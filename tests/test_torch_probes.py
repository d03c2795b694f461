"""The measurement lab's probes in the port (cloudsc_tpu_torch.kernels.
cuda_probes, cloudsc_tpu_torch.bench) on the CPU, against the JAX probes of
bench/ run in Pallas interpret mode:

  * K3: the copy probe's plain version equals `dma_probe.make_copy` bitwise
    for contig, strided and tilemajor, and each TPU grid step's runs cover
    exactly the block of that step; the kernel's stages
    (`CopyProbe.stage_copies` / `stages`, the kernel's own integer mapping)
    cover every element once, never cross a step and stay within a stage's
    bytes, at small shapes element by element and at the lab's default
    size by interval arithmetic (sb 32 and 1), and the kernel's walk over
    them (`_walk`) meets the same stages; the ring's order of loads, waits
    and stores (`_ring_events`), replayed with its slots and barrier
    phases, computes x * 1.0000001 bit for bit, and the replay finds the
    faults of a broken order;
  * K2: the overlap probe's plain version equals `overlap_probe.make_fn`
    bitwise, 5 variants x {full, resident} x w in {0, 3}, on seeded inputs
    in [0, 1) with one block scaled under 0.5 at even levels, so branchy
    takes both branches (resident: the region both define, level 0 and the
    column output of block 0);
  * the layout converter round-trips;
  * the lab's entry points answer --help and exit 1 without a card.

Tolerance 0: every multiply-add is one rounding on both sides (XLA's CPU
build contracts the JAX body into FMAs; the plain version's `fma32` rounds
once), and the copy is one fp32 multiply.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudsc_tpu_torch.kernels import cuda_probes as cp
from cloudsc_tpu_torch.runtime import tracing

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def bench_scripts(monkeypatch):
    """bench/ on sys.path, and pallas_call in interpret mode (make_fn has no
    interpret argument); both restored after the test."""
    from jax.experimental import pallas as pl

    monkeypatch.syspath_prepend(str(ROOT / "bench"))
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    import dma_probe
    import overlap_probe

    return overlap_probe, dma_probe


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

def _copy_cases():
    nk2, lps, rows, nblk, sb = 3, 2, 5, 4, 2
    ni = nblk // sb
    return {
        "contig": (cp.contig_probe(8, 5), lambda i: (i, 0, 0)),
        "strided": (cp.strided_probe(nk2, lps, rows, nblk, sb),
                    lambda i, k: (k, 0, i, 0)),
        "tilemajor": (cp.tilemajor_probe(nk2, ni, lps, rows, sb),
                      lambda i, k: (k, i, 0, 0, 0)),
    }


@pytest.mark.parametrize("name", ["contig", "strided", "tilemajor"])
def test_copy_plain_equals_jax_probe(bench_scripts, name):
    _, dma_probe = bench_scripts
    probe, index = _copy_cases()[name]
    rng = np.random.default_rng(7)
    x = rng.random(probe.shape, dtype=np.float32) * 4 - 2
    col = rng.random(cp.COL_SHAPE, dtype=np.float32)
    fn = dma_probe.make_copy(probe.shape, probe.block, index, probe.grid,
                             interpret=True)
    want, want_col = (np.asarray(a) for a in fn(jnp.asarray(x),
                                                 jnp.asarray(col)))
    before = tracing.counter("launches.copy")
    got, got_col = cp.dma_copy(torch.from_numpy(x), torch.from_numpy(col),
                               probe)
    assert tracing.counter("launches.copy") == before
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_col.numpy(), want_col)


@pytest.mark.parametrize("name", ["contig", "strided", "tilemajor"])
def test_copy_blocks_cover_the_tpu_grid_steps(name):
    """The runs of step (i, k) are exactly the elements of the TPU
    BlockSpec's block at grid step (i, k), and the steps together touch
    every element once."""
    probe, index = _copy_cases()[name]
    flat = np.arange(int(np.prod(probe.shape))).reshape(probe.shape)
    seen = []
    for b in range(probe.nsteps):
        i, k = b % probe.ni, b // probe.ni
        ix = index(i) if len(probe.grid) == 1 else index(i, k)
        region = flat[tuple(slice(j * n, (j + 1) * n)
                            for j, n in zip(ix, probe.block))]
        got = probe.offsets(i, k)
        np.testing.assert_array_equal(np.sort(got), np.sort(region.ravel()))
        seen.append(got)
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)),
                                  flat.ravel())


# small probes for the stage cut: each kind, K1's 512-byte runs (sb 1),
# and chunks that cut long runs into pieces (contig, tilemajor) and gather
# short ones unevenly (strided: 10 runs of 1 kB, 3 a stage at most)
def _stage_cases():
    cases = {name: probe for name, (probe, _) in _copy_cases().items()}
    cases["strided_sb1"] = cp.strided_probe(3, 2, 5, 4, 1)
    cases["contig3"] = cp.contig_probe(3, 5)
    return cases


def _step_of(probe, chunk, t):
    return t // probe.stage_plan(chunk)[0]


def _ring_events(n: int, stages: int) -> list:
    """csrc/probes.cu copy_kernel's order: how one CTA with `n` stages and
    a ring of `stages` slots loads, waits, multiplies and stores, as (op,
    stage, slot, parity): "load" (the elected thread's bulk loads into the
    slot), "wait" (every thread, on the slot's full barrier with that
    parity), "store" (the bulk stores after the multiply and the CTA
    barrier, one bulk group), "read" (the elected thread's
    `wait_group.read 1`: every store group but the newest has read its
    slot) and "drain" (`wait_group 0`)."""
    ev = [("load", j, j % stages, None)
          for j in range(min(stages - 1, n))]
    for j in range(n):
        ev.append(("wait", j, j % stages, (j // stages) & 1))
        ev.append(("store", j, j % stages, None))
        if j + stages - 1 < n:
            ev.append(("read", j, None, None))
            nxt = j + stages - 1
            ev.append(("load", nxt, nxt % stages, None))
    if n:
        ev.append(("drain", None, None, None))
    return ev


def _replay_copy_ring(probe, x, nctas, chunk, stages, events=None):
    """Runs K3 on the CPU from its model: for each CTA the ring's events
    (`_ring_events`, or `events(n)`) over its stages
    (`stage_copies`), with S slots and a full barrier each. Returns (out,
    faults): a wait on a slot that does not hold its stage or with the
    wrong phase parity, a load into a slot whose stage is not yet stored
    or whose store may still be reading it, a stage over `chunk` bytes, a
    store group not drained at the end."""
    flat = x.reshape(-1)
    out = np.full_like(flat, np.nan)
    faults = []
    total = probe.nstages(chunk)
    for c in range(nctas):
        mine = np.arange(c, total, nctas)
        stage, off, size = probe.stage_copies(chunk, mine)
        copies = {int(t): [] for t in mine}
        for t, o, n in zip(stage.tolist(), off.tolist(), size.tolist()):
            copies[t].append((o // 4, n // 4))
        slot_stage = [None] * stages   # what each slot holds
        slot_data = [None] * stages
        phases = [0] * stages          # completed phases of each barrier
        pending = []                   # slots of store groups not yet read
        stored = set()
        evs = (events or _ring_events)(len(mine), stages)
        for op, j, slot, parity in evs:
            if op == "load":
                if slot_stage[slot] is not None and \
                        slot_stage[slot] not in stored:
                    faults.append(("overwrite", c, j))
                if slot in pending:
                    faults.append(("store still reading", c, j))
                parts = copies[int(mine[j])]
                if sum(n for _, n in parts) * 4 > chunk:
                    faults.append(("stage over chunk", c, j))
                slot_stage[slot] = j
                slot_data[slot] = np.concatenate(
                    [flat[o:o + n] for o, n in parts])
                phases[slot] += 1      # the bytes land: the phase completes
            elif op == "wait":
                if slot_stage[slot] != j or (phases[slot] - 1) & 1 != parity:
                    faults.append(("wait", c, j))
                slot_data[slot] = slot_data[slot] * np.float32(cp.MUL)
            elif op == "store":
                if slot_stage[slot] != j:
                    faults.append(("store", c, j))
                pos = 0
                for o, n in copies[int(mine[j])]:
                    out[o:o + n] = slot_data[slot][pos:pos + n]
                    pos += n
                stored.add(j)
                pending.append(slot)
            elif op == "read":
                pending = pending[-1:]
            elif op == "drain":
                pending = []
        if pending:
            faults.append(("not drained", c, None))
    return out.reshape(x.shape), faults


@pytest.mark.parametrize("chunk", [1024, 3072, 6144, 32768])
@pytest.mark.parametrize("name", list(_stage_cases()))
def test_copy_stages_cover_every_element_once(name, chunk):
    """Every element lies in exactly one bulk copy of one stage; a stage
    holds the runs of one TPU step only, at most `chunk` bytes, whole
    16-byte units; each CTA's stage count is within one of another's."""
    probe = _stage_cases()[name]
    n = int(np.prod(probe.shape))
    for nctas in (1, 3, 132):
        per_cta = probe.stages(nctas, chunk)
        assert len(per_cta) == nctas
        counts = np.zeros(n, dtype=np.int64)
        total = 0
        for c, mine in enumerate(per_cta):
            for j, copies in enumerate(mine):
                t = c + j * nctas
                i, k = (_step_of(probe, chunk, t) % probe.ni,
                        _step_of(probe, chunk, t) // probe.ni)
                step = set(probe.offsets(i, k).tolist())
                assert sum(nb for _, nb in copies) <= chunk
                for off, nb in copies:
                    assert off % 16 == 0 and nb % 16 == 0 and nb > 0
                    elems = range(off // 4, (off + nb) // 4)
                    assert step.issuperset(elems), (name, t)
                    counts[off // 4:(off + nb) // 4] += 1
            total += len(mine)
        assert total == probe.nstages(chunk)
        np.testing.assert_array_equal(counts, 1)
        sizes = [len(m) for m in per_cta]
        assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("stages", [2, 3, 4, 6])
@pytest.mark.parametrize("name", list(_stage_cases()))
def test_copy_ring_replay_computes_the_probe(name, stages):
    """The ring's events over each CTA's stages, replayed with S slots,
    write x * 1.0000001 bit for bit and find no fault, with fewer stages
    than CTAs (132) and with several rounds a CTA (3)."""
    probe = _stage_cases()[name]
    x = np.random.default_rng(2).random(probe.shape, dtype=np.float32)
    want = x * np.float32(cp.MUL)
    for nctas in (3, 132):
        out, faults = _replay_copy_ring(probe, x, nctas, 3072, stages)
        assert faults == []
        np.testing.assert_array_equal(out, want)


def test_copy_ring_replay_finds_faults():
    """The replay finds the faults of a broken ring: a refill with no
    `wait_group.read`, a refill of the slot still being read, a flipped
    parity, a missing drain."""
    probe = _stage_cases()["strided_sb1"]
    x = np.random.default_rng(4).random(probe.shape, dtype=np.float32)

    def broken(change):
        return lambda n, s: change(_ring_events(n, s), s)

    no_read = broken(lambda ev, s: [e for e in ev if e[0] != "read"])
    flipped = broken(lambda ev, s: [
        (op, j, slot, 1 - parity) if op == "wait" and j == s else
        (op, j, slot, parity) for op, j, slot, parity in ev])
    no_drain = broken(lambda ev, s: [e for e in ev if e[0] != "drain"])

    def early(ev, s):
        # stage 1's refill (and its read) moved before stage 1's store:
        # `wait_group.read 1` then leaves stage 0's store, whose slot the
        # refill takes, free to be still reading
        out = list(ev)
        i = next(k for k, e in enumerate(out) if e[:2] == ("read", 1))
        read, load = out.pop(i), out.pop(i)
        out[i - 1:i - 1] = [read, load]
        return out

    for events, kind in ((no_read, "store still reading"),
                         (flipped, "wait"), (no_drain, "not drained"),
                         (broken(early), "store still reading")):
        _, faults = _replay_copy_ring(probe, x, 1, 3072, 3, events)
        assert kind in {f[0] for f in faults}, kind


def _walk(probe, chunk, c, grid, n):
    """csrc/probes.cu StageWalk: CTA c's first n stages as (r, i, k), each
    advanced from the last by the grid with carries, no division."""
    sps = probe.stage_plan(chunk)[0]
    b, db = c // sps, grid // sps
    r, i, k = c % sps, b % probe.ni, b // probe.ni
    dr, di, dk = grid % sps, db % probe.ni, db // probe.ni
    out = []
    for _ in range(n):
        out.append((r, i, k))
        r += dr
        carry = int(r >= sps)
        r -= sps * carry
        i += di + carry
        k += dk
        if i >= probe.ni:
            i -= probe.ni
            k += 1
    return out


@pytest.mark.parametrize("sb", [32, 1])
def test_copy_stage_walk_matches_division(sb):
    """The kernel walks each CTA's stages by adding the grid with carries;
    at the lab's size and at the small shapes that walk meets stage t's
    (t % sps, step % ni, step // ni) at every stage of every CTA."""
    from cloudsc_tpu_torch.bench import dma_probe as db

    probes = db.probes(db.parse_args(["--sb", str(sb)]))
    probes += list(_stage_cases().values())
    for probe in probes:
        for chunk in (3072, 16384, cp.COPY_RING.chunk):
            sps = probe.stage_plan(chunk)[0]
            total = probe.nstages(chunk)
            for grid in (3, 132, 132 * 2):
                for c in {0, 1, grid - 1}:
                    n = max(0, -(-(total - c) // grid))
                    t = c + grid * np.arange(min(n, 4000))
                    got = np.array(_walk(probe, chunk, c, grid, len(t)))
                    if not len(t):
                        continue
                    b, r = np.divmod(t, sps)
                    want = np.stack([r, b % probe.ni, b // probe.ni], 1)
                    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sb", [32, 1])
def test_copy_stages_at_the_lab_size(sb):
    """At the lab's default size (every probe, K3's COPY_RING chunk and
    16 kB, the H100's 132 SMs): the copies' sorted intervals are disjoint
    and tile the array; each is 16-byte aligned, a multiple of 16 bytes
    and inside one run; each stage is at most a chunk and inside one TPU
    step; no CTA moves more than one stage's bytes more than another."""
    from cloudsc_tpu_torch.bench import dma_probe as db

    nctas = 132 * cp.COPY_RING.ctas
    for probe in db.probes(db.parse_args(["--sb", str(sb)])):
        nbytes = 4 * int(np.prod(probe.shape))
        # every run's first byte, sorted, and its step
        step = np.arange(probe.nsteps, dtype=np.int64)
        base = (step % probe.ni) * probe.base_i + (step // probe.ni) \
            * probe.base_k
        starts = 4 * (base[:, None] + probe.run_stride
                      * np.arange(probe.nruns)[None]).reshape(-1)
        run_step = np.repeat(step, probe.nruns)
        order = np.argsort(starts)
        starts, run_step = starts[order], run_step[order]
        for chunk in sorted({cp.COPY_RING.chunk, 16384}):
            total = probe.nstages(chunk)
            stage, off, size = probe.stage_copies(chunk, np.arange(total))
            assert (off % 16 == 0).all() and (size % 16 == 0).all()
            assert (size > 0).all()
            srt = np.argsort(off)
            o, n = off[srt], size[srt]
            assert o[0] == 0 and o[-1] + n[-1] == nbytes
            np.testing.assert_array_equal(o[1:], o[:-1] + n[:-1])
            run = np.searchsorted(starts, off, side="right") - 1
            assert (off + size <= starts[run] + 4 * probe.run_len).all()
            # every copy of a stage lies in the stage's own step
            np.testing.assert_array_equal(
                run_step[run], stage // probe.stage_plan(chunk)[0])
            stage_bytes = np.bincount(stage, weights=size, minlength=total)
            assert stage_bytes.max() <= chunk
            cta_bytes = np.bincount(stage % nctas, weights=size,
                                    minlength=nctas)
            assert cta_bytes.max() - cta_bytes.min() <= stage_bytes.max()
            del stage, off, size, srt, o, n, run


def test_copy_ring_reaches_the_source(monkeypatch):
    """`COPY_RING` becomes the build's COPY_RING_* macros, which the probes'
    source requires and reads; the geometry query's keys and the kernel's
    threads agree with the source."""
    import re

    from cloudsc_tpu_torch.kernels import build

    src = (ROOT / "cloudsc_tpu_torch" / "csrc" / "probes.cu").read_text()
    code = re.sub(r"//[^\n]*", "", src)
    flags = build.nvcc_flags()
    r = cp.COPY_RING
    for key, value in (("STAGES", r.stages), ("CHUNK", r.chunk),
                       ("CTAS", r.ctas)):
        macro = f"COPY_RING_{key}"
        assert f"-D{macro}={value}" in flags
        assert code.count(macro) == 2, macro  # the guard and the read
    assert r.stages >= 2 and r.chunk % 16 == 0
    assert r.smem_bytes <= 232448 // r.ctas
    threads = re.search(r"constexpr int COPY_THREADS = (\d+);", src)
    assert int(threads.group(1)) == cp.COPY_THREADS
    assert re.search(r"const int vals\[%d\]" % len(cp.COPY_GEOMETRY_KEYS),
                     src)
    # the flags read COPY_RING when they are made: a process that rebinds it
    # before the first build builds that ring, into a directory of its own
    monkeypatch.setattr(cp, "COPY_RING", cp.CopyRing(4, 32768, 1))
    other = build.nvcc_flags()
    assert "-DCOPY_RING_STAGES=4" in other and "-DCOPY_RING_CTAS=1" in other
    assert build.source_hash(other) != build.source_hash(flags)


def test_copy_args_refused_on_the_cpu():
    """The wrapper's checks that need no card: shape, type, alignment of
    the runs; a CPU x never reaches them (it runs the plain version)."""
    probe = cp.contig_probe(32, 7)
    x = torch.zeros(probe.shape)
    col = torch.zeros(cp.COL_SHAPE)
    with pytest.raises(ValueError, match="probe takes"):
        cp.check_copy_args(x[:3], col, probe)
    with pytest.raises(ValueError, match="fp32"):
        cp.check_copy_args(x.double(), col, probe)
    with pytest.raises(ValueError, match="CUDA device"):
        cp.check_copy_args(x, col, probe)
    odd = dataclasses.replace(probe, run_stride=probe.run_stride + 2)
    assert odd.run_stride % 4
    before = tracing.counter("launches.copy")
    got, _ = cp.dma_copy(x, col, odd)
    assert tracing.counter("launches.copy") == before
    assert torch.equal(got, x * cp.MUL)


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

NK2, NI, RR, SB = 4, 3, 40, 1


def _overlap_inputs():
    """Values in [0, 1) over 12 decades: at O(1) the probe's 1e-8/1e-9
    scratch and lookahead terms fall under an fp32 ulp, and the comparison
    would not see them."""
    rng = np.random.default_rng(11)
    shape = (NK2, NI, RR, SB, 128)
    big = (rng.random(shape) * 10.0 ** (-12 * rng.random(shape))).astype(
        np.float32)
    big[:, :, 0, 0, 0] = 0.9         # every block's row 0 above 0.5 ...
    big[::2, 0] *= np.float32(0.4)   # ... but block 0's at even levels
    col = rng.random(cp.COL_SHAPE, dtype=np.float32)
    return big, col


@pytest.mark.parametrize("w", [0, 3])
@pytest.mark.parametrize("mode", ["full", "resident"])
@pytest.mark.parametrize("variant", list(cp.VARIANTS))
def test_overlap_plain_equals_jax_probe(bench_scripts, variant, mode, w):
    overlap_probe, _ = bench_scripts
    big, col = _overlap_inputs()
    fn = overlap_probe.make_fn(variant, mode, w, NI, NK2, RR, SB)
    args = (big, big, col) if variant in ("alias", "prod") else (big, col)
    want = [np.asarray(a) for a in fn(*(jnp.asarray(a) for a in args))]
    before = tracing.counter("launches.overlap")
    out, colo, col_out = cp.overlap_step(cp.probe_from_jax(big),
                                         torch.from_numpy(col), variant,
                                         mode, w, SB)
    assert tracing.counter("launches.overlap") == before
    np.testing.assert_array_equal(col_out.numpy(), want[-1])
    blk = SB * 128
    if mode == "full" and variant != "plain" and (variant == "branchy") \
            == bool(w):
        # the variant's own terms show (full mode; the scratch and lookahead
        # terms at w=0, the skipped chain at w>0): it differs from plain
        plain = cp.overlap_plain(cp.probe_from_jax(big), torch.from_numpy(col),
                                 "plain", mode, w, SB)[0]
        assert not torch.equal(out, plain)
    if mode == "full":
        np.testing.assert_array_equal(cp.probe_to_jax(out, SB).numpy(),
                                      want[0])
        if variant == "prod":
            np.testing.assert_array_equal(cp.probe_to_jax(colo, SB).numpy(),
                                          want[1])
        else:
            assert colo is None
    else:
        assert out.shape == (1, RR, NI * blk)
        np.testing.assert_array_equal(
            cp.probe_to_jax(out, SB).numpy()[0, 0], want[0][0, 0])
        if variant == "prod":
            np.testing.assert_array_equal(colo.numpy()[:blk],
                                          want[1].reshape(-1)[:blk])
    if variant == "branchy" and w:
        # both branches ran: at level 0, block 0 (under 0.5) kept its input
        # and block 1 did not
        lev0 = cp.probe_to_jax(out, SB).numpy()[0]
        np.testing.assert_array_equal(lev0[0], big[0, 0])
        assert not np.array_equal(lev0[1], big[0, 1])


def test_fma32_is_one_rounding():
    """fma32 against the exact value (fractions) rounded once to fp32, on
    cases where the fp64 sum would round twice."""
    from fractions import Fraction

    rng = np.random.default_rng(3)
    a = rng.random(20000, dtype=np.float32)
    b = np.float32(1.0000001)
    c = np.float32(1e-7)
    got = cp.fma32(torch.from_numpy(a), float(b), float(c)).numpy()
    naive = (a.astype(np.float64) * float(b) + float(c)).astype(np.float32)
    for i in np.flatnonzero(got != naive)[:50].tolist() + list(range(50)):
        exact = Fraction(float(a[i])) * Fraction(float(b)) + Fraction(float(c))
        lo = np.float32(float(exact))
        # the fp32 neighbours around the exact value; pick the nearest
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(v.view(np.int32)) & 1))
        assert got[i] == best, i
    # (1 + 2^-12)^2 + 2^-60 lies just above an fp32 midpoint: the fp64 sum
    # rounds onto the midpoint and then to even, one ulp under the FMA
    a = torch.tensor([1 + 2.0 ** -12], dtype=torch.float32)
    want = np.float32(1 + 2.0 ** -11 + 2.0 ** -23)
    assert float((a.double() * a.double() + 2.0 ** -60).float()) != want
    assert cp.fma32(a, a, 2.0 ** -60).item() == want


def test_probe_layout_round_trips():
    rng = np.random.default_rng(5)
    for sb in (1, 2, 8):
        a = torch.from_numpy(rng.random((3, 2, 7, sb, 128), dtype=np.float32))
        x = cp.probe_from_jax(a)
        assert x.shape == (3, 7, 2 * sb * 128) and x.is_contiguous()
        assert torch.equal(cp.probe_to_jax(x, sb), a)
        # element [k, i, r, s, l] -> [k, r, (i*sb + s)*128 + l]
        assert x[2, 5, (1 * sb + sb - 1) * 128 + 17] == a[2, 1, 5, sb - 1, 17]
        colo = torch.from_numpy(rng.random((2 * sb, 128), dtype=np.float32))
        assert torch.equal(cp.probe_to_jax(cp.probe_from_jax(colo), sb), colo)


def test_overlap_args_refused():
    x = torch.zeros((2, 40, 256))
    col = torch.zeros(cp.COL_SHAPE)
    cp.check_overlap_args(x, col, "prod", "full", 5, 2, cuda=False)
    for sb in (0, cp.SB_MAX + 1, 9):
        with pytest.raises(ValueError, match="sb"):
            cp.check_overlap_args(x, col, "plain", "full", 0, sb, cuda=False)
    with pytest.raises(ValueError, match="multiple of sb"):
        cp.check_overlap_args(x[..., :200], col, "plain", "full", 0, 1,
                              cuda=False)
    with pytest.raises(ValueError, match="rr >= 33"):
        cp.check_overlap_args(x[:, :20], col, "scratch", "full", 0, 1,
                              cuda=False)
    with pytest.raises(ValueError, match="built for"):
        cp.check_overlap_args(x, col, "plain", "full", 5, 1, cuda=True)
    with pytest.raises(ValueError, match="CUDA device"):
        cp.check_overlap_args(x, col, "plain", "full", 4, 1, cuda=True)
    with pytest.raises(ValueError, match="variant"):
        cp.check_overlap_args(x, col, "fancy", "full", 4, 1, cuda=False)


def test_overlap_w_matches_c_source():
    import re

    src = (ROOT / "cloudsc_tpu_torch" / "csrc" / "probes.cu").read_text()
    ws = re.search(r"#define OVERLAP_WS ([\d, ]+)", src).group(1)
    assert tuple(int(v) for v in ws.split(",")) == cp.OVERLAP_W
    names = re.search(r"enum Variant \{([^}]*)\}", src).group(1)
    assert [n.strip().lower() for n in names.split(",")] == list(cp.VARIANTS)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def _run(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


LAB = ["kernel_lab", "overlap_probe", "dma_probe", "ring_sweep"]


@pytest.mark.parametrize("name", LAB)
def test_entry_point_help(name):
    r = _run(["-m", f"cloudsc_tpu_torch.bench.{name}", "--help"])
    assert r.returncode == 0, r.stderr
    assert "usage: python -m cloudsc_tpu_torch.bench." + name in r.stdout


@pytest.mark.parametrize("name", LAB)
def test_entry_point_without_card_exits_1(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal path needs none")
    r = _run(["-m", f"cloudsc_tpu_torch.bench.{name}"])
    assert r.returncode == 1, r.stdout + r.stderr
    assert "needs a CUDA device" in r.stderr
    assert "{" not in r.stdout


def test_kernel_lab_same_bits():
    """kernel_lab's check: NaNs of equal bits are equal, 0.0 and -0.0 are
    not, and neither are tensors of another shape or dtype."""
    from cloudsc_tpu_torch.bench.kernel_lab import same_bits

    a = torch.tensor([1.0, float("nan"), float("inf")], dtype=torch.float64)
    assert same_bits(a, a.clone())
    assert not same_bits(torch.tensor([0.0]), torch.tensor([-0.0]))
    assert not same_bits(a, a[:2])
    assert not same_bits(a, a.float())
    assert same_bits(a.float(), a.float().clone())


@pytest.mark.parametrize("mode", ["full", "init", "floor"])
def test_kernel_lab_plain_is_the_body_on_the_cpu(mode):
    """kernel_lab's plain version of each body equals what the wrapper runs
    on a CPU pack (its plain version), bit for bit."""
    from cloudsc_tpu_torch import data as tdata
    from cloudsc_tpu_torch.bench.kernel_lab import plain, same_bits
    from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
    from cloudsc_tpu_torch.params import Params as TParams
    from cloudsc_tpu_torch.physics import scheme as tscheme

    inp = tdata.load_input(tdata.default_input_path(), 100)
    params = TParams.from_input(inp)
    c = tscheme.derived_consts(params, inp.ptsphy, torch.float64)
    p = cc.pack_inputs_folded(inp, params, dtype=torch.float64)
    got = plain(p, c, mode)
    want = cc.cloudsc_fused(p, c, mode=mode)
    assert len(got) == len(want) == 3
    assert all(same_bits(x, y) for x, y in zip(got, want))
