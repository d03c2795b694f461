"""The measurement lab's probes in the port (cloudsc_tpu_torch.kernels.
cuda_probes, cloudsc_tpu_torch.bench) on the CPU, against the JAX probes of
bench/ run in Pallas interpret mode:

  * K3: the copy probe's plain version equals `dma_probe.make_copy` bitwise
    for contig, strided and tilemajor, and each thread block of the kernel
    covers exactly the block of its TPU grid step;
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
    before = cp.COPY_LAUNCHES
    got, got_col = cp.dma_copy(torch.from_numpy(x), torch.from_numpy(col),
                               probe)
    assert cp.COPY_LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_col.numpy(), want_col)


@pytest.mark.parametrize("name", ["contig", "strided", "tilemajor"])
def test_copy_blocks_cover_the_tpu_grid_steps(name):
    """Thread block (i, k) of the kernel touches exactly the elements of the
    TPU BlockSpec's block at grid step (i, k), and the blocks together
    touch every element once."""
    probe, index = _copy_cases()[name]
    flat = np.arange(int(np.prod(probe.shape))).reshape(probe.shape)
    seen = []
    for b in range(probe.nblocks):
        i, k = b % probe.ni, b // probe.ni
        ix = index(i) if len(probe.grid) == 1 else index(i, k)
        region = flat[tuple(slice(j * n, (j + 1) * n)
                            for j, n in zip(ix, probe.block))]
        got = probe.offsets(i, k)
        np.testing.assert_array_equal(np.sort(got), np.sort(region.ravel()))
        seen.append(got)
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)),
                                  flat.ravel())


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
    before = cp.OVERLAP_LAUNCHES
    out, colo, col_out = cp.overlap_step(cp.probe_from_jax(big),
                                         torch.from_numpy(col), variant,
                                         mode, w, SB)
    assert cp.OVERLAP_LAUNCHES == before
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
