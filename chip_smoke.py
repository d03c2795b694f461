"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive, time.

    python3 chip_smoke.py

Run from the root of a checkout on a host with one CUDA card (an H100 for
the recorded numbers). It imports neither JAX nor the JAX package
`cloudsc_tpu`, only `cloudsc_tpu_torch`. Phases, each of which raises on a
failed check (the script then exits non-zero and prints no result):

  0. environment: card name and power limit (nvidia-smi), torch/CUDA/nvcc
     versions, the kernel builds, all started together (the default
     library, and K1 alone for each scheme version of VERSION_CASES,
     each form build of `data.synthetic.FORM_CASES` and the field dict's
     build, `cuda_cloudsc.ROWS_FORM`, whose Rows policy is read and whose
     zdqs_kernel's registers are printed; seconds,
     ptxas registers and spills), K1's ring geometry and occupancy in each
     precision and build (S, BLOCK, MIN_BLOCKS, dynamic shared memory,
     registers, spills, blocks an SM; the library's geometry must be
     `cuda_cloudsc.RING`, every build at least one block an SM), K3's
     copy ring (S, bytes a stage, CTAs an SM, dynamic shared memory,
     registers and spills; it must be `cuda_probes.COPY_RING` with its CTAs
     fitting an SM), and about a second of streaming to bring the clocks
     up;
  1. the fused kernel against its plain PyTorch version on the main path's
     own pack (`CloudscDriver.prepare`: activity-sorted grouped columns,
     163,840 columns x 137 levels), fp64 (errsum/refsum < FP64_TOL per
     field) and fp32 (max-abs/max-ref <= 1e-5 per field), and bit for bit
     (max abs err 0), with the launch count of exactly those calls, and
     their times; then on the driver's pack at a ragged column count
     (RAGGED_NCOL), every output buffer bit for bit;
  1a. K1's diagnostic bodies (`floor`, `init`) against their plain versions
     on the same pack under the same bars, and the three bodies' times;
  1b. the overlap probe (K2) against its plain version at the lab's
     default size, every variant x {full, resident} x every w the lab
     sweeps by default, max-abs/max-ref <= 1e-6 (bitwise expected), and its
     times;
  1c. the copy probe (K3) against x * 1.0000001, contig32...4096, strided
     and tilemajor at the lab's default size and strided at sb 1 (K1's
     512-byte runs), bitwise, and their GB/s;
  1d. K1's scheme versions (`data.synthetic.VERSION_CASES`: the four single
     alternates of the reference configuration and the aerosol build, each
     on the input that takes its branch) at 163,840 columns, fp64 and fp32:
     each version's main path (`CloudscDriver(scheme_config=...).run`) with
     the per-version launch counts reset just before and read just after;
     then on the driver's pack the build against its plain version, bit for
     bit on all 21 fields, its time and the plain version's, and its
     outputs against the reference configuration's build on the same input,
     which must differ (that build's time there is printed beside);
  1f. K1's form builds (`data.synthetic.FORM_CASES`: the seven other
     (fc, fn, fd) packs, fn off being the in-line CUADJTQ; the unfolded
     pack (CLOUDSC_FOLD_INPUTS=0); the four derivable flux rows written by
     the kernel (CLOUDSC_FOLD_OUTPUTS=0) on the folded and the unfolded
     pack; skip sets A and B, B with the per-round 5.2.1 skip; no dynamic
     skips; between them every macro branch of the scheme header)
     at RAGGED_NCOL columns, fp64 and fp32: each build's main path under
     its driver switches with the per-version counts reset and read, then
     on the driver's pack the build against its plain version, all three
     buffers bit for bit (NaNs included: skipped sections are wrong physics
     by construction), its time and the plain version's;
  1g. the flux rows' kernel (`csrc/foldo.cu`, `foldo_synthesize`) against
     its plain loop at 163,840 x 137, fp64 and fp32, all four rows bit for
     bit, from the driver's pack (strided rows) and from a field dict
     expanded on the card (contiguous), PFPLSL/N the strided views of K1's
     o_half; one `launches.foldo` a call, read from the registry; its time
     beside its bound and the loop's;
  2. the main path in fp32 (`python -m cloudsc_tpu_torch 1 163840 128`'s
     driver calls, outputs left on the card): launch counts reset just
     before, read just after (K1 1 + ITERATIONS, the flux rows' kernel
     once, in the run's `assemble`); the perf table; validation on the card
     (`validate.device_field_norms` against the reference expanded there)
     within test_golden's FP32_TOL per field;
  3. the main path in fp64 at the same size, validated on the card: every
     field within FP64_TOL, and no field's MaxRelErr (the validation
     table's errsum/refsum) above the larger of the 10*eps flag bar and the
     JAX package's own fp64 engine's reading of that field at this size
     (`bench.sweep.fp64_verdict`): a `!!!!` flag is accepted only where
     the reference engine carries one at least as large; then the fields
     fetched once and validated on the host, whose norms must equal the
     card's within NORMS_RTOL per field and statistic;
  3s. the eager scan engine (`CloudscDriver(backend="scan")`) in fp64 at the
     same size, validated on the card under the same bars, then one step
     with CLOUDSC_SCAN_PACKED=1 (`physics.cloudsc.scan_pack` once after the
     copy): every field equal to the plain dict's bit for bit; it launches
     no kernel (every count unchanged);
  3m. the main path in fp64 at the same size with CLOUDSC_FOLD_NEWTON=0,
     with CLOUDSC_FOLD_CURVES=1 CLOUDSC_FOLD_DEP=1 and with
     CLOUDSC_FOLD_INPUTS=0: launches by version, validated on the card
     under the fp64 bars, the build bit for bit with its plain version on
     the driver's pack, K1 timed beside the reference build on the same
     input (two windows each, alternating, the least of each's), the host
     pack and H2D;
  3p. the per-field entry at the same size: in fp32 the main path with
     CLOUDSC_PACKED_STORAGE=0 (the field dict on the card, read in place
     by the unfolded build) with the per-version, in-place and zdqs_kernel
     counts reset and read (every launch in place, after one zdqs_kernel
     launch), bit for bit with the CLOUDSC_FOLD_INPUTS=0 main path (none in
     place, no zdqs_kernel launch) and with
     `cuda_cloudsc.cloudsc_fused_fields` on the card's field dict; in fp32
     and fp64 `cuda_cloudsc.cloudsc_fused` on the card's field dict
     (zdqs_kernel, then the Rows policy) bit for bit with the plain version
     on the same dict, its time beside its bound (a `cloudsc_fused_rows` row
     in the kernel table); zdqs_kernel (`zdqs_row`) alone bit for bit with
     `zdqs_plain`, its time beside its bound and the plain version's (one
     `timing zdqs_kernel` line, a `zdqs_kernel` row in the kernel table
     with the main path's zdqs_kernel launches and the comparison's max abs
     err);
  3l. the main path in fp32 in the cyclic (CLOUDSC_GROUP_COLUMNS=0) and the
     grouped unsorted (CLOUDSC_GROUP_SORT=0) layouts: every field equal to
     the sorted main path's bit for bit after the ungroup;
  3a. the adjoint, fp64: `physics.autodiff.grad` of the gradient tests'
     scalar head with respect to `pt` at 163,840 columns, in column blocks:
     finite, not identically zero, and every column's gradient equal to its
     source column's in a 100-column run on the card within GRAD_COPY_RTOL
     of the largest gradient (bit for bit expected, and reported); seconds,
     blocks and peak device memory;
  3b. the tangent, fp64, on the adjoint's first block: `autodiff.jvp`
     against a central finite difference (eps 1e-3, relative < 1e-4), and
     <grad, v> against it (relative < 1e-12);
  3c. parameter gradients, fp64, at 163,840 columns: d/d rcldiff and
     d/d rkooptau of sum(tendency_loc_t^2) * 1e6 against a central finite
     difference (step 1e-6 of the value, relative < 1e-5);
  3d. the timestep loop (`examples.timestep_loop`), 3 steps at 163,840
     columns with the state on the card: finite state, cloud fraction in
     [0, 1], 150 K < T < 340 K, non-negative surface precipitation, budget
     source > -1e-9, step 1 equal to the plain single step; seconds a step;
  3e. the refusal: K1 with an input that requires grad raises;
  3f. the energy monitor: with EC_PMON=1 the main path (fp64 and fp32,
     PMON_ITERATIONS steps) reports the card's energy line from NVML, with
     positive joules; joules a step.
     Phases 3a-3d launch no hand-written kernel (every count unchanged);
  4. timing lines, each with the card's name and power limit, printed
     after phase 5;
  5. the measurement lab's path, through its entry points
     (`cloudsc_tpu_torch.bench.kernel_lab --modes full init floor`,
     `kernel_lab --skip s45r --foldn 0`, `kernel_lab --modes full init
     floor --fold 0 --foldo 0` (the three bodies on the unfolded pack)
     and `.activity_probe --device cuda` at RAGGED_NCOL columns, `.overlap_probe` with all five variants,
     `.dma_probe`): the launch counts reset just before, read just after,
     every lab kernel launched, the skip-and-form build among them;
  6. ranks: `torchrun --standalone --nproc-per-node 2 chip_smoke.py
     --cli-rank 1 163840 128 --precision fp64 --kernel cuda`, two ranks of
     `cloudsc_tpu_torch.cli.main` (what `python -m cloudsc_tpu_torch` runs)
     over gloo, each on card LOCAL_RANK % device_count() (one card: both
     share it), each reporting its own K1 launch count (2: the warm-up and
     the step): exit 0, one NUMPROC=2 line and the `@ rank#1` row from rank
     0 alone, every field within FP64_TOL and the fp64 bar, and the
     printed table equal, digit for digit, to the one from an in-process
     one-rank 81,920-column run's card norms with errsum and refsum
     doubled (each rank tiles the whole 100-column snapshot); then at 100
     columns (true slicing) with `--write-reference`, each rank's file
     equal to its slice of a one-rank 100-column run, bit for bit;
  7. mesh: `CloudscDriver(devices=[cuda:0, cuda:0])` (the first two cards
     where there are two) at 163,840 columns, fp32 and fp64: bit for bit
     with the one-device main path, two timer rows, K1 launched twice a
     step (counts reset just before, read just after);
  8. levels: K1 against its plain version at 61, 68 and 91 levels and
     RAGGED_NCOL columns, fp32 and fp64, bit for bit;
  9. flags, fp32 at 163,840 columns through `cli.main`: `--debug-nans`
     passes, then raises on an input poisoned with one NaN, and
     `driver.check_finite` on outputs poisoned with one; `--profile`
     writes a non-empty Chrome trace; `--sweep-nproma 64,128` prints two
     config lines and perf tables and one validation table.
  10. the measurement entries: `cloudsc_tpu_torch.bench.bench.main()` in
     this process, fp32 and fp64 (CLOUDSC_BENCH_PRECISION), with K1's
     counts reset just before and read just after (1 + 10 launches of the
     reference build each): one JSON line, no `skipped` key, a positive
     value, config `cuda/grouped+fold...`; then `bench.sweep --ngptot
     16384 --kernel cuda --precision fp64 --iterations 1 --validate` (no
     field over FP64_TOL or the JAX engine's reading) and `bench.sweep
     --weak-scaling 1`, each exit 0 with a parsed rate.
     Each of phases 6-10 prints its seconds.

The line before the last is the kernel table as JSON, with each kernel's
bound (`bound_ms`: the larger of its modeled bytes over the card's memory
rate and its counted operations over its peak rate, `bench.timing.bound`);
the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

# test_golden.py's fp64 bar (ref: validate_mod.F90's errsum/refsum metric),
# and the judgement of a run's MaxRelErrs against the JAX fp64 engine's
from cloudsc_tpu_torch.bench.sweep import (FP64_TOL, JAX_FP64_RELERR,
                                           fp64_verdict)

NGPTOT, NPROMA, ITERATIONS = 163840, 128, 10
# test_golden.py's fp32 bars
FP32_TOL_DEFAULT = 2.0e-2
FP32_TOL = {
    "PFSQLF": 0.5, "PFSQIF": 0.5, "PFSQRF": 0.5, "PFSQSF": 0.5,
    "PFCQLNG": 0.5, "PFCQNNG": 0.5, "PFCQRNG": 0.5, "PFCQSNG": 0.5,
    "TENDENCY_LOC%CLD": 0.1, "TENDENCY_LOC%Q": 0.05,
}
KERNEL_SOURCE = "cloudsc_tpu_torch/csrc/cloudsc_fused.cu"
KERNEL_REPLACES = "cloudsc_tpu/kernels/pallas_cloudsc.py:977"
PROBES_SOURCE = "cloudsc_tpu_torch/csrc/probes.cu"
FOLDO_SOURCE = "cloudsc_tpu_torch/csrc/foldo.cu"
# the flux rows' kernel replaces no TPU kernel: the JAX package rebuilds the
# rows in a lax.scan outside pallas_call
FOLDO_REPLACES = "none (cloudsc_tpu/kernels/pallas_cloudsc.py:1525, lax.scan)"
# a column's rows: PAPH, PFPLSL, PFPLSN (nlev+1 each) and PVFL, PVFI (nlev)
# read, the four rows (nlev+1 each) written; a level's operations: ZGDPH_R's
# three, two each for the sums' terms and adds, the two scalings
FOLDO_FLOP_PER_LEVEL = 11
# K2's bar against its plain version, max-abs/max-ref
OVERLAP_TOL = 1e-6
# the bound's model (cloudsc_tpu_torch/bench/timing.py: the H100 SXM's
# data-sheet peaks at 700 W, K1's operations as the reference's flop model
# counts them) is read there; the init body's operations, counted from
# cloudsc_scheme.cuh::level_init (+, -, *, / and exp as one each) plus the
# body's three adds, a level
INIT_FLOP_PER_LEVEL = 81
# zdqs_kernel's operations an element, counted from cloudsc_scheme.cuh's
# level_zdqs (+, -, *, /, min, max and exp as one each): ZTP1 2, FOEALFA 6,
# sat_mix 20, cuadj_zdqs 130 (51 a Newton iteration)
ZDQS_FLOP_PER_ELEMENT = 158
# zdqs_kernel's rows read a level it computes (those below the cloud top):
# PT, TENDENCY_TMP_T, PAP, PAPH, PMFU, PMFD, PVERVEL, PHRSW and PHRLW, each
# once (PAPH's surface level and the clamped k+1 reads come from the
# cache); the ZDQS row is written on every level, 0 above the cloud top
ZDQS_ROWS_READ = 9
# `_device_ms`'s spin, in clock cycles: ~40 ms at the H100's 1.98 GHz,
# some 4 times the host's issue of ITERATIONS zdqs_row calls
SPIN_CYCLES = 80_000_000
# a column count that is neither a multiple of K1's block nor of 4
RAGGED_NCOL = 16387
# the card's validation norms against the host's, relative, per field and
# statistic (the two reduce in fp64 in another order)
NORMS_RTOL = 1e-12
# an expanded column's gradient against its source column's in a 100-column
# run, relative to the largest gradient (bit for bit is expected: the
# card's elementwise arithmetic does not depend on a column's position, and
# every block holds every source column, so it branches as that run does)
GRAD_COPY_RTOL = 1e-12
# tests/test_gradients.py's bars
JVP_FD_EPS, JVP_FD_RTOL, ADJOINT_TANGENT_RTOL, PARAM_FD_RTOL = \
    1e-3, 1e-4, 1e-12, 1e-5
LOOP_STEPS = 3
# steps of the main path under the energy monitor: NVML's energy counter
# moves in steps of tens of milliseconds, so the window is about a second
PMON_ITERATIONS = 200


def _relerr(got, want) -> float:
    import numpy as np

    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    refsum = np.abs(want).sum()
    errsum = np.abs(got - want).sum()
    return float(errsum / refsum if refsum > 0 else errsum)


def scheme_versions(inp, params) -> dict:
    """VERSION_CASES name -> the KernelVersion its configuration runs."""
    import torch

    from cloudsc_tpu_torch.data import synthetic
    from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
    from cloudsc_tpu_torch.physics import scheme

    out = {}
    for name in synthetic.VERSION_CASES:
        vinp, vparams, cfg = synthetic.version_case(name, inp, params)
        out[name] = cc.kernel_version(scheme.derived_consts(
            vparams, vinp.ptsphy, torch.float32, cfg))
    return out


def phase0_environment(versions, rows_version):
    """Returns (card, {version name: {"f32"|"f64": (registers, spill store
    bytes, blocks an SM)}}) for the default build, each of `versions` and,
    as "rows", the field dict's build `rows_version` (its Rows policy; the
    record adds zdqs_kernel's registers and spill store bytes)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from cloudsc_tpu_torch.bench.timing import card as query_card

    card = query_card()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    from cloudsc_tpu_torch.kernels import build

    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    print(f"nvcc: {nvcc.strip().splitlines()[-1]}")
    # every build at once: each runs one nvcc a source, all in parallel
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2 + len(versions)) as ex:
        jobs = {"default": ex.submit(build.build)}
        jobs.update({name: ex.submit(build.build, False, version=v)
                     for name, v in {**versions,
                                     "rows": rows_version}.items()})
        paths = {name: job.result() for name, job in jobs.items()}
    print(f"builds: {len(paths)} libraries in "
          f"{time.perf_counter() - t0:.2f} s")
    info = dict(build.BUILD_INFO)  # the default build's own report
    print(f"build: {info['seconds']:.2f} s (cached={info['cached']})")
    for line in build.ptxas_summary(info["ptxas"]):
        print(f"ptxas {line}")
    from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc

    g = cc.RING
    resources = {}
    for vname, path in paths.items():
        ptxas = build.parse_ptxas((path.parent / "ptxas.log").read_text())
        rows = vname == "rows"
        lib = build.load_library(
            version=rows_version if rows else versions.get(vname))
        resources[vname] = {}
        for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
            occ = cc.occupancy(dtype, lib, rows=rows)
            if (occ["stages"], occ["block"], occ["min_blocks"]) != \
                    (g.stages, g.block, g.min_blocks) \
                    or occ["blocks_per_sm"] < 1:
                raise RuntimeError(f"K1 {vname} {name}: the library runs "
                                   f"{occ}, RING is {g}")
            r = ptxas[f"fused_{name}" + ("_rows" if rows else "")]
            resources[vname][name] = (r["registers"], r["spill_stores"],
                                      occ["blocks_per_sm"])
            if rows:
                z = ptxas[f"zdqs_{name}"]
                resources[vname][name] += (z["registers"], z["spill_stores"])
                print(f"zdqs_kernel {name}: {z['registers']} registers, "
                      f"{z['spill_stores']} B spill stores, "
                      f"{z['stack']} B stack (ptxas)")
            print(f"K1 {vname} {name}: S={occ['stages']}, BLOCK={occ['block']}, "
                  f"MIN_BLOCKS={occ['min_blocks']}, dynamic shared memory "
                  f"{occ['smem_bytes']} B a block; "
                  f"{r['registers']} registers, {r['spill_stores']} B spill "
                  f"stores, {r['spill_loads']} B spill loads, {r['stack']} B "
                  f"stack (ptxas); {occ['blocks_per_sm']} blocks an SM "
                  f"({occ['blocks_per_sm'] * occ['block'] // 32} warps)")
    from cloudsc_tpu_torch.kernels import cuda_probes as cp

    geo, r = cp.copy_geometry(), info["ptxas"]["copy"]
    ring = cp.COPY_RING
    if (geo["stages"], geo["chunk"], geo["ctas"]) != \
            (ring.stages, ring.chunk, ring.ctas) \
            or geo["blocks_per_sm"] < ring.ctas:
        raise RuntimeError(f"K3: the library runs {geo}, COPY_RING is {ring}")
    print(f"K3 copy ring: S={geo['stages']}, CHUNK={geo['chunk']} B, "
          f"{geo['ctas']} CTAs an SM of {geo['blocks_per_sm']} that fit, "
          f"{geo['sms']} SMs, {geo['threads']} threads a CTA, dynamic shared "
          f"memory {geo['smem_bytes']} B a CTA; {r['registers']} registers, "
          f"{r['spill_stores']} B spill stores, {r['spill_loads']} B spill "
          f"loads, {r['stack']} B stack (ptxas)")
    # bring the clocks up before anything is timed (~1 s of streaming)
    x = torch.ones(1 << 28, device="cuda")
    for _ in range(1000):
        x.mul_(1.0)
    torch.cuda.synchronize()
    return card, resources


def _event_ms(fn, iterations):
    """ms a call over `iterations` calls between CUDA events, after one
    warm-up call: the caching allocator then holds the outputs' blocks, and
    no cudaMalloc stalls the host inside the window (one did, up to 23 ms)."""
    from cloudsc_tpu_torch.bench.timing import event_ms

    return event_ms(fn, iterations, warmup=1)


def _device_ms(fn, iterations):
    """ms a call of `fn` on the card alone: one warm-up call, then
    `iterations` calls issued while a spin kernel (`torch.cuda._sleep`)
    holds the stream, between CUDA events, so that a call whose host issue
    is as long as its kernel (zdqs_row's checks and row table, against a
    0.38 ms fp32 kernel) is timed by its kernel. Raises if the spin ended
    before the last call was issued."""
    import torch

    fn()
    torch.cuda.synchronize()
    spin_start, start, stop = (torch.cuda.Event(enable_timing=True)
                               for _ in range(3))
    spin_start.record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iterations):
        fn()
    issue_ms = (time.perf_counter() - t0) * 1e3
    stop.record()
    stop.synchronize()
    spin_ms = spin_start.elapsed_time(start)
    if issue_ms >= spin_ms:
        raise RuntimeError(f"the spin ({spin_ms:.2f} ms) ended before the "
                           f"{iterations} calls were issued "
                           f"({issue_ms:.2f} ms)")
    return start.elapsed_time(stop) / iterations


def _check_fields(tag, got, want):
    """Kernel against plain version, field by field (CloudscOutputs): fp64
    errsum/refsum < FP64_TOL, fp32 max-abs/max-ref <= 1e-5; returns the max
    abs err."""
    import torch

    max_abs = 0.0
    for name in want._fields:
        a = getattr(got, name).double()
        b = getattr(want, name).double()
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"{tag} {name}: shape or non-finite")
        diff = (a - b).abs()
        max_abs = max(max_abs, float(diff.max()))
        if getattr(got, name).dtype == torch.float64:
            err = _relerr(a.cpu().numpy(), b.cpu().numpy())
            ok = err < FP64_TOL
        else:
            err = float(diff.max()) / max(float(b.abs().max()), 1e-30)
            ok = err <= 1e-5
        if not ok:
            raise RuntimeError(f"{tag} {name}: kernel vs plain {err:.3e}")
    return max_abs


def phase1_kernel_vs_plain(inp, params):
    """Kernel against the plain version on the main path's pack; returns
    per-dtype (max_abs_err, kernel ms over ITERATIONS, plain ms for one
    call, modeled bytes the step moves)."""
    import torch

    from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
    from cloudsc_tpu_torch.runtime import tracing
    from cloudsc_tpu_torch.runtime.driver import CloudscDriver

    results = {}
    for dtype in (torch.float64, torch.float32):
        tag = "fp64" if dtype == torch.float64 else "fp32"
        driver = CloudscDriver(params, inp.ptsphy, dtype=dtype, device="cuda")
        c, consts = driver.step.c, driver.step.consts
        p = driver.prepare(inp).to("cuda")
        before = tracing.counter("ops.k1")
        got = cc.assemble(cc.cloudsc_fused(p, c, consts), p, c)  # warm-up
        torch.cuda.synchronize()
        ms = _event_ms(lambda: cc.cloudsc_fused(p, c, consts), ITERATIONS)
        calls = 2 + ITERATIONS  # the check's call, the warm-up, the window
        rose = tracing.counter("ops.k1") - before
        if rose != calls:
            raise RuntimeError(f"{tag}: ops.k1 rose by {rose}, expected "
                               f"{calls}")
        plain_ms = _event_ms(lambda: cc.cloudsc_fused_plain(p, c), 1)
        if tracing.counter("ops.k1") - before != calls:
            raise RuntimeError("the plain version launched the kernel")
        want = cc.assemble(cc.cloudsc_fused_plain(p, c), p, c)
        max_abs = _check_fields(tag, got, want)
        if max_abs != 0.0:
            raise RuntimeError(f"{tag}: kernel not bitwise equal to the plain "
                               f"version (max abs err {max_abs:.3e})")
        print(f"phase 1 {tag}: kernel == plain version bit for bit on all 21 "
              f"fields, max abs err {max_abs:.3e}, launches {calls}")
        # modeled bytes the step must move: the pack and col in, the three
        # output buffers out, each once (the k+1 rereads assumed cached)
        nbytes = (p.pack.numel() + p.col.numel()
                  + p.nlev * len(cc.OLEV_ROWS) * p.ncol
                  + (p.nlev + 1) * len(cc.OHALF_ROWS) * p.ncol
                  + p.ncol) * p.pack.element_size()
        results[tag] = (max_abs, ms, plain_ms, nbytes)
        del p, got, want
        torch.cuda.empty_cache()
    return results


def phase1_ragged(params):
    """K1 against its plain version on the driver's pack at RAGGED_NCOL
    columns, fp64 and fp32: every output buffer bit for bit."""
    import torch

    from cloudsc_tpu_torch import data
    from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
    from cloudsc_tpu_torch.runtime.driver import CloudscDriver

    inp = data.load_input(data.default_input_path(), RAGGED_NCOL)
    for dtype in (torch.float64, torch.float32):
        tag = "fp64" if dtype == torch.float64 else "fp32"
        driver = CloudscDriver(params, inp.ptsphy, dtype=dtype, device="cuda")
        c, consts = driver.step.c, driver.step.consts
        p = driver.prepare(inp).to("cuda")
        got = cc.cloudsc_fused(p, c, consts)
        want = cc.cloudsc_fused_plain(p, c)
        for name, a, b in zip(("o_lev", "o_half", "o_prainfrac"), got, want):
            if a.shape != b.shape or not bool(torch.isfinite(a).all()) \
                    or not torch.equal(a, b):
                raise RuntimeError(f"{tag} {name} at {RAGGED_NCOL} columns: "
                                   f"kernel != plain version (max abs err "
                                   f"{float((a - b).abs().max()):.3e})")
        print(f"phase 1 {tag} at {RAGGED_NCOL} columns: kernel == plain "
              f"version bit for bit on all three buffers")


def phase_foldo(inp, params):
    """The flux rows' kernel against its plain loop at NGPTOT columns, fp64
    and fp32, from the driver's pack and from a field dict expanded on the
    card, PFPLSL/N the views of K1's o_half: all four rows bit for bit, one
    launch a call. Returns per dtype (kernel ms over ITERATIONS calls on
    the field dict, the pack's, the loop's ms a call, (bound ms, by), the
    lab's launches: two checked calls and the timing loops, the largest
    |kernel - loop| over the rows compared)."""
    import torch

    from cloudsc_tpu_torch.bench import timing
    from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
    from cloudsc_tpu_torch.physics.cloudsc import fields_on_device
    from cloudsc_tpu_torch.runtime import tracing
    from cloudsc_tpu_torch.runtime.driver import CloudscDriver

    results = {}
    for dtype in (torch.float64, torch.float32):
        tag = "fp64" if dtype == torch.float64 else "fp32"
        driver = CloudscDriver(params, inp.ptsphy, dtype=dtype, device="cuda")
        c = driver.step.c
        p = driver.prepare(inp).to("cuda")
        o_half = cc.cloudsc_fused(p, c, driver.step.consts)[1]
        half = {n: o_half[:, j] for j, n in enumerate(cc.ohalf_rows(True))}
        fields = fields_on_device(inp, dtype, "cuda")
        ms, err = {}, 0.0
        launches = tracing.counter("launches.foldo")
        for kind, src in (("pack", p), ("fields", fields)):
            got, want = dict(half), dict(half)
            before = tracing.counter("launches.foldo")
            cc.foldo_synthesize(got, src, c)
            rose = tracing.counter("launches.foldo") - before
            if rose != 1:
                raise RuntimeError(f"{tag} {kind}: launches.foldo rose by "
                                   f"{rose}")
            cc.foldo_synthesize_plain(want, src, c)
            for name in cc.FOLDO_ROWS:
                a, b = got[name], want[name]
                if a.shape == b.shape:
                    err = max(err, float((a - b).abs().max()))
                if a.shape != b.shape or not torch.equal(a, b):
                    raise RuntimeError(
                        f"{tag} {kind} {name}: kernel != plain loop (max abs "
                        f"err {float((a - b).abs().max()):.3e})")
            ms[kind] = _event_ms(lambda: cc.foldo_synthesize(dict(half), src,
                                                             c), ITERATIONS)
            print(f"phase 1g {tag} {kind}: the flux rows' kernel == plain "
                  f"loop bit for bit on all four rows")
        plain_ms = _event_ms(lambda: cc.foldo_synthesize_plain(
            dict(half), fields, c), 3)
        nlev, size = inp.klev, p.pack.element_size()
        nbytes = (3 * (nlev + 1) + 2 * nlev + 4 * (nlev + 1)) * NGPTOT * size
        bound = timing.bound(nbytes, FOLDO_FLOP_PER_LEVEL * nlev * NGPTOT,
                             tag)
        launches = tracing.counter("launches.foldo") - launches
        results[tag] = (ms["fields"], ms["pack"], plain_ms, bound, launches,
                        err)
        del p, o_half, half, fields, got, want
        torch.cuda.empty_cache()
    return results


def phase1a_diagnostic_bodies(inp, params):
    """K1's floor and init bodies against their plain versions on the
    driver's pack, fp64 and fp32, and the three bodies' times; returns
    {(mode, tag): (max_abs_err, ms, plain_ms)} and the modeled bytes a step
    per tag."""
    import torch

    from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
    from cloudsc_tpu_torch.runtime import tracing
    from cloudsc_tpu_torch.runtime.driver import CloudscDriver

    results, nbytes = {}, {}
    for dtype in (torch.float64, torch.float32):
        tag = "fp64" if dtype == torch.float64 else "fp32"
        driver = CloudscDriver(params, inp.ptsphy, dtype=dtype, device="cuda")
        c, consts = driver.step.c, driver.step.consts
        p = driver.prepare(inp).to("cuda")
        for mode, plain, counter in (
                ("floor", lambda: cc.cloudsc_floor_plain(p),
                 "launches.k1.floor"),
                ("init", lambda: cc.cloudsc_init_plain(p, c),
                 "launches.k1.init")):
            before = tracing.counter(counter)
            got = cc.assemble(cc.cloudsc_fused(p, c, consts, mode=mode), p, c)
            torch.cuda.synchronize()
            ms = _event_ms(lambda: cc.cloudsc_fused(p, c, consts, mode=mode),
                           ITERATIONS)
            if tracing.counter(counter) - before != 2 + ITERATIONS:
                raise RuntimeError(f"{tag} {mode}: {counter} rose by "
                                   f"{tracing.counter(counter) - before}")
            plain_ms = _event_ms(plain, 1)
            want = cc.assemble(plain(), p, c)
            if tracing.counter(counter) - before != 2 + ITERATIONS:
                raise RuntimeError(f"the plain {mode} body launched a kernel")
            max_abs = _check_fields(f"{tag} {mode}", got, want)
            if mode == "floor" and max_abs != 0.0:
                raise RuntimeError(f"{tag} floor: not bitwise ({max_abs:.3e})")
            results[(mode, tag)] = (max_abs, ms, plain_ms)
            print(f"phase 1a {tag} {mode}: kernel == plain version within bar "
                  f"on all 21 fields, max abs err {max_abs:.3e}, launches "
                  f"{2 + ITERATIONS}")
        full_ms = _event_ms(lambda: cc.cloudsc_fused(p, c, consts), ITERATIONS)
        results[("full", tag)] = (None, full_ms, None)
        nbytes[tag] = (p.pack.numel() + p.col.numel()
                       + p.nlev * len(cc.OLEV_ROWS) * p.ncol
                       + (p.nlev + 1) * len(cc.OHALF_ROWS) * p.ncol
                       + p.ncol) * p.pack.element_size()
        del p, got, want
        torch.cuda.empty_cache()
    return results, nbytes


def phase1b_overlap_probe():
    """K2 against its plain version at the lab's default size, every
    variant x mode x w of the lab's default sweep (the instantiations the
    lab path launches); then its times there. Returns (max abs err,
    {(variant, mode, w): ms}, (ms, plain ms) of prod/full/w=8)."""
    import torch

    from cloudsc_tpu_torch.bench import overlap_probe as ob
    from cloudsc_tpu_torch.bench import timing
    from cloudsc_tpu_torch.kernels import cuda_probes as cp
    from cloudsc_tpu_torch.runtime import tracing

    a = ob.parse_args([])
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (a.nk2, a.rr, a.ni * a.sb * cp.LANES)
    x = torch.rand(shape, device="cuda", generator=gen)
    # values over 12 decades, so the 1e-8/1e-9 terms show in fp32; block 0
    # under 0.5 at even levels, so branchy takes both branches
    x = x * 10.0 ** (-12 * torch.rand(shape, device="cuda", generator=gen))
    x[:, 0, ::a.sb * cp.LANES] = 0.9
    x[::2, :, :a.sb * cp.LANES] *= 0.4
    col = torch.rand(cp.COL_SHAPE, device="cuda", generator=gen)
    max_abs, n = 0.0, 0
    for variant in cp.VARIANTS:
        for mode in cp.OVERLAP_MODES:
            for w in a.w:
                before = tracing.counter("launches.overlap")
                got = cp.overlap_step(x, col, variant, mode, w, a.sb)
                want = cp.overlap_plain(x, col, variant, mode, w, a.sb)
                torch.cuda.synchronize()
                if tracing.counter("launches.overlap") - before != 1:
                    raise RuntimeError("overlap_step did not count 1 launch")
                for g, h in zip(got, want):
                    if (g is None) != (h is None):
                        raise RuntimeError(f"{variant} {mode}: outputs")
                    if g is None:
                        continue
                    if g.shape != h.shape or not bool(torch.isfinite(g).all()):
                        raise RuntimeError(f"{variant} {mode} w={w}: shape "
                                           f"or non-finite")
                    diff = float((g - h).abs().max())
                    max_abs = max(max_abs, diff)
                    if diff / max(float(h.abs().max()), 1e-30) > OVERLAP_TOL:
                        raise RuntimeError(f"overlap {variant} {mode} w={w}: "
                                           f"kernel vs plain {diff:.3e}")
                n += 1
                del got, want
    print(f"phase 1b: overlap kernel == plain version in {n} cases "
          f"(5 variants x 2 modes x w in {a.w}, {shape}), max abs err "
          f"{max_abs:.3e}")
    x = torch.ones(shape, device="cuda")
    times = {}
    for variant in cp.VARIANTS:
        for mode in cp.OVERLAP_MODES:
            for w in (0, 8):
                times[(variant, mode, w)] = _event_ms(
                    lambda: cp.overlap_step(x, col, variant, mode, w, a.sb),
                    ITERATIONS)
    plain_ms = _event_ms(
        lambda: cp.overlap_plain(x, col, "prod", "full", 8, a.sb), 1)
    del x
    torch.cuda.empty_cache()
    # prod/full/w=8: x read and out written once, colo and col/col_out;
    # a multiply-add a value and chain step, two for each of the 33 scratch
    # rows and one for each of the 3 lookahead rows a level, a multiply for
    # colo and col_out
    nk2, rr, ncol = shape
    nbytes = (2 * nk2 * rr * ncol + ncol + 2 * col.numel()) * 4
    flops = 2 * nk2 * ncol * (rr * 8 + 2 * cp.SCR_ROWS + cp.LOOK_ROWS) \
        + ncol + col.numel()
    return max_abs, times, (times[("prod", "full", 8)], plain_ms,
                            timing.bound(nbytes, flops, "fp32"))


def phase1c_copy_probe():
    """K3 against x * 1.0000001 at the lab's default size, bitwise; returns
    {name: (ms, plain ms, bytes a pass, max abs err)}."""
    import torch

    from cloudsc_tpu_torch.bench import dma_probe as db
    from cloudsc_tpu_torch.kernels import cuda_probes as cp
    from cloudsc_tpu_torch.runtime import tracing

    col = torch.rand(cp.COL_SHAPE, device="cuda")
    results = {}
    sb1 = db.probes(db.parse_args(["--sb", "1", "--only", "strided"]))
    for key, probe in [(p.name, p) for p in db.probes(db.parse_args([]))] \
            + [("strided sb=1", sb1[0])]:
        x = torch.rand(probe.shape, device="cuda")
        before = tracing.counter("launches.copy")
        got = cp.dma_copy(x, col, probe)
        want = cp.dma_copy_plain(x, col)
        if tracing.counter("launches.copy") - before != 1:
            raise RuntimeError("dma_copy did not count 1 launch")
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise RuntimeError(f"copy {key}: kernel != x * 1.0000001")
        max_abs = max(float((g - h).abs().max()) for g, h in zip(got, want))
        del got, want
        ms = _event_ms(lambda: cp.dma_copy(x, col, probe), ITERATIONS)
        plain_ms = _event_ms(lambda: cp.dma_copy_plain(x, col), ITERATIONS)
        results[key] = (ms, plain_ms, 2 * x.numel() * 4, max_abs)
        del x
        torch.cuda.empty_cache()
    print(f"phase 1c: copy kernel == x * 1.0000001 bitwise for "
          f"{', '.join(results)}")
    return results


def phase1d_versions(inp, params, versions):
    """Each scheme version of VERSION_CASES at NGPTOT columns, fp64 and
    fp32: its main path with the per-version counts reset and read, then
    its build against its plain version on the driver's pack (bit for bit
    on all 21 fields) and against the reference configuration's build on
    the same input (must differ; that build is timed there too). Returns
    {name: {tag: record}}."""
    import torch

    from cloudsc_tpu_torch.bench import timing
    from cloudsc_tpu_torch.data import synthetic
    from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
    from cloudsc_tpu_torch.physics import scheme
    from cloudsc_tpu_torch.runtime import tracing
    from cloudsc_tpu_torch.runtime.driver import CloudscDriver

    results = {}
    for name, v in versions.items():
        vinp, vparams, cfg = synthetic.version_case(name, inp, params)
        results[name] = {}
        for dtype in (torch.float64, torch.float32):
            tag = "fp64" if dtype == torch.float64 else "fp32"
            driver = CloudscDriver(vparams, vinp.ptsphy, dtype=dtype,
                                   device="cuda", scheme_config=cfg)
            c, consts = driver.step.c, driver.step.consts
            if cc.kernel_version(c) != v:
                raise RuntimeError(f"{name}: runs {cc.kernel_version(c)}")
            tracing.reset()
            out, timings, _ = driver.run(vinp, iterations=ITERATIONS,
                                         fetch_outputs=False)
            launches = tracing.keyed("launches.k1.version")
            if launches != {v: 1 + ITERATIONS}:
                raise RuntimeError(f"{name} {tag} main path: launches "
                                   f"{launches}, expected {1 + ITERATIONS} "
                                   f"of {v}")
            if not all(bool(torch.isfinite(a).all()) for a in out):
                raise RuntimeError(f"{name} {tag}: non-finite outputs")
            del out
            p = driver.prepare(vinp).to("cuda")
            got = cc.cloudsc_fused(p, c, consts)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            want = cc.cloudsc_fused_plain(p, c)
            stop.record()
            stop.synchronize()
            plain_ms = start.elapsed_time(stop)
            got_a, want_a = cc.assemble(got, p, c), cc.assemble(want, p, c)
            max_abs = _check_fields(f"{name} {tag}", got_a, want_a)
            if max_abs != 0.0 or not all(torch.equal(a, b)
                                         for a, b in zip(got, want)):
                raise RuntimeError(f"{name} {tag}: kernel not bitwise equal "
                                   f"to the plain version (max abs err "
                                   f"{max_abs:.3e})")
            del want, want_a
            ms = _event_ms(lambda: cc.cloudsc_fused(p, c, consts), ITERATIONS)
            # the reference configuration's build on the same input and
            # column order
            c0 = scheme.derived_consts(params, vinp.ptsphy, dtype)
            p0 = cc.pack_inputs_folded(vinp, params, None, dtype,
                                       driver._group_perm).to("cuda")
            base = cc.assemble(cc.cloudsc_fused(p0, c0), p0, c0)
            changed = [f for f in base._fields
                       if not torch.equal(getattr(got_a, f), getattr(base, f))]
            if not changed:
                raise RuntimeError(f"{name} {tag}: outputs equal the "
                                   f"reference configuration's build's")
            c0_consts = cc.const_vector(c0, "cuda")
            ref_ms = _event_ms(lambda: cc.cloudsc_fused(p0, c0, c0_consts),
                               ITERATIONS)
            results[name][tag] = dict(
                launches=launches[v], max_abs=max_abs, ms=ms, ref_ms=ref_ms,
                plain_ms=plain_ms, driver_ms=timings.compute_s * 1e3,
                rows=len(p.rows),
                bound=timing.bound(cc.k1_bytes(p),
                                   timing.K1_FLOP_PER_COLUMN * NGPTOT, tag))
            print(f"phase 1d {name} {tag} ({len(p.rows)} rows): kernel == "
                  f"plain version bit for bit on all 21 fields; main-path "
                  f"launches {launches[v]}; {len(changed)} of 21 fields "
                  f"differ from the reference configuration's build")
            del p, p0, got, got_a, base
            torch.cuda.empty_cache()
    return results


# the driver's switches, all unset at their defaults
FORM_ENV = ("CLOUDSC_FOLD_INPUTS", "CLOUDSC_FOLD_NEWTON",
            "CLOUDSC_FOLD_CURVES", "CLOUDSC_FOLD_DEP", "CLOUDSC_FOLD_OUTPUTS",
            "CLOUDSC_PACKED_STORAGE", "CLOUDSC_SCAN_PACKED",
            "CLOUDSC_GROUP_COLUMNS", "CLOUDSC_GROUP_SORT",
            "CLOUDSC_S521_ROUND_SKIP")


def _form_env(form: dict) -> dict:
    """The driver's switches that select the build's form `form` ({
    fold_inputs, fc, fn, fd, fold_outputs} keywords, each absent at its
    default)."""
    env = {}
    if form.get("fold_inputs") is False:
        env["CLOUDSC_FOLD_INPUTS"] = "0"
    if form.get("fold_outputs") is False:
        env["CLOUDSC_FOLD_OUTPUTS"] = "0"
    if form.get("fc"):
        env["CLOUDSC_FOLD_CURVES"] = "1"
    if form.get("fn") is False:
        env["CLOUDSC_FOLD_NEWTON"] = "0"
    if form.get("fd"):
        env["CLOUDSC_FOLD_DEP"] = "1"
    return env


class _env:
    """The driver's switches set to `values` (the others unset) inside the
    block, restored after."""

    def __init__(self, values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.pop(k, None) for k in FORM_ENV}
        os.environ.update(self.values)

    def __exit__(self, *exc):
        for k in FORM_ENV:
            os.environ.pop(k, None)
            if self.saved[k] is not None:
                os.environ[k] = self.saved[k]


def form_versions(params, ptsphy) -> dict:
    """FORM_CASES name -> the KernelVersion the driver runs under its
    switches and configuration."""
    import torch

    from cloudsc_tpu_torch.data import synthetic
    from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
    from cloudsc_tpu_torch.physics import scheme

    out = {}
    for name, (form, cfg) in synthetic.FORM_CASES.items():
        with _env(_form_env(form)):
            flags, fo = cc.fold_flags(), cc.fold_outputs_flag()
            c = scheme.derived_consts(params, ptsphy, torch.float32,
                                      scheme.SchemeConfig(**cfg))
        out[name] = cc.kernel_version(c, flags, fo)
    return out


def phase_forms(params, forms):
    """Each FORM_CASES build at RAGGED_NCOL columns, fp64 and fp32: the
    driver's main path under its switches (one warm-up and one step), the
    per-version counts reset just before and read just after; then on the
    driver's pack the build against its plain version, all three buffers
    bit for bit (the four derivable flux rows in the buffer where the
    build writes them), and its time and the plain version's. A build that
    skips
    sections computes wrong physics by construction (set B drops the
    implicit solve, whose unsolved sums overflow fp32): its outputs need
    not be finite, and are held bit for bit, NaNs included. Returns {name:
    {tag: record}}."""
    import torch

    from cloudsc_tpu_torch import data
    from cloudsc_tpu_torch.bench import timing
    from cloudsc_tpu_torch.bench.kernel_lab import same_bits
    from cloudsc_tpu_torch.data import synthetic
    from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
    from cloudsc_tpu_torch.physics import scheme
    from cloudsc_tpu_torch.runtime import tracing
    from cloudsc_tpu_torch.runtime.driver import CloudscDriver

    inp = data.load_input(data.default_input_path(), RAGGED_NCOL)
    results = {}
    for name, (form, cfg) in synthetic.FORM_CASES.items():
        v = forms[name]
        results[name] = {}
        for dtype in (torch.float64, torch.float32):
            tag = "fp64" if dtype == torch.float64 else "fp32"
            with _env(_form_env(form)):
                driver = CloudscDriver(params, inp.ptsphy, dtype=dtype,
                                       device="cuda",
                                       scheme_config=scheme.SchemeConfig(
                                           **cfg))
                tracing.reset()
                out, _, _ = driver.run(inp, iterations=1, fetch_outputs=False)
                launches = tracing.keyed("launches.k1.version")
                p = driver.prepare(inp).to("cuda")
            if launches != {v: 2}:
                raise RuntimeError(f"form {name} {tag} main path: launches "
                                   f"{launches}, expected 2 of {v}")
            if not cfg.get("skip") and not all(
                    bool(torch.isfinite(a).all()) for a in out):
                raise RuntimeError(f"form {name} {tag}: non-finite outputs")
            del out
            c, consts, fo = driver.step.c, driver.step.consts, \
                driver.fold_outputs
            if cc.kernel_version(c, p.form, fo) != v or len(p.rows) != len(
                    cc.pack_rows(v.fc, v.fn, v.fd,
                                 fold_inputs=v.fold_inputs)):
                raise RuntimeError(f"form {name}: runs "
                                   f"{cc.kernel_version(c, p.form, fo)}")
            got = cc.cloudsc_fused(p, c, consts, fold_outputs=fo)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            want = cc.cloudsc_fused_plain(p, c, fo)
            stop.record()
            stop.synchronize()
            plain_ms = start.elapsed_time(stop)
            max_abs = 0.0
            for bname, a, b in zip(("o_lev", "o_half", "o_prainfrac"), got,
                                   want):
                if not cfg.get("skip") and not bool(torch.isfinite(a).all()):
                    raise RuntimeError(f"form {name} {tag} {bname}: "
                                       f"non-finite")
                if not same_bits(a, b):
                    err = (a - b).abs().nan_to_num(float("inf")).max()
                    raise RuntimeError(f"form {name} {tag} {bname}: kernel "
                                       f"!= plain version (max abs err "
                                       f"{float(err):.3e})")
            del got, want
            ms = _event_ms(lambda: cc.cloudsc_fused(p, c, consts,
                                                    fold_outputs=fo),
                           ITERATIONS)
            results[name][tag] = dict(
                launches=launches[v], max_abs=max_abs, ms=ms,
                plain_ms=plain_ms, rows=len(p.rows),
                bound=timing.bound(cc.k1_bytes(p, fo),
                                   timing.K1_FLOP_PER_COLUMN * p.ncol, tag))
            print(f"phase forms {name} {tag} ({len(p.rows)} rows): kernel == "
                  f"plain version bit for bit on all three buffers at "
                  f"{RAGGED_NCOL} columns; main-path launches {launches[v]}")
            del p
            torch.cuda.empty_cache()
    return results


def phase_form_main_path(inp, params, ref_dev):
    """The main path at NGPTOT columns in fp64 with CLOUDSC_FOLD_NEWTON=0
    (the in-line CUADJTQ), with CLOUDSC_FOLD_CURVES=1 CLOUDSC_FOLD_DEP=1
    (fc+fn+fd) and with CLOUDSC_FOLD_INPUTS=0 (the unfolded pack):
    launches by version, validation on the card under the fp64 bars, the
    build against its plain version on the driver's pack (all three
    buffers bit for bit), and K1 timed by CUDA events beside the reference
    build on the same input (two windows each, alternating, the least of
    each's). Returns {name: record}."""
    import torch

    from cloudsc_tpu_torch.bench import timing
    from cloudsc_tpu_torch.bench.kernel_lab import same_bits
    from cloudsc_tpu_torch.data import synthetic
    from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
    from cloudsc_tpu_torch.runtime import tracing
    from cloudsc_tpu_torch.runtime.driver import CloudscDriver

    results = {}
    for name in ("fn_off", "fc_fn_fd", "unfolded"):
        with _env(_form_env(synthetic.FORM_CASES[name][0])):
            driver = CloudscDriver(params, inp.ptsphy, dtype=torch.float64,
                                   device="cuda")
            tracing.reset()
            t0 = time.perf_counter()
            out, timings, _ = driver.run(inp, iterations=ITERATIONS,
                                         fetch_outputs=False)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = tracing.keyed("launches.k1.version")
            t0 = time.perf_counter()
            host = driver.prepare(inp)
            pack_s = time.perf_counter() - t0
            p = host.to("cuda")
            del host
        v = cc.kernel_version(driver.step.c, p.form, driver.fold_outputs)
        if launches != {v: 1 + ITERATIONS} or v == cc.DEFAULT_VERSION:
            raise RuntimeError(f"{name} main path: launches {launches}")
        errs, _ = _card_validation(f"form {name} fp64", out, ref_dev)
        del out
        flagged = _check_bars(f"phase form main path {name} fp64", errs)
        c, consts = driver.step.c, driver.step.consts
        got = cc.cloudsc_fused(p, c, consts)
        t0 = time.perf_counter()
        want = cc.cloudsc_fused_plain(p, c)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        for bname, a, b in zip(("o_lev", "o_half", "o_prainfrac"), got,
                               want):
            if not same_bits(a, b):
                err = (a - b).abs().nan_to_num(float("inf")).max()
                raise RuntimeError(f"form {name} fp64 {bname} at {NGPTOT} "
                                   f"columns: kernel != plain version (max "
                                   f"abs err {float(err):.3e})")
        del got, want
        p0 = CloudscDriver(params, inp.ptsphy, dtype=torch.float64,
                           device="cuda").prepare(inp).to("cuda")
        form_ms, ref_ms = [], []
        for _ in range(2):
            form_ms.append(_event_ms(lambda: cc.cloudsc_fused(p, c, consts),
                                     ITERATIONS))
            ref_ms.append(_event_ms(lambda: cc.cloudsc_fused(p0, c, consts),
                                    ITERATIONS))
        ms, ref_ms = min(form_ms), min(ref_ms)
        results[name] = dict(launches=launches[v], ms=ms, ref_ms=ref_ms,
                             plain_ms=plain_ms, rows=len(p.rows),
                             driver_ms=timings.compute_s * 1e3,
                             pack_s=pack_s, h2d_s=timings.h2d_s,
                             run_s=run_s,
                             flagged=sorted(flagged),
                             bound=timing.bound(
                                 cc.k1_bytes(p),
                                 timing.K1_FLOP_PER_COLUMN * NGPTOT, "fp64"))
        print(f"phase form main path {name} fp64 ({len(p.rows)} rows): 21 "
              f"fields within FP64_TOL and the JAX bar, validated on the "
              f"card, {launches[v]} launches of {name}'s build, kernel == "
              f"plain version bit for bit on all three buffers at {NGPTOT} "
              f"columns; K1 {ms:.4f} ms, the reference build on the same "
              f"input {ref_ms:.4f} ms (the least of two windows each, "
              f"alternating)")
        del p, p0
        torch.cuda.empty_cache()
    return results


def phase_fields_entry(inp, params):
    """The per-field entry at NGPTOT columns. In fp32 the main path with
    CLOUDSC_PACKED_STORAGE=0 (the field dict on the card, read in place by
    the unfolded build) with the counters reset just before and read just
    after (the unfolded build alone, every launch counted in
    `launches.k1.in_place`; the host-packed CLOUDSC_FOLD_INPUTS=0 main path
    none), every field equal bit for bit to the CLOUDSC_FOLD_INPUTS=0 main
    path's (the host's unfolded pack) after the ungroup, and
    `cloudsc_fused_fields` on `fields_on_device`'s dict equal bit for bit
    to both. In fp32 and fp64 `cloudsc_fused` on the card's field dict (the
    Rows policy) against `cloudsc_fused_plain` on the same dict (through
    its row table, on the card), all three buffers bit for bit, with its
    time beside its bound. Returns a record."""
    import torch

    from cloudsc_tpu_torch.bench import timing
    from cloudsc_tpu_torch.bench.kernel_lab import same_bits
    from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
    from cloudsc_tpu_torch.physics.cloudsc import fields_on_device
    from cloudsc_tpu_torch.runtime import tracing
    from cloudsc_tpu_torch.runtime.driver import CloudscDriver

    def run(env):
        with _env(env):
            driver = CloudscDriver(params, inp.ptsphy, dtype=torch.float32,
                                   device="cuda")
            tracing.reset()
            out, t, _ = driver.run(inp, iterations=ITERATIONS,
                                   fetch_outputs=False)
        return driver, out, t, tracing.keyed("launches.k1.version"), \
            tracing.counter("launches.k1.in_place"), \
            tracing.counter("launches.zdqs")

    driver, fields_out, t_fields, launches, in_place, zdqs_launches = run(
        {"CLOUDSC_PACKED_STORAGE": "0"})
    v = cc.kernel_version(driver.step.c, cc.ROWS_FORM)
    if launches != {v: 1 + ITERATIONS} or in_place != launches[v] or \
            zdqs_launches != launches[v] or \
            driver.config_name("cuda") != "cuda/fields+unfold+foldo":
        raise RuntimeError(f"per-field main path: launches {launches}, in "
                           f"place {in_place}, zdqs_kernel {zdqs_launches}, "
                           f"{driver.config_name('cuda')}")
    _, pack_out, t_pack, _, pack_in_place, pack_zdqs = run(
        {"CLOUDSC_FOLD_INPUTS": "0"})
    if (pack_in_place, pack_zdqs) != (0, 0):
        raise RuntimeError(f"the host-packed main path read {pack_in_place} "
                           f"steps in place, {pack_zdqs} zdqs_kernel "
                           f"launches")
    fields = fields_on_device(inp, torch.float32, "cuda")
    entry_out = cc.cloudsc_fused_fields(fields, params, inp.ptsphy)
    for f, a, b, e in zip(pack_out._fields, fields_out, pack_out, entry_out):
        if not (torch.equal(a, b) and torch.equal(e, b)):
            raise RuntimeError(f"per-field {f}: differs from the unfolded "
                               f"pack's main path")
    del fields_out, pack_out, entry_out, fields
    rec = dict(launches=launches[v], in_place=in_place,
               zdqs_launches=zdqs_launches,
               driver_ms=t_fields.compute_s * 1e3,
               unfolded_driver_ms=t_pack.compute_s * 1e3)
    print(f"phase fields entry fp32: the per-field main path "
          f"({launches[v]} launches of the dict's build, {in_place} in "
          f"place, {zdqs_launches} of zdqs_kernel), cloudsc_fused_fields "
          f"and the unfolded pack's main path (none in place, the in-line "
          f"CUADJTQ) equal bit for bit on all 21 fields")
    torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.float64):
        tag = "fp64" if dtype == torch.float64 else "fp32"
        d = CloudscDriver(params, inp.ptsphy, dtype=dtype, device="cuda")
        c, consts = d.step.c, d.step.consts
        fields = fields_on_device(inp, dtype, "cuda")
        # the modeled bytes of the pack the dict stands in for
        p = cc.pack_inputs(fields, params, None, inp.ptsphy)
        bound = timing.bound(cc.k1_bytes(p),
                             timing.K1_FLOP_PER_COLUMN * NGPTOT, tag)
        del p
        tracing.reset()
        got = cc.cloudsc_fused(fields, c, consts)
        counted = (tracing.counter("launches.k1.in_place"),
                   tracing.counter("ops.pack"))
        if counted != (1, 0):
            raise RuntimeError(f"{tag}: cloudsc_fused on the dict counted "
                               f"(in place, ops.pack) {counted}")
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        want = cc.cloudsc_fused_plain(fields, c)
        stop.record()
        stop.synchronize()
        plain_ms = start.elapsed_time(stop)
        max_abs = 0.0
        for bname, a, b in zip(("o_lev", "o_half", "o_prainfrac"), got,
                               want):
            max_abs = max(max_abs, float((a.double() - b.double()).abs()
                                         .max()))
            if not bool(torch.isfinite(a).all()) or not same_bits(a, b):
                raise RuntimeError(f"{tag} {bname}: cloudsc_fused on the "
                                   f"dict != the plain version on it "
                                   f"(max abs err {max_abs:.3e})")
        del got, want
        rows_ms = _event_ms(lambda: cc.cloudsc_fused(fields, c, consts),
                            ITERATIONS)
        # zdqs_kernel alone: against its plain version, its time and bound
        tracing.reset()
        z = cc.zdqs_row(fields, c)
        if tracing.counter("launches.zdqs") != 1:
            raise RuntimeError(f"{tag}: zdqs_row counted "
                               f"{tracing.counter('launches.zdqs')} launches")
        start.record()
        zp = cc.zdqs_plain(fields, c)
        stop.record()
        stop.synchronize()
        zdqs_plain_ms = start.elapsed_time(stop)
        zdqs_max_abs = float((z.double() - zp.double()).abs().max())
        if not bool(torch.isfinite(z).all()) or not same_bits(z, zp):
            raise RuntimeError(f"{tag}: zdqs_kernel != its plain version "
                               f"(max abs err {zdqs_max_abs:.3e})")
        del z, zp
        zdqs_ms = _device_ms(lambda: cc.zdqs_row(fields, c), ITERATIONS)
        nlev, ktop = inp.klev, c.NCLDTOP - 1
        zdqs_bound = timing.bound(
            (ZDQS_ROWS_READ * (nlev - ktop) + nlev + 1) * NGPTOT
            * (8 if tag == "fp64" else 4),
            ZDQS_FLOP_PER_ELEMENT * (nlev - ktop) * NGPTOT, tag)
        rec[tag] = dict(max_abs=max_abs, ms=rows_ms, plain_ms=plain_ms,
                        bound=bound, zdqs_ms=zdqs_ms,
                        zdqs_plain_ms=zdqs_plain_ms, zdqs_bound=zdqs_bound,
                        zdqs_max_abs=zdqs_max_abs)
        print(f"phase fields entry {tag}: cloudsc_fused on the dict == the "
              f"plain version on the same dict bit for bit on all three "
              f"buffers; {rows_ms:.4f} ms (zdqs_kernel and K1), bound "
              f"{bound[0]:.4f} ms (by {bound[1]}) = "
              f"{bound[0] / rows_ms:.3f} of its time; zdqs_kernel == "
              f"zdqs_plain bit for bit")
        del fields, d
        torch.cuda.empty_cache()
    return rec


def phase_layouts(inp, params):
    """The main path in fp32 at NGPTOT columns in the cyclic layout
    (CLOUDSC_GROUP_COLUMNS=0) and the grouped unsorted one
    (CLOUDSC_GROUP_SORT=0): after the ungroup every field equals the sorted
    main path's bit for bit (K1 has nothing across columns). Returns
    {layout: K1 ms a step in the driver loop}."""
    import torch

    from cloudsc_tpu_torch.runtime.driver import CloudscDriver

    base, t, _ = CloudscDriver(params, inp.ptsphy, dtype=torch.float32,
                               device="cuda").run(inp, iterations=ITERATIONS,
                                                  fetch_outputs=False)
    results = {"sorted": t.compute_s * 1e3}
    for name, env in (("cyclic", {"CLOUDSC_GROUP_COLUMNS": "0"}),
                      ("grouped", {"CLOUDSC_GROUP_SORT": "0"})):
        with _env(env):
            out, t, _ = CloudscDriver(
                params, inp.ptsphy, dtype=torch.float32, device="cuda").run(
                    inp, iterations=ITERATIONS, fetch_outputs=False)
        for f, a, b in zip(base._fields, out, base):
            if not torch.equal(a, b):
                raise RuntimeError(f"layout {name} {f}: differs from the "
                                   f"sorted main path (max abs err "
                                   f"{float((a - b).abs().max()):.3e})")
        results[name] = t.compute_s * 1e3
        print(f"phase layouts {name} fp32: all 21 fields equal the sorted "
              f"main path's bit for bit after the ungroup")
        del out
    del base
    torch.cuda.empty_cache()
    return results


def phase5_lab_path():
    """The lab's entry points at their defaults (overlap with all five
    variants); every lab kernel's count reset just before and read just
    after. Returns the counts."""
    from cloudsc_tpu_torch.bench import activity_probe, dma_probe, \
        kernel_lab, overlap_probe
    from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
    from cloudsc_tpu_torch.kernels import cuda_probes as cp
    from cloudsc_tpu_torch.runtime import tracing

    tracing.reset()
    small = str(RAGGED_NCOL)
    for mod, argv in (
            (kernel_lab, ["--modes", "full", "init", "floor",
                          "--precision", "fp32", "fp64"]),
            (kernel_lab, ["--ngptot", small, "--skip", "s45r",
                          "--foldn", "0", "--precision", "fp32", "fp64"]),
            (kernel_lab, ["--ngptot", small, "--modes", "full", "init",
                          "floor", "--fold", "0", "--foldo", "0",
                          "--precision", "fp32", "fp64"]),
            (activity_probe, ["--device", "cuda", "--ngptot", small]),
            (overlap_probe, ["--variants", *cp.VARIANTS]),
            (dma_probe, [])):
        if mod.main(argv) != 0:
            raise RuntimeError(f"{mod.__name__} {argv} failed")
    for argv, lab_form in (
            ("--skip s45r --foldn 0",
             cc.KernelVersion(fn=False, skip=frozenset({"s45r"}))),
            ("--fold 0 --foldo 0",
             cc.KernelVersion(fn=False, fold_inputs=False,
                              fold_outputs=False))):
        if tracing.counter("launches.k1.version", lab_form) == 0:
            raise RuntimeError(f"lab path: kernel_lab {argv} launched no "
                               f"build of that form")
    counts = {"cloudsc_fused": tracing.counter("ops.k1"),
              "cloudsc_floor": tracing.counter("launches.k1.floor"),
              "cloudsc_init": tracing.counter("launches.k1.init"),
              "overlap_probe": tracing.counter("launches.overlap"),
              "dma_copy": tracing.counter("launches.copy")}
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise RuntimeError(f"lab path: no launch of {missing}")
    print(f"phase 5 lab path: launches {counts}")
    return counts


def _card_validation(tag, out, ref_dev):
    """The outputs' shapes and finiteness, then the validation table from
    the norms reduced on the card; returns (FieldErrors, seconds)."""
    import numpy as np
    import torch

    from cloudsc_tpu_torch.validate import FIELD_ATTR, REF_DATASET, \
        VALIDATION_ORDER, device_field_norms, validate_from_norms

    for name, _ in VALIDATION_ORDER:
        a = getattr(out, FIELD_ATTR[name])
        if a.shape != ref_dev[REF_DATASET[name]].shape \
                or not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"{tag} {name}: wrong shape or non-finite")
    t0 = time.perf_counter()
    norms = device_field_norms(out, ref_dev).cpu().numpy()
    validate_s = time.perf_counter() - t0
    eps = float(np.finfo(np.float64 if tag.endswith("fp64")
                         else np.float32).eps)
    return validate_from_norms(norms, NGPTOT, work_eps=eps), validate_s


def _check_bars(tag, errs):
    """test_golden's bars on the validation table (fp64: FP64_TOL and the
    JAX engine's reading; fp32: FP32_TOL); returns the flagged fields."""
    bad = {}
    for e in errs:
        err = e.errsum / e.refsum if e.refsum > 0 else e.errsum
        # test_golden's comparisons: fp64 err < FP64_TOL, fp32 err <= tol
        if tag.endswith("fp64"):
            over = not err < FP64_TOL
        else:
            over = err > FP32_TOL.get(e.name, FP32_TOL_DEFAULT)
        if over:
            bad[e.name] = err
    if bad:
        raise RuntimeError(f"{tag} over tolerance: {bad}")
    flagged = {e.name: e.relerr for e in errs if e.flagged}
    if tag.endswith("fp64"):
        over = fp64_verdict(NGPTOT, {e.name: e.relerr for e in errs}
                            )["over_jax_reading"]
        if over:
            raise RuntimeError(f"{tag}: MaxRelErr above both the flag bar "
                               f"and the JAX engine's reading: {over}")
        jax = JAX_FP64_RELERR[NGPTOT]
        print(f"{tag}: every field's MaxRelErr within max(10*eps, JAX "
              f"engine's reading); flagged "
              + ", ".join(f"{n} {v:.3e} (JAX {jax.get(n, 0.0):.3e})"
                          for n, v in flagged.items()))
    return flagged


def phase_main_path(inp, params, dtype, ref_dev):
    """The main path's driver calls, outputs left on the card and validated
    there; in fp64 also fetched once and validated on the host, whose norms
    must equal the card's. Returns (K1's launches, the flux rows' kernel's
    launches, timings, wall s of driver.run, card validation s, host
    validation s or None)."""
    import numpy as np
    import torch

    from cloudsc_tpu_torch import data
    from cloudsc_tpu_torch.physics.cloudsc import CloudscOutputs
    from cloudsc_tpu_torch.runtime import tracing
    from cloudsc_tpu_torch.runtime.driver import CloudscDriver
    from cloudsc_tpu_torch.validate import validate_outputs

    tag = "fp64" if dtype == torch.float64 else "fp32"
    driver = CloudscDriver(params, inp.ptsphy, dtype=dtype, device="cuda")
    ngpblks = -(-NGPTOT // NPROMA)
    print(f"     NUMPROC=1, NUMOMP=1, NGPTOTG={NGPTOT}, NPROMA={NPROMA}, "
          f"NGPBLKS={ngpblks}")
    tracing.reset()
    t0 = time.perf_counter()
    out, timings, timer = driver.run(inp, iterations=ITERATIONS,
                                     fetch_outputs=False)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = tracing.counter("ops.k1")
    if launches != 1 + ITERATIONS:
        raise RuntimeError(f"{tag} main path: {launches} kernel launches, "
                           f"expected {1 + ITERATIONS}")
    foldo_launches = tracing.counter("launches.foldo")
    if foldo_launches != 1:
        raise RuntimeError(f"{tag} main path: the flux rows' kernel launched "
                           f"{foldo_launches} times, expected once")
    timer.print_performance(NPROMA, ngpblks, NGPTOT, numomp=1,
                            iterations=ITERATIONS)
    print(f" device compute: {timings.compute_s * 1e3:9.3f} ms | h2d:"
          f" {timings.h2d_s * 1e3:9.3f} ms | d2h: {timings.d2h_s * 1e3:9.3f}"
          f" ms | compile: {timings.compile_s:7.3f} s")
    errs, validate_s = _card_validation(f"main path {tag}", out, ref_dev)
    host_validate_s = None
    if tag == "fp64":
        t0 = time.perf_counter()
        host_out = CloudscOutputs(*(a.cpu().numpy() for a in out))
        fetch_s = time.perf_counter() - t0
        ref = data.load_reference(data.default_reference_path(), NGPTOT)
        t0 = time.perf_counter()
        host_errs = validate_outputs(host_out, ref, ngptotg=NGPTOT,
                                     print_table=False)
        host_validate_s = time.perf_counter() - t0
        del host_out, ref
        card = np.array([[e.minval, e.maxval, e.maxerr, e.errsum, e.refsum]
                         for e in errs])
        host = np.array([[e.minval, e.maxval, e.maxerr, e.errsum, e.refsum]
                         for e in host_errs])
        worst = float(np.max(np.abs(card - host)
                             / np.maximum(np.abs(host), 1e-300)))
        if not np.allclose(card, host, rtol=NORMS_RTOL, atol=0.0):
            raise RuntimeError(f"fp64 main path: card norms differ from the "
                               f"host's by {worst:.3e} relative")
        print(f"phase main path fp64: the card's norms equal the host's "
              f"(validate_outputs on the fetched fields) within "
              f"{NORMS_RTOL:g} relative, worst {worst:.3e}; fetch "
              f"{fetch_s:.3f} s, host validation {host_validate_s:.3f} s")
    # the rest of driver.run: host pack, assemble + foldo, ungroup
    host_s = run_s - (timings.h2d_s + timings.compile_s
                      + timings.compute_s * ITERATIONS)
    print(f"main path {tag} wall: run {run_s:.3f} s = host pack + assemble + "
          f"ungroup {host_s:.3f} s + h2d {timings.h2d_s:.3f} s + warm-up "
          f"{timings.compile_s:.3f} s + {ITERATIONS} x kernel "
          f"{timings.compute_s:.5f} s (no d2h: outputs stay on the card); "
          f"validation on the card {validate_s:.3f} s")
    flagged = _check_bars(f"phase main path {tag}", errs)
    print(f"phase main path {tag}: 21 fields within "
          f"{'FP64_TOL' if tag == 'fp64' else 'FP32_TOL'}, validated on the "
          f"card, {launches} launches, flagged {sorted(flagged)}")
    return launches, foldo_launches, timings, run_s, validate_s, \
        host_validate_s


def phase_scan(inp, params, ref_dev):
    """The eager scan engine in fp64 at NGPTOT columns, validated on the
    card under the fp64 bars; then one step of the pre-packed closure
    (CLOUDSC_SCAN_PACKED=1, `scan_pack` once after the copy), every field
    equal to the plain dict's bit for bit; no kernel count may move.
    Returns (timings, wall s of driver.run, the packed closure's
    timings)."""
    import torch

    from cloudsc_tpu_torch.runtime import tracing
    from cloudsc_tpu_torch.runtime.driver import CloudscDriver

    driver = CloudscDriver(params, inp.ptsphy, dtype=torch.float64,
                           device="cuda", backend="scan", nproma=NPROMA)

    def counts():
        return (tracing.counter("ops.k1"),
                tracing.counter("launches.k1.floor"),
                tracing.counter("launches.k1.init"),
                tracing.keyed("launches.k1.version"))

    before = counts()
    t0 = time.perf_counter()
    out, timings, _ = driver.run(inp, iterations=1, fetch_outputs=False)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if counts() != before:
        raise RuntimeError(f"the scan engine moved a kernel count: {before} "
                           f"-> {counts()}")
    errs, validate_s = _card_validation("scan fp64", out, ref_dev)
    flagged = _check_bars("phase scan fp64", errs)
    print(f"phase scan fp64: 21 fields within FP64_TOL, validated on the "
          f"card in {validate_s:.3f} s, no kernel launched, flagged "
          f"{sorted(flagged)}; step {timings.compute_s * 1e3:.1f} ms, "
          f"warm-up step {timings.compile_s:.3f} s, h2d {timings.h2d_s:.3f} "
          f"s, driver.run {run_s:.3f} s")
    with _env({"CLOUDSC_SCAN_PACKED": "1"}):
        packed = CloudscDriver(params, inp.ptsphy, dtype=torch.float64,
                               device="cuda", backend="scan", nproma=NPROMA)
    if packed.config_name("cuda") != "scan/cyclic+packed":
        raise RuntimeError(f"scan_pack: runs {packed.config_name('cuda')}")
    got, t_packed, _ = packed.run(inp, iterations=1, fetch_outputs=False)
    if counts() != before:
        raise RuntimeError("the pre-packed scan moved a kernel count")
    for f, a, b in zip(out._fields, got, out):
        if not torch.equal(a, b):
            raise RuntimeError(f"scan_pack {f}: differs from the plain "
                               f"dict's step")
    del out, got
    print(f"phase scan fp64 scan_pack: all 21 fields equal the plain dict's "
          f"bit for bit; step {t_packed.compute_s * 1e3:.1f} ms against "
          f"{timings.compute_s * 1e3:.1f} ms")
    return timings, run_s, t_packed


def _kernel_counts():
    from cloudsc_tpu_torch.runtime import tracing

    return (tracing.counter("ops.k1"), tracing.counter("launches.k1.floor"),
            tracing.counter("launches.k1.init"),
            tracing.keyed("launches.k1.version"),
            tracing.counter("launches.overlap"),
            tracing.counter("launches.copy"))


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def phase_adjoint(inp, params, fields):
    """The `pt` gradient of the scalar head at NGPTOT columns through
    `autodiff` (its default blocks), against a 100-column run on the card.
    Returns (the gradient, seconds, blocks, peak bytes)."""
    import dataclasses

    import torch

    from cloudsc_tpu_torch.bench.grad_blocks import scalar_head
    from cloudsc_tpu_torch.physics import autodiff
    from cloudsc_tpu_torch.physics.cloudsc import fields_on_device

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = autodiff.grad(scalar_head, fields, params, inp.ptsphy, ("pt",),
                      device="cuda")["pt"]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    blocks = -(-NGPTOT // autodiff.DEFAULT_BLOCK_COLUMNS)
    if g.shape != fields["pt"].shape or not bool(torch.isfinite(g).all()):
        raise RuntimeError("adjoint: wrong shape or NaN/inf")
    gmax = float(g.abs().max())
    if not gmax > 0.0:
        raise RuntimeError("adjoint: identically zero")
    klon = inp.klon_file
    small = fields_on_device(dataclasses.replace(inp, ngptot=klon),
                             torch.float64, "cuda")
    g100 = autodiff.grad(scalar_head, small, params, inp.ptsphy, ("pt",),
                         device="cuda")["pt"]
    want = g100[:, torch.arange(NGPTOT, device="cuda") % klon]
    worst = float((g - want).abs().max())
    if not worst <= GRAD_COPY_RTOL * gmax:
        raise RuntimeError(f"adjoint: a column's gradient differs from its "
                           f"source column's by {worst:.3e} (max |g| "
                           f"{gmax:.3e})")
    print(f"phase adjoint fp64: d(scalar head)/d(pt) at {NGPTOT} columns in "
          f"{blocks} blocks of {autodiff.DEFAULT_BLOCK_COLUMNS}: {seconds:.3f} "
          f"s, peak {peak / 2**30:.2f} GiB; finite, max |g| {gmax:.3e}, "
          f"{int((g != 0).sum())} nonzeros; every column against its source "
          f"column in a {klon}-column run: max abs diff {worst:.3e} (bar "
          f"{GRAD_COPY_RTOL:g} * max |g|; bit for bit: "
          f"{bool(torch.equal(g, want))})")
    return g, seconds, blocks, peak


def phase_tangent(inp, params, fields, g):
    """On the adjoint's first block: jvp against a central finite
    difference and against <grad, v>. Returns (jvp seconds, forward
    seconds)."""
    import torch

    from cloudsc_tpu_torch.bench.grad_blocks import scalar_head
    from cloudsc_tpu_torch.physics import autodiff

    n = min(autodiff.DEFAULT_BLOCK_COLUMNS, NGPTOT)
    block = {k: v[..., :n].contiguous() for k, v in fields.items()}
    v = torch.randn(block["pt"].shape, dtype=torch.float64, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0)) * 0.01
    kw = dict(device="cuda", block_columns=n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, jv = autodiff.jvp(scalar_head, block, params, inp.ptsphy, {"pt": v},
                         **kw)
    torch.cuda.synchronize()
    jvp_s = time.perf_counter() - t0

    def f(pt):
        return autodiff.value(scalar_head, {**block, "pt": pt}, params,
                              inp.ptsphy, **kw)

    t0 = time.perf_counter()
    up = f(block["pt"] + JVP_FD_EPS * v)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    fd = (up - f(block["pt"] - JVP_FD_EPS * v)) / (2 * JVP_FD_EPS)
    vg = (g[:, :n] * v).sum()
    r_fd, r_vg = _rel(fd, jv), _rel(vg, jv)
    if not r_fd < JVP_FD_RTOL:
        raise RuntimeError(f"tangent: jvp {float(jv):.9e} vs finite "
                           f"difference {float(fd):.9e}, relative {r_fd:.3e}")
    if not r_vg < ADJOINT_TANGENT_RTOL:
        raise RuntimeError(f"tangent: <grad, v> {float(vg):.15e} vs jvp "
                           f"{float(jv):.15e}, relative {r_vg:.3e}")
    print(f"phase tangent fp64 ({n} columns): jvp {float(jv):.9e} in "
          f"{jvp_s:.3f} s (a forward value {fwd_s:.3f} s); against the "
          f"central finite difference relative {r_fd:.3e} (< {JVP_FD_RTOL:g})"
          f"; <grad, v> against jvp relative {r_vg:.3e} (< "
          f"{ADJOINT_TANGENT_RTOL:g})")
    return jvp_s, fwd_s


def phase_parameter(inp, params, fields):
    """d/d rcldiff and d/d rkooptau of sum(tendency_loc_t^2) * 1e6 at NGPTOT
    columns against central finite differences. Returns the seconds of the
    gradient."""
    import torch

    from cloudsc_tpu_torch.physics import autodiff

    def head(out, cols):
        return (out.tendency_loc_t ** 2).sum() * 1e6

    names = ("rcldiff", "rkooptau")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads = autodiff.grad(head, fields, params, inp.ptsphy, names,
                          device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for name in names:
        theta0 = getattr(params.ydecldp, name)
        eps = theta0 * 1e-6

        def loss(theta):
            # no graph is kept: the whole width in one piece
            return float(autodiff.value(
                head, fields, autodiff.with_params(params, {name: theta}),
                inp.ptsphy, device="cuda", block_columns=NGPTOT))

        fd = (loss(theta0 + eps) - loss(theta0 - eps)) / (2 * eps)
        g = float(grads[name])
        if not (g == g and abs(g) != float("inf") and g != 0.0):
            raise RuntimeError(f"parameter: degenerate d/d{name}: {g}")
        r = _rel(g, fd)
        if not r < PARAM_FD_RTOL:
            raise RuntimeError(f"parameter: d/d{name} {g:.9e} vs finite "
                               f"difference {fd:.9e}, relative {r:.3e}")
        print(f"phase parameter fp64: d/d{name} {g:.9e} against the central "
              f"finite difference {fd:.9e}: relative {r:.3e} (< "
              f"{PARAM_FD_RTOL:g})")
    print(f"phase parameter fp64: both gradients at {NGPTOT} columns in one "
          f"blocked pass, {seconds:.3f} s")
    return seconds


def phase_timestep_loop(inp, params, fields):
    """LOOP_STEPS steps of the timestep loop at NGPTOT columns, the state on
    the card throughout; tests/test_timestep_loop.py's checks. Returns the
    seconds a step."""
    import torch

    from cloudsc_tpu_torch.examples import timestep_loop as tl
    from cloudsc_tpu_torch.physics.cloudsc import cloudsc

    step = tl.make_step(fields, params, inp.ptsphy)
    state0 = {k: fields[k] for k in tl.STATE_KEYS}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, diags = tl.integrate(step, state0, LOOP_STEPS)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / LOOP_STEPS
    for k in ("pt", "pq", "pa", "pclv"):
        if final[k].device.type != "cuda" \
                or not bool(torch.isfinite(final[k]).all()):
            raise RuntimeError(f"timestep loop: {k} left the card or is "
                               f"non-finite")
    pa_lo, pa_hi = float(final["pa"].min()), float(final["pa"].max())
    t_lo, t_hi = float(final["pt"].min()), float(final["pt"].max())
    sprecip = diags["sprecip"].cpu().numpy()
    q0 = float(tl.water_path(fields, params, state0))
    src = (float(diags["wpath"][-1]) - q0) + inp.ptsphy * float(sprecip.sum())
    with torch.no_grad():
        out = cloudsc(fields, params, inp.ptsphy)
        sp1 = float((out.pfplsl[-1] + out.pfplsn[-1]).mean())
    del out
    if not (pa_lo >= 0.0 and pa_hi <= 1.0 and 150.0 < t_lo and t_hi < 340.0
            and bool((sprecip >= 0.0).all()) and src > -1e-9
            and float(sprecip[0]) == sp1):
        raise RuntimeError(f"timestep loop: pa [{pa_lo}, {pa_hi}], T [{t_lo}, "
                           f"{t_hi}], surface precipitation {sprecip}, budget "
                           f"source {src}, step 1 {float(sprecip[0])} vs the "
                           f"single step {sp1}")
    print(f"phase timestep loop fp64: {LOOP_STEPS} steps at {NGPTOT} columns, "
          f"{step_s:.3f} s a step, state on the card; pa in [{pa_lo:.3f}, "
          f"{pa_hi:.3f}], T in [{t_lo:.2f}, {t_hi:.2f}] K, surface "
          f"precipitation {', '.join(f'{86400 * x:.4f}' for x in sprecip)} "
          f"mm/day, budget source {src:+.3e} kg/m2, step 1 equal to the "
          f"plain single step")
    return step_s


def phase_refusal(params):
    """K1 on the card with a pack that requires grad raises."""
    import torch

    from cloudsc_tpu_torch import data
    from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
    from cloudsc_tpu_torch.runtime.driver import CloudscDriver

    inp = data.load_input(data.default_input_path(), RAGGED_NCOL)
    driver = CloudscDriver(params, inp.ptsphy, dtype=torch.float64,
                           device="cuda", backend="cuda")
    p = driver.prepare(inp).to("cuda")
    p.pack.requires_grad_(True)
    before = _kernel_counts()
    try:
        cc.cloudsc_fused(p, driver.step.c, driver.step.consts)
    except RuntimeError as e:
        if "--kernel scan" not in str(e):
            raise
        print(f"phase refusal: K1 with an input that requires grad raised: "
              f"{e}")
    else:
        raise RuntimeError("K1 took an input that requires grad")
    if _kernel_counts() != before:
        raise RuntimeError("the refused call launched a kernel")


def phase_pmon(inp, params):
    """The main path with EC_PMON=1: the energy line from NVML, positive
    joules. Returns {tag: (joules a step, watts at the end, ms a step)}."""
    import re

    import torch

    from cloudsc_tpu_torch.runtime.driver import CloudscDriver

    results = {}
    had = os.environ.get("EC_PMON")
    os.environ["EC_PMON"] = "1"
    try:
        for dtype in (torch.float64, torch.float32):
            tag = "fp64" if dtype == torch.float64 else "fp32"
            driver = CloudscDriver(params, inp.ptsphy, dtype=dtype,
                                   device="cuda")
            _, timings, _ = driver.run(inp, iterations=PMON_ITERATIONS,
                                       fetch_outputs=False)
            line = timings.energy_line
            m = re.fullmatch(r" EC_PMON: energy delta (\S+) J, power (\S+) W",
                             line or "")
            if not m or not float(m.group(1)) > 0.0:
                raise RuntimeError(f"pmon {tag}: energy line {line!r}")
            print(f"main path {tag}, {PMON_ITERATIONS} steps:{line}")
            results[tag] = (float(m.group(1)) / PMON_ITERATIONS,
                            float(m.group(2)), timings.compute_s * 1e3)
    finally:
        if had is None:
            del os.environ["EC_PMON"]
        else:
            os.environ["EC_PMON"] = had
    return results


# ---- ranks, meshes, level counts and the CLI's flags -----------------------

RANK_TIMEOUT = 300  # seconds a two-rank launch may take
RANK_LINE = "chip_smoke rank "


def cli_rank(argv) -> int:
    """One rank of a `torchrun` launch: `cloudsc_tpu_torch.cli.main(argv)`,
    as `python -m cloudsc_tpu_torch` runs it, then this rank's K1 launch
    count on stderr (`RANK_LINE` + JSON)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cloudsc_tpu_torch import cli
    from cloudsc_tpu_torch.runtime import tracing

    tracing.reset()
    rc = cli.main(argv)
    # one write, so the ranks' lines on the shared stderr do not interleave
    line = RANK_LINE + json.dumps({"rank": int(os.environ.get("RANK", "0")),
                                   "launches": tracing.counter("ops.k1")})
    os.write(sys.stderr.fileno(), f"\n{line}\n".encode())
    return rc


def _launch_ranks(args):
    """`torchrun --standalone --nproc-per-node 2 chip_smoke.py --cli-rank
    ARGS` on this host's cards; returns (stdout, {rank: K1 launches})."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", os.path.abspath(__file__), "--cli-rank",
           *args]
    r = subprocess.run(cmd, capture_output=True, text=True,
                       timeout=RANK_TIMEOUT,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    if r.returncode != 0:
        raise RuntimeError(f"two ranks of {args}: rc {r.returncode}\n"
                           f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    launches = {}
    for rec in re.findall(re.escape(RANK_LINE) + r"(\{[^}]*\})", r.stderr):
        rec = json.loads(rec)
        launches[rec["rank"]] = rec["launches"]
    return r.stdout, launches


def _table_lines(text) -> dict:
    """{field: printed validation row} of a CLI's stdout."""
    return {m.group(1): line for line in text.splitlines()
            if (m := re.match(r" (\S+)\s+[123]D[123] ", line))}


def phase_ranks(params):
    """Two ranks of the CLI sharing the card (gloo; each rank takes
    LOCAL_RANK % device_count()): at NGPTOT columns in fp64, each rank's 81,920
    columns tile the whole snapshot, so the printed table must equal, digit
    for digit, the table of an in-process one-rank 81,920-column run's
    card norms with errsum and refsum doubled (a sum of two equal fp64
    numbers is exact); every field within FP64_TOL and the fp64 bar. At
    100 columns (true slicing) each rank's written outputs equal the
    matching slice of a one-rank 100-column run bit for bit. Returns
    {case: (seconds, {rank: K1 launches})}."""
    import tempfile

    import numpy as np
    import torch

    from cloudsc_tpu_torch import data
    from cloudsc_tpu_torch.runtime.driver import CloudscDriver
    from cloudsc_tpu_torch.validate import REF_DATASET, FIELD_ATTR, \
        device_field_norms, error_line, reference_on_device, \
        validate_from_norms

    results = {}
    half = NGPTOT // 2
    t0 = time.perf_counter()
    out, launches = _launch_ranks([
        "1", str(NGPTOT), str(NPROMA), "--precision", "fp64", "--kernel",
        "cuda"])
    seconds = time.perf_counter() - t0
    if out.count("NUMPROC=2,") != 1 or "@ rank#1" not in out:
        raise RuntimeError(f"ranks: config line or rank#1 row missing:\n"
                           f"{out[-3000:]}")
    if out.count(" Variable ") != 1:
        raise RuntimeError("ranks: not exactly one validation table")
    if launches != {0: 2, 1: 2}:
        raise RuntimeError(f"ranks: K1 launches {launches}, expected 2 a "
                           f"rank (warm-up and one step)")
    printed = _table_lines(out)
    inp = data.load_input(data.default_input_path(), half)
    driver = CloudscDriver(params, inp.ptsphy, dtype=torch.float64,
                           device="cuda", backend="cuda")
    one, _, _ = driver.run(inp, fetch_outputs=False)
    norms = device_field_norms(one, reference_on_device(
        data.default_reference_path(), half, "cuda")).cpu().numpy()
    del one
    norms[:, 3:] *= 2.0
    errs = validate_from_norms(norms, NGPTOT, print_table=False)
    for e in errs:
        if printed.get(e.name) != error_line(e):
            raise RuntimeError(f"ranks {e.name}: printed\n"
                               f"{printed.get(e.name)!r}, the doubled "
                               f"one-rank norms give\n{error_line(e)!r}")
    flagged = _check_bars("phase ranks fp64", errs)
    print(f"phase ranks fp64: 2 ranks on {torch.cuda.device_count()} "
          f"card(s) at {NGPTOT} columns in {seconds:.1f} s, K1 launches "
          f"{launches}; the table equals the doubled one-rank {half}-column "
          f"norms on all 21 rows, flagged {sorted(flagged)}")
    print("\n".join(line for line in out.splitlines()
                    if "@ rank#" in line or "TOTAL" in line))
    results["fp64"] = (seconds, launches)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _, launches = _launch_ranks([
            "1", "100", "16", "--precision", "fp64", "--kernel", "cuda",
            "--write-reference", os.path.join(tmp, "ref.npz")])
        seconds = time.perf_counter() - t0
        inp = data.load_input(data.default_input_path(), 100)
        single, _, _ = CloudscDriver(params, inp.ptsphy, torch.float64,
                                     "cuda", backend="cuda").run(inp)
        for r in range(2):
            fields, _ = data._read(os.path.join(tmp, f"ref.rank{r}.npz"))
            for name, attr in FIELD_ATTR.items():
                got = fields[REF_DATASET[name]]
                want = getattr(single, attr)[..., 50 * r:50 * (r + 1)]
                if not np.array_equal(got, want):
                    raise RuntimeError(f"ranks at 100 columns: rank {r} "
                                       f"{name} differs from the one-rank "
                                       f"slice")
    print(f"phase ranks 100 columns: each rank's written outputs equal the "
          f"one-rank run's slice bit for bit (true slicing), {seconds:.1f} s, "
          f"K1 launches {launches}")
    results["100"] = (seconds, launches)
    return results


def phase_mesh(inp, params):
    """The driver's mesh of two shares at NGPTOT columns (the first two
    cards where there are two, else one card twice), fp32 and fp64: its
    outputs equal the one-device main path's bit for bit, two timer rows,
    K1 launched twice a step. Returns {tag: (launches, seconds, the
    timer's per-device ms a step)}."""
    import torch

    from cloudsc_tpu_torch.runtime import tracing
    from cloudsc_tpu_torch.runtime.driver import CloudscDriver

    ndev = torch.cuda.device_count()
    devices = ["cuda:0", "cuda:1"] if ndev > 1 else ["cuda:0", "cuda:0"]
    results = {}
    for dtype in (torch.float32, torch.float64):
        tag = "fp64" if dtype == torch.float64 else "fp32"
        t0 = time.perf_counter()
        one, _, _ = CloudscDriver(params, inp.ptsphy, dtype=dtype,
                                  device="cuda").run(inp, fetch_outputs=False)
        mesh = CloudscDriver(params, inp.ptsphy, dtype=dtype,
                             devices=devices)
        tracing.reset()
        shards, timings, timer = mesh.run(inp, iterations=ITERATIONS,
                                          fetch_outputs=False)
        torch.cuda.synchronize()
        launches = tracing.counter("ops.k1")
        if launches != 2 * (1 + ITERATIONS):
            raise RuntimeError(f"mesh {tag}: {launches} K1 launches, "
                               f"expected {2 * (1 + ITERATIONS)}")
        if len(timer.device_cols) != 2 or \
                sum(timer.device_cols) != NGPTOT * ITERATIONS:
            raise RuntimeError(f"mesh {tag}: timer rows {timer.device_cols}")
        for name in one._fields:
            got = torch.cat([getattr(s, name).to("cuda:0") for s in shards],
                            -1)
            if not torch.equal(got, getattr(one, name)):
                raise RuntimeError(f"mesh {tag} {name}: not bit for bit "
                                   f"with the one-device main path")
        seconds = time.perf_counter() - t0
        ms = [t / ITERATIONS * 1e3 for t in timer.device_time]
        print(f"phase mesh {tag}: 2 shares on {devices} at {NGPTOT} columns "
              f"bit for bit with the one-device main path on all 21 fields, "
              f"K1 launches {launches}, timer rows {timer.device_cols}, "
              f"{seconds:.1f} s")
        timer.print_performance(NPROMA, -(-NGPTOT // NPROMA), NGPTOT,
                                numomp=1, iterations=ITERATIONS)
        results[tag] = (launches, seconds, ms)
        del one, shards
        torch.cuda.empty_cache()
    return results


def phase_levels(params):
    """K1 against its plain version at 61, 68 and 91 levels (the top of
    the atmosphere kept, tests/test_level_generality.py's truncation) at
    RAGGED_NCOL columns, fp32 and fp64: every output buffer bit for bit.
    Returns the seconds."""
    import dataclasses

    import numpy as np
    import torch

    from cloudsc_tpu_torch import data
    from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
    from cloudsc_tpu_torch.physics import scheme

    t0 = time.perf_counter()
    base = data.load_input(data.default_input_path(), RAGGED_NCOL)
    for nlev in (61, 68, 91):
        fields = {}
        for name, a in base.fields.items():
            if a.ndim >= 2 and a.shape[-2] in (base.klev, base.klev + 1):
                cut = nlev + a.shape[-2] - base.klev
                fields[name] = np.ascontiguousarray(a[..., :cut, :])
            else:
                fields[name] = a
        inp = dataclasses.replace(base, fields=fields, klev=nlev)
        for dtype in (torch.float32, torch.float64):
            c = scheme.derived_consts(params, inp.ptsphy, dtype)
            p = cc.pack_inputs_folded(inp, params, dtype=dtype).to("cuda")
            got = cc.cloudsc_fused(p, c)
            want = cc.cloudsc_fused_plain(p, c)
            for name, a, b in zip(("o_lev", "o_half", "o_prainfrac"), got,
                                  want):
                if a.shape != b.shape or not bool(torch.isfinite(a).all()) \
                        or not torch.equal(a, b):
                    raise RuntimeError(f"levels {nlev} {dtype} {name}: "
                                       f"kernel != plain version")
    seconds = time.perf_counter() - t0
    print(f"phase levels: K1 == plain version bit for bit at 61, 68 and 91 "
          f"levels, {RAGGED_NCOL} columns, fp32 and fp64, {seconds:.1f} s")
    return seconds


def _cli(argv):
    """`cloudsc_tpu_torch.cli.main(argv)` in this process; its stdout."""
    import contextlib
    import io

    from cloudsc_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"cli {argv}: rc {rc}")
    return buf.getvalue()


def phase_flags(inp, params):
    """The CLI's flags at NGPTOT columns in fp32, in this process:
    `--debug-nans` passes, then raises on an input poisoned with one NaN
    and on the main path's outputs poisoned with one NaN (naming the
    field); `--profile` writes a non-empty Chrome trace; `--sweep-nproma
    64,128` prints two config lines and two perf tables and one
    validation table. Returns the seconds."""
    import tempfile

    import torch

    from cloudsc_tpu_torch import data
    from cloudsc_tpu_torch.runtime.driver import CloudscDriver, check_finite

    t0 = time.perf_counter()
    base = ["1", str(NGPTOT), str(NPROMA)]
    out = _cli([*base, "--debug-nans", "--iterations", "2"])
    if len(_table_lines(out)) != 21:
        raise RuntimeError("--debug-nans: no validation table")
    driver = CloudscDriver(params, inp.ptsphy, dtype=torch.float32,
                           device="cuda")
    res, _, _ = driver.run(inp, fetch_outputs=False, debug_nans=True)
    res.pfplsl[100, NGPTOT // 3] = float("nan")
    try:
        check_finite(res, 1)
    except FloatingPointError as e:
        if "pfplsl" not in str(e):
            raise
    else:
        raise RuntimeError("check_finite missed a NaN in pfplsl")
    del res
    with tempfile.TemporaryDirectory() as tmp:
        fields, scalars = data._read(data.default_input_path())
        fields["PT"] = fields["PT"].copy()
        fields["PT"][100, 7] = float("nan")
        poisoned = os.path.join(tmp, "poisoned.npz")
        data.write_snapshot(poisoned, fields, scalars)
        try:
            _cli([*base, "--debug-nans", "--input", poisoned])
        except FloatingPointError as e:
            raised = str(e)
        else:
            raise RuntimeError("--debug-nans passed a poisoned input")
        _cli([*base, "--no-validate", "--profile", tmp])
        trace = os.path.join(tmp, f"trace_rank0_nproma{NPROMA}.json")
        text = open(trace).read()
        if not json.loads(text)["traceEvents"]:
            raise RuntimeError("--profile wrote an empty trace")
        kernel_events = text.count("fused_kernel")
    out = _cli([*base, "--sweep-nproma", "64,128"])
    lines = out.splitlines()
    if sum("NUMPROC=1" in x for x in lines) != 2 \
            or sum(x.rstrip().endswith(": TOTAL") for x in lines) != 2 \
            or out.count(" Variable ") != 1:
        raise RuntimeError(f"--sweep-nproma 64,128:\n{out[-3000:]}")
    seconds = time.perf_counter() - t0
    print(f"phase flags fp32 at {NGPTOT} columns: --debug-nans passed, then "
          f"raised on a poisoned input ({raised}) and on poisoned outputs; "
          f"--profile wrote {len(text)} B with {kernel_events} events named "
          f"fused_kernel; --sweep-nproma 64,128 printed two tables; "
          f"{seconds:.1f} s")
    return seconds


def phase_measurement_entries():
    """The bench entry in this process, fp32 and fp64, K1's counts reset
    just before and read just after each; then the sweep's grid at 16,384
    columns in fp64 and its weak scaling on one card, each a process of
    its own. Returns ({precision: (JSON line, launches)}, grid record,
    weak-scaling record, seconds)."""
    import contextlib
    import io
    import tempfile

    from cloudsc_tpu_torch.bench import bench, sweep
    from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
    from cloudsc_tpu_torch.runtime import tracing

    t0 = time.perf_counter()
    lines = {}
    saved = os.environ.get("CLOUDSC_BENCH_PRECISION")
    try:
        for tag in ("fp32", "fp64"):
            os.environ["CLOUDSC_BENCH_PRECISION"] = tag
            tracing.reset()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = bench.main()
            launches = tracing.counter("launches.k1.version",
                                       cc.KernelVersion())
            out = [x for x in buf.getvalue().splitlines()
                   if not x.startswith("#")]
            if rc != 0 or len(out) != 1:
                raise RuntimeError(f"bench {tag}: rc {rc}, output "
                                   f"{buf.getvalue()!r}")
            rec = json.loads(out[0])
            if "skipped" in rec or not rec["value"] > 0 \
                    or not rec["config"].startswith("cuda/grouped+fold") \
                    or launches != 1 + bench.CARD_ITERS \
                    or tracing.counter("ops.k1") != launches:
                raise RuntimeError(f"bench {tag}: {rec}, {launches} "
                                   f"reference-build launches of "
                                   f"{tracing.counter('ops.k1')}")
            print(f"phase 10 bench {tag}: {out[0]}; {launches} K1 launches")
            lines[tag] = (rec, launches)
    finally:
        if saved is None:
            os.environ.pop("CLOUDSC_BENCH_PRECISION", None)
        else:
            os.environ["CLOUDSC_BENCH_PRECISION"] = saved
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for name, argv in (
                ("grid", ["--ngptot", "16384", "--kernel", "cuda",
                          "--precision", "fp64", "--iterations", "1",
                          "--validate"]),
                ("weak", ["--weak-scaling", "1"])):
            path = os.path.join(tmp, f"{name}.json")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = sweep.main([*argv, "--out", path])
            recs = json.loads(open(path).read())
            rate = recs[0].get("cols_per_s" if name == "grid" else "value")
            if rc != 0 or len(recs) != 1 or not rate:
                raise RuntimeError(f"sweep {argv}: rc {rc}, {recs}\n"
                                   f"{buf.getvalue()[-3000:]}")
            runs[name] = recs[0]
    grid = runs["grid"]  # the sweep exits 1 on a field over its fp64 bar
    seconds = time.perf_counter() - t0
    print(f"phase 10 sweep: grid fp64 16384 {grid['cols_per_s']} columns/s "
          f"(K1 {grid['compute_ms']} ms, flagged {grid['flagged']}); weak "
          f"scaling 1 card {runs['weak']['value']} columns/s; {seconds:.1f} s")
    return lines, grid, runs["weak"], seconds


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--cli-rank"]:
        return cli_rank(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cloudsc_tpu_torch import data
    from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
    from cloudsc_tpu_torch.params import Params
    from cloudsc_tpu_torch.physics import scheme
    from cloudsc_tpu_torch.validate import reference_on_device

    t_start = time.perf_counter()
    inp = data.load_input(data.default_input_path(), NGPTOT)
    params = Params.from_input(inp)
    versions = scheme_versions(inp, params)
    forms = form_versions(params, inp.ptsphy)
    card, resources = phase0_environment(
        {**versions, **forms}, cc.kernel_version(scheme.derived_consts(
            params, inp.ptsphy, torch.float32), cc.ROWS_FORM))

    k = phase1_kernel_vs_plain(inp, params)
    diag, diag_bytes = phase1a_diagnostic_bodies(inp, params)
    phase1_ragged(params)
    vk = phase1d_versions(inp, params, versions)
    fk = phase_forms(params, forms)
    foldo = phase_foldo(inp, params)
    k2_err, k2_times, (k2_ms, k2_plain_ms, k2_bound) = phase1b_overlap_probe()
    k3 = phase1c_copy_probe()
    ref_dev = reference_on_device(data.default_reference_path(), NGPTOT,
                                  "cuda")
    launches, foldo32, t32, run32, val32, _ = phase_main_path(
        inp, params, torch.float32, ref_dev)
    _, foldo64, t64, run64, val64, host_val64 = phase_main_path(
        inp, params, torch.float64, ref_dev)
    torch.cuda.empty_cache()
    t_scan, run_scan, t_scan_packed = phase_scan(inp, params, ref_dev)
    fmain = phase_form_main_path(inp, params, ref_dev)
    del ref_dev
    torch.cuda.empty_cache()
    fentry = phase_fields_entry(inp, params)
    layouts = phase_layouts(inp, params)

    # the differentiable path and the loop: one plain fp64 field dict,
    # expanded on the card, for all four phases; no hand-written kernel
    from cloudsc_tpu_torch.physics.cloudsc import fields_on_device

    fields = fields_on_device(inp, torch.float64, "cuda")
    before = _kernel_counts()
    g, adj_s, adj_blocks, adj_peak = phase_adjoint(inp, params, fields)
    jvp_s, fwd_s = phase_tangent(inp, params, fields, g)
    del g
    par_s = phase_parameter(inp, params, fields)
    loop_s = phase_timestep_loop(inp, params, fields)
    if _kernel_counts() != before:
        raise RuntimeError(f"the differentiable path moved a kernel count: "
                           f"{before} -> {_kernel_counts()}")
    del fields
    torch.cuda.empty_cache()
    phase_refusal(params)
    pmon = phase_pmon(inp, params)
    lab_counts = phase5_lab_path()
    torch.cuda.empty_cache()
    print(f"torch.cuda.device_count() = {torch.cuda.device_count()}")
    ranks = phase_ranks(params)
    mesh = phase_mesh(inp, params)
    levels_s = phase_levels(params)
    flags_s = phase_flags(inp, params)
    bench_lines, sweep_grid, sweep_weak, entries_s = \
        phase_measurement_entries()

    nlev = inp.klev
    from cloudsc_tpu_torch.bench import timing
    from cloudsc_tpu_torch.bench.timing import PEAK_GBS

    k1_bound = {tag: timing.bound(k[tag][3],
                                  timing.K1_FLOP_PER_COLUMN * NGPTOT, tag)
                for tag in ("fp32", "fp64")}
    for tag, t, run_s, val_s in (("fp32", t32, run32, val32),
                                 ("fp64", t64, run64, val64)):
        max_abs, ms, plain_ms, nbytes = k[tag]
        gbs = nbytes / (ms * 1e-3) / 1e9
        busy_s = (1 + ITERATIONS) * t.compute_s
        bound_ms, bound_by = k1_bound[tag]
        print(f"timing {tag} [{card}]: kernel {ms:.4f} ms/step "
              f"({NGPTOT / (ms * 1e-3):.0f} columns/s, CUDA events over "
              f"{ITERATIONS} launches on the driver's pack); modeled "
              f"{nbytes / 1e9:.3f} GB a step, {gbs:.0f} GB/s = "
              f"{gbs / PEAK_GBS:.3f} of an assumed {PEAK_GBS:.0f} GB/s peak; "
              f"bound {bound_ms:.4f} ms (by {bound_by}) = "
              f"{bound_ms / ms:.3f} of the kernel's time; driver loop "
              f"{t.compute_s * 1e3:.4f} ms/step; plain version "
              f"{plain_ms:.1f} ms/step (1 call); h2d {t.h2d_s * 1e3:.1f} ms; "
              f"no d2h; warm-up {t.compile_s:.2f} s; "
              f"kernel busy {busy_s:.4f} s of driver.run {run_s:.3f} s "
              f"(host wall clock, no trace) = idle share "
              f"{1 - busy_s / run_s:.4f}; validation on the card "
              f"{val_s:.3f} s"
              + (f", on the host {host_val64:.3f} s" if tag == "fp64" else ""))
    print(f"timing scan fp64 [{card}]: {t_scan.compute_s * 1e3:.1f} ms/step "
          f"(CUDA events over 1 step after a warm-up step of "
          f"{t_scan.compile_s:.3f} s); h2d {t_scan.h2d_s:.3f} s; driver.run "
          f"{run_scan:.3f} s; pre-packed (scan_pack) "
          f"{t_scan_packed.compute_s * 1e3:.1f} ms/step")
    print(f"timing fields entry fp32 [{card}]: driver loop with "
          f"CLOUDSC_PACKED_STORAGE=0 "
          f"{fentry['driver_ms']:.4f} ms/step (K1 in place), with "
          f"CLOUDSC_FOLD_INPUTS=0 {fentry['unfolded_driver_ms']:.4f} ms/step")
    for tag in ("fp32", "fp64"):
        r = fentry[tag]
        regs, spill, blocks, zregs, zspill = resources["rows"][
            tag.replace("fp", "f")]
        print(f"timing K1 in place {tag} [{card}]: cloudsc_fused "
              f"{r['ms']:.4f} ms/step on the field dict (zdqs_kernel, then "
              f"K1's Rows policy streaming its row; CUDA events over "
              f"{ITERATIONS} calls at {NGPTOT} columns); bound "
              f"{r['bound'][0]:.4f} ms (by {r['bound'][1]}) = "
              f"{r['bound'][0] / r['ms']:.3f} of the two kernels' time; plain "
              f"version {r['plain_ms']:.1f} ms (1 call); K1 {regs} "
              f"registers, {spill} B spill stores, {blocks} blocks an SM")
    print(f"timing zdqs_kernel [{card}]: "
          + "; ".join(
              f"{tag} {r['zdqs_ms']:.4f} ms/step at {NGPTOT} x {nlev}, bound "
              f"{r['zdqs_bound'][0]:.4f} ms (by {r['zdqs_bound'][1]}) = "
              f"{r['zdqs_bound'][0] / r['zdqs_ms']:.3f} of its time, plain "
              f"version {r['zdqs_plain_ms']:.1f} ms (1 call), "
              f"{resources['rows'][tag.replace('fp', 'f')][3]} registers"
              for tag, r in ((t, fentry[t]) for t in ("fp32", "fp64")))
          + f" (CUDA events over {ITERATIONS} launches issued behind a "
            f"spin: the kernel's time, not the host's issue)")
    print(f"timing adjoint fp64 [{card}]: d(scalar head)/d(pt) at {NGPTOT} "
          f"columns {adj_s:.3f} s in {adj_blocks} blocks, peak "
          f"{adj_peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); "
          f"jvp of one block {jvp_s:.3f} s, its forward value {fwd_s:.3f} s; "
          f"two parameter gradients at {NGPTOT} columns {par_s:.3f} s; "
          f"timestep loop {loop_s:.3f} s a step (host clock, synchronised)")
    for tag, (joules, watts, ms) in pmon.items():
        print(f"timing energy {tag} [{card}]: {joules:.4f} J a K1 step "
              f"({ms:.4f} ms a step over {PMON_ITERATIONS} steps of the "
              f"driver loop, NVML total energy; {joules / (ms * 1e-3):.0f} W "
              f"mean, {watts:.0f} W at the end)")
    for name, rec in vk.items():
        for tag in ("fp32", "fp64"):
            r = rec[tag]
            regs, spill, blocks = resources[name][tag.replace("fp", "f")]
            print(f"timing K1 {name} {tag} [{card}]: {r['ms']:.4f} ms/step "
                  f"(CUDA events over {ITERATIONS} launches on the driver's "
                  f"pack; driver loop {r['driver_ms']:.4f} ms), the reference "
                  f"configuration's build on the same input {r['ref_ms']:.4f} "
                  f"ms ({r['ms'] / r['ref_ms'] - 1:+.1%}), plain version "
                  f"{r['plain_ms']:.1f} ms (1 call); bound "
                  f"{r['bound'][0]:.4f} ms (by {r['bound'][1]}, {r['rows']} "
                  f"rows) = {r['bound'][0] / r['ms']:.3f} of the kernel's "
                  f"time; {regs} registers, {spill} B spill stores, {blocks} "
                  f"blocks an SM")
    for name, rec in fk.items():
        for tag in ("fp32", "fp64"):
            r = rec[tag]
            regs, spill, blocks = resources[name][tag.replace("fp", "f")]
            print(f"timing K1 form {name} {tag} [{card}]: {r['ms']:.4f} "
                  f"ms/step at {RAGGED_NCOL} columns (CUDA events over "
                  f"{ITERATIONS} launches on the driver's pack), plain "
                  f"version {r['plain_ms']:.1f} ms (1 call); bound "
                  f"{r['bound'][0]:.4f} ms (by {r['bound'][1]}, {r['rows']} "
                  f"rows); {regs} registers, {spill} B spill stores, "
                  f"{blocks} blocks an SM")
    for name, r in fmain.items():
        print(f"timing K1 form {name} fp64 main path [{card}]: "
              f"{r['ms']:.4f} ms/step at {NGPTOT} columns, the reference "
              f"build on the same input {r['ref_ms']:.4f} ms "
              f"({r['ms'] / r['ref_ms'] - 1:+.1%}); driver loop "
              f"{r['driver_ms']:.4f} ms; bound {r['bound'][0]:.4f} ms (by "
              f"{r['bound'][1]}, {r['rows']} rows) = "
              f"{r['bound'][0] / r['ms']:.3f} of the kernel's time; plain "
              f"version {r['plain_ms']:.1f} ms (1 call); host pack "
              f"{r['pack_s']:.3f} s (prepare, host clock), h2d "
              f"{r['h2d_s']:.3f} s, driver.run {r['run_s']:.3f} s; flagged "
              f"{r['flagged']}")
    for tag, (ms, pack_ms, plain_ms, (bound_ms, bound_by), _, _) in \
            foldo.items():
        print(f"timing foldo {tag} [{card}]: the flux rows' kernel "
              f"{ms:.4f} ms on the field dict, {pack_ms:.4f} ms on the "
              f"driver's pack (CUDA events over {ITERATIONS} calls at "
              f"{NGPTOT} x {nlev}); bound {bound_ms:.4f} ms (by {bound_by}) "
              f"= {bound_ms / ms:.3f} of the kernel's time; plain loop "
              f"{plain_ms:.4f} ms (3 calls)")
    print(f"timing layouts fp32 [{card}]: driver loop "
          + ", ".join(f"{k} {v:.4f} ms/step" for k, v in layouts.items())
          + f" at {NGPTOT} columns")
    for tag in ("fp32", "fp64"):
        full, init, floor = (diag[(m, tag)][1] for m in ("full", "init",
                                                         "floor"))
        gbs = diag_bytes[tag] / (floor * 1e-3) / 1e9
        print(f"timing K1 bodies {tag} [{card}]: full {full:.4f} ms, init "
              f"{init:.4f} ms, floor {floor:.4f} ms a step (CUDA events over "
              f"{ITERATIONS} launches, driver's pack); floor moves the modeled "
              f"{diag_bytes[tag] / 1e9:.3f} GB at {gbs:.0f} GB/s = "
              f"{gbs / PEAK_GBS:.3f} of an assumed {PEAK_GBS:.0f} GB/s peak; "
              f"plain init {diag[('init', tag)][2]:.1f} ms, plain floor "
              f"{diag[('floor', tag)][2]:.1f} ms (1 call)")
    for variant in ("plain", "alias", "scratch", "prod", "branchy"):
        t = {(m, w): k2_times[(variant, m, w)]
             for m in ("full", "resident") for w in (0, 8)}
        print(f"timing overlap {variant} [{card}]: S (full, w=0) "
              f"{t[('full', 0)]:.4f} ms, C (resident, w=8) "
              f"{t[('resident', 8)]:.4f} ms, T (full, w=8) "
              f"{t[('full', 8)]:.4f} ms, resident w=0 "
              f"{t[('resident', 0)]:.4f} ms (CUDA events over {ITERATIONS} "
              f"launches at the lab's default size)")
    print(f"timing overlap plain version prod/full/w=8 [{card}]: "
          f"{k2_plain_ms:.1f} ms (1 call) against the kernel's {k2_ms:.4f} ms")
    for name, (ms, plain_ms, nbytes, _) in k3.items():
        print(f"timing copy {name} [{card}]: {ms:.4f} ms, "
              f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s; plain x * 1.0000001 "
              f"{plain_ms:.4f} ms, {nbytes / (plain_ms * 1e-3) / 1e9:.0f} GB/s "
              f"(CUDA events over {ITERATIONS} launches)")
    for tag, (launches_m, seconds, ms) in mesh.items():
        print(f"timing mesh {tag} [{card}]: per-device rows "
              + ", ".join(f"{t:.4f}" for t in ms)
              + f" ms a step over {ITERATIONS} steps ({launches_m} K1 "
              f"launches; two shares on "
              + ("two cards" if torch.cuda.device_count() > 1
                 else "one card: a correctness run, not a speed figure")
              + f"); phase {seconds:.1f} s")
    for case, (seconds, launches_r) in ranks.items():
        print(f"timing ranks {case} [{card}]: two ranks sharing "
              f"{'the card' if torch.cuda.device_count() == 1 else 'cards'} "
              f"{seconds:.1f} s from launch to exit, K1 launches "
              f"{launches_r} (their rows above are a correctness run, not a "
              f"speed figure)")
    print(f"timing levels [{card}]: {levels_s:.1f} s; flags {flags_s:.1f} s")
    for tag, (rec, launches_b) in bench_lines.items():
        print(f"timing bench {tag} [{card}]: {rec['value']} columns/s per "
              f"chip, vs_baseline {rec['vs_baseline']} (bench.bench: "
              f"{launches_b} K1 launches, CUDA events over 10 driver steps)")
    print(f"timing sweep [{card}]: fp64 16384 K1 {sweep_grid['compute_ms']} "
          f"ms a step, {sweep_grid['cols_per_s']} columns/s (TOTAL row, "
          f"host clock), peak {sweep_grid.get('peak_mib')} MiB, process "
          f"{sweep_grid['wall_s']:.1f} s; weak scaling 1 card "
          f"{sweep_weak['value']} columns/s; phase 10 {entries_s:.1f} s")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    # the table's times are fp32 (K1's three bodies, the probes)
    max_abs, ms, plain_ms, _ = k["fp32"]
    bound_ms, bound_by = k1_bound["fp32"]
    entries = [{
        "name": "cloudsc_fused", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }]
    diag_flops = {"floor": (nlev + 1) * NGPTOT,
                  "init": INIT_FLOP_PER_LEVEL * (nlev + 1) * NGPTOT}
    for mode in ("floor", "init"):
        max_abs, ms, plain_ms = diag[(mode, "fp32")]
        bound_ms, bound_by = timing.bound(diag_bytes["fp32"],
                                          diag_flops[mode], "fp32")
        entries.append({
            "name": f"cloudsc_{mode}", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
            "launches": lab_counts[f"cloudsc_{mode}"],
            "max_abs_err": max(max_abs, diag[(mode, "fp64")][0]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})
    entries.append({
        "name": "overlap_probe", "route": "cuda", "source": PROBES_SOURCE,
        "replaces": "bench/overlap_probe.py:171",
        "launches": lab_counts["overlap_probe"], "max_abs_err": k2_err,
        "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1], "library_ms": None})
    ms, plain_ms, nbytes, _ = k3["strided"]
    # x and col read once and written once; one multiply a value
    bound_ms, bound_by = timing.bound(nbytes + 2 * 4 * 1024,
                                      nbytes // 8 + 1024, "fp32")
    entries.append({
        "name": "dma_copy", "route": "cuda", "source": PROBES_SOURCE,
        "replaces": "bench/dma_probe.py:80",
        "launches": lab_counts["dma_copy"],
        "max_abs_err": max(r[3] for r in k3.values()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by,
        # the plain version is one PyTorch call, x * 1.0000001
        "library_ms": plain_ms})
    # K1's scheme-version builds: fp32 in the common keys, fp64 beside
    for name, rec in vk.items():
        r32, r64 = rec["fp32"], rec["fp64"]
        entries.append({
            "name": f"cloudsc_fused[{name}]", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
            "launches": r32["launches"],
            "max_abs_err": max(r32["max_abs"], r64["max_abs"]),
            "ms": r32["ms"], "plain_ms": r32["plain_ms"],
            "bound_ms": r32["bound"][0], "bound_by": r32["bound"][1],
            "library_ms": None,
            "fp64": {"launches": r64["launches"], "ms": r64["ms"],
                     "plain_ms": r64["plain_ms"], "bound_ms": r64["bound"][0],
                     "bound_by": r64["bound"][1]}})
    # K1's form builds, at RAGGED_NCOL: fp32 in the common keys, fp64
    # beside, and the full-width fp64 main path of the two forms it runs
    for name, rec in fk.items():
        r32, r64 = rec["fp32"], rec["fp64"]
        entry = {
            "name": f"cloudsc_fused[{name}]", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
            "launches": r32["launches"],
            "max_abs_err": max(r32["max_abs"], r64["max_abs"]),
            "ms": r32["ms"], "plain_ms": r32["plain_ms"],
            "bound_ms": r32["bound"][0], "bound_by": r32["bound"][1],
            "library_ms": None, "ncol": RAGGED_NCOL,
            "fp64": {"launches": r64["launches"], "ms": r64["ms"],
                     "plain_ms": r64["plain_ms"], "bound_ms": r64["bound"][0],
                     "bound_by": r64["bound"][1]}}
        if name in fmain:
            r = fmain[name]
            entry["main_path_fp64"] = {
                "ncol": NGPTOT, "launches": r["launches"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "max_abs_err": 0.0,
                "reference_build_ms": r["ref_ms"], "bound_ms": r["bound"][0],
                "bound_by": r["bound"][1]}
        if name == "unfolded":
            # the same build through the per-field entry
            entry["fields_fp32"] = {
                "ncol": NGPTOT, "launches": fentry["launches"],
                "driver_ms": fentry["driver_ms"]}
        entries.append(entry)
    # K1's Rows policy on the field dict: the per-field main path's launches
    # (each read in place), fp32 in the common keys, fp64 beside
    r32, r64 = fentry["fp32"], fentry["fp64"]
    entries.append({
        "name": "cloudsc_fused_rows", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": fentry["in_place"],
        "max_abs_err": max(r32["max_abs"], r64["max_abs"]),
        "ms": r32["ms"], "plain_ms": r32["plain_ms"],
        "bound_ms": r32["bound"][0], "bound_by": r32["bound"][1],
        "library_ms": None,
        "fp64": {"ms": r64["ms"], "plain_ms": r64["plain_ms"],
                 "bound_ms": r64["bound"][0], "bound_by": r64["bound"][1]}})
    # zdqs_kernel: the per-field main path's launches (one a dict step),
    # fp32 in the common keys, fp64 beside
    entries.append({
        "name": "zdqs_kernel", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": "none (the TPU kernel reads the row folded on the host "
                    "or runs the in-line CUADJTQ in its sweep)",
        "launches": fentry["zdqs_launches"],
        "max_abs_err": max(r32["zdqs_max_abs"], r64["zdqs_max_abs"]),
        "ms": r32["zdqs_ms"], "plain_ms": r32["zdqs_plain_ms"],
        "bound_ms": r32["zdqs_bound"][0], "bound_by": r32["zdqs_bound"][1],
        "library_ms": None,
        "fp64": {"ms": r64["zdqs_ms"], "plain_ms": r64["zdqs_plain_ms"],
                 "bound_ms": r64["zdqs_bound"][0],
                 "bound_by": r64["zdqs_bound"][1]}})
    ms, pack_ms, plain_ms, (bound_ms, bound_by), lab_f, err_f = foldo["fp32"]
    ms64, pack64, plain64, (bound64, by64), lab64, err64 = foldo["fp64"]
    entries.append({
        "name": "foldo_synthesize", "route": "cuda", "source": FOLDO_SOURCE,
        "replaces": FOLDO_REPLACES, "launches": foldo32,
        "lab_launches": lab_f, "max_abs_err": err_f, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "pack_ms": pack_ms,
        "fp64": {"launches": foldo64, "lab_launches": lab64,
                 "max_abs_err": err64, "ms": ms64, "pack_ms": pack64,
                 "plain_ms": plain64, "bound_ms": bound64,
                 "bound_by": by64}})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
