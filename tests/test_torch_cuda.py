"""The CUDA kernels on the card: each against its plain PyTorch version on
the same inputs, their launch counts (K1's three bodies, the overlap probe,
the copy probe), K1's occupancy, each scheme version's and each form's
build of K1, the column layouts after the ungroup, the validation
norms reduced on the card against the host's, the flux rows' kernel
(csrc/foldo.cu) against its plain loop, and zdqs_kernel against
`zdqs_plain` and a field dict's step against the in-line build, bit for
bit. Every test
needs a CUDA device and skips without one (marker `cuda`). The module imports no JAX, so that it
also runs on a GPU host without it, where the repo's conftest (which
imports JAX) is left out:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: the kernel is built with -fmad=false and follows the plain
version's operation order, so in fp64 every field is within test_golden's
FP64_TOL (errsum/refsum) and in fp32 within test_pallas's rtol 1e-5, and
`test_kernel_bitwise_equals_plain` holds it bit for bit (max abs err 0).
The floor body is one add (bitwise); the init body is section 1 under the
same bars as the full body. The probes are bitwise: the overlap kernel's
fmaf and the plain version's `fma32` round once, the copy is one fp32
multiply.
"""

import time

import numpy as np
import pytest
import torch

from cloudsc_tpu_torch import data as tdata
from cloudsc_tpu_torch.data import synthetic
from cloudsc_tpu_torch.kernels import build
from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
from cloudsc_tpu_torch.kernels import cuda_probes as cp
from cloudsc_tpu_torch.params import Params
from cloudsc_tpu_torch.physics import scheme as tscheme
from cloudsc_tpu_torch.runtime import tracing

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

FP64_TOL = 5.0e-14  # tests/test_golden.py, which imports JAX


def _k1_counts():
    """K1's launches by body: full, floor, init."""
    return (tracing.counter("ops.k1"), tracing.counter("launches.k1.floor"),
            tracing.counter("launches.k1.init"))


def relerr(got, want):
    """errsum/refsum, as tests/conftest.py's relerr."""
    errsum = np.abs(got - want).sum()
    refsum = np.abs(want).sum()
    return errsum / refsum if refsum > 0 else errsum

NCOL = 1000  # not a multiple of the 128-thread block: the ragged edge


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def snapshot():
    inp = tdata.load_input(tdata.default_input_path(), NCOL)
    return inp, Params.from_input(inp)


def _pair(snapshot, cuda, dtype):
    inp, params = snapshot
    c = tscheme.derived_consts(params, inp.ptsphy, dtype)
    p = cc.pack_inputs_folded(inp, params, dtype=dtype).to(cuda)
    got = cc.assemble(cc.cloudsc_fused(p, c), p, c)
    want = cc.assemble(cc.cloudsc_fused_plain(p, c), p, c)
    torch.cuda.synchronize()
    return got, want


def test_kernel_matches_plain_fp64(snapshot, cuda):
    got, want = _pair(snapshot, cuda, torch.float64)
    for name in want._fields:
        a = getattr(got, name).cpu().numpy()
        b = getattr(want, name).cpu().numpy()
        assert np.isfinite(a).all(), name
        assert relerr(a, b) < FP64_TOL, name


def test_kernel_matches_plain_fp32(snapshot, cuda):
    got, want = _pair(snapshot, cuda, torch.float32)
    for name in want._fields:
        a = getattr(got, name).double().cpu().numpy()
        b = getattr(want, name).double().cpu().numpy()
        assert np.isfinite(a).all(), name
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert err < 1e-5, f"{name}: maxrel={err:.3e}"


def test_launch_count(snapshot, cuda):
    inp, params = snapshot
    step = cc.FusedStep(params, inp.ptsphy, torch.float32).to(cuda)
    p = cc.pack_inputs_folded(inp, params, dtype=torch.float32).to(cuda)
    before = tracing.counter("ops.k1")
    for _ in range(3):
        step(p)
    cc.cloudsc_fused_plain(p, step.c)
    torch.cuda.synchronize()
    assert tracing.counter("ops.k1") == before + 3


@pytest.mark.parametrize("order", ["grouped", "cyclic"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ncol", [16387, 16384])
def test_kernel_bitwise_equals_plain(cuda, ncol, dtype, order):
    """The ring schedule changes where the rows come from, not the
    arithmetic: every output buffer equal bit for bit to the plain
    version's (max abs err 0), at a column count that is neither a multiple
    of the block nor of 4 (16,387: a ragged last block) and at one that
    fills whole blocks, in both column orders."""
    inp = tdata.load_input(tdata.default_input_path(), ncol)
    params = Params.from_input(inp)
    c = tscheme.derived_consts(params, inp.ptsphy, dtype)
    p = cc.pack_inputs_folded(inp, params, dtype=dtype,
                              column_order=order).to(cuda)
    before = tracing.counter("ops.k1")
    got = cc.cloudsc_fused(p, c)
    want = cc.cloudsc_fused_plain(p, c)
    torch.cuda.synchronize()
    assert tracing.counter("ops.k1") == before + 1
    for name, a, b in zip(("o_lev", "o_half", "o_prainfrac"), got, want):
        assert a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        assert float((a - b).abs().max()) == 0.0, name
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_bitwise_at_another_geometry(cuda, dtype):
    """The sweep's path (bench/ring_sweep.py): K1 built alone at a geometry
    other than RING's — S=3, 64-thread blocks — is still bit for bit the
    plain version at a ragged column count, and runs with that geometry."""
    from cloudsc_tpu_torch.kernels import build

    g = cc.RingGeometry(stages=3, block=64, min_blocks=2)
    lib = build.load_library(ring=g,
                             sources=[build.CSRC / "cloudsc_fused.cu"])
    occ = cc.occupancy(dtype, lib)
    assert (occ["stages"], occ["block"], occ["min_blocks"]) == (3, 64, 2)
    assert occ["blocks_per_sm"] >= 1
    inp = tdata.load_input(tdata.default_input_path(), 16387)
    params = Params.from_input(inp)
    c = tscheme.derived_consts(params, inp.ptsphy, dtype)
    p = cc.pack_inputs_folded(inp, params, dtype=dtype).to(cuda)
    got = cc.cloudsc_fused(p, c, lib=lib)
    want = cc.cloudsc_fused_plain(p, c)
    for name, a, b in zip(("o_lev", "o_half", "o_prainfrac"), got, want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_occupancy(cuda, dtype):
    """The built kernel runs with the geometry of cuda_cloudsc.RING and at
    least one block an SM."""
    occ = cc.occupancy(dtype)
    g = cc.RING
    assert occ["blocks_per_sm"] >= 1
    assert (occ["stages"], occ["block"], occ["min_blocks"]) == \
        (g.stages, g.block, g.min_blocks)
    assert occ["smem_bytes"] == g.smem_bytes(8 if dtype == torch.float64
                                             else 4)
    assert 0 < occ["registers"] <= 255


def test_cuda_pack_refuses_non_default_config(snapshot, cuda):
    """A configuration other than the reference's (IWARMRAIN=1) is no longer
    refused: the wrapper launches that version's own build, equal bit for
    bit to the plain version, and still refuses what no build takes."""
    inp, params = snapshot
    cfg = tscheme.SchemeConfig(iwarmrain=1)
    c = tscheme.derived_consts(params, inp.ptsphy, torch.float32, cfg)
    p = cc.pack_inputs_folded(inp, params, cfg, dtype=torch.float32).to(cuda)
    before = tracing.counter("ops.k1")
    got = cc.cloudsc_fused(p, c)
    want = cc.cloudsc_fused_plain(p, c)
    torch.cuda.synchronize()
    assert tracing.counter("ops.k1") == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # every section tag is a build of its own; a tag no build knows is not
    skip = tscheme.derived_consts(params, inp.ptsphy, torch.float32,
                                  tscheme.SchemeConfig(skip=("s99",)))
    with pytest.raises(ValueError, match="skip tags"):
        cc.cloudsc_fused(p, skip)
    assert tracing.counter("ops.k1") == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(synthetic.VERSION_CASES))
def test_version_build_bitwise_equals_plain(cuda, case, dtype):
    """Each scheme version's build (the four single alternates and the
    aerosol build, each on the input that takes its branch) equals its
    plain version bit for bit at a ragged 16,387 columns, launches once,
    and differs from the reference configuration's build on that input."""
    inp = tdata.load_input(tdata.default_input_path(), 16387)
    params0 = Params.from_input(inp)
    inp, params, cfg = synthetic.version_case(case, inp, params0)
    c = tscheme.derived_consts(params, inp.ptsphy, dtype, cfg)
    assert cc.kernel_version(c) != cc.DEFAULT_VERSION
    p = cc.pack_inputs_folded(inp, params, cfg, dtype=dtype).to(cuda)
    before = tracing.counter("ops.k1")
    got = cc.cloudsc_fused(p, c)
    want = cc.cloudsc_fused_plain(p, c)
    torch.cuda.synchronize()
    assert tracing.counter("ops.k1") == before + 1
    for name, a, b in zip(("o_lev", "o_half", "o_prainfrac"), got, want):
        assert bool(torch.isfinite(a).all()), name
        assert torch.equal(a, b), \
            f"{name}: max abs err {float((a - b).abs().max()):.3e}"
    # the reference configuration's build, no coupling, on the same input
    c0 = tscheme.derived_consts(params0, inp.ptsphy, dtype)
    p0 = cc.pack_inputs_folded(inp, params0, dtype=dtype).to(cuda)
    base = cc.cloudsc_fused(p0, c0)
    assert any(not torch.equal(a, b) for a, b in zip(got, base))
    occ = cc.occupancy(dtype, build.load_library(version=cc.kernel_version(c)))
    assert occ["blocks_per_sm"] >= 1
    assert occ["smem_bytes"] == cc.RING.smem_bytes(p.pack.element_size(),
                                                   len(p.rows))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_device_norms_equal_host_norms(snapshot, cuda, dtype):
    """The validation norms reduced on the card (against the reference
    expanded there) equal the host path's within 1e-12 relative, per field
    and statistic."""
    from cloudsc_tpu_torch import validate as tvalidate

    inp, params = snapshot
    c = tscheme.derived_consts(params, inp.ptsphy, dtype)
    p = cc.pack_inputs_folded(inp, params, dtype=dtype,
                              column_order="cyclic").to(cuda)
    out = cc.assemble(cc.cloudsc_fused(p, c), p, c)
    ref_dev = tvalidate.reference_on_device(tdata.default_reference_path(),
                                            NCOL, cuda)
    norms = tvalidate.device_field_norms(out, ref_dev).cpu().numpy()
    host = tvalidate.validate_outputs(
        type(out)(*(a.cpu().numpy() for a in out)),
        tdata.load_reference(tdata.default_reference_path(), NCOL),
        ngptotg=NCOL, print_table=False)
    want = np.array([[e.minval, e.maxval, e.maxerr, e.errsum, e.refsum]
                     for e in host])
    np.testing.assert_allclose(norms, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", ["floor", "init"])
def test_diagnostic_bodies_match_plain(snapshot, cuda, mode, dtype):
    inp, params = snapshot
    c = tscheme.derived_consts(params, inp.ptsphy, dtype)
    p = cc.pack_inputs_folded(inp, params, dtype=dtype,
                              column_order="cyclic").to(cuda)
    before = _k1_counts()
    got = cc.assemble(cc.cloudsc_fused(p, c, mode=mode), p, c)
    plain = cc.cloudsc_floor_plain(p) if mode == "floor" else \
        cc.cloudsc_init_plain(p, c)
    want = cc.assemble(plain, p, c)
    torch.cuda.synchronize()
    after = _k1_counts()
    assert after == (before[0], before[1] + (mode == "floor"),
                     before[2] + (mode == "init"))
    for name in want._fields:
        a = getattr(got, name).double().cpu().numpy()
        b = getattr(want, name).double().cpu().numpy()
        assert np.isfinite(a).all(), name
        if mode == "floor":
            np.testing.assert_array_equal(a, b, err_msg=name)
        elif dtype == torch.float64:
            assert relerr(a, b) < FP64_TOL, name
        else:
            err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
            assert err < 1e-5, f"{name}: maxrel={err:.3e}"


@pytest.mark.parametrize("sb", [1, 2])
@pytest.mark.parametrize("w", list(cp.OVERLAP_W))
@pytest.mark.parametrize("mode", ["full", "resident"])
@pytest.mark.parametrize("variant", list(cp.VARIANTS))
def test_overlap_kernel_matches_plain(cuda, variant, mode, w, sb):
    rng = np.random.default_rng(13)
    nk2, rr, ni = 5, 40, 3
    shape = (nk2, rr, ni * sb * 128)
    x = (rng.random(shape) * 10.0 ** (-12 * rng.random(shape))).astype(
        np.float32)
    x[:, 0, ::sb * 128] = 0.9
    x[::2, :, :sb * 128] *= np.float32(0.4)  # block 0 skips at even levels
    x = torch.from_numpy(x).to(cuda)
    col = torch.rand(cp.COL_SHAPE, generator=torch.Generator().manual_seed(1)
                     ).to(cuda)
    before = tracing.counter("launches.overlap")
    got = cp.overlap_step(x, col, variant, mode, w, sb)
    want = cp.overlap_plain(x, col, variant, mode, w, sb)
    torch.cuda.synchronize()
    assert tracing.counter("launches.overlap") == before + 1
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def _sync_within(seconds: float = 120.0) -> None:
    """Waits for the stream by polling an event, so that a kernel hung on a
    barrier fails the test instead of stopping the run."""
    done = torch.cuda.Event()
    done.record()
    t0 = time.monotonic()
    while not done.query():
        if time.monotonic() - t0 > seconds:
            pytest.fail(f"the kernel did not finish within {seconds} s")
        time.sleep(1e-3)


def _copy_probes():
    """The card tests' copy probes: contig, strided and tilemajor at small
    shapes (contig3: 5 stages, fewer than the grid's CTAs); strided at
    sb 1 (K1's 512-byte runs, gathered several a stage); runs of three
    stages and one 512-byte row (cut into four equal pieces); the lab's
    default strided probe (1.63 GB)."""
    chunk = cp.COPY_RING.chunk
    long_run = cp.contig_probe(chunk // 512 * 3 + 1, 4)
    assert 4 * long_run.run_len > chunk
    return [cp.contig_probe(32, 7), cp.contig_probe(3, 5),
            cp.strided_probe(4, 3, 5, 8, 2), cp.strided_probe(2, 2, 3, 4, 1),
            cp.tilemajor_probe(3, 4, 3, 5, 2),
            cp.strided_probe(4, 3, 6, 16, 1), long_run,
            cp.strided_probe(46, 3, 18, 1280, 32)]


@pytest.mark.parametrize("k", range(8))
def test_copy_kernel_matches_plain(cuda, k):
    """Bit for bit with x * 1.0000001, five times over (a missing proxy
    fence shows as an occasional stale slot), one launch counted a call."""
    probe = _copy_probes()[k]
    col = torch.rand(cp.COL_SHAPE).to(cuda)
    x = torch.rand(probe.shape, device=cuda)
    want = cp.dma_copy_plain(x, col)
    for _ in range(5):
        before = tracing.counter("launches.copy")
        got = cp.dma_copy(x, col, probe)
        _sync_within()
        assert tracing.counter("launches.copy") == before + 1
        assert torch.equal(got[0], want[0]), probe.name
        assert torch.equal(got[1], want[1]), probe.name


def test_copy_kernel_refuses_a_misaligned_view(cuda):
    """A view 4 bytes into its storage is not 16-byte aligned: bulk copies
    cannot take it, and the wrapper raises before any launch."""
    probe = cp.contig_probe(32, 7)
    n = int(np.prod(probe.shape))
    base = torch.rand(n + 4, device=cuda)
    col = torch.rand(cp.COL_SHAPE, device=cuda)
    x = base[1:n + 1].reshape(probe.shape)
    assert x.is_contiguous() and x.data_ptr() % 16
    before = tracing.counter("launches.copy")
    with pytest.raises(ValueError, match="16-byte aligned"):
        cp.dma_copy(x, col, probe)
    assert tracing.counter("launches.copy") == before
    aligned = base[4:n + 4].reshape(probe.shape)
    got, _ = cp.dma_copy(aligned, col, probe)
    _sync_within()
    assert tracing.counter("launches.copy") == before + 1
    assert torch.equal(got, aligned * 1.0000001)


def test_copy_geometry(cuda):
    """The built kernel runs `COPY_RING` on every SM of the card: its CTAs
    an SM fit, and its dynamic shared memory is S stages of CHUNK bytes."""
    g = cp.copy_geometry()
    r = cp.COPY_RING
    assert (g["stages"], g["chunk"], g["ctas"]) == (r.stages, r.chunk,
                                                    r.ctas)
    assert g["smem_bytes"] == r.smem_bytes
    assert g["blocks_per_sm"] >= r.ctas
    assert g["threads"] == cp.COPY_THREADS
    assert g["sms"] == torch.cuda.get_device_properties(0).multi_processor_count
    assert g["local_bytes"] == 0


def test_probe_kernels_refuse_bad_arguments(cuda):
    x = torch.zeros((2, 40, 256), device=cuda)
    col = torch.zeros(cp.COL_SHAPE, device=cuda)
    before = tracing.counter("launches.overlap")
    with pytest.raises(ValueError, match="built for"):
        cp.overlap_step(x, col, "plain", "full", 5, 1)
    assert tracing.counter("launches.overlap") == before
    with pytest.raises(ValueError, match="probe takes"):
        cp.dma_copy(x, col, cp.contig_probe(32, 7))


# ---- the differentiable path and the energy monitor on the card --------------

def test_kernel_refuses_a_gradient_on_the_card(snapshot, cuda):
    """K1 has no backward: a pack that requires grad raises before any
    launch, and names the scan engine."""
    from cloudsc_tpu_torch.runtime.driver import CloudscDriver

    inp, params = snapshot
    drv = CloudscDriver(params, inp.ptsphy, dtype=torch.float64,
                        device="cuda", backend="cuda")
    p = drv.prepare(inp).to(cuda)
    p.pack.requires_grad_(True)
    before = tracing.counter("ops.k1")
    with pytest.raises(RuntimeError, match="--kernel scan"):
        cc.cloudsc_fused(p, drv.step.c, drv.step.consts)
    assert tracing.counter("ops.k1") == before


def test_adjoint_of_expanded_columns_equals_source_columns(snapshot, cuda):
    """The card's elementwise arithmetic does not depend on a column's
    position: at 1000 columns in blocks of 400 (each holding every snapshot
    column) every column's gradient is its source column's, bit for bit."""
    from cloudsc_tpu_torch.bench.grad_blocks import scalar_head
    from cloudsc_tpu_torch.physics import autodiff
    from cloudsc_tpu_torch.physics.cloudsc import fields_on_device

    inp, params = snapshot
    wide = fields_on_device(inp, torch.float64, cuda)
    src = fields_on_device(tdata.load_input(tdata.default_input_path(), 100),
                           torch.float64, cuda)
    g = autodiff.grad(scalar_head, wide, params, inp.ptsphy, ("pt",),
                      device=cuda, block_columns=400)["pt"]
    g100 = autodiff.grad(scalar_head, src, params, inp.ptsphy, ("pt",),
                         device=cuda)["pt"]
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0.0
    assert torch.equal(g, g100[:, torch.arange(NCOL, device=cuda) % 100])


def test_energy_sampler_reads_nvml(cuda, monkeypatch):
    """With EC_PMON set the sampler reads the card's own counters: the
    energy counter does not run backwards and the card draws power."""
    from cloudsc_tpu_torch.runtime import pmon

    monkeypatch.setenv("EC_PMON", "1")
    sampler = pmon.EnergySampler(cuda)
    e0, p0 = pmon.energy_power(sampler._source)
    x = torch.ones(1 << 26, device=cuda)
    for _ in range(200):
        x.mul_(1.0)
    torch.cuda.synchronize()
    e1, _ = pmon.energy_power(sampler._source)
    assert e1 >= e0 > 0.0 and p0 > 0.0
    sampler.start()
    assert sampler.stop_and_report().startswith(" EC_PMON: energy delta ")


# ---- generality, meshes and ranks on the card ---------------------------------

def _truncated(inp, nlev):
    """The atmosphere cut at `nlev` full levels, the top kept
    (tests/test_level_generality.py's `_truncated`; that module imports
    JAX)."""
    import dataclasses

    fields = {}
    for name, a in inp.fields.items():
        if a.ndim >= 2 and a.shape[-2] == inp.klev:
            fields[name] = np.ascontiguousarray(a[..., :nlev, :])
        elif a.ndim >= 2 and a.shape[-2] == inp.klev + 1:
            fields[name] = np.ascontiguousarray(a[..., :nlev + 1, :])
        else:
            fields[name] = a
    return dataclasses.replace(inp, fields=fields, klev=nlev)


def _bitwise(p, c):
    got = cc.cloudsc_fused(p, c)
    want = cc.cloudsc_fused_plain(p, c)
    torch.cuda.synchronize()
    for name, a, b in zip(("o_lev", "o_half", "o_prainfrac"), got, want):
        assert a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        assert torch.equal(a, b), \
            f"{name}: max abs err {float((a - b).abs().max()):.3e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nlev", [61, 68, 91])
def test_kernel_bitwise_at_any_level_count(cuda, nlev, dtype):
    """K1 takes the level count at run time: at 61, 68 and 91 levels and
    the ragged 16,387 columns, bit for bit with its plain version."""
    inp = _truncated(tdata.load_input(tdata.default_input_path(), 16387),
                     nlev)
    params = Params.from_input(inp)
    c = tscheme.derived_consts(params, inp.ptsphy, dtype)
    p = cc.pack_inputs_folded(inp, params, dtype=dtype).to(cuda)
    assert p.nlev == nlev
    _bitwise(p, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_bitwise_on_a_perturbed_state(cuda, dtype):
    """A seeded shake of the snapshot (tests/test_robustness.py's kind:
    +-8 K, moisture 0.3-1.7x, condensates 0-5x, cloud fraction 0-2.5x
    clipped) fires branches the snapshot leaves cold; K1 stays bit for bit
    with its plain version and finite."""
    import dataclasses

    inp = tdata.load_input(tdata.default_input_path(), 1000)
    rng = np.random.default_rng(3)
    f = dict(inp.fields)
    f["PT"] = f["PT"] + rng.uniform(-8.0, 8.0, size=(1, 100))
    f["PQ"] = f["PQ"] * rng.uniform(0.3, 1.7, size=f["PQ"].shape)
    f["PCLV"] = f["PCLV"] * rng.uniform(0.0, 5.0, size=f["PCLV"].shape)
    f["PA"] = np.clip(f["PA"] * rng.uniform(0.0, 2.5, size=f["PA"].shape),
                      0.0, 1.0)
    inp = dataclasses.replace(inp, fields=f)
    params = Params.from_input(inp)
    c = tscheme.derived_consts(params, inp.ptsphy, dtype)
    _bitwise(cc.pack_inputs_folded(inp, params, dtype=dtype).to(cuda), c)


@pytest.mark.parametrize("backend", ["cuda", "scan"])
def test_mesh_on_one_card_bitwise_equals_one_device(cuda, backend):
    """Two shares on one card (a device may repeat): equal to the
    one-device run bit for bit, one timer row and one launch a share."""
    from cloudsc_tpu_torch.runtime.driver import CloudscDriver

    inp = tdata.load_input(tdata.default_input_path(), 16387)
    params = Params.from_input(inp)
    one, _, _ = CloudscDriver(params, inp.ptsphy, torch.float64, "cuda",
                              backend=backend).run(inp)
    mesh = CloudscDriver(params, inp.ptsphy, torch.float64, backend=backend,
                         devices=["cuda", "cuda"])
    before = tracing.counter("ops.k1")
    two, _, timer = mesh.run(inp, iterations=2)
    launched = tracing.counter("ops.k1") - before
    assert launched == (6 if backend == "cuda" else 0)
    assert len(timer.device_cols) == 2 and sum(timer.device_cols) == 2 * 16387
    for name in one._fields:
        np.testing.assert_array_equal(getattr(two, name), getattr(one, name),
                                      err_msg=name)


def test_scan_padding_bitwise_on_the_card(cuda):
    """The scan driver's zero padding (100 columns to 128) leaves every
    real column as the unpadded engine gives it, bit for bit: the card has
    no vector tail (tests/test_torch_generality.py states the host's)."""
    from cloudsc_tpu_torch.physics.cloudsc import cloudsc, fields_on_device
    from cloudsc_tpu_torch.runtime.driver import CloudscDriver

    inp = tdata.load_input(tdata.default_input_path(), 100)
    params = Params.from_input(inp)
    plain = cloudsc(fields_on_device(inp, torch.float64, cuda), params,
                    inp.ptsphy)
    padded, _, _ = CloudscDriver(params, inp.ptsphy, torch.float64, "cuda",
                                 backend="scan", nproma=64).run(inp)
    for name in plain._fields:
        np.testing.assert_array_equal(getattr(padded, name),
                                      getattr(plain, name).cpu().numpy(),
                                      err_msg=name)


def test_rank_reference_on_the_card(cuda):
    """The reference of rank 1 of 2 put on the card equals
    `load_reference`'s slice of it."""
    from cloudsc_tpu_torch.validate import reference_on_device

    path = tdata.default_reference_path()
    got = reference_on_device(path, 50, cuda, 100, 1, 2)
    for k, v in tdata.load_reference(path, 50, 100, 1, 2).items():
        assert got[k].device.type == "cuda"
        np.testing.assert_array_equal(got[k].cpu().numpy(), v, err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(synthetic.FORM_CASES))
def test_form_build_bitwise_equals_plain(cuda, case, dtype):
    """Each form's build of K1 equals its plain version bit for bit at a
    ragged 16,387 columns (NaNs included), launches once as its own
    version, and runs with at least one block an SM and its form's rows in
    the ring."""
    form, cfg = synthetic.FORM_CASES[case]
    form, fo = synthetic.split_form(form)
    inp = tdata.load_input(tdata.default_input_path(), 16387)
    params = Params.from_input(inp)
    config = tscheme.SchemeConfig(**cfg)
    c = tscheme.derived_consts(params, inp.ptsphy, dtype, config)
    p = cc.pack_inputs_raw(inp, params, config, dtype=dtype,
                           **form).to(cuda)
    v = cc.kernel_version(c, p.form, fo)
    assert v != cc.DEFAULT_VERSION
    tracing.reset()
    got = cc.cloudsc_fused(p, c, fold_outputs=fo)
    want = cc.cloudsc_fused_plain(p, c, fo)
    torch.cuda.synchronize()
    assert tracing.keyed("launches.k1.version") == {v: 1}
    ints = torch.int32 if dtype == torch.float32 else torch.int64
    for name, a, b in zip(("o_lev", "o_half", "o_prainfrac"), got, want):
        # a build that skips sections is wrong physics by construction (set
        # B drops the implicit solve, which overflows fp32): bit for bit,
        # NaNs included
        assert cfg.get("skip") or bool(torch.isfinite(a).all()), name
        assert torch.equal(a.view(ints), b.view(ints)), name
    occ = cc.occupancy(dtype, build.load_library(version=v))
    assert occ["blocks_per_sm"] >= 1
    assert occ["smem_bytes"] == cc.RING.smem_bytes(p.pack.element_size(),
                                                   len(p.rows))


@pytest.mark.parametrize("env", [{"CLOUDSC_GROUP_COLUMNS": "0"},
                                 {"CLOUDSC_GROUP_SORT": "0"}],
                         ids=["cyclic", "grouped_unsorted"])
def test_layouts_equal_sorted_main_path(cuda, env, monkeypatch):
    """The cyclic and grouped-unsorted layouts, after the ungroup, equal
    the sorted main path bit for bit at 16,387 columns (K1 has nothing
    across columns)."""
    from cloudsc_tpu_torch.runtime.driver import CloudscDriver

    inp = tdata.load_input(tdata.default_input_path(), 16387)
    params = Params.from_input(inp)
    for var in ("CLOUDSC_GROUP_COLUMNS", "CLOUDSC_GROUP_SORT"):
        monkeypatch.delenv(var, raising=False)
    base, _, _ = CloudscDriver(params, inp.ptsphy, device="cuda").run(
        inp, fetch_outputs=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    out, _, _ = CloudscDriver(params, inp.ptsphy, device="cuda").run(
        inp, fetch_outputs=False)
    for name, a, b in zip(base._fields, out, base):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fields_entry_bitwise_on_the_card(cuda, dtype):
    """The per-field entry on a field dict expanded on the card: its device
    pack equals the host's unfolded pack, and its outputs equal the
    unfolded (in-line CUADJTQ) build's on that pack and the plain
    version's, bit for bit, at a ragged 16,387 columns; one launch of the
    dict's build (the ZDQS row streamed) a call."""
    from cloudsc_tpu_torch.physics.cloudsc import fields_on_device

    inp = tdata.load_input(tdata.default_input_path(), 16387)
    params = Params.from_input(inp)
    c = tscheme.derived_consts(params, inp.ptsphy, dtype)
    fields = fields_on_device(inp, dtype, cuda)
    host = cc.pack_inputs_unfolded(inp, params, dtype=dtype,
                                   column_order="cyclic")
    dev = cc.pack_inputs(fields, params)
    assert torch.equal(dev.pack.cpu(), host.pack)
    v = cc.kernel_version(c, cc.ROWS_FORM)
    tracing.reset()
    got = cc.cloudsc_fused_fields(fields, params, inp.ptsphy)
    torch.cuda.synchronize()
    assert tracing.keyed("launches.k1.version") == {v: 1}
    p = host.to(cuda)
    want = cc.assemble(cc.cloudsc_fused(p, c), p, c)
    plain = cc.assemble(cc.cloudsc_fused_plain(p, c), p, c)
    for name, a, b, d in zip(want._fields, got, want, plain):
        assert bool(torch.isfinite(a).all()), name
        assert torch.equal(a, b) and torch.equal(a, d), name


def test_scan_pack_bitwise_on_the_card(cuda):
    """The pre-packed scan step equals the plain dict's bit for bit on the
    card, fp64, 1,000 columns."""
    from cloudsc_tpu_torch.physics.cloudsc import cloudsc, fields_on_device, \
        scan_pack

    inp = tdata.load_input(tdata.default_input_path(), NCOL)
    params = Params.from_input(inp)
    fields = fields_on_device(inp, torch.float64, cuda)
    want = cloudsc(fields, params, inp.ptsphy)
    got = cloudsc(scan_pack(fields, params, inp.ptsphy), params, inp.ptsphy)
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["pack", "fields"])
@pytest.mark.parametrize("ncol", [16387, 16384])
def test_foldo_kernel_bitwise_equals_plain(cuda, ncol, kind, dtype):
    """csrc/foldo.cu against the plain loop on the card, all four rows bit
    for bit: from a folded pack (strided rows) or a field dict expanded on
    the card (contiguous rows), with PFPLSL/N the strided views of K1's
    o_half, at a ragged and a whole-block column count; one launch a call,
    counted in `launches.foldo` and `ops.assemble`."""
    from cloudsc_tpu_torch.physics.cloudsc import fields_on_device

    inp = tdata.load_input(tdata.default_input_path(), ncol)
    params = Params.from_input(inp)
    c = tscheme.derived_consts(params, inp.ptsphy, dtype)
    if kind == "pack":
        src = p = cc.pack_inputs_folded(inp, params, dtype=dtype).to(cuda)
        assert src.pack[:, src.row("paph")].stride(0) == len(src.rows) * ncol
    else:
        src = fields_on_device(inp, dtype, cuda)
        p = cc.pack_inputs(src, params)
        assert src["pvfl"].is_contiguous()
    o_half = cc.cloudsc_fused(p, c)[1]
    half = {n: o_half[:, j] for j, n in enumerate(cc.ohalf_rows(True))}
    assert half["pfplsl"].stride(0) == o_half.shape[1] * ncol
    got, want = dict(half), dict(half)
    counts = ("launches.foldo", "ops.assemble")
    before = [tracing.counter(n) for n in counts]
    cc.foldo_synthesize(got, src, c)
    assert [tracing.counter(n) - b for n, b in zip(counts, before)] == [1, 1]
    cc.foldo_synthesize_plain(want, src, c)
    torch.cuda.synchronize()
    assert tracing.counter("launches.foldo") == before[0] + 1
    for name in cc.FOLDO_ROWS:
        a, b = got[name], want[name]
        assert a.shape == b.shape == (inp.klev + 1, ncol), name
        assert bool(torch.isfinite(a).all()), name
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_step_device_ops_on_the_card(cuda, dtype):
    """The resident step on the card (a field dict read in place by K1,
    then `assemble`) issues 3 device operations: the K1 layer's 2
    (zdqs_kernel's ZDQS row, then K1) and `assemble`'s 1 (the flux rows'
    one launch; the cloud tendencies are a view of K1's buffer), and no
    pack;
    `launches.foldo` and `launches.zdqs` count one launch a step and
    `launches.k1.in_place` every K1 launch."""
    from cloudsc_tpu_torch.physics.cloudsc import fields_on_device

    inp = tdata.load_input(tdata.default_input_path(), 16387)
    params = Params.from_input(inp)
    fields = fields_on_device(inp, dtype, cuda)
    step = cc.FusedStep(params, inp.ptsphy, dtype).to(cuda)
    cc.assemble(step(fields), fields, step.c)  # builds and warms up
    tracing.reset()
    for _ in range(2):
        cc.assemble(step(fields), fields, step.c)
    torch.cuda.synchronize()
    assert [tracing.counter(n) for n in ("ops.pack", "ops.k1",
                                         "ops.assemble")] == [0, 4, 2]
    assert tracing.counter("launches.foldo") == 2
    assert tracing.counter("launches.zdqs") == 2
    assert tracing.counter("launches.k1.in_place") == 2
    assert tracing.counter("pack_bytes") == 0


@pytest.mark.parametrize("fold_outputs", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_step_writes_the_vapour_plane(cuda, dtype, fold_outputs):
    """K1 writes the vapour species' cloud-tendency row itself: with the
    block that the step's level buffer takes from the caching allocator
    filled with NaN beforehand, a step on a field dict gives a vapour
    plane of +0 and all 21 outputs bit for bit the plain version's on the
    same dict, TENDENCY_LOC_CLD a view of that buffer."""
    from cloudsc_tpu_torch.physics.cloudsc import fields_on_device

    inp = tdata.load_input(tdata.default_input_path(), NCOL)
    params = Params.from_input(inp)
    fields = fields_on_device(inp, dtype, cuda)
    step = cc.FusedStep(params, inp.ptsphy, dtype,
                        fold_outputs=fold_outputs).to(cuda)
    step(fields)  # builds; its blocks go back to the allocator
    torch.cuda.synchronize()
    # the step's requests in its order: the ZDQS row, then the level
    # buffer, which the NaN block's freed place serves next
    nlev, ncol = fields["pt"].shape
    zdqs = torch.empty_like(fields["pt"])
    poison = torch.full((nlev, len(cc.OLEV_ROWS), ncol), float("nan"),
                        dtype=dtype, device=cuda)
    ptr = poison.data_ptr()
    del poison, zdqs
    res = step(fields)
    assert res[0].data_ptr() == ptr
    got = cc.assemble(res, fields, step.c, fold_outputs)
    assert got.tendency_loc_cld.data_ptr() == \
        ptr + cc.TCLD0 * ncol * res[0].element_size()
    want = cc.assemble(cc.cloudsc_fused_plain(fields, step.c, fold_outputs),
                       fields, step.c, fold_outputs)
    torch.cuda.synchronize()
    ints = torch.int32 if dtype == torch.float32 else torch.int64
    assert not got.tendency_loc_cld[tscheme.IV].view(ints).any()
    _outputs_bitwise(got, want)


def _in_place_case(case, dtype, cuda, ncol=16387):
    """(params, SchemeConfig, the field dict on the card) of the reference
    configuration or the aerosol build (every coupling's rows), at `ncol`
    columns."""
    from cloudsc_tpu_torch.physics.cloudsc import fields_on_device

    inp = tdata.load_input(tdata.default_input_path(), ncol)
    params = Params.from_input(inp)
    config = None
    if case == "aerosol":
        inp, params, config = synthetic.version_case(case, inp, params)
    return inp, params, config, fields_on_device(inp, dtype, cuda)


def _outputs_bitwise(got, want):
    for name, a, b in zip(want._fields, got, want):
        ints = torch.int32 if a.dtype == torch.float32 else torch.int64
        assert bool(torch.isfinite(a).all()), name
        assert torch.equal(a.view(ints), b.view(ints)), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["reference", "aerosol"])
def test_in_place_step_bitwise_equals_packed(cuda, case, dtype):
    """The step on a field dict read in place (zdqs_kernel's ZDQS row, then
    the Rows policy streaming it) gives the 21 outputs of the packed step
    (`pack_inputs` and the Pack policy of the unfolded build, the in-line
    CUADJTQ) bit for bit at a ragged 16,387 columns, for the reference
    configuration and the aerosol build's extra rows: one K1 launch,
    counted in place, after one zdqs_kernel launch, and no pack."""
    inp, params, config, fields = _in_place_case(case, dtype, cuda)
    step = cc.FusedStep(params, inp.ptsphy, dtype, config).to(cuda)
    assert cc.rows_in_place(fields, step.c)
    tracing.reset()
    got = cc.assemble(step(fields), fields, step.c)
    torch.cuda.synchronize()
    assert [tracing.counter(n) for n in (
        "ops.pack", "ops.k1", "launches.k1.in_place",
        "launches.zdqs")] == [0, 2, 1, 1]
    assert tracing.keyed("launches.k1.version") == {
        cc.kernel_version(step.c, cc.ROWS_FORM): 1}
    p = cc.pack_inputs(fields, params, config)
    want = cc.assemble(cc.cloudsc_fused(p, step.c), fields, step.c)
    torch.cuda.synchronize()
    _outputs_bitwise(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("fault", ["transposed", "ldcum_float"])
def test_refused_dict_falls_back_to_the_pack(cuda, fault, dtype):
    """A dict `rows_in_place` refuses (a row laid out level-innermost, or
    LDCUM in the working dtype) raises on the card, naming the row, from
    `cloudsc_fused` and from the step: nothing is packed or launched."""
    inp, params, _, fields = _in_place_case("reference", dtype, cuda)
    step = cc.FusedStep(params, inp.ptsphy, dtype).to(cuda)
    bad = dict(fields)
    if fault == "transposed":
        bad["pt"] = fields["pt"].t().contiguous().t()
    else:
        bad["ldcum"] = fields["ldcum"].to(dtype)
    assert not cc.rows_in_place(bad, step.c)
    named = "pt" if fault == "transposed" else "ldcum"
    tracing.reset()
    with pytest.raises(ValueError, match=f"in place: {named}"):
        cc.cloudsc_fused(bad, step.c)
    with pytest.raises(ValueError, match=f"in place: {named}"):
        step(bad)
    with pytest.raises(ValueError, match=f"in place: {named}"):
        cc.zdqs_row(bad, step.c)
    torch.cuda.synchronize()
    assert [tracing.counter(n) for n in (
        "ops.pack", "ops.k1", "launches.k1.in_place",
        "launches.zdqs")] == [0] * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rows_policy_occupancy(cuda, dtype):
    """The Rows policy's build of K1 that a field dict runs (the unfolded
    rows and the ZDQS row, 28 ring rows) takes within 4 registers of the
    Pack policy's in the same library, uses no more local memory a thread
    (none in fp32), runs the same ring, and keeps its blocks an SM: 3 in
    fp32, 2 in fp64, the fp64 ring then holding 2 x 114,688 B of the SM's
    shared memory."""
    c = tscheme.derived_consts(
        Params.from_input(tdata.load_input(tdata.default_input_path(), 100)),
        1.0, dtype)
    lib = build.load_library(version=cc.kernel_version(c, cc.ROWS_FORM))
    pack = cc.occupancy(dtype, lib)
    rows = cc.occupancy(dtype, lib, rows=True)
    assert rows["local_bytes"] <= pack["local_bytes"], (rows, pack)
    if dtype == torch.float32:
        assert rows["local_bytes"] == 0, rows
    assert abs(rows["registers"] - pack["registers"]) <= 4, (rows, pack)
    assert rows["smem_bytes"] == pack["smem_bytes"] == cc.RING.smem_bytes(
        torch.finfo(dtype).bits // 8, 28)
    assert rows["blocks_per_sm"] == (3 if dtype == torch.float32 else 2), \
        rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ncol", [16387, 163840])
def test_zdqs_kernel_bitwise_equals_plain(cuda, ncol, dtype):
    """zdqs_kernel (`zdqs_row`) on a field dict expanded on the card, read
    in place, against `zdqs_plain` on the same dict: the (nlev, ncol) ZDQS
    row bit for bit, at a ragged and at the cells' column count; one launch
    a call, counted in `launches.zdqs` and `ops.k1`."""
    from cloudsc_tpu_torch.physics.cloudsc import fields_on_device

    inp = tdata.load_input(tdata.default_input_path(), ncol)
    params = Params.from_input(inp)
    c = tscheme.derived_consts(params, inp.ptsphy, dtype)
    fields = fields_on_device(inp, dtype, cuda)
    tracing.reset()
    got = cc.zdqs_row(fields, c)
    assert [tracing.counter(n) for n in ("launches.zdqs", "ops.k1")] == [1, 1]
    want = cc.zdqs_plain(fields, c)
    torch.cuda.synchronize()
    ints = torch.int32 if dtype == torch.float32 else torch.int64
    assert got.shape == (inp.klev, ncol)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got.view(ints), want.view(ints))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dict_step_bitwise_equals_the_inline_build(cuda, dtype):
    """`cloudsc_fused` on a 163,840-column cyclic field dict on the card
    (zdqs_kernel, then K1's Rows policy streaming the ZDQS row) against the
    unfolded build's Pack policy, which runs the in-line CUADJTQ, on the
    same columns (`pack_inputs(fields)`): all three buffers bit for bit."""
    from cloudsc_tpu_torch.physics.cloudsc import fields_on_device

    inp = tdata.load_input(tdata.default_input_path(), 163840)
    params = Params.from_input(inp)
    c = tscheme.derived_consts(params, inp.ptsphy, dtype)
    fields = fields_on_device(inp, dtype, cuda)
    got = cc.cloudsc_fused(fields, c)
    p = cc.pack_inputs(fields, params)
    assert not p.fn and not p.fold_inputs
    want = cc.cloudsc_fused(p, c)
    torch.cuda.synchronize()
    ints = torch.int32 if dtype == torch.float32 else torch.int64
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a.view(ints), b.view(ints))
