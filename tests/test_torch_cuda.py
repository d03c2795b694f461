"""The CUDA kernels on the card: each against its plain PyTorch version on
the same inputs, their launch counts (K1's three bodies, the overlap probe,
the copy probe), K1's occupancy, each scheme version's build of K1, and
the validation norms reduced on the card against the host's. Every test
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

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

FP64_TOL = 5.0e-14  # tests/test_golden.py, which imports JAX


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
    before = cc.LAUNCHES
    for _ in range(3):
        step(p)
    cc.cloudsc_fused_plain(p, step.c)
    torch.cuda.synchronize()
    assert cc.LAUNCHES == before + 3


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
    before = cc.LAUNCHES
    got = cc.cloudsc_fused(p, c)
    want = cc.cloudsc_fused_plain(p, c)
    torch.cuda.synchronize()
    assert cc.LAUNCHES == before + 1
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
    before = cc.LAUNCHES
    got = cc.cloudsc_fused(p, c)
    want = cc.cloudsc_fused_plain(p, c)
    torch.cuda.synchronize()
    assert cc.LAUNCHES == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    skip = tscheme.derived_consts(params, inp.ptsphy, torch.float32,
                                  tscheme.SchemeConfig(skip=("s37",)))
    with pytest.raises(ValueError, match="SchemeConfig"):
        cc.cloudsc_fused(p, skip)
    assert cc.LAUNCHES == before + 1


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
    before = cc.LAUNCHES
    got = cc.cloudsc_fused(p, c)
    want = cc.cloudsc_fused_plain(p, c)
    torch.cuda.synchronize()
    assert cc.LAUNCHES == before + 1
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
    before = (cc.LAUNCHES, cc.FLOOR_LAUNCHES, cc.INIT_LAUNCHES)
    got = cc.assemble(cc.cloudsc_fused(p, c, mode=mode), p, c)
    plain = cc.cloudsc_floor_plain(p) if mode == "floor" else \
        cc.cloudsc_init_plain(p, c)
    want = cc.assemble(plain, p, c)
    torch.cuda.synchronize()
    after = (cc.LAUNCHES, cc.FLOOR_LAUNCHES, cc.INIT_LAUNCHES)
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
    before = cp.OVERLAP_LAUNCHES
    got = cp.overlap_step(x, col, variant, mode, w, sb)
    want = cp.overlap_plain(x, col, variant, mode, w, sb)
    torch.cuda.synchronize()
    assert cp.OVERLAP_LAUNCHES == before + 1
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
        before = cp.COPY_LAUNCHES
        got = cp.dma_copy(x, col, probe)
        _sync_within()
        assert cp.COPY_LAUNCHES == before + 1
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
    before = cp.COPY_LAUNCHES
    with pytest.raises(ValueError, match="16-byte aligned"):
        cp.dma_copy(x, col, probe)
    assert cp.COPY_LAUNCHES == before
    aligned = base[4:n + 4].reshape(probe.shape)
    got, _ = cp.dma_copy(aligned, col, probe)
    _sync_within()
    assert cp.COPY_LAUNCHES == before + 1
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
    before = cp.OVERLAP_LAUNCHES
    with pytest.raises(ValueError, match="built for"):
        cp.overlap_step(x, col, "plain", "full", 5, 1)
    assert cp.OVERLAP_LAUNCHES == before
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
    before = cc.LAUNCHES
    with pytest.raises(RuntimeError, match="--kernel scan"):
        cc.cloudsc_fused(p, drv.step.c, drv.step.consts)
    assert cc.LAUNCHES == before


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
    before = cc.LAUNCHES
    two, _, timer = mesh.run(inp, iterations=2)
    assert cc.LAUNCHES - before == (6 if backend == "cuda" else 0)
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
