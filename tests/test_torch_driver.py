"""The port's main path as a whole, on the CPU (the plain version of the
kernel, and the eager scan engine): the driver against reference.h5 and
against the JAX driver, its engines and their refusals, the CLI,
the refusal to run `--device cuda` without a card, the h5py-free snapshot
archives, the port's copies of the JAX package's numpy helpers, chip_smoke's
fp64 bar, and that neither the package nor chip_smoke imports JAX or the JAX
package.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cloudsc_tpu.data import load_input, load_reference
from cloudsc_tpu.validate import FIELD_ATTR, REF_DATASET, VALIDATION_ORDER, \
    validate_outputs
from cloudsc_tpu_torch import data as tdata
from cloudsc_tpu_torch import validate as tvalidate
from cloudsc_tpu_torch.data import expand as texpand
from cloudsc_tpu_torch.params import Params as TParams
from cloudsc_tpu_torch.runtime.driver import CloudscDriver

from conftest import REFERENCE_DATA, REFERENCE_H5, relerr
from test_golden import FP64_TOL

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


def test_port_never_imports_jax():
    """Importing every module of the package and chip_smoke, and running the
    CPU driver, an adjoint and the fp64 attribution, leaves JAX and the JAX package out of sys.modules (needs a
    fresh process: conftest imports both here)."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import cloudsc_tpu_torch, cloudsc_tpu_torch.cli, "
        "cloudsc_tpu_torch.data\n"
        "import cloudsc_tpu_torch.kernels.cuda_cloudsc, "
        "cloudsc_tpu_torch.kernels.build, "
        "cloudsc_tpu_torch.kernels.cuda_probes\n"
        "import cloudsc_tpu_torch.bench.kernel_lab, "
        "cloudsc_tpu_torch.bench.overlap_probe, "
        "cloudsc_tpu_torch.bench.dma_probe, "
        "cloudsc_tpu_torch.bench.ring_sweep, "
        "cloudsc_tpu_torch.bench.timing\n"
        "import cloudsc_tpu_torch.physics.scheme, "
        "cloudsc_tpu_torch.physics.satfold, cloudsc_tpu_torch.validate, "
        "cloudsc_tpu_torch.physics.cloudsc, "
        "cloudsc_tpu_torch.data.synthetic\n"
        "import cloudsc_tpu_torch.physics.autodiff, "
        "cloudsc_tpu_torch.runtime.pmon, "
        "cloudsc_tpu_torch.bench.fp64_attribution, "
        "cloudsc_tpu_torch.bench.grad_blocks\n"
        "import cloudsc_tpu_torch.examples.adjoint_sensitivity, "
        "cloudsc_tpu_torch.examples.param_calibration, "
        "cloudsc_tpu_torch.examples.timestep_loop, "
        "cloudsc_tpu_torch.examples.pod_sharding, "
        "cloudsc_tpu_torch.runtime.dist\n"
        "import chip_smoke\n"
        "from cloudsc_tpu_torch.params import Params\n"
        "from cloudsc_tpu_torch.runtime.driver import CloudscDriver\n"
        "inp = cloudsc_tpu_torch.data.load_input("
        "cloudsc_tpu_torch.data.default_input_path(), 16)\n"
        "drv = CloudscDriver(Params.from_input(inp), inp.ptsphy, "
        "dtype=torch.float64, device='cpu')\n"
        "out, _, _ = drv.run(inp)\n"
        "assert out.plude.shape == (137, 16)\n"
        "drv = CloudscDriver(Params.from_input(inp), inp.ptsphy, "
        "dtype=torch.float64, device='cpu', backend='scan')\n"
        "out, _, _ = drv.run(inp, fetch_outputs=False)\n"
        "assert out.plude.shape == (137, 16)\n"
        "g = cloudsc_tpu_torch.examples.adjoint_sensitivity.sensitivity("
        "8, 'cpu')\n"
        "assert g.shape == (137, 8)\n"
        "assert cloudsc_tpu_torch.bench.fp64_attribution.attribute("
        "8, 'cpu')[0][0] == 'PLUDE'\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'cloudsc_tpu') "
        "or m.startswith(('jax.', 'jaxlib', 'cloudsc_tpu.')))\n"
        "print('JAXMODS', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = _run(["-c", code])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "JAXMODS []" in r.stdout


@pytest.fixture(scope="module")
def cpu_fp64_100():
    inp = tdata.load_input(tdata.default_input_path(), 100)
    drv = CloudscDriver(TParams.from_input(inp), inp.ptsphy,
                        dtype=torch.float64, device="cpu")
    out, timings, timer = drv.run(inp)
    return out, timings


def test_cpu_driver_matches_reference_fp64(cpu_fp64_100, reference_100):
    out, timings = cpu_fp64_100
    bad = {}
    for name, _ in VALIDATION_ORDER:
        got = np.asarray(getattr(out, FIELD_ATTR[name]))
        want = reference_100[REF_DATASET[name]]
        assert got.shape == want.shape, name
        assert got.dtype == np.float64
        err = relerr(got, want)
        if not err < FP64_TOL:
            bad[name] = err
    assert not bad, f"fp64 fields over FP64_TOL: {bad}"
    errs = validate_outputs(out, reference_100, ngptotg=100,
                            print_table=False)
    flagged = [e.name for e in errs if e.flagged]
    assert len(flagged) <= 1, f"fp64 flag count: {flagged}"
    assert timings.compute_s > 0 and timings.d2h_s >= 0


def test_cpu_driver_grouped_matches_jax_driver():
    """ngptot=300: activity-sorted grouped columns and the inverse gather,
    against the JAX driver's XLA scan on the canonical layout."""
    import jax.numpy as jnp

    from cloudsc_tpu.params import Params
    from cloudsc_tpu.runtime.driver import CloudscDriver as JaxDriver

    inp = load_input(REFERENCE_DATA, ngptot=300, expand=False)
    params = Params.from_input(inp)
    out, _, _ = CloudscDriver(params, inp.ptsphy, dtype=torch.float64,
                              device="cpu").run(inp)
    ref, _, _ = JaxDriver(params, inp.ptsphy, dtype=jnp.float64,
                          backend="xla").run(inp)
    bad = {}
    for name in ref._fields:
        got, want = getattr(out, name), np.asarray(getattr(ref, name))
        assert got.shape == want.shape, name
        err = relerr(got, want)
        if not err < FP64_TOL:
            bad[name] = err
    assert not bad, f"port vs JAX driver at 300 columns: {bad}"


def test_cli_cpu_fp64():
    r = _run(["-m", "cloudsc_tpu_torch", "1", "100", "16", "--device", "cpu",
              "--precision", "fp64"])
    assert r.returncode == 0, r.stdout + r.stderr
    out = r.stdout
    assert "NUMPROC=1, NUMOMP=1, NGPTOTG=100, NPROMA=16, NGPBLKS=7" in out
    assert "Reference MFLOP count for 100 columns" in out
    assert ": TOTAL" in out and "device compute:" in out
    assert "Variable" in out and "MaxRelErr-%" in out
    for name, _ in VALIDATION_ORDER:
        assert f" {name:<20s} " in out, name


def test_scan_driver_matches_reference_fp64(reference_100):
    """The scan engine through the driver: the plain dict zero-padded to a
    multiple of NPROMA (100 -> 112 columns) and cut back, within FP64_TOL of
    reference.h5; with `fetch_outputs=False` the same values stay tensors
    and no D2H is timed."""
    inp = tdata.load_input(tdata.default_input_path(), 100)
    drv = CloudscDriver(TParams.from_input(inp), inp.ptsphy,
                        dtype=torch.float64, device="cpu", backend="scan",
                        nproma=16)
    assert drv.prepare(inp)["pt"].shape == (137, 112)
    out, timings, _ = drv.run(inp, fetch_outputs=False)
    assert isinstance(out.plude, torch.Tensor) and timings.d2h_s == 0.0
    bad = {}
    for name, _ in VALIDATION_ORDER:
        got = getattr(out, FIELD_ATTR[name]).numpy()
        want = reference_100[REF_DATASET[name]]
        assert got.shape == want.shape, name
        err = relerr(got, want)
        if not err < FP64_TOL:
            bad[name] = err
    assert not bad, f"scan driver vs reference.h5: {bad}"


def test_driver_engines_refuse_clearly(params, input_100):
    """No silent fallback: a configuration the kernel does not take raises
    and names the scan engine, which takes it; backend 'cuda' needs the
    card; an unknown backend raises."""
    from cloudsc_tpu_torch.physics.scheme import SchemeConfig

    # every section tag is a kernel build now; a tag no build knows is not
    CloudscDriver(params, input_100.ptsphy, device="cpu",
                  scheme_config=SchemeConfig(skip=("s37",)))
    cfg = SchemeConfig(skip=("s99",))
    with pytest.raises(ValueError, match="--kernel scan"):
        CloudscDriver(params, input_100.ptsphy, device="cpu",
                      scheme_config=cfg)
    CloudscDriver(params, input_100.ptsphy, device="cpu", scheme_config=cfg,
                  backend="scan")
    with pytest.raises(ValueError, match="needs device='cuda'"):
        CloudscDriver(params, input_100.ptsphy, device="cpu", backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        CloudscDriver(params, input_100.ptsphy, device="cpu", backend="xla")


def test_kernel_driver_keeps_outputs_on_device(cpu_fp64_100):
    """`fetch_outputs=False` on the kernel path: the canonical-order
    outputs as tensors, equal to the fetched ones."""
    want, _ = cpu_fp64_100
    inp = tdata.load_input(tdata.default_input_path(), 100)
    out, timings, _ = CloudscDriver(
        TParams.from_input(inp), inp.ptsphy, dtype=torch.float64,
        device="cpu").run(inp, fetch_outputs=False)
    assert timings.d2h_s == 0.0
    for a, b in zip(out, want):
        assert isinstance(a, torch.Tensor)
        np.testing.assert_array_equal(a.numpy(), b)


def test_cli_cuda_without_card_fails_clearly():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal path needs none")
    r = _run(["-m", "cloudsc_tpu_torch", "1", "100", "16"])
    assert r.returncode != 0
    assert "--device cuda needs a CUDA device" in r.stderr
    assert "Variable" not in r.stdout


def test_driver_cuda_without_card_raises(params, input_100):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal path needs none")
    with pytest.raises(RuntimeError, match="cuda"):
        CloudscDriver(params, input_100.ptsphy, device="cuda")


def test_npz_archives_equal_h5_mirrors():
    """data/input.npz and data/reference.npz hold the .h5 mirrors' arrays and
    scalars bitwise (the port reads them where h5py is absent)."""
    a = tdata.load_input(tdata.default_input_path(), 300)
    b = load_input(REFERENCE_DATA, ngptot=300, expand=False)
    assert (a.klon_file, a.klev, a.ngptot, a.ptsphy) == \
        (b.klon_file, b.klev, b.ngptot, b.ptsphy)
    assert a.scalars == b.scalars
    assert [type(v) for v in a.scalars.values()] == \
        [type(v) for v in b.scalars.values()]
    assert a.fields.keys() == b.fields.keys()
    for k in a.fields:
        assert a.fields[k].dtype == b.fields[k].dtype, k
        np.testing.assert_array_equal(a.fields[k], b.fields[k], err_msg=k)
    ra = tdata.load_reference(tdata.default_reference_path(), 300)
    rb = load_reference(REFERENCE_H5, ngptot=300)
    assert ra.keys() == rb.keys()
    for k in ra:
        np.testing.assert_array_equal(ra[k], rb[k], err_msg=k)


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_port_sources_import_no_jax_package():
    """No import statement of the package (its lab under bench/ included) or
    of chip_smoke names JAX or the JAX package, whichever branch it sits
    in."""
    files = sorted((ROOT / "cloudsc_tpu_torch").rglob("*.py"))
    for rel in ("bench/overlap_probe.py", "bench/fp64_attribution.py",
                "bench/grad_blocks.py", "physics/autodiff.py",
                "runtime/pmon.py", "examples/__init__.py",
                "examples/adjoint_sensitivity.py",
                "examples/param_calibration.py", "examples/timestep_loop.py",
                "examples/pod_sharding.py", "runtime/dist.py"):
        assert ROOT / "cloudsc_tpu_torch" / rel in files, rel
    files.append(ROOT / "chip_smoke.py")
    bad = {}
    for f in files:
        hit = sorted(n for n in _imports(f) if n.split(".")[0] in
                     ("jax", "jaxlib", "cloudsc_tpu"))
        if hit:
            bad[str(f.relative_to(ROOT))] = hit
    assert not bad


def test_params_copy_equals_jax_package(input_100):
    from cloudsc_tpu.params import Params

    a, b = Params.from_input(input_100), TParams.from_input(input_100)
    for group in ("ydcst", "ydthf", "ydecldp", "ydephli"):
        ga, gb = getattr(a, group), getattr(b, group)
        assert vars(ga) == vars(gb), group
        assert [type(v) for v in vars(ga).values()] == \
            [type(v) for v in vars(gb).values()], group


@pytest.mark.parametrize("ncol", [16, 100, 300, 1000])
def test_expand_copy_equals_jax_package(params, ncol):
    from cloudsc_tpu.data import expand as jexpand

    inp = tdata.load_input(tdata.default_input_path(), ncol)
    perm = texpand.activity_perm(inp.fields["PCLV"],
                                 inp.fields["TENDENCY_TMP_CLD"], inp.ptsphy,
                                 params.ydecldp.rlmin)
    np.testing.assert_array_equal(perm, jexpand.activity_perm(
        inp.fields["PCLV"], inp.fields["TENDENCY_TMP_CLD"], inp.ptsphy,
        params.ydecldp.rlmin))
    np.testing.assert_array_equal(texpand.group_counts(100, ncol),
                                  jexpand.group_counts(100, ncol))
    if ncol >= 100:
        np.testing.assert_array_equal(
            texpand.group_inverse(100, ncol, perm),
            jexpand.group_inverse(100, ncol, perm))
    np.testing.assert_array_equal(texpand.group_inverse(100, ncol),
                                  jexpand.group_inverse(100, ncol))
    f = inp.fields["PCLV"]
    np.testing.assert_array_equal(texpand.expand_field(f, ncol),
                                  jexpand.expand_field(f, ncol))
    np.testing.assert_array_equal(
        texpand.expand_field(f, ncol, order="grouped"),
        jexpand.expand_field(f, ncol, order="grouped"))


def test_validate_copy_equals_jax_package(cpu_fp64_100, reference_100,
                                          capsys):
    """The same outputs give the JAX package's validation table, line for
    line, and the same statistics."""
    from cloudsc_tpu import validate as jvalidate

    out, _ = cpu_fp64_100
    a = tvalidate.validate_outputs(out, reference_100, ngptotg=100)
    ta = capsys.readouterr().out
    b = jvalidate.validate_outputs(out, reference_100, ngptotg=100)
    tb = capsys.readouterr().out
    assert ta == tb and "Variable" in ta
    assert [dataclasses.astuple(e) for e in a] == \
        [dataclasses.astuple(e) for e in b]
    assert tvalidate.VALIDATION_ORDER == jvalidate.VALIDATION_ORDER
    assert tvalidate.FIELD_ATTR == jvalidate.FIELD_ATTR


def _relerr_full_size(out, reference_100, ngptot=None):
    """validate's FieldErrors at `ngptot` columns (chip_smoke's 163,840 by
    default), from a 100-column run: the expanded columns are exact copies,
    so each column's error counts as often as the cyclic expansion copies
    it."""
    from chip_smoke import NGPTOT

    w = texpand.group_counts(100, ngptot or NGPTOT).astype(np.float64)
    errs = []
    for name, ndim in tvalidate.VALIDATION_ORDER:
        got = np.asarray(getattr(out, tvalidate.FIELD_ATTR[name]), np.float64)
        want = np.asarray(reference_100[tvalidate.REF_DATASET[name]],
                          np.float64)
        errs.append(tvalidate.FieldErrors(
            name=name, ndim=ndim, minval=0.0, maxval=0.0, maxerr=0.0,
            errsum=float((np.abs(got - want) * w).sum()),
            refsum=float((np.abs(want) * w).sum()), avgpgp=0.0))
    return errs


def test_chip_smoke_fp64_bar(golden_outputs_fp64, cpu_fp64_100,
                             reference_100):
    """chip_smoke's fp64 bar (the sweep's fp64_verdict at its NGPTOT) holds
    the JAX fp64 engine's reading at 163,840 columns, and the port's plain
    version meets it at that size, which an engine twice as far off on one
    flagged field fails."""
    from chip_smoke import NGPTOT
    from cloudsc_tpu_torch.bench.sweep import JAX_FP64_RELERR, fp64_verdict

    def over_jax_reading(errs):
        return fp64_verdict(NGPTOT, {e.name: e.relerr for e in errs}
                            )["over_jax_reading"]

    jax_errs = _relerr_full_size(golden_outputs_fp64, reference_100)
    assert {e.name: e.relerr for e in jax_errs if e.relerr} == \
        pytest.approx(JAX_FP64_RELERR[NGPTOT], rel=1e-5, abs=0)
    port_errs = _relerr_full_size(cpu_fp64_100[0], reference_100)
    assert over_jax_reading(port_errs) == {}
    # the bar has teeth: twice the JAX engine's reading on one flux field
    worse = [dataclasses.replace(e, errsum=2 * e.errsum)
             if e.name == "PFSQLF" else e for e in jax_errs]
    assert list(over_jax_reading(worse)) == ["PFSQLF"]


def test_sweep_fp64_bar_by_size(golden_outputs_fp64, reference_100):
    """The sweep's JAX_FP64_RELERR is the JAX fp64 engine's reading at each
    size it lists (the fields it leaves out read 0)."""
    from cloudsc_tpu_torch.bench import sweep

    for n, table in sweep.JAX_FP64_RELERR.items():
        errs = _relerr_full_size(golden_outputs_fp64, reference_100, n)
        got = {e.name: e.relerr for e in errs if e.relerr}
        assert got == pytest.approx(table, rel=1e-5, abs=0), n


@pytest.mark.parametrize("env", [{"CLOUDSC_GROUP_COLUMNS": "0"},
                                 {"CLOUDSC_GROUP_SORT": "0"},
                                 {"CLOUDSC_FOLD_NEWTON": "0"},
                                 {"CLOUDSC_FOLD_CURVES": "1",
                                  "CLOUDSC_FOLD_DEP": "1"}],
                         ids=["cyclic", "grouped_unsorted", "fn_off",
                              "fc_fd"])
def test_driver_layout_and_form_switches(env, monkeypatch):
    """The JAX driver's switches on the port's driver, 256 columns fp64 on
    the CPU (a multiple of the vector width: no row tail, so a column's
    arithmetic does not depend on its position). The layouts: the cyclic
    pack and the grouped unsorted one, whose outputs after the ungroup are
    the sorted default's bit for bit. The forms: the driver packs the
    form's rows, and its outputs are within FP64_TOL of the default's."""
    from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc

    for var in ("CLOUDSC_GROUP_COLUMNS", "CLOUDSC_GROUP_SORT",
                "CLOUDSC_FOLD_NEWTON", "CLOUDSC_FOLD_CURVES",
                "CLOUDSC_FOLD_DEP"):
        monkeypatch.delenv(var, raising=False)
    inp = tdata.load_input(tdata.default_input_path(), 256)
    params = TParams.from_input(inp)
    base = CloudscDriver(params, inp.ptsphy, dtype=torch.float64,
                         device="cpu")
    p0 = base.prepare(inp)
    want, _, _ = base.run(inp)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    driver = CloudscDriver(params, inp.ptsphy, dtype=torch.float64,
                           device="cpu")
    p = driver.prepare(inp)
    got, _, _ = driver.run(inp)
    form = cc.fold_flags()
    assert p.form == form and p.rows == cc.pack_rows(**form)
    if "CLOUDSC_GROUP_COLUMNS" in env or "CLOUDSC_GROUP_SORT" in env:
        assert p.rows == p0.rows and not torch.equal(p.pack, p0.pack)
        for name, a, b in zip(want._fields, got, want):
            np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        assert p.rows != p0.rows
        for name, a, b in zip(want._fields, got, want):
            assert relerr(a, b) < FP64_TOL, name
