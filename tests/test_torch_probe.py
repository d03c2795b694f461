"""The activity probe and the host-compiled forms on the CPU.

  * the port's recorded guard masks (`bench/activity_probe.record_masks`,
    the eager engine with `scheme.probe_hook`) against the JAX probe's
    `record_masks(cache_dir=None)` at 100 columns, fp64. The guards are
    threshold tests on fp64 values that torch and XLA round alike to an ulp
    or so; the 5.2.1 overshoot test `zsinksum > zmax` compares two sums
    that are equal in exact arithmetic on a few units, and there an ulp
    flips it: measured 4 of 12,300 units, none in any other guard. At most
    MASK_UNITS_DIFFER units of a guard may differ;
  * `tile_rates` equal to the JAX probe's on the same masks, and the warp
    model's fire and divergent shares;
  * `dynamic_skips=False` and `s521_round_skip` in the plain version
    against the JAX scan engine under the same SchemeConfig (as
    test_torch_skips.py holds the section skips), the round skip's probe
    tags recorded, and its rounds value-exact;
  * csrc/cloudsc_scheme.cuh compiled for the host (tests/
    cpu_scheme_harness.cpp, as test_torch_kernel.py's
    test_scheme_header_matches_plain_on_cpu) with each form's macros
    against the plain version on the same 100-column fp64 pack, within
    test_golden's FP64_TOL per field: between them the builds compile and
    run every macro branch of the header.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from cloudsc_tpu.data import load_input
from cloudsc_tpu.params import Params
from cloudsc_tpu_torch.data import synthetic
from cloudsc_tpu_torch.kernels import build
from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
from cloudsc_tpu_torch.physics import cloudsc as tcloudsc
from cloudsc_tpu_torch.physics import scheme as tscheme

from conftest import REFERENCE_DATA, relerr
from test_golden import FP64_TOL
from test_torch_skips import plain_against_jax_scan

torch.set_num_threads(1)

# units of a guard's (level, column) mask that may differ between the
# port's and the JAX probe's fp64 engines at 100 columns (measured 4)
MASK_UNITS_DIFFER = 12


def _jax_probe():
    path = Path(__file__).resolve().parents[1] / "bench" / "activity_probe.py"
    spec = importlib.util.spec_from_file_location("jax_activity_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def masks_pair():
    """(JAX probe's masks, the port's) at 100 columns, fp64, and the two
    packages' inputs and parameters."""
    from cloudsc_tpu_torch import data as tdata
    from cloudsc_tpu_torch.bench import activity_probe as tap
    from cloudsc_tpu_torch.params import Params as TParams

    jap = _jax_probe()

    inp = load_input(REFERENCE_DATA, ngptot=100)
    params = Params.from_input(inp)
    jm = jap.record_masks(inp, params, cache_dir=None)
    tinp = tdata.load_input(tdata.default_input_path(), 100)
    tparams = TParams.from_input(tinp)
    tm = tap.record_masks(tcloudsc.make_inputs(tinp, torch.float64), tparams,
                          tinp.ptsphy)
    return jap, tap, jm, tm, (inp, params), (tinp, tparams)


def test_recorded_masks_match_jax_probe(masks_pair):
    _, _, jm, tm, _, _ = masks_pair
    assert sorted(tm) == sorted(jm)
    assert {"s31", "s32", "s33", "s34e", "solver", "precip", "rain",
            "s521"} <= set(tm)
    for tag in jm:
        assert tm[tag].shape == jm[tag].shape, tag
        differ = int((tm[tag] != jm[tag]).sum())
        assert differ <= MASK_UNITS_DIFFER, (tag, differ)


@pytest.mark.parametrize("tile", [32 * 128, 4 * 128])
def test_tile_rates_equal_jax_probe(masks_pair, tile):
    jap, tap, jm, _, (inp, params), (tinp, tparams) = masks_pair
    for tag, a in jm.items():
        assert tap.tile_rates(a, tinp, tparams, tile=tile) == \
            jap.tile_rates(a, inp, params, tile=tile), tag
    # the warp rates are the tile model at 32 columns, plus the share of
    # units some but not all of whose lanes are active
    a = jm["precip"]
    w = tap.warp_rates(a, tinp, tparams)
    t = jap.tile_rates(a, inp, params, tile=32)
    assert {k: v[0] for k, v in w.items()} == t
    assert all(0.0 <= d <= f for f, d in w.values())


def test_unit_rates_counts_divergent_units():
    from cloudsc_tpu_torch.bench.activity_probe import unit_rates

    a = np.zeros((2, 8), bool)
    a[0, :4] = True      # level 0: tile 0 all active, tile 1 inert
    a[1, 5] = True       # level 1: tile 1 divergent
    assert unit_rates(a, 4) == (0.5, 0.25)
    # a ragged last tile is edge-padded with its last column
    assert unit_rates(a[:, :6], 4) == (0.5, 0.25)


@pytest.mark.parametrize("cfg", [dict(dynamic_skips=False),
                                 dict(s521_round_skip=True),
                                 dict(s521_round_skip=True,
                                      dynamic_skips=False)],
                         ids=["no_dynamic_skips", "round_skip",
                              "round_skip_forced"])
def test_plain_config_matches_jax_scan(params, cfg):
    bad, out, _ = plain_against_jax_scan(params, **cfg)
    assert not bad, f"{cfg}: plain version vs JAX scan: {bad}"
    # value-exact: the same outputs as the reference configuration's
    inp = load_input(REFERENCE_DATA, ngptot=100, expand=False)
    p = cc.pack_inputs_folded(inp, params, dtype=torch.float64)
    c0 = tscheme.derived_consts(params, inp.ptsphy, torch.float64)
    full = cc.assemble(cc.cloudsc_fused_plain(p, c0), p, c0)
    for a, b in zip(out, full):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_round_skip_reads_its_environment_and_probes(monkeypatch):
    monkeypatch.setenv("CLOUDSC_S521_ROUND_SKIP", "1")
    assert tscheme.SchemeConfig().s521_round_skip
    monkeypatch.setenv("CLOUDSC_S521_ROUND_SKIP", "0")
    assert not tscheme.SchemeConfig().s521_round_skip
    assert tscheme.SchemeConfig(s521_round_skip=True).s521_round_skip
    from cloudsc_tpu_torch import data as tdata
    from cloudsc_tpu_torch.bench import activity_probe as tap
    from cloudsc_tpu_torch.params import Params as TParams

    inp = tdata.load_input(tdata.default_input_path(), 100)
    masks = tap.record_masks(
        tcloudsc.make_inputs(inp, torch.float64), TParams.from_input(inp),
        inp.ptsphy, tscheme.SchemeConfig(s521_round_skip=True))
    rounds = [t for t in masks if t.startswith("s521r")]
    assert rounds == [f"s521r{i}" for i in range(1, 5)]
    # a round runs where its species can overshoot: never more often than
    # the rescale itself
    for t in rounds:
        assert masks[t].sum() <= masks["s521"].sum()


def test_probe_defaults_to_the_card():
    from cloudsc_tpu_torch.bench import activity_probe as tap

    a = tap.parse_args([])
    assert (a.device, a.ngptot) == ("cuda", tap.MODEL_NGPTOT) == \
        ("cuda", 163840)
    a = tap.parse_args(["--device", "cpu"])
    assert (a.device, a.ngptot) == ("cpu", 100)
    assert tap.parse_args(["--ngptot", "16387"]).ngptot == 16387


# K1's form builds, and the per-round 5.2.1 skip alone
FORM_CASES = {**synthetic.FORM_CASES,
              "round_skip": ({}, dict(s521_round_skip=True))}


@pytest.mark.parametrize("case", list(FORM_CASES))
def test_scheme_header_form_matches_plain_on_cpu(case, tmp_path):
    import shutil

    from test_torch_kernel import _STUB_CUDA_RUNTIME, host_harness_outputs

    if shutil.which("g++") is None:
        pytest.skip("needs a host C++ compiler (g++)")
    form, kw = FORM_CASES[case]
    inp = load_input(REFERENCE_DATA, ngptot=100, expand=False)
    params = Params.from_input(inp)
    cfg = tscheme.SchemeConfig(**kw)
    c = tscheme.derived_consts(params, inp.ptsphy, torch.float64, cfg)
    p = cc.pack_inputs_folded(inp, params, cfg, dtype=torch.float64, **form)
    v = cc.kernel_version(c, p.form)
    assert v != cc.DEFAULT_VERSION
    (tmp_path / "cuda_runtime.h").write_text(_STUB_CUDA_RUNTIME)
    got = host_harness_outputs(p, c, v, tmp_path)
    want = cc.assemble(cc.cloudsc_fused_plain(p, c), p, c)
    bad = {name: relerr(getattr(got, name).numpy(),
                        getattr(want, name).numpy())
           for name in want._fields
           if not relerr(getattr(got, name).numpy(),
                         getattr(want, name).numpy()) < FP64_TOL}
    assert not bad, f"{case}: the host-compiled scheme header vs plain: {bad}"
    # the build's source hash is its own
    assert build.source_hash(build.nvcc_flags(version=v)) != \
        build.source_hash(build.nvcc_flags())
