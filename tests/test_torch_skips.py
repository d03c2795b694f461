"""K1's section skips on the CPU: the plain version with each of the 16
`SchemeConfig.skip` tags singly against the JAX package's scan engine under
the same SchemeConfig, at 100 columns in fp64, on the main path's form (the
folded inputs with the streamed ZDQS row, `make_inputs(fold=True,
fold_newton=True)` on the JAX side).

Some sections never act on the snapshot (no melting, freezing or rain in
it: s44a, s44b, s44c, s45r),
and skipping them moves nothing; both sides agree all the same.
A skipped section makes the physics wrong by construction, and some skips
leave fields far from any physical value (s522, the implicit solve, leaves
the explicit sums unsolved), but both sides drop the same statements, so
every field stays within test_golden's FP64_TOL (errsum/refsum); a field
that both sides leave zero counts as equal. `dynamic_skips=False` and
`s521_round_skip` are held the same way in test_torch_probe.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudsc_tpu.data import load_input
from cloudsc_tpu.physics import cloudsc as jcloudsc
from cloudsc_tpu.physics import make_inputs as jmake_inputs
from cloudsc_tpu.physics.scheme import SchemeConfig as JConfig
from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
from cloudsc_tpu_torch.physics import scheme as tscheme

from conftest import REFERENCE_DATA, relerr
from test_golden import FP64_TOL

torch.set_num_threads(1)


def plain_against_jax_scan(params, **cfg):
    """{field: relerr} of the plain version (after assemble) against the
    JAX scan engine under SchemeConfig(**cfg), 100 columns, fp64, for the
    fields not within FP64_TOL; and the two outputs."""
    inp = load_input(REFERENCE_DATA, ngptot=100, expand=False)
    fields = jmake_inputs(inp, jnp.float64, fold=True, fold_newton=True,
                          params=params)
    ref = jax.jit(lambda f: jcloudsc(f, params, inp.ptsphy,
                                     config=JConfig(**cfg)))(fields)
    p = cc.pack_inputs_folded(inp, params, dtype=torch.float64)
    c = tscheme.derived_consts(params, inp.ptsphy, torch.float64,
                               tscheme.SchemeConfig(**cfg))
    cc.check_kernel_config(c)
    out = cc.assemble(cc.cloudsc_fused_plain(p, c), p, c)
    bad = {}
    for name in ref._fields:
        got, want = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        assert got.shape == want.shape, name
        err = relerr(got, want)
        if not err < FP64_TOL:
            bad[name] = err
    return bad, out, ref


def check_skip(params, tag):
    bad, _, _ = plain_against_jax_scan(params, skip=(tag,))
    assert not bad, f"skip {tag}: plain version vs JAX scan: {bad}"


# the first eight tags here, the other eight in test_torch_skips_b.py (one
# file a worker under `--dist loadfile`: each JAX compile takes ~8-16 s)
@pytest.mark.parametrize("tag", tscheme.SKIP_TAGS[:8])
def test_plain_skip_matches_jax_scan(params, tag):
    check_skip(params, tag)
