"""The port's differentiable path on the CPU (`physics/autodiff.py` through
the eager engine), against the JAX package's `jax.grad` / `jax.jvp` on the
same inputs, and its own pins (tests/test_gradients.py's bars).

Inputs: the 100-column snapshot in fp64 and a tangent made from a numpy
seed. One JAX compile gives the `pt` gradient and the five parameter
gradients of the scalar head (every differentiable output head mixed), a
second the tangent; both are module-scope fixtures, as are the port's
gradient and tangent.

Tolerances, with what an x86 CPU run measured beside:
  * `pt` gradient, elementwise: max|d| <= 1e-9 * max|g|  (1.5e-14)
  * jvp: relative 1e-10  (1.0e-14)
  * parameter gradients: relative 1e-9, exact zeros where JAX has them
    (~1e-15; ramid and rtaumel are exact zeros in both)
  * jvp against a central finite difference, eps 1e-3: relative 1e-4
  * <grad, v> against jvp: relative 1e-12  (6e-15)
  * blocked against unblocked: the output fields bit for bit; the gradient
    within 1e-12 * max|g| (<= 2e-16: an inert lane's derivative through an
    active branch equals the identity's to an ulp, and blocks branch apart)
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudsc_tpu.physics import cloudsc as jcloudsc
from cloudsc_tpu.physics import make_inputs as jmake_inputs
from cloudsc_tpu_torch import data as tdata
from cloudsc_tpu_torch.kernels import cuda_cloudsc as cc
from cloudsc_tpu_torch.params import Params as TParams
from cloudsc_tpu_torch.physics import autodiff, scheme
from cloudsc_tpu_torch.physics.cloudsc import cloudsc, make_inputs
from cloudsc_tpu_torch.runtime.driver import CloudscDriver

torch.set_num_threads(1)

OUTPUTS = ("tendency_loc_t", "tendency_loc_q", "pcovptot", "pfplsl",
           "pfplsn", "pfhpsl", "pfsqlf", "plude")
TUNABLE = ("rcldiff", "ramid", "rkooptau", "rtaumel", "rcovpmin")


def scalar_head(out, cols):
    """tests/test_gradients.py's scalar, as a sum over columns."""
    return sum((getattr(out, n) ** 2).sum() for n in OUTPUTS) * 1e6


def tend_t_head(out, cols):
    return (out.tendency_loc_t ** 2).sum() * 1e6


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.fixture(scope="module")
def port():
    inp = tdata.load_input(tdata.default_input_path(), 100)
    return inp, TParams.from_input(inp), make_inputs(inp, torch.float64)


@pytest.fixture(scope="module")
def tangent(port):
    rng = np.random.default_rng(0)
    return rng.standard_normal(tuple(port[2]["pt"].shape)) * 0.01  # ~0.01 K


@pytest.fixture(scope="module")
def jax_head(input_100, params):
    fields = jmake_inputs(input_100, dtype=jnp.float64)

    def head(pt, thetas):
        f = dict(fields)
        f["pt"] = pt
        p = copy.copy(params)
        p.ydecldp = copy.copy(params.ydecldp)
        for i, name in enumerate(TUNABLE):
            setattr(p.ydecldp, name, thetas[i])
        out = jcloudsc(f, p, input_100.ptsphy)
        return sum(jnp.sum(getattr(out, n) ** 2) for n in OUTPUTS) * 1e6

    thetas = jnp.asarray([getattr(params.ydecldp, n) for n in TUNABLE],
                         jnp.float64)
    return head, fields["pt"], thetas


@pytest.fixture(scope="module")
def jax_grads(jax_head):
    head, pt, thetas = jax_head
    val, (g_pt, g_theta) = jax.jit(
        jax.value_and_grad(head, argnums=(0, 1)))(pt, thetas)
    return float(val), np.asarray(g_pt), np.asarray(g_theta)


@pytest.fixture(scope="module")
def port_grads(port):
    inp, params, fields = port
    val, grads = autodiff.value_and_grad(
        scalar_head, fields, params, inp.ptsphy, ("pt",) + TUNABLE,
        device="cpu")
    return val, grads


@pytest.fixture(scope="module")
def port_jvp(port, tangent):
    inp, params, fields = port
    return autodiff.jvp(scalar_head, fields, params, inp.ptsphy,
                        {"pt": torch.from_numpy(tangent)}, device="cpu")


# ---- against the JAX package ------------------------------------------------

def test_pt_gradient_matches_jax(jax_grads, port_grads):
    jval, g_jax, _ = jax_grads
    val, grads = port_grads
    g = grads["pt"].numpy()
    assert g.shape == g_jax.shape and g.dtype == np.float64
    assert rel(val, jval) < 1e-13
    assert np.abs(g - g_jax).max() <= 1e-9 * np.abs(g_jax).max()


@pytest.mark.parametrize("name", TUNABLE)
def test_parameter_gradient_matches_jax(jax_grads, port_grads, name):
    """All five TECLDP scalars of the calibration example differentiate;
    one that never reaches the head gives the exact zero JAX gives."""
    g_jax = float(jax_grads[2][TUNABLE.index(name)])
    g = port_grads[1][name]
    assert g.shape == () and np.isfinite(float(g))
    if g_jax == 0.0:
        assert float(g) == 0.0
    else:
        assert rel(g, g_jax) < 1e-9


def test_jvp_matches_jax(jax_head, port_jvp, port_grads, tangent):
    head, pt, thetas = jax_head
    jval, jv = jax.jit(lambda p, v: jax.jvp(lambda q: head(q, thetas),
                                            (p,), (v,)))(pt,
                                                         jnp.asarray(tangent))
    val, tv = port_jvp
    assert rel(val, jval) < 1e-13
    assert torch.equal(val, port_grads[0])
    assert rel(tv, jv) < 1e-10


# ---- the port's own pins (tests/test_gradients.py's bars) --------------------

def test_adjoint_finite_and_nonzero(port_grads):
    g = port_grads[1]["pt"]
    assert bool(torch.isfinite(g).all()), "NaN/inf in the adjoint"
    assert float(g.abs().max()) > 0.0, "identically-zero adjoint"


def test_tangent_matches_finite_difference(port, port_jvp, tangent):
    inp, params, fields = port
    eps, v = 1e-3, torch.from_numpy(tangent)

    def f(pt):
        return autodiff.value(scalar_head, {**fields, "pt": pt}, params,
                              inp.ptsphy, device="cpu")

    fd = (f(fields["pt"] + eps * v) - f(fields["pt"] - eps * v)) / (2 * eps)
    assert rel(fd, port_jvp[1]) < 1e-4


def test_adjoint_consistent_with_tangent(port_grads, port_jvp, tangent):
    vg = (port_grads[1]["pt"] * torch.from_numpy(tangent)).sum()
    assert rel(vg, port_jvp[1]) < 1e-12


def test_blocked_gradient_equals_unblocked(port, port_grads):
    """Three ragged blocks (37, 37, 26 columns): field gradients
    concatenate, 0-d parameter gradients add in block order."""
    inp, params, fields = port
    val, grads = autodiff.value_and_grad(
        scalar_head, fields, params, inp.ptsphy, ("pt", "rcldiff"),
        device="cpu", block_columns=37)
    want_val, want = port_grads
    assert rel(val, want_val) < 1e-14
    assert grads["pt"].shape == want["pt"].shape
    d = (grads["pt"] - want["pt"]).abs().max()
    assert float(d) <= 1e-12 * float(want["pt"].abs().max())
    assert rel(grads["rcldiff"], want["rcldiff"]) < 1e-12
    # the forward values alone are blocked bit for bit (blocks of 64 and 36
    # columns: a multiple of the host's vector width, whose last partial
    # vector of a row goes through other transcendental code)
    def field(out, cols):
        return out.tendency_loc_t

    a = autodiff.value(field, fields, params, inp.ptsphy, device="cpu")
    b = autodiff.value(field, fields, params, inp.ptsphy, device="cpu",
                       block_columns=64)
    assert a.shape == (137, 100) and torch.equal(a, b)


@pytest.mark.parametrize("name", ["rcldiff", "rkooptau"])
def test_parameter_gradient_matches_fd(port, name):
    inp, params, fields = port
    theta0 = getattr(params.ydecldp, name)

    def loss(theta):
        return float(autodiff.value(
            tend_t_head, fields, autodiff.with_params(params, {name: theta}),
            inp.ptsphy, device="cpu"))

    g = float(autodiff.grad(tend_t_head, fields, params, inp.ptsphy, (name,),
                            device="cpu")[name])
    eps = theta0 * 1e-6
    fd = (loss(theta0 + eps) - loss(theta0 - eps)) / (2 * eps)
    assert np.isfinite(g) and g != 0.0, f"degenerate d/d{name}: {g}"
    assert rel(g, fd) < 1e-5


def test_parameter_jvp_is_its_gradient(port):
    """Forward mode with respect to a parameter: the tangent along 1 is
    d/dtheta, the reverse-mode value."""
    inp, params, fields = port
    g = autodiff.grad(tend_t_head, fields, params, inp.ptsphy, ("rcldiff",),
                      device="cpu")["rcldiff"]
    _, t = autodiff.jvp(tend_t_head, fields, params, inp.ptsphy,
                        {"rcldiff": torch.tensor(1.0, dtype=torch.float64)},
                        device="cpu")
    assert rel(t, g) < 1e-12


def test_vjp_of_an_output_head(port):
    """A head with columns last and its cotangent, in two blocks: the
    gradient of sum(cotangent * head)."""
    inp, params, fields = port
    rng = np.random.default_rng(1)
    cot = torch.from_numpy(rng.standard_normal((137, 100)))

    val, g = autodiff.vjp(lambda out, cols: out.tendency_loc_t, fields,
                          params, inp.ptsphy, ("pq",), cot, device="cpu",
                          block_columns=50)
    want = autodiff.grad(
        lambda out, cols: (out.tendency_loc_t * cot[:, cols]).sum(), fields,
        params, inp.ptsphy, ("pq",), device="cpu")["pq"]
    assert val.shape == (137, 100) and g["pq"].shape == (137, 100)
    assert float((g["pq"] - want).abs().max()) \
        <= 1e-12 * float(want.abs().max())
    assert float(want.abs().max()) > 0.0


# ---- parameters as tensors: forward values unchanged -------------------------

def test_tensor_parameters_leave_forward_values_bitwise(port):
    """The engine with the five parameters and the step as 0-d tensors
    gives bit for bit the outputs it gives with Python floats."""
    inp, params, fields = port
    with torch.no_grad():
        want = cloudsc(fields, params, inp.ptsphy)
        as_t = {n: torch.tensor(getattr(params.ydecldp, n),
                                dtype=torch.float64) for n in TUNABLE}
        got = cloudsc(fields, autodiff.with_params(params, as_t),
                      torch.tensor(inp.ptsphy, dtype=torch.float64))
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_scalar_helpers_take_tensors_and_keep_floats():
    like = torch.tensor([1.5, 2.5, 3.5], dtype=torch.float64)
    s = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    mask = torch.tensor([True, False, True])
    assert torch.equal(scheme.rdiv(0.3, like), scheme.rdiv(s, like).detach())
    assert torch.equal(scheme.div(like, 0.3), scheme.div(like, s).detach())
    assert torch.equal(scheme.sel2(mask, 0.3, 0.7, like),
                       scheme.sel2(mask, s, 0.7, like).detach())
    assert scheme.sdiv(3600.0, 0.3) == 3600.0 / 0.3
    assert float(scheme.sdiv(3600.0, s).detach()) == 3600.0 / 0.3
    assert scheme.sel2(mask, s, 0.7, like).requires_grad
    assert scheme.rdiv(s, like).requires_grad
    assert scheme.div(like, s).requires_grad


def test_column_parameter_equals_single_runs(port):
    """Members stacked along the column axis with the parameter one value a
    column: each member's outputs equal its single run bit for bit (32
    columns a member: a multiple of the host's vector width, see above)."""
    from cloudsc_tpu_torch.examples.param_calibration import stacked_ensemble

    inp, params, fields = port
    small = {k: v[..., :32].contiguous() for k, v in fields.items()}
    thetas = params.ydecldp.rcldiff * np.array([0.5, 1.0, 3.0])
    wide, wparams = stacked_ensemble(small, params, "rcldiff", thetas)
    assert wide["pt"].shape == (137, 96)
    with torch.no_grad():
        got = cloudsc(wide, wparams, inp.ptsphy)
        for i, theta in enumerate(thetas):
            want = cloudsc(small, autodiff.with_params(
                params, {"rcldiff": float(theta)}), inp.ptsphy)
            for name in want._fields:
                a = getattr(got, name)[..., 32 * i:32 * (i + 1)]
                assert torch.equal(a, getattr(want, name)), (i, name)
    assert not torch.equal(got.tendency_loc_t[:, :32],
                           got.tendency_loc_t[:, 64:])


@pytest.mark.parametrize("ncol", [16, 100, 250])
def test_fields_expanded_on_device_equal_host_expansion(ncol):
    from cloudsc_tpu_torch.physics.cloudsc import fields_on_device

    inp = tdata.load_input(tdata.default_input_path(), ncol)
    got = fields_on_device(inp, torch.float64, "cpu")
    want = make_inputs(inp, torch.float64)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


# ---- refusals ----------------------------------------------------------------

def test_fused_kernel_refuses_a_gradient(port):
    """The kernel wrapper and the kernel backends raise, naming the scan
    engine, when an input requires grad; with autograd off they run."""
    inp, params, _ = port
    drv = CloudscDriver(params, inp.ptsphy, dtype=torch.float64, device="cpu")
    small = tdata.load_input(tdata.default_input_path(), 8)
    p = drv.prepare(small)
    p.pack.requires_grad_(True)
    with pytest.raises(RuntimeError, match="--kernel scan"):
        cc.cloudsc_fused(p, drv.step.c)
    with torch.no_grad():
        assert cc.cloudsc_fused(p, drv.step.c)[0].shape[-1] == 8
    theta = torch.tensor(params.ydecldp.rcldiff, dtype=torch.float64,
                         requires_grad=True)
    with pytest.raises(RuntimeError, match="--kernel scan"):
        CloudscDriver(autodiff.with_params(params, {"rcldiff": theta}),
                      inp.ptsphy, dtype=torch.float64, device="cpu")
    CloudscDriver(autodiff.with_params(params, {"rcldiff": theta}),
                  inp.ptsphy, dtype=torch.float64, device="cpu",
                  backend="scan")


def test_autodiff_names_and_devices(port):
    inp, params, fields = port
    with pytest.raises(KeyError, match="neither a field nor a TECLDP"):
        autodiff.grad(scalar_head, fields, params, inp.ptsphy, ("nosuch",),
                      device="cpu")
    with pytest.raises(ValueError, match="not a float field"):
        autodiff.grad(scalar_head, fields, params, inp.ptsphy, ("ktype",),
                      device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            autodiff.grad(scalar_head, fields, params, inp.ptsphy, ("pt",))
