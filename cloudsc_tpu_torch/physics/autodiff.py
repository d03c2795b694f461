"""Derivatives of the CLOUDSC step: adjoint (reverse mode) and
tangent-linear (forward mode) through the eager engine.

What `jax.grad`, `jax.value_and_grad`, `jax.vjp` and `jax.jvp` are to the
JAX package: `grad`, `value_and_grad`, `vjp` and `jvp` of a head of
`physics.cloudsc.cloudsc` with respect to named inputs. A name is a key of
the field dict (`"pt"`, any float field of `make_inputs`) or a TECLDP scalar
of `params.ydecldp` (`"rcldiff"`, `"rkooptau"`, ...), whose value, a float or
a 0-d / `(ncol,)` tensor, is the point of differentiation. The fused CUDA
kernel has no derivative (it refuses an input that requires grad); these run
the engine, on `device` ("cuda" raises without a card; only an explicit
"cpu" runs on the host).

**The head.** `head(out, cols)` maps a block's `CloudscOutputs` to one
tensor; `cols` is the slice of global column indices the block holds, for a
head that reads its own full-width data (observations). A 0-d result must be
a sum over columns (a mean divides by the global count itself): blocks add,
in column order. Any other result has the columns on its last axis: blocks
concatenate.

**The memory plan: column blocks.** Reverse mode keeps every intermediate
of the step, 0.42 MiB a column in fp64 (measured), ~67 GiB at 163,840
columns beside 6.4 GiB of fields: more than one 80 GB card holds. Columns
are independent, so the step is differentiated `block_columns` columns at a
time: each block's inputs are cut (and moved to `device`), its graph is
built, walked back and freed; field gradients (and those of `(ncol,)`
parameters) concatenate, gradients of 0-d parameters add in block order. A
parameter that never reaches the head gives an exact zero. A block costs the
same seconds whatever its width (the host's launch rate sets the pace of
both passes, `bench/grad_blocks.py --profile`), so the fewest blocks that
fit are the fastest: `DEFAULT_BLOCK_COLUMNS` is the measured choice for one
80 GB card (`bench/grad_blocks.py`). `value` and `jvp` keep no graph and
run every column in one block unless told otherwise. The skips inside the
scheme (`scheme.inert_skip`) are value-exact, so blocked output fields equal
the unblocked ones bit for bit on the card (on the host a row's last
partial vector rounds its transcendentals otherwise, so only widths that
are multiples of the vector width compare bit for bit); a blocked
derivative equals the unblocked one to rounding (an inert lane's derivative
through the active branch is the identity's only to an ulp), and bit for
bit where every block takes the same branches, as blocks that each hold
every snapshot column do.

**Forward mode** uses `torch.autograd.forward_ad` dual tensors, not
`torch.func.jvp`: the engine branches in Python on `mask.any()`, which a
functional transform only tolerates, and the dual level adds no wrapper
around each of the step's tens of thousands of operations. It keeps no
graph. It costs ~10 forward passes on the card, all of it the host's:
each operation's tangent rule is dispatched from Python-visible autograd
code.
"""

from __future__ import annotations

import copy

import torch
import torch.autograd.forward_ad as fwad

from .cloudsc import cloudsc

# columns a block; see bench/grad_blocks.py for the measurement behind it
DEFAULT_BLOCK_COLUMNS = 81920


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; "cuda" without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; the derivatives run on the host only with device='cpu'")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def with_params(params, values: dict):
    """A copy of `params` with the TECLDP scalars of `values` replaced
    (floats or tensors); `params` itself is left as it is."""
    p = copy.copy(params)
    p.ydecldp = copy.copy(params.ydecldp)
    for name, value in values.items():
        if not hasattr(p.ydecldp, name):
            raise KeyError(f"{name!r} is neither a field nor a TECLDP scalar")
        setattr(p.ydecldp, name, value)
    return p


def _ncol(fields) -> int:
    return next(iter(fields.values())).shape[-1]


def _blocks(ncol: int, block_columns):
    """(lo, hi) of each block; one block of every column if None."""
    step = max(int(block_columns or ncol), 1)
    return [(lo, min(lo + step, ncol)) for lo in range(0, ncol, step)]


def _cut(t: torch.Tensor, lo: int, hi: int, device, whole: bool):
    """Columns lo:hi of a tensor whose last axis is the columns, contiguous
    on `device`; a 0-d tensor is moved whole."""
    if t.ndim and not whole:
        t = t[..., lo:hi].contiguous()
    return t.to(device)


class _Block:
    """One column block's inputs on the device: the field dict, the
    parameters and the step, with every tensor among them cut to the
    block's columns, and the named inputs (`names`) as fresh leaves."""

    def __init__(self, fields, params, ptsphy, names, lo, hi, device):
        whole = lo == 0 and hi == _ncol(fields)
        self.cols = slice(lo, hi)
        self.fields = {k: _cut(v, lo, hi, device, whole)
                       for k, v in fields.items()}
        dtype = next(v.dtype for v in self.fields.values()
                     if v.is_floating_point())
        self.ptsphy = _cut(ptsphy, lo, hi, device, whole) \
            if torch.is_tensor(ptsphy) else ptsphy
        cut = {name: _cut(v, lo, hi, device, whole)
               for name, v in vars(params.ydecldp).items()
               if torch.is_tensor(v)}
        self.leaves = {}
        for name in names:
            if name in self.fields:
                if not self.fields[name].is_floating_point():
                    raise ValueError(f"field {name!r} is not a float field")
                # a tensor of its own: the caller's is never marked
                self.leaves[name] = self.fields[name].detach().clone()
            else:
                if not hasattr(params.ydecldp, name):
                    raise KeyError(f"{name!r} is neither a field nor a "
                                   f"TECLDP scalar")
                v = cut[name] if name in cut else torch.tensor(
                    float(getattr(params.ydecldp, name)), dtype=dtype,
                    device=device)
                self.leaves[name] = v.detach().clone()
        self._cut_params = cut
        self._params = params

    def run(self, inputs: dict, config):
        """The step with `inputs` (name -> tensor) in place of the named
        fields and parameters."""
        f = dict(self.fields)
        e = dict(self._cut_params)
        for name, t in inputs.items():
            (f if name in self.fields else e)[name] = t
        return cloudsc(f, with_params(self._params, e), self.ptsphy, config)


def _join(parts: list, stacked: bool):
    """Blocks of one result: concatenated on the column axis, or (0-d parts)
    added in block order."""
    if len(parts) == 1:
        return parts[0]
    if stacked:
        return torch.cat(parts, dim=-1)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def value(head, fields, params, ptsphy, *, config=None, device="cuda",
          block_columns=None):
    """`head` of the step, block by block, with no derivative kept."""
    device = resolve_device(device)
    vals = []
    with torch.no_grad():
        for lo, hi in _blocks(_ncol(fields), block_columns):
            b = _Block(fields, params, ptsphy, (), lo, hi, device)
            vals.append(head(b.run({}, config), b.cols))
    return _join(vals, vals[0].ndim > 0)


def vjp(head, fields, params, ptsphy, wrt, cotangent=None, *, config=None,
        device="cuda", block_columns=None):
    """(head's value, {name: gradient}) for the names of `wrt`: the
    vector-Jacobian product of `head` with `cotangent` (the head's shape,
    columns last; for a 0-d head None means 1). A field's gradient has the
    field's shape; a parameter's has its value's (0-d for a float)."""
    device = resolve_device(device)
    wrt = tuple(wrt)
    vals, grads = [], {name: [] for name in wrt}
    for lo, hi in _blocks(_ncol(fields),
                          block_columns or DEFAULT_BLOCK_COLUMNS):
        b = _Block(fields, params, ptsphy, wrt, lo, hi, device)
        val, gs = _vjp_block(head, b, cotangent, config)
        vals.append(val)
        for name, g in zip(wrt, gs):
            grads[name].append(g)
    return (_join(vals, vals[0].ndim > 0),
            {name: _join(g, g[0].ndim > 0) for name, g in grads.items()})


def _vjp_block(head, b: _Block, cotangent, config):
    leaves = [t.requires_grad_(True) for t in b.leaves.values()]
    with torch.enable_grad():
        val = head(b.run(b.leaves, config), b.cols)
        if val.ndim == 0:
            seed = val if cotangent is None else val * cotangent.to(val.device)
        else:
            if cotangent is None:
                raise ValueError("a head that is not 0-d needs a cotangent")
            seed = (val * cotangent[..., b.cols].to(val.device)).sum()
        # a head no named input reaches has no graph: exact zeros
        gs = torch.autograd.grad(seed, leaves, allow_unused=True) \
            if seed.requires_grad else [None] * len(leaves)
    return val.detach(), [torch.zeros_like(t) if g is None else g
                          for t, g in zip(leaves, gs)]


def value_and_grad(head, fields, params, ptsphy, wrt, **kw):
    """(value, {name: gradient}) of a 0-d `head`."""
    val, grads = vjp(head, fields, params, ptsphy, wrt, None, **kw)
    if val.ndim:
        raise ValueError("value_and_grad needs a 0-d head; use vjp")
    return val, grads


def grad(head, fields, params, ptsphy, wrt, **kw):
    """{name: gradient} of a 0-d `head`."""
    return value_and_grad(head, fields, params, ptsphy, wrt, **kw)[1]


def jvp(head, fields, params, ptsphy, tangents: dict, *, config=None,
        device="cuda", block_columns=None):
    """(head's value, its directional derivative) along `tangents`
    (name -> a tensor of the named input's shape), in forward mode."""
    device = resolve_device(device)
    names = tuple(tangents)
    vals, tans = [], []
    for lo, hi in _blocks(_ncol(fields), block_columns):
        b = _Block(fields, params, ptsphy, names, lo, hi, device)
        whole = hi - lo == _ncol(fields)
        with torch.no_grad(), fwad.dual_level():
            duals = {
                name: fwad.make_dual(b.leaves[name], _cut(
                    torch.as_tensor(tangents[name], dtype=b.leaves[name].dtype),
                    lo, hi, device, whole).expand_as(b.leaves[name]))
                for name in names}
            val, tan = fwad.unpack_dual(head(b.run(duals, config), b.cols))
            vals.append(val)
            tans.append(torch.zeros_like(val) if tan is None else tan)
    stacked = vals[0].ndim > 0
    return _join(vals, stacked), _join(tans, stacked)
