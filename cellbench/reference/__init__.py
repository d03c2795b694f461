"""The benchmark's plain reference: CLOUDSC in plain PyTorch, frozen.

`scheme`, `thermo` and `engine` are a copy of the scheme, its constants
and the step over a raw field dict; `params` loads the parameters from the
snapshot's scalars by name. The package imports nothing of the program,
nor JAX; its tensors run wherever they lie, one torch operation at a time,
with TF32 off (it has no matrix product). `step` runs it over a whole
field dict, optionally in another precision (the lower-precision control).
"""

from __future__ import annotations

import torch

from .engine import Outputs, cloudsc
from .params import Params
from .scheme import SchemeConfig

__all__ = ["Outputs", "Params", "SchemeConfig", "cloudsc", "step"]


def step(fields: dict, params, ptsphy: float, config, dtype=None,
         store=None) -> Outputs:
    """One step over every column of `fields`. With `dtype` the float
    fields are cast to it first; with `store` every output is rounded
    through that dtype (an output stored in lower precision). Either is
    the lower-precision control."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dtype is not None:
        fields = {k: v.to(dtype) if v.is_floating_point() else v
                  for k, v in fields.items()}
    with torch.no_grad():
        out = cloudsc(fields, params, ptsphy, config)
    if store is not None:
        out = Outputs(*(o.to(store).to(o.dtype) for o in out))
    return out
