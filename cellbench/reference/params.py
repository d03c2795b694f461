"""Physics parameter structs of the benchmark's reference, hydrated from
the input snapshot's global scalars by name, as the dwarf loads them.

A frozen copy (numpy only; it imports nothing of the program):
  TOMCST  basic constants        (ref: src/common/module/yomcst.F90:303-336)
  TOETHF  thermodynamic fit      (ref: src/common/module/yoethf.F90:105-158)
  TECLDP  cloud-scheme params    (ref: src/common/module/yoecldp.F90:241-369)
  TEPHLI  linearized physics     (ref: src/common/module/yoephli.F90:63-97)
"""

from __future__ import annotations

import numpy as np


def _native(v):
    if isinstance(v, (np.generic, np.ndarray)):
        v = v.item() if np.ndim(v) == 0 else tuple(float(x) for x in np.ravel(v))
    return v


class _ParamGroup:
    """Attribute-style access to a set of named scalars."""

    def __init__(self, entries: dict):
        for k, v in entries.items():
            setattr(self, k.lower(), _native(v))

    def __repr__(self):
        keys = sorted(self.__dict__)
        return f"{type(self).__name__}({', '.join(keys)})"


class TOMCST(_ParamGroup):
    """Basic physical constants (RG, RD, RCPD, RETV, RLVTT, RLSTT, RLMLT, RTT, RV)."""


class TOETHF(_ParamGroup):
    """Saturation-fit constants (R2ES..R5IES, RALVDCP/RALSDCP/RALFDCP, RKOOP1/2...)."""


class TECLDP(_ParamGroup):
    """Cloud scheme parameters (~110 scalars + RBETA/RBETAP1 tables)."""


class TEPHLI(_ParamGroup):
    """Linearized-physics parameters (LPHYLIN etc.; unused by the scheme itself)."""


_YOMCST_KEYS = ["RG", "RD", "RCPD", "RETV", "RLVTT", "RLSTT", "RLMLT", "RTT", "RV"]
_YOETHF_KEYS = [
    "R2ES", "R3LES", "R3IES", "R4LES", "R4IES", "R5LES", "R5IES",
    "R5ALVCP", "R5ALSCP", "RALVDCP", "RALSDCP", "RALFDCP",
    "RTWAT", "RTICE", "RTICECU", "RTWAT_RTICE_R", "RTWAT_RTICECU_R",
    "RKOOP1", "RKOOP2",
]


class Params:
    """Aggregate of all parameter groups consumed by the scheme."""

    def __init__(self, ydcst: TOMCST, ydthf: TOETHF, ydecldp: TECLDP,
                 ydephli: TEPHLI | None = None):
        self.ydcst = ydcst
        self.ydthf = ydthf
        self.ydecldp = ydecldp
        self.ydephli = ydephli

    @classmethod
    def from_scalars(cls, scalars: dict, rbeta=None, rbetap1=None) -> "Params":
        ydcst = TOMCST({k: scalars[k] for k in _YOMCST_KEYS})
        ydthf = TOETHF({k: scalars[k] for k in _YOETHF_KEYS if k in scalars})
        # RVTMP2 is not in the snapshot; the python reference sets it to 0
        # (ref: src/cloudsc_python/src/cloudscf2py/inputs.py:148).
        if not hasattr(ydthf, "rvtmp2"):
            ydthf.rvtmp2 = 0.0
        ydecldp = TECLDP({
            k[len("YRECLDP_"):]: v
            for k, v in scalars.items()
            if k.startswith("YRECLDP_")
        })
        # The RBETA tables live as fields in the archive, not globals
        # (ref: yoecldp.F90:358-366 loads YRECLDP_RBETA(0:100)).
        if rbeta is not None:
            ydecldp.rbeta = tuple(float(x) for x in np.ravel(rbeta))
        if rbetap1 is not None:
            ydecldp.rbetap1 = tuple(float(x) for x in np.ravel(rbetap1))
        ephli = {
            k[len("YREPHLI_"):]: v
            for k, v in scalars.items()
            if k.startswith("YREPHLI_")
        }
        ydephli = TEPHLI(ephli) if ephli else None
        return cls(ydcst, ydthf, ydecldp, ydephli)

    @classmethod
    def from_snapshot(cls, fields: dict, scalars: dict) -> "Params":
        """Hydrate from a snapshot's fields (the RBETA tables) and scalars."""
        return cls.from_scalars(scalars, rbeta=fields.get("YRECLDP_RBETA"),
                                rbetap1=fields.get("YRECLDP_RBETAP1"))
