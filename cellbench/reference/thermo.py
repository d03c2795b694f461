"""Saturation and thermodynamic functions of the benchmark's reference, as
torch expressions: the cy39 ECMWF physics functions (ref:
src/common/include/fcttre.func.h, fccld.func.h of dwarf-p-cloudsc) on
tensors of the working dtype, with the parameters as Python scalars. A
frozen copy; it imports nothing of the program.
"""

from __future__ import annotations

import torch


def foedelta(t, cst):
    """1 for water (T>=RTT), 0 for ice (ref: fcttre.func.h:41)."""
    return torch.where(t >= cst.rtt, 1.0, 0.0).to(t.dtype)


def foealfa(t, thf):
    """Mixed-phase liquid fraction in [0,1] (ref: fcttre.func.h:83-84)."""
    x = (torch.clamp(torch.clamp(t, max=thf.rtwat), min=thf.rtice)
         - thf.rtice) * thf.rtwat_rtice_r
    return torch.clamp(x * x, max=1.0)


def foeeliq(t, cst, thf):
    """Saturation vapour pressure wrt liquid (ref: fcttre.func.h:163)."""
    return thf.r2es * torch.exp(thf.r3les * (t - cst.rtt) / (t - thf.r4les))


def foeeice(t, cst, thf):
    """Saturation vapour pressure wrt ice (ref: fcttre.func.h:164)."""
    return thf.r2es * torch.exp(thf.r3ies * (t - cst.rtt) / (t - thf.r4ies))


def foeewm_a(t, alfa, cst, thf):
    """Mixed-phase saturation vapour pressure with the liquid fraction
    precomputed (ref: fcttre.func.h:90-92)."""
    return thf.r2es * (
        alfa * torch.exp(thf.r3les * (t - cst.rtt) / (t - thf.r4les))
        + (1.0 - alfa) * torch.exp(thf.r3ies * (t - cst.rtt) / (t - thf.r4ies))
    )


def foedem_a(t, alfa, thf):
    """d(qsat)/dT factor, mixed phase (ref: fcttre.func.h:100-101)."""
    return alfa * thf.r5alvcp * (1.0 / (t - thf.r4les) ** 2) + (
        1.0 - alfa
    ) * thf.r5alscp * (1.0 / (t - thf.r4ies) ** 2)


def foeldcpm_a(alfa, thf):
    """L/cp, mixed phase (ref: fcttre.func.h:103-104)."""
    return alfa * thf.ralvdcp + (1.0 - alfa) * thf.ralsdcp
