"""One CLOUDSC step of the benchmark's reference over a raw field dict.

A frozen copy of the port's eager engine on its plain (unfolded) field
dict: section 1 over every level at once (`scheme.level_init`), a Python
loop over the levels from NCLDTOP down calling `scheme.level_step` on
per-level views, then the full-level assembly and the section-8 flux
diagnostics (ref: src/cloudsc_fortran/cloudsc.F90 of dwarf-p-cloudsc,
654-2867). It forms every sum the port may fold (x + PTSPHY*tend,
PMFU + PMFD, PHRSW + PHRLW, the flux running sums) itself, from the raw
fields, at the fields' dtype. It imports nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import scheme
from .scheme import IL, II, IR, IS, NCLV


class Outputs(NamedTuple):
    """The 21 outputs in the dwarf's validation order of names (columns on
    the trailing axis)."""

    plude: torch.Tensor              # (nlev, ncol)
    pcovptot: torch.Tensor           # (nlev, ncol)
    prainfrac_toprfz: torch.Tensor   # (ncol,)
    pfsqlf: torch.Tensor             # (nlev+1, ncol)
    pfsqif: torch.Tensor
    pfcqlng: torch.Tensor
    pfcqnng: torch.Tensor
    pfsqrf: torch.Tensor
    pfsqsf: torch.Tensor
    pfcqrng: torch.Tensor
    pfcqsng: torch.Tensor
    pfsqltur: torch.Tensor
    pfsqitur: torch.Tensor
    pfplsl: torch.Tensor
    pfplsn: torch.Tensor
    pfhpsl: torch.Tensor
    pfhpsn: torch.Tensor
    tendency_loc_t: torch.Tensor     # (nlev, ncol)
    tendency_loc_q: torch.Tensor
    tendency_loc_a: torch.Tensor
    tendency_loc_cld: torch.Tensor   # (nclv, nlev, ncol), vapour slot zero


# the raw per-level fields of the dict, and the ones the scheme reads
# (PVFA and the PDYN* fields are loaded by the dwarf and never read)
LEVEL_FIELDS = (
    "pt", "pq", "tendency_tmp_t", "tendency_tmp_q", "tendency_tmp_a",
    "tendency_tmp_cld", "pvfa", "pvfl", "pvfi", "pdyna", "pdynl", "pdyni",
    "phrsw", "phrlw", "pvervel", "pap", "paph", "plu", "plude", "psnde",
    "pmfu", "pmfd", "pa", "pclv", "psupsat",
)
AEROSOL_FIELDS = ("plcrit_aer", "picrit_aer", "pre_ice", "pccn", "pnice")
COLUMN_FIELDS = ("plsm", "ldcum", "ktype")


def _aer_read(c) -> list:
    """The aerosol fields the configuration's couplings read."""
    return [n for n, on in (("pre_ice", c.LAERICESED),
                            ("picrit_aer", c.LAERICEAUTO),
                            ("pnice", c.LAERICEAUTO),
                            ("plcrit_aer", c.LAERLIQAUTOLSP or c.LAERLIQCOLL),
                            ("pccn", c.LAERLIQAUTOLSP or c.LAERLIQCOLL))
            if on]


def cloudsc(fields: dict, params, ptsphy, config=None) -> Outputs:
    """One step over every column of a raw field dict, on the fields'
    device and in their dtype. `config` is a `scheme.SchemeConfig` (the
    reference configuration if None)."""
    pt = fields["pt"]
    c = scheme.derived_consts(params, ptsphy, pt.dtype, config)
    raw = dict(
        pt=pt, pq=fields["pq"], pa=fields["pa"], pap=fields["pap"],
        tendency_tmp_t=fields["tendency_tmp_t"],
        tendency_tmp_q=fields["tendency_tmp_q"],
        tendency_tmp_a=fields["tendency_tmp_a"],
        pclv=[fields["pclv"][m] for m in range(4)],
        tendency_tmp_cld=[fields["tendency_tmp_cld"][m] for m in range(4)],
    )
    ini = scheme.level_init(raw, c)
    rows = {n: ini[n] for n in (
        "ztp1", "za", "zaorig", "zqsmix", "zqsliq", "zqsice", "zfoeew",
        "zfoeewmt", "zfoeeliqt", "zfoealfa", "zli", "zliqfrac", "zicefrac",
        "zfoeeliq", "zfoeeice", "zfokoop", "tend_t_pre", "tend_q_pre")}
    rows.update(
        pap=fields["pap"], paph=fields["paph"],
        pmf=fields["pmfu"] + fields["pmfd"],
        zhr=fields["phrsw"] + fields["phrlw"],
        pvervel=fields["pvervel"], plude_in=fields["plude"],
        plu=fields["plu"], psnde=fields["psnde"], psupsat=fields["psupsat"])
    for n in _aer_read(c):
        rows[n] = fields[n]

    nlev, ncol = rows["ztp1"].shape
    dev = rows["ztp1"].device
    zqx0, zlneg, zfoealfa = ini["zqx0"], ini["zlneg"], ini["zfoealfa"]
    tend_t_pre, tend_q_pre = ini["tend_t_pre"], ini["tend_q_pre"]
    plude_in, paph = fields["plude"], fields["paph"]
    land, ldcum, ktype = fields["plsm"] > 0.5, fields["ldcum"], \
        fields["ktype"]
    pvfl, pvfi = fields["pvfl"], fields["pvfi"]
    paph_surf = paph[nlev]
    ktop = c.NCLDTOP - 1           # 0-based first level of the loop
    zqtmst = c.zqtmst
    flag = {b: torch.tensor(b, device=dev) for b in (False, True)}

    def clamp(k, n):
        return min(max(k, 0), n - 1)

    def make_x(k):
        """Level k's view: rows at k, and at k-1 / k+1 where the scheme
        reads them, the index clamped to the array (every such read is
        masked by not_first / not_last)."""
        def row(name, off=0):
            a = rows[name]
            return a[clamp(k + off, a.shape[0])]

        x = {name: row(name) for name in rows}
        x.update(
            ztp1_prev=row("ztp1", -1), za_prev=row("za", -1),
            pap_prev=row("pap", -1), paph_next=row("paph", 1),
            pmf_next=row("pmf", 1), plu_next=row("plu", 1),
            zqx=[ini["zqx"][m][k] for m in range(NCLV)],
            paph_surf=paph_surf, land=land, ldcum=ldcum, ktype=ktype,
            not_first=flag[k > ktop], not_last=flag[k < nlev - 1])
        return x

    # 3-6. the level loop (ref: 854-2775)
    zero_row = paph.new_zeros((ncol,))
    ys_rows = {n: [] for n in ("plude", "pcovptot", "tend_t", "tend_q",
                               "tend_a")}
    zqxn_rows = [[] for _ in range(NCLV)]
    pfplsx_rows = [[] for _ in range(NCLV)]
    carry = scheme.initial_carry(zero_row, c)
    for k in range(ktop, nlev):
        carry, ys = scheme.level_step(make_x(k), carry, c)
        for n, acc in ys_rows.items():
            acc.append(ys[n])
        for m in range(NCLV):
            zqxn_rows[m].append(ys["zqxn"][m])
            pfplsx_rows[m].append(ys["pfplsx_next"][m])

    def levels(acc, above):
        if isinstance(above, int):
            above = zero_row.expand(above, ncol)
        return torch.cat([above, torch.stack(acc)])

    zqxn = [levels(zqxn_rows[m], ktop) for m in range(NCLV)]
    # half level k+1 receives level k's flux (ref: 687, 2698-2702)
    zpfplsx = [levels(pfplsx_rows[m], ktop + 1) for m in range(NCLV)]
    plude = levels(ys_rows["plude"], plude_in[:ktop])
    pcovptot = levels(ys_rows["pcovptot"], ktop)
    tend_t = levels(ys_rows["tend_t"], tend_t_pre[:ktop])
    tend_q = levels(ys_rows["tend_q"], tend_q_pre[:ktop])
    tend_a = levels(ys_rows["tend_a"], ktop)
    tend_cld = torch.stack(
        [torch.cat([zero_row.expand(ktop, ncol),
                    (zqxn[m][ktop:] - zqx0[m][ktop:]) * zqtmst])
         for m in (IL, II, IR, IS)] + [zero_row.expand(nlev, ncol)])

    # 8. flux diagnostics (ref: 2788-2867), the running sums in level order
    pfplsl = zpfplsx[IR] + zpfplsx[IL]
    pfplsn = zpfplsx[IS] + zpfplsx[II]
    zgdph_r = -c.zrg_r * (paph[1:] - paph[:-1]) * zqtmst
    liq_inc = (zqxn[IL] - zqx0[IL] + pvfl * ptsphy - zfoealfa * plude) \
        * zgdph_r
    ice_inc = (zqxn[II] - zqx0[II] + pvfi * ptsphy
               - (1.0 - zfoealfa) * plude) * zgdph_r
    rain_inc = (zqxn[IR] - zqx0[IR]) * zgdph_r
    snow_inc = (zqxn[IS] - zqx0[IS]) * zgdph_r
    top_row = zero_row[None]

    def half_cumsum(inc):
        """PF(jk+1) = sum_{j<=jk} inc(j); PF(0) = 0 (ref: 2798-2857)."""
        return torch.cat([top_row, torch.cumsum(inc, dim=0)])

    def after(prev, inc):
        """Rain/snow accumulate onto the liquid/ice flux of the level above
        (ref: 2818-2819)."""
        return torch.cat([top_row, prev[:-1] + inc])

    pfsqlf = half_cumsum(liq_inc)
    pfsqif = half_cumsum(ice_inc)
    pfcqlng = half_cumsum(zlneg[IL] * zgdph_r)
    pfcqnng = half_cumsum(zlneg[II] * zgdph_r)
    return Outputs(
        plude=plude, pcovptot=pcovptot,
        prainfrac_toprfz=carry["prainfrac"],
        pfsqlf=pfsqlf, pfsqif=pfsqif, pfcqlng=pfcqlng, pfcqnng=pfcqnng,
        pfsqrf=after(pfsqlf, rain_inc), pfsqsf=after(pfsqif, snow_inc),
        pfcqrng=after(pfcqlng, zlneg[IR] * zgdph_r),
        pfcqsng=after(pfcqnng, zlneg[IS] * zgdph_r),
        pfsqltur=half_cumsum(pvfl * ptsphy * zgdph_r),
        pfsqitur=half_cumsum(pvfi * ptsphy * zgdph_r),
        pfplsl=pfplsl, pfplsn=pfplsn,
        pfhpsl=-c.RLVTT * pfplsl, pfhpsn=-c.RLSTT * pfplsn,
        tendency_loc_t=tend_t, tendency_loc_q=tend_q, tendency_loc_a=tend_a,
        tendency_loc_cld=tend_cld,
    )
