"""The CLOUDSC output contract and the eager scan engine on torch tensors.

Counterpart of `cloudsc_tpu/physics/cloudsc.py`: `CloudscOutputs` (the same
21 fields in the same order and shapes, columns on the trailing axis),
`make_inputs` (an `InputData` -> the field dict, plain or folded, on host
tensors), `scan_pack` (the field dict's level-loop rows stacked once into
three buffers, the JAX module's pre-packed closure) and `cloudsc` (one
step over every column of a field dict or of `scan_pack`'s). The engine is
the JAX module's without its XLA schedule choices (the in-step packed
closure, the scan unroll): section 1 (`scheme.level_init`) over all levels
at once, a Python loop over the levels from NCLDTOP down calling
`scheme.level_step` on per-level views, then the full-level assembly and
the section-8 cumulative fluxes. It runs on whatever device its tensors are
on, one torch operation at a time, and is the port's `--kernel scan`: the
fp64 golden surface and the engine for what the fused kernel does not take.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import satfold, scheme
from .scheme import IL, II, IR, IS, NCLV


class CloudscOutputs(NamedTuple):
    plude: torch.Tensor              # (nlev, ncol)   scaled detrainment (inout)
    pcovptot: torch.Tensor           # (nlev, ncol)   precip fraction
    prainfrac_toprfz: torch.Tensor   # (ncol,)        rain frac at top of refreeze layer
    pfsqlf: torch.Tensor             # (nlev+1, ncol) flux of liquid
    pfsqif: torch.Tensor             # (nlev+1, ncol) flux of ice
    pfcqlng: torch.Tensor            # (nlev+1, ncol) -ve correction, liquid
    pfcqnng: torch.Tensor            # (nlev+1, ncol) -ve correction, ice
    pfsqrf: torch.Tensor             # (nlev+1, ncol) flux of rain
    pfsqsf: torch.Tensor             # (nlev+1, ncol) flux of snow
    pfcqrng: torch.Tensor            # (nlev+1, ncol) -ve correction, rain
    pfcqsng: torch.Tensor            # (nlev+1, ncol) -ve correction, snow
    pfsqltur: torch.Tensor           # (nlev+1, ncol) VDF liquid flux
    pfsqitur: torch.Tensor           # (nlev+1, ncol) VDF ice flux
    pfplsl: torch.Tensor             # (nlev+1, ncol) liq+rain sedimentation flux
    pfplsn: torch.Tensor             # (nlev+1, ncol) ice+snow sedimentation flux
    pfhpsl: torch.Tensor             # (nlev+1, ncol) enthalpy flux, liquid
    pfhpsn: torch.Tensor             # (nlev+1, ncol) enthalpy flux, ice
    tendency_loc_t: torch.Tensor     # (nlev, ncol)
    tendency_loc_q: torch.Tensor     # (nlev, ncol)
    tendency_loc_a: torch.Tensor     # (nlev, ncol)
    tendency_loc_cld: torch.Tensor   # (nclv, nlev, ncol) — vapour slot zero


_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}

# per-level fields of the plain dict: key -> snapshot name
_PLAIN = (
    ("pt", "PT"), ("pq", "PQ"),
    ("tendency_tmp_t", "TENDENCY_TMP_T"), ("tendency_tmp_q", "TENDENCY_TMP_Q"),
    ("tendency_tmp_a", "TENDENCY_TMP_A"),
    ("tendency_tmp_cld", "TENDENCY_TMP_CLD"),
    ("pvfa", "PVFA"), ("pvfl", "PVFL"), ("pvfi", "PVFI"),
    ("pdyna", "PDYNA"), ("pdynl", "PDYNL"), ("pdyni", "PDYNI"),
    ("phrsw", "PHRSW"), ("phrlw", "PHRLW"),
    ("pvervel", "PVERVEL"), ("pap", "PAP"), ("paph", "PAPH"),
    ("plsm", "PLSM"),
    ("plu", "PLU"), ("plude", "PLUDE"), ("psnde", "PSNDE"),
    ("pmfu", "PMFU"), ("pmfd", "PMFD"),
    ("pa", "PA"), ("pclv", "PCLV"), ("psupsat", "PSUPSAT"),
)
# what the folded dict keeps of the snapshot as it is
_FOLDED_REST = (
    ("pvfl", "PVFL"), ("pvfi", "PVFI"),
    ("pvervel", "PVERVEL"), ("pap", "PAP"), ("paph", "PAPH"),
    ("plsm", "PLSM"),
    ("plu", "PLU"), ("plude", "PLUDE"), ("psnde", "PSNDE"),
    ("psupsat", "PSUPSAT"),
)
_AEROSOL = (
    ("plcrit_aer", "PLCRIT_AER"), ("picrit_aer", "PICRIT_AER"),
    ("pre_ice", "PRE_ICE"), ("pccn", "PCCN"), ("pnice", "PNICE"),
)


def make_inputs(inp, dtype=torch.float64, column_order: str = "cyclic",
                column_perm=None, fold: bool = False,
                fold_curves: bool = False, fold_newton: bool = False,
                fold_dep: bool = False, params=None, config=None) -> dict:
    """An `InputData` -> the field dict `cloudsc` consumes, as host tensors
    (cloudsc_tpu.physics.make_inputs with host=True). Fields are cast at
    file width, then expanded to `inp.ngptot` columns in `column_order`
    ("cyclic", the reference's, or "grouped"; `column_perm`, grouped only,
    permutes the source columns first).

    `fold=True` gives the folded contract: the section-1 state accumulation
    and the always-summed pairs computed in fp64 at file width, then cast
    (ztp1_in, zqv_in, za_in, zqx_cld_in, pmf, zhr in place of pt, pq, pa,
    pclv, the tendencies and the pairs). With `params`, and computed in
    fp64 at file width like the rest (physics/satfold): `fold_curves` adds
    the nine saturation-curve rows, `fold_newton` the 3.4b Newton's ZDQS
    row, `fold_dep` the two deposition rows of the formula `config`'s
    IDEPICE selects."""
    from ..data.expand import expand_field

    if column_perm is not None and column_order != "grouped":
        raise ValueError("column_perm requires column_order='grouped'")
    f = inp.fields
    ngptot = inp.ngptot
    np_dtype = _NP_DTYPES[dtype]

    def cast(name, to=None):
        a = np.asarray(f[name]) if isinstance(name, str) else name
        to = np.dtype(np_dtype if to is None else to)
        if a.dtype != to:
            a = a.astype(to)
        if a.shape[-1] != ngptot:
            if column_perm is not None:
                a = a[..., column_perm]
            a = expand_field(a, ngptot, order=column_order)
        return torch.from_numpy(np.ascontiguousarray(a))

    flags = {"ldcum": cast("LDCUM", to=bool),
             "ktype": cast("KTYPE", to=np.int32)}
    if not fold:
        return {**{k: cast(n) for k, n in _PLAIN + _AEROSOL}, **flags}

    dt64 = float(inp.ptsphy)

    def f64(name):
        return np.asarray(f[name], np.float64)

    ztp1_64 = f64("PT") + dt64 * f64("TENDENCY_TMP_T")
    folded = {
        "ztp1_in": cast(ztp1_64),
        "zqv_in": cast(f64("PQ") + dt64 * f64("TENDENCY_TMP_Q")),
        "za_in": cast(f64("PA") + dt64 * f64("TENDENCY_TMP_A")),
        "zqx_cld_in": cast(f64("PCLV")[:4]
                           + dt64 * f64("TENDENCY_TMP_CLD")[:4]),
        "pmf": cast(f64("PMFU") + f64("PMFD")),
        "zhr": cast(f64("PHRSW") + f64("PHRLW")),
    }
    if fold_curves or fold_newton or fold_dep:
        if params is None:
            raise ValueError("fold_curves/fold_newton/fold_dep need params")
        # the config matters for fold_dep alone (IDEPICE)
        c64 = scheme.derived_consts(params, dt64, torch.float64, config)
        curves = satfold.curve_rows(c64, ztp1_64, f64("PAP"))
        if fold_curves:
            folded.update({n: cast(r) for n, r in curves.items()})
        if fold_newton:
            folded["zdqs"] = cast(satfold.newton_zdqs(
                c64, ztp1_64, f64("PAP"), f64("PAPH"),
                f64("PMFU") + f64("PMFD"), f64("PHRSW") + f64("PHRLW"),
                f64("PVERVEL"), curves["zqsmix"],
            ))
        if fold_dep:
            dep = satfold.dep_rows(
                c64, ztp1_64, f64("PQ") + dt64 * f64("TENDENCY_TMP_Q"),
                f64("PA") + dt64 * f64("TENDENCY_TMP_A"),
                f64("PCLV")[:4] + dt64 * f64("TENDENCY_TMP_CLD")[:4],
                f64("PAP"), curves)
            folded.update({n: cast(r) for n, r in dep.items()})
    return {**folded, **{k: cast(n) for k, n in _FOLDED_REST + _AEROSOL},
            **flags}


def fields_on_device(inp, dtype, device) -> dict:
    """`make_inputs`' plain field dict (cyclic column order) on `device`,
    expanded there: only the file-width arrays cross from the host, and
    column j takes file column j % klon, as the host expansion gives it."""
    import dataclasses

    narrow = make_inputs(dataclasses.replace(
        inp, ngptot=min(inp.ngptot, inp.klon_file)), dtype)
    idx = torch.arange(inp.ngptot, device=device) % inp.klon_file
    return {k: v.to(device).index_select(v.ndim - 1, idx)
            for k, v in narrow.items()}


# The pre-packed scan's three stacks (the JAX module's _SCAN_*_ROWS): P, the
# rows also read at level k-1; H, the rows also read at level k+1 (padded to
# nlev+1 levels); S, the rows read at level k alone (`_scan_s_rows`), then
# the condensates after section 1
_SCAN_P_ROWS = ("ztp1", "za", "pap")
_SCAN_H_ROWS = ("paph", "pmf", "plu")
_SCAN_CLOSURE_NAMES = (
    "ztp1", "za", "zaorig", "zqsmix", "zqsliq", "zqsice", "zfoeew",
    "zfoeewmt", "zfoeeliqt", "zfoealfa", "zli", "zliqfrac", "zicefrac",
    "zfoeeliq", "zfoeeice", "zfokoop", "pap", "paph", "pmf", "zhr",
    "pvervel", "plude_in", "plu", "psnde", "psupsat", "tend_t_pre",
    "tend_q_pre", "pre_ice", "picrit_aer", "pnice", "plcrit_aer", "pccn",
)


def _aer_read(c) -> list:
    """The aerosol fields the configuration's couplings read."""
    return [n for n, on in (("pre_ice", c.LAERICESED),
                            ("picrit_aer", c.LAERICEAUTO),
                            ("pnice", c.LAERICEAUTO),
                            ("plcrit_aer", c.LAERLIQAUTOLSP or c.LAERLIQCOLL),
                            ("pccn", c.LAERLIQAUTOLSP or c.LAERLIQCOLL))
            if on]


def _scan_s_rows(c) -> list:
    """The S stack's rows: the level loop's rows read at level k alone (the
    aerosol rows only where a coupling reads them), then zqx0..zqx4."""
    unread = {n for n, _ in _AEROSOL} - set(_aer_read(c))
    return [n for n in _SCAN_CLOSURE_NAMES
            if n not in _SCAN_P_ROWS + _SCAN_H_ROWS and n not in unread] + \
        [f"zqx{m}" for m in range(NCLV)]


def _front(fields: dict, params, ptsphy, config):
    """Section 1 over every level at once and the level loop's full-level
    rows -> (c, ini, rows)."""
    folded = "ztp1_in" in fields
    pt = fields["ztp1_in"] if folded else fields["pt"]
    c = scheme.derived_consts(params, ptsphy, pt.dtype, config)

    # ==================================================================
    # 1. INITIAL VALUES (ref: 654-808), every level at once
    # ==================================================================
    if folded:
        raw = dict(ztp1_in=pt, zqv_in=fields["zqv_in"], za_in=fields["za_in"],
                   zqx_cld_in=[fields["zqx_cld_in"][m] for m in range(4)],
                   pap=fields["pap"])
        if "zqsmix" in fields:
            # folded saturation curves: level_init reads the rows
            raw.update({n: fields[n] for n in satfold.CURVE_ROWS})
    else:
        raw = dict(
            pt=pt, pq=fields["pq"], pa=fields["pa"], pap=fields["pap"],
            tendency_tmp_t=fields["tendency_tmp_t"],
            tendency_tmp_q=fields["tendency_tmp_q"],
            tendency_tmp_a=fields["tendency_tmp_a"],
            pclv=[fields["pclv"][m] for m in range(4)],
            tendency_tmp_cld=[fields["tendency_tmp_cld"][m] for m in range(4)],
        )
    ini = scheme.level_init(raw, c)
    # the full-level arrays the level views slice; the scheme only ever
    # consumes PMFU+PMFD and PHRSW+PHRLW summed (the folded dict carries
    # the fp64 sums)
    rows = {n: ini[n] for n in (
        "ztp1", "za", "zaorig", "zqsmix", "zqsliq", "zqsice", "zfoeew",
        "zfoeewmt", "zfoeeliqt", "zfoealfa", "zli", "zliqfrac", "zicefrac",
        "zfoeeliq", "zfoeeice", "zfokoop", "tend_t_pre", "tend_q_pre")}
    rows.update(
        pap=fields["pap"], paph=fields["paph"],
        pmf=fields["pmf"] if folded else fields["pmfu"] + fields["pmfd"],
        zhr=fields["zhr"] if folded else fields["phrsw"] + fields["phrlw"],
        pvervel=fields["pvervel"], plude_in=fields["plude"],
        plu=fields["plu"], psnde=fields["psnde"], psupsat=fields["psupsat"])
    for n in _aer_read(c):
        rows[n] = fields[n]
    for n in ("zdqs",) + satfold.DEP_ROWS:
        if n in fields:
            rows[n] = fields[n]
    return c, ini, rows


def scan_pack(fields: dict, params, ptsphy, config=None) -> dict:
    """The scan engine's pre-packed closure (the JAX module's scan_pack,
    CLOUDSC_SCAN_PACKED=1): sections 0-1 run here, once, and the level
    loop's rows go into three stacks — S (nlev, R, ncol), the rows read at
    level k alone and the condensates; P (nlev, 3, ncol), the rows also read
    at k-1; H (nlev+1, 3, ncol), the rows also read at k+1 — so that
    `cloudsc`, which takes the returned dict (detected by its "stack_s"
    key), cuts five slices a level. The same operations on the same values
    as the plain dict: bit for bit its outputs. Pass `cloudsc` the same
    `config` (the S stack's aerosol rows follow it). A folded-curve, Newton
    or deposition dict is refused: the stacks have no rows for it. The JAX
    dict's all-zero `dep` entry (its chained timing loop's data dependency)
    has no counterpart: the port's driver does not chain."""
    if any(n in fields for n in ("zqsmix", "zdqs") + satfold.DEP_ROWS):
        raise ValueError("scan_pack does not take folded-curve, Newton or "
                         "deposition field dicts (the stacks have no rows "
                         "for them)")
    c, ini, rows = _front(fields, params, ptsphy, config)
    nlev = rows["ztp1"].shape[0]
    s_rows = _scan_s_rows(c)
    stack_s = torch.stack([rows[n] for n in s_rows[:-NCLV]] + ini["zqx"],
                          dim=1)
    stack_p = torch.stack([rows[n] for n in _SCAN_P_ROWS], dim=1)
    stack_h = torch.stack(
        [v if v.shape[0] == nlev + 1 else torch.cat([v, v[-1:]])
         for v in (rows[n] for n in _SCAN_H_ROWS)], dim=1)
    return dict(stack_s=stack_s, stack_p=stack_p, stack_h=stack_h,
                zqx0=torch.stack(ini["zqx0"]), zlneg=torch.stack(ini["zlneg"]),
                pvfl=fields["pvfl"], pvfi=fields["pvfi"],
                land=fields["plsm"] > 0.5, ldcum=fields["ldcum"],
                ktype=fields["ktype"])


def cloudsc(fields: dict, params, ptsphy, config=None) -> CloudscOutputs:
    """One CLOUDSC step over every column of a `make_inputs` field dict
    (plain or folded), or of `scan_pack`'s pre-packed dict, on the fields'
    device. `config` selects the scheme version (scheme.SchemeConfig; the
    reference configuration if None). Every operation is a torch operation
    on the fields, so the step differentiates in reverse and forward mode
    with respect to any float field, and to `ptsphy` or a float of `params`
    given as a tensor (`scheme.derived_consts`; `physics.autodiff` holds
    the entry points)."""
    if "stack_s" in fields:
        stack_s, stack_p, stack_h = (fields["stack_s"], fields["stack_p"],
                                     fields["stack_h"])
        nlev, _, ncol = stack_s.shape
        dev = stack_s.device
        c = scheme.derived_consts(params, ptsphy, stack_s.dtype, config)
        s_idx = {n: i for i, n in enumerate(_scan_s_rows(c))}
        zqx0, zlneg = list(fields["zqx0"]), list(fields["zlneg"])
        zfoealfa = stack_s[:, s_idx["zfoealfa"]]
        tend_t_pre = stack_s[:, s_idx["tend_t_pre"]]
        tend_q_pre = stack_s[:, s_idx["tend_q_pre"]]
        plude_in = stack_s[:, s_idx["plude_in"]]
        paph = stack_h[:, 0]
        land, ldcum, ktype = fields["land"], fields["ldcum"], fields["ktype"]
        p_idx = {n: i for i, n in enumerate(_SCAN_P_ROWS)}
        h_idx = {n: i for i, n in enumerate(_SCAN_H_ROWS)}
    else:
        c, ini, rows = _front(fields, params, ptsphy, config)
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

    # the two level flags as device scalars, made once
    flag = {b: torch.tensor(b, device=dev) for b in (False, True)}

    def clamp(k, n):
        return min(max(k, 0), n - 1)

    def make_x(k):
        """Level k's view: rows at k, and at k-1 / k+1 where the scheme
        reads them, the index clamped to the array as the JAX scan's
        dynamic slices clamp it (every such read is masked by not_first /
        not_last). The pre-packed dict: five slices of its stacks."""
        if "stack_s" in fields:
            sk, pk = stack_s[k], stack_p[k]
            pkm = stack_p[clamp(k - 1, nlev)]
            hk, hkp = stack_h[k], stack_h[clamp(k + 1, nlev + 1)]
            x = {n: sk[i] for n, i in s_idx.items()}
            x.update({n: pk[i] for n, i in p_idx.items()})
            x.update({n: hk[i] for n, i in h_idx.items()})
            x.update(ztp1_prev=pkm[p_idx["ztp1"]], za_prev=pkm[p_idx["za"]],
                     pap_prev=pkm[p_idx["pap"]],
                     paph_next=hkp[h_idx["paph"]],
                     pmf_next=hkp[h_idx["pmf"]], plu_next=hkp[h_idx["plu"]],
                     zqx=[sk[s_idx[f"zqx{m}"]] for m in range(NCLV)])
        else:
            def row(name, off=0):
                a = rows[name]
                return a[clamp(k + off, a.shape[0])]

            x = {name: row(name) for name in rows}
            x.update(
                ztp1_prev=row("ztp1", -1), za_prev=row("za", -1),
                pap_prev=row("pap", -1), paph_next=row("paph", 1),
                pmf_next=row("pmf", 1), plu_next=row("plu", 1),
                zqx=[ini["zqx"][m][k] for m in range(NCLV)])
        x.update(paph_surf=paph_surf, land=land, ldcum=ldcum, ktype=ktype,
                 not_first=flag[k > ktop], not_last=flag[k < nlev - 1])
        return x

    # ==================================================================
    # 3-6. THE LEVEL LOOP (ref: 854-2775). Each level's rows are collected
    # and stacked under the rows above cloud top (zero, or the section-1
    # value), with no write into an existing array: reverse and forward
    # mode then see one stack a field, not a chain of slice updates.
    # ==================================================================
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
        """The full-level array: `above` over the levels down to cloud top
        (one zero row broadcast if `above` is a count), then the loop's."""
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

    # ==================================================================
    # 8. flux diagnostics (ref: 2788-2867)
    # ==================================================================
    pfplsl = zpfplsx[IR] + zpfplsx[IL]
    pfplsn = zpfplsx[IS] + zpfplsx[II]
    zgdph_r = -c.zrg_r * (paph[1:] - paph[:-1]) * zqtmst   # (nlev, ncol)
    liq_inc = (zqxn[IL] - zqx0[IL] + pvfl * ptsphy - zfoealfa * plude) * zgdph_r
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
    return CloudscOutputs(
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
