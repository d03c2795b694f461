"""Shape-agnostic CLOUDSC physics on torch tensors: level init + level step.

Counterpart of `cloudsc_tpu/physics/scheme.py` (behavioural spec:
src/cloudsc_fortran/cloudsc.F90 in the reference; `ref:` line numbers point
there). Every function is elementwise over tensors of any shape, in the
Fortran statement order, and mirrors the JAX module line for line so the two
packages round alike:

  * structural sparsity — the 5x5 source (ZSOLQA) and implicit (ZSOLQB)
    matrices keep their compile-time zeros as Python ``None`` (`sadd`,
    `schain`), and the LU solve skips them;
  * the 5.2.1 run-out order is the lexicographic (ratio, species) rank with
    the first-minimum tie rule;
  * the dynamic fast paths (`inert_skip`, the 5.2.1 no-overshoot case and
    the optional per-round skip) are plain Python branches on
    ``mask.any()``, value-exact like the JAX ``lax.cond``; `probe_hook`
    sees their guards (bench/activity_probe.py).

This is the body of the plain version of the fused CUDA kernel
(`kernels/cuda_cloudsc.py`): on a CPU tensor the kernel wrapper runs it level
by level, and on the card it is what the kernel is held against.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import torch

from .thermo import foealfa, foedelta, foedem_a, foeewm_a, foeldcpm_a

# 0-based species indices (ref: yoecldp.F90:86-91)
IL, II, IR, IS, IV = 0, 1, 2, 3, 4
NCLV = 5
# phase markers: 0=vapour 1=liquid 2=ice (ref: cloudsc.F90:603-607)
IPHASE = (1, 2, 1, 2, 0)
# melting targets (ref: cloudsc.F90:613-617)
IMELT = (II, IR, IS, IR, -1)

ZEPSEC = 1.0e-14  # ref: cloudsc.F90:589
# numerical wet-bulb fit constants (ref: cloudsc.F90:421-425)
ZTW1, ZTW2, ZTW3, ZTW4, ZTW5 = 1329.31, 0.0074615, 0.85e5, 40.637, 275.0

CARRY_KEYS = (
    "zanewm1", "zqxnm1", "pfplsx", "zcovptot", "zcovpmax",
    "zcldtopdist", "llrainliq", "prainfrac",
)


def chain(terms):
    """Left-to-right sum, preserving the Fortran accumulation order."""
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


# -- structural-sparsity helpers: None == compile-time zero -------------------

def sadd(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a + b


def sneg(a):
    return None if a is None else -a


def schain(terms):
    """Left-to-right sum over non-None terms (None if all are None)."""
    acc = None
    for t in terms:
        acc = sadd(acc, t)
    return acc


# -- jnp.maximum / jnp.minimum / jnp.where with Python-scalar operands --------

def mx(a, b):
    if torch.is_tensor(a):
        return torch.maximum(a, b) if torch.is_tensor(b) else torch.clamp(a, min=b)
    return torch.clamp(b, min=a)


def mn(a, b):
    if torch.is_tensor(a):
        return torch.minimum(a, b) if torch.is_tensor(b) else torch.clamp(a, max=b)
    return torch.clamp(b, max=a)


def sel2(mask, a, b, like):
    """where(mask, a, b) for two scalars, in `like`'s dtype. Each is a Python
    float or a parameter tensor (0-d or `(ncol,)`, which keeps its
    gradient)."""
    if torch.is_tensor(a):
        return torch.where(mask, a, b)
    return torch.where(mask, torch.full_like(like, a), b)


def madd(mask, v):
    return torch.where(mask, v, 0.0)


# Division with a Python-scalar operand, rounded once as JAX rounds it:
# `scalar / tensor` in torch is reciprocal-then-multiply, and CUDA turns
# `tensor / scalar` into a multiply by the reciprocal; a 0-d tensor on the
# operand's device keeps both a true IEEE division. A scalar that is already
# a tensor (a parameter under differentiation, on the operand's device)
# divides as it is, which is the same division.

def rdiv(s, t):
    return (s if torch.is_tensor(s) else t.new_full((), s)) / t


def div(t, s):
    return t / (s if torch.is_tensor(s) else t.new_full((), s))


def sdiv(a, b):
    """a / b for two scalars: Python's division for two floats; a true
    tensor division as soon as one is a parameter tensor (`float / tensor`
    would be reciprocal-then-multiply, two roundings)."""
    if torch.is_tensor(a):
        return div(a, b)
    return rdiv(a, b) if torch.is_tensor(b) else a / b


# Diagnostic probe: a callable(tag, mask) that records the per-element guard
# masks of the dynamic fast paths and of the sections' activity
# (bench/activity_probe.py); None on every other path. The engine branches
# on the host, so a nested guard is recorded only on the levels where its
# enclosing branch runs.
probe_hook = None


def inert_skip(mask, active_fn, ops, force=False, tag=None):
    """Dynamic fast path for a region that is inert wherever `mask` is False:
    when it is False everywhere in the batch, the region's increments are
    exactly zero and its updates the identity, so returning `ops` unchanged
    is value-exact (the JAX `lax.cond` contract: every value `active_fn`
    returns has a seed in `ops` equal to its inert value). `force` runs the
    active branch regardless — the oracle the inertness tests diff against.
    `tag` names the guard to `probe_hook`."""
    if probe_hook is not None:
        probe_hook(tag, mask)
    if force or bool(mask.any()):
        return active_fn(ops)
    return ops


class SchemeConfig(SimpleNamespace):
    """Scheme-version switches (ref: cloudsc.F90:562-580). The reference
    hardcodes (2, 2, 1, 1); the alternates are implemented and selectable:
      iwarmrain: 1 Sundqvist-1989 | 2 Khairoutdinov-Kogan-2000
      ievaprain: 1 Sundqvist      | 2 Abel-Boutle-2013
      ievapsnow: 1 Sundqvist      | 2 PSD-based
      idepice:   1 Rotstayn-2001  | 2 ice-PSD-based
    skip: diagnostics only — tags of physics sections to drop (SKIP_TAGS;
    bench/kernel_lab.py's section attribution). Any entry makes the physics
    wrong by construction; nothing on the main path sets it.
    dynamic_skips=False always runs the skippable regions (the oracle for
    the value-exactness of the skips). s521_round_skip adds a value-exact
    skip of each 5.2.1 rescale round no column can need; None reads
    CLOUDSC_S521_ROUND_SKIP (default 0), as the JAX package does.
    """

    def __init__(self, iwarmrain=2, ievaprain=2, ievapsnow=1, idepice=1,
                 skip=(), dynamic_skips=True, s521_round_skip=None):
        if s521_round_skip is None:
            s521_round_skip = (
                os.environ.get("CLOUDSC_S521_ROUND_SKIP", "0") == "1")
        super().__init__(iwarmrain=int(iwarmrain), ievaprain=int(ievaprain),
                         ievapsnow=int(ievapsnow), idepice=int(idepice),
                         skip=tuple(skip),
                         dynamic_skips=bool(dynamic_skips),
                         s521_round_skip=bool(s521_round_skip))


# the section tags `SchemeConfig.skip` takes, in the scheme's order
SKIP_TAGS = ("s31", "s33", "s34e", "s34c", "s37", "s43a", "s43b", "s43c",
             "s44a", "s44b", "s44c", "s45r", "s45s", "s46", "s521", "s522")


def derived_consts(params, ptsphy, dtype,
                   config: SchemeConfig | None = None) -> SimpleNamespace:
    """Scalar constants shared by every section (the ASSOCIATE block +
    derived values, ref: cloudsc.F90:503-545, 585-591), as plain Python
    floats/ints/bools from `params.Params`. `ptsphy` and any float of
    `params` may instead be a tensor of the working dtype on the fields'
    device, 0-d or `(ncol,)` (a parameter under differentiation, or one
    value a column): it passes through with its gradient, and the derived
    values divide it as the floats divide."""
    cst, thf, e = params.ydcst, params.ydthf, params.ydecldp
    c = SimpleNamespace()
    c.cst, c.thf, c.e = cst, thf, e
    c.ptsphy = ptsphy if torch.is_tensor(ptsphy) else float(ptsphy)
    c.RG, c.RD, c.RCPD, c.RETV = cst.rg, cst.rd, cst.rcpd, cst.retv
    c.RLVTT, c.RLSTT, c.RLMLT = cst.rlvtt, cst.rlstt, cst.rlmlt
    c.RTT, c.RV = cst.rtt, cst.rv
    c.R4LES, c.R4IES = thf.r4les, thf.r4ies
    c.R5LES, c.R5IES = thf.r5les, thf.r5ies
    c.RALVDCP, c.RALSDCP, c.RALFDCP = thf.ralvdcp, thf.ralsdcp, thf.ralfdcp
    c.NCLDTOP = int(e.ncldtop)      # 1-based as in Fortran
    c.NSSOPT = int(e.nssopt)
    c.LAERICESED = bool(e.laericesed)
    c.LAERICEAUTO = bool(e.laericeauto)
    c.LAERLIQAUTOLSP = bool(e.laerliqautolsp)
    c.LAERLIQCOLL = bool(e.laerliqcoll)
    cfg = config or SchemeConfig()
    c.IWARMRAIN, c.IEVAPRAIN = cfg.iwarmrain, cfg.ievaprain
    c.IEVAPSNOW, c.IDEPICE = cfg.ievapsnow, cfg.idepice
    c.zqtmst = sdiv(1.0, c.ptsphy)
    c.zrdcp = c.RD / c.RCPD
    c.zrg_r = 1.0 / c.RG
    c.zrldcp = 1.0 / (c.RALSDCP - c.RALVDCP)
    # 100*eps of the working precision (ref: 555)
    c.zepsilon = 100.0 * float(torch.finfo(dtype).eps)
    c.zvqx = (0.0, e.rvice, e.rvrain, e.rvsnow, 0.0)  # fall speed per species
    c.dtype = dtype
    c.skip = frozenset(cfg.skip)
    c.dynamic_skips = cfg.dynamic_skips
    c.s521_round_skip = cfg.s521_round_skip
    return c


def sat_mix(ztp1, zfoealfa, pap, c):
    """Section 1's mixed-phase saturation curve (ref: 749-760): its two
    exponentials, ZFOEEWMT and ZQSMIX at temperature ztp1, liquid fraction
    zfoealfa and pressure pap, elementwise."""
    cst, thf = c.cst, c.thf
    exp_liq = torch.exp(thf.r3les * (ztp1 - cst.rtt) / (ztp1 - thf.r4les))
    exp_ice = torch.exp(thf.r3ies * (ztp1 - cst.rtt) / (ztp1 - thf.r4ies))
    zfoeewmt = mn(
        thf.r2es * (zfoealfa * exp_liq + (1.0 - zfoealfa) * exp_ice)
        / pap, 0.5
    )
    zqsmix = zfoeewmt / (1.0 - c.RETV * zfoeewmt)
    return exp_liq, exp_ice, zfoeewmt, zqsmix


def cuadj_zdqs(ztp1, pap, zdp, pmf, pmf_next, not_last, pvervel, zhr,
               zqsmix, c):
    """3.4b's forcing chain and the in-line CUADJTQ, 2 Newton iterations
    (ref: 1281-1325): ZDQS of one level from that level's inputs alone —
    ZTP1, PAP, PAPH's difference zdp, PMFU+PMFD of the level and of the one
    below (masked by `not_last`), PVERVEL, PHRSW+PHRLW and ZQSMIX — with no
    cross-level carry, so elementwise over levels and columns."""
    cst, thf = c.cst, c.thf
    ptsphy, RETV = c.ptsphy, c.RETV
    zdtdp = c.zrdcp * ztp1 / pap
    zdpmxdt = zdp * c.zqtmst
    zmfdn2 = madd(not_last, pmf_next)
    zwtot = pvervel + 0.5 * c.RG * (pmf + zmfdn2)
    zwtot = mn(zdpmxdt, mx(-zdpmxdt, zwtot))
    zzzdt = zhr  # PHRSW + PHRLW (ref: 1289)
    zdtdiab = mn(zdpmxdt * zdtdp, mx(-zdpmxdt * zdtdp, zzzdt)) * ptsphy
    zdtforc = zdtdp * zwtot * ptsphy + zdtdiab
    tloc = mx(ztp1 + zdtforc, 160.0)
    qloc = zqsmix
    zqp = 1.0 / pap
    # inlined CUADJTQ, 2 Newton iterations (ref: 1303-1319)
    for _ in range(2):
        alfa_n = foealfa(tloc, thf)
        zqsat = mn(foeewm_a(tloc, alfa_n, cst, thf) * zqp, 0.5)
        zcor_n = 1.0 / (1.0 - RETV * zqsat)
        zqsat = zqsat * zcor_n
        zcond = (qloc - zqsat) / (
            1.0 + zqsat * zcor_n * foedem_a(tloc, alfa_n, thf)
        )
        tloc = tloc + foeldcpm_a(alfa_n, thf) * zcond
        qloc = qloc - zcond
    return qloc - zqsmix


def level_init(raw: dict, c) -> dict:
    """Section 1 'initial values' (ref: 654-808), elementwise over any shape.

    `raw` holds same-shape tensors: pt, pq, pa, pap, tendency_tmp_{t,q,a},
    pclv (list of the 4 condensates), tendency_tmp_cld (list of 4) — or the
    folded contract (ztp1_in, zqv_in, za_in, zqx_cld_in), whose tendency
    accumulation was done at load time in fp64."""
    cst, thf, e = c.cst, c.thf, c.e
    zqtmst, RETV = c.zqtmst, c.RETV
    RALVDCP, RALSDCP = c.RALVDCP, c.RALSDCP

    if "ztp1_in" in raw:
        ztp1 = raw["ztp1_in"]
        zqx = [None] * NCLV
        zqx[IV] = raw["zqv_in"]
        for m in (IL, II, IR, IS):
            zqx[m] = raw["zqx_cld_in"][m]
        za = raw["za_in"]
    else:
        ztp1 = raw["pt"] + c.ptsphy * raw["tendency_tmp_t"]
        zqx = [None] * NCLV
        zqx[IV] = raw["pq"] + c.ptsphy * raw["tendency_tmp_q"]
        for m in (IL, II, IR, IS):
            zqx[m] = raw["pclv"][m] + c.ptsphy * raw["tendency_tmp_cld"][m]
        za = raw["pa"] + c.ptsphy * raw["tendency_tmp_a"]
    zqx0 = list(zqx)
    zaorig = za

    zero = torch.zeros_like(ztp1)
    tend_t = zero
    tend_q = zero
    zlneg = [zero] * NCLV

    # tidy tiny cloud cover / total water (ref: 696-721)
    cond = ((zqx[IL] + zqx[II]) < e.rlmin) | (za < e.ramin)
    for m, lat in ((IL, RALVDCP), (II, RALSDCP)):
        zlneg[m] = zlneg[m] + madd(cond, zqx[m])
        zqadj = zqx[m] * zqtmst
        tend_q = tend_q + madd(cond, zqadj)
        tend_t = tend_t - madd(cond, lat * zqadj)
        zqx[IV] = zqx[IV] + madd(cond, zqx[m])
        zqx[m] = torch.where(cond, 0.0, zqx[m])
    za = torch.where(cond, 0.0, za)

    # tidy small CLV amounts (ref: 727-743)
    for m in (IL, II, IR, IS):
        c2 = zqx[m] < e.rlmin
        zlneg[m] = zlneg[m] + madd(c2, zqx[m])
        zqadj = zqx[m] * zqtmst
        tend_q = tend_q + madd(c2, zqadj)
        lat = RALVDCP if IPHASE[m] == 1 else RALSDCP
        tend_t = tend_t - madd(c2, lat * zqadj)
        zqx[IV] = zqx[IV] + madd(c2, zqx[m])
        zqx[m] = torch.where(c2, 0.0, zqx[m])

    # saturation curves (ref: 749-784); the two exponentials are shared by
    # FOEEWM/FOEELIQ/FOEEICE/FOKOOP as in the JAX module
    pap = raw["pap"]
    zfoealfa = foealfa(ztp1, thf)
    if "zqsmix" in raw:
        # folded saturation curves (CLOUDSC_FOLD_CURVES): the block below,
        # computed at load time in fp64 (physics/satfold.curve_rows)
        zfoeeliq, zfoeeice = raw["zfoeeliq"], raw["zfoeeice"]
        zfoeewmt, zqsmix = raw["zfoeewmt"], raw["zqsmix"]
        zfoeew, zqsice = raw["zfoeew"], raw["zqsice"]
        zfoeeliqt, zqsliq = raw["zfoeeliqt"], raw["zqsliq"]
        zfokoop = raw["zfokoop"]
    else:
        exp_liq, exp_ice, zfoeewmt, zqsmix = sat_mix(ztp1, zfoealfa, pap, c)
        zfoeeliq = thf.r2es * exp_liq
        zfoeeice = thf.r2es * exp_ice
        zdelta = foedelta(ztp1, cst)
        zfoeew = mn((zdelta * zfoeeliq + (1.0 - zdelta) * zfoeeice) / pap,
                    0.5)
        zfoeew = mn(0.5, zfoeew)
        zqsice = zfoeew / (1.0 - RETV * zfoeew)
        zfoeeliqt = mn(zfoeeliq / pap, 0.5)
        zqsliq = zfoeeliqt / (1.0 - RETV * zfoeeliqt)
        # Koop supersaturation limit (ref: fccld.func.h:27), reused in 3.1/3.7
        zfokoop = mn(thf.rkoop1 - thf.rkoop2 * ztp1, zfoeeliq / zfoeeice)

    # cloud fraction in [0,1]; liquid/ice split (ref: 786-808)
    za = mx(0.0, mn(1.0, za))
    zli = zqx[IL] + zqx[II]
    has_li = zli > e.rlmin
    zliqfrac = torch.where(has_li, zqx[IL] / torch.where(has_li, zli, 1.0), 0.0)
    zicefrac = torch.where(has_li, 1.0 - zliqfrac, 0.0)

    return dict(
        ztp1=ztp1, za=za, zaorig=zaorig, zqx=zqx, zqx0=zqx0,
        zqsmix=zqsmix, zqsliq=zqsliq, zqsice=zqsice,
        zfoeew=zfoeew, zfoeewmt=zfoeewmt, zfoeeliqt=zfoeeliqt,
        zfoealfa=zfoealfa, zli=zli, zliqfrac=zliqfrac, zicefrac=zicefrac,
        zfoeeliq=zfoeeliq, zfoeeice=zfoeeice, zfokoop=zfokoop,
        tend_t_pre=tend_t, tend_q_pre=tend_q, zlneg=zlneg,
    )


def initial_carry(like, c) -> dict:
    """Column-carry reset (ref: 687, 838-843); `like` sets shape/dtype."""
    zero = torch.zeros_like(like)
    return dict(
        zanewm1=zero,
        zqxnm1=[zero] * NCLV,
        pfplsx=[zero] * NCLV,     # flux arriving at the current level
        zcovptot=zero,
        zcovpmax=zero,
        zcldtopdist=zero,
        llrainliq=torch.ones_like(like, dtype=torch.bool),
        prainfrac=zero,
    )


def level_step(x: dict, carry: dict, c) -> tuple[dict, dict]:
    """Sections 3-6 for one level (ref: 854-2775), elementwise over any shape.

    `x` holds the per-level slabs of the JAX contract (`not_first` and
    `not_last` as bool tensors); `carry` the JK->JK+1 recurrences. Returns
    (new_carry, ys)."""
    e, cst, thf = c.e, c.cst, c.thf
    ptsphy, zqtmst = c.ptsphy, c.zqtmst
    RG, RD, RETV, RTT, RV = c.RG, c.RD, c.RETV, c.RTT, c.RV
    RLSTT = c.RLSTT
    R4LES, R4IES, R5LES, R5IES = c.R4LES, c.R4IES, c.R5LES, c.R5IES
    RALVDCP, RALSDCP = c.RALVDCP, c.RALSDCP
    zrldcp, zrdcp, zrg_r, zepsilon = c.zrldcp, c.zrdcp, c.zrg_r, c.zepsilon
    NSSOPT = c.NSSOPT

    not_first = x["not_first"]
    not_last = x["not_last"]
    ztp1 = x["ztp1"]
    za = x["za"]
    zqx = list(x["zqx"])
    zqsmix, zqsliq, zqsice = x["zqsmix"], x["zqsliq"], x["zqsice"]
    pap, paph, paph_next = x["pap"], x["paph"], x["paph_next"]
    paph_surf = x["paph_surf"]
    land, ldcum, ktype = x["land"], x["ldcum"], x["ktype"]
    zfoealfa_k = x["zfoealfa"]
    pfplsx_row = carry["pfplsx"]

    zero = torch.zeros_like(ztp1)
    force_on = not c.dynamic_skips

    # ---- 3.0 per-level init (ref: 854-983) --------------------------
    zqxfg = list(zqx)
    solqa = [[None for _ in range(NCLV)] for _ in range(NCLV)]
    solqb = [[None for _ in range(NCLV)] for _ in range(NCLV)]
    zfallsrce = [None] * NCLV
    zfallsink = [None] * NCLV
    zconvsrce = [None] * NCLV
    zconvsink = [None] * NCLV
    zpsupsatsrce = [None] * NCLV
    solab = zero
    solac = zero

    zdp = paph_next - paph
    zgdp = rdiv(RG, zdp)
    zrho = pap / (RD * ztp1)
    zdtgdp = ptsphy * zgdp
    zrdtgdp = zdp * (1.0 / (ptsphy * RG))

    zfacw = rdiv(R5LES, (ztp1 - R4LES) ** 2)
    zcor = 1.0 / (1.0 - RETV * x["zfoeeliqt"])
    zdqsliqdt = zfacw * zcor * zqsliq
    zcorqsliq = 1.0 + RALVDCP * zdqsliqdt

    zfaci = rdiv(R5IES, (ztp1 - R4IES) ** 2)
    zcor = 1.0 / (1.0 - RETV * x["zfoeew"])
    zdqsicedt = zfaci * zcor * zqsice
    zcorqsice = 1.0 + RALSDCP * zdqsicedt

    zalfaw = zfoealfa_k
    zfac = zalfaw * zfacw + (1.0 - zalfaw) * zfaci
    zcor = 1.0 / (1.0 - RETV * x["zfoeewmt"])
    zdqsmixdt = zfac * zcor * zqsmix
    zcorqsmix = 1.0 + foeldcpm_a(zfoealfa_k, thf) * zdqsmixdt

    zevaplimmix = mx((zqsmix - zqx[IV]) / zcorqsmix, 0.0)

    ztmpa = 1.0 / mx(za, ZEPSEC)
    zliqcld = zqx[IL] * ztmpa
    zicecld = zqx[II] * ztmpa
    zlicld = zliqcld + zicecld

    # evaporate very small liquid/ice (ref: 971-983)
    for m in (IL, II):
        tiny = zqx[m] < e.rlmin
        solqa[IV][m] = sadd(solqa[IV][m], madd(tiny, zqx[m]))
        solqa[m][IV] = sadd(solqa[m][IV], -madd(tiny, zqx[m]))

    # ---- 3.1 ice supersaturation adjustment (ref: 985-1088) ---------
    zfokoop = x["zfokoop"]
    warm_or_off = (ztp1 >= RTT) | (NSSOPT == 0)
    zfac = torch.where(warm_or_off, 1.0, za + zfokoop * (1.0 - za))
    zfaci = sel2(warm_or_off, 1.0, sdiv(ptsphy, e.rkooptau), ztp1)

    high_a = za > 1.0 - e.ramin
    zsup_cld = mx((zqx[IV] - zfac * zqsice) / zcorqsice, 0.0)
    zqp1env = (zqx[IV] - za * zqsice) / mx(1.0 - za, zepsilon)
    zsup_env = mx((1.0 - za) * (zqp1env - zfac * zqsice) / zcorqsice, 0.0)
    zsupsat = torch.where(high_a, zsup_cld, zsup_env)

    has_sup = zsupsat > ZEPSEC
    warm = ztp1 > e.rthomo
    if probe_hook is not None:
        probe_hook("s31", has_sup | (x["psupsat"] > ZEPSEC))
    if "s31" not in c.skip:
        for m, w in ((IL, warm), (II, ~warm)):
            amt = madd(has_sup & w, zsupsat)
            solqa[m][IV] = sadd(solqa[m][IV], amt)
            solqa[IV][m] = sadd(solqa[IV][m], -amt)
            zqxfg[m] = zqxfg[m] + amt
        solac = torch.where(has_sup, (1.0 - za) * zfaci, solac)

        psupsat = x["psupsat"]
        has_ps = psupsat > ZEPSEC
        for m, w in ((IL, warm), (II, ~warm)):
            amt = madd(has_ps & w, psupsat)
            solqa[m][m] = sadd(solqa[m][m], amt)
            zpsupsatsrce[m] = amt
            zqxfg[m] = zqxfg[m] + amt
        solac = torch.where(has_ps, (1.0 - za) * zfaci, solac)

    # ---- 3.2 detrainment from convection (ref: 1100-1127) -----------
    plude_scaled = x["plude_in"] * zdtgdp
    plu_next = x["plu_next"]
    lcond = not_last & ldcum & (plude_scaled > e.rlmin) & (plu_next > ZEPSEC)
    solac = solac + madd(lcond, plude_scaled / torch.where(lcond, plu_next, 1.0))
    zconvsrce[IL] = madd(lcond, zalfaw * plude_scaled)
    zconvsrce[II] = madd(lcond, (1.0 - zalfaw) * plude_scaled)
    solqa[IL][IL] = sadd(solqa[IL][IL], zconvsrce[IL])
    solqa[II][II] = sadd(solqa[II][II], zconvsrce[II])
    plude_out = torch.where(
        not_last, torch.where(lcond, plude_scaled, 0.0), x["plude_in"]
    )
    solqa[IS][IS] = sadd(
        solqa[IS][IS], madd(not_last & ldcum, x["psnde"] * zdtgdp)
    )
    if probe_hook is not None:
        probe_hook(
            "s32", lcond | (not_last & ldcum & (x["psnde"] * zdtgdp != 0.0))
        )

    # ---- 3.3 subsidence source + in-layer evaporation (ref: 1143-1194)
    # x["pmf"] = PMFU + PMFD, only ever consumed summed (ref: 1145, 1203, 1288)
    zmf = mx(0.0, x["pmf"] * zdtgdp)
    zacust = zmf * carry["zanewm1"]
    zlcust = [None] * NCLV
    if "s33" not in c.skip:
        for m in (IL, II):
            zlcust[m] = madd(not_first, zmf * carry["zqxnm1"][m])
            zconvsrce[m] = sadd(zconvsrce[m], zlcust[m])
        zdtdp = zrdcp * 0.5 * (x["ztp1_prev"] + ztp1) / paph
        zdtforc = zdtdp * (pap - x["pap_prev"])
        zdqs_sub = carry["zanewm1"] * zdtforc * zdqsmixdt
        zlfinalsum = zero
        for m in (IL, II):
            zlfinal = mx(0.0, zlcust[m] - zdqs_sub)
            zevap = mn(zlcust[m] - zlfinal, zevaplimmix)
            zlfinal = zlcust[m] - zevap
            zlfinalsum = zlfinalsum + madd(not_first, zlfinal)
            solqa[m][m] = sadd(solqa[m][m], madd(not_first, zlcust[m]))
            solqa[IV][m] = sadd(solqa[IV][m], madd(not_first, zevap))
            solqa[m][IV] = sadd(solqa[m][IV], -madd(not_first, zevap))
        zacust = torch.where(zlfinalsum < ZEPSEC, 0.0, zacust)
        solac = solac + madd(not_first, zacust)

    # subsidence sink to layer below (ref: 1201-1217)
    zmfdn = madd(not_last, mx(0.0, x["pmf_next"] * zdtgdp))
    if probe_hook is not None:
        probe_hook("s33", (not_first & (zmf > 0.0)) | (zmfdn > 0.0))
    solab = solab + zmfdn
    solqb[IL][IL] = sadd(solqb[IL][IL], zmfdn)
    solqb[II][II] = sadd(solqb[II][II], zmfdn)
    zconvsink[IL] = zmfdn
    zconvsink[II] = zmfdn

    # ---- 3.4 turbulent erosion (ref: 1230-1261) ----------------------
    zldifdt = sel2(
        (ktype > 0) & (plude_out > ZEPSEC),
        e.rcldiff_convi * e.rcldiff * ptsphy,
        e.rcldiff * ptsphy,
        ztp1,
    )
    has_cld = x["zli"] > ZEPSEC
    ze = zldifdt * mx(zqsmix - zqx[IV], 0.0)
    zleros = za * ze
    zleros = mn(zleros, zevaplimmix)
    zleros = mn(zleros, x["zli"])
    zaeros = zleros / torch.where(has_cld, zlicld, 1.0)
    if probe_hook is not None:
        probe_hook("s34e", has_cld)
    if "s34e" not in c.skip:
        solac = solac - madd(has_cld, zaeros)
        for m, frac in ((IL, x["zliqfrac"]), (II, x["zicefrac"])):
            amt = madd(has_cld, frac * zleros)
            solqa[IV][m] = sadd(solqa[IV][m], amt)
            solqa[m][IV] = sadd(solqa[m][IV], -amt)

    # ---- 3.4b condensation/evaporation from dqsat/dt (ref: 1281-1325)
    if "zdqs" in x:
        # folded Newton: the forcing chain + 2-iteration CUADJTQ below were
        # evaluated at load time in fp64 (physics/satfold.newton_zdqs)
        zdqs = x["zdqs"]
    else:
        zdqs = cuadj_zdqs(ztp1, pap, zdp, x["pmf"], x["pmf_next"], not_last,
                          x["pvervel"], x["zhr"], zqsmix, c)

    # 3.4a evaporation of clouds (ref: 1333-1356)
    evap_m = zdqs > 0.0
    zlevap = za * mn(zdqs, zlicld)
    zlevap = mn(zlevap, zevaplimmix)
    zlevap = mn(zlevap, mx(zqsmix - zqx[IV], 0.0))
    if "s34c" not in c.skip:
        for m, frac in ((IL, x["zliqfrac"]), (II, x["zicefrac"])):
            amt = madd(evap_m, frac * zlevap)
            solqa[IV][m] = sadd(solqa[IV][m], amt)
            solqa[m][IV] = sadd(solqa[m][IV], -amt)

    # 3.4b(1) increase of cloud water in existing clouds (ref: 1362-1396)
    c1m = (za > ZEPSEC) & (zdqs <= -e.rlmin)
    zlcond1 = mx(-zdqs, 0.0)
    zcorq = 1.0 / (1.0 - RETV * zqsmix)
    zcdmax = torch.where(
        za > 0.99,
        (zqx[IV] - zqsmix)
        / (1.0 + zcorq * zqsmix * foedem_a(ztp1, zfoealfa_k, thf)),
        (zqx[IV] - za * zqsmix) / torch.where(c1m, za, 1.0),
    )
    zlcond1 = mx(mn(zlcond1, zcdmax), 0.0)
    zlcond1 = za * zlcond1
    zlcond1 = torch.where(zlcond1 < e.rlmin, 0.0, zlcond1)
    if "s34c" not in c.skip:
        for m, w in ((IL, warm), (II, ~warm)):
            amt = madd(c1m & w, zlcond1)
            solqa[m][IV] = sadd(solqa[m][IV], amt)
            solqa[IV][m] = sadd(solqa[IV][m], -amt)
            zqxfg[m] = zqxfg[m] + amt

    # 3.4b(2) generation of new clouds (ref: 1400-1499)
    c2m = (zdqs <= -e.rlmin) & (za < 1.0 - ZEPSEC)
    zsigk = pap / paph_surf
    zrhc = torch.where(
        zsigk > 0.8,
        e.ramid + (1.0 - e.ramid) * div(zsigk - 0.8, 0.2) ** 2,
        e.ramid,
    )
    if NSSOPT in (0, 1):  # none / Tompkins
        zqe = (zqx[IV] - za * zqsice) / mx(ZEPSEC, 1.0 - za)
        zqe = mx(0.0, zqe)
    elif NSSOPT == 2:  # Lohmann and Karcher
        zqe = zqx[IV]
    else:  # Gierens
        zqe = zqx[IV] + x["zli"]
    zfac2 = torch.where((ztp1 >= RTT) | (NSSOPT == 0), 1.0, zfokoop)
    in_range = (zqe >= zrhc * zqsice * zfac2) & (zqe < zqsice * zfac2)
    c2m = c2m & in_range
    zacond = (
        -(1.0 - za) * zfac2 * zdqs
        / mx(2.0 * (zfac2 * zqsice - zqe), ZEPSEC)
    )
    zacond = mn(zacond, 1.0 - za)
    zlcond2 = -zfac2 * zdqs * 0.5 * zacond
    zzdl = 2.0 * (zfac2 * zqsice - zqe) / mx(ZEPSEC, 1.0 - za)
    zlcondlim = (za - 1.0) * zfac2 * zdqs - zfac2 * zqsice + zqx[IV]
    zlcond2 = torch.where(
        zfac2 * zdqs < -zzdl, mn(zlcond2, zlcondlim), zlcond2
    )
    zlcond2 = mx(zlcond2, 0.0)
    kill = (zlcond2 < e.rlmin) | ((1.0 - za) < ZEPSEC)
    zlcond2 = torch.where(kill, 0.0, zlcond2)
    zacond = torch.where(kill | (zlcond2 == 0.0), 0.0, zacond)
    if "s34c" not in c.skip:
        solac = solac + madd(c2m, zacond)
        for m, w in ((IL, warm), (II, ~warm)):
            amt = madd(c2m & w, zlcond2)
            solqa[m][IV] = sadd(solqa[m][IV], amt)
            solqa[IV][m] = sadd(solqa[IV][m], -amt)
            zqxfg[m] = zqxfg[m] + amt

    # ---- 3.7 ice deposition -------------------------------------------
    # cloud-top distance carry (ref: 1529-1533), updated unconditionally
    reset_top = (x["za_prev"] < e.rcldtopcf) & (za >= e.rcldtopcf)
    zcldtopdist = torch.where(
        reset_top, 0.0, carry["zcldtopdist"] + zdp / (zrho * RG)
    )

    # 4.2 sedimentation source/sink (ref: 1714-1746), outside the branch
    for m in (II, IR, IS):
        zfallsrce[m] = madd(not_first, pfplsx_row[m] * zdtgdp)
        solqa[m][m] = sadd(solqa[m][m], zfallsrce[m])
        if m == II and c.LAERICESED:
            vq = 0.002 * x["pre_ice"]
        else:
            vq = c.zvqx[m]
        zfallsink[m] = zdtgdp * (vq * zrho)

    # 4.4b's rain-fraction latch, hoisted out of the branch (ref: 2044-2056)
    rain_p = zqx[IR] > ZEPSEC
    latch = rain_p & (ztp1 <= RTT) & (x["ztp1_prev"] > RTT)
    zqpretot_f = mx(zqx[IS] + zqx[IR], ZEPSEC)
    prainfrac = torch.where(latch, zqx[IR] / zqpretot_f, carry["prainfrac"])
    llrainliq = (latch & (prainfrac > 0.8)) | (~latch & carry["llrainliq"])

    # ================================================================
    # 3.7-4.5 ice deposition + precipitation block (ref: 1501-2421), the
    # implicit solver and the tendency sections: inert (the identity) on
    # levels where no condensate, precipitation or explicit source exists —
    # see the JAX module for the guard-coverage argument
    # ================================================================
    flux_in = (
        (pfplsx_row[II] > 0.0)
        | (pfplsx_row[IR] > 0.0)
        | (pfplsx_row[IS] > 0.0)
    )
    pre_m = (
        (zqxfg[IL] > 0.0) | (zqxfg[II] > 0.0)
        | (zqxfg[IR] > 0.0) | (zqxfg[IS] > 0.0)
        | flux_in
    )
    region_m = pre_m
    for _mm in range(NCLV):
        for _nn in range(NCLV):
            if solqa[_mm][_nn] is not None:
                region_m = region_m | (solqa[_mm][_nn] != 0.0)
    if probe_hook is not None:
        # the folded solve's own activity, recorded outside the branch (see
        # the JAX module)
        probe_hook("solver", region_m | (zmfdn > 0.0))
    _blk_a = [
        (IS, IL), (IR, IL), (IL, IS), (IL, IR),   # 4.3b warm rain (KK2000)
        (IR, II), (II, IR), (IR, IS), (IS, IR),   # 4.4a melt + 4.4b freeze
        (II, IL), (IL, II),                       # 3.7 dep + 4.4c hom.freeze
        (IV, IR), (IR, IV), (IV, IS), (IS, IV),   # 4.5 evap/sublimation
    ]
    _blk_b = [(IS, II), (IS, IL), (IR, IL)]       # 4.3a / 4.3b(v1) / 4.3c
    _sqa0, _sqb0, _qf0 = solqa, solqb, zqxfg
    _zicecld30 = zicecld  # in-cloud ice as of section 3.0, read by 3.7

    def _precip_active(ops):
        solqa = [row[:] for row in _sqa0]
        solqb = [row[:] for row in _sqb0]
        zqxfg = list(_qf0)
        for m, n in _blk_a:
            if solqa[m][n] is None:
                solqa[m][n] = zero
        for m, n in _blk_b:
            if solqb[m][n] is None:
                solqb[m][n] = zero
        zcovptot = carry["zcovptot"]

        dep_m = (ztp1 < RTT) & (zqxfg[IL] > e.rlmin)
        if "zdep0" in x:
            # folded deposition (CLOUDSC_FOLD_DEP): the chain below up to the
            # raw amount, computed at load time in fp64 (satfold.dep_rows);
            # only the carry-dependent tail remains
            zinfactor, zdepos = x["zinfac"], x["zdep0"]
        else:
            zvpice = div(x["zfoeeice"] * RV, RD)
            zvpliq = zvpice * zfokoop
            zicenuclei = 1000.0 * torch.exp(
                12.96 * (zvpliq - zvpice) / zvpliq - 0.639
            )
            zinfactor = mn(div(zicenuclei, 15000.0), 1.0)
            if c.IDEPICE == 1:  # Rotstayn 2001 monodisperse (ref: 1519-1601)
                zadd = RLSTT * (rdiv(RLSTT, RV * ztp1) - 1.0) / (2.4e-2 * ztp1)
                zbdd = RV * ztp1 * pap / (2.21 * zvpice)
                zcvds = (
                    7.8
                    * (zicenuclei / zrho) ** 0.666
                    * (zvpliq - zvpice)
                    / (8.87 * (zadd + zbdd) * zvpice)
                )
                zice0 = mx(_zicecld30, zicenuclei * e.riceinit / zrho)
                zinew_b = 0.666 * zcvds * ptsphy + zice0 ** 0.666
                zinew = zinew_b * torch.sqrt(zinew_b)      # == zinew_b**1.5
                zdepos = mx(za * (zinew - zice0), 0.0)
            else:  # IDEPICE == 2: ice-PSD deposition (ref: 1608-1689)
                zice0 = mx(_zicecld30, zicenuclei * e.riceinit / zrho)
                zaplusb = (
                    e.rcl_apb1 * zvpice - e.rcl_apb2 * zvpice * ztp1
                    + pap * e.rcl_apb3 * (ztp1 * ztp1 * ztp1)
                )
                zcorrfac = torch.sqrt(1.0 / zrho)
                ztq = div(ztp1, 273.0)
                zcorrfac2 = ztq * torch.sqrt(ztq) * rdiv(393.0, ztp1 + 120.0)
                zpr02 = zrho * zice0 * e.rcl_const1i  # ZTCG = ZFACX1I = 1
                zterm1 = (
                    (zvpliq - zvpice) * ztp1 ** 2 * zvpice * zcorrfac2
                    * e.rcl_const2i / (zrho * zaplusb * zvpice)
                )
                zterm2 = (
                    0.65 * e.rcl_const6i * zpr02 ** e.rcl_const4i
                    + e.rcl_const3i * torch.sqrt(zcorrfac) * torch.sqrt(zrho)
                    * zpr02 ** e.rcl_const5i / torch.sqrt(zcorrfac2)
                )
                zdepos = mx(za * zterm1 * zterm2 * ptsphy, 0.0)
        ztopred = mn(
            zinfactor
            + (1.0 - zinfactor)
            * (e.rdepliqrefrate + div(zcldtopdist, e.rdepliqrefdepth)),
            1.0,
        )
        zdepos = mn(zdepos, zqxfg[IL])
        # cloud-top reduction for turbulence/nucleation/fallout (ref: 1581-1586)
        zdepos = zdepos * ztopred
        if "s37" not in c.skip:
            amt = madd(dep_m, zdepos)
            solqa[II][IL] = sadd(solqa[II][IL], amt)
            solqa[IL][II] = sadd(solqa[IL][II], -amt)
            zqxfg[II] = zqxfg[II] + amt
            zqxfg[IL] = zqxfg[IL] - amt

        # ==============================================================
        # 4. PRECIPITATION PROCESSES
        # ==============================================================
        # revised in-cloud condensate (ref: 1700-1705)
        ztmpa = 1.0 / mx(za, ZEPSEC)
        zliqcld = zqxfg[IL] * ztmpa
        zicecld = zqxfg[II] * ztmpa

        # 4.2 sedimentation fall source applied to the first guess
        # (ref: 1714-1726)
        zqpretot = zero
        for m in (II, IR, IS):
            zqxfg[m] = zqxfg[m] + zfallsrce[m]
            zqpretot = zqpretot + madd(not_first, zqxfg[m])

        # 4.3p precip cover overlap, MAX-RAN (ref: 1767-1784)
        has_pre = zqpretot > ZEPSEC
        zcovptot_new = 1.0 - (
            (1.0 - zcovptot)
            * (1.0 - mx(za, x["za_prev"]))
            / (1.0 - mn(x["za_prev"], 1.0 - 1.0e-6))
        )
        zcovptot = torch.where(has_pre, mx(zcovptot_new, e.rcovpmin), 0.0)
        zcovpclr = torch.where(has_pre, mx(0.0, zcovptot - za), 0.0)
        covp_safe = torch.where(has_pre, zcovptot, 1.0)
        zraincld = torch.where(has_pre, zqxfg[IR] / covp_safe, 0.0)
        zsnowcld = torch.where(has_pre, zqxfg[IS] / covp_safe, 0.0)
        zcovpmax = torch.where(has_pre, mx(zcovptot, carry["zcovpmax"]), 0.0)

        snow_m = (ztp1 <= RTT) & (zicecld > ZEPSEC)
        liq_m = zliqcld > ZEPSEC
        rime_m = (ztp1 <= RTT) & (zliqcld > ZEPSEC)
        zfallcorr = rdiv(e.rdensref, zrho) ** 0.4
        rime2 = rime_m & (zsnowcld > ZEPSEC) & (zcovptot > 0.01)
        zicetot = zqxfg[II] + zqxfg[IS]
        melt_m = (zicetot > ZEPSEC) & (ztp1 > RTT)
        frz_cold = rain_p & (ztp1 < RTT)

        # 4.3a snow autoconversion, Lin et al. 1983 (ref: 1789-1811)
        zzco = ptsphy * e.rsnowlin1 * torch.exp(e.rsnowlin2 * (ztp1 - RTT))
        if c.LAERICEAUTO:
            zlcrit = x["picrit_aer"]
            zzco = zzco * rdiv(e.rnice, x["pnice"]) ** 0.333
        else:
            zlcrit = e.rlcritsnow
        zsnowaut = zzco * (1.0 - torch.exp(-((zicecld / zlcrit if torch.is_tensor(zlcrit) else div(zicecld, zlcrit)) ** 2)))
        if "s43a" not in c.skip:
            solqb[IS][II] = sadd(solqb[IS][II], madd(snow_m, zsnowaut))

        # 4.3b warm-rain autoconversion/accretion (ref: 1819-1927)
        if c.IWARMRAIN == 1:  # Sundqvist (1989), implicit (ref: 1826-1874)
            zzco = e.rkconv * ptsphy
            if c.LAERLIQAUTOLSP:
                zlcrit = x["plcrit_aer"]
                zzco = zzco * rdiv(e.rccn, x["pccn"]) ** 0.333
            else:
                zlcrit = sel2(land, e.rclcrit_land, e.rclcrit_sea, ztp1)
            zprecip = (pfplsx_row[IS] + pfplsx_row[IR]) / mx(ZEPSEC, zcovptot)
            pr_pos = zprecip > 0.0
            pr_sqrt = torch.where(
                pr_pos, torch.sqrt(torch.where(pr_pos, zprecip, 1.0)), 0.0
            )
            zcfpr = 1.0 + e.rprc1 * pr_sqrt
            if c.LAERLIQCOLL:
                zcfpr = zcfpr * rdiv(e.rccn, x["pccn"]) ** 0.333
            zzco = zzco * zcfpr
            zlcrit = zlcrit / mx(zcfpr, ZEPSEC)
            # exp guarded against overflow for large arguments (ref: 1864-1868)
            zarg = zliqcld / zlcrit
            zrainaut = torch.where(
                zarg < 20.0, zzco * (1.0 - torch.exp(-(zarg * zarg))), zzco,
            )
            cold = ztp1 <= RTT
            solqb[IS][IL] = sadd(solqb[IS][IL], madd(liq_m & cold, zrainaut))
            solqb[IR][IL] = sadd(solqb[IR][IL], madd(liq_m & ~cold, zrainaut))
        elif c.IWARMRAIN == 2:  # Khairoutdinov and Kogan (2000)
            zconst_pow = sel2(
                land,
                e.rcl_kk_cloud_num_land ** e.rcl_kkbaun,
                e.rcl_kk_cloud_num_sea ** e.rcl_kkbaun,
                ztp1,
            )
            zlcrit = sel2(land, e.rclcrit_land, e.rclcrit_sea, ztp1)
            above = zliqcld > zlcrit
            zrainaut = (
                1.5 * za * ptsphy
                * e.rcl_kkaau
                * mx(zliqcld, 0.0) ** e.rcl_kkbauq
                * zconst_pow
            )
            zrainaut = mn(zrainaut, zqxfg[IL])
            zrainaut = torch.where(zrainaut < ZEPSEC, 0.0, zrainaut)
            zrainacc = (
                2.0 * za * ptsphy
                * e.rcl_kkaac
                * mx(zliqcld * zraincld, 0.0) ** e.rcl_kkbac
            )
            zrainacc = mn(zrainacc, zqxfg[IL])
            zrainacc = torch.where(zrainacc < ZEPSEC, 0.0, zrainacc)
            zrainaut = torch.where(above, zrainaut, 0.0)
            zrainacc = torch.where(above, zrainacc, 0.0)
            cold = ztp1 <= RTT
            if "s43b" not in c.skip:
                for dst, sel_c in ((IS, cold), (IR, ~cold)):
                    mm = liq_m & sel_c
                    solqa[dst][IL] = sadd(solqa[dst][IL], madd(mm, zrainaut))
                    solqa[dst][IL] = sadd(solqa[dst][IL], madd(mm, zrainacc))
                    solqa[IL][dst] = sadd(solqa[IL][dst], -madd(mm, zrainaut))
                    solqa[IL][dst] = sadd(solqa[IL][dst], -madd(mm, zrainacc))
        else:
            raise NotImplementedError(f"IWARMRAIN={c.IWARMRAIN} unknown")

        # riming: snow collects cloud liquid (ref: 1935-1980)
        rime_base = mx(zrho * zsnowcld * e.rcl_const1s, 0.0)
        rime_pos = rime_base > 0.0
        rime_pow = torch.where(
            rime_pos,
            torch.where(rime_pos, rime_base, 1.0) ** e.rcl_const8s,
            0.0,
        )
        zsnowrime = (
            0.3 * zcovptot * ptsphy * e.rcl_const7s * zfallcorr * rime_pow
        )
        zsnowrime = mn(zsnowrime, 1.0)
        if "s43c" not in c.skip:
            solqb[IS][IL] = sadd(solqb[IS][IL], madd(rime2, zsnowrime))

        # 4.4a melting of snow and ice (ref: 1990-2034)
        zsubsat = mx(zqsice - zqx[IV], 0.0)
        ztdmtw0 = ztp1 - RTT - zsubsat * (
            ZTW1 + ZTW2 * (pap - ZTW3) - ZTW4 * (ztp1 - ZTW5)
        )
        zcons1 = torch.abs(div(ptsphy * (1.0 + 0.5 * ztdmtw0), e.rtaumel))
        zmeltmax = madd(melt_m, mx(ztdmtw0 * zcons1 * zrldcp, 0.0))
        if "s44a" not in c.skip:
            for m in (II, IS):
                n = IMELT[m]
                mm = (zmeltmax > ZEPSEC) & (zicetot > ZEPSEC)
                zalfa_m = zqxfg[m] / torch.where(mm, zicetot, 1.0)
                zmelt = mn(zqxfg[m], zalfa_m * zmeltmax)
                amt = madd(mm, zmelt)
                zqxfg[m] = zqxfg[m] - amt
                zqxfg[n] = zqxfg[n] + amt
                solqa[n][m] = sadd(solqa[n][m], amt)
                solqa[m][n] = sadd(solqa[m][n], -amt)

        # 4.4c freezing of liquid (ref: 2099-2112)
        zfrzmax = mx((e.rthomo - ztp1) * zrldcp, 0.0)
        frz_m = (zfrzmax > ZEPSEC) & (zqxfg[IL] > ZEPSEC)
        zfrz = mn(zqxfg[IL], zfrzmax)
        if "s44c" not in c.skip:
            amt = madd(frz_m, zfrz)
            solqa[II][IL] = sadd(solqa[II][IL], amt)
            solqa[IL][II] = sadd(solqa[IL][II], -amt)

        # ---- rain sub-branch: 4.4b freezing + 4.5 rain evaporation ------
        rain_m2 = rain_p | (zqxfg[IR] > ZEPSEC)
        _rsqa0 = [solqa[IS][IR], solqa[IR][IS], solqa[IV][IR], solqa[IR][IV]]

        def _rain_active(ops):
            sa_sr, sa_rs, sa_vr, sa_rv, covp, qf_r = ops
            # 4.4b freezing of rain (ref: 2039-2094)
            lam_den = torch.where(rain_p, zrho * zqx[IR], 1.0)
            zlambda_c6 = rdiv(e.rcl_fac1, lam_den) ** (e.rcl_fac2 * e.rcl_const6r)
            ztemp = e.rcl_fzrab * (ztp1 - RTT)
            zfrz_het = (
                ptsphy * rdiv(e.rcl_const5r, zrho)
                * (torch.exp(ztemp) - 1.0)
                * zlambda_c6
            )
            zfrzmax_liq = mx(zfrz_het, 0.0)
            zcons1f = torch.abs(div(ptsphy * (1.0 + 0.5 * (RTT - ztp1)), e.rtaumel))
            zfrzmax_mix = mx((RTT - ztp1) * zcons1f * zrldcp, 0.0)
            zfrzmax = torch.where(llrainliq, zfrzmax_liq, zfrzmax_mix)
            frz_m = frz_cold & (zfrzmax > ZEPSEC)
            zfrz = mn(zqx[IR], zfrzmax)
            if "s44b" not in c.skip:
                amt = madd(frz_m, zfrz)
                sa_sr = sadd(sa_sr, amt)
                sa_rs = sadd(sa_rs, -amt)

            # 4.5 rain evaporation (ref: 2114-2281)
            if c.IEVAPRAIN == 1:  # Sundqvist scheme (ref: 2121-2184)
                zzrh = e.rprecrhmax + (
                    1.0 - e.rprecrhmax
                ) * zcovpmax / mx(ZEPSEC, 1.0 - za)
                zzrh = mn(mx(zzrh, e.rprecrhmax), 1.0)
                zqe = (zqx[IV] - za * zqsliq) / mx(ZEPSEC, 1.0 - za)
                zqe = mx(0.0, mn(zqe, zqsliq))
                llo1 = (
                    (zcovpclr > ZEPSEC)
                    & (qf_r > ZEPSEC)
                    & (zqe < zzrh * zqsliq)
                )
                denom = covp * zdtgdp
                denom = torch.sign(denom) * mx(torch.abs(denom), zepsilon)
                denom = torch.where(denom == 0.0, zepsilon, denom)
                zpreclr = qf_r * zcovpclr / denom
                zbeta1 = (
                    div(torch.sqrt(pap / paph_surf), e.rvrfactor)
                    * zpreclr
                    / mx(zcovpclr, ZEPSEC)
                )
                b1_pos = zbeta1 > 0.0
                b1_pow = torch.where(
                    b1_pos, torch.where(b1_pos, zbeta1, 1.0) ** 0.5777, 0.0
                )
                zbeta = RG * e.rpecons * 0.5 * b1_pow
                zdenom = 1.0 + zbeta * ptsphy * zcorqsliq
                zdpr = zcovpclr * zbeta * (zqsliq - zqe) / zdenom * zdp * zrg_r
                zdpevap = zdpr * zdtgdp
                zevap = mn(zdpevap, qf_r)
                if "s45r" not in c.skip:
                    amt = madd(llo1, zevap)
                    sa_vr = sadd(sa_vr, amt)
                    sa_rv = sadd(sa_rv, -amt)
                    covp = torch.where(
                        llo1,
                        mx(
                            e.rcovpmin,
                            covp - mx(
                                0.0,
                                (covp - za) * zevap
                                / torch.where(llo1, qf_r, 1.0),
                            ),
                        ),
                        covp,
                    )
                    qf_r = qf_r - amt
            elif c.IEVAPRAIN == 2:
                zzrh = e.rprecrhmax + (
                    1.0 - e.rprecrhmax
                ) * zcovpmax / mx(ZEPSEC, 1.0 - za)
                zzrh = mn(mx(zzrh, e.rprecrhmax), 1.0)
                zzrh = mn(0.8, zzrh)
                zqe = mx(0.0, mn(zqx[IV], zqsliq))
                llo1 = (
                    (zcovpclr > ZEPSEC)
                    & (qf_r > ZEPSEC)
                    & (zqe < zzrh * zqsliq)
                )
                zpreclr = qf_r / torch.where(llo1, covp, 1.0)
                zesatliq = RV / RD * x["zfoeeliq"]
                lam_den = torch.where(llo1, zrho * zpreclr, 1.0)
                lam_base = rdiv(e.rcl_fac1, lam_den)
                zevap_denom = (
                    e.rcl_cdenom1 * zesatliq
                    - e.rcl_cdenom2 * ztp1 * zesatliq
                    + e.rcl_cdenom3 * (ztp1 * ztp1 * ztp1) * pap
                )
                ztq = div(ztp1, 273.0)
                zcorr2 = ztq * torch.sqrt(ztq) * 393.0 / (ztp1 + 120.0)
                zsubsat = mx(zzrh * zqsliq - zqe, 0.0)
                zbeta = (
                    rdiv(0.5, zqsliq) * ztp1 ** 2 * zesatliq
                    * e.rcl_const1r
                    * (zcorr2 / zevap_denom)
                    * (
                        rdiv(0.78, lam_base ** (e.rcl_fac2 * e.rcl_const4r))
                        + e.rcl_const2r
                        * torch.sqrt(zrho * zfallcorr)
                        / (
                            torch.sqrt(zcorr2)
                            * lam_base ** (e.rcl_fac2 * e.rcl_const3r)
                        )
                    )
                )
                zdenom = 1.0 + zbeta * ptsphy
                zdpevap = zcovpclr * zbeta * ptsphy * zsubsat / zdenom
                zevap = mn(zdpevap, qf_r)
                if "s45r" not in c.skip:
                    amt = madd(llo1, zevap)
                    sa_vr = sadd(sa_vr, amt)
                    sa_rv = sadd(sa_rv, -amt)
                    covp = torch.where(
                        llo1,
                        mx(
                            e.rcovpmin,
                            covp - mx(
                                0.0,
                                (covp - za) * zevap
                                / torch.where(llo1, qf_r, 1.0),
                            ),
                        ),
                        covp,
                    )
                    qf_r = qf_r - amt
            else:
                raise NotImplementedError(f"IEVAPRAIN={c.IEVAPRAIN} unknown")
            return (sa_sr, sa_rs, sa_vr, sa_rv, covp, qf_r)

        (
            solqa[IS][IR], solqa[IR][IS], solqa[IV][IR], solqa[IR][IV],
            zcovptot, zqxfg[IR],
        ) = inert_skip(
            rain_m2,
            _rain_active,
            (
                *(zero if v is None else v for v in _rsqa0),
                zcovptot,
                zqxfg[IR],
            ),
            force=force_on,
            tag="rain",
        )

        # 4.5 snow sublimation (ref: 2289-2419)
        if c.IEVAPSNOW == 1:  # Sundqvist
            zzrh = e.rprecrhmax + (1.0 - e.rprecrhmax) * zcovpmax / mx(
                ZEPSEC, 1.0 - za
            )
            zzrh = mn(mx(zzrh, e.rprecrhmax), 1.0)
            zqe = (zqx[IV] - za * zqsice) / mx(ZEPSEC, 1.0 - za)
            zqe = mx(0.0, mn(zqe, zqsice))
            llo1 = (
                (zcovpclr > ZEPSEC)
                & (zqxfg[IS] > ZEPSEC)
                & (zqe < zzrh * zqsice)
            )
            denom = zcovptot * zdtgdp
            denom = torch.sign(denom) * mx(torch.abs(denom), zepsilon)
            denom = torch.where(denom == 0.0, zepsilon, denom)
            zpreclr = zqxfg[IS] * zcovpclr / denom
            zbeta1 = (
                div(torch.sqrt(pap / paph_surf), e.rvrfactor)
                * zpreclr
                / mx(zcovpclr, ZEPSEC)
            )
            b1_pos = zbeta1 > 0.0
            b1_pow = torch.where(
                b1_pos, torch.where(b1_pos, zbeta1, 1.0) ** 0.5777, 0.0
            )
            zbeta = RG * e.rpecons * b1_pow
            zdenom = 1.0 + zbeta * ptsphy * zcorqsice
            zdpr = zcovpclr * zbeta * (zqsice - zqe) / zdenom * zdp * zrg_r
            zdpevap = zdpr * zdtgdp
            zevap = mn(zdpevap, zqxfg[IS])
            if "s45s" not in c.skip:
                amt = madd(llo1, zevap)
                solqa[IV][IS] = sadd(solqa[IV][IS], amt)
                solqa[IS][IV] = sadd(solqa[IS][IV], -amt)
                zcovptot = torch.where(
                    llo1,
                    mx(
                        e.rcovpmin,
                        zcovptot - mx(
                            0.0,
                            (zcovptot - za) * zevap
                            / torch.where(llo1, zqxfg[IS], 1.0),
                        ),
                    ),
                    zcovptot,
                )
                zqxfg[IS] = zqxfg[IS] - amt
        elif c.IEVAPSNOW == 2:  # PSD-based sublimation (ref: 2349-2419)
            zzrh = e.rprecrhmax + (1.0 - e.rprecrhmax) * zcovpmax / mx(
                ZEPSEC, 1.0 - za
            )
            zzrh = mn(mx(zzrh, e.rprecrhmax), 1.0)
            zqe = (zqx[IV] - za * zqsice) / mx(ZEPSEC, 1.0 - za)
            zqe = mx(0.0, mn(zqe, zqsice))
            llo1 = (
                (zcovpclr > ZEPSEC)
                & (zqx[IS] > ZEPSEC)
                & (zqe < zzrh * zqsice)
            )
            zpreclr = zqx[IS] / torch.where(llo1, mx(zcovptot, ZEPSEC), 1.0)
            zvpice2 = div(x["zfoeeice"] * RV, RD)
            # ZTCG = ZFACX1S = 1 (ref: 2382-2387)
            zaplusb = (
                e.rcl_apb1 * zvpice2 - e.rcl_apb2 * zvpice2 * ztp1
                + pap * e.rcl_apb3 * (ztp1 * ztp1 * ztp1)
            )
            zcorrfac = torch.sqrt(1.0 / zrho)
            ztq = div(ztp1, 273.0)
            zcorrfac2 = ztq * torch.sqrt(ztq) * rdiv(393.0, ztp1 + 120.0)
            zpr02 = zrho * zpreclr * e.rcl_const1s
            zterm1 = (
                (zqsice - zqe) * ztp1 ** 2 * zvpice2 * zcorrfac2
                * e.rcl_const2s / (zrho * zaplusb * zqsice)
            )
            p2_pos = zpr02 > 0.0
            zpr02s = torch.where(p2_pos, zpr02, 1.0)
            zterm2 = (
                0.65 * e.rcl_const6s
                * torch.where(p2_pos, zpr02s ** e.rcl_const4s, 0.0)
                + e.rcl_const3s * torch.sqrt(zcorrfac) * torch.sqrt(zrho)
                * torch.where(p2_pos, zpr02s ** e.rcl_const5s, 0.0)
                / torch.sqrt(zcorrfac2)
            )
            zdpevap = mx(zcovpclr * zterm1 * zterm2 * ptsphy, 0.0)
            zevaplimice = mx((zqsice - zqx[IV]) / zcorqsice, 0.0)
            zevap = mn(zdpevap, zevaplimice)
            zevap = mn(zevap, zqx[IS])
            amt = madd(llo1, zevap)
            solqa[IV][IS] = sadd(solqa[IV][IS], amt)
            solqa[IS][IV] = sadd(solqa[IS][IV], -amt)
            zcovptot = torch.where(
                llo1,
                mx(
                    e.rcovpmin,
                    zcovptot - mx(
                        0.0,
                        (zcovptot - za) * zevap
                        / torch.where(llo1, zqx[IS], 1.0),
                    ),
                ),
                zcovptot,
            )
            zqxfg[IS] = zqxfg[IS] - amt
        else:
            raise NotImplementedError(f"IEVAPSNOW={c.IEVAPSNOW} unknown")

        # 4.6 evaporate small precipitation amounts (ref: 2426-2435)
        if "s46" not in c.skip:
            for m in (IR, IS):
                small = zqxfg[m] < e.rlmin
                solqa[IV][m] = sadd(solqa[IV][m], madd(small, zqxfg[m]))
                solqa[m][IV] = sadd(solqa[m][IV], -madd(small, zqxfg[m]))

        # ==============================================================
        # 5.2.1 conservation scaling of explicit sinks (ref: 2467-2580):
        # lexicographic (ratio, species) ranks from pairwise comparisons,
        # identical to the sequential first-minimum scan, then lazily
        # applied per-round factors (see the JAX module)
        # ==============================================================
        zsinksum = [
            schain([sneg(solqa[m][n]) for n in range(NCLV)]) for m in range(NCLV)
        ]
        zmax = [mx(zqx[m], ZEPSEC) for m in range(NCLV)]

        def _no_overshoot():
            return all(bool((zsinksum[m] <= zmax[m]).all()) for m in range(NCLV))

        sq_idx = [
            (m, n) for m in range(NCLV) for n in range(NCLV)
            if solqa[m][n] is not None
        ]

        def _rescale_sinks(vals):
            sq = [[None] * NCLV for _ in range(NCLV)]
            for (m, n), v in zip(sq_idx, vals):
                sq[m][n] = v
            zratio = [zmax[m] / mx(zsinksum[m], zmax[m]) for m in range(NCLV)]
            iz = torch.zeros_like(ztp1, dtype=torch.int32)
            rank = []
            for m in range(NCLV):
                r = iz
                for n in range(NCLV):
                    if n == m:
                        continue
                    if n < m:
                        r = r + (zratio[n] <= zratio[m]).to(torch.int32)
                    else:
                        r = r + (zratio[n] < zratio[m]).to(torch.int32)
                rank.append(r)
            neg0 = [
                [None if sq[m][n] is None else sq[m][n] < 0.0
                 for n in range(NCLV)]
                for m in range(NCLV)
            ]
            # prec[m][n]: entry (m, n) receives species-n's column factor
            # BEFORE species-m's own round
            prec = [
                [
                    None if (n == m or neg0[n][m] is None)
                    else (neg0[n][m] & (rank[n] < rank[m]))
                    for n in range(NCLV)
                ]
                for m in range(NCLV)
            ]
            one = torch.ones_like(ztp1)
            # round 0 reuses the ordering ratio (bitwise the same sums)
            ratio_fin = [
                torch.where(rank[m] == 0, zratio[m], one) for m in range(NCLV)
            ]
            # per-round skip (s521_round_skip; see the JAX module): a species
            # whose negative entries alone stay within zmax can never
            # overshoot, whatever factors the earlier rounds apply, and its
            # round is then the identity (ratio zmax / zmax == 1); a round
            # whose species carries that guarantee in every column is skipped
            never_over = None
            if c.s521_round_skip:
                never_over = []
                for m in range(NCLV):
                    npart = None
                    for n in range(NCLV):
                        if sq[m][n] is not None:
                            npart = sadd(npart, madd(sq[m][n] < 0.0, -sq[m][n]))
                    never_over.append(
                        torch.ones_like(ztp1, dtype=torch.bool)
                        if npart is None else npart <= zmax[m])
            for round_i in range(1, NCLV):
                if c.s521_round_skip:
                    unsafe = None
                    for m in range(NCLV):
                        u = (rank[m] == round_i) & ~never_over[m]
                        unsafe = u if unsafe is None else unsafe | u
                    if probe_hook is not None:
                        probe_hook(f"s521r{round_i}", unsafe)
                    if not (force_on or bool(unsafe.any())):
                        continue
                sel = [rank[m] == round_i for m in range(NCLV)]
                num = None
                den = None
                for m in range(NCLV):
                    sink = None
                    for n in range(NCLV):
                        if sq[m][n] is None:
                            continue
                        v = sq[m][n]
                        if prec[m][n] is not None:
                            v = v * torch.where(prec[m][n], ratio_fin[n], 1.0)
                        sink = sadd(sink, -v)
                    num = sadd(num, madd(sel[m], zmax[m]))
                    den = sadd(den, madd(sel[m], mx(sink, zmax[m])))
                ratio_sel = num / den
                for m in range(NCLV):
                    ratio_fin[m] = torch.where(sel[m], ratio_sel, ratio_fin[m])
            out = []
            for m, n in sq_idx:
                v = sq[m][n]
                if neg0[m][n] is not None:
                    v = v * torch.where(neg0[m][n], ratio_fin[m], 1.0)
                if neg0[n][m] is not None:
                    v = v * torch.where(neg0[n][m], ratio_fin[n], 1.0)
                out.append(v)
            return tuple(out)

        if "s521" not in c.skip:
            vals0 = tuple(solqa[m][n] for m, n in sq_idx)
            if probe_hook is not None:
                over = None
                for m in range(NCLV):
                    o = zsinksum[m] > zmax[m]
                    over = o if over is None else over | o
                probe_hook("s521", over)
            if force_on or not _no_overshoot():
                scaled = _rescale_sinks(vals0)
            else:
                scaled = vals0
            for (m, n), v in zip(sq_idx, scaled):
                solqa[m][n] = v

        # ==============================================================
        # 5.2.2 implicit 5x5 solve (LHS build + non-pivoting LU,
        #       ref: 2589-2668) — unrolled with structural zeros skipped
        # ==============================================================
        one = torch.ones_like(ztp1)
        qlhs = [[None] * NCLV for _ in range(NCLV)]
        for mcol in range(NCLV):
            diag = sadd(one, zfallsink[mcol])
            for o in range(NCLV):
                diag = sadd(diag, solqb[o][mcol])
            qlhs[mcol][mcol] = diag
        for nrow in range(NCLV):
            for mcol in range(NCLV):
                if nrow != mcol:
                    qlhs[nrow][mcol] = sneg(solqb[nrow][mcol])
        zqxn = [
            zqx[m]
            + chain([solqa[m][n] for n in range(NCLV) if solqa[m][n] is not None])
            for m in range(NCLV)
        ]
        if "s522" not in c.skip:
            for jn in range(NCLV - 1):
                for jm in range(jn + 1, NCLV):
                    if qlhs[jm][jn] is None:
                        continue
                    qlhs[jm][jn] = qlhs[jm][jn] / qlhs[jn][jn]
                    for ik in range(jn + 1, NCLV):
                        if qlhs[jn][ik] is None:
                            continue
                        qlhs[jm][ik] = sadd(
                            qlhs[jm][ik], -(qlhs[jm][jn] * qlhs[jn][ik])
                        )
            # backsubstitution (ref: 2654-2668)
            for jn in range(1, NCLV):
                for jm in range(jn):
                    if qlhs[jn][jm] is not None:
                        zqxn[jn] = zqxn[jn] - qlhs[jn][jm] * zqxn[jm]
            zqxn[NCLV - 1] = zqxn[NCLV - 1] / qlhs[NCLV - 1][NCLV - 1]
            for jn in range(NCLV - 2, -1, -1):
                for jm in range(jn + 1, NCLV):
                    if qlhs[jn][jm] is not None:
                        zqxn[jn] = zqxn[jn] - qlhs[jn][jm] * zqxn[jm]
                zqxn[jn] = zqxn[jn] / qlhs[jn][jn]

        # clip small/negative values to vapour (ref: 2673-2680)
        for n in (IL, II, IR, IS):
            neg_n = zqxn[n] < ZEPSEC
            zqxn[IV] = zqxn[IV] + madd(neg_n, zqxn[n])
            zqxn[n] = torch.where(neg_n, 0.0, zqxn[n])

        # 5.3 precipitation flux to the next level (ref: 2698-2712)
        pfplsx_next = [
            zero if zfallsink[m] is None else zfallsink[m] * zqxn[m] * zrdtgdp
            for m in range(NCLV)
        ]
        zqpre2 = pfplsx_next[IS] + pfplsx_next[IR]
        zcovptot = torch.where(zqpre2 < ZEPSEC, 0.0, zcovptot)

        # 6. tendencies (ref: 2722-2773)
        tend_t = x["tend_t_pre"]
        for m in (IL, II, IR, IS):
            sinks = sadd(zfallsink[m], zconvsink[m])
            zfluxq = sadd(
                sadd(sadd(zpsupsatsrce[m], zconvsrce[m]), zfallsrce[m]),
                None if sinks is None else -(sinks * zqxn[m]),
            )
            lat = RALVDCP if IPHASE[m] == 1 else RALSDCP
            tend_t = tend_t + lat * (zqxn[m] - zqx[m] - zfluxq) * zqtmst
        tend_q = x["tend_q_pre"] + (zqxn[IV] - zqx[IV]) * zqtmst

        return (*zqxn, *pfplsx_next, tend_t, tend_q, zcovptot, zcovpmax)

    # ==============================================================
    # 5.1 cloud-fraction solver (ref: 2446-2455)
    # ==============================================================
    zanew = mn((za + solac) / (1.0 + solab), 1.0)
    zanew = torch.where(zanew < e.ramin, 0.0, zanew)
    zda = zanew - x["zaorig"]

    _ops = (
        *zqx,
        *(zero,) * NCLV,
        x["tend_t_pre"],
        x["tend_q_pre"],
        carry["zcovptot"],
        zero,
    )
    _out = inert_skip(region_m, _precip_active, _ops, force=force_on,
                      tag="precip")
    zqxn = list(_out[:NCLV])
    pfplsx_next = list(_out[NCLV:2 * NCLV])
    tend_t, tend_q, zcovptot, zcovpmax = _out[2 * NCLV:]
    tend_a = zda * zqtmst

    new_carry = dict(
        zanewm1=zanew,
        zqxnm1=list(zqxn),
        pfplsx=pfplsx_next,
        zcovptot=zcovptot,
        zcovpmax=zcovpmax,
        zcldtopdist=zcldtopdist,
        llrainliq=llrainliq,
        prainfrac=prainfrac,
    )
    ys = dict(
        zqxn=list(zqxn),
        pfplsx_next=pfplsx_next,
        plude=plude_out,
        pcovptot=zcovptot,
        tend_t=tend_t,
        tend_q=tend_q,
        tend_a=tend_a,
    )
    return new_carry, ys
