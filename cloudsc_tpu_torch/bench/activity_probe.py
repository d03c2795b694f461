"""Guard activity of the dynamic skips, per (level, column) and per warp.

K1 runs one column a thread, so its dynamic skips (`scheme.inert_skip`'s
regions, the 5.2.1 no-overshoot case) are per-thread branches: a warp of 32
columns skips a region on a level only when none of its lanes is active
there, and pays for both sides when some lanes are and some are not. This
probe runs the port's eager engine (`physics.cloudsc`), in fp64, with
`scheme.probe_hook` set; the engine branches on the host, so the masks are
concrete (a nested guard is recorded only on the levels where its enclosing
branch ran, and counts as inactive on the others). For each guard it
reports:

  - the active share of (level, column) units (the best any per-column
    schedule could reach);
  - the share of levels with any active column (the batch-level rate);
  - with `--device cpu` (the JAX probe's mode: the 100 snapshot columns),
    the predicted fire rates at 163,840 columns for the cyclic, grouped and
    sorted layouts (`tile_rates`, the JAX probe's model), at the JAX
    kernel's (SB, 128) tile and at a 32-column warp, and for the warp the
    share of (warp, level) units where some but not all lanes are active:
    the divergent units K1 pays for;
  - with `--device cuda` (the default), the masks at `--ngptot` columns
    (default 163,840) in the driver's layout (grouped, activity-sorted
    columns), where the warp rates are measured, not modeled.

    python -m cloudsc_tpu_torch.bench.activity_probe [--ngptot N] [--out FILE]
    python -m cloudsc_tpu_torch.bench.activity_probe --device cpu   # 100 columns
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

LAYOUTS = ("cyclic", "grouped", "sorted")
WARP = 32
# the JAX kernel's column tile, SB x 128 lanes at its SB of 32
JAX_TILE = 32 * 128
# the main path's width: the columns of the modeled layouts (--device cpu)
# and those measured on the card by default
MODEL_NGPTOT = 163840


def _sorted_perm(inp, params, nshards: int = 1):
    from ..data.expand import activity_perm

    return activity_perm(inp.fields["PCLV"], inp.fields["TENDENCY_TMP_CLD"],
                         inp.ptsphy, params.ydecldp.rlmin, nshards=nshards)


def layout_sources(inp, params, ngptot: int, nshards: int = 1) -> dict:
    """layout -> the source column of each of `ngptot` expanded columns, for
    the cyclic, grouped and sorted layouts of data.expand."""
    from ..data.expand import group_counts

    klon = int(np.asarray(inp.fields["PT"]).shape[-1])
    counts = group_counts(klon, ngptot)
    out = {"cyclic": np.arange(ngptot, dtype=np.int64) % klon}
    for name in ("grouped", "sorted"):
        perm = (_sorted_perm(inp, params, nshards) if name == "sorted"
                else np.arange(klon, dtype=np.int64))
        out[name] = np.repeat(np.asarray(perm, np.int64), counts)
    return out


def unit_rates(a: np.ndarray, tile: int) -> tuple[float, float]:
    """(fire, divergent) over (tile, level) units of a (nlev, ncol) mask
    whose columns are cut into tiles of `tile`, the last edge-padded: the
    share where any column is active, and where some but not all are."""
    ncol = a.shape[1]
    pad = -ncol % tile
    if pad:
        a = np.concatenate([a, np.repeat(a[:, -1:], pad, axis=1)], axis=1)
    t = a.reshape(a.shape[0], -1, tile)
    anyv, allv = t.any(axis=2), t.all(axis=2)
    return float(anyv.mean()), float((anyv & ~allv).mean())


def tile_rates(a: np.ndarray, inp, params, ngptot: int = MODEL_NGPTOT,
               tile: int = JAX_TILE, nshards: int = 1) -> dict:
    """Predicted fire rate (share of (tile, level) units where any column of
    the tile is active) of each layout at `ngptot` columns, from the
    per-(level, source column) masks `a` (the JAX probe's model)."""
    return {name: unit_rates(a[:, src], tile)[0]
            for name, src in layout_sources(inp, params, ngptot,
                                            nshards).items()}


def warp_rates(a: np.ndarray, inp, params, ngptot: int = MODEL_NGPTOT,
               warp: int = WARP, nshards: int = 1) -> dict:
    """layout -> (fire, divergent) over (warp, level) units at `ngptot`
    columns, modeled from the per-(level, source column) masks `a`."""
    return {name: unit_rates(a[:, src], warp)
            for name, src in layout_sources(inp, params, ngptot,
                                            nshards).items()}


def record_masks(fields: dict, params, ptsphy, config=None) -> dict:
    """tag -> (levels, ncol) bool array: every guard `scheme.probe_hook`
    sees in one eager step of `physics.cloudsc` on `fields` (on their
    device). A nested guard's missing levels are appended as inactive (the
    enclosing branch skipped them); their position does not enter any
    rate."""
    from ..physics import cloudsc as engine
    from ..physics import scheme

    records: dict = {}

    def hook(tag, mask):
        records.setdefault(tag, []).append(mask.detach().clone())

    saved = scheme.probe_hook
    scheme.probe_hook = hook
    try:
        out = engine.cloudsc(fields, params, ptsphy, config)
    finally:
        scheme.probe_hook = saved
    if not bool(torch.isfinite(out.tendency_loc_t).all()):
        raise FloatingPointError("non-finite tendency in the probed step")
    nlev = max(len(v) for v in records.values())
    stacked = {}
    for tag, masks in records.items():
        a = torch.stack(masks).cpu().numpy()
        if a.shape[0] < nlev:
            a = np.concatenate(
                [a, np.zeros((nlev - a.shape[0], a.shape[1]), bool)])
        stacked[tag] = a
    return stacked


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m cloudsc_tpu_torch.bench.activity_probe",
        description="Guard activity of the dynamic skips.")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda measures the masks in the driver's layout; "
                        "cpu runs the JAX probe's modeled mode")
    p.add_argument("--ngptot", type=int, default=None,
                   help=f"columns (default {MODEL_NGPTOT} on the card, 100 "
                        f"with --device cpu)")
    p.add_argument("--sb", type=int, nargs="+", default=[32],
                   help="JAX tile heights to model (a tile is SB x 128)")
    p.add_argument("--nshards", type=int, default=1)
    p.add_argument("--out", default=None, help="write the records as JSON")
    a = p.parse_args(argv)
    if a.ngptot is None:
        a.ngptot = MODEL_NGPTOT if a.device == "cuda" else 100
    return a


def run(a) -> list[dict]:
    from .. import data
    from ..params import Params
    from ..physics.cloudsc import make_inputs

    inp = data.load_input(data.default_input_path(), a.ngptot)
    params = Params.from_input(inp)
    measured = a.device == "cuda"
    if measured:
        # the driver's layout: grouped columns in activity order
        fields = make_inputs(inp, torch.float64, column_order="grouped",
                             column_perm=_sorted_perm(inp, params,
                                                      a.nshards))
    else:
        fields = make_inputs(inp, torch.float64)
    fields = {k: v.to(a.device) for k, v in fields.items()}
    masks = record_masks(fields, params, inp.ptsphy)
    del fields
    records = []
    how = ("measured in the driver layout" if measured
           else f"modeled at {MODEL_NGPTOT}")
    print(f"# {a.device} fp64, {a.ngptot} columns ({how})")
    print(f"{'guard':>8} {'lev x col act%':>15} {'any-col lev act%':>17}")
    for tag, m in masks.items():
        rec = dict(tag=tag, device=a.device, precision="fp64",
                   ngptot=a.ngptot, active=float(m.mean()),
                   levels_any=float(m.any(axis=1).mean()))
        print(f"{tag:>8} {100 * rec['active']:>14.1f}% "
              f"{100 * rec['levels_any']:>16.1f}%")
        if measured:
            fire, div = unit_rates(m, WARP)
            tfire, _ = unit_rates(m, JAX_TILE)
            rec.update(warp_fire=fire, warp_divergent=div, tile_fire=tfire,
                       layout="sorted", measured=True)
            print(f"{'':>8} measured (sorted layout): warp-{WARP} fire "
                  f"{100 * fire:.1f}%, divergent {100 * div:.1f}%; "
                  f"{JAX_TILE}-column tile fire {100 * tfire:.1f}%")
        else:
            rec["tile"] = {}
            for sb in a.sb:
                rates = tile_rates(m, inp, params, MODEL_NGPTOT,
                                   tile=sb * 128, nshards=a.nshards)
                rec["tile"][sb * 128] = rates
                print(f"{'':>8} predicted (SB={sb})-tile fire rate: "
                      + "  ".join(f"{k} {100 * v:.1f}%"
                                  for k, v in rates.items()))
            w = warp_rates(m, inp, params, MODEL_NGPTOT,
                           nshards=a.nshards)
            rec["warp"] = {k: dict(fire=v[0], divergent=v[1])
                           for k, v in w.items()}
            rec["measured"] = False
            print(f"{'':>8} predicted warp-{WARP} fire / divergent: "
                  + "  ".join(f"{k} {100 * f:.1f}% / {100 * d:.1f}%"
                              for k, (f, d) in w.items()))
        records.append(rec)
    return records


def main(argv=None) -> int:
    a = parse_args(argv)
    if a.device == "cuda":
        from . import timing

        if not timing.require_cuda("activity_probe"):
            return 1
        timing.header("activity_probe")
    records = run(a)
    if a.out:
        Path(a.out).write_text(json.dumps(records, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
