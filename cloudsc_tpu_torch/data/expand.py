"""Per-rank slicing, column expansion, grouped column order and activity
sorting.

Counterpart of `cloudsc_tpu/data/expand.py` (numpy only). The snapshot
holds KLON (=100) columns; a run of NGPTOT >> KLON columns tiles them
(ref: src/common/module/expand_mod.F90:237-334). The host pack writes each
source column's copies contiguously ("grouped"), a column permutation of
the cyclic layout; `group_inverse` maps the outputs back. Copies of a
source column are bitwise identical through the scheme, so any such
permutation is exact.
"""

from __future__ import annotations

import numpy as np


def get_offsets(klon_file: int, ngptot: int, ngptotg: int, rank: int,
                nranks: int) -> tuple[int, int]:
    """This rank's (start, count) in the file's columns. The file is cut
    between ranks only when it holds at least NGPTOTG columns, rank r from
    r * ceil(ngptotg / nranks); otherwise every rank reads all of it and
    tiles it, so a run on several ranks computes what one rank does
    (ref: expand_mod.F90:30-46, dwarf_cloudsc.F90:74-77)."""
    if klon_file >= ngptotg:
        share = (ngptotg - 1) // nranks + 1
        return rank * share, min(klon_file, ngptot)
    return 0, klon_file


def expand_field(field: np.ndarray, ngptot: int,
                 order: str = "cyclic") -> np.ndarray:
    """Tile the trailing (column) axis out to ngptot columns. "cyclic":
    dst col j <- src col j % klon (ref: expand_mod.F90:237-334); "grouped":
    each source column's copies contiguously, a column permutation of the
    cyclic layout (`group_inverse` maps back)."""
    klon = field.shape[-1]
    if klon == ngptot:
        return field
    if order == "grouped":
        return np.ascontiguousarray(
            np.repeat(field, group_counts(klon, ngptot), axis=-1))
    reps = -(-ngptot // klon)
    tiled = np.tile(field, (1,) * (field.ndim - 1) + (reps,))
    return np.ascontiguousarray(tiled[..., :ngptot])


def group_counts(klon: int, ncol: int) -> np.ndarray:
    """Multiplicity of each source column in the cyclic expansion to ncol:
    count_g = |{j in [0, ncol): j % klon == g}| = ceil((ncol - g) / klon)."""
    g = np.arange(klon, dtype=np.int64)
    return np.maximum(0, -(-(ncol - g) // klon))


def group_inverse(klon: int, ncol: int,
                  perm: np.ndarray | None = None) -> np.ndarray:
    """inv mapping canonical (cyclic) column j to a grouped-layout column
    holding the same source column (the first member of group j % klon).

    `perm` is the source-column permutation applied before the grouped
    expansion (activity sorting): group position p then holds source
    perm[p], and inv routes each canonical column to its source's position.
    Requires ncol >= klon so every source has at least one copy."""
    counts = group_counts(klon, ncol)
    off = np.concatenate([[0], np.cumsum(counts[:-1])])
    if perm is not None:
        if ncol < klon:
            raise ValueError("sorted grouping requires ncol >= klon")
        pos = np.empty(klon, dtype=np.int64)
        pos[np.asarray(perm, dtype=np.int64)] = np.arange(klon, dtype=np.int64)
        off = off[pos]
    return off[np.arange(ncol, dtype=np.int64) % klon].astype(np.int32)


def activity_perm(pclv: np.ndarray, tcld: np.ndarray, ptsphy: float,
                  rlmin: float, nshards: int = 1) -> np.ndarray:
    """Most-active-first ordering of the source columns (an argsort, so a
    pure permutation and bitwise neutral through the scheme).

    Key: the start-of-step condensates (PCLV + dt * TENDENCY_TMP_CLD, the
    section-1 state, ref: cloudsc.F90:669-682) mark the levels whose total
    condensate exceeds RLMIN; columns order by (levels from the topmost
    active level to the bottom, number of active levels), descending. On
    the card this puts columns with similar work side by side in a warp,
    so the per-thread skips diverge less.

    `nshards` > 1 (a column mesh: the driver cuts the layout into
    contiguous shares, one a device) deals the sorted sources round-robin
    over the shards, so every device gets a similar mix of activity and
    none is the straggler that holds all the busy columns."""
    q = np.asarray(pclv, np.float64)[:4] + float(ptsphy) * np.asarray(
        tcld, np.float64
    )[:4]
    act = np.maximum(q, 0.0).sum(axis=0) > rlmin        # (nlev, klon)
    nlev = act.shape[0]
    first = np.where(act.any(axis=0), act.argmax(axis=0), nlev)
    span = nlev - first
    order = np.lexsort((act.sum(axis=0), span))[::-1].astype(np.int64)
    if nshards > 1:
        order = np.concatenate([order[s::nshards] for s in range(nshards)])
    return order
