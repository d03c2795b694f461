"""The benchmark's inputs, made from `--seed`.

The dwarf's 100-column snapshot (`data/input.npz`, read with numpy) is the
source of every input. The seed sets, in this order:

  1. a permutation of the snapshot's columns;
  2. a relative perturbation of its state fields (temperature, humidity,
     cloud fraction and condensates, and their tendencies), one draw an
     element, at the amplitudes the configuration states;
  3. in the `resident` traffic, a second such draw for every element of
     every column of the run, made on the device, so that no two columns
     are equal.

Every field stays physical: water is never negative (a relative change
under 1 keeps the sign) and cloud fraction is clipped to [0, 1].

The field dict is the port's plain field dict (`make_inputs` keys and
dtypes: lower-case names, LDCUM bool, KTYPE int32, columns last in cyclic
order: column j of a share starting at column s takes snapshot column
(s + j) mod 100). Both sides get the same dict: the program steps on it, and
the reference reads it.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

SNAPSHOT = Path(__file__).resolve().parents[1] / "data" / "input.npz"
SCALARS_KEY = "__scalars__"
# parameter tables stored as fields: never permuted or expanded
TABLES = ("YRECLDP_RBETA", "YRECLDP_RBETAP1")

# the plain field dict: key -> snapshot name
FIELDS = (
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
    ("plcrit_aer", "PLCRIT_AER"), ("picrit_aer", "PICRIT_AER"),
    ("pre_ice", "PRE_ICE"), ("pccn", "PCCN"), ("pnice", "PNICE"),
)
FLAGS = (("ldcum", "LDCUM", torch.bool), ("ktype", "KTYPE", torch.int32))
# the snapshot's fields and scalars the dwarf's loader reads
LOADED = tuple(n for _, n in FIELDS) + tuple(n for _, n, _ in FLAGS) + (
    "TENDENCY_CML_T", "TENDENCY_CML_Q", "TENDENCY_CML_A",
    "TENDENCY_CML_CLD") + TABLES
# fields that must stay non-negative, and the one clipped to [0, 1]
NONNEGATIVE = ("PQ", "PCLV")
FRACTION = "PA"
DTYPES = {"fp32": torch.float32, "fp64": torch.float64}


def seed_key(seed: int) -> int:
    """The seed as a non-negative 64-bit integer (any whole number goes)."""
    return int(seed) % 2**64


def load_snapshot(path=SNAPSHOT) -> tuple[dict, dict]:
    """(fields, scalars) of a snapshot in the port's archive format."""
    with np.load(path, allow_pickle=False) as z:
        fields = {k: z[k] for k in z.files if k != SCALARS_KEY}
        scalars = json.loads(str(z[SCALARS_KEY]))
    return fields, scalars


def _per_column(name: str, a: np.ndarray, klon: int) -> bool:
    return name not in TABLES and a.ndim >= 1 and a.shape[-1] == klon


def _physical(name: str, a):
    """Clip what the perturbation may push out of its physical range."""
    if name == FRACTION:
        return a.clip(0.0, 1.0)
    if name in NONNEGATIVE:
        return a.clip(min=0.0)
    return a


def seeded_snapshot(fields: dict, scalars: dict, seed: int,
                    amplitude: dict) -> dict:
    """The snapshot's columns permuted and its state fields perturbed
    (steps 1 and 2): name -> numpy array at file width. `amplitude` maps a
    snapshot field to its relative amplitude (x * (1 + a*u), u uniform in
    [-1, 1], one draw an element, in fp64)."""
    klon = int(scalars["KLON"])
    rng = np.random.default_rng(seed_key(seed))
    perm = rng.permutation(klon)
    out = {k: (v[..., perm] if _per_column(k, v, klon) else v).copy()
           for k, v in fields.items()}
    for name in sorted(amplitude):
        a = np.asarray(out[name], np.float64)
        u = rng.uniform(-1.0, 1.0, size=a.shape)
        out[name] = _physical(name, a * (1.0 + amplitude[name] * u))
    return out


def write_snapshot(path, fields: dict, scalars: dict) -> None:
    """An archive the port's loader reads (every field an array, the
    scalars as JSON), uncompressed."""
    np.savez(path, **{k: np.asarray(v) for k, v in fields.items()},
             **{SCALARS_KEY: np.array(json.dumps(scalars))})


def field_dict(snap: dict, ncol: int, precision: str, device,
               start: int = 0, amplitude: dict | None = None,
               generator: torch.Generator | None = None) -> dict:
    """The plain field dict of columns [start, start + ncol) of the
    snapshot's cyclic expansion, made on `device`: the file-width arrays
    cross, the expansion is an index on the device. With `amplitude` and
    `generator`, step 3: every element of the state fields takes its own
    relative draw, made on the device in one call a field."""
    dtype = DTYPES[precision]
    klon = next(v.shape[-1] for k, v in snap.items() if k == "PT")
    idx = torch.arange(start, start + ncol, device=device) % klon

    def expand(name, to):
        t = torch.as_tensor(np.ascontiguousarray(snap[name])).to(device, to)
        return t.index_select(t.ndim - 1, idx)

    out = {}
    for key, name in FIELDS:
        t = expand(name, dtype)
        if amplitude and name in amplitude:
            u = torch.empty_like(t).uniform_(-1.0, 1.0, generator=generator)
            t = _physical(name, t * (1.0 + amplitude[name] * u))
            del u
        out[key] = t
    for key, name, to in FLAGS:
        out[key] = expand(name, to)
    return out


def share_generator(seed: int, share: int, device) -> torch.Generator:
    """The generator of step 3 for one share of the columns."""
    state = np.random.SeedSequence([seed_key(seed), share]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))
