"""The comparison that decides `correct`: what the timed path produced
against the plain reference, field by field, over every column.

Per field of the 21, in fp64 where the outputs lie: errsum = sum |got - ref|,
refsum = sum |ref|, maxerr = max |got - ref| and refmax = max |ref|. Two
numbers are compared, each against its limit from the configuration:

  rel_l1   the largest errsum / refsum over the fields (the dwarf's own
           measure of a field, ref: validate_mod.F90:273-283);
  rel_max  the largest maxerr / refmax over the fields: one column gone
           wrong reads here, where the sums would dilute it.

A field whose reference is zero everywhere reads 0 where the program gives
zero too, and infinity otherwise; a non-finite output reads infinity.
"""

from __future__ import annotations

import math

import torch

NUMBERS = ("rel_l1", "rel_max")


class Comparison:
    def __init__(self, names: tuple, limits: dict):
        missing = set(NUMBERS) - set(limits)
        if missing:
            raise ValueError(f"limits lack {sorted(missing)}")
        self.names = tuple(names)
        self.limits = {k: float(limits[k]) for k in NUMBERS}
        self.stats = {n: [0.0, 0.0, 0.0, 0.0] for n in self.names}
        self.columns = 0

    def add(self, got, ref) -> None:
        """Accumulate one share: `got` and `ref` are sequences of the 21
        fields over the same columns, in the same order."""
        rows = []
        for g, r in zip(got, ref, strict=True):
            g, r = g.double(), r.to(g.device).double()
            d = (g - r).abs()
            rows.append(torch.stack([d.sum(), r.abs().sum(),
                                     d.max(), r.abs().max()]))
        vals = torch.stack(rows).cpu().tolist()
        for n, (es, rs, me, rm) in zip(self.names, vals):
            s = self.stats[n]
            s[0] += es
            s[1] += rs
            s[2] = max(s[2], me) if not math.isnan(me) else math.nan
            s[3] = max(s[3], rm)
        self.columns += ref[0].shape[-1]

    @staticmethod
    def _ratio(err: float, ref: float) -> float:
        if not math.isfinite(err):
            return math.inf
        if ref == 0.0:
            return 0.0 if err == 0.0 else math.inf
        return err / ref

    def numbers(self) -> dict:
        """name -> (value, the field that sets it)."""
        out = {}
        for key, (i, j) in (("rel_l1", (0, 1)), ("rel_max", (2, 3))):
            per = {n: self._ratio(s[i], s[j]) for n, s in self.stats.items()}
            field = max(per, key=per.get)
            out[key] = (per[field], field)
        return out

    def correct(self) -> bool:
        return self.columns > 0 and all(
            v <= self.limits[k] for k, (v, _) in self.numbers().items())

    def report(self) -> dict:
        """What the result line carries last: each number, its field and
        its limit."""
        return {k: {"value": v, "limit": self.limits[k], "field": f}
                for k, (v, f) in self.numbers().items()}

    def lines(self) -> list[str]:
        return [f"compare {k} {v!r} limit {self.limits[k]!r} ({f}, "
                f"{self.columns} columns)"
                for k, (v, f) in self.numbers().items()]
