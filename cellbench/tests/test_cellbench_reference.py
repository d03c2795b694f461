"""The frozen reference against the dwarf's own golden outputs, and what it
and the harness import."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from cellbench import inputs, reference
from cellbench.run import FORBIDDEN

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
# the dwarf's fp64 bar: errsum / refsum a field (tests/test_golden.py)
FP64_TOL = 5.0e-14
# field name in the golden file
GOLDEN = {n: n.upper() for n in reference.Outputs._fields}


def test_reference_matches_the_dwarf_golden_outputs():
    fields, scalars = inputs.load_snapshot()
    params = reference.Params.from_snapshot(fields, scalars)
    d = inputs.field_dict(fields, int(scalars["KLON"]), "fp64", "cpu")
    out = reference.cloudsc(d, params, float(scalars["PTSPHY"]))
    with np.load(ROOT / "data" / "reference.npz") as z:
        for name in reference.Outputs._fields:
            got = getattr(out, name).numpy()
            ref = z[GOLDEN[name]]
            assert got.shape == ref.shape, name
            err = np.abs(got - ref).sum()
            refsum = np.abs(ref).sum()
            rel = err / refsum if refsum else err
            assert rel < FP64_TOL, (name, rel)


def test_reference_step_and_its_controls():
    """`step` is the scheme over the whole dict; its control arguments
    compute in another dtype or round the outputs through one."""
    fields, scalars = inputs.load_snapshot()
    params = reference.Params.from_snapshot(fields, scalars)
    ptsphy = float(scalars["PTSPHY"])
    d = inputs.field_dict(fields, 40, "fp32", "cpu")
    whole = reference.cloudsc(d, params, ptsphy)
    for w, p in zip(whole, reference.step(d, params, ptsphy, None)):
        assert torch.equal(w, p)
    stored = reference.step(d, params, ptsphy, None, store=torch.bfloat16)
    for w, p in zip(whole, stored):
        assert p.dtype == torch.float32
        assert torch.equal(p, w.to(torch.bfloat16).float())
    low = reference.step(inputs.field_dict(fields, 40, "fp64", "cpu"),
                         params, ptsphy, None, dtype=torch.float32)
    assert all(o.dtype == torch.float32 for o in low)


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    for path in sorted((PKG / "reference").glob("*.py")):
        bad = _imports(path) & (set(FORBIDDEN) | {"cloudsc_tpu_torch"})
        assert not bad, (path.name, bad)


def test_harness_never_imports_jax_or_the_top_level_bench():
    for path in sorted(PKG.rglob("*.py")):
        if "tests" in path.parts:
            continue
        bad = _imports(path) & (set(FORBIDDEN) | {"bench"})
        assert not bad, (path.relative_to(PKG), bad)


def test_reference_loads_no_forbidden_module_at_run_time():
    code = ("import json, sys; import cellbench.reference; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(json.loads(out))
    assert not loaded & (set(FORBIDDEN) | {"cloudsc_tpu_torch"})


def test_forbidden_names_are_compared_whole():
    from cellbench import run

    assert run.forbidden_modules(["cloudsc_tpu_torch", "cloudsc_tpu_torch.x",
                                  "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["cloudsc_tpu.physics", "jax.numpy",
                                  "jaxlib", "flax.linen"]) == [
        "cloudsc_tpu", "flax", "jax", "jaxlib"]
