"""K1's forms in fp32 on the CPU: the plain version for fc+fn+fd, each
single knob and fn off against the JAX package's Pallas kernel in
interpret mode on the same pack (test_torch_forms.py holds fp64).

torch's and XLA's CPU exp differ by an ulp in fp32, which flips threshold
branches and cancels in the flux sums, so rtol 1e-5 cannot hold between
the two fp32 engines (test_torch_kernel.py's test_plain_matches_pallas_
interpret says so for the main path's form); the forms are held to the
repo's fp32 engine guard instead: test_fp32_oracle's per-field p90 bound
and outlier fraction against the Pallas kernel's outputs. The folded and
in-line inputs differ pointwise at clip thresholds, so each form is held
against the Pallas kernel on its own form's pack.
"""

import numpy as np
import pytest
import torch

from test_torch_forms import FORMS, pallas_and_plain

torch.set_num_threads(1)


@pytest.mark.parametrize("form", list(FORMS))
def test_plain_form_matches_pallas_interpret_fp32(form, monkeypatch):
    from test_fp32_oracle import OUTLIER_FRAC_BOUND, P90_BOUND, _field_stats

    ref, out = pallas_and_plain(form, "float32", monkeypatch)
    for name in ref._fields:
        assert getattr(out, name).shape == getattr(ref, name).shape, name
        assert np.isfinite(getattr(out, name)).all(), name
    ref64 = type(ref)(*(np.asarray(a, np.float64) for a in ref))
    stats = _field_stats(ref64, out)
    bad = {name: s for name, s in stats.items()
           if not (s[0] <= P90_BOUND[name] and s[1] <= OUTLIER_FRAC_BOUND)}
    assert not bad, f"{form} fp32: plain version vs Pallas kernel: {bad}"
