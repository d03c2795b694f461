"""K1's section skips on the CPU, the second eight of the 16 tags: the
plain version against the JAX package's scan engine under the same
SchemeConfig, as test_torch_skips.py holds the first eight.
"""

import pytest
import torch

from cloudsc_tpu_torch.physics import scheme as tscheme

from test_torch_skips import check_skip

torch.set_num_threads(1)


@pytest.mark.parametrize("tag", tscheme.SKIP_TAGS[8:])
def test_plain_skip_matches_jax_scan(params, tag):
    check_skip(params, tag)
