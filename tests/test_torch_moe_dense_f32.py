"""``test_torch_moe_dense.py``'s token identity in f32: the slot-dense
layout on the mixture-of-experts archs against the reference's dense
engine on 8 traces."""

import pytest

from test_torch_moe_dense import DENSE_ARCHS
from test_torch_moe_serve import check_tokens, params  # noqa: F401


@pytest.mark.parametrize("trace_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("key", [7, 11])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_f32_dense_tokens_match_reference(params, arch, key, trace_seed):
    check_tokens(params, arch, "float32", key, trace_seed, paged=False)
