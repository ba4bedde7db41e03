"""``test_torch_moe_serve.py``'s token identity in f32: the port's paged
engine on the mixture-of-experts archs against the reference's on 8
traces (parameter keys 7 and 11, trace seeds 0-3)."""

import pytest

from test_torch_moe_serve import ARCHS, check_tokens, params  # noqa: F401


@pytest.mark.parametrize("trace_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("key", [7, 11])
@pytest.mark.parametrize("arch", ARCHS)
def test_f32_greedy_tokens_match_reference(params, arch, key, trace_seed):
    check_tokens(params, arch, "float32", key, trace_seed)
