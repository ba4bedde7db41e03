"""``test_torch_vlm_serve.py``'s token identity in f32: the port's paged
engine on Llama-3.2-Vision at full precision and binarized against the
reference's on 8 traces (parameter keys 7 and 11, trace seeds 0-3), each
request with its context."""

import pytest

from test_torch_vlm_serve import VLM, check_tokens, params  # noqa: F401


@pytest.mark.parametrize("trace_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("key", [7, 11])
def test_f32_paged_tokens_match_reference(params, key, trace_seed):
    check_tokens(params, VLM, "float32", key, trace_seed)


@pytest.mark.parametrize("trace_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("key", [7, 11])
def test_f32_paged_binarized_tokens_match_reference(params, key, trace_seed):
    check_tokens(params, VLM + "+xnor", "float32", key, trace_seed)
