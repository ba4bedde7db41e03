"""``test_torch_vlm_dense.py``'s token identity in f32, binarized and at
full precision: the slot-dense engine on Llama-3.2-Vision[+xnor] against
the reference's on 8 traces."""

import pytest

from test_torch_vlm_serve import VLM, check_tokens, params  # noqa: F401


@pytest.mark.parametrize("trace_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("key", [7, 11])
def test_f32_dense_tokens_match_reference(params, key, trace_seed):
    check_tokens(params, VLM + "+xnor", "float32", key, trace_seed,
                 paged=False)


@pytest.mark.parametrize("trace_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("key", [7, 11])
def test_f32_dense_full_precision_tokens_match_reference(params, key,
                                                         trace_seed):
    check_tokens(params, VLM, "float32", key, trace_seed, paged=False)
