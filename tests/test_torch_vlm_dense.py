"""The slot-dense layout (``paged=False``: an exact-length prefill a
request, the context kept resident beside the per-slot ``ctx_kv``) on
Llama-3.2-Vision, binarized and at full precision, against the
reference's dense engine: greedy tokens identical on 8 traces in bf16,
jitted (``test_torch_vlm_dense_f32.py``: f32)."""

import pytest

from test_torch_vlm_serve import VLM, check_tokens, params  # noqa: F401


@pytest.mark.parametrize("trace_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("key", [7, 11])
def test_bf16_dense_tokens_match_reference(params, key, trace_seed):
    check_tokens(params, VLM, "bfloat16", key, trace_seed, paged=False)


@pytest.mark.parametrize("trace_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("key", [7, 11])
def test_bf16_dense_binarized_tokens_match_reference(params, key, trace_seed):
    check_tokens(params, VLM + "+xnor", "bfloat16", key, trace_seed,
                 paged=False)
