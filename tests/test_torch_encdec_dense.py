"""The slot-dense layout on Whisper, binarized and not (the frames encoded
inside the exact-length prefill; no context kept resident, the decoder's
``ctx_kv`` per slot) against the reference's dense engine: greedy tokens
identical on 8 traces in bf16, jitted (``test_torch_encdec_dense_f32.py``:
f32)."""

import pytest

from test_torch_vlm_serve import check_tokens, params  # noqa: F401
from test_torch_encdec_serve import ENCDEC


@pytest.mark.parametrize("trace_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("key", [7, 11])
def test_bf16_dense_tokens_match_reference(params, key, trace_seed):
    check_tokens(params, ENCDEC, "bfloat16", key, trace_seed, paged=False)


@pytest.mark.parametrize("trace_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("key", [7, 11])
def test_bf16_dense_binarized_tokens_match_reference(params, key, trace_seed):
    check_tokens(params, ENCDEC + "+xnor", "bfloat16", key, trace_seed,
                 paged=False)
