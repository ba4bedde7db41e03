"""The port's serve engine on Whisper (``enc`` + ``dec``: each request's
frames encoded once at admission, the decoder's self-attention paged
beside its per-slot ``ctx_kv``) against ``repro.serve.ServeEngine``:
greedy tokens identical on 8 traces (parameter keys 7 and 11, trace
seeds 0-3), paged here in bf16 (jitted reference), binarized and at full
precision, with the
reference's counters; f32 in ``test_torch_encdec_serve_f32.py``, the
slot-dense layout (which encodes inside its prefill) in
``test_torch_encdec_dense*.py``, the rest of the tier in
``test_torch_encdec_tier.py``.  Prefix hits are keyed on the frames."""

import pytest

from test_torch_vlm_serve import (check_ctx_keys_the_prefix,  # noqa: F401
                                  check_tokens, params)

ENCDEC = "whisper-tiny"


@pytest.mark.parametrize("trace_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("key", [7, 11])
def test_bf16_paged_tokens_match_reference(params, key, trace_seed):
    check_tokens(params, ENCDEC + "+xnor", "bfloat16", key, trace_seed)


def test_frames_key_the_prefix_cache(params):
    check_ctx_keys_the_prefix(params, ENCDEC + "+xnor")


@pytest.mark.parametrize("trace_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("key", [7, 11])
def test_bf16_paged_full_precision_tokens_match_reference(params, key,
                                                          trace_seed):
    check_tokens(params, ENCDEC, "bfloat16", key, trace_seed)
