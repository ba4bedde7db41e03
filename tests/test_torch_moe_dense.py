"""The slot-dense layout (``paged=False``: an exact-length prefill a
request, one dispatch group of the whole prompt) on the
mixture-of-experts archs against the reference's dense engine: greedy
tokens identical on 8 traces in bf16 (``test_torch_moe_dense_f32.py``:
f32).  The archs' quantization is swapped from the paged files:
moonshot-v1-16b-a3b at full precision, llama4-scout-17b-a16e
binarized."""

import pytest

from test_torch_moe_serve import check_tokens, params  # noqa: F401

DENSE_ARCHS = ["moonshot-v1-16b-a3b", "llama4-scout-17b-a16e+xnor"]


@pytest.mark.parametrize("trace_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("key", [7, 11])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_bf16_dense_tokens_match_reference(params, arch, key, trace_seed):
    check_tokens(params, arch, "bfloat16", key, trace_seed, paged=False)
