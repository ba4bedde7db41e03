"""``test_torch_encdec_serve.py``'s token identity in f32: the port's
paged engine on Whisper at full precision and binarized against the
reference's on 8 traces, each request with its frames."""

import pytest

from test_torch_vlm_serve import check_tokens, params  # noqa: F401
from test_torch_encdec_serve import ENCDEC


@pytest.mark.parametrize("trace_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("key", [7, 11])
def test_f32_paged_tokens_match_reference(params, key, trace_seed):
    check_tokens(params, ENCDEC, "float32", key, trace_seed)


@pytest.mark.parametrize("trace_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("key", [7, 11])
def test_f32_paged_binarized_tokens_match_reference(params, key, trace_seed):
    check_tokens(params, ENCDEC + "+xnor", "float32", key, trace_seed)
