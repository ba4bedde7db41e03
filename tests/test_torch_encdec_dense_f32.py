"""``test_torch_encdec_dense.py``'s token identity in f32, binarized and
at full precision: the slot-dense engine on Whisper[+xnor] against the
reference's on 8 traces."""

import pytest

from test_torch_vlm_serve import check_tokens, params  # noqa: F401
from test_torch_encdec_serve import ENCDEC


@pytest.mark.parametrize("trace_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("key", [7, 11])
def test_f32_dense_tokens_match_reference(params, key, trace_seed):
    check_tokens(params, ENCDEC + "+xnor", "float32", key, trace_seed,
                 paged=False)


@pytest.mark.parametrize("trace_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("key", [7, 11])
def test_f32_dense_full_precision_tokens_match_reference(params, key,
                                                         trace_seed):
    check_tokens(params, ENCDEC, "float32", key, trace_seed, paged=False)
