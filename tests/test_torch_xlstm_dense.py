"""``test_torch_xlstm_serve.py``'s token identity for the slot-dense
layout in bf16: the port's dense engine on xLSTM-350M[+xnor] against the
reference's dense engine on 8 traces."""

import pytest

from test_torch_xlstm_serve import ARCHS, check_tokens, params  # noqa: F401


@pytest.mark.parametrize("trace_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("key", [7, 11])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_dense_tokens_match_reference(params, arch, key, trace_seed):
    check_tokens(params, arch, "bfloat16", key, trace_seed, paged=False)
