"""``test_torch_xlstm_dense.py`` in f32: the port's slot-dense engine on
xLSTM-350M[+xnor] against the reference's on 8 traces."""

import pytest

from test_torch_xlstm_serve import ARCHS, check_tokens, params  # noqa: F401


@pytest.mark.parametrize("trace_seed", [0, 1, 2, 3])
@pytest.mark.parametrize("key", [7, 11])
@pytest.mark.parametrize("arch", ARCHS)
def test_f32_dense_tokens_match_reference(params, arch, key, trace_seed):
    check_tokens(params, arch, "float32", key, trace_seed, paged=False)
