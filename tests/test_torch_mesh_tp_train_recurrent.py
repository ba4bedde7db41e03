"""Tensor-parallel training of the recurrent and CNN kinds over gloo
ranks on the CPU (``test_torch_mesh_tp_train.py`` has the helpers and
the ``attn`` / ``moe`` cases): the sharded ``train_step`` on the (data,
model) = (1, 4) mesh against the JAX package's jitted single-device
``train_step`` and the port's single-process step, at
``tests/test_torch_train.py``'s tolerances, replicated leaves bitwise
equal on every rank of ``model``.

recurrentgemma-2b at 6 query heads and its one KV head (``local``:
ranks 0-2 hold 2 query heads and the KV head, whose gradient is summed
over them, rank 3 none; ``rglru`` on its channel block), xlstm-350m
(``mlstm`` on its block of ``di`` and of the memory's rows, ``slstm``
with its gates gathered and its cell whole) and the same at 2 heads
``+xnor`` (heads that do not divide the 4 ranks), and xnor-cnn
(``bindense`` on its ``d_ff`` block).  On this mesh nothing is split
over ``data``, so a step of these kinds gathers no parameter.
"""

import pytest
import torch

from test_torch_mesh_tp_train import hold_case, hold_replicated, run

torch.set_num_threads(1)

CASES = {
    "recurrentgemma-2b 6 heads": ("recurrentgemma-2b",
                                  dict(n_heads=6, n_kv_heads=1), 1),
    "xlstm-350m": ("xlstm-350m", {}, 1),
    "xlstm-350m+xnor 2 heads": ("xlstm-350m+xnor",
                                dict(n_heads=2, n_kv_heads=2), 1),
    "xnor-cnn": ("xnor-cnn", {}, 1),
}


@pytest.fixture(scope="module")
def runs():
    return run((1, 4), ("data", "model"), CASES, tuple(CASES))


@pytest.mark.parametrize("name", list(CASES))
def test_tp_train_step_of_recurrent_kinds_matches_reference(name, runs):
    hold_case(name, CASES[name], runs)


@pytest.mark.parametrize("name", list(CASES))
def test_recurrent_kinds_replicated_leaves_are_bitwise_equal(name, runs):
    hold_replicated(name, CASES[name], runs)


@pytest.mark.parametrize("name", list(CASES))
def test_recurrent_and_cnn_kinds_gather_no_parameter_over_model(name, runs):
    """local + rglru, mlstm + slstm and bindense layers train on their
    blocks over ``model``: on (1, 4) the step gathers no parameter, not
    even the embedding (its vocab stays split)."""
    for r in runs["ranks"]:
        got = r["cases"][name]
        assert got["probe"]["calls"] == []
        assert got["layers"] and not any(got["layers"]) and got["embed"] == 0
