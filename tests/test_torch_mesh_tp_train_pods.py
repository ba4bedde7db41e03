"""Tensor- and expert-parallel training on the (pod, data, model) = (2,
2, 2) gloo mesh (``test_torch_mesh_tp_train.py`` has the (1, 4) mesh and
the helpers): the sharded ``train_step`` of the same cases, with the
batch split over (pod, data) and the FSDP blocks gathered over ``data``
a layer at a time, against the JAX package's jitted single-device step
and the port's single-process step; and ``microbatch=2``, whose parts
are the global batch's first and last four rows (the reference's
reshape), each split over the mesh, against the reference's
``train_step(..., microbatch=2)``."""

import numpy as np
import pytest
import torch

from test_torch_mesh_tp_train import (QWEN, hold_case, hold_gathers,
                                      hold_replicated, run)

torch.set_num_threads(1)

CASES = {
    "qwen2-7b": ("qwen2-7b", QWEN, 1),
    "qwen2-7b+xnor": ("qwen2-7b+xnor", QWEN, 1),
    "moonshot-v1-16b-a3b": ("moonshot-v1-16b-a3b", {}, 1),
    "recurrentgemma-2b+xnor": ("recurrentgemma-2b+xnor", {}, 1),
    "qwen2-7b microbatch 2": ("qwen2-7b", QWEN, 2),
    "moonshot-v1-16b-a3b microbatch 2": ("moonshot-v1-16b-a3b", {}, 2),
}
COUNTED = "qwen2-7b"


@pytest.fixture(scope="module")
def runs():
    return run((2, 2, 2), ("pod", "data", "model"), CASES, COUNTED)


@pytest.mark.parametrize("name", list(CASES))
def test_tp_train_step_on_pods_matches_reference_and_single_process(
        name, runs):
    hold_case(name, CASES[name], runs)


@pytest.mark.parametrize("name", list(CASES))
def test_leaves_replicated_over_model_are_bitwise_equal_on_pods(name, runs):
    hold_replicated(name, CASES[name], runs)


def test_step_gathers_its_fsdp_blocks_a_layer_at_a_time(runs):
    """qwen2-7b's attn layers keep their heads and d_ff over ``model``
    and gather their blocks over ``data``: each layer's once in the
    forward and once in its recompute, one layer's alive at a time, the
    embedding's at its use; the CE never makes a (tokens, vocab)
    tensor (2 rows a rank)."""
    hold_gathers(COUNTED, CASES[COUNTED], runs, 2)


def test_microbatch_parts_hold_unequal_token_counts():
    """The parts' CE denominators differ (the global batch's first four
    rows hold more labelled positions than its last four), so a part cut
    from each rank's block would give another loss."""
    from test_torch_mesh_train import _batch
    labels = _batch(256)["labels"]
    counts = [int((labels[i * 4:(i + 1) * 4] >= 0).sum()) for i in range(2)]
    assert counts[0] != counts[1]
    per_rank = [int((labels[r * 2:(r + 1) * 2] >= 0).sum()) for r in range(4)]
    assert len(set(per_rank)) == 4
    assert np.sum(counts) == np.sum(per_rank)
