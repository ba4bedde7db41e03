"""Tensor-parallel training of the recurrent and CNN kinds on the (pod,
data, model) = (2, 2, 2) gloo mesh (``test_torch_mesh_tp_train.py`` has
the helpers): xlstm-350m and xnor-cnn, the batch split over (pod, data)
and the FSDP blocks gathered over ``data`` a layer at a time, against
the JAX package's jitted single-device step and the port's
single-process step; replicated leaves bitwise equal over ``model``."""

import pytest
import torch

from test_torch_mesh_tp_train import hold_case, hold_replicated, run

torch.set_num_threads(1)

CASES = {
    "xlstm-350m": ("xlstm-350m", {}, 1),
    "xnor-cnn": ("xnor-cnn", {}, 1),
}


@pytest.fixture(scope="module")
def runs():
    return run((2, 2, 2), ("pod", "data", "model"), CASES, ())


@pytest.mark.parametrize("name", list(CASES))
def test_tp_train_step_of_recurrent_kinds_on_pods_matches_reference(
        name, runs):
    hold_case(name, CASES[name], runs)


@pytest.mark.parametrize("name", list(CASES))
def test_recurrent_kinds_replicated_leaves_are_bitwise_equal_on_pods(
        name, runs):
    hold_replicated(name, CASES[name], runs)
