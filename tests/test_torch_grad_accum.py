"""Gradient accumulation and the UV loss in the port against the JAX
package (CPU, float32).

``train_step`` on two micro-batches (K backward passes into the same
gradients, their mean, one clip and one optimizer step, BatchNorm running
stats threaded through the micro-batches in order, the logs' K-mean)
against JAX ``make_train_step(grad_accum=2)`` on the same two batches
stacked, at ``tests/test_train_step_parity.py``'s bounds
(``tests/test_torch_tail_pad.assert_step_matches``).  The model has the UV
head and feeds it to the STN (``resnet_input: img+mask+uv``), with the UV
loss on, so the UV loss and its gradients are held to JAX in the same step.
Also: ``_accumulation_groups`` drops a partial tail group and reports it.
"""
import numpy as np
import pytest

from test_torch_tail_pad import (LOSSES, assert_step_matches, jax_model, jax_step, make_batch,
                                 port_model, port_step)

UV = dict(unet_uv=True, resnet_input="img+mask+uv")
ACCUM_LOSSES = dict(LOSSES, uv_loss="MSE", uv_lambda=2.0, batch_size=3)


@pytest.fixture(scope="module")
def accum_case():
    # well-posed seeds (tests/test_torch_tail_pad.py): others put the court
    # near the horizon, where the step's f32 gradients follow rounding
    model, variables = jax_model(3, **UV)
    micro = [make_batch(3, 4, uv=True), make_batch(3, 5, uv=True)]
    stacked = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
    return variables, micro, jax_step(model, variables, stacked, ACCUM_LOSSES, grad_accum=2)


def test_grad_accum_matches_jax(accum_case):
    variables, micro, (new_state, logs_j, grads_j) = accum_case
    assert float(logs_j["UV_loss"]) > 0
    model = port_model(variables, **UV)
    logs, grads = port_step(model, micro, ACCUM_LOSSES)
    assert "UV_loss" in logs
    assert_step_matches(model, logs, grads, new_state, logs_j, grads_j, n_steps=2)


def test_accumulation_groups_drop_a_partial_tail():
    from sports_field_homography_tpu_torch.train.loop import _accumulation_groups

    dropped = []
    groups = list(_accumulation_groups(range(5), 2, dropped.append))
    assert groups == [[0, 1], [2, 3]] and dropped == [1]
    dropped.clear()
    assert list(_accumulation_groups(range(4), 2, dropped.append)) == [[0, 1], [2, 3]]
    assert dropped == []
