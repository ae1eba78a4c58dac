"""Parity of the port's FasterRCNN training loss and step with the JAX
package on the CPU, in float32 (heltondetection_tpu_torch/models/
faster_rcnn.py ``faster_rcnn_loss``, train/trainer.py
``make_rcnn_train_step``).

One tiny network in the published configs' training mode
(``torch_rcnn_refs.TRAIN_CFG``: ResNet18 with its stem and layer1 frozen
and its BatchNorm on running statistics, PAFPNv8 with BatchNorm on batch
statistics, the decoupled head, 128², 4 classes, B=2) holds seeded flax
variables with its predictors scaled (``torch_rcnn_refs.tame``). The one
reference program is its own ``make_rcnn_train_step`` (jitted once, run
twice): clipping is out of reach, so Adam's first moment after the first
step is 0.1 times the gradient, and the step's metrics, moved statistics
and EMA come with it. The port takes the uniforms of the reference's keys
(``torch_rcnn_refs.loss_draws``). Gradient accumulation is held to the
reference's rule for a batch-mean loss (``_accum_grads`` with
``loss_is_batch_scaled=False``: the micro-batches' gradients and metrics
averaged, BatchNorm statistics chained), replayed with the same program on
each micro-batch from the same weights. Tolerances: each loss term within 1e-4
relative (the proposals the second stage samples from differ by up to
2e-3 px between the packages); every gradient within 1e-4 of the global
gradient norm; ``grad_norm`` within 1e-6 of the norm of the port's own
gradients (summed in float64) and, against the reference's, within the
norm of the two gradients' difference (a few million elements, each
within 1e-4 of the norm, can move the norm by more than 1e-4); running
statistics within 1e-4 relative; after two
AdamW steps parameters and EMA within 2e-4, and within twice the learning
rate (1e-3 here) where the two gradients differ by over 1 % (Adam turns a
rounding difference in a near-zero gradient into a step of up to the
learning rate either way).

With the backbone's BatchNorm on batch statistics too (``norm_eval``
off) this network's gradients differ from the reference's by up to 1.8e-4
of the global norm: a float32 conv's rounding (1.1e-6 of its largest
output, both packages) meets channels whose mean is up to 9 times their
spread over the batch, so each train-mode BatchNorm multiplies it about
tenfold. The knobs' train mode is held at the feature and statistics
level in test_torch_port_rcnn_train.py, and here the statistics move.
"""

import numpy as np
import pytest
import torch

import jax

from heltondetection_tpu_torch.models import faster_rcnn as PR
from heltondetection_tpu_torch.train import schedule as PS
from heltondetection_tpu_torch.train import trainer as PT
from heltondetection_tpu_torch.utils.convert import from_jax_variables

from torch_rcnn_refs import (TRAIN_CFG, TRAIN_OPT, adam_moments,
                             port_train_draws, port_train_rcnn,
                             reference_train_step, tiny_train_rcnn,
                             train_batch)

KEYS = (jax.random.PRNGKey(7), jax.random.PRNGKey(8))
FROZEN = ("backbone.stem_", "backbone.layer1_")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def reference():
    """The variables and the reference's two steps from them on
    ``train_batch(0)`` with KEYS[0] and ``train_batch(1)`` with KEYS[1]:
    [(state, metrics, gradients by port name)] after each."""
    jm, variables = tiny_train_rcnn()
    run, state = reference_train_step(jm, variables)
    start, steps, mu = state, [], None
    for i, key in enumerate(KEYS):
        state, metrics = jax.device_get(run(state, train_batch(i), key))
        new_mu = from_jax_variables({"params": adam_moments(state.opt_state)})
        # mu = 0.9 mu + 0.1 g
        grads = {k: (v - (0.0 if mu is None else 0.9 * mu[k])) / 0.1
                 for k, v in new_mu.items()}
        steps.append((state, metrics, grads))
        mu = new_mu
    return variables, steps, run, start


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _check_grad_norm(got, pm, grads, want):
    """``grad_norm`` is the norm of the port's gradients, and differs from
    the reference's by no more than their difference's norm (the triangle
    inequality), both summed in float64."""
    own = diff = 0.0
    for k, p in pm.named_parameters():
        if p.grad is not None:
            g = p.grad.double()
            own += float((g * g).sum())
            diff += float(((g - grads[k].double()) ** 2).sum())
    own, diff = np.sqrt(own), np.sqrt(diff)
    assert abs(got - own) <= 1e-6 * own, (got, own)
    assert abs(got - want) <= diff + 1e-6 * want, (got, want, diff)


def test_faster_rcnn_loss_matches_jax(reference):
    """``faster_rcnn_loss`` in training mode on the reference's draws: each
    term within 1e-4 relative; every gradient within 1e-4 of the global
    norm (the frozen stem and layer1 get none); the running statistics
    within 1e-4 relative, the neck's moved and the backbone's held."""
    variables, steps, _, _ = reference
    state, metrics, grads = steps[0]
    pm = port_train_rcnn(variables).train()
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    t = _tensors(train_batch(0))
    total, got = PR.faster_rcnn_loss(
        pm, t["image"].float() / 255.0, t["gt_boxes_xyxy"], t["gt_cls"],
        t["gt_mask"], draws=port_train_draws(KEYS[0]))
    total.backward()
    for k in ("rpn_obj", "rpn_reg", "cls", "box", "total"):
        np.testing.assert_allclose(float(got[k].detach()), float(metrics[k]),
                                   rtol=1e-4, err_msg=k)
        assert float(metrics[k]) > 0
    gnorm = float(metrics["grad_norm"])
    for k, p in pm.named_parameters():
        assert (p.grad is None) == k.startswith(FROZEN), k
        if p.grad is not None:
            np.testing.assert_allclose(p.grad.numpy(), grads[k].numpy(),
                                       rtol=0, atol=1e-4 * gnorm, err_msg=k)
    want = from_jax_variables({"batch_stats": state.batch_stats})
    after = pm.state_dict()
    for k, v in want.items():
        if "running" in k:
            np.testing.assert_allclose(after[k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
            assert torch.equal(after[k], before[k]) == \
                k.startswith("backbone."), k


def test_norm_eval_holds_the_backbone_statistics(reference):
    """With ``backbone_norm_eval`` (the configs' default) a training-mode
    loss leaves every backbone BatchNorm statistic where it was and moves
    the neck's; without it both move."""
    variables = reference[0]
    t = _tensors(train_batch(1))
    for norm_eval in (True, False):
        with torch.device("meta"):
            pm = PR.FasterRCNN(PR.RCNNConfig(**{
                **TRAIN_CFG, "backbone_norm_eval": norm_eval,
                "backbone_frozen_stages": 0}))
        pm = pm.to_empty(device="cpu")
        pm.load_state_dict(from_jax_variables(variables))
        pm.train()
        before = {k: v.clone() for k, v in pm.state_dict().items()}
        with torch.no_grad():
            PR.faster_rcnn_loss(pm, t["image"].float() / 255.0,
                                t["gt_boxes_xyxy"], t["gt_cls"],
                                t["gt_mask"],
                                draws=torch.Generator().manual_seed(0))
        after = pm.state_dict()
        for part in ("backbone.", "neck."):
            keys = [k for k in after if k.startswith(part)
                    and k.endswith("running_mean")]
            assert keys
            moved = [not torch.equal(after[k], before[k]) for k in keys]
            if part == "backbone." and norm_eval:
                assert not any(moved)
            else:
                assert all(moved), part


def test_rcnn_train_step_matches_jax(reference):
    """Two ``make_rcnn_train_step`` calls (uint8 images divided inside,
    AdamW with the frozen stem and layer1, the EMA; the schedule's first
    step is at learning rate 0, so the second moves the weights) on the
    reference's draws, against the reference's own two steps: the loss
    terms within 1e-4 relative, ``grad_norm`` as the module docstring
    says, parameters and EMA within 2e-4 (plus twice the learning rate
    where the two gradients differ by over 1 %); the frozen stage does not
    move."""
    variables, steps, _, _ = reference
    pm = port_train_rcnn(variables)
    state = PT.create_train_state(pm, PS.make_optimizer(pm, 1e-3,
                                                        **TRAIN_OPT))
    step = PT.make_rcnn_train_step()
    loose = {}      # where the two gradients differ by over 1 % of the ref's
    for i, (key, (_, metrics, grads)) in enumerate(zip(KEYS, steps)):
        state, got = step(state, _tensors(train_batch(i)),
                          [port_train_draws(key)])
        for k, p in pm.named_parameters():
            if p.grad is not None:
                loose[k] = loose.get(k, False) | (
                    (p.grad - grads[k]).abs() > 1e-2 * grads[k].abs())
        for k in ("rpn_obj", "rpn_reg", "cls", "box", "total"):
            np.testing.assert_allclose(float(got[k]), float(metrics[k]),
                                       rtol=1e-4, err_msg=k)
        _check_grad_norm(float(got["grad_norm"]), pm, grads,
                         float(metrics["grad_norm"]))
    assert state.step == 2
    final = steps[-1][0]
    sd = from_jax_variables({"params": final.params,
                             "batch_stats": final.batch_stats})
    emas = from_jax_variables({"params": final.ema_params})
    own = pm.state_dict()
    for k, v in sd.items():
        if not v.is_floating_point():
            continue
        # Adam moves an element by about the learning rate whatever its
        # gradient's size: where the two gradients differ by over 1 % (a
        # near-zero gradient's rounding), an element's two steps may differ
        # by up to twice the learning rate
        tol = 2e-4 + 1e-4 * v.abs() + 2e-3 * loose.get(k, False)
        assert bool(((own[k] - v).abs() <= tol).all()), k
        if k in emas:
            assert bool(((state.ema[k] - emas[k]).abs() <= tol).all()), k
    start = from_jax_variables({"params": variables["params"]})
    assert torch.equal(own["backbone.stem_conv.weight"],
                       start["backbone.stem_conv.weight"])
    assert not torch.equal(own["rpn.conv.weight"], start["rpn.conv.weight"])


def test_grad_accum_matches_jax(reference):
    """``make_rcnn_train_step(accum_steps=2)`` on B=4: micro-batch i takes
    rows i::2 and the uniforms of ``fold_in(key, i)``, as the reference's
    scan does. Against the reference's step on each micro-batch from the
    same weights, its statistics chained: the loss terms averaged within
    1e-4 relative, ``grad_norm`` (of the averaged gradient) as the module
    docstring says, every averaged gradient within 1e-4 of its norm, the
    statistics after both micro-batches within 1e-4 relative."""
    variables, _, run, start = reference
    key = jax.random.PRNGKey(9)
    batch = train_batch(2, b=4)
    stats, metrics, grads = start.batch_stats, [], []
    for i in range(2):
        micro = {k: v[i::2] for k, v in batch.items()}
        state, m = jax.device_get(run(start._replace(batch_stats=stats),
                                      micro, jax.random.fold_in(key, i)))
        stats = state.batch_stats
        metrics.append(m)
        grads.append(from_jax_variables(
            {"params": adam_moments(state.opt_state)}))
    grads = {k: (grads[0][k] + grads[1][k]) / 0.2 for k in grads[0]}
    gnorm = float(torch.sqrt(sum((g * g).sum() for g in grads.values())))
    pm = port_train_rcnn(variables)
    state = PT.create_train_state(pm, PS.make_optimizer(pm, 1e-3,
                                                        **TRAIN_OPT))
    draws = [port_train_draws(jax.random.fold_in(key, i)) for i in range(2)]
    state, got = PT.make_rcnn_train_step(accum_steps=2)(
        state, _tensors(batch), draws)
    for k in ("rpn_obj", "rpn_reg", "cls", "box", "total"):
        np.testing.assert_allclose(
            float(got[k]), (float(metrics[0][k]) + float(metrics[1][k])) / 2,
            rtol=1e-4, err_msg=k)
    _check_grad_norm(float(got["grad_norm"]), pm, grads, gnorm)
    for k, p in pm.named_parameters():
        if p.grad is not None:
            np.testing.assert_allclose(p.grad.numpy(), grads[k].numpy(),
                                       rtol=0, atol=1e-4 * gnorm, err_msg=k)
    want = from_jax_variables({"batch_stats": stats})
    own = pm.state_dict()
    for k, v in want.items():
        if "running" in k:
            np.testing.assert_allclose(own[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    # the neck's statistics moved once per micro-batch
    assert int(own["neck.in0.bn.num_batches_tracked"]) == 2
