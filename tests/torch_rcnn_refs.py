"""Helpers of the FasterRCNN parity tests (tests/test_torch_port_rcnn_*.py):
seeded flax variables for any module, and the predictor scaling both
packages share.

A flax variable tree of a module's shapes (``jax.eval_shape`` of its init,
which skips flax's slow init) is filled from a numpy seed and carried to the
port with ``utils.convert.from_jax_variables``, so every test also tests
the weight bridge and ``load_state_dict(strict=True)``.
"""

import functools

import numpy as np
import torch

from heltondetection_tpu_torch.utils.convert import from_jax_variables


def draw_variables(shapes, seed: int):
    """Numpy leaves for a flax variable tree of ``shapes``: kernels
    N(0, 1/fan_in), BatchNorm scales and variances in [0.5, 1.5], every
    bias and BatchNorm mean N(0, 0.1²)."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v)
            elif k == "kernel":
                out[k] = rng.standard_normal(v.shape, np.float32) * \
                    np.float32(1 / np.sqrt(np.prod(v.shape[:-1])))
            elif k in ("scale", "var"):
                out[k] = rng.random(v.shape, np.float32) + np.float32(0.5)
            else:
                out[k] = rng.standard_normal(v.shape, np.float32) * \
                    np.float32(0.1)
        return out

    return {c: walk(shapes[c]) for c in shapes}


def load_port(model: torch.nn.Module, variables) -> torch.nn.Module:
    """The port's ``model`` holding the flax ``variables``, strictly."""
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model.eval()


def tame(variables, model, images: torch.Tensor):
    """Scale the four predictor kernels of a FasterRCNN, in the flax tree
    and in the port's ``model`` that holds it, so that on ``images`` the
    RPN objectness logits have std 2, the RPN deltas 0.5, the class logits
    2 and the box deltas 0.5. Random weights otherwise give near-equal RPN
    scores (every proposal ties) or, with larger activations, saturated
    ones; these give distinct, unsaturated scores. The factors come from
    the port's forward and apply to both packages."""
    from heltondetection_tpu_torch.models.faster_rcnn import (
        generate_proposals, pyramid_anchors)
    p = variables["params"]
    cfg = model.cfg

    def scale(head, layer, factor):
        factor = np.float32(factor)
        p[head][layer]["kernel"] = p[head][layer]["kernel"] * factor
        getattr(getattr(model, head if head == "rpn" else "box_head"),
                layer).weight.mul_(torch.tensor(factor))

    with torch.no_grad():
        pyr, obj, deltas = model(images)
        scale("rpn", "cls", 2.0 / float(obj.std()))
        scale("rpn", "reg", 0.5 / float(deltas.std()))
        obj, deltas = model.rpn(pyr)
        props = generate_proposals(obj, deltas, model.anchors("cpu"),
                                   pyramid_anchors(cfg.img_size)[1],
                                   cfg.img_size, cfg)
        scores, hd = model.run_box_head(pyr, props[0])
        scale("box_head", "cls", 2.0 / float(scores.std()))
        scale("box_head", "reg", 0.5 / float(hd.std()))
    return model



@functools.lru_cache(maxsize=None)
def _uniforms(n: int):
    """A jitted function of keys (B, 2) → (3, B, n): per key its
    ``jax.random.split(key, 3)`` and one ``uniform`` of each."""
    import jax
    import jax.numpy as jnp

    def one(key):
        return jnp.stack([jax.random.uniform(k, (n,))
                          for k in jax.random.split(key, 3)])
    return jax.jit(lambda keys: jax.vmap(one, out_axes=1)(keys))


def sampling_draws(keys, n: int):
    """The three (B, n) uniforms the reference's ``_sample_balanced`` draws
    from each key of ``keys`` (its ``jax.random.split(rng, 3)`` and one
    ``uniform`` of each), as torch tensors."""
    return tuple(torch.from_numpy(np.array(u))
                 for u in _uniforms(n)(keys))


def loss_draws(rng, b: int, n_anchors: int, n_rois: int):
    """The sampling draws of the reference's ``faster_rcnn_loss`` on key
    ``rng`` for a batch of ``b``: image i's RPN draws from key i and its box
    head's from key b + i of ``jax.random.split(rng, 2 b)``."""
    import jax
    from heltondetection_tpu_torch.models.faster_rcnn import RCNNDraws
    keys = jax.random.split(rng, 2 * b)
    return RCNNDraws(sampling_draws(keys[:b], n_anchors),
                     sampling_draws(keys[b:], n_rois))


def adam_moments(opt_state):
    """The first-moment tree (``mu``) of the one Adam state inside a
    reference optax state (numpy leaves; a frozen parameter's is a
    ``MaskedNode``, which ``from_jax_variables`` skips)."""
    from heltondetection_tpu_torch.utils.convert import _adam_states
    (adam,) = list(_adam_states(opt_state))
    return adam.mu


# the tiny FasterRCNN of the training parity tests: the published configs'
# training mode (ResNet18, stem and layer1 frozen, backbone BatchNorm on
# running statistics; PAFPNv8's on batch statistics), the decoupled head,
# 128², 4 classes, small proposal and sample budgets
TRAIN_SIZE, TRAIN_NC, TRAIN_M = 128, 4, 6
TRAIN_CFG = dict(num_classes=TRAIN_NC, img_size=TRAIN_SIZE,
                 backbone="resnet18", neck="pafpn_v8", head="decoupled",
                 rpn_pre_nms_topk=128, rpn_post_nms_topk=32, rpn_batch=64,
                 box_batch=32, backbone_norm_eval=True,
                 backbone_frozen_stages=1)
# AdamW with the stem and layer1 frozen; clipping out of reach, so Adam's
# first moment after a step is 0.1 times the gradient
TRAIN_OPT = dict(total_steps=10, warmup_steps=1, weight_decay=5e-4,
                 grad_clip=1e3,
                 frozen_prefixes=("backbone/stem_", "backbone/layer1_"))


def train_batch(seed: int, b: int = 2):
    """Images (b, 128, 128, 3) uint8 and xyxy gts (b, 6): even images with
    four gts, odd ones with two, the rest masked."""
    rng = np.random.default_rng(seed)
    s, m = TRAIN_SIZE, TRAIN_M
    img = rng.integers(0, 256, (b, s, s, 3)).astype(np.uint8)
    xy = rng.uniform(0, 70, (b, m, 2))
    wh = rng.uniform(12, 56, (b, m, 2))
    gt = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    mask = np.zeros((b, m), bool)
    for i in range(b):
        mask[i, :4 if i % 2 == 0 else 2] = True
    cls = rng.integers(0, TRAIN_NC, (b, m)).astype(np.int32)
    return {"image": img, "gt_boxes_xyxy": gt, "gt_cls": cls,
            "gt_mask": mask}


@functools.lru_cache(maxsize=None)
def tiny_train_rcnn(seed: int = 61):
    """The reference's tiny FasterRCNN and its seeded variables, the four
    predictor layers tamed on ``train_batch(0)``'s frames."""
    import jax
    from heltondetection_tpu.models import faster_rcnn as JR
    jm = JR.FasterRCNN(JR.RCNNConfig(**TRAIN_CFG))
    shapes = jax.eval_shape(lambda: JR.init_faster_rcnn(
        jm, jax.random.PRNGKey(0), TRAIN_SIZE))
    variables = draw_variables(shapes, seed=seed)
    pm = port_train_rcnn(variables)
    x = torch.from_numpy(train_batch(0)["image"].astype(np.float32) / 255.0)
    tame(variables, pm, x)
    return jm, variables


def port_train_rcnn(variables):
    """The port's tiny FasterRCNN holding ``variables``."""
    from heltondetection_tpu_torch.models import faster_rcnn as PR
    with torch.device("meta"):
        pm = PR.FasterRCNN(PR.RCNNConfig(**TRAIN_CFG))
    return load_port(pm.to_empty(device="cpu"), variables)


def reference_train_step(jm, variables, accum_steps: int = 1):
    """The reference's ``make_rcnn_train_step`` (AdamW of ``TRAIN_OPT``,
    EMA) jitted, compiled without LLVM's expensive passes (the same IEEE
    arithmetic in less compile time), and its state at step 0."""
    import jax
    import jax.numpy as jnp
    from heltondetection_tpu.train import schedule as JS
    from heltondetection_tpu.train import trainer as JT
    tx = JS.make_optimizer(1e-3, **TRAIN_OPT)
    params = variables["params"]
    state = JT.TrainState(params, variables["batch_stats"], tx.init(params),
                          jnp.zeros((), jnp.int32), params)
    step = jax.jit(JT.make_rcnn_train_step(jm, tx, jm.cfg, use_ema=True,
                                           accum_steps=accum_steps))
    batch = train_batch(0)
    run = step.lower(state, batch, jax.random.PRNGKey(0)).compile(
        {"xla_llvm_disable_expensive_passes": True})
    return run, state


def port_train_draws(key, b: int = 2):
    """The port's sampling draws of the reference's loss on ``key`` for a
    batch of ``b`` of the tiny network."""
    from heltondetection_tpu_torch.models import faster_rcnn as PR
    n_anchors = PR.pyramid_anchors(TRAIN_SIZE)[0].shape[0]
    return loss_draws(key, b, n_anchors,
                      TRAIN_CFG["rpn_post_nms_topk"] + TRAIN_M)
