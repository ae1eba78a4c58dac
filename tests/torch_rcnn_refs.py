"""Helpers of the FasterRCNN parity tests (tests/test_torch_port_rcnn_*.py):
seeded flax variables for any module, and the predictor scaling both
packages share.

A flax variable tree of a module's shapes (``jax.eval_shape`` of its init,
which skips flax's slow init) is filled from a numpy seed and carried to the
port with ``utils.convert.from_jax_variables``, so every test also tests
the weight bridge and ``load_state_dict(strict=True)``.
"""

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

