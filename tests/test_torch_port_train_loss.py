"""Parity of the port's YOLOv5 loss (heltondetection_tpu_torch/train/
yolo_loss.py) with the JAX package's on the CPU.

The same numpy inputs go through both: the assigner's targets must be equal
exactly; the loss terms within rtol 2e-6 and their gradients (with respect
to the raw maps, or to the packed head's objectness logits, feature rows
and weight blocks) within 1e-6 of the largest gradient — float32 rounding
of the same arithmetic. The gts include a centre on a cell's half
(``fx == 0.5``, where the x-neighbour is excluded), gts on the grid's
borders, duplicate gts of one centre (their slots collide in the
objectness scatter-max) and padding rows; one input is all padding. One
jitted JAX program per loss configuration serves both heads and both
inputs.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from heltondetection_tpu.train import yolo_loss as J

from heltondetection_tpu_torch.models.yolov5 import packed_train_head
from heltondetection_tpu_torch.train import yolo_loss as P

NC, S, B, M = 3, 64, 2, 8
STRIDES = (8, 16, 32)
CONFIGS = {"none": ("none", 0.0), "root+smoothing": ("root", 0.1),
           "root_cls": ("root_cls", 0.0)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def gts(all_padding=False):
    """(B, M) gts in cxcywh pixels with the special cases of the module
    docstring, classes and mask."""
    rng = np.random.default_rng(7)
    gt = np.zeros((B, M, 4), np.float32)
    gt[..., :2] = rng.uniform(6, 58, (B, M, 2))
    gt[..., 2:] = rng.uniform(4, 48, (B, M, 2))
    gt[0, 0] = [20.0, 30.0, 12.0, 16.0]     # 20/8 = 2.5: fx == 0.5 at P3
    gt[0, 1] = [4.0, 60.0, 10.0, 9.0]       # x in cell 0, y in the last row
    gt[0, 2] = [63.5, 0.5, 30.0, 20.0]      # on the right and top borders
    gt[0, 3] = [33.0, 41.0, 20.0, 24.0]     # duplicates of one centre,
    gt[0, 4] = [33.0, 41.0, 26.0, 18.0]     # different shapes
    gt[1, 5] = [48.0, 16.0, 40.0, 40.0]     # fy == 0.5 at P5 (16/32)
    cls = rng.integers(0, NC, (B, M)).astype(np.int32)
    mask = np.ones((B, M), bool)
    mask[1, 6:] = False                      # padding rows
    if all_padding:
        mask[:] = False
    return gt, cls, mask


def raw_maps():
    rng = np.random.default_rng(3)
    return [rng.normal(0, 1.5, (B, S // s, S // s, 3 * (5 + NC)))
            .astype(np.float32) for s in STRIDES]


def packed_inputs():
    """Feature rows and a standard detect conv per level, as the packed
    train head consumes them."""
    rng = np.random.default_rng(4)
    cin = 16
    out = []
    for s in STRIDES:
        h = S // s
        f = rng.normal(0, 1, (B, cin, h, h)).astype(np.float32)
        w = rng.normal(0, 0.3, (3 * (5 + NC), cin, 1, 1)).astype(np.float32)
        b = rng.normal(0, 0.5, (3 * (5 + NC),)).astype(np.float32)
        out.append((f, w, b))
    return out


def _j_packed(levels):
    """The reference's packed layout from (f, w, b) per level, built as
    its _PackedDetect builds it."""
    outs = []
    blk = 5 + NC
    for f, w, b in levels:
        bb, cin, h, wd = f.shape
        f2 = jnp.transpose(f, (0, 2, 3, 1)).reshape(bb, h * wd, cin)
        k = w[:, :, 0, 0].T                                  # (cin, A·blk)
        obj = jnp.asarray([a * blk + 4 for a in range(3)])
        pobj = f2 @ k[:, obj] + b[obj]
        wblocks = []
        for a in range(3):
            idx = jnp.asarray(list(range(a * blk + 5, a * blk + blk)) +
                              list(range(a * blk, a * blk + 5)))
            wblocks.append((jnp.pad(k[:, idx], ((0, 0), (0, 128 - blk))),
                            jnp.pad(b[idx], (0, 128 - blk))))
        outs.append((pobj, f2, wblocks, (h, wd)))
    return outs


@functools.lru_cache(maxsize=None)
def jax_losses(name):
    """One jitted program: (value, metrics, grads) under configuration
    ``name`` of the packed loss (the one training runs) for "none", of the
    standard loss for the focal variants. The port's two losses share
    their per-level terms, so between them every branch (plain and focal
    objectness, plain and focal classes, smoothing) is held against the
    reference, one compile each."""
    focal, ls = CONFIGS[name]
    cfg = J.YoloLossConfig(num_classes=NC, img_size=S, focal=focal,
                           label_smoothing=ls)
    if name == "none":
        return jax.jit(jax.value_and_grad(
            lambda lv, gt, cls, mask: J.yolo_loss_packed(
                _j_packed(lv), gt, cls, mask, cfg), has_aux=True))
    return jax.jit(jax.value_and_grad(
        lambda r, gt, cls, mask: J.yolo_loss(r, gt, cls, mask, cfg),
        has_aux=True))


def port_cfg(name):
    focal, ls = CONFIGS[name]
    return P.YoloLossConfig(num_classes=NC, img_size=S, focal=focal,
                            label_smoothing=ls)


def _close(got, want, what):
    np.testing.assert_allclose(float(got), float(want), rtol=2e-6,
                               atol=1e-7, err_msg=what)


def _grads_close(got, want, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale,
                               err_msg=what)


def test_build_level_targets_exact():
    """Every target of every level equals the reference's exactly: cells
    (clamped before the int cast), regression targets, validity (the
    ``fx != 0.5`` exclusion and the border rules)."""
    gt, cls, mask = gts()
    cfg_j = J.YoloLossConfig(num_classes=NC, img_size=S)
    cfg_p = P.YoloLossConfig(num_classes=NC, img_size=S)
    targets = jax.jit(lambda g, c, m: [
        J.build_level_targets(g, c, m, lvl, (S // s, S // s), cfg_j)
        for lvl, s in enumerate(STRIDES)])(gt, cls, mask)
    for lvl, s in enumerate(STRIDES):
        hw = (S // s, S // s)
        want = targets[lvl]
        got = P.build_level_targets(torch.from_numpy(gt),
                                    torch.from_numpy(cls),
                                    torch.from_numpy(mask), lvl, hw, cfg_p)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=f"level {lvl} {k}")
    # the special cases do what they are there for
    t0 = P.build_level_targets(torch.from_numpy(gt), torch.from_numpy(cls),
                               torch.from_numpy(mask), 0, (8, 8), cfg_p)
    assert not t0["valid"][0, 0, :, 1].any()      # fx == 0.5: no x-neighbour
    assert t0["valid"][0, 0, :, 2].any()
    assert not t0["valid"][1, 6:].any()           # padding


@pytest.mark.parametrize("padding", [False, True], ids=["gts", "all_padding"])
@pytest.mark.parametrize("name", ["root+smoothing", "root_cls"])
def test_yolo_loss_matches_jax(name, padding):
    gt, cls, mask = gts(padding)
    raws = raw_maps()
    (jl, jm), jg = jax_losses(name)(raws, gt, cls, mask)
    rt = [torch.tensor(r, requires_grad=True) for r in raws]
    total, metrics = P.yolo_loss(rt, torch.from_numpy(gt),
                                 torch.from_numpy(cls),
                                 torch.from_numpy(mask), port_cfg(name))
    total.backward()
    _close(total.detach(), jl, "total")
    for k in jm:
        _close(metrics[k].detach(), jm[k], k)
    if padding:
        assert float(metrics["box"].detach()) == 0.0
        assert float(metrics["cls"].detach()) == 0.0
    for lvl, (r, g) in enumerate(zip(rt, jg)):
        _grads_close(r.grad.numpy(), g, f"grad level {lvl}")


@pytest.mark.parametrize("padding", [False, True], ids=["gts", "all_padding"])
def test_yolo_loss_packed_matches_jax(padding):
    """The packed loss through ``models.yolov5.packed_train_head``:
    values, and gradients with respect to the feature maps and the
    standard detect conv's weight and bias."""
    name = "none"
    gt, cls, mask = gts(padding)
    levels = packed_inputs()
    (jl, jm), jg = jax_losses(name)(levels, gt, cls, mask)
    leaves = [tuple(torch.tensor(x, requires_grad=True) for x in lv)
              for lv in levels]
    outs = [packed_train_head(f, w, b, NC) for f, w, b in leaves]
    total, metrics = P.yolo_loss_packed(outs, torch.from_numpy(gt),
                                        torch.from_numpy(cls),
                                        torch.from_numpy(mask),
                                        port_cfg(name))
    total.backward()
    _close(total.detach(), jl, "total")
    for k in jm:
        _close(metrics[k].detach(), jm[k], k)
    if padding:
        assert float(metrics["box"].detach()) == 0.0
    for lvl, (lv, g) in enumerate(zip(leaves, jg)):
        for what, x, gx in zip(("f", "weight", "bias"), lv, g):
            _grads_close(x.grad.numpy(), gx, f"level {lvl} {what}")


def test_objectness_target_is_a_scatter_max():
    """Two duplicate slots with different CIoUs: the objectness target of
    the slot is the larger CIoU, whatever their order."""
    gt, cls, mask = gts()
    cfg = port_cfg("none")
    raws = [torch.from_numpy(r) for r in raw_maps()]
    swapped = gt.copy()
    swapped[0, [3, 4]] = swapped[0, [4, 3]]
    a = P.yolo_loss(raws, torch.from_numpy(gt), torch.from_numpy(cls),
                    torch.from_numpy(mask), cfg)[1]["obj"]
    cls_sw = cls.copy()
    cls_sw[0, [3, 4]] = cls_sw[0, [4, 3]]
    b = P.yolo_loss(raws, torch.from_numpy(swapped), torch.from_numpy(cls_sw),
                    torch.from_numpy(mask), cfg)[1]["obj"]
    assert float(a) == float(b)
