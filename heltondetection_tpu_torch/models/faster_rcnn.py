"""FasterRCNN, inference and training; counterpart of
heltondetection_tpu/models/faster_rcnn.py.

    images → backbone (ResNet50 by default, any registry name) → C2..C5
    → FPN or PAFPNv8 (256 channels) + P6 → P2..P6
    → RPN: objectness and deltas per level → per-level top-k, decode,
      clip, NMS → joint top-k proposals
    → level-aware RoIAlign (or RoIPool) over P2..P{1+roi_levels}
    → coupled (two fc) or decoupled (conv branches) box head → per-class
      deltas → decode → class-aware NMS

Shapes are fixed, with validity masks, as in the reference, and the batch
dimension is explicit: the RPN NMS is one ``batched_nms`` call per level
over the whole batch and the final NMS one call, so on CUDA tensors each is
one launch of the ``nms_mask`` kernel. Flattening follows the reference's
NHWC order: the RPN outputs in (h, w, a) rows and the box head's crops in
(h, w, c) order, so weights carried over from the reference line up.
The RPN convs and the box head's hidden layers run in the model's dtype;
the RPN outputs, the coupled head's predictors and the decoupled head's
dense layers in float32.

Training (:func:`faster_rcnn_loss`) follows torchvision's FasterRCNN as the
reference does: the RPN's anchors matched at IoU 0.7/0.3 with every gt's
best anchors kept, 256 sampled at half foreground; the proposals (on the
detached RPN maps) with the gts appended, matched at 0.5 and 512 sampled
at a quarter foreground; smooth-L1 (beta 1/9) and cross-entropy. Both
assigners take their IoU from ``ops.boxes.iou_matrix`` (the ``iou_matrix``
kernel on CUDA tensors, one launch per image and stage). The RPN loss is
the reference's sparse form: the sampled logits are recomputed from 3x3
patches gathered from the pyramid (:func:`rpn_logits_at`), so the dense
RPN maps carry no gradient. Sampling is a function of explicit uniform
draws (:class:`RCNNDraws`), which the train step takes from a
``torch.Generator``; ``jax.random``'s draws cannot be reproduced, so the
tests feed the reference's own.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from heltondetection_tpu_torch.models.backbones import build_backbone
from heltondetection_tpu_torch.models.common import CastConv2d, CastLinear
from heltondetection_tpu_torch.models.dropblock import DropBlock
from heltondetection_tpu_torch.models.necks import FPN, PAFPNv8
from heltondetection_tpu_torch.ops.anchors import rpn_pyramid_anchors
from heltondetection_tpu_torch.ops.boxes import (clip_boxes, decode_deltas,
                                                 encode_deltas, iou_matrix)
from heltondetection_tpu_torch.ops.nms import _topk, batched_nms
from heltondetection_tpu_torch.ops.roi_align import multilevel_roi_align


class RCNNConfig(NamedTuple):
    num_classes: int = 80               # foreground classes (bg is extra)
    img_size: int = 832
    neck: str = "fpn"                   # fpn | pafpn_v8
    head: str = "coupled"               # coupled | decoupled
    roi_method: str = "align"           # align | pool
    # RPN
    rpn_pre_nms_topk: int = 1000        # per level
    rpn_post_nms_topk: int = 1000
    rpn_nms_thresh: float = 0.7
    rpn_fg_iou: float = 0.7
    rpn_bg_iou: float = 0.3
    rpn_batch: int = 256
    rpn_pos_frac: float = 0.5
    # box head
    box_fg_iou: float = 0.5
    box_batch: int = 512
    box_pos_frac: float = 0.25
    # inference
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    max_det: int = 100
    max_gt: int = 64
    backbone: str = "resnet50"          # models/backbones.py registry name
    dropblock_p: float = 0.0            # DropBlock on the pooled crops
    roi_levels: int = 4                 # levels the box head pools from
    backbone_norm_eval: bool = True
    backbone_frozen_stages: int = 1
    remat: bool = False


STRIDES = (4, 8, 16, 32, 64)            # P2..P6
ANCHOR_SIZES = (32, 64, 128, 256, 512)
RATIOS = (0.5, 1.0, 2.0)
A_PER_CELL = len(RATIOS)


def _nhwc_rows(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, H·W·C) in NHWC order, as flax flattens."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class RPNHead(nn.Module):
    """A shared 3x3 conv, then objectness and delta 1x1 convs, over every
    level, in the input's dtype; outputs float32 (B, N) and (B, N, 4), the
    levels concatenated, rows in (h, w, a) order."""

    def __init__(self, channels: int = 256):
        super().__init__()
        self.conv = CastConv2d(channels, 256, 3, 1, 1)
        self.cls = CastConv2d(256, A_PER_CELL, 1)
        self.reg = CastConv2d(256, A_PER_CELL * 4, 1)

    def forward(self, feats):
        logits, deltas = [], []
        for f in feats:
            t = F.relu(self.conv(f))
            logits.append(_nhwc_rows(self.cls(t).float()))
            deltas.append(_nhwc_rows(self.reg(t).float())
                          .reshape(f.shape[0], -1, 4))
        return torch.cat(logits, 1), torch.cat(deltas, 1)


class CoupledBoxHead(nn.Module):
    """torchvision's TwoMLPHead and predictor: crops (R, 7, 7, C) flattened
    in (h, w, c) order → fc1 → fc2 (1024, the model's dtype) → class logits
    (C+1) and per-class deltas (C, 4) in float32."""

    def __init__(self, num_classes: int, in_features: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.fc1 = CastLinear(in_features, 1024)
        self.fc2 = CastLinear(1024, 1024)
        self.cls = CastLinear(1024, num_classes + 1)
        self.reg = CastLinear(1024, num_classes * 4)
        self.num_classes = num_classes

    def forward(self, x):
        r = x.shape[0]
        x = x.reshape(r, -1).to(self.dtype)
        x = F.relu(self.fc2(F.relu(self.fc1(x)))).float()
        return self.cls(x), self.reg(x).reshape(r, self.num_classes, 4)


class DecoupledBoxHead(nn.Module):
    """The reference's decoupled head: separate class and box branches of
    two 3x3 convs (256, the model's dtype) each, then per branch a float32
    dense layer (1024) and its predictor."""

    def __init__(self, num_classes: int, channels: int, dtype):
        super().__init__()
        self.dtype = dtype
        for br in ("cls", "reg"):
            self.add_module(f"{br}_conv0", CastConv2d(channels, 256, 3, 1, 1))
            self.add_module(f"{br}_conv1", CastConv2d(256, 256, 3, 1, 1))
            self.add_module(f"{br}_fc", CastLinear(256 * 49, 1024))
        self.cls = CastLinear(1024, num_classes + 1)
        self.reg = CastLinear(1024, num_classes * 4)
        self.num_classes = num_classes

    def _branch(self, br: str, x):
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        for i in range(2):
            x = F.relu(getattr(self, f"{br}_conv{i}")(x))
        return F.relu(getattr(self, f"{br}_fc")(_nhwc_rows(x).float()))

    def forward(self, x):
        r = x.shape[0]
        return (self.cls(self._branch("cls", x)),
                self.reg(self._branch("reg", x)).reshape(
                    r, self.num_classes, 4))


class FasterRCNN(nn.Module):
    """``forward(images (B, S, S, 3) float NHWC)`` → (the pyramid P2..P6
    as NCHW tensors, RPN objectness (B, N), RPN deltas (B, N, 4));
    :meth:`run_box_head` pools the proposals and runs the box head. The
    full inference is :func:`faster_rcnn_infer`. Parameters are float32;
    ``dtype`` is the compute dtype."""

    def __init__(self, cfg: RCNNConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.num_classes = cfg.num_classes
        self.dtype = dtype
        self.backbone = build_backbone(
            cfg.backbone, norm_eval=cfg.backbone_norm_eval,
            frozen_stages=cfg.backbone_frozen_stages, remat=cfg.remat)
        chans = self.backbone.channels[-4:]
        neck = FPN if cfg.neck == "fpn" else PAFPNv8
        self.neck = neck(chans, 256, extra_pool=True)
        self.rpn = RPNHead(256)
        if cfg.head == "coupled":
            self.box_head = CoupledBoxHead(cfg.num_classes, 256 * 49, dtype)
        else:
            self.box_head = DecoupledBoxHead(cfg.num_classes, 256, dtype)
        self.head_dropblock = (DropBlock(cfg.dropblock_p, block_size=3)
                               if cfg.dropblock_p > 0 else None)
        self._anchors = {}     # device -> the pyramid's anchors there

    def features(self, images: torch.Tensor) -> List[torch.Tensor]:
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        return self.neck(self.backbone(x)[-4:])

    def forward(self, images: torch.Tensor):
        pyr = self.features(images)
        obj, deltas = self.rpn(pyr)
        return pyr, obj, deltas

    def anchors(self, device) -> torch.Tensor:
        """The pyramid's anchors (N, 4) at ``cfg.img_size`` on ``device``,
        made once per device."""
        device = torch.device(device)
        if device not in self._anchors:
            self._anchors[device] = torch.from_numpy(
                pyramid_anchors(self.cfg.img_size)[0]).to(device)
        return self._anchors[device]

    def run_box_head(self, pyr, rois: torch.Tensor):
        """Pyramid (NCHW, P2 first) and rois (B, R, 4) → class logits
        (B, R, C+1) and per-class deltas (B, R, C, 4). The crops come from
        the first ``roi_levels`` levels (never P6), the head runs over all
        B·R rois at once. In training mode a model with ``dropblock_p`` > 0
        applies DropBlock (block 3) to the crops first, and the pyramid
        gets the crops' gradient (the rois get none)."""
        b, r = rois.shape[:2]
        nl = self.cfg.roi_levels
        crops = multilevel_roi_align(
            [p.permute(0, 2, 3, 1) for p in pyr[:nl]], rois, STRIDES[:nl],
            out_size=7, method=self.cfg.roi_method)
        crops = crops.reshape(b * r, *crops.shape[2:])
        if self.head_dropblock is not None:
            crops = self.head_dropblock(
                crops.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        scores, deltas = self.box_head(crops)
        return (scores.reshape(b, r, -1),
                deltas.reshape(b, r, *deltas.shape[1:]))


@functools.lru_cache(maxsize=8)
def pyramid_anchors(img_size: int) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """The RPN anchors of every level P2..P6 of a square input (numpy), and
    each level's count, made once per size."""
    return rpn_pyramid_anchors(img_size, STRIDES, ANCHOR_SIZES, RATIOS)


def generate_proposals(obj_logits: torch.Tensor, deltas: torch.Tensor,
                       anchors: torch.Tensor, level_counts: Tuple[int, ...],
                       img_size: int, cfg: RCNNConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Proposals of a batch: obj_logits (B, N) and deltas (B, N, 4) over
    every level, anchors (N, 4) → (proposals (B, P, 4), scores (B, P),
    valid (B, P)) with P = ``rpn_post_nms_topk``.

    torchvision's semantics: per level the top ``rpn_pre_nms_topk`` logits
    (ties lower index first), decoded, clipped, boxes under 1e-3 px
    dropped, and NMS within the level (one ``batched_nms`` call over the
    batch per level, each level capped at P); then the joint top P."""
    boxes_all, scores_all = [], []
    start = 0
    for cnt in level_counts:
        sl = slice(start, start + cnt)
        start += cnt
        k = min(cfg.rpn_pre_nms_topk, cnt)
        s, i = _topk(obj_logits[:, sl], k)
        d = torch.gather(deltas[:, sl], 1, i[..., None].expand(-1, -1, 4))
        b = clip_boxes(decode_deltas(anchors[sl][i], d), img_size, img_size)
        ok = ((b[..., 2] - b[..., 0]) > 1e-3) & \
            ((b[..., 3] - b[..., 1]) > 1e-3)
        s = torch.where(ok, torch.sigmoid(s), torch.zeros_like(s))
        lb, ls, _, _ = batched_nms(
            b, s, torch.zeros_like(i, dtype=torch.int32),
            iou_thres=cfg.rpn_nms_thresh, score_thres=0.0, pre_nms_topk=k,
            max_det=min(k, cfg.rpn_post_nms_topk), class_aware=False)
        boxes_all.append(lb)
        scores_all.append(ls)
    boxes = torch.cat(boxes_all, 1)
    scores = torch.cat(scores_all, 1)
    k = min(cfg.rpn_post_nms_topk, scores.shape[1])
    ps, oi = _topk(scores, k)
    pb = torch.gather(boxes, 1, oi[..., None].expand(-1, -1, 4))
    if k < cfg.rpn_post_nms_topk:      # fewer candidates than proposals
        pad = cfg.rpn_post_nms_topk - k
        pb = F.pad(pb, (0, 0, 0, pad))
        ps = F.pad(ps, (0, pad))
    return pb, ps, ps > 0.0


def faster_rcnn_infer(model: FasterRCNN, images: torch.Tensor,
                      cfg: RCNNConfig = None):
    """Batched inference: images (B, S, S, 3) float in [0, 1], S =
    ``cfg.img_size`` → fixed-shape dets (boxes (B, max_det, 4), scores,
    classes, valid): the network's forward, then
    :func:`detect_from_features`."""
    cfg = cfg or model.cfg
    if images.shape[1:3] != (cfg.img_size, cfg.img_size):
        raise ValueError(f"FasterRCNN at img_size {cfg.img_size} got images "
                         f"of {tuple(images.shape[1:3])}")
    return detect_from_features(model, *model(images), cfg)


def detect_from_features(model: FasterRCNN, pyr, obj: torch.Tensor,
                         deltas: torch.Tensor, cfg: RCNNConfig = None):
    """The second half of :func:`faster_rcnn_infer`, from the pyramid and
    the RPN outputs: proposals, the box head over them, and
    :func:`box_dets`: per-class boxes decoded with weights (10, 10, 5, 5)
    and clipped, class probabilities (softmax without the background, zero
    on invalid proposals), and one class-aware NMS over the top 2048 (box,
    class) pairs."""
    cfg = cfg or model.cfg
    _, counts = pyramid_anchors(cfg.img_size)
    props, _, pvalid = generate_proposals(
        obj, deltas, model.anchors(obj.device), counts, cfg.img_size, cfg)
    scores, head_deltas = model.run_box_head(pyr, props)
    return box_dets(scores, head_deltas, props, pvalid, cfg)


def box_dets(scores: torch.Tensor, head_deltas: torch.Tensor,
             props: torch.Tensor, pvalid: torch.Tensor, cfg: RCNNConfig):
    """The box head's outputs over the proposals → fixed-shape dets: class
    logits (B, R, C+1) and per-class deltas (B, R, C, 4) decoded against
    the proposals (B, R, 4)."""
    b, r, nc1 = scores.shape
    probs = torch.softmax(scores, -1)[..., 1:] * pvalid[..., None]
    boxes = clip_boxes(decode_deltas(props[:, :, None, :], head_deltas,
                                     (10.0, 10.0, 5.0, 5.0)),
                       cfg.img_size, cfg.img_size)
    nc = nc1 - 1
    flat_c = torch.arange(nc, dtype=torch.int32, device=scores.device)
    return batched_nms(boxes.reshape(b, r * nc, 4), probs.reshape(b, r * nc),
                       flat_c.repeat(b, r), iou_thres=cfg.nms_thresh,
                       score_thres=cfg.score_thresh,
                       pre_nms_topk=min(r * nc, 2048), max_det=cfg.max_det)


# ---------------------------------------------------------------------------
# training: sampling, assignment, losses
# ---------------------------------------------------------------------------

class RCNNDraws(NamedTuple):
    """The uniform [0, 1) draws of one batch's sampling, three (B, n) each
    (foreground priority, background priority, the final order), as the
    reference's ``_sample_balanced`` draws them per image: ``rpn`` over the
    anchors, ``box`` over the proposals with the gts appended."""
    rpn: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    box: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def draw_sampling(generator: torch.Generator, batch: int, n_anchors: int,
                  n_rois: int) -> RCNNDraws:
    """A batch's :class:`RCNNDraws` from ``generator``, on its device."""
    def three(n):
        return tuple(torch.rand((batch, n), generator=generator,
                                device=generator.device) for _ in range(3))
    return RCNNDraws(three(n_anchors), three(n_rois))


def _top_quota_mask(pri: torch.Tensor, mask: torch.Tensor,
                    quota: torch.Tensor, max_quota: int) -> torch.Tensor:
    """Per row, the ``quota`` (B,) highest-priority entries of ``mask``
    (B, n), quota ≤ ``max_quota``, by the reference's threshold: the
    quota-th largest priority, so no full ranking is made. Uniform
    priorities can tie (about 2⁻²⁴ a pair), and then ``pri >= thr``
    selects quota + 1 rows; the final fixed-size top-k of
    :func:`_sample_balanced` absorbs the extra one, as in the
    reference."""
    if max_quota <= 0:
        return torch.zeros_like(mask)
    top = torch.topk(pri, max_quota, dim=-1).values
    kth = top.gather(-1, (quota - 1).clamp(0, max_quota - 1)[:, None])[:, 0]
    thr = torch.where(quota > 0, kth, torch.full_like(kth, math.inf))
    return mask & (pri >= thr[:, None])


def _sample_balanced(fg: torch.Tensor, bg: torch.Tensor, batch: int,
                     pos_frac: float, draws) -> Tuple[torch.Tensor, ...]:
    """torchvision's BalancedPositiveNegativeSampler at fixed shapes: per
    row of fg/bg (B, n), up to ``batch · pos_frac`` random foreground and
    the rest random background. ``draws``: the three (B, n) uniforms of
    :class:`RCNNDraws`. Returns (idx (B, batch), is_fg, valid); the
    selected rows come first (foreground, then background), ties of the
    final order broken by the lower index, as ``jax.lax.top_k`` does."""
    u_fg, u_bg, u_g = draws
    n = fg.shape[-1]
    batch = min(batch, n)
    fg_pri = torch.where(fg, u_fg, -1.0)
    bg_pri = torch.where(bg, u_bg, -1.0)
    max_fg = int(batch * pos_frac)
    quota = torch.full(fg.shape[:1], max_fg, dtype=torch.long,
                       device=fg.device)
    sel_fg = _top_quota_mask(fg_pri, fg, quota, max_fg)
    sel_bg = _top_quota_mask(bg_pri, bg, batch - sel_fg.sum(-1), batch)
    pri = sel_fg.float() * 2.0 + sel_bg.float() * 1.0 + u_g * 1e-3
    _, idx = _topk(pri, batch)
    return idx, sel_fg.gather(-1, idx), (sel_fg | sel_bg).gather(-1, idx)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x`` (B, n, ...) at ``idx`` (B, k) along dim 1."""
    return x.gather(1, idx.reshape(*idx.shape, *(1,) * (x.dim() - 2))
                    .expand(*idx.shape, *x.shape[2:]))


def assign_rpn_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                       gt_mask: torch.Tensor, cfg: RCNNConfig, draws):
    """The RPN's assignment and sampling of a batch (torchvision's Matcher
    with low-quality matches): anchors (N, 4), gts (B, M, 4) xyxy with
    their mask (B, M), ``draws`` the three (B, N) uniforms. An anchor is
    foreground at IoU ≥ ``rpn_fg_iou`` or as one of a gt's best anchors
    (within a relative 1e-6 and above 0), background below ``rpn_bg_iou``;
    an image without gts has no foreground. Returns the sampled (idx,
    is_fg, valid, matched gt), each (B, rpn_batch). The IoU of each image
    is one ``iou_matrix`` call."""
    iou = torch.stack([iou_matrix(anchors, g) for g in gt_boxes])
    iou = torch.where(gt_mask[:, None, :], iou, -1.0)
    best_iou, best_gt = iou.amax(dim=2), iou.argmax(dim=2)  # first best
    fg = best_iou >= cfg.rpn_fg_iou
    bg = best_iou < cfg.rpn_bg_iou           # also every anchor without gts
    thr = iou.amax(dim=1) * (1.0 - 1e-6)     # each gt's best, relative slack
    low_q = ((iou >= thr[:, None, :]) & gt_mask[:, None, :] &
             (iou > 0)).any(dim=2)
    fg = fg | low_q
    bg = bg & ~fg
    fg = fg & gt_mask.any(dim=1, keepdim=True)
    idx, is_fg, valid = _sample_balanced(fg, bg, cfg.rpn_batch,
                                         cfg.rpn_pos_frac, draws)
    return idx, is_fg, valid, best_gt.gather(1, idx)


def assign_box_targets(proposals: torch.Tensor, prop_valid: torch.Tensor,
                       gt_boxes: torch.Tensor, gt_cls: torch.Tensor,
                       gt_mask: torch.Tensor, cfg: RCNNConfig, draws):
    """The box head's assignment and sampling of a batch: the gts are
    appended to the proposals (B, P, 4) (torchvision's
    add_gt_to_proposals), matched at IoU ≥ ``box_fg_iou`` (foreground) or
    below it (background), ``box_batch`` sampled at ``box_pos_frac``
    foreground; ``draws`` the three (B, P + M) uniforms. Returns (rois
    (B, S, 4), labels (0 background, else class + 1), box targets encoded
    with weights (10, 10, 5, 5), is_fg, valid)."""
    props = torch.cat([proposals, gt_boxes], 1)
    pvalid = torch.cat([prop_valid, gt_mask], 1)
    iou = torch.stack([iou_matrix(p, g) for p, g in zip(props, gt_boxes)])
    iou = torch.where(gt_mask[:, None, :] & pvalid[:, :, None], iou, -1.0)
    best_iou, best_gt = iou.amax(dim=2), iou.argmax(dim=2)  # first best
    fg = (best_iou >= cfg.box_fg_iou) & pvalid
    bg = (best_iou < cfg.box_fg_iou) & pvalid & ~fg
    idx, is_fg, valid = _sample_balanced(fg, bg, cfg.box_batch,
                                         cfg.box_pos_frac, draws)
    rois = _rows(props, idx)
    matched = best_gt.gather(1, idx)
    labels = torch.where(is_fg, gt_cls.long().gather(1, matched) + 1, 0)
    reg_t = encode_deltas(rois, _rows(gt_boxes, matched),
                          (10.0, 10.0, 5.0, 5.0))
    return rois, labels, reg_t, is_fg, valid


def smooth_l1(x: torch.Tensor, beta: float = 1.0 / 9.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def _rpn_loss_body(logits, reg, anchors, idx, is_fg, valid, matched,
                   gt_boxes):
    """The RPN loss of each image (B,) from its sampled logits and deltas
    (B, K) and (B, K, 4): the binary cross-entropy over the valid samples
    and smooth-L1 over the foreground ones, both over the valid count."""
    vf = valid.float()
    n = vf.sum(-1).clamp(min=1.0)
    tgt = is_fg.float()
    obj_l = (logits.clamp(min=0) - logits * tgt +
             torch.log1p(torch.exp(-logits.abs())))      # stable BCE
    l_obj = (obj_l * vf).sum(-1) / n
    reg_t = encode_deltas(anchors[idx], _rows(gt_boxes, matched))
    fgf = (is_fg & valid).float()
    l_reg = (smooth_l1(reg - reg_t).sum(-1) * fgf).sum(-1) / n
    return l_obj, l_reg


def rpn_loss(obj_logits, deltas, anchors, gt_boxes, gt_mask, cfg, draws):
    """The RPN loss of each image from the dense outputs (B, N) and
    (B, N, 4), gathered at the sampled anchors."""
    idx, is_fg, valid, matched = assign_rpn_targets(anchors, gt_boxes,
                                                    gt_mask, cfg, draws)
    return _rpn_loss_body(obj_logits.gather(1, idx), _rows(deltas, idx),
                          anchors, idx, is_fg, valid, matched, gt_boxes)


def rpn_logits_at(rpn: RPNHead, pyr, idx: torch.Tensor,
                  dtype: torch.dtype = torch.float32):
    """The RPN head's objectness (B, K) and deltas (B, K, 4) at ``idx``
    (B, K), flat anchor indices over every level in (h, w, a) order,
    recomputed from 3x3 patches of the pyramid (NCHW, P2 first): the dense
    head's function at those positions (out-of-map taps zero, as its SAME
    padding), whose backward is a matmul over K rows and a row scatter into
    the pyramid instead of the 3x3 conv's over every level. Operands are
    cast to ``dtype`` and their products summed in float32, as the
    reference's ``preferred_element_type``; outputs are float32."""
    b, c = pyr[0].shape[:2]
    a = A_PER_CELL
    dev = idx.device
    hs = [p.shape[2] for p in pyr]
    ws = [p.shape[3] for p in pyr]
    cells = [h * w for h, w in zip(hs, ws)]
    bounds = torch.tensor(np.cumsum([0] + [n * a for n in cells]),
                          device=dev)
    row_base = torch.tensor(np.cumsum([0] + cells[:-1]), device=dev)
    flat = torch.cat([p.permute(0, 2, 3, 1).reshape(b, -1, c) for p in pyr],
                     1)
    rows_per_img = flat.shape[1]
    lvl = (idx[..., None] >= bounds[1:-1]).sum(-1)
    pos = idx - bounds[lvl]
    cell, a_idx = pos // a, pos % a
    h = torch.tensor(hs, device=dev)[lvl]
    w = torch.tensor(ws, device=dev)[lvl]
    y, x = cell // w, cell % w
    base = row_base[lvl] + torch.arange(b, device=dev)[:, None] * \
        rows_per_img
    rows, ok = [], []
    for dy in (-1, 0, 1):                    # (kh, kw) row-major, as HWIO
        for dx in (-1, 0, 1):
            yy, xx = y + dy, x + dx
            ok.append((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w))
            rows.append(base + torch.minimum(yy.clamp(min=0), h - 1) * w +
                        torch.minimum(xx.clamp(min=0), w - 1))
    rows, ok = torch.stack(rows, -1), torch.stack(ok, -1)
    patch = torch.where(ok[..., None], flat.reshape(-1, c)[rows], 0.0)
    k = idx.shape[1]
    patch = patch.reshape(b, k, 9 * c).to(dtype).float()

    def dense(x, weight, bias):
        # weight OIHW → (in · kh · kw in HWIO row order, out)
        wk = weight.permute(2, 3, 1, 0).reshape(-1, weight.shape[0])
        return x @ wk.to(dtype).float() + bias

    t = F.relu(dense(patch, rpn.conv.weight, rpn.conv.bias)).to(dtype)
    obj = dense(t.float(), rpn.cls.weight, rpn.cls.bias)
    reg = dense(t.float(), rpn.reg.weight, rpn.reg.bias)
    obj_k = obj.gather(-1, a_idx[..., None])[..., 0]
    reg_k = reg.reshape(b, k, a, 4).gather(
        2, a_idx[..., None, None].expand(b, k, 1, 4))[:, :, 0]
    return obj_k, reg_k


def rpn_loss_sparse(rpn: RPNHead, pyr, anchors, gt_boxes, gt_mask, cfg,
                    draws, dtype: torch.dtype = torch.float32):
    """:func:`rpn_loss` with the sampled outputs recomputed by
    :func:`rpn_logits_at`: the same numbers up to the order of the conv's
    sums."""
    idx, is_fg, valid, matched = assign_rpn_targets(anchors, gt_boxes,
                                                    gt_mask, cfg, draws)
    obj_k, reg_k = rpn_logits_at(rpn, pyr, idx, dtype)
    return _rpn_loss_body(obj_k, reg_k, anchors, idx, is_fg, valid, matched,
                          gt_boxes)


def box_head_loss(scores, deltas, labels, reg_targets, is_fg, valid):
    """torchvision's fastrcnn_loss of each image: cross-entropy over C + 1
    classes and smooth-L1 on the matched class's deltas of the foreground
    rows, both over the valid count. scores (B, S, C+1), deltas
    (B, S, C, 4)."""
    vf = valid.float()
    n = vf.sum(-1).clamp(min=1.0)
    logp = F.log_softmax(scores, dim=-1)
    ce = -logp.gather(-1, labels[..., None])[..., 0]
    l_cls = (ce * vf).sum(-1) / n
    cls_idx = (labels - 1).clamp(min=0)
    d = deltas.gather(2, cls_idx[..., None, None].expand(
        *cls_idx.shape, 1, 4))[:, :, 0]
    fgf = (is_fg & valid).float()
    l_reg = (smooth_l1(d - reg_targets).sum(-1) * fgf).sum(-1) / n
    return l_cls, l_reg


def faster_rcnn_loss(model: FasterRCNN, images: torch.Tensor,
                     gt_boxes_xyxy: torch.Tensor, gt_cls: torch.Tensor,
                     gt_mask: torch.Tensor, cfg: Optional[RCNNConfig] = None,
                     draws: Union[RCNNDraws, torch.Generator, None] = None):
    """The two-stage training loss of a batch → (total, metrics): images
    (B, S, S, 3) float in [0, 1], gts (B, M, 4) xyxy pixels with classes
    and mask (B, M). Runs the network as it is set (training mode: batch
    statistics move, except where ``norm_eval`` or a frozen stage holds
    them); proposals on the RPN maps without gradient (one ``nms_mask``
    launch per level on CUDA); the sparse RPN loss; the second-stage
    assignment; the box head over the sampled rois. Each term is the mean
    over the images; the metrics are ``rpn_obj``, ``rpn_reg``, ``cls``,
    ``box`` and ``total``, 0-d tensors. ``draws``: the sampling's uniforms,
    or a generator on the images' device to draw them from."""
    cfg = cfg or model.cfg
    b = images.shape[0]
    anchors = model.anchors(images.device)
    _, counts = pyramid_anchors(cfg.img_size)
    pyr = model.features(images)
    with torch.no_grad():               # proposals use values only
        obj, deltas = model.rpn(pyr)
        props, _, pvalid = generate_proposals(obj, deltas, anchors, counts,
                                              cfg.img_size, cfg)
        del obj, deltas
    if not isinstance(draws, RCNNDraws):
        draws = draw_sampling(draws, b, anchors.shape[0],
                              props.shape[1] + gt_boxes_xyxy.shape[1])
    l_obj, l_reg = rpn_loss_sparse(model.rpn, pyr, anchors, gt_boxes_xyxy,
                                   gt_mask, cfg, draws.rpn, model.dtype)
    rois, labels, reg_t, is_fg, valid = assign_box_targets(
        props, pvalid, gt_boxes_xyxy, gt_cls, gt_mask, cfg, draws.box)
    scores, head_deltas = model.run_box_head(pyr, rois)
    l_cls, l_box = box_head_loss(scores, head_deltas, labels, reg_t, is_fg,
                                 valid)
    metrics = {"rpn_obj": l_obj.mean(), "rpn_reg": l_reg.mean(),
               "cls": l_cls.mean(), "box": l_box.mean()}
    total = metrics["rpn_obj"] + metrics["rpn_reg"] + metrics["cls"] + \
        metrics["box"]
    metrics["total"] = total
    return total, metrics
