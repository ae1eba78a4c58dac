"""FasterRCNN, the inference half; counterpart of
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
dense layers in float32. The training half (assigners, sampling, losses)
comes with the training slice.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from heltondetection_tpu_torch.models.backbones import build_backbone
from heltondetection_tpu_torch.models.common import CastConv2d, CastLinear
from heltondetection_tpu_torch.models.dropblock import DropBlock
from heltondetection_tpu_torch.models.necks import FPN, PAFPNv8
from heltondetection_tpu_torch.ops.anchors import rpn_pyramid_anchors
from heltondetection_tpu_torch.ops.boxes import clip_boxes, decode_deltas
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
        B·R rois at once."""
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
