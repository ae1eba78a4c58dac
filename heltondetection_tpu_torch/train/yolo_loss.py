"""YOLOv5 label assignment and loss; counterpart of
heltondetection_tpu/train/yolo_loss.py.

The YOLOv5 v6.1 assigner (the anchor shape-ratio match, and the cross-grid
expansion to the centre cell and one x- and one y-neighbour) and the loss:
CIoU box, BCE objectness with the per-level balance (4.0, 1.0, 0.4), BCE
classes, gains box 0.05, obj 1.0, cls 0.5 scaled by nc/80 and (img/640)²,
and the focal variants "root" (obj and cls) and "root_cls" (cls only).

Fixed shapes as in the reference: every gt expands to a block of A anchors
× 3 cells with a validity mask, and duplicate (cell, anchor) slots of
overlapping gts all count in the box and class terms. The objectness target
is a scatter-*max* of the detached, clamped CIoU over those slots
(``scatter_reduce_(reduce="amax")`` on a flat index; with duplicates the
winner of an ``index_put_`` would be undefined). The backward of the
candidate gather is a scatter-add over duplicate slots, whose float order on
CUDA varies from run to run: the card is held to a tolerance, not to bits.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from heltondetection_tpu_torch.ops.anchors import (YOLOV5_ANCHORS,
                                                   YOLOV5_STRIDES)
from heltondetection_tpu_torch.ops.boxes import bbox_iou


class YoloLossConfig(NamedTuple):
    num_classes: int = 80
    img_size: int = 640
    box_gain: float = 0.05
    obj_gain: float = 1.0
    cls_gain: float = 0.5
    anchor_t: float = 4.0
    balance: Tuple[float, ...] = (4.0, 1.0, 0.4)
    cls_pw: float = 1.0          # BCE positive weight (cls)
    obj_pw: float = 1.0
    label_smoothing: float = 0.0
    focal: str = "none"          # none | root (obj+cls) | root_cls (cls only)
    fl_gamma: float = 1.5
    fl_alpha: float = 0.25
    anchors: Optional[Tuple] = None   # per-level pixel anchors; None = v6.1


def _bce_logits(logits, targets, pos_weight=1.0):
    """Elementwise BCE-with-logits, torch's semantics with pos_weight."""
    return -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))


def _focal_bce(logits, targets, gamma, alpha, pos_weight=1.0):
    """Ultralytics' FocalLoss around BCE-with-logits."""
    loss = _bce_logits(logits, targets, pos_weight)
    p = torch.sigmoid(logits)
    p_t = targets * p + (1 - targets) * (1 - p)
    alpha_t = targets * alpha + (1 - targets) * (1 - alpha)
    return loss * alpha_t * (1.0 - p_t) ** gamma


@functools.lru_cache(maxsize=64)
def _anchors_on(level_anchors: Tuple, stride: int,
                device: torch.device) -> torch.Tensor:
    """One level's anchors in grid units on ``device``, made once: a
    blocking host-to-device copy in every step would wait for the card."""
    return torch.tensor(level_anchors, dtype=torch.float32,
                        device=device) / stride


def build_level_targets(gt_cxcywh: torch.Tensor, gt_cls: torch.Tensor,
                        gt_mask: torch.Tensor, level: int,
                        feat_hw: Tuple[int, int], cfg: YoloLossConfig,
                        anchors=YOLOV5_ANCHORS, strides=YOLOV5_STRIDES
                        ) -> Dict[str, torch.Tensor]:
    """Fixed-shape assignment for one pyramid level.

    ``gt_cxcywh`` (B, M, 4) in input pixels, ``gt_cls`` (B, M), ``gt_mask``
    (B, M) bool. Returns (B, M, A, O=3, …) candidate targets and their
    validity mask; cell indices are clamped in range (an invalid entry is
    masked out of every term)."""
    stride = strides[level]
    h, w = feat_hw
    anc = _anchors_on(tuple(map(tuple, anchors[level])), stride,
                      gt_cxcywh.device)                        # (A, 2) cells
    gxy = gt_cxcywh[..., 0:2] / stride                         # (B, M, 2)
    gwh = gt_cxcywh[..., 2:4] / stride

    # anchor shape-ratio filter: max(w/aw, aw/w, h/ah, ah/h) < anchor_t
    r = gwh[:, :, None, :] / anc[None, None, :, :]             # (B, M, A, 2)
    ratio = torch.maximum(r, 1.0 / torch.clamp(r, min=1e-9)).amax(-1)
    m_anchor = (ratio < cfg.anchor_t) & gt_mask[:, :, None]

    gx, gy = gxy[..., 0], gxy[..., 1]                          # (B, M)
    fx, fy = torch.remainder(gx, 1.0), torch.remainder(gy, 1.0)
    cx0, cy0 = torch.floor(gx), torch.floor(gy)

    # offset cells (Ultralytics g=0.5): the centre always, one x- and one
    # y-neighbour on the side of the fraction
    dx = torch.where(fx < 0.5, -1.0, 1.0)
    dy = torch.where(fy < 0.5, -1.0, 1.0)
    x_ok = torch.where(fx < 0.5, gx > 1.0, gx < (w - 1.0)) & (fx != 0.5)
    y_ok = torch.where(fy < 0.5, gy > 1.0, gy < (h - 1.0)) & (fy != 0.5)

    # O = 3: [centre, x-neighbour, y-neighbour]
    cell_x = torch.stack([cx0, cx0 + dx, cx0], dim=-1)         # (B, M, 3)
    cell_y = torch.stack([cy0, cy0, cy0 + dy], dim=-1)
    off_ok = torch.stack([torch.ones_like(x_ok), x_ok, y_ok], dim=-1)

    valid = m_anchor[:, :, :, None] & off_ok[:, :, None, :]    # (B, M, A, O)
    # clamp for safe gathers, then the int cast; validity excludes the rest
    cell_x = cell_x.clamp(0, w - 1).long()
    cell_y = cell_y.clamp(0, h - 1).long()

    # regression target in grid units, relative to each assigned cell
    txy = gxy[:, :, None, :] - torch.stack([cell_x, cell_y], -1).float()
    return {
        "cell_x": cell_x, "cell_y": cell_y,                    # (B, M, O)
        "txy": txy,                                            # (B, M, O, 2)
        "twh": gwh,                                            # (B, M, 2)
        "tcls": gt_cls,                                        # (B, M)
        "valid": valid,                                        # (B, M, A, O)
        "anchors_grid": anc,                                   # (A, 2)
    }


def _one_hot(cls: torch.Tensor, nc: int) -> torch.Tensor:
    """``jax.nn.one_hot``: an out-of-range class gives a zero row."""
    return (cls[..., None].long() ==
            torch.arange(nc, device=cls.device)).float()


def _level_terms(sel: torch.Tensor, box_lanes: int, obj_logits: torch.Tensor,
                 obj_index: torch.Tensor, t: Dict, cfg: YoloLossConfig,
                 nc: int, lvl: int):
    """One level's (box, obj, cls) terms. ``sel`` (B, M, A, O, ·) holds the
    candidate logits with the box lanes at ``box_lanes`` and the classes in
    the other slice (``[5:]`` standard, ``[:nc]`` packed); ``obj_logits``
    is the dense objectness map, ``obj_index`` (B, M, A, O) the flat index
    of each candidate slot into it."""
    valid = t["valid"]
    vf = valid.float()
    n_pos = torch.clamp(vf.sum(), min=1.0)
    pxy = torch.sigmoid(sel[..., box_lanes:box_lanes + 2]) * 2.0 - 0.5
    pwh = (torch.sigmoid(sel[..., box_lanes + 2:box_lanes + 4]) * 2.0) ** 2 \
        * t["anchors_grid"][None, None, :, None, :]
    pbox = torch.cat([pxy, pwh], dim=-1)                       # (B,M,A,O,4)
    tbox = torch.cat([t["txy"][:, :, None, :, :].expand_as(pxy),
                      t["twh"][:, :, None, None, :].expand_as(pwh)], dim=-1)
    ciou = bbox_iou(pbox, tbox, fmt="cxcywh", kind="ciou")     # (B,M,A,O)
    lbox = ((1.0 - ciou) * vf).sum() / n_pos

    # objectness target: scatter-max of the detached, clamped CIoU
    iou_d = torch.clamp(ciou.detach(), min=0.0) * vf
    tobj = torch.zeros(obj_logits.numel(), device=sel.device)
    tobj.scatter_reduce_(0, obj_index.reshape(-1), iou_d.reshape(-1),
                         reduce="amax", include_self=True)
    tobj = tobj.view_as(obj_logits)
    if cfg.focal == "root":
        obj_l = _focal_bce(obj_logits, tobj, cfg.fl_gamma, cfg.fl_alpha,
                           cfg.obj_pw)
    else:
        obj_l = _bce_logits(obj_logits, tobj, cfg.obj_pw)
    lobj = obj_l.mean() * cfg.balance[lvl]

    lcls = None
    if nc > 1:
        cp = 1.0 - 0.5 * cfg.label_smoothing
        cn = 0.5 * cfg.label_smoothing
        tc = _one_hot(t["tcls"], nc) * (cp - cn) + cn          # (B, M, nc)
        tc = tc[:, :, None, None, :].expand(*valid.shape, nc)
        # standard lanes [tx ty tw th obj cls…], packed [cls… tx ty tw th obj]
        cls_logits = sel[..., 5:] if box_lanes == 0 else sel[..., :nc]
        if cfg.focal in ("root", "root_cls"):
            cls_l = _focal_bce(cls_logits, tc, cfg.fl_gamma, cfg.fl_alpha,
                               cfg.cls_pw)
        else:
            cls_l = _bce_logits(cls_logits, tc, cfg.cls_pw)
        lcls = (cls_l * vf[..., None]).sum() / (n_pos * nc)
    return lbox, lobj, lcls


def _total(lbox, lobj, lcls, cfg: YoloLossConfig, nc: int, nl: int, b: int):
    scale = 3.0 / nl
    lbox = lbox * cfg.box_gain * scale
    lobj = lobj * cfg.obj_gain * scale * (cfg.img_size / 640.0) ** 2
    lcls = lcls * cfg.cls_gain * scale * (nc / 80.0)
    total = (lbox + lobj + lcls) * b
    return total, {"box": lbox, "obj": lobj, "cls": lcls, "total": total}


def yolo_loss(raw_outputs: Sequence[torch.Tensor], gt_cxcywh: torch.Tensor,
              gt_cls: torch.Tensor, gt_mask: torch.Tensor,
              cfg: YoloLossConfig, anchors=YOLOV5_ANCHORS,
              strides=YOLOV5_STRIDES
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The total YOLOv5 loss over all levels and its terms.

    ``raw_outputs``: per level (B, H, W, A·(5+C)) logits. The total is
    batch-scaled as Ultralytics' (per-element means, then total × B)."""
    if cfg.anchors is not None:
        anchors = cfg.anchors
    nc = cfg.num_classes
    b = raw_outputs[0].shape[0]
    zero = raw_outputs[0].new_zeros(())
    lbox, lobj, lcls = zero, zero, zero
    for lvl, raw in enumerate(raw_outputs):
        _, h, w, _ = raw.shape
        a_n = len(anchors[lvl])
        p = raw.reshape(b, h, w, a_n, 5 + nc)
        t = build_level_targets(gt_cxcywh, gt_cls, gt_mask, lvl, (h, w), cfg,
                                anchors, strides)
        bi = torch.arange(b, device=raw.device)[:, None, None, None]
        ai = torch.arange(a_n, device=raw.device)[None, None, :, None]
        flat = ((bi * h + t["cell_y"][:, :, None, :]) * w
                + t["cell_x"][:, :, None, :]) * a_n + ai       # (B, M, A, O)
        sel = p.reshape(-1, 5 + nc)[flat]                      # (B,M,A,O,5+C)
        bx, ob, cl = _level_terms(sel, 0, p[..., 4], flat, t, cfg, nc, lvl)
        lbox, lobj = lbox + bx, lobj + ob
        if cl is not None:
            lcls = lcls + cl
    return _total(lbox, lobj, lcls, cfg, nc, len(raw_outputs), b)


def yolo_loss_packed(packed_outputs, gt_cxcywh: torch.Tensor,
                     gt_cls: torch.Tensor, gt_mask: torch.Tensor,
                     cfg: YoloLossConfig, anchors=YOLOV5_ANCHORS,
                     strides=YOLOV5_STRIDES
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`yolo_loss` on the packed train head's outputs, the same math.

    ``packed_outputs``: per level ``(pobj (B, HW, A), f2 (B, HW, cin),
    [(ka (cin, CP), ba (CP)) per anchor], (h, w))`` from
    ``models.yolov5.packed_train_head``, lanes ``[cls₀..cls_{C-1}, tx, ty,
    tw, th, obj, pad]``. The head's matmul runs after the assigned feature
    rows are gathered: one cin-wide row gather shared by the anchors and
    one small GEMM, over the candidates instead of the (B, HW, ·) map."""
    if cfg.anchors is not None:
        anchors = cfg.anchors
    nc = cfg.num_classes
    b = packed_outputs[0][0].shape[0]
    zero = packed_outputs[0][0].new_zeros(())
    lbox, lobj, lcls = zero, zero, zero
    for lvl, (pobj, f2, wblocks, (h, w)) in enumerate(packed_outputs):
        a_n = len(anchors[lvl])
        t = build_level_targets(gt_cxcywh, gt_cls, gt_mask, lvl, (h, w), cfg,
                                anchors, strides)
        m = gt_cxcywh.shape[1]
        o_n = t["cell_x"].shape[-1]
        cell = t["cell_y"] * w + t["cell_x"]                   # (B, M, O)
        fsel = torch.gather(f2, 1, cell.reshape(b, m * o_n, 1)
                            .expand(-1, -1, f2.shape[-1]))     # (B, MO, cin)
        kcat = torch.cat([ka for ka, _ in wblocks], dim=1)
        bcat = torch.cat([ba for _, ba in wblocks], dim=0)
        cand = fsel @ kcat + bcat                              # (B, MO, A·CP)
        sel = cand.reshape(b, m, o_n, a_n, -1).permute(0, 1, 3, 2, 4)
        bi = torch.arange(b, device=f2.device)[:, None, None, None]
        ai = torch.arange(a_n, device=f2.device)[None, None, :, None]
        flat = (bi * (h * w) + cell[:, :, None, :]) * a_n + ai  # (B,M,A,O)
        bx, ob, cl = _level_terms(sel, nc, pobj, flat, t, cfg, nc, lvl)
        lbox, lobj = lbox + bx, lobj + ob
        if cl is not None:
            lcls = lcls + cl
    return _total(lbox, lobj, lcls, cfg, nc, len(packed_outputs), b)
