"""Fused YOLO postprocess, select-then-decode; counterpart of
heltondetection_tpu/ops/postprocess.py.

1. rank anchors by σ(obj) alone (Ultralytics v6.1's own candidate
   pre-filter is objectness-thresholded), or over the standard head
   (:func:`fused_select_decode`) by the best class's confidence
   σ(obj)·σ(max cls), and keep the top ``topk``;
2. gather one CP-wide bf16 row of class and box logits for each (the
   standard head's rows are 5+C wide) and run the v6.1 decode on those
   rows only;
3. keep each candidate's top ``max_cls_per_box`` classes, ranked in bf16
   with σ taken in float32, and take a flat top-k over the (box, class)
   pairs;
4. class-aware greedy NMS: the ``nms_fixpoint`` CUDA kernel on CUDA tensors,
   its plain version on CPU tensors (ops/nms.py).

Every top-k here is exact, a stable descending sort, so equal values come
out lower index first, as ``jax.lax.top_k`` orders them; the reference's
``approx`` knob (``lax.approx_max_k``) has no counterpart.
:func:`make_fused_postprocess` takes either head's outputs.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from heltondetection_tpu_torch.models.yolov5 import packed_cls_width
from heltondetection_tpu_torch.ops.anchors import (YOLOV5_ANCHORS,
                                                   YOLOV5_STRIDES)
from heltondetection_tpu_torch.ops.nms import (_MAX_WH, _topk,
                                               nms_mask_fixpoint_batched)
from heltondetection_tpu_torch.utils import trace


@functools.lru_cache(maxsize=16)
def _flat_decode_tables(img_hw: Tuple[int, int],
                        anchors=YOLOV5_ANCHORS,
                        strides=YOLOV5_STRIDES,
                        order: str = "yxa",
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-flat-anchor constants: grid_xy (N, 2), anchor_wh (N, 2),
    stride (N,). ``order="yxa"`` matches decode_full's (level, y, x, a)
    flattening; ``"ayx"`` the packed head's anchor-major (level, a, y, x)."""
    gxy, awh, st = [], [], []
    h_in, w_in = img_hw
    for lvl, s in enumerate(strides):
        h, w = h_in // s, w_in // s
        a = np.asarray(anchors[lvl], np.float32)          # (A, 2)
        na = len(a)
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        g = np.stack([xs, ys], -1).astype(np.float32)      # (h, w, 2) x,y
        if order == "yxa":
            gxy.append(np.repeat(g.reshape(-1, 2), na, axis=0))
            awh.append(np.tile(a, (h * w, 1)))
        else:                                              # a-major
            gxy.append(np.tile(g.reshape(-1, 2), (na, 1)))
            awh.append(np.repeat(a, h * w, axis=0))
        st.append(np.full((h * w * na,), s, np.float32))
    return (np.concatenate(gxy), np.concatenate(awh), np.concatenate(st))


@functools.lru_cache(maxsize=16)
def _decode_tables_on(img_hw, anchors, strides, order, device
                      ) -> Tuple[torch.Tensor, ...]:
    """:func:`_flat_decode_tables` as tensors on ``device``, copied once."""
    return tuple(torch.from_numpy(t).to(device) for t in
                 _flat_decode_tables(img_hw, anchors, strides, order))


def _per_candidate_classes(cls_logits: torch.Tensor, kc: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, K, C) logits → per-row top-kc (values (B, K, kc), ids (B, K, kc)),
    by kc rounds of argmax (first index on ties) and masking, in the
    logits' own dtype."""
    x = cls_logits
    vals, ids = [], []
    for _ in range(kc):
        a = torch.argmax(x, dim=-1)                        # (B, K)
        vals.append(torch.gather(x, -1, a[..., None])[..., 0])
        ids.append(a)
        x = x.scatter(-1, a[..., None], float("-inf"))
    return torch.stack(vals, -1), torch.stack(ids, -1)


def _expand_pairs(boxes: torch.Tensor, obj: torch.Tensor,
                  cls_logits: torch.Tensor, *, num_classes: int, topk: int,
                  conf_thres: float, max_cls_per_box: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-candidate class expansion (top ``max_cls_per_box`` classes) and a
    flat re-top-k over the (box, class) pairs. ``obj`` is the σ(obj)
    probability; ``cls_logits`` may be any float dtype (ranking only)."""
    b, k1 = obj.shape
    kc = min(max_cls_per_box, num_classes)
    v, ci = _per_candidate_classes(cls_logits, kc)         # (B, k1, kc)
    pair_s = obj[..., None] * torch.sigmoid(v.float())
    flat_s = torch.where(pair_s > conf_thres, pair_s,
                         torch.zeros_like(pair_s)).reshape(b, k1 * kc)
    k2 = min(topk, k1 * kc)
    top_s, top_i = _topk(flat_s, k2)
    bi = top_i // kc
    out_b = torch.gather(boxes, 1, bi[..., None].expand(-1, -1, 4))
    out_c = torch.gather(ci.reshape(b, k1 * kc), 1, top_i)
    out_c = torch.where(top_s > 0.0, out_c, -1).to(torch.int32)
    if k2 < topk:
        pad = topk - k2
        out_b = F.pad(out_b, (0, 0, 0, pad))
        top_s = F.pad(top_s, (0, pad))
        out_c = F.pad(out_c, (0, pad), value=-1)
    return out_b, top_s, out_c


def fused_select_decode(raw, num_classes: int, *, topk: int = 1024,
                        conf_thres: float = 0.001, max_cls_per_box: int = 4,
                        anchors=YOLOV5_ANCHORS, strides=YOLOV5_STRIDES,
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw head maps → top-k multi-label candidates, decoded.

    ``raw``: per level (B, H, W, A·(5+C)), ``decode_full``'s input, flat in
    (level, y, x, a) row order. Returns boxes (B, topk, 4) xyxy pixels
    f32, scores (B, topk) f32 DESC-sorted, classes (B, topk) int32 (−1 on
    sub-threshold padding rows).
    """
    c = num_classes
    b = raw[0].shape[0]
    img_hw = (raw[0].shape[1] * strides[0], raw[0].shape[2] * strides[0])

    # pass 1: each anchor's best-class confidence, per level
    best_parts, flat_parts = [], []
    for lvl, p in enumerate(raw):
        _, h, w, _ = p.shape
        p5 = p.reshape(b, h * w * len(anchors[lvl]), 5 + c)
        m = p5[..., 5:].amax(-1)                           # (B, HWA) logits
        best_parts.append(torch.sigmoid(p5[..., 4].float()) *
                          torch.sigmoid(m.float()))
        flat_parts.append(p5.to(torch.bfloat16))
    best = torch.cat(best_parts, dim=1)                    # (B, N)
    flat = torch.cat(flat_parts, dim=1)                    # (B, N, 5+C) bf16

    # pass 2: the top-k anchors by best-class confidence
    k1 = min(topk, best.shape[1])
    _, box_i = _topk(best, k1)

    # pass 3: gather and decode the selected rows only
    rows = torch.gather(flat, 1, box_i[..., None].expand(-1, -1, 5 + c)
                        ).float()                          # (B, k1, 5+C)
    gxy, awh, st = _decode_tables_on(img_hw, anchors, strides, "yxa",
                                     best.device)
    g = gxy[box_i]
    aw = awh[box_i]
    s_ = st[box_i][..., None]
    xy = (torch.sigmoid(rows[..., 0:2]) * 2.0 - 0.5 + g) * s_
    wh = (torch.sigmoid(rows[..., 2:4]) * 2.0) ** 2 * aw
    boxes = torch.cat([xy - wh * 0.5, xy + wh * 0.5], -1)

    # pass 4: the classes of each row and a flat top-k over the pairs
    return _expand_pairs(boxes, torch.sigmoid(rows[..., 4]), rows[..., 5:],
                         num_classes=c, topk=topk, conf_thres=conf_thres,
                         max_cls_per_box=max_cls_per_box)


def fused_select_decode_packed(packed, num_classes: int, *, topk: int = 1024,
                               conf_thres: float = 0.001,
                               max_cls_per_box: int = 4,
                               anchors=YOLOV5_ANCHORS,
                               strides=YOLOV5_STRIDES,
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Packed head outputs → top-k multi-label candidates, decoded.

    ``packed``: per level ``(pobj (B, A·HW) f32, [pcand_a (B, HW, CP) bf16
    per anchor], (h, w))`` from ``YOLOv5(packed_head=True)``, flat in
    anchor-major (a, y, x) row order. Returns boxes (B, topk, 4) xyxy
    pixels f32, scores (B, topk) f32 DESC-sorted, classes (B, topk) int32
    (−1 on sub-threshold padding rows).
    """
    c = num_classes
    cp = packed_cls_width(c)
    h0, w0 = packed[0][2]
    img_hw = (h0 * strides[0], w0 * strides[0])

    obj_logit = torch.cat([p[0] for p in packed], dim=1)          # (B, N)
    cand_flat = torch.cat([pc for _, pcands, _ in packed for pc in pcands],
                          dim=1)                                  # (B, N, CP)
    k1 = min(topk, obj_logit.shape[1])
    obj_l, box_i = _topk(obj_logit, k1)
    obj = torch.sigmoid(obj_l)                                    # (B, k1)

    rows = torch.gather(cand_flat, 1, box_i[..., None].expand(-1, -1, cp))
    box_rows = rows[..., c:c + 4].float()                         # (B, k1, 4)
    gxy, awh, st = _decode_tables_on(img_hw, anchors, strides, "ayx",
                                     obj_logit.device)
    g = gxy[box_i]
    aw = awh[box_i]
    s_ = st[box_i][..., None]
    xy = (torch.sigmoid(box_rows[..., 0:2]) * 2.0 - 0.5 + g) * s_
    wh = (torch.sigmoid(box_rows[..., 2:4]) * 2.0) ** 2 * aw
    boxes = torch.cat([xy - wh * 0.5, xy + wh * 0.5], -1)

    # mask box/pad lanes out of the class top-k, in bf16 like the reference
    lane = torch.arange(cp, device=rows.device)
    cls_rows = torch.where(lane < c, rows,
                           torch.tensor(-1e4, dtype=rows.dtype,
                                        device=rows.device))
    return _expand_pairs(boxes, obj, cls_rows, num_classes=c, topk=topk,
                         conf_thres=conf_thres,
                         max_cls_per_box=max_cls_per_box)


def nms_sorted_candidates(boxes: torch.Tensor, scores: torch.Tensor,
                          classes: torch.Tensor, *, iou_thres: float = 0.65,
                          max_det: int | None = 300,
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """Batched class-aware NMS on score-DESC-sorted candidates.

    boxes (B, K, 4), scores (B, K), classes (B, K) → fixed (B, max_det)
    dets (boxes, scores, classes, valid). ``max_det=None`` skips the final
    compacting top-k: the (B, K) rows come back in candidate order with
    suppressed and invalid rows masked out.
    """
    b, k, _ = boxes.shape
    valid = scores > 0.0
    nb = boxes + classes.float()[..., None] * _MAX_WH      # class offset
    nb = torch.where(valid[..., None], nb, torch.zeros_like(nb))  # inert pad
    keep = nms_mask_fixpoint_batched(nb, iou_thres)
    if max_det is None:
        out_valid = keep & valid
        out_s = torch.where(out_valid, scores, torch.zeros_like(scores))
        out_b = torch.where(out_valid[..., None], boxes,
                            torch.zeros_like(boxes))
        out_c = torch.where(out_valid, classes, -1)
        return out_b, out_s, out_c, out_valid
    kept_s = torch.where(keep & valid, scores, torch.full_like(scores, -1.0))
    md = min(max_det, k)
    out_s, oi = _topk(kept_s, md)
    out_valid = out_s > 0.0
    out_b = torch.where(out_valid[..., None],
                        torch.gather(boxes, 1, oi[..., None].expand(-1, -1, 4)),
                        torch.zeros((), dtype=boxes.dtype, device=boxes.device))
    out_c = torch.where(out_valid, torch.gather(classes, 1, oi), -1)
    out_s = torch.where(out_valid, out_s, torch.zeros_like(out_s))
    if md < max_det:
        pad = max_det - md
        out_b = F.pad(out_b, (0, 0, 0, pad))
        out_s = F.pad(out_s, (0, pad))
        out_c = F.pad(out_c, (0, pad), value=-1)
        out_valid = F.pad(out_valid, (0, pad))
    return out_b, out_s, out_c, out_valid


def make_fused_postprocess(num_classes: int, *, conf_thres: float = 0.001,
                           iou_thres: float = 0.65, pre_nms_topk: int = 1024,
                           max_det: int | None = 300,
                           max_cls_per_box: int = 4,
                           anchors=YOLOV5_ANCHORS, strides=YOLOV5_STRIDES):
    """The batch postprocess over head outputs → dets (B, max_det, …):
    the packed head's per-level ``(pobj, [pcand_a], (h, w))`` through
    :func:`fused_select_decode_packed`, the standard head's raw maps
    through :func:`fused_select_decode`."""

    def post(raw):
        packed = isinstance(raw[0], (tuple, list))
        select = fused_select_decode_packed if packed else fused_select_decode
        with trace.span("ops.postprocess", device=True):
            cb, cs, cc = select(
                raw, num_classes, topk=pre_nms_topk, conf_thres=conf_thres,
                max_cls_per_box=max_cls_per_box, anchors=anchors,
                strides=strides)
            return nms_sorted_candidates(cb, cs, cc, iou_thres=iou_thres,
                                         max_det=max_det)

    return post
