"""Evaluation engine: batched postprocess on the device, COCO mAP on the
host; counterpart of heltondetection_tpu/engine/evaluator.py.

    for batch: forward → decode → (multi-label select) → class-aware NMS
    → letterbox inverse → accumulate dets → COCO AP50 / mAP50-95

Two routes end in the same ``Evaluator``: ``forward_fn`` (e.g.
``engine.runner.forward_for_eval``: the model and ``decode_full``) followed
by :func:`make_postprocess`, whose NMS is the ``nms_mask`` CUDA kernel; or
``step_fn`` = :func:`make_packed_serve_step`, whose NMS is the
``nms_fixpoint`` kernel. Only the fixed-shape (B, max_det) det arrays
cross to the host.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from heltondetection_tpu_torch.device import resolve_device
from heltondetection_tpu_torch.models.yolov5 import YOLOv5, packed_copy
from heltondetection_tpu_torch.ops.nms import _topk, batched_nms
from heltondetection_tpu_torch.ops.postprocess import make_fused_postprocess
from heltondetection_tpu_torch.utils import trace
from heltondetection_tpu_torch.utils.cocoeval import DetEval, format_summary


def multilabel_candidates(boxes: torch.Tensor, obj: torch.Tensor,
                          cls: torch.Tensor, *, topk: int,
                          conf_thres: float, max_cls_per_box: int = 4,
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """(B, N, 4), (B, N), (B, N, C) → the top-k (box, score, class) pairs,
    (B, topk, …), scores DESC-sorted.

    1. keep the ``topk`` boxes ranked by best-class confidence;
    2. per kept box, keep its ``max_cls_per_box`` best classes;
    3. flat top-k over the surviving (box, class) pairs, conf = obj·cls,
       pairs at or below ``conf_thres`` scored 0.
    Rows past k1·kc pairs are padding: a zero box, score 0, class −1.
    """
    b, n, c = cls.shape
    best = obj * cls.amax(-1)                                  # (B, N)
    k1 = min(topk, n)
    _, box_i = _topk(best, k1)                                 # (B, k1)
    sel_boxes = torch.gather(boxes, 1, box_i[..., None].expand(-1, -1, 4))
    conf = (torch.gather(obj, 1, box_i)[..., None] *
            torch.gather(cls, 1, box_i[..., None].expand(-1, -1, c)))
    kc = min(max_cls_per_box, c)
    v, ci = _topk(conf, kc)                                    # (B, k1, kc)
    flat = torch.where(v > conf_thres, v,
                       torch.zeros_like(v)).reshape(b, k1 * kc)
    k2 = min(topk, k1 * kc)
    top_s, top_i = _topk(flat, k2)
    box_idx = top_i // kc
    out_c = torch.gather(ci.reshape(b, k1 * kc), 1, top_i).to(torch.int32)
    out_b = torch.gather(sel_boxes, 1, box_idx[..., None].expand(-1, -1, 4))
    if k2 < topk:
        pad = topk - k2
        out_b = F.pad(out_b, (0, 0, 0, pad))
        top_s = F.pad(top_s, (0, pad))
        out_c = F.pad(out_c, (0, pad), value=-1)
    return out_b, top_s, out_c


def make_postprocess(num_classes: int, *, conf_thres: float = 0.001,
                     iou_thres: float = 0.65, pre_nms_topk: int = 1024,
                     max_det: int = 300, multi_label: bool = True
                     ) -> Callable:
    """The batch postprocess ``post(boxes (B, N, 4), obj (B, N),
    cls (B, N, C)) → dets (B, max_det, …)``: candidate selection, then
    :func:`batched_nms` (the ``nms_mask`` kernel on CUDA tensors).
    ``multi_label=False`` keeps each box's best class only."""
    del num_classes      # the width comes from ``cls``; kept for symmetry

    def post(boxes, obj, cls):
        with trace.span("ops.postprocess", device=True):
            if multi_label:
                cb, cs, cc = multilabel_candidates(
                    boxes, obj, cls, topk=pre_nms_topk,
                    conf_thres=conf_thres)
            else:
                conf = obj[..., None] * cls
                cb, cs = boxes, conf.amax(-1)
                cc = torch.argmax(conf, dim=-1).to(torch.int32)
            return batched_nms(cb, cs, cc, iou_thres=iou_thres,
                               score_thres=conf_thres,
                               pre_nms_topk=pre_nms_topk, max_det=max_det)

    return post


def make_packed_serve_step(model: YOLOv5, num_classes: int, *,
                           conf_thres: float = 0.001, iou_thres: float = 0.65,
                           pre_nms_topk: int = 1024,
                           max_det: Optional[int] = None,
                           multi_label: bool = True, anchors=None,
                           device=None, quant=None) -> Callable:
    """Build the serve step of a standard YOLOv5 ``model``: its weights are
    mapped once to the packed head (:func:`packed_copy`) on ``device`` (CUDA
    unless ``device="cpu"``), and ``step(images (B, S, S, 3) uint8 NHWC) →
    (boxes, scores, classes, valid)`` runs ``/255``, the model and the fused
    postprocess, dets (B, max_det or pre_nms_topk, …) in letterbox
    coordinates. ``multi_label=False`` keeps one class per box.

    ``quant`` (an ``ops/quant.py`` tree: ``quantize_yolo`` or
    ``quantize_yolo_flow``) runs every conv in the tree on the int8 path
    (``ops/quant.attach_quant``); the head's logits stay float and its
    candidate rows bf16."""
    dev = resolve_device(device)
    if num_classes != model.num_classes:
        raise ValueError(f"num_classes {num_classes} != the model's "
                         f"{model.num_classes}")
    model_p = packed_copy(model).to(dev, memory_format=torch.channels_last)
    if quant is not None:
        from heltondetection_tpu_torch.ops.quant import attach_quant
        model_p = attach_quant(model_p, quant)
    kw = {} if anchors is None else {"anchors": anchors}
    post = make_fused_postprocess(num_classes, conf_thres=conf_thres,
                                  iou_thres=iou_thres,
                                  pre_nms_topk=pre_nms_topk, max_det=max_det,
                                  max_cls_per_box=4 if multi_label else 1,
                                  **kw)

    @torch.inference_mode()
    def step(images):
        x = torch.as_tensor(images, device=dev).float() / 255.0
        return post(model_p(x))

    return step


def dispatch_step(step: Callable, images, device: torch.device):
    """Enqueue ``step`` on one uint8 batch and its dets' copy to the host,
    without waiting for either. ``images`` (numpy or tensor) goes up through
    pinned memory (a tensor that is pinned already is not copied again), so
    the upload does not wait for a step still queued; the dets come down
    into pinned buffers. Returns (dets on the host, the event that marks
    the copies done, or None on the CPU): call ``event.synchronize()``
    before reading the dets."""
    x = images
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if x.device != device:
        if device.type == "cuda":
            x = x.pin_memory().to(device, non_blocking=True)
        else:
            x = x.to(device)
    with torch.inference_mode():
        out = step(x)
    if device.type != "cuda":
        return tuple(out), None
    host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 .copy_(t, non_blocking=True) for t in out)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    return host, done


def dispatch_sharded(steps, images, mesh) -> List:
    """:func:`dispatch_step` of each device's rows of ``images`` (split by
    ``parallel.mesh.batch_sharding``) on that device's step, each under its
    own device (a new thread starts on device 0): a list of (dets on the
    host, event) parts, in batch order; over one device, its one part as
    :func:`dispatch_step` gives it."""
    from heltondetection_tpu_torch.parallel.mesh import batch_sharding
    parts = []
    for step, dev, (lo, hi) in zip(steps, mesh.devices,
                                   batch_sharding(mesh, len(images))):
        with torch.cuda.device(dev) if dev.type == "cuda" else \
                contextlib.nullcontext():
            parts.append(dispatch_step(step, images[lo:hi], dev))
    return parts[0] if len(parts) == 1 else parts


def fetch_dets(out) -> Tuple[np.ndarray, ...]:
    """Wait for the dets of :func:`dispatch_step` (or of each part of
    :func:`dispatch_sharded`) and return them as numpy arrays, the parts
    concatenated in batch order."""
    parts = out if isinstance(out, list) else [out]
    got = []
    for host, done in parts:
        if done is not None:
            done.synchronize()
        got.append([t.numpy() for t in host])
    if len(got) == 1:
        return tuple(got[0])
    return tuple(np.concatenate(ts) for ts in zip(*got))


class Evaluator:
    """COCO-style evaluator over an iterator of batches.

    ``forward_fn(images) → (boxes (B, N, 4), obj (B, N), cls (B, N, C))``
    is the model and decode; :func:`make_postprocess` follows it. Or
    ``step_fn(images) → (boxes, scores, classes, valid)`` (B, K, …) replaces
    both, e.g. :func:`make_packed_serve_step`. Batches are dicts with
    ``image`` (B, S, S, 3) uint8, ``img_id`` (``None`` marks a padding row),
    the letterbox's ``scale``/``pad_x``/``pad_y`` and ``orig_hw`` (h, w).
    Images go to ``device`` (CUDA unless ``device="cpu"``).

    ``mesh`` (``parallel.mesh.Mesh``, the reference's ``mesh``; default
    the one device ``device``): each batch is split by rows over the mesh's
    devices, and ``forward_fn`` or ``step_fn`` is a sequence of one
    function a device, each over its replica of the model
    (``parallel.mesh.replicate``), or one function for a mesh of one; every
    device runs its rows and the dets are concatenated in batch order. The
    batch must divide by the device count.
    """

    def __init__(self, forward_fn: Optional[Callable], num_classes: int, *,
                 conf_thres: float = 0.001, iou_thres: float = 0.65,
                 pre_nms_topk: int = 1024, max_det: int = 300,
                 multi_label: bool = True,
                 step_fn: Optional[Callable] = None, device=None,
                 mesh=None):
        from heltondetection_tpu_torch.parallel.mesh import mesh_functions
        self.num_classes = num_classes
        if step_fn is None and forward_fn is None:
            raise ValueError("need forward_fn or step_fn")
        self.mesh, fns = mesh_functions(
            step_fn if step_fn is not None else forward_fn, mesh, device)
        self.device = self.mesh.devices[0]
        if step_fn is None:
            post = make_postprocess(num_classes, conf_thres=conf_thres,
                                    iou_thres=iou_thres,
                                    pre_nms_topk=pre_nms_topk,
                                    max_det=max_det, multi_label=multi_label)

            def wrap(forward):
                def step(images):
                    return post(*forward(images))
                return step

            fns = [wrap(f) for f in fns]
        self._steps = fns
        self._step = fns[0]

    def run(self, batches: Iterable[Dict[str, Any]],
            det_eval: Optional[DetEval] = None,
            verbose: bool = False) -> Dict[str, float]:
        """Score every batch. One batch is kept in flight: each batch's
        dets start their copy to pinned host memory right after its step,
        the next batch is dispatched, and only then does the host wait for
        the previous batch's copy and accumulate it, so the letterbox
        inverse and DetEval overlap the device's next step.
        ``images_per_sec`` counts the host accumulate, not the final
        summarize."""
        ev = det_eval or DetEval(self.num_classes)
        t0 = time.perf_counter()
        n_img = self.collect(batches, ev)
        dt = time.perf_counter() - t0
        stats = ev.summarize()
        stats["images_per_sec"] = n_img / max(dt, 1e-9)
        stats["num_images"] = n_img
        if verbose:
            print(format_summary(stats))
            print(f" images/sec (incl. host accumulate) = "
                  f"{stats['images_per_sec']:.1f}")
        return stats

    def collect(self, batches: Iterable[Dict[str, Any]], det_eval) -> int:
        """Run every batch and add its dets to ``det_eval`` (anything with
        ``add_det``), without summarizing; returns the images counted.
        Spans: ``eval.dispatch`` and ``eval.accumulate`` (with its
        ``eval.wait``), one each a batch."""
        n_img = 0
        pending = None
        for batch in batches:
            with trace.span("eval.dispatch"):
                out = self._dispatch(batch["image"])
            meta = (batch["img_id"], batch["scale"], batch["pad_x"],
                    batch["pad_y"], batch["orig_hw"])
            if pending is not None:
                with trace.span("eval.accumulate"):
                    n_img += self._accumulate(det_eval, *pending)
            pending = (out, meta)
        if pending is not None:
            with trace.span("eval.accumulate"):
                n_img += self._accumulate(det_eval, *pending)
        return n_img

    def _dispatch(self, images):
        """Enqueue one batch's step and its dets' copy to the host, one part
        a device of the mesh; see :func:`dispatch_sharded`."""
        return dispatch_sharded(self._steps, images, self.mesh)

    @staticmethod
    def _accumulate(ev: DetEval, out, meta) -> int:
        """Wait for one batch's dets and add them to the DetEval. The
        letterbox inverse runs over the whole (B, K) block in one numpy
        pass."""
        with trace.span("eval.wait"):
            ob, os_, oc, ov = fetch_dets(out)
        img_ids, scale, pad_x, pad_y, orig_hw = meta
        s = np.asarray(scale, np.float32).reshape(-1, 1)
        px = np.asarray(pad_x, np.float32).reshape(-1, 1)
        py = np.asarray(pad_y, np.float32).reshape(-1, 1)
        hw = np.asarray(orig_hw, np.float32)            # (B, 2) = (h, w)
        oh, ow = hw[:, 0:1], hw[:, 1:2]
        x1 = np.clip((ob[..., 0] - px) / s, 0, ow)
        y1 = np.clip((ob[..., 1] - py) / s, 0, oh)
        x2 = np.clip((ob[..., 2] - px) / s, 0, ow)
        y2 = np.clip((ob[..., 3] - py) / s, 0, oh)
        xywh = np.stack([x1, y1, x2 - x1, y2 - y1], axis=-1)  # (B, K, 4)
        n_img = 0
        for i, img_id in enumerate(img_ids):
            if img_id is None:   # padding row of the final batch
                continue
            n_img += 1
            v = ov[i]
            if v.any():
                ev.add_det(img_id, xywh[i][v], os_[i][v], oc[i][v])
        return n_img
