"""Image detector over a serve step or a forward; counterpart of
``Detector`` in heltondetection_tpu/engine/infer.py, without TTA/WBF, video
and file frontends (they come with the inference-surface slice)."""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from heltondetection_tpu_torch.data.letterbox import letterbox_np
from heltondetection_tpu_torch.device import resolve_device
from heltondetection_tpu_torch.engine.evaluator import make_postprocess


class Detector:
    """Batched detection over RGB frames of any sizes.

    ``detect_fn(images (B, S, S, 3) uint8) → (boxes, scores, classes,
    valid)`` in letterbox coordinates, e.g. the step of
    :func:`heltondetection_tpu_torch.engine.evaluator.make_packed_serve_step`.
    Or, with ``detect_fn=None``, ``forward_fn(images) → (boxes, obj, cls)``
    (e.g. ``engine.runner.forward_for_eval``) followed by the single-label
    :func:`make_postprocess` at ``conf_thres``, ``iou_thres`` and
    ``max_det``, whose NMS is the ``nms_mask`` kernel on CUDA.
    Frames are letterboxed on the host and go to ``device`` (CUDA unless
    ``device="cpu"``) as one uint8 batch."""

    def __init__(self, detect_fn: Optional[Callable], num_classes: int,
                 img_size: int, *, forward_fn: Optional[Callable] = None,
                 conf_thres: float = 0.25, iou_thres: float = 0.45,
                 max_det: int = 300, tta: bool = False, device=None):
        if tta:
            raise NotImplementedError("TTA/WBF is not ported yet")
        if (detect_fn is None) == (forward_fn is None):
            raise ValueError("need exactly one of detect_fn and forward_fn")
        self.device = resolve_device(device)
        self.num_classes = num_classes
        self.img_size = img_size
        if detect_fn is None:
            post = make_postprocess(num_classes, conf_thres=conf_thres,
                                    iou_thres=iou_thres, max_det=max_det,
                                    multi_label=False)

            @torch.inference_mode()
            def detect_fn(images):
                return post(*forward_fn(images))

        self._detect = detect_fn

    def detect_image(self, img_rgb: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One RGB image → (boxes xyxy in source coords, scores, classes)."""
        return self.detect_batch([img_rgb])[0]

    def detect_batch(self, frames: Sequence[np.ndarray]
                     ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Same-or-mixed-size RGB frames → per-frame (boxes, scores,
        classes) in source coordinates, one device dispatch for the batch."""
        lbs, metas = [], []
        for f in frames:
            lb, _, meta = letterbox_np(f, np.zeros((0, 4), np.float32),
                                       self.img_size)
            lbs.append(lb)
            metas.append(meta)
        x = torch.from_numpy(np.stack(lbs)).to(self.device)
        ob, os_, oc, ov = (t.cpu().numpy() for t in self._detect(x))
        return [self._to_source(ob[i], os_[i], oc[i], ov[i], metas[i],
                                frames[i].shape[:2])
                for i in range(len(frames))]

    def _to_source(self, boxes, scores, classes, valid, meta, hw):
        v = np.asarray(valid).astype(bool)
        b = np.asarray(boxes)[v]
        b = (b - [meta["pad_x"], meta["pad_y"]] * 2) / meta["scale"]
        h, w = hw
        b[:, [0, 2]] = b[:, [0, 2]].clip(0, w)
        b[:, [1, 3]] = b[:, [1, 3]].clip(0, h)
        return b, np.asarray(scores)[v], np.asarray(classes)[v]
