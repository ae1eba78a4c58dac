"""Image and video detector over a serve step or a forward, with TTA views
fused by WBF on the device; counterpart of heltondetection_tpu/engine/infer.py.

    image → letterbox → step (forward, decode, NMS) → source coordinates
    TTA: identity, horizontal flip and rescaled views → WBF → the same
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from heltondetection_tpu_torch.data.letterbox import letterbox_np
from heltondetection_tpu_torch.engine.evaluator import make_postprocess
from heltondetection_tpu_torch.ops.wbf import weighted_boxes_fusion


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
    ``device="cpu"``) as one uint8 batch.

    ``tta=True`` runs 1 + len(tta_scales) views per batch, each one
    dispatch of the same step (so the step must take any S that is a
    multiple of 32): the frames, their horizontal flip, and for each scale
    after the first a letterbox at ``round(img_size·scale/32)·32``. The
    views' dets are mapped to the first view's coordinates and fused by
    :func:`weighted_boxes_fusion` at ``wbf_iou`` into ``max_det`` dets per
    frame, all on the device; only the fused dets cross to the host.

    ``mesh`` (``parallel.mesh.Mesh``; default the one device ``device``):
    ``detect_fn`` or ``forward_fn`` is a sequence of one function a device
    of the mesh, each over its replica, or one function for a mesh of one;
    a batch is split by rows over the devices (it must divide by their
    count) and the dets come back concatenated on the first device, which
    is the detector's ``device``. ``BatchingDetector`` serves such a
    detector over every device of its mesh."""

    def __init__(self, detect_fn: Optional[Callable], num_classes: int,
                 img_size: int, *, forward_fn: Optional[Callable] = None,
                 conf_thres: float = 0.25, iou_thres: float = 0.45,
                 max_det: int = 300, tta: bool = False,
                 tta_scales: Sequence[float] = (1.0, 0.83),
                 wbf_iou: float = 0.55, device=None, mesh=None):
        from heltondetection_tpu_torch.parallel.mesh import mesh_functions
        if (detect_fn is None) == (forward_fn is None):
            raise ValueError("need exactly one of detect_fn and forward_fn")
        self.mesh, fns = mesh_functions(
            detect_fn if detect_fn is not None else forward_fn, mesh, device)
        self.device = self.mesh.devices[0]
        self.num_classes = num_classes
        self.img_size = img_size
        self.tta = tta
        self.tta_scales = tuple(tta_scales)
        self.wbf_iou = wbf_iou
        self.max_det = max_det
        self._n_views = (1 + len(self.tta_scales)) if tta else 1
        if detect_fn is None:
            post = make_postprocess(num_classes, conf_thres=conf_thres,
                                    iou_thres=iou_thres, max_det=max_det,
                                    multi_label=False)

            def wrap(forward):
                @torch.inference_mode()
                def detect(images):
                    return post(*forward(images))
                return detect

            fns = [wrap(f) for f in fns]
        self._steps = fns

    def _detect(self, images: torch.Tensor):
        """Each device's rows of ``images`` on its step; the dets
        concatenated in batch order on the detector's device (one device's
        as its step gives them)."""
        from heltondetection_tpu_torch.parallel.mesh import shard_batch
        outs = [step(x) for step, x in
                zip(self._steps, shard_batch(images, self.mesh))]
        if len(outs) == 1:
            return outs[0]
        return tuple(torch.cat([o[k].to(self.device) for o in outs])
                     for k in range(len(outs[0])))

    def detect_image(self, img_rgb: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One RGB image → (boxes xyxy in source coords, scores, classes),
        TTA-fused when enabled."""
        return self.detect_batch([img_rgb])[0]

    def detect_batch(self, frames: Sequence[np.ndarray]
                     ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Same-or-mixed-size RGB frames → per-frame (boxes, scores,
        classes) in source coordinates: one device dispatch per view for
        the whole batch, and with TTA one batched fusion."""
        x, metas = self._letterbox(frames, self.img_size)
        dets = self._detect_views(frames, x, metas) if self.tta \
            else self._detect(x)
        ob, os_, oc, ov = (t.cpu().numpy() for t in dets)
        return [self._to_source(ob[i], os_[i], oc[i], ov[i], metas[i],
                                frames[i].shape[:2])
                for i in range(len(frames))]

    def _letterbox(self, frames, size: int):
        """Frames → ((B, size, size, 3) uint8 on the device, their metas)."""
        lbs, metas = [], []
        for f in frames:
            lb, _, meta = letterbox_np(f, np.zeros((0, 4), np.float32), size)
            lbs.append(lb)
            metas.append(meta)
        return torch.from_numpy(np.stack(lbs)).to(self.device), metas

    def _view_dets(self, frames, x, metas):
        """The dets of every TTA view, (B, K, …) tensors on the device in
        the first view's letterbox coordinates: [(boxes, scores, classes,
        valid)] for the identity, the flip and each further scale."""
        s = self.img_size
        views = [self._detect(x)]
        ob, os_, oc, ov = self._detect(x.flip(2))
        views.append((torch.stack([s - ob[..., 2], ob[..., 1],
                                   s - ob[..., 0], ob[..., 3]], -1),
                      os_, oc, ov))

        def factors(ms):
            scale = torch.tensor([m["scale"] for m in ms], dtype=torch.float32,
                                 device=self.device)[:, None, None]
            pad = torch.tensor([[m["pad_x"], m["pad_y"]] * 2 for m in ms],
                               dtype=torch.float32,
                               device=self.device)[:, None, :]
            return scale, pad

        scale1, pad1 = factors(metas)
        for sc in self.tta_scales[1:]:
            ns = int(round(s * sc / 32)) * 32
            x2, metas2 = self._letterbox(frames, ns)
            ob, os_, oc, ov = self._detect(x2)
            scale2, pad2 = factors(metas2)
            views.append(((ob.float() - pad2) / scale2 * scale1 + pad1,
                          os_, oc, ov))
        return views

    @torch.inference_mode()
    def _detect_views(self, frames, x, metas):
        views = self._view_dets(frames, x, metas)
        return weighted_boxes_fusion(
            *(torch.cat([v[k] for v in views], dim=1) for k in range(4)),
            n_views=self._n_views, iou_thres=self.wbf_iou,
            max_out=self.max_det)

    def _to_source(self, boxes, scores, classes, valid, meta, hw):
        v = np.asarray(valid).astype(bool)
        b = np.asarray(boxes)[v]
        b = (b - [meta["pad_x"], meta["pad_y"]] * 2) / meta["scale"]
        h, w = hw
        b[:, [0, 2]] = b[:, [0, 2]].clip(0, w)
        b[:, [1, 3]] = b[:, [1, 3]].clip(0, h)
        return b, np.asarray(scores)[v], np.asarray(classes)[v]

    # -- frontends ----------------------------------------------------------

    def infer_image_file(self, path: str, out_path: Optional[str] = None,
                         class_names: Optional[Sequence[str]] = None,
                         ) -> Dict:
        """Detect on an image file; with ``out_path`` also write the
        rendered boxes there (needs OpenCV)."""
        from heltondetection_tpu_torch.data.readers import imread_rgb
        from heltondetection_tpu_torch.utils.vis import draw_boxes
        img = imread_rgb(path)
        boxes, scores, classes = self.detect_image(img)
        if out_path:
            import cv2
            rendered = draw_boxes(img, boxes, scores, classes, class_names)
            cv2.imwrite(out_path, cv2.cvtColor(rendered, cv2.COLOR_RGB2BGR))
        return {"boxes": boxes, "scores": scores, "classes": classes}

    def infer_video_file(self, path: str, out_path: str,
                         class_names: Optional[Sequence[str]] = None,
                         max_frames: Optional[int] = None,
                         batch_frames: int = 8) -> int:
        """Video inference, ``batch_frames`` frames per device dispatch (the
        short tail chunk is padded to the same batch); TTA rides the same
        batched path. Needs OpenCV. Returns the frames processed."""
        import cv2
        from heltondetection_tpu_torch.utils.vis import draw_boxes
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise FileNotFoundError(path)
        fps = cap.get(cv2.CAP_PROP_FPS) or 25
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 fps, (w, h))
        bs = max(1, batch_frames)
        n = 0
        eof = False
        try:
            while not eof:
                chunk: List[np.ndarray] = []
                while len(chunk) < bs:
                    if max_frames and n + len(chunk) >= max_frames:
                        eof = True
                        break
                    ok, frame = cap.read()
                    if not ok:
                        eof = True
                        break
                    chunk.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
                if not chunk:
                    break
                real = len(chunk)
                padded = chunk + [chunk[-1]] * (bs - real)
                dets = self.detect_batch(padded)[:real]
                for rgb, (boxes, scores, classes) in zip(chunk, dets):
                    rendered = draw_boxes(rgb, boxes, scores, classes,
                                          class_names)
                    writer.write(cv2.cvtColor(rendered, cv2.COLOR_RGB2BGR))
                    n += 1
        finally:
            cap.release()
            writer.release()
        return n
