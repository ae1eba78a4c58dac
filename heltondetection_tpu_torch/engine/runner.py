"""Model construction, the eval forward and ``load_detector``; counterpart
of ``build_model``, ``_cfg_anchors``, ``_forward_for_eval`` (YOLOv5 branch),
``_config_num_classes``, ``_load_eval_variables``, ``_make_detector`` and
``load_detector`` in heltondetection_tpu/engine/runner.py. The train, eval
and test orchestration (``run_train``, ``run_eval``, ``run_test``) comes
with the training slice (ROADMAP A9)."""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Callable, Optional

import torch

from heltondetection_tpu_torch.configs.base import (ExperimentConfig,
                                                    load_config)
from heltondetection_tpu_torch.device import resolve_device
from heltondetection_tpu_torch.models.yolov5 import YOLOv5, decode_full
from heltondetection_tpu_torch.ops.anchors import normalize_anchors
from heltondetection_tpu_torch.utils import ckpt as ckpt_io

_log = logging.getLogger("heltondetection_tpu_torch")


def build_model(mc, num_classes: int) -> YOLOv5:
    """The model of a ``ModelConfig``, on the CPU with uninitialised
    weights (a checkpoint fills them). ``dropblock_p``, ``remat`` and the
    freeze knobs shape training only and are not read here."""
    if mc.family == "yolov5":
        from heltondetection_tpu_torch.models.cspdarknet import VARIANTS
        if (mc.backbone or "cspdarknet") != "cspdarknet":
            raise NotImplementedError(
                f"yolov5 over backbone {mc.backbone!r}: the backbone "
                f"registry is not ported yet (ROADMAP A10)")
        d, w = VARIANTS[mc.variant]
        dtype = torch.bfloat16 if mc.dtype == "bfloat16" else torch.float32
        with torch.device("meta"):
            model = YOLOv5(num_classes=num_classes, depth_multiple=d,
                           width_multiple=w, dtype=dtype)
        return model.to_empty(device="cpu").eval()
    if mc.family == "faster_rcnn":
        raise NotImplementedError(
            "the faster_rcnn family is not ported yet (ROADMAP A12)")
    raise ValueError(f"unknown model family {mc.family}")


def _cfg_anchors(cfg: ExperimentConfig):
    """cfg.model.anchors → canonical nested tuples, or None for the v6.1
    default set: every YOLO decode and serve build site goes through this,
    so a config's custom anchors apply uniformly."""
    if getattr(cfg.model, "anchors", None) is None:
        return None
    return normalize_anchors(cfg.model.anchors)


def forward_for_eval(model: YOLOv5, num_classes: int, anchors=None,
                     device=None) -> Callable:
    """``fwd(images (B, S, S, 3) uint8) → (boxes (B, N, 4), obj (B, N),
    cls (B, N, C))``: ``/255``, the model and ``decode_full``, the contract
    of ``Evaluator(forward_fn=…)`` and ``Detector(forward_fn=…)``. The
    model moves to ``device`` (CUDA unless ``device="cpu"``) in place, with
    channels-last weights; ``anchors`` replaces the v6.1 default set."""
    dev = resolve_device(device)
    if num_classes != model.num_classes:
        raise ValueError(f"num_classes {num_classes} != the model's "
                         f"{model.num_classes}")
    model = model.to(dev, memory_format=torch.channels_last).eval()
    kw = {} if anchors is None else {"anchors": normalize_anchors(anchors)}

    @torch.inference_mode()
    def fwd(images):
        x = torch.as_tensor(images, device=dev).float() / 255.0
        return decode_full(model(x), num_classes, **kw)

    return fwd


def _config_num_classes(cfg: ExperimentConfig) -> int:
    """The class count a train run of this config uses: explicit
    ``data.class_names`` win, else ``cfg.model.num_classes``. The reference
    also parses the val (or train) annotations for their category count
    when they are mounted; that needs the dataset readers (ROADMAP A6), so
    an annotation file that exists raises here rather than being ignored.
    Annotations that are not mounted leave the config value in charge, as
    in the reference (pure-inference hosts)."""
    if cfg.data.class_names:
        return len(cfg.data.class_names)
    ann = cfg.data.val_ann or cfg.data.train_ann
    if ann and os.path.exists(ann):
        raise NotImplementedError(
            f"deriving num_classes from the annotations at {ann} needs the "
            f"dataset readers, which are not ported yet (ROADMAP A6); set "
            f"data.class_names in the config")
    return cfg.model.num_classes


def _load_eval_variables(cfg: ExperimentConfig) -> dict:
    """The state dict to evaluate from the work dir: the EMA weights when
    the checkpoint has them, else the raw ones. ``cfg.eval.ckpt = "best"``
    loads the best-val-AP snapshot (``ckpt_best/``) instead of the newest
    rotating checkpoint, falling back to it when there is no snapshot."""
    ckpt_dir = cfg.ckpt_dir
    if getattr(cfg.eval, "ckpt", "last") == "best":
        if ckpt_io.latest_step(cfg.best_ckpt_dir) is not None:
            ckpt_dir = cfg.best_ckpt_dir
        else:
            _log.warning("eval.ckpt='best' but %s has no snapshot; falling "
                         "back to %s", cfg.best_ckpt_dir, cfg.ckpt_dir)
    return _eval_state(ckpt_io.restore_eval_variables(ckpt_dir))


def _eval_state(saved: dict) -> dict:
    return saved["ema"] if saved["ema"] is not None else saved["model"]


def load_detector(config, ckpt: Optional[str] = None, *, device=None,
                  **detector_kwargs):
    """Load a trained run as a ready
    :class:`~heltondetection_tpu_torch.engine.infer.Detector` (also
    exported as ``heltondetection_tpu_torch.load_detector``).

    ``config``: an :class:`ExperimentConfig` or a path to a config file.
    ``ckpt``: ``None`` (respect ``cfg.eval.ckpt``), ``"last"``, ``"best"``,
    or an explicit checkpoint directory (``utils/ckpt.py`` layout).
    ``device``: CUDA unless ``"cpu"``. ``detector_kwargs`` override the
    config's test-time knobs (``conf_thres``, ``iou_thres``, ``tta``,
    ``tta_scales``, ``max_det``).

    >>> det = heltondetection_tpu_torch.load_detector("configs/myexp.py")
    >>> boxes, scores, classes = det.detect_image(img_rgb)
    """
    dev = resolve_device(device)
    cfg = load_config(config) if isinstance(config, (str, os.PathLike)) \
        else config
    nc = _config_num_classes(cfg)
    model = build_model(cfg.model, nc)
    if ckpt in (None, "last", "best"):
        if ckpt is not None:
            cfg = dataclasses.replace(
                cfg, eval=dataclasses.replace(cfg.eval, ckpt=ckpt))
        state = _load_eval_variables(cfg)
    else:   # explicit checkpoint directory
        state = _eval_state(ckpt_io.restore_eval_variables(ckpt))
    model.load_state_dict(state)
    return _make_detector(cfg, model, nc, device=dev, **detector_kwargs)


def _make_detector(cfg, model: YOLOv5, nc: int, *, device=None, **overrides):
    """Detector construction from the config's test-time knobs
    (overridable): the fused packed-head serve step (kernel
    ``nms_fixpoint``) unless ``cfg.eval.fused`` is off or the caller brings
    a ``detect_fn``, else :func:`forward_for_eval` and the single-label
    postprocess (kernel ``nms_mask``)."""
    from heltondetection_tpu_torch.engine.infer import Detector
    dev = resolve_device(device)
    kw = dict(conf_thres=cfg.test.conf_thres, iou_thres=cfg.test.iou_thres,
              tta=cfg.test.tta, tta_scales=cfg.test.tta_scales)
    kw.update(overrides)
    if kw.pop("int8", getattr(cfg.test, "int8", False)):
        raise NotImplementedError(
            "int8 serving is not ported yet (ROADMAP A15)")
    detect_fn = kw.pop("detect_fn", None)
    fwd = None
    if detect_fn is None:
        if getattr(cfg.eval, "fused", True):
            from heltondetection_tpu_torch.engine.evaluator import \
                make_packed_serve_step
            detect_fn = make_packed_serve_step(
                model, nc, conf_thres=kw["conf_thres"],
                iou_thres=kw["iou_thres"], max_det=kw.get("max_det", 300),
                multi_label=False, anchors=_cfg_anchors(cfg), device=dev)
        else:
            fwd = forward_for_eval(model, nc, anchors=_cfg_anchors(cfg),
                                   device=dev)
    return Detector(detect_fn, nc, cfg.model.img_size, forward_fn=fwd,
                    device=dev, **kw)
