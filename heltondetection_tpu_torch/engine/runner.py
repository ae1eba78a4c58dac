"""Runner: builds everything from an ExperimentConfig and owns the train
loop, periodic eval, checkpointing and resume; counterpart of
heltondetection_tpu/engine/runner.py.

Ported: ``build_dataset`` (COCO, YOLO, DOTA, VOC and VisDrone readers),
``build_model`` (YOLOv5, over a registry backbone too, and FasterRCNN),
``run_train`` for both families (single process, one card) with its
in-loop ``run_eval``: for YOLOv5 DropBlock, remat, autoanchor, multi-scale
and the on-device augmentation (``train.device_aug``); for FasterRCNN its
two-stage step with the backbone's frozen stages and
``train.backbone_pretrain`` (torchvision ResNet weights). ``run_eval``
(single process; YOLOv5's fused route on kernel ``nms_fixpoint``, its
unfused one and FasterRCNN's on ``nms_mask``) with its artifacts (the COCO
results JSON, the per-class table, the confusion matrix and curve PNGs,
the FLOPs line), ``run_test`` (an image, a directory of images or a
video, with the heat-map panels), the eval forward and ``load_detector``
for both families, each in float or W8A8 int8 (``eval.int8``,
``test.int8``: ``_int8_quant_tree`` and ``ops/quant.py``). Parts not
ported raise ``NotImplementedError`` naming their ROADMAP item: more than
one device (A14).

Where ``train.native_loader`` is set (every config's default) and the C++
loader core builds (``native/loader_core.cpp``: g++ with the OpenCV and
libjpeg development files), training and eval take the native pipelines
of ``data/native_loader.py``; otherwise the Python pipelines of
``data/augment.py``. The log says which, and why when it is the Python
one. ``HELTON_PROFILE_DIR`` and ``HELTON_DEBUG_NANS`` act on training as
in the reference (:func:`train_from_datasets`).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from heltondetection_tpu_torch.configs.base import (ExperimentConfig,
                                                    load_config)
from heltondetection_tpu_torch.device import resolve_device
from heltondetection_tpu_torch.models.faster_rcnn import (FasterRCNN,
                                                          RCNNConfig,
                                                          faster_rcnn_infer)
from heltondetection_tpu_torch.models.yolov5 import (YOLOv5, decode_full,
                                                     pack_head_variables)
from heltondetection_tpu_torch.ops.anchors import normalize_anchors
from heltondetection_tpu_torch.utils import ckpt as ckpt_io
from heltondetection_tpu_torch.utils.log import LOGGER, TBWriter, get_logger

_log = logging.getLogger(LOGGER)


def build_dataset(dc, split: str = "train"):
    """The reader of ``split`` ("train" or "val") of a ``DataConfig``:
    ``format`` is one of coco, yolo, dota, voc and visdrone."""
    from heltondetection_tpu_torch.data import readers as R
    ann = dc.train_ann if split == "train" else dc.val_ann
    imgs = dc.train_imgs if split == "train" else dc.val_imgs
    if dc.format == "coco":
        ds = R.COCODataset(ann, imgs)
    elif dc.format == "yolo":
        ds = R.YOLODataset(imgs, ann, dc.class_names)
    elif dc.format == "dota":
        ds = R.DOTADataset(imgs, ann, dc.class_names)
    elif dc.format == "voc":
        ds = R.VOCDataset(ann, imgs, dc.class_names)
    elif dc.format == "visdrone":
        ds = R.VisDroneDataset(imgs, ann, dc.class_names)
    else:
        raise ValueError(f"unknown dataset format {dc.format}")
    if getattr(dc, "cache_images", False):
        ds = R.CachedDataset(ds)
    return ds


Model = Union[YOLOv5, FasterRCNN]


def build_model(mc, num_classes: int) -> Model:
    """The model of a ``ModelConfig``, on the CPU with uninitialised
    weights (a checkpoint fills them): a YOLOv5 (``mc.backbone``, when set,
    a registry name in place of the v6.1 CSPDarknet) or a FasterRCNN
    (ResNet50 unless ``mc.backbone`` names another). ``dropblock_p``,
    ``remat`` and the FasterRCNN backbone's ``norm_eval`` and
    ``frozen_stages`` act in training mode only; the freeze knobs are the
    optimizer's."""
    dtype = torch.bfloat16 if mc.dtype == "bfloat16" else torch.float32
    if mc.family == "yolov5":
        from heltondetection_tpu_torch.models.cspdarknet import VARIANTS
        d, w = VARIANTS[mc.variant]
        with torch.device("meta"):
            model = YOLOv5(num_classes=num_classes, depth_multiple=d,
                           width_multiple=w, dtype=dtype,
                           dropblock_p=mc.dropblock_p,
                           remat=getattr(mc, "remat", False),
                           backbone=mc.backbone or "cspdarknet")
        return model.to_empty(device="cpu").eval()
    if mc.family == "faster_rcnn":
        # proposal and sampling budgets: None keeps torchvision's defaults
        budgets = {k: v for k in ("rpn_pre_nms_topk", "rpn_post_nms_topk",
                                  "rpn_batch", "box_batch")
                   if (v := getattr(mc, k, None)) is not None}
        rcfg = RCNNConfig(num_classes=num_classes, img_size=mc.img_size,
                          neck=mc.neck, head=mc.head,
                          roi_method=mc.roi_method,
                          dropblock_p=mc.dropblock_p,
                          roi_levels=mc.roi_levels,
                          backbone=mc.backbone or "resnet50",
                          backbone_norm_eval=mc.backbone_norm_eval,
                          backbone_frozen_stages=mc.backbone_frozen_stages,
                          remat=getattr(mc, "remat", False), **budgets)
        with torch.device("meta"):
            model = FasterRCNN(rcfg, dtype=dtype)
        return model.to_empty(device="cpu").eval()
    raise ValueError(f"unknown model family {mc.family}")


def _cfg_anchors(cfg: ExperimentConfig):
    """cfg.model.anchors → canonical nested tuples, or None for the v6.1
    default set: every YOLO decode and serve build site goes through this,
    so a config's custom anchors apply uniformly."""
    if getattr(cfg.model, "anchors", None) is None:
        return None
    return normalize_anchors(cfg.model.anchors)


def forward_for_eval(model: Model, num_classes: int, anchors=None,
                     device=None, quant=None) -> Callable:
    """``fwd(images (B, S, S, 3) uint8) → (boxes (B, N, 4), obj (B, N),
    cls (B, N, C))``, the contract of ``Evaluator(forward_fn=…)`` and
    ``Detector(forward_fn=…)``: ``/255`` and a YOLOv5 and ``decode_full``
    (``anchors`` replaces the v6.1 default set), or ``/255`` and
    ``faster_rcnn_infer``, whose fixed dets (B, max_det) come out as
    boxes, scores as ``obj`` and one-hot classes (zero rows where a det
    is not valid). The model moves to ``device`` (CUDA unless
    ``device="cpu"``) in place, with channels-last weights. ``quant`` (an
    ``ops/quant.py`` tree) runs its convs on the int8 path, through a
    quantized copy (``ops/quant.attach_quant``); ``model`` stays float."""
    dev = resolve_device(device)
    if num_classes != model.num_classes:
        raise ValueError(f"num_classes {num_classes} != the model's "
                         f"{model.num_classes}")
    model = model.to(dev, memory_format=torch.channels_last).eval()
    if quant is not None:
        from heltondetection_tpu_torch.ops.quant import attach_quant
        model = attach_quant(model, quant)
    if isinstance(model, FasterRCNN):
        @torch.inference_mode()
        def fwd(images):
            x = torch.as_tensor(images, device=dev).float() / 255.0
            ob, os_, oc, ov = faster_rcnn_infer(model, x)
            cls = F.one_hot(oc.clamp(min=0).long(), num_classes).float()
            return ob, os_, cls * ov[..., None]

        return fwd
    kw = {} if anchors is None else {"anchors": normalize_anchors(anchors)}

    @torch.inference_mode()
    def fwd(images):
        x = torch.as_tensor(images, device=dev).float() / 255.0
        return decode_full(model(x), num_classes, **kw)

    return fwd


def _config_num_classes(cfg: ExperimentConfig) -> int:
    """The class count a train run of this config uses (``run_train``:
    ``ds.num_classes or cfg.model.num_classes``), without a dataset object:
    explicit ``data.class_names`` win, else the val (or train) annotations
    are parsed for their category count, else ``cfg.model.num_classes``.
    Annotations that are not mounted leave the config value in charge
    (pure-inference hosts)."""
    if cfg.data.class_names:
        return len(cfg.data.class_names)
    if cfg.data.val_ann or cfg.data.train_ann:
        split = "val" if cfg.data.val_ann else "train"
        try:
            nc = build_dataset(cfg.data, split).num_classes
            if nc:
                return nc
        except (OSError, ValueError) as e:
            _log.info("could not derive num_classes from %s annotations "
                      "(%s); using cfg.model.num_classes=%d", split, e,
                      cfg.model.num_classes)
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


def _frozen_prefixes(mc) -> tuple:
    """The optimizer's freeze set: the whole backbone for
    ``freeze_backbone`` (the reference's frozen-backbone ablation), else
    FasterRCNN's ``backbone_frozen_stages`` (the stem and layer1 by
    default, torchvision's ``trainable_backbone_layers=3``)."""
    if mc.freeze_backbone:
        return ("backbone",)
    if mc.family == "faster_rcnn" and mc.backbone_frozen_stages > 0:
        from heltondetection_tpu_torch.models.backbones import \
            frozen_stage_prefixes
        return frozen_stage_prefixes(mc.backbone or "resnet50",
                                     mc.backbone_frozen_stages)
    return ()


def _net_like(model: Model, device, packed_head: bool = False) -> Model:
    """An eval-mode model of ``model``'s shape on ``device`` (channels-last
    weights), its weights left for a ``load_state_dict``."""
    with torch.device("meta"):
        if isinstance(model, FasterRCNN):
            net = FasterRCNN(model.cfg, model.dtype)
        else:
            net = YOLOv5(model.num_classes, model.depth_multiple,
                         model.width_multiple, model.num_anchors,
                         model.dtype, packed_head=packed_head,
                         backbone=model.backbone_name)
    return net.to_empty(device=device).to(
        memory_format=torch.channels_last).eval()


def _once(reuse: Dict, key: str, msg: str, *args) -> None:
    if key not in reuse:
        reuse[key] = True
        _log.info(msg, *args)


def _native_pipelines(cfg: ExperimentConfig):
    """(the ``data.native_loader`` module, None) where
    ``train.native_loader`` is set and the loader core builds here; else
    (None, why the Python pipelines are taken)."""
    if not cfg.train.native_loader:
        return None, "train.native_loader is off"
    from heltondetection_tpu_torch.data import native_loader
    if native_loader.native_loader_available():
        return native_loader, None
    from heltondetection_tpu_torch.native import loader_build_error
    return None, ("the native loader core did not build: "
                  f"{loader_build_error()}")


def run_eval(cfg: ExperimentConfig, state_dict=None, model=None,
             verbose: bool = True, dump_json: Optional[str] = None,
             _reuse: Optional[Dict] = None, *, device=None
             ) -> Dict[str, float]:
    """``--mode eval``: the val set → COCO AP, on ``device`` (CUDA unless
    ``device="cpu"``), single process.

    ``state_dict`` (with ``model``, a model of the right shape) is scored
    directly; without it the config's checkpoint is loaded
    (``cfg.eval.ckpt``: EMA weights when saved). For YOLOv5,
    ``eval.fused`` (default) runs the packed-head serve step, whose NMS is
    kernel ``nms_fixpoint``; off, ``forward_for_eval`` and
    ``make_postprocess`` (kernel ``nms_mask``). FasterRCNN always takes
    that second route, single-label, as in the reference; its own NMS
    calls are ``nms_mask`` too. ``eval.int8`` scores the int8 serving
    program: the config's quant tree (:func:`_int8_quant_tree`, calibrated
    or read from its cache) on a quantized copy of the network; the
    in-training eval (``_reuse``) logs it ignored and scores float, as the
    reference does.

    ``dump_json``: also write the detections as a COCO results JSON
    (pycocotools' ``loadRes`` format), labels mapped back to the dataset's
    category ids. ``verbose`` logs the COCO summary, the per-class AP
    table, the FLOPs and parameters of the forward, and renders the
    confusion matrix, the PR curves and the P/R/F1 curves as PNGs into the
    run's directory (``work_dir/name``) where matplotlib is installed.

    ``_reuse``: a dict owned by the caller (``run_train``'s in-loop eval)
    that keeps the parsed val set (``"ds"``, which the caller may also
    provide), the gt-registered ``DetEval`` (detections reset per call)
    and the eval network and ``Evaluator`` across calls; each call loads
    its weights into that network. Every call scores its own detections:
    the port's ``DetEval.summarize`` accumulates anew each time, where the
    reference's reused its first ``accumulate`` and reported stale stats.
    """
    from heltondetection_tpu_torch.data.augment import EvalPipeline
    from heltondetection_tpu_torch.data.loader import EvalLoader
    from heltondetection_tpu_torch.engine.evaluator import Evaluator
    from heltondetection_tpu_torch.ops.postprocess import \
        make_fused_postprocess
    from heltondetection_tpu_torch.utils.cocoeval import (DetEval,
                                                          format_summary)
    dev = resolve_device(device)
    get_logger()
    reuse = {} if _reuse is None else _reuse
    int8 = getattr(cfg.eval, "int8", False)
    if int8 and _reuse is not None:
        # the in-loop eval scores float: calibrating per epoch would cost
        # more than the eval itself
        _once(reuse, "int8_note", "eval.int8 ignored for in-training eval "
              "(float)")
        int8 = False
    if reuse.get("ds") is None:
        reuse["ds"] = build_dataset(cfg.data, "val")
    ds = reuse["ds"]
    nc = ds.num_classes or cfg.model.num_classes
    if state_dict is None:
        model = build_model(cfg.model, nc)
        state_dict = _load_eval_variables(cfg)
    elif model is None:
        model = build_model(cfg.model, nc)
    rcnn = cfg.model.family == "faster_rcnn"
    fused = not rcnn and getattr(cfg.eval, "fused", True)
    if "net" not in reuse:
        reuse["net"] = _net_like(model, dev, packed_head=fused)
    net = reuse["net"]
    net.load_state_dict(
        pack_head_variables(state_dict, nc) if fused else state_dict)
    if int8:
        # eval.int8 scores the program int8 serving runs: the quant tree
        # of these weights (calibrated on the standard model, as serving
        # calibrates, or from the cache) on a copy of the eval network
        from heltondetection_tpu_torch.ops.quant import attach_quant
        std = net
        if fused:
            std = _net_like(model, dev)
            std.load_state_dict(state_dict)
        net = attach_quant(net, _int8_quant_tree(cfg, std))
    if "evaluator" not in reuse:       # (int8 runs only with a fresh reuse)
        anchors = _cfg_anchors(cfg)
        kw = dict(conf_thres=cfg.eval.conf_thres,
                  iou_thres=cfg.eval.iou_thres, max_det=cfg.eval.max_det)
        if fused:
            post = make_fused_postprocess(
                nc, pre_nms_topk=1024,
                max_cls_per_box=4 if cfg.eval.multi_label else 1,
                **kw, **({} if anchors is None else {"anchors": anchors}))

            def step(images, net=net):
                return post(net(images.float() / 255.0))

            ev = Evaluator(None, nc, step_fn=step, device=dev)
        else:
            ev = Evaluator(forward_for_eval(net, nc, anchors=anchors,
                                            device=dev), nc,
                           multi_label=cfg.eval.multi_label and not rcnn,
                           device=dev, **kw)
        reuse["evaluator"] = ev
    det = reuse.get("det")
    if det is None:
        det = reuse["det"] = DetEval(nc)
        ds.gt_for_eval(det)
    else:
        det.reset_dets()
    # more than one process (ROADMAP A14) will take this pipeline for its
    # shard of the val set too: the reference builds it and then ignores it
    # there, which is not to be copied
    native, why = _native_pipelines(cfg)
    if native is not None:
        pipe = native.NativeEvalPipeline(
            ds, cfg.model.img_size, decode_in_pool=cfg.train.decode_in_pool)
        _once(reuse, "loader_note", "eval loader: NativeEvalPipeline (C++)")
    else:
        pipe = EvalPipeline(ds, cfg.model.img_size)
        _once(reuse, "loader_note", "eval loader: the Python EvalPipeline "
              "(%s)", why)
    with EvalLoader(pipe, cfg.eval.batch_size,
                    num_workers=cfg.train.num_workers) as loader:
        stats = reuse["evaluator"].run(loader, det_eval=det, verbose=False)
    if dump_json:
        results = det.to_coco_json(getattr(ds, "label_to_cat", None))
        with open(dump_json, "w") as f:
            json.dump(results, f)
        _log.info("wrote %d detections (COCO results format) to %s",
                  len(results), dump_json)
    if verbose:
        _log.info("eval results for %s:\n%s", cfg.name, format_summary(stats))
        _eval_artifacts(cfg, ds, det, model)
    return stats


def _eval_artifacts(cfg: ExperimentConfig, ds, det, model: Model) -> None:
    """The verbose eval's artifacts: the per-class AP table, the confusion
    matrix (conf 0.25, IoU 0.45), PR and P/R/F1 curve PNGs in the run's
    directory (where matplotlib is installed), the mean-F1 peak, and the
    forward's FLOPs and parameters, counted on a weightless copy of
    ``model`` on the meta device."""
    from heltondetection_tpu_torch.utils.cocoeval import (
        format_classwise, save_confusion_png, save_pr_curves_png,
        save_prf_curves_png)
    from heltondetection_tpu_torch.utils.flops import model_complexity
    names = getattr(ds, "class_names", None) or cfg.data.class_names
    _log.info("per-class AP (mmdet classwise table):\n%s",
              format_classwise(det.per_class_ap(), names))
    art_dir = os.path.join(cfg.work_dir, cfg.name)
    os.makedirs(art_dir, exist_ok=True)
    cm_path = os.path.join(art_dir, "confusion_matrix.png")
    pr_path = os.path.join(art_dir, "pr_curve.png")
    prf_path = os.path.join(art_dir, "prf_curve.png")
    try:
        save_confusion_png(det.confusion_matrix(), names, cm_path)
        save_pr_curves_png(det, names, pr_path)
        best_conf, best_f1 = save_prf_curves_png(det, names, prf_path)
    except (ImportError, ValueError) as e:   # matplotlib is optional
        _log.info("eval artifact rendering unavailable: %s", e)
    else:
        _log.info("eval artifacts: confusion matrix (conf 0.25, IoU 0.45) "
                  "→ %s; PR curves @0.5 → %s; P/R/F1 vs conf → %s",
                  cm_path, pr_path, prf_path)
        _log.info("mean-F1 peak %.3f at conf %.3f — the suggested "
                  "test.conf_thres for this model", best_f1, best_conf)
    comp = model_complexity(_net_like(model, torch.device("meta")),
                            cfg.model.img_size)
    _log.info("FLOPs: %.2f G/img  Params: %.2f M", comp["gflops_per_image"],
              comp["mparams"])


def _check_train_config(cfg: ExperimentConfig) -> None:
    """Raise for the train options that are not ported (naming their
    ROADMAP item) or that the reference refuses."""
    mc, tc = cfg.model, cfg.train
    if tc.spatial_shards > 1:
        # the reference refuses spatial_shards with device_aug too
        raise NotImplementedError("train.spatial_shards and every other "
                                  "multi-device path are not ported yet "
                                  "(ROADMAP A14)")
    if mc.family == "faster_rcnn" and tc.multi_scale:
        raise ValueError(
            "train.multi_scale is a yolov5 feature (the two-stage proposal "
            "and sampling budgets are tuned per resolution: train separate "
            "faster_rcnn configs per size instead)")


def _with_xyxy(s: Dict) -> Dict:
    """``s`` (a sample or a batch) with ``gt_boxes_xyxy`` added."""
    b = np.asarray(s["gt_boxes"], np.float32)
    half = b[..., 2:] * np.float32(0.5)
    s["gt_boxes_xyxy"] = np.concatenate([b[..., :2] - half,
                                         b[..., :2] + half], axis=-1)
    return s


class _XyxyTargets:
    """A train pipeline whose samples (or, for a native pipeline, whole
    batches) also carry their cxcywh gt boxes as xyxy pixels
    (``gt_boxes_xyxy``, float32), made on the host: the targets of
    FasterRCNN's step."""

    def __init__(self, pipe):
        self.pipe = pipe
        if hasattr(pipe, "sample_batch"):
            # only then: the loaders take a pipeline with sample_batch for
            # a native one
            self.sample_batch = self._sample_batch

    def __len__(self):
        return len(self.pipe)

    def sample(self, i: int, epoch: int = 0):
        return _with_xyxy(self.pipe.sample(i, epoch))

    def _sample_batch(self, idxs, epoch: int, pool):
        return _with_xyxy(self.pipe.sample_batch(idxs, epoch, pool))

    def close(self) -> None:
        if hasattr(self.pipe, "close"):
            self.pipe.close()


def run_train(cfg: ExperimentConfig, resume: bool = True, *, device=None
              ) -> Dict[str, float]:
    """``--mode train``: :func:`train_from_datasets` on the config's train
    and val readers, on ``device`` (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    val_ds = build_dataset(cfg.data, "val") if cfg.data.val_ann else None
    return train_from_datasets(cfg, build_dataset(cfg.data, "train"), val_ds,
                               resume=resume, device=dev)


def train_from_datasets(cfg: ExperimentConfig, train_ds, val_ds=None,
                        resume: bool = True, *, device=None
                        ) -> Dict[str, float]:
    """Train ``cfg``'s model on ``train_ds`` (any reader: ``__len__``,
    ``load``, ``num_classes``), scoring ``val_ds`` (a reader with
    ``gt_for_eval``) every ``eval_interval`` epochs and at the end; returns
    the best val stats (``{}`` without a val set).

    AdamW with warmup and cosine decay, EMA, the host augmentation
    pipeline and pinned uint8 uploads, checkpoints every
    ``ckpt_interval`` epochs (the newest three kept) and a best-AP
    snapshot in ``cfg.best_ckpt_dir`` with ``best.json`` beside the run;
    ``resume`` continues from the newest checkpoint in ``cfg.ckpt_dir``.
    A FasterRCNN takes its gt boxes as xyxy (made on the host) and draws
    its sampling from one generator seeded by ``train.seed + 1``, whose
    state the checkpoints keep, so a resumed run continues its stream;
    ``train.backbone_pretrain`` loads a torchvision ResNet into its
    backbone before the EMA is made. ``device_aug``, ``autoanchor`` and
    ``multi_scale`` are YOLOv5's. Single process, one device. The train
    pipeline is the native one where ``train.native_loader`` is set and
    the loader core builds (the log names the pipeline taken, and why when
    it is the Python one).

    Two environment variables, as in the reference:

    * ``HELTON_PROFILE_DIR``: the epochs run under ``torch.profiler`` (CPU
      activities, and CUDA's on the card), and its trace is written to
      ``<dir>/train-<pid>.pt.trace.json`` when training ends, however it
      ends. The profiler keeps every event of the run in memory: trace a
      few steps, not a long run.
    * ``HELTON_DEBUG_NANS``: autograd's anomaly mode is on for the run
      (the previous setting is restored after), and each step's loss and
      logged metrics (the gradient norm among them) are checked finite,
      one host read a step; a NaN raises ``FloatingPointError`` naming the
      epoch and the step within it. The reference traps NaNs in every
      jitted op; here a NaN that reaches neither a metric nor autograd's
      backward stays untrapped where it appears: one that enters only the
      optimizer's moments (caught a step later, if the update carries it
      into the loss), the EMA weights or the BatchNorm running statistics
      (which the train forward does not read), or the in-loop eval's
      outputs. Without the variable the step makes no extra host read."""
    from heltondetection_tpu_torch.data.augment import (DeviceAugPipeline,
                                                        TrainPipeline)
    from heltondetection_tpu_torch.data.loader import TrainLoader
    from heltondetection_tpu_torch.models.common import init_weights
    from heltondetection_tpu_torch.train.schedule import make_optimizer
    from heltondetection_tpu_torch.train.trainer import (create_train_state,
                                                         make_rcnn_train_step,
                                                         make_train_step,
                                                         multiscale_sizes,
                                                         resize_batch_to)
    from heltondetection_tpu_torch.train.yolo_loss import YoloLossConfig
    dev = resolve_device(device)
    _check_train_config(cfg)
    accum = max(int(getattr(cfg.train, "grad_accum", 1)), 1)
    if cfg.train.batch_size % accum:
        raise ValueError(f"batch_size ({cfg.train.batch_size}) must be "
                         f"divisible by grad_accum ({accum})")
    logger = get_logger(log_file=os.path.join(cfg.log_dir, "train.log"))
    tb = TBWriter(cfg.log_dir)
    nc = train_ds.num_classes or cfg.model.num_classes
    cfg.model.num_classes = nc
    is_rcnn = cfg.model.family == "faster_rcnn"
    model = build_model(cfg.model, nc)
    init_weights(model, torch.Generator().manual_seed(cfg.train.seed))
    model = model.to(dev, memory_format=torch.channels_last)
    tc = cfg.train
    device_aug = tc.device_aug and not is_rcnn
    if tc.autoanchor and not is_rcnn:
        _autoanchor(cfg, train_ds, logger)

    native, why = _native_pipelines(cfg)
    if device_aug:
        kw = dict(max_boxes=cfg.data.max_boxes, seed=tc.seed,
                  mosaic_p=tc.mosaic_p)
        pipe = (native.NativeDeviceAugPipeline(
                    train_ds, cfg.model.img_size,
                    decode_in_pool=tc.decode_in_pool, **kw)
                if native is not None else
                DeviceAugPipeline(train_ds, cfg.model.img_size, **kw))
        keys = TrainLoader.DEVICE_AUG_KEYS
    else:
        kw = dict(mosaic_p=tc.mosaic_p, hsv=tc.hsv, flip_p=tc.flip_p,
                  mixup_p=tc.mixup_p, max_boxes=cfg.data.max_boxes,
                  seed=tc.seed)
        pipe = (native.NativeTrainPipeline(
                    train_ds, cfg.model.img_size,
                    decode_in_pool=tc.decode_in_pool, **kw)
                if native is not None else
                TrainPipeline(train_ds, cfg.model.img_size, **kw))
        keys = TrainLoader.KEYS
    logger.info("train loader: %s%s", type(pipe).__name__,
                " (C++)" if native is not None else f" (Python: {why})",
                extra={"train_loader": {"pipeline": type(pipe).__name__,
                                        "native": native is not None,
                                        "why": why}})
    if is_rcnn:
        pipe = _XyxyTargets(pipe)
        keys = ("image", "gt_boxes_xyxy", "gt_cls", "gt_mask")
    loader = TrainLoader(pipe, tc.batch_size, seed=tc.seed,
                         num_workers=tc.num_workers, device=dev, keys=keys)
    steps_per_epoch = loader.steps_per_epoch()
    if steps_per_epoch < 1:
        raise ValueError(
            f"dataset yields 0 steps/epoch: {len(train_ds)} images < "
            f"batch_size {cfg.train.batch_size} — shrink train.batch_size "
            "or add data")
    opt = make_optimizer(
        model, cfg.train.lr,
        total_steps=steps_per_epoch * cfg.train.epochs,
        warmup_steps=int(cfg.train.warmup_epochs * steps_per_epoch),
        weight_decay=cfg.train.weight_decay,
        final_lr_frac=cfg.train.final_lr_frac, grad_clip=cfg.train.grad_clip,
        frozen_prefixes=_frozen_prefixes(cfg.model))
    rng = None
    if is_rcnn:
        rng = torch.Generator(dev).manual_seed(tc.seed + 1)
        step_fn = make_rcnn_train_step(use_ema=tc.ema, accum_steps=accum,
                                       seed=tc.seed)
    else:
        loss_cfg = YoloLossConfig(num_classes=nc,
                                  img_size=cfg.model.img_size,
                                  focal=cfg.train.focal,
                                  label_smoothing=cfg.train.label_smoothing,
                                  anchors=_cfg_anchors(cfg))
        model.packed_train = True    # the same weights, the loss's layout
        base_step = make_train_step(loss_cfg, use_ema=tc.ema,
                                    accum_steps=accum, seed=tc.seed)
        augmented = _device_augment(cfg, dev) if device_aug else None
        sized = None
        if tc.multi_scale:
            ms_sizes = multiscale_sizes(cfg.model.img_size, tc.multi_scale)
            logger.info("multi-scale training over buckets %s", ms_sizes)

            def sized(step, batch):
                # the reference's seeded, resume-stable draw per global step
                i = int(np.random.default_rng(
                    (tc.seed << 20) ^ step).integers(len(ms_sizes)))
                return resize_batch_to(batch, ms_sizes[i])

        def step_fn(state, batch):
            if augmented is not None:      # on the card, before the model
                batch = augmented(state.step, batch)
            if sized is not None:
                batch = sized(state.step, batch)
            return base_step(state, batch)

    if tc.backbone_pretrain:
        from heltondetection_tpu_torch.utils.torch_convert import \
            graft_backbone
        n = graft_backbone(model, tc.backbone_pretrain)
        logger.info("loaded a pretrained backbone (%d tensors) from %s", n,
                    tc.backbone_pretrain)
    if tc.pretrain_ckpt:
        n = ckpt_io.load_params_for_transfer(tc.pretrain_ckpt, model)
        logger.info("loaded %d transfer tensors from %s", n,
                    tc.pretrain_ckpt)
    state = create_train_state(model, opt, use_ema=tc.ema, rng=rng)

    start_epoch = 0
    if resume and ckpt_io.latest_step(cfg.ckpt_dir,
                                      ckpt_io.STATE_FILE) is not None:
        try:
            ckpt_io.restore_state(cfg.ckpt_dir, state)
            start_epoch = state.step // steps_per_epoch
            logger.info("resumed from step %d (epoch %d)", state.step,
                        start_epoch, extra={"resumed_step": state.step})
        except (ValueError, KeyError) as e:
            logger.warning("ignoring incompatible checkpoint in %s: %s",
                           cfg.ckpt_dir, e)
    mc = cfg.model
    if is_rcnn and start_epoch == 0 and \
            (mc.backbone_norm_eval or mc.backbone_frozen_stages > 0) and \
            not tc.backbone_pretrain and not tc.pretrain_ckpt:
        # the FrozenBN and frozen-stage defaults assume pretrained weights;
        # from a random init they pin a random stem and unit statistics
        logger.warning(
            "faster_rcnn is training FROM SCRATCH but backbone_norm_eval=%s/"
            "backbone_frozen_stages=%d assume a pretrained backbone: set "
            "train.backbone_pretrain (a torchvision ResNet .pth) or, for "
            "from-scratch runs, set model.backbone_norm_eval=False and "
            "backbone_frozen_stages=0", mc.backbone_norm_eval,
            mc.backbone_frozen_stages)

    logger.info("training %s: %d epochs x %d steps on %s", cfg.name,
                cfg.train.epochs, steps_per_epoch, dev)
    trace_dir = os.environ.get("HELTON_PROFILE_DIR")
    debug_nans = bool(os.environ.get("HELTON_DEBUG_NANS"))
    profiler = None
    if trace_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
    anomaly = torch.is_anomaly_enabled()
    if debug_nans:
        torch.autograd.set_detect_anomaly(True)
    writer = ckpt_io.CheckpointWriter(cfg.ckpt_dir)
    best_writer = ckpt_io.CheckpointWriter(cfg.best_ckpt_dir, max_to_keep=1)
    try:
        return _train_epochs(cfg, loader, step_fn, state, tb, logger,
                             start_epoch, val_ds, dev, writer, best_writer,
                             debug_nans)
    finally:
        loader.close()
        for w in (writer, best_writer):
            w.close()
        if debug_nans:
            torch.autograd.set_detect_anomaly(anomaly)
        tb.close()
        if profiler is not None:
            profiler.stop()
            os.makedirs(trace_dir, exist_ok=True)
            path = os.path.join(trace_dir,
                                f"train-{os.getpid()}.pt.trace.json")
            profiler.export_chrome_trace(path)
            logger.info("profiler trace → %s", path)


def _autoanchor(cfg: ExperimentConfig, train_ds, logger) -> None:
    """The YOLOv5 v6.1 anchor check at train start: the best possible
    recall of the configured anchors on the train labels, and when it is
    below 0.98 a refit that replaces ``cfg.model.anchors`` if its fitness
    is higher. The loss, the in-loop eval and ``load_detector`` read the
    anchors through :func:`_cfg_anchors`. Seeded by ``train.seed``. The
    new anchors live in this ``cfg`` only, as in the reference: the log
    line prints them for the config file, which a later process loads."""
    from heltondetection_tpu_torch.data.autoanchor import check_anchors
    new, st = check_anchors(train_ds, img_size=cfg.model.img_size,
                            anchors=_cfg_anchors(cfg), seed=cfg.train.seed)
    if new is None:
        logger.info("autoanchor: anchors fit the data (BPR %.4f over %d "
                    "boxes), keeping them", st["bpr"], st["n_boxes"],
                    extra={"autoanchor": st})
        return
    logger.info("autoanchor: BPR %.4f < 0.98, refit anchors (BPR %.4f, "
                "fitness %.4f → %.4f over %d boxes): %s", st["prev_bpr"],
                st["bpr"], st["prev_fitness"], st["fitness"], st["n_boxes"],
                new, extra={"autoanchor": dict(st, anchors=new)})
    cfg.model.anchors = new


def _device_augment(cfg: ExperimentConfig, dev) -> Callable:
    """``augmented(step, batch) → batch``: the on-device augmentation of
    ``data.device_aug`` with draws from a generator on ``dev`` seeded by
    (``train.seed``, step), so a resumed run draws what an unbroken one
    would."""
    from heltondetection_tpu_torch.data.device_aug import (
        device_augment_batch, sample_draws, step_draws_seed)
    tc = cfg.train
    gen = torch.Generator(dev)

    def augmented(step: int, batch: Dict) -> Dict:
        gen.manual_seed(step_draws_seed(tc.seed, step))
        draws = sample_draws(batch["images4"].shape[0], cfg.model.img_size,
                             gen, flip_p=tc.flip_p, mixup_p=tc.mixup_p)
        return device_augment_batch(batch, draws, hsv=tc.hsv)

    return augmented


def _check_finite(metrics: Dict[str, torch.Tensor], epoch: int,
                  step: int) -> None:
    """Raise FloatingPointError naming the epoch, the step of the epoch
    and the metrics that are not finite (one host read of them all)."""
    names = list(metrics)
    ok = torch.isfinite(torch.stack([metrics[k].detach().float().reshape(())
                                     for k in names])).tolist()
    bad = [k for k, fine in zip(names, ok) if not fine]
    if bad:
        raise FloatingPointError(f"non-finite {', '.join(bad)} at epoch "
                                 f"{epoch} step {step} (HELTON_DEBUG_NANS)")


def _train_epochs(cfg, loader, step_fn, state, tb, logger, start_epoch,
                  val_ds, dev, writer, best_writer, debug_nans: bool = False
                  ) -> Dict[str, float]:
    # a previous run's best (best.json) seeds the comparison, so a
    # restarted run cannot overwrite a better one-slot snapshot
    best: Dict[str, float] = _read_best_json(cfg)
    patience = getattr(cfg.train, "patience", None)
    best_epoch = start_epoch - 1     # a resumed run gets a fresh window
    eval_reuse: Dict = {"ds": val_ds}
    for epoch in range(start_epoch, cfg.train.epochs):
        t0 = time.perf_counter()
        agg: Dict[str, torch.Tensor] = {}
        n_steps, wait = 0, 0.0
        batches = loader.epoch(epoch)
        while True:
            tw = time.perf_counter()
            batch = next(batches, None)
            wait += time.perf_counter() - tw
            if batch is None:
                break
            if debug_nans:
                try:
                    state, metrics = step_fn(state, batch)
                except RuntimeError as e:   # anomaly mode's backward check
                    if "nan values" not in str(e):
                        raise
                    raise FloatingPointError(
                        f"NaN in the backward pass at epoch {epoch} step "
                        f"{n_steps} (HELTON_DEBUG_NANS): {e}") from e
                _check_finite(metrics, epoch, n_steps)
            else:
                state, metrics = step_fn(state, batch)
            n_steps += 1
            # device sums: one host read per epoch, not one per step
            for k, v in metrics.items():
                agg[k] = agg.get(k, 0.0) + v
        means = {k: float(v) / max(n_steps, 1) for k, v in agg.items()}
        secs = time.perf_counter() - t0
        tb.scalars(epoch, means, prefix="train/")
        logger.info("epoch %d/%d  %.1fs (loader wait %.1fs)  %s", epoch + 1,
                    cfg.train.epochs, secs, wait,
                    "  ".join(f"{k}={v:.4f}" for k, v in means.items()),
                    extra={"epoch_stats": {
                        "epoch": epoch, "steps": n_steps, "step": state.step,
                        "seconds": secs, "loader_wait_s": wait, **means}})

        last = epoch == cfg.train.epochs - 1
        stop = saved = False
        if (epoch + 1) % cfg.train.ckpt_interval == 0 or last:
            writer.save(state, state.step)
            saved = True
        if val_ds is not None and ((epoch + 1) % cfg.train.eval_interval == 0
                                   or last):
            weights = dict(state.model.state_dict())
            if state.ema is not None:
                weights.update(state.ema)
            stats = run_eval(cfg, weights, state.model, verbose=False,
                             _reuse=eval_reuse, device=dev)
            tb.scalars(epoch, {"AP": stats["AP"], "AP50": stats["AP50"]},
                       prefix="val/")
            logger.info("epoch %d val: AP=%.4f AP50=%.4f (%.1f img/s)",
                        epoch + 1, stats["AP"], stats["AP50"],
                        stats["images_per_sec"],
                        extra={"eval_stats": dict(stats, epoch=epoch)})
            if stats.get("AP", 0) > best.get("AP", -1):
                best, best_epoch = stats, epoch
                best_writer.save(state, state.step)
                _write_best_json(cfg, stats, state.step)
                logger.info("epoch %d: new best AP=%.4f → %s", epoch + 1,
                            stats["AP"], cfg.best_ckpt_dir)
            elif patience is not None and epoch - best_epoch >= patience:
                logger.info("early stop at epoch %d: no val AP improvement "
                            "since epoch %d (patience %d); best AP=%.4f",
                            epoch + 1, best_epoch + 1, patience,
                            best.get("AP", 0.0))
                stop = True
                if not saved:   # the final weights, whatever the interval
                    writer.save(state, state.step)
        if stop:
            break
    return best


def _best_json_path(cfg) -> str:
    return os.path.join(cfg.work_dir, cfg.name, "best.json")


def _write_best_json(cfg, stats: Dict[str, float], step: int) -> None:
    path = _best_json_path(cfg)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"AP": stats["AP"], "AP50": stats["AP50"], "step": step},
                  f)


def _read_best_json(cfg) -> Dict[str, float]:
    """The best val stats of an earlier run of this config, or {}."""
    try:
        with open(_best_json_path(cfg)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


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


def _make_detector(cfg, model: Model, nc: int, *, device=None,
                   **overrides):
    """Detector construction from the config's test-time knobs
    (overridable): for YOLOv5 the fused packed-head serve step (kernel
    ``nms_fixpoint``) unless ``cfg.eval.fused`` is off or the caller brings
    a ``detect_fn``; else, and always for FasterRCNN,
    :func:`forward_for_eval` and the single-label postprocess (kernel
    ``nms_mask``). ``int8`` (default ``cfg.test.int8``) serves the quant
    tree of :func:`_int8_quant_tree` on either route; a caller's
    ``detect_fn`` runs as given, with a warning."""
    from heltondetection_tpu_torch.engine.infer import Detector
    dev = resolve_device(device)
    kw = dict(conf_thres=cfg.test.conf_thres, iou_thres=cfg.test.iou_thres,
              tta=cfg.test.tta, tta_scales=cfg.test.tta_scales)
    kw.update(overrides)
    int8 = kw.pop("int8", getattr(cfg.test, "int8", False))
    detect_fn = kw.pop("detect_fn", None)
    if int8 and detect_fn is not None:
        get_logger().warning(
            "test.int8 requested but a caller-supplied detect_fn overrides "
            "the built serve step — the custom fn runs as given (float "
            "unless it quantizes itself)")
        int8 = False
    quant = _int8_quant_tree(cfg, model.to(dev)) if int8 else None
    fwd = None
    if detect_fn is None:
        if cfg.model.family == "yolov5" and getattr(cfg.eval, "fused", True):
            from heltondetection_tpu_torch.engine.evaluator import \
                make_packed_serve_step
            detect_fn = make_packed_serve_step(
                model, nc, conf_thres=kw["conf_thres"],
                iou_thres=kw["iou_thres"], max_det=kw.get("max_det", 300),
                multi_label=False, anchors=_cfg_anchors(cfg), device=dev,
                quant=quant)
        else:
            fwd = forward_for_eval(model, nc, anchors=_cfg_anchors(cfg),
                                   device=dev, quant=quant)
    return Detector(detect_fn, nc, cfg.model.img_size, forward_fn=fwd,
                    device=dev, **kw)


def _quant_cache_paths(tree: Dict) -> Dict[str, np.ndarray]:
    """Flatten a quant tree to {'/'-path: numpy array} for npz I/O."""
    flat = {}

    def _walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                _walk(v, path + (k,))
            else:
                flat["/".join(path + (k,))] = v.cpu().numpy()
    _walk(tree, ())
    return flat


def _params_fingerprint(model: Model) -> np.ndarray:
    """A cheap identity of a checkpoint for the quant cache: the count of
    parameters and BatchNorm statistics (the reference's params and
    batch_stats leaves, all of which the fold reads) and the float64 sum of
    their absolute values."""
    leaves = [t for n, t in model.state_dict().items()
              if not n.endswith("num_batches_tracked")]
    s = sum(float(t.detach().double().abs().sum()) for t in leaves)
    return np.asarray([len(leaves), s], np.float64)


def _int8_calib_spec(cfg: ExperimentConfig):
    """The validated int8 knobs of ``cfg.test``: (mode, act_clip, skip
    prefixes, their tag for the cache key)."""
    from heltondetection_tpu_torch.ops.quant import YOLO_INT8_SKIP_PRESETS
    mode = getattr(cfg.test, "int8_mode", "layer")
    if mode not in ("layer", "flow"):
        raise ValueError(
            f"test.int8_mode={mode!r} — expected 'layer' or 'flow'")
    act_clip = getattr(cfg.test, "int8_act_clip", "p999")
    if act_clip not in ("p999", "amax"):
        raise ValueError(
            f"test.int8_act_clip={act_clip!r} — expected 'p999' or 'amax'")
    skip = getattr(cfg.test, "int8_skip", None)
    tail = getattr(cfg.test, "int8_float_tail", "balanced")
    if skip is not None:
        # keyed on the list itself: the reference keys an explicit list by
        # its length, so two lists of one length share a stale cache
        skip = tuple(skip)
        tail = "skip" + json.dumps(list(skip))
    elif cfg.model.family == "yolov5":
        if tail not in YOLO_INT8_SKIP_PRESETS:
            raise ValueError(
                f"test.int8_float_tail={tail!r} — expected one of "
                f"{sorted(YOLO_INT8_SKIP_PRESETS)}")
        skip = YOLO_INT8_SKIP_PRESETS[tail]
    else:
        # the float-tail presets cover the YOLO family; two-stage models
        # keep the stem float
        skip = ("backbone/stem_conv",)
        tail = "rcnn-default"
    if mode == "flow" and cfg.model.family != "yolov5":
        _log.warning("test.int8_mode='flow' is yolov5-only — using the "
                     "per-layer W8A8 mode for %s", cfg.model.family)
        mode = "layer"
    return mode, act_clip, skip, tail


def _load_quant_cache(path: str, calib_id: str, fp: np.ndarray,
                      device) -> Optional[Dict]:
    """The tree cached at ``path`` if it was made for ``calib_id`` and
    this checkpoint, else None (logged)."""
    if not os.path.exists(path):
        return None
    try:
        z = np.load(path, allow_pickle=False)
        if (str(z["__calib_id__"]) != calib_id
                or not np.allclose(z["__fingerprint__"], fp)):
            _log.info("int8 PTQ: cache at %s is stale (checkpoint or "
                      "calibration set changed) — recalibrating", path)
            return None
        tree: Dict = {}
        for key in z.files:
            if key.startswith("__"):
                continue
            node = tree
            *parts, leaf = key.split("/")
            for p in parts:
                node = node.setdefault(p, {})
            node[leaf] = torch.from_numpy(z[key]).to(device)
    except (OSError, ValueError, KeyError) as e:
        _log.warning("int8 PTQ: unreadable cache %s (%s) — recalibrating",
                     path, e)
        return None
    _log.info("int8 PTQ: loaded cached quant tree %s", path)
    return tree


def _int8_quant_tree(cfg: ExperimentConfig, model: Model) -> Dict:
    """Calibrate ``model`` (weights loaded, on its device) and build its
    quant tree (``ops/quant.py``) on the first ``cfg.test.int8_calib``
    calibration images, letterboxed as serving letterboxes them: from
    ``cfg.test.int8_calib_dir`` (a directory of images, for hosts without
    the val split) or else the val set. ``test.int8_mode`` picks the
    per-layer or the flow tree (YOLOv5), ``int8_float_tail`` or an
    explicit ``int8_skip`` what stays float, ``int8_act_clip`` the clip.

    The tree is cached at ``{work_dir}/{name}/int8_quant.npz``, keyed by a
    calibration id (mode, skip list, clip, size and the images) and a
    fingerprint of the weights, so a later call for the same checkpoint
    and settings skips the calibration."""
    import hashlib

    from heltondetection_tpu_torch.data.letterbox import letterbox_np
    from heltondetection_tpu_torch.data.readers import IMG_EXTS, imread_rgb
    from heltondetection_tpu_torch.ops.quant import (quantize_rcnn,
                                                     quantize_yolo,
                                                     quantize_yolo_flow)
    mode, act_clip, skip, tail = _int8_calib_spec(cfg)
    n_want = int(getattr(cfg.test, "int8_calib", 32))
    calib_dir = getattr(cfg.test, "int8_calib_dir", None)
    head = f"{mode}:{tail}:{act_clip}:sz{cfg.model.img_size}"
    if calib_dir:
        files = sorted(
            os.path.join(calib_dir, f) for f in os.listdir(calib_dir)
            if os.path.splitext(f)[1].lower() in IMG_EXTS)[:n_want]
        if not files:
            raise ValueError(
                f"test.int8_calib_dir={calib_dir!r} holds no images")
        # the files' identities, so replacing an image in place invalidates
        # the cached scales
        h = hashlib.sha256()
        for f in files:
            st = os.stat(f)
            h.update(f"{os.path.basename(f)}:{st.st_mtime_ns}:"
                     f"{st.st_size};".encode())
        calib_id = (f"{head}:dir:{calib_dir}:{len(files)}:"
                    f"{h.hexdigest()[:16]}")
        n = len(files)

        def load(i):
            return imread_rgb(files[i])
    else:
        if not cfg.data.val_ann:
            raise ValueError("test.int8 needs a val set (data.val_ann) or "
                             "test.int8_calib_dir to calibrate")
        ds = build_dataset(cfg.data, "val")
        n = min(n_want, len(ds))
        if n == 0:
            raise ValueError("test.int8 needs a non-empty val set (or "
                             "test.int8_calib_dir) to calibrate")
        calib_id = f"{head}:val:{n}"

        def load(i):
            return ds.load(i)["image"]

    dev = next(model.parameters()).device
    cache_path = os.path.join(cfg.work_dir, cfg.name, "int8_quant.npz")
    fp = _params_fingerprint(model)
    tree = _load_quant_cache(cache_path, calib_id, fp, dev)
    if tree is not None:
        return tree
    no_boxes = np.zeros((0, 4), np.float32)
    imgs = np.stack([letterbox_np(load(i), no_boxes, cfg.model.img_size)[0]
                     for i in range(n)]).astype(np.uint8)
    _log.info("int8 PTQ: calibrating on %d images (%s)", n, calib_id)
    if cfg.model.family != "yolov5":
        quantize = quantize_rcnn
    elif mode == "flow":
        quantize = quantize_yolo_flow
    else:
        quantize = quantize_yolo
    tree = quantize(model, imgs, skip=skip, act_clip=act_clip)
    try:
        os.makedirs(os.path.dirname(cache_path), exist_ok=True)
        np.savez(cache_path, __fingerprint__=fp,
                 __calib_id__=np.asarray(calib_id),
                 **_quant_cache_paths(tree))
        _log.info("int8 PTQ: cached quant tree at %s", cache_path)
    except OSError as e:   # a read-only work_dir: serve from memory only
        _log.warning("int8 PTQ: could not cache quant tree (%s)", e)
    return tree


def run_test(cfg: ExperimentConfig, source: str,
             out_path: Optional[str] = None, *, device=None) -> Dict:
    """``--mode test``: detection on an image, a directory of images or a
    video, on ``device`` (CUDA unless ``device="cpu"``), through the
    Detector of :func:`load_detector` (the config's test knobs, TTA
    included; for YOLOv5 the packed serve step on kernel ``nms_fixpoint``,
    for FasterRCNN ``faster_rcnn_infer`` on ``nms_mask``).

    An image returns its dets (``boxes``, ``scores``, ``classes`` in source
    pixels) and, with ``out_path``, writes the rendered frame there (needs
    OpenCV); with ``test.save_heatmaps`` and ``out_path`` also the panels
    of :func:`_save_heatmap_panels` (``"heatmaps"`` names the first). A
    directory writes each image's rendering (and panels) into ``out_path``
    or ``work_dir/name/test_out``; a video (.mp4, .avi, .mov, .mkv) its
    rendering into ``out_path`` or ``out.mp4``."""
    from heltondetection_tpu_torch.data.readers import IMG_EXTS
    dev = resolve_device(device)
    names = cfg.data.class_names
    nc = _config_num_classes(cfg)
    model = build_model(cfg.model, nc)
    model.load_state_dict(_load_eval_variables(cfg))
    det = _make_detector(cfg, model, nc, device=dev)
    if os.path.isdir(source):
        files = sorted(f for f in os.listdir(source)
                       if os.path.splitext(f)[1].lower() in IMG_EXTS)
        out_dir = out_path or os.path.join(cfg.work_dir, cfg.name, "test_out")
        os.makedirs(out_dir, exist_ok=True)
        for f in files:
            src_f, out_f = os.path.join(source, f), os.path.join(out_dir, f)
            det.infer_image_file(src_f, out_f, names)
            if cfg.test.save_heatmaps:
                _save_heatmap_panels(cfg, model, src_f, out_f, device=dev)
        return {"images": len(files), "out_dir": out_dir}
    if os.path.splitext(source)[1].lower() in (".mp4", ".avi", ".mov",
                                               ".mkv"):
        return {"frames": det.infer_video_file(source, out_path or "out.mp4",
                                               names)}
    result = det.infer_image_file(source, out_path, names)
    if cfg.test.save_heatmaps and out_path:
        result["heatmaps"] = _save_heatmap_panels(cfg, model, source,
                                                  out_path, device=dev)
    return result


def _save_heatmap_panels(cfg: ExperimentConfig, model: Model, source: str,
                         out_path: str, *, device=None) -> str:
    """Write the per-level panels of one image beside ``out_path`` (its
    stem + ``_heatmaps.png``, ``_objmaps.png`` and, for FasterRCNN,
    ``_clsmaps.png``), each level a panel of the letterboxed image's size:
    YOLOv5's raw head maps' mean activation and best-anchor objectness;
    FasterRCNN's pyramid activations, RPN objectness, and the box head's
    best class score over ``generate_proposals``' proposals (its NMS on
    kernel ``nms_mask`` on CUDA). Written by ``utils/vis.py:write_png``,
    no OpenCV needed. Returns the heat-map panel's path."""
    from heltondetection_tpu_torch.data import readers
    from heltondetection_tpu_torch.data.letterbox import letterbox_np
    from heltondetection_tpu_torch.utils.vis import (feature_heatmaps,
                                                     objectness_maps,
                                                     rcnn_class_score_maps,
                                                     rpn_objectness_maps,
                                                     write_png)
    dev = resolve_device(device)
    lb, _, _ = letterbox_np(readers.imread_rgb(source),
                            np.zeros((0, 4), np.float32), cfg.model.img_size)
    net = model.to(dev).eval()
    x = torch.from_numpy(lb).to(dev)[None].float() / 255.0
    stem = os.path.splitext(out_path)[0]

    def host(t):
        return t.float().cpu().numpy()

    with torch.inference_mode():
        if isinstance(net, YOLOv5):
            raws0 = [host(r[0]) for r in net(x)]
            hm = feature_heatmaps(lb, raws0)
            om = objectness_maps(lb, raws0, net.num_classes,
                                 net.num_anchors)
        else:
            from heltondetection_tpu_torch.models.faster_rcnn import (
                STRIDES, generate_proposals, pyramid_anchors)
            pyr, obj, deltas = net(x)
            pyr0 = [host(p[0].permute(1, 2, 0)) for p in pyr]
            level_hw = [p.shape[:2] for p in pyr0]
            hm = feature_heatmaps(lb, pyr0)
            om = rpn_objectness_maps(lb, level_hw, host(obj[0]))
            props, _, pvalid = generate_proposals(
                obj, deltas, net.anchors(dev),
                pyramid_anchors(cfg.model.img_size)[1], cfg.model.img_size,
                net.cfg)
            scores, _ = net.run_box_head(pyr, props)
            probs = torch.softmax(scores[0].float(), -1)[:, 1:]
            write_png(stem + "_clsmaps.png", rcnn_class_score_maps(
                lb, level_hw, STRIDES, host(props[0]), host(probs),
                host(pvalid[0]), num_pooled=net.cfg.roi_levels))
    write_png(stem + "_heatmaps.png", hm)
    write_png(stem + "_objmaps.png", om)
    return stem + "_heatmaps.png"
