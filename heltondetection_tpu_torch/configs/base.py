"""Config system; counterpart of heltondetection_tpu/configs/base.py: one
dataclass per experiment, loaded by path via the CLI. The dataclasses are
the reference's field for field (the experiment files beside this one are
its files with their imports pointed here), so a config means the same in
both packages. Fields
mirror the reference's experiment-table columns (model / mosaic p / lr /
epochs / bs / img size, README.md:71-154) plus the knobs its ablations used
(focal-loss variants, DropBlock, frozen backbone, decoupled head, RoIPool).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


@dataclass
class DataConfig:
    format: str = "coco"              # coco | yolo | dota | voc | visdrone
    train_ann: str = ""               # coco: json; yolo/dota: label dir
    train_imgs: str = ""
    val_ann: str = ""
    val_imgs: str = ""
    class_names: Optional[Sequence[str]] = None
    max_boxes: int = 128
    cache_images: bool = False   # RAM-cache decoded images (ultralytics
    # --cache ram lineage); budget 8 GiB


@dataclass
class ModelConfig:
    family: str = "yolov5"            # yolov5 | faster_rcnn
    variant: str = "s"                # yolov5: n/s/m/l/x
    backbone: str = ""                # "" = family default (cspdarknet /
    # resnet50); any models/backbones.py name swaps it (README.md:8-9,120)
    num_classes: int = 80
    img_size: int = 640
    dtype: str = "float32"            # float32 | bfloat16 (compute dtype)
    anchors: Optional[Tuple] = None   # yolov5: per-level ((w,h)×3)×3 in
    # input pixels; None = the v6.1 COCO set (ops/anchors.YOLOV5_ANCHORS).
    # Fit dataset-specific ones with tools/autoanchor.py or
    # train.autoanchor=True (data/autoanchor.py)
    # faster_rcnn options (README.md:65,73-76 ablations)
    neck: str = "fpn"                 # fpn | pafpn_v8
    head: str = "coupled"             # coupled | decoupled
    roi_method: str = "align"         # align | pool
    freeze_backbone: bool = False     # README.md:132
    dropblock_p: float = 0.0          # README.md:97,131 ablations
    roi_levels: int = 4               # 1 = "P2" head variants (README.md:65)
    backbone_norm_eval: bool = True   # FrozenBN during training — the
    # torchvision/mmdet pretrained-fine-tune default (faster_rcnn only;
    # set False for from-scratch SyncBN training)
    backbone_frozen_stages: int = 1   # stem+layer1 stop-gradient
    # (torchvision trainable_backbone_layers=3; faster_rcnn only)
    remat: bool = False               # checkpoint the backbone stages:
    # the backward re-runs each stage instead of holding its activations —
    # ~1/3 extra backbone FLOPs for O(boundary) activation memory, for
    # memory-bound high-res/large-batch training; math is identical
    # faster_rcnn proposal/sampling budgets (None = torchvision defaults:
    # 1000/1000 proposals, 256 RPN rows, 512 box rows — the mmdet/
    # torchvision constructor knobs; shrink for small images or tight HBM)
    rpn_pre_nms_topk: Optional[int] = None    # per-level pre-NMS top-k
    rpn_post_nms_topk: Optional[int] = None   # proposals kept per image
    rpn_batch: Optional[int] = None           # sampled RPN anchors/image
    box_batch: Optional[int] = None           # sampled rois/image


@dataclass
class TrainConfig:
    epochs: int = 48
    batch_size: int = 16
    lr: float = 1e-3                  # adamw (README.md tables)
    weight_decay: float = 5e-4
    warmup_epochs: float = 3.0
    final_lr_frac: float = 0.1
    grad_clip: Optional[float] = 10.0
    mosaic_p: float = 0.5
    hsv: bool = True
    flip_p: float = 0.5
    mixup_p: float = 0.0      # blend two fully-augmented samples (pixel mix
    # beta(32,32), label union — YOLOv5-v6.1 lineage mixup); supported on
    # the host pipelines AND device_aug (batch-roll partner on device)
    device_aug: bool = False   # mosaic/flip/HSV as fused on-device XLA ops
    native_loader: bool = True  # C++ batch pipeline (native/loader_core.cpp)
    # when buildable; falls back to the pure-Python path otherwise
    decode_in_pool: bool = False  # decode JPEGs inside the C++ pool
    # (libjpeg; no EXIF rotation — leave off for EXIF-oriented datasets)
    ema: bool = True
    grad_accum: int = 1       # micro-batch gradient accumulation: split
    # each batch into this many micro-batches, scan them accumulating
    # gradients, then apply ONE optimizer/EMA update — peak activation
    # memory drops to one micro-batch's (effective batch sizes past one
    # chip's HBM). batch_size must be divisible by it (and by
    # devices*grad_accum under data parallelism)
    spatial_shards: int = 1   # shard the image H axis over this many mesh
    # columns (parallel/spatial.py): a (devices/sp × sp) data×spatial mesh
    # lets resolutions beyond one chip's HBM train (beyond-reference;
    # SURVEY.md §5 long-context analog). Both families; img_size must be
    # divisible by spatial_shards times the coarsest pyramid stride (32
    # YOLO, 64 FasterRCNN P6) so every pyramid level splits evenly
    focal: str = "none"               # none | root | root_cls (README.md:117)
    label_smoothing: float = 0.0
    autoanchor: bool = False  # yolov5: at train start measure best-possible
    # -recall of model.anchors against the dataset labels and re-fit them
    # (k-means + genetic evolution, data/autoanchor.py) when BPR < 0.98 —
    # the v6.1-lineage anchor check. Deterministic under `seed`
    multi_scale: Tuple[float, ...] = ()  # yolov5 multi-scale training
    # (ultralytics --multi-scale lineage), TPU-idiomatic: each factor maps
    # img_size to a /32-rounded BUCKET size; every step samples one bucket
    # (seeded, resume-stable) and the batch is resized ON DEVICE inside
    # that bucket's compiled program — a few static programs instead of
    # dynamic shapes. Factors must be <= 1.0: the host renders at img_size,
    # so set img_size to the LARGEST scale and list the smaller factors
    # (e.g. img_size=960 with (0.67, 0.83, 1.0) ≈ 640-960 multi-scale)
    seed: int = 0
    num_workers: int = 8
    eval_interval: int = 10           # epochs between val evals
    ckpt_interval: int = 5
    patience: Optional[int] = None    # early stopping (ultralytics
    # lineage): stop when val AP has not improved for this many EPOCHS
    # (checked at eval epochs, so keep eval_interval <= patience). The
    # stop decision broadcasts from rank 0 so multi-host ranks agree
    pretrain_ckpt: Optional[str] = None   # transfer init (README.md:79)
    backbone_pretrain: Optional[str] = None   # torchvision ResNet .pth
    # (ImageNet weights) grafted onto params["backbone"] via
    # utils/torch_convert.convert_resnet — the reference's FasterRCNN rows
    # all start from ImageNet-pretrained ResNet50 (README.md:65,132)


@dataclass
class EvalConfig:
    batch_size: int = 16
    conf_thres: float = 0.001
    iou_thres: float = 0.65
    max_det: int = 300
    multi_label: bool = True
    fused: bool = True   # packed-head fused postprocess (ops/postprocess.py)
    approx: bool = False  # approx_max_k candidate top-k (serving-only knob)
    ckpt: str = "last"   # which checkpoint eval/test/export load:
    # "last" = newest rotating ckpt; "best" = the best-val-AP snapshot
    # (ckpt_best/, written whenever the in-loop eval improves)
    int8: bool = False   # score the W8A8-quantized program (ops/quant.py)
    # so --mode eval reports the mAP cost of PTQ before serving uses it;
    # calibration knobs are shared with TestConfig (int8_calib*). Ignored
    # by the in-training eval loop (which always scores float).


@dataclass
class TestConfig:
    conf_thres: float = 0.25
    iou_thres: float = 0.45
    tta: bool = False                 # README.md:19
    tta_scales: Tuple[float, ...] = (1.0, 0.83)
    save_heatmaps: bool = False       # demo-style per-level panels
    int8: bool = False                # W8A8 PTQ serving (ops/quant.py):
    # backbone/neck convs as int8 GEMMs; calibrated on val (or the dir)
    int8_mode: str = "layer"          # "layer" = per-conv W8A8, activations
    # float (the model's dtype) between convs; "flow" = int8 activation
    # flow (yolov5 only): activations stay int8 between convs, with
    # per-channel scales folded into each consumer's weights
    int8_calib: int = 32              # calibration images (from the val set)
    int8_calib_dir: Optional[str] = None   # calibrate on this directory of
    # images instead of the val split (pure-inference hosts); the quant
    # tree is cached at {work_dir}/{name}/int8_quant.npz either way
    int8_float_tail: str = "balanced"  # which layer groups stay float
    # (yolov5 only; the AP cost of PTQ concentrates in the high-res early
    # backbone and the top-down neck path feeding the small-box level):
    #   "none"     — quantize everything but the stem
    #   "balanced" — also keep down1 and c3_1 (backbone) and lat4 and td3
    #                (neck) float. DEFAULT
    #   "accuracy" — keep the early backbone (down1 … c3_2) and the whole
    #                top-down neck path (lat5, td4, lat4, td3) float
    int8_act_clip: str = "p999"       # activation clip: "p999" (the
    # 99.9th percentile, robust to outliers) or "amax" (the exact range)
    int8_skip: Optional[Tuple[str, ...]] = None   # explicit '/'-joined
    # module-path prefixes to keep float — overrides int8_float_tail


@dataclass
class ExperimentConfig:
    name: str = "experiment"
    work_dir: str = "runs"
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    test: TestConfig = field(default_factory=TestConfig)

    @property
    def ckpt_dir(self) -> str:
        return os.path.join(self.work_dir, self.name, "ckpt")

    @property
    def best_ckpt_dir(self) -> str:
        return os.path.join(self.work_dir, self.name, "ckpt_best")

    @property
    def log_dir(self) -> str:
        return os.path.join(self.work_dir, self.name, "logs")


def load_config(path: str) -> ExperimentConfig:
    """Load ``config`` (an ExperimentConfig) from a python file — the
    reference's one-config-per-experiment pattern."""
    spec = importlib.util.spec_from_file_location("exp_config", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = getattr(mod, "config", None)
    if not isinstance(cfg, ExperimentConfig):
        raise TypeError(f"{path} defines no `config` of this package's "
                        f"ExperimentConfig (got {type(cfg).__name__})")
    return cfg
