"""FasterRCNN in the benchmark: the seeded weights (the reference's layout:
torchvision's ResNet keys, the program's keys for the rest), the program's
eval and train entries built as ``run_eval`` and ``run_train`` build them,
the reference's FLOPs, and the map from the program's parameter names to
the reference's."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from benchmark.harness import frames
from benchmark.harness.weights import fill_seeded
from benchmark.reference import common as rc
from benchmark.reference import faster_rcnn as ref

_BACKBONE = "backbone."
# the RPN's loss terms and parameters: its sampling does not depend on the
# network's rounding, the box head's does (through the proposals)
FIRST_STAGE = ("rpn_", "rpn.")


@torch.no_grad()
def _tame(cfg: Dict, model: ref.FasterRCNN, x: torch.Tensor) -> None:
    """Scale the four predictors on the reference's outputs for ``x``: RPN
    logits to std 2, RPN deltas 0.5, class logits 2, box deltas 0.5 (random
    weights otherwise give near-equal scores, every proposal a tie)."""
    pyr = model.features(x)
    logits, deltas = model.rpn(pyr)
    model.rpn.cls.weight.mul_(2.0 / logits.std())
    model.rpn.reg.weight.mul_(0.5 / deltas.std())
    logits, deltas = model.rpn(pyr)
    anc, counts = ref.anchors(cfg, x.device)
    props, _ = ref.proposals(cfg, logits, deltas, anc, counts)
    scores, hd = ref.box_head(model, pyr, props)
    model.box_head.cls.weight.mul_(2.0 / scores.std())
    model.box_head.reg.weight.mul_(0.5 / hd.std())


def make_weights(cfg: Dict, seed: int, device, calib: torch.Tensor,
                 clock=None) -> Dict[str, torch.Tensor]:
    """The reference-layout state dict, float32 on ``device``: random
    weights from the seed, BatchNorm statistics calibrated by the
    reference's forward on ``calib``, uint8 frames of the cell's
    traffic, the predictors tamed on them. ``clock`` (``run.Clock``) marks
    the fill and the reference's calibration and taming apart."""
    with torch.device("meta"):
        model = ref.build(cfg)
    model = model.to_empty(device=device).eval()
    gen = frames.torch_gen(seed, 10, device)
    fill_seeded(model, gen, cfg["bn_bias"])
    if clock is not None:
        clock.mark("weights")
    x = calib.to(device).permute(0, 3, 1, 2).float() / 255.0
    with rc.no_tf32():
        rc.calibrate_bn(model, lambda: model.rpn(model.features(x)))
        _tame(cfg, model, x)
    if clock is not None:
        clock.mark(rc.REFERENCE_PART)
    return {k: v.detach() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def reference_model(cfg: Dict, weights: Dict, device) -> ref.FasterRCNN:
    with torch.device("meta"):
        model = ref.build(cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=False)
    return model


def _port_weights(weights: Dict) -> Dict[str, torch.Tensor]:
    from heltondetection_tpu_torch.utils.torch_convert import convert_resnet
    bb = {k[len(_BACKBONE):]: v.clone() for k, v in weights.items()
          if k.startswith(_BACKBONE)}
    out = {_BACKBONE + k: v for k, v in convert_resnet(bb).items()}
    out.update({k: v.clone() for k, v in weights.items()
                if not k.startswith(_BACKBONE)})
    return out


def port_to_reference_names(cfg: Dict, weights: Dict) -> Dict[str, str]:
    """{program parameter name: reference name}, read by passing the
    converter tensors that carry their reference name's index."""
    names = sorted(weights)
    tags = {k: torch.tensor([float(i)]) for i, k in enumerate(names)}
    return {pk: names[int(v.item())] for pk, v in _port_weights(tags).items()}


def _rcnn_cfg(cfg: Dict):
    from heltondetection_tpu_torch.models.faster_rcnn import RCNNConfig
    r, b = cfg["rpn"], cfg["box"]
    return RCNNConfig(
        num_classes=cfg["num_classes"], img_size=cfg["img_size"],
        neck=cfg["neck"], head=cfg["head"],
        rpn_pre_nms_topk=r["pre_nms_topk"],
        rpn_post_nms_topk=r["post_nms_topk"], rpn_nms_thresh=r["nms_thresh"],
        rpn_fg_iou=r["fg_iou"], rpn_bg_iou=r["bg_iou"],
        rpn_batch=r["batch"], rpn_pos_frac=r["pos_frac"],
        box_fg_iou=b["fg_iou"], box_batch=b["batch"],
        box_pos_frac=b["pos_frac"], score_thresh=cfg["eval"]["conf_thres"],
        nms_thresh=cfg["eval"]["iou_thres"], max_det=cfg["eval"]["max_det"],
        backbone=cfg["backbone"], roi_levels=cfg["roi_levels"],
        backbone_norm_eval=cfg["backbone_norm_eval"],
        backbone_frozen_stages=cfg["backbone_frozen_stages"])


def _port_model(cfg: Dict, weights: Dict, device):
    from heltondetection_tpu_torch.models.faster_rcnn import FasterRCNN
    dtype = torch.bfloat16 if cfg["dtype"] == "bfloat16" else torch.float32
    with torch.device("meta"):
        model = FasterRCNN(_rcnn_cfg(cfg), dtype=dtype)
    model = model.to_empty(device=device).to(
        memory_format=torch.channels_last)
    model.load_state_dict(_port_weights(weights), strict=False)
    return model


class EvalProgram:
    """``run_eval``'s FasterRCNN route: ``forward_for_eval`` (the network
    and ``faster_rcnn_infer``) and the single-label postprocess
    (``nms_mask``) behind an ``Evaluator``; ``trunk`` is the network's
    forward (the pyramid and the RPN maps), ``post`` the rest.
    ``quant_calib`` (uint8 frames) builds the int8 serving program in its
    place: the control."""

    def __init__(self, cfg: Dict, weights: Dict, device,
                 quant_calib: Optional[torch.Tensor] = None):
        import torch.nn.functional as F
        from heltondetection_tpu_torch.engine.evaluator import (
            Evaluator, make_postprocess)
        from heltondetection_tpu_torch.engine.runner import forward_for_eval
        from heltondetection_tpu_torch.models.faster_rcnn import \
            detect_from_features
        ev = cfg["eval"]
        nc = cfg["num_classes"]
        model = _port_model(cfg, weights, device).eval()
        tree = None
        if quant_calib is not None:
            from heltondetection_tpu_torch.ops.quant import quantize_rcnn
            tree = quantize_rcnn(model, quant_calib.numpy(),
                                 skip=("backbone/stem_conv",),
                                 act_clip="p999")
        fwd = forward_for_eval(model, nc, device=device, quant=tree)
        kw = dict(conf_thres=ev["conf_thres"], iou_thres=ev["iou_thres"],
                  max_det=ev["max_det"])
        self.evaluator = Evaluator(fwd, nc, multi_label=ev["multi_label"],
                                   device=device, **kw)
        self.model = model
        post = make_postprocess(nc, multi_label=ev["multi_label"], **kw)

        def rest(feats):
            ob, os_, oc, ov = detect_from_features(model, *feats)
            cls = F.one_hot(oc.clamp(min=0).long(), nc).float()
            return post(ob, os_, cls * ov[..., None])

        self._rest = rest

    @torch.inference_mode()
    def trunk(self, x):
        return self.model(x.float() / 255.0)

    @torch.inference_mode()
    def post(self, feats):
        return self._rest(feats)


def reference_dets(cfg: Dict, model, images: torch.Tensor):
    """The reference's detections of uint8 images (B, S, S, 3) in letterbox
    pixels, and its candidates: each pre-NMS box's decode for each class
    (B, K, C, 4) with the class probabilities (B, K, C); no head logits
    are compared (``None``)."""
    dets, boxes, probs = ref.infer(model, images.float() / 255.0)
    return dets, boxes, probs, None


def infer_flops(cfg: Dict) -> float:
    """FLOPs of one frame through the reference: the network and RPN head
    at the cell's size and the box head over ``post_nms_topk`` proposals,
    counted from shapes (matrix products and convolutions)."""
    from torch.utils.flop_counter import FlopCounterMode
    size, p = cfg["img_size"], cfg["rpn"]["post_nms_topk"]
    with torch.device("meta"):
        model = ref.build(cfg)
        x = torch.zeros((1, 3, size, size))
        crops = torch.zeros((p, cfg["neck_channels"], cfg["roi_size"],
                             cfg["roi_size"]))
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model.rpn(model.features(x))
        model.box_head(crops)
    return float(counter.get_total_flops())


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def steps_per_epoch(cfg: Dict) -> int:
    return cfg["train"]["train_images"] // cfg["train"]["batch"]


def n_anchors(cfg: Dict) -> int:
    return sum((cfg["img_size"] // s) ** 2 * len(cfg["rpn"]["ratios"])
               for s in cfg["rpn"]["strides"])


def make_draws(cfg: Dict, seed: int, n: int, device):
    """``n`` batches of sampling uniforms: ((rpn: three (B, anchors)),
    (box: three (B, proposals + max_boxes)))."""
    gen = frames.torch_gen(seed, 20, device)
    b = cfg["train"]["batch"]
    n_rois = cfg["rpn"]["post_nms_topk"] + cfg["train"]["max_boxes"]
    out = []
    for _ in range(n):
        rpn = torch.rand((3, b, n_anchors(cfg)), generator=gen, device=device)
        box = torch.rand((3, b, n_rois), generator=gen, device=device)
        out.append((tuple(rpn), tuple(box)))
    return out


class TrainProgram:
    """``run_train``'s FasterRCNN step: the model, AdamW with the
    warmup-cosine schedule, the clip and the stem and first stage frozen,
    the EMA; the sampling draws handed in."""

    def __init__(self, cfg: Dict, weights: Dict, device):
        from heltondetection_tpu_torch.models.backbones import \
            frozen_stage_prefixes
        from heltondetection_tpu_torch.train.schedule import make_optimizer
        from heltondetection_tpu_torch.train.trainer import (
            create_train_state, make_rcnn_train_step)
        tc = cfg["train"]
        model = _port_model(cfg, weights, device)
        spe = steps_per_epoch(cfg)
        self.frozen = frozen_stage_prefixes(cfg["backbone"],
                                            cfg["backbone_frozen_stages"])
        opt = make_optimizer(
            model, tc["lr"], total_steps=spe * tc["epochs"],
            warmup_steps=int(tc["warmup_epochs"] * spe),
            weight_decay=tc["weight_decay"],
            final_lr_frac=tc["final_lr_frac"], grad_clip=tc["grad_clip"],
            frozen_prefixes=self.frozen)
        self.state = create_train_state(model, opt, use_ema=tc["ema"])
        self._step = make_rcnn_train_step(use_ema=tc["ema"])
        self.cfg = cfg

    @staticmethod
    def batch(b: Dict) -> Dict:
        return {"image": b["image"], "gt_boxes_xyxy": b["gt_xyxy"],
                "gt_cls": b["gt_cls"], "gt_mask": b["gt_mask"]}

    def step(self, batch: Dict, draws):
        from heltondetection_tpu_torch.models.faster_rcnn import RCNNDraws
        return self._step(self.state, batch, [RCNNDraws(*draws)])[1]

    def assigners(self, b: Dict, draws):
        """The two assigners on the batch's proposals, as callables, and
        the least time a call of both needs (s): the IoU operations of the
        valid (anchor or proposal, real gt) pairs at the float32 peak, or
        the boxes read once and one assignment (index and IoU) written per
        anchor or proposal at the HBM peak, whichever is larger."""
        from benchmark.harness.peaks import F32_FLOP_PER_S, HBM_BYTES_PER_S
        from heltondetection_tpu_torch.models.faster_rcnn import (
            assign_box_targets, assign_rpn_targets, generate_proposals,
            pyramid_anchors)
        model = self.state.model
        rcfg = model.cfg
        anchors = model.anchors(b["image"].device)
        with torch.no_grad():
            _, obj, deltas = model(b["image"].float() / 255.0)
            props, _, pvalid = generate_proposals(
                obj, deltas, anchors, pyramid_anchors(rcfg.img_size)[1],
                rcfg.img_size, rcfg)

        def rpn():
            return assign_rpn_targets(anchors, b["gt_xyxy"], b["gt_mask"],
                                      rcfg, draws[0])

        def box():
            return assign_box_targets(props, pvalid, b["gt_xyxy"],
                                      b["gt_cls"], b["gt_mask"], rcfg,
                                      draws[1])

        n_gt = b["gt_mask"].sum(1).double()
        n_a = anchors.shape[0]
        n_p = props.shape[1] + b["gt_xyxy"].shape[1]
        pairs = float((n_gt * (n_a + n_p)).sum())
        n_img = b["image"].shape[0]
        bytes_ = (16.0 * (n_a + n_img * n_p + n_img * b["gt_xyxy"].shape[1])
                  + 8.0 * n_img * (n_a + n_p))
        least = max(pairs * 13 / F32_FLOP_PER_S, bytes_ / HBM_BYTES_PER_S)
        return rpn, box, least


def reference_loss(cfg: Dict, model, b: Dict, draws):
    return ref.loss(model, b["image"].float() / 255.0, b["gt_xyxy"],
                    b["gt_cls"], b["gt_mask"], draws)


def reference_frozen(name: str, cfg: Dict) -> bool:
    return ref.frozen(name, cfg)


def train_flops(cfg: Dict) -> float:
    """FLOPs of one step of the reference (forward and backward of its
    matrix products and convolutions, under autograd) at the cell's batch:
    the network and the RPN head at the cell's size, the box head over
    ``box.batch`` sampled rois an image; counted from shapes on the meta
    device."""
    from torch.utils.flop_counter import FlopCounterMode
    bsz, size = cfg["train"]["batch"], cfg["img_size"]
    with torch.device("meta"):
        model = ref.build(cfg).train()
        x = torch.zeros((bsz, 3, size, size))
        crops = torch.zeros((bsz * cfg["box"]["batch"], cfg["neck_channels"],
                             cfg["roi_size"], cfg["roi_size"]),
                            requires_grad=True)
    counter = FlopCounterMode(display=False)
    with counter:
        logits, deltas = model.rpn(model.features(x))
        s, d = model.box_head(crops)
        (logits.sum() + deltas.sum() + s.sum() + d.sum()).backward()
    return float(counter.get_total_flops())
