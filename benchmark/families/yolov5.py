"""YOLOv5 in the benchmark: the seeded weights (the reference's layout),
the program's eval and train entries built as ``run_eval`` and
``run_train`` build them, the reference's FLOPs, and the map from the
program's parameter names to the reference's."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from benchmark.harness import frames
from benchmark.harness.weights import fill_seeded
from benchmark.reference import common as rc
from benchmark.reference import yolov5 as ref


def make_weights(cfg: Dict, seed: int, device, calib: torch.Tensor,
                 clock=None) -> Dict[str, torch.Tensor]:
    """The reference-layout (Ultralytics v6.1) state dict, float32 on
    ``device``: random weights from the seed, BatchNorm statistics
    calibrated by the reference's forward on ``calib``, uint8 frames of
    the cell's traffic. ``clock`` (``run.Clock``) marks the fill and the
    reference's calibration apart."""
    with torch.device("meta"):
        model = ref.build(cfg)
    model = model.to_empty(device=device)
    gen = frames.torch_gen(seed, 10, device)
    fill_seeded(model, gen, cfg["bn_bias"])
    if clock is not None:
        clock.mark("weights")
    x = calib.to(device).permute(0, 3, 1, 2).float() / 255.0
    with rc.no_tf32():
        rc.calibrate_bn(model, lambda: model(x))
    if clock is not None:
        clock.mark(rc.REFERENCE_PART)
    return {k: v.detach() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def reference_model(cfg: Dict, weights: Dict, device) -> ref.TorchYOLOv5:
    with torch.device("meta"):
        model = ref.build(cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=False)
    return model


def _port_weights(cfg: Dict, weights: Dict) -> Dict[str, torch.Tensor]:
    from heltondetection_tpu_torch.utils.torch_convert import convert_yolov5
    return convert_yolov5({k: v.clone() for k, v in weights.items()},
                          cfg["depth_multiple"])


def port_to_reference_names(cfg: Dict, weights: Dict) -> Dict[str, str]:
    """{program parameter name: reference name}, read by passing the
    converter tensors that carry their reference name's index."""
    names = sorted(weights)
    tags = {k: torch.tensor([float(i)]) for i, k in enumerate(names)}
    return {pk: names[int(v.item())]
            for pk, v in _port_weights(cfg, tags).items()
            if not pk.endswith("num_batches_tracked")}


def _dtype(cfg: Dict) -> torch.dtype:
    return torch.bfloat16 if cfg["dtype"] == "bfloat16" else torch.float32


def _port_model(cfg: Dict, weights: Dict, device, packed_head: bool):
    from heltondetection_tpu_torch.models.yolov5 import (YOLOv5,
                                                         pack_head_variables)
    with torch.device("meta"):
        model = YOLOv5(cfg["num_classes"], cfg["depth_multiple"],
                       cfg["width_multiple"], dtype=_dtype(cfg),
                       packed_head=packed_head)
    model = model.to_empty(device=device).to(
        memory_format=torch.channels_last)
    sd = _port_weights(cfg, weights)
    if packed_head:
        sd = pack_head_variables(sd, cfg["num_classes"])
    model.load_state_dict(sd)
    return model


class EvalProgram:
    """``run_eval``'s fused route: the packed-head network and the fused
    postprocess (``nms_fixpoint``) behind an ``Evaluator``; ``trunk`` and
    ``post`` are the two halves for the per-layer timings. ``quant_calib``
    (uint8 frames) builds the int8 serving program in its place, every
    conv but the stem int8 (the ``"none"`` float tail): the control."""

    def __init__(self, cfg: Dict, weights: Dict, device,
                 quant_calib: Optional[torch.Tensor] = None):
        from heltondetection_tpu_torch.engine.evaluator import Evaluator
        from heltondetection_tpu_torch.ops.postprocess import \
            make_fused_postprocess
        ev = cfg["eval"]
        nc = cfg["num_classes"]
        net = _port_model(cfg, weights, device, packed_head=True).eval()
        if quant_calib is not None:
            from heltondetection_tpu_torch.ops.quant import (
                YOLO_INT8_SKIP_PRESETS, attach_quant, quantize_yolo)
            std = _port_model(cfg, weights, device, packed_head=False).eval()
            tree = quantize_yolo(std, quant_calib.numpy(),
                                 skip=YOLO_INT8_SKIP_PRESETS["none"],
                                 act_clip="p999")
            net = attach_quant(net, tree)
        post = make_fused_postprocess(
            nc, pre_nms_topk=ev["pre_nms_topk"],
            max_cls_per_box=ev["max_cls_per_box"] if ev["multi_label"] else 1,
            conf_thres=ev["conf_thres"], iou_thres=ev["iou_thres"],
            max_det=ev["max_det"])
        self.net, self.post_fn = net, post
        self.evaluator = Evaluator(
            None, nc, step_fn=lambda images: post(net(images.float() / 255.0)),
            device=device)

    @torch.inference_mode()
    def trunk(self, x):
        return self.net(x.float() / 255.0)

    @torch.inference_mode()
    def post(self, raw):
        return self.post_fn(raw)


def program_maps(cfg: Dict, prog: EvalProgram, images: torch.Tensor):
    """The timed network's head logits for uint8 images (B, S, S, 3) on
    its device, per level (B, A, HW, 5 + C) float32 in the reference's
    order [tx, ty, tw, th, obj, cls…]: what the fused postprocess reads,
    the objectness from the head's float32 rows and the rest from its
    bfloat16 candidate rows."""
    nc = cfg["num_classes"]
    maps = []
    for pobj, pcand, _ in prog.trunk(images):
        p = torch.stack(pcand, 1).float()
        obj = pobj.view(p.shape[0], p.shape[1], -1, 1)
        maps.append(torch.cat([p[..., nc:nc + 4], obj, p[..., :nc]], -1))
    return maps


def reference_post(cfg: Dict, maps):
    """The reference's decode, selection and NMS of head logits per level
    (B, A, HW, 5 + C): its detections in letterbox pixels."""
    size, nc = cfg["img_size"], cfg["num_classes"]
    raw = [m.transpose(2, 3).reshape(m.shape[0], -1, size // st, size // st)
           for m, st in zip(maps, cfg["strides"])]
    boxes, obj, cls = ref.decode(raw, nc, cfg["anchors"], cfg["strides"])
    return ref.select_and_nms(boxes, obj, cls, cfg["eval"])


def alter_head(prog: EvalProgram) -> None:
    """The fault "an answer altered where it is produced": the network's
    head rows of the first image of every batch reversed in each anchor's
    order, so that each of its answers comes from another place."""
    net = prog.net
    forward = net.forward

    def altered(x):
        out = []
        for pobj, pcand, hw in forward(x):
            pobj = pobj.clone()
            rows = pobj.view(pobj.shape[0], len(pcand), -1)
            rows[0] = rows[0].flip(-1)
            pcand = [c.clone() for c in pcand]
            for c in pcand:
                c[0] = c[0].flip(0)
            out.append((pobj, pcand, hw))
        return out

    net.forward = altered


def reference_dets(cfg: Dict, model, images: torch.Tensor):
    """The reference's detections of uint8 images (B, S, S, 3) in letterbox
    pixels, its candidates: every anchor's box for every class
    (B, N, 1, 4) with the scores obj·cls (B, N, C), and its head logits
    per level (B, A, HW, 5 + C)."""
    x = images.permute(0, 3, 1, 2).float() / 255.0
    raw = model(x)
    nc = cfg["num_classes"]
    boxes, obj, cls = ref.decode(raw, nc, cfg["anchors"], cfg["strides"])
    dets = ref.select_and_nms(boxes, obj, cls, cfg["eval"])
    maps = [r.view(r.shape[0], len(a), 5 + nc, -1).transpose(2, 3)
            for r, a in zip(raw, cfg["anchors"])]
    return dets, boxes[:, :, None, :], obj[..., None] * cls, maps


def infer_flops(cfg: Dict) -> float:
    """FLOPs of one frame through the reference network at the cell's
    size, counted from shapes (matrix products and convolutions)."""
    from torch.utils.flop_counter import FlopCounterMode
    with torch.device("meta"):
        model = ref.build(cfg)
        x = torch.zeros((1, 3, cfg["img_size"], cfg["img_size"]))
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(x)
    return float(counter.get_total_flops())


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def steps_per_epoch(cfg: Dict) -> int:
    return cfg["train"]["train_images"] // cfg["train"]["batch"]


class TrainProgram:
    """``run_train``'s YOLOv5 step: the model (packed train head), AdamW
    with the warmup-cosine schedule and the clip, the EMA."""

    frozen = ()

    def __init__(self, cfg: Dict, weights: Dict, device):
        from heltondetection_tpu_torch.train.schedule import make_optimizer
        from heltondetection_tpu_torch.train.trainer import (
            create_train_state, make_train_step)
        from heltondetection_tpu_torch.train.yolo_loss import YoloLossConfig
        tc = cfg["train"]
        model = _port_model(cfg, weights, device, packed_head=False)
        model.packed_train = True
        spe = steps_per_epoch(cfg)
        opt = make_optimizer(
            model, tc["lr"], total_steps=spe * tc["epochs"],
            warmup_steps=int(tc["warmup_epochs"] * spe),
            weight_decay=tc["weight_decay"],
            final_lr_frac=tc["final_lr_frac"], grad_clip=tc["grad_clip"])
        self.state = create_train_state(model, opt, use_ema=tc["ema"])
        self._step = make_train_step(YoloLossConfig(
            num_classes=cfg["num_classes"], img_size=cfg["img_size"]),
            use_ema=tc["ema"])

    @staticmethod
    def batch(b: Dict) -> Dict:
        return {"image": b["image"], "gt_boxes": frames.xyxy_to_cxcywh(
            b["gt_xyxy"]), "gt_cls": b["gt_cls"], "gt_mask": b["gt_mask"]}

    def step(self, batch: Dict, draws=None):
        return self._step(self.state, batch)[1]


def reference_loss(cfg: Dict, model, b: Dict, draws=None):
    x = b["image"].permute(0, 3, 1, 2).float() / 255.0
    return ref.loss(model(x), frames.xyxy_to_cxcywh(b["gt_xyxy"]),
                    b["gt_cls"], b["gt_mask"], cfg)


def reference_frozen(name: str, cfg: Dict) -> bool:
    return False


def train_flops(cfg: Dict) -> float:
    """FLOPs of one step of the reference (forward and backward of its
    matrix products and convolutions, under autograd) at the cell's batch,
    counted from shapes on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode
    bsz, size = cfg["train"]["batch"], cfg["img_size"]
    with torch.device("meta"):
        model = ref.build(cfg)
        x = torch.zeros((bsz, 3, size, size))
    counter = FlopCounterMode(display=False)
    with counter:
        raw = model(x)
        sum(r.float().sum() for r in raw).backward()
    return float(counter.get_total_flops())
