"""W8A8 post-training quantization for the serving path; counterpart of
heltondetection_tpu/ops/quant.py.

A trained float model becomes a "quant" tree, nested dicts keyed by the
reference's '/'-joined module paths (so the skip presets and cache files
mean the same thing in both packages), whose leaves are tensors in the
port's layouts:

* BatchNorm is folded into the conv (serving runs on running statistics:
  ``w' = w·g``, ``b' = β − μ·g`` with ``g = γ/√(var + eps)``);
* weights are quantized per output channel, symmetric int8
  (``s_w[c] = amax_c/127``), OIHW;
* activations get static scales calibrated by running a few batches
  through the float model (``models.common.calibration_mode``), clipped
  by default at the 99.9th percentile so one outlier does not set the
  scale of a whole tensor;
* the detect, RPN and box heads and the 3-channel stems stay float.

Two conv+BN layouts are recognized, as in the reference: ``ConvBnAct``
modules (YOLO family, PAFPN necks), whose entries sit at the module's path
(``{"backbone": {"down1": {"w_q", "out_scale", "bias", "inv_in_scale"}}}``),
and the ResNet sibling pairs ``convN``/``bnN``, whose entries sit at the
conv's path (``{"layer1_0": {"conv1": {...}}}``, where the reference keeps
flat ``conv1_w_q`` keys beside the submodules; ``utils/convert.py:
from_jax_quant_tree`` maps one onto the other). The int8 activation-flow
tree (:func:`build_flow_tree`, YOLOv5) stores the BN-folded float weight
``w_f`` and the activation scales instead, and ``res_scale`` at residual
bottlenecks.

Usage::

    qtree = quantize_yolo(model, calib_images)        # (N, S, S, 3) uint8
    step = make_packed_serve_step(model, nc, quant=qtree)
    qmodel = attach_quant(model, qtree)               # a quantized copy

Only convs present in the tree run int8; the rest stay float, so a
partial tree (``skip=``) costs nothing. The float model is never changed:
:func:`attach_quant` returns a copy.
"""

from __future__ import annotations

import copy
import logging
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from heltondetection_tpu_torch.models.common import (ConvBnAct, FlowQuant,
                                                     LayerQuant,
                                                     calibration_mode)
from heltondetection_tpu_torch.utils.log import LOGGER

BN_EPS_CONVBN = 1e-3   # models/common.ConvBnAct BatchNorm epsilon
BN_EPS_PAIR = 1e-5     # models/resnet.py (torchvision) BatchNorm epsilon

_log = logging.getLogger(LOGGER)


def _is_pair(parent: nn.Module, k: str) -> bool:
    """ResNet-style sibling layout: a conv at ``k``, its BN partner at
    ``k.replace("conv", "bn")`` in the same module."""
    partner = k.replace("conv", "bn")
    return ("conv" in k and k != "conv" and partner != k
            and isinstance(parent._modules.get(k), nn.Conv2d)
            and isinstance(parent._modules.get(partner), nn.BatchNorm2d))


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def calibrate_amax(model: nn.Module, batches: Iterable, *,
                   normalize: bool = True) -> Dict[str, Any]:
    """Run calibration batches through the float ``model`` (eval mode, on
    its device); return the tree of activation statistics (host numpy
    (2, C) ``[amax, p999]``, nested by module path: ``in_amax`` and
    ``out_amax`` at each ``ConvBnAct``, ``res_amax`` at each residual
    bottleneck, ``convN_in_amax`` beside each ResNet pair).

    ``batches`` yields (B, S, S, 3) images in the serving input
    convention: raw 0–255 when ``normalize`` (divided by 255 here), else
    already scaled. The statistics are the elementwise max over batches."""
    dev = _device(model)
    names = {m: n for n, m in model.named_modules()}
    was_training = model.training
    model.eval()
    amax: Optional[Dict[str, Any]] = None
    try:
        for b in batches:
            x = torch.as_tensor(np.asarray(b), device=dev)
            x = x.float() / 255.0 if normalize else x.float()
            with calibration_mode() as rec, torch.no_grad():
                model(x)
            stats: Dict[str, Any] = {}
            for mod, entries in rec.items():
                node = stats
                for part in filter(None, names[mod].split(".")):
                    node = node.setdefault(part, {})
                for key, val in entries.items():
                    node[key] = val.cpu().numpy()
            amax = stats if amax is None else _tree_max(amax, stats)
    finally:
        model.train(was_training)
    if amax is None:
        raise ValueError("calibration needs at least one batch")
    return amax


def _tree_max(a: Dict, b: Dict) -> Dict:
    return {k: (_tree_max(a[k], v) if isinstance(v, dict)
                else np.maximum(a[k], v)) for k, v in b.items()}


def _act_scale(stats, act_clip: str) -> Tuple[float, float, float]:
    """(clip value, amax, p999) PER TENSOR from a recorded (2, C) stats
    entry ``[amax_c, p999_c]``, reduced with a channel max."""
    s = np.asarray(stats, np.float32).reshape(2, -1)
    amax, p999 = float(s[0].max()), float(s[1].max())
    return (p999 if act_clip == "p999" else amax), amax, p999


def _act_scale_vec(stats, act_clip: str) -> np.ndarray:
    """Activation scale vector (C,) = clip value / 127 for the int8 flow:
    the per-tensor value broadcast over channels (genuinely per-channel
    scales inflate the folded weights' per-out-channel range until
    small-scale channels quantize to zero). Dead channels fall back to
    amax, then 1."""
    s = np.asarray(stats, np.float32).reshape(2, -1)
    v = s[1] if act_clip == "p999" else s[0]
    v = np.where(v > 0, v, s[0])
    v = np.where(v > 0, v, 1.0)
    return (np.full_like(v, v.max()) / 127.0).astype(np.float32)


def _bn_fold(conv: nn.Conv2d, bn: nn.BatchNorm2d, eps: float
             ) -> Tuple[np.ndarray, np.ndarray]:
    """(w·g OIHW, β − μ·g) in float32 numpy."""
    kernel = conv.weight.detach().cpu().numpy().astype(np.float32)
    g = bn.weight.detach().cpu().numpy().astype(np.float32) / np.sqrt(
        bn.running_var.cpu().numpy().astype(np.float32) + eps)
    bias = (bn.bias.detach().cpu().numpy().astype(np.float32)
            - bn.running_mean.cpu().numpy().astype(np.float32) * g)
    return kernel * g[:, None, None, None], bias


def _quant_one(conv: nn.Conv2d, bn: nn.BatchNorm2d, eps: float,
               in_val: float) -> Optional[Dict[str, torch.Tensor]]:
    w, bias = _bn_fold(conv, bn, eps)
    s_in = in_val / 127.0
    if s_in <= 0.0:                         # conv never saw data — skip
        return None
    s_w = np.max(np.abs(w), axis=(1, 2, 3)) / 127.0    # per out channel
    s_w = np.where(s_w > 0, s_w, 1.0)
    w_q = np.clip(np.round(w / s_w[:, None, None, None]), -127, 127
                  ).astype(np.int8)
    return {
        "w_q": torch.from_numpy(w_q),
        "out_scale": torch.from_numpy((s_in * s_w).astype(np.float32)),
        "bias": torch.from_numpy(bias.astype(np.float32)),
        "inv_in_scale": torch.tensor(np.float32(1.0 / s_in)),
    }


def _skipped(dotted: str, skip: Sequence[str]) -> bool:
    return any(dotted == s or dotted.startswith(s + "/") for s in skip)


def build_quant_tree(model: nn.Module, amax_tree: Dict[str, Any], *,
                     skip: Sequence[str] = (),
                     act_clip: str = "p999") -> Dict[str, Any]:
    """Fold and quantize every calibrated conv+BN of ``model`` into a
    per-layer W8A8 tree. ``skip`` holds '/'-joined module-path prefixes to
    leave float (e.g. "backbone/stem"); ``act_clip`` is "p999" (default)
    or "amax". Logs the quantized, skipped and uncalibrated counts and the
    outlier layers (amax > 2·p999), and warns on an empty tree."""
    counts = {"quantized": 0, "skip_list": 0, "uncalibrated": 0}
    outliers = []

    def _emit(dotted: str, q, amax: float, p999: float):
        counts["quantized"] += 1
        _log.debug("int8 %s: s_in=%.5g (amax=%.4g p999=%.4g)", dotted,
                   1.0 / float(q["inv_in_scale"]), amax, p999)
        if amax / max(p999, 1e-12) > 2.0:
            outliers.append((dotted, amax / max(p999, 1e-12)))

    def _unit(dotted, stats, conv, bn, eps):
        """The entry of one conv+BN, or None (counted)."""
        if _skipped(dotted, skip):
            counts["skip_list"] += 1
            return None
        if stats is None:
            counts["uncalibrated"] += 1     # never ran (an unused branch)
            return None
        in_val, amax, p999 = _act_scale(stats, act_clip)
        q = _quant_one(conv, bn, eps, in_val)
        if q is None:
            counts["uncalibrated"] += 1
        else:
            _emit(dotted, q, amax, p999)
        return q

    def _walk(mod: nn.Module, a, path: Tuple[str, ...]):
        a = a if isinstance(a, dict) else {}
        out = {}
        for k, sub in mod.named_children():
            cur = path + (k,)
            dotted = "/".join(cur)
            if isinstance(sub, ConvBnAct):
                q = _unit(dotted, a.get(k, {}).get("in_amax"), sub.conv,
                          sub.bn, BN_EPS_CONVBN)
            elif _is_pair(mod, k):
                q = _unit(dotted, a.get(k + "_in_amax"), sub,
                          mod._modules[k.replace("conv", "bn")], BN_EPS_PAIR)
            else:
                q = _walk(sub, a.get(k, {}), cur) or None
            if q is not None:
                out[k] = q
        return out

    tree = _walk(model, amax_tree, ())
    _log.info("int8 PTQ: quantized %d convs (%d on skip list, %d "
              "uncalibrated, act_clip=%s)", counts["quantized"],
              counts["skip_list"], counts["uncalibrated"], act_clip)
    if counts["quantized"] == 0:
        _log.warning("int8 PTQ produced an EMPTY quant tree — the model "
                     "will silently serve float (path mismatch between "
                     "calibration stats and the model?)")
    elif counts["uncalibrated"] > counts["quantized"]:
        _log.warning("int8 PTQ: more convs uncalibrated (%d) than quantized "
                     "(%d) — check that calibration ran through the same "
                     "forward path", counts["uncalibrated"],
                     counts["quantized"])
    for dotted, ratio in outliers:
        _log.info("int8 PTQ outlier layer %s: amax/p999=%.1f (p999 clip is "
                  "protecting its resolution)", dotted, ratio)
    return tree


def _batched(calib_images, batch_size: int):
    if isinstance(calib_images, np.ndarray) or hasattr(calib_images, "shape"):
        arr = calib_images
        return [arr[i:i + batch_size]
                for i in range(0, arr.shape[0], batch_size)]
    return calib_images


def quantize_yolo(model: nn.Module, calib_images, *, normalize: bool = True,
                  batch_size: int = 8,
                  skip: Sequence[str] = ("backbone/stem",),
                  act_clip: str = "p999") -> Dict[str, Any]:
    """One-call PTQ of a YOLOv5-family model: calibrate on
    ``calib_images`` ((N, S, S, 3) uint8, or an iterable of batches), then
    fold and quantize every backbone and neck ``ConvBnAct``."""
    amax = calibrate_amax(model, _batched(calib_images, batch_size),
                          normalize=normalize)
    return build_quant_tree(model, amax, skip=skip, act_clip=act_clip)


# Head-boundary convs of the YOLOv5 PAFPN: their outputs feed the (float)
# detect head, so the flow mode emits them float instead of paying a
# requant and dequant at the boundary.
YOLO_FLOW_FLOAT_OUT = ("neck/td3/cv3", "neck/bu4/cv3", "neck/bu6/cv3")

# Float-tail presets: the PTQ AP cost concentrates in the high-resolution
# early backbone stages and the top-down neck path that feeds P3 (the
# small-box level), so each preset keeps more of them float.
YOLO_INT8_SKIP_PRESETS = {
    "none": ("backbone/stem",),
    "balanced": ("backbone/stem", "backbone/down1", "backbone/c3_1",
                 "neck/lat4", "neck/td3"),
    "accuracy": ("backbone/stem", "backbone/down1", "backbone/c3_1",
                 "backbone/down2", "backbone/c3_2", "neck/lat5", "neck/td4",
                 "neck/lat4", "neck/td3"),
}


def build_flow_tree(model: nn.Module, amax_tree: Dict[str, Any], *,
                    skip: Sequence[str] = (),
                    float_out: Sequence[str] = (),
                    act_clip: str = "p999") -> Dict[str, Any]:
    """The int8 activation-flow tree (``ConvBnAct`` modules only, the YOLO
    family's block): per conv the BN-folded float weight ``w_f`` (OIHW),
    ``bias``, the per-channel ``in_scale`` (used where a float tensor
    enters the flow) and ``out_scale`` (left out for the ``float_out``
    paths, which emit float for the head); ``res_scale`` at each residual
    bottleneck. The consumer folds its input's scales into ``w_f`` once
    (``models.common.FlowQuant``)."""
    n_q, n_float_out = 0, 0

    def _walk(mod: nn.Module, a, path: Tuple[str, ...]):
        nonlocal n_q, n_float_out
        a = a if isinstance(a, dict) else {}
        out = {}
        if "res_amax" in a:
            out["res_scale"] = torch.from_numpy(
                _act_scale_vec(a["res_amax"], act_clip))
        for k, sub in mod.named_children():
            cur = path + (k,)
            dotted = "/".join(cur)
            if isinstance(sub, ConvBnAct):
                stats = a.get(k, {})
                if _skipped(dotted, skip) or "in_amax" not in stats:
                    continue
                w_f, bias = _bn_fold(sub.conv, sub.bn, BN_EPS_CONVBN)
                entry = {"w_f": torch.from_numpy(w_f),
                         "bias": torch.from_numpy(bias),
                         "in_scale": torch.from_numpy(
                             _act_scale_vec(stats["in_amax"], act_clip))}
                if dotted not in float_out and "out_amax" in stats:
                    entry["out_scale"] = torch.from_numpy(
                        _act_scale_vec(stats["out_amax"], act_clip))
                else:
                    n_float_out += 1
                out[k] = entry
                n_q += 1
            elif not isinstance(sub, nn.Conv2d):
                w = _walk(sub, a.get(k, {}), cur)
                if w:
                    out[k] = w
        return out

    tree = _walk(model, amax_tree, ())
    _log.info("int8 flow PTQ: %d convs in the int8 stream (%d emit float at "
              "the head boundary, act_clip=%s)", n_q, n_float_out, act_clip)
    if n_q == 0:
        _log.warning("int8 flow PTQ produced an EMPTY tree — the model will "
                     "silently serve float")
    return tree


def quantize_yolo_flow(model: nn.Module, calib_images, *,
                       normalize: bool = True, batch_size: int = 8,
                       skip: Sequence[str] = ("backbone/stem",),
                       float_out: Sequence[str] = YOLO_FLOW_FLOAT_OUT,
                       act_clip: str = "p999") -> Dict[str, Any]:
    """One-call int8 activation-flow PTQ of a YOLOv5-family model: the
    calibration of :func:`quantize_yolo`, then :func:`build_flow_tree`."""
    amax = calibrate_amax(model, _batched(calib_images, batch_size),
                          normalize=normalize)
    return build_flow_tree(model, amax, skip=skip, float_out=float_out,
                           act_clip=act_clip)


def quantize_rcnn(model: nn.Module, calib_images, *, normalize: bool = True,
                  batch_size: int = 4,
                  skip: Sequence[str] = ("backbone/stem_conv",),
                  act_clip: str = "p999") -> Dict[str, Any]:
    """One-call PTQ of a FasterRCNN: calibrate through its default forward
    (backbone → neck → RPN maps), then fold and quantize the backbone's
    conv+BN pairs and the neck's ``ConvBnAct``s. The RPN conv and the box
    head stay float (no BN to fold; precision-sensitive logits)."""
    amax = calibrate_amax(model, _batched(calib_images, batch_size),
                          normalize=normalize)
    return build_quant_tree(model, amax, skip=skip, act_clip=act_clip)


def _is_entry(node: Dict) -> bool:
    return isinstance(node.get("w_q", node.get("w_f")), torch.Tensor)


def _is_flow_tree(qtree: Dict[str, Any]) -> bool:
    return any(isinstance(v, dict) and ("w_f" in v or _is_flow_tree(v))
               for v in qtree.values())


def attach_quant(model: nn.Module, qtree: Dict[str, Any]) -> nn.Module:
    """A copy of ``model`` that runs ``qtree``: each entry becomes a
    ``quant`` submodule (``models.common.LayerQuant`` or ``FlowQuant``) of
    the ``ConvBnAct`` or pair conv at its path, each ``res_scale`` a buffer
    of its bottleneck, all on the model's device; ``model`` itself is left
    as it was. A path the model lacks raises ``KeyError``.

    A flow tree's consumers fold their incoming scales on their first
    call; for a YOLOv5 that call is made here, on a 64² zero image, so the
    copy runs, and exports, folded."""
    qm = copy.deepcopy(model)
    dev = _device(qm)
    dtype = getattr(qm, "dtype", torch.float32)

    def put(mod: nn.Module, node: Dict, path: str):
        for k, v in node.items():
            if k == "res_scale":
                mod.register_buffer("res_scale", v.to(dev))
                continue
            sub = mod._modules.get(k)
            if sub is None:
                raise KeyError(f"quant tree path {path}{k} is not a module "
                               f"of the model")
            if not _is_entry(v):
                put(sub, v, f"{path}{k}/")
                continue
            conv = sub.conv if isinstance(sub, ConvBnAct) else sub
            geom = dict(stride=conv.stride[0], pad=conv.padding[0],
                        groups=conv.groups, dtype=dtype)
            t = {n: x.to(dev) for n, x in v.items()}
            if "w_f" in t:
                sub.quant = FlowQuant(t["w_f"], t["bias"], t["in_scale"],
                                      t.get("out_scale"), act=sub.act, **geom)
            else:
                sub.quant = LayerQuant(t["w_q"], t["out_scale"], t["bias"],
                                       t["inv_in_scale"], **geom)

    put(qm, qtree, "")
    if _is_flow_tree(qtree) and hasattr(qm, "num_anchors"):
        with torch.no_grad():
            qm(torch.zeros((1, 64, 64, 3), device=dev))
    return qm
