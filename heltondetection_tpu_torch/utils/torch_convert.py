"""PyTorch state dicts of the reference's lineage onto the port's models;
counterpart of heltondetection_tpu/utils/torch_convert.py.

Both sides are NCHW torch modules, so every map is by name alone:

* torchvision-v1 ResNet (``train.backbone_pretrain``) onto
  ``models.resnet.ResNet``: ``conv1``/``bn1`` → ``stem_conv``/``stem_bn``,
  ``layer{L}.{i}.{conv,bn}{k}`` → ``layer{L}_{i}.{conv,bn}{k}``,
  ``downsample.0``/``downsample.1`` → ``ds_conv``/``ds_bn``; ``fc.*`` is
  dropped;
* Ultralytics YOLOv5 v6.1 (``model.0`` … ``model.24``) onto
  ``models.yolov5.YOLOv5``: one table (``_YOLO_BB_MAP``, ``_YOLO_NECK_MAP``)
  maps ``model.{idx}`` to the backbone and neck modules, a C3's ``m.{i}``
  to ``m{i}``, ``model.24.m.{i}`` to ``detect{i}``; the same table drives
  the inverse (:func:`export_yolov5_state_dict`), so the two cannot drift.

BatchNorm's running statistics come along with its weights; its
``num_batches_tracked`` counters do not (the reference keeps none, and the
port's BatchNorm reads none): the YOLOv5 map sets them to 0, the exports
write zeros as torch expects. Nothing is downloaded: the files come from
the user.
"""

from __future__ import annotations

import pickle
from typing import Dict, Mapping, Tuple

import torch


def convert_resnet(state_dict: Mapping[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet state dict (any depth) → the state dict of the
    port's ``ResNet`` of the same depth, float32."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in state_dict.items():
        if key.startswith("fc.") or key.endswith("num_batches_tracked"):
            continue
        parts = key.split(".")
        if parts[0] in ("conv1", "bn1"):
            name = ("stem_conv" if parts[0] == "conv1" else "stem_bn") + \
                "." + ".".join(parts[1:])
        elif parts[0].startswith("layer") and len(parts) >= 4:
            block = f"{parts[0]}_{parts[1]}"
            if parts[2] == "downsample":
                mod = "ds_conv" if parts[3] == "0" else "ds_bn"
                rest = parts[4:]
            elif parts[2].startswith(("conv", "bn")):
                mod, rest = parts[2], parts[3:]
            else:
                raise KeyError(f"unrecognized torchvision ResNet key: {key}")
            name = ".".join([block, mod] + rest)
        else:
            raise KeyError(f"unrecognized torchvision ResNet key: {key}")
        out[name] = torch.as_tensor(val).float()
    return out


def load_torchvision_resnet(path: str) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet ``.pth`` state dict file → the port's ResNet
    state dict. The file is read with ``weights_only=True``: tensors and
    plain containers, no arbitrary pickles. A ``{"state_dict": ...}``
    wrapper and DataParallel's ``module.`` prefixes are accepted."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return convert_resnet({k.replace("module.", ""): v
                           for k, v in sd.items()})


@torch.no_grad()
def graft_backbone(model: torch.nn.Module, path: str) -> int:
    """Load a torchvision ResNet ``.pth`` into ``model.backbone`` in place
    (its weights and BatchNorm statistics); returns the count of tensors
    copied. Keys or shapes that differ from the backbone's raise
    ValueError naming them, before anything is changed, so a file of
    another depth fails loudly."""
    have = load_torchvision_resnet(path)
    own = {k: v for k, v in model.backbone.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    diff = {k: (tuple(have[k].shape) if k in have else None,
                tuple(own[k].shape) if k in own else None)
            for k in set(have) | set(own)
            if k not in have or k not in own or have[k].shape != own[k].shape}
    if diff:
        raise ValueError(f"backbone_pretrain {path} does not fit the "
                         f"backbone (the file's shape, the model's): {diff}")
    for k, v in own.items():
        v.copy_(have[k])
    return len(own)


def save_torch_state_dict(path: str, state_dict: Mapping) -> None:
    """Write a state dict (tensor or numpy leaves) as a ``.pth`` that
    ``torch.load(path, weights_only=True)`` reads."""
    torch.save({k: torch.as_tensor(v).contiguous()
                for k, v in state_dict.items()}, path)


def export_resnet_state_dict(state_dict: Mapping[str, torch.Tensor]
                             ) -> Dict[str, torch.Tensor]:
    """The state dict of the port's ``ResNet`` → the torchvision-v1 layout
    (no ``fc.*``), the inverse of :func:`convert_resnet`; BatchNorm gets
    zero ``num_batches_tracked`` counters."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        mod, _, leaf = key.rpartition(".")
        if mod in ("stem_conv", "stem_bn"):
            name = "conv1" if mod == "stem_conv" else "bn1"
        else:
            block, sub = mod.split(".")
            layer, i = block.split("_")
            sub = {"ds_conv": "downsample.0",
                   "ds_bn": "downsample.1"}.get(sub, sub)
            name = f"{layer}.{i}.{sub}"
        out[f"{name}.{leaf}"] = val
        if leaf == "running_mean":
            out[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=
                                                             torch.int64)
    return out


# (the port's module, the Ultralytics model index, kind, base C3 depth):
# one table drives both directions so the layouts cannot drift apart
_YOLO_BB_MAP = [
    ("stem", 0, "conv", None),
    ("down1", 1, "conv", None),
    ("c3_1", 2, "c3", 3),
    ("down2", 3, "conv", None),
    ("c3_2", 4, "c3", 6),
    ("down3", 5, "conv", None),
    ("c3_3", 6, "c3", 9),
    ("down4", 7, "conv", None),
    ("c3_4", 8, "c3", 3),
    ("sppf", 9, "sppf", None),
]
_YOLO_NECK_MAP = [
    ("lat5", 10, "conv", None),
    ("td4", 13, "c3", 3),
    ("lat4", 14, "conv", None),
    ("td3", 17, "c3", 3),
    ("bu3", 18, "conv", None),
    ("bu4", 20, "c3", 3),
    ("bu5", 21, "conv", None),
    ("bu6", 23, "c3", 3),
]
_CONVBN_LEAVES = ("conv.weight", "bn.weight", "bn.bias", "bn.running_mean",
                  "bn.running_var")


def _yolo_convbn_prefixes(depth_multiple: float):
    """Every (Ultralytics prefix, port prefix) of a conv+BN module."""
    def d(n):
        return max(round(n * depth_multiple), 1)

    for sub, table in (("backbone", _YOLO_BB_MAP), ("neck", _YOLO_NECK_MAP)):
        for name, idx, kind, n in table:
            t, p = f"model.{idx}", f"{sub}.{name}"
            if kind == "conv":
                yield t, p
            elif kind == "sppf":
                yield from ((f"{t}.{cv}", f"{p}.{cv}")
                            for cv in ("cv1", "cv2"))
            else:
                for cv in ("cv1", "cv2", "cv3"):
                    yield f"{t}.{cv}", f"{p}.{cv}"
                for i in range(d(n)):
                    for cv in ("cv1", "cv2"):
                        yield f"{t}.m.{i}.{cv}", f"{p}.m{i}.{cv}"


def convert_yolov5(state_dict: Mapping, depth_multiple: float = 0.33
                   ) -> Dict[str, torch.Tensor]:
    """An Ultralytics v6.1 YOLOv5 state dict → the state dict of the port's
    ``YOLOv5`` (standard head), float32; ``depth_multiple`` sets the C3
    repeat counts (0.33 for n/s, 0.67 m, 1.0 l, 1.33 x)."""
    out: Dict[str, torch.Tensor] = {}
    for t, p in _yolo_convbn_prefixes(depth_multiple):
        for leaf in _CONVBN_LEAVES:
            out[f"{p}.{leaf}"] = torch.as_tensor(
                state_dict[f"{t}.{leaf}"]).float()
        out[f"{p}.bn.num_batches_tracked"] = torch.tensor(0)
    for i in range(3):
        for leaf in ("weight", "bias"):
            out[f"detect{i}.{leaf}"] = torch.as_tensor(
                state_dict[f"model.24.m.{i}.{leaf}"]).float()
    return out


def export_yolov5_state_dict(state_dict: Mapping[str, torch.Tensor],
                             depth_multiple: float = 0.33
                             ) -> Dict[str, torch.Tensor]:
    """The port's YOLOv5 state dict (standard head) → the Ultralytics
    v6.1 layout, the inverse of :func:`convert_yolov5` on the same table,
    with zero ``num_batches_tracked`` counters, so a model trained here
    loads into any v6.1-compatible torch stack."""
    out: Dict[str, torch.Tensor] = {}
    for t, p in _yolo_convbn_prefixes(depth_multiple):
        for leaf in _CONVBN_LEAVES:
            out[f"{t}.{leaf}"] = state_dict[f"{p}.{leaf}"]
        out[f"{t}.bn.num_batches_tracked"] = torch.zeros((), dtype=
                                                         torch.int64)
    for i in range(3):
        for leaf in ("weight", "bias"):
            out[f"model.24.m.{i}.{leaf}"] = state_dict[f"detect{i}.{leaf}"]
    return out


def _load_checked(path: str, allow_pickle: bool):
    """``torch.load`` with ``weights_only=True``; a full pickle only when
    ``allow_pickle`` (unpickling runs code from the file)."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        # the one failure weights_only=False can fix: a full-model pickle
        # the safe loader refused; anything else propagates
        if not allow_pickle:
            raise ValueError(
                f"{path} is not a plain tensor state dict and "
                "allow_pickle=False (full-model pickles execute arbitrary "
                "code on load)") from e
        return torch.load(path, map_location="cpu", weights_only=False)


def load_ultralytics_checkpoint(path: str, num_classes: int = 80,
                                variant: str = "s", allow_pickle: bool = True,
                                *, device=None) -> Tuple[torch.nn.Module,
                                                         Dict[str,
                                                              torch.Tensor]]:
    """An Ultralytics YOLOv5 ``.pt`` file → (the port's YOLOv5 of
    ``variant`` holding it, in eval mode on ``device``: CUDA unless
    ``"cpu"``; its state dict). A plain tensor state dict loads through
    the safe ``weights_only`` path; the official releases are full-model
    pickles, which stay allowed by default (loading them is this
    function's job) and ``allow_pickle=False`` refuses."""
    from heltondetection_tpu_torch.device import resolve_device
    from heltondetection_tpu_torch.models.cspdarknet import VARIANTS
    from heltondetection_tpu_torch.models.yolov5 import YOLOv5
    ckpt = _load_checked(path, allow_pickle)
    model_t = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt \
        else ckpt
    sd = model_t.float().state_dict() if hasattr(model_t, "state_dict") \
        else model_t
    d, w = VARIANTS[variant]
    sd = convert_yolov5({k.replace("module.", ""): v for k, v in sd.items()},
                        depth_multiple=d)
    with torch.device("meta"):
        model = YOLOv5(num_classes=num_classes, depth_multiple=d,
                       width_multiple=w)
    model.load_state_dict(sd, assign=True)
    return model.to(resolve_device(device)).eval(), sd
