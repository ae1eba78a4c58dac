"""torchvision ResNet weights for the port's backbones; counterpart of the
ResNet half of heltondetection_tpu/utils/torch_convert.py
(``train.backbone_pretrain``).

A torchvision-v1 ResNet state dict maps onto ``models.resnet.ResNet`` by
name alone, both being NCHW torch modules: ``conv1``/``bn1`` →
``stem_conv``/``stem_bn``, ``layer{L}.{i}.{conv,bn}{k}`` →
``layer{L}_{i}.{conv,bn}{k}``, ``downsample.0``/``downsample.1`` →
``ds_conv``/``ds_bn``; ``fc.*`` is dropped. BatchNorm's running statistics
come along with its weights; its ``num_batches_tracked`` counters do not
(the reference keeps none, and the port's BatchNorm does not read them).
"""

from __future__ import annotations

from typing import Dict, Mapping

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
