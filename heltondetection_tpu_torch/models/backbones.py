"""Backbone registry; counterpart of heltondetection_tpu/models/backbones.py.

One contract for every backbone: ``build_backbone(name, …)`` returns an
``nn.Module`` whose ``forward(x (B, 3, H, W))`` gives a tuple of pyramid
features, low stride first and ending at stride 32 (C2..C5 for the ResNets
and the C2-tapped CSPDarknets), and whose ``channels`` attribute holds
their widths. Consumers slice what they need: YOLOv5 the last three,
FasterRCNN the last four.

Built-in names: resnet18/34/50/101 and cspdarknet_{n,s,m,l,x}.
:func:`register_backbone` adds a module under a name that configs can
use.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, Optional, Sequence

import torch.nn as nn

from heltondetection_tpu_torch.models.cspdarknet import VARIANTS, CSPDarknet
from heltondetection_tpu_torch.models.resnet import RESNET_STAGES, ResNet

# name -> (factory, frozen-prefix function or None)
_REGISTRY: Dict[str, tuple] = {}


def register_backbone(name: str, factory: Callable[..., nn.Module],
                      frozen_prefixes: Optional[
                          Callable[[int, str], Sequence[str]]] = None,
                      ) -> None:
    """Register ``factory(dropblock_p, norm_eval, frozen_stages, remat)``
    under ``name``; it returns a module with the contract of this module's
    docstring. ``frozen_prefixes(frozen_stages, root)`` returns the
    "/"-joined parameter-path prefixes that ``frozen_stages`` freezes (omit
    it for a backbone that does not freeze). A name registered again is
    replaced."""
    _REGISTRY[name] = (factory, frozen_prefixes)


def backbone_names():
    return sorted(_REGISTRY)


def build_backbone(name: str, dropblock_p: float = 0.0,
                   norm_eval: bool = False, frozen_stages: int = 0,
                   remat: bool = False) -> nn.Module:
    """A new module of the registered backbone ``name``. ``norm_eval`` and
    ``frozen_stages`` follow mmdet's ResNet knobs (BatchNorm on running
    statistics in training; no gradient through the first stages). A
    factory without a ``remat`` parameter (or ``**kwargs``) raises for
    ``remat=True``."""
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown backbone {name!r}; registered: {backbone_names()}")
    factory, _ = _REGISTRY[name]
    kw = dict(dropblock_p=dropblock_p, norm_eval=norm_eval,
              frozen_stages=frozen_stages)
    params = inspect.signature(factory).parameters
    if "remat" in params or any(p.kind is inspect.Parameter.VAR_KEYWORD
                                for p in params.values()):
        return factory(remat=remat, **kw)
    if remat:
        raise ValueError(
            f"backbone {name!r} factory does not accept remat=True")
    return factory(**kw)


def frozen_stage_prefixes(name: str, frozen_stages: int,
                          root: str = "backbone"):
    """The parameter-path prefixes of the stages ``frozen_stages`` freezes
    in backbone ``name`` under ``root``, for the optimizer's freeze set."""
    if frozen_stages <= 0:
        return ()
    entry = _REGISTRY.get(name)
    if entry is None or entry[1] is None:
        return ()
    return tuple(entry[1](frozen_stages, root))


def _resnet_factory(stages, block):
    def make(dropblock_p, norm_eval, frozen_stages, remat=False):
        return ResNet(stages, block, dropblock_p=dropblock_p,
                      norm_eval=norm_eval, frozen_stages=frozen_stages,
                      remat=remat)
    return make


def _resnet_frozen(frozen_stages: int, root: str):
    return ([f"{root}/stem_"] +
            [f"{root}/layer{i}_" for i in range(1, frozen_stages + 1)])


def _csp_factory(variant):
    d, w = VARIANTS[variant]

    def make(dropblock_p, norm_eval, frozen_stages, remat=False):
        return CSPDarknet(d, w, dropblock_p=dropblock_p, remat=remat,
                          include_c2=True, norm_eval=norm_eval,
                          frozen_stages=frozen_stages)
    return make


def _csp_frozen(frozen_stages: int, root: str):
    # one frozen stage: stem..c3_1
    return (f"{root}/stem/", f"{root}/down1/", f"{root}/c3_1/")


for _name, (_stages, _block) in RESNET_STAGES.items():
    register_backbone(_name, _resnet_factory(_stages, _block),
                      _resnet_frozen)
for _variant in VARIANTS:
    register_backbone(f"cspdarknet_{_variant}", _csp_factory(_variant),
                      _csp_frozen)
