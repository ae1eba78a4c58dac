"""YOLOv5 detector: CSPDarknet ⊕ PAFPNv5 ⊕ coupled Detect head, + decode;
counterpart of heltondetection_tpu/models/yolov5.py.

    imgs (B, S, S, 3) → CSPDarknet → (c3, c4, c5) → PAFPNv5 → (p3, p4, p5)
    → Detect: per level 1x1 conv → (B, H, W, A·(5+C))
    → decode: xy = (2σ−0.5+grid)·stride, wh = (2σ)²·anchor, conf = σobj·σcls

The model takes NHWC float images and returns the reference's layouts; the
convs inside run NCHW. The head always runs in float32, whatever the compute
``dtype`` of backbone and neck; parameters are float32 throughout.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from heltondetection_tpu_torch.device import resolve_device
from heltondetection_tpu_torch.models.common import (init_weights, q_dequant,
                                                     scaled)
from heltondetection_tpu_torch.models.cspdarknet import VARIANTS, CSPDarknet
from heltondetection_tpu_torch.models.necks import PAFPNv5
from heltondetection_tpu_torch.ops.anchors import (YOLOV5_ANCHORS,
                                                   YOLOV5_STRIDES, yolo_grid)
from heltondetection_tpu_torch.parallel.spatial import gather_rows
from heltondetection_tpu_torch.utils import trace


def packed_cls_width(num_classes: int) -> int:
    """Per-anchor block width of the packed serve head: C class logits + 5
    box/obj logits, rounded up to 128."""
    return max(128, -(-(num_classes + 5) // 128) * 128)


class YOLOv5(nn.Module):
    """``forward(x (B, H, W, 3) float)`` returns the raw per-level maps
    ``[(B, Hl, Wl, A·(5+C))]``, or with ``packed_head=True`` the serve layout
    per level ``(pobj (B, A·HW) f32, [pcand_a (B, HW, CP) bf16 per anchor],
    (h, w))`` in anchor-major (a, y, x) row order: pobj carries the
    objectness logits, and each pcand row packs ``[cls₀..cls_{C-1}, tx, ty,
    tw, th, obj, pad]`` for one anchor. Packed weights come from a standard
    state dict through :func:`pack_head_variables`.

    ``packed_train=True`` (an attribute that may be flipped; the weights
    are the standard ``detect{i}`` convs either way, so a train checkpoint
    is an eval checkpoint) returns the train layout of
    :func:`packed_train_head` per level, which ``train.yolo_loss.
    yolo_loss_packed`` consumes. ``dropblock_p`` and ``remat`` shape
    training only (:class:`~heltondetection_tpu_torch.models.cspdarknet.
    CSPDarknet`); neither adds a parameter. ``backbone`` other than
    ``"cspdarknet"`` (the v6.1 backbone of the depth and width multiples)
    is a name of the backbone registry (``models.backbones``), whose last
    three features feed the neck.

    Under spatial sharding (``spatial``, set on the model and its trunk by
    the train step or ``parallel.spatial.spatial_forward``) the input is a
    band of H rows: the detect convolutions run on the band and their
    outputs are gathered over the spatial group (the packed train head's
    objectness and feature rows; the packed serve head's features), so the
    outputs are the whole image's."""

    spatial = None

    def __init__(self, num_classes: int = 80, depth_multiple: float = 0.33,
                 width_multiple: float = 0.50, num_anchors: int = 3,
                 dtype: torch.dtype = torch.float32,
                 packed_head: bool = False, packed_train: bool = False,
                 dropblock_p: float = 0.0, remat: bool = False,
                 backbone: str = "cspdarknet"):
        super().__init__()
        self.num_classes = num_classes
        self.depth_multiple = depth_multiple
        self.width_multiple = width_multiple
        self.num_anchors = num_anchors
        self.dtype = dtype
        self.packed_head = packed_head
        self.packed_train = packed_train
        self.backbone_name = backbone
        if backbone == "cspdarknet":
            self.backbone = CSPDarknet(depth_multiple, width_multiple,
                                       dropblock_p=dropblock_p, remat=remat)
        else:
            from heltondetection_tpu_torch.models.backbones import \
                build_backbone
            self.backbone = build_backbone(backbone, dropblock_p=dropblock_p,
                                           remat=remat)
        self.neck = PAFPNv5(depth_multiple, width_multiple,
                            in_channels=self.backbone.channels[-3:])
        chans = [scaled(c, width_multiple) for c in (256, 512, 1024)]
        a = num_anchors
        if packed_head:
            cp = packed_cls_width(num_classes)
            for i, cin in enumerate(chans):
                self.add_module(f"detect{i}_obj", nn.Linear(cin, a))
                for j in range(a):
                    self.add_module(f"detect{i}_cand{j}", nn.Linear(cin, cp))
        else:
            no = a * (5 + num_classes)
            for i, cin in enumerate(chans):
                self.add_module(f"detect{i}", nn.Conv2d(cin, no, 1))

    def forward(self, x: torch.Tensor):
        with trace.span("yolov5.forward", device=True):
            return self._forward(x)

    def _forward(self, x: torch.Tensor):
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        feats = self.neck(self.backbone(x)[-3:])
        # the int8 flow's head-boundary guard: a tree whose last neck convs
        # emit int8 still hands the (float) head float features
        feats = [q_dequant(f, self.dtype) for f in feats]
        a = self.num_anchors
        mesh = self.spatial
        outs = []
        for i, f in enumerate(feats):
            f = f.float()
            if self.packed_train and not self.packed_head:
                conv = getattr(self, f"detect{i}")
                pobj, f2, wblocks, (h, w) = packed_train_head(
                    f, conv.weight, conv.bias, self.num_classes, a)
                if mesh is not None:      # one gather of both (H-major rows)
                    both = gather_rows(torch.cat([pobj, f2], -1), mesh, 1)
                    pobj, f2 = both[..., :a], both[..., a:]
                    h *= mesh.n_spatial
                outs.append((pobj, f2, wblocks, (h, w)))
                continue
            if not self.packed_head:
                y = gather_rows(getattr(self, f"detect{i}")(f), mesh)
                outs.append(y.permute(0, 2, 3, 1))
                continue
            f = gather_rows(f, mesh)
            # 1x1 convs as (B·HW, cin) matmuls, one per anchor, so each
            # candidate row is born CP wide in flat (a-major) row order
            b, cin, h, w = f.shape
            f2 = f.permute(0, 2, 3, 1).reshape(b, h * w, cin)
            pobj = getattr(self, f"detect{i}_obj")(f2)        # (B, HW, A)
            pobj = pobj.transpose(1, 2).reshape(b, a * h * w)
            pcand = [getattr(self, f"detect{i}_cand{j}")(f2)
                     .to(torch.bfloat16) for j in range(a)]
            outs.append((pobj, pcand, (h, w)))
        return outs


def packed_train_head(f: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, num_classes: int,
                      num_anchors: int = 3):
    """The packed train head of one level; counterpart of the reference's
    ``_PackedDetect``. ``f`` (B, cin, h, w) float32 and the standard
    ``detect`` conv's ``weight`` (A·(5+C), cin, 1, 1) and ``bias`` →
    ``(pobj (B, HW, A), f2 (B, HW, cin), [(ka (cin, CP), ba (CP)) per
    anchor], (h, w))``: the dense objectness logits, the feature rows, and
    per anchor its weight block with lanes ``[cls₀..cls_{C-1}, tx, ty, tw,
    th, obj, 0-pad]``. The box and class logits are left to the loss, which
    gathers the rows of its assigned cells and applies the blocks there
    (row selection commutes with a 1×1 conv), so that branch, forward and
    backward, runs over the candidates instead of the whole map."""
    b, cin, h, w = f.shape
    a_n, blk = num_anchors, 5 + num_classes
    cp = packed_cls_width(num_classes)
    f2 = f.permute(0, 2, 3, 1).reshape(b, h * w, cin)
    k = weight[:, :, 0, 0].reshape(a_n, blk, cin)     # slices, no index copy
    bia = bias.reshape(a_n, blk)
    pobj = F.linear(f2, k[:, 4], bia[:, 4])                    # (B, HW, A)
    wblocks = [(F.pad(torch.cat([k[a, 5:], k[a, :5]]).t(), (0, cp - blk)),
                F.pad(torch.cat([bia[a, 5:], bia[a, :5]]), (0, cp - blk)))
               for a in range(a_n)]
    return pobj, f2, wblocks, (h, w)


def pack_head_variables(state_dict: Dict[str, torch.Tensor],
                        num_classes: int, num_anchors: int = 3
                        ) -> Dict[str, torch.Tensor]:
    """Map a standard state dict to the packed-head layout.

    ``detect{i}.weight`` (A·(5+C), cin, 1, 1) with channel a·(5+C)+j →
      ``detect{i}_obj`` Linear (A, cin), row a = the obj logit (j = 4);
      ``detect{i}_cand{a}`` Linear (CP, cin), the anchor's CP-row block
      [cls₀..cls_{C-1}, tx, ty, tw, th, obj, pad]; pad rows get weight 0
      and bias −20 (σ ≈ 2e-9, inert under any threshold).
    A pure reshuffle: the logits are the same numbers.
    """
    out = dict(state_dict)
    cp = packed_cls_width(num_classes)
    blk = 5 + num_classes
    for i in range(3):
        name = f"detect{i}"
        if f"{name}.weight" not in out:
            break
        k = out.pop(f"{name}.weight")[:, :, 0, 0]              # (A·blk, cin)
        b = out.pop(f"{name}.bias")
        obj_rows = [a * blk + 4 for a in range(num_anchors)]
        out[f"{name}_obj.weight"] = k[obj_rows].clone()
        out[f"{name}_obj.bias"] = b[obj_rows].clone()
        for a in range(num_anchors):
            kc = k.new_zeros((cp, k.shape[1]))
            bc = b.new_full((cp,), -20.0)
            kc[:num_classes] = k[a * blk + 5:a * blk + blk]
            bc[:num_classes] = b[a * blk + 5:a * blk + blk]
            kc[num_classes:num_classes + 5] = k[a * blk:a * blk + 5]
            bc[num_classes:num_classes + 5] = b[a * blk:a * blk + 5]
            out[f"{name}_cand{a}.weight"] = kc
            out[f"{name}_cand{a}.bias"] = bc
    return out


def packed_copy(model: YOLOv5) -> YOLOv5:
    """A packed-head YOLOv5 holding ``model``'s weights, mapped by
    :func:`pack_head_variables`, on ``model``'s device, in eval mode."""
    with torch.device("meta"):    # no default init: the weights are assigned
        packed = YOLOv5(model.num_classes, model.depth_multiple,
                        model.width_multiple, model.num_anchors, model.dtype,
                        packed_head=True, backbone=model.backbone_name)
    packed.load_state_dict(pack_head_variables(
        model.state_dict(), model.num_classes, model.num_anchors),
        assign=True)
    return packed.eval()


def decode_predictions(raw: Sequence[torch.Tensor], num_classes: int,
                       anchors=YOLOV5_ANCHORS, strides=YOLOV5_STRIDES,
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw maps → (boxes (B, N, 4) xyxy, scores (B, N), classes (B, N)
    int32): each anchor's best class by obj·cls (first on ties), flat in
    (level, y, x, a) order. :func:`decode_full` keeps every class's score
    instead."""
    boxes, scores, classes = [], [], []
    for lvl, p in enumerate(raw):
        b, h, w, _ = p.shape
        a = len(anchors[lvl])
        p = p.float().reshape(b, h, w, a, 5 + num_classes)
        grid = yolo_grid(h, w, p.device)[None, :, :, None, :]
        anc = torch.tensor(anchors[lvl], dtype=torch.float32,
                           device=p.device)[None, None, None]
        xy = (torch.sigmoid(p[..., 0:2]) * 2.0 - 0.5 + grid) * strides[lvl]
        wh = (torch.sigmoid(p[..., 2:4]) * 2.0) ** 2 * anc
        conf = torch.sigmoid(p[..., 4])[..., None] * torch.sigmoid(p[..., 5:])
        box = torch.cat([xy - wh * 0.5, xy + wh * 0.5], dim=-1)
        boxes.append(box.reshape(b, -1, 4))
        scores.append(conf.amax(-1).reshape(b, -1))
        classes.append(torch.argmax(conf, dim=-1).reshape(b, -1))
    return (torch.cat(boxes, 1), torch.cat(scores, 1),
            torch.cat(classes, 1).to(torch.int32))


def decode_full(raw: Sequence[torch.Tensor], num_classes: int,
                anchors=YOLOV5_ANCHORS, strides=YOLOV5_STRIDES,
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw maps → (boxes (B, N, 4) xyxy, obj (B, N), cls (B, N, C)), all
    per-class scores kept, flat in (level, y, x, a) order."""
    boxes, objs, clss = [], [], []
    for lvl, p in enumerate(raw):
        b, h, w, _ = p.shape
        a = len(anchors[lvl])
        p = p.float().reshape(b, h, w, a, 5 + num_classes)
        grid = yolo_grid(h, w, p.device)[None, :, :, None, :]
        anc = torch.tensor(anchors[lvl], dtype=torch.float32,
                           device=p.device)[None, None, None]
        xy = (torch.sigmoid(p[..., 0:2]) * 2.0 - 0.5 + grid) * strides[lvl]
        wh = (torch.sigmoid(p[..., 2:4]) * 2.0) ** 2 * anc
        box = torch.cat([xy - wh * 0.5, xy + wh * 0.5], dim=-1)
        boxes.append(box.reshape(b, -1, 4))
        objs.append(torch.sigmoid(p[..., 4]).reshape(b, -1))
        clss.append(torch.sigmoid(p[..., 5:]).reshape(b, -1, num_classes))
    return torch.cat(boxes, 1), torch.cat(objs, 1), torch.cat(clss, 1)


def calibrate_bn(model: YOLOv5, generator: torch.Generator, size: int = 256,
                 batch: int = 2) -> None:
    """Set every BatchNorm's running statistics to those of its input on
    ``batch`` uniform-noise images of ``size``² drawn from ``generator``.
    Random weights alone make the activations vanish or blow up with depth;
    with calibrated statistics every block's output is normalized, as in a
    trained network."""
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None                      # cumulative: one batch's stats
    x = torch.rand((batch, size, size, 3), generator=generator)
    was_training = model.training
    model.train()
    with torch.no_grad():
        model(x.to(next(model.parameters()).device))
    model.train(was_training)
    for m, momentum in zip(bns, momenta):
        m.momentum = momentum


def build_yolov5(variant: str = "s", num_classes: int = 80,
                 dtype: torch.dtype = torch.float32,
                 packed_head: bool = False, *, device=None,
                 generator: torch.Generator | None = None) -> YOLOv5:
    """A YOLOv5 variant in eval mode on ``device`` (CUDA unless
    ``device="cpu"``), with random weights from ``generator`` (seed 0 when
    none is given) and BatchNorm statistics calibrated on noise images from
    the same generator (:func:`calibrate_bn`)."""
    dev = resolve_device(device)
    d, w = VARIANTS[variant]
    with torch.device("meta"):    # no default init, no global RNG draws
        model = YOLOv5(num_classes=num_classes, depth_multiple=d,
                       width_multiple=w, dtype=dtype, packed_head=packed_head)
    model = model.to_empty(device="cpu")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(model, generator)
    calibrate_bn(model, generator)
    return model.to(dev).eval()
