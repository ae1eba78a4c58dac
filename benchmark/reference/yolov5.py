"""Plain float32 YOLOv5 v6.1: the network, its decode, the eval's candidate
selection and the training loss.

The network is a frozen copy of ``tests/torch_refs.py:37-206``
(``TConv`` … ``TorchYOLOv5``, ``yolo_decode_torch``), written against the
public Ultralytics v6.1 spec with its ``model.0`` … ``model.24`` state-dict
keys; its convolutions are :class:`~common.QConv2d` so the control can run
it in a lower precision. The loss is Ultralytics v6.1's ``ComputeLoss``
(``utils/loss.py``: the shape-ratio match, the centre cell and one x- and one
y-neighbour, CIoU box, BCE objectness with the level balance, BCE classes)
at fixed shapes, with two choices of this project's recipe, which its JAX
package documents: a gt's duplicate (cell, anchor) slots all count, and the
objectness target of a cell is the largest of its slots' CIoUs (Ultralytics
keeps whichever slot it writes last), with CIoU's alpha inside the graph.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.common import EPS, QConv2d, class_nms, topk_stable


class TConv(nn.Module):
    """Ultralytics Conv: Conv2d (no bias) + BN (eps 1e-3) + SiLU."""

    def __init__(self, cin, cout, k=1, s=1, p=None):
        super().__init__()
        self.conv = QConv2d(cin, cout, k, s, k // 2 if p is None else p,
                            bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3, momentum=0.03)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class TBottleneck(nn.Module):
    def __init__(self, cin, cout, shortcut=True, e=0.5):
        super().__init__()
        ch = int(cout * e)
        self.cv1 = TConv(cin, ch, 1)
        self.cv2 = TConv(ch, cout, 3)
        self.add = shortcut and cin == cout

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class TC3(nn.Module):
    def __init__(self, cin, cout, n=1, shortcut=True, e=0.5):
        super().__init__()
        ch = int(cout * e)
        self.cv1 = TConv(cin, ch, 1)
        self.cv2 = TConv(cin, ch, 1)
        self.cv3 = TConv(2 * ch, cout, 1)
        self.m = nn.Sequential(*(TBottleneck(ch, ch, shortcut, 1.0)
                                 for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class TSPPF(nn.Module):
    def __init__(self, cin, cout, k=5):
        super().__init__()
        ch = cin // 2
        self.cv1 = TConv(cin, ch, 1)
        self.cv2 = TConv(ch * 4, cout, 1)
        self.m = nn.MaxPool2d(k, 1, k // 2)

    def forward(self, x):
        x = self.cv1(x)
        y1 = self.m(x)
        y2 = self.m(y1)
        return self.cv2(torch.cat([x, y1, y2, self.m(y2)], 1))


class TDetect(nn.Module):
    """v6.1 Detect: a 1x1 conv per level; raw maps only."""

    def __init__(self, nc, chs, na=3):
        super().__init__()
        self.nc, self.na = nc, na
        self.m = nn.ModuleList(QConv2d(c, na * (5 + nc), 1) for c in chs)

    def forward(self, feats):
        return [conv(f) for conv, f in zip(self.m, feats)]


class TorchYOLOv5(nn.Module):
    """YOLOv5 v6.1 with the Ultralytics ``model.{i}`` key layout; NCHW
    float input in [0, 1], raw (B, A·(5+C), H, W) maps per level."""

    def __init__(self, nc=80, depth_multiple=0.33, width_multiple=0.50):
        super().__init__()

        def cw(c):
            return max(8, int(math.ceil(c * width_multiple / 8) * 8))

        def d(n):
            return max(round(n * depth_multiple), 1)

        m = nn.ModuleList()
        m.append(TConv(3, cw(64), 6, 2, 2))                 # 0 stem
        m.append(TConv(cw(64), cw(128), 3, 2))              # 1
        m.append(TC3(cw(128), cw(128), d(3)))               # 2
        m.append(TConv(cw(128), cw(256), 3, 2))             # 3
        m.append(TC3(cw(256), cw(256), d(6)))               # 4 → save
        m.append(TConv(cw(256), cw(512), 3, 2))             # 5
        m.append(TC3(cw(512), cw(512), d(9)))               # 6 → save
        m.append(TConv(cw(512), cw(1024), 3, 2))            # 7
        m.append(TC3(cw(1024), cw(1024), d(3)))             # 8
        m.append(TSPPF(cw(1024), cw(1024)))                 # 9
        m.append(TConv(cw(1024), cw(512), 1))               # 10 → save
        m.append(nn.Identity())                             # 11 upsample
        m.append(nn.Identity())                             # 12 concat
        m.append(TC3(cw(1024), cw(512), d(3), shortcut=False))   # 13
        m.append(TConv(cw(512), cw(256), 1))                # 14 → save
        m.append(nn.Identity())                             # 15 upsample
        m.append(nn.Identity())                             # 16 concat
        m.append(TC3(cw(512), cw(256), d(3), shortcut=False))    # 17 P3
        m.append(TConv(cw(256), cw(256), 3, 2))             # 18
        m.append(nn.Identity())                             # 19 concat
        m.append(TC3(cw(512), cw(512), d(3), shortcut=False))    # 20 P4
        m.append(TConv(cw(512), cw(512), 3, 2))             # 21
        m.append(nn.Identity())                             # 22 concat
        m.append(TC3(cw(1024), cw(1024), d(3), shortcut=False))  # 23 P5
        m.append(TDetect(nc, (cw(256), cw(512), cw(1024))))  # 24
        self.model = m

    def forward(self, x):
        m = self.model
        for i in range(10):
            x = m[i](x)
            if i == 4:
                c3 = x
            elif i == 6:
                c4 = x
        lat5 = m[10](x)
        x = torch.cat([F.interpolate(lat5, scale_factor=2, mode="nearest"),
                       c4], 1)
        t4 = m[13](x)
        lat4 = m[14](t4)
        x = torch.cat([F.interpolate(lat4, scale_factor=2, mode="nearest"),
                       c3], 1)
        p3 = m[17](x)
        x = torch.cat([m[18](p3), lat4], 1)
        p4 = m[20](x)
        x = torch.cat([m[21](p4), lat5], 1)
        p5 = m[23](x)
        return m[24]((p3, p4, p5))


def build(cfg: Dict) -> TorchYOLOv5:
    return TorchYOLOv5(cfg["num_classes"], cfg["depth_multiple"],
                       cfg["width_multiple"])


def decode(raw: Sequence[torch.Tensor], nc: int, anchors, strides):
    """v6.1 inference decode of raw maps, flat in (level, y, x, anchor)
    order: boxes xyxy (B, N, 4), objectness (B, N), classes (B, N, C)."""
    boxes, objs, clss = [], [], []
    for lvl, p in enumerate(raw):
        b, _, ny, nx = p.shape
        a = len(anchors[lvl])
        y = p.float().view(b, a, 5 + nc, ny, nx).permute(0, 3, 4, 1, 2)
        y = y.sigmoid()
        gy, gx = torch.meshgrid(torch.arange(ny, device=p.device),
                                torch.arange(nx, device=p.device),
                                indexing="ij")
        grid = torch.stack([gx, gy], -1).float()[None, :, :, None, :]
        anc = torch.tensor(anchors[lvl], dtype=torch.float32,
                           device=p.device)[None, None, None]
        xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * strides[lvl]
        wh = (y[..., 2:4] * 2.0) ** 2 * anc
        boxes.append(torch.cat([xy - wh / 2, xy + wh / 2], -1).reshape(b, -1, 4))
        objs.append(y[..., 4].reshape(b, -1))
        clss.append(y[..., 5:].reshape(b, -1, nc))
    return torch.cat(boxes, 1), torch.cat(objs, 1), torch.cat(clss, 1)


def select_and_nms(boxes, obj, cls, ev: Dict):
    """The eval's detections from the decode: the top ``pre_nms_topk``
    anchors by objectness, each anchor's best ``max_cls_per_box`` classes
    (one without ``multi_label``; equal scores lower index first), the (anchor, class) pairs scored
    obj·cls above ``conf_thres``, the top ``pre_nms_topk`` pairs, greedy
    NMS per class at ``iou_thres``, the top ``max_det``."""
    k1 = min(ev["pre_nms_topk"], obj.shape[1])
    _, ai = topk_stable(obj, k1)
    b = torch.gather(boxes, 1, ai[..., None].expand(-1, -1, 4))
    o = torch.gather(obj, 1, ai)
    c = torch.gather(cls, 1, ai[..., None].expand(-1, -1, cls.shape[-1]))
    kc = ev["max_cls_per_box"] if ev["multi_label"] else 1
    cv, ci = topk_stable(c, kc)
    pair = o[..., None] * cv
    pair = torch.where(pair > ev["conf_thres"], pair, torch.zeros_like(pair))
    flat = pair.reshape(pair.shape[0], -1)
    k2 = min(ev["pre_nms_topk"], flat.shape[1])
    ps, pi = topk_stable(flat, k2)
    pb = torch.gather(b, 1, (pi // kc)[..., None].expand(-1, -1, 4))
    pc = torch.gather(ci.reshape(ci.shape[0], -1), 1, pi)
    return class_nms(pb, ps, pc, score_thres=0.0, iou_thres=ev["iou_thres"],
                     pre_nms_topk=k2, max_det=ev["max_det"])


# ---------------------------------------------------------------------------
# training loss
# ---------------------------------------------------------------------------

def ciou(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Complete IoU of cxcywh boxes (Zheng et al. 2020), v6.1's form."""
    b1x1, b1x2 = b1[..., 0] - b1[..., 2] / 2, b1[..., 0] + b1[..., 2] / 2
    b1y1, b1y2 = b1[..., 1] - b1[..., 3] / 2, b1[..., 1] + b1[..., 3] / 2
    b2x1, b2x2 = b2[..., 0] - b2[..., 2] / 2, b2[..., 0] + b2[..., 2] / 2
    b2y1, b2y2 = b2[..., 1] - b2[..., 3] / 2, b2[..., 1] + b2[..., 3] / 2
    inter = ((torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1))
             .clamp(min=0) *
             (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1))
             .clamp(min=0))
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1
    union = w1 * h1 + w2 * h2 - inter + EPS
    iou = inter / union
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    c2 = cw ** 2 + ch ** 2 + EPS
    rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 +
            (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w2 / (h2 + EPS)) -
                              torch.atan(w1 / (h1 + EPS))) ** 2
    alpha = v / (v - iou + (1 + EPS))
    return iou - (rho2 / c2 + v * alpha)


def bce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (logits.clamp(min=0) - logits * target +
            torch.log1p(torch.exp(-logits.abs())))


def loss(raw: Sequence[torch.Tensor], gt_cxcywh: torch.Tensor,
         gt_cls: torch.Tensor, gt_mask: torch.Tensor, cfg: Dict):
    """The batch-scaled v6.1 loss of raw maps (B, A·(5+C), H, W) per level;
    gts (B, M, 4) cxcywh input pixels, classes (B, M), mask (B, M). Returns
    (total, {box, obj, cls, total})."""
    lc = cfg["train"]["loss"]
    nc, anchors, strides = cfg["num_classes"], cfg["anchors"], cfg["strides"]
    nl = len(raw)
    b = raw[0].shape[0]
    dev = raw[0].device
    lbox = lobj = lcls = torch.zeros((), device=dev)
    for lvl, p in enumerate(raw):
        _, _, h, w = p.shape
        a_n = len(anchors[lvl])
        p = p.float().view(b, a_n, 5 + nc, h, w).permute(0, 1, 3, 4, 2)
        s = strides[lvl]
        anc = torch.tensor(anchors[lvl], dtype=torch.float32, device=dev) / s
        gxy, gwh = gt_cxcywh[..., :2] / s, gt_cxcywh[..., 2:] / s
        r = gwh[:, :, None, :] / anc                           # (B, M, A, 2)
        ok_a = (torch.maximum(r, 1 / r.clamp(min=1e-9)).amax(-1)
                < lc["anchor_t"]) & gt_mask[:, :, None]
        frac = gxy - gxy.floor()
        left = (frac < 0.5) & (gxy > 1.0)
        right = (frac > 0.5) & (gxy < torch.tensor([w - 1.0, h - 1.0],
                                                   device=dev))
        cells = [gxy.floor()]
        oks = [torch.ones_like(left[..., 0])]
        for ax in (0, 1):                     # one x-, then one y-neighbour
            step = torch.zeros_like(gxy)
            step[..., ax] = torch.where(left[..., ax], -1.0,
                                        torch.where(right[..., ax], 1.0, 0.0))
            cells.append(gxy.floor() + step)
            oks.append(left[..., ax] | right[..., ax])
        tobj = torch.zeros(b, a_n, h, w, device=dev)
        n_pos = torch.zeros((), device=dev)
        box_sum = torch.zeros((), device=dev)
        cls_sum = torch.zeros((), device=dev)
        bi = torch.arange(b, device=dev)[:, None, None].expand(-1, *ok_a.shape[1:])
        ai = torch.arange(a_n, device=dev)[None, None, :].expand_as(ok_a)
        for cell, ok_o in zip(cells, oks):
            valid = ok_a & ok_o[:, :, None]                    # (B, M, A)
            gi = cell[..., 0].clamp(0, w - 1).long()[:, :, None].expand_as(ai)
            gj = cell[..., 1].clamp(0, h - 1).long()[:, :, None].expand_as(ai)
            ps = p[bi, ai, gj, gi]                             # (B, M, A, 5+C)
            pxy = ps[..., :2].sigmoid() * 2 - 0.5
            pwh = (ps[..., 2:4].sigmoid() * 2) ** 2 * anc
            txy = gxy[:, :, None, :] - torch.stack([gi, gj], -1).float()
            twh = gwh[:, :, None, :].expand_as(pwh)
            iou = ciou(torch.cat([pxy, pwh], -1), torch.cat([txy, twh], -1))
            vf = valid.float()
            n_pos = n_pos + vf.sum()
            box_sum = box_sum + ((1 - iou) * vf).sum()
            t = F.one_hot(gt_cls.long().clamp(0, nc - 1), nc).float()
            t = t[:, :, None, :].expand(-1, -1, a_n, -1)
            cls_sum = cls_sum + (bce(ps[..., 5:], t) * vf[..., None]).sum()
            flat = ((bi * a_n + ai) * h + gj) * w + gi
            tv = (iou.detach().clamp(min=0) * vf).reshape(-1)
            tobj.view(-1).scatter_reduce_(0, flat.reshape(-1), tv,
                                          reduce="amax", include_self=True)
        n_pos = n_pos.clamp(min=1.0)
        lbox = lbox + box_sum / n_pos
        lcls = lcls + cls_sum / (n_pos * nc)
        lobj = lobj + bce(p[..., 4], tobj).mean() * lc["balance"][lvl]
    scale = 3.0 / nl
    lbox = lbox * lc["box_gain"] * scale
    lobj = lobj * lc["obj_gain"] * scale * (cfg["img_size"] / 640.0) ** 2
    lcls = lcls * lc["cls_gain"] * scale * (nc / 80.0)
    total = (lbox + lobj + lcls) * b
    return total, {"box": lbox, "obj": lobj, "cls": lcls, "total": total}
