"""Plain float32 FasterRCNN with a ResNet50, a YOLOv8-style PAFPN and the
decoupled box head: inference and the two-stage training loss.

After torchvision's FasterRCNN (``models/detection``: ``AnchorGenerator``
without the rounding of its cell anchors, ``RegionProposalNetwork``,
``MultiScaleRoIAlign`` with ``aligned=False`` and sampling ratio 2,
``BoxCoder``, ``Matcher`` with low-quality matches,
``BalancedPositiveNegativeSampler``, ``fastrcnn_loss``) and the neck and head
of the HeltonDetection recipe. The ResNet is a frozen copy of
``tests/torch_refs.py:212-283`` (torchvision's key layout); the neck, the
RPN head and the box head take the key names of the program's checkpoints
(``neck.in0.conv.weight`` …), the format in which their weights are
handed to it. Sampling draws its randomness from explicit uniforms (three
per row: foreground priority, background priority, order), which the
harness hands to the program as well.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.common import (QConv2d, QLinear, box_iou,
                                        class_nms, clip, decode, encode,
                                        topk_stable)


# ---------------------------------------------------------------------------
# ResNet (torchvision v1 layout)
# ---------------------------------------------------------------------------

class TTorchBottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, width, stride=1, downsample=None):
        super().__init__()
        self.conv1 = QConv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = QConv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = QConv2d(width, width * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(width * 4)
        self.downsample = downsample

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + idt)


class TorchResNet(nn.Module):
    """(C2, C3, C4, C5) of a bottleneck ResNet; ``frozen_stages`` stops the
    gradient after the stem and that many stages."""

    def __init__(self, stage_sizes=(3, 4, 6, 3), frozen_stages: int = 1):
        super().__init__()
        self.conv1 = QConv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for si, (n, width) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
            blocks = []
            for bi in range(n):
                stride = 2 if (bi == 0 and si > 0) else 1
                down = None
                if bi == 0:
                    down = nn.Sequential(
                        QConv2d(cin, width * 4, 1, stride, bias=False),
                        nn.BatchNorm2d(width * 4))
                blocks.append(TTorchBottleneck(cin, width, stride, down))
                cin = width * 4
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
        self.frozen_stages = frozen_stages

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for si in range(4):
            x = getattr(self, f"layer{si + 1}")(x)
            if si + 1 <= self.frozen_stages:
                x = x.detach()
            outs.append(x)
        return outs


# ---------------------------------------------------------------------------
# PAFPNv8 (program key layout)
# ---------------------------------------------------------------------------

class ConvBnAct(nn.Module):
    def __init__(self, cin, cout, k=1, s=1):
        super().__init__()
        self.conv = QConv2d(cin, cout, k, s, k // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3, momentum=0.03)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.cv1 = ConvBnAct(c, c, 1)
        self.cv2 = ConvBnAct(c, c, 3)

    def forward(self, x):
        return self.cv2(self.cv1(x))           # no shortcut in the neck


class C3(nn.Module):
    def __init__(self, cin, cout, n=1):
        super().__init__()
        ch = cout // 2
        self.cv1 = ConvBnAct(cin, ch, 1)
        self.n = n
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(ch))
        self.cv2 = ConvBnAct(cin, ch, 1)
        self.cv3 = ConvBnAct(2 * ch, cout, 1)

    def forward(self, x):
        y = self.cv1(x)
        for i in range(self.n):
            y = getattr(self, f"m{i}")(y)
        return self.cv3(torch.cat([y, self.cv2(x)], 1))


class PAFPNv8(nn.Module):
    """1x1 ConvBnAct per input, a top-down path of C3s over the upsampled
    level above, a bottom-up path of strided 3x3 ConvBnActs and C3s, P6 as
    every other row and column of the last level."""

    def __init__(self, in_channels: Sequence[int], c: int = 256):
        super().__init__()
        self.n = n = len(in_channels)
        for i, cin in enumerate(in_channels):
            self.add_module(f"in{i}", ConvBnAct(cin, c, 1))
        for i in range(n - 1):
            self.add_module(f"td{i}", C3(2 * c, c))
        for i in range(1, n):
            self.add_module(f"bu{i}", ConvBnAct(c, c, 3, 2))
            self.add_module(f"out{i}", C3(2 * c, c))

    def forward(self, feats):
        n = self.n
        xs = [getattr(self, f"in{i}")(f) for i, f in enumerate(feats)]
        td = [None] * n
        td[-1] = xs[-1]
        for i in range(n - 2, -1, -1):
            up = F.interpolate(td[i + 1], scale_factor=2, mode="nearest")
            td[i] = getattr(self, f"td{i}")(torch.cat([up, xs[i]], 1))
        outs = [td[0]]
        for i in range(1, n):
            x = getattr(self, f"bu{i}")(outs[-1])
            outs.append(getattr(self, f"out{i}")(torch.cat([x, td[i]], 1)))
        return outs + [outs[-1][:, :, ::2, ::2]]


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------

class RPNHead(nn.Module):
    def __init__(self, c=256, a=3):
        super().__init__()
        self.conv = QConv2d(c, 256, 3, 1, 1)
        self.cls = QConv2d(256, a, 1)
        self.reg = QConv2d(256, a * 4, 1)

    def forward(self, feats):
        """Objectness (B, N) and deltas (B, N, 4) over every level, rows in
        (level, y, x, anchor) order."""
        logits, deltas = [], []
        for f in feats:
            t = F.relu(self.conv(f))
            b = f.shape[0]
            logits.append(self.cls(t).permute(0, 2, 3, 1).reshape(b, -1))
            deltas.append(self.reg(t).permute(0, 2, 3, 1).reshape(b, -1, 4))
        return torch.cat(logits, 1), torch.cat(deltas, 1)


class DecoupledBoxHead(nn.Module):
    """Per branch two 3x3 convs (ReLU), the (h, w, c)-flattened crop through
    a 1024 dense layer (ReLU); class logits (C+1) and per-class deltas."""

    def __init__(self, nc, c=256, fc=1024, roi=7):
        super().__init__()
        for br in ("cls", "reg"):
            self.add_module(f"{br}_conv0", QConv2d(c, 256, 3, 1, 1))
            self.add_module(f"{br}_conv1", QConv2d(256, 256, 3, 1, 1))
            self.add_module(f"{br}_fc", QLinear(256 * roi * roi, fc))
        self.cls = QLinear(fc, nc + 1)
        self.reg = QLinear(fc, nc * 4)
        self.nc = nc

    def _branch(self, br, x):
        for i in range(2):
            x = F.relu(getattr(self, f"{br}_conv{i}")(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return F.relu(getattr(self, f"{br}_fc")(x))

    def forward(self, crops):                      # (R, C, 7, 7)
        r = crops.shape[0]
        return (self.cls(self._branch("cls", crops)),
                self.reg(self._branch("reg", crops)).reshape(r, self.nc, 4))


class FasterRCNN(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        self.cfg = cfg
        self.backbone = TorchResNet(cfg["stage_sizes"],
                                    cfg["backbone_frozen_stages"])
        self.neck = PAFPNv8((256, 512, 1024, 2048), cfg["neck_channels"])
        self.rpn = RPNHead(cfg["neck_channels"], len(cfg["rpn"]["ratios"]))
        self.box_head = DecoupledBoxHead(cfg["num_classes"],
                                         cfg["head_channels"],
                                         cfg["head_fc"], cfg["roi_size"])

    def train(self, mode: bool = True):
        """Training mode with the ResNet's BatchNorm on its running
        statistics (``backbone_norm_eval``)."""
        super().train(mode)
        if mode and self.cfg["backbone_norm_eval"]:
            for m in self.backbone.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.eval()
        return self

    def features(self, x):                         # x (B, 3, S, S)
        return self.neck(self.backbone(x))


def build(cfg: Dict) -> FasterRCNN:
    return FasterRCNN(cfg)


def anchors(cfg: Dict, device) -> tuple:
    """Every RPN anchor (N, 4) xyxy, levels P2..P6 in (y, x, anchor) order,
    and each level's count: per cell one anchor per ratio r of the level's
    size s, h = s·√r and w = s/√r, centred at (x·stride, y·stride)."""
    rc = cfg["rpn"]
    out, counts = [], []
    for stride, size in zip(rc["strides"], rc["sizes"]):
        n = cfg["img_size"] // stride
        r = torch.tensor(rc["ratios"], dtype=torch.float64)
        hs, ws = size * torch.sqrt(r), size / torch.sqrt(r)
        cell = torch.stack([-ws / 2, -hs / 2, ws / 2, hs / 2], 1).float()
        c = torch.arange(n, dtype=torch.float32) * stride
        cy, cx = torch.meshgrid(c, c, indexing="ij")
        shift = torch.stack([cx, cy, cx, cy], -1).reshape(-1, 1, 4)
        out.append((shift + cell[None]).reshape(-1, 4))
        counts.append(out[-1].shape[0])
    return torch.cat(out).to(device), counts


def proposals(cfg: Dict, logits, deltas, anc, counts):
    """Per level the top ``pre_nms_topk`` logits, decoded, clipped, boxes
    under 1e-3 px dropped, NMS at ``nms_thresh``; then the joint top
    ``post_nms_topk`` by σ(logit). (boxes (B, P, 4), valid (B, P))."""
    rc = cfg["rpn"]
    size = cfg["img_size"]
    boxes_l, scores_l = [], []
    start = 0
    for cnt in counts:
        sl = slice(start, start + cnt)
        start += cnt
        k = min(rc["pre_nms_topk"], cnt)
        s, i = topk_stable(logits[:, sl], k)
        d = torch.gather(deltas[:, sl], 1, i[..., None].expand(-1, -1, 4))
        b = clip(decode(anc[sl][i], d), size)
        ok = ((b[..., 2] - b[..., 0]) > 1e-3) & ((b[..., 3] - b[..., 1]) > 1e-3)
        s = torch.where(ok, torch.sigmoid(s), torch.zeros_like(s))
        kb, ks, _, _ = class_nms(b, s, torch.zeros_like(i), score_thres=0.0,
                                 iou_thres=rc["nms_thresh"], pre_nms_topk=k,
                                 max_det=min(k, rc["post_nms_topk"]),
                                 class_aware=False)
        boxes_l.append(kb)
        scores_l.append(ks)
    boxes, scores = torch.cat(boxes_l, 1), torch.cat(scores_l, 1)
    k = min(rc["post_nms_topk"], scores.shape[1])
    ps, oi = topk_stable(scores, k)
    pb = torch.gather(boxes, 1, oi[..., None].expand(-1, -1, 4))
    return pb, ps > 0


def roi_align(cfg: Dict, pyr: List[torch.Tensor], rois: torch.Tensor):
    """torchvision's MultiScaleRoIAlign over P2..P{1+roi_levels}: each roi
    pools from level clamp(floor(2 + log2(√area/224)), 0, L−1) of its own
    image, ``aligned=False`` (no half-pixel shift, rois at least 1 px), a
    2x2 grid of bilinear samples per bin, zero outside (−1, H) × (−1, W).
    rois (B, R, 4) without gradient → crops (B·R, C, 7, 7)."""
    out_size, s = cfg["roi_size"], cfg["roi_sampling_ratio"]
    nl = cfg["roi_levels"]
    strides = cfg["rpn"]["strides"][:nl]
    b, r = rois.shape[:2]
    c = pyr[0].shape[1]
    rois = rois.detach()
    area = ((rois[..., 2] - rois[..., 0]).clamp(min=0) *
            (rois[..., 3] - rois[..., 1]).clamp(min=0))
    lvl = torch.floor(2 + torch.log2(torch.sqrt(area) / 224 + 1e-8))
    lvl = lvl.clamp(0, nl - 1).long()
    out = pyr[0].new_zeros((b, r, c, out_size, out_size))
    g = (torch.arange(out_size * s, device=rois.device) + 0.5) / s
    for li in range(nl):
        feat = pyr[li]
        h, w = feat.shape[2], feat.shape[3]
        for img in range(b):
            sel = (lvl[img] == li).nonzero()[:, 0]
            if sel.numel() == 0:
                continue
            bx = rois[img, sel] / strides[li]
            rw = (bx[:, 2] - bx[:, 0]).clamp(min=1.0)
            rh = (bx[:, 3] - bx[:, 1]).clamp(min=1.0)
            ys = bx[:, 1:2] + g * (rh / out_size)[:, None]       # (n, 14)
            xs = bx[:, 0:1] + g * (rw / out_size)[:, None]
            yy = ys[:, :, None].expand(-1, -1, xs.shape[1])
            xx = xs[:, None, :].expand(-1, ys.shape[1], -1)
            ok = (yy > -1) & (yy < h) & (xx > -1) & (xx < w)
            yc, xc = yy.clamp(0, h - 1), xx.clamp(0, w - 1)
            y0, x0 = yc.floor(), xc.floor()
            y1 = (y0 + 1).clamp(max=h - 1)
            x1 = (x0 + 1).clamp(max=w - 1)
            ly, lx = yc - y0, xc - x0
            f = feat[img]                                          # (C, H, W)

            def tap(yi, xi):
                return f[:, yi.long(), xi.long()]                  # (C, n, S, S)

            v = (tap(y0, x0) * ((1 - ly) * (1 - lx)) +
                 tap(y0, x1) * ((1 - ly) * lx) +
                 tap(y1, x0) * (ly * (1 - lx)) +
                 tap(y1, x1) * (ly * lx)) * ok
            v = v.reshape(c, -1, out_size, s, out_size, s).mean((3, 5))
            out[img, sel] = v.permute(1, 0, 2, 3)
    return out.reshape(b * r, c, out_size, out_size)


def box_head(model: FasterRCNN, pyr, rois):
    b, r = rois.shape[:2]
    scores, deltas = model.box_head(roi_align(model.cfg, pyr, rois))
    return scores.reshape(b, r, -1), deltas.reshape(b, r, -1, 4)


def infer(model: FasterRCNN, images: torch.Tensor):
    """Detections of images (B, S, S, 3) in [0, 1]: (boxes, scores,
    classes, valid), each (B, max_det, …); and candidates for the program's
    detections to be found among: the box head over every level's top
    ``pre_nms_topk`` boxes before NMS (a superset of the proposals of any
    run whose RPN scores differ by rounding), per (box, class) boxes
    (B, K, C, 4) and probabilities (B, K, C)."""
    cfg = model.cfg
    ev = cfg["eval"]
    wts = cfg["box"]["weights"]
    pyr = model.features(images.permute(0, 3, 1, 2))
    logits, deltas = model.rpn(pyr)
    anc, counts = anchors(cfg, images.device)
    props, pvalid = proposals(cfg, logits, deltas, anc, counts)
    scores, hd = box_head(model, pyr, props)
    probs = torch.softmax(scores, -1)[..., 1:] * pvalid[..., None]
    boxes = clip(decode(props[:, :, None, :], hd, wts), cfg["img_size"])
    b, p, nc = probs.shape
    cls = torch.arange(nc, device=images.device).repeat(b, p)
    dets = class_nms(boxes.reshape(b, p * nc, 4), probs.reshape(b, p * nc),
                     cls, score_thres=ev["conf_thres"],
                     iou_thres=ev["iou_thres"],
                     pre_nms_topk=min(p * nc, ev["pre_nms_topk"]),
                     max_det=ev["max_det"])
    cand = pre_nms_boxes(cfg, logits, deltas, anc, counts)
    cb, cp = [], []
    for i in range(b):
        one = [f[i:i + 1] for f in pyr]
        s_, d_ = box_head(model, one, cand[i:i + 1])
        cp.append(torch.softmax(s_, -1)[0, :, 1:])
        cb.append(clip(decode(cand[i][:, None, :], d_[0], wts),
                       cfg["img_size"]))
    return dets, torch.stack(cb), torch.stack(cp)


def pre_nms_boxes(cfg: Dict, logits, deltas, anc, counts):
    """Every level's top ``pre_nms_topk`` anchors by logit, decoded and
    clipped: (B, K, 4)."""
    out, start = [], 0
    for cnt in counts:
        sl = slice(start, start + cnt)
        start += cnt
        k = min(cfg["rpn"]["pre_nms_topk"], cnt)
        _, i = topk_stable(logits[:, sl], k)
        d = torch.gather(deltas[:, sl], 1, i[..., None].expand(-1, -1, 4))
        out.append(clip(decode(anc[sl][i], d), cfg["img_size"]))
    return torch.cat(out, 1)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def sample(fg, bg, batch: int, pos_frac: float, draws):
    """BalancedPositiveNegativeSampler with given uniforms (three (B, n)):
    the ``batch·pos_frac`` foreground rows of highest first uniform, the
    rest of the batch from the background rows of highest second uniform;
    the chosen rows first (foreground, then background, each by the third
    uniform), then unchosen rows. (idx, is_fg, valid), each (B, batch)."""
    u_fg, u_bg, u_g = draws
    b, n = fg.shape
    batch = min(batch, n)
    max_fg = int(batch * pos_frac)
    idx_all, fg_all, val_all = [], [], []
    for i in range(b):
        f = fg[i].nonzero()[:, 0]
        f = f[torch.argsort(u_fg[i, f], descending=True, stable=True)][:max_fg]
        g = bg[i].nonzero()[:, 0]
        g = g[torch.argsort(u_bg[i, g], descending=True,
                            stable=True)][:batch - f.numel()]
        pri = u_g[i] * 1e-3
        pri = pri.index_add(0, f, torch.full_like(f, 2, dtype=pri.dtype))
        pri = pri.index_add(0, g, torch.ones_like(g, dtype=pri.dtype))
        _, idx = topk_stable(pri, batch)
        is_fg = torch.zeros(n, dtype=torch.bool, device=fg.device)
        is_fg[f] = True
        chosen = is_fg.clone()
        chosen[g] = True
        idx_all.append(idx)
        fg_all.append(is_fg[idx])
        val_all.append(chosen[idx])
    return torch.stack(idx_all), torch.stack(fg_all), torch.stack(val_all)


def smooth_l1(x, beta=1.0 / 9.0):
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def rows(x, idx):
    return torch.stack([x[i, idx[i]] for i in range(x.shape[0])])


def loss(model: FasterRCNN, images: torch.Tensor, gt: torch.Tensor,
         gt_cls: torch.Tensor, gt_mask: torch.Tensor, draws):
    """The two-stage training loss of a batch (images (B, S, S, 3) in
    [0, 1], gts (B, M, 4) xyxy with classes and mask): the RPN's anchors
    matched at 0.7/0.3 (plus each gt's best anchors), 256 sampled at half
    foreground, BCE and smooth-L1 (beta 1/9); proposals without gradient,
    the gts appended, matched at 0.5, 512 sampled at a quarter foreground,
    cross-entropy and smooth-L1 on the gt class's deltas; each term over the
    sampled count, then the batch mean. (total, terms)."""
    cfg = model.cfg
    rc, bc = cfg["rpn"], cfg["box"]
    dev = images.device
    pyr = model.features(images.permute(0, 3, 1, 2))
    logits, deltas = model.rpn(pyr)
    anc, counts = anchors(cfg, dev)
    with torch.no_grad():
        props, pvalid = proposals(cfg, logits.detach(), deltas.detach(), anc,
                                  counts)
    any_gt = gt_mask.any(1, keepdim=True)
    # RPN
    iou = torch.stack([box_iou(anc, g) for g in gt])           # (B, N, M)
    iou = torch.where(gt_mask[:, None, :], iou, torch.full_like(iou, -1))
    best, best_gt = iou.max(2)
    fg = best >= rc["fg_iou"]
    bg = best < rc["bg_iou"]
    gt_best = iou.amax(1)
    low_q = ((iou >= gt_best[:, None, :] * (1 - 1e-6)) & gt_mask[:, None, :]
             & (iou > 0)).any(2)
    fg = (fg | low_q) & any_gt
    bg = bg & ~(fg | low_q)
    idx, is_fg, valid = sample(fg, bg, rc["batch"], rc["pos_frac"], draws[0])
    n = valid.float().sum(1).clamp(min=1)
    lg = torch.gather(logits, 1, idx)
    tgt = is_fg.float()
    l_obj = (F.binary_cross_entropy_with_logits(lg, tgt, reduction="none")
             * valid).sum(1) / n
    matched = torch.gather(best_gt, 1, idx)
    reg_t = encode(anc[idx], rows(gt, matched))
    l_rreg = ((smooth_l1(rows(deltas, idx) - reg_t).sum(-1)
               * (is_fg & valid)).sum(1) / n)
    # box head
    allp = torch.cat([props, gt], 1)
    allv = torch.cat([pvalid, gt_mask], 1)
    iou = torch.stack([box_iou(p, g) for p, g in zip(allp, gt)])
    iou = torch.where(gt_mask[:, None, :] & allv[:, :, None], iou,
                      torch.full_like(iou, -1))
    best, best_gt = iou.max(2)
    fg = (best >= bc["fg_iou"]) & allv
    bg = (best < bc["fg_iou"]) & allv & ~fg
    idx, is_fg, valid = sample(fg, bg, bc["batch"], bc["pos_frac"], draws[1])
    rois = rows(allp, idx)
    matched = torch.gather(best_gt, 1, idx)
    labels = torch.where(is_fg, torch.gather(gt_cls.long(), 1, matched) + 1,
                         torch.zeros_like(matched))
    reg_t = encode(rois, rows(gt, matched), bc["weights"])
    scores, hd = box_head(model, pyr, rois)
    n = valid.float().sum(1).clamp(min=1)
    ce = F.cross_entropy(scores.reshape(-1, scores.shape[-1]),
                         labels.reshape(-1), reduction="none").reshape(labels.shape)
    l_cls = (ce * valid).sum(1) / n
    d = torch.gather(hd, 2, (labels - 1).clamp(min=0)[..., None, None]
                     .expand(-1, -1, 1, 4))[:, :, 0]
    l_box = (smooth_l1(d - reg_t).sum(-1) * (is_fg & valid)).sum(1) / n
    terms = {"rpn_obj": l_obj.mean(), "rpn_reg": l_rreg.mean(),
             "cls": l_cls.mean(), "box": l_box.mean()}
    total = sum(terms.values())
    terms["total"] = total
    return total, terms


def frozen(name: str, cfg: Dict) -> bool:
    """Whether a parameter is in the stem or a frozen stage: no gradient,
    no update."""
    k = cfg["backbone_frozen_stages"]
    return name.startswith(("backbone.conv1.", "backbone.bn1.")) or any(
        name.startswith(f"backbone.layer{i}.") for i in range(1, k + 1))
