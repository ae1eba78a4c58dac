"""The one traffic generator: frames with painted objects, made from the
seed by a traffic mix's parameters (``benchmark/traffic/<name>.json``).

A source frame takes one of the mix's source shapes (weighted), a count of
objects from a negative binomial of the mix's mean and dispersion (COCO
val2017: 7.3 a frame, heavy-tailed), capped at ``max``, each object a
size band (COCO's small, medium and large shares of sqrt(area) in pixels,
log-uniform within the band), a log-uniform aspect and a class. The frame
is smooth noise with each object filled in its class's colour. A frame is
letterboxed to the model's size (pad ``pad_value``), or with
``mosaic_p`` four frames are letterboxed into the quadrants of one canvas.
Counts, shapes and boxes come from numpy's generator, pixels from a
``torch.Generator`` on the device, both seeded by ``--seed``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed, stream])


def torch_gen(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (2 ** 63))
    return g


def frame_spec(rng: np.random.Generator, mix: Dict, num_classes: int):
    """(h, w, boxes (k, 4) xyxy float32, classes (k,) int64)."""
    shapes = np.asarray([s[:2] for s in mix["source_shapes"]])
    p = np.asarray([s[2] for s in mix["source_shapes"]], np.float64)
    h, w = shapes[rng.choice(len(shapes), p=p / p.sum())]
    ob = mix["objects"]
    r = ob["dispersion"]
    k = int(min(rng.negative_binomial(r, r / (r + ob["mean"])), ob["max"]))
    bands = mix["object_sizes"]
    bp = np.asarray([b[0] for b in bands], np.float64)
    boxes = np.zeros((k, 4), np.float32)
    for i in range(k):
        _, lo, hi = bands[rng.choice(len(bands), p=bp / bp.sum())]
        side = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        ar = float(np.exp(rng.uniform(np.log(mix["aspect"][0]),
                                      np.log(mix["aspect"][1]))))
        bw = min(side * np.sqrt(ar), w - 1.0)
        bh = min(side / np.sqrt(ar), h - 1.0)
        x1 = rng.uniform(0, w - bw)
        y1 = rng.uniform(0, h - bh)
        boxes[i] = (x1, y1, x1 + bw, y1 + bh)
    classes = rng.integers(0, num_classes, k)
    return int(h), int(w), boxes, classes


def render(h: int, w: int, boxes: np.ndarray, classes: np.ndarray,
           palette: torch.Tensor, gen: torch.Generator, device
           ) -> torch.Tensor:
    """A (h, w, 3) uint8 frame on ``device``: smooth noise, each box filled
    with its class's colour."""
    coarse = torch.rand((1, 3, h // 32 + 2, w // 32 + 2), generator=gen,
                        device=device)
    img = F.interpolate(coarse, size=(h, w), mode="bilinear",
                        align_corners=False)[0] * 255.0
    for (x1, y1, x2, y2), c in zip(boxes.astype(np.int64), classes):
        img[:, y1:y2 + 1, x1:x2 + 1] = palette[int(c)][:, None, None]
    return img.round().clamp(0, 255).to(torch.uint8).permute(1, 2, 0)


def letterbox_into(canvas: torch.Tensor, frame: torch.Tensor, x0: int,
                   y0: int, size: int) -> Tuple[float, int, int]:
    """Resize ``frame`` (h, w, 3) uint8 to fit a ``size``² square at (x0,
    y0) of ``canvas`` (S, S, 3), centred, aspect kept (bilinear); returns
    (scale, pad_x, pad_y) within the square."""
    h, w = frame.shape[:2]
    s = min(size / h, size / w)
    nh, nw = int(round(h * s)), int(round(w * s))
    x = frame.permute(2, 0, 1)[None].float()
    if (nh, nw) != (h, w):
        x = F.interpolate(x, size=(nh, nw), mode="bilinear",
                          align_corners=False)
    px, py = (size - nw) // 2, (size - nh) // 2
    canvas[y0 + py:y0 + py + nh, x0 + px:x0 + px + nw] = \
        x[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8)
    return s, px, py


def eval_ring(mix: Dict, cfg: Dict, seed: int, batch: int, device,
              pin: bool) -> List[Dict]:
    """``mix["ring"]`` batches of letterboxed frames, each a dict of the
    Evaluator's layout without ``img_id`` (given when the batch is handed
    out): ``image`` (B, S, S, 3) uint8 on the host (pinned where ``pin``),
    ``scale``, ``pad_x``, ``pad_y``, ``orig_hw``."""
    size, nc = cfg["img_size"], cfg["num_classes"]
    rng = _rng(seed, 1)
    gen = torch_gen(seed, 1, device)
    palette = torch.randint(0, 256, (nc, 3), generator=gen,
                            device=device).float()
    ring = []
    for _ in range(mix["ring"]):
        imgs = torch.full((batch, size, size, 3), mix["pad_value"],
                          dtype=torch.uint8, device=device)
        meta = {"scale": [], "pad_x": [], "pad_y": [], "orig_hw": []}
        for i in range(batch):
            h, w, boxes, cls = frame_spec(rng, mix, nc)
            frame = render(h, w, boxes, cls, palette, gen, device)
            s, px, py = letterbox_into(imgs[i], frame, 0, 0, size)
            meta["scale"].append(s)
            meta["pad_x"].append(float(px))
            meta["pad_y"].append(float(py))
            meta["orig_hw"].append((h, w))
        host = imgs.cpu()
        ring.append(dict(meta, image=host.pin_memory() if pin else host))
    return ring


def train_ring(mix: Dict, cfg: Dict, seed: int, batch: int, device
               ) -> List[Dict]:
    """``mix["ring"]`` training batches on ``device``: ``image`` (B, S, S,
    3) uint8, ``gt_xyxy`` (B, M, 4) float32 pixels, ``gt_cls`` (B, M)
    int64 and ``gt_mask`` (B, M) bool, M = ``max_boxes``; a share
    ``mosaic_p`` of the images are 2x2 mosaics of four frames."""
    size, nc = cfg["img_size"], cfg["num_classes"]
    m_max = cfg["train"]["max_boxes"]
    rng = _rng(seed, 2)
    gen = torch_gen(seed, 2, device)
    palette = torch.randint(0, 256, (nc, 3), generator=gen,
                            device=device).float()
    ring = []
    for _ in range(mix["ring"]):
        imgs = torch.full((batch, size, size, 3), mix["pad_value"],
                          dtype=torch.uint8, device=device)
        gts = np.zeros((batch, m_max, 4), np.float32)
        gcls = np.zeros((batch, m_max), np.int64)
        gmask = np.zeros((batch, m_max), bool)
        for i in range(batch):
            mosaic = rng.uniform() < mix["mosaic_p"]
            tiles = ([(0, 0), (size // 2, 0), (0, size // 2),
                      (size // 2, size // 2)] if mosaic else [(0, 0)])
            tile = size // 2 if mosaic else size
            all_b, all_c = [], []
            for x0, y0 in tiles:
                h, w, boxes, cls = frame_spec(rng, mix, nc)
                frame = render(h, w, boxes, cls, palette, gen, device)
                s, px, py = letterbox_into(imgs[i], frame, x0, y0, tile)
                b = boxes * s + np.asarray([x0 + px, y0 + py] * 2, np.float32)
                all_b.append(b)
                all_c.append(cls)
            b = np.concatenate(all_b)
            c = np.concatenate(all_c)
            keep = ((b[:, 2] - b[:, 0]) >= mix["min_box_px"]) & \
                ((b[:, 3] - b[:, 1]) >= mix["min_box_px"])
            b, c = b[keep][:m_max], c[keep][:m_max]
            gts[i, :len(b)] = b
            gcls[i, :len(b)] = c
            gmask[i, :len(b)] = True
        ring.append({"image": imgs,
                     "gt_xyxy": torch.from_numpy(gts).to(device),
                     "gt_cls": torch.from_numpy(gcls).to(device),
                     "gt_mask": torch.from_numpy(gmask).to(device)})
    return ring


def xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    return torch.cat([(b[..., :2] + b[..., 2:]) / 2, b[..., 2:] - b[..., :2]],
                     -1)
