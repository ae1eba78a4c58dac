"""Letterbox (aspect-preserving resize and pad) forward and inverse
transforms on the device; counterpart of heltondetection_tpu/ops/letterbox.py.

* :func:`letterbox_params`: the geometry alone, scale and pad from (src_h,
  src_w, dst), which the host pipeline's resize and the coordinate maps
  share, so the inverse applied to dets is exactly the forward's.
* :func:`letterbox_image`: the letterbox of one HWC image as torch ops on
  its device (resize, then pad). The reference's ``jax.image.resize``
  bilinear filter widens with the scale when it shrinks an image
  (antialiasing); ``F.interpolate(..., antialias=True)`` does the same.
  When it enlarges one the triangle filter is the plain bilinear
  (half-pixel centres), so an enlargement takes ``antialias=False``:
  CUDA's antialiased kernel sums its taps otherwise than the CPU's, and
  the plain one agrees with the CPU.

No path of the package calls it, as in the reference: the serving paths
letterbox frames on the host (``data/letterbox.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F


class LetterboxParams(NamedTuple):
    scale: torch.Tensor   # float32: the resize ratio applied to the source
    pad_x: torch.Tensor   # float32: left pad in destination pixels
    pad_y: torch.Tensor   # float32: top pad in destination pixels
    new_w: torch.Tensor   # int32: resized (pre-pad) width
    new_h: torch.Tensor   # int32: resized (pre-pad) height


def letterbox_params(src_h, src_w, dst_h: int, dst_w: int, *,
                     center: bool = True) -> LetterboxParams:
    """Scale and pad mapping src → dst with the aspect kept (the YOLOv5
    convention): ``scale = min(dst/src)``, the resized size rounded, the
    padding split evenly when ``center``. Python numbers or tensors, all
    in float32 as the reference computes them."""
    src_h = torch.as_tensor(src_h, dtype=torch.float32)
    src_w = torch.as_tensor(src_w, dtype=torch.float32)
    # tensor / tensor: torch computes ``number / tensor`` as a reciprocal
    # times the number, which rounds otherwise
    scale = torch.minimum(torch.full_like(src_h, dst_h) / src_h,
                          torch.full_like(src_w, dst_w) / src_w)
    new_w = torch.round(src_w * scale).to(torch.int32)
    new_h = torch.round(src_h * scale).to(torch.int32)
    pad_x = (dst_w - new_w).to(torch.float32)
    pad_y = (dst_h - new_h).to(torch.float32)
    if center:
        pad_x, pad_y = pad_x * 0.5, pad_y * 0.5
    else:
        pad_x, pad_y = torch.zeros_like(pad_x), torch.zeros_like(pad_y)
    return LetterboxParams(scale, pad_x, pad_y, new_w, new_h)


def _offsets(p: LetterboxParams) -> torch.Tensor:
    return torch.stack([p.pad_x, p.pad_y, p.pad_x, p.pad_y], dim=-1)


def apply_to_boxes(boxes_xyxy: torch.Tensor, p: LetterboxParams
                   ) -> torch.Tensor:
    """Source-image xyxy boxes → letterboxed coordinates."""
    sx = torch.stack([p.scale] * 4, dim=-1)
    return boxes_xyxy * sx.to(boxes_xyxy.device) + \
        _offsets(p).to(boxes_xyxy.device)


def invert_boxes(boxes_xyxy: torch.Tensor, p: LetterboxParams,
                 src_h=None, src_w=None) -> torch.Tensor:
    """Letterboxed xyxy boxes → source-image coordinates, clipped to the
    source's bounds when they are given."""
    dev = boxes_xyxy.device
    out = (boxes_xyxy - _offsets(p).to(dev)) / p.scale.to(dev)
    if src_h is not None:
        x1, y1, x2, y2 = out.unbind(-1)
        out = torch.stack([x1.clamp(0.0, float(src_w)),
                           y1.clamp(0.0, float(src_h)),
                           x2.clamp(0.0, float(src_w)),
                           y2.clamp(0.0, float(src_h))], dim=-1)
    return out


def letterbox_image(img: torch.Tensor, dst_h: int, dst_w: int,
                    pad_value: float = 114.0
                    ) -> Tuple[torch.Tensor, LetterboxParams]:
    """Letterbox of one (H, W, C) image on its device: a bilinear resize
    (antialiased only when it shrinks, as ``jax.image.resize``) computed in
    float32, cast back to the image's dtype, centred on a ``pad_value``
    canvas of (dst_h, dst_w, C)."""
    h, w, c = img.shape
    p = letterbox_params(h, w, dst_h, dst_w)
    r = min(dst_h / h, dst_w / w)
    new_h, new_w = int(round(h * r)), int(round(w * r))
    x = img.permute(2, 0, 1)[None].float()
    resized = F.interpolate(x, size=(new_h, new_w), mode="bilinear",
                            align_corners=False, antialias=r < 1)[0]
    top, left = (dst_h - new_h) // 2, (dst_w - new_w) // 2
    out = torch.full((dst_h, dst_w, c), pad_value, dtype=img.dtype,
                     device=img.device)
    out[top:top + new_h, left:left + new_w] = \
        resized.permute(1, 2, 0).to(img.dtype)
    return out, p
