"""The int8 convolution product of W8A8 serving; counterpart of the two
``lax.conv_general_dilated(..., preferred_element_type=jnp.int32)`` calls in
heltondetection_tpu/models/common.py (``conv_bn_maybe_quant`` and
``ConvBnAct._int8_flow``), which XLA runs outside any Pallas kernel.

The port computes it as a matrix product on ``torch._int_mm`` (int8 × int8
→ int32; cuBLASLt on CUDA): a 1×1 conv is one GEMM over the NHWC rows of
its input, a k×k conv an NHWC im2col followed by the GEMM, a grouped conv
one GEMM per group. ``_int_mm`` on CUDA wants more than 16 rows and a
reduction and output width that are multiples of 8; the operands are zero
padded to meet that, which leaves every int32 sum exact. No path falls back
to the plain version: a shape the GEMM refuses is an error.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_MIN_ROWS = 17      # _int_mm on CUDA: rows > 16
_ALIGN = 8          # ... and the reduction and output widths multiples of 8


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_gemm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a (M, K) int8 @ w (N, K) int8ᵀ → (M, N) int32`` on ``_int_mm``,
    the operands zero padded to its shape rules (padding adds zero terms
    to no sum)."""
    m, k = a.shape
    n = w.shape[0]
    kp, np_, mp = _round_up(k, _ALIGN), _round_up(n, _ALIGN), max(m, _MIN_ROWS)
    if kp != k or mp != m:
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if kp != k or np_ != n:
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    y = torch._int_mm(a.contiguous(), w.contiguous().t())
    return y[:m, :n]


def _columns(x: torch.Tensor, k: int, stride: int, pad: int) -> torch.Tensor:
    """NHWC int8 ``x`` → its conv columns (B, Ho, Wo, C, k, k), each row in
    the (c, kh, kw) order of an OIHW weight's flattening."""
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad))
    if k == 1:
        return x[:, ::stride, ::stride, :, None, None]
    return x.unfold(1, k, stride).unfold(2, k, stride)


def int8_conv2d(x_q: torch.Tensor, w_q: torch.Tensor, stride: int = 1,
                pad: int = 0, groups: int = 1) -> torch.Tensor:
    """``x_q`` (B, Cin, H, W) int8 (channels-last memory is the fast
    case) conv ``w_q`` (Cout, Cin/groups, k, k) int8, square kernel, zero
    padding → (B, Cout, Ho, Wo) int32 in channels-last memory, exact."""
    b = x_q.shape[0]
    cout, cig, k, _ = w_q.shape
    cols = _columns(x_q.permute(0, 2, 3, 1), k, stride, pad)
    ho, wo = cols.shape[1], cols.shape[2]
    cog = cout // groups
    outs = []
    for g in range(groups):
        a = cols[:, :, :, g * cig:(g + 1) * cig].reshape(b * ho * wo,
                                                           cig * k * k)
        outs.append(int8_gemm(a, w_q[g * cog:(g + 1) * cog].reshape(cog, -1)))
    y = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return y.reshape(b, ho, wo, cout).permute(0, 3, 1, 2)


def int8_conv2d_plain(x_q: torch.Tensor, w_q: torch.Tensor, stride: int = 1,
                      pad: int = 0, groups: int = 1) -> torch.Tensor:
    """The plain version of :func:`int8_conv2d`: ``F.conv2d`` in float64 on
    the int8 values, cast to int32. Exact, since |sum| ≤ k²·Cin·127² is far
    below 2⁵³ (float32 is not: 9·1024·127² > 2²⁴). For tests and checks
    only."""
    y = F.conv2d(x_q.double(), w_q.double(), None, stride, pad, 1, groups)
    return y.to(torch.int32)
