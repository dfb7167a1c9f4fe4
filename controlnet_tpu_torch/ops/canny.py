"""Batched Canny edge detection on the device, as plain PyTorch ops.

Port of ``controlnet_tpu/ops/canny.py`` (``canny_edges``, ``canny_hints``):
Sobel-3x3 gradients with replicate padding (no blur, as ``cv2.Canny``), L1
magnitude, four-sector non-maximum suppression with cv2's tan(22.5) /
tan(67.5) quantisation, a double threshold, and hysteresis by iterated 3x3
max-pooling.  It is not a TPU kernel, so it has no kernel of its own; it
gives the ControlNet trainer its hints on the card without a host round trip.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_SOBEL_Y = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))
_TAN_22_5 = 0.4142135623730951
_TAN_67_5 = 2.414213562373095


def _conv3x3(x: torch.Tensor, kernel) -> torch.Tensor:
    """3x3 cross-correlation of (B, H, W) with replicate padding."""
    w = torch.tensor(kernel, dtype=x.dtype, device=x.device)[None, None]
    xp = F.pad(x[:, None], (1, 1, 1, 1), mode="replicate")
    return F.conv2d(xp, w)[:, 0]


def _shift_pad(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift (B, H, W) by (dy, dx), zero-filling the edges."""
    _, h, w = x.shape
    out = torch.zeros_like(x)
    out[:, max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = \
        x[:, max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)]
    return out


def canny_edges(images: torch.Tensor, low_threshold: int = 100, high_threshold: int = 200,
                hysteresis_iters: int | None = None) -> torch.Tensor:
    """``images``: (B, H, W) grayscale in [0, 255].  Returns float32
    (B, H, W) edge maps in {0, 255}.  ``hysteresis_iters`` defaults to the
    JAX package's image-size-scaled count (each iteration grows strong edges
    by one pixel through weak ones)."""
    if hysteresis_iters is None:
        hysteresis_iters = min(128, max(32, max(images.shape[1], images.shape[2]) // 8))
    x = images.to(torch.float32)
    gx = _conv3x3(x, _SOBEL_X)
    gy = _conv3x3(x, _SOBEL_Y)
    ax, ay = gx.abs(), gy.abs()
    mag = ax + ay  # cv2's default L1 gradient

    horiz = ay <= ax * _TAN_22_5
    vert = ay > ax * _TAN_67_5
    same_sign = (gx * gy) >= 0
    m_l, m_r = _shift_pad(mag, 0, 1), _shift_pad(mag, 0, -1)
    m_u, m_d = _shift_pad(mag, 1, 0), _shift_pad(mag, -1, 0)
    m_ul, m_dr = _shift_pad(mag, 1, 1), _shift_pad(mag, -1, -1)
    m_ur, m_dl = _shift_pad(mag, 1, -1), _shift_pad(mag, -1, 1)
    n1 = torch.where(horiz, m_l, torch.where(vert, m_u, torch.where(same_sign, m_ul, m_ur)))
    n2 = torch.where(horiz, m_r, torch.where(vert, m_d, torch.where(same_sign, m_dr, m_dl)))
    is_max = (mag > n1) & (mag >= n2)

    strong = is_max & (mag > high_threshold)
    weak = is_max & (mag > low_threshold)
    edges = strong
    for _ in range(hysteresis_iters):
        grown = F.max_pool2d(edges.to(torch.float32)[:, None], 3, stride=1, padding=1)[:, 0]
        edges = ((grown > 0) & weak) | edges
    return edges.to(torch.float32) * 255.0


def canny_hints(images_01: torch.Tensor, low: int = 100, high: int = 200) -> torch.Tensor:
    """The reference hint pipeline: (B, H, W, C) images in [0, 1] (RGB is
    converted with cv2's luma weights) -> canny -> exact {0, 1} float32,
    replicated to (B, H, W, 3)."""
    if images_01.shape[-1] == 3:
        w = torch.tensor([0.299, 0.587, 0.114], dtype=images_01.dtype, device=images_01.device)
        gray = torch.einsum("bhwc,c->bhw", images_01, w)
    else:
        gray = images_01[..., 0]
    edges = canny_edges(torch.round(gray * 255.0), low, high)
    hint = (edges > 0).to(torch.float32)
    return hint[..., None].expand(*hint.shape, 3).contiguous()
