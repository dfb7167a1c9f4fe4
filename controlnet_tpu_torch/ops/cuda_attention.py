"""Attention forward in the transposed (head_dim, L) layout: the wrapper of
``csrc/attention_fwd.cu`` and its plain PyTorch version.

Counterpart of ``controlnet_tpu/ops/pallas_attention.py``'s forward
(``fused_attention_t`` / ``_attn_kernel_t``).  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.  There is no fallback
from one to the other.

``launches`` counts kernel launches (never plain-version calls).
"""

from __future__ import annotations

import ctypes

import torch

launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Shared memory for one key/value tile.  Small tiles keep many blocks
# resident per SM: on an H100, 16 KB beat 48, 100 and 200 KB at the
# L = 784 shapes (scripts/port_attention_tile_sweep.py; PERF.md).  Tiles
# above 48 KB are allowed (the launcher raises the limit).
KV_TILE_BYTES = 16 * 1024
MAX_HEAD_DIM = 64


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(QK^T/sqrt(d))V over (B, H, L, D), the math of the JAX
    package's ``_xla_attention``: scores and softmax in float32, the
    probabilities cast to the input type before the second product."""
    dh = q.shape[-1]
    scale = 1.0 / (dh ** 0.5)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    probs = torch.softmax(scores * scale, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


def fused_attention_t_plain(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: (B, H, dh, L) in, (B, H, dh, Lq) out."""
    out = reference_attention(qt.transpose(-1, -2), kt.transpose(-1, -2), vt.transpose(-1, -2))
    return out.transpose(-1, -2).contiguous()


def _pow2_dim(dh: int) -> int:
    dp = 4
    while dp < dh:
        dp *= 2
    return dp


def launch_config(dh: int, lq: int, lk: int) -> tuple[int, int]:
    """(kv_tile, threads): keys staged per shared-memory tile (at most
    ``KV_TILE_BYTES``), and threads (= query rows) per block."""
    dp = _pow2_dim(dh)
    kv_tile = max(1, min(lk, KV_TILE_BYTES // (2 * dp * 4)))
    threads = 64 if lq <= 64 else 128
    return kv_tile, threads


def _panel_ok(x: torch.Tensor) -> bool:
    """(B, H, dh, L) whose (H, dh, L) block is contiguous; any batch stride."""
    expected = 1
    for dim in (3, 2, 1):
        if x.shape[dim] != 1 and x.stride(dim) != expected:
            return False
        expected *= x.shape[dim]
    return True


def _check(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor) -> None:
    if not (qt.device == kt.device == vt.device):
        raise ValueError(f"q, k, v on different devices: {qt.device}, {kt.device}, {vt.device}")
    if not (qt.dtype == kt.dtype == vt.dtype):
        raise ValueError(f"q, k, v of different types: {qt.dtype}, {kt.dtype}, {vt.dtype}")
    if qt.dtype not in _DTYPE_CODE:
        raise ValueError(f"attention kernel takes float32 or bfloat16, not {qt.dtype}")
    if qt.dim() != 4 or kt.shape != vt.shape or kt.dim() != 4:
        raise ValueError(f"expected (B, H, dh, L) tensors, got q{tuple(qt.shape)} "
                         f"k{tuple(kt.shape)} v{tuple(vt.shape)}")
    if qt.shape[:3] != kt.shape[:3]:
        raise ValueError(f"q{tuple(qt.shape)} and k{tuple(kt.shape)} differ in (B, H, dh)")
    if not 1 <= qt.shape[2] <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {qt.shape[2]} outside 1..{MAX_HEAD_DIM}")
    for name, x in (("q", qt), ("k", kt), ("v", vt)):
        if not _panel_ok(x):
            raise ValueError(f"{name} must have contiguous (H, dh, L) panels, "
                             f"got strides {x.stride()}")


def _launch(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor) -> torch.Tensor:
    global launches
    from controlnet_tpu_torch.ops import _build

    b, h, dh, lq = qt.shape
    lk = kt.shape[3]
    out = torch.empty((b, h, dh, lq), dtype=qt.dtype, device=qt.device)
    kv_tile, threads = launch_config(dh, lq, lk)
    lib = _build.load()
    with torch.cuda.device(qt.device):
        stream = torch.cuda.current_stream(qt.device).cuda_stream
        err = lib.controlnet_attention_fwd_t(
            qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), out.data_ptr(),
            b, h, dh, lq, lk, qt.stride(0), kt.stride(0), vt.stride(0),
            _DTYPE_CODE[qt.dtype], kv_tile, threads, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err} "
                           f"(q{tuple(qt.shape)} k{tuple(kt.shape)} {qt.dtype})")
    launches += 1
    return out


class _AttentionFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qt, kt, vt):
        return _launch(qt, kt, vt)

    @staticmethod
    def backward(ctx, dout):
        raise NotImplementedError(
            "the attention backward kernel is the training slice's work; "
            "sample under torch.no_grad() or torch.inference_mode()")


def fused_attention_t(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor) -> torch.Tensor:
    """softmax(Q^T K / sqrt(dh)) in the transposed layout: qt (B, H, dh, Lq),
    kt/vt (B, H, dh, Lk) -> (B, H, dh, Lq) in the input type."""
    _check(qt, kt, vt)
    if qt.device.type == "cpu":
        return fused_attention_t_plain(qt, kt, vt)
    if qt.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {qt.device}")
    if torch.is_grad_enabled() and (qt.requires_grad or kt.requires_grad or vt.requires_grad):
        return _AttentionFwd.apply(qt, kt, vt)
    return _launch(qt, kt, vt)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(QK^T/sqrt(d))V over (B, H, L, D) (transposes at the boundary)."""
    out_t = fused_attention_t(q.transpose(-1, -2).contiguous(), k.transpose(-1, -2).contiguous(),
                              v.transpose(-1, -2).contiguous())
    return out_t.transpose(-1, -2)
