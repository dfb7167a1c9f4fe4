"""Attention in the transposed (head_dim, L) layout and its gradient: the
wrappers of ``csrc/attention_fwd.cu`` (kernel a: float32 on the CUDA cores,
bfloat16 on the tensor cores in ``csrc/attention_fwd_bf16.cu``) and
``csrc/attention_bwd.cu`` (kernel b: float32 on the CUDA cores, bfloat16 on
the tensor cores in ``csrc/attention_bwd_bf16.cu``), and their plain PyTorch
versions.

Counterpart of ``controlnet_tpu/ops/pallas_attention.py``'s
``fused_attention_t`` with its custom VJP (``_attn_kernel_t`` forward,
``_attn_bwd_kernel_t`` backward).  A CPU tensor takes the plain versions; a
CUDA tensor launches the kernels or raises.  There is no fallback from one to
the other.

``launches`` counts launches of kernel a and ``bwd_launches`` of kernel b
(never plain-version calls).
"""

from __future__ import annotations

import ctypes

import torch

launches = 0
bwd_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Shared memory for one key/value tile.  Small tiles keep many blocks
# resident per SM: on an H100, 16 KB beat 48, 100 and 200 KB at the
# L = 784 shapes (scripts/port_attention_tile_sweep.py; PERF.md).  Tiles
# above 48 KB are allowed (the launcher raises the limit).
KV_TILE_BYTES = 16 * 1024
MAX_HEAD_DIM = 64
# The bf16 kernels (tensor cores): keys per shared-memory tile of the
# forward (csrc/attention_fwd_bf16.cu), double-buffered.
MMA_KV_TILE = 64


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
    """Plain version of the kernel, written as ``_attn_kernel_t`` computes it:
    scores, softmax and the product with V in float32 (V upcast, P never
    rounded), one rounding to the input type.  (B, H, dh, L) in,
    (B, H, dh, Lq) out."""
    scale = 1.0 / (qt.shape[2] ** 0.5)
    probs = torch.softmax(torch.einsum("bhdq,bhdk->bhqk", qt.float(), kt.float()) * scale, dim=-1)
    return torch.einsum("bhdk,bhqk->bhdq", vt.float(), probs).to(qt.dtype).contiguous()


def _pow2_dim(dh: int) -> int:
    dp = 4
    while dp < dh:
        dp *= 2
    return dp


def launch_config(dh: int, lq: int, lk: int) -> tuple[int, int]:
    """(kv_tile, threads) of the float32 kernel: keys staged per
    shared-memory tile (at most ``KV_TILE_BYTES``), and threads (= query
    rows) per block."""
    dp = _pow2_dim(dh)
    kv_tile = max(1, min(lk, KV_TILE_BYTES // (2 * dp * 4)))
    threads = 64 if lq <= 64 else 128
    return kv_tile, threads


def mma_launch_config(dh: int, lq: int) -> tuple[int, int, int]:
    """(padded head dim, warps, shared bytes) of the bf16 kernel: dh padded
    with zeros to a multiple of 16 (the mma's depth); one warp per 16 query
    rows, up to 4 a block (fewer where Lq is short); the (dh, rows) query tile
    and two (dh, 64) K and V tiles in bf16, rows padded as ``row_pitch`` in
    csrc/mma_attention.cuh pads them."""
    dp = (dh + 15) // 16 * 16
    warps = min(4, -(-lq // 16))

    def pitch(k: int) -> int:  # k bf16 values plus padding to an odd count of 16 bytes
        return k + 8 * (1 if (k // 8) % 2 == 0 else 2)

    return dp, warps, 2 * dp * (pitch(16 * warps) + 4 * pitch(MMA_KV_TILE))


def mma_bwd_tile(dh: int) -> int:
    """Keys (dq pass) and queries (dkv pass) per shared-memory tile of the
    bf16 backward (csrc/attention_bwd_bf16.cu, ``tile_for``): 64 where dh
    padded to a multiple of 16 is at most 32, else 32."""
    return 64 if (dh + 15) // 16 * 16 <= 32 else 32


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


def bwd_launch_config(dh: int, lq: int, lk: int) -> tuple[int, int, int, int]:
    """(kv_tile, q_tile, threads_q, threads_k) of the backward kernel: keys
    staged per tile by its dq pass and queries (with their lse and D) by its
    dkv pass, each tile at most ``KV_TILE_BYTES``; threads per block of each
    pass (64 for a short axis, else 128)."""
    dp = _pow2_dim(dh)
    kv_tile = max(1, min(lk, KV_TILE_BYTES // (2 * dp * 4)))
    q_tile = max(1, min(lq, KV_TILE_BYTES // ((2 * dp + 2) * 4)))
    return kv_tile, q_tile, 64 if lq <= 64 else 128, 64 if lk <= 64 else 128


def fused_attention_t_bwd_plain(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                                dout: torch.Tensor):
    """Plain version of the backward kernel, written as ``_attn_bwd_kernel_t``
    computes it: recompute P in float32, then dV = dO P, dP = dO^T V,
    dS = P o (dP - rowsum(dP o P)), dQ = scale K dS^T, dK = scale Q dS.
    (B, H, dh, L) in; (dq, dk, dv) in the input type."""
    scale = 1.0 / (qt.shape[2] ** 0.5)
    q, k, v, do = (x.float() for x in (qt, kt, vt, dout))
    probs = torch.softmax(torch.einsum("bhdq,bhdk->bhqk", q, k) * scale, dim=-1)
    dv = torch.einsum("bhdq,bhqk->bhdk", do, probs)
    dp = torch.einsum("bhdq,bhdk->bhqk", do, v)
    ds = probs * (dp - (dp * probs).sum(-1, keepdim=True))
    dq = scale * torch.einsum("bhdk,bhqk->bhdq", k, ds)
    dk = scale * torch.einsum("bhdq,bhqk->bhdk", q, ds)
    return tuple(x.to(qt.dtype) for x in (dq, dk, dv))


def _stream(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _launch(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
            lse: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel a; with ``lse`` (float32 (B, H, Lq)) it also writes each query
    row's log-sum-exp, which the backward kernel reads."""
    global launches
    from controlnet_tpu_torch.ops import _build

    b, h, dh, lq = qt.shape
    lk = kt.shape[3]
    out = torch.empty((b, h, dh, lq), dtype=qt.dtype, device=qt.device)
    if qt.dtype == torch.bfloat16:
        kv_tile, threads = MMA_KV_TILE, 32 * mma_launch_config(dh, lq)[1]
    else:
        kv_tile, threads = launch_config(dh, lq, lk)
    lib = _build.load()
    with torch.cuda.device(qt.device):
        err = lib.controlnet_attention_fwd_t(
            qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, h, dh, lq, lk, qt.stride(0), kt.stride(0), vt.stride(0),
            _DTYPE_CODE[qt.dtype], kv_tile, threads, _stream(qt))
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err} "
                           f"(q{tuple(qt.shape)} k{tuple(kt.shape)} {qt.dtype})")
    launches += 1
    return out


def _launch_bwd(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor, out: torch.Tensor,
                lse: torch.Tensor, dout: torch.Tensor, delta: torch.Tensor | None = None):
    """Kernel b: (dq, dk, dv), contiguous, in the input type.  ``delta``, a
    float32 (B, H, Lq) tensor, receives each query row's D (a scratch is
    made when it is None)."""
    global bwd_launches
    from controlnet_tpu_torch.ops import _build

    if dout.shape != out.shape or dout.dtype != out.dtype or dout.device != out.device:
        raise ValueError(f"attention gradient {tuple(dout.shape)} {dout.dtype} does not "
                         f"match the output {tuple(out.shape)} {out.dtype}")
    dout = dout.contiguous()
    b, h, dh, lq = qt.shape
    lk = kt.shape[3]
    dq = torch.empty((b, h, dh, lq), dtype=qt.dtype, device=qt.device)
    dk = torch.empty((b, h, dh, lk), dtype=qt.dtype, device=qt.device)
    dv = torch.empty_like(dk)
    if delta is None:
        delta = torch.empty((b, h, lq), dtype=torch.float32, device=qt.device)
    elif (delta.shape != (b, h, lq) or delta.dtype != torch.float32
          or delta.device != qt.device or not delta.is_contiguous()):
        raise ValueError(f"delta must be a contiguous float32 {(b, h, lq)} tensor on {qt.device}")
    if qt.dtype == torch.bfloat16:
        kv_tile = q_tile = mma_bwd_tile(dh)
        threads_q, threads_k = (32 * mma_launch_config(dh, n)[1] for n in (lq, lk))
    else:
        kv_tile, q_tile, threads_q, threads_k = bwd_launch_config(dh, lq, lk)
    lib = _build.load()
    with torch.cuda.device(qt.device):
        err = lib.controlnet_attention_bwd_t(
            qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, dh, lq, lk, qt.stride(0), kt.stride(0), vt.stride(0),
            _DTYPE_CODE[qt.dtype], kv_tile, q_tile, threads_q, threads_k, _stream(qt))
    if err != 0:
        raise RuntimeError(f"attention backward kernel launch failed: cudaError {err} "
                           f"(q{tuple(qt.shape)} k{tuple(kt.shape)} {qt.dtype})")
    bwd_launches += 1
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """The attention with its gradient.  On CUDA tensors the forward is kernel
    a (saving the row log-sum-exp) and the backward kernel b; on CPU tensors
    both are the plain versions."""

    @staticmethod
    def forward(ctx, qt, kt, vt):
        if qt.device.type == "cpu":
            ctx.save_for_backward(qt, kt, vt)
            return fused_attention_t_plain(qt, kt, vt)
        b, h, _, lq = qt.shape
        lse = torch.empty((b, h, lq), dtype=torch.float32, device=qt.device)
        out = _launch(qt, kt, vt, lse)
        ctx.save_for_backward(qt, kt, vt, out, lse)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        if dout.device.type == "cpu":
            return fused_attention_t_bwd_plain(*ctx.saved_tensors, dout)
        return _launch_bwd(*ctx.saved_tensors, dout)


def fused_attention_t(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor) -> torch.Tensor:
    """softmax(Q^T K / sqrt(dh)) in the transposed layout: qt (B, H, dh, Lq),
    kt/vt (B, H, dh, Lk) -> (B, H, dh, Lq) in the input type.  Differentiable:
    where a gradient is needed the call goes through ``_Attention``."""
    _check(qt, kt, vt)
    if qt.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention kernel for device {qt.device}")
    if torch.is_grad_enabled() and (qt.requires_grad or kt.requires_grad or vt.requires_grad):
        return _Attention.apply(qt, kt, vt)
    if qt.device.type == "cpu":
        return fused_attention_t_plain(qt, kt, vt)
    return _launch(qt, kt, vt)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(QK^T/sqrt(d))V over (B, H, L, D) (transposes at the boundary)."""
    out_t = fused_attention_t(q.transpose(-1, -2).contiguous(), k.transpose(-1, -2).contiguous(),
                              v.transpose(-1, -2).contiguous())
    return out_t.transpose(-1, -2)
