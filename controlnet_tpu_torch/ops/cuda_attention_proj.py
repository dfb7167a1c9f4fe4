"""The whole self-attention layer as one kernel: the wrapper of
``csrc/attention_proj.cu`` (kernel d) and its plain PyTorch version.

Counterpart of ``controlnet_tpu/ops/pallas_attention.py``'s
``fused_attention_proj`` (``_attn_proj_kernel``): packed q|k|v projection,
per-head softmax attention and output projection of (B, L, C) tokens in one
launch, so that neither the (B, 3D, L) projection nor the (B, D, L) attention
output reaches device memory.  Forward only, as on the JAX side: the sampling
and serving paths call it under ``torch.inference_mode()``.

The parameters are taken as ``nn.MultiheadAttention`` lays them out:
``in_proj_weight`` (3D, C), ``in_proj_bias`` (3D,), ``out_proj.weight`` (C, D),
``out_proj.bias`` (C,); the JAX side's (C, 3D) and (D, C) are their transposes.

A CPU tensor takes the plain version; a CUDA tensor inside
``fused_proj_supported`` launches the kernel or raises.  There is no fallback
from one to the other.  ``launches`` counts kernel launches (never plain
calls).
"""

from __future__ import annotations

import ctypes

import torch

launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
MAX_HEAD_DIM = 64
HEAD_DIMS = (8, 16, 24, 32, 48, 64)   # the kernel's instantiations
MAX_SHARED_BYTES = 232448             # what one block may use on an H100
_SLAB_FLOATS = 2 * 16 * 132           # the two operand slabs of csrc/attention_proj.cu


def _padded_head_dim(dh: int) -> int:
    return next(dp for dp in HEAD_DIMS if dp >= dh)


def shared_bytes(rows: int, dh: int, d: int, itemsize: int) -> int:
    """Shared memory of one block at tile height ``rows``: the operand slabs,
    the query tile, the K and V tiles (float32) and the rows x D output tile
    in the input type.  The same sum as ``smem_bytes`` in the CUDA source."""
    dp = _padded_head_dim(dh)
    q_tile = (rows * (dp + 1) + 3) & ~3
    out_pitch = d + (1 if itemsize == 4 else 2)
    return 4 * (_SLAB_FLOATS + q_tile + 2 * rows * dp) + itemsize * rows * out_pitch


def tile_rows(l: int, d: int, heads: int, dtype: torch.dtype) -> int | None:
    """Query / key rows per block: the largest of 128, 64, 32 that the
    sequence fills past half and whose shared memory fits; None if none fits."""
    dh = d // heads
    for rows in (128, 64, 32):
        if rows > 32 and l <= rows // 2:
            continue
        if shared_bytes(rows, dh, d, _ITEMSIZE[dtype]) <= MAX_SHARED_BYTES:
            return rows
    return None


def fused_proj_supported(l: int, c: int, d: int, heads: int, dtype: torch.dtype) -> bool:
    """The shapes kernel d takes, decided before any launch: float32 or
    bfloat16; a head dimension that is a multiple of 8 (as the JAX layer
    requires) and at most 64; a channel count that is a multiple of 8; and a
    model width whose 32-row output tile fits a block's shared memory
    (D up to ~1,600 in float32).  A layer outside this rule takes the split
    path (projection, attention kernel, projection)."""
    if dtype not in _DTYPE_CODE or heads < 1 or d % heads or l < 1:
        return False
    dh = d // heads
    if dh % 8 or dh > MAX_HEAD_DIM or c % 8:
        return False
    return tile_rows(l, d, heads, dtype) is not None


def fused_attention_proj_plain(x: torch.Tensor, in_w: torch.Tensor, in_b: torch.Tensor,
                               out_w: torch.Tensor, out_b: torch.Tensor,
                               num_heads: int) -> torch.Tensor:
    """Plain version of the kernel, with its roundings: q|k|v summed in
    float32 and rounded to the input type once; scores and exp in float32;
    the unnormalised exp contracted with V and divided by its row sum (the
    probabilities are never rounded), each head's output rounded to the input
    type; the output projection summed in float32 over input-type weights and
    bias, rounded once.  x (B, L, C) -> (B, L, C)."""
    dt = x.dtype
    b, l, _ = x.shape
    d = out_w.shape[1]
    dh = d // num_heads
    in_w, in_b, out_w, out_b = (p.to(dt).float() for p in (in_w, in_b, out_w, out_b))
    qkv = (torch.matmul(x.float(), in_w.t()) + in_b).to(dt).float()
    q, k, v = (t.reshape(b, l, num_heads, dh).transpose(1, 2) for t in qkv.split(d, dim=-1))
    scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / dh ** 0.5)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    out = (torch.matmul(e, v) / e.sum(dim=-1, keepdim=True)).to(dt).float()
    out = out.transpose(1, 2).reshape(b, l, d)
    return (torch.matmul(out, out_w.t()) + out_b).to(dt)


def _check(x, in_w, in_b, out_w, out_b, num_heads: int) -> None:
    params = (in_w, in_b, out_w, out_b)
    if any(p.device != x.device for p in params):
        raise ValueError(f"x and the parameters are on different devices: {x.device}, "
                         f"{[str(p.device) for p in params]}")
    if any(p.dtype != x.dtype for p in params):
        raise ValueError(f"x and the parameters differ in type: {x.dtype}, "
                         f"{[p.dtype for p in params]}")
    if x.dim() != 3:
        raise ValueError(f"expected (B, L, C) tokens, got {tuple(x.shape)}")
    c = x.shape[2]
    if out_w.dim() != 2 or out_w.shape[0] != c:
        raise ValueError(f"out_proj weight {tuple(out_w.shape)} does not map to C = {c}")
    d = out_w.shape[1]
    if (in_w.shape != (3 * d, c) or in_b.shape != (3 * d,) or out_b.shape != (c,)
            or num_heads < 1 or d % num_heads):
        raise ValueError(f"parameters do not fit x{tuple(x.shape)} with {num_heads} heads: "
                         f"in_w{tuple(in_w.shape)} in_b{tuple(in_b.shape)} "
                         f"out_w{tuple(out_w.shape)} out_b{tuple(out_b.shape)}")


def _stream(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _launch(x: torch.Tensor, in_w: torch.Tensor, in_b: torch.Tensor, out_w: torch.Tensor,
            out_b: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Kernel d.  The output takes x's layout: channel-major (B, C, L) memory
    behind a (B, L, C) view where x is such a view (as the attention layer of a
    block passes it), else contiguous tokens."""
    global launches
    from controlnet_tpu_torch.ops import _build

    b, l, c = x.shape
    d = out_w.shape[1]
    if not fused_proj_supported(l, c, d, num_heads, x.dtype):
        raise ValueError(f"the fused projection + attention kernel does not take L {l}, C {c}, "
                         f"D {d}, {num_heads} heads, {x.dtype} (see fused_proj_supported)")
    for name, p in (("in_proj weight", in_w), ("in_proj bias", in_b),
                    ("out_proj weight", out_w), ("out_proj bias", out_b)):
        if not p.is_contiguous():
            raise ValueError(f"{name} must be contiguous, got strides {p.stride()}")
    if x.stride(2) == 1:
        out = torch.empty((b, l, c), dtype=x.dtype, device=x.device)
    elif x.stride(1) == 1 or l == 1:
        out = torch.empty((b, c, l), dtype=x.dtype, device=x.device).transpose(1, 2)
    else:
        raise ValueError("x must be (B, L, C) tokens with contiguous rows, or the transposed "
                         f"view of a (B, C, L) tensor; got strides {x.stride()}")
    rows = tile_rows(l, d, num_heads, x.dtype)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.controlnet_attention_proj(
            x.data_ptr(), in_w.data_ptr(), in_b.data_ptr(), out_w.data_ptr(), out_b.data_ptr(),
            out.data_ptr(), b, l, c, d, num_heads, *x.stride(), *out.stride(),
            _DTYPE_CODE[x.dtype], rows, _stream(x))
    if err != 0:
        raise RuntimeError(f"fused projection + attention kernel launch failed: cudaError {err} "
                           f"(x{tuple(x.shape)} strides {x.stride()}, D {d}, {num_heads} heads, "
                           f"{x.dtype}, {rows} rows per block)")
    launches += 1
    return out


def fused_attention_proj(x: torch.Tensor, in_w: torch.Tensor, in_b: torch.Tensor,
                         out_w: torch.Tensor, out_b: torch.Tensor,
                         num_heads: int) -> torch.Tensor:
    """Self-attention with both projections fused: x (B, L, C) normed tokens
    -> (B, L, C) attention output (the caller adds the residual), all tensors
    of one type (float32 or bfloat16).  Forward only: it raises where a
    gradient would be needed."""
    _check(x, in_w, in_b, out_w, out_b, num_heads)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, in_w, in_b, out_w, out_b)):
        raise RuntimeError("fused_attention_proj is forward-only (it has no gradient): call it "
                           "under torch.inference_mode() or torch.no_grad(), or switch "
                           "fused_proj off for training")
    if x.device.type == "cpu":
        return fused_attention_proj_plain(x, in_w, in_b, out_w, out_b, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"no fused projection + attention kernel for device {x.device}")
    return _launch(x, in_w, in_b, out_w, out_b, num_heads)
