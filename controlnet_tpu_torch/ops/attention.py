"""Multi-head attention over post-projection tokens.

Port of ``controlnet_tpu/ops/attention.py``.  Every call goes through
``cuda_attention.fused_attention_t``: the hand-written kernel for CUDA
tensors, its plain version for CPU tensors.  Unlike the JAX module there
is no try/except dispatch and no quiet fallback.
"""

from __future__ import annotations

import torch

from controlnet_tpu_torch.ops import cuda_attention
from controlnet_tpu_torch.ops.cuda_attention import reference_attention

__all__ = ["multi_head_attention", "multi_head_attention_t", "reference_attention"]


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int) -> torch.Tensor:
    """Multi-head attention over (B, L, D) tokens (post-projection)."""
    qh, kh, vh = (_split_heads(x, num_heads) for x in (q, k, v))
    return _merge_heads(cuda_attention.fused_attention(qh, kh, vh))


def multi_head_attention_t(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    """Attention over TRANSPOSED tokens: qt/kt/vt are (B, D, L), the layout
    the kernel reads.  Each may be a slice of one packed (B, 3D, L)
    projection; no copy is made.  Returns (B, D, Lq)."""
    b, dm, lq = qt.shape
    lk = kt.shape[2]
    dh = dm // num_heads
    out_t = cuda_attention.fused_attention_t(
        qt.reshape(b, num_heads, dh, lq), kt.reshape(b, num_heads, dh, lk),
        vt.reshape(b, num_heads, dh, lk))
    return out_t.reshape(b, dm, lq)
