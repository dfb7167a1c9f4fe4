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
MAX_HEAD_DIM = 128
HEAD_DIMS = (8, 16, 24, 32, 48, 64, 96, 128)   # the kernel's instantiations
MAX_SHARED_BYTES = 232448             # what one block may use on an H100
MAX_CLUSTER = 16                      # blocks of one cluster (past 8: non-portable)
# constants of csrc/attention_proj.cuh
_THREADS = 128
_SLAB = 32                            # depth of the x and weight slabs
_STAGES = 3                           # slabs in the cp.async ring
_OUT_TILES = 8                        # n-tiles per pass of the output projection


def _padded_head_dim(dh: int) -> int | None:
    """The instantiation a head dim runs in, or None past ``MAX_HEAD_DIM``."""
    return next((dp for dp in HEAD_DIMS if dp >= dh), None)


def proj_tiles(rows: int, dp: int) -> int:
    """``proj_tiles`` of csrc/attention_proj.cuh: n-tiles per pass of the
    q|k|v projection, a multiple of the warps sharing a row block, at most 12
    or ``dp / 8`` where that is more (the q columns lie in one pass)."""
    split = _THREADS // 32 // (rows // 16)
    return min(-(-(3 * dp // 8) // split) * split, max(12, dp // 8))


def _round16(v: int) -> int:
    return (v + 15) // 16 * 16


def _row_pitch(k: int, itemsize: int) -> int:
    """``row_pitch`` of csrc/mma_attention.cuh: k elements plus padding to an
    odd number of 16-byte units."""
    return k + (16 // itemsize) * (1 if (k * itemsize // 16) % 2 == 0 else 2)


def shared_bytes(rows: int, dh: int, d: int, heads: int, head_groups: int, itemsize: int) -> int:
    """Shared memory of one block: a ring of x and weight slabs (the q tile
    reuses the x slabs), its own K|V for two heads and a peer's (the other stage
    buffer is its own K|V of the other head), the head outputs of its group,
    all heads' outputs of its rows where there are head groups, and the
    float32 scratch that merges the warps sharing a row block.  The same
    sum as ``make_layout`` in csrc/attention_proj.cuh (the kernel refuses a
    plan whose sum differs)."""
    dp = _padded_head_dim(dh)
    dk = _round16(dp) if itemsize == 2 else dp
    p_slab = _row_pitch(_SLAB, itemsize)
    p_k, p_v = _row_pitch(dk, itemsize), _row_pitch(dp, itemsize)
    dg = dh * (heads // head_groups)
    # x slabs (the q tile reuses them), weight slabs, own K|V of two heads and
    # one peer's (the other stage buffer is the own K|V of the other head)
    x_slab = max(rows * p_slab, _SLAB * _row_pitch(rows, itemsize))  # row- or channel-major
    split = _THREADS // 32 // (rows // 16)
    w_slab = 8 * max(proj_tiles(rows, dp), _OUT_TILES) * p_slab
    elems = (_STAGES * (x_slab + w_slab) + 3 * rows * (p_k + p_v)
             + rows * _row_pitch(_round16(dg), itemsize))
    if head_groups > 1:
        elems += rows * _row_pitch(_round16(d), itemsize)
    scratch = (_THREADS // 32) * (4 + 4 * (dp // 8)) * 32 * 4 if split > 1 else 0
    return elems * itemsize + scratch


def launch_plan(l: int, c: int, d: int, heads: int,
                dtype: torch.dtype) -> tuple[int, int, int, int] | None:
    """(rows, q_tiles, head_groups, smem_bytes) of kernel d for one layer, or
    None where the kernel has no instantiation for its head dim or the
    cluster cannot hold it.

    rows: query rows per block, 64 past L = 256, 32 past 64, else 16;
    q_tiles = ceil(L / rows) blocks share one batch element's K and V (each
    projects its own rows' keys and values once); head_groups: the largest
    divisor of the heads (and of C into slices of 8 or more channels) that
    keeps the cluster, q_tiles * head_groups blocks, within 16, so that short
    sequences still fill the card; smem_bytes: ``shared_bytes``, at most
    ``MAX_SHARED_BYTES``."""
    if (dtype not in _ITEMSIZE or heads < 1 or d % heads or l < 1
            or _padded_head_dim(d // heads) is None):
        return None
    rows = 64 if l > 256 else (32 if l > 64 else 16)
    q_tiles = -(-l // rows)
    if q_tiles > MAX_CLUSTER:
        return None
    groups = max((g for g in range(1, heads + 1)
                  if heads % g == 0 and c % g == 0 and (c // g) % 8 == 0
                  and q_tiles * g <= MAX_CLUSTER), default=0)
    if not groups:
        return None
    smem = shared_bytes(rows, d // heads, d, heads, groups, _ITEMSIZE[dtype])
    if smem > MAX_SHARED_BYTES:
        return None
    return rows, q_tiles, groups, smem


def fused_proj_supported(l: int, c: int, d: int, heads: int, dtype: torch.dtype) -> bool:
    """The shapes kernel d takes, decided before any launch: float32 or
    bfloat16; a head dimension that is a multiple of 8 (as the JAX layer
    requires) and at most 128 (``MAX_HEAD_DIM``, where kernels a and b stop
    too); a channel count that is a multiple of 8; and a
    launch plan (``launch_plan``): L up to 1,024 (16 blocks of 64 rows in one
    cluster) and a block's shared memory within 227 KB (D up to ~1,600 in
    float32).  A layer outside this rule takes the split path (projection,
    attention kernel, projection)."""
    if dtype not in _DTYPE_CODE or heads < 1 or d % heads or l < 1:
        return False
    dh = d // heads
    if dh % 8 or dh > MAX_HEAD_DIM or c % 8:
        return False
    return launch_plan(l, c, d, heads, dtype) is not None


def max_active_clusters(l: int, c: int, d: int, heads: int, dtype: torch.dtype) -> int:
    """How many of kernel d's clusters, at this layer's launch plan, the
    current CUDA card holds at once (cudaOccupancyMaxActiveClusters): with
    ``launch_plan``'s cluster size, how much of the card one wave fills.
    Needs a CUDA card; a diagnostic, not on any path."""
    from controlnet_tpu_torch.ops import _build

    rows, q_tiles, groups, smem = launch_plan(l, c, d, heads, dtype)
    count = ctypes.c_int(0)
    err = _build.load().controlnet_attention_proj_clusters(
        l, c, d, heads, _DTYPE_CODE[dtype], rows, q_tiles, groups, smem, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cluster occupancy query failed: cudaError {err}")
    return count.value


def phase_profile(x: torch.Tensor, in_w: torch.Tensor, in_b: torch.Tensor,
                  out_w: torch.Tensor, out_b: torch.Tensor, num_heads: int) -> dict:
    """Mean clock cycles per block of one launch of kernel d by phase
    (``PHASES``, as thread 0 of each block sees them), and the block count.
    Needs a CUDA card; a diagnostic, not on any path."""
    counters = torch.zeros(len(PHASES) + 1, dtype=torch.int64, device=x.device)
    with torch.inference_mode():
        _launch(x, in_w, in_b, out_w, out_b, num_heads, counters)
    counts = counters.tolist()
    blocks = max(counts[-1], 1)
    return {**{p: c / blocks for p, c in zip(PHASES, counts)}, "blocks": counts[-1]}


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


PHASES = ("zero", "project", "project_sync", "attend_wait", "attend_math", "attend_put", "merge",
          "gather", "out_project")


def _launch(x: torch.Tensor, in_w: torch.Tensor, in_b: torch.Tensor, out_w: torch.Tensor,
            out_b: torch.Tensor, num_heads: int,
            phase_cycles: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel d.  The output takes x's layout: channel-major (B, C, L) memory
    behind a (B, L, C) view where x is such a view (as the attention layer of a
    block passes it), else contiguous tokens.  ``phase_cycles``: None, or
    len(PHASES) + 1 zeroed int64 counters on x's device that receive the
    blocks' cycles by phase and the count of blocks (``phase_profile``)."""
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
    for name, p in (("in_proj weight", in_w), ("out_proj weight", out_w)):
        if p.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel stages it by cp.async)")
    rows, q_tiles, groups, smem = launch_plan(l, c, d, num_heads, x.dtype)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.controlnet_attention_proj(
            x.data_ptr(), in_w.data_ptr(), in_b.data_ptr(), out_w.data_ptr(), out_b.data_ptr(),
            out.data_ptr(), b, l, c, d, num_heads, *x.stride(), *out.stride(),
            _DTYPE_CODE[x.dtype], rows, q_tiles, groups, smem, _stream(x),
            None if phase_cycles is None else phase_cycles.data_ptr())
    if err != 0:
        raise RuntimeError(f"fused projection + attention kernel launch failed: cudaError {err} "
                           f"(x{tuple(x.shape)} strides {x.stride()}, D {d}, {num_heads} heads, "
                           f"{x.dtype}; plan: {rows} rows per block, {q_tiles} query tiles x "
                           f"{groups} head groups per cluster, {smem} bytes of shared memory)")
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
