"""Attention in the transposed (head_dim, L) layout and its gradient: the
wrappers of ``csrc/attention_fwd.cu`` (kernel a: float32 on the CUDA cores,
bfloat16 on Hopper's warpgroup tensor cores in ``csrc/attention_fwd_bf16.cu``)
and ``csrc/attention_bwd.cu`` (kernel b: float32 on the CUDA cores, bfloat16
on the warpgroup tensor cores in ``csrc/attention_bwd_bf16.cu``), and their
plain PyTorch versions.

Counterpart of ``controlnet_tpu/ops/pallas_attention.py``'s
``fused_attention_t`` with its custom VJP (``_attn_kernel_t`` forward,
``_attn_bwd_kernel_t`` backward).  A CPU tensor takes the plain versions; a
CUDA tensor launches the kernels or raises.  There is no fallback from one to
the other.

``launches`` counts launches of kernel a and ``bwd_launches`` of kernel b
(never plain-version calls); ``loader_launches`` counts the bf16 launches by
kernel, panel group and loading route (``ROUTES``).
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple

import torch

launches = 0
bwd_launches = 0
loader_launches: collections.Counter = collections.Counter()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Shared memory for one key/value tile.  Small tiles keep many blocks
# resident per SM: on an H100, 16 KB beat 48, 100 and 200 KB at the
# L = 784 shapes (scripts/port_attention_tile_sweep.py; PERF.md).  Tiles
# above 48 KB are allowed (the launcher raises the limit).
KV_TILE_BYTES = 16 * 1024
# Head dims the kernels take: up to 128 (CIFAR-10's 512-channel levels at 4
# heads); past 64 the float32 kernels split a query row across more threads
# and the bf16 kernels pad it to 96 or 128.
MAX_HEAD_DIM = 128
# The bf16 kernels (wgmma): L values per operand tile, which is also the rows
# a consumer warpgroup owns (64 queries in a, 64 keys in b) and the key (a)
# or query (b) tile of the sweep.
MMA_TILE = 64
SMEM_LIMIT = 232_448  # shared memory a block may use on an H100
SMS = 132
# How the bf16 kernels load a panel group, by the values one copy moves
# (``loader_vec``): TMA, 8-byte cp.async, 4-byte cp.async, element loads; an
# odd L of at most STAGED_MAX_L that the producer streams takes the staged
# route (the panel's span by 4-byte cp.async, laid out in shared memory).
ROUTES = {8: "tma", 4: "cp.async8", 2: "cp.async4", 1: "elements"}
STAGED_MAX_L = 128
# Phases of ``phase_profile`` (a) and ``phase_profile_bwd`` (b's main
# kernel): thread 0's clock64 cycles, csrc/attention_{fwd,bwd}_bf16.cu.
PHASES_A = ("wait", "scores", "softmax", "pv", "epilogue")
PHASES_B = ("wait", "scores", "elementwise", "grads", "dq", "epilogue")


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
    """dh rounded up to a power of two >= 4: the float32 kernels' DP."""
    dp = 4
    while dp < dh:
        dp *= 2
    return dp


def fwd_split(dh: int) -> int:
    """Threads that share one query row in the float32 forward kernel
    (csrc/attention_fwd.cu, SPLIT): 1 up to a padded head dim of 64, 8 at
    128."""
    return 1 if _pow2_dim(dh) <= 64 else 8


def launch_config(dh: int, lq: int, lk: int) -> tuple[int, int]:
    """(kv_tile, threads) of the float32 kernel: keys staged per
    shared-memory tile (at most ``KV_TILE_BYTES``), and threads per block
    (``fwd_split(dh)`` threads per query row)."""
    dp = _pow2_dim(dh)
    kv_tile = max(1, min(lk, KV_TILE_BYTES // (2 * dp * 4)))
    # a short query axis takes 64-thread blocks, unless a row is split:
    # then 128, so that fewer blocks stage the same K and V tiles
    threads = 64 if lq <= 64 and fwd_split(dh) == 1 else 128
    return kv_tile, threads


def mma_head_dim(dh: int) -> int:
    """dh padded with zeros for the bf16 kernels: a multiple of 16 (wgmma's
    depth) up to 64, then 96 or 128 (their instantiations)."""
    return (dh + 15) // 16 * 16 if dh <= 64 else (96 if dh <= 96 else 128)


class MmaPlan(NamedTuple):
    """The bf16 kernels' launch at one shape (csrc/attention_{fwd,bwd}_bf16.cu)."""
    dp: int            # padded head dim
    warpgroups: int    # consumer warpgroups of a's blocks (b's have one)
    fwd_stages: int    # ring stages of a's streamed key tiles, of b's query tiles
    bwd_stages: int
    q_tiles: int       # 64-query tiles
    k_tiles: int       # 64-key tiles
    split: int         # b's blocks a key tile along the query axis
    fwd_smem: int      # shared bytes of a block of a, of b
    bwd_smem: int
    bwd_scratch: int   # float32 values of b's scratch: dQ accumulator, partials


def mma_plan(dh: int, lq: int, lk: int, bh: int) -> MmaPlan:
    """Kernel a's and kernel b's bf16 launch for B*H = ``bh`` slices: a, one
    consumer warpgroup a block where Lq <= 64, else two; b, one a block of
    64 keys, with the query axis split where the slices' key tiles fill less
    than two waves of the card's SMs, into as many shares as that takes (each
    share at least one query tile, none empty); rings of 3 stages (2 at DP
    96 and 128, where a tile is 12 or 16 KB), no more than the tiles they
    stream.  Shared bytes as the C side counts them: 1024 of alignment slack,
    128 bytes a padded head dim a tile, 8 a barrier; b also two 64 x 64 bf16
    dS tiles, a DP x 64 float32 dQ stage and 512 bytes a stage for its lse
    and D; where the streamed panels (a's keys, b's queries) take the staged
    route, its buffer of two spans of two tiles and 16 bytes."""
    dp = mma_head_dim(dh)
    nwg = 1 if lq <= MMA_TILE else 2
    tile = dp * 128
    q_tiles, k_tiles = -(-lq // MMA_TILE), -(-lk // MMA_TILE)
    most = 3 if dp <= 64 else 2
    fwd_stages, bwd_stages = min(most, k_tiles), min(most, q_tiles)
    blocks = bh * k_tiles
    split = 1 if blocks >= 2 * SMS else min(q_tiles, -(-2 * SMS // blocks))
    split = -(-q_tiles // -(-q_tiles // split))  # every share non-empty
    scratch = bh * q_tiles * dp * MMA_TILE + (2 * split * bh * dh * lk if split > 1 else 0)

    def stage(length: int) -> int:  # the staged route's buffer: two spans
        return 2 * (2 * tile + 16) if length % 2 and length <= STAGED_MAX_L else 0

    return MmaPlan(dp, nwg, fwd_stages, bwd_stages, q_tiles, k_tiles, split,
                   1024 + tile * (nwg + 2 * fwd_stages) + 8 * (2 * fwd_stages + 1) + stage(lk),
                   1024 + tile * (2 + 2 * bwd_stages) + 2 * 8192 + dp * 256 + 512 * bwd_stages
                   + 8 * (2 * bwd_stages + 1) + stage(lq), scratch)


def loader_vec(length: int, strides: list[int], ptrs: list[int]) -> int:
    """How the bf16 kernels load a group of (dh, L) panels of length L with
    these batch strides (values) and addresses (bytes): 8 = TMA, whose global
    strides must be multiples of 16 bytes (L and the batch stride multiples
    of 8 values, the panels 16-byte aligned); 4 = 8-byte cp.async (L and the
    strides multiples of 4, 8-byte aligned); 2 = 4-byte cp.async (even, 4-byte
    aligned); 1 = element loads."""
    for vec in (8, 4, 2):
        if all(x % vec == 0 for x in (length, *strides)) and all(p % (2 * vec) == 0
                                                                   for p in ptrs):
            return vec
    return 1


def _bstride(x: torch.Tensor) -> int:
    """The batch stride of (B, H, dh, L) panels, that of a contiguous tensor
    where B is 1 (any stride serves one batch; TMA needs a regular one)."""
    return x.stride(0) if x.shape[0] > 1 else x.shape[1] * x.shape[2] * x.shape[3]


def loader_route(vec: int, length: int, streamed: bool) -> str:
    """The name of the route a panel group takes (``ROUTES``, or "staged")."""
    return "staged" if vec == 1 and streamed and length <= STAGED_MAX_L else ROUTES[vec]


def _loader(kernel: str, group: str, length: int, streamed: bool, *panels: torch.Tensor) -> int:
    vec = loader_vec(length, [_bstride(x) for x in panels], [x.data_ptr() for x in panels])
    loader_launches[f"{kernel}:{group}:{loader_route(vec, length, streamed)}"] += 1
    return vec


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
            lse: torch.Tensor | None = None, out32: torch.Tensor | None = None,
            cycles: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel a; with ``lse`` (float32 (B, H, Lq)) it also writes each query
    row's log-sum-exp, which the backward kernel reads, and in bf16 with
    ``out32`` (float32 (B, H, dh, Lq)) the output before its rounding, from
    which kernel b forms D.  ``cycles``: int64 counters for
    ``phase_profile`` (bf16)."""
    global launches
    from controlnet_tpu_torch.ops import _build

    b, h, dh, lq = qt.shape
    lk = kt.shape[3]
    out = torch.empty((b, h, dh, lq), dtype=qt.dtype, device=qt.device)
    q_vec = k_vec = 0
    if qt.dtype == torch.bfloat16:
        if out32 is not None and (out32.shape != out.shape or out32.dtype != torch.float32
                                  or not out32.is_contiguous()):
            raise ValueError(f"out32 must be a contiguous float32 {tuple(out.shape)} tensor")
        plan = mma_plan(dh, lq, lk, b * h)
        kv_tile, threads = MMA_TILE, 128 * plan.warpgroups + 32
        q_vec = _loader("a", "q", lq, False, qt)
        k_vec = _loader("a", "kv", lk, True, kt, vt)
    else:
        kv_tile, threads = launch_config(dh, lq, lk)
    lib = _build.load()
    with torch.cuda.device(qt.device):
        err = lib.controlnet_attention_fwd_t(
            qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if out32 is None else out32.data_ptr(),
            b, h, dh, lq, lk, _bstride(qt), _bstride(kt), _bstride(vt),
            _DTYPE_CODE[qt.dtype], kv_tile, threads, q_vec, k_vec, _stream(qt),
            None if cycles is None else cycles.data_ptr())
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err} "
                           f"(q{tuple(qt.shape)} k{tuple(kt.shape)} {qt.dtype})")
    launches += 1
    return out


def forward_for_backward(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor):
    """Kernel a as training calls it: (out, saved, lse), with ``saved`` the
    output before its rounding that kernel b takes (float32; in float32 the
    output itself) and ``lse`` the row log-sum-exp."""
    b, h, dh, lq = qt.shape
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=qt.device)
    out32 = None
    if qt.dtype == torch.bfloat16:
        out32 = torch.empty((b, h, dh, lq), dtype=torch.float32, device=qt.device)
    out = _launch(qt, kt, vt, lse, out32)
    return out, (out if out32 is None else out32), lse


def _launch_bwd(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor, out: torch.Tensor,
                lse: torch.Tensor, dout: torch.Tensor, delta: torch.Tensor | None = None,
                cycles: torch.Tensor | None = None):
    """Kernel b: (dq, dk, dv), contiguous, in the input type.  ``out`` is the
    forward's output before its rounding (``forward_for_backward``'s
    ``saved``: float32 in both types).  ``delta``, a float32 (B, H, Lq)
    tensor, receives each query row's D (a scratch is made when it is None).
    ``cycles``: int64 counters for ``phase_profile_bwd`` (bf16)."""
    global bwd_launches
    from controlnet_tpu_torch.ops import _build

    if (dout.shape != out.shape or dout.dtype != qt.dtype or out.dtype != torch.float32
            or dout.device != out.device):
        raise ValueError(f"attention gradient {tuple(dout.shape)} {dout.dtype} does not "
                         f"match the output {tuple(out.shape)} {out.dtype}")
    dout = dout.contiguous()
    out = out.contiguous()
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
    scratch = None
    split = q_vec = k_vec = 0
    if qt.dtype == torch.bfloat16:
        plan = mma_plan(dh, lq, lk, b * h)
        kv_tile = q_tile = MMA_TILE
        threads_q = threads_k = 160
        split = plan.split
        scratch = torch.empty(plan.bwd_scratch, dtype=torch.float32, device=qt.device)
        q_vec = _loader("b", "q", lq, True, qt, dout)
        k_vec = _loader("b", "kv", lk, False, kt, vt)
    else:
        kv_tile, q_tile, threads_q, threads_k = bwd_launch_config(dh, lq, lk)
    lib = _build.load()
    with torch.cuda.device(qt.device):
        err = lib.controlnet_attention_bwd_t(
            qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            b, h, dh, lq, lk, _bstride(qt), _bstride(kt), _bstride(vt),
            _DTYPE_CODE[qt.dtype], kv_tile, q_tile, threads_q, threads_k, split, q_vec, k_vec,
            _stream(qt), None if cycles is None else cycles.data_ptr())
    if err != 0:
        raise RuntimeError(f"attention backward kernel launch failed: cudaError {err} "
                           f"(q{tuple(qt.shape)} k{tuple(kt.shape)} {qt.dtype})")
    bwd_launches += 1
    return dq, dk, dv


def phase_profile(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor) -> dict:
    """Mean clock cycles per block of one bf16 launch of kernel a by phase
    (``PHASES_A``, as thread 0 of each block sees them), and the block
    count.  Needs a CUDA card; a diagnostic, not on any path."""
    counters = torch.zeros(len(PHASES_A) + 1, dtype=torch.int64, device=qt.device)
    with torch.inference_mode():
        _launch(qt, kt, vt, cycles=counters)
    counts = counters.tolist()
    blocks = max(counts[-1], 1)
    return {**{p: c / blocks for p, c in zip(PHASES_A, counts)}, "blocks": counts[-1]}


def phase_profile_bwd(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                      dout: torch.Tensor) -> dict:
    """The same for one bf16 launch of kernel b's main kernel, by
    ``PHASES_B``."""
    counters = torch.zeros(len(PHASES_B) + 1, dtype=torch.int64, device=qt.device)
    with torch.inference_mode():
        _, saved, lse = forward_for_backward(qt, kt, vt)
        _launch_bwd(qt, kt, vt, saved, lse, dout, cycles=counters)
    counts = counters.tolist()
    blocks = max(counts[-1], 1)
    return {**{p: c / blocks for p, c in zip(PHASES_B, counts)}, "blocks": counts[-1]}


class _Attention(torch.autograd.Function):
    """The attention with its gradient.  On CUDA tensors the forward is kernel
    a (saving the row log-sum-exp and, in bf16, the float32 output before its
    rounding) and the backward kernel b; on CPU tensors both are the plain
    versions."""

    @staticmethod
    def forward(ctx, qt, kt, vt):
        if qt.device.type == "cpu":
            ctx.save_for_backward(qt, kt, vt)
            return fused_attention_t_plain(qt, kt, vt)
        out, saved, lse = forward_for_backward(qt, kt, vt)
        ctx.save_for_backward(qt, kt, vt, saved, lse)
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
