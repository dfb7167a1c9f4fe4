"""The whole self-attention layer as one kernel: the wrapper of kernel d
(``csrc/attention_proj.cu`` in float32, ``csrc/attention_proj_bf16.cu`` on
wgmma and TMA in bfloat16) and its plain PyTorch version.

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
from typing import NamedTuple

import torch

from controlnet_tpu_torch.ops import cuda_attention

launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
MAX_HEAD_DIM = 128
HEAD_DIMS = (8, 16, 24, 32, 48, 64, 96, 128)   # the kernel's instantiations
MAX_SHARED_BYTES = 232448             # what one block may use on an H100
MAX_CLUSTER = 16                      # blocks of one cluster (past 8: non-portable)
BF16_CLUSTER = 8                      # bf16 d's head groups stop at 8 blocks a cluster ...
BF16_BLOCKS = 256                     # ... or, past 8 tiles and in lean plans, reach this many
FEW_BLOCKS = 64                       # packed bf16 rows giving fewer blocks take one element a cluster
# constants of csrc/attention_proj.cuh (float32)
_THREADS = 128
_SLAB = 32                            # depth of the x and weight slabs
_STAGES = 3                           # slabs in the cp.async ring
_OUT_TILES = 8                        # n-tiles per pass of the output projection


# constants of csrc/attention_proj_hopper.cuh (bfloat16)
TILE = 64                             # rows of a block: one wgmma tile
_X_TILE = TILE * 128                  # one swizzled 64 x 64 tile of x or of head outputs
_MAX_N = 128                          # widest product tile
LEAN_N = 64                           # ... of the lean instantiation (half of it at DP 16)
_STAGE_BYTES = 17408                  # a warpgroup's epilogue staging (128 x 66 bf16, aligned)
OUT_COLS = (16, 32, 48, 64, 96, 128)  # output channels a tile of the output projection
TWO_PER_SM = 115712                   # shared memory that lets two blocks share an SM
THREE_PER_SM = 76800                  # ... three
X_ROUTES = ("tma token-major", "tma channel-major", "copy token-major", "copy channel-major")


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


def shared_bytes(rows: int, dh: int, d: int, heads: int, head_groups: int,
                 itemsize: int = 4) -> int:
    """Shared memory of one float32 block: a ring of x and weight slabs (the q tile
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


class Bf16Plan(NamedTuple):
    """Kernel d's launch plan in bfloat16 (csrc/attention_proj_hopper.cuh)."""
    elems: int           # batch elements a cluster: 1 where L >= 64, packed below
    tiles: int           # 64-row tiles a head group and cluster
    warpgroups: int      # 64-row tiles (warpgroups) a block: 1 or 2
    groups: int          # head groups (ceil(tiles / warpgroups) * groups <= 16 blocks)
    heads_per_tile: int  # heads of one projection tile (N = heads_per_tile * DP)
    out_cols: int        # output channels of one output-projection tile
    wstages: int         # weight ring
    kvstages: int        # K|V ring
    smem: int            # shared memory of a block
    per_sm: int          # blocks an SM its instantiation is built for: 1 at two warpgroups a
                         # block, 2 at one, 3 in the lean one (DP 16 or 32, products <= LEAN_N)


def packing(l: int) -> tuple[int, int]:
    """(elems, tiles): the batch elements one cluster holds and the 64-row
    tiles they fill.  From L = 64 up, one element in ceil(L / 64) tiles;
    below, the flattened rows of consecutive elements share tiles: the fewest
    tiles (up to 4) that fill at least 90% of their rows, else the fullest."""
    if l >= TILE:
        return 1, -(-l // TILE)
    best = None
    for tiles in range(1, 5):
        elems = TILE * tiles // l
        fill = elems * l / (TILE * tiles)
        if fill >= 0.9:
            return elems, tiles
        if best is None or fill > best[0]:
            best = (fill, elems, tiles)
    return best[1], best[2]


def shared_bytes_bf16(c: int, d: int, dp: int, heads_per_tile: int, out_cols: int, wstages: int,
                      kvstages: int, warpgroups: int = 1) -> int:
    """Shared memory of one bfloat16 block: 1 KB of alignment slack, each
    warpgroup's x tiles (64 rows of all C channels; later the head outputs,
    all D), the weight ring, the attention region (two Q tiles a warpgroup
    and the K|V ring, or each warpgroup's epilogue staging), the barriers.
    The same sum as ``make_layout`` in csrc/attention_proj_hopper.cuh (the
    kernel refuses a plan whose sum differs)."""
    x = -(-max(c, d) // TILE) * _X_TILE
    slot = max(heads_per_tile * dp, out_cols) * 128
    attn = max((2 * warpgroups + 2 * kvstages) * dp * 128, warpgroups * _STAGE_BYTES)
    return (1024 + warpgroups * x + wstages * slot + attn
            + 8 * (2 + wstages + 2 * warpgroups + kvstages))


def head_fits(blocks: int, c: int, heads: int) -> list[int]:
    """The head-group counts, in rising order, of a cluster whose head group
    spans ``blocks`` blocks: divisors of the heads that cut C into slices of
    a multiple of 8 channels, at most ``MAX_CLUSTER`` blocks a cluster."""
    return [g for g in range(1, heads + 1)
            if heads % g == 0 and c % g == 0 and (c // g) % 8 == 0 and blocks * g <= MAX_CLUSTER]


def head_groups(blocks: int, c: int, heads: int, clusters: int | None = None) -> int | None:
    """bf16 d's head groups of a cluster whose head group spans ``blocks``
    blocks: with ``clusters`` given, the fewest that give the card
    ``BF16_BLOCKS`` blocks in all (or the most that fit); else the most that
    keep the cluster within ``BF16_CLUSTER`` blocks (or one group, where its
    blocks need more).  None where no cluster holds one group."""
    fits = head_fits(blocks, c, heads)
    if not fits:
        return None
    if clusters is not None:
        return next((g for g in fits if clusters * blocks * g >= BF16_BLOCKS), fits[-1])
    return max(g for g in fits if blocks * g <= max(BF16_CLUSTER, blocks))


def pass_cols(width: int, widths: tuple = OUT_COLS) -> int:
    """The output-projection tile (of ``widths``) that pads ``width``
    channels least, the wider of two that pad alike."""
    return min(widths, key=lambda n: (-(-width // n) * n, -n))


def max_n(per_sm: int, dp: int) -> int:
    """``max_n`` of csrc/attention_proj_hopper.cuh: the widest product tile
    of an instantiation, ``LEAN_N`` (half of it at DP 16) in the lean one."""
    return (LEAN_N // 2 if dp <= 16 else LEAN_N) if per_sm > 2 else _MAX_N


# (weight, K|V) ring stages in the order tried, and the shared memory a
# block may take for its blocks an SM, in the order tried
_RINGS = ((4, 3), (3, 3), (2, 3), (2, 2))
_LIMITS = {1: (MAX_SHARED_BYTES,), 2: (TWO_PER_SM, MAX_SHARED_BYTES), 3: (THREE_PER_SM,)}


def _bf16_tiling(c: int, d: int, heads: int, dp: int, elems: int, tiles: int, warpgroups: int,
                 per_sm: int, groups: int) -> Bf16Plan | None:
    """The bf16 plan of one tiling: projection tiles of the most heads that
    divide a group within ``max_n`` columns, the output tile of ``pass_cols``
    within them, and the first ring stages (K|V no more than the tiles a block
    loads) whose shared memory fits a limit of ``_LIMITS``, tried in order."""
    hpg = heads // groups
    cap = max_n(per_sm, dp)
    nb = max(n for n in (1, 2, 4, 8) if hpg % n == 0 and n * dp <= cap)
    no = pass_cols(c // groups, tuple(n for n in OUT_COLS if n <= cap))
    for limit in _LIMITS[per_sm]:
        for ws, ks in _RINGS:
            ks = min(ks, hpg * tiles)
            smem = shared_bytes_bf16(c, d, dp, nb, no, ws, ks, warpgroups)
            if smem <= limit:
                return Bf16Plan(elems, tiles, warpgroups, groups, nb, no, ws, ks, smem, per_sm)
    return None


def _bf16_plan(l: int, c: int, d: int, heads: int, batch: int | None) -> Bf16Plan | None:
    dp = cuda_attention.mma_head_dim(d // heads)  # kernel a's padding
    whole = (1, -(-l // TILE))  # one element a cluster
    if dp <= 32 and l <= 784:
        # the lean instantiation, where it fits: one element a cluster, the
        # fewest head groups that give the card BF16_BLOCKS blocks
        groups = head_groups(whole[1], c, heads, batch or 1)
        plan = groups and _bf16_tiling(c, d, heads, dp, *whole, 1, 3, groups)
        if plan:
            return plan
    elems, tiles = packing(l)
    clusters = None if batch is None else -(-batch // elems)
    for nwg in (2, 1) if tiles > 1 else (1,):
        blocks = -(-tiles // nwg)
        groups = head_groups(blocks, c, heads, clusters if tiles > 8 else None)
        if groups is None:
            continue
        if clusters is not None and elems > 1 and clusters * blocks * groups < FEW_BLOCKS:
            # packed rows would leave most of the card idle: one element a
            # cluster (L < 64: one tile), one warpgroup a block
            return _bf16_tiling(c, d, heads, dp, *whole, 1, 2,
                                head_groups(whole[1], c, heads))
        plan = _bf16_tiling(c, d, heads, dp, elems, tiles, nwg, 2 // nwg, groups)
        if plan:
            return plan
    return None


def launch_plan(l: int, c: int, d: int, heads: int, dtype: torch.dtype,
                batch: int | None = None) -> tuple[int, int, int, int] | Bf16Plan | None:
    """Kernel d's launch plan for one layer, or None where the kernel has no
    instantiation for its head dim or a cluster cannot hold it.  bfloat16: a
    ``Bf16Plan``.  float32: (rows, q_tiles, head_groups, smem_bytes).

    In bfloat16 (csrc/attention_proj_hopper.cuh): 64-row tiles.  At padded
    head dims 16 and 32 and L up to 784 the lean instantiation where its
    shared memory lets three blocks share an SM: one warpgroup a block, one
    element's ceil(L / 64) tiles a cluster, the fewest head groups that give
    ``BF16_BLOCKS`` blocks in all (``batch`` or 1 clusters), products at most
    ``max_n`` columns wide.  Else one element's tiles a cluster from L = 64
    up and elements packed into tiles below (``packing``); two tiles
    (warpgroups) a block where there are two and they fit one block an SM,
    else one; ``head_groups``: the most head groups that keep a cluster
    within 8 blocks, or one group where a group's tiles need more (and C
    into slices of 8 or more channels: the card holds 14 clusters of 16
    blocks at once but 16 or more of 8), except past 8 tiles with ``batch``
    given, where the fewest groups (cluster up to 16 blocks) that give
    ``BF16_BLOCKS`` blocks in all: at L 1,024 and batch 16 one group leaves
    128 blocks of 16 heads each; where packed rows would give the batch
    fewer than ``FEW_BLOCKS`` blocks, one element a cluster and one tile a
    block instead.  Then (``_bf16_tiling``) projection tiles of the most
    heads that divide a group and stay within ``max_n`` columns; the
    output-projection tile that pads a group's channels least; ring stages
    (weights / K|V) 4 / 3, 3 / 3, 2 / 3 or 2 / 2 (K|V no more than the tiles
    a block loads), the first that lets the instantiation's blocks share an
    SM (one-warpgroup blocks: two, else the first that fits one block).

    In float32 (csrc/attention_proj.cuh):
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
    if dtype == torch.bfloat16:
        return _bf16_plan(l, c, d, heads, batch)
    rows = 64 if l > 256 else (32 if l > 64 else 16)
    q_tiles = -(-l // rows)
    groups = max(head_fits(q_tiles, c, heads), default=0)
    if not groups:
        return None
    smem = shared_bytes(rows, d // heads, d, heads, groups)
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
    float32; in bfloat16 C and D up to ~1,300, the x tile of all C channels
    resident).  A layer outside this rule takes the split path (projection,
    attention kernel, projection)."""
    if dtype not in _DTYPE_CODE or heads < 1 or d % heads or l < 1:
        return False
    dh = d // heads
    if dh % 8 or dh > MAX_HEAD_DIM or c % 8:
        return False
    return launch_plan(l, c, d, heads, dtype) is not None


def max_active_clusters(l: int, c: int, d: int, heads: int, dtype: torch.dtype,
                        batch: int | None = None) -> int:
    """How many of kernel d's clusters, at this layer's launch plan, the
    current CUDA card holds at once (cudaOccupancyMaxActiveClusters): with
    ``launch_plan``'s cluster size, how much of the card one wave fills.
    Needs a CUDA card; a diagnostic, not on any path."""
    from controlnet_tpu_torch.ops import _build

    plan = launch_plan(l, c, d, heads, dtype, batch)
    count = ctypes.c_int(0)
    if dtype == torch.bfloat16:
        err = _build.load().controlnet_attention_proj_bf16_clusters(
            l, c, d, heads, plan.elems, plan.tiles, plan.groups, plan.heads_per_tile,
            plan.out_cols, plan.wstages, plan.kvstages, plan.warpgroups, plan.per_sm, plan.smem,
            ctypes.byref(count))
    else:
        rows, q_tiles, groups, smem = plan
        err = _build.load().controlnet_attention_proj_clusters(
            l, c, d, heads, _DTYPE_CODE[dtype], rows, q_tiles, groups, smem, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cluster occupancy query failed: cudaError {err}")
    return count.value


def phase_profile(x: torch.Tensor, in_w: torch.Tensor, in_b: torch.Tensor,
                  out_w: torch.Tensor, out_b: torch.Tensor, num_heads: int) -> dict:
    """Mean clock cycles per block of one launch of kernel d by phase
    (``phases(x.dtype)``, as thread 0 of each block sees them), and the block
    count.  Needs a CUDA card; a diagnostic, not on any path."""
    names = phases(x.dtype)
    counters = torch.zeros(len(names) + 1, dtype=torch.int64, device=x.device)
    with torch.inference_mode():
        _launch(x, in_w, in_b, out_w, out_b, num_heads, counters)
    counts = counters.tolist()
    blocks = max(counts[-1], 1)
    return {**{p: c / blocks for p, c in zip(names, counts)}, "blocks": counts[-1]}


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


# where a block's cycles go (phase_profile): float32 (attention_proj.cuh) and
# bfloat16 (attention_proj_hopper.cuh, hopper_attention.cuh's PhaseClock)
PHASES = ("zero", "project", "project_sync", "attend_wait", "attend_math", "attend_put", "merge",
          "gather", "out_project")
PHASES_BF16 = ("wait", "sync", "project", "scores", "softmax", "pv", "out_project", "epilogue")


def phases(dtype: torch.dtype) -> tuple[str, ...]:
    return PHASES_BF16 if dtype == torch.bfloat16 else PHASES


def x_route(shape: tuple, strides: tuple, ptr: int, elems: int) -> tuple[int, int]:
    """How the bfloat16 kernel loads x (B, L, C) of these strides (in
    elements) at address ``ptr``: (route, elements a copy), route an index of
    ``X_ROUTES``.  TMA where its 16-byte stride rule holds (token-major x; or
    channel-major x with L a multiple of 8 and one element a cluster),
    else the warpgroup copies it, 16, 8 or 4 bytes a copy where the strides
    and L let no copy straddle two elements, else element by element."""
    _, l, c = shape
    bs, rs, cs = strides
    if cs == 1 and c > 1:  # token-major: rows of contiguous channels
        if (rs % 8 == 0 and bs % 8 == 0 and ptr % 16 == 0
                and (elems == 1 or bs == l * rs or shape[0] == 1)):
            return 0, 8
        vec = next((v for v in (8, 4, 2) if rs % v == 0 and bs % v == 0 and ptr % (2 * v) == 0),
                   1)
        return 2, vec
    if elems == 1 and cs % 8 == 0 and bs % 8 == 0 and ptr % 16 == 0:
        return 1, 8
    vec = next((v for v in (8, 4, 2) if l % v == 0 and cs % v == 0 and bs % v == 0
                and ptr % (2 * v) == 0), 1)
    return 3, vec


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
            raise ValueError(f"{name} must be 16-byte aligned (the kernel loads it by "
                             "cp.async or TMA)")
    if x.dtype == torch.bfloat16:
        return _launch_bf16(x, in_w, in_b, out_w, out_b, num_heads, out, phase_cycles)
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


def _launch_bf16(x: torch.Tensor, in_w: torch.Tensor, in_b: torch.Tensor, out_w: torch.Tensor,
                 out_b: torch.Tensor, num_heads: int, out: torch.Tensor,
                 phase_cycles: torch.Tensor | None) -> torch.Tensor:
    """Kernel d in bfloat16 into ``out``, with its two scratch buffers: q|k|v
    of every head in kernel a's (dh, L) panels, and the head outputs."""
    global launches
    from controlnet_tpu_torch.ops import _build

    b, l, c = x.shape
    d = out_w.shape[1]
    plan = launch_plan(l, c, d, num_heads, x.dtype, b)
    clusters = -(-b // plan.elems)
    rows = -(-plan.tiles // plan.warpgroups) * plan.warpgroups * TILE
    qkv = torch.empty(clusters * 3 * d * rows, dtype=x.dtype, device=x.device)
    heads_out = torch.empty(clusters * rows * d, dtype=x.dtype, device=x.device)
    route, vec = x_route(tuple(x.shape), x.stride(), x.data_ptr(), plan.elems)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.controlnet_attention_proj_bf16(
            x.data_ptr(), in_w.data_ptr(), in_b.data_ptr(), out_w.data_ptr(), out_b.data_ptr(),
            out.data_ptr(), qkv.data_ptr(), heads_out.data_ptr(), b, l, c, d, num_heads,
            *x.stride(), *out.stride(), plan.elems, plan.tiles, plan.groups,
            plan.heads_per_tile, plan.out_cols, plan.wstages, plan.kvstages,
            plan.warpgroups, plan.per_sm, route, vec, plan.smem, _stream(x),
            None if phase_cycles is None else phase_cycles.data_ptr())
    if err != 0:
        raise RuntimeError(f"fused projection + attention kernel launch failed: cudaError {err} "
                           f"(x{tuple(x.shape)} strides {x.stride()}, D {d}, {num_heads} heads, "
                           f"bfloat16; plan {plan}, x route {X_ROUTES[route]} by {vec})")
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
