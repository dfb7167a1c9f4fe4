"""3x3 stride-1 pad-1 convolution in the transposed (C, B, L) layout: the
wrappers of kernel c (float32 on the CUDA cores in ``csrc/conv3x3_tl.cu``,
bfloat16 on wgmma in ``csrc/conv3x3_tl_bf16.cuh``) and its plain PyTorch
version.

Counterpart of ``controlnet_tpu/ops/pallas_conv.py``'s ``pallas_conv3x3_tl``
(``_conv_kernel`` with its custom VJP).  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.  There is no fallback
from one to the other.  As in the JAX package the gradient is plain tensor
code (``torch.nn.grad``), on both devices.

Weights are ``(Cout, Cin, 3, 3)`` as ``nn.Conv2d`` holds them; the wrapper
lays them out for the kernel: for float32 the K-major ``(9*Cin, Npad)``
matrix of the implicit GEMM (``k_major_weight``; at Cin 1 the kernel reads
the weight as held instead, as that matrix would be its transpose), for
bfloat16 the ``(slabs, 9, 2, Cout, 8)`` order of the wgmma kernel's TMA boxes
(``slab_weight``), kept across calls while the weight's version is unchanged
(``_kept``).  The float32 kernel's tile configuration and its split over the
input channels come from ``f32_launch_plan``, the bfloat16 kernel's from
``bf16_launch_plan`` (the wgmma kernel's, or for images 64 wide and wider
the mma.sync kernel's in ``csrc/conv3x3_tl_bf16_mma.cu``, laid out by
``flat_weight``).  The input may be any ``(C, B, L)`` view whose rows of
L values are contiguous (the ``to_tl`` view of an NCHW tensor is one): the
kernel reads it through its channel and batch strides, and no copy is made.
The output is contiguous.

``launches`` counts launches of kernel c (never plain-version calls).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
import threading

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
_GRID_X_LIMIT = 2**31 - 1  # pixel tiles
_INT32_MAX = 2**31 - 1
# The float32 kernel (csrc/conv3x3_tl.cu, CONV_F32_TILES): its tile
# configurations as (pixels, output channels, threads, output channels a
# thread, blocks an SM) of a block; every thread holds 8 pixels.
F32_TILES = ((128, 128, 256, 8, 2), (128, 64, 128, 8, 4), (64, 64, 64, 8, 8),
             (256, 32, 128, 8, 3), (256, 32, 256, 4, 2), (256, 16, 128, 4, 4))
# The one tile with an instantiation that reads the weight as held, which a
# conv of one input channel takes (K = 9: one slab, unsplit)
F32_HELD_TILE = (256, 32, 256, 4, 2)
F32_STAGES = 4  # slabs (one input channel's 9 taps each) in flight
SMS = 132  # streaming multiprocessors of an H100 SXM
MAX_SHARED_BYTES = 232448  # a block's shared memory on an H100
SM_SHARED_BYTES = 233472  # an SM's, of which each resident block takes 1 KB more


def from_tl(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """(C, B, H*W) -> (B, C, H, W); a view of a contiguous input."""
    c, b, _ = x.shape
    return x.permute(1, 0, 2).reshape(b, c, hw[0], hw[1])


def to_tl(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (C, B, H*W); a view of a contiguous input."""
    b, c, h, w = x.shape
    return x.reshape(b, c, h * w).permute(1, 0, 2)


def flat_weight(weight: torch.Tensor, dtype: torch.dtype,
                channel_multiple: int = 1) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> contiguous (Cout, 9*Cp), tap-major
    (column = (3*ky + kx) * Cp + c), in ``dtype``; Cp is Cin rounded up to
    ``channel_multiple``, the extra channels zero: the order the Pallas
    kernel's im2col block multiplies."""
    cout, cin = weight.shape[:2]
    taps = weight.permute(0, 2, 3, 1).to(dtype)
    pad = -cin % channel_multiple
    if pad:
        taps = F.pad(taps, (0, pad))
    return taps.reshape(cout, 9 * (cin + pad)).contiguous()


def slab_weight(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> the bf16 kernel's contiguous (ceil(Cin / 16), 9, 2,
    Cout16, 8) bf16 weight, Cout16 = Cout rounded up to 16: slab s, tap
    3*ky + kx, channel half h, output channel o, value v holds w[o, 16*s +
    8*h + v, ky, kx], zero past Cin and Cout.  One slab is one TMA box, laid
    out as wgmma's K-major core matrices; its rows are 16 output channels
    (256 contiguous bytes)."""
    cout = weight.shape[0]
    flat = flat_weight(weight, torch.bfloat16, BF16_SLAB)
    if cout % 16:
        flat = F.pad(flat, (0, 0, 0, -cout % 16))
    slabs = flat.shape[1] // (9 * BF16_SLAB)
    return flat.reshape(flat.shape[0], 9, slabs, 2, 8).permute(2, 1, 3, 0, 4).contiguous()


# tensor -> {kind: (version, derived tensor)}: what the wrapper derived from a
# weight or bias, dropped with the tensor; the lock serves the serve tool's
# replica threads
_KEPT: WeakIdKeyDictionary = WeakIdKeyDictionary()
_KEPT_LOCK = threading.Lock()


def _kept(t: torch.Tensor, kind: str, make) -> torch.Tensor:
    """``make(t)`` (a layout named ``kind``), computed again only when ``t``
    was changed in place since it was made (its version counter moved).
    Inference tensors keep no version counter: theirs is made on every call,
    as is a result that is ``t`` itself (kept, it would keep its key alive)."""
    if t.is_inference():
        return make(t)
    with _KEPT_LOCK:
        kept = _KEPT.get(t)
        hit = None if kept is None else kept.get(kind)
        if hit is not None and hit[0] == t._version:
            return hit[1]
        out = make(t)
        if out is not t:
            _KEPT.setdefault(t, {})[kind] = (t._version, out)
        return out


def conv3x3_tl_plain(weight: torch.Tensor, bias: torch.Tensor | None, x: torch.Tensor,
                     hw: tuple[int, int]) -> torch.Tensor:
    """Plain version of the kernel, with its arithmetic: the weights rounded
    to the activation's type, float32 products and sums, a float32 bias, one
    rounding at the end.  (C, B, L) in, contiguous (Cout, B, L) out."""
    w32 = weight.to(x.dtype).float()
    b32 = None if bias is None else bias.float()
    out = F.conv2d(from_tl(x, hw).float(), w32, b32, stride=1, padding=1)
    return to_tl(out.to(x.dtype)).contiguous()


def k_major_weight(weight: torch.Tensor, n_pad: int) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> the float32 kernel's contiguous (9*Cin, n_pad)
    float32 matrix, row 9*c + 3*ky + kx, the columns past Cout zero."""
    cout, cin = weight.shape[:2]
    taps = weight.float().permute(1, 2, 3, 0).reshape(9 * cin, cout)
    if n_pad > cout:
        taps = F.pad(taps, (0, n_pad - cout))
    return taps.contiguous()


@dataclasses.dataclass(frozen=True)
class F32Plan:
    """A launch of the float32 kernel: ``tile`` (pixels, output channels,
    threads, output channels a thread, blocks an SM) of a block, ``m_tiles`` x ``n_tiles``
    block tiles over the M = B*H*W pixels and Cout channels, the input
    channels in ``splits`` parts of ``channels_per_split`` (gridDim.y; a
    second kernel adds the parts when there are several), ``stages`` slabs
    in flight and the block's static shared bytes.  ``weights_as_held``
    (Cin 1 on ``F32_HELD_TILE``): the kernel reads the (Cout, Cin, 3, 3)
    weight itself, whose K-major matrix would be a transposed copy costing
    as much as the product; otherwise it reads ``k_major_weight(weight,
    n_pad)``."""

    tile: tuple
    m_tiles: int
    n_tiles: int
    splits: int
    channels_per_split: int
    stages: int
    shared_bytes: int
    weights_as_held: bool

    @property
    def grid(self) -> tuple[int, int]:
        return self.m_tiles * self.n_tiles, self.splits

    @property
    def n_pad(self) -> int:
        """Columns of the K-major weight matrix: Cout rounded up to the channel tile."""
        return self.n_tiles * self.tile[1]


# The planner's model of the card, in microseconds, fitted to
# `scripts/port_conv_check.py --sweep` on an H100 (every tile and split at the
# 40 shapes of kernel c's units): a block's FFMAs at the tile's share of an
# SM's 128 lanes a cycle at F32_CLOCK_MHZ (the narrower the channel tile,
# the more gathering a product), plus a fixed cost a block and one for each
# element a thread gathers a slab (index work, filling the ring, the
# epilogue); the split partial sums' pass, its launch and its bytes (they
# mostly come back out of L2).  An SM keeps its pipes busy from
# F32_FULL_WARPS resident warps on.
F32_CLOCK_MHZ = 1755.0
F32_EFFICIENCY = {(128, 128, 256): 0.64, (128, 64, 128): 0.61, (64, 64, 64): 0.61,
                  (256, 32, 128): 0.52, (256, 32, 256): 0.47, (256, 16, 128): 0.40}
F32_BLOCK_US = 0.5
F32_GATHER_US = 0.05
F32_SUM_US = 0.5
F32_SUM_BYTES_PER_US = 4e6
F32_FULL_WARPS = 12
F32_SPLITS = tuple(range(1, 17)) + (24, 32)  # the splits of the input channels it weighs


def f32_plan(tile: tuple, splits: int, cin: int, cout: int, m: int) -> F32Plan:
    """The float32 kernel's launch of ``tile`` (one of ``F32_TILES``) with the
    input channels in ``splits`` parts, for M = B*H*W pixels."""
    bm, bn = tile[:2]
    cps = -(-cin // splits)
    held = cin == 1 and tuple(tile) == F32_HELD_TILE
    shared = 4 * F32_STAGES * 9 * (bm + bn + 4 * held)  # held weights' rows padded by 4
    return F32Plan(tile, -(-m // bm), -(-cout // bn), splits, cps, F32_STAGES, shared, held)


def f32_plan_us(plan: F32Plan, cout: int, m: int) -> float:
    """The planner's estimate of a launch's device time, in microseconds."""
    bm, bn, threads, _, per_sm = plan.tile
    blocks = plan.grid[0] * plan.splits
    gathered = -(-9 * bm // threads)  # elements a thread gathers a slab
    block_us = (bm * bn * 9 * plan.channels_per_split
                / (128 * F32_EFFICIENCY[plan.tile[:3]] * F32_CLOCK_MHZ)
                + F32_BLOCK_US + F32_GATHER_US * gathered)
    q = -(-blocks // SMS)  # blocks on the busiest SM
    rate = min(1.0, min(q, per_sm) * threads / 32 / F32_FULL_WARPS)
    us = q * block_us / rate
    if plan.splits > 1:
        us += F32_SUM_US + (plan.splits + 1) * cout * m * 4 / F32_SUM_BYTES_PER_US
    return us


@functools.lru_cache(maxsize=None)
def f32_launch_plan(cin: int, cout: int, h: int, w: int, b: int) -> F32Plan:
    """The float32 kernel's launch for a (Cin, Cout, H, W, B) conv: of every
    tile configuration (``F32_TILES``) and split of the input channels
    (``F32_SPLITS``, none empty), the one ``f32_plan_us`` puts first
    (weighing them takes ~0.6 ms of host time, so each shape's plan is kept);
    at Cin 1, ``F32_HELD_TILE``.
    Raises where the pixel count, the output or the grid exceed what the
    kernel's 32-bit indices and grid hold."""
    m = b * h * w
    if m > _INT32_MAX or cout * m > _INT32_MAX:
        raise ValueError(f"conv of {cin}->{cout} @{h}x{w} B {b} beyond the kernel's 32-bit indices")
    if cin == 1:
        return f32_plan(F32_HELD_TILE, 1, cin, cout, m)
    best = None
    for tile in F32_TILES:
        for splits in F32_SPLITS:
            plan = f32_plan(tile, splits, cin, cout, m)
            if (splits - 1) * plan.channels_per_split >= cin or plan.grid[0] > _GRID_X_LIMIT:
                continue
            us = f32_plan_us(plan, cout, m)
            if best is None or us < best[0]:
                best = (us, plan)
    if best is None:
        raise ValueError(f"conv of {cin}->{cout} @{h}x{w} B {b} beyond the kernel's grid")
    return best[1]


# The bf16 wgmma kernel (csrc/conv3x3_tl_bf16.cuh): pixel rows of a consumer
# warpgroup, input channels a k-step, P's pitch in values, the widest image
# it takes, the channel tiles it is instantiated for, its ring depths, and
# its blocks an SM by warpgroups and channel tile (its launch bounds,
# min_blocks).
BF16_ROWS = 64
BF16_SLAB = 16
BF16_PITCH = 24
BF16_MAX_W = 63
BF16_TILES_N = (16, 32, 64, 128)
BF16_STAGES = (2, 3, 4)
BF16_SPLITS = tuple(range(1, 17)) + (24, 32)


def bf16_min_blocks(nwg: int, bn: int) -> int:
    return (3 if bn <= 32 else 2) if nwg == 1 else 1


@dataclasses.dataclass(frozen=True)
class Bf16Plan:
    """A launch of the bf16 wgmma kernel: ``nwg`` consumer warpgroups of 64
    pixels a block, ``bn`` output channels a tile, ``stages`` ring slots, the
    input channels' 16-channel slabs in ``splits`` parts of
    ``slabs_per_split`` (a second kernel adds the parts when there are
    several), ``m_tiles`` x ``n_tiles`` x ``splits`` tiles walked by
    ``blocks`` persistent blocks, ``per_sm`` of them an SM, each with
    ``shared_bytes`` of dynamic shared memory; P (the pixel-major tile) has
    ``rows_p`` = 2W + 66 rows."""

    nwg: int
    bn: int
    stages: int
    splits: int
    slabs_per_split: int
    m_tiles: int
    n_tiles: int
    blocks: int
    per_sm: int
    shared_bytes: int
    rows_p: int

    @property
    def tiles(self) -> int:
        return self.m_tiles * self.n_tiles * self.splits

    @property
    def n_pad(self) -> int:
        """Columns of the split partial sums: Cout rounded up to the channel tile."""
        return self.n_tiles * self.bn


def bf16_shared_bytes(nwg: int, bn: int, stages: int, w: int) -> int:
    """Dynamic shared bytes of a block (``smem_bytes`` in the kernel's header):
    1 KB of alignment slack, the weight ring and its barriers, then per
    warpgroup the two P tiles and the output tile."""
    rows_p = 2 * w + BF16_ROWS + 2
    per_wg = 2 * rows_p * BF16_PITCH * 2 + bn * (BF16_ROWS + 8) * 2
    return 1024 + stages * (bn * 9 * BF16_SLAB * 2 + 16) + nwg * per_wg


def bf16_stages(nwg: int, bn: int, w: int) -> int | None:
    """The ring's slots: the most of ``BF16_STAGES`` that keep the blocks an SM
    should hold, else the fewest that fit a block; None if none fits."""
    fits = [st for st in BF16_STAGES if bf16_shared_bytes(nwg, bn, st, w) <= MAX_SHARED_BYTES]
    want = bf16_min_blocks(nwg, bn)
    keep = [st for st in fits
            if want * (bf16_shared_bytes(nwg, bn, st, w) + 1024) <= SM_SHARED_BYTES]
    return max(keep) if keep else min(fits, default=None)


def bf16_plan(nwg: int, bn: int, stages: int, splits: int, cin: int, cout: int,
              h: int, w: int, b: int) -> Bf16Plan:
    """The bf16 wgmma kernel's launch of one tile configuration and split,
    with as many persistent blocks as the card holds at once (or as there
    are tiles)."""
    m = b * h * w
    slabs = -(-cin // BF16_SLAB)
    sps = -(-slabs // splits)
    m_tiles, n_tiles = -(-m // (BF16_ROWS * nwg)), -(-cout // bn)
    shared = bf16_shared_bytes(nwg, bn, stages, w)
    per_sm = min(bf16_min_blocks(nwg, bn), SM_SHARED_BYTES // (shared + 1024))
    tiles = m_tiles * n_tiles * splits
    return Bf16Plan(nwg, bn, stages, splits, sps, m_tiles, n_tiles,
                    max(1, min(tiles, SMS * per_sm)), per_sm, shared, 2 * w + BF16_ROWS + 2)


# The planner's model of the card, fitted to `scripts/port_conv_check.py
# --sweep bf16` on an H100 (every wgmma configuration at kernel c's unit
# shapes narrower than BF16_MMA_MIN_W): an SM's tensor cycles (a k-step is 9
# wgmma.m64nBNk16, BN / 2 cycles each at the full rate, shared by the blocks
# it holds) against a block's own cycles a k-step (a fixed part, barriers,
# ldmatrix and the wait for its loads, and a part for each input channel it
# gathers) and a tile (masks, epilogue), and the bytes the call moves
# through L2 (the weights once a pixel tile, P once a channel tile); the
# split partial sums' pass; a launch.
BF16_CLOCK_MHZ = 1755.0
BF16_TENSOR_EFFICIENCY = 0.5
BF16_STEP_CYCLES = 1500.0
BF16_CHANNEL_CYCLES = 75.0
BF16_TILE_CYCLES = 5000.0
BF16_BYTES_PER_US = 4e6
BF16_SUM_US = 4.0
BF16_LAUNCH_US = 3.0


def bf16_plan_us(plan: Bf16Plan, cin: int, cout: int, h: int, w: int, b: int) -> float:
    """The planner's estimate of a launch's device time, in microseconds."""
    m = b * h * w
    slabs = -(-cin // BF16_SLAB)
    conc = max(1, min(plan.per_sm, -(-plan.blocks // SMS)))  # blocks an SM holds
    tiles_per_block = -(-plan.tiles // plan.blocks)
    steps = tiles_per_block * plan.slabs_per_split
    tensor = conc * steps * 9 * plan.bn / 2 * plan.nwg / BF16_TENSOR_EFFICIENCY
    own = (steps * (BF16_STEP_CYCLES + BF16_CHANNEL_CYCLES * min(cin, BF16_SLAB))
           + tiles_per_block * BF16_TILE_CYCLES)
    us = max(tensor, own) / BF16_CLOCK_MHZ
    moved = (2 * BF16_SLAB * slabs * m * plan.rows_p / BF16_ROWS * plan.n_tiles
             + 2 * 9 * BF16_SLAB * slabs * plan.n_pad * plan.m_tiles + 2 * cout * m)
    us = max(us, moved / BF16_BYTES_PER_US)
    if plan.splits > 1:
        us += BF16_SUM_US + (plan.splits + 1) * plan.n_pad * m * 4 / BF16_BYTES_PER_US
    return us + BF16_LAUNCH_US


@functools.lru_cache(maxsize=None)
def bf16_wgmma_plan(cin: int, cout: int, h: int, w: int, b: int) -> Bf16Plan:
    """The wgmma kernel's launch for a (Cin, Cout, H, W, B) conv, W at most
    ``BF16_MAX_W``: of every warpgroup count, channel tile, ring depth that
    fits the blocks an SM should hold, and split of the input channels
    (``BF16_SPLITS``, none empty), the one ``bf16_plan_us`` puts first (each
    shape's plan is kept).  Raises beyond the kernel's widths, grid and
    32-bit indices."""
    m = b * h * w
    if w > BF16_MAX_W:
        raise ValueError(f"conv of {cin}->{cout} @{h}x{w}: the wgmma kernel takes W <= {BF16_MAX_W}")
    if m > _INT32_MAX - 256:
        raise ValueError(f"conv of {cin}->{cout} @{h}x{w} B {b} beyond the kernel's 32-bit indices")
    slabs = -(-cin // BF16_SLAB)
    best = None
    for nwg, bn in itertools.product((1, 2), BF16_TILES_N):
        if bn > 16 and bn // 2 >= cout:
            continue  # a narrower tile covers Cout
        stages = bf16_stages(nwg, bn, w)
        if stages is None:
            continue
        for splits in BF16_SPLITS:
            if splits > slabs or (splits - 1) * -(-slabs // splits) >= slabs:
                continue
            plan = bf16_plan(nwg, bn, stages, splits, cin, cout, h, w, b)
            if plan.tiles > _INT32_MAX:
                continue
            us = bf16_plan_us(plan, cin, cout, h, w, b)
            if best is None or us < best[0]:
                best = (us, plan)
    if best is None:
        raise ValueError(f"conv of {cin}->{cout} @{h}x{w} B {b} beyond the kernel's grid")
    return best[1]


def bf16_launch_plan(cin: int, cout: int, h: int, w: int, b: int) -> Bf16Plan | MmaPlan:
    """Kernel c's bf16 launch: the mma.sync kernel's (``mma_launch_config``)
    for images at least ``BF16_MMA_MIN_W`` wide, where it ran faster in turns
    on an H100 (the hint encoder's 64^2 to 1024^2 layers), else the wgmma
    kernel's (``bf16_wgmma_plan``).  Raises beyond the kernels' grids and
    32-bit indices."""
    if w >= BF16_MMA_MIN_W:
        return mma_launch_config(cin, cout, h, w, b)
    return bf16_wgmma_plan(cin, cout, h, w, b)


# The mma.sync kernel (csrc/conv3x3_tl_bf16_mma.cu), kept for wide images:
# output pixels of a block (rows, columns of one image), its input channels
# per slab and double-buffered stages, and the narrowest image it takes.
MMA_PIXEL_TILE = (8, 32)
MMA_STAGES = 2
BF16_MMA_MIN_W = 64


@dataclasses.dataclass(frozen=True)
class MmaPlan:
    """A launch of the mma.sync kernel: ``pixel_tile`` (rows, columns of one
    image) and ``tco`` output channels a block, ``stages`` double-buffered
    slabs, ``shared_bytes`` of dynamic shared memory."""

    pixel_tile: tuple
    tco: int
    stages: int
    shared_bytes: int


def mma_launch_config(cin: int, cout: int, h: int, w: int, b: int) -> MmaPlan:
    """The mma.sync kernel's launch: 8 x 32 output pixels and 16, 32 or 64
    output channels a block (the fewest that cover Cout; ragged H, W and
    Cout are masked), and per stage the (10 x 34)-pixel halo tile of one
    16-channel slab, pixel-major at a 24-value pitch, beside the slab's
    (channels, 9 taps x 16) weights at a 152-value pitch, in bf16.  Raises
    where the grid cannot hold the call."""
    th, tw = MMA_PIXEL_TILE
    tco = 16 if cout <= 16 else 32 if cout <= 32 else 64
    tiles = -(-h // th) * -(-w // tw)
    if tiles > _GRID_X_LIMIT or -(-cout // tco) > 65535 or b > 65535:
        raise ValueError(f"conv of {cin}->{cout} @{h}x{w} B {b} beyond the kernel's grid")
    stage = (th + 2) * (tw + 2) * (BF16_SLAB + 8) + tco * (9 * BF16_SLAB + 8)
    return MmaPlan((th, tw), tco, MMA_STAGES, 2 * MMA_STAGES * stage)


def _check(weight: torch.Tensor, bias: torch.Tensor | None, x: torch.Tensor,
           hw: tuple[int, int]) -> None:
    if x.dim() != 3:
        raise ValueError(f"expected a (C, B, L) tensor, got {tuple(x.shape)}")
    if weight.dim() != 4 or tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"expected (Cout, Cin, 3, 3) weights, got {tuple(weight.shape)}")
    if weight.shape[1] != x.shape[0]:
        raise ValueError(f"weights take {weight.shape[1]} channels, x has {x.shape[0]}")
    if hw[0] * hw[1] != x.shape[2]:
        raise ValueError(f"hw {tuple(hw)} does not match L = {x.shape[2]}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"conv kernel takes float32 or bfloat16, not {x.dtype}")
    if weight.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError("weights, bias and x must be on one device")
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"expected a ({weight.shape[0]},) bias, got {tuple(bias.shape)}")
    if x.shape[2] != 1 and x.stride(2) != 1:
        raise ValueError(f"x must have contiguous rows of L values, got strides {x.stride()}")


def _launch(weight: torch.Tensor, bias: torch.Tensor | None, x: torch.Tensor,
            hw: tuple[int, int], plan: F32Plan | Bf16Plan | MmaPlan | None = None,
            cycles: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel c on a CUDA tensor with ``plan``, by default ``f32_launch_plan``'s
    or ``bf16_launch_plan``'s; ``cycles``: bf16 phase counters (``phase_profile``)."""
    global launches
    from controlnet_tpu_torch.ops import _build

    cin, b, l = x.shape
    cout = weight.shape[0]
    b32 = (torch.zeros(cout, dtype=torch.float32, device=x.device) if bias is None
           else _kept(bias, "f32", lambda t: t.float().contiguous()))
    out = torch.empty((cout, b, l), dtype=x.dtype, device=x.device)
    lib = _build.load()
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    if x.dtype == torch.bfloat16:
        plan = plan or bf16_launch_plan(cin, cout, hw[0], hw[1], b)
        if isinstance(plan, MmaPlan):
            w_mat = _kept(weight, "flat16", lambda t: flat_weight(t, torch.bfloat16, BF16_SLAB))
            with torch.cuda.device(x.device):
                err = lib.controlnet_conv3x3_tl_bf16_mma(
                    x.data_ptr(), w_mat.data_ptr(), b32.data_ptr(), out.data_ptr(),
                    cin, cout, b, hw[0], hw[1], x.stride(0), x.stride(1), plan.tco // 16, stream)
        else:
            w_mat = _kept(weight, "slab", slab_weight)
            partial = (torch.empty((plan.splits, b * l, plan.n_pad), dtype=torch.float32,
                                   device=x.device) if plan.splits > 1 else None)
            with torch.cuda.device(x.device):
                err = lib.controlnet_conv3x3_tl_bf16(
                    x.data_ptr(), w_mat.data_ptr(), b32.data_ptr(), out.data_ptr(),
                    None if partial is None else partial.data_ptr(),
                    cin, cout, b, hw[0], hw[1], x.stride(0), x.stride(1),
                    plan.nwg, plan.bn, plan.stages, plan.splits, plan.blocks, stream,
                    None if cycles is None else cycles.data_ptr())
    else:
        plan = plan or f32_launch_plan(cin, cout, hw[0], hw[1], b)
        if (b - 1) * x.stride(1) + l > _INT32_MAX:
            raise ValueError(f"x{tuple(x.shape)} at strides {x.stride()} beyond the kernel's "
                             "32-bit offsets in a channel plane")
        w_mat = (weight.float().contiguous() if plan.weights_as_held
                 else k_major_weight(weight, plan.n_pad))
        tile_m, tile_n, threads = plan.tile[:3]
        partial = (torch.empty((plan.splits, cout, b * l), dtype=torch.float32, device=x.device)
                   if plan.splits > 1 else None)
        with torch.cuda.device(x.device):
            err = lib.controlnet_conv3x3_tl(
                x.data_ptr(), w_mat.data_ptr(), b32.data_ptr(), out.data_ptr(),
                None if partial is None else partial.data_ptr(),
                cin, cout, b, hw[0], hw[1], x.stride(0), x.stride(1),
                tile_m, tile_n, threads, plan.splits, int(plan.weights_as_held), stream)
    if err != 0:
        raise RuntimeError(f"conv kernel launch failed: cudaError {err} "
                           f"(x{tuple(x.shape)} w{tuple(weight.shape)} {x.dtype})")
    launches += 1
    return out


# bf16 kernel c's phases (ConsumerPhase, then ProducerPhase, in its header)
PHASES_BF16 = ("wait_gather", "wait_mma", "wait_full", "issue", "gather_store", "epilogue")
PRODUCER_PHASES_BF16 = ("wait_empty", "load")


def phase_profile(weight: torch.Tensor, bias: torch.Tensor | None, x: torch.Tensor,
                  hw: tuple[int, int], plan: Bf16Plan | None = None) -> dict:
    """Mean clock cycles per block of one launch of bf16 kernel c's wgmma
    kernel (``plan``, by default ``bf16_wgmma_plan``'s) by phase, as
    thread 0 of a block's first consumer warpgroup (``PHASES_BF16``) and its
    producer warp's lane 0 (``PRODUCER_PHASES_BF16``) see them, and the block
    count.  Needs a CUDA card; a diagnostic, not on any path."""
    n = len(PHASES_BF16) + 1
    counters = torch.zeros(2 * n, dtype=torch.int64, device=x.device)
    plan = plan or bf16_wgmma_plan(x.shape[0], weight.shape[0], hw[0], hw[1], x.shape[1])
    with torch.inference_mode():
        _launch(weight, bias, x, hw, plan, counters)
    counts = counters.tolist()
    blocks = max(counts[n - 1], 1)
    out = {p: c / blocks for p, c in zip(PHASES_BF16, counts)}
    out.update({p: c / blocks for p, c in zip(PRODUCER_PHASES_BF16, counts[n:])})
    out["blocks"] = counts[n - 1]
    return out


def _forward(weight, bias, x, hw):
    if x.device.type == "cpu":
        return conv3x3_tl_plain(weight, bias, x, hw)
    return _launch(weight, bias, x, hw)


class _Conv3x3TL(torch.autograd.Function):
    """The convolution with its gradient.  The forward is kernel c on CUDA
    tensors and the plain version on CPU tensors; the backward is the
    standard convolution gradients in plain tensor code on both."""

    @staticmethod
    def forward(ctx, weight, bias, x, hw):
        ctx.save_for_backward(weight, bias, x)
        ctx.hw = hw
        return _forward(weight, bias, x, hw)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        weight, bias, x = ctx.saved_tensors
        dw = db = dx = None
        dimg = from_tl(dout, ctx.hw)
        if ctx.needs_input_grad[0]:
            dw = torch.nn.grad.conv2d_weight(
                from_tl(x, ctx.hw).float(), weight.shape, dimg.float(), padding=1
            ).to(weight.dtype)
        if bias is not None and ctx.needs_input_grad[1]:
            db = dout.float().sum(dim=(1, 2)).to(bias.dtype)
        if ctx.needs_input_grad[2]:
            b, _, h, w = dimg.shape
            dx_img = torch.nn.grad.conv2d_input(
                (b, weight.shape[1], h, w), weight.to(dout.dtype), dimg, padding=1)
            dx = to_tl(dx_img).to(x.dtype)
        return dw, db, dx, None


def conv3x3_tl(weight: torch.Tensor, bias: torch.Tensor | None, x: torch.Tensor,
               hw: tuple[int, int]) -> torch.Tensor:
    """3x3 stride-1 pad-1 convolution of ``x`` (Cin, B, H*W) with ``weight``
    (Cout, Cin, 3, 3) and ``bias`` (Cout) or None -> contiguous (Cout, B, H*W)
    in ``x``'s type.  Differentiable: where a gradient is needed the call
    goes through ``_Conv3x3TL``."""
    hw = (int(hw[0]), int(hw[1]))
    _check(weight, bias, x, hw)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no conv kernel for device {x.device}")
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or weight.requires_grad or (bias is not None and bias.requires_grad))
    if needs_grad:
        return _Conv3x3TL.apply(weight, bias, x, hw)
    return _forward(weight, bias, x, hw)
