"""3x3 stride-1 pad-1 convolution in the transposed (C, B, L) layout: the
wrapper of ``csrc/conv3x3_tl.cu`` (kernel c: float32 on the CUDA cores,
bfloat16 on the tensor cores in ``csrc/conv3x3_tl_bf16.cu``) and its plain
PyTorch version.

Counterpart of ``controlnet_tpu/ops/pallas_conv.py``'s ``pallas_conv3x3_tl``
(``_conv_kernel`` with its custom VJP).  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.  There is no fallback
from one to the other.  As in the JAX package the gradient is plain tensor
code (``torch.nn.grad``), on both devices.

Weights are ``(Cout, Cin, 3, 3)`` as ``nn.Conv2d`` holds them; the wrapper
lays them out for the kernel: for float32 the K-major ``(9*Cin, Npad)``
matrix of the implicit GEMM (``k_major_weight``; at Cin 1 the kernel reads
the weight as held instead, as that matrix would be its transpose), for
bfloat16 the ``(Cout, 9*Cin)`` tap-major order cast to bf16 with Cin padded
with zero channels to a multiple of 16, the tensor-core kernel's slab
(``flat_weight``).  The float32 kernel's tile configuration and its split
over the input channels come from ``f32_launch_plan``.  The input may
be any ``(C, B, L)`` view whose rows of L values are contiguous (the
``to_tl`` view of an NCHW tensor is one): the kernel reads it through its
channel and batch strides, and no copy is made.  The output is contiguous.

``launches`` counts launches of kernel c (never plain-version calls).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_GRID_LIMIT = 65535  # grid y and z: the bf16 kernel's channel tiles and batch, the f32 splits
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
# The bf16 kernel (csrc/conv3x3_tl_bf16.cu): output pixels of a block (rows,
# columns of one image), input channels per slab, double-buffered stages.
MMA_PIXEL_TILE = (8, 32)
MMA_SLAB = 16
MMA_STAGES = 2
MAX_SHARED_BYTES = 232448  # a block's shared memory on an H100


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
    ``channel_multiple``, the extra channels zero."""
    cout, cin = weight.shape[:2]
    taps = weight.permute(0, 2, 3, 1).to(dtype)
    pad = -cin % channel_multiple
    if pad:
        taps = F.pad(taps, (0, pad))
    return taps.reshape(cout, 9 * (cin + pad)).contiguous()


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


def launch_config(cout: int) -> int:
    """Output-channel groups per block (16 channels each) of the bf16
    kernel: 1, 2 or 4, the fewest that cover ``cout`` up to its 64 channels a
    block."""
    return 1 if cout <= 16 else 2 if cout <= 32 else 4


def mma_launch_config(cin: int, cout: int, h: int, w: int,
                      b: int) -> tuple[tuple[int, int], int, int, int]:
    """(pixel tile, channel tile, stages, shared bytes) of the bf16 kernel:
    8 x 32 output pixels and 16, 32 or 64 output channels a block (as
    ``launch_config``; ragged H, W and Cout are masked), and per stage the
    (10 x 34)-pixel halo tile of one 16-channel slab, pixel-major at a
    24-value pitch, beside the slab's (channels, 9 taps x 16) weights at a
    152-value pitch, in bf16 (pitches as ``row_pitch`` in
    csrc/mma_attention.cuh).  Raises where the grid cannot hold the call."""
    th, tw = MMA_PIXEL_TILE
    tco = 16 * launch_config(cout)
    tiles = -(-h // th) * -(-w // tw)
    if tiles > _GRID_X_LIMIT or -(-cout // tco) > _GRID_LIMIT or b > _GRID_LIMIT:
        raise ValueError(f"conv of {cin}->{cout} @{h}x{w} B {b} beyond the kernel's grid")
    stage = (th + 2) * (tw + 2) * (MMA_SLAB + 8) + tco * (9 * MMA_SLAB + 8)
    return (th, tw), tco, MMA_STAGES, 2 * MMA_STAGES * stage


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
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"conv kernel takes float32 or bfloat16, not {x.dtype}")
    if weight.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError("weights, bias and x must be on one device")
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"expected a ({weight.shape[0]},) bias, got {tuple(bias.shape)}")
    if x.shape[2] != 1 and x.stride(2) != 1:
        raise ValueError(f"x must have contiguous rows of L values, got strides {x.stride()}")


def _launch(weight: torch.Tensor, bias: torch.Tensor | None, x: torch.Tensor,
            hw: tuple[int, int], plan: F32Plan | None = None) -> torch.Tensor:
    """Kernel c on a CUDA tensor; float32 takes ``plan``, by default
    ``f32_launch_plan``'s."""
    global launches
    from controlnet_tpu_torch.ops import _build

    cin, b, l = x.shape
    cout = weight.shape[0]
    partial = None
    if x.dtype == torch.bfloat16:
        cog = launch_config(cout)
        if b > _GRID_LIMIT or -(-cout // (16 * cog)) > _GRID_LIMIT:
            raise ValueError(f"batch {b} or Cout {cout} beyond the kernel's grid")
        mma_launch_config(cin, cout, hw[0], hw[1], b)  # raises beyond the grid
        w_mat = flat_weight(weight, x.dtype, MMA_SLAB)
        tile_m = tile_n = threads = splits = held = 0
    else:
        plan = plan or f32_launch_plan(cin, cout, hw[0], hw[1], b)
        if (b - 1) * x.stride(1) + l > _INT32_MAX:
            raise ValueError(f"x{tuple(x.shape)} at strides {x.stride()} beyond the kernel's "
                             "32-bit offsets in a channel plane")
        w_mat = (weight.float().contiguous() if plan.weights_as_held
                 else k_major_weight(weight, plan.n_pad))
        tile_m, tile_n, threads = plan.tile[:3]
        cog, splits, held = 0, plan.splits, int(plan.weights_as_held)
        if splits > 1:
            partial = torch.empty((splits, cout, b * l), dtype=torch.float32, device=x.device)
    b32 = (torch.zeros(cout, dtype=torch.float32, device=x.device) if bias is None
           else bias.float().contiguous())
    out = torch.empty((cout, b, l), dtype=x.dtype, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.controlnet_conv3x3_tl(
            x.data_ptr(), w_mat.data_ptr(), b32.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            cin, cout, b, hw[0], hw[1], x.stride(0), x.stride(1),
            _DTYPE_CODE[x.dtype], cog, tile_m, tile_n, threads, splits, held,
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"conv kernel launch failed: cudaError {err} "
                           f"(x{tuple(x.shape)} w{tuple(weight.shape)} {x.dtype})")
    launches += 1
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
