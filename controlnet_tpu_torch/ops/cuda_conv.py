"""3x3 stride-1 pad-1 convolution in the transposed (C, B, L) layout: the
wrapper of ``csrc/conv3x3_tl.cu`` (kernel c) and its plain PyTorch version.

Counterpart of ``controlnet_tpu/ops/pallas_conv.py``'s ``pallas_conv3x3_tl``
(``_conv_kernel`` with its custom VJP).  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.  There is no fallback
from one to the other.  As in the JAX package the gradient is plain tensor
code (``torch.nn.grad``), on both devices.

Weights are ``(Cout, Cin, 3, 3)`` as ``nn.Conv2d`` holds them; the wrapper
flattens them to the kernel's ``(Cout, 9*Cin)`` tap-major order and casts
them to the activation's type.  The input may be any ``(C, B, L)`` view whose
rows of L values are contiguous (the ``to_tl`` view of an NCHW tensor is
one): the kernel reads it through its channel and batch strides, and no copy
is made.  The output is contiguous.

``launches`` counts launches of kernel c (never plain-version calls).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_GRID_LIMIT = 65535  # the kernel's grid carries the batch and the channel tiles in y and z


def from_tl(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """(C, B, H*W) -> (B, C, H, W); a view of a contiguous input."""
    c, b, _ = x.shape
    return x.permute(1, 0, 2).reshape(b, c, hw[0], hw[1])


def to_tl(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (C, B, H*W); a view of a contiguous input."""
    b, c, h, w = x.shape
    return x.reshape(b, c, h * w).permute(1, 0, 2)


def flat_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> contiguous (Cout, 9*Cin), tap-major
    (column = (3*ky + kx) * Cin + c), in ``dtype``."""
    cout, cin = weight.shape[:2]
    return weight.permute(0, 2, 3, 1).reshape(cout, 9 * cin).to(dtype).contiguous()


def conv3x3_tl_plain(weight: torch.Tensor, bias: torch.Tensor | None, x: torch.Tensor,
                     hw: tuple[int, int]) -> torch.Tensor:
    """Plain version of the kernel, with its arithmetic: the weights rounded
    to the activation's type, float32 products and sums, a float32 bias, one
    rounding at the end.  (C, B, L) in, contiguous (Cout, B, L) out."""
    w32 = weight.to(x.dtype).float()
    b32 = None if bias is None else bias.float()
    out = F.conv2d(from_tl(x, hw).float(), w32, b32, stride=1, padding=1)
    return to_tl(out.to(x.dtype)).contiguous()


def launch_config(cout: int) -> int:
    """Output-channel groups per block (16 channels each): 1, 2 or 4, the
    fewest that cover ``cout`` up to the kernel's 64 channels a block.  The
    block's tile of pixels is 32 wide and 32 / groups high."""
    return 1 if cout <= 16 else 2 if cout <= 32 else 4


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
            hw: tuple[int, int]) -> torch.Tensor:
    """Kernel c on a CUDA tensor."""
    global launches
    from controlnet_tpu_torch.ops import _build

    cin, b, l = x.shape
    cout = weight.shape[0]
    cog = launch_config(cout)
    if b > _GRID_LIMIT or -(-cout // (16 * cog)) > _GRID_LIMIT:
        raise ValueError(f"batch {b} or Cout {cout} beyond the kernel's grid")
    w_flat = flat_weight(weight, x.dtype)
    b32 = (torch.zeros(cout, dtype=torch.float32, device=x.device) if bias is None
           else bias.float().contiguous())
    out = torch.empty((cout, b, l), dtype=x.dtype, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.controlnet_conv3x3_tl(
            x.data_ptr(), w_flat.data_ptr(), b32.data_ptr(), out.data_ptr(),
            cin, cout, b, hw[0], hw[1], x.stride(0), x.stride(1),
            _DTYPE_CODE[x.dtype], cog,
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
