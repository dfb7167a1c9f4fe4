"""Port transposed-layout convolutions (controlnet_tpu_torch.ops.tl_conv,
controlnet_tpu_torch.ops.cuda_conv) against the JAX package.

The same numpy arrays go through both.  On the CPU the port's ``conv3x3_tl``
is the plain version of its CUDA kernel; the JAX side is the Pallas kernel
``pallas_conv3x3_tl`` in interpret mode and the XLA einsum path
(``conv3x3_tl(use_pallas=False)``).  The JAX package keeps weights HWIO and
activations NHWC; the port OIHW and NCHW; both share the (C, B, L) layout.

Tolerances: float32 1e-5 of max|out| (sums of up to 9*Cin float32 products
in another order); bfloat16 3e-2 of max|out| (products of bf16-rounded
operands, one rounding of the sum; the JAX einsum and the port round at the
same places); gradients 1e-4 absolute, as tests/test_tl_parity.py holds the
Pallas VJP to the XLA path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlnet_tpu.ops import tl_conv as jax_tl
from controlnet_tpu.ops.pallas_conv import pallas_conv3x3_tl
from controlnet_tpu_torch.ops import cuda_conv, tl_conv

# (b, h, w, cin, cout): the shapes of tests/test_tl_parity.py's conv3x3 and
# Pallas tests, plus the hint encoder's 3-channel stem
CONV3_SHAPES = [(2, 8, 8, 8, 16), (3, 7, 5, 4, 8), (2, 8, 8, 1, 8), (4, 6, 7, 8, 16),
                (2, 8, 8, 3, 16)]


def _case(seed, b, h, w, cin, cout, k=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    bound = 1.0 / np.sqrt(cin * k * k)
    w_hwio = rng.uniform(-bound, bound, (k, k, cin, cout)).astype(np.float32)
    bias = rng.uniform(-bound, bound, (cout,)).astype(np.float32)
    return x, w_hwio, bias


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


def _x_tl(x_nhwc, dtype=torch.float32):
    """The port's (C, B, L) view of an NCHW tensor, as the hint encoder makes it."""
    nchw = torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))
    return tl_conv.to_tl(nchw.to(dtype))


def test_to_tl_from_tl_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 5, 4)).astype(np.float32)  # NHWC
    ref = np.asarray(jax_tl.to_tl(jnp.asarray(x)))
    out = _x_tl(x)
    assert out.shape == (4, 2, 15) and out.stride(2) == 1
    np.testing.assert_array_equal(out.numpy(), ref)
    back = tl_conv.from_tl(out, (3, 5))
    np.testing.assert_array_equal(back.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jax_tl.from_tl(jnp.asarray(ref), (3, 5))))
    # a contiguous (C, B, L) tensor comes back as a view, not a copy
    c = out.contiguous()
    assert tl_conv.from_tl(c, (3, 5)).data_ptr() == c.data_ptr()


@pytest.mark.parametrize("b,h,w,cin,cout", CONV3_SHAPES)
def test_conv3x3_tl_matches_pallas_and_xla(b, h, w, cin, cout):
    x, w_hwio, bias = _case(1, b, h, w, cin, cout)
    x_tl = jax_tl.to_tl(jnp.asarray(x))
    ref_xla = np.asarray(jax_tl.conv3x3_tl(jnp.asarray(w_hwio), jnp.asarray(bias), x_tl, (h, w),
                                           use_pallas=False))
    ref_pl = np.asarray(pallas_conv3x3_tl(jnp.asarray(w_hwio), jnp.asarray(bias), x_tl, (h, w),
                                          interpret=True))
    before = cuda_conv.launches
    out = tl_conv.conv3x3_tl(_oihw(w_hwio), torch.from_numpy(bias), _x_tl(x), (h, w))
    assert cuda_conv.launches == before  # a CPU tensor takes the plain version
    assert out.shape == (cout, b, h * w) and out.is_contiguous()
    tol = 1e-5 * np.abs(ref_xla).max()
    np.testing.assert_allclose(out.numpy(), ref_pl, rtol=0, atol=tol)
    np.testing.assert_allclose(out.numpy(), ref_xla, rtol=0, atol=tol)


def test_conv3x3_tl_without_bias():
    x, w_hwio, _ = _case(2, 2, 6, 6, 4, 8)
    ref = np.asarray(jax_tl.conv3x3_tl(jnp.asarray(w_hwio), None, jax_tl.to_tl(jnp.asarray(x)),
                                       (6, 6), use_pallas=False))
    out = tl_conv.conv3x3_tl(_oihw(w_hwio), None, _x_tl(x), (6, 6))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 8, 8, 8, 16), (2, 8, 8, 3, 16)])
def test_conv3x3_tl_bf16(b, h, w, cin, cout):
    """bf16 activations: weights cast to bf16, float32 sums and bias, one
    rounding at the end, as the Pallas kernel does."""
    x, w_hwio, bias = _case(3, b, h, w, cin, cout)
    x_tl = jax_tl.to_tl(jnp.asarray(x)).astype(jnp.bfloat16)
    ref = jax_tl.conv3x3_tl(jnp.asarray(w_hwio), jnp.asarray(bias), x_tl, (h, w), use_pallas=False)
    out = tl_conv.conv3x3_tl(_oihw(w_hwio), torch.from_numpy(bias), _x_tl(x, torch.bfloat16),
                             (h, w))
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=3e-2 * np.abs(ref).max())


def test_conv3x3_tl_gradients_match_jax_grad():
    """The autograd Function's plain backward against jax.grad of the Pallas
    kernel's custom VJP (interpret mode) and of the XLA path."""
    cin, cout, b, h, w = 8, 8, 2, 4, 4
    x, w_hwio, bias = _case(4, b, h, w, cin, cout)
    x_tl = jax_tl.to_tl(jnp.asarray(x))

    def loss_pl(w_, b_, x_):
        return (pallas_conv3x3_tl(w_, b_, x_, (h, w), interpret=True) ** 2).sum()

    def loss_xla(w_, b_, x_):
        return (jax_tl.conv3x3_tl(w_, b_, x_, (h, w), use_pallas=False) ** 2).sum()

    args = (jnp.asarray(w_hwio), jnp.asarray(bias), x_tl)
    g_pl = jax.grad(loss_pl, argnums=(0, 1, 2))(*args)
    g_xla = jax.grad(loss_xla, argnums=(0, 1, 2))(*args)

    wt = _oihw(w_hwio).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    xt = _x_tl(x).requires_grad_()
    out = tl_conv.conv3x3_tl(wt, bt, xt, (h, w))
    assert out.grad_fn.name().startswith("_Conv3x3TL")
    (out ** 2).sum().backward()
    got = (wt.grad.permute(2, 3, 1, 0).numpy(), bt.grad.numpy(), xt.grad.numpy())
    for mine, ref_pl, ref_xla in zip(got, g_pl, g_xla):
        np.testing.assert_allclose(mine, np.asarray(ref_pl), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(mine, np.asarray(ref_xla), rtol=1e-4, atol=1e-4)


def test_conv3x3_tl_gradient_only_where_needed():
    """Frozen weights (the sampling tools' case) take no gradient; x does."""
    x, w_hwio, bias = _case(5, 1, 4, 4, 2, 3)
    xt = _x_tl(x).requires_grad_()
    out = tl_conv.conv3x3_tl(_oihw(w_hwio), torch.from_numpy(bias), xt, (4, 4))
    out.sum().backward()
    ref = _x_tl(x).requires_grad_()
    cuda_conv.conv3x3_tl_plain(_oihw(w_hwio), torch.from_numpy(bias), ref, (4, 4)).sum().backward()
    torch.testing.assert_close(xt.grad, ref.grad, rtol=0, atol=1e-6)


@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 8, 8, 8, 16), (1, 12, 6, 4, 4), (2, 16, 16, 3, 16)])
def test_conv3x3s2_tl(b, h, w, cin, cout):
    x, w_hwio, bias = _case(6, b, h, w, cin, cout)
    ref = np.asarray(jax_tl.conv3x3s2_tl(jnp.asarray(w_hwio), jnp.asarray(bias),
                                         jax_tl.to_tl(jnp.asarray(x)), (h, w)))
    out = tl_conv.conv3x3s2_tl(_oihw(w_hwio), torch.from_numpy(bias), _x_tl(x), (h, w))
    assert out.shape == (cout, b, (h // 2) * (w // 2)) and out.stride(2) == 1
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_conv1x1_tl():
    x, w_hwio, bias = _case(7, 2, 6, 6, 8, 16, k=1)
    ref = np.asarray(jax_tl.conv1x1_tl(jnp.asarray(w_hwio), jnp.asarray(bias),
                                       jax_tl.to_tl(jnp.asarray(x))))
    out = tl_conv.conv1x1_tl(_oihw(w_hwio), torch.from_numpy(bias), _x_tl(x))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_flat_weight_is_the_pallas_kernels_order():
    """(Cout, 9*Cin), tap-major: what ``_conv3x3_fwd_impl`` feeds its kernel."""
    _, w_hwio, _ = _case(8, 1, 4, 4, 3, 5)
    ref = w_hwio.transpose(3, 0, 1, 2).reshape(5, 27)
    flat = cuda_conv.flat_weight(_oihw(w_hwio), torch.float32)
    assert flat.is_contiguous()
    np.testing.assert_array_equal(flat.numpy(), ref)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, w_hwio, bias = _case(9, 2, 4, 4, 3, 5)
    wt, bt = _oihw(w_hwio), torch.from_numpy(bias)
    channels_last = torch.from_numpy(x).permute(3, 0, 1, 2).reshape(3, 2, 16)  # pixel stride 3
    assert channels_last.stride(2) != 1
    with pytest.raises(ValueError, match="contiguous rows"):
        tl_conv.conv3x3_tl(wt, bt, channels_last, (4, 4))
    with pytest.raises(ValueError, match="does not match L"):
        tl_conv.conv3x3_tl(wt, bt, _x_tl(x), (4, 5))
    with pytest.raises(ValueError, match="channels"):
        tl_conv.conv3x3_tl(wt[:, :2], bt, _x_tl(x), (4, 4))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tl_conv.conv3x3_tl(wt, bt, _x_tl(x, torch.float16), (4, 4))
    with pytest.raises(ValueError, match="no conv kernel for device"):
        tl_conv.conv3x3_tl(wt.to("meta"), bt.to("meta"), _x_tl(x).to("meta"), (4, 4))


def test_launch_config_covers_the_hint_encoder_widths():
    assert [cuda_conv.launch_config(c) for c in (16, 32, 64, 128, 256, 512)] == [1, 2, 4, 4, 4, 4]
