"""Port layers and blocks (controlnet_tpu_torch.nn) against the JAX package,
with the JAX parameters carried across by controlnet_tpu_torch.io.jax_params.

Inputs come from a numpy seed; JAX runs on the CPU in float32 matmul
precision (tests/conftest.py).  Tolerances: 1e-5 for single layers, 5e-5 for
blocks (a few float32 convolutions and reductions summed in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import load_block, np_tree, random_params, to_nchw, to_nhwc
from controlnet_tpu.nn import blocks as jax_blocks
from controlnet_tpu.nn import layers as jax_layers
from controlnet_tpu_torch.io import jax_params
from controlnet_tpu_torch.nn import blocks, layers


def _rng(seed):
    return np.random.default_rng(seed)


def _load(module, fill, jax_p):
    sd = {}
    fill(np_tree(jax_p), "m", sd)
    module.load_state_dict(jax_params._to_torch({k[2:]: v for k, v in sd.items()}), strict=True)
    return module


@pytest.mark.parametrize("mean", [0.0, 3.0], ids=["centered", "offset"])
def test_group_norm_single_pass_stats(mean):
    """JAX GroupNorm is single-pass E[x^2]-E[x]^2 in f32 (nn/layers.py:252-269)."""
    jg = jax_layers.GroupNorm(4, 16)
    p = {"scale": jnp.asarray(_rng(0).standard_normal(16), jnp.float32),
         "bias": jnp.asarray(_rng(1).standard_normal(16), jnp.float32)}
    x = (_rng(2).standard_normal((2, 5, 7, 16)) * 2.0 + mean).astype(np.float32)
    ref = np.asarray(jg(p, jnp.asarray(x)))
    gn = _load(layers.GroupNorm(4, 16), jax_params._norm, p)
    with torch.no_grad():
        out = gn(to_nchw(x))
    np.testing.assert_allclose(to_nhwc(out), ref, atol=1e-5)


def test_group_norm_keeps_bf16():
    gn = layers.GroupNorm(2, 8)
    x = torch.randn(2, 8, 4, 4).bfloat16()
    assert gn(x).dtype == torch.bfloat16


def test_conv_transpose_flipped_kernel_layout():
    """The JAX kernel is stored flipped (io/torch_export.py:41-44)."""
    jc = jax_layers.ConvTranspose2d(6, 5)
    p = jc.init(jax.random.PRNGKey(0))
    x = _rng(3).standard_normal((2, 7, 7, 6)).astype(np.float32)
    ref = np.asarray(jc(p, jnp.asarray(x)))
    ct = _load(layers.ConvTranspose2d(6, 5, 4, 2, 1), jax_params._conv_transpose, p)
    with torch.no_grad():
        out = ct(to_nchw(x))
    assert out.shape == (2, 5, 14, 14)
    np.testing.assert_allclose(to_nhwc(out), ref, atol=1e-5)


@pytest.mark.parametrize("k,stride,pad", [(3, 1, None), (1, 1, None), (4, 2, 1)])
def test_conv2d(k, stride, pad):
    jc = jax_layers.Conv2d(3, 8, k, stride=stride, padding=pad)
    p = jc.init(jax.random.PRNGKey(1))
    x = _rng(4).standard_normal((2, 8, 8, 3)).astype(np.float32)
    ref = np.asarray(jc(p, jnp.asarray(x)))
    conv = _load(layers.Conv2d(3, 8, k, stride=stride, padding=pad), jax_params._conv, p)
    with torch.no_grad():
        out = conv(to_nchw(x))
    np.testing.assert_allclose(to_nhwc(out), ref, atol=1e-5)


def test_linear():
    jl = jax_layers.Linear(12, 7)
    p = jl.init(jax.random.PRNGKey(2))
    x = _rng(5).standard_normal((3, 12)).astype(np.float32)
    lin = _load(layers.Linear(12, 7), jax_params._linear, p)
    with torch.no_grad():
        out = lin(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jl(p, jnp.asarray(x))), atol=1e-5)


@pytest.mark.parametrize("t", [[0, 1, 999], [17]])
def test_time_embedding(t):
    ref = np.asarray(jax_layers.get_time_embedding(jnp.asarray(t), 128))
    out = layers.get_time_embedding(torch.tensor(t), 128)
    assert out.dtype == torch.float32 and out.shape == (len(t), 128)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)


# --- blocks at tests/conftest.py::TINY_MODEL_CONFIG widths --------------------

def _block_io(seed, c, hw=8, temb=8):
    rng = _rng(seed)
    x = rng.standard_normal((2, hw, hw, c)).astype(np.float32)
    t_emb = rng.standard_normal((2, temb)).astype(np.float32)
    return x, t_emb


@pytest.mark.parametrize("down_sample", [True, False])
def test_down_block(tiny_model_config, down_sample):
    cfg = tiny_model_config
    args = dict(in_ch=8, out_ch=16, t_emb_dim=cfg["time_emb_dim"], down_sample=down_sample,
                num_heads=cfg["num_heads"], num_layers=2, attn=True, norm_channels=8)
    jb = jax_blocks.DownBlock(**args)
    p = random_params(jb, 3)
    x, t_emb = _block_io(6, 8)
    ref = np.asarray(jb(p, jnp.asarray(x), jnp.asarray(t_emb)))
    blk = blocks.DownBlock(**args)
    load_block(blk, p)
    with torch.no_grad():
        out = blk(to_nchw(x), torch.from_numpy(t_emb))
    np.testing.assert_allclose(to_nhwc(out), ref, atol=5e-5)


def test_mid_block(tiny_model_config):
    cfg = tiny_model_config
    args = dict(in_ch=16, out_ch=8, t_emb_dim=cfg["time_emb_dim"], num_heads=cfg["num_heads"],
                num_layers=2, norm_channels=8)
    jb = jax_blocks.MidBlock(**args)
    p = random_params(jb, 4)
    x, t_emb = _block_io(7, 16, hw=4)
    ref = np.asarray(jb(p, jnp.asarray(x), jnp.asarray(t_emb)))
    blk = blocks.MidBlock(**args)
    load_block(blk, p)
    with torch.no_grad():
        out = blk(to_nchw(x), torch.from_numpy(t_emb))
    np.testing.assert_allclose(to_nhwc(out), ref, atol=5e-5)


@pytest.mark.parametrize("up_sample", [True, False])
def test_up_block(tiny_model_config, up_sample):
    cfg = tiny_model_config
    args = dict(in_ch=32, out_ch=16, t_emb_dim=cfg["time_emb_dim"], up_sample=up_sample,
                num_heads=cfg["num_heads"], num_layers=1, attn=True, norm_channels=8,
                upsample_ch=16)
    jb = jax_blocks.UpBlock(**args)
    p = random_params(jb, 5)
    x, t_emb = _block_io(8, 16, hw=4)
    hw = 8 if up_sample else 4
    skip = _rng(9).standard_normal((2, hw, hw, 16)).astype(np.float32)
    ref = np.asarray(jb(p, jnp.asarray(x), jnp.asarray(skip), jnp.asarray(t_emb)))
    blk = blocks.UpBlock(**args)
    load_block(blk, p)
    with torch.no_grad():
        out = blk(to_nchw(x), to_nchw(skip), torch.from_numpy(t_emb))
    np.testing.assert_allclose(to_nhwc(out), ref, atol=5e-5)


def test_block_bf16_stays_bf16(tiny_model_config):
    """A bf16 activation stays bf16 through a block (the f32 time-embedding
    term is cast, as in the JAX package)."""
    blk = blocks.DownBlock(8, 16, 8, True, 2, 1, True, 8)
    with torch.no_grad():
        out = blk(torch.randn(2, 8, 8, 8).bfloat16(), torch.randn(2, 8))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 16, 4, 4)
