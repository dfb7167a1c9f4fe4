"""Port UNet and ControlNet (controlnet_tpu_torch.models) against the JAX
package, with JAX weights carried across by controlnet_tpu_torch.io.jax_params.

JAX runs jitted on the CPU in float32 matmul precision (tests/conftest.py);
the port runs on the CPU, where attention takes its plain version.
Tolerance: atol 1e-4 on outputs of magnitude ~1 (dozens of float32
convolutions and reductions, summed in another order by each framework).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import MNIST_CONFIG, random_params, to_nchw, to_nhwc
from controlnet_tpu.models.controlnet import ControlNet as JaxControlNet
from controlnet_tpu.models.unet import UNet as JaxUNet
from controlnet_tpu_torch.io import jax_params
from controlnet_tpu_torch.models.controlnet import ControlNet
from controlnet_tpu_torch.models.unet import UNet
from controlnet_tpu_torch.ops import cuda_attention

ATOL = 1e-4


def _inputs(seed, b, size, hint_channels=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, size, size, 1)).astype(np.float32)
    hint = rng.uniform(size=(b, size, size, hint_channels)).astype(np.float32)
    t = rng.integers(0, 1000, size=(b,))
    return x, hint, t


def _carried_controlnet(cfg, seed):
    jcn = JaxControlNet(cfg["im_channels"], cfg)
    p = random_params(jcn, seed)
    cn = ControlNet(cfg["im_channels"], cfg)
    cn.load_state_dict(jax_params.controlnet_state_dict_from_jax(p), strict=True)
    return jcn, p, cn.eval()


def test_unet_matches_jax(tiny_model_config):
    cfg = tiny_model_config
    ju = JaxUNet(cfg["im_channels"], cfg)
    p = random_params(ju, 0)
    unet = UNet(cfg["im_channels"], cfg)
    unet.load_state_dict(jax_params.unet_state_dict_from_jax(p), strict=True)
    x, _, t = _inputs(0, 2, cfg["im_size"])
    ref = np.asarray(jax.jit(ju.__call__)(p, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        out = unet(to_nchw(x), torch.from_numpy(t))
    assert out.shape == (2, 1, cfg["im_size"], cfg["im_size"])
    np.testing.assert_allclose(to_nhwc(out), ref, atol=ATOL)


def test_controlnet_matches_jax(tiny_model_config):
    cfg = tiny_model_config
    jcn, p, cn = _carried_controlnet(cfg, 1)
    x, hint, t = _inputs(1, 2, cfg["im_size"])
    ref = np.asarray(jax.jit(jcn.__call__)(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(hint)))
    with torch.no_grad():
        out = cn(to_nchw(x), torch.from_numpy(t), to_nchw(hint))
        out_f = cn(to_nchw(x), torch.from_numpy(t), hint_features=cn.hint_features(to_nchw(hint)))
    np.testing.assert_allclose(to_nhwc(out), ref, atol=ATOL)
    torch.testing.assert_close(out_f, out, rtol=0, atol=0)


def test_controlnet_full_mnist_width_matches_jax():
    """One forward at the full MNIST width (config/mnist.yaml), batch 1;
    random weights (every zero conv nonzero) carried into the port."""
    cfg = MNIST_CONFIG
    jcn, p, cn = _carried_controlnet(cfg, 2)
    x, hint, t = _inputs(2, 1, 28)
    ref = np.asarray(jax.jit(jcn.__call__)(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(hint)))
    with torch.no_grad():
        out = cn(to_nchw(x), torch.from_numpy(t), to_nchw(hint))
    assert out.shape == (1, 1, 28, 28)
    np.testing.assert_allclose(to_nhwc(out), ref, atol=ATOL)


def test_full_width_forward_makes_26_attention_calls(monkeypatch):
    """The main path's attention mix: 26 calls per ControlNet forward at
    seven (L, head_dim) shapes (16 in the frozen UNet, 10 in the control
    copy).  chip_smoke.py holds the kernel's launch counter to the same 26."""
    calls = collections.Counter()
    orig = cuda_attention.fused_attention_t

    def spy(qt, kt, vt):
        calls[(qt.shape[3], qt.shape[2])] += 1
        return orig(qt, kt, vt)

    monkeypatch.setattr(cuda_attention, "fused_attention_t", spy)
    cn = ControlNet(1, MNIST_CONFIG).eval()
    with torch.no_grad():
        cn(torch.zeros(1, 1, 28, 28), torch.tensor([5]), torch.zeros(1, 3, 28, 28))
    assert calls == {(784, 16): 4, (784, 4): 2, (196, 32): 4, (196, 8): 2,
                     (49, 64): 8, (49, 32): 4, (49, 16): 2}
    assert sum(calls.values()) == 26


def test_zero_conv_identity(tiny_model_config):
    """At init every zero conv outputs 0: ControlNet == its base UNet."""
    cfg = tiny_model_config
    torch.manual_seed(0)
    unet = UNet(cfg["im_channels"], cfg).eval()
    cn = ControlNet(cfg["im_channels"], cfg).eval()
    cn.init_from_unet(unet.state_dict())
    x, hint, t = _inputs(3, 2, cfg["im_size"])
    with torch.no_grad():
        out = cn(to_nchw(x), torch.from_numpy(t), to_nchw(hint))
        base = unet(to_nchw(x), torch.from_numpy(t))
    torch.testing.assert_close(out, base, rtol=0, atol=0)


@pytest.mark.parametrize("locked", [True, False])
def test_split_params(tiny_model_config, locked):
    cn = ControlNet(1, tiny_model_config, model_locked=locked)
    trainable, frozen = cn.split_params()
    names = dict(cn.named_parameters())
    assert set(trainable) | set(frozen) == set(names) and not set(trainable) & set(frozen)
    assert all(k.startswith("trained_unet.") for k in frozen)
    assert any(k.startswith("control_copy_unet_hint_block.") for k in trainable)
    decoder_trains = any(k.startswith("trained_unet.ups.") for k in trainable)
    assert decoder_trains == (not locked)


def test_frozen_trunk_takes_no_gradient(tiny_model_config):
    """The frozen down path runs under no_grad; its mids and decoder do not,
    so gradients reach the control branch through them."""
    cfg = tiny_model_config
    _, _, cn = _carried_controlnet(cfg, 4)
    x, hint, t = _inputs(4, 2, cfg["im_size"])
    cn.zero_grad()
    cn(to_nchw(x), torch.from_numpy(t), to_nchw(hint)).sum().backward()
    grads = {k: p.grad for k, p in cn.named_parameters()}
    assert grads["trained_unet.conv_in.weight"] is None
    assert grads["trained_unet.downs.0.resnet_conv_first.0.2.weight"] is None
    assert grads["trained_unet.mids.0.resnet_conv_first.0.2.weight"] is not None
    assert grads["control_copy_unet.conv_in.weight"] is not None
