"""The CIFAR-10 configuration (config/cifar.yaml) on the port: attention at
head dims past 64, a narrow CIFAR-shaped ControlNet against the JAX package,
and the full-width model built on the CPU.

config/cifar.yaml's 512-channel levels run attention at 4 heads, head dim
128 (L 64), where the kernels stopped at 64 before.  The plain versions of
kernels a and b are shape-generic; they are held to the Pallas kernel in
interpret mode (``fused_attention_t(..., interpret=True)``, and ``jax.grad``
of it, whose backward is ``_attn_bwd_kernel_t``) at head dims 96 and 128,
atol 2e-5 forward and 3e-5 backward, the limits of
``test_torch_port_attention.py`` and ``test_torch_port_train.py``.

The narrow ControlNet keeps a 512-wide level at 4 heads (down_channels [32,
64, 512] at 16x16, one layer a block), so the attention layer of that
level reaches head dim 128 in the control copy and in the trunk.  Forward: 1e-4
of max|out|.  Three ControlNet train steps with t, noise and the
condition-drop mask injected from the JAX step's key discipline: the limits
of ``test_torch_port_train.py`` (losses rtol 1e-5, weights above the noise
floor within 1e-2 lr).  The 512-wide convolutions (fan-in 4,608) take many
gradients below the noise floor: 13-17% of the trainable weights here,
against under 10% at the MNIST test widths, so at least 80% of the weights
are held.

The full-width ControlNet is built and run on the CPU at batch 1 (no JAX
forward, to keep the test light): its output shape, its parameter count
against the JAX tree's, and its attention calls (26 a forward, 8 at head dim
128; the backward calls of a training step), which ``chip_smoke.py`` holds
the kernels' launch counters to.
"""

import collections
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_util import random_params, to_nchw, to_nhwc
from controlnet_tpu.models.controlnet import ControlNet as JaxControlNet
from controlnet_tpu.ops import pallas_attention as jax_pa
from controlnet_tpu.schedules.linear import make_linear_schedule as jax_schedule
from controlnet_tpu.train.loops import make_controlnet_train_step as jax_cn_step
from controlnet_tpu.train.state import create_train_state as jax_train_state
from controlnet_tpu_torch import config as port_config
from controlnet_tpu_torch.io import jax_params
from controlnet_tpu_torch.models.controlnet import ControlNet
from controlnet_tpu_torch.ops import cuda_attention
from controlnet_tpu_torch.schedules.linear import make_linear_schedule
from controlnet_tpu_torch.train.loops import make_controlnet_train_step
from controlnet_tpu_torch.train.state import create_train_state
from test_torch_port_train import LR, T, _jax_draws, _noisy_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_ATOL = 2e-5
BWD_ATOL = 3e-5

# config/cifar.yaml in structure at its widest level (512 channels, 4 heads:
# head dim 128), cut in levels, width below it, image size and layers
NARROW_CIFAR = dict(
    im_channels=3,
    im_size=16,
    hint_channels=3,
    down_channels=[32, 64, 512],
    mid_channels=[512, 64],
    down_sample=[True, False],
    time_emb_dim=32,
    num_down_layers=1,
    num_mid_layers=1,
    num_up_layers=1,
    num_heads=4,
)


def _qkvw(seed, b, h, dh, lq, lk):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s, dtype=np.float32)
                 for s in ((b, h, dh, lq), (b, h, dh, lk), (b, h, dh, lk), (b, h, dh, lq)))


WIDE_SHAPES = [(64, 64, 128), (64, 64, 96), (64, 49, 128)]
WIDE_IDS = ["L64-dh128", "L64-dh96", "cross-Lq64-Lk49-dh128"]


@pytest.mark.parametrize("lq,lk,dh", WIDE_SHAPES, ids=WIDE_IDS)
def test_attention_plain_matches_pallas_interpret_past_dh64(lq, lk, dh):
    q, k, v, _ = _qkvw(dh + lk, 2, 2, dh, lq, lk)
    ref = np.asarray(jax_pa.fused_attention_t(*(jnp.asarray(x) for x in (q, k, v)),
                                              interpret=True))
    out = cuda_attention.fused_attention_t(*(torch.from_numpy(x) for x in (q, k, v)))
    assert out.shape == (2, 2, dh, lq)
    np.testing.assert_allclose(out.numpy(), ref, atol=FWD_ATOL)


@pytest.mark.parametrize("lq,lk,dh", WIDE_SHAPES, ids=WIDE_IDS)
def test_attention_grad_matches_pallas_interpret_past_dh64(lq, lk, dh):
    """The plain backward and the port's autograd Function on CPU tensors
    against jax.grad of the Pallas kernel."""
    q, k, v, w = _qkvw(dh + lk + 1, 2, 2, dh, lq, lk)

    def loss(q, k, v):
        return jnp.sum(jax_pa.fused_attention_t(q, k, v, interpret=True) * w)

    ref = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))]
    plain = cuda_attention.fused_attention_t_bwd_plain(*(torch.from_numpy(x)
                                                         for x in (q, k, v, w)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (cuda_attention.fused_attention_t(qt, kt, vt) * torch.from_numpy(w)).sum().backward()
    for p, a, r in zip(plain, (qt.grad, kt.grad, vt.grad), ref):
        np.testing.assert_allclose(p.numpy(), r, atol=BWD_ATOL)
        np.testing.assert_allclose(a.numpy(), r, atol=BWD_ATOL)


def _carried(cfg, seed):
    jcn = JaxControlNet(cfg["im_channels"], cfg)
    p = random_params(jcn, seed)
    cn = ControlNet(cfg["im_channels"], cfg)
    cn.load_state_dict(jax_params.controlnet_state_dict_from_jax(p), strict=True)
    return jcn, p, cn


def _data(seed, b, size):
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, size=(b, size, size, 3)).astype(np.float32)
    hints = (rng.uniform(size=(b, size, size, 3)) < 0.2).astype(np.float32)
    return images, hints


def test_narrow_cifar_controlnet_forward_matches_jax(monkeypatch):
    cfg = NARROW_CIFAR
    jcn, p, cn = _carried(cfg, 3)
    images, hints = _data(3, 2, cfg["im_size"])
    t = np.array([7, 912])
    ref = np.asarray(jax.jit(jcn.__call__)(p, jnp.asarray(images), jnp.asarray(t),
                                           jnp.asarray(hints)))
    dims = collections.Counter()
    orig = cuda_attention.fused_attention_t

    def spy(qt, kt, vt):
        dims[qt.shape[2]] += 1
        return orig(qt, kt, vt)

    monkeypatch.setattr(cuda_attention, "fused_attention_t", spy)
    with torch.no_grad():
        out = cn.eval()(to_nchw(images), torch.from_numpy(t), to_nchw(hints))
    assert dims[128] == 2  # the 512-wide down block of the control copy and of the trunk
    scale = np.abs(ref).max()
    assert np.abs(to_nhwc(out) - ref).max() <= 1e-4 * scale


def _compare_params(sd_port, sd_ref, before, noisy):
    clean, total, upd = [], 0, 0.0
    for k, low in noisy.items():
        p, r, b0 = sd_port[k].numpy(), sd_ref[k].numpy(), before[k].numpy()
        clean.append(np.abs(p - r)[~low.numpy()])
        total += p.size
        upd = max(upd, float(np.abs(r - b0).max()))
    clean = np.concatenate(clean)
    assert upd > 0.5 * LR  # the steps moved the weights
    assert clean.size >= 0.8 * total, clean.size / total
    assert clean.max() < 1e-2 * LR, clean.max() / LR


def test_narrow_cifar_controlnet_train_steps_match_jax():
    """Three steps, f32, with the condition-drop mask: losses, weights after."""
    cfg, drop = NARROW_CIFAR, 0.5
    b, size = 2, cfg["im_size"]
    jcn, p, cn = _carried(cfg, 4)
    trainable_j, frozen_j = jcn.split_params(p)
    tx = optax.adam(LR)
    jstate = jax_train_state(trainable_j, tx)
    jstep = jax_cn_step(jcn, jax_schedule(T, 1e-4, 0.02), tx, cfg_drop_prob=drop)

    trainable, frozen = cn.freeze_trunk()
    before = {k: v.clone() for k, v in cn.state_dict().items()}
    state = create_train_state(trainable, LR)
    step = make_controlnet_train_step(cn, make_linear_schedule(T, 1e-4, 0.02, device="cpu"),
                                      cfg_drop_prob=drop)
    key, noisy = jax.random.PRNGKey(31), None
    for i in range(3):
        images, hints = _data(50 + i, b, size)
        key, sk = jax.random.split(key)
        jstate, jloss = jstep(jstate, frozen_j, jnp.asarray(images), jnp.asarray(hints), sk)
        t, noise, keep = _jax_draws(sk, images.shape, drop)
        loss = step(state, to_nchw(images), to_nchw(hints), t=torch.from_numpy(t),
                    noise=to_nchw(noise), keep=torch.from_numpy(keep))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        noisy = _noisy_weights(state, noisy)
    ref = jax_params.controlnet_state_dict_from_jax(
        jax.tree.map(np.asarray, jcn.merge_params(jstate.params, frozen_j)))
    sd = cn.state_dict()
    _compare_params(sd, ref, before, noisy)
    for k in frozen:
        assert torch.equal(sd[k], before[k]), k


# the attention calls of a full-width config/cifar.yaml ControlNet, (L, head dim):
# kernel a per forward, kernel b per training step (the frozen down path and
# mid block 0 of the trunk record no graph)
CIFAR_FORWARD_CALLS = {(1024, 32): 4, (1024, 4): 2, (256, 64): 4, (256, 16): 2, (64, 128): 8,
                       (64, 64): 4, (64, 32): 2}
CIFAR_BACKWARD_CALLS = {(1024, 32): 2, (1024, 4): 2, (256, 64): 2, (256, 16): 2, (64, 128): 4,
                        (64, 64): 4, (64, 32): 2}


def test_full_width_cifar_controlnet_on_the_cpu(monkeypatch):
    """config/cifar.yaml at full width: the forward at batch 1 (shape,
    finite), the parameter count equal to the JAX tree's, and the attention
    calls of a forward and of a training step."""
    mp = port_config.model_params(port_config.load_config(
        os.path.join(REPO, "config", "cifar.yaml")))
    shapes = jax.eval_shape(JaxControlNet(mp["im_channels"], mp).init, jax.random.PRNGKey(0))
    jax_count = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    torch.manual_seed(0)
    cn = ControlNet(mp["im_channels"], mp)
    assert sum(p.numel() for p in cn.parameters()) == jax_count
    assert sum(p.numel() for p in cn.trained_unet.parameters()) > 39_000_000

    fwd, bwd = collections.Counter(), collections.Counter()
    orig_fwd = cuda_attention.fused_attention_t
    orig_bwd = cuda_attention.fused_attention_t_bwd_plain

    def spy_fwd(qt, kt, vt):
        fwd[(qt.shape[3], qt.shape[2])] += 1
        return orig_fwd(qt, kt, vt)

    def spy_bwd(qt, kt, vt, dout):
        bwd[(qt.shape[3], qt.shape[2])] += 1
        return orig_bwd(qt, kt, vt, dout)

    monkeypatch.setattr(cuda_attention, "fused_attention_t", spy_fwd)
    monkeypatch.setattr(cuda_attention, "fused_attention_t_bwd_plain", spy_bwd)
    images, hints = _data(9, 1, 32)
    with torch.no_grad():
        out = cn(to_nchw(images), torch.tensor([500]), to_nchw(hints))
    assert out.shape == (1, 3, 32, 32) and bool(torch.isfinite(out).all())
    assert fwd == CIFAR_FORWARD_CALLS and sum(fwd.values()) == 26
    fwd.clear()
    trainable, _ = cn.freeze_trunk()
    step = make_controlnet_train_step(cn, make_linear_schedule(1000, 1e-4, 0.02, device="cpu"))
    loss = step(create_train_state(trainable, LR), to_nchw(images), to_nchw(hints),
                torch.Generator().manual_seed(0))
    assert torch.isfinite(loss)
    assert fwd == CIFAR_FORWARD_CALLS
    assert bwd == CIFAR_BACKWARD_CALLS and sum(bwd.values()) == 18
