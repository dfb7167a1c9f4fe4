"""The port's training slice (controlnet_tpu_torch.train, the attention
gradient, checkpoints, batching, the trainer tools) against the JAX package.

Attention gradients: the port's plain backward and its autograd Function on
CPU tensors against ``jax.grad`` of the Pallas kernel in interpret mode
(``fused_attention_t(..., interpret=True)``, the custom VJP whose backward is
``_attn_bwd_kernel_t``), atol 3e-5 in float32 as the JAX package's own
backward tests use.

Train steps: three steps from the same carried-over weights with Adam from
zero on both sides.  JAX threefry and torch generators never agree, so the
test replays the JAX step's key discipline (train/loops.py) and injects t,
the noise and the condition-drop mask into the port's step.  Adam moves a
weight by about lr per step whatever its gradient's size, so a wrong
gradient shows as an O(lr) difference, and a gradient at float32's noise
floor (|g| < 1e-6, e.g. the key bias of attention, whose true gradient is 0)
takes an update that is noise normalised by Adam, up to lr per step on
either side.  Tolerances: float32 losses rtol 1e-5; weights whose gradient
stayed above the floor atol 1e-2 * lr (measured spread below 1e-3 * lr),
the others (under 10% of the weights) unchecked.  bfloat16 losses rtol
2e-2; bf16 rounding flips the sign of small gradients, so the weights are
held by the mean absolute difference (< 0.15 lr; measured 0.05-0.08) and
the cosine of the two frameworks' total updates (> 0.97; measured
0.988-0.993), where a wrong gradient gives ~lr and ~0.
"""

import collections
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from _torch_port_util import MNIST_CONFIG, random_params, to_nchw
from controlnet_tpu.data.datasets import iterate_batches as jax_iterate_batches
from controlnet_tpu.models.controlnet import ControlNet as JaxControlNet
from controlnet_tpu.models.unet import UNet as JaxUNet
from controlnet_tpu.ops import pallas_attention as jax_pa
from controlnet_tpu.schedules.linear import make_linear_schedule as jax_schedule
from controlnet_tpu.train.loops import make_controlnet_train_step as jax_cn_step
from controlnet_tpu.train.loops import make_ddpm_train_step as jax_ddpm_step
from controlnet_tpu.train.state import create_train_state as jax_train_state
from controlnet_tpu.utils.diffusion_utils import drop_image_condition as jax_drop
from controlnet_tpu_torch import cli
from controlnet_tpu_torch.data import datasets
from controlnet_tpu_torch.io import checkpoint, jax_params
from controlnet_tpu_torch.models.controlnet import ControlNet
from controlnet_tpu_torch.models.unet import UNet
from controlnet_tpu_torch.ops import cuda_attention
from controlnet_tpu_torch.schedules.linear import make_linear_schedule
from controlnet_tpu_torch.tools import sample_ddpm_controlnet as sample_tool
from controlnet_tpu_torch.tools import train_ddpm, train_ddpm_controlnet
from controlnet_tpu_torch.train.loops import make_controlnet_train_step, make_ddpm_train_step
from controlnet_tpu_torch.train.state import create_train_state
from controlnet_tpu_torch.utils.diffusion_utils import drop_image_condition

ATTN_ATOL = 3e-5
LR = 1e-3
T = 50


# ---------------------------------------------------------------------------
# attention gradient
# ---------------------------------------------------------------------------

def _qkvw(seed, b, h, dh, lq, lk):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s, dtype=np.float32)
                 for s in ((b, h, dh, lq), (b, h, dh, lk), (b, h, dh, lk), (b, h, dh, lq)))


def _jax_grads(q, k, v, w, dtype=jnp.float32):
    def loss(q, k, v):
        out = jax_pa.fused_attention_t(q, k, v, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * w)

    args = (jnp.asarray(x, dtype) for x in (q, k, v))
    return [np.asarray(g.astype(jnp.float32)) for g in jax.grad(loss, argnums=(0, 1, 2))(*args)]


BWD_SHAPES = [(49, 49, 64), (49, 49, 4), (49, 7, 16), (16, 16, 8)]
BWD_IDS = ["L49-dh64", "L49-dh4", "cross-Lq49-Lk7", "L16-dh8"]


@pytest.mark.parametrize("lq,lk,dh", BWD_SHAPES, ids=BWD_IDS)
def test_attention_bwd_plain_matches_pallas_interpret(lq, lk, dh):
    q, k, v, w = _qkvw(0, 2, 2, dh, lq, lk)
    ref = _jax_grads(q, k, v, w)
    got = cuda_attention.fused_attention_t_bwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v, w)))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, atol=ATTN_ATOL)


@pytest.mark.parametrize("lq,lk,dh", BWD_SHAPES, ids=BWD_IDS)
def test_attention_function_grad_matches_pallas_interpret(lq, lk, dh):
    """The port's autograd Function on CPU tensors (the same Function the
    card runs, with the plain versions in place of kernels a and b)."""
    q, k, v, w = _qkvw(1, 2, 2, dh, lq, lk)
    ref = _jax_grads(q, k, v, w)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = cuda_attention.fused_attention_t(qt, kt, vt)
    assert out.grad_fn is not None and "_Attention" in type(out.grad_fn).__name__
    (out * torch.from_numpy(w)).sum().backward()
    for g, r in zip((qt.grad, kt.grad, vt.grad), ref):
        np.testing.assert_allclose(g.numpy(), r, atol=ATTN_ATOL)


def test_attention_bwd_matches_chunked_pallas_backward(monkeypatch):
    """The JAX backward with its query axis in chunks (_pick_chunk forced
    to 64 rows: L 49 pads to 128, two chunks): the same gradients."""
    monkeypatch.setattr(jax_pa, "_pick_chunk", lambda lq_p, lk_p: 64)
    q, k, v, w = _qkvw(2, 2, 4, 8, 49, 49)
    ref = _jax_grads(q, k, v, w)
    got = cuda_attention.fused_attention_t_bwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v, w)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, atol=ATTN_ATOL)


def test_attention_bwd_plain_bf16():
    """bf16 in, bf16 out, float32 math on both sides: one bf16 ulp of
    gradients of magnitude < 8 (2^-5)."""
    q, k, v, w = (x.astype(jnp.bfloat16).astype(np.float32) for x in _qkvw(3, 1, 2, 16, 49, 49))
    ref = _jax_grads(q, k, v, w, jnp.bfloat16)
    got = cuda_attention.fused_attention_t_bwd_plain(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v, w)))
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), r, atol=2 ** -5)


def test_bwd_launch_config():
    assert cuda_attention.bwd_launch_config(16, 784, 784) == (128, 120, 128, 128)
    assert cuda_attention.bwd_launch_config(64, 49, 49) == (32, 31, 64, 64)
    assert cuda_attention.bwd_launch_config(16, 49, 7) == (7, 49, 64, 64)
    assert cuda_attention.bwd_launch_config(4, 196, 196) == (196, 196, 128, 128)


def test_backward_counter_untouched_on_cpu():
    before = cuda_attention.bwd_launches, cuda_attention.launches
    q, k, v, _ = _qkvw(4, 1, 2, 8, 16, 16)
    qt = torch.from_numpy(q).requires_grad_()
    cuda_attention.fused_attention_t(qt, torch.from_numpy(k), torch.from_numpy(v)).sum().backward()
    assert qt.grad is not None
    assert (cuda_attention.bwd_launches, cuda_attention.launches) == before


def test_backward_wrapper_rejects_a_mismatched_gradient():
    """Kernel b's wrapper checks dO against the saved output before it
    builds or launches anything."""
    q, k, v, w = (torch.from_numpy(x) for x in _qkvw(6, 1, 2, 8, 16, 16))
    lse = torch.zeros(1, 2, 16)
    with pytest.raises(ValueError, match="does not match"):
        cuda_attention._launch_bwd(q, k, v, q, lse, w[..., :8])
    with pytest.raises(ValueError, match="does not match"):
        cuda_attention._launch_bwd(q, k, v, q, lse, w.bfloat16())


def test_inference_path_records_no_graph():
    q, k, v, _ = _qkvw(5, 1, 2, 8, 16, 16)
    qt = torch.from_numpy(q).requires_grad_()
    with torch.no_grad():
        out = cuda_attention.fused_attention_t(qt, torch.from_numpy(k), torch.from_numpy(v))
    assert out.grad_fn is None


# ---------------------------------------------------------------------------
# condition drop, batching, cli helpers
# ---------------------------------------------------------------------------

def test_drop_image_condition_matches_jax_with_injected_mask():
    rng = np.random.default_rng(6)
    hints = rng.uniform(size=(8, 4, 4, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jax_drop(jnp.asarray(hints), key, 0.5))
    keep = 1.0 - np.asarray(jax.random.bernoulli(key, 0.5, (8,)), np.float32)
    out = drop_image_condition(to_nchw(hints), 0.5, keep=torch.from_numpy(keep))
    np.testing.assert_array_equal(out.numpy().transpose(0, 2, 3, 1), ref)


def test_drop_image_condition_generator():
    hints = torch.ones(64, 3, 2, 2)
    assert drop_image_condition(hints, 0.0) is hints
    a = drop_image_condition(hints, 0.3, torch.Generator().manual_seed(1))
    b = drop_image_condition(hints, 0.3, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    kept = a.flatten(1).amax(1)
    assert set(kept.tolist()) == {0.0, 1.0}
    assert torch.equal(a, hints * kept[:, None, None, None])


@pytest.mark.parametrize("n,batch", [(10, 4), (3, 4), (8, 4)])
def test_iterate_batches_matches_jax(n, batch):
    data = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    ref = list(jax_iterate_batches(list(data), batch, shuffle=True, seed=7, prefetch=0))
    got = list(datasets.iterate_batches(data, batch, shuffle=True, seed=7))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    on_tensor = list(datasets.iterate_batches(torch.from_numpy(data), batch, shuffle=True, seed=7))
    for g, r in zip(on_tensor, ref):
        np.testing.assert_array_equal(g.numpy(), r)


def test_load_images_maps_to_unit_range(tmp_path):
    u8 = np.array([[[0, 255], [51, 102]]], np.uint8)
    np.save(tmp_path / "u8.npy", u8)
    np.save(tmp_path / "f.npy", u8[..., None].astype(np.float32) / 255.0)
    a = datasets.load_images(str(tmp_path / "u8.npy"))
    b = datasets.load_images(str(tmp_path / "f.npy"))
    assert a.shape == (1, 2, 2, 1) and a.dtype == np.float32
    np.testing.assert_allclose(a[0, :, :, 0], [[-1.0, 1.0], [-0.6, -0.2]], atol=1e-6)
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_cli_helpers():
    assert cli.compute_dtype_from({}) is None
    assert cli.compute_dtype_from({"compute_dtype": "bf16"}) is torch.bfloat16
    with pytest.raises(ValueError):
        cli.compute_dtype_from({"compute_dtype": "fp8"})
    assert cli.ckpt_max_to_keep({}) == 3 and cli.ckpt_max_to_keep({"ckpt_max_to_keep": 0}) == 0
    assert [cli.should_save_epoch(e, 5, 2) for e in range(5)] == [False, True, False, True, True]
    timer = cli.EpochTimer()
    for x in (1.0, 2.0, 4.5):
        timer.add(torch.tensor(x))
    assert timer.mean_loss() == pytest.approx(2.5) and "3 steps" in timer.summary()


# ---------------------------------------------------------------------------
# train steps against the JAX steps
# ---------------------------------------------------------------------------

def _data(seed, b, size):
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, size=(b, size, size, 1)).astype(np.float32)
    hints = (rng.uniform(size=(b, size, size, 3)) < 0.2).astype(np.float32)
    return images, hints


def _jax_draws(key, images_shape, drop_prob):
    """t, noise and keep of one JAX step (train/loops.py key discipline)."""
    kd = None
    if drop_prob > 0:
        key, kd = jax.random.split(key)
    kt, kn = jax.random.split(key)
    b = images_shape[0]
    t = np.array(jax.random.randint(kt, (b,), 0, T))
    noise = np.array(jax.random.normal(kn, images_shape, jnp.float32))
    keep = None
    if kd is not None:
        keep = 1.0 - np.array(jax.random.bernoulli(kd, drop_prob, (b,)), np.float32)
    return t, noise, keep


NOISE_FLOOR = 1e-6  # |gradient| below which Adam (eps 1e-8) amplifies float noise


def _noisy_weights(state, noisy=None):
    """Record, per parameter, where a step's gradient sat at the noise floor."""
    noisy = noisy or {}
    for k, p in state.params.items():
        low = p.grad.abs() < NOISE_FLOOR
        noisy[k] = low if k not in noisy else noisy[k] | low
    return noisy


def _compare_params(sd_port, sd_ref, before, noisy, bf16):
    clean, rough, upd_p, upd_r = [], [], [], []
    for k, low in noisy.items():
        p, r, b0 = sd_port[k].numpy(), sd_ref[k].numpy(), before[k].numpy()
        d = np.abs(p - r)
        clean.append(d[~low.numpy()])
        rough.append(d[low.numpy()])
        upd_p.append((p - b0).ravel())
        upd_r.append((r - b0).ravel())
    clean, rough, upd_p, upd_r = (np.concatenate(x) for x in (clean, rough, upd_p, upd_r))
    cos = float(upd_p @ upd_r / (np.linalg.norm(upd_p) * np.linalg.norm(upd_r)))
    assert np.abs(upd_r).max() > 0.5 * LR  # the steps moved the weights
    assert rough.size < 0.1 * (rough.size + clean.size)
    if bf16:
        assert np.concatenate([clean, rough]).mean() < 0.15 * LR
        assert cos > 0.97, cos
    else:
        assert clean.max() < 1e-2 * LR, clean.max() / LR


def _loss_rtol(bf16):
    return 2e-2 if bf16 else 1e-5


@pytest.mark.parametrize("dtype,drop", [("float32", 0.0), ("bfloat16", 0.0), ("float32", 0.5)],
                         ids=["f32", "bf16", "f32-cfg-drop"])
def test_controlnet_train_step_matches_jax(tiny_model_config, dtype, drop):
    cfg = tiny_model_config
    bf16 = dtype == "bfloat16"
    b, size = 4, cfg["im_size"]
    jcn = JaxControlNet(cfg["im_channels"], cfg)
    p = random_params(jcn, 10)
    trainable_j, frozen_j = jcn.split_params(p)
    tx = optax.adam(LR)
    jstate = jax_train_state(trainable_j, tx)
    jstep = jax_cn_step(jcn, jax_schedule(T, 1e-4, 0.02), tx,
                        compute_dtype=jnp.bfloat16 if bf16 else None, cfg_drop_prob=drop)

    cn = ControlNet(cfg["im_channels"], cfg)
    cn.load_state_dict(jax_params.controlnet_state_dict_from_jax(p), strict=True)
    trainable, frozen = cn.freeze_trunk()
    before = {k: v.clone() for k, v in cn.state_dict().items()}
    state = create_train_state(trainable, LR)
    step = make_controlnet_train_step(cn, make_linear_schedule(T, 1e-4, 0.02, device="cpu"),
                                      compute_dtype=torch.bfloat16 if bf16 else None,
                                      cfg_drop_prob=drop)

    key = jax.random.PRNGKey(21)
    dropped, noisy = 0, None
    for i in range(3):
        images, hints = _data(30 + i, b, size)
        key, sk = jax.random.split(key)
        jstate, jloss = jstep(jstate, frozen_j, jnp.asarray(images), jnp.asarray(hints), sk)
        t, noise, keep = _jax_draws(sk, images.shape, drop)
        dropped += 0 if keep is None else int((keep == 0).sum())
        loss = step(state, to_nchw(images), to_nchw(hints), t=torch.from_numpy(t),
                    noise=to_nchw(noise), keep=None if keep is None else torch.from_numpy(keep))
        assert loss.dtype == torch.float32 and loss.dim() == 0
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=_loss_rtol(bf16))
        noisy = _noisy_weights(state, noisy)
    assert state.step == 3
    if drop:
        assert dropped > 0  # the mask really zeroed hints

    ref = jax_params.controlnet_state_dict_from_jax(
        jax.tree.map(np.asarray, jcn.merge_params(jstate.params, frozen_j)))
    sd = cn.state_dict()
    _compare_params(sd, ref, before, noisy, bf16)
    for k in frozen:
        assert torch.equal(sd[k], before[k]), k
        assert frozen[k].grad is None, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ddpm_train_step_matches_jax(tiny_model_config, dtype):
    cfg = tiny_model_config
    bf16 = dtype == "bfloat16"
    b, size = 4, cfg["im_size"]
    ju = JaxUNet(cfg["im_channels"], cfg)
    p = random_params(ju, 11)
    tx = optax.adam(LR)
    jstate = jax_train_state(p, tx)
    jstep = jax_ddpm_step(lambda pp, x, t: ju(pp, x, t), jax_schedule(T, 1e-4, 0.02), tx,
                          compute_dtype=jnp.bfloat16 if bf16 else None)

    unet = UNet(cfg["im_channels"], cfg)
    unet.load_state_dict(jax_params.unet_state_dict_from_jax(p), strict=True)
    before = {k: v.clone() for k, v in unet.state_dict().items()}
    state = create_train_state(dict(unet.named_parameters()), LR)
    step = make_ddpm_train_step(unet, make_linear_schedule(T, 1e-4, 0.02, device="cpu"),
                                compute_dtype=torch.bfloat16 if bf16 else None)

    key, noisy = jax.random.PRNGKey(22), None
    for i in range(3):
        images, _ = _data(40 + i, b, size)
        key, sk = jax.random.split(key)
        jstate, jloss = jstep(jstate, jnp.asarray(images), sk)
        t, noise, _ = _jax_draws(sk, images.shape, 0.0)
        loss = step(state, to_nchw(images), t=torch.from_numpy(t), noise=to_nchw(noise))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=_loss_rtol(bf16))
        noisy = _noisy_weights(state, noisy)

    ref = jax_params.unet_state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    _compare_params(unet.state_dict(), ref, before, noisy, bf16)


def test_train_step_generator_draws_are_reproducible(tiny_model_config):
    cfg = tiny_model_config
    sched = make_linear_schedule(T, 1e-4, 0.02, device="cpu")
    images, hints = _data(5, 2, cfg["im_size"])
    losses = []
    for _ in range(2):
        torch.manual_seed(0)
        cn = ControlNet(1, cfg)
        trainable, _ = cn.freeze_trunk()
        state = create_train_state(trainable, LR)
        step = make_controlnet_train_step(cn, sched, cfg_drop_prob=0.5)
        g = torch.Generator().manual_seed(3)
        losses.append([step(state, to_nchw(images), to_nchw(hints), g).item() for _ in range(2)])
    assert losses[0] == losses[1]


def test_controlnet_step_requires_frozen_trunk(tiny_model_config):
    cn = ControlNet(1, tiny_model_config)
    with pytest.raises(ValueError, match="freeze_trunk"):
        make_controlnet_train_step(cn, make_linear_schedule(T, 1e-4, 0.02, device="cpu"))


@pytest.mark.parametrize("locked", [True, False])
def test_freeze_trunk(tiny_model_config, locked):
    cn = ControlNet(1, tiny_model_config, model_locked=locked)
    trainable, frozen = cn.freeze_trunk()
    assert all(p.requires_grad for p in trainable.values())
    assert not any(p.requires_grad for p in frozen.values())
    assert any(k.startswith("trained_unet.ups.") for k in trainable) == (not locked)
    assert any(k.startswith("trained_unet.mids.") for k in frozen)


def test_full_width_training_step_attention_calls(monkeypatch):
    """The training main path's attention mix at full MNIST width: 26
    forward calls per step (as in sampling) and 18 backward calls: the
    frozen down path (6) and the frozen mid 0 (2) record no graph.
    chip_smoke.py holds kernel b's launch counter to the same 18."""
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
    torch.manual_seed(0)
    cn = ControlNet(1, MNIST_CONFIG)
    trainable, frozen = cn.freeze_trunk()
    state = create_train_state(trainable, LR)
    step = make_controlnet_train_step(cn, make_linear_schedule(1000, 1e-4, 0.02, device="cpu"))
    images, hints = _data(8, 1, 28)
    loss = step(state, to_nchw(images), to_nchw(hints), torch.Generator().manual_seed(0))
    assert torch.isfinite(loss)
    assert sum(fwd.values()) == 26
    assert bwd == {(784, 16): 2, (784, 4): 2, (196, 32): 2, (196, 8): 2,
                   (49, 64): 4, (49, 32): 4, (49, 16): 2}
    assert sum(bwd.values()) == 18
    assert all(p.grad is None for p in frozen.values())


# ---------------------------------------------------------------------------
# checkpoints and the trainer tools
# ---------------------------------------------------------------------------

def test_checkpoint_save_restore_prune(tmp_path):
    d = str(tmp_path)
    assert checkpoint.latest_checkpoint(d, "cn.pth") is None
    assert checkpoint.restore_checkpoint(d, "cn.pth") is None
    for s in range(1, 6):
        checkpoint.save_checkpoint(d, "cn.pth", s, {"x": torch.full((2,), float(s))},
                                   max_to_keep=2)
    assert sorted(os.listdir(tmp_path / "cn")) == ["4.pt", "5.pt"]
    tree, step = checkpoint.restore_checkpoint(d, "cn.pth")
    assert step == 5 and torch.equal(tree["x"], torch.full((2,), 5.0))
    assert checkpoint.restore_checkpoint(d, "cn", step=4)[0]["x"][0] == 4.0
    for s in (6, 7):
        checkpoint.save_checkpoint(d, "cn.pth", s, {"x": torch.zeros(1)}, max_to_keep=0)
    assert checkpoint.prune_checkpoints(d, "cn.pth", None) == []
    assert checkpoint.prune_checkpoints(d, "cn.pth", 1) == [4, 5, 6]
    assert sorted(os.listdir(tmp_path / "cn")) == ["7.pt"]


def test_train_state_round_trip_resumes_exactly(tmp_path, tiny_model_config):
    """Three steps straight equal one step, a save, a restore into a fresh
    state, and two more steps: parameters and Adam moments carry over."""
    cfg = tiny_model_config
    sched = make_linear_schedule(T, 1e-4, 0.02, device="cpu")

    def fresh():
        torch.manual_seed(1)
        unet = UNet(1, cfg)
        return unet, create_train_state(dict(unet.named_parameters()), LR)

    batches = [to_nchw(_data(50 + i, 2, cfg["im_size"])[0]) for i in range(3)]
    unet_a, state_a = fresh()
    step_a = make_ddpm_train_step(unet_a, sched)
    g = torch.Generator().manual_seed(4)
    for x in batches:
        step_a(state_a, x, g)

    unet_b, state_b = fresh()
    g = torch.Generator().manual_seed(4)
    make_ddpm_train_step(unet_b, sched)(state_b, batches[0], g)
    checkpoint.save_checkpoint(str(tmp_path), "u.pth", 1, state_b.state_dict())
    unet_c, state_c = fresh()
    tree, _ = checkpoint.restore_checkpoint(str(tmp_path), "u.pth")
    state_c.load_state_dict(tree)
    step_c = make_ddpm_train_step(unet_c, sched)
    for x in batches[1:]:
        step_c(state_c, x, g)
    assert state_c.step == state_a.step == 3
    for k, v in unet_a.state_dict().items():
        assert torch.equal(unet_c.state_dict()[k], v), k


def _tool_config(tmp_path, model_config, task, epochs):
    config = {
        "diffusion_params": {"num_timesteps": 10, "beta_start": 1e-4, "beta_end": 0.02},
        "model_params": dict(model_config),
        "train_params": {"task_name": str(tmp_path / task), "batch_size": 4,
                         "num_epochs": epochs, "controlnet_epochs": epochs,
                         "ddpm_lr": LR, "controlnet_lr": LR, "ddpm_ckpt_name": "ddpm_ckpt.pth",
                         "controlnet_ckpt_name": "cn.pth", "num_samples": 2,
                         "num_grid_rows": 2, "ckpt_max_to_keep": 1},
    }
    path = tmp_path / f"{task}_{epochs}.yaml"
    path.write_text(yaml.safe_dump(config))
    return str(path)


def _digit_images(seed, n, size):
    """uint8 (N, H, W) strokes on black, digit-like enough for canny."""
    rng = np.random.default_rng(seed)
    images = np.zeros((n, size, size), np.uint8)
    yy, xx = np.mgrid[:size, :size]
    for im in images:
        cy, cx = rng.uniform(size * 0.3, size * 0.7, 2)
        r = rng.uniform(size * 0.15, size * 0.35)
        ring = np.abs(np.hypot(yy - cy, xx - cx) - r) < rng.uniform(0.8, 1.6)
        im[ring] = 255
    return images


@pytest.mark.parametrize("tool", ["ddpm", "controlnet"])
def test_trainer_resume_equals_unbroken_run(tmp_path, tiny_model_config, tool):
    """Two epochs in one run equal one epoch, a checkpoint, and a resumed
    second epoch (a new call of the tool, as after a restart)."""
    images = tmp_path / "im.npy"
    np.save(images, _digit_images(0, 10, tiny_model_config["im_size"]))
    torch.manual_seed(5)
    base = {k: v.clone() for k, v in UNet(1, tiny_model_config).state_dict().items()}
    outs = {}
    for task, epoch_runs in (("whole", (2,)), ("split", (1, 2))):
        if tool == "controlnet":
            os.makedirs(tmp_path / task)
            torch.save(base, tmp_path / task / "ddpm_ckpt.pth")
        for epochs in epoch_runs:
            path = _tool_config(tmp_path, tiny_model_config, task, epochs)
            if tool == "ddpm":
                train_ddpm.train(path, str(images), device="cpu")
            else:
                train_ddpm_controlnet.train(path, str(images), device="cpu")
        name = "ddpm_ckpt.pth" if tool == "ddpm" else "cn.pth"
        outs[task] = torch.load(tmp_path / task / name, weights_only=True)
        assert sorted(os.listdir(tmp_path / task / name[:-4])) == ["2.pt"]  # max_to_keep 1
    assert outs["whole"].keys() == outs["split"].keys()
    for k, v in outs["whole"].items():
        assert torch.equal(outs["split"][k], v), k


def test_trainer_tools_then_sample_tool_cpu(tmp_path, tiny_model_config):
    """train_ddpm -> its .pth seeds train_ddpm_controlnet (hints from canny
    on the device, then from --hints) -> the sampling tool loads the
    ControlNet .pth unchanged."""
    cfg = tiny_model_config
    size = cfg["im_size"]
    np.save(tmp_path / "im.npy", _digit_images(1, 9, size))
    path = _tool_config(tmp_path, cfg, "task", 1)
    train_ddpm.main(["--config", path, "--images", str(tmp_path / "im.npy"), "--device", "cpu"])
    history = train_ddpm_controlnet.train(path, str(tmp_path / "im.npy"), device="cpu")
    assert history["epochs"] == [1] and np.isfinite(history["losses"][0])

    hints = (np.random.default_rng(2).uniform(size=(9, size, size, 3)) < 0.2).astype(np.float32)
    np.save(tmp_path / "hints.npy", hints)
    path2 = _tool_config(tmp_path, cfg, "task", 2)
    train_ddpm_controlnet.main(["--config", path2, "--images", str(tmp_path / "im.npy"),
                                "--hints", str(tmp_path / "hints.npy"), "--device", "cpu"])
    sd = torch.load(tmp_path / "task" / "cn.pth", weights_only=True)
    assert set(sd) == set(ControlNet(1, cfg).state_dict())
    sample_tool.main(["--config", path2, "--hints", str(tmp_path / "hints.npy"),
                      "--save_every", "5", "--device", "cpu"])
    out = sorted(os.listdir(tmp_path / "task" / "hint_samples"))
    assert out == ["hints.png", "x0_0.png", "x0_5.png"]


def test_controlnet_trainer_device_hints_are_canny(tiny_model_config):
    from controlnet_tpu_torch.ops.canny import canny_hints

    images = torch.from_numpy(datasets.to_unit(_digit_images(3, 4, 16)))[:, None]
    hints = train_ddpm_controlnet.device_hints(images)
    assert hints.shape == (4, 3, 16, 16)
    ref = canny_hints(((images + 1) / 2).permute(0, 2, 3, 1))
    assert torch.equal(hints, ref.permute(0, 3, 1, 2)) and hints.sum() > 0
