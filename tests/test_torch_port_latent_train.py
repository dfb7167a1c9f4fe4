"""The port's latent-training slice against the JAX package: the PatchGAN
discriminator, LPIPS and its weight import, the latent trainers' optimizers
(multistep LR, gradient accumulation), the latent cache, and three steps each
of the VAE-GAN, LDM and LDM ControlNet trainers, on carried-over weights and
numpy-seeded inputs with the JAX steps' draws injected (JAX threefry and
torch generators never agree).

Tolerances, and why:
* forwards (discriminator, LPIPS): 1e-5 of max|out|, float32 convolutions
  summed in another order (measured <= 1e-6);
* the LR schedule exactly, as float32 from optax; the accumulated Adam steps
  within 1e-4 lr (optax forms Adam's bias corrections in float32, torch in
  float64: 1 - 0.999 is 4.7e-5 off in float32; measured 7.2e-6 lr), where a
  wrong mean or count is off by ~lr;
* train steps, float32: metrics and losses rtol 1e-5; after three Adam steps
  the weights whose gradients stayed above the noise floor (|g| >= 1e-6,
  where Adam turns float noise into O(lr) moves) within 1e-2 lr, as
  test_torch_port_train.py holds the DDPM and ControlNet steps (a wrong
  gradient moves a weight by ~lr); in the VAE-GAN steps the noise-floor
  weights take the JAX step's values after each step (measured: the
  discriminator's convs behind its batch norms otherwise move 0.29 lr apart
  and its loss 2.2e-5 apart a step later); each metric also passes within
  rtol of the step's g_loss, since the adversarial term is formed from a
  discriminator output near 1 (0.0033 at step 3, 4.6e-5 relative or 1.5e-7
  absolute apart after that cancellation);
* the VAE-GAN step in bfloat16: losses only, rtol 5e-2 (bf16 rounding of
  the VAE's activations, ~1e-2 seen; its small gradients flip sign).

JAX runs on the CPU as its own tests run it; in the LDM ControlNet step its
3x3 stride-1 hint convs go through the Pallas conv kernel in interpret mode
(``pallas_conv3x3_tl(interpret=True)``) wherever that kernel takes the
shape, the 3-channel stem through the XLA route.  The port's kernels take
their plain versions on CPU tensors.
"""

import collections
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_util import random_params, to_nchw, to_nhwc
from controlnet_tpu.data.datasets import load_latents as jax_load_latents
from controlnet_tpu.models.controlnet import ControlNet as JaxControlNet
from controlnet_tpu.models.discriminator import Discriminator as JaxDiscriminator
from controlnet_tpu.models.lpips import LPIPS as JaxLPIPS
from controlnet_tpu.models.lpips import load_torch_weights as jax_load_lpips
from controlnet_tpu.models.unet import UNet as JaxUNet
from controlnet_tpu.models.vae import VAE as JaxVAE
from controlnet_tpu.ops import pallas_conv
from controlnet_tpu.schedules.linear import make_linear_schedule as jax_schedule
from controlnet_tpu.train.loops import make_controlnet_train_step as jax_cn_step
from controlnet_tpu.train.loops import make_ddpm_train_step as jax_ddpm_step
from controlnet_tpu.train.loops import make_vae_gan_train_step as jax_vae_gan_step
from controlnet_tpu.train.state import create_train_state as jax_train_state
from controlnet_tpu_torch.data import datasets
from controlnet_tpu_torch.io import jax_params
from controlnet_tpu_torch.models.controlnet import ControlNet
from controlnet_tpu_torch.models.discriminator import Discriminator
from controlnet_tpu_torch.models.lpips import LPIPS, load_torch_weights
from controlnet_tpu_torch.models.unet import UNet
from controlnet_tpu_torch.models.vae import VAE
from controlnet_tpu_torch.ops import cuda_attention, tl_conv
from controlnet_tpu_torch.schedules.linear import make_linear_schedule
from controlnet_tpu_torch.train.loops import (make_controlnet_train_step, make_ddpm_train_step,
                                              make_vae_gan_train_step)
from controlnet_tpu_torch.train.state import create_train_state, multistep_schedule
from tools.train_ldm_vae import latents_from_batch as jax_latents_from_batch
from tools.train_ldm_vae import multistep_adam

FWD_RTOL = 1e-5
STEP_RTOL = 1e-5
BF16_LOSS_RTOL = 5e-2
LR = 1e-3
NOISE_FLOOR = 1e-6

# the latent config of tests/test_tools_celebhq_e2e.py, canny_im_size raised
# from 16 to 32: latents 8x8 (one VAE downsample of 16), hint factor 4
CELEB_LDM = dict(
    hint_channels=3, down_channels=[8, 16, 16], mid_channels=[16, 16],
    down_sample=[True, False], attn_down=[False, True], time_emb_dim=8, norm_channels=4,
    num_heads=2, conv_out_channels=8, num_down_layers=1, num_mid_layers=1, num_up_layers=1)
CELEB_VAE = dict(
    z_channels=2, down_channels=[8, 16], mid_channels=[16], down_sample=[True],
    attn_down=[False], norm_channels=4, num_heads=2, num_down_layers=1, num_mid_layers=1,
    num_up_layers=1)
Z, IM, CANNY, LATENT = 2, 16, 32, 8
FACTOR = CANNY // LATENT
T = 8  # the e2e config's timesteps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the suite runs in
    parallel workers, and at these sizes torch's thread pool only contends
    with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


# ---------------------------------------------------------------------------
# discriminator and LPIPS
# ---------------------------------------------------------------------------

def _carried_disc(seed):
    jd = JaxDiscriminator(im_channels=3)
    p = random_params(jd, seed)
    d = Discriminator(im_channels=3)
    d.load_state_dict(jax_params.discriminator_state_dict_from_jax(p), strict=True)
    return jd, p, d


def _carried_lpips(seed):
    jl = JaxLPIPS()
    p = random_params(jl, seed)
    lp = LPIPS()
    lp.load_state_dict(jax_params.lpips_state_dict_from_jax(p), strict=True)
    return jl, p, lp


def test_discriminator_forward_matches_jax():
    jd, p, d = _carried_disc(1)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jd.__call__)(p, jnp.asarray(x)))
    with torch.no_grad():
        out = d(to_nchw(x))
    assert out.shape == (2, 1, 3, 3)
    assert _rel(to_nhwc(out), ref) < FWD_RTOL


def test_discriminator_state_dict_names():
    names = list(Discriminator(im_channels=3).state_dict())
    assert names == ["layers.0.0.weight", "layers.0.0.bias", "layers.1.0.weight",
                     "layers.1.1.weight", "layers.1.1.bias", "layers.2.0.weight",
                     "layers.2.1.weight", "layers.2.1.bias", "layers.3.0.weight"]


@pytest.mark.parametrize("normalize,channels", [(False, 3), (True, 3), (False, 1)],
                         ids=["rgb", "normalize", "grey"])
def test_lpips_forward_matches_jax(normalize, channels):
    jl, p, lp = _carried_lpips(2)
    rng = np.random.default_rng(2)
    lo = 0.0 if normalize else -1.0
    a, b = (rng.uniform(lo, 1, (2, 32, 32, channels)).astype(np.float32) for _ in range(2))
    ref = np.asarray(jax.jit(jl.__call__, static_argnums=3)(p, jnp.asarray(a), jnp.asarray(b),
                                                            normalize))
    with torch.no_grad():
        out = lp(to_nchw(a), to_nchw(b), normalize=normalize)
    assert out.shape == (2, 1, 1, 1) and out.dtype == torch.float32
    assert _rel(to_nhwc(out), ref) < FWD_RTOL


def test_lpips_is_frozen_float32_and_seeded():
    a = LPIPS(torch.Generator().manual_seed(3))
    b = LPIPS(torch.Generator().manual_seed(3))
    assert all(not p.requires_grad and p.dtype == torch.float32 for p in a.parameters())
    for (ka, va), (_, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(va, vb), ka
    lins = torch.cat([w.weight.flatten() for w in a.lins()])
    assert 0.0 <= lins.min() and lins.max() < 0.1
    conv = a.vgg_convs()[4]  # 128 -> 256
    assert abs(conv.weight.std().item() / np.sqrt(2.0 / (128 * 9)) - 1) < 0.05


def _lpips_files(tmp_path, seed):
    """A full dump (VGG features + lin heads) and a lin-only file, as torch
    ``.pth`` state dicts with the reference's names."""
    rng = np.random.default_rng(seed)
    full = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
            for k, v in LPIPS().state_dict().items()}
    lins = {f"lin{k}.model.1.weight": full[f"lin{k}.model.1.weight"] * 2 for k in range(5)}
    torch.save(full, tmp_path / "full.pth")
    torch.save(lins, tmp_path / "lin.pth")
    return str(tmp_path / "full.pth"), str(tmp_path / "lin.pth")


@pytest.mark.parametrize("files,have_vgg", [(("full",), False), (("lin",), False),
                                            (("full", "lin"), False), (("lin",), True)],
                         ids=["full", "lin-only-ignored", "full-then-lin", "lin-over-have-vgg"])
def test_lpips_load_torch_weights_matches_jax(tmp_path, files, have_vgg):
    """Both layouts and the rule that lin heads load only alongside VGG
    features: the same weights and the same flag as the JAX loader."""
    paths = dict(zip(("full", "lin"), _lpips_files(tmp_path, 4)))
    jl, p, lp = _carried_lpips(5)
    jflag = tflag = have_vgg
    for name in files:
        p, jflag = jax_load_lpips(p, paths[name], have_vgg=jflag)
        tflag = load_torch_weights(lp, paths[name], have_vgg=tflag)
    assert tflag == jflag
    ref = jax_params.lpips_state_dict_from_jax(jax.tree.map(np.asarray, p))
    for k, v in lp.state_dict().items():
        assert torch.equal(v, ref[k]), k


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("milestones,spe,gamma", [([1], 3, 0.5), ([2, 4, 5], 2, 0.1),
                                                  ([25, 50, 75, 100], 1, 0.5)])
def test_multistep_schedule_matches_optax(milestones, spe, gamma):
    ref = optax.piecewise_constant_schedule(2.5e-5, {m * spe: gamma for m in milestones})
    ours = multistep_schedule(2.5e-5, milestones, spe, gamma)
    for k in range(0, 12 * spe):
        assert np.float32(ours(k)) == np.float32(ref(k)), k


def test_accumulated_scheduled_adam_matches_optax_multisteps():
    """k = 2 over 4 calls, Adam (0.5, 0.999) on a multistep LR that halves
    after the first update: parameters after every call as optax's
    ``MultiSteps(adam(schedule))``, whose inner count (the schedule's and
    the bias correction's) advances on updates only."""
    rng = np.random.default_rng(6)
    w0 = rng.standard_normal(5).astype(np.float32)
    grads = [rng.standard_normal(5).astype(np.float32) for _ in range(4)]
    tx = optax.MultiSteps(optax.adam(optax.piecewise_constant_schedule(0.1, {1: 0.5}),
                                     b1=0.5, b2=0.999), 2)
    params = jnp.asarray(w0)
    opt_state = tx.init(params)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    state = create_train_state({"w": w}, 0.1, betas=(0.5, 0.999),
                               lr_schedule=multistep_schedule(0.1, [1], 1, 0.5), acc_steps=2)
    for i, g in enumerate(grads):
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        params = optax.apply_updates(params, updates)
        w.grad = torch.from_numpy(g.copy())
        state.apply_gradients()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(params), rtol=0, atol=1e-4 * 0.1)
        assert not np.array_equal(np.asarray(params), w0) or i == 0
    assert state.step == 4 and state.updates == 2 and not state.acc


def test_accumulation_window_survives_a_checkpoint():
    """A state saved in the middle of a window resumes it exactly."""
    def fresh():
        w = torch.nn.Parameter(torch.ones(3))
        return w, create_train_state({"w": w}, 0.1, acc_steps=3)

    grads = [torch.tensor([1.0, -2.0, 0.5]) * (i + 1) for i in range(6)]
    w_a, a = fresh()
    for g in grads:
        w_a.grad = g.clone()
        a.apply_gradients()
    w_b, b = fresh()
    for g in grads[:2]:
        w_b.grad = g.clone()
        b.apply_gradients()
    w_c, c = fresh()
    c.load_state_dict(b.state_dict())
    for g in grads[2:]:
        w_c.grad = g.clone()
        c.apply_gradients()
    assert torch.equal(w_c.detach(), w_a.detach()) and c.updates == a.updates == 2


# ---------------------------------------------------------------------------
# the latent cache
# ---------------------------------------------------------------------------

def test_load_latents_merges_npz_and_pkl_shards(tmp_path):
    rng = np.random.default_rng(7)
    m = {f"{i:08d}": rng.standard_normal((4, 3, 3)).astype(np.float32) for i in range(5)}
    np.savez(tmp_path / "latents_0.npz", **{k: m[k] for k in list(m)[:3]})
    with open(tmp_path / "ref.pkl", "wb") as f:  # the reference's shards: torch tensors, 4-D
        pickle.dump({k: torch.from_numpy(m[k])[None] for k in list(m)[3:]}, f)
    ours = datasets.load_latents(str(tmp_path))
    ref = jax_load_latents(str(tmp_path))
    assert sorted(ours) == sorted(ref) == sorted(m)
    for k in m:
        np.testing.assert_array_equal(ours[k], ref[k])
        np.testing.assert_array_equal(ours[k], m[k])
    stacked = datasets.stack_latents(ours, 2)
    np.testing.assert_array_equal(stacked, np.stack([m[k] for k in sorted(m)]))
    nhwc = {k: v.transpose(1, 2, 0) for k, v in ours.items()}  # the JAX package's shards
    np.testing.assert_array_equal(datasets.stack_latents(nhwc, 2), stacked)
    with pytest.raises(ValueError):
        datasets.stack_latents(ours, 3)


def test_latents_from_batch_matches_jax():
    rng = np.random.default_rng(8)
    moments = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)  # NHWC, z = 2
    key = jax.random.PRNGKey(8)
    ref = np.asarray(jax_latents_from_batch(jnp.asarray(moments), key, 2))
    noise = np.asarray(jax.random.normal(key, (3, 4, 4, 2), jnp.float32))
    out = datasets.latents_from_batch(to_nchw(moments), noise=to_nchw(noise))
    np.testing.assert_allclose(to_nhwc(out), ref, rtol=1e-6, atol=1e-6)
    g = torch.Generator().manual_seed(0)
    assert datasets.latents_from_batch(to_nchw(moments), g).shape == (3, 2, 4, 4)


# ---------------------------------------------------------------------------
# train steps against the JAX steps
# ---------------------------------------------------------------------------

def _noisy(params: dict, noisy: dict) -> dict:
    """Where a step's gradient sat at the noise floor, per parameter."""
    for k, p in params.items():
        low = p.grad.abs() < NOISE_FLOOR
        noisy[k] = low if k not in noisy else noisy[k] | low
    return noisy


def _assert_weights(sd, ref, before, noisy, lr=LR):
    """Weights above the noise floor within 1e-2 lr of the JAX step's, and
    the steps moved them."""
    clean, moved, n_noisy, n = [], 0.0, 0, 0
    for k, low in noisy.items():
        d = np.abs(sd[k].numpy() - ref[k].numpy())
        clean.append(d[~low.numpy()])
        moved = max(moved, float(np.abs(ref[k].numpy() - before[k].numpy()).max()))
        n_noisy += int(low.sum())
        n += low.numel()
    assert moved > 0.5 * lr
    assert n_noisy < 0.25 * n, n_noisy / n
    worst = float(np.concatenate(clean).max())
    assert worst < 1e-2 * lr, worst / lr


def _vae_gan_setup(dtype):
    bf16 = dtype == "bfloat16"
    jvae, jdisc, jlp = JaxVAE(3, CELEB_VAE), JaxDiscriminator(im_channels=3), JaxLPIPS()
    pv, pd, pl = random_params(jvae, 20), random_params(jdisc, 21), random_params(jlp, 22)
    tx_g = optax.adam(LR, b1=0.5, b2=0.999)
    tx_d = optax.adam(LR, b1=0.5, b2=0.999)
    kw = dict(disc_start=1, disc_weight=0.5, kl_weight=0.01, perceptual_weight=1.0)
    jstep = jax_vae_gan_step(jvae, jdisc, jlp, tx_g, tx_d, compute_dtype=jnp.bfloat16 if bf16
                             else None, **kw)
    vae, disc, lp = VAE(3, CELEB_VAE), Discriminator(im_channels=3), LPIPS()
    vae.load_state_dict(jax_params.vae_state_dict_from_jax(pv), strict=True)
    disc.load_state_dict(jax_params.discriminator_state_dict_from_jax(pd), strict=True)
    lp.load_state_dict(jax_params.lpips_state_dict_from_jax(pl), strict=True)
    g_state = create_train_state(dict(vae.named_parameters()), LR, betas=(0.5, 0.999))
    d_state = create_train_state(dict(disc.named_parameters()), LR, betas=(0.5, 0.999))
    step = make_vae_gan_train_step(vae, disc, lp, compute_dtype=torch.bfloat16 if bf16 else None,
                                   **kw)
    jax_side = (jstep, jax_train_state(pv, tx_g), jax_train_state(pd, tx_d), pl)
    return jax_side, (vae, disc, g_state, d_state, step)


def _vae_gan_reference(jg, jd) -> dict:
    """Both nets' weights after the JAX step, by port names ("g." / "d.")."""
    return {**{f"g.{k}": v for k, v in jax_params.vae_state_dict_from_jax(
                jax.tree.map(np.asarray, jg.params)).items()},
            **{f"d.{k}": v for k, v in jax_params.discriminator_state_dict_from_jax(
                jax.tree.map(np.asarray, jd.params)).items()}}


@torch.no_grad()
def _take_noise_floor_weights(g_state, d_state, ref: dict) -> None:
    """Weights whose gradient this step sat at the noise floor take the JAX
    step's values, as in test_torch_port_distill.py: Adam moves each by ~lr
    along the sign of float noise (behind the discriminator's batch norms a
    conv weight's gradient reaches 2e-10, and 3/4 of its last conv sees only
    padding), and that noise would feed the next step's losses."""
    for prefix, state in (("g.", g_state), ("d.", d_state)):
        for k, p in state.params.items():
            low = p.grad.abs() < NOISE_FLOOR
            p[low] = ref[prefix + k][low]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vae_gan_steps_straddling_disc_start_match_jax(dtype):
    """Steps 1, 2, 3 with disc_start 1: the discriminator is off at step 1
    (its optimizer still counts a zero-gradient update) and on after."""
    bf16 = dtype == "bfloat16"
    (jstep, jg, jd, pl), (vae, disc, g_state, d_state, step) = _vae_gan_setup(dtype)
    before = {**{f"g.{k}": v.clone() for k, v in vae.state_dict().items()},
              **{f"d.{k}": v.clone() for k, v in disc.state_dict().items()}}
    key, noisy = jax.random.PRNGKey(23), {}
    for i in range(3):
        images = np.random.default_rng(30 + i).uniform(-1, 1, (2, IM, IM, 3)).astype(np.float32)
        key, sk = jax.random.split(key)
        jg, jd, jm = jstep(jg, jd, pl, jnp.asarray(images), sk, jnp.int32(i + 1))
        noise = jax.random.normal(sk, (2, IM // 2, IM // 2, Z), jnp.bfloat16 if bf16
                                  else jnp.float32)
        m = step(g_state, d_state, to_nchw(images), i + 1, noise=to_nchw(noise.astype(jnp.float32)))
        assert set(m) == set(jm)
        rtol = BF16_LOSS_RTOL if bf16 else STEP_RTOL
        for k in m:
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=rtol,
                                       atol=rtol * float(jm["g_loss"]),
                                       err_msg=f"step {i + 1} {k}")
        assert (m["disc_loss"].item() == 0.0) == (i == 0)
        _noisy({f"g.{k}": p for k, p in g_state.params.items()}, noisy)
        if i > 0:  # step 1's discriminator gradients are exactly zero
            _noisy({f"d.{k}": p for k, p in d_state.params.items()}, noisy)
        ref = _vae_gan_reference(jg, jd)
        if not bf16:
            _take_noise_floor_weights(g_state, d_state, ref)
    assert g_state.step == d_state.step == 3 and d_state.updates == 3
    if bf16:
        return
    sd = {**{f"g.{k}": v for k, v in vae.state_dict().items()},
          **{f"d.{k}": v for k, v in disc.state_dict().items()}}
    noisy.update({k: torch.zeros_like(v, dtype=torch.bool) for k, v in sd.items()
                  if k not in noisy})
    _assert_weights(sd, ref, before, noisy)
    # the discriminator's Adam took three updates, the first of zeros
    opt = d_state.optimizer.state[next(iter(d_state.params.values()))]
    assert int(opt["step"]) == 3


def _jax_draws(key, shape, drop_prob):
    """t, noise and keep of one JAX ControlNet / DDPM step (its key discipline)."""
    kd = None
    if drop_prob > 0:
        key, kd = jax.random.split(key)
    kt, kn = jax.random.split(key)
    t = np.array(jax.random.randint(kt, (shape[0],), 0, T))
    noise = np.array(jax.random.normal(kn, shape, jnp.float32))
    keep = None if kd is None else 1.0 - np.array(jax.random.bernoulli(kd, drop_prob,
                                                                       (shape[0],)), np.float32)
    return t, noise, keep


def _latents(i):
    return np.random.default_rng(40 + i).standard_normal((2, LATENT, LATENT, Z)).astype(np.float32)


def test_ldm_steps_match_jax():
    """Three steps of the LDM trainer's step on the CompVis schedule, Adam
    on the multistep LR (halved after two updates)."""
    ju = JaxUNet(Z, CELEB_LDM)
    p = random_params(ju, 24)
    tx = multistep_adam(LR, [1], 2, gamma=0.5)
    jstate = jax_train_state(p, tx)
    jstep = jax_ddpm_step(lambda pp, x, t: ju(pp, x, t), jax_schedule(T, 0.0015, 0.0195, True), tx)
    unet = UNet(Z, CELEB_LDM)
    unet.load_state_dict(jax_params.unet_state_dict_from_jax(p), strict=True)
    before = {k: v.clone() for k, v in unet.state_dict().items()}
    state = create_train_state(dict(unet.named_parameters()), LR,
                               lr_schedule=multistep_schedule(LR, [1], 2, 0.5))
    step = make_ddpm_train_step(unet, make_linear_schedule(T, 0.0015, 0.0195, ldm_scheduler=True,
                                                           device="cpu"))
    key, noisy = jax.random.PRNGKey(25), {}
    for i in range(3):
        lat = _latents(i)
        key, sk = jax.random.split(key)
        jstate, jloss = jstep(jstate, jnp.asarray(lat), sk)
        t, noise, _ = _jax_draws(sk, lat.shape, 0.0)
        loss = step(state, to_nchw(lat), t=torch.from_numpy(t), noise=to_nchw(noise))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=STEP_RTOL)
        _noisy(state.params, noisy)
    assert state.optimizer.param_groups[0]["lr"] == LR * 0.5
    ref = jax_params.unet_state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    _assert_weights(unet.state_dict(), ref, before, noisy)


@pytest.fixture
def pallas_interpret_hint_convs(monkeypatch):
    """Route the JAX hint encoder's 3x3 stride-1 convs through the Pallas
    kernel in interpret mode wherever the kernel takes the shape (the TPU
    backend check aside); counts those calls."""
    calls = []
    orig = pallas_conv.pallas_conv3x3_tl

    def applicable(x, cin, cout, hw):
        sub = {jnp.dtype(jnp.float32): 8, jnp.dtype(jnp.bfloat16): 16}.get(jnp.dtype(x.dtype))
        c, b, l = x.shape
        return (sub is not None and cin % sub == 0 and cout % sub == 0
                and pallas_conv._plan(b, l, cin, cout, jnp.dtype(x.dtype).itemsize) is not None)

    def interpret(w, b, x, hw, interpret=False):
        calls.append((w.shape[2], w.shape[3]))
        return orig(w, b, x, hw, interpret=True)

    monkeypatch.setattr(pallas_conv, "pallas_conv3x3_applicable", applicable)
    monkeypatch.setattr(pallas_conv, "pallas_conv3x3_tl", interpret)
    return calls


def test_ldm_controlnet_steps_match_jax(pallas_interpret_hint_convs):
    """Three steps of the LDM ControlNet trainer's step (hints 32^2 over 8^2
    latents, factor 4; condition drop 0.5, mask injected), Adam on the
    multistep LR cut by 10 after two updates."""
    jcn = JaxControlNet(Z, CELEB_LDM, down_sample_factor=FACTOR)
    p = random_params(jcn, 26)
    trainable_j, frozen_j = jcn.split_params(p)
    tx = multistep_adam(LR, [1], 2, gamma=0.1)
    jstate = jax_train_state(trainable_j, tx)
    jstep = jax_cn_step(jcn, jax_schedule(T, 0.0015, 0.0195, True), tx, cfg_drop_prob=0.5)
    cn = ControlNet(Z, CELEB_LDM, down_sample_factor=FACTOR)
    cn.load_state_dict(jax_params.controlnet_state_dict_from_jax(p, ldm=True), strict=True)
    trainable, frozen = cn.freeze_trunk()
    before = {k: v.clone() for k, v in cn.state_dict().items()}
    state = create_train_state(trainable, LR, lr_schedule=multistep_schedule(LR, [1], 2, 0.1))
    step = make_controlnet_train_step(
        cn, make_linear_schedule(T, 0.0015, 0.0195, ldm_scheduler=True, device="cpu"),
        cfg_drop_prob=0.5)
    key, noisy, dropped = jax.random.PRNGKey(27), {}, 0
    for i in range(3):
        lat = _latents(10 + i)
        hints = (np.random.default_rng(50 + i).uniform(size=(2, CANNY, CANNY, 3)) < 0.3
                 ).astype(np.float32)
        key, sk = jax.random.split(key)
        jstate, jloss = jstep(jstate, frozen_j, jnp.asarray(lat), jnp.asarray(hints), sk)
        t, noise, keep = _jax_draws(sk, lat.shape, 0.5)
        dropped += int((keep == 0).sum())
        # the hint encoder reads contiguous NCHW hints (the trainer tool makes them so)
        loss = step(state, to_nchw(lat), to_nchw(hints).contiguous(), t=torch.from_numpy(t),
                    noise=to_nchw(noise), keep=torch.from_numpy(keep))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=STEP_RTOL)
        _noisy(state.params, noisy)
    assert pallas_interpret_hint_convs  # the JAX side ran the Pallas conv
    assert 0 < dropped < 6
    ref = jax_params.controlnet_state_dict_from_jax(
        jax.tree.map(np.asarray, jcn.merge_params(jstate.params, frozen_j)), ldm=True)
    sd = cn.state_dict()
    _assert_weights({k: sd[k] for k in trainable}, ref, before, noisy)
    for k in frozen:
        assert torch.equal(sd[k], before[k]) and frozen[k].grad is None, k


# ---------------------------------------------------------------------------
# kernel dispatch per step
# ---------------------------------------------------------------------------

@pytest.fixture
def dispatch(monkeypatch):
    """Counts calls at the dispatch points of kernels a (attention forward),
    b (its backward) and c (the TL 3x3 conv); on CUDA tensors each one is a
    launch."""
    calls = collections.Counter()
    fwd, bwd, conv = (cuda_attention.fused_attention_t, cuda_attention.fused_attention_t_bwd_plain,
                      tl_conv.conv3x3_tl)

    def spy(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    monkeypatch.setattr(cuda_attention, "fused_attention_t", spy("a", fwd))
    monkeypatch.setattr(cuda_attention, "fused_attention_t_bwd_plain", spy("b", bwd))
    monkeypatch.setattr(tl_conv, "conv3x3_tl", spy("c", conv))
    return calls


# config/celebhq.yaml's ldm_params in structure (attention at every level,
# two layers a block, one mid block of two layers), cut in width
CELEBHQ_STRUCTURE = dict(CELEB_LDM, down_channels=[16, 24, 32, 48], mid_channels=[48, 32],
                         down_sample=[True, True, True], attn_down=[True, True, True],
                         num_heads=4, norm_channels=8, time_emb_dim=16, conv_out_channels=16,
                         num_down_layers=2, num_mid_layers=2, num_up_layers=2)


@pytest.mark.parametrize("cfg,factor,expect", [
    (CELEB_LDM, FACTOR, {"ldm": (4, 4, 0), "controlnet": (6, 4, 4)}),
    (CELEBHQ_STRUCTURE, 32, {"ldm": (14, 14, 0), "controlnet": (22, 14, 7)})],
    ids=["tiny", "celebhq-structure"])
def test_kernel_dispatch_per_step(dispatch, cfg, factor, expect):
    """Launches a, b, c per train step.  At config/celebhq.yaml's structure:
    the LDM step 14 forward + 14 backward attention calls; the LDM ControlNet
    step 22 forward (trunk 14 + control copy 8) and 14 backward (the control
    copy's 8 and the trunk's 6 up-block layers: its down path and mid block
    record no graph) and the hint encoder's 7 stride-1 convs, under
    gradient.  chip_smoke.py holds the launch counters to the same numbers."""
    torch.manual_seed(0)
    sched = make_linear_schedule(T, 0.0015, 0.0195, ldm_scheduler=True, device="cpu")
    lat = torch.randn(1, Z, LATENT, LATENT)
    unet = UNet(Z, cfg)
    step = make_ddpm_train_step(unet, sched)
    assert torch.isfinite(step(create_train_state(dict(unet.named_parameters()), LR), lat,
                               torch.Generator().manual_seed(0)))
    assert (dispatch["a"], dispatch["b"], dispatch["c"]) == expect["ldm"]
    dispatch.clear()
    cn = ControlNet(Z, cfg, down_sample_factor=factor)
    trainable, frozen = cn.freeze_trunk()
    step = make_controlnet_train_step(cn, sched)
    hint = torch.rand(1, 3, LATENT * factor, LATENT * factor)
    assert torch.isfinite(step(create_train_state(trainable, LR), lat, hint,
                               torch.Generator().manual_seed(0)))
    assert (dispatch["a"], dispatch["b"], dispatch["c"]) == expect["controlnet"]
    assert cn.hint_block[0][0].weight.grad is not None  # kernel c's route under gradient
    assert all(p.grad is None for p in frozen.values())


def test_vae_gan_step_dispatches_no_kernel(dispatch):
    """At config/celebhq.yaml's autoencoder structure (no attention, no mid
    block) the VAE-GAN step reaches none of the kernels."""
    _, (vae, disc, g_state, d_state, step) = _vae_gan_setup("float32")
    step(g_state, d_state, torch.rand(2, 3, IM, IM) * 2 - 1, 2, torch.Generator().manual_seed(0))
    assert sum(dispatch.values()) == 0
