"""Port schedule and ancestral sampler (controlnet_tpu_torch.schedules,
controlnet_tpu_torch.sample) against the JAX package.

JAX threefry and torch's generators never give the same numbers, so the
tests repeat the JAX sampler's key discipline with ``jax.random`` (x_T from
the first split of the key, sample/common.py:34-35; then one split per step,
sample/ddpm.py:78), and hand x_T and every step's noise to the port.
Tolerances: 5e-6 absolute for the schedule tables (float32 linspace and a
1000-term cumprod, which the two frameworks round differently by a few
ulps; sqrt(1 - acp) amplifies an ulp of acp near 1 into ~1e-6); 1e-5
for single update rules; 2e-4 for the whole 10-step ControlNet sampling
loop at the tiny config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import random_params, to_nchw, to_nhwc
from controlnet_tpu.models.controlnet import ControlNet as JaxControlNet
from controlnet_tpu.sample.ddpm import make_ddpm_sampler as jax_make_ddpm_sampler
from controlnet_tpu.schedules import linear as jax_linear
from controlnet_tpu_torch.io import jax_params
from controlnet_tpu_torch.models.controlnet import ControlNet
from controlnet_tpu_torch.sample.ddpm import make_ddpm_sampler
from controlnet_tpu_torch.schedules import linear

CPU = "cpu"


@pytest.mark.parametrize("ldm", [False, True], ids=["linear", "ldm_scheduler"])
def test_schedule_tables(ldm):
    ref = jax_linear.make_linear_schedule(1000, 1e-4, 0.02, ldm_scheduler=ldm)
    sched = linear.make_linear_schedule(1000, 1e-4, 0.02, ldm_scheduler=ldm, device=CPU)
    assert sched.num_timesteps == 1000
    for name in ref._fields:
        np.testing.assert_allclose(getattr(sched, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=5e-6, err_msg=name)


def _state(seed, shape=(2, 4, 4, 1)):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(3))


def test_add_noise_and_eps_to_x0():
    ref_s = jax_linear.make_linear_schedule(100, 1e-4, 0.02)
    sched = linear.make_linear_schedule(100, 1e-4, 0.02, device=CPU)
    x0, noise, _ = _state(0)
    t = np.array([0, 73])
    ref = np.asarray(jax_linear.add_noise(ref_s, jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t)))
    out = linear.add_noise(sched, to_nchw(x0), to_nchw(noise), torch.from_numpy(t))
    np.testing.assert_allclose(to_nhwc(out), ref, atol=1e-5)
    ref = np.asarray(jax_linear.eps_to_x0(ref_s, jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t)))
    out = linear.eps_to_x0(sched, to_nchw(x0), to_nchw(noise), torch.from_numpy(t))
    np.testing.assert_allclose(to_nhwc(out), ref, atol=1e-5)


@pytest.mark.parametrize("t", [57, 1, 0])
def test_sample_prev_timestep_injected_noise(t):
    """Keeps the t == 0 branch: the posterior mean, no noise."""
    ref_s = jax_linear.make_linear_schedule(100, 1e-4, 0.02)
    sched = linear.make_linear_schedule(100, 1e-4, 0.02, device=CPU)
    xt, eps, _ = _state(1)
    key = jax.random.PRNGKey(3)
    z = np.asarray(jax.random.normal(key, xt.shape, jnp.float32))
    ref_prev, ref_x0 = jax_linear.sample_prev_timestep(ref_s, jnp.asarray(xt), jnp.asarray(eps), t, key)
    prev, x0 = linear.sample_prev_timestep(sched, to_nchw(xt), to_nchw(eps), t, to_nchw(z))
    np.testing.assert_allclose(to_nhwc(prev), np.asarray(ref_prev), atol=1e-5)
    np.testing.assert_allclose(to_nhwc(x0), np.asarray(ref_x0), atol=1e-5)


@pytest.mark.parametrize("eta,t_prev", [(0.0, 40), (0.0, -1), (1.0, 40)])
def test_ddim_step(eta, t_prev):
    ref_s = jax_linear.make_linear_schedule(100, 1e-4, 0.02)
    sched = linear.make_linear_schedule(100, 1e-4, 0.02, device=CPU)
    xt, eps, _ = _state(2)
    key = jax.random.PRNGKey(4)
    z = np.asarray(jax.random.normal(key, xt.shape, jnp.float32))
    ref_prev, ref_x0 = jax_linear.ddim_step(ref_s, jnp.asarray(xt), jnp.asarray(eps), 60, t_prev,
                                            key, eta=eta)
    prev, x0 = linear.ddim_step(sched, to_nchw(xt), to_nchw(eps), 60, t_prev, to_nchw(z), eta=eta)
    np.testing.assert_allclose(to_nhwc(prev), np.asarray(ref_prev), atol=1e-5)
    np.testing.assert_allclose(to_nhwc(x0), np.asarray(ref_x0), atol=1e-5)


def _jax_noise(key, shape, T):
    """x_T and the per-step noise, drawn as the JAX ancestral sampler draws them."""
    k0, key = jax.random.split(key)
    x_start = np.asarray(jax.random.normal(k0, shape, jnp.float32))
    zs = []
    for _ in range(T):
        key, kstep = jax.random.split(key)
        zs.append(np.asarray(jax.random.normal(kstep, shape, jnp.float32)))
    return x_start, np.stack(zs)


def test_controlnet_sampler_matches_jax(tiny_model_config):
    """The whole slice at the tiny config: 10-step schedule, record_every 5,
    ControlNet with hint features computed once."""
    cfg = tiny_model_config
    T, b, size = 10, 2, cfg["im_size"]
    shape = (b, size, size, cfg["im_channels"])
    jcn = JaxControlNet(cfg["im_channels"], cfg)
    p = random_params(jcn, 7)
    hint = np.random.default_rng(7).uniform(size=(b, size, size, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)

    ref_s = jax_linear.make_linear_schedule(T, 1e-4, 0.02)
    jax_sampler = jax_make_ddpm_sampler(lambda pp, x, t, f: jcn(pp, x, t, hint_features=f),
                                        ref_s, shape, record_every=5)
    ref_x0, ref_traj = jax_sampler(p, key, jcn.hint_features(p, jnp.asarray(hint)))

    cn = ControlNet(cfg["im_channels"], cfg).eval()
    cn.load_state_dict(jax_params.controlnet_state_dict_from_jax(p), strict=True)
    sched = linear.make_linear_schedule(T, 1e-4, 0.02, device=CPU)
    sampler = make_ddpm_sampler(lambda m, x, t, f: m(x, t, hint_features=f), sched,
                                (b, cfg["im_channels"], size, size), record_every=5, device=CPU)
    x_start, zs = _jax_noise(key, shape, T)
    with torch.no_grad():
        feats = cn.hint_features(to_nchw(hint))
    x0, traj = sampler(cn, None, feats, x_start=to_nchw(x_start),
                       step_noise=torch.from_numpy(zs.transpose(0, 1, 4, 2, 3).copy()))

    assert traj.shape == (2, b, 1, size, size)
    np.testing.assert_allclose(to_nhwc(x0), np.asarray(ref_x0), atol=2e-4)
    for k in range(2):
        np.testing.assert_allclose(to_nhwc(traj[k]), np.asarray(ref_traj[k]), atol=2e-4)


def test_sampler_generator_and_bf16_compute(tiny_model_config):
    """Noise from a seeded torch.Generator is reproducible; bf16 compute
    keeps the scheduler update in float32 and the trajectory clamped."""
    cfg = tiny_model_config
    torch.manual_seed(0)
    cn = ControlNet(1, cfg).eval()
    sched = linear.make_linear_schedule(4, 1e-4, 0.02, device=CPU)
    hint = torch.rand(2, 3, 8, 8)
    sampler = make_ddpm_sampler(lambda m, x, t, f: m(x, t, hint_features=f), sched,
                                (2, 1, 8, 8), record_every=2, compute_dtype=torch.bfloat16,
                                device=CPU)
    with torch.no_grad():
        feats = cn.hint_features(hint)
    a = sampler(cn, torch.Generator().manual_seed(5), feats)
    b = sampler(cn, torch.Generator().manual_seed(5), feats)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    x0, traj = a
    assert x0.dtype == torch.float32 and traj.shape == (2, 2, 1, 8, 8)
    assert torch.isfinite(x0).all() and traj.abs().max() <= 1.0
