"""Port few-step samplers and guidance (controlnet_tpu_torch.sample: ddim, dpm,
cfg, make_few_step_sampler, make_ldm_sampler) and the latent sample tool
against the JAX package.

JAX threefry and torch's generators never give the same numbers, so the
tests repeat the JAX samplers' key discipline with ``jax.random`` (x_T from
the first split of the key, sample/common.py:34-35; with eta != 0 one more
split per DDIM step, sample/ddim.py:82, drawn in schedules/linear.py:144) and
hand x_T and the per-step noise to the port.  Tolerance: 2e-4 absolute for a
whole sampling loop at the tiny configs (a handful of model calls, each
within 1e-4, fed back through the update rule), also after the VAE decode.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _torch_port_util import NARROW_LDM, Z, random_params, to_nchw, to_nhwc
from controlnet_tpu.io.torch_export import export_controlnet, export_vae, save_torch_checkpoint
from controlnet_tpu.models.controlnet import ControlNet as JaxControlNet
from controlnet_tpu.models.vae import VAE as JaxVAE
from controlnet_tpu.sample import make_few_step_sampler as jax_make_few_step_sampler
from controlnet_tpu.sample import make_ldm_sampler as jax_make_ldm_sampler
from controlnet_tpu.sample.cfg import make_cfg_eps_fn as jax_make_cfg_eps_fn
from controlnet_tpu.sample.cfg import null_hint_features as jax_null_hint_features
from controlnet_tpu.sample.ddim import ddim_timesteps as jax_ddim_timesteps
from controlnet_tpu.schedules import linear as jax_linear
from controlnet_tpu_torch import cli
from controlnet_tpu_torch.io import jax_params
from controlnet_tpu_torch.models.controlnet import ControlNet
from controlnet_tpu_torch.sample import (ddim_timesteps, make_few_step_sampler,
                                         make_ldm_sampler)
from controlnet_tpu_torch.sample.cfg import make_cfg_eps_fn, null_hint_features
from controlnet_tpu_torch.schedules import linear
from controlnet_tpu_torch.tools import sample_ldm_controlnet as ldm_tool

CPU = "cpu"
ATOL = 2e-4
T = 20


@pytest.mark.parametrize("num_timesteps,num_steps",
                         [(1000, 50), (1000, 20), (1000, 1000), (1000, 999), (10, 7), (100, 1)])
def test_ddim_timesteps_equal(num_timesteps, num_steps):
    ref = jax_ddim_timesteps(num_timesteps, num_steps)
    ts = ddim_timesteps(num_timesteps, num_steps)
    np.testing.assert_array_equal(ts, ref)
    assert ts[0] == num_timesteps - 1 and (ts[-1] == 0 or num_steps == 1)


def test_ddim_timesteps_rejects_bad_counts():
    for n in (0, 11):
        with pytest.raises(ValueError, match="num_steps"):
            ddim_timesteps(10, n)


def _jax_noise(key, shape, steps):
    """x_T and the per-step noise as the JAX DDIM sampler draws them."""
    k0, key = jax.random.split(key)
    x_start = np.asarray(jax.random.normal(k0, shape, jnp.float32))
    zs = np.zeros((steps, *shape), np.float32)
    for i in range(steps):
        key, kstep = jax.random.split(key)
        zs[i] = np.asarray(jax.random.normal(kstep, shape, jnp.float32))
    return x_start, zs


@pytest.fixture(scope="module")
def ddpm_setup():
    """The tiny DDPM ControlNet on both sides, with hint features and the
    null-hint features computed by each side's own code."""
    from conftest import TINY_MODEL_CONFIG as cfg

    b, size = 2, cfg["im_size"]
    jcn = JaxControlNet(cfg["im_channels"], cfg)
    p = random_params(jcn, 50)
    cn = ControlNet(cfg["im_channels"], cfg).eval()
    cn.load_state_dict(jax_params.controlnet_state_dict_from_jax(p), strict=True)
    hint = np.random.default_rng(50).uniform(size=(b, size, size, 3)).astype(np.float32)
    jfeats = jcn.hint_features(p, jnp.asarray(hint))
    jnull = jax_null_hint_features(jcn.hint_features, p, hint.shape[1:], b)
    with torch.no_grad():
        feats = cn.hint_features(to_nchw(hint))
        null = null_hint_features(cn.hint_features, to_nchw(hint))
    np.testing.assert_allclose(to_nhwc(null), np.asarray(jnull), atol=1e-5)
    return SimpleNamespace(
        cfg=cfg, b=b, size=size, jcn=jcn, p=p, cn=cn, jfeats=jfeats, jnull=jnull, feats=feats,
        null=null, jshape=(b, size, size, cfg["im_channels"]),
        shape=(b, cfg["im_channels"], size, size),
        jsched=jax_linear.make_linear_schedule(T, 1e-4, 0.02),
        sched=linear.make_linear_schedule(T, 1e-4, 0.02, device=CPU),
        jeps=lambda pp, x, t, f: jcn(pp, x, t, hint_features=f),
        eps=lambda m, x, t, f: m(x, t, hint_features=f))


def _assert_sample_equal(got, ref):
    x0, traj = got
    ref_x0, ref_traj = ref
    assert traj.shape[0] == ref_traj.shape[0]
    np.testing.assert_allclose(to_nhwc(x0), np.asarray(ref_x0), atol=ATOL)
    for k in range(traj.shape[0]):
        np.testing.assert_allclose(to_nhwc(traj[k]), np.asarray(ref_traj[k]), atol=ATOL)


@pytest.mark.parametrize("kind,eta", [("ddim", 0.0), ("ddim", 0.7), ("dpm", 0.0)])
def test_few_step_samplers_match_jax(ddpm_setup, kind, eta):
    s = ddpm_setup
    steps = 5
    key = jax.random.PRNGKey(12)
    jax_sampler = jax_make_few_step_sampler(kind, s.jeps, s.jsched, s.jshape, steps, eta=eta)
    ref = jax_sampler(s.p, key, s.jfeats)
    sampler = make_few_step_sampler(kind, s.eps, s.sched, s.shape, steps, eta=eta, device=CPU)
    assert sampler.timesteps == jax_sampler.timesteps == [19, 14, 10, 5, 0]
    x_start, zs = _jax_noise(key, s.jshape, steps)
    noise = {}
    if eta:
        noise["step_noise"] = torch.from_numpy(zs.transpose(0, 1, 4, 2, 3).copy())
    got = sampler(s.cn, None, s.feats, x_start=to_nchw(x_start), **noise)
    assert got[1].shape == (steps, *s.shape) and got[1].abs().max() <= 1.0
    _assert_sample_equal(got, ref)


def test_dpm_rejects_eta_and_unknown_kind(ddpm_setup):
    s = ddpm_setup
    with pytest.raises(ValueError, match="deterministic"):
        make_few_step_sampler("dpm", s.eps, s.sched, s.shape, 5, eta=0.5, device=CPU)
    with pytest.raises(ValueError, match="unknown few-step sampler"):
        make_few_step_sampler("euler", s.eps, s.sched, s.shape, 5, device=CPU)


def test_ddim_noise_from_generator_is_reproducible(ddpm_setup):
    s = ddpm_setup
    sampler = make_few_step_sampler("ddim", s.eps, s.sched, s.shape, 4, eta=1.0,
                                    compute_dtype=torch.bfloat16, device=CPU)
    a = sampler(s.cn, torch.Generator().manual_seed(3), s.feats)
    b = sampler(s.cn, torch.Generator().manual_seed(3), s.feats)
    c = sampler(s.cn, torch.Generator().manual_seed(4), s.feats)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a[0].dtype == torch.float32 and not torch.equal(a[0], c[0])


SCALES = (0.0, 1.0, 2.5)


def test_cfg_eps_matches_jax(ddpm_setup):
    """Guided epsilon, batched and unbatched, at scales 0, 1 and 2.5."""
    s = ddpm_setup
    rng = np.random.default_rng(51)
    x = rng.standard_normal(s.jshape).astype(np.float32)
    t = np.array([17, 3])
    cases = [(scale, batched) for scale in SCALES for batched in (True, False)]

    @jax.jit
    def jax_all(p, x, t, pair):
        return [jax_make_cfg_eps_fn(s.jeps, scale, batched)(p, x, t, pair)
                for scale, batched in cases]

    refs = jax_all(s.p, jnp.asarray(x), jnp.asarray(t), (s.jfeats, s.jnull))
    with torch.no_grad():
        plain = s.eps(s.cn, to_nchw(x), torch.from_numpy(t), s.feats)
        uncond = s.eps(s.cn, to_nchw(x), torch.from_numpy(t), s.null)
        for (scale, batched), ref in zip(cases, refs):
            out = make_cfg_eps_fn(s.eps, scale, batched)(s.cn, to_nchw(x), torch.from_numpy(t),
                                                         (s.feats, s.null))
            np.testing.assert_allclose(to_nhwc(out), np.asarray(ref), atol=1e-4,
                                       err_msg=f"scale {scale} batched {batched}")
            if scale in (0.0, 1.0):  # the endpoints are the two branches themselves
                torch.testing.assert_close(out, plain if scale else uncond, rtol=0, atol=1e-5)
    assert not torch.allclose(plain, uncond, atol=1e-3)


@pytest.mark.parametrize("kind", ["ancestral", "dpm"])
def test_cfg_sampler_matches_jax(ddpm_setup, kind):
    """CFG (scale 2.5, batched) through a whole loop with the hint a
    (conditional, null) pair, selected as the tools select it."""
    s = ddpm_setup
    key = jax.random.PRNGKey(13)
    jeps = jax_make_cfg_eps_fn(s.jeps, 2.5)
    eps, hint_arg = cli.apply_cfg(2.5, s.eps, s.feats, lambda: s.null)
    assert cli.apply_cfg(None, s.eps, s.feats, None) == (s.eps, s.feats)
    if kind == "dpm":
        ref = jax_make_few_step_sampler("dpm", jeps, s.jsched, s.jshape, 4)(
            s.p, key, (s.jfeats, s.jnull))
        x_start, _ = _jax_noise(key, s.jshape, 0)
        sampler, ts = cli.select_sampler("dpm", 4, 0.0, eps, s.sched, s.shape, 1, device=CPU)
        assert ts == [19, 13, 6, 0] and cli.snapshot_timestep(1, ts, T, 1) == 13
        got = sampler(s.cn, None, hint_arg, x_start=to_nchw(x_start))
    else:
        from controlnet_tpu.sample.ddpm import make_ddpm_sampler as jax_make_ddpm_sampler

        ref = jax_make_ddpm_sampler(jeps, s.jsched, s.jshape, record_every=10)(
            s.p, key, (s.jfeats, s.jnull))
        x_start, zs = _jax_noise(key, s.jshape, T)
        sampler, ts = cli.select_sampler("ancestral", 50, 0.0, eps, s.sched, s.shape, 10,
                                         device=CPU)
        assert ts is None and cli.snapshot_timestep(1, ts, T, 10) == 0
        got = sampler(s.cn, None, hint_arg, x_start=to_nchw(x_start),
                      step_noise=torch.from_numpy(zs.transpose(0, 1, 4, 2, 3).copy()))
    _assert_sample_equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_null_hint_features_follow_the_hints_type(dtype):
    """The null hint is zeros of the conditional hint's type and device, at
    batch 1, expanded to the batch: not a float32 default."""
    seen = []

    def fn(h):
        seen.append((h.dtype, tuple(h.shape)))
        return h[:, :1] + 1.0

    hint = torch.ones(3, 2, 4, 4, dtype=dtype)
    null = null_hint_features(fn, hint)
    assert seen == [(dtype, (1, 2, 4, 4))]
    assert null.dtype == dtype and null.shape == (3, 1, 4, 4) and null.is_contiguous()
    assert bool((null == 1.0).all())


def test_mnist_tool_takes_sampler_and_cfg_flags(ddpm_setup, tmp_path):
    """The DDPM sample tool with --sampler / --sampler_steps / --cfg_scale:
    one grid per visited timestep; the float sample equals the sampler built
    by hand from the same parts."""
    from controlnet_tpu_torch.tools import sample_ddpm_controlnet as tool

    s = ddpm_setup
    task = tmp_path / "task"
    os.makedirs(task)
    save_torch_checkpoint(export_controlnet(s.p, s.jcn), str(task / "cn.pth"))
    config = {
        "diffusion_params": {"num_timesteps": T, "beta_start": 1e-4, "beta_end": 0.02},
        "model_params": dict(s.cfg),
        "train_params": {"task_name": str(task), "num_samples": 2, "num_grid_rows": 2,
                         "controlnet_ckpt_name": "cn.pth"},
    }
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(config))
    hints = np.random.default_rng(52).uniform(size=(4, s.size, s.size, 3)).astype(np.float32)
    np.save(tmp_path / "hints.npy", hints)
    tool.main(["--config", str(tmp_path / "cfg.yaml"), "--hints", str(tmp_path / "hints.npy"),
               "--sampler", "dpm", "--sampler_steps", "4", "--cfg_scale", "2.5",
               "--device", "cpu"])
    assert sorted(os.listdir(task / "hint_samples")) == [
        "hints.png", "x0_0.png", "x0_13.png", "x0_19.png", "x0_6.png"]

    cn, sched = tool.load_model(config, str(task / "cn.pth"), device=CPU)
    picked = tool.gather_hints(hints, 2, seed=0)
    x0, traj = tool.sample(cn, sched, picked, seed=0, sampler="dpm", sampler_steps=4,
                           cfg_scale=2.5)
    with torch.no_grad():
        feats = cn.hint_features(to_nchw(picked))
        null = null_hint_features(cn.hint_features, to_nchw(picked))
    by_hand = make_few_step_sampler("dpm", make_cfg_eps_fn(s.eps, 2.5), sched, s.shape, 4,
                                    device=CPU)
    ref_x0, _ = by_hand(cn, torch.Generator().manual_seed(0), (feats, null))
    assert traj.shape == (4, *s.shape)
    torch.testing.assert_close(x0, ref_x0, rtol=0, atol=1e-6)
    plain, _ = tool.sample(cn, sched, picked, seed=0, sampler="dpm", sampler_steps=4)
    assert (x0 - plain).abs().max() > 1e-3  # guidance moves the sample


@pytest.fixture(scope="module")
def ldm_setup():
    """Narrow LDM ControlNet (factor 4: hints 32^2, latents 8^2) and tiny VAE
    (one downsample: images 16^2) as JAX trees and as exported .pth trees."""
    from conftest import TINY_VAE_CONFIG

    vae_cfg = dict(TINY_VAE_CONFIG, z_channels=Z)
    jcn = JaxControlNet(Z, NARROW_LDM, down_sample_factor=4)
    jvae = JaxVAE(3, vae_cfg)
    p, vp = random_params(jcn, 60), random_params(jvae, 61)
    # a louder control branch, so that guidance visibly moves the sample
    p["hint_block"]["layers"][-1]["w"] *= 30.0
    for zp in p["down_zero"] + p["mid_zero"]:
        zp["w"] *= 5.0
    config = {
        "dataset_params": {"im_channels": 3, "im_size": 16, "canny_im_size": 32},
        "diffusion_params": {"num_timesteps": T, "beta_start": 0.0015, "beta_end": 0.0195},
        "ldm_params": dict(NARROW_LDM),
        "autoencoder_params": vae_cfg,
    }
    hints = (np.random.default_rng(60).uniform(size=(6, 32, 32, 3)) < 0.2).astype(np.float32)
    return SimpleNamespace(jcn=jcn, jvae=jvae, p=p, vp=vp, config=config, hints=hints,
                           sd=export_controlnet(p, jcn), vae_sd=export_vae(vp))


def test_ldm_sampler_dpm_cfg_decode_matches_jax(ldm_setup, tmp_path):
    """The slice as a whole, through the tool's own functions: reference-format
    .pth files -> models -> hint features in chunks -> DPM-Solver++ 5 steps
    with guidance -> VAE decode, against the JAX latent sampler on the same
    x_T."""
    s = ldm_setup
    save_torch_checkpoint(s.sd, str(tmp_path / "cn.pth"))
    save_torch_checkpoint(s.vae_sd, str(tmp_path / "vae.pth"))
    hints = s.hints[:2]
    key = jax.random.PRNGKey(14)

    jsched = jax_linear.make_linear_schedule(T, 0.0015, 0.0195, ldm_scheduler=True)
    jfeats = s.jcn.hint_features_chunked(s.p, jnp.asarray(hints))
    jnull = jax_null_hint_features(s.jcn.hint_features, s.p, hints.shape[1:], 2)
    jeps = jax_make_cfg_eps_fn(lambda pp, x, t, f: s.jcn(pp, x, t, hint_features=f), 2.0)
    jax_sampler = jax_make_ldm_sampler(jeps, lambda vp, z: s.jvae.decode(vp, z), jsched,
                                       (2, 8, 8, Z), ddim_steps=5, solver="dpm")
    ref_images, ref_traj = jax_sampler(s.p, s.vp, key, (jfeats, jnull))

    cn, vae, sched = ldm_tool.load_models(s.config, str(tmp_path / "cn.pth"),
                                          str(tmp_path / "vae.pth"), device=CPU)
    assert cn.down_sample_factor == 4
    loop, hint_arg = ldm_tool.prepare(cn, sched, hints, sampler="dpm", sampler_steps=5,
                                      cfg_scale=2.0, hint_chunk=1)
    assert loop.timesteps == jax_sampler.timesteps
    x_start, _ = _jax_noise(key, (2, 8, 8, Z), 0)
    images, traj = loop(cn, vae, None, hint_arg, x_start=to_nchw(x_start))
    assert images.shape == (2, 3, 16, 16) and traj.shape == (5, 2, Z, 8, 8)
    np.testing.assert_allclose(to_nhwc(traj[-1]), np.asarray(ref_traj[-1]), atol=ATOL)
    np.testing.assert_allclose(to_nhwc(images), np.asarray(ref_images), atol=ATOL)


def test_make_ldm_sampler_ancestral_decodes_the_final_latent(ldm_setup):
    s = ldm_setup
    cn, vae, sched = ldm_tool.load_models(s.config, None, None, device=CPU)
    vae.load_state_dict(jax_params._to_torch(s.vae_sd))
    eps = lambda m, x, t: torch.zeros_like(x)  # noqa: E731
    sampler = make_ldm_sampler(eps, lambda v, z: v.decode(z), sched, (2, Z, 8, 8),
                               record_every=10, device=CPU)
    assert sampler.timesteps is None
    images, traj = sampler(None, vae, torch.Generator().manual_seed(0))
    assert traj.shape == (2, 2, Z, 8, 8)
    with torch.no_grad():
        # the trajectory is clamped, the decoded latent is not: decode the clamp of a
        # latent the clamp leaves alone
        inside = traj[-1] * 0.5
        torch.testing.assert_close(vae.decode(inside), vae.decode(inside.clone()))
    assert images.shape == (2, 3, 16, 16) and torch.isfinite(images).all()


def test_ldm_tool_end_to_end_cpu(ldm_setup, tmp_path):
    """config -> two .pth -> hints .npy -> PNG grids, for a few-step run with
    guidance; the assertions on values are on the float sampler output."""
    s = ldm_setup
    task = tmp_path / "task"
    os.makedirs(task)
    save_torch_checkpoint(s.sd, str(task / "cn.pth"))
    save_torch_checkpoint(s.vae_sd, str(task / "vae.pth"))
    config = dict(s.config, train_params={
        "task_name": str(task), "num_samples": 3, "num_grid_rows": 2,
        "controlnet_ckpt_name": "cn.pth", "vae_autoencoder_ckpt_name": "vae.pth"})
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(config))
    np.save(tmp_path / "hints.npy", s.hints)
    ldm_tool.main(["--config", str(cfg_path), "--hints", str(tmp_path / "hints.npy"),
                   "--sampler", "ddim", "--sampler_steps", "3", "--cfg_scale", "2.0",
                   "--hint_chunk", "2", "--device", "cpu"])
    out = sorted(os.listdir(task / "hint_samples"))
    assert out == ["final_decoded.png", "hints.png", "x0_0.png", "x0_10.png", "x0_19.png"]

    cn, vae, sched = ldm_tool.load_models(config, str(task / "cn.pth"), str(task / "vae.pth"),
                                          device=CPU)
    hints = ldm_tool.gather_hints(s.hints, 3, seed=0)
    runs = {name: ldm_tool.sample(cn, vae, sched, hints, seed=0, **flags)
            for name, flags in {
                "cfg2": dict(sampler="ddim", sampler_steps=3, cfg_scale=2.0),
                "again": dict(sampler="ddim", sampler_steps=3, cfg_scale=2.0, hint_chunk=2),
                "plain": dict(sampler="ddim", sampler_steps=3),
                "scale1": dict(sampler="ddim", sampler_steps=3, cfg_scale=1.0),
                "ancestral": dict(record_every=5)}.items()}
    images, traj = runs["cfg2"]
    assert images.shape == (3, 3, 16, 16) and traj.shape == (3, 3, Z, 8, 8)
    assert images.dtype == torch.float32 and torch.isfinite(images).all()
    torch.testing.assert_close(runs["again"][0], images, rtol=0, atol=1e-5)
    # scale 1 is the plain conditional model; scale 2 moves the sample
    torch.testing.assert_close(runs["scale1"][0], runs["plain"][0], rtol=0, atol=1e-4)
    assert (images - runs["plain"][0]).abs().max() > 1e-3
    assert runs["ancestral"][1].shape == (T // 5, 3, Z, 8, 8)
    with pytest.raises(ValueError, match="do not divide"):
        ldm_tool.prepare(cn, sched, np.zeros((1, 30, 30, 3), np.float32))
