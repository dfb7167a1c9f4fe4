"""The port's distillation slice (schedules/karras.py, schedules/consistency.py,
nn/layers.BatchNorm, models/consistency.py, models/dmd.py, the consistency and
DMD train steps, ``ClippedAdamW``, the student state dicts) against the JAX
package, on the CPU.

Same-seed numpy inputs go through the JAX function and the port's.  JAX
threefry and torch generators never agree, so where the JAX side draws (sigma,
t, the coin, x_T, noise) the test replays the JAX function's own key
discipline and injects the draws into the port.  Tolerances: the schedules
within 1e-6 (relative), ``sigma_to_timestep`` and the noise-level index
exact, BatchNorm and the feature extractor 1e-5 of max|out|, the students'
forwards 1e-4 of max|out|, every DMD loss term rtol 1e-5, ``generate`` 2e-4
of max(1, max|out|).  Train steps (3 per mode, tiny config): float32 losses
rtol 1e-5 and the weights and the EMA after within 1e-2 * lr on the
noise-floor rule of tests/test_torch_port_train.py: weights whose gradient
fell below 1e-6 in a step are Adam-normalised noise on both sides, are not
held, and take the JAX step's values after that step (``_noisy``), so the
noise does not feed the next step's loss.  bf16 DMD (the student in bf16,
the feature moments cubed): the losses rtol 5e-2 and ``grad_norm`` 0.25; its
gradient lies ~30% from the float32 one (norm of the difference) on either
side and as far from the other side's, which Adam turns into O(lr) weight
noise, so the weights are held in float32 only.  The optimizer against
optax's chain: rtol 1e-6.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_util import MNIST_CONFIG, np_tree, random_params, to_nchw, to_nhwc
from conftest import TINY_MODEL_CONFIG
from controlnet_tpu.io.torch_export import export_distilled_student
from controlnet_tpu.models.consistency import ConsistencyDistilled as JaxConsistencyDistilled
from controlnet_tpu.models.controlnet import ControlNet as JaxControlNet
from controlnet_tpu.models.dmd import DistributionMatchingDistilled as JaxDMD
from controlnet_tpu.nn.layers import BatchNorm as JaxBatchNorm
from controlnet_tpu.schedules import karras as jax_karras
from controlnet_tpu.schedules.consistency import ConsistencyScheduler as JaxConsistencyScheduler
from controlnet_tpu.schedules.linear import make_linear_schedule as jax_schedule
from controlnet_tpu.train.loops import make_consistency_train_step as jax_cons_step
from controlnet_tpu.train.loops import make_dmd_train_step as jax_dmd_step
from controlnet_tpu.train.state import create_train_state as jax_train_state
from controlnet_tpu_torch.io import jax_params
from controlnet_tpu_torch.models.consistency import ConsistencyControlNet, ConsistencyDistilled
from controlnet_tpu_torch.models.dmd import (DistributionMatchingControlNet,
                                             DistributionMatchingDistilled, FeatureExtractor)
from controlnet_tpu_torch.nn.layers import BatchNorm
from controlnet_tpu_torch.schedules import karras
from controlnet_tpu_torch.schedules.consistency import ConsistencyScheduler
from controlnet_tpu_torch.schedules.linear import make_linear_schedule
from controlnet_tpu_torch.train.loops import make_consistency_train_step, make_dmd_train_step
from controlnet_tpu_torch.train.state import (ClippedAdamW, create_dmd_train_state,
                                              create_train_state)
from test_torch_port_train import LR, NOISE_FLOOR, _noisy_weights

T = 50
CFG = TINY_MODEL_CONFIG


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the suite runs in
    parallel workers, and at these sizes torch's thread pool only contends
    with theirs (the tiny trainer runs took ~100x longer so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def student_sd(p):
    return jax_params.student_state_dict_from_jax(np_tree(p))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 10, 1000])
def test_geometric_and_karras_sigmas(n):
    assert _rel(karras.geometric_sigmas(n, 0.002, 80.0).numpy(),
                jax_karras.geometric_sigmas(n, 0.002, 80.0)) < 1e-6
    assert _rel(karras.karras_sigmas(n, 0.002, 80.0).numpy(),
                jax_karras.karras_sigmas(n, 0.002, 80.0)) < 1e-6


def test_karras_sigmas_raise_below_two_steps():
    for n in (0, 1):
        with pytest.raises(ValueError, match="num_steps >= 2"):
            karras.karras_sigmas(n, 0.002, 80.0)


def test_log_uniform_sigmas_and_sigma_add_noise():
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jax_karras.sample_log_uniform_sigmas(key, 64, 0.002, 80.0))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (64,), jnp.float32)))
    got = karras.sample_log_uniform_sigmas(64, 0.002, 80.0, u=u).numpy()
    assert _rel(got, ref) < 1e-6
    g = torch.Generator().manual_seed(0)
    drawn = karras.sample_log_uniform_sigmas(4096, 0.002, 80.0, generator=g)
    assert drawn.min() >= 0.002 * (1 - 1e-6) and drawn.max() <= 80.0 * (1 + 1e-6)

    rng = np.random.default_rng(4)
    x0 = rng.standard_normal((3, 8, 8, 1)).astype(np.float32)
    sigma = np.array([0.01, 1.0, 50.0], np.float32)
    ref_xt, ref_noise = jax_karras.sigma_add_noise(jnp.asarray(x0), jnp.asarray(sigma), key)
    xt, noise = karras.sigma_add_noise(to_nchw(x0), torch.from_numpy(sigma),
                                       noise=to_nchw(np.asarray(ref_noise)))
    np.testing.assert_allclose(to_nhwc(xt), np.asarray(ref_xt), rtol=1e-6, atol=1e-6)


def test_sigma_to_timestep_exact():
    sched = jax_schedule(1000, 1e-4, 0.02)
    implied = np.sqrt((1 - np.asarray(sched.alpha_cum_prod)) / np.asarray(sched.alpha_cum_prod))
    mids = (implied[:-1] + implied[1:]) / 2  # ties between neighbours, in float32
    sigma = np.concatenate([np.geomspace(1e-3, 200.0, 257), implied[::37], mids[::41],
                            [0.0, 1e6]]).astype(np.float32)
    ref = np.asarray(jax_karras.sigma_to_timestep(jnp.asarray(sigma), sched.alpha_cum_prod))
    # the same table on both sides: the port's own (torch.cumprod) differs from
    # JAX's in the last bit here and there, which moves a tie
    acp = torch.from_numpy(np.array(sched.alpha_cum_prod))
    got = karras.sigma_to_timestep(torch.from_numpy(sigma), acp)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    port_acp = make_linear_schedule(1000, 1e-4, 0.02, device="cpu").alpha_cum_prod
    assert _rel(port_acp.numpy(), acp.numpy()) < 1e-6


def test_consistency_scheduler_matches_jax():
    jsched = JaxConsistencyScheduler(40)
    sched = ConsistencyScheduler(40, device="cpu")
    assert _rel(sched.sigmas.numpy(), jsched.sigmas) < 1e-6
    rng = np.random.default_rng(5)
    x0 = rng.standard_normal((4, 8, 8, 1)).astype(np.float32)
    x_t = rng.standard_normal((4, 8, 8, 1)).astype(np.float32)
    t = np.array([0, 1, 17, 39])
    key = jax.random.PRNGKey(9)

    def jfn(x, tt, h):
        return x * jsched.sigmas[tt].reshape(-1, 1, 1, 1) + h

    def pfn(x, tt, h):
        return x * sched.sigmas[tt].reshape(-1, 1, 1, 1) + h

    ref = float(jsched.consistency_loss(jfn, jnp.asarray(x_t), jnp.asarray(t), 0.5,
                                        jnp.asarray(x0), key))
    noise = np.asarray(jax.random.normal(key, x0.shape, jnp.float32))
    got = sched.consistency_loss(pfn, to_nchw(x_t), torch.from_numpy(t), 0.5, to_nchw(x0),
                                 noise=to_nchw(noise)).item()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    ref_xt, _ = jsched.add_noise(jnp.asarray(x0), jnp.asarray(t), key)
    xt, _ = sched.add_noise(to_nchw(x0), torch.from_numpy(t), noise=to_nchw(noise))
    np.testing.assert_allclose(to_nhwc(xt), np.asarray(ref_xt), rtol=1e-6, atol=1e-6)
    out = sched.sample(pfn, to_nchw(x_t).requires_grad_(), torch.from_numpy(t), 0.5)
    assert out.grad_fn is None


# ---------------------------------------------------------------------------
# layers and models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_matches_jax(dtype):
    rng = np.random.default_rng(6)
    x = (3.0 * rng.standard_normal((5, 6, 6, 7)) + 1.5).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(7)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(7)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = JaxBatchNorm(7)({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                          jnp.asarray(x, jdt))
    bn = BatchNorm(7)
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    xin = to_nchw(x).to(getattr(torch, dtype))
    out = bn(xin)
    assert out.dtype == xin.dtype and not hasattr(bn, "running_mean")
    ref = np.asarray(ref.astype(jnp.float32))
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    assert np.abs(to_nhwc(out) - ref).max() <= tol * np.abs(ref).max()


def test_feature_extractor_matches_jax():
    jm = JaxDMD(1, CFG, num_timesteps=T)
    fp = jm.feature_extractor.init(jax.random.PRNGKey(11))
    fe = FeatureExtractor(1)
    fe.load_state_dict(jax_params.features_state_dict_from_jax(np_tree(fp)), strict=True)
    assert not any(p.requires_grad for p in fe.parameters())
    x = np.random.default_rng(7).uniform(-1, 1, (4, 28, 28, 1)).astype(np.float32)
    ref = jax.jit(jm.feature_extractor.__call__)(fp, jnp.asarray(x))
    xin = to_nchw(x).requires_grad_()
    got = fe(xin)
    assert [tuple(f.shape) for f in got] == [(4, 32, 28, 28), (4, 64, 14, 14), (4, 128, 7, 7),
                                             (4, 256, 4, 4)]
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert np.abs(to_nhwc(g) - r).max() <= 1e-5 * np.abs(r).max()
    sum(f.sum() for f in got).backward()  # gradients reach the input, not the weights
    assert xin.grad is not None and all(p.grad is None for p in fe.parameters())


def test_feature_extractor_init_is_seeded_kaiming_fan_out():
    a, b, c = FeatureExtractor(1, seed=3), FeatureExtractor(1, seed=3), FeatureExtractor(3)
    for (k, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), k
    w = a.stages[3].conv2.weight
    assert abs(w.std().item() - np.sqrt(2.0 / (256 * 9))) < 0.05 * np.sqrt(2.0 / (256 * 9))
    assert c.stages[0].conv1.out_channels == 64 and a.stages[0].conv1.out_channels == 32


def _student_pair(kind, cfg, seed):
    if kind == "consistency":
        jm = JaxConsistencyDistilled(1, cfg, use_ddpm_teacher=False).student
        port = ConsistencyControlNet(1, cfg)
    else:
        jm = JaxDMD(1, cfg).student
        port = DistributionMatchingControlNet(1, cfg)
    p = random_params(jm, seed)
    port.load_state_dict(student_sd(p), strict=True)
    return jm, p, port


def _student_inputs(kind, b, size, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, size, size, 1)).astype(np.float32)
    h = (rng.uniform(size=(b, size, size, 3)) < 0.2).astype(np.float32)
    if kind == "consistency":
        cond = np.geomspace(0.01, 80.0, b).astype(np.float32)
    else:
        cond = np.linspace(0, 999, b).astype(np.int32)
    return x, h, cond


@pytest.mark.parametrize("width", ["tiny", "mnist"])
@pytest.mark.parametrize("kind", ["consistency", "dmd"])
def test_student_forward_matches_jax(kind, width):
    cfg = CFG if width == "tiny" else MNIST_CONFIG
    b = 4 if width == "tiny" else 2
    jm, p, port = _student_pair(kind, cfg, 20)
    x, h, cond = _student_inputs(kind, b, cfg["im_size"], 21)
    ref = np.asarray(jax.jit(jm.__call__)(p, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(h)))
    with torch.no_grad():
        out = port(to_nchw(x), torch.from_numpy(cond), to_nchw(h))
    assert out.dtype == torch.float32
    assert np.abs(to_nhwc(out) - ref).max() <= 1e-4 * np.abs(ref).max()


def test_consistency_boundary_is_per_sample():
    jm, p, port = _student_pair("consistency", CFG, 22)
    x, h, _ = _student_inputs("consistency", 4, 8, 23)
    sigma = np.array([0.001, 0.002, 0.0021, 10.0], np.float32)
    ref = np.asarray(jax.jit(jm.__call__)(p, jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(h)))
    with torch.no_grad():
        out = to_nhwc(port(to_nchw(x), torch.from_numpy(sigma), to_nchw(h)))
    np.testing.assert_array_equal(out[:2], x[:2])  # at or below sigma_min: x itself
    assert np.abs(out[2:] - x[2:]).max() > 1e-3
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()


def test_noise_index_truncates_as_jax():
    port = ConsistencyControlNet(1, CFG)
    e4 = np.exp(np.float32(4.0))
    edge = np.exp(np.float32(0.5))  # c_noise * 1000 = 125 exactly in real numbers
    sigma = np.array([1e-9, 0.5, np.nextafter(np.float32(1), 0), 1.0, np.nextafter(np.float32(1),
                      2), edge * (1 - 1e-6), edge, edge * (1 + 1e-6), e4 * (1 - 1e-6), e4,
                      e4 * (1 + 1e-6), 1e4], np.float32)
    jc = JaxConsistencyDistilled(1, CFG, use_ddpm_teacher=False).student
    c = jc.c_noise(jnp.asarray(sigma))
    ref = np.asarray(jnp.clip((c * 1000.0).astype(jnp.int32), 0, 999))
    got = port.noise_index(torch.from_numpy(sigma))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got[:5].tolist() == [0] * 5 and got[-1].item() == 999
    assert set(got[5:8].tolist()) <= {124, 125} and got[-2].item() == 999


def _eval_dtype(fn, *args):
    return jax.eval_shape(fn, *args).dtype


@pytest.mark.parametrize("which", ["consistency_student", "dmd_student", "controlnet_teacher",
                                   "consistency_teacher_x0", "dmd_teacher_x0"])
def test_bf16_output_dtypes_match_jax(which):
    """The consistency student runs in float32 under bf16 compute (c_in
    promotes its input); the DMD student and the teacher stay bf16; the
    teachers' x0 (eps_to_x0 with float32 tables) is float32 on both sides."""
    x = jnp.zeros((2, 8, 8, 1), jnp.bfloat16)
    h = jnp.zeros((2, 8, 8, 3), jnp.bfloat16)
    xt, ht = torch.zeros(2, 1, 8, 8, dtype=torch.bfloat16), torch.zeros(2, 3, 8, 8,
                                                                          dtype=torch.bfloat16)
    sigma, t = jnp.array([0.5, 5.0]), jnp.array([3, 40])
    jc = JaxConsistencyDistilled(1, CFG, num_timesteps=T)
    jd = JaxDMD(1, CFG, num_timesteps=T)
    pc = ConsistencyDistilled(1, CFG, num_timesteps=T, device="cpu")
    pd = DistributionMatchingDistilled(1, CFG, num_timesteps=T, device="cpu")
    jcp = jax.eval_shape(jc.init, jax.random.PRNGKey(0))
    jdp = jax.eval_shape(jd.init, jax.random.PRNGKey(0))
    st, tt = torch.tensor([0.5, 5.0]), torch.tensor([3, 40])
    cases = {
        "consistency_student": (lambda: _eval_dtype(lambda p: jc.student(p, x, sigma, h),
                                                    jcp["student"]),
                                lambda: pc.student(xt, st, ht)),
        "dmd_student": (lambda: _eval_dtype(lambda p: jd.student(p, x, t, h), jdp["student"]),
                        lambda: pd.student(xt, tt, ht)),
        "controlnet_teacher": (lambda: _eval_dtype(lambda p: jd.teacher(p, x, t, h),
                                                   jdp["teacher"]),
                               lambda: pd.teacher(xt, tt, ht)),
        "consistency_teacher_x0": (lambda: _eval_dtype(
            lambda p: jc.ddpm_teacher_prediction(p, x, sigma, h), jcp),
            lambda: pc.ddpm_teacher_prediction(xt, st, ht)),
        "dmd_teacher_x0": (lambda: _eval_dtype(lambda p: jd.teacher_prediction(p, x, t, h), jdp),
                           lambda: pd.teacher_prediction(xt, tt, ht)),
    }
    jax_fn, port_fn = cases[which]
    with torch.no_grad():
        got = port_fn().dtype
    assert str(got)[6:] == str(jax_fn())


# ---------------------------------------------------------------------------
# DMD losses
# ---------------------------------------------------------------------------

def _feats(seed, b=3, shapes=((4, 4, 5), (2, 2, 7))):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b,) + s) * rng.uniform(0.5, 2.0)).astype(np.float32)
            for s in shapes]


def _nchw_list(feats):
    return [to_nchw(f) for f in feats]


@pytest.mark.parametrize("term", ["feature_distribution_matching_loss", "gram_matrix_loss"])
def test_dmd_feature_terms_match_jax(term):
    pred, target = _feats(30), _feats(31)
    ref = float(getattr(JaxDMD, term)([jnp.asarray(f) for f in pred],
                                      [jnp.asarray(f) for f in target]))
    got = getattr(DistributionMatchingDistilled, term)(_nchw_list(pred), _nchw_list(target))
    np.testing.assert_allclose(got.item(), ref, rtol=1e-5)


def test_dmd_variance_is_biased():
    """With batch 2, torch's default (unbiased) variance is twice jnp.var;
    the port's term follows JAX and not the default."""
    pred, target = _feats(32, b=2), _feats(33, b=2)
    ref = float(JaxDMD.feature_distribution_matching_loss([jnp.asarray(f) for f in pred],
                                                          [jnp.asarray(f) for f in target]))
    got = DistributionMatchingDistilled.feature_distribution_matching_loss(
        _nchw_list(pred), _nchw_list(target)).item()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    unbiased = 0.0
    for pf, tf in zip(_nchw_list(pred), _nchw_list(target)):
        p, t = pf.reshape(2, -1), tf.reshape(2, -1)
        pm, tm = p.mean(0), t.mean(0)
        unbiased += (torch.mean((pm - tm) ** 2) + torch.mean((p.var(0) - t.var(0)) ** 2)
                     + 0.1 * torch.mean((((p - pm) ** 3).mean(0) - ((t - tm) ** 3).mean(0)) ** 2))
    assert abs(unbiased.item() / 2 - ref) > 1e-3 * abs(ref)


def test_dmd_wasserstein_and_total_match_jax():
    jm = JaxDMD(1, CFG, num_timesteps=T)
    fp = jm.feature_extractor.init(jax.random.PRNGKey(12))
    pm = DistributionMatchingDistilled(1, CFG, num_timesteps=T, device="cpu")
    pm.feature_extractor.load_state_dict(jax_params.features_state_dict_from_jax(np_tree(fp)))
    rng = np.random.default_rng(34)
    pred = (1.3 * rng.standard_normal((3, 8, 8, 1))).astype(np.float32)  # some beyond [-1, 1]
    target = rng.uniform(-1, 1, (3, 8, 8, 1)).astype(np.float32)
    ref = float(JaxDMD.wasserstein_distance_loss(jnp.asarray(pred), jnp.asarray(target)))
    got = DistributionMatchingDistilled.wasserstein_distance_loss(to_nchw(pred), to_nchw(target))
    np.testing.assert_allclose(got.item(), ref, rtol=1e-5)
    ref_total, ref_comps = jax.jit(jm.true_distribution_matching_loss)(
        {"features": fp}, jnp.asarray(pred), jnp.asarray(target))
    total, comps = pm.true_distribution_matching_loss(to_nchw(pred), to_nchw(target))
    np.testing.assert_allclose(total.item(), float(ref_total), rtol=1e-5)
    assert set(comps) == set(ref_comps) == {"feature_dist", "wasserstein", "gram", "pixel"}
    for k in comps:
        np.testing.assert_allclose(comps[k].item(), float(ref_comps[k]), rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps", [1, 4])
def test_consistency_generate_matches_jax(steps):
    jm = JaxConsistencyDistilled(1, CFG, use_ddpm_teacher=False)
    p = random_params(jm.student, 40)
    pm = ConsistencyDistilled(1, CFG, use_ddpm_teacher=False, device="cpu")
    pm.load_student(student_sd(p))
    hint = (np.random.default_rng(41).uniform(size=(4, 8, 8, 3)) < 0.2).astype(np.float32)
    shape = (4, 8, 8, 1)
    key = jax.random.PRNGKey(42)
    ref = np.asarray(jax.jit(lambda sp, h, k: jm.generate({"student": sp}, h, shape, k, steps))(
        p, jnp.asarray(hint), key))
    if steps == 1:
        x_start, noise = jax.random.normal(key, shape), None
    else:  # the key discipline of ConsistencyDistilled.generate
        k0, k = jax.random.split(key)
        x_start, noise = jax.random.normal(k0, shape), []
        for _ in range(steps):
            k, kn = jax.random.split(k)
            noise.append(to_nchw(np.asarray(jax.random.normal(kn, shape))))
    out = pm.generate(to_nchw(hint), (4, 1, 8, 8), num_steps=steps,
                      x_start=to_nchw(np.asarray(x_start)), noise=noise)
    assert np.abs(to_nhwc(out) - ref).max() <= 2e-4 * max(1.0, np.abs(ref).max())
    g = pm.generate(to_nchw(hint), (4, 1, 8, 8), torch.Generator().manual_seed(1), steps)
    torch.testing.assert_close(
        g, pm.generate(to_nchw(hint), (4, 1, 8, 8), torch.Generator().manual_seed(1), steps))


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _data(seed, b=4):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1, 1, (b, 8, 8, 1)).astype(np.float32)
    hint = (rng.uniform(size=(b, 8, 8, 3)) < 0.2).astype(np.float32)
    return x0, hint


def _compare(sd_port, sd_ref, before, noisy, bf16):
    """``_compare_params`` of tests/test_torch_port_train.py, with room for
    the tiny config's hint block: its 64 -> 128 conv holds 60% of the
    student's weights and takes many gradients below the floor, so up to a
    quarter of the weights may fall below it in some step."""
    clean, rough, upd_p, upd_r = [], [], [], []
    for k, low in noisy.items():
        p, r, b0 = (x.float().numpy() for x in (sd_port[k], sd_ref[k], before[k]))
        d, low = np.abs(p - r), low.numpy()
        clean.append(d[~low])
        rough.append(d[low])
        upd_p.append((p - b0).ravel())
        upd_r.append((r - b0).ravel())
    clean, rough, upd_p, upd_r = (np.concatenate(x) for x in (clean, rough, upd_p, upd_r))
    cos = float(upd_p @ upd_r / (np.linalg.norm(upd_p) * np.linalg.norm(upd_r)))
    assert np.abs(upd_r).max() > 0.5 * LR  # the steps moved the weights
    assert rough.size < 0.25 * (rough.size + clean.size)
    if bf16:
        assert np.concatenate([clean, rough]).mean() < 0.15 * LR
        assert cos > 0.97, cos
    else:
        assert clean.max() < 1e-2 * LR, clean.max() / LR


def _noisy(state, noisy, ref_sd):
    """The noise-floor rule of tests/test_torch_port_train.py, once per step:
    record where this step's gradient fell below the floor, then give those
    weights the JAX step's values.  Adam turns a gradient at float32's noise
    floor into a step of up to lr in a direction that differs between the
    frameworks; left in place, that noise would feed the next step's loss.
    A parameter outside the graph (the UNet's own time MLP, which the
    students bypass) has no gradient: zero on both sides."""
    for p in state.params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    noisy = _noisy_weights(state, noisy)
    with torch.no_grad():
        for k, p in state.params.items():
            low = p.grad.abs() < NOISE_FLOOR
            p[low] = ref_sd[k][low]
    return noisy


def _cons_draws(jm, mode, key, shape):
    """sigma / t and noise of one JAX consistency step (train/loops.py)."""
    k1, k2, k3 = jax.random.split(key, 3)
    b = shape[0]
    noise = to_nchw(np.asarray(jax.random.normal(k3, shape, jnp.float32)))
    as_t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    if mode == "consistency_only":
        return dict(sigma=as_t(jm.sample_sigmas(k1, b)), sigma_2=as_t(jm.sample_sigmas(k2, b)),
                    noise=noise)
    if mode == "manual":
        kc, kt1, kt2 = jax.random.split(k1, 3)
        coin = jax.random.uniform(kc, ())
        t_hi = jax.random.randint(kt1, (b,), int(0.75 * T), T)
        t_lo = jax.random.randint(kt2, (b,), 0, T)
        return dict(t=as_t(jnp.where(coin < 0.5, t_hi, t_lo)), noise=noise)
    return dict(sigma=as_t(jm.sample_sigmas(k1, b)), noise=noise)


def _consistency_pair(mode, seed):
    use_teacher = mode != "consistency_only"
    jm = JaxConsistencyDistilled(1, CFG, use_ddpm_teacher=use_teacher, num_timesteps=T)
    student = random_params(jm.student, seed)
    ema = random_params(jm.student, seed + 1)
    teacher = random_params(JaxControlNet(1, CFG), seed + 2) if use_teacher else {}
    pm = ConsistencyDistilled(1, CFG, use_ddpm_teacher=use_teacher, num_timesteps=T,
                              device="cpu")
    pm.load_student(student_sd(student), student_sd(ema))
    if use_teacher:
        pm.teacher.load_state_dict(
            jax_params.controlnet_state_dict_from_jax(np_tree(teacher)), strict=True)
    return jm, (student, ema, teacher), pm


@pytest.mark.parametrize("mode", ["ddpm_distillation", "consistency_only", "manual"])
def test_consistency_train_step_matches_jax(mode):
    jm, (student, ema, teacher), pm = _consistency_pair(mode, 50)
    tx = optax.adam(LR)
    jstate = jax_train_state(student, tx)
    jstep = jax_cons_step(jm, tx, mode=mode)
    jema = ema
    state = create_train_state(dict(pm.student.named_parameters()), LR)
    step = make_consistency_train_step(pm, state, mode)
    before = {k: v.clone() for k, v in pm.student.state_dict().items()}
    ema_before = {k: v.clone() for k, v in pm.ema_teacher.state_dict().items()}
    key, noisy = jax.random.PRNGKey(51), None
    for i in range(3):
        x0, hint = _data(60 + i)
        key, sk = jax.random.split(key)
        jstate, jema, jm_metrics = jstep(jstate, jema, teacher, jnp.asarray(x0),
                                         jnp.asarray(hint), sk, jnp.int32(0))
        metrics = step(to_nchw(x0), to_nchw(hint), **_cons_draws(jm, mode, sk, x0.shape))
        assert set(metrics) == set(jm_metrics)
        for k, v in metrics.items():
            assert v.dtype == torch.float32 and v.dim() == 0 and v.grad_fn is None
            np.testing.assert_allclose(v.item(), float(jm_metrics[k]), rtol=1e-5, err_msg=k)
        noisy = _noisy(state, noisy, student_sd(jstate.params))
    assert state.step == 3
    _compare(pm.student.state_dict(), student_sd(jstate.params), before, noisy, False)
    ema_sd, ema_ref = pm.ema_teacher.state_dict(), student_sd(jema)
    moved = max((ema_sd[k] - ema_before[k]).abs().max().item() for k in ema_sd)
    assert moved > 1e-3 * LR  # the EMA followed the student
    for k in ema_sd:
        np.testing.assert_allclose(ema_sd[k].numpy(), ema_ref[k].numpy(), rtol=0,
                                   atol=1e-2 * LR, err_msg=k)
        assert not ema_sd[k].requires_grad
    if mode != "consistency_only":
        assert all(p.grad is None for p in pm.teacher.parameters())


def test_consistency_step_checks_its_inputs():
    pm = ConsistencyDistilled(1, CFG, use_ddpm_teacher=False, num_timesteps=T, device="cpu")
    state = create_train_state(dict(pm.student.named_parameters()), LR)
    with pytest.raises(ValueError, match="unknown consistency training mode"):
        make_consistency_train_step(pm, state, "lcm")
    with pytest.raises(ValueError, match="needs the DDPM teacher"):
        make_consistency_train_step(pm, state, "manual")
    other = create_train_state(dict(pm.ema_teacher.named_parameters()), LR)
    with pytest.raises(ValueError, match="student's parameters"):
        make_consistency_train_step(pm, other, "consistency_only")
    # the EMA is a separate copy: no tensor is shared with the student
    ptrs = {p.data_ptr() for p in pm.student.parameters()}
    assert not ptrs & {p.data_ptr() for p in pm.ema_teacher.parameters()}


DMD_DECAY_STEPS = 100


@functools.lru_cache(maxsize=None)
def _jax_dmd(bf16: bool):
    """The JAX DMD model, its optimizer and its jitted step, shared by the
    tests so the step compiles once per compute type."""
    jm = JaxDMD(1, CFG, num_timesteps=T)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(optax.cosine_decay_schedule(LR, DMD_DECAY_STEPS),
                                 weight_decay=1e-6))
    return jm, tx, jax_dmd_step(jm, tx, compute_dtype=jnp.bfloat16 if bf16 else None)


def _dmd_pair(seed):
    jm = _jax_dmd(False)[0]
    student = random_params(jm.student, seed)
    teacher = random_params(JaxControlNet(1, CFG), seed + 1)
    features = jm.feature_extractor.init(jax.random.PRNGKey(seed + 2))
    pm = DistributionMatchingDistilled(1, CFG, num_timesteps=T, device="cpu")
    pm.student.load_state_dict(student_sd(student), strict=True)
    pm.teacher.load_state_dict(jax_params.controlnet_state_dict_from_jax(np_tree(teacher)),
                               strict=True)
    pm.feature_extractor.load_state_dict(
        jax_params.features_state_dict_from_jax(np_tree(features)), strict=True)
    state = create_dmd_train_state(dict(pm.student.named_parameters()), LR, DMD_DECAY_STEPS)
    return jm, (student, teacher, features), pm, state


def _dmd_draws(key, shape):
    """t and noise of one JAX DMD step (train/loops.py)."""
    kt1, kt2, kc, kn = jax.random.split(key, 4)
    b = shape[0]
    t_hi = jax.random.randint(kt1, (b,), int(0.75 * T), T)
    t_lo = jax.random.randint(kt2, (b,), 0, T)
    t = jnp.where(jax.random.uniform(kc, ()) < 0.5, t_hi, t_lo)
    noise = jax.random.normal(kn, shape, jnp.float32)
    return dict(t=torch.from_numpy(np.array(t)), noise=to_nchw(np.asarray(noise)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dmd_train_step_matches_jax(dtype):
    bf16 = dtype == "bfloat16"
    jm, (student, teacher, features), pm, state = _dmd_pair(70)
    _, tx, jstep = _jax_dmd(bf16)
    jstate = jax_train_state(student, tx)
    step = make_dmd_train_step(pm, state, compute_dtype=torch.bfloat16 if bf16 else None)
    before = {k: v.clone() for k, v in pm.student.state_dict().items()}
    key, noisy = jax.random.PRNGKey(71), None
    for i in range(3):
        x0, hint = _data(80 + i)
        key, sk = jax.random.split(key)
        jstate, jm_metrics = jstep(jstate, teacher, features, jnp.asarray(x0),
                                   jnp.asarray(hint), sk)
        metrics = step(to_nchw(x0), to_nchw(hint), **_dmd_draws(sk, x0.shape))
        assert set(metrics) == set(jm_metrics)
        for k, v in metrics.items():
            assert v.dim() == 0 and v.grad_fn is None
            rtol = (0.25 if k == "grad_norm" else 5e-2) if bf16 else 1e-5
            np.testing.assert_allclose(v.item(), float(jm_metrics[k]), rtol=rtol, atol=1e-7,
                                       err_msg=k)
        assert metrics["skipped"].item() == 0.0
        noisy = _noisy(state, noisy, student_sd(jstate.params))
    assert state.optimizer.count.item() == 3
    if not bf16:  # bf16: Adam turns the gradients' bf16 noise into O(lr) weight noise
        _compare(pm.student.state_dict(), student_sd(jstate.params), before, noisy, False)
    assert all(p.grad is None for p in pm.teacher.parameters())
    assert all(p.grad is None for p in pm.feature_extractor.parameters())


def test_dmd_nan_guard_matches_jax():
    """A batch with a non-finite loss: the JAX step's masked state stays as it
    was, and so does the port's, bit for bit (parameters, moments, count);
    both report skipped 1 and grad_norm 0.  The next good step matches."""
    jm, (student, teacher, features), pm, state = _dmd_pair(90)
    _, tx, jstep = _jax_dmd(False)
    jstate = jax_train_state(student, tx)
    step = make_dmd_train_step(pm, state)
    key = jax.random.PRNGKey(91)
    x0, hint = _data(92)
    key, sk = jax.random.split(key)
    jstate, _ = jstep(jstate, teacher, features, jnp.asarray(x0), jnp.asarray(hint), sk)
    step(to_nchw(x0), to_nchw(hint), **_dmd_draws(sk, x0.shape))
    _noisy(state, None, student_sd(jstate.params))

    bad = x0.copy()
    bad[1, 3, 4, 0] = np.nan
    key, sk = jax.random.split(key)
    jbefore = jax.tree.map(np.array, jstate)
    params_before = {k: p.detach().clone() for k, p in state.params.items()}
    opt_before = copy.deepcopy(state.optimizer.state_dict())
    jstate, jmet = jstep(jstate, teacher, features, jnp.asarray(bad), jnp.asarray(hint), sk)
    met = step(to_nchw(bad), to_nchw(hint), **_dmd_draws(sk, x0.shape))
    for a, b in zip(jax.tree.leaves(jbefore), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert float(jmet["skipped"]) == met["skipped"].item() == 1.0
    assert float(jmet["grad_norm"]) == met["grad_norm"].item() == 0.0
    assert not np.isfinite(float(jmet["total_loss"])) and not torch.isfinite(met["total_loss"])
    for k, p in state.params.items():
        assert torch.equal(p.detach(), params_before[k]), k
    opt_after = state.optimizer.state_dict()
    for k in ("exp_avg", "exp_avg_sq", "count"):
        assert torch.equal(opt_after[k], opt_before[k]), k

    x0, hint = _data(93)
    key, sk = jax.random.split(key)
    jstate, jmet = jstep(jstate, teacher, features, jnp.asarray(x0), jnp.asarray(hint), sk)
    met = step(to_nchw(x0), to_nchw(hint), **_dmd_draws(sk, x0.shape))
    np.testing.assert_allclose(met["total_loss"].item(), float(jmet["total_loss"]), rtol=1e-5)
    assert state.optimizer.count.item() == 2


# ---------------------------------------------------------------------------
# the DMD optimizer, state dicts, resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip", [True, False], ids=["clip-active", "clip-inactive"])
def test_clipped_adamw_matches_optax(clip):
    rng = np.random.default_rng(100)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 2, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    scale = 3.0 if clip else 0.01
    grads = [{k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    norms = [np.sqrt(sum((g ** 2).sum() for g in gs.values())) for gs in grads]
    assert all(n > 1.0 for n in norms) if clip else all(n < 1.0 for n in norms)
    decay_steps = 4  # the last update's learning rate is 0: min(k, N) clamps
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(optax.cosine_decay_schedule(LR, decay_steps), weight_decay=1e-6))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = ClippedAdamW(list(tp.values()), LR, decay_steps)
    for gs, n in zip(grads, norms):
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in gs.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(gs[k])
        g_norm = opt.step()
        np.testing.assert_allclose(g_norm.item(), n, rtol=1e-6)
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-9, err_msg=k)
    adam = opt_state[1][0]
    assert opt.count.item() == int(adam.count) == 5
    mu = np.concatenate([np.asarray(adam.mu[k]).ravel() for k in tp])
    np.testing.assert_allclose(opt.exp_avg.numpy(), mu, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(opt.learning_rate(torch.tensor(4)).item(), 0.0, atol=1e-12)
    np.testing.assert_allclose(opt.learning_rate(torch.tensor(1)).item(),
                               float(optax.cosine_decay_schedule(LR, decay_steps)(1)), rtol=1e-6)


def test_clipped_adamw_rejects_an_empty_schedule():
    with pytest.raises(ValueError, match="decay_steps"):
        ClippedAdamW([torch.nn.Parameter(torch.zeros(2))], LR, 0)


@pytest.mark.parametrize("kind", ["consistency", "dmd"])
def test_student_state_dict_equals_export_distilled_student(kind):
    jm = (JaxConsistencyDistilled(1, MNIST_CONFIG, use_ddpm_teacher=False).student
          if kind == "consistency" else JaxDMD(1, MNIST_CONFIG).student)
    p = random_params(jm, 110)
    ref = export_distilled_student(np_tree(p), jm)
    got = jax_params.student_state_dict_from_jax(np_tree(p))
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    port = ConsistencyControlNet(1, MNIST_CONFIG) if kind == "consistency" else \
        DistributionMatchingControlNet(1, MNIST_CONFIG)
    port.load_state_dict(got, strict=True)
    assert "t_proj.1.weight" in got and "hint_block.6.weight" in got


@pytest.mark.parametrize("kind", ["dmd", "adam"])
def test_train_state_resumes_exactly(tmp_path, kind):
    """Two updates, a save, a load into a fresh state, and one more update on
    each: bit-identical parameters and optimizer state."""
    rng = np.random.default_rng(120)
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in (("w", (5, 4)), ("b", (4,)))}
    grads = [{k: (2.0 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in init.items()} for _ in range(3)]

    def fresh():
        params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
        return (create_dmd_train_state(params, LR, 10) if kind == "dmd"
                else create_train_state(params, LR))

    def update(state, gs):
        for k, p in state.params.items():
            p.grad = torch.from_numpy(gs[k])
        state.optimizer.step()
        state.step += 1

    a = fresh()
    for gs in grads[:2]:
        update(a, gs)
    torch.save(a.state_dict(), tmp_path / "state.pt")
    b = fresh()
    b.load_state_dict(torch.load(tmp_path / "state.pt", weights_only=True))
    assert b.step == 2
    update(a, grads[2])
    update(b, grads[2])
    for k in init:
        assert torch.equal(a.params[k].detach(), b.params[k].detach()), k
    if kind == "dmd":
        for k in ("exp_avg", "exp_avg_sq", "count"):
            assert torch.equal(getattr(a.optimizer, k), getattr(b.optimizer, k)), k


STEP_CALLS = {"ddpm_distillation": (42, 16), "consistency_only": (32, 16), "manual": (42, 16),
              "dmd": (42, 16)}


@pytest.mark.parametrize("kind", list(STEP_CALLS))
def test_full_width_distillation_step_attention_calls(monkeypatch, kind):
    """The attention mix of one distillation step at full MNIST width: the
    student's 16 layers forward and backward, plus the forward-only 26 of
    the ControlNet teacher or 16 of the EMA target (``consistency_only``).
    chip_smoke.py holds kernels a and b's launch counters to the same
    numbers."""
    from controlnet_tpu_torch.ops import cuda_attention

    calls = {"fwd": 0, "bwd": 0}
    orig_fwd = cuda_attention.fused_attention_t
    orig_bwd = cuda_attention.fused_attention_t_bwd_plain

    def spy_fwd(qt, kt, vt):
        calls["fwd"] += 1
        return orig_fwd(qt, kt, vt)

    def spy_bwd(qt, kt, vt, dout):
        calls["bwd"] += 1
        return orig_bwd(qt, kt, vt, dout)

    monkeypatch.setattr(cuda_attention, "fused_attention_t", spy_fwd)
    monkeypatch.setattr(cuda_attention, "fused_attention_t_bwd_plain", spy_bwd)
    torch.manual_seed(0)
    x0 = torch.rand(1, 1, 28, 28) * 2 - 1
    hint = (torch.rand(1, 3, 28, 28) < 0.2).float()
    g = torch.Generator().manual_seed(0)
    if kind == "dmd":
        pm = DistributionMatchingDistilled(1, MNIST_CONFIG, device="cpu")
        state = create_dmd_train_state(dict(pm.student.named_parameters()), LR, 10)
        metrics = make_dmd_train_step(pm, state)(x0, hint, g)
    else:
        pm = ConsistencyDistilled(1, MNIST_CONFIG, use_ddpm_teacher=kind != "consistency_only",
                                  device="cpu")
        state = create_train_state(dict(pm.student.named_parameters()), LR)
        metrics = make_consistency_train_step(pm, state, kind)(x0, hint, g)
    assert all(torch.isfinite(v) for v in metrics.values())
    assert (calls["fwd"], calls["bwd"]) == STEP_CALLS[kind]
