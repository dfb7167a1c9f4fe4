"""The port's data parallelism (controlnet_tpu_torch.parallel, the cli's mesh
helpers, the samplers' ``mesh=``, the trainer tool under torchrun) against
the JAX package's mesh.

Two ranks run as processes of their own (``_torch_port_parallel_rank.py``,
torch only) in a gloo group on the CPU, each holding 1/2 of the rows of every
global batch; the JAX side runs the same global batches sharded over 2 of
conftest's 8 virtual CPU devices (``parallel.mesh.make_mesh``).  The draws
are the JAX steps' (train/loops.py key discipline), injected into the port
as global tensors.  Tolerances are those of test_torch_port_train.py and
test_torch_port_distill.py: float32 losses rtol 1e-5; weights whose gradient
stayed above the noise floor within 1e-2 of the learning rate; samples
2e-4.  The two ranks' weights after the steps are bit-equal (the ranks stay
in step).
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from _torch_port_util import np_tree, random_params, to_nchw, to_nhwc
from conftest import TINY_MODEL_CONFIG as CFG
from controlnet_tpu import cli as jax_cli
from controlnet_tpu.models.controlnet import ControlNet as JaxControlNet
from controlnet_tpu.models.unet import UNet as JaxUNet
from controlnet_tpu.nn.layers import BatchNorm as JaxBatchNorm
from controlnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from controlnet_tpu.parallel.mesh import replicate as jax_replicate
from controlnet_tpu.parallel.mesh import shard_batch as jax_shard_batch
from controlnet_tpu.sample import make_few_step_sampler as jax_few_step_sampler
from controlnet_tpu.sample.ddpm import make_ddpm_sampler as jax_ddpm_sampler
from controlnet_tpu.schedules.linear import make_linear_schedule as jax_schedule
from controlnet_tpu.train.loops import make_controlnet_train_step as jax_cn_step
from controlnet_tpu.train.loops import make_ddpm_train_step as jax_ddpm_step
from controlnet_tpu.train.state import create_train_state as jax_train_state
from controlnet_tpu_torch import cli
from controlnet_tpu_torch.io import jax_params
from controlnet_tpu_torch.models.unet import UNet
from controlnet_tpu_torch.parallel.mesh import Mesh
from controlnet_tpu_torch.train.state import TrainState
from test_torch_port_distill import DMD_DECAY_STEPS, _compare, _dmd_draws, _dmd_pair, _jax_dmd
from test_torch_port_distill import student_sd
from test_torch_port_train import LR, NOISE_FLOOR, T, _compare_params, _data, _jax_draws
from test_torch_port_train import _digit_images, _tool_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_SCRIPT = os.path.join(REPO, "tests", "_torch_port_parallel_rank.py")
WORLD = 2
B = 4  # the global batch: 2 rows a rank
STEPS = 2
SAMPLE_T = 10
SAMPLE_ATOL = 2e-4


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    return env


def _run_ranks(workdir: str) -> list:
    procs = [subprocess.Popen([sys.executable, RANK_SCRIPT, workdir, str(r), str(WORLD)],
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(WORLD)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [torch.load(os.path.join(workdir, f"out{r}.pt"), weights_only=False)
            for r in range(WORLD)]


def _jax_mesh():
    return jax_make_mesh(jax.devices()[:WORLD])


# ---------------------------------------------------------------------------
# (a) put_batch and sampler_mesh against the JAX tools' rules
# ---------------------------------------------------------------------------

def _fake_mesh(rank=0):
    return Mesh(rank=rank, world_size=WORLD, device=torch.device("cpu"), backend="gloo")


@pytest.mark.parametrize("b", [7, 8])
def test_put_batch_trims_as_jax(b, capsys):
    """A batch of 7 is trimmed to 6 with a warning shown once, 8 passes, as
    the JAX tool does on a 2-device mesh; rank r keeps rows [r*k, (r+1)*k)."""
    jax_cli._put_batch_warned.clear()
    cli._put_batch_warned.clear()
    x = np.arange(b * 3, dtype=np.float32).reshape(b, 3)
    mesh = _jax_mesh()
    ref = [np.asarray(jax_cli.put_batch(x, mesh)) for _ in range(2)]
    jax_out = capsys.readouterr().out
    got = [[cli.put_batch(x, _fake_mesh(r)) for r in range(WORLD)] for _ in range(2)]
    port_out = capsys.readouterr().out
    keep = (b // WORLD) * WORLD
    np.testing.assert_array_equal(ref[0], x[:keep])
    for per_rank in got:
        np.testing.assert_array_equal(np.concatenate(per_rank), ref[0])
    assert jax_out.count("trimming") == port_out.count("trimming") == (b % WORLD)
    if b % WORLD:
        assert f"{b} -> {keep}" in jax_out and f"{b} -> {keep}" in port_out


def test_put_batch_refuses_a_batch_smaller_than_the_world(monkeypatch):
    """Every port rank is a process of its own: a batch of 1 over 2 ranks
    raises, as the JAX tool's multi-process branch does for a host batch
    smaller than its per-process shard (2 processes over 4 devices: 2 a
    process)."""
    x = np.zeros((1, 3), np.float32)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="smaller than the per-process"):
        jax_cli.put_batch(x, jax_make_mesh(jax.devices()[:4]))
    with pytest.raises(ValueError, match="smaller than the world size"):
        cli.put_batch(x, _fake_mesh())
    assert cli.put_batch(x, None) is x


@pytest.mark.parametrize("n", [7, 8, 1])
def test_sampler_mesh_pads_as_jax(n, monkeypatch, capsys):
    jax_cli._put_batch_warned.clear()
    cli._put_batch_warned.clear()
    monkeypatch.setattr(jax_cli, "mesh_or_none", _jax_mesh)
    monkeypatch.setattr(cli, "mesh_or_none", lambda device=None: _fake_mesh())
    _, ref = jax_cli.sampler_mesh(n)
    jax_out = capsys.readouterr().out
    mesh, got = cli.sampler_mesh(n)
    port_out = capsys.readouterr().out
    assert got == ref == -(-n // WORLD) * WORLD and mesh.world_size == WORLD
    assert ("padding" in jax_out) == ("padding" in port_out) == (n % WORLD != 0)


def test_mesh_or_none_without_a_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert cli.mesh_or_none("cpu") is None
    assert cli.sampler_mesh(5, "cpu") == (None, 5)


# ---------------------------------------------------------------------------
# (b)-(d): one two-rank run of every case against the JAX mesh
# ---------------------------------------------------------------------------

def _ddpm_case(mesh):
    ju = JaxUNet(1, CFG)
    p = random_params(ju, 11)
    tx = optax.adam(LR)
    jstate = jax_replicate(jax_train_state(p, tx), mesh)
    jstep = jax_ddpm_step(lambda pp, x, t: ju(pp, x, t), jax_schedule(T, 1e-4, 0.02), tx)
    key, steps, losses = jax.random.PRNGKey(22), [], []
    for i in range(STEPS):
        images, _ = _data(40 + i, B, CFG["im_size"])
        key, sk = jax.random.split(key)
        jstate, jloss = jstep(jstate, jax_shard_batch(jnp.asarray(images), mesh), sk)
        t, noise, _ = _jax_draws(sk, images.shape, 0.0)
        steps.append((to_nchw(images), torch.from_numpy(t), to_nchw(noise)))
        losses.append(float(jloss))
    case = {"cfg": CFG, "lr": LR, "T": T, "sd": jax_params.unet_state_dict_from_jax(p),
            "steps": steps}
    ref = {"losses": losses,
           "sd": jax_params.unet_state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))}
    return case, ref


def _controlnet_case(mesh, drop=0.5):
    jcn = JaxControlNet(1, CFG)
    p = random_params(jcn, 10)
    trainable, frozen = jcn.split_params(p)
    tx = optax.adam(LR)
    jstate = jax_replicate(jax_train_state(trainable, tx), mesh)
    frozen = jax_replicate(frozen, mesh)
    jstep = jax_cn_step(jcn, jax_schedule(T, 1e-4, 0.02), tx, cfg_drop_prob=drop)
    key, steps, losses = jax.random.PRNGKey(21), [], []
    for i in range(STEPS):
        images, hints = _data(30 + i, B, CFG["im_size"])
        key, sk = jax.random.split(key)
        jstate, jloss = jstep(jstate, frozen, jax_shard_batch(jnp.asarray(images), mesh),
                              jax_shard_batch(jnp.asarray(hints), mesh), sk)
        t, noise, keep = _jax_draws(sk, images.shape, drop)
        steps.append((to_nchw(images), to_nchw(hints), torch.from_numpy(t), to_nchw(noise),
                      torch.from_numpy(keep)))
        losses.append(float(jloss))
    case = {"cfg": CFG, "lr": LR, "T": T, "drop": drop, "steps": steps,
            "sd": jax_params.controlnet_state_dict_from_jax(np_tree(p))}
    merged = jcn.merge_params(jax.tree.map(np.asarray, jstate.params),
                              jax.tree.map(np.asarray, frozen))
    return case, {"losses": losses, "sd": jax_params.controlnet_state_dict_from_jax(merged)}


def _dmd_case(mesh):
    jm, (student, teacher, features), pm, _ = _dmd_pair(70)
    _, tx, jstep = _jax_dmd(False)
    jstate = jax_replicate(jax_train_state(student, tx), mesh)
    x0, hint = _data(80, B, CFG["im_size"])
    sk = jax.random.split(jax.random.PRNGKey(71))[1]
    jstate, jmetrics = jstep(jstate, jax_replicate(teacher, mesh), jax_replicate(features, mesh),
                             jax_shard_batch(jnp.asarray(x0), mesh),
                             jax_shard_batch(jnp.asarray(hint), mesh), sk)
    feature_x = np.random.default_rng(7).uniform(-1, 1, (B, 8, 8, 1)).astype(np.float32)
    ref_feats = jax.jit(jm.feature_extractor.__call__)(
        jax_replicate(features, mesh), jax_shard_batch(jnp.asarray(feature_x), mesh))
    case = {"cfg": CFG, "T": T, "lr": LR, "decay_steps": DMD_DECAY_STEPS,
            "student": student_sd(student),
            "teacher": jax_params.controlnet_state_dict_from_jax(np_tree(teacher)),
            "features": jax_params.features_state_dict_from_jax(np_tree(features)),
            "x0": to_nchw(x0), "hint": to_nchw(hint), "feature_x": to_nchw(feature_x),
            **_dmd_draws(sk, x0.shape)}
    ref = {"metrics": {k: float(v) for k, v in jmetrics.items()},
           "sd": student_sd(jstate.params), "before": pm.student.state_dict(),
           "features": [np.asarray(f) for f in ref_feats]}
    return case, ref


def _batchnorm_case(mesh):
    rng = np.random.default_rng(6)
    # a large mean: the two-pass variance keeps its precision where E[x^2] - E[x]^2 would not
    x = (3.0 * rng.standard_normal((B, 6, 6, 7)) + 40.0).astype(np.float32)
    w = rng.standard_normal((B, 6, 6, 7)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(7)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(7)).astype(np.float32)
    bn = JaxBatchNorm(7)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}

    def loss(pp, xx):
        return jnp.sum(bn(pp, xx) * jnp.asarray(w))

    xs = jax_shard_batch(jnp.asarray(x), mesh)
    out = jax.jit(bn.__call__)(params, xs)
    dparams, dx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, xs)
    case = {"x": to_nchw(x), "w": to_nchw(w),
            "params": {"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}}
    ref = {"out": np.asarray(out), "dx": np.asarray(dx),
           "dweight": np.asarray(dparams["scale"]), "dbias": np.asarray(dparams["bias"])}
    return case, ref


def _sampler_noise(key, shape, steps):
    """x_T and the per-step noise as the JAX samplers draw them."""
    k0, key = jax.random.split(key)
    x_start = np.asarray(jax.random.normal(k0, shape, jnp.float32))
    zs = []
    for _ in range(steps):
        key, kstep = jax.random.split(key)
        zs.append(np.asarray(jax.random.normal(kstep, shape, jnp.float32)))
    return to_nchw(x_start), torch.from_numpy(np.stack(zs).transpose(0, 1, 4, 2, 3).copy())


def _samplers_case(mesh, ddim_steps=5, eta=0.7):
    jcn = JaxControlNet(1, CFG)
    p = random_params(jcn, 7)
    size = CFG["im_size"]
    shape = (B, size, size, 1)
    hint = np.random.default_rng(7).uniform(size=(B, size, size, 3)).astype(np.float32)
    jsched = jax_schedule(SAMPLE_T, 1e-4, 0.02)
    jeps = lambda pp, x, t, f: jcn(pp, x, t, hint_features=f)  # noqa: E731
    pr = jax_replicate(p, mesh)
    feats = jcn.hint_features(pr, jax_shard_batch(jnp.asarray(hint), mesh))
    key = jax.random.PRNGKey(11)
    ref = {"ancestral": jax_ddpm_sampler(jeps, jsched, shape, record_every=5, mesh=mesh)(
               pr, key, feats),
           "ddim": jax_few_step_sampler("ddim", jeps, jsched, shape, ddim_steps, eta=eta,
                                        mesh=mesh)(pr, key, feats)}
    x_start, step_noise = _sampler_noise(key, shape, SAMPLE_T)
    _, ddim_noise = _sampler_noise(key, shape, ddim_steps)
    case = {"cfg": CFG, "T": SAMPLE_T, "sd": jax_params.controlnet_state_dict_from_jax(np_tree(p)),
            "hint": to_nchw(hint), "shape": (B, 1, size, size), "x_start": x_start,
            "step_noise": step_noise, "ddim_noise": ddim_noise, "ddim_steps": ddim_steps,
            "eta": eta}
    return case, ref


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every case's JAX reference on the 2-device mesh, then one run of the
    two rank processes over all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mesh = _jax_mesh()
        built = {name: fn(mesh) for name, fn in (
            ("ddpm", _ddpm_case), ("controlnet", _controlnet_case), ("dmd", _dmd_case),
            ("batchnorm", _batchnorm_case), ("samplers", _samplers_case))}
    finally:
        torch.set_num_threads(n)
    workdir = str(tmp_path_factory.mktemp("two_ranks"))
    torch.save({k: v[0] for k, v in built.items()}, os.path.join(workdir, "cases.pt"))
    outs = _run_ranks(workdir)
    return SimpleNamespace(ref={k: v[1] for k, v in built.items()},
                           case={k: v[0] for k, v in built.items()}, outs=outs)


def test_rank_processes_import_no_jax(two_ranks):
    assert [o["jax_imported"] for o in two_ranks.outs] == [False] * WORLD


def _ranks_in_step(outs, name):
    for k, v in outs[0][name]["sd"].items():
        assert torch.equal(v, outs[1][name]["sd"][k]), k


@pytest.mark.parametrize("name", ["ddpm", "controlnet"])
def test_two_rank_train_steps_match_jax_mesh(two_ranks, name):
    """(b) Two steps of the DDPM step and of the ControlNet step (with the
    condition-drop mask) at 2 ranks, 2 rows each, against the JAX step on the
    2-device mesh: losses rtol 1e-5, weights above the noise floor within
    1e-2 lr."""
    out, ref, case = two_ranks.outs[0][name], two_ranks.ref[name], two_ranks.case[name]
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-5)
    assert out["losses"] == two_ranks.outs[1][name]["losses"]
    _ranks_in_step(two_ranks.outs, name)
    _compare_params(out["sd"], ref["sd"], case["sd"], out["noisy"], bf16=False)
    if name == "controlnet":
        assert any((s[4] == 0).any() for s in case["steps"])  # the mask dropped hints


def test_two_rank_dmd_step_matches_jax_mesh(two_ranks):
    """(c) One DMD step at 2 ranks against the JAX DMD step on the mesh: every
    loss term (the feature moments and the extractor's BatchNorm over the
    global batch), the gradient norm before the clip, the weights; and the
    extractor's features of a global batch gathered from the ranks."""
    out, ref = two_ranks.outs[0]["dmd"], two_ranks.ref["dmd"]
    assert set(out["metrics"]) == set(ref["metrics"])
    for k, v in out["metrics"].items():
        np.testing.assert_allclose(v, ref["metrics"][k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert out["metrics"] == two_ranks.outs[1]["dmd"]["metrics"]
    assert out["metrics"]["skipped"] == 0.0
    _ranks_in_step(two_ranks.outs, "dmd")
    _compare(out["sd"], ref["sd"], ref["before"], out["noisy"], False)
    for g, r in zip(out["features"], ref["features"]):
        assert np.abs(to_nhwc(g) - r).max() <= 1e-5 * np.abs(r).max()


def test_two_rank_batchnorm_matches_jax_mesh(two_ranks):
    """BatchNorm over the global batch at a large mean (two passes), forward
    and backward through the all-reduces, against the JAX BatchNorm and its
    gradient on the sharded batch."""
    out, ref = two_ranks.outs[0]["batchnorm"], two_ranks.ref["batchnorm"]
    assert np.abs(to_nhwc(out["out"]) - ref["out"]).max() <= 1e-5 * np.abs(ref["out"]).max()
    assert np.abs(to_nhwc(out["dx"]) - ref["dx"]).max() <= 1e-4 * np.abs(ref["dx"]).max()
    # each rank's parameter gradient is its rows' share: the sum is the global one
    for k in ("dweight", "dbias"):
        total = sum(o["batchnorm"][k] for o in two_ranks.outs).numpy()
        np.testing.assert_allclose(total, ref[k], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["ancestral", "ddim"])
def test_two_rank_samplers_match_jax_mesh(two_ranks, kind):
    """(d) The ancestral loop and DDIM (eta 0.7) at 2 ranks on injected
    global x_T and noise against the JAX mesh samplers: 2e-4, and every rank
    holds the whole gathered batch."""
    x0, traj = two_ranks.outs[0]["samplers"][kind]
    ref_x0, ref_traj = two_ranks.ref["samplers"][kind]
    assert x0.shape == (B, 1, CFG["im_size"], CFG["im_size"])
    np.testing.assert_allclose(to_nhwc(x0), np.asarray(ref_x0), atol=SAMPLE_ATOL)
    assert traj.shape[0] == ref_traj.shape[0]
    for k in range(traj.shape[0]):
        np.testing.assert_allclose(to_nhwc(traj[k]), np.asarray(ref_traj[k]), atol=SAMPLE_ATOL)
    x0_1, traj_1 = two_ranks.outs[1]["samplers"][kind]
    assert torch.equal(x0, x0_1) and torch.equal(traj, traj_1)


# ---------------------------------------------------------------------------
# (e) the trainer tool under torchrun
# ---------------------------------------------------------------------------

def test_train_ddpm_controlnet_under_torchrun(tmp_path, monkeypatch):
    """One epoch of the ControlNet trainer tool through ``torchrun
    --standalone --nproc_per_node 2 ... --device cpu`` against the same run in
    one process: one checkpoint and one .pth written (by rank 0), and the
    same weights above the noise floor within 1e-2 lr."""
    from controlnet_tpu_torch.tools import train_ddpm_controlnet

    np.save(tmp_path / "im.npy", _digit_images(0, 8, CFG["im_size"]))
    torch.manual_seed(5)
    base = {k: v.clone() for k, v in UNet(1, CFG).state_dict().items()}
    for task in ("one", "two"):
        os.makedirs(tmp_path / task)
        torch.save(base, tmp_path / task / "ddpm_ckpt.pth")
    noisy: dict = {}
    apply = TrainState.apply_gradients

    def recording(self, *extra):
        for k, p in self.params.items():
            low = p.grad.abs() < NOISE_FLOOR
            noisy[k] = low if k not in noisy else noisy[k] | low
        return apply(self, *extra)

    monkeypatch.setattr(TrainState, "apply_gradients", recording)
    train_ddpm_controlnet.train(_tool_config(tmp_path, CFG, "one", 1), str(tmp_path / "im.npy"),
                                device="cpu")
    monkeypatch.undo()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(WORLD), "-m", "controlnet_tpu_torch.tools.train_ddpm_controlnet",
         "--config", _tool_config(tmp_path, CFG, "two", 1), "--images",
         str(tmp_path / "im.npy"), "--device", "cpu"],
        cwd=str(tmp_path), env={**_env(), "OMP_NUM_THREADS": "1"}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout
    assert proc.stdout.count("Finished epoch:1") == 1  # rank 0 alone logs
    for task in ("one", "two"):
        assert sorted(os.listdir(tmp_path / task / "cn")) == ["1.pt"]
    one = torch.load(tmp_path / "one" / "cn.pth", weights_only=True)
    two = torch.load(tmp_path / "two" / "cn.pth", weights_only=True)
    cn, state, _ = train_ddpm_controlnet.make_trainer(
        yaml.safe_load(open(_tool_config(tmp_path, CFG, "one", 1))), base, "cpu")
    trainable = state.params
    before = {k: v.detach().clone() for k, v in cn.state_dict().items()}
    # the tool's zero convs start at zero, so most of the control branch sees
    # no gradient or one at the floor in the first steps: those weights are
    # held to Adam's bound (lr a step), the others to 1e-2 lr
    clean, rough, moved = [], [], 0.0
    for k in trainable:
        d, low = (two[k] - one[k]).abs(), noisy[k]
        clean.append(d[~low])
        rough.append(d[low])
        moved = max(moved, (one[k] - before[k]).abs().max().item())
    clean, rough = torch.cat(clean), torch.cat(rough)
    assert moved > 0.5 * LR and clean.numel() > 0
    assert clean.max().item() < 1e-2 * LR, clean.max().item() / LR
    assert rough.max().item() <= 2 * LR
    for k in set(one) - set(trainable):
        assert torch.equal(one[k], two[k]), k


# ---------------------------------------------------------------------------
# the kernel build under several ranks
# ---------------------------------------------------------------------------

BUILD_RANK = """
import os, sys, time
from unittest import mock
from pathlib import Path

from controlnet_tpu_torch.ops import _build

_build.BUILD_DIR = Path(sys.argv[1])
_build.LIB_PATH = _build.BUILD_DIR / "libcontrolnet_kernels.so"


def record(verbose=False):  # the build, recorded: a second takes as long
    with open(_build.BUILD_DIR / "builds.txt", "a") as f:
        f.write(f"{os.getpid()}\\n")
    time.sleep(1.0)
    _build.LIB_PATH.write_bytes(b"built")
    return _build.LIB_PATH


_build._compile_and_link = record
_build.ctypes = mock.MagicMock()  # no library to open here
_build.load()
"""


def test_two_processes_build_the_kernels_once(tmp_path):
    """Two ranks that start together on a stale ``build/kernels/`` (a
    library older than the sources): the first takes the build lock and
    builds, the second waits on it, finds the library fresh and loads it."""
    lib = tmp_path / "libcontrolnet_kernels.so"
    lib.write_bytes(b"stale")
    os.utime(lib, (0, 0))
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_RANK, str(tmp_path)], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    assert len((tmp_path / "builds.txt").read_text().split()) == 1
    assert lib.read_bytes() == b"built"
