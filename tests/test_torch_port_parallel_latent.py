"""The data-parallel paths of the port's four latent tools, its latent
sampler's ``mesh=`` and the serve tool's replicas.

* ``make_ldm_sampler(mesh=)`` at two gloo ranks (``_torch_port_parallel_rank.py``)
  against the JAX package's ``make_ldm_sampler(mesh=)`` on 2 virtual devices,
  x_T and the noise injected from the JAX key discipline: 2e-4;
* train_vae, train_ldm_vae, sample_ldm_vae and sample_ldm_controlnet through
  their ``main`` under ``torchrun --standalone --nproc_per_node 2 ... --device
  cpu`` against the same driver in one process, on the tiny CelebA-HQ config
  of test_torch_port_latent_tools.py: checkpoints and logs from rank 0 only,
  weights above the noise floor within 1e-2 lr, samples within 2e-4 (the
  tolerances of test_torch_port_parallel.py);
* two CPU replicas of the serve tool's model answer a bucket as one replica
  does, and split a bucket by the JAX server's rule.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import yaml

from _torch_port_util import Z, np_tree, random_params, to_nhwc
from conftest import TINY_MODEL_CONFIG as CFG
from conftest import TINY_VAE_CONFIG as VCFG
from controlnet_tpu.models.unet import UNet as JaxUNet
from controlnet_tpu.models.vae import VAE as JaxVAE
from controlnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from controlnet_tpu.parallel.mesh import replicate as jax_replicate
from controlnet_tpu.sample.ddpm import make_ldm_sampler as jax_ldm_sampler
from controlnet_tpu.schedules.linear import make_linear_schedule as jax_schedule
from controlnet_tpu_torch.io import jax_params
from controlnet_tpu_torch.models.controlnet import ControlNet
from controlnet_tpu_torch.models.unet import UNet
from controlnet_tpu_torch.models.vae import VAE
from controlnet_tpu_torch.tools import serve
from test_torch_port_latent_tools import CONFIG as LATENT_CONFIG
from test_torch_port_parallel import _sampler_noise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_SCRIPT = os.path.join(REPO, "tests", "_torch_port_parallel_rank.py")
WORLD = 2
SAMPLE_T = 10
SAMPLE_ATOL = 2e-4


def _env():
    return {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}


# ---------------------------------------------------------------------------
# make_ldm_sampler(mesh=) against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ldm_sampler(tmp_path_factory):
    """JAX's latent samplers (ancestral, DPM 3 steps) on the 2-device mesh,
    then the port's at two ranks on the same weights and draws."""
    mesh = jax_make_mesh(jax.devices()[:WORLD])
    cfg = dict(CFG, im_channels=Z, im_size=4)
    ju, jv = JaxUNet(Z, cfg), JaxVAE(3, VCFG)
    pu, pv = random_params(ju, 31), random_params(jv, 32)
    shape = (4, 4, 4, Z)
    sched = jax_schedule(SAMPLE_T, 1e-4, 0.02)
    eps, dec = (lambda p, x, t: ju(p, x, t)), (lambda p, z: jv.decode(p, z))
    key = jax.random.PRNGKey(33)
    pu_r, pv_r = jax_replicate(pu, mesh), jax_replicate(pv, mesh)
    ref = {"ancestral": jax_ldm_sampler(eps, dec, sched, shape, record_every=5, mesh=mesh)(
               pu_r, pv_r, key),
           "dpm": jax_ldm_sampler(eps, dec, sched, shape, mesh=mesh, ddim_steps=3,
                                  solver="dpm")(pu_r, pv_r, key)}
    x_start, step_noise = _sampler_noise(key, shape, SAMPLE_T)
    case = {"cfg": cfg, "vae_cfg": VCFG, "T": SAMPLE_T, "shape": (4, Z, 4, 4), "dpm_steps": 3,
            "unet": jax_params.unet_state_dict_from_jax(np_tree(pu)),
            "vae": jax_params.vae_state_dict_from_jax(np_tree(pv)),
            "x_start": x_start, "step_noise": step_noise}
    workdir = str(tmp_path_factory.mktemp("ldm_sampler"))
    torch.save({"ldm_sampler": case}, os.path.join(workdir, "cases.pt"))
    procs = [subprocess.Popen([sys.executable, RANK_SCRIPT, workdir, str(r), str(WORLD)],
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    outs = [torch.load(os.path.join(workdir, f"out{r}.pt"), weights_only=False)
            for r in range(WORLD)]
    return SimpleNamespace(ref=ref, outs=outs)


@pytest.mark.parametrize("kind", ["ancestral", "dpm"])
def test_ldm_sampler_mesh_matches_jax(ldm_sampler, kind):
    """Decoded images and the latent trajectory of the global batch, on
    every rank, against JAX's mesh sampler: 2e-4."""
    ref_images, ref_traj = ldm_sampler.ref[kind]
    assert [o["jax_imported"] for o in ldm_sampler.outs] == [False] * WORLD
    for o in ldm_sampler.outs:
        images, traj = o["ldm_sampler"][kind]
        assert images.shape == (4, 3, 8, 8)
        np.testing.assert_allclose(to_nhwc(images), np.asarray(ref_images), atol=SAMPLE_ATOL)
        assert traj.shape[0] == ref_traj.shape[0]
        for k in range(traj.shape[0]):
            np.testing.assert_allclose(to_nhwc(traj[k]), np.asarray(ref_traj[k]),
                                       atol=SAMPLE_ATOL)


# ---------------------------------------------------------------------------
# the four tools under torchrun
# ---------------------------------------------------------------------------

DRIVER = """
import os, sys
import torch

from controlnet_tpu_torch.tools import (sample_ldm_controlnet, sample_ldm_vae, train_ldm_vae,
                                        train_vae)
from controlnet_tpu_torch.train.state import TrainState

cfg, root, out, num_samples = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4]
noisy = {}
apply = TrainState.apply_gradients


def recording(self, *extra):  # the noise-floor weights of each update
    for k, p in self.params.items():
        low = p.grad.abs() < 1e-6
        noisy[k] = low if k not in noisy else noisy[k] | low
    return apply(self, *extra)


TrainState.apply_gradients = recording
dev = ["--device", "cpu"]
train_vae.main(["--config", cfg, "--images", f"{root}/images.npy", *dev])
train_ldm_vae.main(["--config", cfg, "--images", f"{root}/images.npy", "--vae_ckpt",
                    f"{root}/vae.pth", *dev])
fixed = ["--vae_ckpt", f"{root}/vae.pth", "--num_samples", num_samples, "--sampler", "dpm",
         "--sampler_steps", "3", "--save_every", "3", *dev]
samples = {"ldm": sample_ldm_vae.main(["--config", cfg, "--ckpt", f"{root}/ldm.pth", *fixed]),
           "controlnet": sample_ldm_controlnet.main([
               "--config", cfg, "--ckpt", f"{root}/cn.pth", "--hints", f"{root}/hints.npy",
               *fixed])}
if int(os.environ.get("RANK", "0")) == 0:
    torch.save({"noisy": noisy, "samples": samples}, out)
"""


def _write_config(root, task) -> str:
    cfg = {k: dict(v) for k, v in LATENT_CONFIG.items()}
    cfg["train_params"].update(task_name=str(root / task))
    path = root / f"{task}.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


@pytest.fixture(scope="module")
def tools(tmp_path_factory):
    """The driver once in one process (4 samples) and once under torchrun at
    two ranks (3 samples, padded to 4)."""
    root = tmp_path_factory.mktemp("latent_tools_dp")
    rng = np.random.default_rng(40)
    images = (rng.random((12, 16, 16, 3)) * 255).astype(np.uint8)
    images[:, 4:12, 4:12] = 255
    np.save(root / "images.npy", images)
    np.save(root / "hints.npy", (rng.random((6, 32, 32, 3)) < 0.2).astype(np.float32))
    torch.manual_seed(41)
    ae, ldm = LATENT_CONFIG["autoencoder_params"], LATENT_CONFIG["ldm_params"]
    torch.save(VAE(3, ae).state_dict(), root / "vae.pth")
    torch.save(UNet(ae["z_channels"], ldm).state_dict(), root / "ldm.pth")
    cn = ControlNet(ae["z_channels"], ldm, down_sample_factor=4)
    with torch.no_grad():
        for m in cn.zero_convs():  # every branch contributes
            m.weight.normal_(0.0, 0.1)
    torch.save(cn.state_dict(), root / "cn.pth")
    driver = root / "driver.py"
    driver.write_text(DRIVER)
    runs = {}
    for task, launch, n in (("one", [sys.executable], "4"),
                            ("two", [sys.executable, "-m", "torch.distributed.run",
                                     "--standalone", "--nproc_per_node", str(WORLD)], "3")):
        os.makedirs(root / task)
        proc = subprocess.run([*launch, str(driver), _write_config(root, task), str(root),
                               str(root / f"{task}.pt"), n], cwd=str(root), env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stdout
        runs[task] = SimpleNamespace(log=proc.stdout, dir=root / task,
                                     **torch.load(root / f"{task}.pt", weights_only=False))
    return SimpleNamespace(root=root, **runs)


def _compare_weights(one: dict, two: dict, noisy: dict, lr: float) -> None:
    """The weights whose gradient stayed above the noise floor within 1e-2
    lr; the others within Adam's bound (2 lr)."""
    clean, rough = [], []
    for k, v in one.items():
        d, low = (two[k] - v).abs(), noisy[k]
        clean.append(d[~low])
        rough.append(d[low])
    clean, rough = torch.cat(clean), torch.cat(rough)
    assert clean.numel() > 0
    assert clean.max().item() < 1e-2 * lr, clean.max().item() / lr
    assert rough.numel() == 0 or rough.max().item() <= 2 * lr


def test_train_vae_under_torchrun(tools):
    """One epoch of train_vae (3 global batches of 4, 2 rows a rank; the
    discriminator's batch norms over the global batch from step 3): rank 0
    alone logs and writes; both nets' .pth weights match one process."""
    tp = LATENT_CONFIG["train_params"]
    assert tools.two.log.count("Finished epoch: 1") == 1
    one, two = {}, {}
    for name in (tp["vae_autoencoder_ckpt_name"], tp["vae_discriminator_ckpt_name"]):
        for run in (tools.one, tools.two):
            assert sorted(os.listdir(run.dir / name[:-4])) == ["1.pt"]
        one.update(torch.load(tools.one.dir / name, weights_only=True))
        two.update(torch.load(tools.two.dir / name, weights_only=True))
    _compare_weights(one, two, tools.one.noisy, tp["autoencoder_lr"])
    grids = sorted(os.listdir(tools.two.dir / "vae_autoencoder_samples"))
    assert grids == sorted(os.listdir(tools.one.dir / "vae_autoencoder_samples"))


def test_train_ldm_vae_under_torchrun(tools):
    """One epoch of train_ldm_vae encoding each rank's rows of the images
    with the VAE (its noise drawn at the global shape): the LDM's .pth
    matches one process."""
    tp = LATENT_CONFIG["train_params"]
    assert tools.two.log.count("Finished epoch:1") == 1
    one = torch.load(tools.one.dir / tp["ldm_ckpt_name"], weights_only=True)
    two = torch.load(tools.two.dir / tp["ldm_ckpt_name"], weights_only=True)
    _compare_weights(one, two, tools.one.noisy, tp["ldm_lr"])


@pytest.mark.parametrize("tool,out_dir", [("ldm", "samples"), ("controlnet", "hint_samples")])
def test_sample_tools_under_torchrun(tools, tool, out_dir):
    """sample_ldm_vae and sample_ldm_controlnet (DPM 3 steps, decode) at two
    ranks, 3 samples padded to 4, against one process on 4: 2e-4; the grids
    written once."""
    two, one = tools.two.samples[tool], tools.one.samples[tool][:3]
    assert two.shape == one.shape == (3, 16, 16, 3)
    np.testing.assert_allclose(two, one, atol=SAMPLE_ATOL)
    assert "final_decoded.png" in os.listdir(tools.two.dir / out_dir)
    assert tools.two.log.count("decoded grid to") == 2  # rank 0 alone, once a tool


# ---------------------------------------------------------------------------
# the serve tool's replicas
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serve_config(tmp_path_factory):
    from controlnet_tpu_torch.models.consistency import ConsistencyDistilled
    from controlnet_tpu_torch.tools import train_consistency_controlnet_distilled as cd_train

    task = tmp_path_factory.mktemp("serve_replicas")
    cfg = dict(CFG)
    torch.manual_seed(50)
    cn = ControlNet(1, cfg)
    with torch.no_grad():
        for m in cn.zero_convs():
            m.weight.normal_(0.0, 0.1)
    torch.save(cn.state_dict(), task / "cn.pth")
    cd = ConsistencyDistilled(1, cfg, use_ddpm_teacher=False, device="cpu")
    torch.save(cd_train.reference_checkpoint(cd, 0, cfg), task / cd_train.CKPT_NAME)
    return {"diffusion_params": {"num_timesteps": 20, "beta_start": 1e-4, "beta_end": 0.02},
            "model_params": cfg,
            "train_params": {"task_name": str(task), "controlnet_ckpt_name": "cn.pth"}}


@pytest.mark.parametrize("model,steps", [("dpm_controlnet", 3), ("consistency", 3)])
def test_two_replicas_answer_as_one(serve_config, model, steps):
    """A 16-row bucket split over two CPU replicas (8 rows each; x_T and the
    consistency student's re-injected noise drawn at the bucket's shape and
    sliced) equals one replica's answer; a 3-row bucket stays on the first
    replica and equals it too."""
    args = SimpleNamespace(model=model, device="cpu", seed=0)
    cpu = torch.device("cpu")
    one, *_ = serve.build_generator(args, serve_config, [cpu])
    two, *_ = serve.build_generator(args, serve_config, [cpu, cpu])
    rng = np.random.default_rng(51)
    for rows in (16, 3):
        hints = rng.uniform(size=(rows, 8, 8, 3)).astype(np.float32)
        a = one(hints, torch.Generator().manual_seed(5), steps)
        b = two(hints, torch.Generator().manual_seed(5), steps)
        assert a.shape == b.shape == (rows, 1, 8, 8)
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5)


def test_replicas_split_by_the_jax_rule():
    """``splits_over_replicas`` is the JAX server's ``rows % n_data == 0``
    under a mesh (none with one device); a split bucket gives replica i its
    i-th block of rows, another goes whole to the first replica."""
    for n in (1, 2, 4):
        for rows in range(1, 33):
            assert serve.splits_over_replicas(rows, n) == (n > 1 and rows % n == 0)
    calls = []

    def fake(i):
        def gen(hints, generator, steps=1, x_start=None, noise=None):
            calls.append((i, hints.shape[0]))
            return torch.zeros((hints.shape[0], 1, 2, 2))
        return gen

    def draw(generator, rows, steps, x_start):
        return torch.zeros((rows, 1, 2, 2)), None

    cpu = torch.device("cpu")
    gen = serve._replicated([fake(0), fake(1)], [cpu, cpu], draw)
    gen(np.zeros((8, 2, 2, 3), np.float32), None)
    gen(np.zeros((5, 2, 2, 3), np.float32), None)
    assert calls == [(0, 4), (1, 4), (0, 5)]
