"""The port's tools on file trees (``--config`` alone, as the JAX tools run),
on the CPU (``device="cpu"``) at tiny configs, against the ``.npy`` route.

The trees are written by the port's ``data/synthetic.py`` (MNIST-like gray
class trees for the train and test splits) and by PIL (a flat CelebA-HQ
style directory).  An ``.npy`` of the same images in the reader's order, and
of the readers' cv2 hints, gives the same batches in the same order for a
seed, so each tree-route trainer's epoch losses equal the ``.npy`` route's
(rtol 1e-6: the same float32 operations on the same inputs).  ``infer_vae``
keys its latent shards by the images' basenames, which are the keys the JAX
``infer_vae`` writes (``dataset.images[i]`` of the JAX ``CelebDataset``).
``sample_ddpm`` is held to the JAX ancestral sampler over the same UNet
weights with x_T and the per-step noise injected, atol 2e-4 as the other
sampler tests.
"""

import os
import shutil
import types

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from _torch_port_util import random_params, to_nchw, to_nhwc
from conftest import TINY_MODEL_CONFIG
from controlnet_tpu.data import datasets as jd
from controlnet_tpu.models.unet import UNet as JaxUNet
from controlnet_tpu.sample.ddpm import make_ddpm_sampler as jax_make_ddpm_sampler
from controlnet_tpu.schedules.linear import make_linear_schedule as jax_schedule
from controlnet_tpu_torch import cli
from controlnet_tpu_torch.data import datasets as pd
from controlnet_tpu_torch.data.synthetic import make_synthetic_image_tree
from controlnet_tpu_torch.io import jax_params
from controlnet_tpu_torch.tools import (infer_vae, sample_consistency_controlnet_distilled,
                                        sample_ddpm, sample_ddpm_controlnet,
                                        sample_distribution_matching_controlnet_distilled,
                                        sample_ldm_controlnet,
                                        train_consistency_controlnet_distilled, train_ddpm,
                                        train_ddpm_controlnet,
                                        train_distribution_matching_controlnet_distilled,
                                        train_ldm_controlnet, train_ldm_vae, train_vae)
from test_torch_port_latent_tools import CONFIG as CELEB_CONFIG
from test_torch_port_sampler import _jax_noise

T = 10
SIZE = 8  # TINY_MODEL_CONFIG's im_size


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _npy_of_reader(reader, path: str, hints_path: str | None = None) -> None:
    """The reader's images as a uint8 .npy in its order (and its hints)."""
    u8 = np.stack([np.rint((reader[i][0] if isinstance(reader[i], tuple) else reader[i]) * 127.5
                           + 127.5).astype(np.uint8) for i in range(len(reader))])
    np.save(path, u8[..., 0] if u8.shape[-1] == 1 else u8)
    if hints_path is not None:
        np.save(hints_path, np.stack([reader[i][1] for i in range(len(reader))]))


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("data_tools")
    for split, seed in (("train", 0), ("test", 1)):
        make_synthetic_image_tree(str(root / split), num_classes=2, per_class=4, size=SIZE,
                                  channels=1, seed=seed)
        reader = pd.MnistDataset(split, str(root / split), return_hints=True)
        _npy_of_reader(reader, str(root / f"{split}_images.npy"),
                       str(root / f"{split}_hints.npy"))
    # a flat CelebA-HQ style directory: 12 RGB PNGs, not square
    celeb = root / "celeb"
    celeb.mkdir()
    rng = np.random.default_rng(2)
    for i in range(12):
        arr = (rng.uniform(size=(20, 18, 3)) > 0.5).astype(np.uint8) * 200
        Image.fromarray(arr).save(celeb / f"face_{i:03d}.png")
    return types.SimpleNamespace(root=root, path=lambda name: str(root / name))


def _mnist_config(ws, task: str, **train) -> str:
    task_dir = os.path.join(ws.root, task)
    os.makedirs(task_dir, exist_ok=True)
    config = {
        "dataset_params": {"task_name": "mnist", "im_path": ws.path("train"),
                           "im_test_path": ws.path("test")},
        "diffusion_params": {"num_timesteps": T, "beta_start": 1e-4, "beta_end": 0.02},
        "model_params": TINY_MODEL_CONFIG,
        "train_params": {"task_name": task_dir, "batch_size": 4, "num_epochs": 1,
                         "controlnet_epochs": 1, "consistency_epochs": 1,
                         "distribution_matching_epochs": 1, "ddpm_lr": 1e-3,
                         "controlnet_lr": 1e-3, "consistency_lr": 1e-3,
                         "distribution_matching_lr": 1e-3, "num_samples": 4,
                         "num_grid_rows": 2, "ddpm_ckpt_name": "ddpm.pth",
                         "controlnet_ckpt_name": "cn.pth", "seed": 0, **train},
    }
    path = os.path.join(ws.root, f"{task}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def _copy_into(ws, src_task: str, dst_task: str, name: str) -> None:
    dst = os.path.join(ws.root, dst_task, name)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    shutil.copy(os.path.join(ws.root, src_task, name), dst)


@pytest.fixture(scope="module")
def trained(ws):
    """train_ddpm and train_ddpm_controlnet (cv2 hints) on the tree: the
    base UNet and the ControlNet the later tools start from."""
    ddpm = train_ddpm.train(_mnist_config(ws, "base"), device="cpu")
    cn = train_ddpm_controlnet.train(_mnist_config(ws, "base"), device="cpu")
    return {"ddpm": ddpm, "cn": cn}


def test_train_ddpm_tree_equals_npy(ws, trained):
    npy = train_ddpm.train(_mnist_config(ws, "ddpm_npy"), ws.path("train_images.npy"),
                           device="cpu")
    assert trained["ddpm"]["epochs"] == [1] and np.isfinite(trained["ddpm"]["losses"]).all()
    np.testing.assert_allclose(trained["ddpm"]["losses"], npy["losses"], rtol=1e-6)
    assert os.path.exists(os.path.join(ws.root, "base", "ddpm.pth"))


@pytest.mark.parametrize("backend,npy_hints", [("cv2", True), ("tpu", False)])
def test_train_controlnet_tree_equals_npy(ws, trained, backend, npy_hints):
    """cv2 hints from the reader equal the .npy of the reader's hints; the
    card's canny (here the CPU plain version) on the tree's images equals
    the .npy route without --hints."""
    tree_task, npy_task = f"cn_{backend}_tree", f"cn_{backend}_npy"
    for task in (tree_task, npy_task):
        _copy_into(ws, "base", task, "ddpm.pth")
    if backend == "cv2":
        tree = trained["cn"]
    else:
        tree = train_ddpm_controlnet.train(_mnist_config(ws, tree_task), device="cpu",
                                           hint_backend=backend)
    npy = train_ddpm_controlnet.train(
        _mnist_config(ws, npy_task), ws.path("train_images.npy"),
        ws.path("train_hints.npy") if npy_hints else None, device="cpu")
    assert np.isfinite(tree["losses"]).all()
    np.testing.assert_allclose(tree["losses"], npy["losses"], rtol=1e-6)


def test_hint_backend_takes_the_jax_tools_choices():
    """``--hint_backend`` takes cv2 and tpu, the JAX trainer's choices, and
    nothing else."""
    import argparse

    parser = argparse.ArgumentParser()
    cli.add_hint_backend_arg(parser)
    for name in ("cv2", "tpu"):
        assert parser.parse_args(["--hint_backend", name]).hint_backend == name
    assert cli.HINT_BACKENDS == ("cv2", "tpu")
    with pytest.raises(SystemExit):
        parser.parse_args(["--hint_backend", "device"])


def test_train_controlnet_cv2_needs_the_reader(ws):
    with pytest.raises(ValueError, match="--hint_backend cv2"):
        train_ddpm_controlnet.train(_mnist_config(ws, "cn_bad"), ws.path("train_images.npy"),
                                    device="cpu", hint_backend="cv2")


def test_sample_controlnet_reads_test_split_hints(ws, trained):
    config = _mnist_config(ws, "base")
    sample_ddpm_controlnet.main(["--config", config, "--device", "cpu", "--save_every", "5",
                                 "--seed", "3"])
    out = os.path.join(ws.root, "base", "hint_samples")
    assert sorted(os.listdir(out)) == ["hints.png", "x0_0.png", "x0_5.png"]
    # the same draws as the JAX tool's gather_test_hints over the JAX reader
    from tools.sample_ddpm_controlnet import gather_test_hints

    mine = sample_ddpm_controlnet.gather_hints(
        cli.build_dataset("mnist", yaml.safe_load(open(config))["dataset_params"], "test",
                          return_hints=True), 4, seed=3)
    ref = gather_test_hints(jd.MnistDataset("test", ws.path("test"), return_hints=True), 4, 3)
    np.testing.assert_array_equal(mine, ref)


def test_sample_controlnet_device_canny_of_test_split(ws, trained):
    """--hint_backend tpu draws the same test images and takes the port's
    canny of them (the plain version here) in place of cv2's."""
    from controlnet_tpu_torch.ops.canny import canny_hints

    config = yaml.safe_load(open(_mnist_config(ws, "base")))
    got = sample_ddpm_controlnet.split_hints(config, 4, 3, "tpu", "cpu")
    images = sample_ddpm_controlnet.gather_hints(
        pd.MnistDataset("test", ws.path("test")), 4, seed=3)
    want = canny_hints(torch.from_numpy((images + 1.0) / 2.0)).numpy()
    assert got.shape == (4, SIZE, SIZE, 3)
    np.testing.assert_array_equal(got, want)
    sample_ddpm_controlnet.main(["--config", _mnist_config(ws, "base"), "--device", "cpu",
                                 "--hint_backend", "tpu", "--sampler", "ddim",
                                 "--sampler_steps", "2"])


def test_sample_ddpm_tool_and_jax_sampler(ws, trained):
    """The tool writes x0_<t> grids from the trained .pth; its sample()
    equals the JAX ancestral sampler with x_T and the noise injected."""
    config = _mnist_config(ws, "base")
    sample_ddpm.main(["--config", config, "--device", "cpu", "--save_every", "5"])
    assert sorted(os.listdir(os.path.join(ws.root, "base", "samples"))) == ["x0_0.png",
                                                                             "x0_5.png"]
    ju = JaxUNet(1, TINY_MODEL_CONFIG)
    p = random_params(ju, 5)
    shape = (3, SIZE, SIZE, 1)
    key = jax.random.PRNGKey(9)
    ref_x0, ref_traj = jax_make_ddpm_sampler(lambda pp, x, t: ju(pp, x, t),
                                             jax_schedule(T, 1e-4, 0.02), shape,
                                             record_every=5)(p, key)
    unet, sched = sample_ddpm.load_model(yaml.safe_load(open(config)), None, "cpu")
    unet.load_state_dict(jax_params.unet_state_dict_from_jax(p), strict=True)
    x_start, zs = _jax_noise(key, shape, T)
    x0, traj = sample_ddpm.sample(unet, sched, 3, SIZE, record_every=5,
                                  x_start=to_nchw(x_start),
                                  step_noise=torch.from_numpy(zs.transpose(0, 1, 4, 2, 3).copy()))
    assert traj.shape == (2, 3, 1, SIZE, SIZE)
    np.testing.assert_allclose(to_nhwc(x0), np.asarray(ref_x0), atol=2e-4)
    for k in range(2):
        np.testing.assert_allclose(to_nhwc(traj[k]), np.asarray(ref_traj[k]), atol=2e-4)


def test_sample_ddpm_raises_without_cuda_unless_cpu(ws, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_ddpm.main(["--config", _mnist_config(ws, "base")])


def test_distillation_tools_tree_equals_npy(ws, trained):
    """Both trainers read the train (and DMD the test) split's images and cv2
    hints from the trees, as the .npy route does from the readers' arrays;
    the sample tools' test mode draws the test split from the tree."""
    cd, dmd = train_consistency_controlnet_distilled, \
        train_distribution_matching_controlnet_distilled
    for task in ("cd_tree", "cd_npy", "dmd_tree", "dmd_npy"):
        _copy_into(ws, "base", task, "cn.pth")
    a = cd.train(_mnist_config(ws, "cd_tree"), device="cpu")
    b = cd.train(_mnist_config(ws, "cd_npy"), ws.path("train_images.npy"),
                 ws.path("train_hints.npy"), device="cpu")
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-6)
    a = dmd.train(_mnist_config(ws, "dmd_tree"), device="cpu", no_plots=True)
    b = dmd.train(_mnist_config(ws, "dmd_npy"), ws.path("train_images.npy"),
                  ws.path("test_images.npy"), ws.path("train_hints.npy"),
                  ws.path("test_hints.npy"), device="cpu", no_plots=True)
    for k in ("train_total_loss", "val_loss"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6)
    for tool, task in ((sample_consistency_controlnet_distilled, "cd_tree"),
                       (sample_distribution_matching_controlnet_distilled, "dmd_tree")):
        out = tool.main(["--config", _mnist_config(ws, task), "--mode", "test",
                         "--num_samples", "3", "--device", "cpu"])
        assert out["x0"].shape == (3, 1, SIZE, SIZE) and bool(torch.isfinite(out["x0"]).all())
        assert set(np.unique(out["hints"].numpy())) <= {0.0, 1.0}


def _celeb_config(ws, task: str, **train) -> str:
    config = yaml.safe_load(yaml.safe_dump(CELEB_CONFIG))
    config["dataset_params"]["im_path"] = ws.path("celeb")
    config["train_params"].update(task_name=os.path.join(ws.root, task), **train)
    os.makedirs(config["train_params"]["task_name"], exist_ok=True)
    path = os.path.join(ws.root, f"{task}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def test_latent_tools_on_a_celeb_tree(ws):
    """train_vae (tree = .npy route), infer_vae (basename keys, the JAX
    tool's), train_ldm_vae in latent mode (= the cache read alone),
    train_ldm_controlnet with cv2 hints at canny_im_size (= the .npy of the
    reader's hints), sample_ldm_controlnet's hints from the tree."""
    reader = pd.CelebDataset("train", ws.path("celeb"), im_size=16)
    _npy_of_reader(reader, ws.path("celeb.npy"))
    a = train_vae.train(_celeb_config(ws, "lat"), device="cpu")
    b = train_vae.train(_celeb_config(ws, "lat_npy"), ws.path("celeb.npy"), device="cpu")
    for k in a["metrics"][0]:
        np.testing.assert_allclose(a["metrics"][0][k], b["metrics"][0][k], rtol=1e-6)

    infer_vae.infer(_celeb_config(ws, "lat"), device="cpu")
    cache = os.path.join(ws.root, "lat", "vae_latents")
    keys = set(pd.load_latents(cache))
    assert keys == set(jd.CelebDataset("train", ws.path("celeb"), im_size=16).images)
    assert all(k.startswith("face_") and k.endswith(".png") for k in keys)

    tree = train_ldm_vae.train(_celeb_config(ws, "lat"), device="cpu")
    # the same cache read alone, in sorted key order (basenames sort as the tree)
    _copy_into(ws, "lat", "lat_cache", os.path.join("vae_latents", "latents_0.npz"))
    cfg = yaml.safe_load(open(_celeb_config(ws, "lat_cache")))
    cfg["dataset_params"]["im_path"] = ws.path("no_tree")
    with open(ws.path("lat_cache.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)
    alone = train_ldm_vae.train(ws.path("lat_cache.yaml"), device="cpu")
    np.testing.assert_allclose(tree["losses"], alone["losses"], rtol=1e-6)

    hint_reader = pd.CelebDataset("train", ws.path("celeb"), im_size=16, return_hint=True,
                                  canny_im_size=32)
    np.save(ws.path("celeb_hints.npy"), np.stack([hint_reader[i][1]
                                                  for i in range(len(hint_reader))]))
    cn_tree = train_ldm_controlnet.train(_celeb_config(ws, "lat"), device="cpu")
    _copy_into(ws, "lat", "lat_cache", "ddpm_ckpt.pth")
    cn_npy = train_ldm_controlnet.train(ws.path("lat_cache.yaml"), ws.path("celeb_hints.npy"),
                                        device="cpu")
    np.testing.assert_allclose(cn_tree["losses"], cn_npy["losses"], rtol=1e-6)

    sample_ldm_controlnet.main(["--config", _celeb_config(ws, "lat"), "--device", "cpu",
                                "--sampler", "ddim", "--sampler_steps", "2"])
    assert os.path.exists(os.path.join(ws.root, "lat", "hint_samples", "final_decoded.png"))
