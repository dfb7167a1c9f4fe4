"""The port's latent-training tools end to end on the CPU (``device="cpu"``),
on the tiny CelebA-HQ config of tests/test_tools_celebhq_e2e.py with
canny_im_size raised to 32 (hint factor 4) and seeded images:
train_vae (1 epoch, then resumed to 2, against an unbroken 2-epoch run) ->
infer_vae (grid, latent shards, no overwrite) -> train_ldm_vae ->
sample_ldm_vae -> train_ldm_controlnet -> the existing sample_ldm_controlnet
on the written ``.pth`` files."""

import os

import numpy as np
import pytest
import torch
import yaml

from controlnet_tpu_torch.data.datasets import load_latents
from controlnet_tpu_torch.io.checkpoint import latest_checkpoint
from controlnet_tpu_torch.io.jax_params import load_reference_checkpoint
from controlnet_tpu_torch.models.controlnet import ControlNet
from controlnet_tpu_torch.models.vae import VAE
from controlnet_tpu_torch.tools import (infer_vae, sample_ldm_controlnet, sample_ldm_vae,
                                        train_ldm_controlnet, train_ldm_vae, train_vae)

N = 12  # images: 3 batches of 4 an epoch, so a 2-call accumulation window spans epochs
CONFIG = {
    "dataset_params": {"name": "celebhq", "im_path": "unused", "im_channels": 3, "im_size": 16,
                       "canny_im_size": 32},
    "diffusion_params": {"num_timesteps": 8, "beta_start": 0.0015, "beta_end": 0.0195},
    "ldm_params": {"hint_channels": 3, "down_channels": [8, 16, 16], "mid_channels": [16, 16],
                   "down_sample": [True, False], "attn_down": [False, True], "time_emb_dim": 8,
                   "norm_channels": 4, "num_heads": 2, "conv_out_channels": 8,
                   "num_down_layers": 1, "num_mid_layers": 1, "num_up_layers": 1},
    "autoencoder_params": {"z_channels": 2, "down_channels": [8, 16], "mid_channels": [16],
                           "down_sample": [True], "attn_down": [False], "norm_channels": 4,
                           "num_heads": 2, "num_down_layers": 1, "num_mid_layers": 1,
                           "num_up_layers": 1},
    "train_params": {"seed": 7, "ldm_batch_size": 4, "autoencoder_batch_size": 4,
                     "disc_start": 2, "disc_weight": 0.5, "perceptual_weight": 1,
                     "kl_weight": 0.000005, "ldm_epochs": 1, "autoencoder_epochs": 1,
                     "controlnet_epochs": 1, "num_samples": 2, "num_grid_rows": 2,
                     "ldm_lr": 0.001, "ldm_lr_steps": [1], "autoencoder_lr": 0.001,
                     "controlnet_lr": 0.001, "controlnet_lr_steps": [1],
                     "autoencoder_acc_steps": 2, "autoencoder_img_save_steps": 2,
                     "save_latents": True, "vae_latent_dir_name": "vae_latents",
                     "ldm_ckpt_name": "ddpm_ckpt.pth",
                     "controlnet_ckpt_name": "ddpm_controlnet_ckpt.pth",
                     "vae_autoencoder_ckpt_name": "vae_autoencoder_ckpt.pth",
                     "vae_discriminator_ckpt_name": "vae_discriminator_ckpt.pth"},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the suite runs in
    parallel workers, and at these sizes torch's thread pool only contends
    with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("latent_tools")
    rng = np.random.default_rng(0)
    images = (rng.random((N, 16, 16, 3)) * 255).astype(np.uint8)
    images[:, 4:12, 4:12] = 255
    np.save(root / "images.npy", images)
    np.save(root / "hints.npy", (rng.random((N, 32, 32, 3)) < 0.2).astype(np.float32))
    return root


def _config(ws, task: str, **train) -> str:
    cfg = {k: dict(v) for k, v in CONFIG.items()}
    cfg["train_params"].update(task_name=str(ws / task), **train)
    path = ws / f"{task}_{'_'.join(f'{k}{v}' for k, v in train.items())}.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _pth(ws, task, name):
    return load_reference_checkpoint(str(ws / task / name))


@pytest.fixture(scope="module")
def chain(ws):
    """The whole chain once, in task "chain": the VAE for 1 epoch and
    resumed to 2, then each later tool; returns each trainer's history."""
    images = str(ws / "images.npy")
    out = {"vae": [train_vae.train(_config(ws, "chain", autoencoder_epochs=e), images,
                                   device="cpu") for e in (1, 2)]}
    cfg = _config(ws, "chain")
    infer_vae.infer(cfg, images, device="cpu")
    out["ldm"] = train_ldm_vae.train(cfg, device="cpu")
    sample_ldm_vae.main(["--config", cfg, "--device", "cpu", "--save_every", "4"])
    out["controlnet"] = train_ldm_controlnet.train(cfg, str(ws / "hints.npy"), device="cpu")
    return out


def test_vae_trainer_writes_grids_checkpoints_and_pth(ws, chain):
    first, second = chain["vae"]
    assert first["epochs"] == [1] and second["epochs"] == [2]
    for h in (first, second):
        assert all(np.isfinite(v) for v in h["metrics"][0].values())
    # disc_start 2: the adversarial terms count from step 3 of epoch 1
    assert first["metrics"][0]["disc_loss"] > 0
    task = ws / "chain"
    grids = sorted(os.listdir(task / "vae_autoencoder_samples"))
    assert grids == [f"current_autoencoder_sample_{s}.png" for s in (1, 2, 4, 6)]
    tp = CONFIG["train_params"]
    for name in (tp["vae_autoencoder_ckpt_name"], tp["vae_discriminator_ckpt_name"]):
        assert latest_checkpoint(str(task), name) == 2
    vae = VAE(3, CONFIG["autoencoder_params"])
    vae.load_state_dict(_pth(ws, "chain", tp["vae_autoencoder_ckpt_name"]), strict=True)


def test_vae_trainer_resumes_exactly(ws, chain):
    """1 epoch, then resumed to 2 (the accumulation window open across the
    epoch boundary is carried in the checkpoint) equals 2 epochs straight."""
    train_vae.train(_config(ws, "straight", autoencoder_epochs=2), str(ws / "images.npy"),
                    device="cpu")
    name = CONFIG["train_params"]["vae_autoencoder_ckpt_name"]
    resumed, straight = _pth(ws, "chain", name), _pth(ws, "straight", name)
    for k in straight:
        assert torch.equal(resumed[k], straight[k]), k
    disc = CONFIG["train_params"]["vae_discriminator_ckpt_name"]
    for k, v in _pth(ws, "straight", disc).items():
        assert torch.equal(_pth(ws, "chain", disc)[k], v), k


def test_infer_vae_writes_grid_and_shards_and_refuses_overwrite(ws, chain, capsys):
    task = ws / "chain"
    assert (task / "vae_infer_samples.png").exists()
    latent_dir = task / "vae_latents"
    assert os.listdir(latent_dir) == ["latents_0.npz"]
    latents = load_latents(str(latent_dir))
    assert sorted(latents) == [f"{i:08d}" for i in range(N)]
    assert all(v.shape == (4, 8, 8) for v in latents.values())
    # the moments of image 5 are the VAE's on that image
    vae = sample_ldm_vae.load_vae(yaml.safe_load(open(_config(ws, "chain"))),
                                  str(task / "vae_autoencoder_ckpt.pth"), "cpu")
    img = np.load(ws / "images.npy")[5:6].astype(np.float32) / 127.5 - 1
    with torch.no_grad():
        ref = vae.moments(torch.from_numpy(img).permute(0, 3, 1, 2))[0].numpy()
    np.testing.assert_allclose(latents["00000005"], ref, atol=1e-5)
    before = os.path.getmtime(latent_dir / "latents_0.npz")
    infer_vae.infer(_config(ws, "chain"), str(ws / "images.npy"), device="cpu")
    assert "refusing to overwrite" in capsys.readouterr().out
    assert os.path.getmtime(latent_dir / "latents_0.npz") == before


def test_latent_export_shards_by_a_thousand(tmp_path, monkeypatch):
    monkeypatch.setattr(infer_vae, "SHARD_SIZE", 5)
    vae = VAE(3, CONFIG["autoencoder_params"])
    assert infer_vae.export_latents(vae, torch.rand(12, 3, 16, 16) * 2 - 1,
                                    str(tmp_path / "lat"), batch_size=4) == 3
    assert sorted(os.listdir(tmp_path / "lat")) == [f"latents_{k}.npz" for k in range(3)]
    assert len(load_latents(str(tmp_path / "lat"))) == 12


def test_ldm_trainer_and_sample_tool(ws, chain):
    h = chain["ldm"]
    assert h["epochs"] == [1] and np.isfinite(h["losses"]).all()
    tp = CONFIG["train_params"]
    unet = sample_ldm_vae.load_ldm(yaml.safe_load(open(_config(ws, "chain"))),
                                   str(ws / "chain" / tp["ldm_ckpt_name"]), "cpu")
    assert unet.im_channels == 2
    samples = sorted(os.listdir(ws / "chain" / "samples"))
    assert samples == ["final_decoded.png", "x0_0.png", "x0_4.png"]


def test_ldm_trainer_encodes_on_the_fly_without_a_cache(ws, chain):
    """No latent cache under the task: the frozen VAE encodes --images."""
    cfg = _config(ws, "fly")
    h = train_ldm_vae.train(cfg, str(ws / "images.npy"),
                            str(ws / "chain" / "vae_autoencoder_ckpt.pth"), device="cpu")
    assert h["epochs"] == [1] and np.isfinite(h["losses"]).all()
    assert (ws / "fly" / "ddpm_ckpt.pth").exists()
    with pytest.raises(ValueError, match="no latent cache"):
        train_ldm_vae.train(_config(ws, "empty"), device="cpu")


def test_ldm_controlnet_trainer_and_the_existing_sample_tool(ws, chain):
    h = chain["controlnet"]
    assert h["epochs"] == [1] and np.isfinite(h["losses"]).all()
    tp = CONFIG["train_params"]
    sd = _pth(ws, "chain", tp["controlnet_ckpt_name"])
    cn = ControlNet(2, CONFIG["ldm_params"], down_sample_factor=4)
    cn.load_state_dict(sd, strict=True)
    # the frozen trunk is the trained LDM, unchanged
    ldm = _pth(ws, "chain", tp["ldm_ckpt_name"])
    assert all(torch.equal(sd[f"trained_unet.{k}"], v) for k, v in ldm.items())
    sample_ldm_controlnet.main(["--config", _config(ws, "chain"), "--hints",
                                str(ws / "hints.npy"), "--device", "cpu", "--sampler", "ddim",
                                "--sampler_steps", "2"])
    out = sorted(os.listdir(ws / "chain" / "hint_samples"))
    assert "final_decoded.png" in out and "hints.png" in out


def test_ldm_controlnet_trainer_checks_the_hints(ws, chain, tmp_path):
    np.save(tmp_path / "short.npy", np.zeros((N - 1, 32, 32, 3), np.float32))
    with pytest.raises(ValueError, match="do not match"):
        train_ldm_controlnet.train(_config(ws, "chain"), str(tmp_path / "short.npy"),
                                   device="cpu")
