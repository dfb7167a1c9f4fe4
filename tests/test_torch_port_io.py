"""Port weight carry-over (controlnet_tpu_torch.io.jax_params) against the
JAX package's exporter, and the port's sampling tool end to end on the CPU.

``controlnet_state_dict_from_jax`` is the port's own copy of the layout rules
of ``controlnet_tpu.io.torch_export``; it must give the same keys and
bit-identical values as ``export_controlnet``, and load with strict=True.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from _torch_port_util import random_params
from controlnet_tpu.io.torch_export import export_controlnet, export_unet, save_torch_checkpoint
from controlnet_tpu.models.controlnet import ControlNet as JaxControlNet
from controlnet_tpu.models.unet import UNet as JaxUNet
from controlnet_tpu_torch.io import jax_params
from controlnet_tpu_torch.models.controlnet import ControlNet
from controlnet_tpu_torch.models.unet import UNet
from controlnet_tpu_torch.tools import sample_ddpm_controlnet as tool


def _assert_same(sd, ref):
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert tuple(sd[k].shape) == v.shape, k
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_controlnet_state_dict_matches_export_controlnet(tiny_model_config):
    cfg = tiny_model_config
    jcn = JaxControlNet(cfg["im_channels"], cfg)
    p = random_params(jcn, 0)
    sd = jax_params.controlnet_state_dict_from_jax(p)
    _assert_same(sd, export_controlnet(p, jcn))
    cn = ControlNet(cfg["im_channels"], cfg)
    cn.load_state_dict(sd, strict=True)
    assert set(cn.state_dict()) == set(sd)


def test_unet_state_dict_matches_export_unet(tiny_model_config):
    cfg = tiny_model_config
    ju = JaxUNet(cfg["im_channels"], cfg)
    p = random_params(ju, 1)
    sd = jax_params.unet_state_dict_from_jax(p)
    _assert_same(sd, export_unet(p))
    UNet(cfg["im_channels"], cfg).load_state_dict(sd, strict=True)


def test_load_reference_checkpoint(tmp_path, tiny_model_config):
    """A .pth written by the JAX package's exporter loads strictly."""
    cfg = tiny_model_config
    jcn = JaxControlNet(cfg["im_channels"], cfg)
    ref = export_controlnet(random_params(jcn, 2), jcn)
    path = str(tmp_path / "cn.pth")
    save_torch_checkpoint(ref, path)
    sd = jax_params.load_reference_checkpoint(path)
    _assert_same(sd, ref)
    ControlNet(cfg["im_channels"], cfg).load_state_dict(sd, strict=True)


def _tiny_config(tmp_path, model_config):
    config = {
        "dataset_params": {"task_name": "mnist"},
        "diffusion_params": {"num_timesteps": 6, "beta_start": 1e-4, "beta_end": 0.02},
        "model_params": dict(model_config),
        "train_params": {"task_name": str(tmp_path / "task"), "num_samples": 3,
                         "num_grid_rows": 2, "controlnet_ckpt_name": "cn.pth"},
        "tpu_params": {"attn_pipe": True},  # TPU-only knobs: ignored by the port
    }
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(config))
    return str(path)


def test_sample_tool_end_to_end_cpu(tmp_path, tiny_model_config):
    """config -> .pth (from the JAX exporter) -> hints .npy -> PNG grids."""
    cfg = tiny_model_config
    jcn = JaxControlNet(cfg["im_channels"], cfg)
    os.makedirs(tmp_path / "task")
    save_torch_checkpoint(export_controlnet(random_params(jcn, 3), jcn),
                          str(tmp_path / "task" / "cn.pth"))
    hints = np.random.default_rng(3).uniform(size=(5, 8, 8, 3)).astype(np.float32)
    np.save(tmp_path / "hints.npy", hints)
    tool.main(["--config", _tiny_config(tmp_path, cfg), "--hints", str(tmp_path / "hints.npy"),
               "--save_every", "3", "--device", "cpu"])
    out = sorted(os.listdir(tmp_path / "task" / "hint_samples"))
    assert out == ["hints.png", "x0_0.png", "x0_3.png"]


def test_sample_function_shapes_and_range(tiny_model_config):
    cfg = {"diffusion_params": {"num_timesteps": 4, "beta_start": 1e-4, "beta_end": 0.02},
           "model_params": dict(tiny_model_config)}
    cn, sched = tool.load_model(cfg, None, device="cpu")
    hints = tool.gather_hints(np.random.default_rng(4).uniform(size=(3, 8, 8, 3)), 2, seed=1)
    x0, traj = tool.sample(cn, sched, hints, seed=0)
    assert x0.shape == (2, 1, 8, 8) and traj.shape == (1, 2, 1, 8, 8)
    assert torch.isfinite(x0).all() and traj.abs().max() <= 1.0
