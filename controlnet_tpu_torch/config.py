"""YAML config loading and validation.

The port's own copy of the parts of ``controlnet_tpu/config.py`` that the
ported paths need.  The schema is the same (dataset_params /
diffusion_params / model_params / train_params); the TPU-only
``tpu_params`` section is ignored.
"""

from __future__ import annotations

import os
from typing import Any, Mapping


class ConfigError(ValueError):
    """Raised when a config file fails schema validation."""


def load_config(path: str) -> dict:
    """Load a YAML config file into a plain dict."""
    import yaml

    if not os.path.exists(path):
        raise ConfigError(f"config file not found: {path}")
    with open(path, "r") as f:
        config = yaml.safe_load(f)
    if not isinstance(config, dict):
        raise ConfigError(f"config file {path} did not parse to a mapping")
    return config


def get_config_value(config: Mapping[str, Any], key: str, default_value: Any = None) -> Any:
    return config.get(key, default_value)


def dataset_params(config: Mapping[str, Any]) -> dict:
    return dict(config["dataset_params"])


def diffusion_params(config: Mapping[str, Any]) -> dict:
    return dict(config["diffusion_params"])


def model_params(config: Mapping[str, Any]) -> dict:
    if "model_params" in config:
        return dict(config["model_params"])
    if "ldm_params" in config:
        return dict(config["ldm_params"])
    raise ConfigError("config has neither model_params nor ldm_params")


def ldm_params(config: Mapping[str, Any]) -> dict:
    return dict(config["ldm_params"])


def autoencoder_params(config: Mapping[str, Any]) -> dict:
    return dict(config["autoencoder_params"])


def train_params(config: Mapping[str, Any]) -> dict:
    return dict(config["train_params"])


def validate_unet_model_params(mp: Mapping[str, Any]) -> None:
    """Channel-structure checks shared by every UNet variant."""
    down = mp["down_channels"]
    mid = mp["mid_channels"]
    ds = mp["down_sample"]
    if mid[0] != down[-1]:
        raise ConfigError("mid_channels[0] must equal down_channels[-1]")
    if mid[-1] != down[-2]:
        raise ConfigError("mid_channels[-1] must equal down_channels[-2]")
    if len(ds) != len(down) - 1:
        raise ConfigError("len(down_sample) must be len(down_channels) - 1")


def validate_vae_model_params(mp: Mapping[str, Any]) -> None:
    """Channel-structure checks of the VAE."""
    down = mp["down_channels"]
    mid = mp["mid_channels"]
    if mid[0] != down[-1]:
        raise ConfigError("mid_channels[0] must equal down_channels[-1]")
    if mid[-1] != down[-1]:
        raise ConfigError("mid_channels[-1] must equal down_channels[-1]")
    if len(mp["down_sample"]) != len(down) - 1:
        raise ConfigError("len(down_sample) must be len(down_channels) - 1")
    if len(mp["attn_down"]) != len(down) - 1:
        raise ConfigError("len(attn_down) must be len(down_channels) - 1")
