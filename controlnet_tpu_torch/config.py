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


def validate_class_config(condition_config: Mapping[str, Any]) -> None:
    if "class_condition_config" not in condition_config:
        raise ConfigError("class conditioning desired but class_condition_config missing")
    if "num_classes" not in condition_config["class_condition_config"]:
        raise ConfigError("num_classes missing in class_condition_config")


def validate_text_config(condition_config: Mapping[str, Any]) -> None:
    if "text_condition_config" not in condition_config:
        raise ConfigError("text conditioning desired but text_condition_config missing")
    if "text_embed_dim" not in condition_config["text_condition_config"]:
        raise ConfigError("text_embed_dim missing in text_condition_config")


def validate_image_config(condition_config: Mapping[str, Any]) -> None:
    if "image_condition_config" not in condition_config:
        raise ConfigError("image conditioning desired but image_condition_config missing")
    icc = condition_config["image_condition_config"]
    if "image_condition_input_channels" not in icc:
        raise ConfigError("image_condition_input_channels missing in image_condition_config")
    if "image_condition_output_channels" not in icc:
        raise ConfigError("image_condition_output_channels missing in image_condition_config")


def validate_image_conditional_input(cond_input: Mapping[str, Any], x) -> None:
    """The mask of an image-conditioned call: a 4-d NCHW tensor with x's
    batch (dim 0)."""
    if not isinstance(cond_input, Mapping) or "image" not in cond_input:
        raise ConfigError("model initialized with image conditioning but cond_input has no image")
    im = cond_input["image"]
    if im.dim() != 4 or im.shape[0] != x.shape[0]:
        raise ConfigError("image conditioning input must be a batch-matched NCHW tensor")


def validate_class_conditional_input(cond_input: Mapping[str, Any], x, num_classes: int) -> None:
    if not isinstance(cond_input, Mapping) or "class" not in cond_input:
        raise ConfigError("model initialized with class conditioning but cond_input has no class")
    cls = cond_input["class"]
    if tuple(cls.shape) != (x.shape[0], num_classes):
        raise ConfigError(
            f"class conditioning input must be one-hot (B, num_classes); got {tuple(cls.shape)}")


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
