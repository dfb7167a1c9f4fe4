"""Helpers shared by the tests of the PyTorch port (tests/test_torch_port_*.py):
layout conversions between the JAX package (NHWC) and the port (NCHW), and
JAX parameter trees carried into port modules."""

import jax
import numpy as np
import torch

from controlnet_tpu_torch.io import jax_params

MNIST_CONFIG = dict(
    im_channels=1,
    im_size=28,
    hint_channels=3,
    down_channels=[32, 64, 128, 256],
    mid_channels=[256, 256, 128],
    down_sample=[True, True, False],
    time_emb_dim=128,
    num_down_layers=2,
    num_mid_layers=2,
    num_up_layers=2,
    num_heads=4,
)

# config/celebhq.yaml's ldm_params in structure (three attended downsampling
# levels, one mid block), cut in width and layers
NARROW_LDM = dict(
    hint_channels=3,
    down_channels=[16, 24, 32, 48],
    mid_channels=[48, 32],
    down_sample=[True, True, True],
    attn_down=[True, True, True],
    time_emb_dim=16,
    norm_channels=8,
    num_heads=4,
    conv_out_channels=16,
    num_down_layers=1,
    num_mid_layers=1,
    num_up_layers=1,
)
Z = 2  # latent channels


def to_nchw(x_nhwc) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(x_nhwc, np.float32).transpose(0, 3, 1, 2)))


def to_nhwc(x_nchw: torch.Tensor) -> np.ndarray:
    return x_nchw.detach().float().numpy().transpose(0, 2, 3, 1)


def np_tree(params):
    return jax.tree.map(np.array, params)


def load_block(module: torch.nn.Module, jax_block_params) -> None:
    """Carry one JAX Down/Mid/Up block's parameters into a port block."""
    sd = {}
    jax_params._block(np_tree(jax_block_params), "blk", sd)
    module.load_state_dict(jax_params._to_torch({k[len("blk."):]: v for k, v in sd.items()}),
                           strict=True)


def random_params(jax_module, seed: int):
    """A JAX parameter tree of ``jax_module``'s structure filled from a numpy
    seed (faster than the eager ``init`` at full width).  Weights are
    uniform in +-1/sqrt(fan_in), biases small, norm scales near 1, and the
    zero convs are not zero, so every branch contributes."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0))

    def fill(path, s):
        name = path[-1].key
        if name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif len(s.shape) == 1:
            v = 0.1 * rng.standard_normal(s.shape)
        else:
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            v = rng.uniform(-bound, bound, s.shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)

