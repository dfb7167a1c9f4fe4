"""Port canny (controlnet_tpu_torch.ops.canny) against the JAX package's
on-device canny (controlnet_tpu.ops.canny).

Both compute on integer-valued float32 pixels with the same Sobel taps,
sector thresholds and hysteresis count, so the hints must agree exactly:
the tolerance is equality of the {0, 1} maps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlnet_tpu.data.synthetic import _draw_shape
from controlnet_tpu.ops.canny import canny_edges as jax_canny_edges
from controlnet_tpu.ops.canny import canny_hints as jax_canny_hints
from controlnet_tpu_torch.ops.canny import canny_edges, canny_hints


def _shapes(seed, n, size):
    """Digit-like uint8 strokes (the JAX package's synthetic shapes)."""
    rng = np.random.default_rng(seed)
    return np.stack([_draw_shape(rng, size, k) for k in range(n)])


def _rings(seed, n, size):
    """Thick anti-aliased rings of random centre, radius and brightness."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    out = []
    for _ in range(n):
        cy, cx = rng.uniform(size * 0.3, size * 0.7, 2)
        r, w = rng.uniform(size * 0.15, size * 0.35), rng.uniform(0.8, 2.0)
        d = np.abs(np.hypot(yy - cy, xx - cx) - r)
        out.append(np.clip(w + 0.5 - d, 0, 1) * rng.uniform(150, 255))
    return np.stack(out).astype(np.uint8)


@pytest.mark.parametrize("make,size", [(_shapes, 28), (_rings, 28), (_rings, 32), (_shapes, 64)],
                         ids=["shapes-28", "rings-28", "rings-32", "shapes-64"])
def test_canny_hints_match_jax_gray(make, size):
    imgs = make(0, 8, size).astype(np.float32) / 255.0
    ref = np.asarray(jax_canny_hints(jnp.asarray(imgs[..., None])))
    out = canny_hints(torch.from_numpy(imgs[..., None]))
    assert out.shape == (8, size, size, 3) and out.dtype == torch.float32
    assert ref.sum() > 0
    np.testing.assert_array_equal(out.numpy(), ref)


def test_canny_hints_match_jax_rgb():
    imgs = _shapes(1, 6, 32).astype(np.float32) / 255.0
    rgb = np.stack([imgs, imgs * 0.8, imgs * 0.6], axis=-1)
    ref = np.asarray(jax_canny_hints(jnp.asarray(rgb)))
    np.testing.assert_array_equal(canny_hints(torch.from_numpy(rgb)).numpy(), ref)


@pytest.mark.parametrize("low,high,iters", [(100, 200, None), (50, 120, 4), (100, 200, 1)])
def test_canny_edges_match_jax(low, high, iters):
    """Thresholds and hysteresis length, on noisy grey levels (many weak
    pixels, so a short hysteresis leaves chains unfinished)."""
    rng = np.random.default_rng(2)
    imgs = np.clip(_rings(3, 6, 28).astype(np.float32)
                   + rng.normal(0, 30, (6, 28, 28)), 0, 255).round()
    ref = np.asarray(jax_canny_edges(jnp.asarray(imgs), low, high, iters))
    out = canny_edges(torch.from_numpy(imgs), low, high, iters)
    assert set(np.unique(ref)) <= {0.0, 255.0}
    np.testing.assert_array_equal(out.numpy(), ref)


def test_canny_blank_flat_and_contract():
    assert canny_edges(torch.zeros(1, 16, 16)).sum() == 0
    assert canny_edges(torch.full((1, 16, 16), 200.0)).sum() == 0
    hints = canny_hints(torch.from_numpy(_shapes(4, 2, 28).astype(np.float32)[..., None] / 255.0))
    assert set(torch.unique(hints).tolist()) <= {0.0, 1.0}
    assert torch.equal(hints[..., 0], hints[..., 1]) and torch.equal(hints[..., 0], hints[..., 2])
