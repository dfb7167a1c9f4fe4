"""Synthetic image fixtures: small class-labelled PNG trees with crisp
geometric shapes, in place of the real MNIST / CIFAR-10 / CelebA-HQ data
(none of which is in the repository).

The port's own copy of ``controlnet_tpu/data/synthetic.py``: the same seed
writes the same tree, PNG for PNG (``tests/test_torch_port_data.py`` holds
them equal).  The tree has the layout the readers in ``data/datasets.py``
glob (``<root>/<class>/*.png``):

    <root>/<class_idx>/<i>.png

Shapes are drawn with hard edges on a black background, so cv2.Canny and
the port's canny (``ops/canny.py``) find the same contours.  ``chip_smoke.py``
writes its trees with it.
"""

from __future__ import annotations

import os

import numpy as np

def _draw_shape(rng: np.random.Generator, size: int, k: int) -> np.ndarray:
    """One uint8 (size, size) grayscale image with a bright geometric shape.

    ``k`` selects the shape family (rect / circle / cross / frame), so a
    range over k yields edge orientations in every direction (axis-aligned,
    diagonal via the circle) for the canny fidelity tests.
    """
    img = np.zeros((size, size), np.uint8)
    val = int(rng.integers(190, 256))
    m = max(2, size // 7)  # margin
    kind = k % 4
    if kind == 0:  # filled rectangle
        y0 = int(rng.integers(m, size // 2))
        x0 = int(rng.integers(m, size // 2))
        y1 = int(rng.integers(size // 2 + 1, size - m + 1))
        x1 = int(rng.integers(size // 2 + 1, size - m + 1))
        img[y0:y1, x0:x1] = val
    elif kind == 1:  # filled circle
        cy = size / 2 + float(rng.uniform(-size / 8, size / 8))
        cx = size / 2 + float(rng.uniform(-size / 8, size / 8))
        r = float(rng.uniform(size / 5, size / 2 - m))
        yy, xx = np.mgrid[0:size, 0:size]
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = val
    elif kind == 2:  # thick cross
        w = max(2, size // 8)
        c = size // 2 + int(rng.integers(-size // 8, size // 8 + 1))
        img[c - w : c + w, m : size - m] = val
        img[m : size - m, c - w : c + w] = val
    else:  # hollow frame
        t = max(2, size // 9)
        hi = max(m + 1, size // 3)
        y0 = int(rng.integers(m, hi))
        x0 = int(rng.integers(m, hi))
        y1 = size - int(rng.integers(m, hi))
        x1 = size - int(rng.integers(m, hi))
        img[y0:y1, x0:x1] = val
        img[y0 + t : y1 - t, x0 + t : x1 - t] = 0
    return img


def make_synthetic_image_tree(
    path: str,
    num_classes: int = 2,
    per_class: int = 8,
    size: int = 28,
    channels: int = 1,
    seed: int = 0,
) -> str:
    """Write ``num_classes * per_class`` shape PNGs under
    ``<path>/<class>/<i>.png`` and return ``path``.

    ``channels=1`` writes grayscale (MNIST layout), ``channels=3`` writes a
    randomly tinted RGB version of the same shape (CIFAR layout,
    dataset/cifar_dataset.py:95-104 writes an identical per-class tree).
    """
    from PIL import Image  # imported here: the port's modules import without PIL

    rng = np.random.default_rng(seed)
    for cls in range(num_classes):
        d = os.path.join(path, str(cls))
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            gray = _draw_shape(rng, size, k=cls * per_class + i)
            if channels == 3:
                tint = rng.uniform(0.6, 1.0, size=3)
                arr = np.clip(gray[..., None] * tint[None, None, :], 0, 255).astype(np.uint8)
                Image.fromarray(arr, mode="RGB").save(os.path.join(d, f"{i}.png"))
            else:
                Image.fromarray(gray, mode="L").save(os.path.join(d, f"{i}.png"))
    return path
