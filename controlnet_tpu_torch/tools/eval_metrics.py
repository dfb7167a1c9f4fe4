"""Sample-quality metrics between two image sets: FFD and matched-pair LPIPS.

Counterpart of ``tools/eval_metrics.py`` (the same functions, CLI and JSON
keys):

* **FFD**: the Fréchet distance between the two sets' global-average-pooled
  top-stage features of the DMD ``FeatureExtractor`` (``models/dmd.py``),
  seeded, frozen and the same for both sets; run on the device, 64 images a
  batch (its batch norm uses the batch's statistics, as in JAX).  The
  distance itself is numpy / scipy ``sqrtm``.  With fewer images than the
  top stage is wide (256 for grayscale, 512 for RGB) the covariances are
  singular and the distance is ill-conditioned.
* **LPIPS**: the mean distance between the i-th images of the two sets
  (``models/lpips.py``, frozen random features drawn from ``seed + 1``).

The port draws its networks from a torch generator where the JAX tool draws
them from ``PRNGKey(seed)``, so the two CLIs give different numbers for the
same trees: compare FFD values within one tool.  ``evaluate`` and
``ffd_with_ci`` take the networks as arguments to use others.

    python -m controlnet_tpu_torch.tools.eval_metrics --dir_a mnist/samples_a \\
        --dir_b mnist/samples_b [--im_channels 1] [--out metrics.json] [--device cpu]

Runs on the card; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from controlnet_tpu_torch.device import resolve_device
from controlnet_tpu_torch.models.dmd import FeatureExtractor
from controlnet_tpu_torch.models.lpips import LPIPS


def load_images(d: str, im_channels: int) -> np.ndarray:
    from PIL import Image

    paths = sorted(
        glob.glob(os.path.join(d, "*.png")) + glob.glob(os.path.join(d, "*.jpg"))
    )
    assert paths, f"no images under {d}"
    ims = []
    for p in paths:
        im = Image.open(p)
        im = im.convert("L" if im_channels == 1 else "RGB")
        arr = np.asarray(im, np.float32) / 255.0 * 2.0 - 1.0
        if arr.ndim == 2:
            arr = arr[:, :, None]
        ims.append(arr)
    return np.stack(ims)


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    """d^2 = |mu1-mu2|^2 + Tr(C1 + C2 - 2 sqrt(C1 C2))."""
    from scipy import linalg

    diff = mu1 - mu2
    # scipy < 1.16 returns (sqrtm, errest) when asked for the error estimate
    covmean = linalg.sqrtm(cov1 @ cov2)
    if isinstance(covmean, tuple):
        covmean = covmean[0]
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * np.trace(covmean))


def _nchw(images: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(images.transpose(0, 3, 1, 2))).to(device)


def extract_features(fe: FeatureExtractor, images: np.ndarray, batch: int = 64) -> np.ndarray:
    """Global-average-pooled top-stage features, one row per (H, W, C) image,
    ``batch`` images a forward on ``fe``'s device."""
    device = next(fe.parameters()).device
    chunks = []
    with torch.inference_mode():
        for i in range(0, len(images), batch):
            top = fe(_nchw(images[i:i + batch], device))[-1]
            chunks.append(top.float().mean(dim=(2, 3)).cpu().numpy())
    return np.concatenate(chunks)


def _stats(feats: np.ndarray):
    return feats.mean(axis=0), np.cov(feats, rowvar=False)


def feature_stats(fe: FeatureExtractor, images: np.ndarray, batch: int = 64):
    """Global-average-pooled top-stage features -> (mu, cov)."""
    return _stats(extract_features(fe, images, batch))


def _feature_net(im_channels: int, seed: int, fe: FeatureExtractor | None, device):
    return (fe if fe is not None else FeatureExtractor(im_channels, seed=seed)).to(device).eval()


def ffd_with_ci(images_a: np.ndarray, images_b: np.ndarray, im_channels: int,
                seed: int = 0, n_boot: int = 100, paired: bool = False,
                fe: FeatureExtractor | None = None, device=None):
    """FFD point estimate + percentile-bootstrap 95% CI.

    Features are extracted once; each bootstrap draw resamples image rows
    with replacement on both sides and recomputes the Fréchet distance from
    the resampled (mu, cov).  ``paired=True`` draws the same indices on both
    sides, for sets whose row i correspond (the same x_T and hint): drawing
    them apart would measure unpaired estimator noise instead.  ``fe`` is
    the feature net (default: ``FeatureExtractor(im_channels, seed)``)."""
    fe = _feature_net(im_channels, seed, fe, resolve_device(device))
    fa = extract_features(fe, images_a)
    fb = extract_features(fe, images_b)
    if paired and len(fa) != len(fb):
        raise ValueError(f"paired=True needs equal sizes, got {len(fa)}/{len(fb)}")
    point = frechet_distance(*_stats(fa), *_stats(fb))
    rng = np.random.default_rng(seed)
    vals = []
    for _ in range(n_boot):
        ia = rng.integers(0, len(fa), len(fa))
        ib = ia if paired else rng.integers(0, len(fb), len(fb))
        vals.append(frechet_distance(*_stats(fa[ia]), *_stats(fb[ib])))
    lo, hi = np.percentile(vals, [2.5, 97.5])
    return {"ffd": float(point), "ffd_ci_lo": float(lo), "ffd_ci_hi": float(hi),
            "n_boot": n_boot, "paired": paired}


def evaluate(images_a: np.ndarray, images_b: np.ndarray, im_channels: int, seed: int = 0,
             fe: FeatureExtractor | None = None, lpips: LPIPS | None = None, device=None):
    """FFD and mean matched-pair LPIPS of two (N, H, W, C) sets in [-1, 1];
    ``fe`` / ``lpips`` default to the seeded networks."""
    device = resolve_device(device)
    fe = _feature_net(im_channels, seed, fe, device)
    mu_a, cov_a = feature_stats(fe, images_a)
    mu_b, cov_b = feature_stats(fe, images_b)
    ffd = frechet_distance(mu_a, cov_a, mu_b, cov_b)

    if lpips is None:
        lpips = LPIPS(torch.Generator().manual_seed(seed + 1))
    lpips = lpips.to(device).eval()
    n = min(len(images_a), len(images_b))
    lpips_vals = []
    with torch.inference_mode():
        for i in range(0, n, 32):
            a = images_a[i:i + 32]
            b = images_b[i:i + 32]
            m = min(a.shape[0], b.shape[0])
            lpips_vals.append(lpips(_nchw(a[:m], device), _nchw(b[:m], device)).mean().item())
    return {"ffd": ffd, "lpips_mean": float(np.mean(lpips_vals)), "n_a": len(images_a),
            "n_b": len(images_b)}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="Fidelity metrics between two sample sets (PyTorch port)")
    parser.add_argument("--dir_a", required=True)
    parser.add_argument("--dir_b", required=True)
    parser.add_argument("--im_channels", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    images_a = load_images(args.dir_a, args.im_channels)
    images_b = load_images(args.dir_b, args.im_channels)
    metrics = evaluate(images_a, images_b, args.im_channels, args.seed, device=device)
    print(json.dumps(metrics))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics


if __name__ == "__main__":
    main()
