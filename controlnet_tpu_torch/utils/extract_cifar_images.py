"""CIFAR-10 python batches -> per-class PNG tree, the tree ``CifarDataset`` reads.

The port's copy of ``controlnet_tpu/utils/extract_cifar_images.py``: the
``cifar-10-batches-py`` pickles (``data_batch_1..5``, ``test_batch``) become
``<save_root>/{train,test}/<class>/<n>.png``, ``n`` counting per class and
split; a missing batch file is skipped.  ``--download`` first fetches the
canonical tarball (``download_cifar``), which needs network access.

    python -m controlnet_tpu_torch.utils.extract_cifar_images \\
        --batches_dir cifar-10-batches-py --save_root data/cifar10
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

CLASSES = ["airplane", "automobile", "bird", "cat", "deer",
           "dog", "frog", "horse", "ship", "truck"]


def _load_batch(path: str) -> tuple[np.ndarray, list[int]]:
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    data = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return data, list(d[b"labels"])


def extract_images(batches_dir: str, save_root: str) -> None:
    from PIL import Image

    splits = {
        "train": [f"data_batch_{i}" for i in range(1, 6)],
        "test": ["test_batch"],
    }
    for split, files in splits.items():
        counters = [0] * 10
        for fname in files:
            path = os.path.join(batches_dir, fname)
            if not os.path.exists(path):
                print(f"skipping missing batch file {path}")
                continue
            data, labels = _load_batch(path)
            for img, label in zip(data, labels):
                d = os.path.join(save_root, split, CLASSES[label])
                os.makedirs(d, exist_ok=True)
                Image.fromarray(img).save(os.path.join(d, f"{counters[label]}.png"))
                counters[label] += 1
        print(f"{split}: wrote {sum(counters)} images")


CIFAR_URL = "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"


def download_cifar(dest_dir: str, url: str = CIFAR_URL) -> str:
    """Download and unpack the canonical CIFAR-10 tarball into ``dest_dir``
    (unless its batches are there already); returns the
    ``cifar-10-batches-py`` directory.  Needs network access."""
    import tarfile
    import urllib.request

    os.makedirs(dest_dir, exist_ok=True)
    out = os.path.join(dest_dir, "cifar-10-batches-py")
    if os.path.isdir(out) and os.path.exists(os.path.join(out, "data_batch_1")):
        print(f"found existing {out}")
        return out
    tar_path = os.path.join(dest_dir, "cifar-10-python.tar.gz")
    if not os.path.exists(tar_path):
        print(f"downloading {url} ...")
        urllib.request.urlretrieve(url, tar_path)
    with tarfile.open(tar_path, "r:gz") as tf:
        tf.extractall(dest_dir, filter="data")
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Extract CIFAR-10 pickle batches to a png tree")
    parser.add_argument("--batches_dir",
                        help="path to cifar-10-batches-py/ (omit with --download)")
    parser.add_argument("--save_root", required=True)
    parser.add_argument("--download", action="store_true",
                        help="fetch the canonical tarball first (needs network)")
    args = parser.parse_args(argv)
    batches = args.batches_dir
    if args.download:
        batches = download_cifar(os.path.dirname(args.save_root) or ".")
    if not batches:
        parser.error("--batches_dir is required unless --download is given")
    extract_images(batches, args.save_root)


if __name__ == "__main__":
    main()
