"""Kaggle MNIST CSV -> per-class PNG tree, the tree ``MnistDataset`` reads.

The port's copy of ``controlnet_tpu/utils/extract_mnist_images.py``: each
CSV row after the header is ``label, 784 pixel values``; row ``n`` becomes
``<save_dir>/<label>/<n>.png``.

    python -m controlnet_tpu_torch.utils.extract_mnist_images \\
        --csv mnist_train.csv --save_dir data/mnist/train/images
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np


def extract_images(save_dir: str, csv_fname: str) -> None:
    from PIL import Image

    assert os.path.exists(csv_fname), f"csv file {csv_fname} does not exist"
    with open(csv_fname) as f:
        reader = csv.reader(f)
        next(reader)  # header
        for idx, row in enumerate(reader):
            label = row[0]
            d = os.path.join(save_dir, label)
            os.makedirs(d, exist_ok=True)
            img = np.asarray(row[1:], np.uint8).reshape(28, 28)
            Image.fromarray(img).save(os.path.join(d, f"{idx}.png"))
            if idx % 1000 == 0:
                print(f"extracted {idx} images")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Extract MNIST csv to png tree")
    parser.add_argument("--csv", required=True)
    parser.add_argument("--save_dir", required=True)
    args = parser.parse_args(argv)
    extract_images(args.save_dir, args.csv)


if __name__ == "__main__":
    main()
