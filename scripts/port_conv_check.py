#!/usr/bin/env python3
"""Build the port's CUDA kernels with ptxas's report, then hold the 3x3
transposed-layout conv kernel (controlnet_tpu_torch/csrc/conv3x3_tl.cu)
against its plain version, and time it beside F.conv2d and its bound, at
the seven shapes of the CelebA-HQ hint encode (1024^2 hints, factor 32) on
one CUDA card.

    python3 scripts/port_conv_check.py [--batch 16]

The shapes and the check are chip_smoke.py's; this script runs that one phase
alone, for work on the kernel.
"""

import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from controlnet_tpu_torch.ops import _build  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(description="check and time the conv kernel alone")
    parser.add_argument("--batch", type=int, default=chip_smoke.LDM_BATCH)
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {chip_smoke.nvidia_smi_line()}; torch {torch.__version__}", flush=True)
    _build.build(verbose=True)
    shapes = chip_smoke.hint_conv_shapes(1024, 3, 256, 32, args.batch)
    chip_smoke.phase_conv_kernels(shapes, torch.device("cuda"))


if __name__ == "__main__":
    main()
