#!/usr/bin/env python3
"""Build the port's CUDA kernels with ptxas's report, then hold the fused
projection + attention kernel (controlnet_tpu_torch/csrc/attention_proj.cu)
against its plain version, and time it beside the split path,
F.multi_head_attention_forward and its bound, at the six MNIST and the seven
latent self-attention shapes on one CUDA card.

    python3 scripts/port_attention_proj_check.py [--batch 16] [--serve]

``--serve`` also runs the full-width MNIST forward with the fused layer on
and the serve tool's phase.  The shapes and the checks are chip_smoke.py's;
this script runs those phases alone, for work on the kernel or the server.
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
    parser = argparse.ArgumentParser(description="check and time the fused layer kernel alone")
    parser.add_argument("--batch", type=int, default=chip_smoke.SERVE_BATCH)
    parser.add_argument("--serve", action="store_true",
                        help="also run the fused MNIST forward and the serve phase")
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    print(f"card: {chip_smoke.nvidia_smi_line()}; torch {torch.__version__}", flush=True)
    _build.build(verbose=True)
    chip_smoke.phase_proj_kernels(chip_smoke.MNIST_PROJ_SHAPES, args.batch, device,
                                  "MNIST forward")
    chip_smoke.phase_proj_kernels(chip_smoke.LDM_PROJ_SHAPES, args.batch, device,
                                  "latent forward")
    if args.serve:
        from controlnet_tpu_torch.tools import sample_ddpm_controlnet as tool

        config = chip_smoke.mnist_config()
        ckpt = os.path.join(REPO, "build", "smoke", f"mnist_controlnet_seed{chip_smoke.SEED}.pth")
        chip_smoke.write_seeded_checkpoint(config, ckpt)
        cn, _ = tool.load_model(config, ckpt)
        chip_smoke.phase_mnist_fused_forward(cn, device)
        del cn
        chip_smoke.phase_serve(config, ckpt, device)


if __name__ == "__main__":
    main()
