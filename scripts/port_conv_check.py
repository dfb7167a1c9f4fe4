#!/usr/bin/env python3
"""Build the port's CUDA kernels with ptxas's register and spill report and
count each kernel's tensor-core instructions, then hold the 3x3
transposed-layout conv kernel (kernel c: csrc/conv3x3_tl.cu in float32,
csrc/conv3x3_tl_bf16.cu in bf16) against its plain version at the seven
shapes of the CelebA-HQ hint encode (1024^2 hints, factor 32) and
chip_smoke.py's ragged shape, on one CUDA card.

    python3 scripts/port_conv_check.py [--batch 16] [--check-only]

``--check-only`` times nothing: it holds the bf16 kernel against its plain
version once at every shape, which is the quick first call after a change to
the kernel.  Without it the script runs chip_smoke.py's phase 10 alone (both
types, device times beside F.conv2d's and the bound).
"""

import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from controlnet_tpu_torch.ops import _build  # noqa: E402


def check_only(shapes: list, device) -> None:
    """The bf16 kernel once against its plain version at every shape."""
    from controlnet_tpu_torch.ops import cuda_conv

    failed = []
    for cin, cout, h, w, b in shapes:
        g = torch.Generator(device=device).manual_seed(chip_smoke.SEED)
        x = cuda_conv.to_tl(torch.randn((b, cin, h, w), generator=g, device=device).bfloat16())
        bound = 1.0 / (9 * cin) ** 0.5
        weight = (torch.rand((cout, cin, 3, 3), generator=g, device=device) * 2 - 1) * bound
        bias = (torch.rand((cout,), generator=g, device=device) * 2 - 1) * bound
        with torch.inference_mode():
            before = cuda_conv.launches
            out = cuda_conv.conv3x3_tl(weight, bias, x, (h, w)).float()
            ref = cuda_conv.conv3x3_tl_plain(weight, bias, x, (h, w)).float()
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        err = (out - ref).abs().max().item() / scale
        ok = (cuda_conv.launches == before + 1 and err <= chip_smoke.CONV_TOL[torch.bfloat16]
              and bool(torch.isfinite(out).all()))
        print(f"c bf16 {cin:3d}->{cout:3d} @{h}x{w} B {b}: launch config "
              f"{cuda_conv.mma_launch_config(cin, cout, h, w, b)}, rel err {err:.3g} (tol "
              f"{chip_smoke.CONV_TOL[torch.bfloat16]:g}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failed.append((cin, cout, h, w))
    if failed:
        raise SystemExit(f"conv kernel disagrees with its plain version at {failed}")


def main() -> None:
    parser = argparse.ArgumentParser(description="check and time the conv kernel alone")
    parser.add_argument("--batch", type=int, default=chip_smoke.LDM_BATCH)
    parser.add_argument("--check-only", action="store_true",
                        help="the bf16 kernel against its plain version once; no timing")
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    print(f"card: {chip_smoke.nvidia_smi_line()}; torch {torch.__version__}", flush=True)
    _build.build(verbose=True)
    chip_smoke.phase_sass(chip_smoke.start_sass(str(_build.LIB_PATH), _build._nvcc()))
    shapes = chip_smoke.hint_conv_shapes(1024, 3, 256, 32, args.batch)
    if args.check_only:
        check_only(shapes + [chip_smoke.RAGGED_CONV_SHAPE[:4] + (args.batch,)], device)
        return
    chip_smoke.phase_conv_kernels(shapes, device)


if __name__ == "__main__":
    main()
