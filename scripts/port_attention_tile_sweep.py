#!/usr/bin/env python3
"""Time the port's float32 CUDA attention kernel (kernel a's float32 path,
csrc/attention_fwd.cu) at the main-path shapes under a few shared-memory
key/value tile budgets (controlnet_tpu_torch.ops.cuda_attention
.KV_TILE_BYTES), batch*heads 256.  The bf16 path runs on the tensor cores with
a fixed 64-key tile (csrc/attention_fwd_bf16.cu, ``MMA_KV_TILE``) and takes no
budget; scripts/port_attention_proj_check.py --attention times it.  Needs one
CUDA card:

    python3 scripts/port_attention_tile_sweep.py
"""

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from controlnet_tpu_torch.ops import cuda_attention  # noqa: E402

SHAPES = [(784, 16, 4), (784, 4, 2), (196, 32, 4), (196, 8, 2), (49, 64, 8), (49, 32, 4),
          (49, 16, 2)]  # (L, head_dim, calls per ControlNet forward)
BUDGETS = [8 * 1024, 16 * 1024, 32 * 1024, 48 * 1024, 100 * 1024, 200 * 1024]


def time_ms(fn, iters=50):
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    for budget in BUDGETS:
        cuda_attention.KV_TILE_BYTES = budget
        total = 0.0
        parts = []
        for l, dh, n in SHAPES:
            q, k, v = (torch.randn(64, 4, dh, l, device="cuda") for _ in range(3))
            ms = time_ms(lambda: cuda_attention.fused_attention_t(q, k, v))
            total += n * ms
            parts.append(f"L{l}/dh{dh} {ms:.4f}")
        print(f"float32 tile {budget // 1024:3d} KB: per forward {total:.4f} ms | "
              + ", ".join(parts), flush=True)


if __name__ == "__main__":
    with torch.inference_mode():
        main()
