#!/usr/bin/env python3
"""Drive the PyTorch port (controlnet_tpu_torch) end to end on one CUDA card.

    python3 chip_smoke.py                  # the whole check, one card
    python3 chip_smoke.py --verbose-build  # also print ptxas's register report

Phases (each one that fails makes the script exit non-zero):

1. Print the card (``nvidia-smi`` name and power limit) and build the CUDA
   kernels from the sources in this checkout (``build/kernels/``).
2. Full-width MNIST ControlNet forward at batch 64 with weights from a
   seeded reference-format ``.pth``: through the kernel against the same
   model with the attention's plain version, f32 and bf16.  The kernel's
   launch counter must rise by exactly 26 per forward; the attention shapes
   of that forward are recorded for phase 3.
3. The attention kernel against its plain version at every main-path shape
   (B*H = 256) and one cross-attention shape, f32 and bf16, with the stated
   tolerances; CUDA-event times of the kernel, the plain version and
   ``torch.nn.functional.scaled_dot_product_attention`` (a yardstick the
   port never calls), beside the least time the card could take.
4. The main path: the sampling tool's ``sample`` over the 1000-step
   ancestral loop at batch 64, f32 and bf16 compute.  Launch counters are
   set to 0 just before and read just after each run.  A 10-step sample is
   also checked against the same sample with the plain attention.
5. A ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line, and as the
   last line ``{"ok": true, "device": {...}}``.

TF32 is off for matmuls and convolutions throughout, so float32 means
float32.  Exits non-zero, printing no result, without a CUDA device or
without the package beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
BATCH = 64
SEED = 0
# Published peaks of one H100 SXM (dense): the float32 rate outside the
# tensor cores, the bf16 tensor-core rate, and the HBM rate.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# Whole-model tolerance, relative to the largest |output|: a wrong attention
# kernel moves the output by O(1); float32 reassociation by ~1e-6.
MODEL_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
CROSS_SHAPE = (49, 7, 16)  # (Lq, Lk, head_dim): not on the main path


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def plain_attention():
    """Route the attention of this process through its plain version (the
    comparison model of phases 2 and 4); the port itself has no such switch."""
    from controlnet_tpu_torch.ops import cuda_attention

    orig = cuda_attention.fused_attention_t
    cuda_attention.fused_attention_t = cuda_attention.fused_attention_t_plain
    try:
        yield
    finally:
        cuda_attention.fused_attention_t = orig


@contextlib.contextmanager
def record_shapes(into: list):
    from controlnet_tpu_torch.ops import cuda_attention

    orig = cuda_attention.fused_attention_t

    def rec(qt, kt, vt):
        into.append((qt.shape[3], kt.shape[3], qt.shape[2], qt.shape[0] * qt.shape[1]))
        return orig(qt, kt, vt)

    cuda_attention.fused_attention_t = rec
    try:
        yield
    finally:
        cuda_attention.fused_attention_t = orig


def cuda_time_ms(fn, min_ms: float = 30.0) -> float:
    """Mean milliseconds per call, CUDA events around a run of calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = int(max(5, min(500, min_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(bh: int, lq: int, lk: int, dh: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time for one call: each input read once and the output written
    once at the HBM rate, or the two products (4*Lq*Lk*dh flops per slice)
    at the card's peak for the input type, whichever is larger."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = itemsize * bh * dh * (2 * lq + 2 * lk)
    flops = 4.0 * bh * lq * lk * dh
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def mnist_config() -> dict:
    from controlnet_tpu_torch import config as cfg

    return cfg.load_config(os.path.join(REPO, "config", "mnist.yaml"))


def write_seeded_checkpoint(config: dict, path: str) -> None:
    """A reference-format .pth of random weights from SEED, with every zero
    conv nonzero so the control branch contributes."""
    from controlnet_tpu_torch.models.controlnet import ControlNet

    torch.manual_seed(SEED)
    mp = config["model_params"]
    cn = ControlNet(mp["im_channels"], mp)
    zero_convs = (list(cn.control_copy_unet_down_zero_convs)
                  + list(cn.control_copy_unet_mid_zero_convs)
                  + [cn.control_copy_unet_hint_block[-1]])
    with torch.no_grad():
        for conv in zero_convs:
            conv.weight.normal_(0.0, 0.05)
            conv.bias.normal_(0.0, 0.05)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(cn.state_dict(), path)


def seeded_hints(n: int, size: int):
    """Binary (N, H, W, 3) edge-like hints in {0, 1}, as canny maps are."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    edges = (rng.uniform(size=(n, size, size, 1)) < 0.15).astype(np.float32)
    return np.repeat(edges, 3, axis=-1)


def phase_forward(cn, device) -> list:
    """Full-width forward, kernel vs plain; returns the recorded shapes."""
    from controlnet_tpu_torch.ops import cuda_attention

    g = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn((BATCH, 1, 28, 28), generator=g, device=device)
    t = torch.randint(0, 1000, (BATCH,), generator=g, device=device)
    hint = (torch.rand((BATCH, 3, 28, 28), generator=g, device=device) < 0.15).float()
    shapes: list = []
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            xin = x.to(dtype)
            feats = cn.hint_features(hint).to(dtype)
            before = cuda_attention.launches
            rec: list = []
            with record_shapes(rec):
                out = cn(xin, t, hint_features=feats)
            torch.cuda.synchronize()
            launched = cuda_attention.launches - before
            with plain_attention():
                ref = cn(xin, t, hint_features=feats)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            ok = (launched == 26 and len(rec) == 26 and bool(torch.isfinite(out).all())
                  and err <= MODEL_TOL[dtype] * max(scale, 1.0))
            log(f"forward {str(dtype)[6:]}: batch {BATCH}, kernel launches {launched} "
                f"(expect 26), max|out| {scale:.4g}, max abs err vs plain {err:.3g} "
                f"(tol {MODEL_TOL[dtype]:g} x max(1, max|out|)) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("full-width forward failed")
            shapes = shapes or rec
    return shapes


def phase_kernels(shapes: list, device) -> dict:
    """Kernel vs plain at every main-path shape, f32 and bf16; timings."""
    import collections

    import torch.nn.functional as F

    from controlnet_tpu_torch.ops import cuda_attention

    mix = collections.Counter(shapes)
    cases = sorted(mix, key=lambda s: (-s[0], -s[2])) + [(*CROSS_SHAPE, BATCH * 4)]
    totals = {}
    for dtype in (torch.float32, torch.bfloat16):
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, flops=0.0,
                   ops_ms=0.0, bytes_ms=0.0, max_abs_err=0.0)
        for lq, lk, dh, bh in cases:
            g = torch.Generator(device=device).manual_seed(SEED)
            q = torch.randn((BATCH, bh // BATCH, dh, lq), generator=g, device=device).to(dtype)
            k = torch.randn((BATCH, bh // BATCH, dh, lk), generator=g, device=device).to(dtype)
            v = torch.randn((BATCH, bh // BATCH, dh, lk), generator=g, device=device).to(dtype)
            with torch.inference_mode():
                out = cuda_attention.fused_attention_t(q, k, v)
                ref = cuda_attention.fused_attention_t_plain(q, k, v)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                ok = err <= KERNEL_TOL[dtype] and bool(torch.isfinite(out).all())
                qh, kh, vh = (a.transpose(-1, -2).contiguous() for a in (q, k, v))
                ms = cuda_time_ms(lambda: cuda_attention.fused_attention_t(q, k, v))
                plain_ms = cuda_time_ms(lambda: cuda_attention.fused_attention_t_plain(q, k, v))
                lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
            bound_ms, bound_by = attention_bound_ms(bh, lq, lk, dh, dtype)
            n = mix.get((lq, lk, dh, bh), 0)
            where = f"x{n} per forward" if n else "cross-attention, off the main path"
            log(f"attention {str(dtype)[6:]:8s} Lq {lq:4d} Lk {lk:4d} dh {dh:2d} BH {bh}: "
                f"err {err:.3g} (tol {KERNEL_TOL[dtype]:g}) {'ok' if ok else 'FAIL'} | "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by}) | {where}")
            if not ok:
                raise SystemExit("attention kernel disagrees with its plain version")
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                             ("library_ms", lib_ms)):
                tot[key] += n * val
            tot["ops_ms"] += n * (bound_ms if bound_by == "operations" else 0.0)
            tot["bytes_ms"] += n * (bound_ms if bound_by == "bytes" else 0.0)
            tot["flops"] += n * 4.0 * bh * lq * lk * dh
        tot["bound_by"] = "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes"
        totals[dtype] = tot
        log(f"attention {str(dtype)[6:]} per forward ({sum(mix.values())} calls): "
            f"kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, "
            f"sdpa {tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
            f"({tot['bound_by']}), {tot['flops'] / 1e9:.2f} GFLOP")
    return totals


def phase_main_path(config: dict, ckpt: str, device) -> dict:
    """The tool's sampling function, 1000 steps, batch 64, f32 and bf16."""
    from controlnet_tpu_torch.ops import cuda_attention
    from controlnet_tpu_torch.schedules.linear import make_linear_schedule
    from controlnet_tpu_torch.tools import sample_ddpm_controlnet as tool

    cn, sched = tool.load_model(config, ckpt)
    hints = tool.gather_hints(seeded_hints(4 * BATCH, 28), BATCH, seed=SEED)
    dp = config["diffusion_params"]

    # a 10-step sample, kernel vs plain attention, same generator seed
    short = make_linear_schedule(10, dp["beta_start"], dp["beta_end"], device=device)
    x0_k, _ = tool.sample(cn, short, hints[:4], seed=SEED)
    with plain_attention():
        x0_p, _ = tool.sample(cn, short, hints[:4], seed=SEED)
    err = (x0_k - x0_p).abs().max().item()
    scale = x0_p.abs().max().item()
    ok = bool(torch.isfinite(x0_k).all()) and err <= MODEL_TOL[torch.float32] * max(scale, 1.0)
    log(f"10-step sample, batch 4: max abs err kernel vs plain {err:.3g} "
        f"(max|x0| {scale:.4g}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("short sample disagrees with the plain attention")

    results = {}
    T = sched.num_timesteps
    for name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        torch.cuda.synchronize()
        cuda_attention.launches = 0
        start = time.perf_counter()
        x0, traj = tool.sample(cn, sched, hints, seed=SEED, compute_dtype=dtype)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = cuda_attention.launches
        final = traj[-1]
        ok = (launches == 26 * T and x0.shape == (BATCH, 1, 28, 28)
              and bool(torch.isfinite(x0).all()) and bool(torch.isfinite(final).all())
              and final.abs().max().item() <= 1.0 and traj.shape[0] == 1)
        results[name] = dict(seconds=seconds, launches=launches,
                             samples_per_s=BATCH / seconds, ms_per_step=seconds * 1e3 / T)
        log(f"main path {name}: {T} steps, batch {BATCH}: {seconds:.3f} s, "
            f"{BATCH / seconds:.3f} samples/s, {seconds * 1e3 / T:.3f} ms/step, "
            f"attention launches {launches} (expect {26 * T}), "
            f"raw x0 range [{x0.min().item():.3g}, {x0.max().item():.3g}], "
            f"written x0 in [-1, 1]: {final.abs().max().item() <= 1.0} -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"main path ({name}) failed")
    return results


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--verbose-build", action="store_true",
                        help="print nvcc's register and shared-memory report")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from controlnet_tpu_torch.ops import _build, cuda_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(DEVICE)
    smi = nvidia_smi_line()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    start = time.perf_counter()
    _build.build(verbose=args.verbose_build)
    _build.load()
    log(f"kernel build: {time.perf_counter() - start:.2f} s ({_build.LIB_PATH.name} from "
        f"{', '.join(p.name for p in _build.sources())})")

    config = mnist_config()
    ckpt = os.path.join(REPO, "build", "smoke", f"mnist_controlnet_seed{SEED}.pth")
    write_seeded_checkpoint(config, ckpt)
    from controlnet_tpu_torch.tools import sample_ddpm_controlnet as tool

    cn, _ = tool.load_model(config, ckpt)
    shapes = phase_forward(cn, device)
    del cn
    kern = phase_kernels(shapes, device)
    main_path = phase_main_path(config, ckpt, device)

    f32, bf16 = kern[torch.float32], kern[torch.bfloat16]
    entry = {
        "name": "attention_fwd_t",
        "route": "cuda",
        "source": "controlnet_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "controlnet_tpu/ops/pallas_attention.py:36",
        "launches": main_path["float32"]["launches"],
        "max_abs_err": f32["max_abs_err"],
        # per ControlNet forward: the 26 calls at their main-path shapes, f32
        "ms": f32["ms"], "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
        "bf16": {"ms": bf16["ms"], "plain_ms": bf16["plain_ms"], "bound_ms": bf16["bound_ms"],
                 "bound_by": bf16["bound_by"], "library_ms": bf16["library_ms"],
                 "max_abs_err": bf16["max_abs_err"],
                 "launches": main_path["bfloat16"]["launches"]},
    }
    log(json.dumps({"kernels": [entry]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
