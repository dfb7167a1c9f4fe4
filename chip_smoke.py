#!/usr/bin/env python3
"""Drive the PyTorch port (controlnet_tpu_torch) end to end on one CUDA card.

    python3 chip_smoke.py                  # the whole check, one card
    python3 chip_smoke.py --verbose-build  # also print ptxas's register report

Phases (each one that fails makes the script exit non-zero):

1. Print the card (``nvidia-smi`` name and power limit) and build the CUDA
   kernels from the sources in this checkout (``build/kernels/``); count the
   tensor-core instructions (HMMA) of each kernel in ``cuobjdump -sass`` of
   the library: every bfloat16 instantiation of kernels a, b, c and d must
   have some, and no float32 one any (float32 means float32, no TF32).
2. Full-width MNIST ControlNet forward at batch 64 with weights from a
   seeded reference-format ``.pth``: through the kernel against the same
   model with the attention's plain version, f32 and bf16.  The kernel's
   launch counter must rise by exactly 26 per forward; the attention shapes
   of that forward are recorded for phase 3.
3. The attention kernel against its plain version at every main-path shape
   (B*H = 256) and one cross-attention shape, f32 and bf16, with the stated
   tolerances; device times (``device_time_ms``) of the kernel, the plain
   version and ``torch.nn.functional.scaled_dot_product_attention`` (a
   yardstick the port never calls; the backend that ran is printed), beside
   the least time the card could take.
4. The main path: the sampling tool's ``sample`` over the 1000-step
   ancestral loop at batch 64, f32 and bf16 compute.  Launch counters are
   set to 0 just before and read just after each run.  A 10-step sample is
   also checked against the same sample with the plain attention.
5. One full-width training step at batch 64 (the ControlNet trainer tool's
   step, trunks from a seeded base UNet, hints from the port's canny on the
   card on seeded digit-like images): 26 forward and 18 backward kernel
   launches; the backward shapes are recorded for phase 6.
6. The backward kernel against its plain version at every training shape
   and the cross shape, f32 and bf16, its row term D against rowsum(dP o P)
   from float32 P (beside the rowsum(dO o O) it was formed from before), and
   the forward kernel's saved log-sum-exp against ``torch.logsumexp``;
   device times of the kernel, the plain version and the backward of
   ``scaled_dot_product_attention`` (a yardstick the port never calls; the
   backend that ran is printed), beside the least time the card could
   take.
7. Three training steps through the kernels against the same steps with
   the plain attention forward and backward, from one generator, f32 and
   bf16: losses, first-step gradients and the weights after.
8. The training main path: 20 timed steps of the trainer's step at batch
   64, f32 and bf16 compute, counters set to 0 just before and read just
   after (exactly 26 forward and 18 backward launches a step), trainable
   weights moved and frozen ones bit-identical; ms/step on the host clock
   and a short torch.profiler window for device time.
9. The trainer tools: ``train_ddpm`` and ``train_ddpm_controlnet`` for one
   epoch over 256 seeded images, each resumed to a second epoch, then the
   sampling tool loads the written ControlNet ``.pth`` for a 10-step sample.
10. The 3x3 transposed-layout conv kernel against its plain version at the
   seven shapes of the CelebA-HQ hint encode (1024^2 hints, batch 16) and
   one ragged shape (24 -> 40 channels at 30 x 30), f32 and bf16; device
   times of the kernel (its own share beside the wrapper's casts), the plain
   version and ``F.conv2d`` (a yardstick the port never calls for these
   convs), beside the least time the card could take.
11. The full-width hint encode at batch 16: exactly 7 conv-kernel launches
   per chunk, the kernel route against the NCHW route through ``F.conv2d``,
   and chunked (4 hints at a time) against unchunked.
12. The full-width latent ControlNet forward (``config/celebhq.yaml``, batch
   16) through the attention kernel against the plain attention, 22 launches
   per forward; then the attention kernel against its plain version at
   those shapes (B*H = 256; L 1024..16, head dims 8..48), timed as in
   phase 3.
13. The latent main path through the sample tool (seeded ``.pth`` weights,
   ``.npy`` hints, batch 16): a 5-step sample with guidance through the kernels
   against the plain versions; then the ancestral loop (cut to a 250-step
   schedule, which leaves time for the later phases: its ms/step is what is
   read), DPM-Solver++ 20 steps with ``cfg_scale`` 2.0 and DDIM 50 steps on
   the 1000-step schedule, f32 and bf16, each ending
   in VAE-decoded (16, 3, 128, 128) images; counters set to 0 just before
   and read just after each run.
14. The fused projection + attention layer (kernel d) switched on: the
   full-width MNIST forward at batch 64 launches it 24 times and the
   attention kernel twice (head dim 4), the full-width latent forward at
   batch 16 launches it 22 times; each against the same forward with the
   switch off and with the plain versions, f32 and bf16.
15. Kernel d against its plain version at the six MNIST shapes (batch 16,
   the server's largest bucket, and batch 64) and the seven latent shapes
   (batch 16), on the channel-major activations the model passes, f32 and
   bf16; device times of the kernel, the plain version, the split path the
   port runs with the switch off (projection, attention kernel, projection)
   and ``F.multi_head_attention_forward`` (a yardstick the port never
   calls), beside the least time the card could take; the launch plan
   (rows, cluster, shared memory, clusters the card holds at once) and the
   kernel's clock cycles a block by phase.
16. The serving main path: the serve tool's ``make_server`` on a free port,
   ``dpm_controlnet`` from the seeded ``.pth``, buckets up to 16, up to 20
   steps, switch on.  ``/healthz``; ``/generate_batch`` of 16 rows at 4, 10
   and 20 steps with the counters set to 0 just before and read just after;
   ``/generate`` when PIL imports; a pinned-x_T batch through
   ``build_generator``, kernels against plain versions; 32 concurrent
   one-row clients (in a process of their own) with and without dynamic
   batching; the two 400s; the same 16-row request, in turns, to servers with
   the switch off and with ``ddim_controlnet``; a profiler window over one
   generation; shutdown.
17. A ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line, and as the
   last line ``{"ok": true, "device": {...}}``.

Kernel, plain-version and library times are device time: the profiler's sum
of the GPU work a call launches (``device_time_ms``), the wrappers' own casts
included, taken by the timing phases (3, 6, 10, 12, 15) each in a process of
its own (``in_fresh_process``).  Beside each, the CUDA-event time of a loop of
calls (``cuda_time_ms``, the yardstick of earlier runs) is printed once more
for comparison.  TF32 is off for matmuls and convolutions throughout, so float32
means float32.  Exits non-zero, printing no result, without a CUDA device or
without the package beside it.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import json
import os
import shutil
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
# Kernel b against its plain version, relative to max|grad|: float32 sums in
# another order (measured ~2e-6); in bf16 both compute in float32 from the
# same bf16 operands (P and dS enter their products as hi + lo, ~2^-17), so a
# gradient differs where a float32 sum lands on the other side of a bf16
# rounding boundary: one bf16 ulp, at most 2^-7 = 7.8e-3 of max|grad|.  The
# lse that kernel a saves, absolute, natural log (float32 math in both types).
BWD_KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
LSE_TOL = 1e-4
# Kernel c against its plain version, relative to max|out|: the plain version
# is a float32 cuDNN convolution, which may sum in Winograd form (float32
# errors up to ~1e-4 of the output's scale); in bf16 both round the same
# float32 sums once (half an ulp, 2e-3 of the value).
CONV_TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}
# Kernel d against its plain version, relative to max|out|: float32 sums in
# another order (three chained products); in bf16 a sum that lands near a
# rounding boundary rounds the other way in q, k, v, the head outputs or y
# (one bf16 ulp is 0.8% of a value).
PROJ_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# The fused layer against the split path inside a whole forward: in bf16 both
# round q|k|v, the head outputs and y, but from float32 sums taken in another
# order, so a sum near a rounding boundary rounds the other way and the
# forward's later layers carry it on.
FUSED_VS_SPLIT_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-1}
SERVE_BATCH = 16    # the serve tool's default largest bucket
SERVE_STEPS = (4, 10, 20)
SERVE_CLIENTS = 32
# (L, C, heads, calls per forward) of the self-attention layers kernel d takes
MNIST_PROJ_SHAPES = [(784, 64, 4, 4), (196, 128, 4, 4), (196, 32, 4, 2), (49, 256, 4, 8),
                     (49, 128, 4, 4), (49, 64, 4, 2)]
LDM_PROJ_SHAPES = [(1024, 384, 16, 4), (1024, 128, 16, 2), (256, 512, 16, 4),
                   (256, 256, 16, 2), (64, 768, 16, 4), (64, 384, 16, 2), (16, 512, 16, 4)]
LDM_BATCH = 16      # train_params.ldm_batch_size of config/celebhq.yaml
TRAIN_STEPS = 20    # timed steps of the training main path, per compute type
TRAIN_WARMUP = 2
PROFILE_STEPS = 5
CHECK_STEPS = 3     # kernel-vs-plain training steps
NOISE_FLOOR = 1e-6  # |gradient| below which Adam (eps 1e-8) amplifies float noise
TOOL_IMAGES = 256   # the trainer tools' seeded dataset: 4 steps per epoch


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class _PlainAttention(torch.autograd.Function):
    """The plain forward and the plain backward on any device: the comparison
    model of the training phases (the port's own Function launches kernels a
    and b on CUDA tensors)."""

    @staticmethod
    def forward(ctx, qt, kt, vt):
        from controlnet_tpu_torch.ops import cuda_attention

        ctx.save_for_backward(qt, kt, vt)
        return cuda_attention.fused_attention_t_plain(qt, kt, vt)

    @staticmethod
    def backward(ctx, dout):
        from controlnet_tpu_torch.ops import cuda_attention

        return cuda_attention.fused_attention_t_bwd_plain(*ctx.saved_tensors, dout)


@contextlib.contextmanager
def plain_attention():
    """Route the attention of this process, and its gradient, through the
    plain versions (the comparison model of phases 2, 4 and 7); the port
    itself has no such switch."""
    from controlnet_tpu_torch.ops import cuda_attention

    def plain(qt, kt, vt):
        if torch.is_grad_enabled() and (qt.requires_grad or kt.requires_grad or vt.requires_grad):
            return _PlainAttention.apply(qt, kt, vt)
        return cuda_attention.fused_attention_t_plain(qt, kt, vt)

    orig = cuda_attention.fused_attention_t
    cuda_attention.fused_attention_t = plain
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


@contextlib.contextmanager
def plain_attention_proj():
    """Route the fused projection + attention layer of this process through
    its plain version (the comparison model of phases 14 and 16); the port
    itself has no such switch."""
    from controlnet_tpu_torch.ops import cuda_attention_proj

    orig = cuda_attention_proj.fused_attention_proj
    cuda_attention_proj.fused_attention_proj = cuda_attention_proj.fused_attention_proj_plain
    try:
        yield
    finally:
        cuda_attention_proj.fused_attention_proj = orig


@contextlib.contextmanager
def record_proj_shapes(into: list):
    """Record (L, C, heads, channel-major?) of every fused-layer call."""
    from controlnet_tpu_torch.ops import cuda_attention_proj

    orig = cuda_attention_proj.fused_attention_proj

    def rec(x, in_w, in_b, out_w, out_b, heads):
        into.append((x.shape[1], x.shape[2], heads, x.stride(1) == 1))
        return orig(x, in_w, in_b, out_w, out_b, heads)

    cuda_attention_proj.fused_attention_proj = rec
    try:
        yield
    finally:
        cuda_attention_proj.fused_attention_proj = orig


# (label, parts of the kernel's mangled name ("!part": a part it must not
# have), whether its template type is bf16: True / False / None for either)
# -> cuobjdump's functions of the kernel.
# Every "bf16" label must have HMMA in each instantiation, no "f32" one any.
SASS_KERNELS = (
    ("a bf16 (attention_fwd_bf16.cu)", ("attention_fwd_bf16_kernel",), None),
    ("a f32 (attention_fwd.cu)", ("attention_fwd_t_kernel",), None),
    ("b bf16 (attention_bwd_bf16.cu)", ("attention_bwd_", "_bf16_kernel"), None),
    ("b f32 (attention_bwd.cu)", ("attention_bwd_", "!_bf16_kernel"), None),
    ("c bf16 (conv3x3_tl_bf16.cu)", ("conv3x3_tl_bf16_kernel",), None),
    ("c f32 (conv3x3_tl.cu)", ("conv3x3_tl_kernel",), None),
    ("d bf16 (attention_proj.cuh)", ("attention_proj_kernel",), True),
    ("d f32 (attention_proj.cuh)", ("attention_proj_kernel",), False),
)


def phase_sass(lib_path: str, nvcc: str) -> dict:
    """HMMA instructions per kernel in the built library's SASS: every bf16
    instantiation of kernels a, b, c and d runs its products on the tensor
    cores, and no float32 instantiation does."""
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    funcs: dict = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name] = 0
        elif name is not None and "HMMA" in line:
            funcs[name] += 1
    counts = {}
    for label, parts, bf16 in SASS_KERNELS:
        mine = [n for n in funcs if all((p[1:] not in n) if p[0] == "!" else (p in n)
                                        for p in parts)
                and (bf16 is None or ("__nv_bfloat16" in n) == bf16)]
        hmma = [funcs[n] for n in mine]
        counts[label] = dict(instantiations=len(mine), hmma=sum(hmma),
                             min_hmma=min(hmma) if hmma else 0)
        log(f"SASS {label}: {len(mine)} instantiations, HMMA {sum(hmma)} in all, "
            f"{min(hmma) if hmma else 0} in the fewest")
    for label, c in counts.items():
        if c["instantiations"] == 0:
            raise SystemExit(f"kernel {label}: missing from the library")
        if " bf16 " in label and c["min_hmma"] == 0:
            raise SystemExit(f"kernel {label}: no tensor-core instructions in its SASS")
        if " f32 " in label and c["hmma"] != 0:
            raise SystemExit(f"kernel {label}: tensor-core instructions in float32")
    return counts


def cuda_time_ms(fn, min_ms: float = 30.0) -> float:
    """Mean milliseconds per call, CUDA events around a run of calls: the
    yardstick of earlier runs, kept beside ``device_time_ms`` for comparison.
    Where issuing a call on the host takes longer than its device work, it
    reads host time."""
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


def device_events(prof) -> list:
    """The device activity of a profiler window (kernels, copies, fills),
    without the ranges that annotate it (the optimizer's "Optimizer.step#
    Adam.step" spans its own kernels)."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _device_ms(evt) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name)) / 1e3
    return 0.0


# device_time_ms's windows, and the device records in them launched elsewhere
PROFILER_WINDOWS = {"measurements": 0, "windows": 0, "foreign": 0}


def device_time_ms(fn, calls: int = 5, tries: int = 8) -> tuple[float, dict]:
    """Device time per call: after a warm-up, a torch.profiler window (CPU +
    CUDA) over ``calls`` calls; the device time of all the GPU work those
    calls launched (the wrappers' casts and copies included), summed and
    divided by ``calls``.  Returns (ms, {kernel name: ms per call}).

    Only device records whose launch (a `cuda*` or `cu*` API call, matched
    by correlation id) lies in the window count: a process that has launched
    millions of kernels since its first window was seen to report an old
    window's records in every later one (why the timing phases run in fresh
    processes).  Even a fresh process now and then loses some of a window's
    records, so a window counts only when another window of the same calls
    kept as many, a nonzero multiple of ``calls``.  No agreement in ``tries`` windows fails the run: there is no
    fallback to events."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    counts = []
    PROFILER_WINDOWS["measurements"] += 1
    for _ in range(tries):
        PROFILER_WINDOWS["windows"] += 1
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        launched = {e.id for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("cu")}
        everything = device_events(prof)
        events = [e for e in everything if e.id in launched]
        if len(events) != len(everything):
            PROFILER_WINDOWS["foreign"] += len(everything) - len(events)
        if events and len(events) % calls == 0 and len(events) in counts:
            names: dict = {}
            for e in events:
                names[e.name] = names.get(e.name, 0.0) + _device_ms(e) / calls
            return sum(names.values()), names
        counts.append(len(events))
        last = collections.Counter(e.name[:48] for e in everything).most_common(6)
    raise SystemExit(f"the profiler recorded no consistent device time (device records per "
                     f"window: {counts}; the last window's, launched there or not: {last})")


def time_calls(**fns) -> dict:
    """For each named call: ``device_time_ms`` under its name, the kernel
    names of its window under ``<name>_names`` and the CUDA-event time under
    ``<name>_events``."""
    out = {}
    for key, fn in fns.items():
        out[key], out[f"{key}_names"] = device_time_ms(fn)
        out[f"{key}_events"] = cuda_time_ms(fn)
    return out


def own_ms(names: dict, *keys: str) -> float:
    """Device time of the kernels whose names hold one of ``keys``."""
    return sum(v for k, v in names.items() if any(key in k for key in keys))


def sdpa_backend(names: dict) -> str:
    """Which scaled_dot_product_attention backend ran, from its kernel names."""
    joined = " ".join(names).lower()
    for backend, marks in (("cudnn", ("cudnn",)), ("flash", ("flash",)),
                           ("efficient", ("fmha", "memeff", "mem_eff"))):
        if any(m in joined for m in marks):
            return backend
    return "math"


def attention_bound_ms(bh: int, lq: int, lk: int, dh: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time for one call: each input read once and the output written
    once at the HBM rate, or the two products (4*Lq*Lk*dh flops per slice)
    at the card's peak for the input type, whichever is larger."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = itemsize * bh * dh * (2 * lq + 2 * lk)
    flops = 4.0 * bh * lq * lk * dh
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def attention_bwd_bound_ms(bh: int, lq: int, lk: int, dh: int,
                           dtype: torch.dtype) -> tuple[float, str]:
    """Least time for one backward call: q, k, v and dO read once and dq,
    dk, dv written once at the HBM rate, or the five products the JAX cost
    estimate counts (10*Lq*Lk*dh flops per slice) at the card's peak for the
    input type, whichever is larger."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = itemsize * bh * dh * (3 * lq + 4 * lk)
    flops = 10.0 * bh * lq * lk * dh
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def proj_bound_ms(b: int, l: int, c: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time for one fused layer call (D = C): x, the weights and the
    biases read once and y written once at the HBM rate, or the layer's
    (8*L*C^2 + 4*L^2*C)*B flops, each projection counted once, at the card's
    peak for the input type, whichever is larger."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = itemsize * (2 * b * l * c + 4 * c * c + 4 * c)
    flops = (8.0 * l * c * c + 4.0 * l * l * c) * b
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def conv_bound_ms(cin: int, cout: int, b: int, l: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time for one 3x3 TL conv call: the input, the weights and the
    bias read once and the output written once at the HBM rate, or
    2*9*Cin*Cout*B*L flops at the card's peak for the input type, whichever
    is larger."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = itemsize * ((cin + cout) * b * l + 9 * cin * cout) + 4 * cout
    flops = 2.0 * 9 * cin * cout * b * l
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


@contextlib.contextmanager
def record_conv_shapes(into: list):
    """Record (Cin, Cout, H, W, B) of every 3x3 TL conv the hint encoder asks for."""
    from controlnet_tpu_torch.ops import tl_conv

    orig = tl_conv.conv3x3_tl

    def rec(weight, bias, x, hw):
        into.append((x.shape[0], weight.shape[0], int(hw[0]), int(hw[1]), x.shape[1]))
        return orig(weight, bias, x, hw)

    tl_conv.conv3x3_tl = rec
    try:
        yield
    finally:
        tl_conv.conv3x3_tl = orig


RAGGED_CONV_SHAPE = (24, 40, 30, 30, LDM_BATCH)  # (Cin, Cout, H, W, B): every edge masked


def phase_conv_kernels(shapes: list, device) -> dict:
    """Kernel c against its plain version at every shape of the hint encode
    and RAGGED_CONV_SHAPE (inputs as (C, B, L) views of NCHW tensors, as the
    encoder passes them), f32 and bf16; device times of the kernel (and of
    its own launch, without the wrapper's weight cast), the plain version
    and ``F.conv2d`` on the contiguous NCHW tensor (the library yardstick,
    which the port never calls for these convs).  The per-encode totals sum
    ``shapes`` only."""
    import torch.nn.functional as F

    from controlnet_tpu_torch.ops import cuda_conv

    totals = {}
    for dtype in (torch.float32, torch.bfloat16):
        tot = dict(ms=0.0, own_ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, flops=0.0,
                   ms_events=0.0, plain_ms_events=0.0, library_ms_events=0.0,
                   ops_ms=0.0, bytes_ms=0.0, max_abs_err=0.0, max_rel_err=0.0)
        for cin, cout, h, w, b in list(shapes) + [RAGGED_CONV_SHAPE]:
            on_path = (cin, cout, h, w, b) != RAGGED_CONV_SHAPE
            g = torch.Generator(device=device).manual_seed(SEED)
            img = torch.randn((b, cin, h, w), generator=g, device=device).to(dtype)
            bound = 1.0 / (9 * cin) ** 0.5
            weight = (torch.rand((cout, cin, 3, 3), generator=g, device=device) * 2 - 1) * bound
            bias = (torch.rand((cout,), generator=g, device=device) * 2 - 1) * bound
            x = cuda_conv.to_tl(img)
            with torch.inference_mode():
                out = cuda_conv.conv3x3_tl(weight, bias, x, (h, w))
                ref = cuda_conv.conv3x3_tl_plain(weight, bias, x, (h, w))
                torch.cuda.synchronize()
                scale = ref.float().abs().max().item()
                err = (out.float() - ref.float()).abs().max().item()
                del ref
                ok = (err <= CONV_TOL[dtype] * scale and bool(torch.isfinite(out).all())
                      and out.shape == (cout, b, h * w) and out.is_contiguous())
                del out
                wd, bd = weight.to(dtype), bias.to(dtype)
                t = time_calls(
                    ms=lambda: cuda_conv.conv3x3_tl(weight, bias, x, (h, w)),
                    plain_ms=lambda: cuda_conv.conv3x3_tl_plain(weight, bias, x, (h, w)),
                    library_ms=lambda: F.conv2d(img, wd, bd, stride=1, padding=1))
            own = own_ms(t["ms_names"], "conv3x3_tl_kernel", "conv3x3_tl_bf16_kernel")
            bound_ms, bound_by = conv_bound_ms(cin, cout, b, h * w, dtype)
            flops = 2.0 * 9 * cin * cout * b * h * w
            log(f"conv3x3_tl {str(dtype)[6:]:8s} {cin:3d}->{cout:3d} @{h}x{w} B {b}: "
                f"err {err:.3g} (tol {CONV_TOL[dtype]:g} x max|out| {scale:.3g}) "
                f"{'ok' if ok else 'FAIL'} | device: kernel {t['ms']:.4f} ms, its own launch "
                f"{own:.4f} ms ({flops / own / 1e9:.2f} TFLOP/s, {bound_ms / own:.3f} of the "
                f"bound), plain {t['plain_ms']:.4f} ms, F.conv2d {t['library_ms']:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}) | events: kernel {t['ms_events']:.4f}, plain "
                f"{t['plain_ms_events']:.4f}, F.conv2d {t['library_ms_events']:.4f} ms"
                f"{'' if on_path else ' | ragged, off the main path'}")
            if not ok:
                raise SystemExit("conv kernel disagrees with its plain version")
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["max_rel_err"] = max(tot["max_rel_err"], err / scale)
            del img, x
            if not on_path:
                continue
            for key in ("ms", "plain_ms", "library_ms", "ms_events", "plain_ms_events",
                        "library_ms_events"):
                tot[key] += t[key]
            tot["own_ms"] += own
            tot["bound_ms"] += bound_ms
            tot["flops"] += flops
            tot["ops_ms"] += bound_ms if bound_by == "operations" else 0.0
            tot["bytes_ms"] += bound_ms if bound_by == "bytes" else 0.0
        tot["bound_by"] = "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes"
        totals[dtype] = tot
        log(f"conv3x3_tl {str(dtype)[6:]} per hint encode ({len(shapes)} calls), device: "
            f"kernel {tot['ms']:.4f} ms (own launches {tot['own_ms']:.4f}), plain "
            f"{tot['plain_ms']:.4f} ms, F.conv2d {tot['library_ms']:.4f} ms, bound "
            f"{tot['bound_ms']:.4f} ms ({tot['bound_by']}), {tot['flops'] / 1e9:.2f} GFLOP | "
            f"events: kernel {tot['ms_events']:.4f}, plain {tot['plain_ms_events']:.4f}, "
            f"F.conv2d {tot['library_ms_events']:.4f} ms")
    return totals


def hint_conv_shapes(hint_size: int, hint_channels: int, c0: int, factor: int,
                     batch: int) -> list:
    """(Cin, Cout, H, W, B) of the stride-1 3x3 convs of the dynamic hint
    encoder, in call order (what ``record_conv_shapes`` sees on a real encode)."""
    shapes = [(hint_channels, 16, hint_size, hint_size, batch)]
    base, size = 16, hint_size
    while factor > 1:
        base, size, factor = base * 2, size // 2, factor // 2
        shapes.append((base, base, size, size, batch))
    return shapes + [(base, c0, size, size, batch)]


def mnist_config() -> dict:
    from controlnet_tpu_torch import config as cfg

    return cfg.load_config(os.path.join(REPO, "config", "mnist.yaml"))


def randomize_zero_convs(cn) -> None:
    """Make every zero conv nonzero (normal, std 0.05, from the global torch
    seed) so the control branch contributes, and takes gradient, from the
    first step."""
    with torch.no_grad():
        for conv in cn.zero_convs():
            conv.weight.normal_(0.0, 0.05)
            conv.bias.normal_(0.0, 0.05)


def write_seeded_checkpoint(config: dict, path: str) -> None:
    """A reference-format .pth of random weights from SEED, with every zero
    conv nonzero so the control branch contributes."""
    from controlnet_tpu_torch.models.controlnet import ControlNet

    torch.manual_seed(SEED)
    mp = config["model_params"]
    cn = ControlNet(mp["im_channels"], mp)
    randomize_zero_convs(cn)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(cn.state_dict(), path)


def seeded_unet_state_dict(config: dict) -> dict:
    """The base UNet's state dict, random weights from SEED (what a
    reference-format ddpm .pth holds)."""
    from controlnet_tpu_torch.models.unet import UNet

    torch.manual_seed(SEED)
    mp = config["model_params"]
    return UNet(mp["im_channels"], mp).state_dict()


def seeded_digits(n: int, size: int = 28):
    """uint8 (N, H, W) digit-like images from SEED: a bright anti-aliased
    ring arc and a bar, 1-2.5 px thick, on black, which canny turns into
    closed edge maps as it does MNIST digits."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[:size, :size].astype(np.float32)
    out = np.zeros((n, size, size), np.float32)
    for im in out:
        cy, cx = rng.uniform(0.35 * size, 0.65 * size, 2)
        r, w = rng.uniform(0.15 * size, 0.3 * size), rng.uniform(1.0, 2.5)
        ring = np.clip(w + 0.5 - np.abs(np.hypot(yy - cy, xx - cx) - r), 0.0, 1.0)
        ring *= (np.arctan2(yy - cy, xx - cx) < rng.uniform(0.0, np.pi))  # an arc
        ang = rng.uniform(0.0, np.pi)
        y0, x0 = rng.uniform(0.25 * size, 0.75 * size, 2)
        across = np.abs((xx - x0) * np.sin(ang) - (yy - y0) * np.cos(ang))
        along = np.abs((xx - x0) * np.cos(ang) + (yy - y0) * np.sin(ang))
        bar = np.clip(w + 0.5 - across, 0.0, 1.0) * (along < rng.uniform(0.15, 0.35) * size)
        im[:] = np.maximum(ring, bar) * rng.uniform(180, 255)
    return out.round().astype(np.uint8)


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


def phase_kernels(shapes: list, device, batch: int = BATCH, cross: bool = True) -> dict:
    """Kernel vs plain at every main-path shape (and, with ``cross``, one
    cross-attention shape), f32 and bf16; device times, and the SDPA backend."""
    import torch.nn.functional as F

    from controlnet_tpu_torch.ops import cuda_attention

    mix = collections.Counter(shapes)
    cases = sorted(mix, key=lambda s: (-s[0], -s[2]))
    if cross:
        cases.append((*CROSS_SHAPE, batch * 4))
    totals = {}
    for dtype in (torch.float32, torch.bfloat16):
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, flops=0.0,
                   ms_events=0.0, plain_ms_events=0.0, library_ms_events=0.0,
                   ops_ms=0.0, bytes_ms=0.0, max_abs_err=0.0, sdpa_backends=set())
        for lq, lk, dh, bh in cases:
            g = torch.Generator(device=device).manual_seed(SEED)
            q = torch.randn((batch, bh // batch, dh, lq), generator=g, device=device).to(dtype)
            k = torch.randn((batch, bh // batch, dh, lk), generator=g, device=device).to(dtype)
            v = torch.randn((batch, bh // batch, dh, lk), generator=g, device=device).to(dtype)
            with torch.inference_mode():
                out = cuda_attention.fused_attention_t(q, k, v)
                ref = cuda_attention.fused_attention_t_plain(q, k, v)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                ok = err <= KERNEL_TOL[dtype] and bool(torch.isfinite(out).all())
                qh, kh, vh = (a.transpose(-1, -2).contiguous() for a in (q, k, v))
                t = time_calls(
                    ms=lambda: cuda_attention.fused_attention_t(q, k, v),
                    plain_ms=lambda: cuda_attention.fused_attention_t_plain(q, k, v),
                    library_ms=lambda: F.scaled_dot_product_attention(qh, kh, vh))
            backend = sdpa_backend(t["library_ms_names"])
            bound_ms, bound_by = attention_bound_ms(bh, lq, lk, dh, dtype)
            n = mix.get((lq, lk, dh, bh), 0)
            where = f"x{n} per forward" if n else "cross-attention, off the main path"
            log(f"attention {str(dtype)[6:]:8s} Lq {lq:4d} Lk {lk:4d} dh {dh:2d} BH {bh}: "
                f"err {err:.3g} (tol {KERNEL_TOL[dtype]:g}) {'ok' if ok else 'FAIL'} | device: "
                f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, sdpa ({backend}) "
                f"{t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) | events: kernel "
                f"{t['ms_events']:.4f}, plain {t['plain_ms_events']:.4f}, sdpa "
                f"{t['library_ms_events']:.4f} ms | {where}")
            if not ok:
                raise SystemExit("attention kernel disagrees with its plain version")
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["sdpa_backends"].add(backend)
            for key in ("ms", "plain_ms", "library_ms", "ms_events", "plain_ms_events",
                        "library_ms_events"):
                tot[key] += n * t[key]
            tot["bound_ms"] += n * bound_ms
            tot["ops_ms"] += n * (bound_ms if bound_by == "operations" else 0.0)
            tot["bytes_ms"] += n * (bound_ms if bound_by == "bytes" else 0.0)
            tot["flops"] += n * 4.0 * bh * lq * lk * dh
        tot["bound_by"] = "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes"
        tot["sdpa_backends"] = sorted(tot["sdpa_backends"])
        totals[dtype] = tot
        log(f"attention {str(dtype)[6:]} per forward ({sum(mix.values())} calls), device: "
            f"kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, sdpa "
            f"({'/'.join(tot['sdpa_backends'])}) {tot['library_ms']:.4f} ms, bound "
            f"{tot['bound_ms']:.4f} ms ({tot['bound_by']}), {tot['flops'] / 1e9:.2f} GFLOP | "
            f"events: kernel {tot['ms_events']:.4f}, plain {tot['plain_ms_events']:.4f}, sdpa "
            f"{tot['library_ms_events']:.4f} ms")
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


def train_setup(config: dict, base: dict, device, dtype_name: str):
    """The trainer tool's ControlNet, train state and step at ``dtype_name``
    compute, trunks from ``base``, zero convs made nonzero from SEED."""
    from controlnet_tpu_torch.tools import train_ddpm_controlnet as tool

    cfg = copy.deepcopy(config)
    cfg["train_params"]["compute_dtype"] = dtype_name
    cn, state, step = tool.make_trainer(cfg, base, device, seed=SEED)
    randomize_zero_convs(cn)
    return cn, state, step


def train_batches(images: torch.Tensor, steps: int, epoch: int = 0):
    """``steps`` batches of the trainer's shuffled order, with their canny
    hints made on the card as the trainer tool makes them."""
    from controlnet_tpu_torch.data.datasets import batch_indices
    from controlnet_tpu_torch.tools.train_ddpm_controlnet import device_hints

    done = 0
    while done < steps:
        for idx in batch_indices(len(images), BATCH, shuffle=True, seed=epoch):
            if done == steps:
                return
            batch = images[torch.from_numpy(idx).to(images.device)]
            yield batch, device_hints(batch)
            done += 1
        epoch += 1


@contextlib.contextmanager
def record_bwd_shapes(into: list):
    from controlnet_tpu_torch.ops import cuda_attention

    orig = cuda_attention._launch_bwd

    def rec(qt, kt, vt, out, lse, dout):
        into.append((qt.shape[3], kt.shape[3], qt.shape[2], qt.shape[0] * qt.shape[1]))
        return orig(qt, kt, vt, out, lse, dout)

    cuda_attention._launch_bwd = rec
    try:
        yield
    finally:
        cuda_attention._launch_bwd = orig


def phase_train_shapes(config: dict, base: dict, images: torch.Tensor, device) -> list:
    """One full-width training step; returns the backward attention shapes."""
    from controlnet_tpu_torch.ops import cuda_attention

    _, state, step = train_setup(config, base, device, "float32")
    shapes: list = []
    g = torch.Generator(device=device).manual_seed(SEED)
    batch, hints = next(train_batches(images, 1))
    before = cuda_attention.launches, cuda_attention.bwd_launches
    with record_bwd_shapes(shapes):
        loss = step(state, batch, hints, g)
    torch.cuda.synchronize()
    fwd = cuda_attention.launches - before[0]
    bwd = cuda_attention.bwd_launches - before[1]
    ok = fwd == 26 and bwd == 18 and len(shapes) == 18 and bool(torch.isfinite(loss))
    log(f"training step, batch {BATCH}: attention launches forward {fwd} (expect 26), "
        f"backward {bwd} (expect 18), loss {loss.item():.4f} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("full-width training step failed")
    return shapes


def phase_kernels_bwd(shapes: list, device) -> dict:
    """Kernel b (and kernel a's lse) against the plain versions at every
    training shape (q, k, v as slices of one packed projection, as the model
    passes them) and the cross shape, f32 and bf16; b's row term D against
    rowsum(dP o P) from float32 P, beside rowsum(dO o O) over the output (how
    it was formed before); device times, and the SDPA backend."""
    import torch.nn.functional as F

    from controlnet_tpu_torch.ops import cuda_attention

    mix = collections.Counter(shapes)
    cases = sorted(mix, key=lambda s: (-s[0], -s[2])) + [(*CROSS_SHAPE, BATCH * 4)]
    totals = {}
    for dtype in (torch.float32, torch.bfloat16):
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, flops=0.0,
                   ms_events=0.0, plain_ms_events=0.0, library_ms_events=0.0,
                   ops_ms=0.0, bytes_ms=0.0, max_abs_err=0.0, max_rel_err=0.0, lse_err=0.0,
                   d_err=0.0, d_err_from_o=0.0, sdpa_backends=set())
        for lq, lk, dh, bh in cases:
            heads = bh // BATCH
            g = torch.Generator(device=device).manual_seed(SEED)
            if lq == lk:
                packed = torch.randn((BATCH, 3 * heads * dh, lq), generator=g,
                                     device=device).to(dtype)
                q, k, v = (packed[:, i * heads * dh:(i + 1) * heads * dh]
                           .reshape(BATCH, heads, dh, lq) for i in range(3))
            else:
                q = torch.randn((BATCH, heads, dh, lq), generator=g, device=device).to(dtype)
                k = torch.randn((BATCH, heads, dh, lk), generator=g, device=device).to(dtype)
                v = torch.randn((BATCH, heads, dh, lk), generator=g, device=device).to(dtype)
            dout = torch.randn((BATCH, heads, dh, lq), generator=g, device=device).to(dtype)
            lse = torch.empty((BATCH, heads, lq), dtype=torch.float32, device=device)
            delta = torch.empty((BATCH, heads, lq), dtype=torch.float32, device=device)
            out = cuda_attention._launch(q, k, v, lse)
            scores = torch.einsum("bhdq,bhdk->bhqk", q.float(), k.float()) / dh ** 0.5
            lse_err = (lse - torch.logsumexp(scores, dim=-1)).abs().max().item()
            got = cuda_attention._launch_bwd(q, k, v, out, lse, dout, delta)
            ref = cuda_attention.fused_attention_t_bwd_plain(q, k, v, dout)
            # D as the TPU kernel forms it, and as rowsum(dO o O) over the output
            probs = torch.softmax(scores, dim=-1)
            del scores
            d_ref = (torch.einsum("bhdq,bhdk->bhqk", dout.float(), v.float()) * probs).sum(-1)
            del probs
            d_max = d_ref.abs().max().item()
            d_err = (delta - d_ref).abs().max().item() / d_max
            d_err_o = ((dout.float() * out.float()).sum(2) - d_ref).abs().max().item() / d_max
            del d_ref
            torch.cuda.synchronize()
            abs_err = max((a.float() - r.float()).abs().max().item() for a, r in zip(got, ref))
            rel_err = max(((a.float() - r.float()).abs().max() / r.float().abs().max()).item()
                          for a, r in zip(got, ref))
            ok = (rel_err <= BWD_KERNEL_TOL[dtype] and lse_err <= LSE_TOL
                  and all(bool(torch.isfinite(a).all()) for a in got))
            qh, kh, vh = (a.transpose(-1, -2).contiguous().requires_grad_() for a in (q, k, v))
            sdpa = F.scaled_dot_product_attention(qh, kh, vh)
            gh = dout.transpose(-1, -2).contiguous()
            t = time_calls(
                ms=lambda: cuda_attention._launch_bwd(q, k, v, out, lse, dout),
                plain_ms=lambda: cuda_attention.fused_attention_t_bwd_plain(q, k, v, dout),
                library_ms=lambda: torch.autograd.grad(sdpa, (qh, kh, vh), gh,
                                                       retain_graph=True))
            del sdpa
            backend = sdpa_backend(t["library_ms_names"])
            bound_ms, bound_by = attention_bwd_bound_ms(bh, lq, lk, dh, dtype)
            n = mix.get((lq, lk, dh, bh), 0)
            where = f"x{n} per step" if n else "cross-attention, off the main path"
            log(f"attention bwd {str(dtype)[6:]:8s} Lq {lq:4d} Lk {lk:4d} dh {dh:2d} BH {bh}: "
                f"rel err {rel_err:.3g} (tol {BWD_KERNEL_TOL[dtype]:g}), abs {abs_err:.3g}, "
                f"lse err {lse_err:.3g} (tol {LSE_TOL:g}), D err {d_err:.3g} of max|D| "
                f"(rowsum(dO o O) {d_err_o:.3g}) {'ok' if ok else 'FAIL'} | device: kernel "
                f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, sdpa bwd ({backend}) "
                f"{t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) | events: "
                f"kernel {t['ms_events']:.4f}, plain {t['plain_ms_events']:.4f}, sdpa bwd "
                f"{t['library_ms_events']:.4f} ms | {where}")
            if not ok:
                raise SystemExit("attention backward kernel disagrees with its plain version")
            tot["max_abs_err"] = max(tot["max_abs_err"], abs_err)
            tot["max_rel_err"] = max(tot["max_rel_err"], rel_err)
            tot["lse_err"] = max(tot["lse_err"], lse_err)
            tot["d_err"] = max(tot["d_err"], d_err)
            tot["d_err_from_o"] = max(tot["d_err_from_o"], d_err_o)
            tot["sdpa_backends"].add(backend)
            for key in ("ms", "plain_ms", "library_ms", "ms_events", "plain_ms_events",
                        "library_ms_events"):
                tot[key] += n * t[key]
            tot["bound_ms"] += n * bound_ms
            tot["ops_ms"] += n * (bound_ms if bound_by == "operations" else 0.0)
            tot["bytes_ms"] += n * (bound_ms if bound_by == "bytes" else 0.0)
            tot["flops"] += n * 10.0 * bh * lq * lk * dh
        tot["bound_by"] = "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes"
        tot["sdpa_backends"] = sorted(tot["sdpa_backends"])
        totals[dtype] = tot
        log(f"attention bwd {str(dtype)[6:]} per training step ({sum(mix.values())} calls), "
            f"device: kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, sdpa bwd "
            f"({'/'.join(tot['sdpa_backends'])}) {tot['library_ms']:.4f} ms, bound "
            f"{tot['bound_ms']:.4f} ms ({tot['bound_by']}), {tot['flops'] / 1e9:.2f} GFLOP; "
            f"D err {tot['d_err']:.3g} of max|D| (rowsum(dO o O) {tot['d_err_from_o']:.3g}), "
            f"grad rel err {tot['max_rel_err']:.3g} | events: kernel {tot['ms_events']:.4f}, "
            f"plain {tot['plain_ms_events']:.4f}, sdpa bwd {tot['library_ms_events']:.4f} ms")
    return totals


def _check_steps(config, base, images, device, dtype_name: str, plain: bool):
    """CHECK_STEPS training steps from one start and one generator; returns
    (losses, first-step grads, params before, params after, noise-floor mask)."""
    cn, state, step = train_setup(config, base, device, dtype_name)
    before = {k: p.detach().clone() for k, p in state.params.items()}
    g = torch.Generator(device=device).manual_seed(SEED)
    losses, grads, noisy = [], None, {}
    with plain_attention() if plain else contextlib.nullcontext():
        for batch, hints in train_batches(images, CHECK_STEPS):
            losses.append(step(state, batch, hints, g))
            for k, p in state.params.items():
                low = p.grad.abs() < NOISE_FLOOR
                noisy[k] = low if k not in noisy else noisy[k] | low
            if grads is None:
                grads = {k: p.grad.detach().clone() for k, p in state.params.items()}
    after = {k: p.detach().clone() for k, p in state.params.items()}
    return torch.stack(losses).float().cpu(), grads, before, after, noisy


def phase_train_parity(config: dict, base: dict, images: torch.Tensor, device,
                       dtype: torch.dtype) -> dict:
    """CHECK_STEPS steps through kernels a and b against the same steps with
    the plain attention forward and backward.  Tolerances: losses and the
    first step's gradients MODEL_TOL (relative); after three Adam steps the
    weights whose gradients stayed above the noise floor within 1e-2 * lr
    (f32), or, in bf16, whose rounding flips small gradients' signs, a mean
    |difference| under 0.15 lr and a cosine of the two updates over 0.97."""
    name = str(dtype)[6:]
    lk, gk, before, ak, nk = _check_steps(config, base, images, device, name, plain=False)
    lp, gp, _, ap, npl = _check_steps(config, base, images, device, name, plain=True)
    lr = config["train_params"]["controlnet_lr"]
    loss_err = ((lk - lp).abs().max() / lp.abs().max().clamp(min=1.0)).item()
    gmax = max(g.abs().max().item() for g in gp.values())
    grad_err = max((gk[k] - gp[k]).abs().max().item() for k in gp) / gmax
    clean, allw, upd_k, upd_p = [], [], [], []
    for k in before:
        d = (ak[k] - ap[k]).abs()
        keep = ~(nk[k] | npl[k])
        clean.append(d[keep].flatten())
        allw.append(d.flatten())
        upd_k.append((ak[k] - before[k]).flatten())
        upd_p.append((ap[k] - before[k]).flatten())
    clean, allw, upd_k, upd_p = (torch.cat(x).double() for x in (clean, allw, upd_k, upd_p))
    cos = (upd_k @ upd_p / (upd_k.norm() * upd_p.norm())).item()
    clean_max = clean.max().item() / lr
    mean_diff = allw.mean().item() / lr
    ok = (bool(torch.isfinite(lk).all()) and loss_err <= MODEL_TOL[dtype]
          and grad_err <= MODEL_TOL[dtype]
          and (mean_diff < 0.15 and cos > 0.97 if dtype == torch.bfloat16 else clean_max < 1e-2))
    log(f"training {name}, {CHECK_STEPS} steps kernels vs plain attention: losses "
        f"{[round(x, 5) for x in lk.tolist()]} vs {[round(x, 5) for x in lp.tolist()]} "
        f"(rel err {loss_err:.3g}), first-step grads rel err {grad_err:.3g} "
        f"(tol {MODEL_TOL[dtype]:g}); weights after: max |diff| {clean_max:.3g} lr over the "
        f"{clean.numel() / allw.numel():.3f} whose gradients stayed above {NOISE_FLOOR:g}, "
        f"mean {mean_diff:.3g} lr over all, update cosine {cos:.6f} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"training ({name}) through the kernels disagrees with plain attention")
    return dict(loss_err=loss_err, grad_err=grad_err, clean_max_lr=clean_max,
                mean_diff_lr=mean_diff, cos=cos)


def is_kernel_a(name: str) -> bool:
    """A profiler kernel name of kernel a: its float32 or its bf16 kernel."""
    return "attention_fwd_t_kernel" in name or "attention_fwd_bf16_kernel" in name


def phase_train_main_path(config: dict, base: dict, images: torch.Tensor, device) -> dict:
    """The training main path: the trainer tool's step at batch 64, full
    width, hints from the port's canny on the card, f32 and bf16.  Counters
    set to 0 just before the timed run and read just after; then a short
    torch.profiler window for device time and busy share."""
    from torch.profiler import ProfilerActivity, profile

    from controlnet_tpu_torch.ops import cuda_attention

    results = {}
    for name in ("float32", "bfloat16"):
        cn, state, step = train_setup(config, base, device, name)
        trainable, frozen = cn.split_params()
        t_before = {k: p.detach().clone() for k, p in trainable.items()}
        f_before = {k: p.detach().clone() for k, p in frozen.items()}
        g = torch.Generator(device=device).manual_seed(SEED)
        for batch, hints in train_batches(images, TRAIN_WARMUP, epoch=100):
            step(state, batch, hints, g)
        data = list(train_batches(images, TRAIN_STEPS + PROFILE_STEPS))
        torch.cuda.synchronize()
        cuda_attention.launches = 0
        cuda_attention.bwd_launches = 0
        start = time.perf_counter()
        losses = [step(state, batch, hints, g) for batch, hints in data[:TRAIN_STEPS]]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        fwd, bwd = cuda_attention.launches, cuda_attention.bwd_launches
        losses = torch.stack(losses).float()

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for batch, hints in data[TRAIN_STEPS:]:
                step(state, batch, hints, g)
            torch.cuda.synchronize()
        kernels = device_events(prof)
        dev_ms = sum(_device_ms(e) for e in kernels) / PROFILE_STEPS
        fwd_ms = sum(_device_ms(e) for e in kernels if is_kernel_a(e.name))
        bwd_ms = sum(_device_ms(e) for e in kernels if "attention_bwd_" in e.name)

        moved = all(not torch.equal(p.detach(), t_before[k]) for k, p in trainable.items())
        still = all(torch.equal(p.detach(), f_before[k]) for k, p in frozen.items())
        ms_step = seconds * 1e3 / TRAIN_STEPS
        ok = (fwd == 26 * TRAIN_STEPS and bwd == 18 * TRAIN_STEPS
              and bool(torch.isfinite(losses).all()) and moved and still)
        results[name] = dict(seconds=seconds, launches=fwd, bwd_launches=bwd,
                             ms_per_step=ms_step, steps_per_s=TRAIN_STEPS / seconds,
                             device_ms_per_step=dev_ms, busy=dev_ms / ms_step,
                             kernels_per_step=len(kernels) / PROFILE_STEPS,
                             attn_fwd_device_ms=fwd_ms / PROFILE_STEPS,
                             attn_bwd_device_ms=bwd_ms / PROFILE_STEPS)
        log(f"training main path {name}: {TRAIN_STEPS} steps, batch {BATCH}: {seconds:.3f} s, "
            f"{ms_step:.3f} ms/step, {TRAIN_STEPS / seconds:.3f} steps/s, attention launches "
            f"forward {fwd} (expect {26 * TRAIN_STEPS}), backward {bwd} "
            f"(expect {18 * TRAIN_STEPS}), loss {losses[0].item():.4f} -> "
            f"{losses[-1].item():.4f}, trainable moved {moved}, frozen unchanged {still} | "
            f"profile ({PROFILE_STEPS} steps): device {dev_ms:.3f} ms/step, busy "
            f"{dev_ms / ms_step:.3f}, {len(kernels) / PROFILE_STEPS:.1f} kernels/step, "
            f"kernel a {fwd_ms / PROFILE_STEPS:.3f} ms/step, kernel b "
            f"{bwd_ms / PROFILE_STEPS:.3f} ms/step -> {'ok' if ok else 'FAIL'}")
        by_name: dict = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + _device_ms(e) / PROFILE_STEPS
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        log(f"training {name} top device kernels (ms/step): "
            + "; ".join(f"{k.replace('void ', '')[:56]} {v:.3f}" for k, v in top))
        if not ok:
            raise SystemExit(f"training main path ({name}) failed")
        del cn, state, step
    return results


def phase_tools(config: dict, device) -> None:
    """Each trainer tool for one epoch over TOOL_IMAGES seeded images, then
    resumed to a second epoch; the sampling tool then loads the written
    ControlNet .pth and draws a 10-step sample."""
    import numpy as np
    import yaml

    from controlnet_tpu_torch.ops.canny import canny_hints
    from controlnet_tpu_torch.schedules.linear import make_linear_schedule
    from controlnet_tpu_torch.tools import sample_ddpm_controlnet as sample_tool
    from controlnet_tpu_torch.tools import train_ddpm, train_ddpm_controlnet

    work = os.path.join(REPO, "build", "smoke", "tools")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    images = os.path.join(work, "images.npy")
    np.save(images, seeded_digits(TOOL_IMAGES))

    def config_path(epochs: int) -> str:
        cfg = copy.deepcopy(config)
        cfg["train_params"].update(task_name=os.path.join(work, "mnist"), num_epochs=epochs,
                                   controlnet_epochs=epochs, ckpt_save_every_epochs=1)
        path = os.path.join(work, f"mnist_{epochs}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        return path

    start = time.perf_counter()
    runs = [(tool, epochs, tool.train(config_path(epochs), images))
            for tool in (train_ddpm, train_ddpm_controlnet) for epochs in (1, 2)]
    seconds = time.perf_counter() - start
    ok = all(h["epochs"] == [epochs] and np.isfinite(h["losses"]).all() for _, epochs, h in runs)
    tp = config["train_params"]
    ckpt = os.path.join(work, "mnist", tp["controlnet_ckpt_name"])
    ok = ok and all(os.path.exists(os.path.join(work, "mnist", name[:-4], "2.pt"))
                    for name in (tp["ddpm_ckpt_name"], tp["controlnet_ckpt_name"]))
    cn, _ = sample_tool.load_model(config, ckpt)
    dp = config["diffusion_params"]
    short = make_linear_schedule(10, dp["beta_start"], dp["beta_end"], device=device)
    first = torch.from_numpy(np.load(images)[:4, :, :, None].astype(np.float32) / 255.0)
    hints = canny_hints(first.to(device)).cpu().numpy()
    x0, _ = sample_tool.sample(cn, short, hints, seed=SEED)
    ok = ok and x0.shape == (4, 1, 28, 28) and bool(torch.isfinite(x0).all())
    log(f"trainer tools: train_ddpm and train_ddpm_controlnet, 1 epoch then resumed to 2 "
        f"over {TOOL_IMAGES} images ({seconds:.1f} s; epoch losses "
        f"{[round(h['losses'][0], 4) for _, _, h in runs]}); sample tool on the written .pth, "
        f"10 steps: x0 {tuple(x0.shape)} finite -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("trainer tools failed")


def celebhq_config() -> dict:
    from controlnet_tpu_torch import config as cfg

    return cfg.load_config(os.path.join(REPO, "config", "celebhq.yaml"))


@contextlib.contextmanager
def plain_conv():
    """Route the 3x3 transposed-layout convs of this process through the plain
    version (the comparison model of phase 13); the port itself has no such
    switch."""
    from controlnet_tpu_torch.ops import cuda_conv, tl_conv

    orig = tl_conv.conv3x3_tl
    tl_conv.conv3x3_tl = cuda_conv.conv3x3_tl_plain
    try:
        yield
    finally:
        tl_conv.conv3x3_tl = orig


def write_seeded_ldm_checkpoints(config: dict, cn_path: str, vae_path: str) -> None:
    """Reference-format .pth files of the latent ControlNet and the VAE at the
    config's full width, random weights from SEED, every zero conv nonzero."""
    from controlnet_tpu_torch.tools import sample_ldm_controlnet as tool

    torch.manual_seed(SEED)
    cn, vae, _ = tool.load_models(config, None, None, device="cpu")
    randomize_zero_convs(cn)
    os.makedirs(os.path.dirname(cn_path), exist_ok=True)
    torch.save(cn.state_dict(), cn_path)
    torch.save(vae.state_dict(), vae_path)


def write_seeded_ldm_hints(n: int, size: int, path: str) -> None:
    """An .npy of binary (N, size, size, 3) edge-like hints (uint8 0 / 1)."""
    import numpy as np

    np.save(path, seeded_hints(n, size).astype(np.uint8))


def phase_hint_encode(cn, hints, device) -> list:
    """The full-width hint encode at batch LDM_BATCH: launches per chunk, the
    kernel route against the NCHW route, chunked against unchunked.  Returns
    the recorded conv shapes."""
    from controlnet_tpu_torch.ops import cuda_conv

    hint = torch.as_tensor(hints, dtype=torch.float32, device=device)
    hint = hint.permute(0, 3, 1, 2).contiguous()
    shapes: list = []
    with torch.inference_mode():
        before = cuda_conv.launches
        with record_conv_shapes(shapes):
            feats = cn.hint_features(hint)
        torch.cuda.synchronize()
        per_encode = cuda_conv.launches - before
        ref = cn.hint_block(hint)  # the same modules through F.conv2d, NCHW
        torch.cuda.synchronize()
        err = (feats - ref).abs().max().item()
        scale = ref.abs().max().item()
        del ref
        before = cuda_conv.launches
        chunked = cn.hint_features_chunked(hint, chunk=4)
        torch.cuda.synchronize()
        per_chunked = cuda_conv.launches - before
        chunk_err = (chunked - feats).abs().max().item()
        start = time.perf_counter()
        cn.hint_features_chunked(hint, chunk=LDM_BATCH)
        torch.cuda.synchronize()
        encode_ms = (time.perf_counter() - start) * 1e3
    n_chunks = -(-hint.shape[0] // 4)
    ok = (per_encode == 7 and len(shapes) == 7 and per_chunked == 7 * n_chunks
          and feats.shape == (hint.shape[0], cn.trained_unet.down_channels[0],
                              hint.shape[2] // cn.down_sample_factor,
                              hint.shape[3] // cn.down_sample_factor)
          and bool(torch.isfinite(feats).all())
          and err <= MODEL_TOL[torch.float32] * max(scale, 1.0)
          and chunk_err <= 1e-5 * max(scale, 1.0))
    log(f"hint encode f32, batch {hint.shape[0]}, hints {tuple(hint.shape[2:])}: conv kernel "
        f"launches {per_encode} (expect 7), chunked by 4: {per_chunked} (expect "
        f"{7 * n_chunks}); features {tuple(feats.shape)}, max|f| {scale:.4g}; max abs err "
        f"vs the NCHW F.conv2d route {err:.3g} (tol {MODEL_TOL[torch.float32]:g} x max|f|), "
        f"chunked vs unchunked {chunk_err:.3g} "
        f"({'bit-identical' if chunk_err == 0 else 'tol 1e-5 x max|f|'}); "
        f"whole encode {encode_ms:.2f} ms on the host clock -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("full-width hint encode failed")
    return shapes


def phase_ldm_forward(cn, hints, device) -> list:
    """Full-width latent ControlNet forward at batch LDM_BATCH, kernel vs
    plain attention; returns the recorded attention shapes."""
    from controlnet_tpu_torch.ops import cuda_attention

    g = torch.Generator(device=device).manual_seed(SEED)
    hint = torch.as_tensor(hints, dtype=torch.float32, device=device)
    hint = hint.permute(0, 3, 1, 2).contiguous()
    size = hint.shape[2] // cn.down_sample_factor
    x = torch.randn((LDM_BATCH, cn.trained_unet.im_channels, size, size), generator=g,
                    device=device)
    t = torch.randint(0, 1000, (LDM_BATCH,), generator=g, device=device)
    shapes: list = []
    with torch.inference_mode():
        feats32 = cn.hint_features_chunked(hint)
        for dtype in (torch.float32, torch.bfloat16):
            xin, feats = x.to(dtype), feats32.to(dtype)
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
            ok = (launched == 22 and len(rec) == 22 and out.shape == x.shape
                  and bool(torch.isfinite(out).all())
                  and err <= MODEL_TOL[dtype] * max(scale, 1.0))
            log(f"latent forward {str(dtype)[6:]}: batch {LDM_BATCH}, attention launches "
                f"{launched} (expect 22), max|out| {scale:.4g}, max abs err vs plain {err:.3g} "
                f"(tol {MODEL_TOL[dtype]:g} x max(1, max|out|)) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("full-width latent forward failed")
            shapes = shapes or rec
    return shapes


def phase_ldm_fused_forward(cn, hints, device) -> None:
    """The full-width latent forward of ``phase_ldm_forward`` with the fused
    layer on: every attention layer has a head dim of 8..48, so all 22 go to
    kernel d and none to kernel a."""
    g = torch.Generator(device=device).manual_seed(SEED)
    hint = torch.as_tensor(hints, dtype=torch.float32, device=device)
    hint = hint.permute(0, 3, 1, 2).contiguous()
    size = hint.shape[2] // cn.down_sample_factor
    x = torch.randn((LDM_BATCH, cn.trained_unet.im_channels, size, size), generator=g,
                    device=device)
    t = torch.randint(0, 1000, (LDM_BATCH,), generator=g, device=device)
    with torch.inference_mode():
        feats = cn.hint_features_chunked(hint)
    phase_fused_forward(cn, x, t, feats, LDM_PROJ_SHAPES, 0, "latent")


LDM_ANCESTRAL_STEPS = 250  # the ancestral loop's schedule length in phase 13
LDM_MODES = (
    ("ancestral", dict()),
    ("dpm20_cfg2", dict(sampler="dpm", sampler_steps=20, cfg_scale=2.0)),
    ("ddim50", dict(sampler="ddim", sampler_steps=50)),
)


def phase_ldm_main_path(config: dict, cn, vae, sched, hints_path: str, device) -> dict:
    """The latent main path through the sample tool's functions: a short
    sample with guidance, kernels vs plain versions; then the three sampler modes at
    batch LDM_BATCH, f32 and bf16, counters set to 0 just before each run and
    read just after."""
    import numpy as np

    from controlnet_tpu_torch.ops import cuda_attention, cuda_conv
    from controlnet_tpu_torch.tools import sample_ldm_controlnet as tool

    hints = tool.gather_hints(np.load(hints_path), LDM_BATCH, seed=SEED)

    flags = dict(sampler="dpm", sampler_steps=5, cfg_scale=2.0)
    img_k, _ = tool.sample(cn, vae, sched, hints[:2], seed=SEED, **flags)
    with plain_attention(), plain_conv():
        img_p, _ = tool.sample(cn, vae, sched, hints[:2], seed=SEED, **flags)
    err = (img_k - img_p).abs().max().item()
    scale = img_p.abs().max().item()
    ok = bool(torch.isfinite(img_k).all()) and err <= MODEL_TOL[torch.float32] * max(scale, 1.0)
    log(f"5-step latent sample with guidance + decode, batch 2: max abs err kernels vs plain "
        f"{err:.3g} (max|image| {scale:.4g}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("short latent sample disagrees with the plain versions")

    from controlnet_tpu_torch.schedules.linear import make_linear_schedule

    dp = config["diffusion_params"]
    ancestral_sched = make_linear_schedule(LDM_ANCESTRAL_STEPS, dp["beta_start"],
                                           dp["beta_end"], ldm_scheduler=True, device=device)
    im_size, z = config["dataset_params"]["im_size"], cn.trained_unet.im_channels
    lsize = tool.latent_size(config["dataset_params"], config["autoencoder_params"])
    results: dict = {}
    for mode, mode_flags in LDM_MODES:
        run_sched = ancestral_sched if mode == "ancestral" else sched
        steps = mode_flags.get("sampler_steps", run_sched.num_timesteps)
        with_cfg = "cfg_scale" in mode_flags
        for name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_attention.launches = 0
            cuda_conv.launches = 0
            start = time.perf_counter()
            images, traj = tool.sample(cn, vae, run_sched, hints, seed=SEED,
                                       compute_dtype=dtype, **mode_flags)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            attn, conv = cuda_attention.launches, cuda_conv.launches
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            # one encode of the hints, and one of the null hint under guidance
            want_conv = 14 if with_cfg else 7
            snapshots = 1 if mode == "ancestral" else steps
            ok = (attn == 22 * steps and conv == want_conv
                  and images.shape == (LDM_BATCH, 3, im_size, im_size)
                  and traj.shape == (snapshots, LDM_BATCH, z, lsize, lsize)
                  and bool(torch.isfinite(images).all()) and bool(torch.isfinite(traj).all()))
            results[(mode, name)] = dict(
                seconds=seconds, steps=steps, ms_per_step=seconds * 1e3 / steps,
                samples_per_s=LDM_BATCH / seconds, attn_launches=attn, conv_launches=conv,
                peak_gb=peak_gb)
            log(f"latent main path {mode} {name}: {steps} steps, batch {LDM_BATCH}"
                f"{' (x2 in the model call, for guidance)' if with_cfg else ''}: {seconds:.3f} s, "
                f"{LDM_BATCH / seconds:.3f} samples/s, {seconds * 1e3 / steps:.3f} ms/step, "
                f"attention launches {attn} (expect {22 * steps}), conv launches {conv} "
                f"(expect {want_conv}), images {tuple(images.shape)} in "
                f"[{images.min().item():.3g}, {images.max().item():.3g}], peak memory "
                f"{peak_gb:.2f} GB -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"latent main path ({mode}, {name}) failed")
            del images, traj
    return results


def phase_ldm(device) -> dict:
    """Phases 10-13: the CelebA-HQ latent slice."""
    import numpy as np

    from controlnet_tpu_torch.tools import sample_ldm_controlnet as tool

    config = celebhq_config()
    work = os.path.join(REPO, "build", "smoke", "ldm")
    os.makedirs(work, exist_ok=True)
    cn_path = os.path.join(work, f"ldm_controlnet_seed{SEED}.pth")
    vae_path = os.path.join(work, f"vae_seed{SEED}.pth")
    hints_path = os.path.join(work, f"hints_seed{SEED}.npy")
    start = time.perf_counter()
    write_seeded_ldm_checkpoints(config, cn_path, vae_path)
    write_seeded_ldm_hints(2 * LDM_BATCH, config["dataset_params"]["canny_im_size"], hints_path)
    cn, vae, sched = tool.load_models(config, cn_path, vae_path)
    n_params = sum(p.numel() for p in cn.parameters()) + sum(p.numel() for p in vae.parameters())
    log(f"latent models: config/celebhq.yaml at full width, {n_params / 1e6:.1f} M parameters, "
        f"hint factor {cn.down_sample_factor}; seeded .pth and .npy written and loaded in "
        f"{time.perf_counter() - start:.1f} s")
    hints = tool.gather_hints(np.load(hints_path), LDM_BATCH, seed=SEED)

    conv_shapes = phase_hint_encode(cn, hints, device)
    if conv_shapes != hint_conv_shapes(hints.shape[1], 3, cn.trained_unet.down_channels[0],
                                       cn.down_sample_factor, LDM_BATCH):
        raise SystemExit(f"unexpected conv shapes in the hint encode: {conv_shapes}")
    kern_conv = in_fresh_process("phase_conv_kernels", conv_shapes)
    attn_shapes = phase_ldm_forward(cn, hints, device)
    kern_attn = in_fresh_process("phase_kernels", attn_shapes, batch=LDM_BATCH, cross=False)
    phase_ldm_fused_forward(cn, hints, device)
    kern_proj = in_fresh_process("phase_proj_kernels", LDM_PROJ_SHAPES, LDM_BATCH,
                                 what="latent forward")
    runs = phase_ldm_main_path(config, cn, vae, sched, hints_path, device)
    return dict(conv=kern_conv, attn=kern_attn, proj=kern_proj, runs=runs)


def proj_inputs(b: int, l: int, c: int, dtype: torch.dtype, device):
    """Seeded inputs of one fused layer call: channel-major (B, C, L) unit
    normal activations, as the GroupNorm before the layer leaves them, and
    parameters drawn as ``nn.MultiheadAttention`` initialises its weights,
    with nonzero biases."""
    g = torch.Generator(device=device).manual_seed(SEED)

    def uniform(shape, bound):
        return ((torch.rand(shape, generator=g, device=device) * 2 - 1) * bound).to(dtype)

    xt = torch.randn((b, c, l), generator=g, device=device).to(dtype)
    return (xt, uniform((3 * c, c), (6.0 / (4 * c)) ** 0.5), uniform((3 * c,), 0.1),
            uniform((c, c), 1.0 / c ** 0.5), uniform((c,), 0.1))


def phase_proj_kernels(cases: list, batch: int, device, what: str) -> dict:
    """Kernel d against its plain version at ``cases`` ((L, C, heads, calls
    per forward)), f32 and bf16, on the (B, L, C) view of channel-major
    activations that the model passes; timings of the kernel, the plain
    version, the split path and ``F.multi_head_attention_forward`` (device
    time, with the CUDA-event time beside)."""
    import torch.nn.functional as F

    from controlnet_tpu_torch.ops import attention as attention_ops
    from controlnet_tpu_torch.ops import cuda_attention_proj as proj

    totals = {}
    for dtype in (torch.float32, torch.bfloat16):
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, split_ms=0.0, flops=0.0,
                   ms_events=0.0, plain_ms_events=0.0, library_ms_events=0.0,
                   split_ms_events=0.0, ops_ms=0.0, bytes_ms=0.0, max_abs_err=0.0,
                   max_rel_err=0.0)
        for l, c, heads, n in cases:
            xt, in_w, in_b, out_w, out_b = proj_inputs(batch, l, c, dtype, device)
            x = xt.transpose(1, 2)
            args = (in_w, in_b, out_w, out_b, heads)

            def split():
                qkv = torch.matmul(in_w, xt) + in_b[:, None]
                out_t = attention_ops.multi_head_attention_t(
                    qkv[:, :c], qkv[:, c:2 * c], qkv[:, 2 * c:], heads)
                return torch.matmul(out_w, out_t) + out_b[:, None]

            xl = x.transpose(0, 1).contiguous()  # (L, B, C), the library call's layout

            def library():
                return F.multi_head_attention_forward(
                    xl, xl, xl, c, heads, in_w, in_b, None, None, False, 0.0, out_w, out_b,
                    training=False, need_weights=False)[0]

            with torch.inference_mode():
                out = proj.fused_attention_proj(x, *args)
                ref = proj.fused_attention_proj_plain(x, *args)
                torch.cuda.synchronize()
                scale = ref.float().abs().max().item()
                err = (out.float() - ref.float()).abs().max().item()
                # the same layer on contiguous (B, L, C) tokens
                err_tok = (proj.fused_attention_proj(x.contiguous(), *args).float()
                           - ref.float()).abs().max().item()
                err_split = (split().transpose(1, 2).float() - ref.float()).abs().max().item()
                err_lib = (library().transpose(0, 1).float() - ref.float()).abs().max().item()
                phases = proj.phase_profile(x, *args)
                ok = (max(err, err_tok) <= PROJ_TOL[dtype] * scale
                      and bool(torch.isfinite(out).all()) and out.shape == x.shape
                      and out.stride() == x.stride())
                del ref
                t = time_calls(ms=lambda: proj.fused_attention_proj(x, *args),
                               plain_ms=lambda: proj.fused_attention_proj_plain(x, *args),
                               split_ms=split, library_ms=library)
            ms = t["ms"]
            bound_ms, bound_by = proj_bound_ms(batch, l, c, dtype)
            flops = (8.0 * l * c * c + 4.0 * l * l * c) * batch
            rows, q_tiles, groups, smem = proj.launch_plan(l, c, c, heads, dtype)
            clusters = proj.max_active_clusters(l, c, c, heads, dtype)
            # The query tiles partition L, and each block projects K and V for
            # its own rows only: each key's K and V is projected once per batch
            # element (the kernel's projection flops over the layer's own
            # 8*L*C^2, tiles padded to whole rows apart).
            projections_per_key = 1 if rows * (q_tiles - 1) < l <= rows * q_tiles else q_tiles
            recompute = (4 + 4 * projections_per_key) / 8
            log(f"attention_proj {str(dtype)[6:]:8s} L {l:4d} C {c:3d} dh {c // heads:2d} B {batch}: "
                f"err {err:.3g}, on contiguous tokens {err_tok:.3g} (tol {PROJ_TOL[dtype]:g} x "
                f"max|out| {scale:.3g}) {'ok' if ok else 'FAIL'}; split path vs plain "
                f"{err_split:.3g}, library vs plain {err_lib:.3g} | device: kernel {ms:.4f} ms "
                f"({flops / ms / 1e9:.2f} TFLOP/s of the layer's flops; {rows} rows per block, "
                f"cluster {q_tiles} tiles x {groups} head groups, {clusters} clusters at once for "
                f"{batch}, {smem} B shared, projection "
                f"work x{recompute:.1f}, padded rows x{rows * q_tiles / l:.2f}), plain "
                f"{t['plain_ms']:.4f} ms, split path {t['split_ms']:.4f} ms, F.mha "
                f"{t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) | events: "
                f"kernel {t['ms_events']:.4f}, plain {t['plain_ms_events']:.4f}, split path "
                f"{t['split_ms_events']:.4f}, F.mha {t['library_ms_events']:.4f} ms | x{n} per "
                f"{what} | cycles a block by phase: "
                + ", ".join(f"{p} {phases[p]:.0f}" for p in proj.PHASES))
            if not ok:
                raise SystemExit("fused projection + attention kernel disagrees with its "
                                 "plain version")
            tot["max_abs_err"] = max(tot["max_abs_err"], err, err_tok)
            tot["max_rel_err"] = max(tot["max_rel_err"], max(err, err_tok) / scale)
            for key in ("ms", "plain_ms", "library_ms", "split_ms", "ms_events",
                        "plain_ms_events", "library_ms_events", "split_ms_events"):
                tot[key] += n * t[key]
            tot["bound_ms"] += n * bound_ms
            tot["flops"] += n * flops
            tot["ops_ms"] += n * (bound_ms if bound_by == "operations" else 0.0)
            tot["bytes_ms"] += n * (bound_ms if bound_by == "bytes" else 0.0)
        tot["bound_by"] = "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes"
        totals[dtype] = tot
        log(f"attention_proj {str(dtype)[6:]} per {what} at batch {batch} "
            f"({sum(n for *_, n in cases)} calls), device: kernel {tot['ms']:.4f} ms, plain "
            f"{tot['plain_ms']:.4f} ms, split path {tot['split_ms']:.4f} ms, F.mha "
            f"{tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms ({tot['bound_by']}), "
            f"{tot['flops'] / 1e9:.2f} GFLOP | events: kernel {tot['ms_events']:.4f}, plain "
            f"{tot['plain_ms_events']:.4f}, split path {tot['split_ms_events']:.4f}, F.mha "
            f"{tot['library_ms_events']:.4f} ms")
    return totals


def phase_fused_forward(cn, x, t, feats32, expect: list, want_a: int, what: str) -> dict:
    """One full-width forward with the fused layer switched on: launches of
    kernel d (one per entry of ``expect``) and of kernel a, against the same
    forward with the switch off and with the plain versions, f32 and bf16.
    Returns kernel d's counted launches of that forward by dtype name."""
    from controlnet_tpu_torch.nn.layers import set_attn_fused_proj
    from controlnet_tpu_torch.ops import cuda_attention, cuda_attention_proj

    want_d = sum(n for *_, n in expect)
    want = collections.Counter({(l, c, h, True): n for l, c, h, n in expect})
    launches = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            xin, feats = x.to(dtype), feats32.to(dtype)
            off = cn(xin, t, hint_features=feats)
            set_attn_fused_proj(cn, True)
            try:
                before = cuda_attention_proj.launches, cuda_attention.launches
                rec: list = []
                with record_proj_shapes(rec):
                    out = cn(xin, t, hint_features=feats)
                torch.cuda.synchronize()
                got_d = cuda_attention_proj.launches - before[0]
                got_a = cuda_attention.launches - before[1]
                with plain_attention(), plain_attention_proj():
                    ref = cn(xin, t, hint_features=feats)
                torch.cuda.synchronize()
            finally:
                set_attn_fused_proj(cn, False)
            scale = max(ref.float().abs().max().item(), 1.0)
            err = (out.float() - ref.float()).abs().max().item()
            err_off = (out.float() - off.float()).abs().max().item()
            ok = (got_d == want_d and got_a == want_a and collections.Counter(rec) == want
                  and out.shape == x.shape and bool(torch.isfinite(out).all())
                  and err <= MODEL_TOL[dtype] * scale
                  and err_off <= FUSED_VS_SPLIT_TOL[dtype] * scale)
            log(f"{what} forward, fused layer on, {str(dtype)[6:]}: batch {x.shape[0]}, kernel d "
                f"launches {got_d} (expect {want_d}), kernel a {got_a} (expect {want_a}), all on "
                f"channel-major activations; max abs err vs the plain versions {err:.3g} (tol "
                f"{MODEL_TOL[dtype]:g} x max(1, max|out|) = {MODEL_TOL[dtype] * scale:.3g}), vs "
                f"the switch off {err_off:.3g} (tol {FUSED_VS_SPLIT_TOL[dtype]:g} x the same) -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"{what} forward with the fused layer failed")
            launches[str(dtype)[6:]] = got_d
    return launches


def phase_mnist_fused_forward(cn, device) -> dict:
    g = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn((BATCH, 1, 28, 28), generator=g, device=device)
    t = torch.randint(0, 1000, (BATCH,), generator=g, device=device)
    hint = (torch.rand((BATCH, 3, 28, 28), generator=g, device=device) < 0.15).float()
    with torch.inference_mode():
        feats = cn.hint_features(hint)
    return phase_fused_forward(cn, x, t, feats, MNIST_PROJ_SHAPES, 2, "MNIST")


# The concurrent clients of phase 16, run as ``python -c`` in a process of
# their own: argv = (url, number of clients), the request body on stdin.  Each
# thread posts the body once, all released together; prints one JSON object.
CLIENT_SCRIPT = """
import io, json, sys, threading, time, urllib.request
import numpy as np
url, n = sys.argv[1], int(sys.argv[2])
body = sys.stdin.buffer.read()
out = [None] * n
gate = threading.Barrier(n + 1)
def client(i):
    gate.wait()
    t0 = time.perf_counter()
    with urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"),
                                timeout=300) as r:
        status, rows, raw = r.status, int(r.headers["X-Batch-Rows"]), r.read()
    ms = (time.perf_counter() - t0) * 1e3
    with np.load(io.BytesIO(raw)) as z:
        s = z["samples"]
    out[i] = (status, rows, ms, list(s.shape), bool(np.isfinite(s).all()))
threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
for t in threads:
    t.start()
gate.wait()
t0 = time.perf_counter()
for t in threads:
    t.join()
wall = time.perf_counter() - t0
assert all(o is not None for o in out), "a client failed"
print(json.dumps({"wall_s": wall, "statuses": [o[0] for o in out], "rows": [o[1] for o in out],
                  "client_ms": [o[2] for o in out], "shapes": [o[3] for o in out],
                  "finite": [o[4] for o in out]}))
"""


def _post(url: str, body: bytes, timeout: float = 300.0):
    """POST; returns (status, headers, body, client seconds)."""
    import urllib.error
    import urllib.request

    start = time.perf_counter()
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"),
                                    timeout=timeout) as r:
            status, headers, out = r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        status, headers, out = e.code, dict(e.headers), e.read()
    return status, headers, out, time.perf_counter() - start


def _npz(**arrays) -> bytes:
    import io

    import numpy as np

    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def phase_serve(config: dict, ckpt: str, device) -> dict:
    """The serving main path through the serve tool, on the card."""
    import io
    import threading
    import types
    import urllib.request

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from controlnet_tpu_torch.ops import cuda_attention, cuda_attention_proj
    from controlnet_tpu_torch.sample.ddim import ddim_timesteps
    from controlnet_tpu_torch.tools import serve

    T = config["diffusion_params"]["num_timesteps"]
    hints = seeded_hints(SERVE_BATCH, 28)
    mid = SERVE_STEPS[1]  # the step count of the comparisons

    def make_args(**kw):
        base = dict(config_path=os.path.join(REPO, "config", "mnist.yaml"),
                    model="dpm_controlnet", host="127.0.0.1", port=0, seed=SEED,
                    max_batch=SERVE_BATCH, max_steps=max(SERVE_STEPS), dynamic_batching=True,
                    batch_window_ms=2.0, ckpt=ckpt, device=None, attn_fused_proj=True)
        return types.SimpleNamespace(**{**base, **kw})

    def dispatchers() -> int:
        return sum(th.name == "serve-microbatcher" for th in threading.enumerate())

    @contextlib.contextmanager
    def serving(**kw):
        before = dispatchers()
        start = time.perf_counter()
        server = serve.make_server(make_args(**kw), config)
        warm_s = time.perf_counter() - start
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            yield f"http://127.0.0.1:{server.server_address[1]}", warm_s
        finally:
            server.shutdown()
            server.server_close()
            thread.join(10)
            if thread.is_alive() or dispatchers() != before:
                raise SystemExit("the server did not shut down: its dispatcher thread is left")

    def batch_request(base: str, rows: np.ndarray, steps: int):
        status, headers, body, seconds = _post(f"{base}/generate_batch?steps={steps}",
                                               _npz(hints=rows))
        if status != 200:
            raise SystemExit(f"/generate_batch?steps={steps} answered {status}: {body[:200]!r}")
        with np.load(io.BytesIO(body)) as z:
            samples = z["samples"]
        return (samples, float(headers["X-Latency-Ms"]), int(headers["X-Batch-Rows"]),
                seconds * 1e3)

    def clients(base: str) -> dict:
        """SERVE_CLIENTS one-row clients, released together, in a process of
        their own (threads of this process would share the interpreter lock
        with the server's dispatcher, which real clients do not)."""
        body = _npz(hints=hints[:1])
        out = subprocess.run(
            [sys.executable, "-c", CLIENT_SCRIPT, f"{base}/generate_batch?steps={mid}",
             str(SERVE_CLIENTS)], input=body, capture_output=True, timeout=600)
        if out.returncode != 0:
            raise SystemExit(f"the concurrent clients failed: {out.stderr.decode()[-2000:]}")
        r = json.loads(out.stdout)
        lat = sorted(r["client_ms"])
        good = (r["statuses"] == [200] * SERVE_CLIENTS
                and r["shapes"] == [[1, 28, 28, 1]] * SERVE_CLIENTS and all(r["finite"]))
        return dict(requests_per_s=SERVE_CLIENTS / r["wall_s"], p50_ms=lat[len(lat) // 2],
                    p99_ms=lat[min(len(lat) - 1, int(0.99 * len(lat)))],
                    mean_rows=sum(r["rows"]) / len(r["rows"]), max_rows=max(r["rows"]),
                    good=good)

    res: dict = {}
    with serving() as (base, warm_s), serving(attn_fused_proj=False) as (base_off, _), \
            serving(model="ddim_controlnet") as (base_ddim, _):
        health = json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=30).read())
        ok = health == {"status": "ok", "model": "dpm_controlnet", "warm": True,
                        "max_batch": SERVE_BATCH, "max_steps": max(SERVE_STEPS),
                        "batch_window_ms": 2.0}
        log(f"server: dpm_controlnet, fused layer on, warm in {warm_s:.2f} s (one generation "
            f"per bucket 1..{SERVE_BATCH}); /healthz {health} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("/healthz is wrong")
        first = batch_request(base, hints, SERVE_STEPS[0])
        log(f"the first request after warm-up ({SERVE_BATCH} rows, {SERVE_STEPS[0]} steps): "
            f"X-Latency-Ms {first[1]:.2f}")

        # the serving main path: counters set to 0 just before, read just after
        torch.cuda.synchronize()
        cuda_attention_proj.launches = 0
        cuda_attention.launches = 0
        calls = 0
        for steps in SERVE_STEPS:
            runs = [batch_request(base, hints, steps) for _ in range(3)]
            calls += 3 * len(ddim_timesteps(T, steps))
            ok = all(samples.shape == (SERVE_BATCH, 28, 28, 1) and samples.dtype == np.float32
                     and bool(np.isfinite(samples).all())
                     and float(np.abs(samples).max()) <= 1.0 and rows == SERVE_BATCH
                     for samples, _, rows, _ in runs)
            latency_ms, client_ms = (sorted(r[i] for r in runs)[1] for i in (1, 3))
            res[f"steps{steps}"] = dict(latency_ms=latency_ms, client_ms=client_ms)
            samples = runs[0][0]
            log(f"/generate_batch?steps={steps}, {SERVE_BATCH} rows, median of 3: X-Latency-Ms "
                f"{latency_ms:.2f} ({latency_ms / steps:.2f} ms/step), client {client_ms:.2f} ms, "
                f"samples {samples.shape} in [{samples.min():.3g}, {samples.max():.3g}] -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"/generate_batch at {steps} steps failed")
        res["launches_d"], res["launches_a"] = cuda_attention_proj.launches, cuda_attention.launches
        ok = res["launches_d"] == 24 * calls and res["launches_a"] == 2 * calls
        log(f"serving main path: {calls} model calls, kernel d launches {res['launches_d']} "
            f"(expect {24 * calls}), kernel a {res['launches_a']} (expect {2 * calls}) -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the served requests did not go through the kernels as expected")

        try:
            import PIL  # noqa: F401
            have_pil = True
        except ImportError:
            have_pil = False
        if have_pil:
            from PIL import Image

            from controlnet_tpu_torch.io.images import encode_sample_png

            status, headers, body, _ = _post(f"{base}/generate?steps={SERVE_STEPS[0]}",
                                             encode_sample_png(hints[0][:, :, :1] * 2 - 1))
            ok = status == 200 and Image.open(io.BytesIO(body)).size == (28, 28)
            log(f"/generate?steps={SERVE_STEPS[0]} (PNG in, PNG out): {status}, X-Batch-Rows "
                f"{headers.get('X-Batch-Rows')} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("/generate failed")
        else:
            log("/generate not driven: PIL does not import on this machine "
                "(/generate_batch needs numpy only)")

        bad = [_post(f"{base}/generate_batch?steps={s}", _npz(hints=hints))[0]
               for s in (max(SERVE_STEPS) + 1, "abc")]
        log(f"steps={max(SERVE_STEPS) + 1} and steps=abc answer {bad} (expect [400, 400])")
        if bad != [400, 400]:
            raise SystemExit("an out-of-range or unparseable steps was not a 400")

        # the same request to the three servers in turns (on, off, ddim, ddim, off, on)
        turns = [("on_ms", base), ("off_ms", base_off), ("ddim_ms", base_ddim)]
        seen: dict = {name: [] for name, _ in turns}
        for order in (turns, turns[::-1]) * 3:
            for name, url in order:
                seen[name].append(batch_request(url, hints, mid)[1])
        for name, vals in seen.items():
            vals.sort()
            res[name] = (vals[2] + vals[3]) / 2
        log(f"{SERVE_BATCH}-row request at {mid} steps, X-Latency-Ms, median of 6 taken in "
            f"turns: dpm_controlnet fused layer on {res['on_ms']:.2f} (range {seen['on_ms'][0]:.2f}"
            f"-{seen['on_ms'][-1]:.2f}), off {res['off_ms']:.2f} ({seen['off_ms'][0]:.2f}-"
            f"{seen['off_ms'][-1]:.2f}); ddim_controlnet on {res['ddim_ms']:.2f} "
            f"({seen['ddim_ms'][0]:.2f}-{seen['ddim_ms'][-1]:.2f})")

        res["batched"] = clients(base)
    with serving(dynamic_batching=False) as (base, _):
        res["unbatched"] = clients(base)
    for name in ("batched", "unbatched"):
        r = res[name]
        log(f"{SERVE_CLIENTS} concurrent one-row clients in another process, steps {mid}, "
            f"{'dynamic batching' if name == 'batched' else '--no-dynamic-batching'}: "
            f"{r['requests_per_s']:.3f} requests/s, client p50 {r['p50_ms']:.1f} ms, p99 "
            f"{r['p99_ms']:.1f} ms, X-Batch-Rows mean {r['mean_rows']:.2f}, max {r['max_rows']}")
    ok = (res["batched"]["good"] and res["unbatched"]["good"] and res["batched"]["max_rows"] > 1
          and res["unbatched"]["max_rows"] == 1)
    if not ok:
        raise SystemExit("concurrent clients: bad samples, or batching did not behave")

    # a pinned x_T through build_generator: kernels against the plain versions
    g = torch.Generator(device=device).manual_seed(SEED)
    x_start = torch.randn((SERVE_BATCH, 1, 28, 28), generator=g, device=device)
    gen = serve.build_generator(make_args(), config)[0]
    out_k = gen(hints, None, 4, x_start=x_start)
    with plain_attention(), plain_attention_proj():
        out_p = gen(hints, None, 4, x_start=x_start)
    err = (out_k - out_p).abs().max().item()
    ok = (out_k.shape == (SERVE_BATCH, 1, 28, 28) and bool(torch.isfinite(out_k).all())
          and err <= MODEL_TOL[torch.float32])
    log(f"generate, 4 steps, x_T pinned, batch {SERVE_BATCH}: max abs err kernels vs plain "
        f"versions {err:.3g} (tol {MODEL_TOL[torch.float32]:g}; samples in [-1, 1]) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the served sample disagrees with the plain versions")

    # device time of one generation, switch on and off: the wall time of a run
    # without the profiler, then the device time of the same run under it
    for name, on in (("on", True), ("off", False)):
        gen = serve.build_generator(make_args(attn_fused_proj=on), config)[0]
        gen(hints, None, mid, x_start=x_start)
        torch.cuda.synchronize()
        start = time.perf_counter()
        gen(hints, None, mid, x_start=x_start).cpu()
        wall_ms = (time.perf_counter() - start) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            gen(hints, None, mid, x_start=x_start)
            torch.cuda.synchronize()
        kernels = device_events(prof)
        dev_ms = sum(_device_ms(e) for e in kernels)
        d_ms = sum(_device_ms(e) for e in kernels if "attention_proj_kernel" in e.name)
        a_ms = sum(_device_ms(e) for e in kernels if is_kernel_a(e.name))
        res[f"profile_{name}"] = dict(wall_ms=wall_ms, device_ms=dev_ms, busy=dev_ms / wall_ms,
                                      kernels=len(kernels), d_ms=d_ms, a_ms=a_ms)
        log(f"one {SERVE_BATCH}-row {mid}-step generation, fused layer {name}: {wall_ms:.2f} ms on "
            f"the host clock; under the profiler {dev_ms:.2f} ms of device time (busy "
            f"{dev_ms / wall_ms:.3f}), {len(kernels)} kernels, kernel d {d_ms:.3f} ms, kernel a "
            f"{a_ms:.3f} ms")
    return res


# The kernel-timing phases (3, 6, 10, 12 and 15).  Each runs in a process of
# its own (``in_fresh_process``): on the H100 a process that has launched
# millions of kernels since its first profiler window loses device records in
# later windows, often all of a window's own, while a fresh one does not.
TIMING_PHASES = ("phase_kernels", "phase_kernels_bwd", "phase_conv_kernels",
                 "phase_proj_kernels")


def in_fresh_process(phase: str, *args, **kwargs) -> dict:
    """Run the timing phase ``phase`` (one of TIMING_PHASES) with JSON-able
    ``args`` / ``kwargs`` and ``device`` set to the card, in a new Python
    process on the same card; pass its log lines on and return its totals by
    dtype.  A failure there fails the run."""
    spec = json.dumps([phase, args, kwargs])
    torch.cuda.empty_cache()  # the child allocates its own inputs
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--timing-phase", spec],
                          stdout=subprocess.PIPE, text=True, timeout=1200, check=False)
    lines = proc.stdout.splitlines()
    for line in lines[:-1]:
        log(line)
    if proc.returncode != 0 or not lines:
        raise SystemExit(f"{phase} failed in its own process (exit code {proc.returncode})")
    result = json.loads(lines[-1])
    for key in PROFILER_WINDOWS:
        PROFILER_WINDOWS[key] += result["profiler_windows"][key]
    return {getattr(torch, name): tot for name, tot in result["totals"].items()}


def timing_phase(spec: str) -> int:
    """The child side of ``in_fresh_process``: run the phase, print its
    totals and this process's profiler windows as the last line."""
    phase, args, kwargs = json.loads(spec)
    if phase not in TIMING_PHASES:
        raise SystemExit(f"no timing phase {phase!r}")
    # shape lists come back from JSON as lists of lists; the phases count them
    args = [[tuple(x) for x in a] if isinstance(a, list) and a and isinstance(a[0], list) else a
            for a in args]
    totals = globals()[phase](*args, device=torch.device(DEVICE), **kwargs)
    print(json.dumps({"totals": {str(d)[6:]: tot for d, tot in totals.items()},
                      "profiler_windows": PROFILER_WINDOWS}), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--verbose-build", action="store_true",
                        help="print nvcc's register and shared-memory report")
    parser.add_argument("--timing-phase", help=argparse.SUPPRESS)  # set by in_fresh_process
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from controlnet_tpu_torch.ops import _build, cuda_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.timing_phase:
        _build.load()
        return timing_phase(args.timing_phase)
    device = torch.device(DEVICE)
    smi = nvidia_smi_line()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    start = time.perf_counter()
    _build.build(verbose=args.verbose_build)
    _build.load()
    log(f"kernel build: {time.perf_counter() - start:.2f} s ({_build.LIB_PATH.name} from "
        f"{', '.join(p.name for p in _build.sources())})")
    sass = phase_sass(str(_build.LIB_PATH), _build._nvcc())

    config = mnist_config()
    ckpt = os.path.join(REPO, "build", "smoke", f"mnist_controlnet_seed{SEED}.pth")
    write_seeded_checkpoint(config, ckpt)
    from controlnet_tpu_torch.data.datasets import to_unit
    from controlnet_tpu_torch.tools import sample_ddpm_controlnet as tool

    cn, _ = tool.load_model(config, ckpt)
    shapes = phase_forward(cn, device)
    fused_launches = phase_mnist_fused_forward(cn, device)
    del cn
    kern = in_fresh_process("phase_kernels", shapes)
    main_path = phase_main_path(config, ckpt, device)

    base = seeded_unet_state_dict(config)
    images = torch.from_numpy(to_unit(seeded_digits(8 * BATCH)))[:, None].to(device)
    bwd_shapes = phase_train_shapes(config, base, images, device)
    kern_bwd = in_fresh_process("phase_kernels_bwd", bwd_shapes)
    for dtype in (torch.float32, torch.bfloat16):
        phase_train_parity(config, base, images, device, dtype)
    train = phase_train_main_path(config, base, images, device)
    phase_tools(config, device)
    del images
    torch.cuda.empty_cache()
    ldm = phase_ldm(device)
    proj16 = in_fresh_process("phase_proj_kernels", MNIST_PROJ_SHAPES, SERVE_BATCH,
                              what="MNIST forward")
    proj64 = in_fresh_process("phase_proj_kernels", MNIST_PROJ_SHAPES, BATCH,
                              what="MNIST forward")
    served = phase_serve(config, ckpt, device)

    def kernel_entry(name, source, replaces, tots, launches, bf16_launches, per):
        f32, bf16 = tots[torch.float32], tots[torch.bfloat16]
        # the CUDA-event times of the same calls (the yardstick of earlier runs)
        events = ("ms_events", "plain_ms_events", "library_ms_events")
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": f32["max_abs_err"],
            # per ControlNet forward (kernel a) or training step (kernel b): every
            # call at its main-path shape, f32; device time (device_time_ms)
            "per": per,
            "ms": f32["ms"], "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
            **{k: f32[k] for k in events},
            "bf16": {"ms": bf16["ms"], "plain_ms": bf16["plain_ms"],
                     "bound_ms": bf16["bound_ms"], "bound_by": bf16["bound_by"],
                     "library_ms": bf16["library_ms"], "max_abs_err": bf16["max_abs_err"],
                     "launches": bf16_launches, **{k: bf16[k] for k in events}},
        }

    fwd_entry = kernel_entry("attention_fwd_t", "controlnet_tpu_torch/csrc/attention_fwd.cu",
                             "controlnet_tpu/ops/pallas_attention.py:36", kern,
                             main_path["float32"]["launches"],
                             main_path["bfloat16"]["launches"], "forward (26 calls)")
    fwd_entry["train_launches"] = train["float32"]["launches"]
    # the latent main path: launches of each run, and the per-forward times at
    # the latent shapes (22 calls, B*H = 256)
    fwd_entry["ldm_launches"] = {f"{mode}_{name}": r["attn_launches"]
                                 for (mode, name), r in ldm["runs"].items()}
    ldm_fwd = kernel_entry("attention_fwd_t", "", "", ldm["attn"],
                           ldm["runs"][("ancestral", "float32")]["attn_launches"],
                           ldm["runs"][("ancestral", "bfloat16")]["attn_launches"],
                           "latent forward (22 calls)")
    fwd_entry["ldm"] = {k: ldm_fwd[k] for k in ("per", "launches", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms", "max_abs_err", "bf16")}
    bwd_entry = kernel_entry("attention_bwd_t", "controlnet_tpu_torch/csrc/attention_bwd.cu",
                             "controlnet_tpu/ops/pallas_attention.py:100", kern_bwd,
                             train["float32"]["bwd_launches"],
                             train["bfloat16"]["bwd_launches"], "training step (18 calls)")
    bwd_entry["max_rel_err"] = kern_bwd[torch.float32]["max_rel_err"]
    bwd_entry["lse_max_abs_err"] = max(t["lse_err"] for t in kern_bwd.values())
    for dtype, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        tot = kern_bwd[dtype]
        bwd_entry[f"d_err_{key}"] = tot["d_err"]
        bwd_entry[f"d_err_from_o_{key}"] = tot["d_err_from_o"]
        bwd_entry[f"sdpa_backends_{key}"] = tot["sdpa_backends"]
    bwd_entry["bf16"]["max_rel_err"] = kern_bwd[torch.bfloat16]["max_rel_err"]
    bwd_entry["bf16"]["source"] = "controlnet_tpu_torch/csrc/attention_bwd_bf16.cu"
    conv_entry = kernel_entry("conv3x3_tl", "controlnet_tpu_torch/csrc/conv3x3_tl.cu",
                              "controlnet_tpu/ops/pallas_conv.py:44", ldm["conv"],
                              ldm["runs"][("ancestral", "float32")]["conv_launches"],
                              ldm["runs"][("ancestral", "bfloat16")]["conv_launches"],
                              "hint encode (7 calls)")
    conv_entry["max_rel_err"] = ldm["conv"][torch.float32]["max_rel_err"]
    conv_entry["bf16"]["max_rel_err"] = ldm["conv"][torch.bfloat16]["max_rel_err"]
    conv_entry["bf16"]["source"] = "controlnet_tpu_torch/csrc/conv3x3_tl_bf16.cu"
    conv_entry["own_ms"] = ldm["conv"][torch.float32]["own_ms"]
    conv_entry["bf16"]["own_ms"] = ldm["conv"][torch.bfloat16]["own_ms"]
    conv_entry["ldm_launches"] = {f"{mode}_{name}": r["conv_launches"]
                                  for (mode, name), r in ldm["runs"].items()}
    fwd_entry["serve_launches"] = served["launches_a"]
    # kernel d: launches of the served requests (24 per model call); times per
    # MNIST forward at the server's largest bucket, then at batch 64 and per
    # latent forward at batch 16, each beside the split path's time
    proj_entry = kernel_entry("attention_proj", "controlnet_tpu_torch/csrc/attention_proj.cu",
                              "controlnet_tpu/ops/pallas_attention.py:358", proj16,
                              served["launches_d"], None,
                              f"MNIST forward at batch {SERVE_BATCH} (24 calls)")
    keys = ("ms", "plain_ms", "split_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
            "max_rel_err", "ms_events", "plain_ms_events", "split_ms_events",
            "library_ms_events")
    proj_entry["split_ms"] = proj16[torch.float32]["split_ms"]
    proj_entry["max_rel_err"] = proj16[torch.float32]["max_rel_err"]
    proj_entry["bf16"] = {k: proj16[torch.bfloat16][k] for k in keys}
    # no served run computes in bf16; these are the counts of the one fused
    # MNIST forward of each dtype at batch 64, read from the counter around it
    proj_entry["fused_forward_launches"] = fused_launches
    for name, tots in ((f"batch{BATCH}", proj64), ("ldm", ldm["proj"])):
        proj_entry[name] = {str(dtype)[6:]: {k: tots[dtype][k] for k in keys}
                            for dtype in (torch.float32, torch.bfloat16)}
    proj_entry["served"] = {k: served[k] for k in (
        *(f"steps{n}" for n in SERVE_STEPS), "on_ms", "off_ms", "ddim_ms", "batched",
        "unbatched", "profile_on", "profile_off")}
    for entry, kernel in ((fwd_entry, "a"), (bwd_entry, "b"), (conv_entry, "c"),
                          (proj_entry, "d")):
        entry["sass"] = {k: v for k, v in sass.items() if k.startswith(kernel + " ")}
    fwd_entry["sdpa_backends"] = {str(d)[6:]: kern[d]["sdpa_backends"] for d in kern}
    log(f"device_time_ms: {PROFILER_WINDOWS['windows']} profiler windows for "
        f"{PROFILER_WINDOWS['measurements']} measurements (2 each when no window lost records), "
        f"{PROFILER_WINDOWS['foreign']} device records left out as launched outside a window")
    log(json.dumps({"kernels": [fwd_entry, bwd_entry, conv_entry, proj_entry]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
