#!/usr/bin/env python3
"""Build the port's CUDA kernels with ptxas's report and count each kernel's
tensor-core instructions, then hold the fused projection + attention kernel
(kernel d, controlnet_tpu_torch/csrc/attention_proj.cuh) against its plain
version, and time it beside the split path, F.multi_head_attention_forward and
its bound, at the six MNIST and the seven latent self-attention shapes on one
CUDA card (and check it at the six CIFAR-10 ones and at head dims 72-128 off
the model paths), with the launch plan (rows per block, cluster, shared memory) of
each shape.

    python3 scripts/port_attention_proj_check.py [--batch 16] [--serve] [--phases] [--attention]
    python3 scripts/port_attention_proj_check.py --check-only

``--serve`` also runs the full-width MNIST forward with the fused layer on
and the serve tool's phase; ``--phases`` prints kernel d's clock cycles per
block by phase (``cuda_attention_proj.phase_profile``) at every shape, and
with ``--attention`` kernels a's and b's in bf16 (``cuda_attention.
phase_profile`` / ``phase_profile_bwd``) at the MNIST (784, 784, 16), latent
(1024, 1024, 24) and cross (1024, 77, 24) shapes; ``--attention`` prints
the host cost of a bf16 launch of kernel a on the TMA and cp.async routes
(``host_cost``: the tensor maps' encoding), then checks and times kernel a
(both types) at the MNIST and latent shapes beside SDPA, and kernel b at the
same shapes beside SDPA's backward.  ``--check-only`` times nothing: it holds kernel d
against its plain version once at every shape (batch 16 and 64) and in bf16
at ``chip_smoke.PROJ_EDGE_SHAPES`` (three layouts of x, two calls bit-equal),
kernel a (both types, with its saved log-sum-exp) at the MNIST, latent and CIFAR-10
attention shapes, and kernel b (both types, with its row term D against rowsum(dP o P)
from float32 P) at the MNIST and CIFAR-10 attention shapes and the cross
shape; both also at head dims 80, 100 and 128 off the model paths, which is
the quick first call after a change to any of the three.
``scripts/port_proj_units.py`` times d at its four units.  The shapes and the checks are chip_smoke.py's.
"""

import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from controlnet_tpu_torch.ops import _build  # noqa: E402


# kernel a's (L, head_dim, calls per forward) on the MNIST (batch 64) and latent
# (batch 16) forwards, B*H 256 in both
A_MNIST = ((784, 16, 4), (784, 4, 2), (196, 32, 4), (196, 8, 2), (49, 64, 8), (49, 32, 4),
           (49, 16, 2))
A_LATENT = ((1024, 24, 4), (1024, 8, 2), (256, 32, 4), (256, 16, 2), (64, 48, 4), (64, 24, 2),
            (16, 32, 4))
# and on the CIFAR-10 forward (batch 64, config/cifar.yaml): head dims up to 128
A_CIFAR = ((1024, 32, 4), (1024, 4, 2), (256, 64, 4), (256, 16, 2), (64, 128, 8), (64, 64, 4),
           (64, 32, 2))
# head dims past 64 off the model paths: ragged (80 and 100 pad to 96 and 128
# in bf16, to 128 in float32) and a cross shape
WIDE_SHAPES = [(49, 49, 80, 256), (49, 49, 100, 256), (64, 7, 128, 256)]
A_SHAPES = ([(l, l, dh, 256) for l, dh, _ in A_MNIST + A_LATENT + A_CIFAR]
            + [(*chip_smoke.CROSS_SHAPE, 64)] + WIDE_SHAPES)


def check_only(device) -> None:
    """Each kernel once against its plain version at every shape; no timing."""
    from controlnet_tpu_torch.ops import cuda_attention

    for batch, shapes in ((chip_smoke.SERVE_BATCH, chip_smoke.MNIST_PROJ_SHAPES),
                          (chip_smoke.BATCH, chip_smoke.MNIST_PROJ_SHAPES),
                          (chip_smoke.LDM_BATCH, chip_smoke.LDM_PROJ_SHAPES),
                          (chip_smoke.BATCH, chip_smoke.CIFAR_PROJ_SHAPES),
                          (chip_smoke.SERVE_BATCH, chip_smoke.PROJ_WIDE_SHAPES)):
        chip_smoke.phase_proj_checks(shapes, batch, device)  # raises on a disagreement
    chip_smoke.phase_proj_edges(device)
    failed = []
    for lq, lk, dh, bh in A_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=device).manual_seed(chip_smoke.SEED)
            q = torch.randn((bh // 4, 4, dh, lq), generator=g, device=device).to(dtype)
            k, v = (torch.randn((bh // 4, 4, dh, lk), generator=g, device=device).to(dtype)
                    for _ in range(2))
            with torch.inference_mode():
                out, _, lse = cuda_attention.forward_for_backward(q, k, v)
                ref = cuda_attention.fused_attention_t_plain(q, k, v)
                s = torch.einsum("bhdq,bhdk->bhqk", q.float(), k.float()) / dh ** 0.5
                lse_err = (lse - torch.logsumexp(s, -1)).abs().max().item()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ok = err <= chip_smoke.KERNEL_TOL[dtype] and lse_err <= chip_smoke.LSE_TOL
            print(f"a {str(dtype)[6:]:8s} Lq {lq:4d} Lk {lk:4d} dh {dh:2d} BH {bh}: err {err:.3g} "
                  f"(tol {chip_smoke.KERNEL_TOL[dtype]:g}), lse err {lse_err:.3g} (tol "
                  f"{chip_smoke.LSE_TOL:g}) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failed.append(("a", lq, lk, dh, dtype))
    b_shapes = ([(l, l, dh, 256) for l, dh, _ in A_MNIST + A_CIFAR]
                + [(*chip_smoke.CROSS_SHAPE, 256)] + WIDE_SHAPES)
    for lq, lk, dh, bh in b_shapes:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=device).manual_seed(chip_smoke.SEED)
            q, dout = (torch.randn((64, bh // 64, dh, lq), generator=g, device=device).to(dtype)
                       for _ in range(2))
            k, v = (torch.randn((64, bh // 64, dh, lk), generator=g, device=device).to(dtype)
                    for _ in range(2))
            delta = torch.empty((64, bh // 64, lq), device=device)
            _, saved, lse = cuda_attention.forward_for_backward(q, k, v)
            got = cuda_attention._launch_bwd(q, k, v, saved, lse, dout, delta)
            ref = cuda_attention.fused_attention_t_bwd_plain(q, k, v, dout)
            probs = torch.softmax(torch.einsum("bhdq,bhdk->bhqk", q.float(), k.float())
                                  / dh ** 0.5, -1)
            d_ref = (torch.einsum("bhdq,bhdk->bhqk", dout.float(), v.float()) * probs).sum(-1)
            torch.cuda.synchronize()
            err = max(((a.float() - r.float()).abs().max() / r.float().abs().max()).item()
                      for a, r in zip(got, ref))
            d_err = ((delta - d_ref).abs().max() / d_ref.abs().max()).item()
            ok = err <= chip_smoke.BWD_KERNEL_TOL[dtype] and d_err <= chip_smoke.D_TOL
            print(f"b {str(dtype)[6:]:8s} Lq {lq:4d} Lk {lk:4d} dh {dh:2d} BH {bh}: rel err "
                  f"{err:.3g} (tol {chip_smoke.BWD_KERNEL_TOL[dtype]:g}), D err {d_err:.3g} of "
                  f"max|D| (tol {chip_smoke.D_TOL:g}) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failed.append(("b", lq, lk, dh, dtype))
    if failed:
        raise SystemExit(f"kernels disagree with their plain versions: {failed}")


def phases(batch: int, device) -> None:
    """Kernel d's cycles per block by phase (thread 0's clock64), each shape."""
    from controlnet_tpu_torch.ops import cuda_attention_proj as proj

    for l, c, heads, _ in (chip_smoke.MNIST_PROJ_SHAPES + chip_smoke.LDM_PROJ_SHAPES
                           + chip_smoke.CIFAR_PROJ_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            xt, *params = chip_smoke.proj_inputs(batch, l, c, dtype, device)
            proj.phase_profile(xt.transpose(1, 2), *params, heads)  # warm
            prof = proj.phase_profile(xt.transpose(1, 2), *params, heads)
            total = sum(prof[p] for p in proj.phases(dtype))
            print(f"phases d {str(dtype)[6:]:8s} L {l:4d} C {c:3d}: {prof['blocks']} blocks, "
                  f"{total:.0f} cycles a block: " + ", ".join(
                      f"{p} {prof[p]:.0f} ({prof[p] / total:.0%})" for p in proj.phases(dtype)),
                  flush=True)


# kernels a and b's phase profiles: (what, Lq, Lk, head dim), B*H 256 as on the
# MNIST (batch 64) and latent / conditional (batch 16) paths
ATTENTION_PHASE_SHAPES = (("MNIST", 784, 784, 16), ("latent", 1024, 1024, 24),
                          ("cross", 1024, 77, 24))


def attention_phases(device) -> None:
    """Kernels a's and b's bf16 cycles per block by phase (thread 0's
    clock64; ``cuda_attention.phase_profile`` / ``phase_profile_bwd``)."""
    from controlnet_tpu_torch.ops import cuda_attention as ca

    def line(name: str, prof: dict, phases: tuple) -> str:
        total = sum(prof[p] for p in phases)
        return (f"{name}: {prof['blocks']} blocks, {total:.0f} cycles a block: " + ", ".join(
            f"{p} {prof[p]:.0f} ({prof[p] / total:.0%})" for p in phases))

    for what, lq, lk, dh in ATTENTION_PHASE_SHAPES:
        g = torch.Generator(device=device).manual_seed(chip_smoke.SEED)
        q, dout = (torch.randn((64, 4, dh, lq), generator=g, device=device).bfloat16()
                   for _ in range(2))
        k, v = (torch.randn((64, 4, dh, lk), generator=g, device=device).bfloat16()
                for _ in range(2))
        ca.phase_profile(q, k, v)  # warm
        shape = f"Lq {lq:4d} Lk {lk:4d} dh {dh}"
        print("phases a bf16 " + line(f"{what} {shape}", ca.phase_profile(q, k, v), ca.PHASES_A),
              flush=True)
        print("phases b bf16 " + line(f"{what} {shape}", ca.phase_profile_bwd(q, k, v, dout),
                                      ca.PHASES_B), flush=True)


def host_cost(device, calls: int = 2000) -> None:
    """Host microseconds a bf16 launch of kernel a takes (no synchronise; the
    device work at these shapes is shorter), on the TMA route (L 64: three
    tensor maps encoded a call) and on the 8-byte cp.async route (L 60: none):
    the difference is the encoding's cost."""
    import time

    from controlnet_tpu_torch.ops import cuda_attention

    for length in (64, 60, 64, 60):
        q, k, v = (torch.randn((1, 4, 16, length), device=device).bfloat16() for _ in range(3))
        for _ in range(50):
            cuda_attention._launch(q, k, v)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            cuda_attention._launch(q, k, v)
        host_us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        route = cuda_attention.ROUTES[cuda_attention.loader_vec(length, [4 * 16 * length],
                                                                [q.data_ptr()])]
        print(f"host a bf16 L {length} ({route}): {host_us:.2f} us a launch over {calls}",
              flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description="check and time the fused layer kernel alone")
    parser.add_argument("--batch", type=int, default=chip_smoke.SERVE_BATCH)
    parser.add_argument("--serve", action="store_true",
                        help="also run the fused MNIST forward and the serve phase")
    parser.add_argument("--check-only", action="store_true",
                        help="kernels d and a against their plain versions once; no timing")
    parser.add_argument("--phases", action="store_true",
                        help="also print kernel d's cycles per block by phase at every shape "
                             "(with --attention also kernels a's and b's, bf16)")
    parser.add_argument("--attention", action="store_true",
                        help="also check and time kernel a at the MNIST and latent shapes")
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    print(f"card: {chip_smoke.nvidia_smi_line()}; torch {torch.__version__}", flush=True)
    _build.build(verbose=True)
    chip_smoke.phase_sass(chip_smoke.start_sass(str(_build.LIB_PATH), _build._nvcc()))
    if args.check_only:
        check_only(device)
        return
    if args.phases:
        phases(args.batch, device)
        if args.attention:
            attention_phases(device)
    if args.attention:
        host_cost(device)
        for what, mix in (("MNIST", A_MNIST), ("latent", A_LATENT)):
            shapes = [(l, l, dh, 256) for l, dh, n in mix for _ in range(n)]
            batch = 64 if what == "MNIST" else 16
            cross = ((1024, 77, 24),) if what == "latent" else ()
            print(f"kernel a, {what} forward:", flush=True)
            chip_smoke.phase_kernels(shapes, device, batch=batch, cross=cross)
            print(f"kernel b, {what} forward's shapes:", flush=True)
            chip_smoke.phase_kernels_bwd(shapes, device, batch=batch, cross=cross,
                                         per=f"{what} forward's shapes")
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
