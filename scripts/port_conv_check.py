#!/usr/bin/env python3
"""Kernel c (the 3x3 transposed-layout conv: csrc/conv3x3_tl.cu in float32,
csrc/conv3x3_tl_bf16.cuh in bf16) alone on one CUDA card.

    python3 scripts/port_conv_check.py [--batch 16] [--check-only] [--phases] [--sweep [f32|bf16|both]]
    python3 scripts/port_conv_check.py ROOT LABEL [ROOT LABEL ...]

Without ROOTs the script builds the port's kernels with ptxas's register and
spill report (and fails if an instantiation of c, f32 or bf16, spills or
keeps a stack frame), counts each kernel's tensor-core and TMA instructions,
then:

- ``--check-only`` times nothing: c in both types against its plain version
  once at every shape of its four units (``units``) and chip_smoke.py's two
  off-path shapes (the ragged one and one whose tiles straddle images), each
  twice for equal bits (both types add the parts of a split over the input
  channels in a fixed order): the quick first call after a change to the
  kernel;
- ``--sweep`` gives the device time of every tile configuration and channel
  split at every shape, the kernel's own launches only, beside the
  planner's estimate and its pick: f32 (``cuda_conv.f32_plan``), bf16 (the
  wgmma kernel's ``cuda_conv.bf16_plan``: warpgroups, channel tile, split,
  the ring as the planner sets it, where W <= 63; and the mma.sync
  kernel's plan everywhere) or both;
- ``--phases`` prints bf16 c's wgmma kernel's clock64 cycles a block by
  phase (``cuda_conv.phase_profile``) at every shape it takes;
- none of them runs chip_smoke.py's phase 10 alone (the hint encode, both
  types).

With ROOT LABEL pairs it times c at its four units with each checkout's own
chip_smoke.py (``phase_conv_kernels`` in a fresh process): the hint encode
(with the off-path shapes), the MNIST ControlNet and UNet TL forwards at
batch 64 and the latent ControlNet TL forward at batch 16.  ROOT is this
checkout or another (say the parent commit unpacked by ``git archive`` into
an ignored directory); with several, each runs in a process of its own, in
turns (the order given, then the reverse), so that versions are compared in
one call on one card.  Each run prints a ``SHAPE`` line per shape and a
``UNIT`` line per unit and type (device ms of the kernel, its own launches,
the plain version, F.conv2d and the bound), then a ``TURNS`` table of the
kernel's times, one column a run.
"""

import argparse
import contextlib
import io
import itertools
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (Cin, Cout, H, W) -> (calls a MNIST ControlNet forward_tl, calls a UNet
# forward_tl) at batch 64 (what chip_smoke.tl_conv_shapes records)
MNIST_TL = {
    (1, 32, 28, 28): (2, 1), (32, 64, 28, 28): (2, 1), (64, 64, 28, 28): (6, 3),
    (64, 128, 14, 14): (2, 1), (128, 128, 14, 14): (6, 3), (128, 256, 7, 7): (2, 1),
    (256, 256, 7, 7): (18, 9), (256, 128, 7, 7): (2, 1), (128, 128, 7, 7): (10, 5),
    (256, 64, 7, 7): (1, 1), (64, 64, 7, 7): (3, 3), (128, 32, 14, 14): (1, 1),
    (32, 32, 14, 14): (3, 3), (64, 16, 28, 28): (1, 1), (16, 16, 28, 28): (3, 3),
    (16, 1, 28, 28): (1, 1)}
# (Cin, Cout, H, W) -> calls a latent ControlNet forward_tl at batch 16
LATENT_TL = {
    (4, 256, 32, 32): 2, (256, 384, 32, 32): 2, (384, 384, 32, 32): 6, (384, 512, 16, 16): 2,
    (512, 512, 16, 16): 6, (512, 768, 8, 8): 2, (768, 768, 8, 8): 6, (768, 512, 4, 4): 2,
    (512, 512, 4, 4): 10, (1024, 384, 8, 8): 1, (384, 384, 8, 8): 3, (768, 256, 16, 16): 1,
    (256, 256, 16, 16): 3, (512, 128, 32, 32): 1, (128, 128, 32, 32): 3, (128, 4, 32, 32): 1}
MNIST_BATCH, LATENT_BATCH = 64, 16


def units(cs) -> list:
    """(name, shapes with repeats, phase_conv_kernels kwargs) of c's four
    units; the hint encode's shapes from ``cs`` (a chip_smoke module)."""
    def calls(table, batch, col=None):
        return [s + (batch,) for s, n in table.items()
                for _ in range(n if col is None else n[col])]

    return [("hint encode", cs.hint_conv_shapes(1024, 3, 256, 32, cs.LDM_BATCH), {}),
            ("MNIST ControlNet TL forward", calls(MNIST_TL, MNIST_BATCH, 0), {"off_path": []}),
            ("MNIST UNet TL forward", calls(MNIST_TL, MNIST_BATCH, 1), {"off_path": []}),
            ("latent ControlNet TL forward", calls(LATENT_TL, LATENT_BATCH), {"off_path": []})]


def distinct_shapes(cs) -> list:
    """Every distinct (Cin, Cout, H, W, B) of the four units, then the two
    off-path ones (the ragged shape and the one whose tiles straddle images)."""
    seen: dict = {}
    for _, shapes, _ in units(cs):
        seen.update(dict.fromkeys(shapes))
    return list(seen) + [tuple(cs.RAGGED_CONV_SHAPE), tuple(cs.STRADDLE_CONV_SHAPE)]


# The one instantiation of c allowed to spill: the mma.sync kernel's
# 16-channel tile, whose four blocks an SM (64 registers) spill 60 bytes and
# run the byte-bound 3 -> 16 stem at 1024^2 faster than three spill-free ones
# (0.6462 / 0.6476 against 0.7149 / 0.7145 ms in turns on an H100 80GB HBM3
# at 700.00 W; PERF.md, section 6).
SPILL_ALLOWED = ("conv3x3_tl_bf16_mma_kernelILi16E",)


def spill_report(report: str) -> list:
    """Print the registers, stack frame and spill bytes of every instantiation
    of c (f32 and bf16, the bf16 split sum included) from ptxas's report;
    return those that spill or keep a stack frame, but for ``SPILL_ALLOWED``
    (the script fails on them once its checks have run)."""
    rows, name = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and ("conv3x3_tl_f32_" in name or "conv3x3_tl_bf16_" in name):
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                          r"spill loads", line)
            if m:
                rows.append([name, *map(int, m.groups()), None])
            m = re.search(r"Used (\d+) registers", line)
            if m and rows and rows[-1][0] == name:
                rows[-1][4] = int(m.group(1))
    for name, stack, stores, loads, regs in rows:
        kind = "f32" if "conv3x3_tl_f32_" in name else "bf16"
        print(f"ptxas c {kind} {name}: {regs} registers, stack frame {stack} B, spill stores "
              f"{stores} B, loads {loads} B", flush=True)
    for kind in ("conv3x3_tl_f32_", "conv3x3_tl_bf16_"):
        if not any(kind in r[0] for r in rows):
            raise SystemExit(f"no {kind} instantiation of kernel c in ptxas's report")
    return [name for name, stack, stores, loads, _ in rows
            if (stack or stores or loads) and not any(a in name for a in SPILL_ALLOWED)]


def conv_inputs(cs, cin, cout, h, w, b, dtype, device):
    """chip_smoke.phase_conv_kernels's seeded inputs: NCHW image, its (C, B,
    L) view, weights and bias."""
    import torch

    from controlnet_tpu_torch.ops import cuda_conv

    g = torch.Generator(device=device).manual_seed(cs.SEED)
    img = torch.randn((b, cin, h, w), generator=g, device=device).to(dtype)
    bound = 1.0 / (9 * cin) ** 0.5
    weight = (torch.rand((cout, cin, 3, 3), generator=g, device=device) * 2 - 1) * bound
    bias = (torch.rand((cout,), generator=g, device=device) * 2 - 1) * bound
    return img, cuda_conv.to_tl(img), weight, bias


def check_only(cs, shapes: list, device) -> None:
    """c in both types against its plain version at every shape, two calls
    bit for bit."""
    import torch

    from controlnet_tpu_torch.ops import cuda_conv

    failed = []
    for cin, cout, h, w, b in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            _, x, weight, bias = conv_inputs(cs, cin, cout, h, w, b, dtype, device)
            with torch.inference_mode():
                before = cuda_conv.launches
                out = cuda_conv.conv3x3_tl(weight, bias, x, (h, w))
                again = cuda_conv.conv3x3_tl(weight, bias, x, (h, w))
                ref = cuda_conv.conv3x3_tl_plain(weight, bias, x, (h, w)).float()
            torch.cuda.synchronize()
            scale = ref.abs().max().item()
            err = (out.float() - ref).abs().max().item() / scale
            same = bool(torch.equal(out, again))
            ok = (cuda_conv.launches == before + 2 and err <= cs.CONV_TOL[dtype] and same
                  and bool(torch.isfinite(out).all()) and out.shape == (cout, b, h * w))
            plan = (cuda_conv.f32_launch_plan(cin, cout, h, w, b) if dtype == torch.float32
                    else cuda_conv.bf16_launch_plan(cin, cout, h, w, b))
            print(f"c {str(dtype)[6:]:8s} {cin:4d}->{cout:3d} @{h}x{w} B {b}: plan {plan}, rel err "
                  f"{err:.3g} (tol {cs.CONV_TOL[dtype]:g}), two calls bit-equal {same} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failed.append((str(dtype)[6:], cin, cout, h, w, b))
            del x, out, again, ref
    if failed:
        raise SystemExit(f"conv kernel disagrees with its plain version at {failed}")


def phases(cs, shapes: list, device) -> None:
    """bf16 c's wgmma kernel's clock64 cycles a block by phase
    (``cuda_conv.phase_profile``) at every shape it takes, with the
    planner's plan."""
    import torch

    from controlnet_tpu_torch.ops import cuda_conv

    names = cuda_conv.PHASES_BF16 + cuda_conv.PRODUCER_PHASES_BF16
    for cin, cout, h, w, b in shapes:
        if w > cuda_conv.BF16_MAX_W:
            continue
        _, x, weight, bias = conv_inputs(cs, cin, cout, h, w, b, torch.bfloat16, device)
        plan = cuda_conv.bf16_wgmma_plan(cin, cout, h, w, b)
        cuda_conv.phase_profile(weight, bias, x, (h, w), plan)  # warm
        prof = cuda_conv.phase_profile(weight, bias, x, (h, w), plan)
        total = sum(prof[p] for p in cuda_conv.PHASES_BF16)
        print(f"phases c bf16 {cin:4d}->{cout:3d} @{h}x{w} B {b} [{plan_key(plan)}]: "
              f"{prof['blocks']} blocks, {total:.0f} cycles a block: "
              + ", ".join(f"{p} {prof[p]:.0f}" for p in names), flush=True)
        del x


def plan_key(plan) -> str:
    """A plan's label: rows x channels (and threads) of a tile, ring, split."""
    if hasattr(plan, "nwg"):
        return f"{64 * plan.nwg}x{plan.bn} st{plan.stages} S{plan.splits}"
    if hasattr(plan, "tco"):
        return f"mma {plan.pixel_tile[0]}x{plan.pixel_tile[1]}x{plan.tco}"
    return f"{plan.tile[0]}x{plan.tile[1]}/{plan.tile[2]}t S{plan.splits}"


def sweep_bf16(cs, shapes: list, device) -> None:
    """Every bf16 wgmma warpgroup count, channel tile and split of the input
    channels (``cuda_conv.bf16_plan``, the ring depth as the planner sets it)
    at every shape it takes, and the mma.sync kernel's plan at every shape:
    device ms of the kernel's own launches (the split sum included), the
    planner's estimate, and where the planner's pick stands."""
    import torch

    from controlnet_tpu_torch.ops import cuda_conv

    for cin, cout, h, w, b in shapes:
        _, x, weight, bias = conv_inputs(cs, cin, cout, h, w, b, torch.bfloat16, device)
        pick = cuda_conv.bf16_launch_plan(cin, cout, h, w, b)
        slabs = -(-cin // cuda_conv.BF16_SLAB)
        plans = {plan_key(mma): mma for mma in [cuda_conv.mma_launch_config(cin, cout, h, w, b)]}
        for nwg, bn in itertools.product((1, 2), cuda_conv.BF16_TILES_N):
            stages = cuda_conv.bf16_stages(nwg, bn, w)
            if w > cuda_conv.BF16_MAX_W or (bn > 16 and bn // 2 >= cout) or stages is None:
                continue
            for splits in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32):
                if splits > slabs or (splits - 1) * -(-slabs // splits) >= slabs:
                    continue
                plan = cuda_conv.bf16_plan(nwg, bn, stages, splits, cin, cout, h, w, b)
                if splits > 1 and plan.m_tiles * plan.n_tiles >= 2 * cuda_conv.SMS * plan.per_sm:
                    continue  # enough tiles without a split
                plans[plan_key(plan)] = plan
        plans[plan_key(pick)] = pick
        with torch.inference_mode():
            t = cs.time_calls(**{k: (lambda p=p: cuda_conv._launch(weight, bias, x, (h, w), p))
                                 for k, p in plans.items()})
        own = {k: cs.own_ms(t[f"{k}_names"], "conv3x3_tl_bf16_") for k in plans}
        best = min(own, key=own.get)
        flops = 2.0 * 9 * cin * cout * b * h * w
        for k, plan in plans.items():
            est = (f"estimate {cuda_conv.bf16_plan_us(plan, cin, cout, h, w, b) / 1e3:.4f} ms, "
                   f"blocks {plan.blocks} of {plan.tiles} tiles"
                   if isinstance(plan, cuda_conv.Bf16Plan) else "the mma.sync kernel")
            print(f"SWEEP bf16 {cin}->{cout} @{h}x{w} B {b} | {k}: own {own[k]:.4f} ms "
                  f"({flops / own[k] / 1e9:.2f} TFLOP/s), {est}", flush=True)
        print(f"PICK bf16 {cin}->{cout} @{h}x{w} B {b}: planner {plan_key(pick)} "
              f"{own[plan_key(pick)]:.4f} ms, best {best} {own[best]:.4f} ms "
              f"({own[plan_key(pick)] / own[best]:.3f}x)", flush=True)
        del x


def sweep(cs, shapes: list, device) -> None:
    """Every f32 tile configuration and split of the input channels at every
    shape: device ms of the kernel's own launches (time_calls), the planner's
    estimate, and where the planner's pick stands."""
    import torch

    from controlnet_tpu_torch.ops import cuda_conv

    for cin, cout, h, w, b in shapes:
        _, x, weight, bias = conv_inputs(cs, cin, cout, h, w, b, torch.float32, device)
        m = b * h * w
        pick = cuda_conv.f32_launch_plan(cin, cout, h, w, b)
        plans = {}
        for tile in cuda_conv.F32_TILES:
            for splits in cuda_conv.F32_SPLITS:
                plan = cuda_conv.f32_plan(tile, splits, cin, cout, m)
                if (splits - 1) * plan.channels_per_split >= cin:
                    continue
                if splits > 1 and plan.grid[0] >= 8 * cuda_conv.SMS:
                    continue  # enough blocks without a split
                plans[plan_key(plan)] = plan
        key_of_pick = plan_key(pick)
        plans[key_of_pick] = pick
        with torch.inference_mode():
            t = cs.time_calls(**{k: (lambda p=p: cuda_conv._launch(weight, bias, x, (h, w), p))
                                 for k, p in plans.items()})
        own = {k: cs.own_ms(t[f"{k}_names"], "conv3x3_tl_f32_") for k in plans}
        best = min(own, key=own.get)
        flops = 2.0 * 9 * cin * cout * m
        for k, plan in plans.items():
            print(f"SWEEP {cin}->{cout} @{h}x{w} B {b} | {k}: own {own[k]:.4f} ms "
                  f"({flops / own[k] / 1e9:.2f} TFLOP/s), estimate "
                  f"{cuda_conv.f32_plan_us(plan, cout, m) / 1e3:.4f} ms, blocks "
                  f"{plan.grid[0] * plan.splits}", flush=True)
        print(f"PICK {cin}->{cout} @{h}x{w} B {b}: planner {key_of_pick} {own[key_of_pick]:.4f} "
              f"ms, best {best} {own[best]:.4f} ms ({own[key_of_pick] / own[best]:.3f}x)",
              flush=True)
        del x


# a per-shape log line of chip_smoke.phase_conv_kernels
SHAPE_LINE = re.compile(
    r"conv3x3_tl (\S+)\s+(\d+)->\s*(\d+) @(\d+)x(\d+) B (\d+):.*\| device: kernel ([\d.]+) ms, "
    r"its own launch ([\d.]+) ms.*plain ([\d.]+) ms, F\.conv2d ([\d.]+) ms, bound ([\d.]+) ms")
UNIT_LINE = re.compile(r"conv3x3_tl (\S+) per (.+?) \(\d+ calls\)")
RESULT = re.compile(r"^(SHAPE|UNIT) (\S+) c (\S+)\s+(.*?): kernel ([\d.]+) ms")


def shape_lines(log: str) -> dict:
    """(dtype, unit) -> the per-shape figures phase_conv_kernels logged for
    it: each unit's shape lines come before its total line."""
    out, pending = {}, []
    for line in log.splitlines():
        m = SHAPE_LINE.search(line)
        if m:
            pending.append(m.groups())
            continue
        m = UNIT_LINE.search(line)
        if m:
            out[m.groups()] = pending
            pending = []
    return out


class _Tee(io.StringIO):
    """Keeps what is written and passes it on to the real stdout."""

    def write(self, text):
        sys.__stdout__.write(text)
        sys.__stdout__.flush()
        return super().write(text)


def run_one(root: str, label: str) -> None:
    """Time c at its four units with ROOT's chip_smoke.py (in this process)."""
    os.chdir(root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from controlnet_tpu_torch.ops import _build

    _build.load()  # built from ROOT's sources where missing or stale
    print(f"{label}: card {cs.nvidia_smi_line()}", flush=True)
    cs.start_fork_server()
    todo = units(cs)
    log = _Tee()
    with contextlib.redirect_stdout(log):
        totals = cs.in_fresh_processes(*(("phase_conv_kernels", (shapes,), dict(kw, what=what))
                                         for what, shapes, kw in todo))
    by_unit = shape_lines(log.getvalue())
    # the off-path shapes of ROOT's chip_smoke.py (a parent may lack the straddling one)
    off_shapes = [cs.RAGGED_CONV_SHAPE] + ([cs.STRADDLE_CONV_SHAPE]
                                           if hasattr(cs, "STRADDLE_CONV_SHAPE") else [])
    off = {tuple(str(v) for v in sh) for sh in off_shapes}
    for (what, shapes, _), tot in zip(todo, totals):
        for dtype, t in tot.items():
            name = str(dtype)[6:]
            wanted = list(dict.fromkeys(shapes)) + (off_shapes if what == "hint encode" else [])
            for shape in wanted:
                key = tuple(str(v) for v in shape)
                for _, *sh, ms, own, plain, lib, bound in by_unit.get((name, what), []):
                    if tuple(sh) == key:
                        n = shapes.count(tuple(shape))
                        where = "off the main path" if key in off and not n else f"x{n}"
                        print(f"SHAPE {label} c {name:8s} {what} {shape[0]}->{shape[1]} "
                              f"@{shape[2]}x{shape[3]} B {shape[4]} {where}: kernel {ms} ms, "
                              f"own {own} ms, plain {plain} ms, F.conv2d {lib} ms, bound {bound} ms",
                              flush=True)
                        break
            print(f"UNIT {label} c {name:8s} {what} ({len(shapes)} calls): kernel {t['ms']:.4f} ms, "
                  f"own {t['own_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, F.conv2d "
                  f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), max "
                  f"rel err {t['max_rel_err']:.4g}", flush=True)


def in_turns(pairs: list) -> None:
    """Each (ROOT, LABEL) in a process of its own, in turns, then the table."""
    order = pairs + pairs[::-1]
    results: dict = {}
    for root, label in order:
        cmd = [sys.executable, os.path.abspath(__file__), root, label]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            print(line, end="", flush=True)
            m = RESULT.match(line)
            if m:
                kind, lab, dtype, what, ms = m.groups()
                results.setdefault((kind, dtype, what), {}).setdefault(lab, []).append(float(ms))
        if proc.wait() != 0:
            raise SystemExit(f"{label} ({root}) failed: exit code {proc.returncode}")
    labels = [label for _, label in pairs]
    print("in turns, device ms of kernel c (each run): " + " | ".join(labels), flush=True)
    for (kind, dtype, what), by_label in results.items():
        cells = " | ".join(" / ".join(f"{v:.4f}" for v in by_label.get(label, []))
                           for label in labels)
        print(f"TURNS {kind} {dtype:8s} {what}: {cells}", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description="check and time the conv kernel alone")
    parser.add_argument("pairs", nargs="*", help="ROOT LABEL [ROOT LABEL ...]: time in turns")
    parser.add_argument("--batch", type=int, default=None,
                        help="the hint encode's batch (chip_smoke.LDM_BATCH)")
    parser.add_argument("--check-only", action="store_true",
                        help="both types against the plain version; no timing")
    parser.add_argument("--phases", action="store_true",
                        help="bf16 c's clock64 cycles a block by phase at every shape")
    parser.add_argument("--sweep", choices=("f32", "bf16", "both"), nargs="?", const="both",
                        help="time every tile configuration and split of a type (after the "
                             "check; both types by default)")
    args = parser.parse_args()
    if args.pairs:
        if len(args.pairs) % 2:
            raise SystemExit("ROOT LABEL pairs expected")
        pairs = [(os.path.abspath(args.pairs[i]), args.pairs[i + 1])
                 for i in range(0, len(args.pairs), 2)]
        if len(pairs) == 1:
            run_one(*pairs[0])
        else:
            in_turns(pairs)
        return

    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from controlnet_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    print(f"card: {cs.nvidia_smi_line()}; torch {torch.__version__}", flush=True)
    _build.build(verbose=True)
    spills = spill_report(_build.ptxas_report)
    cs.phase_sass(cs.start_sass(str(_build.LIB_PATH), _build._nvcc()))
    if args.check_only:
        check_only(cs, distinct_shapes(cs), device)
    if args.phases:
        phases(cs, distinct_shapes(cs), device)
    if args.sweep in ("f32", "both"):
        sweep(cs, distinct_shapes(cs), device)
    if args.sweep in ("bf16", "both"):
        sweep_bf16(cs, distinct_shapes(cs), device)
    if not (args.check_only or args.sweep or args.phases):
        cs.phase_conv_kernels(cs.hint_conv_shapes(1024, 3, 256, 32, args.batch or cs.LDM_BATCH),
                              device)
    if spills:
        raise SystemExit(f"instantiations of kernel c spill or keep a stack frame: {spills}")


if __name__ == "__main__":  # the fork server's children import this module again
    main()
