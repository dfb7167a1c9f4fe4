#!/usr/bin/env python3
"""Time kernel d (both types) beside the split path, F.mha, its plain version
and its bound at its four units, with each checkout's own ``chip_smoke.py``:
the served MNIST call (batch 16), the MNIST forward at batch 64, the latent
forward (batch 16) and the CIFAR-10 forward (batch 64), in one fresh process
as chip_smoke.py does.  Each ROOT is this checkout or another one whose
chip_smoke.py has ``phase_proj_kernels`` and fresh timing processes (say the
parent commit unpacked by ``git archive`` into an ignored directory); with
several, each runs in a process of its own, in turns (the order given, then
the reverse), so that versions are compared in one call on one card.

    python3 scripts/port_proj_units.py ROOT LABEL [ROOT LABEL ...] [--phases]

Each unit prints one ``SHAPE`` line per layer shape (device ms of the
kernel, the split path and F.mha) and one ``UNIT`` line with its total, each
naming LABEL; with several checkouts a table of every shape's and unit's
kernel times follows, one column a run.  ``--phases`` first prints each
ROOT's kernel d clock cycles a block by phase at every shape (its
``scripts/port_attention_proj_check.py``'s ``phases``).
"""

import contextlib
import io
import os
import re
import subprocess
import sys

# a per-shape log line of phase_proj_kernels (the same in older checkouts)
SHAPE_LINE = re.compile(r"attention_proj (\S+)\s+L\s+(\d+) C\s+(\d+) dh\s+(\d+) B (\d+):.*"
                        r"\| device: kernel ([\d.]+) ms.*split path ([\d.]+) ms, F\.mha ([\d.]+) ms")
RESULT = re.compile(r"^(SHAPE|UNIT) (\S+) d (\S+)\s+(.*?): kernel ([\d.]+) ms, split path "
                    r"([\d.]+) ms, F\.mha ([\d.]+) ms")


class _Tee(io.StringIO):
    """Keeps what is written and passes it on to the real stdout."""

    def write(self, text):
        sys.__stdout__.write(text)
        sys.__stdout__.flush()
        return super().write(text)


def run_one(root: str, label: str, phases: bool) -> None:
    """Time d at the four units with ROOT's chip_smoke.py (in this process)."""
    os.chdir(root)
    sys.path[:0] = [root, os.path.join(root, "scripts")]
    import torch

    import chip_smoke as cs
    from controlnet_tpu_torch.ops import _build

    _build.load()  # built from ROOT's sources where missing or stale
    print(f"{label}: card {cs.nvidia_smi_line()}", flush=True)
    if phases:
        import port_attention_proj_check as check

        check.phases(cs.SERVE_BATCH, torch.device("cuda"))
    cs.start_fork_server()
    units = (("served MNIST call", cs.MNIST_PROJ_SHAPES, cs.SERVE_BATCH),
             ("MNIST forward", cs.MNIST_PROJ_SHAPES, cs.BATCH),
             ("latent forward", cs.LDM_PROJ_SHAPES, cs.LDM_BATCH),
             ("CIFAR forward", cs.CIFAR_PROJ_SHAPES, cs.BATCH))
    log = _Tee()
    with contextlib.redirect_stdout(log):
        totals = cs.in_fresh_processes(*(("phase_proj_kernels", (shapes, batch), dict(what=what))
                                         for what, shapes, batch in units))
    lines = [m.groups() for m in map(SHAPE_LINE.search, log.getvalue().splitlines()) if m]
    for (what, shapes, batch), tot in zip(units, totals):
        for dtype, t in tot.items():
            name = str(dtype)[6:]
            for l, c, heads, calls in shapes:
                dh = str(c // heads)
                for dt, ll, cc, dd, bb, ms, split, mha in lines:
                    if (dt, ll, cc, dd, bb) == (name, str(l), str(c), dh, str(batch)):
                        print(f"SHAPE {label} d {name:8s} {what} ({l}, {c}, {heads}) x{calls} "
                              f"(batch {batch}): kernel {ms} ms, split path {split} ms, F.mha "
                              f"{mha} ms", flush=True)
                        break
            print(f"UNIT {label} d {name:8s} {what} (batch {batch}): kernel "
                  f"{t['ms']:.4f} ms, split path {t['split_ms']:.4f} ms, F.mha "
                  f"{t['library_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}), max rel err {t['max_rel_err']:.4g}",
                  flush=True)


def main() -> None:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    phases = "--phases" in sys.argv
    pairs = [(os.path.abspath(args[i]), args[i + 1]) for i in range(0, len(args), 2)]
    if len(pairs) == 1:
        run_one(*pairs[0], phases)
        return
    # several checkouts: each in a process of its own, in turns
    order = pairs + pairs[::-1]
    results: dict = {}
    for n, (root, label) in enumerate(order):
        cmd = [sys.executable, os.path.abspath(__file__), root, label]
        if phases and n < len(pairs):
            cmd.append("--phases")
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            print(line, end="", flush=True)
            m = RESULT.match(line)
            if m:
                kind, lab, dtype, what, ms = m.groups()[:5]
                results.setdefault((kind, dtype, what), {}).setdefault(lab, []).append(float(ms))
        if proc.wait() != 0:
            raise SystemExit(f"{label} ({root}) failed: exit code {proc.returncode}")
    labels = [label for _, label in pairs]
    print("in turns, device ms of kernel d (each run): " + " | ".join(labels), flush=True)
    for (kind, dtype, what), by_label in results.items():
        cells = " | ".join(" / ".join(f"{v:.4f}" for v in by_label.get(label, []))
                           for label in labels)
        print(f"TURNS {kind} {dtype:8s} {what}: {cells}", flush=True)


if __name__ == "__main__":  # the fork server's children import this module again
    main()
