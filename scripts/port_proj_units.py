#!/usr/bin/env python3
"""Time kernel d (both types) beside the split path, F.mha, its plain version
and its bound at its four units, with a checkout's own ``chip_smoke.py``: the
served MNIST call (batch 16), the MNIST forward at batch 64, the latent
forward (batch 16) and the CIFAR-10 forward (batch 64), in one fresh process
as chip_smoke.py does.  ROOT is this checkout or another one whose
chip_smoke.py has ``phase_proj_kernels`` and fresh timing processes (say the
parent commit unpacked by ``git archive`` into an ignored directory), so
that two versions can be timed in turns in one call on one card; each line
of the result names LABEL.

    python3 scripts/port_proj_units.py ROOT LABEL [--phases]

``--phases`` first prints ROOT's kernel d clock cycles a block by phase at
every shape (its ``scripts/port_attention_proj_check.py``'s ``phases``).
"""

import os
import sys


def main() -> None:
    root, label = os.path.abspath(sys.argv[1]), sys.argv[2]
    os.chdir(root)
    sys.path[:0] = [root, os.path.join(root, "scripts")]
    import torch

    import chip_smoke as cs
    from controlnet_tpu_torch.ops import _build

    _build.build()
    print(f"{label}: card {cs.nvidia_smi_line()}", flush=True)
    if "--phases" in sys.argv:
        import port_attention_proj_check as check

        check.phases(cs.SERVE_BATCH, torch.device("cuda"))
    cs.start_fork_server()
    units = (("served MNIST call", cs.MNIST_PROJ_SHAPES, cs.SERVE_BATCH),
             ("MNIST forward", cs.MNIST_PROJ_SHAPES, cs.BATCH),
             ("latent forward", cs.LDM_PROJ_SHAPES, cs.LDM_BATCH),
             ("CIFAR forward", cs.CIFAR_PROJ_SHAPES, cs.BATCH))
    totals = cs.in_fresh_processes(*(("phase_proj_kernels", (shapes, batch), dict(what=what))
                                     for what, shapes, batch in units))
    for (what, _, batch), tot in zip(units, totals):
        for dtype, t in tot.items():
            print(f"UNIT {label} d {str(dtype)[6:]:8s} {what} (batch {batch}): kernel "
                  f"{t['ms']:.4f} ms, split path {t['split_ms']:.4f} ms, F.mha "
                  f"{t['library_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']}), max rel err {t['max_rel_err']:.4g}",
                  flush=True)


if __name__ == "__main__":  # the fork server's children import this module again
    main()
