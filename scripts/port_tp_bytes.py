#!/usr/bin/env python3
"""Bytes one rank puts through its model group in a tensor-parallel training
step, counted on the CPU from the full-width shapes.

Builds the ControlNet of ``--config`` and shards it as model index 0 of a
model axis of ``--model-parallel`` (``parallel/tp.py``), in a process that
is a gloo group of one: the mesh names the model axis, while its model
group is that one rank, so each collective sums one shard (the values are
wrong).  One forward and one backward of the trainable branch on
``--rows`` rows then hand the collectives tensors of a real step's shapes,
and ``tp.moved_bytes`` counts them (every tensor handed to an all-reduce,
all-gather or reduce-scatter; a bfloat16 sum moves float32).
``chip_smoke.py`` phase 41 reads the same counter on the card at the real
sizes.

    python3 scripts/port_tp_bytes.py --config config/mnist.yaml --rows 32
    python3 scripts/port_tp_bytes.py --config config/celebhq.yaml --rows 1
"""

import argparse
import os
import socket
import sys

import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default=os.path.join(REPO, "config", "mnist.yaml"))
    parser.add_argument("--rows", type=int, default=32, help="rows a data index holds")
    parser.add_argument("--model-parallel", type=int, default=2)
    args = parser.parse_args()

    from controlnet_tpu_torch import config as cfg
    from controlnet_tpu_torch.models.controlnet import ControlNet
    from controlnet_tpu_torch.parallel import tp
    from controlnet_tpu_torch.parallel.mesh import Mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    config = cfg.load_config(args.config)
    mesh = Mesh(rank=0, world_size=args.model_parallel, device=torch.device("cpu"),
                backend="gloo", model_parallel=args.model_parallel)
    b = args.rows
    if "ldm_params" in config:
        ds, ae = cfg.dataset_params(config), cfg.autoencoder_params(config)
        latent = ds["im_size"] // 2 ** sum(bool(d) for d in ae["down_sample"])
        cn = ControlNet(ae["z_channels"], cfg.ldm_params(config),
                        down_sample_factor=ds["canny_im_size"] // latent)
        x = torch.randn(b, ae["z_channels"], latent, latent)
        hint = torch.rand(b, 3, ds["canny_im_size"], ds["canny_im_size"])
    else:
        mp = cfg.model_params(config)
        cn = ControlNet(mp["im_channels"], mp)
        x = torch.randn(b, mp["im_channels"], mp["im_size"], mp["im_size"])
        hint = torch.rand(b, 3, mp["im_size"], mp["im_size"])
    tp.tp_shard_params(cn, mesh)
    cn.freeze_trunk()
    tp.moved_bytes = 0
    out = cn(x, torch.randint(0, 1000, (b,)), hint)
    forward = tp.moved_bytes
    out.square().mean().backward()
    print(f"{os.path.basename(args.config)}, {b} rows, model axis {args.model_parallel}: "
          f"{forward} B forward, {tp.moved_bytes} B a step a rank")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
