"""The multi-device training run: data parallelism and Megatron tensor
parallelism over a 2-D (data, model) mesh.

Counterpart of the JAX package's ``dryrun_multichip``: a tiny ControlNet
trained for 20 steps over every rank of the group, the batch split over the
data axis and, on 4 or more ranks (an even count), the parameters sharded
over a model axis of 2 (``parallel/tp.py``).  The loss must decrease.

    python -m torch.distributed.run --nproc_per_node N \\
        -m controlnet_tpu_torch.parallel.dryrun [--device cpu]

Runs on the card (``cuda:{LOCAL_RANK}``, NCCL) unless it is given
``--device cpu`` (gloo).
"""

from __future__ import annotations

import argparse

import torch

TINY_MODEL_CONFIG = dict(
    im_channels=1,
    im_size=8,
    hint_channels=3,
    down_channels=[8, 16, 16],
    mid_channels=[16, 16],
    down_sample=[True, False],
    time_emb_dim=8,
    num_down_layers=1,
    num_mid_layers=1,
    num_up_layers=1,
    num_heads=2,
)
STEPS = 20
PER_RANK_BATCH = 2


def dryrun_multichip(n_devices: int, device=None, steps: int = STEPS) -> dict:
    """Train the tiny ControlNet for ``steps`` steps over the ``n_devices``
    ranks of the process group (joined from torchrun's environment when it
    is not up yet); returns the losses and the mesh's shape.  Raises when
    the loss does not decrease."""
    from controlnet_tpu_torch import cli
    from controlnet_tpu_torch.device import resolve_device
    from controlnet_tpu_torch.models.controlnet import ControlNet
    from controlnet_tpu_torch.parallel.mesh import make_mesh
    from controlnet_tpu_torch.parallel.tp import tp_shard_params
    from controlnet_tpu_torch.schedules.linear import make_linear_schedule
    from controlnet_tpu_torch.train.loops import make_controlnet_train_step
    from controlnet_tpu_torch.train.state import create_train_state

    device = resolve_device(device)
    model_parallel = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh(device=device, model_parallel=model_parallel)
    if mesh.world_size != n_devices:
        raise ValueError(f"the process group has {mesh.world_size} ranks, not {n_devices}")
    torch.manual_seed(0)
    cn = ControlNet(1, TINY_MODEL_CONFIG, model_locked=True).to(device)
    cli.put_replicated(cn, mesh)
    if model_parallel > 1:
        tp_shard_params(cn, mesh)
    trainable, _ = cn.freeze_trunk()
    state = create_train_state(trainable, 2e-3, mesh=mesh)
    step = make_controlnet_train_step(cn, make_linear_schedule(50, 1e-4, 0.02, device=device))

    b = PER_RANK_BATCH * n_devices
    size = TINY_MODEL_CONFIG["im_size"]
    # structured (learnable) images, not zeros: the loss must have signal
    images = torch.linspace(-1, 1, size, device=device)[None, None, :, None].expand(
        b, 1, size, size).contiguous()
    hints = torch.zeros((b, 3, size, size), device=device)
    images, hints = cli.put_batch((images, hints), mesh)
    generator = torch.Generator(device=device).manual_seed(1)
    losses = [step(state, images, hints, generator).item() for _ in range(steps)]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if not all(torch.isfinite(torch.tensor(losses))) or not last < first:
        raise AssertionError(f"sharded training loss did not decrease: {first} -> {last}")
    layout = ("batch over the data axis, parameters Megatron-TP over the model axis"
              if model_parallel > 1 else "batch over the data axis")
    cli.say(mesh, f"dryrun_multichip OK on {n_devices} ranks (mesh ({mesh.data_size}, "
                  f"{model_parallel}), {layout}, {steps} steps, loss {first:.5f} -> {last:.5f})")
    return {"losses": losses, "mesh": (mesh.data_size, model_parallel)}


def main(argv=None) -> None:
    import os

    parser = argparse.ArgumentParser(description="multi-device ControlNet training run")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    dryrun_multichip(int(os.environ.get("WORLD_SIZE", "1")), args.device)


if __name__ == "__main__":
    main()
