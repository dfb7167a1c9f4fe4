"""One rank of the four-rank tensor-parallel runs of tests/test_torch_port_tp.py.

    python tests/_torch_port_tp_rank.py WORKDIR RANK WORLD

Joins a gloo group through ``WORKDIR/pg`` (a file rendezvous), builds a
(2, 2) and a (1, 4) mesh on it (every rank creates every subgroup, in the
same order), reads the cases from ``WORKDIR/cases.pt``, runs each one on the
CPU and writes ``WORKDIR/out{RANK}.pt``.  Imports torch and the port only,
never JAX.
"""

import dataclasses
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from controlnet_tpu_torch import cli  # noqa: E402
from controlnet_tpu_torch.parallel.mesh import gather_rows, make_mesh  # noqa: E402
from controlnet_tpu_torch.parallel.tp import tp_full_state_dict, tp_shard_params  # noqa: E402


def _sharded_controlnet(case, mesh, **kw):
    from controlnet_tpu_torch.models.controlnet import ControlNet

    cn = ControlNet(case["im_channels"], case["cfg"], **kw)
    cn.load_state_dict(case["sd"], strict=True)
    plan = tp_shard_params(cn, mesh)
    return cn, plan


def run_cn_train(case, mesh):
    """Train steps of the tiny ControlNet on the (2, 2) mesh with injected
    global draws: losses and the joined weights."""
    from controlnet_tpu_torch.schedules.linear import make_linear_schedule
    from controlnet_tpu_torch.train.loops import make_controlnet_train_step
    from controlnet_tpu_torch.train.state import create_train_state

    cn, plan = _sharded_controlnet(case, mesh)
    trainable, _ = cn.freeze_trunk()
    state = create_train_state(trainable, case["lr"], mesh=mesh)
    step = make_controlnet_train_step(cn, make_linear_schedule(case["T"], 1e-4, 0.02,
                                                               device="cpu"))
    losses = []
    for images, hints, t, noise in case["steps"]:
        images, hints = cli.put_batch((images, hints), mesh)
        losses.append(step(state, images, hints, t=t, noise=noise).item())
    return {"losses": losses, "sd": tp_full_state_dict(cn, mesh),
            "sharded_leaves": sum(d is not None for d in plan.values())}


def run_ldm_forward(case, mesh):
    cn, _ = _sharded_controlnet(case, mesh, down_sample_factor=case["factor"])
    x, hint, t = (v.contiguous() for v in cli.put_batch((case["x"], case["hint"], case["t"]),
                                                        mesh))
    with torch.no_grad():
        return {"out": gather_rows(cn(x, t, hint), mesh)}


def run_vae_encode(case, mesh):
    from controlnet_tpu_torch.models.vae import VAE

    vae = VAE(3, case["cfg"])
    vae.load_state_dict(case["sd"], strict=True)
    tp_shard_params(vae, mesh)
    with torch.no_grad():
        return {"moments": gather_rows(vae.moments(cli.put_batch(case["x"], mesh)), mesh)}


def run_heads(case, mesh):
    """The tiny ControlNet (2 heads, D 8 and 16) on the (1, 4) mesh: a head
    spans two ranks.  Its output and every gradient (the decoder trains too)
    against the same model in this process without TP."""
    from controlnet_tpu_torch.models.controlnet import ControlNet
    from controlnet_tpu_torch.nn.layers import MultiheadAttention

    def run(cn):
        trainable, _ = cn.freeze_trunk()
        out = cn(case["x"], case["t"], case["hint"])
        (out * case["w"]).sum().backward()
        return out.detach(), {k: p.grad for k, p in trainable.items()}

    ref = ControlNet(1, case["cfg"], model_locked=False)
    ref.load_state_dict(case["sd"], strict=True)
    ref_out, ref_grads = run(ref)
    cn, plan = _sharded_controlnet(case, mesh, model_locked=False)
    out, grads = run(cn)
    heads = [m.num_heads % mesh.model_parallel for m in cn.modules()
             if isinstance(m, MultiheadAttention) and m.tp_mesh is not None]
    return {"out": out, "ref_out": ref_out, "grads": tp_full_state_dict(cn, mesh, grads),
            "ref_grads": ref_grads, "sharded": {k for k, d in plan.items() if d is not None},
            "split_heads": heads}


class _Remainder(torch.nn.Module):
    """Two leaves of at least 1 MiB outside the ResNet and attention grammar
    (remainder leaves: sharded along their output axis, gathered at use): a
    3x3 conv, run both in NCHW and in the transposed layout of the hint
    encoders, and a Linear."""

    def __init__(self):
        from controlnet_tpu_torch.nn.layers import Conv2d, Linear

        super().__init__()
        self.conv = Conv2d(128, 256, 3)
        self.proj = Linear(256, 1024)

    def forward(self, x):
        b, c, h, w = x.shape
        tl = self.conv.tl(x.permute(1, 0, 2, 3).reshape(c, b, h * w), (h, w))
        y = self.conv(x) + tl.reshape(-1, b, h, w).permute(1, 0, 2, 3)
        return self.proj(y.mean((2, 3)))


def run_remainder(case, mesh):
    """``_Remainder`` sharded over the model axis against the same weights in
    this process without TP: the output and every gradient."""
    torch.manual_seed(21)
    ref = _Remainder()
    model = _Remainder()
    model.load_state_dict(ref.state_dict())
    g = torch.Generator().manual_seed(22)
    x = torch.randn((2, 128, 4, 4), generator=g)
    w = torch.randn((2, 1024), generator=g)

    def run(m):
        out = m(x)
        (out * w).sum().backward()
        return out.detach(), {k: p.grad for k, p in m.named_parameters()}

    ref_out, ref_grads = run(ref)
    plan = tp_shard_params(model, mesh)
    out, grads = run(model)
    return {"out": out, "ref_out": ref_out, "grads": tp_full_state_dict(model, mesh, grads),
            "ref_grads": ref_grads, "sharded": {k for k, d in plan.items() if d is not None}}


def run_dryrun(case, mesh):
    from controlnet_tpu_torch.parallel.dryrun import dryrun_multichip

    return dryrun_multichip(dist.get_world_size(), "cpu")


CASES = {"cn_train": (run_cn_train, 2), "ldm_forward": (run_ldm_forward, 2),
         "vae_encode": (run_vae_encode, 2), "heads": (run_heads, 4),
         "remainder": (run_remainder, 2), "dryrun": (run_dryrun, None)}
# The NCCL route's collectives (all_gather_into_tensor, reduce_scatter_tensor),
# which gloo has for CPU tensors: the same cases on a mesh that names NCCL.
NATIVE = ("heads", "remainder")


def main() -> int:
    workdir, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/pg", rank=rank,
                            world_size=world)
    meshes = {mp: make_mesh(device="cpu", model_parallel=mp) for mp in (2, 4)}
    m22 = meshes[2]
    assert (m22.data_size, m22.data_index, m22.model_index) == (2, rank // 2, rank % 2)
    cases = torch.load(os.path.join(workdir, "cases.pt"), weights_only=False)
    out = {}
    for name, case in cases.items():
        fn, mp = CASES[name]
        out[name] = fn(case, None if mp is None else meshes[mp])
        if name in NATIVE:
            out[f"{name}_native"] = fn(case, dataclasses.replace(meshes[mp], backend="nccl"))
    out["jax_imported"] = "jax" in sys.modules
    torch.save(out, os.path.join(workdir, f"out{rank}.pt"))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
