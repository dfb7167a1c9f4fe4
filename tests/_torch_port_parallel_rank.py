"""One rank of the two-rank runs of tests/test_torch_port_parallel.py and
tests/test_torch_port_parallel_latent.py.

    python tests/_torch_port_parallel_rank.py WORKDIR RANK WORLD

Joins a gloo group through ``WORKDIR/pg`` (a file rendezvous: no TCP port to
fight over under pytest-xdist), reads the cases from ``WORKDIR/cases.pt``
(global batches, global injected draws, weights), runs each one through the
port's data-parallel path on the CPU, and writes ``WORKDIR/out{RANK}.pt``.
The process imports torch and the port only, never JAX.
"""

import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from controlnet_tpu_torch import cli  # noqa: E402
from controlnet_tpu_torch.parallel.mesh import gather_rows, make_mesh  # noqa: E402

NOISE_FLOOR = 1e-6


def _noisy(state, noisy):
    for k, p in state.params.items():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        low = g.abs() < NOISE_FLOOR
        noisy[k] = low if k not in noisy else noisy[k] | low
    return noisy


def _sd(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def run_ddpm(case, mesh):
    from controlnet_tpu_torch.models.unet import UNet
    from controlnet_tpu_torch.schedules.linear import make_linear_schedule
    from controlnet_tpu_torch.train.loops import make_ddpm_train_step
    from controlnet_tpu_torch.train.state import create_train_state

    unet = UNet(1, case["cfg"])
    unet.load_state_dict(case["sd"], strict=True)
    state = create_train_state(dict(unet.named_parameters()), case["lr"], mesh=mesh)
    step = make_ddpm_train_step(unet, make_linear_schedule(case["T"], 1e-4, 0.02, device="cpu"))
    losses, noisy = [], {}
    for images, t, noise in case["steps"]:
        losses.append(step(state, cli.put_batch(images, mesh), t=t, noise=noise).item())
        noisy = _noisy(state, noisy)
    return {"losses": losses, "sd": _sd(unet), "noisy": noisy}


def run_controlnet(case, mesh):
    from controlnet_tpu_torch.models.controlnet import ControlNet
    from controlnet_tpu_torch.schedules.linear import make_linear_schedule
    from controlnet_tpu_torch.train.loops import make_controlnet_train_step
    from controlnet_tpu_torch.train.state import create_train_state

    cn = ControlNet(1, case["cfg"])
    cn.load_state_dict(case["sd"], strict=True)
    trainable, _ = cn.freeze_trunk()
    state = create_train_state(trainable, case["lr"], mesh=mesh)
    step = make_controlnet_train_step(cn, make_linear_schedule(case["T"], 1e-4, 0.02,
                                                               device="cpu"),
                                      cfg_drop_prob=case["drop"])
    losses, noisy = [], {}
    for images, hints, t, noise, keep in case["steps"]:
        images, hints = cli.put_batch((images, hints), mesh)
        losses.append(step(state, images, hints, t=t, noise=noise, keep=keep).item())
        noisy = _noisy(state, noisy)
    return {"losses": losses, "sd": _sd(cn), "noisy": noisy}


def run_dmd(case, mesh):
    from controlnet_tpu_torch.models.dmd import DistributionMatchingDistilled
    from controlnet_tpu_torch.train.loops import make_dmd_train_step
    from controlnet_tpu_torch.train.state import create_dmd_train_state

    pm = DistributionMatchingDistilled(1, case["cfg"], num_timesteps=case["T"], device="cpu")
    pm.student.load_state_dict(case["student"], strict=True)
    pm.teacher.load_state_dict(case["teacher"], strict=True)
    pm.feature_extractor.load_state_dict(case["features"], strict=True)
    with torch.no_grad():  # the extractor's BatchNorm over the global batch
        feats = [gather_rows(f, mesh)
                 for f in pm.feature_extractor(cli.put_batch(case["feature_x"], mesh), mesh)]
    state = create_dmd_train_state(dict(pm.student.named_parameters()), case["lr"],
                                   case["decay_steps"], mesh=mesh)
    step = make_dmd_train_step(pm, state)
    x0, hint = cli.put_batch((case["x0"], case["hint"]), mesh)
    metrics = step(x0, hint, t=case["t"], noise=case["noise"])
    return {"metrics": {k: v.item() for k, v in metrics.items()}, "sd": _sd(pm.student),
            "noisy": _noisy(state, {}), "features": feats}


def run_batchnorm(case, mesh):
    from controlnet_tpu_torch.nn.layers import BatchNorm

    bn = BatchNorm(case["x"].shape[1])
    bn.load_state_dict(case["params"])
    x = cli.put_batch(case["x"], mesh).clone().requires_grad_()
    out = bn(x, mesh)
    (out * cli.put_batch(case["w"], mesh)).sum().backward()
    return {"out": gather_rows(out.detach(), mesh), "dx": gather_rows(x.grad, mesh),
            "dweight": bn.weight.grad, "dbias": bn.bias.grad}


def run_samplers(case, mesh):
    from controlnet_tpu_torch.models.controlnet import ControlNet
    from controlnet_tpu_torch.sample import make_ddpm_sampler, make_ddim_sampler
    from controlnet_tpu_torch.schedules.linear import make_linear_schedule

    cn = ControlNet(1, case["cfg"]).eval()
    cn.load_state_dict(case["sd"], strict=True)
    sched = make_linear_schedule(case["T"], 1e-4, 0.02, device="cpu")
    eps = lambda m, x, t, f: m(x, t, hint_features=f)  # noqa: E731
    with torch.no_grad():
        feats = cn.hint_features(cli.put_batch(case["hint"], mesh))
    out = {}
    ancestral = make_ddpm_sampler(eps, sched, case["shape"], record_every=5, device="cpu",
                                  mesh=mesh)
    out["ancestral"] = ancestral(cn, None, feats, x_start=case["x_start"],
                                 step_noise=case["step_noise"])
    ddim = make_ddim_sampler(eps, sched, case["shape"], num_steps=case["ddim_steps"],
                             eta=case["eta"], device="cpu", mesh=mesh)
    out["ddim"] = ddim(cn, None, feats, x_start=case["x_start"],
                       step_noise=case["ddim_noise"])
    return out


def run_ldm_sampler(case, mesh):
    """The latent sampler (ancestral and DPM) with injected global draws:
    each rank samples and decodes its rows; returns the gathered images and
    latent trajectory."""
    from controlnet_tpu_torch.models.unet import UNet
    from controlnet_tpu_torch.models.vae import VAE
    from controlnet_tpu_torch.sample.ddpm import make_ldm_sampler
    from controlnet_tpu_torch.schedules.linear import make_linear_schedule

    unet = UNet(case["shape"][1], case["cfg"]).eval()
    unet.load_state_dict(case["unet"], strict=True)
    vae = VAE(3, case["vae_cfg"]).eval()
    vae.load_state_dict(case["vae"], strict=True)
    sched = make_linear_schedule(case["T"], 1e-4, 0.02, device="cpu")
    eps, dec = (lambda m, x, t: m(x, t)), (lambda v, z: v.decode(z))
    ancestral = make_ldm_sampler(eps, dec, sched, case["shape"], record_every=5, device="cpu",
                                 mesh=mesh)
    dpm = make_ldm_sampler(eps, dec, sched, case["shape"], ddim_steps=case["dpm_steps"],
                           solver="dpm", device="cpu", mesh=mesh)
    return {"ancestral": ancestral(unet, vae, None, x_start=case["x_start"],
                                   step_noise=case["step_noise"]),
            "dpm": dpm(unet, vae, None, x_start=case["x_start"])}


CASES = {"ddpm": run_ddpm, "controlnet": run_controlnet, "dmd": run_dmd,
         "batchnorm": run_batchnorm, "samplers": run_samplers, "ldm_sampler": run_ldm_sampler}


def main() -> int:
    workdir, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/pg", rank=rank,
                            world_size=world)
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.backend) == (rank, world, "gloo")
    cases = torch.load(os.path.join(workdir, "cases.pt"), weights_only=False)
    out = {name: CASES[name](case, mesh) for name, case in cases.items()}
    out["jax_imported"] = "jax" in sys.modules
    torch.save(out, os.path.join(workdir, f"out{rank}.pt"))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
