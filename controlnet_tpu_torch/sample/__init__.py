from controlnet_tpu_torch.sample.ddim import ddim_timesteps, make_ddim_sampler
from controlnet_tpu_torch.sample.ddpm import make_ddpm_sampler, make_ldm_sampler
from controlnet_tpu_torch.sample.dpm import make_dpm_sampler


def make_few_step_sampler(kind, eps_fn, sched, shape, num_steps, eta=0.0,
                          compute_dtype=None, device=None):
    """Few-step sampler factory shared by the sample tools: ``kind`` is the
    ``--sampler`` value ("ddim" | "dpm").  Both samplers share the
    ``sampler(model, generator[, hint_features]) -> (x0, trajectory)``
    contract and carry the visited timesteps as ``sampler.timesteps``."""
    if kind == "ddim":
        return make_ddim_sampler(eps_fn, sched, shape, num_steps=num_steps, eta=eta,
                                 compute_dtype=compute_dtype, device=device)
    if kind == "dpm":
        if eta:  # the ODE solver is deterministic by construction
            raise ValueError("--eta is a DDIM knob; the dpm solver is "
                             "deterministic (eta must be 0)")
        return make_dpm_sampler(eps_fn, sched, shape, num_steps=num_steps,
                                compute_dtype=compute_dtype, device=device)
    raise ValueError(f"unknown few-step sampler {kind!r} (ddim | dpm)")


__all__ = ["ddim_timesteps", "make_ddim_sampler", "make_ddpm_sampler",
           "make_dpm_sampler", "make_few_step_sampler", "make_ldm_sampler"]
