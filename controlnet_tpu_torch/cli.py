"""Helpers the tools share.

The port's own copy of the parts of ``controlnet_tpu/cli.py`` that the
ported tools need: the dataset reader a config names (``build_dataset``) and
the tools' choice between it and ``.npy`` arrays (``open_split``), the
compute type from YAML, checkpoint cadence and retention, the per-epoch loss
timer, and the sample tools' sampler and guidance flags.
"""

from __future__ import annotations

import time

import torch


def build_dataset(task_name: str, dataset_config: dict, split: str = "train",
                  return_hints: bool = False):
    """The reader of ``dataset_params`` (``controlnet_tpu/cli.py``'s rule):
    the dataset kind is ``dataset_params.task_name`` (or ``name``, the
    celebhq schema's key) when present, else ``task_name``, which is also
    the tools' output directory; the train split reads ``im_path``, the test
    split ``im_test_path`` (CIFAR-10 falls back to ``im_path``)."""
    from controlnet_tpu_torch.data.datasets import CelebDataset, CifarDataset, MnistDataset

    task_name = dataset_config.get("task_name", dataset_config.get("name", task_name))
    if task_name == "mnist":
        path = dataset_config["im_path"] if split == "train" else dataset_config["im_test_path"]
        return MnistDataset(split, im_path=path, return_hints=return_hints)
    if task_name == "cifar10":
        path = dataset_config["im_path"] if split == "train" else dataset_config.get(
            "im_test_path", dataset_config["im_path"])
        return CifarDataset(split, im_path=path, download=dataset_config.get("download", False),
                            return_hints=return_hints)
    if task_name == "celebhq":
        return CelebDataset(split, im_path=dataset_config["im_path"],
                            im_size=dataset_config["im_size"],
                            im_channels=dataset_config.get("im_channels", 3),
                            return_hint=return_hints,
                            canny_im_size=dataset_config.get("canny_im_size", 1024))
    raise ValueError(f"Invalid dataset/task name: {task_name}")


def open_split(config: dict, split: str, device, images_path: str | None = None,
               hints_path: str | None = None, return_hints: bool = False,
               kind: str | None = None):
    """A tool's images of one split: the ``.npy`` arrays when ``images_path``
    is given (hints from ``hints_path`` or none), else the reader that
    ``dataset_params`` names (hints from cv2 with ``return_hints``; ``kind``
    is ``build_dataset``'s fallback name, ``train_params.task_name`` when
    None)."""
    from controlnet_tpu_torch.data.datasets import ImageSource

    if images_path is not None:
        return ImageSource.from_npy(images_path, hints_path, device)
    if hints_path is not None:
        raise ValueError("hints from an .npy need the images from an .npy too")
    dataset = build_dataset(kind or config["train_params"]["task_name"],
                            config["dataset_params"], split, return_hints)
    return ImageSource.from_reader(dataset, device)


HINT_BACKENDS = ("cv2", "tpu")


def add_hint_backend_arg(parser) -> None:
    """``--hint_backend cv2|tpu``, as the JAX trainer tool has it: cv2 takes
    canny on the host in the reader (the reference's hints); ``tpu`` the
    port's canny on the card, batch by batch (``ops/canny.py``).  The default is cv2 for a tree and the card for
    ``.npy`` images without ``--hints``."""
    parser.add_argument("--hint_backend", choices=HINT_BACKENDS, default=None,
                        help="cv2: host canny in the reader (reference hints); tpu: the "
                             "port's canny on the card")


def mesh_or_none(device=None):
    """The data-parallel mesh (``parallel.mesh.make_mesh`` on ``device``)
    under ``torchrun`` with ``WORLD_SIZE`` above 1, or when a process group is
    already up; else None (one process, no collective)."""
    from controlnet_tpu_torch.device import in_group

    if not in_group():
        return None
    from controlnet_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(device=device)


_put_batch_warned: set = set()


def _warn_once(key: str, msg: str) -> None:
    if key not in _put_batch_warned:
        _put_batch_warned.add(key)
        print(f"controlnet_tpu_torch: {msg}")


def put_batch(batch, mesh):
    """This rank's rows of a global batch (a tensor, an array or a tree of
    them, batch-leading).  A batch not divisible by the world size is trimmed
    to the largest divisible size, with a one-time warning; a batch smaller
    than the world size raises, as the JAX tool's multi-process branch does:
    every rank is a process of its own, and a replicated fallback would give
    each rank different data.  No mesh: the batch as it is."""
    if mesh is None:
        return batch
    from controlnet_tpu_torch.parallel.mesh import shard_host_local_batch
    from controlnet_tpu_torch.sample.common import tree_map

    n = mesh.world_size
    leaves = []
    tree_map(leaves.append, batch)
    b = leaves[0].shape[0] if leaves else 0
    if b % n:
        keep = (b // n) * n
        if keep == 0:
            raise ValueError(
                f"batch of {b} is smaller than the world size ({n}); pad the batch or "
                f"run fewer ranks: a replicated fallback is not safe across {n} processes")
        _warn_once(f"trim:{b}", f"trimming batch {b} -> {keep} for {n}-way data-parallel "
                   f"divisibility; warning shown once")
        batch = tree_map(lambda x: x[:keep], batch)
    return shard_host_local_batch(batch, mesh)


def batch_rows(mesh):
    """``ImageSource.batches``' ``rows`` for this rank: ``put_batch``'s rows
    of each global batch's indices (None without a mesh)."""
    return None if mesh is None else (lambda idx: put_batch(idx, mesh))


def say(mesh, msg: str) -> None:
    """Print on rank 0 only (every line once per run)."""
    from controlnet_tpu_torch.parallel.mesh import is_writer

    if is_writer(mesh):
        print(msg, flush=True)


def write_once(mesh, fn, *args, **kwargs) -> None:
    """Call the writer ``fn`` on rank 0 only, then hold every rank at a
    barrier, so no rank reads the file before it is whole."""
    from controlnet_tpu_torch.parallel.mesh import barrier, is_writer

    if is_writer(mesh):
        fn(*args, **kwargs)
    barrier(mesh)


def sampler_mesh(num_samples: int, device=None):
    """(mesh, padded count) for data-parallel sampling (the samplers'
    ``mesh=``): the count is padded up to divisibility by the world size
    (sampling costs per sample, so padding beats trimming) and callers slice
    the output back to ``num_samples``.  One process: (None, num_samples)."""
    mesh = mesh_or_none(device)
    if mesh is None:
        return None, num_samples
    n = mesh.world_size
    padded = ((num_samples + n - 1) // n) * n
    if padded != num_samples:
        _warn_once(f"pad:{num_samples}", f"padding sample batch {num_samples} -> {padded} "
                   f"for {n}-way data-parallel sampling")
    return mesh, padded


def put_replicated(obj, mesh):
    """``obj`` (a module, an optimizer, a tuple of them) with rank 0's
    tensors on every rank."""
    if mesh is None:
        return obj
    from controlnet_tpu_torch.parallel.mesh import replicate

    return replicate(obj, mesh)


def compute_dtype_from(train_config: dict) -> torch.dtype | None:
    """``train_params.compute_dtype`` ("bfloat16" | "float32"): the network's
    forward/backward type.  None (absent or "float32") is full float32."""
    name = str(train_config.get("compute_dtype", "float32")).lower()
    if name in ("float32", "f32", "none"):
        return None
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(f"unknown compute_dtype {name!r} (use bfloat16 or float32)")


class EpochTimer:
    """Per-epoch loss/time accumulator.  ``add`` keeps the device scalar:
    reading it every step would stall the host on the device each step; the
    one synchronisation is in ``summary`` at the end of the epoch."""

    def __init__(self):
        self.t0 = time.time()
        self.losses: list = []

    def add(self, loss: torch.Tensor) -> None:
        self.losses.append(loss.detach())

    def mean_loss(self) -> float:
        if not self.losses:
            return float("nan")
        return torch.stack(self.losses).float().mean().item()

    def summary(self) -> str:
        mean = self.mean_loss()
        return f"mean loss {mean:.4f} | {len(self.losses)} steps | {time.time() - self.t0:.1f}s"


def ckpt_max_to_keep(train_config: dict) -> int:
    """``train_params.ckpt_max_to_keep`` newest checkpoints per name are kept
    (default 3); 0 keeps every one."""
    return int(train_config.get("ckpt_max_to_keep", 3))


def should_save_epoch(epoch_idx: int, num_epochs: int, every: int) -> bool:
    """Every ``every`` epochs, and always after the last one."""
    return (epoch_idx + 1) % max(every, 1) == 0 or (epoch_idx + 1) == num_epochs


def add_sampler_args(parser) -> None:
    """Sampler-selection flags shared by the sample tools: ``--sampler
    ddim|dpm --sampler_steps N`` runs a few-step loop (``sample/ddim.py``
    first-order, ``sample/dpm.py`` DPM-Solver++(2M) second-order) on the same
    checkpoint; the default is the full-length ancestral sampler."""
    parser.add_argument("--sampler", choices=["ancestral", "ddim", "dpm"], default="ancestral",
                        help="ancestral, few-step ddim, or few-step dpm "
                             "(DPM-Solver++ 2M, second-order)")
    parser.add_argument("--sampler_steps", type=int, default=50,
                        help="few-step sampler step count")
    parser.add_argument("--eta", type=float, default=0.0,
                        help="DDIM stochasticity; 0 = deterministic "
                             "(--sampler ddim only; dpm is deterministic)")


def add_cfg_args(parser) -> None:
    """``--cfg_scale`` for the ControlNet sample tools: classifier-free
    guidance over the hint condition (``sample/cfg.py``).  Unset keeps the
    plain conditional model."""
    parser.add_argument("--cfg_scale", type=float, default=None,
                        help="classifier-free guidance scale (1 is the plain conditional "
                             "model; >1 sharpens hint adherence; needs a checkpoint trained "
                             "with train_params.cfg_drop_prob > 0 for a meaningful null branch)")


def apply_cfg(cfg_scale: float | None, eps_fn, hint_arg, null_hint_fn):
    """Honor ``--cfg_scale``: returns ``(eps_fn, hint_arg)``, wrapped for
    guidance with a (conditional, null) hint pair when the scale is set,
    unchanged otherwise.  ``null_hint_fn`` computes the null-hint features
    and is called only when guidance is on."""
    if cfg_scale is None:
        return eps_fn, hint_arg
    from controlnet_tpu_torch.sample.cfg import make_cfg_eps_fn

    return make_cfg_eps_fn(eps_fn, cfg_scale), (hint_arg, null_hint_fn())


def select_sampler(sampler: str, sampler_steps: int, eta: float, eps_fn, sched, shape,
                   record_every: int, compute_dtype: torch.dtype | None = None, device=None,
                   mesh=None):
    """Honor the ``add_sampler_args`` flags: returns ``(sampler, step_ts)``
    where ``step_ts`` is the few-step loop's visited timesteps (None for the
    ancestral loop); ``mesh`` (``sampler_mesh``'s) samples the global batch
    ``shape`` data-parallel."""
    if sampler != "ancestral":
        from controlnet_tpu_torch.sample import make_few_step_sampler

        loop = make_few_step_sampler(sampler, eps_fn, sched, shape, num_steps=sampler_steps,
                                     eta=eta, compute_dtype=compute_dtype, device=device,
                                     mesh=mesh)
        return loop, loop.timesteps
    from controlnet_tpu_torch.sample.ddpm import make_ddpm_sampler

    return make_ddpm_sampler(eps_fn, sched, shape, record_every, compute_dtype, device,
                             mesh), None


def snapshot_timestep(k: int, step_ts, num_timesteps: int, record_every: int) -> int:
    """Timestep label of trajectory snapshot ``k`` (0-based, newest last):
    the few-step loop's entry when ``step_ts`` is set, else the ancestral
    convention (snapshot k is the state after the denoising step at
    t = T - 1 - (k * record_every + record_every - 1))."""
    if step_ts is not None:
        return step_ts[k]
    return num_timesteps - 1 - (k * record_every + record_every - 1)
