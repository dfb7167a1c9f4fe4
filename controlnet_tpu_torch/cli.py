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
                   record_every: int, compute_dtype: torch.dtype | None = None, device=None):
    """Honor the ``add_sampler_args`` flags: returns ``(sampler, step_ts)``
    where ``step_ts`` is the few-step loop's visited timesteps (None for the
    ancestral loop)."""
    if sampler != "ancestral":
        from controlnet_tpu_torch.sample import make_few_step_sampler

        loop = make_few_step_sampler(sampler, eps_fn, sched, shape, num_steps=sampler_steps,
                                     eta=eta, compute_dtype=compute_dtype, device=device)
        return loop, loop.timesteps
    from controlnet_tpu_torch.sample.ddpm import make_ddpm_sampler

    return make_ddpm_sampler(eps_fn, sched, shape, record_every, compute_dtype, device), None


def snapshot_timestep(k: int, step_ts, num_timesteps: int, record_every: int) -> int:
    """Timestep label of trajectory snapshot ``k`` (0-based, newest last):
    the few-step loop's entry when ``step_ts`` is set, else the ancestral
    convention (snapshot k is the state after the denoising step at
    t = T - 1 - (k * record_every + record_every - 1))."""
    if step_ts is not None:
        return step_ts[k]
    return num_timesteps - 1 - (k * record_every + record_every - 1)
