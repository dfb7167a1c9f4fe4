"""Rules of the PyTorch port that are not numerics: it imports no JAX and
nothing of the JAX package, and its entry points never run on the CPU
unless asked to."""

import importlib
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import controlnet_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(controlnet_tpu_torch.__path__,
                                                       "controlnet_tpu_torch."))


def test_port_imports_no_jax_and_no_jax_package():
    mods = _all_modules()
    for name in ("ops.cuda_attention", "ops.canny", "train.loops", "train.state", "io.checkpoint",
                 "cli", "data.datasets", "utils.diffusion_utils", "tools.train_ddpm",
                 "tools.train_ddpm_controlnet", "tools.sample_ddpm_controlnet",
                 "ops.cuda_conv", "ops.tl_conv", "models.vae", "sample.ddim", "sample.dpm",
                 "sample.cfg", "tools.sample_ldm_controlnet", "ops.cuda_attention_proj",
                 "tools.serve", "schedules.karras", "schedules.consistency",
                 "models.consistency", "models.dmd",
                 "tools.train_consistency_controlnet_distilled",
                 "tools.sample_consistency_controlnet_distilled",
                 "tools.train_distribution_matching_controlnet_distilled",
                 "tools.sample_distribution_matching_controlnet_distilled",
                 "models.discriminator", "models.lpips", "tools.train_vae", "tools.infer_vae",
                 "tools.train_ldm_vae", "tools.sample_ldm_vae", "tools.train_ldm_controlnet",
                 "utils.profiling", "utils.config_utils", "utils.extract_mnist_images",
                 "utils.extract_cifar_images", "tools.eval_metrics",
                 "tools.compare_controlnet_models", "tools.compare_all_controlnet_models",
                 "tools.export_torch_checkpoint", "parallel", "parallel.mesh"):
        assert f"controlnet_tpu_torch.{name}" in mods, name
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'controlnet_tpu' or m.startswith('controlnet_tpu.')\n"
        "             or m == 'tools' or m.startswith('tools.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("ok")


def test_data_modules_import_no_jax_pil_or_cv2():
    """The readers, the synthetic-tree writer, the tools' data plumbing, the
    sample tool, the PNG extractors and the tools that read or write PNGs
    import no JAX, nothing of the JAX package (not even its JAX-free
    ``data`` modules), and neither PIL nor cv2 until an image is read."""
    mods = ["controlnet_tpu_torch.data.datasets", "controlnet_tpu_torch.data.synthetic",
            "controlnet_tpu_torch.cli", "controlnet_tpu_torch.tools.sample_ddpm",
            "controlnet_tpu_torch.utils.extract_mnist_images",
            "controlnet_tpu_torch.utils.extract_cifar_images",
            "controlnet_tpu_torch.tools.eval_metrics",
            "controlnet_tpu_torch.tools.compare_all_controlnet_models"]
    assert set(mods) <= set(_all_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'controlnet_tpu', 'tools', 'PIL', 'cv2'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sample_ddpm_raises_on_cuda_less_host_unless_cpu(monkeypatch, tmp_path):
    from controlnet_tpu_torch.tools import sample_ddpm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = os.path.join(REPO, "config", "mnist.yaml")
    for call in (lambda: sample_ddpm.main(["--config", config, "--ckpt", "unused.pth"]),
                 lambda: sample_ddpm.load_model({"diffusion_params": {}}, None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # with --device cpu it runs here (a random UNet, a 2-step DDIM loop)
    import yaml

    cfg = yaml.safe_load(open(config))
    cfg["train_params"].update(task_name=str(tmp_path), num_samples=2)
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(cfg))
    from controlnet_tpu_torch.models.unet import UNet

    torch.save(UNet(1, cfg["model_params"]).state_dict(), tmp_path / "u.pth")
    sample_ddpm.main(["--config", str(path), "--ckpt", str(tmp_path / "u.pth"), "--device",
                      "cpu", "--sampler", "ddim", "--sampler_steps", "2"])
    assert len(os.listdir(tmp_path / "samples")) == 2


def test_port_sources_name_no_jax():
    """No module of the port names jax or controlnet_tpu in an import."""
    for name in _all_modules():
        src = importlib.util.find_spec(name).origin
        with open(src) as f:
            for line in f:
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    words = s.replace(",", " ").split()
                    assert "jax" not in words and "controlnet_tpu" not in words, (src, s)
                    assert "tools" not in words, (src, s)  # the root tools package imports JAX
                    assert not any(w.startswith(("jax.", "controlnet_tpu.", "tools."))
                                   for w in words), (src, s)


def test_entry_points_without_device_raise_on_cuda_less_host(monkeypatch):
    from controlnet_tpu_torch.sample.ddpm import make_ddpm_sampler
    from controlnet_tpu_torch.schedules.linear import make_linear_schedule
    from controlnet_tpu_torch.tools import sample_ddpm_controlnet as tool

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_linear_schedule(10, 1e-4, 0.02)
    sched = make_linear_schedule(10, 1e-4, 0.02, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_ddpm_sampler(lambda m, x, t: x, sched, (1, 1, 4, 4))
    cfg = {"diffusion_params": {"num_timesteps": 10, "beta_start": 1e-4, "beta_end": 0.02},
           "model_params": {}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.load_model(cfg, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--hints", "unused.npy", "--config", os.path.join(REPO, "config", "mnist.yaml"),
                   "--ckpt", "unused.pth"])


def test_ldm_entry_points_raise_on_cuda_less_host(monkeypatch):
    """The latent sample tool and the few-step samplers run on the card
    unless device="cpu" is passed."""
    from controlnet_tpu_torch.sample import make_few_step_sampler, make_ldm_sampler
    from controlnet_tpu_torch.schedules.linear import make_linear_schedule
    from controlnet_tpu_torch.tools import sample_ldm_controlnet as tool

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sched = make_linear_schedule(10, 1e-4, 0.02, device="cpu")
    eps = lambda m, x, t: x  # noqa: E731
    for call in (lambda: make_few_step_sampler("ddim", eps, sched, (1, 1, 4, 4), 5),
                 lambda: make_few_step_sampler("dpm", eps, sched, (1, 1, 4, 4), 5),
                 lambda: make_ldm_sampler(eps, lambda v, z: z, sched, (1, 1, 4, 4)),
                 lambda: tool.load_models({"diffusion_params": {}}, None, None),
                 lambda: tool.main(["--hints", "unused.npy", "--config",
                                    os.path.join(REPO, "config", "celebhq.yaml"),
                                    "--ckpt", "unused.pth", "--vae_ckpt", "unused.pth"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_conv_wrapper_has_no_cpu_fallback(monkeypatch):
    """Only a CPU tensor takes the plain version.  Any other tensor (here one
    on the meta device) goes to the kernel's launcher, which launches or
    raises."""
    from controlnet_tpu_torch.ops import cuda_conv

    def refuse(*args):
        raise RuntimeError("launcher reached")

    monkeypatch.setattr(cuda_conv, "_launch", refuse)
    monkeypatch.setattr(cuda_conv, "conv3x3_tl_plain", lambda *a: pytest.fail("fell back"))
    with pytest.raises(RuntimeError, match="launcher reached"):
        cuda_conv._forward(torch.zeros(3, 2, 3, 3, device="meta"), None,
                           torch.zeros(2, 1, 16, device="meta"), (4, 4))


def test_trainer_entry_points_raise_on_cuda_less_host(monkeypatch):
    """Both trainers run on the card unless device="cpu" is passed."""
    from controlnet_tpu_torch.tools import train_ddpm, train_ddpm_controlnet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = os.path.join(REPO, "config", "mnist.yaml")
    for call in (lambda: train_ddpm.train(config, "unused.npy"),
                 lambda: train_ddpm_controlnet.train(config, "unused.npy"),
                 lambda: train_ddpm.main(["--config", config, "--images", "unused.npy"]),
                 lambda: train_ddpm_controlnet.main(["--config", config, "--images", "unused.npy"]),
                 lambda: train_ddpm_controlnet.make_trainer({}, {})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_serve_entry_point_raises_on_cuda_less_host(monkeypatch):
    """The serve tool runs on the card unless --device cpu is passed."""
    import types

    from controlnet_tpu_torch.tools import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = os.path.join(REPO, "config", "mnist.yaml")
    args = types.SimpleNamespace(model="dpm_controlnet", host="127.0.0.1", port=0, seed=0,
                                 ckpt="unused.pth", device=None)
    for call in (lambda: serve.main(["--config", config, "--ckpt", "unused.pth", "--port", "0"]),
                 lambda: serve.make_server(args, serve.cfg.load_config(config)),
                 lambda: serve.build_generator(args, serve.cfg.load_config(config))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_fused_proj_wrapper_launches_or_raises_off_the_cpu(monkeypatch):
    """A CUDA tensor inside the kernel's rule goes to the launcher, never to
    the plain version; the launcher refuses a layout it cannot read."""
    from controlnet_tpu_torch.ops import cuda_attention_proj as proj

    monkeypatch.setattr(proj, "fused_attention_proj_plain", lambda *a: pytest.fail("fell back"))
    x = torch.zeros(2, 4, 16, 2, device="meta")[..., 0]  # rows and channels both strided
    params = [torch.zeros(s, device="meta") for s in ((48, 16), (48,), (16, 16), (16,))]
    with pytest.raises(ValueError, match="contiguous rows"):
        proj._launch(x, *params, 2)
    with pytest.raises(ValueError, match="does not take"):
        proj._launch(torch.zeros(2, 4, 16, device="meta"), *params, 4)  # head dim 4
    with pytest.raises(ValueError, match="must be contiguous"):
        proj._launch(torch.zeros(2, 4, 16, device="meta"), params[0].t().contiguous().t(),
                     *params[1:], 2)


def test_kernel_library_is_not_built_on_import():
    from controlnet_tpu_torch.ops import _build

    assert _build._lib is None
    assert [p.name for p in _build.sources()] == [
        "attention_bwd.cu", "attention_bwd_bf16.cu", "attention_fwd.cu", "attention_fwd_bf16.cu",
        "attention_proj.cu", "attention_proj_bf16.cu", "attention_proj_bf16_128.cu",
        "attention_proj_bf16_64_96.cu", "attention_proj_f32_128.cu", "attention_proj_f32_64_96.cu",
        "conv3x3_tl.cu", "conv3x3_tl_bf16.cu"]
    assert [p.name for p in _build.headers()] == ["attention_proj.cuh", "hopper_attention.cuh",
                                                  "mma_attention.cuh"]


def test_distillation_entry_points_raise_on_cuda_less_host(monkeypatch):
    """The distillation models, trainers and sample tools run on the card
    unless device="cpu" is passed."""
    from controlnet_tpu_torch.config import load_config
    from controlnet_tpu_torch.models.consistency import ConsistencyDistilled
    from controlnet_tpu_torch.models.dmd import DistributionMatchingDistilled
    from controlnet_tpu_torch.tools import (sample_consistency_controlnet_distilled,
                                            sample_distribution_matching_controlnet_distilled,
                                            train_consistency_controlnet_distilled,
                                            train_distribution_matching_controlnet_distilled)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = os.path.join(REPO, "config", "mnist.yaml")
    mnist = load_config(config)
    mp = mnist["model_params"]
    cd_train = train_consistency_controlnet_distilled
    dmd_train = train_distribution_matching_controlnet_distilled
    for call in (lambda: ConsistencyDistilled(1, mp),
                 lambda: DistributionMatchingDistilled(1, mp),
                 lambda: cd_train.train(config, "unused.npy"),
                 lambda: cd_train.main(["--config", config, "--images", "unused.npy"]),
                 lambda: dmd_train.train(config, "unused.npy", "unused.npy"),
                 lambda: dmd_train.main(["--config", config, "--images", "unused.npy",
                                         "--test_images", "unused.npy"]),
                 lambda: sample_consistency_controlnet_distilled.main(["--config", config]),
                 lambda: sample_consistency_controlnet_distilled.load_student(mnist, "x.pth"),
                 lambda: sample_distribution_matching_controlnet_distilled.main(
                     ["--config", config]),
                 lambda: sample_distribution_matching_controlnet_distilled.load_student(
                     mnist, "x.pth")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_latent_training_entry_points_raise_on_cuda_less_host(monkeypatch):
    """The five latent-training tools (and their trainer and loader
    factories) run on the card unless device="cpu" is passed."""
    from controlnet_tpu_torch.config import load_config
    from controlnet_tpu_torch.tools import (infer_vae, sample_ldm_vae, train_ldm_controlnet,
                                            train_ldm_vae, train_vae)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = os.path.join(REPO, "config", "celebhq.yaml")
    celebhq = load_config(config)
    for call in (lambda: train_vae.train(config, "unused.npy"),
                 lambda: train_vae.main(["--config", config, "--images", "unused.npy"]),
                 lambda: train_vae.make_trainer(celebhq),
                 lambda: infer_vae.infer(config, "unused.npy"),
                 lambda: infer_vae.main(["--config", config, "--images", "unused.npy"]),
                 lambda: train_ldm_vae.train(config),
                 lambda: train_ldm_vae.main(["--config", config]),
                 lambda: train_ldm_vae.make_trainer(celebhq, 1),
                 lambda: sample_ldm_vae.main(["--config", config]),
                 lambda: sample_ldm_vae.load_ldm(celebhq, None),
                 lambda: sample_ldm_vae.load_vae(celebhq, None),
                 lambda: train_ldm_controlnet.train(config, "unused.npy"),
                 lambda: train_ldm_controlnet.main(["--config", config, "--hints", "unused.npy"]),
                 lambda: train_ldm_controlnet.make_trainer(celebhq, {}, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_comparison_and_evaluation_tools_raise_on_cuda_less_host(monkeypatch, tmp_path):
    """The compare tools and eval_metrics run on the card unless --device
    cpu is passed."""
    from controlnet_tpu_torch.tools import (compare_all_controlnet_models,
                                            compare_controlnet_models, eval_metrics)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = os.path.join(REPO, "config", "mnist.yaml")
    for call in (lambda: compare_controlnet_models.main(["--config", config]),
                 lambda: compare_all_controlnet_models.main(["--config", config]),
                 lambda: eval_metrics.main(["--dir_a", str(tmp_path), "--dir_b", str(tmp_path)]),
                 lambda: eval_metrics.evaluate(None, None, 1),
                 lambda: eval_metrics.ffd_with_ci(None, None, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
