"""The port's distillation tools on the CPU at the tiny config: both trainers
(1 epoch, then resumed to 2), both sample tools on the ``.pth`` a trainer
wrote and on one written by the JAX package's export path, and the serve
tool's ``consistency`` / ``dmd`` models against the JAX server's.

Resume is exact: a run of 2 epochs and a run of 1 epoch resumed to 2 write
bit-identical students (and EMA).  The served students are compared with the
JAX server's ``generate`` (tools/serve.py, from an orbax checkpoint of the
same weights) with x_T injected, within 1e-3 of max|out|, and are not
clamped.  The tolerance is the JAX side's: at sigma_max the consistency
student's input is scaled by 1/80, and there the JAX forward lies up to
~4e-4 of max|out| from a float64 forward of the port's module while the
port's float32 forward lies ~6e-6 from it (measured on these weights).
"""

import io
import json
import os
import threading
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _torch_port_util import np_tree, random_params, to_nchw, to_nhwc
from conftest import TINY_MODEL_CONFIG
from controlnet_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
from controlnet_tpu.io.torch_export import export_distilled_student, save_torch_checkpoint
from controlnet_tpu.models.consistency import ConsistencyDistilled as JaxConsistencyDistilled
from controlnet_tpu.models.dmd import DistributionMatchingControlNet as JaxDMDStudent
from controlnet_tpu_torch.io import jax_params
from controlnet_tpu_torch.models.controlnet import ControlNet
from controlnet_tpu_torch.tools import sample_consistency_controlnet_distilled as cd_sample
from controlnet_tpu_torch.tools import (
    sample_distribution_matching_controlnet_distilled as dmd_sample)
from controlnet_tpu_torch.tools import serve
from controlnet_tpu_torch.tools import train_consistency_controlnet_distilled as cd_train
from controlnet_tpu_torch.tools import (
    train_distribution_matching_controlnet_distilled as dmd_train)

T = 20
CFG = dict(TINY_MODEL_CONFIG)
N = 8  # images per split: 2 steps an epoch at batch 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the suite runs in
    parallel workers, and at these sizes torch's thread pool only contends
    with theirs (the tiny trainer runs took ~100x longer so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """A seeded ControlNet teacher .pth and train / test splits."""
    root = tmp_path_factory.mktemp("distill_tools")
    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        np.save(root / f"{split}_images.npy", rng.integers(0, 256, (N, 8, 8), dtype=np.uint8))
        np.save(root / f"{split}_hints.npy",
                (rng.uniform(size=(N, 8, 8, 3)) < 0.2).astype(np.float32))
    torch.manual_seed(1)
    cn = ControlNet(1, CFG)
    with torch.no_grad():
        for conv in cn.zero_convs():
            conv.weight.normal_(0.0, 0.05)
    teacher = {k: v.clone() for k, v in cn.state_dict().items()}
    return types.SimpleNamespace(root=root, teacher=teacher,
                                 path=lambda name: str(root / name))


def _config(ws, task: str, epochs: int, **train) -> str:
    task_dir = os.path.join(ws.root, task)
    os.makedirs(task_dir, exist_ok=True)
    if not os.path.exists(os.path.join(task_dir, "cn.pth")):
        torch.save(ws.teacher, os.path.join(task_dir, "cn.pth"))
    config = {
        "diffusion_params": {"num_timesteps": T, "beta_start": 1e-4, "beta_end": 0.02},
        "model_params": CFG,
        "train_params": {"task_name": task_dir, "batch_size": 4, "controlnet_ckpt_name": "cn.pth",
                         "consistency_epochs": epochs, "consistency_lr": 1e-3,
                         "distribution_matching_epochs": epochs,
                         "distribution_matching_lr": 1e-3, "ckpt_save_every_epochs": 1,
                         "seed": 0, **train},
    }
    path = os.path.join(ws.root, f"{task}_{epochs}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


MODE_FLAGS = {"ddpm_distillation": {}, "consistency_only": {"use_consistency_only": True},
              "manual": {"use_ddpm_distillation": False}}


@pytest.mark.parametrize("mode", list(MODE_FLAGS))
def test_consistency_trainer_resumes_exactly(ws, mode):
    images, hints = ws.path("train_images.npy"), ws.path("train_hints.npy")
    straight = cd_train.train(_config(ws, f"cd_{mode}_a", 2, **MODE_FLAGS[mode]), images, hints,
                              device="cpu")
    first = cd_train.train(_config(ws, f"cd_{mode}_b", 1, **MODE_FLAGS[mode]), images, hints,
                           device="cpu")
    resumed = cd_train.train(_config(ws, f"cd_{mode}_b", 2, **MODE_FLAGS[mode]), images, hints,
                             device="cpu")
    assert straight["mode"] == mode and straight["epochs"] == [1, 2]
    assert first["epochs"] == [1] and resumed["epochs"] == [2]
    assert np.isfinite(straight["losses"]).all()
    np.testing.assert_array_equal(straight["losses"], first["losses"] + resumed["losses"])
    task_b = os.path.join(ws.root, f"cd_{mode}_b")
    assert os.path.exists(os.path.join(task_b, "consistency_controlnet_distilled", "2.pt"))
    a = torch.load(os.path.join(ws.root, f"cd_{mode}_a", cd_train.CKPT_NAME), weights_only=True)
    b = torch.load(os.path.join(task_b, cd_train.CKPT_NAME), weights_only=True)
    assert set(a) == {"epoch", "model_state_dict", "ema_teacher_state_dict", "model_config"}
    assert a["epoch"] == b["epoch"] == 2 and a["model_config"]["im_size"] == 8
    for key in ("model_state_dict", "ema_teacher_state_dict"):
        for k, v in a[key].items():
            assert torch.equal(v, b[key][k]), (key, k)
    moved = any(not torch.equal(a["model_state_dict"][k], a["ema_teacher_state_dict"][k])
                for k in a["model_state_dict"])
    assert moved  # the EMA lags the student


def test_dmd_trainer_resumes_exactly_and_keeps_the_best(ws):
    """The cosine schedule spans the configured epochs, so a 1-epoch run is not
    the first half of a 2-epoch one: exactness is held by resuming a copy of
    the 2-epoch run's epoch-1 checkpoint (and its best-val sidecar as it
    stood then) to epoch 2."""
    import shutil

    args = dict(images_path=ws.path("train_images.npy"),
                test_images_path=ws.path("test_images.npy"),
                hints_path=ws.path("train_hints.npy"), test_hints_path=None, device="cpu")
    straight = dmd_train.train(_config(ws, "dmd_a", 2), no_plots=True, **args)
    task_a, task_c = (os.path.join(ws.root, t) for t in ("dmd_a", "dmd_c"))
    _config(ws, "dmd_c", 2)
    for name in ("distribution_matching_controlnet_distilled",
                 "distribution_matching_controlnet_best"):
        os.makedirs(os.path.join(task_c, name))
        shutil.copy(os.path.join(task_a, name, "1.pt"), os.path.join(task_c, name, "1.pt"))
    with open(os.path.join(task_c, dmd_train.BEST_VAL), "w") as f:
        json.dump({"best_val": straight["val_loss"][0], "epoch": 1}, f)
    resumed = dmd_train.train(_config(ws, "dmd_c", 2), no_plots=True, **args)
    assert straight["epochs"] == [1, 2] and resumed["epochs"] == [2]
    assert straight["skipped"] == [0, 0] and np.isfinite(straight["val_loss"]).all()
    assert resumed["val_loss"] == straight["val_loss"][1:]
    assert resumed["train_total_loss"] == straight["train_total_loss"][1:]
    assert straight["best_val"] == min(straight["val_loss"]) == resumed["best_val"]
    a = torch.load(os.path.join(task_a, dmd_train.REF_CKPT), weights_only=True)
    c = torch.load(os.path.join(task_c, dmd_train.REF_CKPT), weights_only=True)
    assert set(a) == {"epoch", "model_state_dict", "config"} and a["epoch"] == c["epoch"] == 2
    for k, v in a["model_state_dict"].items():
        assert torch.equal(v, c["model_state_dict"][k]), k
    opt_a = torch.load(os.path.join(task_a, "distribution_matching_controlnet_distilled", "2.pt"),
                       weights_only=True)["state"]["opt_state"]
    opt_c = torch.load(os.path.join(task_c, "distribution_matching_controlnet_distilled", "2.pt"),
                       weights_only=True)["state"]["opt_state"]
    for k in ("exp_avg", "exp_avg_sq", "count"):
        assert torch.equal(opt_a[k], opt_c[k]), k
    assert opt_a["count"].item() == 4  # 2 epochs of 2 steps

    # the 1-epoch run resumed to 2, with plots; the best is kept under its own name
    first = dmd_train.train(_config(ws, "dmd_b", 1), **args)
    again = dmd_train.train(_config(ws, "dmd_b", 2), **args)
    assert first["epochs"] == [1] and again["epochs"] == [2]
    task_b = os.path.join(ws.root, "dmd_b")
    with open(os.path.join(task_b, dmd_train.BEST_VAL)) as f:
        best = json.load(f)
    assert best["best_val"] == min(first["val_loss"] + again["val_loss"]) == again["best_val"]
    assert os.path.exists(os.path.join(task_b, "distribution_matching_controlnet_best",
                                       f"{best['epoch']}.pt"))
    best_pth = torch.load(os.path.join(task_b, dmd_train.BEST_REF_CKPT), weights_only=True)
    assert best_pth["epoch"] == best["epoch"]
    assert os.path.exists(os.path.join(task_b, "dmd_training_samples",
                                       "epoch_002_comparison.png"))
    assert not os.path.exists(os.path.join(task_a, "dmd_training_samples"))
    with pytest.raises(SystemExit):
        dmd_train.main(["--images", "x.npy"])  # --test_images is required


def test_sample_tools_on_the_written_pth(ws):
    cd_train.train(_config(ws, "cd_s", 1), ws.path("train_images.npy"), device="cpu")
    dmd_train.train(_config(ws, "dmd_s", 1), ws.path("train_images.npy"),
                    ws.path("test_images.npy"), device="cpu", no_plots=True)
    for mode, extra in (("random", []), ("custom", []),
                        ("test", ["--test_images", ws.path("test_images.npy")]),
                        ("test", ["--test_images", ws.path("test_images.npy"),
                                  "--test_hints", ws.path("test_hints.npy")])):
        for steps in (1, 4):
            out = cd_sample.main(["--config", _config(ws, "cd_s", 1), "--mode", mode,
                                  "--num_samples", "5", "--num_steps", str(steps),
                                  "--device", "cpu", *extra])
            assert out["x0"].shape == (5, 1, 8, 8) and torch.isfinite(out["x0"]).all()
        out = dmd_sample.main(["--config", _config(ws, "dmd_s", 1), "--mode", mode,
                               "--num_samples", "5", "--use_best", "--device", "cpu", *extra])
        assert out["x0"].shape == (5, 1, 8, 8) and torch.isfinite(out["x0"]).all()
    pngs = os.listdir(os.path.join(ws.root, "cd_s", "consistency_samples"))
    assert "custom_sample_004.png" in pngs and "test_comparison_004.png" in pngs
    geo = dmd_sample.create_geometric_hints(4, CFG)
    assert geo.shape == (4, 8, 8, 3) and geo[0, ::4].all() and not geo[0, 1::4].any()


def _jax_student(kind, seed):
    """A JAX student tree, its output conv scaled up so that samples leave
    [-1, 1] (where a clamp would show)."""
    if kind == "consistency":
        jm = JaxConsistencyDistilled(1, CFG, use_ddpm_teacher=False, num_timesteps=T)
        p = random_params(jm.student, seed)
    else:
        jm = JaxDMDStudent(1, CFG)
        p = random_params(jm, seed)
    p["unet"]["conv_out"] = {k: 8.0 * v for k, v in p["unet"]["conv_out"].items()}
    return jm, p


def _jax_export(kind, jm, p, path):
    """The wrapper tools/export_torch_checkpoint.py writes (--type consistency
    | dmd), from a JAX parameter tree."""
    if kind == "consistency":
        sd = export_distilled_student(np_tree(p), jm.student)
        payload = {"epoch": 3, "model_state_dict": sd, "ema_teacher_state_dict": sd,
                   "model_config": dict(CFG)}
    else:
        payload = {"epoch": 3, "model_state_dict": export_distilled_student(np_tree(p), jm),
                   "config": {"model_params": dict(CFG)}}
    save_torch_checkpoint(payload, path)


def _jax_server_config(task):
    return {"diffusion_params": {"num_timesteps": T, "beta_start": 1e-4, "beta_end": 0.02},
            "model_params": CFG, "train_params": {"task_name": str(task)}}


@pytest.mark.parametrize("kind", ["consistency", "dmd"])
def test_sample_tools_on_a_jax_exported_pth(ws, kind, tmp_path):
    jm, p = _jax_student(kind, 30)
    path = str(tmp_path / f"{kind}.pth")
    _jax_export(kind, jm, p, path)
    config = _jax_server_config(tmp_path)
    if kind == "consistency":
        model = cd_sample.load_student(config, path, "cpu")
        student = model.student
    else:
        student = dmd_sample.load_student(config, path, "cpu")
    want = jax_params.student_state_dict_from_jax(np_tree(p))
    for k, v in student.state_dict().items():
        assert torch.equal(v, want[k]), k
    cfg_path = str(tmp_path / "c.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(config, f)
    tool = cd_sample if kind == "consistency" else dmd_sample
    out = tool.main(["--config", cfg_path, "--ckpt", path, "--mode", "custom", "--num_samples",
                     "3", "--device", "cpu"])
    assert out["x0"].shape == (3, 1, 8, 8) and torch.isfinite(out["x0"]).all()


def _serve_args(model, ckpt, **kw):
    base = dict(model=model, host="127.0.0.1", port=0, seed=0, max_batch=2, max_steps=8,
                device="cpu", ckpt=ckpt)
    return types.SimpleNamespace(**{**base, **kw})


@pytest.mark.parametrize("kind", ["consistency", "dmd"])
def test_served_student_matches_the_jax_server(kind, tmp_path):
    import tools.serve as jax_serve
    from tools.sample_consistency_controlnet_distilled import CKPT_NAME as JAX_CD_CKPT
    from tools.train_distribution_matching_controlnet_distilled import CKPT_NAME as JAX_DMD_CKPT

    jm, p = _jax_student(kind, 40)
    jax_save_checkpoint(str(tmp_path), JAX_CD_CKPT if kind == "consistency" else JAX_DMD_CKPT,
                        1, {"state": {"params": p}})
    config = _jax_server_config(tmp_path)
    jgen = jax_serve.build_generator(types.SimpleNamespace(model=kind), config)[0]
    hint = (np.random.default_rng(41).uniform(size=(2, 8, 8, 3)) < 0.3).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jgen(jnp.asarray(hint), key, steps=1))
    x_start = np.asarray(jax.random.normal(key, ref.shape))  # the JAX server's x_T draw

    path = str(tmp_path / "student.pth")
    _jax_export(kind, jm, p, path)
    gen, im_size, im_channels, hint_channels, cap = serve.build_generator(
        _serve_args(kind, path), config)
    assert (im_size, im_channels, hint_channels, cap) == (8, 1, 3, None)
    out = gen(hint, None, 1, x_start=to_nchw(x_start))
    assert np.abs(to_nhwc(out) - ref).max() <= 1e-3 * np.abs(ref).max()
    # not clamped: the raw student output, whatever its range
    if kind == "consistency":
        model = cd_sample.load_student(config, path, "cpu")
        raw = cd_sample.generate(model, to_nchw(hint), 1, x_start=to_nchw(x_start))
    else:
        student = dmd_sample.load_student(config, path, "cpu")
        raw = dmd_sample.generate(student, to_nchw(hint), T, x_start=to_nchw(x_start))
    assert torch.equal(out, raw) and float(out.abs().max()) > 1.0
    g = torch.Generator().manual_seed(2)
    again = gen(hint, torch.Generator().manual_seed(2), 3)
    first = gen(hint, g, 3)
    torch.testing.assert_close(first, again, rtol=0, atol=0)
    if kind == "dmd":  # DMD ignores steps
        torch.testing.assert_close(gen(hint, torch.Generator().manual_seed(2), 1), first,
                                   rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["consistency", "dmd"])
def test_serve_http_students(kind, tmp_path):
    jm, p = _jax_student(kind, 50)
    path = str(tmp_path / "student.pth")
    _jax_export(kind, jm, p, path)
    server = serve.make_server(_serve_args(kind, path), _jax_server_config(tmp_path))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        health = json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=30).read())
        assert health == {"status": "ok", "model": kind, "warm": True, "max_batch": 2,
                          "max_steps": 8, "batch_window_ms": 2.0}
        buf = io.BytesIO()
        np.savez_compressed(buf, hints=np.zeros((2, 8, 8, 3), np.float32))
        for steps in (1, 4, 8):
            req = urllib.request.Request(f"{base}/generate_batch?steps={steps}",
                                         data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                assert r.status == 200 and r.headers["X-Batch-Rows"] == "2"
                with np.load(io.BytesIO(r.read())) as z:
                    assert z["samples"].shape == (2, 8, 8, 1)
        req = urllib.request.Request(f"{base}/generate_batch?steps=9", data=buf.getvalue(),
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=60)
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)
    assert not thread.is_alive()
