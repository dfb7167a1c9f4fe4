"""The port's background checkpoint saves (controlnet_tpu_torch.io.checkpoint:
``save_checkpoint_background``, ``wait_for_checkpoints``,
``restore_checkpoint_raw``) on CPU tensors, held to the contracts the JAX
package's tests set for its own (tests/test_config_data_io.py): the snapshot
is the value at call time, saves of one root serialise, a worker's failure
is raised by the next wait and then forgotten, ``max_to_keep`` holds under
background saves and when they mix with blocking ones, and a restore waits
for a write in flight.  Then the three trainers that save in the background
(``train_ddpm``, the consistency and the DMD trainers), each resumed, with
their calls of ``save_checkpoint_background`` counted.

A worker is held back where a test needs it in flight by a gate on
``save_file`` (the write), so no test depends on timing: the gate opens from
the test's own thread, or from a timer thread that opens it after 0.3 s.
Stream ordering on a card (the clone before an in-place optimizer step) is
what the CPU cannot show; chip_smoke.py checks it on the H100.
"""

import os
import threading

import numpy as np
import pytest
import torch
import yaml

from conftest import TINY_MODEL_CONFIG
from controlnet_tpu_torch.io import checkpoint as ckpt
from controlnet_tpu_torch.models.controlnet import ControlNet
from controlnet_tpu_torch.models.unet import UNet
from controlnet_tpu_torch.tools import train_consistency_controlnet_distilled as cd_train
from controlnet_tpu_torch.tools import train_ddpm
from controlnet_tpu_torch.tools import (
    train_distribution_matching_controlnet_distilled as dmd_train)
from controlnet_tpu_torch.train.state import create_train_state


def _steps(root) -> list[int]:
    return sorted(int(f[:-3]) for f in os.listdir(root) if f.endswith(".pt"))


@pytest.fixture
def gate(monkeypatch):
    """Holds every background write until ``gate.set()`` (or 30 s)."""
    event = threading.Event()
    real = ckpt.save_file

    def held(obj, path):
        if threading.current_thread() is not threading.main_thread():
            event.wait(timeout=30.0)
        real(obj, path)

    monkeypatch.setattr(ckpt, "save_file", held)
    yield event
    event.set()
    ckpt.wait_for_checkpoints()


def _open_soon(event: threading.Event) -> None:
    threading.Timer(0.3, event.set).start()


def test_snapshot_holds_the_value_at_call_time(tmp_path, gate):
    """The same tensor objects changed in place right after the call (as an
    optimizer step changes them), and a container of the tree changed too:
    the file holds the values and structure of the call."""
    w, m = torch.arange(8, dtype=torch.float32), torch.ones(3)
    inner = {"m": m, "step": 1}
    tree = {"w": w, "inner": inner, "moments": [torch.zeros(2), torch.full((2,), 2.0)]}
    path = ckpt.save_checkpoint_background(str(tmp_path), "model.pth", 1, tree)
    assert path == os.path.join(str(tmp_path), "model", "1.pt")
    assert not os.path.exists(path)  # the write is held
    w.add_(100.0)
    m.mul_(0.0)
    tree["moments"][1].add_(5.0)
    inner["step"] = 2
    inner["extra"] = torch.ones(1)
    gate.set()
    got, step = ckpt.restore_checkpoint(str(tmp_path), "model.pth")
    assert step == 1 and set(got) == {"w", "inner", "moments"}
    assert torch.equal(got["w"], torch.arange(8, dtype=torch.float32))
    assert set(got["inner"]) == {"m", "step"} and got["inner"]["step"] == 1
    assert torch.equal(got["inner"]["m"], torch.ones(3))
    assert torch.equal(got["moments"][0], torch.zeros(2))
    assert torch.equal(got["moments"][1], torch.full((2,), 2.0))


def test_two_saves_in_a_row_restore_right(tmp_path):
    d = str(tmp_path)
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    ckpt.save_checkpoint_background(d, "model.pth", 1, {"w": x, "step": 1})
    ckpt.save_checkpoint_background(d, "model.pth", 2, {"w": x * 10, "step": 2})
    got, step = ckpt.restore_checkpoint(d, "model.pth")
    assert step == 2 and got["step"] == 2 and torch.equal(got["w"], x * 10)
    got1, step1 = ckpt.restore_checkpoint_raw(d, "model.pth", step=1)
    assert step1 == 1 and torch.equal(got1["w"], x)
    ckpt.wait_for_checkpoints()  # nothing in flight: returns at once
    assert ckpt.latest_checkpoint(d, "model.pth") == 2


def test_worker_failure_is_raised_by_the_next_wait_then_drained(tmp_path, monkeypatch, capfd):
    def boom(obj, f, *args, **kwargs):
        raise OSError("synthetic write failure")

    monkeypatch.setattr(ckpt.torch, "save", boom)
    ckpt.save_checkpoint_background(str(tmp_path), "model.pth", 1, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match=r"1 background checkpoint save\(s\) failed: "
                                           r"OSError\('synthetic write failure'\)"):
        ckpt.wait_for_checkpoints()
    assert "background save of" in capfd.readouterr().err  # printed when it happened
    ckpt.wait_for_checkpoints()  # drained: a second wait is clean
    monkeypatch.undo()
    assert ckpt.latest_checkpoint(str(tmp_path), "model.pth") is None


def test_retention_under_background_saves(tmp_path):
    d = str(tmp_path)
    for s in range(1, 7):
        ckpt.save_checkpoint_background(d, "model.pth", s, {"w": torch.full((2,), float(s))},
                                        max_to_keep=3)
    ckpt.wait_for_checkpoints()
    assert _steps(os.path.join(d, "model")) == [4, 5, 6]
    # a best root under its own name keeps its own steps
    ckpt.save_checkpoint_background(d, "best.pth", 2, {"w": torch.zeros(2)}, max_to_keep=1)
    ckpt.save_checkpoint_background(d, "model.pth", 7, {"w": torch.zeros(2)}, max_to_keep=1)
    got, step = ckpt.restore_checkpoint(d, "model.pth")
    assert step == 7 and _steps(os.path.join(d, "model")) == [7]
    assert ckpt.latest_checkpoint(d, "best.pth") == 2


def test_retention_holds_when_blocking_and_background_saves_mix(tmp_path, gate):
    """A blocking save with max_to_keep while the root's background save is
    still held: it joins that worker before it prunes, so the older
    background step does not land after the prune."""
    d = str(tmp_path)
    ckpt.save_checkpoint_background(d, "model.pth", 5, {"w": torch.full((2,), 5.0)})
    _open_soon(gate)
    ckpt.save_checkpoint(d, "model.pth", 6, {"w": torch.full((2,), 6.0)}, max_to_keep=1)
    ckpt.wait_for_checkpoints()
    assert _steps(os.path.join(d, "model")) == [6]
    got, step = ckpt.restore_checkpoint(d, "model.pth")
    assert step == 6 and torch.equal(got["w"], torch.full((2,), 6.0))


def test_restore_waits_for_a_slow_write(tmp_path, gate):
    d = str(tmp_path)
    ckpt.save_checkpoint_background(d, "model.pth", 3, {"w": torch.full((4,), 3.0)})
    assert ckpt.latest_checkpoint(d, "model.pth") is None  # not written yet
    _open_soon(gate)
    got, step = ckpt.restore_checkpoint(d, "model.pth")
    assert step == 3 and torch.equal(got["w"], torch.full((4,), 3.0))


def _assert_same_tree(a, b, where=""):
    assert type(a) is type(b), where
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _assert_same_tree(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{where}/{i}")
    else:
        assert a == b, where


def test_background_file_equals_the_blocking_file(tmp_path):
    """A train state after one Adam step (its optimizer state dict shares the
    live per-parameter dicts), saved both ways: the files hold the same tree,
    key by key, with the same types."""
    torch.manual_seed(0)
    unet = UNet(1, TINY_MODEL_CONFIG)
    state = create_train_state(dict(unet.named_parameters()), 1e-3)
    loss = sum(p.square().sum() for p in unet.parameters())
    loss.backward()
    state.optimizer.step()
    state.step = 1
    d = str(tmp_path)
    blocking = ckpt.save_checkpoint(d, "a.pth", 1, {"state": state.state_dict(), "epoch": 1})
    background = ckpt.save_checkpoint_background(d, "b.pth", 1,
                                                 {"state": state.state_dict(), "epoch": 1})
    ckpt.wait_for_checkpoints()
    a, b = (torch.load(p, weights_only=True) for p in (blocking, background))
    _assert_same_tree(a, b)
    assert a["state"]["opt_state"]["state"]  # the moments are in the file


# --- the three trainers that save in the background ----------------------------------------

T = 10
N = 8  # images per split: 2 steps an epoch at batch 4


def _write_config(tmp_path, task: str, epochs: int) -> str:
    task_dir = tmp_path / task
    task_dir.mkdir(exist_ok=True)
    config = {
        "diffusion_params": {"num_timesteps": T, "beta_start": 1e-4, "beta_end": 0.02},
        "model_params": dict(TINY_MODEL_CONFIG),
        "train_params": {"task_name": str(task_dir), "batch_size": 4, "num_epochs": epochs,
                         "consistency_epochs": epochs, "distribution_matching_epochs": epochs,
                         "ddpm_lr": 1e-3, "consistency_lr": 1e-3, "distribution_matching_lr": 1e-3,
                         "ddpm_ckpt_name": "ddpm_ckpt.pth", "controlnet_ckpt_name": "cn.pth",
                         "ckpt_save_every_epochs": 1, "ckpt_max_to_keep": 1, "seed": 0},
    }
    path = tmp_path / f"{task}_{epochs}.yaml"
    path.write_text(yaml.safe_dump(config))
    return str(path)


@pytest.fixture
def data(tmp_path):
    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        np.save(tmp_path / f"{split}_images.npy", rng.integers(0, 256, (N, 8, 8), np.uint8))
        np.save(tmp_path / f"{split}_hints.npy",
                (rng.uniform(size=(N, 8, 8, 3)) < 0.2).astype(np.float32))
    torch.manual_seed(1)
    return {split: str(tmp_path / f"{split}_images.npy") for split in ("train", "test")} | {
        "hints": str(tmp_path / "train_hints.npy"), "teacher": ControlNet(1, TINY_MODEL_CONFIG)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("tool", ["train_ddpm", "consistency", "dmd"])
def test_trainers_save_in_the_background_and_resume(tmp_path, data, tool, monkeypatch):
    """Each trainer for one epoch, then resumed to a second: every epoch's
    checkpoint (and DMD's best) goes through save_checkpoint_background, the
    resumed run starts from it, and the final files are in place."""
    module = {"train_ddpm": train_ddpm, "consistency": cd_train, "dmd": dmd_train}[tool]
    calls = []
    real = module.save_checkpoint_background

    def spy(ckpt_dir, name, step, tree, max_to_keep=None):
        calls.append((name, step))
        return real(ckpt_dir, name, step, tree, max_to_keep=max_to_keep)

    monkeypatch.setattr(module, "save_checkpoint_background", spy)
    (tmp_path / "task").mkdir()
    torch.save(data["teacher"].state_dict(), tmp_path / "task" / "cn.pth")
    histories = []
    for epochs in (1, 2):
        path = _write_config(tmp_path, "task", epochs)
        if tool == "train_ddpm":
            histories.append(train_ddpm.train(path, data["train"], device="cpu"))
        elif tool == "consistency":
            histories.append(cd_train.train(path, data["train"], data["hints"], device="cpu"))
        else:
            histories.append(dmd_train.train(path, images_path=data["train"],
                                             test_images_path=data["test"],
                                             hints_path=data["hints"], test_hints_path=None,
                                             no_plots=True, device="cpu"))
    assert [h["epochs"] for h in histories] == [[1], [2]]
    task = tmp_path / "task"
    if tool == "train_ddpm":
        assert calls == [("ddpm_ckpt.pth", 1), ("ddpm_ckpt.pth", 2)]
        assert _steps(task / "ddpm_ckpt") == [2] and (task / "ddpm_ckpt.pth").exists()
    elif tool == "consistency":
        assert calls == [(cd_train.CKPT_NAME, 1), (cd_train.CKPT_NAME, 2)]
        assert _steps(task / cd_train.CKPT_NAME[:-4]) == [2]
        assert (task / cd_train.CKPT_NAME).exists()
    else:
        latest = [c for c in calls if c[0] == dmd_train.CKPT_NAME]
        best = [c for c in calls if c[0] == dmd_train.BEST_CKPT_NAME]
        assert latest == [(dmd_train.CKPT_NAME, 1), (dmd_train.CKPT_NAME, 2)]
        assert best and best[0] == (dmd_train.BEST_CKPT_NAME, 1) and len(calls) == 2 + len(best)
        assert (task / dmd_train.REF_CKPT).exists() and (task / dmd_train.BEST_REF_CKPT).exists()
        assert (task / dmd_train.BEST_VAL).exists()
