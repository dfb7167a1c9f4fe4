"""The port's conversion tools and small modules on the CPU against the JAX
package: ``export_torch_checkpoint``, the two PNG extractors,
``config_utils``, and the float32 pin of every entry point.

* The exporter, for each of its seven types: a port resume checkpoint of
  weights drawn by the JAX package (carried across with ``io/jax_params.py``)
  exports to a ``.pth`` that loads with ``strict=True`` into the port module,
  with the keys, payload keys and values of the JAX exporter's payload on the
  same weights (``controlnet_tpu.io.torch_export``, what
  ``tools/export_torch_checkpoint.py`` writes); the newest step by default.
  A real two-epoch ``train_ddpm_controlnet`` run exported at ``--step 1`` is
  bit-identical to the final ``.pth`` of a one-epoch run; an existing output
  is overwritten only with ``--force``.
* The extractors write byte-identical trees to the JAX converters'.
* ``config_utils`` has the JAX shim's ``__all__``, and each validator raises
  where the JAX one does.
* After ``resolve_device`` and a tool's ``main``, both TF32 switches read
  False, and reading them raises nothing.
"""

import csv
import filecmp
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _torch_port_util import NARROW_LDM, Z, np_tree, random_params
from conftest import TINY_MODEL_CONFIG, TINY_VAE_CONFIG
from controlnet_tpu.io import torch_export as jax_export
from controlnet_tpu.models.consistency import ConsistencyDistilled as JaxConsistencyDistilled
from controlnet_tpu.models.controlnet import ControlNet as JaxControlNet
from controlnet_tpu.models.dmd import DistributionMatchingControlNet as JaxDMDStudent
from controlnet_tpu.models.unet import UNet as JaxUNet
from controlnet_tpu.models.vae import VAE as JaxVAE
from controlnet_tpu_torch.io import jax_params
from controlnet_tpu_torch.io.checkpoint import save_checkpoint
from controlnet_tpu_torch.models.consistency import ConsistencyControlNet
from controlnet_tpu_torch.models.controlnet import ControlNet
from controlnet_tpu_torch.models.dmd import DistributionMatchingControlNet
from controlnet_tpu_torch.models.unet import UNet
from controlnet_tpu_torch.models.vae import VAE
from controlnet_tpu_torch.tools import export_torch_checkpoint as export_tool
from controlnet_tpu_torch.tools import train_ddpm_controlnet
from controlnet_tpu_torch.train.state import create_train_state

CFG = dict(TINY_MODEL_CONFIG)
CONFIG = {
    "dataset_params": {"im_size": 16, "im_channels": 3, "canny_im_size": 32},
    "diffusion_params": {"num_timesteps": 8, "beta_start": 1e-4, "beta_end": 0.02},
    "model_params": CFG,
    "ldm_params": NARROW_LDM,
    "autoencoder_params": dict(TINY_VAE_CONFIG, z_channels=Z),
    "train_params": {"ddpm_ckpt_name": "ddpm.pth", "ldm_ckpt_name": "ldm.pth",
                     "controlnet_ckpt_name": "cn.pth",
                     "vae_autoencoder_ckpt_name": "vae.pth"},
}
FACTOR = 4  # canny_im_size 32 over the 8x8 latents of one VAE downsample


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the suite runs in
    parallel workers, and at these sizes torch's thread pool only contends
    with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_config(root, task: str, **train) -> str:
    config = {**CONFIG, "train_params": {**CONFIG["train_params"],
                                         "task_name": str(root / task), **train}}
    path = root / f"{task}.yaml"
    path.write_text(yaml.safe_dump(config))
    return str(path)


def _state(module: torch.nn.Module, params: dict | None = None) -> dict:
    """A trainer's TrainState tree over ``params`` (default: all of ``module``'s)."""
    return create_train_state(params or dict(module.named_parameters()), 1e-3).state_dict()


def _case(kind: str, seed: int):
    """(JAX payload, port module, the port trainer's checkpoint tree, its name)
    for ``kind``, from one JAX parameter tree."""
    if kind in ("unet", "ldm_unet"):
        ch, mp = (1, CFG) if kind == "unet" else (Z, NARROW_LDM)
        p = random_params(JaxUNet(ch, mp), seed)
        port = UNet(ch, mp)
        port.load_state_dict(jax_params.unet_state_dict_from_jax(np_tree(p)), strict=True)
        return jax_export.export_unet(p), port, _state(port), (
            "ddpm.pth" if kind == "unet" else "ldm.pth")
    if kind in ("controlnet", "ldm_controlnet"):
        ldm = kind == "ldm_controlnet"
        ch, mp, factor = (Z, NARROW_LDM, FACTOR) if ldm else (1, CFG, None)
        jcn = JaxControlNet(ch, mp, down_sample_factor=factor)
        p = random_params(jcn, seed)
        port = ControlNet(ch, mp, model_locked=True, down_sample_factor=factor)
        port.load_state_dict(jax_params.controlnet_state_dict_from_jax(np_tree(p), ldm=ldm),
                             strict=True)
        trainable, frozen = port.split_params()
        tree = {"state": _state(port, trainable),
                "frozen": {k: v.detach() for k, v in frozen.items()}}
        return jax_export.export_controlnet(p, jcn), port, tree, "cn.pth"
    if kind == "vae":
        p = random_params(JaxVAE(3, CONFIG["autoencoder_params"]), seed)
        port = VAE(3, CONFIG["autoencoder_params"])
        port.load_state_dict(jax_params.vae_state_dict_from_jax(np_tree(p)), strict=True)
        return jax_export.export_vae(p), port, {"g": _state(port), "d": {}}, "vae.pth"
    if kind == "consistency":
        jstudent = JaxConsistencyDistilled(1, CFG, use_ddpm_teacher=False).student
        p, ema = random_params(jstudent, seed), random_params(jstudent, seed + 100)
        port = ConsistencyControlNet(1, CFG)
        port.load_state_dict(jax_params.student_state_dict_from_jax(np_tree(p)), strict=True)
        ema_sd = jax_params.student_state_dict_from_jax(np_tree(ema))
        payload = {"epoch": 3,
                   "model_state_dict": jax_export.export_distilled_student(p, jstudent),
                   "ema_teacher_state_dict": jax_export.export_distilled_student(ema, jstudent),
                   "model_config": CFG}
        return payload, port, {"state": _state(port), "ema": ema_sd}, \
            "consistency_controlnet_distilled.pth"
    jstudent = JaxDMDStudent(1, CFG)
    p = random_params(jstudent, seed)
    port = DistributionMatchingControlNet(1, CFG)
    port.load_state_dict(jax_params.student_state_dict_from_jax(np_tree(p)), strict=True)
    payload = {"epoch": 3, "model_state_dict": jax_export.export_distilled_student(p, jstudent),
               "config": None}
    return payload, port, {"state": _state(port)}, "distribution_matching_controlnet_distilled.pth"


def _assert_same_tensors(got: dict, ref: dict) -> None:
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("kind", export_tool.TYPES)
def test_export_round_trips_each_type(tmp_path, kind):
    ref, port, tree, name = _case(kind, seed=export_tool.TYPES.index(kind))
    config = _write_config(tmp_path, "task")
    task = str(tmp_path / "task")
    # step 1 holds other weights: the newest step (3) is exported by default
    save_checkpoint(task, name, 1, _zeroed(tree))
    save_checkpoint(task, name, 3, tree)
    out = export_tool.main(["--config", config, "--type", kind])
    want = {"dmd": "distribution_matching_controlnet_distilled_ckpt.pth"}.get(kind, name)
    assert out == os.path.join(task, want)
    payload = torch.load(out, map_location="cpu", weights_only=True)
    if kind in ("consistency", "dmd"):
        assert set(payload) == set(ref) and payload["epoch"] == 3
        _assert_same_tensors(payload["model_state_dict"], ref["model_state_dict"])
        port.load_state_dict(payload["model_state_dict"], strict=True)
        if kind == "consistency":
            _assert_same_tensors(payload["ema_teacher_state_dict"], ref["ema_teacher_state_dict"])
            assert payload["model_config"] == CFG
        else:
            assert payload["config"] == yaml.safe_load(open(config))
    else:
        _assert_same_tensors(payload, ref)
        port.load_state_dict(payload, strict=True)


def _zeroed(tree):
    """``tree`` with every tensor zeroed (a stale step)."""
    if isinstance(tree, dict):
        return {k: _zeroed(v) for k, v in tree.items()}
    return torch.zeros_like(tree) if isinstance(tree, torch.Tensor) else tree


def test_export_of_a_trainer_step_is_bit_identical_and_needs_force(tmp_path):
    """Epoch 1 of a two-epoch run, exported at --step 1, is the final .pth
    of a one-epoch run; the default output (the trainer's own final .pth)
    is overwritten only with --force."""
    rng = np.random.default_rng(0)
    np.save(tmp_path / "images.npy", rng.integers(0, 256, (8, 8, 8), dtype=np.uint8))
    np.save(tmp_path / "hints.npy", (rng.uniform(size=(8, 8, 8, 3)) < 0.2).astype(np.float32))
    torch.manual_seed(0)
    base = {k: v.clone() for k, v in UNet(1, CFG).state_dict().items()}
    paths = {}
    for task, epochs in (("two", 2), ("one", 1)):
        os.makedirs(tmp_path / task)
        torch.save(base, tmp_path / task / "ddpm.pth")
        paths[task] = _write_config(tmp_path, task, controlnet_epochs=epochs, batch_size=4,
                                    controlnet_lr=1e-3, seed=0)
        train_ddpm_controlnet.main(["--config", paths[task], "--images",
                                    str(tmp_path / "images.npy"), "--hints",
                                    str(tmp_path / "hints.npy"), "--device", "cpu"])
    out = str(tmp_path / "step1.pth")
    export_tool.main(["--config", paths["two"], "--type", "controlnet", "--step", "1",
                      "--out", out])
    got = torch.load(out, weights_only=True)
    want = torch.load(tmp_path / "one" / "cn.pth", weights_only=True)
    last = torch.load(tmp_path / "two" / "cn.pth", weights_only=True)
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert not all(torch.equal(got[k], last[k]) for k in last)  # epoch 2 moved the weights
    ControlNet(1, CFG).load_state_dict(got, strict=True)

    with pytest.raises(SystemExit, match="refusing to overwrite"):
        export_tool.main(["--config", paths["two"], "--type", "controlnet", "--step", "1"])
    assert all(torch.equal(v, torch.load(tmp_path / "two" / "cn.pth", weights_only=True)[k])
               for k, v in last.items())
    export_tool.main(["--config", paths["two"], "--type", "controlnet", "--step", "1",
                      "--force"])
    forced = torch.load(tmp_path / "two" / "cn.pth", weights_only=True)
    assert all(torch.equal(forced[k], want[k]) for k in want)
    with pytest.raises(FileNotFoundError, match="train first"):
        export_tool.main(["--config", _write_config(tmp_path, "empty"), "--type", "unet"])


# -------------------------------------------------------------- extractors


def _same_tree(a, b) -> None:
    files_a = sorted(os.path.relpath(os.path.join(d, f), a)
                     for d, _, fs in os.walk(a) for f in fs)
    files_b = sorted(os.path.relpath(os.path.join(d, f), b)
                     for d, _, fs in os.walk(b) for f in fs)
    assert files_a == files_b and files_a
    match, mismatch, errors = filecmp.cmpfiles(a, b, files_a, shallow=False)
    assert not mismatch and not errors


def test_mnist_extractor_writes_the_jax_tree(tmp_path):
    from controlnet_tpu.utils import extract_mnist_images as jax_mnist
    from controlnet_tpu_torch.utils import extract_mnist_images

    rng = np.random.default_rng(0)
    path = tmp_path / "mnist.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["label"] + [f"pixel{i}" for i in range(784)])
        for label in (3, 7, 3):
            w.writerow([label] + rng.integers(0, 256, 784).tolist())
    jax_mnist.extract_images(str(tmp_path / "jax"), str(path))
    extract_mnist_images.main(["--csv", str(path), "--save_dir", str(tmp_path / "port")])
    _same_tree(tmp_path / "jax", tmp_path / "port")
    assert sorted(os.listdir(tmp_path / "port" / "3")) == ["0.png", "2.png"]


def test_cifar_extractor_writes_the_jax_tree(tmp_path):
    from controlnet_tpu.utils import extract_cifar_images as jax_cifar
    from controlnet_tpu_torch.utils import extract_cifar_images

    rng = np.random.default_rng(1)
    batches = tmp_path / "cifar-10-batches-py"
    os.makedirs(batches)
    for name, labels in (("data_batch_1", [0, 9, 0, 4]), ("test_batch", [9, 2])):
        data = rng.integers(0, 256, (len(labels), 3072), dtype=np.uint8)
        with open(batches / name, "wb") as f:
            pickle.dump({b"data": data, b"labels": labels}, f)
    jax_cifar.extract_images(str(batches), str(tmp_path / "jax"))
    extract_cifar_images.main(["--batches_dir", str(batches), "--save_root",
                               str(tmp_path / "port")])
    _same_tree(tmp_path / "jax", tmp_path / "port")
    assert sorted(os.listdir(tmp_path / "port" / "train" / "airplane")) == ["0.png", "1.png"]
    assert sorted(os.listdir(tmp_path / "port" / "test")) == ["bird", "truck"]
    with pytest.raises(SystemExit):  # no --batches_dir and no --download
        extract_cifar_images.main(["--save_root", str(tmp_path / "none")])
    assert not os.path.exists(tmp_path / "none")


# ------------------------------------------------------------ config_utils


def _validator_cases():
    ok_cond = {"class_condition_config": {"num_classes": 10},
               "text_condition_config": {"text_embed_dim": 8},
               "image_condition_config": {"image_condition_input_channels": 3,
                                          "image_condition_output_channels": 3}}
    cases = [("validate_class_config", (ok_cond,)), ("validate_class_config", ({},)),
             ("validate_class_config", ({"class_condition_config": {}},)),
             ("validate_text_config", (ok_cond,)), ("validate_text_config", ({},)),
             ("validate_text_config", ({"text_condition_config": {}},)),
             ("validate_image_config", (ok_cond,)), ("validate_image_config", ({},)),
             ("validate_image_config", ({"image_condition_config": {
                 "image_condition_input_channels": 3}},)),
             ("validate_image_config", ({"image_condition_config": {
                 "image_condition_output_channels": 3}},))]
    # inputs: (kind, cond shapes or None, x batch, num_classes)
    for shape, b in (((2, 3, 4, 4), 2), ((3, 3, 4, 4), 2), ((2, 4, 4), 2), (None, 2)):
        cases.append(("validate_image_conditional_input", ("image", shape, b)))
    for shape, b in (((2, 10), 2), ((2, 9), 2), ((3, 10), 2), (None, 2)):
        cases.append(("validate_class_conditional_input", ("class", shape, b)))
    return cases


@pytest.mark.parametrize("name,args", _validator_cases())
def test_config_utils_validators_raise_where_jax_does(name, args):
    from controlnet_tpu.utils import config_utils as jax_utils
    from controlnet_tpu_torch.utils import config_utils

    assert config_utils.__all__ == jax_utils.__all__
    assert config_utils.get_config_value({"a": 1}, "b", 2) == jax_utils.get_config_value(
        {"a": 1}, "b", 2) == 2

    def outcome(fn, array):
        if name.endswith("_input"):
            key, shape, b = args
            cond = {} if shape is None else {key: array(np.zeros(shape, np.float32))}
            call = (cond, array(np.zeros((b, 1, 4, 4), np.float32)))
            call += (10,) if key == "class" else ()
        else:
            call = args
        try:
            fn(*call)
        except ValueError as e:
            return type(e).__name__
        return None

    ref = outcome(getattr(jax_utils, name), jnp.asarray)
    got = outcome(getattr(config_utils, name), torch.from_numpy)
    assert got == ref


# ------------------------------------------------------------- float32 pin


def test_entry_points_pin_float32_without_tf32(tmp_path):
    from controlnet_tpu_torch.device import resolve_device
    from controlnet_tpu_torch.tools import eval_metrics

    def set_tf32(on: bool) -> None:
        torch.backends.cudnn.allow_tf32 = on
        torch.backends.cuda.matmul.allow_tf32 = on

    def read() -> tuple:
        return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32

    set_tf32(True)
    assert read() == (True, True)
    assert resolve_device("cpu") == torch.device("cpu")
    assert read() == (False, False)
    from PIL import Image

    os.makedirs(tmp_path / "a")
    for i in range(3):
        Image.fromarray(np.full((16, 16), 40 * i, np.uint8)).save(tmp_path / "a" / f"{i}.png")
    set_tf32(True)
    eval_metrics.main(["--dir_a", str(tmp_path / "a"), "--dir_b", str(tmp_path / "a"),
                       "--device", "cpu"])
    assert read() == (False, False)
    set_tf32(True)
    with pytest.raises(FileNotFoundError):  # the exporter pins too, before it finds nothing
        export_tool.main(["--config", _write_config(tmp_path, "t"), "--type", "dmd"])
    assert read() == (False, False)
