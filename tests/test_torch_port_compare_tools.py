"""The port's comparison and evaluation tools on the CPU against the JAX tools:
``compare_controlnet_models``, ``compare_all_controlnet_models``,
``eval_metrics`` and ``utils/profiling``.

At the tiny config (8x8, T 8) with weights drawn by the JAX package and
carried across with ``io/jax_params.py``:

* the test batch the tools draw equals the JAX tools' draw exactly;
* the DDPM x0 of the compare path, on a schedule of ``--ddpm_steps`` with x_T
  and step noise injected, equals JAX ``make_ddpm_sampler`` within 2e-4 (the
  samplers' limit); each student's 1 step from an injected x_T is within
  1e-3 of max|out| (the served students' limit);
* both tools write the JAX tools' artifact names, metrics lines (each line
  matches one of the JAX tool's f-strings, read from its source) and
  ``timing_data.npy`` keys; compare_all skips a missing model and handles
  none found;
* eval_metrics: ``load_images`` exact; with the JAX networks carried in,
  features within 1e-4 of max|feat| and LPIPS within 1e-4; the Fréchet
  distance, ``_stats`` and the bootstrap CI on the same feature rows to
  1e-10; FFD end to end only at n > 256, where the covariances have full
  rank; the CLI's JSON keys, FFD(a, a) ~ 0;
* ``StepTimer.stats`` equals JAX's on the same clock readings, and ``trace``
  writes a trace file.
"""

import ast
import glob
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _torch_port_util import np_tree, random_params, to_nchw, to_nhwc
from conftest import TINY_MODEL_CONFIG
from controlnet_tpu.models.consistency import ConsistencyDistilled as JaxConsistencyDistilled
from controlnet_tpu.models.controlnet import ControlNet as JaxControlNet
from controlnet_tpu.models.dmd import DistributionMatchingControlNet as JaxDMDStudent
from controlnet_tpu.models.dmd import FeatureExtractor as JaxFeatureExtractor
from controlnet_tpu.models.lpips import LPIPS as JaxLPIPS
from controlnet_tpu.sample.ddpm import make_ddpm_sampler as jax_make_ddpm_sampler
from controlnet_tpu.schedules.linear import make_linear_schedule as jax_schedule
from controlnet_tpu_torch.data.synthetic import make_synthetic_image_tree
from controlnet_tpu_torch.io import jax_params
from controlnet_tpu_torch.models.dmd import FeatureExtractor
from controlnet_tpu_torch.models.lpips import LPIPS
from controlnet_tpu_torch.tools import compare_all_controlnet_models as compare_all
from controlnet_tpu_torch.tools import compare_controlnet_models as compare
from controlnet_tpu_torch.tools import eval_metrics
from controlnet_tpu_torch.tools.train_consistency_controlnet_distilled import CKPT_NAME
from controlnet_tpu_torch.tools.train_distribution_matching_controlnet_distilled import REF_CKPT
from controlnet_tpu_torch.utils import profiling
from tools import eval_metrics as jax_eval

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(TINY_MODEL_CONFIG)
T = 8  # the config's num_timesteps
STEPS = 6  # --ddpm_steps: the compare path's schedule, not the config's
N = 3
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the suite runs in
    parallel workers, and at these sizes torch's thread pool only contends
    with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_models(task: str, which=("ddpm", "consistency", "dmd")) -> dict:
    """The three models' reference-format .pth files at the names the port's
    trainers write, from JAX parameter trees; returns the trees."""
    os.makedirs(task, exist_ok=True)
    jcn = JaxControlNet(1, CFG)
    jcons = JaxConsistencyDistilled(1, CFG, use_ddpm_teacher=False)
    jdmd = JaxDMDStudent(1, CFG)
    trees = {"ddpm": random_params(jcn, 1), "consistency": random_params(jcons.student, 2),
             "dmd": random_params(jdmd, 3)}
    if "ddpm" in which:
        torch.save(jax_params.controlnet_state_dict_from_jax(np_tree(trees["ddpm"])),
                   os.path.join(task, "cn.pth"))
    student = {k: jax_params.student_state_dict_from_jax(np_tree(trees[k]))
               for k in ("consistency", "dmd")}
    if "consistency" in which:
        torch.save({"epoch": 1, "model_state_dict": student["consistency"],
                    "ema_teacher_state_dict": student["consistency"], "model_config": CFG},
                   os.path.join(task, CKPT_NAME))
    if "dmd" in which:
        torch.save({"epoch": 1, "model_state_dict": student["dmd"], "config": {}},
                   os.path.join(task, REF_CKPT))
    return dict(trees=trees, jax=dict(ddpm=jcn, consistency=jcons, dmd=jdmd))


def _config_path(root, task: str) -> str:
    config = {
        "dataset_params": {"task_name": "mnist", "im_path": str(root / "test"),
                           "im_test_path": str(root / "test")},
        "diffusion_params": {"num_timesteps": T, "beta_start": 1e-4, "beta_end": 0.02},
        "model_params": CFG,
        "train_params": {"task_name": str(root / task), "controlnet_ckpt_name": "cn.pth"},
    }
    path = root / f"{task}.yaml"
    path.write_text(yaml.safe_dump(config))
    return str(path)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """A digit-like test split (the port's synthetic tree) and a task with
    all three models."""
    root = tmp_path_factory.mktemp("compare_tools")
    make_synthetic_image_tree(str(root / "test"), num_classes=2, per_class=5, size=8, seed=3)
    models = _write_models(str(root / "full"))
    return types.SimpleNamespace(root=root, config=_config_path(root, "full"), **models)


def _load(path):
    from controlnet_tpu_torch.config import load_config

    return load_config(path)


def test_drawn_batch_equals_jax_draw(ws):
    from controlnet_tpu import cli as jax_cli
    from controlnet_tpu.data.datasets import iterate_batches as jax_iterate

    config = _load(ws.config)
    reader = jax_cli.build_dataset(str(ws.root / "full"), config["dataset_params"], "test",
                                   return_hints=True)
    for seed in (0, 5):
        ref_ims, ref_hints = next(jax_iterate(reader, N, shuffle=True, seed=seed))
        ims, hints = compare.draw_test_batch(config, N, seed, None, CPU)
        np.testing.assert_array_equal(ims, ref_ims)
        np.testing.assert_array_equal(hints, ref_hints)
    # --hint_backend tpu: the same images, the port's canny of them
    ims_tpu, hints_tpu = compare.draw_test_batch(config, N, 5, "tpu", CPU)
    np.testing.assert_array_equal(ims_tpu, ref_ims)
    assert hints_tpu.shape == (N, 8, 8, 3) and set(np.unique(hints_tpu)) <= {0.0, 1.0}


def _jax_noise(key, shape, steps):
    """x_T and the per-step noise, drawn as the JAX ancestral sampler draws them."""
    k0, key = jax.random.split(key)
    x_start = np.asarray(jax.random.normal(k0, shape, jnp.float32))
    zs = []
    for _ in range(steps):
        key, kstep = jax.random.split(key)
        zs.append(np.asarray(jax.random.normal(kstep, shape, jnp.float32)))
    return x_start, np.stack(zs)


def test_ddpm_path_matches_jax_sampler_on_ddpm_steps(ws):
    config = _load(ws.config)
    _, hints = compare.draw_test_batch(config, N, 0, None, CPU)
    jcn, p = ws.jax["ddpm"], ws.trees["ddpm"]
    shape = (N, 8, 8, 1)
    sampler = jax_make_ddpm_sampler(lambda pp, x, t, f: jcn(pp, x, t, hint_features=f),
                                    jax_schedule(STEPS, 1e-4, 0.02), shape, record_every=STEPS)
    key = jax.random.PRNGKey(4)
    ref, _ = sampler(p, key, jcn.hint_features(p, jnp.asarray(hints)))
    x_start, zs = _jax_noise(key, shape, STEPS)
    generate = compare.make_generator("ddpm", config, hints, STEPS, CPU)
    got = generate(0, x_start=to_nchw(x_start),
                   step_noise=torch.from_numpy(zs.transpose(0, 1, 4, 2, 3).copy()))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(ref), atol=2e-4)


@pytest.mark.parametrize("model", ["consistency", "dmd"])
def test_student_one_step_matches_jax(ws, model):
    config = _load(ws.config)
    _, hints = compare.draw_test_batch(config, N, 0, None, CPU)
    shape = (N, 8, 8, 1)
    key = jax.random.PRNGKey(6)
    h = jnp.asarray(hints)
    if model == "consistency":
        jc = ws.jax["consistency"]
        ref = jax.jit(lambda sp, hh, k: jc.generate({"student": sp}, hh, shape, k, 1))(
            ws.trees["consistency"], h, key)
        x_t = np.asarray(jax.random.normal(key, shape))
    else:
        x_t = np.asarray(jax.random.normal(key, shape))
        ref = jax.jit(ws.jax["dmd"].__call__)(ws.trees["dmd"], jnp.asarray(x_t),
                                              jnp.full((N,), STEPS - 1, jnp.int32), h)
    ref = np.asarray(ref)
    got = compare.make_generator(model, config, hints, STEPS, CPU)(0, x_start=to_nchw(x_t))
    assert np.abs(to_nhwc(got) - ref).max() <= 1e-3 * np.abs(ref).max()


def _jax_line_patterns(tool: str) -> list:
    """Regexes of the metrics lines the JAX tool builds in ``compare_models``:
    each f-string with its fields as wildcards."""
    tree = ast.parse(open(os.path.join(REPO, "tools", f"{tool}.py")).read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "compare_models")
    exprs = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and [getattr(t, "id", None) for t in node.targets] == [
                "lines"]:
            exprs += node.value.elts
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "append" and getattr(node.func.value, "id", None) == "lines"):
            exprs += node.args
    pats = []
    for e in exprs:
        if isinstance(e, ast.JoinedStr):
            pats.append("".join(re.escape(v.value) if isinstance(v, ast.Constant) else ".+?"
                                for v in e.values))
        else:
            pats.append(re.escape(eval(compile(ast.Expression(e), tool, "eval"))))
    return pats


def _jax_timing_keys(tool: str) -> set:
    """The keys of the dict the JAX tool saves as timing_data.npy."""
    tree = ast.parse(open(os.path.join(REPO, "tools", f"{tool}.py")).read())
    save = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute) and n.func.attr == "save")
    if isinstance(save.args[1], ast.Dict):
        return {k.value for k in save.args[1].keys}
    return {n.slice.value for n in ast.walk(tree) if isinstance(n, ast.Subscript)
            and getattr(n.value, "id", None) == save.args[1].id
            and isinstance(n.slice, ast.Constant)}


def _check_artifacts(out_dir: str, tool: str, models: int) -> set:
    """The grids, the metrics lines against the JAX tool's; returns the keys
    of timing_data.npy, each one of the JAX tool's."""
    assert sorted(os.listdir(out_dir)) == [f"comparison_{i:03d}.png" for i in range(N)] + [
        "performance_metrics.txt", "timing_data.npy"]
    from PIL import Image

    im = np.asarray(Image.open(os.path.join(out_dir, "comparison_000.png")))
    assert im.shape == (12, 2 + (2 + models) * 10)  # one row: hint, original, each model
    pats = _jax_line_patterns(tool)
    lines = open(os.path.join(out_dir, "performance_metrics.txt")).read().splitlines()
    for line in lines:
        assert any(re.fullmatch(p, line) for p in pats), line
    timings = np.load(os.path.join(out_dir, "timing_data.npy"), allow_pickle=True).item()
    assert set(timings) <= _jax_timing_keys(tool)
    return set(timings)


def test_compare_tool_artifacts_carry_the_jax_names(ws, capsys):
    out = compare.main(["--config", ws.config, "--num_samples", str(N), "--ddpm_steps",
                        str(STEPS), "--device", "cpu"])
    out_dir = os.path.join(ws.root, "full", "model_comparison")
    keys = _check_artifacts(out_dir, "compare_controlnet_models", 2)
    assert keys == _jax_timing_keys("compare_controlnet_models")
    lines = open(os.path.join(out_dir, "performance_metrics.txt")).read().splitlines()
    assert len(lines) == 8 and lines[3] == f"DDPM steps: {STEPS}   Consistency steps: 1"
    assert out["samples"]["ddpm"].shape == (N, 8, 8, 1)
    assert np.isfinite(out["samples"]["consistency"]).all()
    assert out["timings"]["ddpm_times"] == [out["timings"]["ddpm_total"] / N] * N


def test_compare_all_artifacts_carry_the_jax_names(ws):
    out = compare_all.main(["--config", ws.config, "--num_samples", str(N), "--ddpm_steps",
                            str(STEPS), "--device", "cpu"])
    out_dir = os.path.join(ws.root, "full", "all_model_comparison")
    assert _check_artifacts(out_dir, "compare_all_controlnet_models", 3) == {
        "ddpm", "consistency", "dmd"} == _jax_timing_keys("compare_all_controlnet_models")
    assert list(out["timings"]) == ["ddpm", "consistency", "dmd"]
    lines = open(os.path.join(out_dir, "performance_metrics.txt")).read().splitlines()
    assert [ln.split(":")[0] for ln in lines[-2:]] == ["speedup consistency vs ddpm",
                                                      "speedup dmd vs ddpm"]
    # the same draws as the two-model tool: its DDPM and consistency samples
    two = compare.main(["--config", ws.config, "--num_samples", str(N), "--ddpm_steps",
                        str(STEPS), "--device", "cpu"])
    for m in ("ddpm", "consistency"):
        np.testing.assert_array_equal(out["samples"][m], two["samples"][m])


def test_compare_all_skips_missing_models_and_handles_none(ws, capsys):
    _write_models(str(ws.root / "ddpm_only"), which=("ddpm",))
    out = compare_all.main(["--config", _config_path(ws.root, "ddpm_only"), "--num_samples",
                            str(N), "--ddpm_steps", "2", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "Skipping consistency model: " in printed and "Skipping DMD model: " in printed
    assert list(out["timings"]) == ["ddpm"]
    out_dir = os.path.join(ws.root, "ddpm_only", "all_model_comparison")
    assert "speedup" not in open(os.path.join(out_dir, "performance_metrics.txt")).read()
    assert _check_artifacts(out_dir, "compare_all_controlnet_models", 1) == {"ddpm"}

    os.makedirs(ws.root / "none")
    assert compare_all.main(["--config", _config_path(ws.root, "none"), "--num_samples",
                             str(N), "--device", "cpu"]) is None
    printed = capsys.readouterr().out
    assert "Skipping DDPM ControlNet: " in printed
    assert "No model checkpoints found — nothing to compare" in printed
    assert os.listdir(ws.root / "none") == []


@pytest.mark.parametrize("tool", [compare, compare_all])
def test_compare_tools_raise_without_cuda_unless_cpu(ws, monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--config", ws.config, "--num_samples", str(N)])


# ---------------------------------------------------------------- eval_metrics


def _png_tree(d, n: int, size: int, channels: int, seed: int) -> np.ndarray:
    from PIL import Image

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    ims = rng.integers(0, 256, (n, size, size, channels), dtype=np.uint8)
    for i, im in enumerate(ims):
        Image.fromarray(im[..., 0] if channels == 1 else im).save(os.path.join(d, f"{i:04d}.png"))
    return ims


@pytest.mark.parametrize("channels", [1, 3])
def test_load_images_equals_jax(tmp_path, channels):
    _png_tree(tmp_path, 5, 8, channels, seed=channels)
    # a jpg too, and a file the loaders skip
    from PIL import Image

    Image.fromarray(np.full((8, 8, 3), 99, np.uint8)).save(tmp_path / "x.jpg")
    (tmp_path / "notes.txt").write_text("skip")
    got = eval_metrics.load_images(str(tmp_path), channels)
    ref = jax_eval.load_images(str(tmp_path), channels)
    assert got.dtype == ref.dtype and got.shape == (6, 8, 8, channels)
    np.testing.assert_array_equal(got, ref)


def _carried_nets(channels: int, seed: int):
    """The JAX tool's seeded networks and the port's copies of them."""
    jfe, jlp = JaxFeatureExtractor(in_channels=channels), JaxLPIPS()
    fp, lp = jfe.init(jax.random.PRNGKey(seed)), jlp.init(jax.random.PRNGKey(seed + 1))
    fe = FeatureExtractor(channels)
    fe.load_state_dict(jax_params.features_state_dict_from_jax(np_tree(fp)), strict=True)
    lpips = LPIPS()
    lpips.load_state_dict(jax_params.lpips_state_dict_from_jax(np_tree(lp)), strict=True)
    return (jfe, fp), fe, lpips


def test_features_and_lpips_match_jax_with_carried_networks():
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, (70, 16, 16, 1)).astype(np.float32)  # batches of 64 and 6
    b = np.clip(a + 0.3 * rng.standard_normal(a.shape), -1, 1).astype(np.float32)
    (jfe, fp), fe, lpips = _carried_nets(1, 0)
    ref = jax_eval.extract_features(jfe, fp, a)
    got = eval_metrics.extract_features(fe, a)
    assert got.shape == ref.shape == (70, 256)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    ref_m = jax_eval.evaluate(a[:8], b[:8], 1, seed=0)
    got_m = eval_metrics.evaluate(a[:8], b[:8], 1, seed=0, fe=fe, lpips=lpips, device="cpu")
    assert set(got_m) == set(ref_m) and got_m["n_a"] == ref_m["n_a"] == 8
    assert abs(got_m["lpips_mean"] - ref_m["lpips_mean"]) <= 1e-4


def test_ffd_end_to_end_matches_jax_at_full_rank():
    """300 images > the 256 features: the covariances have full rank."""
    rng = np.random.default_rng(1)
    a = rng.uniform(-1, 1, (300, 8, 8, 1)).astype(np.float32)
    b = np.clip(0.8 * a + 0.2 * rng.standard_normal(a.shape), -1, 1).astype(np.float32)
    (_, _), fe, _ = _carried_nets(1, 2)
    ref = jax_eval.ffd_with_ci(a, b, 1, seed=2, n_boot=3)
    got = eval_metrics.ffd_with_ci(a, b, 1, seed=2, n_boot=3, fe=fe, device="cpu")
    assert set(got) == set(ref) and got["paired"] is False and got["n_boot"] == 3
    assert abs(got["ffd"] - ref["ffd"]) <= 1e-5 * abs(ref["ffd"])


@pytest.mark.parametrize("paired", [False, True])
def test_frechet_stats_and_bootstrap_equal_jax_on_the_same_rows(monkeypatch, paired):
    rng = np.random.default_rng(3)
    fa = rng.standard_normal((40, 6)).astype(np.float32)
    fb = (0.5 + 1.2 * rng.standard_normal((40, 6))).astype(np.float32)
    for x, y in zip(eval_metrics._stats(fa), jax_eval._stats(fa)):
        np.testing.assert_array_equal(x, y)
    d = eval_metrics.frechet_distance(*eval_metrics._stats(fa), *eval_metrics._stats(fb))
    assert abs(d - jax_eval.frechet_distance(*jax_eval._stats(fa), *jax_eval._stats(fb))) <= 1e-10
    rows = {"a": fa, "b": fb}
    monkeypatch.setattr(jax_eval, "FeatureExtractor", lambda **kw: types.SimpleNamespace(
        init=lambda key: None))
    monkeypatch.setattr(jax_eval, "extract_features", lambda fe, p, ims: rows[ims])
    monkeypatch.setattr(eval_metrics, "extract_features", lambda fe, ims: rows[ims])
    ref = jax_eval.ffd_with_ci("a", "b", 1, seed=7, n_boot=20, paired=paired)
    got = eval_metrics.ffd_with_ci("a", "b", 1, seed=7, n_boot=20, paired=paired, device="cpu")
    assert set(got) == set(ref) and got["paired"] is paired
    for k in ("ffd", "ffd_ci_lo", "ffd_ci_hi"):
        assert abs(got[k] - ref[k]) <= 1e-10, k


def test_cli_json_keys_and_ffd_of_a_tree_against_itself(tmp_path, capsys):
    import json

    _png_tree(tmp_path / "a", 20, 16, 1, seed=4)
    out = tmp_path / "m.json"
    metrics = eval_metrics.main(["--dir_a", str(tmp_path / "a"), "--dir_b", str(tmp_path / "a"),
                                 "--out", str(out), "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == metrics == json.loads(out.read_text())
    # the JAX tool's keys, from its evaluate's return
    tree = ast.parse(open(os.path.join(REPO, "tools", "eval_metrics.py")).read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "evaluate")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    assert set(metrics) == {k.value for k in ret.value.keys}
    assert metrics["n_a"] == metrics["n_b"] == 20
    assert abs(metrics["ffd"]) <= 1e-3 and metrics["lpips_mean"] == 0.0


# ------------------------------------------------------------------ profiling


def test_step_timer_stats_equal_jax_on_the_same_clock(monkeypatch):
    from controlnet_tpu.utils import profiling as jax_profiling

    ticks = [0.0, 2.0, 2.5, 2.75, 3.0, 3.5, 10.0, 10.25, 11.0, 11.125]
    for mod, clock in ((profiling, "perf_counter"), (jax_profiling, "time")):
        it = iter(ticks)
        monkeypatch.setattr(mod.time, clock, lambda it=it: next(it))
        timer = mod.StepTimer(skip=1)
        for _ in range(5):
            with timer:
                pass
        monkeypatch.undo()
        if mod is profiling:
            got = timer.stats()
        else:
            ref = timer.stats()
    assert got == ref and got["steps"] == 4 and got["mean_s"] == (0.25 + 0.5 + 0.25 + 0.125) / 4
    assert profiling.StepTimer().stats() == {"steps": 0}


def test_trace_writes_a_trace_file(tmp_path):
    with profiling.trace(str(tmp_path)):
        (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    assert glob.glob(str(tmp_path / "*.pt.trace.json*"))
