"""The port's serve tool (controlnet_tpu_torch.tools.serve) on the CPU: its
micro-batcher under the JAX batcher's own cases, the HTTP contract on a tiny
config, and its ``generate`` against the JAX server's.

The batcher cases are the test functions of tests/test_serve_batcher.py, run
with the port's ``_MicroBatcher`` / ``_bucket`` in place of the JAX tool's
(both are pure threading code).  The slice as a whole: the port's ``generate``
with ``x_start`` set to the x_T that ``controlnet_tpu.sample.common`` draws
from the key, against the ``generate`` of the JAX tools/serve.py built from the
same weights, DDIM and DPM-Solver++, 4 steps, within 2e-4 (a handful of model
calls, each within 1e-4, fed back through the update rule).
"""

import io
import json
import threading
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_serve_batcher as jax_batcher_cases
from _torch_port_util import random_params, to_nchw, to_nhwc
from conftest import TINY_MODEL_CONFIG
from controlnet_tpu.io.torch_export import export_controlnet, save_torch_checkpoint
from controlnet_tpu.models.controlnet import ControlNet as JaxControlNet
from controlnet_tpu.sample import make_few_step_sampler as jax_make_few_step_sampler
from controlnet_tpu.schedules import linear as jax_linear
from controlnet_tpu_torch.io import images
from controlnet_tpu_torch.nn import layers
from controlnet_tpu_torch.tools import serve

T = 8  # timesteps of the tiny config
BATCHER_CASES = [
    "test_batcher_single_request_passthrough",
    "test_batcher_coalesces_concurrent_requests",
    "test_batcher_window_merges_burst_on_idle_device",
    "test_batcher_groups_by_steps_and_respects_max_batch",
    "test_batcher_sheds_cancelled_requests",
    "test_batcher_stop_fails_parked_requests_fast",
    "test_batcher_submit_after_stop_fails_fast",
    "test_batcher_propagates_errors_to_every_member",
    "test_bucket_helper_unchanged",
]


@pytest.mark.parametrize("case", BATCHER_CASES)
def test_port_batcher_passes_the_jax_batcher_case(case, monkeypatch):
    monkeypatch.setattr(jax_batcher_cases, "_MicroBatcher", serve._MicroBatcher)
    monkeypatch.setattr(jax_batcher_cases, "_bucket", serve._bucket)
    getattr(jax_batcher_cases, case)()


def test_batcher_cases_are_all_of_the_jax_file():
    names = sorted(n for n in dir(jax_batcher_cases) if n.startswith("test_"))
    assert names == sorted(BATCHER_CASES)


@pytest.mark.parametrize("b,cap,want", [(1, 8, 1), (3, 8, 4), (8, 8, 8), (9, 12, 12), (8, 12, 8),
                                        (12, 12, 12), (5, 5, 5)])
def test_serve_bucket_respects_cap(b, cap, want):
    """A cap that is no power of two is itself the last bucket, never the
    power of two above it."""
    assert serve._bucket(b, cap) == want
    assert all(serve._bucket(n, cap) <= cap for n in range(1, cap + 1))
    assert want in serve._buckets(cap) and serve._buckets(cap)[-1] == cap


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The tiny DDPM ControlNet as a JAX tree and as a reference-format .pth,
    with the config that names it."""
    cfg = dict(TINY_MODEL_CONFIG)
    jcn = JaxControlNet(cfg["im_channels"], cfg)
    p = random_params(jcn, 70)
    task = tmp_path_factory.mktemp("serve_task")
    save_torch_checkpoint(export_controlnet(p, jcn), str(task / "cn.pth"))
    config = {
        "diffusion_params": {"num_timesteps": T, "beta_start": 1e-4, "beta_end": 0.02},
        "model_params": cfg,
        "train_params": {"task_name": str(task), "controlnet_ckpt_name": "cn.pth"},
    }
    return types.SimpleNamespace(cfg=cfg, jcn=jcn, p=p, config=config, size=cfg["im_size"])


def _args(model, **kw):
    base = dict(model=model, host="127.0.0.1", port=0, seed=0, max_batch=2, max_steps=64,
                device="cpu")
    return types.SimpleNamespace(**{**base, **kw})


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _npz(hints):
    buf = io.BytesIO()
    np.savez_compressed(buf, hints=hints)
    return buf.getvalue()


@pytest.mark.parametrize("model,fused", [("ddim_controlnet", False), ("dpm_controlnet", True)])
def test_serve_few_step_controlnet(served, model, fused):
    """The JAX server's HTTP contract (tests/test_tools_distill_e2e.py,
    test_serve_few_step_controlnet) on the port's server, on the CPU."""
    from PIL import Image

    s = served
    server = serve.make_server(_args(model, attn_fused_proj=fused), s.config)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        health = json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=30).read())
        # --max-steps 64 is clamped to the schedule length
        assert health == {"status": "ok", "model": model, "warm": True, "max_batch": 2,
                          "max_steps": T, "batch_window_ms": 2.0}

        png = io.BytesIO()
        Image.fromarray(np.zeros((s.size, s.size), np.uint8)).save(png, format="PNG")
        for steps in (1, 4):
            status, headers, body = _post(f"{base}/generate?steps={steps}", png.getvalue())
            assert status == 200 and headers["Content-Type"] == "image/png"
            assert Image.open(io.BytesIO(body)).size == (s.size, s.size)
            assert float(headers["X-Latency-Ms"]) > 0 and headers["X-Batch-Rows"] == "1"
        # a parameter that merely ends in "steps" is not the steps argument
        assert _post(f"{base}/generate?nsteps=10000", png.getvalue())[0] == 200

        hints = np.zeros((2, s.size, s.size, 3), np.float32)
        status, headers, body = _post(f"{base}/generate_batch?steps=4", _npz(hints))
        assert status == 200 and headers["X-Batch-Rows"] == "2"
        with np.load(io.BytesIO(body)) as z:
            samples = z["samples"]
        assert samples.shape == (2, s.size, s.size, 1) and samples.dtype == np.float32
        assert np.all(np.isfinite(samples)) and float(np.abs(samples).max()) <= 1.0

        bad = [
            (f"{base}/generate?steps=32", png.getvalue()),      # over the schedule length
            (f"{base}/generate?steps=0", png.getvalue()),       # below the allowed range
            (f"{base}/generate?steps=banana", png.getvalue()),  # no integer
            (f"{base}/generate", b"not-a-png"),                 # undecodable image
            (f"{base}/generate_batch", b"junk"),                # undecodable npz
            (f"{base}/generate_batch", _npz(hints[:, :4])),     # wrong image size
            (f"{base}/generate_batch", _npz(np.zeros((3, s.size, s.size, 3), np.float32))),
        ]
        for url, body in bad:
            assert _post(url, body)[0] == 400, url
        assert _post(f"{base}/elsewhere", b"")[0] == 404
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}/elsewhere", timeout=30)
        assert err.value.code == 404
        # the server is still up
        assert json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=30).read())["warm"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)
    assert not thread.is_alive()
    assert not [t for t in threading.enumerate() if t.name == "serve-microbatcher"]


def test_generation_error_is_a_500_for_the_request(served, monkeypatch):
    s = served
    server = serve.make_server(_args("ddim_controlnet"), s.config, warm=False)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def boom(*a, **k):
        raise RuntimeError("device on fire")

    monkeypatch.setattr(serve.sample_tool, "prepare", boom)
    try:
        health = json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=30).read())
        assert health["warm"] is False
        status, _, body = _post(f"{base}/generate_batch",
                                _npz(np.zeros((1, s.size, s.size, 3), np.float32)))
        assert status == 500 and b"device on fire" in body
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
@pytest.mark.parametrize("model", ["ddim_controlnet", "dpm_controlnet"])
def test_generate_matches_the_jax_server(served, model, fused):
    """The slice as a whole: hint features once, the few-step solver, the
    clamp; against the JAX server's ``generate`` on the same weights."""
    s = served
    steps, b = 4, 2
    hint = np.random.default_rng(71).uniform(size=(b, s.size, s.size, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jsched = jax_linear.make_linear_schedule(T, 1e-4, 0.02)
    solver = model.split("_")[0]

    def jax_generate(hint, key, steps):  # tools/serve.py, the teacher branch
        feats = s.jcn.hint_features(s.p, hint)
        sampler = jax_make_few_step_sampler(
            solver, lambda p, x, t, f: s.jcn(p, x, t, hint_features=f), jsched,
            (hint.shape[0], s.size, s.size, s.cfg["im_channels"]), num_steps=steps)
        x0, _ = sampler(s.p, key, feats)
        return jnp.clip(x0, -1.0, 1.0)

    ref = np.asarray(jax_generate(jnp.asarray(hint), key, steps))
    k0, _ = jax.random.split(key)  # controlnet_tpu.sample.common draws x_T from the first split
    x_start = np.asarray(jax.random.normal(k0, ref.shape, jnp.float32))

    generate, im_size, im_channels, hint_channels, steps_cap = serve.build_generator(
        _args(model, attn_fused_proj=fused), s.config)
    assert (im_size, im_channels, hint_channels, steps_cap) == (s.size, 1, 3, T)
    out = generate(hint, None, steps, x_start=to_nchw(x_start))
    assert out.shape == (b, 1, s.size, s.size) and float(out.abs().max()) <= 1.0
    np.testing.assert_allclose(to_nhwc(out), ref, rtol=0, atol=2e-4)
    # without x_start the x_T comes from the generator, reproducibly
    g = torch.Generator().manual_seed(3)
    a = generate(hint, g, steps)
    torch.testing.assert_close(generate(hint, torch.Generator().manual_seed(3), steps), a,
                               rtol=0, atol=0)
    assert (a - out).abs().max() > 1e-3


def test_build_generator_sets_the_switch_and_checks_the_model(served):
    s = served
    with pytest.raises(ValueError, match="unknown model"):
        serve.build_generator(_args("lcm"), s.config)
    seen = {}
    orig = serve.set_attn_fused_proj
    try:
        serve.set_attn_fused_proj = lambda m, on: (seen.update(on=on), orig(m, on))[1]
        serve.build_generator(_args("dpm_controlnet", attn_fused_proj=True), s.config)
        assert seen == {"on": True}
        serve.build_generator(_args("dpm_controlnet"), s.config)
        assert seen == {"on": False}
    finally:
        serve.set_attn_fused_proj = orig
    assert layers.MultiheadAttention.fused_proj is False


def test_png_codec_round_trip():
    sample = np.linspace(-1.0, 1.0, 8 * 8, dtype=np.float32).reshape(8, 8, 1)
    hint = images.decode_hint_png(images.encode_sample_png(sample), 8, 3)
    assert hint.shape == (1, 8, 8, 3) and hint.dtype == np.float32
    np.testing.assert_allclose(hint[0, :, :, 0], (sample[:, :, 0] + 1) / 2, atol=1 / 255)
    np.testing.assert_array_equal(hint[..., 0], hint[..., 2])
    rgb = images.encode_sample_png(np.zeros((8, 8, 3), np.float32))
    assert images.decode_hint_png(rgb, 4, 1).shape == (1, 4, 4, 1)
    with pytest.raises(Exception):
        images.decode_hint_png(b"not-a-png", 8, 3)


def test_cli_flags_match_the_jax_tool(served, monkeypatch):
    """``main`` parses the JAX tool's flags plus --ckpt / --device /
    --attn_fused_proj; the default model is the JAX server's, consistency."""
    s = served
    got = {}

    class Stop(Exception):
        pass

    def fake_make_server(args, config):
        got.update(vars(args))
        raise Stop

    monkeypatch.setattr(serve, "make_server", fake_make_server)
    monkeypatch.setattr(serve.cfg, "load_config", lambda path: s.config)
    with pytest.raises(Stop):
        serve.main(["--config", "x.yaml", "--model", "ddim_controlnet", "--device", "cpu",
                    "--no-dynamic-batching", "--attn_fused_proj", "--max-steps", "20"])
    assert got == dict(config_path="x.yaml", model="ddim_controlnet", ckpt=None,
                       host="127.0.0.1", port=8000, seed=0, device="cpu", attn_fused_proj=True,
                       max_batch=16, max_steps=20, dynamic_batching=False, batch_window_ms=2.0)
    with pytest.raises(Stop):
        serve.main(["--config", "x.yaml"])
    assert got["model"] == "consistency"
    with pytest.raises(SystemExit):
        serve.main(["--model", "lcm"])
