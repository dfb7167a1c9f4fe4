"""The port's tensor parallelism (controlnet_tpu_torch/parallel/tp.py and the
2-D mesh) against the JAX package's (controlnet_tpu/parallel/tp.py).

* the plan: ``tp_param_specs`` leaf by leaf against JAX's specs carried
  through the state-dict layout rules (each JAX leaf filled with its index
  along its sharded axis, converted by ``io/jax_params.py``, and the torch
  dim along which the result varies read back);
* ``tp_memory_report`` against JAX's, field by field, on the full CelebA-HQ
  LDM ControlNet built on ``meta``;
* four gloo rank processes (``_torch_port_tp_rank.py``, torch only) on a
  (2, 2) mesh: two ControlNet train steps against JAX's single-device step
  with the same draws (tolerances of tests/test_sharding.py), the LDM
  ControlNet forward and the VAE encode against JAX's (1e-5); on a (1, 4)
  mesh, where a head spans two ranks and GroupNorm groups straddle ranks,
  the output and every gradient (replicated leaves upstream of the
  column-parallel layers among them) against the same model in one
  process; and ``dryrun_multichip(4)``.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_port_util import np_tree, random_params, to_nchw, to_nhwc
from conftest import TINY_MODEL_CONFIG as CFG
from conftest import TINY_VAE_CONFIG as VCFG
from controlnet_tpu.models.controlnet import ControlNet as JaxControlNet
from controlnet_tpu.models.vae import VAE as JaxVAE
from controlnet_tpu.parallel.tp import tp_memory_report as jax_memory_report
from controlnet_tpu.parallel.tp import tp_param_specs as jax_specs
from controlnet_tpu.schedules.linear import make_linear_schedule as jax_schedule
from controlnet_tpu.train.loops import make_controlnet_train_step as jax_cn_step
from controlnet_tpu.train.state import create_train_state as jax_train_state
from controlnet_tpu_torch.io import jax_params
from controlnet_tpu_torch.models.controlnet import ControlNet
from controlnet_tpu_torch.models.vae import VAE
from controlnet_tpu_torch.nn.layers import MultiheadAttention
from controlnet_tpu_torch.parallel.mesh import Mesh
from controlnet_tpu_torch.parallel.tp import tp_memory_report, tp_param_specs, tp_shard_params
from test_torch_port_train import LR, T, _jax_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_SCRIPT = os.path.join(REPO, "tests", "_torch_port_tp_rank.py")
WORLD = 4
B = 4
STEPS = 2

CELEBHQ_LDM = dict(
    hint_channels=3, down_channels=[256, 384, 512, 768], mid_channels=[768, 512],
    down_sample=[True, True, True], attn_down=[True, True, True], time_emb_dim=512,
    norm_channels=32, num_heads=16, conv_out_channels=128, num_down_layers=2,
    num_mid_layers=2, num_up_layers=2)


# ---------------------------------------------------------------------------
# the plan and the memory report
# ---------------------------------------------------------------------------

def _markers(shapes, specs):
    """Each leaf filled with 1 + its index along the sharded axis (0 where
    replicated)."""
    def fill(s, spec):
        a = np.zeros(s.shape, np.float32)
        if spec != P():
            axis = list(spec).index("model")
            shape = [1] * len(s.shape)
            shape[axis] = s.shape[axis]
            a = a + (np.arange(s.shape[axis]) + 1).reshape(shape)
        return a
    return jax.tree.map(fill, shapes, specs, is_leaf=lambda v: isinstance(v, P))


def _varying_dims(sd: dict) -> dict:
    out = {}
    for k, v in sd.items():
        dims = [d for d in range(v.dim()) if (v - v.narrow(d, 0, 1)).abs().max() > 0]
        assert len(dims) <= 1, (k, dims)
        out[k] = dims[0] if dims else None
    return out


MODELS = {
    "controlnet": (lambda: JaxControlNet(1, CFG, model_locked=True),
                   jax_params.controlnet_state_dict_from_jax, lambda: ControlNet(1, CFG)),
    "ldm_controlnet": (lambda: JaxControlNet(4, dict(CFG, im_channels=4), down_sample_factor=4,
                                             model_locked=True),
                       lambda p: jax_params.controlnet_state_dict_from_jax(p, ldm=True),
                       lambda: ControlNet(4, dict(CFG, im_channels=4), down_sample_factor=4)),
    "vae": (lambda: JaxVAE(3, VCFG), jax_params.vae_state_dict_from_jax, lambda: VAE(3, VCFG)),
}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_plan_matches_jax_leaf_by_leaf(name, n):
    """The sharded dim of every leaf equals JAX's spec through the layout
    rules (HWIO axis 3 -> OIHW 0, Linear (in, out) axis 1 -> (out, in) 0,
    wq / wk / wv -> the packed in_proj rows, wo -> out_proj's input axis);
    the port counts 4 fewer sharded leaves per sharded attention layer
    (wq, wk, wv and bq, bk, bv pack into two)."""
    make_jax, convert, make_port = MODELS[name]
    shapes = jax.eval_shape(make_jax().init, jax.random.PRNGKey(0))
    specs = jax_specs(shapes, n)
    ref = _varying_dims(convert(_markers(shapes, specs)))
    got = tp_param_specs(make_port(), n)
    assert got == ref
    assert tp_param_specs(make_port().state_dict(), n) == got  # by state dict too
    n_jax = sum(1 for s in jax.tree.leaves(specs, is_leaf=lambda v: isinstance(v, P))
                if s != P())
    n_attn = sum(1 for k, d in got.items() if k.endswith("in_proj_weight") and d is not None)
    assert sum(d is not None for d in got.values()) == n_jax - 4 * n_attn > 0
    assert all(d is None for d in tp_param_specs(make_port(), 1).values())


@pytest.mark.parametrize("n", [2, 4])
def test_memory_report_matches_jax_on_celebhq(n):
    """Every field of the report on the CelebA-HQ LDM ControlNet (the port's
    built on ``meta``, JAX's through ``eval_shape``), and JAX's headroom
    bounds: >= 40% per-device reduction at TP=2, >= 60% at 4."""
    jcn = JaxControlNet(4, CELEBHQ_LDM, model_locked=True, down_sample_factor=32)
    ref = jax_memory_report(jax.eval_shape(jcn.init, jax.random.PRNGKey(0)), n)
    with torch.device("meta"):
        cn = ControlNet(4, CELEBHQ_LDM, model_locked=True, down_sample_factor=32)
    got = tp_memory_report(cn, n)
    assert got == ref
    assert got["sharded_fraction"] > 0.9
    assert got["reduction_vs_replicated"] >= (0.40 if n == 2 else 0.60)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def _mesh(rank=0, world=2, mp=2):
    return Mesh(rank=rank, world_size=world, device=torch.device("cpu"), backend="gloo",
                model_parallel=mp)


def test_fused_proj_refuses_under_tp():
    """Kernel d computes the whole layer, projections included: a TP
    attention layer with ``fused_proj`` on raises (JAX leaves its fused path
    off under TP), and never quietly takes the split path."""
    mha = MultiheadAttention(16, 2)
    mha.fused_proj = True
    mha.tp_mesh = _mesh()
    with pytest.raises(RuntimeError, match="tensor parallelism"):
        mha(torch.zeros(1, 4, 16))


def test_model_parallel_1_is_the_data_parallel_mesh():
    """A mesh of model_parallel 1 is the data-parallel mesh: data size =
    world size, rows by rank, the default group for the data collectives; a
    (2, 2) mesh splits rows by the data index; a plan over a model axis of 1
    shards nothing and leaves the model untouched."""
    for rank in range(4):
        m1, m2 = _mesh(rank, 4, 1), _mesh(rank, 4, 2)
        assert (m1.data_size, m1.data_index, m1.model_index, m1.data_group) == (4, rank, 0, None)
        assert m1.rows(8) == slice(2 * rank, 2 * rank + 2)
        assert (m2.data_size, m2.data_index, m2.model_index) == (2, rank // 2, rank % 2)
        assert m2.rows(8) == slice(4 * (rank // 2), 4 * (rank // 2) + 4)
    cn = ControlNet(1, CFG)
    before = {k: v.clone() for k, v in cn.state_dict().items()}
    plan = tp_shard_params(cn, _mesh(0, 1, 1))
    assert all(d is None for d in plan.values())
    assert all(torch.equal(v, before[k]) for k, v in cn.state_dict().items())
    assert all(m.tp_mesh is None for m in cn.modules() if hasattr(m, "tp_mesh"))


def test_dryrun_runs_on_the_card_unless_told_cpu(monkeypatch):
    """``dryrun_multichip`` resolves its device before it joins a group: on a
    host with no card it raises unless it is given ``device="cpu"``."""
    from controlnet_tpu_torch.parallel.dryrun import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(4)


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------

def _cn_train_case():
    jcn = JaxControlNet(1, CFG)
    p = random_params(jcn, 10)
    trainable, frozen = jcn.split_params(p)
    tx = optax.adam(LR)
    jstate = jax_train_state(trainable, tx)
    jstep = jax_cn_step(jcn, jax_schedule(T, 1e-4, 0.02), tx)
    key, steps, losses = jax.random.PRNGKey(21), [], []
    rng = np.random.default_rng(30)
    for _ in range(STEPS):
        images = rng.uniform(-1, 1, (B, 8, 8, 1)).astype(np.float32)
        hints = rng.uniform(size=(B, 8, 8, 3)).astype(np.float32)
        key, sk = jax.random.split(key)
        jstate, jloss = jstep(jstate, frozen, jnp.asarray(images), jnp.asarray(hints), sk)
        t, noise, _ = _jax_draws(sk, images.shape, 0.0)
        steps.append((to_nchw(images), to_nchw(hints), torch.from_numpy(t), to_nchw(noise)))
        losses.append(float(jloss))
    case = {"cfg": CFG, "im_channels": 1, "lr": LR, "T": T, "steps": steps,
            "sd": jax_params.controlnet_state_dict_from_jax(np_tree(p))}
    merged = jcn.merge_params(jax.tree.map(np.asarray, jstate.params),
                              jax.tree.map(np.asarray, frozen))
    return case, {"losses": losses, "sd": jax_params.controlnet_state_dict_from_jax(merged)}


def _ldm_forward_case():
    cfg = dict(CFG, im_channels=4)
    jcn = JaxControlNet(4, cfg, down_sample_factor=4, model_locked=True)
    p = random_params(jcn, 12)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((B, 8, 8, 4)).astype(np.float32)
    hint = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    t = np.array([1, 5, 9, 3], np.int32)
    ref = np.asarray(jax.jit(lambda pp, a, b, c: jcn(pp, a, b, c))(
        p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(hint)))
    case = {"cfg": cfg, "im_channels": 4, "factor": 4, "x": to_nchw(x), "hint": to_nchw(hint),
            "t": torch.from_numpy(t),
            "sd": jax_params.controlnet_state_dict_from_jax(np_tree(p), ldm=True)}
    return case, {"out": ref}


def _vae_encode_case():
    jvae = JaxVAE(3, VCFG)
    p = random_params(jvae, 14)
    x = np.random.default_rng(15).standard_normal((B, 16, 16, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda pp, a: jvae.encode(pp, a, jax.random.PRNGKey(2))[1])(
        p, jnp.asarray(x)))
    return {"cfg": VCFG, "x": to_nchw(x),
            "sd": jax_params.vae_state_dict_from_jax(np_tree(p))}, {"moments": ref}


def _heads_case():
    """GroupNorm over 2 groups: on the (1, 4) mesh a group of the 8- and
    16-wide hidden layers spans two ranks; 2 heads over 4 ranks."""
    cfg = dict(CFG, norm_channels=2)
    g = torch.Generator().manual_seed(16)
    cn = ControlNet(1, cfg)
    sd = {k: 0.3 * torch.randn(v.shape, generator=g) for k, v in cn.state_dict().items()}
    return {"cfg": cfg, "im_channels": 1, "sd": sd,
            "x": torch.randn((2, 1, 8, 8), generator=g), "t": torch.tensor([3, 40]),
            "hint": torch.rand((2, 3, 8, 8), generator=g),
            "w": torch.randn((2, 1, 8, 8), generator=g)}, {}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Every case's reference, then one run of the four rank processes over
    all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        built = {name: fn() for name, fn in (
            ("cn_train", _cn_train_case), ("ldm_forward", _ldm_forward_case),
            ("vae_encode", _vae_encode_case), ("heads", _heads_case))}
    finally:
        torch.set_num_threads(n)
    built["dryrun"] = built["remainder"] = ({}, {})
    workdir = str(tmp_path_factory.mktemp("four_ranks"))
    torch.save({k: v[0] for k, v in built.items()}, os.path.join(workdir, "cases.pt"))
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, RANK_SCRIPT, workdir, str(r), str(WORLD)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    outs = [torch.load(os.path.join(workdir, f"out{r}.pt"), weights_only=False)
            for r in range(WORLD)]
    return SimpleNamespace(ref={k: v[1] for k, v in built.items()},
                           case={k: v[0] for k, v in built.items()}, outs=outs, logs=logs)


def test_rank_processes_import_no_jax(four_ranks):
    assert [o["jax_imported"] for o in four_ranks.outs] == [False] * WORLD


def test_tp_train_steps_match_jax_single_device(four_ranks):
    """Two ControlNet steps on the (2, 2) mesh (2 rows a data index,
    parameters sharded over 2) against JAX's single-device step with the
    same draws: loss rtol 1e-5, weights atol 1.5e-3 (tests/test_sharding.py's
    TP tolerances); the joined weights are the same on every rank."""
    out, ref = four_ranks.outs[0]["cn_train"], four_ranks.ref["cn_train"]
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-5)
    for k, v in ref["sd"].items():
        np.testing.assert_allclose(out["sd"][k].numpy(), v.numpy(), atol=1.5e-3, err_msg=k)
    moved = max((out["sd"][k] - four_ranks.case["cn_train"]["sd"][k]).abs().max().item()
                for k in out["sd"])
    assert moved > 0.5 * LR
    for o in four_ranks.outs[1:]:
        assert o["cn_train"]["losses"] == out["losses"]
        assert all(torch.equal(o["cn_train"]["sd"][k], v) for k, v in out["sd"].items())
    assert out["sharded_leaves"] > 0


@pytest.mark.parametrize("name,key", [("ldm_forward", "out"), ("vae_encode", "moments")])
def test_tp_forwards_match_jax(four_ranks, name, key):
    """The LDM ControlNet (stride-2 hint encoder with remainder weights,
    zero convs) and the VAE encoder on the (2, 2) mesh against JAX's
    forward on one device: 1e-5."""
    ref = four_ranks.ref[name][key]
    for o in four_ranks.outs:
        np.testing.assert_allclose(to_nhwc(o[name][key]), ref, atol=1e-5)


def test_heads_spanning_ranks_match_one_process(four_ranks):
    """The (1, 4) mesh: both attention widths shard their columns while 2
    heads do not divide 4 (q / k / v gathered, every head run, the rank's
    columns kept), and GroupNorm groups straddle ranks.  Output 1e-5 and
    every gradient within 1e-4 of its tensor's largest against one process,
    the replicated leaves upstream of a column-parallel layer (norm1, the
    stem, the time MLP) among them."""
    out = four_ranks.outs[0]["heads"]
    assert out["split_heads"] and all(h != 0 for h in out["split_heads"])
    np.testing.assert_allclose(out["out"].numpy(), out["ref_out"].numpy(), atol=1e-5)
    replicated = [k for k in out["ref_grads"] if k not in out["sharded"]]
    assert any("resnet_conv_first.0.0" in k for k in replicated)
    assert any(k.endswith("conv_in.weight") for k in replicated)
    for k, r in out["ref_grads"].items():
        scale = max(r.abs().max().item(), 1e-6)
        assert (out["grads"][k] - r).abs().max().item() <= 1e-4 * scale, k


def test_remainder_weights_gathered_at_use_match_one_process(four_ranks):
    """Leaves of at least 1 MiB outside the grammar (a 3x3 conv in NCHW and
    in the transposed layout, a Linear) sharded on their output axis and
    gathered at use, on the (2, 2) mesh: output and every gradient within
    1e-5 of its tensor's largest against one process."""
    for o in four_ranks.outs:
        out = o["remainder"]
        assert out["sharded"] == {"conv.weight", "proj.weight"}
        np.testing.assert_allclose(out["out"].numpy(), out["ref_out"].numpy(), atol=1e-5)
        for k, r in out["ref_grads"].items():
            scale = max(r.abs().max().item(), 1e-6)
            assert (out["grads"][k] - r).abs().max().item() <= 1e-5 * scale, k


@pytest.mark.parametrize("name", ["heads", "remainder"])
def test_nccl_route_matches_the_gloo_route(four_ranks, name):
    """The NCCL route's collectives (``all_gather_into_tensor``,
    ``reduce_scatter_tensor``, which gloo also has for CPU tensors) on the
    same cases, through a mesh that names NCCL: the heads spanning ranks (q /
    k / v gathered, their gradients reduce-scattered) and the remainder
    weights (gathered at use).  Outputs and gradients within 1e-6 of each
    tensor's largest of the gloo route's, which the tests above hold against
    one process."""
    for o in four_ranks.outs:
        got, want = o[f"{name}_native"], o[name]
        pairs = [(got["out"], want["out"])]
        pairs += [(got["grads"][k], v) for k, v in want["grads"].items()]
        for a, b in pairs:
            assert a.shape == b.shape
            assert (a - b).abs().max().item() <= 1e-6 * max(b.abs().max().item(), 1e-6)


def test_dryrun_multichip_4_ranks(four_ranks):
    """``dryrun_multichip(4)`` on the CPU: a (2, 2) mesh, 20 steps, the loss
    decreasing, the same on every rank."""
    runs = [o["dryrun"] for o in four_ranks.outs]
    assert all(r["mesh"] == (2, 2) for r in runs)
    losses = runs[0]["losses"]
    assert len(losses) == 20 and np.mean(losses[-5:]) < np.mean(losses[:5])
    assert all(r["losses"] == losses for r in runs)
