"""The port's transposed-layout and dual-trunk forwards against the JAX
package: ``ops/tl_conv.py``'s ``downconv4_tl``, ``upconvT4_tl`` and
``group_norm_tl`` with the layers' ``tl``, ``UNet.forward_tl`` (plain and
conditioned), ``ControlNet.forward_tl`` / ``forward_paired`` /
``forward_fused`` of the DDPM and LDM variants (values, gradients, bf16
types), the blocks' ``pair`` on cross-attention, the three forwards under
tensor parallelism, and the kernel calls of a forward at the full MNIST
width.

JAX runs jitted on the CPU, where its TL conv takes the XLA einsum path and
its attention the XLA one (no Pallas outside a TPU); the port runs on the
CPU, where kernels a and c take their plain versions.  Weights come from
numpy seeds (``random_params``, every zero conv nonzero) carried across by
``io/jax_params.py``.  Tolerances: the TL functions 1e-5 (one conv or norm),
forwards 1e-4 (PERF.md section 2), gradients 1e-4 of max|grad|.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import MNIST_CONFIG, NARROW_LDM, Z, np_tree, random_params, to_nchw, to_nhwc
from conftest import TINY_MODEL_CONFIG
from controlnet_tpu.models.controlnet import ControlNet as JaxControlNet
from controlnet_tpu.models.unet import UNet as JaxUNet
from controlnet_tpu.nn import layers as jax_layers
from controlnet_tpu.ops import tl_conv as jax_tl
from controlnet_tpu_torch.io import jax_params
from controlnet_tpu_torch.models.controlnet import ControlNet
from controlnet_tpu_torch.models.unet import UNet
from controlnet_tpu_torch.nn import blocks, layers
from controlnet_tpu_torch.ops import cuda_attention, cuda_conv, tl_conv

OP_ATOL = 1e-5
ATOL = 1e-4
FORWARDS = ("forward_tl", "forward_paired", "forward_fused")

COND_CONFIG = dict(  # tests/test_tl_parity.py's conditioned UNet
    down_channels=[8, 16, 16], mid_channels=[16, 16], down_sample=[True, False],
    attn_down=[False, True], time_emb_dim=8, norm_channels=4, num_heads=2,
    conv_out_channels=8, num_down_layers=1, num_mid_layers=1, num_up_layers=1,
    condition_config=dict(
        condition_types=["class", "text", "image"],
        class_condition_config=dict(num_classes=3, cond_drop_prob=0.0),
        text_condition_config=dict(text_embed_model="clip", text_embed_dim=8,
                                   cond_drop_prob=0.0),
        image_condition_config=dict(image_condition_input_channels=3,
                                    image_condition_output_channels=2, image_condition_h=8,
                                    image_condition_w=8, cond_drop_prob=0.0)))


def _tl(x_nhwc: np.ndarray) -> np.ndarray:
    """NHWC -> (C, B, H*W), the layout both packages' TL functions take."""
    b, h, w, c = x_nhwc.shape
    return np.ascontiguousarray(x_nhwc.reshape(b, h * w, c).transpose(2, 0, 1))


# --- the TL functions and the layers' tl ---------------------------------------------------

@pytest.mark.parametrize("op,b,h,w,cin,cout", [
    ("downconv4", 2, 8, 8, 8, 16), ("downconv4", 1, 12, 6, 4, 4),
    ("upconvT4", 2, 4, 4, 8, 8), ("upconvT4", 1, 6, 3, 4, 8),
    ("group_norm", 2, 5, 5, 16, 16), ("group_norm", 3, 4, 6, 8, 8)])
def test_tl_op_matches_jax(op, b, h, w, cin, cout):
    """Each TL function through its layer's ``tl`` (weights carried by
    jax_params) against the JAX function on the same (C, B, L) input, at
    tests/test_tl_parity.py's shapes, and against the layer's NCHW forward."""
    rng = np.random.default_rng(10 * ("downconv4", "upconvT4", "group_norm").index(op) + b)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    sd: dict = {}
    if op == "downconv4":
        p = random_params(jax_layers.Conv2d(cin, cout, 4, stride=2, padding=1), b)
        jfn = lambda pp, xx: jax_tl.downconv4_tl(pp["w"], pp["b"], xx, (h, w))  # noqa: E731
        layer, out_hw = layers.Conv2d(cin, cout, 4, stride=2, padding=1), (h // 2, w // 2)
        jax_params._conv(np_tree(p), "l", sd)
    elif op == "upconvT4":
        p = random_params(jax_layers.ConvTranspose2d(cin, cout, 4, 2, 1), b)
        jfn = lambda pp, xx: jax_tl.upconvT4_tl(pp["w"], pp["b"], xx, (h, w))  # noqa: E731
        layer, out_hw = layers.ConvTranspose2d(cin, cout, 4, 2, 1), (2 * h, 2 * w)
        jax_params._conv_transpose(np_tree(p), "l", sd)
    else:
        p = random_params(jax_layers.GroupNorm(4, cin), b)
        jfn = lambda pp, xx: jax_tl.group_norm_tl(pp["scale"], pp["bias"], xx, 4)  # noqa: E731
        layer, out_hw = layers.GroupNorm(4, cin), (h, w)
        jax_params._norm(np_tree(p), "l", sd)
    layer.load_state_dict(jax_params._to_torch({k[2:]: v for k, v in sd.items()}), strict=True)
    ref = np.asarray(jax.jit(jfn)(p, jnp.asarray(_tl(x))))
    x_tl = tl_conv.to_tl(to_nchw(x))
    with torch.no_grad():
        out = layer.tl(x_tl) if op == "group_norm" else layer.tl(x_tl, (h, w))
        nchw = layer(to_nchw(x))
    assert out.shape == ref.shape == (cout, b, out_hw[0] * out_hw[1])
    np.testing.assert_allclose(out.numpy(), ref, atol=OP_ATOL)
    torch.testing.assert_close(tl_conv.from_tl(out, out_hw), nchw, rtol=0, atol=OP_ATOL)


def test_conv_tl_takes_the_nchw_round_trip_for_other_shapes():
    """A conv with no TL function (5x5 here) goes through NCHW and back, as
    JAX's ``Conv2d.tl`` does, instead of raising."""
    conv = layers.Conv2d(4, 6, 5)
    x = torch.randn(2, 4, 7, 5)
    with torch.no_grad():
        out = conv.tl(tl_conv.to_tl(x), (7, 5))
        torch.testing.assert_close(tl_conv.from_tl(out, (7, 5)), conv(x), rtol=0, atol=0)


# --- UNet.forward_tl ----------------------------------------------------------------------

def _unet_cond(b: int, seed: int):
    rng = np.random.default_rng(seed)
    return {"class": np.eye(3, dtype=np.float32)[rng.integers(0, 3, b)],
            "text": rng.standard_normal((b, 5, 8)).astype(np.float32),
            "image": rng.standard_normal((b, 8, 8, 3)).astype(np.float32)}


def test_unet_forward_tl_matches_jax(controlnets):
    """``UNet.forward_tl`` at the tiny config (the ControlNet's frozen trunk,
    in the fixture's jit) and at the class + text + image conditioned one
    with per-level attention flags: against JAX's ``forward_tl`` and the
    port's own ``forward``."""
    ju = JaxUNet(2, COND_CONFIG)
    p = random_params(ju, 30)
    unet = UNet(2, COND_CONFIG).eval()
    unet.load_state_dict(jax_params.unet_state_dict_from_jax(p), strict=True)
    rng = np.random.default_rng(31)
    x = rng.standard_normal((2, 8, 8, 2)).astype(np.float32)
    t = rng.integers(0, 1000, 2)
    cond = _unet_cond(2, 32)
    ref = np.asarray(jax.jit(ju.forward_tl)(p, jnp.asarray(x), jnp.asarray(t),
                                            {k: jnp.asarray(v) for k, v in cond.items()}))
    pcond = {k: to_nchw(v) if k == "image" else torch.from_numpy(v) for k, v in cond.items()}
    with torch.no_grad():
        out = unet.forward_tl(to_nchw(x), torch.from_numpy(t), pcond)
        nchw = unet(to_nchw(x), torch.from_numpy(t), pcond)
    cases = [(out, ref, nchw), (controlnets["outs"]["unet_tl"], np.asarray(
        controlnets["refs"]["unet_tl"]), controlnets["outs"]["unet"])]
    for out, ref, nchw in cases:
        assert out.is_contiguous() and out.shape == nchw.shape
        np.testing.assert_allclose(to_nhwc(out), ref, atol=ATOL)
        torch.testing.assert_close(out, nchw, rtol=0, atol=ATOL)


# --- ControlNet.forward_tl / forward_paired / forward_fused ----------------------------------

# NARROW_LDM cut to two levels, attention at the second only
LDM_TL = dict(NARROW_LDM, down_channels=[16, 24, 32], mid_channels=[32, 24],
              down_sample=[True, False], attn_down=[False, True])


def _controlnet(variant: str, seed: int):
    """(JAX ControlNet, its params, the port's with them) for the tiny DDPM
    config or LDM_TL (hint factor 4: hints 32^2, latents 8^2)."""
    if variant == "ddpm":
        jcn = JaxControlNet(1, TINY_MODEL_CONFIG)
        cn = ControlNet(1, TINY_MODEL_CONFIG)
    else:
        jcn = JaxControlNet(Z, LDM_TL, down_sample_factor=4)
        cn = ControlNet(Z, LDM_TL, down_sample_factor=4)
    p = random_params(jcn, seed)
    cn.load_state_dict(jax_params.controlnet_state_dict_from_jax(p, ldm=variant == "ldm"),
                       strict=True)
    return jcn, p, cn


def _controlnet_inputs(variant: str, seed: int, b: int = 2):
    rng = np.random.default_rng(seed)
    ch, hint_hw = (1, 8) if variant == "ddpm" else (Z, 32)
    x = rng.standard_normal((b, 8, 8, ch)).astype(np.float32)
    hint = rng.uniform(size=(b, hint_hw, hint_hw, 3)).astype(np.float32)
    return x, rng.integers(0, 1000, b), hint


@pytest.fixture(scope="module")
def controlnets():
    """The three forwards of the tiny DDPM ControlNet and its frozen trunk's
    ``UNet.forward_tl`` on both sides (the JAX ones in one jit, which shares
    the trunk's stem and down path between them), and the port's
    ``forward``s."""
    jcn, p, cn = _controlnet("ddpm", 40)
    x, t, hint = _controlnet_inputs("ddpm", 41)

    def everything(pp, xx, tt, hh):
        return ([getattr(jcn, name)(pp, xx, tt, hh) for name in FORWARDS]
                + [jcn.unet.forward_tl(pp["trained_unet"], xx, tt)])

    refs = jax.jit(everything)(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(hint))
    with torch.no_grad():
        args = (to_nchw(x), torch.from_numpy(t), to_nchw(hint))
        outs = {name: getattr(cn, name)(*args) for name in FORWARDS}
        outs["unet_tl"] = cn.trained_unet.forward_tl(*args[:2])
        outs["unet"] = cn.trained_unet(*args[:2])
        return {"refs": dict(zip(FORWARDS + ("unet_tl",), refs)), "outs": outs,
                "forward": cn(*args)}


@pytest.mark.parametrize("name", FORWARDS)
def test_controlnet_forwards_match_jax(controlnets, name):
    """Each forward against its JAX counterpart and against the port's own
    ``forward`` (the tiny DDPM ControlNet, live zero convs)."""
    ref, out = np.asarray(controlnets["refs"][name]), controlnets["outs"][name]
    assert out.shape == (2, 1, 8, 8) and out.is_contiguous()
    np.testing.assert_allclose(to_nhwc(out), ref, atol=ATOL)
    torch.testing.assert_close(out, controlnets["forward"], rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def ldm_controlnets():
    """The three forwards of the LDM_TL ControlNet (the dynamic hint
    encoder, per-level attention, norm_channels and conv_out_channels of its
    config) on both sides, the JAX ones in one jit, and the port's
    ``forward``."""
    jcn, p, cn = _controlnet("ldm", 42)
    x, t, hint = _controlnet_inputs("ldm", 43)

    def everything(pp, xx, tt, hh):
        return [getattr(jcn, name)(pp, xx, tt, hh) for name in FORWARDS]

    refs = jax.jit(everything)(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(hint))
    args = (to_nchw(x), torch.from_numpy(t), to_nchw(hint).contiguous())
    with torch.no_grad():
        return {"refs": dict(zip(FORWARDS, refs)), "forward": cn(*args),
                "outs": {name: getattr(cn, name)(*args) for name in FORWARDS}}


@pytest.mark.parametrize("name", FORWARDS)
def test_ldm_controlnet_forwards_match_jax(ldm_controlnets, name):
    """Each forward of the LDM ControlNet against its JAX counterpart."""
    ref, out = np.asarray(ldm_controlnets["refs"][name]), ldm_controlnets["outs"][name]
    assert out.shape == (2, Z, 8, 8)
    np.testing.assert_allclose(to_nhwc(out), ref, atol=ATOL)


def test_ldm_controlnet_forwards_match_forward(ldm_controlnets):
    """The LDM ControlNet's three forwards against its ``forward``, whose
    JAX parity tests/test_torch_port_ldm.py holds."""
    for name in FORWARDS:
        torch.testing.assert_close(ldm_controlnets["outs"][name], ldm_controlnets["forward"],
                                   rtol=0, atol=ATOL)


def test_controlnet_gradients_match_jax():
    """mean(out^2) through ``forward_paired``: every parameter's gradient
    within 1e-4 of max|grad| of ``jax.grad``'s on the whole tree, so the
    frozen trunk's stem and down path take none and its mids and decoder do
    (``forward``'s semantics, JAX's ``stop_gradient``); ``forward_tl`` and
    ``forward_fused`` give ``forward``'s gradients, which
    tests/test_torch_port_train.py holds against JAX."""
    jcn, p, cn = _controlnet("ddpm", 50)
    x, t, hint = _controlnet_inputs("ddpm", 51)
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(hint))
    ref_tree = jax.jit(jax.grad(lambda q: jnp.mean(jcn.forward_paired(q, *args) ** 2)))(p)
    ref = jax_params.controlnet_state_dict_from_jax(np_tree(ref_tree))
    names = dict(cn.named_parameters())
    assert sorted(names) == sorted(ref)
    gmax = max(v.abs().max().item() for v in ref.values())

    def grads(name):
        cn.zero_grad(set_to_none=True)
        out = getattr(cn, name)(to_nchw(x), torch.from_numpy(t), to_nchw(hint))
        (out ** 2).mean().backward()
        return {k: torch.zeros_like(v) if v.grad is None else v.grad.clone()
                for k, v in names.items()}

    paired = grads("forward_paired")
    for k, g in ref.items():
        assert (paired[k] - g).abs().max().item() <= 1e-4 * gmax, k
    for k in ("trained_unet.conv_in.weight", "trained_unet.downs.0.attentions.0.in_proj_weight",
              "trained_unet.t_proj.0.weight"):
        assert paired[k].abs().max() == 0, k
    for k in ("trained_unet.mids.0.attentions.0.in_proj_weight", "trained_unet.ups.0.resnet_"
              "conv_first.0.2.weight", "control_copy_unet.downs.0.attentions.0.in_proj_weight"):
        assert paired[k].abs().max() > 0, k
    default = grads("forward")
    for name in ("forward_tl", "forward_fused"):
        got = grads(name)
        for k, g in default.items():
            assert (got[k] - g).abs().max().item() <= 1e-4 * gmax, (name, k)


def test_controlnet_bf16_output_types_match_jax():
    """bf16 x and hint: the paired forward's output type as JAX's
    (``eval_shape``, as tests/test_models.py holds it against ``__call__``),
    and the TL and fused forwards' the same, finite."""
    jcn = JaxControlNet(1, TINY_MODEL_CONFIG)
    ref = jax.eval_shape(lambda pp: jcn.forward_paired(
        pp, jnp.zeros((2, 8, 8, 1), jnp.bfloat16), jnp.array([5, 100]),
        jnp.ones((2, 8, 8, 3), jnp.bfloat16)), jax.eval_shape(jcn.init, jax.random.PRNGKey(0)))
    cn = ControlNet(1, TINY_MODEL_CONFIG)
    x, t = torch.zeros(2, 1, 8, 8, dtype=torch.bfloat16), torch.tensor([5, 100])
    hint = torch.ones(2, 3, 8, 8, dtype=torch.bfloat16)
    for name in FORWARDS:
        with torch.no_grad():
            out = getattr(cn, name)(x, t, hint)
        assert str(out.dtype)[6:] == str(ref.dtype) == "bfloat16", name
        assert torch.isfinite(out.float()).all()


@pytest.mark.parametrize("block", ["down", "mid"])
def test_pair_and_fused_raise_on_cross_attention(block):
    """A cross-attention block has no paired or fused path, as in JAX."""
    kw = dict(t_emb_dim=8, num_heads=2, num_layers=1, norm_channels=4, cross_attn=True,
              context_dim=6)
    make = ((lambda: blocks.DownBlock(8, 8, down_sample=False, attn=True, **kw))
            if block == "down" else (lambda: blocks.MidBlock(8, 8, **kw)))
    a, b = make(), make()
    x, t = torch.zeros(1, 8, 4, 4), torch.zeros(1, 8)
    with pytest.raises(NotImplementedError, match="cross-attention"):
        a.pair(b, x, x, t, t)
    with pytest.raises(NotImplementedError, match="cross-attention"):
        a.fused(b, torch.cat([x, x], 1), t, t)


@pytest.mark.parametrize("name", FORWARDS)
def test_forwards_raise_under_tensor_parallelism(name):
    """Marks as ``tp_shard_params`` leaves them at a model axis of 2 (a
    column-parallel resnet conv, sharded attention heads): each of the three
    forwards raises, as ``Conv2d.tl`` always has."""
    cn = ControlNet(1, TINY_MODEL_CONFIG)
    mesh = object()
    for blk in (cn.trained_unet.downs[0], cn.control.downs[0]):
        blk.resnet_conv_first[0][2].tp_mesh, blk.resnet_conv_first[0][2].tp_mode = mesh, "col"
        blk.attentions[0].tp_mesh = mesh
    with pytest.raises(NotImplementedError, match="tensor-parallel|tensor parallelism"):
        getattr(cn, name)(torch.zeros(1, 1, 8, 8), torch.tensor([3]), torch.zeros(1, 3, 8, 8))


# --- kernel calls at the full MNIST width ---------------------------------------------------

def test_kernel_calls_per_forward_at_mnist_width(monkeypatch):
    """Calls of the plain versions of kernels c and a (what a CUDA tensor
    launches) per forward at the full width of config/mnist.yaml: c on every
    stride-1 3x3 conv of the TL forwards (38 a UNet, 63 a ControlNet: 25 in
    the control trunk; none in the others), a 26 a ControlNet forward in the
    default and TL forwards, 16 in the paired and fused ones (10 pairs at
    twice the batch and the decoder's 6).  chip_smoke.py phase 42 holds the
    launch counters to the same numbers."""
    calls = collections.Counter()
    conv_plain, attn_plain = cuda_conv.conv3x3_tl_plain, cuda_attention.fused_attention_t_plain

    def conv(weight, bias, x, hw):
        calls["c"] += 1
        return conv_plain(weight, bias, x, hw)

    def attn(qt, kt, vt):
        calls["a"] += 1
        calls["a_rows"] += qt.shape[0]
        return attn_plain(qt, kt, vt)

    monkeypatch.setattr(cuda_conv, "conv3x3_tl_plain", conv)
    monkeypatch.setattr(cuda_attention, "fused_attention_t_plain", attn)
    cn = ControlNet(1, MNIST_CONFIG).eval()
    x, t = torch.zeros(1, 1, 28, 28), torch.tensor([5])
    with torch.no_grad():
        feats = cn.hint_features(torch.zeros(1, 3, 28, 28))
        seen = {}
        for name in ("forward",) + FORWARDS:
            calls.clear()
            getattr(cn, name)(x, t, hint_features=feats)
            seen[name] = dict(calls)
        calls.clear()
        cn.trained_unet.forward_tl(x, t)
        seen["unet_tl"] = dict(calls)
    assert seen == {"forward": {"a": 26, "a_rows": 26},
                    "forward_tl": {"a": 26, "a_rows": 26, "c": 63},
                    "forward_paired": {"a": 16, "a_rows": 26},
                    "forward_fused": {"a": 16, "a_rows": 26},
                    "unet_tl": {"a": 16, "a_rows": 16, "c": 38}}
