"""The port's conditional UNet (class, text cross-attention and image
conditioning; controlnet_tpu_torch.models.unet, nn.blocks, config,
utils.diffusion_utils, sample.common / sample.cfg, io.jax_params) against the
JAX package, with JAX weights carried across and numpy-seeded inputs.

JAX runs jitted on the CPU (tests/conftest.py); the port runs on the CPU,
where attention takes its plain version.  Tolerances: blocks 1e-5, the UNet
1e-4 (PERF.md section 2), gradients 1e-4 of max|grad|, guided DDIM loops
2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port_util import load_block, np_tree, random_params, to_nchw, to_nhwc
from conftest import TINY_MODEL_CONFIG
from controlnet_tpu import config as jax_cfg
from controlnet_tpu.io.torch_export import export_unet
from controlnet_tpu.models.unet import UNet as JaxUNet
from controlnet_tpu.nn import blocks as jax_blocks
from controlnet_tpu.sample.cfg import make_cfg_eps_fn as jax_make_cfg_eps_fn
from controlnet_tpu.sample.common import cast_hint as jax_cast_hint
from controlnet_tpu.sample.ddim import make_ddim_sampler as jax_make_ddim_sampler
from controlnet_tpu.schedules import linear as jax_linear
from controlnet_tpu.utils import diffusion_utils as jax_du
from controlnet_tpu_torch import config as cfg
from controlnet_tpu_torch.io import jax_params
from controlnet_tpu_torch.models.unet import UNet, resize_nearest
from controlnet_tpu_torch.nn import blocks
from controlnet_tpu_torch.sample.cfg import make_cfg_eps_fn
from controlnet_tpu_torch.sample.common import cast_hint
from controlnet_tpu_torch.sample.ddim import make_ddim_sampler
from controlnet_tpu_torch.schedules import linear
from controlnet_tpu_torch.utils import diffusion_utils as du

BLOCK_ATOL = 1e-5
ATOL = 1e-4
SAMPLE_ATOL = 2e-4
CTX_DIM, CTX_LEN = 12, 5
CLASSES = 3
MASK_CH = 2
CONDITION = dict(
    class_condition_config=dict(num_classes=CLASSES),
    text_condition_config=dict(text_embed_dim=CTX_DIM),
    image_condition_config=dict(image_condition_input_channels=MASK_CH,
                                image_condition_output_channels=3),
)
TYPES = {"class": ["class"], "text": ["text"], "image": ["image"],
         "all": ["class", "text", "image"]}


def _config(types):
    mp = dict(TINY_MODEL_CONFIG)
    mp["condition_config"] = dict(CONDITION, condition_types=list(types))
    return mp


def _cond(seed, b, types, mask_size=32):
    """Numpy conditioning inputs, NHWC mask: the JAX layout."""
    rng = np.random.default_rng(seed)
    cond = {}
    if "class" in types:
        cond["class"] = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, b)]
    if "text" in types:
        cond["text"] = rng.standard_normal((b, CTX_LEN, CTX_DIM)).astype(np.float32)
    if "image" in types:
        cond["image"] = rng.standard_normal((b, mask_size, mask_size, MASK_CH)).astype(np.float32)
    return cond


def _jax_cond(cond):
    return {k: jnp.asarray(v) for k, v in cond.items()}


def _port_cond(cond):
    return {k: to_nchw(v) if k == "image" else torch.from_numpy(v) for k, v in cond.items()}


def _carried_unet(types, seed):
    mp = _config(types)
    ju = JaxUNet(1, mp)
    p = random_params(ju, seed)
    unet = UNet(1, mp)
    unet.load_state_dict(jax_params.unet_state_dict_from_jax(p), strict=True)
    return ju, p, unet.eval()


# --- config validators --------------------------------------------------------------------

@pytest.mark.parametrize("name,condition_config", [
    ("validate_class_config", {}),
    ("validate_class_config", {"class_condition_config": {}}),
    ("validate_text_config", {}),
    ("validate_text_config", {"text_condition_config": {}}),
    ("validate_image_config", {}),
    ("validate_image_config", {"image_condition_config": {"image_condition_output_channels": 3}}),
    ("validate_image_config", {"image_condition_config": {"image_condition_input_channels": 2}}),
], ids=["class-config", "num_classes", "text-config", "text_embed_dim", "image-config",
        "image-input-channels", "image-output-channels"])
def test_validators_raise_as_jax(name, condition_config):
    with pytest.raises(jax_cfg.ConfigError) as ref:
        getattr(jax_cfg, name)(condition_config)
    with pytest.raises(cfg.ConfigError) as got:
        getattr(cfg, name)(condition_config)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("cond_input,match", [
    (None, "has no class"), ({"text": torch.zeros(2, 5, 12)}, "has no class"),
    ({"class": torch.zeros(2, CLASSES + 1)}, r"one-hot \(B, num_classes\); got \(2, 4\)"),
    ({"class": torch.zeros(3, CLASSES)}, r"got \(3, 3\)"),
], ids=["none", "missing", "classes", "batch"])
def test_class_input_validator(cond_input, match):
    x = torch.zeros(2, 1, 8, 8)
    with pytest.raises(cfg.ConfigError, match=match):
        cfg.validate_class_conditional_input(cond_input, x, CLASSES)
    if cond_input is not None:
        jx = jnp.zeros((2, 8, 8, 1))
        with pytest.raises(jax_cfg.ConfigError, match=match):
            jax_cfg.validate_class_conditional_input(
                {k: jnp.asarray(v.numpy()) for k, v in cond_input.items()}, jx, CLASSES)


@pytest.mark.parametrize("cond_input,match", [
    (None, "has no image"), ({"class": torch.zeros(2, 3)}, "has no image"),
    ({"image": torch.zeros(3, 2, 8, 8)}, "batch-matched NCHW"),
    ({"image": torch.zeros(2, 8, 8)}, "batch-matched NCHW"),
], ids=["none", "missing", "batch", "rank"])
def test_image_input_validator(cond_input, match):
    """The batch is dim 0 of an NCHW mask (the JAX check reads it from an
    NHWC one)."""
    with pytest.raises(cfg.ConfigError, match=match):
        cfg.validate_image_conditional_input(cond_input, torch.zeros(2, 1, 8, 8))
    cfg.validate_image_conditional_input({"image": torch.zeros(2, 2, 32, 32)},
                                         torch.zeros(2, 1, 8, 8))


# --- condition dropping ---------------------------------------------------------------------

def test_drop_text_condition_matches_jax():
    rng = np.random.default_rng(0)
    text = rng.standard_normal((8, CTX_LEN, CTX_DIM)).astype(np.float32)
    empty = rng.standard_normal((1, CTX_LEN, CTX_DIM)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = jax_du.drop_text_condition(jnp.asarray(text), jnp.asarray(empty), key, 0.5)
    drop = np.array(jax.random.bernoulli(key, 0.5, (8,)))
    assert 0 < drop.sum() < 8
    got = du.drop_text_condition(torch.from_numpy(text), torch.from_numpy(empty), 0.5,
                                 drop=torch.from_numpy(drop))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    t = torch.from_numpy(text)
    assert du.drop_text_condition(t, torch.from_numpy(empty), 0.0) is t
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    a = du.drop_text_condition(t, torch.from_numpy(empty), 0.5, generator=g1)
    torch.testing.assert_close(a, du.drop_text_condition(t, torch.from_numpy(empty), 0.5,
                                                         generator=g2), rtol=0, atol=0)


def test_drop_class_condition_matches_jax():
    onehot = np.eye(10, dtype=np.float32)[np.random.default_rng(1).integers(0, 10, 16)]
    key = jax.random.PRNGKey(4)
    ref = jax_du.drop_class_condition(jnp.asarray(onehot), key, 0.5)
    keep = 1.0 - np.asarray(jax.random.bernoulli(key, 0.5, (16,))).astype(np.float32)
    assert 0 < keep.sum() < 16
    got = du.drop_class_condition(torch.from_numpy(onehot), 0.5, keep=torch.from_numpy(keep))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    rows = du.drop_class_condition(torch.from_numpy(onehot), 0.5,
                                   generator=torch.Generator().manual_seed(0)).sum(1)
    assert set(rows.tolist()) <= {0.0, 1.0}


# --- cross-attention blocks -----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["down", "mid", "up"])
def test_cross_attention_block_matches_jax(kind):
    """Down and Up run resnet -> self -> cross a layer, Mid self -> cross ->
    resnet, each cross layer GroupNorm on the queries and the unnormed
    projected context as keys and values."""
    b, h, w, t_dim, heads = 2, 4, 4, 8, 2
    kw = dict(num_heads=heads, num_layers=2, norm_channels=4, cross_attn=True,
              context_dim=CTX_DIM)
    if kind == "down":
        jb = jax_blocks.DownBlock(8, 16, t_dim, down_sample=True, attn=True, **kw)
        pb = blocks.DownBlock(8, 16, t_dim, down_sample=True, attn=True, **kw)
        cin = 8
    elif kind == "mid":
        jb = jax_blocks.MidBlock(16, 8, t_dim, **kw)
        pb = blocks.MidBlock(16, 8, t_dim, **kw)
        cin = 16
    else:
        jb = jax_blocks.UpBlock(16, 8, t_dim, up_sample=True, attn=True, upsample_ch=8, **kw)
        pb = blocks.UpBlock(16, 8, t_dim, up_sample=True, attn=True, upsample_ch=8, **kw)
        cin = 8
    p = random_params(jb, 7)
    load_block(pb, p)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    skip = rng.standard_normal((b, 2 * h, 2 * w, 8)).astype(np.float32)
    t_emb = rng.standard_normal((b, t_dim)).astype(np.float32)
    ctx = rng.standard_normal((b, CTX_LEN, CTX_DIM)).astype(np.float32)
    jt, jc = jnp.asarray(t_emb), jnp.asarray(ctx)
    pt, pc = torch.from_numpy(t_emb), torch.from_numpy(ctx)
    with torch.no_grad():
        if kind == "up":
            ref = jb(p, jnp.asarray(x), jnp.asarray(skip), jt, jc)
            out = pb(to_nchw(x), to_nchw(skip), pt, pc)
        else:
            ref = jb(p, jnp.asarray(x), jt, jc)
            out = pb(to_nchw(x), pt, pc)
        with pytest.raises(ValueError, match="context required"):
            pb(to_nchw(x), to_nchw(skip), pt) if kind == "up" else pb(to_nchw(x), pt)
    np.testing.assert_allclose(to_nhwc(out), np.asarray(ref), atol=BLOCK_ATOL)


# --- the UNet -------------------------------------------------------------------------------

def test_resize_nearest_follows_jax_not_torch_nearest():
    """16 -> 4: JAX (half-pixel centres) reads rows 2, 6, 10, 14, which is
    torch's nearest-exact; torch's nearest reads 0, 4, 8, 12."""
    x = torch.arange(16.0).reshape(1, 1, 16, 1).expand(1, 1, 16, 3).contiguous()
    got = resize_nearest(x, (4, 3))
    assert got[0, 0, :, 0].tolist() == [2.0, 6.0, 10.0, 14.0]
    ref = jax.image.resize(jnp.asarray(x.numpy()).transpose(0, 2, 3, 1), (1, 4, 3, 1), "nearest")
    np.testing.assert_array_equal(to_nhwc(got), np.asarray(ref))
    assert F.interpolate(x, size=(4, 3), mode="nearest")[0, 0, :, 0].tolist() == [0, 4, 8, 12]
    torch.testing.assert_close(got, F.interpolate(x, size=(4, 3), mode="nearest-exact"))
    for size in ((5, 7), (23, 9), (8, 8)):  # up, mixed, none
        ref = jax.image.resize(jnp.asarray(x.numpy()).transpose(0, 2, 3, 1), (1, *size, 1),
                               "nearest")
        np.testing.assert_array_equal(to_nhwc(resize_nearest(x, size)), np.asarray(ref))


@pytest.mark.parametrize("types", sorted(TYPES))
def test_conditional_unet_matches_jax(types):
    """Forward on carried weights.  The mask (32 -> 8, and 12 -> 8 with all
    three types) is downscaled where torch's nearest and JAX's nearest
    differ."""
    ju, p, unet = _carried_unet(TYPES[types], 10)
    b = 2
    rng = np.random.default_rng(10)
    x = rng.standard_normal((b, 8, 8, 1)).astype(np.float32)
    t = rng.integers(0, 1000, b)
    cond = _cond(11, b, TYPES[types], mask_size=12 if types == "all" else 32)
    ref = np.asarray(jax.jit(ju.__call__)(p, jnp.asarray(x), jnp.asarray(t), _jax_cond(cond)))
    with torch.no_grad():
        out = unet(to_nchw(x), torch.from_numpy(t), _port_cond(cond))
    np.testing.assert_allclose(to_nhwc(out), ref, atol=ATOL)
    if "image" in cond:
        m = _port_cond(cond)["image"]
        assert not torch.equal(F.interpolate(m, size=(8, 8), mode="nearest"),
                               resize_nearest(m, (8, 8)))
    with pytest.raises(ValueError, match="cond_input required"):
        unet(to_nchw(x), torch.from_numpy(t))


def test_conditional_state_dict_is_the_exported_one():
    """unet_state_dict_from_jax of a conditioned tree is the JAX package's
    export (the reference names: class_emb.weight, cond_conv_in,
    cross_attention_norms / cross_attentions / context_proj), and a reference
    .pth of it loads strictly."""
    _, p, unet = _carried_unet(TYPES["all"], 12)
    sd = jax_params.unet_state_dict_from_jax(p)
    ref = export_unet(np_tree(p))
    assert sorted(sd) == sorted(ref) == sorted(unet.state_dict())
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v))
    assert "class_emb.weight" in sd and "cond_conv_in.weight" in sd
    assert "cond_conv_in.bias" not in sd
    # one cross layer after each of the 5 self-attention layers (2 down, 1 mid, 2 up)
    assert sum(".cross_attentions.0.in_proj_weight" in k for k in sd) == 5
    assert sum(".context_proj.0.weight" in k for k in sd) == 5
    fresh = UNet(1, _config(TYPES["all"]))
    fresh.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in ref.items()},
                          strict=True)


def test_conditional_unet_gradient_matches_jax():
    """A DDPM loss mean((eps(x_t, t, cond) - noise)^2) through the fully
    conditioned UNet: the loss, and every weight's gradient within 1e-4 of
    max|grad| of jax.grad's."""
    ju, p, unet = _carried_unet(TYPES["all"], 13)
    b = 2
    rng = np.random.default_rng(13)
    x = rng.standard_normal((b, 8, 8, 1)).astype(np.float32)
    noise = rng.standard_normal((b, 8, 8, 1)).astype(np.float32)
    t = rng.integers(0, 1000, b)
    cond = _cond(14, b, TYPES["all"])

    def loss_fn(pp):
        return jnp.mean((ju(pp, jnp.asarray(x), jnp.asarray(t), _jax_cond(cond))
                         - jnp.asarray(noise)) ** 2)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(p)
    ref = jax_params.unet_state_dict_from_jax(np_tree(ref_grads))
    unet.zero_grad()
    loss = ((unet(to_nchw(x), torch.from_numpy(t), _port_cond(cond)) - to_nchw(noise)) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    gmax = max(v.abs().max().item() for v in ref.values())
    names = dict(unet.named_parameters())
    assert sorted(names) == sorted(ref)
    for k, g in ref.items():
        assert (names[k].grad - g).abs().max().item() <= 1e-4 * gmax, k
    for k in ("cond_conv_in.weight", "class_emb.weight", "mids.0.context_proj.0.weight",
              "ups.0.cross_attentions.0.in_proj_weight"):
        assert names[k].grad.abs().max() > 0, k


def _jax_noise(key, shape, steps):
    """x_T and the per-step noise as the JAX DDIM sampler draws them."""
    k0, key = jax.random.split(key)
    x_start = np.asarray(jax.random.normal(k0, shape, jnp.float32))
    zs = np.zeros((steps, *shape), np.float32)
    for i in range(steps):
        key, kstep = jax.random.split(key)
        zs[i] = np.asarray(jax.random.normal(kstep, shape, jnp.float32))
    return x_start, zs


def test_guided_ddim_with_dict_condition_matches_jax():
    """DDIM (eta 0.5) with guidance on a dict condition: the (cond, null)
    pair is concatenated leaf by leaf into one doubled-batch model call; the
    null is the zero one-hot, an empty-prompt embedding and the zero mask.
    x_T and the step noise are JAX's, injected."""
    ju, p, unet = _carried_unet(TYPES["all"], 15)
    b, steps = 2, 5
    cond = _cond(16, b, TYPES["all"])
    empty = np.random.default_rng(17).standard_normal((1, CTX_LEN, CTX_DIM)).astype(np.float32)
    null = {"class": np.zeros_like(cond["class"]), "image": np.zeros_like(cond["image"]),
            "text": np.repeat(empty, b, axis=0)}
    jsched = jax_linear.make_linear_schedule(20, 1e-4, 0.02)
    sched = linear.make_linear_schedule(20, 1e-4, 0.02, device="cpu")
    jeps = jax_make_cfg_eps_fn(lambda pp, x, t, c: ju(pp, x, t, c), 3.0)
    eps = make_cfg_eps_fn(lambda m, x, t, c: m(x, t, c), 3.0)
    jshape, shape = (b, 8, 8, 1), (b, 1, 8, 8)
    key = jax.random.PRNGKey(18)
    ref_x0, ref_traj = jax_make_ddim_sampler(jeps, jsched, jshape, steps, eta=0.5)(
        p, key, (_jax_cond(cond), _jax_cond(null)))
    x_start, zs = _jax_noise(key, jshape, steps)
    sampler = make_ddim_sampler(eps, sched, shape, steps, eta=0.5, device="cpu")
    x0, traj = sampler(unet, None, (_port_cond(cond), _port_cond(null)),
                       x_start=to_nchw(x_start),
                       step_noise=torch.from_numpy(zs.transpose(0, 1, 4, 2, 3).copy()))
    np.testing.assert_allclose(to_nhwc(x0), np.asarray(ref_x0), atol=SAMPLE_ATOL)
    for k in range(steps):
        np.testing.assert_allclose(to_nhwc(traj[k]), np.asarray(ref_traj[k]), atol=SAMPLE_ATOL)


# --- bf16 types -----------------------------------------------------------------------------

def test_cast_hint_casts_every_leaf_as_jax():
    cond = _cond(19, 2, TYPES["all"])
    for tree in (cond, (cond, cond)):
        jt = jax_cast_hint(jax.tree.map(jnp.asarray, tree), jnp.bfloat16)
        pt = cast_hint(jax.tree.map(torch.from_numpy, tree), torch.bfloat16)
        assert jax.tree.structure(jt) == jax.tree.structure(
            jax.tree.map(lambda t: t, pt, is_leaf=torch.is_tensor))
        flat_j = jax.tree.leaves(jt)
        flat_p = jax.tree.leaves(pt, is_leaf=torch.is_tensor)
        assert [str(a.dtype) for a in flat_j] == [str(a.dtype)[6:] for a in flat_p]
    x = torch.zeros(2)
    assert cast_hint(x, torch.bfloat16).dtype == torch.bfloat16
    assert cast_hint((x, x), torch.bfloat16)[1].dtype == torch.bfloat16
    assert cast_hint(x, None) is x


@pytest.mark.parametrize("leaves", ["bf16", "f32"])
@pytest.mark.parametrize("types", sorted(TYPES))
def test_bf16_output_dtype_matches_jax(types, leaves, monkeypatch):
    """bf16 x with each condition leaf cast to bf16 (what the samplers'
    cast_hint does) or left float32: the output type as JAX's
    (``jax.eval_shape``).  A float32 mask promotes the concat before conv_in,
    and with it the network, to float32 on both sides; a float32 context or
    one-hot does not.  The class term joins t_emb in float32."""
    mp = _config(TYPES[types])
    ju = JaxUNet(1, mp)
    jp = jax.eval_shape(ju.init, jax.random.PRNGKey(0))
    cond = _cond(20, 2, TYPES[types])
    jdt = jnp.bfloat16 if leaves == "bf16" else jnp.float32
    ref = jax.eval_shape(lambda pp, c: ju(pp, jnp.zeros((2, 8, 8, 1), jnp.bfloat16),
                                          jnp.array([1, 2]), c),
                         jp, {k: jnp.asarray(v, jdt) for k, v in cond.items()})
    unet = UNet(1, mp)
    pcond = {k: v.to(torch.bfloat16 if leaves == "bf16" else torch.float32)
             for k, v in _port_cond(cond).items()}
    seen = []
    orig = UNet.encode
    monkeypatch.setattr(UNet, "encode",
                        lambda self, out, t_emb, context=None: seen.append(t_emb.dtype)
                        or orig(self, out, t_emb, context))
    with torch.no_grad():
        out = unet(torch.zeros(2, 1, 8, 8, dtype=torch.bfloat16), torch.tensor([1, 2]), pcond)
    assert str(out.dtype)[6:] == str(ref.dtype)
    assert seen == [torch.float32]


def test_fused_switch_keeps_cross_attention_on_the_split_path(monkeypatch):
    """Kernel d is self-attention only: with the fused switch on, the text
    UNet's cross-attention layers still take the split path (projections and
    kernel a); its output stays the switch-off output."""
    from controlnet_tpu_torch.nn.layers import set_attn_fused_proj
    from controlnet_tpu_torch.ops import cuda_attention, cuda_attention_proj

    _, _, unet = _carried_unet(TYPES["text"], 21)
    calls = {"a_cross": 0, "a_self": 0, "d": 0}
    orig_a, orig_d = cuda_attention.fused_attention_t, cuda_attention_proj.fused_attention_proj

    def spy_a(qt, kt, vt):
        calls["a_cross" if kt.shape[3] == CTX_LEN else "a_self"] += 1
        return orig_a(qt, kt, vt)

    def spy_d(*args):
        calls["d"] += 1
        return orig_d(*args)

    monkeypatch.setattr(cuda_attention, "fused_attention_t", spy_a)
    monkeypatch.setattr(cuda_attention_proj, "fused_attention_proj", spy_d)
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal((2, 1, 8, 8)).astype(np.float32))
    cond = _port_cond(_cond(22, 2, TYPES["text"]))
    t = torch.tensor([3, 500])
    with torch.no_grad():
        off = unet(x, t, cond)
        set_attn_fused_proj(unet, True)
        on = unet(x, t, cond)
    # 5 self layers: 4 at head dim 8 take kernel d, the one at head dim 4 stays split
    assert calls == {"a_cross": 10, "a_self": 6, "d": 4}
    torch.testing.assert_close(on, off, rtol=0, atol=1e-5)
