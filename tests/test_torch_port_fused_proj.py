"""The port's fused projection + attention layer
(controlnet_tpu_torch.ops.cuda_attention_proj, nn.layers.MultiheadAttention
with ``fused_proj`` on) against the JAX package's ``fused_attention_proj``,
its Pallas kernel run in interpret mode on the CPU.

Inputs come from a numpy seed.  On the CPU the port's wrapper takes the
kernel's plain version, which makes the kernel's own roundings; the CUDA
kernel is held against that plain version on the card by chip_smoke.py.

Tolerances: float32 3e-5 (three chained float32 products summed in another
order).  bfloat16 6e-3 absolute on outputs of magnitude ~0.5, i.e. about three
bf16 ulps: both sides round q|k|v, each head's output and y to bf16 at the
same places, so they differ only where a float32 sum lands on the other side
of a rounding boundary.  (The JAX test allows 0.03 against the composed
reference, which rounds elsewhere.)
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_util import MNIST_CONFIG, random_params, to_nchw, to_nhwc
from controlnet_tpu.models.controlnet import ControlNet as JaxControlNet
from controlnet_tpu.nn import layers as jax_layers
from controlnet_tpu.ops.pallas_attention import fused_attention_proj as jax_fused_attention_proj
from controlnet_tpu_torch.io import jax_params
from controlnet_tpu_torch.models.controlnet import ControlNet
from controlnet_tpu_torch.nn import layers
from controlnet_tpu_torch.ops import cuda_attention, cuda_attention_proj

TOL = {"float32": 3e-5, "bfloat16": 6e-3}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (batch, heads, L, head_dim): the JAX test's two shapes, head dims 8 and 64,
# an L past one 128-lane tile, and a head dim of 24 as at the latent widths
CASES = [(2, 2, 49, 16), (1, 4, 64, 32), (2, 2, 40, 8), (1, 2, 33, 64), (1, 2, 130, 8),
         (1, 2, 20, 24)]


def _layer_inputs(seed, b, heads, l, dh):
    rng = np.random.default_rng(seed)
    d = heads * dh
    x = rng.standard_normal((b, l, d)).astype(np.float32)
    bound = np.sqrt(6.0 / (4 * d))
    wqkv = rng.uniform(-bound, bound, (d, 3 * d)).astype(np.float32)
    bqkv = (0.1 * rng.standard_normal(3 * d)).astype(np.float32)
    wo = rng.uniform(-1, 1, (d, d)).astype(np.float32) / np.sqrt(d)
    bo = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, wqkv, bqkv, wo, bo


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,heads,l,dh", CASES)
def test_plain_matches_jax_kernel(b, heads, l, dh, dtype):
    x, wqkv, bqkv, wo, bo = _layer_inputs(l + dh, b, heads, l, dh)
    ref = jax_fused_attention_proj(jnp.asarray(x, dtype), jnp.asarray(wqkv), jnp.asarray(bqkv),
                                   jnp.asarray(wo), jnp.asarray(bo), heads, interpret=True)
    assert ref.dtype == jnp.dtype(dtype)
    dt = TORCH_DTYPE[dtype]
    # the port takes nn.MultiheadAttention's layout: the transposes
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dt)
            for a in (x, wqkv.T, bqkv, wo.T, bo)]
    out = cuda_attention_proj.fused_attention_proj_plain(*args, heads)
    via_wrapper = cuda_attention_proj.fused_attention_proj(*args, heads)
    assert out.dtype == dt and out.shape == (b, l, heads * dh)
    torch.testing.assert_close(via_wrapper, out, rtol=0, atol=0)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), rtol=0,
                               atol=TOL[dtype])


def _carried_layer(d, heads, seed):
    jm = jax_layers.MultiheadAttention(d, heads)
    p = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv", "bo"):  # init leaves the biases at zero
        p[name] = (0.1 * rng.standard_normal(d)).astype(np.float32)
    sd = {}
    jax_params._attention(p, "m", sd)
    m = layers.MultiheadAttention(d, heads)
    m.load_state_dict(jax_params._to_torch({k[2:]: v for k, v in sd.items()}), strict=True)
    return jm, p, m.eval()


@pytest.mark.parametrize("channel_major", [True, False], ids=["channel_major", "tokens"])
def test_fused_layer_with_carried_weights_matches_jax(channel_major):
    """The fused layer fed weights through io/jax_params equals the JAX
    kernel fed the originals, and the port's own split path."""
    d, heads, b, l = 32, 2, 2, 49
    jm, p, m = _carried_layer(d, heads, 3)
    x = np.random.default_rng(4).standard_normal((b, l, d)).astype(np.float32)
    wqkv = np.concatenate([p["wq"], p["wk"], p["wv"]], axis=1)
    bqkv = np.concatenate([p["bq"], p["bk"], p["bv"]])
    ref = np.asarray(jax_fused_attention_proj(jnp.asarray(x), jnp.asarray(wqkv), jnp.asarray(bqkv),
                                              jnp.asarray(p["wo"]), jnp.asarray(p["bo"]), heads,
                                              interpret=True))
    composed = np.asarray(jm(p, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    if channel_major:  # the (B, L, C) view of a (B, C, L) tensor, as a block passes it
        xt = xt.transpose(1, 2).contiguous().transpose(1, 2)
    with torch.no_grad():
        off = m(xt)
        layers.set_attn_fused_proj(m, True)
        on = m(xt)
    np.testing.assert_allclose(on.numpy(), ref, rtol=0, atol=3e-5)
    np.testing.assert_allclose(on.numpy(), composed, rtol=0, atol=3e-5)
    torch.testing.assert_close(on, off, rtol=0, atol=3e-5)


def _spies(monkeypatch):
    """Count the calls of the two wrappers, by (L, C) and by (L, head_dim)."""
    fused, split = collections.Counter(), collections.Counter()
    orig_fused = cuda_attention_proj.fused_attention_proj
    orig_split = cuda_attention.fused_attention_t

    def spy_fused(x, *args):
        fused[(x.shape[1], x.shape[2])] += 1
        return orig_fused(x, *args)

    def spy_split(qt, kt, vt):
        split[(qt.shape[3], qt.shape[2])] += 1
        return orig_split(qt, kt, vt)

    monkeypatch.setattr(cuda_attention_proj, "fused_attention_proj", spy_fused)
    monkeypatch.setattr(cuda_attention, "fused_attention_t", spy_split)
    return fused, split


def test_controlnet_forward_with_switch_on_matches_jax(tiny_model_config, monkeypatch):
    """The narrow ControlNet with the fused layer on against the JAX ControlNet
    forward.  Its widths 8 and 16 with 2 heads give head dims 4 (split path)
    and 8 (fused), so both routes run."""
    cfg = tiny_model_config
    jcn = JaxControlNet(cfg["im_channels"], cfg)
    p = random_params(jcn, 5)
    cn = ControlNet(cfg["im_channels"], cfg).eval()
    cn.load_state_dict(jax_params.controlnet_state_dict_from_jax(p), strict=True)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, cfg["im_size"], cfg["im_size"], 1)).astype(np.float32)
    hint = rng.uniform(size=(2, cfg["im_size"], cfg["im_size"], 3)).astype(np.float32)
    t = rng.integers(0, 1000, size=(2,))
    ref = np.asarray(jax.jit(jcn.__call__)(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(hint)))
    with torch.no_grad():
        off = cn(to_nchw(x), torch.from_numpy(t), to_nchw(hint))
        layers.set_attn_fused_proj(cn, True)
        fused, split = _spies(monkeypatch)
        on = cn(to_nchw(x), torch.from_numpy(t), to_nchw(hint))
    assert sum(fused.values()) > 0 and sum(split.values()) > 0
    assert all(c // cfg["num_heads"] == 8 for _, c in fused)
    assert all(dh == 4 for _, dh in split)
    np.testing.assert_allclose(to_nhwc(on), ref, rtol=0, atol=1e-4)
    torch.testing.assert_close(on, off, rtol=0, atol=1e-4)


def test_full_width_forward_dispatch_with_switch_on(monkeypatch):
    """At the full MNIST width the switch sends 24 of the 26 self-attention
    calls to the fused layer; the two head-dim-4 calls keep the split path.
    chip_smoke.py holds the kernels' launch counters to the same numbers."""
    cn = ControlNet(1, MNIST_CONFIG).eval()
    layers.set_attn_fused_proj(cn, True)
    fused, split = _spies(monkeypatch)
    with torch.no_grad():
        cn(torch.zeros(1, 1, 28, 28), torch.tensor([5]), torch.zeros(1, 3, 28, 28))
    assert fused == {(784, 64): 4, (196, 128): 4, (196, 32): 2, (49, 256): 8, (49, 128): 4,
                     (49, 64): 2}
    assert split == {(784, 4): 2}
    assert sum(fused.values()) == 24 and sum(split.values()) == 2


def test_switch_is_off_by_default_and_set_below_a_model(tiny_model_config, monkeypatch):
    cn = ControlNet(1, tiny_model_config).eval()
    mhas = [m for m in cn.modules() if isinstance(m, layers.MultiheadAttention)]
    assert mhas and not any(m.fused_proj for m in mhas)
    fused, _ = _spies(monkeypatch)
    with torch.no_grad():
        cn(torch.zeros(1, 1, 8, 8), torch.tensor([5]), torch.zeros(1, 3, 8, 8))
    assert not fused
    layers.set_attn_fused_proj(cn, True)
    assert all(m.fused_proj for m in mhas)
    layers.set_attn_fused_proj(cn, False)
    assert not any(m.fused_proj for m in mhas)


@pytest.mark.parametrize("case", ["cross_attention", "head_dim_4"])
def test_calls_outside_the_rule_take_the_split_path(case, monkeypatch):
    fused, split = _spies(monkeypatch)
    torch.manual_seed(0)
    if case == "cross_attention":
        m = layers.MultiheadAttention(32, 2).eval()
        q, kv = torch.randn(2, 9, 32), torch.randn(2, 5, 32)
    else:
        m = layers.MultiheadAttention(16, 4).eval()
        q, kv = torch.randn(2, 9, 16), None
    with torch.no_grad():
        off = m(q, kv)
        m.fused_proj = True
        on = m(q, kv)
    assert not fused and sum(split.values()) == 2
    torch.testing.assert_close(on, off, rtol=0, atol=0)


@pytest.mark.parametrize("which", ["x", "weight"])
def test_a_tensor_that_requires_grad_raises(which):
    """Forward only, as the JAX kernel (no VJP): the wrapper says so."""
    m = layers.MultiheadAttention(16, 2)
    m.fused_proj = True
    x = torch.randn(1, 6, 16)
    if which == "x":
        for p in m.parameters():
            p.requires_grad_(False)
        x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        m(x)
    with torch.no_grad():
        assert m(x).shape == (1, 6, 16)


@pytest.mark.parametrize("l,c,d,heads,dtype,ok", [
    (784, 64, 64, 4, torch.float32, True),
    (1024, 384, 384, 16, torch.bfloat16, True),
    (64, 768, 768, 16, torch.float32, True),
    (784, 16, 16, 4, torch.float32, False),      # head dim 4
    (49, 288, 288, 4, torch.float32, False),     # head dim 72 > 64
    (49, 48, 48, 4, torch.float32, False),       # head dim 12, no multiple of 8
    (49, 64, 64, 4, torch.float16, False),       # float32 and bfloat16 only
    (49, 64, 64, 3, torch.float32, False),       # heads do not divide D
    (16, 4096, 4096, 64, torch.float32, False),  # the 32-row output tile does not fit
])
def test_fused_proj_supported(l, c, d, heads, dtype, ok):
    assert cuda_attention_proj.fused_proj_supported(l, c, d, heads, dtype) is ok


@pytest.mark.parametrize("l,c,heads,rows_f32,rows_bf16", [
    (784, 64, 4, 128, 128), (196, 128, 4, 128, 128), (196, 32, 4, 128, 128),
    (49, 256, 4, 64, 64), (49, 128, 4, 64, 64), (49, 64, 4, 64, 64),
    (1024, 384, 16, 64, 128), (1024, 128, 16, 128, 128), (256, 512, 16, 64, 128),
    (256, 256, 16, 128, 128), (64, 768, 16, 32, 64), (64, 384, 16, 64, 64),
    (16, 512, 16, 32, 32),
])
def test_tile_rows_at_the_model_shapes(l, c, heads, rows_f32, rows_bf16):
    """Rows per block at the 13 self-attention shapes of the two models: the
    tallest tile whose shared memory fits one block."""
    for dtype, rows in ((torch.float32, rows_f32), (torch.bfloat16, rows_bf16)):
        assert cuda_attention_proj.tile_rows(l, c, heads, dtype) == rows
        itemsize = torch.tensor([], dtype=dtype).element_size()
        assert (cuda_attention_proj.shared_bytes(rows, c // heads, c, itemsize)
                <= cuda_attention_proj.MAX_SHARED_BYTES)


def test_wrapper_checks_and_has_no_cpu_fallback(monkeypatch):
    """Mismatched parameters raise; only a CPU tensor takes the plain version
    (a tensor elsewhere, here on the meta device, raises instead)."""
    x, w, b = torch.zeros(1, 4, 16), torch.zeros(48, 16), torch.zeros(48)
    wo, bo = torch.zeros(16, 16), torch.zeros(16)
    with pytest.raises(ValueError, match="differ in type"):
        cuda_attention_proj.fused_attention_proj(x, w.bfloat16(), b, wo, bo, 2)
    with pytest.raises(ValueError, match="do not fit"):
        cuda_attention_proj.fused_attention_proj(x, w[:32], b, wo, bo, 2)
    with pytest.raises(ValueError, match=r"\(B, L, C\)"):
        cuda_attention_proj.fused_attention_proj(x[0], w, b, wo, bo, 2)
    monkeypatch.setattr(cuda_attention_proj, "fused_attention_proj_plain",
                        lambda *a: pytest.fail("fell back"))
    with pytest.raises(ValueError, match="no fused projection"):
        cuda_attention_proj.fused_attention_proj(*(t.to("meta") for t in (x, w, b, wo, bo)), 2)
    assert cuda_attention_proj.launches == 0
