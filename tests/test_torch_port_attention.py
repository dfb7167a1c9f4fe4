"""Port attention (controlnet_tpu_torch.ops) against the JAX package.

On the CPU the port's ``fused_attention_t`` runs its plain version; the JAX
side runs the Pallas kernel in interpret mode.  Inputs come from a numpy
seed.  Tolerance: atol 2e-5 in float32 (the JAX package's own
kernel-vs-XLA tolerance; both sides sum in float32 in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlnet_tpu.nn.layers import MultiheadAttention as JaxMHA
from controlnet_tpu.ops import attention as jax_attention
from controlnet_tpu.ops.pallas_attention import fused_attention_t as jax_fused_attention_t
from controlnet_tpu_torch.io import jax_params
from controlnet_tpu_torch.nn.layers import MultiheadAttention
from controlnet_tpu_torch.ops import attention, cuda_attention

ATOL = 2e-5


def _qkv(seed, b, h, dh, lq, lk):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, dh, lq), dtype=np.float32)
    k = rng.standard_normal((b, h, dh, lk), dtype=np.float32)
    v = rng.standard_normal((b, h, dh, lk), dtype=np.float32)
    return q, k, v


@pytest.mark.parametrize("lq,lk,dh", [(49, 49, 64), (49, 49, 4), (196, 196, 16), (49, 7, 16),
                                      (64, 77, 24), (16, 77, 48)],
                         ids=["L49-dh64", "L49-dh4", "L196-dh16", "cross-Lq49-Lk7",
                              "cross-Lq64-Lk77-dh24", "cross-Lq16-Lk77-dh48"])
def test_fused_attention_t_matches_pallas_interpret(lq, lk, dh):
    q, k, v = _qkv(0, 2, 2, dh, lq, lk)
    ref = np.asarray(jax_fused_attention_t(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           interpret=True))
    out = cuda_attention.fused_attention_t(torch.from_numpy(q), torch.from_numpy(k),
                                           torch.from_numpy(v))
    assert out.shape == (2, 2, dh, lq) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_fused_attention_matches_jax_untransposed():
    q, k, v = (x.transpose(0, 1, 3, 2) for x in _qkv(1, 1, 2, 8, 16, 16))
    ref = np.asarray(jax_attention._xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    out = cuda_attention.fused_attention(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_reference_attention_is_xla_attention_in_bf16():
    """The plain version keeps _xla_attention's rounding: probabilities are
    cast to the input type before the second product.  bf16 inputs are
    exact in both frameworks; tolerance is one bf16 ulp at |x| < 4."""
    q, k, v = (x.transpose(0, 1, 3, 2) for x in _qkv(2, 1, 2, 16, 49, 49))
    ref = jax_attention._xla_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    out = attention.reference_attention(*(torch.from_numpy(np.ascontiguousarray(x)).bfloat16()
                                          for x in (q, k, v)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=2 ** -5)


@pytest.mark.parametrize("dh,lq,lk", [(16, 49, 49), (4, 784, 784), (8, 49, 7)],
                         ids=["self-dh16", "self-dh4-L784", "cross"])
def test_multi_head_attention_t_matches_jax(dh, lq, lk):
    heads = 4
    q, k, v = (x.reshape(2, heads * dh, -1) for x in _qkv(3, 2, heads, dh, lq, lk))
    ref = np.asarray(jax_attention.multi_head_attention_t(jnp.asarray(q), jnp.asarray(k),
                                                          jnp.asarray(v), heads))
    out = attention.multi_head_attention_t(torch.from_numpy(q), torch.from_numpy(k),
                                           torch.from_numpy(v), heads)
    assert out.shape == (2, heads * dh, lq)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_multi_head_attention_matches_jax():
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 49, 32), dtype=np.float32) for _ in range(3))
    ref = np.asarray(jax_attention.multi_head_attention(jnp.asarray(q), jnp.asarray(k),
                                                        jnp.asarray(v), 4))
    out = attention.multi_head_attention(*(torch.from_numpy(x) for x in (q, k, v)), 4)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def _carried_mha(d, heads, seed):
    jm = JaxMHA(d, heads)
    p = jm.init(jax.random.PRNGKey(seed))
    # nonzero biases so the packed-bias path is exercised
    ks = jax.random.split(jax.random.PRNGKey(seed + 100), 4)
    for kk, name in zip(ks, ("bq", "bk", "bv", "bo")):
        p[name] = 0.1 * jax.random.normal(kk, (d,))
    sd = {}
    jax_params._attention(jax.tree.map(np.asarray, p), "m", sd)
    mha = MultiheadAttention(d, heads)
    mha.load_state_dict(jax_params._to_torch({k[2:]: v for k, v in sd.items()}), strict=True)
    return jm, p, mha


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_multihead_attention_module_carried_weights(cross):
    d, heads = 32, 4
    jm, p, mha = _carried_mha(d, heads, 5)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 49, d), dtype=np.float32)
    kv = rng.standard_normal((2, 7, d), dtype=np.float32) if cross else None
    ref = np.asarray(jm(p, jnp.asarray(x), None if kv is None else jnp.asarray(kv)))
    with torch.no_grad():
        out = mha(torch.from_numpy(x), None if kv is None else torch.from_numpy(kv))
    assert out.shape == (2, 49, d)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_packed_projection_slices_reach_kernel_without_copy():
    """q, k, v handed to the wrapper are views into one (B, 3D, L) tensor:
    the wrapper takes any batch stride, so no copy is made."""
    seen = []
    orig = cuda_attention.fused_attention_t

    def spy(qt, kt, vt):
        seen.append((qt, kt, vt))
        return orig(qt, kt, vt)

    mha = MultiheadAttention(16, 4)
    x = torch.randn(3, 10, 16)
    cuda_attention.fused_attention_t = spy
    try:
        with torch.no_grad():
            mha(x)
    finally:
        cuda_attention.fused_attention_t = orig
    (qt, kt, vt), = seen
    assert qt.stride(0) == 3 * 16 * 10 and qt.data_ptr() != kt.data_ptr()
    assert kt.untyped_storage().data_ptr() == qt.untyped_storage().data_ptr()
    assert all(cuda_attention._panel_ok(t) for t in (qt, kt, vt))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, 1, 2, 8, 16, 16))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cuda_attention.fused_attention_t(q.half(), k.half(), v.half())
    big = torch.zeros(1, 1, cuda_attention.MAX_HEAD_DIM + 1, 4)
    with pytest.raises(ValueError, match="head_dim"):
        cuda_attention.fused_attention_t(big, big, big)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_attention.fused_attention_t(q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3))
    with pytest.raises(ValueError, match="differ"):
        cuda_attention.fused_attention_t(q, k[:, :1], v[:, :1])


@pytest.mark.parametrize("dh,lq,lk,tile,threads", [
    (16, 784, 784, 128, 128),   # dh 16 f32 tile: 16 KB / (2 * 16 * 4 B)
    (4, 784, 784, 512, 128),
    (4, 196, 196, 196, 128),    # whole head fits one tile
    (64, 49, 49, 32, 64),       # short query axis: 64-thread blocks
    (20, 196, 196, 64, 128),    # dh 20 pads to 32
    (8, 49, 7, 7, 64),
])
def test_launch_config(dh, lq, lk, tile, threads, monkeypatch):
    assert cuda_attention.launch_config(dh, lq, lk) == (tile, threads)
    monkeypatch.setattr(cuda_attention, "KV_TILE_BYTES", 48 * 1024)
    assert cuda_attention.launch_config(16, 784, 784) == (384, 128)


def test_launch_counter_untouched_by_plain_version():
    before = cuda_attention.launches
    q, k, v = (torch.from_numpy(x) for x in _qkv(7, 1, 2, 8, 16, 16))
    cuda_attention.fused_attention_t(q, k, v)
    assert cuda_attention.launches == before

