"""The tensor-core redesign of kernels a (bf16 attention forward) and d (the
fused projection + attention layer), checked on the CPU before any card
sees them.

Three kinds of test:

* kernel d's launch planner (``cuda_attention_proj.launch_plan``) at the 13
  self-attention shapes of the MNIST and latent models, float32 and bfloat16:
  the query tiles partition L (each key row's K and V is projected by exactly
  one block: projection work 1.0), one cluster of at most 16 blocks per batch
  element, shared memory within a block's 227 KB;
* kernel a's bf16 launch configuration at the MNIST and latent shapes;
* a model of each kernel's arithmetic written in torch on the CPU (bf16
  operands, float32 sums, the online softmax over the kernel's key tiles; e
  split into bf16 hi + lo for d, bf16 P for a), held against the JAX
  functions (Pallas kernels in interpret mode) and the port's plain versions
  on numpy-seeded inputs at real shapes, batch 1-2.  The last fixes the bf16
  tolerances that chip_smoke.py holds the CUDA kernels to: PROJ_TOL 2e-2 of
  max|out| for d, KERNEL_TOL 3e-2 absolute for a, LSE_TOL 1e-4 for a's
  log-sum-exp.  In float32 the models agree with the plain versions to float32
  reassociation (1e-5).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlnet_tpu.ops.pallas_attention import fused_attention_proj as jax_fused_attention_proj
from controlnet_tpu.ops.pallas_attention import fused_attention_t as jax_fused_attention_t
from controlnet_tpu_torch.ops import cuda_attention, cuda_attention_proj

# chip_smoke.py's tolerances for the kernels against their plain versions
PROJ_TOL_BF16 = 2e-2   # relative to max|out|
KERNEL_TOL_BF16 = 3e-2  # absolute
LSE_TOL = 1e-4

# (L, C, heads) -> (rows, q_tiles, head_groups), the same in both types
PLANS = {
    (784, 64, 4): (64, 13, 1), (196, 128, 4): (32, 7, 2), (196, 32, 4): (32, 7, 2),
    (49, 256, 4): (16, 4, 4), (49, 128, 4): (16, 4, 4), (49, 64, 4): (16, 4, 4),
    (1024, 384, 16): (64, 16, 1), (1024, 128, 16): (64, 16, 1), (256, 512, 16): (32, 8, 2),
    (256, 256, 16): (32, 8, 2), (64, 768, 16): (16, 4, 4), (64, 384, 16): (16, 4, 4),
    (16, 512, 16): (16, 1, 16),
}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("l,c,heads", sorted(PLANS, reverse=True))
def test_launch_plan_at_the_model_shapes(l, c, heads, dtype):
    plan = cuda_attention_proj.launch_plan(l, c, c, heads, DTYPES[dtype])
    assert plan is not None and cuda_attention_proj.fused_proj_supported(
        l, c, c, heads, DTYPES[dtype])
    rows, q_tiles, groups, smem = plan
    assert (rows, q_tiles, groups) == PLANS[(l, c, heads)]
    # the tiles partition the sequence: every key row lies in exactly one
    # block's tile, so its K and V are projected once (projection work 1.0)
    assert rows * (q_tiles - 1) < l <= rows * q_tiles
    assert q_tiles * groups <= cuda_attention_proj.MAX_CLUSTER == 16
    assert heads % groups == 0 and (c // groups) % 8 == 0
    itemsize = DTYPES[dtype].itemsize
    assert smem == cuda_attention_proj.shared_bytes(rows, c // heads, c, heads, groups, itemsize)
    assert smem <= cuda_attention_proj.MAX_SHARED_BYTES == 232448


@pytest.mark.parametrize("l,c,heads,dtype", [
    (1025, 64, 4, torch.float32),        # 17 tiles of 64 rows: past one cluster
    (64, 4096, 64, torch.float32),       # the gathered rows x D head outputs do not fit
    (784, 1600, 25, torch.float32),      # 64 rows x D head outputs do not fit
])
def test_launch_plan_refuses_what_a_cluster_cannot_hold(l, c, heads, dtype):
    assert cuda_attention_proj.launch_plan(l, c, c, heads, dtype) is None
    assert not cuda_attention_proj.fused_proj_supported(l, c, c, heads, dtype)


@pytest.mark.parametrize("dh,lq,expect", [
    # MNIST forward (26 calls)
    (16, 784, (16, 4)), (4, 784, (16, 4)), (32, 196, (32, 4)), (8, 196, (16, 4)),
    (64, 49, (64, 4)), (32, 49, (32, 4)), (16, 49, (16, 4)),
    # latent forward (22 calls)
    (24, 1024, (32, 4)), (8, 1024, (16, 4)), (32, 256, (32, 4)), (16, 256, (16, 4)),
    (48, 64, (48, 4)), (24, 64, (32, 4)), (32, 16, (32, 1)),
])
def test_bf16_launch_config(dh, lq, expect):
    """Kernel a in bf16: dh padded with zeros to a multiple of 16 (4 and 8 ->
    16, 24 -> 32); one warp per 16 query rows, up to 4 a block; the tiles fit
    well inside a block's shared memory, so several blocks share an SM."""
    dp, warps, smem = cuda_attention.mma_launch_config(dh, lq)
    assert (dp, warps) == expect
    assert dp % 16 == 0 and dh <= dp < dh + 16
    assert smem <= 48 * 1024


# --- models of the kernels' arithmetic ---------------------------------------------------

def _as_bf16(t):
    return t.to(torch.bfloat16).float()


def _online_softmax_pv(s, v, tile, round_p):
    """softmax(s) v over the key axis the way the kernels walk it: tiles of
    `tile` keys, scores in log2 units, running max and sum in float32; the
    exponentiated scores reach the product with V through round_p; returns
    (unnormalised output, row sum, running max)."""
    m = torch.full(s.shape[:-1], -math.inf)
    l = torch.zeros(s.shape[:-1])
    o = torch.zeros(*s.shape[:-1], v.shape[-1])
    for k0 in range(0, s.shape[-1], tile):
        st = s[..., k0:k0 + tile]
        m_new = torch.maximum(m, st.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(st - m_new[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + round_p(p) @ v[..., k0:k0 + tile, :]
        m = m_new
    return o, l, m


def model_attention_a(qt, kt, vt):
    """Kernel a: (B, H, dh, L) in; bf16 on the tensor cores (P rounded to
    bf16, row sums from the float32 P), float32 as float32.  Returns the
    output in the input type and the natural-log lse."""
    dh = qt.shape[2]
    q, k, v = (t.float().transpose(-1, -2) for t in (qt, kt, vt))
    s = (q @ k.transpose(-1, -2)) * (math.log2(math.e) / math.sqrt(dh))
    round_p = _as_bf16 if qt.dtype == torch.bfloat16 else (lambda p: p)
    o, l, m = _online_softmax_pv(s, v, cuda_attention.MMA_KV_TILE, round_p)
    out = (o / l[..., None]).to(qt.dtype).transpose(-1, -2)
    return out, m * math.log(2.0) + torch.log(l)


def _hi_lo(p):
    hi = _as_bf16(p)
    return hi + _as_bf16(p - hi)


def model_attention_proj_d(x, in_w, in_b, out_w, out_b, heads):
    """Kernel d: x (B, L, C) in the input type; q|k|v summed in float32 and
    rounded once; per head an online softmax over the launch plan's key
    tiles, e never rounded in float32 and split into bf16 hi + lo in bf16;
    head outputs rounded; y summed in float32 and rounded once."""
    dt = x.dtype
    b, l, c = x.shape
    d = out_w.shape[1]
    dh = d // heads
    rows = cuda_attention_proj.launch_plan(l, c, d, heads, dt)[0]
    w, bias, wo, bo = (p.float() for p in (in_w, in_b, out_w, out_b))
    qkv = (x.float() @ w.t() + bias).to(dt).float()
    q, k, v = (t.reshape(b, l, heads, dh).transpose(1, 2) for t in qkv.split(d, dim=-1))
    s = (q @ k.transpose(-1, -2)) * (math.log2(math.e) / math.sqrt(dh))
    o, lsum, _ = _online_softmax_pv(s, v, rows, _hi_lo if dt == torch.bfloat16 else (lambda p: p))
    out = (o / lsum[..., None]).to(dt).float().transpose(1, 2).reshape(b, l, d)
    return (out @ wo.t() + bo).to(dt)


def _proj_inputs(seed, b, l, c):
    """As chip_smoke.proj_inputs draws them: unit-normal activations and
    nn.MultiheadAttention-style weights with nonzero biases."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, c)).astype(np.float32)
    bound = np.sqrt(6.0 / (4 * c))
    in_w = rng.uniform(-bound, bound, (3 * c, c)).astype(np.float32)
    in_b = rng.uniform(-0.1, 0.1, 3 * c).astype(np.float32)
    out_w = rng.uniform(-1, 1, (c, c)).astype(np.float32) / np.sqrt(c)
    out_b = rng.uniform(-0.1, 0.1, c).astype(np.float32)
    return x, in_w, in_b, out_w, out_b


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,l,c,heads", [(2, 49, 256, 4), (1, 196, 128, 4), (1, 64, 384, 16)],
                         ids=["mnist-L49", "mnist-L196", "latent-L64"])
def test_kernel_d_model_against_jax_and_plain(b, l, c, heads, dtype):
    arrays = _proj_inputs(l + c, b, l, c)
    dt = DTYPES[dtype]
    x, in_w, in_b, out_w, out_b = (torch.from_numpy(a).to(dt) for a in arrays)
    model = model_attention_proj_d(x, in_w, in_b, out_w, out_b, heads).float()
    plain = cuda_attention_proj.fused_attention_proj_plain(x, in_w, in_b, out_w, out_b,
                                                           heads).float()
    jx, jw, jb, jwo, jbo = arrays
    ref = jax_fused_attention_proj(jnp.asarray(jx, dtype), jnp.asarray(jw.T), jnp.asarray(jb),
                                   jnp.asarray(jwo.T), jnp.asarray(jbo), heads, interpret=True)
    ref = torch.from_numpy(np.asarray(ref, np.float32))
    scale = plain.abs().max().item()
    err_plain = (model - plain).abs().max().item() / scale
    err_jax = (model - ref).abs().max().item() / scale
    if dt == torch.float32:
        assert err_plain < 1e-5 and err_jax < 1e-5
    else:
        assert err_plain < PROJ_TOL_BF16 and err_jax < PROJ_TOL_BF16


def test_hi_lo_split_keeps_16_bits():
    p = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, 100000).astype(np.float32))
    rel = ((_hi_lo(p) - p).abs() / p).max().item()
    assert rel < 2.0 ** -15
    assert ((_as_bf16(p) - p).abs() / p).max().item() > 2.0 ** -10  # bf16 alone: ~2^-9


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,h,dh,lq", [(1, 2, 16, 784), (1, 2, 24, 1024), (2, 2, 48, 64),
                                       (2, 2, 4, 196)],
                         ids=["mnist-L784", "latent-L1024", "latent-L64", "mnist-L196-dh4"])
def test_kernel_a_model_against_jax_and_plain(b, h, dh, lq, dtype):
    rng = np.random.default_rng(dh + lq)
    q, k, v = (rng.standard_normal((b, h, dh, lq)).astype(np.float32) for _ in range(3))
    dt = DTYPES[dtype]
    qt, kt, vt = (torch.from_numpy(a).to(dt) for a in (q, k, v))
    out, lse = model_attention_a(qt, kt, vt)
    plain = cuda_attention.fused_attention_t_plain(qt, kt, vt)
    ref = jax_fused_attention_t(*(jnp.asarray(a, dtype) for a in (q, k, v)), interpret=True)
    ref = torch.from_numpy(np.asarray(ref, np.float32))
    err_plain = (out.float() - plain.float()).abs().max().item()
    err_jax = (out.float() - ref).abs().max().item()
    tol = KERNEL_TOL_BF16 if dt == torch.bfloat16 else 1e-5
    assert err_plain < tol and err_jax < tol
    # the saved lse: from the float32 P, whatever the input type
    s = torch.einsum("bhdq,bhdk->bhqk", qt.float(), kt.float()) / math.sqrt(dh)
    assert (lse - torch.logsumexp(s, -1)).abs().max().item() < LSE_TOL
