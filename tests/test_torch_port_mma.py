"""The tensor-core kernels (bf16 attention forward a and backward b, the bf16
3x3 conv c, the fused projection + attention layer d), checked on the CPU
before any card sees them.

Three kinds of test:

* kernel d's launch planner (``cuda_attention_proj.launch_plan``) at the 13
  self-attention shapes of the MNIST and latent models, float32 and bfloat16:
  the query tiles partition L (each key row's K and V is projected by exactly
  one block: projection work 1.0), one cluster of at most 16 blocks per batch
  element, shared memory within a block's 227 KB;
* kernels a and b's bf16 launch plan (``cuda_attention.mma_plan``: padded
  head dim, warpgroups, ring stages, the dkv query split, TMA or cp.async,
  shared memory) at the MNIST, latent, CIFAR-10 and cross shapes, and
  kernel c's (``cuda_conv.mma_launch_config``) at the 7 hint-encode shapes
  and a ragged one;
* a model of each kernel's arithmetic written in torch on the CPU (bf16
  operands, float32 sums; for a and d the online softmax over the kernel's
  key tiles, for b D from a's float32 output, dQ over key tiles, dK and dV
  over the query shares and tiles, for c
  the halo tiles, taps and 16-channel slabs; every float32 probability or
  gradient that enters a product split into bf16 hi + lo), held against the
  JAX functions (Pallas kernels in interpret mode) and the port's plain
  versions on numpy-seeded inputs at real or small shapes, batch 1-2.  The
  last fixes the bf16 tolerances that chip_smoke.py holds the CUDA kernels
  to: PROJ_TOL 2e-2 of max|out| for d, KERNEL_TOL 3e-2 absolute for a,
  BWD_KERNEL_TOL 1e-2 of max|grad| for b, CONV_TOL 1e-2 of max|out| for c,
  LSE_TOL 1e-4 for a's log-sum-exp.  In float32 the models agree with the
  plain versions to float32 reassociation (1e-5).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlnet_tpu.ops.pallas_attention import fused_attention_proj as jax_fused_attention_proj
from controlnet_tpu.ops.pallas_attention import fused_attention_t as jax_fused_attention_t
from controlnet_tpu.ops.pallas_conv import pallas_conv3x3_tl
from controlnet_tpu_torch.ops import cuda_attention, cuda_attention_proj, cuda_conv

# chip_smoke.py's tolerances for the kernels against their plain versions
PROJ_TOL_BF16 = 2e-2   # relative to max|out|
KERNEL_TOL_BF16 = 3e-2  # absolute
BWD_TOL_BF16 = 1e-2    # relative to max|grad|: one bf16 ulp, at most 2^-7
CONV_TOL_BF16 = 1e-2   # relative to max|out|: one bf16 ulp, at most 2^-7
LSE_TOL = 1e-4

# (L, C, heads) -> (rows, q_tiles, head_groups), the same in both types
PLANS = {
    (784, 64, 4): (64, 13, 1), (196, 128, 4): (32, 7, 2), (196, 32, 4): (32, 7, 2),
    (49, 256, 4): (16, 4, 4), (49, 128, 4): (16, 4, 4), (49, 64, 4): (16, 4, 4),
    (1024, 384, 16): (64, 16, 1), (1024, 128, 16): (64, 16, 1), (256, 512, 16): (32, 8, 2),
    (256, 256, 16): (32, 8, 2), (64, 768, 16): (16, 4, 4), (64, 384, 16): (16, 4, 4),
    (16, 512, 16): (16, 1, 16),
    # config/cifar.yaml's six fused layers: head dims 32, 64, 128, 64, 32, 16
    (1024, 128, 4): (64, 16, 1), (256, 256, 4): (32, 8, 2), (64, 512, 4): (16, 4, 4),
    (64, 256, 4): (16, 4, 4), (64, 128, 4): (16, 4, 4), (256, 64, 4): (32, 8, 2),
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


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("dh", [136, 192, 256])
def test_launch_plan_is_none_past_head_dim_128(dh, dtype):
    """Past the widest instantiation the planner answers None (it raised
    StopIteration before head dim 128 was instantiated) and the layer takes
    the split path."""
    assert cuda_attention_proj.launch_plan(49, 2 * dh, 2 * dh, 2, DTYPES[dtype]) is None
    assert not cuda_attention_proj.fused_proj_supported(49, 2 * dh, 2 * dh, 2, DTYPES[dtype])


def test_head_dims_past_64_pad_to_96_and_128():
    """72-96 run in the 96 instantiation, 104-128 in the 128 one; past 64 a
    projection pass spans the whole q tile (DP / 8 n-tiles) so the q columns
    lie in one pass, and float32 at 64 rows has no plan there (the C side
    builds none)."""
    pad = cuda_attention_proj._padded_head_dim
    assert [pad(d) for d in (64, 72, 88, 96, 104, 120, 128)] == [64, 96, 96, 96, 128, 128, 128]
    assert pad(136) is None and cuda_attention_proj.MAX_HEAD_DIM == 128
    assert [cuda_attention_proj.proj_tiles(r, 64) for r in (16, 32, 64)] == [12, 12, 12]
    assert [cuda_attention_proj.proj_tiles(r, 96) for r in (16, 32, 64)] == [12, 12, 12]
    assert [cuda_attention_proj.proj_tiles(r, 128) for r in (16, 32, 64)] == [16, 16, 16]
    for l, c, heads in ((1024, 96, 1), (1024, 128, 1), (300, 256, 2)):
        assert cuda_attention_proj.launch_plan(l, c, c, heads, torch.float32) is None
        assert cuda_attention_proj.launch_plan(l, c, c, heads, torch.bfloat16)[0] == 64


# (dh, Lq, Lk, B*H) -> (padded head dim, a's consumer warpgroups, a's and b's
# ring stages, b's query split, route of the query panels, route of the key
# panels), the panels contiguous or slices of one packed projection, 16-byte
# aligned
MMA_PLANS = [
    # MNIST forward and training step (B*H 256)
    (16, 784, 784, 256, (16, 2, 3, 3, 1, "tma", "tma")),
    (4, 784, 784, 256, (16, 2, 3, 3, 1, "tma", "tma")),
    (32, 196, 196, 256, (32, 2, 3, 3, 1, "cp.async8", "cp.async8")),
    (8, 196, 196, 256, (16, 2, 3, 3, 1, "cp.async8", "cp.async8")),
    (64, 49, 49, 256, (64, 1, 1, 1, 1, "elements", "elements")),
    (32, 49, 49, 256, (32, 1, 1, 1, 1, "elements", "elements")),
    (16, 49, 49, 256, (16, 1, 1, 1, 1, "elements", "elements")),
    # latent forward (B*H 256)
    (24, 1024, 1024, 256, (32, 2, 3, 3, 1, "tma", "tma")),
    (8, 1024, 1024, 256, (16, 2, 3, 3, 1, "tma", "tma")),
    (32, 256, 256, 256, (32, 2, 3, 3, 1, "tma", "tma")),
    (16, 256, 256, 256, (16, 2, 3, 3, 1, "tma", "tma")),
    (48, 64, 64, 256, (48, 1, 1, 1, 1, "tma", "tma")),
    (24, 64, 64, 256, (32, 1, 1, 1, 1, "tma", "tma")),
    (32, 16, 16, 256, (32, 1, 1, 1, 1, "tma", "tma")),
    # CIFAR-10 (config/cifar.yaml: 512 channels at 4 heads) and head dims past 64
    (128, 64, 64, 256, (128, 1, 1, 1, 1, "tma", "tma")),
    (100, 64, 64, 256, (128, 1, 1, 1, 1, "tma", "tma")),
    (96, 64, 64, 256, (96, 1, 1, 1, 1, "tma", "tma")),
    (80, 49, 49, 256, (96, 1, 1, 1, 1, "elements", "elements")),
    (65, 1024, 1024, 256, (96, 2, 2, 2, 1, "tma", "tma")),
    (128, 16, 16, 256, (128, 1, 1, 1, 1, "tma", "tma")),
    # few slices (one batch element): b splits the query axis
    (4, 784, 784, 4, (16, 2, 3, 3, 5, "tma", "tma")),
    (8, 196, 196, 4, (16, 2, 3, 3, 4, "cp.async8", "cp.async8")),
    (16, 784, 784, 4, (16, 2, 3, 3, 5, "tma", "tma")),
    (24, 1024, 1024, 16, (32, 2, 3, 3, 2, "tma", "tma")),
    (32, 196, 196, 4, (32, 2, 3, 3, 4, "cp.async8", "cp.async8")),
    (48, 64, 64, 16, (48, 1, 1, 1, 1, "tma", "tma")),
    (64, 49, 49, 4, (64, 1, 1, 1, 1, "elements", "elements")),
    # cross-attention: the conditional LDM's 77 text tokens, chip_smoke's CROSS_SHAPE
    (24, 1024, 77, 256, (32, 2, 2, 3, 1, "tma", "elements")),
    (32, 16, 77, 256, (32, 1, 2, 1, 1, "tma", "elements")),
    (16, 49, 7, 256, (16, 1, 1, 1, 1, "elements", "elements")),
]


@pytest.mark.parametrize("dh,lq,lk,bh,expect", MMA_PLANS,
                         ids=[f"dh{s[0]}-{s[1]}x{s[2]}-bh{s[3]}" for s in MMA_PLANS])
def test_mma_plan(dh, lq, lk, bh, expect):
    """Kernels a and b in bf16 (wgmma): dh padded with zeros to a multiple of
    16 up to 64, then 96 or 128; a's blocks one consumer warpgroup of 64
    query rows where Lq <= 64, else two; 64-wide tiles in a 3-stage ring (2
    past DP 64, no more than the streamed tiles); b's query split only where the slices' key tiles fill less
    than two waves of 132 SMs, every share non-empty; TMA where L is a
    multiple of 8, 8-byte cp.async where it is a multiple of 4, element
    loads where it is odd; every block's shared memory within the card's 232,448 bytes,
    with room for a second block an SM at DP <= 64."""
    plan = cuda_attention.mma_plan(dh, lq, lk, bh)
    packed = [3 * 4 * dh * length for length in (lq, lk)]  # q|k|v of 4 heads
    routes = tuple(cuda_attention.ROUTES[cuda_attention.loader_vec(length, [stride], [256])]
                   for length, stride in zip((lq, lk), packed))
    assert (plan.dp, plan.warpgroups, plan.fwd_stages, plan.bwd_stages, plan.split) + routes \
        == expect
    assert plan.dp % 16 == 0 and dh <= plan.dp and plan.dp == cuda_attention.mma_head_dim(dh)
    assert plan.q_tiles * 64 >= lq > (plan.q_tiles - 1) * 64
    assert plan.k_tiles * 64 >= lk > (plan.k_tiles - 1) * 64
    per = -(-plan.q_tiles // plan.split)
    assert (plan.split - 1) * per < plan.q_tiles <= plan.split * per
    if plan.split > 1:
        assert bh * plan.k_tiles < 2 * cuda_attention.SMS
    for smem in (plan.fwd_smem, plan.bwd_smem):
        assert smem <= cuda_attention.SMEM_LIMIT
        if plan.dp <= 64:
            assert 2 * smem <= cuda_attention.SMEM_LIMIT
    tile = plan.dp * 128
    staged = [2 * (2 * tile + 16) if n % 2 and n <= 128 else 0 for n in (lq, lk)]
    assert plan.fwd_smem == 1024 + tile * (plan.warpgroups + 2 * plan.fwd_stages) + \
        8 * (2 * plan.fwd_stages + 1) + staged[1]
    assert plan.bwd_smem == 1024 + tile * (2 + 2 * plan.bwd_stages) + 2 * 8192 + \
        plan.dp * 256 + 512 * plan.bwd_stages + 8 * (2 * plan.bwd_stages + 1) + staged[0]
    assert (plan.fwd_stages, plan.bwd_stages) == tuple(
        min(3 if plan.dp <= 64 else 2, n) for n in (plan.k_tiles, plan.q_tiles))
    # b's float32 scratch: the dQ accumulator of every query tile, and the
    # split's partial dK and dV
    partials = 2 * plan.split * bh * dh * lk if plan.split > 1 else 0
    assert plan.bwd_scratch == bh * plan.q_tiles * plan.dp * 64 + partials


@pytest.mark.parametrize("length,strides,ptrs,vec", [
    (784, [3 * 64 * 784], [0, 2 * 64 * 784], 8), (784, [64 * 784], [8], 4),
    (784, [64 * 784], [4], 2), (196, [3 * 128 * 196], [0, 256], 4),
    (198, [3 * 198 * 8], [0], 2), (200, [3 * 200 + 2], [0], 2), (49, [49 * 64], [0], 1),
    (64, [64], [2], 1), (77, [77 * 24], [0], 1)])
def test_loader_vec_follows_tma_and_cp_async_rules(length, strides, ptrs, vec):
    """TMA needs 16-byte global strides and a 16-byte aligned panel, the
    8-byte cp.async L and the strides multiples of 4 and 8-byte alignment,
    the 4-byte one even ones and 4-byte alignment."""
    assert cuda_attention.loader_vec(length, strides, ptrs) == vec


def test_f32_split_past_dh64():
    """The float32 forward splits a query row over 8 threads past a padded
    head dim of 64 (16 dims a thread: no spills) in blocks of 128 threads
    (16 rows); its tile keeps 16 KB."""
    assert [cuda_attention.fwd_split(d) for d in (4, 16, 64, 65, 96, 128)] == [1, 1, 1, 8, 8, 8]
    assert cuda_attention.launch_config(128, 64, 64) == (16, 128)
    assert cuda_attention.launch_config(64, 49, 49) == (32, 64)
    assert cuda_attention.bwd_launch_config(128, 64, 64) == (16, 15, 64, 64)


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
    """Kernel a: (B, H, dh, L) in; bf16 on the tensor cores (the keys in
    tiles of ``MMA_TILE``, P split into bf16 hi + lo for P V, row sums from
    the float32 P), float32 as float32.  Returns the output in the input
    type, the natural-log lse, and the float32 output before its rounding
    (what kernel a writes for kernel b's D)."""
    dh = qt.shape[2]
    q, k, v = (t.float().transpose(-1, -2) for t in (qt, kt, vt))
    s = (q @ k.transpose(-1, -2)) * (math.log2(math.e) / math.sqrt(dh))
    round_p = _hi_lo if qt.dtype == torch.bfloat16 else (lambda p: p)
    o, l, m = _online_softmax_pv(s, v, cuda_attention.MMA_TILE, round_p)
    out32 = (o / l[..., None]).transpose(-1, -2)
    return out32.to(qt.dtype), m * math.log(2.0) + torch.log(l), out32


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
@pytest.mark.parametrize("b,l,c,heads", [(2, 49, 256, 4), (1, 196, 128, 4), (1, 64, 384, 16),
                                         (1, 64, 512, 4)],
                         ids=["mnist-L49", "mnist-L196", "latent-L64", "cifar-L64-dh128"])
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
@pytest.mark.parametrize("b,h,dh,lq,lk", [(1, 2, 16, 784, 784), (1, 2, 24, 1024, 1024),
                                          (2, 2, 48, 64, 64), (2, 2, 4, 196, 196),
                                          (2, 2, 128, 64, 64), (2, 2, 96, 64, 64),
                                          (2, 2, 24, 64, 77), (2, 2, 48, 16, 77)],
                         ids=["mnist-L784", "latent-L1024", "latent-L64", "mnist-L196-dh4",
                              "cifar-L64-dh128", "L64-dh96", "cross-64x77-dh24",
                              "cross-16x77-dh48"])
def test_kernel_a_model_against_jax_and_plain(b, h, dh, lq, lk, dtype):
    """Kernel a follows the Pallas kernel, which contracts float32 P with V
    upcast: with P as hi + lo the bf16 model sits within one bf16 ulp of the
    largest output (2^-7 max|out|) of both the plain version and the Pallas
    kernel (measured: at most 1.8e-3 max|out| from each; the old bf16-P
    rounding was up to 6.5e-3 max|out| from the Pallas kernel).  The cross
    cases (the conditional LDM's 77 text tokens) walk one full key tile and
    a ragged one."""
    rng = np.random.default_rng(dh + lq + (lk if lk != lq else 0))
    q = rng.standard_normal((b, h, dh, lq)).astype(np.float32)
    k, v = (rng.standard_normal((b, h, dh, lk)).astype(np.float32) for _ in range(2))
    dt = DTYPES[dtype]
    qt, kt, vt = (torch.from_numpy(a).to(dt) for a in (q, k, v))
    out, lse, _ = model_attention_a(qt, kt, vt)
    plain = cuda_attention.fused_attention_t_plain(qt, kt, vt)
    ref = jax_fused_attention_t(*(jnp.asarray(a, dtype) for a in (q, k, v)), interpret=True)
    ref = torch.from_numpy(np.asarray(ref, np.float32))
    scale = plain.float().abs().max().item()
    err_plain = (out.float() - plain.float()).abs().max().item() / scale
    err_jax = (out.float() - ref).abs().max().item() / scale
    if dt == torch.bfloat16:
        assert err_plain < 2.0 ** -7
        assert err_jax < 2.0 ** -7
    else:
        assert err_plain < 1e-5
        assert err_jax < 1e-5
    # the saved lse: from the float32 P, whatever the input type
    s = torch.einsum("bhdq,bhdk->bhqk", qt.float(), kt.float()) / math.sqrt(dh)
    assert (lse - torch.logsumexp(s, -1)).abs().max().item() < LSE_TOL


def model_attention_bwd_b(qt, kt, vt, dout, lse, out32):
    """Kernel b: (B, H, dh, L) in, (dq, dk, dv) in the input type.  D =
    rowsum(dO o O) from kernel a's float32 output before its rounding; P from
    the saved lse in float32 and dS = P o (dP - D); dQ summed over key tiles
    of ``MMA_TILE`` (each key block's float32 product added into the
    accumulator, in whatever order they arrive); dV and dK summed over query
    tiles of the same size within each of the plan's query shares, then the
    shares in order.  In bf16 P and dS enter their products as hi + lo."""
    b, h, dh, lq = qt.shape
    lk = kt.shape[3]
    tile = cuda_attention.MMA_TILE
    plan = cuda_attention.mma_plan(dh, lq, lk, b * h)
    split = _hi_lo if qt.dtype == torch.bfloat16 else (lambda x: x)
    scale = 1.0 / math.sqrt(dh)
    q, k, v, do = (t.float() for t in (qt, kt, vt, dout))
    d = (do * out32).sum(2)
    s = torch.einsum("bhdq,bhdk->bhqk", q, k)
    p = torch.exp2(s * (scale * math.log2(math.e)) - lse[..., None] * math.log2(math.e))
    dp = torch.einsum("bhdq,bhdk->bhqk", do, v)
    ds = p * (dp - d[..., None])
    dq = torch.zeros_like(q)
    for k0 in range(0, lk, tile):
        dq = dq + torch.einsum("bhdk,bhqk->bhdq", k[..., k0:k0 + tile],
                               split(ds[..., k0:k0 + tile]))
    per = -(-plan.q_tiles // plan.split) * tile
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for z0 in range(0, lq, per):
        pk, pv = torch.zeros_like(k), torch.zeros_like(v)
        for q0 in range(z0, min(lq, z0 + per), tile):
            rows = slice(q0, q0 + tile)
            pv = pv + torch.einsum("bhdq,bhqk->bhdk", do[..., rows], split(p[:, :, rows]))
            pk = pk + torch.einsum("bhdq,bhqk->bhdk", q[..., rows], split(ds[:, :, rows]))
        dk, dv = dk + pk * scale, dv + pv
    grads = (dq * scale, dk, dv)
    return tuple(g.to(qt.dtype) for g in grads), d


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,h,dh,lq,lk", [(1, 2, 16, 196, 196), (2, 2, 24, 64, 64),
                                          (2, 2, 16, 49, 7), (2, 2, 128, 64, 64),
                                          (2, 2, 128, 64, 49), (2, 2, 24, 64, 77),
                                          (2, 2, 48, 16, 77)],
                         ids=["mnist-L196", "latent-L64-dh24", "cross-49x7", "cifar-L64-dh128",
                              "cross-64x49-dh128", "cross-64x77-dh24", "cross-16x77-dh48"])
def test_kernel_b_model_against_jax_vjp_and_plain(b, h, dh, lq, lk, dtype):
    """Kernel b against jax.vjp of the Pallas forward (its backward is
    ``_attn_bwd_kernel_t``, interpret mode) and against the plain backward,
    each relative to max|grad| of the reference: bf16 within one bf16 ulp of
    the largest gradient (2^-7; chip_smoke.py's BWD_KERNEL_TOL), float32 to
    reassociation (1e-5).  D, formed as rowsum(dO o O) over kernel a's
    float32 output before its rounding (P as hi + lo in it), within 1e-5 of
    max|D| of the plain rowsum(dP o P) in both types.  Two slices a case:
    b splits the query axis."""
    rng = np.random.default_rng(dh + lq + lk)
    q, dout = (rng.standard_normal((b, h, dh, lq)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, h, dh, lk)).astype(np.float32) for _ in range(2))
    dt = DTYPES[dtype]
    qt, kt, vt, dot = (torch.from_numpy(a).to(dt) for a in (q, k, v, dout))
    _, lse, out32 = model_attention_a(qt, kt, vt)
    got, d = model_attention_bwd_b(qt, kt, vt, dot, lse, out32)
    plain = cuda_attention.fused_attention_t_bwd_plain(qt, kt, vt, dot)
    _, vjp = jax.vjp(lambda *a: jax_fused_attention_t(*a, interpret=True),
                     *(jnp.asarray(a, dtype) for a in (q, k, v)))
    ref = [torch.from_numpy(np.asarray(g, np.float32)) for g in vjp(jnp.asarray(dout, dtype))]
    tol = BWD_TOL_BF16 if dt == torch.bfloat16 else 1e-5
    for mine, p_ref, j_ref in zip(got, plain, ref):
        assert mine.dtype == dt
        assert (mine.float() - p_ref.float()).abs().max() <= tol * p_ref.float().abs().max()
        assert (mine.float() - j_ref).abs().max() <= tol * j_ref.abs().max()
    scale = 1.0 / math.sqrt(dh)
    probs = torch.softmax(torch.einsum("bhdq,bhdk->bhqk", qt.float(), kt.float()) * scale, -1)
    d_ref = (torch.einsum("bhdq,bhdk->bhqk", dot.float(), vt.float()) * probs).sum(-1)
    assert (d - d_ref).abs().max() <= 1e-5 * d_ref.abs().max()


def test_kernel_b_d_from_float32_p_not_the_rounded_output():
    """In bf16, rowsum(dO o O) over the bf16 output (how kernel b formed D
    once) is off rowsum(dP o P) by the output's rounding, far more
    than D over the float32 output before its rounding (kernel b's form) is."""
    rng = np.random.default_rng(7)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((1, 2, 16, 196)).astype(np.float32))
                     .bfloat16() for _ in range(4))
    out, lse, out32 = model_attention_a(q, k, v)
    _, d = model_attention_bwd_b(q, k, v, dout, lse, out32)
    probs = torch.softmax(torch.einsum("bhdq,bhdk->bhqk", q.float(), k.float()) / 4.0, -1)
    d_ref = (torch.einsum("bhdq,bhdk->bhqk", dout.float(), v.float()) * probs).sum(-1)
    scale = d_ref.abs().max()
    err_p = ((d - d_ref).abs().max() / scale).item()
    err_o = (((dout.float() * out.float()).sum(2) - d_ref).abs().max() / scale).item()
    assert err_p < 1e-5 and err_o > 100 * err_p


# --- kernel c: the bf16 3x3 conv on the tensor cores -------------------------------------

# (Cin, Cout, H, W, B): the hint encode's seven convs at batch 16 (1024^2
# hints, factor 32; chip_smoke.hint_conv_shapes) and chip_smoke's ragged shape
CONV_SHAPES = [(3, 16, 1024, 1024, 16), (32, 32, 512, 512, 16), (64, 64, 256, 256, 16),
               (128, 128, 128, 128, 16), (256, 256, 64, 64, 16), (512, 512, 32, 32, 16),
               (512, 256, 32, 32, 16), (24, 40, 30, 30, 16)]


@pytest.mark.parametrize("cin,cout,h,w,b", CONV_SHAPES)
def test_conv_mma_launch_config(cin, cout, h, w, b):
    """8 x 32 pixels and the fewest of 16 / 32 / 64 channels that cover Cout
    a block; two stages of the halo tile and the slab's weights; two blocks
    fit an SM (the kernel's launch bounds); the grid within its limits."""
    (th, tw), tco, stages, smem = cuda_conv.mma_launch_config(cin, cout, h, w, b)
    assert (th, tw) == cuda_conv.MMA_PIXEL_TILE == (8, 32) and stages == 2
    assert tco == {16: 16, 32: 32}.get(cout, 64)
    assert smem == {16: 42368, 32: 52096, 64: 71552}[tco]
    assert 2 * smem <= cuda_conv.MAX_SHARED_BYTES == 232448
    assert -(-h // th) * -(-w // tw) < 2 ** 31 and -(-cout // tco) <= 65535 and b <= 65535


def test_conv_mma_launch_config_refuses_what_the_grid_cannot_hold():
    with pytest.raises(ValueError, match="grid"):
        cuda_conv.mma_launch_config(3, 16, 64, 64, 65536)


def model_conv_c(weight, bias, x, hw):
    """Kernel c in bf16: per block a tile of 8 x 32 output pixels and a tile
    of output channels; the input channels in slabs of 16 (Cin padded with
    zeros); per slab the (10, 34) halo tile, zeros outside the image, and for
    each of the 9 taps the slab's (channels, 16) weights times the tap's
    shifted (16, 8 x 32) window, bf16 operands and float32 sums; then the
    float32 bias and one rounding.  (C, B, L) in, (Cout, B, L) out."""
    cin, b, _ = x.shape
    cout = weight.shape[0]
    h, w = hw
    (th, tw), tco, _, _ = cuda_conv.mma_launch_config(cin, cout, h, w, b)
    slab = cuda_conv.MMA_SLAB
    wf = cuda_conv.flat_weight(weight, torch.bfloat16, slab).float()
    cinp = wf.shape[1] // 9
    wf = wf.reshape(cout, 9, cinp)
    ht, wt = -(-h // th) * th, -(-w // tw) * tw
    xp = torch.zeros(b, cinp, ht + 2, wt + 2)
    xp[:, :cin, 1:h + 1, 1:w + 1] = cuda_conv.from_tl(x, hw).float()
    out = torch.zeros(cout, b, ht, wt)
    for y0 in range(0, ht, th):
        for x0 in range(0, wt, tw):
            halo = xp[:, :, y0:y0 + th + 2, x0:x0 + tw + 2]
            for co0 in range(0, cout, tco):
                wtile = wf[co0:co0 + tco]
                acc = torch.zeros(wtile.shape[0], b, th, tw)
                for c0 in range(0, cinp, slab):
                    for tap in range(9):
                        dy, dx = divmod(tap, 3)
                        win = halo[:, c0:c0 + slab, dy:dy + th, dx:dx + tw]
                        acc += torch.einsum("oc,bcyx->obyx", wtile[:, tap, c0:c0 + slab], win)
                acc += bias[co0:co0 + tco].float()[:, None, None, None]
                out[co0:co0 + tco, :, y0:y0 + th, x0:x0 + tw] = acc
    return out[:, :, :h, :w].reshape(cout, b, h * w).to(torch.bfloat16)


@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 12, 36, 3, 16), (1, 13, 37, 32, 32),
                                            (2, 9, 32, 24, 40)],
                         ids=["stem-cin3", "ragged-13x37", "cout40"])
def test_kernel_c_model_against_pallas_and_plain(b, h, w, cin, cout):
    """bf16, relative to max|out|: within one bf16 ulp of the largest output
    (2^-7) of the plain version and of the Pallas kernel in interpret mode,
    as chip_smoke.py's CONV_TOL holds the CUDA kernel; float32 sums in
    another order are all that differs before the one rounding."""
    rng = np.random.default_rng(cin * cout + h)
    x = rng.standard_normal((b, cin, h, w)).astype(np.float32)
    bound = 1.0 / math.sqrt(9 * cin)
    wt = rng.uniform(-bound, bound, (cout, cin, 3, 3)).astype(np.float32)
    bias = rng.uniform(-bound, bound, cout).astype(np.float32)
    x_tl = cuda_conv.to_tl(torch.from_numpy(x).bfloat16())
    weight, bias_t = torch.from_numpy(wt), torch.from_numpy(bias)
    got = model_conv_c(weight, bias_t, x_tl, (h, w)).float()
    plain = cuda_conv.conv3x3_tl_plain(weight, bias_t, x_tl, (h, w)).float()
    ref = pallas_conv3x3_tl(jnp.asarray(wt.transpose(2, 3, 1, 0)), jnp.asarray(bias),
                            jnp.asarray(x_tl.float().numpy(), jnp.bfloat16), (h, w),
                            interpret=True)
    ref = torch.from_numpy(np.asarray(ref, np.float32))
    scale = plain.abs().max()
    assert (got - plain).abs().max() <= CONV_TOL_BF16 * scale
    assert (got - ref).abs().max() <= CONV_TOL_BF16 * scale
