"""The tensor-core kernels (bf16 attention forward a and backward b, the bf16
3x3 conv c, the fused projection + attention layer d), checked on the CPU
before any card sees them.

Three kinds of test:

* kernel d's launch planner (``cuda_attention_proj.launch_plan``) at the 13
  self-attention shapes of the MNIST and latent models, float32 and bfloat16:
  the query tiles partition L (each key row's K and V is projected by exactly
  one block: projection work 1.0), one cluster of at most 16 blocks per batch
  element, shared memory within a block's 227 KB;
* kernel a's bf16 launch configuration at the MNIST and latent shapes, and
  kernel c's (``cuda_conv.mma_launch_config``) at the 7 hint-encode shapes
  and a ragged one;
* a model of each kernel's arithmetic written in torch on the CPU (bf16
  operands, float32 sums; for a and d the online softmax over the kernel's
  key tiles, for b the two sweeps over key tiles and the query tiles, for c
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


@pytest.mark.parametrize("dh,tile", [(4, 64), (8, 64), (16, 64), (24, 64), (32, 64), (48, 32),
                                     (64, 32)])
def test_bf16_backward_tile(dh, tile):
    """Kernel b in bf16 takes 64 keys (dq pass) or queries (dkv pass) a tile
    up to a padded head dim of 32, 32 beyond, where S, dP and two gradient
    accumulators of 16 rows would not fit a warp's registers."""
    assert cuda_attention.mma_bwd_tile(dh) == tile


@pytest.mark.parametrize("dh,lq,expect", [
    # CIFAR-10 forward (config/cifar.yaml: 512 channels at 4 heads, L 64)
    (128, 64, (128, 4)), (100, 64, (128, 4)), (96, 64, (96, 4)), (80, 49, (96, 4)),
    (65, 1024, (96, 4)), (128, 16, (128, 1)),
])
def test_bf16_launch_config_past_dh64(dh, lq, expect):
    """Kernel a in bf16 past head dim 64: dh padded to 96 or 128 (its two
    wide instantiations); the double-buffered K and V tiles then take more
    than 48 KB, which the launcher allows, and stay far inside a block's
    232,448 bytes (two blocks an SM at 4 warps)."""
    dp, warps, smem = cuda_attention.mma_launch_config(dh, lq)
    assert (dp, warps) == expect
    assert smem == 2 * dp * (cuda_attention.mma_launch_config(16, lq)[2] // 32)
    assert smem <= 232_448 // 2
    assert cuda_attention.mma_bwd_tile(dh) == 32


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
    """Kernel a: (B, H, dh, L) in; bf16 on the tensor cores (P split into
    bf16 hi + lo for P V, row sums from the float32 P), float32 as float32.
    Returns the output in the input type and the natural-log lse."""
    dh = qt.shape[2]
    q, k, v = (t.float().transpose(-1, -2) for t in (qt, kt, vt))
    s = (q @ k.transpose(-1, -2)) * (math.log2(math.e) / math.sqrt(dh))
    round_p = _hi_lo if qt.dtype == torch.bfloat16 else (lambda p: p)
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
    out, lse = model_attention_a(qt, kt, vt)
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


def model_attention_bwd_b(qt, kt, vt, dout, lse):
    """Kernel b: (B, H, dh, L) in, (dq, dk, dv) in the input type.  P from the
    saved lse in float32; the dq pass sums D = rowsum(dP o P) over the
    kernel's key tiles (``mma_bwd_tile``), then forms dS = P o (dP - D) and
    dQ over the same tiles; the dkv pass takes the queries in tiles of the
    same size for dV and dK.  In bf16 P and dS enter their products as
    hi + lo."""
    tile = cuda_attention.mma_bwd_tile(qt.shape[2])
    split = _hi_lo if qt.dtype == torch.bfloat16 else (lambda x: x)
    scale = 1.0 / math.sqrt(qt.shape[2])
    q, k, v, do = (t.float() for t in (qt, kt, vt, dout))
    s = torch.einsum("bhdq,bhdk->bhqk", q, k)
    p = torch.exp2(s * (scale * math.log2(math.e)) - lse[..., None] * math.log2(math.e))
    dp = torch.einsum("bhdq,bhdk->bhqk", do, v)
    lk, lq = k.shape[3], q.shape[3]
    d = torch.zeros(p.shape[:-1])
    for k0 in range(0, lk, tile):
        d = d + (dp[..., k0:k0 + tile] * p[..., k0:k0 + tile]).sum(-1)
    ds = p * (dp - d[..., None])
    dq = torch.zeros_like(q)
    for k0 in range(0, lk, tile):
        dq = dq + torch.einsum("bhdk,bhqk->bhdq", k[..., k0:k0 + tile],
                               split(ds[..., k0:k0 + tile]))
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for q0 in range(0, lq, tile):
        rows = slice(q0, q0 + tile)
        dv = dv + torch.einsum("bhdq,bhqk->bhdk", do[..., rows], split(p[:, :, rows]))
        dk = dk + torch.einsum("bhdq,bhqk->bhdk", q[..., rows], split(ds[:, :, rows]))
    grads = (dq * scale, dk * scale, dv)
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
    reassociation (1e-5).  D, formed from float32 P, within 1e-5 of max|D| of
    the plain rowsum(dP o P) in both types."""
    rng = np.random.default_rng(dh + lq + lk)
    q, dout = (rng.standard_normal((b, h, dh, lq)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, h, dh, lk)).astype(np.float32) for _ in range(2))
    dt = DTYPES[dtype]
    qt, kt, vt, dot = (torch.from_numpy(a).to(dt) for a in (q, k, v, dout))
    _, lse = model_attention_a(qt, kt, vt)
    got, d = model_attention_bwd_b(qt, kt, vt, dot, lse)
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
    before) is off rowsum(dP o P) by the output's rounding, far more than
    D from float32 P is."""
    rng = np.random.default_rng(7)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((1, 2, 16, 196)).astype(np.float32))
                     .bfloat16() for _ in range(4))
    out, lse = model_attention_a(q, k, v)
    _, d = model_attention_bwd_b(q, k, v, dout, lse)
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
