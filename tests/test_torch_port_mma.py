"""The tensor-core kernels (bf16 attention forward a and backward b, the bf16
3x3 conv c, the fused projection + attention layer d), checked on the CPU
before any card sees them.

Three kinds of test:

* kernel d's launch planner (``cuda_attention_proj.launch_plan``) at the
  self-attention shapes of the MNIST, latent and CIFAR-10 models, float32
  and bfloat16: the query tiles partition L (each key row's K and V is
  projected by exactly one block: projection work 1.0), one cluster of at
  most 16 blocks, shared memory within a block's 227 KB; in bfloat16 the
  packing of short sequences into 64-row tiles covers each (element, token)
  once and every row attends to the keys of its own element only;
* kernels a and b's bf16 launch plan (``cuda_attention.mma_plan``: padded
  head dim, warpgroups, ring stages, the dkv query split, TMA or cp.async,
  shared memory) at the MNIST, latent, CIFAR-10 and cross shapes, and
  kernel c's (``cuda_conv.bf16_launch_plan``: on wgmma, tiles over the
  pixels across images, channel tiles, the split of Cin, shared memory, the
  grid; on mma.sync for images 64 wide and wider) at the 7 hint-encode
  shapes and a ragged one, and its TMA weight layout;
* a model of each kernel's arithmetic written in torch on the CPU (bf16
  operands, float32 sums; for a and d the online softmax over the kernel's
  key tiles, for b D from a's float32 output, dQ over key tiles, dK and dV
  over the query shares and tiles, for c on wgmma
  64-row pixel tiles across images, P's shifted rows, per-tap masks,
  16-channel slabs and the split's fixed-order sum, on mma.sync halo tiles;
  every float32 probability or
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

# (L, C, heads) -> float32 (rows, q_tiles, head_groups)
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
# (L, C, heads) -> bfloat16 (elements a cluster, 64-row tiles a head group,
# tiles (warpgroups) a block, head groups, heads a projection tile, output
# channels a tile)
BF16_PLANS = {
    (784, 64, 4): (1, 13, 1, 1, 2, 32),   # the lean instantiation: three blocks an SM
    (196, 128, 4): (1, 4, 1, 4, 1, 32),
    (196, 32, 4): (1, 4, 1, 4, 1, 16),
    (49, 256, 4): (5, 4, 2, 4, 1, 64),
    (49, 128, 4): (1, 1, 1, 4, 1, 32),
    (49, 64, 4): (1, 1, 1, 4, 1, 16),
    (1024, 384, 16): (1, 16, 2, 1, 4, 128),
    (1024, 128, 16): (1, 16, 2, 1, 8, 128),
    (256, 512, 16): (1, 4, 2, 4, 4, 128),
    (256, 256, 16): (1, 4, 1, 4, 2, 32),
    (64, 768, 16): (1, 1, 1, 8, 2, 96),
    (64, 384, 16): (1, 1, 1, 16, 1, 32),
    (16, 512, 16): (4, 1, 1, 8, 2, 64),
    (1024, 128, 4): (1, 16, 2, 1, 4, 128),
    (256, 256, 4): (1, 4, 2, 4, 1, 64),
    (64, 512, 4): (1, 1, 1, 4, 1, 128),
    (64, 256, 4): (1, 1, 1, 4, 1, 64),
    (64, 128, 4): (1, 1, 1, 4, 1, 32),
    (256, 64, 4): (1, 4, 1, 4, 1, 16),
}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_bf16_plan(l, c, heads, plan):
    """What every bf16 plan of kernel d holds (csrc/attention_proj_hopper.cuh)."""
    dh = c // heads
    dp = cuda_attention.mma_head_dim(dh)
    lean = plan.per_sm == 3
    if l >= 64 or lean or plan.elems == 1:  # one element a cluster, its tiles partition L
        assert plan.elems == 1 and plan.tiles == -(-l // 64)
    else:  # packed: the elements' flattened rows fill at least 90% of the tiles, or the most
        assert plan.elems * l <= plan.tiles * 64 < (plan.elems + 1) * l
        assert plan.tiles <= 4
    blocks = -(-plan.tiles // plan.warpgroups)
    if lean:  # one warpgroup a block, product tiles of at most 64 (DP 16: 32) columns
        cap = 32 if dp == 16 else 64
        assert dp <= 32 and plan.warpgroups == 1 and plan.per_sm == 3
        assert plan.heads_per_tile * dp <= cap and plan.out_cols <= cap
        assert plan.smem <= cuda_attention_proj.THREE_PER_SM
    else:
        assert plan.warpgroups == (2 if plan.tiles > 1 else 1)
    assert blocks * plan.groups <= cuda_attention_proj.MAX_CLUSTER
    assert heads % plan.groups == 0 and (c // plan.groups) % 8 == 0
    hpg = heads // plan.groups
    assert hpg % plan.heads_per_tile == 0 and plan.heads_per_tile * dp <= 128
    assert plan.out_cols in cuda_attention_proj.OUT_COLS
    assert plan.smem == cuda_attention_proj.shared_bytes_bf16(
        c, c, dp, plan.heads_per_tile, plan.out_cols, plan.wstages, plan.kvstages,
        plan.warpgroups)
    assert plan.smem <= cuda_attention_proj.MAX_SHARED_BYTES == 232448
    # each warpgroup's x tile of all C channels stays resident, then its head outputs
    assert plan.smem >= 1024 + plan.warpgroups * -(-c // 64) * 8192


def check_f32_plan(l, c, heads, plan):
    """What every float32 plan of kernel d holds (csrc/attention_proj.cuh):
    the query tiles partition the sequence, so that every key row lies in
    exactly one block's tile and its K and V are projected once (projection
    work 1.0); one cluster of at most 16 blocks; shared memory as the kernel
    sums it, within a block's 227 KB."""
    rows, q_tiles, groups, smem = plan
    assert rows * (q_tiles - 1) < l <= rows * q_tiles
    assert q_tiles * groups <= cuda_attention_proj.MAX_CLUSTER == 16
    assert heads % groups == 0 and (c // groups) % 8 == 0
    assert smem == cuda_attention_proj.shared_bytes(rows, c // heads, c, heads, groups, 4)
    assert smem <= cuda_attention_proj.MAX_SHARED_BYTES == 232448


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("l,c,heads", sorted(PLANS, reverse=True))
def test_launch_plan_at_the_model_shapes(l, c, heads, dtype):
    plan = cuda_attention_proj.launch_plan(l, c, c, heads, DTYPES[dtype])
    assert plan is not None and cuda_attention_proj.fused_proj_supported(
        l, c, c, heads, DTYPES[dtype])
    if dtype == "bfloat16":
        assert plan[:6] == BF16_PLANS[(l, c, heads)]
        check_bf16_plan(l, c, heads, plan)
        return
    assert plan[:3] == PLANS[(l, c, heads)]
    check_f32_plan(l, c, heads, plan)


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
    float32 projection pass spans the whole q tile (DP / 8 n-tiles) so the q
    columns lie in one pass, and float32 at 64 rows has no plan there (the C
    side builds none); bf16 pads as kernel a (a multiple of 16 up to 64, then
    96 or 128), one head a projection tile past 64, and plans 64-row tiles
    at every L up to 1,024."""
    pad = cuda_attention_proj._padded_head_dim
    assert [pad(d) for d in (64, 72, 88, 96, 104, 120, 128)] == [64, 96, 96, 96, 128, 128, 128]
    assert [cuda_attention.mma_head_dim(d) for d in (8, 24, 40, 72, 104, 120)] == [
        16, 32, 48, 96, 128, 128]
    assert pad(136) is None and cuda_attention_proj.MAX_HEAD_DIM == 128
    assert [cuda_attention_proj.proj_tiles(r, 64) for r in (16, 32, 64)] == [12, 12, 12]
    assert [cuda_attention_proj.proj_tiles(r, 96) for r in (16, 32, 64)] == [12, 12, 12]
    assert [cuda_attention_proj.proj_tiles(r, 128) for r in (16, 32, 64)] == [16, 16, 16]
    for l, c, heads in ((1024, 96, 1), (1024, 128, 1), (300, 256, 2)):
        assert cuda_attention_proj.launch_plan(l, c, c, heads, torch.float32) is None
        plan = cuda_attention_proj.launch_plan(l, c, c, heads, torch.bfloat16)
        assert plan.tiles == -(-l // 64) and plan.heads_per_tile == 1
        check_bf16_plan(l, c, heads, plan)


@pytest.mark.parametrize("l,c,heads,batch,groups", [
    (1024, 384, 16, 16, 2), (1024, 128, 16, 16, 2), (1024, 128, 4, 64, 1),
    (784, 64, 4, 64, 1), (784, 64, 4, 16, 1), (256, 512, 16, 16, 4), (49, 256, 4, 16, 4)])
def test_bf16_head_groups_follow_the_batch_past_8_tiles(l, c, heads, batch, groups):
    """Past 8 tiles (L > 512), and in the lean plans, the bf16 planner takes
    the fewest head groups whose blocks fill the card (``BF16_BLOCKS``),
    within 16 blocks a cluster (at L 784 the lean plan's 13 tiles leave one
    group); at 8 tiles or fewer the batch changes a full-width plan only
    where packed rows would leave fewer than ``FEW_BLOCKS`` blocks, which
    then take one element a tile."""
    plan = cuda_attention_proj.launch_plan(l, c, c, heads, torch.bfloat16, batch)
    assert plan.groups == groups
    check_bf16_plan(l, c, heads, plan)
    blocks = -(-plan.tiles // plan.warpgroups)
    clusters = -(-batch // plan.elems)
    if plan.tiles > 8 or plan.per_sm == 3:
        smaller = [g for g in range(1, groups) if heads % g == 0]
        assert all(clusters * blocks * g < cuda_attention_proj.BF16_BLOCKS for g in smaller)
        return
    unbatched = cuda_attention_proj.launch_plan(l, c, c, heads, torch.bfloat16)
    packed_blocks = -(-batch // unbatched.elems) * -(-unbatched.tiles // unbatched.warpgroups)
    if unbatched.elems > 1 and packed_blocks * unbatched.groups < cuda_attention_proj.FEW_BLOCKS:
        assert (plan.elems, plan.tiles, plan.warpgroups) == (1, 1, 1)
    else:
        assert plan == unbatched


# MNIST self-attention shapes at the served batch (16) and the forward's (64)
# -> bf16 (elements a cluster, 64-row tiles a group, warpgroups a block, head
# groups, blocks an SM)
BF16_MNIST_PLANS = {
    (784, 64, 4, 16): (1, 13, 1, 1, 3), (784, 64, 4, 64): (1, 13, 1, 1, 3),
    (196, 128, 4, 16): (1, 4, 1, 4, 3), (196, 128, 4, 64): (1, 4, 1, 1, 3),
    (196, 32, 4, 16): (1, 4, 1, 4, 3), (196, 32, 4, 64): (1, 4, 1, 1, 3),
    (49, 256, 4, 16): (1, 1, 1, 4, 2), (49, 256, 4, 64): (5, 4, 2, 4, 1),
    (49, 128, 4, 16): (1, 1, 1, 4, 3), (49, 128, 4, 64): (1, 1, 1, 4, 3),
    (49, 64, 4, 16): (1, 1, 1, 4, 3), (49, 64, 4, 64): (1, 1, 1, 4, 3),
}


@pytest.mark.parametrize("l,c,heads,batch", sorted(BF16_MNIST_PLANS))
def test_bf16_plans_at_the_mnist_shapes_fill_the_card(l, c, heads, batch):
    """bf16 kernel d's plans at the MNIST shapes, where plans of two
    warpgroups an SM were slower than the mma.sync kernel before them: at
    head dims 16 and 32 the lean instantiation (one warpgroup a block, three
    blocks an SM, product tiles of at most 64 columns) with one element a
    cluster and the fewest head groups that reach ``BF16_BLOCKS`` blocks (or
    the most that fit); at head dim 64 packed rows of five elements in four
    tiles, unless the batch leaves those clusters fewer than ``FEW_BLOCKS``
    blocks (batch 16: one element a tile, one warpgroup a block)."""
    plan = cuda_attention_proj.launch_plan(l, c, c, heads, torch.bfloat16, batch)
    got = (plan.elems, plan.tiles, plan.warpgroups, plan.groups, plan.per_sm)
    assert got == BF16_MNIST_PLANS[(l, c, heads, batch)]
    check_bf16_plan(l, c, heads, plan)
    blocks = -(-batch // plan.elems) * -(-plan.tiles // plan.warpgroups) * plan.groups
    assert blocks >= cuda_attention_proj.FEW_BLOCKS


@pytest.mark.parametrize("l,c,heads,batch", [
    (49, 384, 12, 64), (49, 512, 16, None), (49, 512, 16, 16), (22, 288, 16, None),
    (22, 288, 16, 64), (33, 384, 12, 64), (22, 384, 12, 64), (16, 512, 16, 64),
    (196, 512, 16, 16)])
def test_bf16_plan_past_the_lean_budget_is_a_full_width_one(l, c, heads, batch):
    """At head dims 16 and 32 a layer whose lean plan does not fit three
    blocks an SM (C past ~300 with few head groups: the resident x tile)
    takes the full-width planner's plan: its packing, or one element a
    cluster, with rows that fit its tiles (not the lean plan's one tile
    holding the packing's elements)."""
    plan = cuda_attention_proj.launch_plan(l, c, c, heads, torch.bfloat16, batch)
    assert plan.per_sm in (1, 2)
    check_bf16_plan(l, c, heads, plan)
    assert (plan.elems, plan.tiles) in (cuda_attention_proj.packing(l), (1, -(-l // 64)))
    assert plan.elems * l <= plan.tiles * 64


@pytest.mark.parametrize("l", [1, 2, 7, 16, 20, 33, 48, 49, 50, 63, 64, 100, 196, 300, 1024])
@pytest.mark.parametrize("b", [1, 3, 5, 16])
def test_packing_covers_each_token_once_and_fills_its_tiles(l, b):
    """bf16 kernel d's packing (``packing``, which ``launch_plan`` takes for
    a full-width (not lean) plan, here head dim 64, unless the batch's packed
    clusters would hold fewer than ``FEW_BLOCKS`` blocks): the ceil(B / elems)
    clusters hold each batch element once (the last one fewer where B is no
    multiple of elems); a cluster's elements fit its tiles, with no room for
    one more; from L = 64 up one element in ceil(L / 64) tiles; below, the
    fewest tiles (at most 4) that fill at least 90% of their rows, else the
    fullest.  That a packed row attends only to its own element's keys is
    the kernel's to show: the packed cases of
    ``test_kernel_d_model_against_jax_and_plain`` hold its model against JAX,
    and ``chip_smoke.phase_proj_edges`` the kernel against its plain
    version."""
    elems, tiles = cuda_attention_proj.packing(l)
    plan = cuda_attention_proj.launch_plan(l, 256, 256, 4, torch.bfloat16)
    assert (plan.elems, plan.tiles) == (elems, tiles)
    batched = cuda_attention_proj.launch_plan(l, 256, 256, 4, torch.bfloat16, b)
    packed_blocks = -(-b // elems) * -(-tiles // plan.warpgroups) * plan.groups
    if elems > 1 and packed_blocks < cuda_attention_proj.FEW_BLOCKS:
        assert (batched.elems, batched.tiles) == (1, 1)
    else:
        assert (batched.elems, batched.tiles) == (elems, tiles)
    clusters = -(-b // elems)
    held = [min(elems, b - k * elems) for k in range(clusters)]
    assert sum(held) == b and all(1 <= n <= elems for n in held)
    assert elems * l <= tiles * 64 < (elems + 1) * l
    if l >= 64:
        assert elems == 1 and tiles == -(-l // 64)
        return
    fill = {n: n * 64 // l * l / (64 * n) for n in range(1, 5)}
    full = [n for n in fill if fill[n] >= 0.9]
    assert tiles == (full[0] if full else max(fill, key=fill.get))
    assert elems == tiles * 64 // l


# chip_smoke.py's four lists of kernel d's shapes, (L, C, heads, calls)
MNIST_PROJ_SHAPES = [(784, 64, 4, 4), (196, 128, 4, 4), (196, 32, 4, 2), (49, 256, 4, 8),
                     (49, 128, 4, 4), (49, 64, 4, 2)]
LDM_PROJ_SHAPES = [(1024, 384, 16, 4), (1024, 128, 16, 2), (256, 512, 16, 4),
                   (256, 256, 16, 2), (64, 768, 16, 4), (64, 384, 16, 2), (16, 512, 16, 4)]
CIFAR_PROJ_SHAPES = [(1024, 128, 4, 4), (256, 256, 4, 4), (64, 512, 4, 8), (64, 256, 4, 4),
                     (64, 128, 4, 2), (256, 64, 4, 2)]
PROJ_WIDE_SHAPES = [(49, 288, 4, 1), (33, 192, 2, 1), (100, 192, 2, 1), (100, 120, 1, 1),
                    (20, 256, 2, 1), (300, 256, 2, 1)]


@pytest.mark.parametrize("l,c,heads,_", MNIST_PROJ_SHAPES + LDM_PROJ_SHAPES + CIFAR_PROJ_SHAPES
                         + PROJ_WIDE_SHAPES)
def test_bf16_support_is_unchanged_at_the_listed_shapes(l, c, heads, _):
    """The bf16 kernel takes every shape the mma.sync one took: all four of
    chip_smoke.py's lists, and L up to 1,024 at head dims up to 128; float32
    answers as before (no 64-row plan past head dim 64: (300, 256, 2) takes
    the split path in float32 only)."""
    assert cuda_attention_proj.fused_proj_supported(l, c, c, heads, torch.bfloat16)
    check_bf16_plan(l, c, heads, cuda_attention_proj.launch_plan(l, c, c, heads, torch.bfloat16))
    f32 = cuda_attention_proj.fused_proj_supported(l, c, c, heads, torch.float32)
    assert f32 == ((l, c, heads) != (300, 256, 2))
    for dh in (8, 24, 48, 72, 96, 120, 128):
        assert cuda_attention_proj.fused_proj_supported(1024, 2 * dh, 2 * dh, 2, torch.bfloat16)


@pytest.mark.parametrize("l,c,heads,_", MNIST_PROJ_SHAPES + LDM_PROJ_SHAPES + CIFAR_PROJ_SHAPES
                         + PROJ_WIDE_SHAPES)
def test_f32_support_is_unchanged_at_the_listed_shapes(l, c, heads, _):
    """float32 kernel d takes all four of chip_smoke.py's lists but (300,
    256, 2), head dim 128 at L > 256 (64-row blocks of that head dim outgrow
    a block's shared memory), which keeps the split path in float32; and
    each plan it gives, with the batch or without, holds the kernel's
    rules."""
    f32 = cuda_attention_proj.fused_proj_supported(l, c, c, heads, torch.float32)
    assert f32 == ((l, c, heads) != (300, 256, 2))
    for batch in (None, 16, 64):
        plan = cuda_attention_proj.launch_plan(l, c, c, heads, torch.float32, batch)
        assert (plan is not None) == f32
        if plan is not None:
            check_f32_plan(l, c, heads, plan)


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


def packed_rows(plan, b, l):
    """The model's layout of bf16 kernel d's rows, after the kernel's: for
    each cluster, its first batch element, its element count, and for each
    of its tiles' 64 rows the flattened row (element e, token t) -> e * L + t
    of the cluster, valid below ec * L."""
    for first in range(0, b, plan.elems):
        ec = min(plan.elems, b - first)
        yield first, ec, [range(tile * 64, tile * 64 + 64) for tile in range(plan.tiles)]


def row_keys(plan, l, ec, tile):
    """The model's key range of each row of a tile (the keys of its own
    element; padding rows take the last element's) and the key tiles it
    sweeps, after csrc/attention_proj_hopper.cuh's phase 2."""
    rows = torch.arange(tile * 64, tile * 64 + 64)
    e = torch.clamp(rows // l, max=ec - 1)
    e0, e1 = min(tile * 64 // l, ec - 1), min((tile * 64 + 63) // l, ec - 1)
    return e * l, e * l + l, range(e0 * l // 64, (e1 * l + l - 1) // 64 + 1)


def _masked_online_softmax_pv(s, v, lo, hi, key_tiles):
    """The bf16 kernel's sweep: key tiles of 64 in order, keys outside a row's
    [lo, hi) at -inf, exp2 against a running max that is 0 while a row has
    seen no key (as the kernel does), P as bf16 hi + lo into P V."""
    m = torch.full(s.shape[:-1], -math.inf)
    lsum = torch.zeros(s.shape[:-1])
    o = torch.zeros(*s.shape[:-1], v.shape[-1])
    for j in key_tiles:
        keys = torch.arange(j * 64, j * 64 + 64)
        st = s[..., j * 64:j * 64 + 64]
        st = st.masked_fill((keys[None, :] < lo[:, None]) | (keys[None, :] >= hi[:, None]),
                            -math.inf)
        m_new = torch.maximum(m, st.amax(-1))
        base = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
        corr = torch.exp2(m - base)
        p = torch.exp2(st - base[..., None])
        lsum = lsum * corr + p.sum(-1)
        o = o * corr[..., None] + _hi_lo(p) @ v[..., j * 64:j * 64 + 64, :]
        m = m_new
    return o, lsum


def model_attention_proj_d(x, in_w, in_b, out_w, out_b, heads):
    """Kernel d: x (B, L, C) in the input type; q|k|v summed in float32 and
    rounded once; per head an online softmax over the key tiles the launch
    plan gives, e never rounded in float32 and split into bf16 hi + lo in
    bf16; head outputs rounded; y summed in float32 and rounded once.  In
    bf16 the rows of ``plan.elems`` consecutive elements share a cluster's
    64-row tiles (``packed_rows``) and each row's keys are its own element's,
    masked per row in the key tiles of its tile (``row_keys``)."""
    dt = x.dtype
    b, l, c = x.shape
    d = out_w.shape[1]
    dh = d // heads
    plan = cuda_attention_proj.launch_plan(l, c, d, heads, dt)
    w, bias, wo, bo = (p.float() for p in (in_w, in_b, out_w, out_b))
    qkv = (x.float() @ w.t() + bias).to(dt).float()
    scale = math.log2(math.e) / math.sqrt(dh)
    if dt == torch.float32:
        q, k, v = (t.reshape(b, l, heads, dh).transpose(1, 2) for t in qkv.split(d, dim=-1))
        s = (q @ k.transpose(-1, -2)) * scale
        o, lsum, _ = _online_softmax_pv(s, v, plan[0], lambda p: p)
        out = (o / lsum[..., None]).transpose(1, 2).reshape(b, l, d)
    else:
        out = torch.zeros(b, l, d)
        for first, ec, tiles in packed_rows(plan, b, l):
            n = plan.tiles * 64
            # the cluster's flattened rows, padded to whole tiles with the
            # bias alone (a zero x row), per head (heads, n, dh)
            flat = torch.zeros(n, 3 * d)
            flat[:] = bias.to(dt).float()
            flat[:ec * l] = qkv[first:first + ec].reshape(ec * l, 3 * d)
            q, k, v = (t.reshape(n, heads, dh).transpose(0, 1) for t in flat.split(d, dim=-1))
            s = (q @ k.transpose(-1, -2)) * scale
            for tile, rows in enumerate(tiles):
                lo, hi, key_tiles = row_keys(plan, l, ec, tile)
                o, lsum = _masked_online_softmax_pv(s[:, rows.start:rows.stop], v, lo, hi,
                                                    key_tiles)
                res = (o / lsum[..., None]).transpose(0, 1).reshape(64, d)
                for r in rows:
                    if r < ec * l:
                        out[first + r // l, r % l] = res[r - rows.start]
    out = out.to(dt).float()
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
                                         (1, 64, 512, 4), (7, 49, 64, 4), (5, 16, 128, 4),
                                         (3, 33, 96, 4)],
                         ids=["mnist-L49", "mnist-L196", "latent-L64", "cifar-L64-dh128",
                              "packed-L49-B7", "packed-L16-B5", "packed-L33-B3"])
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


# --- kernel c: the bf16 3x3 conv on wgmma -------------------------------------------------

# (Cin, Cout, H, W, B): the hint encode's seven convs at batch 16 (1024^2
# hints, factor 32; chip_smoke.hint_conv_shapes) and chip_smoke's ragged shape
CONV_SHAPES = [(3, 16, 1024, 1024, 16), (32, 32, 512, 512, 16), (64, 64, 256, 256, 16),
               (128, 128, 128, 128, 16), (256, 256, 64, 64, 16), (512, 512, 32, 32, 16),
               (512, 256, 32, 32, 16), (24, 40, 30, 30, 16)]


def check_conv_bf16_plan(cin, cout, h, w, b):
    """The bf16 plan's invariants (tests/test_torch_port_tl_conv.py holds them
    at the 40 unit shapes).  Images 64 wide and wider take the mma.sync
    kernel: 8 x 32 pixels of one image and the fewest of 16 / 32 / 64
    channels that cover Cout a block, two stages of the halo tile and the
    slab's weights, two blocks an SM (its launch bounds), the grid within
    its limits.  The rest take the wgmma kernel: an instantiated tile, a
    ring of at least two slots; pixel tiles of 64 rows a warpgroup cover the
    B*H*W pixels across images once, channel tiles Cout, splits the
    16-channel slabs, each once and none empty; shared memory within a
    block's and, times the blocks an SM holds, an SM's; the grid within the
    tiles and the card; P holds every row a tap reads, in two gathering
    tasks a thread or three; 32-bit pixel indices."""
    plan = cuda_conv.bf16_launch_plan(cin, cout, h, w, b)
    if w >= cuda_conv.BF16_MMA_MIN_W == 64:
        assert isinstance(plan, cuda_conv.MmaPlan)
        th, tw = plan.pixel_tile
        assert (th, tw) == cuda_conv.MMA_PIXEL_TILE == (8, 32) and plan.stages == 2
        assert plan.tco == {16: 16, 32: 32}.get(cout, 64)
        assert plan.shared_bytes == {16: 42368, 32: 52096, 64: 71552}[plan.tco]
        assert 2 * plan.shared_bytes <= cuda_conv.MAX_SHARED_BYTES == 232448
        assert -(-h // th) * -(-w // tw) < 2 ** 31 and -(-cout // plan.tco) <= 65535 <= 65535
        assert b <= 65535
        return plan
    m, slabs = b * h * w, -(-cin // 16)
    assert plan.nwg in (1, 2) and plan.bn in cuda_conv.BF16_TILES_N and plan.stages >= 2
    for tiles, size, total in ((plan.m_tiles, 64 * plan.nwg, m), (plan.n_tiles, plan.bn, cout),
                               (plan.splits, plan.slabs_per_split, slabs)):
        starts = range(0, tiles * size, size)
        assert sum(min(total, s + size) - s for s in starts) == total
        assert all(s < total for s in starts)
    assert plan.tiles == plan.m_tiles * plan.n_tiles * plan.splits <= 2 ** 31 - 1
    assert plan.shared_bytes == cuda_conv.bf16_shared_bytes(plan.nwg, plan.bn, plan.stages, w)
    assert plan.shared_bytes <= cuda_conv.MAX_SHARED_BYTES == 232448
    assert plan.per_sm >= 1 and plan.per_sm * plan.shared_bytes <= 232448
    assert plan.per_sm * (plan.shared_bytes + 1024) <= cuda_conv.SM_SHARED_BYTES
    assert plan.per_sm <= cuda_conv.bf16_min_blocks(plan.nwg, plan.bn)
    assert 1 <= plan.blocks == min(plan.tiles, cuda_conv.SMS * plan.per_sm)
    # P: a tap (ky, kx) of row r reads row ky * W + r + kx < rows_p = 2W + 66
    assert plan.rows_p == 2 * w + 66 and 2 * w + 63 + 2 < plan.rows_p
    assert 2 * plan.rows_p <= 3 * 128
    assert m + 256 <= 2 ** 31 - 1
    return plan


@pytest.mark.parametrize("cin,cout,h,w,b", CONV_SHAPES)
def test_conv_bf16_launch_plan(cin, cout, h, w, b):
    """The hint encode's plans hold ``check_conv_bf16_plan`` (the 64^2 to
    1024^2 layers on the mma.sync kernel, the 32^2 ones and the ragged 30^2
    on wgmma); a split's float32 partial sums stay within the 40-bit sizes a
    buffer can hold."""
    plan = check_conv_bf16_plan(cin, cout, h, w, b)
    assert isinstance(plan, cuda_conv.MmaPlan) == (w >= 64)
    assert isinstance(plan, cuda_conv.MmaPlan) or plan.splits == 1 or (
        plan.splits * b * h * w * plan.n_pad * 4 < 2 ** 40)


def test_conv_bf16_launch_plan_refuses_what_32_bit_indices_cannot_hold():
    with pytest.raises(ValueError, match="32-bit"):
        cuda_conv.bf16_launch_plan(3, 16, 32, 32, 2 ** 21)
    with pytest.raises(ValueError, match="grid"):
        cuda_conv.bf16_launch_plan(3, 16, 64, 64, 65536)
    with pytest.raises(ValueError, match="W <= 63"):
        cuda_conv.bf16_wgmma_plan(3, 16, 8, 64, 1)


def model_conv_c(weight, bias, x, hw, plan=None):
    """Kernel c in bf16 on wgmma, as ``csrc/conv3x3_tl_bf16.cuh`` computes it:
    the pixel axis is M = B*H*W across images, a warpgroup owns 64
    consecutive m; its P tile holds the flat pixels m0 - W - 1 + q, q <
    2W + 66, zeros outside [0, M); tap (ky, kx) reads P row ky * W + r + kx,
    zeroed where it leaves the pixel's image; per 16-channel slab (Cin padded
    with zeros) the 9 taps' products into float32 sums; with a split, each
    part's float32 sums added in split order; then the float32 bias and one
    rounding.  (C, B, L) in, (Cout, B, L) out."""
    cin, b, _ = x.shape
    cout = weight.shape[0]
    h, w = hw
    plan = plan or cuda_conv.bf16_wgmma_plan(cin, cout, h, w, b)
    m = b * h * w
    sw = cuda_conv.slab_weight(weight).float()[:, :, :, :cout]  # (slabs, 9, 2, Cout, 8)
    slabs = sw.shape[0]
    wk = sw.permute(1, 3, 0, 2, 4).reshape(9, cout, slabs * 16)  # tap, o, c
    xf = torch.zeros(slabs * 16, m)
    xf[:cin] = x.float().reshape(cin, m)
    q = torch.arange(plan.rows_p)
    parts = torch.zeros(plan.splits, m, cout)
    for m0 in range(0, m, 64):
        pix = m0 - w - 1 + q
        ok = (pix >= 0) & (pix < m)
        ptile = torch.where(ok[:, None], xf[:, pix.clamp(0, m - 1)].T, torch.zeros(()))
        r = torch.arange(64)
        p = m0 + r
        l = p % (h * w)
        y, xx = l // w, l % w
        for sp in range(plan.splits):
            c0 = sp * plan.slabs_per_split * 16
            c1 = min(slabs, (sp + 1) * plan.slabs_per_split) * 16
            acc = torch.zeros(64, cout)
            for s in range(c0, c1, 16):
                for tap in range(9):
                    ky, kx = divmod(tap, 3)
                    inside = ((y + ky - 1 >= 0) & (y + ky - 1 < h) & (xx + kx - 1 >= 0)
                              & (xx + kx - 1 < w) & (p < m))
                    a = ptile[ky * w + r + kx, s:s + 16] * inside[:, None]
                    acc += a @ wk[tap, :, s:s + 16].T
            keep = p < m
            parts[sp, p[keep]] = acc[keep]
    total = parts[0]
    for sp in range(1, plan.splits):
        total = total + parts[sp]
    out = total + bias.float()
    return out.T.reshape(cout, b, h * w).to(torch.bfloat16)


def model_conv_c_mma(weight, bias, x, hw):
    """Kernel c in bf16 on mma.sync (``csrc/conv3x3_tl_bf16_mma.cu``, images
    64 wide and wider): per block a tile of 8 x 32 output pixels of one
    image and a tile of output channels; the input channels in slabs of 16
    (Cin padded with zeros); per slab the (10, 34) halo tile, zeros outside
    the image, and for each of the 9 taps the slab's (channels, 16) weights
    times the tap's shifted (16, 8 x 32) window, bf16 operands and float32
    sums; then the float32 bias and one rounding.  (C, B, L) in, (Cout, B,
    L) out."""
    cin, b, _ = x.shape
    cout = weight.shape[0]
    h, w = hw
    plan = cuda_conv.mma_launch_config(cin, cout, h, w, b)
    (th, tw), tco = plan.pixel_tile, plan.tco
    slab = cuda_conv.BF16_SLAB
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


def test_slab_weight_is_the_bf16_kernels_order_and_fits_tma():
    """(slabs, 9, 2, Cout16, 8): [s, 3 ky + kx, h, o, v] = w[o, 16 s + 8 h + v,
    ky, kx], zeros past Cin and Cout; contiguous bf16 read by TMA as rows of
    16 output channels x 8 values (256 bytes) whose outer strides are
    multiples of 16 bytes."""
    rng = np.random.default_rng(3)
    weight = torch.from_numpy(rng.standard_normal((5, 20, 3, 3)).astype(np.float32))
    sw = cuda_conv.slab_weight(weight)
    assert sw.shape == (2, 9, 2, 16, 8) and sw.dtype == torch.bfloat16 and sw.is_contiguous()
    assert all(st * 2 % 16 == 0 for st in sw.stride()[:-1]) and 16 * sw.shape[-1] * 2 == 256
    assert sw.shape[3] % 16 == 0 and not sw[:, :, :, 5:].any()
    wb = weight.bfloat16()
    for s in range(2):
        for tap in range(9):
            for hf in range(2):
                for v in range(8):
                    c = 16 * s + 8 * hf + v
                    want = wb[:, c, tap // 3, tap % 3] if c < 20 else torch.zeros(5)
                    assert torch.equal(sw[s, tap, hf, :5, v].float(), want.float())


def _conv_case(b, h, w, cin, cout):
    rng = np.random.default_rng(cin * cout + h)
    x = rng.standard_normal((b, cin, h, w)).astype(np.float32)
    bound = 1.0 / math.sqrt(9 * cin)
    wt = rng.uniform(-bound, bound, (cout, cin, 3, 3)).astype(np.float32)
    bias = rng.uniform(-bound, bound, cout).astype(np.float32)
    x_tl = cuda_conv.to_tl(torch.from_numpy(x).bfloat16())
    weight, bias_t = torch.from_numpy(wt), torch.from_numpy(bias)
    plain = cuda_conv.conv3x3_tl_plain(weight, bias_t, x_tl, (h, w)).float()
    ref = pallas_conv3x3_tl(jnp.asarray(wt.transpose(2, 3, 1, 0)), jnp.asarray(bias),
                            jnp.asarray(x_tl.float().numpy(), jnp.bfloat16), (h, w),
                            interpret=True)
    return weight, bias_t, x_tl, plain, torch.from_numpy(np.asarray(ref, np.float32))


@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 12, 36, 3, 16), (1, 13, 37, 32, 32),
                                            (2, 9, 32, 24, 40), (3, 7, 7, 32, 48),
                                            (1, 4, 4, 128, 64), (1, 5, 63, 16, 16)],
                         ids=["stem-cin3", "ragged-13x37", "cout40", "straddle-7x7",
                              "split-cin", "widest-63"])
def test_kernel_c_model_against_pallas_and_plain(b, h, w, cin, cout):
    """bf16 on wgmma, relative to max|out|: within one bf16 ulp of the largest
    output (2^-7) of the plain version and of the Pallas kernel in interpret
    mode, as chip_smoke.py's CONV_TOL holds the CUDA kernel; float32 sums in
    another order are all that differs before the one rounding.  The cases:
    the 3-channel stem, a ragged 13x37, Cout 40 (a masked channel tile), 64-row
    tiles straddling 7x7 images (147 pixels), 128 -> 64 @4x4 which the planner
    splits over the input channels, and W 63, the widest the kernel takes."""
    weight, bias_t, x_tl, plain, ref = _conv_case(b, h, w, cin, cout)
    plan = cuda_conv.bf16_wgmma_plan(cin, cout, h, w, b)
    if (h, w) == (7, 7):
        assert b * h * w % 64 != 0 and 64 % (h * w) != 0  # tiles straddle images
    if cin == 128:
        assert plan.splits > 1
    got = model_conv_c(weight, bias_t, x_tl, (h, w), plan).float()
    scale = plain.abs().max()
    assert (got - plain).abs().max() <= CONV_TOL_BF16 * scale
    assert (got - ref).abs().max() <= CONV_TOL_BF16 * scale


@pytest.mark.parametrize("b,h,w,cin,cout", [(1, 9, 70, 3, 16), (1, 10, 64, 32, 32),
                                            (2, 9, 66, 24, 40)],
                         ids=["stem-cin3", "w64", "cout40-ragged"])
def test_kernel_c_mma_model_against_pallas_and_plain(b, h, w, cin, cout):
    """bf16 on mma.sync (the planner's kernel for images 64 wide and wider),
    held as the wgmma model is: halo tiles, taps, 16-channel slabs; ragged H,
    W and Cout."""
    weight, bias_t, x_tl, plain, ref = _conv_case(b, h, w, cin, cout)
    assert isinstance(cuda_conv.bf16_launch_plan(cin, cout, h, w, b), cuda_conv.MmaPlan)
    got = model_conv_c_mma(weight, bias_t, x_tl, (h, w)).float()
    scale = plain.abs().max()
    assert (got - plain).abs().max() <= CONV_TOL_BF16 * scale
    assert (got - ref).abs().max() <= CONV_TOL_BF16 * scale
