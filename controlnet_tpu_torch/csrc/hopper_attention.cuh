// Hopper building blocks of the bf16 attention kernels a (attention_fwd_bf16.cu)
// and b (attention_bwd_bf16.cu), of the bf16 fused layer d
// (attention_proj_hopper.cuh) and of the bf16 conv c (conv3x3_tl_bf16.cuh,
// which takes the mbarriers, wgmma wrappers and tensor-map encoder): TMA
// tensor maps and loads, mbarriers, cluster barriers, the producer warp's
// copy routes, and wgmma on 128-byte-swizzled tiles.
//
// Tiles.  Every operand tile is a (DP, 64) block of a (dh, L) panel: DP rows
// (head dims, zero past dh) of 64 consecutive L values, one 128-byte row per
// head dim, 1024-byte aligned, with the 16-byte chunk c of row r stored at
// chunk c ^ (r % 8) (TMA's SWIZZLE_128B, which is what wgmma's 128-byte
// swizzle mode reads).  The same tile serves both ways round:
//   * MN-major (transpose bit set): as A (M = the 64 L values, K = head dims)
//     or B (N = the 64 L values, K = head dims) of the score products S = Q^T K
//     and dP = dO^T V; one K step of 16 head dims is 16 rows, 2048 bytes on;
//   * K-major: as B (N = DP head dims, K = the 64 L values) of the products
//     whose A is a float32 accumulator turned into bf16 registers (P V, dS K^T,
//     P^T dO^T, dS^T Q^T); one K step of 16 L values is 32 bytes along the row.
//
// Loading routes, chosen at run time per panel group by the wrapper
// (cuda_attention.loader_vec): 8 = TMA (L a multiple of 8, the batch stride a
// multiple of 8, the panel 16-byte aligned: TMA's 16-byte stride rule), 4 =
// 8-byte cp.async (L a multiple of 4), 2 = 4-byte cp.async (L even), 1 =
// element loads (odd L).  The copy routes write the same swizzled layout as
// TMA; a thread waits for its copies and fences them to the async proxy
// (which wgmma reads through) before it arrives on a stage's barrier or
// meets its warpgroup at a named barrier.  On a copy route a consumer
// warpgroup loads its own stationary tiles (so that they load beside the
// producer's first stage), on TMA the producer does.  TMA fills rows past dh
// and columns past L with zeros; the copy routes write the zeros themselves.
//
// Accumulators.  A 64 x N float32 accumulator of one warpgroup is float
// d[N / 8][4] per thread: warp w holds rows 16 w .. 16 w + 15, lane 4 g + t
// holds, for each 8 columns j, (16 w + g, 8 j + 2 t), (16 w + g, 8 j + 2 t + 1),
// (16 w + g + 8, 8 j + 2 t), (16 w + g + 8, 8 j + 2 t + 1): per warp the
// layout of mma.sync's m16n8 accumulator, so mma_attention.cuh's online
// softmax and hi + lo packing run on it unchanged.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "mma_attention.cuh"

namespace controlnet_hopper {

using bf16 = __nv_bfloat16;
using controlnet_mma::smem_addr;

constexpr int kTile = 64;          // L values per tile row (128 bytes of bf16)
constexpr int kRowBytes = 128;
constexpr float kLog2e = 1.4426950408889634f;

// Bytes of one (DP, 64) tile.
__host__ __device__ constexpr int tile_bytes(int dp) { return dp * kRowBytes; }

// Byte offset of byte `byte` (0..127) of row r in a swizzled tile.
__device__ __forceinline__ int swz(int r, int byte) {
  return r * kRowBytes + ((((byte >> 4) ^ r) & 7) << 4) + (byte & 15);
}

// --- mbarriers ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A new barrier is in
// phase 0, so a wait on parity 1 passes at once (the producer's first wait on
// an empty stage).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Order this thread's generic-proxy shared-memory writes before later
// async-proxy accesses (wgmma's operand reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Order this thread's generic-proxy accesses, to global and shared memory,
// before its later async-proxy ones (TMA reads of what other blocks wrote).
__device__ __forceinline__ void fence_proxy_async_all() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// Every thread of every block of the cluster meets here; writes before it
// (global and shared) are visible to reads after it anywhere in the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Barrier `id` (1..15) over `threads` threads (a warpgroup's 128).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --- loads -------------------------------------------------------------------------------

// One (64, DP, 1, 1) box of a 4-D (L, dh, H, B) tensor map at (col0, 0, h, b).
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int col0, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col0), "r"(0), "r"(h),
      "r"(b)
      : "memory");
}

// One box of a 3-D tensor map at (c0, c1, c2) into this block's shared memory.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// 8 bytes from global to shared memory, asynchronously; src_bytes 0 writes
// zeros (src must still be a valid address).
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// The copy routes: columns [col0, col0 + 64) of rows [0, DP) of the (dh, L)
// panel at `src` into the swizzled tile at `dst`, by `nthreads` threads
// (thread `tid` of them: the producer warp's 32, or a consumer warpgroup's
// 128 for its own stationary tiles); rows >= dh and columns >= L are zeros.
// vec 4: 8-byte cp.async (L a multiple of 4); 2: 4-byte cp.async (L even);
// else element loads, two values a thread a step and kUnroll steps in flight
// (an odd L is latency-bound: each step is one round trip to memory).  The
// caller waits for the copies (copies_done).
template <int DP>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src, int L, int dh, int col0,
                                          int vec, int tid, int nthreads) {
  char* base = reinterpret_cast<char*>(dst);
  if (vec == 4) {
    for (int idx = tid; idx < DP * 16; idx += nthreads) {
      const int d = idx >> 4, c4 = idx & 15, col = col0 + 4 * c4;
      const bool ok = d < dh && col < L;  // L % 4 == 0: a chunk is all in or all out
      cp_async8(base + swz(d, 8 * c4), ok ? src + (int64_t)d * L + col : src, ok ? 8 : 0);
    }
  } else if (vec == 2) {
    for (int idx = tid; idx < DP * 32; idx += nthreads) {
      const int d = idx >> 5, c2 = idx & 31, col = col0 + 2 * c2;
      const bool ok = d < dh && col < L;  // L even: a pair is all in or all out
      controlnet_mma::cp_async4(base + swz(d, 4 * c2), ok ? src + (int64_t)d * L + col : src,
                                ok ? 4 : 0);
    }
  } else {
    constexpr int kUnroll = 16;
    const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
    for (int i0 = tid; i0 < DP * 32; i0 += kUnroll * nthreads) {
      uint32_t w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int idx = i0 + u * nthreads, d = idx >> 5, col = col0 + 2 * (idx & 31);
        uint32_t lo = 0, hi = 0;
        if (idx < DP * 32 && d < dh) {
          const int64_t at = (int64_t)d * L + col;
          if (col < L) lo = s16[at];
          if (col + 1 < L) hi = s16[at + 1];
        }
        w[u] = lo | (hi << 16);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int idx = i0 + u * nthreads;
        if (idx < DP * 32) {
          *reinterpret_cast<uint32_t*>(base + swz(idx >> 5, 4 * (idx & 31))) = w[u];
        }
      }
    }
  }
}

// The staged route for an odd L (vec 1) of at most kStagedMaxL, taken by the
// producer warp for its streamed tiles, two at a time (K and V, or Q and
// dO): the span of each panel that holds the tile's rows, copied whole by
// 4-byte cp.async into its half of the linear buffer `stg` (stage_bytes(DP)
// bytes; a span is aligned down to 4 bytes, its last word may hold one
// value), one wait for both, then each laid out into its swizzled tile from
// shared memory.  One round trip to memory a stage where element loads take
// DP / 4.
constexpr int kStagedMaxL = 128;
__host__ __device__ constexpr int span_bytes(int dp) { return 2 * dp * kRowBytes + 16; }
__host__ __device__ constexpr int stage_bytes(int dp) { return 2 * span_bytes(dp); }

// The span of rows [0, dh) x columns [col0, col0 + 64) of the panel at src,
// by 4-byte cp.async into stg; returns the byte offset of (0, col0) in stg.
__device__ __forceinline__ int stage_span(char* stg, const bf16* src, int L, int dh, int col0,
                                          int lane) {
  const uintptr_t first = reinterpret_cast<uintptr_t>(src + col0);
  const uintptr_t end =
      reinterpret_cast<uintptr_t>(src + (int64_t)(dh - 1) * L + min(col0 + kTile, L));
  const uintptr_t a0 = first & ~static_cast<uintptr_t>(3);
  const int words = (int)((end - a0 + 3) >> 2);
  for (int w = lane; w < words; w += 32) {
    const uintptr_t from = a0 + 4 * (uintptr_t)w, left = end - from;
    controlnet_mma::cp_async4(stg + 4 * w, reinterpret_cast<const void*>(from),
                              left < 4 ? (int)left : 4);
  }
  return (int)(first - a0);
}

// A staged span laid out into the swizzled tile at dst (rows >= dh, columns
// >= L zero).
template <int DP>
__device__ __forceinline__ void layout_span(bf16* dst, const char* stg, int shift, int L, int dh,
                                            int col0, int lane) {
  char* base = reinterpret_cast<char*>(dst);
  for (int idx = lane; idx < DP * 32; idx += 32) {
    const int d = idx >> 5, c = 2 * (idx & 31), col = col0 + c;
    uint32_t lo = 0, hi = 0;
    if (d < dh) {
      const char* at = stg + shift + 2 * ((int64_t)d * L + c);
      if (col < L) lo = *reinterpret_cast<const unsigned short*>(at);
      if (col + 1 < L) hi = *reinterpret_cast<const unsigned short*>(at + 2);
    }
    *reinterpret_cast<uint32_t*>(base + swz(d, 2 * c)) = lo | (hi << 16);
  }
}

// The producer warp's copy of the two streamed tiles of a stage (the same
// columns of two panels of length L): staged where L is odd and at most
// kStagedMaxL, else copy_tile.  The caller waits (copies_done).
template <int DP>
__device__ __forceinline__ void producer_copy(bf16* dst0, bf16* dst1, char* stg, const bf16* src0,
                                              const bf16* src1, int L, int dh, int col0, int vec,
                                              int lane) {
  if (vec == 1 && L <= kStagedMaxL) {
    const int s0 = stage_span(stg, src0, L, dh, col0, lane);
    const int s1 = stage_span(stg + span_bytes(DP), src1, L, dh, col0, lane);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    layout_span<DP>(dst0, stg, s0, L, dh, col0, lane);
    layout_span<DP>(dst1, stg + span_bytes(DP), s1, L, dh, col0, lane);
    __syncwarp();  // the buffer is free for the next stage
  } else {
    copy_tile<DP>(dst0, src0, L, dh, col0, vec, lane, 32);
    copy_tile<DP>(dst1, src1, L, dh, col0, vec, lane, 32);
  }
}

// Whether the producer stages a panel group of length L at `vec`.
__host__ __device__ constexpr bool staged(int L, int vec) { return vec == 1 && L <= kStagedMaxL; }

// After copy_tile: this thread's copies have landed and are visible to wgmma.
__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  fence_proxy_async();
}

// Add `bytes` of float32 from shared memory at src to global memory at dst
// (both 16-byte aligned, a multiple of 16 bytes) in the L2, asynchronously;
// one thread starts it.  commit / wait as for any bulk copy.
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, const void* src, int bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// The starting thread's bulk operations have read their sources (their
// shared memory may be written again).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// --- wgmma -------------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Wait until at most N of this warpgroup's committed product groups are
// still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
  }
}

// The shared-memory matrix descriptor of a swizzled tile at p (128-byte
// swizzle mode): start address, leading and stride byte offsets, all in
// 16-byte units.  The 8-row groups of a tile are 1024 bytes apart.  An
// MN-major tile here is one swizzle atom wide (64 values), so both offsets are
// set to 1024 and neither reading of them reaches a second atom; for a K-major
// tile the leading offset is unused by the swizzled mode (1, as CUTLASS sets).
__device__ __forceinline__ uint64_t desc_mn(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_k(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 16) += a (64 x 16, registers) b (16 x 16, K-major in shared memory).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[2][4], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 32) += a (64 x 16, registers) b (32 x 16, K-major in shared memory).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[4][4], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 48) += a (64 x 16, registers) b (48 x 16, K-major in shared memory).
__device__ __forceinline__ void wgmma_rs_n48(float (&d)[6][4], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64) += a (64 x 16, registers) b (64 x 16, K-major in shared memory).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 96) += a (64 x 16, registers) b (96 x 16, K-major in shared memory).
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[12][4], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128) += a (64 x 16, registers) b (128 x 16, K-major in shared memory).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// d (64 x 16) = [d +] a b, a in shared memory (MN-major with TA 1, K-major with
// TA 0), b in shared memory (N-major with TB 1, K-major with TB 0); scale_d 0
// overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[2][4], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, %11, %12;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 32) = [d +] a b, a in shared memory (MN-major with TA 1, K-major with
// TA 0), b in shared memory (N-major with TB 1, K-major with TB 0); scale_d 0
// overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 48) = [d +] a b, a in shared memory (MN-major with TA 1, K-major with
// TA 0), b in shared memory (N-major with TB 1, K-major with TB 0); scale_d 0
// overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n48(float (&d)[6][4], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, %27, %28;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 64) = [d +] a b, a in shared memory (MN-major with TA 1, K-major with
// TA 0), b in shared memory (N-major with TB 1, K-major with TB 0); scale_d 0
// overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 96) = [d +] a b, a in shared memory (MN-major with TA 1, K-major with
// TA 0), b in shared memory (N-major with TB 1, K-major with TB 0); scale_d 0
// overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n96(float (&d)[12][4], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, %51, %52;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 128) = [d +] a b, a in shared memory (MN-major with TA 1, K-major with
// TA 0), b in shared memory (N-major with TB 1, K-major with TB 0); scale_d 0
// overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}


// d (64 x N) = [d +] a b over one K step, both from shared memory (a
// MN-major with TA 1, K-major with TA 0; b N-major with TB 1, K-major with
// TB 0).
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t a, uint64_t b,
                                         int scale_d) {
  if constexpr (N == 16) wgmma_ss_n16<TA, TB>(d, a, b, scale_d);
  else if constexpr (N == 32) wgmma_ss_n32<TA, TB>(d, a, b, scale_d);
  else if constexpr (N == 48) wgmma_ss_n48<TA, TB>(d, a, b, scale_d);
  else if constexpr (N == 64) wgmma_ss_n64<TA, TB>(d, a, b, scale_d);
  else if constexpr (N == 96) wgmma_ss_n96<TA, TB>(d, a, b, scale_d);
  else wgmma_ss_n128<TA, TB>(d, a, b, scale_d);
}

// d (64 x DP) += a (64 x 16 from registers) times K step `ks` (16 L values) of
// the K-major tile at b.
template <int DP>
__device__ __forceinline__ void wgmma_rs(float (&d)[DP / 8][4], const uint32_t (&a)[4],
                                         const bf16* b, int ks) {
  const uint64_t desc = desc_k(b) + (uint64_t)(2 * ks);  // 32 bytes a K step
  if constexpr (DP == 16) wgmma_rs_n16(d, a, desc);
  else if constexpr (DP == 32) wgmma_rs_n32(d, a, desc);
  else if constexpr (DP == 48) wgmma_rs_n48(d, a, desc);
  else if constexpr (DP == 64) wgmma_rs_n64(d, a, desc);
  else if constexpr (DP == 96) wgmma_rs_n96(d, a, desc);
  else wgmma_rs_n128(d, a, desc);
}

// s (64 x 64) = a^T b over DP head dims: a and b are (DP, 64) tiles (MN-major
// operands), e.g. S = Q^T K.  Started, not waited for.
template <int DP>
__device__ __forceinline__ void wgmma_scores(float (&s)[8][4], const bf16* a, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    wgmma_ss<64, 1, 1>(s, desc_mn(a + kk * 16 * kTile), desc_mn(b + kk * 16 * kTile), kk > 0);
  }
}

// p (64 x 64 float32, keys or queries as the columns) into bf16 A operands
// hi and lo of the four K steps (p = hi + lo to ~2^-17).
__device__ __forceinline__ void split_hi_lo(const float (&p)[8][4], uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const float* p0 = p[2 * ks];
    const float* p1 = p[2 * ks + 1];
    const float r[8] = {p0[0], p0[1], p0[2], p0[3], p1[0], p1[1], p1[2], p1[3]};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      hi[ks][q] = controlnet_mma::pack_bf16(r[2 * q], r[2 * q + 1]);
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi[ks][q]);
      lo[ks][q] = controlnet_mma::pack_bf16(r[2 * q] - __low2float(h),
                                            r[2 * q + 1] - __high2float(h));
    }
  }
}

// acc (64 x DP) += (hi + lo) b over the 64 L values of the K-major tile b.
// Started, not waited for.
template <int DP>
__device__ __forceinline__ void wgmma_split(float (&acc)[DP / 8][4], const uint32_t (&hi)[4][4],
                                            const uint32_t (&lo)[4][4], const bf16* b) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    wgmma_rs<DP>(acc, hi[ks], b, ks);
    wgmma_rs<DP>(acc, lo[ks], b, ks);
  }
}

// A warpgroup's 64 x N float32 accumulator as bf16 into the (N, 64) swizzled
// tile at st, column n as row n (so N = DP is a (DP, 64) operand tile, and N =
// k DP is k of them one after another): element (row, n) becomes f(n, value).
// The caller brackets it with named barriers (the tile must be free).
template <int N, class F>
__device__ __forceinline__ void stage_columns(const float (&acc)[N / 8][4], bf16* st,
                                              const F& f) {
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x & 127) >> 5;
  const int g = lane >> 2, t = lane & 3;
  char* base = reinterpret_cast<char*>(st);
#pragma unroll
  for (int dt = 0; dt < N / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = dt * 8 + 2 * t + (e & 1), row = w4 * 16 + g + 8 * (e >> 1);
      *reinterpret_cast<bf16*>(base + swz(n, 2 * row)) = __float2bfloat16(f(n, acc[dt][e]));
    }
  }
}

// Stage a warpgroup's 64 x DP accumulator, times `mul`, as bf16 into the
// (DP, 64) swizzled tile st (head dim d as the row), then store rows d < dh of
// it to columns [col0, col0 + 64) of the (dh, L) panel dst, coalesced.  Named
// barrier `bar` (1..15) brackets the staging; the tile must be free.
template <int DP>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 8][4], float mul, bf16* st,
                                           bf16* dst, int dh, int L, int col0, int bar) {
  const int wtid = threadIdx.x & 127;
  const char* base = reinterpret_cast<const char*>(st);
  named_sync(bar, 128);
  stage_columns<DP>(acc, st, [mul](int, float v) { return v * mul; });
  named_sync(bar, 128);
  for (int idx = wtid; idx < dh * kTile; idx += 128) {
    const int d = idx >> 6, c = idx & 63;
    if (col0 + c < L) {
      dst[(int64_t)d * L + col0 + c] = *reinterpret_cast<const bf16*>(base + swz(d, 2 * c));
    }
  }
}

// Keys outside [lo[r], hi[r]) of row r (this thread's rows g and g + 8) out of
// the scores s of 64 keys from key0 (-inf, which online_softmax turns into a
// zero probability).
__device__ __forceinline__ void mask_keys(float (&s)[8][4], int key0, const int (&lo)[2],
                                          const int (&hi)[2], int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + nt * 8 + 2 * t + (e & 1), r = e >> 1;
      if (key < lo[r] || key >= hi[r]) s[nt][e] = -CUDART_INF_F;
    }
  }
}

// --- timing ------------------------------------------------------------------------------

// Thread 0's clock64() cycles by phase, added to `counters` (phases, then
// the block count) at the end; off (null) it costs one test a mark.
template <int N>
struct PhaseClock {
  unsigned long long* counters;
  long long last = 0;
  unsigned long long spent[N] = {};
  __device__ __forceinline__ explicit PhaseClock(unsigned long long* c) : counters(c) {
    if (counters) last = clock64();
  }
  __device__ __forceinline__ void mark(int phase) {
    if (counters) {
      const long long now = clock64();
      spent[phase] += now - last;
      last = now;
    }
  }
  __device__ __forceinline__ void flush() {
    if (counters) {
#pragma unroll
      for (int p = 0; p < N; ++p) atomicAdd(counters + p, spent[p]);
      atomicAdd(counters + N, 1ull);
    }
  }
};

// --- host: tensor maps -------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the CUDA runtime has loaded
// (looked up once; the library is linked without -lcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A `rank`-D tensor map of bf16 values at p (dims innermost first, strides of
// dims 1.. in bytes, boxes of `box`): 128-byte swizzle (the innermost box is
// 64 values), zeros outside.  Returns false where TMA cannot describe it.
inline bool tiled_map(CUtensorMap* map, const void* p, int rank, const cuuint64_t* dims,
                      const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(p),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of the (batch, heads, dh, L) bf16 panels at p, batches
// `bstride` values apart: boxes of 64 L values by dp head dims, swizzled
// 128 bytes, zeros outside.  Returns false where TMA cannot describe them.
inline bool panel_map(CUtensorMap* map, const void* p, int batch, int heads, int dh, int L,
                      long long bstride, int dp) {
  const cuuint64_t dims[4] = {(cuuint64_t)L, (cuuint64_t)dh, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)L * 2, (cuuint64_t)dh * L * 2,
                                 (cuuint64_t)bstride * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kTile, (cuuint32_t)dp, 1, 1};
  return tiled_map(map, p, 4, dims, strides, box);
}

// Dynamic shared memory above 48 KB needs the kernel's attribute raised.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48u * 1024u) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace controlnet_hopper
