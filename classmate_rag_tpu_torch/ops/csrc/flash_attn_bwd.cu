// Backward of the non-causal flash attention with a key-padding mask
// (flash_attn.cu), for Hopper (sm_90a): one fused kernel for dK, dV and
// dQ, and a small kernel before it for D.
//
// Replaces the backward of the TPU library kernel jax.experimental.pallas.
// ops.tpu.flash_attention (jax 0.9.0), which the JAX package reaches when
// contrastive.py:155 takes the gradient of the encoder with its flash
// gate open. flash_attn_bwd_kernel is the counterpart of both of its
// kernels:
//   _flash_attention_bwd_dkv (flash_attention.py:941, pallas_call :1121)
//   _flash_attention_bwd_dq  (flash_attention.py:1287, pallas_call :1456)
// and flash_attn_bwd_delta_kernel of the XLA sum that computes D outside
// them (_flash_attention_bwd, flash_attention.py:273).
// Both recompute the probabilities from the forward's log-sum-exp:
//   x[q, k]  = (Q[q] . K[k]) * sm_scale * log2(e) + bias[k]
//   P[q, k]  = 2^(x[q, k] - lse[q])             (lse in base 2)
//   dP       = dO V^T
//   dS       = P o (dP - D[q]),   D[q] = sum_d O[q, d] dO[q, d]
//   dV = P^T dO,  dK = dS^T Q * sm_scale,  dQ = dS K * sm_scale
// bias is the forward's: 0 for a real key, NEG_INF (f32 min, added) for
// a pad key, -inf past T.
//
// Masking follows the port's forward, not the TPU kernel's segment ids.
// A pad key gets P = 0 in every row of a batch row that has a real key,
// so its dK and dV are exactly 0: a block of 128 keys with no real key
// in such a row is skipped (its dK and dV written as zeros, no loads).
// A batch row with no real key is a uniform softmax over its T keys in
// the forward (every logit is NEG_INF); here P = 1/T there, as the plain
// version's autograd gives. Pad query rows are ordinary rows; the
// encoder's pooling drops them, so their dO is 0, and then dQ, dK and dV
// on real tokens equal the segment-id version's.
//
// What bounds it on an H100: five products of 64 x 64 x 128 for each
// (64-query tile, 128-key block) pair (S^T, dP^T, dV, dK, dQ); bytes are
// q, k, v and dO read and dq, dk, dv written once, with the LSE, D and
// the mask. At head_dim 64 the bytes bound it at T 128 (~2x the tensor
// cores' time) and the products at T 512. The design (FlashAttention-3's
// backward, cut to head_dim 64, no causal mask):
//
// - Work item = (128-key block, head, batch row) on a persistent grid of
//   one CTA an SM: two consumer warpgroups of 64 keys each and a producer
//   warpgroup, 384 threads at 168 registers a thread. The consumers' live
//   set (four 64 x 64 f32 accumulators: dK, dV, S^T, dP^T; then P and dS
//   as bf16 pairs, and dQ) fits that; setmaxnreg moves the producer
//   warpgroup's spare registers (it keeps 80) to the consumers (208). The
//   ptxas report (ops/build/flash_attn_bwd-*.log) shows the count and
//   the spills, which must stay 0. Items of one (batch row, head) are
//   adjacent, so CTAs running side by side share its Q and dO in L2.
// - The producer's first warp loads K and V once an item (TMA, 3-D maps
//   over the strided [B, T, heads*64] views, 128-byte swizzle) into one
//   of two item buffers, so it runs into the next item while the
//   consumers finish this one, and streams Q and dO in 64-row tiles
//   through a ring of STAGES stages, each with its 64 LSE and 64 D values
//   (plain loads, 0 past T). TMA fills rows past T with zeros.
// - Each consumer warpgroup keeps dK and dV (64 keys x 64) in registers
//   for the whole item and for every query tile computes, all with wgmma
//   m64n64k16:
//     S^T  = K Q^T and dP^T = V dO^T    (both operands K-major, smem);
//     P^T and dS^T in f32 registers;
//     dV += P^T dO and dK += dS^T Q     (A from registers, the
//                                        accumulator's own layout; B
//                                        MN-major with the transpose bit).
//   Registers only: no shared-memory round trip for S, dP, P or dS.
// - dQ = dS K needs all 128 keys: each warpgroup writes its dS^T rows as
//   bf16 into a 128-byte-swizzled tile (two tiles, alternating), a named
//   barrier joins the two, and one warpgroup (alternating by tile, so the
//   work evens out) runs the 8 k-steps with both operands MN-major from
//   shared memory while the other goes on to the next tile's products.
// - Every result leaves through shared memory and TMA, never as scattered
//   stores from the accumulators: each warpgroup stages a tile (swizzled,
//   no bank conflicts) and one thread issues the copy, which runs while
//   the warpgroup goes on. dK and dV at the item's end; dQ * sm_scale
//   after each tile, stored as bf16 where one block holds every key (T <=
//   128, the training shape), else added in f32 into a workspace
//   [B, T, heads, 64]. That addition is a finalizer warp's (one a
//   consumer warpgroup, in the producer warpgroup): it issues TMA's
//   reduce-add from the staged tile, frees the tile as soon as TMA has
//   read it, waits for the sums to land, and counts the tile's key
//   blocks; the warp that counts the last one loads the 64-row tile
//   (TMA), converts it to bf16 in shared memory and stores it (TMA). So
//   neither the additions' latency nor the conversion stands in the
//   consumers' way. The counters [B, heads, T/64] are zeroed with the
//   workspace by the D kernel and reset by the warp that converts.
//
// The D kernel reads O and dO once in bf16 and writes D f32 [B, heads, T]
// (a tile's 64 values contiguous), and zeroes the workspace and counters
// when the fused kernel needs them.

#include "hopper.cuh"  // mbarriers, TMA, wgmma, the tensor-map encoder

namespace {

constexpr int D = 64;          // head_dim: one 128-byte swizzled row
constexpr int BK = 128;        // keys an item: 2 warpgroups x 64
constexpr int BQ = 64;         // query rows a tile
constexpr int STAGES = 3;      // Q/dO ring depth
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 128;      // + the producer warpgroup
constexpr int KV_BYTES = BK * D * 2;          // 16 KB each of K and V
constexpr int ITEM_BYTES = 2 * KV_BYTES;
constexpr int TILE_BYTES = BQ * D * 2;        // 8 KB each of Q and dO
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
constexpr int DS_BYTES = BK * BQ * 2;         // dS^T of a tile, bf16
constexpr int OUT_BYTES = 2 * TILE_BYTES;     // a warpgroup's store tiles
constexpr int RING_OFFSET = 2 * ITEM_BYTES;
constexpr int DS_OFFSET = RING_OFFSET + STAGES * STAGE_BYTES;
constexpr int OUT_OFFSET = DS_OFFSET + 2 * DS_BYTES;
constexpr int CONV_BYTES = 2 * TILE_BYTES;    // a finalizer's f32 dQ tile
constexpr int CONV_OFFSET = OUT_OFFSET + 2 * OUT_BYTES;
constexpr int ROWV_OFFSET = CONV_OFFSET + 2 * CONV_BYTES;  // lse, D a stage
constexpr int INFO_OFFSET = ROWV_OFFSET + STAGES * 2 * BQ * 4;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float NEG_INF_F = -3.4028234663852886e38f;  // f32 min
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BAR_CONSUMERS = 1;  // named barriers: both warpgroups,
constexpr int BAR_WG = 2;         // and warpgroup wg alone (BAR_WG + wg)

// What the producer tells the consumers about an item: whether its key
// block is skipped (no loads; dK = dV = 0) and whether its batch row has
// no real key (P = 1/T), and the bias of its 128 keys: the mask's, or
// -log2(T) on every key of a row with no real key (-inf past T either
// way).
constexpr int ITEM_SKIP = 1;
constexpr int ITEM_UNIFORM = 2;

struct ItemInfo {
  int flags;
  int pad[3];
  float bias[BK];
};

// What a consumer warpgroup hands its finalizer warp with its store tile:
// {b, h, qt, kind}.
constexpr int JOB_TILE = 0;  // add the tile's f32 dQ into the workspace
constexpr int JOB_SKIP = 1;  // a skipped key block: every tile of (b, h)
constexpr int JOB_END = 2;   // no more work
constexpr int JOB_OFFSET = INFO_OFFSET + 2 * (int)sizeof(ItemInfo);
constexpr int BAR_OFFSET = JOB_OFFSET + 2 * 16;
constexpr int SMEM_BYTES =
    BAR_OFFSET + (2 * STAGES + 10) * 8 + 1024;  // + slack to align

struct Item {
  int b, h, kb;
};

__device__ __forceinline__ Item decode(int item, int heads, int n_kb) {
  const int bh = item / n_kb;
  return Item{bh / heads, bh % heads, item % n_kb};
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x, which the compiler may not assume it knows: what is computed from it
// is computed where it is used, and holds no register in between.
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(BAR_CONSUMERS), "n"(CONSUMERS)
               : "memory");
}

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(BAR_WG + wg), "n"(128)
               : "memory");
}

// An accumulator (rows 16 wl + g + 8i of the warpgroup's 64, columns
// 8j + t2 + e at acc[4j + 2i + e]) times ``scale`` as bf16 into a 64-row
// tile of 128-byte rows, 16-byte chunk j of row r at chunk j ^ (r % 8):
// the layout a 128-byte-swizzle TMA store reads.
__device__ __forceinline__ void stage_bf16(unsigned char* tile,
                                           const float (&acc)[32],
                                           float scale, int wl, int g,
                                           int t2) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * wl + g + 8 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(tile + r * 128 + ((j ^ (r & 7)) << 4) +
                                   2 * t2) =
          pack_bf16(acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
    }
  }
}

// The same in f32: two tiles of 32 columns (8 KB each), 128-byte rows
// of 8 chunks of 4 floats, swizzled the same way.
__device__ __forceinline__ void stage_f32(unsigned char* tile,
                                          const float (&acc)[32], float scale,
                                          int wl, int g, int t2) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * wl + g + 8 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 2 * (j & 3) + (t2 >> 2);  // chunk in the half's row
      *reinterpret_cast<float2*>(tile + (j >> 2) * (BQ * 128) + r * 128 +
                                 ((c ^ (r & 7)) << 4) + (t2 & 3) * 4) =
          make_float2(acc[4 * j + 2 * i] * scale,
                      acc[4 * j + 2 * i + 1] * scale);
    }
  }
}

// The lead thread of a consumer warpgroup, before the warpgroup writes its
// store tile: the finalizer is done with the last job's tile (``posted``
// jobs handed over so far) and the lead's own TMA stores have read it.
__device__ __forceinline__ void tile_free(uint64_t* stage_empty, int posted) {
  if (posted > 0) mbar_wait(stage_empty, (posted - 1) & 1);
  bulk_wait_read<0>();
}

// The lead hands its finalizer a job (and the store tile with it), once
// tile_free has returned; returns the jobs posted so far. (Counts go by
// value, in and out: a reference would give them an address, and a place
// in local memory.)
__device__ __forceinline__ int post_job(uint64_t* stage_full, int4* job,
                                        int posted, int4 value) {
  *job = value;
  mbar_arrive(stage_full);
  return posted + 1;
}

// A consumer warpgroup's dQ tile qt (acc_q, unscaled) through its store
// tile: stored as bf16 * sm_scale where one block holds every key, else
// staged in f32 for the finalizer to add into the workspace. Returns the
// jobs posted so far.
__device__ __forceinline__ int store_dq(
    const float (&acc_q)[32], unsigned char* out_wg, const CUtensorMap* dq_map,
    bool to_ws, float sm_scale, int b, int h, int qt, int wg, int wl, int g,
    int t2, bool lead, uint64_t* stage_full, uint64_t* stage_empty, int4* job,
    int posted) {
  if (lead) tile_free(stage_empty, posted);
  warpgroup_sync(wg);
  if (to_ws) {
    stage_f32(out_wg, acc_q, sm_scale, wl, g, t2);
  } else {
    stage_bf16(out_wg, acc_q, sm_scale, wl, g, t2);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  warpgroup_sync(wg);
  if (lead) {
    if (to_ws) {
      return post_job(stage_full, job, posted, make_int4(b, h, qt, JOB_TILE));
    }
    tma_store_3d(dq_map, out_wg, h * D, qt * BQ, b);
    bulk_commit();
  }
  return posted;
}

// A finalizer warp: one key block's share of dQ tile qt of (b, h) is in
// the workspace. The warp that brings the tile's count to n_kb loads it
// (TMA, f32) into ``conv``, converts it to bf16 in place, stores it into
// dq (TMA), and resets the count for another launch on the same
// workspace. ``n_conv`` counts the conversions so far (conv_full's
// phases); returns the new count.
__device__ __forceinline__ int finish_tile(
    int* __restrict__ count, unsigned char* conv, uint64_t* conv_full,
    const CUtensorMap* ws_map, const CUtensorMap* dq_map, int b, int h, int qt,
    int heads, int n_kb, int n_qt, int lane, int n_conv) {
  int* cnt = count + ((size_t)b * heads + h) * n_qt + qt;
  int last = 0;
  if (lane == 0) last = atomicAdd(cnt, 1) == n_kb - 1;
  if (!__shfl_sync(FULL_MASK, last, 0)) return n_conv;
  if (lane == 0) {
    *cnt = 0;
    __threadfence();
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    bulk_wait_read<0>();  // the last tile's store has read conv
    mbar_expect_tx(conv_full, CONV_BYTES);
    tma_load_3d(conv, ws_map, conv_full, h * D, qt * BQ, b);
    tma_load_3d(conv + BQ * 128, ws_map, conv_full, h * D + 32, qt * BQ, b);
  }
  mbar_wait(conv_full, n_conv & 1);
  // 8 rows at a time: f32 row r (chunk c of 4 floats in half c / 8 at
  // half * 8 KB + r * 128 + ((c % 8) ^ (r % 8)) * 16) into bf16 row r
  // (chunk j of 8 at r * 128 + (j ^ (r % 8)) * 16), which overwrites only
  // f32 half 0 of the same row, read just before.
#pragma unroll 1
  for (int r8 = 0; r8 < BQ; r8 += 8) {
    const int r = r8 + (lane >> 2);
    uint4 packed[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 2 * (lane & 3) + e;
      const unsigned char* half = conv + (j >> 2) * (BQ * 128) + r * 128;
      const float4 a = *reinterpret_cast<const float4*>(
          half + (((2 * (j & 3)) ^ (r & 7)) << 4));
      const float4 c = *reinterpret_cast<const float4*>(
          half + (((2 * (j & 3) + 1) ^ (r & 7)) << 4));
      packed[e] = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                             pack_bf16(c.x, c.y), pack_bf16(c.z, c.w));
    }
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 2 * (lane & 3) + e;
      *reinterpret_cast<uint4*>(conv + r * 128 + ((j ^ (r & 7)) << 4)) =
          packed[e];
    }
    __syncwarp();
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) {
    tma_store_3d(dq_map, conv, h * D, qt * BQ, b);
    bulk_commit();
  }
  return n_conv + 1;
}

__global__ void __launch_bounds__(THREADS, 1)
    flash_attn_bwd_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const __grid_constant__ CUtensorMap dq_map,
                          const __grid_constant__ CUtensorMap dk_map,
                          const __grid_constant__ CUtensorMap dv_map,
                          const __grid_constant__ CUtensorMap ws_map,
                          const int* __restrict__ mask,    // [B, T]
                          const float* __restrict__ lse,   // [B, heads, T]
                          const float* __restrict__ delta, // [B, heads, T]
                          const float* __restrict__ ws,    // or null (ws_map)
                          int* __restrict__ count,         // [B, heads, n_qt]
                          __nv_bfloat16* __restrict__ dq, int T, int heads,
                          int n_kb, int n_qt, int n_items,
                          long long stride_out, float sm_scale,
                          float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned (the swizzle's period), by an offset from smem_raw
  // rather than integer arithmetic on its address: the compiler then
  // knows every pointer below is shared memory, and keeps 32-bit
  // addresses for them.
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* kv = smem;                   // 2 items x (K, V)
  unsigned char* ring = smem + RING_OFFSET;   // STAGES x (Q, dO)
  unsigned char* ds_buf = smem + DS_OFFSET;   // 2 x dS^T
  float* rowv = reinterpret_cast<float*>(smem + ROWV_OFFSET);
  ItemInfo* info = reinterpret_cast<ItemInfo*>(smem + INFO_OFFSET);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFFSET);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_full = empty + STAGES;
  uint64_t* kv_empty = kv_full + 2;
  uint64_t* stage_full = kv_empty + 2;   // a warpgroup's store tile and job
  uint64_t* stage_empty = stage_full + 2;
  uint64_t* conv_full = stage_empty + 2;  // a finalizer's workspace tile
  int4* jobs = reinterpret_cast<int4*>(smem + JOB_OFFSET);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);  // every consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], CONSUMERS / 32);
      mbar_init(&stage_full[s], 1);
      mbar_init(&stage_empty[s], 1);
      mbar_init(&conv_full[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    // ---- producer warpgroup: its registers go to the consumers; its
    // first warp loads an item's mask, K and V, then its Q/dO tiles; with
    // a workspace, warps 1 and 2 finalize warpgroup 0's and 1's dQ tiles.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 80;\n" ::: "memory");
    const int pw = warp - CONSUMERS / 32;
    if (pw == 1 || pw == 2) {
      if (ws == nullptr) return;
      const int fw = pw - 1;
      const unsigned char* stage = smem + OUT_OFFSET + fw * OUT_BYTES;
      unsigned char* conv = smem + CONV_OFFSET + fw * CONV_BYTES;
      int n_conv = 0;
      for (int k = 0;; ++k) {
        mbar_wait(&stage_full[fw], k & 1);
        const int4 job = jobs[fw];  // {b, h, qt, kind}
        if (job.w == JOB_END) break;
        // A skipped key block adds nothing, to every tile of (b, h).
        const bool skip = job.w == JOB_SKIP;
        if (skip) {
          if (lane == 0) mbar_arrive(&stage_empty[fw]);
        } else if (lane == 0) {
          tma_reduce_add_3d(&ws_map, stage, job.y * D, job.z * BQ, job.x);
          tma_reduce_add_3d(&ws_map, stage + BQ * 128, job.y * D + 32,
                            job.z * BQ, job.x);
          bulk_commit();
          bulk_wait_read<0>();
          mbar_arrive(&stage_empty[fw]);  // the tile may be written again
          bulk_wait<0>();                 // the additions are in memory
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
          __threadfence();
        }
        __syncwarp();
        for (int qt = skip ? 0 : job.z; qt < (skip ? n_qt : job.z + 1); ++qt) {
          n_conv = finish_tile(count, conv, &conv_full[fw], &ws_map, &dq_map,
                               job.x, job.y, qt, heads, n_kb, n_qt, lane,
                               n_conv);
        }
      }
      if (lane == 0) bulk_wait<0>();
      return;
    }
    if (pw != 0) return;
    int it = 0;
    int n = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
      const Item w = decode(item, heads, n_kb);
      const int* mrow = mask + (size_t)w.b * T;
      float bias[4];
      int blk = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int key = w.kb * BK + 32 * u + lane;
        const int m = key < T ? __ldg(mrow + key) : 0;
        bias[u] = key < T ? (m != 0 ? 0.0f : NEG_INF_F) : -INFINITY;
        blk |= m;
      }
      bool row_has_key = __any_sync(FULL_MASK, blk != 0);
      bool skip = false;
      if (!row_has_key) {  // no real key here: has the batch row one?
        int any = 0;       // loads in flight together: no early exit
#pragma unroll 4
        for (int t = lane; t < T; t += 32) any |= __ldg(mrow + t);
        row_has_key = __any_sync(FULL_MASK, any != 0);
        skip = row_has_key;
      }
      if (!row_has_key) {
        // P = 1/T on the T keys: with the scale 0 (the consumers' part),
        // 2^(bias - lse) with bias -log2(T) and lse 0.
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (bias[u] != -INFINITY) bias[u] = -log2f((float)T);
        }
      }
      const int slot = n & 1;
      mbar_wait(&kv_empty[slot], ((n >> 1) & 1) ^ 1);
#pragma unroll
      for (int u = 0; u < 4; ++u) info[slot].bias[32 * u + lane] = bias[u];
      if (lane == 0) {
        info[slot].flags =
            (skip ? ITEM_SKIP : 0) | (row_has_key ? 0 : ITEM_UNIFORM);
      }
      __syncwarp();  // the warp's writes, then lane 0's release
      if (lane == 0) {
        if (skip) {
          mbar_arrive(&kv_full[slot]);
        } else {
          unsigned char* dst = kv + slot * ITEM_BYTES;
          mbar_expect_tx(&kv_full[slot], ITEM_BYTES);
          tma_load_3d(dst, &k_map, &kv_full[slot], w.h * D, w.kb * BK, w.b);
          tma_load_3d(dst + KV_BYTES, &v_map, &kv_full[slot], w.h * D,
                      w.kb * BK, w.b);
        }
      }
      if (skip) continue;
      const size_t rv = ((size_t)w.b * heads + w.h) * T;
      for (int qt = 0; qt < n_qt; ++qt, ++it) {
        const int r0 = qt * BQ + lane;
        // lse 0 past T, and for a row with no real key (its bias above).
        const float l0 = row_has_key && r0 < T ? __ldg(lse + rv + r0) : 0.0f;
        const float l1 =
            row_has_key && r0 + 32 < T ? __ldg(lse + rv + r0 + 32) : 0.0f;
        const float d0 = r0 < T ? __ldg(delta + rv + r0) : 0.0f;
        const float d1 = r0 + 32 < T ? __ldg(delta + rv + r0 + 32) : 0.0f;
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        float* rs = rowv + s * 2 * BQ;
        rs[lane] = l0;
        rs[lane + 32] = l1;
        rs[BQ + lane] = d0;
        rs[BQ + lane + 32] = d1;
        __syncwarp();
        if (lane == 0) {
          unsigned char* dst = ring + s * STAGE_BYTES;
          mbar_expect_tx(&full[s], STAGE_BYTES);
          tma_load_3d(dst, &q_map, &full[s], w.h * D, qt * BQ, w.b);
          tma_load_3d(dst + TILE_BYTES, &do_map, &full[s], w.h * D, qt * BQ,
                      w.b);
        }
      }
    }
    return;  // no block-wide barrier follows
  }

  // ---- consumers ---------------------------------------------------------
  // Warpgroup wg takes keys 64 wg .. 64 wg + 63 of the item's block; its
  // warp wl rows 16 wl .. 16 wl + 15 of them. In each m64n64 accumulator
  // (S^T, dP^T: keys x queries; dK, dV: keys x head dims; dQ: queries x
  // head dims) lane l holds rows 16 wl + l/4 (i = 0) and + 8 (i = 1),
  // columns 8j + 2(l % 4) + e, at acc[4j + 2i + e].
  asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n" ::: "memory");
  const int wg = warp >> 2;
  const int wl = warp & 3;
  const int g = lane >> 2;
  const int t2 = 2 * (lane & 3);
  const int kr = 64 * wg + 16 * wl + g;  // this thread's key rows: kr, kr + 8
  const bool lead = (tid & 127) == 0;     // issues the warpgroup's stores
  int posted = 0;  // jobs the lead handed the finalizer
  int it = 0;
  int n = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
    const Item w = decode(item, heads, n_kb);
    const int slot = n & 1;
    float acc_dv[32], acc_dk[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) acc_dv[x] = acc_dk[x] = 0.0f;

    mbar_wait(&kv_full[slot], (n >> 1) & 1);
    const int flags = info[slot].flags;
    if ((flags & ITEM_SKIP) && ws != nullptr && wg == 0 && lead) {
      // Its dQ share is 0: counted all the same.
      tile_free(&stage_empty[0], posted);
      posted = post_job(&stage_full[0], &jobs[0], posted,
                        make_int4(w.b, w.h, 0, JOB_SKIP));
    }
    if (!(flags & ITEM_SKIP)) {
      // A batch row with no real key: P = 2^(0 * s + bias - 0) = 1/T (the
      // producer's bias and lse for it).
      const float sc = (flags & ITEM_UNIFORM) ? 0.0f : scale_log2;
      float kbias[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) kbias[i] = info[slot].bias[kr + 8 * i];
      const unsigned char* sk = kv + slot * ITEM_BYTES;    // all 128 keys
      const unsigned char* sk_wg = sk + wg * (KV_BYTES / 2);
      const unsigned char* sv_wg = sk + KV_BYTES + wg * (KV_BYTES / 2);
      for (int qt = 0; qt < n_qt; ++qt, ++it) {
        const int s = it % STAGES;
        const bool owner = (it & 1) == wg;  // runs this tile's dQ
        unsigned char* sds = ds_buf + (it & 1) * DS_BYTES;
        const unsigned char* sq = ring + s * STAGE_BYTES;
        const unsigned char* sdo = sq + TILE_BYTES;
        mbar_wait(&full[s], (it / STAGES) & 1);

        // S^T = K Q^T and dP^T = V dO^T: 4 k-steps of 16 head dims each.
        float acc_s[32], acc_p[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_m64n64k16_ss(acc_s, desc_sw128(sk_wg + kk * 32),
                             desc_sw128(sq + kk * 32), kk);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_m64n64k16_ss(acc_p, desc_sw128(sv_wg + kk * 32),
                             desc_sw128(sdo + kk * 32), kk);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc_s);
        fence_regs(acc_p);

        // P^T = 2^(x - lse) and dS^T = P^T o (dP^T - D), as bf16 A
        // fragments (queries 16kk .. 16kk + 15 are columns j = 2kk, 2kk + 1,
        // i.e. acc[8kk .. 8kk + 7]).
        const float* lse_s = rowv + s * 2 * BQ;
        const float* d_s = lse_s + BQ;
        uint32_t pa[4][4], da[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(lse_s + 8 * j + t2);
          const float2 d2 = *reinterpret_cast<const float2*>(d_s + 8 * j + t2);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int x = 4 * j + 2 * i;
            const float p0 = ex2(fmaf(acc_s[x], sc, kbias[i]) - l2.x);
            const float p1 = ex2(fmaf(acc_s[x + 1], sc, kbias[i]) - l2.y);
            const float s0 = p0 * (acc_p[x] - d2.x);
            const float s1 = p1 * (acc_p[x + 1] - d2.y);
            pa[j >> 1][(j & 1) * 2 + i] = pack_bf16(p0, p1);
            da[j >> 1][(j & 1) * 2 + i] = pack_bf16(s0, s1);
          }
        }

        // dV += P^T dO, dK += dS^T Q: B MN-major, a k16 step 16 rows.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_m64n64k16_rs_tb(acc_dv, pa[kk], desc_sw128(sdo + kk * 2048), 1);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_m64n64k16_rs_tb(acc_dk, da[kk], desc_sw128(sq + kk * 2048), 1);
        }
        wgmma_commit();

        // dS^T rows kr, kr + 8 into the swizzled tile: row r, 16-byte
        // chunk j (queries 8j .. 8j + 7) at r * 128 + ((j ^ (r % 8)) * 16).
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = kr + 8 * i;
            *reinterpret_cast<uint32_t*>(sds + r * 128 + ((j ^ (r & 7)) << 4) +
                                         2 * t2) = da[j >> 1][(j & 1) * 2 + i];
          }
        }
        // Generic-proxy stores -> visible to wgmma's async-proxy reads.
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        consumers_sync();

        // dV and dK have read the stage and the A fragments.
        wgmma_wait<0>();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          fence_regs(pa[kk]);
          fence_regs(da[kk]);
        }
        fence_regs(acc_dv);
        fence_regs(acc_dk);
        if (lane == 0) mbar_arrive(&empty[s]);
        if (!owner) continue;
        // dQ = dS K over the block's 128 keys: 8 k-steps, dS^T and K both
        // MN-major (rows hold keys).
        float acc_q[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          wgmma_m64n64k16_ss_tt(acc_q, desc_sw128(sds + kk * 2048),
                                desc_sw128(sk + kk * 2048), kk);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc_q);
        posted = store_dq(acc_q, smem + OUT_OFFSET + opaque(wg) * OUT_BYTES,
                          &dq_map, ws != nullptr, sm_scale, w.b, w.h, qt, wg,
                          wl, g, t2, lead, &stage_full[wg], &stage_empty[wg],
                          &jobs[wg], posted);
      }
    }
    // Every product that read this item's K and V has retired.
    if (lane == 0) mbar_arrive(&kv_empty[slot]);

    // dV and dK through the warpgroup's store tiles (TMA drops rows past T).
    unsigned char* out_wg = smem + OUT_OFFSET + opaque(wg) * OUT_BYTES;
    if (lead) tile_free(&stage_empty[wg], posted);
    warpgroup_sync(wg);
    stage_bf16(out_wg, acc_dv, 1.0f, wl, g, t2);
    stage_bf16(out_wg + TILE_BYTES, acc_dk, sm_scale, wl, g, t2);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    warpgroup_sync(wg);
    if (lead) {
      const int key0 = w.kb * BK + 64 * wg;
      tma_store_3d(&dv_map, out_wg, w.h * D, key0, w.b);
      tma_store_3d(&dk_map, out_wg + TILE_BYTES, w.h * D, key0, w.b);
      bulk_commit();
    }
  }
  if (lead) {
    if (ws != nullptr) {
      tile_free(&stage_empty[wg], posted);
      post_job(&stage_full[wg], &jobs[wg], posted, make_int4(0, 0, 0, JOB_END));
    }
    bulk_wait<0>();  // the stores have read shared memory
  }
}

// D = sum over head_dim of O * dO for 32 tokens of one batch row a block:
// 8 threads a (token, head), 16 bytes of O and dO each; D staged by head
// in shared memory and written [B, heads, T]. With ``ws`` also zeroes
// the workspace rows of those tokens and, in the first block of a batch
// row, that row's counters (heads x n_qt).
constexpr int DT = 32;
constexpr int D_THREADS = DT * (D / 8);  // 256: one chunk a thread a head

__global__ void __launch_bounds__(D_THREADS)
    flash_attn_bwd_delta_kernel(const __nv_bfloat16* __restrict__ out,
                                const __nv_bfloat16* __restrict__ dout,
                                float* __restrict__ delta,
                                float* __restrict__ ws,
                                int* __restrict__ count, int T, int heads,
                                int n_qt) {
  extern __shared__ float sd[];  // [heads][DT]
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * DT;
  const int per_token = heads * (D / 8);
  for (int c = threadIdx.x; c < DT * per_token; c += D_THREADS) {
    const int tt = c / per_token;
    const int rem = c % per_token;
    const int h = rem >> 3;
    const int t = t0 + tt;
    float sum = 0.0f;
    if (t < T) {
      const size_t off = ((size_t)b * T + t) * heads * D + (size_t)rem * 8;
      const uint4 o = __ldg(reinterpret_cast<const uint4*>(out + off));
      const uint4 d = __ldg(reinterpret_cast<const uint4*>(dout + off));
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(o2[e]);
        const float2 y = __bfloat1622float2(d2[e]);
        sum = fmaf(a.x, y.x, fmaf(a.y, y.y, sum));
      }
      if (ws != nullptr) {
        float4* z = reinterpret_cast<float4*>(ws + off);
        z[0] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        z[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    // The 8 lanes of a (token, head) are adjacent: every thread makes the
    // same number of trips (DT * per_token is a multiple of D_THREADS).
    sum += __shfl_xor_sync(FULL_MASK, sum, 1);
    sum += __shfl_xor_sync(FULL_MASK, sum, 2);
    sum += __shfl_xor_sync(FULL_MASK, sum, 4);
    if ((rem & 7) == 0) sd[h * DT + tt] = sum;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < heads * DT; i += D_THREADS) {
    const int t = t0 + i % DT;
    if (t < T) delta[((size_t)b * heads + i / DT) * T + t] = sd[i];
  }
  if (count != nullptr && blockIdx.x == 0) {
    for (int i = threadIdx.x; i < heads * n_qt; i += D_THREADS) {
      count[(size_t)b * heads * n_qt + i] = 0;
    }
  }
}

// Registers a thread the kernel starts with, which setmaxnreg moves: the
// producer warpgroup frees (REGS - 80) x 128, the consumers take
// (208 - REGS) x 256, so REGS below 166 would leave them waiting forever.
constexpr int REGS = 65536 / THREADS / 8 * 8;  // 168
static_assert(REGS == 168, "setmaxnreg counts assume 168 at launch");

// CTAs a launch runs: all the card holds at once (cached per device); 0
// if the compiled kernel does not start with REGS registers.
int resident_ctas() {
  thread_local int last_dev = -1, last = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev != last_dev) {
    int sms = 0, per_sm = 0;
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, flash_attn_bwd_kernel) != cudaSuccess ||
        attr.numRegs != REGS) {
      return 0;
    }
    if (cudaFuncSetAttribute(flash_attn_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, flash_attn_bwd_kernel, THREADS, SMEM_BYTES) !=
            cudaSuccess) {
      return 0;
    }
    last = per_sm * sms;
    last_dev = dev;
  }
  return last;
}

// A 3-D map over a [B, T, cols] view with token stride ``stride_t``
// elements: boxes of ``box_cols`` x ``rows``, 128-byte swizzle.
bool encode_map(CUtensorMap* map, EncodeTiledFn encode, const void* base,
                CUtensorMapDataType type, int elem_bytes, int batch, int T,
                long long cols, long long stride_t, int box_cols, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)T,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)stride_t * elem_bytes,
                                 (cuuint64_t)stride_t * elem_bytes * T};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(base), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map over one of q, k, v, dO, dq, dk, dv (bf16, 64-column boxes).
bool encode_bf16(CUtensorMap* map, EncodeTiledFn encode, const void* base,
                 int batch, int T, int heads, long long stride_t, int rows) {
  return encode_map(map, encode, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                    batch, T, (long long)heads * D, stride_t, D, rows);
}

bool bad_args(int batch, int T, int heads, long long stride_in,
              long long stride_do, long long stride_out, float sm_scale) {
  return batch <= 0 || T <= 0 || heads <= 0 || batch > 65535 ||
         stride_in % 8 != 0 || stride_do % 8 != 0 || stride_out % 8 != 0 ||
         stride_in < (long long)heads * D ||
         stride_do < (long long)heads * D ||
         stride_out < (long long)heads * D || !(sm_scale > 0.0f);
}

}  // namespace

extern "C" {

// CTAs of the fused kernel's persistent grid the card holds at once.
int flash_attn_bwd_resident_ctas() { return resident_ctas(); }

// D (and the workspace's zeros) on ``stream``. out, dout: [B, T, heads*64]
// bf16 contiguous, 16-byte aligned; delta [B, heads, T] f32; ws
// [B, T, heads, 64] f32 and count [B, heads, ceil(T / 64)] int32, or
// both null when T <= 128 (one key block). Returns 0 or the
// cudaError_t.
int flash_attn_bwd_delta_launch(const void* out, const void* dout,
                                void* delta, void* ws, void* count, int batch,
                                int T, int heads, void* stream) {
  if (batch <= 0 || T <= 0 || heads <= 0 || batch > 65535 ||
      (ws == nullptr) != (count == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((T + DT - 1) / DT, batch);
  const int smem = heads * DT * 4;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  flash_attn_bwd_delta_kernel<<<grid, D_THREADS, smem,
                                (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout), static_cast<float*>(delta),
      static_cast<float*>(ws), static_cast<int*>(count), T, heads,
      (T + BQ - 1) / BQ);
  return (int)cudaGetLastError();
}

// dq, dk, dv on ``stream``. q, k, v: [B, T, heads, 64] bf16 with token
// stride ``stride_in`` (a multiple of 8; 16-byte aligned bases); dout the
// same shape with token stride ``stride_do`` (a multiple of 8, 16-byte
// aligned); mask [B, T] int32; lse [B, heads, T] f32 from
// flash_attn_launch; delta [B, heads, T] f32 and, when T > 128, ws and
// count from flash_attn_bwd_delta_launch (else null); outputs
// [B, T, heads, 64] bf16 with token stride ``stride_out`` (a multiple of
// 8; 16-byte aligned bases). Returns 0 or the cudaError_t of the launch
// (a tensor-map failure as cudaErrorUnknown).
int flash_attn_bwd_launch(const void* q, const void* k, const void* v,
                          const void* dout, const void* mask, const void* lse,
                          const void* delta, void* ws, void* count, void* dq,
                          void* dk, void* dv, int batch, int T, int heads,
                          long long stride_in, long long stride_do,
                          long long stride_out, float sm_scale,
                          void* stream) {
  const int n_kb = (T + BK - 1) / BK;
  if (bad_args(batch, T, heads, stride_in, stride_do, stride_out, sm_scale) ||
      (n_kb > 1) != (ws != nullptr) || (ws == nullptr) != (count == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_items = (long long)batch * heads * n_kb;
  if (n_items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int ctas = resident_ctas();
  if (ctas <= 0) return (int)cudaErrorInvalidConfiguration;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorUnknown;
  CUtensorMap q_map, k_map, v_map, do_map, dq_map, dk_map, dv_map, ws_map;
  const long long hd = (long long)heads * D;
  if (!encode_bf16(&q_map, encode, q, batch, T, heads, stride_in, BQ) ||
      !encode_bf16(&k_map, encode, k, batch, T, heads, stride_in, BK) ||
      !encode_bf16(&v_map, encode, v, batch, T, heads, stride_in, BK) ||
      !encode_bf16(&do_map, encode, dout, batch, T, heads, stride_do, BQ) ||
      !encode_bf16(&dq_map, encode, dq, batch, T, heads, stride_out, BQ) ||
      !encode_bf16(&dk_map, encode, dk, batch, T, heads, stride_out, BQ) ||
      !encode_bf16(&dv_map, encode, dv, batch, T, heads, stride_out, BQ)) {
    return (int)cudaErrorUnknown;
  }
  // The workspace, [B, T, heads*64] f32, in boxes of 32 columns (128 bytes).
  ws_map = dq_map;  // unread where there is no workspace
  if (ws != nullptr &&
      !encode_map(&ws_map, encode, ws, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                  batch, T, hd, hd, 32, BQ)) {
    return (int)cudaErrorUnknown;
  }
  const int grid = (int)(n_items < ctas ? n_items : ctas);
  flash_attn_bwd_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      q_map, k_map, v_map, do_map, dq_map, dk_map, dv_map, ws_map,
      static_cast<const int*>(mask), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(ws),
      static_cast<int*>(count), static_cast<__nv_bfloat16*>(dq), T, heads,
      n_kb, (T + BQ - 1) / BQ, (int)n_items, stride_out, sm_scale,
      sm_scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // extern "C"
