// Non-causal flash attention with a key-padding mask, for Hopper (sm_90a).
//
// Replaces the TPU library kernel jax.experimental.pallas.ops.tpu.
// flash_attention as the encoder calls it (classmate_rag_tpu/embeddings/
// model.py:272-284), with the semantics of the encoder's non-flash path
// (model.py:285-293), which is what the JAX package computes off the TPU:
//   s[q, k] = (Q[q] . K[k]) * sm_scale + (mask[k] ? 0 : NEG_INF)
//   out[q]  = sum_k softmax_k(s[q, :]) V[k]
// NEG_INF is f32 min (finite), added, not set: a row whose keys are all
// masked gets the uniform softmax the reference gives it. Pad QUERY rows
// are computed like any other row (keys are masked, queries are not).
//
// Layout: q, k, v are [B, T, heads, 64] bf16 views with one token stride
// (the columns of the encoder's fused [B*T, 3H] projection); out is
// [B, T, heads*64] bf16 contiguous; mask is [B, T] int32.
//
// What bounds it on an H100: at T <= 512 and head_dim 64, bytes (Q and O
// for every row, K and V for the real keys) bound it, ~0.02 ms at the
// encoder's shapes; the tensor-core work is ~1/4 of that at T = 512 and
// less below. So the design keeps copies in flight and the per-tile work
// short:
//
// - Work item = (batch row, head, 128-query tile): two consumer
//   warpgroups of 64 query rows each and one producer warp. K/V go
//   through L2 T/128 times per (batch row, head).
// - Persistent grid rather than more resident CTAs: the S and O
//   accumulators take 64 f32 registers a thread, and the register file
//   is split over the SM's 4 schedulers, so 2 CTAs of 9 warps (<= 96
//   registers a thread) is the most an SM holds. Each CTA walks items
//   blockIdx.x, + gridDim.x, ...; items of one (batch row, head) are
//   adjacent, so CTAs running side by side share K/V in L2. The producer
//   runs ahead into the next item: its Q goes to the second of two Q
//   buffers, its mask words are loaded and its K/V tiles go into the
//   ring while the consumers finish the current item. At T = 128 an item
//   has 1-2 key tiles, so this, with the other CTA of the SM, is what
//   hides the copies.
// - TMA (cp.async.bulk.tensor, 3-D maps over (heads*64 columns, T, B),
//   128-byte swizzle) for Q once per item and for K/V tiles of 64 keys
//   into a ring of STAGES stages, one mbarrier pair per stage. Rows past
//   T arrive as zeros per batch row and still count as bytes.
// - S = Q K^T with wgmma m64n64k16 (4 k-steps over head_dim), both
//   operands K-major from swizzled shared memory.
// - Online softmax in f32 registers, in base 2. In a tile whose 64 keys
//   are all real, the row max is taken on the raw scores and one FFMA
//   folds log2(e) * sm_scale (> 0) and the max into the exponent; other
//   tiles first add the mask bias with one FFMA a score. Then ex2. Row
//   max across the 4 threads of a row by shuffles; the row sum stays per
//   thread and is reduced once in the epilogue (every thread of a row
//   rescales by the same factor); O is rescaled only when a max moved.
// - O += P V with wgmma m64n64k16: P from registers (the m64nNk16
//   accumulator fragment of 16 keys is the k16 A fragment, converted to
//   bf16 in place), V from shared memory as an MN-major operand with the
//   transpose bit (no scalar shared loads).
// - The two consumer warpgroups share every K/V stage and interleave on
//   the SM's schedulers with each other and with the other CTA's: one's
//   softmax runs while another's products do. A stage is freed when both
//   warpgroups' products on it retired.
// - Epilogue: O / l -> bf16 into the warp's own 16 rows of the item's Q
//   buffer (swizzled: no bank conflicts), then 16-byte stores, each
//   warp instruction 4 whole 128-byte rows; the Q buffer is released
//   after that.
// Issuing S(n + 1) before the softmax of tile n, or taking turns with
// named barriers, needs a second accumulator or P kept live across the
// softmax: over 96 registers, so it would cost the second CTA of the SM.
//
// The reference normalises P in f32 and rounds the probabilities to bf16
// before P.V; here the unnormalised 2^(s - m) is rounded and the sum is
// divided out at the end. Both round each weight once to bf16 (relative
// 2^-9), so the outputs differ by about |v| * 2^-9.
//
// Padding: a key tile with no real key, met after a tile that had one,
// adds 2^(NEG_INF - m) = 0 to every row and leaves m unchanged, so it is
// skipped: the producer does not load it. The producer alone reads the
// mask (the words of 8 tiles at once, one ballot a word) and hands each
// loaded stage's mask bias to the consumers beside it in shared memory;
// after an item's last tile it posts a stage with no data that marks the
// item's end, so the consumers never wait on a skipped tile's stage.
// A 64-key tile keeps the skip fine: a bucket-128 passage of <= 64
// tokens reads one K/V tile. The first tile is never skipped, so m is
// finite from then on and 2^(m_old - m_new) never sees -inf - -inf.
// Keys past T score -inf and weigh exactly 0.

#include "hopper.cuh"  // mbarriers, TMA, wgmma, the tensor-map encoder

namespace {

constexpr int D = 64;         // head_dim: one 128-byte swizzled row
constexpr int BM = 128;       // query rows an item: 2 warpgroups x 64
constexpr int BN = 64;        // keys a tile
constexpr int STAGES = 4;     // K/V ring depth
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 32;
constexpr int Q_BYTES = BM * D * 2;         // 16 KB
constexpr int KV_BYTES = BN * D * 2;        // 8 KB each of K and V
constexpr int STAGE_BYTES = 2 * KV_BYTES;
constexpr int BAR_OFFSET = 2 * Q_BYTES + STAGES * STAGE_BYTES;
constexpr int INFO_OFFSET = BAR_OFFSET + 128;
constexpr int MASK_TILES = 8;  // key tiles whose mask words load at once
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float NEG_INF_F = -3.4028234663852886e38f;  // f32 min
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// What the producer tells the consumers about a ring stage: whether it
// ends the item (no data) or holds a key tile whose 64 keys are all real,
// and the tile's mask bias (0 for a real key, NEG_INF for a masked one,
// -inf past T).
constexpr int TILE_END = 1;
constexpr int TILE_ALL_REAL = 2;

struct TileInfo {
  int flags;
  int pad[3];
  float bias[BN];
};

constexpr int SMEM_BYTES =
    INFO_OFFSET + STAGES * (int)sizeof(TileInfo) + 1024;  // + slack to align

struct Item {
  int b, h, qt;
};

__device__ __forceinline__ Item decode(int item, int heads, int n_qt) {
  const int bh = item / n_qt;
  return Item{bh / heads, bh % heads, item % n_qt};
}

// Mask words of keys k0*64 + 32u + lane, u < 2 * MASK_TILES, of batch
// row b (0 past T): the real keys of MASK_TILES tiles, loaded together.
__device__ __forceinline__ void load_mask_words(int (&words)[2 * MASK_TILES],
                                                const int* __restrict__ mask,
                                                int b, int k0, int T,
                                                int lane) {
  const int* mrow = mask + (size_t)b * T;
#pragma unroll
  for (int u = 0; u < 2 * MASK_TILES; ++u) {
    const int key = k0 * BN + 32 * u + lane;
    words[u] = key < T ? __ldg(mrow + key) : 0;
  }
}

// S = Q K^T for one warpgroup: 64 rows x 64 keys, 4 k-steps of 16 head
// dims, both operands K-major in swizzled shared memory.
__device__ __forceinline__ void issue_s(float (&acc)[32],
                                        const unsigned char* sq,
                                        const unsigned char* sk) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_m64n64k16_ss(acc, desc_sw128(sq + kk * 32), desc_sw128(sk + kk * 32),
                       kk);
  }
}


__global__ void __launch_bounds__(THREADS, 2)
    flash_attn_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const int* __restrict__ mask,      // [B, T]
                      __nv_bfloat16* __restrict__ out,   // [B, T, heads*64]
                      int T, int heads, int n_qt, int n_items,
                      float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sQ = smem;                    // 2 buffers of 128 rows
  unsigned char* ring = smem + 2 * Q_BYTES;    // STAGES x (K, V)
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFFSET);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;
  uint64_t* q_empty = q_full + 2;
  TileInfo* info = reinterpret_cast<TileInfo*>(smem + INFO_OFFSET);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);  // every consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // ---- producer: Q per item, then the item's K/V tiles ---------------
    // The mask words of MASK_TILES tiles load together (one latency);
    // each tile's real keys are then one ballot a word. The next item's
    // first words load while this item's last tiles are issued.
    const int n_kt = (T + BN - 1) / BN;
    int it = 0;
    int n = 0;
    int words[2 * MASK_TILES];
    if (blockIdx.x < n_items) {
      load_mask_words(words, mask, decode(blockIdx.x, heads, n_qt).b, 0, T,
                      lane);
    }
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
      const Item w = decode(item, heads, n_qt);
      if (lane == 0) {
        const int qb = n & 1;
        mbar_wait(&q_empty[qb], ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(&q_full[qb], Q_BYTES);
        tma_load_3d(sQ + qb * Q_BYTES, &q_map, &q_full[qb], w.h * D,
                    w.qt * BM, w.b);
      }
      bool seen = false;
      for (int k0 = 0; k0 < n_kt; k0 += MASK_TILES) {
        if (k0 > 0) load_mask_words(words, mask, w.b, k0, T, lane);
        int cur[2 * MASK_TILES];
#pragma unroll
        for (int u = 0; u < 2 * MASK_TILES; ++u) cur[u] = words[u];
        const int next = item + gridDim.x;
        if (k0 + MASK_TILES >= n_kt && next < n_items) {
          load_mask_words(words, mask, decode(next, heads, n_qt).b, 0, T,
                          lane);
        }
#pragma unroll
        for (int u = 0; u < MASK_TILES; ++u) {
          const int kt = k0 + u;
          const unsigned lo = __ballot_sync(FULL_MASK, cur[2 * u] != 0);
          const unsigned hi = __ballot_sync(FULL_MASK, cur[2 * u + 1] != 0);
          const bool any = (lo | hi) != 0u;
          if (kt >= n_kt || (!any && seen)) continue;  // adds exactly nothing
          seen = seen || any;
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          const int key = kt * BN + lane;  // this lane's keys: key, key + 32
          info[s].bias[lane] =
              key < T ? (cur[2 * u] != 0 ? 0.0f : NEG_INF_F) : -INFINITY;
          info[s].bias[lane + 32] =
              key + 32 < T ? (cur[2 * u + 1] != 0 ? 0.0f : NEG_INF_F)
                           : -INFINITY;
          if (lane == 0) {
            info[s].flags = (lo & hi) == FULL_MASK ? TILE_ALL_REAL : 0;
          }
          __syncwarp();  // the warp's writes, then lane 0's release
          if (lane == 0) {
            mbar_expect_tx(&full[s], STAGE_BYTES);
            unsigned char* dst = ring + s * STAGE_BYTES;
            tma_load_3d(dst, &k_map, &full[s], w.h * D, kt * BN, w.b);
            tma_load_3d(dst + KV_BYTES, &v_map, &full[s], w.h * D, kt * BN,
                        w.b);
          }
          ++it;
        }
      }
      if (lane == 0) {  // the item's end: a stage with no data
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        info[s].flags = TILE_END;
        mbar_arrive(&full[s]);
      }
      ++it;
    }
    return;  // no block-wide barrier follows
  }

  // ---- consumers ---------------------------------------------------------
  // Warpgroup wg takes query rows 64 wg .. 64 wg + 63 of the item; its
  // warp wl rows 16 wl .. 16 wl + 15. In the m64n64 accumulator, lane l
  // holds rows 16 wl + l/4 (i = 0) and + 8 (i = 1), columns
  // 8j + 2(l % 4) + e, at acc[4j + 2i + e].
  const int wg = warp >> 2;
  const int wl = warp & 3;
  const int g = lane >> 2;
  const int t2 = 2 * (lane & 3);
  int it = 0;
  int n = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
    const Item w = decode(item, heads, n_qt);
    const int qb = n & 1;
    const unsigned char* sq = sQ + qb * Q_BYTES + wg * (Q_BYTES / 2);

    float o[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) o[x] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.0f, 0.0f};  // this thread's part of the row sums

    mbar_wait(&q_full[qb], (n >> 1) & 1);
    for (;; ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const int flags = info[s].flags;
      if (flags & TILE_END) {
        if (lane == 0) mbar_arrive(&empty[s]);
        ++it;
        break;
      }
      const unsigned char* sk = ring + s * STAGE_BYTES;

      float acc[32];
      wgmma_fence();
      issue_s(acc, sq, sk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);

      // Base-2 logits x = s * log2(e) * sm_scale + bias and the new row
      // maxima. A tile whose 64 keys are all real has no bias: its scale
      // (> 0) goes onto the raw maximum and into the exponent's FFMA.
      // Otherwise the bias is added first and the multiplier is 1.
      const bool all_real = flags & TILE_ALL_REAL;
      const float mul = all_real ? scale_log2 : 1.0f;
      if (!all_real) {
        const float* bias = info[s].bias;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 b2 = *reinterpret_cast<const float2*>(bias + 8 * j + t2);
          acc[4 * j + 0] = fmaf(acc[4 * j + 0], scale_log2, b2.x);
          acc[4 * j + 1] = fmaf(acc[4 * j + 1], scale_log2, b2.y);
          acc[4 * j + 2] = fmaf(acc[4 * j + 2], scale_log2, b2.x);
          acc[4 * j + 3] = fmaf(acc[4 * j + 3], scale_log2, b2.y);
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(acc[4 * j], acc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(acc[4 * j + 2], acc[4 * j + 3]));
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL_MASK, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL_MASK, mx[i], 2));
        mx[i] = fmaxf(m[i], mx[i] * mul);
        alpha[i] = ex2(m[i] - mx[i]);  // 0 on the first tile
        m[i] = mx[i];
      }
      // P = 2^(x - m) as bf16 A fragments (keys 16kk .. 16kk + 15 are
      // accumulator columns j = 2kk, 2kk + 1, i.e. acc[8kk .. 8kk + 7])
      // and this thread's part of its row sums.
      uint32_t pa[4][4];
      float rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = r & 1;
          const float p0 = ex2(fmaf(acc[8 * kk + 2 * r], mul, -mx[i]));
          const float p1 = ex2(fmaf(acc[8 * kk + 2 * r + 1], mul, -mx[i]));
          rs[i] += p0 + p1;
          pa[kk][r] = pack_bf16(p0, p1);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
      if (alpha[0] != 1.0f || alpha[1] != 1.0f) {  // the max moved
#pragma unroll
        for (int x = 0; x < 32; ++x) o[x] *= alpha[(x >> 1) & 1];
      }

      // O += P V: 4 k-steps of 16 keys, V MN-major (transposed); one k16
      // step is 16 rows of V.
      const unsigned char* sv = sk + KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n64k16_rs_tb(o, pa[kk], desc_sw128(sv + kk * 2048), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with it
    }

    // ---- epilogue: O / l -> bf16, staged in this warp's 16 rows of the
    // Q buffer (its products are done), then 16-byte stores ------------
    unsigned char* stage =
        const_cast<unsigned char*>(sq) + wl * 16 * (D * 2);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float sum = l[i];
      sum += __shfl_xor_sync(FULL_MASK, sum, 1);
      sum += __shfl_xor_sync(FULL_MASK, sum, 2);
      const float inv = 1.0f / sum;
      const int r = g + 8 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // 16-byte chunk j of row r, swizzled
        *reinterpret_cast<uint32_t*>(stage + r * 128 + ((j ^ (r & 7)) << 4) +
                                     2 * t2) =
            pack_bf16(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      }
    }
    __syncwarp();
    const size_t out_stride = (size_t)heads * D;
    const int row0 = w.qt * BM + wg * 64 + wl * 16;
#pragma unroll
    for (int u = 0; u < 4; ++u) {  // 4 rows of 128 bytes a store
      const int r = 4 * u + (lane >> 3);
      const int c = lane & 7;
      if (row0 + r < T) {
        *reinterpret_cast<uint4*>(out + ((size_t)w.b * T + row0 + r) *
                                            out_stride +
                                  (size_t)w.h * D + 8 * c) =
            *reinterpret_cast<const uint4*>(stage + r * 128 +
                                            ((c ^ (r & 7)) << 4));
      }
    }
    // Generic accesses to the buffer, before TMA writes the next Q there.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(&q_empty[qb]);
  }
}

// CTAs a launch runs: all the card holds at once (cached per device).
int resident_ctas() {
  thread_local int last_dev = -1, last = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev != last_dev) {
    int sms = 0, per_sm = 0;
    if (cudaFuncSetAttribute(flash_attn_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, flash_attn_kernel, THREADS, SMEM_BYTES) != cudaSuccess) {
      return 0;
    }
    last = per_sm * sms;
    last_dev = dev;
  }
  return last;
}

// A 3-D map over one of q, k, v: (heads*64 columns, T rows, B planes),
// boxes of 64 columns x ``rows``.
bool encode_map(CUtensorMap* map, EncodeTiledFn encode, const void* base,
                int batch, int T, int heads, long long stride_t, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)heads * D, (cuuint64_t)T,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)stride_t * 2,
                                 (cuuint64_t)stride_t * 2 * T};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

int flash_attn_head_dim() { return D; }

// CTAs of the persistent grid the card holds at once; 0 if none fits.
int flash_attn_resident_ctas() { return resident_ctas(); }

// Launches on ``stream``. q, k, v: [B, T, heads, 64] bf16 with token
// stride ``stride_t`` elements (a multiple of 8; 16-byte aligned bases);
// out [B, T, heads*64] bf16; mask [B, T] int32; sm_scale > 0. Returns 0
// or the cudaError_t of the launch (a tensor-map failure as
// cudaErrorUnknown).
int flash_attn_launch(const void* q, const void* k, const void* v,
                      const void* mask, void* out, int batch, int T,
                      int heads, long long stride_t, float sm_scale,
                      void* stream) {
  if (batch <= 0 || T <= 0 || heads <= 0 || stride_t % 8 != 0 ||
      stride_t < (long long)heads * D || !(sm_scale > 0.0f)) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_qt = (T + BM - 1) / BM;
  const long long n_items = (long long)batch * heads * n_qt;
  if (n_items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int ctas = resident_ctas();
  if (ctas <= 0) return (int)cudaErrorInvalidConfiguration;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorUnknown;
  CUtensorMap q_map, k_map, v_map;
  if (!encode_map(&q_map, encode, q, batch, T, heads, stride_t, BM) ||
      !encode_map(&k_map, encode, k, batch, T, heads, stride_t, BN) ||
      !encode_map(&v_map, encode, v, batch, T, heads, stride_t, BN)) {
    return (int)cudaErrorUnknown;
  }
  const int grid = (int)(n_items < ctas ? n_items : ctas);
  flash_attn_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      q_map, k_map, v_map, static_cast<const int*>(mask),
      static_cast<__nv_bfloat16*>(out), T, heads, n_qt, (int)n_items,
      sm_scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // extern "C"
