// Masked dense scan with a running exact top-k, for Hopper (sm_90a).
//
// Replaces the TPU kernel classmate_rag_tpu/ops/topk.py::topk_pallas:
//   scores[q, n] = bf16(queries[q]) . emb[n] + mask_bias[n]   (f32 sums)
// and, for every query, the k best (score desc, row asc) rows. Two
// launches: topk_scan_kernel walks the corpus and writes a few sorted
// lists per query, the [Q, N] score matrix never; topk_merge_kernel
// merges them into each query's top-k (topk_pallas's own final
// lax.top_k over its per-tile lists).
//
// What bounds it on an H100, at the serving shape (N = 262,144 rows of
// d = 768 bf16, Q = 256, k = 32): the corpus read, 403 MB -> 120 us at
// 3.35 TB/s, against 103 GFLOP -> 104 us at 989 TFLOP/s bf16. The two
// are nearly balanced, so the copies, the products and the selection
// must overlap or stay small:
//
// - Grid (Q / 64 query blocks) x (S corpus slices), S chosen by the
//   wrapper so the grid is one wave of resident blocks (4 x 33 on 132
//   SMs). The query blocks of a slice run side by side and share each
//   corpus tile through L2; device memory sees the corpus once.
// - Queries stay resident: each block converts its 64 query rows to bf16
//   once, into shared memory in the 128-byte-swizzled layout wgmma reads
//   (96 KB at d = 768), and keeps them for its whole walk.
// - The corpus arrives through a ring of (128 rows x 64 columns) bf16
//   stages: one producer thread keeps TMA loads in flight
//   (cp.async.bulk.tensor with 128-byte swizzle, completion counted on
//   an mbarrier per stage); a consumer frees a stage as soon as the
//   products that read it have retired.
// - Products on the tensor cores with wgmma m64n128k16 (bf16 in, f32
//   accumulators in registers), both operands K-major from shared memory
//   through swizzled descriptors, two stages in flight.
// - Two consumer warpgroups take the slice's 128-row tiles in turn, so
//   one's selection runs while the other's products do (one warpgroup
//   where two sets of lists leave too little shared memory, large k).
// - Selection, a few instructions a score: each warpgroup keeps one
//   running top-k list per query across its tiles; a score survives only
//   if it beats the list's k-th entry and reaches the query's published
//   bound (the largest k-th score any list of the grid has reached,
//   shared through one atomicMax a query: a row below it cannot make the
//   final top-k). The first tile seeds that bound by bisection on the
//   tile's own scores; then each list adds its first tile's two best
//   scores to a pool per query, and one block per query raises the
//   bound to the pool's k-th best. Survivors go to a 32-entry buffer
//   per query, merged into the list with a warp bitonic network when it
//   fills and once at the end. Comparing (score, row) pairs keeps the lowest row
//   among equal scores, whatever the order of arrival.
//
// Sentinels: rows past N are never candidates; a list slot never filled
// is (-inf, -1), below every real score, and the merge reports an
// unfilled result slot as (NEG_INF, -1). Scores of masked rows are
// score + NEG_INF, which rounds to NEG_INF, exactly as in the plain
// version.

#include <climits>
#include <cstdint>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, the tensor-map encoder

namespace {

constexpr int QB = 64;        // queries per block: the M of one wgmma
constexpr int TN = 128;       // corpus rows per tile: the N of one wgmma
constexpr int KC = 64;        // columns of d per stage: one 128-byte row
constexpr int CAP = 32;       // candidate buffer entries per query
constexpr int MAX_K = 128;
constexpr int MIN_STAGES = 2;
constexpr int MAX_STAGES = 8;
constexpr int Q_CHUNK_BYTES = QB * KC * 2;   // 8 KB
constexpr int STAGE_BYTES = TN * KC * 2;     // 16 KB
constexpr int SEED_BITS = 16;  // key bits a bisected bound resolves
constexpr int POOL_TOP = 2;    // scores each list adds to its query's pool
constexpr int POOL_READ = 128;  // pool entries a bound is taken from
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float NEG_INF_F = -3.4028234663852886e38f;  // f32 min

// Named barriers (0 is __syncthreads): all consumers; the turn of each of
// two consumer warpgroups to issue its products.
constexpr int BAR_CONSUMERS = 1;
constexpr int BAR_TURN = 2;

// Shared-memory layout for one (d, k, stages, consumer warpgroups);
// offsets from a 1024-byte aligned base (the 128-byte swizzle repeats
// every 8 rows = 1024 bytes). Each consumer warpgroup has its own lists
// and buffers.
struct Layout {
  int ring, lv, lr, bv, br, bar, bytes;
};

__host__ __device__ inline Layout layout(int d, int k, int stages, int wgs) {
  Layout L;
  const int chunks = (d + KC - 1) / KC;
  L.ring = chunks * Q_CHUNK_BYTES;
  L.lv = L.ring + stages * STAGE_BYTES;
  L.lr = L.lv + wgs * QB * k * 4;
  L.bv = L.lr + wgs * QB * k * 4;
  L.br = L.bv + wgs * QB * CAP * 4;
  L.bar = L.br + wgs * QB * CAP * 4;
  L.bytes = L.bar + 2 * stages * 8 + 1024;  // + slack to align the base
  return L;
}

__device__ __forceinline__ bool beats(float av, int ar, float bv, int br) {
  return av > bv || (av == bv && ar < br);
}

// f32 -> unsigned with the same order, so atomicMax on the key is a max
// on the score; key 0 (never made from a score) means "none yet".
__device__ __forceinline__ unsigned float_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned key) {
  if (key == 0u) return -INFINITY;
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// ---- selection ----------------------------------------------------------

// acc[4j + 2i + e] at the run-time column bit b = 2j + e of query half i:
// a tree of selects on the bits of b (registers take no run-time index).
__device__ __forceinline__ float pick(const float (&acc)[64], int i, int b) {
  float v16[16], v8[8], v4[4], v2[2];
#pragma unroll
  for (int x = 0; x < 16; ++x) {
    v16[x] = (b & 1) ? acc[4 * x + 2 * i + 1] : acc[4 * x + 2 * i];
  }
#pragma unroll
  for (int x = 0; x < 8; ++x) v8[x] = (b & 2) ? v16[2 * x + 1] : v16[2 * x];
#pragma unroll
  for (int x = 0; x < 4; ++x) v4[x] = (b & 4) ? v8[2 * x + 1] : v8[2 * x];
#pragma unroll
  for (int x = 0; x < 2; ++x) v2[x] = (b & 8) ? v4[2 * x + 1] : v4[2 * x];
  return (b & 16) ? v2[1] : v2[0];
}

// One compare-exchange of a bitonic network over the 32 lanes: lane and
// lane ^ stride compare (v, r); the lower lane keeps the better pair in
// a descending block and the worse one in an ascending block.
__device__ __forceinline__ void exchange(float& v, int& r, int stride,
                                         bool descending, int lane) {
  const float ov = __shfl_xor_sync(FULL_MASK, v, stride);
  const int orr = __shfl_xor_sync(FULL_MASK, r, stride);
  const bool keep_better = ((lane & stride) == 0) == descending;
  if (beats(ov, orr, v, r) == keep_better) {
    v = ov;
    r = orr;
  }
}

// A bitonic sequence over the lanes -> descending.
__device__ __forceinline__ void bitonic_merge(float& v, int& r, int lane) {
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    exchange(v, r, stride, true, lane);
  }
}

// Merges up to 32 candidates (lane j holds candidate j, empty slots
// (-inf, INT_MAX)) into a query's sorted list of k <= 32 * KW entries
// ((score desc, row asc), empty slots last): sort the candidates, then
// pass them down the list 32 entries at a time; at each step the better
// half of (segment, candidates) is the new segment and the worse half
// goes on. One warp; the list is in shared memory.
template <int KW>
__device__ __forceinline__ void merge_into(float* lv, int* lr, float cv, int cr,
                                           int k, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      exchange(cv, cr, stride, (lane & size) == 0, lane);
    }
  }
#pragma unroll
  for (int u = 0; u < KW; ++u) {
    const int i = 32 * u + lane;
    float sv = i < k ? lv[i] : -INFINITY;
    int sr = i < k ? lr[i] : INT_MAX;
    // Segment against the reversed candidates: the better of each pair
    // are the best 32 of both (a bitonic sequence), the worse the rest.
    const float rv = __shfl_sync(FULL_MASK, cv, 31 - lane);
    const int rr = __shfl_sync(FULL_MASK, cr, 31 - lane);
    const bool cand_better = beats(rv, rr, sv, sr);
    cv = cand_better ? sv : rv;
    cr = cand_better ? sr : rr;
    if (cand_better) {
      sv = rv;
      sr = rr;
    }
    bitonic_merge(sv, sr, lane);
    if (i < k) {
      lv[i] = sv;
      lr[i] = sr;
    }
    if (u + 1 < KW) bitonic_merge(cv, cr, lane);
  }
  __syncwarp();
}

// acc[4j + 2i + e] for the query half i and column 2j + e of this lane.
#define ACC(i, j, e) acc[4 * (j) + 2 * (i) + (e)]

// One block: 64 queries x one corpus slice. WGS consumer warpgroups take
// the slice's tiles in turn (tile t -> warpgroup t % WGS), each with its
// own lists, so one warpgroup's selection runs beside the other's
// products; the turn barriers keep their product issue in tile order,
// so each waits on a ring stage at most one phase ahead. Each writes its
// own list per query (WGS lists a slice). The last warp is the producer.
template <int KW, int WGS>
__global__ void __launch_bounds__(WGS * 128 + 32, 1)
    topk_scan_kernel(const __grid_constant__ CUtensorMap emb_map,
                     const float* __restrict__ queries,  // [Q, d] f32
                     const float* __restrict__ bias,     // [N] f32
                     float* __restrict__ out_vals,       // [Q, S * WGS, k]
                     int* __restrict__ out_rows,         // [Q, S * WGS, k]
                     unsigned* __restrict__ bounds,      // [Q] + pools, 0s
                     int n, int d, int nq, int k, int n_slices,
                     int slice_rows, int stages) {
  constexpr int CONSUMERS = WGS * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout L = layout(d, k, stages, WGS);
  unsigned char* sQ = smem;
  unsigned char* ring = smem + L.ring;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int chunks = (d + KC - 1) / KC;
  const int q0 = blockIdx.x * QB;
  const int slice = blockIdx.y;
  const int row_begin = slice * slice_rows;
  const int row_end = min(n, row_begin + slice_rows);
  const int n_tiles = (row_end - row_begin + TN - 1) / TN;
  // Each query's pool, after the bounds: the POOL_TOP best scores of
  // every list's first tile (keys, 0 where none yet).
  unsigned* pool = bounds + nq;
  const int pool_stride = n_slices * 2 * POOL_TOP;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // the 4 warps of the consuming warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // ---- producer: one thread keeps the ring full ---------------------
    if (lane == 0) {
      int it = 0;
      for (int t = 0; t < n_tiles; ++t) {
        for (int c = 0; c < chunks; ++c, ++it) {
          const int s = it % stages;
          mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
          mbar_expect_tx(&full[s], STAGE_BYTES);
          tma_load_2d(ring + s * STAGE_BYTES, &emb_map, &full[s], c * KC,
                      row_begin + t * TN);
        }
      }
    }
    return;  // no block-wide barrier follows
  }

  // ---- consumers: queries -> bf16, resident for the whole walk --------
  for (int g = tid; g < QB * chunks * 8; g += CONSUMERS) {
    const int c = g / (QB * 8);
    const int r = (g / 8) % QB;
    const int cg = g % 8;  // 16-byte group within the 128-byte row
    const int col = c * KC + cg * 8;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < nq && col < d) {
      const float4* src =
          reinterpret_cast<const float4*>(queries + (size_t)(q0 + r) * d + col);
      const float4 a = src[0];
      const float4 b = src[1];
      packed = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                          pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
    }
    *reinterpret_cast<uint4*>(sQ + c * Q_CHUNK_BYTES + r * 128 +
                              ((cg ^ (r & 7)) * 16)) = packed;
  }
  // Generic-proxy stores -> visible to wgmma's async-proxy reads.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, %1;\n" ::"n"(BAR_CONSUMERS), "n"(CONSUMERS)
               : "memory");

  // Warpgroup wg; its warp w owns local queries 16w .. 16w + 15, lists
  // and buffers alike. In the m64n128 accumulator, lane l holds rows
  // 16w + l/4 (i = 0) and 16w + l/4 + 8 (i = 1), columns 8j + 2(l % 4) + e,
  // at acc[4j + 2i + e]; the 4 lanes of a quad hold the 128 columns of
  // the same two queries.
  const int wg = warp >> 2;
  const int wq0 = (warp & 3) * 16;
  float* Lv = reinterpret_cast<float*>(smem + L.lv) + wg * QB * k;
  int* Lr = reinterpret_cast<int*>(smem + L.lr) + wg * QB * k;
  float* Bv = reinterpret_cast<float*>(smem + L.bv) + wg * QB * CAP;
  int* Br = reinterpret_cast<int*>(smem + L.br) + wg * QB * CAP;
  for (int i = lane; i < 16 * k; i += 32) {
    Lv[wq0 * k + i] = -INFINITY;
    Lr[wq0 * k + i] = INT_MAX;
  }
  __syncwarp();
  const int quad = lane & 3;
  const int my_q[2] = {wq0 + (lane >> 2), wq0 + (lane >> 2) + 8};
  const bool live[2] = {q0 + my_q[0] < nq, q0 + my_q[1] < nq};
  // The list's k-th entry and the query's bound: a score survives if it
  // beats the former and is >= the latter.
  float thr_v[2] = {-INFINITY, -INFINITY};
  int thr_r[2] = {INT_MAX, INT_MAX};
  float bound[2] = {-INFINITY, -INFINITY};
  int cnt[2] = {0, 0};

  float acc[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) acc[x] = 0.0f;

  for (int t = wg; t < n_tiles; t += WGS) {
    const int row0 = row_begin + t * TN;
    const bool whole = row0 + TN <= row_end;
    // This tile's mask bias and the published bounds, loaded while the
    // products run.
    float2 bb[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int r = row0 + 8 * j + 2 * quad;
      if (whole) {
        bb[j] = __ldg(reinterpret_cast<const float2*>(bias + r));
      } else {
        bb[j].x = r < row_end ? __ldg(bias + r) : 0.0f;
        bb[j].y = r + 1 < row_end ? __ldg(bias + r + 1) : 0.0f;
      }
    }
    unsigned g_key[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      g_key[i] = live[i] ? __ldcg(bounds + q0 + my_q[i]) : 0u;
    }

    if (WGS > 1 && t > 0) {  // the previous tile's products are issued
      asm volatile("bar.sync %0, %1;\n" ::"r"(BAR_TURN + wg), "n"(256)
                   : "memory");
    }
    int it = t * chunks;
    int prev = 0;
    for (int c = 0; c < chunks; ++c, ++it) {
      const int s = it % stages;
      mbar_wait(&full[s], (it / stages) & 1);
      wgmma_fence();
      const unsigned char* a = sQ + c * Q_CHUNK_BYTES;
      const unsigned char* b = ring + s * STAGE_BYTES;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n128k16(acc, desc_sw128(a + kk * 32), desc_sw128(b + kk * 32),
                         (c | kk) != 0);
      }
      wgmma_commit();
      if (c > 0) {
        wgmma_wait<1>();  // the previous stage's products have retired
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = s;
    }
    if (WGS > 1 && t + 1 < n_tiles) {  // the next tile's turn
      asm volatile("bar.arrive %0, %1;\n" ::"r"(BAR_TURN + (wg ^ 1)), "n"(256)
                   : "memory");
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[prev]);

    // Scores; a column past the slice scores -inf, below every bound.
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = whole || row0 + 8 * j + 2 * quad + e < row_end;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          ACC(i, j, e) = in ? ACC(i, j, e) + (e ? bb[j].y : bb[j].x)
                            : -INFINITY;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) bound[i] = fmaxf(bound[i], key_float(g_key[i]));

    if (t < WGS) {
      // Seed each query's bound from this tile: the largest key (on its
      // top SEED_BITS bits) with at least k of the tile's scores at or
      // above it. At least k rows reach it, so the k-th score of the
      // whole corpus does too; publish it for every block.
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        unsigned key = 0u;
        for (int bit = 31; bit >= 32 - SEED_BITS; --bit) {
          const unsigned cand = key | (1u << bit);
          const float x = key_float(cand);
          int c = 0;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            c += (ACC(i, j, 0) >= x) + (ACC(i, j, 1) >= x);
          }
          c += __shfl_xor_sync(FULL_MASK, c, 1);
          c += __shfl_xor_sync(FULL_MASK, c, 2);
          if (c >= k) key = cand;
        }
        if (live[i] && key != 0u) {
          bound[i] = fmaxf(bound[i], key_float(key));
          if (quad == 0) atomicMax(bounds + q0 + my_q[i], key);
        }
      }
    }

    if (t / WGS == 2 && wg == 0) {
      // Raise the bound of the queries this block answers for (one slice
      // a query) to the k-th best of their pools: distinct rows' scores,
      // so k of them at or above a key certify it as a list's k-th does.
      for (int ql = 0; ql < 16 && q0 + wq0 + ql < nq; ++ql) {
        if ((q0 + wq0 + ql) % n_slices != slice) continue;
        const unsigned* row = pool + (size_t)(q0 + wq0 + ql) * pool_stride;
        const int width = min(pool_stride, POOL_READ);
        unsigned keys[POOL_READ / 32];
#pragma unroll
        for (int u = 0; u < POOL_READ / 32; ++u) {
          keys[u] = lane + 32 * u < width ? __ldcg(row + lane + 32 * u) : 0u;
        }
        unsigned key = 0u;
        for (int bit = 31; bit >= 32 - SEED_BITS; --bit) {
          const unsigned cand = key | (1u << bit);
          unsigned c = 0;
#pragma unroll
          for (int u = 0; u < POOL_READ / 32; ++u) c += keys[u] >= cand;
          if (__reduce_add_sync(FULL_MASK, c) >= (unsigned)k) key = cand;
        }
        if (key != 0u) {
          if (lane == 0) atomicMax(bounds + q0 + wq0 + ql, key);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (my_q[i] == wq0 + ql) bound[i] = fmaxf(bound[i], key_float(key));
          }
        }
      }
    }

    // Survivors as one bit per column. Every row in the list precedes
    // this tile, so beating its k-th entry is a strict >, i.e. >= the
    // next float up.
    uint32_t m[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float floor_i =
          live[i] ? fmaxf(bound[i], nextafterf(thr_v[i], INFINITY)) : INFINITY;
      m[i] = 0u;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          m[i] |= (uint32_t)(ACC(i, j, e) >= floor_i) << (2 * j + e);
        }
      }
    }

    // Survivors -> buffers; a query whose buffer fills is merged, its
    // threshold rises, and its remaining survivors are filtered again.
    while (__any_sync(FULL_MASK, (m[0] | m[1]) != 0u)) {
      bool over[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = __popc(m[i]);
        int incl = c;
        int x = __shfl_up_sync(FULL_MASK, incl, 1, 4);
        if (quad >= 1) incl += x;
        x = __shfl_up_sync(FULL_MASK, incl, 2, 4);
        if (quad >= 2) incl += x;
        const int total = __shfl_sync(FULL_MASK, incl, 3, 4);
        // This lane's survivors take slots slot, slot + 1, ...; those past
        // the buffer stay for the next round.
        const int slot = cnt[i] + incl - c;
        const int fit = max(0, min(c, CAP - slot));
        uint32_t left = m[i];
        for (int x = 0; x < fit; ++x) {
          const int b = __ffs(left) - 1;
          left &= left - 1;
          const int at = my_q[i] * CAP + slot + x;
          Bv[at] = pick(acc, i, b);
          Br[at] = row0 + 8 * (b >> 1) + 2 * quad + (b & 1);
        }
        m[i] = left;
        over[i] = cnt[i] + total > CAP;
        cnt[i] = min(CAP, cnt[i] + total);
      }
      __syncwarp();
      const unsigned ov0 = __ballot_sync(FULL_MASK, over[0] && quad == 0);
      const unsigned ov1 = __ballot_sync(FULL_MASK, over[1] && quad == 0);
      if ((ov0 | ov1) == 0u) break;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        unsigned ov = i == 0 ? ov0 : ov1;
        while (ov) {
          const int q = wq0 + 8 * i + ((__ffs(ov) - 1) >> 2);
          ov &= ov - 1;
          merge_into<KW>(Lv + q * k, Lr + q * k, Bv[q * CAP + lane],
                         Br[q * CAP + lane], k, lane);
          if (lane == 0 && Lr[q * k + k - 1] != INT_MAX) {
            atomicMax(bounds + q0 + q, float_key(Lv[q * k + k - 1]));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!over[i]) continue;
        cnt[i] = 0;
        thr_v[i] = Lv[my_q[i] * k + k - 1];
        thr_r[i] = Lr[my_q[i] * k + k - 1];
        uint32_t drop = 0u;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool stays =
                ACC(i, j, e) >= bound[i] &&
                beats(ACC(i, j, e), row0 + 8 * j + 2 * quad + e, thr_v[i],
                      thr_r[i]);
            drop |= (uint32_t)!stays << (2 * j + e);
          }
        }
        m[i] &= ~drop;
      }
    }
    if (t < WGS) {
      // Into each query's pool: the POOL_TOP best of this first tile's
      // survivors, in the list or still in the buffer.
      for (int ql = 0; ql < 16; ++ql) {
        const int q = wq0 + ql;
        const int in_buffer =
            __shfl_sync(FULL_MASK, ql < 8 ? cnt[0] : cnt[1], 4 * (ql & 7));
        unsigned key = 0u;
        if (lane < k && Lr[q * k + lane] != INT_MAX) {
          key = float_key(Lv[q * k + lane]);
        }
        if (lane < in_buffer) key = max(key, float_key(Bv[q * CAP + lane]));
        for (int u = 0; u < POOL_TOP; ++u) {
          const unsigned best = __reduce_max_sync(FULL_MASK, key);
          if (lane == 0 && q0 + q < nq) {
            pool[(size_t)(q0 + q) * pool_stride +
                 (slice * 2 + wg) * POOL_TOP + u] = best;
          }
          const unsigned at = __ffs(__ballot_sync(FULL_MASK, key == best)) - 1;
          if (lane == (int)at) key = 0u;
        }
      }
    }
  }

  // ---- last merges and the warpgroup's list out -----------------------
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    for (int a = 0; a < 8; ++a) {
      const int left = __shfl_sync(FULL_MASK, cnt[i], 4 * a);
      if (left > 0) {
        const int q = wq0 + 8 * i + a;
        merge_into<KW>(Lv + q * k, Lr + q * k,
                       lane < left ? Bv[q * CAP + lane] : -INFINITY,
                       lane < left ? Br[q * CAP + lane] : INT_MAX, k, lane);
      }
    }
  }
  for (int ql = 0; ql < 16; ++ql) {
    const int q = q0 + wq0 + ql;
    if (q >= nq) break;
    const size_t o = ((size_t)q * n_slices * WGS + slice * WGS + wg) * k;
    for (int i = lane; i < k; i += 32) {
      const int r = Lr[(wq0 + ql) * k + i];
      out_vals[o + i] = r == INT_MAX ? -INFINITY : Lv[(wq0 + ql) * k + i];
      out_rows[o + i] = r == INT_MAX ? -1 : r;
    }
  }
}

#undef ACC

// The lists of a scan -> each query's top-k; one warp a query. Only entries
// at or above a bound that k rows reach can make the top-k: the scan's
// bound, raised to the k-th best of the lists' first two entries (the
// true top-k is spread over the lists, so that lands near the k-th
// score). The warp gathers the entries at or above it, 32 at a time, and
// merges them into its list; comparing (score, row) pairs keeps the
// lowest row among equal scores.
constexpr int MERGE_WARPS = 4;
constexpr int MERGE_BATCH = 8;  // 32-entry loads in flight a warp

template <int KW>
__global__ void __launch_bounds__(MERGE_WARPS * 32)
    topk_merge_kernel(const float* __restrict__ part_vals,  // [Q, lists, k]
                      const int* __restrict__ part_rows,    // [Q, lists, k]
                      const unsigned* __restrict__ bounds,  // [Q] keys
                      float* __restrict__ out_vals,         // [Q, k]
                      int* __restrict__ out_rows,           // [Q, k]
                      int nq, int n_lists, int k) {
  __shared__ float lv_all[MERGE_WARPS][MAX_K];
  __shared__ int lr_all[MERGE_WARPS][MAX_K];
  __shared__ float cv_all[MERGE_WARPS][64];
  __shared__ int cr_all[MERGE_WARPS][64];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * MERGE_WARPS + warp;
  if (q >= nq) return;  // the whole warp
  float* lv = lv_all[warp];
  int* lr = lr_all[warp];
  float* cv = cv_all[warp];
  int* cr = cr_all[warp];
  for (int i = lane; i < k; i += 32) {
    lv[i] = -INFINITY;
    lr[i] = INT_MAX;
  }
  const size_t base = (size_t)q * n_lists * k;
  const int total = n_lists * k;
  unsigned heads[4];  // the first two entries of lists lane, lane + 32
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int list = lane + 32 * (h >> 1);
    const int i = h & 1;
    const size_t j = base + (size_t)list * k + i;
    heads[h] = list < n_lists && i < k && part_rows[j] >= 0
                   ? float_key(part_vals[j])
                   : 0u;
  }
  unsigned key = 0u;
  for (int bit = 31; bit >= 32 - SEED_BITS; --bit) {
    const unsigned cand = key | (1u << bit);
    unsigned c = 0;
#pragma unroll
    for (int h = 0; h < 4; ++h) c += heads[h] >= cand;
    if (__reduce_add_sync(FULL_MASK, c) >= (unsigned)k) key = cand;
  }
  const float bound = key_float(max(key, bounds[q]));
  int have = 0;  // gathered candidates in cv / cr, fewer than 32
  for (int j0 = 0; j0 < total; j0 += 32 * MERGE_BATCH) {
    float v[MERGE_BATCH];  // loaded together: one wait for the batch
    int r[MERGE_BATCH];
#pragma unroll
    for (int b = 0; b < MERGE_BATCH; ++b) {
      const int j = j0 + 32 * b + lane;
      v[b] = j < total ? part_vals[base + j] : -INFINITY;
      r[b] = j < total ? part_rows[base + j] : -1;
    }
#pragma unroll
    for (int b = 0; b < MERGE_BATCH; ++b) {
      const bool keep = r[b] >= 0 && v[b] >= bound;
      const unsigned ball = __ballot_sync(FULL_MASK, keep);
      if (keep) {
        const int pos = have + __popc(ball & ((1u << lane) - 1u));
        cv[pos] = v[b];
        cr[pos] = r[b];
      }
      have += __popc(ball);
      __syncwarp();
      if (have >= 32) {
        merge_into<KW>(lv, lr, cv[lane], cr[lane], k, lane);
        have -= 32;
        const float mv = cv[32 + lane];
        const int mr = cr[32 + lane];
        __syncwarp();
        if (lane < have) {
          cv[lane] = mv;
          cr[lane] = mr;
        }
        __syncwarp();
      }
    }
  }
  if (have > 0) {
    merge_into<KW>(lv, lr, lane < have ? cv[lane] : -INFINITY,
                   lane < have ? cr[lane] : INT_MAX, k, lane);
  }
  for (int i = lane; i < k; i += 32) {
    const bool filled = lr[i] != INT_MAX;
    out_vals[(size_t)q * k + i] = filled ? lv[i] : NEG_INF_F;
    out_rows[(size_t)q * k + i] = filled ? lr[i] : -1;
  }
}

typedef void (*KernelFn)(const CUtensorMap, const float*, const float*, float*,
                         int*, unsigned*, int, int, int, int, int, int, int);

// The kernel for (d, k), its block size, ring depth and shared memory:
// two consumer warpgroups where their lists leave room for 3 stages,
// else one, with as many stages as fit up to MAX_STAGES; no kernel if
// not even MIN_STAGES fit.
struct Config {
  KernelFn fn;
  int wgs, threads, stages, smem;
};

template <int KW>
KernelFn kernel_for(int wgs) {
  return wgs == 2 ? topk_scan_kernel<KW, 2> : topk_scan_kernel<KW, 1>;
}

Config find_config(int dev, int d, int k) {
  Config cfg = {nullptr, 0, 0, 0, 0};
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return cfg;
  }
  for (int wgs = 2; wgs >= 1; --wgs) {
    for (int s = MAX_STAGES; s >= (wgs == 2 ? 3 : MIN_STAGES); --s) {
      const int bytes = layout(d, k, s, wgs).bytes;
      if (bytes <= optin) {
        const int kw = (k + 31) / 32;
        cfg.fn = kw == 1   ? kernel_for<1>(wgs)
                 : kw == 2 ? kernel_for<2>(wgs)
                           : kernel_for<4>(wgs);
        cfg.wgs = wgs;
        cfg.threads = wgs * 128 + 32;
        cfg.stages = s;
        cfg.smem = bytes;
        if (cudaFuncSetAttribute(cfg.fn,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bytes) != cudaSuccess) {
          cfg.fn = nullptr;
        }
        return cfg;
      }
    }
  }
  return cfg;
}

// find_config for the current device, kept for the last (device, d, k)
// each host thread asked about: a launch costs no attribute calls.
Config pick_config(int d, int k) {
  thread_local int last_dev = -1, last_d = 0, last_k = 0;
  thread_local Config last = {nullptr, 0, 0, 0, 0};
  int dev = 0;
  if (d <= 0 || k < 1 || k > MAX_K || cudaGetDevice(&dev) != cudaSuccess) {
    return Config{nullptr, 0, 0, 0, 0};
  }
  if (dev != last_dev || d != last_d || k != last_k) {
    last = find_config(dev, d, k);
    last_dev = dev;
    last_d = d;
    last_k = k;
  }
  return last;
}

}  // namespace

extern "C" {

int topk_scan_tile_rows() { return TN; }

int topk_scan_block_queries() { return QB; }

int topk_scan_max_k() { return MAX_K; }

// u32 words of scratch a launch takes: each query's bound and pool.
int topk_scan_scratch_words(int nq, int n_slices) {
  return nq * (1 + 2 * POOL_TOP * n_slices);
}

// Lists the scan writes per query and slice for (d, k): one per consumer
// warpgroup.
int topk_scan_lists_per_slice(int d, int k) { return pick_config(d, k).wgs; }

// Blocks of this kernel the card holds at once for (d, k); 0 if one
// block's shared memory (resident queries, ring, lists) does not fit.
int topk_scan_resident_blocks(int d, int k) {
  const Config cfg = pick_config(d, k);
  int dev = 0, sms = 0, per_sm = 0;
  if (cfg.fn == nullptr || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cfg.fn,
                                                    cfg.threads, cfg.smem) !=
          cudaSuccess) {
    return 0;
  }
  return per_sm * sms;
}

// Launches the scan on ``stream`` over n_slices slices of slice_rows
// rows (a multiple of the tile; the last slice may be short), writing
// topk_scan_lists_per_slice() lists a slice, after zeroing ``bounds``
// (topk_scan_scratch_words() of u32 scratch). Returns 0 or a cudaError_t
// (a tensor-map failure as cudaErrorUnknown).
int topk_scan_launch(const void* emb, const void* queries, const void* bias,
                     void* out_vals, void* out_rows, void* bounds, int n,
                     int d, int nq, int k, int n_slices, int slice_rows,
                     void* stream) {
  if (n <= 0 || nq <= 0 || k < 1 || k > MAX_K || d <= 0 || d % 8 != 0 ||
      slice_rows <= 0 || slice_rows % TN != 0 ||
      n_slices != (n + slice_rows - 1) / slice_rows || n_slices > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const Config cfg = pick_config(d, k);
  if (cfg.fn == nullptr) return (int)cudaErrorInvalidValue;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorUnknown;

  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {(cuuint32_t)KC, (cuuint32_t)TN};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(emb), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return (int)cudaErrorUnknown;
  }
  cudaError_t err = cudaMemsetAsync(
      bounds, 0, (size_t)topk_scan_scratch_words(nq, n_slices) * 4,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + QB - 1) / QB, n_slices);
  cfg.fn<<<grid, cfg.threads, cfg.smem, (cudaStream_t)stream>>>(
      map, static_cast<const float*>(queries), static_cast<const float*>(bias),
      static_cast<float*>(out_vals), static_cast<int*>(out_rows),
      static_cast<unsigned*>(bounds), n, d, nq, k, n_slices, slice_rows,
      cfg.stages);
  return (int)cudaGetLastError();
}

// Launches the merge of a scan's lists into out_vals / out_rows
// ([Q, k]; unfilled slots (NEG_INF, -1)) on ``stream``.
int topk_merge_launch(const void* part_vals, const void* part_rows,
                      const void* bounds, void* out_vals, void* out_rows,
                      int nq, int n_lists, int k, void* stream) {
  if (nq <= 0 || n_lists <= 0 || k < 1 || k > MAX_K) {
    return (int)cudaErrorInvalidValue;
  }
  const int kw = (k + 31) / 32;
  void (*fn)(const float*, const int*, const unsigned*, float*, int*, int, int,
             int) = kw == 1   ? topk_merge_kernel<1>
                    : kw == 2 ? topk_merge_kernel<2>
                              : topk_merge_kernel<4>;
  fn<<<(nq + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32, 0,
       (cudaStream_t)stream>>>(
      static_cast<const float*>(part_vals), static_cast<const int*>(part_rows),
      static_cast<const unsigned*>(bounds), static_cast<float*>(out_vals),
      static_cast<int*>(out_rows), nq, n_lists, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
