// Masked dense scan with a per-chunk exact top-k, for Hopper (sm_90a).
//
// Replaces the TPU kernel classmate_rag_tpu/ops/topk.py::topk_pallas:
//   scores[q, n] = bf16(queries[q]) . emb[n] + mask_bias[n]   (f32 sums)
// and, for every query, the k best (score desc, row asc) rows. The full
// [Q, N] score matrix is never written to device memory: each block
// keeps a running top-k per query in shared memory and writes only that
// list, [Q, n_chunks, k]. The wrapper (ops/topk.py) merges the chunk
// lists with a stable descending sort, which keeps lowest-row-first
// among equal scores because chunk lists ascend by row at equal scores.
//
// Grid: (query blocks of QB rows) x (corpus chunks of CHUNK_ROWS rows);
// the query-block index varies fastest, so the blocks that read one
// corpus chunk run side by side and share it through L2.
// Each block, per sub-tile of TN corpus rows:
//   1. streams the query rows (f32 -> bf16) and the sub-tile in KC-wide
//      slices of d through shared memory and accumulates
//      Q_blk . E_tile^T in f32 on the tensor cores (WMMA 16x16x16 bf16);
//   2. adds mask_bias and merges the TN new scores of each query into
//      that query's sorted top-k list (one warp per query, insertion only
//      for scores that beat the current k-th entry).
//
// What bounds it on an H100: the corpus read. At the serving shape
// (N = 262,144 rows of d = 768 bf16, Q = 256, k = 32) the kernel must
// move 403 MB, 120 us at 3.35 TB/s, against 103 GFLOP, 104 us at
// 989 TFLOP/s bf16: memory-bound, barely. This first version is simple
// rather than fast: synchronous global->shared copies, no cp.async/TMA
// pipeline and no wgmma; several blocks per SM hide part of the latency.
// The top-k merge runs on the CUDA cores while other blocks on the SM
// use the tensor cores.
//
// Sentinels: rows past N are never candidates; a list slot never filled
// reports (NEG_INF, -1). Scores of masked rows are score + NEG_INF,
// which rounds to NEG_INF, exactly as in the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <climits>
#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int QB = 64;          // queries per block
constexpr int TN = 128;         // corpus rows per sub-tile
constexpr int KC = 64;          // slice of d staged per step
constexpr int SUBTILES = 16;    // sub-tiles per block
constexpr int CHUNK_ROWS = TN * SUBTILES;
constexpr int THREADS = 256;    // 8 warps
constexpr int LDA = KC + 8;     // padded smem strides (bank conflicts)
constexpr int LDS = TN + 4;
constexpr int MAX_K = 128;
constexpr float NEG_INF_F = -3.4028234663852886e38f;  // f32 min

constexpr int SQ_BYTES = QB * LDA * 2;
constexpr int SE_BYTES = TN * LDA * 2;
constexpr int SS_BYTES = QB * LDS * 4;
constexpr int STAGE_BYTES =
    (SQ_BYTES + SE_BYTES) > SS_BYTES ? (SQ_BYTES + SE_BYTES) : SS_BYTES;

__device__ __forceinline__ bool beats(float av, int ar, float bv, int br) {
  return av > bv || (av == bv && ar < br);
}

__global__ void __launch_bounds__(THREADS)
topk_scan_kernel(const __nv_bfloat16* __restrict__ emb,   // [N, d]
                 const float* __restrict__ queries,       // [Q, d]
                 const float* __restrict__ bias,          // [N]
                 float* __restrict__ out_vals,            // [Q, n_chunks, k]
                 int* __restrict__ out_rows,              // [Q, n_chunks, k]
                 int n, int d, int nq, int k, int n_chunks) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sE = reinterpret_cast<__nv_bfloat16*>(smem + SQ_BYTES);
  float* sS = reinterpret_cast<float*>(smem);  // aliases sQ/sE
  float* sBias = reinterpret_cast<float*>(smem + STAGE_BYTES);
  float* Lv = sBias + TN;                       // [QB, k]
  int* Lr = reinterpret_cast<int*>(Lv + QB * k);  // [QB, k]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int qb = blockIdx.x;
  const int chunk = blockIdx.y;
  const int q0 = qb * QB;
  const int chunk_row0 = chunk * CHUNK_ROWS;

  for (int i = tid; i < QB * k; i += THREADS) {
    Lv[i] = -INFINITY;
    Lr[i] = INT_MAX;
  }

  // Warp tile of the 64 x 128 score block: 16 rows x 64 columns.
  const int wr = warp >> 1;
  const int wc = warp & 1;

  for (int sub = 0; sub < SUBTILES; ++sub) {
    const int row0 = chunk_row0 + sub * TN;
    if (row0 >= n) break;  // uniform across the block

    if (tid < TN) {
      const int r = row0 + tid;
      sBias[tid] = r < n ? bias[r] : 0.0f;
    }

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);

    for (int kc = 0; kc < d; kc += KC) {
      // Query slice: QB x KC f32 -> bf16 (4 floats per thread-step).
#pragma unroll
      for (int it = 0; it < (QB * KC / 4) / THREADS; ++it) {
        const int idx = tid + it * THREADS;
        const int r = idx / (KC / 4);
        const int c = (idx % (KC / 4)) * 4;
        const int q = q0 + r;
        const int col = kc + c;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q < nq && col < d) {
          v = *reinterpret_cast<const float4*>(queries + (size_t)q * d + col);
        }
        __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
        __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
        uint2 packed;
        packed.x = *reinterpret_cast<uint32_t*>(&lo);
        packed.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(sQ + r * LDA + c) = packed;
      }
      // Corpus slice: TN x KC bf16 (8 values = 16 bytes per thread-step).
#pragma unroll
      for (int it = 0; it < (TN * KC / 8) / THREADS; ++it) {
        const int idx = tid + it * THREADS;
        const int r = idx / (KC / 8);
        const int c = (idx % (KC / 8)) * 8;
        const int row = row0 + r;
        const int col = kc + c;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row < n && col < d) {
          v = *reinterpret_cast<const uint4*>(emb + (size_t)row * d + col);
        }
        *reinterpret_cast<uint4*>(sE + r * LDA + c) = v;
      }
      __syncthreads();

#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, sQ + (wr * 16) * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // B = E_tile^T: element (kk, n) sits at sE[n * LDA + kk],
          // i.e. column-major with leading dimension LDA.
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> b;
          wmma::load_matrix_sync(b, sE + (wc * 64 + j * 16) * LDA + kk, LDA);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(sS + (wr * 16) * LDS + wc * 64 + j * 16,
                              acc[j], LDS, wmma::mem_row_major);
    }
    __syncthreads();

    // Merge: warp w owns queries w, w + 8, ...; lane holds columns
    // lane, lane + 32, lane + 64, lane + 96 of the sub-tile.
    for (int ql = warp; ql < QB; ql += THREADS / 32) {
      if (q0 + ql >= nq) break;  // uniform across the warp
      float* lv = Lv + ql * k;
      int* lr = Lr + ql * k;
      float s[4];
      int row[4];
      bool cand[4];
      float tv = lv[k - 1];
      int tr = lr[k - 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = lane + 32 * j;
        row[j] = row0 + c;
        s[j] = sS[ql * LDS + c] + sBias[c];
        cand[j] = row[j] < n && beats(s[j], row[j], tv, tr);
      }
      while (__any_sync(0xffffffffu, cand[0] | cand[1] | cand[2] | cand[3])) {
        // Best candidate of this lane, then of the warp. A lane with no
        // candidate offers (-inf, INT_MAX), which every real row beats.
        float bv = -INFINITY;
        int br = INT_MAX;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (cand[j] && beats(s[j], row[j], bv, br)) {
            bv = s[j];
            br = row[j];
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
          const int orr = __shfl_xor_sync(0xffffffffu, br, off);
          if (beats(ov, orr, bv, br)) {
            bv = ov;
            br = orr;
          }
        }
        // Insert at p = number of list entries that beat the winner.
        int cnt = 0;
        for (int i = lane; i < k; i += 32) cnt += beats(lv[i], lr[i], bv, br);
        const int p = __reduce_add_sync(0xffffffffu, cnt);
        float mv[MAX_K / 32];
        int mr[MAX_K / 32];
#pragma unroll
        for (int m = 0; m < MAX_K / 32; ++m) {
          const int i = lane + 32 * m;
          if (i >= p && i < k - 1) {
            mv[m] = lv[i];
            mr[m] = lr[i];
          }
        }
        __syncwarp();
#pragma unroll
        for (int m = 0; m < MAX_K / 32; ++m) {
          const int i = lane + 32 * m;
          if (i >= p && i < k - 1) {
            lv[i + 1] = mv[m];
            lr[i + 1] = mr[m];
          }
        }
        __syncwarp();
        if (lane == 0) {
          lv[p] = bv;
          lr[p] = br;
        }
        __syncwarp();
        tv = lv[k - 1];
        tr = lr[k - 1];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cand[j] = cand[j] && row[j] != br && beats(s[j], row[j], tv, tr);
        }
      }
    }
    __syncthreads();  // sS is overwritten by the next sub-tile's slices
  }

  for (int i = tid; i < QB * k; i += THREADS) {
    const int q = q0 + i / k;
    if (q >= nq) continue;
    float v = Lv[i];
    int r = Lr[i];
    if (r == INT_MAX) {
      v = NEG_INF_F;
      r = -1;
    }
    const size_t o = ((size_t)q * n_chunks + chunk) * k + (i % k);
    out_vals[o] = v;
    out_rows[o] = r;
  }
}

}  // namespace

extern "C" {

int topk_scan_chunk_rows() { return CHUNK_ROWS; }

int topk_scan_max_k() { return MAX_K; }

// Launches the scan on ``stream``. Returns 0 or the cudaError_t of the
// attribute call or the launch (cudaGetLastError right after it).
int topk_scan_launch(const void* emb, const void* queries, const void* bias,
                     void* out_vals, void* out_rows, int n, int d, int nq,
                     int k, int n_chunks, void* stream) {
  if (n <= 0 || nq <= 0 || k < 1 || k > MAX_K || d <= 0 || d % 8 != 0 ||
      n_chunks != (n + CHUNK_ROWS - 1) / CHUNK_ROWS || n_chunks > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = STAGE_BYTES + TN * 4 + QB * k * 8;
  cudaError_t err = cudaFuncSetAttribute(
      topk_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nq + QB - 1) / QB, n_chunks);
  topk_scan_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(emb),
      static_cast<const float*>(queries), static_cast<const float*>(bias),
      static_cast<float*>(out_vals), static_cast<int*>(out_rows), n, d, nq, k,
      n_chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
