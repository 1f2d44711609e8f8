// Row top-k of a score matrix plus a bias, for Hopper (sm_90a): BM25's
// selection in the fused step (ops/hybrid_step.py bm25_select).
//
// For every row b of scores [B, N] (f32) and bias [N] (f32): the first k
// entries of torch.sort(scores[b] + bias, descending=True, stable=True),
// bit for bit: value descending, then row ascending. A value is the same
// f32 add as the plain version's ``scores + bias[None, :]``.
//
// Replaces no TPU kernel: the JAX package leaves this selection to XLA
// (lax.top_k on the exact route, lax.approx_max_k on the approx route;
// classmate_rag_tpu/ops/hybrid_step.py). The port ran it as a stable sort
// of every whole row (a radix sort a row at 1M columns), which wrote the
// sorted [B, N] values and indices to keep 8 to 64 columns of them.
//
// What bounds it on an H100: one read of the scores, B * N * 4 bytes
// ([256, 1,048,576]: 1.07 GB -> 0.32 ms at 3.35 TB/s); the bias (4 MB at
// 1M) is read by every row from L2. The design keeps to the one read:
//
// - Order: a value compares by the radix sort's key (its f32 bits mapped
//   to an unsigned of the same order, -0.0 taken as +0.0, as the radix
//   sort takes it), then by row. An entry is the u64 (key << 32 | ~row):
//   larger is better, the order is one integer compare, and the first k
//   are one set in one order whatever the order of arrival. Entry 0 (row
//   0xffffffff) is the empty slot, below every real entry.
// - Grid (B, slices). When B fills the card, one slice a row: the block
//   walks its row and writes the answer (one launch). Otherwise each row
//   is cut into slices so that the grid holds about two blocks an SM, and
//   row_select_merge_kernel merges each row's slice lists (a second one).
// - Each warp walks its own contiguous part of the slice in ascending
//   rows, U 16-byte loads a lane in flight (the scores streamed, the bias
//   left in L2 for the other rows), and keeps a running top-k list in
//   shared memory. A value is a candidate only if its entry beats the
//   list's k-th: one compare a value and one vote a step of the warp. The
//   walk ascends, so an equal value (a later row) never enters: BM25 rows
//   are mostly exact zeros, and once k zeros are in the list no later
//   zero is. Candidates go to a 64-entry buffer; at 32 a warp bitonic
//   network merges them into the list and the k-th rises.
// - The warps' lists merge in a tree into warp 0's (log2 WARPS rounds,
//   each cut short where the other list falls below the k-th).
// - Each block adds its candidates to the launch's counter (one atomicAdd):
//   how often the filter let a value through.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

typedef unsigned long long Entry;

constexpr int WARPS = 16;        // warps a block
constexpr int U = 4;             // 16-byte loads a lane keeps in flight
constexpr int MAX_K = 256;
constexpr int MAX_N = 1 << 30;   // columns a row; keeps row arithmetic in int
constexpr int CAP = 64;          // candidate buffer entries a warp
constexpr int MERGE_WARPS = 4;   // rows a merge block
constexpr int MERGE_BATCH = 8;   // 32-entry loads in flight a merge warp
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float NEG_INF_F = -3.4028234663852886e38f;  // f32 min

__device__ __forceinline__ unsigned radix_key(float f) {
  unsigned u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;  // -0.0 sorts as +0.0
  return u ^ ((unsigned)((int)u >> 31) | 0x80000000u);
}

__device__ __forceinline__ Entry make_entry(unsigned key, int row) {
  return ((Entry)key << 32) | (unsigned)~row;
}

__device__ __forceinline__ int entry_row(Entry e) {
  return (int)~(unsigned)e;
}

// One compare-exchange of a bitonic network over the 32 lanes: lane and
// lane ^ stride compare; the lower lane keeps the larger entry in a
// descending block and the smaller one in an ascending block.
__device__ __forceinline__ void exchange(Entry& v, int stride, bool descending,
                                         int lane) {
  const Entry o = __shfl_xor_sync(FULL_MASK, v, stride);
  const bool keep_larger = ((lane & stride) == 0) == descending;
  if ((o > v) == keep_larger) v = o;
}

// A bitonic sequence over the lanes -> descending.
__device__ __forceinline__ void bitonic_merge(Entry& v, int lane) {
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    exchange(v, stride, true, lane);
  }
}

// Merges up to 32 candidates (lane j holds one, 0 for none) into a sorted
// list of k <= 32 * KW entries in shared memory: sort the candidates, then
// pass them down the list 32 entries at a time; at each step the larger
// half of (segment, candidates) is the new segment and the rest goes on.
template <int KW>
__device__ __forceinline__ void merge_into(Entry* list, Entry c, int k,
                                           int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      exchange(c, stride, (lane & size) == 0, lane);
    }
  }
#pragma unroll
  for (int u = 0; u < KW; ++u) {
    const int i = 32 * u + lane;
    Entry s = i < k ? list[i] : 0ull;
    // Segment against the reversed candidates: the larger of each pair
    // are the best 32 of both (a bitonic sequence), the smaller the rest.
    const Entry r = __shfl_sync(FULL_MASK, c, 31 - lane);
    const bool cand_larger = r > s;
    c = cand_larger ? s : r;
    if (cand_larger) s = r;
    bitonic_merge(s, lane);
    if (i < k) list[i] = s;
    if (u + 1 < KW) bitonic_merge(c, lane);
  }
  __syncwarp();
}

// Appends the lanes' kept entries (``ball`` their vote) to the warp's
// buffer, which holds ``have`` < 32 of them; at 32 merges the first 32
// into the list. Returns the buffer's new count.
template <int KW>
__device__ __forceinline__ int push(Entry* list, Entry* buf, int have,
                                    Entry e, bool keep, unsigned ball, int k,
                                    int lane) {
  if (keep) buf[have + __popc(ball & ((1u << lane) - 1u))] = e;
  have += __popc(ball);
  __syncwarp();
  if (have >= 32) {
    merge_into<KW>(list, buf[lane], k, lane);
    have -= 32;
    const Entry rest = buf[32 + lane];
    __syncwarp();
    if (lane < have) buf[lane] = rest;
    __syncwarp();
  }
  return have;
}

// Writes a finished list as the row's answer: rows (int64) and values,
// each value recomputed as the same f32 add; an empty slot (none when
// k <= N) as (NEG_INF, -1).
__device__ __forceinline__ void write_answer(const Entry* list,
                                             const float* row,
                                             const float* bias,
                                             float* out_vals,
                                             long long* out_rows, int k,
                                             int lane) {
  for (int i = lane; i < k; i += 32) {
    const Entry e = list[i];
    if (e == 0ull) {
      out_rows[i] = -1;
      out_vals[i] = NEG_INF_F;
    } else {
      const int r = entry_row(e);
      out_rows[i] = r;
      out_vals[i] = row[r] + bias[r];
    }
  }
}

// One block: one slice of one row. ``scratch`` holds the launch's
// counter, then with more than one slice a row the slices' lists
// [B, S, k].
template <int KW, int VEC>
__global__ void __launch_bounds__(WARPS * 32, 2)
    row_select_kernel(const float* __restrict__ scores,  // [B, N]
                      const float* __restrict__ bias,    // [N]
                      float* __restrict__ out_vals,      // [B, k]
                      long long* __restrict__ out_rows,  // [B, k]
                      Entry* __restrict__ scratch, int n, int k,
                      int slice_rows) {
  __shared__ Entry lists[WARPS][32 * KW];
  __shared__ Entry bufs[WARPS][CAP];
  __shared__ unsigned warp_in[WARPS];
  constexpr int G = 32 * VEC;  // rows of one load across the warp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const int s = blockIdx.y;
  Entry* list = lists[warp];
  Entry* buf = bufs[warp];
  for (int i = lane; i < k; i += 32) list[i] = 0ull;
  __syncwarp();

  // The warp's part of the slice: whole loads, in ascending rows.
  const int lo = s * slice_rows;
  const int hi = min(n, lo + slice_rows);
  const int part = (hi - lo + WARPS * G - 1) / (WARPS * G) * G;
  const int w_lo = min(hi, lo + warp * part);
  const int w_hi = min(hi, w_lo + part);
  const float* row = scores + (size_t)b * n;

  Entry gate = 0ull;  // the list's k-th entry
  int have = 0;
  unsigned admitted = 0;
  for (int base = w_lo; base < w_hi; base += U * G) {
    float v[U][VEC];
    if constexpr (VEC == 4) {
      float4 a[U], c[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r0 = base + (u * 32 + lane) * 4;
        a[u] = c[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r0 < w_hi) {
          a[u] = __ldcs(reinterpret_cast<const float4*>(row + r0));
          c[u] = __ldg(reinterpret_cast<const float4*>(bias + r0));
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        v[u][0] = a[u].x + c[u].x;
        v[u][1] = a[u].y + c[u].y;
        v[u][2] = a[u].z + c[u].z;
        v[u][3] = a[u].w + c[u].w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r0 = base + u * 32 + lane;
        v[u][0] = r0 < w_hi ? __ldcs(row + r0) + __ldg(bias + r0) : 0.f;
      }
    }
    unsigned key[U][VEC];
    bool any = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int r = base + (u * 32 + lane) * VEC + j;
        key[u][j] = radix_key(v[u][j]);
        any |= r < w_hi && make_entry(key[u][j], r) > gate;
      }
    }
    if (!__any_sync(FULL_MASK, any)) continue;
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int r = base + (u * 32 + lane) * VEC + j;
        const Entry e = make_entry(key[u][j], r);
        const bool keep = r < w_hi && e > gate;
        const unsigned ball = __ballot_sync(FULL_MASK, keep);
        if (ball != 0u) {
          have = push<KW>(list, buf, have, e, keep, ball, k, lane);
          admitted += __popc(ball);
          gate = list[k - 1];
        }
      }
    }
  }
  if (have > 0) merge_into<KW>(list, lane < have ? buf[lane] : 0ull, k, lane);
  if (lane == 0) warp_in[warp] = admitted;
  __syncthreads();

#pragma unroll 1
  for (int step = 1; step < WARPS; step <<= 1) {
    if ((warp & (2 * step - 1)) == 0) {
      const Entry* other = lists[warp + step];
      for (int c0 = 0; c0 < k; c0 += 32) {
        const Entry cand = c0 + lane < k ? other[c0 + lane] : 0ull;
        if (!__any_sync(FULL_MASK, cand > list[k - 1])) break;
        merge_into<KW>(list, cand, k, lane);
      }
    }
    __syncthreads();
  }

  if (warp != 0) return;
  if (gridDim.y == 1) {
    write_answer(list, row, bias, out_vals + (size_t)b * k,
                 out_rows + (size_t)b * k, k, lane);
  } else {
    Entry* out = scratch + 1 + ((size_t)b * gridDim.y + s) * k;
    for (int i = lane; i < k; i += 32) out[i] = list[i];
  }
  if (lane == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < WARPS; ++w) total += warp_in[w];
    if (total != 0) atomicAdd(scratch, total);
  }
}

// One warp a row: merges the row's slice lists (each sorted, rows
// distinct across them) into its answer.
template <int KW>
__global__ void __launch_bounds__(MERGE_WARPS * 32)
    row_select_merge_kernel(const float* __restrict__ scores,  // [B, N]
                            const float* __restrict__ bias,    // [N]
                            float* __restrict__ out_vals,      // [B, k]
                            long long* __restrict__ out_rows,  // [B, k]
                            const Entry* __restrict__ scratch, int nb, int n,
                            int k, int n_slices) {
  __shared__ Entry lists[MERGE_WARPS][32 * KW];
  __shared__ Entry bufs[MERGE_WARPS][CAP];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * MERGE_WARPS + warp;
  if (b >= nb) return;  // the whole warp
  Entry* list = lists[warp];
  Entry* buf = bufs[warp];
  for (int i = lane; i < k; i += 32) list[i] = 0ull;
  __syncwarp();
  const Entry* parts = scratch + 1 + (size_t)b * n_slices * k;
  const int total = n_slices * k;
  Entry gate = 0ull;
  int have = 0;
  for (int j0 = 0; j0 < total; j0 += 32 * MERGE_BATCH) {
    Entry e[MERGE_BATCH];  // loaded together: one wait for the batch
#pragma unroll
    for (int i = 0; i < MERGE_BATCH; ++i) {
      const int j = j0 + 32 * i + lane;
      e[i] = j < total ? parts[j] : 0ull;
    }
#pragma unroll
    for (int i = 0; i < MERGE_BATCH; ++i) {
      const bool keep = e[i] > gate;
      const unsigned ball = __ballot_sync(FULL_MASK, keep);
      if (ball != 0u) {
        have = push<KW>(list, buf, have, e[i], keep, ball, k, lane);
        gate = list[k - 1];
      }
    }
  }
  if (have > 0) merge_into<KW>(list, lane < have ? buf[lane] : 0ull, k, lane);
  write_answer(list, scores + (size_t)b * n, bias, out_vals + (size_t)b * k,
               out_rows + (size_t)b * k, k, lane);
}

typedef void (*SelectFn)(const float*, const float*, float*, long long*,
                         Entry*, int, int, int);
typedef void (*MergeFn)(const float*, const float*, float*, long long*,
                        const Entry*, int, int, int, int);

// List width in warps of 32 entries: 1, 2, 4 or 8.
int list_warps(int k) {
  const int kw = (k + 31) / 32;
  return kw <= 1 ? 1 : kw <= 2 ? 2 : kw <= 4 ? 4 : 8;
}

template <int VEC>
SelectFn select_fn(int kw) {
  return kw == 1   ? row_select_kernel<1, VEC>
         : kw == 2 ? row_select_kernel<2, VEC>
         : kw == 4 ? row_select_kernel<4, VEC>
                   : row_select_kernel<8, VEC>;
}

}  // namespace

extern "C" {

int row_select_max_k() { return MAX_K; }

int row_select_max_n() { return MAX_N; }

int row_select_warps() { return WARPS; }

// Rows one step of a warp covers with 16-byte loads; a slice is a
// multiple of it.
int row_select_step_rows() { return U * 32 * 4; }

// Launches the walk on ``stream`` over n_slices slices of slice_rows rows
// a row (the last may be short), after zeroing the counter (the first
// u64 of ``scratch``). With one slice it writes out_vals [B, k] (f32) and
// out_rows [B, k] (int64); with more, the slices' lists after the counter
// in ``scratch`` (B * n_slices * k u64), for row_select_merge_launch.
// 16-byte loads where N is a multiple of 4 and both inputs are 16-byte
// aligned, else 4-byte ones. Returns 0 or a cudaError_t.
int row_select_launch(const void* scores, const void* bias, void* out_vals,
                      void* out_rows, void* scratch, int nb, int n, int k,
                      int n_slices, int slice_rows, void* stream) {
  if (nb <= 0 || n <= 0 || n > MAX_N || k < 1 || k > MAX_K || k > n ||
      slice_rows <= 0 || slice_rows % row_select_step_rows() != 0 ||
      n_slices != (n + slice_rows - 1) / slice_rows || n_slices > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, sizeof(Entry), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const bool wide = n % 4 == 0 && (uintptr_t)scores % 16 == 0 &&
                    (uintptr_t)bias % 16 == 0;
  const int kw = list_warps(k);
  const SelectFn fn = wide ? select_fn<4>(kw) : select_fn<1>(kw);
  dim3 grid(nb, n_slices);
  fn<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(scores), static_cast<const float*>(bias),
      static_cast<float*>(out_vals), static_cast<long long*>(out_rows),
      static_cast<Entry*>(scratch), n, k, slice_rows);
  return (int)cudaGetLastError();
}

// Launches the merge of a walk's slice lists into out_vals / out_rows on
// ``stream``. Returns 0 or a cudaError_t.
int row_select_merge_launch(const void* scores, const void* bias,
                            void* out_vals, void* out_rows,
                            const void* scratch, int nb, int n, int k,
                            int n_slices, void* stream) {
  if (nb <= 0 || n <= 0 || n > MAX_N || k < 1 || k > MAX_K || k > n ||
      n_slices < 2) {
    return (int)cudaErrorInvalidValue;
  }
  const int kw = list_warps(k);
  const MergeFn fn = kw == 1   ? row_select_merge_kernel<1>
                     : kw == 2 ? row_select_merge_kernel<2>
                     : kw == 4 ? row_select_merge_kernel<4>
                               : row_select_merge_kernel<8>;
  fn<<<(nb + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32, 0,
       (cudaStream_t)stream>>>(
      static_cast<const float*>(scores), static_cast<const float*>(bias),
      static_cast<float*>(out_vals), static_cast<long long*>(out_rows),
      static_cast<const Entry*>(scratch), nb, n, k, n_slices);
  return (int)cudaGetLastError();
}

}  // extern "C"
