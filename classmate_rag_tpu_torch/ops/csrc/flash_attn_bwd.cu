// Backward of the non-causal flash attention with a key-padding mask
// (flash_attn.cu), for Hopper (sm_90a): two kernels.
//
// Replaces the backward of the TPU library kernel jax.experimental.pallas.
// ops.tpu.flash_attention (jax 0.9.0), which the JAX package reaches when
// contrastive.py:155 takes the gradient of the encoder with its flash
// gate open:
//   _flash_attention_bwd_dkv (flash_attention.py:941, pallas_call :1121)
//     -> flash_attn_bwd_dkv_kernel: a block per (key tile, head, batch
//        row) walks the query tiles;
//   _flash_attention_bwd_dq (flash_attention.py:1287, pallas_call :1456)
//     -> flash_attn_bwd_dq_kernel: a block per (query tile, head, batch
//        row) walks the key tiles.
// Both recompute the probabilities from the forward's log-sum-exp:
//   x[q, k]  = (Q[q] . K[k]) * sm_scale * log2(e) + bias[k]
//   P[q, k]  = 2^(x[q, k] - lse[q])             (lse in base 2)
//   dP       = dO V^T
//   dS       = P o (dP - D[q]),   D[q] = sum_d O[q, d] dO[q, d]
//   dV = P^T dO,  dK = dS^T Q * sm_scale,  dQ = dS K * sm_scale
// bias is the forward's: 0 for a real key, NEG_INF (f32 min, added) for
// a pad key, -inf past T. D is computed outside, by torch, as the JAX
// backward computes it outside its kernels (_flash_attention_bwd
// :273-275).
//
// Masking follows the port's forward, not the TPU kernel's segment ids.
// A pad key gets P = 0 in every row of a batch row that has a real key,
// so its dK and dV are 0. A batch row with no real key is a uniform
// softmax over its T keys in the forward (every logit is NEG_INF); here
// P = 1/T there, as the plain version's autograd gives. Pad query rows
// are ordinary rows; the encoder's pooling drops them, so their dO is 0,
// and then dQ, dK and dV on real tokens equal the segment-id version's.
//
// What bounds it on an H100: at T <= 512 and head_dim 64 the work is 7
// products of 64 x 64 x 64 for each (query tile, key tile) pair (S and
// dP in both kernels, dV and dK in one, dQ in the other), ~2/3 of them
// in the dkv kernel; bytes are q, k, v, dO read and dq, dk, dv written
// once. Tensor-core work bounds it above T ~ 128. This first design is
// simple: WMMA bf16 16x16x16 products with f32 sums, each warp owning
// 16 rows of the 64-row tile, tiles staged through shared memory with
// 16-byte loads, the softmax's elementwise step on the staged f32 S and
// dP. No TMA, no wgmma and no overlap of copies with products: that is
// a later redesign (one fused dkv+dq pass, wgmma, a TMA ring).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int D = 64;          // head_dim
constexpr int BT = 64;         // rows of a query or key tile
constexpr int THREADS = 128;   // 4 warps, 16 rows of a tile each
constexpr int LDH = D + 8;     // bf16 tile row stride (elements)
constexpr int LDF = BT + 4;    // f32 tile row stride (elements)
constexpr int TILE_H = BT * LDH * 2;  // bytes of a bf16 tile
constexpr int TILE_F = BT * LDF * 4;  // bytes of an f32 tile
// Shared memory: 6 bf16 tiles (the two walked-over operands, the two
// resident ones, P and dS), 2 f32 tiles (S and dP) and 3 row vectors.
constexpr int SMEM_BYTES = 6 * TILE_H + 2 * TILE_F + 3 * BT * 4;
constexpr float NEG_INF_F = -3.4028234663852886e38f;  // f32 min
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
    FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    FragBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct Smem {
  bf16 *walk0, *walk1, *res0, *res1, *p, *ds;
  float *s, *dp, *bias, *lse, *delta;
};

__device__ __forceinline__ Smem carve(unsigned char* raw) {
  Smem m;
  m.walk0 = reinterpret_cast<bf16*>(raw);
  m.walk1 = reinterpret_cast<bf16*>(raw + TILE_H);
  m.res0 = reinterpret_cast<bf16*>(raw + 2 * TILE_H);
  m.res1 = reinterpret_cast<bf16*>(raw + 3 * TILE_H);
  m.p = reinterpret_cast<bf16*>(raw + 4 * TILE_H);
  m.ds = reinterpret_cast<bf16*>(raw + 5 * TILE_H);
  m.s = reinterpret_cast<float*>(raw + 6 * TILE_H);
  m.dp = reinterpret_cast<float*>(raw + 6 * TILE_H + TILE_F);
  m.bias = reinterpret_cast<float*>(raw + 6 * TILE_H + 2 * TILE_F);
  m.lse = m.bias + BT;
  m.delta = m.lse + BT;
  return m;
}

// Rows r0 .. r0 + 63 of head h of batch row b of a [B, T, heads, 64]
// view with token stride ``stride`` into dst [64][LDH]; zeros past T.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int b,
                                          int h, int r0, int T,
                                          long long stride) {
  for (int i = threadIdx.x; i < BT * 8; i += THREADS) {
    const int r = i >> 3;
    const int c = i & 7;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < T) {
      val = *reinterpret_cast<const uint4*>(
          src + ((size_t)b * T + r0 + r) * stride + (size_t)h * D + 8 * c);
    }
    *reinterpret_cast<uint4*>(dst + r * LDH + 8 * c) = val;
  }
}

// acc[n] = A (16 rows at a, row-major) . X^T for X [64][LDH] row-major:
// 16 x 64, columns n*16 .. n*16 + 15 in acc[n].
__device__ __forceinline__ void mm_abt(FragC (&acc)[4], const bf16* a,
                                       const bf16* x) {
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.0f);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, LDH);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      FragBT fb;
      wmma::load_matrix_sync(fb, x + n * 16 * LDH + kk * 16, LDH);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// acc[n] += Y^T . B where Y^T's 16 rows are columns c0 .. c0 + 15 of
// Y [64][LDH] (at = Y + c0) and B [64][LDH] row-major.
__device__ __forceinline__ void mm_atb(FragC (&acc)[4], const bf16* at,
                                       const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    FragAT fa;
    wmma::load_matrix_sync(fa, at + kk * 16 * LDH, LDH);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      FragB fb;
      wmma::load_matrix_sync(fb, b + kk * 16 * LDH + n * 16, LDH);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// acc[n] += A (16 rows at a, row-major) . B for B [64][LDH] row-major.
__device__ __forceinline__ void mm_ab(FragC (&acc)[4], const bf16* a,
                                      const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, LDH);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      FragB fb;
      wmma::load_matrix_sync(fb, b + kk * 16 * LDH + n * 16, LDH);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

__device__ __forceinline__ void store_rows(float* dst, FragC (&acc)[4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    wmma::store_matrix_sync(dst + n * 16, acc[n], LDF, wmma::mem_row_major);
  }
}

// One warp's 16 rows of a tile pair: S (in m.s) and dP (in m.dp) to P
// and dS in bf16 (m.p, m.ds). Query row q0 + row, key k0 + c.
__device__ __forceinline__ void softmax_grad(const Smem& m, int w, int lane,
                                             int q0, int k0, int T,
                                             bool uniform,
                                             float scale_log2) {
  const float inv_t = 1.0f / T;
#pragma unroll 4
  for (int r = 0; r < 16; ++r) {
    const int row = w * 16 + r;
    const bool q_ok = q0 + row < T;
    const float lse = m.lse[row];
    const float dlt = m.delta[row];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = lane + 32 * j;
      float p = 0.0f;
      if (q_ok) {
        if (uniform) {
          p = k0 + c < T ? inv_t : 0.0f;
        } else {
          p = ex2(fmaf(m.s[row * LDF + c], scale_log2, m.bias[c]) - lse);
        }
      }
      const float ds = p * (m.dp[row * LDF + c] - dlt);
      m.p[row * LDH + c] = __float2bfloat16(p);
      m.ds[row * LDH + c] = __float2bfloat16(ds);
    }
  }
}

// This warp's 16 rows of a 64 x 64 f32 result, scaled, as bf16 into rows
// r0 + 16 w .. of head h of batch row b (token stride ``stride``); rows
// past T are not written. ``stage`` is the warp's 16 rows of an f32 tile.
__device__ __forceinline__ void write_rows(bf16* out, FragC (&acc)[4],
                                           float* stage, float scale, int w,
                                           int lane, int b, int h, int r0,
                                           int T, long long stride) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int i = 0; i < acc[n].num_elements; ++i) acc[n].x[i] *= scale;
  }
  store_rows(stage, acc);
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    const int row = r0 + w * 16 + r;
    if (row >= T) break;
    const float2 v = *reinterpret_cast<const float2*>(stage + r * LDF +
                                                      2 * lane);
    *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * T + row) * stride +
                                       (size_t)h * D + 2 * lane) =
        __floats2bfloat162_rn(v.x, v.y);
  }
}

// The mask's bias for keys k0 .. k0 + 63 into m.bias; returns whether
// any of them is real (a block-wide vote: every thread calls it).
__device__ __forceinline__ bool load_bias(const Smem& m, const int* mrow,
                                          int k0, int T) {
  bool real = false;
  if (threadIdx.x < BT) {
    const int key = k0 + threadIdx.x;
    real = key < T && mrow[key] != 0;
    m.bias[threadIdx.x] = key < T ? (real ? 0.0f : NEG_INF_F) : -INFINITY;
  }
  return __syncthreads_or(real) != 0;
}

// Whether batch row ``mrow`` has a real key (block-wide vote).
__device__ __forceinline__ bool row_has_key(const int* mrow, int T) {
  bool real = false;
  for (int t = threadIdx.x; t < T; t += THREADS) real = real || mrow[t] != 0;
  return __syncthreads_or(real) != 0;
}

// The forward's lse and torch's D for query rows q0 .. q0 + 63 (0 past T).
__device__ __forceinline__ void load_rows(const Smem& m, const float* lse,
                                          const float* delta, int b, int h,
                                          int heads, int q0, int T) {
  if (threadIdx.x < BT) {
    const int row = q0 + threadIdx.x;
    const bool ok = row < T;
    m.lse[threadIdx.x] = ok ? lse[((size_t)b * heads + h) * T + row] : 0.0f;
    m.delta[threadIdx.x] =
        ok ? delta[((size_t)b * T + row) * heads + h] : 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS)
    flash_attn_bwd_dkv_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const int* __restrict__ mask,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int T, int heads, long long stride_in,
                              long long stride_do, long long stride_out,
                              float sm_scale, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem m = carve(smem_raw);
  const int k0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int* mrow = mask + (size_t)b * T;

  const bool uniform = !row_has_key(mrow, T);
  const bool tile_real = load_bias(m, mrow, k0, T);
  FragC acc_dv[4], acc_dk[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    wmma::fill_fragment(acc_dv[n], 0.0f);
    wmma::fill_fragment(acc_dk[n], 0.0f);
  }
  if (uniform || tile_real) {  // else P = 0 on every key: dK = dV = 0
    bf16* sk = m.res0;
    bf16* sv = m.res1;
    load_tile(sk, k, b, h, k0, T, stride_in);
    load_tile(sv, v, b, h, k0, T, stride_in);
    for (int q0 = 0; q0 < T; q0 += BT) {
      __syncthreads();  // the last tile pair's readers are done
      bf16* sq = m.walk0;
      bf16* sdo = m.walk1;
      load_tile(sq, q, b, h, q0, T, stride_in);
      load_tile(sdo, dout, b, h, q0, T, stride_do);
      load_rows(m, lse, delta, b, h, heads, q0, T);
      __syncthreads();
      FragC acc[4];
      mm_abt(acc, sq + w * 16 * LDH, sk);  // S: this warp's query rows
      store_rows(m.s + w * 16 * LDF, acc);
      mm_abt(acc, sdo + w * 16 * LDH, sv);  // dP = dO V^T
      store_rows(m.dp + w * 16 * LDF, acc);
      __syncwarp();
      softmax_grad(m, w, lane, q0, k0, T, uniform, scale_log2);
      __syncthreads();  // P and dS of every query row
      mm_atb(acc_dv, m.p + w * 16, sdo);  // this warp's keys: P^T dO
      mm_atb(acc_dk, m.ds + w * 16, sq);  // dS^T Q
    }
    __syncthreads();
  }
  write_rows(dv, acc_dv, m.s + w * 16 * LDF, 1.0f, w, lane, b, h, k0, T,
             stride_out);
  write_rows(dk, acc_dk, m.dp + w * 16 * LDF, sm_scale, w, lane, b, h, k0,
             T, stride_out);
}

__global__ void __launch_bounds__(THREADS)
    flash_attn_bwd_dq_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const int* __restrict__ mask,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dq, int T, int heads,
                             long long stride_in, long long stride_do,
                             long long stride_out, float sm_scale,
                             float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem m = carve(smem_raw);
  const int q0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int* mrow = mask + (size_t)b * T;

  const bool uniform = !row_has_key(mrow, T);
  bf16* sq = m.res0;
  bf16* sdo = m.res1;
  load_tile(sq, q, b, h, q0, T, stride_in);
  load_tile(sdo, dout, b, h, q0, T, stride_do);
  load_rows(m, lse, delta, b, h, heads, q0, T);
  FragC acc_dq[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc_dq[n], 0.0f);
  for (int k0 = 0; k0 < T; k0 += BT) {
    // The vote is also the barrier after the last tile's readers.
    if (!load_bias(m, mrow, k0, T) && !uniform) continue;  // P = 0 here
    bf16* sk = m.walk0;
    bf16* sv = m.walk1;
    load_tile(sk, k, b, h, k0, T, stride_in);
    load_tile(sv, v, b, h, k0, T, stride_in);
    __syncthreads();
    FragC acc[4];
    mm_abt(acc, sq + w * 16 * LDH, sk);
    store_rows(m.s + w * 16 * LDF, acc);
    mm_abt(acc, sdo + w * 16 * LDH, sv);
    store_rows(m.dp + w * 16 * LDF, acc);
    __syncwarp();
    softmax_grad(m, w, lane, q0, k0, T, uniform, scale_log2);
    __syncwarp();  // this warp's dS rows are all it reads
    mm_ab(acc_dq, m.ds + w * 16 * LDH, sk);
    __syncthreads();
  }
  write_rows(dq, acc_dq, m.s + w * 16 * LDF, sm_scale, w, lane, b, h, q0, T,
             stride_out);
}

bool bad_args(int batch, int T, int heads, long long stride_in,
              long long stride_do, long long stride_out, float sm_scale) {
  return batch <= 0 || T <= 0 || heads <= 0 || batch > 65535 ||
         heads > 65535 || stride_in % 8 != 0 || stride_do % 8 != 0 ||
         stride_out % 2 != 0 || stride_in < (long long)heads * D ||
         stride_do < (long long)heads * D ||
         stride_out < (long long)heads * D || !(sm_scale > 0.0f);
}

}  // namespace

extern "C" {

// Both launch on ``stream``. q, k, v: [B, T, heads, 64] bf16 with token
// stride ``stride_in`` (a multiple of 8; 16-byte aligned bases); dout the
// same shape with token stride ``stride_do`` (a multiple of 8, 16-byte
// aligned); mask [B, T] int32;
// lse [B, heads, T] f32 from flash_attn_launch; delta [B, T, heads] f32
// (sum over head_dim of O * dO); outputs [B, T, heads, 64] bf16 with
// token stride ``stride_out`` (even). Return 0 or the cudaError_t of the
// launch.
int flash_attn_bwd_dkv_launch(const void* q, const void* k, const void* v,
                              const void* dout, const void* mask,
                              const void* lse, const void* delta, void* dk,
                              void* dv, int batch, int T, int heads,
                              long long stride_in, long long stride_do,
                              long long stride_out, float sm_scale,
                              void* stream) {
  if (bad_args(batch, T, heads, stride_in, stride_do, stride_out, sm_scale)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BT - 1) / BT, heads, batch);
  flash_attn_bwd_dkv_kernel<<<grid, THREADS, SMEM_BYTES,
                              (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const int*>(mask), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), T, heads, stride_in, stride_do, stride_out,
      sm_scale, sm_scale * LOG2E);
  return (int)cudaGetLastError();
}

int flash_attn_bwd_dq_launch(const void* q, const void* k, const void* v,
                             const void* dout, const void* mask,
                             const void* lse, const void* delta, void* dq,
                             int batch, int T, int heads, long long stride_in,
                             long long stride_do, long long stride_out,
                             float sm_scale, void* stream) {
  if (bad_args(batch, T, heads, stride_in, stride_do, stride_out, sm_scale)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BT - 1) / BT, heads, batch);
  flash_attn_bwd_dq_kernel<<<grid, THREADS, SMEM_BYTES,
                             (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const int*>(mask), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), T, heads,
      stride_in, stride_do, stride_out, sm_scale, sm_scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // extern "C"
