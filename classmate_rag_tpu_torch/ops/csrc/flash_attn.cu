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
// Grid: (query tiles of 64, heads, batch); 4 warps, 16 query rows each.
// Each block walks the key tiles of 64 in order, keeping in registers,
// per query row, the running max m, the running sum l of exp(s - m) and
// the f32 accumulator of P.V, FlashAttention-2 style:
//   S = Q K^T  bf16 mma.sync m16n8k16, f32 accumulate (exact bf16 products)
//   m' = max(m, rowmax S); P = exp(S - m'); l = l e^(m-m') + rowsum P
//   O = O e^(m-m') + bf16(P) V  (mma.sync again), out = O / l at the end.
// The [T, T] scores never reach device memory.
//
// The reference normalises P in f32 and rounds the probabilities to bf16
// before P.V; here the unnormalised exp(S - m') is rounded and the sum is
// divided out at the end. Both round each weight once to bf16 (relative
// 2^-9), so the outputs differ by about |v| * 2^-9.
//
// Padding: a key tile with no real key, met after a tile that had one,
// adds exp(NEG_INF - m) = 0 to every row and leaves m unchanged, so the
// block skips it (uniform across the block); at T = 512 a 40-token
// passage reads 1 key tile of 8. The first tile is never skipped, so m is
// finite from then on and exp(m_old - m') never sees -inf - -inf. Keys
// past T (T not a multiple of 64) score -inf and weigh exactly 0.
//
// What bounds it on an H100: at T <= 512 and head_dim 64, bytes and
// tensor-core operations are close (4*B*h*T^2*64 FLOP against 8*B*T*H
// bytes; ratio 64T FLOP per 8 bytes ~ 1:1 to 4:1 of the card's 295).
// This first version is simple rather than fast: synchronous global ->
// shared copies of each K/V tile, mma.sync (not wgmma), f32 expf, no
// double buffering.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int D = 64;         // head_dim
constexpr int BM = 64;        // query rows a block
constexpr int BN = 64;        // keys a tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int LDS = D + 8;    // padded smem row (bf16): no bank conflicts
constexpr float NEG_INF_F = -3.4028234663852886e38f;  // f32 min

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 two =
      __halves2bfloat162(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
  return *reinterpret_cast<const uint32_t*>(&two);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pair_u32(const __nv_bfloat16* lo,
                                             const __nv_bfloat16* hi) {
  const __nv_bfloat162 two = __halves2bfloat162(*lo, *hi);
  return *reinterpret_cast<const uint32_t*>(&two);
}

// Copies rows [t0, t0 + 64) of one head into smem (zeros past T).
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int t0, int T, long long stride_t,
                                          int tid) {
#pragma unroll
  for (int it = 0; it < (BN * D / 8) / THREADS; ++it) {
    const int idx = tid + it * THREADS;
    const int r = idx >> 3;
    const int c = (idx & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < T) {
      val = *reinterpret_cast<const uint4*>(src + (t0 + r) * stride_t + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
flash_attn_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int* __restrict__ mask,        // [B, T]
                  __nv_bfloat16* __restrict__ out,     // [B, T, heads*64]
                  int T, int heads, long long stride_t, float sm_scale) {
  __shared__ __align__(16) __nv_bfloat16 sQ[BM * LDS];
  __shared__ __align__(16) __nv_bfloat16 sK[BN * LDS];
  __shared__ __align__(16) __nv_bfloat16 sV[BN * LDS];
  __shared__ float sBias[BN];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // mma groupID: row in the fragment
  const int t4 = lane & 3;   // thread in group: column pair
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long head_off = (long long)b * T * stride_t + (long long)h * D;
  const int* mrow = mask + (long long)b * T;

  load_tile(sQ, q + head_off, q0, T, stride_t, tid);
  __syncthreads();
  // This warp's 16 query rows as mma A fragments, 4 slices of 16 dims.
  uint32_t qa[4][4];
  {
    const __nv_bfloat16* r0 = sQ + (warp * 16 + g) * LDS + 2 * t4;
    const __nv_bfloat16* r1 = r0 + 8 * LDS;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      qa[ks][0] = ld_u32(r0 + ks * 16);
      qa[ks][1] = ld_u32(r1 + ks * 16);
      qa[ks][2] = ld_u32(r0 + ks * 16 + 8);
      qa[ks][3] = ld_u32(r1 + ks * 16 + 8);
    }
  }

  // Rows g and g + 8 of the warp's 16: running max, sum, accumulator.
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};
  float o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.0f;
  }

  bool seen_real = false;
  const int n_tiles = (T + BN - 1) / BN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int key0 = kt * BN;
    __syncthreads();  // the previous tile's sK/sV/sBias reads are done
    int real = 0;
    if (tid < BN) {
      const int key = key0 + tid;
      float bias = -INFINITY;
      if (key < T) {
        real = mrow[key] != 0;
        bias = real ? 0.0f : NEG_INF_F;
      }
      sBias[tid] = bias;
    }
    const int any_real = __syncthreads_or(real);
    if (!any_real && seen_real) continue;  // adds exactly nothing
    seen_real = seen_real || any_real;
    load_tile(sK, k + head_off, key0, T, stride_t, tid);
    load_tile(sV, v + head_off, key0, T, stride_t, tid);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: 8 n-tiles of 8 keys.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      const __nv_bfloat16* kr = sK + (nt * 8 + g) * LDS + 2 * t4;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        mma_bf16(s[nt], qa[ks], ld_u32(kr + ks * 16), ld_u32(kr + ks * 16 + 8));
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float b0 = sBias[nt * 8 + 2 * t4];
      const float b1 = sBias[nt * 8 + 2 * t4 + 1];
      s[nt][0] = __fmul_rn(s[nt][0], sm_scale) + b0;
      s[nt][1] = __fmul_rn(s[nt][1], sm_scale) + b1;
      s[nt][2] = __fmul_rn(s[nt][2], sm_scale) + b0;
      s[nt][3] = __fmul_rn(s[nt][3], sm_scale) + b1;
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the 4 threads of a row share it
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    const float alpha[2] = {expf(m[0] - mx[0]), expf(m[1] - mx[1])};
    float rs[2] = {0.0f, 0.0f};
    uint32_t pa[4][4];  // bf16(P) as A fragments, 4 slices of 16 keys
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = expf(s[nt][0] - mx[0]);
      const float p1 = expf(s[nt][1] - mx[0]);
      const float p2 = expf(s[nt][2] - mx[1]);
      const float p3 = expf(s[nt][3] - mx[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pa[nt >> 1][(nt & 1) * 2] = pack_bf16(p0, p1);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
      m[r] = mx[r];
    }

    // O = O * alpha + P V: 8 n-tiles of 8 head dims, 4 slices of 16 keys.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
      const __nv_bfloat16* vc = sV + 2 * t4 * LDS + nt * 8 + g;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const __nv_bfloat16* v0 = vc + ks * 16 * LDS;
        mma_bf16(o[nt], pa[ks], pair_u32(v0, v0 + LDS),
                 pair_u32(v0 + 8 * LDS, v0 + 9 * LDS));
      }
    }
  }

  const int row0 = q0 + warp * 16 + g;
  const size_t out_stride = (size_t)heads * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= T) continue;
    __nv_bfloat16* dst =
        out + ((size_t)b * T + row) * out_stride + (size_t)h * D + 2 * t4;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<uint32_t*>(dst + nt * 8) =
          pack_bf16(o[nt][2 * r] / l[r], o[nt][2 * r + 1] / l[r]);
    }
  }
}

}  // namespace

extern "C" {

int flash_attn_head_dim() { return D; }

// Launches on ``stream``. q, k, v: [B, T, heads, 64] bf16 with token
// stride ``stride_t`` elements (a multiple of 8; 16-byte aligned bases);
// out [B, T, heads*64] bf16; mask [B, T] int32. Returns 0 or the
// cudaError_t of the launch.
int flash_attn_launch(const void* q, const void* k, const void* v,
                      const void* mask, void* out, int batch, int T,
                      int heads, long long stride_t, float sm_scale,
                      void* stream) {
  if (batch <= 0 || T <= 0 || heads <= 0 || stride_t % 8 != 0 ||
      stride_t < (long long)heads * D || heads > 65535 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((T + BM - 1) / BM, heads, batch);
  flash_attn_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(mask),
      static_cast<__nv_bfloat16*>(out), T, heads, stride_t, sm_scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
