// Residual + bias + LayerNorm over rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel classmate_rag_tpu/ops/encoder_fused.py::
// residual_ln (_residual_ln_kernel):
//   x = resid + (y + b);  out = (x - mean) * rsqrt(var + eps) * g + beta
// per row of H floats, with the biased variance taken in a second pass
// over the centred row (mean of squared deviations), as the TPU kernel
// and the encoder's _layer_norm do. resid + (y + b) is the association
// of the encoder's unfused path (attn_out = mm + b; hidden + attn_out).
//
// What bounds it on an H100: bytes. Two [N, H] f32 inputs read once and
// one written once, 3*N*H*4 bytes (+ 3 H-vectors); at the encoder's shape
// (N = 16,384 tokens, H = 768) 151 MB, 45 us at 3.35 TB/s, against ~10
// operations an element. Design: one warp per row, the row held in
// registers (H/128 float4 a lane, H <= 1024), so both reduction passes
// read registers, not memory; warp shuffles reduce; 8 rows a block.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_V = 8;  // float4 a lane: H <= 32 * 4 * 8 = 1024

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

template <int NV>
__global__ void __launch_bounds__(THREADS)
residual_ln_kernel(const float* __restrict__ resid,  // [N, H]
                   const float* __restrict__ y,      // [N, H]
                   const float* __restrict__ b,      // [H]
                   const float* __restrict__ g,      // [H]
                   const float* __restrict__ beta,   // [H]
                   float* __restrict__ out,          // [N, H]
                   int n, float eps) {
  constexpr int H = NV * 128;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= n) return;
  const size_t base = (size_t)row * H;
  const float4* r4 = reinterpret_cast<const float4*>(resid + base);
  const float4* y4 = reinterpret_cast<const float4*>(y + base);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float4 x[NV];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    const float4 rv = r4[c];
    const float4 yv = y4[c];
    const float4 bv = __ldg(b4 + c);
    x[i] = make_float4(rv.x + (yv.x + bv.x), rv.y + (yv.y + bv.y),
                       rv.z + (yv.z + bv.z), rv.w + (yv.w + bv.w));
    sum += (x[i].x + x[i].y) + (x[i].z + x[i].w);
  }
  const float mean = warp_sum(sum) / (float)H;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float dx = x[i].x - mean, dy = x[i].y - mean;
    const float dz = x[i].z - mean, dw = x[i].w - mean;
    sq += (dx * dx + dy * dy) + (dz * dz + dw * dw);
  }
  const float var = warp_sum(sq) / (float)H;
  const float rstd = 1.0f / sqrtf(var + eps);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const float4* be4 = reinterpret_cast<const float4*>(beta);
  float4* o4 = reinterpret_cast<float4*>(out + base);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    const float4 gv = __ldg(g4 + c);
    const float4 bev = __ldg(be4 + c);
    o4[c] = make_float4((x[i].x - mean) * rstd * gv.x + bev.x,
                        (x[i].y - mean) * rstd * gv.y + bev.y,
                        (x[i].z - mean) * rstd * gv.z + bev.z,
                        (x[i].w - mean) * rstd * gv.w + bev.w);
  }
}

template <int NV>
int launch(const void* resid, const void* y, const void* b, const void* g,
           const void* beta, void* out, int n, float eps,
           cudaStream_t stream) {
  const int blocks = (n + WARPS - 1) / WARPS;
  residual_ln_kernel<NV><<<blocks, THREADS, 0, stream>>>(
      static_cast<const float*>(resid), static_cast<const float*>(y),
      static_cast<const float*>(b), static_cast<const float*>(g),
      static_cast<const float*>(beta), static_cast<float*>(out), n, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on ``stream``; h must be a multiple of 128 up to 1024 and every
// pointer 16-byte aligned (the wrapper checks). Returns 0 or the
// cudaError_t of the launch.
int residual_ln_launch(const void* resid, const void* y, const void* b,
                       const void* g, const void* beta, void* out, int n,
                       int h, float eps, void* stream) {
  if (n <= 0 || h <= 0 || h % 128 != 0 || h / 128 > MAX_V) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (h / 128) {
    case 1: return launch<1>(resid, y, b, g, beta, out, n, eps, s);
    case 2: return launch<2>(resid, y, b, g, beta, out, n, eps, s);
    case 3: return launch<3>(resid, y, b, g, beta, out, n, eps, s);
    case 4: return launch<4>(resid, y, b, g, beta, out, n, eps, s);
    case 5: return launch<5>(resid, y, b, g, beta, out, n, eps, s);
    case 6: return launch<6>(resid, y, b, g, beta, out, n, eps, s);
    case 7: return launch<7>(resid, y, b, g, beta, out, n, eps, s);
    default: return launch<8>(resid, y, b, g, beta, out, n, eps, s);
  }
}

}  // extern "C"
