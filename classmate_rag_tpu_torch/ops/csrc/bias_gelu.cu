// Bias + exact GELU, written in bf16, for Hopper (sm_90a).
//
// Replaces the TPU kernel classmate_rag_tpu/ops/encoder_fused.py::bias_gelu
// (_bias_gelu_kernel): out[n, f] = bf16(gelu(y[n, f] + b[f])), with the
// exact (erf) GELU of the encoder's XLA path (embeddings/model.py:363,
// jax.nn.gelu(approximate=False) = 0.5 * x * erfc(-x / sqrt(2))). The TPU
// kernel carried a polynomial erf because Mosaic had none; CUDA has
// erfcf. erfc rather than 1 + erf: for x < -4 the sum 1 + erf(x/sqrt 2)
// cancels to a few ulps and loses most of its digits, erfc does not.
//
// What bounds it on an H100: bytes. Each element is read once as f32 and
// written once as bf16, N*F*(4 + 2) + 4F bytes; at the encoder's shape
// (N = 16,384 tokens, F = 3072) that is 302 MB, 90 us at 3.35 TB/s,
// against a few f32 operations and one erfcf an element. The design
// moves each byte once:
// one thread handles 8 consecutive elements of a row (F % 8 == 0, so
// they never straddle two rows), two 16-byte loads of y, two of b
// (L1/L2-resident: F floats), one 16-byte store of 8 bf16. The TPU
// kernel's row blocking (_pick_rows sized VMEM blocks) has no
// counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr float SQRT_HALF = 0.70710678118654752f;

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * erfcf(-x * SQRT_HALF);
}

__global__ void __launch_bounds__(THREADS)
bias_gelu_kernel(const float* __restrict__ y,        // [N, F]
                 const float* __restrict__ b,        // [F]
                 __nv_bfloat16* __restrict__ out,    // [N, F]
                 long long n_vec, int f) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
       i < n_vec; i += stride) {
    const long long e0 = i * 8;
    const int col = (int)(e0 % f);
    const float4 y0 = *reinterpret_cast<const float4*>(y + e0);
    const float4 y1 = *reinterpret_cast<const float4*>(y + e0 + 4);
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(b + col));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(b + col + 4));
    const float x[8] = {y0.x + b0.x, y0.y + b0.y, y0.z + b0.z, y0.w + b0.w,
                        y1.x + b1.x, y1.y + b1.y, y1.z + b1.z, y1.w + b1.w};
    uint4 packed;
    uint32_t* w = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 two = __halves2bfloat162(
          __float2bfloat16_rn(gelu(x[2 * j])),
          __float2bfloat16_rn(gelu(x[2 * j + 1])));
      w[j] = *reinterpret_cast<const uint32_t*>(&two);
    }
    *reinterpret_cast<uint4*>(out + e0) = packed;
  }
}

}  // namespace

extern "C" {

// Launches on ``stream``. f must be a multiple of 8 and y, b and out
// 16-byte aligned (the wrapper checks). Returns 0 or the cudaError_t of
// the launch.
int bias_gelu_launch(const void* y, const void* b, void* out, long long n,
                     int f, void* stream) {
  if (n <= 0 || f <= 0 || f % 8 != 0) return (int)cudaErrorInvalidValue;
  const long long n_vec = n * (long long)f / 8;
  long long blocks = (n_vec + THREADS - 1) / THREADS;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond this
  bias_gelu_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(y), static_cast<const float*>(b),
      static_cast<__nv_bfloat16*>(out), n_vec, f);
  return (int)cudaGetLastError();
}

}  // extern "C"
