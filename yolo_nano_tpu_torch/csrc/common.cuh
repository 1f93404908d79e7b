// Shared device helpers of the port's kernels (fused_dw_pw.cu, fused_stage.cu).
//
// Activations are NHWC in device memory (the port keeps NCHW tensors in
// channels_last memory format), so one pixel's channels are contiguous and
// neighbouring threads take neighbouring channels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ynt {

constexpr int kThreads = 256;

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_LEAKY) return v >= 0.f ? v : 0.1f * v;
  return v;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype(bf16)
}

// Pointwise (1x1) product over P pixels of one tile:
//   store(p, o, bias[o] + sum_k row(p)[k] * w[k * N + o])   for p < P, o < N.
// row(p) points at pixel p's K input channels (shared or device memory).
// Each thread owns one output channel o and PT consecutive pixels, so a warp
// reads one weight row coalesced and each input value as a broadcast. The
// weights (at most a few hundred KB) are read through L1/L2, not staged.
template <int PT, typename WT, typename Row, typename Store>
__device__ __forceinline__ void pointwise(int P, int K, int N,
                                          const WT* __restrict__ w,
                                          const float* __restrict__ bias,
                                          Row row, Store store) {
  const int groups = (P + PT - 1) / PT;
  for (int item = threadIdx.x; item < groups * N; item += blockDim.x) {
    const int o = item % N;
    const int p0 = (item / N) * PT;
    const float* r[PT];
#pragma unroll
    for (int i = 0; i < PT; ++i) r[i] = row(min(p0 + i, P - 1));
    float acc[PT];
#pragma unroll
    for (int i = 0; i < PT; ++i) acc[i] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float wk = to_float(__ldg(&w[k * N + o]));
#pragma unroll
      for (int i = 0; i < PT; ++i) acc[i] = fmaf(r[i][k], wk, acc[i]);
    }
    const float b = __ldg(&bias[o]);
#pragma unroll
    for (int i = 0; i < PT; ++i)
      if (p0 + i < P) store(p0 + i, o, acc[i] + b);
  }
}

}  // namespace ynt
