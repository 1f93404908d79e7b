// Shared device helpers of the port's kernels (fused_dw_pw.cu,
// fused_dw_pw_bf16.cu, fused_stage.cu).
//
// Activations are NHWC in device memory (the port keeps NCHW tensors in
// channels_last memory format), so one pixel's channels are contiguous and
// neighbouring threads take neighbouring channels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ynt {

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

// Calls f(cy, cx, k) for every cell (cy, cx) of a grid cols cells wide
// (a region, the tile's pixels, the weight rows) and every k < per_cell,
// item i = cell * per_cell + k spread over the block's threads; the indices
// are walked without a division per step.
template <typename F>
__device__ __forceinline__ void for_each_cell(int cells, int cols,
                                              int per_cell, F f) {
  const int step = blockDim.x;
  const int dk = step % per_cell;
  const int dcy = step / per_cell / cols;
  const int dcx = step / per_cell % cols;
  int k = threadIdx.x % per_cell;
  int cy = threadIdx.x / per_cell / cols;
  int cx = threadIdx.x / per_cell % cols;
  for (int i = threadIdx.x; i < cells * per_cell; i += step) {
    f(cy, cx, k);
    k += dk;
    const int carry = k >= per_cell;
    k -= carry * per_cell;
    cx += dcx + carry;
    cy += dcy;
    if (cx >= cols) {
      cx -= cols;
      ++cy;
    }
  }
}

}  // namespace ynt
