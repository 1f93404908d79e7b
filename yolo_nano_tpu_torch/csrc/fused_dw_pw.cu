// Fused depthwise-3x3 -> act -> pointwise-1x1 -> act, for Hopper (sm_90a).
//
// Replaces the TPU kernel yolo_nano_tpu/ops/pallas/fused_conv.py::fused_dw_pw
// (body `_kernel`): for x [B,H,W,C] (NHWC in memory)
//   out = act_out( act_mid( dw3x3(x, pad 1, stride 1) + dw_b ) @ pw_w + pw_b )
// with the depthwise taps summed in f32, the pointwise product taken in x's
// dtype (the mid activation rounded to it) with f32 accumulation, and the
// output written in x's dtype. It runs the two dw->pw pairs of each detection
// head: C = Cout = 96 at 52x52, 26x26 and 13x13 for a 416 input.
//
// What bounds it on this card: per output pixel it moves C inputs and Cout
// outputs and does 2*9*C + 2*C*Cout operations: about 26 operations per byte
// in f32 at C = 96 (52 in bf16), above the H100's balance of about 20 for
// f32 outside the tensor cores (67 TFLOP/s over 3.35 TB/s). So the bound is
// the f32 operation rate, provided the dw intermediate never goes to device
// memory, which is what the fusion buys.
//
// Design: the TPU kernel kept a whole image per grid step in VMEM
// (52*52*96*4 B ~ 1 MB); a Hopper block has at most 227 KB of shared memory.
// So one thread block takes one 8x8 output tile of one image: it stages the
// 10x10xC input tile with its 1-pixel halo (zero outside the image: that is
// the pad 1) as f32 in shared memory, writes the 8x8xC depthwise result to a
// second shared buffer, then runs the pointwise product from shared memory
// with the weights read through L1/L2. At C = 96 that is 38 KB + 25 KB.
// This is the simple, correct first design: the product runs on the f32
// pipes, not the tensor cores.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kTile = 8;
constexpr int kHalo = kTile + 2;

template <typename T>
__global__ void __launch_bounds__(ynt::kThreads)
    fused_dw_pw_kernel(const T* __restrict__ x, const float* __restrict__ dw_w,
                       const float* __restrict__ dw_b,
                       const T* __restrict__ pw_w,
                       const float* __restrict__ pw_b, T* __restrict__ out,
                       int H, int W, int C, int Cout, int act_mid,
                       int act_out, int tiles_x) {
  extern __shared__ float smem[];
  float* xs = smem;                      // [kHalo*kHalo][C]
  float* mid = smem + kHalo * kHalo * C;  // [kTile*kTile][C]

  const int n = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_x) * kTile;
  const int ox0 = (blockIdx.x % tiles_x) * kTile;
  const T* xn = x + static_cast<int64_t>(n) * H * W * C;
  T* on = out + static_cast<int64_t>(n) * H * W * Cout;

  for (int i = threadIdx.x; i < kHalo * kHalo * C; i += blockDim.x) {
    const int c = i % C;
    const int r = i / C;
    const int iy = oy0 - 1 + r / kHalo;
    const int ix = ox0 - 1 + r % kHalo;
    float v = 0.f;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W)
      v = ynt::to_float(xn[(static_cast<int64_t>(iy) * W + ix) * C + c]);
    xs[i] = v;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTile * kTile * C; i += blockDim.x) {
    const int c = i % C;
    const int p = i / C;
    const int py = p / kTile;
    const int px = p % kTile;
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        acc = fmaf(xs[((py + dy) * kHalo + px + dx) * C + c],
                   dw_w[(dy * 3 + dx) * C + c], acc);
    acc = ynt::activate(acc + dw_b[c], act_mid);
    mid[i] = ynt::to_float(ynt::from_float<T>(acc));
  }
  __syncthreads();

  ynt::pointwise<8>(
      kTile * kTile, C, Cout, pw_w, pw_b,
      [&](int p) { return mid + p * C; },
      [&](int p, int o, float v) {
        const int oy = oy0 + p / kTile;
        const int ox = ox0 + p % kTile;
        if (oy < H && ox < W)
          on[(static_cast<int64_t>(oy) * W + ox) * Cout + o] =
              ynt::from_float<T>(ynt::activate(v, act_out));
      });
}

template <typename T>
int launch(const T* x, const float* dw_w, const float* dw_b, const T* pw_w,
           const float* pw_b, T* out, int B, int H, int W, int C, int Cout,
           int act_mid, int act_out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kHalo * kHalo + kTile * kTile) * C;
  cudaError_t err = cudaFuncSetAttribute(
      fused_dw_pw_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (W + kTile - 1) / kTile;
  const int tiles_y = (H + kTile - 1) / kTile;
  const dim3 grid(tiles_x * tiles_y, B);
  fused_dw_pw_kernel<T><<<grid, ynt::kThreads, smem, stream>>>(
      x, dw_w, dw_b, pw_w, pw_b, out, H, W, C, Cout, act_mid, act_out,
      tiles_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_dw_pw_f32(const void* x, const void* dw_w,
                               const void* dw_b, const void* pw_w,
                               const void* pw_b, void* out, int B, int H,
                               int W, int C, int Cout, int act_mid,
                               int act_out, void* stream) {
  return launch<float>(
      static_cast<const float*>(x), static_cast<const float*>(dw_w),
      static_cast<const float*>(dw_b), static_cast<const float*>(pw_w),
      static_cast<const float*>(pw_b), static_cast<float*>(out), B, H, W, C,
      Cout, act_mid, act_out, static_cast<cudaStream_t>(stream));
}

extern "C" int fused_dw_pw_bf16(const void* x, const void* dw_w,
                                const void* dw_b, const void* pw_w,
                                const void* pw_b, void* out, int B, int H,
                                int W, int C, int Cout, int act_mid,
                                int act_out, void* stream) {
  return launch<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dw_w),
      static_cast<const float*>(dw_b),
      static_cast<const __nv_bfloat16*>(pw_w),
      static_cast<const float*>(pw_b), static_cast<__nv_bfloat16*>(out), B,
      H, W, C, Cout, act_mid, act_out, static_cast<cudaStream_t>(stream));
}
