// One ShuffleNetV2 block per launch, for Hopper (sm_90a); a stage is one
// stride-2 launch followed by n stride-1 launches.
//
// Replaces the TPU kernel yolo_nano_tpu/ops/pallas/fused_stage.py::fused_stage
// (body `_stage_kernel`), which runs a whole stage on folded weights:
//   stride-2 block: branch1 = relu(pw(dw3x3/s2(x) + b) + b),
//                   branch2 = relu(pw2(dw3x3/s2(relu(pw1(x) + b)) + b) + b),
//                   out[2j] = branch1[j], out[2j+1] = branch2[j];
//   stride-1 block: x1, x2 = x[:C/2], x[C/2:],
//                   out[2j] = x1[j], out[2j+1] = relu(pw2(dw3x3(relu(pw1(x2)+b))+b)+b)[j].
// The channel shuffle (groups 2) is written directly as that interleave; the
// TPU kernel's E/O selector matmuls were a workaround for Mosaic's missing
// lane interleaves and have no counterpart here.
//
// What bounds it on this card: a stride-1 block does 4*c2^2 + 18*c2
// operations per pixel against 16*c2 bytes in and out in f32: about 16
// operations per byte at stage2 (c2 = 58, under the f32 balance of ~20: bytes)
// and 30 and 58 at stage3 and stage4 (c2 = 116, 232: f32 operations). The
// TPU kernel kept a whole stage in VMEM; on Hopper a whole stage does not fit
// in 227 KB of shared memory (the stage2 output alone is 52*52*116*4 B ~
// 1.25 MB per image), so each launch fuses one block and only block outputs
// go through device memory (mostly L2 at these sizes).
//
// Design: one thread block per (image, TxT output tile). For an output tile
// the block needs an R x R input region, R = (T-1)*stride + 3 (the 1-pixel
// halo of the 3x3 depthwise):
//   1. pw1 + relu over the R x R region, read straight from device memory,
//      into shared memory, with 0 outside the image (the depthwise pad);
//   2. depthwise 3x3 (+ bias, no act) at the tile's T x T outputs;
//   3. pw2 + relu, written to the odd output channels;
//   4. stride 1: x1 copied to the even channels; stride 2: branch1's
//      depthwise into shared memory, then its pw + relu to the even channels.
// The caller picks T (yolo_nano_tpu_torch/ops/kernels/fused_stage.py): small
// tiles (2 to 6 at 416 px) whose buffers fit 28 KB, so that many blocks are
// resident per SM. Weights are read through L1/L2, not staged (stage4's pw2
// alone is 232*232*4 B ~ 215 KB).
// This is the simple, correct first design: the products run on the f32
// pipes, not the tensor cores; a whole stage in one launch is later work.

#include <cstdint>

#include "common.cuh"

namespace {

struct BlockWeights {
  const float* pw1_w;  // [K1][c2], K1 = Cin (stride 2) or c2 (stride 1)
  const float* pw1_b;  // [c2]
  const float* dw_w;   // [9][c2]
  const float* dw_b;   // [c2]
  const float* pw2_w;  // [c2][c2]
  const float* pw2_b;  // [c2]
  const float* b1dw_w;  // [9][Cin]   (stride 2 only)
  const float* b1dw_b;  // [Cin]
  const float* b1pw_w;  // [Cin][c2]
  const float* b1pw_b;  // [c2]
};

__host__ __device__ inline int region(int tile, int stride) {
  return (tile - 1) * stride + 3;
}

// Shared memory layout: offs [R*R] ints | A [max(R*R*c2, T*T*Cin)] | D [T*T*c2]
__host__ __device__ inline int a_floats(int tile, int stride, int cin, int c2) {
  const int r = region(tile, stride);
  const int a = r * r * c2;
  const int e = stride == 2 ? tile * tile * cin : 0;
  return a > e ? a : e;
}

__host__ __device__ inline int offs_ints(int tile, int stride) {
  const int r = region(tile, stride);
  return (r * r + 3) / 4 * 4;  // keep the float buffers 16-byte aligned
}

inline size_t smem_bytes(int tile, int stride, int cin, int c2) {
  return sizeof(int) * offs_ints(tile, stride) +
         sizeof(float) * (a_floats(tile, stride, cin, c2) + tile * tile * c2);
}

template <int STRIDE>
__global__ void __launch_bounds__(ynt::kThreads)
    shuffle_block_kernel(const float* __restrict__ x, float* __restrict__ out,
                         BlockWeights wts, int H, int W, int Cin, int Ho,
                         int Wo, int c2, int tile, int tiles_x) {
  extern __shared__ float smem[];
  const int R = region(tile, STRIDE);
  int* offs = reinterpret_cast<int*>(smem);
  float* A = smem + offs_ints(tile, STRIDE);
  float* D = A + a_floats(tile, STRIDE, Cin, c2);
  const int P = tile * tile;
  const int Cout = 2 * c2;

  const int n = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_x) * tile;
  const int ox0 = (blockIdx.x % tiles_x) * tile;
  const float* xn = x + static_cast<int64_t>(n) * H * W * Cin;
  float* on = out + static_cast<int64_t>(n) * Ho * Wo * Cout;
  // input pixel (iy, ix) of region cell r; -1 outside the image
  for (int r = threadIdx.x; r < R * R; r += blockDim.x) {
    const int iy = oy0 * STRIDE - 1 + r / R;
    const int ix = ox0 * STRIDE - 1 + r % R;
    offs[r] = (iy >= 0 && iy < H && ix >= 0 && ix < W) ? (iy * W + ix) * Cin
                                                       : -1;
  }
  __syncthreads();

  // 1. pw1 + relu over the region; the stride-1 block reads x2 = x[c2:]
  const int k1 = STRIDE == 2 ? Cin : c2;
  const float* x_in = xn + (STRIDE == 2 ? 0 : c2);
  ynt::pointwise<4>(
      R * R, k1, c2, wts.pw1_w, wts.pw1_b,
      [&](int r) { return x_in + max(offs[r], 0); },
      [&](int r, int o, float v) {
        A[r * c2 + o] = offs[r] >= 0 ? fmaxf(v, 0.f) : 0.f;
      });
  __syncthreads();

  // 2. depthwise 3x3 (+ bias) at the tile's outputs
  for (int i = threadIdx.x; i < P * c2; i += blockDim.x) {
    const int c = i % c2;
    const int p = i / c2;
    const int py = p / tile;
    const int px = p % tile;
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        acc = fmaf(A[((py * STRIDE + dy) * R + px * STRIDE + dx) * c2 + c],
                   wts.dw_w[(dy * 3 + dx) * c2 + c], acc);
    D[i] = acc + wts.dw_b[c];
  }
  __syncthreads();

  auto out_pixel = [&](int p) -> int64_t {
    const int oy = oy0 + p / tile;
    const int ox = ox0 + p % tile;
    return (oy < Ho && ox < Wo) ? (static_cast<int64_t>(oy) * Wo + ox) * Cout
                                : -1;
  };

  if (STRIDE == 2) {
    // branch1 depthwise 3x3/s2 (+ bias) of x into A (free again after step 2)
    for (int i = threadIdx.x; i < P * Cin; i += blockDim.x) {
      const int c = i % Cin;
      const int p = i / Cin;
      const int py = p / tile;
      const int px = p % tile;
      float acc = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int off = offs[(py * 2 + dy) * R + px * 2 + dx];
          if (off >= 0)
            acc = fmaf(xn[off + c], wts.b1dw_w[(dy * 3 + dx) * Cin + c], acc);
        }
      A[i] = acc + wts.b1dw_b[c];
    }
    __syncthreads();
    ynt::pointwise<4>(
        P, Cin, c2, wts.b1pw_w, wts.b1pw_b,
        [&](int p) { return A + p * Cin; },
        [&](int p, int o, float v) {
          const int64_t q = out_pixel(p);
          if (q >= 0) on[q + 2 * o] = fmaxf(v, 0.f);
        });
  } else {
    for (int i = threadIdx.x; i < P * c2; i += blockDim.x) {
      const int c = i % c2;
      const int64_t q = out_pixel(i / c2);
      if (q >= 0) {
        const int p = i / c2;
        const int iy = oy0 + p / tile;
        const int ix = ox0 + p % tile;
        on[q + 2 * c] = xn[(static_cast<int64_t>(iy) * W + ix) * Cin + c];
      }
    }
  }

  // 3. pw2 + relu to the odd channels
  ynt::pointwise<4>(
      P, c2, c2, wts.pw2_w, wts.pw2_b, [&](int p) { return D + p * c2; },
      [&](int p, int o, float v) {
        const int64_t q = out_pixel(p);
        if (q >= 0) on[q + 2 * o + 1] = fmaxf(v, 0.f);
      });
}

constexpr size_t kSmemMax = 227 * 1024;

}  // namespace

// x [B,H,W,Cin] -> out [B,Ho,Wo,2*c2], Ho = (H-1)/stride + 1, both NHWC f32;
// one thread block per (image, tile x tile output pixels).
extern "C" int shuffle_block_f32(
    const void* x, void* out, int B, int H, int W, int Cin, int c2,
    int stride, int tile, const void* pw1_w, const void* pw1_b,
    const void* dw_w, const void* dw_b, const void* pw2_w, const void* pw2_b,
    const void* b1dw_w, const void* b1dw_b, const void* b1pw_w,
    const void* b1pw_b, void* stream) {
  if ((stride != 1 && stride != 2) || tile < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(tile, stride, Cin, c2);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const BlockWeights wts{
      static_cast<const float*>(pw1_w),  static_cast<const float*>(pw1_b),
      static_cast<const float*>(dw_w),   static_cast<const float*>(dw_b),
      static_cast<const float*>(pw2_w),  static_cast<const float*>(pw2_b),
      static_cast<const float*>(b1dw_w), static_cast<const float*>(b1dw_b),
      static_cast<const float*>(b1pw_w), static_cast<const float*>(b1pw_b)};
  const int Ho = (H - 1) / stride + 1;
  const int Wo = (W - 1) / stride + 1;
  const int tiles_x = (Wo + tile - 1) / tile;
  const int tiles_y = (Ho + tile - 1) / tile;
  const dim3 grid(tiles_x * tiles_y, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (stride == 2) {
    err = cudaFuncSetAttribute(shuffle_block_kernel<2>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    shuffle_block_kernel<2><<<grid, ynt::kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), wts, H, W,
        Cin, Ho, Wo, c2, tile, tiles_x);
  } else {
    err = cudaFuncSetAttribute(shuffle_block_kernel<1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    shuffle_block_kernel<1><<<grid, ynt::kThreads, smem, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), wts, H, W,
        Cin, Ho, Wo, c2, tile, tiles_x);
  }
  return static_cast<int>(cudaGetLastError());
}
