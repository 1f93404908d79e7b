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
// What bounds it on this card: the pointwise products, 96% of the
// operations. Kept to f32 accuracy they run as 3xTF32 on the tensor cores
// (three TF32 passes, 495 TFLOP/s each), so a forward at batch 32, 416 px
// (24.8 GFLOP in 16 launches) takes at least 3 * 24.8e9 / 495e12 = 0.150 ms;
// its 167 MB of stage inputs, outputs and weights take 0.050 ms at
// 3.35 TB/s. The kernel is bound by operations.
//
// What the design does about it:
//   - every pointwise product (pw1, pw2, branch1's pw) goes through the
//     3xTF32 mma.sync routine of mma_tf32.cuh; the depthwise 3x3 (4% of the
//     operations) stays on the CUDA cores, reading shared memory;
//   - weights stream through shared memory in 16-row chunks, double-buffered
//     with cp.async; prepare_stage zero-pads them to multiples of 8 rows and
//     columns, so a chunk is whole 16-byte copies and no product is masked;
//     the input region also arrives by cp.async;
//   - larger tiles than the CUDA-core design's (T is 5 to 13 at 416 px, as
//     shuffle_block_tile below picks it):
//     pw1 is recomputed on the 1-pixel halo of each tile, and larger tiles
//     recompute less. A whole stage does not fit in 227 KB of shared memory
//     (the stage2 output is 52*52*116*4 B ~ 1.25 MB per image), so each
//     launch fuses one block and only block outputs go through device memory
//     (mostly L2).
// The kernel stays far from that bound (PERF.md): mma.sync does not reach
// the 495 TFLOP/s that wgmma does, the products wait on latency with one
// block of 16 warps to an SM, and the steps around them (region fill,
// depthwise, stores) are not overlapped with them.

// One thread block per (image, T x T output tile); the tile needs an R x R
// input region, R = (T-1)*stride + 3. Shared memory, in floats after the
// region's offsets:
//   X: rows16(R*R) x ld, ld = act_stride(max(K1, c2)): the input region
//      (K1 channels, zero-padded), then pw1's output written over it in place;
//   D: rows16(P) x act_stride(c2) (stride 2: of max(Cin, c2)), P = T*T: a
//      depthwise output, the A operand of the product after it;
//   the weight chunks of mma_tf32::gemm.
// Steps:
//   1. the region of x (the stride-1 block reads x2 = x[c2:]) into X by
//      cp.async, 0 outside the image;
//   2. stride 2 only: branch1's depthwise 3x3/s2 of the region into D, then
//      its pw + relu to the even channels;
//   3. pw1 + relu over the region, in place, 0 outside the image (the
//      depthwise's zero pad);
//   4. depthwise 3x3 (+ bias, no act) at the tile's outputs into D, while
//      pw2's first weight chunk loads;
//   5. pw2 + relu to the odd channels. The stride-1 block first starts a
//      cp.async of x1 at the tile's pixels into X, writes pw2 over D in
//      place, then stores each output pixel, x1 and pw2 interleaved, in
//      16-byte stores.
// Blocks are 16 warps at up to 128 registers a thread, one to an SM: the
// products wait on latency, and a round of 16 warps covers twice the rows of
// 8 (for c2 = 232, 64 rows), so each block streams its weights half as often.
//
// The bf16 kernel (shuffle_block_bf16) is fused_stage_bf16.cu.
//
// The activation ACT is a compile-time parameter: ReLU (YOLO-Nano) or
// LeakyReLU (NanoDet-Plus), v >= 0 ? v : 0.1f * v on the sum with its
// bias, in every pointwise's epilogue (stage_act); the launch takes it as
// an int (ynt::Act), and each (stride, act) is a kernel of its own.

#include <cstdint>

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

using ynt::mma_tf32::act_stride;
using ynt::mma_tf32::round_up;
using ynt::mma_tf32::wbuf_floats;

constexpr int kThreads = ynt::mma_tf32::kWarps * 32;

// A pointwise's activation of its sum plus bias.
template <int ACT>
__device__ __forceinline__ float stage_act(float v) {
  if constexpr (ACT == ynt::ACT_LEAKY)
    return v >= 0.f ? v : 0.1f * v;
  else
    return fmaxf(v, 0.f);
}

struct BlockWeights {
  const float* pw1_w;   // [round8(K1)][round8(c2)], K1 = Cin (stride 2) or c2
  const float* pw1_b;   // [c2]
  const float* dw_w;    // [9][c2]
  const float* dw_b;    // [c2]
  const float* pw2_w;   // [round8(c2)][round8(c2)]
  const float* pw2_b;   // [c2]
  const float* b1dw_w;  // [9][Cin]   (stride 2 only)
  const float* b1dw_b;  // [Cin]
  const float* b1pw_w;  // [round8(Cin)][round8(c2)]
  const float* b1pw_b;  // [c2]
};

struct Layout {
  int R, P, ld, offs, x, d;  // offs: ints; x, d: floats after the offsets
  __host__ __device__ Layout(int tile, int stride, int cin, int c2) {
    R = (tile - 1) * stride + 3;
    P = tile * tile;
    const int k1 = stride == 2 ? cin : c2;
    ld = act_stride(k1 > c2 ? k1 : c2);
    // region cells' input offsets, then the tile pixels' output offsets;
    // a multiple of 4 keeps the float buffers 16-byte aligned
    offs = round_up(R * R + P, 4);
    x = round_up(R * R, 16) * ld;
    // stride 2: D holds branch1's depthwise output first
    d = round_up(P, 16) * act_stride(stride == 2 && cin > c2 ? cin : c2);
  }
  __host__ __device__ size_t bytes(int c2) const {
    return sizeof(int) * offs +
           sizeof(float) * (static_cast<size_t>(x) + d + wbuf_floats(c2));
  }
};

// Depthwise 3x3 (+ bias, no act) at the tile's P outputs: src is a region
// buffer (row stride lds, R x R cells), dst gets rows16(P) x round8(C) at
// row stride ldd, its pad columns 0. A thread keeps one channel's 9 taps and
// bias in registers and walks pixels; neighbouring threads take neighbouring
// channels.
template <int STRIDE>
__device__ __forceinline__ void depthwise(const float* src, int lds, int R,
                                          int tile, int C, const float* w,
                                          const float* b, float* dst,
                                          int ldd) {
  const int cp = round_up(C, 8);
  const int groups = max(1, static_cast<int>(blockDim.x) / cp);
  for (int i = threadIdx.x; i < groups * cp; i += blockDim.x) {
    const int c = i % cp;
    float tap[9];
    float bias = 0.f;
    if (c < C) {
#pragma unroll
      for (int k = 0; k < 9; ++k) tap[k] = __ldg(&w[k * C + c]);
      bias = __ldg(&b[c]);
    }
    int py = i / cp / tile;  // pixel p = py * tile + px, walked without
    int px = i / cp % tile;  // a division per step
    for (int p = i / cp; p < tile * tile; p += groups) {
      float acc = 0.f;
      if (c < C) {
        const float* s0 = src + (py * STRIDE * R + px * STRIDE) * lds + c;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            acc = fmaf(s0[(dy * R + dx) * lds], tap[dy * 3 + dx], acc);
        acc += bias;
      }
      dst[p * ldd + c] = acc;
      for (px += groups; px >= tile; px -= tile) ++py;
    }
  }
}

template <int STRIDE, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
    shuffle_block_kernel(const float* __restrict__ x, float* __restrict__ out,
                         BlockWeights wts, int H, int W, int Cin, int Ho,
                         int Wo, int c2, int tile, int tiles_x) {
  extern __shared__ float smem[];
  const Layout lay(tile, STRIDE, Cin, c2);
  const int R = lay.R;
  const int P = lay.P;
  const int ld = lay.ld;
  int* offs = reinterpret_cast<int*>(smem);
  int* opix = offs + R * R;
  float* X = smem + lay.offs;
  float* D = X + lay.x;
  float* wbuf = D + lay.d;
  const int Cout = 2 * c2;

  const int n = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_x) * tile;
  const int ox0 = (blockIdx.x % tiles_x) * tile;
  const float* xn = x + static_cast<int64_t>(n) * H * W * Cin;
  float* on = out + static_cast<int64_t>(n) * Ho * Wo * Cout;
  // input pixel (iy, ix) of region cell r and output pixel of tile pixel
  // p, as offsets; -1 outside the image
  for (int r = threadIdx.x; r < R * R; r += blockDim.x) {
    const int iy = oy0 * STRIDE - 1 + r / R;
    const int ix = ox0 * STRIDE - 1 + r % R;
    offs[r] = (iy >= 0 && iy < H && ix >= 0 && ix < W) ? (iy * W + ix) * Cin
                                                       : -1;
  }
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int oy = oy0 + p / tile;
    const int ox = ox0 + p % tile;
    opix[p] = (oy < Ho && ox < Wo) ? (oy * Wo + ox) * Cout : -1;
  }
  __syncthreads();

  // 1. the region into X by cp.async, 0 outside the image and in the pad
  //    columns; the stride-1 block reads x2 = x[c2:]
  const int k1 = STRIDE == 2 ? Cin : c2;
  const int k1p = round_up(k1, 8);
  const float* x_in = xn + (STRIDE == 2 ? 0 : c2);
  if (k1 % 4 == 0 && Cin % 4 == 0 &&
      reinterpret_cast<uintptr_t>(x_in) % 16 == 0) {
    const int vecs = k1p / 4;
    for (int i = threadIdx.x; i < R * R * vecs; i += blockDim.x) {
      const int r = i / vecs;
      const int c = i % vecs * 4;
      const bool in = offs[r] >= 0 && c < k1;
      ynt::mma_tf32::cp_async_zfill<16>(X + r * ld + c,
                                        in ? x_in + offs[r] + c : x_in, in);
    }
  } else {
    for (int i = threadIdx.x; i < R * R * k1p; i += blockDim.x) {
      const int r = i / k1p;
      const int c = i % k1p;
      const bool in = offs[r] >= 0 && c < k1;
      ynt::mma_tf32::cp_async_zfill<4>(X + r * ld + c,
                                       in ? x_in + offs[r] + c : x_in, in);
    }
  }
  ynt::mma_tf32::cp_async_commit();

  if (STRIDE == 2) {
    // 2. branch1: depthwise 3x3/s2 of the region into D, then its pw + relu
    //    to the even channels
    const int lde = act_stride(Cin);
    ynt::mma_tf32::prefetch(Cin, c2, wts.b1pw_w, wbuf);
    ynt::mma_tf32::cp_async_wait<1>();
    __syncthreads();
    depthwise<2>(X, ld, R, tile, Cin, wts.b1dw_w, wts.b1dw_b, D, lde);
    ynt::mma_tf32::gemm(P, Cin, c2, D, lde, wts.b1pw_w, wbuf, true,
                        [&](int p, int o, float v) {
                          const int q = opix[p];
                          if (q >= 0)
                            on[q + 2 * o] =
                                stage_act<ACT>(v + __ldg(&wts.b1pw_b[o]));
                        });
  } else {
    ynt::mma_tf32::prefetch(k1, c2, wts.pw1_w, wbuf);
  }

  // 3. pw1 + relu over the region, in place; 0 outside the image (the
  //    depthwise's zero pad)
  ynt::mma_tf32::gemm(R * R, k1, c2, X, ld, wts.pw1_w, wbuf, STRIDE == 1,
                      [&](int r, int o, float v) {
                        X[r * ld + o] =
                            offs[r] >= 0
                                ? stage_act<ACT>(v + __ldg(&wts.pw1_b[o]))
                                : 0.f;
                      });
  // pw2's first weight chunk loads during the depthwise
  ynt::mma_tf32::prefetch(c2, c2, wts.pw2_w, wbuf);
  __syncthreads();

  // 4. depthwise 3x3 (+ bias) at the tile's outputs into D
  const int ldd = act_stride(c2);
  depthwise<STRIDE>(X, ld, R, tile, c2, wts.dw_w, wts.dw_b, D, ldd);

  if (STRIDE == 2) {
    // 5. pw2 + relu to the odd channels
    ynt::mma_tf32::gemm(P, c2, c2, D, ldd, wts.pw2_w, wbuf, true,
                        [&](int p, int o, float v) {
                          const int q = opix[p];
                          if (q >= 0)
                            on[q + 2 * o + 1] =
                                stage_act<ACT>(v + __ldg(&wts.pw2_b[o]));
                        });
  } else {
    // 5. x1 of the tile's pixels into X (free once the depthwise is done) by
    //    cp.async, during pw2; pw2 + relu over D in place; then each output
    //    pixel, x1 and pw2 interleaved, in 16-byte stores
    __syncthreads();
    auto in_pixel = [&](int p) -> int64_t {
      const int iy = oy0 + p / tile;
      const int ix = ox0 + p % tile;
      return (iy < H && ix < W) ? (static_cast<int64_t>(iy) * W + ix) * Cin
                                : -1;
    };
    if (c2 % 4 == 0 && Cin % 4 == 0 &&
        reinterpret_cast<uintptr_t>(xn) % 16 == 0) {
      const int vecs = c2 / 4;
      for (int i = threadIdx.x; i < P * vecs; i += blockDim.x) {
        const int64_t q = in_pixel(i / vecs);
        const int c = i % vecs * 4;
        ynt::mma_tf32::cp_async_zfill<16>(X + (i / vecs) * c2 + c,
                                          q >= 0 ? xn + q + c : xn, q >= 0);
      }
    } else {
      for (int i = threadIdx.x; i < P * c2; i += blockDim.x) {
        const int64_t q = in_pixel(i / c2);
        const int c = i % c2;
        ynt::mma_tf32::cp_async_zfill<4>(X + i, q >= 0 ? xn + q + c : xn,
                                         q >= 0);
      }
    }
    ynt::mma_tf32::cp_async_commit();
    ynt::mma_tf32::gemm(P, c2, c2, D, ldd, wts.pw2_w, wbuf, true,
                        [&](int p, int o, float v) {
                          D[p * ldd + o] =
                              stage_act<ACT>(v + __ldg(&wts.pw2_b[o]));
                        });
    __syncthreads();
    const int pairs = c2 / 2;  // c2 is even
    for (int i = threadIdx.x; i < P * pairs; i += blockDim.x) {
      const int p = i / pairs;
      const int c = i % pairs * 2;
      if (opix[p] >= 0)
        *reinterpret_cast<float4*>(on + opix[p] + 2 * c) =
            make_float4(X[p * c2 + c], D[p * ldd + c], X[p * c2 + c + 1],
                        D[p * ldd + c + 1]);
    }
  }
}

constexpr size_t kSmemMax = 227 * 1024;

template <int STRIDE, int ACT>
cudaError_t launch(const float* x, float* out, const BlockWeights& wts, int B,
                   int H, int W, int Cin, int c2, int tile, size_t smem,
                   cudaStream_t s) {
  const int Ho = (H - 1) / STRIDE + 1;
  const int Wo = (W - 1) / STRIDE + 1;
  const int tiles_x = (Wo + tile - 1) / tile;
  const int tiles_y = (Ho + tile - 1) / tile;
  const cudaError_t err = cudaFuncSetAttribute(
      shuffle_block_kernel<STRIDE, ACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  shuffle_block_kernel<STRIDE, ACT><<<dim3(tiles_x * tiles_y, B), kThreads,
                                      smem, s>>>(x, out, wts, H, W, Cin, Ho,
                                                 Wo, c2, tile, tiles_x);
  return cudaGetLastError();
}

constexpr int kSMs = 132;  // streaming multiprocessors of an H100 SXM
// Work of a block outside the products (depthwise, stores) per tile pixel,
// in k-steps of the products; fitted to chip_smoke.py --sweep-stage-tiles
// on an H100 (PERF.md)
constexpr double kPixelSteps = 0.05;

// Rounds of mma_tf32::gemm for an m x n output: a round covers the m16
// tiles of the warps that N leaves along M.
int gemm_rounds(int m, int n) {
  const int per_round =
      ynt::mma_tf32::kWarps / ynt::mma_tf32::warps_n(n) * ynt::mma_tf32::kWM;
  return ((m + 15) / 16 + per_round - 1) / per_round;
}

// Modelled time of one launch at this tile side: the k-steps a block's warps
// run (rounds x K/8 of each product; the warps wait on latency, so a round
// with idle warps costs a full one) and kPixelSteps per tile pixel, times
// the waves of blocks over the SMs, one block to an SM.
double tile_cost(int tile, int stride, int Cin, int c2, int B, int Ho,
                 int Wo) {
  const int R = (tile - 1) * stride + 3;
  const int k1 = stride == 2 ? Cin : c2;
  const int rounds_tile = gemm_rounds(tile * tile, c2);
  int steps = gemm_rounds(R * R, c2) * ((k1 + 7) / 8) +
              rounds_tile * ((c2 + 7) / 8);
  if (stride == 2) steps += rounds_tile * ((Cin + 7) / 8);
  const int64_t blocks = static_cast<int64_t>(B) * ((Ho + tile - 1) / tile) *
                         ((Wo + tile - 1) / tile);
  const int64_t waves = (blocks + kSMs - 1) / kSMs;
  return waves * (steps + kPixelSteps * tile * tile);
}

}  // namespace

// Shared memory of one thread block, in bytes.
extern "C" size_t shuffle_block_smem_bytes(int tile, int stride, int Cin,
                                           int c2) {
  return Layout(tile, stride, Cin, c2).bytes(c2);
}

// Output tile side of one block launch: of the sides up to 16 whose shared
// memory fits, the one of least tile_cost (the larger on a tie); 0 if none
// fits. Larger tiles recompute less of pw1 on the halo and pad fewer rows to
// 16; smaller ones give more blocks to fill the SMs.
extern "C" int shuffle_block_tile(int stride, int Cin, int c2, int B, int Ho,
                                  int Wo) {
  int best = 0;
  double best_cost = 0.0;
  for (int tile = 1; tile <= 16; ++tile) {
    if (Layout(tile, stride, Cin, c2).bytes(c2) > kSmemMax) continue;
    const double cost = tile_cost(tile, stride, Cin, c2, B, Ho, Wo);
    if (best == 0 || cost <= best_cost) {
      best = tile;
      best_cost = cost;
    }
  }
  return best;
}

// x [B,H,W,Cin] -> out [B,Ho,Wo,2*c2], Ho = (H-1)/stride + 1, both NHWC f32;
// one thread block per (image, tile x tile output pixels); act ynt::ACT_RELU
// or ynt::ACT_LEAKY. The pointwise weights are zero-padded to multiples of 8
// rows and columns.
extern "C" int shuffle_block_f32(
    const void* x, void* out, int B, int H, int W, int Cin, int c2,
    int stride, int tile, int act, const void* pw1_w, const void* pw1_b,
    const void* dw_w, const void* dw_b, const void* pw2_w, const void* pw2_b,
    const void* b1dw_w, const void* b1dw_b, const void* b1pw_w,
    const void* b1pw_b, void* stream) {
  // mma_tf32::gemm's warps cover N = c2 up to kWarps * kNTW * 8 = 512
  if ((stride != 1 && stride != 2) || tile < 1 || c2 % 2 ||
      (act != ynt::ACT_RELU && act != ynt::ACT_LEAKY) ||
      round_up(c2, 8) > ynt::mma_tf32::kWarps * ynt::mma_tf32::kNTW * 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Layout(tile, stride, Cin, c2).bytes(c2);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const BlockWeights wts{
      static_cast<const float*>(pw1_w),  static_cast<const float*>(pw1_b),
      static_cast<const float*>(dw_w),   static_cast<const float*>(dw_b),
      static_cast<const float*>(pw2_w),  static_cast<const float*>(pw2_b),
      static_cast<const float*>(b1dw_w), static_cast<const float*>(b1dw_b),
      static_cast<const float*>(b1pw_w), static_cast<const float*>(b1pw_b)};
  const auto* xf = static_cast<const float*>(x);
  auto* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool leaky = act == ynt::ACT_LEAKY;
  const cudaError_t err =
      stride == 2
          ? (leaky ? launch<2, ynt::ACT_LEAKY>(xf, of, wts, B, H, W, Cin, c2,
                                               tile, smem, s)
                   : launch<2, ynt::ACT_RELU>(xf, of, wts, B, H, W, Cin, c2,
                                              tile, smem, s))
          : (leaky ? launch<1, ynt::ACT_LEAKY>(xf, of, wts, B, H, W, Cin, c2,
                                               tile, smem, s)
                   : launch<1, ynt::ACT_RELU>(xf, of, wts, B, H, W, Cin, c2,
                                              tile, smem, s));
  return static_cast<int>(err);
}
