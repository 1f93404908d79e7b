// Fused depthwise-3x3 -> act -> pointwise-1x1 -> act in f32, for Hopper
// (sm_90a). The bf16 kernel is fused_dw_pw_bf16.cu.
//
// Replaces the f32 variant of the TPU kernel
// yolo_nano_tpu/ops/pallas/fused_conv.py::fused_dw_pw (body `_kernel`): for
// x [B,H,W,C] (NHWC in memory)
//   out = act_out( act_mid( dw3x3(x, pad 1, stride 1) + dw_b ) @ pw_w + pw_b )
// with the depthwise taps and the pointwise products summed in f32. It runs
// the two dw->pw pairs of each detection head: C = Cout = 96 at 52x52, 26x26
// and 13x13 for a 416 input.
//
// What bounds it on this card: per output pixel it moves C inputs and Cout
// outputs and does 2*9*C + 2*C*Cout operations. Kept to f32 accuracy the
// product runs as 3xTF32 on the tensor cores (three passes at 495 TFLOP/s):
// at batch 32, 416 px the six calls of a forward move 174 MB (0.052 ms at
// 3.35 TB/s) and take 3 * 4.6 GFLOP / 495 TFLOP/s = 0.028 ms of products.
// The kernel is bound by bytes, provided the depthwise output never goes to
// device memory (the fusion) and the input loads overlap the compute.
//
// What the design does about it:
//   - the pointwise product goes through mma_tf32::gemm (3xTF32 mma.sync),
//     with the weights resident in shared memory: loaded once per block (by
//     16-byte cp.async where Cout allows) and zero-padded to multiples of 8
//     rows and columns there; the taps and biases sit beside them;
//   - a persistent grid, one block of 16 warps per SM, walks the tw x th
//     output tiles of all images; the next tile's input region arrives by
//     cp.async into a second buffer while the current tile's depthwise,
//     product and stores run;
//   - the tile is picked by dw_pw_tile_cost below so that a tile's pixels
//     fill whole gemm rounds (128 rows at Cout = 96) and the tiles spread
//     evenly over the SMs; fitted to chip_smoke.py --sweep-dw-pw-tiles;
//   - the depthwise stays on the CUDA cores, reading shared memory: a thread
//     takes one channel of one tile row and slides its 3x3 window along the
//     row, 3 loads per pixel;
//   - outputs go back through shared memory (the product's epilogue writes
//     over its own input rows) and leave in 16-byte stores.
// What holds it back (PERF.md; tools/probe_dw_pw.py times each phase with
// clock64 on the card): the product and its epilogue take about two thirds
// of a tile's cycles, issuing the hi/lo splits of every fragment and the
// f32 adds beside the mma.sync passes in every warp; the depthwise, the
// fill and the stores run between barriers, not beside the product.
//
// Shared memory of a block, in this order:
//   Ws:  round8(C) x w_stride(Cout) floats, the pointwise weights;
//   par: 9*C taps, C depthwise biases, Cout pointwise biases (floats,
//        rounded to 4);
//   D:   rows16(tw*th) x act_stride(max(C, Cout)) floats: the depthwise
//        output (the product's A operand, pad columns 0), then the output;
//   two region buffers of (th+2) x (tw+2) cells x ldr floats, ldr = C
//        rounded to 4, 0 outside the image (the pad 1).
// At C = Cout = 96 with a 13 x 9 tile: 39,936 + 4,224 + 51,200 +
// 2 x 63,360 = 222,080 bytes of the 232,448 a block may use.
// Widths whose weights and smallest tile do not fit (C = Cout above 216)
// are refused.
//
// The depthwise size K is a compile-time parameter: K = 3 above
// (fused_dw_pw_kernel), K = 5 for NanoDet-Plus's stride-1 pairs
// (fused_dw_pw5_kernel, with its own tile rule; the exports take K): a
// region of (th+4) x (tw+4) cells, 25 taps a channel
// (par holds 25*C taps), each thread of the depthwise sliding a 5x5 window
// along its row. Where the weights and the smallest tile's double-buffered
// region do not fit (C = 256, Cout = 128: the GhostBottleneck shortcut's
// weights alone take 139 KB), the K = 5 kernel streams the weights
// through mma_tf32::gemm's chunks instead (RESIDENT false; C and Cout then
// multiples of 8, the weights 16-byte aligned), whose waits then also wait
// on the next region's copies.

#include <cstdint>

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

using ynt::mma_tf32::act_stride;
using ynt::mma_tf32::round_up;
using ynt::mma_tf32::w_stride;

constexpr int kThreads = ynt::mma_tf32::kWarps * 32;
constexpr size_t kSmemMax = 227 * 1024;
constexpr int kSMs = 132;  // streaming multiprocessors of an H100 SXM

struct Layout {
  int P, cells, ldr, ldd, w, par, d;  // floats
  size_t region;                      // bytes of one region buffer
  // K: the depthwise size; resident: the weights in shared memory, else
  // the streamed chunks
  __host__ __device__ Layout(int tw, int th, int C, int Cout, int K = 3,
                             bool resident = true) {
    P = tw * th;
    cells = (tw + K - 1) * (th + K - 1);
    ldr = round_up(C, 4);
    ldd = act_stride(C > Cout ? C : Cout);
    w = resident ? round_up(C, 8) * w_stride(Cout)
                 : ynt::mma_tf32::wbuf_floats(Cout);
    // 16-byte aligned buffers after it
    par = round_up((K * K + 1) * C + Cout, 4);
    d = round_up(P, 16) * ldd;
    region = static_cast<size_t>(cells) * ldr * sizeof(float);
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * (static_cast<size_t>(w) + par + d) + 2 * region;
  }
};

using ynt::for_each_cell;

// Depthwise 3x3 (+ bias, act_mid) of a (th+2) x (tw+2) region
// into dst, rows16(tw*th) x round8(C) at row stride ldd, pad columns 0; w
// [9][C] and b [C] in shared memory. A thread takes one channel of one
// output row and slides the 3x3 window along it; neighbouring threads take
// neighbouring channels.
__device__ __forceinline__ void depthwise(const float* src, int ldr, int tw,
                                          int th, int C, const float* w,
                                          const float* b, int act_mid,
                                          float* dst, int ldd) {
  const int cp = round_up(C, 8);
  const int rw = tw + 2;
  const int row = rw * ldr;
  for (int i = threadIdx.x; i < th * cp; i += blockDim.x) {
    const int c = i % cp;
    const int y = i / cp;
    float* out = dst + y * tw * ldd + c;
    if (c >= C) {
      for (int px = 0; px < tw; ++px) out[px * ldd] = 0.f;
      continue;
    }
    float tap[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) tap[k] = w[k * C + c];
    const float bias = b[c];
    const float* s = src + y * row + c;
    // window columns px (l), px+1 (m), px+2 (r); rows dy = 0, 1, 2
    float l0 = s[0], l1 = s[row], l2 = s[2 * row];
    float m0 = s[ldr], m1 = s[row + ldr], m2 = s[2 * row + ldr];
    for (int px = 0; px < tw; ++px) {
      const float* sr = s + (px + 2) * ldr;
      const float r0 = sr[0], r1 = sr[row], r2 = sr[2 * row];
      float acc = 0.f;
      acc = fmaf(l0, tap[0], acc);
      acc = fmaf(m0, tap[1], acc);
      acc = fmaf(r0, tap[2], acc);
      acc = fmaf(l1, tap[3], acc);
      acc = fmaf(m1, tap[4], acc);
      acc = fmaf(r1, tap[5], acc);
      acc = fmaf(l2, tap[6], acc);
      acc = fmaf(m2, tap[7], acc);
      acc = fmaf(r2, tap[8], acc);
      out[px * ldd] = ynt::activate(acc + bias, act_mid);
      l0 = m0, l1 = m1, l2 = m2;
      m0 = r0, m1 = r1, m2 = r2;
    }
  }
}

// Depthwise KxK (K = 5; + bias, act_mid) of a (th+K-1) x (tw+K-1) region
// into dst as `depthwise` does: a thread takes one channel of one output row
// and slides the KxK window along it (K new loads a pixel), its FMAs in the
// order dy, then dx, from 0, then the bias.
template <int K>
__device__ __forceinline__ void depthwise_k(const float* src, int ldr, int tw,
                                            int th, int C, const float* w,
                                            const float* b, int act_mid,
                                            float* dst, int ldd) {
  const int cp = round_up(C, 8);
  const int row = (tw + K - 1) * ldr;
  for (int i = threadIdx.x; i < th * cp; i += blockDim.x) {
    const int c = i % cp;
    const int y = i / cp;
    float* out = dst + y * tw * ldd + c;
    if (c >= C) {
      for (int px = 0; px < tw; ++px) out[px * ldd] = 0.f;
      continue;
    }
    float tap[K * K];
#pragma unroll
    for (int k = 0; k < K * K; ++k) tap[k] = w[k * C + c];
    const float bias = b[c];
    const float* s = src + y * row + c;
    float win[K][K];  // win[dx][dy]: window column dx, row dy
#pragma unroll
    for (int dx = 0; dx < K - 1; ++dx)
#pragma unroll
      for (int dy = 0; dy < K; ++dy) win[dx][dy] = s[dy * row + dx * ldr];
    for (int px = 0; px < tw; ++px) {
      const float* sr = s + (px + K - 1) * ldr;
#pragma unroll
      for (int dy = 0; dy < K; ++dy) win[K - 1][dy] = sr[dy * row];
      float acc = 0.f;
#pragma unroll
      for (int dy = 0; dy < K; ++dy)
#pragma unroll
        for (int dx = 0; dx < K; ++dx)
          acc = fmaf(win[dx][dy], tap[dy * K + dx], acc);
      out[px * ldd] = ynt::activate(acc + bias, act_mid);
#pragma unroll
      for (int dx = 0; dx < K - 1; ++dx)
#pragma unroll
        for (int dy = 0; dy < K; ++dy) win[dx][dy] = win[dx + 1][dy];
    }
  }
}

// The kernel's body at depthwise size K, weights resident or streamed.
template <int K, bool RESIDENT>
__device__ __forceinline__ void dw_pw_body(
    const float* __restrict__ x, const float* __restrict__ dw_w,
    const float* __restrict__ dw_b, const float* __restrict__ pw_w,
    const float* __restrict__ pw_b, float* __restrict__ out, int B, int H,
    int W, int C, int Cout, int act_mid, int act_out, int tw, int th,
    bool vec_in, bool vec_w, bool vec_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kHalo = (K - 1) / 2;
  const Layout lay(tw, th, C, Cout, K, RESIDENT);
  float* Ws = reinterpret_cast<float*>(smem);  // or the streamed chunks
  float* par = Ws + lay.w;  // depthwise taps [K*K][C], dw_b [C], pw_b [Cout]
  float* D = par + lay.par;
  float* regions = D + lay.d;
  const int region_elems = lay.cells * lay.ldr;
  const int ldr = lay.ldr;
  const int ldd = lay.ldd;
  const int rw = tw + K - 1;
  const int tiles_x = (W + tw - 1) / tw;
  const int tiles_img = tiles_x * ((H + th - 1) / th);
  const int tiles = B * tiles_img;

  // the region of tile t (image, tile row, tile column) into buf: 16-byte
  // cp.async copies (zeros outside the image), or plain loads where x's
  // pixels are not 16-byte aligned
  auto fill = [&](int t, float* buf) {
    const int oy0 = t % tiles_img / tiles_x * th - kHalo;
    const int ox0 = t % tiles_x * tw - kHalo;
    const float* xn = x + static_cast<int64_t>(t / tiles_img) * H * W * C;
    auto pixel = [&](int cy, int cx) -> int64_t {
      const int iy = oy0 + cy;
      const int ix = ox0 + cx;
      return iy >= 0 && iy < H && ix >= 0 && ix < W
                 ? (static_cast<int64_t>(iy) * W + ix) * C
                 : -1;
    };
    if (vec_in) {
      for_each_cell(lay.cells, rw, C / 4, [&](int cy, int cx, int v) {
        const int64_t q = pixel(cy, cx);
        ynt::mma_tf32::cp_async_zfill<16>(buf + (cy * rw + cx) * ldr + v * 4,
                                          q >= 0 ? xn + q + v * 4 : xn,
                                          q >= 0);
      });
    } else {
      for_each_cell(lay.cells, rw, C, [&](int cy, int cx, int c) {
        const int64_t q = pixel(cy, cx);
        buf[(cy * rw + cx) * ldr + c] = q >= 0 ? xn[q + c] : 0.f;
      });
    }
    ynt::mma_tf32::cp_async_commit();
  };

  int t = blockIdx.x;
  if (t < tiles) fill(t, regions);
  // the weights, taps and biases, once per block, while the first region
  // arrives: the weights by 16-byte cp.async where Cout allows, zeros in the
  // pad rows and columns
  const int kp = round_up(C, 8);
  const int np = round_up(Cout, 8);
  const int ldw = w_stride(Cout);
  if (!RESIDENT) {
    // streamed by the product, chunk by chunk
  } else if (vec_w) {
    for_each_cell(kp, 1, np / 4, [&](int k, int, int v) {
      const bool in = k < C && v * 4 < Cout;
      ynt::mma_tf32::cp_async_zfill<16>(
          Ws + k * ldw + v * 4, in ? pw_w + k * Cout + v * 4 : pw_w, in);
    });
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < kp * np; i += blockDim.x) {
      const int k = i / np;
      const int o = i % np;
      Ws[k * ldw + o] = k < C && o < Cout ? pw_w[k * Cout + o] : 0.f;
    }
  }
  ynt::mma_tf32::cp_async_commit();
  constexpr int kTaps = K * K;
  for (int i = threadIdx.x; i < (kTaps + 1) * C + Cout; i += blockDim.x)
    par[i] = i < kTaps * C         ? dw_w[i]
             : i < (kTaps + 1) * C ? dw_b[i - kTaps * C]
                                   : pw_b[i - (kTaps + 1) * C];

  for (int it = 0; t < tiles; ++it, t += gridDim.x) {
    const float* cur = regions + (it & 1) * region_elems;
    if (t + gridDim.x < tiles)
      fill(t + gridDim.x, regions + ((it + 1) & 1) * region_elems);
    else
      ynt::mma_tf32::cp_async_commit();  // an empty group keeps the count
    ynt::mma_tf32::cp_async_wait<1>();   // all but the next tile's region
    __syncthreads();  // ... and the last tile's stores are done with D

    if constexpr (K == 3)
      depthwise(cur, ldr, tw, th, C, par, par + 9 * C, act_mid, D, ldd);
    else
      depthwise_k<K>(cur, ldr, tw, th, C, par, par + kTaps * C, act_mid, D,
                     ldd);
    __syncthreads();

    ynt::mma_tf32::gemm<RESIDENT>(
        lay.P, C, Cout, D, ldd, RESIDENT ? Ws : pw_w,
        RESIDENT ? nullptr : Ws, RESIDENT,
        [&](int m, int n, float v) {
          D[m * ldd + n] =
              ynt::activate(v + par[(kTaps + 1) * C + n], act_out);
        });
    __syncthreads();

    const int oy0 = t % tiles_img / tiles_x * th;
    const int ox0 = t % tiles_x * tw;
    float* on = out + static_cast<int64_t>(t / tiles_img) * H * W * Cout;
    if (vec_out) {
      for_each_cell(lay.P, tw, Cout / 4, [&](int py, int px, int v) {
        const int oy = oy0 + py;
        const int ox = ox0 + px;
        if (oy < H && ox < W)
          *reinterpret_cast<float4*>(
              on + (static_cast<int64_t>(oy) * W + ox) * Cout + v * 4) =
              *reinterpret_cast<const float4*>(D + (py * tw + px) * ldd +
                                               v * 4);
      });
    } else {
      for (int i = threadIdx.x; i < lay.P * Cout; i += blockDim.x) {
        const int p = i / Cout;
        const int c = i % Cout;
        const int oy = oy0 + p / tw;
        const int ox = ox0 + p % tw;
        if (oy < H && ox < W)
          on[(static_cast<int64_t>(oy) * W + ox) * Cout + c] = D[p * ldd + c];
      }
    }
    // D is next written after the barrier that follows the next wait
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    fused_dw_pw_kernel(const float* __restrict__ x,
                       const float* __restrict__ dw_w,
                       const float* __restrict__ dw_b,
                       const float* __restrict__ pw_w,
                       const float* __restrict__ pw_b, float* __restrict__ out,
                       int B, int H, int W, int C, int Cout, int act_mid,
                       int act_out, int tw, int th, bool vec_in,
                       bool vec_w, bool vec_out) {
  dw_pw_body<3, true>(x, dw_w, dw_b, pw_w, pw_b, out, B, H, W, C, Cout,
                      act_mid, act_out, tw, th, vec_in, vec_w, vec_out);
}

template <bool RESIDENT>
__global__ void __launch_bounds__(kThreads, 1)
    fused_dw_pw5_kernel(const float* __restrict__ x,
                        const float* __restrict__ dw_w,
                        const float* __restrict__ dw_b,
                        const float* __restrict__ pw_w,
                        const float* __restrict__ pw_b,
                        float* __restrict__ out, int B, int H, int W, int C,
                        int Cout, int act_mid, int act_out, int tw, int th,
                        bool vec_in, bool vec_w, bool vec_out) {
  dw_pw_body<5, RESIDENT>(x, dw_w, dw_b, pw_w, pw_b, out, B, H, W, C, Cout,
                          act_mid, act_out, tw, th, vec_in, vec_w, vec_out);
}

// Whether the K = 5 kernel keeps its weights resident: where they and the
// smallest tile's two regions fit.
bool resident5(int C, int Cout) {
  return Layout(1, 1, C, Cout, 5, true).bytes() <= kSmemMax;
}

int launch(int K, const float* x, const float* dw_w, const float* dw_b,
           const float* pw_w, const float* pw_b, float* out, int B, int H,
           int W, int C, int Cout, int act_mid, int act_out, int tw, int th,
           cudaStream_t stream) {
  // mma_tf32::gemm's warps cover N = Cout up to kWarps * kNTW * 8 = 512
  if ((K != 3 && K != 5) || tw < 1 || th < 1 || C < 1 ||
      round_up(Cout, 8) > ynt::mma_tf32::kWarps * ynt::mma_tf32::kNTW * 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool resident = K == 3 || resident5(C, Cout);
  // streamed weights: whole 16-byte chunk rows of [C][Cout]
  if (!resident && (C % 8 || Cout % 8 ||
                    reinterpret_cast<uintptr_t>(pw_w) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Layout(tw, th, C, Cout, K, resident).bytes();
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn =
      K == 3     ? reinterpret_cast<const void*>(fused_dw_pw_kernel)
      : resident ? reinterpret_cast<const void*>(fused_dw_pw5_kernel<true>)
                 : reinterpret_cast<const void*>(fused_dw_pw5_kernel<false>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = static_cast<int64_t>(B) * ((H + th - 1) / th) *
                        ((W + tw - 1) / tw);
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_in = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w =
      Cout % 4 == 0 && reinterpret_cast<uintptr_t>(pw_w) % 16 == 0;
  const bool vec_out =
      Cout % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  if (K == 3)
    fused_dw_pw_kernel<<<grid, kThreads, smem, stream>>>(
        x, dw_w, dw_b, pw_w, pw_b, out, B, H, W, C, Cout, act_mid, act_out,
        tw, th, vec_in, vec_w, vec_out);
  else if (resident)
    fused_dw_pw5_kernel<true><<<grid, kThreads, smem, stream>>>(
        x, dw_w, dw_b, pw_w, pw_b, out, B, H, W, C, Cout, act_mid, act_out,
        tw, th, vec_in, vec_w, vec_out);
  else
    fused_dw_pw5_kernel<false><<<grid, kThreads, smem, stream>>>(
        x, dw_w, dw_b, pw_w, pw_b, out, B, H, W, C, Cout, act_mid, act_out,
        tw, th, vec_in, vec_w, vec_out);
  return static_cast<int>(cudaGetLastError());
}

// Work of a block per region cell (input load, depthwise) and per tile row
// (the depthwise's setup of a row), in gemm rounds; fitted to chip_smoke.py
// --sweep-dw-pw-tiles on an H100 (PERF.md).
constexpr double kCellRounds = 0.3 / 128;
constexpr double kRowRounds = 0.02;

// Modelled time of one launch with tw x th tiles: the gemm rounds of a tile
// (a round with idle warps costs a full one), kCellRounds per region cell
// and kRowRounds per tile row, times the tiles of the busiest block of the
// persistent grid, one block to an SM.
double dw_pw_tile_cost(int tw, int th, int B, int H, int W, int Cout) {
  const int per_round = ynt::mma_tf32::kWarps /
                        ynt::mma_tf32::warps_n(Cout) * ynt::mma_tf32::kWM;
  const int rounds = ((tw * th + 15) / 16 + per_round - 1) / per_round;
  const int64_t tiles = static_cast<int64_t>(B) * ((H + th - 1) / th) *
                        ((W + tw - 1) / tw);
  const int64_t waves = (tiles + kSMs - 1) / kSMs;
  return waves * (rounds + kCellRounds * (tw + 2) * (th + 2) +
                  kRowRounds * th);
}

// The K = 5 kernel's cost model (fused_dw_pw_tile at K = 5):
// dw_pw_tile_cost with the 5x5 region's cells and kPixelRounds5 per tile
// pixel for the 25-tap depthwise. Not fitted to a sweep: no cell runs the
// f32 5x5 pairs.
constexpr double kPixelRounds5 = 0.01;

double dw_pw5_tile_cost(int tw, int th, int B, int H, int W, int Cout) {
  const int per_round = ynt::mma_tf32::kWarps /
                        ynt::mma_tf32::warps_n(Cout) * ynt::mma_tf32::kWM;
  const int rounds = ((tw * th + 15) / 16 + per_round - 1) / per_round;
  const int64_t tiles = static_cast<int64_t>(B) * ((H + th - 1) / th) *
                        ((W + tw - 1) / tw);
  const int64_t waves = (tiles + kSMs - 1) / kSMs;
  return waves * (rounds + kCellRounds * (tw + 4) * (th + 4) +
                  kRowRounds * th + kPixelRounds5 * tw * th);
}

}  // namespace

// The exports take the depthwise size K, 3 or 5; each K is a kernel of its
// own (fused_dw_pw_kernel, fused_dw_pw5_kernel) with its own tile rule.

// Shared memory of one thread block, in bytes (at K = 5 with the weights
// resident or streamed, as the launch takes them); 0 for another K.
extern "C" size_t fused_dw_pw_smem_bytes(int tw, int th, int C, int Cout,
                                         int K) {
  if (K != 3 && K != 5) return 0;
  return Layout(tw, th, C, Cout, K, K == 3 || resident5(C, Cout)).bytes();
}

// Output tile (tw columns x th rows) of one launch: of the tiles up to
// 64 x 64, and no larger than the image, whose shared memory fits, the one
// of least dw_pw_tile_cost (K = 3) or dw_pw5_tile_cost (K = 5), the first
// found on a tie, in order of tw, then th. Returns 0 and leaves tw, th
// alone if none fits.
extern "C" int fused_dw_pw_tile(int B, int H, int W, int C, int Cout, int K,
                                int* tw, int* th) {
  if (K != 3 && K != 5) return 0;
  const bool resident = K == 3 || resident5(C, Cout);
  double best = 0.0;
  int found = 0;
  for (int w = 1; w <= 64 && w <= W; ++w) {
    for (int h = 1; h <= 64 && h <= H; ++h) {
      if (Layout(w, h, C, Cout, K, resident).bytes() > kSmemMax) continue;
      const double cost = K == 3 ? dw_pw_tile_cost(w, h, B, H, W, Cout)
                                 : dw_pw5_tile_cost(w, h, B, H, W, Cout);
      if (!found || cost < best) {
        found = 1;
        best = cost;
        *tw = w;
        *th = h;
      }
    }
  }
  return found;
}

// x [B,H,W,C] -> out [B,H,W,Cout], NHWC, all f32; dw_w [K,K,C], dw_b [C],
// pw_w [C,Cout], pw_b [Cout]. One persistent block per SM walks the tw x th
// output tiles.
extern "C" int fused_dw_pw_f32(const void* x, const void* dw_w,
                               const void* dw_b, const void* pw_w,
                               const void* pw_b, void* out, int B, int H,
                               int W, int C, int Cout, int K, int act_mid,
                               int act_out, int tw, int th, void* stream) {
  return launch(
      K, static_cast<const float*>(x), static_cast<const float*>(dw_w),
      static_cast<const float*>(dw_b), static_cast<const float*>(pw_w),
      static_cast<const float*>(pw_b), static_cast<float*>(out), B, H, W, C,
      Cout, act_mid, act_out, tw, th, static_cast<cudaStream_t>(stream));
}
