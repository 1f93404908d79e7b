// Fused depthwise-3x3 -> act -> pointwise-1x1 -> act in bf16, for Hopper
// (sm_90a). The f32 kernel is fused_dw_pw.cu.
//
// Replaces the bf16 variant of the TPU kernel
// yolo_nano_tpu/ops/pallas/fused_conv.py::fused_dw_pw (body `_kernel`,
// lines 75-95): for x [B,H,W,C] bf16 (NHWC in memory)
//   mid = bf16( act_mid( dw3x3(x, pad 1, stride 1) + dw_b ) ),
//   out = bf16( act_out( mid @ pw_w + pw_b ) ),
// the depthwise taps (f32) summed in f32 on the bf16 inputs, the pointwise
// product on bf16 operands with f32 sums. It runs the two dw->pw pairs of
// each detection head of a bf16 model: C = Cout = 96 at 52x52, 26x26 and
// 13x13 for a 416 input.
//
// What bounds it on this card: bytes. Per output pixel it reads C and writes
// Cout bf16 values and does 2*9*C + 2*C*Cout operations: at batch 32, 416
// px the six calls of a forward move 87 MB (0.0261 ms at 3.35 TB/s) and do
// 4.6 GFLOP (0.0046 ms at 989 TFLOP/s).
//
// What the design does about it:
//   - everything the block keeps is bf16, as the function defines it: the
//     input region, the depthwise output (the product's A operand, at the
//     ldmatrix-friendly row stride mma_bf16::act_stride) and the resident
//     pointwise weights, transposed to Wt[n][k] and zero-padded in the
//     block's prologue from pw_w [C,Cout] (no host preparation; a thread
//     loads its 16-byte rows before it stores any, the taps and biases
//     arrive by cp.async meanwhile). At C = Cout = 96 and the 13 x 9 tile a
//     block takes 112 KB, so two blocks share an SM and one block's fill,
//     depthwise and stores run beside the other's product;
//   - the product is mma_bf16::gemm with the weights resident: m16n8k16 bf16
//     mma.sync, A by ldmatrix.x4, each k-step from a fresh zero added to the
//     running f32 sum (mma_bf16.cuh says why); its epilogue writes
//     act_out(v + pw_b) in bf16 over its own A rows, and the tile leaves in
//     16-byte stores;
//   - a persistent grid of (blocks an SM) x 132 blocks walks the tw x th
//     output tiles; the next tile's region arrives by 16-byte cp.async (zero
//     fill outside the image: the pad) into a second buffer while the
//     current tile computes. A TMA tensor map would give the pad by its
//     out-of-bounds fill as well; it was not built: cp.async was measured;
//   - the depthwise takes channel pairs: a thread keeps one pair's taps in
//     registers and slides the 3x3 window along a segment of a tile row,
//     three 4-byte __nv_bfloat162 loads a pixel, 4 pixels a step with all
//     of a step's loads issued first, f32 FMAs in the order of the f32
//     kernel (dy, then dx, from 0; then the bias). A step of 8 pixels
//     spilled registers (688 bytes of loads a thread) and ran slower;
//   - its own tile rule (fused_dw_pw_bf16_tile), a cost model of a tile's
//     product, fill, depthwise and stores and of the waves of tiles over
//     the SMs at the occupancy the runtime reports, fitted to
//     chip_smoke.py --sweep-dw-pw-tiles at batch 32, 8 and 1; small grids
//     take small tiles, so that batch 1 still spreads over the SMs.
// What still holds it back (PERF.md; tools/probe_dw_pw.py, clock64 probes
// on an H100): 6.6x its bound at batch 32 (0.172 ms a forward). At 52x52
// a 13 x 9 tile takes about 11k cycles of depthwise and 11k of product
// and epilogue, 3k of stores and 3k of region wait, with 1.8 blocks
// resident on an SM: 16 warps an SM, each phase a chain of dependent
// loads, FMAs or mma.sync and f32 adds between barriers, issue- and
// latency-bound, not byte-bound. At batch 1 a launch takes about 9 us, of
// which the block prologue (weights, taps, first region) is 3 us.
//
// Shared memory of a block, in this order:
//   par: 9*C taps, C depthwise biases, Cout pointwise biases and a zero
//        (f32, rounded to 4);
//   Wt:  round8(Cout) x w_stride(round16(C)) bf16, the pointwise weights;
//   D:   rows16(tw*th) x act_stride(max(C, Cout)) bf16: the depthwise output
//        (columns C..round16(C)-1 zero), then the output;
//   two region buffers of (th+2) x (tw+2) cells x round8(C) bf16, 0 outside
//        the image.
// Cout above 256 takes the product's wide variant (8 n8 tiles a warp, one
// block an SM); Cout up to 512 whose weights and smallest tile fit.
//
// The depthwise size K is a compile-time parameter: K = 3 above
// (fused_dw_pw_bf16_kernel), K = 5 for NanoDet-Plus's stride-1 pairs
// (fused_dw_pw5_bf16_kernel, with its own tile rule; the exports take K):
// at C = Cout = 128 (the heads) and C = 256, Cout = 128 (the
// GhostBottleneck shortcuts, no activation). The region is (th+4) x (tw+4)
// cells and par holds 25*C taps. Its depthwise (depthwise5) keeps
// a channel pair's 25 taps in registers and, for a step of kPx5 pixels,
// loads each of the 5 window rows' kPx5 + 4 cells once and sums the step's
// outputs from them (a sliding 5x5 window would hold 4 x 5 pairs more
// registers than two blocks an SM allow); its FMAs run in the K = 3 order,
// dy, then dx, from 0, then the bias.

#include <cstdint>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace {

namespace mb = ynt::mma_bf16;
using mb::act_stride;
using mb::round_up;
using ynt::for_each_cell;
using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kThreads = mb::kWarps * 32;
constexpr size_t kSmemMax = 227 * 1024;
constexpr int kSMs = 132;  // streaming multiprocessors of an H100 SXM

struct Layout {
  int P, cells, ldr, ldd, ldw, kp, np;
  int par;               // floats
  int w, d, region;      // bf16 elements
  __host__ __device__ Layout(int tw, int th, int C, int Cout, int K = 3) {
    P = tw * th;
    cells = (tw + K - 1) * (th + K - 1);
    ldr = round_up(C, 8);
    kp = round_up(C, 16);
    np = round_up(Cout, 8);
    ldw = mb::w_stride(kp);
    ldd = act_stride(C > Cout ? C : Cout);
    // 16-byte aligned buffers after it
    par = round_up((K * K + 1) * C + Cout + 1, 4);
    w = np * ldw;
    d = round_up(P, 16) * ldd;
    region = cells * ldr;
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * static_cast<size_t>(par) +
           sizeof(bf16) * (static_cast<size_t>(w) + d + 2 * region);
  }
};

// Segments a tile row is cut into for the depthwise: about 8 pixels each.
__host__ __device__ inline int row_segments(int tw) { return (tw + 7) / 8; }

constexpr int kPx = 4;       // pixels of a depthwise step
constexpr int kWBatch = 8;   // weight vectors a thread loads before storing
constexpr int kOutBatch = 4; // output vectors a thread reads before storing

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
}

// Depthwise 3x3 (+ bias, act_mid, rounded to bf16) of a (th+2) x (tw+2)
// region (ldr channels a cell) into dst, rows p = py * tw + px at row stride
// ldd, columns C..round16(C)-1 zero; w [9][C] and b [C] in shared memory. A
// thread keeps one channel pair's taps in registers (blockDim / pairs
// threads share a pair) and walks segments of tile rows, kPx pixels a step:
// the step's new window columns are all loaded before any of its outputs
// is summed, so its 2 * kPx FMA chains (dy, then dx, from 0; then the
// bias) run side by side. An odd C's last pair has a zero tap and bias
// beside it (and a zero region channel), so its pad column comes out 0.
__device__ __forceinline__ void depthwise(const bf16* __restrict__ src,
                                          int ldr, int tw, int th, int C,
                                          const float* w, const float* b,
                                          int act, bf16* __restrict__ dst,
                                          int ldd) {
  const int pairs = (C + 1) / 2;
  const int groups = max(1, static_cast<int>(blockDim.x) / pairs);
  const int segs = row_segments(tw);
  const int seg = (tw + segs - 1) / segs;
  const int row = (tw + 2) * ldr;
  for (int i = threadIdx.x; i < groups * pairs; i += blockDim.x) {
    const int c = i % pairs * 2;
    const bool odd = c + 1 >= C;
    float2 tap[9];
#pragma unroll
    for (int k = 0; k < 9; ++k)
      tap[k] = make_float2(w[k * C + c], odd ? 0.f : w[k * C + c + 1]);
    const float2 bias = make_float2(b[c], odd ? 0.f : b[c + 1]);
    for (int item = i / pairs; item < th * segs; item += groups) {
      const int y = item / segs;
      const int x0 = item % segs * seg;
      const int x1 = min(x0 + seg, tw);
      const bf16* sp = src + (y * (tw + 2) + x0) * ldr + c;
      bf16* op = dst + (y * tw + x0) * ldd + c;
      // window columns: win[q] is region column x + q of the step at x
      float2 win[kPx + 2][3];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
          win[q][dy] = load2(sp + q * ldr + dy * row);
      for (int x = x0; x < x1; x += kPx, sp += kPx * ldr, op += kPx * ldd) {
        const int n = min(kPx, x1 - x);
#pragma unroll
        for (int q = 0; q < kPx; ++q) {
          if (q >= n) continue;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
            win[q + 2][dy] = load2(sp + (q + 2) * ldr + dy * row);
        }
#pragma unroll
        for (int q = 0; q < kPx; ++q) {
          float ax = 0.f, ay = 0.f;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              ax = fmaf(win[q + dx][dy].x, tap[dy * 3 + dx].x, ax);
              ay = fmaf(win[q + dx][dy].y, tap[dy * 3 + dx].y, ay);
            }
          if (q < n)
            *reinterpret_cast<bf162*>(op + q * ldd) =
                __floats2bfloat162_rn(ynt::activate(ax + bias.x, act),
                                      ynt::activate(ay + bias.y, act));
        }
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          win[0][dy] = win[kPx][dy];
          win[1][dy] = win[kPx + 1][dy];
        }
      }
    }
  }
  // the pad columns 2 * pairs .. round16(C) - 1
  const int pad = (round_up(C, 16) - 2 * pairs) / 2;  // words a row
  for (int i = threadIdx.x; i < tw * th * pad; i += blockDim.x)
    *reinterpret_cast<uint32_t*>(dst + i / pad * ldd + 2 * pairs +
                                 i % pad * 2) = 0u;
}

constexpr int kPx5 = 4;  // pixels of a depthwise5 step

// Depthwise 5x5 (+ bias, act, rounded to bf16) of a (th+4) x (tw+4) region
// into dst, as `depthwise` lays it out (module comment): a thread keeps a
// channel pair's taps in registers and walks segments of tile rows, kPx5
// pixels a step; for each window row dy it loads the step's kPx5 + 4 cells
// of that row once and adds their products to the step's sums.
__device__ __forceinline__ void depthwise5(const bf16* __restrict__ src,
                                           int ldr, int tw, int th, int C,
                                           const float* w, const float* b,
                                           int act, bf16* __restrict__ dst,
                                           int ldd) {
  constexpr int K = 5;
  const int pairs = (C + 1) / 2;
  const int groups = max(1, static_cast<int>(blockDim.x) / pairs);
  const int segs = row_segments(tw);
  const int seg = (tw + segs - 1) / segs;
  const int row = (tw + K - 1) * ldr;
  for (int i = threadIdx.x; i < groups * pairs; i += blockDim.x) {
    const int c = i % pairs * 2;
    const bool odd = c + 1 >= C;
    float2 tap[K * K];
#pragma unroll
    for (int k = 0; k < K * K; ++k)
      tap[k] = make_float2(w[k * C + c], odd ? 0.f : w[k * C + c + 1]);
    const float2 bias = make_float2(b[c], odd ? 0.f : b[c + 1]);
    for (int item = i / pairs; item < th * segs; item += groups) {
      const int y = item / segs;
      const int x0 = item % segs * seg;
      const int x1 = min(x0 + seg, tw);
      const bf16* sp = src + (y * (tw + K - 1) + x0) * ldr + c;
      bf16* op = dst + (y * tw + x0) * ldd + c;
      for (int x = x0; x < x1; x += kPx5, sp += kPx5 * ldr, op += kPx5 * ldd) {
        const int n = min(kPx5, x1 - x);
        float ax[kPx5], ay[kPx5];
#pragma unroll
        for (int q = 0; q < kPx5; ++q) ax[q] = ay[q] = 0.f;
#pragma unroll
        for (int dy = 0; dy < K; ++dy) {
          float2 r[kPx5 + K - 1];
#pragma unroll
          for (int q = 0; q < kPx5 + K - 1; ++q)
            r[q] = q < n + K - 1 ? load2(sp + q * ldr + dy * row)
                                 : make_float2(0.f, 0.f);
#pragma unroll
          for (int q = 0; q < kPx5; ++q)
#pragma unroll
            for (int dx = 0; dx < K; ++dx) {
              ax[q] = fmaf(r[q + dx].x, tap[dy * K + dx].x, ax[q]);
              ay[q] = fmaf(r[q + dx].y, tap[dy * K + dx].y, ay[q]);
            }
        }
#pragma unroll
        for (int q = 0; q < kPx5; ++q)
          if (q < n)
            *reinterpret_cast<bf162*>(op + q * ldd) =
                __floats2bfloat162_rn(ynt::activate(ax[q] + bias.x, act),
                                      ynt::activate(ay[q] + bias.y, act));
      }
    }
  }
  // the pad columns 2 * pairs .. round16(C) - 1
  const int pad = (round_up(C, 16) - 2 * pairs) / 2;  // words a row
  for (int i = threadIdx.x; i < tw * th * pad; i += blockDim.x)
    *reinterpret_cast<uint32_t*>(dst + i / pad * ldd + 2 * pairs +
                                 i % pad * 2) = 0u;
}

// The bf16 pair (lo, hi) as one 32-bit word, and back.
__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return __bfloat16_as_ushort(lo) |
         static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16;
}
__device__ __forceinline__ bf16 half_of(uint32_t w, int q) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(w >> (16 * q)));
}

// Wt[n][k] = pw_w[k][n] (k < C, n < Cout; zeros up to round16(C) x
// round8(Cout)), at row stride ldw. A thread loads up to kWBatch vectors of
// 8 columns of pw_w's rows (16-byte loads where Cout and the pointer allow)
// before it stores any into Wt's columns; neighbouring threads take
// neighbouring rows k, so the stores of a warp fall on distinct banks.
__device__ __forceinline__ void transpose_weights(const bf16* __restrict__ pw_w,
                                                  int C, int Cout, int kp,
                                                  int np, bf16* Wt, int ldw) {
  const bool vec = Cout % 8 == 0 && reinterpret_cast<uintptr_t>(pw_w) % 16 == 0;
  const int total = kp * (np / 8);
  for (int base = threadIdx.x; base < total;
       base += kWBatch * static_cast<int>(blockDim.x)) {
    uint4 v[kWBatch];
#pragma unroll
    for (int e = 0; e < kWBatch; ++e) {
      const int i = base + e * blockDim.x;
      const int k = i % kp;
      const int n = i / kp * 8;
      v[e] = make_uint4(0u, 0u, 0u, 0u);
      if (i >= total || k >= C) continue;
      const bf16* r = pw_w + k * Cout + n;
      if (vec) {
        v[e] = __ldg(reinterpret_cast<const uint4*>(r));
      } else {
        const bf16 z = __float2bfloat16(0.f);
        uint32_t u[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          u[q] = pack(n + 2 * q < Cout ? r[2 * q] : z,
                      n + 2 * q + 1 < Cout ? r[2 * q + 1] : z);
        v[e] = make_uint4(u[0], u[1], u[2], u[3]);
      }
    }
#pragma unroll
    for (int e = 0; e < kWBatch; ++e) {
      const int i = base + e * blockDim.x;
      if (i >= total) continue;
      const int k = i % kp;
      const int n = i / kp * 8;
      const uint32_t u[4] = {v[e].x, v[e].y, v[e].z, v[e].w};
#pragma unroll
      for (int q = 0; q < 8; ++q)
        Wt[(n + q) * ldw + k] = half_of(u[q / 2], q % 2);
    }
  }
}

// The kernel's body at depthwise size K. v_in, v_out: channels a copy (8:
// 16 bytes; 2: 4 bytes; 1: single loads or stores), as x's and out's
// alignment and C, Cout allow.
template <int K, int NTW>
__device__ __forceinline__ void dw_pw_body(
    const bf16* __restrict__ x, const float* __restrict__ dw_w,
    const float* __restrict__ dw_b, const bf16* __restrict__ pw_w,
    const float* __restrict__ pw_b, bf16* __restrict__ out, int B, int H,
    int W, int C, int Cout, int act_mid, int act_out, int tw, int th,
    int v_in, int v_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kHalo = (K - 1) / 2;
  constexpr int kTaps = K * K;
  const Layout lay(tw, th, C, Cout, K);
  float* par = reinterpret_cast<float*>(smem);  // taps, dw_b, pw_b, 0
  bf16* Wt = reinterpret_cast<bf16*>(par + lay.par);
  bf16* D = Wt + lay.w;
  bf16* regions = D + lay.d;
  const int rw = tw + K - 1;
  const int ldr = lay.ldr;
  const int ldd = lay.ldd;
  const int tiles_x = (W + tw - 1) / tw;
  const int tiles_img = tiles_x * ((H + th - 1) / th);
  const int tiles = B * tiles_img;

  // the region of tile t (image, tile row, tile column) into buf, zeros
  // outside the image and in an odd C's pad channel; one cp.async group
  auto fill = [&](int t, bf16* buf) {
    const int oy0 = t % tiles_img / tiles_x * th - kHalo;
    const int ox0 = t % tiles_x * tw - kHalo;
    const bf16* xn = x + static_cast<int64_t>(t / tiles_img) * H * W * C;
    auto pixel = [&](int cy, int cx) -> int64_t {
      const int iy = oy0 + cy;
      const int ix = ox0 + cx;
      return iy >= 0 && iy < H && ix >= 0 && ix < W
                 ? (static_cast<int64_t>(iy) * W + ix) * C
                 : -1;
    };
    if (v_in == 8) {
      for_each_cell(lay.cells, rw, C / 8, [&](int cy, int cx, int v) {
        const int64_t q = pixel(cy, cx);
        mb::cp_async_zfill<16>(buf + (cy * rw + cx) * ldr + v * 8,
                               q >= 0 ? xn + q + v * 8 : xn, q >= 0);
      });
    } else if (v_in == 2) {
      for_each_cell(lay.cells, rw, C / 2, [&](int cy, int cx, int v) {
        const int64_t q = pixel(cy, cx);
        mb::cp_async_zfill<4>(buf + (cy * rw + cx) * ldr + v * 2,
                              q >= 0 ? xn + q + v * 2 : xn, q >= 0);
      });
    } else {
      for_each_cell(lay.cells, rw, round_up(C, 2), [&](int cy, int cx, int c) {
        const int64_t q = pixel(cy, cx);
        buf[(cy * rw + cx) * ldr + c] =
            q >= 0 && c < C ? xn[q + c] : __float2bfloat16(0.f);
      });
    }
    mb::cp_async_commit();
  };

  // the taps and biases by 4-byte cp.async, then a zero (the bias the
  // product reads beside an odd Cout's last column), in one group with the
  // first region; the weights transposed while they arrive
  for (int i = threadIdx.x; i < lay.par; i += blockDim.x) {
    if (i < (kTaps + 1) * C + Cout)
      mb::cp_async_zfill<4>(par + i,
                            i < kTaps * C         ? dw_w + i
                            : i < (kTaps + 1) * C ? dw_b + i - kTaps * C
                                                  : pw_b + i - (kTaps + 1) * C,
                            true);
    else
      par[i] = 0.f;
  }
  int t = blockIdx.x;
  if (t < tiles)
    fill(t, regions);
  else
    mb::cp_async_commit();
  transpose_weights(pw_w, C, Cout, lay.kp, lay.np, Wt, lay.ldw);

  for (int it = 0; t < tiles; ++it, t += gridDim.x) {
    const bf16* cur = regions + (it & 1) * lay.region;
    if (t + gridDim.x < tiles)
      fill(t + gridDim.x, regions + ((it + 1) & 1) * lay.region);
    else
      mb::cp_async_commit();  // an empty group keeps the count
    mb::cp_async_wait<1>();   // all but the next tile's region
    __syncthreads();  // ... and the last tile's stores are done with D

    if constexpr (K == 3)
      depthwise(cur, ldr, tw, th, C, par, par + 9 * C, act_mid, D, ldd);
    else
      depthwise5(cur, ldr, tw, th, C, par, par + kTaps * C, act_mid, D, ldd);
    __syncthreads();

    // the product, its epilogue over its own rows of D
    mb::gemm<true, true, NTW>(
        lay.P, C, Cout, D, ldd, Wt, nullptr, true, par + (kTaps + 1) * C,
        nullptr,
        [&](int m, int, int n, float v0, float v1) {
          *reinterpret_cast<bf162*>(D + m * ldd + n) = __floats2bfloat162_rn(
              ynt::activate(v0, act_out), ynt::activate(v1, act_out));
        });
    __syncthreads();

    const int oy0 = t % tiles_img / tiles_x * th;
    const int ox0 = t % tiles_x * tw;
    bf16* on = out + static_cast<int64_t>(t / tiles_img) * H * W * Cout;
    // the tile's outputs: a thread keeps one vector of a pixel (blockDim /
    // per threads share it) and walks pixels, reading kOutBatch of them
    // from D before it stores any
    const int per = Cout / v_out;  // vectors a pixel
    const int groups = max(1, static_cast<int>(blockDim.x) / per);
    for (int j = threadIdx.x; j < groups * per; j += blockDim.x) {
      const int col = j % per * v_out;
      for (int p0 = j / per; p0 < lay.P; p0 += kOutBatch * groups) {
        uint4 v[kOutBatch];
        int64_t dst[kOutBatch];
#pragma unroll
        for (int e = 0; e < kOutBatch; ++e) {
          const int p = p0 + e * groups;
          const int py = p / tw;
          const int oy = oy0 + py;
          const int ox = ox0 + p - py * tw;
          dst[e] = p < lay.P && oy < H && ox < W
                       ? (static_cast<int64_t>(oy) * W + ox) * Cout + col
                       : -1;
          if (dst[e] < 0) continue;
          const bf16* s = D + p * ldd + col;
          if (v_out == 8)
            v[e] = *reinterpret_cast<const uint4*>(s);
          else if (v_out == 2)
            v[e].x = *reinterpret_cast<const uint32_t*>(s);
          else
            v[e].x = __bfloat16_as_ushort(*s);
        }
#pragma unroll
        for (int e = 0; e < kOutBatch; ++e) {
          if (dst[e] < 0) continue;
          if (v_out == 8)
            *reinterpret_cast<uint4*>(on + dst[e]) = v[e];
          else if (v_out == 2)
            *reinterpret_cast<uint32_t*>(on + dst[e]) = v[e].x;
          else
            on[dst[e]] = half_of(v[e].x, 0);
        }
      }
    }
    // D is next written after the barrier that follows the next wait
  }
}

template <int NTW>
__global__ void __launch_bounds__(kThreads, NTW == mb::kNTW ? 2 : 1)
    fused_dw_pw_bf16_kernel(const bf16* __restrict__ x,
                            const float* __restrict__ dw_w,
                            const float* __restrict__ dw_b,
                            const bf16* __restrict__ pw_w,
                            const float* __restrict__ pw_b,
                            bf16* __restrict__ out, int B, int H, int W,
                            int C, int Cout, int act_mid, int act_out, int tw,
                            int th, int v_in, int v_out) {
  dw_pw_body<3, NTW>(x, dw_w, dw_b, pw_w, pw_b, out, B, H, W, C, Cout,
                     act_mid, act_out, tw, th, v_in, v_out);
}

template <int NTW>
__global__ void __launch_bounds__(kThreads, NTW == mb::kNTW ? 2 : 1)
    fused_dw_pw5_bf16_kernel(const bf16* __restrict__ x,
                             const float* __restrict__ dw_w,
                             const float* __restrict__ dw_b,
                             const bf16* __restrict__ pw_w,
                             const float* __restrict__ pw_b,
                             bf16* __restrict__ out, int B, int H, int W,
                             int C, int Cout, int act_mid, int act_out,
                             int tw, int th, int v_in, int v_out) {
  dw_pw_body<5, NTW>(x, dw_w, dw_b, pw_w, pw_b, out, B, H, W, C, Cout,
                     act_mid, act_out, tw, th, v_in, v_out);
}

// The kernel of a launch of depthwise size K and Cout output channels: 4 n8
// tiles a warp up to Cout = 256, else the wide variant's 8.
const void* kernel_for(int Cout, int K = 3) {
  const bool narrow = mb::ntw_for(Cout) == mb::kNTW;
  if (K == 5)
    return narrow ? reinterpret_cast<const void*>(
                        fused_dw_pw5_bf16_kernel<mb::kNTW>)
                  : reinterpret_cast<const void*>(
                        fused_dw_pw5_bf16_kernel<mb::kNTWWide>);
  return narrow
             ? reinterpret_cast<const void*>(fused_dw_pw_bf16_kernel<mb::kNTW>)
             : reinterpret_cast<const void*>(
                   fused_dw_pw_bf16_kernel<mb::kNTWWide>);
}

// Blocks of the kernel that fit on one SM at once at this shared memory, as
// the runtime reports it (registers and shared memory); 0 on an error.
int blocks_per_sm(int Cout, size_t smem, int K = 3) {
  const void* fn = kernel_for(Cout, K);
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmemMax)) != cudaSuccess)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads, smem) !=
      cudaSuccess)
    return 0;
  return n;
}

int64_t tile_count(int tw, int th, int B, int H, int W) {
  return static_cast<int64_t>(B) * ((H + th - 1) / th) * ((W + tw - 1) / tw);
}

// The cost model of fused_dw_pw_bf16_tile, in k-steps of one warp's
// m16n8k16 products (per 16 channels where a term scales with channels): a
// tile's own time is its longest warp's k-steps in the product, plus
// kCellSteps per region cell (the fill), kPixelSteps per tile pixel (the
// depthwise and the stores) and kSegmentSteps per row segment of the
// depthwise (its window's set-up). An SM runs its share of the tiles on
// `occ` resident blocks, which overlap: a wave of occ tiles costs one tile's
// time plus kShare of it for each further tile. Each block pays kBlockSteps
// once (the weights' transpose). Fitted to chip_smoke.py
// --sweep-dw-pw-tiles on an H100 (PERF.md).
constexpr double kCellSteps = 0.1;
constexpr double kPixelSteps = 0.05;
constexpr double kSegmentSteps = 0.5;
constexpr double kShare = 0.2;
constexpr double kBlockSteps = 20.0;

// The K = 5 kernel's depthwise costs kPixelSteps5 a tile pixel per 16
// channels where the K = 3 one's costs kPixelSteps, and its row segments
// kSegmentSteps5: its 25 taps and 5 row loads a step; from the operations'
// ratio, not fitted to a sweep.
constexpr double kPixelSteps5 = kPixelSteps * 25.0 / 9.0;
constexpr double kSegmentSteps5 = kSegmentSteps * 25.0 / 9.0;

double tile_cost(int tw, int th, int B, int H, int W, int C, int Cout,
                 int occ, int K = 3) {
  const Layout lay(tw, th, C, Cout, K);
  const int ntw_max = mb::ntw_for(Cout);
  const int wn = mb::warps_n(Cout, ntw_max);
  const int ntw = (lay.np / 8 + wn - 1) / wn;
  const int per_round = mb::kWarps / wn * mb::kWM;  // m16 tiles a round
  const int rounds = ((lay.P + 15) / 16 + per_round - 1) / per_round;
  const int k16 = lay.kp / 16;
  const double pixel = K == 3 ? kPixelSteps * lay.P * (k16 + lay.np / 16 + 1)
                              : lay.P * (kPixelSteps5 * k16 +
                                         kPixelSteps * (lay.np / 16 + 1));
  const double steps = rounds * mb::kWM * ntw * k16 +
                       kCellSteps * lay.cells * k16 + pixel +
                       (K == 3 ? kSegmentSteps : kSegmentSteps5) * th *
                           row_segments(tw) * (((C + 1) / 2 + 31) / 32);
  const int64_t per_sm = (tile_count(tw, th, B, H, W) + kSMs - 1) / kSMs;
  const int64_t blocks = per_sm < occ ? per_sm : occ;  // resident on an SM
  const int64_t waves = (per_sm + occ - 1) / occ;
  const int64_t last = per_sm - (waves - 1) * occ;  // tiles of the last wave
  return steps * ((waves - 1) * (1 + kShare * (occ - 1)) +
                  (1 + kShare * (last - 1))) +
         kBlockSteps * blocks;
}

int blocks_per_sm_at(int tw, int th, int C, int Cout, int K) {
  const size_t smem = Layout(tw, th, C, Cout, K).bytes();
  if (smem > kSmemMax || Cout < 1 || Cout > mb::kNMax) return 0;
  return blocks_per_sm(Cout, smem, K);
}

int tile_of(int K, int B, int H, int W, int C, int Cout, int* tw, int* th) {
  double best = 0.0;
  int found = 0;
  int occ_size = -1, occ = 0;  // the occupancy of the last size asked
  for (int w = 1; w <= 32 && w <= W; ++w) {
    for (int h = 1; h <= 32 && h <= H; ++h) {
      const size_t smem = Layout(w, h, C, Cout, K).bytes();
      if (smem > kSmemMax) continue;
      if (static_cast<int>(smem) != occ_size) {
        occ_size = static_cast<int>(smem);
        occ = blocks_per_sm_at(w, h, C, Cout, K);
      }
      if (occ < 1) continue;
      const double cost = tile_cost(w, h, B, H, W, C, Cout, occ, K);
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

int launch(int K, const void* x, const void* dw_w, const void* dw_b,
           const void* pw_w, const void* pw_b, void* out, int B, int H,
           int W, int C, int Cout, int act_mid, int act_out, int tw, int th,
           void* stream) {
  if ((K != 3 && K != 5) || tw < 1 || th < 1 || C < 1 || Cout < 1 ||
      Cout > mb::kNMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Layout(tw, th, C, Cout, K).bytes();
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = tile_count(tw, th, B, H, W);
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int occ = blocks_per_sm(Cout, smem, K);  // sets the smem attribute
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto xa = reinterpret_cast<uintptr_t>(x);
  const auto oa = reinterpret_cast<uintptr_t>(out);
  const int v_in = C % 8 == 0 && xa % 16 == 0 ? 8
                   : C % 2 == 0 && xa % 4 == 0 ? 2
                                               : 1;
  const int v_out = Cout % 8 == 0 && oa % 16 == 0 ? 8
                    : Cout % 2 == 0 && oa % 4 == 0 ? 2
                                                   : 1;
  const int64_t slots = static_cast<int64_t>(occ) * sms;
  const int grid = static_cast<int>(tiles < slots ? tiles : slots);
  const auto* xt = static_cast<const bf16*>(x);
  const auto* dw = static_cast<const float*>(dw_w);
  const auto* db = static_cast<const float*>(dw_b);
  const auto* pw = static_cast<const bf16*>(pw_w);
  const auto* pb = static_cast<const float*>(pw_b);
  auto* ot = static_cast<bf16*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  const bool narrow = mb::ntw_for(Cout) == mb::kNTW;
  if (K == 3 && narrow)
    fused_dw_pw_bf16_kernel<mb::kNTW><<<grid, kThreads, smem, s>>>(
        xt, dw, db, pw, pb, ot, B, H, W, C, Cout, act_mid, act_out, tw, th,
        v_in, v_out);
  else if (K == 3)
    fused_dw_pw_bf16_kernel<mb::kNTWWide><<<grid, kThreads, smem, s>>>(
        xt, dw, db, pw, pb, ot, B, H, W, C, Cout, act_mid, act_out, tw, th,
        v_in, v_out);
  else if (narrow)
    fused_dw_pw5_bf16_kernel<mb::kNTW><<<grid, kThreads, smem, s>>>(
        xt, dw, db, pw, pb, ot, B, H, W, C, Cout, act_mid, act_out, tw, th,
        v_in, v_out);
  else
    fused_dw_pw5_bf16_kernel<mb::kNTWWide><<<grid, kThreads, smem, s>>>(
        xt, dw, db, pw, pb, ot, B, H, W, C, Cout, act_mid, act_out, tw, th,
        v_in, v_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The exports take the depthwise size K, 3 or 5; each K is a kernel of its
// own (fused_dw_pw_bf16_kernel, fused_dw_pw5_bf16_kernel) with its own tile
// rule (tile_cost at K over the same tiles).

// Shared memory of one thread block, in bytes; 0 for another K.
extern "C" size_t fused_dw_pw_bf16_smem_bytes(int tw, int th, int C, int Cout,
                                              int K) {
  if (K != 3 && K != 5) return 0;
  return Layout(tw, th, C, Cout, K).bytes();
}

// Blocks an SM holds at once with this tile (the runtime's occupancy); 0 if
// none fits, for another K or on an error.
extern "C" int fused_dw_pw_bf16_blocks_per_sm(int tw, int th, int C, int Cout,
                                              int K) {
  if (K != 3 && K != 5) return 0;
  return blocks_per_sm_at(tw, th, C, Cout, K);
}

// Output tile (tw columns x th rows) of one launch: of the tiles up to
// 32 x 32, no larger than the image, whose shared memory fits, the one of
// least tile_cost (the first found on a tie, in order of tw, then th).
// Returns 0 and leaves tw, th alone if none fits or for another K.
extern "C" int fused_dw_pw_bf16_tile(int B, int H, int W, int C, int Cout,
                                     int K, int* tw, int* th) {
  if (K != 3 && K != 5) return 0;
  return tile_of(K, B, H, W, C, Cout, tw, th);
}

// x [B,H,W,C] -> out [B,H,W,Cout], NHWC, bf16; dw_w [K,K,C], dw_b [C],
// pw_b [Cout] f32; pw_w [C,Cout] bf16. A persistent grid of (blocks an SM)
// x 132 blocks walks the tw x th output tiles.
extern "C" int fused_dw_pw_bf16(const void* x, const void* dw_w,
                                const void* dw_b, const void* pw_w,
                                const void* pw_b, void* out, int B, int H,
                                int W, int C, int Cout, int K, int act_mid,
                                int act_out, int tw, int th, void* stream) {
  return launch(K, x, dw_w, dw_b, pw_w, pw_b, out, B, H, W, C, Cout, act_mid,
                act_out, tw, th, stream);
}
