// One ShuffleNetV2 block per launch in bf16, for Hopper (sm_90a); a stage
// is one stride-2 launch followed by n stride-1 launches.
//
// Replaces the bf16 variant of the TPU kernel
// yolo_nano_tpu/ops/pallas/fused_stage.py::fused_stage (body `_stage_kernel`;
// `_mm` and `_dw3x3` set where it rounds), on folded weights:
//   stride-2 block: branch1 = relu(pw(dw3x3/s2(x) + b) + b),
//                   branch2 = relu(pw2(dw3x3/s2(relu(pw1(x) + b)) + b) + b),
//                   out[2j] = branch1[j], out[2j+1] = branch2[j];
//   stride-1 block: x1, x2 = x[:C/2], x[C/2:],
//                   out[2j] = x1[j],
//                   out[2j+1] = relu(pw2(dw3x3(relu(pw1(x2)+b))+b)+b)[j].
// Every op rounds its output to bf16 (to nearest even) where the TPU kernel
// rounds: a pointwise multiplies bf16 operands with f32 sums, adds the f32
// bias, applies ReLU and rounds; a depthwise sums its f32 taps on the bf16
// inputs in f32, adds the bias and rounds. The f32 kernel is
// fused_stage.cu.
//
// What bounds it on this card: bytes. At 0.5x width, batch 32, 416 px, the
// three stages' 4.8 GFLOP take 0.005 ms at 989 TFLOP/s, and their inputs,
// outputs and weights (43.6 MB) 0.0132 ms at 3.35 TB/s. A design of one
// launch per block moves every block's input and output through device
// memory (mostly L2), about 164 MB: 0.049 ms.
//
// What the design does about it:
//   - every activation a block keeps is a bf16 value by the function's
//     definition, so shared memory holds bf16 (the region, pw1's output
//     written over it in place, the depthwise output, the left half): half
//     the bytes of f32, half the bank traffic of the depthwise and the
//     fragment loads;
//   - the pointwise products are native bf16 mma.sync m16n8k16 with f32
//     sums (mma_bf16.cuh), A fragments by ldmatrix, no conversion in the
//     k-loop; prepare_stage hands the weights over in bf16, transposed and
//     zero-padded (K to 16, N to 8). Where a block's pointwise weights take
//     at most kResidentBytes (all of 0.5x; at 1.0x the blocks at c2 = 58
//     and the stride-1 blocks at c2 = 116) they are copied into shared
//     memory once, by cp.async overlapped with the region, and the products
//     run with no barrier; the others stream them in chunks of 32 columns.
//     The biases and depthwise taps come into shared memory with them;
//   - the region arrives by 16-byte cp.async with zero fill outside the
//     image (the depthwise's zero pad), and the stride-1 block fetches x1
//     with it into a buffer of its own. Where x or a channel count is not
//     16-byte aligned (at 1.0x, c2 = 58 puts x2 at a 116-byte offset) the
//     copies take 4 bytes, or single loads below 4-byte alignment;
//   - the depthwise reads 4 channels (8 bytes) a load where C allows it;
//   - blocks are 8 warps with __launch_bounds__ for 2 blocks an SM, so that
//     one block's fill, depthwise and stores overlap another's products;
//     the tile rule (shuffle_block_bf16_tile) weighs the tile's work against
//     the waves its blocks take at the occupancy the runtime reports;
//   - above c2 = 256 (stage 4 at 1.5x and 2.0x: c2 = 352, 488) a warp owns
//     up to 8 n8 tiles of every product instead of 4 (mma_bf16.cuh's NTW),
//     so that each round of rows still ends with all of N in registers
//     before its epilogue, and pw1 can still write over its own A rows.
//     That doubles the accumulators (64 floats a thread), so this variant
//     is built for 1 block an SM, and its weights always stream. It takes
//     an even c2 up to 512; its speed is not tuned.
// The activation ACT is a compile-time parameter: ReLU (YOLO-Nano) or
// LeakyReLU (NanoDet-Plus), v >= 0 ? v : 0.10009765625f * v on the f32 sum
// with its bias (the slope is 0.1 rounded to bf16, as the port's bf16
// LeakyReLU takes it), then rounded to bf16 once (act_pair); the launch
// takes it as an int (ynt::Act), and each ACT is a set of kernels of its
// own. The tile rule weighs the ReLU kernels' occupancy for both.
// What holds it back (PERF.md, tools/probe_dw_pw.py's phase probes): a
// block is a chain of barrier-separated phases (copies, region wait, pw1,
// depthwise, pw2) of a few thousand cycles each, and at 0.5x stages 3 and 4
// launch 128 blocks, one an SM, so nothing overlaps that chain.
//
// One thread block per (image, T x T output tile); the tile needs an R x R
// input region, R = (T-1)*stride + 3. Shared memory, after the offsets (R*R
// region cells' input offsets, then T*T tile pixels' output offsets) and
// the f32 biases and taps (Params):
//   X: rows16(R*R) x act_stride(max(K1, c2)): the input region (K1 = Cin at
//      stride 2, else c2; zero pad columns to 16), then pw1's output over
//      it (0 outside the image);
//   L: T*T x act_stride(c2): the block's left half at the tile's pixels,
//      x1 or branch1's output;
//   D: rows16(T*T) x act_stride(c2) (stride 2: of max(Cin, c2)): a
//      depthwise output, the A operand of the product after it;
//   the resident weights, or two streamed chunks.
// Steps:
//   stride 1: region of x2 -> X and x1 -> L; pw1 X -> X; depthwise X -> D;
//     pw2 D, whose epilogue stores each output pair (x1[n], pw2[n],
//     x1[n+1], pw2[n+1]) in one 8-byte store;
//   stride 2: region of x -> X; branch1's depthwise/s2 X -> D and pw D ->
//     L; pw1 X -> X; depthwise/s2 X -> D; pw2 D with L as above.

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace {

namespace mb = ynt::mma_bf16;
using mb::act_stride;
using mb::round_up;
using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kThreads = mb::kWarps * 32;
// pointwise weights (bf16 bytes in shared memory) a block keeps resident
constexpr int kResidentBytes = 64 * 1024;
constexpr size_t kSmemMax = 227 * 1024;

struct BlockWeights {
  const bf16* pw1_w;    // Wt [round8(c2)][round16(K1)], K1: Cin or c2
  const float* pw1_b;   // [c2]
  const float* dw_w;    // [9][c2]
  const float* dw_b;    // [c2]
  const bf16* pw2_w;    // Wt [round8(c2)][round16(c2)]
  const float* pw2_b;   // [c2]
  const float* b1dw_w;  // [9][Cin]   (stride 2 only)
  const float* b1dw_b;  // [Cin]
  const bf16* b1pw_w;   // Wt [round8(c2)][round16(Cin)]
  const float* b1pw_b;  // [c2]
};

// Offsets (floats) of the f32 biases and taps in shared memory, each
// rounded to 4 floats.
struct Params {
  int pw1_b, pw2_b, dw_w, dw_b, b1pw_b, b1dw_w, b1dw_b, floats;
  __host__ __device__ Params(int stride, int cin, int c2) {
    const int c = round_up(c2, 4);
    pw1_b = 0;
    pw2_b = c;
    dw_w = 2 * c;
    dw_b = dw_w + 9 * c;
    b1pw_b = dw_b + c;
    b1dw_w = b1pw_b + (stride == 2 ? c : 0);
    b1dw_b = b1dw_w + (stride == 2 ? 9 * round_up(cin, 4) : 0);
    floats = b1dw_b + (stride == 2 ? round_up(cin, 4) : 0);
  }
};

struct Layout {
  int R, P, k1, ldx, ldl, ldd;
  int offs;          // ints, then the Params' floats
  int x, l, d, w;    // bf16 elements
  bool resident;
  __host__ __device__ Layout(int tile, int stride, int cin, int c2) {
    R = (tile - 1) * stride + 3;
    P = tile * tile;
    k1 = stride == 2 ? cin : c2;
    ldx = act_stride(k1 > c2 ? k1 : c2);
    ldl = act_stride(c2);
    ldd = act_stride(stride == 2 && cin > c2 ? cin : c2);
    // a multiple of 4 keeps the bf16 buffers 16-byte aligned
    offs = round_up(R * R + P, 4) + Params(stride, cin, c2).floats;
    x = round_up(R * R, 16) * ldx;
    l = P * ldl;
    d = round_up(P, 16) * ldd;
    const int w_res = mb::resident_elems(k1, c2) + mb::resident_elems(c2, c2) +
                      (stride == 2 ? mb::resident_elems(cin, c2) : 0);
    // the wide variant (c2 > 256) never fits: its weights always stream
    resident = mb::ntw_for(c2) == mb::kNTW && 2 * w_res <= kResidentBytes;
    w = resident ? w_res : mb::stream_elems(c2);
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(int) * static_cast<size_t>(offs) +
           sizeof(bf16) * (static_cast<size_t>(x) + l + d + w);
  }
};

// rows rows of k bf16 channels into dst [rows][ld], row r from src +
// offs[r] (nothing where offs[r] < 0), zeros there and in the columns k to
// kpad (a multiple of V). V = 8: 16-byte cp.async; 2: 4-byte cp.async; 1:
// single loads. src + offs[r] is aligned to V elements. A thread keeps one
// column and steps over rows (no division in the loop).
template <int V>
__device__ __forceinline__ void fill_rows(bf16* dst, int ld, const bf16* src,
                                          const int* offs, int rows, int k,
                                          int kpad) {
  const int vecs = kpad / V;
  const int per = blockDim.x / vecs;  // rows of one pass
  if (static_cast<int>(threadIdx.x) >= per * vecs) return;
  const int c = threadIdx.x % vecs * V;
  for (int r = threadIdx.x / vecs; r < rows; r += per) {
    const int o = offs[r];
    const bool in = o >= 0 && c < k;
    const bf16* s = in ? src + o + c : src;
    if constexpr (V == 8)
      mb::cp_async_zfill<16>(dst + r * ld + c, s, in);
    else if constexpr (V == 2)
      mb::cp_async_zfill<4>(dst + r * ld + c, s, in);
    else
      dst[r * ld + c] = in ? *s : __float2bfloat16(0.f);
  }
}

__device__ __forceinline__ void fill(int v, bf16* dst, int ld, const bf16* src,
                                     const int* offs, int rows, int k,
                                     int kpad) {
  if (v == 8)
    fill_rows<8>(dst, ld, src, offs, rows, k, kpad);
  else if (v == 2)
    fill_rows<2>(dst, ld, src, offs, rows, k, kpad);
  else
    fill_rows<1>(dst, ld, src, offs, rows, k, kpad);
}

// Depthwise 3x3 (+ bias, no act, rounded to bf16) at the tile's P outputs:
// src is a region buffer (row stride lds, R x R cells), dst gets rows P x
// round16(C) at row stride ldd, its pad columns 0. A thread keeps the taps
// and biases (w [9][C], b [C] in shared memory) of VC neighbouring channels
// in registers and walks pixels, reading VC channels a load (8 bytes for
// VC = 4, where C is a multiple of 4, so that the products of a pixel are
// four independent chains; 4 bytes for VC = 2); neighbouring threads take
// neighbouring channels.
template <int STRIDE, int VC>
__device__ __forceinline__ void depthwise_vec(const bf16* src, int lds, int R,
                                              int tile, int C,
                                              const float* w, const float* b,
                                              bf16* dst, int ldd) {
  using Vec = typename std::conditional<VC == 4, uint2, uint32_t>::type;
  const int nv = (C + VC - 1) / VC;  // vectors holding a channel
  const int groups = max(1, static_cast<int>(blockDim.x) / nv);
  for (int i = threadIdx.x; i < groups * nv; i += blockDim.x) {
    const int c = i % nv * VC;
    float tap[9][VC], bias[VC];
#pragma unroll
    for (int e = 0; e < VC; ++e) {
      const bool in = c + e < C;
#pragma unroll
      for (int k = 0; k < 9; ++k) tap[k][e] = in ? w[k * C + c + e] : 0.f;
      bias[e] = in ? b[c + e] : 0.f;
    }
    int py = i / nv / tile;  // pixel p = py * tile + px, walked without
    int px = i / nv % tile;  // a division per step
    for (int p = i / nv; p < tile * tile; p += groups) {
      const bf16* s0 = src + (py * STRIDE * R + px * STRIDE) * lds + c;
      float acc[VC];
#pragma unroll
      for (int e = 0; e < VC; ++e) acc[e] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const Vec v = *reinterpret_cast<const Vec*>(s0 + (dy * R + dx) * lds);
          const bf162* h = reinterpret_cast<const bf162*>(&v);
#pragma unroll
          for (int e = 0; e < VC; e += 2) {
            const float2 f = __bfloat1622float2(h[e / 2]);
            acc[e] = fmaf(f.x, tap[dy * 3 + dx][e], acc[e]);
            acc[e + 1] = fmaf(f.y, tap[dy * 3 + dx][e + 1], acc[e + 1]);
          }
        }
      Vec o;
      bf162* oh = reinterpret_cast<bf162*>(&o);
#pragma unroll
      for (int e = 0; e < VC; e += 2)
        oh[e / 2] = __floats2bfloat162_rn(acc[e] + bias[e],
                                          acc[e + 1] + bias[e + 1]);
      *reinterpret_cast<Vec*>(dst + p * ldd + c) = o;
      for (px += groups; px >= tile; px -= tile) ++py;
    }
  }
  // the pad columns nv * VC .. round16(C) - 1
  const int pad = (round_up(C, 16) - nv * VC) / 2;
  for (int i = threadIdx.x; i < tile * tile * pad; i += blockDim.x)
    *reinterpret_cast<uint32_t*>(dst + i / pad * ldd + nv * VC +
                                 i % pad * 2) = 0u;
}

template <int STRIDE>
__device__ __forceinline__ void depthwise(const bf16* src, int lds, int R,
                                          int tile, int C, const float* w,
                                          const float* b, bf16* dst,
                                          int ldd) {
  if (C % 4 == 0)
    depthwise_vec<STRIDE, 4>(src, lds, R, tile, C, w, b, dst, ldd);
  else
    depthwise_vec<STRIDE, 2>(src, lds, R, tile, C, w, b, dst, ldd);
}

// relu of a column pair (bias added), rounded to bf16, as one 32-bit word.
__device__ __forceinline__ uint32_t relu_pair(float v0, float v1) {
  const bf162 r = __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The bf16 rounding of LeakyReLU's slope 0.1.
constexpr float kLeakySlope = 0.10009765625f;

// The activation ACT of a column pair (bias added), rounded to bf16, as one
// 32-bit word.
template <int ACT>
__device__ __forceinline__ uint32_t act_pair(float v0, float v1) {
  if constexpr (ACT == ynt::ACT_LEAKY) {
    const bf162 r = __floats2bfloat162_rn(v0 >= 0.f ? v0 : kLeakySlope * v0,
                                          v1 >= 0.f ? v1 : kLeakySlope * v1);
    return *reinterpret_cast<const uint32_t*>(&r);
  } else {
    return relu_pair(v0, v1);
  }
}

// n f32 values from device memory into shared memory, 4 bytes a copy; the
// caller commits.
__device__ __forceinline__ void copy_floats(float* dst, const float* src,
                                            int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    mb::cp_async_zfill<4>(dst + i, src + i, true);
}

template <int STRIDE, bool RESIDENT, int NTW, int ACT>
__global__ void __launch_bounds__(kThreads, NTW == mb::kNTW ? 2 : 1)
    shuffle_block_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                         BlockWeights wts, int H, int W, int Cin, int Ho,
                         int Wo, int c2, int tile, int tiles_x, int v_region,
                         int v_left) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(tile, STRIDE, Cin, c2);
  const int R = lay.R;
  const int P = lay.P;
  const int k1 = lay.k1;
  const int ldx = lay.ldx;
  int* offs = reinterpret_cast<int*>(smem);
  int* opix = offs + R * R;
  const Params pr(STRIDE, Cin, c2);
  float* par = reinterpret_cast<float*>(offs + round_up(R * R + P, 4));
  bf16* X = reinterpret_cast<bf16*>(offs + lay.offs);
  bf16* L = X + lay.x;  // the left half: x1, or branch1's output
  bf16* D = L + lay.l;
  bf16* wsm = D + lay.d;  // resident weights, or the streamed chunks
  bf16* W1 = wsm;
  bf16* W2 = W1 + mb::resident_elems(k1, c2);
  bf16* Wb = W2 + mb::resident_elems(c2, c2);
  const int Cout = 2 * c2;
  const int np = round_up(c2, 8);

  // 0. biases and taps (and resident weights) into shared memory, in flight
  //    with the region
  copy_floats(par + pr.pw1_b, wts.pw1_b, c2);
  copy_floats(par + pr.pw2_b, wts.pw2_b, c2);
  copy_floats(par + pr.dw_w, wts.dw_w, 9 * c2);
  copy_floats(par + pr.dw_b, wts.dw_b, c2);
  if (STRIDE == 2) {
    copy_floats(par + pr.b1pw_b, wts.b1pw_b, c2);
    copy_floats(par + pr.b1dw_w, wts.b1dw_w, 9 * Cin);
    copy_floats(par + pr.b1dw_b, wts.b1dw_b, Cin);
  }
  if (RESIDENT) {
    mb::load_rows(W1, mb::w_stride(round_up(k1, 16)), wts.pw1_w, np,
                  round_up(k1, 16), 0, round_up(k1, 16));
    mb::load_rows(W2, mb::w_stride(round_up(c2, 16)), wts.pw2_w, np,
                  round_up(c2, 16), 0, round_up(c2, 16));
    if (STRIDE == 2)
      mb::load_rows(Wb, mb::w_stride(round_up(Cin, 16)), wts.b1pw_w, np,
                    round_up(Cin, 16), 0, round_up(Cin, 16));
  }
  mb::cp_async_commit();

  const int n = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_x) * tile;
  const int ox0 = (blockIdx.x % tiles_x) * tile;
  const bf16* xn = x + static_cast<int64_t>(n) * H * W * Cin;
  bf16* on = out + static_cast<int64_t>(n) * Ho * Wo * Cout;
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

  // 1. the region into X, 0 outside the image and in the pad columns; the
  //    stride-1 block reads x2 = x[c2:], and x1 at the tile's pixels into
  //    L (its input pixel offset is its output offset)
  fill(v_region, X, ldx, xn + (STRIDE == 2 ? 0 : c2), offs, R * R, k1,
       round_up(k1, 16));
  if (STRIDE == 1)
    fill(v_left, L, lay.ldl, xn, opix, P, c2, round_up(c2, v_left));
  mb::cp_async_commit();
  if (!RESIDENT) mb::prefetch(STRIDE == 2 ? Cin : k1, c2,
                              STRIDE == 2 ? wts.b1pw_w : wts.pw1_w, wsm);
  mb::cp_async_wait<0>();
  __syncthreads();

  const bf16* w_pw1 = RESIDENT ? W1 : wts.pw1_w;
  const bf16* w_pw2 = RESIDENT ? W2 : wts.pw2_w;
  const bf16* w_b1pw = RESIDENT ? Wb : wts.b1pw_w;
  if (STRIDE == 2) {
    // 2. branch1: depthwise 3x3/s2 of the region into D, then its pw +
    //    relu, D -> L
    depthwise<2>(X, ldx, R, tile, Cin, par + pr.b1dw_w, par + pr.b1dw_b, D,
                 lay.ldd);
    __syncthreads();
    mb::gemm<RESIDENT, false, NTW>(
        P, Cin, c2, D, lay.ldd, w_b1pw, wsm, true, par + pr.b1pw_b, opix,
        [&](int m, int, int o, float v0, float v1) {
          *reinterpret_cast<uint32_t*>(L + m * lay.ldl + o) =
              act_pair<ACT>(v0, v1);
        });
  }
  // 3. pw1 + relu over the region, in place; 0 outside the image (the
  //    depthwise's zero pad)
  mb::gemm<RESIDENT, true, NTW>(
      R * R, k1, c2, X, ldx, w_pw1, wsm, STRIDE == 1, par + pr.pw1_b, offs,
      [&](int m, int in, int o, float v0, float v1) {
        *reinterpret_cast<uint32_t*>(X + m * ldx + o) =
            in >= 0 ? act_pair<ACT>(v0, v1) : 0u;
      });
  __syncthreads();
  if (!RESIDENT) mb::prefetch(c2, c2, wts.pw2_w, wsm);
  // 4. depthwise 3x3 (+ bias) at the tile's outputs, X -> D
  depthwise<STRIDE>(X, ldx, R, tile, c2, par + pr.dw_w, par + pr.dw_b, D,
                    lay.ldd);
  mb::cp_async_wait<0>();
  __syncthreads();
  // 5. pw2 + relu; each output pair (L[o], pw2[o], L[o+1], pw2[o+1]) in one
  //    8-byte store
  mb::gemm<RESIDENT, false, NTW>(
      P, c2, c2, D, lay.ldd, w_pw2, wsm, true, par + pr.pw2_b, opix,
      [&](int m, int q, int o, float v0, float v1) {
        if (q < 0) return;
        const uint32_t r = act_pair<ACT>(v0, v1);
        const uint32_t l =
            *reinterpret_cast<const uint32_t*>(L + m * lay.ldl + o);
        *reinterpret_cast<uint2*>(on + q + 2 * o) =
            make_uint2(__byte_perm(l, r, 0x5410), __byte_perm(l, r, 0x7632));
      });
}

template <int STRIDE, bool RESIDENT, int NTW, int ACT>
cudaError_t launch(const bf16* x, bf16* out, const BlockWeights& wts, int B,
                   int H, int W, int Cin, int c2, int tile, size_t smem,
                   int v_region, int v_left, cudaStream_t s) {
  const int Ho = (H - 1) / STRIDE + 1;
  const int Wo = (W - 1) / STRIDE + 1;
  const int tiles_x = (Wo + tile - 1) / tile;
  const int tiles_y = (Ho + tile - 1) / tile;
  const cudaError_t err = cudaFuncSetAttribute(
      shuffle_block_kernel<STRIDE, RESIDENT, NTW, ACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  shuffle_block_kernel<STRIDE, RESIDENT, NTW, ACT>
      <<<dim3(tiles_x * tiles_y, B), kThreads, smem, s>>>(
          x, out, wts, H, W, Cin, Ho, Wo, c2, tile, tiles_x, v_region,
          v_left);
  return cudaGetLastError();
}

// The kernel of a launch: its stride, resident weights or streamed, and
// the n8 tiles a warp owns (mb::ntw_for(c2)). The wide variant is built
// streamed only (Layout::resident).
template <int STRIDE, int NTW>
const void* kernel_of(bool resident) {
  if constexpr (NTW == mb::kNTW)
    if (resident)
      return reinterpret_cast<const void*>(
          shuffle_block_kernel<STRIDE, true, NTW, ynt::ACT_RELU>);
  return reinterpret_cast<const void*>(
      shuffle_block_kernel<STRIDE, false, NTW, ynt::ACT_RELU>);
}

// Blocks of this launch's kernel that fit on one SM at once, as the runtime
// reports it (registers and shared memory); 0 on an error.
int blocks_per_sm(int stride, bool resident, int c2, size_t smem) {
  const bool wide = mb::ntw_for(c2) != mb::kNTW;
  const void* fn =
      stride == 2 ? (wide ? kernel_of<2, mb::kNTWWide>(resident)
                          : kernel_of<2, mb::kNTW>(resident))
                  : (wide ? kernel_of<1, mb::kNTWWide>(resident)
                          : kernel_of<1, mb::kNTW>(resident));
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmemMax)) != cudaSuccess)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads, smem) !=
      cudaSuccess)
    return 0;
  return n;
}

constexpr int kSMs = 132;  // streaming multiprocessors of an H100 SXM
// The cost model of shuffle_block_bf16_tile, in k-steps of one warp's
// m16n8k16 products: a block's own time is its longest warp's k-steps plus
// kCellSteps per region cell and kPixelSteps per tile pixel (fill,
// depthwise, stores; per 16 channels); blocks that share an SM overlap, so a
// wave of `occ` blocks an SM costs that time once plus kShare of it for each
// further block. Fitted to chip_smoke.py --sweep-stage-tiles on an H100
// (PERF.md): at 0.5x it picks the fastest side of every launch; at 1.0x its
// picks sum to within 1% of the fastest sides'.
constexpr double kCellSteps = 0.05;
constexpr double kPixelSteps = 0.15;
constexpr double kShare = 0.5;

// k-steps of one warp in a product of an m x n output and depth k.
int gemm_steps(int m, int k, int n) {
  const int wn = mb::warps_n(n, mb::ntw_for(n));
  const int ntw = (round_up(n, 8) / 8 + wn - 1) / wn;
  const int per_round = mb::kWarps / wn * mb::kWM;
  const int rounds = ((m + 15) / 16 + per_round - 1) / per_round;
  return rounds * mb::kWM * ntw * (round_up(k, 16) / 16);
}

double tile_cost(int tile, int stride, int Cin, int c2, int B, int Ho, int Wo,
                 int occ) {
  const Layout lay(tile, stride, Cin, c2);
  double steps = gemm_steps(lay.R * lay.R, lay.k1, c2) +
                 gemm_steps(lay.P, c2, c2);
  if (stride == 2) steps += gemm_steps(lay.P, Cin, c2);
  steps += kCellSteps * lay.R * lay.R * (round_up(lay.k1, 16) / 16) +
           kPixelSteps * lay.P * (round_up(c2, 16) / 16);
  const int64_t blocks = static_cast<int64_t>(B) * ((Ho + tile - 1) / tile) *
                         ((Wo + tile - 1) / tile);
  const int64_t per_sm = (blocks + kSMs - 1) / kSMs;
  const int64_t waves = (per_sm + occ - 1) / occ;
  const int64_t last = per_sm - (waves - 1) * occ;  // blocks of the last wave
  return steps * ((waves - 1) * (1 + kShare * (occ - 1)) +
                  (1 + kShare * (last - 1)));
}

}  // namespace

// Shared memory of one thread block, in bytes.
extern "C" size_t shuffle_block_bf16_smem_bytes(int tile, int stride, int Cin,
                                                int c2) {
  return Layout(tile, stride, Cin, c2).bytes();
}

// Blocks an SM holds at once at this tile side (the runtime's occupancy);
// 0 if none fits or on an error.
extern "C" int shuffle_block_bf16_blocks_per_sm(int tile, int stride, int Cin,
                                                int c2) {
  const Layout lay(tile, stride, Cin, c2);
  if (lay.bytes() > kSmemMax) return 0;
  return blocks_per_sm(stride, lay.resident, c2, lay.bytes());
}

// Output tile side of one block launch: of the sides up to 16 whose shared
// memory fits, the one of least tile_cost (the larger on a tie); 0 if none
// fits.
extern "C" int shuffle_block_bf16_tile(int stride, int Cin, int c2, int B,
                                       int Ho, int Wo) {
  int best = 0;
  double best_cost = 0.0;
  for (int tile = 1; tile <= 16; ++tile) {
    const int occ = shuffle_block_bf16_blocks_per_sm(tile, stride, Cin, c2);
    if (occ < 1) continue;
    const double cost = tile_cost(tile, stride, Cin, c2, B, Ho, Wo, occ);
    if (best == 0 || cost <= best_cost) {
      best = tile;
      best_cost = cost;
    }
  }
  return best;
}

// x [B,H,W,Cin] -> out [B,Ho,Wo,2*c2] in bf16, Ho = (H-1)/stride + 1, both
// NHWC; one thread block per (image, tile x tile output pixels). The
// pointwise weights are bf16 Wt [round8(c2)][round16(K)] (transposed,
// zero-padded, 16-byte aligned); the depthwise taps and all biases f32; act
// ynt::ACT_RELU or ynt::ACT_LEAKY.
extern "C" int shuffle_block_bf16(
    const void* x, void* out, int B, int H, int W, int Cin, int c2,
    int stride, int tile, int act, const void* pw1_w, const void* pw1_b,
    const void* dw_w, const void* dw_b, const void* pw2_w, const void* pw2_b,
    const void* b1dw_w, const void* b1dw_b, const void* b1pw_w,
    const void* b1pw_b, void* stream) {
  if ((stride != 1 && stride != 2) || tile < 1 || c2 % 2 || c2 > mb::kNMax ||
      (stride == 1 && Cin != 2 * c2) ||
      (act != ynt::ACT_RELU && act != ynt::ACT_LEAKY))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay(tile, stride, Cin, c2);
  const size_t smem = lay.bytes();
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const BlockWeights wts{
      static_cast<const bf16*>(pw1_w),   static_cast<const float*>(pw1_b),
      static_cast<const float*>(dw_w),   static_cast<const float*>(dw_b),
      static_cast<const bf16*>(pw2_w),   static_cast<const float*>(pw2_b),
      static_cast<const float*>(b1dw_w), static_cast<const float*>(b1dw_b),
      static_cast<const bf16*>(b1pw_w),  static_cast<const float*>(b1pw_b)};
  const auto* xt = static_cast<const bf16*>(x);
  auto* ot = static_cast<bf16*>(out);
  // copy widths: 8 channels (16 bytes) where the source, the pixel stride
  // and the channel count allow it, else 2 (4 bytes), else 1
  auto width = [&](const bf16* src, int k) {
    const auto a = reinterpret_cast<uintptr_t>(src);
    if (k % 8 == 0 && Cin % 8 == 0 && a % 16 == 0) return 8;
    if (k % 2 == 0 && Cin % 2 == 0 && a % 4 == 0) return 2;
    return 1;
  };
  const int v_region = width(xt + (stride == 2 ? 0 : c2), lay.k1);
  const int v_left = width(xt, c2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the kernel of this stride, warp width, weights and activation; the wide
  // variant is built streamed only (Layout::resident)
  auto go = [&](auto stride_c, auto ntw, auto act_c) {
    constexpr int S = decltype(stride_c)::value;
    constexpr int NTW = decltype(ntw)::value;
    constexpr int A = decltype(act_c)::value;
    if constexpr (NTW == mb::kNTW)
      if (lay.resident)
        return launch<S, true, NTW, A>(xt, ot, wts, B, H, W, Cin, c2, tile,
                                       smem, v_region, v_left, s);
    return launch<S, false, NTW, A>(xt, ot, wts, B, H, W, Cin, c2, tile,
                                    smem, v_region, v_left, s);
  };
  using S1 = std::integral_constant<int, 1>;
  using S2 = std::integral_constant<int, 2>;
  using Narrow = std::integral_constant<int, mb::kNTW>;
  using Wide = std::integral_constant<int, mb::kNTWWide>;
  auto with_act = [&](auto act_c) {
    const bool wide = mb::ntw_for(c2) != mb::kNTW;
    return stride == 2
               ? (wide ? go(S2(), Wide(), act_c) : go(S2(), Narrow(), act_c))
               : (wide ? go(S1(), Wide(), act_c) : go(S1(), Narrow(), act_c));
  };
  const cudaError_t err =
      act == ynt::ACT_LEAKY
          ? with_act(std::integral_constant<int, ynt::ACT_LEAKY>())
          : with_act(std::integral_constant<int, ynt::ACT_RELU>());
  return static_cast<int>(err);
}
