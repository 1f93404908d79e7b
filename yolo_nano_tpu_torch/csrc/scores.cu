// The detector's scores for Hopper (sm_90a): softmax max, argmax and
// objectness in one read of the class logits.
//
// Replaces no Pallas kernel. The JAX package's scores
// (yolo_nano_tpu/models/yolo_nano.py::scores_from_features) are XLA
// reductions, which the TPU fuses. The port's plain version of them
// (yolo_nano_tpu_torch/ops/kernels/scores.py::scores_plain) is five
// PyTorch passes over [B,N,C] in f32 (the widening copy, max, the
// broadcast subtract and exp, sum, argmax), each a read, and most a write,
// of the whole tensor. This kernel reads each logit once.
//
// For cls [B,N,C] and conf [B,N,1] (f32 or bf16, contiguous), row by row:
//   m     = max_c l_c,  cls = the first c with l_c = m (the first NaN's
//           index where the row holds one, as torch.argmax),
//   s     = sum_c expf(l_c - m),
//   score = expf(m - (m + logf(s))) * (1 / (1 + expf(-obj))),
// in f32 (bf16 widened exactly), each operation rounded on its own in the
// plain version's order, with expf and logf as the plain version's
// PyTorch kernels call them and the sum in the order PyTorch's reduction
// takes (score_row), so that on the card a score and a class are the plain
// version's bit for bit; a row with NaN or inf gives what the plain
// version gives (NaN where it gives NaN).
//
// What bounds it on this card: bytes, nearly. A logit is read once (2 or
// 4 bytes) and takes about 20 f32 instructions (the max, the subtract,
// expf, the sum), so the card's 3.35 TB/s would allow 1.7 (bf16) or 0.8
// (f32) G logits a millisecond against the SMs' issue of about 1.5 G; at
// bf16 the two are near each other. Outputs are 8 bytes a row.
//
// What the design does about it: a persistent grid (the SMs times the
// blocks each holds) walks tiles of whole rows. A tile's rows are one
// contiguous span of the logits, copied into a ring of kStages shared-
// memory buffers with 16-byte cp.async copies, so that the copies of the
// next tiles are in flight while the block computes this one. A group of
// L lanes shares a row (the tile rule, `plan`): two passes over the
// on-chip copy, the max, then the exponentials and the class, each lane
// over the classes j, j + L, ... (neighbouring lanes on neighbouring
// classes: at four lanes a row in bf16, two rows a bank where a thread a
// row reads eight), reduced over the group by shuffles.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>
#include <utility>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kTileBytes = 16 * 1024;  // logits a stage holds, at least
// from this many classes on, PyTorch's sum reads four classes a load (its
// order matched bit for bit on the H100 from 1 to 127 classes one a load,
// from 128 on four, with PyTorch 2.11)
constexpr int kVecC = 128;
constexpr size_t kSmemMax = 227 * 1024;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // the bytes past src_bytes are not read, and filled with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr unsigned kFull = 0xffffffffu;

// Rows [first, first + n) of the logits into a stage buffer: the span's
// 16-byte pieces by cp.async (kAsync: the logits' base is 16-byte aligned,
// and so is every tile's start), else element by element.
template <typename T, bool kAsync>
__device__ __forceinline__ void copy_rows(T* dst, const T* cls,
                                          int64_t first, int n, int C) {
  const T* src = cls + first * C;
  const int count = n * C;
  if (kAsync) {
    const int bytes = count * static_cast<int>(sizeof(T));
    const char* s = reinterpret_cast<const char*>(src);
    char* d = reinterpret_cast<char*>(dst);
    for (int v = threadIdx.x; 16 * v < bytes; v += kThreads)
      cp_async16(d + 16 * v, s + 16 * v, min(16, bytes - 16 * v));
  } else {
    for (int e = threadIdx.x; e < count; e += kThreads) dst[e] = src[e];
  }
}

// The score and class of one row, by a group of L = 32 / NL lanes (this
// one j) over the row's copy in shared memory; in lane 0 of the group.
//
// The sum of exponentials takes PyTorch's order, so that it is the plain
// version's bit for bit, and so is the score: its CUDA reduction of the
// last, contiguous dimension of many rows (ATen's Reduce.cuh) gives a row
// 32 threads, each summing its classes into a leaf, and the leaves meet
// in a tree that halves (leaf t takes leaf t + 16, then t + 8, ..., t + 1:
// shuffles down). Below kVecC classes thread t sums its classes t, t + 32,
// ... in order (at most four). From kVecC on it reads four classes at a
// time (16 bytes of the f32 exponentials, whose rows start `shift` = (row
// C) mod 4 classes past a 16-byte boundary): classes head + 4 (t + 32 k) +
// q into accumulator q (head = (4 - shift) mod 4), after the unaligned
// head (class t - shift into the first, for shift <= t < 4) and before the
// tail (class head + tail + t, the first), then ((a0 + a1) + a2) + a3.
// Here lane j holds the leaves t = j + L i, i < NL, so that the tree's
// halvings down to L are additions in the lane and the rest shuffles down.
template <typename T, int NL, bool kVec>
__device__ __forceinline__ void score_row(const T* row, int C, int j,
                                          int shift, float obj, float* score,
                                          int32_t* out_cls, bool writes) {
  constexpr int L = 32 / NL;
  // the max: fmaxf passes NaN over, a NaN in the row makes it NaN below
  float m = -INFINITY;
  int nan = 0;
  for (int base = j; base < C; base += 32) {
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      if (base + L * i < C) {
        const float v = ynt::to_float(row[base + L * i]);
        m = fmaxf(m, v);
        nan |= isnan(v);
      }
    }
  }
#pragma unroll
  for (int off = L >> 1; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    nan |= __shfl_xor_sync(kFull, nan, off);
  }
  if (nan) m = NAN;  // as torch.max: NaN in, NaN out

  // the exponentials into the leaves; the class is the first index that
  // holds the max, or in a row holding NaN the first NaN (torch.argmax)
  int arg = INT32_MAX;
  auto take = [&](int c, float& acc) {
    const float v = ynt::to_float(row[c]);
    acc = __fadd_rn(acc, expf(__fsub_rn(v, m)));
    if (v == m) arg = min(arg, c);
  };
  float leaf[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) leaf[i] = 0.f;
  if (!kVec) {
    for (int base = j; base < C; base += 32) {
#pragma unroll
      for (int i = 0; i < NL; ++i)
        if (base + L * i < C) take(base + L * i, leaf[i]);
    }
  } else {
    const int head = (4 - shift) & 3;  // classes before the vectors
    const int end = C - head, tail = end - end % 4;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int t = j + L * i;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      if (shift && t >= shift && t < 4) take(t - shift, a[0]);
      for (int v = t; 4 * v + 3 < end; v += 32) {
#pragma unroll
        for (int q = 0; q < 4; ++q) take(head + 4 * v + q, a[q]);
      }
      if (tail + t < end) take(head + tail + t, a[0]);
      leaf[i] = __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]);
    }
  }
  if (nan) {  // rare: the first NaN
    for (int c = j; c < C; c += L)
      if (isnan(ynt::to_float(row[c]))) {
        arg = c;
        break;
      }
  }
#pragma unroll
  for (int h = NL >> 1; h > 0; h >>= 1) {
#pragma unroll
    for (int i = 0; i < h; ++i) leaf[i] = __fadd_rn(leaf[i], leaf[i + h]);
  }
  float s = leaf[0];
#pragma unroll
  for (int off = L >> 1; off > 0; off >>= 1) {
    s = __fadd_rn(s, __shfl_down_sync(kFull, s, off));
    arg = min(arg, __shfl_xor_sync(kFull, arg, off));
  }
  if (writes) {
    const float lse = __fadd_rn(m, logf(s));
    const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-obj)));
    *score = __fmul_rn(expf(__fsub_rn(m, lse)), sig);
    *out_cls = arg;
  }
}

template <typename T, bool kAsync, int NL>
__global__ void __launch_bounds__(kThreads)
    scores_kernel(const T* __restrict__ cls, const T* __restrict__ conf,
                  float* __restrict__ score, int32_t* __restrict__ out_cls,
                  int64_t rows, int C, int tile_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int L = 32 / NL;
  constexpr int groups = kThreads / L;
  const int group = threadIdx.x / L;
  const int j = threadIdx.x % L;
  const int64_t tiles = (rows + tile_rows - 1) / tile_rows;
  const size_t stage_bytes =
      (static_cast<size_t>(tile_rows) * C * sizeof(T) + 15) & ~size_t(15);
  auto stage = [&](int s) {
    return reinterpret_cast<T*>(smem + s * stage_bytes);
  };
  auto issue = [&](int64_t t, int s) {
    if (t < tiles) {
      const int64_t first = t * tile_rows;
      copy_rows<T, kAsync>(stage(s), cls, first,
                           rows - first < tile_rows
                               ? static_cast<int>(rows - first)
                               : tile_rows,
                           C);
    }
    if (kAsync) cp_async_commit();  // an empty group past the last tile
  };

  int64_t t = blockIdx.x;
  for (int s = 0; s < kStages - 1; ++s) issue(t + s * gridDim.x, s);
  for (int i = 0; t < tiles; t += gridDim.x, ++i) {
    issue(t + (kStages - 1) * static_cast<int64_t>(gridDim.x),
          (i + kStages - 1) % kStages);
    if (kAsync) cp_async_wait<kStages - 1>();  // this tile's copies landed
    __syncthreads();
    const T* tile = stage(i % kStages);
    const int64_t first = t * tile_rows;
    const int n = rows - first < tile_rows ? static_cast<int>(rows - first)
                                           : tile_rows;
    // every lane runs every round (the shuffles take the whole warp); a
    // group past the tile's rows works on its last row and writes nothing
    for (int base = 0; base < n; base += groups) {
      const int r = min(base + group, n - 1);
      const bool writes = base + group < n && j == 0;
      const float obj =
          writes ? ynt::to_float(conf[first + r]) : 0.f;  // in flight early
      const T* row = tile + static_cast<size_t>(r) * C;
      if (C >= kVecC)
        score_row<T, NL, true>(row, C, j,
                               static_cast<int>((first + r) * C % 4), obj,
                               score + first + r, out_cls + first + r,
                               writes);
      else
        score_row<T, NL, false>(row, C, j, 0, obj, score + first + r,
                                out_cls + first + r, writes);
    }
    __syncthreads();  // the buffer is copied into again kStages - 1 on
  }
  if (kAsync) cp_async_wait<0>();
}

struct Plan {
  int leaves, rows, smem;  // leaves a lane (NL), rows a tile, ring bytes
};

// The tile rule. Lanes a row: four (NL = 8), or the fewest above whose
// smallest tile (a row a group) fits the ring. Rows a tile: a multiple of
// the groups, about kTileBytes of logits, fewer where the rows would not
// give each SM four tiles. On the H100 at C = 80 (PERF.md §6) four lanes
// a row were the fastest in both dtypes: two 6% slower in bf16, eight 15%
// to 17%, sixteen and 32 1.5x to 2.1x (a shuffle tree and a score for
// fewer classes a lane), one 2.1x in bf16 (a thread a row reads eight
// rows a bank); a larger tile, fewer blocks an SM, was slower.
Plan plan(int C, int esize, int64_t rows, int sms) {
  const size_t row_bytes = static_cast<size_t>(C) * esize;
  int L = 4;
  while (L < 32 && kStages * (kThreads / L) * row_bytes > kSmemMax) L *= 2;
  const int groups = kThreads / L;
  const int64_t by_bytes =
      std::max<int64_t>(1, kTileBytes / (groups * row_bytes));
  const int64_t by_rows =
      (rows + 4LL * sms * groups - 1) / (4LL * sms * groups);
  int64_t mult = std::max<int64_t>(1, std::min(by_bytes, by_rows));
  while (mult > 1 && kStages * mult * groups * row_bytes > kSmemMax) --mult;
  Plan p{32 / L, static_cast<int>(mult * groups), 0};
  p.smem = static_cast<int>(kStages * ((p.rows * row_bytes + 15) &
                                       ~size_t(15)));
  return p;
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

struct Launch {
  Plan plan;
  int grid;
};

// The grid for a plan: the SMs times the blocks an SM holds, at most the
// tiles; the kernel allowed the shared memory first.
template <typename T, bool kAsync, int NL>
cudaError_t grid_for(const Plan& p, int sms, int64_t rows, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      scores_kernel<T, kAsync, NL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemMax));
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scores_kernel<T, kAsync, NL>, kThreads, p.smem);
  const int64_t tiles = (rows + p.rows - 1) / p.rows;
  *grid = static_cast<int>(std::min<int64_t>(std::max(sms * per_sm, 1),
                                             tiles));
  return err;
}

template <typename T, bool kAsync, int NL>
cudaError_t run(const Launch& l, const T* cls, const T* conf, float* score,
                int32_t* out_cls, int64_t rows, int C, cudaStream_t stream) {
  scores_kernel<T, kAsync, NL><<<l.grid, kThreads, l.plan.smem, stream>>>(
      cls, conf, score, out_cls, rows, C, l.plan.rows);
  return cudaGetLastError();
}

// Calls f<NL>() for the plan's leaves a lane (8 down to 1).
template <typename F>
cudaError_t by_leaves(int leaves, F f) {
  switch (leaves) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 4: return f(std::integral_constant<int, 4>());
    case 8: return f(std::integral_constant<int, 8>());
  }
  return cudaErrorInvalidValue;
}

template <typename T, bool kAsync>
int launch(const T* cls, const T* conf, float* score, int32_t* out_cls,
           int64_t rows, int C, cudaStream_t stream) {
  // the tile rule's pick and the grid, per device and shape
  static std::mutex mu;
  static std::map<std::tuple<int, int, int64_t>, Launch> launches;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  Launch l;
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = launches.find({dev, C, rows});
    if (it == launches.end()) {
      int sms = 0;
      err = static_cast<cudaError_t>(sm_count(&sms));
      if (err != cudaSuccess) return err;
      l.plan = plan(C, sizeof(T), rows, sms);
      err = by_leaves(l.plan.leaves, [&](auto nl) {
        return grid_for<T, kAsync, decltype(nl)::value>(l.plan, sms, rows,
                                                        &l.grid);
      });
      if (err != cudaSuccess) return err;
      it = launches.emplace(std::make_tuple(dev, C, rows), l).first;
    }
    l = it->second;
  }
  return by_leaves(l.plan.leaves, [&](auto nl) {
    return run<T, kAsync, decltype(nl)::value>(l, cls, conf, score, out_cls,
                                               rows, C, stream);
  });
}

}  // namespace

// The largest C the kernel takes at an element size (2 or 4 bytes): the
// ring's smallest tiles, 8 rows at 32 lanes a row, in shared memory.
extern "C" int scores_max_c(int esize) {
  return static_cast<int>(kSmemMax / (kStages * (kThreads / 32) * esize));
}

// The tile rule's pick for `rows` rows of C classes at an element size on
// the current device: out[0] lanes a row, out[1] rows a tile, out[2] the
// ring's shared-memory bytes. Returns a CUDA error (0 when it was read).
extern "C" int scores_plan(int C, int esize, long long rows, int* out) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  const Plan p = plan(C, esize, rows, sms);
  out[0] = 32 / p.leaves;
  out[1] = p.rows;
  out[2] = p.smem;
  return 0;
}

// conf [rows] and cls [rows, C] (f32, or bf16 when bf16; contiguous),
// score [rows] f32 and cls_out [rows] int32; one launch on `stream`, no
// allocation, no host read. Returns the CUDA error of the launch (0 when
// it was taken); C outside 1..scores_max_c is refused as an invalid value.
extern "C" int scores(const void* conf, const void* cls, void* score,
                      void* cls_out, long long rows, int C, int bf16,
                      void* stream) {
  const int esize = bf16 ? 2 : 4;
  if (C < 1 || C > scores_max_c(esize) || rows < 0)
    return cudaErrorInvalidValue;
  if (rows == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<float*>(score);
  auto oc = static_cast<int32_t*>(cls_out);
  const bool aligned = reinterpret_cast<uintptr_t>(cls) % 16 == 0;
  if (bf16) {
    auto c = static_cast<const __nv_bfloat16*>(cls);
    auto o = static_cast<const __nv_bfloat16*>(conf);
    return aligned ? launch<__nv_bfloat16, true>(c, o, sc, oc, rows, C, s)
                   : launch<__nv_bfloat16, false>(c, o, sc, oc, rows, C, s);
  }
  auto c = static_cast<const float*>(cls);
  auto o = static_cast<const float*>(conf);
  return aligned ? launch<float, true>(c, o, sc, oc, rows, C, s)
                 : launch<float, false>(c, o, sc, oc, rows, C, s);
}
