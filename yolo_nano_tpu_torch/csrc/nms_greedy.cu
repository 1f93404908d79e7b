// Greedy non-maximum suppression for Hopper (sm_90a): one block an image.
//
// Replaces no Pallas kernel. The JAX package's NMS
// (yolo_nano_tpu/ops/nms.py::nms_greedy) is a lax.while_loop of sweeps
// over the K x K overlap matrix, which XLA runs on the TPU with no host
// round trip. The port's plain version of it (yolo_nano_tpu_torch/ops/
// nms.py::nms_greedy_plain) runs the sweeps from Python and reads the
// loop's condition on the host after each one: a drain of the card per
// sweep, 5 to 17 a batch. This kernel computes the same keep set in one
// launch, so that the whole postprocess is enqueued with no host read.
//
// For boxes [B,K,4] (corners, f32) sorted by descending score and valid
// [B,K] (bool), keep [B,K] (bool) is the sequential greedy
//   keep_i = valid_i && !(exists j < i : keep_j && ovr(j,i) > thresh),
// the set the plain version's fixpoint converges to. ovr is the IoU, minus
// the DIoU penalty when diou, computed in f32 in the order of the plain
// version's _pairwise_iou and _pairwise_diou_penalty: every operation
// rounded on its own (the __f*_rn intrinsics, so no FMA contraction), max,
// min and clamp propagating NaN as torch.maximum, torch.minimum and
// torch.clamp do, and thresh the f32 value torch compares against. The keep
// set is then the plain version's bit for bit.
//
// What bounds it on this card: almost nothing moves (17 bytes in and 1 out
// a candidate: 1.1 MB at batch 128, K = 512, 0.3 us at 3.35 TB/s). The
// work is K^2 / 2 overlap tests of about 40 f32 instructions an image (5.2
// M at K = 512, about 20 us of one SM's issue, an image to an SM) and then
// the greedy decisions, one chain of K steps each depending on the ones
// before it (a shared-memory read a kept candidate, about 2.4 us for the
// 144 an image keeps at most in eval-strict). So it is bound by one SM's
// issue and latency, not by the card's bytes or FLOPs.
//
// What the design does about it: one block an image, so the images of a
// batch run side by side (batch 128 to 256 is one wave on 132 SMs). Up to
// K = 1024 (kMaskK), every pair's decision is taken first, in parallel,
// into a bitmask in shared memory: row i's word w holds the candidates
// 32w..32w+31 above i that a kept i suppresses (only the words at and
// above the diagonal are computed). Then one warp walks the chain: lane l
// holds word l of the removed bits, each word's survivors are found with
// ffs, and a kept candidate costs a shared-memory read and an OR; no
// barrier inside the chain. The mask's tests take most of the time
// (PERF.md §6): a word's 32 are unrolled, finite boxes skip the NaN checks
// (a pair with a NaN or inf coordinate is tested again with them), and a
// pair that does not meet skips the division. Above kMaskK the mask (4 K^2
// / 32 bytes) no longer fits, and the block walks the chain itself: for
// each kept candidate all threads test the candidates above it and set
// their removed bits with shared-memory atomics, then meet at a barrier
// (K / 8 bytes of shared memory, so K up to 1,859,584; the wrapper refuses
// more). Its work is the kept candidates' rows alone, where the mask's is
// every valid pair: on TTA's merge (batch 8, K = 2,816) the mask kept in
// global memory took 1.8x to 3.3x the chain's time (PERF.md §6).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaskK = 1024;          // largest K of the bitmask design
constexpr int kMaskThreads = 768;     // its block: two fit on an SM
constexpr int kChainThreads = 1024;   // the other design's block
constexpr size_t kSmemMax = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

struct __align__(16) Box {
  float x1, y1, x2, y2;
};

// torch.maximum / torch.minimum: NaN if either operand is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
// torch.clamp(x, min=0)
__device__ __forceinline__ float clamp0(float x) {
  return isnan(x) ? x : fmaxf(x, 0.f);
}

// The same on finite boxes, where no operand of theirs can be NaN (a
// difference of finite coordinates is finite or inf): fmaxf and fminf.
template <bool kFinite>
__device__ __forceinline__ float vmax(float a, float b) {
  return kFinite ? fmaxf(a, b) : max_nan(a, b);
}
template <bool kFinite>
__device__ __forceinline__ float vmin(float a, float b) {
  return kFinite ? fminf(a, b) : min_nan(a, b);
}
template <bool kFinite>
__device__ __forceinline__ float vclamp0(float x) {
  return kFinite ? fmaxf(x, 0.f) : clamp0(x);
}

__device__ __forceinline__ float area(const Box& b) {
  return __fmul_rn(__fsub_rn(b.x2, b.x1), __fsub_rn(b.y2, b.y1));
}

// ovr(j, i) > thresh, j the higher-scored box, as the plain version
// computes it: inter / (((area_j + area_i) - inter) + 1e-20), minus
// d^2 / (c^2 + 1e-20) when kDiou. kFinite: both boxes' coordinates are
// finite, so max, min and clamp need not propagate NaN.
template <bool kDiou, bool kFinite>
__device__ __forceinline__ bool suppresses(const Box& j, float area_j,
                                           const Box& i, float thresh) {
  const float xx1 = vmax<kFinite>(j.x1, i.x1);
  const float yy1 = vmax<kFinite>(j.y1, i.y1);
  const float xx2 = vmin<kFinite>(j.x2, i.x2);
  const float yy2 = vmin<kFinite>(j.y2, i.y2);
  const float inter = __fmul_rn(vclamp0<kFinite>(__fsub_rn(xx2, xx1)),
                                vclamp0<kFinite>(__fsub_rn(yy2, yy1)));
  const float den =
      __fadd_rn(__fsub_rn(__fadd_rn(area_j, area(i)), inter), 1e-20f);
  // Most pairs do not meet (inter = 0), and a zero numerator sends the
  // IEEE division to its slow path. 0 / den is a zero for any den but 0
  // and NaN; its sign changes no comparison below, so it is taken as +0.
  float ovr = inter == 0.f && den != 0.f && !isnan(den)
                  ? 0.f
                  : __fdiv_rn(inter, den);
  if (kDiou) {
    // (a + b) / 2 as a product by 0.5: the same correctly rounded value
    const float dx = __fsub_rn(__fmul_rn(__fadd_rn(j.x1, j.x2), 0.5f),
                               __fmul_rn(__fadd_rn(i.x1, i.x2), 0.5f));
    const float dy = __fsub_rn(__fmul_rn(__fadd_rn(j.y1, j.y2), 0.5f),
                               __fmul_rn(__fadd_rn(i.y1, i.y2), 0.5f));
    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    const float ew =
        __fsub_rn(vmax<kFinite>(j.x2, i.x2), vmin<kFinite>(j.x1, i.x1));
    const float eh =
        __fsub_rn(vmax<kFinite>(j.y2, i.y2), vmin<kFinite>(j.y1, i.y1));
    const float c2 = __fadd_rn(__fmul_rn(ew, ew), __fmul_rn(eh, eh));
    ovr = __fsub_rn(ovr, __fdiv_rn(d2, __fadd_rn(c2, 1e-20f)));
  }
  return ovr > thresh;
}

__device__ __forceinline__ Box load_box(const float* p) {
  return Box{__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3)};
}

__device__ __forceinline__ bool finite(const Box& b) {
  return isfinite(b.x1) && isfinite(b.y1) && isfinite(b.x2) &&
         isfinite(b.y2);
}

// The bits of one word of candidates that are not valid (or lie past K):
// removed from the start. Every thread of the block calls it for its t.
__device__ __forceinline__ unsigned invalid_ballot(const uint8_t* valid,
                                                   int t, int K) {
  return __ballot_sync(kFull, t >= K || !valid[t]);
}

// Word w of the bitmask design's shared memory: maskT[w * ldm + i] holds
// row i's word w (transposed, and ldm = K | 1 odd, so the chain's lanes and
// the mask's writers hit distinct banks).
struct MaskLayout {
  int W, ldm;
  size_t boxes, mask, words;  // byte offsets
  __host__ __device__ MaskLayout(int K) {
    W = (K + 31) / 32;
    ldm = K | 1;
    boxes = 0;
    mask = sizeof(Box) * K;
    words = mask + sizeof(unsigned) * W * ldm;
  }
  __host__ __device__ size_t bytes() const {
    return words + sizeof(unsigned) * 3 * W;
  }
};

template <bool kDiou>
__global__ void __launch_bounds__(kMaskThreads)
    nms_mask_kernel(const float* __restrict__ boxes,
                    const uint8_t* __restrict__ valid,
                    uint8_t* __restrict__ keep, int K, float thresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const MaskLayout L(K);
  Box* bs = reinterpret_cast<Box*>(smem + L.boxes);
  unsigned* maskT = reinterpret_cast<unsigned*>(smem + L.mask);
  unsigned* invalid = reinterpret_cast<unsigned*>(smem + L.words);
  unsigned* kept = invalid + L.W;
  unsigned* finite_bits = kept + L.W;  // boxes with finite coordinates
  const int W = L.W, ldm = L.ldm;
  boxes += static_cast<size_t>(blockIdx.x) * K * 4;
  valid += static_cast<size_t>(blockIdx.x) * K;
  keep += static_cast<size_t>(blockIdx.x) * K;

  for (int base = 0; base < K; base += blockDim.x) {
    const int t = base + threadIdx.x;
    const Box b = t < K ? load_box(boxes + 4 * t) : Box{};
    if (t < K) bs[t] = b;
    const unsigned bad = invalid_ballot(valid, t, K);
    const unsigned fin = __ballot_sync(kFull, t < K && finite(b));
    if ((t & 31) == 0 && t < K) {
      invalid[t >> 5] = bad;
      finite_bits[t >> 5] = fin;
    }
  }
  __syncthreads();

  // the mask: item (w, i), i fastest, so a warp shares candidate t's box.
  // The 32 tests of a word are unrolled and independent (no branch), so a
  // thread overlaps their latencies, on finite boxes; those at or below i
  // or past K are masked off (their box index clamped into the block's
  // boxes), and a pair with a NaN or inf coordinate is tested again with
  // NaN propagated.
  for (int item = threadIdx.x; item < W * K; item += blockDim.x) {
    const int w = item / K, i = item - w * K;
    unsigned bits = 0;
    if (32 * w + 31 > i) {  // a word with candidates above i
      const Box bi = bs[i];
      const float ai = area(bi);
      const int lo = max(32 * w, i + 1) - 32 * w;
      const int hi = min(32, K - 32 * w);
#pragma unroll
      for (int l = 0; l < 32; ++l) {
        const Box bt = bs[min(32 * w + l, K - 1)];
        bits |= static_cast<unsigned>(
                    suppresses<kDiou, true>(bi, ai, bt, thresh))
                << l;
      }
      const unsigned range =
          (hi == 32 ? ~0u : (1u << hi) - 1u) & ~((1u << lo) - 1u);
      const bool fi = (finite_bits[i >> 5] >> (i & 31)) & 1u;
      unsigned odd = range & (fi ? ~finite_bits[w] : ~0u);
      bits &= range & ~odd;
      for (; odd; odd &= odd - 1) {
        const int l = __ffs(odd) - 1;
        if (suppresses<kDiou, false>(bi, ai, bs[32 * w + l], thresh))
          bits |= 1u << l;
      }
    }
    maskT[w * ldm + i] = bits;
  }
  __syncthreads();

  // the chain, in warp 0: lane l holds word l of the removed bits
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    unsigned rem = lane < W ? invalid[lane] : 0u;
    for (int w = 0; w < W; ++w) {
      unsigned cur = __shfl_sync(kFull, rem, w);
      unsigned todo = ~cur, taken = 0;
      if (32 * w + 32 > K) todo &= (1u << (K - 32 * w)) - 1u;
      while (todo) {
        const int l = __ffs(todo) - 1;
        const int i = 32 * w + l;
        taken |= 1u << l;
        cur |= maskT[w * ldm + i];
        if (lane < W) rem |= maskT[lane * ldm + i];
        todo = ~cur & ~((2u << l) - 1u);  // l = 31: 2u << 31 == 0, none left
        if (32 * w + 32 > K) todo &= (1u << (K - 32 * w)) - 1u;
      }
      if (lane == 0) kept[w] = taken;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < K; t += blockDim.x)
    keep[t] = (kept[t >> 5] >> (t & 31)) & 1u;
}

// Above kMaskK: the block walks the chain, a barrier after each kept
// candidate. removed[w] holds word w's removed bits (invalid ones from the
// start); all threads read the same word after each barrier, so every
// thread takes the same branch.
template <bool kDiou>
__global__ void __launch_bounds__(kChainThreads)
    nms_chain_kernel(const float* __restrict__ boxes,
                     const uint8_t* __restrict__ valid,
                     uint8_t* __restrict__ keep, int K, float thresh) {
  extern __shared__ unsigned removed[];
  boxes += static_cast<size_t>(blockIdx.x) * K * 4;
  valid += static_cast<size_t>(blockIdx.x) * K;
  keep += static_cast<size_t>(blockIdx.x) * K;
  const int W = (K + 31) / 32;

  for (int base = 0; base < K; base += blockDim.x) {
    const int t = base + threadIdx.x;
    const unsigned bad = invalid_ballot(valid, t, K);
    if ((t & 31) == 0 && t < K) removed[t >> 5] = bad;
    if (t < K) keep[t] = 0;
  }
  for (int w = 0; w < W; ++w) {
    __syncthreads();
    unsigned todo = ~removed[w];
    if (32 * w + 32 > K) todo &= (1u << (K - 32 * w)) - 1u;
    while (todo) {
      const int l = __ffs(todo) - 1;
      const int i = 32 * w + l;
      if (threadIdx.x == 0) keep[i] = 1;
      const Box bi = load_box(boxes + 4 * i);
      const float ai = area(bi);
      for (int t = i + 1 + threadIdx.x; t < K; t += blockDim.x)
        if (suppresses<kDiou, false>(bi, ai, load_box(boxes + 4 * t),
                                     thresh))
          atomicOr(&removed[t >> 5], 1u << (t & 31));
      __syncthreads();
      // a thread past this read may already set bits of the next kept
      // candidate's row: bits above it, which leave the lowest one alone
      todo = ~removed[w] & ~((2u << l) - 1u);
      if (32 * w + 32 > K) todo &= (1u << (K - 32 * w)) - 1u;
    }
  }
}

template <bool kDiou>
int launch(const float* boxes, const uint8_t* valid, uint8_t* keep, int B,
           int K, float thresh, cudaStream_t stream) {
  if (K <= kMaskK) {
    const size_t bytes = MaskLayout(K).bytes();
    cudaError_t err = cudaFuncSetAttribute(
        nms_mask_kernel<kDiou>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    nms_mask_kernel<kDiou><<<B, kMaskThreads, bytes, stream>>>(
        boxes, valid, keep, K, thresh);
  } else {
    const size_t bytes = sizeof(unsigned) * ((K + 31) / 32);
    if (bytes > kSmemMax) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        nms_chain_kernel<kDiou>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    nms_chain_kernel<kDiou><<<B, kChainThreads, bytes, stream>>>(
        boxes, valid, keep, K, thresh);
  }
  return cudaGetLastError();
}

}  // namespace

// The largest K either design takes: the chain's removed bits in shared
// memory.
extern "C" int nms_greedy_max_k() {
  return static_cast<int>(kSmemMax / sizeof(unsigned) * 32);
}

// boxes [B,K,4] f32, valid [B,K] and keep [B,K] bool (one byte each, 0 or
// 1), all contiguous; one block an image on `stream`. Returns the CUDA
// error of the launch (0 when it was taken).
extern "C" int nms_greedy(const void* boxes, const void* valid, void* keep,
                          int B, int K, float thresh, int diou,
                          void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto bx = static_cast<const float*>(boxes);
  auto vd = static_cast<const uint8_t*>(valid);
  auto kp = static_cast<uint8_t*>(keep);
  return diou ? launch<true>(bx, vd, kp, B, K, thresh, s)
              : launch<false>(bx, vd, kp, B, K, thresh, s);
}
