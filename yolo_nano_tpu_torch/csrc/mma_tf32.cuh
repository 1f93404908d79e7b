// f32-accurate tile products on the tensor cores (3xTF32 mma.sync), for
// Hopper (sm_90a); used by fused_stage.cu and fused_dw_pw.cu for every
// pointwise (1x1) product.
//
// One product: out[m][n] = sum_k A[m][k] * W[k][n], m < M, n < N, with
//   - A: activations in shared memory, row stride lda = 4 mod 8 (as
//     act_stride gives), columns K..round8(K)-1 zero (rows past M are read
//     but their results dropped);
//   - W: by default weights in device memory, [round8(K)][round8(N)],
//     zero-padded, 16-byte aligned; streamed through shared memory in chunks
//     of kKC rows, double-buffered with cp.async. With RESIDENT, W is
//     already in shared memory, [round8(K)][w_stride(N)], zero-padded: the
//     product then waits on no cp.async group, so copies the caller started
//     stay in flight through it;
//   - an epilogue functor epi(m, n, v) called once for each m < M, n < N
//     (bias, activation and the store are the caller's).
//
// Precision: each operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (rounded as cvt.rna), and each k-step of 8 is summed as
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi. The dropped a_lo*b_lo term is below
// 2^-22 of |a*b|; a single TF32 pass keeps about 3 decimal digits. The three
// passes of a k-step accumulate on the tensor core into a fresh zero, and
// that sum is added to the running f32 sum on the CUDA cores: the tensor
// core rounds its sum toward zero at the scale of its largest addend, so
// running all 3*K/8 passes through one accumulator lost up to an ulp of the
// running sum at each pass, always the same way. Against the stage in f64
// (chip_smoke.py phase 2, batch 32 at 416 px on an H100) that gave 3.7x to
// 23x cuDNN f32's error; the fresh sums give 0.7x to 1.3x.
//
// Work split: the block's 16 warps form a grid of warps_m x warps_n; a warp
// owns kWM m16 tiles x up to kNTW n8 tiles (a 32 x 32 output tile), so N is
// at most kWarps * kNTW * 8 = 512. One round covers warps_m * kWM * 16 rows
// and all of N; the K chunks of W stream once per round, and the
// accumulators stay in registers until the round's epilogue. The epilogue
// runs after a barrier that follows the round's last read of A, so it may
// overwrite the round's own rows of A (fused_stage's pw1 does).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ynt {
namespace mma_tf32 {

constexpr int kWarps = 16;  // warps of a block
constexpr int kWM = 2;     // m16 tiles of a warp
constexpr int kNTW = 4;    // n8 tiles of a warp, at most
constexpr int kKC = 16;    // weight rows of one staged chunk

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Row stride (floats) of an activation buffer of k columns: k rounded to 8,
// plus 4, so that the 32 A-fragment loads of a warp fall on 32 banks.
__host__ __device__ constexpr int act_stride(int k) {
  return round_up(k, 8) + 4;
}

// Row stride of a staged weight chunk of n columns: an odd multiple of 8, so
// that the 32 B-fragment loads of a warp fall on 32 banks.
__host__ __device__ constexpr int w_stride(int n) {
  return round_up(n, 8) / 8 % 2 ? round_up(n, 8) : round_up(n, 8) + 8;
}

// Floats of shared memory the double-buffered weight chunks take.
__host__ __device__ constexpr int wbuf_floats(int n) {
  return 2 * kKC * w_stride(n);
}

// Warps along N: the fewest that leave each warp at most kNTW n8 tiles.
__host__ __device__ inline int warps_n(int n) {
  const int nt = round_up(n, 8) / 8;
  int w = 1;
  while (w < kWarps && (nt + w - 1) / w > kNTW) w *= 2;
  return w;
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: the rounding of cvt.rna.tf32.f32, done as an integer add to the
// magnitude and a mask (two integer operations; cvt.rna measured 8-13%
// slower in the stage kernel on an H100).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a * b, one m16n8k8 TF32 product with f32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 or 4 bytes (BYTES) from gmem, or zeros where !valid (src-size 0).
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* smem, const void* gmem,
                                               bool valid) {
  const auto s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
                 "l"(gmem), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
                 "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// Rows [k0, k0 + rows) of W [.][np] into buf [rows][ldw], 16 bytes a copy.
__device__ __forceinline__ void load_chunk(float* buf, const float* W, int np,
                                           int ldw, int k0, int rows) {
  const int vecs = np / 4;
  for (int i = threadIdx.x; i < rows * vecs; i += blockDim.x) {
    const int r = i / vecs;
    const int v = i % vecs;
    cp_async_zfill<16>(buf + r * ldw + v * 4, W + (k0 + r) * np + v * 4,
                       true);
  }
  cp_async_commit();
}

// Starts the copy of W's first chunk into wbuf, as one cp.async group; a
// gemm called with prefetched = true then skips it. Cp.async groups the
// caller commits in between complete before the gemm's first read of A.
__device__ __forceinline__ void prefetch(int K, int N, const float* W,
                                         float* wbuf) {
  load_chunk(wbuf, W, round_up(N, 8), w_stride(N), 0,
             min(kKC, round_up(K, 8)));
}

// The product described at the top of this file. Every thread of the block
// calls it; wbuf holds wbuf_floats(N) floats (unused with RESIDENT). By
// default, before its first read of A, every cp.async group the block
// committed earlier has completed and the block has synchronised; with
// RESIDENT the caller has synchronised after writing A and W. It
// synchronises before each epilogue. A caller that reads what epi wrote to
// shared memory synchronises first.
template <bool RESIDENT = false, typename Epi>
__device__ __forceinline__ void gemm(int M, int K, int N,
                                     const float* A, int lda,
                                     const float* __restrict__ W,
                                     float* wbuf, bool prefetched, Epi epi) {
  const int kp = round_up(K, 8);
  const int np = round_up(N, 8);
  const int ldw = w_stride(N);
  const int wn_count = warps_n(N);
  const int nt_all = np / 8;
  const int ntw = (nt_all + wn_count - 1) / wn_count;  // <= kNTW: N <= 512
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // groupID of the fragment layouts
  const int t = lane % 4;  // thread in group
  const int wm = warp / wn_count;
  const int mt_all = (M + 15) / 16;
  const int mt_round = (kWarps / wn_count) * kWM;
  const int kc = RESIDENT ? kp : kKC;  // weight rows of one chunk
  const int chunks = (kp + kc - 1) / kc;
  const int nt0 = (warp % wn_count) * ntw;
  const int n_tiles = min(ntw, nt_all - nt0);  // may be <= 0

  for (int mt_first = 0; mt_first < mt_all; mt_first += mt_round) {
    const int mt_warp = mt_first + wm * kWM;
    float acc[kWM][kNTW][4];
#pragma unroll
    for (int i = 0; i < kWM; ++i)
#pragma unroll
      for (int j = 0; j < kNTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    if (!RESIDENT && (mt_first > 0 || !prefetched))
      load_chunk(wbuf, W, np, ldw, 0, min(kKC, kp));
    for (int c = 0; c < chunks; ++c) {
      const int k0 = c * kc;
      if (!RESIDENT) {
        if (c + 1 < chunks) {
          load_chunk(wbuf + ((c + 1) & 1) * kKC * ldw, W, np, ldw, k0 + kKC,
                     min(kKC, kp - k0 - kKC));
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
      }
      const float* wb = RESIDENT ? W : wbuf + (c & 1) * kKC * ldw;
      const int ksteps = min(kc, kp - k0) / 8;
      if (n_tiles > 0) {
        // the operands of k-step ks + 1 load while ks's products run
        float a_raw[kWM][4], b_raw[kNTW][2];
        auto load = [&](int ks) {
#pragma unroll
          for (int i = 0; i < kWM; ++i) {
            if (mt_warp + i < mt_all) {
              const float* a =
                  A + ((mt_warp + i) * 16 + g) * lda + k0 + ks * 8 + t;
              a_raw[i][0] = a[0];
              a_raw[i][1] = a[8 * lda];
              a_raw[i][2] = a[4];
              a_raw[i][3] = a[8 * lda + 4];
            }
          }
#pragma unroll
          for (int j = 0; j < kNTW; ++j) {
            if (j < n_tiles) {
              const float* b = wb + (ks * 8 + t) * ldw + (nt0 + j) * 8 + g;
              b_raw[j][0] = b[0];
              b_raw[j][1] = b[4 * ldw];
            }
          }
        };
        load(0);
        // streamed: the chunk's k-steps unrolled; resident: a loop over K
#pragma unroll
        for (int ks = 0; ks < (RESIDENT ? ksteps : kKC / 8); ++ks) {
          if (ks < ksteps) {
            uint32_t a_hi[kWM][4], a_lo[kWM][4];
            uint32_t b_hi[kNTW][2], b_lo[kNTW][2];
#pragma unroll
            for (int i = 0; i < kWM; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                split(a_raw[i][e], a_hi[i][e], a_lo[i][e]);
#pragma unroll
            for (int j = 0; j < kNTW; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                split(b_raw[j][e], b_hi[j][e], b_lo[j][e]);
            if (ks + 1 < ksteps) load(ks + 1);
            // small terms first, into a fresh zero; then one f32 add
#pragma unroll
            for (int i = 0; i < kWM; ++i)
#pragma unroll
              for (int j = 0; j < kNTW; ++j)
                if (j < n_tiles && mt_warp + i < mt_all) {
                  float d[4] = {0.f, 0.f, 0.f, 0.f};
                  mma(d, a_lo[i], b_hi[j][0], b_hi[j][1]);
                  mma(d, a_hi[i], b_lo[j][0], b_lo[j][1]);
                  mma(d, a_hi[i], b_hi[j][0], b_hi[j][1]);
#pragma unroll
                  for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
                }
          }
        }
      }
      // the buffer is refilled, A's rows may be overwritten
      if (!RESIDENT || c + 1 == chunks) __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < kWM; ++i) {
#pragma unroll
      for (int j = 0; j < kNTW; ++j) {
        if (j < n_tiles && mt_warp + i < mt_all) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = (mt_warp + i) * 16 + g + (e / 2) * 8;
            const int n = (nt0 + j) * 8 + 2 * t + e % 2;
            if (m < M && n < N) epi(m, n, acc[i][j][e]);
          }
        }
      }
    }
  }
}

}  // namespace mma_tf32
}  // namespace ynt
