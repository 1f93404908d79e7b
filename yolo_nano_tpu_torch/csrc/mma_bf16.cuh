// bf16 tile products on the tensor cores (mma.sync m16n8k16, bf16 operands,
// f32 sums), for Hopper (sm_90a); used by fused_stage_bf16.cu for every
// pointwise (1x1) product of the bf16 ShuffleV2 block, and by
// fused_dw_pw_bf16.cu for the heads' pointwise products.
//
// One product: out[m][n] = sum_k A[m][k] * W[k][n], m < M, n < N, with
//   - A: bf16 activations in shared memory, rows16(M) rows at row stride
//     lda = act_stride(K) (a round16 plus 8: an odd number of 16-byte units,
//     so the eight row addresses of an ldmatrix phase fall on distinct
//     banks); columns K..round16(K)-1 zero; rows past M are read, their
//     results dropped;
//   - W: bf16 weights transposed, Wt[n][k], [round8(N)][round16(K)],
//     zero-padded, 16-byte aligned, in device memory. With RESIDENT the
//     caller has copied all of it into shared memory at row stride
//     round16(K) + 8 (see load_rows), and the product runs with no barrier;
//     otherwise it streams through shared memory in chunks of kKC columns
//     of every row, double-buffered with cp.async;
//   - bias [N] f32 and rows [M] int in shared memory: each thread loads the
//     bias of its columns once, and each row's entry once a round, before
//     the round's epilogue stores anything (a load after the epilogue's
//     stores would wait on them); rows may be null (the entries are then 0);
//   - an epilogue functor epi(m, rows[m], n, v0, v1) called once for each
//     m < M and each even n < N with the sums of columns n and n + 1 plus
//     their bias (for an odd N, column N is read from bias[N] and W's zero
//     pad row, and the epilogue drops it).
//
// A fragments come by ldmatrix.x4 from the bf16 rows, B fragments by 32-bit
// loads of Wt's rows (a row stride of 4 mod 8 words puts the 32 loads of a
// warp on 32 banks). Each k-step's mma starts from a fresh zero and its sum
// is added to the running f32 sum on the CUDA cores, as mma_tf32.cuh does.
// Carried straight through the tensor core's accumulator instead, the
// sums drifted as K grew: on an H100 at K = 96 and 232 the bf16 outputs
// left the function's own (f64 sums, rounded to bf16 where the function
// rounds) 1.6x and 2x as often as cuDNN f32's did. A fresh zero per k-step
// keeps them at 0.9x to 1.04x of cuDNN's, for 4 to 5% of the stage's time
// (chip_smoke.py phase 5 holds and prints the shares).
//
// Work split: the block's kWarps warps form warps_m x warps_n; a warp owns
// kWM m16 tiles x up to NTW n8 tiles (a template argument: kNTW, or
// kNTWWide where N is above kWarps * kNTW * 8 = 256), so N is at most
// kWarps * kNTWWide * 8 = 512. One round covers warps_m * kWM * 16 rows and
// all of N: every output column of a round's rows is in registers before
// the round's epilogue, which an in-place product needs (a second pass
// over N would read rows the first pass's epilogue overwrote).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ynt {
namespace mma_bf16 {

constexpr int kWarps = 8;  // warps of a block
constexpr int kWM = 2;     // m16 tiles of a warp
constexpr int kNTW = 4;    // n8 tiles of a warp, at most, for N <= 256
constexpr int kNTWWide = 8;  // the same for 256 < N <= 512
constexpr int kKC = 32;    // weight columns (K) of one streamed chunk
constexpr int kNMax = kWarps * kNTWWide * 8;

// The n8 tiles a warp may own in a product of N columns.
__host__ __device__ constexpr int ntw_for(int n) {
  return n <= kWarps * kNTW * 8 ? kNTW : kNTWWide;
}

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Row stride (bf16 elements) of an activation buffer of k columns.
__host__ __device__ constexpr int act_stride(int k) {
  return round_up(k, 16) + 8;
}

// Row stride (bf16 elements) of weights held in shared memory, kc columns
// (a multiple of 16): kc/2 + 4 words, 4 mod 8.
__host__ __device__ constexpr int w_stride(int kc) { return kc + 8; }

// bf16 elements of shared memory a resident Wt of K x N takes.
__host__ __device__ constexpr int resident_elems(int k, int n) {
  return round_up(n, 8) * w_stride(round_up(k, 16));
}

// bf16 elements of the double-buffered chunks of a streamed Wt of N rows.
__host__ __device__ constexpr int stream_elems(int n) {
  return 2 * round_up(n, 8) * w_stride(kKC);
}

// Warps along N: the fewest (a power of 2) that leave each at most ntw n8
// tiles.
__host__ __device__ inline int warps_n(int n, int ntw) {
  const int nt = round_up(n, 8) / 8;
  int w = 1;
  while (w < kWarps && (nt + w - 1) / w > ntw) w *= 2;
  return w;
}

// d += a * b, one m16n8k16 bf16 product with f32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += a * b: the product's sum from a fresh zero, then added in f32.
__device__ __forceinline__ void mma_add(float (&acc)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma(d, a, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// The A fragment of one m16 x k16 tile: lane l gives the address of row
// l % 16, columns (l / 16) * 8 .. + 7.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const bf16* row) {
  const auto s = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
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

// Columns [k0, k0 + cols) of every row of Wt [np][kp] into buf [np][ldw],
// 16 bytes a copy (cols a multiple of 8, at most 8 * blockDim.x); the
// caller commits. A thread keeps one column and steps over rows.
__device__ __forceinline__ void load_rows(bf16* buf, int ldw, const bf16* Wt,
                                          int np, int kp, int k0, int cols) {
  const int vecs = cols / 8;
  const int per = blockDim.x / vecs;  // rows of one pass
  if (static_cast<int>(threadIdx.x) >= per * vecs) return;
  const int v = threadIdx.x % vecs * 8;
  for (int r = threadIdx.x / vecs; r < np; r += per)
    cp_async_zfill<16>(buf + r * ldw + v, Wt + r * kp + k0 + v, true);
}

// Starts the copy of a streamed Wt's first chunk into wbuf, as one cp.async
// group; a gemm called with prefetched = true then skips it.
__device__ __forceinline__ void prefetch(int K, int N, const bf16* Wt,
                                         bf16* wbuf) {
  const int kp = round_up(K, 16);
  load_rows(wbuf, w_stride(kKC), Wt, round_up(N, 8), kp, 0, min(kKC, kp));
  cp_async_commit();
}

// The product described at the top of this file, N at most kWarps * NTW *
// 8; every thread of the block calls it. RESIDENT: W is the shared-memory copy of Wt (w_stride(kp)), the
// caller has synchronised after writing A and W, and the product neither
// waits nor synchronises (but for IN_PLACE); a caller that reads what epi
// wrote to shared memory synchronises first. Streamed: W is Wt in device
// memory and wbuf holds stream_elems(N); before its first read of A every
// cp.async group the block committed earlier has completed and the block
// has synchronised; it synchronises after its last read of A and wbuf.
// IN_PLACE: epi may overwrite the rows of A it is called for; each round's
// epilogue then runs after a barrier that follows the round's last read of
// A (the rounds read disjoint rows).
template <bool RESIDENT, bool IN_PLACE, int NTW, typename Epi>
__device__ __forceinline__ void gemm(int M, int K, int N, const bf16* A,
                                     int lda, const bf16* __restrict__ W,
                                     bf16* wbuf, bool prefetched,
                                     const float* bias, const int* rows,
                                     Epi epi) {
  const int kp = round_up(K, 16);
  const int np = round_up(N, 8);
  const int wn_count = warps_n(N, NTW);
  const int nt_all = np / 8;
  const int ntw = (nt_all + wn_count - 1) / wn_count;  // <= NTW
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // groupID of the fragment layouts
  const int t = lane % 4;  // thread in group
  const int wm = warp / wn_count;
  const int mt_all = (M + 15) / 16;
  const int mt_round = (kWarps / wn_count) * kWM;
  const int kc = RESIDENT ? kp : kKC;  // weight columns of one chunk
  const int ldw = w_stride(kc);
  const int chunks = (kp + kc - 1) / kc;
  const int nt0 = (warp % wn_count) * ntw;
  const int n_tiles = min(ntw, nt_all - nt0);  // may be <= 0
  // this lane's ldmatrix row and column within an m16 x k16 tile
  const int a_row = lane % 16;
  const int a_col = lane / 16 * 8;
  float bias_r[NTW][2];
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int n = (nt0 + j) * 8 + 2 * t;
    const bool in = j < n_tiles && n < N;
    bias_r[j][0] = in ? bias[n] : 0.f;
    bias_r[j][1] = in ? bias[n + 1] : 0.f;
  }

  for (int mt_first = 0; mt_first < mt_all; mt_first += mt_round) {
    const int mt_warp = mt_first + wm * kWM;
    float acc[kWM][NTW][4];
#pragma unroll
    for (int i = 0; i < kWM; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    if (!RESIDENT && (mt_first > 0 || !prefetched)) {
      load_rows(wbuf, ldw, W, np, kp, 0, min(kKC, kp));
      cp_async_commit();
    }
    for (int c = 0; c < chunks; ++c) {
      const int k0 = c * kc;
      if (!RESIDENT) {
        if (c + 1 < chunks) {
          load_rows(wbuf + ((c + 1) & 1) * np * ldw, ldw, W, np, kp,
                    k0 + kKC, min(kKC, kp - k0 - kKC));
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
      }
      const bf16* wb = RESIDENT ? W : wbuf + (c & 1) * np * ldw;
      const int ksteps = min(kc, kp - k0) / 16;
      if (n_tiles > 0) {
#pragma unroll 2
        for (int ks = 0; ks < ksteps; ++ks) {
          uint32_t a[kWM][4], b[NTW][2];
#pragma unroll
          for (int i = 0; i < kWM; ++i)
            if (mt_warp + i < mt_all)
              ldmatrix_x4(a[i], A + ((mt_warp + i) * 16 + a_row) * lda + k0 +
                                    ks * 16 + a_col);
#pragma unroll
          for (int j = 0; j < NTW; ++j)
            if (j < n_tiles) {
              const bf16* w = wb + ((nt0 + j) * 8 + g) * ldw + ks * 16 + 2 * t;
              b[j][0] = *reinterpret_cast<const uint32_t*>(w);
              b[j][1] = *reinterpret_cast<const uint32_t*>(w + 8);
            }
#pragma unroll
          for (int i = 0; i < kWM; ++i)
#pragma unroll
            for (int j = 0; j < NTW; ++j)
              if (j < n_tiles && mt_warp + i < mt_all)
                mma_add(acc[i][j], a[i], b[j][0], b[j][1]);
        }
      }
      // the buffer may be refilled
      if (!RESIDENT) __syncthreads();
    }

    if (RESIDENT && IN_PLACE) __syncthreads();
    int tag[kWM][2];
#pragma unroll
    for (int i = 0; i < kWM; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (mt_warp + i) * 16 + g + h * 8;
        tag[i][h] = m < M && rows ? rows[m] : 0;
      }
#pragma unroll
    for (int i = 0; i < kWM; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (mt_warp + i) * 16 + g + h * 8;
        if (mt_warp + i >= mt_all || m >= M) continue;
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          const int n = (nt0 + j) * 8 + 2 * t;
          if (j < n_tiles && n < N)
            epi(m, tag[i][h], n, acc[i][j][2 * h] + bias_r[j][0],
                acc[i][j][2 * h + 1] + bias_r[j][1]);
        }
      }
    }
  }
}

}  // namespace mma_bf16
}  // namespace ynt
