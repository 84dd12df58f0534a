// K1: the fused NICE coupling net (inference), u = elu(elu(zcol·w1)·w2)·wp,
// and K4, the same chain for training, which also stores the post-ELU
// hiddens a = bf16(elu(zcol·w1)) and b = bf16(elu(a·w2)), (M, Hid) each.
//
// K1 replaces ipoke_tpu/ops/nice_net.py::nice_net_raw_pallas (body
// _nice_net_kernel); K4 replaces its train variant _train_impl (body
// _nice_net_train_kernel), the forward rule of nice_net_raw_train, whose
// backward runs as matrix products outside any kernel in both packages.
// Both are one template: the kStore flag adds the two stores and nothing
// else, so K4's u is bitwise K1's.  zcol is the 3x3 im2col of the coupling
// input (M = B·H·W rows, K1 = 9·C1 columns), w1 (K1, Hid), w2 (Hid, Hid) and the
// tap-packed out weight wp (Hid, 9·Cout) are bf16; every dot accumulates in
// fp32, ELU runs on the fp32 accumulator and its result is rounded to bf16
// before the next dot, exactly like the TPU kernel.  u is fp32.  The im2col,
// the shifted-add epilogue, the bias and the h-branch run in the wrapper.
//
// Bound on the H100: at the shipped shapes (M = 2560, Hid = 2048) one call is
// ~27 GFLOP over ~10 MB of weights, far above the card's ~295 FLOP/byte, so
// it is compute bound and needs the tensor cores.  The unfused chain also
// writes and re-reads two (M, Hid) hiddens (~21 MB in bf16) per call.
// K4 at the level-0 step coupling (K1 = 144, N = 288): 26.0 GFLOP, 26 us at
// 989 TFLOP/s bf16; it moves ~35 MB (10.2 MB weights, 21 MB of a and b,
// 3 MB of u), 10 us at 3.35 TB/s: still compute bound.  The stores of a and
// b are 16-byte vectors from shared memory, coalesced along the row, and
// streaming (evict-first): every CTA re-reads all of w2 from L2, and plain
// stores of the 21 MB of a and b pushed w2 out of L2 (K4 took 1.0 ms against
// K1's 0.68 on an H100; with __stcs 0.80).
//
// Design: one CTA of 8 warps per 32-row block (80 CTAs at the shipped M).
//   1. a = bf16(elu(zcol·w1)) for the block stays in shared memory
//      (32 x 2048 bf16 = 128 KB); K4 copies it out once it is whole;
//   2. for each 128-column tile of w2: b_tile = bf16(elu(a·w2[:, tile]))
//      into shared memory, then immediately u += b_tile·wp[tile, :] with u
//      (32 x 9·Cout fp32) in shared memory — the second hidden b is never
//      stored in full on chip; K4 copies each tile out as it is made.
// All products are nvcuda::wmma 16x16x16 bf16 tiles with fp32 accumulators;
// B operands stream from global memory (the weights are L2 resident).  A
// first, simple kernel: no wgmma, TMA or cp.async pipelining yet.
//
// Shape contract (checked by the wrapper): K1p = K1 padded to a multiple of
// 16 (zcol and w1 zero-padded), Hid % 128 == 0, Np = 9·Cout padded to a
// multiple of 16 (wp zero-padded); M is arbitrary (the last block masks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 32;      // rows per CTA
constexpr int BN2 = 128;    // w2 column tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;      // bf16 row padding (16 B) against bank conflicts

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ float elu(float v) { return v > 0.f ? v : expm1f(v); }

// ELU on a 16x16 fp32 accumulator, rounded to bf16 into dst (row stride ldd),
// through a per-warp 16x16 fp32 staging tile.
__device__ __forceinline__ void store_elu_bf16(FragC& acc, float* stage,
                                               bf16* dst, int ldd, int lane) {
  for (int i = 0; i < acc.num_elements; ++i) acc.x[i] = elu(acc.x[i]);
  wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
  __syncwarp();
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int c = 0; c < 8; ++c)
    dst[r * ldd + c0 + c] = __float2bfloat16(stage[r * 16 + c0 + c]);
  __syncwarp();
}

// Copy rows [0, rows) of a BM x cols bf16 tile (row stride lds, in shared
// memory) to global memory (row stride ldg), 8 values (16 bytes) a thread,
// with streaming stores that do not keep the lines in L2.
__device__ __forceinline__ void store_tile(const bf16* src, int lds, bf16* dst,
                                           size_t ldg, int rows, int cols,
                                           int tid) {
  const int vec_per_row = cols / 8;
  for (int i = tid; i < rows * vec_per_row; i += THREADS) {
    const int r = i / vec_per_row, c = (i % vec_per_row) * 8;
    __stcs(reinterpret_cast<uint4*>(dst + r * ldg + c),
           *reinterpret_cast<const uint4*>(src + r * lds + c));
  }
}

size_t smem_bytes(int K1p, int hid, int Np) {
  return sizeof(bf16) * BM * ((hid + PAD) + (K1p + PAD) + (BN2 + PAD)) +
         sizeof(float) * (BM * (Np + 4) + WARPS * 256);
}

// kStore: K4, which also writes a and b (M x hid bf16); else K1.
template <bool kStore>
__global__ void __launch_bounds__(THREADS)
nice_net_kernel(const bf16* __restrict__ zcol, const bf16* __restrict__ w1,
                const bf16* __restrict__ w2, const bf16* __restrict__ wp,
                float* __restrict__ u, bf16* __restrict__ a_out,
                bf16* __restrict__ b_out, int M, int K1p, int hid, int Np) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = hid + PAD, ldz = K1p + PAD, ldb = BN2 + PAD, ldu = Np + 4;
  bf16* a_s = reinterpret_cast<bf16*>(smem);       // BM x lda
  bf16* z_s = a_s + BM * lda;                      // BM x ldz
  bf16* b_s = z_s + BM * ldz;                      // BM x ldb
  float* u_s = reinterpret_cast<float*>(b_s + BM * ldb);  // BM x ldu
  float* stage = u_s + BM * ldu;                   // WARPS x 16 x 16

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM;
  const int rows = min(BM, M - m0);
  float* wstage = stage + warp * 256;

  // 0. zcol block -> smem (rows past M are zero), u accumulator = 0
  for (int i = tid; i < BM * K1p; i += THREADS) {
    const int r = i / K1p, c = i % K1p;
    z_s[r * ldz + c] = (m0 + r < M) ? zcol[(size_t)(m0 + r) * K1p + c]
                                    : __float2bfloat16(0.f);
  }
  for (int i = tid; i < BM * ldu; i += THREADS) u_s[i] = 0.f;
  __syncthreads();

  // 1. a = bf16(elu(z·w1)); warp w owns column tiles w, w+8, ...
  for (int ct = warp; ct < hid / 16; ct += WARPS) {
    FragC c0, c1;
    wmma::fill_fragment(c0, 0.f);
    wmma::fill_fragment(c1, 0.f);
    for (int k = 0; k < K1p; k += 16) {
      FragA af;
      FragB bfr;
      wmma::load_matrix_sync(bfr, w1 + (size_t)k * hid + ct * 16, hid);
      wmma::load_matrix_sync(af, z_s + k, ldz);
      wmma::mma_sync(c0, af, bfr, c0);
      wmma::load_matrix_sync(af, z_s + 16 * ldz + k, ldz);
      wmma::mma_sync(c1, af, bfr, c1);
    }
    store_elu_bf16(c0, wstage, a_s + ct * 16, lda, lane);
    store_elu_bf16(c1, wstage, a_s + 16 * lda + ct * 16, lda, lane);
  }
  __syncthreads();
  if (kStore) store_tile(a_s, lda, a_out + (size_t)m0 * hid, hid, rows, hid, tid);

  const int n_frag_u = 2 * (Np / 16);
  for (int j0 = 0; j0 < hid; j0 += BN2) {
    // 2. b_tile = bf16(elu(a·w2[:, j0:j0+128])); warp w owns 16 columns
    {
      FragC c0, c1;
      wmma::fill_fragment(c0, 0.f);
      wmma::fill_fragment(c1, 0.f);
      const bf16* bcol = w2 + j0 + warp * 16;
#pragma unroll 4
      for (int k = 0; k < hid; k += 16) {
        FragA af;
        FragB bfr;
        wmma::load_matrix_sync(bfr, bcol + (size_t)k * hid, hid);
        wmma::load_matrix_sync(af, a_s + k, lda);
        wmma::mma_sync(c0, af, bfr, c0);
        wmma::load_matrix_sync(af, a_s + 16 * lda + k, lda);
        wmma::mma_sync(c1, af, bfr, c1);
      }
      store_elu_bf16(c0, wstage, b_s + warp * 16, ldb, lane);
      store_elu_bf16(c1, wstage, b_s + 16 * ldb + warp * 16, ldb, lane);
    }
    __syncthreads();
    if (kStore)
      store_tile(b_s, ldb, b_out + (size_t)m0 * hid + j0, hid, rows, BN2, tid);
    // 3. u += b_tile · wp[j0:j0+128, :]
    for (int f = warp; f < n_frag_u; f += WARPS) {
      const int rt = f & 1, nt = f >> 1;
      FragC c;
      wmma::load_matrix_sync(c, u_s + rt * 16 * ldu + nt * 16, ldu,
                             wmma::mem_row_major);
#pragma unroll
      for (int k = 0; k < BN2; k += 16) {
        FragA af;
        FragB bfr;
        wmma::load_matrix_sync(bfr, wp + (size_t)(j0 + k) * Np + nt * 16, Np);
        wmma::load_matrix_sync(af, b_s + rt * 16 * ldb + k, ldb);
        wmma::mma_sync(c, af, bfr, c);
      }
      wmma::store_matrix_sync(u_s + rt * 16 * ldu + nt * 16, c, ldu,
                              wmma::mem_row_major);
    }
    __syncthreads();  // b_s is rewritten by the next tile
  }

  for (int i = tid; i < BM * Np; i += THREADS) {
    const int r = i / Np, c = i % Np;
    if (m0 + r < M) u[(size_t)(m0 + r) * Np + c] = u_s[r * ldu + c];
  }
}

template <bool kStore>
int launch(const void* zcol, const void* w1, const void* w2, const void* wp,
           void* u, void* a, void* b, int M, int K1p, int hid, int Np,
           void* stream) {
  if (M <= 0 || K1p % 16 || hid % BN2 || Np % 16) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(K1p, hid, Np);
  cudaError_t err = cudaFuncSetAttribute(
      nice_net_kernel<kStore>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + BM - 1) / BM);
  nice_net_kernel<kStore><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)zcol, (const bf16*)w1, (const bf16*)w2, (const bf16*)wp,
      (float*)u, (bf16*)a, (bf16*)b, M, K1p, hid, Np);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nice_net_u(const void* zcol, const void* w1, const void* w2,
                          const void* wp, void* u, int M, int K1p, int hid,
                          int Np, void* stream) {
  return launch<false>(zcol, w1, w2, wp, u, nullptr, nullptr, M, K1p, hid, Np,
                       stream);
}

// K4: as nice_net_u, and a, b (M x hid bf16, row-major) receive the hiddens.
extern "C" int nice_net_train_u(const void* zcol, const void* w1,
                                const void* w2, const void* wp, void* u,
                                void* a, void* b, int M, int K1p, int hid,
                                int Np, void* stream) {
  return launch<true>(zcol, w1, w2, wp, u, a, b, M, K1p, hid, Np, stream);
}
