// K1: the fused NICE coupling net (inference), u = elu(elu(zcol·w1)·w2)·wp,
// and K4, the same chain for training, which also keeps the post-ELU
// hiddens a = bf16(elu(zcol·w1)) and b = bf16(elu(a·w2)), (M, Hid) each.
//
// K1 replaces ipoke_tpu/ops/nice_net.py::nice_net_raw_pallas (body
// _nice_net_kernel); K4 replaces its train variant _train_impl (body
// _nice_net_train_kernel), the forward rule of nice_net_raw_train, whose
// backward runs as matrix products outside any kernel in both packages.
// zcol is the 3x3 im2col of the coupling input (M = B·H·W rows, K1 = 9·C1
// columns), w1 (K1, Hid), w2 (Hid, Hid) and the tap-packed out weight wp
// (Hid, 9·Cout) are bf16; every product accumulates in fp32, ELU runs on the
// fp32 sum and its result is rounded to bf16 before the next product,
// exactly like the TPU kernel.  u is fp32.  The im2col, the shifted-add
// epilogue, the bias and the h-branch run in the wrapper.
//
// Bound on the H100: at the level-0 step coupling (M = 2560, K1 = 144,
// Hid = 2048, N = 288) one call is 26.0 GFLOP, 26.3 us at 989 TFLOP/s bf16;
// its least traffic is 13.8 MB (K1) or 34.8 MB with a and b (K4), 4-10 us at
// 3.35 TB/s: compute bound.
//
// Design.  The TPU kernel kept all three weights in 14 MB of VMEM; on Hopper
// one 64-row block of the first hidden at Hid = 2048 (256 KB) is already
// more than a block's 227 KB of shared memory.  So one call is three
// launches of one warp-specialised wgmma kernel, nice_net_stage<S>, each a
// tiled product with its epilogue:
//   S = 1: a = bf16(elu(zcol·w1)), (M, Hid), written to device memory;
//   S = 2: b = bf16(elu(a·w2)), (M, Hid), written to device memory;
//   S = 3: u = b·wp, (M, Np) fp32.
// K1 and K4 run the same three launches: for K1 the wrapper passes a and b
// as scratch from torch.empty, for K4 they are the residuals its backward
// needs.  So K4's u is K1's bit for bit, and there is no template flag.
//
// Each CTA computes one BM x BN output tile (BM = 128; BN = 128 for S = 1,
// 2 and 64 for S = 3) over K in BK = 64 slices.  Warps 0-7 are two consumer
// warpgroups (rows 0-63 and 64-127 of the tile); warp 8 issues the loads.
// A ring of 4 shared-memory stages is filled by TMA (cp.async.bulk.tensor,
// 128-byte swizzle, completion on a "full" mbarrier per stage; each
// consumer warp arrives on the stage's "empty" mbarrier once its products
// are done), so up to four K slices are in flight.  A tiles (128 x 64) are
// K-major; the weights are row-major (K, N), MN-major for B, loaded as
// 64-column boxes and read through wgmma's transpose bit, one m64n64k16 per
// box and 16-deep K step.  Accumulators stay in registers (64 fp32 a thread
// for BN = 128; nothing else is live with them).  The hidden epilogue
// applies ELU to the fp32 sums in registers, rounds pairs to bf16 into a
// swizzled tile that reuses the drained ring, and writes it with one TMA
// store per 64 columns, which clips the ragged last row block; S = 3 stores
// u as float2 from registers, masked to M rows and Np columns.
// Out-of-bounds loads (rows past M, K1 past K1p, columns past Np) are
// zero-filled by TMA.
//
// Why not fuse b into the u product (b tile kept on chip, u summed over the
// Hid/BN column slices): the partial sums of u are 8-16 slices of (M, Np)
// fp32, 23-47 MB at level 0, more than the 10.5 MB of b that S = 3 re-reads
// from L2, and their sum needs a reduction pass or a cluster.  Unfused, each
// u element is one CTA's dot product in a fixed K order: u is deterministic
// with no reduction and no atomics.  The working set of one call (w2 8.4
// MB, a and b 10.5 MB each at level 0) fits the 50 MB L2, so a and b are
// read back from L2 and the stores do not push w2 out; each w2 tile is read
// by M/128 = 20 row blocks (168 MB of L2 traffic).
//
// Per CTA (ptxas -v, sm_90a): 90 registers for S = 1, 2 and 58 for S = 3,
// no spills; dynamic shared memory 132,160 bytes (S = 1, 2) and 99,392 (S =
// 3), so one CTA per SM.  Waves on 132 SMs: at M = 2560 S = 1, 2 run 20 x
// 16 = 320 CTAs, 2.42 waves (81% of the three waves' SM slots busy); at M =
// 5120 640 CTAs, 4.85 waves (97%).  S = 3 at Np = 288 runs 20 x 5 = 100
// CTAs (76% of one wave), 200 at M = 5120 (1.52 waves, 76%).
//
// Not taken (tools/torch_nice_net_variants.py times such variants on the
// card): two CTAs per SM with a 3-stage ring each ran even with this on an
// H100; 2-CTA clusters that multicast each weight tile to both row blocks
// were slower there, so the stages are not limited by L2 reads.

// Shape contract (checked here and by the wrapper): K1p = K1 padded to a
// multiple of 16 (zcol and w1 zero-padded), Hid % 128 == 0, Np = 9·Cout
// padded to a multiple of 16 (wp zero-padded); M is arbitrary.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128, BK = 64, STAGES = 4;
constexpr int THREADS = 288;                   // 2 consumer warpgroups + 1 loader warp
constexpr int A_BYTES = BM * BK * 2;           // 16 KB
constexpr int BOX_BYTES = 64 * 64 * 2;         // one 64 x 64 bf16 box, 8 KB

template <int S> struct Stage {
  static constexpr int BN = S == 3 ? 64 : 128;
  static constexpr bool kHidden = S != 3;      // ELU + bf16 tile, else fp32 u
  static constexpr int B_BYTES = BK * BN * 2;
  // the bf16 output tile reuses the drained ring
  static_assert(BM * BN * 2 <= STAGES * (A_BYTES + B_BYTES), "C tile");
  static constexpr int SMEM = 1024 /* alignment slack */ +
      STAGES * (A_BYTES + B_BYTES) + 2 * STAGES * 8;
};

// ELU with expm1 as __expf(v) - 1: absolute error ~2e-7 (ex2.approx), below
// the bf16 rounding step of the result wherever |v| > 2^-14.  An accurate
// expm1f added ~12 us to each of stages 1 and 2 at level 0 on an H100.
__device__ __forceinline__ float elu(float v) { return v > 0.f ? v : __expf(v) - 1.f; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarrier -------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// --- TMA ------------------------------------------------------------------
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// --- wgmma ----------------------------------------------------------------
// Shared-memory matrix descriptor, 128-byte swizzle: start, leading and
// stride byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d += A·B, m64n64k16, bf16 in, fp32 accumulators; A K-major, B MN-major.
__device__ __forceinline__ void wgmma64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// One output tile of stage S: (BM rows from blockIdx.y) x (BN columns from
// blockIdx.x) of A (M, K) · B (K, N).  mA: A, boxes {64, 128}; mB: B, boxes
// {64, 64}; mC: the hidden written by S = 1, 2 (boxes {64, 128}); u: S = 3's
// output, (M, N) fp32.
template <int S>
__global__ void __launch_bounds__(THREADS, 1)
nice_net_stage(const __grid_constant__ CUtensorMap mA,
               const __grid_constant__ CUtensorMap mB,
               const __grid_constant__ CUtensorMap mC, float* __restrict__ u,
               int M, int N, int K) {
  using St = Stage<S>;
  constexpr int BN = St::BN, NB = BN / 64;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment for the swizzled tiles
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sA = base, sB = sA + STAGES * A_BYTES;
  const uint32_t full = sB + STAGES * St::B_BYTES, empty = full + STAGES * 8;

  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // loader warp: one thread keeps the ring full
    if (tid == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(empty + 8 * s, (kt / STAGES - 1) & 1);
        mbar_expect_tx(full + 8 * s, A_BYTES + St::B_BYTES);
        tma_load(sA + s * A_BYTES, &mA, kt * BK, m0, full + 8 * s);
        for (int j = 0; j < NB; ++j)
          tma_load(sB + s * St::B_BYTES + j * BOX_BYTES, &mB, n0 + 64 * j,
                   kt * BK, full + 8 * s);
      }
    }
  } else {
    // consumers: warpgroup wg owns rows 64·wg .. 64·wg + 63 of the tile
    float acc[NB][32];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;

    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(full + 8 * s, (kt / STAGES) & 1);
      const uint32_t a = sA + s * A_BYTES + wg * 64 * 128;
      const uint32_t b = sB + s * St::B_BYTES;
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A: K-major, 16 K values = 32 bytes along the swizzled 128-byte row;
        // B: MN-major, 16 K rows = two 8-row (1024-byte) swizzle atoms
        const uint64_t da = desc(a + kk * 32, 16, 1024);
#pragma unroll
        for (int j = 0; j < NB; ++j)
          wgmma64(acc[j], da, desc(b + j * BOX_BYTES + kk * 2048, BOX_BYTES, 1024));
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      // the previous slice's products are done: hand its stage back
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      if (kt > 0 && tid % 32 == 0) mbar_arrive(empty + 8 * ((kt - 1) % STAGES));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");

    // accumulator layout of m64nNk16: register i of thread t holds row
    // 16·warp + t/4 + 8·((i/2)%2), column 8·(i/4) + 2·(t%4) + i%2
    const int warp = (tid / 32) % 4, lane = tid % 32;
    const int r_base = wg * 64 + warp * 16 + lane / 4;
    if constexpr (St::kHidden) {
      // the output tile overwrites the ring: both warpgroups must be done
      asm volatile("bar.sync 1, 256;" ::: "memory");
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int r = r_base + 8 * ((i / 2) % 2);
          const int c = 8 * (i / 4) + 2 * (lane % 4);  // column in the 64-box
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(elu(acc[j][i]), elu(acc[j][i + 1]));
          // 128-byte swizzle: 16-byte chunk c/8 of row r sits at chunk (c/8)^(r%8)
          const int off = j * (BM * 128) + r * 128 + (((c / 8) ^ (r % 8)) * 16) + (c % 8) * 2;
          *reinterpret_cast<__nv_bfloat162*>(smem + off) = v;
        }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync 1, 256;" ::: "memory");
      if (tid == 0) {
        for (int j = 0; j < NB; ++j)
          tma_store(&mC, base + j * (BM * 128), n0 + 64 * j, m0);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
    } else {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int r = m0 + r_base + 8 * ((i / 2) % 2);
          const int c = n0 + 64 * j + 8 * (i / 4) + 2 * (lane % 4);
          if (r < M && c < N)
            *reinterpret_cast<float2*>(u + (size_t)r * N + c) =
                make_float2(acc[j][i], acc[j][i + 1]);
        }
    }
  }
}

// --- host -----------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, without linking libcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (rows, cols) bf16 matrix read or written in {64, box_rows}
// boxes with the 128-byte swizzle; out-of-bounds reads are zero.
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                int box_rows) {
  const EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t estrides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                dims, strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int S>
cudaError_t launch_stage(const CUtensorMap& a, const CUtensorMap& b,
                         const CUtensorMap& c, float* u, int M, int N, int K,
                         cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      nice_net_stage<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, Stage<S>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + Stage<S>::BN - 1) / Stage<S>::BN, (M + BM - 1) / BM);
  nice_net_stage<S><<<grid, THREADS, Stage<S>::SMEM, stream>>>(a, b, c, u, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// K1 and K4 on a rank's shard of the hidden width (the dp x tp mesh of
// ipoke_tpu_torch/parallel): w2 (hid x hs) holds hs of w2's columns and wp
// (hs x Np) the same rows of the tap-packed out weight, so S = 2 runs at N =
// hs and S = 3 at K = hs; a (M x hid) and b (M x hs) bf16 receive the
// post-ELU hiddens.  u (M x Np fp32) is the rank's partial of the coupling's
// u, which the caller sums over the ranks.  hs = hid is the unsplit chain.
// Three launches on `stream`; returns the first CUDA error.
extern "C" int nice_net_u_split(const void* zcol, const void* w1, const void* w2,
                                const void* wp, void* u, void* a, void* b, int M,
                                int K1p, int hid, int hs, int Np, void* stream) {
  if (M <= 0 || K1p <= 0 || K1p % 16 || hid <= 0 || hid % 128 || hs <= 0 ||
      hs % 128 || Np <= 0 || Np % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap m_z, m_w1, m_a, m_w2, m_b, m_wp;
  if (!tensor_map(&m_z, zcol, M, K1p, BM) || !tensor_map(&m_w1, w1, K1p, hid, BK) ||
      !tensor_map(&m_a, a, M, hid, BM) || !tensor_map(&m_w2, w2, hid, hs, BK) ||
      !tensor_map(&m_b, b, M, hs, BM) || !tensor_map(&m_wp, wp, hs, Np, BK))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float* out = (float*)u;
  cudaError_t err = launch_stage<1>(m_z, m_w1, m_a, out, M, hid, K1p, s);
  if (err == cudaSuccess) err = launch_stage<2>(m_a, m_w2, m_b, out, M, hs, hid, s);
  if (err == cudaSuccess) err = launch_stage<3>(m_b, m_wp, m_b, out, M, Np, hs, s);
  return (int)err;
}

// K1 and K4: u (M x Np fp32) = elu(elu(zcol·w1)·w2)·wp; a and b (M x hid
// bf16, row-major) receive the post-ELU hiddens (scratch for K1).  Three
// launches on `stream`; returns the first CUDA error.
extern "C" int nice_net_u(const void* zcol, const void* w1, const void* w2,
                          const void* wp, void* u, void* a, void* b, int M,
                          int K1p, int hid, int Np, void* stream) {
  return nice_net_u_split(zcol, w1, w2, wp, u, a, b, M, K1p, hid, hid, Np, stream);
}
