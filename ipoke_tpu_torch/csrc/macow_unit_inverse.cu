// K2: the inverse of one whole MaCowUnit in one launch, a thread-block
// cluster per batch item.
//
// Replaces ipoke_tpu/ops/masked_conv.py::macow_unit_inverse_pallas (body
// _unit_kernel).  A MaCowUnit is MCF(A) -> MCF(B) -> ActNorm1 -> MCF(C) ->
// MCF(D) -> ActNorm2; its inverse is AN2^-1, MCF-D, MCF-C (both in
// H<->W-transposed space, square latents), AN1^-1, MCF-B, MCF-A.  Each MCF
// inverse is a recurrence over H dependent rows; row r computes, per column
// w and hidden unit j,
//   hid[w][j] = elu(sum_{dy,dx,c} buf[start+dy][w+dx][c] * w_shift[dy][dx][c][j])
//   raw[w][k] = sum_j hid[w][j] * w_hid[j][k] + hc[r][w][k]        (k < 2C)
//   x[r][w][c] = (y[r][w][c] - raw[w][c]) / (tanh(raw[w][C+c]/2)*alpha + 1 + 1e-12)
// and writes x back into buf, where the next row reads it.  hc = elu(h)·w_h
// + b (the conditioning half of the 1x1 out conv and its bias) is computed
// by the wrapper, as on the TPU.  Everything is fp32, like the TPU kernel.
//
// Bound on the H100: latency.  One unit is 4 recurrences x H (= 8) dependent
// rows, 200 units per sampling pass, and a row is only ~0.26 M multiply-adds
// per batch item, so the cost is the chain of 32 dependent row steps.
//
// Design:
// - A cluster of CLUSTER = 4 CTAs per batch item: 160 CTAs at B = 40, two
//   per SM, one wave.  The cluster splits the hidden units: a CTA computes
//   hk = hid/4 (rounded up to 4) of them for every column of the row, from
//   its slice of the flow's w_shift and w_hid, and the partial (W, 2C)
//   product of its hiddens with its rows of w_hid.  The partials go through
//   distributed shared memory with one cluster barrier per row (two
//   buffers, by row parity, so a CTA never overwrites a partial a peer may
//   still read).  Every CTA adds the 4 partials in rank order and computes
//   the whole row's affine inverse itself, so all four hold the same buffer,
//   bit for bit, with no second exchange, and the result is reproducible.
// - Weights off the critical path: the next flow's weight slice is copied
//   by cp.async.bulk, completing on an mbarrier, into the second of two
//   buffers while the current flow's rows run.  At a flow's start each
//   thread loads its share of its hidden unit's tap weights into registers,
//   where they stay for all H rows.
// - The tap dot: 8 lanes share one hidden unit, each owning NQ groups of
//   (dy, 4 channels) and all kw taps.  A lane reads one float4 of 4
//   channels per column of the window (the 4 hidden units of a warp read
//   the same addresses: broadcasts), and the 8 lanes' sums for 8 columns
//   are reduce-scattered with 7 shuffles, leaving each lane one column.
// - The row's conditioning term hc is loaded into registers at the row's
//   start and consumed by its epilogue, so its latency hides under the dot.
// - ELU as the TPU kernel computes it, exp(min(a, 0)) - 1, with __expf
//   (~2e-7 absolute); tanhf stays accurate (tanh.approx errs by ~5e-4, above
//   the 1e-4 parity).  No tensor cores: a row's product is only W = 8
//   columns deep per item, and TF32 misses the fp32 parity.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_copy.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 4;               // CTAs per batch item
constexpr int THREADS = 256;
constexpr int SPLIT = 8;                 // lanes sharing one hidden unit's tap dot
constexpr int JSLOTS = THREADS / SPLIT;  // hidden units a CTA can hold: 32
constexpr int COLS = 8;                  // columns per pass of the tap dot
constexpr int AMAX = 4;                  // affine elements per thread: W*C <= AMAX*THREADS
constexpr int NQ_MAX = 2;                // tap groups per lane: kh*ceil(C/4) <= NQ_MAX*SPLIT
constexpr int KW = 3;                    // kernel width in scan space, as configured: (2, 3)

__device__ __forceinline__ float elu(float v) {
  return v > 0.f ? v : __expf(fminf(v, 0.f)) - 1.f;
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

struct Dims {
  int H, W, C, hid, kh, kw, cw;
  int Cp;    // C rounded up to 4: buf holds float4 groups of channels
  int Wpad;  // buf columns: W rounded up to COLS, plus kw - 1
  int hk;    // hidden units per CTA, a multiple of 4 (16-byte bulk copies)
  int Q;     // tap groups (dy, 4 channels): kh * Cp / 4
};

Dims make_dims(int H, int W, int C, int hid, int kh, int kw) {
  Dims d;
  d.H = H; d.W = W; d.C = C; d.hid = hid; d.kh = kh; d.kw = kw;
  d.cw = (kw - 1) / 2;
  d.Cp = round4(C);
  d.Wpad = (W + COLS - 1) / COLS * COLS + kw - 1;
  d.hk = round4((hid + CLUSTER - 1) / CLUSTER);
  d.Q = kh * d.Cp / 4;
  return d;
}

// Shared memory, in floats after 16 bytes of mbarriers, each region on a
// 16-byte boundary: two weight slices (w_shift [kh*kw*C][hk], then w_hid
// [hk][2C]), buf (H+kh, Wpad, Cp), cur (H, W, C), one row of the CTA's
// hiddens (W, hk+4) and the row's partial products, two of (W, 2C).
// ipoke_tpu_torch/ops/masked_conv.py::k2_smem_bytes mirrors this.
__host__ __device__ __forceinline__ int slice_floats(const Dims& d) {
  return d.kh * d.kw * d.C * d.hk + d.hk * 2 * d.C;
}
__host__ __device__ __forceinline__ int buf_floats(const Dims& d) {
  return round4((d.H + d.kh) * d.Wpad * d.Cp);
}
size_t smem_bytes(const Dims& d) {
  const int floats = 2 * slice_floats(d) + buf_floats(d) + round4(d.H * d.W * d.C) +
                     round4(d.W * (d.hk + 4)) + round4(2 * d.W * 2 * d.C);
  return 16 + 4 * (size_t)floats;
}

// Warp 0 copies this CTA's slice of flow m's weights into dst: for each of
// the kh*kw*C tap rows of w_shift the CTA's hk hidden units (hk*4 bytes),
// then its hk rows of w_hid; completion on bar.  Every address and size is
// a multiple of 16 bytes since hid and hk are multiples of 4.
__device__ __forceinline__ void fetch_slice(const Dims& d, int m, float* dst,
                                            uint64_t* bar, const float* w_shift,
                                            const float* w_hid, int j0, int nj) {
  const int lane = threadIdx.x & 31;
  const int rows = d.kh * d.kw * d.C;
  const uint32_t b = smem_u32(bar);
  if (lane == 0) {
    // generic-proxy reads of the buffer (the last flow's) come before the
    // async-proxy writes of this copy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_expect_tx(b, (uint32_t)(rows + 2 * d.C) * nj * 4);
  }
  __syncwarp();
  if (nj == 0) return;
  const float* ws = w_shift + (size_t)m * rows * d.hid + j0;
  for (int r = lane; r < rows; r += 32)
    bulk_load(dst + r * d.hk, ws + (size_t)r * d.hid, nj * 4, b);
  if (lane == 0)
    bulk_load(dst + rows * d.hk, w_hid + ((size_t)m * d.hid + j0) * 2 * d.C,
              nj * 2 * d.C * 4, b);
}

// One masked-conv recurrence in scan space.  Reads cur, leaves the result in
// buf rows [0, H) (reverse) or [kh, kh+H) (forward), columns [cw, cw+W).
// `g` counts rows over the unit, for the parity of the partials' buffer.
template <int NQ>
__device__ __forceinline__ void rowscan(const Dims& d, cg::cluster_group& cluster,
                                        const float* wsl, float* buf, const float* cur,
                                        float* hid_s, float* xpart,
                                        const float* __restrict__ hcm, float alpha,
                                        bool reverse, int nj, int& g) {
  const int tid = threadIdx.x;
  const int s = tid & (SPLIT - 1);  // this lane's tap split
  const int jl = tid / SPLIT;       // its hidden unit in the CTA's slice
  const int H = d.H, W = d.W, C = d.C, Cp = d.Cp, Wpad = d.Wpad, hk = d.hk;
  const int C4 = Cp / 4, twoC = 2 * C, hs = hk + 4;
  const float* ws = wsl;                        // [(dy*kw + dx)*C + c][hk]
  const float* wh = wsl + d.kh * KW * C * hk;  // [j][2C]

  // the lane's tap weights for all H rows: wr[q][cc][dx] of hidden unit jl
  // at tap group qq = s + q*SPLIT, i.e. row dy and channel 4*c4 + cc; zero
  // past C, past the CTA's hidden units and past the last group
  float wr[NQ][4][KW];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int qq = s + q * SPLIT, dy = qq / C4, c4 = qq % C4;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int c = 4 * c4 + cc;
#pragma unroll
      for (int dx = 0; dx < KW; ++dx)
        wr[q][cc][dx] = (qq < d.Q && c < C && jl < nj)
                            ? ws[((dy * KW + dx) * C + c) * hk + jl] : 0.f;
    }
  }

  const int n_aff = W * C;
  const int wstep = THREADS / twoC;  // columns apart in the out product
  const int k_out = tid % twoC, w_out = tid / twoC;
  for (int i = 0; i < H; ++i, ++g) {
    const int row = reverse ? H - 1 - i : i;
    const int start = reverse ? row + 1 : row;
    // this row's conditioning term, in flight during the dot
    float hmu[AMAX], hls[AMAX];
#pragma unroll
    for (int a = 0; a < AMAX; ++a) {
      const int idx = tid + a * THREADS;
      hmu[a] = hls[a] = 0.f;
      if (idx < n_aff) {
        const float* p = hcm + ((size_t)row * W + idx / C) * twoC + idx % C;
        hmu[a] = __ldg(p);
        hls[a] = __ldg(p + C);
      }
    }

    // hidden units: lane s of each group of 8 sums its tap groups for 8
    // columns, then the group reduce-scatters so that lane s holds column s
    for (int w0 = 0; w0 < W; w0 += COLS) {
      float acc[COLS];
#pragma unroll
      for (int k = 0; k < COLS; ++k) acc[k] = 0.f;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int qq = s + q * SPLIT;
        if (qq < d.Q) {
          const float* src = buf + ((start + qq / C4) * Wpad + w0) * Cp + 4 * (qq % C4);
#pragma unroll
          for (int col = 0; col < COLS + KW - 1; ++col) {
            const float4 v = *reinterpret_cast<const float4*>(src + col * Cp);
#pragma unroll
            for (int dx = 0; dx < KW; ++dx) {
              const int k = col - dx;
              if (k >= 0 && k < COLS) {
                acc[k] = fmaf(v.x, wr[q][0][dx], acc[k]);
                acc[k] = fmaf(v.y, wr[q][1][dx], acc[k]);
                acc[k] = fmaf(v.z, wr[q][2][dx], acc[k]);
                acc[k] = fmaf(v.w, wr[q][3][dx], acc[k]);
              }
            }
          }
        }
      }
      const bool b4 = s & 4, b2 = s & 2, b1 = s & 1;
      float r4[4], r2[2];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        r4[k] = (b4 ? acc[k + 4] : acc[k]) +
                __shfl_xor_sync(0xffffffffu, b4 ? acc[k] : acc[k + 4], 4);
#pragma unroll
      for (int k = 0; k < 2; ++k)
        r2[k] = (b2 ? r4[k + 2] : r4[k]) +
                __shfl_xor_sync(0xffffffffu, b2 ? r4[k] : r4[k + 2], 2);
      const float sum = (b1 ? r2[1] : r2[0]) +
                        __shfl_xor_sync(0xffffffffu, b1 ? r2[0] : r2[1], 1);
      const int w = w0 + s;
      if (w < W && jl < nj) hid_s[w * hs + jl] = elu(sum);
    }
    __syncthreads();

    // the CTA's partial of the 1x1 out product: thread (k, columns w_out,
    // w_out + wstep, ...), the w_hid element shared by its columns
    float* xp = xpart + (g & 1) * W * twoC;
    if (w_out < wstep) {
      for (int wb = w_out; wb < W; wb += 4 * wstep) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int j = 0; j < nj; j += 4) {
          float wv[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) wv[t] = wh[(j + t) * twoC + k_out];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int w = wb + u * wstep;
            if (w < W) {
              const float4 hv = *reinterpret_cast<const float4*>(hid_s + w * hs + j);
              acc[u] = fmaf(hv.x, wv[0], acc[u]);
              acc[u] = fmaf(hv.y, wv[1], acc[u]);
              acc[u] = fmaf(hv.z, wv[2], acc[u]);
              acc[u] = fmaf(hv.w, wv[3], acc[u]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (wb + u * wstep < W) xp[(wb + u * wstep) * twoC + k_out] = acc[u];
      }
    }
    cluster.sync();  // every CTA's partial of this row is written

    // affine inverse of the row: the partials added in rank order
    const int write_at = reverse ? row : row + d.kh;
#pragma unroll
    for (int a = 0; a < AMAX; ++a) {
      const int idx = tid + a * THREADS;
      if (idx < n_aff) {
        const int w = idx / C, c = idx % C;
        float mu = 0.f, ls = 0.f;
#pragma unroll
        for (int r = 0; r < CLUSTER; ++r) {
          const float* pr = cluster.map_shared_rank(xp, r) + w * twoC;
          mu += pr[c];
          ls += pr[C + c];
        }
        mu += hmu[a];
        ls += hls[a];
        const float scale = tanhf(ls * 0.5f) * alpha + 1.0f;
        buf[(write_at * Wpad + d.cw + w) * Cp + c] =
            (cur[(row * W + w) * C + c] - mu) / (scale + 1e-12f);
      }
    }
    __syncthreads();
  }
}

template <int NQ>
__global__ void __launch_bounds__(THREADS, 2)
macow_unit_inverse_kernel(const float* __restrict__ y,
                          const float* __restrict__ w_shift,
                          const float* __restrict__ w_hid,
                          const float* __restrict__ hc,
                          const float* __restrict__ an_bias,
                          const float* __restrict__ an_inv,
                          float* __restrict__ x, int B, Dims d, float alpha) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / CLUSTER;
  const int tid = threadIdx.x;
  const int H = d.H, W = d.W, C = d.C, kh = d.kh, Wpad = d.Wpad, Cp = d.Cp;
  const int n_img = H * W * C, n_w = slice_floats(d);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  float* wbuf = reinterpret_cast<float*>(smem_raw + 16);
  float* buf = wbuf + 2 * n_w;
  float* cur = buf + buf_floats(d);
  float* hid_s = cur + round4(n_img);
  float* xpart = hid_s + round4(W * (d.hk + 4));
  const int j0 = rank * d.hk;
  const int nj = max(0, min(d.hk, d.hid - j0));  // this CTA's hidden units
  const float* yb = y + (size_t)b * n_img;

  if (tid == 0) {
    mbar_init(smem_u32(&bars[0]), 1);
    mbar_init(smem_u32(&bars[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid < 32) {  // D and C, the first two flows, into the two buffers
    fetch_slice(d, 3, wbuf, &bars[0], w_shift, w_hid, j0, nj);
    fetch_slice(d, 2, wbuf + n_w, &bars[1], w_shift, w_hid, j0, nj);
  }
  // zero buf (its pad columns stay zero for the whole unit), then AN2^-1,
  // written transposed (scan space of D and C)
  for (int i = tid; i < buf_floats(d); i += THREADS) buf[i] = 0.f;
  for (int idx = tid; idx < n_img; idx += THREADS) {
    const int i = idx / (W * C), j = (idx / C) % W, c = idx % C;
    cur[(j * W + i) * C + c] = (yb[idx] - an_bias[C + c]) * an_inv[C + c];
  }
  __syncthreads();

  // buf cell of result row r, column w, channel c after a recurrence
  auto res = [&](bool reverse, int r, int w, int c) -> float& {
    return buf[((r + (reverse ? 0 : kh)) * Wpad + d.cw + w) * Cp + c];
  };
  int g = 0;
  for (int stage = 0; stage < 4; ++stage) {  // flows D, C, B, A
    const int m = 3 - stage;
    const bool reverse = m & 1;  // D and B run bottom-up
    float* wsl = wbuf + (stage & 1) * n_w;
    mbar_wait(smem_u32(&bars[stage & 1]), (stage >> 1) & 1);
    rowscan<NQ>(d, cluster, wsl, buf, cur, hid_s, xpart,
                    hc + ((size_t)m * B + b) * H * W * 2 * C, alpha, reverse, nj, g);
    if (stage < 2 && tid < 32)  // B after D, A after C, into the freed buffer
      fetch_slice(d, m - 2, wsl, &bars[stage & 1], w_shift, w_hid, j0, nj);
    if (stage == 3) break;
    for (int idx = tid; idx < n_img; idx += THREADS) {
      const int i = idx / (W * C), j = (idx / C) % W, c = idx % C;
      if (stage == 1)  // back from transposed space, then AN1^-1
        cur[idx] = (res(false, j, i, c) - an_bias[c]) * an_inv[c];
      else
        cur[idx] = res(reverse, i, j, c);
    }
    __syncthreads();
    // the rows the next recurrence reads first: above the image for a
    // forward one, below it for a reverse one
    const int pad0 = reverse ? 0 : H;
    for (int i = tid; i < kh * Wpad * Cp; i += THREADS) buf[pad0 * Wpad * Cp + i] = 0.f;
    __syncthreads();
  }
  // x: each CTA of the cluster holds all of it and writes a quarter
  float* xb = x + (size_t)b * n_img;
  const int per = (n_img + CLUSTER - 1) / CLUSTER;
  for (int idx = rank * per + tid; idx < min(n_img, (rank + 1) * per); idx += THREADS)
    xb[idx] = res(false, idx / (W * C), (idx / C) % W, idx % C);
  cluster.sync();  // no CTA leaves while a peer may read its partials
}

// The shapes the kernel takes (ops/masked_conv.py::unit_fits mirrors it).
bool takes(const Dims& d) {
  return d.H > 0 && d.H == d.W && d.C > 0 && d.hid > 0 && d.hid % 4 == 0 &&
         d.kh > 0 && d.kw == KW && d.hk <= JSLOTS &&
         d.Q <= NQ_MAX * SPLIT && d.W * d.C <= AMAX * THREADS;
}

using Kernel = void (*)(const float*, const float*, const float*, const float*,
                        const float*, const float*, float*, int, Dims, float);

// A launch of the kernel for B items at d: the instance for its tap groups,
// its shared memory opted into, a cluster of CLUSTER CTAs per item.
cudaError_t prepare(const Dims& d, int B, cudaStream_t stream, Kernel* kernel,
                    cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  if (B <= 0 || !takes(d)) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  *kernel = d.Q <= SPLIT ? macow_unit_inverse_kernel<1> : macow_unit_inverse_kernel<2>;
  err = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(B * CLUSTER);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// y, x (B, H, W, C); w_shift (4, kh, kw, C, hid) with C/D in scan space;
// w_hid (4, hid, 2C); hc (4, B, H, W, 2C) with C/D transposed; an_bias,
// an_inv (2, C) for [AN1, AN2].  All fp32, contiguous, 16-byte aligned,
// H == W, hid a multiple of 4, kw 3.  A refused launch returns its
// error; there is no other kernel to fall back on.
extern "C" int macow_unit_inverse(const void* y, const void* w_shift,
                                  const void* w_hid, const void* hc,
                                  const void* an_bias, const void* an_inv,
                                  void* x, int B, int H, int W, int C, int hid,
                                  int kh, int kw, float alpha, void* stream) {
  const Dims d = make_dims(H, W, C, hid, kh, kw);
  Kernel kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = prepare(d, B, (cudaStream_t)stream, &kernel, &cfg, attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, kernel, (const float*)y, (const float*)w_shift,
                           (const float*)w_hid, (const float*)hc,
                           (const float*)an_bias, (const float*)an_inv, (float*)x,
                           B, d, alpha);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The kernel's shared memory per CTA in bytes at a shape it takes, else -1.
extern "C" int macow_unit_inverse_smem_bytes(int H, int W, int C, int hid, int kh,
                                             int kw) {
  const Dims d = make_dims(H, W, C, hid, kh, kw);
  return takes(d) ? (int)smem_bytes(d) : -1;
}

// How many of the kernel's clusters the card holds at once at a shape
// (cudaOccupancyMaxActiveClusters), or minus a cudaError_t.
extern "C" int macow_unit_inverse_max_clusters(int H, int W, int C, int hid, int kh,
                                               int kw) {
  const Dims d = make_dims(H, W, C, hid, kh, kw);
  Kernel kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = prepare(d, 1, nullptr, &kernel, &cfg, attr);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}
