// K5: the inverse of one affine masked-conv flow in one launch, a
// thread-block cluster per batch item.
//
// Replaces ipoke_tpu/ops/masked_conv.py::masked_conv_inverse_pallas (body
// _inverse_kernel).  The inverse is a recurrence over H dependent rows in
// scan space (orders A/B as stored; C/D after the wrapper's H<->W transpose
// and kernel-axis swap).  Row r computes, per column w and hidden unit j,
//   hid[w][j] = elu(sum_{dy,dx,c} xp[dy][w+dx][c] * w_shift[dy][dx][c][j])
//   raw[w][k] = sum_j hid[w][j] * w_hid[j][k] + hc[r][w][k]        (k < 2C)
//   x[r][w][c] = (y[r][w][c] - raw[w][c]) / (tanh(raw[w][C+c]/2)*alpha + 1 + 1e-12)
// where xp[dy] is the rebuilt row r-kh+dy (order A, rows above) or r+1+dy
// (order B, rows below), zero outside the image, padded by one zero column
// on each side (kw = 3).  hc = elu(h)·w_h + b (the conditioning half of the
// 1x1 out conv and its bias) is computed by the wrapper, as for K2: ELU is
// elementwise over the [conv, h] concat, so the h half separates exactly.
// Everything is fp32, like the TPU kernel.
//
// Bound on the H100: latency.  The rows form a chain of H dependent steps,
// each only ~0.4 MFLOP per batch item at C = 32, hid = 128, W = 8, so the
// cost is the chain, not FLOPs (5.0 us of fp32 work for a whole 8x16 flow at
// B = 40) or bytes.
//
// Design: K2's row design (csrc/macow_unit_inverse.cu) for one flow and any
// number of rows.
// - A cluster of k CTAs per batch item (k from the shape:
//   ops/masked_conv.py::k5_cluster, the fewest that hold the hidden units
//   at most 32 a CTA, else 8; 4 at hid = 128, so 160 CTAs at B = 40, two
//   per SM, one wave; wider clusters measured slower).  The cluster splits the
//   hidden units: a CTA computes hk = hid/k (rounded up to 4) of them for
//   every column of the row, and the partial (W, 2C) product of its
//   hiddens with its rows of w_hid.  The partials go through distributed
//   shared memory with one cluster barrier per row (a CTA barrier at
//   k = 1; two buffers, by row parity, so a CTA never overwrites a partial
//   a peer may still read).  Every CTA adds the k partials in rank order
//   and computes the whole row's affine inverse itself, so all k hold the
//   same rows, bit for bit, with no second exchange, and the result is
//   reproducible.
// - Weights: the CTA's slice of w_shift and w_hid arrives by cp.async.bulk
//   (one copy per tap row, issued by all threads), completing on an
//   mbarrier, while the CTA zeroes its ring; each lane then holds its tap
//   weights in registers for all H rows.
// - The tap dot: 8 lanes share one hidden unit, each owning NQ groups of
//   (dy, 4 channels) and all kw taps; a lane reads one float4 of 4 channels
//   per column of the window, and the 8 lanes' sums for 8 columns are
//   reduce-scattered with 7 shuffles, leaving each lane one column.
// - Wide flows (the instance NQ = 0): where a lane's groups exceed NQ_MAX
//   (Q = kh*ceil(C/4) > 16, C > 32 at kernel (2, 3)), where a CTA holds more
//   than 32 hidden units (hid > 256 at the portable cluster of 8) or where
//   2C exceeds the threads, the tap weights stay in shared memory and
//   stream through registers one group (12 weights) at a time, summed into
//   the same 8-column accumulators, so a hidden unit's dot runs over any
//   number of groups; the CTA's hidden units go in passes of 32, and the
//   out product loops over (2C x 4 columns) items.  A non-portable cluster
//   of 16 would halve the hidden units a CTA holds at hid 384 but also the
//   CTAs an SM holds; passes keep the portable cluster and one path for
//   every width.  The shapes it opens: a `reshape: down` MultiscaleStack's
//   4x4 blocks at C = 64-128 and hid 256-384, whose 2x3x128x32 weight slice
//   (96 KB) fits shared memory and not the registers.
// - Streamed flows (the third instance): where the CTA's weight slice, ring
//   and row buffers pass shared memory (2x2x512 at hid 512 needs 786 KB of
//   w_shift a CTA at a cluster of 8; 4x4x256 at hid 2048 12.6 MB a flow) or
//   a row holds more than AMAX * THREADS = 1024 elements, the tap weights
//   stay in device memory (12.6 MB at 4x4x256, hid 2048: they sit in the
//   50 MB L2) and are read once a row and column tile; the rebuilt rows
//   are read back from x itself; a row's hiddens go to a (B, W, hid)
//   scratch in device memory.  Where they fit (``staged``), the kh input
//   rows of a row and its whole hiddens are copied into shared memory once
//   a row, so the dots read them from there.
//   Per row: (1) each CTA computes its hk hidden units for every column,
//   a thread an (hidden unit, 8 columns) item with up to 8 threads
//   splitting its taps, their partials summed in a fixed order through
//   shared memory; (2) a cluster barrier; (3) each CTA computes a
//   contiguous 1/k of the row's W*C affine elements over all hid hidden
//   units, any number of elements, threads again splitting the dot; (4) a
//   cluster barrier.  Each value is one fixed-order sum, so the result is
//   reproducible.  Data written in the launch is read through L2
//   (ld.global.cg), past the SM's L1, and each barrier is preceded by a
//   fence, so a CTA reads what its peers wrote.  Only hid % 4 == 0 and kw
//   = 3 remain of the limits.
// - Shared memory grows with W and not with H: the weight slice, a ring of
//   the last kh rebuilt rows, kh x (W rounded up to 8, plus 2) x C, one row
//   of the CTA's hiddens and the two partial buffers (~48 KB a CTA at
//   W = 16, ~62 KB at W = 32 for C = 32, hid = 128, k = 4).  Row r lives in
//   ring slot r mod kh and is written straight to x (each CTA of the
//   cluster writes every k-th group of 32 elements), so tall latents fit.
// - The row's y and hc are loaded into registers at the row's start and
//   consumed by its affine, so their latency hides under the dot.
// - ELU as the TPU kernel computes it, exp(min(a, 0)) - 1, with __expf
//   (~2e-7 absolute); tanhf stays accurate (tanh.approx errs by ~5e-4, above
//   the 1e-4 parity).  No tensor cores: a row's product is only W columns
//   deep per item, and TF32 misses the fp32 parity.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_copy.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int SPLIT = 8;                 // lanes sharing one hidden unit's tap dot
constexpr int JSLOTS = THREADS / SPLIT;  // hidden units a CTA can hold: 32
constexpr int COLS = 8;                  // columns per pass of the tap dot
constexpr int AMAX = 4;                  // affine elements per thread: W*C <= AMAX*THREADS
constexpr int NQ_MAX = 2;                // tap groups per lane held in registers
constexpr int KW = 3;                    // kernel width in scan space, as configured: (2, 3)
constexpr int MAX_CLUSTER = 8;           // the portable cluster size

__device__ __forceinline__ float elu(float v) {
  return v > 0.f ? v : __expf(fminf(v, 0.f)) - 1.f;
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

struct Dims {
  int H, W, C, hid, kh, kw;
  int k;     // CTAs per batch item
  int Cp;    // C rounded up to 4: the ring holds float4 groups of channels
  int Wpad;  // ring columns: W rounded up to COLS, plus kw - 1
  int hk;    // hidden units per CTA, a multiple of 4 (16-byte bulk copies)
  int Q;     // tap groups (dy, 4 channels): kh * Cp / 4
};

Dims make_dims(int H, int W, int C, int hid, int kh, int kw, int k) {
  Dims d;
  d.H = H; d.W = W; d.C = C; d.hid = hid; d.kh = kh; d.kw = kw; d.k = k;
  d.Cp = round4(C);
  d.Wpad = (W + COLS - 1) / COLS * COLS + kw - 1;
  d.hk = k > 0 ? round4((hid + k - 1) / k) : 0;
  d.Q = kh * d.Cp / 4;
  return d;
}

// Shared memory, in floats after 16 bytes of mbarrier, each region on a
// 16-byte boundary: the weight slice (w_shift [kh*kw*C][hk], then w_hid
// [hk][2C]), the ring (kh, Wpad, Cp), one row of the CTA's hiddens
// (W, hk+4) and the row's partial products, two of (W, 2C).
// ipoke_tpu_torch/ops/masked_conv.py::k5_smem_bytes mirrors this.
__host__ __device__ __forceinline__ int slice_floats(const Dims& d) {
  return d.kh * KW * d.C * d.hk + d.hk * 2 * d.C;
}
__host__ __device__ __forceinline__ int ring_floats(const Dims& d) {
  return round4(d.kh * d.Wpad * d.Cp);
}
size_t smem_bytes(const Dims& d) {
  const int floats = slice_floats(d) + ring_floats(d) + round4(d.W * (d.hk + 4)) +
                     round4(2 * d.W * 2 * d.C);
  return 16 + 4 * (size_t)floats;
}

// NQ > 0: each lane's NQ tap groups in registers for all rows (Q <= NQ *
// SPLIT, hk <= JSLOTS); NQ = 0: the wide path, weights read from shared
// memory group by group, hidden units in passes of JSLOTS.
template <int NQ>
__global__ void __launch_bounds__(THREADS, 2)
masked_conv_inverse_kernel(const float* __restrict__ y,
                           const float* __restrict__ w_shift,
                           const float* __restrict__ w_hid,
                           const float* __restrict__ hc,
                           float* __restrict__ x, Dims d, float alpha,
                           int reverse) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / d.k;
  const int tid = threadIdx.x;
  const int s = tid & (SPLIT - 1);  // this lane's tap split
  const int jl0 = tid / SPLIT;      // its hidden unit in the CTA's slice (first pass)
  constexpr bool kWide = NQ == 0;
  const int H = d.H, W = d.W, C = d.C, Cp = d.Cp, Wpad = d.Wpad, hk = d.hk;
  const int kh = d.kh, C4 = Cp / 4, twoC = 2 * C, hs = hk + 4;
  const int taps = kh * KW * C;  // rows of w_shift
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  float* ws = reinterpret_cast<float*>(smem_raw + 16);  // [(dy*kw + dx)*C + c][hk]
  float* wh = ws + taps * hk;                           // [j][2C]
  float* ring = wh + hk * twoC;
  float* hid_s = ring + ring_floats(d);
  float* xpart = hid_s + round4(W * hs);
  const int j0 = rank * hk;
  const int nj = max(0, min(hk, d.hid - j0));  // this CTA's hidden units
  const size_t img = (size_t)H * W * C;
  const float* yb = y + (size_t)b * img;
  const float* hcb = hc + (size_t)b * img * 2;
  float* xb = x + (size_t)b * img;

  const uint32_t bb = smem_u32(bar);
  if (tid == 0) {
    mbar_init(bb, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bb, (uint32_t)(taps + twoC) * nj * 4);
  }
  __syncthreads();
  // the CTA's weight slice: for each of the kh*kw*C tap rows of w_shift its
  // nj hidden units (nj*4 bytes), one bulk copy a thread (from all warps:
  // ~4 us faster a launch than warp 0 alone), then its nj rows of w_hid.
  // Every address and size is a multiple of 16 bytes since hid and hk are
  // multiples of 4.
  if (nj > 0) {
    for (int r = tid; r < taps; r += THREADS)
      bulk_load(ws + r * hk, w_shift + (size_t)r * d.hid + j0, nj * 4, bb);
    if (tid == THREADS - 1)
      bulk_load(wh, w_hid + (size_t)j0 * twoC, nj * twoC * 4, bb);
  }
  // the ring starts as the zero rows outside the image; its pad columns
  // stay zero throughout
  for (int i = tid; i < ring_floats(d); i += THREADS) ring[i] = 0.f;
  mbar_wait(bb, 0);

  // the lane's tap weights for all H rows: wr[q][cc][dx] of hidden unit jl
  // at tap group qq = s + q*SPLIT, i.e. row dy and channel 4*c4 + cc; zero
  // past C, past the CTA's hidden units and past the last group
  float wr[kWide ? 1 : NQ][4][KW];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int qq = s + q * SPLIT, dy = qq / C4, c4 = qq % C4;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int c = 4 * c4 + cc;
#pragma unroll
      for (int dx = 0; dx < KW; ++dx)
        wr[q][cc][dx] = (qq < d.Q && c < C && jl0 < nj)
                            ? ws[((dy * KW + dx) * C + c) * hk + jl0] : 0.f;
    }
  }
  __syncthreads();  // the ring is zeroed

  const int n_aff = W * C;
  const int wstep = THREADS / twoC;  // columns apart in the out product
  const int k_out = tid % twoC, w_out = tid / twoC;
  for (int i = 0; i < H; ++i) {
    const int row = reverse ? H - 1 - i : i;
    // this row's y and conditioning term, in flight during the dot
    float yv[AMAX], hmu[AMAX], hls[AMAX];
#pragma unroll
    for (int a = 0; a < AMAX; ++a) {
      const int idx = tid + a * THREADS;
      yv[a] = hmu[a] = hls[a] = 0.f;
      if (idx < n_aff) {
        const float* p = hcb + ((size_t)row * W + idx / C) * twoC + idx % C;
        yv[a] = __ldg(yb + (size_t)row * n_aff + idx);
        hmu[a] = __ldg(p);
        hls[a] = __ldg(p + C);
      }
    }

    // hidden units: lane s of each group of 8 sums its tap groups for 8
    // columns, then the group reduce-scatters so that lane s holds column
    // s.  Tap row dy reads rebuilt row row+1+dy (reverse) or row-kh+dy,
    // kept in ring slot (row+1+dy) mod kh or (row+dy) mod kh.  One pass of
    // JSLOTS hidden units, more on the wide path.
    for (int jb = 0; jb < (kWide ? hk : 1); jb += JSLOTS) {
    const int jl = jl0 + jb;
    for (int w0 = 0; w0 < W; w0 += COLS) {
      float acc[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[c] = 0.f;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int qq = s + q * SPLIT;
        if (qq < d.Q) {
          const int dy = qq / C4;
          const int slot = (reverse ? row + 1 + dy : row + dy) % kh;
          const float* src = ring + (slot * Wpad + w0) * Cp + 4 * (qq % C4);
#pragma unroll
          for (int col = 0; col < COLS + KW - 1; ++col) {
            const float4 v = *reinterpret_cast<const float4*>(src + col * Cp);
#pragma unroll
            for (int dx = 0; dx < KW; ++dx) {
              const int c = col - dx;
              if (c >= 0 && c < COLS) {
                acc[c] = fmaf(v.x, wr[q][0][dx], acc[c]);
                acc[c] = fmaf(v.y, wr[q][1][dx], acc[c]);
                acc[c] = fmaf(v.z, wr[q][2][dx], acc[c]);
                acc[c] = fmaf(v.w, wr[q][3][dx], acc[c]);
              }
            }
          }
        }
      }
      if constexpr (kWide) {
        // the wide path: each group's 12 weights from shared memory
        for (int qq = s; qq < d.Q && jl < nj; qq += SPLIT) {
          const int dy = qq / C4, c4 = qq % C4;
          float wq[4][KW];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int c = 4 * c4 + cc;
#pragma unroll
            for (int dx = 0; dx < KW; ++dx)
              wq[cc][dx] = c < C ? ws[((dy * KW + dx) * C + c) * hk + jl] : 0.f;
          }
          const int slot = (reverse ? row + 1 + dy : row + dy) % kh;
          const float* src = ring + (slot * Wpad + w0) * Cp + 4 * c4;
#pragma unroll
          for (int col = 0; col < COLS + KW - 1; ++col) {
            const float4 v = *reinterpret_cast<const float4*>(src + col * Cp);
#pragma unroll
            for (int dx = 0; dx < KW; ++dx) {
              const int c = col - dx;
              if (c >= 0 && c < COLS) {
                acc[c] = fmaf(v.x, wq[0][dx], acc[c]);
                acc[c] = fmaf(v.y, wq[1][dx], acc[c]);
                acc[c] = fmaf(v.z, wq[2][dx], acc[c]);
                acc[c] = fmaf(v.w, wq[3][dx], acc[c]);
              }
            }
          }
        }
      }
      const bool b4 = s & 4, b2 = s & 2, b1 = s & 1;
      float r4[4], r2[2];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        r4[c] = (b4 ? acc[c + 4] : acc[c]) +
                __shfl_xor_sync(0xffffffffu, b4 ? acc[c] : acc[c + 4], 4);
#pragma unroll
      for (int c = 0; c < 2; ++c)
        r2[c] = (b2 ? r4[c + 2] : r4[c]) +
                __shfl_xor_sync(0xffffffffu, b2 ? r4[c] : r4[c + 2], 2);
      const float sum = (b1 ? r2[1] : r2[0]) +
                        __shfl_xor_sync(0xffffffffu, b1 ? r2[0] : r2[1], 1);
      const int w = w0 + s;
      if (w < W && jl < nj) hid_s[w * hs + jl] = elu(sum);
    }
    }
    __syncthreads();

    // the CTA's partial of the 1x1 out product: thread (k, columns w_out,
    // w_out + wstep, ...), the w_hid element shared by its columns
    float* xp = xpart + (i & 1) * W * twoC;
    if (kWide) {
      // item e: output k of columns 4g .. 4g+3
      for (int e = tid; e < twoC * ((W + 3) / 4); e += THREADS) {
        const int kk = e % twoC, wb = 4 * (e / twoC);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int j = 0; j < nj; j += 4) {
          float wv[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) wv[t] = wh[(j + t) * twoC + kk];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (wb + u < W) {
              const float4 hv = *reinterpret_cast<const float4*>(hid_s + (wb + u) * hs + j);
              acc[u] = fmaf(hv.x, wv[0], acc[u]);
              acc[u] = fmaf(hv.y, wv[1], acc[u]);
              acc[u] = fmaf(hv.z, wv[2], acc[u]);
              acc[u] = fmaf(hv.w, wv[3], acc[u]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (wb + u < W) xp[(wb + u) * twoC + kk] = acc[u];
      }
    } else if (w_out < wstep) {
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
    // every CTA's partial of this row is written (a cluster barrier costs
    // ~0.45 us a row even for one CTA, a CTA barrier far less)
    if (d.k > 1) cluster.sync(); else __syncthreads();

    // affine inverse of the row, the partials added in rank order; the row
    // replaces the oldest one in the ring, which no later row reads
    float* dst = ring + ((row % kh) * Wpad + 1) * Cp;
    float* xr = xb + (size_t)row * n_aff;
#pragma unroll
    for (int a = 0; a < AMAX; ++a) {
      const int idx = tid + a * THREADS;
      if (idx < n_aff) {
        const int w = idx / C, c = idx % C;
        float mu = 0.f, ls = 0.f;
        for (int r = 0; r < d.k; ++r) {
          const float* pr = (r == rank ? xp : cluster.map_shared_rank(xp, r)) + w * twoC;
          mu += pr[c];
          ls += pr[C + c];
        }
        mu += hmu[a];
        ls += hls[a];
        const float scale = tanhf(ls * 0.5f) * alpha + 1.0f;
        const float v = (yv[a] - mu) / (scale + 1e-12f);
        dst[w * Cp + c] = v;
        if ((idx >> 5) % d.k == rank) xr[idx] = v;
      }
    }
    __syncthreads();
  }
  if (d.k > 1) cluster.sync();  // no CTA leaves while a peer may read its partials
}

// The streamed instance: tap weights and w_hid read from device memory,
// the rebuilt rows from x, the row's hiddens through hbuf (B, W, hid).
// Shared memory: a reduction buffer of THREADS * COLS floats
// (STREAMED_SMEM bytes) and, where the card's shared memory holds them
// (``staged``), the row's input window (kh rows of W + 2 columns, zero
// outside the image) and the row's whole hiddens (W, hid), each read
// from device memory once a row instead of once per use.
constexpr int PMAX = 8;  // threads splitting one item's dot
constexpr size_t STREAMED_SMEM = sizeof(float) * THREADS * COLS;

__host__ __device__ __forceinline__ int window_floats(const Dims& d) {
  return round4(d.kh * (d.W + 2) * d.C);
}
size_t staged_smem_bytes(const Dims& d) {
  return STREAMED_SMEM + sizeof(float) * ((size_t)window_floats(d) + (size_t)d.W * d.hid);
}

// Threads splitting each of n items' dots: the most, a power of 2 up to
// PMAX, that still give every item a thread and keep a warp's lanes on
// distinct items (so their weight reads coalesce).
__device__ __forceinline__ int parts_for(int n) {
  int p = 1;
  while (2 * p <= PMAX && THREADS / (2 * p) >= max(32, n)) p *= 2;
  return p;
}

__device__ __forceinline__ void sync_all(cg::cluster_group& cluster, int k) {
  __threadfence();  // global writes of this CTA before its peers' reads
  if (k > 1) cluster.sync(); else __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
masked_conv_inverse_streamed(const float* __restrict__ y,
                             const float* __restrict__ w_shift,
                             const float* __restrict__ w_hid,
                             const float* __restrict__ hc, float* x,
                             float* hbuf, Dims d, float alpha, int reverse,
                             int staged) {
  extern __shared__ __align__(16) float red[];  // [part][item][COLS]
  float* win = red + THREADS * COLS;            // [dy][W + 2][C], staged only
  float* hrow = win + window_floats(d);         // [W][hid], staged only
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / d.k;
  const int tid = threadIdx.x;
  const int H = d.H, W = d.W, C = d.C, hid = d.hid, kh = d.kh, twoC = 2 * C;
  const int j0 = rank * d.hk;
  const int nj = max(0, min(d.hk, hid - j0));  // this CTA's hidden units
  const int tiles = (W + COLS - 1) / COLS;
  const int items = nj * tiles;                 // (hidden unit, column tile)
  const int P = parts_for(items), IP = THREADS / P;
  const int row_taps = KW * C;                  // taps of one tap row dy
  const size_t img = (size_t)H * W * C;
  const float* yb = y + (size_t)b * img;
  const float* hcb = hc + (size_t)b * img * 2;
  float* xb = x + (size_t)b * img;
  float* hb = hbuf + (size_t)b * W * hid;
  const int n_aff = W * C;
  const int per = (n_aff + d.k - 1) / d.k;      // affine elements a CTA
  const int e_lo = min(n_aff, rank * per), e_n = min(n_aff, e_lo + per) - e_lo;
  const int P2 = parts_for(e_n), IP2 = THREADS / P2;
  const int wrow = (W + 2) * C;                 // a window row, padded

  for (int i = 0; i < H; ++i) {
    const int row = reverse ? H - 1 - i : i;
    if (staged) {  // the kh rows this row reads, zero outside the image
      for (int t = tid; t < kh * wrow; t += THREADS) {
        const int dy = t / wrow, w = (t - dy * wrow) / C - 1, c = t % C;
        const int src = reverse ? row + 1 + dy : row - kh + dy;
        win[t] = (src >= 0 && src < H && w >= 0 && w < W)
                     ? __ldcg(xb + (size_t)src * n_aff + w * C + c) : 0.f;
      }
      __syncthreads();
    }
    // (1) the CTA's hidden units of this row
    for (int e0 = 0; e0 < items; e0 += IP) {
      const int e = e0 + tid % IP, p = tid / IP;
      const bool live = e < items;
      const int j = live ? e % nj : 0, w0 = live ? e / nj * COLS : 0;
      float acc[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[c] = 0.f;
      for (int dy = 0; live && dy < kh; ++dy) {
        const int src = reverse ? row + 1 + dy : row - kh + dy;
        if (src < 0 || src >= H) continue;  // the zero rows outside the image
        const float* xs = xb + (size_t)src * n_aff;
        const float* ws = w_shift + (size_t)dy * row_taps * hid + j0 + j;
        const float* wn = win + dy * wrow;
        for (int t = p; t < row_taps; t += P) {
          const int dx = t / C, c = t - dx * C;
          const float wv = __ldg(ws + (size_t)t * hid);
          if (staged) {
#pragma unroll
            for (int col = 0; col < COLS; ++col)
              if (w0 + col < W) acc[col] = fmaf(wn[(w0 + col + dx) * C + c], wv, acc[col]);
          } else {
#pragma unroll
            for (int col = 0; col < COLS; ++col) {
              const int w = w0 + col + dx - 1;
              if (w >= 0 && w < W && w0 + col < W)
                acc[col] = fmaf(__ldcg(xs + w * C + c), wv, acc[col]);
            }
          }
        }
      }
      if (P > 1) {
#pragma unroll
        for (int c = 0; c < COLS; ++c) red[(p * IP + tid % IP) * COLS + c] = acc[c];
        __syncthreads();
        if (p == 0) {
          for (int q = 1; q < P; ++q)
#pragma unroll
            for (int c = 0; c < COLS; ++c) acc[c] += red[(q * IP + tid) * COLS + c];
        }
        __syncthreads();
      }
      if (p == 0 && live) {
#pragma unroll
        for (int col = 0; col < COLS; ++col)
          if (w0 + col < W) hb[(size_t)(w0 + col) * hid + j0 + j] = elu(acc[col]);
      }
    }
    sync_all(cluster, d.k);  // every hidden unit of the row is written
    if (staged) {
      for (int t = tid; t < W * hid; t += THREADS) hrow[t] = __ldcg(hb + t);
      __syncthreads();
    }
    const float* hsrc = staged ? hrow : hb;

    // (3) the CTA's share of the row's affine inverse over all hid units
    for (int e0 = 0; e0 < e_n; e0 += IP2) {
      const int e = e0 + tid % IP2, p = tid / IP2;
      const bool live = e < e_n;
      const int idx = e_lo + (live ? e : 0), w = idx / C, c = idx - w * C;
      float mu = 0.f, ls = 0.f;
      if (live) {
        const float* hw = hsrc + (size_t)w * hid;
        for (int j = p; j < hid; j += P2) {
          const float hv = staged ? hw[j] : __ldcg(hw + j);
          mu = fmaf(hv, __ldg(w_hid + (size_t)j * twoC + c), mu);
          ls = fmaf(hv, __ldg(w_hid + (size_t)j * twoC + C + c), ls);
        }
      }
      if (P2 > 1) {
        red[2 * (p * IP2 + tid % IP2)] = mu;
        red[2 * (p * IP2 + tid % IP2) + 1] = ls;
        __syncthreads();
        if (p == 0) {
          for (int q = 1; q < P2; ++q) {
            mu += red[2 * (q * IP2 + tid)];
            ls += red[2 * (q * IP2 + tid) + 1];
          }
        }
        __syncthreads();
      }
      if (p == 0 && live) {
        const float* hp = hcb + ((size_t)row * W + w) * twoC + c;
        mu += __ldg(hp);
        ls += __ldg(hp + C);
        const float scale = tanhf(ls * 0.5f) * alpha + 1.0f;
        xb[(size_t)row * n_aff + idx] =
            (__ldg(yb + (size_t)row * n_aff + idx) - mu) / (scale + 1e-12f);
      }
    }
    sync_all(cluster, d.k);  // the row is in x before the next row reads it
  }
}

// The shapes the kernel takes (ops/masked_conv.py::k5_fits mirrors it).
bool takes(const Dims& d) {
  return d.H > 0 && d.W > 0 && d.C > 0 && d.hid > 0 && d.hid % 4 == 0 &&
         d.kh > 0 && d.kw == KW && d.k >= 1 && d.k <= MAX_CLUSTER;
}

// Whether the shared-memory instances (NQ = 0, 1, 2) hold the flow: a row
// of at most AMAX * THREADS elements and their footprint within what a
// block may opt into; else the streamed instance
// (ops/masked_conv.py::k5_streamed mirrors it).
bool in_smem(const Dims& d, int max_smem) {
  return d.W * d.C <= AMAX * THREADS && smem_bytes(d) <= (size_t)max_smem;
}

// Whether a lane's tap weights stay in registers (the instances NQ = 1, 2);
// else the wide path (ops/masked_conv.py::k5_registers mirrors it).
bool in_registers(const Dims& d) {
  return d.Q <= NQ_MAX * SPLIT && d.hk <= JSLOTS && 2 * d.C <= THREADS;
}

using Kernel = void (*)(const float*, const float*, const float*, const float*,
                        float*, Dims, float, int);
using Streamed = void (*)(const float*, const float*, const float*, const float*,
                          float*, float*, Dims, float, int, int);

struct Plan {
  Kernel kernel = nullptr;      // a shared-memory instance, or
  Streamed streamed = nullptr;  // the streamed one,
  int staged = 0;               // with its window and hiddens staged
  size_t smem = 0;
};

// The instance for d (its tap groups where shared memory holds the flow,
// else the streamed one), its shared memory opted into, and a launch of a
// cluster of d.k CTAs per item for B items.
cudaError_t prepare(const Dims& d, int B, cudaStream_t stream, Plan* plan,
                    cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  if (B <= 0 || !takes(d)) return cudaErrorInvalidValue;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  *plan = Plan{};
  const void* fn;
  if (in_smem(d, max_smem)) {
    plan->smem = smem_bytes(d);
    plan->kernel = !in_registers(d) ? masked_conv_inverse_kernel<0>
                   : d.Q <= SPLIT   ? masked_conv_inverse_kernel<1>
                                    : masked_conv_inverse_kernel<2>;
    fn = (const void*)plan->kernel;
  } else {
    plan->staged = staged_smem_bytes(d) <= (size_t)max_smem;
    plan->smem = plan->staged ? staged_smem_bytes(d) : STREAMED_SMEM;
    plan->streamed = masked_conv_inverse_streamed;
    fn = (const void*)plan->streamed;
  }
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)plan->smem);
  if (err != cudaSuccess) return err;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = d.k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(B * d.k);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = plan->smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// y, x (B, H, W, C) in scan space; w_shift (kh, kw, C, hid) in scan space;
// w_hid (hid, 2C); hc (B, H, W, 2C) in scan space; scratch (B, W, hid), used
// by the streamed instance only (may be null where shared memory holds the
// flow: masked_conv_inverse_streamed_at says which).  All fp32, contiguous,
// 16-byte aligned; hid a multiple of 4, kw 3.  reverse: order B (rows
// depend on the rows below), else order A.  cluster: CTAs per batch item.
// A refused launch returns its error; there is no other kernel to fall
// back on.
extern "C" int masked_conv_inverse(const void* y, const void* w_shift,
                                   const void* w_hid, const void* hc, void* x,
                                   void* scratch, int B, int H, int W, int C,
                                   int hid, int kh, int kw, float alpha,
                                   int reverse, int cluster, void* stream) {
  const Dims d = make_dims(H, W, C, hid, kh, kw, cluster);
  Plan plan;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = prepare(d, B, (cudaStream_t)stream, &plan, &cfg, attr);
  if (err != cudaSuccess) return (int)err;
  if (plan.streamed) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    err = cudaLaunchKernelEx(&cfg, plan.streamed, (const float*)y,
                             (const float*)w_shift, (const float*)w_hid,
                             (const float*)hc, (float*)x, (float*)scratch, d,
                             alpha, reverse, plan.staged);
  } else {
    err = cudaLaunchKernelEx(&cfg, plan.kernel, (const float*)y,
                             (const float*)w_shift, (const float*)w_hid,
                             (const float*)hc, (float*)x, d, alpha, reverse);
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// 1 where the launch at this shape takes the streamed instance (and needs
// the scratch), 0 where a shared-memory instance holds it, -1 where the
// kernel does not take the shape.
extern "C" int masked_conv_inverse_streamed_at(int W, int C, int hid, int kh, int kw,
                                               int cluster) {
  const Dims d = make_dims(1, W, C, hid, kh, kw, cluster);
  int dev = 0, max_smem = 0;
  if (!takes(d) || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return -1;
  return in_smem(d, max_smem) ? 0 : 1;
}

// The chosen instance's shared memory per CTA in bytes at a shape it takes
// (any number of rows), else -1.
extern "C" int masked_conv_inverse_smem_bytes(int W, int C, int hid, int kh, int kw,
                                              int cluster) {
  const Dims d = make_dims(1, W, C, hid, kh, kw, cluster);
  Plan plan;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  return prepare(d, 1, nullptr, &plan, &cfg, attr) == cudaSuccess ? (int)plan.smem : -1;
}

// How many of the kernel's clusters the card holds at once at a shape
// (cudaOccupancyMaxActiveClusters), or minus a cudaError_t.
extern "C" int masked_conv_inverse_max_clusters(int W, int C, int hid, int kh, int kw,
                                                int cluster) {
  const Dims d = make_dims(1, W, C, hid, kh, kw, cluster);
  Plan plan;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = prepare(d, 1, nullptr, &plan, &cfg, attr);
  int n = 0;
  if (err == cudaSuccess)
    err = plan.streamed
              ? cudaOccupancyMaxActiveClusters(&n, (const void*)plan.streamed, &cfg)
              : cudaOccupancyMaxActiveClusters(&n, (const void*)plan.kernel, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}
