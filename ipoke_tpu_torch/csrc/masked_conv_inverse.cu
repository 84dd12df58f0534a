// K5: the inverse of one affine masked-conv flow in one launch.
//
// Replaces ipoke_tpu/ops/masked_conv.py::masked_conv_inverse_pallas (body
// _inverse_kernel).  The inverse is a recurrence over H dependent rows in
// scan space (orders A/B as stored; C/D after the wrapper's H<->W transpose
// and kernel-axis swap).  Row r computes, per column w and hidden unit j,
//   hid[w][j] = elu(sum_{dy,dx,c} xp[dy][w+dx][c] * w_shift[dy][dx][c][j])
//   raw[w][k] = sum_j hid[w][j] * w_hid[j][k] + hc[r][w][k]        (k < 2C)
//   x[r][w][c] = (y[r][w][c] - raw[w][c]) / (tanh(raw[w][C+c]/2)*alpha + 1 + 1e-12)
// where xp[dy] is the rebuilt row r-kh+dy (order A, rows above) or r+1+dy
// (order B, rows below), zero outside the image, padded by cw = (kw-1)/2
// zero columns on each side.  hc = elu(h)·w_h + b (the conditioning half of
// the 1x1 out conv and its bias) is computed by the wrapper, as for K2: ELU
// is elementwise over the [conv, h] concat, so the h half separates
// exactly.  Everything is fp32, like the TPU kernel.
//
// Bound on the H100: latency.  The rows form a chain of H dependent steps,
// each only ~0.4 MFLOP per batch item at C=32, hid=128, W=8, so the cost is
// the chain, not FLOPs or bytes.
//
// Design: batch items are independent, so one CTA per item runs all H rows
// with only __syncthreads between them.  Unlike K2 (csrc/macow_unit_inverse.cu),
// which holds the whole latent on chip, shared memory holds the flow's
// weights (w_shift <= 2*3*32*128 floats = 98 KB, w_hid <= 128*64 floats), a
// ring of the last kh rebuilt rows, kh x (W+2cw) x C, and one row of
// hiddens, W x hid: it grows with W and not with H (~141 KB at W=16, ~152 KB
// at W=32 for C=32, hid=128), so tall and large latents fit.  Row r is kept
// in ring slot r mod kh and written straight to x in device memory.  The tap
// sums give each thread one hidden unit j and WPT columns, so a weight read
// from shared memory is reused WPT times.  A first, simple kernel: no
// tensor cores (the dots are kh*kw*C <= 192 deep), no TMA.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WPT = 4;  // columns per thread in the tap sums

__device__ __forceinline__ float elu(float v) { return v > 0.f ? v : expm1f(v); }

struct Dims {
  int H, W, C, hid, kh, kw, cw, Wp;
};

size_t smem_floats(const Dims& d) {
  return (size_t)d.kh * d.kw * d.C * d.hid  // w_shift
         + (size_t)d.hid * 2 * d.C          // w_hid
         + (size_t)d.kh * d.Wp * d.C        // ring of the last kh rows
         + (size_t)d.W * d.hid;             // hidden activations of a row
}

__global__ void __launch_bounds__(THREADS)
masked_conv_inverse_kernel(const float* __restrict__ y,
                           const float* __restrict__ w_shift,
                           const float* __restrict__ w_hid,
                           const float* __restrict__ hc,
                           float* __restrict__ x, Dims d, float alpha,
                           int reverse) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, b = blockIdx.x;
  const int H = d.H, W = d.W, C = d.C, hid = d.hid, kh = d.kh, kw = d.kw;
  const int Wp = d.Wp;
  const int n_ws = kh * kw * C * hid, n_wh = hid * 2 * C, n_ring = kh * Wp * C;
  float* ws = smem;
  float* wh = ws + n_ws;
  float* ring = wh + n_wh;
  float* hid_s = ring + n_ring;
  const size_t img = (size_t)H * W * C;
  const float* yb = y + (size_t)b * img;
  const float* hcb = hc + (size_t)b * img * 2;
  float* xb = x + (size_t)b * img;

  for (int i = tid; i < n_ws; i += blockDim.x) ws[i] = w_shift[i];
  for (int i = tid; i < n_wh; i += blockDim.x) wh[i] = w_hid[i];
  for (int i = tid; i < n_ring; i += blockDim.x) ring[i] = 0.f;
  __syncthreads();

  const int n_wg = (W + WPT - 1) / WPT;
  for (int i = 0; i < H; ++i) {
    const int row = reverse ? H - 1 - i : i;
    // hidden units: thread -> (j, group of WPT columns).  Tap row dy reads
    // rebuilt row row+1+dy (reverse) or row-kh+dy, kept in slot (that) mod kh.
    for (int idx = tid; idx < hid * n_wg; idx += blockDim.x) {
      const int j = idx % hid, w0 = (idx / hid) * WPT;
      float acc[WPT];
#pragma unroll
      for (int q = 0; q < WPT; ++q) acc[q] = 0.f;
      for (int dy = 0; dy < kh; ++dy) {
        const int slot = (reverse ? row + 1 + dy : row + dy) % kh;
        for (int dx = 0; dx < kw; ++dx) {
          const float* src = ring + (slot * Wp + w0 + dx) * C;
          const float* wt = ws + (dy * kw + dx) * C * hid + j;
          for (int c = 0; c < C; ++c) {
            const float wv = wt[c * hid];
#pragma unroll
            for (int q = 0; q < WPT; ++q)
              if (w0 + q < W) acc[q] += src[q * C + c] * wv;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < WPT; ++q)
        if (w0 + q < W) hid_s[(w0 + q) * hid + j] = elu(acc[q]);
    }
    __syncthreads();
    // affine inverse of the row: thread -> (w, c); the row replaces the
    // oldest one in the ring, which no later row reads
    float* dst = ring + ((row % kh) * Wp + d.cw) * C;
    for (int idx = tid; idx < W * C; idx += blockDim.x) {
      const int w = idx / C, c = idx % C;
      const float* hrow = hid_s + w * hid;
      float mu = 0.f, ls = 0.f;
      for (int j = 0; j < hid; ++j) {
        const float a = hrow[j];
        mu += a * wh[j * 2 * C + c];
        ls += a * wh[j * 2 * C + C + c];
      }
      const float* hcp = hcb + ((size_t)row * W + w) * 2 * C;
      mu += hcp[c];
      ls += hcp[C + c];
      const float scale = tanhf(ls * 0.5f) * alpha + 1.0f;
      const size_t at = (size_t)row * W * C + idx;
      const float v = (yb[at] - mu) / (scale + 1e-12f);
      dst[idx] = v;
      xb[at] = v;
    }
    __syncthreads();
  }
}

}  // namespace

// y, x (B, H, W, C) in scan space; w_shift (kh, kw, C, hid) in scan space;
// w_hid (hid, 2C); hc (B, H, W, 2C) in scan space.  All fp32, contiguous.
// reverse: order B (rows depend on the rows below), else order A.
extern "C" int masked_conv_inverse(const void* y, const void* w_shift,
                                   const void* w_hid, const void* hc, void* x,
                                   int B, int H, int W, int C, int hid, int kh,
                                   int kw, float alpha, int reverse,
                                   void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || hid <= 0 || kh <= 0 || kw <= 0
      || kw % 2 == 0)
    return (int)cudaErrorInvalidValue;
  const Dims d{H, W, C, hid, kh, kw, (kw - 1) / 2, W + 2 * ((kw - 1) / 2)};
  const size_t smem = smem_floats(d) * sizeof(float);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(masked_conv_inverse_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  masked_conv_inverse_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)y, (const float*)w_shift, (const float*)w_hid,
      (const float*)hc, (float*)x, d, alpha, reverse);
  return (int)cudaGetLastError();
}
