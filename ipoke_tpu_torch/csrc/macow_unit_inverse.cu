// K2: the inverse of one whole MaCowUnit in one launch.
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
// rows, 200 units per sampling pass, and each row is only ~0.4 MFLOP per
// batch item, so the cost is the chain of dependent steps, not FLOPs or
// bytes.  An unfused row scan pays several kernel launches per row.
//
// Design: batch items are independent, so one CTA per item (40 CTAs at the
// shipped batch) runs all four recurrences back to back with no launch in
// between.  Its activation buffer (H+kh) x (W+2cw) x C, the recurrence's
// input, and the current MCF's weights (w_shift <= 2*3*32*128 floats =
// 98 KB, w_hid <= 128*64 floats) live in shared memory; between rows only
// __syncthreads.  For the tap sums each thread owns one hidden unit j and
// WPT columns, so a weight read from shared memory is reused WPT times.
// A first, simple kernel: no tensor cores (the dots are 6*C <= 192 deep).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WPT = 4;  // columns per thread in the tap sums

__device__ __forceinline__ float elu(float v) { return v > 0.f ? v : expm1f(v); }

struct Dims {
  int H, W, C, hid, kh, kw, cw, Wp;
};

size_t smem_floats(const Dims& d) {
  return (size_t)d.kh * d.kw * d.C * d.hid   // w_shift of one MCF
         + (size_t)d.hid * 2 * d.C           // w_hid of one MCF
         + (size_t)(d.H + d.kh) * d.Wp * d.C // buf
         + (size_t)d.H * d.W * d.C           // cur: the recurrence's y side
         + (size_t)d.W * d.hid;              // hidden activations of a row
}

// One masked-conv recurrence in scan space.  Reads cur, leaves the result in
// buf rows [0, H) (reverse) or [kh, kh+H) (forward), columns [cw, cw+W).
__device__ void rowscan(const Dims& d, const float* cur, float* buf,
                        const float* ws, const float* wh, float* hid_s,
                        const float* __restrict__ hc, float alpha,
                        bool reverse) {
  const int tid = threadIdx.x;
  const int C = d.C, hid = d.hid, W = d.W, Wp = d.Wp;
  for (int i = tid; i < (d.H + d.kh) * Wp * C; i += blockDim.x) buf[i] = 0.f;
  __syncthreads();
  const int n_wg = (W + WPT - 1) / WPT;
  for (int i = 0; i < d.H; ++i) {
    const int row = reverse ? d.H - 1 - i : i;
    const int start = reverse ? row + 1 : row;
    // hidden units: thread -> (j, group of WPT columns)
    for (int idx = tid; idx < hid * n_wg; idx += blockDim.x) {
      const int j = idx % hid, w0 = (idx / hid) * WPT;
      float acc[WPT];
#pragma unroll
      for (int q = 0; q < WPT; ++q) acc[q] = 0.f;
      for (int dy = 0; dy < d.kh; ++dy) {
        for (int dx = 0; dx < d.kw; ++dx) {
          const float* src = buf + ((start + dy) * Wp + w0 + dx) * C;
          const float* wt = ws + (dy * d.kw + dx) * C * hid + j;
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
    // affine inverse of the row: thread -> (w, c)
    const int write_at = reverse ? row : row + d.kh;
    for (int idx = tid; idx < W * C; idx += blockDim.x) {
      const int w = idx / C, c = idx % C;
      const float* hrow = hid_s + w * hid;
      float mu = 0.f, ls = 0.f;
      for (int j = 0; j < hid; ++j) {
        const float a = hrow[j];
        mu += a * wh[j * 2 * C + c];
        ls += a * wh[j * 2 * C + C + c];
      }
      const float* hcp = hc + ((size_t)row * W + w) * 2 * C;
      mu += hcp[c];
      ls += hcp[C + c];
      const float scale = tanhf(ls * 0.5f) * alpha + 1.0f;
      buf[(write_at * Wp + d.cw + w) * C + c] =
          (cur[(row * W + w) * C + c] - mu) / (scale + 1e-12f);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
macow_unit_inverse_kernel(const float* __restrict__ y,
                          const float* __restrict__ w_shift,
                          const float* __restrict__ w_hid,
                          const float* __restrict__ hc,
                          const float* __restrict__ an_bias,
                          const float* __restrict__ an_inv,
                          float* __restrict__ x, int B, Dims d, float alpha) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, b = blockIdx.x;
  const int H = d.H, W = d.W, C = d.C;
  const int n_ws = d.kh * d.kw * C * d.hid, n_wh = d.hid * 2 * C;
  const int n_img = H * W * C;
  float* ws = smem;
  float* wh = ws + n_ws;
  float* buf = wh + n_wh;
  float* cur = buf + (H + d.kh) * d.Wp * C;
  float* hid_s = cur + n_img;
  const float* yb = y + (size_t)b * n_img;

  auto stage = [&](int m) {  // weights of MCF m (0..3 = A, B, C, D)
    for (int i = tid; i < n_ws; i += blockDim.x) ws[i] = w_shift[(size_t)m * n_ws + i];
    for (int i = tid; i < n_wh; i += blockDim.x) wh[i] = w_hid[(size_t)m * n_wh + i];
  };
  auto hc_of = [&](int m) { return hc + ((size_t)m * B + b) * H * W * 2 * C; };
  // buf cell of result row r, column w, channel c after a recurrence
  auto res = [&](bool reverse, int r, int w, int c) {
    return buf[((r + (reverse ? 0 : d.kh)) * d.Wp + d.cw + w) * C + c];
  };

  // AN2^-1, written transposed (scan space of D and C)
  for (int idx = tid; idx < n_img; idx += blockDim.x) {
    const int i = idx / (W * C), j = (idx / C) % W, c = idx % C;
    cur[(j * W + i) * C + c] = (yb[idx] - an_bias[C + c]) * an_inv[C + c];
  }
  stage(3);
  __syncthreads();
  rowscan(d, cur, buf, ws, wh, hid_s, hc_of(3), alpha, true);   // D
  for (int idx = tid; idx < n_img; idx += blockDim.x)
    cur[idx] = res(true, idx / (W * C), (idx / C) % W, idx % C);
  stage(2);
  __syncthreads();
  rowscan(d, cur, buf, ws, wh, hid_s, hc_of(2), alpha, false);  // C
  // back from transposed space, then AN1^-1
  for (int idx = tid; idx < n_img; idx += blockDim.x) {
    const int i = idx / (W * C), j = (idx / C) % W, c = idx % C;
    cur[idx] = (res(false, j, i, c) - an_bias[c]) * an_inv[c];
  }
  stage(1);
  __syncthreads();
  rowscan(d, cur, buf, ws, wh, hid_s, hc_of(1), alpha, true);   // B
  for (int idx = tid; idx < n_img; idx += blockDim.x)
    cur[idx] = res(true, idx / (W * C), (idx / C) % W, idx % C);
  stage(0);
  __syncthreads();
  rowscan(d, cur, buf, ws, wh, hid_s, hc_of(0), alpha, false);  // A
  float* xb = x + (size_t)b * n_img;
  for (int idx = tid; idx < n_img; idx += blockDim.x)
    xb[idx] = res(false, idx / (W * C), (idx / C) % W, idx % C);
}

}  // namespace

// y, x (B, H, W, C); w_shift (4, kh, kw, C, hid) with C/D in scan space;
// w_hid (4, hid, 2C); hc (4, B, H, W, 2C) with C/D transposed; an_bias,
// an_inv (2, C) for [AN1, AN2].  All fp32, contiguous, H == W.
extern "C" int macow_unit_inverse(const void* y, const void* w_shift,
                                  const void* w_hid, const void* hc,
                                  const void* an_bias, const void* an_inv,
                                  void* x, int B, int H, int W, int C, int hid,
                                  int kh, int kw, float alpha, void* stream) {
  if (B <= 0 || H <= 0 || H != W || C <= 0 || hid <= 0 || kh <= 0 || kw <= 0)
    return (int)cudaErrorInvalidValue;
  const Dims d{H, W, C, hid, kh, kw, (kw - 1) / 2, W + 2 * ((kw - 1) / 2)};
  const size_t smem = smem_floats(d) * sizeof(float);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(macow_unit_inverse_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  macow_unit_inverse_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)y, (const float*)w_shift, (const float*)w_hid,
      (const float*)hc, (const float*)an_bias, (const float*)an_inv, (float*)x,
      B, d, alpha);
  return (int)cudaGetLastError();
}
