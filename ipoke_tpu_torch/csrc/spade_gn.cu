// K3: SPADE GroupNorm + modulation, a thread-block cluster per frame.
//
// Replaces ipoke_tpu/ops/spade_gn.py::spade_gn_modulate_pallas (body
// _spade_gn_kernel):
//   out = GroupNorm(x) * (1 + gamma) + beta
// x is (N, H, W, C) NHWC, one frame per n; gamma and beta are (BM, H, W, C)
// with BM | N, shared by the T = N / BM frames of a clip (frame n belongs to
// clip n / T).  Statistics are fp32 with the fast variance
// max(E[x^2] - E[x]^2, 0) and rsqrt(var + eps); the normalised value is
// rounded to the IO type, then (1 + gamma), the product and the sum with
// beta each round to it, as the plain version's ops do.
//
// Bound on the H100: bytes.  A reduction per (frame, group), then one
// elementwise pass: no tensor-core work.  The TPU kernel keeps a frame in
// VMEM and reads it from HBM once; a frame (2 MiB at 128 px x 64 ch in
// bf16) is far larger than one SM's shared memory.
//
// Design: a cluster of k CTAs per frame (the wrapper picks k by shape and
// dtype, ops/spade_gn.py::spade_gn_plan), each owning a contiguous 1/k of
// the frame's pixels, so its slice is one contiguous run of whole pixel
// rows.  The grid is persistent: as many clusters as the card holds at once
// (cudaOccupancyMaxActiveClusters), cluster c taking frames c, c + n, ...,
// so neighbouring clusters work on neighbouring frames and a clip's frames
// run together.  Per frame the CTA sums each channel of its slice in fp32
// in registers (16-byte accesses, neighbouring threads on neighbouring
// addresses), reduces them through shared memory in a fixed order, folds
// the channels into G group sums (sum x, sum x^2) and exchanges those 2G
// floats through distributed shared memory (one cluster barrier; two
// buffers by frame parity); every CTA adds the k partials in rank order, so
// the statistics are bitwise reproducible.  When the slice fits (RESIDENT:
// at most 128 KB, rows a multiple of 16 bytes; the wrapper's choice) it
// stays in shared memory as NCH chunks, each filled by one cp.async.bulk on
// its own mbarrier, and x crosses device memory once, as on the TPU; as
// soon as the normalise pass has read a chunk, the copy of the next frame's
// chunk starts, so the next frame's reads overlap this frame's writes.
// Otherwise (fp32 at 128 px, 256 KB slices, or narrow rows) the normalise
// pass reads x again, from L2 where it is still there, at two CTAs per SM.
// gamma and beta come from the frame's clip: where a clip's frames run at
// once, the cluster on its first frame prefetches the clip's slices into L2,
// and the output is stored with the streaming hint to leave them there.  Pixel rows that are not a
// multiple of 16 bytes go element by element (VEC = 1).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int MAX_CLUSTER = 16;           // non-portable beyond 8
constexpr int RESIDENT_BYTES = 128 * 1024;  // the largest slice kept on chip
constexpr int NCH = 4;                    // chunks of a kept slice, one bulk copy each

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// v rounded to the IO type and back
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// streaming (evict-first) scalar accesses; bf16 through its 16-bit pattern
__device__ __forceinline__ float ld_stream(const float* p) { return __ldcs(p); }
__device__ __forceinline__ __nv_bfloat16 ld_stream(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ void st_stream(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void st_stream(__nv_bfloat16* p, __nv_bfloat16 v) {
  __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(v));
}

// VEC elements of type T: one 16-byte access when VEC * sizeof(T) == 16
template <typename T, int VEC>
struct alignas(VEC * sizeof(T)) Pack {
  T v[VEC];
};
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    return *reinterpret_cast<const Pack<T, VEC>*>(&u);
  } else {
    return Pack<T, VEC>{{p[0]}};
  }
}
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_cs(const T* p) {  // read once: evict first
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
    return *reinterpret_cast<const Pack<T, VEC>*>(&u);
  } else {
    return Pack<T, VEC>{{ld_stream(p)}};
  }
}
template <typename T, int VEC>
__device__ __forceinline__ void store_cs(T* p, const Pack<T, VEC>& v) {
  if constexpr (VEC * sizeof(T) == 16)
    __stcs(reinterpret_cast<uint4*>(p), *reinterpret_cast<const uint4*>(&v));
  else
    st_stream(p, v.v[0]);
}

struct Shape {
  int N, HW, C, G, T;  // frames, pixels per frame, channels, groups, frames per clip
  int k;               // CTAs per frame (the cluster)
  int pix;             // pixels per CTA: ceil(HW / k)
  float eps;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
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
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Shared memory: 128 bytes of mbarriers and the slice (RESIDENT only), then
// fp32 per-(pixel lane, channel) sums of x and x^2, the channel sums, two
// buffers (by frame parity) of the group partials this CTA shows its
// cluster, and the frame's group statistics.
__host__ __device__ inline size_t slice_bytes(const Shape& s, size_t esize) {
  return ((size_t)s.pix * s.C * esize + 15) / 16 * 16;
}
template <typename T, int VEC>
size_t smem_bytes(const Shape& s, bool resident) {
  const int lanes = THREADS / (s.C / VEC);
  return (resident ? 128 + slice_bytes(s, sizeof(T)) : 0) +
         4 * ((size_t)2 * lanes * s.C + 2 * s.C + 6 * s.G);
}

// A persistent grid: cluster c normalises frames c, c + n_clusters, ...
// (neighbouring clusters on neighbouring frames, so a clip's frames run
// together).  RESIDENT: the slice is NCH chunks, each filled by one bulk
// copy on its own mbarrier; the copy of the next frame's chunk starts as
// soon as this frame's normalise pass has read the chunk, so the next
// frame's reads overlap this frame's writes.
template <typename T, int VEC, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, RESIDENT ? 1 : 2)
spade_gn_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                const T* __restrict__ beta, T* __restrict__ out, Shape s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_clusters = gridDim.x / s.k;
  const int tid = threadIdx.x;
  const int C = s.C, G = s.G, cpg = C / G;
  const int cvs = C / VEC;          // VEC-wide vectors per pixel row
  const int lanes = THREADS / cvs;  // pixel lanes
  const int cv = tid % cvs, lane = tid / cvs;
  const int p0 = rank * s.pix, npix = max(0, min(s.HW, p0 + s.pix) - p0);
  const int cpix = (npix + NCH - 1) / NCH;  // pixels per chunk

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  T* slice = reinterpret_cast<T*>(smem_raw + 128);
  float* red = reinterpret_cast<float*>(
      smem_raw + (RESIDENT ? 128 + slice_bytes(s, sizeof(T)) : 0));
  float* chan = red + 2 * lanes * C;  // sum x, then sum x^2, per channel
  float* parts = chan + 2 * C;        // per frame parity: [G] sum x, [G] sum x^2
  float* stat = parts + 4 * G;        // the frame's [G] mean, [G] rstd

  // thread 0 fills chunk i of frame f's slice (an empty chunk completes its
  // phase with no bytes)
  auto fetch = [&](int f, int i) {
    const int q0 = min(npix, i * cpix), q1 = min(npix, q0 + cpix);
    const uint32_t bytes = (uint32_t)((q1 - q0) * C * sizeof(T));
    const uint32_t bar = smem_u32(&bars[i]);
    mbar_expect_tx(bar, bytes);
    if (bytes)
      bulk_load(slice + (size_t)q0 * C, x + ((size_t)f * s.HW + p0 + q0) * C, bytes, bar);
  };
  const int first = blockIdx.x / s.k;
  if constexpr (RESIDENT) {
    if (tid == 0) {
      for (int i = 0; i < NCH; ++i) mbar_init(smem_u32(&bars[i]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int i = 0; i < NCH; ++i) fetch(first, i);
    }
    __syncthreads();
  }

  int it = 0;
  for (int f = first; f < s.N; f += n_clusters, ++it) {
    const T* xf = x + ((size_t)f * s.HW + p0) * C;  // this CTA's slice of frame f
    const T* gf = gamma + ((size_t)(f / s.T) * s.HW + p0) * C;
    const T* bf = beta + ((size_t)(f / s.T) * s.HW + p0) * C;
    T* of = out + ((size_t)f * s.HW + p0) * C;
    float* part = parts + (it & 1) * 2 * G;
    // where a clip's frames run at once (as many clusters as frames a clip),
    // the cluster on its first frame brings the clip's gamma and beta into
    // L2 for all of them; with fewer clusters the clip's frames run in turn
    // and find them in L2 from the frames before
    if constexpr (VEC * sizeof(T) == 16)
      if (tid == 0 && npix > 0 && f % s.T == 0 && n_clusters >= s.T) {
        const uint32_t bytes = (uint32_t)(npix * C * sizeof(T));
        asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
                     :: "l"(gf), "r"(bytes) : "memory");
        asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
                     :: "l"(bf), "r"(bytes) : "memory");
      }

    // pass 1: per-channel sums of this thread's vectors, chunk by chunk
    float s1[VEC], s2[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.f;
    for (int i = 0; i < NCH; ++i) {
      const int q0 = min(npix, i * cpix), q1 = min(npix, q0 + cpix);
      if constexpr (RESIDENT) mbar_wait(smem_u32(&bars[i]), it & 1);
      if (lane < lanes) {
#pragma unroll 4
        for (int q = q0 + lane; q < q1; q += lanes) {
          const size_t off = (size_t)q * C + cv * VEC;
          Pack<T, VEC> v;
          if constexpr (RESIDENT)
            v = *reinterpret_cast<const Pack<T, VEC>*>(slice + off);
          else
            v = load<T, VEC>(xf + off);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float a = to_f(v.v[j]);
            s1[j] += a;
            s2[j] = fmaf(a, a, s2[j]);
          }
        }
      }
    }
    if (lane < lanes) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        red[lane * C + cv * VEC + j] = s1[j];
        red[(lanes + lane) * C + cv * VEC + j] = s2[j];
      }
    }
    __syncthreads();
    // per channel over the pixel lanes, in a fixed order: first `n_parts`
    // ranges of lanes side by side, then the ranges
    const int n_parts = max(1, THREADS / (2 * C));
    const int per = (lanes + n_parts - 1) / n_parts;
    const int qc = tid % (2 * C), qp = tid / (2 * C);  // (moment*C + channel, range)
    float acc = 0.f;
    if (qp < n_parts) {
      const int m = qc / C, c = qc % C;
      for (int l = qp * per; l < min(lanes, (qp + 1) * per); ++l)
        acc += red[(m * lanes + l) * C + c];
    }
    __syncthreads();
    if (qp < n_parts) red[qp * 2 * C + qc] = acc;
    __syncthreads();
    for (int q = tid; q < 2 * C; q += THREADS) {
      float t = 0.f;
      for (int pp = 0; pp < n_parts; ++pp) t += red[pp * 2 * C + q];
      chan[q] = t;
    }
    __syncthreads();
    for (int q = tid; q < 2 * G; q += THREADS) {
      const float* src = chan + (q / G) * C + (q % G) * cpg;
      float t = 0.f;
      for (int c = 0; c < cpg; ++c) t += src[c];
      part[q] = t;
    }
    cluster.sync();  // every CTA's group sums of frame f are written
    if (tid < G) {
      float a = 0.f, b = 0.f;
      for (int r = 0; r < s.k; ++r) {  // rank order: the same sums on every CTA
        const float* pr = cluster.map_shared_rank(part, r);
        a += pr[tid];
        b += pr[G + tid];
      }
      const float cnt = (float)s.HW * (float)cpg;
      const float mean = a / cnt;
      const float var = fmaxf(b / cnt - mean * mean, 0.f);
      stat[tid] = mean;
      stat[G + tid] = rsqrtf(var + s.eps);
    }
    __syncthreads();

    // pass 2: normalise and modulate, each op rounding to the IO type; a
    // chunk read by every thread is refilled with the next frame's
    float mean[VEC], rstd[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int grp = (cv * VEC + j) / cpg;
      mean[j] = stat[grp];
      rstd[j] = stat[G + grp];
    }
    for (int i = 0; i < NCH; ++i) {
      const int q0 = min(npix, i * cpix), q1 = min(npix, q0 + cpix);
      if (lane < lanes) {
#pragma unroll 2
        for (int q = q0 + lane; q < q1; q += lanes) {
          const size_t off = (size_t)q * C + cv * VEC;
          Pack<T, VEC> v;
          if constexpr (RESIDENT)
            v = *reinterpret_cast<const Pack<T, VEC>*>(slice + off);
          else
            v = load_cs<T, VEC>(xf + off);
          const Pack<T, VEC> gv = load<T, VEC>(gf + off);
          const Pack<T, VEC> bv = load<T, VEC>(bf + off);
          Pack<T, VEC> o;
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float normed = rnd<T>((to_f(v.v[j]) - mean[j]) * rstd[j]);
            const float onep = rnd<T>(1.0f + to_f(gv.v[j]));
            const float prod = rnd<T>(normed * onep);
            o.v[j] = from_f<T>(prod + to_f(bv.v[j]));
          }
          store_cs<T, VEC>(of + off, o);
        }
      }
      if constexpr (RESIDENT) {
        __syncthreads();
        if (tid == 0 && f + n_clusters < s.N) {
          // the generic-proxy reads of the chunk come before the copy's writes
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          fetch(f + n_clusters, i);
        }
      }
    }
  }
  cluster.sync();  // no CTA leaves while a peer may read its partials
}

// The clusters the card holds at once for a kernel and launch shape
// (cudaOccupancyMaxActiveClusters), kept per (kernel, shared memory,
// cluster size, device).
template <typename K>
cudaError_t active_clusters(K* kernel, const cudaLaunchConfig_t& cfg, int k, int* n) {
  struct Entry {
    const void* fn;
    size_t smem;
    int k, dev, n;
  };
  static Entry cache[64];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.fn == (const void*)kernel && e.smem == cfg.dynamicSmemBytes && e.k == k &&
        e.dev == dev) {
      *n = e.n;
      return cudaSuccess;
    }
  }
  err = cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
  if (err == cudaSuccess && used < 64)
    cache[used++] = Entry{(const void*)kernel, cfg.dynamicSmemBytes, k, dev, *n};
  return err;
}

// Launch (max_clusters == nullptr) or report the clusters the card holds at
// once (*max_clusters).  The grid is min(N, that many) clusters.
template <typename T, int VEC, bool RESIDENT>
cudaError_t run_t(const void* x, const void* gamma, const void* beta, void* out,
                  const Shape& s, cudaStream_t stream, int* max_clusters) {
  auto kernel = spade_gn_kernel<T, VEC, RESIDENT>;
  const size_t smem = smem_bytes<T, VEC>(s, RESIDENT);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  if (s.k > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s.k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(s.k);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  err = active_clusters(kernel, cfg, s.k, &active);
  if (err != cudaSuccess) return err;
  if (max_clusters) {
    *max_clusters = active;
    return cudaSuccess;
  }
  if (active < 1) return cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3(min(s.N, active) * s.k);
  err = cudaLaunchKernelEx(&cfg, kernel, (const T*)x, (const T*)gamma, (const T*)beta,
                           (T*)out, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t run_io(const void* x, const void* gamma, const void* beta, void* out,
                   const Shape& s, bool resident, cudaStream_t stream,
                   int* max_clusters) {
  constexpr int V = 16 / sizeof(T);
  if ((s.C * sizeof(T)) % 16 == 0) {
    if (resident) return run_t<T, V, true>(x, gamma, beta, out, s, stream, max_clusters);
    return run_t<T, V, false>(x, gamma, beta, out, s, stream, max_clusters);
  }
  if (resident) return cudaErrorInvalidValue;  // bulk copies move 16-byte rows
  return run_t<T, 1, false>(x, gamma, beta, out, s, stream, max_clusters);
}

cudaError_t run(const void* x, const void* gamma, const void* beta, void* out, int n,
                int hw, int c, int groups, int t, float eps, int bf16, int cluster,
                int resident, cudaStream_t stream, int* max_clusters) {
  const size_t esize = bf16 ? 2 : 4;
  if (n <= 0 || hw <= 0 || c <= 0 || 2 * c > THREADS || groups <= 0 || c % groups ||
      t <= 0 || n % t || cluster < 1 || cluster > MAX_CLUSTER || cluster > hw)
    return cudaErrorInvalidValue;
  const Shape s{n, hw, c, groups, t, cluster, (hw + cluster - 1) / cluster, eps};
  if (resident && slice_bytes(s, esize) > RESIDENT_BYTES) return cudaErrorInvalidValue;
  return bf16 ? run_io<__nv_bfloat16>(x, gamma, beta, out, s, resident, stream,
                                      max_clusters)
              : run_io<float>(x, gamma, beta, out, s, resident, stream, max_clusters);
}

}  // namespace

// x, out (N, HW, C); gamma, beta (N / T, HW, C); fp32 (bf16 = 0) or bf16, all
// contiguous and 16-byte aligned.  cluster: CTAs per frame (1-16); resident:
// keep each CTA's slice in shared memory (at most 128 KB, rows of a
// multiple of 16 bytes).  A refused launch returns its error; there is no
// other kernel to fall back on.
extern "C" int spade_gn(const void* x, const void* gamma, const void* beta, void* out,
                        int n, int hw, int c, int groups, int t, float eps, int bf16,
                        int cluster, int resident, void* stream) {
  return (int)run(x, gamma, beta, out, n, hw, c, groups, t, eps, bf16, cluster,
                  resident, (cudaStream_t)stream, nullptr);
}

// How many of the kernel's clusters the card holds at once for that launch
// shape (cudaOccupancyMaxActiveClusters), or minus a cudaError_t.
extern "C" int spade_gn_max_clusters(int hw, int c, int groups, int bf16, int cluster,
                                     int resident) {
  int n = 0;
  const cudaError_t err = run(nullptr, nullptr, nullptr, nullptr, 1, hw, c, groups, 1,
                              1e-5f, bf16, cluster, resident, nullptr, &n);
  return err != cudaSuccess ? -(int)err : n;
}
