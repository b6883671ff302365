// xtile_parts: the natural-store x-stage of csrc/xtile.cuh cut short
// after each of its steps, strict and fast, for timing the parts of
// kx_visc.cu's kx_fwd (two float planes in and out) and xstage.cu
// (complex64 in and out) on the card: there is no profiler of the
// kernels' insides there, so a part's cost is the difference of two cuts.
//
// Replaces no TPU kernel and runs on no model path: chip_smoke.py's
// phase 5v launches it (xfb_xtile_parts) beside the two kernels. Each cut
// is the kernel's own code up to its step (the same load, the same
// xtile.cuh passes, the same combine), then keeps what it computed alive
// by a store that never fires (a comparison with NaN):
//   stop 0: the loads (cp.async, then the wait and the block barrier);
//   stop 1: + the first pass of the sub-DFT;
//   stop 2: + the whole sub-DFT (subdft's passes, in its order);
//   stop 3: + the cluster exchange and the K-point step (combine), no
//           store;
//   stop 4: all of it, with the natural store (finish).
// The transposed store (finish_transposed) has its own cuts
// (xfb_xtile_tparts), of kc_kernel's form (two (n, cols) float planes in,
// the half store k <= n/2 to (cols, n/2 + 1) planes) and ka_kernel's
// real forward (one float plane in, the full store to (cols, n) planes):
//   stop 0: the loads (as above);
//   stop 1: + the whole sub-DFT;
//   stop 2: + the cluster exchange and the K-point step, the outputs held
//           in registers;
//   stop 3: + the staging of the outputs in the tile (combine_staged);
//   stop 4: all of it, with the transposed store (finish_transposed).
#include "xtile.cuh"

namespace {

namespace xt = xfb::xtile;

// The first `count` passes of subdft<-1, FAST>, in its order.
template <bool FAST>
__device__ __forceinline__ void passes(const xt::Tile& t, int count) {
  if constexpr (FAST) {
    const xt::Dft16 a = xt::dft16();
    if (t.m >= 256) {
      xt::pass16_first<-1>(t, a, true);
      if (count < 2) return;
      if (t.m == 512) {
        xt::pass16_second<-1, true>(t, a);
      } else {
        xt::pass16_second<-1, false>(t, a);
        if (t.m == 1024 && count > 2) xt::pass<4, -1>(t, 256);
      }
    } else {
      xt::pass16_first<-1>(t, a, false);
      if (count < 2) return;
      if (t.m == 128) {
        xt::pass<8, -1>(t, 16);
      } else {
        xt::pass<4, -1>(t, 16);
      }
    }
  } else {
    int done = 0;
    for (int p = 1; p < t.m && done < count; ++done) {
      const int r = t.m / p >= 8 ? 8 : t.m / p;
      if (r == 8) {
        xt::pass<8, -1>(t, p);
      } else if (r == 4) {
        xt::pass<4, -1>(t, p);
      } else {
        xt::pass<2, -1>(t, p);
      }
      p *= r;
    }
  }
}

// Keeps a value alive: a store that never fires (sentinel is NaN).
struct Sink {
  float* y;
  float sentinel;
  __device__ __forceinline__ void operator()(int, int, float2 v) const {
    if (v.x == sentinel) y[0] = v.y;
  }
};

// The natural store of kx_fwd (CPLX false: planes yr, yi) or of xstage at
// one shard (CPLX true: complex64 y), rows of hny columns.
template <bool CPLX>
struct Store {
  float* yr;
  float* yi;
  int j0, hny;
  __device__ __forceinline__ void operator()(int i, int c, float2 v) const {
    const int j = j0 + c;
    if (j >= hny) return;
    const size_t off = static_cast<size_t>(i) * hny + j;
    if constexpr (CPLX) {
      reinterpret_cast<float2*>(yr)[off] = v;
    } else {
      yr[off] = v.x;
      yi[off] = v.y;
    }
  }
};

template <bool FAST, bool CPLX, int STOP>
__global__ void __launch_bounds__(512, 2)
    parts_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 float* yr, float* yi, const float2* __restrict__ tw, int n,
                 int hny, int k, int logc, float sentinel) {
  extern __shared__ float2 smem[];
  const xt::Tile t = xt::begin(smem, tw, n, k, logc);
  const int j0 = (blockIdx.x / k) << logc;
  const int cmask = (1 << logc) - 1;
  // kx_visc_kernel's and xstage_kernel's load: rows rank + k * jj,
  // consecutive lanes on consecutive columns
#pragma unroll
  for (int b = 0; b < xt::kElems; ++b) {
    const int u = b * blockDim.x + threadIdx.x;
    const int j = j0 + (u & cmask);
    float2* d = t.s + u;
    if (j < hny) {
      const size_t off =
          static_cast<size_t>(t.rank + k * (u >> logc)) * hny + j;
      if constexpr (CPLX) {
        xt::cp_async8(d, reinterpret_cast<const float2*>(xr) + off);
      } else {
        xt::cp_async4(&d->x, xr + off);
        xt::cp_async4(&d->y, xi + off);
      }
    } else {
      *d = make_float2(0.f, 0.f);
    }
  }
  xt::cp_async_wait_all();
  __syncthreads();
  if constexpr (STOP <= 2) {
    if (STOP > 0) passes<FAST>(t, STOP == 1 ? 1 : 99);
    const float2 v = t.s[threadIdx.x];
    if (v.x == sentinel) yr[0] = v.y;
  } else if constexpr (STOP == 3) {
    passes<FAST>(t, 99);
    Sink out{yr, sentinel};
    switch (t.k) {
      case 1:
        xt::combine<1, -1, FAST>(t, tw, out);
        break;
      case 2:
        xt::combine<2, -1, FAST>(t, tw, out);
        break;
      case 4:
        xt::combine<4, -1, FAST>(t, tw, out);
        break;
      default:
        xt::combine<8, -1, FAST>(t, tw, out);
        break;
    }
  } else {
    Store<CPLX> out{yr, yi, j0, hny};
    xt::finish<-1, FAST>(t, tw, out);
  }
}

template <bool FAST, bool CPLX, int STOP>
int run(const float* xr, const float* xi, float* yr, float* yi,
        const void* tw, int n, int hny, int tile_c, int cluster_k,
        int threads, int smem, int device, void* stream) {
  const int tiles = (hny + tile_c - 1) / tile_c;
  return static_cast<int>(xt::launch(
      parts_kernel<FAST, CPLX, STOP>, tiles, 1, cluster_k, threads, smem,
      device, static_cast<cudaStream_t>(stream), xr, xi, yr, yi,
      static_cast<const float2*>(tw), n, hny, cluster_k, xt::log2i(tile_c),
      __builtin_nanf("")));
}

template <bool FAST, bool CPLX>
int run_stop(int stop, const float* xr, const float* xi, float* yr,
             float* yi, const void* tw, int n, int hny, int tile_c,
             int cluster_k, int threads, int smem, int device,
             void* stream) {
  switch (stop) {
    case 0:
      return run<FAST, CPLX, 0>(xr, xi, yr, yi, tw, n, hny, tile_c,
                                cluster_k, threads, smem, device, stream);
    case 1:
      return run<FAST, CPLX, 1>(xr, xi, yr, yi, tw, n, hny, tile_c,
                                cluster_k, threads, smem, device, stream);
    case 2:
      return run<FAST, CPLX, 2>(xr, xi, yr, yi, tw, n, hny, tile_c,
                                cluster_k, threads, smem, device, stream);
    case 3:
      return run<FAST, CPLX, 3>(xr, xi, yr, yi, tw, n, hny, tile_c,
                                cluster_k, threads, smem, device, stream);
    case 4:
      return run<FAST, CPLX, 4>(xr, xi, yr, yi, tw, n, hny, tile_c,
                                cluster_k, threads, smem, device, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The exchange and K-point step of combine_staged, its outputs kept alive
// in registers and never staged.
template <int K, bool FAST>
__device__ __forceinline__ void exchange(const xt::Tile& t,
                                         const float2* __restrict__ tw,
                                         float* y, float sentinel) {
  constexpr int B = xt::kElems / K;
  const int mk = t.m / K;
  const int cmask = (1 << t.logc) - 1;
  float2 v[xt::kElems];
  xt::cluster_sync();
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int u = b * blockDim.x + threadIdx.x;
    const int k2 = t.rank * mk + (u >> t.logc);
    float2* x = v + b * K;
    xt::gather<K, FAST>(t, t.s, k2, u & cmask, x);
    if (b == B - 1) xt::cluster_arrive();
    xt::twiddle_dft<K, -1>(t, tw, k2, x);
  }
  xt::cluster_wait();
#pragma unroll
  for (int e = 0; e < xt::kElems; ++e) {
    if (v[e].x == sentinel) y[0] = v[e].y;
  }
}

// kc_kernel's cut (KA false: xr, xi (n, cols) planes -> yr, yi (cols,
// n/2 + 1)) or ka_kernel's real forward (KA true: xr (n, cols) -> yr, yi
// (cols, n)), up to stop STOP
template <bool FAST, bool KA, int STOP>
__global__ void __launch_bounds__(512, 2)
    tparts_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  float* yr, float* yi, const float2* __restrict__ tw, int n,
                  int cols, int k, int logc, float sentinel) {
  extern __shared__ float2 smem[];
  const xt::Tile t = xt::begin(smem, tw, n, k, logc);
  const int j0 = (blockIdx.x / k) << logc;
  const int cmask = (1 << logc) - 1;
  // ka_kernel's and kc_kernel's load: rows rank + k * jj, consecutive
  // lanes on consecutive columns
#pragma unroll
  for (int b = 0; b < xt::kElems; ++b) {
    const int u = b * blockDim.x + threadIdx.x;
    const int x = j0 + (u & cmask);
    float2* d = t.s + u;
    if (x < cols) {
      const size_t off =
          static_cast<size_t>(t.rank + k * (u >> logc)) * cols + x;
      xt::cp_async4(&d->x, xr + off);
      if constexpr (KA) {
        d->y = 0.f;
      } else {
        xt::cp_async4(&d->y, xi + off);
      }
    } else {
      *d = make_float2(0.f, 0.f);
    }
  }
  xt::cp_async_wait_all();
  __syncthreads();
  if constexpr (STOP == 4) {
    if constexpr (KA) {
      xt::RowOut o{yr, yi, 0, j0, cols, n, 1.f};
      xt::finish_transposed<-1, FAST>(t, tw, false, o);
    } else {
      xt::HalfOut o{yr, yi, 0, j0, cols, n / 2 + 1};
      xt::finish_transposed<-1, FAST>(t, tw, true, o);
    }
    return;
  }
  if constexpr (STOP > 0) xt::subdft<-1, FAST>(t);
  if constexpr (STOP == 2) {
    switch (t.k) {
      case 1:
        exchange<1, FAST>(t, tw, yr, sentinel);
        break;
      case 2:
        exchange<2, FAST>(t, tw, yr, sentinel);
        break;
      case 4:
        exchange<4, FAST>(t, tw, yr, sentinel);
        break;
      default:
        exchange<8, FAST>(t, tw, yr, sentinel);
        break;
    }
    return;
  }
  if constexpr (STOP == 3) {
    switch (t.k) {
      case 1:
        xt::combine_staged<1, -1, FAST>(t, tw);
        break;
      case 2:
        xt::combine_staged<2, -1, FAST>(t, tw);
        break;
      case 4:
        xt::combine_staged<4, -1, FAST>(t, tw);
        break;
      default:
        xt::combine_staged<8, -1, FAST>(t, tw);
        break;
    }
  }
  const float2 v = t.s[threadIdx.x];
  if (v.x == sentinel) yr[0] = v.y;
}

template <bool FAST, bool KA, int STOP>
int trun(const float* xr, const float* xi, float* yr, float* yi,
         const void* tw, int n, int cols, int tile_c, int cluster_k,
         int threads, int smem, int device, void* stream) {
  const int tiles = (cols + tile_c - 1) / tile_c;
  return static_cast<int>(xt::launch(
      tparts_kernel<FAST, KA, STOP>, tiles, 1, cluster_k, threads, smem,
      device, static_cast<cudaStream_t>(stream), xr, xi, yr, yi,
      static_cast<const float2*>(tw), n, cols, cluster_k, xt::log2i(tile_c),
      __builtin_nanf("")));
}

template <bool FAST, bool KA>
int trun_stop(int stop, const float* xr, const float* xi, float* yr,
              float* yi, const void* tw, int n, int cols, int tile_c,
              int cluster_k, int threads, int smem, int device,
              void* stream) {
  switch (stop) {
    case 0:
      return trun<FAST, KA, 0>(xr, xi, yr, yi, tw, n, cols, tile_c,
                               cluster_k, threads, smem, device, stream);
    case 1:
      return trun<FAST, KA, 1>(xr, xi, yr, yi, tw, n, cols, tile_c,
                               cluster_k, threads, smem, device, stream);
    case 2:
      return trun<FAST, KA, 2>(xr, xi, yr, yi, tw, n, cols, tile_c,
                               cluster_k, threads, smem, device, stream);
    case 3:
      return trun<FAST, KA, 3>(xr, xi, yr, yi, tw, n, cols, tile_c,
                               cluster_k, threads, smem, device, stream);
    case 4:
      return trun<FAST, KA, 4>(xr, xi, yr, yi, tw, n, cols, tile_c,
                               cluster_k, threads, smem, device, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The cut transposed store: ka 0: kc's (xr, xi two (n, cols) float planes
// -> yr, yi (cols, n/2 + 1)), 1: ka's real forward (xr (n, cols), xi
// unused -> yr, yi (cols, n)); fast 0 or 1; stop 0..4 (above); tile_c,
// cluster_k, threads, smem: the plan of ops/xtile.py for n.
extern "C" int xfb_xtile_tparts(int fast, int ka, int stop, const float* xr,
                                const float* xi, float* yr, float* yi,
                                const void* tw, int n, int cols, int tile_c,
                                int cluster_k, int threads, int smem,
                                int device, void* stream) {
  if (!xt::plan_ok(n, tile_c, cluster_k, threads, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (fast) {
    return ka ? trun_stop<true, true>(stop, xr, xi, yr, yi, tw, n, cols,
                                      tile_c, cluster_k, threads, smem,
                                      device, stream)
              : trun_stop<true, false>(stop, xr, xi, yr, yi, tw, n, cols,
                                       tile_c, cluster_k, threads, smem,
                                       device, stream);
  }
  return ka ? trun_stop<false, true>(stop, xr, xi, yr, yi, tw, n, cols,
                                     tile_c, cluster_k, threads, smem,
                                     device, stream)
            : trun_stop<false, false>(stop, xr, xi, yr, yi, tw, n, cols,
                                      tile_c, cluster_k, threads, smem,
                                      device, stream);
}

// The cut x-stage: xr, xi (cplx 0: two (n, hny) float planes; 1: xr one
// (n, hny) complex64 array, xi unused) -> yr, yi the same way; fast 0 or
// 1; stop 0..4 (above); tile_c, cluster_k, threads, smem: the plan of
// ops/xtile.py for n.
extern "C" int xfb_xtile_parts(int fast, int cplx, int stop, const float* xr,
                               const float* xi, float* yr, float* yi,
                               const void* tw, int n, int hny, int tile_c,
                               int cluster_k, int threads, int smem,
                               int device, void* stream) {
  if (!xt::plan_ok(n, tile_c, cluster_k, threads, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (fast) {
    return cplx ? run_stop<true, true>(stop, xr, xi, yr, yi, tw, n, hny,
                                       tile_c, cluster_k, threads, smem,
                                       device, stream)
                : run_stop<true, false>(stop, xr, xi, yr, yi, tw, n, hny,
                                        tile_c, cluster_k, threads, smem,
                                        device, stream);
  }
  return cplx ? run_stop<false, true>(stop, xr, xi, yr, yi, tw, n, hny,
                                      tile_c, cluster_k, threads, smem,
                                      device, stream)
              : run_stop<false, false>(stop, xr, xi, yr, yi, tw, n, hny,
                                       tile_c, cluster_k, threads, smem,
                                       device, stream);
}

// The resident clusters of the stop-4 cut (the kernels' launch bounds,
// plan and shared bytes) for a grid of `tiles` tiles: out[0] clusters,
// out[1] blocks per SM, out[2] registers, out[3] local bytes per thread.
extern "C" int xfb_xtile_occupancy(int fast, int tiles, int cluster_k,
                                   int threads, int smem, int device,
                                   int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* kernel =
      fast ? reinterpret_cast<const void*>(parts_kernel<true, false, 4>)
           : reinterpret_cast<const void*>(parts_kernel<false, false, 4>);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * cluster_k, 1);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(&out[0], kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  out[2] = fa.numRegs;
  out[3] = static_cast<int>(fa.localSizeBytes);
  return static_cast<int>(err);
}
