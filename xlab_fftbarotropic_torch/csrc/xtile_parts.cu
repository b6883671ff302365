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
// the half store k <= n/2 to (cols, n/2 + 1) planes), ka_kernel's real
// forward (one float plane in, the full store to (cols, n) planes),
// kb_kernel's (the Hermitian load, the inverse, the full x-major store;
// paired and single) and ky_all_kernel's (the product load, five products
// a tile, the half store):
//   stop 0: the loads (each form's own);
//   stop 1: + the whole sub-DFT;
//   stop 2: + the cluster exchange and the K-point step, the outputs held
//           in registers;
//   stop 3: + the staging of the outputs in the tile (combine_staged);
//   stop 4: all of it, with the transposed store (finish_transposed).
#include "epilogue.cuh"
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
template <int K, int SIGN, bool FAST>
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
    xt::twiddle_dft<K, SIGN>(t, tw, k2, x);
  }
  xt::cluster_wait();
#pragma unroll
  for (int e = 0; e < xt::kElems; ++e) {
    if (v[e].x == sentinel) y[0] = v[e].y;
  }
}

// The forms of the cut transposed store: kc's (two (n, cols) float
// planes in, the half store to (cols, n/2 + 1) planes), ka's real forward
// (one (n, cols) plane in, the full store to (cols, n) planes), kb's (the
// Hermitian load of two (n/2 + 1, cols) plane pairs, the inverse, the
// full x-major store of Re and Im times the scale to (cols, n) planes;
// the third plane NULL: the single inverse, Re alone) and ky_all's (the
// five shallow-water products of the (n, cols) planes u, v, zeta, eta_s,
// product fastest in the grid, the half store to (5, cols, n/2 + 1)
// planes; the bench's constants below, split on as fast mode runs it).
enum Form { kKc = 0, kKaReal = 1, kKb = 2, kKyAll = 3 };
constexpr float kIes = 32768.f, kF0 = 1e-4f, kGrav = 9.81f;

// kb_pair.cu KbOut: Re * scale to oa[x, y], Im * scale to ob[x, y] (ob
// NULL: not written)
struct KbStore {
  float* oa;
  float* ob;
  int j0, nx, ny;
  float scale;

  __device__ __forceinline__ void operator()(int y, int c, float2 v) const {
    const int x = j0 + c;
    if (x >= nx) return;
    const size_t off = static_cast<size_t>(x) * ny + y;
    oa[off] = __fmul_rn(v.x, scale);
    if (ob != nullptr) ob[off] = __fmul_rn(v.y, scale);
  }
};

// The plane tile's cut (the fast kb_kernel and ky_all_kernel: SIGN, HALF
// and the load theirs): xtile.cuh plane_transposed's steps up to stop
// STOP, the same calls in its order.
template <int SIGN, bool HALF, int STOP, class Load, class Out>
__device__ __forceinline__ void plane_cut(float2* smem,
                                          const float2* __restrict__ tw,
                                          int n, int k, int logc,
                                          const Load& load, Out out,
                                          float* y, float sentinel) {
  if constexpr (STOP == 4) {
    xt::plane_transposed<SIGN, HALF>(smem, tw, n, k, logc, load, out);
    return;
  }
  const xt::Tile t = xt::begin(smem, tw, n, k, logc);
  const bool vec = load.vec();
  load(t, load.first_column(k, logc), vec);
  __syncthreads();
  if constexpr (STOP > 0) xt::subdft_planes<SIGN>(t, vec, load.real());
  if constexpr (STOP == 2) {
    switch (t.k) {
      case 1:
        exchange<1, SIGN, true>(t, tw, y, sentinel);
        break;
      case 2:
        exchange<2, SIGN, true>(t, tw, y, sentinel);
        break;
      case 4:
        exchange<4, SIGN, true>(t, tw, y, sentinel);
        break;
      default:
        exchange<8, SIGN, true>(t, tw, y, sentinel);
        break;
    }
    return;
  }
  if constexpr (STOP == 3 && HALF) {
    switch (t.k) {
      case 1:
        xt::combine_staged_half<1, SIGN>(t, tw);
        break;
      case 2:
        xt::combine_staged_half<2, SIGN>(t, tw);
        break;
      case 4:
        xt::combine_staged_half<4, SIGN>(t, tw);
        break;
      default:
        xt::combine_staged_half<8, SIGN>(t, tw);
        break;
    }
  } else if constexpr (STOP == 3) {
    switch (t.k) {
      case 1:
        xt::combine_staged<1, SIGN, true>(t, tw);
        break;
      case 2:
        xt::combine_staged<2, SIGN, true>(t, tw);
        break;
      case 4:
        xt::combine_staged<4, SIGN, true>(t, tw);
        break;
      default:
        xt::combine_staged<8, SIGN, true>(t, tw);
        break;
    }
  }
  const float2 v = t.s[threadIdx.x];
  if (v.x == sentinel) y[0] = v.y;
}

// The column tile's cut of form FORM up to stop STOP: each form's own
// load, then finish_transposed's steps (kc_kernel, ka_kernel, and the
// strict kb_kernel and ky_all_kernel)
template <bool FAST, int FORM, int STOP>
__device__ __forceinline__ void tile_cut(
    float2* smem, const float* __restrict__ x0, const float* __restrict__ x1,
    const float* __restrict__ x2, const float* __restrict__ x3, float* yr,
    float* yi, const float2* __restrict__ tw, int n, int cols, float scale,
    int k, int logc, float sentinel) {
  constexpr int SIGN = FORM == kKb ? +1 : -1;
  const xt::Tile t = xt::begin(smem, tw, n, k, logc);
  int cluster = blockIdx.x / k, p = 0;
  if constexpr (FORM == kKyAll) {
    p = cluster % xfb::kSwProducts;
    cluster /= xfb::kSwProducts;
  }
  const int j0 = cluster << logc;
  const int cmask = (1 << logc) - 1;
  if constexpr (FORM == kKb) {
    xt::load_hermitian(t, t.s, x0, x1, x2, x3, j0, cols);
  } else if constexpr (FORM == kKyAll) {
    xt::load_rows(t, j0, cols, [&](int, int, size_t off) {
      return make_float2(xfb::sw_product(p, x0, x1, x2, x3, off, kIes, kF0,
                                         kGrav, true),
                         0.f);
    });
  } else {
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
        xt::cp_async4(&d->x, x0 + off);
        if constexpr (FORM == kKaReal) {
          d->y = 0.f;
        } else {
          xt::cp_async4(&d->y, x1 + off);
        }
      } else {
        *d = make_float2(0.f, 0.f);
      }
    }
    xt::cp_async_wait_all();
  }
  __syncthreads();
  if constexpr (STOP == 4) {
    if constexpr (FORM == kKaReal) {
      xt::RowOut o{yr, yi, 0, j0, cols, n, 1.f};
      xt::finish_transposed<-1, FAST>(t, tw, false, o);
    } else if constexpr (FORM == kKb) {
      KbStore o{yr, yi, j0, cols, n, scale};
      xt::finish_transposed<+1, FAST>(t, tw, false, o);
    } else {
      const size_t plane = static_cast<size_t>(p) * cols * (n / 2 + 1);
      xt::HalfOut o{yr, yi, plane, j0, cols, n / 2 + 1};
      xt::finish_transposed<-1, FAST>(t, tw, true, o);
    }
    return;
  }
  if constexpr (STOP > 0) xt::subdft<SIGN, FAST>(t);
  if constexpr (STOP == 2) {
    switch (t.k) {
      case 1:
        exchange<1, SIGN, FAST>(t, tw, yr, sentinel);
        break;
      case 2:
        exchange<2, SIGN, FAST>(t, tw, yr, sentinel);
        break;
      case 4:
        exchange<4, SIGN, FAST>(t, tw, yr, sentinel);
        break;
      default:
        exchange<8, SIGN, FAST>(t, tw, yr, sentinel);
        break;
    }
    return;
  }
  if constexpr (STOP == 3) {
    switch (t.k) {
      case 1:
        xt::combine_staged<1, SIGN, FAST>(t, tw);
        break;
      case 2:
        xt::combine_staged<2, SIGN, FAST>(t, tw);
        break;
      case 4:
        xt::combine_staged<4, SIGN, FAST>(t, tw);
        break;
      default:
        xt::combine_staged<8, SIGN, FAST>(t, tw);
        break;
    }
  }
  const float2 v = t.s[threadIdx.x];
  if (v.x == sentinel) yr[0] = v.y;
}

// The cut of form FORM (above) up to stop STOP: the fast kb and ky_all on
// the plane tile (plane_cut), the others on the column tile (tile_cut)
template <bool FAST, int FORM, int STOP>
__global__ void __launch_bounds__(512, 2)
    tparts_kernel(const float* __restrict__ x0, const float* __restrict__ x1,
                  const float* __restrict__ x2, const float* __restrict__ x3,
                  float* yr, float* yi, const float2* __restrict__ tw, int n,
                  int cols, float scale, int k, int logc, float sentinel) {
  extern __shared__ float2 smem[];
  if constexpr (FAST && FORM == kKb) {
    plane_cut<+1, false, STOP>(smem, tw, n, k, logc,
                               xt::HermitianLoad{x0, x1, x2, x3, cols},
                               KbStore{yr, yi, 0, cols, n, scale}, yr,
                               sentinel);
  } else if constexpr (FAST && FORM == kKyAll) {
    const int p = static_cast<int>(blockIdx.x / k) % xfb::kSwProducts;
    const int hny = n / 2 + 1;
    plane_cut<-1, true, STOP>(
        smem, tw, n, k, logc,
        xt::SwProductLoad{x0, x1, x2, x3, cols, p, kIes, kF0, kGrav, true},
        xt::HalfOut{yr, yi, static_cast<size_t>(p) * cols * hny, 0, cols,
                    hny},
        yr, sentinel);
  } else {
    tile_cut<FAST, FORM, STOP>(smem, x0, x1, x2, x3, yr, yi, tw, n, cols,
                               scale, k, logc, sentinel);
  }
}

template <bool FAST, int FORM, int STOP>
int trun(const float* const* x, float* yr, float* yi, const void* tw, int n,
         int cols, float scale, int tile_c, int cluster_k, int threads,
         int smem, int device, void* stream) {
  const int tiles = (cols + tile_c - 1) / tile_c;
  return static_cast<int>(xt::launch(
      tparts_kernel<FAST, FORM, STOP>,
      tiles * (FORM == kKyAll ? xfb::kSwProducts : 1), 1, cluster_k, threads,
      smem, device, static_cast<cudaStream_t>(stream), x[0], x[1], x[2],
      x[3], yr, yi, static_cast<const float2*>(tw), n, cols, scale,
      cluster_k, xt::log2i(tile_c), __builtin_nanf("")));
}

template <bool FAST, int FORM>
int trun_stop(int stop, const float* const* x, float* yr, float* yi,
              const void* tw, int n, int cols, float scale, int tile_c,
              int cluster_k, int threads, int smem, int device,
              void* stream) {
  switch (stop) {
    case 0:
      return trun<FAST, FORM, 0>(x, yr, yi, tw, n, cols, scale, tile_c,
                                 cluster_k, threads, smem, device, stream);
    case 1:
      return trun<FAST, FORM, 1>(x, yr, yi, tw, n, cols, scale, tile_c,
                                 cluster_k, threads, smem, device, stream);
    case 2:
      return trun<FAST, FORM, 2>(x, yr, yi, tw, n, cols, scale, tile_c,
                                 cluster_k, threads, smem, device, stream);
    case 3:
      return trun<FAST, FORM, 3>(x, yr, yi, tw, n, cols, scale, tile_c,
                                 cluster_k, threads, smem, device, stream);
    case 4:
      return trun<FAST, FORM, 4>(x, yr, yi, tw, n, cols, scale, tile_c,
                                 cluster_k, threads, smem, device, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool FAST>
int tform(int form, int stop, const float* const* x, float* yr, float* yi,
          const void* tw, int n, int cols, float scale, int tile_c,
          int cluster_k, int threads, int smem, int device, void* stream) {
  switch (form) {
    case kKc:
      return trun_stop<FAST, kKc>(stop, x, yr, yi, tw, n, cols, scale,
                                  tile_c, cluster_k, threads, smem, device,
                                  stream);
    case kKaReal:
      return trun_stop<FAST, kKaReal>(stop, x, yr, yi, tw, n, cols, scale,
                                      tile_c, cluster_k, threads, smem,
                                      device, stream);
    case kKb:
      return trun_stop<FAST, kKb>(stop, x, yr, yi, tw, n, cols, scale,
                                  tile_c, cluster_k, threads, smem, device,
                                  stream);
    case kKyAll:
      return trun_stop<FAST, kKyAll>(stop, x, yr, yi, tw, n, cols, scale,
                                     tile_c, cluster_k, threads, smem,
                                     device, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The cut transposed store of form `form` (0 kc: x0, x1 two (n, cols)
// float planes -> yr, yi (cols, n/2 + 1); 1 ka's real forward: x0 (n,
// cols) -> yr, yi (cols, n); 2 kb: x0..x3 two (n/2 + 1, cols) plane pairs
// (x2, x3, yi NULL: the single inverse) -> yr, yi x-major (cols, n) times
// `scale`; 3 ky_all: x0..x3 the (n, cols) planes u, v, zeta, eta_s -> yr,
// yi (5, cols, n/2 + 1)); fast 0 or 1; stop 0..4 (above); tile_c,
// cluster_k, threads, smem: the plan of ops/xtile.py for n.
extern "C" int xfb_xtile_tparts(int fast, int form, int stop,
                                const float* x0, const float* x1,
                                const float* x2, const float* x3, float* yr,
                                float* yi, const void* tw, int n, int cols,
                                float scale, int tile_c, int cluster_k,
                                int threads, int smem, int device,
                                void* stream) {
  if (!xt::plan_ok(n, tile_c, cluster_k, threads, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* const x[4] = {x0, x1, x2, x3};
  return fast ? tform<true>(form, stop, x, yr, yi, tw, n, cols, scale,
                            tile_c, cluster_k, threads, smem, device, stream)
              : tform<false>(form, stop, x, yr, yi, tw, n, cols, scale,
                             tile_c, cluster_k, threads, smem, device,
                             stream);
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
