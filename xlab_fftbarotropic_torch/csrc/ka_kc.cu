// ka, kc: the per-transform x-stage and forward partial y-stage, and the
// x-first forward pipelines built on them.
//
// ka replaces pallas_fft._ka_call / _ka_kernel
// (xlab_fftbarotropic_tpu/ops/pallas_fft.py:549) in every mode: for each
// column j of the (n, m) planes x = xr + i xi (xi NULL: real input) it
// runs the DFT along the n rows, forward (exp(-...)) or inverse
// (exp(+...)), unnormalized, multiplies by `scale` (the TPU kernel folds
// it into its DFT matrix; here one rounded product after the DFT) and
// writes the row out[j, :] of the transposed (m, n) planes.
//
// kc replaces pallas_fft._kc_call / _kc_kernel (:1349): for each column
// x of the y-major (ny, nx) complex planes it runs the forward DFT along
// y and keeps rows k <= ny/2, written as out[x, k] (nx, ny/2 + 1).
// The same kernel with a field grid axis is kc_sw, the stacked (F, ny, nx)
// -> (F, nx, ny/2 + 1) form (pallas_sw._kc_sw_kernel, ops/pallas_sw.py:581),
// and with the viscosity and dealias epilogue of _visc_epilogue (:1536),
//   nulap = nu * lap;  out = mask * (Y + nulap * Z)
// on the (nx, ny/2 + 1) tables and current stage state, it is kc_visc
// (pallas_fft._kc_visc_kernel, :1412).
//
// The x-first forward pipelines read x-major (nx, ny) physical fields and
// run the real forward x-DFT of each y column j, written transposed as
// the row out[j, :] of (ny, nx) planes, with a product prologue:
//   ka_adv (pallas_fft._ka_adv_kernel, :1391): -(u zx) - v zy + S (zy +
//     beta for beta != 0), each product and sum rounded on its own in
//     ky_adv's expression order (epilogue.cuh advection);
//   ka_fwd (pallas_sw._ka_fwd_kernel, ops/pallas_sw.py:450): the five
//     shallow-water products of csrc/ky_all.cu (q u, q v, eta u, eta v,
//     phi; eta = eta_s * ies unscales the pairing equalizer exactly), each
//     rounded as ops/fused_sw.py sw_products (epilogue.cuh sw_product),
//     one product per cluster, written to (5, ny, nx).
// ka_adv + kc_visc is the barotropic x-first tendency, ka_fwd + kc_sw the
// shallow-water one (COMBINE follows, csrc/sw_combine.cu).
//
// Bound: memory traffic. Every kernel here is on the column-tile
// transform of csrc/xtile.cuh: a cluster of K blocks owns C adjacent
// columns, so the planes are read in row segments of C floats (64 bytes
// at C = 16, where a block per column used 4 bytes of each 32-byte
// sector), and the transposed store hands each output row to the
// epilogue in runs of contiguous k, so the outputs (and kc_visc's tables)
// move in whole sectors too. ka, ka_adv and ka_fwd run the plan of n
// alone (ka_adv and ka_fwd: ka's real forward behind a load that forms
// the advection or the product, so ka of the advection or products
// formed in torch gives their bits), and kc, kc_sw and kc_visc are one
// kernel on an epilogue with the plan of ny alone (ops/xtile.py), so
// every form runs one transform's bits. At hny = n/2 + 1 columns (the
// complex inverse of irfft2 and inverse_pair) the last tile holds one
// column: its loads read 0 and its stores are skipped past m.
// At 4096^2 ka (real input) reads 67 MB and writes 134 MB, kc reads 134
// MB and writes 67 MB; ka_adv reads 336 MB and writes 134 MB, kc_visc
// reads 268 MB and writes 67 MB, ka_fwd reads 268 MB and writes 671 MB,
// kc_sw reads 671 MB and writes 336 MB. ka_fwd's cluster index decodes
// as (tile, product), product fastest, so the five clusters of a tile
// run together and all but the first to read a plane's columns find
// them in L2; each reads only the planes its product needs.
#include "epilogue.cuh"
#include "xtile.cuh"

namespace {

// cluster tile: columns j0 .. j0 + C of the (n, m) planes; block r of it
// loads rows r + k jj of the tile (xi NULL: zero imaginary parts),
// consecutive lanes on consecutive columns
template <int SIGN>
__global__ void __launch_bounds__(512, 2)
    ka_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
              const float2* __restrict__ tw, xfb::xtile::RowOut out, int n,
              int k, int logc) {
  extern __shared__ float2 smem[];
  namespace xt = xfb::xtile;
  const xt::Tile t = xt::begin(smem, tw, n, k, logc);
  const int m = out.m;
  const int j0 = (blockIdx.x / k) << logc;
  const int cmask = (1 << logc) - 1;
#pragma unroll
  for (int b = 0; b < xt::kElems; ++b) {
    const int u = b * blockDim.x + threadIdx.x;
    const int x = j0 + (u & cmask);
    float2* d = t.s + u;
    if (x < m) {
      const size_t off =
          static_cast<size_t>(t.rank + k * (u >> logc)) * m + x;
      xt::cp_async4(&d->x, xr + off);
      if (xi != nullptr) {
        xt::cp_async4(&d->y, xi + off);
      } else {
        d->y = 0.f;
      }
    } else {
      *d = make_float2(0.f, 0.f);
    }
  }
  xt::cp_async_wait_all();
  __syncthreads();
  xt::RowOut o = out;
  o.j0 = j0;
  xt::finish_transposed<SIGN>(t, tw, false, o);
}

// cluster tile: columns j0 .. j0 + C of the x-major (nx, ny) fields;
// block r of it forms rows r + k jj of the tile (zero imaginary parts),
// consecutive lanes on consecutive columns
__global__ void __launch_bounds__(512, 2)
    ka_adv_kernel(const float* __restrict__ u, const float* __restrict__ zx,
                  const float* __restrict__ v, const float* __restrict__ zy,
                  const float* __restrict__ src,
                  const float2* __restrict__ tw, xfb::xtile::RowOut out,
                  int nx, int k, int logc, float beta) {
  extern __shared__ float2 smem[];
  namespace xt = xfb::xtile;
  const xt::Tile t = xt::begin(smem, tw, nx, k, logc);
  const int j0 = (blockIdx.x / k) << logc;
  xt::load_rows(t, j0, out.m, [&](int, int, size_t off) {
    return make_float2(
        xfb::advection(__ldg(u + off), __ldg(zx + off), __ldg(v + off),
                       __ldg(zy + off), __ldg(src + off), beta),
        0.f);
  });
  __syncthreads();
  xt::RowOut o = out;
  o.j0 = j0;
  xt::finish_transposed<-1>(t, tw, false, o);
}

// cluster (tile, p) of product p = cluster mod 5: columns j0 .. j0 + C of
// the x-major (nx, ny) fields; block r of it forms rows r + k jj of the
// tile (zero imaginary parts), consecutive lanes on consecutive columns
__global__ void __launch_bounds__(512, 2)
    ka_fwd_kernel(const float* __restrict__ u, const float* __restrict__ v,
                  const float* __restrict__ zeta,
                  const float* __restrict__ eta_s,
                  const float2* __restrict__ tw, xfb::xtile::RowOut out,
                  int nx, int k, int logc, float ies, float f0, float grav,
                  int split) {
  extern __shared__ float2 smem[];
  namespace xt = xfb::xtile;
  const xt::Tile t = xt::begin(smem, tw, nx, k, logc);
  const int ny = out.m;
  const int cluster = blockIdx.x / k;
  const int p = cluster % xfb::kSwProducts;
  const int j0 = (cluster / xfb::kSwProducts) << logc;
  xt::load_rows(t, j0, ny, [&](int, int, size_t off) {
    return make_float2(
        xfb::sw_product(p, u, v, zeta, eta_s, off, ies, f0, grav, split != 0),
        0.f);
  });
  __syncthreads();
  xt::RowOut o = out;
  o.j0 = j0;
  o.plane = static_cast<size_t>(p) * ny * nx;
  xt::finish_transposed<-1>(t, tw, false, o);
}

// The store of kc's output k of tile column c (field plane `plane` of
// the (F, nx, hny) outputs); lap == NULL: no epilogue, else kc_visc's
// on the (nx, hny) tables and stage state (one field), read in k order.
struct KcOut {
  const float* lap;
  const float* mask;
  const float* zr;
  const float* zi;
  float* yr;
  float* yi;
  size_t plane;
  int j0, nx, hny;
  float nu;

  __device__ __forceinline__ void operator()(int k, int c, float2 v) const {
    const int x = j0 + c;
    if (x >= nx) return;  // the ragged last tile
    const size_t off = plane + static_cast<size_t>(x) * hny + k;
    if (lap != nullptr) {
      v = xfb::visc(nu, __ldg(lap + off), __ldg(mask + off), v,
                    __ldg(zr + off), __ldg(zi + off));
    }
    yr[off] = v.x;
    yi[off] = v.y;
  }
};

// cluster (tile, f): columns j0 .. j0 + C of field f; block r of it loads
// rows r + k jj of the tile, consecutive lanes on consecutive columns
__global__ void __launch_bounds__(512, 2)
    kc_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
              const float2* __restrict__ tw, KcOut out, int ny, int k,
              int logc) {
  extern __shared__ float2 smem[];
  namespace xt = xfb::xtile;
  const xt::Tile t = xt::begin(smem, tw, ny, k, logc);
  const int nx = out.nx;
  const int j0 = (blockIdx.x / k) << logc;
  const size_t plane = static_cast<size_t>(blockIdx.y) * ny * nx;
  const int cmask = (1 << logc) - 1;
#pragma unroll
  for (int b = 0; b < xt::kElems; ++b) {
    const int u = b * blockDim.x + threadIdx.x;
    const int x = j0 + (u & cmask);
    float2* d = t.s + u;
    if (x < nx) {
      const size_t off =
          plane + static_cast<size_t>(t.rank + k * (u >> logc)) * nx + x;
      xt::cp_async4(&d->x, xr + off);
      xt::cp_async4(&d->y, xi + off);
    } else {
      *d = make_float2(0.f, 0.f);
    }
  }
  xt::cp_async_wait_all();
  __syncthreads();
  KcOut o = out;
  o.plane = static_cast<size_t>(blockIdx.y) * nx * out.hny;
  o.j0 = j0;
  xt::finish_transposed<-1>(t, tw, true, o);
}

template <int SIGN>
int launch_ka(const float* xr, const float* xi, const void* tw, float* yr,
              float* yi, int n, int m, float scale, int tile_c,
              int cluster_k, int threads, int smem, int device,
              void* stream) {
  if (!xfb::xtile::plan_ok(n, tile_c, cluster_k, threads, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (m + tile_c - 1) / tile_c;
  return static_cast<int>(xfb::xtile::launch(
      ka_kernel<SIGN>, tiles, 1, cluster_k, threads, smem, device,
      static_cast<cudaStream_t>(stream), xr, xi,
      static_cast<const float2*>(tw),
      xfb::xtile::RowOut{yr, yi, 0, 0, m, n, scale}, n, cluster_k,
      xfb::xtile::log2i(tile_c)));
}

int launch_kc(const float* xr, const float* xi, const void* tw, KcOut out,
              int nfields, int ny, int tile_c, int cluster_k, int threads,
              int smem, int device, void* stream) {
  if (!xfb::xtile::plan_ok(ny, tile_c, cluster_k, threads, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (out.nx + tile_c - 1) / tile_c;
  return static_cast<int>(xfb::xtile::launch(
      kc_kernel, tiles, nfields, cluster_k, threads, smem, device,
      static_cast<cudaStream_t>(stream), xr, xi,
      static_cast<const float2*>(tw), out, ny, cluster_k,
      xfb::xtile::log2i(tile_c)));
}

}  // namespace

// xr, xi (xi NULL: real input): (n, m) -> yr, yi: (m, n). tile_c,
// cluster_k, threads, smem: the plan of ops/xtile.py for n.
extern "C" int xfb_ka(const float* xr, const float* xi, const void* tw,
                      float* yr, float* yi, int n, int m, int forward,
                      float scale, int tile_c, int cluster_k, int threads,
                      int smem, int device, void* stream) {
  return forward ? launch_ka<-1>(xr, xi, tw, yr, yi, n, m, scale, tile_c,
                                 cluster_k, threads, smem, device, stream)
                 : launch_ka<+1>(xr, xi, tw, yr, yi, n, m, scale, tile_c,
                                 cluster_k, threads, smem, device, stream);
}

// xr, xi: (ny, nx) -> yr, yi: (nx, ny/2 + 1). tile_c, cluster_k,
// threads, smem: the plan of ops/xtile.py for ny (and of every kc form).
extern "C" int xfb_kc(const float* xr, const float* xi, const void* tw,
                      float* yr, float* yi, int ny, int nx, int tile_c,
                      int cluster_k, int threads, int smem, int device,
                      void* stream) {
  return launch_kc(xr, xi, tw,
                   KcOut{nullptr, nullptr, nullptr, nullptr, yr, yi, 0, 0,
                         nx, ny / 2 + 1, 0.f},
                   1, ny, tile_c, cluster_k, threads, smem, device, stream);
}

// xr, xi: (nfields, ny, nx) -> yr, yi: (nfields, nx, ny/2 + 1)
extern "C" int xfb_kc_sw(const float* xr, const float* xi, const void* tw,
                         float* yr, float* yi, int nfields, int ny, int nx,
                         int tile_c, int cluster_k, int threads, int smem,
                         int device, void* stream) {
  return launch_kc(xr, xi, tw,
                   KcOut{nullptr, nullptr, nullptr, nullptr, yr, yi, 0, 0,
                         nx, ny / 2 + 1, 0.f},
                   nfields, ny, tile_c, cluster_k, threads, smem, device,
                   stream);
}

// xr, xi: (ny, nx); lap, mask, zr, zi: (nx, ny/2 + 1) -> yr, yi: the same
extern "C" int xfb_kc_visc(const float* xr, const float* xi,
                           const float* lap, const float* mask,
                           const float* zr, const float* zi, const void* tw,
                           float* yr, float* yi, int ny, int nx, float nu,
                           int tile_c, int cluster_k, int threads, int smem,
                           int device, void* stream) {
  return launch_kc(xr, xi, tw,
                   KcOut{lap, mask, zr, zi, yr, yi, 0, 0, nx, ny / 2 + 1,
                         nu},
                   1, ny, tile_c, cluster_k, threads, smem, device, stream);
}

// u, zx, v, zy, src: (nx, ny) x-major -> yr, yi: (ny, nx). tile_c,
// cluster_k, threads, smem: the plan of ops/xtile.py for nx
extern "C" int xfb_ka_adv(const float* u, const float* zx, const float* v,
                          const float* zy, const float* src, const void* tw,
                          float* yr, float* yi, int nx, int ny, float beta,
                          int tile_c, int cluster_k, int threads, int smem,
                          int device, void* stream) {
  if (!xfb::xtile::plan_ok(nx, tile_c, cluster_k, threads, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (ny + tile_c - 1) / tile_c;
  return static_cast<int>(xfb::xtile::launch(
      ka_adv_kernel, tiles, 1, cluster_k, threads, smem, device,
      static_cast<cudaStream_t>(stream), u, zx, v, zy, src,
      static_cast<const float2*>(tw),
      xfb::xtile::RowOut{yr, yi, 0, 0, ny, nx, 1.f}, nx, cluster_k,
      xfb::xtile::log2i(tile_c), beta));
}

// u, v, zeta, eta_s: (nx, ny) x-major -> yr, yi: (5, ny, nx). tile_c,
// cluster_k, threads, smem: the plan of ops/xtile.py for nx
extern "C" int xfb_ka_fwd(const float* u, const float* v, const float* zeta,
                          const float* eta_s, const void* tw, float* yr,
                          float* yi, int nx, int ny, float ies, float f0,
                          float grav, int split, int tile_c, int cluster_k,
                          int threads, int smem, int device, void* stream) {
  if (!xfb::xtile::plan_ok(nx, tile_c, cluster_k, threads, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (ny + tile_c - 1) / tile_c;
  return static_cast<int>(xfb::xtile::launch(
      ka_fwd_kernel, tiles * xfb::kSwProducts, 1, cluster_k, threads, smem,
      device, static_cast<cudaStream_t>(stream), u, v, zeta, eta_s,
      static_cast<const float2*>(tw),
      xfb::xtile::RowOut{yr, yi, 0, 0, ny, nx, 1.f}, nx, cluster_k,
      xfb::xtile::log2i(tile_c), ies, f0, grav, split));
}
