// ky_all: the shallow-water products and their forward y-stages.
//
// Replaces pallas_sw.forward_tendencies' KY stage: _ky_all_loop_kernel
// (xlab_fftbarotropic_tpu/ops/pallas_sw.py:533, the default at 4096^2),
// _ky_all_kernel (:513, the default up to 2048^2) and _ky_fwd_kernel
// (:489, XFB_SW_KYALL=0), three TPU schedules of one function. For each
// physical column x of the y-major (ny, nx) fields u, v, zeta, eta_s it
// forms the five products q u, q v, eta u, eta v, phi with
//   eta = eta_s * ies          (ies = 1 / eta_scale, exact)
//   q   = zeta + f0            (zeta alone when split)
//   phi = g * eta + ke         (ke alone when split), ke = 0.5 (u u + v v)
// each product and sum rounded on its own in the order of
// ops/fused_sw.py sw_products (epilogue.cuh sw_product, ka_fwd's load),
// runs the forward DFT of each real product column along y and keeps
// rows k <= ny/2, written as out[p, x, k] of shape (5, nx, ny/2 + 1).
//
// Each product gets its own transform: packing two real products into
// one complex FFT would give the smaller one the larger one's round-off,
// and the products differ by orders (q u about 1e-3, phi about 50 in the
// bench configuration).
//
// Bound: memory traffic, about 604 MB per call at 4096^2 (4 planes in,
// 10 half planes out). ky_adv's y-stage (csrc/ky_adv.cu) with ka_fwd's
// load and cluster order (csrc/ka_kc.cu): the column-tile transform of
// csrc/xtile.cuh, planned for ny alone; a cluster of K blocks owns C
// adjacent x columns of one product, block r computes rows y = r + K j of
// the tile from the planes that product reads (row segments of C floats),
// and the transposed half store writes each output row x in runs of
// contiguous k. The cluster index decodes as (tile, product), product
// fastest, so the five clusters of a tile run together and all but the
// first to read a plane's columns find them in L2. The tile holds
// (product, 0), so product p is kc of (sw_products(...)[p], 0) bit for
// bit.
#include "epilogue.cuh"
#include "xtile.cuh"

namespace {

// cluster (tile, p) of product p = cluster mod 5: columns j0 .. j0 + C of
// the y-major (ny, nx) fields; block r of it forms rows r + k jj of the
// tile (zero imaginary parts), consecutive lanes on consecutive columns
__global__ void __launch_bounds__(512, 2)
    ky_all_kernel(const float* __restrict__ u, const float* __restrict__ v,
                  const float* __restrict__ zeta,
                  const float* __restrict__ eta_s,
                  const float2* __restrict__ tw, xfb::xtile::HalfOut out,
                  int ny, int k, int logc, float ies, float f0, float grav,
                  int split) {
  extern __shared__ float2 smem[];
  namespace xt = xfb::xtile;
  const xt::Tile t = xt::begin(smem, tw, ny, k, logc);
  const int nx = out.nx;
  const int cluster = blockIdx.x / k;
  const int p = cluster % xfb::kSwProducts;
  const int j0 = (cluster / xfb::kSwProducts) << logc;
  xt::load_rows(t, j0, nx, [&](int, int, size_t off) {
    return make_float2(
        xfb::sw_product(p, u, v, zeta, eta_s, off, ies, f0, grav, split != 0),
        0.f);
  });
  __syncthreads();
  xt::HalfOut o = out;
  o.j0 = j0;
  o.plane = static_cast<size_t>(p) * nx * out.hny;
  xt::finish_transposed<-1>(t, tw, true, o);
}

}  // namespace

// u, v, zeta, eta_s: (ny, nx) y-major -> outr, outi: (5, nx, ny/2 + 1).
// tile_c, cluster_k, threads, smem: the plan of ops/xtile.py for ny.
extern "C" int xfb_ky_all(const float* u, const float* v, const float* zeta,
                          const float* eta_s, const void* tw, float* outr,
                          float* outi, int ny, int nx, float ies, float f0,
                          float grav, int split, int tile_c, int cluster_k,
                          int threads, int smem, int device, void* stream) {
  if (!xfb::xtile::plan_ok(ny, tile_c, cluster_k, threads, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (nx + tile_c - 1) / tile_c;
  return static_cast<int>(xfb::xtile::launch(
      ky_all_kernel, tiles * xfb::kSwProducts, 1, cluster_k, threads, smem,
      device, static_cast<cudaStream_t>(stream), u, v, zeta, eta_s,
      static_cast<const float2*>(tw),
      xfb::xtile::HalfOut{outr, outi, 0, 0, nx, ny / 2 + 1}, ny, cluster_k,
      xfb::xtile::log2i(tile_c), ies, f0, grav, split));
}
