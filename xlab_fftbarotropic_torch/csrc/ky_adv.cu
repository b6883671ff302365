// ky_adv: the advection product and the forward y-stage.
//
// Replaces pallas_fft.forward_tendency_yfirst / _ky_adv_kernel
// (xlab_fftbarotropic_tpu/ops/pallas_fft.py:1506). For each physical
// column x of the y-major (ny, nx) fields it forms
//   adv[y] = -(u zx) - v zy + S            (zy + beta for beta != 0)
// in the TPU kernel's expression order, each product and sum rounded on
// its own (xfb::advection, the expression kb_adv shares), runs the
// forward DFT of the real column (zero imaginary part) along y and keeps
// rows k <= ny/2, written as out[x, k] of shape (nx, ny/2 + 1).
//
// Bound: memory traffic, about 403 MB per call at 4096^2 (5 planes in,
// 2 half planes out). The column-tile transform of csrc/xtile.cuh, as kc
// (ka_kc.cu kc_kernel) runs it: a cluster of K blocks owns C adjacent x
// columns; block r computes rows y = r + K j of the tile from the five
// planes, read in row segments of C floats (plain loads: cp.async cannot
// compute the product), and the transposed half store writes each output
// row x in runs of contiguous k. The tile holds (adv, 0), so ky_adv is
// kc of (adv, 0) bit for bit.
//
// xfb_ky_adv_fast is ky_adv on the fast column tile (xtile.cuh FAST: the
// radix-16 sub-DFT passes as bf16 tensor-core products), the barotropic
// fast mode's FUSEKB=0 arm: the same load, plan and store, so it gives
// the bits of kb_adv_half's fast forward transform of the same
// advection.
#include "epilogue.cuh"
#include "xtile.cuh"

namespace {

// cluster tile: columns j0 .. j0 + C; block r of it computes rows r + k jj
// of the tile, consecutive lanes on consecutive columns
template <bool FAST>
__global__ void __launch_bounds__(512, 2)
    ky_adv_kernel(const float* __restrict__ u, const float* __restrict__ zx,
                  const float* __restrict__ v, const float* __restrict__ zy,
                  const float* __restrict__ src,
                  const float2* __restrict__ tw, xfb::xtile::HalfOut out,
                  int ny, int k, int logc, float beta) {
  extern __shared__ float2 smem[];
  namespace xt = xfb::xtile;
  const xt::Tile t = xt::begin(smem, tw, ny, k, logc);
  const int nx = out.nx;
  const int j0 = (blockIdx.x / k) << logc;
  const int cmask = (1 << logc) - 1;
#pragma unroll
  for (int b = 0; b < xt::kElems; ++b) {
    const int i = b * blockDim.x + threadIdx.x;
    const int x = j0 + (i & cmask);
    float adv = 0.f;
    if (x < nx) {
      const size_t off =
          static_cast<size_t>(t.rank + k * (i >> logc)) * nx + x;
      adv = xfb::advection(__ldg(u + off), __ldg(zx + off), __ldg(v + off),
                           __ldg(zy + off), __ldg(src + off), beta);
    }
    t.s[i] = make_float2(adv, 0.f);
  }
  __syncthreads();
  xt::HalfOut o = out;
  o.j0 = j0;
  xt::finish_transposed<-1, FAST>(t, tw, true, o);
}

template <bool FAST>
int launch(const float* u, const float* zx, const float* v, const float* zy,
           const float* src, const void* tw, float* outr, float* outi,
           int ny, int nx, float beta, int tile_c, int cluster_k,
           int threads, int smem, int device, void* stream) {
  if (!xfb::xtile::plan_ok(ny, tile_c, cluster_k, threads, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (nx + tile_c - 1) / tile_c;
  return static_cast<int>(xfb::xtile::launch(
      ky_adv_kernel<FAST>, tiles, 1, cluster_k, threads, smem, device,
      static_cast<cudaStream_t>(stream), u, zx, v, zy, src,
      static_cast<const float2*>(tw),
      xfb::xtile::HalfOut{outr, outi, 0, 0, nx, ny / 2 + 1}, ny, cluster_k,
      xfb::xtile::log2i(tile_c), beta));
}

}  // namespace

// u, zx, v, zy, src: (ny, nx) y-major -> outr, outi: (nx, ny/2 + 1).
// tile_c, cluster_k, threads, smem: the plan of ops/xtile.py for ny.
extern "C" int xfb_ky_adv(const float* u, const float* zx, const float* v,
                          const float* zy, const float* src, const void* tw,
                          float* outr, float* outi, int ny, int nx,
                          float beta, int tile_c, int cluster_k, int threads,
                          int smem, int device, void* stream) {
  return launch<false>(u, zx, v, zy, src, tw, outr, outi, ny, nx, beta,
                       tile_c, cluster_k, threads, smem, device, stream);
}

// ky_adv on the fast column tile: arguments as xfb_ky_adv's
extern "C" int xfb_ky_adv_fast(const float* u, const float* zx,
                               const float* v, const float* zy,
                               const float* src, const void* tw, float* outr,
                               float* outi, int ny, int nx, float beta,
                               int tile_c, int cluster_k, int threads,
                               int smem, int device, void* stream) {
  return launch<true>(u, zx, v, zy, src, tw, outr, outi, ny, nx, beta,
                      tile_c, cluster_k, threads, smem, device, stream);
}
