// ka_diag / ka6 / ka_quad: the derivative x-stage of one RK stage.
//
// Replaces pallas_fft.derivative_xstage_planes / _ka_diag_kernel
// (xlab_fftbarotropic_tpu/ops/pallas_fft.py:694) for the barotropic
// family, pallas_tracer.tracer_xstage_planes / _ka6_kernel
// (xlab_fftbarotropic_tpu/ops/pallas_tracer.py:57) for the tracer family,
// and the barotropic QUAD_MODE "quad" and "split" x-stages of
// pallas_fft.derivative_quad_planes: _ka4_kernel (:605, fields 0-3 in one
// call) and _ka2_kernel (:629, fields 0-1 "zderiv", then 2-3 "pderiv").
// From stacked spectral state planes S = sr + i si (nstate, n, hny) it
// forms the diagonal-scaled fields
//   f = 0..3:  i kx Z,  i ky Z,  -i ky psi,  i kx psi   (Z = S[0],
//                                                        psi = Z * rlap)
//   f = 4..5:  i kx Q,  i ky Q                          (Q = S[1])
// so field f reads state f / 4 and takes the diagonal of field f % 4,
// and writes their unnormalized inverse x-DFT transposed:
//   out[f, j, x] = sum_i D_f[i, j] S[f/4][i, j] exp(+2 pi i i x / n),
// wr, wi of shape (F, hny, n): F = 4 (ka_diag) or 6 (ka6). The diagonals
// keep the TPU kernel's grouping (diagonal first, then rlap) and the
// positive-Nyquist kx. ka_quad writes fields first .. first + count - 1
// of the four (F = count) in _ka4's and _ka2's grouping, psi first:
// psi = S * rlap, then ky * psi or kx * psi (PSI_FIRST), which rounds
// apart from ka_diag's.
//
// Bound: memory traffic. At 4096^2 ka_diag reads 3 planes of 33.6 MB and
// writes 8 (about 369 MB), ka6 reads 5 and writes 12 (about 571 MB).
// The column-tile transform of csrc/xtile.cuh, as ka (ka_kc.cu ka_kernel)
// runs it, with ka's plan for n (ops/xtile.py): a cluster of K blocks
// owns C adjacent columns j of one field; block r forms rows i = r + K jj
// of the field's tile from the state, rlap and the kx/ky tables, read in
// row segments of C floats (xtile.cuh load_rows: plain loads, since
// cp.async cannot compute the diagonal), and the transposed store writes each output row j in runs
// of contiguous x, through ka's store at scale 1 (exact), so ka of the
// fields formed in torch gives the same bits. The last of the
// ceil(hny / C) tiles holds one column (hny = n/2 + 1 is odd): its loads
// read 0 and its stores are skipped. The cluster index decodes as (tile,
// field), field fastest, so the clusters that read a tile's columns run
// together and all but the first of each state find them in L2 (the
// state, rlap and tables exceed L2 at 4096^2; with the fields on grid y,
// each one's tiles in turn, ka_diag took 0.495 ms against 0.457 on an
// H100, PERF.md).
#include "xtile.cuh"

namespace {

// cluster (tile, f) of field f = cluster mod nfields: columns j0 .. j0 + C;
// block r of it forms rows r + k jj of the tile, consecutive lanes on
// consecutive columns
template <bool PSI_FIRST>
__global__ void __launch_bounds__(512, 2)
    ka_fields_kernel(const float* __restrict__ sr,
                     const float* __restrict__ si,
                     const float* __restrict__ rlap,
                     const float* __restrict__ kx,
                     const float* __restrict__ ky,
                     const float2* __restrict__ tw, xfb::xtile::RowOut out,
                     int n, int k, int logc, int first, int nfields) {
  extern __shared__ float2 smem[];
  namespace xt = xfb::xtile;
  const xt::Tile t = xt::begin(smem, tw, n, k, logc);
  const int hny = out.m;
  const int cluster = blockIdx.x / k;
  const int f = cluster % nfields;  // output field
  const int j0 = (cluster / nfields) << logc;
  const int g = f + first;          // which of the fields
  const int kind = g & 3;
  const size_t state = static_cast<size_t>(g >> 2) * n * hny;
  xt::load_rows(t, j0, hny, [&](int i, int j, size_t off) {
    const float a = __ldg(sr + state + off);
    const float b = __ldg(si + state + off);
    if (kind == 0) {          // i kx S
      const float q = __ldg(kx + i);
      return make_float2(-(b * q), a * q);
    }
    if (kind == 1) {          // i ky S
      const float q = __ldg(ky + j);
      return make_float2(-(b * q), a * q);
    }
    const float r = __ldg(rlap + off);
    if (kind == 2) {          // -i ky psi
      const float q = __ldg(ky + j);
      return PSI_FIRST ? make_float2(q * (b * r), -(q * (a * r)))
                       : make_float2((b * q) * r, -(a * q) * r);
    }
    const float q = __ldg(kx + i);   // i kx psi
    return PSI_FIRST ? make_float2(-(q * (b * r)), q * (a * r))
                     : make_float2(-(b * q) * r, (a * q) * r);
  });
  __syncthreads();
  xt::RowOut o = out;
  o.j0 = j0;
  o.plane = static_cast<size_t>(f) * hny * n;
  xt::finish_transposed<+1>(t, tw, false, o);
}

template <bool PSI_FIRST>
int launch(int nfields, const float* sr, const float* si, const float* rlap,
           const float* kx, const float* ky, const void* tw, float* wr,
           float* wi, int n, int hny, int first, int tile_c, int cluster_k,
           int threads, int smem, int device, void* stream) {
  if (!xfb::xtile::plan_ok(n, tile_c, cluster_k, threads, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (hny + tile_c - 1) / tile_c;
  return static_cast<int>(xfb::xtile::launch(
      ka_fields_kernel<PSI_FIRST>, tiles * nfields, 1, cluster_k,
      threads, smem, device, static_cast<cudaStream_t>(stream), sr, si, rlap,
      kx, ky, static_cast<const float2*>(tw),
      xfb::xtile::RowOut{wr, wi, 0, 0, hny, n, 1.f}, n, cluster_k,
      xfb::xtile::log2i(tile_c), first, nfields));
}

}  // namespace

// zr, zi: (n, hny) -> wr, wi: (4, hny, n). tile_c, cluster_k, threads,
// smem: the plan of ops/xtile.py for n
extern "C" int xfb_ka_diag(const float* zr, const float* zi,
                           const float* rlap, const float* kx,
                           const float* ky, const void* tw, float* wr,
                           float* wi, int n, int hny, int tile_c,
                           int cluster_k, int threads, int smem,
                           int device, void* stream) {
  return launch<false>(4, zr, zi, rlap, kx, ky, tw, wr, wi, n, hny, 0,
                       tile_c, cluster_k, threads, smem, device, stream);
}

// sr2, si2: (2, n, hny) -> wr, wi: (6, hny, n)
extern "C" int xfb_ka6(const float* sr2, const float* si2, const float* rlap,
                       const float* kx, const float* ky, const void* tw,
                       float* wr, float* wi, int n, int hny, int tile_c,
                       int cluster_k, int threads, int smem,
                       int device, void* stream) {
  return launch<false>(6, sr2, si2, rlap, kx, ky, tw, wr, wi, n, hny, 0,
                       tile_c, cluster_k, threads, smem, device, stream);
}

// zr, zi: (n, hny) -> wr, wi: (count, hny, n), fields first..first+count-1
// in the psi-first grouping
extern "C" int xfb_ka_quad(const float* zr, const float* zi,
                           const float* rlap, const float* kx,
                           const float* ky, const void* tw, float* wr,
                           float* wi, int n, int hny, int first, int count,
                           int tile_c, int cluster_k, int threads, int smem,
                           int device, void* stream) {
  return launch<true>(count, zr, zi, rlap, kx, ky, tw, wr, wi, n, hny, first,
                      tile_c, cluster_k, threads, smem, device, stream);
}
