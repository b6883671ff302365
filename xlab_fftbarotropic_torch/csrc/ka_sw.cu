// ka_sw: the shallow-water inverse x-stage of one RK stage.
//
// Replaces pallas_sw.inverse_quad_planes' KA stage, _ka_sw_kernel
// (xlab_fftbarotropic_tpu/ops/pallas_sw.py:217) and its two-call split
// _ka_sw2_kernel (:245, a TPU VMEM workaround that computes the same
// function). From the six state planes (zr, zi, dr, di, er, ei) of
// Z = zeta_hat, D = div_hat, E = eta_hat (n, hny) it forms
//   f = 0:  u     = -i ky rlap Z + i kx rlap D
//   f = 1:  v     =  i kx rlap Z + i ky rlap D
//   f = 2:  zeta  =  Z
//   f = 3:  eta_s =  eta_scale * E   (the pairing equalizer, a power of 2)
// written directly (the TPU kernel's stacked one-hot factor data is not
// needed here), each product and sum rounded on its own in the order of
// ops/fused_sw.py sw_fields, and writes their unnormalized inverse x-DFT
// transposed: wr, wi of shape (4, hny, n).
//
// Bound: memory traffic. At 4096^2 it reads 7 planes of 33.6 MB and
// writes 8 (about 504 MB). The column-tile transform of csrc/xtile.cuh
// with ka's plan for n (ops/xtile.py), as ka_diag.cu's field x-stages run
// it: a cluster of K blocks owns C adjacent columns j of one field; block
// r forms rows i = r + K jj of the field's tile from the state, rlap and
// the kx/ky tables, read in row segments of C floats (xtile.cuh
// load_rows), and the transposed store writes each output row j in runs
// of contiguous x, through ka's store at scale 1 (exact), so ka of the
// fields formed in torch gives the same bits. The cluster index decodes
// as (tile, field), field fastest, so the four clusters of a tile share
// its columns of zr, zi, dr, di and rlap in L2. The last of the ceil(hny
// / C) tiles holds one column (hny = n/2 + 1 is odd): its loads read 0 and
// its stores are skipped, so no row lands in the next field's plane.
#include "xtile.cuh"

namespace {

// Field f of the state at row i, column j (off = i hny + j)
__device__ __forceinline__ float2 sw_field(
    int f, const float* __restrict__ zr, const float* __restrict__ zi,
    const float* __restrict__ dr, const float* __restrict__ di,
    const float* __restrict__ er, const float* __restrict__ ei,
    const float* __restrict__ rlap, const float* __restrict__ kx,
    const float* __restrict__ ky, int i, int j, size_t off,
    float eta_scale) {
  if (f == 2) return make_float2(__ldg(zr + off), __ldg(zi + off));
  if (f == 3) {
    return make_float2(__fmul_rn(__ldg(er + off), eta_scale),
                       __fmul_rn(__ldg(ei + off), eta_scale));
  }
  const float k = __ldg(kx + i), q = __ldg(ky + j), r = __ldg(rlap + off);
  const float a = __ldg(zr + off), b = __ldg(zi + off);
  const float c = __ldg(dr + off), d = __ldg(di + off);
  if (f == 0) {            // u = -i ky rlap Z + i kx rlap D
    return make_float2(
        __fsub_rn(__fmul_rn(__fmul_rn(b, q), r),
                  __fmul_rn(__fmul_rn(d, k), r)),
        __fadd_rn(-__fmul_rn(__fmul_rn(a, q), r),
                  __fmul_rn(__fmul_rn(c, k), r)));
  }
  return make_float2(      // v = i kx rlap Z + i ky rlap D
      __fsub_rn(-__fmul_rn(__fmul_rn(b, k), r),
                __fmul_rn(__fmul_rn(d, q), r)),
      __fadd_rn(__fmul_rn(__fmul_rn(a, k), r),
                __fmul_rn(__fmul_rn(c, q), r)));
}

// cluster (tile, f) of field f = cluster mod 4: columns j0 .. j0 + C;
// block r of it forms rows r + k jj of the tile, consecutive lanes on
// consecutive columns
__global__ void __launch_bounds__(512, 2)
    ka_sw_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
                 const float* __restrict__ dr, const float* __restrict__ di,
                 const float* __restrict__ er, const float* __restrict__ ei,
                 const float* __restrict__ rlap,
                 const float* __restrict__ kx, const float* __restrict__ ky,
                 const float2* __restrict__ tw, xfb::xtile::RowOut out,
                 int n, int k, int logc, float eta_scale) {
  extern __shared__ float2 smem[];
  namespace xt = xfb::xtile;
  const xt::Tile t = xt::begin(smem, tw, n, k, logc);
  const int hny = out.m;
  const int cluster = blockIdx.x / k;
  const int f = cluster & 3;
  const int j0 = (cluster >> 2) << logc;
  xt::load_rows(t, j0, hny, [&](int i, int j, size_t off) {
    return sw_field(f, zr, zi, dr, di, er, ei, rlap, kx, ky, i, j, off,
                    eta_scale);
  });
  __syncthreads();
  xt::RowOut o = out;
  o.j0 = j0;
  o.plane = static_cast<size_t>(f) * hny * n;
  xt::finish_transposed<+1>(t, tw, false, o);
}

}  // namespace

// zr .. ei, rlap: (n, hny); kx: (n,); ky: (hny,) -> wr, wi: (4, hny, n).
// tile_c, cluster_k, threads, smem: the plan of ops/xtile.py for n
extern "C" int xfb_ka_sw(const float* zr, const float* zi, const float* dr,
                         const float* di, const float* er, const float* ei,
                         const float* rlap, const float* kx, const float* ky,
                         const void* tw, float* wr, float* wi, int n, int hny,
                         float eta_scale, int tile_c, int cluster_k,
                         int threads, int smem, int device, void* stream) {
  if (!xfb::xtile::plan_ok(n, tile_c, cluster_k, threads, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (hny + tile_c - 1) / tile_c;
  return static_cast<int>(xfb::xtile::launch(
      ka_sw_kernel, tiles * 4, 1, cluster_k, threads, smem, device,
      static_cast<cudaStream_t>(stream), zr, zi, dr, di, er, ei, rlap, kx,
      ky, static_cast<const float2*>(tw),
      xfb::xtile::RowOut{wr, wi, 0, 0, hny, n, 1.f}, n, cluster_k,
      xfb::xtile::log2i(tile_c), eta_scale));
}
