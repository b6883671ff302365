// kx_visc: the forward x-stage with the viscosity and dealias epilogue,
// optionally fused with the RK stage-state update.
//
// Replaces pallas_fft.forward_tail / _kx_visc_kernel
// (xlab_fftbarotropic_tpu/ops/pallas_fft.py:1654) for the barotropic
// family (one field) and pallas_tracer.forward_tail_tracer /
// _kx_visc_tracer_kernel (xlab_fftbarotropic_tpu/ops/pallas_tracer.py:206)
// for the tracer family (two stacked fields, nu = 1 with the stacked
// diffusion table), and, with no epilogue, pallas_sw.forward_tendencies'
// KX stage / _kx_fwd_kernel (xlab_fftbarotropic_tpu/ops/pallas_sw.py:565)
// for the shallow-water family (five stacked product fields, the raw
// forward transform: about 671 MB per call at 4096^2, 10 half planes in
// and out). For each field f and spectral column j it runs the
// forward colfft of (fr + i fi)[f, :, j] and applies the epilogue of
// _visc_epilogue in its order:
//   nulap = nu * lap[f];  r = mask * (F + nulap * Zs[f])
// writing rr, ri of shape (F, nx, hny); with z0 given (the stage axpy)
// also n = z0 + coef * r. The axpy rounds the product and the sum
// separately (__fmul_rn, __fadd_rn), as the unfused torch arithmetic
// does, so the fused and unfused RK forms give the same bits.
//
// Bound: memory traffic, per field about 268 MB at 4096^2 (6 half
// planes in, 2 out), 403 MB with the axpy (2 more in, 2 more out).
// Every plane is read and written along column j, strided by hny, in
// this simple form.
#include "colfft.cuh"

namespace {

__global__ void kx_visc_kernel(const float* __restrict__ fr,
                               const float* __restrict__ fi,
                               const float* __restrict__ lap,
                               const float* __restrict__ mask,
                               const float* __restrict__ zsr,
                               const float* __restrict__ zsi,
                               const float* __restrict__ z0r,
                               const float* __restrict__ z0i,
                               const float2* __restrict__ tw,
                               float* __restrict__ rr,
                               float* __restrict__ ri,
                               float* __restrict__ nr,
                               float* __restrict__ ni, int nx, int lognx,
                               int hny, float nu, float coef) {
  extern __shared__ float2 s[];
  const int j = blockIdx.x;
  const size_t plane = static_cast<size_t>(blockIdx.y) * nx * hny;
  for (int i = threadIdx.x; i < nx; i += blockDim.x) {
    const size_t off = plane + static_cast<size_t>(i) * hny + j;
    s[xfb::bitrev(i, lognx)] = make_float2(fr[off], fi[off]);
  }
  xfb::colfft<-1>(s, nx, lognx, tw);
  for (int i = threadIdx.x; i < nx; i += blockDim.x) {
    const size_t moff = static_cast<size_t>(i) * hny + j;
    const size_t off = plane + moff;
    const float2 f = s[i];
    if (lap == nullptr) {  // kx_fwd: the raw transform, no epilogue
      rr[off] = f.x;
      ri[off] = f.y;
      continue;
    }
    const float nulap = nu * lap[off];
    const float m = mask[moff];
    const float r_re = m * (f.x + nulap * zsr[off]);
    const float r_im = m * (f.y + nulap * zsi[off]);
    rr[off] = r_re;
    ri[off] = r_im;
    if (z0r != nullptr) {
      nr[off] = __fadd_rn(z0r[off], __fmul_rn(coef, r_re));
      ni[off] = __fadd_rn(z0i[off], __fmul_rn(coef, r_im));
    }
  }
}

}  // namespace

// fr, fi, lap, zsr, zsi (and z0r, z0i, rr, ri, nr, ni): (nfields, nx, hny);
// mask: (nx, hny). z0r = z0i = nr = ni = NULL: no stage axpy. lap = NULL
// (and mask, zsr, zsi, z0r, z0i NULL): no epilogue at all, rr + i ri is
// the forward x-DFT itself (kx_fwd, the shallow-water forward x-stage).
extern "C" int xfb_kx_visc(const float* fr, const float* fi,
                           const float* lap, const float* mask,
                           const float* zsr, const float* zsi,
                           const float* z0r, const float* z0i,
                           const void* tw, float* rr, float* ri, float* nr,
                           float* ni, int nfields, int nx, int hny,
                           float nu, float coef, int device, void* stream) {
  const size_t smem = static_cast<size_t>(nx) * sizeof(float2);
  cudaError_t err = xfb::prepare(reinterpret_cast<const void*>(kx_visc_kernel),
                                 device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kx_visc_kernel<<<dim3(hny, nfields), xfb::threads_for(nx), smem,
                   static_cast<cudaStream_t>(stream)>>>(
      fr, fi, lap, mask, zsr, zsi, z0r, z0i, static_cast<const float2*>(tw),
      rr, ri, nr, ni, nx, xfb::ilog2(nx), hny, nu, coef);
  return static_cast<int>(cudaGetLastError());
}
