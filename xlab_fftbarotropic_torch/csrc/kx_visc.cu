// kx_visc: the forward x-stage with the viscosity and dealias epilogue.
//
// Replaces pallas_fft.forward_tail / _kx_visc_kernel with coef=None
// (xlab_fftbarotropic_tpu/ops/pallas_fft.py). For each of the hny
// spectral columns j it runs the forward colfft of (fr + i fi)[:, j] and
// applies the epilogue of _visc_epilogue in its order:
//   nulap = nu * lap;  r = mask * (F + nulap * Zs)
// writing rr, ri of shape (nx, hny). The stage-axpy (coef) and RK4-tail
// epilogues are not part of this kernel.
//
// Bound: memory traffic, about 268 MB per call at 4096^2 (6 half planes
// in, 2 out). Every plane is read and written along column j, strided by
// hny, in this simple form.
#include "colfft.cuh"

namespace {

__global__ void kx_visc_kernel(const float* __restrict__ fr,
                               const float* __restrict__ fi,
                               const float* __restrict__ lap,
                               const float* __restrict__ mask,
                               const float* __restrict__ zsr,
                               const float* __restrict__ zsi,
                               const float2* __restrict__ tw,
                               float* __restrict__ rr,
                               float* __restrict__ ri, int nx, int lognx,
                               int hny, float nu) {
  extern __shared__ float2 s[];
  const int j = blockIdx.x;
  for (int i = threadIdx.x; i < nx; i += blockDim.x) {
    const size_t off = static_cast<size_t>(i) * hny + j;
    s[xfb::bitrev(i, lognx)] = make_float2(fr[off], fi[off]);
  }
  xfb::colfft<-1>(s, nx, lognx, tw);
  for (int i = threadIdx.x; i < nx; i += blockDim.x) {
    const size_t off = static_cast<size_t>(i) * hny + j;
    const float2 f = s[i];
    const float nulap = nu * lap[off];
    const float m = mask[off];
    rr[off] = m * (f.x + nulap * zsr[off]);
    ri[off] = m * (f.y + nulap * zsi[off]);
  }
}

}  // namespace

extern "C" int xfb_kx_visc(const float* fr, const float* fi,
                           const float* lap, const float* mask,
                           const float* zsr, const float* zsi,
                           const void* tw, float* rr, float* ri, int nx,
                           int hny, float nu, int device, void* stream) {
  const size_t smem = static_cast<size_t>(nx) * sizeof(float2);
  cudaError_t err = xfb::prepare(reinterpret_cast<const void*>(kx_visc_kernel),
                                 device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kx_visc_kernel<<<hny, xfb::threads_for(nx), smem,
                   static_cast<cudaStream_t>(stream)>>>(
      fr, fi, lap, mask, zsr, zsi, static_cast<const float2*>(tw), rr, ri,
      nx, xfb::ilog2(nx), hny, nu);
  return static_cast<int>(cudaGetLastError());
}
