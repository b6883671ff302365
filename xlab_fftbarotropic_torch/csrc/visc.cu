// visc: the viscosity and dealias epilogue as an elementwise pass of its
// own, optionally with the RK stage-state update.
//
// Replaces pallas_fft._visc_kernel and _visc_axpy_kernel
// (xlab_fftbarotropic_tpu/ops/pallas_fft.py:1544, :1551), the VISC half
// of the unfused forward tail (XFB_BT_FUSEKX=0; its KX half is kx_fwd on
// one field, csrc/kx_visc.cu). On (nx, hny) planes:
//   r = mask * (F + nu lap Z)            (xfb::visc)
// and with z0 given also n = z0 + coef * r (xfb::axpy): the expressions
// kx_visc's epilogue runs, from csrc/epilogue.cuh, so the two forms of
// the forward tail give the same bits.
//
// Bound: memory traffic, about 268 MB per call at 4096^2 (6 half planes
// in, 2 out), 403 MB with the axpy (8 in, 4 out). A grid-stride loop with
// consecutive threads on consecutive elements: every access coalesced.
#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void visc_kernel(const float* __restrict__ fr,
                            const float* __restrict__ fi,
                            const float* __restrict__ lap,
                            const float* __restrict__ mask,
                            const float* __restrict__ zr,
                            const float* __restrict__ zi,
                            const float* __restrict__ z0r,
                            const float* __restrict__ z0i,
                            float* __restrict__ rr, float* __restrict__ ri,
                            float* __restrict__ nr, float* __restrict__ ni,
                            long long numel, float nu, float coef) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < numel; i += stride) {
    const float2 r = xfb::visc(nu, lap[i], mask[i],
                               make_float2(fr[i], fi[i]), zr[i], zi[i]);
    rr[i] = r.x;
    ri[i] = r.y;
    if (z0r != nullptr) {
      nr[i] = xfb::axpy(z0r[i], coef, r.x);
      ni[i] = xfb::axpy(z0i[i], coef, r.y);
    }
  }
}

}  // namespace

// Every pointer: a plane of numel floats. z0r = z0i = nr = ni = NULL: no
// stage axpy.
extern "C" int xfb_visc(const float* fr, const float* fi, const float* lap,
                        const float* mask, const float* zr, const float* zi,
                        const float* z0r, const float* z0i, float* rr,
                        float* ri, float* nr, float* ni, long long numel,
                        float nu, float coef, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (numel + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;  // grid-stride beyond ~31 blocks/SM
  if (blocks < 1) blocks = 1;
  visc_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      fr, fi, lap, mask, zr, zi, z0r, z0i, rr, ri, nr, ni, numel, nu, coef);
  return static_cast<int>(cudaGetLastError());
}
