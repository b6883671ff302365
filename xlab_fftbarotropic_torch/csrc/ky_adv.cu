// ky_adv: the advection product and the forward y-stage.
//
// Replaces pallas_fft.forward_tendency_yfirst / _ky_adv_kernel
// (xlab_fftbarotropic_tpu/ops/pallas_fft.py). For each physical column x
// of the y-major (ny, nx) fields it forms
//   adv[y] = -(u zx) - v zy + S            (zy + beta for beta != 0)
// in the TPU kernel's expression order, each product and sum rounded on
// its own (xfb::advection, the expression kb_adv shares), runs the
// forward colfft of the real column (zero imaginary part) and keeps rows
// k <= ny/2, written as out[x, k] of shape (nx, hny).
//
// Bound: memory traffic, about 403 MB per call at 4096^2 (5 planes in,
// 2 half planes out). The five column reads are strided by nx; the row
// write is contiguous.
#include "colfft.cuh"
#include "epilogue.cuh"

namespace {

__global__ void ky_adv_kernel(const float* __restrict__ u,
                              const float* __restrict__ zx,
                              const float* __restrict__ v,
                              const float* __restrict__ zy,
                              const float* __restrict__ src,
                              const float2* __restrict__ tw,
                              float* __restrict__ outr,
                              float* __restrict__ outi, int ny, int logny,
                              int nx, float beta) {
  extern __shared__ float2 s[];
  const int x = blockIdx.x;
  for (int y = threadIdx.x; y < ny; y += blockDim.x) {
    const size_t off = static_cast<size_t>(y) * nx + x;
    const float adv =
        xfb::advection(u[off], zx[off], v[off], zy[off], src[off], beta);
    s[xfb::bitrev(y, logny)] = make_float2(adv, 0.f);
  }
  xfb::colfft<-1>(s, ny, logny, tw);
  const int hny = ny / 2 + 1;
  const size_t row = static_cast<size_t>(x) * hny;
  for (int k = threadIdx.x; k < hny; k += blockDim.x) {
    const float2 val = s[k];
    outr[row + k] = val.x;
    outi[row + k] = val.y;
  }
}

}  // namespace

extern "C" int xfb_ky_adv(const float* u, const float* zx, const float* v,
                          const float* zy, const float* src, const void* tw,
                          float* outr, float* outi, int ny, int nx,
                          float beta, int device, void* stream) {
  const size_t smem = static_cast<size_t>(ny) * sizeof(float2);
  cudaError_t err = xfb::prepare(reinterpret_cast<const void*>(ky_adv_kernel),
                                 device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ky_adv_kernel<<<nx, xfb::threads_for(ny), smem,
                  static_cast<cudaStream_t>(stream)>>>(
      u, zx, v, zy, src, static_cast<const float2*>(tw), outr, outi, ny,
      xfb::ilog2(ny), nx, beta);
  return static_cast<int>(cudaGetLastError());
}
