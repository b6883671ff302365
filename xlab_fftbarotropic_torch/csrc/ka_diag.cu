// ka_diag: the derivative x-stage of one RK stage.
//
// Replaces pallas_fft.derivative_xstage_planes / _ka_diag_kernel
// (xlab_fftbarotropic_tpu/ops/pallas_fft.py). From the spectral state
// planes Z = zr + i zi (n, hny) it forms the four diagonal-scaled fields
//   i kx Z,  i ky Z,  -i ky psi,  i kx psi      (psi = Z * rlap)
// and writes their unnormalized inverse x-DFT transposed:
//   out[f, j, x] = sum_i D_f[i, j] Z[i, j] exp(+2 pi i i x / n),
// wr, wi of shape (4, hny, n). The diagonals keep the TPU kernel's
// grouping (diagonal first, then rlap) and the positive-Nyquist kx.
//
// Bound: memory traffic. At 4096^2 one call reads 3 planes of 33.6 MB
// and writes 8 (about 369 MB). Block (f, j) transforms column j of field
// f; the column read is strided by hny, the row write is contiguous.
// The field index is the fastest grid axis, so the four blocks that read
// column j run together and three of them find it in L2.
#include "colfft.cuh"

namespace {

__global__ void ka_diag_kernel(const float* __restrict__ zr,
                               const float* __restrict__ zi,
                               const float* __restrict__ rlap,
                               const float* __restrict__ kx,
                               const float* __restrict__ ky,
                               const float2* __restrict__ tw,
                               float* __restrict__ wr,
                               float* __restrict__ wi,
                               int n, int logn, int hny) {
  extern __shared__ float2 s[];
  const int f = blockIdx.x;
  const int j = blockIdx.y;
  const float kyj = ky[j];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const size_t off = static_cast<size_t>(i) * hny + j;
    const float a = zr[off];
    const float b = zi[off];
    float xr, xi;
    if (f == 0) {          // i kx Z
      const float k = kx[i];
      xr = -(b * k);
      xi = a * k;
    } else if (f == 1) {   // i ky Z
      xr = -(b * kyj);
      xi = a * kyj;
    } else if (f == 2) {   // -i ky psi
      const float r = rlap[off];
      xr = (b * kyj) * r;
      xi = -(a * kyj) * r;
    } else {               // i kx psi
      const float k = kx[i];
      const float r = rlap[off];
      xr = -(b * k) * r;
      xi = (a * k) * r;
    }
    s[xfb::bitrev(i, logn)] = make_float2(xr, xi);
  }
  xfb::colfft<+1>(s, n, logn, tw);
  const size_t row = (static_cast<size_t>(f) * hny + j) * n;
  for (int x = threadIdx.x; x < n; x += blockDim.x) {
    const float2 v = s[x];
    wr[row + x] = v.x;
    wi[row + x] = v.y;
  }
}

}  // namespace

extern "C" int xfb_ka_diag(const float* zr, const float* zi,
                           const float* rlap, const float* kx,
                           const float* ky, const void* tw, float* wr,
                           float* wi, int n, int hny, int device,
                           void* stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float2);
  cudaError_t err = xfb::prepare(reinterpret_cast<const void*>(ka_diag_kernel),
                                 device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ka_diag_kernel<<<dim3(4, hny), xfb::threads_for(n), smem,
                   static_cast<cudaStream_t>(stream)>>>(
      zr, zi, rlap, kx, ky, static_cast<const float2*>(tw), wr, wi, n,
      xfb::ilog2(n), hny);
  return static_cast<int>(cudaGetLastError());
}
