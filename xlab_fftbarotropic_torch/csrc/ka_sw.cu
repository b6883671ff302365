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
// needed here), and writes their unnormalized inverse x-DFT transposed:
// wr, wi of shape (4, hny, n).
//
// Bound: memory traffic. At 4096^2 it reads 7 planes of 33.6 MB and
// writes 8 (about 504 MB). Block (f, j) transforms column j of field f;
// the column reads are strided by hny, the row write is contiguous. The
// field index is the fastest grid axis, so the four blocks that read
// column j run together and all but the first find it in L2.
#include "colfft.cuh"

namespace {

__global__ void ka_sw_kernel(const float* __restrict__ zr,
                             const float* __restrict__ zi,
                             const float* __restrict__ dr,
                             const float* __restrict__ di,
                             const float* __restrict__ er,
                             const float* __restrict__ ei,
                             const float* __restrict__ rlap,
                             const float* __restrict__ kx,
                             const float* __restrict__ ky,
                             const float2* __restrict__ tw,
                             float* __restrict__ wr, float* __restrict__ wi,
                             int n, int logn, int hny, float eta_scale) {
  extern __shared__ float2 s[];
  const int f = blockIdx.x;
  const int j = blockIdx.y;
  const float q = ky[j];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const size_t off = static_cast<size_t>(i) * hny + j;
    float xr, xi;
    if (f == 0) {          // u = -i ky rlap Z + i kx rlap D
      const float k = kx[i], r = rlap[off];
      const float a = zr[off], b = zi[off], c = dr[off], d = di[off];
      xr = (b * q) * r - (d * k) * r;
      xi = -((a * q) * r) + (c * k) * r;
    } else if (f == 1) {   // v = i kx rlap Z + i ky rlap D
      const float k = kx[i], r = rlap[off];
      const float a = zr[off], b = zi[off], c = dr[off], d = di[off];
      xr = -((b * k) * r) - (d * q) * r;
      xi = (a * k) * r + (c * q) * r;
    } else if (f == 2) {   // zeta = Z
      xr = zr[off];
      xi = zi[off];
    } else {               // eta_s = eta_scale * E
      xr = er[off] * eta_scale;
      xi = ei[off] * eta_scale;
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

// zr .. ei, rlap: (n, hny); kx: (n,); ky: (hny,) -> wr, wi: (4, hny, n)
extern "C" int xfb_ka_sw(const float* zr, const float* zi, const float* dr,
                         const float* di, const float* er, const float* ei,
                         const float* rlap, const float* kx, const float* ky,
                         const void* tw, float* wr, float* wi, int n, int hny,
                         float eta_scale, int device, void* stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float2);
  cudaError_t err = xfb::prepare(reinterpret_cast<const void*>(ka_sw_kernel),
                                 device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ka_sw_kernel<<<dim3(4, hny), xfb::threads_for(n), smem,
                 static_cast<cudaStream_t>(stream)>>>(
      zr, zi, dr, di, er, ei, rlap, kx, ky, static_cast<const float2*>(tw),
      wr, wi, n, xfb::ilog2(n), hny, eta_scale);
  return static_cast<int>(cudaGetLastError());
}
