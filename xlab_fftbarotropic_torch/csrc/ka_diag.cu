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
// Block (f, j) transforms column j of field f; the column read is
// strided by hny, the row write is contiguous. The field index is the
// fastest grid axis, so the blocks that read column j run together and
// all but the first of each state find it in L2.
#include "colfft.cuh"

namespace {

template <bool PSI_FIRST>
__global__ void ka_fields_kernel(const float* __restrict__ sr,
                                 const float* __restrict__ si,
                                 const float* __restrict__ rlap,
                                 const float* __restrict__ kx,
                                 const float* __restrict__ ky,
                                 const float2* __restrict__ tw,
                                 float* __restrict__ wr,
                                 float* __restrict__ wi,
                                 int n, int logn, int hny, int first) {
  extern __shared__ float2 s[];
  const int f = blockIdx.x;           // output field
  const int g = f + first;            // which of the fields it is
  const int kind = g & 3;
  const size_t state = static_cast<size_t>(g >> 2) * n * hny;
  const int j = blockIdx.y;
  const float kyj = ky[j];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const size_t off = static_cast<size_t>(i) * hny + j;
    const float a = sr[state + off];
    const float b = si[state + off];
    float xr, xi;
    if (kind == 0) {          // i kx S
      const float k = kx[i];
      xr = -(b * k);
      xi = a * k;
    } else if (kind == 1) {   // i ky S
      xr = -(b * kyj);
      xi = a * kyj;
    } else if (kind == 2) {   // -i ky psi
      const float r = rlap[off];
      xr = PSI_FIRST ? kyj * (b * r) : (b * kyj) * r;
      xi = PSI_FIRST ? -(kyj * (a * r)) : -(a * kyj) * r;
    } else {                  // i kx psi
      const float k = kx[i];
      const float r = rlap[off];
      xr = PSI_FIRST ? -(k * (b * r)) : -(b * k) * r;
      xi = PSI_FIRST ? k * (a * r) : (a * k) * r;
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

template <bool PSI_FIRST>
int launch(int nfields, const float* sr, const float* si, const float* rlap,
           const float* kx, const float* ky, const void* tw, float* wr,
           float* wi, int n, int hny, int first, int device, void* stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float2);
  cudaError_t err = xfb::prepare(
      reinterpret_cast<const void*>(ka_fields_kernel<PSI_FIRST>), device,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ka_fields_kernel<PSI_FIRST><<<dim3(nfields, hny), xfb::threads_for(n),
                                smem, static_cast<cudaStream_t>(stream)>>>(
      sr, si, rlap, kx, ky, static_cast<const float2*>(tw), wr, wi, n,
      xfb::ilog2(n), hny, first);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// zr, zi: (n, hny) -> wr, wi: (4, hny, n)
extern "C" int xfb_ka_diag(const float* zr, const float* zi,
                           const float* rlap, const float* kx,
                           const float* ky, const void* tw, float* wr,
                           float* wi, int n, int hny, int device,
                           void* stream) {
  return launch<false>(4, zr, zi, rlap, kx, ky, tw, wr, wi, n, hny, 0,
                       device, stream);
}

// sr2, si2: (2, n, hny) -> wr, wi: (6, hny, n)
extern "C" int xfb_ka6(const float* sr2, const float* si2, const float* rlap,
                       const float* kx, const float* ky, const void* tw,
                       float* wr, float* wi, int n, int hny, int device,
                       void* stream) {
  return launch<false>(6, sr2, si2, rlap, kx, ky, tw, wr, wi, n, hny, 0,
                       device, stream);
}

// zr, zi: (n, hny) -> wr, wi: (count, hny, n), fields first..first+count-1
// in the psi-first grouping
extern "C" int xfb_ka_quad(const float* zr, const float* zi,
                           const float* rlap, const float* kx,
                           const float* ky, const void* tw, float* wr,
                           float* wi, int n, int hny, int first, int count,
                           int device, void* stream) {
  return launch<true>(count, zr, zi, rlap, kx, ky, tw, wr, wi, n, hny, first,
                      device, stream);
}
