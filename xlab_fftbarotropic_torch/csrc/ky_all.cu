// ky_all: the shallow-water products and their forward y-stages.
//
// Replaces pallas_sw.forward_tendencies' KY stage: _ky_all_loop_kernel
// (xlab_fftbarotropic_tpu/ops/pallas_sw.py:533, the default at 4096^2),
// _ky_all_kernel (:513, the default up to 2048^2) and _ky_fwd_kernel
// (:489, XFB_SW_KYALL=0), three TPU schedules of one function. For each
// physical column x of the y-major (ny, nx) fields u, v, zeta, eta_s it
// forms, in the TPU kernels' expressions,
//   eta = eta_s * ies          (ies = 1 / eta_scale, exact)
//   q   = zeta + f0            (zeta alone when split)
//   phi = g * eta + ke         (ke alone when split), ke = 0.5 (u u + v v)
// and the five products q u, q v, eta u, eta v, phi one after another;
// each goes through the forward colfft of the real column, and rows
// k <= ny/2 are written to out[p, x, k] (5, nx, hny).
//
// Each product gets its own transform: packing two real products into
// one complex FFT would give the smaller one the larger one's round-off,
// and the products differ by orders (q u about 1e-3, phi about 50 in the
// bench configuration). The block reads its four input columns once and
// keeps them in shared memory beside the one ny-point work column:
// 24 * ny bytes, 96 KB at 4096 and 192 KB at 8192. (Re-reading them from
// L2 for each product instead took 3.76 against 2.48 ms at 4096^2 on an
// H100, with the same bits.)
//
// Bound: memory traffic, about 604 MB per call at 4096^2 (4 planes in,
// 10 half planes out). The column reads are strided by nx; the row
// writes are contiguous.
#include "colfft.cuh"

namespace {

__global__ void ky_all_kernel(const float* __restrict__ u,
                              const float* __restrict__ v,
                              const float* __restrict__ zeta,
                              const float* __restrict__ eta_s,
                              const float2* __restrict__ tw,
                              float* __restrict__ outr,
                              float* __restrict__ outi, int ny, int logny,
                              int nx, float ies, float f0, float grav,
                              int split) {
  extern __shared__ float2 s[];
  // the four input columns after the work column; each thread reads back
  // only the rows it stored itself, so no barrier is needed between
  float* const cu = reinterpret_cast<float*>(s + ny);
  float* const cv = cu + ny;
  float* const cz = cv + ny;
  float* const ce = cz + ny;
  const int x = blockIdx.x;
  const int hny = ny / 2 + 1;
  for (int y = threadIdx.x; y < ny; y += blockDim.x) {
    const size_t off = static_cast<size_t>(y) * nx + x;
    cu[y] = u[off];
    cv[y] = v[off];
    cz[y] = zeta[off];
    ce[y] = eta_s[off];
  }
  for (int p = 0; p < 5; ++p) {
    for (int y = threadIdx.x; y < ny; y += blockDim.x) {
      const float uu = cu[y], vv = cv[y];
      float val;
      if (p < 2) {
        const float q = split ? cz[y] : cz[y] + f0;
        val = q * (p == 0 ? uu : vv);
      } else if (p < 4) {
        const float eta = ce[y] * ies;
        val = eta * (p == 2 ? uu : vv);
      } else {
        const float ke = 0.5f * (uu * uu + vv * vv);
        val = split ? ke : grav * (ce[y] * ies) + ke;
      }
      s[xfb::bitrev(y, logny)] = make_float2(val, 0.f);
    }
    xfb::colfft<-1>(s, ny, logny, tw);
    const size_t row = (static_cast<size_t>(p) * nx + x) * hny;
    for (int k = threadIdx.x; k < hny; k += blockDim.x) {
      const float2 val = s[k];
      outr[row + k] = val.x;
      outi[row + k] = val.y;
    }
    __syncthreads();  // the next product overwrites the column
  }
}

}  // namespace

// u, v, zeta, eta_s: (ny, nx) -> outr, outi: (5, nx, ny/2 + 1)
extern "C" int xfb_ky_all(const float* u, const float* v, const float* zeta,
                          const float* eta_s, const void* tw, float* outr,
                          float* outi, int ny, int nx, float ies, float f0,
                          float grav, int split, int device, void* stream) {
  // the work column (float2) and the four input columns (float)
  const size_t smem = static_cast<size_t>(ny) * 3 * sizeof(float2);
  cudaError_t err = xfb::prepare(reinterpret_cast<const void*>(ky_all_kernel),
                                 device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ky_all_kernel<<<nx, xfb::threads_for(ny), smem,
                  static_cast<cudaStream_t>(stream)>>>(
      u, v, zeta, eta_s, static_cast<const float2*>(tw), outr, outi, ny,
      xfb::ilog2(ny), nx, ies, f0, grav, split);
  return static_cast<int>(cudaGetLastError());
}
