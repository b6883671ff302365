// kx_visc: the forward x-stage with the viscosity and dealias epilogue,
// optionally fused with the RK stage-state update or the RK4 tail.
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
// and out) and for the barotropic XFB_BT_FUSEKX=0 form
// (pallas_fft._kx_fwd_bt_kernel, :1521, one field; visc.cu applies its
// epilogue). For each field f and spectral column j it runs the
// forward colfft of (fr + i fi)[f, :, j] and applies the epilogue of
// _visc_epilogue in its order:
//   nulap = nu * lap[f];  r = mask * (F + nulap * Zs[f])
// writing rr, ri of shape (F, nx, hny); with z0 given (the stage axpy)
// also n = z0 + coef * r. xfb_kx_visc_tail replaces
// pallas_fft._kx_visc_tail_kernel (:1677, XFB_BT_FUSETAIL=1): the
// epilogue then reads z0, r1, r2, r3 and writes only the stepped state
// n = z0 + (r1 + 2 r2 + 2 r3 + r) * c, so stage 4's tendency r never
// reaches memory and the rk4_combine launch goes. Every epilogue rounds
// each product and sum on its own (csrc/epilogue.cuh), as the unfused
// torch arithmetic, visc and rk4_combine do, so the fused and unfused
// forms give the same bits.
//
// Bound: memory traffic, per field about 268 MB at 4096^2 (6 half
// planes in, 2 out), 403 MB with the axpy (2 more in, 2 more out), 537
// MB with the tail (14 in, 2 out). Every plane is read and written along
// column j, strided by hny, in this simple form.
#include "colfft.cuh"
#include "epilogue.cuh"

namespace {

// The RK4 tail's tendencies of stages 1-3 (z0 is kx_visc's z0r, z0i);
// r1r == nullptr: no tail.
struct Tail {
  const float* r1r;
  const float* r1i;
  const float* r2r;
  const float* r2i;
  const float* r3r;
  const float* r3i;
  float c;
};

__global__ void kx_visc_kernel(const float* __restrict__ fr,
                               const float* __restrict__ fi,
                               const float* __restrict__ lap,
                               const float* __restrict__ mask,
                               const float* __restrict__ zsr,
                               const float* __restrict__ zsi,
                               const float* __restrict__ z0r,
                               const float* __restrict__ z0i, Tail tail,
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
    const float2 r = xfb::visc(nu, lap[off], mask[moff], f, zsr[off],
                               zsi[off]);
    if (tail.r1r != nullptr) {  // the RK4 tail: n only, r stays here
      nr[off] = xfb::rk4_tail(z0r[off], tail.r1r[off], tail.r2r[off],
                              tail.r3r[off], r.x, tail.c);
      ni[off] = xfb::rk4_tail(z0i[off], tail.r1i[off], tail.r2i[off],
                              tail.r3i[off], r.y, tail.c);
      continue;
    }
    rr[off] = r.x;
    ri[off] = r.y;
    if (z0r != nullptr) {
      nr[off] = xfb::axpy(z0r[off], coef, r.x);
      ni[off] = xfb::axpy(z0i[off], coef, r.y);
    }
  }
}

int launch(const float* fr, const float* fi, const float* lap,
           const float* mask, const float* zsr, const float* zsi,
           const float* z0r, const float* z0i, Tail tail, const void* tw,
           float* rr, float* ri, float* nr, float* ni, int nfields, int nx,
           int hny, float nu, float coef, int device, void* stream) {
  const size_t smem = static_cast<size_t>(nx) * sizeof(float2);
  cudaError_t err = xfb::prepare(reinterpret_cast<const void*>(kx_visc_kernel),
                                 device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kx_visc_kernel<<<dim3(hny, nfields), xfb::threads_for(nx), smem,
                   static_cast<cudaStream_t>(stream)>>>(
      fr, fi, lap, mask, zsr, zsi, z0r, z0i, tail,
      static_cast<const float2*>(tw), rr, ri, nr, ni, nx, xfb::ilog2(nx),
      hny, nu, coef);
  return static_cast<int>(cudaGetLastError());
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
  return launch(fr, fi, lap, mask, zsr, zsi, z0r, z0i, Tail{}, tw, rr, ri,
                nr, ni, nfields, nx, hny, nu, coef, device, stream);
}

// The tail form: every plane (nfields, nx, hny) but mask (nx, hny); writes
// nr, ni = z0 + (r1 + 2 r2 + 2 r3 + r) * c, where r is the epilogue's
// tendency (never written).
extern "C" int xfb_kx_visc_tail(const float* fr, const float* fi,
                                const float* lap, const float* mask,
                                const float* zsr, const float* zsi,
                                const float* z0r, const float* z0i,
                                const float* r1r, const float* r1i,
                                const float* r2r, const float* r2i,
                                const float* r3r, const float* r3i,
                                const void* tw, float* nr, float* ni,
                                int nfields, int nx, int hny, float nu,
                                float c, int device, void* stream) {
  return launch(fr, fi, lap, mask, zsr, zsi, z0r, z0i,
                Tail{r1r, r1i, r2r, r2i, r3r, r3i, c}, tw, nullptr, nullptr,
                nr, ni, nfields, nx, hny, nu, 0.f, device, stream);
}
