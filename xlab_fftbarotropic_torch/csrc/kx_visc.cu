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
// epilogue). For each field f and spectral column j it runs the forward
// length-nx DFT of (fr + i fi)[f, :, j] and applies the epilogue of
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
// MB with the tail (14 in, 2 out). The transform is the column-tile
// x-stage of csrc/xtile.cuh: a cluster owns C adjacent columns, so every
// plane, the epilogue's too, is read and written in row segments of C
// floats (a block per column would move one float per 32-byte sector,
// its planes strided by hny along the column). Every
// form (no epilogue, visc, axpy, tail; any number of fields) runs the
// one kernel below with the plan of nx alone, so the transform's bits
// never depend on the form.
#include "epilogue.cuh"
#include "xtile.cuh"

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

struct Planes {
  const float* lap;
  const float* mask;
  const float* zsr;
  const float* zsi;
  const float* z0r;
  const float* z0i;
  float* rr;
  float* ri;
  float* nr;
  float* ni;
};

// The epilogue of output row i, tile column c. Its operands are read
// through the read-only path (no output aliases an input: the wrappers
// allocate them), so the loads of one row need not wait for the stores
// of the row before.
struct Epilogue {
  Planes p;
  Tail tail;
  size_t plane;
  int j0, hny;
  float nu, coef;

  __device__ __forceinline__ void operator()(int i, int c, float2 f) const {
    const int j = j0 + c;
    if (j >= hny) return;  // the ragged last tile
    const size_t moff = static_cast<size_t>(i) * hny + j;
    const size_t off = plane + moff;
    if (p.lap == nullptr) {  // kx_fwd: the raw transform, no epilogue
      p.rr[off] = f.x;
      p.ri[off] = f.y;
      return;
    }
    const float2 r = xfb::visc(nu, __ldg(p.lap + off), __ldg(p.mask + moff),
                               f, __ldg(p.zsr + off), __ldg(p.zsi + off));
    if (tail.r1r != nullptr) {  // the RK4 tail: n only, r stays here
      p.nr[off] = xfb::rk4_tail(__ldg(p.z0r + off), __ldg(tail.r1r + off),
                                __ldg(tail.r2r + off), __ldg(tail.r3r + off),
                                r.x, tail.c);
      p.ni[off] = xfb::rk4_tail(__ldg(p.z0i + off), __ldg(tail.r1i + off),
                                __ldg(tail.r2i + off), __ldg(tail.r3i + off),
                                r.y, tail.c);
      return;
    }
    p.rr[off] = r.x;
    p.ri[off] = r.y;
    if (p.z0r != nullptr) {
      p.nr[off] = xfb::axpy(__ldg(p.z0r + off), coef, r.x);
      p.ni[off] = xfb::axpy(__ldg(p.z0i + off), coef, r.y);
    }
  }
};

__global__ void __launch_bounds__(512, 2)
    kx_visc_kernel(const float* __restrict__ fr, const float* __restrict__ fi,
                   Planes p, Tail tail, const float2* __restrict__ tw,
                   int nx, int hny, int k, int logc, float nu, float coef) {
  extern __shared__ float2 smem[];
  namespace xt = xfb::xtile;
  const xt::Tile t = xt::begin(smem, tw, nx, k, logc);
  const int j0 = (blockIdx.x / k) << logc;
  const size_t plane = static_cast<size_t>(blockIdx.y) * nx * hny;
  const int cmask = (1 << logc) - 1;
  // rows rank + k * jj, consecutive lanes on consecutive columns
#pragma unroll
  for (int b = 0; b < xt::kElems; ++b) {
    const int u = b * blockDim.x + threadIdx.x;
    const int j = j0 + (u & cmask);
    float2* d = t.s + u;
    if (j < hny) {
      const size_t off =
          plane + static_cast<size_t>(t.rank + k * (u >> logc)) * hny + j;
      xt::cp_async4(&d->x, fr + off);
      xt::cp_async4(&d->y, fi + off);
    } else {
      *d = make_float2(0.f, 0.f);
    }
  }
  xt::cp_async_wait_all();
  __syncthreads();
  Epilogue out{p, tail, plane, j0, hny, nu, coef};
  xt::finish<-1>(t, tw, out);
}

int launch(const float* fr, const float* fi, const Planes& p, Tail tail,
           const void* tw, int nfields, int nx, int hny, float nu,
           float coef, int tile_c, int cluster_k, int threads, int smem,
           int device, void* stream) {
  if (!xfb::xtile::plan_ok(nx, tile_c, cluster_k, threads, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (hny + tile_c - 1) / tile_c;
  return static_cast<int>(xfb::xtile::launch(
      kx_visc_kernel, tiles, nfields, cluster_k, threads, smem, device,
      static_cast<cudaStream_t>(stream), fr, fi, p, tail,
      static_cast<const float2*>(tw), nx, hny, cluster_k,
      xfb::xtile::log2i(tile_c), nu, coef));
}

}  // namespace

// fr, fi, lap, zsr, zsi (and z0r, z0i, rr, ri, nr, ni): (nfields, nx, hny);
// mask: (nx, hny). z0r = z0i = nr = ni = NULL: no stage axpy. lap = NULL
// (and mask, zsr, zsi, z0r, z0i NULL): no epilogue at all, rr + i ri is
// the forward x-DFT itself (kx_fwd, the shallow-water forward x-stage).
// tile_c, cluster_k, threads, smem: the plan of ops/xtile.py for nx.
extern "C" int xfb_kx_visc(const float* fr, const float* fi,
                           const float* lap, const float* mask,
                           const float* zsr, const float* zsi,
                           const float* z0r, const float* z0i,
                           const void* tw, float* rr, float* ri, float* nr,
                           float* ni, int nfields, int nx, int hny,
                           float nu, float coef, int tile_c, int cluster_k,
                           int threads, int smem, int device, void* stream) {
  return launch(fr, fi, Planes{lap, mask, zsr, zsi, z0r, z0i, rr, ri, nr, ni},
                Tail{}, tw, nfields, nx, hny, nu, coef, tile_c, cluster_k,
                threads, smem, device, stream);
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
                                float c, int tile_c, int cluster_k,
                                int threads, int smem, int device,
                                void* stream) {
  return launch(fr, fi,
                Planes{lap, mask, zsr, zsi, z0r, z0i, nullptr, nullptr, nr,
                       ni},
                Tail{r1r, r1i, r2r, r2i, r3r, r3i, c}, tw, nfields, nx, hny,
                nu, 0.f, tile_c, cluster_k, threads, smem, device, stream);
}
