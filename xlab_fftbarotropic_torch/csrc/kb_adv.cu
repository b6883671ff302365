// kb_adv_full, kb_adv_half: the paired c2r y-stage, the advection product
// and the real forward y-stage in one kernel.
//
// kb_adv_full replaces pallas_fft.kb_adv_full / _kb_adv_full_kernel
// (xlab_fftbarotropic_tpu/ops/pallas_fft.py:1158, XFB_BT_FUSEKB=full);
// kb_adv_half replaces pallas_fft.kb_adv_half / _kb_adv_half_kernel
// (:1179, XFB_BT_FUSEKB=half). For each physical column x a block runs in
// shared memory what kb_pair (twice) and ky_adv run for that column:
//   full: rows 0..ny/2 of fields 0-3 of ka_diag's stacked (4, hny, nx)
//     output at column x (strided by nx) -> the Hermitian columns
//     zx + i zy and u + i v (xfb::load_hermitian_column: the
//     self-conjugate rows projected to their real part) -> two inverse
//     colfft, each value scaled by `scale` (1/(nx ny)) as kb_pair writes
//     it -> zeta_x, zeta_y, u, v of column x;
//   half: u + i v from fields 2 and 3 only; zeta_x and zeta_y come from
//     y-major (ny, nx) planes (one kb_pair made them), read at column x;
// then adv[y] = -(u zx) - v (zy + beta) + src[y, x] (xfb::advection,
// ky_adv's expression and rounding), the forward colfft of the real
// column, and rows k <= ny/2 written as row x of the (nx, hny) output.
// The physical fields never reach device memory, and every value is the
// one kb_pair and ky_adv compute, so the fused forms give their bits.
//
// Bound: memory traffic, about 403 MB per call at 4096^2 either way
// (full: 8 half planes and src in, 2 half planes out; half: 4 half
// planes, zeta_x, zeta_y and src in). The column reads are strided by nx
// as in kb_pair and ky_adv; the row write is contiguous. Shared memory:
// full holds two columns of ny float2 (64 KB at 4096, 128 KB at 8192),
// half one; the advection column reuses the u + i v one, bit-reversed in
// place.
#include "colfft.cuh"
#include "epilogue.cuh"

namespace {

template <bool FULL>
__global__ void kb_adv_kernel(const float* __restrict__ wr,
                              const float* __restrict__ wi,
                              const float* __restrict__ zx,
                              const float* __restrict__ zy,
                              const float* __restrict__ src,
                              const float2* __restrict__ tw,
                              float* __restrict__ outr,
                              float* __restrict__ outi, int ny, int logny,
                              int nx, float scale, float beta) {
  extern __shared__ float2 s[];
  float2* uv = s;        // u + i v, then the advection column
  float2* zz = s + ny;   // zeta_x + i zeta_y (full only)
  const int x = blockIdx.x;
  const size_t plane = static_cast<size_t>((ny >> 1) + 1) * nx;
  xfb::load_hermitian_column(uv, wr + 2 * plane + x, wi + 2 * plane + x,
                             wr + 3 * plane + x, wi + 3 * plane + x, ny,
                             logny, nx);
  if constexpr (FULL) {
    xfb::load_hermitian_column(zz, wr + x, wi + x, wr + plane + x,
                               wi + plane + x, ny, logny, nx);
  }
  xfb::colfft<+1>(uv, ny, logny, tw);
  if constexpr (FULL) xfb::colfft<+1>(zz, ny, logny, tw);
  // each thread owns the rows y it reads, so the column is overwritten
  // in natural order and bit-reversed after a barrier
  for (int y = threadIdx.x; y < ny; y += blockDim.x) {
    const size_t off = static_cast<size_t>(y) * nx + x;
    const float2 p = uv[y];
    float zxv, zyv;
    if constexpr (FULL) {
      const float2 q = zz[y];
      zxv = __fmul_rn(q.x, scale);
      zyv = __fmul_rn(q.y, scale);
    } else {
      zxv = zx[off];
      zyv = zy[off];
    }
    const float adv = xfb::advection(__fmul_rn(p.x, scale), zxv,
                                     __fmul_rn(p.y, scale), zyv, src[off],
                                     beta);
    uv[y] = make_float2(adv, 0.f);
  }
  __syncthreads();
  for (int y = threadIdx.x; y < ny; y += blockDim.x) {
    const int r = xfb::bitrev(y, logny);
    if (y < r) {  // each pair swapped once, by the owner of its lower row
      const float2 a = uv[y];
      uv[y] = uv[r];
      uv[r] = a;
    }
  }
  xfb::colfft<-1>(uv, ny, logny, tw);
  const int hny = ny / 2 + 1;
  const size_t row = static_cast<size_t>(x) * hny;
  for (int k = threadIdx.x; k < hny; k += blockDim.x) {
    const float2 val = uv[k];
    outr[row + k] = val.x;
    outi[row + k] = val.y;
  }
}

template <bool FULL>
int launch(const float* wr, const float* wi, const float* zx,
           const float* zy, const float* src, const void* tw, float* outr,
           float* outi, int ny, int nx, float scale, float beta, int device,
           void* stream) {
  const size_t smem = static_cast<size_t>(FULL ? 2 : 1) * ny * sizeof(float2);
  cudaError_t err = xfb::prepare(
      reinterpret_cast<const void*>(kb_adv_kernel<FULL>), device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kb_adv_kernel<FULL><<<nx, xfb::threads_for(ny), smem,
                        static_cast<cudaStream_t>(stream)>>>(
      wr, wi, zx, zy, src, static_cast<const float2*>(tw), outr, outi, ny,
      xfb::ilog2(ny), nx, scale, beta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// wr, wi: ka_diag's (4, ny/2 + 1, nx) stack; src: (ny, nx) y-major;
// outr, outi: (nx, ny/2 + 1).
extern "C" int xfb_kb_adv_full(const float* wr, const float* wi,
                               const float* src, const void* tw, float* outr,
                               float* outi, int ny, int nx, float scale,
                               float beta, int device, void* stream) {
  return launch<true>(wr, wi, nullptr, nullptr, src, tw, outr, outi, ny, nx,
                      scale, beta, device, stream);
}

// zx, zy, src: (ny, nx) y-major; wr, wi: the (4, ny/2 + 1, nx) stack, of
// which fields 2 and 3 are read; outr, outi: (nx, ny/2 + 1).
extern "C" int xfb_kb_adv_half(const float* zx, const float* zy,
                               const float* wr, const float* wi,
                               const float* src, const void* tw, float* outr,
                               float* outi, int ny, int nx, float scale,
                               float beta, int device, void* stream) {
  return launch<false>(wr, wi, zx, zy, src, tw, outr, outi, ny, nx, scale,
                       beta, device, stream);
}
