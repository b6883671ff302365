// kb_pair: the paired c2r y-stage.
//
// Replaces pallas_fft._kb_call_stacked / _kb_kernel_stacked
// (xlab_fftbarotropic_tpu/ops/pallas_fft.py) with transpose_out=False.
// For each physical column x it reads rows 0..ny/2 of fields fa and fb
// from a stacked (F, hny, nx) x-stage output (F = 4 from ka_diag, 6 from
// ka6; field f starts at f * hny * nx, so F itself is never needed),
// zeroes the imaginary part of the self-conjugate rows 0 and ny/2 (the
// positive-Nyquist leak guard), builds the full Hermitian column
// c[j] = a[j] + i b[j],
// c[ny-j] = conj(a[j]) + i conj(b[j]) in shared memory, runs the inverse
// colfft and writes Re * scale -> a[y, x] and Im * scale -> b[y, x]
// (y-major (ny, nx); scale = 1/(nx*ny)).
//
// Bound: memory traffic, about 268 MB per call at 4096^2 (4 planes in,
// 2 out). Block x reads column x of each input plane (strided by nx) and
// writes column x of each output (strided by nx): both sides are strided
// in this simple form, and neighbouring blocks share the sectors in L2.
#include "colfft.cuh"

namespace {

__global__ void kb_pair_kernel(const float* __restrict__ wr,
                               const float* __restrict__ wi, int fa,
                               int fb, const float2* __restrict__ tw,
                               float* __restrict__ oa,
                               float* __restrict__ ob, int ny, int logny,
                               int nx, float scale) {
  extern __shared__ float2 s[];
  const int x = blockIdx.x;
  const int half = ny >> 1;
  const size_t plane = static_cast<size_t>(half + 1) * nx;
  const float* ar_p = wr + fa * plane + x;
  const float* ai_p = wi + fa * plane + x;
  const float* br_p = wr + fb * plane + x;
  const float* bi_p = wi + fb * plane + x;
  for (int j = threadIdx.x; j <= half; j += blockDim.x) {
    const size_t off = static_cast<size_t>(j) * nx;
    const float ar = ar_p[off];
    const float br = br_p[off];
    const bool selfconj = (j == 0) || (j == half);
    const float ai = selfconj ? 0.f : ai_p[off];
    const float bi = selfconj ? 0.f : bi_p[off];
    s[xfb::bitrev(j, logny)] = make_float2(ar - bi, ai + br);
    if (!selfconj) {
      s[xfb::bitrev(ny - j, logny)] = make_float2(ar + bi, br - ai);
    }
  }
  xfb::colfft<+1>(s, ny, logny, tw);
  for (int y = threadIdx.x; y < ny; y += blockDim.x) {
    const float2 v = s[y];
    const size_t off = static_cast<size_t>(y) * nx + x;
    oa[off] = v.x * scale;
    ob[off] = v.y * scale;
  }
}

}  // namespace

extern "C" int xfb_kb_pair(const float* wr, const float* wi, int fa, int fb,
                           const void* tw, float* oa, float* ob, int ny,
                           int nx, float scale, int device, void* stream) {
  const size_t smem = static_cast<size_t>(ny) * sizeof(float2);
  cudaError_t err = xfb::prepare(reinterpret_cast<const void*>(kb_pair_kernel),
                                 device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kb_pair_kernel<<<nx, xfb::threads_for(ny), smem,
                   static_cast<cudaStream_t>(stream)>>>(
      wr, wi, fa, fb, static_cast<const float2*>(tw), oa, ob, ny,
      xfb::ilog2(ny), nx, scale);
  return static_cast<int>(cudaGetLastError());
}
