// kb_pair, kb: the paired c2r y-stage.
//
// kb_pair replaces pallas_fft._kb_call_stacked / _kb_kernel_stacked
// (xlab_fftbarotropic_tpu/ops/pallas_fft.py:1049) with
// transpose_out=False; kb replaces pallas_fft._kb_call / _kb_kernel
// (:1043), whose output is x-major.
//
// For each physical column x a block reads rows 0..ny/2 of two x-stage
// outputs a and b (kb_pair: fields fa and fb of a stacked (F, hny, nx)
// output, F = 4 from ka_diag, 6 from ka6, field f at f * hny * nx, so F
// itself is never needed; kb: two separate (hny, nx) plane pairs, b
// absent for a single inverse), zeroes the imaginary part of the
// self-conjugate rows 0 and ny/2 (the positive-Nyquist leak guard),
// builds the full Hermitian column c[j] = a[j] + i b[j],
// c[ny-j] = conj(a[j]) + i conj(b[j]) in shared memory, runs the inverse
// colfft and writes Re * scale to a and Im * scale to b: kb_pair
// y-major, a[y, x] (ny, nx); kb x-major, a[x, y] (nx, ny).
//
// Bound: memory traffic, about 268 MB per call at 4096^2 (4 planes in,
// 2 out). Block x reads column x of each input plane (strided by nx);
// kb_pair writes column x of each output (strided too, neighbouring
// blocks share the sectors in L2), kb writes row x (contiguous).
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
  const size_t plane = static_cast<size_t>((ny >> 1) + 1) * nx;
  xfb::load_hermitian_column(s, wr + fa * plane + x, wi + fa * plane + x,
                             wr + fb * plane + x, wi + fb * plane + x, ny,
                             logny, nx);
  xfb::colfft<+1>(s, ny, logny, tw);
  for (int y = threadIdx.x; y < ny; y += blockDim.x) {
    const float2 v = s[y];
    const size_t off = static_cast<size_t>(y) * nx + x;
    oa[off] = v.x * scale;
    ob[off] = v.y * scale;
  }
}

__global__ void kb_kernel(const float* __restrict__ war,
                          const float* __restrict__ wai,
                          const float* __restrict__ wbr,
                          const float* __restrict__ wbi,
                          const float2* __restrict__ tw,
                          float* __restrict__ oa, float* __restrict__ ob,
                          int ny, int logny, int nx, float scale) {
  extern __shared__ float2 s[];
  const int x = blockIdx.x;
  xfb::load_hermitian_column(s, war + x, wai + x,
                             wbr == nullptr ? nullptr : wbr + x,
                             wbi == nullptr ? nullptr : wbi + x, ny, logny,
                             nx);
  xfb::colfft<+1>(s, ny, logny, tw);
  const size_t row = static_cast<size_t>(x) * ny;
  for (int y = threadIdx.x; y < ny; y += blockDim.x) {
    const float2 v = s[y];
    oa[row + y] = v.x * scale;
    if (ob != nullptr) ob[row + y] = v.y * scale;
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

// war, wai, wbr, wbi: (ny/2 + 1, nx) -> oa, ob: (nx, ny). wbr, wbi and ob
// NULL: a single inverse (b is zero and not written).
extern "C" int xfb_kb(const float* war, const float* wai, const float* wbr,
                      const float* wbi, const void* tw, float* oa, float* ob,
                      int ny, int nx, float scale, int device, void* stream) {
  const size_t smem = static_cast<size_t>(ny) * sizeof(float2);
  cudaError_t err = xfb::prepare(reinterpret_cast<const void*>(kb_kernel),
                                 device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kb_kernel<<<nx, xfb::threads_for(ny), smem,
              static_cast<cudaStream_t>(stream)>>>(
      war, wai, wbr, wbi, static_cast<const float2*>(tw), oa, ob, ny,
      xfb::ilog2(ny), nx, scale);
  return static_cast<int>(cudaGetLastError());
}
