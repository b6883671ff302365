// kb_pair, kb: the paired c2r y-stage.
//
// kb_pair replaces pallas_fft._kb_call_stacked / _kb_kernel_stacked
// (xlab_fftbarotropic_tpu/ops/pallas_fft.py:1049) with
// transpose_out=False; kb replaces pallas_fft._kb_call / _kb_kernel
// (:1043), whose output is x-major, and serves _kb_call_stacked's
// transpose_out=True form too (ops/fused_fft.py kb_stacked).
//
// For each physical column x they read rows 0..ny/2 of two x-stage
// outputs a and b (kb_pair: fields fa and fb of a stacked (F, hny, nx)
// output, F = 4 from ka_diag, 6 from ka6, field f at f * hny * nx, so F
// itself is never needed; kb: two separate (hny, nx) plane pairs, b
// absent for a single inverse), zero the imaginary part of the
// self-conjugate rows 0 and ny/2 (the positive-Nyquist leak guard),
// build the full Hermitian column c[j] = a[j] + i b[j],
// c[ny-j] = conj(a[j]) + i conj(b[j]), run the inverse DFT along y and
// write Re * scale to a and Im * scale to b: kb_pair y-major, a[y, x]
// (ny, nx); kb x-major, a[x, y] (nx, ny).
//
// Bound: memory traffic, about 268 MB per call at 4096^2 (4 half planes
// in, 2 planes out). kb_pair runs one column per block around colfft.cuh:
// block x reads column x of each input plane (strided by nx) and writes
// column x of each output (strided too, neighbouring blocks share the
// sectors in L2); its bits are those of ky_adv and kb_adv (the fusion
// arms), so it stays there until they move with it. kb runs the
// column-tile transform of csrc/xtile.cuh: a cluster of K blocks owns C
// adjacent x columns; block r builds rows y = r + K j of the Hermitian
// tile from input row h = min(y, ny - y), read in row segments of C
// floats (64 bytes at C = 16; rows h and ny - h go to blocks r and K - r
// of the same cluster at about the same time, so L2 serves the second
// read), and the transposed store writes each output row x in runs of
// contiguous y. One plan of ny alone for the paired and single forms.
#include "colfft.cuh"
#include "xtile.cuh"

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

// The store of kb's output y of tile column c: Re * scale to oa[x, y],
// Im * scale to ob[x, y] (ob NULL: the single inverse, not written).
struct KbOut {
  float* oa;
  float* ob;
  int j0, nx, ny;
  float scale;

  __device__ __forceinline__ void operator()(int y, int c, float2 v) const {
    const int x = j0 + c;
    if (x >= nx) return;  // the ragged last tile
    const size_t off = static_cast<size_t>(x) * ny + y;
    oa[off] = __fmul_rn(v.x, scale);
    if (ob != nullptr) ob[off] = __fmul_rn(v.y, scale);
  }
};

// cluster tile: columns j0 .. j0 + C; block r of it builds rows r + k jj
// of the Hermitian tile (colfft.cuh load_hermitian_column's formulas,
// from input row h = min(y, ny - y)), consecutive lanes on consecutive
// columns. wbr == NULL: a zero partner.
__global__ void __launch_bounds__(512, 2)
    kb_kernel(const float* __restrict__ war, const float* __restrict__ wai,
              const float* __restrict__ wbr, const float* __restrict__ wbi,
              const float2* __restrict__ tw, KbOut out, int k, int logc) {
  extern __shared__ float2 smem[];
  namespace xt = xfb::xtile;
  const int ny = out.ny, nx = out.nx, half = ny >> 1;
  const xt::Tile t = xt::begin(smem, tw, ny, k, logc);
  const int j0 = (blockIdx.x / k) << logc;
  const int cmask = (1 << logc) - 1;
#pragma unroll
  for (int b = 0; b < xt::kElems; ++b) {
    const int u = b * blockDim.x + threadIdx.x;
    const int x = j0 + (u & cmask);
    const int y = t.rank + k * (u >> logc);
    float2 v = make_float2(0.f, 0.f);
    if (x < nx) {
      const int h = y <= half ? y : ny - y;
      const size_t off = static_cast<size_t>(h) * nx + x;
      const bool selfconj = (h == 0) || (h == half);
      const float ar = __ldg(war + off);
      const float ai = selfconj ? 0.f : __ldg(wai + off);
      const float br = wbr == nullptr ? 0.f : __ldg(wbr + off);
      const float bi = (selfconj || wbi == nullptr) ? 0.f : __ldg(wbi + off);
      v = y <= half ? make_float2(ar - bi, ai + br)
                    : make_float2(ar + bi, br - ai);
    }
    t.s[u] = v;
  }
  __syncthreads();
  KbOut o = out;
  o.j0 = j0;
  xt::finish_transposed<+1>(t, tw, false, o);
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
// NULL: a single inverse (b is zero and not written). tile_c, cluster_k,
// threads, smem: the plan of ops/xtile.py for ny.
extern "C" int xfb_kb(const float* war, const float* wai, const float* wbr,
                      const float* wbi, const void* tw, float* oa, float* ob,
                      int ny, int nx, float scale, int tile_c, int cluster_k,
                      int threads, int smem, int device, void* stream) {
  if (!xfb::xtile::plan_ok(ny, tile_c, cluster_k, threads, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (nx + tile_c - 1) / tile_c;
  return static_cast<int>(xfb::xtile::launch(
      kb_kernel, tiles, 1, cluster_k, threads, smem, device,
      static_cast<cudaStream_t>(stream), war, wai, wbr, wbi,
      static_cast<const float2*>(tw), KbOut{oa, ob, 0, nx, ny, scale},
      cluster_k, xfb::xtile::log2i(tile_c)));
}
