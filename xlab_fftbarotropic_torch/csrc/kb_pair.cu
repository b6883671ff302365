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
// in, 2 planes out). Both run the column-tile transform of
// csrc/xtile.cuh: a cluster of K blocks owns C adjacent x columns; block
// r builds rows y = r + K j of the Hermitian tile from input row
// h = min(y, ny - y) (xtile.cuh load_hermitian), read in row segments of
// C floats (64 bytes at C = 16; rows h and ny - h go to blocks r and
// K - r of the same cluster at about the same time, so L2 serves the
// second read). kb_pair takes the natural store (finish): the combine
// hands out X[k2 + m k1] for the tile's C columns, written as row
// segments of C contiguous floats of a[y, :] and b[y, :]. kb takes the
// transposed store (finish_transposed), which writes each output row x
// in runs of contiguous y. One plan of ny alone for every form, and the
// same arithmetic up to the store, so kb_pair's output is kb's
// transposed bit for bit; ky_adv and kb_adv (the fusion arms) share the
// load and the transform, so they keep kb_pair's bits. xfb_kb_pair_fast
// is kb_pair on the fast column tile (xtile.cuh FAST: bf16 tensor-core
// radix-16 passes, the barotropic fast mode), load and store unchanged;
// kb_adv_half's fast form shares its inverse. xfb_kb_fast is kb on the
// fast tile (kb_kernel<true>), the x-first order's fast mode, whose
// output is kb_pair's fast form's transposed bit for bit: on the plane
// tile (xtile.cuh plane_transposed, HermitianLoad), where nx is a
// multiple of 4 a thread reads four columns of row h of each half plane
// with one 16-byte load, forms the Hermitian sums in registers and stores
// them 16 bytes at a time into the tile's two float planes, and the
// first pass runs inlined from them; other widths load_hermitian's tile.
#include "xtile.cuh"

namespace {

// The store of kb_pair's output y of tile column c: Re * scale to
// oa[y, x], Im * scale to ob[y, x].
struct KbPairOut {
  float* oa;
  float* ob;
  int j0, nx;
  float scale;

  __device__ __forceinline__ void operator()(int y, int c, float2 v) const {
    const int x = j0 + c;
    if (x >= nx) return;  // the ragged last tile
    const size_t off = static_cast<size_t>(y) * nx + x;
    oa[off] = __fmul_rn(v.x, scale);
    ob[off] = __fmul_rn(v.y, scale);
  }
};

// cluster tile: columns j0 .. j0 + C of fields fa, fb of the stacked
// (F, ny/2 + 1, nx) planes
template <bool FAST>
__global__ void __launch_bounds__(512, 2)
    kb_pair_kernel(const float* __restrict__ wr,
                   const float* __restrict__ wi, int fa, int fb,
                   const float2* __restrict__ tw, KbPairOut out, int ny,
                   int k, int logc) {
  extern __shared__ float2 smem[];
  namespace xt = xfb::xtile;
  const xt::Tile t = xt::begin(smem, tw, ny, k, logc);
  const int j0 = (blockIdx.x / k) << logc;
  const size_t plane = static_cast<size_t>((ny >> 1) + 1) * out.nx;
  xt::load_hermitian(t, t.s, wr + fa * plane, wi + fa * plane,
                     wr + fb * plane, wi + fb * plane, j0, out.nx);
  __syncthreads();
  KbPairOut o = out;
  o.j0 = j0;
  xt::finish<+1, FAST>(t, tw, o);
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

// cluster tile: columns j0 .. j0 + C of the two (ny/2 + 1, nx) plane
// pairs. wbr == NULL: a zero partner.
template <bool FAST>
__global__ void __launch_bounds__(512, 2)
    kb_kernel(const float* __restrict__ war, const float* __restrict__ wai,
              const float* __restrict__ wbr, const float* __restrict__ wbi,
              const float2* __restrict__ tw, KbOut out, int k, int logc) {
  extern __shared__ float2 smem[];
  namespace xt = xfb::xtile;
  if constexpr (FAST) {
    xt::plane_transposed<+1, false>(
        smem, tw, out.ny, k, logc,
        xt::HermitianLoad{war, wai, wbr, wbi, out.nx}, out);
  } else {
    const xt::Tile t = xt::begin(smem, tw, out.ny, k, logc);
    const int j0 = (blockIdx.x / k) << logc;
    xt::load_hermitian(t, t.s, war, wai, wbr, wbi, j0, out.nx);
    __syncthreads();
    KbOut o = out;
    o.j0 = j0;
    xt::finish_transposed<+1, FAST>(t, tw, false, o);
  }
}

template <bool FAST>
int launch_pair(const float* wr, const float* wi, int fa, int fb,
                const void* tw, float* oa, float* ob, int ny, int nx,
                float scale, int tile_c, int cluster_k, int threads,
                int smem, int device, void* stream) {
  if (!xfb::xtile::plan_ok(ny, tile_c, cluster_k, threads, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (nx + tile_c - 1) / tile_c;
  return static_cast<int>(xfb::xtile::launch(
      kb_pair_kernel<FAST>, tiles, 1, cluster_k, threads, smem, device,
      static_cast<cudaStream_t>(stream), wr, wi, fa, fb,
      static_cast<const float2*>(tw), KbPairOut{oa, ob, 0, nx, scale}, ny,
      cluster_k, xfb::xtile::log2i(tile_c)));
}

template <bool FAST>
int launch_kb(const float* war, const float* wai, const float* wbr,
              const float* wbi, const void* tw, float* oa, float* ob, int ny,
              int nx, float scale, int tile_c, int cluster_k, int threads,
              int smem, int device, void* stream) {
  if (!xfb::xtile::plan_ok(ny, tile_c, cluster_k, threads, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (nx + tile_c - 1) / tile_c;
  return static_cast<int>(xfb::xtile::launch(
      kb_kernel<FAST>, tiles, 1, cluster_k, threads, smem, device,
      static_cast<cudaStream_t>(stream), war, wai, wbr, wbi,
      static_cast<const float2*>(tw), KbOut{oa, ob, 0, nx, ny, scale},
      cluster_k, xfb::xtile::log2i(tile_c)));
}

}  // namespace

// wr, wi: the stacked (F, ny/2 + 1, nx) planes, of which fields fa and
// fb are read -> oa, ob: (ny, nx). tile_c, cluster_k, threads, smem: the
// plan of ops/xtile.py for ny.
extern "C" int xfb_kb_pair(const float* wr, const float* wi, int fa, int fb,
                           const void* tw, float* oa, float* ob, int ny,
                           int nx, float scale, int tile_c, int cluster_k,
                           int threads, int smem, int device, void* stream) {
  return launch_pair<false>(wr, wi, fa, fb, tw, oa, ob, ny, nx, scale,
                            tile_c, cluster_k, threads, smem, device,
                            stream);
}

// kb_pair on the fast column tile: arguments as xfb_kb_pair's
extern "C" int xfb_kb_pair_fast(const float* wr, const float* wi, int fa,
                                int fb, const void* tw, float* oa, float* ob,
                                int ny, int nx, float scale, int tile_c,
                                int cluster_k, int threads, int smem,
                                int device, void* stream) {
  return launch_pair<true>(wr, wi, fa, fb, tw, oa, ob, ny, nx, scale, tile_c,
                           cluster_k, threads, smem, device, stream);
}

// war, wai, wbr, wbi: (ny/2 + 1, nx) -> oa, ob: (nx, ny). wbr, wbi and ob
// NULL: a single inverse (b is zero and not written). tile_c, cluster_k,
// threads, smem: the plan of ops/xtile.py for ny.
extern "C" int xfb_kb(const float* war, const float* wai, const float* wbr,
                      const float* wbi, const void* tw, float* oa, float* ob,
                      int ny, int nx, float scale, int tile_c, int cluster_k,
                      int threads, int smem, int device, void* stream) {
  return launch_kb<false>(war, wai, wbr, wbi, tw, oa, ob, ny, nx, scale,
                          tile_c, cluster_k, threads, smem, device, stream);
}

// kb on the fast column tile: arguments as xfb_kb's
extern "C" int xfb_kb_fast(const float* war, const float* wai,
                           const float* wbr, const float* wbi, const void* tw,
                           float* oa, float* ob, int ny, int nx, float scale,
                           int tile_c, int cluster_k, int threads, int smem,
                           int device, void* stream) {
  return launch_kb<true>(war, wai, wbr, wbi, tw, oa, ob, ny, nx, scale,
                         tile_c, cluster_k, threads, smem, device, stream);
}
