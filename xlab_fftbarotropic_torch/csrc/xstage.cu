// xstage: the distributed x-stage, the all-to-all transposes fused with
// the length-nx DFT along the sharded x axis.
//
// Replaces, in xlab_fftbarotropic_tpu/parallel/pallas_overlap.py,
//   _xstage_kernel (:61): row shards -> DFT along x -> row shards, both
//     all-to-alls chunk-pipelined with the DFT in one kernel;
//   _gather_kernel (:148): row shards -> DFT -> x-pencil column shards
//     (the forward half, for the x-pencil spectral layout);
//   _scatter_kernel (:212): x-pencil -> DFT -> row shards (the inverse
//     half).
// With P shards of a global (nx, hrow) complex64 half-spectrum (rows_l =
// nx / P; the x-pencil layout pads the half axis to hpad = P w, w =
// ceil(hrow / P)), element (g, c) lives
//   in the row layout at      shard g / rows_l, offset (g % rows_l) hrow + c;
//   in the x-pencil layout at shard c / w,      offset g w + c % w.
// A cluster of blocks owns a tile of C adjacent columns (the column-tile
// x-stage of csrc/xtile.cuh): it pulls the tile's nx rows from the P
// source shards, runs the length-nx DFT forward or inverse, unnormalized,
// times `scale`, and pushes the tile to the P row owners (xstage,
// scatter) or into its owners' x-pencils (gather; a pad column c >= hrow
// is written as zeros). A tile may straddle x-pencil shards: every
// element is addressed through the pointer tables on its own. Tiles are
// independent, so one launch needs no semaphores: the many resident
// clusters overlap one tile's loads with another's butterflies, which the
// TPU kernel arranged by hand with its chunk pipeline (n_chunks 128-lane
// chunks, a TPU tiling rule not carried over).
//
// The shards are reached through two tables of P base pointers on the
// card (sources, destinations), never through one tensor's strides: here
// every pointer points into one stacked tensor on one card. A later
// executor with one process per card passes peer-mapped pointers to the
// same kernel, with a barrier across the cards before the launch and
// after it, and each card launches the blocks of its own w columns.
//
// Bound: bytes (at 4096^2, P = 4: 67 MB read, 67 MB written; the DFT's
// 0.5 GFLOP are under a tenth of that time at the float32 rate). Both
// sides are read and written in row segments of C complex64 values (128
// bytes at C = 16; a block per column would move 8 bytes per 32-byte
// sector).
#include "xtile.cuh"

namespace {

constexpr int kRows = 0;    // row shards (rows_l, hrow)
constexpr int kPencil = 1;  // x-pencil column shards (nx, w)

// Element (g, c) of the global (nx, hrow) half spectrum in LAYOUT, through
// the table of shard base pointers.
template <int LAYOUT>
__device__ __forceinline__ float2* element(const long long* __restrict__ ptr,
                                           int g, int c, int rows_l,
                                           int hrow, int w) {
  if (LAYOUT == kRows) {
    const int s = g / rows_l;
    return reinterpret_cast<float2*>(__ldg(&ptr[s])) +
           static_cast<size_t>(g - s * rows_l) * hrow + c;
  }
  const int t = c / w;
  return reinterpret_cast<float2*>(__ldg(&ptr[t])) +
         static_cast<size_t>(g) * w + (c - t * w);
}

// The store of output row g, tile column c: times scale, or zeros in a
// pad column (hrow <= j < columns).
template <int DST>
struct Store {
  const long long* dst;
  int j0, rows_l, hrow, w, columns;
  float scale;

  __device__ __forceinline__ void operator()(int g, int c, float2 v) const {
    const int j = j0 + c;
    if (j >= columns) return;  // the ragged last tile
    *element<DST>(dst, g, j, rows_l, hrow, w) =
        j < hrow ? make_float2(__fmul_rn(v.x, scale), __fmul_rn(v.y, scale))
                 : make_float2(0.f, 0.f);
  }
};

template <int SIGN, int SRC, int DST>
__global__ void __launch_bounds__(512, 2)
    xstage_kernel(const long long* __restrict__ src,
                  const long long* __restrict__ dst,
                  const float2* __restrict__ tw, int nx, int k, int logc,
                  int rows_l, int hrow, int w, int columns, float scale) {
  extern __shared__ float2 smem[];
  namespace xt = xfb::xtile;
  const xt::Tile t = xt::begin(smem, tw, nx, k, logc);
  const int j0 = (blockIdx.x / k) << logc;
  const int cmask = (1 << logc) - 1;
  // rows rank + k * gg, consecutive lanes on consecutive columns
#pragma unroll
  for (int b = 0; b < xt::kElems; ++b) {
    const int u = b * blockDim.x + threadIdx.x;
    const int j = j0 + (u & cmask);
    float2* d = t.s + u;
    if (j < hrow) {
      xt::cp_async8(d, element<SRC>(src, t.rank + k * (u >> logc), j,
                                    rows_l, hrow, w));
    } else {
      *d = make_float2(0.f, 0.f);
    }
  }
  xt::cp_async_wait_all();
  __syncthreads();
  Store<DST> out{dst, j0, rows_l, hrow, w, columns, scale};
  xt::finish<SIGN>(t, tw, out);
}

template <int SRC, int DST>
cudaError_t launch(const long long* src, const long long* dst,
                   const float2* tw, int nx, int rows_l, int hrow, int w,
                   int columns, int forward, float scale, int tile_c,
                   int cluster_k, int threads, int smem, int device,
                   cudaStream_t stream) {
  if (!xfb::xtile::plan_ok(nx, tile_c, cluster_k, threads, smem)) {
    return cudaErrorInvalidValue;
  }
  const int tiles = (columns + tile_c - 1) / tile_c;
  const int logc = xfb::xtile::log2i(tile_c);
  return forward
             ? xfb::xtile::launch(xstage_kernel<-1, SRC, DST>, tiles, 1,
                                  cluster_k, threads, smem, device, stream,
                                  src, dst, tw, nx, cluster_k, logc, rows_l,
                                  hrow, w, columns, scale)
             : xfb::xtile::launch(xstage_kernel<1, SRC, DST>, tiles, 1,
                                  cluster_k, threads, smem, device, stream,
                                  src, dst, tw, nx, cluster_k, logc, rows_l,
                                  hrow, w, columns, scale);
}

}  // namespace

// src, dst: device tables of p base pointers (int64); tw: the (nx/2)
// twiddles exp(-2 pi i k / nx); mode 0 xstage (rows -> rows), 1 gather
// (rows -> x-pencil), 2 scatter (x-pencil -> rows); p shards of rows_l
// rows, hrow the half axis, w the x-pencil width; tile_c, cluster_k,
// threads, smem: the plan of ops/xtile.py for nx and the mode's columns.
extern "C" int xfb_xstage(const long long* src, const long long* dst,
                          const float2* tw, int p, int rows_l, int hrow,
                          int w, int mode, int forward, float scale,
                          int tile_c, int cluster_k, int threads, int smem,
                          int device, cudaStream_t stream) {
  const int nx = p * rows_l;
  switch (mode) {
    case 0:
      return launch<kRows, kRows>(src, dst, tw, nx, rows_l, hrow, w, hrow,
                                  forward, scale, tile_c, cluster_k, threads,
                                  smem, device, stream);
    case 1:
      return launch<kRows, kPencil>(src, dst, tw, nx, rows_l, hrow, w, p * w,
                                    forward, scale, tile_c, cluster_k,
                                    threads, smem, device, stream);
    case 2:
      return launch<kPencil, kRows>(src, dst, tw, nx, rows_l, hrow, w, hrow,
                                    forward, scale, tile_c, cluster_k,
                                    threads, smem, device, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
