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
// The shards are reached through their P source and P destination base
// pointers, passed by value in the kernel's __grid_constant__ parameter
// (shards.cuh), never through one tensor's strides. With rank -1 every
// pointer points into one stacked tensor on one card and the grid covers
// every tile. The one-process-per-card executor (parallel/peer.py) passes
// the ranks' peer-mapped exchange buffers to the same kernel, with a
// barrier across the ranks before the launch and after it, and each rank
// launches the tiles of its own w columns, in every mode: those whose
// first column j0 lies in [rank w, (rank + 1) w), an offset of the tile
// index (tile0) and a shorter grid, the kernel's body unchanged. A tile
// may reach into the next rank's columns; each is computed once.
//
// Bound: bytes (at 4096^2, P = 4: 67 MB read, 67 MB written; the DFT's
// 0.5 GFLOP are under a tenth of that time at the float32 rate). Both
// sides are read and written in row segments of C complex64 values (128
// bytes at C = 16; a block per column would move 8 bytes per 32-byte
// sector).
//
// Fast mode (the JAX package's --fast-transforms, whose overlap x-stages
// run their four-step DFT as bf16 matmuls) takes xstage_kernel<..., true>
// (xfb_xstage_fast, every mode): the sub-DFT's radix-16 passes as bf16
// tensor-core products, float32 accumulate (xtile.cuh FAST: two passes
// at nx = 4096, the radix-2 rest folded into the second, no bank
// conflict on the tile), the loads, the scale and the pad's zeros
// unchanged. The tile in shared memory is float2 whatever the layout, so
// the fast passes run as on the 4-byte planes: the 8-byte elements change
// only the sector check of the plan. At 4096^2 on an H100 the fast modes
// run 1.05-1.10x their strict forms (0.124-0.129 ms against 0.113-0.123,
// 31-32 % of the 0.040 ms bound; they ran 1.16-1.19x before the passes'
// redesign): the sub-DFT costs about 0.012 ms more than the strict one,
// the exchange and the store no less (PERF.md §6).
#include "shards.cuh"
#include "xtile.cuh"

namespace {

constexpr int kRows = 0;    // row shards (rows_l, hrow)
constexpr int kPencil = 1;  // x-pencil column shards (nx, w)

// Element (g, c) of the global (nx, hrow) half spectrum in LAYOUT, through
// the shard base pointers (an array of the kernel's parameter).
template <int LAYOUT, class T>
__device__ __forceinline__ T* element(T* const* ptr, int g, int c,
                                      int rows_l, int hrow, int w) {
  if (LAYOUT == kRows) {
    const int s = g / rows_l;
    return ptr[s] + static_cast<size_t>(g - s * rows_l) * hrow + c;
  }
  const int t = c / w;
  return ptr[t] + static_cast<size_t>(g) * w + (c - t * w);
}

// The store of output row g, tile column c: times scale, or zeros in a
// pad column (hrow <= j < columns).
template <int DST>
struct Store {
  float2* const* dst;
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

template <int SIGN, int SRC, int DST, bool FAST>
__global__ void __launch_bounds__(512, 2)
    xstage_kernel(const __grid_constant__ xfb::Shards sh,
                  const float2* __restrict__ tw, int nx, int k, int logc,
                  int rows_l, int hrow, int w, int columns, float scale,
                  int tile0) {
  extern __shared__ float2 smem[];
  namespace xt = xfb::xtile;
  const xt::Tile t = xt::begin(smem, tw, nx, k, logc);
  const int j0 = (tile0 + blockIdx.x / k) << logc;
  const int cmask = (1 << logc) - 1;
  // rows rank + k * gg, consecutive lanes on consecutive columns
#pragma unroll
  for (int b = 0; b < xt::kElems; ++b) {
    const int u = b * blockDim.x + threadIdx.x;
    const int j = j0 + (u & cmask);
    float2* d = t.s + u;
    if (j < hrow) {
      xt::cp_async8(d, element<SRC>(sh.src, t.rank + k * (u >> logc), j,
                                    rows_l, hrow, w));
    } else {
      *d = make_float2(0.f, 0.f);
    }
  }
  xt::cp_async_wait_all();
  __syncthreads();
  Store<DST> out{sh.dst, j0, rows_l, hrow, w, columns, scale};
  xt::finish<SIGN, FAST>(t, tw, out);
}

template <int SRC, int DST, bool FAST>
cudaError_t launch(const xfb::Shards& sh, const float2* tw, int nx,
                   int rows_l, int hrow, int w, int columns, int forward,
                   float scale, int tile_c,
                   int cluster_k, int threads, int smem, int rank,
                   int device, cudaStream_t stream) {
  if (!xfb::xtile::plan_ok(nx, tile_c, cluster_k, threads, smem)) {
    return cudaErrorInvalidValue;
  }
  int tiles = (columns + tile_c - 1) / tile_c;
  int tile0 = 0;
  if (rank >= 0) {
    // the tiles whose first column lies in the rank's w columns
    const int end = ((rank + 1) * w + tile_c - 1) / tile_c;
    tile0 = (rank * w + tile_c - 1) / tile_c;
    tiles = (end < tiles ? end : tiles) - tile0;
    if (tiles <= 0) return cudaSuccess;
  }
  const int logc = xfb::xtile::log2i(tile_c);
  return forward
             ? xfb::xtile::launch(xstage_kernel<-1, SRC, DST, FAST>, tiles, 1,
                                  cluster_k, threads, smem, device, stream,
                                  sh, tw, nx, cluster_k, logc, rows_l,
                                  hrow, w, columns, scale, tile0)
             : xfb::xtile::launch(xstage_kernel<1, SRC, DST, FAST>, tiles, 1,
                                  cluster_k, threads, smem, device, stream,
                                  sh, tw, nx, cluster_k, logc, rows_l,
                                  hrow, w, columns, scale, tile0);
}

// The entry's mode switch, strict or on the fast column tile.
template <bool FAST>
int entry(const void* const* ptrs, const float2* tw, int p, int rows_l,
          int hrow, int w, int mode, int forward, float scale, int tile_c,
          int cluster_k, int threads, int smem, int rank, int device,
          cudaStream_t stream) {
  xfb::Shards sh;
  if (!xfb::load_shards(ptrs, p, &sh) || rank < -1 || rank >= p) {
    return cudaErrorInvalidValue;
  }
  const int nx = p * rows_l;
  switch (mode) {
    case 0:
      return launch<kRows, kRows, FAST>(sh, tw, nx, rows_l, hrow, w, hrow,
                                        forward, scale, tile_c, cluster_k,
                                        threads, smem, rank, device, stream);
    case 1:
      return launch<kRows, kPencil, FAST>(sh, tw, nx, rows_l, hrow, w, p * w,
                                          forward, scale, tile_c, cluster_k,
                                          threads, smem, rank, device,
                                          stream);
    case 2:
      return launch<kPencil, kRows, FAST>(sh, tw, nx, rows_l, hrow, w, hrow,
                                          forward, scale, tile_c, cluster_k,
                                          threads, smem, rank, device,
                                          stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// ptrs: host array of 2 p device pointers (the p source shards, then the
// p destination shards; p outside [1, kMaxShards] is refused); tw: the
// (nx/2) twiddles exp(-2 pi i k / nx); mode 0 xstage (rows -> rows), 1
// gather (rows -> x-pencil), 2 scatter (x-pencil -> rows); p shards of
// rows_l rows, hrow the half axis, w the x-pencil width; tile_c,
// cluster_k, threads, smem: the plan of ops/xtile.py for nx and the mode's
// columns; rank -1 launches every tile, a rank in [0, p) its own.
extern "C" int xfb_xstage(const void* const* ptrs, const float2* tw, int p,
                          int rows_l, int hrow, int w, int mode, int forward,
                          float scale, int tile_c, int cluster_k, int threads,
                          int smem, int rank, int device,
                          cudaStream_t stream) {
  return entry<false>(ptrs, tw, p, rows_l, hrow, w, mode, forward, scale,
                      tile_c, cluster_k, threads, smem, rank, device, stream);
}

// xstage on the fast column tile, every mode: arguments as xfb_xstage's
extern "C" int xfb_xstage_fast(const void* const* ptrs, const float2* tw,
                               int p, int rows_l, int hrow, int w, int mode,
                               int forward, float scale, int tile_c,
                               int cluster_k, int threads, int smem,
                               int rank, int device, cudaStream_t stream) {
  return entry<true>(ptrs, tw, p, rows_l, hrow, w, mode, forward, scale,
                     tile_c, cluster_k, threads, smem, rank, device, stream);
}
