// a2a: the all-to-all transposes of the distributed transforms, between
// the row shards and the column shards of a half-spectrum.
//
// Replaces pallas_transpose._a2a_cols_kernel and _a2a_rows_kernel
// (xlab_fftbarotropic_tpu/parallel/pallas_transpose.py:39, :78), which
// move the blocks between TPU chips by remote DMA. With P shards of a
// global (nx, hrow) complex64 array, rows_l = nx / P and w = ceil(hrow /
// P) (the half axis padded to hpad = P w):
//
//   to columns: out[t][s rows_l + r][j] = in[s][r][t w + j], zero where
//               t w + j >= hrow (the pad);
//   to rows:    out[s][r][t w + j] = in[t][s rows_l + r][j] for
//               t w + j < hrow (the pad is dropped).
//
// The shards are reached through their P source and P destination base
// pointers, passed by value in the kernel's __grid_constant__ parameter
// (shards.cuh), never through one tensor's strides. With rank -1 every
// pointer points into one stacked tensor on one card, a call queues this
// kernel and nothing else, and the grid covers every shard. The
// one-process-per-card executor (parallel/peer.py) passes the ranks'
// peer-mapped exchange buffers the same way, with a barrier across the
// ranks before the launch (the sources are written) and after it (the
// destinations are complete), and each rank launches only its own
// blocks: to columns, the runs g P + t with t = rank (its column shard,
// pulled from every row shard); to rows, those with s = rank (its row
// shard, pulled from every column shard). Every rank writes locally and
// reads its peers.
//
// Block g P + t moves one run: global row g = s rows_l + r, columns
// [t w, t w + w) of the row side (row r of shard s), against row g of
// column shard t, both contiguous, so reads and writes coalesce. The P
// runs of a row are blocks of their own (no division by w per element),
// launched next to each other, so that the 32-byte sectors two runs share
// (a run of 513 values ends inside one) are written while in L2, not
// twice to memory. Each thread issues kUnroll independent 8-byte loads
// before its stores, to keep enough bytes in flight for the HBM rate.
// Rows of 2049 values and runs of 513 are only 8-byte aligned, so the
// move stays in float2.
// Bound: bytes, each value read and written once (at 4096^2 and P = 4,
// 67 MB each way). A copy: the result is the plain version's bit for bit.
#include "shards.cuh"

namespace {

constexpr int kUnroll = 4;
constexpr int kMaxThreads = 256;

template <bool TO_COLS>
__global__ void __launch_bounds__(kMaxThreads)
    a2a_kernel(const __grid_constant__ xfb::Shards sh, int p, int rows_l,
               int hrow, int w, int rank) {
  // the run's global row g and column shard t: every run with rank -1,
  // else the rank's own (to columns: t = rank; to rows: g / rows_l = rank)
  int g = blockIdx.x / p;
  int t = blockIdx.x - g * p;
  if (rank >= 0) {
    if (TO_COLS) {
      g = blockIdx.x;
      t = rank;
    } else {
      g += rank * rows_l;
    }
  }
  const int s = g / rows_l;
  const size_t row = static_cast<size_t>(g - s * rows_l) * hrow + t * w;
  const size_t col = static_cast<size_t>(g) * w;
  // the run's values on the row side; the rest of it (c >= hrow) is pad
  const int valid = min(w, hrow - t * w);
  const float2* __restrict__ in =
      TO_COLS ? sh.src[s] + row : sh.src[t] + col;
  float2* __restrict__ out = TO_COLS ? sh.dst[t] + col : sh.dst[s] + row;
  const int last = TO_COLS ? w : valid;
  for (int j0 = threadIdx.x; j0 < last; j0 += kUnroll * blockDim.x) {
    float2 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * blockDim.x;
      v[u] = j < valid ? in[j] : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * blockDim.x;
      if (j < last) out[j] = v[u];
    }
  }
}

}  // namespace

// ptrs: host array of 2 p device pointers (the p source shards, then the
// p destination shards); p shards of rows_l rows; hrow the row side's
// width, w the column side's; to_cols picks the direction; rank -1 moves
// every run, a rank in [0, p) its own (p rows_l of them). p outside [1,
// kMaxShards] is refused (cudaErrorInvalidValue).
extern "C" int xfb_a2a(const void* const* ptrs, int p, int rows_l, int hrow,
                       int w, int to_cols, int rank, int device,
                       cudaStream_t stream) {
  xfb::Shards sh;
  if (!xfb::load_shards(ptrs, p, &sh) || rows_l < 1 || w < 1 ||
      hrow > p * w || rank < -1 || rank >= p) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  // one thread per kUnroll values of a run, in whole warps
  int threads = ((w + kUnroll - 1) / kUnroll + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const unsigned blocks =
      static_cast<unsigned>(rank < 0 ? p : 1) * p * rows_l;
  if (to_cols) {
    a2a_kernel<true><<<blocks, threads, 0, stream>>>(sh, p, rows_l, hrow, w,
                                                     rank);
  } else {
    a2a_kernel<false><<<blocks, threads, 0, stream>>>(sh, p, rows_l, hrow,
                                                      w, rank);
  }
  return cudaGetLastError();
}
