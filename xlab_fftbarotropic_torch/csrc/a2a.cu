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
// The shards are reached through two tables of P base pointers on the
// card, one for the sources and one for the destinations, never through
// one tensor's strides: here every pointer points into one stacked
// tensor on one card. A later executor with one process per card passes
// peer-mapped pointers to the same kernel, with a barrier across the
// cards before the launch (the sources are written) and after it (the
// destinations are complete); each card then launches only the blocks
// whose destination rows (to columns) or source rows (to rows) are its
// own.
//
// Block g moves global row g = s rows_l + r: the row side's contiguous
// hpad values (row r of shard s) against the P column shards' contiguous
// runs of w (row g of each), so reads and writes coalesce. Bound: bytes,
// each value read and written once (at 4096^2 and P = 4, 67 MB each
// way). A copy: the result is the plain version's bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool TO_COLS>
__global__ void a2a_kernel(const long long* __restrict__ src,
                           const long long* __restrict__ dst, int rows_l,
                           int hrow, int w, int p) {
  const int g = blockIdx.x;
  const int s = g / rows_l;
  const int r = g - s * rows_l;
  const size_t row = static_cast<size_t>(r) * hrow;
  const size_t col = static_cast<size_t>(g) * w;
  if (TO_COLS) {
    const float2* in = reinterpret_cast<const float2*>(src[s]) + row;
    for (int c = threadIdx.x; c < p * w; c += blockDim.x) {
      const int t = c / w;
      float2* out = reinterpret_cast<float2*>(dst[t]) + col;
      out[c - t * w] = c < hrow ? in[c] : make_float2(0.f, 0.f);
    }
  } else {
    float2* out = reinterpret_cast<float2*>(dst[s]) + row;
    for (int c = threadIdx.x; c < hrow; c += blockDim.x) {
      const int t = c / w;
      const float2* in = reinterpret_cast<const float2*>(src[t]) + col;
      out[c] = in[c - t * w];
    }
  }
}

}  // namespace

// src, dst: device tables of p base pointers (int64); p shards of rows_l
// rows; hrow the row side's width, w the column side's; to_cols picks the
// direction.
extern "C" int xfb_a2a(const long long* src, const long long* dst, int p,
                       int rows_l, int hrow, int w, int to_cols, int device,
                       cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (to_cols) {
    a2a_kernel<true><<<p * rows_l, kThreads, 0, stream>>>(src, dst, rows_l,
                                                          hrow, w, p);
  } else {
    a2a_kernel<false><<<p * rows_l, kThreads, 0, stream>>>(src, dst, rows_l,
                                                           hrow, w, p);
  }
  return cudaGetLastError();
}
