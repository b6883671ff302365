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
// Block c pulls column c's nx values from the P source shards, runs the
// shared colfft (csrc/colfft.cuh) forward or inverse, unnormalized, times
// `scale`, and pushes the column to the P row owners (xstage, scatter) or
// into its owner's x-pencil (gather; a pad column c >= hrow is written as
// zeros). Columns are independent, so one launch needs no semaphores: the
// many resident blocks overlap one column's loads with another's
// butterflies, which the TPU kernel arranged by hand with its chunk
// pipeline (n_chunks 128-lane chunks, a TPU tiling rule not carried
// over).
//
// The shards are reached through two tables of P base pointers on the
// card (sources, destinations), never through one tensor's strides: here
// every pointer points into one stacked tensor on one card. A later
// executor with one process per card passes peer-mapped pointers to the
// same kernel, with a barrier across the cards before the launch and
// after it, and each card launches the blocks of its own w columns.
//
// Bound: bytes (at 4096^2, P = 4: 67 MB read, 67 MB written; the DFT's
// 0.5 GFLOP are under a tenth of that time at the float32 rate). The
// row-layout side is read or written along columns, strided by hrow, as
// the per-transform ka reads its columns (csrc/ka_kc.cu).
#include "colfft.cuh"

namespace {

constexpr int kRows = 0;    // row shards (rows_l, hrow)
constexpr int kPencil = 1;  // x-pencil column shards (nx, w)

template <int LAYOUT>
__device__ __forceinline__ size_t element(const long long* __restrict__ ptr,
                                          int g, int c, int rows_l, int hrow,
                                          int w, long long* base) {
  if (LAYOUT == kRows) {
    const int s = g / rows_l;
    *base = __ldg(&ptr[s]);
    return static_cast<size_t>(g - s * rows_l) * hrow + c;
  }
  const int t = c / w;
  *base = __ldg(&ptr[t]);
  return static_cast<size_t>(g) * w + (c - t * w);
}

template <int SIGN, int SRC, int DST>
__global__ void xstage_kernel(const long long* __restrict__ src,
                              const long long* __restrict__ dst,
                              const float2* __restrict__ tw, int nx,
                              int lognx, int rows_l, int hrow, int w,
                              float scale) {
  extern __shared__ float2 s[];
  const int c = blockIdx.x;
  long long base;
  if (c >= hrow) {  // a pad column of the x-pencil: zeros, no transform
    for (int g = threadIdx.x; g < nx; g += blockDim.x) {
      const size_t off = element<DST>(dst, g, c, rows_l, hrow, w, &base);
      reinterpret_cast<float2*>(base)[off] = make_float2(0.f, 0.f);
    }
    return;
  }
  for (int g = threadIdx.x; g < nx; g += blockDim.x) {
    const size_t off = element<SRC>(src, g, c, rows_l, hrow, w, &base);
    s[xfb::bitrev(g, lognx)] = reinterpret_cast<const float2*>(base)[off];
  }
  xfb::colfft<SIGN>(s, nx, lognx, tw);
  for (int g = threadIdx.x; g < nx; g += blockDim.x) {
    const size_t off = element<DST>(dst, g, c, rows_l, hrow, w, &base);
    const float2 v = s[g];
    reinterpret_cast<float2*>(base)[off] = make_float2(v.x * scale,
                                                       v.y * scale);
  }
}

template <int SRC, int DST>
cudaError_t launch(const long long* src, const long long* dst,
                   const float2* tw, int nx, int rows_l, int hrow, int w,
                   int columns, int forward, float scale, int device,
                   cudaStream_t stream) {
  const void* kernel =
      forward ? reinterpret_cast<const void*>(&xstage_kernel<-1, SRC, DST>)
              : reinterpret_cast<const void*>(&xstage_kernel<1, SRC, DST>);
  const size_t smem = static_cast<size_t>(nx) * sizeof(float2);
  cudaError_t err = xfb::prepare(kernel, device, smem);
  if (err != cudaSuccess) return err;
  const int lognx = xfb::ilog2(nx);
  const int threads = xfb::threads_for(nx);
  if (forward) {
    xstage_kernel<-1, SRC, DST><<<columns, threads, smem, stream>>>(
        src, dst, tw, nx, lognx, rows_l, hrow, w, scale);
  } else {
    xstage_kernel<1, SRC, DST><<<columns, threads, smem, stream>>>(
        src, dst, tw, nx, lognx, rows_l, hrow, w, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// src, dst: device tables of p base pointers (int64); tw: colfft's
// (nx/2) twiddles; mode 0 xstage (rows -> rows), 1 gather (rows ->
// x-pencil), 2 scatter (x-pencil -> rows); p shards of rows_l rows, hrow
// the half axis, w the x-pencil width.
extern "C" int xfb_xstage(const long long* src, const long long* dst,
                          const float2* tw, int p, int rows_l, int hrow,
                          int w, int mode, int forward, float scale,
                          int device, cudaStream_t stream) {
  const int nx = p * rows_l;
  switch (mode) {
    case 0:
      return launch<kRows, kRows>(src, dst, tw, nx, rows_l, hrow, w, hrow,
                                  forward, scale, device, stream);
    case 1:
      return launch<kRows, kPencil>(src, dst, tw, nx, rows_l, hrow, w, p * w,
                                    forward, scale, device, stream);
    case 2:
      return launch<kPencil, kRows>(src, dst, tw, nx, rows_l, hrow, w, hrow,
                                    forward, scale, device, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
