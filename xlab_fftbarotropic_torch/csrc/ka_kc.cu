// ka, kc: the per-transform x-stage and forward partial y-stage.
//
// ka replaces pallas_fft._ka_call / _ka_kernel
// (xlab_fftbarotropic_tpu/ops/pallas_fft.py:549) in every mode: for each
// column j of the (n, m) planes x = xr + i xi (xi NULL: real input) it
// runs the colfft along the n rows, forward (exp(-...)) or inverse
// (exp(+...)), unnormalized, multiplies by `scale` (the TPU kernel folds
// it into its DFT matrix) and writes the row out[j, :] of the transposed
// (m, n) planes.
//
// kc replaces pallas_fft._kc_call / _kc_kernel (:1349): for each column
// x of the y-major (ny, nx) complex planes it runs the forward colfft
// along y and keeps rows k <= ny/2, written as out[x, k] (nx, ny/2 + 1).
//
// Together they are the shallow-water forcing spectrum
// (pallas_sw.forward_planes: kc(ka(src, forward, real input))), once per
// segment. Bound: memory traffic; the column reads are strided, the row
// writes contiguous. At 4096^2 ka (real input) reads 67 MB and writes
// 134 MB, kc reads 134 MB and writes 67 MB.
#include "colfft.cuh"

namespace {

template <int SIGN>
__global__ void ka_kernel(const float* __restrict__ xr,
                          const float* __restrict__ xi,
                          const float2* __restrict__ tw,
                          float* __restrict__ yr, float* __restrict__ yi,
                          int n, int logn, int m, float scale) {
  extern __shared__ float2 s[];
  const int j = blockIdx.x;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const size_t off = static_cast<size_t>(i) * m + j;
    s[xfb::bitrev(i, logn)] =
        make_float2(xr[off], xi == nullptr ? 0.f : xi[off]);
  }
  xfb::colfft<SIGN>(s, n, logn, tw);
  const size_t row = static_cast<size_t>(j) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float2 v = s[i];
    yr[row + i] = v.x * scale;
    yi[row + i] = v.y * scale;
  }
}

__global__ void kc_kernel(const float* __restrict__ xr,
                          const float* __restrict__ xi,
                          const float2* __restrict__ tw,
                          float* __restrict__ yr, float* __restrict__ yi,
                          int ny, int logny, int nx) {
  extern __shared__ float2 s[];
  const int x = blockIdx.x;
  for (int y = threadIdx.x; y < ny; y += blockDim.x) {
    const size_t off = static_cast<size_t>(y) * nx + x;
    s[xfb::bitrev(y, logny)] = make_float2(xr[off], xi[off]);
  }
  xfb::colfft<-1>(s, ny, logny, tw);
  const int hny = ny / 2 + 1;
  const size_t row = static_cast<size_t>(x) * hny;
  for (int k = threadIdx.x; k < hny; k += blockDim.x) {
    const float2 v = s[k];
    yr[row + k] = v.x;
    yi[row + k] = v.y;
  }
}

template <int SIGN>
int launch_ka(const float* xr, const float* xi, const void* tw, float* yr,
              float* yi, int n, int m, float scale, int device,
              void* stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float2);
  cudaError_t err = xfb::prepare(
      reinterpret_cast<const void*>(ka_kernel<SIGN>), device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ka_kernel<SIGN><<<m, xfb::threads_for(n), smem,
                    static_cast<cudaStream_t>(stream)>>>(
      xr, xi, static_cast<const float2*>(tw), yr, yi, n, xfb::ilog2(n), m,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xr, xi (xi NULL: real input): (n, m) -> yr, yi: (m, n)
extern "C" int xfb_ka(const float* xr, const float* xi, const void* tw,
                      float* yr, float* yi, int n, int m, int forward,
                      float scale, int device, void* stream) {
  return forward ? launch_ka<-1>(xr, xi, tw, yr, yi, n, m, scale, device,
                                 stream)
                 : launch_ka<+1>(xr, xi, tw, yr, yi, n, m, scale, device,
                                 stream);
}

// xr, xi: (ny, nx) -> yr, yi: (nx, ny/2 + 1)
extern "C" int xfb_kc(const float* xr, const float* xi, const void* tw,
                      float* yr, float* yi, int ny, int nx, int device,
                      void* stream) {
  const size_t smem = static_cast<size_t>(ny) * sizeof(float2);
  cudaError_t err = xfb::prepare(reinterpret_cast<const void*>(kc_kernel),
                                 device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kc_kernel<<<nx, xfb::threads_for(ny), smem,
              static_cast<cudaStream_t>(stream)>>>(
      xr, xi, static_cast<const float2*>(tw), yr, yi, ny, xfb::ilog2(ny),
      nx);
  return static_cast<int>(cudaGetLastError());
}
