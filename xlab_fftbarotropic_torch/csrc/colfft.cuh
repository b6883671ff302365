// colfft: the DFT device function of kb_adv_tracer.cu, the one FFT
// stepping kernel left that transforms one column per block (the others
// run the column tile of xtile.cuh).
//
// A block transforms one column of length n (a power of two, 64..8192)
// held in shared memory as float2 (re, im): an in-place iterative
// radix-2 decimation-in-time FFT. The caller stores its input at the
// bit-reversed position (xfb::bitrev) and reads the result in natural
// order after the call. Unnormalized, either sign.
//
// This takes the place of pallas_fft._four_step (and the p/q partial
// sums of _kb_compute, the stage-restricted _kc_body): the TPU kernels
// factor the DFT into matmuls for the MXU; here the column fits in
// shared memory (8192 complex64 values are 64 KB) and the butterflies
// run on the CUDA cores in float32.
//
// Twiddles come from a table tw[k] = exp(-2 pi i k / n), k < n/2, built
// on the host in float64 and rounded to float32 (sincosf at large n
// costs accuracy); the inverse sign reads the conjugate.
#pragma once

#include <cuda_runtime.h>

namespace xfb {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ int bitrev(int i, int logn) {
  return static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - logn));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// SIGN = -1: forward exp(-2 pi i jk/n); SIGN = +1: inverse exp(+...).
// Every thread of the block must call it; it synchronises before the
// first stage (the caller's stores) and after the last.
template <int SIGN>
__device__ __forceinline__ void colfft(float2* s, int n, int logn,
                                       const float2* __restrict__ tw) {
  __syncthreads();
  const int half = n >> 1;
  for (int lh = 0; lh < logn; ++lh) {
    const int h = 1 << lh;
    const int tshift = logn - 1 - lh;  // twiddle stride n / (2h)
    for (int b = threadIdx.x; b < half; b += blockDim.x) {
      const int k = b & (h - 1);
      const int i0 = ((b >> lh) << (lh + 1)) + k;
      const int i1 = i0 + h;
      float2 w = __ldg(&tw[k << tshift]);
      if (SIGN > 0) w.y = -w.y;
      const float2 x0 = s[i0];
      const float2 t = cmul(w, s[i1]);
      s[i0] = make_float2(x0.x + t.x, x0.y + t.y);
      s[i1] = make_float2(x0.x - t.x, x0.y - t.y);
    }
    __syncthreads();
  }
}

inline int ilog2(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

inline int threads_for(int n) {
  return n / 2 < kMaxThreads ? n / 2 : kMaxThreads;
}

// Select the caller's device and allow the column's dynamic shared
// memory (above 48 KB only after this attribute is set).
inline cudaError_t prepare(const void* kernel, int device, size_t smem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  return err;
}

}  // namespace xfb
