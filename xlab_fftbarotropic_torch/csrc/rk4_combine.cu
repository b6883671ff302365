// rk4_combine, plane_axpy: the RK4 tail and the RK stage update over a
// tuple of same-shape float32 planes.
//
// rk4_combine replaces pallas_sw.plane_rk4_combine / _rk4_combine_kernel
// (xlab_fftbarotropic_tpu/ops/pallas_sw.py:971). For each plane p:
//   out_p = s0_p + (r1_p + 2 r2_p + 2 r3_p + r4_p) * c      (c = dt/6)
// in that grouping (main.cpp:309-312). plane_axpy replaces
// pallas_sw.plane_axpy / _axpy_kernel (:946): out_p = s_p + coef * r_p,
// the stage state of the unfused SW RK4 form. Every product and sum is
// rounded on its own (__fmul_rn, __fadd_rn, no contraction), as the
// torch elementwise arithmetic does, so these kernels, their plain
// versions and the axpy that sw_combine and kx_visc fuse in give the
// same bits.
//
// Bound: memory traffic. rk4_combine moves 6 values per 7 flops: at
// 4096^2 one call on two planes (re, im) of (4096, 2049) reads 10 planes
// and writes 2, about 403 MB. plane_axpy on the six SW planes reads 12
// and writes 6, about 604 MB. One launch covers every plane (grid y =
// plane), a grid-stride loop with consecutive threads on consecutive
// elements.
#include "epilogue.cuh"

namespace {

constexpr int kMaxPlanes = 8;
constexpr int kThreads = 256;

struct Planes {
  const float* s0[kMaxPlanes];
  const float* r1[kMaxPlanes];
  const float* r2[kMaxPlanes];
  const float* r3[kMaxPlanes];
  const float* r4[kMaxPlanes];
  float* out[kMaxPlanes];
};

__global__ void rk4_combine_kernel(Planes p, long long numel, float c) {
  const int q = blockIdx.y;
  const float* __restrict__ s0 = p.s0[q];
  const float* __restrict__ r1 = p.r1[q];
  const float* __restrict__ r2 = p.r2[q];
  const float* __restrict__ r3 = p.r3[q];
  const float* __restrict__ r4 = p.r4[q];
  float* __restrict__ out = p.out[q];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < numel; i += stride) {
    out[i] = xfb::rk4_tail(s0[i], r1[i], r2[i], r3[i], r4[i], c);
  }
}

struct AxpyPlanes {
  const float* s[kMaxPlanes];
  const float* r[kMaxPlanes];
  float* out[kMaxPlanes];
};

__global__ void plane_axpy_kernel(AxpyPlanes p, long long numel,
                                  float coef) {
  const int q = blockIdx.y;
  const float* __restrict__ s = p.s[q];
  const float* __restrict__ r = p.r[q];
  float* __restrict__ out = p.out[q];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < numel; i += stride) {
    out[i] = xfb::axpy(s[i], coef, r[i]);
  }
}

unsigned grid_x(long long numel) {
  long long blocks = (numel + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;  // grid-stride beyond ~31 blocks/SM
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks);
}

}  // namespace

// ptrs: host array of 6 * n_planes device pointers, in the order
// s0[0..n), r1[0..n), r2[0..n), r3[0..n), r4[0..n), out[0..n);
// numel: elements per plane.
extern "C" int xfb_rk4_combine(const void* const* ptrs, int n_planes,
                               long long numel, float c, int device,
                               void* stream) {
  if (n_planes < 1 || n_planes > kMaxPlanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Planes p = {};
  for (int q = 0; q < n_planes; ++q) {
    p.s0[q] = static_cast<const float*>(ptrs[q]);
    p.r1[q] = static_cast<const float*>(ptrs[n_planes + q]);
    p.r2[q] = static_cast<const float*>(ptrs[2 * n_planes + q]);
    p.r3[q] = static_cast<const float*>(ptrs[3 * n_planes + q]);
    p.r4[q] = static_cast<const float*>(ptrs[4 * n_planes + q]);
    p.out[q] = const_cast<float*>(
        static_cast<const float*>(ptrs[5 * n_planes + q]));
  }
  rk4_combine_kernel<<<dim3(grid_x(numel), n_planes), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(p, numel, c);
  return static_cast<int>(cudaGetLastError());
}

// ptrs: host array of 3 * n_planes device pointers, in the order
// s[0..n), r[0..n), out[0..n); numel: elements per plane.
extern "C" int xfb_plane_axpy(const void* const* ptrs, int n_planes,
                              long long numel, float coef, int device,
                              void* stream) {
  if (n_planes < 1 || n_planes > kMaxPlanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  AxpyPlanes p = {};
  for (int q = 0; q < n_planes; ++q) {
    p.s[q] = static_cast<const float*>(ptrs[q]);
    p.r[q] = static_cast<const float*>(ptrs[n_planes + q]);
    p.out[q] = const_cast<float*>(
        static_cast<const float*>(ptrs[2 * n_planes + q]));
  }
  plane_axpy_kernel<<<dim3(grid_x(numel), n_planes), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p, numel, coef);
  return static_cast<int>(cudaGetLastError());
}
