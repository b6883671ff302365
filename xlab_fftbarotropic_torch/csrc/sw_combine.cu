// sw_combine: the three dealiased shallow-water tendencies, with the RK
// stage update or the ETDRK4 stage matvec optionally fused in.
//
// Replaces pallas_sw.forward_tendencies' COMBINE, _combine_kernel
// (xlab_fftbarotropic_tpu/ops/pallas_sw.py:671), _combine_axpy_kernel
// (:679) and _combine_mv_kernel (:693), all around _combine_body (:610).
// Per spectral point (x, k), from the product spectra P (5, nx, hny) =
// QU, QV, EU, EV, PHI, the CURRENT stage state Z, D, E and the forcing
// spectrum S:
//   dzeta = mask * (-(i kx) QU - (i ky) QV + nu lap Z (+ S))
//   ddiv  = mask * ( (i kx) QV - (i ky) QU - lap PHI + nu lap D)
//   deta  = mask * (-(i kx) EU - (i ky) EV - H D)
// and with split on, -f0 D and f0 Z - g lap E where lap != 0 (the mean
// mode, where curl and div of f0 u vanish, takes neither).
//
// xfb_sw_combine, with the axpy, also writes next = z0 + coef * tendency
// from the BASE state z0, which is not the stage state the viscosity and
// -H D read. xfb_sw_combine_mv writes the ETDRK4 stage
// stage = z0 + scale * (Q @ tendency) with Q the per-mode 3x3 table
// (3, 3, nx, hny) of models/etdrk4.py, per row i of Q and per re/im
// plane: ((z0 + (scale q_i0) t_z) + (scale q_i1) t_d) + (scale q_i2) t_e;
// the tendency itself is written only when asked for (the last ETDRK4
// stage never reads it again).
//
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, no contraction) in the order of the torch expression, so
// the kernels, their plain torch versions and the unfused stage updates
// give the same bits.
//
// Bound: memory traffic, one thread per point with consecutive threads
// on consecutive points. At 4096^2 (one half plane 33.6 MB) sw_combine
// reads 16 half planes (18 with the forcing; and the 6 of z0 with the
// axpy) and writes 6 (12). sw_combine_mv reads those 18, the 9 of Q and
// the 6 of z0 and writes 12 (6 without the tendency): 45 planes, 1.51 GB,
// 0.45 ms at 3.35 TB/s (39 planes, 1.31 GB, 0.39 ms).
//
// The bf16 product forms (xfb_sw_combine_bf16, xfb_sw_combine_mv_bf16:
// the same _combine_axpy_kernel and _combine_mv_kernel reading the
// product spectra kx_fwd stores in bf16 under the JAX package's
// XFB_SW_PSTORE, pallas_sw.py:152-197, the shallow-water fast mode's
// default) read kPr and kPi as bf16 and widen each value exactly
// (__bfloat162float) before the unchanged float32 arithmetic, so a bf16
// form gives the bits of its float32 form run on the upcast products.
// The 10 product planes cost half their float32 bytes: sw_combine with
// the axpy and the forcing 31 float32-plane equivalents, 1.04 GB, 0.311
// ms at 3.35 TB/s (float32 36 planes, 0.361 ms); sw_combine_mv with the
// tendency 40, 1.34 GB, 0.401 ms (45 planes, 0.451 ms). The float32
// forms' code is unchanged (the kernels' <float> instances).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

// pointer table, in the order the wrappers pass it: the inputs shared by
// both entry points, then sw_combine's outputs, or sw_combine_mv's Q
// base pointer and its outputs
enum {
  kPr, kPi, kZr, kZi, kDr, kDi, kEr, kEi, kSr, kSi, kKx, kKy, kLap, kMask,
  kZ0, kTend = kZ0 + 6, kNext = kTend + 6, kNumPtrs = kNext + 6,
  kQ = kZ0 + 6, kMvTend = kQ + 1, kMvStage = kMvTend + 6,
  kMvNumPtrs = kMvStage + 6
};

struct Ptrs {
  const float* in[kTend];
  float* out[12];
};

struct MvPtrs {
  const float* in[kMvTend];
  float* out[12];  // tendency x 6 (all null: not written), stage x 6
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// value i of the product planes in[k] of type P (float; or bf16,
// widened exactly)
template <class P>
__device__ __forceinline__ float product(const float* const* in, int k,
                                         long long i) {
  if constexpr (std::is_same_v<P, float>) {
    return in[k][i];
  } else {
    return __bfloat162float(reinterpret_cast<const P*>(in[k])[i]);
  }
}

// the six dealiased tendency values (dzr, dzi, ddr, ddi, der, dei) at
// point i of the planes, the product spectra of type P
template <class P>
__device__ __forceinline__ void tendency(const float* const* in, long long i,
                                         long long plane, int hny, float f0,
                                         float grav, float nu, float H,
                                         int split, float t[6]) {
  const float k = in[kKx][i / hny];
  const float q = in[kKy][i % hny];
  const float lap = in[kLap][i];
  const float mask = in[kMask][i];
  const float qur = product<P>(in, kPr, i), qui = product<P>(in, kPi, i);
  const float qvr = product<P>(in, kPr, plane + i),
              qvi = product<P>(in, kPi, plane + i);
  const float eur = product<P>(in, kPr, 2 * plane + i),
              eui = product<P>(in, kPi, 2 * plane + i);
  const float evr = product<P>(in, kPr, 3 * plane + i),
              evi = product<P>(in, kPi, 3 * plane + i);
  const float phr = product<P>(in, kPr, 4 * plane + i),
              phi = product<P>(in, kPi, 4 * plane + i);
  const float zr = in[kZr][i], zi = in[kZi][i];
  const float dr = in[kDr][i], di = in[kDi][i];
  const float nulap = mul(nu, lap);
  float dzr = add(add(mul(k, qui), mul(q, qvi)), mul(nulap, zr));
  float dzi = add(sub(mul(-k, qur), mul(q, qvr)), mul(nulap, zi));
  float ddr = add(sub(add(mul(-k, qvi), mul(q, qui)), mul(lap, phr)),
                  mul(nulap, dr));
  float ddi = add(sub(sub(mul(k, qvr), mul(q, qur)), mul(lap, phi)),
                  mul(nulap, di));
  if (split) {
    const float fz = lap != 0.f ? f0 : 0.f;
    const float er = in[kEr][i], ei = in[kEi][i];
    dzr = sub(dzr, mul(fz, dr));
    dzi = sub(dzi, mul(fz, di));
    ddr = sub(add(ddr, mul(fz, zr)), mul(grav, mul(lap, er)));
    ddi = sub(add(ddi, mul(fz, zi)), mul(grav, mul(lap, ei)));
  }
  if (in[kSr] != nullptr) {
    dzr = add(dzr, in[kSr][i]);
    dzi = add(dzi, in[kSi][i]);
  }
  t[0] = mul(mask, dzr);
  t[1] = mul(mask, dzi);
  t[2] = mul(mask, ddr);
  t[3] = mul(mask, ddi);
  t[4] = mul(mask, sub(add(mul(k, eui), mul(q, evi)), mul(H, dr)));
  t[5] = mul(mask, sub(sub(mul(-k, eur), mul(q, evr)), mul(H, di)));
}

template <class P>
__global__ void sw_combine_kernel(Ptrs p, int nx, int hny, float f0,
                                  float grav, float nu, float H, int split,
                                  float coef) {
  const long long plane = static_cast<long long>(nx) * hny;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < plane; i += stride) {
    float t[6];
    tendency<P>(p.in, i, plane, hny, f0, grav, nu, H, split, t);
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      p.out[c][i] = t[c];
      if (p.out[6 + c] != nullptr) {
        p.out[6 + c][i] = add(p.in[kZ0 + c][i], mul(coef, t[c]));
      }
    }
  }
}

template <class P>
__global__ void sw_combine_mv_kernel(MvPtrs p, int nx, int hny, float f0,
                                     float grav, float nu, float H,
                                     int split, float scale) {
  const long long plane = static_cast<long long>(nx) * hny;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const float* qt = p.in[kQ];
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < plane; i += stride) {
    float t[6];
    tendency<P>(p.in, i, plane, hny, f0, grav, nu, H, split, t);
    if (p.out[0] != nullptr) {
#pragma unroll
      for (int c = 0; c < 6; ++c) p.out[c][i] = t[c];
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float q0 = mul(scale, qt[(3 * r) * plane + i]);
      const float q1 = mul(scale, qt[(3 * r + 1) * plane + i]);
      const float q2 = mul(scale, qt[(3 * r + 2) * plane + i]);
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // the re and the im plane
        p.out[6 + 2 * r + c][i] =
            add(add(add(p.in[kZ0 + 2 * r + c][i], mul(q0, t[c])),
                    mul(q1, t[2 + c])),
                mul(q2, t[4 + c]));
      }
    }
  }
}

unsigned grid_blocks(int nx, int hny) {
  const long long plane = static_cast<long long>(nx) * hny;
  long long blocks = (plane + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;  // grid-stride beyond ~31 blocks/SM
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks);
}

template <class P>
int combine(const void* const* ptrs, int nx, int hny, float f0, float grav,
            float nu, float H, int split, float coef, int device,
            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Ptrs p = {};
  for (int c = 0; c < kTend; ++c) p.in[c] = static_cast<const float*>(ptrs[c]);
  for (int c = 0; c < 12; ++c) {
    p.out[c] = const_cast<float*>(static_cast<const float*>(ptrs[kTend + c]));
  }
  sw_combine_kernel<P><<<grid_blocks(nx, hny), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      p, nx, hny, f0, grav, nu, H, split, coef);
  return static_cast<int>(cudaGetLastError());
}

template <class P>
int combine_mv(const void* const* ptrs, int nx, int hny, float f0,
               float grav, float nu, float H, int split, float scale,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  MvPtrs p = {};
  for (int c = 0; c < kMvTend; ++c) {
    p.in[c] = static_cast<const float*>(ptrs[c]);
  }
  for (int c = 0; c < 12; ++c) {
    p.out[c] =
        const_cast<float*>(static_cast<const float*>(ptrs[kMvTend + c]));
  }
  sw_combine_mv_kernel<P><<<grid_blocks(nx, hny), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      p, nx, hny, f0, grav, nu, H, split, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ptrs: host array of 32 device pointers: pr, pi (5, nx, hny); zr, zi,
// dr, di, er, ei; sr, si (NULL: no forcing); kx (nx,), ky (hny,); lap,
// mask; z0 x 6 (NULL: no axpy); tend x 6; next x 6 (NULL: no axpy). Every
// plane (nx, hny). er, ei are read only when split is set.
extern "C" int xfb_sw_combine(const void* const* ptrs, int nx, int hny,
                              float f0, float grav, float nu, float H,
                              int split, float coef, int device,
                              void* stream) {
  return combine<float>(ptrs, nx, hny, f0, grav, nu, H, split, coef, device,
                        stream);
}

// ptrs: host array of 33 device pointers: pr, pi (5, nx, hny); zr, zi,
// dr, di, er, ei; sr, si (NULL: no forcing); kx (nx,), ky (hny,); lap,
// mask; z0 x 6; Q (3, 3, nx, hny); tend x 6 (all NULL: not written);
// stage x 6. Every plane (nx, hny).
extern "C" int xfb_sw_combine_mv(const void* const* ptrs, int nx, int hny,
                                 float f0, float grav, float nu, float H,
                                 int split, float scale, int device,
                                 void* stream) {
  return combine_mv<float>(ptrs, nx, hny, f0, grav, nu, H, split, scale,
                           device, stream);
}

// The bf16 product forms: arguments as xfb_sw_combine's and
// xfb_sw_combine_mv's, with pr, pi bf16 (5, nx, hny) planes
extern "C" int xfb_sw_combine_bf16(const void* const* ptrs, int nx, int hny,
                                   float f0, float grav, float nu, float H,
                                   int split, float coef, int device,
                                   void* stream) {
  return combine<__nv_bfloat16>(ptrs, nx, hny, f0, grav, nu, H, split, coef,
                                device, stream);
}

extern "C" int xfb_sw_combine_mv_bf16(const void* const* ptrs, int nx,
                                      int hny, float f0, float grav,
                                      float nu, float H, int split,
                                      float scale, int device,
                                      void* stream) {
  return combine_mv<__nv_bfloat16>(ptrs, nx, hny, f0, grav, nu, H, split,
                                   scale, device, stream);
}
