// The elementwise expressions several kernels share, each written once.
//
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn: nvcc never contracts them into an FMA), in the order of the
// torch plain versions. A fused kernel and the unfused pair it replaces
// then give the same bits: kb_adv, kb_adv_tracer and ky_adv (advection),
// kx_visc, visc and kc_visc (the viscosity epilogue), kx_visc's tail and
// rk4_combine (the RK4 tail). ka_adv's advection rounds as ops/fused_fft.py
// advection, and ka_fwd's and ky_all's products (sw_product) in the
// order of ops/fused_sw.py sw_products, so ka (kc for ky_all) of the
// advection or products formed in torch gives their bits.
#pragma once

#include <cuda_runtime.h>

namespace xfb {

// -(u zx) - v zy + src, with zy + beta first for beta != 0 (beta = 0 is
// the f-plane expression): pallas_fft._ky_adv_kernel's order (:1512-1513)
__device__ __forceinline__ float advection(float u, float zx, float v,
                                           float zy, float src, float beta) {
  if (beta != 0.f) zy = __fadd_rn(zy, beta);
  return __fadd_rn(__fsub_rn(-__fmul_rn(u, zx), __fmul_rn(v, zy)), src);
}

// mask * (F + nulap * Z) with nulap = nu * lap, for both parts:
// pallas_fft._visc_epilogue (:1536)
__device__ __forceinline__ float2 visc(float nu, float lap, float mask,
                                       float2 f, float zr, float zi) {
  const float nulap = __fmul_rn(nu, lap);
  return make_float2(__fmul_rn(mask, __fadd_rn(f.x, __fmul_rn(nulap, zr))),
                     __fmul_rn(mask, __fadd_rn(f.y, __fmul_rn(nulap, zi))));
}

// z0 + coef * r: the RK stage update
__device__ __forceinline__ float axpy(float z0, float coef, float r) {
  return __fadd_rn(z0, __fmul_rn(coef, r));
}

// z0 + (r1 + 2 r2 + 2 r3 + r4) * c in that grouping (c = dt/6,
// main.cpp:309-312): pallas_sw._rk4_combine_kernel
__device__ __forceinline__ float rk4_tail(float z0, float r1, float r2,
                                          float r3, float r4, float c) {
  float t = __fadd_rn(r1, __fmul_rn(2.0f, r2));
  t = __fadd_rn(t, __fmul_rn(2.0f, r3));
  t = __fadd_rn(t, r4);
  return __fadd_rn(z0, __fmul_rn(t, c));
}

constexpr int kSwProducts = 5;  // q u, q v, eta u, eta v, phi

// Product p of the shallow-water forward stage at `off` of the u, v,
// zeta, eta_s planes: q u, q v, eta u, eta v, phi, with eta = eta_s
// ies (exact: ies is a power of two), q = zeta + f0 and phi = g eta +
// (u u + v v) / 2; split leaves out f0 and g eta. Reads only the planes
// product p needs: pallas_sw._ka_fwd_kernel (:450) and _ky_all_kernel
// (:513), in sw_products' order.
__device__ __forceinline__ float sw_product(int p, const float* __restrict__ u,
                                            const float* __restrict__ v,
                                            const float* __restrict__ zeta,
                                            const float* __restrict__ eta_s,
                                            size_t off, float ies, float f0,
                                            float grav, bool split) {
  if (p < 2) {
    const float z = __ldg(zeta + off);
    const float q = split ? z : __fadd_rn(z, f0);
    return __fmul_rn(q, __ldg((p == 0 ? u : v) + off));
  }
  if (p < 4) {
    const float eta = __fmul_rn(__ldg(eta_s + off), ies);
    return __fmul_rn(eta, __ldg((p == 2 ? u : v) + off));
  }
  const float a = __ldg(u + off), b = __ldg(v + off);
  const float ke =
      __fmul_rn(0.5f, __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)));
  if (split) return ke;
  return __fadd_rn(__fmul_rn(grav, __fmul_rn(__ldg(eta_s + off), ies)), ke);
}

// sw_product at off .. off + 3 (16-byte aligned, ky_all's plane tile):
// one 16-byte read of each plane product p needs, each of the four
// values rounded as sw_product rounds it.
__device__ __forceinline__ float4 sw_product4(
    int p, const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ zeta, const float* __restrict__ eta_s,
    size_t off, float ies, float f0, float grav, bool split) {
  const auto ld = [off](const float* x) {
    return __ldg(reinterpret_cast<const float4*>(x + off));
  };
  const auto each = [](float4 a, float4 b, auto f) {
    return make_float4(f(a.x, b.x), f(a.y, b.y), f(a.z, b.z), f(a.w, b.w));
  };
  if (p < 2) {
    return each(ld(zeta), ld(p == 0 ? u : v), [&](float z, float w) {
      return __fmul_rn(split ? z : __fadd_rn(z, f0), w);
    });
  }
  if (p < 4) {
    return each(ld(eta_s), ld(p == 2 ? u : v), [&](float e, float w) {
      return __fmul_rn(__fmul_rn(e, ies), w);
    });
  }
  const float4 ke = each(ld(u), ld(v), [](float a, float b) {
    return __fmul_rn(0.5f, __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)));
  });
  if (split) return ke;
  return each(ke, ld(eta_s), [&](float k, float e) {
    return __fadd_rn(__fmul_rn(grav, __fmul_rn(e, ies)), k);
  });
}

}  // namespace xfb
