// xtile: the transform of a column tile, shared by the x-stages of
// kx_visc.cu, xstage.cu, ka, ka_adv and ka_fwd (ka_kc.cu), ka_diag.cu
// and ka_sw.cu and the y-stages kc (ka_kc.cu), kb and kb_pair
// (kb_pair.cu), ky_adv (ky_adv.cu), ky_all (ky_all.cu), kb_adv
// (kb_adv.cu) and kb_adv_tracer (kb_adv_tracer.cu).
//
// Each transforms along an axis of length n (a power of two 64..8192)
// whose column axis is contiguous in memory. A tile of C adjacent
// columns belongs to a thread block cluster of K blocks
// (ops/xtile.py:xtile_plan picks C, K, the threads and the shared bytes
// from n alone, so every form of a kernel runs the same transform):
//
//   1. block r loads rows r, r + K, r + 2K, ... (m = n/K of them) of the
//      tile (cp.async, or plain loads where the load computes, as the
//      Hermitian one of the paired c2r y-stages, load_hermitian,
//      ky_adv's advection product and the fields and products of the
//      x-stages and ky_all, load_rows), consecutive lanes on consecutive
//      columns, so every row segment is C contiguous elements (64 or
//      128 bytes at C = 16): whole 32-byte sectors, where a block per
//      column would use 4 or 8 bytes of each;
//   2. it runs the length-m sub-DFT of each of its C columns in shared
//      memory: self-sorting (Stockham) radix-8, -4, -2 passes with the
//      butterflies in registers, the twiddles W_m^x staged in shared
//      memory from the float64-built table (no bit-reversed scatter);
//   3. after a cluster barrier, block q takes k2 in [q m/K, (q+1) m/K):
//      it reads Y_r[k2] of every block r through distributed shared
//      memory, twiddles it by W_n^(r k2), runs the length-K DFT over r
//      and hands X[k2 + m k1] (k1 < K) to the caller's epilogue, which
//      stores full row segments again (finish; gather and twiddle_dft
//      are its steps, which kb_adv runs on two tiles at once); or
//   3'. the transposed store (finish_transposed), for the y-stages and
//      the full-length x-stages (ka, ka_adv, ka_fwd, the field x-stages
//      of ka_diag.cu, ka_sw), whose output rows are the tile's columns:
//      after a second cluster barrier block q stages its m C outputs
//      column-major in its own tile (a column of m + 16/C values, so a
//      half warp's 16 stores hit 16 banks) and hands them to the
//      epilogue column by column, consecutive lanes on consecutive k:
//      each column's outputs are K runs of m/K contiguous k (64 at 4096,
//      256 bytes per plane). The fast ka, kc, kb and ky_all run it on
//      the plane tile (plane_transposed, below): their tile loaded as two
//      float planes where the rows are aligned, by 16-byte copies (ka,
//      kc) or 16-byte stores of four values formed in registers (kb's
//      Hermitian load, ky_all's products), the first pass inlined, and
//      the half stores (kc, ky_all) staging only the outputs they keep
//      (columns of m/2 + 16/C).
//
// X[k2 + m k1] = sum_r W_K^(r k1) W_n^(r k2) sum_j x[r + K j] W_m^(j k2):
// one pass over device memory whatever n. Each thread holds kElems
// complex values of every pass; the tile (m C values) and the W_m table
// are the block's dynamic shared memory. Every product and sum is
// rounded on its own (no contraction left to the compiler), so the same
// inputs give the same bits in every kernel that includes this.
//
// The fast form (FAST = true on subdft, finish and finish_transposed;
// the JAX package's --fast-transforms, pallas_fft.MM_MODE "default":
// one bf16 product per stage, float32 accumulate) runs step 2 as the
// passes of ops/xtile.py fast_radices: radix 16 on the tensor cores
// while 16 divides what is left, then the float32 radix-8/4/2 pass of
// the rest. A radix-16 pass twiddles its inputs in float32 (mul, as the
// strict pass), rounds each to bf16 (round to nearest even), and forms
// the 16-point DFT as the real block product
//   [Yr; Yi] = [[C, -Wi], [Wi, C]] [xr; xi]
// (C = cos, Wi = -SIGN sin of 2 pi f t / 16, each rounded once to bf16
// from float64 with the zeros exact, negation exact), four
// mma.sync.m16n8k16 bf16 products per 8 butterflies, each output summed
// in float32 by the tensor core. So the multiplications that round to
// bf16 are exactly those of the radix-16 DFT matrices: their data
// operand (the twiddled tile value) and their matrix entry. The
// twiddles between passes, the float32 pass, the K-point step
// (twiddle_dft) and every load and epilogue stay float32: at n = 4096
// (K = 8, m = 512: passes 16, 16, 2) two bf16-rounded stages per
// transform, as the JAX fast mode's two bf16 matmul stages there.
//
// The data movement is the fast form's own (pass16_first,
// pass16_second): at m = 512 (n = 512..4096) the float32 radix-2 pass
// runs on the second radix-16 pass's D registers (each lane holds both
// partners of its outputs), so the sub-DFT is two shared-memory round
// trips and four barriers where the strict one takes three and six;
// a lane map, a swizzled layout between the passes and one for their
// outputs (read back by gather<K, true>) put every tile load and store
// of a half warp on 16 bank pairs at C = 16 (and C = 8 at m = 512),
// where the radix-16 pass before them met 4-way conflicts on both. The
// passes are calls, not inlined (their registers are their own), but
// for the plane tile's first pass (its reads are its own). They
// read and write only the tile's m C slots, and take no more shared
// memory than the strict passes. The kernels stay bound by their
// float32 bytes (the DFT-16 products are under 0.01 ms of bf16 work
// per call at 4096^2); on an H100 the fast x-stages now run within a
// few per cent of their strict forms, the sub-DFT no dearer than the
// strict one, and the exchange and store of step 3 hold them back
// (PERF.md §6).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace xfb {
namespace xtile {

constexpr int kElems = 16;  // complex values per thread (ops/xtile.py ELEMS)

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}

__device__ __forceinline__ float2 mul(float2 a, float2 b) {
  return make_float2(__fmaf_rn(a.x, b.x, -__fmul_rn(a.y, b.y)),
                     __fmaf_rn(a.x, b.y, __fmul_rn(a.y, b.x)));
}

// a * W_4 (SIGN = -1: times -i; +1: times i), exact
template <int SIGN>
__device__ __forceinline__ float2 rot4(float2 a) {
  if constexpr (SIGN < 0) return make_float2(a.y, -a.x);
  return make_float2(-a.y, a.x);
}

// a * W_8
template <int SIGN>
__device__ __forceinline__ float2 rot8(float2 a) {
  constexpr float h = 0.70710678118654752f;
  return SIGN < 0 ? make_float2(__fmul_rn(h, __fadd_rn(a.x, a.y)),
                                __fmul_rn(h, __fsub_rn(a.y, a.x)))
                  : make_float2(__fmul_rn(h, __fsub_rn(a.x, a.y)),
                                __fmul_rn(h, __fadd_rn(a.x, a.y)));
}

// In-place length-R DFT of v[0..R), natural order in and out.
template <int R, int SIGN>
__device__ __forceinline__ void dft(float2* v) {
  if constexpr (R == 2) {
    const float2 a = v[0];
    v[0] = add(a, v[1]);
    v[1] = sub(a, v[1]);
  } else if constexpr (R == 4) {
    const float2 t0 = add(v[0], v[2]), t1 = sub(v[0], v[2]);
    const float2 t2 = add(v[1], v[3]), t3 = rot4<SIGN>(sub(v[1], v[3]));
    v[0] = add(t0, t2);
    v[2] = sub(t0, t2);
    v[1] = add(t1, t3);
    v[3] = sub(t1, t3);
  } else if constexpr (R == 8) {
    float2 e[4] = {v[0], v[2], v[4], v[6]};
    float2 o[4] = {v[1], v[3], v[5], v[7]};
    dft<4, SIGN>(e);
    dft<4, SIGN>(o);
    o[1] = rot8<SIGN>(o[1]);
    o[2] = rot4<SIGN>(o[2]);
    o[3] = rot8<SIGN>(rot4<SIGN>(o[3]));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = add(e[k], o[k]);
      v[k + 4] = sub(e[k], o[k]);
    }
  }
}

// W_n^idx (idx < n) of the sign from the half table tw[k] = exp(-2 pi i
// k / n), k < n/2, built in float64 and rounded once; negation is exact.
template <int SIGN>
__device__ __forceinline__ float2 twiddle(const float2* __restrict__ tw,
                                          int idx, int n) {
  const int half = n >> 1;
  float2 w = __ldg(&tw[idx & (half - 1)]);
  if (idx >= half) w = make_float2(-w.x, -w.y);
  if (SIGN > 0) w.y = -w.y;
  return w;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The cluster, in PTX (sm_90): this block's rank, a full barrier of every
// thread of every block (release, then acquire), its two halves, and the
// generic address of the same shared variable in block `rank`.
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

__device__ __forceinline__ float2* map_rank(float2* p, int rank) {
  unsigned long long out;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(out)
               : "l"(p), "r"(static_cast<unsigned>(rank)));
  return reinterpret_cast<float2*>(out);
}

// The block's view of its tile: s[j * C + c] holds row r + K j of column
// c (the load order), then Y_r[k2] after subdft; sw[x] = W_m^x (forward
// sign), x < m.
struct Tile {
  float2* s;
  float2* sw;
  int n, m, k, logc, rank;
};

// Call first: the shared layout, this block's rank in the cluster, and
// the W_m table staged (the loads may still be in flight).
__device__ __forceinline__ Tile begin(float2* smem,
                                      const float2* __restrict__ tw, int n,
                                      int k, int logc) {
  Tile t;
  t.n = n;
  t.k = k;
  t.m = n / k;
  t.logc = logc;
  t.rank = cluster_rank();
  t.s = smem;
  t.sw = smem + (t.m << logc);
  for (int x = threadIdx.x; x < t.m; x += blockDim.x) {
    t.sw[x] = twiddle<-1>(tw, x * k, n);
  }
  return t;
}

// One self-sorting radix-R pass over the tile: butterfly i (< m/R) of
// column c reads rows i + t m/R, twiddles input t by W_(pR)^(t k) with
// k = i mod p, and writes rows (i - k) R + k + t p.
template <int R, int SIGN>
__device__ __forceinline__ void pass(const Tile& t, int p) {
  constexpr int B = kElems / R;
  const int stride = t.m / R;
  const int cmask = (1 << t.logc) - 1;
  const int twstep = t.m / (p * R);
  float2 v[kElems];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int u = b * blockDim.x + threadIdx.x;
    const int c = u & cmask, i = u >> t.logc;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      v[b * R + q] = t.s[((i + q * stride) << t.logc) + c];
    }
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int u = b * blockDim.x + threadIdx.x;
    const int c = u & cmask, i = u >> t.logc;
    const int k = i & (p - 1);
    float2* x = v + b * R;
    if (p > 1) {
#pragma unroll
      for (int q = 1; q < R; ++q) {
        float2 w = t.sw[q * k * twstep];
        if (SIGN > 0) w.y = -w.y;
        x[q] = mul(x[q], w);
      }
    }
    dft<R, SIGN>(x);
    const int j = (i - k) * R + k;
#pragma unroll
    for (int q = 0; q < R; ++q) t.s[((j + q * p) << t.logc) + c] = x[q];
  }
  __syncthreads();
}

// ---- the fast radix-16 pass (FAST) ----

// bf16 bits of cos(2 pi x / 16), rounded once from float64 (the zeros
// exact): the magnitudes at x = 0..4 (ops/xtile.py DFT16_COS_BF16), and
// the rest by symmetry.
__device__ __forceinline__ unsigned cos16(int x) {
  x &= 15;
  if (x > 8) x = 16 - x;          // cos is even
  const bool neg = x > 4;         // cos(pi - a) = -cos(a)
  if (neg) x = 8 - x;
  const unsigned mag = x == 0   ? 0x3F80u
                       : x == 1 ? 0x3F6Du
                       : x == 2 ? 0x3F35u
                       : x == 3 ? 0x3EC4u
                                : 0x0000u;
  return neg ? mag | 0x8000u : mag;
}

// The A fragments (16 x 16, row-major, of mma m16n8k16) of C = cos and
// S = sin of 2 pi f t / 16, f the row (-S is S with both sign bits
// flipped, formed where it is used): this lane holds rows g, g + 8 and
// columns 2q, 2q + 1, 2q + 8, 2q + 9 (g = lane / 4, q = lane mod 4), the
// lower column in the lower half of each register.
struct Dft16 {
  unsigned c[4], s[4];
};

__device__ __forceinline__ Dft16 dft16() {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  Dft16 a;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int f = g + 8 * (r & 1), t = 2 * q + 8 * (r >> 1);
    a.c[r] = cos16(f * t) | cos16(f * (t + 1)) << 16;
    a.s[r] = cos16(f * t - 4) | cos16(f * (t + 1) - 4) << 16;
  }
  return a;
}

// lo, hi rounded to bf16 (nearest even), lo in the lower half
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// d += a b: one m16n8k16 bf16 product, float32 accumulate
__device__ __forceinline__ void mma16(float* d, const unsigned* a,
                                      const unsigned* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The fast passes' lane map. Lane (g, q) of warp w holds B column n = g
// (inputs t = 2q, 2q + 1, 2q + 8, 2q + 9) and D columns n = 2q, 2q + 1
// (outputs f = g, g + 8) of the mma groups h = 0..3; group h takes
// column quad h mod Q (Q = C/4, lq = log2 Q) and, by the pass,
//   plain (the first pass; the second one where nothing is folded in):
//     butterfly i = 32 w / C + (h >> lq) + (n >> 2) (4 >> lq) of column
//     4 (h mod Q) + ((n & 3) ^ (n >> 2));
//   fold (the second pass of m = 512, fold_butterfly): butterfly i = k +
//     (n & 1) p of one column per class n >> 1, so a lane's D columns
//     are the radix-2 partners i, i + p (rows r, r + m/2 of a column).
// Each lane loads its B fragments rotated over the groups (group (q + s)
// mod 4 at step s; selects between registers put them back in group
// order). The first pass (p = 1) writes the second one's input in a
// layout of its own (row x, column c at x C + (c ^ swizzle(x))), the
// second pass its outputs in another (out_swizzle). Every tile load and
// store of both passes then hits 16 bank pairs per half warp at C = 16,
// and at C = 8 where m = 512 (tests/test_torch_xtile.py counts them).
__device__ __forceinline__ int swizzle(const Tile& t, int x) {
  if (t.logc == 4) return ((x & 3) << 2) | (((x >> 4) & 1) << 1);
  if (t.logc == 3) return (((x >> 1) & 1) << 2) | ((x >> 4) & 1);
  return 0;
}

// The layout the fast sub-DFT leaves its outputs in where the second
// pass is its last (m = 256, 512): row x, column c at x C + (c ^
// out_swizzle(x)), so that pass's stores need no rotation; gather<K,
// true> reads it back. m = 1024 (its float32 radix-4 pass reads the
// tile's rows) and the one-pass lengths: the rows as they are.
__device__ __forceinline__ int out_swizzle(const Tile& t, int x) {
  if (t.m != 256 && t.m != 512) return 0;
  if (t.logc == 4) return ((x >> 4) & 3) << 2;
  if (t.logc == 3) return ((x >> 4) & 3) << 1;
  return 0;
}

// b[h] <- x where h == slot, for every h: the selects that put a B
// fragment loaded for group `slot` (which differs between the lanes) into
// that group's registers
__device__ __forceinline__ void put_slot(unsigned (&b)[4][4], int slot,
                                         const unsigned* x) {
#pragma unroll
  for (int h = 0; h < 4; ++h) {
#pragma unroll
    for (int r = 0; r < 4; ++r) b[h][r] = h == slot ? x[r] : b[h][r];
  }
}

// The plain map's butterfly of group h, fragment column n: (i, column).
__device__ __forceinline__ int2 plain_butterfly(const Tile& t, int h, int n) {
  const int lq = t.logc - 2;
  return make_int2(((threadIdx.x >> 5) << (5 - t.logc)) + (h >> lq) +
                       (n >> 2) * (4 >> lq),
                   4 * (h & ((1 << lq) - 1)) + ((n & 3) ^ (n >> 2)));
}

// The fold map's butterfly of group h, fragment column n: (i, column);
// at C = 8 the class x = n >> 1 sets k's parity, so that the row parity
// (a bank bit at C = 8) runs across the lanes.
__device__ __forceinline__ int2 fold_butterfly(const Tile& t, int h, int n) {
  const int w = threadIdx.x >> 5, x = n >> 1;
  int k, c;
  if (t.logc == 3) {
    k = 2 * w + (x & 1);
    c = 4 * (h & 1) + 2 * (h >> 1) + (x >> 1);
  } else {
    const int lq = t.logc - 2;
    k = (w << (4 - t.logc)) + (h >> lq);
    c = 4 * (h & ((1 << lq) - 1)) + x;
  }
  return make_int2(k + (n & 1) * (t.m >> 5), c);
}

// Yr = C xr - Wi xi, Yi = Wi xr + C xi (Wi = -SIGN S) of one group: four
// mma.sync products, C xr then -Wi xi into Yr, Wi xr then C xi into Yi
// (each sum's order is part of its bits).
template <int SIGN>
__device__ __forceinline__ void dft16_group(const Dft16& a,
                                            const unsigned* b, float* yr,
                                            float* yi) {
  unsigned ns[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) ns[r] = a.s[r] ^ 0x80008000u;
  const unsigned* wi = SIGN < 0 ? ns : a.s;
  const unsigned* mwi = SIGN < 0 ? a.s : ns;
#pragma unroll
  for (int e = 0; e < 4; ++e) yr[e] = yi[e] = 0.f;
  mma16(yr, a.c, b);
  mma16(yr, mwi, b + 2);
  mma16(yi, wi, b);
  mma16(yi, a.c, b + 2);
}

// This lane's B fragment of one butterfly: inputs t = 2q, 2q + 1, 2q + 8,
// 2q + 9 from rows i + t m/16 of column c (`swz`: of the second pass's
// input layout), each times its twiddle W_(16 p)^(t k) for t > 0 where
// k >= 0 (the second pass: p = 16, k = i mod 16; conjugated for SIGN =
// +1), rounded to bf16: b = {re t, t + 1; re t + 8, t + 9; im ..; im ..}.
template <int SIGN>
__device__ __forceinline__ void load_b(const Tile& t, int i, int c, bool swz,
                                       int k, unsigned* b) {
  const int stride = t.m >> 4, twstep = t.m >> 8, q = threadIdx.x & 3;
  float2 x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int tt = 2 * q + (e & 1) + 8 * (e >> 1);
    const int row = i + tt * stride;
    x[e] = t.s[(row << t.logc) + (swz ? c ^ swizzle(t, row) : c)];
    if (k >= 0 && tt > 0) {
      float2 w = t.sw[tt * k * twstep];
      if (SIGN > 0) w.y = -w.y;
      x[e] = mul(x[e], w);
    }
  }
  b[0] = bf16x2(x[0].x, x[1].x);
  b[1] = bf16x2(x[2].x, x[3].x);
  b[2] = bf16x2(x[0].y, x[1].y);
  b[3] = bf16x2(x[2].y, x[3].y);
}

// The first radix-16 pass (p = 1: no twiddles) on the tensor cores, the
// plain map: in(i, column, b) loads the B fragment of butterfly i (the
// tile's rows: load_b; the plane tile's: PlaneIn), out in the
// second pass's layout (`to_swizzled`) or the tile's rows (the only
// radix-16 pass, m < 256). The tile is written only after every lane has
// read its inputs, so they may lie in the tile itself.
template <int SIGN, class In>
__device__ __forceinline__ void pass16_first_body(const Tile& t,
                                                  const Dft16& a,
                                                  bool to_swizzled, In in) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  unsigned b[4][4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int h = (q + s) & 3;
    const int2 bc = plain_butterfly(t, h, g);
    unsigned x[4];
    in(bc.x, bc.y, x);
    put_slot(b, h, x);
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    float yr[4], yi[4];
    dft16_group<SIGN>(a, b[h], yr, yi);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int2 bc = plain_butterfly(t, h, 2 * q + (e & 1));
      const int row = 16 * bc.x + g + 8 * (e >> 1);
      const int c = to_swizzled ? bc.y ^ swizzle(t, row) : bc.y;
      t.s[(row << t.logc) + c] = make_float2(yr[e], yi[e]);
    }
  }
  __syncthreads();
}

// pass16_first_body on the tile's rows, as a call, not inlined (so is
// pass16_second): the registers of the passes are their own, so the
// state of the kernel around them (kb_adv's second tile and advection,
// the epilogues' pointers) is saved once around the call instead of
// spilled inside their loops.
template <int SIGN>
__device__ __noinline__ void pass16_first(const Tile t, const Dft16 a,
                                          bool to_swizzled) {
  pass16_first_body<SIGN>(t, a, to_swizzled, [&](int i, int c, unsigned* x) {
    load_b<SIGN>(t, i, c, false, -1, x);
  });
}

// The second radix-16 pass (p = 16) on the tensor cores, from the first
// pass's layout to out_swizzle's (the tile's rows at m = 1024, whose
// float32 pass follows); FOLD (m = 512): the plain map's radix-2
// pass<2> at p = m/2 folded in, op for op, on the D registers (each lane
// holds both partners).
template <int SIGN, bool FOLD>
__device__ __noinline__ void pass16_second(const Tile t, const Dft16 a) {
  constexpr int p = 16;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  unsigned b[4][4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int h = (q + s) & 3;
    const int2 bc = FOLD ? fold_butterfly(t, h, g) : plain_butterfly(t, h, g);
    unsigned x[4];
    load_b<SIGN>(t, bc.x, bc.y, true, bc.x & (p - 1), x);
    put_slot(b, h, x);
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    float yr[4], yi[4];
    dft16_group<SIGN>(a, b[h], yr, yi);
    if constexpr (FOLD) {
      // pass<2> at p = m/2: rows r = k + p f and r + m/2 from partners
      // i = k (e even) and k + p (e odd), the second twiddled by W_m^r
      const int2 kc = fold_butterfly(t, h, 2 * q);
#pragma unroll
      for (int fe = 0; fe < 2; ++fe) {
        const int r = kc.x + p * (g + 8 * fe);
        float2 w = t.sw[r];
        if (SIGN > 0) w.y = -w.y;
        const float2 x0 = make_float2(yr[2 * fe], yi[2 * fe]);
        const float2 x1 =
            mul(make_float2(yr[2 * fe + 1], yi[2 * fe + 1]), w);
        const int r2 = r + (t.m >> 1);
        t.s[(r << t.logc) + (kc.y ^ out_swizzle(t, r))] = add(x0, x1);
        t.s[(r2 << t.logc) + (kc.y ^ out_swizzle(t, r2))] = sub(x0, x1);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int2 bc = plain_butterfly(t, h, 2 * q + (e & 1));
        const int k = bc.x & (p - 1);
        const int row = (bc.x - k) * 16 + k + p * (g + 8 * (e >> 1));
        t.s[(row << t.logc) + (bc.y ^ out_swizzle(t, row))] =
            make_float2(yr[e], yi[e]);
      }
    }
  }
  __syncthreads();
}

// The length-m sub-DFT of every column of the tile, in place, natural
// order out: radix 8 while 8 divides what is left, then 4 or 2
// (ops/xtile.py sub_radices); FAST: the passes fast_radices names (radix
// 16 on the tensor cores while 16 divides what is left, then one float32
// pass of the rest), as one or two tensor-core passes: m = 512's radix-2
// rest runs inside the second one, m = 64, 128 and 1024 keep their
// float32 pass.
template <int SIGN, bool FAST = false>
__device__ __forceinline__ void subdft(const Tile& t) {
  if constexpr (FAST) {
    const Dft16 a = dft16();
    if (t.m >= 256) {
      pass16_first<SIGN>(t, a, true);
      if (t.m == 512) {
        pass16_second<SIGN, true>(t, a);
      } else {
        pass16_second<SIGN, false>(t, a);
        if (t.m == 1024) pass<4, SIGN>(t, 256);
      }
    } else {
      pass16_first<SIGN>(t, a, false);
      if (t.m == 128) {
        pass<8, SIGN>(t, 16);
      } else {
        pass<4, SIGN>(t, 16);
      }
    }
  } else {
    for (int p = 1; p < t.m;) {
      const int r = t.m / p >= 8 ? 8 : t.m / p;
      if (r == 8) {
        pass<8, SIGN>(t, p);
      } else if (r == 4) {
        pass<4, SIGN>(t, p);
      } else {
        pass<2, SIGN>(t, p);
      }
      p *= r;
    }
  }
}

// Y_r[k2] of tile column c from every block r of the cluster, through
// distributed shared memory (s: the tile at the same offset in every
// block); FAST: from the fast sub-DFT's output layout (out_swizzle).
template <int K, bool FAST = false>
__device__ __forceinline__ void gather(const Tile& t, float2* s, int k2,
                                       int c, float2* x) {
  if constexpr (FAST) c ^= out_swizzle(t, k2);
#pragma unroll
  for (int r = 0; r < K; ++r) x[r] = map_rank(s, r)[(k2 << t.logc) + c];
}

// X[k2 + m k1] (k1 < K) in x from the gathered Y_r[k2]: each twiddled by
// W_n^(r k2), then the length-K DFT over r.
template <int K, int SIGN>
__device__ __forceinline__ void twiddle_dft(const Tile& t,
                                            const float2* __restrict__ tw,
                                            int k2, float2* x) {
#pragma unroll
  for (int r = 1; r < K; ++r) {
    x[r] = mul(x[r], twiddle<SIGN>(tw, r * k2, t.n));
  }
  dft<K, SIGN>(x);
}

// Block q's slice of the outputs from every block's sub-DFT: out(row,
// column in tile, value) for each of its rows k2 + m k1. Reads the other
// blocks' shared memory between two cluster barriers: the arrival after
// the last read, the wait before the block exits (its tile stays alive
// until every block has read it).
template <int K, int SIGN, bool FAST = false, class Out>
__device__ __forceinline__ void combine(const Tile& t,
                                        const float2* __restrict__ tw,
                                        Out& out) {
  constexpr int B = kElems / K;
  const int mk = t.m / K;
  const int cmask = (1 << t.logc) - 1;
  cluster_sync();
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int u = b * blockDim.x + threadIdx.x;
    const int c = u & cmask;
    const int k2 = t.rank * mk + (u >> t.logc);
    float2 x[K];
    gather<K, FAST>(t, t.s, k2, c, x);
    if (b == B - 1) cluster_arrive();
    twiddle_dft<K, SIGN>(t, tw, k2, x);
#pragma unroll
    for (int k1 = 0; k1 < K; ++k1) out(k2 + t.m * k1, c, x[k1]);
  }
  cluster_wait();
}

// Steps 2 and 3 once the caller's loads have landed (after
// cp_async_wait_all and __syncthreads).
template <int SIGN, bool FAST = false, class Out>
__device__ __forceinline__ void finish(const Tile& t,
                                       const float2* __restrict__ tw,
                                       Out& out) {
  subdft<SIGN, FAST>(t);
  switch (t.k) {
    case 1:
      combine<1, SIGN, FAST>(t, tw, out);
      break;
    case 2:
      combine<2, SIGN, FAST>(t, tw, out);
      break;
    case 4:
      combine<4, SIGN, FAST>(t, tw, out);
      break;
    default:
      combine<8, SIGN, FAST>(t, tw, out);
      break;
  }
}

// The staged column's stride: m + 16 / C values, so the 16 lanes of a
// half warp, on C columns and 16 / C rows, store to 16 bank pairs.
__device__ __forceinline__ int staged_stride(const Tile& t) {
  return t.m + (16 >> t.logc);
}

// Step 3' up to the epilogue: combine's twiddles and length-K DFT, its
// outputs kept in registers; a cluster barrier (every block has read this
// block's tile), then X[k2 + m k1] of tile column c staged at
// s[c stride + k1 m/K + k2 - q m/K]. The W_m table behind the tile is
// dead by now: the padding of the C columns (16 values) takes part of it.
template <int K, int SIGN, bool FAST = false>
__device__ __forceinline__ void combine_staged(const Tile& t,
                                               const float2* __restrict__ tw) {
  constexpr int B = kElems / K;
  const int mk = t.m / K;
  const int cmask = (1 << t.logc) - 1;
  float2 v[kElems];
  cluster_sync();
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int u = b * blockDim.x + threadIdx.x;
    const int c = u & cmask;
    const int k2 = t.rank * mk + (u >> t.logc);
    float2* x = v + b * K;
    gather<K, FAST>(t, t.s, k2, c, x);
    if (b == B - 1) cluster_arrive();
    twiddle_dft<K, SIGN>(t, tw, k2, x);
  }
  cluster_wait();
  const int stride = staged_stride(t);
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int u = b * blockDim.x + threadIdx.x;
    const int c = u & cmask, kk = u >> t.logc;
#pragma unroll
    for (int k1 = 0; k1 < K; ++k1) {
      t.s[c * stride + k1 * mk + kk] = v[b * K + k1];
    }
  }
  __syncthreads();
}

// Steps 2 and 3' once the caller's loads have landed: out(k, column in
// tile, value) for every output k of the block's slice, consecutive lanes
// on consecutive k of one column. half: only k <= n/2 (the forward half
// spectrum), which are the first m/2 staged values of each column and,
// on rank 0, the one at m/2 (k = n/2).
template <int SIGN, bool FAST = false, class Out>
__device__ __forceinline__ void finish_transposed(
    const Tile& t, const float2* __restrict__ tw, bool half, Out& out) {
  subdft<SIGN, FAST>(t);
  switch (t.k) {
    case 1:
      combine_staged<1, SIGN, FAST>(t, tw);
      break;
    case 2:
      combine_staged<2, SIGN, FAST>(t, tw);
      break;
    case 4:
      combine_staged<4, SIGN, FAST>(t, tw);
      break;
    default:
      combine_staged<8, SIGN, FAST>(t, tw);
      break;
  }
  const int stride = staged_stride(t);
  const int logmk = (__ffs(t.m) - 1) - (__ffs(t.k) - 1);
  const int len = half ? t.m >> 1 : t.m;
  const int loglen = __ffs(len) - 1;
  for (int u = threadIdx.x; u < (len << t.logc); u += blockDim.x) {
    const int c = u >> loglen, i = u & (len - 1);
    const int k = t.rank * (t.m / t.k) + (i & ((1 << logmk) - 1)) +
                  t.m * (i >> logmk);
    out(k, c, t.s[c * stride + i]);
  }
  if (half && t.rank == 0) {
    for (int c = threadIdx.x; c < (1 << t.logc); c += blockDim.x) {
      out(t.n >> 1, c, t.s[c * stride + (t.m >> 1)]);
    }
  }
}

// ---- the plane tile: the fast ka, kc, kb and ky_all ----
//
// ka_kernel<SIGN, true> and kc_kernel<true> (ka_kc.cu), kb_kernel<true>
// (kb_pair.cu) and ky_all_kernel<true> (ky_all.cu) load their tile as two
// float planes where the rows are 16-byte aligned (kc's (ny, nx) planes,
// ka's real forward (n, ny) planes, kb's (ny/2 + 1, nx) half planes,
// ky_all's (ny, nx) fields: the tile's m C real parts, row j, column c at
// word j C + c, then its m C imaginary parts; a real input, ka's real
// forward and ky_all's products: the first plane alone): one 16-byte
// cp.async moves four columns of a row (load_planes), or a thread forms
// four columns in registers from one 16-byte read of each input and
// stores them 16 bytes at a time (load_quads: kb's Hermitian load,
// ky_all's products); elsewhere (ka's complex inverse on hny columns,
// any row of a width not a multiple of 4) the tile's own layout, one
// float per cp.async or one value per store, as the other kernels load.
// The load is plane_transposed's: ka's and kc's copies (load_planes) or a
// load object of the caller's (HermitianLoad, SwProductLoad). The first
// pass reads its B fragments from either layout (PlaneIn, load_b)
// inlined, and writes the tile's usual layout: the rest of the transform
// is the tile's, the second pass a call (plane_finish). The half stores
// (kc, ky_all) stage only the outputs they store (combine_staged_half).
// Every output keeps finish_transposed's bits: only the data movement
// differs.

// The plane tile's reader: input (row, column) of the first pass.
struct PlaneIn {
  const float* s;
  bool real;

  // The first pass's B fragment of butterfly i of column c: load_b's
  // (inputs t = 2q, 2q + 1, 2q + 8, 2q + 9 from rows i + t m/16; no
  // twiddle), read as words from the two planes.
  __device__ __forceinline__ void operator()(const Tile& t, int i, int c,
                                             unsigned* b) const {
    const int stride = t.m >> 4, q = threadIdx.x & 3;
    const int plane = t.m << t.logc;
    float2 x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tt = 2 * q + (e & 1) + 8 * (e >> 1);
      const int off = ((i + tt * stride) << t.logc) + c;
      x[e] = make_float2(s[off], real ? 0.f : s[plane + off]);
    }
    b[0] = bf16x2(x[0].x, x[1].x);
    b[1] = bf16x2(x[2].x, x[3].x);
    b[2] = bf16x2(x[0].y, x[1].y);
    b[3] = bf16x2(x[2].y, x[3].y);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// The plane tile's load: block r's rows r + K j (j < m) of columns j0 ..
// j0 + C of the (rows, cols) planes xr, xi (xi NULL: the real plane
// alone; 0 past cols). `vec` (cols a multiple of 4, xr and xi 16-byte
// aligned): as planes, one 16-byte copy of four columns per thread and
// instruction, consecutive lanes on consecutive quads of a row; else
// into the tile's layout (row j, column c at value j C + c; 0 imaginary
// parts for the real input), one float each, consecutive lanes on
// consecutive columns.
__device__ __forceinline__ void load_planes(const Tile& t,
                                            const float* __restrict__ xr,
                                            const float* __restrict__ xi,
                                            int cols, int j0, bool vec) {
  if (vec) {
    float* d = reinterpret_cast<float*>(t.s);
    const int plane = t.m << t.logc;
    const int planes = xi == nullptr ? 1 : 2;
    const int lq = t.logc - 2;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if ((e >> 2) >= planes) break;
      const int v = (e & 3) * blockDim.x + threadIdx.x;
      const int quad = v & ((1 << lq) - 1), j = v >> lq;
      const int x = j0 + 4 * quad;
      float* to = d + (e >> 2) * plane + (j << t.logc) + 4 * quad;
      if (x < cols) {
        const size_t row = t.rank + t.k * j;
        cp_async16(to, (e >> 2 ? xi : xr) + row * cols + x);
      } else {
        *reinterpret_cast<float4*>(to) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    const int cmask = (1 << t.logc) - 1;
#pragma unroll
    for (int b = 0; b < kElems; ++b) {
      const int u = b * blockDim.x + threadIdx.x;
      const int x = j0 + (u & cmask);
      float2* d = t.s + u;
      if (x < cols) {
        const size_t off =
            static_cast<size_t>(t.rank + t.k * (u >> t.logc)) * cols + x;
        cp_async4(&d->x, xr + off);
        if (xi != nullptr) {
          cp_async4(&d->y, xi + off);
        } else {
          d->y = 0.f;
        }
      } else {
        *d = make_float2(0.f, 0.f);
      }
    }
  }
}

// subdft<SIGN, true> of the plane tile: the first pass inlined, from the
// planes (`vec`) or the tile's rows, then the tile's own passes.
template <int SIGN>
__device__ __forceinline__ void subdft_planes(const Tile& t, bool vec,
                                              bool real) {
  const Dft16 a = dft16();
  const PlaneIn in{reinterpret_cast<const float*>(t.s), real};
  if (vec) {
    pass16_first_body<SIGN>(t, a, t.m >= 256,
                            [&](int i, int c, unsigned* b) { in(t, i, c, b); });
  } else {
    pass16_first_body<SIGN>(t, a, t.m >= 256,
                            [&](int i, int c, unsigned* b) {
                              load_b<SIGN>(t, i, c, false, -1, b);
                            });
  }
  if (t.m >= 256) {
    if (t.m == 512) {
      pass16_second<SIGN, true>(t, a);
    } else {
      pass16_second<SIGN, false>(t, a);
      if (t.m == 1024) pass<4, SIGN>(t, 256);
    }
  } else if (t.m == 128) {
    pass<8, SIGN>(t, 16);
  } else {
    pass<4, SIGN>(t, 16);
  }
}

// The staged half column's stride: m/2 + 16 / C values (k <= n/2 is the
// first m/2 staged values of a column and rank 0's one at m/2).
__device__ __forceinline__ int half_stride(const Tile& t) {
  return (t.m >> 1) + (16 >> t.logc);
}

// combine_staged<K, SIGN, true> for the half store: the same exchange and
// K-point step, each output X[k2 + m k1] that the half store keeps (k1 <
// K/2, and k1 = K/2 at k2 = 0 on rank 0; at K = 1 k2 <= m/2) staged at
// s[c half_stride + k1 m/K + k2 - q m/K], the rest never formed.
template <int K, int SIGN>
__device__ __forceinline__ void combine_staged_half(
    const Tile& t, const float2* __restrict__ tw) {
  constexpr int B = kElems / K;
  const int mk = t.m / K;
  const int cmask = (1 << t.logc) - 1;
  float2 v[kElems];
  cluster_sync();
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int u = b * blockDim.x + threadIdx.x;
    const int k2 = t.rank * mk + (u >> t.logc);
    float2* x = v + b * K;
    gather<K, true>(t, t.s, k2, u & cmask, x);
    if (b == B - 1) cluster_arrive();
    twiddle_dft<K, SIGN>(t, tw, k2, x);
  }
  cluster_wait();
  const int stride = half_stride(t);
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int u = b * blockDim.x + threadIdx.x;
    const int c = u & cmask, kk = u >> t.logc;
    float2* col = t.s + c * stride;
    if constexpr (K == 1) {
      if (kk <= (t.m >> 1)) col[kk] = v[b];
    } else {
#pragma unroll
      for (int k1 = 0; k1 < K / 2; ++k1) col[k1 * mk + kk] = v[b * K + k1];
      if (t.rank == 0 && kk == 0) col[t.m >> 1] = v[b * K + K / 2];
    }
  }
  __syncthreads();
}

// The staged outputs to the epilogue: out(k, column in tile, value),
// consecutive lanes on consecutive k of one column; half: the first m/2
// of each column (stride half_stride) and rank 0's k = n/2, else all m
// (stride staged_stride).
template <class Out>
__device__ __forceinline__ void store_staged(const Tile& t, bool half,
                                             Out& out) {
  const int stride = half ? half_stride(t) : staged_stride(t);
  const int logmk = (__ffs(t.m) - 1) - (__ffs(t.k) - 1);
  const int len = half ? t.m >> 1 : t.m;
  const int loglen = __ffs(len) - 1;
  for (int u = threadIdx.x; u < (len << t.logc); u += blockDim.x) {
    const int c = u >> loglen, i = u & (len - 1);
    const int k = t.rank * (t.m / t.k) + (i & ((1 << logmk) - 1)) +
                  t.m * (i >> logmk);
    out(k, c, t.s[c * stride + i]);
  }
  if (half && t.rank == 0) {
    for (int c = threadIdx.x; c < (1 << t.logc); c += blockDim.x) {
      out(t.n >> 1, c, t.s[c * stride + (t.m >> 1)]);
    }
  }
}

// The plane tile's steps after its load has landed: the sub-DFT (the
// first pass inlined from the planes, `vec`, or the tile's rows; `real`:
// the real plane alone), the exchange and K-point step with the staging
// (HALF: only the outputs the half store keeps) and the transposed store
// through `out` (out.j0 set).
template <int SIGN, bool HALF, class Out>
__device__ __forceinline__ void plane_finish(const Tile& t,
                                             const float2* __restrict__ tw,
                                             bool vec, bool real, Out& out) {
  subdft_planes<SIGN>(t, vec, real);
  if constexpr (HALF) {
    switch (t.k) {
      case 1:
        combine_staged_half<1, SIGN>(t, tw);
        break;
      case 2:
        combine_staged_half<2, SIGN>(t, tw);
        break;
      case 4:
        combine_staged_half<4, SIGN>(t, tw);
        break;
      default:
        combine_staged_half<8, SIGN>(t, tw);
        break;
    }
  } else {
    switch (t.k) {
      case 1:
        combine_staged<1, SIGN, true>(t, tw);
        break;
      case 2:
        combine_staged<2, SIGN, true>(t, tw);
        break;
      case 4:
        combine_staged<4, SIGN, true>(t, tw);
        break;
      default:
        combine_staged<8, SIGN, true>(t, tw);
        break;
    }
  }
  store_staged(t, HALF, out);
}

// The plane tile of the fast ka and kc: block `rank` of the cluster of
// tile blockIdx.x / K loads its rows of the (n, cols) planes xr, xi (xi
// NULL: real input; load_planes' copies), runs the length-n transform
// (SIGN) of every column on the fast tile and stores it transposed
// through `out` (HALF: k <= n/2), out.j0 set to the tile's first column.
template <int SIGN, bool HALF, class Out>
__device__ __forceinline__ void plane_transposed(
    float2* smem, const float2* __restrict__ tw, int n, int k, int logc,
    const float* __restrict__ xr, const float* __restrict__ xi, int cols,
    Out out) {
  const Tile t = begin(smem, tw, n, k, logc);
  const bool vec = (cols & 3) == 0 &&
                   (reinterpret_cast<size_t>(xr) & 15) == 0 &&
                   (reinterpret_cast<size_t>(xi) & 15) == 0;
  out.j0 = (blockIdx.x / k) << logc;
  load_planes(t, xr, xi, cols, out.j0, vec);
  cp_async_wait_all();
  __syncthreads();
  plane_finish<SIGN, HALF>(t, tw, vec, xi == nullptr, out);
}

// The plane tile of the fast kb and ky_all, whose loads compute the
// tile: `load` (HermitianLoad, SwProductLoad) says whether the tile
// lands as planes (load.vec()) and as the real plane alone
// (load.real()), gives the tile's first column (load.first_column(K,
// log2 C)) and loads block t.rank's rows (load(t, j0, vec)); the rest is
// the fast ka's and kc's (plane_finish).
template <int SIGN, bool HALF, class Load, class Out>
__device__ __forceinline__ void plane_transposed(
    float2* smem, const float2* __restrict__ tw, int n, int k, int logc,
    const Load& load, Out out) {
  const Tile t = begin(smem, tw, n, k, logc);
  const bool vec = load.vec();
  out.j0 = load.first_column(k, logc);
  load(t, out.j0, vec);
  __syncthreads();
  plane_finish<SIGN, HALF>(t, tw, vec, load.real(), out);
}

// The Hermitian load of the paired c2r y-stages (kb_pair.cu, kb_adv.cu,
// kb_adv_tracer.cu):
// block r's rows y = r + K j of the tile of columns j0 .. j0 + C into s,
// from the two half spectra a = ar + i ai and b = br + i bi, (n/2 + 1,
// nx) planes, at input row h = min(y, n - y): a + i b up to n/2,
// conj(a) + i conj(b) past it. The imaginary parts of the self-conjugate
// rows 0 and n/2 are never read (the positive-Nyquist leak guard);
// br == NULL is a zero partner; columns past nx load 0.
__device__ __forceinline__ void load_hermitian(
    const Tile& t, float2* s, const float* __restrict__ ar,
    const float* __restrict__ ai, const float* __restrict__ br,
    const float* __restrict__ bi, int j0, int nx) {
  const int half = t.n >> 1;
  const int cmask = (1 << t.logc) - 1;
#pragma unroll
  for (int b = 0; b < kElems; ++b) {
    const int u = b * blockDim.x + threadIdx.x;
    const int x = j0 + (u & cmask);
    const int y = t.rank + t.k * (u >> t.logc);
    float2 v = make_float2(0.f, 0.f);
    if (x < nx) {
      const int h = y <= half ? y : t.n - y;
      const size_t off = static_cast<size_t>(h) * nx + x;
      const bool selfconj = (h == 0) || (h == half);
      const float a_r = __ldg(ar + off);
      const float a_i = selfconj ? 0.f : __ldg(ai + off);
      const float b_r = br == nullptr ? 0.f : __ldg(br + off);
      const float b_i = (selfconj || bi == nullptr) ? 0.f : __ldg(bi + off);
      v = y <= half ? make_float2(a_r - b_i, a_i + b_r)
                    : make_float2(a_r + b_i, b_r - a_i);
    }
    s[u] = v;
  }
}

// The computing load of a tile (the x-stages of ka_diag.cu, ka_sw.cu
// and ka_kc.cu ka_adv_kernel, ka_fwd_kernel; the y-stage ky_all.cu):
// block r's rows i = r + K jj of the tile of columns j0 .. j0 + C of
// (n, m) planes into its tile, value(i, j, off) at off = i m + j,
// consecutive lanes on consecutive columns; 0 past m (the ragged last
// tile).
template <class Value>
__device__ __forceinline__ void load_rows(const Tile& t, int j0, int m,
                                          Value value) {
  const int cmask = (1 << t.logc) - 1;
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const int u = e * blockDim.x + threadIdx.x;
    const int j = j0 + (u & cmask);
    const int i = t.rank + t.k * (u >> t.logc);
    t.s[u] = j < m ? value(i, j, static_cast<size_t>(i) * m + j)
                   : make_float2(0.f, 0.f);
  }
}

// The computing load of the plane tile (kb_kernel<true>'s Hermitian
// load, ky_all_kernel<true>'s products): block r's rows r + K j (j < m)
// of columns j0 .. j0 + C, cols a multiple of 4 (and the inputs 16-byte
// aligned): thread v forms the four columns x .. x + 3 of quad v mod C/4
// of row j = v div C/4 (e = 0..3: v = e threads + thread) as
// quad(row, x, re, im) and stores them with one 16-byte store into each
// plane (real: the real plane alone, re), as load_planes' copies land;
// 0 past cols.
template <class Quad>
__device__ __forceinline__ void load_quads(const Tile& t, int j0, int cols,
                                           bool real, Quad quad) {
  float* d = reinterpret_cast<float*>(t.s);
  const int plane = t.m << t.logc;
  const int lq = t.logc - 2;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int v = e * blockDim.x + threadIdx.x;
    const int q4 = v & ((1 << lq) - 1), j = v >> lq;
    const int x = j0 + 4 * q4;
    float4 re = make_float4(0.f, 0.f, 0.f, 0.f), im = re;
    if (x < cols) quad(t.rank + t.k * j, x, re, im);
    float* to = d + (j << t.logc) + 4 * q4;
    *reinterpret_cast<float4*>(to) = re;
    if (!real) *reinterpret_cast<float4*>(to + plane) = im;
  }
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// The Hermitian load of the fast kb (kb_kernel<true>) on the plane tile:
// load_hermitian's values (rows y from input row h = min(y, n - y) of the
// (n/2 + 1, nx) planes ar, ai, br, bi; a + i b up to n/2, conj(a) + i
// conj(b) past it; the imaginary parts of rows 0 and n/2 never read; br
// NULL a zero partner), the same sums, four columns at a time: one
// 16-byte read of each plane, one 16-byte store into each float plane
// (load_quads) where nx is a multiple of 4 and the planes are 16-byte
// aligned; else load_hermitian into the tile's own layout.
struct HermitianLoad {
  const float* ar;
  const float* ai;
  const float* br;
  const float* bi;
  int nx;

  __device__ __forceinline__ bool vec() const {
    return (nx & 3) == 0 &&
           ((reinterpret_cast<size_t>(ar) | reinterpret_cast<size_t>(ai) |
             reinterpret_cast<size_t>(br) | reinterpret_cast<size_t>(bi)) &
            15) == 0;
  }
  __device__ __forceinline__ bool real() const { return false; }
  __device__ __forceinline__ int first_column(int k, int logc) const {
    return (blockIdx.x / k) << logc;
  }
  __device__ __forceinline__ void operator()(const Tile& t, int j0,
                                             bool vec) const {
    if (!vec) {
      load_hermitian(t, t.s, ar, ai, br, bi, j0, nx);
      return;
    }
    const int half = t.n >> 1;
    load_quads(t, j0, nx, false, [&](int y, int x, float4& re, float4& im) {
      const int h = y <= half ? y : t.n - y;
      const size_t off = static_cast<size_t>(h) * nx + x;
      const bool selfconj = (h == 0) || (h == half);
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 a_r = ldg4(ar + off);
      const float4 a_i = selfconj ? zero : ldg4(ai + off);
      const float4 b_r = br == nullptr ? zero : ldg4(br + off);
      const float4 b_i = (selfconj || bi == nullptr) ? zero : ldg4(bi + off);
      if (y <= half) {
        re = make_float4(a_r.x - b_i.x, a_r.y - b_i.y, a_r.z - b_i.z,
                         a_r.w - b_i.w);
        im = make_float4(a_i.x + b_r.x, a_i.y + b_r.y, a_i.z + b_r.z,
                         a_i.w + b_r.w);
      } else {
        re = make_float4(a_r.x + b_i.x, a_r.y + b_i.y, a_r.z + b_i.z,
                         a_r.w + b_i.w);
        im = make_float4(b_r.x - a_i.x, b_r.y - a_i.y, b_r.z - a_i.z,
                         b_r.w - a_i.w);
      }
    });
  }
};

// The product load of the fast ky_all (ky_all_kernel<true>) on the plane
// tile: cluster (tile, p) of product p = cluster mod 5 forms product p of
// the y-major (ny, nx) planes u, v, zeta, eta_s (epilogue.cuh
// sw_product's rounding) into the real plane alone, four columns at a
// time (sw_product4, load_quads) where nx is a multiple of 4 and the
// planes are 16-byte aligned; else load_rows into the tile's own layout,
// zero imaginary parts. Either way the tile holds (product, 0), as kc of
// (product, 0) loads it.
struct SwProductLoad {
  const float* u;
  const float* v;
  const float* zeta;
  const float* eta_s;
  int nx, p;
  float ies, f0, grav;
  bool split;

  __device__ __forceinline__ bool vec() const {
    return (nx & 3) == 0 &&
           ((reinterpret_cast<size_t>(u) | reinterpret_cast<size_t>(v) |
             reinterpret_cast<size_t>(zeta) |
             reinterpret_cast<size_t>(eta_s)) &
            15) == 0;
  }
  __device__ __forceinline__ bool real() const { return true; }
  __device__ __forceinline__ int first_column(int k, int logc) const {
    return (static_cast<int>(blockIdx.x / k) / kSwProducts) << logc;
  }
  __device__ __forceinline__ void operator()(const Tile& t, int j0,
                                             bool vec) const {
    if (!vec) {
      load_rows(t, j0, nx, [&](int, int, size_t off) {
        return make_float2(
            sw_product(p, u, v, zeta, eta_s, off, ies, f0, grav, split),
            0.f);
      });
      return;
    }
    load_quads(t, j0, nx, true, [&](int i, int x, float4& re, float4&) {
      re = sw_product4(p, u, v, zeta, eta_s,
                       static_cast<size_t>(i) * nx + x, ies, f0, grav,
                       split);
    });
  }
};

// The store of a forward y-stage's half spectrum (ky_adv.cu, kb_adv.cu,
// kb_adv_tracer.cu, ky_all.cu): X[k] of tile column c to yr, yi at [j0 + c, k] of the
// (nx, n/2 + 1) planes from `plane` on.
struct HalfOut {
  float* yr;
  float* yi;
  size_t plane;
  int j0, nx, hny;

  __device__ __forceinline__ void operator()(int k, int c, float2 v) const {
    const int x = j0 + c;
    if (x >= nx) return;  // the ragged last tile
    const size_t off = plane + static_cast<size_t>(x) * hny + k;
    yr[off] = v.x;
    yi[off] = v.y;
  }
};

// The bf16 store of a natural x-stage's planes (kx_visc.cu's kx_fwd with
// the shallow-water product store, the JAX package's XFB_SW_PSTORE=bf16,
// pallas_sw.py:152-197): X[k] of tile column c rounded once to bf16
// (__float2bfloat16_rn, round to nearest even: torch's
// .to(torch.bfloat16) of the float32 value) to yr, yi at [k, j0 + c] of
// the (n, m) planes from `plane` on. One 2-byte store per value: a bf16
// row of m = n/2 + 1 values is 2 m bytes, so no column pair starts
// 4-byte aligned on every row.
struct Bf16Out {
  __nv_bfloat16* yr;
  __nv_bfloat16* yi;
  size_t plane;
  int j0, m;

  __device__ __forceinline__ void operator()(int k, int c, float2 v) const {
    const int j = j0 + c;
    if (j >= m) return;  // the ragged last tile
    const size_t off = plane + static_cast<size_t>(k) * m + j;
    yr[off] = __float2bfloat16_rn(v.x);
    yi[off] = __float2bfloat16_rn(v.y);
  }
};

// The store of a full-length transposed x-stage (ka_kc.cu ka_kernel,
// ka_adv_kernel and ka_fwd_kernel, ka_diag.cu ka_fields_kernel, ka_sw.cu
// ka_sw_kernel): scale * X[k] of tile column c to yr, yi at [j0 + c, k]
// of the (m, n) planes from `plane` on, one rounded product (scale = 1
// is exact).
struct RowOut {
  float* yr;
  float* yi;
  size_t plane;
  int j0, m, n;
  float scale;

  __device__ __forceinline__ void operator()(int k, int c, float2 v) const {
    const int x = j0 + c;
    if (x >= m) return;  // the ragged last tile
    const size_t off = plane + static_cast<size_t>(x) * n + k;
    yr[off] = __fmul_rn(v.x, scale);
    yi[off] = __fmul_rn(v.y, scale);
  }
};

// Host side: check the plan's numbers (ops/xtile.py) and launch `kernel`
// on a grid of (tiles K, fields) blocks in clusters of K.
inline bool plan_ok(int n, int c, int k, int threads, int smem) {
  if (n < 64 || n > 8192 || (n & (n - 1)) != 0) return false;
  if (c < 1 || c > 16 || (c & (c - 1)) != 0) return false;
  if (k != 1 && k != 2 && k != 4 && k != 8) return false;
  const int m = n / k;
  return threads * kElems == m * c && threads <= 1024 &&
         smem == (m * c + m) * static_cast<int>(sizeof(float2));
}

inline int log2i(int c) {
  int l = 0;
  while ((1 << l) < c) ++l;
  return l;
}

template <class... Params, class... Args>
cudaError_t launch(void (*kernel)(Params...), int tiles, int fields, int k,
                   int threads, int smem, int device, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * k, fields);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace xtile
}  // namespace xfb
