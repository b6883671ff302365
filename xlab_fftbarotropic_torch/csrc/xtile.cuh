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
//      256 bytes per plane).
//
// X[k2 + m k1] = sum_r W_K^(r k1) W_n^(r k2) sum_j x[r + K j] W_m^(j k2):
// one pass over device memory whatever n. Each thread holds kElems
// complex values of every pass; the tile (m C values) and the W_m table
// are the block's dynamic shared memory. Every product and sum is
// rounded on its own (no contraction left to the compiler), so the same
// inputs give the same bits in every kernel that includes this.
#pragma once

#include <cuda_runtime.h>

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

// The length-m sub-DFT of every column of the tile, in place, natural
// order out: radix 8 while 8 divides what is left, then 4 or 2
// (ops/xtile.py sub_radices).
template <int SIGN>
__device__ __forceinline__ void subdft(const Tile& t) {
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

// Y_r[k2] of tile column c from every block r of the cluster, through
// distributed shared memory (s: the tile at the same offset in every
// block).
template <int K>
__device__ __forceinline__ void gather(const Tile& t, float2* s, int k2,
                                       int c, float2* x) {
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
template <int K, int SIGN, class Out>
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
    gather<K>(t, t.s, k2, c, x);
    if (b == B - 1) cluster_arrive();
    twiddle_dft<K, SIGN>(t, tw, k2, x);
#pragma unroll
    for (int k1 = 0; k1 < K; ++k1) out(k2 + t.m * k1, c, x[k1]);
  }
  cluster_wait();
}

// Steps 2 and 3 once the caller's loads have landed (after
// cp_async_wait_all and __syncthreads).
template <int SIGN, class Out>
__device__ __forceinline__ void finish(const Tile& t,
                                       const float2* __restrict__ tw,
                                       Out& out) {
  subdft<SIGN>(t);
  switch (t.k) {
    case 1:
      combine<1, SIGN>(t, tw, out);
      break;
    case 2:
      combine<2, SIGN>(t, tw, out);
      break;
    case 4:
      combine<4, SIGN>(t, tw, out);
      break;
    default:
      combine<8, SIGN>(t, tw, out);
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
template <int K, int SIGN>
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
    gather<K>(t, t.s, k2, c, x);
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
template <int SIGN, class Out>
__device__ __forceinline__ void finish_transposed(
    const Tile& t, const float2* __restrict__ tw, bool half, Out& out) {
  subdft<SIGN>(t);
  switch (t.k) {
    case 1:
      combine_staged<1, SIGN>(t, tw);
      break;
    case 2:
      combine_staged<2, SIGN>(t, tw);
      break;
    case 4:
      combine_staged<4, SIGN>(t, tw);
      break;
    default:
      combine_staged<8, SIGN>(t, tw);
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
