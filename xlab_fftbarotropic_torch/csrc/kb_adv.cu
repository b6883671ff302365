// kb_adv_full, kb_adv_half: the paired c2r y-stage, the advection product
// and the real forward y-stage in one kernel.
//
// kb_adv_full replaces pallas_fft.kb_adv_full / _kb_adv_full_kernel
// (xlab_fftbarotropic_tpu/ops/pallas_fft.py:1158, XFB_BT_FUSEKB=full);
// kb_adv_half replaces pallas_fft.kb_adv_half / _kb_adv_half_kernel
// (:1179, XFB_BT_FUSEKB=half). A thread block cluster runs for a tile of
// C/2 adjacent x columns (half the plan's C) what kb_pair (twice) and
// ky_adv run for them, on the column-tile transform of csrc/xtile.cuh:
//   1. inverse: block r loads rows r + K j of the Hermitian tile of u + i v
//      (fields 2 and 3 of ka_diag's stacked (4, ny/2 + 1, nx) output,
//      xtile.cuh load_hermitian: the self-conjugate rows projected to
//      their real part), and for full a second tile of zx + i zy (fields
//      0 and 1); the inverse sub-DFT of each tile; after a cluster
//      barrier, block q combines its k2 slice over the K blocks (gather
//      and twiddle_dft, kb_pair's arithmetic) into u, v (and zx, zy) at
//      rows y = k2 + m k1 of its C columns, each value times `scale`
//      (1/(nx ny)) as kb_pair writes it; half reads zx and zy from the
//      y-major (ny, nx) planes one kb_pair made, at (y, j0 + c): row
//      segments;
//   2. adv = -(u zx) - v (zy + beta) + src[y, x] (xfb::advection, ky_adv's
//      expression and rounding), held in registers;
//   3. redistribution: after a second cluster barrier (every block has
//      read every tile), each value goes through distributed shared
//      memory to the block that loads row y in ky_adv, y mod K, at slot
//      (y div K) C + c of its first tile, as (adv, 0); a third barrier;
//   4. forward: ky_adv's sub-DFT and transposed half store
//      (finish_transposed) into row x of the (nx, ny/2 + 1) output.
// The physical fields never reach device memory, and every value is the
// one kb_pair and ky_adv compute, so the fused forms give their bits.
//
// Bound: memory traffic, about 403 MB per call at 4096^2 either way
// (full: 8 half planes and src in, 2 half planes out; half: 4 half
// planes, zeta_x, zeta_y and src in). Both take tiles of C/2 columns
// (32 KB at 4096) and 256 threads: full holds two tiles and the W_m
// table (68 KB, three blocks per SM, where two tiles of C columns, 132
// KB, would leave one), half one tile (36 KB, four blocks per SM); the
// plan's C ran kb_adv_full 1.4x and kb_adv_half 1.1x slower on the H100.
//
// xfb_kb_adv_half_fast and xfb_kb_adv_full_fast are kb_adv_half and
// kb_adv_full on the fast column tile (xtile.cuh FAST: the inverse and
// the forward sub-DFTs in bf16 tensor-core radix-16 passes), the
// barotropic fast mode's arms (the JAX package's XFB_BT_FUSEKB=auto
// resolves to half in fast mode, =full picks full); every other step
// unchanged, so they give the bits of kb_pair's fast form (once or
// twice) followed by ky_adv's fast form.
#include "epilogue.cuh"
#include "xtile.cuh"

namespace {

namespace xt = xfb::xtile;

// Steps 1 (from the combine on) to 3 for a cluster of K blocks: the tile
// of u + i v in t.s, of zx + i zy in zz (full), both after their inverse
// sub-DFT; on return t.s holds (adv, 0) at ky_adv's load slots.
template <int K, bool FULL, bool FAST>
__device__ __forceinline__ void advect(const xt::Tile& t, float2* zz,
                                       const float2* __restrict__ tw,
                                       const float* __restrict__ zx,
                                       const float* __restrict__ zy,
                                       const float* __restrict__ src, int j0,
                                       int nx, float scale, float beta) {
  constexpr int B = xt::kElems / K;
  const int mk = t.m / K;
  const int cmask = (1 << t.logc) - 1;
  float adv[xt::kElems];
  xt::cluster_sync();
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int i = b * blockDim.x + threadIdx.x;
    const int c = i & cmask;
    const int k2 = t.rank * mk + (i >> t.logc);
    float2 p[K], q[K];
    xt::gather<K, FAST>(t, t.s, k2, c, p);
    if constexpr (FULL) xt::gather<K, FAST>(t, zz, k2, c, q);
    if (b == B - 1) xt::cluster_arrive();
    xt::twiddle_dft<K, +1>(t, tw, k2, p);
    if constexpr (FULL) xt::twiddle_dft<K, +1>(t, tw, k2, q);
    const int x = j0 + c;
#pragma unroll
    for (int k1 = 0; k1 < K; ++k1) {
      float a = 0.f;
      if (x < nx) {  // the ragged last tile
        const size_t off = static_cast<size_t>(k2 + t.m * k1) * nx + x;
        float zxv, zyv;
        if constexpr (FULL) {
          zxv = __fmul_rn(q[k1].x, scale);
          zyv = __fmul_rn(q[k1].y, scale);
        } else {
          zxv = __ldg(zx + off);
          zyv = __ldg(zy + off);
        }
        a = xfb::advection(__fmul_rn(p[k1].x, scale), zxv,
                           __fmul_rn(p[k1].y, scale), zyv, __ldg(src + off),
                           beta);
      }
      adv[b * K + k1] = a;
    }
  }
  xt::cluster_wait();
  // row y = k2 + m k1 to block y mod K, slot y div K (K divides m)
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int i = b * blockDim.x + threadIdx.x;
    const int c = i & cmask;
    const int k2 = t.rank * mk + (i >> t.logc);
    float2* dst = xt::map_rank(t.s, k2 & (K - 1));
#pragma unroll
    for (int k1 = 0; k1 < K; ++k1) {
      const int slot = k2 / K + mk * k1;
      dst[(slot << t.logc) + c] = make_float2(adv[b * K + k1], 0.f);
    }
  }
  xt::cluster_sync();
}

// cluster tile: columns j0 .. j0 + C
template <bool FULL, bool FAST>
__global__ void __launch_bounds__(256, FULL ? 3 : 4)
    kb_adv_kernel(const float* __restrict__ wr, const float* __restrict__ wi,
                  const float* __restrict__ zx, const float* __restrict__ zy,
                  const float* __restrict__ src,
                  const float2* __restrict__ tw, xt::HalfOut out, int ny,
                  int k, int logc, float scale, float beta) {
  extern __shared__ float2 smem[];
  const xt::Tile t = xt::begin(smem, tw, ny, k, logc);
  float2* zz = t.sw + t.m;  // the second tile (full), behind the W_m table
  const int nx = out.nx;
  const int j0 = (blockIdx.x / k) << logc;
  const size_t plane = static_cast<size_t>((ny >> 1) + 1) * nx;
  xt::load_hermitian(t, t.s, wr + 2 * plane, wi + 2 * plane, wr + 3 * plane,
                     wi + 3 * plane, j0, nx);
  if constexpr (FULL) {
    xt::load_hermitian(t, zz, wr, wi, wr + plane, wi + plane, j0, nx);
  }
  __syncthreads();
  xt::subdft<+1, FAST>(t);
  if constexpr (FULL) {
    xt::Tile tz = t;
    tz.s = zz;
    xt::subdft<+1, FAST>(tz);
  }
  switch (k) {
    case 1:
      advect<1, FULL, FAST>(t, zz, tw, zx, zy, src, j0, nx, scale, beta);
      break;
    case 2:
      advect<2, FULL, FAST>(t, zz, tw, zx, zy, src, j0, nx, scale, beta);
      break;
    case 4:
      advect<4, FULL, FAST>(t, zz, tw, zx, zy, src, j0, nx, scale, beta);
      break;
    default:
      advect<8, FULL, FAST>(t, zz, tw, zx, zy, src, j0, nx, scale, beta);
      break;
  }
  xt::HalfOut o = out;
  o.j0 = j0;
  xt::finish_transposed<-1, FAST>(t, tw, true, o);
}

template <bool FULL, bool FAST = false>
int launch(const float* wr, const float* wi, const float* zx,
           const float* zy, const float* src, const void* tw, float* outr,
           float* outi, int ny, int nx, float scale, float beta, int tile_c,
           int cluster_k, int threads, int smem, int device, void* stream) {
  if (!xt::plan_ok(ny, tile_c, cluster_k, threads, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // tiles of half the plan's columns (the bits depend on K and the
  // passes, not on C) and half its threads: full's two tiles and the W_m
  // table take the plan's shared bytes, half holds one tile less
  const int c = tile_c / 2;
  const int tile_bytes =
      ny / cluster_k * c * static_cast<int>(sizeof(float2));
  const int tiles = (nx + c - 1) / c;
  return static_cast<int>(xt::launch(
      kb_adv_kernel<FULL, FAST>, tiles, 1, cluster_k, threads / 2,
      FULL ? smem : smem - tile_bytes, device,
      static_cast<cudaStream_t>(stream), wr, wi, zx, zy, src,
      static_cast<const float2*>(tw),
      xt::HalfOut{outr, outi, 0, 0, nx, ny / 2 + 1}, ny, cluster_k,
      xt::log2i(c), scale, beta));
}

}  // namespace

// wr, wi: ka_diag's (4, ny/2 + 1, nx) stack; src: (ny, nx) y-major;
// outr, outi: (nx, ny/2 + 1). tile_c, cluster_k, threads, smem: the plan
// of ops/xtile.py for ny (the kernel runs tiles of tile_c / 2 columns
// with threads / 2).
extern "C" int xfb_kb_adv_full(const float* wr, const float* wi,
                               const float* src, const void* tw, float* outr,
                               float* outi, int ny, int nx, float scale,
                               float beta, int tile_c, int cluster_k,
                               int threads, int smem, int device,
                               void* stream) {
  return launch<true>(wr, wi, nullptr, nullptr, src, tw, outr, outi, ny, nx,
                      scale, beta, tile_c, cluster_k, threads, smem, device,
                      stream);
}

// zx, zy, src: (ny, nx) y-major; wr, wi: the (4, ny/2 + 1, nx) stack, of
// which fields 2 and 3 are read; outr, outi: (nx, ny/2 + 1). The plan as
// kb_adv_full's.
extern "C" int xfb_kb_adv_half(const float* zx, const float* zy,
                               const float* wr, const float* wi,
                               const float* src, const void* tw, float* outr,
                               float* outi, int ny, int nx, float scale,
                               float beta, int tile_c, int cluster_k,
                               int threads, int smem, int device,
                               void* stream) {
  return launch<false>(wr, wi, zx, zy, src, tw, outr, outi, ny, nx, scale,
                       beta, tile_c, cluster_k, threads, smem, device,
                       stream);
}

// kb_adv_half on the fast column tile: arguments as xfb_kb_adv_half's
extern "C" int xfb_kb_adv_half_fast(const float* zx, const float* zy,
                                    const float* wr, const float* wi,
                                    const float* src, const void* tw,
                                    float* outr, float* outi, int ny, int nx,
                                    float scale, float beta, int tile_c,
                                    int cluster_k, int threads, int smem,
                                    int device, void* stream) {
  return launch<false, true>(wr, wi, zx, zy, src, tw, outr, outi, ny, nx,
                             scale, beta, tile_c, cluster_k, threads, smem,
                             device, stream);
}

// kb_adv_full on the fast column tile: arguments as xfb_kb_adv_full's
extern "C" int xfb_kb_adv_full_fast(const float* wr, const float* wi,
                                    const float* src, const void* tw,
                                    float* outr, float* outi, int ny, int nx,
                                    float scale, float beta, int tile_c,
                                    int cluster_k, int threads, int smem,
                                    int device, void* stream) {
  return launch<true, true>(wr, wi, nullptr, nullptr, src, tw, outr, outi,
                            ny, nx, scale, beta, tile_c, cluster_k, threads,
                            smem, device, stream);
}
