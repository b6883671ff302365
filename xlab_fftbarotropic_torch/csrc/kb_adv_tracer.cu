// kb_adv_tracer: the tracer family's velocity y-stage, both advection
// products and both forward y-stages, in one kernel.
//
// Replaces pallas_tracer.kb_adv_tracer / _kb_adv_tracer_kernel
// (xlab_fftbarotropic_tpu/ops/pallas_tracer.py:132). kb_adv_half's design
// (csrc/kb_adv.cu) with a second product: a thread block cluster runs for
// a tile of C/2 adjacent x columns (half the plan's C) what kb_pair of
// fields 2, 3 and ky_adv (twice) run for them, on the column-tile
// transform of csrc/xtile.cuh:
//   1. inverse: block r loads rows r + K j of the Hermitian tile of u + i v
//      (fields 2 and 3 of ka6's stacked (6, ny/2 + 1, nx) output,
//      xtile.cuh load_hermitian: the self-conjugate rows projected to
//      their real part) and runs its inverse sub-DFT; after a cluster
//      barrier block q combines its k2 slice over the K blocks (gather and
//      twiddle_dft, kb_pair's arithmetic) into u, v at rows
//      y = k2 + m k1 of its columns, each times `scale` (1/(nx ny)) as
//      kb_pair writes it;
//   2. adv_z = -(u zx) - v (zy + beta) + src and adv_q = -(u qx) - v qy + 0
//      (xfb::advection, ky_adv's expression and rounding; beta belongs to
//      zeta alone, and a NULL src adds 0 as ky_adv adds a zero plane) from
//      the y-major (ny, nx) gradients at (y, j0 + c): row segments;
//   3. redistribution through distributed shared memory to the block that
//      loads row y in ky_adv, y mod K, at slot (y div K) C + c: adv_q into
//      the second tile as soon as it is formed (no block reads that tile
//      before the forward stage), adv_z held in registers until a second
//      cluster barrier (every block has read the first tile) and then
//      stored into the first; a third barrier;
//   4. forward: ky_adv's sub-DFT and transposed half store
//      (finish_transposed) of each tile into row x of the stacked (2, nx,
//      ny/2 + 1) output, adv_q to plane 1 first, then adv_z to plane 0.
// So plane 0 is ky_adv(u, zx, v, zy, src, beta) and plane 1 ky_adv(u, qx,
// v, qy, 0, 0) with (u, v) = kb_pair(w, 2, 3, scale), bit for bit; the
// velocities never reach device memory.
//
// The two real forward transforms stay two: packed into one as
// adv_z + i adv_q, the Hermitian split would leave the smaller tendency
// (1e4 apart for bench.py's tracer configuration) with the larger one's
// round-off.
//
// Bound: memory traffic, about 604 MB per call at 4096^2 (4 half planes
// of w and 5 y-major planes in, 4 half planes out). Tiles of C/2 columns
// and half the plan's threads, as kb_adv_full: the first tile, the W_m
// table and the second tile take the plan's shared bytes (68 KB at 4096,
// three blocks per SM), plus kPad values behind the second tile. A staged
// tile's columns (xtile.cuh combine_staged) run 16 values past it: the
// first tile's into the W_m table, dead once both sub-DFTs have read it,
// the second tile's into the pad; so the second tile is transformed and
// stored first, while the table is whole.
//
// xfb_kb_adv_tracer_fast is kb_adv_tracer on the fast column tile
// (xtile.cuh FAST: the inverse and both forward sub-DFTs as bf16
// tensor-core radix-16 passes), the tracer fast mode's. The fast pass
// twiddles in float32 from the same W_m table and reads and writes only
// a tile's m C slots, so the order above holds unchanged: the second
// tile first, the first tile's staging into the dead table last. It
// gives the bits of kb_pair's fast form of fields 2, 3 followed by
// ky_adv's fast form of each product.
#include "epilogue.cuh"
#include "xtile.cuh"

namespace {

namespace xt = xfb::xtile;

// the padding of a tile's staged columns: C (m + 16 / C) = m C + 16 values
constexpr int kPad = 16;

// Steps 1 (from the combine on) to 3 for a cluster of K blocks: the tile
// of u + i v in t.s after its inverse sub-DFT; on return t.s holds
// (adv_z, 0) and qq (adv_q, 0) at ky_adv's load slots.
template <int K, bool FAST>
__device__ __forceinline__ void advect(
    const xt::Tile& t, float2* qq, const float2* __restrict__ tw,
    const float* __restrict__ zx, const float* __restrict__ zy,
    const float* __restrict__ qx, const float* __restrict__ qy,
    const float* __restrict__ src, int j0, int nx, float scale,
    float beta) {
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
    float2 p[K];
    xt::gather<K, FAST>(t, t.s, k2, c, p);
    if (b == B - 1) xt::cluster_arrive();
    xt::twiddle_dft<K, +1>(t, tw, k2, p);
    const int x = j0 + c;
    // row y = k2 + m k1 to block y mod K, slot y div K (K divides m)
    float2* dst = xt::map_rank(qq, k2 & (K - 1));
#pragma unroll
    for (int k1 = 0; k1 < K; ++k1) {
      float az = 0.f, aq = 0.f;
      if (x < nx) {  // the ragged last tile
        const size_t off = static_cast<size_t>(k2 + t.m * k1) * nx + x;
        const float u = __fmul_rn(p[k1].x, scale);
        const float v = __fmul_rn(p[k1].y, scale);
        az = xfb::advection(u, __ldg(zx + off), v, __ldg(zy + off),
                            src == nullptr ? 0.f : __ldg(src + off), beta);
        aq = xfb::advection(u, __ldg(qx + off), v, __ldg(qy + off), 0.f,
                            0.f);
      }
      adv[b * K + k1] = az;
      dst[((k2 / K + mk * k1) << t.logc) + c] = make_float2(aq, 0.f);
    }
  }
  xt::cluster_wait();
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
template <bool FAST>
__global__ void __launch_bounds__(256, 3)
    kb_adv_tracer_kernel(const float* __restrict__ zx,
                         const float* __restrict__ zy,
                         const float* __restrict__ qx,
                         const float* __restrict__ qy,
                         const float* __restrict__ wr,
                         const float* __restrict__ wi,
                         const float* __restrict__ src,
                         const float2* __restrict__ tw, xt::HalfOut out,
                         int ny, int k, int logc, float scale, float beta) {
  extern __shared__ float2 smem[];
  const xt::Tile t = xt::begin(smem, tw, ny, k, logc);
  float2* qq = t.sw + t.m;  // the second tile, behind the W_m table
  const int nx = out.nx;
  const int j0 = (blockIdx.x / k) << logc;
  const size_t plane = static_cast<size_t>(out.hny) * nx;
  xt::load_hermitian(t, t.s, wr + 2 * plane, wi + 2 * plane, wr + 3 * plane,
                     wi + 3 * plane, j0, nx);
  __syncthreads();
  xt::subdft<+1, FAST>(t);
  switch (k) {
    case 1:
      advect<1, FAST>(t, qq, tw, zx, zy, qx, qy, src, j0, nx, scale, beta);
      break;
    case 2:
      advect<2, FAST>(t, qq, tw, zx, zy, qx, qy, src, j0, nx, scale, beta);
      break;
    case 4:
      advect<4, FAST>(t, qq, tw, zx, zy, qx, qy, src, j0, nx, scale, beta);
      break;
    default:
      advect<8, FAST>(t, qq, tw, zx, zy, qx, qy, src, j0, nx, scale, beta);
      break;
  }
  xt::Tile tq = t;
  tq.s = qq;
  xt::HalfOut o = out;
  o.j0 = j0;
  o.plane = plane;  // adv_q: the second (nx, ny/2 + 1) plane
  xt::finish_transposed<-1, FAST>(tq, tw, true, o);
  o.plane = 0;
  xt::finish_transposed<-1, FAST>(t, tw, true, o);
}

template <bool FAST>
int launch(const float* zx, const float* zy, const float* qx,
           const float* qy, const float* wr, const float* wi,
           const float* src, const void* tw, float* outr, float* outi,
           int ny, int nx, float scale, float beta, int tile_c,
           int cluster_k, int threads, int smem, int device, void* stream) {
  if (!xt::plan_ok(ny, tile_c, cluster_k, threads, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int c = tile_c / 2;
  const int tiles = (nx + c - 1) / c;
  return static_cast<int>(xt::launch(
      kb_adv_tracer_kernel<FAST>, tiles, 1, cluster_k, threads / 2,
      smem + kPad * static_cast<int>(sizeof(float2)), device,
      static_cast<cudaStream_t>(stream), zx, zy, qx, qy, wr, wi, src,
      static_cast<const float2*>(tw),
      xt::HalfOut{outr, outi, 0, 0, nx, ny / 2 + 1}, ny, cluster_k,
      xt::log2i(c), scale, beta));
}

}  // namespace

// zx, zy, qx, qy, src: (ny, nx) y-major, src may be NULL; wr, wi: ka6's
// (6, ny/2 + 1, nx) stack, of which fields 2 and 3 are read; outr, outi:
// (2, nx, ny/2 + 1). tile_c, cluster_k, threads, smem: the plan of
// ops/xtile.py for ny (the kernel runs tiles of tile_c / 2 columns with
// threads / 2, in smem plus the pad).
extern "C" int xfb_kb_adv_tracer(const float* zx, const float* zy,
                                 const float* qx, const float* qy,
                                 const float* wr, const float* wi,
                                 const float* src, const void* tw,
                                 float* outr, float* outi, int ny, int nx,
                                 float scale, float beta, int tile_c,
                                 int cluster_k, int threads, int smem,
                                 int device, void* stream) {
  return launch<false>(zx, zy, qx, qy, wr, wi, src, tw, outr, outi, ny, nx,
                       scale, beta, tile_c, cluster_k, threads, smem, device,
                       stream);
}

// kb_adv_tracer on the fast column tile: arguments as xfb_kb_adv_tracer's
extern "C" int xfb_kb_adv_tracer_fast(const float* zx, const float* zy,
                                      const float* qx, const float* qy,
                                      const float* wr, const float* wi,
                                      const float* src, const void* tw,
                                      float* outr, float* outi, int ny,
                                      int nx, float scale, float beta,
                                      int tile_c, int cluster_k, int threads,
                                      int smem, int device, void* stream) {
  return launch<true>(zx, zy, qx, qy, wr, wi, src, tw, outr, outi, ny, nx,
                      scale, beta, tile_c, cluster_k, threads, smem, device,
                      stream);
}
