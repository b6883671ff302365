// kb_adv_tracer: the tracer family's velocity y-stage, both advection
// products and both forward y-stages, in one kernel.
//
// Replaces pallas_tracer.kb_adv_tracer / _kb_adv_tracer_kernel
// (xlab_fftbarotropic_tpu/ops/pallas_tracer.py:132). For each physical
// column x:
//   1. the paired c2r y-stage of fields 2 and 3 (the u and v x-stages)
//      of the stacked (6, hny, nx) KA6 output, as kb_pair does it: the
//      imaginary parts of the self-conjugate rows 0 and ny/2 are zeroed,
//      the Hermitian column a + i b is built and inverse-transformed, so
//      u + i v lands in shared memory, scaled by 1/(nx*ny);
//   2. adv_z = -(u zx) - v (zy + beta) + S   (+ S only when src is given,
//      zy + beta only for beta != 0) and adv_q = -(u qx) - v qy, in the
//      TPU kernel's expression order, from y-major (ny, nx) gradients;
//   3. the forward colfft of each real column, rows k <= ny/2 written as
//      rows x of the stacked (2, nx, hny) output planes (field 0: zeta,
//      field 1: q).
// The velocities never land in device memory.
//
// The two real forward transforms run as two complex ones, not packed
// into one as adv_z + i adv_q: the zeta and tracer tendencies differ in
// magnitude by orders (1e4 for bench.py's tracer configuration), and
// the Hermitian split of a packed transform would leave the smaller
// one with the larger one's round-off. So the block holds two ny-point
// complex buffers: u + i v (later adv_q) and adv_z; 64 KB of shared
// memory at ny = 4096, 128 KB at 8192.
//
// Bound: memory traffic and the three column FFTs, about 604 MB per
// call at 4096^2 (4 half planes of w and 5 full planes of y-major fields
// in, 4 half planes out). The w and y-major reads are strided by nx, the
// row writes contiguous.
#include "colfft.cuh"

namespace {

__global__ void kb_adv_tracer_kernel(const float* __restrict__ zx,
                                     const float* __restrict__ zy,
                                     const float* __restrict__ qx,
                                     const float* __restrict__ qy,
                                     const float* __restrict__ wr,
                                     const float* __restrict__ wi,
                                     const float* __restrict__ src,
                                     const float2* __restrict__ tw,
                                     float* __restrict__ outr,
                                     float* __restrict__ outi, int ny,
                                     int logny, int nx, float scale,
                                     float beta) {
  extern __shared__ float2 smem[];
  float2* uv = smem;       // u + i v, then adv_q
  float2* az = smem + ny;  // adv_z
  const int x = blockIdx.x;
  const int half = ny >> 1;
  const int hny = half + 1;
  const size_t plane = static_cast<size_t>(hny) * nx;
  const float* ar_p = wr + 2 * plane + x;  // field 2: u x-stage
  const float* ai_p = wi + 2 * plane + x;
  const float* br_p = wr + 3 * plane + x;  // field 3: v x-stage
  const float* bi_p = wi + 3 * plane + x;
  for (int j = threadIdx.x; j <= half; j += blockDim.x) {
    const size_t off = static_cast<size_t>(j) * nx;
    const float ar = ar_p[off];
    const float br = br_p[off];
    const bool selfconj = (j == 0) || (j == half);
    const float ai = selfconj ? 0.f : ai_p[off];
    const float bi = selfconj ? 0.f : bi_p[off];
    uv[xfb::bitrev(j, logny)] = make_float2(ar - bi, ai + br);
    if (!selfconj) {
      uv[xfb::bitrev(ny - j, logny)] = make_float2(ar + bi, br - ai);
    }
  }
  xfb::colfft<+1>(uv, ny, logny, tw);
  for (int y = threadIdx.x; y < ny; y += blockDim.x) {
    const size_t off = static_cast<size_t>(y) * nx + x;
    const float2 w = uv[y];
    const float u = w.x * scale;
    const float v = w.y * scale;
    float zyv = zy[off];
    if (beta != 0.f) zyv = zyv + beta;
    float adv_z = -(u * zx[off]) - v * zyv;
    if (src != nullptr) adv_z = adv_z + src[off];
    const float adv_q = -(u * qx[off]) - v * qy[off];
    az[xfb::bitrev(y, logny)] = make_float2(adv_z, 0.f);
    uv[y] = make_float2(adv_q, 0.f);  // own slot: no other thread reads it
  }
  xfb::colfft<-1>(az, ny, logny, tw);
  const size_t row = static_cast<size_t>(x) * hny;
  for (int k = threadIdx.x; k < hny; k += blockDim.x) {
    const float2 val = az[k];
    outr[row + k] = val.x;
    outi[row + k] = val.y;
  }
  // adv_q into bit-reversed order in place: each pair (y, bitrev(y))
  // belongs to the one thread that holds its smaller index
  for (int y = threadIdx.x; y < ny; y += blockDim.x) {
    const int r = xfb::bitrev(y, logny);
    if (y < r) {
      const float2 t = uv[y];
      uv[y] = uv[r];
      uv[r] = t;
    }
  }
  xfb::colfft<-1>(uv, ny, logny, tw);
  const size_t qrow = static_cast<size_t>(nx) * hny + row;
  for (int k = threadIdx.x; k < hny; k += blockDim.x) {
    const float2 val = uv[k];
    outr[qrow + k] = val.x;
    outi[qrow + k] = val.y;
  }
}

}  // namespace

// zx, zy, qx, qy, src: (ny, nx), src may be NULL; wr, wi: (6, hny, nx);
// outr, outi: (2, nx, hny).
extern "C" int xfb_kb_adv_tracer(const float* zx, const float* zy,
                                 const float* qx, const float* qy,
                                 const float* wr, const float* wi,
                                 const float* src, const void* tw,
                                 float* outr, float* outi, int ny, int nx,
                                 float scale, float beta, int device,
                                 void* stream) {
  const size_t smem = 2 * static_cast<size_t>(ny) * sizeof(float2);
  cudaError_t err = xfb::prepare(
      reinterpret_cast<const void*>(kb_adv_tracer_kernel), device, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kb_adv_tracer_kernel<<<nx, xfb::threads_for(ny), smem,
                         static_cast<cudaStream_t>(stream)>>>(
      zx, zy, qx, qy, wr, wi, src, static_cast<const float2*>(tw), outr,
      outi, ny, xfb::ilog2(ny), nx, scale, beta);
  return static_cast<int>(cudaGetLastError());
}
