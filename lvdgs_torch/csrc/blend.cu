// Tile blend kernels of the dense Gaussian-splatting rasterizer, for Hopper
// (sm_90a). Built by lvdgs_torch/ops/rasterizer_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC
// into a plain-C shared library loaded with ctypes. -fmad=false keeps every
// operation rounded as in the plain PyTorch versions, whose expressions the
// code below follows in the same order.
//
// Replaces, from lvdgs_tpu/ops/rasterizer_pallas.py:
//   lvdgs_blend_fwd    <- _make_fwd_kernel    (pallas_blend forward)
//   lvdgs_blend_bwd    <- _make_bwd_kernel    (pallas_blend VJP, _pb_bwd)
//   lvdgs_median_depth <- _make_median_kernel (pallas_median_depth)
//
// Layouts (as the Pallas kernels): tp is (K, T, 10) float32 with fields
// [mean_x, mean_y, conic_a, conic_b, conic_c, r, g, b, depth, opacity], slot
// 0 the front-most; counts (T,) int32 is the valid prefix length of each
// tile's slot list; a tile is 16x16 = 256 pixels, row-major, at integer pixel
// coordinates.
//
// Design. One thread block per tile, one thread per pixel (256 threads). The
// block marches the tile's slots front to back; slot parameters are staged
// through shared memory 32 slots (1280 bytes) at a time by all threads
// together. Before each slot, __syncthreads_count(trans > threshold) is the
// tile-wide early exit (Pallas exits per group of 16 tiles; per tile gives the
// same contributions, since a pixel at T <= T_EPS contributes nothing).
// The TPU kernel's sequential grid over tile groups becomes the block grid;
// nothing carries between blocks.
//
// What bounds it on the H100: per pixel and slot the work is ~25 FP32
// operations and one expf, against 40 bytes of slot parameters read once per
// tile, so the arithmetic (not the 3.35 TB/s of HBM) is the floor: about
// T * 256 * slots_marched * ~30 flops at 67 TFLOP/s. In practice the
// per-slot block barrier (and, in the backward, a 10-value block reduction
// per slot) costs more than the arithmetic; the design keeps one barrier per
// slot in the forward and two in the backward, and spends no device memory
// traffic beyond reading tp once and writing each output once. Making this
// faster (several slots per barrier, warp-level exits) is later work.

#include "blend_common.cuh"

namespace {

using namespace lvdgs;

constexpr int BATCH = 32;      // slots staged per shared-memory batch
constexpr int MAX_K = 1024;    // slots per tile held by the per-slot counters

// Stage slots [k0, k0 + n) of tile t into shared memory (all threads).
__device__ __forceinline__ void stage(float* sp, const float* __restrict__ tp, int k0, int n,
                                      int T, int t) {
  for (int i = threadIdx.x; i < n * NF; i += NPIX) {
    const int s = i / NF;
    sp[i] = tp[((size_t)(k0 + s) * T + t) * NF + (i - s * NF)];
  }
}

__global__ void __launch_bounds__(NPIX)
blend_fwd_kernel(const float* __restrict__ tp, const int* __restrict__ counts,
                 float* __restrict__ acc, float* __restrict__ trans_out,
                 int* __restrict__ nt, int K, int T, int ntx) {
  __shared__ float sp[BATCH * NF];
  __shared__ int nt_sh[MAX_K];
  const int t = blockIdx.x;
  const int lin = threadIdx.x;
  const int lane = lin & 31;
  const float px = (float)((t % ntx) * TS + (lin % TS));
  const float py = (float)((t / ntx) * TS + (lin / TS));
  const int count = min(counts[t], K);
  for (int k = lin; k < K; k += NPIX) nt_sh[k] = 0;

  float trans = 1.0f, ar = 0.0f, ag = 0.0f, ab = 0.0f, ad = 0.0f;
  for (int k = 0; k < count; ++k) {
    const int j = k % BATCH;
    if (j == 0) {
      __syncthreads();  // every thread is done with the previous batch
      stage(sp, tp, k, min(BATCH, count - k), T, t);
    }
    // tile-wide early exit; also publishes the staged batch
    if (__syncthreads_count(trans > T_EPS) == 0) break;
    const float* p = sp + j * NF;
    const SlotEval e = eval_slot(p, px, py);
    const float w = (trans > T_EPS) ? e.alpha * trans : 0.0f;
    ar += w * p[5];
    ag += w * p[6];
    ab += w * p[7];
    ad += w * p[8];
    const int touched = __popc(__ballot_sync(0xffffffffu, w > 0.0f));
    if (lane == 0 && touched) atomicAdd(&nt_sh[k], touched);
    trans *= (1.0f - e.alpha);
  }
  __syncthreads();
  float* a = acc + (size_t)t * 4 * NPIX;
  a[lin] = ar;
  a[NPIX + lin] = ag;
  a[2 * NPIX + lin] = ab;
  a[3 * NPIX + lin] = ad;
  trans_out[(size_t)t * NPIX + lin] = trans;
  for (int k = lin; k < K; k += NPIX) nt[(size_t)t * K + k] = nt_sh[k];
}

__global__ void __launch_bounds__(NPIX)
blend_bwd_kernel(const float* __restrict__ tp, const int* __restrict__ counts,
                 const float* __restrict__ acc, const float* __restrict__ trans_in,
                 const float* __restrict__ dacc, const float* __restrict__ dtrans,
                 float* __restrict__ dtp, int K, int T, int ntx) {
  __shared__ float sp[BATCH * NF];
  __shared__ float red[NWARP][NF];
  const int t = blockIdx.x;
  const int lin = threadIdx.x;
  const int lane = lin & 31, warp = lin >> 5;
  const float px = (float)((t % ntx) * TS + (lin % TS));
  const float py = (float)((t / ntx) * TS + (lin / TS));
  const int count = min(counts[t], K);

  const size_t pix = (size_t)t * 4 * NPIX + lin;
  const float tot_r = acc[pix], tot_g = acc[pix + NPIX];
  const float tot_b = acc[pix + 2 * NPIX], tot_d = acc[pix + 3 * NPIX];
  const float g_r = dacc[pix], g_g = dacc[pix + NPIX];
  const float g_b = dacc[pix + 2 * NPIX], g_d = dacc[pix + 3 * NPIX];
  const float trans_final = trans_in[(size_t)t * NPIX + lin];
  const float g_t = dtrans[(size_t)t * NPIX + lin];

  float trans = 1.0f, pr = 0.0f, pg = 0.0f, pb = 0.0f, pd = 0.0f;
  int k = 0;
  for (; k < count; ++k) {
    const int j = k % BATCH;
    if (j == 0) {
      __syncthreads();
      stage(sp, tp, k, min(BATCH, count - k), T, t);
    }
    if (__syncthreads_count(trans > T_EPS) == 0) break;
    const float* p = sp + j * NF;
    const SlotEval e = eval_slot(p, px, py);
    const bool contributes = trans > T_EPS;
    const float w = contributes ? e.alpha * trans : 0.0f;
    pr += w * p[5];
    pg += w * p[6];
    pb += w * p[7];
    pd += w * p[8];
    const float one_m = 1.0f - e.alpha;
    // dL/dalpha = <g_acc, T_k c_k - S_k/(1-alpha_k)> - g_T T_N/(1-alpha_k),
    // S_k the colour/depth sums of the slots behind k
    float galpha = -g_t * trans_final / one_m;
    if (contributes) {
      galpha += g_r * (trans * p[5] - (tot_r - pr) / one_m) +
                g_g * (trans * p[6] - (tot_g - pg) / one_m) +
                g_b * (trans * p[7] - (tot_b - pb) / one_m) +
                g_d * (trans * p[8] - (tot_d - pd) / one_m);
    }
    if (!(e.alpha > 0.0f)) galpha = 0.0f;
    // a slot clamped at ALPHA_MAX passes no gradient to opacity or power
    const bool unclamped = e.raw < ALPHA_MAX;
    const float d_op = unclamped ? galpha * e.G : 0.0f;
    const float d_pow = unclamped ? galpha * e.alpha : 0.0f;
    float v[NF];
    v[0] = d_pow * (p[2] * e.dx + p[3] * e.dy);
    v[1] = d_pow * (p[4] * e.dy + p[3] * e.dx);
    v[2] = d_pow * (-0.5f * e.dx * e.dx);
    v[3] = d_pow * (-e.dx * e.dy);
    v[4] = d_pow * (-0.5f * e.dy * e.dy);
    v[5] = g_r * w;
    v[6] = g_g * w;
    v[7] = g_b * w;
    v[8] = g_d * w;
    v[9] = d_op;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const float s = warp_sum(v[f]);
      if (lane == 0) red[warp][f] = s;
    }
    __syncthreads();
    if (lin < NF) {
      float s = 0.0f;
#pragma unroll
      for (int w8 = 0; w8 < NWARP; ++w8) s += red[w8][lin];
      dtp[((size_t)k * T + t) * NF + lin] = s;
    }
    trans *= one_m;
  }
  // slots the march never reached get zero gradient
  for (int i = lin; i < (K - k) * NF; i += NPIX) {
    const int s = i / NF;
    dtp[((size_t)(k + s) * T + t) * NF + (i - s * NF)] = 0.0f;
  }
}

__global__ void __launch_bounds__(NPIX)
median_depth_kernel(const float* __restrict__ tp, const int* __restrict__ counts,
                    float* __restrict__ dmed_out, float* __restrict__ opac_out,
                    int K, int T, int ntx) {
  __shared__ float sp[BATCH * NF];
  const int t = blockIdx.x;
  const int lin = threadIdx.x;
  const float px = (float)((t % ntx) * TS + (lin % TS));
  const float py = (float)((t / ntx) * TS + (lin / TS));
  const int count = min(counts[t], K);

  float trans = 1.0f, dmed = 0.0f;
  for (int k = 0; k < count; ++k) {
    const int j = k % BATCH;
    if (j == 0) {
      __syncthreads();
      stage(sp, tp, k, min(BATCH, count - k), T, t);
    }
    // march only until every pixel's accumulated opacity crossed 0.5
    if (__syncthreads_count(trans > 0.5f) == 0) break;
    const float* p = sp + j * NF;
    const SlotEval e = eval_slot(p, px, py);
    const float t_new = trans * (1.0f - e.alpha);
    if (trans > 0.5f && t_new <= 0.5f) dmed = p[8];
    trans = t_new;
  }
  dmed_out[(size_t)t * NPIX + lin] = dmed;
  opac_out[(size_t)t * NPIX + lin] = 1.0f - trans;
}

}  // namespace

extern "C" {

int lvdgs_blend_fwd(const float* tp, const int* counts, float* acc, float* trans, int* nt,
                    int K, int T, int ntx, void* stream) {
  if (K > MAX_K) return (int)cudaErrorInvalidValue;
  blend_fwd_kernel<<<T, NPIX, 0, (cudaStream_t)stream>>>(tp, counts, acc, trans, nt, K, T, ntx);
  return (int)cudaGetLastError();
}

int lvdgs_blend_bwd(const float* tp, const int* counts, const float* acc, const float* trans,
                    const float* dacc, const float* dtrans, float* dtp, int K, int T, int ntx,
                    void* stream) {
  blend_bwd_kernel<<<T, NPIX, 0, (cudaStream_t)stream>>>(tp, counts, acc, trans, dacc, dtrans,
                                                         dtp, K, T, ntx);
  return (int)cudaGetLastError();
}

int lvdgs_median_depth(const float* tp, const int* counts, float* dmed, float* opac, int K, int T,
                       int ntx, void* stream) {
  median_depth_kernel<<<T, NPIX, 0, (cudaStream_t)stream>>>(tp, counts, dmed, opac, K, T, ntx);
  return (int)cudaGetLastError();
}

}  // extern "C"
