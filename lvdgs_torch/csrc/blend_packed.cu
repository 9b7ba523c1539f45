// Packed (group-CSR) tile blend kernels of the Gaussian-splatting
// rasterizer, for Hopper (sm_90a). Built by lvdgs_torch/ops/rasterizer_cuda.py
// with the same flags as blend.cu (-fmad=false: every operation rounds as in
// the plain PyTorch versions, whose expressions the code below follows in
// the same order) into its own plain-C shared library, loaded with ctypes.
//
// Replaces, from lvdgs_tpu/ops/rasterizer_pallas.py (float32 variants):
//   lvdgs_packed_fwd <- _make_packed_fwd_kernel (pallas_blend_packed forward,
//                       and _packed_fwd_call with probe_wmax for the
//                       saturation-feedback probe)
//   lvdgs_packed_bwd <- _make_packed_bwd_kernel (pallas_blend_packed VJP)
//
// Layouts (as the Pallas kernels): tp is (NB, KC, TG, 10) float32, chunk b
// holding slots [k0[b], k0[b] + KC) of the TG tiles of group cg[b], fields
// [mean_x, mean_y, conic_a, conic_b, conic_c, r, g, b, depth, opacity];
// empty slots hold the zero sentinel row (opacity 0, so alpha 0). cg (NB,)
// int32 is sorted, and a group's chunks are consecutive in slot order;
// padding chunks carry cg = G. tids (NB, TG) int32 is the tile id of each
// (chunk, lane); goff (1,) int32 shifts every tile id (tile-sharded
// rendering). acc (G+1, 4, TG, P) and trans (G+1, TG, P) are in group order;
// row G, which no tile owns, is written as zeros and ones.
//
// Design. One 256-thread block per (group, lane): one tile, one thread per
// pixel. The block finds its group's chunk range [b0, b1) by binary search
// in cg and walks the chunks in order, carrying transmittance and the
// colour/depth sums (the backward: transmittance and prefix sums) in
// registers across them; this loop takes the place of the TPU's sequential
// grid, whose output blocks are revisited across a group's chunks. Each
// chunk's 32 slots of this lane are staged in shared memory (1280 bytes).
// Before each slot, __syncthreads_count(trans > T_EPS) is the tile-wide exit
// (Pallas skips a whole chunk once every pixel of its group is saturated;
// per tile, before each slot, gives the same contributions, and only the
// final transmittance of saturated pixels differs, by T_EPS-sized amounts).
// Per-slot outputs of slots never marched, and of padding chunks, are zeros.
// Pixel coordinates come from tids + goff, not from the block index: groups
// may hold arbitrary tiles (depth-sorted grouping).
//
// What bounds it on the H100: as the dense kernels, ~25 FP32 operations and
// one expf per pixel and marched slot, against 40 bytes per slot read once
// per tile, so arithmetic (67 TFLOP/s) rather than memory is the floor; in
// practice the per-slot barrier (two in the backward, around its 10-value
// block reduction) costs more. The design keeps one barrier per slot in the
// forward and moves no device memory beyond reading tp once and writing each
// output once.

#include "blend_common.cuh"

namespace {

using namespace lvdgs;

constexpr int KC = 32;  // slots per chunk

enum NtMode { NT_NONE = 0, NT_COUNT = 1, NT_WMAX = 2 };

// First chunk index b with cg[b] >= g (cg is sorted).
__device__ __forceinline__ int lower_bound(const int* __restrict__ cg, int NB, int g) {
  int lo = 0, hi = NB;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cg[mid] < g) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Chunk range [b0, b1) of group g into shared memory; group G (padding)
// owns the chunks from the first padding chunk to the end.
__device__ __forceinline__ void chunk_range(int* range, const int* __restrict__ cg, int NB, int G,
                                            int g) {
  if (threadIdx.x == 0) {
    range[0] = lower_bound(cg, NB, g);
    range[1] = g < G ? lower_bound(cg, NB, g + 1) : NB;
  }
  __syncthreads();
}

// Stage the KC slots of chunk b, lane `lane`, into shared memory.
__device__ __forceinline__ void stage_chunk(float* sp, const float* __restrict__ tp, int b,
                                            int lane, int TG) {
  const float* base = tp + ((size_t)b * KC * TG + lane) * NF;
  for (int i = threadIdx.x; i < KC * NF; i += NPIX) {
    const int s = i / NF;
    sp[i] = base[(size_t)s * TG * NF + (i - s * NF)];
  }
}

__global__ void __launch_bounds__(NPIX)
packed_fwd_kernel(const float* __restrict__ tp, const int* __restrict__ cg,
                  const int* __restrict__ tids, const int* __restrict__ goff,
                  float* __restrict__ acc, float* __restrict__ trans_out, int* __restrict__ nt,
                  int NB, int G, int TG, int ntx, int nt_mode) {
  __shared__ float sp[KC * NF];
  __shared__ int nt_sh[KC];
  __shared__ int range[2];
  const int g = blockIdx.x / TG;
  const int lane = blockIdx.x % TG;
  const int lin = threadIdx.x;
  const int wl = lin & 31;
  chunk_range(range, cg, NB, G, g);
  const int b0 = range[0], b1 = range[1];
  bool alive = g < G && b0 < b1;
  const int tid = alive ? tids[(size_t)b0 * TG + lane] + goff[0] : 0;
  const float px = (float)((tid % ntx) * TS + (lin % TS));
  const float py = (float)((tid / ntx) * TS + (lin / TS));

  float trans = 1.0f, ar = 0.0f, ag = 0.0f, ab = 0.0f, ad = 0.0f;
  for (int b = b0; b < b1; ++b) {
    const bool marched = alive;
    if (marched) {
      __syncthreads();  // every thread is done with the previous chunk
      stage_chunk(sp, tp, b, lane, TG);
      if (lin < KC) nt_sh[lin] = 0;
      for (int kc = 0; kc < KC; ++kc) {
        // tile-wide early exit; also publishes the staged chunk
        if (__syncthreads_count(trans > T_EPS) == 0) {
          alive = false;
          break;
        }
        const float* p = sp + kc * NF;
        const SlotEval e = eval_slot(p, px, py);
        const float w = (trans > T_EPS) ? e.alpha * trans : 0.0f;
        ar += w * p[5];
        ag += w * p[6];
        ab += w * p[7];
        ad += w * p[8];
        if (nt_mode == NT_COUNT) {
          const int touched = __popc(__ballot_sync(0xffffffffu, w > 0.0f));
          if (wl == 0 && touched) atomicAdd(&nt_sh[kc], touched);
        } else if (nt_mode == NT_WMAX) {
          // the max blend weight in 1/65536 units, rounded up so that any
          // nonzero weight stays nonzero
          const int q = __reduce_max_sync(0xffffffffu, (int)ceilf(w * 65536.0f));
          if (wl == 0 && q) atomicMax(&nt_sh[kc], q);
        }
        trans *= (1.0f - e.alpha);
      }
      __syncthreads();
    }
    if (lin < KC) nt[((size_t)b * KC + lin) * TG + lane] = marched ? nt_sh[lin] : 0;
  }
  float* a = acc + ((size_t)g * 4 * TG + lane) * NPIX;
  const size_t cstride = (size_t)TG * NPIX;
  a[lin] = ar;
  a[cstride + lin] = ag;
  a[2 * cstride + lin] = ab;
  a[3 * cstride + lin] = ad;
  trans_out[((size_t)g * TG + lane) * NPIX + lin] = trans;
}

__global__ void __launch_bounds__(NPIX)
packed_bwd_kernel(const float* __restrict__ tp, const int* __restrict__ cg,
                  const int* __restrict__ tids, const int* __restrict__ goff,
                  const float* __restrict__ acc, const float* __restrict__ trans_in,
                  const float* __restrict__ dacc, const float* __restrict__ dtrans,
                  float* __restrict__ dtp, int NB, int G, int TG, int ntx) {
  __shared__ float sp[KC * NF];
  __shared__ float red[NWARP][NF];
  __shared__ int range[2];
  const int g = blockIdx.x / TG;
  const int lane = blockIdx.x % TG;
  const int lin = threadIdx.x;
  const int wl = lin & 31, warp = lin >> 5;
  chunk_range(range, cg, NB, G, g);
  const int b0 = range[0], b1 = range[1];
  bool alive = g < G && b0 < b1;
  const int tid = alive ? tids[(size_t)b0 * TG + lane] + goff[0] : 0;
  const float px = (float)((tid % ntx) * TS + (lin % TS));
  const float py = (float)((tid / ntx) * TS + (lin / TS));

  const size_t cstride = (size_t)TG * NPIX;
  const size_t pix = ((size_t)g * 4 * TG + lane) * NPIX + lin;
  const float tot_r = acc[pix], tot_g = acc[pix + cstride];
  const float tot_b = acc[pix + 2 * cstride], tot_d = acc[pix + 3 * cstride];
  const float g_r = dacc[pix], g_g = dacc[pix + cstride];
  const float g_b = dacc[pix + 2 * cstride], g_d = dacc[pix + 3 * cstride];
  const size_t tpix = ((size_t)g * TG + lane) * NPIX + lin;
  const float trans_final = trans_in[tpix];
  const float g_t = dtrans[tpix];

  float trans = 1.0f, pr = 0.0f, pg = 0.0f, pb = 0.0f, pd = 0.0f;
  for (int b = b0; b < b1; ++b) {
    int kc = 0;
    if (alive) {
      __syncthreads();  // every thread is done with the previous chunk
      stage_chunk(sp, tp, b, lane, TG);
      for (; kc < KC; ++kc) {
        if (__syncthreads_count(trans > T_EPS) == 0) {
          alive = false;
          break;
        }
        const float* p = sp + kc * NF;
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
          if (wl == 0) red[warp][f] = s;
        }
        __syncthreads();
        if (lin < NF) {
          float s = 0.0f;
#pragma unroll
          for (int w8 = 0; w8 < NWARP; ++w8) s += red[w8][lin];
          dtp[(((size_t)b * KC + kc) * TG + lane) * NF + lin] = s;
        }
        trans *= one_m;
      }
    }
    // slots of this chunk the march never reached get zero gradient: they
    // may hold real Gaussians, whose gradients are scattered back
    for (int i = lin; i < (KC - kc) * NF; i += NPIX) {
      const int s = i / NF;
      dtp[(((size_t)b * KC + kc + s) * TG + lane) * NF + (i - s * NF)] = 0.0f;
    }
  }
}

}  // namespace

extern "C" {

int lvdgs_packed_fwd(const float* tp, const int* cg, const int* tids, const int* goff, float* acc,
                     float* trans, int* nt, int NB, int G, int TG, int ntx, int nt_mode,
                     void* stream) {
  packed_fwd_kernel<<<(G + 1) * TG, NPIX, 0, (cudaStream_t)stream>>>(
      tp, cg, tids, goff, acc, trans, nt, NB, G, TG, ntx, nt_mode);
  return (int)cudaGetLastError();
}

int lvdgs_packed_bwd(const float* tp, const int* cg, const int* tids, const int* goff,
                     const float* acc, const float* trans, const float* dacc, const float* dtrans,
                     float* dtp, int NB, int G, int TG, int ntx, void* stream) {
  packed_bwd_kernel<<<(G + 1) * TG, NPIX, 0, (cudaStream_t)stream>>>(
      tp, cg, tids, goff, acc, trans, dacc, dtrans, dtp, NB, G, TG, ntx);
  return (int)cudaGetLastError();
}

}  // extern "C"
