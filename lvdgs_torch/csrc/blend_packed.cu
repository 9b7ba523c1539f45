// Packed (group-CSR) tile blend kernels of the Gaussian-splatting
// rasterizer, for Hopper (sm_90a). Built by lvdgs_torch/ops/rasterizer_cuda.py
// with the same flags as blend.cu (-fmad=false: every operation rounds as in
// the plain PyTorch versions, whose expressions the code below follows in
// the same order) into its own plain-C shared library, loaded with ctypes.
//
// Replaces, from lvdgs_tpu/ops/rasterizer_pallas.py:
//   lvdgs_packed_fwd      <- _make_packed_fwd_kernel (pallas_blend_packed
//                            forward, and _packed_fwd_call with probe_wmax
//                            for the saturation-feedback probe)
//   lvdgs_packed_bwd      <- _make_packed_bwd_kernel (pallas_blend_packed VJP)
//   lvdgs_packed_fwd_bf16 <- _make_packed_fwd_kernel with bf16=True
//   lvdgs_packed_bwd_bf16 <- _make_packed_bwd_kernel with bf16=True
// The bf16 variants are the same kernels (template flag BF16) with each
// slot's weight math in bfloat16 (eval_slot_bf16, blend_common.cuh); the
// transmittance chain, the accumulations and, in the backward, dL/dalpha
// and every gradient product stay float32, with the float32 conic. As
// upstream, the probe (probe_wmax) has no bf16 form.
//
// Layouts (as the Pallas kernels): tp is (NB, KC, TG, 10) float32, chunk b
// holding slots [k0[b], k0[b] + KC) of the TG tiles of group cg[b], fields
// [mean_x, mean_y, conic_a, conic_b, conic_c, r, g, b, depth, opacity];
// empty slots hold the zero sentinel row (opacity 0, so alpha 0). cg (NB,)
// int32 is sorted, and a group's chunks are consecutive in slot order;
// padding chunks carry cg = G. tids (NB, TG) int32 is the tile id of each
// (chunk, lane); goff (1,) int32 shifts every tile id (tile-sharded
// rendering). acc (G+1, 4, TG, P) and trans (G+1, TG, P) are in group order;
// row G, which no tile owns, is written as zeros and ones. march (G+1, TG)
// int32 is the number of slots each tile marched: the forward writes it,
// the backward reads it.
//
// Stop rule: a tile stops before the first slot at which none of its 256
// pixels has transmittance above T_EPS, or at its group's last chunk. Until
// then every pixel multiplies its transmittance by every slot, saturated or
// not (Pallas skips a whole chunk once every pixel of its group is
// saturated; per tile and slot gives the same contributions, and only the
// final transmittance of saturated pixels differs, by T_EPS-sized amounts).
//
// Design. One 256-thread block per (group, lane): one tile, one thread per
// pixel, walking its group's chunks in order and carrying transmittance and
// the colour/depth sums (the backward: transmittance and prefix sums) in
// registers across them; this loop takes the place of the TPU's sequential
// grid, whose output blocks are revisited across a group's chunks.
// - Chunk range: one parallel pass over cg, each thread testing its few
//   positions for the group's two boundaries; the thread at the first one
//   also loads the tile id. One barrier.
// - Staging: each chunk's KC slots of this lane (1280 bytes) are copied into
//   shared memory with cp.async, the next chunk's while the current one is
//   marched (three buffers in the forward, whose warps still read a chunk
//   after its barrier, two in the backward).
// - Forward: each warp marches its own 32 pixels through the chunk with no
//   block barrier, voting (__any_sync) before each slot, and stops at the
//   first slot at which none of its pixels is above T_EPS. After the chunk,
//   one barrier: the tile's stop is the largest of the 8 warps' stops (the
//   chunk's end if a warp is still live there), and a warp that stopped
//   before it replays the slots up to it on its transmittance alone (its
//   blend weights there are 0, so the sums and counts do not move). Every
//   pixel does the operations of a per-slot tile-wide vote in the same
//   order, so the outputs are those of that design bit for bit; touch
//   counts and probe weights are integer atomics, exact in any order. The
//   touch-count mode is a template parameter, so each mode's loop carries
//   only its own code.
// - Backward: marches march[tile] slots, the forward's stop, with no vote
//   (it replays the forward's transmittance chain through the same
//   eval_slot, so the rule would stop it there too). Each warp sums its 32
//   pixels' 10 gradient terms per slot by warp_sum_fields (13 shuffles for
//   the 10 sums; the same bits as 10 warp-sum trees) into shared memory,
//   red[KC][NWARP][NF] per chunk; after the chunk's one barrier the block's
//   threads add the 8 warps' partials of the 320 (slot, field) outputs in
//   a fixed order and write them. Runs repeat bit for bit, and every pixel
//   does the earlier design's operations in its order, so the gradients
//   are that design's bit for bit too. The five divisions by 1 - alpha stay
//   IEEE divisions: one reciprocal and five products take a fifth to two
//   fifths off the backward but round otherwise, and the street run's
//   keyframe test carries any such change into another trajectory
//   (PERF.md).
// - Both: a warp none of whose pixels a slot can reach (its power below
//   skip_below at every pixel, so alpha is 0 there) skips the slot after
//   computing the power, before the exp; exact, since alpha 0 changes
//   nothing.
//
// What bounds it on the H100: per pixel and marched slot ~27 (forward) and
// ~96 (backward) FP32 operations and one expf, against 40 bytes per slot
// read once per tile, so the operations at 67 TFLOP/s rather than memory
// are the floor. Both kernels execute several instructions per counted
// operation (-fmad=false, the exp's range reduction, the gates, shared
// loads, the warp sums), so instruction throughput bounds them: more
// resident blocks (__launch_bounds__ for 4 backward blocks per SM instead
// of the 3 its 78 registers allow) did not make them faster. Measured on an
// H100 80GB HBM3 at 700 W (lvdgs_torch/tools/packed_ab.py, NB 348 on the
// street-shaped block): the earlier design, with a tile-wide
// __syncthreads_count vote before every slot and in the backward a second
// barrier around a block reduction that 10 threads finished one warp
// partial at a time, took 0.069 (forward) and 0.41 ms (backward); the
// per-warp march with one barrier per chunk 0.059 and 0.28, the warp skip
// 0.052 and 0.18 ms (PERF.md). The bf16 variants add 19 roundings per
// pixel and slot to the same float32 arithmetic: on this card bf16 scalar
// math saves no FP32 work (the TPU's gain was packing two bf16 values per
// vector lane), so they carry the configuration that asks for the
// reference's bf16 numbers, not a speed-up.

#include <climits>

#include "blend_common.cuh"
#include "kernel_attrs.cuh"

namespace {

using namespace lvdgs;

enum NtMode { NT_NONE = 0, NT_COUNT = 1, NT_WMAX = 2 };

// Chunk range [b0, b1) of group g into range[0], range[1] and the tile id
// of lane `lane` (0 for a tile with no chunk) into range[2], in one parallel
// pass over cg: position i in [0, NB] starts the chunks of the groups >= h
// iff (i == NB or cg[i] >= h) and (i == 0 or cg[i - 1] < h), which holds at
// exactly one i since cg is sorted. Group G (padding) owns the chunks from
// the first padding chunk to the end. Ends with the barrier that publishes
// the range.
__device__ __forceinline__ void find_chunks(int* range, const int* __restrict__ cg,
                                            const int* __restrict__ tids,
                                            const int* __restrict__ goff, int NB, int G, int TG,
                                            int g, int lane) {
  for (int i = threadIdx.x; i <= NB; i += NPIX) {
    const int prev = i > 0 ? cg[i - 1] : INT_MIN;
    const int cur = i < NB ? cg[i] : INT_MAX;
    if (prev < g && cur >= g) {
      range[0] = i;
      // a group's tile ids are those of its first chunk
      range[2] = (g < G && cur == g) ? tids[(size_t)i * TG + lane] + goff[0] : 0;
    }
    if (g < G && prev <= g && cur > g) range[1] = i;
  }
  if (g == G && threadIdx.x == 0) range[1] = NB;
  __syncthreads();
}

// Start copying the KC slots of chunk b, lane `lane`, into sp; each thread
// copies its own words, which the block sees after cp_async_wait_all and a
// barrier.
__device__ __forceinline__ void stage_chunk_async(float* sp, const float* __restrict__ tp, int b,
                                                  int lane, int TG) {
  const float* base = tp + ((size_t)b * KC * TG + lane) * NF;
  for (int i = threadIdx.x; i < KC * NF; i += NPIX) {
    const int s = i / NF;
    cp_async4(sp + i, base + (size_t)s * TG * NF + (i - s * NF));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// A pixel: its coordinates, and (for the bf16 weight math) its offset in
// its tile and the tile's origin.
struct Pixel {
  float px, py, pxl, pyl, ox, oy;
};

__device__ __forceinline__ Pixel pixel_of(int tid, int ntx, int lin) {
  Pixel q;
  q.ox = (float)((tid % ntx) * TS);
  q.oy = (float)((tid / ntx) * TS);
  q.pxl = (float)(lin % TS);
  q.pyl = (float)(lin / TS);
  q.px = q.ox + q.pxl;
  q.py = q.oy + q.pyl;
  return q;
}

template <bool BF16>
__device__ __forceinline__ SlotPower power_at(const float* p, const Pixel& q) {
  if constexpr (BF16) {
    return slot_power_bf16(p, q.pxl, q.pyl, q.ox, q.oy);
  } else {
    return slot_power(p, q.px, q.py);
  }
}

template <bool BF16>
__device__ __forceinline__ SlotEval alpha_at(const float* p, const SlotPower& s) {
  if constexpr (BF16) {
    return slot_alpha_bf16(p, s);
  } else {
    return slot_alpha(p, s);
  }
}

template <bool BF16, int MODE>
__global__ void __launch_bounds__(NPIX)
packed_fwd_kernel(const float* __restrict__ tp, const int* __restrict__ cg,
                  const int* __restrict__ tids, const int* __restrict__ goff,
                  float* __restrict__ acc, float* __restrict__ trans_out, int* __restrict__ nt,
                  int* __restrict__ march, int NB, int G, int TG, int ntx) {
  __shared__ float sp[3][KC * NF];
  __shared__ int nt_sh[2][KC];
  __shared__ int stop_sh[2][NWARP];
  __shared__ int range[3];
  const int g = blockIdx.x / TG;
  const int lane = blockIdx.x % TG;
  const int lin = threadIdx.x;
  const int wl = lin & 31, warp = lin >> 5;
  if (lin < 2 * KC) nt_sh[lin / KC][lin % KC] = 0;
  find_chunks(range, cg, tids, goff, NB, G, TG, g, lane);
  const int b0 = range[0], b1 = range[1];
  bool live = g < G && b0 < b1;  // the tile has not stopped
  const Pixel q = pixel_of(range[2], ntx, lin);
  if (live) {
    stage_chunk_async(sp[0], tp, b0, lane, TG);
    cp_async_wait_all();
  }
  __syncthreads();

  float trans = 1.0f, ar = 0.0f, ag = 0.0f, ab = 0.0f, ad = 0.0f;
  int marched = 0;
  for (int b = b0, c = 0; b < b1; ++b, ++c) {
    int* cnt = nt_sh[c & 1];
    if (live) {
      const float* s = sp[c % 3];
      if (b + 1 < b1) stage_chunk_async(sp[(c + 1) % 3], tp, b + 1, lane, TG);
      const float thr = skip_below(s[wl * NF + 9]);
      // this warp's march: it stops before the first slot at which none of
      // its pixels is above T_EPS
      int stop = KC;
      for (int kc = 0; kc < KC; ++kc) {
        if (!__any_sync(FULL, trans > T_EPS)) {
          stop = kc;
          break;
        }
        const float* p = s + kc * NF;
        const SlotPower pw = power_at<BF16>(p, q);
        if (warp_skips(pw, thr, kc)) continue;
        const SlotEval e = alpha_at<BF16>(p, pw);
        const float w = (trans > T_EPS) ? e.alpha * trans : 0.0f;
        ar += w * p[5];
        ag += w * p[6];
        ab += w * p[7];
        ad += w * p[8];
        if constexpr (MODE == NT_COUNT) {
          const int touched = __popc(__ballot_sync(FULL, w > 0.0f));
          if (wl == 0 && touched) atomicAdd(&cnt[kc], touched);
        } else if constexpr (MODE == NT_WMAX) {
          // the max blend weight in 1/65536 units, rounded up so that any
          // nonzero weight stays nonzero
          const int qw = __reduce_max_sync(FULL, (int)ceilf(w * 65536.0f));
          if (wl == 0 && qw) atomicMax(&cnt[kc], qw);
        }
        trans *= (1.0f - e.alpha);
      }
      if (wl == 0) stop_sh[c & 1][warp] = stop;
      cp_async_wait_all();
      __syncthreads();  // the warps' stops and counts, and the next chunk's slots
      int tile_stop = 0;
#pragma unroll
      for (int w8 = 0; w8 < NWARP; ++w8) tile_stop = max(tile_stop, stop_sh[c & 1][w8]);
      // a warp that stopped before the tile goes on multiplying its
      // transmittance up to the tile's stop
      for (int kc = stop; kc < tile_stop; ++kc) {
        const float* p = s + kc * NF;
        const SlotPower pw = power_at<BF16>(p, q);
        if (warp_skips(pw, thr, kc)) continue;
        trans *= (1.0f - alpha_at<BF16>(p, pw).alpha);
      }
      marched += tile_stop;
      live = tile_stop == KC;
    }
    if (lin < KC) {
      nt[((size_t)b * KC + lin) * TG + lane] = cnt[lin];
      cnt[lin] = 0;  // for chunk c + 2, which starts after the next barrier
    }
  }
  float* a = acc + ((size_t)g * 4 * TG + lane) * NPIX;
  const size_t cstride = (size_t)TG * NPIX;
  a[lin] = ar;
  a[cstride + lin] = ag;
  a[2 * cstride + lin] = ab;
  a[3 * cstride + lin] = ad;
  trans_out[((size_t)g * TG + lane) * NPIX + lin] = trans;
  if (lin == 0) march[(size_t)g * TG + lane] = marched;
}

template <bool BF16>
__global__ void __launch_bounds__(NPIX)
packed_bwd_kernel(const float* __restrict__ tp, const int* __restrict__ cg,
                  const int* __restrict__ tids, const int* __restrict__ goff,
                  const int* __restrict__ march, const float* __restrict__ acc,
                  const float* __restrict__ trans_in, const float* __restrict__ dacc,
                  const float* __restrict__ dtrans, float* __restrict__ dtp, int NB, int G, int TG,
                  int ntx) {
  __shared__ float sp[2][KC * NF];
  __shared__ float red[2][KC][NWARP][NF];
  __shared__ int range[3];
  const int g = blockIdx.x / TG;
  const int lane = blockIdx.x % TG;
  const int lin = threadIdx.x;
  const int wl = lin & 31, warp = lin >> 5;
  const int field = bfly_field(wl);
  find_chunks(range, cg, tids, goff, NB, G, TG, g, lane);
  const int b0 = range[0], b1 = range[1];
  const int m = (g < G && b0 < b1) ? march[(size_t)g * TG + lane] : 0;  // slots to march
  const Pixel q = pixel_of(range[2], ntx, lin);
  if (m > 0) {
    stage_chunk_async(sp[0], tp, b0, lane, TG);
    cp_async_wait_all();
  }

  const size_t cstride = (size_t)TG * NPIX;
  const size_t pix = ((size_t)g * 4 * TG + lane) * NPIX + lin;
  const float tot_r = acc[pix], tot_g = acc[pix + cstride];
  const float tot_b = acc[pix + 2 * cstride], tot_d = acc[pix + 3 * cstride];
  const float g_r = dacc[pix], g_g = dacc[pix + cstride];
  const float g_b = dacc[pix + 2 * cstride], g_d = dacc[pix + 3 * cstride];
  const size_t tpix = ((size_t)g * TG + lane) * NPIX + lin;
  const float trans_final = trans_in[tpix];
  const float g_t = dtrans[tpix];
  __syncthreads();

  float trans = 1.0f, pr = 0.0f, pg = 0.0f, pb = 0.0f, pd = 0.0f;
  for (int b = b0, c = 0; b < b1; ++b, ++c) {
    const int n = min(max(m - c * KC, 0), KC);  // slots of this chunk to march
    float* out = dtp + ((size_t)b * KC * TG + lane) * NF;
    if (n == 0) {
      // slots the march never reaches get zero gradient: they may hold
      // real Gaussians, whose gradients are scattered back
      for (int i = lin; i < KC * NF; i += NPIX) {
        const int s = i / NF;
        out[(size_t)s * TG * NF + (i - s * NF)] = 0.0f;
      }
      continue;
    }
    const float* s = sp[c & 1];
    if (b + 1 < b1 && m > (c + 1) * KC) stage_chunk_async(sp[(c + 1) & 1], tp, b + 1, lane, TG);
    float(*r)[NWARP][NF] = red[c & 1];
    const float thr = skip_below(s[wl * NF + 9]);
    for (int kc = 0; kc < n; ++kc) {
      const float* p = s + kc * NF;
      const SlotPower pw = power_at<BF16>(p, q);
      if (warp_skips(pw, thr, kc)) {
        if (field >= 0) r[kc][warp][field] = 0.0f;
        continue;
      }
      const SlotEval e = alpha_at<BF16>(p, pw);
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
      const float sum = warp_sum_fields(v, wl);
      if (field >= 0) r[kc][warp][field] = sum;
      trans *= one_m;
    }
    cp_async_wait_all();
    __syncthreads();  // the warps' partial sums, and the next chunk's slots
    for (int i = lin; i < KC * NF; i += NPIX) {
      const int kc = i / NF, f = i - kc * NF;
      float sum = 0.0f;
      if (kc < n) {
#pragma unroll
        for (int w8 = 0; w8 < NWARP; ++w8) sum += r[kc][w8][f];
      }
      out[(size_t)kc * TG * NF + f] = sum;
    }
  }
}

// B4 (BF16: B4-bf16) in touch-count mode `mode`.
template <bool BF16>
int launch_fwd(const float* tp, const int* cg, const int* tids, const int* goff, float* acc,
               float* trans, int* nt, int* march, int NB, int G, int TG, int ntx, int mode,
               cudaStream_t stream) {
  const dim3 grid((G + 1) * TG);
  if (mode == NT_NONE) {
    packed_fwd_kernel<BF16, NT_NONE><<<grid, NPIX, 0, stream>>>(tp, cg, tids, goff, acc, trans, nt,
                                                                march, NB, G, TG, ntx);
  } else if (mode == NT_COUNT) {
    packed_fwd_kernel<BF16, NT_COUNT><<<grid, NPIX, 0, stream>>>(tp, cg, tids, goff, acc, trans,
                                                                 nt, march, NB, G, TG, ntx);
  } else if constexpr (!BF16) {  // as upstream, the probe has no bf16 form
    if (mode != NT_WMAX) return (int)cudaErrorInvalidValue;
    packed_fwd_kernel<false, NT_WMAX><<<grid, NPIX, 0, stream>>>(tp, cg, tids, goff, acc, trans,
                                                                 nt, march, NB, G, TG, ntx);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lvdgs_packed_fwd(const float* tp, const int* cg, const int* tids, const int* goff, float* acc,
                     float* trans, int* nt, int* march, int NB, int G, int TG, int ntx, int nt_mode,
                     void* stream) {
  return launch_fwd<false>(tp, cg, tids, goff, acc, trans, nt, march, NB, G, TG, ntx, nt_mode,
                           (cudaStream_t)stream);
}

int lvdgs_packed_fwd_bf16(const float* tp, const int* cg, const int* tids, const int* goff,
                          float* acc, float* trans, int* nt, int* march, int NB, int G, int TG,
                          int ntx, int nt_mode, void* stream) {
  return launch_fwd<true>(tp, cg, tids, goff, acc, trans, nt, march, NB, G, TG, ntx, nt_mode,
                          (cudaStream_t)stream);
}

int lvdgs_packed_bwd(const float* tp, const int* cg, const int* tids, const int* goff,
                     const int* march, const float* acc, const float* trans, const float* dacc,
                     const float* dtrans, float* dtp, int NB, int G, int TG, int ntx,
                     void* stream) {
  packed_bwd_kernel<false><<<(G + 1) * TG, NPIX, 0, (cudaStream_t)stream>>>(
      tp, cg, tids, goff, march, acc, trans, dacc, dtrans, dtp, NB, G, TG, ntx);
  return (int)cudaGetLastError();
}

int lvdgs_packed_bwd_bf16(const float* tp, const int* cg, const int* tids, const int* goff,
                          const int* march, const float* acc, const float* trans,
                          const float* dacc, const float* dtrans, float* dtp, int NB, int G,
                          int TG, int ntx, void* stream) {
  packed_bwd_kernel<true><<<(G + 1) * TG, NPIX, 0, (cudaStream_t)stream>>>(
      tp, cg, tids, goff, march, acc, trans, dacc, dtrans, dtp, NB, G, TG, ntx);
  return (int)cudaGetLastError();
}

// lvdgs::kernel_attrs of this library's kernel k.
int lvdgs_packed_attrs(int k, const char** name, int* out) {
  const lvdgs::KernelInfo table[] = {LVDGS_KERNEL(NPIX, packed_fwd_kernel<false, NT_NONE>),
                                     LVDGS_KERNEL(NPIX, packed_fwd_kernel<false, NT_COUNT>),
                                     LVDGS_KERNEL(NPIX, packed_fwd_kernel<false, NT_WMAX>),
                                     LVDGS_KERNEL(NPIX, packed_fwd_kernel<true, NT_NONE>),
                                     LVDGS_KERNEL(NPIX, packed_fwd_kernel<true, NT_COUNT>),
                                     LVDGS_KERNEL(NPIX, packed_bwd_kernel<false>),
                                     LVDGS_KERNEL(NPIX, packed_bwd_kernel<true>)};
  return lvdgs::kernel_attrs(table, sizeof(table) / sizeof(table[0]), k, name, out);
}

}  // extern "C"
