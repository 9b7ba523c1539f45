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
// coordinates. march (T,) int32 is the number of slots each tile marched:
// the forward writes it, the backward reads it.
//
// Stop rule: a tile stops before slot k once k reaches its count or none of
// its 256 pixels has transmittance above T_EPS (0.5 for the median). Until
// then every pixel multiplies its transmittance by every slot, saturated or
// not (Pallas tests the rule per group of 16 tiles; per tile gives the same
// contributions, since a pixel at T <= T_EPS contributes nothing).
//
// Design. One 256-thread block per tile, one thread per pixel; the TPU
// kernel's sequential grid over tile groups becomes the block grid, and
// nothing carries between blocks. The blend forward and backward march the
// tile's slots in chunks of KC = 32, as the packed kernels of
// blend_packed.cu do (same helpers, blend_common.cuh):
// - Staging: chunk c+1's slots (1280 bytes) are copied into shared memory
//   with cp.async while chunk c is marched (three buffers in the forward,
//   whose warps still read a chunk after its barrier, two in the backward).
// - Forward: each warp marches its own 32 pixels through the chunk with no
//   block barrier, voting (__any_sync) before each slot, and stops at the
//   first slot at which none of its pixels is above T_EPS. After the chunk,
//   one barrier: the tile's stop is the largest of the 8 warps' stops, and
//   a warp that stopped before it replays the slots up to it on its
//   transmittance alone (its blend weights there are 0). Touch counts: lane
//   k of each warp keeps the warp's __popc of a ballot for slot k of the
//   chunk; after the barrier 32 threads add the 8 warps' counts (integers,
//   exact in any order) and write them, once per chunk. Every pixel does
//   the operations of a per-slot tile-wide vote in the same order, so the
//   outputs are that design's bit for bit. The forward writes the tile's
//   stop as march.
// - Backward: marches march[tile] slots with no vote (it replays the
//   forward's transmittance chain through the same eval_slot, so the rule
//   would stop it there too). Every warp marches all of them: its dead
//   pixels still carry the -g_T * T_final / (1 - alpha) term. Each warp sums
//   its pixels' 10 gradient terms per slot by warp_sum_fields into shared
//   partials red[KC][NWARP][NF] (two buffers); after the chunk's one barrier
//   the block's threads add the 8 warps' partials of the chunk's 320 (slot,
//   field) outputs from +0 in warp order and write them. Runs repeat bit for
//   bit, and the sums are those of a per-slot tree and block sum bit for
//   bit. The five divisions by 1 - alpha stay IEEE divisions (a reciprocal
//   rounds otherwise, and the street run's keyframe test turns any moved
//   bit into another trajectory; PERF.md).
// - Both: a warp none of whose pixels a slot can reach (its power below
//   skip_below at every pixel, so alpha is 0 there) skips the slot before
//   the exp; exact, since alpha 0 changes nothing, and a skipped slot's
//   gradient partial is +0.
// - Median: the forward's per-warp march, staging (three buffers) and
//   replay at the threshold 0.5, with no sums or counts: a pixel takes the
//   depth of the slot that brings its transmittance from above 0.5 to 0.5
//   or below, and a warp that stopped before the tile replays up to the
//   tile's stop (its pixels are all at 0.5 or below there, so none crosses
//   and dmed stays). Without the warp skip: at ~20 operations per pixel and
//   slot, the skip's shuffle, vote and branch before every slot cost more
//   than the exps it saves (PERF.md).
//
// What bounds them on the H100: per pixel and marched slot ~27 (forward),
// ~96 (backward) and ~20 (median) FP32 operations and one expf, against 40
// bytes of slot parameters read once per tile, so the operations at
// 67 TFLOP/s rather than the 3.35 TB/s of HBM are the floor. Like the
// packed kernels, they execute several instructions per counted operation
// (-fmad=false, the exp's range reduction, the gates, shared loads, the warp
// sums): instruction issue bounds them. Measured on an H100 80GB HBM3 at
// 700 W (K 256, T 1848, the random street-shaped block, straight from the
// library): the first design, with a tile-wide __syncthreads_count vote
// before every slot and in the backward a second barrier around a block
// reduction that 10 threads finished, took 0.0911 (forward) and 0.4308 ms
// (backward); this one 0.075 and 0.236 ms with the same bits (0.81x and
// 0.54x; on a dense street run's tracking call the backward took 0.60 ms a
// launch against 1.42). Neither more blocks per SM (launch bounds), vector
// loads of 16-byte slot rows, nor an in-kernel heaviest-tile-first order
// paid on the street run's own slots (PERF.md). The median marches few
// slots (~9 a tile on the random block, ~27 on a street run's final map),
// so per-block costs weigh more: the first design, a tile-wide vote and a
// barrier before every slot, took 0.0164 ms on the random block and 0.0513
// on the packed street run's final map; this one 0.0156 and 0.0373 (0.95x,
// 0.73x; with the warp skip 0.0178 and 0.0487), same bits, same card.

#include "blend_common.cuh"
#include "kernel_attrs.cuh"

namespace {

using namespace lvdgs;

// Start copying slots [k0, k0 + n) of tile t into sp with cp.async; each
// thread copies its own words, which the block sees after cp_async_wait_all
// and a barrier.
__device__ __forceinline__ void stage_async(float* sp, const float* __restrict__ tp, int k0, int n,
                                            int T, int t) {
  for (int i = threadIdx.x; i < n * NF; i += NPIX) {
    const int s = i / NF;
    cp_async4(sp + i, tp + ((size_t)(k0 + s) * T + t) * NF + (i - s * NF));
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(NPIX)
blend_fwd_kernel(const float* __restrict__ tp, const int* __restrict__ counts,
                 float* __restrict__ acc, float* __restrict__ trans_out, int* __restrict__ nt,
                 int* __restrict__ march, int K, int T, int ntx) {
  __shared__ float sp[3][KC * NF];
  __shared__ int cnt_sh[2][NWARP][KC];
  __shared__ int stop_sh[2][NWARP];
  const int t = blockIdx.x;
  const int lin = threadIdx.x;
  const int wl = lin & 31, warp = lin >> 5;
  const float px = (float)((t % ntx) * TS + (lin % TS));
  const float py = (float)((t / ntx) * TS + (lin / TS));
  const int count = max(min(counts[t], K), 0);
  const int nch = (count + KC - 1) / KC;  // chunks of the slot list
  if (nch > 0) {
    stage_async(sp[0], tp, 0, min(KC, count), T, t);
    cp_async_wait_all();
  }
  __syncthreads();

  float trans = 1.0f, ar = 0.0f, ag = 0.0f, ab = 0.0f, ad = 0.0f;
  int marched = 0;
  int c = 0;
  for (bool live = nch > 0; live; ++c) {
    const int n = min(KC, count - c * KC);  // slots of this chunk
    const float* s = sp[c % 3];
    int mine = 0;  // lane kc: this warp's touch count of slot kc
    if (c + 1 < nch) {
      stage_async(sp[(c + 1) % 3], tp, (c + 1) * KC, min(KC, count - (c + 1) * KC), T, t);
    }
    const float thr = wl < n ? skip_below(s[wl * NF + 9]) : 0.0f;
    // this warp's march: it stops before the first slot at which none of
    // its pixels is above T_EPS
    int stop = n;
    for (int kc = 0; kc < n; ++kc) {
      if (!__any_sync(FULL, trans > T_EPS)) {
        stop = kc;
        break;
      }
      const float* p = s + kc * NF;
      const SlotPower pw = slot_power(p, px, py);
      if (warp_skips(pw, thr, kc)) continue;
      const SlotEval e = slot_alpha(p, pw);
      const float w = (trans > T_EPS) ? e.alpha * trans : 0.0f;
      ar += w * p[5];
      ag += w * p[6];
      ab += w * p[7];
      ad += w * p[8];
      const int touched = __popc(__ballot_sync(FULL, w > 0.0f));
      if (wl == kc) mine = touched;
      trans *= (1.0f - e.alpha);
    }
    if (wl == 0) stop_sh[c & 1][warp] = stop;
    cnt_sh[c & 1][warp][wl] = mine;
    cp_async_wait_all();
    __syncthreads();  // the warps' stops and counts, and the next chunk's slots
    int tile_stop = 0;
#pragma unroll
    for (int w8 = 0; w8 < NWARP; ++w8) tile_stop = max(tile_stop, stop_sh[c & 1][w8]);
    // a warp that stopped before the tile goes on multiplying its
    // transmittance up to the tile's stop
    for (int kc = stop; kc < tile_stop; ++kc) {
      const float* p = s + kc * NF;
      const SlotPower pw = slot_power(p, px, py);
      if (warp_skips(pw, thr, kc)) continue;
      trans *= (1.0f - slot_alpha(p, pw).alpha);
    }
    marched += tile_stop;
    live = tile_stop == n && c + 1 < nch;
    // the chunk's counts, 0 past the stop and past the count
    if (lin < KC && c * KC + lin < K) {
      int sum = 0;
#pragma unroll
      for (int w8 = 0; w8 < NWARP; ++w8) sum += cnt_sh[c & 1][w8][lin];
      nt[(size_t)t * K + c * KC + lin] = sum;
    }
  }
  // slots of the chunks never marched touch no pixel
  for (int k = c * KC + lin; k < K; k += NPIX) nt[(size_t)t * K + k] = 0;
  float* a = acc + (size_t)t * 4 * NPIX;
  a[lin] = ar;
  a[NPIX + lin] = ag;
  a[2 * NPIX + lin] = ab;
  a[3 * NPIX + lin] = ad;
  trans_out[(size_t)t * NPIX + lin] = trans;
  if (lin == 0) march[t] = marched;
}

__global__ void __launch_bounds__(NPIX)
blend_bwd_kernel(const float* __restrict__ tp, const int* __restrict__ counts,
                 const int* __restrict__ march, const float* __restrict__ acc,
                 const float* __restrict__ trans_in, const float* __restrict__ dacc,
                 const float* __restrict__ dtrans, float* __restrict__ dtp, int K, int T,
                 int ntx) {
  __shared__ float sp[2][KC * NF];
  __shared__ float red[2][KC][NWARP][NF];
  const int t = blockIdx.x;
  const int lin = threadIdx.x;
  const int wl = lin & 31, warp = lin >> 5;
  const int field = bfly_field(wl);
  const float px = (float)((t % ntx) * TS + (lin % TS));
  const float py = (float)((t / ntx) * TS + (lin / TS));
  // slots to march: the forward's stop (never past the count, so that a
  // wrong march cannot read outside the tile's slots)
  const int m = max(min(march[t], min(counts[t], K)), 0);
  const int nch = (m + KC - 1) / KC;
  if (nch > 0) {
    stage_async(sp[0], tp, 0, min(KC, m), T, t);
    cp_async_wait_all();
  }

  const size_t pix = (size_t)t * 4 * NPIX + lin;
  const float tot_r = acc[pix], tot_g = acc[pix + NPIX];
  const float tot_b = acc[pix + 2 * NPIX], tot_d = acc[pix + 3 * NPIX];
  const float g_r = dacc[pix], g_g = dacc[pix + NPIX];
  const float g_b = dacc[pix + 2 * NPIX], g_d = dacc[pix + 3 * NPIX];
  const float trans_final = trans_in[(size_t)t * NPIX + lin];
  const float g_t = dtrans[(size_t)t * NPIX + lin];
  __syncthreads();

  float trans = 1.0f, pr = 0.0f, pg = 0.0f, pb = 0.0f, pd = 0.0f;
  for (int c = 0; c < nch; ++c) {
    const int n = min(KC, m - c * KC);  // slots of this chunk to march
    const float* s = sp[c & 1];
    if (c + 1 < nch) {
      stage_async(sp[(c + 1) & 1], tp, (c + 1) * KC, min(KC, m - (c + 1) * KC), T, t);
    }
    float(*r)[NWARP][NF] = red[c & 1];
    const float thr = wl < n ? skip_below(s[wl * NF + 9]) : 0.0f;
    for (int kc = 0; kc < n; ++kc) {
      const float* p = s + kc * NF;
      const SlotPower pw = slot_power(p, px, py);
      if (warp_skips(pw, thr, kc)) {
        if (field >= 0) r[kc][warp][field] = 0.0f;
        continue;
      }
      const SlotEval e = slot_alpha(p, pw);
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
    for (int i = lin; i < n * NF; i += NPIX) {
      const int kc = i / NF, f = i - kc * NF;
      float sum = 0.0f;
#pragma unroll
      for (int w8 = 0; w8 < NWARP; ++w8) sum += r[kc][w8][f];
      dtp[((size_t)(c * KC + kc) * T + t) * NF + f] = sum;
    }
  }
  // slots the march never reached get zero gradient
  for (int i = lin; i < (K - m) * NF; i += NPIX) {
    const int s = i / NF;
    dtp[((size_t)(m + s) * T + t) * NF + (i - s * NF)] = 0.0f;
  }
}

__global__ void __launch_bounds__(NPIX)
median_depth_kernel(const float* __restrict__ tp, const int* __restrict__ counts,
                    float* __restrict__ dmed_out, float* __restrict__ opac_out,
                    int K, int T, int ntx) {
  __shared__ float sp[3][KC * NF];
  __shared__ int stop_sh[2][NWARP];
  const int t = blockIdx.x;
  const int lin = threadIdx.x;
  const int wl = lin & 31;
  const float px = (float)((t % ntx) * TS + (lin % TS));
  const float py = (float)((t / ntx) * TS + (lin / TS));
  const int count = max(min(counts[t], K), 0);
  const int nch = (count + KC - 1) / KC;  // chunks of the slot list
  if (nch > 0) {
    stage_async(sp[0], tp, 0, min(KC, count), T, t);
    cp_async_wait_all();
  }
  __syncthreads();

  float trans = 1.0f, dmed = 0.0f;
  for (int c = 0; c < nch; ++c) {
    const int n = min(KC, count - c * KC);  // slots of this chunk
    const float* s = sp[c % 3];
    if (c + 1 < nch) {
      stage_async(sp[(c + 1) % 3], tp, (c + 1) * KC, min(KC, count - (c + 1) * KC), T, t);
    }
    // this warp's march: it stops before the first slot at which none of
    // its pixels' transmittance is above 0.5
    int stop = n;
    for (int kc = 0; kc < n; ++kc) {
      if (!__any_sync(FULL, trans > 0.5f)) {
        stop = kc;
        break;
      }
      const float* p = s + kc * NF;
      const float t_new = trans * (1.0f - eval_slot(p, px, py).alpha);
      // exactly one slot per pixel takes accumulated opacity past 0.5
      if (trans > 0.5f && t_new <= 0.5f) dmed = p[8];
      trans = t_new;
    }
    if (wl == 0) stop_sh[c & 1][lin >> 5] = stop;
    cp_async_wait_all();
    __syncthreads();  // the warps' stops, and the next chunk's slots
    int tile_stop = 0;
#pragma unroll
    for (int w8 = 0; w8 < NWARP; ++w8) tile_stop = max(tile_stop, stop_sh[c & 1][w8]);
    // a warp that stopped before the tile goes on multiplying its
    // transmittance up to the tile's stop; its pixels are all at 0.5 or
    // below, so none crosses there and dmed stays
    for (int kc = stop; kc < tile_stop; ++kc) trans *= (1.0f - eval_slot(s + kc * NF, px, py).alpha);
    if (tile_stop < n) break;
  }
  dmed_out[(size_t)t * NPIX + lin] = dmed;
  opac_out[(size_t)t * NPIX + lin] = 1.0f - trans;
}

}  // namespace

extern "C" {

int lvdgs_blend_fwd(const float* tp, const int* counts, float* acc, float* trans, int* nt,
                    int* march, int K, int T, int ntx, void* stream) {
  blend_fwd_kernel<<<T, NPIX, 0, (cudaStream_t)stream>>>(tp, counts, acc, trans, nt, march, K, T,
                                                         ntx);
  return (int)cudaGetLastError();
}

int lvdgs_blend_bwd(const float* tp, const int* counts, const int* march, const float* acc,
                    const float* trans, const float* dacc, const float* dtrans, float* dtp, int K,
                    int T, int ntx, void* stream) {
  blend_bwd_kernel<<<T, NPIX, 0, (cudaStream_t)stream>>>(tp, counts, march, acc, trans, dacc,
                                                         dtrans, dtp, K, T, ntx);
  return (int)cudaGetLastError();
}

int lvdgs_median_depth(const float* tp, const int* counts, float* dmed, float* opac, int K, int T,
                       int ntx, void* stream) {
  median_depth_kernel<<<T, NPIX, 0, (cudaStream_t)stream>>>(tp, counts, dmed, opac, K, T, ntx);
  return (int)cudaGetLastError();
}

// lvdgs::kernel_attrs of this library's kernel k.
int lvdgs_blend_attrs(int k, const char** name, int* out) {
  const lvdgs::KernelInfo table[] = {LVDGS_KERNEL(NPIX, blend_fwd_kernel),
                                     LVDGS_KERNEL(NPIX, blend_bwd_kernel),
                                     LVDGS_KERNEL(NPIX, median_depth_kernel)};
  return lvdgs::kernel_attrs(table, sizeof(table) / sizeof(table[0]), k, name, out);
}

}  // extern "C"
