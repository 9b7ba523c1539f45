// Device code shared by the dense (blend.cu) and packed (blend_packed.cu)
// tile blend kernels: the constants of the blend, one slot's alpha at one
// pixel (in float32, and with the weight math in bfloat16), the cp.async
// copies that stage slots, the warp skip, and the warp sums of a slot's 10
// gradient fields. Every kernel that replays another's transmittance chain
// evaluates slots through the same function, so the chains agree bit for
// bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lvdgs {

constexpr int NF = 10;
constexpr int TS = 16;
constexpr int NPIX = TS * TS;  // threads per block, one per pixel of a tile
constexpr int NWARP = NPIX / 32;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1.0e-4f;
constexpr int KC = 32;  // slots per staged chunk, one per lane of a warp
constexpr unsigned FULL = 0xffffffffu;

struct SlotEval {
  float alpha, G, dx, dy, raw;
};

// A slot's offsets from a pixel and its conic power there: the part of
// eval_slot before the exp.
struct SlotPower {
  float dx, dy, power;
};

__device__ __forceinline__ SlotPower slot_power(const float* p, float px, float py) {
  SlotPower s;
  s.dx = px - p[0];
  s.dy = py - p[1];
  s.power = -0.5f * (p[2] * s.dx * s.dx + p[4] * s.dy * s.dy) - p[3] * s.dx * s.dy;
  return s;
}

__device__ __forceinline__ SlotEval slot_alpha(const float* p, const SlotPower& s) {
  SlotEval e;
  e.dx = s.dx;
  e.dy = s.dy;
  e.G = expf(s.power);
  e.raw = p[9] * e.G;
  e.alpha = (s.power <= 0.0f && e.raw >= ALPHA_MIN) ? fminf(ALPHA_MAX, e.raw) : 0.0f;
  return e;
}

// Alpha of one slot (fields p[0..9]) at pixel (px, py).
__device__ __forceinline__ SlotEval eval_slot(const float* p, float px, float py) {
  return slot_alpha(p, slot_power(p, px, py));
}

// x rounded to bfloat16 (nearest even) and widened back.
__device__ __forceinline__ float bf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// eval_slot with the weight math in bfloat16, as the Pallas packed kernels'
// bf16 variant (rasterizer_pallas.py, _make_packed_fwd_kernel and the
// backward's weight replay): coordinates relative to the tile origin
// (ox, oy), (pxl, pyl) the pixel's offset in its tile (bf16-exact); every
// operation of the Pallas bf16 expression is one float32 operation rounded
// once, which is what a bf16 operation on bf16 operands gives (a product of
// two bf16 values is exact in float32). exp runs on the widened power.
// alpha and the returned G, dx, dy are float32 values of bf16 numbers; the
// ok test compares the rounded power in float32.
__device__ __forceinline__ SlotPower slot_power_bf16(const float* p, float pxl, float pyl, float ox,
                                                     float oy) {
  SlotPower s;
  s.dx = bf(pxl - bf(p[0] - ox));
  s.dy = bf(pyl - bf(p[1] - oy));
  const float ca = bf(p[2]), cb = bf(p[3]), cc = bf(p[4]);
  const float quad = bf(bf(bf(ca * s.dx) * s.dx) + bf(bf(cc * s.dy) * s.dy));
  s.power = bf(bf(-0.5f * quad) - bf(bf(cb * s.dx) * s.dy));
  return s;
}

__device__ __forceinline__ SlotEval slot_alpha_bf16(const float* p, const SlotPower& s) {
  SlotEval e;
  e.dx = s.dx;
  e.dy = s.dy;
  e.G = bf(expf(s.power));
  e.raw = bf(bf(p[9]) * e.G);
  e.alpha = (s.power <= 0.0f && e.raw >= ALPHA_MIN) ? fminf(ALPHA_MAX, e.raw) : 0.0f;
  return e;
}

__device__ __forceinline__ SlotEval eval_slot_bf16(const float* p, float pxl, float pyl, float ox,
                                                   float oy) {
  return slot_alpha_bf16(p, slot_power_bf16(p, pxl, pyl, ox, oy));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The power below which a slot of opacity o has alpha 0 at a pixel: there
// o * exp(power) < ALPHA_MIN by a margin of 5%, more than the bf16 weight
// math's three roundings after the power can add. A warp all of whose
// pixels lie below it skips the slot before the exp, exactly: alpha 0
// moves no sum, count or transmittance, and its gradient terms are zeros.
// It is +inf for o == +0 and NaN for o < 0 or NaN, where no pixel's alpha is
// above 0 either and warp_skips skips the slot.
__device__ __forceinline__ float skip_below(float o) { return logf(ALPHA_MIN / o) - 0.05f; }

// Whether every pixel of the warp lies below slot kc's skip power; `thr`
// holds, in lane k, the skip power of slot k of the chunk.
__device__ __forceinline__ bool warp_skips(const SlotPower& pw, float thr, int kc) {
  return !__any_sync(FULL, pw.power >= __shfl_sync(FULL, thr, kc));
}

// The warp sums of the NF = 10 values v, by a transposed butterfly: the
// fields sit at positions 0-4 and 8-12 of 16, and at each step (lane
// offsets 16, 8, 4, 2) a lane keeps the half of its positions that its
// lane bit selects and adds its partner's values of them; the last step
// (offset 1) adds the two partial sums of each position. 13 shuffles where
// NF warp-sum trees take 50. Each sum adds the same operand pairs in the
// same grouping as a tree of __shfl_down_sync by 16, 8, 4, 2 and 1 read in
// lane 0; only the order of the two operands of an addition can differ,
// which IEEE addition ignores, so it equals that tree's sum bit for bit.
// Lane wl ends with the sum of field bfly_field(wl).
__device__ __forceinline__ float warp_sum_fields(const float (&v)[NF], int wl) {
  const bool h16 = wl & 16, h8 = wl & 8, h4 = wl & 4, h2 = wl & 2;
  float y[5];  // positions (h16 ? 8 : 0) + j; positions 5-7 and 13-15 are empty
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    y[j] = (h16 ? v[j + 5] : v[j]) + __shfl_xor_sync(FULL, h16 ? v[j] : v[j + 5], 16);
  }
  float z[4];  // positions (h16 ? 8 : 0) + (h8 ? 4 : 0) + j
  z[0] = (h8 ? y[4] : y[0]) + __shfl_xor_sync(FULL, h8 ? y[0] : y[4], 8);
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    z[j] = (h8 ? 0.0f : y[j]) + __shfl_xor_sync(FULL, h8 ? y[j] : 0.0f, 8);
  }
  float u[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    u[j] = (h4 ? z[j + 2] : z[j]) + __shfl_xor_sync(FULL, h4 ? z[j] : z[j + 2], 4);
  }
  const float t = (h2 ? u[1] : u[0]) + __shfl_xor_sync(FULL, h2 ? u[0] : u[1], 2);
  return t + __shfl_xor_sync(FULL, t, 1);
}

// The field whose warp sum warp_sum_fields leaves in lane wl: one even lane
// per field; -1 for odd lanes and empty positions.
__device__ __forceinline__ int bfly_field(int wl) {
  const int r = (wl >> 1) & 7;
  return ((wl & 1) == 0 && r < 5) ? r + ((wl & 16) ? 5 : 0) : -1;
}

}  // namespace lvdgs
