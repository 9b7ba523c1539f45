// Device code shared by the dense (blend.cu) and packed (blend_packed.cu)
// tile blend kernels: the constants of the blend, one slot's alpha at one
// pixel (in float32, and with the weight math in bfloat16), and a warp sum.
// Every kernel that replays another's transmittance chain evaluates slots
// through the same function, so the chains agree bit for bit.
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace lvdgs
