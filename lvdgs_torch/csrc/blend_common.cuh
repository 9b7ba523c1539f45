// Device code shared by the dense (blend.cu) and packed (blend_packed.cu)
// tile blend kernels: the constants of the blend, one slot's alpha at one
// pixel, and a warp sum. Every kernel that replays another's transmittance
// chain evaluates slots through eval_slot, so the chains agree bit for bit.
#pragma once

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

// Alpha of one slot (fields p[0..9]) at pixel (px, py).
__device__ __forceinline__ SlotEval eval_slot(const float* p, float px, float py) {
  SlotEval e;
  e.dx = px - p[0];
  e.dy = py - p[1];
  const float power = -0.5f * (p[2] * e.dx * e.dx + p[4] * e.dy * e.dy) - p[3] * e.dx * e.dy;
  e.G = expf(power);
  e.raw = p[9] * e.G;
  e.alpha = (power <= 0.0f && e.raw >= ALPHA_MIN) ? fminf(ALPHA_MAX, e.raw) : 0.0f;
  return e;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace lvdgs
