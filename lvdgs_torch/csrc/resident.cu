// Resident-table probe kernels, for Hopper (sm_90a): per-slot row loads
// from, and row accumulates into, a (rows, 16) float32 field table, at the
// blend kernels' access pattern. Built by lvdgs_torch/ops/rasterizer_cuda.py
// with the blend kernels' flags into its own plain-C shared library, loaded
// with ctypes; the wrappers are in lvdgs_torch/ops/resident_cuda.py.
//
// Replaces, from tools/perf_resident.py (the TPU probe that holds the whole
// table in VMEM):
//   lvdgs_resident_gather  <- gather_kernel  (run_gather's pallas_call)
//   lvdgs_resident_scatter <- scatter_kernel (run_scatter's pallas_call)
//
// Layouts (as the Pallas kernels): idx (G, K, TG) int32 and upd
// (G, K, TG, 16) float32 are flat buffers indexed g, then k, then tg: the
// tool reshapes a (K, T) array to (G, K, TG) without transposing, and the
// port indexes the same flat buffer the same way. Every index lies in
// [0, rows).
//
// Design. R1: one block per group g, one thread per (lane tg, field f);
// each thread walks k = 0..K-1 in order and adds fields[idx[g, k, tg], f]
// to a register sum starting at 0, so the sums are those of the Pallas
// kernel's fori_loop, bit for bit. A warp reads two 64-byte rows per step,
// each whole. R2: zero the table, then one thread per (slot, field) adds
// its update with atomicAdd; the Pallas kernel accumulates in grid order
// (g, k, tg), the atomics in any order, so sums over a row's duplicates
// differ in the last bits from run to run.
//
// What bounds it on the H100: bytes. R1 reads each slot's index and row
// (64 bytes; the 8 MB table at 2^17 rows stays in the 50 MB L2, so each row
// comes from device memory about once) and writes (G * TG, 16); R2 reads
// each slot's index and update and writes the table. Neither does more than
// one add per byte moved.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_attrs.cuh"

namespace {

constexpr int NF = 16;  // fields per row

__global__ void resident_gather_kernel(const int* __restrict__ idx, const float* __restrict__ fields,
                                       float* __restrict__ out, int K, int TG) {
  const int g = blockIdx.x;
  const int tg = threadIdx.x / NF, f = threadIdx.x % NF;
  const int* ix = idx + (size_t)g * K * TG + tg;
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < K; ++k) acc += fields[(size_t)ix[(size_t)k * TG] * NF + f];
  out[((size_t)g * TG + tg) * NF + f] = acc;
}

__global__ void zero_kernel(float* __restrict__ out, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    out[i] = 0.0f;
  }
}

__global__ void resident_scatter_kernel(const int* __restrict__ idx, const float* __restrict__ upd,
                                        float* __restrict__ out, size_t n) {
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;  // flat (slot, field)
  if (i >= n) return;
  atomicAdd(&out[(size_t)idx[i / NF] * NF + (i % NF)], upd[i]);
}

}  // namespace

extern "C" {

// out (G * TG, 16): out[g * TG + tg] = sum over k in order of fields[idx[g, k, tg]].
int lvdgs_resident_gather(const int* idx, const float* fields, float* out, int G, int K, int TG,
                          int rows, void* stream) {
  (void)rows;
  if (G == 0) return 0;
  resident_gather_kernel<<<G, TG * NF, 0, (cudaStream_t)stream>>>(idx, fields, out, K, TG);
  return (int)cudaGetLastError();
}

// out (rows, 16): zeroed, then out[idx[s]] += upd[s] for every slot s.
int lvdgs_resident_scatter(const int* idx, const float* upd, float* out, int G, int K, int TG,
                           int rows, void* stream) {
  const size_t n_out = (size_t)rows * NF;
  zero_kernel<<<(unsigned)((n_out + 255) / 256 < 1024 ? (n_out + 255) / 256 : 1024), 256, 0,
                (cudaStream_t)stream>>>(out, n_out);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const size_t n = (size_t)G * K * TG * NF;
  if (n == 0) return 0;
  resident_scatter_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      idx, upd, out, n);
  return (int)cudaGetLastError();
}

// lvdgs::kernel_attrs of this library's kernel k; the gather at the
// probe's TG = 8 tiles per group.
int lvdgs_resident_attrs(int k, const char** name, int* out) {
  const lvdgs::KernelInfo table[] = {LVDGS_KERNEL(8 * NF, resident_gather_kernel),
                                     LVDGS_KERNEL(256, zero_kernel),
                                     LVDGS_KERNEL(256, resident_scatter_kernel)};
  return lvdgs::kernel_attrs(table, sizeof(table) / sizeof(table[0]), k, name, out);
}

}  // extern "C"
