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
// Design. R1: one warp per two output rows (lanes tg and tg + 1 of group
// g), NF threads per row, one per field: 924 warps at the probe's shapes, 7
// per SM. The sum of each (lane, field) runs in k order from +0, so it is
// the Pallas kernel's fori_loop bit for bit, and nothing but more loads in
// flight can speed it up. The warp stages its lanes' indices in shared
// memory (KS = 512 slots per pass, every load issued before the first
// store), then loads the rows RC = 32 slots at a time into registers, chunk
// c + 1's loads issued before chunk c's values are added: up to 64
// independent loads per thread in flight. No slot past K is read. The first
// design, one 128-thread block per group whose threads loaded an index and
// then the row it names for one slot after another, waited on two
// dependent round trips per slot. R2: zero the table, then one thread per
// (slot, field) adds its update with atomicAdd; the Pallas kernel
// accumulates in grid order (g, k, tg), the atomics in any order, so sums
// over a row's duplicates differ in the last bits from run to run.
//
// What bounds them on the H100: bytes. The bound counts each distinct row
// once (the 8 MB table at 2^17 rows, read from device memory), the indices
// and the output: 0.0030 ms for R1, 0.0121 ms for R2, which writes the
// table and reads 30 MB of updates. Neither does more than one add per byte
// moved. R1 reads its 473088 rows of 64 bytes (30 MB) with no reuse, so the
// rows come from L2 rather than device memory and L2's rate is its floor
// in practice. Measured straight from the library on an H100 80GB HBM3 at
// 700 W (the probe's shapes), bit for bit: the first design 0.0243-0.0252
// ms in every run; this one 0.0112 ms in turns with it in two runs, but
// 0.0113-0.0210 ms (median 0.0166) over eight copies of the same inputs
// at other addresses in a third, timed twice each, while the first design
// held still (PERF.md). Chunks of 16 or 64 slots, chunks without the double
// buffer, and four warps per block measured from 11% faster to 5% slower in
// the same runs. R2 takes 0.0265 ms.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_attrs.cuh"

namespace {

constexpr int NF = 16;  // fields per row
constexpr int LANES = 2;  // output rows per warp (one warp per block): NF threads each
constexpr int RC = 32;    // slots per chunk of row loads in flight
constexpr int KS = 512;   // slots whose indices one pass stages in shared memory

// Start loading field f of the rows that slots [k0, k0 + n) of this
// thread's lane name (their indices in si, n <= RC) into v; v[j] is slot
// k0 + j. Slots past n are not read.
__device__ __forceinline__ void chunk_rows(float (&v)[RC], const int* si, int k0, int n,
                                           const float* __restrict__ fields, int f) {
#pragma unroll
  for (int j = 0; j < RC; ++j) {
    v[j] = j < n ? __ldg(fields + (size_t)si[k0 + j] * NF + f) : 0.0f;
  }
}

__global__ void __launch_bounds__(32)
resident_gather_kernel(const int* __restrict__ idx, const float* __restrict__ fields,
                       float* __restrict__ out, int K, int TG) {
  __shared__ int sidx[LANES][KS + 1];  // padded: the two lanes' reads fall in two banks
  const int parts = (TG + LANES - 1) / LANES;  // warps per group
  const int g = blockIdx.x / parts;
  const int tg0 = (blockIdx.x - g * parts) * LANES;
  const int l = threadIdx.x / NF, f = threadIdx.x % NF;
  const int nl = min(LANES, TG - tg0);  // lanes of this warp (1 where TG is odd)
  const int* ix = idx + (size_t)g * K * TG + tg0;
  const int* si = sidx[min(l, nl - 1)];  // a thread past the last lane repeats it, writes nothing
  float acc = 0.0f;
  for (int s0 = 0; s0 < K; s0 += KS) {
    const int ns = min(KS, K - s0);
    // this pass's indices of the warp's lanes, all loads issued before
    // the first store
    int stage[KS * LANES / 32];
#pragma unroll
    for (int u = 0; u < KS * LANES / 32; ++u) {
      const int i = u * 32 + threadIdx.x, k = i / LANES, li = i % LANES;
      stage[u] = k < ns && li < nl ? __ldg(ix + (size_t)(s0 + k) * TG + li) : 0;
    }
    __syncwarp();  // the previous pass's reads are done
#pragma unroll
    for (int u = 0; u < KS * LANES / 32; ++u) {
      const int i = u * 32 + threadIdx.x;
      sidx[i % LANES][i / LANES] = stage[u];
    }
    __syncwarp();
    // the rows, RC slots at a time: chunk c + 1's loads are in flight while
    // chunk c is added, in slot order
    const int nch = (ns + RC - 1) / RC;
    float v_cur[RC], v_next[RC];
    chunk_rows(v_cur, si, 0, min(RC, ns), fields, f);
    for (int c = 0; c < nch; ++c) {
      chunk_rows(v_next, si, (c + 1) * RC, min(RC, ns - (c + 1) * RC), fields, f);
      const int n = min(RC, ns - c * RC);
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        if (j < n) acc += v_cur[j];
      }
#pragma unroll
      for (int j = 0; j < RC; ++j) v_cur[j] = v_next[j];
    }
  }
  if (l < nl) out[((size_t)g * TG + tg0 + l) * NF + f] = acc;
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
  const unsigned warps = (unsigned)G * (unsigned)((TG + LANES - 1) / LANES);
  resident_gather_kernel<<<warps, 32, 0, (cudaStream_t)stream>>>(idx, fields, out, K, TG);
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

// lvdgs::kernel_attrs of this library's kernel k.
int lvdgs_resident_attrs(int k, const char** name, int* out) {
  const lvdgs::KernelInfo table[] = {LVDGS_KERNEL(32, resident_gather_kernel),
                                     LVDGS_KERNEL(256, zero_kernel),
                                     LVDGS_KERNEL(256, resident_scatter_kernel)};
  return lvdgs::kernel_attrs(table, sizeof(table) / sizeof(table[0]), k, name, out);
}

}  // extern "C"
