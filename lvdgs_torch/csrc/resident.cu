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
// dependent round trips per slot. R2: one cooperative launch of a
// persistent grid (one wave: every block resident at once) zeroes the
// table with 16-byte stores, meets at a grid-wide barrier, then adds the
// updates one quarter row (slot, 4 fields) per thread turn: one 16-byte
// read-only load and one red.global.add.v4.f32 (PTX ISA 8.1, sm_90), 1.89 M
// vector reductions at the probe's shapes where the first design issued
// 7.57 M scalar atomicAdds. The first lane of each four loads the slot's
// index and hands it to the other three with a shuffle; each thread issues
// the loads of SPT quarter rows, SB apart, before its first add. The
// Pallas kernel accumulates in grid order (g, k, tg), the atomics in any
// order, so sums over a row's duplicates differ in the last bits from run
// to run.
//
// What bounds them on the H100: bytes. The bound counts each distinct row
// once (the 8 MB table at 2^17 rows, read from device memory), the indices
// and the output: 0.0030 ms for R1, 0.0121 ms for R2, which writes the
// table and reads 30 MB of updates. Neither does more than one add per byte
// moved. R1 reads its 473088 rows of 64 bytes (30 MB) with no reuse, so the
// rows come from L2 rather than device memory and L2's rate is its floor
// in practice. R2's table (8.4 MB) stays in L2, where its reductions
// resolve. Measured on an H100 80GB HBM3 at 700 W (the probe's shapes;
// PERF.md): R1 bit for bit, 0.0099-0.0101 ms a call from a CUDA graph;
// launched one by one from Python it measured 0.0112-0.0210 ms, the host's
// launch time included. R2 from a CUDA graph: the first design (zero kernel, then one scalar
// atomicAdd per field) 0.0245 ms, its zero pass 0.0037 and its scatter
// pass 0.0205; the vector reductions in two launches 0.0232 (scatter
// 0.0187: the L2's reduction rate, not the count of atomic instructions,
// holds the pass); this single launch 0.0203-0.0208.

#include <cooperative_groups.h>
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

constexpr int SB = 256;  // threads per scatter block
constexpr int SPT = 8;   // quarter rows per thread, all loaded before the first add

// out[row .. row + 4) += v, one vector reduction in L2 (sm_90)
__device__ __forceinline__ void red_add_v4(float* out, float4 v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(out), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}

// A persistent grid of one wave (cooperative launch): zero out[0 .. n4)
// as float4, meet at a grid-wide barrier (where n4 > 0), then add the nq
// quarter rows. Quarter row q = 4 * slot + c holds fields 4c .. 4c + 3 of
// the slot's row; a block's turn b takes q in [b * SB * SPT,
// (b + 1) * SB * SPT), thread t the SPT quarters t + j * SB. SB is a
// multiple of 4, so a slot's four quarters sit in four neighbouring lanes
// of one warp, the first on a lane that is a multiple of 4, and are all in
// range or all past nq.
__global__ void __launch_bounds__(SB)
resident_scatter_kernel(const int* __restrict__ idx, const float4* __restrict__ upd,
                        float* __restrict__ out, size_t n4, size_t nq) {
  float4* out4 = reinterpret_cast<float4*>(out);
  for (size_t i = blockIdx.x * (size_t)SB + threadIdx.x; i < n4; i += (size_t)gridDim.x * SB) {
    out4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if (n4 > 0) cooperative_groups::this_grid().sync();
  const int c = threadIdx.x & 3;
  const int src = (threadIdx.x & 31) & ~3;  // the slot's first lane
  for (size_t b = blockIdx.x; b * (SB * SPT) < nq; b += gridDim.x) {
    const size_t q0 = b * (SB * SPT) + threadIdx.x;
    int row[SPT];
    float4 v[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const size_t q = q0 + (size_t)j * SB;
      const bool in = q < nq;
      row[j] = in && c == 0 ? __ldg(idx + q / 4) : 0;
      v[j] = in ? __ldg(upd + q) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int j = 0; j < SPT; ++j) row[j] = __shfl_sync(0xffffffffu, row[j], src);
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      if (q0 + (size_t)j * SB < nq) red_add_v4(out + (size_t)row[j] * NF + c * 4, v[j]);
    }
  }
}

// The scatter kernel's grid on the current device: as many blocks as can
// be resident at once, which a cooperative launch needs (cached per device).
int scatter_grid(int* grid) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, resident_scatter_kernel, SB, 0);
    }
    if (e != cudaSuccess) return (int)e;
    cached[dev] = sms * per_sm;
  }
  *grid = cached[dev];
  return 0;
}

int launch_scatter(const int* idx, const float* upd, float* out, size_t n4, size_t nq,
                   void* stream) {
  if (n4 == 0 && nq == 0) return 0;
  int grid = 0;
  const int err = scatter_grid(&grid);
  if (err != 0) return err;
  const float4* upd4 = reinterpret_cast<const float4*>(upd);
  void* args[] = {(void*)&idx, (void*)&upd4, (void*)&out, (void*)&n4, (void*)&nq};
  return (int)cudaLaunchCooperativeKernel((const void*)resident_scatter_kernel, grid, SB, args, 0,
                                          (cudaStream_t)stream);
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

// out (rows, 16): zeroed, then out[idx[s]] += upd[s] for every slot s, in
// one launch; with G = 0 the zero pass alone. upd and out 16-byte aligned.
int lvdgs_resident_scatter(const int* idx, const float* upd, float* out, int G, int K, int TG,
                           int rows, void* stream) {
  return launch_scatter(idx, upd, out, (size_t)rows * (NF / 4), (size_t)G * K * TG * (NF / 4),
                        stream);
}

// out += the updates, without zeroing: the scatter pass of
// lvdgs_resident_scatter alone (no grid barrier).
int lvdgs_resident_scatter_add(const int* idx, const float* upd, float* out, int G, int K, int TG,
                               int rows, void* stream) {
  (void)rows;
  return launch_scatter(idx, upd, out, 0, (size_t)G * K * TG * (NF / 4), stream);
}

// lvdgs::kernel_attrs of this library's kernel k.
int lvdgs_resident_attrs(int k, const char** name, int* out) {
  const lvdgs::KernelInfo table[] = {LVDGS_KERNEL(32, resident_gather_kernel),
                                     LVDGS_KERNEL(SB, resident_scatter_kernel)};
  return lvdgs::kernel_attrs(table, sizeof(table) / sizeof(table[0]), k, name, out);
}

}  // extern "C"
