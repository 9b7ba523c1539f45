// What a kernel of this build holds on the card, for the occupancy line of
// chip_smoke.py: each library lists its kernels once, in one table of
// LVDGS_KERNEL entries, and exports one small C function over that table
// (lvdgs_blend_attrs, lvdgs_packed_attrs, lvdgs_resident_attrs) that calls
// kernel_attrs.
#pragma once

#include <cuda_runtime.h>

namespace lvdgs {

// One kernel: its name as written in the source, its function, and the
// threads per block it is launched with.
struct KernelInfo {
  const char* name;
  const void* fn;
  int threads;
};

// The name is the kernel's own spelling, template arguments included.
#define LVDGS_KERNEL(threads, ...) \
  lvdgs::KernelInfo { #__VA_ARGS__, (const void*)__VA_ARGS__, threads }

// Kernel k of table[0..n): *name, and out[0] registers per thread, out[1]
// local memory per thread in bytes (spills and local arrays), out[2] static
// shared memory per block in bytes, out[3] the most blocks resident on one
// SM at out[4], its threads per block. Returns -1 past the last kernel, else
// a cudaError_t.
inline int kernel_attrs(const KernelInfo* table, int n, int k, const char** name, int* out) {
  if (k < 0 || k >= n) return -1;
  const KernelInfo& info = table[k];
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, info.fn);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, info.fn, info.threads, 0);
  if (e != cudaSuccess) return (int)e;
  *name = info.name;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = blocks;
  out[4] = info.threads;
  return 0;
}

}  // namespace lvdgs
