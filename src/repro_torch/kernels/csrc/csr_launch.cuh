// Launch helpers shared by the CSR kernels (one warp per vertex row).
#pragma once

#include <cuda_runtime.h>

namespace csr {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// Enough blocks to fill every SM, no more: the kernels' grid-stride loops
// take the remaining rows (and a kernel that flushes a per-block partial
// flushes it once per block).
template <typename Kernel>
int grid_for(Kernel kernel, int num_rows, int threads, size_t smem,
             int warps) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  const long long need = (static_cast<long long>(num_rows) + warps - 1) /
                         warps;
  const long long cap =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(need < cap ? need : cap);
}

}  // namespace csr
