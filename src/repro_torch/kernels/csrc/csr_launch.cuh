// Launch and streaming helpers shared by the CSR kernels.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

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

// v[e .. e + 3] masked to [lo, hi) (`fill` outside): one 16-byte load
// when all four lie inside and are 16-byte aligned, else four 4-byte
// loads, so nothing outside [lo, hi) is read.
template <class T>
__device__ __forceinline__ typename std::conditional<
    sizeof(T) == 4 && std::is_integral<T>::value, int4, float4>::type
load4(const T* __restrict__ v, long long e, long long lo, long long hi,
      T fill) {
  using V = typename std::conditional<
      sizeof(T) == 4 && std::is_integral<T>::value, int4, float4>::type;
  if (e >= lo && e + 3 < hi &&
      (reinterpret_cast<unsigned long long>(v + e) & 15) == 0)
    return __ldg(reinterpret_cast<const V*>(v + e));
  V d;
  d.x = (e >= lo && e < hi) ? __ldg(v + e) : fill;
  d.y = (e + 1 >= lo && e + 1 < hi) ? __ldg(v + e + 1) : fill;
  d.z = (e + 2 >= lo && e + 2 < hi) ? __ldg(v + e + 2) : fill;
  d.w = (e + 3 >= lo && e + 3 < hi) ? __ldg(v + e + 3) : fill;
  return d;
}

// The row (0 .. n - 1, n <= kWarp) of a group holding entry e: the last i
// with off[i] <= e, for off nondecreasing and off[0] <= e < off[n]; so
// empty rows are skipped.
__device__ __forceinline__ int row_of(const long long* off, int n,
                                      long long e) {
  int i = 0;
#pragma unroll
  for (int step = kWarp / 2; step > 0; step >>= 1)
    if (i + step < n && off[i + step] <= e) i += step;
  return i;
}

}  // namespace csr
