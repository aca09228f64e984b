// Pregel message combine over a CSR, for sm_90a.
//
// Replaces the TPU kernels in src/repro/kernels/pregel_combine.py:
//   pregel_reduce_*_csr   <- _reduce_kernel / pregel_reduce_pallas (K3): per
//                            row v, the sum (f32) of send[dst[e]] or the
//                            min (int32) of send[dst[e]] + bias over v's
//                            edges, seeded by acc_init[v] when given, else
//                            the identity (0 or INF_I32 = 2^30).
//   pregel_combine_*_csr  <- _fused_kernel / pregel_combine_pallas (K4): the
//                            same reduce (seeded by the interior partial),
//                            then the vertex update in the same warp:
//                              sum:  new = valid ? base + damping*acc : 0,
//                                    chg = valid
//                              min:  new = valid ? min(values, acc) : values,
//                                    chg = valid && new != values
// The TPU kernels fold pre-gathered messages per (tile, chunk) with a
// one-hot MXU product (sum) or a masked min over a tiled layout whose pad
// slots carry a weight mask of 0.  Here the CSR is read as it is and holds
// no pad slots (pad vertices are rows with no edges), so there is no mask:
// one warp per vertex row, lanes striding over the row's edges with
// coalesced dst loads, one gathered send value per edge, and a shuffle
// tree that folds the row's 32 lane partials.
//
// Bound on this card: bytes.  Per call a kernel must read row_ptr
// (8 B/row), dst (4 B/edge), the send vector, the optional seed and (K4)
// the values and valid rows, and write the (rows,) outputs.  The send
// gather (send[dst[e]], 4 B per edge from a random row) is the access that
// cannot coalesce; at 4 M vertices the send vector (16.8 MB) fits in the
// 50 MB L2, so the gather is served mostly from L2 and the streaming reads
// of dst set the time.  The design streams dst once, in order, and keeps
// every row's sum in registers: no shared memory, no atomics, and nothing
// but the (rows,) results written.
//
// Determinism: the sum uses no floating-point atomics.  Each lane adds its
// edges (e = row start + lane, + 32, ...) in order and the shuffle tree is
// fixed, so a row's sum has the same bits on every launch.  It rounds in
// another order than the reference's scatter, which the tests allow for.
// The min is order-free and so bit-exact.  Built with -fmad=false, so
// base + damping * acc rounds twice, as the reference's does.
//
// Each C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>

#include <type_traits>

#include "csr_launch.cuh"

namespace {

using csr::kFull;
using csr::kWarp;

constexpr int kInfI32 = 1 << 30;   // the "unreached" sentinel, 2**30

struct SumF32 {
  using T = float;
  static __device__ __forceinline__ T identity() { return 0.0f; }
  static __device__ __forceinline__ T message(T x, int) { return x; }
  static __device__ __forceinline__ T fold(T a, T b) {
    return __fadd_rn(a, b);
  }
};

struct MinI32 {
  using T = int;
  static __device__ __forceinline__ T identity() { return kInfI32; }
  // INF + bias stays below 2^31 because the sentinel is 2^30
  static __device__ __forceinline__ T message(T x, int bias) {
    return x + bias;
  }
  static __device__ __forceinline__ T fold(T a, T b) { return min(a, b); }
};

// The fold of row v's messages, seeded by init[v] when init is given.
// Every lane returns; only lane 0's value is the row's.
template <class M>
__device__ __forceinline__ typename M::T reduce_row(
    const long long* __restrict__ row_ptr, const int* __restrict__ dst,
    const typename M::T* __restrict__ send,
    const typename M::T* __restrict__ init, int bias, int v, int lane) {
  typename M::T acc = M::identity();
  const long long end = row_ptr[v + 1];
  for (long long e = row_ptr[v] + lane; e < end; e += kWarp)
    acc = M::fold(acc, M::message(send[dst[e]], bias));
  for (int off = kWarp / 2; off > 0; off /= 2)
    acc = M::fold(acc, __shfl_down_sync(kFull, acc, off));
  return init != nullptr ? M::fold(init[v], acc) : acc;
}

template <class M>
__global__ void reduce_kernel(const long long* __restrict__ row_ptr,
                              const int* __restrict__ dst,
                              const typename M::T* __restrict__ send,
                              const typename M::T* __restrict__ init,
                              typename M::T* __restrict__ out, int rows,
                              int bias) {
  const int lane = threadIdx.x % kWarp;
  const int warps = blockDim.x / kWarp;
  for (int v = blockIdx.x * warps + threadIdx.x / kWarp; v < rows;
       v += gridDim.x * warps) {
    const typename M::T acc = reduce_row<M>(row_ptr, dst, send, init, bias,
                                            v, lane);
    if (lane == 0) out[v] = acc;
  }
}

template <class M>
__global__ void combine_kernel(const long long* __restrict__ row_ptr,
                               const int* __restrict__ dst,
                               const typename M::T* __restrict__ send,
                               const typename M::T* __restrict__ values,
                               const bool* __restrict__ valid,
                               const typename M::T* __restrict__ init,
                               typename M::T* __restrict__ new_out,
                               bool* __restrict__ chg_out, int rows, int bias,
                               float base, float damping) {
  const int lane = threadIdx.x % kWarp;
  const int warps = blockDim.x / kWarp;
  for (int v = blockIdx.x * warps + threadIdx.x / kWarp; v < rows;
       v += gridDim.x * warps) {
    const typename M::T acc = reduce_row<M>(row_ptr, dst, send, init, bias,
                                            v, lane);
    if (lane != 0) continue;
    const bool ok = valid[v];
    if constexpr (std::is_same<M, SumF32>::value) {
      new_out[v] = ok ? __fadd_rn(base, __fmul_rn(damping, acc)) : 0.0f;
      chg_out[v] = ok;
    } else {
      const int old = values[v];
      const int now = ok ? min(old, acc) : old;
      new_out[v] = now;
      chg_out[v] = ok && now != old;
    }
  }
}

constexpr int kWarpsPerBlock = 8;

template <class M>
int launch_reduce(const void* row_ptr, const void* dst, const void* send,
                  const void* init, void* out, int rows, int bias,
                  void* stream) {
  const int threads = kWarpsPerBlock * kWarp;
  const int grid = csr::grid_for(reduce_kernel<M>, rows, threads, 0,
                                 kWarpsPerBlock);
  using T = typename M::T;
  reduce_kernel<M><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(row_ptr), static_cast<const int*>(dst),
      static_cast<const T*>(send), static_cast<const T*>(init),
      static_cast<T*>(out), rows, bias);
  return static_cast<int>(cudaGetLastError());
}

template <class M>
int launch_combine(const void* row_ptr, const void* dst, const void* send,
                   const void* values, const void* valid, const void* init,
                   void* new_out, void* chg_out, int rows, int bias,
                   float base, float damping, void* stream) {
  const int threads = kWarpsPerBlock * kWarp;
  const int grid = csr::grid_for(combine_kernel<M>, rows, threads, 0,
                                 kWarpsPerBlock);
  using T = typename M::T;
  combine_kernel<M><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(row_ptr), static_cast<const int*>(dst),
      static_cast<const T*>(send), static_cast<const T*>(values),
      static_cast<const bool*>(valid), static_cast<const T*>(init),
      static_cast<T*>(new_out), static_cast<bool*>(chg_out), rows, bias, base,
      damping);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `init` may be null (no seed); the sum forms ignore `bias` (PageRank's is 0).
extern "C" int pregel_reduce_sum_csr(const void* row_ptr, const void* dst,
                                     const void* send, const void* init,
                                     void* out, int rows, int bias,
                                     void* stream) {
  return launch_reduce<SumF32>(row_ptr, dst, send, init, out, rows, bias,
                               stream);
}

extern "C" int pregel_reduce_min_csr(const void* row_ptr, const void* dst,
                                     const void* send, const void* init,
                                     void* out, int rows, int bias,
                                     void* stream) {
  return launch_reduce<MinI32>(row_ptr, dst, send, init, out, rows, bias,
                               stream);
}

// `values` is read by the min form only.
extern "C" int pregel_combine_sum_csr(const void* row_ptr, const void* dst,
                                      const void* send, const void* values,
                                      const void* valid, const void* init,
                                      void* new_out, void* chg_out, int rows,
                                      int bias, float base, float damping,
                                      void* stream) {
  return launch_combine<SumF32>(row_ptr, dst, send, values, valid, init,
                                new_out, chg_out, rows, bias, base, damping,
                                stream);
}

extern "C" int pregel_combine_min_csr(const void* row_ptr, const void* dst,
                                      const void* send, const void* values,
                                      const void* valid, const void* init,
                                      void* new_out, void* chg_out, int rows,
                                      int bias, float base, float damping,
                                      void* stream) {
  return launch_combine<MinI32>(row_ptr, dst, send, values, valid, init,
                                new_out, chg_out, rows, bias, base, damping,
                                stream);
}
