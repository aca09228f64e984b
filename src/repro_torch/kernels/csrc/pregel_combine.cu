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
// no pad slots (pad vertices are rows with no edges), so there is no mask.
//
// Bound on this card: bytes.  Per call a kernel must read row_ptr
// (8 B/row), dst (4 B/edge), the send vector, the optional seed and (K4)
// the values and valid rows, and write the (rows,) outputs.  The send
// gather (send[dst[e]], 4 B per edge from a random row) is the access that
// cannot coalesce; at 4 M vertices the send vector (16.8 MB) fits in the
// 50 MB L2, so the gather is served mostly from L2 and the stream of dst
// sets the time -- if enough of it is in flight.
//
// K3 (reduce_group_kernel) is built for bytes in flight: a warp owns 32
// consecutive rows, reads their row_ptr with one coalesced load, streams
// their one contiguous dst range 256 entries a batch with 16-byte loads
// (eight consecutive entries a lane), starts all eight gathers before
// folding any, folds each lane's entries by row in edge order and merges
// the rows that cross lanes with a segmented warp scan, and stores the 32
// results with one coalesced store.  A hub row longer than a batch is
// folded batch by batch by its warp.  One warp per row (the first design,
// which K4 keeps in reduce_row) had one ~30-entry row of dst in flight
// per warp and a chain of dependent loads per row.
//
// Determinism: the sum uses no floating-point atomics.  K3 folds a lane's
// entries in order, the lanes by a fixed scan tree, and the batches in
// order; K4 folds each lane's edges (e = row start + lane, + 32, ...) in
// order and its shuffle tree is fixed.  So a row's sum has the same bits
// on every launch.  It rounds in another order than the reference's
// scatter, which the tests allow for.  The min is order-free and so
// bit-exact.  Built with -fmad=false, so base + damping * acc rounds
// twice, as the reference's does.
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

// K4's fold of row v's messages (one warp per row), seeded by init[v]
// when init is given.  Every lane returns; only lane 0's value is the
// row's.  K3 no longer uses it (reduce_group_kernel below).
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

// K3: one warp per group of kWarp consecutive rows.  The group's edges
// [gs, ge) are one contiguous range of dst; the warp streams it in
// batches of kBatch edges, lane j holding the kPer consecutive edges
// b + kPer j .. (16-byte loads where four lie inside the range and are
// aligned, else masked 4-byte loads).  All kPer gathers send[dst[e]] are
// started before any is folded.  Then:
//   1. each lane folds its edges in order into runs of equal row; a run
//      that starts and ends inside the lane (a whole short row) is folded
//      into the row's shared accumulator at once -- no other lane holds
//      that row in this batch;
//   2. the lanes' last runs are combined by a segmented inclusive scan
//      over the lanes (5 shuffle steps), a segment being a row that
//      continues from lane to lane;
//   3. the lane where a row's run ends in this batch folds the run's
//      total into the row's accumulator: exactly one lane per (row,
//      batch), so no atomics and a fixed order.
// A row longer than a batch (a hub) spans several batches and is folded
// batch by batch in edge order by the same warp.  At the end lane r
// writes row r's result: one coalesced store per group.
constexpr int kPer = 8;   // consecutive edges a lane holds (4 and 16: slower)
constexpr int kBatch = kPer * kWarp;
constexpr int kReduceWarps = 8;

template <class M>
__global__ void __launch_bounds__(kReduceWarps * kWarp)
reduce_group_kernel(const long long* __restrict__ row_ptr,
                    const int* __restrict__ dst,
                    const typename M::T* __restrict__ send,
                    const typename M::T* __restrict__ init,
                    typename M::T* __restrict__ out, int rows, int bias) {
  using T = typename M::T;
  __shared__ long long s_off[kReduceWarps][kWarp + 1];
  __shared__ T s_acc[kReduceWarps][kWarp];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  long long* off = s_off[warp];
  T* acc = s_acc[warp];
  const int groups = (rows + kWarp - 1) / kWarp;
  for (int g = blockIdx.x * kReduceWarps + warp; g < groups;
       g += gridDim.x * kReduceWarps) {
    const int base = g * kWarp;
    const int n = min(kWarp, rows - base);
    // row_ptr[base .. base + n], one coalesced load; lanes past the
    // group's last row see empty rows at its end
    const long long lo = row_ptr[base + min(lane, n)];
    const long long hi = row_ptr[base + min(lane + 1, n)];
    if (lane == 0) off[0] = lo;
    off[lane + 1] = hi;
    acc[lane] = M::identity();
    const long long gs = __shfl_sync(kFull, lo, 0);
    const long long ge = __shfl_sync(kFull, hi, kWarp - 1);
    __syncwarp();
    for (long long b = gs & ~3LL; b < ge; b += kBatch) {
      const long long e0 = b + kPer * lane;
      int dv[kPer];
#pragma unroll
      for (int j = 0; j < kPer; j += 4) {
        const int4 d = csr::load4(dst, e0 + j, gs, ge, -1);
        dv[j] = d.x;
        dv[j + 1] = d.y;
        dv[j + 2] = d.z;
        dv[j + 3] = d.w;
      }
      T msg[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q)
        msg[q] = dv[q] >= 0 ? M::message(__ldg(send + dv[q]), bias)
                            : M::identity();
      // 1. runs of equal row inside the lane, in edge order
      int head = -1, tail = -1;        // rows of the first and last run
      T head_val = M::identity(), run = M::identity();
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        if (dv[q] < 0) continue;
        const long long e = e0 + q;
        int r = tail < 0 ? csr::row_of(off, n, e) : tail;
        while (off[r + 1] <= e) ++r;
        if (r != tail) {
          if (tail >= 0) {
            if (head == tail) head_val = run;          // the first run
            else acc[tail] = M::fold(acc[tail], run);  // a whole row
          }
          if (head < 0) head = r;
          tail = r;
          run = msg[q];
        } else {
          run = M::fold(run, msg[q]);
        }
      }
      const bool single = head == tail;  // one run (or no edge at all)
      // 2. segmented inclusive scan of the last runs across lanes: a
      //    single-run lane continues the previous lane's last row
      const int prev_tail = __shfl_up_sync(kFull, tail, 1);
      bool flag = lane == 0 || head < 0 || !single || prev_tail != head;
      T carry = run;
#pragma unroll
      for (int d2 = 1; d2 < kWarp; d2 *= 2) {
        const T pv = __shfl_up_sync(kFull, carry, d2);
        const bool pf = __shfl_up_sync(kFull, static_cast<int>(flag), d2);
        if (lane >= d2) {
          if (!flag) carry = M::fold(pv, carry);
          flag = flag || pf;
        }
      }
      // 3. the lane where a row's run ends folds it in
      const T carry_in = __shfl_up_sync(kFull, carry, 1);
      const int next_head = __shfl_down_sync(kFull, head, 1);
      const bool joins = lane > 0 && head >= 0 && prev_tail == head;
      const bool continues = lane < kWarp - 1 && tail >= 0 &&
                             next_head == tail;
      if (head >= 0 && !single) {
        const T h = joins ? M::fold(carry_in, head_val) : head_val;
        acc[head] = M::fold(acc[head], h);
      }
      if (tail >= 0 && !continues) acc[tail] = M::fold(acc[tail], carry);
      __syncwarp();
    }
    if (lane < n) {
      const T a = acc[lane];
      out[base + lane] = init != nullptr ? M::fold(init[base + lane], a) : a;
    }
    __syncwarp();
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
  const int threads = kReduceWarps * kWarp;
  const int groups = (rows + kWarp - 1) / kWarp;
  const int grid = csr::grid_for(reduce_group_kernel<M>, groups, threads, 0,
                                 kReduceWarps);
  using T = typename M::T;
  reduce_group_kernel<M><<<grid, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
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
