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
// Both kernels run on one row-group kernel (reduce_group_kernel), built
// for bytes in flight: a warp owns 32 consecutive rows, reads their
// row_ptr with one coalesced load, streams their one contiguous dst range
// 256 entries a batch with 16-byte loads (eight consecutive entries a
// lane), starts all eight gathers before folding any, folds each lane's
// entries by row in edge order and merges the rows that cross lanes with a
// segmented warp scan, and ends with a lane per row.  A hub row longer
// than a batch is folded batch by batch by its warp; a group with no
// entries reads no dst and no send.  The kernel is a template over its
// epilogue: K3's writes init + acc (or acc) with one coalesced store; K4's
// reads the group's valid, values (min) and init rows with one coalesced
// load each -- issued when the group starts, before its entries stream --
// then applies the vertex update and writes new and chg with one coalesced
// store each.  So over the single-device empty frontier K4 is one pass
// over (rows,) vectors, not a chain of dependent loads per row.
//
// Determinism: the sum uses no floating-point atomics.  The kernel folds a
// lane's entries in order, the lanes by a fixed scan tree, and the batches
// in order, so a row's sum has the same bits on every launch.  It rounds
// in another order than the reference's scatter, which the tests allow
// for.  The min is order-free and so bit-exact.  Built with -fmad=false,
// so base + damping * acc rounds twice, as the reference's does.
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

// The epilogues.  load(v, in) runs when the group starts, a lane per row
// (in: the row exists), and returns what the lane keeps until the end;
// store(v, row, acc) then writes row v's result from the folded acc.
// K3: out = init + acc (init: the optional seed).
template <class M>
struct ReduceEpilogue {
  using T = typename M::T;
  struct Row {};
  const T* __restrict__ init;
  T* __restrict__ out;
  __device__ __forceinline__ Row load(int, bool) const { return Row{}; }
  __device__ __forceinline__ void store(int v, Row, T acc) const {
    out[v] = init != nullptr ? M::fold(init[v], acc) : acc;
  }
};

// K4: the vertex update after the seeded fold.
//   sum:  new = valid ? base + damping * acc : 0,   chg = valid
//   min:  new = valid ? min(values, acc) : values,  chg = valid && new != values
template <class M>
struct CombineEpilogue {
  using T = typename M::T;
  static constexpr bool kMin = std::is_same<M, MinI32>::value;
  struct Row {
    T seed, old;
    bool ok;
  };
  const T* __restrict__ init;
  const T* __restrict__ values;   // read by the min form only
  const bool* __restrict__ valid;
  T* __restrict__ new_out;
  bool* __restrict__ chg_out;
  float base, damping;
  __device__ __forceinline__ Row load(int v, bool in) const {
    Row r{M::identity(), T(), false};
    if (in) {
      r.ok = valid[v];
      if (init != nullptr) r.seed = init[v];
      if constexpr (kMin) r.old = values[v];
    }
    return r;
  }
  __device__ __forceinline__ void store(int v, Row r, T part) const {
    const T acc = init != nullptr ? M::fold(r.seed, part) : part;
    if constexpr (kMin) {
      const int now = r.ok ? min(r.old, acc) : r.old;
      new_out[v] = now;
      chg_out[v] = r.ok && now != r.old;
    } else {
      new_out[v] = r.ok ? __fadd_rn(base, __fmul_rn(damping, acc)) : 0.0f;
      chg_out[v] = r.ok;
    }
  }
};

// One warp per group of kWarp consecutive rows.  The group's edges
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
// hands row r's fold to the epilogue E.
constexpr int kPer = 8;   // consecutive edges a lane holds (4 and 16: slower)
constexpr int kBatch = kPer * kWarp;
constexpr int kReduceWarps = 8;

template <class M, class E>
__global__ void __launch_bounds__(kReduceWarps * kWarp)
reduce_group_kernel(const long long* __restrict__ row_ptr,
                    const int* __restrict__ dst,
                    const typename M::T* __restrict__ send, E epi, int rows,
                    int bias) {
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
    const typename E::Row mine = epi.load(base + lane, lane < n);
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
    for (long long b = gs & ~3LL; gs < ge && b < ge; b += kBatch) {
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
    if (lane < n) epi.store(base + lane, mine, acc[lane]);
    __syncwarp();
  }
}

template <class M, class E>
int launch_groups(const void* row_ptr, const void* dst, const void* send,
                  E epi, int rows, int bias, void* stream) {
  const int threads = kReduceWarps * kWarp;
  const int groups = (rows + kWarp - 1) / kWarp;
  const int grid = csr::grid_for(reduce_group_kernel<M, E>, groups, threads,
                                 0, kReduceWarps);
  reduce_group_kernel<M, E><<<grid, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(row_ptr), static_cast<const int*>(dst),
      static_cast<const typename M::T*>(send), epi, rows, bias);
  return static_cast<int>(cudaGetLastError());
}

template <class M>
int launch_reduce(const void* row_ptr, const void* dst, const void* send,
                  const void* init, void* out, int rows, int bias,
                  void* stream) {
  using T = typename M::T;
  const ReduceEpilogue<M> epi{static_cast<const T*>(init),
                              static_cast<T*>(out)};
  return launch_groups<M>(row_ptr, dst, send, epi, rows, bias, stream);
}

template <class M>
int launch_combine(const void* row_ptr, const void* dst, const void* send,
                   const void* values, const void* valid, const void* init,
                   void* new_out, void* chg_out, int rows, int bias,
                   float base, float damping, void* stream) {
  using T = typename M::T;
  const CombineEpilogue<M> epi{
      static_cast<const T*>(init), static_cast<const T*>(values),
      static_cast<const bool*>(valid), static_cast<T*>(new_out),
      static_cast<bool*>(chg_out), base, damping};
  return launch_groups<M>(row_ptr, dst, send, epi, rows, bias, stream);
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
