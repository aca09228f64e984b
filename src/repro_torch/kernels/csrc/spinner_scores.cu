// Spinner's ComputeScores and fused vertex update over a CSR, for sm_90a.
//
// Replaces the TPU kernels in src/repro/kernels/spinner_scores.py:
//   spinner_scores_csr         <- _kernel / spinner_scores_pallas (K2): the
//                                 dense (V, k) score matrix s[v, l] =
//                                 sum_{u in N(v)} w(v, u) [label(u) = l].
//   fused_update_csr           <- _fused_kernel / fused_update_pallas (K1),
//                                 base form: the same reduction, then the
//                                 Eq. 7-8 proposal in the epilogue; only
//                                 (V,) vectors and the (k,) M(l) partial
//                                 reach device memory.
//   fused_update_seeded_csr    <- the same kernel with has_init / acc_init
//                                 (K1's overlap seed, passed by the sharded
//                                 engine's overlap schedule): the warp's
//                                 score row starts from a (V, k) f32
//                                 interior partial (what spinner_scores_csr
//                                 wrote over the interior segment) instead
//                                 of 0, then folds the frontier segment's
//                                 edges.  The TPU tiles both segments
//                                 against one shared row permutation so the
//                                 partial lines up with its accumulator;
//                                 CSR rows line up by construction.
//   fused_update_frontier_csr  <- the same kernel with has_act / tile_act
//                                 (K1's frontier variant): rows outside the
//                                 (V,) real & active mask skip their edges
//                                 and noise row and write the no-op
//                                 proposal best = label, tb = tc = 0; M(l)
//                                 counts active rows only.  The TPU skips
//                                 whole tiles with no active vertex; here
//                                 the skip is per row (one warp per row),
//                                 which gives the same want, the same M(l)
//                                 and, on active rows, the same outputs.
// The TPU kernels turn the scatter into one-hot x one-hot MXU products over
// a tiled, degree-permuted edge layout because the TPU has no atomics.
// Hopper has fast shared-memory atomics, so these kernels read the CSR as
// it is: one warp per vertex row, lanes striding over the row's edges with
// coalesced dst/w loads, one gathered label per edge, and an atomicAdd into
// a k-float slice of shared memory owned by the warp.  Every form reads a
// neighbour's label from `lookup` and a row's own label from `labels`: one
// array at one device, two on a shard (the rank's label shard, and the
// exchange plan's lookup that dst indexes).  K1's forms also
// fold a second, optional CSR segment (d_row_ptr / d_dst / d_w, null when
// absent): the session's on-device delta of appended entries, parallel
// edges carrying weight changes.
//
// Bound on this card: bytes.  Per call the kernels must read row_ptr
// (8 B/vertex), dst and w (8 B/edge), the labels, and -- for the fused one
// -- the (V, k) f32 tie noise, and write (V, k) f32 scores or three (V,)
// vectors; the seeded form reads the (V, k) f32 partial too, so on a shard
// the interior K2 pass plus the seeded K1 pass move the partial twice more
// than one K1 pass over the whole shard would.  The frontier variant must
// read the (V,) mask, labels and three outputs for every row but row_ptr,
// edges, degree and noise only for the active rows.  The label gather (lookup[dst[e]], 4 B per edge from a
// random row) is the access that cannot coalesce; at the main path's 4 M
// vertices the label vector (16.8 MB) fits in the 50 MB L2.  The design
// keeps the score row in shared memory so the fused kernel never writes
// the (V, k) matrix, and flushes M(l) once per block.
//
// Exactness: the Eq. 3 weights are 1 or 2, so every score sum is an exact
// integer in f32 and any order of atomics gives the same bits as the
// scatter-add reference.  The epilogue keeps the reference's association,
// total = s / max(deg, 1) - pen and x = (total + noise) + bonus, with IEEE
// division and no contraction (built with -fmad=false, never fast-math),
// and the argmax takes the FIRST maximum as jnp.argmax / torch.argmax do.
// M(l) sums integer degrees (or ones) below 2^24, so its atomics are exact.
//
// Each C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>

#include "csr_launch.cuh"

namespace {

using csr::kFull;
using csr::kWarp;

// s[v, :] += over the row's edges, into the warp's shared slice `acc`.
// Weight-0 entries (bucket padding) are skipped: they add nothing.
__device__ __forceinline__ void accumulate_row(
    const long long* __restrict__ row_ptr, const int* __restrict__ dst,
    const float* __restrict__ w, const int* __restrict__ lookup, float* acc,
    int v, int lane) {
  const long long end = row_ptr[v + 1];
  for (long long e = row_ptr[v] + lane; e < end; e += kWarp) {
    const float we = w[e];
    if (we != 0.0f) atomicAdd(&acc[lookup[dst[e]]], we);
  }
}

__global__ void spinner_scores_kernel(
    const long long* __restrict__ row_ptr, const int* __restrict__ dst,
    const float* __restrict__ w, const int* __restrict__ lookup,
    float* __restrict__ out, int num_vertices, int k) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  float* acc = smem + warp * k;
  for (int v = blockIdx.x * warps + warp; v < num_vertices;
       v += gridDim.x * warps) {
    for (int l = lane; l < k; l += kWarp) acc[l] = 0.0f;
    __syncwarp();
    accumulate_row(row_ptr, dst, w, lookup, acc, v, lane);
    __syncwarp();
    float* row = out + static_cast<size_t>(v) * k;
    for (int l = lane; l < k; l += kWarp) row[l] = acc[l];
    __syncwarp();
  }
}

__device__ __forceinline__ float eq8_total(float s, float denom, float pen) {
  return __fsub_rn(__fdiv_rn(s, denom), pen);
}

// kFrontier: `active` is the (V,) real & active mask (1 byte a row); rows
// outside it write the no-op proposal.  Otherwise rows >= num_real are
// padding, left out of M(l) (on a shard the caller passes the shard's real
// row count, the global count less the shard's offset, clamped to [0, V]).
// kSeeded: `acc_init` is the (V, k) partial the score row starts from
// (a template flag, so the other forms carry no seed branch or register).
template <bool kFrontier, bool kSeeded>
__global__ void fused_update_kernel(
    const long long* __restrict__ row_ptr, const int* __restrict__ dst,
    const float* __restrict__ w, const long long* __restrict__ d_row_ptr,
    const int* __restrict__ d_dst, const float* __restrict__ d_w,
    const int* __restrict__ labels, const int* __restrict__ lookup,
    const float* __restrict__ acc_init, const float* __restrict__ deg_w,
    const float* __restrict__ pen, const float* __restrict__ noise,
    const unsigned char* __restrict__ active, int* __restrict__ best_out,
    float* __restrict__ tot_best_out, float* __restrict__ tot_cur_out,
    float* __restrict__ m_out, int num_vertices, int num_real, int k,
    float bonus, int degree_weighted) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  float* m_block = smem;                  // (k,) this block's M(l) partial
  float* acc = smem + k + warp * k;       // (k,) this warp's score row
  for (int l = threadIdx.x; l < k; l += blockDim.x) m_block[l] = 0.0f;
  __syncthreads();

  for (int v = blockIdx.x * warps + warp; v < num_vertices;
       v += gridDim.x * warps) {
    const int cur = labels[v];
    if (kFrontier && !active[v]) {
      // the whole warp skips the row: no edge, degree or noise read
      if (lane == 0) {
        best_out[v] = cur;
        tot_best_out[v] = 0.0f;
        tot_cur_out[v] = 0.0f;
      }
      continue;
    }
    if (kSeeded) {
      const float* seed = acc_init + static_cast<size_t>(v) * k;
      for (int l = lane; l < k; l += kWarp) acc[l] = seed[l];
    } else {
      for (int l = lane; l < k; l += kWarp) acc[l] = 0.0f;
    }
    __syncwarp();
    accumulate_row(row_ptr, dst, w, lookup, acc, v, lane);
    if (d_row_ptr != nullptr)
      accumulate_row(d_row_ptr, d_dst, d_w, lookup, acc, v, lane);
    __syncwarp();

    // Eq. 7-8: each lane scans its columns in increasing order, keeping
    // the first maximum of x = (total + noise) + bonus * [l == label].
    const float deg = deg_w[v];
    const float denom = fmaxf(deg, 1.0f);
    const float* nrow = noise + static_cast<size_t>(v) * k;
    float bval = -CUDART_INF_F;
    int bidx = INT_MAX;
    for (int l = lane; l < k; l += kWarp) {
      const float x = __fadd_rn(__fadd_rn(eq8_total(acc[l], denom, pen[l]),
                                          nrow[l]),
                                l == cur ? bonus : 0.0f);
      if (x > bval) {
        bval = x;
        bidx = l;
      }
    }
    // Warp argmax: larger value wins, equal values go to the smaller
    // column -- a total order, so every lane ends on the first maximum.
    for (int off = kWarp / 2; off > 0; off /= 2) {
      const float ov = __shfl_xor_sync(kFull, bval, off);
      const int oi = __shfl_xor_sync(kFull, bidx, off);
      if (ov > bval || (ov == bval && oi < bidx)) {
        bval = ov;
        bidx = oi;
      }
    }
    if (lane == 0) {
      best_out[v] = bidx;
      tot_best_out[v] = eq8_total(acc[bidx], denom, pen[bidx]);
      tot_cur_out[v] = eq8_total(acc[cur], denom, pen[cur]);
      // a frontier row that got here is active, hence real
      if ((kFrontier || v < num_real) && bidx != cur)
        atomicAdd(&m_block[bidx], degree_weighted ? deg : 1.0f);
    }
    __syncwarp();   // lane 0 has read acc before the next row zeroes it
  }

  __syncthreads();
  for (int l = threadIdx.x; l < k; l += blockDim.x)
    if (m_block[l] != 0.0f) atomicAdd(&m_out[l], m_block[l]);
}

template <bool kFrontier, bool kSeeded>
int launch_fused(const void* row_ptr, const void* dst, const void* w,
                 const void* d_row_ptr, const void* d_dst, const void* d_w,
                 const void* labels, const void* lookup,
                 const void* acc_init, const void* deg_w, const void* pen,
                 const void* noise, const void* active, void* best,
                 void* tot_best, void* tot_cur, void* m, int num_vertices,
                 int num_real, int k, float bonus, int degree_weighted,
                 int warps, void* stream) {
  const int threads = warps * kWarp;
  const size_t smem = static_cast<size_t>(warps + 1) * k * sizeof(float);
  const int grid = csr::grid_for(fused_update_kernel<kFrontier, kSeeded>,
                                 num_vertices, threads, smem, warps);
  fused_update_kernel<kFrontier, kSeeded><<<grid, threads, smem,
                                            static_cast<cudaStream_t>(
                                                stream)>>>(
      static_cast<const long long*>(row_ptr), static_cast<const int*>(dst),
      static_cast<const float*>(w), static_cast<const long long*>(d_row_ptr),
      static_cast<const int*>(d_dst), static_cast<const float*>(d_w),
      static_cast<const int*>(labels), static_cast<const int*>(lookup),
      static_cast<const float*>(acc_init), static_cast<const float*>(deg_w),
      static_cast<const float*>(pen), static_cast<const float*>(noise),
      static_cast<const unsigned char*>(active), static_cast<int*>(best),
      static_cast<float*>(tot_best), static_cast<float*>(tot_cur),
      static_cast<float*>(m), num_vertices, num_real, k, bonus,
      degree_weighted);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int spinner_scores_csr(const void* row_ptr, const void* dst,
                                  const void* w, const void* lookup,
                                  void* out, int num_vertices, int k,
                                  int warps, void* stream) {
  const int threads = warps * kWarp;
  const size_t smem = static_cast<size_t>(warps) * k * sizeof(float);
  const int grid = csr::grid_for(spinner_scores_kernel, num_vertices,
                                 threads, smem, warps);
  spinner_scores_kernel<<<grid, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(row_ptr), static_cast<const int*>(dst),
      static_cast<const float*>(w), static_cast<const int*>(lookup),
      static_cast<float*>(out), num_vertices, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_update_csr(const void* row_ptr, const void* dst,
                                const void* w, const void* d_row_ptr,
                                const void* d_dst, const void* d_w,
                                const void* labels, const void* lookup,
                                const void* deg_w, const void* pen,
                                const void* noise, void* best,
                                void* tot_best, void* tot_cur, void* m,
                                int num_vertices, int num_real, int k,
                                float bonus, int degree_weighted, int warps,
                                void* stream) {
  return launch_fused<false, false>(
      row_ptr, dst, w, d_row_ptr, d_dst, d_w, labels, lookup, nullptr,
      deg_w, pen, noise, nullptr, best, tot_best, tot_cur, m, num_vertices,
      num_real, k, bonus, degree_weighted, warps, stream);
}

extern "C" int fused_update_seeded_csr(
    const void* row_ptr, const void* dst, const void* w, const void* labels,
    const void* lookup, const void* acc_init, const void* deg_w,
    const void* pen, const void* noise, void* best, void* tot_best,
    void* tot_cur, void* m, int num_vertices, int num_real, int k,
    float bonus, int degree_weighted, int warps, void* stream) {
  return launch_fused<false, true>(
      row_ptr, dst, w, nullptr, nullptr, nullptr, labels, lookup, acc_init,
      deg_w, pen, noise, nullptr, best, tot_best, tot_cur, m, num_vertices,
      num_real, k, bonus, degree_weighted, warps, stream);
}

extern "C" int fused_update_frontier_csr(
    const void* row_ptr, const void* dst, const void* w,
    const void* d_row_ptr, const void* d_dst, const void* d_w,
    const void* labels, const void* lookup, const void* deg_w,
    const void* pen, const void* noise, const void* active, void* best,
    void* tot_best, void* tot_cur, void* m, int num_vertices, int k,
    float bonus, int degree_weighted, int warps, void* stream) {
  return launch_fused<true, false>(
      row_ptr, dst, w, d_row_ptr, d_dst, d_w, labels, lookup, nullptr,
      deg_w, pen, noise, active, best, tot_best, tot_cur, m, num_vertices,
      num_vertices, k, bonus, degree_weighted, warps, stream);
}
