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
//                                 the skip is per row (a group with no
//                                 active row reads no edge), which gives
//                                 the same want, the same M(l) and, on
//                                 active rows, the same outputs.
// The TPU kernels turn the scatter into one-hot x one-hot MXU products over
// a tiled, degree-permuted edge layout because the TPU has no atomics.
// Hopper has fast shared-memory atomics, so these kernels read the CSR as
// it is and add each edge's weight into a score row in shared memory.
// Every form reads a neighbour's label from `lookup` and a row's own label
// from `labels`: one array at one device, two on a shard (the rank's label
// shard, and the exchange plan's lookup that dst indexes).  K1's forms
// also fold a second, optional CSR segment (d_row_ptr / d_dst / d_w, null
// when absent): the session's on-device delta of appended entries,
// parallel edges carrying weight changes.
//
// Bound on this card: bytes.  Per call the kernels must read row_ptr
// (8 B/vertex), dst and w (8 B/edge), the labels, and -- for the fused one
// -- the (V, k) f32 tie noise, and write (V, k) f32 scores or three (V,)
// vectors; the seeded form reads the (V, k) f32 partial too, so on a shard
// the interior K2 pass plus the seeded K1 pass move the partial twice more
// than one K1 pass over the whole shard would.  The frontier variant must
// read the (V,) mask, labels and three outputs for every row but row_ptr,
// edges, degree and noise only for the active rows.  The label gather
// (lookup[dst[e]], 4 B per edge from a random row) is the access that
// cannot coalesce; at the main path's 4 M vertices the label vector
// (16.8 MB) fits in the 50 MB L2.
//
// Both kernels are built for bytes in flight and for converged labels,
// where one warp per row (their first design) had all 32 lanes add into
// one shared address: a warp owns a group of consecutive rows (see "row
// groups" below), reads their row pointers with one coalesced load,
// streams their one contiguous entry range with 16-byte loads of dst and
// w, four consecutive entries a lane, starts every label gather of a
// batch before adding any, and sums a lane's entries by (row, label)
// before one shared-memory add per run (fold_segment).  K2
// (spinner_scores_kernel) then writes the group's score rows to the
// (V, k) output in order, each store instruction covering 32 consecutive
// floats.  K1 (fused_update_kernel) also copies the group's noise (and
// seed) rows into shared memory with cp.async while the edges stream,
// runs the epilogue a lane per row, and writes best, tot_best and tot_cur
// with one coalesced store each: the score matrix never reaches device
// memory, and M(l) is summed per label across the warp, then flushed once
// per block.
//
// Exactness: the weights are floats and every kernel sums them as floats
// (IEEE adds, no contraction).  A sum of weights that are multiples of a
// power of two (the Eq. 3 weights 1 and 2, or halves) is exact below 2^24
// units in float32, so any order of adds gives the same bits as the
// scatter-add reference; other weights round in the kernels' own order,
// which the tests allow for.  The epilogue keeps the reference's
// association, total = s / max(deg, 1) - pen and x = (total + noise) +
// bonus, with IEEE division and no contraction (built with -fmad=false,
// never fast-math), and the argmax takes the FIRST maximum as jnp.argmax /
// torch.argmax do.  M(l) adds the moving rows' degrees (or ones) of one
// label in lane order, then per block, then per grid.
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

// Eq. 8's total s / max(deg, 1) - pen, IEEE division.  A zero score
// skips the division: 0 / denom is +0 for denom >= 1 (a score starts at
// +0 and adds nonzero weights, so it is never -0), so the total is
// +0 - pen.
__device__ __forceinline__ float eq8_total(float s, float denom, float pen) {
  if (s == 0.0f) return __fsub_rn(0.0f, pen);
  return __fsub_rn(__fdiv_rn(s, denom), pen);
}

// ---- row groups ----------------------------------------------------------
// A warp owns a group of `rows` consecutive rows (1 to 32).  `rows` is a
// launch argument: score_rows(k) / fused_rows<kSeeded>(k) are its caps
// (as many rows as the group's buffers hold, fewer as k grows, down to
// one) and spinner_scores.py's defaults.  Its shared memory holds off
// (33 int64) and the
// group's score rows, each row `ks = k | 1` floats apart (an odd stride,
// so K1's epilogue, a lane per row, hits 32 distinct banks).  K2 holds
// nothing else.  K1 also holds, for the group's selected rows (every row;
// in the frontier form the active ones), the noise rows and in the seeded
// form the seed rows, then beg (32 int64) and sel (32 int); a K1 block
// adds pen and its M(l) partial (k floats each).  spinner_scores.py's
// `scores_layout` and `fused_layout` reckon the same bytes.
constexpr int kUnroll = 4;  // the epilogue's column loop (8: 1% faster,
                            // 72 registers in one form)
constexpr int kPer = 4;                 // consecutive entries a lane holds
constexpr int kGroupBytes = 12672;     // a K1 warp's float buffers, at most
constexpr int kWarpFixedBytes = 656;   // 264 + 256 + 128, rounded to 16
constexpr int kScoreGroupBytes = 8448;  // a K2 warp's score rows, at most
constexpr int kScoreFixedBytes = 272;   // off: 264, rounded to 16
constexpr int kMaxSmem = 232448;       // 227 KB, a block's dynamic limit
constexpr int kStaticSmem = 48 * 1024;  // above it, opt in per kernel

__host__ __device__ inline int row_stride(int k) { return k | 1; }

// K2's cap on rows per group: as many as kScoreGroupBytes holds, 1 to a
// warp
inline int score_rows(int k) {
  const int r = kScoreGroupBytes / (4 * row_stride(k));
  return r < 1 ? 1 : (r > kWarp ? kWarp : r);
}

__host__ __device__ inline int score_warp_bytes(int k, int rows) {
  return kScoreFixedBytes + ((rows * row_stride(k) * 4 + 15) & ~15);
}

template <bool kSeeded>
__host__ __device__ inline int fused_bufs() { return kSeeded ? 3 : 2; }

// K1's cap on rows per group: as many as kGroupBytes holds, between 1
// and a warp
template <bool kSeeded>
inline int fused_rows(int k) {
  const int r = kGroupBytes / (fused_bufs<kSeeded>() * 4 * row_stride(k));
  return r < 1 ? 1 : (r > kWarp ? kWarp : r);
}

template <bool kSeeded>
__host__ __device__ inline int fused_warp_bytes(int k, int rows) {
  const int floats = fused_bufs<kSeeded>() * rows * row_stride(k);
  return kWarpFixedBytes + ((floats * 4 + 15) & ~15);
}

template <bool kSeeded>
inline size_t fused_smem(int k, int warps, int rows) {
  return static_cast<size_t>((2 * k * 4 + 15) & ~15) +
         static_cast<size_t>(warps) * fused_warp_bytes<kSeeded>(k, rows);
}

// A tile the kernels take: at least one warp, 1 to `cap` rows, and a
// block's shared memory within the dynamic limit.
inline bool tile_ok(int warps, int rows, int cap, size_t smem) {
  return warps >= 1 && rows >= 1 && rows <= cap &&
         smem <= static_cast<size_t>(kMaxSmem);
}

__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
               "l"(g) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying rows base + (sel ? sel[i] : i), i < n, of the (V, k) f32
// matrix `src` into buf[i * ks ..] (lanes on consecutive columns).
__device__ __forceinline__ void copy_rows(float* buf,
                                          const float* __restrict__ src,
                                          const int* sel, int base, int n,
                                          int k, int ks, int lane) {
  for (int i = 0; i < n; ++i) {
    const float* row =
        src + static_cast<size_t>(base + (sel != nullptr ? sel[i] : i)) * k;
    for (int j = lane; j < k; j += kWarp) cp_async4(buf + i * ks + j, row + j);
  }
}

// Fold one CSR segment (rp, dst, w) of a group into its score rows
// acc[i * ks + label], i the selected row.  Base form: the group's rows
// own one contiguous entry range [gs, ge), streamed 128 entries a batch,
// lane j holding four consecutive entries (16-byte loads of dst and w).
// Frontier form: only the n selected rows base + sel[i]; their ranges are
// laid end to end (a prefix sum of their lengths in off, their starts in
// beg) and lane j holds four consecutive entries of that virtual stream.
// Every label gather of a batch is started before any is added.  A lane
// sums its own consecutive entries by (row, label) in entry order, as
// floats, and adds each run once, so converged labels cost about one
// shared-memory add per lane and batch, not one per entry.  (Aggregating
// the lanes' last runs as well, by __match_any_sync and __reduce_add_sync,
// measured slower on the H100.)
template <bool kFrontier>
__device__ __forceinline__ void fold_segment(
    const long long* __restrict__ rp, const int* __restrict__ dst,
    const float* __restrict__ w, const int* __restrict__ lookup, float* acc,
    int ks, long long* off, long long* beg, const int* sel, int base, int n,
    int lane) {
  long long gs, ge;
  if (!kFrontier) {
    const long long lo = rp[base + min(lane, n)];
    const long long hi = rp[base + min(lane + 1, n)];
    if (lane == 0) off[0] = lo;
    off[lane + 1] = hi;
    gs = __shfl_sync(kFull, lo, 0);
    ge = __shfl_sync(kFull, hi, kWarp - 1);
  } else {
    long long len = 0, start = 0;
    if (lane < n) {
      const int row = base + sel[lane];
      start = rp[row];
      len = rp[row + 1] - start;
    }
    long long incl = len;   // inclusive prefix sum over the lanes
#pragma unroll
    for (int d = 1; d < kWarp; d *= 2) {
      const long long o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += o;
    }
    if (lane == 0) off[0] = 0;
    off[lane + 1] = incl;      // lanes past n repeat the total
    beg[lane] = start;
    gs = 0;
    ge = __shfl_sync(kFull, incl, kWarp - 1);
  }
  __syncwarp();
  for (long long b = gs & ~3LL; b < ge; b += kPer * kWarp) {
    const long long t0 = b + kPer * lane;
    int d[kPer], r[kPer];
    float we[kPer];
    if (!kFrontier) {
#pragma unroll
      for (int j = 0; j < kPer; j += 4) {
        const int4 d4 = csr::load4(dst, t0 + j, gs, ge, -1);
        const float4 w4 = csr::load4(w, t0 + j, gs, ge, 0.0f);
        d[j] = d4.x; d[j + 1] = d4.y; d[j + 2] = d4.z; d[j + 3] = d4.w;
        we[j] = w4.x; we[j + 1] = w4.y; we[j + 2] = w4.z; we[j + 3] = w4.w;
      }
    }
    int row = -1;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const long long t = t0 + q;
      r[q] = 0;
      if (t >= gs && t < ge) {
        if (row < 0) row = csr::row_of(off, n, t);
        while (off[row + 1] <= t) ++row;
        r[q] = row;
        if (kFrontier) {
          const long long e = beg[row] + (t - off[row]);
          d[q] = __ldg(dst + e);
          we[q] = __ldg(w + e);
        }
      } else if (kFrontier) {
        d[q] = -1;
        we[q] = 0.0f;
      }
    }
    int lab[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      lab[q] = d[q] >= 0 && we[q] != 0.0f ? __ldg(lookup + d[q]) : -1;
    int key = -1;
    float sum = 0.0f;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      if (lab[q] < 0) continue;            // outside the range, or weight 0
      const int kq = r[q] * ks + lab[q];
      if (kq != key) {
        if (key >= 0) atomicAdd(acc + key, sum);
        key = kq;
        sum = 0.0f;
      }
      sum = __fadd_rn(sum, we[q]);
    }
    if (key >= 0) atomicAdd(acc + key, sum);
  }
  __syncwarp();
}

// K2: the dense (V, k) score matrix, a group of `rows` rows a warp
// (grid-stride).  The warp zeroes the group's score rows, folds the
// group's entries into them, then writes them to out[base * k ..], which
// is contiguous: element t of the group (row t / k, column t % k) goes
// from lane t % 32, so each store instruction covers 32 consecutive
// floats.  The (row, column) of a lane's next element is advanced by the
// warp's stride instead of dividing again.
__global__ void spinner_scores_kernel(
    const long long* __restrict__ row_ptr, const int* __restrict__ dst,
    const float* __restrict__ w, const int* __restrict__ lookup,
    float* __restrict__ out, int num_vertices, int k, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  const int ks = row_stride(k);
  unsigned char* mine =
      smem_raw + static_cast<size_t>(warp) * score_warp_bytes(k, rows);
  long long* off = reinterpret_cast<long long*>(mine);          // 33
  float* acc = reinterpret_cast<float*>(mine + kScoreFixedBytes);
  const int step_i = kWarp / k, step_j = kWarp % k;
  const int lane_i = lane / k, lane_j = lane % k;
  const int groups = (num_vertices + rows - 1) / rows;
  for (int g = blockIdx.x * warps + warp; g < groups;
       g += gridDim.x * warps) {
    const int base = g * rows;
    const int n = min(rows, num_vertices - base);
    for (int t = lane; t < n * ks; t += kWarp) acc[t] = 0.0f;
    fold_segment<false>(row_ptr, dst, w, lookup, acc, ks, off, nullptr,
                        nullptr, base, n, lane);
    float* gout = out + static_cast<size_t>(base) * k;
    int i = lane_i, j = lane_j;
    for (int t = lane; t < n * k; t += kWarp) {
      gout[t] = acc[i * ks + j];
      i += step_i;
      j += step_j;
      if (j >= k) {
        j -= k;
        ++i;
      }
    }
    __syncwarp();   // every lane is done with the group's rows
  }
}

// kFrontier: `active` is the (V,) real & active mask (1 byte a row); rows
// outside it write the no-op proposal.  Otherwise rows >= num_real are
// padding, left out of M(l) (on a shard the caller passes the shard's real
// row count, the global count less the shard's offset, clamped to [0, V]).
// kSeeded: `acc_init` is the (V, k) partial the scores start from (a
// template flag, so the other forms carry no seed branch or register).
//
// Groups are taken grid-stride.  For each, the warp reads the group's
// labels (and active bytes: one load and a ballot) with one coalesced
// load, starts the asynchronous copy (cp.async) of the selected rows'
// noise -- and seed -- rows into shared memory, folds the edges while the
// copies run, then gives each selected row a lane for the Eq. 7-8
// epilogue, and writes best, tot_best and tot_cur with one coalesced
// store each.  A group with no active row reads no row pointer, edge,
// degree, noise or seed.
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
    float bonus, int degree_weighted, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  const int ks = row_stride(k);
  float* s_pen = reinterpret_cast<float*>(smem_raw);     // (k,) pen
  float* m_block = s_pen + k;                            // (k,) M(l)
  unsigned char* mine = smem_raw + ((2 * k * 4 + 15) & ~15) +
                        static_cast<size_t>(warp) *
                            fused_warp_bytes<kSeeded>(k, rows);
  long long* off = reinterpret_cast<long long*>(mine);          // 33
  long long* beg = reinterpret_cast<long long*>(mine + 264);    // 32
  int* sel = reinterpret_cast<int*>(mine + 520);                // 32
  float* acc = reinterpret_cast<float*>(mine + kWarpFixedBytes);
  float* nz = acc + rows * ks;
  float* seed = nz + rows * ks;   // the seeded form's third buffer
  for (int l = threadIdx.x; l < k; l += blockDim.x) {
    s_pen[l] = pen[l];
    m_block[l] = 0.0f;
  }
  __syncthreads();

  const int groups = (num_vertices + rows - 1) / rows;
  for (int g = blockIdx.x * warps + warp; g < groups;
       g += gridDim.x * warps) {
    const int base = g * rows;
    const int n = min(rows, num_vertices - base);
    const int cur_lane = lane < n ? labels[base + lane] : 0;
    unsigned mask = n == kWarp ? kFull : (1u << n) - 1u;   // selected rows
    float deg_lane = 0.0f;
    if (kFrontier) {
      const bool act = lane < n && active[base + lane] != 0;
      mask = __ballot_sync(kFull, act);
      if (act) sel[__popc(mask & ((1u << lane) - 1u))] = lane;
      __syncwarp();
    }
    if ((mask >> lane) & 1u) deg_lane = deg_w[base + lane];
    const int n_sel = kFrontier ? __popc(mask) : n;
    int my_best = cur_lane;
    float my_tb = 0.0f, my_tc = 0.0f;
    if (n_sel > 0) {
      const int* rsel = kFrontier ? sel : nullptr;
      copy_rows(nz, noise, rsel, base, n_sel, k, ks, lane);
      if (kSeeded) copy_rows(seed, acc_init, rsel, base, n_sel, k, ks, lane);
      cp_async_commit();
      for (int t = lane; t < n_sel * ks; t += kWarp) acc[t] = 0.0f;
      fold_segment<kFrontier>(row_ptr, dst, w, lookup, acc, ks, off, beg,
                              sel, base, n_sel, lane);
      if (d_row_ptr != nullptr)
        fold_segment<kFrontier>(d_row_ptr, d_dst, d_w, lookup, acc, ks, off,
                                beg, sel, base, n_sel, lane);
      cp_async_wait_all();
      __syncwarp();

      int move = -1;   // this lane's row's M(l) label and mass
      float mass = 0.0f;
      const int li = kFrontier ? sel[lane < n_sel ? lane : 0] : lane;
      const int cur = __shfl_sync(kFull, cur_lane, li);
      const float deg = __shfl_sync(kFull, deg_lane, li);
      // Eq. 7-8, a lane per selected row: scan the columns in increasing
      // order, keeping the first maximum of x = (total + noise) + bonus *
      // [l == label] (the first match, as torch.argmax).
      if (lane < n_sel) {
        const float denom = fmaxf(deg, 1.0f);
        const float* arow = acc + lane * ks;
        const float* nrow = nz + lane * ks;
        const float* srow = seed + lane * ks;
        float bval = -CUDART_INF_F;
        int bidx = INT_MAX;
#pragma unroll kUnroll
        for (int l = 0; l < k; ++l) {
          const float s = kSeeded ? __fadd_rn(srow[l], arow[l]) : arow[l];
          const float x = __fadd_rn(
              __fadd_rn(eq8_total(s, denom, s_pen[l]), nrow[l]),
              l == cur ? bonus : 0.0f);
          if (x > bval) {
            bval = x;
            bidx = l;
          }
        }
        const float sb = kSeeded ? __fadd_rn(srow[bidx], arow[bidx])
                                 : arow[bidx];
        const float sc = kSeeded ? __fadd_rn(srow[cur], arow[cur]) : arow[cur];
        my_best = bidx;
        my_tb = eq8_total(sb, denom, s_pen[bidx]);
        my_tc = eq8_total(sc, denom, s_pen[cur]);
        // a frontier row that got here is active, hence real
        if ((kFrontier || base + li < num_real) && bidx != cur) {
          move = bidx;
          mass = degree_weighted ? deg : 1.0f;
        }
      }
      // M(l): the lowest of the lanes moving to one label adds their
      // masses in lane order (through beg, free after the folds), then
      // makes one shared-memory add per label
      const unsigned same = __match_any_sync(kFull, move);
      float* s_mass = reinterpret_cast<float*>(beg);
      s_mass[lane] = mass;
      __syncwarp();
      if (move >= 0 && lane == __ffs(same) - 1) {
        float total = 0.0f;
        for (unsigned rest = same; rest != 0; rest &= rest - 1)
          total = __fadd_rn(total, s_mass[__ffs(rest) - 1]);
        atomicAdd(&m_block[move], total);
      }
      if (kFrontier) {   // row `lane`'s result sits on lane rank(lane)
        const int rank = __popc(mask & ((1u << lane) - 1u));
        const int b = __shfl_sync(kFull, my_best, rank);
        const float tb = __shfl_sync(kFull, my_tb, rank);
        const float tc = __shfl_sync(kFull, my_tc, rank);
        const bool on = (mask >> lane) & 1u;
        my_best = on ? b : cur_lane;
        my_tb = on ? tb : 0.0f;
        my_tc = on ? tc : 0.0f;
      }
    }
    if (lane < n) {
      best_out[base + lane] = my_best;
      tot_best_out[base + lane] = my_tb;
      tot_cur_out[base + lane] = my_tc;
    }
    __syncwarp();   // every lane is done with the buffers of this group
  }

  __syncthreads();
  for (int l = threadIdx.x; l < k; l += blockDim.x)
    if (m_block[l] != 0.0f) atomicAdd(&m_out[l], m_block[l]);
}

// K1's kernel at a tile: allow its shared memory and size its grid.
// Returns the grid (> 0) or a negated cudaError_t.
template <bool kFrontier, bool kSeeded>
int fused_grid(int num_vertices, int k, int warps, int rows) {
  const size_t smem = fused_smem<kSeeded>(k, warps, rows);
  if (!tile_ok(warps, rows, fused_rows<kSeeded>(k), smem))
    return -static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fused_update_kernel<kFrontier, kSeeded>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  return csr::grid_for(kernel, (num_vertices + rows - 1) / rows,
                       warps * kWarp, smem, warps);
}

// K2's kernel at a tile, as fused_grid.
int scores_grid(int num_vertices, int k, int warps, int rows) {
  const size_t smem = static_cast<size_t>(warps) * score_warp_bytes(k, rows);
  if (!tile_ok(warps, rows, score_rows(k), smem))
    return -static_cast<int>(cudaErrorInvalidValue);
  if (smem > static_cast<size_t>(kStaticSmem)) {
    const cudaError_t err = cudaFuncSetAttribute(
        spinner_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return -static_cast<int>(err);
  }
  return csr::grid_for(spinner_scores_kernel,
                       (num_vertices + rows - 1) / rows, warps * kWarp, smem,
                       warps);
}

template <bool kFrontier, bool kSeeded>
int launch_fused(const void* row_ptr, const void* dst, const void* w,
                 const void* d_row_ptr, const void* d_dst, const void* d_w,
                 const void* labels, const void* lookup,
                 const void* acc_init, const void* deg_w, const void* pen,
                 const void* noise, const void* active, void* best,
                 void* tot_best, void* tot_cur, void* m, int num_vertices,
                 int num_real, int k, float bonus, int degree_weighted,
                 int warps, int rows, void* stream) {
  const int grid = fused_grid<kFrontier, kSeeded>(num_vertices, k, warps,
                                                  rows);
  if (grid < 0) return -grid;
  auto kernel = fused_update_kernel<kFrontier, kSeeded>;
  kernel<<<grid, warps * kWarp, fused_smem<kSeeded>(k, warps, rows),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(row_ptr), static_cast<const int*>(dst),
      static_cast<const float*>(w), static_cast<const long long*>(d_row_ptr),
      static_cast<const int*>(d_dst), static_cast<const float*>(d_w),
      static_cast<const int*>(labels), static_cast<const int*>(lookup),
      static_cast<const float*>(acc_init), static_cast<const float*>(deg_w),
      static_cast<const float*>(pen), static_cast<const float*>(noise),
      static_cast<const unsigned char*>(active), static_cast<int*>(best),
      static_cast<float*>(tot_best), static_cast<float*>(tot_cur),
      static_cast<float*>(m), num_vertices, num_real, k, bonus,
      degree_weighted, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry takes the tile (warps per block, rows per warp group) and
// refuses, with cudaErrorInvalidValue, a tile outside 1 <= rows <= the
// kernel's cap at k, warps >= 1 and the shared-memory limit.

extern "C" int spinner_scores_csr(const void* row_ptr, const void* dst,
                                  const void* w, const void* lookup,
                                  void* out, int num_vertices, int k,
                                  int warps, int rows, void* stream) {
  const int grid = scores_grid(num_vertices, k, warps, rows);
  if (grid < 0) return -grid;
  spinner_scores_kernel<<<grid, warps * kWarp,
                          static_cast<size_t>(warps) *
                              score_warp_bytes(k, rows),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(row_ptr), static_cast<const int*>(dst),
      static_cast<const float*>(w), static_cast<const int*>(lookup),
      static_cast<float*>(out), num_vertices, k, rows);
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
                                int rows, void* stream) {
  return launch_fused<false, false>(
      row_ptr, dst, w, d_row_ptr, d_dst, d_w, labels, lookup, nullptr,
      deg_w, pen, noise, nullptr, best, tot_best, tot_cur, m, num_vertices,
      num_real, k, bonus, degree_weighted, warps, rows, stream);
}

extern "C" int fused_update_seeded_csr(
    const void* row_ptr, const void* dst, const void* w, const void* labels,
    const void* lookup, const void* acc_init, const void* deg_w,
    const void* pen, const void* noise, void* best, void* tot_best,
    void* tot_cur, void* m, int num_vertices, int num_real, int k,
    float bonus, int degree_weighted, int warps, int rows, void* stream) {
  return launch_fused<false, true>(
      row_ptr, dst, w, nullptr, nullptr, nullptr, labels, lookup, acc_init,
      deg_w, pen, noise, nullptr, best, tot_best, tot_cur, m, num_vertices,
      num_real, k, bonus, degree_weighted, warps, rows, stream);
}

extern "C" int fused_update_frontier_csr(
    const void* row_ptr, const void* dst, const void* w,
    const void* d_row_ptr, const void* d_dst, const void* d_w,
    const void* labels, const void* lookup, const void* deg_w,
    const void* pen, const void* noise, const void* active, void* best,
    void* tot_best, void* tot_cur, void* m, int num_vertices, int k,
    float bonus, int degree_weighted, int warps, int rows, void* stream) {
  return launch_fused<true, false>(
      row_ptr, dst, w, d_row_ptr, d_dst, d_w, labels, lookup, nullptr,
      deg_w, pen, noise, active, best, tot_best, tot_cur, m, num_vertices,
      num_vertices, k, bonus, degree_weighted, warps, rows, stream);
}

// The grid a launch of `form` (0: spinner_scores_csr, 1: fused_update_csr,
// 2: fused_update_seeded_csr, 3: fused_update_frontier_csr) would take at
// this tile on the current device, or a negated cudaError_t; launches
// nothing.  The autotuner's model reckons the same grid from the card's
// constants, and chip_smoke.py holds the two equal.
extern "C" int spinner_tile_grid(int form, int num_vertices, int k,
                                 int warps, int rows) {
  switch (form) {
    case 0: return scores_grid(num_vertices, k, warps, rows);
    case 1: return fused_grid<false, false>(num_vertices, k, warps, rows);
    case 2: return fused_grid<false, true>(num_vertices, k, warps, rows);
    case 3: return fused_grid<true, false>(num_vertices, k, warps, rows);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}
