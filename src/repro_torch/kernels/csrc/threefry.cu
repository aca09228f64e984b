// Threefry2x32 uniform draws, for sm_90a.
//
// Replaces no Pallas kernel.  The reference draws every iteration's tie
// noise and migration draws with jax.random.uniform
// (src/repro/core/engine.py:594-596, and the same calls in its frontier
// and sharded steps), whose threefry2x32 runs in XLA on the TPU.  The
// port reproduces those bits (repro_torch/rng.py); its plain version
// builds them from int64 PyTorch elementwise ops, each a launch that
// reads and writes 8-byte temporaries.  This kernel computes the same
// function in registers and writes only the float32 output:
//
//   out[b * n + i] = max(f * span + lo, lo),  rounded after * and after +,
//   f = float((bits >> 9) | 0x3F800000) - 1,  bits = y0 ^ y1,
//   (y0, y1) = threefry2x32(key_b, (c >> 32, c & 0xffffffff)),  c = offset + i,
//
// for nb keys and n outputs a key: rng.py's _bits_to_unit and uniform,
// jax.random.uniform in its partitionable mode.  The counter is 64-bit,
// so a range of counters that crosses 2^32 (a shard's rows of a large
// draw) is exact.
//
// Bound on this card: integer instructions.  An output costs the 20
// rounds of threefry2x32 (an add, a funnel-shift rotate and a xor each),
// five key injections (two adds each, the constants folded into the key
// words once a thread), the counter and the conversion, against 4 bytes
// written.  The adds can all issue as IMAD on the FMA pipe; the 20
// rotates and 20 xors cannot, and the integer ALU pipe, 64 lanes an SM,
// bounds the function at 40 instructions an output.  One Spinner
// iteration at 4 M vertices and k 32 draws 138.4 M outputs: 5.5 G ALU
// instructions, 0.33 ms at 132 SMs x 64 lanes x 1.98 GHz, against
// 0.165 ms to write its 554 MB at 3.35 TB/s.  (This build's loop issues
// 80 instructions an output, 55.5 of them on the ALU pipe: nvcc leaves
// some adds on IADD3, plus the address arithmetic.)  There is no reuse
// and no shared memory: a grid-stride loop over enough blocks to fill
// every SM, four consecutive outputs a thread (four independent chains
// in flight) written as one float4 (ptxas emits two 8-byte stores; the
// stores are not the bound); the few outputs before a row's first 16-byte
// boundary and after its last whole quad are written one by one.
//
// Built with -fmad=false; the multiply and the add are __fmul_rn and
// __fadd_rn in any case, so a draw with minval != 0 rounds twice, as the
// plain version's separate PyTorch ops do.
//
// The C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                 // consecutive outputs a thread
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Four rounds: x0 += x1; x1 = rotl(x1, r) ^ x0.
template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

// The key schedule of one key: ks = (k0, k1, k0 ^ k1 ^ parity); injection
// i (1 to 5) adds ks[i % 3] to x0 and ks[(i + 1) % 3] + i to x1.
struct Schedule {
  uint32_t k0, k1, k2;
  uint32_t a1, a2, a3, a4, a5;   // the x1 words of the five injections

  __device__ __forceinline__ Schedule(uint32_t key0, uint32_t key1)
      : k0(key0), k1(key1), k2(key0 ^ key1 ^ kParity) {
    a1 = k2 + 1u; a2 = k0 + 2u; a3 = k1 + 3u; a4 = k2 + 4u; a5 = k0 + 5u;
  }

  // y0 ^ y1 of threefry2x32 over the counter (c >> 32, c & 0xffffffff)
  __device__ __forceinline__ uint32_t bits(unsigned long long c) const {
    uint32_t x0 = static_cast<uint32_t>(c >> 32) + k0;
    uint32_t x1 = static_cast<uint32_t>(c) + k1;
    rounds<13, 15, 26, 6>(x0, x1);  x0 += k1; x1 += a1;
    rounds<17, 29, 16, 24>(x0, x1); x0 += k2; x1 += a2;
    rounds<13, 15, 26, 6>(x0, x1);  x0 += k0; x1 += a3;
    rounds<17, 29, 16, 24>(x0, x1); x0 += k1; x1 += a4;
    rounds<13, 15, 26, 6>(x0, x1);  x0 += k2; x1 += a5;
    return x0 ^ x1;
  }
};

// 23 random bits under exponent 0, minus 1, scaled and shifted, then
// clamped below at lo as torch.clamp(min=lo) does (a NaN passes through).
__device__ __forceinline__ float to_uniform(uint32_t bits, float lo,
                                            float span) {
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u),
                            1.0f);
  const float x = __fadd_rn(__fmul_rn(f, span), lo);
  return isnan(x) ? x : fmaxf(x, lo);
}

// Row b of the (nb, n) output for b = blockIdx.y, blockIdx.y + gridDim.y,
// ...; the key words come from keys[b * ks0], keys[b * ks0 + ks1] (int64
// words holding uint32 values) or, without keys, from key0 and key1.
__global__ void __launch_bounds__(kThreads)
uniform_kernel(float* __restrict__ out, const long long* __restrict__ keys,
               long long ks0, long long ks1, uint32_t key0, uint32_t key1,
               int nb, long long n, long long offset, float lo, float span) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (int b = blockIdx.y; b < nb; b += gridDim.y) {
    const Schedule ks =
        keys == nullptr
            ? Schedule(key0, key1)
            : Schedule(static_cast<uint32_t>(__ldg(keys + b * ks0)),
                       static_cast<uint32_t>(__ldg(keys + b * ks0 + ks1)));
    float* row = out + static_cast<long long>(b) * n;
    // outputs before the row's first 16-byte boundary (row is 4-aligned)
    long long head =
        ((16 - (reinterpret_cast<unsigned long long>(row) & 15)) & 15) / 4;
    head = head < n ? head : n;
    const long long quads = (n - head) / kPer;
    const unsigned long long c0 =
        static_cast<unsigned long long>(offset + head);
    for (long long q = t; q < quads; q += stride) {
      const unsigned long long c = c0 + kPer * q;
      float4 v;
      v.x = to_uniform(ks.bits(c), lo, span);
      v.y = to_uniform(ks.bits(c + 1), lo, span);
      v.z = to_uniform(ks.bits(c + 2), lo, span);
      v.w = to_uniform(ks.bits(c + 3), lo, span);
      *reinterpret_cast<float4*>(row + head + kPer * q) = v;
    }
    // the head (at most 3) and the tail after the last quad (at most 3)
    if (blockIdx.x == 0 && threadIdx.x < 2 * kPer) {
      const int j = threadIdx.x;
      const long long i = j < kPer ? j : head + kPer * quads + (j - kPer);
      if (j < kPer ? i < head : i < n)
        row[i] = to_uniform(
            ks.bits(static_cast<unsigned long long>(offset + i)), lo, span);
    }
  }
}

}  // namespace

// `keys` is null (the key is key0, key1) or an int64 array of nb key
// pairs, pair b at keys[b * key_stride0] and keys[b * key_stride0 +
// key_stride1].  out holds nb rows of n floats, contiguous.
extern "C" int threefry_uniform(void* out, const void* keys,
                                long long key_stride0, long long key_stride1,
                                unsigned key0, unsigned key1, int nb,
                                long long n, long long offset, float lo,
                                float span, void* stream) {
  if (nb <= 0 || n <= 0) return cudaSuccess;
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, uniform_kernel,
                                                kThreads, 0);
  // enough blocks to fill every SM, shared out over the rows; a row's
  // blocks take its quads by the grid-stride loop
  const int gy = nb < 65535 ? nb : 65535;
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long long want = (n / kPer + kThreads - 1) / kThreads;
  long long gx = cap / gy;
  gx = gx < want ? gx : want;
  gx = gx > 0 ? gx : 1;
  uniform_kernel<<<dim3(static_cast<unsigned>(gx), gy), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<const long long*>(keys),
      key_stride0, key_stride1, key0, key1, nb, n, offset, lo, span);
  return cudaGetLastError();
}
