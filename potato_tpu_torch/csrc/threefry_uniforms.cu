// threefry_uniforms: the float32 uniforms of one draw of Threefry-2x32 for
// every lane, in one launch.
//
// Replaces no Pallas kernel. It stands in for what XLA makes of
// potato_tpu/core/rng.py::threefry2x32 and _bits_to_unit_float: one fused
// elementwise kernel. Eager PyTorch has no such fusion: the plain version
// (core/rng.py::uniforms_plain) carries the 32-bit words in int64 tensors
// and masks them after every add and rotate, about 120 kernels a draw.
//
// What bounds it on an H100: neither operations nor bytes at the lane
// counts of the render path. A lane reads its 8-byte ray id (and, with a
// bounce per lane, 8 bytes more) and writes 8 bytes a stream; a stream
// costs about 60 integer operations (13 rounds of add, funnel shift and
// xor, 4 key injections, the float conversion). At 2^15 lanes that is
// well under a microsecond of either, so a launch lasts about as long as
// the card takes to start and drain one: one thread a lane, all words in
// registers, no shared memory, every stream of the draw in the one launch.
//
// Bits: the words are uint32 and wrap as the plain version's masks do;
// ctr0 is the low 32 bits of the ray id, ctr1 the low 32 bits of
// bounce * NUM_STREAMS + stream; the float is ((bits >> 9) | 0x3F800000)
// bit-cast, minus 1. So every uniform equals the plain version's bit for
// bit. The key schedule is the canonical one: an injection after every 4
// rounds, and one after the last round when the count is no multiple of 4.
//
// Inputs a captured CUDA graph can refill: each key word and the bounce are
// read through a pointer when one is given (int64 scalars on the device),
// else taken by value; the bounce may also be one int64 a lane. The launch
// allocates nothing, copies nothing from the host and does not synchronise.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_STREAMS = 2;
constexpr uint32_t PARITY = 0x1BD11BDAu;
// Salts of a bounce: core/rng.py's NUM_STREAMS.
constexpr uint32_t NUM_STREAMS = 8u;

// Rounds 0-3, 8-11, ... rotate by 13 15 26 6; rounds 4-7, 12-15, ... by
// 17 29 16 24.
__host__ __device__ constexpr int rotation(int r) {
  return (r / 4) % 2 == 0
             ? (r % 4 == 0 ? 13 : r % 4 == 1 ? 15 : r % 4 == 2 ? 26 : 6)
             : (r % 4 == 0 ? 17 : r % 4 == 1 ? 29 : r % 4 == 2 ? 16 : 24);
}

template <int ROUNDS>
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& y0, uint32_t& y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ PARITY};
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
  int j = 0;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    x0 += x1;
    x1 = __funnelshift_l(x1, x1, rotation(r));
    x1 ^= x0;
    if (r % 4 == 3 || r == ROUNDS - 1) {
      ++j;
      x0 += ks[j % 3];
      x1 += ks[(j + 1) % 3] + static_cast<uint32_t>(j);
    }
  }
  y0 = x0;
  y1 = x1;
}

__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// out is (2 * n_streams, n): rows 2s and 2s + 1 are the two words of stream
// s. bounce_ptr, when given, holds one bounce (bounce_per_lane 0) or one a
// lane (1); k0_ptr and k1_ptr, when given, one key word each.
template <int ROUNDS>
__global__ void __launch_bounds__(THREADS) threefry_uniforms_kernel(
    const long long* __restrict__ ids, int n, uint32_t k0_value,
    uint32_t k1_value, const long long* __restrict__ k0_ptr,
    const long long* __restrict__ k1_ptr, uint32_t bounce_value,
    const long long* __restrict__ bounce_ptr, int bounce_per_lane,
    int n_streams, uint32_t stream0, uint32_t stream1,
    float* __restrict__ out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const uint32_t k0 = k0_ptr ? static_cast<uint32_t>(*k0_ptr) : k0_value;
  const uint32_t k1 = k1_ptr ? static_cast<uint32_t>(*k1_ptr) : k1_value;
  const uint32_t bounce =
      bounce_ptr ? static_cast<uint32_t>(bounce_ptr[bounce_per_lane ? i : 0])
                 : bounce_value;
  const uint32_t c0 = static_cast<uint32_t>(ids[i]);
  const uint32_t salt = bounce * NUM_STREAMS;
  const size_t row = static_cast<size_t>(n);
#pragma unroll
  for (int s = 0; s < MAX_STREAMS; ++s) {
    if (s < n_streams) {
      uint32_t y0, y1;
      threefry2x32<ROUNDS>(k0, k1, c0, salt + (s == 0 ? stream0 : stream1),
                           y0, y1);
      out[2 * s * row + i] = unit_float(y0);
      out[(2 * s + 1) * row + i] = unit_float(y1);
    }
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError(),
// or cudaErrorInvalidValue for a round count other than 13 or 20, a stream
// count outside [1, MAX_STREAMS] or a negative lane count. No lanes, no
// launch.
extern "C" int threefry_uniforms_launch(
    const long long* ids, int n, int rounds, unsigned int k0_value,
    unsigned int k1_value, const long long* k0_ptr, const long long* k1_ptr,
    unsigned int bounce_value, const long long* bounce_ptr,
    int bounce_per_lane, int n_streams,
    unsigned int stream0, unsigned int stream1, float* out, void* stream) {
  if (n < 0 || n_streams < 1 || n_streams > MAX_STREAMS)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = threefry_uniforms_kernel<13>;
  if (rounds == 20)
    kernel = threefry_uniforms_kernel<20>;
  else if (rounds != 13)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(
      ids, n, k0_value, k1_value, k0_ptr, k1_ptr, bounce_value, bounce_ptr,
      bounce_per_lane, n_streams, stream0, stream1, out);
  return static_cast<int>(cudaGetLastError());
}
