// LZ match pass kernels for Hopper (sm_90a).
//
// Bit-exact with kanzi_tpu/ops/lz.py (lz_match_pass, match_pass_np) and
// the port's plain versions (ops/lz.py): for every position i of a block
// of n bytes, its bucket under the reference LZX hash
// (src/transform/LZCodec.hpp: ((LE64(src + i) << 24) * 0x1E35A7BD) >>
// (64 - hashLog)), the latest earlier position in the same bucket, and
// the common prefix of the block at the two, capped at kCap = 32 bytes.
// The block comes zero-padded (ops/lz.py pad_block: at least kCap + 8
// zero bytes, its length a multiple of 8 and one more word), as
// kanzi_tpu's _match_fn pads it: the last 7 positions hash windows that
// run into the zeros, and a prefix may run past n into them. Each launcher
// takes the caller's CUDA stream, launches, and returns
// cudaGetLastError(). Outputs are allocated by the caller.
//
// K1. lz_hash     <- kanzi_tpu/ops/lz.py _hash32_jnp (:58) and the keys
//     of _match_fn's sort (:80-86): XLA, no Pallas kernel; the hash in
//     32-bit limbs, which the card does not need.
// K2. lz_prev_lcp <- kanzi_tpu/ops/lz.py _match_fn (:87-104): the
//     previous item of the sorted order in the same bucket, scattered to
//     its position, and CAP shifted byte compares (32 gathers of the
//     block).
// Between them the caller sorts K1's keys (torch.sort): a key is bucket
// << 32 | position, unique, so the sorted order is _match_fn's stable
// order by (bucket, position).
//
// What bounds K: bytes. K1 reads the block once and writes 8 bytes a
// position; K2 reads the sorted keys (each twice, the second time from
// L1) and windows of the block at two positions, and writes 8 bytes a
// position. A window is two aligned 8-byte loads and a funnel shift; a
// prefix is at most 4 window compares, the first differing byte found
// by the lowest set bit of the XOR (the windows are little-endian). K2's
// block loads are gathers at the sorted order's positions, which the
// card's L2 (50 MB) holds for a block of a few MiB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned long long kSeed = 0x1E35A7BDull;
constexpr int kCap = 32;
constexpr int kThreads = 256;

// The little-endian 8-byte window at byte i of the padded block: two
// aligned loads, the upper one shifted in (by 1 and 63 - s, so that s = 0
// takes nothing of it, with no branch).
__device__ __forceinline__ unsigned long long window(
    const unsigned long long* __restrict__ pad, long long i) {
  const long long q = i >> 3;
  const int s = (int)(i & 7) * 8;
  const unsigned long long lo = __ldg(pad + q);
  const unsigned long long hi = __ldg(pad + q + 1);
  return (lo >> s) | ((hi << 1) << (63 - s));
}

__global__ void __launch_bounds__(kThreads)
lz_hash_kernel(const unsigned long long* __restrict__ pad, long long n,
               int shift, long long* __restrict__ keys) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const unsigned long long h = ((window(pad, i) << 24) * kSeed) >> shift;
  keys[i] = (long long)((h << 32) | (unsigned long long)i);
}

__global__ void __launch_bounds__(kThreads)
lz_prev_lcp_kernel(const unsigned long long* __restrict__ pad,
                   const long long* __restrict__ keys, long long n,
                   int32_t* __restrict__ prev, int32_t* __restrict__ lcp) {
  const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  const unsigned long long key = (unsigned long long)keys[k];
  const long long pos = (long long)(key & 0xFFFFFFFFull);
  int32_t p = -1;
  int32_t len = 0;
  if (k > 0) {
    const unsigned long long before = (unsigned long long)keys[k - 1];
    if ((before >> 32) == (key >> 32)) {
      p = (int32_t)(before & 0xFFFFFFFFull);
      len = kCap;
#pragma unroll
      for (int t = 0; t < kCap; t += 8) {
        const unsigned long long x = window(pad, pos + t) ^ window(pad, p + t);
        if (x) {
          len = t + ((__ffsll((long long)x) - 1) >> 3);
          break;
        }
      }
    }
  }
  prev[pos] = p;
  lcp[pos] = len;
}

}  // namespace

extern "C" {

const char* kanzi_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K1: keys [n] int64 = bucket << 32 | position, from the padded block
// (8-byte aligned). hash_log in [1, 31].
int lz_hash(const void* pad, long long n, int hash_log, void* keys,
            int device, void* stream) {
  cudaSetDevice(device);
  if (n < 0 || n >= (1ll << 31) || hash_log < 1 || hash_log > 31)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    lz_hash_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned long long*)pad, n, 64 - hash_log, (long long*)keys);
  }
  return (int)cudaGetLastError();
}

// K2: prev [n], lcp [n] int32 by position, from K1's keys sorted and the
// padded block.
int lz_prev_lcp(const void* pad, const void* keys, long long n, void* prev,
                void* lcp, int device, void* stream) {
  cudaSetDevice(device);
  if (n < 0 || n >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    lz_prev_lcp_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned long long*)pad, (const long long*)keys, n,
        (int32_t*)prev, (int32_t*)lcp);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
