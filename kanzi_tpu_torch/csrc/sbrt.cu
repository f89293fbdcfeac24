// SBRT (MTF / RANK / TIMESTAMP) forward and inverse kernel for Hopper
// (sm_90a).
//
// Byte-exact with kanzi_tpu/ops/sbrt.py and the reference transform
// (src/transform/SBRT.cpp:22-145): per byte i of symbol c, qc = ((i & m1)
// + (p[c] & m2)) >> shift; c moves to rank 1 + the largest rank j below
// its own whose symbol has q > qc (0 if none), the ranks in between move
// up one, p[c] = i and q[c] = qc. The forward emits c's old rank, the
// inverse reads a rank and emits the symbol that holds it. Bytes past a
// block's length pass through. The launcher takes the caller's CUDA
// stream, launches, and returns cudaGetLastError(). Outputs are allocated
// by the caller.
//
// sbrt <- kanzi_tpu/ops/sbrt.py _sbrt_kernel (:33): 16 blocks a grid
//    cell on the VPU's [16, 256] vregs, in 2048-byte windows of
//    big-endian words, one-hot compares and a 128-lane split gather for
//    every lookup.
//
// One warp per block, its whole automaton in registers. Lane k holds
// ranks 8k..8k+7: for each, the symbol there with its q (packed as q << 8
// | symbol; q < the block length < 2^24) and its p. A step needs no
// shared memory: the lane holding c (forward) or rank r (inverse) hands
// over the other one and p[c] through __reduce_or_sync; each lane offers
// 1 + its largest rank below r with q > qc, and __reduce_max_sync gives
// the new rank; the move of ranks [new, r) up one is a __shfl_up_sync of
// each lane's top entry plus in-lane selects. So a step costs the same
// whatever the distance c moves (the host loop walks it rank by rank).
//
// Bound: the dependent chain of one step per byte in each block (two
// warp reductions and ~150 instructions between them), not bytes: a 4
// MiB block is a chain of 4M steps, and a launch has one chain per block
// (16 warps on 16 of the 132 SMs for the level-5 chain's 16 blocks). The
// input is read 16 bytes ahead of the chain (one broadcast load for the
// warp), and lane 0 writes each finished 4-byte word.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kPer = 8;          // ranks per lane

// One automaton step of byte i (value x) for the lane owning ranks
// base..base+7; returns the byte to emit (the same in every lane).
template <bool kInverse>
__device__ __forceinline__ uint32_t step(uint32_t x, int i, int base,
                                         int m1, int m2, int shift,
                                         uint32_t (&qs)[kPer],
                                         uint32_t (&pv)[kPer]) {
  uint32_t mine = 0, mine_p = 0;
  uint32_t r, c;
  if (kInverse) {
    r = x;
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      if (base + e == (int)r) { mine = qs[e] & 0xFFu; mine_p = pv[e]; }
    c = __reduce_or_sync(kFull, mine);
  } else {
    c = x;
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      if ((qs[e] & 0xFFu) == c) { mine = base + e; mine_p = pv[e]; }
    r = __reduce_or_sync(kFull, mine);
  }
  const int pc = (int)__reduce_or_sync(kFull, mine_p);
  const uint32_t qc = (uint32_t)(((i & m1) + (pc & m2)) >> shift);
  uint32_t cand = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    if (base + e < (int)r && (qs[e] >> 8) > qc) cand = base + e + 1;
  const int nr = (int)__reduce_max_sync(kFull, cand);
  // ranks nr .. r-1 move up one, c takes rank nr; entry e-1 is read
  // before it is written, and entry 0 takes the lane below's old top
  const uint32_t up_qs = __shfl_up_sync(kFull, qs[kPer - 1], 1);
  const uint32_t up_p = __shfl_up_sync(kFull, pv[kPer - 1], 1);
  const uint32_t new_qs = qc << 8 | c;
#pragma unroll
  for (int e = kPer - 1; e >= 1; --e) {
    const int j = base + e;
    const bool moves = j > nr && j <= (int)r;
    qs[e] = j == nr ? new_qs : moves ? qs[e - 1] : qs[e];
    pv[e] = j == nr ? (uint32_t)i : moves ? pv[e - 1] : pv[e];
  }
  const bool moves0 = base > nr && base <= (int)r;
  qs[0] = base == nr ? new_qs : moves0 ? up_qs : qs[0];
  pv[0] = base == nr ? (uint32_t)i : moves0 ? up_p : pv[0];
  return kInverse ? c : r;
}

template <bool kInverse>
__global__ void __launch_bounds__(32)
sbrt_kernel(const uint8_t* __restrict__ in, const int64_t* __restrict__ lens,
            int64_t ld, int m1, int m2, int shift,
            uint8_t* __restrict__ out) {
  const int base = kPer * (int)threadIdx.x;
  const uint8_t* src = in + (size_t)blockIdx.x * ld;
  uint32_t* dst = reinterpret_cast<uint32_t*>(out + (size_t)blockIdx.x * ld);
  const int len = (int)lens[blockIdx.x];
  uint32_t qs[kPer], pv[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    qs[e] = (uint32_t)(base + e);      // q = 0, symbol = rank
    pv[e] = 0;
  }
  uint4 nxt = __ldg(reinterpret_cast<const uint4*>(src));
  for (int64_t off = 0; off < ld; off += 16) {
    const uint4 cur = nxt;
    if (off + 16 < ld)
      nxt = __ldg(reinterpret_cast<const uint4*>(src + off + 16));
    for (int k = 0; k < 4; ++k) {
      const uint32_t w = k == 0 ? cur.x : k == 1 ? cur.y : k == 2 ? cur.z
                                                                  : cur.w;
      uint32_t o = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = (int)off + 4 * k + b;
        const uint32_t x = (w >> (8 * b)) & 0xFFu;
        const uint32_t v =
            i < len ? step<kInverse>(x, i, base, m1, m2, shift, qs, pv) : x;
        o |= v << (8 * b);
      }
      if (threadIdx.x == 0) dst[(off >> 2) + k] = o;
    }
  }
}

}  // namespace

extern "C" {

const char* kanzi_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int sbrt(const void* in, const void* lens, int n_blocks, int64_t ld, int m1,
         int m2, int shift, int inverse, void* out, int device,
         void* stream) {
  cudaSetDevice(device);
  if (ld % 16 != 0 || ld >= (1 << 24) || n_blocks < 0)
    return (int)cudaErrorInvalidValue;
  if (n_blocks > 0 && ld > 0) {
    auto kern = inverse ? sbrt_kernel<true> : sbrt_kernel<false>;
    kern<<<n_blocks, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)in, (const int64_t*)lens, ld, m1, m2, shift,
        (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
