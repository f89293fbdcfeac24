// FPAQ binary arithmetic encode kernel for Hopper (sm_90a).
//
// Bit-exact with kanzi_tpu/ops/fpaq.py and the reference coder
// (src/entropy/FPAQEncoder.{cpp,hpp}): 56-bit low/high, probs[4][256] of
// 16-bit P(bit = 1) in four banks picked by the previous byte >> 6, the
// bank reset to probs[0] at every FPAQ chunk start, one 32-bit flush
// whenever the top 32 bits of low and high agree. The launcher takes the
// caller's CUDA stream, launches, and returns cudaGetLastError(). Outputs
// are allocated by the caller.
//
// G. fpaq_encode <- kanzi_tpu/ops/fpaq.py _fpaq_encode_kernel (:286):
//    up to 64 streams in lockstep on 8 of the VPU's lanes, 28-bit limbs,
//    the probability tables as masked one-hot slabs and a butterfly
//    compaction of each 512-byte window's flushes.
//
// One thread per stream. Its probs[4][256] live in shared memory as u16
// (2 KiB a stream; the streams per block come from the 227 KB budget),
// low/high are uint64_t: ((high - low) >> 8) * p < 2^48 * 2^16, so the
// range split is exact without limbs, and both probability updates are
// p - (p >> 6) + 1023 * bit. Flush words go to the stream's own region
// of the output in order (no compaction pass); the caller sizes the
// region, and a stream that emits more words than it holds counts them
// all but writes only those that fit (the caller then launches it again
// with a larger region). At the end of each 512-byte window the thread
// writes the window's word count and low | MASK_0_24, which the
// container's chunk framing reads.
//
// Bound: the dependent chain of 8 bit steps per input byte in each
// stream (64-bit subtract, shift, multiply, add, the flush test), not
// bytes: a 4 MiB stream is a chain of 32M steps, and a launch has only as
// many chains as the writer's batch has FPAQ blocks. The design keeps
// everything else off the chain: the next 16 input bytes are loaded while
// the current 16 are coded, the table lookups depend only on the data and
// earlier updates, and the flush is branch-free (a predicated store and
// selects), so the streams of a warp never diverge and no bit step waits
// on a branch. The branch it replaces cost about a quarter of each bit
// step on the card; the tables' layout did not matter there (PERF.md:
// an interleaved layout without bank conflicts was slower).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWinB = 512;
constexpr uint64_t kMask24 = (1ull << 24) - 1;
constexpr uint64_t kMask32 = (1ull << 32) - 1;
constexpr uint64_t kMask56 = (1ull << 56) - 1;
constexpr int kProbs = 4 * 256;
constexpr int kSmemBudget = 227 * 1024;
// streams per block: as many 2 KiB tables as the budget holds, in warps
constexpr int kMaxStreamsPerBlock =
    (kSmemBudget / (kProbs * 2)) / 32 * 32;

struct Coder {
  uint64_t low;
  uint64_t high;
  int64_t cnt;
};

// *addr = v where pred holds, without a branch
__device__ __forceinline__ void store_if(bool pred, uint32_t* addr,
                                         uint32_t v) {
  asm volatile("{\n .reg .pred q;\n setp.ne.u32 q, %0, 0;\n"
               " @q st.global.u32 [%1], %2;\n}"
               :: "r"((uint32_t)pred), "l"(addr), "r"(v));
}

__device__ __forceinline__ void encode_byte(uint32_t val,
                                            uint16_t* __restrict__ bank,
                                            Coder& c,
                                            uint32_t* __restrict__ dst,
                                            int64_t cap) {
#pragma unroll
  for (int sh = 7; sh >= 0; --sh) {
    const uint32_t ctx = (val | 256u) >> (sh + 1);
    const uint32_t p = bank[ctx];
    const uint32_t bit = (val >> sh) & 1u;
    const uint64_t t = (((c.high - c.low) >> 8) * p) >> 8;
    if (bit) {
      c.high = c.low + t;
    } else {
      c.low = c.low + t + 1;
    }
    bank[ctx] = (uint16_t)(p - (p >> 6) + 1023u * bit);
    const bool flush = ((c.low ^ c.high) >> 24) == 0;
    store_if(flush && c.cnt < cap, dst + c.cnt, (uint32_t)(c.high >> 24));
    c.cnt += flush;
    const uint64_t low = (c.low & kMask24) << 32;
    const uint64_t high = ((c.high & kMask24) << 32) | kMask32;
    c.low = flush ? low : c.low;
    c.high = flush ? high : c.high;
  }
}

__global__ void fpaq_encode_kernel(const uint8_t* __restrict__ streams,
                                   const int64_t* __restrict__ lens,
                                   int n_streams, int64_t lp, int chunk_win,
                                   int64_t cap, uint32_t* __restrict__ words,
                                   int32_t* __restrict__ win_cnt,
                                   int64_t* __restrict__ win_low) {
  extern __shared__ uint16_t s_probs[];
  uint16_t* probs = s_probs + (size_t)threadIdx.x * kProbs;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_streams) return;
  for (int i = 0; i < kProbs; ++i) probs[i] = 1u << 15;
  const int64_t len = lens[s];
  const uint8_t* src = streams + (size_t)s * lp;
  const int64_t n_win = lp / kWinB;
  uint32_t* dst = words + (size_t)s * cap;
  Coder c{0, kMask56, 0};
  uint32_t prev = 0;
  for (int64_t w = 0; w < n_win; ++w) {
    if (w % chunk_win == 0) prev = 0;            // FPAQ chunk start
    const int64_t start = w * kWinB;
    const int64_t cnt0 = c.cnt;
    const int64_t rem = len - start;
    const int live = rem <= 0 ? 0 : rem >= kWinB ? kWinB : (int)rem;
    uint4 nxt = live > 0
        ? __ldg(reinterpret_cast<const uint4*>(src + start))
        : make_uint4(0u, 0u, 0u, 0u);
    for (int k = 0; k < live; k += 16) {
      const uint4 cur = nxt;
      if (k + 16 < live)
        nxt = __ldg(reinterpret_cast<const uint4*>(src + start + k + 16));
      const uint32_t wv[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (k + j >= live) break;
        const uint32_t val = (wv[j >> 2] >> (8 * (j & 3))) & 0xFFu;
        encode_byte(val, probs + (prev >> 6) * 256, c, dst, cap);
        prev = val;
      }
    }
    win_cnt[(size_t)s * n_win + w] = (int32_t)(c.cnt - cnt0);
    win_low[(size_t)s * n_win + w] = (int64_t)(c.low | kMask24);
  }
}

}  // namespace

extern "C" {

const char* kanzi_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int fpaq_encode(const void* streams, const void* lens, int n_streams,
                int64_t lp, int chunk_win, int64_t cap, void* words,
                void* win_cnt, void* win_low, int device, void* stream) {
  cudaSetDevice(device);
  if (lp % kWinB != 0 || chunk_win < 1 || cap < 0)
    return (int)cudaErrorInvalidValue;
  if (n_streams > 0) {
    const int whole_warps = (n_streams + 31) / 32 * 32;
    const int per_block = whole_warps < kMaxStreamsPerBlock
                              ? whole_warps : kMaxStreamsPerBlock;
    const int smem = per_block * kProbs * (int)sizeof(uint16_t);
    cudaError_t err = cudaFuncSetAttribute(
        fpaq_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    fpaq_encode_kernel<<<(n_streams + per_block - 1) / per_block, per_block,
                         smem, (cudaStream_t)stream>>>(
        (const uint8_t*)streams, (const int64_t*)lens, n_streams, lp,
        chunk_win, cap, (uint32_t*)words, (int32_t*)win_cnt,
        (int64_t*)win_low);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
