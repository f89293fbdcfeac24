// FPAQ lockstep decode kernel for Hopper (sm_90a).
//
// Bit-exact with the port's host decoder (entropy/fpaq.py of the package,
// src/entropy/FPAQDecoder.cpp of the reference) and with kanzi_tpu's
// lockstep decoders (kanzi_tpu/ops/fpaq.py decode_streams_np and
// kanzi_tpu/ops/fpaq_jnp.py decode_batch_jnp) on every stream an encoder
// writes: 56-bit low/high, probs[4][256] of 16-bit P(bit = 1), the bank
// reset to probs[0] at every FPAQ chunk start and the previous byte >> 6
// within a chunk, one 32-bit word shifted into `current` whenever the top
// 32 bits of low and high agree. The launcher takes the caller's CUDA
// stream, launches, and returns cudaGetLastError(). Outputs are allocated
// by the caller.
//
// H. fpaq_decode <- kanzi_tpu/ops/fpaq_jnp.py decode_batch_jnp (:216,
//    _build_decode :147): XLA with no Pallas kernel, b streams in
//    lockstep as [b] vectors, 28-bit limbs, one jitted call per FPAQ
//    chunk index.
//
// What bounds H: the dependent chain of 8 bit steps per output byte in
// each stream. Each step's table index is the bits decoded before it, so
// the lookup, the range split, the compare with `current` and the next
// index are one chain, and a launch has only as many chains as streams.
// This design is the simple one: one block a stream, whose first thread
// decodes the stream's chunks in turn, its 2 KiB table in shared memory
// (the other threads of the warp load and store it), low, high and
// current in 64-bit registers. ((high - low) >> 8) * p is below 2^48 *
// 2^16, exact in 64 bits: no limbs. The payload's global load is off the
// chain: the word the next flush takes is held in a register, and the one
// after it is loaded at the flush that consumes it. A read at or past a
// chunk's word count yields 0, as the host decoder shifts in a zero word
// once fewer than 4 payload bytes are left: a chunk never reads another
// chunk's words, of its stream or of the next.
//
// Inputs (flat, so one launch decodes every chunk of every stream):
// - pay: u32 payload words (the big-endian words of each chunk's bytes
//   after its 7 priming bytes, as values), chunk c's at
//   pay[chunk_off[c] : chunk_off[c] + chunk_nw[c]];
// - chunk_cur[c]: the 56-bit `current` primed from the chunk's first 7
//   bytes;
// - stream s's chunks are first[s], first[s] + 1, ..., one each
//   chunk_bytes output bytes of its lens[s];
// - low/high [b] and probs [b, 1024] (int32 holding u16): the state each
//   stream starts from, overwritten with the state it ends in.
// Outputs: out [b, ld] u8 (bytes past lens[s] untouched); consumed[c]:
// the words chunk c shifted in (its flushes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;
constexpr int kTable = 4 * 256;
constexpr uint64_t kMask32 = 0xFFFFFFFFull;
constexpr uint64_t kMask56 = (1ull << 56) - 1;

__global__ void __launch_bounds__(kThreads)
fpaq_decode_kernel(const uint32_t* __restrict__ pay,
                   const int64_t* __restrict__ chunk_off,
                   const int64_t* __restrict__ chunk_nw,
                   const int64_t* __restrict__ chunk_cur,
                   const int64_t* __restrict__ first,
                   const int64_t* __restrict__ lens, int64_t chunk_bytes,
                   int64_t ld, uint8_t* __restrict__ out,
                   int64_t* __restrict__ consumed,
                   int64_t* __restrict__ low_io,
                   int64_t* __restrict__ high_io,
                   int32_t* __restrict__ probs_io) {
  // the table's loads on the chain are its only 16-bit shared loads: the
  // warp moves it in and out two entries a word
  __shared__ uint32_t probs2[kTable / 2];
  uint16_t* probs = reinterpret_cast<uint16_t*>(probs2);
  const int s = blockIdx.x;
  int32_t* pr = probs_io + (size_t)s * kTable;
  for (int i = threadIdx.x; i < kTable / 2; i += kThreads)
    probs2[i] = ((uint32_t)pr[2 * i] & 0xFFFFu) | ((uint32_t)pr[2 * i + 1]
                                                  << 16);
  __syncthreads();
  if (threadIdx.x == 0) {
    uint64_t low = (uint64_t)low_io[s];
    uint64_t high = (uint64_t)high_io[s];
    const int64_t len = lens[s];
    uint8_t* dst = out + (size_t)s * ld;
    int64_t c = first[s];
    for (int64_t start = 0; start < len; start += chunk_bytes, ++c) {
      const int64_t n = len - start < chunk_bytes ? len - start : chunk_bytes;
      const uint32_t* w = pay + chunk_off[c];
      const int64_t nw = chunk_nw[c];
      uint64_t cur = (uint64_t)chunk_cur[c];
      int64_t widx = 0;
      uint32_t nxt = nw > 0 ? __ldg(w) : 0u;
      uint16_t* p = probs;                      // bank 0 at a chunk start
      for (int64_t i = 0; i < n; ++i) {
        uint32_t ctx = 1;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const uint32_t pv = p[ctx];
          const uint64_t split = low + ((((high - low) >> 8) * pv) >> 8);
          const bool bit = split >= cur;
          high = bit ? split : high;
          low = bit ? low : split + 1;
          p[ctx] = (uint16_t)(pv - (pv >> 6) + (bit ? 1023u : 0u));
          ctx = 2 * ctx + (bit ? 1u : 0u);
          if (((low ^ high) >> 24) == 0) {
            low = (low << 32) & kMask56;
            high = ((high << 32) | kMask32) & kMask56;
            cur = ((cur << 32) | nxt) & kMask56;
            ++widx;
            nxt = widx < nw ? __ldg(w + widx) : 0u;
          }
        }
        dst[start + i] = (uint8_t)ctx;
        p = probs + (((ctx & 0xFFu) >> 6) << 8);
      }
      consumed[c] = widx;
    }
    low_io[s] = (int64_t)low;
    high_io[s] = (int64_t)high;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTable / 2; i += kThreads) {
    const uint32_t v = probs2[i];
    pr[2 * i] = (int32_t)(v & 0xFFFFu);
    pr[2 * i + 1] = (int32_t)(v >> 16);
  }
}

}  // namespace

extern "C" {

const char* kanzi_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int fpaq_decode(const void* pay, const void* chunk_off, const void* chunk_nw,
                const void* chunk_cur, const void* first, const void* lens,
                int n_streams, int64_t chunk_bytes, int64_t ld, void* out,
                void* consumed, void* low, void* high, void* probs,
                int device, void* stream) {
  cudaSetDevice(device);
  if (chunk_bytes < 1 || ld < 0) return (int)cudaErrorInvalidValue;
  if (n_streams > 0)
    fpaq_decode_kernel<<<n_streams, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)pay, (const int64_t*)chunk_off,
        (const int64_t*)chunk_nw, (const int64_t*)chunk_cur,
        (const int64_t*)first, (const int64_t*)lens, chunk_bytes, ld,
        (uint8_t*)out, (int64_t*)consumed, (int64_t*)low, (int64_t*)high,
        (int32_t*)probs);
  return (int)cudaGetLastError();
}

}  // extern "C"
