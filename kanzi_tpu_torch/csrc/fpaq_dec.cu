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
// each stream. Each step's table index is the bits decoded before it, and
// its bit is the split against `current`, so a launch has only as many
// chains as streams: one block a stream, whose first thread decodes the
// stream's chunks in turn, its 2 KiB table in shared memory (the other
// threads of the warp load and store it). Within a byte no step reads an
// entry that an earlier step of the byte wrote: the steps visit distinct
// nodes 1..255 of one bank's bit tree, and the bank is fixed for the byte.
// So the table's loads come off the step's chain: a step holds its own
// probability and both its children's, and loads its four grandchildren
// (one 8-byte load) before its bit is known; after the bit it selects the
// next step's probability and the children's pair that the next step
// holds. The next byte's root and the root's children are loaded after the
// byte's second bit, which fixes the next bank (bank 0 after a chunk's
// last byte). The step's chain is the compare with `current`, the selects
// of the bit and the next step's split, which is computed before the flush
// test: a flush (the top 32 bits of both bounds agree) is a rare branch
// that shifts the bounds and `current` and splits again, so the test
// overlaps the split. Splitting both children's ranges before the bit was
// slower (more instructions a step, PERF.md). low, high and current are
// kept shifted left by 8 bits, as the encoder G keeps them (csrc/fpaq.cu):
// the flush test is one compare of upper words, and the split is ((high -
// low) >> 16) * p with its lower byte cleared, below 2^48 * 2^16, exact in
// 64 bits: no limbs. The payload's global load is off the chain: the word
// the next flush takes is held in a register, and the one after it is
// loaded at the flush that consumes it. A read at or past a chunk's word
// count yields 0, as the host decoder shifts in a zero word once fewer
// than 4 payload bytes are left: a chunk never reads another chunk's
// words, of its stream or of the next.
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
constexpr uint64_t kLow32 = 0xFFFFFFFFull;

// The split of the range [lo, hi] (both shifted left by 8) at the
// probability p of a 1 bit: lo + (((hi - lo) >> 8) * p >> 8), shifted.
__device__ __forceinline__ uint64_t split(uint64_t lo, uint64_t hi,
                                          uint32_t p) {
  return lo + ((((hi - lo) >> 16) * p) & ~0xFFull);
}

__device__ __forceinline__ uint32_t hi32(uint64_t v) {
  return (uint32_t)(v >> 32);
}

// Four table entries (two words) at a shared-window address. The table
// is written as u16: the asm's memory clobber keeps this load after the
// stores before it, which a load of another type need not follow.
__device__ __forceinline__ uint2 lds64(uint32_t a) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y)
               : "r"(a)
               : "memory");
  return v;
}

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
  // the table two entries a word: word w of a bank holds its entries 2w
  // (lower half) and 2w + 1, a node's two children
  __shared__ __align__(8) uint32_t probs2[kTable / 2];
  const int s = blockIdx.x;
  int32_t* pr = probs_io + (size_t)s * kTable;
  for (int i = threadIdx.x; i < kTable / 2; i += kThreads)
    probs2[i] = ((uint32_t)pr[2 * i] & 0xFFFFu) | ((uint32_t)pr[2 * i + 1]
                                                  << 16);
  __syncthreads();
  if (threadIdx.x == 0) {
    uint64_t low = (uint64_t)low_io[s] << 8;
    uint64_t high = (uint64_t)high_io[s] << 8;
    const int64_t len = lens[s];
    uint8_t* dst = out + (size_t)s * ld;
    int64_t c = first[s];
    // the table's shared-window address; the byte's bank, its root's
    // probability and the root's children's: bank 0 at a chunk start
    const uint32_t tbl = (uint32_t)__cvta_generic_to_shared(probs2);
    uint32_t bank = 0;
    uint32_t pv = probs2[0] >> 16, kids = probs2[1];
    for (int64_t start = 0; start < len; start += chunk_bytes, ++c) {
      const int64_t n = len - start < chunk_bytes ? len - start : chunk_bytes;
      const uint32_t* w = pay + chunk_off[c];
      const int64_t nw = chunk_nw[c];
      uint64_t cur = (uint64_t)chunk_cur[c] << 8;
      int64_t widx = 0;
      uint32_t nxt = nw > 0 ? __ldg(w) : 0u;
      uint64_t mid = split(low, high, pv);      // the first step's
      for (int64_t i = 0; i < n; ++i) {
        // the next byte's bank: the byte's top two bits, or bank 0 after
        // the chunk's last byte
        const uint32_t keep = i + 1 < n ? 3u : 0u;
        uint16_t* p = reinterpret_cast<uint16_t*>(probs2 + (bank << 7));
        const uint32_t at = tbl + (bank << 9);
        uint32_t next = 0, npv = 0, nkids = 0;
        uint32_t ctx = 1;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          // the grandchildren 4ctx .. 4ctx + 3 (none past the tree)
          uint2 g = make_uint2(0u, 0u);
          if (k < 6) g = lds64(at + 8 * ctx);
          const bool bit = mid >= cur;
          const uint64_t lo0 = mid + 0x100u;
          const bool flush = bit ? hi32(low) == hi32(mid)
                                 : hi32(lo0) == hi32(high);
          p[ctx] = (uint16_t)(pv - (pv >> 6) + (bit ? 1023u : 0u));
          high = bit ? mid : high;
          low = bit ? low : lo0;
          pv = k < 7 ? (bit ? kids >> 16 : kids & 0xFFFFu) : npv;
          if (k < 6) kids = bit ? g.y : g.x;
          ctx = 2 * ctx + (bit ? 1u : 0u);
          if (k == 1) {
            // after the byte's stores to nodes 1..3 of its bank
            next = ctx & keep;
            const uint2 r = lds64(tbl + (next << 9));
            npv = r.x >> 16;
            nkids = r.y;
          }
          // the next step's split before the flush test, which rarely
          // holds: then again from the shifted bounds
          mid = split(low, high, pv);
          if (flush) {
            low <<= 32;
            high = (high << 32) | (kLow32 << 8);
            cur = (cur << 32) | ((uint64_t)nxt << 8);
            ++widx;
            nxt = widx < nw ? __ldg(w + widx) : 0u;
            mid = split(low, high, pv);
          }
        }
        dst[start + i] = (uint8_t)ctx;
        bank = next;
        kids = nkids;
      }
      consumed[c] = widx;
    }
    low_io[s] = (int64_t)(low >> 8);
    high_io[s] = (int64_t)(high >> 8);
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
