// CM lockstep encode (I) and decode (J) kernels for Hopper (sm_90a).
//
// Bit-exact with the port's host coder (entropy/binary.py's 56-bit shell
// around entropy/cm.py's CMPredictor; src/entropy/CMPredictor.cpp and
// BinaryEntropy{Encoder,Decoder}.cpp of the reference) and with
// kanzi_tpu's lockstep coder (kanzi_tpu/ops/cm_jnp.py) on single-chunk
// streams (fewer than 2^26 bytes): counter1[256][257] (bit-tree context x
// previous byte, rates 2 and 4), counter2[512][17] (SSE on the quantized
// p with the run mask, rate 6), p12 = (2p + 3(s0 + s1) + 64) >> 7, the
// split low + (((high - low) >> 4) * p12 >> 8), one 32-bit word flushed
// whenever the top 32 bits of low and high agree. The launchers take the
// caller's CUDA stream, launch, and return the first error
// (cudaFuncSetAttribute's, then cudaGetLastError()). Outputs are
// allocated by the caller.
//
// I. cm_encode <- kanzi_tpu/ops/cm_jnp.py cm_encode_batch (:186,
//    _build_encode :104)
// J. cm_decode <- kanzi_tpu/ops/cm_jnp.py cm_decode_batch (:291,
//    _build_decode :210)
//    Both XLA with no Pallas kernel: b streams in lockstep as [b]
//    vectors, 28-bit limbs, the tables gathered and scattered a row a
//    stream at every bit.
//
// What bounds I and J: the dependent chain of 8 bit steps per byte in
// each stream. A step loads three counter1 entries at the context the
// bits before it make, then two counter2 entries at an index computed
// from them, splits the range, and stores the four counters it updated.
// Within a byte no two bit steps touch the same row of either table: the
// steps visit distinct nodes 1..255 of the bit tree, and the rows they
// read (counter1 row ctx at entries 256, b1 and b2; counter2 row ctx |
// run mask) depend on nothing else that changes within the byte. A launch
// has only as many chains as streams. The design: one block a stream,
// whose threads move the stream's tables between global memory (int32,
// the state the wrapper passes in and gets back) and dynamic shared
// memory, and whose first warp runs the bit loop. In I the byte's bits,
// so its 8 contexts, are known before its range splits: lanes 0-7 run
// the byte's 8 predictor steps side by side, lane k bit step k, and
// every lane then runs the byte's 8 range splits, the same on each lane,
// with the 8 probabilities shuffled from lanes 0-7; lane 0 stores the
// words. In J each step's context needs the bit before it, so its first
// thread runs the steps one after another, and takes counter1 off the
// step's chain: before a step's bit is known it loads both children's
// counter1 entries and computes their p (the tables as they stood at the
// byte's start, since no earlier step of the byte wrote those rows);
// after the bit it selects the chosen child's, and stores its own four
// counters. After the byte's seventh bit it loads the next byte's root
// row for both values of the last bit (the previous byte follows from
// it): row 1 was written at the byte's first step, before. The step's
// chain is counter2's two entries at the index p gives, p12, the split,
// the compare with `current`, the selects of the bit and the flush test;
// loading both children's counter2 entries and splits as well was slower
// (more instructions a step than the chain saved, PERF.md). A flush is a
// branch that shifts the bounds and `current`.
// counter1 is held as u16: a bit-0 update stops at 0 and a bit-1 update,
// v - ((v - 65520) >> rate) with an arithmetic shift, at 65520. counter2
// is held as u32: its entry 16 starts at 65536 before bsVersion 7 and
// stays there under bit 1. 131,584 + 34,816 = 166,400 B a block (above
// the 48 KB that needs cudaFuncSetAttribute), one block an SM. low, high
// and current live in 64-bit registers: ((high - low) >> 4) * p12 is
// below 2^52 * 2^12, exact in uint64; J keeps them shifted left by 8
// bits, as G does (csrc/fpaq.cu), so its flush test is one compare of
// upper words. I's next input byte and J's next payload word are loaded
// a byte or a flush ahead, off the chain. A read at or past a stream's
// word count yields 0: the host decoder reads the payload's last partial
// word zero-padded on the right and zero words after it.
//
// Inputs of I: streams [b, ld] u8, lens [b]; outputs: words [b, cap]
// (u32 flush words from each stream's start, those past cap dropped),
// cnt [b] (every flush counted). Inputs of J: pay u32 words, stream s's
// at pay[off[s] : off[s] + nw[s]], cur [b] (the 56-bit current primed
// from the payload's first 7 bytes), lens [b]; outputs: out [b, ld] u8
// (bytes past lens[s] untouched), consumed [b] (the words each stream
// shifted in). Both: low/high [b], counter1 [b, 256 * 257] and counter2
// [b, 512 * 17] (int32), c1/c2/run_mask [b] (int32): the state each
// stream starts from, overwritten with the state it ends in.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kC1 = 256 * 257;
constexpr int kC2 = 512 * 17;
constexpr int kSmem = kC1 * 2 + kC2 * 4;
constexpr uint64_t kMask32 = 0xFFFFFFFFull;
constexpr uint64_t kMask56 = (1ull << 56) - 1;

struct State {
  int64_t* low;
  int64_t* high;
  int32_t* c1t;
  int32_t* c2t;
  int32_t* c1;
  int32_t* c2;
  int32_t* run_mask;
};

// the stream's tables into shared memory: counter1 two u16 a word, from
// global int2 pairs; counter2 as it is
__device__ void load_tables(const State& st, int s, uint32_t* c1w,
                            uint32_t* c2) {
  const int2* g1 = reinterpret_cast<const int2*>(st.c1t + (size_t)s * kC1);
  const int32_t* g2 = st.c2t + (size_t)s * kC2;
  for (int i = threadIdx.x; i < kC1 / 2; i += kThreads) {
    const int2 v = g1[i];
    c1w[i] = ((uint32_t)v.x & 0xFFFFu) | ((uint32_t)v.y << 16);
  }
  for (int i = threadIdx.x; i < kC2; i += kThreads) c2[i] = (uint32_t)g2[i];
  __syncthreads();
}

__device__ void store_tables(const State& st, int s, const uint32_t* c1w,
                             const uint32_t* c2) {
  __syncthreads();
  int2* g1 = reinterpret_cast<int2*>(st.c1t + (size_t)s * kC1);
  int32_t* g2 = st.c2t + (size_t)s * kC2;
  for (int i = threadIdx.x; i < kC1 / 2; i += kThreads)
    g1[i] = make_int2((int32_t)(c1w[i] & 0xFFFFu), (int32_t)(c1w[i] >> 16));
  for (int i = threadIdx.x; i < kC2; i += kThreads) g2[i] = (int32_t)c2[i];
}

// a counter's update: bit 0 v - (v >> rate), bit 1 v - ((v - 65520) >>
// rate), the shift arithmetic
__device__ __forceinline__ uint32_t upd(uint32_t v, uint32_t bit, int rate) {
  return (uint32_t)((int32_t)v -
                    (((int32_t)v - (int32_t)(65520u & (0u - bit))) >> rate));
}

// Counter1's part of a node of J's bit tree under the byte's context
// registers: p and the two entries its update rewrites.
struct Row {
  uint32_t p, t256, tc1;
};

__device__ __forceinline__ Row load_row(const uint16_t* c1, uint32_t ctx,
                                        uint32_t b1, uint32_t b2) {
  const uint16_t* r1 = c1 + ctx * 257;
  Row r;
  r.t256 = r1[256];
  r.tc1 = r1[b1];
  r.p = (13u * (r.t256 + r.tc1) + 6u * r1[b2]) >> 5;
  return r;
}

// The split of the range [lo, hi] (both shifted left by 8) at p12: lo +
// (((hi - lo) >> 4) * p12 >> 8), shifted.
__device__ __forceinline__ uint64_t split(uint64_t lo, uint64_t hi,
                                          uint32_t p12) {
  return lo + ((((hi - lo) >> 12) * p12) & ~0xFFull);
}

__device__ __forceinline__ uint32_t hi32(uint64_t v) {
  return (uint32_t)(v >> 32);
}

// Bit step k of I's predictor for the byte val (context (val | 256) >>
// (8 - k)): p12, and CMPredictor::update()'s four counters of that step.
__device__ __forceinline__ uint32_t predict_step(uint16_t* c1, uint32_t* c2,
                                                 uint32_t val, int k,
                                                 uint32_t b1, uint32_t b2,
                                                 uint32_t rm) {
  const uint32_t ctx = (val | 256u) >> (8 - k);
  const uint32_t bit = (val >> (7 - k)) & 1u;
  uint16_t* r1 = c1 + ctx * 257;
  const uint32_t t256 = r1[256], tc1 = r1[b1], tc2 = r1[b2];
  const uint32_t p = (13u * (t256 + tc1) + 6u * tc2) >> 5;
  uint32_t* r2 = c2 + (ctx | rm) * 17 + (p >> 12);
  const uint32_t s0 = r2[0], s1 = r2[1];
  r1[256] = (uint16_t)upd(t256, bit, 2);
  r1[b1] = (uint16_t)upd(tc1, bit, 4);
  r2[0] = upd(s0, bit, 6);
  r2[1] = upd(s1, bit, 6);
  return (p + p + 3u * (s0 + s1) + 64u) >> 7;
}

__global__ void __launch_bounds__(kThreads)
cm_encode_kernel(const uint8_t* __restrict__ streams,
                 const int64_t* __restrict__ lens, int64_t ld, int64_t cap,
                 int32_t* __restrict__ words, int64_t* __restrict__ cnt_out,
                 State st) {
  extern __shared__ uint32_t smem[];
  uint32_t* c1w = smem;
  uint32_t* c2 = smem + kC1 / 2;
  const int s = blockIdx.x;
  load_tables(st, s, c1w, c2);
  const int lane = threadIdx.x;
  if (lane < 32) {
    uint16_t* c1 = reinterpret_cast<uint16_t*>(c1w);
    uint64_t low = (uint64_t)st.low[s];
    uint64_t high = (uint64_t)st.high[s];
    uint32_t b1 = (uint32_t)st.c1[s], b2 = (uint32_t)st.c2[s];
    uint32_t rm = (uint32_t)st.run_mask[s];
    const int64_t len = lens[s];
    const uint8_t* src = streams + (size_t)s * ld;
    int32_t* dst = words + (size_t)s * cap;
    int64_t cnt = 0;
    uint32_t nxt = len > 0 ? __ldg(src) : 0u;
    for (int64_t i = 0; i < len; ++i) {
      const uint32_t val = nxt;
      nxt = i + 1 < len ? __ldg(src + i + 1) : 0u;
      const uint32_t mine =
          lane < 8 ? predict_step(c1, c2, val, lane, b1, b2, rm) : 0u;
      // the byte's stores before the next byte's loads, on every lane
      __syncwarp();
      uint32_t p12[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) p12[k] = __shfl_sync(0xFFFFFFFFu, mine, k);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint64_t mid = low + ((((high - low) >> 4) * p12[k]) >> 8);
        if ((val >> (7 - k)) & 1u)
          high = mid;
        else
          low = mid + 1;
        if (((low ^ high) >> 24) == 0) {
          if (lane == 0 && cnt < cap)
            dst[cnt] = (int32_t)(uint32_t)(high >> 24);
          ++cnt;
          low = (low << 32) & kMask56;
          high = ((high << 32) | kMask32) & kMask56;
        }
      }
      b2 = b1;
      b1 = val;
      rm = b1 == b2 ? 0x100u : 0u;
    }
    if (lane == 0) {
      cnt_out[s] = cnt;
      st.low[s] = (int64_t)low;
      st.high[s] = (int64_t)high;
      st.c1[s] = (int32_t)b1;
      st.c2[s] = (int32_t)b2;
      st.run_mask[s] = (int32_t)rm;
    }
  }
  store_tables(st, s, c1w, c2);
}

__global__ void __launch_bounds__(kThreads)
cm_decode_kernel(const uint32_t* __restrict__ pay,
                 const int64_t* __restrict__ off,
                 const int64_t* __restrict__ nw_in,
                 const int64_t* __restrict__ cur_in,
                 const int64_t* __restrict__ lens, int64_t ld,
                 uint8_t* __restrict__ out, int64_t* __restrict__ consumed,
                 State st) {
  extern __shared__ uint32_t smem[];
  uint32_t* c1w = smem;
  uint32_t* c2 = smem + kC1 / 2;
  const int s = blockIdx.x;
  load_tables(st, s, c1w, c2);
  if (threadIdx.x == 0) {
    uint16_t* c1 = reinterpret_cast<uint16_t*>(c1w);
    // low, high and current shifted left by 8
    uint64_t low = (uint64_t)st.low[s] << 8;
    uint64_t high = (uint64_t)st.high[s] << 8;
    uint32_t b1 = (uint32_t)st.c1[s], b2 = (uint32_t)st.c2[s];
    uint32_t rm = (uint32_t)st.run_mask[s];
    const int64_t len = lens[s];
    const uint32_t* w = pay + off[s];
    const int64_t nw = nw_in[s];
    uint64_t cur = (uint64_t)cur_in[s] << 8;
    uint8_t* dst = out + (size_t)s * ld;
    int64_t widx = 0;
    uint32_t nxt = nw > 0 ? __ldg(w) : 0u;
    // the step's counter1 row
    Row nd = load_row(c1, 1, b1, b2);
    for (int64_t i = 0; i < len; ++i) {
      Row r1n, r0n;                   // the next byte's root, last bit 1/0
      uint32_t ctx = 1;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        // both children's counter1 rows, before the bit
        Row k1, k0;
        if (k < 7) {
          k0 = load_row(c1, 2 * ctx, b1, b2);
          k1 = load_row(c1, 2 * ctx + 1, b1, b2);
        } else {
          k0 = r0n;
          k1 = r1n;
        }
        const uint32_t i2 = (ctx | rm) * 17 + (nd.p >> 12);
        const uint32_t s0 = c2[i2], s1 = c2[i2 + 1];
        const uint32_t p12 = (nd.p + nd.p + 3u * (s0 + s1) + 64u) >> 7;
        const uint64_t mid = split(low, high, p12);
        const bool bit = mid >= cur;
        const uint64_t lo0 = mid + 0x100u;
        const bool flush = bit ? hi32(low) == hi32(mid)
                               : hi32(lo0) == hi32(high);
        const uint32_t b = bit ? 1u : 0u;
        uint16_t* r1 = c1 + ctx * 257;
        r1[256] = (uint16_t)upd(nd.t256, b, 2);
        r1[b1] = (uint16_t)upd(nd.tc1, b, 4);
        c2[i2] = upd(s0, b, 6);
        c2[i2 + 1] = upd(s1, b, 6);
        high = bit ? mid : high;
        low = bit ? low : lo0;
        nd = Row{bit ? k1.p : k0.p, bit ? k1.t256 : k0.t256,
                 bit ? k1.tc1 : k0.tc1};
        ctx = 2 * ctx + b;
        if (k == 6) {
          // after the byte's store to row 1; the byte is ctx's 7 bits
          // and a last one, the previous byte b1
          const uint32_t v0 = (2 * ctx) & 0xFFu;
          r0n = load_row(c1, 1, v0, b1);
          r1n = load_row(c1, 1, v0 | 1u, b1);
        }
        if (flush) {
          low <<= 32;
          high = (high << 32) | (kMask32 << 8);
          cur = (cur << 32) | ((uint64_t)nxt << 8);
          ++widx;
          nxt = widx < nw ? __ldg(w + widx) : 0u;
        }
      }
      dst[i] = (uint8_t)ctx;
      b2 = b1;
      b1 = ctx & 0xFFu;
      rm = b1 == b2 ? 0x100u : 0u;
    }
    consumed[s] = widx;
    st.low[s] = (int64_t)(low >> 8);
    st.high[s] = (int64_t)(high >> 8);
    st.c1[s] = (int32_t)b1;
    st.c2[s] = (int32_t)b2;
    st.run_mask[s] = (int32_t)rm;
  }
  store_tables(st, s, c1w, c2);
}

State make_state(void* low, void* high, void* c1t, void* c2t, void* c1,
                 void* c2, void* run_mask) {
  return State{(int64_t*)low, (int64_t*)high, (int32_t*)c1t,
               (int32_t*)c2t, (int32_t*)c1,   (int32_t*)c2,
               (int32_t*)run_mask};
}

}  // namespace

extern "C" {

const char* kanzi_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int cm_encode(const void* streams, const void* lens, int n_streams,
              int64_t ld, int64_t cap, void* words, void* cnt, void* low,
              void* high, void* c1t, void* c2t, void* c1, void* c2,
              void* run_mask, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ld < 0 || cap < 0) return (int)cudaErrorInvalidValue;
  if (n_streams > 0) {
    err = cudaFuncSetAttribute(cm_encode_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return (int)err;
    cm_encode_kernel<<<n_streams, kThreads, kSmem, (cudaStream_t)stream>>>(
        (const uint8_t*)streams, (const int64_t*)lens, ld, cap,
        (int32_t*)words, (int64_t*)cnt,
        make_state(low, high, c1t, c2t, c1, c2, run_mask));
  }
  return (int)cudaGetLastError();
}

int cm_decode(const void* pay, const void* off, const void* nw,
              const void* cur, const void* lens, int n_streams, int64_t ld,
              void* out, void* consumed, void* low, void* high, void* c1t,
              void* c2t, void* c1, void* c2, void* run_mask, int device,
              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ld < 0) return (int)cudaErrorInvalidValue;
  if (n_streams > 0) {
    err = cudaFuncSetAttribute(cm_decode_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return (int)err;
    cm_decode_kernel<<<n_streams, kThreads, kSmem, (cudaStream_t)stream>>>(
        (const uint32_t*)pay, (const int64_t*)off, (const int64_t*)nw,
        (const int64_t*)cur, (const int64_t*)lens, ld, (uint8_t*)out,
        (int64_t*)consumed, make_state(low, high, c1t, c2t, c1, c2,
                                       run_mask));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
