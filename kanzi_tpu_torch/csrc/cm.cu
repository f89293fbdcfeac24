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
// has only as many chains as streams. Both kernels: one block a stream,
// whose threads move the stream's tables between global memory (int32,
// the state the wrapper passes in and gets back) and dynamic shared
// memory.
//
// In I the coder never feeds the predictor: a step's context, p12 and
// counter updates follow from the input bytes alone, never from low or
// high. So I has G's shape (csrc/fpaq.cu), two warps in two stages:
// - The producer (warp 0) runs the predictor a window (kWin, 128 bytes)
//   ahead. Bit step k of a byte (k = 0 for its top bit) reads counter1's
//   row ctx in [2^k, 2^(k+1)) and counter2's row ctx | run mask, so the
//   8 steps of a byte never share a row with each other or with another
//   byte's other steps: lane k walks the window's bytes for step k
//   alone, with its own copy of the context registers, and writes each
//   byte's operands for the coder; its stores land before its next
//   byte's loads in one thread's program order. The whole warp first
//   copies the window's bytes to shared memory, 4 a lane, and afterwards
//   copies the flush words the coder staged for the window two back to
//   the stream's row of the output, those past cap dropped (every flush
//   is counted).
// - The coder (lane 0 of warp 1) codes the window in the other half of
//   the double buffer: eight 16-byte loads bring a byte's operands,
//   issued a byte ahead, so its step is the split and the flush alone. A
//   bit's operands are four words: P = p12 << 20, p12, add (256 for a 0
//   bit, 0 for a 1 bit) and M (all ones where p12 = 4096, whose P wraps
//   to 0). low and high are kept shifted left by 8 bits, as two 32-bit
//   words each, so the flush test is one compare of upper words. With r =
//   (high - low) << 8 in words r0, r1, the split's ((high - low) >> 4) *
//   p12 is r1 * P + ((r1 & M) << 32) + (r0 >> 12) * p12: a SHF, an IMAD,
//   one IMAD.WIDE.U32 with low as its addend and one 3-input add, masked
//   to the byte grid. The bit is known, so the bound it moves is a select
//   on a predicate that waits on nothing; a flush word is a predicated
//   store to a shared stage at a 32-bit address that advances by 4, and
//   the flush shifts the bounds by selects: the byte loop has no branch.
// The two warps meet once a window (1024 bit steps), through a pair of
// named barriers for each half of the double buffer: the producer arrives
// at FULL[b] when window w is in half b, and syncs on EMPTY[b] before it
// copies out window w's flush words and overwrites the half with window
// w + 2; the coder syncs on FULL[b] and arrives at EMPTY[b]. Warps 2-7
// only move the tables. Shared memory after the tables: 32,896 B of
// operands (128 B a byte, double-buffered, and one byte's worth of the
// coder's look-ahead), 8 KiB of staged flush words (at most one a bit)
// and 256 B of bytes: 207,760 B a block, one block an SM.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md; chip_smoke.py --cm,
// 16 streams of 4 MiB), against 2646.2 ms (156.1 cycles a bit step) for
// the design before (a byte's 8 predictor steps on lanes 0-7, shuffled
// to every lane, then its 8 splits): 900.8 ms, 53.2 cycles a bit step at
// the 1980 MHz SM clock; ptxas schedules a byte of the coder in 206
// instructions and 376 static stall cycles. Also measured and dropped:
// the new bound's add as PTX add.cc/addc after a mad.wide (967.3 ms, 213
// instructions and 411 cycles a byte), and the next split before the
// flush test with the flush a branch (1203.0 ms: ptxas wraps each of the
// byte's 8 branches in BSSY/BSYNC; 1217.6 and 1262.2 ms with the branch
// as bra.uni in PTX).
//
// In J each step's context needs the bit before it, so its first
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
// the 48 KB that needs cudaFuncSetAttribute), one block an SM. J's low,
// high and current live in 64-bit registers: ((high - low) >> 4) * p12 is
// below 2^52 * 2^12, exact in uint64; J keeps them shifted left by 8
// bits, as G does (csrc/fpaq.cu), so its flush test is one compare of
// upper words. J's next payload word is loaded a flush ahead, off the
// chain. A read at or past a stream's word count yields 0: the host
// decoder reads the payload's last partial word zero-padded on the right
// and zero words after it.
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

// I's producer and coder share, after the tables, a window's double
// buffer: for each half, a record of 8 uint4 a byte (kRec: the bit
// steps' P = p12 << 20, p12, add = 256 for a 0 bit or 0 for a 1 bit, and
// M = all ones where p12 = 4096, whose P wraps to 0; 8 words of each,
// bit step k's at index k), the flush words the coder staged (at most
// one a bit), their first index in the stream's row and their count, and
// the window's bytes. A record past the second half takes the coder's
// look-ahead.
constexpr int kWin = 128;
constexpr int kRec = 8;

struct EncSmem {
  uint4 rec[(2 * kWin + 1) * kRec];
  uint32_t stage[2][8 * kWin];
  uint32_t base[2];
  uint32_t count[2];
  uint32_t bytes[2][kWin / 4];
};

constexpr int kSmemEnc = kSmem + (int)sizeof(EncSmem);

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;" :: "r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;" :: "r"(id) : "memory");
}

// the named barriers of the producer and the coder (0 is __syncthreads')
__device__ __forceinline__ int full_bar(int half) { return 1 + half; }
__device__ __forceinline__ int empty_bar(int half) { return 3 + half; }

// shared-memory word at addr = v where pred holds, without a branch
__device__ __forceinline__ void store_if(bool pred, uint32_t addr,
                                         uint32_t v) {
  asm volatile("{\n .reg .pred q;\n setp.ne.u32 q, %0, 0;\n"
               " @q st.shared.u32 [%1], %2;\n}"
               :: "r"((uint32_t)pred), "r"(addr), "r"(v) : "memory");
}

// Producer: window w of the stream (live bytes, 0 < live <= kWin) into
// half b. Every lane copies 4 of the window's bytes; lane k < 8 then
// walks them for bit step k, with its own copy of the context registers.
__device__ __forceinline__ void produce(EncSmem& sm, int b,
                                        const uint8_t* __restrict__ win,
                                        int live, uint16_t* c1, uint32_t* c2,
                                        uint32_t& b1, uint32_t& b2,
                                        uint32_t& rm, int lane) {
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (4 * lane + i < live)
      v |= (uint32_t)__ldg(win + 4 * lane + i) << (8 * i);
  sm.bytes[b][lane] = v;
  __syncwarp();
  if (lane < 8) {
    const int k = lane;
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(sm.bytes[b]);
    uint32_t* rec = reinterpret_cast<uint32_t*>(sm.rec + b * kWin * kRec) + k;
    for (int j = 0; j < live; ++j) {
      const uint32_t val = bytes[j];
      const uint32_t p12 = predict_step(c1, c2, val, k, b1, b2, rm);
      uint32_t* r = rec + j * 4 * kRec;
      r[0] = p12 << 20;
      r[8] = p12;
      r[16] = (((val >> (7 - k)) & 1u) ^ 1u) << 8;
      r[24] = 0u - (p12 >> 12);
      b2 = b1;
      b1 = val;
      rm = b1 == b2 ? 0x100u : 0u;
    }
  }
  __syncwarp();
}

// Producer: the flush words of the window the coder finished in half b,
// to the stream's row, those past its cap dropped.
__device__ __forceinline__ void copy_out(const EncSmem& sm, int b,
                                         int32_t* __restrict__ dst,
                                         uint32_t cap, int lane) {
  const uint32_t base = sm.base[b];
  const uint32_t n = sm.count[b];
  for (uint32_t i = lane; i < n && base + i < cap; i += 32)
    dst[base + i] = (int32_t)sm.stage[b][i];
}

// Coder state: low << 8 and high << 8 as 32-bit words (lower l0/h0,
// upper l1/h1), and the shared address of the next flush word.
struct Coder {
  uint32_t l0, l1, h0, h1;
  uint32_t off;
};

// A bit step's operands: P = p12 << 20, p12, add, M.
struct Op {
  uint32_t pw, q, add, m;
};

__device__ __forceinline__ Op op_of(const uint4 (&r)[kRec], int k) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(r);
  return Op{w[k], w[8 + k], w[16 + k], w[24 + k]};
}

// The split's new bound (low + ((high - low) >> 4) * p12 >> 8, plus 1 for
// a 0 bit), shifted: (high - low) >> 4 is the range r >> 12, r = (high -
// low) << 8 in words r0, r1, and r >> 12 times p12 is r1 times P (r1 << 32
// more where p12 = 4096) plus (r0 >> 12) * p12, below 2^32, to which add
// goes. The sum's lower byte is that of (r0 >> 12) * p12 (low's and r1 *
// P's are 0), and the mask drops it. Written as one 64-bit sum, ptxas
// makes it one IMAD.WIDE.U32 with low as its addend and one 3-input add
// with two carries.
__device__ __forceinline__ void split_words(const Coder& c, const Op& o,
                                            uint32_t& n0, uint32_t& n1) {
  uint32_t r0, r1;
  asm("sub.cc.u32 %0, %2, %3;\n\tsubc.u32 %1, %4, %5;"
      : "=r"(r0), "=r"(r1) : "r"(c.h0), "r"(c.l0), "r"(c.h1), "r"(c.l1));
  const uint64_t n = (((uint64_t)c.l1 << 32) | c.l0) + (uint64_t)r1 * o.pw +
                     ((r0 >> 12) * o.q + o.add) +
                     ((uint64_t)(r1 & o.m) << 32);
  n0 = (uint32_t)n & 0xFFFFFF00u;
  n1 = (uint32_t)(n >> 32);
}

__device__ __forceinline__ void load_rec(uint4 (&r)[kRec], const uint4* src) {
#pragma unroll
  for (int i = 0; i < kRec; ++i) r[i] = src[i];
}

// One bit: the bound the bit moves, the flush test on the upper words (of
// the bound that moved against the one that did not; the word is n1 either
// way), the word stored where it flushes and the bounds shifted by selects.
__device__ __forceinline__ void code_bit(Coder& c, const Op& o) {
  const bool bit = o.add == 0;
  uint32_t n0, n1;
  split_words(c, o, n0, n1);
  const bool flush = n1 == (bit ? c.l1 : c.h1);
  if (bit) {
    c.h0 = n0;
    c.h1 = n1;
  } else {
    c.l0 = n0;
    c.l1 = n1;
  }
  store_if(flush, c.off, n1);
  c.off += flush ? 4u : 0u;
  // low = (low & MASK_0_24) << 32; high = (high & MASK_0_24) << 32 |
  // MASK_0_32, in the shifted form
  const uint32_t h1 = c.h0 | 0xFFu;
  c.l1 = flush ? c.l0 : c.l1;
  c.l0 = flush ? 0u : c.l0;
  c.h1 = flush ? h1 : c.h1;
  c.h0 = flush ? 0xFFFFFF00u : c.h0;
}

// Coder: the live bytes of the window in half b, the next byte's record
// loaded while this one is coded.
__device__ __forceinline__ void code_window(Coder& c, const EncSmem& sm,
                                            int b, int live) {
  const uint4* rec = sm.rec + b * kWin * kRec;
  uint4 nxt[kRec];
  load_rec(nxt, rec);
  for (int j = 0; j < live; ++j) {
    uint4 cur[kRec];
#pragma unroll
    for (int i = 0; i < kRec; ++i) cur[i] = nxt[i];
    load_rec(nxt, rec + (j + 1) * kRec);
#pragma unroll
    for (int k = 0; k < 8; ++k) code_bit(c, op_of(cur, k));
  }
}

// The number of bytes of window w that lie inside a stream of len bytes.
__device__ __forceinline__ int live_bytes(int64_t len, int64_t w) {
  const int64_t rem = len - w * kWin;
  return rem <= 0 ? 0 : rem >= kWin ? kWin : (int)rem;
}

__global__ void __launch_bounds__(kThreads)
cm_encode_kernel(const uint8_t* __restrict__ streams,
                 const int64_t* __restrict__ lens, int64_t ld, int64_t cap,
                 int32_t* __restrict__ words, int64_t* __restrict__ cnt_out,
                 State st) {
  extern __shared__ uint32_t smem[];
  uint32_t* c1w = smem;
  uint32_t* c2 = smem + kC1 / 2;
  EncSmem& sm = *reinterpret_cast<EncSmem*>(smem + kSmem / 4);
  const int s = blockIdx.x;
  load_tables(st, s, c1w, c2);
  const int lane = threadIdx.x & 31;
  const int64_t len = lens[s];
  const int64_t n_win = (len + kWin - 1) / kWin;
  if (threadIdx.x < 32) {
    // producer: window w into half w & 1, after the flush words of window
    // w - 2 have left it
    uint16_t* c1 = reinterpret_cast<uint16_t*>(c1w);
    uint32_t b1 = (uint32_t)st.c1[s], b2 = (uint32_t)st.c2[s];
    uint32_t rm = (uint32_t)st.run_mask[s];
    const uint8_t* src = streams + (size_t)s * ld;
    int32_t* dst = words + (size_t)s * cap;
    // a stream below 2^26 bytes flushes fewer than 2^29 words
    const uint32_t cap32 = cap > UINT32_MAX ? UINT32_MAX : (uint32_t)cap;
    for (int64_t w = 0; w < n_win + 2; ++w) {
      const int b = (int)(w & 1);
      if (w >= 2) {
        bar_sync(empty_bar(b));
        copy_out(sm, b, dst, cap32, lane);
      }
      if (w < n_win) {
        produce(sm, b, src + w * kWin, live_bytes(len, w), c1, c2, b1, b2,
                rm, lane);
        bar_arrive(full_bar(b));
      }
    }
    if (lane == 0) {
      st.c1[s] = (int32_t)b1;
      st.c2[s] = (int32_t)b2;
      st.run_mask[s] = (int32_t)rm;
    }
  } else if (threadIdx.x < 64) {
    // coder
    const uint64_t low = (uint64_t)st.low[s] << 8;
    const uint64_t high = (uint64_t)st.high[s] << 8;
    Coder c{(uint32_t)low, (uint32_t)(low >> 32), (uint32_t)high,
            (uint32_t)(high >> 32), 0};
    uint32_t cnt = 0;
    for (int64_t w = 0; w < n_win; ++w) {
      const int b = (int)(w & 1);
      bar_sync(full_bar(b));
      if (lane == 0) {
        const uint32_t off0 =
            (uint32_t)__cvta_generic_to_shared(sm.stage[b]);
        c.off = off0;
        code_window(c, sm, b, live_bytes(len, w));
        const uint32_t n = (c.off - off0) >> 2;
        sm.base[b] = cnt;
        sm.count[b] = n;
        cnt += n;
      }
      __syncwarp();
      bar_arrive(empty_bar(b));
    }
    if (lane == 0) {
      cnt_out[s] = cnt;
      st.low[s] = (int64_t)(((uint64_t)c.l1 << 24) | (c.l0 >> 8));
      st.high[s] = (int64_t)(((uint64_t)c.h1 << 24) | (c.h0 >> 8));
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
                               kSmemEnc);
    if (err != cudaSuccess) return (int)err;
    cm_encode_kernel<<<n_streams, kThreads, kSmemEnc,
                       (cudaStream_t)stream>>>(
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
