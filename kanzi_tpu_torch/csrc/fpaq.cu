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
// What bounds G: the dependent chain of 8 bit steps per input byte in
// each stream, not bytes: a 4 MiB stream is a chain of 32M steps, and a
// launch has only as many chains as the writer's batch has FPAQ blocks.
// So the design keeps everything it can off the coder's chain.
//
// The stream's data alone decides every probability, so the table is not
// the coder's work. One block a stream, two warps:
// - The producer (warp 0) prepares each window (512 bytes) one window
//   ahead. Bit k of a byte (k = 0 for the top bit) reads ctx in
//   [2^k, 2^(k+1)) of its bank, so the 8 bit positions never share a
//   table entry: lane k walks the window's bytes for position k alone,
//   looks up p, stores the update, and writes the bit's operands for the
//   coder as words (p << 16, p, and 256 for a 0 bit or 0 for a 1 bit).
//   Its chain is one shared-memory round trip a byte, not a bit. The
//   whole warp first copies the window's bytes to shared memory, 16 a
//   lane, and afterwards copies the flush words the coder staged for the
//   window two back to the stream's region of the output.
// - The coder (lane 0 of warp 1) codes the window in the other half of
//   the double buffer: six 16-byte loads bring a byte's operands, issued
//   a byte ahead, so its step is the arithmetic and the flush alone. low
//   and high are kept shifted left by 8 bits (low << 8 and high << 8 fill
//   64 bits), which makes the flush test one compare of the upper words
//   (of the bound that moved against the one that did not) and the flush
//   itself a move of the lower words into the upper ones. The range split
//   ((high - low) >> 8) * p is one IMAD.WIDE.U32 (the range's upper word
//   times p << 16) plus one IMAD (its bits 16..31 times p, plus the 0
//   bit's 256), and the new bound one 64-bit add masked to the byte grid.
//   A flush word is a predicated store to a shared-memory stage at a
//   32-bit address that advances by 4, so no global address is formed
//   on the chain. At the end of each window the coder writes the window's
//   word count and low | MASK_0_24, which the container's chunk framing
//   reads. The producer writes each stream's words in order into the
//   stream's own region of the output; the caller sizes the region, and a
//   stream that emits more words than it holds counts them all but
//   writes only those that fit (the caller then launches it again with a
//   larger region).
// The two warps meet once a window (4096 bit steps), through a pair of
// named barriers for each half of the double buffer: the producer arrives
// at FULL[b] when window w is in half b, and syncs on EMPTY[b] before it
// copies out window w's flush words and overwrites the half with window
// w + 2; the coder syncs on FULL[b] and arrives at EMPTY[b].
//
// Shared memory a block: 96 KiB of operands and 32 KiB of staged flush
// words (one a bit at most), both double-buffered, 1 KiB of bytes and
// 2 KiB of tables, so a launch of s streams takes s SMs.
//
// Measured on an H100 80GB HBM3 at 700 W (PERF.md, chip_smoke.py
// --kernels, 16 streams of 4 MiB), against 1791.8 ms (53.40 ns a bit
// step) for the one-thread-a-stream kernel before: 1024.7 ms, 30.54 ns
// or 60.5 cycles a bit step at the 1980 MHz SM clock. Its SASS (62
// registers) schedules a step in 25.8 instructions and 54.5 static stall
// cycles, 42 of them between one range subtract and the next: the chain
// (IADD3, SHF, IMAD, IMAD.WIDE, three IADD3s for ptxas's split of the
// wide add, LOP3, ISETP) and then the bit's and the flush's 7 SELs, one
// every 2 cycles because the ALU pipe takes a warp instruction every
// other cycle. Two other designs of the coder were measured and dropped:
// the probabilities as a byte's 8 u16 with the flush word stored to
// global memory on the chain (1237.2 ms: 37.2 instructions a step,
// 4 of them the store's 64-bit address), and the split as mad.hi.u32 of
// the masked range with the updates written as predicated PTX moves
// (1146.6 ms, against this design's 1025.0 in the same call: ptxas
// turned the moves into 8 SELs and 2 LOP3s on the ALU pipe).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWinB = 512;
constexpr int kThreads = 64;            // producer warp, coder warp
constexpr int kRec = 6;                 // uint4 a byte: p << 16, p, add
constexpr uint32_t kMask24 = (1u << 24) - 1;

struct Smem {
  // [half][byte] -> 8 x (p << 16), 8 x p, 8 x add (0 for a 1 bit, 256 for
  // a 0 bit) of the byte's bit positions; one byte's worth past the end
  // for the coder's look-ahead
  uint4 rec[(2 * kWinB + 1) * kRec];
  // [half] -> the window's flush words (at most one a bit), their first
  // index in the stream's region and their count
  uint32_t stage[2][8 * kWinB];
  uint32_t base[2];
  uint32_t count[2];
  uint32_t bytes[2][kWinB / 4];
  uint16_t probs[4 * 256];
};

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "n"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "n"(kThreads) : "memory");
}

// barrier ids (0 is __syncthreads')
__device__ __forceinline__ int full_bar(int half) { return 1 + half; }
__device__ __forceinline__ int empty_bar(int half) { return 3 + half; }

// shared-memory word at addr = v where pred holds, without a branch
__device__ __forceinline__ void store_if(bool pred, uint32_t addr,
                                         uint32_t v) {
  asm volatile("{\n .reg .pred q;\n setp.ne.u32 q, %0, 0;\n"
               " @q st.shared.u32 [%1], %2;\n}"
               :: "r"((uint32_t)pred), "r"(addr), "r"(v));
}

__device__ __forceinline__ uint64_t mad_wide(uint32_t a, uint32_t b,
                                             uint64_t c) {
  uint64_t d;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}

// The number of bytes of window w that lie inside a stream of len bytes.
__device__ __forceinline__ int live_bytes(int64_t len, int64_t w) {
  const int64_t rem = len - w * kWinB;
  return rem <= 0 ? 0 : rem >= kWinB ? kWinB : (int)rem;
}

// Producer: window w (live > 0) into half b. Every lane copies 16 of the
// window's bytes; lane k < 8 then walks all 512 for bit position k. Bytes
// past the stream's end are walked too: they only touch the tables after
// the stream's last coded bit.
__device__ __forceinline__ void produce(Smem& sm, int b,
                                       const uint8_t* __restrict__ win,
                                       uint32_t prev, int lane) {
  reinterpret_cast<uint4*>(sm.bytes[b])[lane] =
      __ldg(reinterpret_cast<const uint4*>(win) + lane);
  __syncwarp();
  if (lane < 8) {
    const int k = lane;
    uint32_t* rec =
        reinterpret_cast<uint32_t*>(sm.rec + b * kWinB * kRec) + k;
    for (int j = 0; j < kWinB; j += 4) {
      const uint32_t v4 = sm.bytes[b][j >> 2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t val = (v4 >> (8 * q)) & 0xFFu;
        const uint32_t idx = ((prev >> 6) << 8) | ((val | 256u) >> (8 - k));
        const uint32_t p = sm.probs[idx];
        const uint32_t bit = (val >> (7 - k)) & 1u;
        uint32_t* r = rec + (j + q) * 4 * kRec;
        r[0] = p << 16;
        r[8] = p;
        r[16] = (bit ^ 1u) << 8;
        sm.probs[idx] = (uint16_t)(p - (p >> 6) + 1023u * bit);
        prev = val;
      }
    }
  }
  __syncwarp();
}

// Producer: the flush words of the window the coder finished in half b,
// to the stream's region, those past its cap dropped.
__device__ __forceinline__ void copy_out(const Smem& sm, int b,
                                         uint32_t* __restrict__ dst,
                                         uint32_t cap, int lane) {
  const uint32_t base = sm.base[b];
  const uint32_t n = sm.count[b];
  for (uint32_t i = lane; i < n && base + i < cap; i += 32)
    dst[base + i] = sm.stage[b][i];
}

// Coder state: low << 8 and high << 8 as 32-bit words (lower l0/h0,
// upper l1/h1), and the shared address of the next flush word.
struct Coder {
  uint32_t l0, l1, h0, h1;
  uint32_t off;
};

// One bit: p16 = p << 16, add = 256 for a 0 bit and 0 for a 1 bit.
__device__ __forceinline__ void code_bit(Coder& c, uint32_t p16, uint32_t p,
                                         uint32_t add) {
  const bool bit = add == 0;
  // r = (high - low) << 8
  uint32_t r0, r1;
  asm("sub.cc.u32 %0, %2, %3;\n\tsubc.u32 %1, %4, %5;"
      : "=r"(r0), "=r"(r1) : "r"(c.h0), "r"(c.l0), "r"(c.h1), "r"(c.l1));
  // ((high - low) >> 8) * p + add, below 2^64: its high 32 bits of the
  // range times p << 16, plus bits 16..31 times p, plus add
  const uint64_t rp = mad_wide(r1, p16, (r0 >> 16) * p + add);
  // (low + t [+ 1]) << 8 with t = rp >> 8: low's lower byte is 0, so the
  // add cannot carry out of rp's lower byte, which the mask drops
  uint32_t n0, n1;
  asm("add.cc.u32 %0, %2, %3;\n\taddc.u32 %1, %4, %5;"
      : "=r"(n0), "=r"(n1)
      : "r"(c.l0), "r"((uint32_t)rp), "r"(c.l1), "r"((uint32_t)(rp >> 32)));
  n0 &= 0xFFFFFF00u;
  // the top 32 bits agree: the bound that moved against the one that did
  // not; the flush word is n1 either way
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

__device__ __forceinline__ void load_rec(uint4 (&r)[kRec],
                                         const uint4* src) {
#pragma unroll
  for (int i = 0; i < kRec; ++i) r[i] = src[i];
}

__device__ __forceinline__ void code_byte(Coder& c,
                                          const uint4 (&r)[kRec]) {
  const uint32_t p16[8] = {r[0].x, r[0].y, r[0].z, r[0].w,
                           r[1].x, r[1].y, r[1].z, r[1].w};
  const uint32_t p[8] = {r[2].x, r[2].y, r[2].z, r[2].w,
                         r[3].x, r[3].y, r[3].z, r[3].w};
  const uint32_t add[8] = {r[4].x, r[4].y, r[4].z, r[4].w,
                           r[5].x, r[5].y, r[5].z, r[5].w};
#pragma unroll
  for (int k = 0; k < 8; ++k) code_bit(c, p16[k], p[k], add[k]);
}

// Coder: the live bytes of the window in half b, the next byte's record
// loaded while this one is coded.
__device__ __forceinline__ void code_window(Coder& c, const Smem& sm, int b,
                                            int live) {
  const uint4* rec = sm.rec + b * kWinB * kRec;
  uint4 nxt[kRec];
  load_rec(nxt, rec);
#pragma unroll 2
  for (int j = 0; j < live; ++j) {
    uint4 cur[kRec];
#pragma unroll
    for (int i = 0; i < kRec; ++i) cur[i] = nxt[i];
    load_rec(nxt, rec + (j + 1) * kRec);
    code_byte(c, cur);
  }
}

__global__ void __launch_bounds__(kThreads)
fpaq_encode_kernel(const uint8_t* __restrict__ streams,
                   const int64_t* __restrict__ lens, int64_t lp,
                   int chunk_win, int64_t cap, uint32_t* __restrict__ words,
                   int32_t* __restrict__ win_cnt,
                   int64_t* __restrict__ win_low) {
  extern __shared__ uint4 smem[];
  Smem& sm = *reinterpret_cast<Smem*>(smem);
  const int s = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int64_t len = lens[s];
  const int64_t n_win = lp / kWinB;
  if (threadIdx.x < 32) {
    // producer: window w into half w & 1, after the flush words of window
    // w - 2 have left it
    const uint8_t* src = streams + (size_t)s * lp;
    uint32_t* dst = words + (size_t)s * cap;
    // a stream of at most 1 GiB emits fewer than 2^32 words (at most ~10
    // bits a coded bit), so counts and the cap compare in 32 bits
    const uint32_t cap32 = cap > UINT32_MAX ? UINT32_MAX : (uint32_t)cap;
    for (int i = lane; i < 4 * 256; i += 32) sm.probs[i] = 1u << 15;
    __syncwarp();
    uint32_t last = 0;              // the previous window's last byte
    for (int64_t w = 0; w < n_win + 2; ++w) {
      const int b = (int)(w & 1);
      if (w >= 2) {
        bar_sync(empty_bar(b));
        copy_out(sm, b, dst, cap32, lane);
      }
      if (w < n_win) {
        if (live_bytes(len, w) > 0) {
          produce(sm, b, src + w * kWinB, w % chunk_win == 0 ? 0u : last,
                  lane);
          last = sm.bytes[b][kWinB / 4 - 1] >> 24;
        }
        bar_arrive(full_bar(b));
      }
    }
  } else {
    // coder
    Coder c{0, 0, 0xFFFFFF00u, 0xFFFFFFFFu, 0};    // high = MASK_0_56
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
        win_cnt[(size_t)s * n_win + w] = (int32_t)n;
        win_low[(size_t)s * n_win + w] =
            (int64_t)(((uint64_t)c.l1 << 24) | (c.l0 >> 8) | kMask24);
      }
      __syncwarp();
      bar_arrive(empty_bar(b));
    }
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
  // streams of at most 1 GiB, the container's largest block
  if (lp % kWinB != 0 || chunk_win < 1 || cap < 0 || lp > (int64_t)1 << 30)
    return (int)cudaErrorInvalidValue;
  if (n_streams > 0) {
    const int smem = (int)sizeof(Smem);
    cudaError_t err = cudaFuncSetAttribute(
        fpaq_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    fpaq_encode_kernel<<<n_streams, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)streams, (const int64_t*)lens, lp, chunk_win, cap,
        (uint32_t*)words, (int32_t*)win_cnt, (int64_t*)win_low);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
