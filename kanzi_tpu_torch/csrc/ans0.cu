// Order-0 interleaved 4-lane rANS (ANS0) kernels for Hopper (sm_90a).
//
// Bit-exact with kanzi_tpu/ops/ans.py and the reference coder
// (src/entropy/ANSRange{Encoder,Decoder}.cpp): 16 KiB chunks, log range
// 12, 4 lanes, 16-bit renormalisation, ANS_TOP = 1 << 15. Each kernel has
// an extern "C" launcher that takes the caller's CUDA stream, launches,
// and returns cudaGetLastError(). Outputs are allocated by the caller.
//
// A. ans0_encode_scan  <- kanzi_tpu/ops/ans.py _gather_kernel (:120) and
//    the 4-lane lax.scan of _encode_core (:340-364).
// B. ans0_compact      <- kanzi_tpu/ops/ans.py _compact_kernel (:210) and
//    the dynamic_update_slice scan of compact_rows (:265-271).
// C. ans0_decode       <- kanzi_tpu/ops/ans.py _ans0_decode_kernel (:568).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16384;
constexpr int kSteps = kChunk / 4;
constexpr uint32_t kScale = 4096;
constexpr uint32_t kMask = kScale - 1;
constexpr int kLogRange = 12;
constexpr uint32_t kAnsTop = 1u << 15;

// ---------------------------------------------------------------------
// A. Encode scan. One thread per (chunk, lane); lane l walks its symbols
// backwards, chunk[16383 - 4t - l] at step t, 4096 dependent steps:
// compare with xmax, the renorm select, __umulhi, shift, multiply-add
// (~26 cycles). The chunk's two 256-entry tables (packed =
// bias<<16 | cmplFreq<<4 | invShift-31, and invFreq) sit in shared
// memory, repacked at the load as F1 packs its words (ans1.cu): invFreq,
// then shift - 1 | bias << 5 | cmplFreq << 18, one 8-byte entry a
// symbol, so the gather that the TPU ran as a separate 128-lane
// split-table pass is one shared load a step.
//
// Bound: the chains, 16384 at 4096 chunks, about one warp of them per
// SM sub-partition, so no other warp hides what a chain's warp waits
// on. The first design (a 1-byte global load and a strided 4-byte
// store a step, 16 chunks a block) took 0.485-0.515 ms at 4096 chunks
// on an H100 80GB HBM3 at 700 W, ~120 ns a step (PERF.md): it waited on
// memory every step. This one keeps memory off the step:
// - a block is one warp of 8 chunks (512 blocks at 4096 chunks), its
//   tables 16 KiB of shared memory;
// - the symbols come 16 steps at a time: each of a chunk's 4 threads
//   loads one 16-byte word of the chunk's next 64 bytes, three groups
//   ahead, and the words go round the chunk's threads by __shfl_sync;
//   the next group's 16 table loads are issued in the source before the
//   current group's chain;
// - the slots go to a shared staging row of the chunk (padded against
//   bank conflicts) and leave as 16-byte stores, 64 contiguous bytes a
//   chunk and store instruction;
// - the step is F2's: the renorm as a select into a new register, the
//   shift a wrap-mode funnel shift, x + bias off the chain.
// It takes 0.274 ms, 67 ns a step, on the same card: ptxas runs a
// group's 16 chain steps, then its shuffles, table loads and slot
// stores, in series (PERF.md). A design with the feed in a warp of its
// own (two warps a block, one __syncthreads a group) took 0.341 ms.
//
// Output: final states [C,4] u32, per-lane renorm counts [C,4], and the
// slots in emission order (reversed steps x reversed lanes) as
// vm[C,16384] = flag<<16 | lo<<8 | hi -- the vm of _ans0_encode_impl.
// ---------------------------------------------------------------------

constexpr int kEncChunks = 8;                // chunks per block: one warp
constexpr int kGroup = 16;                   // steps per 16-byte word
constexpr int kGroups = kSteps / kGroup;
constexpr int kStageStride = 4 * kGroup + 4; // ints; padded: no bank
                                             // conflict on the stores

// A group's 16 encode words of this thread's lane: word j of the
// chunk's 4 (held by the chunk's thread j) carries steps 4j .. 4j+3,
// lane l's symbol of step 4j + k at byte 3 - l of its 32-bit word 3 - k.
__device__ __forceinline__ void ans0_lookup(const uint4& w, int tid,
                                            int byte_shift,
                                            const uint2* __restrict__ tab,
                                            uint2 (&e)[kGroup]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int from = (tid & ~3) | j;
    const uint32_t wd[4] = {__shfl_sync(0xFFFFFFFFu, w.x, from),
                            __shfl_sync(0xFFFFFFFFu, w.y, from),
                            __shfl_sync(0xFFFFFFFFu, w.z, from),
                            __shfl_sync(0xFFFFFFFFu, w.w, from)};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      e[4 * j + k] = tab[(wd[3 - k] >> byte_shift) & 0xFF];
  }
}

__global__ void __launch_bounds__(kEncChunks * 4)
ans0_encode_scan_kernel(const uint8_t* __restrict__ chunks,
                        const uint32_t* __restrict__ packed,
                        const uint32_t* __restrict__ inv, int n_chunks,
                        uint32_t* __restrict__ states,
                        int32_t* __restrict__ vm,
                        int32_t* __restrict__ nren) {
  __shared__ uint2 s_tab[kEncChunks][256];
  __shared__ __align__(16) int32_t s_stage[kEncChunks][kStageStride];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kEncChunks;
  for (int i = tid; i < kEncChunks * 256; i += 32) {
    const int g = i >> 8, sym = i & 255;
    const size_t c = (size_t)min(c0 + g, n_chunks - 1);
    const uint32_t pk = packed[c * 256 + sym];
    s_tab[g][sym] = make_uint2(
        inv[c * 256 + sym],
        ((pk & 0xF) - 1) | (pk >> 16) << 5 | ((pk >> 4) & 0xFFF) << 18);
  }
  __syncwarp();

  const int g = tid >> 2;
  const int lane = tid & 3;
  const int c = c0 + g;
  const bool live = c < n_chunks;    // the rest compute on the last chunk
  const uint4* src = reinterpret_cast<const uint4*>(
      chunks + (size_t)min(c, n_chunks - 1) * kChunk);
  const uint2* tab = s_tab[g];
  const int byte_shift = 24 - 8 * lane;
  int32_t* stage = s_stage[g] + 3 - lane;
  int4* out = reinterpret_cast<int4*>(vm + (size_t)c * kChunk);
  // group G (steps 16G .. 16G+15) reads the chunk's bytes
  // [16384 - 64(G+1), 16384 - 64G), its 16-byte words 1023 - 4G - j for
  // j = 0..3; thread `lane` loads word j = lane
  const uint4 zero = make_uint4(0, 0, 0, 0);
  uint4 w1 = src[kChunk / 16 - 5 - lane];
  uint4 w2 = src[kChunk / 16 - 9 - lane];
  uint2 cur[kGroup], nxt[kGroup];
  ans0_lookup(src[kChunk / 16 - 1 - lane], tid, byte_shift, tab, cur);
  uint32_t st = kAnsTop;
  int32_t cnt = 0;
  for (int grp = 0; grp < kGroups; ++grp) {
    const uint4 w3 = grp + 3 < kGroups
        ? src[kChunk / 16 - 1 - 4 * (grp + 3) - lane] : zero;
    ans0_lookup(w1, tid, byte_shift, tab, nxt);
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const uint32_t h = cur[k].y;
      const uint32_t bias = (h >> 5) & 0x1FFFu;
      const uint32_t cmpl = h >> 18;
      const uint32_t xmax = (kScale - cmpl) << (31 - kLogRange);
      // x = st >= xmax ? st >> 16 : st as a select into a new register
      uint32_t x;
      asm("{\n\t.reg .pred p;\n\tsetp.ge.u32 p, %1, %2;\n\t"
          "selp.b32 %0, %3, %1, p;\n\t}"
          : "=r"(x) : "r"(st), "r"(xmax), "r"(st >> 16));
      // >> (shift - 1): the wrap-mode funnel shift reads h's low 5 bits
      const uint32_t qv = __funnelshift_r(__umulhi(x, cur[k].x), 0u, h);
      uint32_t nst;
      asm("mad.lo.u32 %0, %1, %2, %3;"
          : "=r"(nst) : "r"(qv), "r"(cmpl), "r"(x + bias));
      // flag<<16 | lo<<8 | hi at its emission-order place in the group;
      // x != st exactly where the lane renormalised
      const uint32_t flag = x != st ? 1u : 0u;
      stage[(kGroup - 1 - k) * 4] = (int32_t)__byte_perm(st, flag, 0x5401);
      cnt += (int32_t)flag;
      st = nst;
    }
    __syncwarp();
    // the group's 64 slots of each chunk: ints [16320 - 64G, 16384 - 64G)
    if (live) {
      const int4* s4 = reinterpret_cast<const int4*>(s_stage[g]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        out[kChunk / 4 - 16 * (grp + 1) + 4 * i + lane] = s4[4 * i + lane];
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kGroup; ++k) cur[k] = nxt[k];
    w1 = w2;
    w2 = w3;
  }
  if (live) {
    states[(size_t)c * 4 + lane] = st;
    nren[(size_t)c * 4 + lane] = cnt;
  }
}

// ---------------------------------------------------------------------
// B. Row compaction. One 512-thread block per row of 16384 slots: each
// thread loads its 8 int4 of the row up front (the row's 64 KiB all in
// flight at once, 128 KiB an SM at two blocks), slot j of vector
// k * 512 + tid. The slots are ranked in row order (k, warp, lane, slot):
// four ballots a vector give each lane the flagged slots of the lanes
// before it and its warp's total; warp 0 scans the 128 totals between
// two __syncthreads; every flagged slot stores its u16 (lo<<8 | hi,
// little-endian, so the bytes read hi, lo) at off16[row] + rank. This
// replaces the TPU's log-step butterfly and its row-by-row
// dynamic_update_slice scan.
//
// Bound: device-memory bandwidth (64 KiB read per row, the compacted
// payload written); the loads all in flight up front are what keep HBM
// busy.
// ---------------------------------------------------------------------

constexpr int kCompactThreads = 512;
constexpr int kCompactWarps = kCompactThreads / 32;
constexpr int kCompactVecs = kChunk / 4 / kCompactThreads;   // 8 a thread

__global__ void __launch_bounds__(kCompactThreads)
ans0_compact_rows_kernel(const int4* __restrict__ vm,
                         const int64_t* __restrict__ off16, int64_t total16,
                         uint16_t* __restrict__ out) {
  __shared__ __align__(16) int s_tot[kCompactVecs * kCompactWarps];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int4* src = vm + (size_t)row * (kChunk / 4) + tid;
  int4 x[kCompactVecs];
#pragma unroll
  for (int k = 0; k < kCompactVecs; ++k)
    x[k] = __ldg(src + k * kCompactThreads);
  const int64_t base = off16[row];

  const unsigned before = (1u << lane) - 1u;
  int rank[kCompactVecs];
#pragma unroll
  for (int k = 0; k < kCompactVecs; ++k) {
    const unsigned b0 = __ballot_sync(0xFFFFFFFFu, x[k].x & 0x10000);
    const unsigned b1 = __ballot_sync(0xFFFFFFFFu, x[k].y & 0x10000);
    const unsigned b2 = __ballot_sync(0xFFFFFFFFu, x[k].z & 0x10000);
    const unsigned b3 = __ballot_sync(0xFFFFFFFFu, x[k].w & 0x10000);
    rank[k] = __popc(b0 & before) + __popc(b1 & before) +
              __popc(b2 & before) + __popc(b3 & before);
    if (lane == 0)
      s_tot[k * kCompactWarps + warp] =
          __popc(b0) + __popc(b1) + __popc(b2) + __popc(b3);
  }
  __syncthreads();
  if (warp == 0) {   // exclusive scan of the 128 totals, 4 a lane
    const int4 t = reinterpret_cast<const int4*>(s_tot)[lane];
    const int sum = t.x + t.y + t.z + t.w;
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += y;
    }
    const int e = incl - sum;
    reinterpret_cast<int4*>(s_tot)[lane] =
        make_int4(e, e + t.x, e + t.x + t.y, e + t.x + t.y + t.z);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kCompactVecs; ++k) {
    int64_t dst = base + s_tot[k * kCompactWarps + warp] + rank[k];
    const int v[4] = {x[k].x, x[k].y, x[k].z, x[k].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (v[j] & 0x10000) {
        if (dst >= 0 && dst < total16) out[dst] = (uint16_t)(v[j] & 0xFFFF);
        ++dst;
      }
    }
  }
}

// ---------------------------------------------------------------------
// C. Decode. Four threads per chunk (one per rANS lane), 4 chunks a
// block of 16 threads (half a warp); a 4096-chunk batch runs as one
// wave (at most eight blocks an SM). A step of a lane: v = st & 4095,
// sym = f2s[v], (f, cum) = fc[sym], st = f * (st >> 12) + v - cum, and
// where st < 2^15 the lane takes a 16-bit pair of the payload: the lanes
// of a chunk take them in the order 3, 2, 1, 0 from one cursor, lane l
// the pair past those of the flagged lanes above it (a ballot). This
// replaces the TPU's boundary-bitmap + popcount rank scheme.
//
// The chunk's residue table (4 KiB) and its (f, cum) table (2 KiB,
// split at the load so that the multiply-add takes f as it comes) sit
// in shared memory. A step's chain: the byte load at (st & 4095 | the
// table's offset, one LOP3), the (f, cum) load, a subtract and a
// multiply-add, the compare, the ballot, the ballot's bits above the
// lane turned into the pair's permute selector by a byte table (a
// permute, no popcount), the pair's permute and the select.
//
// The payload comes from a ring of 512 bytes a chunk in shared memory
// (the chunks' words interleaved, so that a block's chunks read their
// windows from different banks; words 0 and 1 again past the end, so
// that a window needs one address), filled 128 bytes at a time, two
// 16-byte vectors a thread, from loads issued two fills ahead; a fill
// is due every 16 steps (at most 128 bytes) where the chunk has at most
// 384 bytes ahead of its cursor. The pay pointer is taken at any
// alignment: its vectors are read from the 16-byte boundary below it,
// only those that hold a byte of pay, and the bytes before pay or at or
// past n_pay are cleared at the fill, so a corrupt stream reads 0 there
// (and is caught by the caller's consumed != size check). A step reads
// its 8-byte window at the cursor from three ring words, funnel-shifted,
// off the chain: the pair is a byte permute of the window.
//
// The symbols of 16 steps go to a staging row of the chunk in shared
// memory (two rows, so a row is stored while the next fills) and leave
// as 16-byte stores, one a thread.
//
// Bound: the 4096-step dependent chain of each lane; the lanes of all
// chunks run side by side, about one warp's worth a scheduler at 4096
// chunks, so nothing hides a step's latency. Beside ptxas's stalls, a
// step waits on its two shared loads, longer where a warp's lanes
// conflict on the banks; the times of this and the other designs tried
// are in PERF.md.
// ---------------------------------------------------------------------

constexpr int kDecChunks = 4;           // chunks a block
constexpr int kDecThreads = 4 * kDecChunks;
constexpr unsigned kDecLanes = (1u << kDecThreads) - 1;   // its lanes
constexpr int kRingWords = 128;         // a chunk's ring: 512 bytes,
constexpr int kRingPad = 2;             // its words 0, 1 again past the
constexpr int kRingBytes = 4 * kRingWords;    // end
constexpr int kFillBytes = 128;         // a fill: 2 vectors a thread,
constexpr int kGroupSteps = 16;         // every 16 steps (a step takes
                                        // at most 8 bytes); the symbols
                                        // of 16 steps a row
constexpr int kStageBytes = 144;        // two 64-byte rows, padded: the
                                        // chunks' byte stores hit
                                        // different banks

struct DecSmem {
  uint8_t f2s[kDecChunks * kScale];                  // residue -> symbol
  uint2 fc[kDecChunks][256];                         // (f, cum)
  uint32_t ring[kRingWords + kRingPad][kDecChunks];  // payload words
  uint8_t stage[kDecChunks][kStageBytes];
};

// pay as 16-byte vectors from the boundary at or below it: byte p of
// pay is byte lo + p of the vectors; a vector is loaded only where it
// holds a byte of pay, [lo, hi), and the other bytes read 0
struct PayFeed {
  const uint4* vec;
  int64_t lo, hi;
  int64_t nvec;
};

// word k (bytes 4k .. 4k+3) of a vector, keeping its bytes in [a, z)
__device__ __forceinline__ uint32_t keep_bytes(uint32_t w, int k, int a,
                                               int z) {
  const uint32_t drop_lo = 8 * min(max(a - 4 * k, 0), 4);
  const uint32_t drop_hi = 8 * min(max(4 * k + 4 - z, 0), 4);
  return w & __funnelshift_lc(0u, 0xFFFFFFFFu, drop_lo) &
         __funnelshift_rc(0xFFFFFFFFu, 0u, drop_hi);
}

__device__ __forceinline__ uint4 pay_vector(const PayFeed& pf, int64_t j) {
  uint4 x = make_uint4(0u, 0u, 0u, 0u);
  if ((uint64_t)j < (uint64_t)pf.nvec) {
    x = __ldg(pf.vec + j);
    const int a = (int)min(max(pf.lo - 16 * j, (int64_t)0), (int64_t)16);
    const int z = (int)min(max(pf.hi - 16 * j, (int64_t)0), (int64_t)16);
    if (a > 0 || z < 16) {
      x.x = keep_bytes(x.x, 0, a, z);
      x.y = keep_bytes(x.y, 1, a, z);
      x.z = keep_bytes(x.z, 2, a, z);
      x.w = keep_bytes(x.w, 3, a, z);
    }
  }
  return x;
}

// vector q of the chunk's payload (its bytes 16q .. 16q+15) into the
// ring; `ring` points at the chunk's column
__device__ __forceinline__ void ring_store(uint32_t* ring, int q,
                                           const uint4& x) {
  const int w = 4 * (q & (kRingWords / 4 - 1));
  ring[(w + 0) * kDecChunks] = x.x;
  ring[(w + 1) * kDecChunks] = x.y;
  ring[(w + 2) * kDecChunks] = x.z;
  ring[(w + 3) * kDecChunks] = x.w;
  if (w == 0) {
    ring[kRingWords * kDecChunks] = x.x;
    ring[(kRingWords + 1) * kDecChunks] = x.y;
  }
}

// prmt.b32 with the whole selector (the intrinsic masks it)
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// (a & b) | c in one instruction
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b,
                                           uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__global__ void __launch_bounds__(kDecThreads)
ans0_decode_kernel(const uint8_t* __restrict__ f2s,
                   const uint32_t* __restrict__ fc,
                   const uint32_t* __restrict__ states,
                   const uint8_t* __restrict__ pay, int64_t n_pay,
                   const int64_t* __restrict__ off_bytes, int n_chunks,
                   uint8_t* __restrict__ out, int32_t* __restrict__ consumed) {
  __shared__ __align__(16) DecSmem sm;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kDecChunks;
  const int last = n_chunks - 1;

  // the tables, 8 16-byte loads in flight a thread; the chunks past the
  // last take the last one's, and compute on it without storing
  constexpr int kF2sVecs = kScale / 16;
  for (int i0 = tid; i0 < kDecChunks * kF2sVecs; i0 += 8 * kDecThreads) {
    uint4 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = i0 + kDecThreads * k;
      v[k] = __ldg(reinterpret_cast<const uint4*>(
          f2s + (size_t)min(c0 + i / kF2sVecs, last) * kScale) +
          i % kF2sVecs);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
      reinterpret_cast<uint4*>(sm.f2s)[i0 + kDecThreads * k] = v[k];
  }
  for (int i0 = tid; i0 < kDecChunks * 64; i0 += 8 * kDecThreads) {
    uint4 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = i0 + kDecThreads * k;
      v[k] = __ldg(reinterpret_cast<const uint4*>(
          fc + (size_t)min(c0 + i / 64, last) * 256) + i % 64);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = i0 + kDecThreads * k;
      uint2* d = sm.fc[i / 64] + 4 * (i % 64);
      d[0] = make_uint2(v[k].x & 0xFFF, v[k].x >> 12);
      d[1] = make_uint2(v[k].y & 0xFFF, v[k].y >> 12);
      d[2] = make_uint2(v[k].z & 0xFFF, v[k].z >> 12);
      d[3] = make_uint2(v[k].w & 0xFFF, v[k].w >> 12);
    }
  }

  const int g = tid >> 2;
  const int lane = tid & 3;
  const int c = min(c0 + g, last);
  const bool live = c0 + g <= last;
  uint32_t st = states[(size_t)c * 4 + lane];

  // the chunk's payload: vector j0 holds its first byte, at r; three
  // fills into the ring, the next two in flight (pa even, pb odd); the
  // chunk's thread `lane` takes vectors lane and lane + 4 of a fill
  PayFeed pf;
  const int sh = (int)(reinterpret_cast<uintptr_t>(pay) & 15);
  pf.vec = reinterpret_cast<const uint4*>(pay - sh);
  pf.lo = sh;
  pf.hi = sh + n_pay;
  pf.nvec = n_pay > 0 ? (pf.hi + 15) >> 4 : 0;
  const int64_t as = sh + off_bytes[c];
  const int r0 = (int)(as & 15);
  int64_t jn = (as >> 4) + lane;   // this thread's next vector to load
  uint32_t* ring = &sm.ring[0][g];
  int q = lane;                    // and its place in the chunk's vectors
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    ring_store(ring, q, pay_vector(pf, jn));
    ring_store(ring, q + 4, pay_vector(pf, jn + 4));
    q += 8;
    jn += 8;
  }
  uint4 pb0 = pay_vector(pf, jn), pb1 = pay_vector(pf, jn + 4);
  uint4 pa0 = pay_vector(pf, jn + 8), pa1 = pay_vector(pf, jn + 12);
  jn += 16;
  int filled = 3 * kFillBytes;     // bytes [0, filled) from j0 are in
  int r = r0;                      // the ring; r the cursor
  __syncthreads();

  const uint32_t tb = (uint32_t)g << 12;          // the residue table
  const uint8_t* f2t = sm.f2s;
  const uint2* fct = sm.fc[g];
  const unsigned mine = 0xFu << (4 * g);
  // the pair of lane l is pair k of the window, k the flagged lanes
  // above l: the ballot's bits 4g + l + 1 .. 4g + 3, a byte table from
  // those bits to the permute selector 0x01 + 0x22 k of pair k
  const uint32_t shift = 4 * g + lane + 1;
  const uint32_t bits = 7u >> lane;
  const uint32_t sel_lo = 0x45232301u, sel_hi = 0x67454523u;
  uint8_t* stage = sm.stage[g];
  uint4* dst = reinterpret_cast<uint4*>(out + (size_t)c * kChunk) + lane;
  for (int grp = 0; grp < kSteps / kGroupSteps; ++grp) {
    if (filled - r <= kRingBytes - kFillBytes) {
      if (q & 8) {
        ring_store(ring, q, pb0);
        ring_store(ring, q + 4, pb1);
        pb0 = pay_vector(pf, jn);
        pb1 = pay_vector(pf, jn + 4);
      } else {
        ring_store(ring, q, pa0);
        ring_store(ring, q + 4, pa1);
        pa0 = pay_vector(pf, jn);
        pa1 = pay_vector(pf, jn + 4);
      }
      q += 8;
      jn += 8;
      filled += kFillBytes;
    }
    __syncwarp(kDecLanes);
    uint8_t* row = stage + 64 * (grp & 1) + 3 - lane;
#pragma unroll
    for (int t = 0; t < kGroupSteps; ++t) {
      // the window: bytes r .. r+7 from the chunk's first vector
      const uint32_t* wp =
          ring + (((uint32_t)r >> 2) & (kRingWords - 1)) * kDecChunks;
      const uint32_t o = 8 * (r & 3);
      const uint32_t lo = __funnelshift_r(wp[0], wp[kDecChunks], o);
      const uint32_t hi = __funnelshift_r(wp[kDecChunks],
                                          wp[2 * kDecChunks], o);
      const uint32_t v = st & kMask;
      const uint32_t sym = f2t[and_or(st, kMask, tb)];
      const uint2 e = fct[sym];
      st = e.x * (st >> kLogRange) + (v - e.y);
      const bool flag = st < kAnsTop;
      const unsigned bal = __ballot_sync(kDecLanes, flag);
      const uint32_t pair =
          prmt(lo, hi, prmt(sel_lo, sel_hi, (bal >> shift) & bits));
      st = flag ? __byte_perm(pair, st, 0x5410) : st;
      r += 2 * __popc(bal & mine);
      row[4 * t] = (uint8_t)sym;
    }
    __syncwarp(kDecLanes);
    if (live)
      dst[4 * grp] = reinterpret_cast<const uint4*>(stage +
                                                    64 * (grp & 1))[lane];
  }
  if (live && lane == 0) consumed[c] = r - r0;
}

}  // namespace

extern "C" {

const char* kanzi_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int ans0_encode_scan(const void* chunks, const void* packed, const void* inv,
                     int n_chunks, void* states, void* vm, void* nren,
                     int device, void* stream) {
  cudaSetDevice(device);
  if (n_chunks > 0) {
    ans0_encode_scan_kernel<<<(n_chunks + kEncChunks - 1) / kEncChunks,
                              kEncChunks * 4, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)chunks, (const uint32_t*)packed,
        (const uint32_t*)inv, n_chunks, (uint32_t*)states, (int32_t*)vm,
        (int32_t*)nren);
  }
  return (int)cudaGetLastError();
}

int ans0_compact(const void* vm, const void* off16, int n_rows,
                 int64_t total16, void* out, int device, void* stream) {
  cudaSetDevice(device);
  if (n_rows > 0) {
    ans0_compact_rows_kernel<<<n_rows, kCompactThreads, 0,
                               (cudaStream_t)stream>>>(
        (const int4*)vm, (const int64_t*)off16, total16, (uint16_t*)out);
  }
  return (int)cudaGetLastError();
}

int ans0_decode(const void* f2s, const void* fc, const void* states,
                const void* pay, int64_t n_pay, const void* off_bytes,
                int n_chunks, void* out, void* consumed, int device,
                void* stream) {
  cudaSetDevice(device);
  if (n_chunks > 0) {
    ans0_decode_kernel<<<(n_chunks + kDecChunks - 1) / kDecChunks,
                         kDecThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)f2s, (const uint32_t*)fc, (const uint32_t*)states,
        (const uint8_t*)pay, n_pay, (const int64_t*)off_bytes, n_chunks,
        (uint8_t*)out, (int32_t*)consumed);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
