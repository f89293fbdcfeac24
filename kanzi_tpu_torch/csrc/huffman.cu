// Canonical-Huffman (4-fragment) kernels for Hopper (sm_90a).
//
// Bit-exact with kanzi_tpu/ops/huffman.py and the reference coder
// (src/entropy/Huffman{Encoder,Decoder}.cpp): a 16 KiB chunk splits into 4
// fragments of 4096 symbols, each its own MSB-first bitstream of codes of
// at most 12 bits. Each kernel has an extern "C" launcher that takes the
// caller's CUDA stream, launches, and returns cudaGetLastError(). Outputs
// are allocated by the caller.
//
// D. huff_pack <- kanzi_tpu/ops/ans.py _gather_kernel1 (:145),
//    called from kanzi_tpu/ops/huffman.py:175, the fragment lax.scan of
//    huffman_encode_chunks (:181-198) and the compaction of its pairs;
//    its prologue, huff_code_tables, builds the code tables that the JAX
//    package leaves to XLA (compute_code_tables,
//    kanzi_tpu/ops/huffman.py:98-152) and counts each fragment's bits.
// E. huff_decode      <- kanzi_tpu/ops/huffman.py _huff_decode_kernel (:317).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16384;
constexpr int kFrag = kChunk / 4;
constexpr int kTable = 1 << 12;   // 12-bit prefix table

// ---------------------------------------------------------------------
// D, prologue: the code tables and each fragment's bit count, in three
// kernels, so that the sequential part runs apart from the parallel
// ones, as F's chain does.
//
// 1. Ranks: one block of 256 threads per chunk, thread s owning symbol s.
//    The ranks of the (freq << 8 | sym) keys come from 256 compares per
//    thread (the keys of present symbols are distinct), which replaces
//    the batched sort. The keys by rank go to `sizes` (scratch here).
// 2. Lengths: Moffat-Katajainen (HuffmanEncoder.cpp:246-300) is
//    sequential by nature: phase 1 is 2(m-1) dependent steps, phase 2
//    touches each rank O(1) times. One thread runs both phases for one
//    chunk, the chunks of 32 threads packed in a warp, each on its own
//    column of shared memory ([rank][thread]: no bank conflict). A first
//    design ran them on thread 0 of the chunk's 256-thread block, so each
//    block sat idle through them: the prologue took 0.465 ms at 4096
//    chunks, more than the pack, on an H100 80GB HBM3 at 700 W (PERF.md).
//    A chunk whose code runs past 12 bits then has its lengths limited
//    in the same thread, by the reference's bit-debt repayment
//    (HuffmanEncoder.cpp:129-215, ops/huffman.py _repay_debt) and, where
//    debt is left, its slow path (_slow_path_lengths): the counts
//    renormalised to 2048, ranked again by an insertion sort, new
//    lengths, 8 bits each if those still pass 12. About half of the
//    corpus's chunks need the limit; before, the host coded them one at
//    a time. The lengths by rank go to `codes` (scratch here); a chunk of
//    the slow path writes its new keys by rank over `sizes`.
// 3. Codes: one block per chunk again. The canonical codes are the
//    per-length counting construction of compute_code_tables, each
//    symbol's rank among the same length in symbol order from
//    __match_any_sync and per-warp counts. Last, a short pass
//    over the chunk's 16 KiB (64 bytes a thread) sums the code lengths of
//    each fragment: its bit count, from which the pack's offsets follow.
//
// Bound: the 256 rank compares a symbol (operations), and the lengths'
// dependent chain of ~2m shared-memory steps a chunk, 4096 chunks in
// parallel.
// ---------------------------------------------------------------------

constexpr int kMaxSym = 12;
constexpr int32_t kAbsentFreq = 0x7FFFFF;   // (2^31 - 1) >> 8, as the sort's
constexpr int kLenChunks = 32;              // lengths: chunks per block

__global__ void __launch_bounds__(256)
huff_ranks_kernel(const int64_t* __restrict__ hist,
                  int32_t* __restrict__ keys_out,
                  int32_t* __restrict__ m_out) {
  __shared__ uint32_t s_key[256];
  const int c = blockIdx.x;
  const int sym = threadIdx.x;
  const int64_t f = hist[(size_t)c * 256 + sym];
  const bool present = f > 0;
  const uint32_t key = present ? ((uint32_t)f << 8) | (uint32_t)sym
                               : 0xFFFFFFFFu;
  s_key[sym] = key;
  __syncthreads();
  int rank = 0, m = 0;
  for (int j = 0; j < 256; ++j) {
    const uint32_t kj = s_key[j];
    rank += kj < key;
    m += kj != 0xFFFFFFFFu;
  }
  int32_t* keys = keys_out + (size_t)c * 256;
  if (present) keys[rank] = (int32_t)key;
  if (sym >= m) keys[sym] = kAbsentFreq << 8;
  if (sym == 0) m_out[c] = m;
}

// A thread's column of the lengths kernel's shared memory: entry i of
// its chunk at s[i][t], so that the 32 threads of a warp hit 32 banks.
typedef int32_t LenCol[kLenChunks];

// Moffat-Katajainen on the column: the m frequencies by rank (ascending)
// in, the lengths by rank out
__device__ void mk_lengths(LenCol* s, int t, int m) {
#define D(i) s[(i)][t]
  // phase 1: in-place tree build (entropy/huffman.py
  // _compute_inplace_phase1)
  int sp = 0, r = 0;
  for (int it = 0; it < m - 1; ++it) {
    int32_t total = 0;
    for (int k = 0; k < 2; ++k) {
      const int32_t dr = D(min(r, 255));
      const int32_t ds = D(min(sp, 255));
      const bool use_r = sp >= m || (r < it && dr < ds);
      total += use_r ? dr : ds;
      if (use_r) {
        D(min(r, 255)) = it;
        ++r;
      } else {
        if (sp > it) D(min(sp, 255)) = 0;
        ++sp;
      }
    }
    D(it) = total;
  }
  // phase 2: internal-node depths -> leaf lengths, as the batched plain
  // version runs it (at most 64 levels; m == 1 gives length 1)
  int nn = m, top = m - 2, depth = 1, nal = 2;
  for (int it = 0; it < 64 && nn > 0; ++it) {
    int k = top > 0 ? top : 0;
    while (k > 0 && D(k - 1) >= top) --k;
    const int internal = top - k;
    const int newn = nn - (nal - internal);
    for (int i = max(newn, 0); i < min(nn, 256); ++i) D(i) = depth;
    nn = newn;
    top = k;
    ++depth;
    nal = 2 * internal;
  }
#undef D
}

// The bit-debt repayment on the column's m lengths by rank, the first
// over 12 (ops/huffman.py _repay_debt): the reference's six lists of
// ranks are runs of consecutive ranks, since the lengths fall with the
// rank, each kept as [head, end). Returns the debt left.
__device__ int repay_debt(LenCol* s, int t, int m) {
#define D(i) s[(i)][t]
  int n = 0, debt = 0;
  for (; n < m && D(n) >= kMaxSym; ++n) {
    debt += D(n) - kMaxSym;
    D(n) = kMaxSym;
  }
  int head[6], end[6];
  for (int i = 0; i < 6; ++i) head[i] = end[i] = n;
  for (; n < m; ++n) {
    const int idx = kMaxSym - 1 - D(n);
    if (idx > 5 || debt < (1 << idx)) break;
    if (head[idx] == end[idx]) head[idx] = n;
    end[idx] = n + 1;
  }
  for (int idx = 5; idx >= 0; --idx) {
    for (; debt >= (1 << idx) && head[idx] < end[idx]; ++head[idx]) {
      ++D(head[idx]);
      debt -= 1 << idx;
    }
  }
  for (int idx = 0; idx < 6; ++idx) {
    for (; debt > 0 && head[idx] < end[idx]; ++head[idx]) {
      ++D(head[idx]);
      debt -= 1 << idx;
    }
  }
  return debt;
#undef D
}

constexpr int64_t kLimitScale = kChunk >> 3;   // the slow path's total

// The slow path of the limit (ops/huffman.py _slow_path_lengths): the
// chunk's counts h renormalised to kLimitScale as normalize_freqs does
// (native/transforms.cpp, EntropyUtils::normalizeFrequencies; m > 1
// here), the new (freq << 8 | sym) keys sorted into keys[0..m) and the
// column, then new lengths on the column, 8 bits each past 12.
__device__ void slow_path_lengths(LenCol* s, int t, int m,
                                  const int64_t* __restrict__ h,
                                  int32_t* __restrict__ keys) {
#define D(i) s[(i)][t]
  int64_t total = 0;
  for (int i = 0; i < 256; ++i) total += h[i];
  int64_t sum_scaled = 0;
  int idx_max = 0;
  for (int i = 0; i < 256; ++i) {
    const int64_t sf = h[i] * kLimitScale;
    const int32_t scaled = h[i] == 0 ? 0
        : (int32_t)(total == kLimitScale ? h[i]
                    : sf <= total ? 1 : (sf + (total >> 1)) / total);
    D(i) = scaled;
    sum_scaled += scaled;
    if (scaled > D(idx_max)) idx_max = i;
  }
  if (total != kLimitScale && sum_scaled != kLimitScale) {
    int64_t delta = sum_scaled - kLimitScale;
    const int64_t thr = D(idx_max) >> 4;
    if ((delta < 0 ? -delta : delta) <= thr) {
      D(idx_max) -= (int32_t)delta;
    } else {
      D(idx_max) += (int32_t)(delta < 0 ? thr : -thr);
      delta += delta < 0 ? thr : -thr;
      const int inc = delta < 0 ? 1 : -1;
      delta = delta < 0 ? -delta : delta;
      for (int rnd = 0; rnd < 5 && delta > 0; ++rnd) {
        int adjustments = 0;
        for (int i = 0; i < 256 && delta > 0; ++i) {
          if (D(i) <= 2) continue;
          D(i) += inc;
          ++adjustments;
          --delta;
        }
        if (adjustments == 0) break;
      }
      D(idx_max) = (int32_t)max((int64_t)D(idx_max) - delta, (int64_t)1);
    }
  }
  // the keys of the present symbols, in place (j <= i), then sorted
  int j = 0;
  for (int i = 0; i < 256; ++i)
    if (D(i) > 0) D(j++) = (D(i) << 8) | i;
  for (int i = 1; i < m; ++i) {
    const int32_t k = D(i);
    int p = i;
    for (; p > 0 && D(p - 1) > k; --p) D(p) = D(p - 1);
    D(p) = k;
  }
  for (int i = 0; i < m; ++i) {
    keys[i] = D(i);
    D(i) >>= 8;
  }
  mk_lengths(s, t, m);
  if (D(0) > kMaxSym)
    for (int i = 0; i < m; ++i) D(i) = 8;
#undef D
}

__global__ void __launch_bounds__(kLenChunks)
huff_lengths_kernel(int32_t* __restrict__ keys,
                    const int32_t* __restrict__ m_in,
                    const int64_t* __restrict__ hist, int n_chunks,
                    int32_t* __restrict__ lens_out) {
  __shared__ int32_t s_d[256][kLenChunks];
  const int t = threadIdx.x;
  const int c = blockIdx.x * kLenChunks + t;
  if (c >= n_chunks) return;
  int32_t* ck = keys + (size_t)c * 256;
  for (int i = 0; i < 256; ++i) s_d[i][t] = ck[i] >> 8;
  const int m = m_in[c];
  mk_lengths(s_d, t, m);
  // the length limit: rank 0 has the longest code
  if (m > 1 && s_d[0][t] > kMaxSym && repay_debt(s_d, t, m) > 0)
    slow_path_lengths(s_d, t, m, hist + (size_t)c * 256, ck);
  for (int i = 0; i < 256; ++i) lens_out[(size_t)c * 256 + i] = s_d[i][t];
}

// codes: lengths by rank in, packed len<<12 | code by symbol out; sizes:
// keys by rank in, lengths by symbol out
__global__ void __launch_bounds__(256)
huff_codes_kernel(const uint8_t* __restrict__ chunks,
                  const int64_t* __restrict__ hist,
                  const int32_t* __restrict__ m_in,
                  uint32_t* __restrict__ codes,
                  int32_t* __restrict__ sizes,
                  int32_t* __restrict__ maxlen_out,
                  uint8_t* __restrict__ ok_out,
                  int32_t* __restrict__ bits_out) {
  __shared__ int32_t s_size[256];              // length by symbol
  __shared__ uint32_t s_code[256];
  __shared__ int32_t s_count[16];
  __shared__ int32_t s_first[kMaxSym + 2];
  __shared__ int32_t s_wcnt[8][16];            // per warp, per length
  __shared__ int32_t s_maxlen;
  __shared__ int32_t s_bits[4];
  const int c = blockIdx.x;
  const int sym = threadIdx.x;
  const int warp = sym >> 5;
  const int lane = sym & 31;
  const size_t o = (size_t)c * 256 + sym;
  const int m = m_in[c];
  const int32_t key_r = sizes[o];              // rank `sym`
  const int32_t len_r = (int32_t)codes[o];
  s_size[sym] = 0;
  if (sym < 16) s_count[sym] = 0;
  if (sym < 8 * 16) s_wcnt[sym >> 4][sym & 15] = 0;
  if (sym < 4) s_bits[sym] = 0;
  if (sym == 0) s_maxlen = 0;
  __syncthreads();
  if (sym < m) {
    s_size[key_r & 0xFF] = len_r;
    atomicMax(&s_maxlen, len_r);
  }
  __syncthreads();

  const bool present = hist[o] > 0;
  const int32_t size = s_size[sym];
  const int ln = present ? min(size, kMaxSym + 1) : kMaxSym + 1;
  if (present) atomicAdd(&s_count[ln], 1);
  // the rank among the present symbols of the same length, in symbol order
  const int ln_key = present && ln <= kMaxSym ? ln : 15;
  const unsigned same_w = __match_any_sync(0xFFFFFFFFu, ln_key);
  if (lane == __ffs(same_w) - 1) s_wcnt[warp][ln_key] = __popc(same_w);
  __syncthreads();
  if (sym == 0) {
    int32_t first = 0;
    s_first[0] = 0;
    for (int l = 0; l <= kMaxSym; ++l) {
      first = (first + s_count[l]) << 1;
      s_first[l + 1] = first;
    }
  }
  __syncthreads();
  int32_t same = 0;
  if (ln_key <= kMaxSym) {
    same = __popc(same_w & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) same += s_wcnt[w][ln_key];
  }
  const uint32_t code = present
      ? ((uint32_t)ln << 12) | (uint32_t)(s_first[ln] + same) : 0u;
  codes[o] = code;
  sizes[o] = size;
  if (sym == 0) {
    maxlen_out[c] = s_maxlen;
    ok_out[c] = m > 1 && s_maxlen <= kMaxSym;
  }

  // the bit count of each fragment: thread i sums the lengths (code >> 12,
  // as the pack reads them) of bytes 64i .. 64i+63, fragment i / 64
  s_code[sym] = code;
  __syncthreads();
  const uint4* src = reinterpret_cast<const uint4*>(chunks + (size_t)c * kChunk)
                     + sym * 4;
  int32_t bits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint4 w = src[k];
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int b = 0; b < 16; ++b)
      bits += (int32_t)(s_code[(ws[b >> 2] >> (8 * (b & 3))) & 0xFF] >> 12);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) bits += __shfl_xor_sync(0xFFFFFFFFu, bits, d);
  if (lane == 0) atomicAdd(&s_bits[sym >> 6], bits);
  __syncthreads();
  if (sym < 4) bits_out[(size_t)c * 4 + sym] = s_bits[sym];
}

// ---------------------------------------------------------------------
// D. Encode: pack the fragments' codes into the pair stream. One block of
// 4 warps per chunk, one warp per fragment; the chunk's 256-entry
// len<<12 | code table sits in shared memory, so the gather that the TPU
// ran as a separate 128-lane split-table pass is one shared load per
// symbol.
//
// Lane i takes symbols 128i .. 128i+127 (eight 16-byte loads, kept in
// registers) and sums their lengths; an exclusive warp scan
// (__shfl_up_sync) gives its first bit. It then writes its codes into the
// fragment's big-endian bit image in shared memory (at most 13 bits a
// symbol: 6.5 KiB) through a 64-bit buffer, a 32-bit word at a time: a
// plain store for the words it owns alone, atomicOr for the first and
// last, which it may share with its neighbours. For an ok chunk the warp
// then stores the fragment's whole 16-bit pairs in payload order (hi, lo)
// at byte 2 * off16 of flat, 32 consecutive pairs a store. Every row gets
// nb = bits & 15 and acc = the last nb bits of the image, the values the
// plain version's per-step accumulator ends with (it holds exactly the
// pending bits: a code is shorter than 2^len, and len <= 13); npairs is
// bits >> 4 for an ok chunk and 0 otherwise, and only ok chunks write
// pairs. The first
// design ran one thread per fragment and wrote a 4-byte slot for every
// symbol (4x the input, uncoalesced) for kernel B to pack.
//
// Bound: the bytes (16 KiB read and ~13 KiB of pairs written a chunk on
// this corpus), and the lanes' 128-symbol walks, which run in parallel.
// 27 KiB of shared memory a block: 8 blocks (32 warps) an SM.
// ---------------------------------------------------------------------

constexpr int kPackWarps = 4;                        // a block: one chunk
constexpr int kLaneSyms = kFrag / 32;                // 128
constexpr int kImgWords = kFrag * (kMaxSym + 1) / 32 + 2;

__global__ void __launch_bounds__(kPackWarps * 32)
huff_pack_kernel(const uint8_t* __restrict__ chunks,
                 const uint32_t* __restrict__ codes,
                 const uint8_t* __restrict__ ok,
                 const int64_t* __restrict__ off16,
                 uint16_t* __restrict__ flat,
                 uint32_t* __restrict__ acc_out,
                 int32_t* __restrict__ nb_out,
                 int32_t* __restrict__ npairs_out) {
  __shared__ uint32_t s_code[256];
  __shared__ uint32_t s_img[kPackWarps][kImgWords];
  const int c = blockIdx.x;
  const int f = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    s_code[i] = codes[(size_t)c * 256 + i];
  uint32_t* img = s_img[f];
  for (int i = lane; i < kImgWords; i += 32) img[i] = 0u;
  __syncthreads();

  const uint4* src = reinterpret_cast<const uint4*>(
      chunks + (size_t)c * kChunk + f * kFrag + lane * kLaneSyms);
  uint32_t w[kLaneSyms / 4];
#pragma unroll
  for (int k = 0; k < kLaneSyms / 16; ++k) {
    const uint4 v = src[k];
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
  int my = 0;
#pragma unroll
  for (int b = 0; b < kLaneSyms; ++b)
    my += (int)(s_code[(w[b >> 2] >> (8 * (b & 3))) & 0xFF] >> 12);
  int incl = my;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += t;
  }
  const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
  const int b0 = incl - my;

  // this lane's bits [b0, b0 + my) into the image, MSB first
  uint64_t buf = 0;
  int nbuf = b0 & 31;           // leading bits of the first word: not ours
  int wi = b0 >> 5;
  bool shared_first = (b0 & 31) != 0;
#pragma unroll
  for (int b = 0; b < kLaneSyms; ++b) {   // unrolled: w stays in registers
    const uint32_t x = s_code[(w[b >> 2] >> (8 * (b & 3))) & 0xFF];
    const int ln = (int)(x >> 12);
    buf = (buf << ln) | (x & 0xFFFu);
    nbuf += ln;
    if (nbuf >= 32) {
      nbuf -= 32;
      const uint32_t word = (uint32_t)(buf >> nbuf);
      buf &= (1ull << nbuf) - 1ull;
      if (shared_first) atomicOr(&img[wi], word);
      else img[wi] = word;
      shared_first = false;
      ++wi;
    }
  }
  if (nbuf > 0) atomicOr(&img[wi], (uint32_t)(buf << (32 - nbuf)));
  __syncwarp();

  const size_t r = (size_t)c * 4 + f;
  const int nb = total & 15;
  const bool live = ok[c] != 0;
  if (live) {
    uint16_t* dst = flat + off16[r];
    const int np = total >> 4;
    for (int p = lane; p < np; p += 32) {
      const uint32_t word = img[p >> 1];
      const uint32_t v = (p & 1) ? word & 0xFFFFu : word >> 16;
      dst[p] = (uint16_t)((v >> 8) | ((v & 0xFFu) << 8));   // bytes hi, lo
    }
  }
  if (lane == 0) {
    uint32_t acc = 0;
    if (nb) {
      const int start = total - nb;
      const uint64_t win = ((uint64_t)img[start >> 5] << 32) |
                           img[(start >> 5) + 1];
      acc = (uint32_t)(win >> (64 - (start & 31) - nb)) & ((1u << nb) - 1u);
    }
    acc_out[r] = acc;
    nb_out[r] = nb;
    npairs_out[r] = live ? total >> 4 : 0;
  }
}

// ---------------------------------------------------------------------
// E. Decode. One thread per fragment, 4 per chunk; a block takes the
// chunks of one SM's share of a wave, at most kDecMaxChunks, so that a
// batch of one 4 MiB block (~240 chunks) spreads over the SMs and 3840
// chunks take two waves.
//
// A fragment's bits sit in a 64-bit buffer, MSB first, holding 33-64 of
// them: the 12-bit index is its top 12 bits, a step shifts it left by
// the code's length, and where 32 bits or fewer are left the next stream
// word goes in below them, through selects: no lane branches. The bits
// it adds lie below the top 12 bits (at least 18 are left), so the next
// index is taken before them and never waits for the refill.
//
// Each chunk's table (decode_table: sym | len<<8, 8 KiB) is split in the
// prologue into a length table and a symbol table of 4 KiB each, one
// after the other in shared memory, so that a step's chain is one byte
// load at an address one LEA.HI from the bit buffer, a funnel shift, and
// the next address; the symbol's load takes the same address.
//
// The stream's words come from a ring in shared memory, 64 words a lane
// (the lanes interleaved word by word, so that each lane keeps to its
// own bank): every 64 steps a lane whose buffer has left one half of its
// ring fills that half with 32 words loaded 16 bytes at a time one fill
// before, byte-swapped and with the bytes at or past the fragment's end
// (or the payload's) cleared. No load leaves the payload. A step reads
// the ring at the buffer's next word (one shared load off the chain); 64
// steps take at most 30 words, so the ring never runs dry. A first design
// loaded each word from global memory one word ahead: the warp's
// scoreboard made every step wait for the slowest lane's load, ~154
// cycles a step against ~69 here (PERF.md).
//
// Bound: the 4096-step chain of each fragment (a shared load and two
// integer operations a step); the fragments run side by side. The
// symbols go out 16 bytes at a time.
// ---------------------------------------------------------------------

constexpr int kDecMaxChunks = 24;               // chunks a block at most
constexpr int kDecTables = 2 * kTable;          // a chunk's lengths, symbols
constexpr int kRingWords = 64;                  // a lane's ring: 2 halves
constexpr int kFillWords = kRingWords / 2;      // of 32 words
constexpr int kFillSteps = 64;                  // steps between fills
constexpr int64_t kFarBytes = 1 << 16;          // past any byte a
                                                // fragment's decode reads

// the threads of a block of per_block chunks: a multiple of 32 (those
// past 4 * per_block only help load the tables), and the lane stride of
// the rings, so that lane L's words all sit in bank L % 32
__host__ __device__ constexpr int dec_threads(int per_block) {
  return (4 * per_block + 31) & ~31;
}

constexpr int kDecMaxThreads = dec_threads(kDecMaxChunks);

__host__ __device__ constexpr int dec_smem(int per_block) {
  return per_block * kDecTables + 4 * kRingWords * dec_threads(per_block);
}

// A fragment's stream from the 16-byte vector holding its first byte:
// vector v at p[v], loaded where v - lo < span (unsigned: none before
// the payload, none wholly at or past the end), and the bits from the
// stream's word 0 to the end.
struct FragFeed {
  const uint4* p;
  int lo;
  uint32_t span;
  int tb;
};

// the 32 words from word f of the stream into pf, 16 bytes a load
__device__ __forceinline__ void feed_load(const FragFeed& fd, int f,
                                          uint4 (&pf)[kFillWords / 4]) {
#pragma unroll
  for (int k = 0; k < kFillWords / 4; ++k) {
    const int v = f / 4 + k;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    asm("{\n\t.reg .pred q;\n\tsetp.lt.u32 q, %5, %6;\n\t"
        "@q ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n\t}"
        : "+r"(x.x), "+r"(x.y), "+r"(x.z), "+r"(x.w)
        : "l"(fd.p + v), "r"((uint32_t)(v - fd.lo)), "r"(fd.span));
    pf[k] = x;
  }
}

// pf (words f .. f + 31) into the lane's half of the ring, big-endian,
// the bytes at or past the end cleared where the half reaches it
__device__ __forceinline__ void feed_store(const FragFeed& fd, int f,
                                           const uint4 (&pf)[kFillWords / 4],
                                           uint32_t* ring, int stride) {
  const bool whole = 32 * (f + kFillWords) <= fd.tb;
#pragma unroll
  for (int k = 0; k < kFillWords / 4; ++k) {
    const uint32_t x[4] = {pf[k].x, pf[k].y, pf[k].z, pf[k].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = f + 4 * k + j;
      uint32_t wd = __byte_perm(x[j], 0, 0x0123);
      if (!whole)     // keep the bits below the end: min(t, 32) of them
        wd &= ~__funnelshift_rc(0xFFFFFFFFu, 0u,
                                (uint32_t)max(fd.tb - 32 * n, 0));
      ring[(n & (kRingWords - 1)) * stride] = wd;
    }
  }
}

__global__ void __launch_bounds__(kDecMaxThreads)
huff_decode_kernel(const uint16_t* __restrict__ tbl,
                   const uint8_t* __restrict__ pay, int64_t n_pay,
                   const int64_t* __restrict__ bounds, int n_chunks,
                   int per_block, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t s_dec[];   // [per_block][2][4096]
  const int stride = blockDim.x;
  uint32_t* ring = reinterpret_cast<uint32_t*>(s_dec + per_block *
                                               kDecTables) + threadIdx.x;
  const int c0 = blockIdx.x * per_block;
  const int n_here = min(per_block, n_chunks - c0);

  // the fragment's stream: two fills into the ring, the third in flight
  const int g = threadIdx.x >> 2;
  const int c = c0 + g;
  const bool live = g < n_here;
  const int64_t r = (int64_t)(live ? c : 0) * 4 + (threadIdx.x & 3);
  const int64_t s = max(bounds[r], -kFarBytes);
  const int64_t vs = s >> 4;                   // the vector holding byte s
  int64_t e = min(bounds[r + 1], n_pay);
  if (e < s) e = 16 * vs;                      // no byte: no vector from vs
  FragFeed fd;
  fd.p = reinterpret_cast<const uint4*>(pay) + vs;
  fd.lo = (int)max(-vs, (int64_t)0);
  fd.span = (uint32_t)min(max((e + 15) / 16 - vs - fd.lo, (int64_t)0),
                          kFarBytes);
  fd.tb = (int)min(8 * (e - 16 * vs), 8 * kFarBytes);
  uint4 pf[kFillWords / 4];
  if (live) {
    feed_load(fd, 0, pf);
    feed_store(fd, 0, pf, ring, stride);
    feed_load(fd, kFillWords, pf);
  }

  // the tables: each 16-byte load of 8 entries splits into their
  // lengths (& 15: decode_table's are at most 12) and their symbols
  const uint4* src = reinterpret_cast<const uint4*>(tbl + (size_t)c0 * kTable);
  const int n_vec = n_here * (kTable / 8);
  for (int i0 = threadIdx.x; i0 < n_vec; i0 += 8 * blockDim.x) {
    uint4 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = i0 + k * blockDim.x;
      v[k] = i < n_vec ? __ldg(src + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = i0 + k * blockDim.x;
      if (i < n_vec) {
        uint8_t* t = s_dec + (i >> 9) * kDecTables + 8 * (i & 511);
        *reinterpret_cast<uint2*>(t) = make_uint2(
            __byte_perm(v[k].x, v[k].y, 0x7531) & 0x0F0F0F0Fu,
            __byte_perm(v[k].z, v[k].w, 0x7531) & 0x0F0F0F0Fu);
        *reinterpret_cast<uint2*>(t + kTable) = make_uint2(
            __byte_perm(v[k].x, v[k].y, 0x6420),
            __byte_perm(v[k].z, v[k].w, 0x6420));
      }
    }
  }
  __syncthreads();
  if (!live) return;

  feed_store(fd, kFillWords, pf, ring, stride);
  int filled = kRingWords;                     // words in the ring so far
  feed_load(fd, filled, pf);
  int u = (int)(s & 15) >> 2;                  // the first word
  const uint32_t sk = 8 * (uint32_t)(s & 3);
  const uint32_t w0 = ring[u * stride], w1 = ring[(u + 1) * stride];
  uint32_t hi = __funnelshift_l(w1, w0, sk);
  uint32_t lo = w1 << sk;
  uint32_t room = sk;                          // 64 - bits in the buffer
  u += 2;                                      // the next word's index
  uint32_t w = ring[u * stride];
  uint32_t idx = hi >> 20;

  const uint8_t* tl = s_dec + g * kDecTables;
  uint4* dst = reinterpret_cast<uint4*>(out + (size_t)c * kChunk +
                                        (threadIdx.x & 3) * kFrag);
  auto step = [&]() -> uint32_t {
    const uint32_t len = tl[idx];
    const uint32_t sym = tl[idx + kTable];
    const uint32_t hi2 = __funnelshift_l(lo, hi, len);
    idx = hi2 >> 20;                           // apart from the refill
    const uint32_t lo2 = lo << len;
    const uint32_t room2 = room + len;
    const uint32_t take = room2 >> 5;          // <= 32 bits left: take w
    const uint32_t wv = take ? w : 0u;
    hi = hi2 | __funnelshift_l(wv, 0u, room2);
    lo = lo2 | (wv << (room2 & 31));
    room = room2 & 31;
    u += (int)take;
    w = ring[(u & (kRingWords - 1)) * stride];
    return sym;
  };
  for (int i = 0; i < kFrag / kFillSteps; ++i) {
#pragma unroll
    for (int h = 0; h < kFillSteps / 16; ++h) {
      uint32_t q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t e0 = step(), e1 = step(), e2 = step(), e3 = step();
        q[k] = __byte_perm(__byte_perm(e0, e1, 0x0040),
                           __byte_perm(e2, e3, 0x0040), 0x5410);
      }
      dst[i * (kFillSteps / 16) + h] = make_uint4(q[0], q[1], q[2], q[3]);
    }
    // a half is filled once the buffer has moved into the other one
    if (filled - u <= kFillWords) {
      feed_store(fd, filled, pf, ring, stride);
      filled += kFillWords;
      feed_load(fd, filled, pf);
    }
  }
}

}  // namespace

extern "C" {

const char* kanzi_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// D, prologue: the code tables of every chunk from its histogram, and
// each fragment's bit count (three kernels; `sizes` and `codes` carry
// the keys and lengths by rank between them).
int huff_code_tables(const void* chunks, const void* hist, int n_chunks,
                     void* codes, void* sizes, void* maxlen, void* m,
                     void* ok, void* bits, int device, void* stream) {
  cudaSetDevice(device);
  if (n_chunks > 0) {
    const cudaStream_t st = (cudaStream_t)stream;
    huff_ranks_kernel<<<n_chunks, 256, 0, st>>>(
        (const int64_t*)hist, (int32_t*)sizes, (int32_t*)m);
    huff_lengths_kernel<<<(n_chunks + kLenChunks - 1) / kLenChunks,
                          kLenChunks, 0, st>>>(
        (int32_t*)sizes, (const int32_t*)m, (const int64_t*)hist, n_chunks,
        (int32_t*)codes);
    huff_codes_kernel<<<n_chunks, 256, 0, st>>>(
        (const uint8_t*)chunks, (const int64_t*)hist, (const int32_t*)m,
        (uint32_t*)codes, (int32_t*)sizes, (int32_t*)maxlen, (uint8_t*)ok,
        (int32_t*)bits);
  }
  return (int)cudaGetLastError();
}

// D: the pairs of every ok chunk's fragments into flat at 2 * off16, and
// each fragment's acc, nb and npairs.
int huff_pack(const void* chunks, const void* codes, const void* ok,
              const void* off16, int n_chunks, void* flat, void* acc,
              void* nb, void* npairs, int device, void* stream) {
  cudaSetDevice(device);
  if (n_chunks > 0) {
    huff_pack_kernel<<<n_chunks, kPackWarps * 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)chunks, (const uint32_t*)codes, (const uint8_t*)ok,
        (const int64_t*)off16, (uint16_t*)flat, (uint32_t*)acc,
        (int32_t*)nb, (int32_t*)npairs);
  }
  return (int)cudaGetLastError();
}

int huff_decode(const void* tbl, const void* pay, int64_t n_pay,
                const void* bounds, int n_chunks, void* out, int device,
                void* stream) {
  cudaSetDevice(device);
  if (n_chunks > 0) {
    int sms = 0;
    cudaError_t rc = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
    if (rc != cudaSuccess) return (int)rc;
    rc = cudaFuncSetAttribute(huff_decode_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              dec_smem(kDecMaxChunks));
    if (rc != cudaSuccess) return (int)rc;
    // as few waves as shared memory allows, the chunks spread evenly
    // over the SMs within them
    const int waves = (n_chunks + sms * kDecMaxChunks - 1) /
                      (sms * kDecMaxChunks);
    const int per_block = (n_chunks + sms * waves - 1) / (sms * waves);
    huff_decode_kernel<<<(n_chunks + per_block - 1) / per_block,
                         dec_threads(per_block), dec_smem(per_block),
                         (cudaStream_t)stream>>>(
        (const uint16_t*)tbl, (const uint8_t*)pay, n_pay,
        (const int64_t*)bounds, n_chunks, per_block, (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
