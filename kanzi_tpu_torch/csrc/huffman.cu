// Canonical-Huffman (4-fragment) kernels for Hopper (sm_90a).
//
// Bit-exact with kanzi_tpu/ops/huffman.py and the reference coder
// (src/entropy/Huffman{Encoder,Decoder}.cpp): a 16 KiB chunk splits into 4
// fragments of 4096 symbols, each its own MSB-first bitstream of codes of
// at most 12 bits. Each kernel has an extern "C" launcher that takes the
// caller's CUDA stream, launches, and returns cudaGetLastError(). Outputs
// are allocated by the caller.
//
// D. huff_encode_scan <- kanzi_tpu/ops/ans.py _gather_kernel1 (:145),
//    called from kanzi_tpu/ops/huffman.py:175, and the fragment lax.scan
//    of huffman_encode_chunks (:181-198); its prologue builds the code
//    tables that the JAX package leaves to XLA (compute_code_tables,
//    kanzi_tpu/ops/huffman.py:98-152).
// E. huff_decode      <- kanzi_tpu/ops/huffman.py _huff_decode_kernel (:317).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16384;
constexpr int kFrag = kChunk / 4;
constexpr int kTable = 1 << 12;   // 12-bit prefix table

// XLA's shifts: a shift by 32 or more gives 0. Only the codes of chunks
// the host re-encodes (a code longer than 12 bits) reach such lengths,
// but their accumulators are part of the result all the same.
__device__ __forceinline__ uint32_t shl32(uint32_t x, uint32_t s) {
  return s >= 32 ? 0u : x << s;
}
__device__ __forceinline__ uint32_t shr32(uint32_t x, uint32_t s) {
  return s >= 32 ? 0u : x >> s;
}

// ---------------------------------------------------------------------
// D, prologue. Code tables: one block of 256 threads per chunk, thread s
// owning symbol s. The ranks of the (freq << 8 | sym) keys come from 256
// compares per thread (the keys of present symbols are distinct), which
// replaces the batched sort. Moffat-Katajainen (HuffmanEncoder.cpp:
// 246-300) is sequential by nature, so one thread runs both phases on the
// chunk's 256 ranks in shared memory: phase 1 is 2(m-1) steps, phase 2
// touches each rank O(1) times. The canonical codes are the per-length
// counting construction of compute_code_tables: a code longer than 12
// bits is clamped to 13 there (such chunks are not ok and the host codes
// them), and the result equals the plain version for every chunk.
//
// Bound: the sequential phases of one thread per chunk (a few thousand
// dependent shared-memory steps); every SM keeps 8 chunks in flight.
// ---------------------------------------------------------------------

constexpr int kMaxSym = 12;
constexpr int32_t kAbsentFreq = 0x7FFFFF;   // (2^31 - 1) >> 8, as the sort's

__global__ void __launch_bounds__(256)
huff_code_tables_kernel(const int64_t* __restrict__ hist, int n_chunks,
                        uint32_t* __restrict__ codes_out,
                        int32_t* __restrict__ sizes_out,
                        int32_t* __restrict__ maxlen_out,
                        int32_t* __restrict__ m_out,
                        uint8_t* __restrict__ ok_out) {
  __shared__ uint32_t s_key[256];
  __shared__ int32_t s_data[256];   // by rank: freq, then tree, then length
  __shared__ uint8_t s_sym[256];    // symbol by rank
  __shared__ int32_t s_size[256];   // length by symbol
  __shared__ int32_t s_first[kMaxSym + 2];
  __shared__ int32_t s_maxlen;
  const int c = blockIdx.x;
  const int sym = threadIdx.x;
  const int64_t f = hist[(size_t)c * 256 + sym];
  const bool present = f > 0;
  const uint32_t key = present ? ((uint32_t)f << 8) | (uint32_t)sym
                               : 0xFFFFFFFFu;
  s_key[sym] = key;
  s_size[sym] = 0;
  if (sym == 0) s_maxlen = 0;
  __syncthreads();
  int rank = 0, m = 0;
  for (int j = 0; j < 256; ++j) {
    const uint32_t kj = s_key[j];
    rank += kj < key;
    m += kj != 0xFFFFFFFFu;
  }
  if (present) {
    s_data[rank] = (int32_t)f;
    s_sym[rank] = (uint8_t)sym;
  }
  if (sym >= m) s_data[sym] = kAbsentFreq;
  __syncthreads();

  if (sym == 0) {
    int32_t* d = s_data;
    // phase 1: in-place tree build (entropy/huffman.py
    // _compute_inplace_phase1)
    int s = 0, r = 0;
    for (int t = 0; t < m - 1; ++t) {
      int32_t total = 0;
      for (int k = 0; k < 2; ++k) {
        const int32_t dr = d[min(r, 255)];
        const int32_t ds = d[min(s, 255)];
        const bool use_r = s >= m || (r < t && dr < ds);
        total += use_r ? dr : ds;
        if (use_r) {
          d[min(r, 255)] = t;
          ++r;
        } else {
          if (s > t) d[min(s, 255)] = 0;
          ++s;
        }
      }
      d[t] = total;
    }
    // phase 2: internal-node depths -> leaf lengths, as the batched
    // plain version runs it (at most 64 levels; m == 1 gives length 1)
    int nn = m, top = m - 2, depth = 1, nal = 2;
    for (int it = 0; it < 64 && nn > 0; ++it) {
      int k = top > 0 ? top : 0;
      while (k > 0 && d[k - 1] >= top) --k;
      const int internal = top - k;
      const int newn = nn - (nal - internal);
      for (int i = max(newn, 0); i < min(nn, 256); ++i) d[i] = depth;
      nn = newn;
      top = k;
      ++depth;
      nal = 2 * internal;
    }
  }
  __syncthreads();
  if (sym < m) {
    s_size[s_sym[sym]] = s_data[sym];
    atomicMax(&s_maxlen, s_data[sym]);
  }
  __syncthreads();

  // canonical codes: first code of each length, then the rank among the
  // present symbols of the same length, in symbol order
  const int32_t size = s_size[sym];
  const int ln = present ? min(size, kMaxSym + 1) : kMaxSym + 1;
  if (sym == 0) {
    int32_t counts[kMaxSym + 2] = {0};
    for (int j = 0; j < 256; ++j)
      counts[s_key[j] != 0xFFFFFFFFu ? min(s_size[j], kMaxSym + 1)
                                     : kMaxSym + 1]++;
    int32_t first = 0;
    s_first[0] = 0;
    for (int l = 0; l <= kMaxSym; ++l) {
      first = (first + counts[l]) << 1;
      s_first[l + 1] = first;
    }
  }
  __syncthreads();
  int32_t same = 0;
  if (present && ln <= kMaxSym) {
    for (int j = 0; j < sym; ++j)
      same += s_key[j] != 0xFFFFFFFFu && min(s_size[j], kMaxSym + 1) == ln;
  }
  const size_t o = (size_t)c * 256 + sym;
  codes_out[o] = present ? ((uint32_t)ln << 12) | (uint32_t)(s_first[ln] + same)
                         : 0u;
  sizes_out[o] = size;
  if (sym == 0) {
    maxlen_out[c] = s_maxlen;
    m_out[c] = m;
    ok_out[c] = m > 1 && s_maxlen <= kMaxSym;
  }
}

// ---------------------------------------------------------------------
// D. Encode scan. One thread per (chunk, fragment); the chunk's 256-entry
// len<<12 | code table sits in shared memory, so the gather that the TPU
// ran as a separate 128-lane split-table pass is one shared load per
// symbol. Each thread walks its fragment's 4096 symbols forward (one u32
// load per 4 symbols) with a u32 bit accumulator holding fewer than 16
// bits between steps: len <= 12, so at most one 16-bit pair comes out
// per step. It writes the slot flag<<16 | lo<<8 | hi of every step
// (16 bytes per 4 steps), the vm of huffman_encode_chunks, zero for the
// rows of not-ok chunks, which kernel B then packs.
//
// Bound: device-memory bandwidth for the 64 KiB of slots written per
// chunk (4x the input), and the 4096-step dependent chain per thread.
// 16 chunks (64 threads, 16 KiB of shared memory) per block keep a
// 4096-chunk batch resident at once.
// ---------------------------------------------------------------------

constexpr int kEncChunks = 16;   // chunks per block, 4 threads each

__global__ void __launch_bounds__(kEncChunks * 4)
huff_encode_scan_kernel(const uint8_t* __restrict__ chunks,
                        const uint32_t* __restrict__ codes,
                        const uint8_t* __restrict__ ok, int n_chunks,
                        int32_t* __restrict__ vm,
                        uint32_t* __restrict__ acc_out,
                        int32_t* __restrict__ nb_out,
                        int32_t* __restrict__ npairs_out) {
  __shared__ uint32_t s_code[kEncChunks][256];
  const int c0 = blockIdx.x * kEncChunks;
  for (int i = threadIdx.x; i < kEncChunks * 256; i += blockDim.x) {
    const int c = c0 + (i >> 8);
    if (c < n_chunks)
      s_code[i >> 8][i & 255] = codes[(size_t)c * 256 + (i & 255)];
  }
  __syncthreads();

  const int g = threadIdx.x >> 2;
  const int f = threadIdx.x & 3;
  const int c = c0 + g;
  if (c >= n_chunks) return;
  const bool live = ok[c] != 0;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(
      chunks + (size_t)c * kChunk + f * kFrag);
  int4* dst = reinterpret_cast<int4*>(vm + (size_t)c * kChunk + f * kFrag);
  uint32_t acc = 0;
  int32_t nb = 0;
  int32_t np = 0;
  for (int i = 0; i < kFrag / 4; ++i) {
    const uint32_t w = src[i];
    int32_t slot[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t x = s_code[g][(w >> (8 * k)) & 0xFF];
      const uint32_t ln = x >> 12;
      acc = shl32(acc, ln) | (x & 0xFFF);
      nb += (int32_t)ln;
      const bool flag = nb >= 16;
      const uint32_t sh = flag ? (uint32_t)(nb - 16) : 0u;
      const uint32_t out16 = shr32(acc, sh) & 0xFFFF;
      if (flag) {
        acc &= sh >= 32 ? 0xFFFFFFFFu : (1u << sh) - 1u;
        nb -= 16;
      }
      np += flag ? 1 : 0;
      slot[k] = live ? (int32_t)(((uint32_t)flag << 16) |
                                 ((out16 & 0xFF) << 8) | (out16 >> 8))
                     : 0;
    }
    dst[i] = make_int4(slot[0], slot[1], slot[2], slot[3]);
  }
  acc_out[(size_t)c * 4 + f] = acc;
  nb_out[(size_t)c * 4 + f] = nb;
  npairs_out[(size_t)c * 4 + f] = live ? np : 0;
}

// ---------------------------------------------------------------------
// E. Decode. One thread per fragment, 4 per chunk, 8 chunks per
// warp-sized block. The chunk's direct 4096-entry sym | len<<8 table
// (8 KiB as u16, the flat table of _build_vt) sits in dynamic shared
// memory, so a step is one shared load on the 12 bits at the cursor; this
// replaces the TPU's boundary-bitmap rank table and its overlapped-word
// payload windows. Each thread keeps a small bit buffer refilled a byte
// at a time from its fragment's bytes in the flat payload; a byte past
// the fragment's end (or past the payload) reads 0, so a corrupt or short
// fragment never reads out of bounds and decodes as if zero-padded, as
// the JAX package's padded rows do.
//
// Bound: the 4096-step dependent chain per fragment (shared load, shift,
// refill). 64 KiB of shared memory per 8 chunks allows 3 blocks per SM.
// ---------------------------------------------------------------------

constexpr int kDecChunks = 8;    // chunks per block, 4 threads each
constexpr int kDecSmem = kDecChunks * kTable * (int)sizeof(uint16_t);

__global__ void __launch_bounds__(kDecChunks * 4)
huff_decode_kernel(const uint16_t* __restrict__ tbl,
                   const uint8_t* __restrict__ pay, int64_t n_pay,
                   const int64_t* __restrict__ bounds, int n_chunks,
                   uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint16_t s_tbl[];   // [kDecChunks][kTable]
  const int c0 = blockIdx.x * kDecChunks;
  for (int i = threadIdx.x; i < kDecChunks * kTable / 8; i += blockDim.x) {
    const int g = i / (kTable / 8);
    const int k = i % (kTable / 8);
    if (c0 + g < n_chunks) {
      reinterpret_cast<uint4*>(s_tbl + g * kTable)[k] =
          reinterpret_cast<const uint4*>(tbl + (size_t)(c0 + g) * kTable)[k];
    }
  }
  __syncthreads();

  const int g = threadIdx.x >> 2;
  const int f = threadIdx.x & 3;
  const int c = c0 + g;
  if (c >= n_chunks) return;
  const uint16_t* t = s_tbl + g * kTable;
  int64_t pos = bounds[(size_t)c * 4 + f];
  int64_t end = bounds[(size_t)c * 4 + f + 1];
  if (end > n_pay) end = n_pay;
  uint32_t* dst = reinterpret_cast<uint32_t*>(out + (size_t)c * kChunk +
                                              f * kFrag);
  uint32_t buf = 0;   // the low `have` bits are the stream at the cursor
  int have = 0;
  for (int i = 0; i < kFrag / 4; ++i) {
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      while (have < 12) {
        const uint32_t b = (pos >= 0 && pos < end) ? pay[pos] : 0u;
        ++pos;
        buf = (buf << 8) | b;
        have += 8;
      }
      const uint32_t e = t[(buf >> (have - 12)) & 0xFFF];
      word |= (e & 0xFF) << (8 * k);
      have -= (int)(e >> 8);
    }
    dst[i] = word;
  }
}

}  // namespace

extern "C" {

const char* kanzi_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// D: the code tables of every chunk from its histogram, then the scan.
int huff_encode_scan(const void* chunks, const void* hist, int n_chunks,
                     void* codes, void* sizes, void* maxlen, void* m,
                     void* ok, void* vm, void* acc, void* nb, void* npairs,
                     int device, void* stream) {
  cudaSetDevice(device);
  if (n_chunks > 0) {
    huff_code_tables_kernel<<<n_chunks, 256, 0, (cudaStream_t)stream>>>(
        (const int64_t*)hist, n_chunks, (uint32_t*)codes, (int32_t*)sizes,
        (int32_t*)maxlen, (int32_t*)m, (uint8_t*)ok);
    huff_encode_scan_kernel<<<(n_chunks + kEncChunks - 1) / kEncChunks,
                              kEncChunks * 4, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)chunks, (const uint32_t*)codes, (const uint8_t*)ok,
        n_chunks, (int32_t*)vm, (uint32_t*)acc, (int32_t*)nb,
        (int32_t*)npairs);
  }
  return (int)cudaGetLastError();
}

int huff_decode(const void* tbl, const void* pay, int64_t n_pay,
                const void* bounds, int n_chunks, void* out, int device,
                void* stream) {
  cudaSetDevice(device);
  if (n_chunks > 0) {
    const cudaError_t rc = cudaFuncSetAttribute(
        huff_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kDecSmem);
    if (rc != cudaSuccess) return (int)rc;
    huff_decode_kernel<<<(n_chunks + kDecChunks - 1) / kDecChunks,
                         kDecChunks * 4, kDecSmem, (cudaStream_t)stream>>>(
        (const uint16_t*)tbl, (const uint8_t*)pay, n_pay,
        (const int64_t*)bounds, n_chunks, (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
