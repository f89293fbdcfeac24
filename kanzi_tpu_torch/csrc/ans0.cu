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
// B. Row compaction. One 1024-thread block per row of 16384 slots,
// walked in 16 rounds of 1024 consecutive slots: a warp ballot ranks the
// flagged slots within each warp, warp 0 scans the 32 warp counts, and
// every flagged slot stores its u16 (lo<<8 | hi, little-endian, so the
// bytes read hi, lo) straight to off16[row] + rank. This replaces the
// TPU's log-step butterfly and its row-by-row dynamic_update_slice scan.
//
// Bound: device-memory bandwidth (64 KiB read per row, the compacted
// payload written); reads are coalesced, writes nearly so.
// ---------------------------------------------------------------------

constexpr int kCompactThreads = 1024;

__global__ void __launch_bounds__(kCompactThreads)
ans0_compact_rows_kernel(const int32_t* __restrict__ vm,
                         const int64_t* __restrict__ off16, int64_t total16,
                         uint16_t* __restrict__ out) {
  __shared__ int warp_cnt[32];
  __shared__ int warp_off[32];
  __shared__ int round_total;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int32_t* src = vm + (size_t)row * kChunk;
  int64_t base = off16[row];
  for (int r = 0; r < kChunk; r += kCompactThreads) {
    const int32_t v = src[r + tid];
    const bool f = ((v >> 16) & 1) != 0;
    const unsigned bal = __ballot_sync(0xFFFFFFFFu, f);
    const int rank = __popc(bal & ((1u << lane) - 1u));
    if (lane == 0) warp_cnt[warp] = __popc(bal);
    __syncthreads();
    if (warp == 0) {
      const int x = warp_cnt[lane];
      int incl = x;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
        if (lane >= d) incl += y;
      }
      warp_off[lane] = incl - x;
      if (lane == 31) round_total = incl;
    }
    __syncthreads();
    if (f) {
      const int64_t dst = base + warp_off[warp] + rank;
      if (dst >= 0 && dst < total16) out[dst] = (uint16_t)(v & 0xFFFF);
    }
    base += round_total;
    __syncthreads();   // warp_cnt / round_total are rewritten next round
  }
}

// ---------------------------------------------------------------------
// C. Decode. Four threads per chunk (one per rANS lane), 8 chunks per
// warp-sized block. The chunk's direct 4096-entry residue -> symbol
// table and its 256-entry f | cum<<12 table sit in shared memory, so a
// step is two shared loads and a multiply-add; this replaces the TPU's
// boundary-bitmap + popcount rank scheme. Lanes consume renorm pairs in
// order 3, 2, 1, 0: a ballot gives each lane the count of flagged lanes
// above it. Payload pairs are read from the compact byte stream at
// off_bytes[c] + cursor; a read past n_pay yields 0, so a corrupt
// stream never reads out of bounds and is caught by the caller's
// consumed != size check.
//
// Bound: the 4096-step dependent chain per lane (shared loads, then a
// payload load whose address depends on the previous steps). 40 KiB of
// shared memory per 8 chunks keeps ~5 blocks per SM, so a 4096-chunk
// batch runs as one wave.
// ---------------------------------------------------------------------

constexpr int kDecChunks = 8;    // chunks per block, 4 threads each

__global__ void __launch_bounds__(kDecChunks * 4)
ans0_decode_kernel(const uint8_t* __restrict__ f2s,
                   const uint32_t* __restrict__ fc,
                   const uint32_t* __restrict__ states,
                   const uint8_t* __restrict__ pay, int64_t n_pay,
                   const int64_t* __restrict__ off_bytes, int n_chunks,
                   uint8_t* __restrict__ out, int32_t* __restrict__ consumed) {
  __shared__ __align__(16) uint8_t s_f2s[kDecChunks][kScale];
  __shared__ uint32_t s_fc[kDecChunks][256];
  const int c0 = blockIdx.x * kDecChunks;
  for (int i = threadIdx.x; i < kDecChunks * (int)kScale / 16;
       i += blockDim.x) {
    const int g = i / ((int)kScale / 16);
    const int k = i % ((int)kScale / 16);
    if (c0 + g < n_chunks) {
      reinterpret_cast<uint4*>(s_f2s[g])[k] =
          reinterpret_cast<const uint4*>(f2s + (size_t)(c0 + g) * kScale)[k];
    }
  }
  for (int i = threadIdx.x; i < kDecChunks * 256; i += blockDim.x) {
    if (c0 + (i >> 8) < n_chunks)
      s_fc[i >> 8][i & 255] = fc[(size_t)(c0 + (i >> 8)) * 256 + (i & 255)];
  }
  __syncthreads();

  const int g = threadIdx.x >> 2;
  const int lane = threadIdx.x & 3;
  const int c = c0 + g;
  const bool live = c < n_chunks;
  // dead threads still join every ballot below
  uint32_t st = live ? states[(size_t)c * 4 + lane] : 0u;
  const int64_t base = live ? off_bytes[c] : 0;
  uint8_t* dst = out + (size_t)(live ? c : 0) * kChunk;
  uint32_t cur = 0;
  for (int t = 0; t < kSteps; ++t) {
    const uint32_t v = st & kMask;
    const uint32_t sym = live ? s_f2s[g][v] : 0u;
    const uint32_t e = live ? s_fc[g][sym] : 0u;
    st = (e & 0xFFF) * (st >> kLogRange) + v - (e >> 12);
    const bool flag = live && st < kAnsTop;
    const unsigned bal = __ballot_sync(0xFFFFFFFFu, flag);
    const unsigned nib = (bal >> (4 * g)) & 0xFu;
    if (flag) {
      const int64_t p = base + cur + 2 * __popc(nib >> (lane + 1));
      const uint32_t b0 = (p >= 0 && p < n_pay) ? pay[p] : 0u;
      const uint32_t b1 = (p >= 0 && p + 1 < n_pay) ? pay[p + 1] : 0u;
      st = (st << 16) | (b0 << 8) | b1;
    }
    cur += 2 * __popc(nib);
    if (live) dst[4 * t + 3 - lane] = (uint8_t)sym;
  }
  if (live && lane == 0) consumed[c] = (int32_t)cur;
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
        (const int32_t*)vm, (const int64_t*)off16, total16, (uint16_t*)out);
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
                         kDecChunks * 4, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)f2s, (const uint32_t*)fc, (const uint32_t*)states,
        (const uint8_t*)pay, n_pay, (const int64_t*)off_bytes, n_chunks,
        (uint8_t*)out, (int32_t*)consumed);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
