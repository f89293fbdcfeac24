// SBRT (MTF / RANK / TIMESTAMP) forward and inverse kernels for Hopper
// (sm_90a).
//
// Byte-exact with kanzi_tpu/ops/sbrt.py and the reference transform
// (src/transform/SBRT.cpp:22-145): per byte i of symbol c, qc = ((i & m1)
// + (p[c] & m2)) >> shift; c moves to rank nr = the number of symbols
// whose q exceeds qc, the ranks nr .. r-1 move up one, p[c] = i and q[c]
// = qc. The forward emits c's old rank r, the inverse reads a rank and
// emits the symbol that holds it. Bytes past a block's length pass
// through. Each launcher takes the caller's CUDA stream, launches, and
// returns cudaGetLastError(). Outputs and scratch are allocated by the
// caller.
//
// All four kernels replace kanzi_tpu/ops/sbrt.py _sbrt_kernel (:33,
// launched at :119): 16 blocks a grid cell on the VPU's [16, 256] vregs,
// in 2048-byte windows, one-hot compares and a 128-lane split gather for
// every lookup, one step a byte.
//
// What the design uses: the rank list stays sorted by q, highest first
// (qc is never below c's old q in any mode), and among equal q the
// symbol moved last ranks first. So a symbol's rank before byte i is the
// count of symbols with a greater key (q, seen, p, -symbol), and that
// key is a function of each symbol's last two positions before i.
//
// The forward, three kernels:
//   sbrt_occ    one warp a segment of `seg` bytes: each symbol's last
//               and second-to-last position in it (__match_any_sync per
//               byte of a 128-byte row, the top two lanes of each group
//               merged into shared memory by the group's top lane).
//               Bound: the match and merge a byte, spread over all SMs.
//   sbrt_entry  one thread a (block, symbol): a scan over the block's
//               segments in order gives each segment's entry state
//               (last position, -1 if unseen, and q). Bound: latency of
//               one dependent pass of nseg loads a thread, overlapped by
//               the unrolled loads.
//   sbrt_fwd    one warp a segment: each symbol's key from the entry
//               state, then the segment's bytes only. 16 blocks of 4 MiB
//               at 16 KiB segments are 4096 warps on 132 SMs instead of
//               16 chains of 4M steps, so the work is bound by
//               instruction issue (the ALU pipe takes a warp instruction
//               every 2 cycles), not by one chain's latency. The step
//               keeps no rank list: c's rank is the count of greater
//               keys (8 64-bit compares a lane, one __reduce_add_sync),
//               and only c's key changes.
// The inverse, one kernel:
//   sbrt_inv    one warp a block: its state depends on the symbols it
//               decodes, so its chain cannot be cut. Bound: the chain of
//               one step a byte and its instructions on the ALU pipe.
//               The step has no warp reduction: the input rank r names
//               the owner lane (r >> 3), which hands c to every lane in
//               one __shfl_sync; each lane reads p[c] from its own copy
//               in shared memory and places nr against its own ranks
//               from qc and its own entries, taking the lane below's top
//               entry through a __shfl_up_sync issued before qc is known
//               (off the chain). An entry is one register (q << 8 |
//               symbol), so a rank's move selects one register, not two.
//
// The input is read 16 bytes ahead of the chain (one broadcast load for
// the warp), and lane 0 writes each finished 4-byte word.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kPer = 8;          // ranks (inverse) or symbols (forward)
                                 // per lane

// v[e] for a runtime e in [0, 8), as a tree of selects (depth 3).
__device__ __forceinline__ uint32_t pick8(const uint32_t (&v)[kPer], int e) {
  const bool b0 = e & 1, b1 = e & 2, b2 = e & 4;
  const uint32_t a0 = b0 ? v[1] : v[0];
  const uint32_t a1 = b0 ? v[3] : v[2];
  const uint32_t a2 = b0 ? v[5] : v[4];
  const uint32_t a3 = b0 ? v[7] : v[6];
  const uint32_t c0 = b1 ? a1 : a0;
  const uint32_t c1 = b1 ? a3 : a2;
  return b2 ? c1 : c0;
}

// The forward's state: each symbol's key (q << 33 | seen << 32 | p << 8
// | 255 - symbol), lane k holding symbols 8k..8k+7 in registers and
// `mirror` (shared memory) all 256 for the broadcast of c's. The rank
// of c is the count of greater keys; only c's key changes a step.
struct FwdState {
  unsigned long long key[kPer];
  unsigned long long* mirror;
};

// One forward step of byte i (symbol c); returns c's rank.
__device__ __forceinline__ uint32_t step(uint32_t c, uint32_t i, int lane,
                                         uint32_t m1, uint32_t m2, int shift,
                                         FwdState& st) {
  const unsigned long long kc = st.mirror[c];
  uint32_t cnt = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e) cnt += st.key[e] > kc;
  const uint32_t r = __reduce_add_sync(kFull, cnt);
  const uint32_t pc = (uint32_t)kc >> 8;
  const uint32_t qc = ((i & m1) + (pc & m2)) >> shift;
  const unsigned long long nk = (unsigned long long)qc << 33 |
                                1ull << 32 | i << 8 | (255u - c);
  const int own = lane == (int)(c >> 3) ? (int)(c & 7u) : kPer;
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    if (own == e) st.key[e] = nk;
  __syncwarp();                      // every lane has read mirror[c]
  if (lane == 0) st.mirror[c] = nk;
  __syncwarp();
  return r;
}

// The inverse's state: lane k holds ranks 8k..8k+7 as q << 8 | symbol
// in registers (q < the block length < 2^24), and each lane its own
// copy of every symbol's p in column k of `p` (shared memory, 256 x 32
// words: a lane reads and writes only its own column, so no lane waits
// for another).
struct InvState {
  uint32_t ks[kPer];
  uint32_t* p;
};

// One inverse step of byte i (rank r); returns the symbol at r. A rank
// j counts as "above" where its q > qc or j > r (it stays); c takes the
// first rank that is not, nr, and the ranks after it up to r take the
// entry below them.
__device__ __forceinline__ uint32_t step(uint32_t r, uint32_t i, int lane,
                                         uint32_t m1, uint32_t m2, int shift,
                                         InvState& st) {
  const int base = kPer * lane;
  // the lane below's top entry, before anything moves
  const uint32_t up = __shfl_up_sync(kFull, st.ks[kPer - 1], 1);
  const uint32_t kc = __shfl_sync(kFull, pick8(st.ks, (int)(r & 7u)),
                                  (int)(r >> 3));
  const uint32_t c = kc & 0xFFu;
  const uint32_t pc = st.p[c * 32 + lane];
  st.p[c * 32 + lane] = i;
  const uint32_t qc = ((i & m1) + (pc & m2)) >> shift;
  const uint32_t thr = qc << 8 | 0xFFu;          // q > qc <=> entry > thr
  const uint32_t nk = qc << 8 | c;
  bool ab_prev = lane == 0 || up > thr;
  uint32_t prev = up;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const bool ab = st.ks[e] > thr || base + e > (int)r;
    const uint32_t o = st.ks[e];
    st.ks[e] = ab ? o : ab_prev ? nk : prev;
    ab_prev = ab;
    prev = o;
  }
  return c;
}

// Run the automaton over bytes [start, end) of one row (16-byte aligned
// offsets), stepping those below len and passing the rest through.
template <class State>
__device__ __forceinline__ void walk(const uint8_t* __restrict__ src,
                                     uint32_t* __restrict__ dst, int start,
                                     int end, int len, uint32_t m1,
                                     uint32_t m2, int shift, State& st) {
  const int lane = (int)threadIdx.x;
  uint4 nxt = __ldg(reinterpret_cast<const uint4*>(src + start));
  for (int off = start; off < end; off += 16) {
    const uint4 cur = nxt;
    if (off + 16 < end)
      nxt = __ldg(reinterpret_cast<const uint4*>(src + off + 16));
    for (int k = 0; k < 4; ++k) {
      const uint32_t w = k == 0 ? cur.x : k == 1 ? cur.y : k == 2 ? cur.z
                                                                  : cur.w;
      uint32_t o = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int i = off + 4 * k + b;
        const uint32_t x = (w >> (8 * b)) & 0xFFu;
        const uint32_t v =
            i < len ? step(x, (uint32_t)i, lane, m1, m2, shift, st) : x;
        o |= v << (8 * b);
      }
      if (lane == 0) dst[(off >> 2) + k] = o;
    }
  }
}

// a. each symbol's last and second-to-last position in one segment
__global__ void __launch_bounds__(32)
sbrt_occ_kernel(const uint8_t* __restrict__ in,
                const int64_t* __restrict__ lens, int ld, int seg, int nseg,
                int32_t* __restrict__ occ_last,
                int32_t* __restrict__ occ_sec) {
  __shared__ int32_t sl[256], ss[256];
  const int lane = (int)threadIdx.x;
  const int blk = (int)blockIdx.x / nseg, k = (int)blockIdx.x % nseg;
  for (int j = lane; j < 256; j += 32) sl[j] = ss[j] = -1;
  __syncwarp();
  const uint8_t* src = in + (size_t)blk * ld;
  const int start = k * seg;
  const int end = min(start + seg, min(ld, (int)lens[blk]));
  for (int off = start; off < end; off += 128) {
    const int at = off + 4 * lane;
    const uint32_t w =
        at < end ? __ldg(reinterpret_cast<const uint32_t*>(src + at)) : 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int pos = at + b;
      // positions rise with the lane within one b; past `end`, a
      // value no byte has keeps the lane to itself
      const uint32_t c = pos < end ? (w >> (8 * b)) & 0xFFu
                                   : 256u + (uint32_t)lane;
      const unsigned peers = __match_any_sync(kFull, c);
      const int top = 31 - __clz((int)peers);
      if (c < 256u && lane == top) {
        const unsigned rest = peers & ~(1u << top);
        const int t2 = rest ? off + 4 * (31 - __clz((int)rest)) + b : -1;
        int l = sl[c], s = ss[c];
        if (pos > l) {
          s = max(t2, l);
          l = pos;
        } else {
          s = max(s, pos);
        }
        sl[c] = l;
        ss[c] = s;
      }
      __syncwarp();
    }
  }
  int32_t* ol = occ_last + ((size_t)blk * nseg + k) * 256;
  int32_t* os = occ_sec + ((size_t)blk * nseg + k) * 256;
  for (int j = lane; j < 256; j += 32) {
    ol[j] = sl[j];
    os[j] = ss[j];
  }
}

// b. each segment's entry state: the last position before it (-1 if
// none) and q = ((last & m1) + (the position before that & m2)) >> shift
__global__ void __launch_bounds__(256)
sbrt_entry_kernel(const int32_t* __restrict__ occ_last,
                  const int32_t* __restrict__ occ_sec, int nseg, uint32_t m1,
                  uint32_t m2, int shift, int32_t* __restrict__ ent_last,
                  int32_t* __restrict__ ent_q) {
  int last = -1, prev = -1;
  size_t o = (size_t)blockIdx.x * nseg * 256 + threadIdx.x;
#pragma unroll 8
  for (int k = 0; k < nseg; ++k, o += 256) {
    const int l1 = __ldg(occ_last + o), l2 = __ldg(occ_sec + o);
    ent_last[o] = last;
    ent_q[o] = (int32_t)((((uint32_t)max(last, 0) & m1) +
                          ((uint32_t)max(prev, 0) & m2)) >> shift);
    if (l1 >= 0) {
      prev = l2 >= 0 ? l2 : last;
      last = l1;
    }
  }
}

// c. one segment's keys from its entry state, then its bytes
__global__ void __launch_bounds__(32)
sbrt_fwd_kernel(const uint8_t* __restrict__ in,
                const int64_t* __restrict__ lens, int ld, int seg, int nseg,
                const int32_t* __restrict__ ent_last,
                const int32_t* __restrict__ ent_q, uint32_t m1, uint32_t m2,
                int shift, uint8_t* __restrict__ out) {
  __shared__ unsigned long long mirror[256];
  const int lane = (int)threadIdx.x;
  const int blk = (int)blockIdx.x / nseg, k = (int)blockIdx.x % nseg;
  const uint8_t* src = in + (size_t)blk * ld;
  uint8_t* dst = out + (size_t)blk * ld;
  const int start = k * seg, end = min(start + seg, ld);
  const int len = (int)lens[blk];
  if (start >= len) {                        // the whole segment passes
    for (int off = start + 16 * lane; off < end; off += 16 * 32)
      *reinterpret_cast<uint4*>(dst + off) =
          __ldg(reinterpret_cast<const uint4*>(src + off));
    return;
  }
  const size_t e0 = ((size_t)blk * nseg + k) * 256;
  FwdState st;
  st.mirror = mirror;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int s = kPer * lane + e;
    const int last = __ldg(ent_last + e0 + s);
    st.key[e] = (unsigned long long)(uint32_t)__ldg(ent_q + e0 + s) << 33 |
                (unsigned long long)(last >= 0) << 32 |
                (uint32_t)max(last, 0) << 8 | (uint32_t)(255 - s);
    mirror[s] = st.key[e];
  }
  __syncwarp();
  walk(src, reinterpret_cast<uint32_t*>(dst), start, end, len, m1, m2,
       shift, st);
}

// the inverse: one warp a block
__global__ void __launch_bounds__(32)
sbrt_inv_kernel(const uint8_t* __restrict__ in,
                const int64_t* __restrict__ lens, int ld, uint32_t m1,
                uint32_t m2, int shift, uint8_t* __restrict__ out) {
  __shared__ uint32_t p[256 * 32];
  const int lane = (int)threadIdx.x;
  InvState st;
  st.p = p;
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    st.ks[e] = (uint32_t)(kPer * lane + e);  // q = 0, symbol = rank
  for (int c = 0; c < 256; ++c) p[c * 32 + lane] = 0;
  walk(in + (size_t)blockIdx.x * ld,
       reinterpret_cast<uint32_t*>(out + (size_t)blockIdx.x * ld), 0, ld,
       (int)lens[blockIdx.x], m1, m2, shift, st);
}

bool bad_shape(int n_blocks, int64_t ld) {
  return ld % 16 != 0 || ld >= (1 << 24) || n_blocks < 0;
}

}  // namespace

extern "C" {

const char* kanzi_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int sbrt_occ(const void* in, const void* lens, int n_blocks, int64_t ld,
             int seg, void* occ_last, void* occ_sec, int device,
             void* stream) {
  cudaSetDevice(device);
  if (bad_shape(n_blocks, ld) || seg <= 0 || seg % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int nseg = (int)((ld + seg - 1) / seg);
  if (n_blocks > 0 && nseg > 0)
    sbrt_occ_kernel<<<n_blocks * nseg, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)in, (const int64_t*)lens, (int)ld, seg, nseg,
        (int32_t*)occ_last, (int32_t*)occ_sec);
  return (int)cudaGetLastError();
}

int sbrt_entry(const void* occ_last, const void* occ_sec, int n_blocks,
               int nseg, int m1, int m2, int shift, void* ent_last,
               void* ent_q, int device, void* stream) {
  cudaSetDevice(device);
  if (n_blocks < 0 || nseg < 0) return (int)cudaErrorInvalidValue;
  if (n_blocks > 0 && nseg > 0)
    sbrt_entry_kernel<<<n_blocks, 256, 0, (cudaStream_t)stream>>>(
        (const int32_t*)occ_last, (const int32_t*)occ_sec, nseg,
        (uint32_t)m1, (uint32_t)m2, shift, (int32_t*)ent_last,
        (int32_t*)ent_q);
  return (int)cudaGetLastError();
}

int sbrt_fwd(const void* in, const void* lens, int n_blocks, int64_t ld,
             int seg, const void* ent_last, const void* ent_q, int m1, int m2,
             int shift, void* out, int device, void* stream) {
  cudaSetDevice(device);
  if (bad_shape(n_blocks, ld) || seg <= 0 || seg % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int nseg = (int)((ld + seg - 1) / seg);
  if (n_blocks > 0 && nseg > 0)
    sbrt_fwd_kernel<<<n_blocks * nseg, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)in, (const int64_t*)lens, (int)ld, seg, nseg,
        (const int32_t*)ent_last, (const int32_t*)ent_q, (uint32_t)m1,
        (uint32_t)m2, shift, (uint8_t*)out);
  return (int)cudaGetLastError();
}

int sbrt_inv(const void* in, const void* lens, int n_blocks, int64_t ld,
             int m1, int m2, int shift, void* out, int device,
             void* stream) {
  cudaSetDevice(device);
  if (bad_shape(n_blocks, ld)) return (int)cudaErrorInvalidValue;
  if (n_blocks > 0 && ld > 0)
    sbrt_inv_kernel<<<n_blocks, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)in, (const int64_t*)lens, (int)ld, (uint32_t)m1,
        (uint32_t)m2, shift, (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
