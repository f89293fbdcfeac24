// LZ match pass kernels for Hopper (sm_90a).
//
// Bit-exact with kanzi_tpu/ops/lz.py (lz_match_pass, match_pass_np) and
// the port's plain versions (ops/lz.py): for every position i of a block
// of n bytes, its bucket under the reference LZX hash
// (src/transform/LZCodec.hpp: ((LE64(src + i) << 24) * 0x1E35A7BD) >>
// (64 - hashLog)), the latest earlier position in the same bucket (prev),
// and the common prefix of the block at the two (lcp), capped at kCap = 32
// bytes. The block comes zero-padded (ops/lz.py pad_block: at least kCap
// + 8 zero bytes, its length a multiple of 8 and one more word), as
// kanzi_tpu's _match_fn pads it: the last 7 positions hash windows that
// run into the zeros, and a prefix may run past n into them. Each launcher
// takes the caller's CUDA stream, launches, and returns
// cudaGetLastError(). Outputs are allocated by the caller.
//
// All four replace kanzi_tpu/ops/lz.py _match_fn (:80-104), XLA with no
// Pallas kernel: its hash (_hash32_jnp :58, in 32-bit limbs, which the
// card does not need), its stable sort of (bucket, position) (:86), the
// previous item of the sorted order in the same bucket scattered to its
// position (:87-91), and CAP shifted byte compares (:93-102).
//
// The sort is a stable least-significant-digit radix sort on the bucket's
// hash_log bits alone (the positions arrive in order, so it gives
// jax.lax.sort((h, pos), num_keys=1, is_stable=True)), in passes of
// `bits` bits (ops/lz.py digit_plan: 8 bits at hash_log 16, 10 and 9 at
// 19). A key is bucket << 32 | position. The block is cut into tiles of
// kTile positions, one 512-thread block a tile, and each pass is three
// launches, with no host sync between them or between passes:
//
// lz_count   a tile's count of each digit value in shared memory, an
//            atomic an item, or one a chunk of 32 that shares a value (and,
//            in the last pass, the key of the tile's last item of each
//            value); pass 0 hashes the tile from the block and reads no
//            keys.
// lz_scan    a warp a digit value: the exclusive sum of its counts over
//            the tiles, its total, and in the last pass, for each tile,
//            the key just before the tile's run of that value in the
//            sorted order (the last such key of an earlier tile, or -1).
// lz_scatter a tile's stable rank: warps hold contiguous spans of the
//            tile, a chunk of 32 finds each lane's peers (the lanes of
//            its value) through a warp's bit masks in shared memory, a
//            warp's running count a value there; the tile is staged in
//            shared memory by digit value, so each value's run is written
//            out contiguously at its global offset. In the last pass it
//            writes no keys: a staged key's predecessor in the sorted order
//            is the staged key before it, or lz_scan's key for the first
//            of a run, and prev[position] is that predecessor's position
//            where the buckets are equal, else -1 (one 4-byte scatter).
// lz_lcp     a thread 4 positions, in position order: prev read and lcp
//            written 16 bytes at once, the windows at i and at prev[i] (the
//            only gather; the other three windows only where the first
//            agree), up to 4 XORs of 8 bytes, the first differing byte from
//            the lowest set bit (the windows are little-endian).
//
// What bounds K: bytes. The function reads the block and writes prev and
// lcp (9 bytes a position). The design moves about 8 bytes a position in
// and out of each pass but the last, reads the block twice in pass 0 (the
// second time from L2) and the keys three times in later passes (the
// count, then the scatter's rank and stage), and scatters prev once; a
// block of a few MiB and its keys stay in the card's 50 MB L2. A window is
// two aligned 8-byte loads and a funnel shift. What the card pays beyond
// the bytes: the random 4-byte prev stores and the random window gathers
// of lcp (one L2 sector each), and each tile's chain of 16 rank steps a
// warp between barriers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr u64 kSeed = 0x1E35A7BDull;
constexpr int kCap = 32;
constexpr int kTile = 8192;                  // positions a tile
constexpr int kThreads = 512;                // a tile's block
constexpr int kWarps = kThreads / 32;
constexpr int kItems = kTile / kThreads;     // a lane's items of a tile
constexpr int kSpan = kTile / kWarps;        // a warp's contiguous items
constexpr int kMaxBits = 10;                 // at most 1024 digit values
constexpr int kScanThreads = 64;             // lz_scan: 2 digit values a block
constexpr int kLcpThreads = 256;

// The little-endian 8-byte window at byte i of the padded block: two
// aligned loads, the upper one shifted in (by 1 and 63 - s, so that s = 0
// takes nothing of it, with no branch).
__device__ __forceinline__ u64 window(const u64* __restrict__ pad,
                                      long long i) {
  const long long q = i >> 3;
  const int s = (int)(i & 7) * 8;
  const u64 lo = __ldg(pad + q);
  const u64 hi = __ldg(pad + q + 1);
  return (lo >> s) | ((hi << 1) << (63 - s));
}

// Item i of a pass: the caller's key, or (pass 0, keys null) position i's
// key from the block: bucket << 32 | i.
__device__ __forceinline__ long long item_key(
    const u64* __restrict__ pad, const long long* __restrict__ keys,
    long long i, int hash_log) {
  if (keys) return keys[i];
  const u64 h = ((window(pad, i) << 24) * kSeed) >> (64 - hash_log);
  return (long long)((h << 32) | (u64)i);
}

__device__ __forceinline__ int digit(long long key, int shift, int r) {
  return (int)(((u64)key >> 32 >> shift) & (u64)(r - 1));
}

// In place exclusive prefix sum of a[0, r), r <= 2 * kThreads, by every
// thread of the block; scratch holds kWarps ints. Ends synchronised.
__device__ void block_exclusive_scan(int* a, int r, int* scratch) {
  const int per = (r + kThreads - 1) / kThreads;           // 1 or 2
  const int lo = threadIdx.x * per;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int v[2] = {0, 0};
  int s = 0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (k < per && lo + k < r) v[k] = a[lo + k];
    s += v[k];
  }
  int x = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(~0u, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[w] = x;
  __syncthreads();
  if (w == 0) {
    const int ws = lane < kWarps ? scratch[lane] : 0;
    int xs = ws;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(~0u, xs, o);
      if (lane >= o) xs += y;
    }
    if (lane < kWarps) scratch[lane] = xs - ws;
  }
  __syncthreads();
  int run = scratch[w] + x - s;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (k < per && lo + k < r) a[lo + k] = run;
    run += v[k];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
lz_count_kernel(const u64* __restrict__ pad,
                const long long* __restrict__ keys, long long n,
                int hash_log, int shift, int bits, int tiles,
                int32_t* __restrict__ counts, long long* __restrict__ last) {
  extern __shared__ int cnt_smem[];
  const int r = 1 << bits;
  int* bins = cnt_smem;                  // r counts
  int* top = cnt_smem + r;               // r: the last item of each value
  const int tile = blockIdx.x;
  const long long base = (long long)tile * kTile;
  const int len = (int)min((long long)kTile, n - base);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < r; j += kThreads) {
    bins[j] = 0;
    top[j] = -1;
  }
  // every item's value first, so that the loads are all in flight
  int d[kItems];
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    const int j = w * kSpan + c * 32 + lane;
    d[c] = j < len ? digit(item_key(pad, keys, base + j, hash_log), shift, r)
                   : r;                            // past the tile
  }
  __syncthreads();
  // a shared-memory atomic an item, or one a chunk whose items share a
  // value (a skewed block: one bin takes every item)
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    const int j = w * kSpan + c * 32 + lane;
    const unsigned live = __ballot_sync(~0u, d[c] < r);
    const int lo = __reduce_min_sync(~0u, d[c]);
    const int hi = __reduce_max_sync(~0u, d[c] < r ? d[c] : -1);
    if (lo == hi) {
      if (lane == __ffs(live) - 1) {
        atomicAdd(&bins[lo], __popc(live));
        if (last) atomicMax(&top[lo], j + 31 - __clz(live) - lane);
      }
    } else if (d[c] < r) {
      atomicAdd(&bins[d[c]], 1);
      if (last) atomicMax(&top[d[c]], j);
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < r; d += kThreads) {
    const long long at = (long long)d * tiles + tile;
    counts[at] = bins[d];
    if (last)
      last[at] = top[d] < 0 ? -1
                            : item_key(pad, keys, base + top[d], hash_log);
  }
}

__global__ void __launch_bounds__(kScanThreads)
lz_scan_kernel(const int32_t* __restrict__ counts,
               const long long* __restrict__ last, int r, int tiles,
               int32_t* __restrict__ offs, int32_t* __restrict__ totals,
               long long* __restrict__ pred) {
  const int lane = threadIdx.x & 31;
  const int d = (blockIdx.x * kScanThreads + threadIdx.x) >> 5;
  if (d >= r) return;                              // the whole warp
  // lane l takes tiles [t0, t1): first their sum and the last key of the
  // latest that holds the value (loads independent, all in flight), then
  // the warp's exclusive scans of both, then the outputs
  const int per = (tiles + 31) / 32;
  const int t0 = min(lane * per, tiles), t1 = min(t0 + per, tiles);
  const long long row = (long long)d * tiles;
  int sum = 0;
  long long key = -1;
#pragma unroll 8
  for (int t = t0; t < t1; ++t) {
    const int v = counts[row + t];
    sum += v;
    if (last && v > 0) key = last[row + t];
  }
  int x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(~0u, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) totals[d] = x;
  int run = x - sum;
  const unsigned earlier =
      __ballot_sync(~0u, key >= 0) & ((1u << lane) - 1);
  const long long ks =
      __shfl_sync(~0u, key, earlier ? 31 - __clz(earlier) : 0);
  key = earlier ? ks : -1;
#pragma unroll 8
  for (int t = t0; t < t1; ++t) {
    const int v = counts[row + t];
    offs[row + t] = run;
    run += v;
    if (last) {
      pred[row + t] = key;
      if (v > 0) key = last[row + t];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
lz_scatter_kernel(const u64* __restrict__ pad,
                  const long long* __restrict__ keys, long long n,
                  int hash_log, int shift, int bits, int tiles,
                  const int32_t* __restrict__ offs,
                  const int32_t* __restrict__ totals,
                  const long long* __restrict__ pred,
                  long long* __restrict__ out, int32_t* __restrict__ prev) {
  extern __shared__ __align__(16) unsigned char sc_smem[];
  const int r = 1 << bits;
  long long* stage = (long long*)sc_smem;          // kTile keys by value
  // kWarps x r counts of a warp's items by value (at most kSpan each)
  unsigned short* wcnt = (unsigned short*)(stage + kTile);
  int* gofs = (int*)(wcnt + kWarps * r);           // r: global offsets
  int* tofs = gofs + r;                            // r: the tile's offsets
  int* scratch = tofs + r;                         // kWarps
  const int tile = blockIdx.x;
  const long long base = (long long)tile * kTile;
  const int len = (int)min((long long)kTile, n - base);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  // until the tile is staged, the stage holds each warp's r lane masks
  unsigned* masks = (unsigned*)stage + w * r;
  for (int j = threadIdx.x; j < kWarps * r; j += kThreads) {
    wcnt[j] = 0;
    ((unsigned*)stage)[j] = 0u;
  }
  for (int d = threadIdx.x; d < r; d += kThreads) gofs[d] = totals[d];
  __syncthreads();
  // each value's start in the output, then this tile's run in it
  block_exclusive_scan(gofs, r, scratch);
  for (int d = threadIdx.x; d < r; d += kThreads)
    gofs[d] += offs[(long long)d * tiles + tile];

  // rank: warp w holds items [w * kSpan, (w + 1) * kSpan) in chunks of
  // 32; an item's rank in its warp is the warp's count of its value
  // before the chunk plus its peers in lower lanes. A chunk whose items
  // share a value (a skewed block) needs no masks; otherwise each lane
  // sets its bit in its value's mask and reads its peers there.
  unsigned short* mine = wcnt + w * r;
  const unsigned below = (1u << lane) - 1;
  unsigned dr[kItems];                             // value, then rank
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    const int j = w * kSpan + c * 32 + lane;
    dr[c] = j < len ? digit(item_key(pad, keys, base + j, hash_log),
                            shift, r)
                    : r;                           // past the tile
  }
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    const int d = (int)dr[c];
    const unsigned live = __ballot_sync(~0u, d < r);
    unsigned peers = live;
    if (__reduce_min_sync(~0u, d) != __reduce_max_sync(~0u, d < r ? d : -1)) {
      if (d < r) atomicOr(&masks[d], 1u << lane);
      __syncwarp();
      peers = d < r ? masks[d] : 0u;
      __syncwarp();
      if (d < r && lane == __ffs(peers) - 1) masks[d] = 0u;
    }
    const int before = d < r ? mine[d] : 0;
    __syncwarp();
    if (d < r && lane == __ffs(peers) - 1)
      mine[d] = (unsigned short)(before + __popc(peers));
    __syncwarp();
    dr[c] = ((unsigned)d << 16) | (unsigned)(before + __popc(peers & below));
  }
  __syncthreads();
  // per value: the warps' counts to exclusive offsets, the tile's count
  for (int d = threadIdx.x; d < r; d += kThreads) {
    int s = 0;
    for (int v = 0; v < kWarps; ++v) {
      const int c = wcnt[v * r + d];
      wcnt[v * r + d] = (unsigned short)s;
      s += c;
    }
    tofs[d] = s;
  }
  __syncthreads();
  block_exclusive_scan(tofs, r, scratch);
  // stage the tile by value, stable (the keys read again, from L1 or L2)
#pragma unroll
  for (int c = 0; c < kItems; ++c) {
    const int d = (int)(dr[c] >> 16);
    if (d < r)
      stage[tofs[d] + mine[d] + (int)(dr[c] & 0xFFFF)] = item_key(
          pad, keys, base + w * kSpan + c * 32 + lane, hash_log);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < len; k += kThreads) {
    const long long kk = stage[k];
    const int d = digit(kk, shift, r);
    if (!pred) {
      out[gofs[d] + (k - tofs[d])] = kk;
    } else {
      const long long pk =
          k > tofs[d] ? stage[k - 1] : pred[(long long)d * tiles + tile];
      prev[(u64)kk & 0xFFFFFFFFull] =
          (pk >= 0 && (pk >> 32) == (kk >> 32)) ? (int32_t)(pk & 0xFFFFFFFF)
                                                : -1;
    }
  }
}

__global__ void __launch_bounds__(kLcpThreads)
lz_lcp_kernel(const u64* __restrict__ pad, const int32_t* __restrict__ prev,
              long long n, int32_t* __restrict__ lcp) {
  const long long i = ((long long)blockIdx.x * kLcpThreads + threadIdx.x) * 4;
  if (i >= n) return;
  int p[4];
  if (i + 4 <= n) {
    const int4 v = *(const int4*)(prev + i);
    p[0] = v.x, p[1] = v.y, p[2] = v.z, p[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) p[k] = i + k < n ? prev[i + k] : -1;
  }
  // each position's first window on both sides (the gathers of the four
  // all in flight); the other three windows only where the first agree
  u64 x0[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    x0[k] = p[k] < 0 ? 1 : window(pad, i + k) ^ window(pad, p[k]);
  int len[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    len[k] = p[k] < 0 ? 0 : (__ffsll((long long)x0[k]) - 1) >> 3;
    if (x0[k] == 0) {
      u64 x[3];
#pragma unroll
      for (int t = 1; t < 4; ++t)
        x[t - 1] = window(pad, i + k + 8 * t) ^ window(pad, p[k] + 8 * t);
      len[k] = kCap;
#pragma unroll
      for (int t = 3; t >= 1; --t)
        if (x[t - 1])
          len[k] = 8 * t + ((__ffsll((long long)x[t - 1]) - 1) >> 3);
    }
  }
  if (i + 4 <= n) {
    *(int4*)(lcp + i) = make_int4(len[0], len[1], len[2], len[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i + k < n) lcp[i + k] = len[k];
  }
}

int tiles_of(long long n) { return (int)((n + kTile - 1) / kTile); }

bool bad_pass(long long n, int hash_log, int shift, int bits) {
  return n <= 0 || n >= (1ll << 31) || hash_log < 1 || hash_log > 31 ||
         bits < 1 || bits > kMaxBits || shift < 0 || shift >= hash_log;
}

}  // namespace

extern "C" {

const char* kanzi_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// counts [2^bits, tiles] int32: each tile's count of each value of the
// digit (key >> 32 >> shift) & (2^bits - 1); last (null but in the last
// pass) [2^bits, tiles] int64: the key of the tile's last item of each
// value, -1 for none. keys [n] int64, or null for pass 0: the keys of the
// padded block (8-byte aligned).
int lz_count(const void* pad, const void* keys, long long n, int hash_log,
             int shift, int bits, void* counts, void* last, int device,
             void* stream) {
  cudaSetDevice(device);
  if (bad_pass(n, hash_log, shift, bits)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * sizeof(int) << bits;
  lz_count_kernel<<<tiles_of(n), kThreads, smem, (cudaStream_t)stream>>>(
      (const u64*)pad, (const long long*)keys, n, hash_log, shift, bits,
      tiles_of(n), (int32_t*)counts, (long long*)last);
  return (int)cudaGetLastError();
}

// offs [2^bits, tiles] int32: each value's exclusive sum of counts over
// the tiles; totals [2^bits] int32; pred (null where last is null): the
// key before each tile's run of each value in the sorted order, or -1.
int lz_scan(const void* counts, const void* last, int bits, int tiles,
            void* offs, void* totals, void* pred, int device, void* stream) {
  cudaSetDevice(device);
  if (bits < 1 || bits > kMaxBits || tiles < 1 || (last == nullptr) !=
      (pred == nullptr))
    return (int)cudaErrorInvalidValue;
  const int r = 1 << bits;
  const unsigned grid = (unsigned)((r + kScanThreads / 32 - 1) /
                                   (kScanThreads / 32));
  lz_scan_kernel<<<grid, kScanThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)counts, (const long long*)last, r, tiles,
      (int32_t*)offs, (int32_t*)totals, (long long*)pred);
  return (int)cudaGetLastError();
}

// One stable pass on the digit: out [n] int64 the keys (null keys: the
// block's) in the order of the digit, stable; or, where pred is given
// (the last pass), prev [n] int32 by position and no keys.
int lz_scatter(const void* pad, const void* keys, long long n, int hash_log,
               int shift, int bits, const void* offs, const void* totals,
               const void* pred, void* out, void* prev, int device,
               void* stream) {
  cudaSetDevice(device);
  if (bad_pass(n, hash_log, shift, bits) ||
      (pred ? prev == nullptr : out == nullptr))
    return (int)cudaErrorInvalidValue;
  const int r = 1 << bits;
  const int smem = kTile * (int)sizeof(long long) +
                   kWarps * r * (int)sizeof(unsigned short) +
                   (2 * r + kWarps) * (int)sizeof(int);
  const cudaError_t e = cudaFuncSetAttribute(
      lz_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  lz_scatter_kernel<<<tiles_of(n), kThreads, smem, (cudaStream_t)stream>>>(
      (const u64*)pad, (const long long*)keys, n, hash_log, shift, bits,
      tiles_of(n), (const int32_t*)offs, (const int32_t*)totals,
      (const long long*)pred, (long long*)out, (int32_t*)prev);
  return (int)cudaGetLastError();
}

// lcp [n] int32 by position, from prev and the padded block.
int lz_lcp(const void* pad, const void* prev, long long n, void* lcp,
           int device, void* stream) {
  cudaSetDevice(device);
  if (n <= 0 || n >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const unsigned grid =
      (unsigned)((n + 4 * kLcpThreads - 1) / (4 * kLcpThreads));
  lz_lcp_kernel<<<grid, kLcpThreads, 0, (cudaStream_t)stream>>>(
      (const u64*)pad, (const int32_t*)prev, n, (int32_t*)lcp);
  return (int)cudaGetLastError();
}

}  // extern "C"
