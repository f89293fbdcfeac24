// Order-1 interleaved 4-lane rANS (ANS1) encode kernel for Hopper
// (sm_90a).
//
// Bit-exact with kanzi_tpu/ops/ans1.py and the reference coder
// (src/entropy/ANSRangeEncoder.cpp, order 1): log range 11, 4 lanes each
// walking one quarter of the chunk backwards over (prev << 8 | cur) pair
// indexes, 16-bit renormalisation, ANS_TOP = 1 << 15. The launcher takes
// the caller's CUDA stream, launches, and returns cudaGetLastError().
// Outputs are allocated by the caller.
//
// F. ans1_encode_scan <- kanzi_tpu/ops/ans1.py _ans1_gather_kernel
//    (:142, the one-hot MXU table gather and the invFreq LUT cascade)
//    and _ans1_scan_kernel (:221, the in-kernel lane scan), in one
//    kernel.
//
// One block of one warp per chunk; threads 0-3 are the chunk's 4 lanes
// (the other 28 only help load the LUT). Lane k walks quarter k of the
// chunk backwards: step t encodes the pair (quarter[q-2-t], quarter[q-1-t])
// and the last step (0, quarter[0]). Per step it reads the pair's packed
// f | cum<<12 entry from the chunk's 256 KiB table in device memory
// (L1/L2-resident: one chunk per SM), invFreq from the 2049-entry LUT in
// shared memory, derives bias / cmplFreq / shift as _ans1_gather_kernel
// does (:160-167), then renormalises and updates the state as
// _ans1_scan_kernel does (:241-263) with the native __umulhi.
//
// Bound: the q-step dependent chain of each lane (compare, shift,
// __umulhi, multiply-add), not bytes: a 4 MiB chunk is 4 lanes x 1M
// steps, and a call of 16 chunks has 64 chains. The table loads depend
// only on the data, never on the state, so the design keeps them off
// the chain: the quarter is read in 16-byte words two groups ahead, and
// the 16 table entries of group g+1 are loaded while group g's 16 steps
// run. The renorm slot flag<<16 | lo<<8 | hi (the layout of kernel A's
// vm, so that compaction writes the payload bytes hi, lo directly) goes
// straight to its emission position, reversed steps x reversed lanes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kScale1 = 2048;
constexpr int kLogRange1 = 11;
constexpr uint32_t kAnsTop = 1u << 15;
constexpr int kLut = kScale1 + 1;
constexpr int kTable = 256 * 256;
constexpr int kGroup = 16;       // steps per group: one 16-byte word

// The 16-byte word of group g (positions q-16(g+1) .. q-1-16g of the
// quarter), or zeros past the quarter's start.
__device__ __forceinline__ uint4 load_group(const uint8_t* quarter, int q,
                                            int g, int n_groups) {
  if (g >= n_groups) return make_uint4(0u, 0u, 0u, 0u);
  return __ldg(reinterpret_cast<const uint4*>(quarter + q - kGroup * (g + 1)));
}

__device__ __forceinline__ uint32_t byte_of(const uint4& w, int k) {
  const uint32_t v = k < 4 ? w.x : k < 8 ? w.y : k < 12 ? w.z : w.w;
  return (v >> (8 * (k & 3))) & 0xFFu;
}

// Table entries of one group's 16 steps: step j encodes cur = byte 15-j
// after prev = byte 14-j, and the group's last step takes its prev from
// the top byte of the next group's word (0 past the quarter's start).
__device__ __forceinline__ void gather(const uint32_t* __restrict__ tbl,
                                       const uint4& w, const uint4& w_next,
                                       uint32_t (&v)[kGroup]) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    const uint32_t cur = byte_of(w, 15 - j);
    const uint32_t prev = j < kGroup - 1 ? byte_of(w, 14 - j)
                                         : byte_of(w_next, 15);
    v[j] = __ldg(tbl + ((prev << 8) | cur));
  }
}

__global__ void __launch_bounds__(32)
ans1_encode_scan_kernel(const uint8_t* __restrict__ chunks,
                        const uint32_t* __restrict__ table,
                        const uint32_t* __restrict__ lut, int q,
                        uint32_t* __restrict__ states,
                        int32_t* __restrict__ vm) {
  __shared__ uint32_t s_lut[kLut];
  for (int i = threadIdx.x; i < kLut; i += blockDim.x) s_lut[i] = lut[i];
  __syncthreads();
  const int lane = threadIdx.x;
  if (lane >= 4) return;
  const size_t c = blockIdx.x;
  const uint8_t* quarter = chunks + c * 4 * (size_t)q + (size_t)lane * q;
  const uint32_t* tbl = table + c * kTable;
  int32_t* out = vm + c * 4 * (size_t)q;
  const int n_groups = q / kGroup;

  uint4 w1 = load_group(quarter, q, 1, n_groups);
  uint4 w2 = load_group(quarter, q, 2, n_groups);
  uint32_t v[kGroup], vn[kGroup];
  gather(tbl, load_group(quarter, q, 0, n_groups), w1, v);
  uint32_t st = kAnsTop;
  for (int g = 0; g < n_groups; ++g) {
    // group g+1's entries (harmless in-range loads past the last group)
    gather(tbl, w1, w2, vn);
    w1 = w2;
    w2 = load_group(quarter, q, g + 3, n_groups);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const uint32_t f = v[j] & 0xFFFu;
      const uint32_t cum = v[j] >> 12;
      const bool small = f < 2;
      const uint32_t inv = s_lut[f];
      const uint32_t sp = small ? 1u : 32u - __clz(f - 1);
      const uint32_t bias = small ? cum + kScale1 - 1 : cum;
      const uint32_t cmpl = kScale1 - f;
      const uint32_t xmax = f << (31 - kLogRange1);
      const uint32_t flag = st >= xmax ? 1u : 0u;
      const int t = g * kGroup + j;
      out[(size_t)(q - 1 - t) * 4 + 3 - lane] =
          (int32_t)((flag << 16) | ((st & 0xFFu) << 8) | ((st >> 8) & 0xFFu));
      if (flag) st >>= 16;
      st = st + bias + (__umulhi(st, inv) >> (sp - 1)) * cmpl;
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) v[j] = vn[j];
  }
  states[c * 4 + lane] = st;
}

}  // namespace

extern "C" {

const char* kanzi_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int ans1_encode_scan(const void* chunks, const void* table, const void* lut,
                     int n_chunks, int q, void* states, void* vm, int device,
                     void* stream) {
  cudaSetDevice(device);
  if (q % kGroup != 0) return (int)cudaErrorInvalidValue;
  if (n_chunks > 0 && q > 0) {
    ans1_encode_scan_kernel<<<n_chunks, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)chunks, (const uint32_t*)table, (const uint32_t*)lut,
        q, (uint32_t*)states, (int32_t*)vm);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
