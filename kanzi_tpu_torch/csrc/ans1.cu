// Order-1 interleaved 4-lane rANS (ANS1) encode kernels for Hopper
// (sm_90a).
//
// Bit-exact with kanzi_tpu/ops/ans1.py and the reference coder
// (src/entropy/ANSRangeEncoder.cpp, order 1): log range 11, 4 lanes each
// walking one quarter of the chunk backwards over (prev << 8 | cur) pair
// indexes, 16-bit renormalisation, ANS_TOP = 1 << 15. Each launcher takes
// the caller's CUDA stream, launches, and returns cudaGetLastError().
// Outputs and scratch are allocated by the caller.
//
// F1. ans1_gather <- kanzi_tpu/ops/ans1.py _ans1_gather_kernel (:142, the
//     one-hot MXU table gather and the invFreq LUT cascade).
// F2. ans1_chain  <- kanzi_tpu/ops/ans1.py _ans1_scan_kernel (:221, the
//     in-kernel lane scan).
//
// What bounds F: the dependent chain of each lane, q = 1,048,576 steps at
// 4 MiB a chunk; a lane's state runs through its whole quarter, so the
// time of a call is q times the latency of one step, whatever the number
// of chunks. The bytes are small beside it (9 read and 4 written a
// symbol: 0.1 ms at 16 chunks).
//
// The first design ran both halves in one kernel, one warp a chunk, 4 live
// lanes, and each lane issued all the work off the chain itself. Its
// sm_90a SASS (cuobjdump -sass; 79 registers) runs a loop of 555
// instructions for 16 steps, 34.7 a step: byte extracts, the pair index,
// the table gathers of the next group with their 64-bit addresses (LEA,
// LEA.HI.X), the s_lut[f] load, FLO for the shift, bias, cmplFreq, xmax,
// and the slot's 64-bit address and store; around a dependent chain of 5
// (ISETP of st >= xmax, the predicated SHF of the renorm, IMAD.HI, SHF by
// the shift, IMAD of the update, x + bias off the chain). At 38.86 ns a
// step on an H100 80GB HBM3 at 700 W (PERF.md) the lone warp of an SM
// was bound by its own issue (35 instructions and their load latencies a
// step), not by the chain.
//
// The design now splits the two:
// - F1 (the gather) runs with every thread of the card, one position
//   each (16 a thread): the pair's packed f | cum << 12 entry from the
//   chunk's 256 KiB table (L2-resident), invFreq from the 2049-entry LUT
//   in shared memory, and the encode constants packed into one 8-byte word
//   a step: inv in the low word; shift - 1 (5 bits), bias (13 bits) and
//   cmplFreq (14 bits) in the high word; xmax = (2048 - cmplFreq) << 20.
//   The words go to scratch interleaved [chunk][step][lane], so a chunk's
//   4 lanes read one 32-byte sector a step.
// - F2 (the chain) runs one thread a lane, the lanes of 8 chunks in each
//   warp (the step has no branch, so 32 chains cost what 4 did), one warp
//   a block so that the warps spread over the SMs. A step is a chain of 5
//   (ISETP, SEL of the renorm, IMAD.HI, SHF.R.W, IMAD; about 25 cycles at
//   5 a dependent operation); off it, three field extracts and xmax,
//   st >> 16 and x + bias, the shift - 1 field read straight by a
//   wrap-mode funnel shift, and the renorm word flag<<16 | lo<<8 | hi
//   (a PRMT) stored in kernel A's vm layout (reversed steps x reversed
//   lanes), so that kernel B compacts it as before. The constant words
//   come through a cp.async ring in shared memory, 15 groups of 8 steps
//   ahead, each group waited for by its own count (cp.async.wait_group).
//   A ring of loads in registers (168 registers) ran at 35.68 ns a step
//   on an H100 80GB HBM3 at 700 W (PERF.md), no faster than the fused
//   kernel: its 56 loads in flight share the warp's 6 scoreboards, so
//   waiting for an old group also waited for the newest load. With the
//   ring, the renorm written as C (st >> 16 under the predicate, in
//   place) took 26.24 ns a step on the same card: its SASS (50
//   registers) runs 151 instructions and 338 cycles of static stalls for
//   8 steps, 42.3 a step, because ptxas issues the slot's SEL and PRMT
//   between the ISETP and the in-place shift (33 cycles from one ISETP
//   to the next). The renorm as a select into a new register (inline
//   setp/selp) lets the chain run on: 167 instructions and 277 cycles of
//   static stalls for 8 steps (34.6 a step, ~26 from one ISETP to the
//   next); the rest is the group's 8 loads from the ring and 8 stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kScale1 = 2048;
constexpr uint32_t kAnsTop = 1u << 15;
constexpr int kLut = kScale1 + 1;
constexpr int kTable = 256 * 256;
constexpr int kGatherThreads = 256;
constexpr int kGatherPerThread = 16;
constexpr int kGatherSpan = kGatherThreads * kGatherPerThread;   // 4096
constexpr int kG = 8;            // chain: steps per group
constexpr int kD = 16;           // chain: groups in the shared-memory ring

// F1: block (x, c) packs the constants of positions 4096x .. 4096x+4095
// (position 4t + lane) of chunk c.
__global__ void __launch_bounds__(kGatherThreads)
ans1_gather_kernel(const uint8_t* __restrict__ chunks,
                   const uint32_t* __restrict__ table,
                   const uint32_t* __restrict__ lut, int q,
                   uint2* __restrict__ consts) {
  __shared__ uint32_t s_lut[kLut];
  for (int i = threadIdx.x; i < kLut; i += blockDim.x) s_lut[i] = lut[i];
  __syncthreads();
  const size_t c = blockIdx.y;
  const size_t n = 4 * (size_t)q;
  const uint8_t* chunk = chunks + c * n;
  const uint32_t* tbl = table + c * kTable;
  uint2* out = consts + c * n;
#pragma unroll 4
  for (int k = 0; k < kGatherPerThread; ++k) {
    const int i = blockIdx.x * kGatherSpan + k * kGatherThreads + threadIdx.x;
    const int t = i >> 2;
    const uint8_t* quarter = chunk + (size_t)(i & 3) * q;
    const uint32_t cur = quarter[q - 1 - t];
    const uint32_t prev = t < q - 1 ? quarter[q - 2 - t] : 0u;
    const uint32_t v = __ldg(tbl + ((prev << 8) | cur));
    const uint32_t f = v & 0xFFFu;
    const uint32_t cum = v >> 12;
    const bool small = f < 2;
    const uint32_t sp = small ? 1u : 32u - __clz(f - 1);
    const uint32_t bias = small ? cum + kScale1 - 1 : cum;
    out[i] = make_uint2(s_lut[f], (sp - 1) | (bias << 5) | ((kScale1 - f) << 18));
  }
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

// F2: thread 4c + lane runs lane `lane` of chunk c over its q steps.
// Group g (steps 8g .. 8g+7) of the thread's constant words is copied by
// cp.async into ring slot g % kD of shared memory, kD - 1 groups ahead;
// cp.async.wait_group then waits for exactly the group it needs, where a
// register ring's loads share the warp's few scoreboards and a wait for
// an old load also waits for the newest.
__global__ void __launch_bounds__(32)
ans1_chain_kernel(const uint2* __restrict__ consts, int n_lanes, int q,
                  uint32_t* __restrict__ states, int32_t* __restrict__ vm) {
  __shared__ uint2 s_ring[kD * kG][32];   // [ring step][thread]: no conflict
  const int gid = blockIdx.x * 32 + threadIdx.x;
  if (gid >= n_lanes) return;
  const int t = threadIdx.x;
  const size_t c = gid >> 2;
  const int lane = gid & 3;
  const uint2* src = consts + c * 4 * (size_t)q + lane;     // step i: src[4i]
  int32_t* out = vm + c * 4 * (size_t)q + 3 - lane;         // step i: out[4(q-1-i)]
  const int n_groups = q / kG;

  // every thread commits one (possibly empty) group per call, so that
  // wait_group counts the same groups in every thread
  auto issue = [&](int g) {
    if (g < n_groups) {
      const uint2* s = src + 4 * (size_t)g * kG;
      uint2 (*slot)[32] = s_ring + (g & (kD - 1)) * kG;
#pragma unroll
      for (int j = 0; j < kG; ++j) cp_async8(&slot[j][t], s + 4 * j);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  for (int g = 0; g < kD - 1; ++g) issue(g);
  asm volatile("cp.async.wait_group %0;" :: "n"(kD - 2) : "memory");  // group 0
  uint2 cur[kG];
#pragma unroll
  for (int j = 0; j < kG; ++j) cur[j] = s_ring[j][t];

  uint32_t st = kAnsTop;
  for (int g = 0; g < n_groups; ++g) {
    issue(g + kD - 1);                   // into the slot group g - 1 left
    asm volatile("cp.async.wait_group %0;" :: "n"(kD - 2) : "memory");  // g + 1
    uint2 nxt[kG];
    const uint2 (*slot)[32] = s_ring + ((g + 1) & (kD - 1)) * kG;
#pragma unroll
    for (int j = 0; j < kG; ++j) nxt[j] = slot[j][t];
    int32_t* o = out + 4 * (size_t)(q - 1 - g * kG);
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      const uint32_t inv = cur[j].x;
      const uint32_t h = cur[j].y;
      const uint32_t bias = (h >> 5) & 0x1FFFu;
      const uint32_t cmpl = h >> 18;
      const uint32_t xmax = (kScale1 - cmpl) << 20;
      // x = st >= xmax ? st >> 16 : st as a select into a new register:
      // written as C, ptxas shifts st in place under the predicate, after
      // the slot's PRMT has read it
      uint32_t x;
      asm("{\n\t.reg .pred p;\n\tsetp.ge.u32 p, %1, %2;\n\t"
          "selp.b32 %0, %3, %1, p;\n\t}"
          : "=r"(x) : "r"(st), "r"(xmax), "r"(st >> 16));
      // >> (shift - 1): the wrap-mode funnel shift reads h's low 5 bits
      const uint32_t qv = __funnelshift_r(__umulhi(x, inv), 0u, h);
      // qv * cmpl + (x + bias), so that x + bias is off the chain
      uint32_t nst;
      asm("mad.lo.u32 %0, %1, %2, %3;"
          : "=r"(nst) : "r"(qv), "r"(cmpl), "r"(x + bias));
      // flag<<16 | lo<<8 | hi: bytes 1 and 0 of st, byte 2 of the flag;
      // x != st exactly where the lane renormalised (xmax >= 2^20)
      o[-4 * j] = (int32_t)__byte_perm(st, x != st ? 0x10000u : 0u, 0x7601);
      st = nst;
    }
#pragma unroll
    for (int j = 0; j < kG; ++j) cur[j] = nxt[j];
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  states[gid] = st;
}

}  // namespace

extern "C" {

const char* kanzi_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// F1: consts [n_chunks][q][4] 8-byte words from the chunks, their tables
// and the LUT. q must be a multiple of 1024.
int ans1_gather(const void* chunks, const void* table, const void* lut,
                int n_chunks, int q, void* consts, int device, void* stream) {
  cudaSetDevice(device);
  if (q % (kGatherSpan / 4) != 0 || n_chunks > 65535)
    return (int)cudaErrorInvalidValue;
  if (n_chunks > 0 && q > 0) {
    const dim3 grid(4 * q / kGatherSpan, n_chunks);
    ans1_gather_kernel<<<grid, kGatherThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)chunks, (const uint32_t*)table, (const uint32_t*)lut,
        q, (uint2*)consts);
  }
  return (int)cudaGetLastError();
}

// F2: the 4 lanes of each chunk over consts; final states [n_chunks][4],
// renorm slots vm [n_chunks][4q]. q must be a multiple of 8.
int ans1_chain(const void* consts, int n_chunks, int q, void* states,
               void* vm, int device, void* stream) {
  cudaSetDevice(device);
  if (q % kG != 0) return (int)cudaErrorInvalidValue;
  if (n_chunks > 0 && q > 0) {
    const int n_lanes = 4 * n_chunks;
    ans1_chain_kernel<<<(n_lanes + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
        (const uint2*)consts, n_lanes, q, (uint32_t*)states, (int32_t*)vm);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
