// P2, the entry16 bucket match against a table that stays on chip.
//
// Replaces bench/pallas_vmem_match.py make_pallas_match (:55, pl.pallas_call
// at :112), an experiment that kept the 16 MB entry16 table (2^19 buckets of
// 8 u32 slots) resident in VMEM and matched every probe against its bucket.
// The table is shaped [2^lgB / 16, 128] u32: row rows[j] = bucket >> 4 holds
// 16 buckets, and want[j] = rest | (bucket & 15) << 14 names the bucket g
// within the row and the 14-bit key, or is 0xFFFFFFFF for an invalid probe.
// A slot e matches when its tag (e >> 30) is not 0 and its key
// ((e >> 16) & 0x3FFF) equals want's. Per probe the output is (tv, p0 |
// p1 << 16): tv the largest tag over matches (0 when none), p0 the pay
// (e & 0xFFFF) of the first matching slot, p1 the sum of the pays of the
// later ones, wrapped to 32 bits as the TPU's int32 arithmetic wraps it.
//
// VMEM pads the minor dimension to 128 lanes, so the TPU loaded the whole
// 512-byte row and picked the bucket inside its compare (glane, :65). Here
// one thread takes one probe and reads only its bucket, the 32-byte sector
// at words g * 8 .. g * 8 + 7 of its row, in two uint4 loads, then matches
// the 8 slots in registers. A want >= 2^18, the invalid sentinel included,
// matches nothing and reads no table: the TPU's compare value has 18 bits,
// so it never equals such a want either.
//
// "Resident" on this card means the 50 MB L2: 16 MB is far past the 227 KB
// of shared memory of an SM, and past a 16-SM cluster's distributed shared
// memory. What passes through L2 beside the table is 92 MB of streams
// (rows, want, out), each byte used once, so they are loaded and stored in
// the streaming (evict-first) forms: 10% faster than plain loads and
// stores. No persisting-L2 limit or access-policy window is set, since
// either would outlive the call and change every later kernel's L2.
// Measured on the card and dropped (scripts/return_variants.py on commit
// 8217fec): an L2 evict-last policy on the table's loads
// (createpolicy.fractional, per access; no faster beside the streaming
// forms), 2 or 4 probes a thread with 8- or 16-byte loads of rows and want
// (4% and 35-55% slower; 4 with their outputs staged through shared
// memory for 512-byte stores, 30%), and two lanes a probe, each loading
// half of the bucket in one request (10% slower).
//
// Bound: bytes. Per probe 4 bytes of rows and 4 of want in and 8 out, and
// 32 bytes of table per distinct bucket touched when the table starts in
// device memory: n * 16 + touched * 32 bytes, or n * 16 with the table
// already in L2. What holds it above the warm bound is the L2's rate of
// random 32-byte reads: a bare gather of the same buckets takes longer
// than the whole kernel.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr u32 kWantLimit = 1u << 18;  // 4 bits of bucket, 14 of key
// 1: rows and want are loaded, and out stored, in the streaming forms
#define SHKK_MATCH_STREAM_HINT 1

// a plain load of half a bucket (not the read-only path the compiler may
// pick for a const __restrict__ pointer)
__device__ __forceinline__ uint4 load_half(const uint4* p) {
  uint4 v;
  asm("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// (tv, p0 | p1 << 16) of one probe against its bucket's 8 slots
__device__ __forceinline__ uint2 match8(uint4 lo, uint4 hi, u32 w) {
  const u32 e[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const u32 key = w & 0x3FFFu;
  u32 tv = 0, p0 = 0, p1 = 0;
  bool first = true;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const u32 meta = e[s] >> 16;
    const u32 tag = meta >> 14;
    if (tag != 0u && (meta & 0x3FFFu) == key) {
      const u32 pay = e[s] & 0xFFFFu;
      if (first) {
        p0 = pay;
        first = false;
      } else {
        p1 += pay;
      }
      tv = max(tv, tag);
    }
  }
  return make_uint2(tv, p0 | (p1 << 16));
}

__global__ void __launch_bounds__(kThreads) resident_match_kernel(
    const u32* __restrict__ rows, const u32* __restrict__ want,
    const uint4* __restrict__ table, u32 n, uint2* __restrict__ out) {
  const u32 i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
#if SHKK_MATCH_STREAM_HINT
  const u32 r = __ldcs(rows + i);
  const u32 w = __ldcs(want + i);
#else
  const u32 r = rows[i];
  const u32 w = want[i];
#endif
  uint4 lo, hi;
  if (w < kWantLimit) {
    // 32 uint4 per 512-byte row, 2 per 32-byte bucket
    const uint4* b = table + (size_t)r * 32 + (w >> 14) * 2;
    lo = load_half(b);
    hi = load_half(b + 1);
  } else {  // tag 0 in every slot: no match
    lo = make_uint4(0u, 0u, 0u, 0u);
    hi = lo;
  }
  const uint2 o = match8(lo, hi, w);
#if SHKK_MATCH_STREAM_HINT
  __stcs(out + i, o);
#else
  out[i] = o;
#endif
}

}  // namespace

extern "C" int shkk_resident_match(const void* rows, const void* want,
                                   const void* table128, long long n,
                                   void* out, void* stream) {
  if (n < 0 || n > 0xFFFFFFFFll - kThreads)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    resident_match_kernel<<<grid_for(n, kThreads), kThreads, 0,
                            (cudaStream_t)stream>>>(
        (const u32*)rows, (const u32*)want, (const uint4*)table128, (u32)n,
        (uint2*)out);
  }
  return (int)cudaGetLastError();
}
