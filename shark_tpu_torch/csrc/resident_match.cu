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
// memory. No persisting-L2 access window is set.
//
// Bound: bytes. Per probe 4 bytes of rows and 4 of want in and 8 out, and
// 32 bytes of table per distinct bucket touched: at most n * 16 + the
// table's bytes.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr u32 kWantLimit = 1u << 18;  // 4 bits of bucket, 14 of key

__global__ void resident_match_kernel(const int* __restrict__ rows,
                                      const u32* __restrict__ want,
                                      const uint4* __restrict__ table,
                                      long long n, uint2* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const u32 w = want[i];
  u32 tv = 0, p0 = 0, p1 = 0;
  if (w < kWantLimit) {
    // 32 uint4 per 512-byte row, 2 per 32-byte bucket
    const uint4* b = table + (long long)rows[i] * 32 + (w >> 14) * 2;
    const uint4 lo = b[0];
    const uint4 hi = b[1];
    const u32 e[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const u32 key = w & 0x3FFFu;
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
  }
  out[i] = make_uint2(tv, p0 | (p1 << 16));
}

}  // namespace

extern "C" int shkk_resident_match(const void* rows, const void* want,
                                   const void* table128, long long n,
                                   void* out, void* stream) {
  if (n > 0) {
    resident_match_kernel<<<grid_for(n, kThreads), kThreads, 0,
                            (cudaStream_t)stream>>>(
        (const int*)rows, (const u32*)want, (const uint4*)table128, n,
        (uint2*)out);
  }
  return (int)cudaGetLastError();
}
