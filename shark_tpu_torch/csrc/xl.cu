// K6, the xl probe: one 16-byte bucket load per window, and the side table
// for the few windows that need it, fused into one kernel.
//
// Replaces shark_tpu/classify/hashed.py classify_kernel_hashed's xl
// branch (:568-594) and _xl_side_resolve (:662).
//
// One thread per window. The bucket of window p is b = lo & (2^lgB - 1)
// and rest = lo >> lgB | hi << (32 - lgB); lgB reaches 30, so the bucket's
// offset is computed in 64 bits. The bucket is 4 entry16 words (meta16 <<
// 16 | payload16, meta16 = tag << 14 | rest), matched on a 13-bit rest:
// bit 13 of slot 0's meta16 (bit 29 of the word) flags a bucket that
// overflowed, and the narrower mask keeps a flagged slot 0 matching. A
// degree-2 or row entry spans two adjacent words: payv = first match's
// low half | (sum of later matches) << 16, tagv = max matching tag.
//
// A valid window of a flagged bucket that matched nothing there loads the
// 64-byte planar entry8 side bucket lo & (2^side_lgB - 1), matches the
// 30-bit rest2 = lo >> side_lgB | hi << (32 - side_lgB), adds the side
// stash rows whose full position equals its own, and overwrites (tagv,
// payv) with the result, (0, 0) when the side misses too. shark_tpu
// compacts these windows to XL_SIDE_CAP columns per read under two
// batch-level conds to pay fewer per-row gathers on the TPU; here the extra
// load is a divergent branch of the ~1% of threads that need it, and the
// result equals both of its branches. The xl layout has no main stash.
//
// Bound: bytes. Per window the kernel must read 9 bytes (hi, lo, valid)
// and one 16-byte bucket, and write 8. At transcriptome scale the table is
// 1.07 GB, 21x the card's 50 MB L2, so the bucket loads are random HBM
// reads; the card moves 32-byte sectors, so each touched bucket costs
// twice the 16 bytes the bound counts. The side stash (at most 128 rows,
// 2 KB) is staged in shared memory by the blocks that have a window
// needing it.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSideStash = 128;
constexpr u32 kRestMask = 0x1FFFu;  // 13-bit rest; bit 13 is the flag
constexpr int kFlagBit = 29;

__global__ void probe_xl_kernel(const u32* __restrict__ idx_hi,
                                const u32* __restrict__ idx_lo,
                                const uint8_t* __restrict__ win_valid,
                                long long n, const uint4* __restrict__ table,
                                int lgB, const uint4* __restrict__ side,
                                int side_lgB, int has_side,
                                const uint4* __restrict__ side_stash,
                                int n_side_stash, u32* __restrict__ tagv,
                                u32* __restrict__ payv) {
  __shared__ uint4 st[kMaxSideStash];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const u32 lo = live ? idx_lo[i] : 0u;
  const u32 hi = live ? idx_hi[i] : 0u;
  const bool valid = live && win_valid[i] != 0;
  u32 tag = 0, pay = 0;
  bool need_side = false;
  if (valid) {
    const uint4 v = table[(u64)(lo & ((1u << lgB) - 1u))];
    const u32 rest = (lo >> lgB) | (hi << (32 - lgB));
    const u32 w[4] = {v.x, v.y, v.z, v.w};
    int first = -1;
    u32 p0 = 0, p1 = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const u32 meta = w[r] >> 16;
      const u32 lt = meta >> 14;
      if (lt != 0 && (meta & kRestMask) == rest) {
        if (first < 0) {
          first = r;
          p0 = w[r] & 0xFFFFu;
        } else {
          p1 += w[r] & 0xFFFFu;
        }
        tag = lt > tag ? lt : tag;
      }
    }
    pay = p0 | (p1 << 16);
    need_side = has_side && first < 0 && ((v.x >> kFlagBit) & 1u);
  }
  if (has_side) {  // uniform over the launch: every thread takes it
    if (__syncthreads_or(need_side)) {
      for (int s = threadIdx.x; s < n_side_stash; s += blockDim.x)
        st[s] = side_stash[s];
      __syncthreads();
    }
    if (need_side) {
      const uint4* row = side + (u64)(lo & ((1u << side_lgB) - 1u)) * 4;
      const u32 rest2 = (lo >> side_lgB) | (hi << (32 - side_lgB));
      u32 t = 0, p = 0;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint4 a = row[q];
        const uint4 b = row[2 + q];
        const u32 w0[4] = {a.x, a.y, a.z, a.w};
        const u32 w1[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const u32 lt = w0[r] >> 30;
          if (lt != 0 && (w0[r] & 0x3FFFFFFFu) == rest2) {
            t += lt;
            p += w1[r];
          }
        }
      }
      for (int s = 0; s < n_side_stash; ++s) {
        const uint4 e = st[s];
        if (e.x == lo && e.y == hi) {
          t += e.z;
          p += e.w;
        }
      }
      tag = t;
      pay = p;
    }
  }
  if (live) {
    tagv[i] = tag;
    payv[i] = pay;
  }
}

}  // namespace

extern "C" int shkk_probe_xl(const void* idx_hi, const void* idx_lo,
                             const void* win_valid, long long n,
                             const void* table, int lgB, const void* side,
                             int side_lgB, int has_side,
                             const void* side_stash, int n_side_stash,
                             void* tagv, void* payv, void* stream) {
  if (n_side_stash > kMaxSideStash || lgB < 1 || lgB > 31 || side_lgB < 1 ||
      side_lgB > 31)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    probe_xl_kernel<<<grid_for(n, kThreads), kThreads, 0,
                      (cudaStream_t)stream>>>(
        (const u32*)idx_hi, (const u32*)idx_lo, (const uint8_t*)win_valid, n,
        (const uint4*)table, lgB, (const uint4*)side, side_lgB, has_side,
        (const uint4*)side_stash, n_side_stash, (u32*)tagv, (u32*)payv);
  }
  return (int)cudaGetLastError();
}
