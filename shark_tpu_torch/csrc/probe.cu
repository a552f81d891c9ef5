// K2, the hashed probe: one bucket load per window, then the stash.
//
// Replaces shark_tpu/classify/hashed.py classify_kernel_hashed
// (:542), its entry16 branch (:595-615), its entry8 branch (:616-627)
// and the stash compare (:629-644); the entry16 match is also what
// bench/pallas_vmem_match.py make_pallas_match computed in Pallas.
//
// One thread per window. The bucket of window p is b = lo & (2^lgB - 1)
// and the stored remainder rest = lo >> lgB | hi << (32 - lgB).
//   entry16: the bucket is `slots` u32 words (meta16 << 16 | payload16);
//     meta16 = tag << 14 | rest. A degree-2 or row entry spans two
//     adjacent words, so up to two lanes match: payv = first match's low
//     half | (sum of later matches) << 16, tagv = max matching tag.
//   entry8: the bucket is planar [2][8] (w0 = tag << 30 | rest, w1 =
//     payload); at most one lane matches, so tag and payload are masked
//     sums.
// Then every stash row (pos_lo, pos_hi, tag, payload) whose full position
// equals the window's is added to (tagv, payv); a position lives in the
// table or in the stash, never both, so the add never mixes entries.
//
// Bound: bytes. Per window the kernel must read 9 bytes (hi, lo, valid)
// and one 32-byte (entry16) or 64-byte (entry8) bucket, and write 8. The
// bucket loads are random; the 16-32 MB tables of gene panels fit the
// card's 50 MB L2, so most of them are L2 hits (a later PR can measure).
// The stash (at most 256 rows, 4 KB) is staged in shared memory once per
// block and compared by every thread.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStash = 256;

__global__ void probe_kernel(const u32* __restrict__ idx_hi,
                             const u32* __restrict__ idx_lo,
                             const uint8_t* __restrict__ win_valid,
                             long long n, const u32* __restrict__ table,
                             int lgB, int entry16, int slots,
                             const u32* __restrict__ stash, int n_stash,
                             u32* __restrict__ tagv, u32* __restrict__ payv) {
  __shared__ uint4 st[kMaxStash];
  for (int s = threadIdx.x; s < n_stash; s += blockDim.x)
    st[s] = reinterpret_cast<const uint4*>(stash)[s];
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const u32 lo = idx_lo[i];
  const u32 hi = idx_hi[i];
  const bool valid = win_valid[i] != 0;
  const u32 bucket = lo & ((1u << lgB) - 1u);
  const u32 rest = (lo >> lgB) | (hi << (32 - lgB));
  u32 tag = 0, pay = 0;
  if (entry16) {
    const uint4* row =
        reinterpret_cast<const uint4*>(table + (u64)bucket * slots);
    int first = slots;
    u32 p0 = 0, p1 = 0;
    for (int q = 0; q < (slots >> 2); ++q) {
      const uint4 v = row[q];
      const u32 w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const u32 meta = w[r] >> 16;
        const u32 lt = meta >> 14;
        if (valid && lt != 0 && (meta & 0x3FFFu) == rest) {
          if (first == slots) {
            first = 4 * q + r;
            p0 = w[r] & 0xFFFFu;
          } else {
            p1 += w[r] & 0xFFFFu;
          }
          tag = lt > tag ? lt : tag;
        }
      }
    }
    pay = p0 | (p1 << 16);
  } else {
    const uint4* row = reinterpret_cast<const uint4*>(table + (u64)bucket * 16);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint4 a = row[q];
      const uint4 b = row[2 + q];
      const u32 w0[4] = {a.x, a.y, a.z, a.w};
      const u32 w1[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const u32 lt = w0[r] >> 30;
        if (valid && lt != 0 && (w0[r] & 0x3FFFFFFFu) == rest) {
          tag += lt;
          pay += w1[r];
        }
      }
    }
  }
  if (valid) {
    for (int s = 0; s < n_stash; ++s) {
      const uint4 e = st[s];
      if (e.x == lo && e.y == hi) {
        tag += e.z;
        pay += e.w;
      }
    }
  }
  tagv[i] = tag;
  payv[i] = pay;
}

}  // namespace

extern "C" int shkk_probe(const void* idx_hi, const void* idx_lo,
                          const void* win_valid, long long n,
                          const void* table, int lgB, int entry16, int slots,
                          const void* stash, int n_stash, void* tagv,
                          void* payv, void* stream) {
  if (n_stash > kMaxStash || (entry16 && (slots & 3)) || slots > 8)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    probe_kernel<<<grid_for(n, kThreads), kThreads, 0,
                   (cudaStream_t)stream>>>(
        (const u32*)idx_hi, (const u32*)idx_lo, (const uint8_t*)win_valid, n,
        (const u32*)table, lgB, entry16, slots, (const u32*)stash, n_stash,
        (u32*)tagv, (u32*)payv);
  }
  return (int)cudaGetLastError();
}
