// K6, the xl probe: one 16-byte bucket load per window, and the side table
// for the few windows that need it, fused into one kernel.
//
// Replaces shark_tpu/classify/hashed.py classify_kernel_hashed's xl
// branch (:568-594) and _xl_side_resolve (:662).
//
// The bucket of window p is b = lo & (2^lgB - 1) and rest = lo >> lgB |
// hi << (32 - lgB); lgB reaches 30, so the bucket's offset is computed in
// 64 bits. The bucket is 4 entry16 words (meta16 << 16 | payload16,
// meta16 = tag << 14 | rest), matched on a 13-bit rest: bit 13 of slot 0's
// meta16 (bit 29 of the word) flags a bucket that overflowed, and the
// narrower mask keeps a flagged slot 0 matching. A degree-2 or row entry
// spans two adjacent words: payv = first match's low half | (sum of later
// matches) << 16, tagv = max matching tag.
//
// A valid window of a flagged bucket that matched nothing there loads the
// 64-byte planar entry8 side bucket lo & (2^side_lgB - 1), matches the
// 30-bit rest2 = lo >> side_lgB | hi << (32 - side_lgB), adds the side
// stash rows whose full position equals its own, and overwrites (tagv,
// payv) with the result, (0, 0) when the side misses too. shark_tpu
// compacts these windows to XL_SIDE_CAP columns per read under two
// batch-level conds to pay fewer per-row gathers on the TPU; here the
// result equals both of its branches. The xl layout has no main stash.
//
// Bound: bytes. Per window the kernel must read 9 bytes (hi, lo, valid)
// and one 16-byte bucket, and write 8. At transcriptome scale the table is
// 1.07 GB, 21x the card's 50 MB L2, so the bucket loads are random HBM
// reads, and the card moves whole 32-byte sectors: counted in sectors,
// each touched bucket costs twice the 16 bytes the bound counts.
//
// What bounds it, measured on the card (scripts/xl_variants.py and
// chip_smoke.py's footprint line): the card's rate of random 32-byte
// reads. The kernel takes little more than a bare gather of the same
// 16-byte rows; with the buckets masked into the table's first 32 MB
// (L2-resident) it takes half the time of the whole table, and into
// 256 MB over 90%, so TLB reach past 256 MB costs little. The design:
// - a thread per window: kWin consecutive windows a thread (2 or 4, with
//   lo and hi read as one uint2 or uint4, the valid bytes as one word and
//   every bucket load issued before the first match) measured no faster
//   on the whole table, as one load a thread already keeps the rate busy;
// - plain bucket loads: the read-only path without L1 allocation
//   (ld.global.nc.L1::no_allocate) measured 1.56x slower at the 32 MB
//   footprint and 1-2% slower on the whole table;
// - the side resolve has no block barrier (the first design ran a
//   __syncthreads_or in every block to stage the side stash in shared
//   memory): a warp that holds a window needing the side table reads the
//   side stash (at most 128 rows, 2 KB) from global memory through the
//   read-only cache, four rows a lane, and matches each such window
//   against all rows at once, a warp sum giving the stash's tag and
//   payload. Inline it costs about 1% of the kernel, less than a second
//   launch would.
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWin = 1;  // consecutive windows a thread takes
constexpr int kMaxSideStash = 128;
constexpr int kStashPerLane = kMaxSideStash / 32;
constexpr u32 kRestMask = 0x1FFFu;  // 13-bit rest; bit 13 is the flag
constexpr int kFlagBit = 29;
constexpr u32 kFull = 0xffffffffu;

struct XlArgs {
  const u32* idx_hi;
  const u32* idx_lo;
  const uint8_t* win_valid;
  long long n;
  const uint4* table;
  int lgB;
  const uint4* side;
  int side_lgB, has_side;
  const uint4* side_stash;
  int n_side_stash;
  u32* tagv;
  u32* payv;
};

// kWin consecutive u32 words (T) and kWin valid bytes (B), each one
// aligned load or store
template <int N>
struct Group;
template <>
struct Group<1> {
  typedef u32 T;
  typedef uint8_t B;
};
template <>
struct Group<2> {
  typedef uint2 T;
  typedef uint16_t B;
};
template <>
struct Group<4> {
  typedef uint4 T;
  typedef u32 B;
};

// One 16-byte table row; the asm keeps the load where it stands, under
// its window's condition.
__device__ __forceinline__ uint4 load_row(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// kVec: idx_lo, idx_hi, tagv and payv are aligned to 4 kWin bytes and
// win_valid to kWin, so a full group of kWin windows moves in one word each.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) probe_xl_kernel(const XlArgs a) {
  typedef typename Group<kWin>::T T;
  typedef typename Group<kWin>::B B;
  const long long i0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kWin;
  const bool full = i0 + kWin <= a.n;
  u32 lo[kWin], hi[kWin];
  bool valid[kWin];
  if (kVec && full) {
    const T l = *reinterpret_cast<const T*>(a.idx_lo + i0);
    const T h = *reinterpret_cast<const T*>(a.idx_hi + i0);
    const B v = *reinterpret_cast<const B*>(a.win_valid + i0);
    memcpy(lo, &l, sizeof l);
    memcpy(hi, &h, sizeof h);
#pragma unroll
    for (int r = 0; r < kWin; ++r) valid[r] = ((v >> (8 * r)) & 0xFFu) != 0;
  } else {
#pragma unroll
    for (int r = 0; r < kWin; ++r) {
      const bool live = i0 + r < a.n;
      lo[r] = live ? a.idx_lo[i0 + r] : 0u;
      hi[r] = live ? a.idx_hi[i0 + r] : 0u;
      valid[r] = live && a.win_valid[i0 + r] != 0;
    }
  }

  // every bucket load in flight before the first match
  const u32 bmask = (1u << a.lgB) - 1u;
  uint4 v[kWin];
#pragma unroll
  for (int r = 0; r < kWin; ++r)
    v[r] = valid[r] ? load_row(a.table + (u64)(lo[r] & bmask))
                    : make_uint4(0u, 0u, 0u, 0u);

  u32 tag[kWin], pay[kWin];
  bool need[kWin];
#pragma unroll
  for (int r = 0; r < kWin; ++r) {
    const u32 rest = (lo[r] >> a.lgB) | (hi[r] << (32 - a.lgB));
    const u32 w[4] = {v[r].x, v[r].y, v[r].z, v[r].w};
    bool first = true;
    u32 t = 0, p0 = 0, p1 = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const u32 meta = w[s] >> 16;
      const u32 lt = meta >> 14;
      if (lt != 0 && (meta & kRestMask) == rest) {
        if (first) {
          p0 = w[s] & 0xFFFFu;
          first = false;
        } else {
          p1 += w[s] & 0xFFFFu;
        }
        t = lt > t ? lt : t;
      }
    }
    tag[r] = t;
    pay[r] = p0 | (p1 << 16);
    need[r] = a.has_side && valid[r] && first && ((v[r].x >> kFlagBit) & 1u);
  }

  bool any_need = false;
#pragma unroll
  for (int r = 0; r < kWin; ++r) any_need |= need[r];
  // has_side is uniform over the launch, so the whole warp takes this
  // branch together and every shuffle below has all 32 lanes
  if (a.has_side && __any_sync(kFull, any_need)) {
    const int lane = threadIdx.x & 31;
    // the side bucket of each window that needs it: 8 (rest2 | tag << 30)
    // words, then their 8 payloads
    const u32 smask = (1u << a.side_lgB) - 1u;
#pragma unroll
    for (int r = 0; r < kWin; ++r) {
      if (!need[r]) continue;
      const uint4* row = a.side + (u64)(lo[r] & smask) * 4;
      const u32 rest2 = (lo[r] >> a.side_lgB) | (hi[r] << (32 - a.side_lgB));
      uint4 q[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) q[c] = load_row(row + c);
      u32 t = 0, p = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const u32 w0[4] = {q[h].x, q[h].y, q[h].z, q[h].w};
        const u32 w1[4] = {q[2 + h].x, q[2 + h].y, q[2 + h].z, q[2 + h].w};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const u32 lt = w0[s] >> 30;
          if (lt != 0 && (w0[s] & 0x3FFFFFFFu) == rest2) {
            t += lt;
            p += w1[s];
          }
        }
      }
      tag[r] = t;
      pay[r] = p;
    }
    // the side stash: lane l holds rows l, l + 32, l + 64, l + 96
    uint4 st[kStashPerLane];
#pragma unroll
    for (int c = 0; c < kStashPerLane; ++c) {
      const int s = lane + 32 * c;
      st[c] = s < a.n_side_stash ? __ldg(a.side_stash + s)
                                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int r = 0; r < kWin; ++r) {
      u32 m = __ballot_sync(kFull, need[r]);
      while (m) {  // one window at a time, matched against every row
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const u32 wlo = __shfl_sync(kFull, lo[r], src);
        const u32 whi = __shfl_sync(kFull, hi[r], src);
        u32 t = 0, p = 0;
#pragma unroll
        for (int c = 0; c < kStashPerLane; ++c) {
          if (lane + 32 * c < a.n_side_stash && st[c].x == wlo &&
              st[c].y == whi) {
            t += st[c].z;
            p += st[c].w;
          }
        }
        t = __reduce_add_sync(kFull, t);
        p = __reduce_add_sync(kFull, p);
        if (lane == src) {
          tag[r] += t;
          pay[r] += p;
        }
      }
    }
  }

  if (kVec && full) {
    T t, p;
    memcpy(&t, tag, sizeof t);
    memcpy(&p, pay, sizeof p);
    *reinterpret_cast<T*>(a.tagv + i0) = t;
    *reinterpret_cast<T*>(a.payv + i0) = p;
  } else {
#pragma unroll
    for (int r = 0; r < kWin; ++r) {
      if (i0 + r < a.n) {
        a.tagv[i0 + r] = tag[r];
        a.payv[i0 + r] = pay[r];
      }
    }
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
    const XlArgs a{(const u32*)idx_hi,  (const u32*)idx_lo,
                   (const uint8_t*)win_valid, n,
                   (const uint4*)table, lgB,
                   (const uint4*)side, side_lgB,
                   has_side,            (const uint4*)side_stash,
                   n_side_stash,        (u32*)tagv,
                   (u32*)payv};
    const bool vec = (((uintptr_t)idx_hi | (uintptr_t)idx_lo |
                       (uintptr_t)tagv | (uintptr_t)payv) &
                      (4 * kWin - 1)) == 0 &&
                     ((uintptr_t)win_valid & (kWin - 1)) == 0;
    const unsigned grid = grid_for((n + kWin - 1) / kWin, kThreads);
    if (vec)
      probe_xl_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
    else
      probe_xl_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
