// K2, the hashed probe: one bucket load per window, then the stash.
//
// Replaces shark_tpu/classify/hashed.py classify_kernel_hashed
// (:542), its entry16 branch (:595-615), its entry8 branch (:616-627)
// and the stash compare (:629-644); the entry16 match is also what
// bench/pallas_vmem_match.py make_pallas_match computed in Pallas.
//
// One thread per window. The bucket of window p is b = lo & (2^lgB - 1)
// and the stored remainder rest = lo >> lgB | hi << (32 - lgB).
//   entry16: the bucket is `slots` (4 or 8) u32 words (meta16 << 16 |
//     payload16); meta16 = tag << 14 | rest. A degree-2 or row entry spans
//     two adjacent words, so up to two lanes match: payv = first match's
//     low half | (sum of later matches) << 16, tagv = max matching tag.
//   entry8: the bucket is planar [2][8] (w0 = tag << 30 | rest, w1 =
//     payload); at most one lane matches, so tag and payload are masked
//     sums.
// Then every stash row (pos_lo, pos_hi, tag, payload) whose full position
// equals the window's is added to (tagv, payv); a position lives in the
// table or in the stash, never both, so the add never mixes entries.
//
// Bound: bytes. Per window the kernel must read 9 bytes (hi, lo, valid)
// and one 32-byte (entry16) or 64-byte (entry8) bucket, and write 8. The
// 16-32 MB tables of gene panels fit the card's 50 MB L2, so the random
// bucket loads are mostly L2 hits.
//
// The design:
// - the layout (entry16 with 8 or 4 slots, entry8) is a template
//   parameter picked on the host, so every 16-byte load of the bucket
//   (two, one or four) is issued before the first compare; an invalid
//   window loads none;
// - the stash costs what it holds, not what it is padded to. The host
//   passes the count of rows before the stash's trailing padding rows
//   (0xFFFFFFFF in all four words, which _pad_stash appends). Each block
//   puts those rows in a small open-addressing table in shared memory,
//   keyed by a hash of the whole position (lo, hi): windows crowd into
//   the overflowing buckets that spilled to the stash, so a key of the
//   bucket bits alone would send many of them to the rows. A window walks
//   its hash's run of occupied slots (at most a quarter of the slots are
//   occupied, so most windows read one empty slot) and adds every row of
//   that run whose position equals its own, duplicates included. The
//   trailing padding rows add n_tail * 0xFFFFFFFF to both sums of a valid
//   window at (0xFFFFFFFF, 0xFFFFFFFF), in closed form. An empty stash
//   builds no table and runs no barrier. Warp 0 builds the table while
//   its bucket loads are in flight, from stash rows it loads before the
//   windows, and the one barrier comes after every warp's bucket match,
//   just before the first lookup. Measured on the card
//   (scripts/probe_variants.py, the homolog index's 16 MB table and 6-row
//   stash): 1.17x the device time of P2's match on the same buckets, and
//   P2's time without a stash. The barrier before the match instead of
//   after it cost 7%; a table built by every warp for itself (no
//   barrier), and one built by the whole block (two barriers, the rows
//   loaded after the windows), cost 5-7% more than that.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStash = 256;  // STASH_CAP
constexpr u32 kPad = 0xFFFFFFFFu;

enum Layout { kEntry16x8, kEntry16x4, kEntry8 };

struct ProbeArgs {
  const u32* idx_hi;
  const u32* idx_lo;
  const uint8_t* win_valid;
  long long n;
  const uint4* table;
  int lgB;
  const uint4* stash;
  int n_real;  // rows [0, n_real) go to the shared table
  u32 n_tail;  // trailing padding rows
  int lg_slots;
  u32* tagv;
  u32* payv;
};

// The slot of position (lo, hi) in a table of 2^lg slots, 6 <= lg <= 10.
__device__ __forceinline__ u32 stash_slot(u32 lo, u32 hi, int lg) {
  u32 h = lo * 0x9E3779B1u ^ (hi + 0x7F4A7C15u) * 0x85EBCA77u;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  return h >> (32 - lg);
}

template <Layout kLayout>
struct Bucket {
  static constexpr int kLoads =
      kLayout == kEntry16x8 ? 2 : (kLayout == kEntry16x4 ? 1 : 4);
};

template <Layout kLayout>
__global__ void __launch_bounds__(kThreads) probe_kernel(const ProbeArgs a) {
  constexpr int kLoads = Bucket<kLayout>::kLoads;
  extern __shared__ u32 slot_row[];  // [2^lg_slots]: stash row + 1, or 0
  // warp 0 builds the stash's table; its first row a lane is loaded
  // before the windows, so that its latency hides behind theirs (n_real
  // is uniform over the launch)
  const int lane = threadIdx.x & 31;
  const bool build_warp = a.n_real > 0 && threadIdx.x < 32;
  uint2 pos0 = make_uint2(0u, 0u);
  if (build_warp && lane < a.n_real)
    pos0 = *reinterpret_cast<const uint2*>(a.stash + lane);

  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < a.n;
  const u32 lo = live ? a.idx_lo[i] : 0u;
  const u32 hi = live ? a.idx_hi[i] : 0u;
  const bool valid = live && a.win_valid[i] != 0;

  // the bucket's loads, all in flight before the first compare
  uint4 v[kLoads];
  const uint4* row = a.table + (u64)(lo & ((1u << a.lgB) - 1u)) * kLoads;
#pragma unroll
  for (int q = 0; q < kLoads; ++q)
    v[q] = valid ? row[q] : make_uint4(0u, 0u, 0u, 0u);

  const u32 smask = (1u << a.lg_slots) - 1u;
  if (build_warp) {
    for (u32 j = lane; j <= smask; j += 32) slot_row[j] = 0;
    __syncwarp();
    for (int s = lane; s < a.n_real; s += 32) {
      const uint2 p =
          s == lane ? pos0 : *reinterpret_cast<const uint2*>(a.stash + s);
      u32 h = stash_slot(p.x, p.y, a.lg_slots);
      while (atomicCAS(&slot_row[h], 0u, (u32)s + 1u) != 0u)
        h = (h + 1u) & smask;
    }
  }

  const u32 rest = (lo >> a.lgB) | (hi << (32 - a.lgB));
  u32 tag = 0, pay = 0;
  if constexpr (kLayout == kEntry8) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const u32 w0[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
      const u32 w1[4] = {v[2 + q].x, v[2 + q].y, v[2 + q].z, v[2 + q].w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const u32 lt = w0[r] >> 30;
        if (lt != 0 && (w0[r] & 0x3FFFFFFFu) == rest) {
          tag += lt;
          pay += w1[r];
        }
      }
    }
  } else {
    bool first = true;
    u32 p0 = 0, p1 = 0;
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const u32 w[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const u32 meta = w[r] >> 16;
        const u32 lt = meta >> 14;
        if (lt != 0 && (meta & 0x3FFFu) == rest) {
          if (first) {
            p0 = w[r] & 0xFFFFu;
            first = false;
          } else {
            p1 += w[r] & 0xFFFFu;
          }
          tag = lt > tag ? lt : tag;
        }
      }
    }
    pay = p0 | (p1 << 16);
  }

  // every warp waits for its bucket before this barrier, and warp 0 builds
  // the table meanwhile
  if (a.n_real > 0) __syncthreads();
  if (!live) return;
  if (valid) {
    if (a.n_real > 0) {
      u32 h = stash_slot(lo, hi, a.lg_slots);
      for (u32 s = slot_row[h]; s != 0u; s = slot_row[h]) {
        const uint4 e = __ldg(a.stash + (s - 1u));
        if (e.x == lo && e.y == hi) {
          tag += e.z;
          pay += e.w;
        }
        h = (h + 1u) & smask;
      }
    }
    if (lo == kPad && hi == kPad) {  // n_tail rows of 0xFFFFFFFF
      tag -= a.n_tail;
      pay -= a.n_tail;
    }
  }
  a.tagv[i] = tag;
  a.payv[i] = pay;
}

template <Layout kLayout>
void launch(const ProbeArgs& a, cudaStream_t st) {
  const size_t smem = a.n_real > 0 ? sizeof(u32) << a.lg_slots : 0;
  probe_kernel<kLayout><<<grid_for(a.n, kThreads), kThreads, smem, st>>>(a);
}

}  // namespace

// n_real: the stash rows before its trailing rows of 0xFFFFFFFF (of
// n_stash in all); those trailing rows are never read.
extern "C" int shkk_probe(const void* idx_hi, const void* idx_lo,
                          const void* win_valid, long long n,
                          const void* table, int lgB, int entry16, int slots,
                          const void* stash, int n_stash, int n_real,
                          void* tagv, void* payv, void* stream) {
  if (n_stash > kMaxStash || n_real < 0 || n_real > n_stash || lgB < 1 ||
      lgB > 31 || (entry16 && slots != 8 && slots != 4) ||
      (!entry16 && slots != 8))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    int lg = 6;  // at most a quarter of the slots hold a row
    while ((1 << lg) < 4 * n_real) ++lg;
    const ProbeArgs a{(const u32*)idx_hi,    (const u32*)idx_lo,
                      (const uint8_t*)win_valid, n,
                      (const uint4*)table,   lgB,
                      (const uint4*)stash,   n_real,
                      (u32)(n_stash - n_real), lg,
                      (u32*)tagv,            (u32*)payv};
    cudaStream_t st = (cudaStream_t)stream;
    if (!entry16)
      launch<kEntry8>(a, st);
    else if (slots == 8)
      launch<kEntry16x8>(a, st);
    else
      launch<kEntry16x4>(a, st);
  }
  return (int)cudaGetLastError();
}
