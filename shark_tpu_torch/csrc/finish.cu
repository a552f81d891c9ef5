// K3, the finish: per-window (tag, payload) -> per-read verdicts.
//
// Replaces shark_tpu/classify/step.py finish_from_tags (:869) with
// finish_from_keys (:772), keys_from_gm (:700), compact_true_cols (:493)
// and the packed verdict layout (:366-372).
//
// Per read, the keys (gene << pos_bits | pos) are: one or two direct
// keys for tag 1/2 windows, the inline genes of a tag-3 window's rows3
// row, and for rows past the inline width the genes of their extension
// row (only the first EXT_CAP2 such windows of a read, in column order;
// more, or a row wider than the extension, sets the overflow bit). The
// keys are sorted; a gene's segment scores coverage (head k, then
// min(k, pos - previous pos)) and hits; best = max cov*(L+1)+hits over
// segments; the winners are every segment scoring best (best > 0), in
// ascending gene order, W wide and -1 padded; emit = cov >= thresh[len].
// Only the multiset of valid keys matters, so the kernel builds the
// valid keys alone, in any order, and sorts them.
//
// The group fast path (step.py:1004-1168) changes verdicts batch-wide:
// with n_fix = reads that hit rows but are not pure, a batch with
// n_fix <= FIX_CAP2 gives every pure read (all hits are rows of one gene
// set) the GROUP verdict of its set scored as one pseudo gene (id
// n_genes), and every other read its full verdict; a batch past FIX_CAP2
// gives every read its full verdict.
//
// Bound: operations, the sort of each read's keys (chip_smoke.py counts
// nk log2 nk + 10 nk a read). The bytes (8 per window in, 12 + 4W per
// read out, the rows touched) take less time.
//
// The first design gave every read a block of 128 threads: a panel read
// has 60-176 keys, so most threads idled, and each read paid 40-50
// __syncthreads (a bitonic sort with a barrier per pass, block scans of 3
// barriers each) with key slots taken by shared atomics and two binary
// searches per key for its segment head. This design sizes the work to
// the read, after the same group pass (one warp per read, counting n_fix
// on the device before any verdict):
// - warp pass, one warp per read: it builds the keys 32 windows at a
//   time, a shuffle scan of the per-window key counts giving each lane
//   its slots in a per-warp shared slice, and moves them to registers
//   (key i = register i / 32 of lane i % 32, the next power of two of nk,
//   32 to kWarpCap = 256 keys). Keys are built in column order, so keys
//   that already ascend (one gene: most reads of a panel) skip the sort;
//   the rest take a register bitonic sort (__shfl_xor_sync across lanes,
//   compare-exchange within a lane). Then one pass of shuffle scans per
//   register: the coverage prefix sum, and a max-scan of each segment's
//   head (its prefix and index packed in one int) in place of the binary
//   search; best is a warp max, and the winners' ranks are ballots and
//   popcounts. No block barrier;
// - block path for the rest: a read past kWarpCap keys, or with a row past
//   the inline width while an extension table exists, is appended by its
//   warp to a list on the device (atomic counter, index array). The first
//   design's block code runs on that list alone, a persistent grid (as
//   many blocks as fit on the card at once) that reads the list's length
//   on the device (no host sync), with 256 threads, shift arithmetic in
//   the sort, and a block max-scan for the segment heads in place of the
//   binary searches. Its keys live in dynamic shared memory when the
//   geometry's key bound fits, else in a global scratch slice per block.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // block path
constexpr int kChunkLog2 = 8;   // keys a warp of the block path sorts
constexpr int kChunk = 1 << kChunkLog2;  // in registers (step.py key_cap)
constexpr int kWarpCap = 256;  // step.FINISH_WARP_CAP
constexpr int kLightWarps = 4;  // warps per block of the warp path
constexpr u32 kFull = 0xffffffffu;
constexpr u32 kNoKey = 0xffffffffu;  // sorts after every key (keys < 2^31)
constexpr int kExtCap2 = 16;  // step.py EXT_CAP2
constexpr u32 kTagD1 = 1, kTagD2 = 2, kTagRow = 3;
constexpr int kPackNwShift = 16, kPackEmitShift = 21, kPackOvfShift = 22,
              kPackGrpShift = 23, kNwSat = 31;

// flags of the group pass
constexpr uint8_t kPure = 1, kNeedFix = 2;

// The group pass, one warp per read: any direct hit, any row hit, min and
// max group id over row hits; n_fix counts the impure row-hitting reads.
__global__ void groups_kernel(const u32* __restrict__ tagv,
                              const u32* __restrict__ payv, int B, int Ls,
                              int rb, uint8_t* __restrict__ flags,
                              int32_t* __restrict__ gmax_out,
                              int32_t* __restrict__ n_fix) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= B) return;  // whole warps exit together
  const u32* t = tagv + (long long)warp * Ls;
  const u32* p = payv + (long long)warp * Ls;
  bool any_direct = false, any_row = false;
  int gmin = INT32_MAX, gmax = -1;
  for (int j = lane; j < Ls; j += 32) {
    const u32 tag = t[j];
    if (tag == kTagD1 || tag == kTagD2) any_direct = true;
    if (tag == kTagRow) {
      any_row = true;
      const int g = (int)(p[j] >> rb);
      gmin = min(gmin, g);
      gmax = max(gmax, g);
    }
  }
  any_direct = __any_sync(kFull, any_direct);
  any_row = __any_sync(kFull, any_row);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    gmin = min(gmin, __shfl_xor_sync(kFull, gmin, o));
    gmax = max(gmax, __shfl_xor_sync(kFull, gmax, o));
  }
  if (lane == 0) {
    const bool pure = any_row && !any_direct && gmax == gmin;
    const bool need_fix = any_row && !pure;
    flags[warp] = (pure ? kPure : 0) | (need_fix ? kNeedFix : 0);
    gmax_out[warp] = gmax;
    if (need_fix) atomicAdd(n_fix, 1);
  }
}

struct ReadsArgs {
  const u32* tagv;
  const u32* payv;
  const int32_t* length;
  const int32_t* thresh;
  const u32* rows3;
  int n3, rows3_w, D;
  const uint16_t* ext_mat;
  int ext_w;
  int B, Ls, L, k, pos_bits, n_genes, rb, W;
  int has_rows, groups;
  const uint8_t* flags;  // per read: kPure, kNeedFix
  const int32_t* gmax;   // per read: largest group id over its row windows
  const int32_t* n_fix;  // impure row-hitting reads of the batch
  int fix_cap2;
  int key_cap;
  u32* scratch;  // null: the block path's keys live in shared memory
  int32_t* n_heavy;  // length of the block path's list
  int32_t* heavy;    // the list: read indices
  int32_t* packed;
  int32_t* winners;
  int32_t* best_cov;
};

__device__ __forceinline__ u32 row_field(const u32* row, int i) {
  const u32 w = row[i >> 1];
  return (i & 1) ? (w >> 16) : (w & 0xFFFFu);
}

__device__ __forceinline__ const u32* row_of(const ReadsArgs& a, u32 pay) {
  u32 ridx = a.rb ? (pay & ((1u << a.rb) - 1u)) : pay;
  if (ridx >= (u32)a.n3) ridx = a.n3 - 1;
  return a.rows3 + (u64)ridx * a.rows3_w;
}

__device__ __forceinline__ bool group_mode(const ReadsArgs& a) {
  return a.groups && (*a.n_fix <= a.fix_cap2);
}

// The packed verdict, written once per read.
__device__ __forceinline__ void write_verdict(const ReadsArgs& a, int b,
                                              bool pure, int best, int nw,
                                              int w0, int ovf) {
  const int M = a.L + 1;
  const int best_cov = best / M;
  int len = a.length[b];
  len = len < 0 ? 0 : (len > a.L ? a.L : len);
  const int emit = best_cov >= a.thresh[len] ? 1 : 0;
  int packed;
  if (pure) {
    packed = max(a.gmax[b], 0) | (1 << kPackNwShift) |
             (emit << kPackEmitShift) | (1 << kPackGrpShift);
  } else {
    const int nw_sat = nw < kNwSat ? nw : kNwSat;
    packed = max(w0, 0) | (nw_sat << kPackNwShift) |
             (emit << kPackEmitShift) | (ovf << kPackOvfShift);
  }
  a.packed[b] = packed;
  a.best_cov[b] = best_cov;
}

// ---------------------------------------------------------------------------
// warp path
// ---------------------------------------------------------------------------

__device__ __forceinline__ int warp_incl_sum(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

__device__ __forceinline__ int warp_incl_max(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x = max(x, y);
  }
  return x;
}

// One bitonic merge level of 32 * NR keys held by a warp (key i in
// key[i >> 5] of lane i & 31, at index base + i of the whole sequence):
// the compare-exchange steps of the level `size`, strides from `top` down
// to 1. Direction by the whole sequence's index, as the network has it.
template <int NR>
__device__ __forceinline__ void warp_bitonic_merge(u32 (&key)[NR], int lane,
                                                   int base, int size,
                                                   int top) {
#pragma unroll
  for (int stride = top; stride > 0; stride >>= 1) {
    if (stride >= 32) {  // partner in another register of this lane
      const int rs = stride >> 5;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (r & rs) continue;
        const bool asc = ((base + r * 32) & size) == 0;
        const u32 x = key[r], y = key[r | rs];
        if ((x > y) == asc) {
          key[r] = y;
          key[r | rs] = x;
        }
      }
    } else {  // partner in lane ^ stride, same register
      const bool lower = (lane & stride) == 0;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const u32 x = key[r];
        const u32 y = __shfl_xor_sync(kFull, x, stride);
        const bool asc = ((base + r * 32 + lane) & size) == 0;
        key[r] = (lower == asc) ? min(x, y) : max(x, y);
      }
    }
  }
}

// The levels of a bitonic sort up to 32 * NR: sorts the warp's keys,
// ascending when (base & 32 * NR) == 0, else descending.
template <int NR>
__device__ __forceinline__ void warp_bitonic_sort(u32 (&key)[NR], int lane,
                                                  int base) {
#pragma unroll
  for (int size = 2; size <= 32 * NR; size <<= 1)
    warp_bitonic_merge<NR>(key, lane, base, size, size >> 1);
}

// Key i + 1 beside key i = r * 32 + lane (kNoKey past the last register).
template <int NR>
__device__ __forceinline__ u32 next_key(const u32 (&key)[NR], int r,
                                        int lane) {
  const u32 down = __shfl_down_sync(kFull, key[r], 1);
  const u32 wrap =
      r + 1 < NR ? __shfl_sync(kFull, key[r + 1 < NR ? r + 1 : r], 0) : kNoKey;
  return lane == 31 ? wrap : down;
}

// Sorts, scores and writes the verdict of one read whose nk keys are in
// sk[0 .. nk), nk <= 32 * NR. Key i lives in key[i >> 5] of lane i & 31.
template <int NR>
__device__ __forceinline__ void finish_warp(const ReadsArgs& a, int b,
                                            const u32* sk, int nk, bool pure,
                                            int lane) {
  u32 key[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int i = r * 32 + lane;
    key[r] = i < nk ? sk[i] : kNoKey;
  }

  // ---- sort, unless the keys already ascend ----
  // The keys were built in column order, so a read whose hits are all one
  // gene (a pure read under its group verdict, most direct reads) needs
  // no sort.
  // (every lane shuffles for every register: no short-circuit around
  // next_key, whose full-mask shuffles would wait for a lane that left)
  bool ordered = true;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const u32 next = next_key<NR>(key, r, lane);
    ordered = ordered && key[r] <= next;
  }
  if (!__all_sync(kFull, ordered)) warp_bitonic_sort<NR>(key, lane, 0);

  const int pb = a.pos_bits;
  const u32 pmask = (1u << pb) - 1u;
  const int M = a.L + 1;
  int32_t* win = a.winners + (long long)b * a.W;

  // ---- one gene (most reads): a single segment, no scans ----
  const u32 g_first = __shfl_sync(kFull, key[0], 0) >> pb;
  bool one_gene = true;
#pragma unroll
  for (int r = 0; r < NR; ++r)
    one_gene = one_gene && (r * 32 + lane >= nk || (key[r] >> pb) == g_first);
  if (__all_sync(kFull, one_gene)) {
    int cov = 0;
    u32 prev_last = 0;  // key r * 32 - 1
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int i = r * 32 + lane;
      u32 prev = __shfl_up_sync(kFull, key[r], 1);
      if (lane == 0) prev = prev_last;
      if (i < nk) {
        const int d = (int)(key[r] & pmask) - (int)(prev & pmask);
        cov += i == 0 ? a.k : (d < a.k ? d : a.k);
      }
      prev_last = __shfl_sync(kFull, key[r], 31);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cov += __shfl_xor_sync(kFull, cov, o);
    const int nw = nk > 0 ? 1 : 0;
    for (int q = nw + lane; q < a.W; q += 32) win[q] = -1;
    if (lane == 0) {
      if (nw && a.W > 0) win[0] = (int)g_first;
      write_verdict(a, b, pure, nw ? cov * M + nk : 0, nw,
                    nw ? (int)g_first : -1, 0);
    }
    return;
  }

  // ---- segments: coverage prefix, head by max-scan, score at the end ----
  int score[NR];
  int carry_sum = 0;   // coverage prefix through the previous register
  int carry_head = 0;  // (prefix before the head) << 9 | head index
  u32 prev_last = kNoKey;
  int best = 0;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int i = r * 32 + lane;
    const u32 x = key[r];
    u32 prev = __shfl_up_sync(kFull, x, 1);
    if (lane == 0) prev = prev_last;
    const u32 next = next_key<NR>(key, r, lane);
    const bool valid = i < nk;
    const u32 g = x >> pb;
    const bool start = valid && (i == 0 || (prev >> pb) != g);
    const bool end = valid && (next >> pb) != g;
    int contrib = 0;
    if (valid) {
      const int d = (int)(x & pmask) - (int)(prev & pmask);
      contrib = start ? a.k : (d < a.k ? d : a.k);
    }
    const int cs = carry_sum + warp_incl_sum(contrib, lane);
    const int head = max(carry_head,
                         warp_incl_max(start ? ((cs - contrib) << 9) | i : 0,
                                       lane));
    score[r] = end ? (cs - (head >> 9)) * M + (i - (head & 511) + 1) : 0;
    best = max(best, score[r]);
    carry_sum = __shfl_sync(kFull, cs, 31);
    carry_head = __shfl_sync(kFull, head, 31);
    prev_last = __shfl_sync(kFull, x, 31);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    best = max(best, __shfl_xor_sync(kFull, best, o));

  // ---- winners: segment ends scoring best, ascending gene ----
  int nw = 0, w0 = -1;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const bool is_win = best > 0 && score[r] == best;
    const u32 bal = __ballot_sync(kFull, is_win);
    if (is_win) {
      const int rank = nw + __popc(bal & ((1u << lane) - 1u));
      if (rank < a.W) win[rank] = (int)(key[r] >> pb);
    }
    const u32 first = __shfl_sync(kFull, key[r], bal ? __ffs(bal) - 1 : 0);
    if (w0 < 0 && bal) w0 = (int)(first >> pb);
    nw += __popc(bal);
  }
  for (int q = nw + lane; q < a.W; q += 32) win[q] = -1;
  if (lane == 0) write_verdict(a, b, pure, best, nw, w0, 0);
}

// The verdict of read b by its warp: the keys go into the warp's shared
// slice sk in column order, then to registers; a read with more than
// kWarpCap keys, or a row that needs its extension row, goes to the block
// path's list instead. `pure`: the read takes its group verdict.
__device__ __forceinline__ void warp_read(const ReadsArgs& a, int b,
                                          bool pure, u32* sk, int lane) {
  const u32* tg = a.tagv + (long long)b * a.Ls;
  const u32* py = a.payv + (long long)b * a.Ls;
  const int off = a.L - a.Ls;
  const int pb = a.pos_bits;
  const int D = a.D;
  int nk = 0;
  // the windows 32 at a time, the next 32 loaded while these are keyed
  u32 tag_next = lane < a.Ls ? tg[lane] : 0u;
  u32 pay_next = lane < a.Ls ? py[lane] : 0u;
  for (int base = 0; base < a.Ls; base += 32) {
    const int j = base + lane;
    const u32 tag = tag_next, pay = pay_next;
    const int jn = j + 32;
    tag_next = jn < a.Ls ? tg[jn] : 0u;
    pay_next = jn < a.Ls ? py[jn] : 0u;
    int cnt = 0;
    bool needy = false;
    const u32* row = nullptr;
    if (tag == kTagD1) {
      cnt = 1;
    } else if (tag == kTagD2) {
      cnt = 2;
    } else if (tag == kTagRow && a.has_rows) {
      if (pure) {
        cnt = 1;
      } else {
        row = row_of(a, pay);
        const int deg = (int)row_field(row, 0);
        if (a.ext_w == 0) {
          cnt = deg < D ? deg : D;
        } else if (deg > D) {
          needy = true;
        } else {
          cnt = deg;
        }
      }
    }
    const int incl = warp_incl_sum(cnt, lane);
    const int total = __shfl_sync(kFull, incl, 31);
    if (__any_sync(kFull, needy) || nk + total > kWarpCap) {
      if (lane == 0) a.heavy[atomicAdd(a.n_heavy, 1)] = b;
      return;
    }
    const u32 pos = (u32)(off + j);
    const int at = nk + incl - cnt;
    if (tag == kTagD1 || tag == kTagD2) {
      sk[at] = ((pay & 0xFFFFu) << pb) | pos;
      if (cnt == 2) sk[at + 1] = ((pay >> 16) << pb) | pos;
    } else if (pure) {
      if (cnt) sk[at] = ((u32)a.n_genes << pb) | pos;
    } else {
      for (int d = 0; d < cnt; ++d)
        sk[at + d] = (row_field(row, 1 + d) << pb) | pos;
    }
    nk += total;
  }
  __syncwarp();
  if (nk <= 32) {
    finish_warp<1>(a, b, sk, nk, pure, lane);
  } else if (nk <= 64) {
    finish_warp<2>(a, b, sk, nk, pure, lane);
  } else if (nk <= 128) {
    finish_warp<4>(a, b, sk, nk, pure, lane);
  } else {
    finish_warp<8>(a, b, sk, nk, pure, lane);
  }
  __syncwarp();  // sk is rewritten by the warp's next read
}

// One warp per read, after the group pass.
__global__ void __launch_bounds__(kLightWarps * 32)
    warp_kernel(const ReadsArgs a) {
  __shared__ u32 s_keys[kLightWarps][kWarpCap];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int b = blockIdx.x * kLightWarps + wib;
  if (b >= a.B) return;  // whole warps exit together
  const bool pure = group_mode(a) && (a.flags[b] & kPure);
  warp_read(a, b, pure, s_keys[wib], lane);
}

// ---------------------------------------------------------------------------
// block path
// ---------------------------------------------------------------------------

// Block-wide inclusive max-scan of one non-negative long long per thread;
// every thread gets the block's max in `total`. sh64 holds >= 33 values.
// Contains __syncthreads, so every thread of the block must call it.
__device__ __forceinline__ long long block_incl_max64(long long v,
                                                      long long* sh64,
                                                      long long& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = max(v, y);
  }
  if (lane == 31) sh64[warp] = v;
  __syncthreads();
  if (warp == 0) {
    long long x = lane < nwarps ? sh64[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x = max(x, y);
    }
    if (lane < nwarps) sh64[lane] = x;
    if (lane == 31) sh64[32] = x;
  }
  __syncthreads();
  const long long out = warp > 0 ? max(v, sh64[warp - 1]) : v;
  total = sh64[32];
  __syncthreads();  // sh64 may be reused by the caller's next scan
  return out;
}

// One block per listed read, a persistent grid over the list.
__global__ void __launch_bounds__(kThreads)
    block_kernel(const ReadsArgs a) {
  extern __shared__ u32 smem[];
  __shared__ int sh[33];
  __shared__ long long sh64[33];
  __shared__ int s_nk;
  __shared__ int s_ovf;
  __shared__ int s_w0;
  u32* keys;
  if (a.scratch) {
    keys = a.scratch + (long long)blockIdx.x * 2 * a.key_cap;
  } else {
    keys = smem;
  }
  int32_t* score = reinterpret_cast<int32_t*>(keys + a.key_cap);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int D = a.D;
  const int off = a.L - a.Ls;
  const int pb = a.pos_bits;
  const u32 pmask = (1u << pb) - 1u;
  const bool gmode = group_mode(a);
  const int n_list = *a.n_heavy;

  for (int h = blockIdx.x; h < n_list; h += gridDim.x) {
    const int b = a.heavy[h];
    const bool pure = gmode && (a.flags[b] & kPure);
    const u32* tg = a.tagv + (long long)b * a.Ls;
    const u32* py = a.payv + (long long)b * a.Ls;
    if (tid == 0) {
      s_nk = 0;
      s_ovf = 0;
      s_w0 = -1;
    }
    __syncthreads();

    // ---- keys: direct, inline row genes, pseudo gene (pure reads) ----
    int n_needy = 0;
    for (int j = tid; j < a.Ls; j += blockDim.x) {
      const u32 tag = tg[j];
      const u32 pay = py[j];
      const u32 pos = (u32)(off + j);
      if (tag == kTagD1 || tag == kTagD2) {
        const int c = tag == kTagD2 ? 2 : 1;
        const int at = atomicAdd(&s_nk, c);
        keys[at] = ((pay & 0xFFFFu) << pb) | pos;
        if (c == 2) keys[at + 1] = ((pay >> 16) << pb) | pos;
      } else if (tag == kTagRow && a.has_rows) {
        if (pure) {
          keys[atomicAdd(&s_nk, 1)] = ((u32)a.n_genes << pb) | pos;
        } else {
          const u32* row = row_of(a, pay);
          const int deg = (int)row_field(row, 0);
          int nin;
          if (a.ext_w == 0) {
            nin = deg < D ? deg : D;
          } else if (deg > D) {
            nin = D - 2;
            ++n_needy;
          } else {
            nin = deg;
          }
          if (nin > 0) {
            const int at = atomicAdd(&s_nk, nin);
            for (int d = 0; d < nin; ++d)
              keys[at + d] = (row_field(row, 1 + d) << pb) | pos;
          }
        }
      }
    }
    // ---- extension rows: the first EXT_CAP2 needy windows by column ----
    int total_needy;
    block_exclusive_scan(n_needy, sh, total_needy);
    if (total_needy > 0) {
      bool ovf = total_needy > kExtCap2 || a.ext_mat == nullptr;
      int carry = 0;
      for (int base = 0; base < a.Ls; base += blockDim.x) {
        const int j = base + tid;
        int needy = 0, deg = 0;
        const u32* row = nullptr;
        if (j < a.Ls && tg[j] == kTagRow) {
          row = row_of(a, py[j]);
          deg = (int)row_field(row, 0);
          needy = deg > D;
        }
        int chunk_total;
        const int rank = carry + block_exclusive_scan(needy, sh, chunk_total);
        carry += chunk_total;
        if (needy) {
          const int resid = deg - (D - 2);
          if (resid > a.ext_w) ovf = true;
          if (rank < kExtCap2 && a.ext_mat != nullptr) {
            const u32 erow =
                row_field(row, D - 1) | (row_field(row, D) << 16);
            const uint16_t* eg = a.ext_mat + (u64)erow * a.ext_w;
            const int take = resid < a.ext_w ? resid : a.ext_w;
            const u32 pos = (u32)(off + j);
            const int at = atomicAdd(&s_nk, take);
            for (int d = 0; d < take; ++d)
              keys[at + d] = ((u32)eg[d] << pb) | pos;
          }
        }
      }
      if (ovf) s_ovf = 1;  // benign race: every writer stores 1
    }
    __syncthreads();
    const int nk = s_nk;

    // ---- bitonic sort of keys[0 .. n2), n2 >= 256, sentinel padded:
    // each warp sorts its 256-key chunks in registers; each level past 256
    // takes its strides >= 256 through shared memory, one barrier each,
    // and the rest in registers ----
    int n2 = kChunk;
    while (n2 < nk) n2 <<= 1;
    for (int i = nk + tid; i < n2; i += blockDim.x) keys[i] = kNoKey;
    __syncthreads();
    for (int size = kChunk; size <= n2; size <<= 1) {
      for (int ls = __ffs(size) - 2; ls >= kChunkLog2; --ls) {
        const int stride = 1 << ls;
        for (int i = tid; i < (n2 >> 1); i += blockDim.x) {
          const int lo = ((i >> ls) << (ls + 1)) | (i & (stride - 1));
          const int hi = lo + stride;
          const bool asc = (lo & size) == 0;
          const u32 x = keys[lo], y = keys[hi];
          if ((x > y) == asc) {
            keys[lo] = y;
            keys[hi] = x;
          }
        }
        __syncthreads();
      }
      for (int c = warp * kChunk; c < n2; c += nwarps * kChunk) {
        u32 kr[kChunk / 32];
#pragma unroll
        for (int r = 0; r < kChunk / 32; ++r) kr[r] = keys[c + r * 32 + lane];
        if (size == kChunk)
          warp_bitonic_sort<kChunk / 32>(kr, lane, c);
        else
          warp_bitonic_merge<kChunk / 32>(kr, lane, c, size, kChunk / 2);
#pragma unroll
        for (int r = 0; r < kChunk / 32; ++r) keys[c + r * 32 + lane] = kr[r];
      }
      __syncthreads();
    }

    // ---- segments: the coverage prefix and each key's segment head by
    // block scans (the head's prefix and index in one 64-bit max-scan);
    // each segment end's cov * M + hits into score[] ----
    const int M = a.L + 1;
    int carry = 0, best = 0;
    long long carry_head = 0;
    for (int base = 0; base < nk; base += blockDim.x) {
      const int i = base + tid;
      int contrib = 0;
      bool start = false, end = false;
      if (i < nk) {
        const u32 key = keys[i];
        const u32 prev = keys[i > 0 ? i - 1 : 0];
        const u32 g = key >> pb;
        start = i == 0 || (prev >> pb) != g;
        end = i + 1 == nk || (keys[i + 1] >> pb) != g;
        const int d = (int)(key & pmask) - (int)(prev & pmask);
        contrib = start ? a.k : (d < a.k ? d : a.k);
      }
      int chunk_total;
      const int cs = carry + block_exclusive_scan(contrib, sh, chunk_total) +
                     contrib;
      carry += chunk_total;
      long long chunk_head;
      const long long head = max(
          carry_head,
          block_incl_max64(start ? ((long long)(cs - contrib) << 32) | i : 0,
                           sh64, chunk_head));
      carry_head = max(carry_head, chunk_head);
      if (i < nk) {
        const int sc = end ? (cs - (int)(head >> 32)) * M +
                                 (i - (int)(head & 0xFFFFFFFF) + 1)
                           : 0;
        score[i] = sc;
        best = max(best, sc);
      }
    }
    best = block_max(best, sh);

    // ---- winners: segment ends scoring best, ascending gene ----
    int nw = 0;
    for (int base = 0; base < nk; base += blockDim.x) {
      const int i = base + tid;
      const bool win = best > 0 && i < nk && score[i] == best;
      int chunk_total;
      const int rank = nw + block_exclusive_scan(win ? 1 : 0, sh, chunk_total);
      if (win) {
        const int g = (int)(keys[i] >> pb);
        if (rank < a.W) a.winners[(long long)b * a.W + rank] = g;
        if (rank == 0) s_w0 = g;
      }
      nw += chunk_total;
    }
    for (int r = nw + tid; r < a.W; r += blockDim.x)
      a.winners[(long long)b * a.W + r] = -1;
    __syncthreads();

    if (tid == 0) write_verdict(a, b, pure, best, nw, s_w0, s_ovf);
    __syncthreads();  // shared state is rewritten by the next read
  }
}

}  // namespace

// Blocks of a kernel that fit on the card at once. Asked of the runtime
// once per calling thread, kernel and shared-memory size; any grid is
// correct, since the persistent kernel loops over its list.
struct Resident {
  int smem = -1, blocks = 0;
};

static cudaError_t resident_blocks(const void* kernel, int threads,
                                   size_t smem, Resident& cache, int& out) {
  if ((int)smem != cache.smem) {
    int dev = 0, n_sm = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads, smem);
    if (e != cudaSuccess) return e;
    cache.blocks = max(per_sm, 1) * n_sm;
    cache.smem = (int)smem;
  }
  out = cache.blocks;
  return cudaSuccess;
}

// The group pass alone, for one part of a batch split over devices (a
// replicated index): adds the part's impure row-hitting reads to *n_fix,
// which the caller zeroes once for the whole batch, so that every part's
// finish can take the batch's group choice (shkk_finish's n_fix_total).
extern "C" int shkk_finish_count(const void* tagv, const void* payv, int B,
                                 int Ls, int rb, void* flags, void* gmax,
                                 void* n_fix, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  groups_kernel<<<grid_for((long long)B * 32, threads), threads, 0,
                  (cudaStream_t)stream>>>(
      (const u32*)tagv, (const u32*)payv, B, Ls, rb, (uint8_t*)flags,
      (int32_t*)gmax, (int32_t*)n_fix);
  return (int)cudaGetLastError();
}

// The whole finish on one stream: zero the counters (counters[0] = n_fix,
// counters[1] = the block path's list length), the group pass when the
// index has group ids, the warp pass over every read, then the block path
// over the reads it listed (at most `grid` blocks: the rows of the scratch
// buffer). With n_fix_total (not null), the group choice compares that
// count, the whole batch's, with fix_cap2 in place of this call's own.
extern "C" int shkk_finish(
    const void* tagv, const void* payv, const void* length,
    const void* thresh, const void* rows3, int n3, int rows3_w, int D,
    const void* ext_mat, int ext_w, int B, int Ls, int L, int k,
    int pos_bits, int n_genes, int rb, int W, int has_rows, int groups,
    void* flags, void* gmax, void* counters, int fix_cap2,
    const void* n_fix_total, int key_cap, int grid, void* scratch,
    void* heavy, void* packed, void* winners, void* best_cov, void* stream) {
  ReadsArgs a;
  a.tagv = (const u32*)tagv;
  a.payv = (const u32*)payv;
  a.length = (const int32_t*)length;
  a.thresh = (const int32_t*)thresh;
  a.rows3 = (const u32*)rows3;
  a.n3 = n3;
  a.rows3_w = rows3_w;
  a.D = D;
  a.ext_mat = (const uint16_t*)ext_mat;
  a.ext_w = ext_w;
  a.B = B;
  a.Ls = Ls;
  a.L = L;
  a.k = k;
  a.pos_bits = pos_bits;
  a.n_genes = n_genes;
  a.rb = rb;
  a.W = W;
  a.has_rows = has_rows;
  a.groups = groups;
  a.flags = (const uint8_t*)flags;
  a.gmax = (const int32_t*)gmax;
  a.n_fix = n_fix_total ? (const int32_t*)n_fix_total
                        : (const int32_t*)counters;
  a.fix_cap2 = fix_cap2;
  a.key_cap = key_cap;
  a.scratch = (u32*)scratch;
  a.n_heavy = (int32_t*)counters + 1;
  a.heavy = (int32_t*)heavy;
  a.packed = (int32_t*)packed;
  a.winners = (int32_t*)winners;
  a.best_cov = (int32_t*)best_cov;
  const size_t smem = scratch ? 0 : (size_t)key_cap * 8;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(counters, 0, 2 * sizeof(int32_t), st);
  if (e != cudaSuccess) return (int)e;
  if (groups) {
    const int threads = 256;
    groups_kernel<<<grid_for((long long)B * 32, threads), threads, 0, st>>>(
        a.tagv, a.payv, B, Ls, rb, (uint8_t*)flags, (int32_t*)gmax,
        (int32_t*)counters);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  warp_kernel<<<grid_for(B, kLightWarps), kLightWarps * 32, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  static thread_local Resident block_cache;
  e = resident_blocks((const void*)block_kernel, kThreads, smem, block_cache,
                      blocks);
  if (e != cudaSuccess) return (int)e;
  grid = min(grid, blocks);
  if (grid > 0) block_kernel<<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}
