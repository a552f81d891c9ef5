// K7, the sharded Bloom filter's routing round, in three kernels:
//   K7a shard_route: owner shard, shard-local word and bit per window, a
//       stable per-owner slot, the send buffer and the overflow count;
//   K7b shard_probe: each owner's probe of the slots it received;
//   K7c shard_return: each window's reply, decoded to (tag, payload).
//
// Replaces shark_tpu/parallel/sharded_bf.py shard_owner_local (:138) and
// the halves of _route_probe_return (:181) around its two all_to_all
// exchanges: the sort, slot and pack (:195-237), the owner's probe
// (:245-250, step.py probe_rank and take_rows) and the scatter back with
// decode_pay_words (:256-263). The exchanges are no kernel: when the
// shards share a card the wrapper transposes the stacked send buffer for
// K7b, and K7c reads K7b's replies in place through strides; between
// cards it copies.
//
// Every kernel takes a leading shard axis, so one launch covers all the
// shards that live on one card. Layouts (s = a source shard on this card,
// o = an owner shard, h = an owner shard on this card):
//   windows   idx_hi, idx_lo u32 / win_valid u8 [n_src, Pn], Pn = b * Ls
//   send      uint2 [n_src, n, cap]: (local word, bit), 0xFFFFFFFF in both
//             lanes where no window took the slot
//   recv      uint2 [n_h, n_src_all, cap]; reply the same shape
//   back      uint2 [n_src, n, cap] with any source and owner strides
//             (one card: reply transposed, a view)
//
// K7a's slot order is shark_tpu's: it sorts the keys owner * Pn + flat
// position, so within an owner the slots follow the window's position and
// the probes that overflow `cap` are that owner's last ones. Here, without
// a sort, in one launch that reads each window once: a block takes a tile
// of kTile windows of one source, each warp kWarpTile consecutive ones, a
// lane every 32nd, so each load is coalesced. The warp ranks each window
// among the earlier windows of its warp with the same owner
// (__match_any_sync and a running count per warp and owner in shared
// memory), the block scans those counts over its warps, and the tile
// finds each owner's first slot by a single-pass scan with decoupled
// look-back (Merrill & Garland, 2016): it publishes, per owner, a status
// word holding its count and then its inclusive prefix, and a warp per
// owner sums the words of up to 32 earlier tiles of its source at a time,
// back to the nearest inclusive prefix. A tile's place in that order is
// an atomic ticket, not blockIdx: blocks start in no order, and a block
// that waited on a tile that had not started could wait forever; a
// ticket is taken at a block's start, so every earlier tile is running.
// The tile stages its send entries in shared memory grouped by owner (a
// counting sort of the tile) and stores each owner's run of consecutive
// slots with consecutive threads. A source's tails, [min(total, cap), cap)
// of each of its (source, owner) rows, get the sentinel from fill blocks
// whose tickets follow the next source's tiles: they wait for the
// source's last tile to publish its totals (that tile also writes the
// source's overflow), which it mostly has. So the send buffer is written
// once, with no memset of the whole of it; the status words and the
// ticket are the only scratch (one small memset a call).
//
// Bound: bytes. K7a must read 9 bytes per window and write 8 per window
// (slot and owner), 8 per routed slot and 8 per tail slot, and it moves
// just those, at about 2 TB/s. Measured on the card
// (scripts/route_variants.py): storing each window's send entry itself (a
// warp's entries of one owner then form a run) cost 19-22% more than the
// staged runs, staging before the look-back (more registers, fewer
// blocks an SM) 13%, one ballot a bit of the owner in place of
// __match_any_sync 3-8%, an integer division for the owner 3%; the
// look-back takes about a tenth of the kernel, the send and the slot and
// owner stores each about a seventh. K7b
// reads one 8-byte (word, rank) row per routed window and one 8-byte pay
// row per hit, two dependent random loads, a thread a slot, each random
// load a 32-byte sector; K7c reads 8 bytes of owner and slot and one
// 8-byte reply per routed window and writes 8, four windows a thread.
#include "common.cuh"

namespace {

constexpr int kRouteThreads = 256;  // K7a: threads a block
constexpr int kRouteWarps = kRouteThreads / 32;
constexpr int kRounds = 16;  // K7a: windows a thread takes
constexpr int kHalf = kRounds / 2;  // windows a thread loads at once
constexpr int kWarpTile = 32 * kRounds;
constexpr int kTile = kRouteThreads * kRounds;  // windows a tile
constexpr int kFillSpan = 16384;  // tail slots a fill block takes
// K7a's status words: a flag in the top two bits, a count in the low 32
constexpr u64 kFlagCount = 1ull << 62;   // the tile's own count
constexpr u64 kFlagPrefix = 2ull << 62;  // its inclusive prefix
constexpr int kThreads = 256;
constexpr int kProbeSlots = 1;  // K7b: received slots a thread takes
// K7b's table loads; ld.global.nc.L1::no_allocate.v2.u32 is the read-only
// path without L1 allocation
#define SHKK_PROBE_LOAD "ld.global.v2.u32"
// K7c's reply loads (ld.global.nc.L1::no_allocate.v2.u32: the read-only
// path without L1 allocation)
#define SHKK_RETURN_LOAD "ld.global.v2.u32"

// The owner shard of Bloom position (hi, lo), or -1 when the window is
// invalid or its owner falls outside [0, n); `local` gets the shard-local
// word (shard_owner_local). Narrow: the word fits int32 and the owner is
// its quotient by wps, taken as (word * magic) >> shift (route_magic). Wide:
// the word is 64-bit, the owner is n-1 compares against the shard bounds
// s * wps, and the local word is the low limb of word - owner * wps, which
// is exact because the difference is < wps.
__device__ __forceinline__ int owner_of(u32 hi, u32 lo, bool valid, int n,
                                        long long wps, int wide, u32 magic,
                                        int shift, u32& local) {
  const u32 word_lo = (hi << 27) | (lo >> 5);
  int owner;
  if (wide) {
    const u64 word = ((u64)(hi >> 5) << 32) | word_lo;
    owner = 0;
    for (int s = 1; s < n; ++s) owner += word >= (u64)s * (u64)wps ? 1 : 0;
    local = word_lo - (u32)owner * (u32)wps;
  } else {
    const int w = (int)word_lo;
    owner = w < 0 ? -1 : (int)(((u64)word_lo * magic) >> shift);
    local = (u32)(w - owner * (int)wps);
  }
  return (valid && owner >= 0 && owner < n) ? owner : -1;
}

// (magic, shift) with floor(w / d) == (w * magic) >> shift for every
// w < 2^31 and 1 <= d < 2^31: shift = 31 + ceil(log2 d), magic =
// ceil(2^shift / d) < 2^32. Exact because magic * d - 2^shift < d <=
// 2^(shift - 31) (Granlund and Montgomery, 1994).
static inline void route_magic(long long d, u32& magic, int& shift) {
  int l = 0;
  while ((1ll << l) < d) ++l;
  shift = 31 + l;
  magic = (u32)(((1ull << shift) + (unsigned long long)d - 1) /
                (unsigned long long)d);
}

__device__ __forceinline__ u64 load_status(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_status(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// The status word of a tile and owner once it carries a flag, or (with
// `prefix`, for a fill block, which backs off between reads) once it
// carries the inclusive prefix. The tile is running (it took an earlier
// ticket), so it will publish both.
__device__ __forceinline__ u64 wait_status(const u64* p, bool prefix) {
  u64 v = load_status(p);
  while ((v >> 62) < (prefix ? 2u : 1u)) {
    if (prefix) __nanosleep(200);
    v = load_status(p);
  }
  return v;
}

// Shared memory of a K7a block: the tile's send entries grouped by owner
// (uint2 [kTile]) and the owner of each (u16 [kTile]), then ints: per warp
// and owner a running count, then its offset among the tile's windows of
// that owner [kRouteWarps][n]; per owner the tile's count [n], its first
// slot [n] and its first entry in the staged group [n].
static inline size_t route_smem(int n) {
  return (size_t)kTile * (sizeof(uint2) + sizeof(unsigned short)) +
         (size_t)(kRouteWarps + 3) * n * sizeof(int);
}

// A fill block: the sentinel into the slots [from, from + kFillSpan) of
// row (source s, owner) that lie at or past min(total, cap), the row's
// total read from the source's last tile once that has published it.
__device__ void route_fill(long long s, long long row, long long from,
                           int tiles, int n, long long Pn, long long cap,
                           const u64* status, uint2* send) {
  __shared__ long long end;
  if (threadIdx.x == 0) {
    // slots at or past Pn are tail whatever the total
    end = from >= Pn ? from
                     : min((long long)(u32)wait_status(
                               status + (s * tiles + tiles - 1) * n + row % n,
                               true),
                           cap);
  }
  __syncthreads();
  uint2* dst = send + row * cap;
  const long long to = min(from + kFillSpan, cap);
  for (long long j = max(from, end) + threadIdx.x; j < to; j += kRouteThreads)
    dst[j] = make_uint2(0xFFFFFFFFu, 0xFFFFFFFFu);
}

// K7a. A block's ticket t names its work: the tiles of source 0, of
// source 1, then source 0's fill blocks, source 2's tiles, source 1's
// fill blocks, and so on, source S-1's fill blocks last. A source's fill
// blocks thus wait on tiles that have mostly finished, and fill while the
// next source's tiles run.
__global__ void __launch_bounds__(kRouteThreads) route_kernel(
    const u32* __restrict__ idx_hi, const u32* __restrict__ idx_lo,
    const uint8_t* __restrict__ win_valid, long long Pn, int n_src, int n,
    long long wps, int wide, u32 magic, int shift, long long cap, int tiles,
    long long spans, unsigned* __restrict__ ticket, u64* __restrict__ status,
    uint2* __restrict__ send, int* __restrict__ slot_out,
    int* __restrict__ owner_out, int* __restrict__ overflow) {
  extern __shared__ uint2 stage[];                    // [kTile]
  unsigned short* stage_owner = (unsigned short*)(stage + kTile);
  int* wcnt = (int*)(stage_owner + kTile);            // [kRouteWarps][n]
  int* count = wcnt + kRouteWarps * n;                // [n]
  int* first = count + n;                             // [n]
  int* group = first + n;                             // [n]
  __shared__ long long sh_ticket;
  __shared__ int sh_over, sh_scan[33];
  if (threadIdx.x == 0) {
    sh_ticket = atomicAdd(ticket, 1u);
    sh_over = 0;
  }
  for (int j = threadIdx.x; j < kRouteWarps * n; j += kRouteThreads)
    wcnt[j] = 0;
  __syncthreads();
  long long s = 0;
  int c = (int)sh_ticket;
  if (sh_ticket >= tiles) {
    const long long fills = n * spans;  // a source's fill blocks
    const long long u = sh_ticket - tiles;
    const long long g = u / (tiles + fills), r = u % (tiles + fills);
    if (g < n_src - 1 && r < tiles) {
      s = g + 1;
      c = (int)r;
    } else {
      const long long f = g < n_src - 1 ? r - tiles : r;
      route_fill(g, g * n + f / spans, (f % spans) * kFillSpan, tiles, n,
                 Pn, cap, status, send);
      return;
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // key: owner + 1 (0 where none) in bits 0-10, the bit in 11-15, the
  // window's rank among the warp's windows of its owner (under kWarpTile)
  // from bit 16; local: the shard-local word. The loads of half the
  // windows are issued before the first is used.
  const long long p0 = (long long)c * kTile + warp * kWarpTile + lane;
  const long long i0 = s * Pn + p0;
  int key[kRounds];
  u32 local[kRounds];
#pragma unroll
  for (int h = 0; h < kRounds; h += kHalf) {
    u32 hi[kHalf], lo[kHalf];
    uint8_t va[kHalf];
#pragma unroll
    for (int k = 0; k < kHalf; ++k) {
      const long long i = i0 + (h + k) * 32;
      const bool in = p0 + (h + k) * 32 < Pn;
      hi[k] = in ? idx_hi[i] : 0u;
      lo[k] = in ? idx_lo[i] : 0u;
      va[k] = in ? win_valid[i] : (uint8_t)0;
    }
#pragma unroll
    for (int k = 0; k < kHalf; ++k) {
      const int o = owner_of(hi[k], lo[k], va[k] != 0, n, wps, wide, magic,
                             shift, local[h + k]);
      key[h + k] = (o + 1) | (int)((lo[k] & 31u) << 11);
    }
  }
  int* wc = wcnt + warp * n;
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    // lanes with the same owner, and this lane's rank among the lower ones
    const int o = (key[k] & 0x7FF) - 1;
    const unsigned peers = __match_any_sync(0xffffffffu, o);
    const int below = __popc(peers & ((1u << lane) - 1u));
    if (o >= 0) key[k] |= (wc[o] + below) << 16;
    __syncwarp();
    if (o >= 0 && below == 0) wc[o] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // per owner: the warps' counts become offsets; publish the tile's count
  u64* st = status + (s * tiles + c) * n;
  for (int o = threadIdx.x; o < n; o += kRouteThreads) {
    int run = 0;
    for (int w = 0; w < kRouteWarps; ++w) {
      const int x = wcnt[w * n + o];
      wcnt[w * n + o] = run;
      run += x;
    }
    count[o] = run;
    store_status(st + o, (c == 0 ? kFlagPrefix : kFlagCount) | (u32)run);
  }
  __syncthreads();
  // each owner's first entry in the tile's entries grouped by owner
  int routed = 0;
  for (int o0 = 0; o0 < n; o0 += kRouteThreads) {
    const int o = o0 + threadIdx.x;
    int total;
    const int x = block_exclusive_scan(o < n ? count[o] : 0, sh_scan, total);
    if (o < n) group[o] = routed + x;
    routed += total;
  }
  // look-back: a warp per owner sums the counts of up to 32 earlier tiles
  // of the source at a time (lane l the tile l + 1 back), down to the
  // nearest that carries its inclusive prefix
  const u64* src_status = status + s * tiles * n;
  for (int o = warp; o < n; o += kRouteWarps) {
    u32 excl = 0;
    if (c > 0) {
      for (int top = c - 1;; top -= 32) {
        const int j = top - lane;
        const u64 v =
            j >= 0 ? wait_status(src_status + (long long)j * n + o, false)
                   : kFlagPrefix;  // before the first tile: a prefix of 0
        const unsigned done = __ballot_sync(0xffffffffu, (v >> 62) == 2);
        const int stop = done ? __ffs(done) - 1 : 31;
        u32 x = lane <= stop ? (u32)v : 0u;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, d);
        excl += x;
        if (done) break;
      }
      if (lane == 0) store_status(st + o, kFlagPrefix | (excl + count[o]));
    }
    if (lane == 0) first[o] = (int)excl;
  }
  __syncthreads();
  if (c == tiles - 1) {  // the source's totals: its overflow
    int over = 0;
    for (int o = threadIdx.x; o < n; o += kRouteThreads) {
      const long long total = (long long)first[o] + count[o];
      if (total > cap) over += (int)(total - cap);
    }
    if (over) atomicAdd(&sh_over, over);
    __syncthreads();
    if (threadIdx.x == 0) overflow[s] = sh_over;
  }
  // slot and owner per window; the send entries staged by owner
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    if (p0 + k * 32 >= Pn) break;
    const int o = (key[k] & 0x7FF) - 1;
    int sl = -1;
    if (o >= 0) {
      const int r = wc[o] + (key[k] >> 16);  // rank among the tile's
      const long long slot = (long long)first[o] + r;
      if (slot < cap) sl = (int)slot;
      stage[group[o] + r] = make_uint2(local[k], (u32)(key[k] >> 11) & 31u);
      stage_owner[group[o] + r] = (unsigned short)o;
    }
    slot_out[i0 + k * 32] = sl;
    owner_out[i0 + k * 32] = o;
  }
  __syncthreads();
  // the staged entries, each owner's in one run of consecutive slots
  uint2* dst = send + s * n * cap;
  for (int j = threadIdx.x; j < routed; j += kRouteThreads) {
    const int o = stage_owner[j];
    const long long slot = (long long)first[o] + (j - group[o]);
    if (slot < cap) dst[o * cap + slot] = stage[j];
  }
}

// K7b: each thread takes kProbeSlots received slots of owner h =
// blockIdx.y, a block's slots being kThreads apart so that every recv load
// and reply store is coalesced; no division. A slot whose word lane is
// not below wps (the 0xFFFFFFFF of an empty slot) reads no table row; a
// miss replies (0, 0), as does a rank past rows_max. (K5 reads pay row 0
// on a miss; this wire does not.) Every (word, rank) load of a thread is
// issued before its first pay load. What bounds it, measured on the card
// (chip_smoke.py's shard_probe floor line, scripts/probe_variants.py):
// the card's rate of random reads, as for K5 and K6. With 8 shards of the
// transcriptome index on one card (2.15 GB of word rows, 0.58 GB of pay
// rows) it takes the time of a bare gather of the same word rows and
// then pay rows, one dependent on the other, and under half that time
// with the words masked into 32 MB a shard. 2 or 4 slots a thread
// measured no faster, and the read-only loads without L1 allocation
// (ld.global.nc.L1::no_allocate) 4-5% slower, 1.3x with the words in
// 4 MB a shard; so a slot a thread with plain loads, and no division.
__device__ __forceinline__ uint2 load_row8(const uint2* p) {
  uint2 v;
  asm volatile(SHKK_PROBE_LOAD " {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p));
  return v;
}

__global__ void __launch_bounds__(kThreads) shard_probe_kernel(
    const uint2* __restrict__ recv, u32 per_owner,
    const uint2* __restrict__ bf_rank, long long wps,
    const uint2* __restrict__ pay, long long rows_max,
    uint2* __restrict__ reply) {
  const long long h = blockIdx.y;
  const u32 base = blockIdx.x * (u32)(kThreads * kProbeSlots) + threadIdx.x;
  const uint2* q_in = recv + h * per_owner;
  const uint2* words = bf_rank + h * wps;
  const uint2* pays = pay + h * rows_max;
  uint2 q[kProbeSlots], wr[kProbeSlots];
#pragma unroll
  for (int j = 0; j < kProbeSlots; ++j) {
    const u32 s = base + (u32)(j * kThreads);
    q[j] = s < per_owner ? q_in[s] : make_uint2(0xFFFFFFFFu, 0u);
    wr[j] = (long long)q[j].x < wps ? load_row8(words + q[j].x)
                                    : make_uint2(0u, 0u);
  }
  uint2 out[kProbeSlots];
#pragma unroll
  for (int j = 0; j < kProbeSlots; ++j) {
    const u32 bit = q[j].y & 31u;
    const u32 rank = wr[j].y + __popc(wr[j].x & ((1u << bit) - 1u));
    const bool hit = ((wr[j].x >> bit) & 1u) && (long long)rank < rows_max;
    out[j] = hit ? load_row8(pays + rank) : make_uint2(0u, 0u);
  }
#pragma unroll
  for (int j = 0; j < kProbeSlots; ++j) {
    const u32 s = base + (u32)(j * kThreads);
    if (s < per_owner) reply[h * per_owner + s] = out[j];
  }
}

// K7c: the reply to each window, decoded. A block row per source s
// (blockIdx.y), so a window's source comes from the grid and every index
// within a source is 32-bit: no division. Each thread takes 4
// consecutive windows: one 16-byte load of their slots and one of their
// owners, the reply of each window that has a slot (the 4 reply loads
// issued before the first decode), one 16-byte store of the tags and one
// of the payloads.
// A source's row of windows need not start on a 16-byte boundary (Pn =
// b * Ls is odd for odd b and Ls): its up to 3 windows before the first
// boundary and up to 3 after its last chunk are taken one at a time by
// threads of its first block. The replies are read where K7b wrote them:
// back may be any [S, n, cap, 2] view whose last two strides are (2, 1),
// such as K7b's [owner, source] replies transposed, so the exchange back
// on one card is no copy; the source and owner strides (in 8-byte rows)
// come from the wrapper.
//
// Bound: bytes. Per window 8 bytes of slot and owner in and 8 of tag and
// payload out, and 8 bytes of reply per routed window. A warp's 128
// windows hold runs of consecutive slots of each owner (K7a gives an
// owner's slots in window order), so the reply loads of a warp fall on
// few sectors. Measured on the card (scripts/return_variants.py): a
// window a thread on a 1-D grid, its source a 64-bit division, was 1.24x
// this kernel, and on a 2-D grid 1.22x, so the division was 2% and the
// 4-byte accesses the rest; two chunks of 4 windows a thread, or
// streaming loads of slot and owner, no faster; the reply loads through
// the read-only path without L1 allocation 12% slower.
__device__ __forceinline__ uint2 load_reply(const uint2* p) {
  uint2 v;
  asm volatile(SHKK_RETURN_LOAD " {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p));
  return v;
}

// decode_pay_words of a reply (zeros: tag 0, payload 0, a miss)
__device__ __forceinline__ void decode_reply(uint2 pw, u32& tag, u32& pay) {
  tag = pw.x >> 30;
  pay = tag == 3u ? pw.y : ((pw.x & 0xFFFFu) | ((pw.y & 0xFFFFu) << 16));
}

__device__ __forceinline__ uint2 reply_of(const uint2* bk, u32 owner_stride,
                                          int o, int sl) {
  return sl >= 0 ? load_reply(bk + (u64)(u32)o * owner_stride + (u32)sl)
                 : make_uint2(0u, 0u);
}

__global__ void __launch_bounds__(kThreads) shard_return_kernel(
    const uint2* __restrict__ back, long long src_stride, u32 owner_stride,
    u32 Pn, const int* __restrict__ owner, const int* __restrict__ slot,
    u32* __restrict__ tagv, u32* __restrict__ payv) {
  const u32 s = blockIdx.y;
  const size_t r0 = (size_t)s * Pn;
  const int* sl_s = slot + r0;
  const int* ow_s = owner + r0;
  u32* tg_s = tagv + r0;
  u32* py_s = payv + r0;
  const uint2* bk = back + (long long)s * src_stride;
  // the bases are 16-byte aligned, so window r0 + head is on a boundary
  const u32 head = min((0u - s * Pn) & 3u, Pn);
  const u32 chunks = (Pn - head) >> 2;
  const u32 t = blockIdx.x * (u32)kThreads + threadIdx.x;
  if (t < chunks) {
    const u32 j = head + 4 * t;
    const int4 sl = *reinterpret_cast<const int4*>(sl_s + j);
    const int4 ow = *reinterpret_cast<const int4*>(ow_s + j);
    const uint2 pw0 = reply_of(bk, owner_stride, ow.x, sl.x);
    const uint2 pw1 = reply_of(bk, owner_stride, ow.y, sl.y);
    const uint2 pw2 = reply_of(bk, owner_stride, ow.z, sl.z);
    const uint2 pw3 = reply_of(bk, owner_stride, ow.w, sl.w);
    uint4 tg, py;
    decode_reply(pw0, tg.x, py.x);
    decode_reply(pw1, tg.y, py.y);
    decode_reply(pw2, tg.z, py.z);
    decode_reply(pw3, tg.w, py.w);
    *reinterpret_cast<uint4*>(tg_s + j) = tg;
    // the payload plane starts S * Pn words after the tags: on a 16-byte
    // boundary alike only when S * Pn % 4 == 0
    if ((reinterpret_cast<uintptr_t>(py_s + j) & 15u) == 0) {
      *reinterpret_cast<uint4*>(py_s + j) = py;
    } else {
      py_s[j] = py.x;
      py_s[j + 1] = py.y;
      py_s[j + 2] = py.z;
      py_s[j + 3] = py.w;
    }
  }
  // the windows before the first boundary (threads 0-2) and after the
  // last chunk (threads 4-6) of the source's first block
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const u32 tail = head + 4 * chunks;
    const u32 j = threadIdx.x < 4 ? threadIdx.x : tail + threadIdx.x - 4;
    if ((threadIdx.x < 4 && j < head) || (threadIdx.x >= 4 && j < Pn)) {
      u32 tag, pay;
      decode_reply(reply_of(bk, owner_stride, ow_s[j], sl_s[j]), tag, pay);
      tg_s[j] = tag;
      py_s[j] = pay;
    }
  }
}

}  // namespace

// Bytes of K7a's scratch for n_src sources of Pn windows and n owners: a
// ticket, then a status word per (source, tile, owner).
extern "C" long long shkk_shard_route_scratch(int n_src, long long Pn,
                                              int n) {
  const long long tiles = (Pn + kTile - 1) / kTile;
  return 8 + 8 * (long long)n_src * tiles * n;
}

extern "C" int shkk_shard_route(const void* idx_hi, const void* idx_lo,
                                const void* win_valid, int n_src,
                                long long Pn, int n, long long wps, int wide,
                                long long cap, void* scratch, void* send,
                                void* slot, void* owner, void* overflow,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_src <= 0) return (int)cudaGetLastError();
  if (n < 1 || Pn < 0 || Pn > 0x7FFFFFFFll || cap < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (Pn == 0) {  // no window: every slot a tail, no overflow
    e = cudaMemsetAsync(send, 0xFF, (size_t)n_src * n * cap * 8, st);
    if (e == cudaSuccess)
      e = cudaMemsetAsync(overflow, 0, (size_t)n_src * 4, st);
    return (int)e;
  }
  const int tiles = (int)((Pn + kTile - 1) / kTile);
  e = cudaMemsetAsync(scratch, 0,
                      (size_t)shkk_shard_route_scratch(n_src, Pn, n), st);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = route_smem(n);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(route_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // a fill block per kFillSpan slots of each (source, owner) row
  const long long spans = (cap + kFillSpan - 1) / kFillSpan;
  u32 magic = 0;
  int shift = 0;
  if (!wide) route_magic(wps, magic, shift);
  route_kernel<<<(unsigned)(n_src * (tiles + n * spans)), kRouteThreads,
                 smem, st>>>(
      (const u32*)idx_hi, (const u32*)idx_lo, (const uint8_t*)win_valid, Pn,
      n_src, n, wps, wide, magic, shift, cap, tiles, spans,
      (unsigned*)scratch,
      (u64*)scratch + 1, (uint2*)send, (int*)slot, (int*)owner,
      (int*)overflow);
  return (int)cudaGetLastError();
}

extern "C" int shkk_shard_probe(const void* recv, int n_owners,
                                long long per_owner, const void* bf_rank,
                                long long wps, const void* pay,
                                long long rows_max, void* reply,
                                void* stream) {
  if (n_owners < 0 || n_owners > 65535 || per_owner < 0 ||
      per_owner > 0xFFFFFFFFll - kThreads * kProbeSlots)
    return (int)cudaErrorInvalidValue;
  if (n_owners > 0 && per_owner > 0) {
    const dim3 grid(grid_for(per_owner, kThreads * kProbeSlots), n_owners);
    shard_probe_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint2*)recv, (u32)per_owner, (const uint2*)bf_rank, wps,
        (const uint2*)pay, rows_max, (uint2*)reply);
  }
  return (int)cudaGetLastError();
}

extern "C" int shkk_shard_return(const void* back, long long src_stride,
                                 long long owner_stride, int n_src,
                                 long long Pn, const void* owner,
                                 const void* slot, void* out, void* stream) {
  if (n_src < 0 || n_src > 65535 || Pn < 0 || Pn > 0x7FFFFFFFll ||
      owner_stride < 0 || owner_stride > 0xFFFFFFFFll)
    return (int)cudaErrorInvalidValue;
  if (n_src > 0 && Pn > 0) {
    // a thread for every 4 windows, and a block for a source of fewer
    const unsigned gx = grid_for(Pn / 4 + 1, kThreads);
    u32* tagv = (u32*)out;
    shard_return_kernel<<<dim3(gx, n_src), kThreads, 0,
                          (cudaStream_t)stream>>>(
        (const uint2*)back, src_stride, (u32)owner_stride, (u32)Pn,
        (const int*)owner, (const int*)slot, tagv,
        tagv + (size_t)n_src * Pn);
  }
  return (int)cudaGetLastError();
}
