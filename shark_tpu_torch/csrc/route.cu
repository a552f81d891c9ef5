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
// decode_pay_words (:256-263). The exchanges are no kernel: the wrapper
// transposes the stacked buffer when the shards share a card and copies
// between cards otherwise.
//
// Every kernel takes a leading shard axis, so one launch covers all the
// shards that live on one card. Layouts (s = a source shard on this card,
// o = an owner shard, h = an owner shard on this card):
//   windows   idx_hi, idx_lo u32 / win_valid u8 [n_src, Pn], Pn = b * Ls
//   send      uint2 [n_src, n, cap]: (local word, bit), 0xFFFFFFFF in both
//             lanes where no window took the slot
//   recv      uint2 [n_h, n_src_all, cap]; reply the same shape
//   back      uint2 [n_src, n, cap]
//
// K7a's slot order is shark_tpu's: it sorts the keys owner * Pn + flat
// position, so within an owner the slots follow the window's position and
// the probes that overflow `cap` are that owner's last ones. Here, without
// a sort: a count pass builds one histogram of owners per 256-window
// chunk, a scan pass turns them into each chunk's first slot per owner
// (and sums the overflow), and a scatter pass ranks each window among the
// earlier windows of its chunk with the same owner (a warp's
// __match_any_sync plus per-warp counts in shared memory), which keeps the
// order stable.
//
// Bound: bytes. K7a must read 9 bytes per window and write 8 per window
// and per slot; K7b reads one 8-byte (word, rank) row per routed window
// and one 8-byte pay row per hit, two dependent random loads; K7c reads 8
// bytes of owner and slot and one 8-byte reply per routed window and
// writes 8. All three are one thread per window or slot; the random loads
// of K7b and K7c cost a 32-byte sector each.
#include "common.cuh"

namespace {

constexpr int kChunk = 256;  // windows per routing chunk = threads per block
constexpr int kWarps = kChunk / 32;
constexpr int kScanThreads = 1024;
constexpr int kThreads = 256;
constexpr int kProbeSlots = 1;  // K7b: received slots a thread takes
// K7b's table loads; ld.global.nc.L1::no_allocate.v2.u32 is the read-only
// path without L1 allocation
#define SHKK_PROBE_LOAD "ld.global.v2.u32"

// The owner shard of Bloom position (hi, lo), or -1 when the window is
// invalid or its owner falls outside [0, n); `local` gets the shard-local
// word (shard_owner_local). Narrow: the word fits int32 and the owner is
// one division. Wide: the word is 64-bit, the owner is n-1 compares
// against the shard bounds s * wps, and the local word is the low limb of
// word - owner * wps, which is exact because the difference is < wps.
__device__ __forceinline__ int owner_of(u32 hi, u32 lo, bool valid, int n,
                                        long long wps, int wide,
                                        u32& local) {
  const u32 word_lo = (hi << 27) | (lo >> 5);
  int owner;
  if (wide) {
    const u64 word = ((u64)(hi >> 5) << 32) | word_lo;
    owner = 0;
    for (int s = 1; s < n; ++s) owner += word >= (u64)s * (u64)wps ? 1 : 0;
    local = word_lo - (u32)owner * (u32)wps;
  } else {
    const int w = (int)word_lo;
    owner = w < 0 ? -1 : w / (int)wps;
    local = (u32)(w - owner * (int)wps);
  }
  return (valid && owner >= 0 && owner < n) ? owner : -1;
}

__global__ void route_count_kernel(const u32* __restrict__ idx_hi,
                                   const u32* __restrict__ idx_lo,
                                   const uint8_t* __restrict__ win_valid,
                                   long long Pn, int n, long long wps,
                                   int wide, int nchunks,
                                   int* __restrict__ counts) {
  extern __shared__ int hist[];  // [n]
  const int c = blockIdx.x;
  const long long s = blockIdx.y;
  for (int o = threadIdx.x; o < n; o += blockDim.x) hist[o] = 0;
  __syncthreads();
  const long long p = (long long)c * kChunk + threadIdx.x;
  if (p < Pn) {
    const long long i = s * Pn + p;
    u32 local;
    const int o = owner_of(idx_hi[i], idx_lo[i], win_valid[i] != 0, n, wps,
                           wide, local);
    if (o >= 0) atomicAdd(&hist[o], 1);
  }
  __syncthreads();
  for (int o = threadIdx.x; o < n; o += blockDim.x)
    counts[(s * n + o) * nchunks + c] = hist[o];
}

// One block per (source, owner) row of counts: exclusive scan over the
// chunks, and the windows of the row past `cap` added to the source's
// overflow count.
__global__ void route_scan_kernel(const int* __restrict__ counts, int nchunks,
                                  int n, long long cap, int* __restrict__ offs,
                                  int* __restrict__ overflow) {
  __shared__ int sh[33];
  const long long row = blockIdx.x;
  const int* cnt = counts + row * nchunks;
  int* off = offs + row * nchunks;
  int carry = 0;
  for (int base = 0; base < nchunks; base += blockDim.x) {
    const int c = base + threadIdx.x;
    const int v = c < nchunks ? cnt[c] : 0;
    int total;
    const int excl = block_exclusive_scan(v, sh, total);
    if (c < nchunks) off[c] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0 && carry > cap)
    atomicAdd(&overflow[row / n], (int)(carry - cap));
}

__global__ void route_scatter_kernel(
    const u32* __restrict__ idx_hi, const u32* __restrict__ idx_lo,
    const uint8_t* __restrict__ win_valid, long long Pn, int n,
    long long wps, int wide, int nchunks, long long cap,
    const int* __restrict__ offs, uint2* __restrict__ send,
    int* __restrict__ slot_out, int* __restrict__ owner_out) {
  extern __shared__ int wcnt[];  // [kWarps][n]: windows per warp and owner
  const int c = blockIdx.x;
  const long long s = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < kWarps * n; j += blockDim.x) wcnt[j] = 0;
  __syncthreads();
  const long long p = (long long)c * kChunk + threadIdx.x;
  const bool in = p < Pn;
  const long long i = s * Pn + p;
  u32 local = 0, bit = 0;
  int o = -1;
  if (in) {
    const u32 lo = idx_lo[i];
    bit = lo & 31u;
    o = owner_of(idx_hi[i], lo, win_valid[i] != 0, n, wps, wide, local);
  }
  // lanes with the same owner, and this lane's rank among the lower ones
  const unsigned peers = __match_any_sync(0xffffffffu, o);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  if (o >= 0 && rank == 0) wcnt[warp * n + o] = __popc(peers);
  __syncthreads();
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int t = wcnt[w * n + q];
      wcnt[w * n + q] = run;
      run += t;
    }
  }
  __syncthreads();
  if (!in) return;
  int sl = -1;
  if (o >= 0) {
    const long long slot = (long long)offs[(s * n + o) * nchunks + c] +
                           wcnt[warp * n + o] + rank;
    if (slot < cap) {
      sl = (int)slot;
      send[(s * n + o) * cap + slot] = make_uint2(local, bit);
    }
  }
  slot_out[i] = sl;
  owner_out[i] = o;
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

// K7c: one thread per window of source s: its reply where K7a gave it a
// slot, else zeros (a miss), then decode_pay_words.
__global__ void shard_return_kernel(const uint2* __restrict__ back,
                                    long long Pn, long long total, int n,
                                    long long cap,
                                    const int* __restrict__ owner,
                                    const int* __restrict__ slot,
                                    u32* __restrict__ tagv,
                                    u32* __restrict__ payv) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int sl = slot[i];
  u32 w0 = 0u, w1 = 0u;
  if (sl >= 0) {
    const uint2 pw = back[((i / Pn) * n + owner[i]) * cap + sl];
    w0 = pw.x;
    w1 = pw.y;
  }
  const u32 tag = w0 >> 30;
  tagv[i] = tag;
  payv[i] = tag == 3u ? w1 : ((w0 & 0xFFFFu) | ((w1 & 0xFFFFu) << 16));
}

}  // namespace

// counts and offs are int scratch of n_src * n * ceil(Pn / 256) each.
extern "C" int shkk_shard_route(const void* idx_hi, const void* idx_lo,
                                const void* win_valid, int n_src,
                                long long Pn, int n, long long wps, int wide,
                                long long cap, void* counts, void* offs,
                                void* send, void* slot, void* owner,
                                void* overflow, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(send, 0xFF, (size_t)n_src * n * cap * 8, st);
  if (e == cudaSuccess) e = cudaMemsetAsync(overflow, 0, (size_t)n_src * 4, st);
  if (e != cudaSuccess) return (int)e;
  if (Pn <= 0 || n_src <= 0) return (int)cudaGetLastError();
  const int nchunks = (int)((Pn + kChunk - 1) / kChunk);
  const dim3 grid(nchunks, n_src);
  route_count_kernel<<<grid, kChunk, n * sizeof(int), st>>>(
      (const u32*)idx_hi, (const u32*)idx_lo, (const uint8_t*)win_valid, Pn,
      n, wps, wide, nchunks, (int*)counts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  route_scan_kernel<<<n_src * n, kScanThreads, 0, st>>>(
      (const int*)counts, nchunks, n, cap, (int*)offs, (int*)overflow);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  route_scatter_kernel<<<grid, kChunk, kWarps * n * sizeof(int), st>>>(
      (const u32*)idx_hi, (const u32*)idx_lo, (const uint8_t*)win_valid, Pn,
      n, wps, wide, nchunks, cap, (const int*)offs, (uint2*)send, (int*)slot,
      (int*)owner);
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

extern "C" int shkk_shard_return(const void* back, long long Pn,
                                 long long total, int n, long long cap,
                                 const void* owner, const void* slot,
                                 void* tagv, void* payv, void* stream) {
  if (total > 0) {
    shard_return_kernel<<<grid_for(total, kThreads), kThreads, 0,
                          (cudaStream_t)stream>>>(
        (const uint2*)back, Pn, total, n, cap, (const int*)owner,
        (const int*)slot, (u32*)tagv, (u32*)payv);
  }
  return (int)cudaGetLastError();
}
