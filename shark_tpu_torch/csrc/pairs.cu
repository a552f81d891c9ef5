// K4, extract_pairs: the winners of emitted reads as one ascending
// (row << 16 | gene) u32 stream, sentinel padded, truncated to `out_len`.
//
// Replaces shark_tpu/classify/step.py extract_pairs (:378), which sorts
// the whole [B, W] key matrix. Rows ascend and a row's winners ascend
// (the finish writes them in gene order), so the sorted stream is: per
// row a count (nw when the row is emitted, 1 <= nw <= W, nw < 31, and
// neither overflowed nor a group verdict; else 0), an exclusive scan of
// the counts, and a scatter of each row's first nw winners to its
// offset. The same order, without a sort. The pair (row 65535,
// gene 65535) encodes to the sentinel itself, as in the sort.
//
// Bound: bytes (4 bytes of verdict a row, 4 per winner of an emitted row
// read, 4 per output slot written). At B = 65536 and W = 16 that is under
// one launch's latency, so the design aims at few dependent steps on many
// SMs rather than at the bytes.
//
// One launch, no scratch. The first design scanned the B counts in one
// block (64 serial steps, each a global load and a block scan) and then
// ran a thread per (row, slot) with a 64-bit division each. Here a block
// of kThreads threads owns a tile of kTileRows rows, and:
// 1. reads every row's verdict word (B <= 65536, 256 KB, all of it in
//    L2 after the finish wrote it) with 16-byte loads, all issued before
//    any sum, and reduces two sums: the counts before its tile (its first
//    offset) and all counts (the total). Each block repeats this read
//    instead of exchanging tile sums, so nothing needs a reset and no
//    block waits for another;
// 2. scans its tile's counts, two rows a thread, with one block scan;
// 3. scatters: a warp owns 64 consecutive rows, whose pairs fill one
//    contiguous run of output slots. Lane l takes slots l, l + 32, ... of
//    the run, kBatch of them at once (their winner loads in flight before
//    any store; the stores coalesce); a 5-step shuffle search over the
//    lanes' first offsets finds the slot's row, so the warp visits only
//    its pairs, not its 64 W (row, slot) places, most of them empty;
// 4. fills its share of the sentinel tail [total, out_len), so the tail is
//    written once over the whole grid.
// The design's own floor is step 1: each block moves 4 B bytes from L2,
// so the grid moves 4 B x (B / kTileRows) bytes.
#include "common.cuh"

namespace {

constexpr int kPackNwShift = 16, kPackEmitShift = 21, kPackOvfShift = 22,
              kPackGrpShift = 23, kNwSat = 31;
constexpr u32 kSentinel = 0xFFFFFFFFu;
constexpr u32 kFull = 0xffffffffu;
constexpr int kThreads = 1024;
constexpr int kRowsPerThread = 2;
constexpr int kTileRows = kThreads * kRowsPerThread;
constexpr int kWarpRows = 32 * kRowsPerThread;
constexpr int kBatch = 4;  // scatter loads a lane keeps in flight

// nw when the row is emitted and neither overflowed nor a group verdict
// (bits 21, 22, 23 read 1, 0, 0) and 1 <= nw <= wc = min(W, 30); else 0
__device__ __forceinline__ int row_count(int32_t p, u32 wc) {
  static_assert(kPackOvfShift == kPackEmitShift + 1 &&
                    kPackGrpShift == kPackEmitShift + 2,
                "the three flags are adjacent");
  const u32 v = (u32)p;
  const u32 nw = (v >> kPackNwShift) & 31u;
  return ((v >> kPackEmitShift) & 7u) == 1u && nw - 1u < wc ? (int)nw : 0;
}

// Block-wide sums of two ints; every thread gets both. sh holds >= 64 ints.
__device__ __forceinline__ int2 block_sum2(int x, int y, int* sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  x = __reduce_add_sync(kFull, x);
  y = __reduce_add_sync(kFull, y);
  if (lane == 0) {
    sh[warp] = x;
    sh[32 + warp] = y;
  }
  __syncthreads();
  const int nw = blockDim.x >> 5;
  x = lane < nw ? sh[lane] : 0;
  y = lane < nw ? sh[32 + lane] : 0;
  x = __reduce_add_sync(kFull, x);
  y = __reduce_add_sync(kFull, y);
  __syncthreads();  // sh is reused
  return make_int2(x, y);
}

__global__ void __launch_bounds__(kThreads)
    pairs_kernel(const int32_t* __restrict__ packed,
                 const int32_t* __restrict__ winners, int B, int W, int vec,
                 u32* __restrict__ out, long long out_len) {
  __shared__ int sh[64];
  const int tile0 = blockIdx.x * kTileRows;
  const u32 wc = (u32)min(W, kNwSat - 1);
  // this thread's two rows of the tile, loaded first to overlap step 1
  const int r0 = tile0 + kRowsPerThread * threadIdx.x;
  const int32_t v0 = r0 < B ? packed[r0] : 0;
  const int32_t v1 = r0 + 1 < B ? packed[r0 + 1] : 0;

  // 1. the counts before this tile, and the total
  int before = 0, all = 0;
  if (vec) {
    const int4* p4 = reinterpret_cast<const int4*>(packed);
    const int n4 = B >> 2;
    constexpr int kUnroll = 8;
    for (int q0 = threadIdx.x; q0 < n4; q0 += kUnroll * kThreads) {
      int4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + u * kThreads;
        v[u] = q < n4 ? p4[q] : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = row_count(v[u].x, wc) + row_count(v[u].y, wc) +
                      row_count(v[u].z, wc) + row_count(v[u].w, wc);
        all += c;
        before += 4 * (q0 + u * kThreads) < tile0 ? c : 0;
      }
    }
    for (int r = 4 * n4 + threadIdx.x; r < B; r += kThreads) {
      const int c = row_count(packed[r], wc);
      all += c;
      before += r < tile0 ? c : 0;
    }
  } else {
    for (int r = threadIdx.x; r < B; r += kThreads) {
      const int c = row_count(packed[r], wc);
      all += c;
      before += r < tile0 ? c : 0;
    }
  }
  const int2 sums = block_sum2(before, all, sh);
  const int total = sums.y;

  // 2. offsets of this thread's two rows
  const int c0 = row_count(v0, wc);
  const int c1 = row_count(v1, wc);
  int tile_total;
  const int off0 = sums.x + block_exclusive_scan(c0 + c1, sh, tile_total);

  // 3. scatter the warp's pairs: slot o of [first, end) belongs to the
  // last lane whose off0 <= o (a lane holding no pair has the off0 of the
  // next lane that holds one)
  const int lane = threadIdx.x & 31;
  const int wrow0 = tile0 + (threadIdx.x >> 5) * kWarpRows;
  const int first = __shfl_sync(kFull, off0, 0);
  const int end = __shfl_sync(kFull, off0 + c0 + c1, 31);
  const int stop = (int)min((long long)end, out_len);
  for (int o0 = first; o0 < stop; o0 += 32 * kBatch) {
    u32 key[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int o = o0 + 32 * u + lane;
      int j = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        const int cand = j + step;
        if (__shfl_sync(kFull, off0, cand) <= o) j = cand;
      }
      const int jo = __shfl_sync(kFull, off0, j);
      const int jc = __shfl_sync(kFull, c0, j);
      const int second = o - jo >= jc;  // the lane's second row
      const int row = wrow0 + 2 * j + second;
      const int s = o - jo - (second ? jc : 0);
      key[u] = o < stop ? ((u32)row << 16) |
                              (u32)winners[(long long)row * W + s]
                        : 0u;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int o = o0 + 32 * u + lane;
      if (o < stop) out[o] = key[u];
    }
  }

  // 4. this block's share of the sentinel tail
  const long long tail = out_len - total;
  if (tail > 0) {
    const long long per = (tail + gridDim.x - 1) / gridDim.x;
    const long long t0 = total + (long long)blockIdx.x * per;
    const long long t1 = min(out_len, t0 + per);
    for (long long t = t0 + threadIdx.x; t < t1; t += kThreads)
      out[t] = kSentinel;
  }
}

}  // namespace

extern "C" int shkk_pairs(const void* packed, const void* winners, int B,
                          int W, void* out, long long out_len, void* stream) {
  if (out_len <= 0) return (int)cudaGetLastError();  // B or W is 0, or cap
  if (B > 65536) return (int)cudaErrorInvalidValue;
  const int vec = ((uintptr_t)packed & 15) == 0;
  pairs_kernel<<<grid_for(B, kTileRows), kThreads, 0,
                 (cudaStream_t)stream>>>(
      (const int32_t*)packed, (const int32_t*)winners, B, W, vec, (u32*)out,
      out_len);
  return (int)cudaGetLastError();
}
