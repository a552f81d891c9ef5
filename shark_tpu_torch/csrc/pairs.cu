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
// Two launches of this source: one block scans the B counts (B <= 65536)
// into `offsets` (offsets[B] = total); then one thread per (row, slot)
// writes its pair, and the threads past `total` write the sentinel.
// Bound: bytes (4 bytes of verdict and 4W of winners read per row, 4 per
// output slot written).
#include "common.cuh"

namespace {

constexpr int kPackNwShift = 16, kPackEmitShift = 21, kPackOvfShift = 22,
              kPackGrpShift = 23, kNwSat = 31;
constexpr u32 kSentinel = 0xFFFFFFFFu;

__device__ __forceinline__ int row_count(int32_t p, int W) {
  const u32 v = (u32)p;
  const int nw = (int)((v >> kPackNwShift) & 31u);
  const bool need = ((v >> kPackEmitShift) & 1u) && nw >= 1 && nw <= W &&
                    nw < kNwSat && !((v >> kPackOvfShift) & 1u) &&
                    !((v >> kPackGrpShift) & 1u);
  return need ? nw : 0;
}

__global__ void offsets_kernel(const int32_t* __restrict__ packed, int B,
                               int W, int32_t* __restrict__ offsets) {
  __shared__ int sh[33];
  int carry = 0;
  for (int base = 0; base < B; base += blockDim.x) {
    const int r = base + threadIdx.x;
    const int c = r < B ? row_count(packed[r], W) : 0;
    int total;
    const int ex = block_exclusive_scan(c, sh, total);
    if (r < B) offsets[r] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) offsets[B] = carry;
}

__global__ void scatter_kernel(const int32_t* __restrict__ packed,
                               const int32_t* __restrict__ winners, int B,
                               int W, const int32_t* __restrict__ offsets,
                               u32* __restrict__ out, long long out_len) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * W) return;
  const long long total = offsets[B];
  if (t < out_len && t >= total) out[t] = kSentinel;
  const int r = (int)(t / W);
  const int s = (int)(t % W);
  if (s < row_count(packed[r], W)) {
    const long long o = (long long)offsets[r] + s;
    if (o < out_len) out[o] = ((u32)r << 16) | (u32)winners[t];
  }
}

}  // namespace

extern "C" int shkk_pairs(const void* packed, const void* winners, int B,
                          int W, void* out, long long out_len, void* offsets,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  offsets_kernel<<<1, 1024, 0, st>>>((const int32_t*)packed, B, W,
                                     (int32_t*)offsets);
  const long long n = (long long)B * W;
  if (n > 0) {
    const int threads = 256;
    scatter_kernel<<<grid_for(n, threads), threads, 0, st>>>(
        (const int32_t*)packed, (const int32_t*)winners, B, W,
        (const int32_t*)offsets, (u32*)out, out_len);
  }
  return (int)cudaGetLastError();
}
