// P1, the per-probe tile gather: out[j] = table_tiles[idx[j] >> 6].
//
// Replaces bench/pallas_probe.py pallas_gather_tiles (:34, pl.pallas_call
// at :89), an experiment that measured how fast per-row copies started by hand
// gather random 8-byte rows of a GiB-scale table. The table is shaped
// [rows / 64, 128] u32, so each 8-byte row lies in a 512-byte tile; a probe
// copies the whole tile its row lives in and the caller takes the two
// lanes (idx & 63) * 2 and + 1 out of it.
//
// On the TPU the scalar core started one async copy per probe from HBM into
// a ring of 16 VMEM slots with a semaphore each, waiting on the oldest
// before it started the next. Here one warp takes one probe: lane 0 reads
// idx[j] and shares the tile index by shuffle, then the 32 lanes copy one
// uint4 (16 bytes) each, so the 512-byte tile moves in one coalesced load
// and one coalesced store. Warps stride over the probes; a wave of 8
// blocks of 8 warps on every SM keeps about 8k tiles (4 MB) in flight,
// more than the card's memory latency times its rate, without a ring.
//
// Bound: bytes. Per probe 4 bytes of idx in and 512 out, and 512 bytes of
// table per distinct tile touched: at most n * (4 + 512 + 512). The
// Hopper counterpart of the TPU's copy ring (cp.async.bulk into a ring of
// shared-memory slots with an mbarrier each) is later work.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // warps per block
constexpr int kBlocksPerSm = 8;
constexpr int kTileU4 = 32;  // 512-byte tile = 32 uint4, one per lane

__global__ void gather_tiles_kernel(const uint4* __restrict__ table,
                                    const int* __restrict__ idx, long long n,
                                    uint4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long j = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       j < n; j += nwarps) {
    const int i = lane == 0 ? idx[j] : 0;
    const long long tile = (long long)(__shfl_sync(0xffffffffu, i, 0) >> 6);
    out[j * kTileU4 + lane] = table[tile * kTileU4 + lane];
  }
}

}  // namespace

extern "C" int shkk_gather_tiles(const void* table_tiles, const void* idx,
                                 long long n, void* out, void* stream) {
  if (n > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long wave = (long long)sms * kBlocksPerSm;
    const long long need = (n + kWarps - 1) / kWarps;
    gather_tiles_kernel<<<(unsigned)(need < wave ? need : wave), kWarps * 32,
                          0, (cudaStream_t)stream>>>(
        (const uint4*)table_tiles, (const int*)idx, n, (uint4*)out);
  }
  return (int)cudaGetLastError();
}
