// K5, the classic probe: a (word, rank) row, then a pay row, per window.
//
// Replaces shark_tpu/classify/step.py probe_rank (:661), decode_pay_words
// (:673) and probe_tags (:687), which classify_kernel (:1190) composes
// after hash_positions (:621).
//
// Position p = hi * 2^32 + lo addresses Bloom word p >> 5 = hi << 27 |
// lo >> 5 (64-bit: 2^28 words at -b 1) and bit lo & 31. bf_rank[word] =
// (the Bloom word w0, the count of set bits before it w1): hit = valid and
// bit set, rank = w1 + popcount of w0's bits below the bit. A hit's
// pay[rank] = (tag << 30 | gene0, word1) is decoded as decode_pay_words
// does. shark_tpu reads pay[0] on a miss and zeroes its first word, so a
// miss gives tag 0 and payload (pay[0].y & 0xFFFF) << 16: that word is
// loaded once a thread, beside its first (word, rank) load rather than
// after it, and a miss or an invalid window reads no pay row. An invalid
// window skips the bf_rank load too (its row could only give a miss).
//
// Bound: bytes. Per window the kernel must read 9 bytes (hi, lo, valid)
// and write 8, and it reads one 8-byte bf_rank row per touched word and
// one 8-byte pay row per distinct hit rank. At -b 1 bf_rank is 2 GiB and
// pay 0.58 GB at transcriptome scale, so both loads are random HBM reads
// of a 32-byte sector each, and a hit's two are dependent: a thread waits
// for two memory round trips, and the card hides them only with many
// windows in flight. Measured on the card (chip_smoke.py's shard_probe
// floor line, scripts/route_variants.py), that is the card's rate of
// dependent random reads: the kernel takes 1.01x a bare gather of the same
// (word, rank) rows and then pay rows. Skipping the miss's pay row gained
// nothing (it was an L1 hit on row 0), nor did 2 or 4 windows a thread
// (each issuing every (word, rank) load before its first pay load) or
// windows sorted by word within a block; so a window a thread.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) classic_kernel(
    const u32* __restrict__ idx_hi, const u32* __restrict__ idx_lo,
    const uint8_t* __restrict__ win_valid, long long n,
    const uint2* __restrict__ bf_rank, const uint2* __restrict__ pay,
    u32* __restrict__ tagv, u32* __restrict__ payv) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const u32 miss = (pay[0].y & 0xFFFFu) << 16;
  bool hit = false;
  uint2 pw = make_uint2(0u, 0u);
  if (win_valid[i] != 0) {
    const u32 lo = idx_lo[i];
    const u32 bit = lo & 31u;
    const uint2 wr = bf_rank[((u64)idx_hi[i] << 27) | (lo >> 5)];
    hit = ((wr.x >> bit) & 1u) != 0;
    if (hit) pw = pay[wr.y + __popc(wr.x & ((1u << bit) - 1u))];
  }
  const u32 tag = pw.x >> 30;
  tagv[i] = tag;
  payv[i] = !hit        ? miss
            : tag == 3u ? pw.y
                        : (pw.x & 0xFFFFu) | ((pw.y & 0xFFFFu) << 16);
}

}  // namespace

extern "C" int shkk_classic(const void* idx_hi, const void* idx_lo,
                            const void* win_valid, long long n,
                            const void* bf_rank, const void* pay, void* tagv,
                            void* payv, void* stream) {
  if (n > 0) {
    classic_kernel<<<grid_for(n, kThreads), kThreads, 0,
                     (cudaStream_t)stream>>>(
        (const u32*)idx_hi, (const u32*)idx_lo, (const uint8_t*)win_valid, n,
        (const uint2*)bf_rank, (const uint2*)pay, (u32*)tagv, (u32*)payv);
  }
  return (int)cudaGetLastError();
}
