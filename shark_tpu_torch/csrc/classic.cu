// K5, the classic probe: a (word, rank) row, then a pay row, per window.
//
// Replaces shark_tpu/classify/step.py probe_rank (:661), decode_pay_words
// (:673) and probe_tags (:687), which classify_kernel (:1190) composes
// after hash_positions (:621).
//
// One thread per window. Position p = hi * 2^32 + lo addresses Bloom word
// p >> 5 = hi << 27 | lo >> 5 (64-bit: 2^28 words at -b 1) and bit
// lo & 31. bf_rank[word] = (the Bloom word w0, the count of set bits
// before it w1): hit = valid and bit set, rank = w1 + popcount of w0's
// bits below the bit. pay[hit ? rank : 0] = (tag << 30 | gene0, word1) is
// decoded as decode_pay_words does, with the first word zeroed on a miss,
// so a miss gives tag 0 and payload (pay[0].y & 0xFFFF) << 16, as in
// shark_tpu. An invalid window skips the bf_rank load (its row could only
// give a miss).
//
// Bound: bytes. Per window the kernel must read 9 bytes (hi, lo, valid)
// and write 8, and it reads one 8-byte bf_rank row per touched word and
// one 8-byte pay row per distinct hit rank. At -b 1 bf_rank is 2 GiB and
// pay 0.58 GB at transcriptome scale, so both loads are random HBM reads
// of a 32-byte sector each; the two are dependent, so a thread waits for
// two memory round trips and the card hides them only with many windows
// in flight.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void classic_kernel(const u32* __restrict__ idx_hi,
                               const u32* __restrict__ idx_lo,
                               const uint8_t* __restrict__ win_valid,
                               long long n, const uint2* __restrict__ bf_rank,
                               const uint2* __restrict__ pay,
                               u32* __restrict__ tagv,
                               u32* __restrict__ payv) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const u32 lo = idx_lo[i];
  bool hit = false;
  u32 rank = 0;
  if (win_valid[i] != 0) {
    const u64 word = ((u64)idx_hi[i] << 27) | (lo >> 5);
    const u32 bit = lo & 31u;
    const uint2 wr = bf_rank[word];
    hit = ((wr.x >> bit) & 1u) != 0;
    if (hit) rank = wr.y + __popc(wr.x & ((1u << bit) - 1u));
  }
  const uint2 pw = pay[rank];
  const u32 w0 = hit ? pw.x : 0u;
  const u32 tag = w0 >> 30;
  tagv[i] = tag;
  payv[i] = tag == 3u ? pw.y : ((w0 & 0xFFFFu) | ((pw.y & 0xFFFFu) << 16));
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
