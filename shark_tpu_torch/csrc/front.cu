// K1, the front end: planar 2-bit reads -> canonical k-mer -> XXH64 ->
// Bloom position (hi, lo) for every probe window, plus each read's length.
//
// Replaces the jit'd TPU front end of shark_tpu: classify/step.py
// unpack_codes (:1218), ops/kmers.py canonical_kmers_jax (:79),
// ops/xxh64.py xxh64_u64 (:36, uint32 limb pairs) and step.py _mod_size
// (:334), sliced as in bloom_positions (:635); length as hashed.py:561.
//
// Bound: integer operations. Each window hashes one 64-bit key (five
// 64-bit multiplies with their rotates and xor-shifts) and reduces it,
// about 50 operations (chip_smoke.py's count); the bytes (L/4 + L/8 per
// read in, 9 per window out) take a little less time on the card.
//
// What the first design spent its time on instead: one thread per window
// found its (read, window) with a 64-bit division, and for each of its k
// bases ran four 32-bit divisions by the runtime plane widths and re-read
// the row. This design does no division per window:
// - a block takes 32 consecutive reads (fewer when the rows of 32 long
//   reads would not fit in shared memory) and stages their planar rows,
//   contiguous across reads, with 16-byte loads;
// - a warp decodes one read at a time into three bit streams of 32 bases
//   a word: forward codes (2 bits a base, the first base most
//   significant), complemented codes (2 bits a base, the first base least
//   significant) and validity bits. A lane finds its base in the planar
//   row in a table that the block builds once, by comparing positions
//   with the plane widths (byte q holds bases q, q + L/4, q + 2L/4,
//   q + 3L/4; validity byte q bases q + r L/8), and warp reductions
//   (__reduce_or_sync, one instruction each, and a ballot for the
//   validity bits) assemble the 32 lanes' bases into the words. An
//   invalid base is code 0 (complement 3), as canonical_kmers_jax's
//   where(valid, codes, 0). One word of padding in front holds code 0 and
//   no valid bit, so a window that starts before position 0 (L < k)
//   reads code 0 for its missing bases, as the reference does;
// - a lane per window extracts its forward k-mer, its reverse complement
//   and its k validity bits with funnel shifts of two words each;
// - the length is the popcount of the validity words, once per read;
// - for a Bloom size that is a multiple of 2^32, hi % (size >> 32) is a
//   multiply by a 64-bit magic number from the host
//   (step._fastmod_magic: Lemire, Kaser and Kurz's direct remainder).
// Consecutive lanes store consecutive windows, so the stores coalesce.
//
// Reads longer than kMaxShortL bases take a second kernel: a whole read no
// longer fits in shared memory, and the table above packs positions into
// 12-bit fields. A block takes one read, and each warp walks its share of
// the read in tiles of kTile positions. A lane finds its base's planar byte
// by comparing with the plane widths, reads it from global memory (the 32
// lanes read 32 consecutive bytes), and the warp builds the same three bit
// streams for the tile plus one word for the k - 1 bases its last windows
// reach past it; the window extraction is the one above. Tiles step over
// all L positions, not only the Ls windows, so the length counts each base
// once. This path serves rare reads and is written to be right, not fast.
#include "common.cuh"

namespace {

constexpr int kReads = 32;  // reads per block, at most
constexpr int kWarps = 8;
constexpr u32 kFull = 0xffffffffu;
constexpr int kMaxShortL = 16384;      // longest read of the staged path
constexpr int kTileWords = 32;         // stream words a long-read tile owns
constexpr int kTile = 32 * kTileWords;  // positions (and windows) a tile owns

constexpr u64 P1 = 11400714785074694791ull;
constexpr u64 P2 = 14029467366897019727ull;
constexpr u64 P3 = 1609587929392839161ull;
constexpr u64 P4 = 9650029242287828579ull;
constexpr u64 P5 = 2870177450012600261ull;

__device__ __forceinline__ u64 rotl64(u64 x, int s) {
  return (x << s) | (x >> (64 - s));
}

// XXH64 of one 8-byte little-endian key, seed 0 (xxhash.hpp:427-489).
__device__ __forceinline__ u64 xxh64_8(u64 x) {
  u64 h = P5 + 8;
  h ^= rotl64(x * P2, 31) * P1;
  h = rotl64(h, 27) * P1 + P4;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

struct FrontArgs {
  const uint8_t* packed;
  const uint8_t* vmask;
  int B, L, k, Ls, s0, mod_mode;
  int reads;  // per block
  u64 mod_arg, mod_magic;
  int vec;  // every block's rows 16-byte aligned: stage with uint4 loads
  u32* idx_hi;
  u32* idx_lo;
  uint8_t* win_valid;
  int32_t* length;
};

// Words of each bit stream per read: one of padding, the read's bases,
// and one more that a window's second word may reach.
__host__ __device__ __forceinline__ int stream_words(int L) {
  return ((L + 31) >> 5) + 2;
}

__host__ __device__ __forceinline__ int round16(int n) {
  return (n + 15) & ~15;
}

// Shared memory of a block of `reads` reads: their planar rows, the bit
// streams of its warps, and the table of where each base lies.
static size_t front_smem(int L, int reads) {
  return round16(reads * (L >> 2)) + round16(reads * (L >> 3)) +
         (size_t)kWarps * stream_words(L) * (2 * 8 + 4) +
         (size_t)32 * stream_words(L) * 4;
}

__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* src,
                                      int n, bool vec) {
  const int n16 = vec ? (n >> 4) : 0;
  for (int i = threadIdx.x; i < n16; i += blockDim.x)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  for (int i = (n16 << 4) + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = src[i];
}

// Word c of a warp's three bit streams from the 32 lanes' bases (lane i
// holds base i of the word: its 2-bit code, 0 when invalid, and its
// validity bit); lane 0 stores it. Returns the validity word.
__device__ __forceinline__ u32 put_word(u32 code, u32 v, int lane, u64* F,
                                        u64* R, u32* V, int c) {
  // lane i's base: forward bits 63-2i..62-2i, complement bits 2i+1..2i
  const bool top = lane < 16;
  const u32 fc = code << (2 * (15 - (lane & 15)));
  const u32 rcm = (3u ^ code) << (2 * (lane & 15));
  const u32 f_hi = __reduce_or_sync(kFull, top ? fc : 0u);
  const u32 f_lo = __reduce_or_sync(kFull, top ? 0u : fc);
  const u32 r_lo = __reduce_or_sync(kFull, top ? rcm : 0u);
  const u32 r_hi = __reduce_or_sync(kFull, top ? 0u : rcm);
  const u32 vb = __ballot_sync(kFull, v);
  if (lane == 0) {
    F[c] = ((u64)f_hi << 32) | f_lo;
    R[c] = ((u64)r_hi << 32) | r_lo;
    V[c] = vb;
  }
  return vb;
}

// The window whose k bases start at stream index t: its canonical k-mer from
// two words of each stream, hashed, reduced and stored at flat index `at`.
// mod_mode (see step.py _mod_size): 0 = power of two <= 2^32 (mod_arg is
// the lo mask, hi = 0); 1 = power of two > 2^32 (mod_arg is the hi mask);
// 2 = multiple of 2^32 (mod_arg = size >> 32, hi %= it by mod_magic).
__device__ __forceinline__ void emit_window(const FrontArgs& a, long long at,
                                            const u64* F, const u64* R,
                                            const u32* V, int t) {
  const int k = a.k;
  const int w = t >> 5;
  const int sh = 2 * (t & 31);
  const u64 fa = F[w], fb = F[w + 1], ra = R[w], rb = R[w + 1];
  const u64 top = sh ? (fa << sh) | (fb >> (64 - sh)) : fa;
  const u64 fwd = top >> (64 - 2 * k);
  const u64 rc = (sh ? (ra >> sh) | (rb << (64 - sh)) : ra) &
                 ((1ull << (2 * k)) - 1);
  const u32 vbits = __funnelshift_r(V[w], V[w + 1], t & 31);
  const u32 kmask1 = (1u << k) - 1;
  const u64 h = xxh64_8(fwd < rc ? fwd : rc);
  u32 hi = (u32)(h >> 32);
  u32 lo = (u32)h;
  if (a.mod_mode == 0) {
    hi = 0;
    lo &= (u32)a.mod_arg;
  } else if (a.mod_mode == 1) {
    hi &= (u32)a.mod_arg;
  } else {
    hi = (u32)__umul64hi(a.mod_magic * hi, a.mod_arg);
  }
  a.idx_hi[at] = hi;
  a.idx_lo[at] = lo;
  a.win_valid[at] = (vbits & kmask1) == kmask1 ? 1 : 0;
}

__global__ void __launch_bounds__(kWarps * 32) front_kernel(const FrontArgs a) {
  extern __shared__ uint4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  const int L4 = a.L >> 2;
  const int L8 = a.L >> 3;
  const int NC = stream_words(a.L);
  const long long b0 = (long long)blockIdx.x * a.reads;
  const int nr = min(a.reads, a.B - (int)b0);
  uint8_t* sp = smem;
  uint8_t* sv = sp + round16(a.reads * L4);
  u64* streams = reinterpret_cast<u64*>(sv + round16(a.reads * L8));
  // where stream index t (position t - 32) lies in a planar row, the same
  // for every read: code byte | validity byte << 12 | code plane << 24 |
  // validity plane << 27 (L <= 16384)
  u32* where = reinterpret_cast<u32*>(streams + kWarps * 2 * NC) +
               kWarps * NC;
  stage(sp, a.packed + b0 * L4, nr * L4, a.vec);
  stage(sv, a.vmask + b0 * L8, nr * L8, a.vec);
  for (int t = threadIdx.x; t < 32 * NC; t += blockDim.x) {
    const int p = t - 32;
    u32 w = 0xFFFFFFFFu;  // padding, or past the read
    if (p >= 0 && p < a.L) {
      const int r4 = (p >= L4) + (p >= 2 * L4) + (p >= 3 * L4);
      int r8 = 0;
#pragma unroll
      for (int m = 1; m < 8; ++m) r8 += p >= m * L8;
      w = (u32)(p - r4 * L4) | ((u32)(p - r8 * L8) << 12) | ((u32)r4 << 24) |
          ((u32)r8 << 27);
    }
    where[t] = w;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  u64* F = streams + warp * 2 * NC;  // forward codes
  u64* R = F + NC;                   // complemented codes
  u32* V = reinterpret_cast<u32*>(streams + kWarps * 2 * NC) + warp * NC;
  // stream index of window j's first base is j + first
  const int first = a.s0 - (a.k - 1) + 32;

  for (int r = warp; r < nr; r += kWarps) {
    const uint8_t* prow = sp + r * L4;
    const uint8_t* vrow = sv + r * L8;
    int n_valid = 0;
    for (int c = 0; c < NC; ++c) {
      const u32 w = where[32 * c + lane];  // the base this lane decodes
      u32 code = 0, v = 0;
      if (w != 0xFFFFFFFFu) {
        v = (vrow[(w >> 12) & 0xFFFu] >> (w >> 27)) & 1u;
        code = v ? (u32)(prow[w & 0xFFFu] >> (2 * ((w >> 24) & 3u))) & 3u : 0u;
      }
      n_valid += __popc(put_word(code, v, lane, F, R, V, c));
    }
    __syncwarp();

    const long long row = (b0 + r) * a.Ls;
    for (int j = lane; j < a.Ls; j += 32)
      emit_window(a, row + j, F, R, V, first + j);
    if (lane == 0) a.length[b0 + r] = n_valid;
    __syncwarp();  // F, R and V are rewritten for the warp's next read
  }
}

// Reads longer than kMaxShortL: one block a read, tiles of kTile
// positions. Here L > k, so s0 = k - 1 and window j covers positions j to
// j + k - 1: the stream needs no padding word, and window p0 + jj of the
// tile at p0 starts at stream index jj.
__global__ void __launch_bounds__(kWarps * 32)
    front_long_kernel(const FrontArgs a) {
  __shared__ u64 sF[kWarps][kTileWords + 1];
  __shared__ u64 sR[kWarps][kTileWords + 1];
  __shared__ u32 sV[kWarps][kTileWords + 1];
  __shared__ int n_valid;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = blockIdx.x;
  const int L4 = a.L >> 2;
  const int L8 = a.L >> 3;
  const uint8_t* prow = a.packed + b * L4;
  const uint8_t* vrow = a.vmask + b * L8;
  u64* F = sF[warp];
  u64* R = sR[warp];
  u32* V = sV[warp];
  if (threadIdx.x == 0) n_valid = 0;
  __syncthreads();
  int my_valid = 0;
  for (int p0 = warp * kTile; p0 < a.L; p0 += kWarps * kTile) {
    for (int c = 0; c <= kTileWords; ++c) {
      const int p = p0 + 32 * c + lane;
      u32 code = 0, v = 0;
      if (p < a.L) {
        const int r4 = (p >= L4) + (p >= 2 * L4) + (p >= 3 * L4);
        int r8 = 0;
#pragma unroll
        for (int m = 1; m < 8; ++m) r8 += p >= m * L8;
        v = (vrow[p - r8 * L8] >> r8) & 1u;
        code = v ? (u32)(prow[p - r4 * L4] >> (2 * r4)) & 3u : 0u;
      }
      const u32 vb = put_word(code, v, lane, F, R, V, c);
      if (c < kTileWords) my_valid += __popc(vb);  // the last word is the next tile's
    }
    __syncwarp();
    const int nj = min(kTile, a.Ls - p0);
    for (int jj = lane; jj < nj; jj += 32)
      emit_window(a, b * a.Ls + p0 + jj, F, R, V, jj);
    __syncwarp();  // F, R and V are rewritten for the warp's next tile
  }
  if (lane == 0) atomicAdd(&n_valid, my_valid);
  __syncthreads();
  if (threadIdx.x == 0) a.length[b] = n_valid;
}

}  // namespace

extern "C" int shkk_max_smem_optin() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

extern "C" int shkk_front(const void* packed, const void* vmask, int B,
                          int L, int k, int mod_mode,
                          unsigned long long mod_arg,
                          unsigned long long mod_magic, void* idx_hi,
                          void* idx_lo, void* win_valid, void* length,
                          void* stream) {
  FrontArgs a;
  a.packed = (const uint8_t*)packed;
  a.vmask = (const uint8_t*)vmask;
  a.B = B;
  a.L = L;
  a.k = k;
  a.s0 = (k - 1) < (L - 1) ? (k - 1) : (L - 1);
  a.Ls = L - a.s0;
  a.mod_mode = mod_mode;
  a.mod_arg = (u64)mod_arg;
  a.mod_magic = (u64)mod_magic;
  a.idx_hi = (u32*)idx_hi;
  a.idx_lo = (u32*)idx_lo;
  a.win_valid = (uint8_t*)win_valid;
  a.length = (int32_t*)length;
  if (L > kMaxShortL) {
    if (k > 32) return (int)cudaErrorInvalidValue;
    if (B > 0)
      front_long_kernel<<<B, kWarps * 32, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  // 32 reads a block, halved until the block fits (one read of L = 16384
  // takes 151 KB)
  a.reads = kReads;
  if (front_smem(L, kReads) > 48 * 1024) {
    const size_t optin = (size_t)shkk_max_smem_optin();
    while (a.reads > 1 && front_smem(L, a.reads) > optin) a.reads >>= 1;
  }
  // every block's rows start 16-byte aligned
  a.vec = (((uintptr_t)packed | (uintptr_t)vmask) & 15) == 0 &&
          (a.reads * (L >> 3)) % 16 == 0;
  const size_t smem = front_smem(L, a.reads);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        front_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B > 0)
    front_kernel<<<grid_for(B, a.reads), kWarps * 32, smem,
                   (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* shkk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
