// K1, the front end: planar 2-bit reads -> canonical k-mer -> XXH64 ->
// Bloom position (hi, lo) for every probe window, plus each read's length.
//
// Replaces the jit'd TPU front end of shark_tpu: classify/step.py
// unpack_codes (:1218), ops/kmers.py canonical_kmers_jax (:79),
// ops/xxh64.py xxh64_u64 (:36, uint32 limb pairs) and step.py _mod_size
// (:334), sliced as in bloom_positions (:635); length as hashed.py:561.
//
// One thread per (read, window), in native 64-bit integers. Bound: bytes.
// The kernel must read the packed read (L/4 + L/8 bytes per read) and
// write 9 bytes per window plus 4 per read; its arithmetic (~2k shifts and
// 5 64-bit multiplies per window) is far below the card's integer rate.
// The k bases of a window are re-read from L1/L2 by each window's thread
// (all threads of one read touch the same 39 bytes at L = 104), which
// keeps the kernel one simple pass; a shared-memory row stage is a later
// optimisation.
//
// Planar layout (step.py:1223-1235): base p of a read is in byte
// p % (L/4), bits 2*(p / (L/4)); its validity bit is in byte p % (L/8),
// bit p / (L/8). An invalid base counts as code 0 in the k-mer value,
// exactly as canonical_kmers_jax's where(valid, codes, 0).
#include "common.cuh"

namespace {

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

// mod_mode (see step.py _mod_size): 0 = power of two <= 2^32 (mod_arg is
// the lo mask, hi = 0); 1 = power of two > 2^32 (mod_arg is the hi mask);
// 2 = multiple of 2^32 (mod_arg = size >> 32, hi %= it).
__global__ void front_kernel(const uint8_t* __restrict__ packed,
                             const uint8_t* __restrict__ vmask, int B, int L,
                             int k, int Ls, int s0, int mod_mode, u64 mod_arg,
                             u32* __restrict__ idx_hi,
                             u32* __restrict__ idx_lo,
                             uint8_t* __restrict__ win_valid,
                             int32_t* __restrict__ length) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * Ls) return;
  const int b = (int)(t / Ls);
  const int j = (int)(t % Ls);
  const int L4 = L >> 2;
  const int L8 = L >> 3;
  const uint8_t* prow = packed + (long long)b * L4;
  const uint8_t* vrow = vmask + (long long)b * L8;
  const int e = s0 + j;  // window end position
  u64 fwd = 0, rc = 0;
  bool ok = e >= k - 1;
  const int top = 2 * k - 2;
  for (int i = 0; i < k; ++i) {
    const int p = e - k + 1 + i;
    u32 c = 0;
    if (p >= 0) {
      const u32 v = (vrow[p % L8] >> (p / L8)) & 1u;
      c = v ? (u32)(prow[p % L4] >> (2 * (p / L4))) & 3u : 0u;
      ok = ok && v;
    }
    fwd = (fwd << 2) | c;
    rc = (rc >> 2) | ((u64)(3u ^ c) << top);
  }
  const u64 h = xxh64_8(fwd < rc ? fwd : rc);
  u32 hi = (u32)(h >> 32);
  u32 lo = (u32)h;
  if (mod_mode == 0) {
    hi = 0;
    lo &= (u32)mod_arg;
  } else if (mod_mode == 1) {
    hi &= (u32)mod_arg;
  } else {
    hi %= (u32)mod_arg;
  }
  idx_hi[t] = hi;
  idx_lo[t] = lo;
  win_valid[t] = ok ? 1 : 0;
  if (j == 0) {
    // length = number of valid bases = set validity bits of the row
    int n = 0;
    for (int q = 0; q < L8; ++q) n += __popc((u32)vrow[q]);
    length[b] = n;
  }
}

}  // namespace

extern "C" int shkk_front(const void* packed, const void* vmask, int B,
                          int L, int k, int mod_mode,
                          unsigned long long mod_arg, void* idx_hi,
                          void* idx_lo, void* win_valid, void* length,
                          void* stream) {
  const int s0 = (k - 1) < (L - 1) ? (k - 1) : (L - 1);
  const int Ls = L - s0;
  const long long n = (long long)B * Ls;
  if (n > 0) {
    const int threads = 256;
    front_kernel<<<grid_for(n, threads), threads, 0,
                   (cudaStream_t)stream>>>(
        (const uint8_t*)packed, (const uint8_t*)vmask, B, L, k, Ls, s0,
        mod_mode, (u64)mod_arg, (u32*)idx_hi, (u32*)idx_lo,
        (uint8_t*)win_valid, (int32_t*)length);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* shkk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int shkk_max_smem_optin() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}
