// The floors the probes are held to: bare gathers of table rows at the
// probes' own indices, each row folded to one word so that the loads
// cannot be dropped, four indices a thread with every load issued before
// the first fold. rows16 / rows32 gather 16- or 32-byte rows (the xl
// probe's bucket; the hashed probe's entry16 bucket), rows8 8-byte rows (a
// (word, rank) or pay row); rows4, rows64 and rows128 the 4-, 64- and
// 128-byte rows of the gather-rate sweep (scripts/gather_sweep_torch.py:
// a u32 word, the entry8 bucket, two of them). Row offsets are 64-bit, so
// tables past 2^31 bytes are read whole. two_level gathers a word row and
// then, where pidx >= 0, a pay row whose address depends on the loaded
// word (the owner probe's two dependent reads without its arithmetic).
// Not kernels of the port: they compute nothing the classify path needs.
// Built on their own by shark_tpu_torch/floors.py, not into the kernels'
// library.
#include <cstdint>
#include <cuda_runtime.h>
typedef uint32_t u32;
__device__ __forceinline__ uint4 ld16(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
__device__ __forceinline__ uint2 ld8(const uint2* p) {
  uint2 v;
  asm volatile("ld.global.v2.u32 {%0, %1}, [%2];"
      : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}
template <int R>
__global__ void gather_rows(const uint4* __restrict__ table,
                            const int32_t* __restrict__ idx, long long n,
                            u32* __restrict__ out) {
  const long long i0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  uint4 v[4][R];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c)
      v[r][c] = i0 + r < n ? ld16(table + (uint64_t)(u32)idx[i0 + r] * R + c)
                           : make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    u32 x = 0;
#pragma unroll
    for (int c = 0; c < R; ++c) x ^= v[r][c].x ^ v[r][c].y ^ v[r][c].z ^ v[r][c].w;
    if (i0 + r < n) out[i0 + r] = x;
  }
}
__global__ void gather_rows4(const u32* __restrict__ table,
                             const int32_t* __restrict__ idx, long long n,
                             u32* __restrict__ out) {
  const long long i0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  u32 v[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    v[r] = i0 + r < n ? table[(uint64_t)(u32)idx[i0 + r]] : 0u;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (i0 + r < n) out[i0 + r] = v[r];
}
__global__ void gather_rows8(const uint2* __restrict__ table,
                             const int32_t* __restrict__ idx, long long n,
                             u32* __restrict__ out) {
  const long long i0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  uint2 v[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    v[r] = i0 + r < n ? ld8(table + (u32)idx[i0 + r]) : make_uint2(0, 0);
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (i0 + r < n) out[i0 + r] = v[r].x ^ v[r].y;
}
__global__ void gather_two_level(const uint2* __restrict__ words,
                                 const int32_t* __restrict__ widx,
                                 const uint2* __restrict__ pay,
                                 const int32_t* __restrict__ pidx,
                                 long long n, u32 zero,
                                 u32* __restrict__ out) {
  const long long i0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  uint2 w[4];
  int32_t p[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    w[r] = i0 + r < n ? ld8(words + (u32)widx[i0 + r]) : make_uint2(0, 0);
    p[r] = i0 + r < n ? pidx[i0 + r] : -1;
  }
  uint2 q[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    q[r] = p[r] >= 0 ? ld8(pay + ((u32)p[r] ^ (w[r].x & zero)))
                     : make_uint2(0, 0);
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (i0 + r < n) out[i0 + r] = w[r].x ^ w[r].y ^ q[r].x ^ q[r].y;
}
static unsigned grid4(long long n) { return (unsigned)((n + 1023) / 1024); }
extern "C" int gather_rows_launch(const void* table, const void* idx,
                                  long long n, int row_bytes, void* out,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 0 && row_bytes == 4)
    gather_rows4<<<grid4(n), 256, 0, st>>>(
        (const u32*)table, (const int32_t*)idx, n, (u32*)out);
  else if (n > 0 && row_bytes == 8)
    gather_rows8<<<grid4(n), 256, 0, st>>>(
        (const uint2*)table, (const int32_t*)idx, n, (u32*)out);
  else if (n > 0 && row_bytes == 16)
    gather_rows<1><<<grid4(n), 256, 0, st>>>(
        (const uint4*)table, (const int32_t*)idx, n, (u32*)out);
  else if (n > 0 && row_bytes == 32)
    gather_rows<2><<<grid4(n), 256, 0, st>>>(
        (const uint4*)table, (const int32_t*)idx, n, (u32*)out);
  else if (n > 0 && row_bytes == 64)
    gather_rows<4><<<grid4(n), 256, 0, st>>>(
        (const uint4*)table, (const int32_t*)idx, n, (u32*)out);
  else if (n > 0 && row_bytes == 128)
    gather_rows<8><<<grid4(n), 256, 0, st>>>(
        (const uint4*)table, (const int32_t*)idx, n, (u32*)out);
  else if (n > 0)
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
extern "C" int gather_two_level_launch(const void* words, const void* widx,
                                       const void* pay, const void* pidx,
                                       long long n, void* out, void* stream) {
  if (n > 0)
    gather_two_level<<<grid4(n), 256, 0, (cudaStream_t)stream>>>(
        (const uint2*)words, (const int32_t*)widx, (const uint2*)pay,
        (const int32_t*)pidx, n, 0u, (u32*)out);
  return (int)cudaGetLastError();
}
extern "C" int set_l2_fetch_granularity(long long bytes, long long* was) {
  size_t old = 0;
  cudaError_t e = cudaDeviceGetLimit(&old, cudaLimitMaxL2FetchGranularity);
  if (e == cudaSuccess) {
    *was = (long long)old;
    if (bytes > 0)
      e = cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, (size_t)bytes);
  }
  return (int)e;
}
