// K3, the finish: per-window (tag, payload) -> per-read verdicts.
//
// Replaces shark_tpu/classify/step.py finish_from_tags (:869) with
// finish_from_keys (:772), keys_from_gm (:700), compact_true_cols (:493)
// and the packed verdict layout (:366-372).
//
// Per read, the keys (gene << pos_bits | pos) are: one or two direct
// keys for tag 1/2 windows, the inline genes of a tag-3 window's rows3
// row, and for rows past the inline width the genes of their extension
// row (only the first EXT_CAP2 such windows of a read, in column order;
// more, or a row wider than the extension, sets the overflow bit). The
// keys are sorted; a gene's segment scores coverage (head k, then
// min(k, pos - previous pos)) and hits; best = max cov*(L+1)+hits over
// segments; the winners are every segment scoring best (best > 0), in
// ascending gene order, W wide and -1 padded; emit = cov >= thresh[len].
// Only the multiset of valid keys matters, so the kernel builds the
// valid keys alone, in any order, and sorts them.
//
// The group fast path (step.py:1004-1168) changes verdicts batch-wide:
// with n_fix = reads that hit rows but are not pure, a batch with
// n_fix <= FIX_CAP2 gives every pure read (all hits are rows of one gene
// set) the GROUP verdict of its set scored as one pseudo gene (id
// n_genes), and every other read its full verdict; a batch past FIX_CAP2
// gives every read its full verdict. So the finish is two launches of
// this source: a batch-wide pass that classifies each read and counts
// n_fix on the device, then one block per read that reads n_fix.
//
// Bound: bytes for the key-light reads of a panel (each read's 8 bytes
// per window of (tag, payload) in, 12 + 4W bytes of verdict out); the
// per-read work is a shared-memory bitonic sort of the read's keys
// (next power of two of its key count) and a few block scans, ~log^2
// passes with a barrier each, which bounds it in practice. Keys live in
// dynamic shared memory when the geometry's key bound fits, else in a
// global scratch slice per block, with the same code.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kExtCap2 = 16;  // step.py EXT_CAP2
constexpr u32 kTagD1 = 1, kTagD2 = 2, kTagRow = 3;
constexpr int kPackNwShift = 16, kPackEmitShift = 21, kPackOvfShift = 22,
              kPackGrpShift = 23, kNwSat = 31;

// flags of the batch-wide pass
constexpr uint8_t kPure = 1, kNeedFix = 2;

// One warp per read: any direct hit, any row hit, min and max group id
// over row hits.
__global__ void groups_kernel(const u32* __restrict__ tagv,
                              const u32* __restrict__ payv, int B, int Ls,
                              int rb, uint8_t* __restrict__ flags,
                              int32_t* __restrict__ gmax_out,
                              int32_t* __restrict__ n_fix) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= B) return;  // whole warps exit together
  const u32* t = tagv + (long long)warp * Ls;
  const u32* p = payv + (long long)warp * Ls;
  bool any_direct = false, any_row = false;
  int gmin = INT32_MAX, gmax = -1;
  for (int j = lane; j < Ls; j += 32) {
    const u32 tag = t[j];
    if (tag == kTagD1 || tag == kTagD2) any_direct = true;
    if (tag == kTagRow) {
      any_row = true;
      const int g = (int)(p[j] >> rb);
      gmin = min(gmin, g);
      gmax = max(gmax, g);
    }
  }
  any_direct = __any_sync(0xffffffffu, any_direct);
  any_row = __any_sync(0xffffffffu, any_row);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    gmin = min(gmin, __shfl_xor_sync(0xffffffffu, gmin, o));
    gmax = max(gmax, __shfl_xor_sync(0xffffffffu, gmax, o));
  }
  if (lane == 0) {
    const bool pure = any_row && !any_direct && gmax == gmin;
    const bool need_fix = any_row && !pure;
    flags[warp] = (pure ? kPure : 0) | (need_fix ? kNeedFix : 0);
    gmax_out[warp] = gmax;
    if (need_fix) atomicAdd(n_fix, 1);
  }
}

struct ReadsArgs {
  const u32* tagv;
  const u32* payv;
  const int32_t* length;
  const int32_t* thresh;
  const u32* rows3;
  int n3, rows3_w, D;
  const uint16_t* ext_mat;
  int ext_w;
  int B, Ls, L, k, pos_bits, n_genes, rb, W;
  int has_rows, groups;
  const uint8_t* flags;
  const int32_t* gmax;
  const int32_t* n_fix;
  int fix_cap2;
  int key_cap;
  u32* scratch;  // null: keys live in shared memory
  int32_t* packed;
  int32_t* winners;
  int32_t* best_cov;
};

__device__ __forceinline__ u32 row_field(const u32* row, int i) {
  const u32 w = row[i >> 1];
  return (i & 1) ? (w >> 16) : (w & 0xFFFFu);
}

// cov * M + hits of the gene segment ending at sorted key i, or 0 when
// key i is not the last of its gene. csum is the inclusive prefix sum of
// the per-key coverage contributions.
__device__ __forceinline__ int segment_score(const u32* keys,
                                             const int32_t* csum, int nk,
                                             int i, int pb, int M) {
  const u32 gene = keys[i] >> pb;
  if (i + 1 < nk && (keys[i + 1] >> pb) == gene) return 0;
  const u32 head = gene << pb;  // the gene's first key is >= head
  int lo = 0, hi = i;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < head) lo = mid + 1; else hi = mid;
  }
  const int cov = csum[i] - (lo > 0 ? csum[lo - 1] : 0);
  return cov * M + (i - lo + 1);
}

__global__ void __launch_bounds__(kThreads)
    reads_kernel(const ReadsArgs a) {
  extern __shared__ u32 smem[];
  __shared__ int sh[33];
  __shared__ int s_nk;
  __shared__ int s_ovf;
  __shared__ int s_w0;
  u32* keys;
  int32_t* csum;
  if (a.scratch) {
    keys = a.scratch + (long long)blockIdx.x * 2 * a.key_cap;
  } else {
    keys = smem;
  }
  csum = reinterpret_cast<int32_t*>(keys + a.key_cap);
  const int tid = threadIdx.x;
  const int D = a.D;
  const int off = a.L - a.Ls;
  const int pb = a.pos_bits;
  const u32 pmask = (1u << pb) - 1u;
  const bool group_mode = a.groups && (*a.n_fix <= a.fix_cap2);
  const u32 rmask = a.rb ? ((1u << a.rb) - 1u) : 0xFFFFFFFFu;

  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const bool pure = group_mode && (a.flags[b] & kPure);
    const u32* tg = a.tagv + (long long)b * a.Ls;
    const u32* py = a.payv + (long long)b * a.Ls;
    if (tid == 0) {
      s_nk = 0;
      s_ovf = 0;
      s_w0 = -1;
    }
    __syncthreads();

    // ---- keys: direct, inline row genes, pseudo gene (pure reads) ----
    int n_needy = 0;
    for (int j = tid; j < a.Ls; j += blockDim.x) {
      const u32 tag = tg[j];
      const u32 pay = py[j];
      const u32 pos = (u32)(off + j);
      if (tag == kTagD1 || tag == kTagD2) {
        const int c = tag == kTagD2 ? 2 : 1;
        const int at = atomicAdd(&s_nk, c);
        keys[at] = ((pay & 0xFFFFu) << pb) | pos;
        if (c == 2) keys[at + 1] = ((pay >> 16) << pb) | pos;
      } else if (tag == kTagRow && a.has_rows) {
        if (pure) {
          keys[atomicAdd(&s_nk, 1)] = ((u32)a.n_genes << pb) | pos;
        } else {
          u32 ridx = pay & rmask;
          if (ridx >= (u32)a.n3) ridx = a.n3 - 1;
          const u32* row = a.rows3 + (u64)ridx * a.rows3_w;
          const int deg = (int)row_field(row, 0);
          int nin;
          if (a.ext_w == 0) {
            nin = deg < D ? deg : D;
          } else if (deg > D) {
            nin = D - 2;
            ++n_needy;
          } else {
            nin = deg;
          }
          if (nin > 0) {
            const int at = atomicAdd(&s_nk, nin);
            for (int d = 0; d < nin; ++d)
              keys[at + d] = (row_field(row, 1 + d) << pb) | pos;
          }
        }
      }
    }
    // ---- extension rows: the first EXT_CAP2 needy windows by column ----
    int total_needy;
    block_exclusive_scan(n_needy, sh, total_needy);
    if (total_needy > 0) {
      bool ovf = total_needy > kExtCap2 || a.ext_mat == nullptr;
      int carry = 0;
      for (int base = 0; base < a.Ls; base += blockDim.x) {
        const int j = base + tid;
        int needy = 0, deg = 0;
        const u32* row = nullptr;
        if (j < a.Ls && tg[j] == kTagRow) {
          u32 ridx = py[j] & rmask;
          if (ridx >= (u32)a.n3) ridx = a.n3 - 1;
          row = a.rows3 + (u64)ridx * a.rows3_w;
          deg = (int)row_field(row, 0);
          needy = deg > D;
        }
        int chunk_total;
        const int rank = carry + block_exclusive_scan(needy, sh, chunk_total);
        carry += chunk_total;
        if (needy) {
          const int resid = deg - (D - 2);
          if (resid > a.ext_w) ovf = true;
          if (rank < kExtCap2 && a.ext_mat != nullptr) {
            const u32 erow =
                row_field(row, D - 1) | (row_field(row, D) << 16);
            const uint16_t* eg = a.ext_mat + (u64)erow * a.ext_w;
            const int take = resid < a.ext_w ? resid : a.ext_w;
            const u32 pos = (u32)(off + j);
            const int at = atomicAdd(&s_nk, take);
            for (int d = 0; d < take; ++d)
              keys[at + d] = ((u32)eg[d] << pb) | pos;
          }
        }
      }
      if (ovf) s_ovf = 1;  // benign race: every writer stores 1
    }
    __syncthreads();
    const int nk = s_nk;

    // ---- bitonic sort of keys[0 .. n2) with sentinel padding ----
    int n2 = 1;
    while (n2 < nk) n2 <<= 1;
    if (nk > 1) {
      for (int i = nk + tid; i < n2; i += blockDim.x) keys[i] = 0xFFFFFFFFu;
      __syncthreads();
      for (int size = 2; size <= n2; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          for (int i = tid; i < (n2 >> 1); i += blockDim.x) {
            const int lo = 2 * stride * (i / stride) + (i % stride);
            const int hi = lo + stride;
            const bool asc = (lo & size) == 0;
            const u32 x = keys[lo], y = keys[hi];
            if ((x > y) == asc) {
              keys[lo] = y;
              keys[hi] = x;
            }
          }
          __syncthreads();
        }
      }
    }

    // ---- segmented coverage: inclusive prefix sum of contributions ----
    int carry = 0;
    for (int base = 0; base < nk; base += blockDim.x) {
      const int i = base + tid;
      int contrib = 0;
      if (i < nk) {
        const u32 key = keys[i];
        if (i == 0 || (keys[i - 1] >> pb) != (key >> pb)) {
          contrib = a.k;
        } else {
          const int d = (int)(key & pmask) - (int)(keys[i - 1] & pmask);
          contrib = d < a.k ? d : a.k;
        }
      }
      int chunk_total;
      const int ex = block_exclusive_scan(contrib, sh, chunk_total);
      if (i < nk) csum[i] = carry + ex + contrib;
      carry += chunk_total;
    }
    __syncthreads();

    // ---- best (cov, hits) over segment ends ----
    const int M = a.L + 1;
    int best = 0;
    for (int base = 0; base < nk; base += blockDim.x) {
      const int i = base + tid;
      const int comb = i < nk ? segment_score(keys, csum, nk, i, pb, M) : 0;
      best = max(best, block_max(comb, sh));
    }

    // ---- winners: segment ends scoring best, ascending gene ----
    int nw = 0;
    for (int base = 0; base < nk; base += blockDim.x) {
      const int i = base + tid;
      const bool win = best > 0 && i < nk &&
                       segment_score(keys, csum, nk, i, pb, M) == best;
      int chunk_total;
      const int rank = nw + block_exclusive_scan(win ? 1 : 0, sh, chunk_total);
      if (win) {
        const int g = (int)(keys[i] >> pb);
        if (rank < a.W) a.winners[(long long)b * a.W + rank] = g;
        if (rank == 0) s_w0 = g;
      }
      nw += chunk_total;
    }
    for (int r = nw + tid; r < a.W; r += blockDim.x)
      a.winners[(long long)b * a.W + r] = -1;
    __syncthreads();

    if (tid == 0) {
      const int best_cov = best / M;
      int len = a.length[b];
      len = len < 0 ? 0 : (len > a.L ? a.L : len);
      const int emit = best_cov >= a.thresh[len] ? 1 : 0;
      int packed;
      if (pure) {
        packed = max(a.gmax[b], 0) | (1 << kPackNwShift) |
                 (emit << kPackEmitShift) | (1 << kPackGrpShift);
      } else {
        const int nw_sat = nw < kNwSat ? nw : kNwSat;
        packed = max(s_w0, 0) | (nw_sat << kPackNwShift) |
                 (emit << kPackEmitShift) | (s_ovf << kPackOvfShift);
      }
      a.packed[b] = packed;
      a.best_cov[b] = best_cov;
    }
    __syncthreads();  // shared state is rewritten by the next read
  }
}

}  // namespace

extern "C" int shkk_finish_groups(const void* tagv, const void* payv, int B,
                                  int Ls, int rb, void* flags, void* gmax,
                                  void* n_fix, void* stream) {
  if (B > 0) {
    const int threads = 256;
    groups_kernel<<<grid_for((long long)B * 32, threads), threads, 0,
                    (cudaStream_t)stream>>>(
        (const u32*)tagv, (const u32*)payv, B, Ls, rb, (uint8_t*)flags,
        (int32_t*)gmax, (int32_t*)n_fix);
  }
  return (int)cudaGetLastError();
}

extern "C" int shkk_finish_reads(
    const void* tagv, const void* payv, const void* length,
    const void* thresh, const void* rows3, int n3, int rows3_w, int D,
    const void* ext_mat, int ext_w, int B, int Ls, int L, int k,
    int pos_bits, int n_genes, int rb, int W, int has_rows, int groups,
    const void* flags, const void* gmax, const void* n_fix, int fix_cap2,
    int key_cap, int grid, void* scratch, void* packed, void* winners,
    void* best_cov, void* stream) {
  ReadsArgs a;
  a.tagv = (const u32*)tagv;
  a.payv = (const u32*)payv;
  a.length = (const int32_t*)length;
  a.thresh = (const int32_t*)thresh;
  a.rows3 = (const u32*)rows3;
  a.n3 = n3;
  a.rows3_w = rows3_w;
  a.D = D;
  a.ext_mat = (const uint16_t*)ext_mat;
  a.ext_w = ext_w;
  a.B = B;
  a.Ls = Ls;
  a.L = L;
  a.k = k;
  a.pos_bits = pos_bits;
  a.n_genes = n_genes;
  a.rb = rb;
  a.W = W;
  a.has_rows = has_rows;
  a.groups = groups;
  a.flags = (const uint8_t*)flags;
  a.gmax = (const int32_t*)gmax;
  a.n_fix = (const int32_t*)n_fix;
  a.fix_cap2 = fix_cap2;
  a.key_cap = key_cap;
  a.scratch = (u32*)scratch;
  a.packed = (int32_t*)packed;
  a.winners = (int32_t*)winners;
  a.best_cov = (int32_t*)best_cov;
  const size_t smem = scratch ? 0 : (size_t)key_cap * 8;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        reads_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B > 0 && grid > 0)
    reads_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
