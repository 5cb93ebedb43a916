// One fused stage-A traversal round per query, for Hopper.
//
// Replaces the TPU kernel repro/kernels/fused_traversal.py::
// fused_traversal_round (_fused_kernel, _adc, _bitonic_merge, mode_masks).
// One block per query runs, in order:
//   1. the query's LUT into shared memory by cp.async (16-byte copies that
//      overlap steps 2 and 3), and the slots: the frontier's L, then the M
//      candidates, ids and expanded / filter-pass flags;
//   2. the kill mask in O(L + M): a shared-memory hash table maps each
//      non-negative id to the smallest slot holding it (atomicCAS on the
//      id, atomicMin on the slot); a slot is dead iff its id is < 0 or the
//      table's slot for its id is not its own — frontier._dedup_mask's
//      earlier-slot-wins rule.  Dead slots get dist +INF, and every slot
//      whose dist is >= +INF gets id -1, as frontier.insert does;
//   3. ADC of each live candidate: its code row read with 16-byte loads
//      (all of a row's loads in flight at once), summed over c = 0..C-1,
//      left to right, with __fadd_rn from 0.0f against the shared LUT —
//      the order of pq_lookup.cu and the plain versions;
//   4. the merge by selection: the key of a slot is (dist, slot), a total
//      order equal to the stable sort's; a block radix select on the
//      distance (a byte a pass, stopping once a byte settles it) finds the
//      L-th key's distance, slots at that distance are taken in slot order
//      up to L (sel::block_select), and the L chosen keys are sorted (one
//      warp in registers when L <= 64, else a bitonic network over them in
//      shared memory).  The selection runs over all
//      L + M slots, dead ones included: their (+INF, slot) keys and flags
//      reach the frontier when fewer than L keys are finite.  Nothing
//      assumes the incoming frontier is sorted;
//   5. beam selection: the rank of each of the first L slots under the
//      key (selkey, slot), selkey = dist for unexpanded valid slots else
//      +INF; the `width` lowest finite ranks are the beam, in rank order,
//      and are marked expanded;
//   6. the per-mode fetch / tunnel / result / exact masks of the beam.
// M = 0 (the round-0 call) merges nothing and only sorts and selects.
//
// What bounds it on an H100: one block's critical path, since the search
// loop's B = 256 queries give two blocks to an SM.  A design that scans
// for duplicates in O((L+M)^2), sorts all 1,024 padded slots in 55 steps
// and issues 32 dependent 4-byte loads a candidate spends it there; this
// one has no step that grows faster than L + M except the sort of the L
// survivors, and its longest step is the candidates' row reads (by id,
// rows of the N x C table, one HBM latency for each candidate a thread
// scores).  512 threads a block keep that to two rows a thread at M = 768.
// The bytes read once (LUT, slots, code rows) and written once bound it at
// about 5 us for the loop's shapes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "select.cuh"

namespace {

constexpr float kInf = 3.4e38f;
constexpr int kThreads = 512;
enum Mode { kGate = 0, kPost = 1, kEarly = 2, kPreNaive = 3, kUnfiltered = 4 };

__host__ __device__ inline size_t align8(size_t n) { return (n + 7) & ~(size_t)7; }
__host__ __device__ inline int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

struct Layout {
  size_t lut, dist, ids, hist, state, hkey, hslot, keys, mf_id, selkey, sel_id, flags, mf_flag,
      sel_flag, total;
  int H, Lp;
};

// H: hash slots (a power of two >= 2 (L + M)); Lp: the sort width of the
// L chosen keys
__host__ __device__ inline Layout layout(int L, int M, int C, int K, int W) {
  Layout s;
  const int n = L + M;
  s.H = next_pow2(2 * n);
  s.Lp = next_pow2(L);
  s.lut = 0;  // offset 0: 16-byte aligned for cp.async
  size_t off = M ? align8((size_t)C * K * 4) : 0;
  s.dist = off;     off += (size_t)n * 4;
  s.ids = off;      off += (size_t)n * 4;
  s.hist = off;     off += 4 * 256 * 4;
  s.state = off;    off += 4 * 4;
  // the hash table is spent once the kill mask is known: the chosen keys
  // (Lp * 8 <= 16 L <= 8 H bytes) take its place
  s.hkey = off;
  s.keys = off;
  s.hslot = off + (size_t)s.H * 4;
  off += (size_t)s.H * 8;
  s.mf_id = off;    off += (size_t)L * 4;
  s.selkey = off;   off += (size_t)L * 4;
  s.sel_id = off;   off += (size_t)W * 4;
  s.flags = off;    off += (size_t)n;
  s.mf_flag = off;  off += (size_t)L;
  s.sel_flag = off; off += (size_t)W;
  s.total = align8(off);
  return s;
}

__device__ __forceinline__ uint32_t hash_of(int id, int H) {
  return ((uint32_t)id * 0x9E3779B1u) & (uint32_t)(H - 1);
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}

// Sum of lut[c, code[c]] over c = 0..C-1, left to right.  VEC: the row is
// 16-byte aligned and C % 4 == 0, read as C / 4 16-byte loads issued
// together (eight at a time).
template <bool VEC>
__device__ __forceinline__ float adc_row(const int* __restrict__ code, const float* lut_s, int C,
                                         int K) {
  float acc = 0.0f;
  if (VEC) {
    const int4* row = reinterpret_cast<const int4*>(code);
    for (int c4 = 0; c4 < C / 4; c4 += 8) {
      int4 v[8];
#pragma unroll
      for (int t = 0; t < 8; ++t)
        if (c4 + t < C / 4) v[t] = __ldg(row + c4 + t);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        if (c4 + t < C / 4) {
          const int c = 4 * (c4 + t);
          acc = __fadd_rn(acc, lut_s[(c + 0) * K + v[t].x]);
          acc = __fadd_rn(acc, lut_s[(c + 1) * K + v[t].y]);
          acc = __fadd_rn(acc, lut_s[(c + 2) * K + v[t].z]);
          acc = __fadd_rn(acc, lut_s[(c + 3) * K + v[t].w]);
        }
      }
    }
  } else {
    for (int c = 0; c < C; ++c) acc = __fadd_rn(acc, lut_s[c * K + __ldg(code + c)]);
  }
  return acc;
}

// flags: bit 0 = expanded, bit 1 = passes the filter; sel_flag adds bit 2 = valid
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2) fused_kernel(
    const int* __restrict__ fid, const float* __restrict__ fd, const uint8_t* __restrict__ fexp,
    const uint8_t* __restrict__ fpass, const int* __restrict__ nid, const int* __restrict__ codes,
    const uint8_t* __restrict__ npass, const float* __restrict__ lut, const int* __restrict__ entry,
    int* __restrict__ ofid, float* __restrict__ ofd, uint8_t* __restrict__ ofexp,
    uint8_t* __restrict__ ofpass, int* __restrict__ osel, uint8_t* __restrict__ ovalid,
    int* __restrict__ ofids, uint8_t* __restrict__ ofetch, uint8_t* __restrict__ otun,
    uint8_t* __restrict__ ores, uint8_t* __restrict__ oexact,
    int L, int M, int C, int K, int W, int mode, int by_id, int lut_async) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(L, M, C, K, W);
  float* lut_s = reinterpret_cast<float*>(smem + lay.lut);
  float* dist_s = reinterpret_cast<float*>(smem + lay.dist);
  int* ids_s = reinterpret_cast<int*>(smem + lay.ids);
  int* hkey = reinterpret_cast<int*>(smem + lay.hkey);
  int* hslot = reinterpret_cast<int*>(smem + lay.hslot);
  int* hist = reinterpret_cast<int*>(smem + lay.hist);
  int* state = reinterpret_cast<int*>(smem + lay.state);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem + lay.keys);
  int* mf_id = reinterpret_cast<int*>(smem + lay.mf_id);
  float* selkey = reinterpret_cast<float*>(smem + lay.selkey);
  int* sel_id = reinterpret_cast<int*>(smem + lay.sel_id);
  uint8_t* flg_s = smem + lay.flags;
  uint8_t* mf_flag = smem + lay.mf_flag;
  uint8_t* sel_flag = smem + lay.sel_flag;

  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n = L + M, H = lay.H;

  // 1. the LUT in flight; hash table, histograms and beam flags cleared
  if (M) {
    const float* lut_b = lut + (size_t)b * C * K;
    if (lut_async) {
      for (int i = tid; i < C * K / 4; i += T) cp_async16(lut_s + 4 * i, lut_b + 4 * i);
      asm volatile("cp.async.commit_group;\n" ::);
    } else {
      for (int i = tid; i < C * K; i += T) lut_s[i] = lut_b[i];
    }
  }
  for (int h = tid; h < H; h += T) {
    hkey[h] = -1;
    hslot[h] = 0x7FFFFFFF;
  }
  for (int i = tid; i < 4 * 256; i += T) hist[i] = 0;
  for (int w = tid; w < W; w += T) sel_flag[w] = 0;
  if (tid == 0) state[3] = 0;
  __syncthreads();

  //    slots: frontier, then candidates; each id's smallest slot in the table
  for (int s = tid; s < n; s += T) {
    int id;
    uint8_t f;
    if (s < L) {
      const size_t r = (size_t)b * L + s;
      id = fid[r];
      dist_s[s] = fd[r];
      f = (fexp[r] ? 1 : 0) | (fpass[r] ? 2 : 0);
    } else {
      const size_t r = (size_t)b * M + (s - L);
      id = nid[r];
      f = npass[r] ? 2 : 0;
    }
    ids_s[s] = id;
    flg_s[s] = f;
    if (id >= 0) {
      uint32_t h = hash_of(id, H);
      while (true) {
        const int prev = atomicCAS(&hkey[h], -1, id);
        if (prev == -1 || prev == id) {
          atomicMin(&hslot[h], s);
          break;
        }
        h = (h + 1) & (uint32_t)(H - 1);
      }
    }
  }
  if (M && lut_async) asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // 2-3. kill mask, ADC of live candidates, dead ids -> -1
  for (int s = tid; s < n; s += T) {
    const int id = ids_s[s];
    bool dead = id < 0;
    if (!dead) {
      uint32_t h = hash_of(id, H);
      while (hkey[h] != id) h = (h + 1) & (uint32_t)(H - 1);
      dead = hslot[h] != s;
    }
    float d = kInf;
    if (s < L) {
      if (!dead) d = dist_s[s];
    } else if (!dead) {
      const size_t r = (size_t)b * M + (s - L);
      d = adc_row<VEC>(by_id ? codes + (size_t)id * C : codes + r * C, lut_s, C, K);
    }
    dist_s[s] = d;
    if (d >= kInf) ids_s[s] = -1;
  }
  __syncthreads();

  // 4. the first L keys (dist, slot) of all n slots, sorted
  auto hi_of = [&](int s) { return sel::ord_dist(dist_s[s]); };
  sel::block_select<uint32_t>(hi_of, n, L, hist, state, [&](int at, int s) {
    keys[at] = ((unsigned long long)hi_of(s) << 32) | (uint32_t)s;
  });
  __syncthreads();
  if (lay.Lp <= 64) {
    if (warp == 0) {
      unsigned long long a = lane < L ? keys[lane] : ~0ull;
      unsigned long long c = lane + 32 < L ? keys[lane + 32] : ~0ull;
      sel::warp_sort64(a, c, lane);
      if (lane < L) keys[lane] = a;
      if (lane + 32 < L) keys[lane + 32] = c;
    }
  } else {
    const int P = lay.Lp;
    for (int i = L + tid; i < P; i += T) keys[i] = ~0ull;
    __syncthreads();
    for (int k = 2; k <= P; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < P; i += T) {
          const int p = i ^ j;
          if (p > i) {
            const unsigned long long ki = keys[i], kp = keys[p];
            if (((i & k) == 0) == (ki > kp)) {
              keys[i] = kp;
              keys[p] = ki;
            }
          }
        }
        __syncthreads();
      }
    }
  }
  __syncthreads();

  //    the merged frontier: the first L keys in order
  for (int i = tid; i < L; i += T) {
    const int seq = (int)(uint32_t)keys[i];
    const float d = dist_s[seq];
    const int id = ids_s[seq];
    const uint8_t f = flg_s[seq];
    mf_id[i] = id;
    mf_flag[i] = f;
    selkey[i] = (!(f & 1) && id >= 0) ? d : kInf;
    const size_t r = (size_t)b * L + i;
    ofid[r] = id;
    ofd[r] = d;
    ofpass[r] = (f >> 1) & 1;
  }
  __syncthreads();

  // 5. beam selection by rank under (selkey, slot)
  for (int i = tid; i < L; i += T) {
    const float key = selkey[i];
    int rank = 0;
    for (int j = 0; j < L; ++j) {
      const float kj = selkey[j];
      rank += (kj < key) || (kj == key && j < i);
    }
    const bool selected = rank < W && key < kInf;
    ofexp[(size_t)b * L + i] = (mf_flag[i] & 1) | (selected ? 1 : 0);
    if (selected) {
      sel_id[rank] = mf_id[i];
      sel_flag[rank] = 4 | (mf_flag[i] & 2);
    }
  }
  __syncthreads();

  // 6. per-mode masks of the beam
  for (int w = tid; w < W; w += T) {
    const bool valid = sel_flag[w] & 4;
    const int sid = valid ? sel_id[w] : -1;
    const bool pas = valid && (sel_flag[w] & 2);
    bool fetch, tun = false, res, exact;
    switch (mode) {
      case kUnfiltered: fetch = valid; res = valid; exact = valid; break;
      case kPost: fetch = valid; res = pas; exact = valid; break;
      case kEarly: fetch = valid; res = pas; exact = pas; break;
      case kPreNaive:
        fetch = pas || (sid == entry[b] && valid);
        res = pas;
        exact = fetch;
        break;
      default: fetch = pas; tun = valid && !pas; res = pas; exact = pas; break;
    }
    const size_t r = (size_t)b * W + w;
    osel[r] = sid;
    ovalid[r] = valid;
    ofids[r] = fetch ? sid : -1;
    ofetch[r] = fetch;
    otun[r] = tun;
    ores[r] = res;
    oexact[r] = exact;
  }
}

}  // namespace

extern "C" int fused_round_launch(
    const int* fid, const float* fd, const uint8_t* fexp, const uint8_t* fpass, const int* nid,
    const int* codes, const uint8_t* npass, const float* lut, const int* entry, int* ofid,
    float* ofd, uint8_t* ofexp, uint8_t* ofpass, int* osel, uint8_t* ovalid, int* ofids,
    uint8_t* ofetch, uint8_t* otun, uint8_t* ores, uint8_t* oexact, int B, int L, int M, int C,
    int K, int W, int mode, int by_id, cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  const size_t smem = layout(L, M, C, K, W).total;
  const bool vec = C % 4 == 0 && (uintptr_t)codes % 16 == 0;
  const int lut_async = (C * K) % 4 == 0 && (uintptr_t)lut % 16 == 0;
  auto kernel = vec ? fused_kernel<true> : fused_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<B, kThreads, smem, stream>>>(fid, fd, fexp, fpass, nid, codes, npass, lut, entry, ofid,
                                        ofd, ofexp, ofpass, osel, ovalid, ofids, ofetch, otun,
                                        ores, oexact, L, M, C, K, W, mode, by_id, lut_async);
  return (int)cudaGetLastError();
}
