// One fused stage-A traversal round per query, for Hopper.
//
// Replaces the TPU kernel repro/kernels/fused_traversal.py::
// fused_traversal_round (_fused_kernel, _adc, _bitonic_merge, mode_masks).
// One block per query runs, in order:
//   1. ADC of the M new candidates: sum over c = 0..C-1, left to right,
//      with __fadd_rn from 0.0f against the query's LUT in shared memory —
//      the order of the ADC kernel (pq_lookup.cu) and the plain versions;
//   2. the kill mask: a slot dies if an EARLIER slot holds the same
//      non-negative id, or if its own id is < 0; dead slots become
//      (+INF, -1), as frontier.insert does;
//   3. a bitonic sort of the padded [frontier | candidates] on the key
//      (dist, seq), seq = the slot number.  The key is a total order, so
//      the network reproduces the stable ascending sort exactly; ids and
//      the expanded / filter-pass flags are looked up by seq afterwards.
//      Pads are (+INF, -1, expanded, fails) with seq past every real slot;
//   4. beam selection: the rank of each of the first L slots under the
//      key (selkey, slot), selkey = dist for unexpanded valid slots else
//      +INF; the `width` lowest finite ranks are the beam, in rank order,
//      and are marked expanded;
//   5. the per-mode fetch / tunnel / result / exact masks of the beam.
// M = 0 (the round-0 call) merges nothing and only selects.
//
// What bounds it on an H100: the per-block work, not bytes.  A query's
// inputs are small (its LUT, L frontier slots, M ids and their code rows);
// the kill mask compares each slot with every earlier one (O(P^2) shared
// memory reads, broadcast across a warp) and the sort is O(P log^2 P)
// compare-exchanges with a block barrier per step.  Everything for a query
// stays in shared memory for the whole round — the only device-memory
// traffic is one read of the inputs and one write of the outputs; at
// P = next_pow2(L + M) = 4096 the sort and the LUT need more than 48 KB, so
// the launch opts in to large dynamic shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.4e38f;
constexpr int kThreads = 256;
enum Mode { kGate = 0, kPost = 1, kEarly = 2, kPreNaive = 3, kUnfiltered = 4 };

__host__ __device__ inline size_t align4(size_t n) { return (n + 3) & ~(size_t)3; }

struct Layout {
  size_t lut, key_d, key_s, ids, flags, mf_id, mf_flag, selkey, sel_id, sel_flag, total;
};

__host__ __device__ inline Layout layout(int L, int M, int C, int K, int W, int P) {
  Layout s;
  size_t off = 0;
  s.lut = off;      off += M ? (size_t)C * K * 4 : 0;
  s.key_d = off;    off += (size_t)P * 4;
  s.key_s = off;    off += (size_t)P * 4;
  s.ids = off;      off += (size_t)P * 4;
  s.flags = off;    off += align4(P);
  s.mf_id = off;    off += (size_t)L * 4;
  s.selkey = off;   off += (size_t)L * 4;
  s.sel_id = off;   off += (size_t)W * 4;
  s.mf_flag = off;  off += align4(L);
  s.sel_flag = off; off += align4(W);
  s.total = off;
  return s;
}

// flags: bit 0 = expanded, bit 1 = passes the filter; sel_flag adds bit 2 = valid
__global__ void fused_kernel(
    const int* __restrict__ fid, const float* __restrict__ fd, const uint8_t* __restrict__ fexp,
    const uint8_t* __restrict__ fpass, const int* __restrict__ nid, const int* __restrict__ codes,
    const uint8_t* __restrict__ npass, const float* __restrict__ lut, const int* __restrict__ entry,
    int* __restrict__ ofid, float* __restrict__ ofd, uint8_t* __restrict__ ofexp,
    uint8_t* __restrict__ ofpass, int* __restrict__ osel, uint8_t* __restrict__ ovalid,
    int* __restrict__ ofids, uint8_t* __restrict__ ofetch, uint8_t* __restrict__ otun,
    uint8_t* __restrict__ ores, uint8_t* __restrict__ oexact,
    int L, int M, int C, int K, int W, int P, int mode, int by_id) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(L, M, C, K, W, P);
  float* lut_s = reinterpret_cast<float*>(smem + lay.lut);
  float* key_d = reinterpret_cast<float*>(smem + lay.key_d);
  int* key_s = reinterpret_cast<int*>(smem + lay.key_s);
  int* ids_s = reinterpret_cast<int*>(smem + lay.ids);
  uint8_t* flg_s = smem + lay.flags;
  int* mf_id = reinterpret_cast<int*>(smem + lay.mf_id);
  uint8_t* mf_flag = smem + lay.mf_flag;
  float* selkey = reinterpret_cast<float*>(smem + lay.selkey);
  int* sel_id = reinterpret_cast<int*>(smem + lay.sel_id);
  uint8_t* sel_flag = smem + lay.sel_flag;

  const int b = blockIdx.x, tid = threadIdx.x, T = blockDim.x;
  const int total = L + M;

  if (M) {
    const float* lut_b = lut + (size_t)b * C * K;
    for (int i = tid; i < C * K; i += T) lut_s[i] = lut_b[i];
  }
  for (int w = tid; w < W; w += T) sel_flag[w] = 0;
  __syncthreads();

  // 1. slots: frontier, then candidates with their ADC, then pads
  for (int s = tid; s < P; s += T) {
    int id;
    float d;
    uint8_t f;
    if (s < L) {
      const size_t r = (size_t)b * L + s;
      id = fid[r];
      d = fd[r];
      f = (fexp[r] ? 1 : 0) | (fpass[r] ? 2 : 0);
    } else if (s < total) {
      const size_t r = (size_t)b * M + (s - L);
      id = nid[r];
      f = npass[r] ? 2 : 0;
      d = kInf;
      if (id >= 0) {
        const int* code = by_id ? codes + (size_t)id * C : codes + r * C;
        float acc = 0.0f;
        for (int c = 0; c < C; ++c) acc = __fadd_rn(acc, lut_s[c * K + code[c]]);
        d = acc;
      }
    } else {
      id = -1;
      d = kInf;
      f = 1;
    }
    ids_s[s] = id;
    key_d[s] = d;
    key_s[s] = s;
    flg_s[s] = f;
  }
  __syncthreads();

  // 2. kill mask (reads ids only, writes dists only), then dead ids -> -1
  for (int s = tid; s < total; s += T) {
    const int id = ids_s[s];
    bool dead = id < 0;
    for (int t = 0; t < s && !dead; ++t) dead = ids_s[t] == id;
    if (dead) key_d[s] = kInf;
  }
  __syncthreads();
  for (int s = tid; s < total; s += T)
    if (key_d[s] >= kInf) ids_s[s] = -1;
  __syncthreads();

  // 3. bitonic sort on (dist, seq), ascending
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < P; i += T) {
        const int p = i ^ j;
        if (p > i) {
          const float di = key_d[i], dp = key_d[p];
          const int si = key_s[i], sp = key_s[p];
          const bool i_after = (di > dp) || (di == dp && si > sp);
          if (((i & k) == 0) == i_after) {
            key_d[i] = dp;
            key_d[p] = di;
            key_s[i] = sp;
            key_s[p] = si;
          }
        }
      }
      __syncthreads();
    }
  }

  // the merged frontier: the first L sorted slots
  for (int i = tid; i < L; i += T) {
    const int seq = key_s[i];
    const float d = key_d[i];
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

  // 4. beam selection by rank under (selkey, slot)
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

  // 5. per-mode masks of the beam
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
  int P = 1;
  while (P < L + M) P <<= 1;
  const size_t smem = layout(L, M, C, K, W, P).total;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_kernel<<<B, kThreads, smem, stream>>>(fid, fd, fexp, fpass, nid, codes, npass, lut, entry,
                                              ofid, ofd, ofexp, ofpass, osel, ovalid, ofids,
                                              ofetch, otun, ores, oexact, L, M, C, K, W, P, mode,
                                              by_id);
  return (int)cudaGetLastError();
}
