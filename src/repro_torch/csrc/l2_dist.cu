// Exact squared-L2 distances for Hopper, and the search loop's re-rank.
//
// Replaces the TPU kernel repro/kernels/l2_dist.py::l2_dist (_l2_kernel):
// (B, D) queries against (B, W, D) fetched rows -> (B, W).  Two forms:
//
//   tree = 1  sum of (x - q)^2 by the fixed pairwise tree of the reference's
//             default path (repro/core/search.py::_exact_dist): each level
//             adds neighbouring pairs and carries an odd tail element to the
//             end.  __fsub_rn / __fmul_rn / __fadd_rn keep the compiler from
//             contracting into FMAs, so the result equals the plain PyTorch
//             version bit for bit.
//   tree = 0  the expanded form ||x||^2 - 2 q.x + ||q||^2 of _l2_kernel,
//             held to its plain version within a tolerance (its sums are
//             warp reductions, in another order).
//
// Two entries share one distance function (`row_dist`, one warp a row):
//
//   l2_dist_launch  the distances alone;
//   rerank_launch   the whole of the search loop's stage B for one round
//                   (core/search.py::retire): the distances, the degraded-
//                   record check (a row holding +-inf), and the merge of the
//                   round's W rows into the K-long result list — kill ids
//                   below 0 and repeats of an earlier slot, then the first K
//                   by a stable sort on distance — in one launch.
//
// What bounds it on an H100: at the loop's shapes (B = 256, W = 8, D = 128,
// K = 10) the work is 1.1 MB of rows and a few hundred bytes of results a
// query, well under a microsecond of HBM time; one launch's overhead and
// one chain of dependent latencies (row loads, shuffles, a barrier, the
// merge) are the floor.  So the design keeps each query's round inside one
// block and adds no second pass over the rows:
//   * one warp a row, 16-byte loads; rows the round does not score
//     (result_mask false) are not read at all;
//   * where D is a power of two (4 <= D <= 1024) and the tensors are 16-byte
//     aligned, the pairwise tree is a perfect binary tree: a lane adds its
//     four adjacent squares in registers (two levels) and `__shfl_xor_sync`
//     does the next five (a float add is commutative, so both partners hold
//     the same node); above D = 128 each lane holds one float4 of every
//     128-wide slab and the slabs' roots are added in registers — no
//     shared memory, no warp barrier.  Other D (or unaligned tensors) take
//     two shared-memory buffers a warp, level by level, the odd tail
//     carried as in the plain version;
//   * the +-inf check runs on the values the distance already loaded;
//   * after one block barrier the K + W candidates sit in shared memory:
//     each thread marks its slot dead by scanning the earlier slots' ids,
//     and ranks it by counting the keys (distance, slot) below it, so the
//     output slot is known without a sort.  The distance key is
//     select.cuh's `ord_dist` (-0.0 ties +0.0), with every NaN above +inf,
//     which is the order of torch.sort(stable=True) on float32.
#include <cuda_runtime.h>
#include <stdint.h>

#include "select.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 8;  // the re-rank's block: rows in flight, and its merge's threads
constexpr int kThreads = 32 * kWarps;
// K + W the re-rank takes (rerank_route): its merge counts ranks, O((K + W)^2)
// compares a query; past 1,536 candidates the split route was faster on an
// H100 (scripts/torch_rerank_cap.py, B = 256, W = 8, D = 128)
constexpr int kMaxCandidates = 1536;
constexpr int kMaxSmem = 232448;      // a block's shared memory on Hopper
constexpr float kInf = 3.4e38f;       // the result list's dead-slot distance

// how a row's distance is summed: the expanded form, the tree through
// shared memory, or the tree in registers and shuffles with NV float4s a
// lane (D = 4..128: NV = 1 on D / 4 lanes; D = 128 * NV above)
enum Form { kExpanded = 0, kTreeSmem = 1, kTree1 = 2, kTree2 = 3, kTree4 = 4, kTree8 = 5 };

__device__ __forceinline__ bool is_inf(float v) {
  return (__float_as_uint(v) & 0x7FFFFFFFu) == 0x7F800000u;
}

__device__ __forceinline__ bool any_inf4(const float4& a) {
  return is_inf(a.x) || is_inf(a.y) || is_inf(a.z) || is_inf(a.w);
}

__device__ __forceinline__ float sq_diff(float x, float q) {
  const float d = __fsub_rn(x, q);
  return __fmul_rn(d, d);
}

template <int NV>
__device__ __forceinline__ float tree_shfl(const float* __restrict__ q, const float* __restrict__ x,
                                           int D, int lane, bool& inf) {
  const int used = D >= 128 ? 32 : D / 4;  // lanes holding a float4 of each slab
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* q4 = reinterpret_cast<const float4*>(q);
  float4 xs[NV], qs[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (lane < used) {
      xs[j] = __ldg(x4 + j * 32 + lane);
      qs[j] = __ldg(q4 + j * 32 + lane);
    }
  }
  float v[NV];
  bool bad = false;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    v[j] = 0.0f;
    if (lane < used) {
      const float4 a = xs[j], b = qs[j];
      bad |= any_inf4(a);
      v[j] = __fadd_rn(__fadd_rn(sq_diff(a.x, b.x), sq_diff(a.y, b.y)),
                       __fadd_rn(sq_diff(a.z, b.z), sq_diff(a.w, b.w)));
    }
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    if (off < used) {
#pragma unroll
      for (int j = 0; j < NV; ++j) v[j] = __fadd_rn(v[j], __shfl_xor_sync(kFull, v[j], off));
    }
  }
#pragma unroll
  for (int n = NV; n > 1; n >>= 1) {
#pragma unroll
    for (int i = 0; i < n / 2; ++i) v[i] = __fadd_rn(v[2 * i], v[2 * i + 1]);
  }
  inf = __any_sync(kFull, bad);
  return v[0];
}

// the tree level by level in two shared-memory buffers of D floats (any D)
__device__ __forceinline__ float tree_smem(const float* __restrict__ q, const float* __restrict__ x,
                                           int D, int lane, float* cur, float* nxt, bool& inf) {
  bool bad = false;
  for (int i = lane; i < D; i += 32) {
    const float xv = x[i];
    bad |= is_inf(xv);
    cur[i] = sq_diff(xv, q[i]);
  }
  __syncwarp();
  int n = D;
  while (n > 1) {
    const int pairs = n / 2;
    for (int i = lane; i < pairs; i += 32) nxt[i] = __fadd_rn(cur[2 * i], cur[2 * i + 1]);
    if ((n & 1) && lane == 0) nxt[pairs] = cur[n - 1];
    __syncwarp();
    float* t = cur;
    cur = nxt;
    nxt = t;
    n = pairs + (n & 1);
  }
  const float s = cur[0];
  __syncwarp();  // the buffers serve the warp's next row
  inf = __any_sync(kFull, bad);
  return s;
}

__device__ __forceinline__ float expanded(const float* __restrict__ q, const float* __restrict__ x,
                                          int D, int lane, bool& inf) {
  float xx = 0.0f, qx = 0.0f, qq = 0.0f;
  bool bad = false;
  for (int i = lane; i < D; i += 32) {
    const float xv = x[i], qv = q[i];
    bad |= is_inf(xv);
    xx = __fmaf_rn(xv, xv, xx);
    qx = __fmaf_rn(qv, xv, qx);
    qq = __fmaf_rn(qv, qv, qq);
  }
  for (int off = 16; off > 0; off >>= 1) {
    xx = __fadd_rn(xx, __shfl_xor_sync(kFull, xx, off));
    qx = __fadd_rn(qx, __shfl_xor_sync(kFull, qx, off));
    qq = __fadd_rn(qq, __shfl_xor_sync(kFull, qq, off));
  }
  inf = __any_sync(kFull, bad);
  return __fadd_rn(__fsub_rn(xx, __fmul_rn(2.0f, qx)), qq);
}

// One row's distance, held by lane 0 (by every lane for D >= 128 or the
// shared-memory tree); `inf`, on every lane, says whether the row holds +-inf.  `buf` is the warp's 2 * D floats (kTreeSmem).
__device__ __forceinline__ float row_dist(int form, const float* q, const float* x, int D, int lane,
                                          float* buf, bool& inf) {
  switch (form) {
    case kTree1: return tree_shfl<1>(q, x, D, lane, inf);
    case kTree2: return tree_shfl<2>(q, x, D, lane, inf);
    case kTree4: return tree_shfl<4>(q, x, D, lane, inf);
    case kTree8: return tree_shfl<8>(q, x, D, lane, inf);
    case kTreeSmem: return tree_smem(q, x, D, lane, buf, buf + D, inf);
    default: return expanded(q, x, D, lane, inf);
  }
}

__global__ void l2_kernel(const float* __restrict__ q, const float* __restrict__ x,
                          float* __restrict__ out, int W, int D, int form) {
  extern __shared__ float buf[];
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  for (int w = warp; w < W; w += nwarps) {
    bool inf;
    const size_t row = (size_t)b * W + w;
    const float s = row_dist(form, q + (size_t)b * D, x + row * D, D, lane,
                             buf + (size_t)warp * 2 * D, inf);
    if (lane == 0) out[row] = s;
  }
}

// the distance's sort key: ord_dist, every NaN above +inf
__device__ __forceinline__ uint32_t rank_key(float d) {
  return (__float_as_uint(d) & 0x7FFFFFFFu) > 0x7F800000u ? 0xFFFFFFFFu : sel::ord_dist(d);
}

__global__ void __launch_bounds__(kThreads)
rerank_kernel(const float* __restrict__ q, const float* __restrict__ x,
              const int* __restrict__ sel_ids, const unsigned char* __restrict__ result_mask,
              const int* __restrict__ res_ids, const float* __restrict__ res_dists,
              const int* __restrict__ nd_in, int* __restrict__ out_ids,
              float* __restrict__ out_dists, int* __restrict__ nd_out, int W, int D, int K,
              int form) {
  extern __shared__ int smem[];
  const int n = K + W;
  int* s_id = smem;                                     // candidate ids: [res ; new]
  float* s_d = reinterpret_cast<float*>(s_id + n);      // their distances
  uint32_t* s_key = reinterpret_cast<uint32_t*>(s_d + n);
  int* s_oid = reinterpret_cast<int*>(s_key + n);       // after the kill
  float* s_od = reinterpret_cast<float*>(s_oid + n);
  int* s_deg = reinterpret_cast<int*>(s_od + n);        // W degraded flags
  float* rowbuf = reinterpret_cast<float*>(s_deg + W);  // kTreeSmem: 2 * D floats a row warp
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the result list into slots [0, K); its loads overlap the rows'
  for (int s = tid; s < K; s += kThreads) {
    s_id[s] = res_ids[(size_t)b * K + s];
    s_d[s] = res_dists[(size_t)b * K + s];
  }
  // the round's rows into slots [K, K + W), one warp a row; a row outside
  // the result mask is not read: it enters as (-1, INF)
  for (int w = warp; w < W; w += kWarps) {
    const size_t row = (size_t)b * W + w;
    int out_id = -1;
    float out_d = kInf;
    bool deg = false;
    if (result_mask[row] != 0) {
      const float d = row_dist(form, q + (size_t)b * D, x + row * D, D, lane,
                               rowbuf + (size_t)warp * 2 * D, deg);
      if (!deg) {
        out_id = sel_ids[row];
        out_d = d;
      }
    }
    if (lane == 0) {
      s_id[K + w] = out_id;
      s_d[K + w] = out_d;
      s_deg[w] = deg;
    }
  }
  __syncthreads();

  // the kill: an id below 0 or a repeat of an earlier slot's id is dead
  // (INF); a distance >= INF leaves the slot without an id
  for (int s = tid; s < n; s += kThreads) {
    const int id = s_id[s];
    bool dead = id < 0;
    for (int t = 0; t < s && !dead; ++t) dead = s_id[t] == id;
    const float d = dead ? kInf : s_d[s];
    s_oid[s] = d >= kInf ? -1 : id;
    s_od[s] = d;
    s_key[s] = rank_key(d);
  }
  if (warp == 0) {
    int c = 0;
    for (int w = lane; w < W; w += 32) c += s_deg[w];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(kFull, c, off);
    if (lane == 0) nd_out[b] = nd_in[b] + c;
  }
  __syncthreads();

  // rank = the keys (distance, slot) below this one: its place in a stable sort
  for (int s = tid; s < n; s += kThreads) {
    const uint32_t key = s_key[s];
    int rank = 0;
    for (int t = 0; t < n; ++t) {
      const uint32_t kt = s_key[t];
      rank += kt < key || (kt == key && t < s);
    }
    if (rank < K) {
      out_ids[(size_t)b * K + rank] = s_oid[s];
      out_dists[(size_t)b * K + rank] = s_od[s];
    }
  }
}

// the tree's form for these tensors: shuffles where D is a power of two in
// [4, 1024] and both tensors are 16-byte aligned, else shared memory
int tree_form(const float* q, const float* x, int D) {
  const bool aligned = (reinterpret_cast<uintptr_t>(q) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  if (!aligned || D < 4 || D > 1024 || (D & (D - 1)) != 0) return kTreeSmem;
  return D <= 128 ? kTree1 : D == 256 ? kTree2 : D == 512 ? kTree4 : kTree8;
}

// the re-rank's shared memory: 5 * (K + W) + W words of merge state, and
// for the tree through shared memory 2 * D floats for each warp that
// holds a row (min(W, kWarps))
size_t rerank_smem(int K, int W, int D, int form) {
  const int row_warps = W < kWarps ? W : kWarps;
  return (size_t)(5 * (K + W) + W) * 4 +
         (form == kTreeSmem ? (size_t)row_warps * 2 * D * sizeof(float) : 0);
}

cudaError_t reserve_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" int l2_dist_launch(const float* q, const float* x, float* out, int B, int W, int D,
                              int tree, cudaStream_t stream) {
  if (B == 0 || W == 0) return (int)cudaSuccess;
  const int nwarps = W < kWarps ? W : kWarps;
  const int form = tree ? tree_form(q, x, D) : kExpanded;
  const size_t smem = form == kTreeSmem ? (size_t)nwarps * 2 * D * sizeof(float) : 0;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = reserve_smem((const void*)l2_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  l2_kernel<<<B, nwarps * 32, smem, stream>>>(q, x, out, W, D, form);
  return (int)cudaGetLastError();
}

// Shape rule (kernels/l2_dist.py::rerank_route asks it before any launch):
// 0 = the re-rank kernel takes K result slots, W rows and D — at most
// kMaxCandidates candidates, and its shared memory fits a block, the tree
// charged at its shared-memory form, since which form a call takes also
// depends on the tensors' alignment; 1 = the standalone l2_kernel and the
// plain merge.
extern "C" int rerank_route(int K, int W, int D, int tree) {
  const bool fits = K + W <= kMaxCandidates &&
                    rerank_smem(K, W, D, tree ? kTreeSmem : kExpanded) <= (size_t)kMaxSmem;
  return fits ? 0 : 1;
}

extern "C" int rerank_launch(const float* q, const float* x, const int* sel_ids,
                             const unsigned char* result_mask, const int* res_ids,
                             const float* res_dists, const int* nd_in, int* out_ids,
                             float* out_dists, int* nd_out, int B, int W, int D, int K, int tree,
                             cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  if (rerank_route(K, W, D, tree) != 0) return (int)cudaErrorInvalidValue;
  const int form = tree ? tree_form(q, x, D) : kExpanded;
  const size_t smem = rerank_smem(K, W, D, form);
  cudaError_t e = reserve_smem((const void*)rerank_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  rerank_kernel<<<B, kThreads, smem, stream>>>(q, x, sel_ids, result_mask, res_ids, res_dists,
                                               nd_in, out_ids, out_dists, nd_out, W, D, K, form);
  return (int)cudaGetLastError();
}
