// Sorted top-k on the lexicographic (dist, id) key, for Hopper.
//
// Replaces the TPU kernel repro/kernels/topk_merge.py::topk_merge
// (_bitonic_kernel).  The contract is the TPU kernel's: each row of
// (dist, id) pairs is padded to P = the next power of two >= M with
// (3.4e38, 0x7FFFFFFF), sorted ascending by (dist, id), and the first
// k_out = min(k, P) entries are written, pad ids as -1.  The plain PyTorch
// version (repro_torch/kernels/topk_merge.py) computes it with two stable
// sorts, so keys equal as (dist, id) keep their input order; the kernel
// breaks those ties by position in the row, which makes the key total
// (it matters only for -0.0 against +0.0 under one id, which compare
// equal but differ in their bits).  Pads are never materialised: the first
// min(k_out, M) real keys are selected, and the P - M pads are written
// between the real keys at most 3.4e38 and those above it, where the total
// key puts them.
//
// Three routes, chosen by shape in the library (topk_merge_route, which
// the Python wrapper asks too; not a fallback on failure).  Measured on
// an H100 over B in 64..64,000 and M in 768..10,000 (PERF.md, PR 13): the
// warp route wins only once its warps fill the SMs many times over, the
// block route below that and for any k_out up to 64:
//
//   k_out <= 32 and B * (warps a row) >= 24 per SM: one warp a row.  The
//     warp keeps the row's running first k keys in registers, one a lane,
//     sorted across its lanes (sel::WarpList<1>), and streams the row in
//     16-byte loads (4-byte loads when M % 4 != 0), 128 keys a step.  A
//     key whose distance is above the current k-th distance dies at once;
//     its id is loaded only when a distance of its 16 bytes could survive.
//     Survivors go into the list by warp shuffles, one at a time or, while
//     the list fills, a row of 32 at once (sel::insert_survivors); no block
//     barrier.  For random rows about k * (1 + ln(M / k)) keys are
//     inserted, so once the list has filled almost every step is a load, a
//     compare and a ballot.  Rows of up to 2,048 keys take one warp each,
//     eight rows to a block; a wider row takes ceil(M / 1024) warps
//     (at most 32), whose lists merge once in shared memory.  What bounds
//     it: the instructions of that loop and of the insertions, not the
//     bytes (PERF.md has the ratio to the bytes the function must read);
//     with few rows, one warp's chain of dependent insertions.
//
//   k_out <= 64 otherwise: one block a row.  The row's M 64-bit keys
//     (ord(dist), id) go to shared memory, a block radix select finds the
//     k-th key a byte a pass, stopping once a byte settles it
//     (sel::block_select; ties with the k-th key are taken in position
//     order), and one warp sorts the k chosen keys with their positions
//     (sel::WarpList<2>::merge32, twice).  What bounds it: the passes'
//     barriers and the warp sort, some ten thousand cycles a row, so it
//     serves few rows (and k above 32, where a warp list of two keys a
//     lane inserts too slowly) better than many.
//
//   k_out > 64: the bitonic network of the TPU kernel, one block per row
//     with the padded row in shared memory (12 * P bytes with the
//     positions, so P <= 16384), 55 barrier-separated steps at P = 1024.
//     Bound by the network's depth, not by bytes; it serves wide k only.
#include <cuda_runtime.h>
#include <stdint.h>

#include "select.cuh"

namespace {

constexpr float kPadDist = 3.4e38f;
constexpr int kPadId = 0x7FFFFFFF;
enum Route { kWarpRoute = 0, kBlockRoute = 1, kNetworkRoute = 2 };
constexpr int kWarpMax = 32;          // widest k_out of the warp route (a key a lane)
constexpr int kBlockMax = 64;         // widest k_out of the block route (a warp sorts them)
constexpr int kBlockThreads = 256;
constexpr int kWarpRowMax = 2048;     // rows up to this width take one warp
constexpr int kRowsPerBlock = 8;      // such rows a block
constexpr int kKeysPerWarp = 1024;    // wider rows: one warp per this many keys
constexpr int kMaxWarpsPerRow = 32;
constexpr int kWarpRouteWarpsPerSM = 24;  // the warp route's warps must reach this many an SM

using sel::KeyPos;

// Write a row's k_out outputs from `list`, which holds the row's first k
// real keys sorted: those at most 3.4e38, then the P - M pads, then the
// rest.  Every lane of the warp calls it.
template <int Q>
__device__ __forceinline__ void write_row(const sel::WarpList<Q>& list, const float* d,
                                          float* od, int* oi, int k, int k_out, int M, int P,
                                          int lane) {
  const uint32_t pad_hi = sel::ord_dist(kPadDist);
  int c = 0;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = q * 32 + lane;
    c += __popc(__ballot_sync(sel::kFull, i < k && (uint32_t)(list.e[q].k >> 32) <= pad_hi));
  }
  const int npad = P - M;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int i = q * 32 + lane;
    const int j = i < c ? i : i + npad;
    if (i < k && j < k_out) {
      od[j] = d[list.e[q].p];  // the input's bits: -0.0 stays -0.0
      const int idv = (int)((uint32_t)list.e[q].k ^ 0x80000000u);
      oi[j] = idv == kPadId ? -1 : idv;
    }
  }
  const int pad_end = c + npad < k_out ? c + npad : k_out;
  for (int j = c + lane; j < pad_end; j += 32) {
    od[j] = kPadDist;
    oi[j] = -1;
  }
}

// The warp route: one row per warp (wpr == 1, blockDim.x / 32 rows a
// block) or one row per block of wpr warps.
template <bool VEC>
__global__ void warp_topk_kernel(const float* __restrict__ dists, const int* __restrict__ ids,
                                 float* __restrict__ out_d, int* __restrict__ out_i, int B, int M,
                                 int P, int k_out, int wpr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row = wpr == 1 ? (size_t)blockIdx.x * (blockDim.x >> 5) + warp : blockIdx.x;
  const int part = wpr == 1 ? 0 : warp;
  if (row >= (size_t)B) return;  // wpr == 1 only: such blocks have no barrier
  const int k = k_out < M ? k_out : M;  // real keys needed
  const float* d = dists + row * M;
  const int* id = ids + row * M;

  sel::WarpList<1> list;
  list.clear();
  KeyPos kth = sel::key_max();
  if (k > 0) {
    for (int base = part * 128; base < M; base += wpr * 128) {
      KeyPos cand[4] = {sel::key_max(), sel::key_max(), sel::key_max(), sel::key_max()};
      unsigned live = 0;
      const uint32_t kth_hi = (uint32_t)(kth.k >> 32);
      if (VEC) {
        const int p0 = base + lane * 4;  // M % 4 == 0: p0 < M covers all four
        if (p0 < M) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(d + p0));
          const uint32_t hi[4] = {sel::ord_dist(v.x), sel::ord_dist(v.y), sel::ord_dist(v.z),
                                  sel::ord_dist(v.w)};
          if (hi[0] <= kth_hi || hi[1] <= kth_hi || hi[2] <= kth_hi || hi[3] <= kth_hi) {
            const int4 iv = __ldg(reinterpret_cast<const int4*>(id + p0));
            const int idv[4] = {iv.x, iv.y, iv.z, iv.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              cand[j] = KeyPos{((unsigned long long)hi[j] << 32) | sel::ord_id(idv[j]),
                               (uint32_t)(p0 + j)};
              if (sel::less(cand[j], kth)) live |= 1u << j;
            }
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = base + j * 32 + lane;
          if (p < M) {
            const uint32_t hi = sel::ord_dist(__ldg(d + p));
            if (hi <= kth_hi) {
              cand[j] = KeyPos{((unsigned long long)hi << 32) | sel::ord_id(__ldg(id + p)),
                               (uint32_t)p};
              if (sel::less(cand[j], kth)) live |= 1u << j;
            }
          }
        }
      }
      sel::insert_survivors(list, cand, live, kth, k, lane);
    }
  }

  if (wpr > 1) {  // the row's other warps hand their lists to warp 0
    KeyPos* parts = reinterpret_cast<KeyPos*>(smem);
    if (warp > 0) parts[(warp - 1) * 32 + lane] = list.e[0];
    __syncthreads();
    if (warp > 0) return;
    for (int w = 1; w < wpr && k > 0; ++w) {
      KeyPos cand[1] = {parts[(w - 1) * 32 + lane]};
      const unsigned live = sel::less(cand[0], kth) ? 1u : 0u;
      sel::insert_survivors(list, cand, live, kth, k, lane);
    }
  }
  write_row(list, d, out_d + row * k_out, out_i + row * k_out, k, k_out, M, P, lane);
}

// The block route: one row per block of kBlockThreads; M 64-bit keys, the
// radix histograms and the (at most kBlockMax) chosen keys in shared memory.
__global__ void __launch_bounds__(kBlockThreads) block_topk_kernel(
    const float* __restrict__ dists, const int* __restrict__ ids, float* __restrict__ out_d,
    int* __restrict__ out_i, int M, int P, int k_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  KeyPos* chosen = reinterpret_cast<KeyPos*>(smem);
  int* hist = reinterpret_cast<int*>(chosen + kBlockMax);
  int* state = hist + 8 * 256;
  unsigned long long* key_s = reinterpret_cast<unsigned long long*>(state + 4);
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t row = blockIdx.x;
  const int k = k_out < M ? k_out : M;
  const float* d = dists + row * M;
  const int* id = ids + row * M;
  for (int s = tid; s < M; s += kBlockThreads)
    key_s[s] = ((unsigned long long)sel::ord_dist(d[s]) << 32) | sel::ord_id(id[s]);
  for (int i = tid; i < 8 * 256; i += kBlockThreads) hist[i] = 0;
  if (tid == 0) state[3] = 0;
  __syncthreads();
  auto key_of = [&](int s) { return key_s[s]; };
  sel::block_select<unsigned long long>(key_of, M, k, hist, state, [&](int at, int s) {
    chosen[at] = KeyPos{key_s[s], (uint32_t)s};
  });
  __syncthreads();
  if (tid >= 32) return;
  sel::WarpList<2> list;
  list.clear();
  list.merge32(lane < k ? chosen[lane] : sel::key_max(), lane);
  if (k > 32) list.merge32(lane + 32 < k ? chosen[lane + 32] : sel::key_max(), lane);
  write_row(list, d, out_d + row * k_out, out_i + row * k_out, k, k_out, M, P, lane);
}

// the network route: keys (dist, id, position), a total order
__device__ __forceinline__ bool key_lt(float d, int id, int p, float pd, int pid, int pp) {
  return d < pd || (d == pd && (id < pid || (id == pid && p < pp)));
}

__global__ void bitonic_topk_kernel(const float* __restrict__ dists, const int* __restrict__ ids,
                                    float* __restrict__ out_d, int* __restrict__ out_i, int M,
                                    int P, int k_out) {
  extern __shared__ unsigned char smem[];
  float* sd = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(sd + P);
  int* sp = si + P;
  const size_t row = blockIdx.x;
  for (int t = threadIdx.x; t < P; t += blockDim.x) {
    const bool real = t < M;
    sd[t] = real ? dists[row * M + t] : kPadDist;
    si[t] = real ? ids[row * M + t] : kPadId;
    sp[t] = t;
  }
  __syncthreads();

  for (int block = 2; block <= P; block <<= 1) {
    for (int j = block >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < P / 2; t += blockDim.x) {
        // pair t: the lower element has bit j clear, the upper one set
        const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int hi = lo | j;
        const float dl = sd[lo], dh = sd[hi];
        const int il = si[lo], ih = si[hi], pl = sp[lo], ph = sp[hi];
        const bool asc = (lo & block) == 0;
        if (key_lt(dl, il, pl, dh, ih, ph) != asc) {
          sd[lo] = dh;
          si[lo] = ih;
          sp[lo] = ph;
          sd[hi] = dl;
          si[hi] = il;
          sp[hi] = pl;
        }
      }
      __syncthreads();
    }
  }

  for (int t = threadIdx.x; t < k_out; t += blockDim.x) {
    out_d[row * k_out + t] = sd[t];
    const int id = si[t];
    out_i[row * k_out + t] = id == kPadId ? -1 : id;
  }
}

// a kernel's dynamic shared memory, opted into above the default 48 KB
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// warps the warp route gives a row of M keys
int warps_per_row(int M) {
  if (M <= kWarpRowMax) return 1;
  const int wpr = (M + kKeysPerWarp - 1) / kKeysPerWarp;
  return wpr < kMaxWarpsPerRow ? wpr : kMaxWarpsPerRow;
}

cudaError_t sm_count(int& sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

int route_for(int B, int M, int k_out, int sms) {
  if (k_out > kBlockMax) return kNetworkRoute;
  if (k_out <= kWarpMax && (long long)B * warps_per_row(M) >= (long long)kWarpRouteWarpsPerSM * sms)
    return kWarpRoute;
  return kBlockRoute;
}

template <bool VEC>
int launch_warp(const float* dists, const int* ids, float* out_d, int* out_i, int B, int M, int P,
                int k_out, cudaStream_t stream) {
  const int wpr = warps_per_row(M);
  const int threads = wpr == 1 ? 32 * kRowsPerBlock : 32 * wpr;
  const int blocks = wpr == 1 ? (B + kRowsPerBlock - 1) / kRowsPerBlock : B;
  const size_t smem = wpr == 1 ? 0 : (size_t)(wpr - 1) * 32 * sizeof(KeyPos);
  warp_topk_kernel<VEC><<<blocks, threads, smem, stream>>>(dists, ids, out_d, out_i, B, M, P,
                                                           k_out, wpr);
  return (int)cudaGetLastError();
}

}  // namespace

// The route for B rows of M keys and an output width k_out = min(k, P) on
// the current device: 0 warp, 1 block, 2 network; -1 if the device cannot
// be queried.
extern "C" int topk_merge_route(int B, int M, int k_out) {
  int sms = 0;
  return sm_count(sms) == cudaSuccess ? route_for(B, M, k_out, sms) : -1;
}

// dists, ids (B, M); out_d, out_i (B, k_out) with k_out = min(k, P).
extern "C" int topk_merge_launch(const float* dists, const int* ids, float* out_d, int* out_i,
                                 int B, int M, int P, int k_out, cudaStream_t stream) {
  if (B == 0 || k_out == 0) return (int)cudaSuccess;
  int sms = 0;
  const cudaError_t qe = sm_count(sms);
  if (qe != cudaSuccess) return (int)qe;
  const int route = route_for(B, M, k_out, sms);
  if (route == kWarpRoute) {
    const bool vec = M % 4 == 0 && ((uintptr_t)dists % 16 == 0) && ((uintptr_t)ids % 16 == 0);
    return vec ? launch_warp<true>(dists, ids, out_d, out_i, B, M, P, k_out, stream)
               : launch_warp<false>(dists, ids, out_d, out_i, B, M, P, k_out, stream);
  }
  if (route == kBlockRoute) {
    const size_t smem = kBlockMax * sizeof(KeyPos) + (8 * 256 + 4) * sizeof(int) +
                        (size_t)M * sizeof(unsigned long long);
    const cudaError_t e = allow_smem(block_topk_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    block_topk_kernel<<<B, kBlockThreads, smem, stream>>>(dists, ids, out_d, out_i, M, P, k_out);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)P * (sizeof(float) + 2 * sizeof(int));
  const cudaError_t e = allow_smem(bitonic_topk_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  int threads = P / 2;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  bitonic_topk_kernel<<<B, threads, smem, stream>>>(dists, ids, out_d, out_i, M, P, k_out);
  return (int)cudaGetLastError();
}
