// Sorted top-k on the lexicographic (dist, id) key, for Hopper.
//
// Replaces the TPU kernel repro/kernels/topk_merge.py::topk_merge
// (_bitonic_kernel): a bitonic sorting network over one row's (dist, id)
// pairs, padded to P = the next power of two >= M with (3.4e38,
// 0x7FFFFFFF), of which the first min(k, P) are written and pad ids come
// back as -1.
//
// What bounds it on an H100: neither bytes nor operations at these sizes,
// but the network's depth.  A row moves 8*M bytes in and 8*min(k, P) out,
// and does P/2 * log2(P) * (log2(P) + 1) / 2 compare-exchanges; the
// log2(P) * (log2(P) + 1) / 2 steps (55 at P = 1024) each end in a block
// barrier.  The design keeps the whole row in shared memory (8*P bytes,
// so P <= 16384 fits the block's 227 KB; the wrapper refuses a larger P),
// one block per row, each thread exchanging one pair per step.
//
// The network is the reference's, step for step: the same stages, the
// same "self < partner" compare lt = d < pd || (d == pd && id <= pid), the
// same keep-self rule for the lower and the upper element of a pair.  So
// kernel and reference give the same rows; on keys without NaN that is
// the unique sorted order, which the plain PyTorch version
// (repro_torch/kernels/topk_merge.py) computes with two stable sorts.
#include <cuda_runtime.h>

namespace {

constexpr float kPadDist = 3.4e38f;
constexpr int kPadId = 0x7FFFFFFF;

__device__ __forceinline__ bool key_le(float d, int id, float pd, int pid) {
  return d < pd || (d == pd && id <= pid);
}

__global__ void bitonic_topk_kernel(const float* __restrict__ dists, const int* __restrict__ ids,
                                    float* __restrict__ out_d, int* __restrict__ out_i, int M,
                                    int P, int k_out) {
  extern __shared__ unsigned char smem[];
  float* sd = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(sd + P);
  const size_t row = blockIdx.x;
  for (int t = threadIdx.x; t < P; t += blockDim.x) {
    const bool real = t < M;
    sd[t] = real ? dists[row * M + t] : kPadDist;
    si[t] = real ? ids[row * M + t] : kPadId;
  }
  __syncthreads();

  for (int block = 2; block <= P; block <<= 1) {
    for (int j = block >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < P / 2; t += blockDim.x) {
        // pair t: the lower element has bit j clear, the upper one set
        const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int hi = lo | j;
        const float dl = sd[lo], dh = sd[hi];
        const int il = si[lo], ih = si[hi];
        const bool asc = (lo & block) == 0;
        const bool lt_lo = key_le(dl, il, dh, ih);
        const bool lt_hi = key_le(dh, ih, dl, il);
        const bool keep_lo = asc ? lt_lo : !lt_lo;
        const bool keep_hi = asc ? !lt_hi : lt_hi;
        sd[lo] = keep_lo ? dl : dh;
        si[lo] = keep_lo ? il : ih;
        sd[hi] = keep_hi ? dh : dl;
        si[hi] = keep_hi ? ih : il;
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

}  // namespace

// dists, ids (B, M); out_d, out_i (B, k_out) with k_out = min(k, P).
extern "C" int topk_merge_launch(const float* dists, const int* ids, float* out_d, int* out_i,
                                 int B, int M, int P, int k_out, cudaStream_t stream) {
  if (B == 0 || k_out == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)P * (sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(bitonic_topk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = P / 2;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  bitonic_topk_kernel<<<B, threads, smem, stream>>>(dists, ids, out_d, out_i, M, P, k_out);
  return (int)cudaGetLastError();
}
