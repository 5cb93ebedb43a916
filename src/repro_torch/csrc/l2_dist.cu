// Exact squared-L2 re-ranking distances for Hopper.
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
// What bounds it on an H100: bytes — every fetched row is read once (D*4
// bytes) for 3 flops per element.  One block per query, one warp per row:
// the lanes read a row's D floats with neighbouring lanes on neighbouring
// addresses, and the tree levels run in two shared-memory buffers per warp.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 8;

__global__ void l2_kernel(const float* __restrict__ q, const float* __restrict__ x,
                          float* __restrict__ out, int W, int D, int tree) {
  extern __shared__ float buf[];
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  const float* qb = q + (size_t)b * D;
  float* a = buf + (size_t)warp * 2 * D;
  float* n_ = a + D;
  for (int w = warp; w < W; w += nwarps) {
    const float* xr = x + ((size_t)b * W + w) * D;
    if (tree) {
      float* cur = a;
      float* nxt = n_;
      for (int i = lane; i < D; i += 32) {
        const float d = __fsub_rn(xr[i], qb[i]);
        cur[i] = __fmul_rn(d, d);
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
      if (lane == 0) out[(size_t)b * W + w] = cur[0];
      __syncwarp();
    } else {
      float xx = 0.0f, qx = 0.0f, qq = 0.0f;
      for (int i = lane; i < D; i += 32) {
        const float xv = xr[i], qv = qb[i];
        xx = __fmaf_rn(xv, xv, xx);
        qx = __fmaf_rn(qv, xv, qx);
        qq = __fmaf_rn(qv, qv, qq);
      }
      for (int off = 16; off > 0; off >>= 1) {
        xx += __shfl_xor_sync(0xffffffffu, xx, off);
        qx += __shfl_xor_sync(0xffffffffu, qx, off);
        qq += __shfl_xor_sync(0xffffffffu, qq, off);
      }
      if (lane == 0) out[(size_t)b * W + w] = (xx - 2.0f * qx) + qq;
    }
  }
}

}  // namespace

extern "C" int l2_dist_launch(const float* q, const float* x, float* out, int B, int W, int D,
                              int tree, cudaStream_t stream) {
  if (B == 0 || W == 0) return (int)cudaSuccess;
  const int nwarps = W < kMaxWarps ? W : kMaxWarps;
  const size_t smem = tree ? (size_t)nwarps * 2 * D * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(l2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  l2_kernel<<<B, nwarps * 32, smem, stream>>>(q, x, out, W, D, tree);
  return (int)cudaGetLastError();
}
