// PQ asymmetric-distance computation (ADC) for Hopper.
//
// Replaces the TPU kernel repro/kernels/pq_lookup.py::pq_lookup_gathered
// (_adc_kernel / _adc_body), which computes out[b, m] = sum_c lut[b, c,
// codes[b, m, c]] as a one-hot x LUT matrix product on the MXU.  Here the
// same sum is a gather from a LUT held in shared memory.
//
// What bounds it on an H100: bytes.  Per query it reads its C*K*4-byte LUT
// once (32 KB at C = 32, K = 256), the row ids and the C code words of
// every row, and writes one float per row; there are C adds per row, far
// below the card's float rate.  The design keeps the LUT in shared memory
// (one block per (query, tile of rows), so each query's LUT crosses from
// L2 once per tile) and, in the search loop's entry, folds the gather
// codes[max(id, 0)] into the kernel, so the (B, M, C) gathered copy of the
// code rows is never written to device memory.
//
// Summation order: each thread owns one row and adds c = 0..C-1 left to
// right with __fadd_rn from 0.0f, exactly the order of the plain PyTorch
// version (repro_torch/kernels/pq_lookup.py) and of the fused round's ADC,
// so all three agree bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr float kInf = 3.4e38f;
constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 1024;

// by_id = 0: codes is (B, M, C), row (b, m) at codes[(b*M + m)*C].
// by_id = 1: codes is the (N, C) table, row (b, m) at codes[ids[b*M+m]*C];
//            ids < 0 give +INF and read no codes.
__global__ void adc_kernel(const float* __restrict__ lut, const int* __restrict__ codes,
                           const int* __restrict__ ids, float* __restrict__ out,
                           int M, int C, int K, int by_id) {
  extern __shared__ float lut_s[];
  const int b = blockIdx.y;
  const float* lut_b = lut + (size_t)b * C * K;
  for (int i = threadIdx.x; i < C * K; i += blockDim.x) lut_s[i] = lut_b[i];
  __syncthreads();

  const int m_end = min(M, (int)(blockIdx.x + 1) * kRowsPerBlock);
  for (int m = blockIdx.x * kRowsPerBlock + threadIdx.x; m < m_end; m += blockDim.x) {
    const size_t row = (size_t)b * M + m;
    const int* code;
    if (by_id) {
      const int id = ids[row];
      if (id < 0) {
        out[row] = kInf;
        continue;
      }
      code = codes + (size_t)id * C;
    } else {
      code = codes + row * C;
    }
    float acc = 0.0f;
    for (int c = 0; c < C; ++c) acc = __fadd_rn(acc, lut_s[c * K + code[c]]);
    out[row] = acc;
  }
}

}  // namespace

extern "C" int pq_lookup_launch(const float* lut, const int* codes, const int* ids, float* out,
                                int B, int M, int C, int K, int by_id, cudaStream_t stream) {
  if (B == 0 || M == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)C * K * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(adc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock, B);
  adc_kernel<<<grid, kThreads, smem, stream>>>(lut, codes, ids, out, M, C, K, by_id);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
