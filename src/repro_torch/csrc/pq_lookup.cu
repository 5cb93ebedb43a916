// PQ asymmetric-distance computation (ADC) for Hopper: two kernels.
//
// adc_kernel replaces the TPU kernel repro/kernels/pq_lookup.py::
// pq_lookup_gathered (_adc_kernel / _adc_body), which computes out[b, m] =
// sum_c lut[b, c, codes[b, m, c]] as a one-hot x LUT matrix product on the
// MXU.  Here the same sum is a gather from a LUT held in shared memory.
//
// scan_kernel replaces repro/kernels/pq_lookup.py::pq_scan
// (_adc_scan_kernel), the brute-force sweep out[b, n] = sum_c lut[b, c,
// codes[n, c]] over one (N, C) code table shared by every query.
//
// What bounds them on an H100: bytes.  adc_kernel reads per query its
// C*K*4-byte LUT once (32 KB at C = 32, K = 256), the row ids and the C
// code words of every row, and writes one float per row.  scan_kernel
// reads the whole code table once per query tile and writes the (B, N)
// output, which dominates (256 MB at B = 64, N = 1,000,000).  There are C
// adds per output, far below the card's float rate.  Both keep the LUT in
// shared memory, one block per (tile of rows, query); the scan's tiles are
// 8x longer, so each query's LUT crosses from L2 once per 8192 rows and the
// LUT copies stay small beside the output.  At C = 32 a scan thread loads
// its 128-byte code row with eight 16-byte loads into registers.  In the search loop's entry
// (adc_kernel, by_id = 1) the gather codes[max(id, 0)] is folded into the
// kernel, so the (B, M, C) gathered copy of the code rows is never written.
// Codes must lie in [0, K): the engine checks them when it loads an index.
//
// Summation order: each thread owns one row and adds c = 0..C-1 left to
// right with __fadd_rn from 0.0f, exactly the order of the plain PyTorch
// versions (repro_torch/kernels/pq_lookup.py) and of the fused round's ADC,
// so all of them agree bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr float kInf = 3.4e38f;
constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 1024;
constexpr int kScanRowsPerBlock = 8192;
constexpr int kScanC = 32;  // the code width the scan's vector path serves (rows of 128 B)

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

// out[b, n] = sum_c lut[b, c, codes[n, c]] over the shared (N, C) table.
__global__ void scan_kernel(const float* __restrict__ lut, const int* __restrict__ codes,
                            float* __restrict__ out, int N, int C, int K) {
  extern __shared__ float lut_s[];
  const int b = blockIdx.y;
  const float* lut_b = lut + (size_t)b * C * K;
  for (int i = threadIdx.x; i < C * K; i += blockDim.x) lut_s[i] = lut_b[i];
  __syncthreads();

  const long long n_begin = (long long)blockIdx.x * kScanRowsPerBlock;
  const long long n_end = min((long long)N, n_begin + kScanRowsPerBlock);
  for (long long n = n_begin + threadIdx.x; n < n_end; n += blockDim.x) {
    const int* code = codes + n * C;
    float acc = 0.0f;
    if (C == kScanC) {
      // the row's codes into registers with 16-byte loads issued back to
      // back: one 4-byte load per chunk would fetch a 32-byte sector from
      // L2 for every code (the LUT leaves L1 almost no room to keep them)
      int4 row[kScanC / 4];
      const int4* code4 = reinterpret_cast<const int4*>(code);
#pragma unroll
      for (int i = 0; i < kScanC / 4; ++i) row[i] = __ldg(code4 + i);
      const int* r = reinterpret_cast<const int*>(row);
#pragma unroll
      for (int c = 0; c < kScanC; ++c) acc = __fadd_rn(acc, lut_s[c * K + r[c]]);
    } else {
      for (int c = 0; c < C; ++c) acc = __fadd_rn(acc, lut_s[c * K + __ldg(code + c)]);
    }
    out[(size_t)b * N + n] = acc;
  }
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" int pq_scan_launch(const float* lut, const int* codes, float* out, int B, int N, int C,
                              int K, cudaStream_t stream) {
  if (B == 0 || N == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)C * K * sizeof(float);
  cudaError_t e = allow_smem((const void*)scan_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + kScanRowsPerBlock - 1) / kScanRowsPerBlock, B);
  scan_kernel<<<grid, kThreads, smem, stream>>>(lut, codes, out, N, C, K);
  return (int)cudaGetLastError();
}

extern "C" int pq_lookup_launch(const float* lut, const int* codes, const int* ids, float* out,
                                int B, int M, int C, int K, int by_id, cudaStream_t stream) {
  if (B == 0 || M == 0) return (int)cudaSuccess;
  const size_t smem = (size_t)C * K * sizeof(float);
  cudaError_t e = allow_smem((const void*)adc_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock, B);
  adc_kernel<<<grid, kThreads, smem, stream>>>(lut, codes, ids, out, M, C, K, by_id);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
