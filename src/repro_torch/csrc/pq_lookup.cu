// PQ asymmetric-distance computation (ADC) for Hopper.
//
// The gathered ADC replaces the TPU kernel repro/kernels/pq_lookup.py::
// pq_lookup_gathered (_adc_kernel / _adc_body), which computes out[b, m] =
// sum_c lut[b, c, codes[b, m, c]] as a one-hot x LUT matrix product on the
// MXU; the search loop's entry (by_id = 1) gathers the code rows
// codes[ids[b, m]] of an (N, C) table inside the kernel and gives +INF for
// ids < 0, so no (B, M, C) copy of the rows is written.  The scan replaces
// repro/kernels/pq_lookup.py::pq_scan (_adc_scan_kernel), the brute-force
// sweep out[b, n] = sum_c lut[b, c, codes[n, c]] over one (N, C) table
// shared by every query.  Codes must lie in [0, K): the engine checks them
// when it loads an index.
//
// Gathered ADC (pq_lookup_launch).  The loop's rounds (B = 256 queries,
// M = 768 candidates, C = 32, K = 256) make one block a query, two to an
// SM, so one block's critical path is the kernel's time.  The earlier
// one-block-a-query kernel spent half of it copying the query's 32 KB LUT
// with 4-byte loads, one after another, and the rest on rows whose id load
// and 32 code loads waited on one another (PERF.md).  A block of the
// staged route
//   1. starts the LUT as one TMA bulk copy (cp.async.bulk, completing on an
//      mbarrier; a plain copy, in step 4, when the LUT is off 16-byte
//      alignment or C * K % 4 != 0), which lands while steps 2 and 3 run;
//   2. loads its ids, writes +INF for ids < 0 and lists the live rows in
//      shared memory (a warp ballot and one atomic a warp), so each of its
//      512 threads takes one live row a pass and none holds a dead one;
//   3. issues its row's code loads, the first 32 codes as eight 16-byte
//      loads into registers (4-byte loads when C % 4 != 0 or the rows are
//      off 16-byte alignment), before it waits on the LUT;
//   4. sums from shared memory.
// What bounds it now: the bytes each SM draws from L2 (two 32 KB LUTs and
// its live rows' 128-byte code lines) and one launch; a block that only
// stages its LUT already takes about 2 us.  Several blocks a query, two
// rows a thread, 256 threads, and eight lanes a row (one 16-byte load a
// lane, the sum passed along by shuffles) all measured slower (PERF.md).
// Shape rule (adc_route): a query of fewer rows than its LUT has entries a
// chunk (M < K, so fewer lookups, M * C, than LUT words, C * K) does not
// pay for staging: one thread a row reads lut[b, c, code] from global
// memory, where build_lut has just written it.  The search loop's entry
// call (M = 1) takes that route, its rounds (M = 768) the staged one.
//
// Scan (pq_scan_launch).  The earlier kernel, one block per (tile,
// query), read the (N, C) table from HBM once per query (64 x 128 MB at
// B = 64, N = 1M).  Here a block owns a tile of kScanThreads * kScanRows rows and
// holds their codes in registers, four 8-bit codes to a 32-bit word
// (K <= 256), read from HBM once for all B queries.  It walks the queries:
// query q + 1's LUT arrives by a TMA bulk copy in the second of two
// shared-memory buffers while query q is summed (one mbarrier a buffer, so
// one block barrier a query), and out[q, tile] is written coalesced.
// What bounds it now: the B * N * C shared-memory lookups.  Codes are
// random, so a warp's 32 lanes fall on about 3.5 lanes' worth of banks
// each; the kernel runs close to that floor (PERF.md).  Small tiles and
// three blocks an SM beat larger tiles: the LUT traffic from L2 they add
// costs less than the occupancy they buy.  Codes wider than 8 bits
// (K > 256) or rows of more than 32 codes take the unpacked route: a tile
// of kWideRows rows walks the queries the same way with one LUT buffer,
// its codes read again for each query (from L2 after the first).
//
// Summation order: every route adds c = 0..C-1 left to right with
// __fadd_rn from 0.0f, one row a thread, exactly the order of the plain
// PyTorch versions (repro_torch/kernels/pq_lookup.py) and of the fused
// round's ADC, so all of them agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.4e38f;
enum AdcRoute { kDirect = 0, kStaged = 1 };
enum ScanRoute { kPacked = 0, kWide = 1 };

constexpr int kAdcThreads = 512;
constexpr int kAdcTile = 1024;  // most rows of one query a block takes
constexpr int kDirectThreads = 32;
constexpr int kScanThreads = 256;
constexpr int kScanRows = 2;  // rows a thread holds: a tile is kScanThreads * kScanRows rows
constexpr int kScanTile = kScanThreads * kScanRows;
constexpr int kWideRows = 1024;

__host__ __device__ inline size_t align16(size_t bytes) { return (bytes + 15) & ~(size_t)15; }

// An mbarrier that one TMA bulk copy at a time completes: initialised by
// one thread, then visible to the copy engine (the async proxy)
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  const uint32_t m = (uint32_t)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(m));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// bytes (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory by one TMA bulk copy, whose completion ends the current
// phase of bar; issued by one thread
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const uint32_t m = (uint32_t)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(m), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(d), "l"(src), "r"(bytes), "r"(m)
      : "memory");
}

// wait until the phase of bar with this parity (0 for its first use, 1 for
// its second, ...) has completed; the copied bytes are then visible
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t m = (uint32_t)__cvta_generic_to_shared(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(m), "r"(parity)
        : "memory");
  }
}

// n floats from global to shared memory by plain loads (a LUT that TMA
// cannot copy: off 16-byte alignment, or n % 4 != 0)
__device__ __forceinline__ void copy_lut(float* dst, const float* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

__device__ __forceinline__ int part(const int4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// codes c0 .. c0 + 31 of one row (those below C) into v: 16-byte loads
// when VEC (C % 4 == 0 and the row 16-byte aligned), else 4-byte loads
template <bool VEC>
__device__ __forceinline__ void load_chunk(int4 (&v)[8], const int* __restrict__ code, int c0,
                                           int C) {
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int c = c0 + 4 * t;
    if (VEC) {
      if (c < C) v[t] = __ldg(reinterpret_cast<const int4*>(code + c));
    } else {
      v[t].x = c + 0 < C ? __ldg(code + c + 0) : 0;
      v[t].y = c + 1 < C ? __ldg(code + c + 1) : 0;
      v[t].z = c + 2 < C ? __ldg(code + c + 2) : 0;
      v[t].w = c + 3 < C ? __ldg(code + c + 3) : 0;
    }
  }
}

// acc + lut_s[c * K + code_c] for c = c0 .. min(C, c0 + 32) - 1, in order
__device__ __forceinline__ float sum_chunk(float acc, const int4 (&v)[8],
                                           const float* lut_s, int c0, int C, int K) {
#pragma unroll
  for (int t = 0; t < 8; ++t) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 4 * t + j;
      if (c < C) acc = __fadd_rn(acc, lut_s[c * K + part(v[t], j)]);
    }
  }
  return acc;
}

// ---------------------------------------------------------------- ADC
// Staged route: block (s, b) = tile s of query b's rows, rows [s*tile,
// min(M, (s+1)*tile)).  by_id = 0: codes is (B, M, C), row (b, m) at
// codes[(b*M + m)*C]; by_id = 1: codes is the (N, C) table, row (b, m) at
// codes[ids[b*M + m]*C], ids < 0 give +INF and read no codes.
template <bool VEC>
__global__ void __launch_bounds__(kAdcThreads, 2) adc_staged_kernel(
    const float* __restrict__ lut, const int* __restrict__ codes, const int* __restrict__ ids,
    float* __restrict__ out, int M, int C, int K, int by_id, int lut_async, int tiles, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut_s = reinterpret_cast<float*>(smem);
  int* live_m = reinterpret_cast<int*>(smem + align16((size_t)C * K * 4));  // by_id: live rows
  int* live_id = live_m + tile;
  __shared__ int n_live;

  const int b = blockIdx.x / tiles, tid = threadIdx.x, T = blockDim.x;
  const int m0 = (blockIdx.x % tiles) * tile;
  const int rows = min(tile, M - m0);
  const size_t row0 = (size_t)b * M + m0;
  const float* lut_b = lut + (size_t)b * C * K;

  // 1. the LUT in flight: one bulk copy (TMA), completing on an mbarrier
  __shared__ uint64_t lut_bar;
  if (tid == 0) {
    if (lut_async) {
      bar_init(&lut_bar);
      bulk_copy(lut_s, lut_b, C * K * 4, &lut_bar);
    }
    n_live = 0;
  }
  // 2. the live rows: by id, those with ids >= 0 (the others are +INF now)
  int id[kAdcTile / kAdcThreads];
  if (by_id) {
#pragma unroll
    for (int i = 0; i < kAdcTile / kAdcThreads; ++i) {
      const int r = i * T + tid;
      id[i] = r < rows ? ids[row0 + r] : -1;
    }
  }
  __syncthreads();  // the mbarrier and n_live initialised
  int live = rows;
  if (by_id) {
    const int lane = tid & 31;
#pragma unroll
    for (int i = 0; i < kAdcTile / kAdcThreads; ++i) {
      const int r = i * T + tid;
      if (r < rows && id[i] < 0) out[row0 + r] = kInf;
      const unsigned mask = __ballot_sync(0xFFFFFFFFu, id[i] >= 0);
      int base = 0;
      if (lane == 0 && mask) base = atomicAdd(&n_live, __popc(mask));
      base = __shfl_sync(0xFFFFFFFFu, base, 0);
      if (id[i] >= 0) {
        const int at = base + __popc(mask & ((1u << lane) - 1));
        live_m[at] = r;
        live_id[at] = id[i];
      }
    }
    __syncthreads();
    live = n_live;
  }
  // 3-4. passes of one live row a thread: the pass's code loads issued,
  // then (first pass) the LUT awaited, then the sums
  for (int p = 0;; p += T) {
    const int j = p + tid;
    const int* code = nullptr;
    int4 v[8];
    if (j < live) {
      code = by_id ? codes + (size_t)live_id[j] * C : codes + (row0 + j) * C;
      load_chunk<VEC>(v, code, 0, C);
    }
    if (p == 0) {
      if (lut_async) {
        bar_wait(&lut_bar, 0);
      } else {
        copy_lut(lut_s, lut_b, C * K);
      }
      __syncthreads();
    }
    if (p >= live) break;
    if (code != nullptr) {
      float acc = sum_chunk(0.0f, v, lut_s, 0, C, K);
      for (int c0 = 32; c0 < C; c0 += 32) {  // rows of more than 32 codes
        load_chunk<VEC>(v, code, c0, C);
        acc = sum_chunk(acc, v, lut_s, c0, C, K);
      }
      out[row0 + (by_id ? live_m[j] : j)] = acc;
    }
  }
}

// Direct route (few rows a query): one thread a row, the LUT entries read
// from global memory, all of a chunk's loads issued before its sum.
template <bool VEC>
__global__ void __launch_bounds__(kDirectThreads) adc_direct_kernel(
    const float* __restrict__ lut, const int* __restrict__ codes, const int* __restrict__ ids,
    float* __restrict__ out, long long rows, int M, int C, int K, int by_id) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const int* code;
  if (by_id) {
    const int id = ids[row];
    if (id < 0) {
      out[row] = kInf;
      return;
    }
    code = codes + (size_t)id * C;
  } else {
    code = codes + (size_t)row * C;
  }
  const float* lut_b = lut + (size_t)(row / M) * C * K;
  float acc = 0.0f;
  for (int c0 = 0; c0 < C; c0 += 32) {
    int4 v[8];
    load_chunk<VEC>(v, code, c0, C);
    float g[32];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + 4 * t + j;
        g[4 * t + j] = c < C ? __ldg(lut_b + (size_t)c * K + part(v[t], j)) : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (c0 + i < C) acc = __fadd_rn(acc, g[i]);
  }
  out[row] = acc;
}

// ---------------------------------------------------------------- scan
// Packed route (K <= 256, C <= 32): block x owns rows [x*kScanTile,
// (x+1)*kScanTile), row n_r = x*kScanTile + r*kScanThreads + tid for
// thread tid, its codes packed in w[r].  FAST: C == 32 and K == 256, the
// index's shape, known to the compiler (no bounds on c, LUT rows at
// constant offsets).
template <bool FAST, bool VEC>
__global__ void __launch_bounds__(kScanThreads, 3) scan_packed_kernel(
    const float* __restrict__ lut, const int* __restrict__ codes, float* __restrict__ out, int B,
    int N, int C_, int K_, int lut_async) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = FAST ? 32 : C_, K = FAST ? 256 : K_;
  const int lut_words = C * K;
  float* const buf0 = reinterpret_cast<float*>(smem);
  float* const buf1 = reinterpret_cast<float*>(smem + align16((size_t)lut_words * 4));
  const long long n0 = (long long)blockIdx.x * kScanTile + threadIdx.x;
  __shared__ uint64_t bar[2];  // bar[i] completes each copy into buffer i

  if (lut_async && threadIdx.x == 0) {  // query 0's LUT in flight while the codes arrive
    bar_init(&bar[0]);
    bar_init(&bar[1]);
    bulk_copy(buf0, lut, lut_words * 4, &bar[0]);
  }
  __syncthreads();  // the mbarriers initialised
  uint32_t w[kScanRows][8];
#pragma unroll
  for (int r = 0; r < kScanRows; ++r) {
    const long long n = n0 + (long long)r * kScanThreads;
    const int* code = codes + (size_t)n * C;
    int4 v[8];
    if (n < N) {
      load_chunk<VEC>(v, code, 0, C);
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
      w[r][t] = n < N && 4 * t < C
                    ? (uint32_t)v[t].x | (uint32_t)v[t].y << 8 | (uint32_t)v[t].z << 16 |
                          (uint32_t)v[t].w << 24
                    : 0u;
  }

  for (int q = 0; q < B; ++q) {
    float* const lut_s = q & 1 ? buf1 : buf0;
    if (lut_async) {
      // query q + 1's LUT into the other buffer, free since the barrier
      // that ended query q - 1; query q's, the (q / 2)-th copy into this one
      if (threadIdx.x == 0 && q + 1 < B)
        bulk_copy(q & 1 ? buf0 : buf1, lut + (size_t)(q + 1) * lut_words, lut_words * 4,
                  &bar[(q + 1) & 1]);
      bar_wait(&bar[q & 1], (q >> 1) & 1);
    } else {
      copy_lut(lut_s, lut + (size_t)q * lut_words, lut_words);
      __syncthreads();
    }
    float acc[kScanRows];
#pragma unroll
    for (int r = 0; r < kScanRows; ++r) acc[r] = 0.0f;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * t + j;
        if (c < C) {
          const float* lc = lut_s + c * K;
#pragma unroll
          for (int r = 0; r < kScanRows; ++r)
            acc[r] = __fadd_rn(acc[r], lc[(w[r][t] >> (8 * j)) & 0xFFu]);
        }
      }
    }
    float* out_q = out + (size_t)q * N;
#pragma unroll
    for (int r = 0; r < kScanRows; ++r) {
      const long long n = n0 + (long long)r * kScanThreads;
      if (n < N) out_q[n] = acc[r];
    }
    __syncthreads();  // every lookup of lut_s done before query q + 2's copy into it
  }
}

// Unpacked route (K > 256 or C > 32): block x owns rows [x*kWideRows,
// (x+1)*kWideRows) and walks the queries, one LUT buffer.
__global__ void __launch_bounds__(kScanThreads) scan_wide_kernel(
    const float* __restrict__ lut, const int* __restrict__ codes, float* __restrict__ out, int B,
    int N, int C, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut_s = reinterpret_cast<float*>(smem);
  const long long n_begin = (long long)blockIdx.x * kWideRows;
  const long long n_end = min((long long)N, n_begin + kWideRows);
  for (int q = 0; q < B; ++q) {
    copy_lut(lut_s, lut + (size_t)q * C * K, C * K);
    __syncthreads();
    for (long long n = n_begin + threadIdx.x; n < n_end; n += blockDim.x) {
      const int* code = codes + (size_t)n * C;
      float acc = 0.0f;
      for (int c = 0; c < C; ++c) acc = __fadd_rn(acc, lut_s[c * K + __ldg(code + c)]);
      out[(size_t)q * N + n] = acc;
    }
    __syncthreads();
  }
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

cudaError_t sm_count(int& sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

int adc_route(int M, int K) { return M < K ? kDirect : kStaged; }
int scan_route(int C, int K) { return K <= 256 && C <= 32 ? kPacked : kWide; }

}  // namespace

extern "C" int pq_lookup_route(int M, int K) { return adc_route(M, K); }
extern "C" int pq_scan_route(int C, int K) { return scan_route(C, K); }

extern "C" int pq_scan_launch(const float* lut, const int* codes, float* out, int B, int N, int C,
                              int K, cudaStream_t stream) {
  if (B == 0 || N == 0) return (int)cudaSuccess;
  cudaError_t e;
  if (scan_route(C, K) == kWide) {
    const size_t smem = (size_t)C * K * sizeof(float);
    if ((e = allow_smem((const void*)scan_wide_kernel, smem)) != cudaSuccess) return (int)e;
    const long long blocks = ((long long)N + kWideRows - 1) / kWideRows;
    scan_wide_kernel<<<(unsigned)blocks, kScanThreads, smem, stream>>>(lut, codes, out, B, N, C, K);
    return (int)cudaGetLastError();
  }
  const bool vec = C % 4 == 0 && (uintptr_t)codes % 16 == 0;
  const int lut_async = (C * K) % 4 == 0 && (uintptr_t)lut % 16 == 0;
  const bool fast = C == 32 && K == 256;
  auto kernel = fast ? (vec ? scan_packed_kernel<true, true> : scan_packed_kernel<true, false>)
                     : (vec ? scan_packed_kernel<false, true> : scan_packed_kernel<false, false>);
  const size_t smem = 2 * align16((size_t)C * K * sizeof(float));
  if ((e = allow_smem((const void*)kernel, smem)) != cudaSuccess) return (int)e;
  const long long blocks = ((long long)N + kScanTile - 1) / kScanTile;
  kernel<<<(unsigned)blocks, kScanThreads, smem, stream>>>(lut, codes, out, B, N, C, K, lut_async);
  return (int)cudaGetLastError();
}

extern "C" int pq_lookup_launch(const float* lut, const int* codes, const int* ids, float* out,
                                int B, int M, int C, int K, int by_id, cudaStream_t stream) {
  if (B == 0 || M == 0) return (int)cudaSuccess;
  const bool vec = C % 4 == 0 && (uintptr_t)codes % 16 == 0;
  cudaError_t e;
  if (adc_route(M, K) == kDirect) {
    const long long rows = (long long)B * M;
    const long long blocks = (rows + kDirectThreads - 1) / kDirectThreads;
    auto kernel = vec ? adc_direct_kernel<true> : adc_direct_kernel<false>;
    kernel<<<(unsigned)blocks, kDirectThreads, 0, stream>>>(lut, codes, ids, out, rows, M, C, K,
                                                            by_id);
    return (int)cudaGetLastError();
  }
  // tiles a query: enough blocks for every SM when B alone is too few, at
  // least one row a thread a tile, at most kAdcTile rows a tile
  int sms = 0;
  if ((e = sm_count(sms)) != cudaSuccess) return (int)e;
  const int most = (M + kAdcThreads - 1) / kAdcThreads;
  const int least = (M + kAdcTile - 1) / kAdcTile;
  const int tiles = max(least, min(most, (sms + B - 1) / B));
  const int tile = (M + tiles - 1) / tiles;
  const int lut_async = (C * K) % 4 == 0 && (uintptr_t)lut % 16 == 0;
  auto kernel = vec ? adc_staged_kernel<true> : adc_staged_kernel<false>;
  const size_t smem = align16((size_t)C * K * sizeof(float)) + 2 * (size_t)tile * sizeof(int);
  if ((e = allow_smem((const void*)kernel, smem)) != cudaSuccess) return (int)e;
  kernel<<<(unsigned)((long long)B * tiles), kAdcThreads, smem, stream>>>(
      lut, codes, ids, out, M, C, K, by_id, lut_async, tiles, tile);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
