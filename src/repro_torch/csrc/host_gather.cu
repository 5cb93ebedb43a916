// The host tier's record fetch for Hopper: a round's live records read
// straight out of pinned host memory, over the PCIe link, into the card's
// (B, W) outputs.
//
// Replaces no TPU kernel.  The reference's host tier
// (repro/store/vector_store.py::HostOffloadRecordStore) gathers the whole
// beam on the host and copies it up; this kernel exists so that only the
// rows the filter gate passes cross the link, which is GateANN's claim for
// its slow tier ("no read for a non-matching node").
//
// Contract (store/vector_store.py::_gather_rows, bit for bit): (B, W) int32
// ids -> (B, W, D) float32 vectors and (B, W, R) int32 neighbour rows; a
// slot with id < 0 gets a zero vector and a row of -1.  An id >= N, which
// the search never passes, reads nothing and gets the same dead row.
//
// What bounds it on an H100: the link.  At the gate cell's shapes (B =
// 1,024, W = 8, D = 128, R = 64, 10% selectivity) a round has about 373
// live slots of 8,192: 286 KB to read over PCIe (4.5 us at 64 GB/s, PCIe
// 5.0 x16) and 6.3 MB of outputs to write in HBM (1.9 us at 3.35 TB/s).
// A read from host memory takes a microsecond or more to come back, so the
// design keeps every live row's reads in flight at once:
//   * one warp a slot, eight slots a block: all 8,192 slots of a round are
//     resident at once on 132 SMs, and a dead slot reads nothing;
//   * 16-byte loads (a 512-byte vector is one load a lane, a 256-byte
//     neighbour row one load on 16 lanes), both rows' loads issued before
//     either store; the wrapper refuses records and widths that do not
//     allow them (pointers not 16-byte aligned, D or R not a multiple of 4);
//   * the device address of the records comes from cudaHostGetDevicePointer
//     on each tensor's allocation, in the entry; memory that is not pinned
//     and mapped is refused there, before any launch;
//   * where the caller asks (rows_read not null), the rows read are counted
//     on the device (one atomic a block, over its live warps), so the caller
//     learns how many crossed the link without a sync of its own.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // slots a block
constexpr int kThreads = 32 * kWarps;
constexpr int kNotMappedVectors = -1;  // the entry's refusals, below every cudaError_t
constexpr int kNotMappedNeighbors = -2;

__global__ void __launch_bounds__(kThreads)
host_gather_kernel(const int* __restrict__ ids, const float* __restrict__ vectors,
                   const int* __restrict__ neighbors, float* __restrict__ out_vecs,
                   int* __restrict__ out_nbrs, unsigned long long* __restrict__ rows_read,
                   int slots, int N, int D, int R) {
  const int lane = threadIdx.x & 31;
  const long long slot = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int id = slot < slots ? ids[slot] : -1;
  const bool live = id >= 0 && id < N;
  if (rows_read != nullptr) {  // the same on every thread of the grid
    const int n_live = __syncthreads_count(lane == 0 && live);
    if (threadIdx.x == 0 && n_live) atomicAdd(rows_read, (unsigned long long)n_live);
  }
  if (slot >= slots) return;
  const int d4 = D >> 2, r4 = R >> 2, n4 = d4 > r4 ? d4 : r4;
  float4* ov4 = reinterpret_cast<float4*>(out_vecs + slot * D);
  int4* on4 = reinterpret_cast<int4*>(out_nbrs + slot * R);
  if (!live) {
    for (int i = lane; i < n4; i += 32) {
      if (i < d4) ov4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < r4) on4[i] = make_int4(-1, -1, -1, -1);
    }
    return;
  }
  const float4* sv = reinterpret_cast<const float4*>(vectors + (long long)id * D);
  const int4* sn = reinterpret_cast<const int4*>(neighbors + (long long)id * R);
  for (int i = lane; i < n4; i += 32) {
    float4 v;
    int4 n;
    if (i < d4) v = sv[i];
    if (i < r4) n = sn[i];
    if (i < d4) ov4[i] = v;
    if (i < r4) on4[i] = n;
  }
}

// The device address of `ptr`, which lies inside the pinned allocation that
// starts at `base` (a tensor's storage).
cudaError_t device_address(const void* base, const void* ptr, const char** out) {
  void* dev = nullptr;
  cudaError_t e = cudaHostGetDevicePointer(&dev, const_cast<void*>(base), 0);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch's check must not see it
    return e;
  }
  *out = static_cast<const char*>(dev) + (static_cast<const char*>(ptr) -
                                          static_cast<const char*>(base));
  return cudaSuccess;
}

}  // namespace

// ids (slots,) int32 on the card; vectors (N, D) float32 and neighbors (N, R)
// int32 in pinned host memory, each given by its storage's base pointer and
// its own; outputs (slots, D) and (slots, R) on the card; rows_read one
// uint64 on the card, added to, or null.  D and R are multiples of 4 and
// every pointer is 16-byte aligned (the wrapper checks).  Returns a cudaError_t, or
// kNotMapped* when a record tensor's memory is not pinned and mapped.
extern "C" int host_gather_launch(const int* ids, const void* vec_base, const void* vec_ptr,
                                  const void* nbr_base, const void* nbr_ptr, float* out_vecs,
                                  int* out_nbrs, unsigned long long* rows_read, int slots, int N,
                                  int D, int R, cudaStream_t stream) {
  const char* vectors = nullptr;
  const char* neighbors = nullptr;
  if (device_address(vec_base, vec_ptr, &vectors) != cudaSuccess) return kNotMappedVectors;
  if (device_address(nbr_base, nbr_ptr, &neighbors) != cudaSuccess) return kNotMappedNeighbors;
  if (slots == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((slots + kWarps - 1) / kWarps);
  host_gather_kernel<<<blocks, kThreads, 0, stream>>>(
      ids, reinterpret_cast<const float*>(vectors), reinterpret_cast<const int*>(neighbors),
      out_vecs, out_nbrs, rows_read, slots, N, D, R);
  return (int)cudaGetLastError();
}
