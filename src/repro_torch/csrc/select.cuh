// "The first k keys of N under a total key", for Hopper: the building
// blocks that topk_merge.cu and fused_traversal.cu share.
//
// Keys are made totally ordered and compared as unsigned integers:
//   * a float distance becomes `ord_dist`, a uint32 in the float order,
//     with -0.0 and +0.0 mapped to the same value (they compare equal as
//     floats, and the plain versions' stable sorts keep them in input
//     order).  NaN is not a key;
//   * the high 32 bits of a 64-bit key are `ord_dist`, the low 32 bits
//     the tie-breaker (a slot number, or a signed id flipped to unsigned
//     order), and a key may carry a position that breaks the last ties,
//     so that no two keys of one selection are equal.
//
// `WarpList` keeps one warp's running first-n keys (n = 32 * Q) sorted
// ascending across its lanes, element q * 32 + lane in register q of
// that lane.  `insert` puts one warp-uniform key into place with a
// shuffle up; `merge32` takes 32 keys at once by bitonic merges; neither
// touches shared memory or a block barrier.  A key that is not below the
// list's n-th key falls off the end, so a caller filters its candidates
// against the k-th key (`at`) and inserts only survivors.
//
// `block_select` serves a block that holds all its keys in shared memory
// (the fused round, and topk_merge for 32 < k <= 64): a radix select finds
// the k-th key a byte a pass, stopping once that byte settles it, the
// chosen keys are gathered, and the caller sorts them (`warp_sort64`, or
// `WarpList<2>::merge32` for keys with a position).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace sel {

constexpr unsigned kFull = 0xFFFFFFFFu;

// float -> uint32 in float order; both zeros -> the order of +0.0
__device__ __forceinline__ uint32_t ord_dist(float d) {
  uint32_t u = __float_as_uint(d);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// signed int32 -> uint32 in signed order
__device__ __forceinline__ uint32_t ord_id(int id) { return (uint32_t)id ^ 0x80000000u; }

// a 64-bit key and a position (its index in the row), compared in that order
struct KeyPos {
  unsigned long long k;
  uint32_t p;
};

__device__ __forceinline__ bool less(const KeyPos& a, const KeyPos& b) {
  return a.k < b.k || (a.k == b.k && a.p < b.p);
}

__device__ __forceinline__ KeyPos key_max() { return KeyPos{~0ull, ~0u}; }

__device__ __forceinline__ KeyPos shfl(const KeyPos& a, int src) {
  return KeyPos{__shfl_sync(kFull, a.k, src), __shfl_sync(kFull, a.p, src)};
}

__device__ __forceinline__ KeyPos shfl_up1(const KeyPos& a) {
  return KeyPos{__shfl_up_sync(kFull, a.k, 1), __shfl_up_sync(kFull, a.p, 1)};
}

__device__ __forceinline__ KeyPos shfl_xor(const KeyPos& a, int m) {
  return KeyPos{__shfl_xor_sync(kFull, a.k, m), __shfl_xor_sync(kFull, a.p, m)};
}

__device__ __forceinline__ KeyPos kmin(const KeyPos& a, const KeyPos& b) { return less(a, b) ? a : b; }
__device__ __forceinline__ KeyPos kmax(const KeyPos& a, const KeyPos& b) { return less(a, b) ? b : a; }

// 32 keys, one a lane, sorted ascending across the lanes (bitonic, 15 steps)
__device__ __forceinline__ void warp_sort32(KeyPos& x, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const KeyPos y = shfl_xor(x, j);
      const bool keep_min = ((lane & k) == 0) == ((lane & j) == 0);
      x = keep_min ? kmin(x, y) : kmax(x, y);
    }
  }
}

// a bitonic sequence of 32 keys, one a lane, into ascending order (5 steps)
__device__ __forceinline__ void warp_bitonic_merge32(KeyPos& x, int lane) {
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const KeyPos y = shfl_xor(x, j);
    x = (lane & j) == 0 ? kmin(x, y) : kmax(x, y);
  }
}

template <int Q>
struct WarpList {
  KeyPos e[Q];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int q = 0; q < Q; ++q) e[q] = key_max();
  }

  // element i (warp-uniform i < 32 * Q), broadcast to every lane
  __device__ __forceinline__ KeyPos at(int i) const {
    KeyPos r = e[0];
#pragma unroll
    for (int q = 1; q < Q; ++q)
      if ((i >> 5) == q) r = e[q];
    return shfl(r, i & 31);
  }

  // merge 32 keys, one a lane (key_max() where a lane has none): sort them,
  // then keep the first 32 * Q of list and keys by bitonic merges — the
  // first 32 of the top row and the reversed keys are min(top, reversed)
  // (Q <= 2)
  __device__ __forceinline__ void merge32(KeyPos s, int lane) {
    static_assert(Q == 1 || Q == 2, "WarpList::merge32 takes Q = 1 or 2");
    warp_sort32(s, lane);
    KeyPos t = kmin(e[Q - 1], shfl(s, 31 - lane));
    warp_bitonic_merge32(t, lane);
    if (Q == 2) {
      const KeyPos r = shfl(t, 31 - lane);
      KeyPos lo = kmin(e[0], r), hi = kmax(e[0], r);
      warp_bitonic_merge32(lo, lane);
      warp_bitonic_merge32(hi, lane);
      e[Q - 1] = hi;
      t = lo;
    }
    e[0] = t;
  }

  // insert x (the same on every lane): the list keeps its first 32 * Q keys
  __device__ __forceinline__ void insert(const KeyPos& x, int lane) {
    KeyPos pred[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      pred[q] = shfl_up1(e[q]);
      if (q > 0) {
        const KeyPos last = shfl(e[q - 1], 31);
        if (lane == 0) pred[q] = last;
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (less(e[q], x)) continue;
      const bool first = (q == 0 && lane == 0) || less(pred[q], x);
      e[q] = first ? x : pred[q];
    }
  }
};

// Put every candidate a lane flags in `live` (bit j: cand[j]) that is
// still below the list's k-th key into the list; the k-th key is re-read
// after each step and the remaining candidates are filtered against it.
// Candidate row j goes in by one merge32 when more than kMergeMin lanes
// flag it (a list still filling, or a run of better keys); what is left
// goes in one key at a time, taken from the lowest lane that has one.  A
// merge costs several insertions, and each insertion tightens the k-th
// key, which kills later candidates: on the H100 merging paid only for
// rows where most lanes survive (a list still filling), at k = 10 and at
// k = 64 alike.
constexpr int kMergeMin = 16;

template <int Q, int R>
__device__ __forceinline__ void insert_survivors(WarpList<Q>& list, const KeyPos (&cand)[R],
                                                 unsigned live, KeyPos& kth, int k, int lane) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (__popc(__ballot_sync(kFull, (live >> j) & 1u)) > kMergeMin) {
      list.merge32(((live >> j) & 1u) ? cand[j] : key_max(), lane);
      live &= ~(1u << j);
      kth = list.at(k - 1);
#pragma unroll
      for (int i = j + 1; i < R; ++i)
        if ((live & (1u << i)) && !less(cand[i], kth)) live &= ~(1u << i);
    }
  }
  unsigned lanes = __ballot_sync(kFull, live != 0);
  while (lanes) {
    const int src = __ffs(lanes) - 1;
    KeyPos mine = cand[0];
#pragma unroll
    for (int j = R - 1; j > 0; --j)
      if (live & (1u << j)) mine = cand[j];
    if (live & 1u) mine = cand[0];
    const KeyPos x = shfl(mine, src);
    if (lane == src) live &= live - 1;
    list.insert(x, lane);
    kth = list.at(k - 1);
#pragma unroll
    for (int j = 0; j < R; ++j)
      if ((live & (1u << j)) && !less(cand[j], kth)) live &= ~(1u << j);
    lanes = __ballot_sync(kFull, live != 0);
  }
}

// Sort 64 distinct 64-bit keys held by one warp, element lane in `a` and
// element lane + 32 in `b`, ascending: a bitonic network in registers, by
// shuffles (21 steps, no shared memory).
__device__ __forceinline__ void warp_sort64(unsigned long long& a, unsigned long long& b,
                                            int lane) {
#pragma unroll
  for (int k = 2; k <= 64; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 32) {  // partners in one lane: a is the lower element, ascending
        const unsigned long long lo = a < b ? a : b, hi = a < b ? b : a;
        a = lo;
        b = hi;
      } else {
        const unsigned long long pa = __shfl_xor_sync(kFull, a, j);
        const unsigned long long pb = __shfl_xor_sync(kFull, b, j);
        const bool lower = (lane & j) == 0;
        const bool asc_a = (lane & k) == 0, asc_b = ((lane + 32) & k) == 0;
        a = (asc_a == lower) ? (a < pa ? a : pa) : (a < pa ? pa : a);
        b = (asc_b == lower) ? (b < pb ? b : pb) : (b < pb ? pb : b);
      }
    }
  }
}

// Radix selection over a block: among the n keys get(s), s < n, of an
// unsigned type U (32 or 64 bits), find V, the r-th smallest (1 <= r <= n).
// One pass a byte, high byte first; each pass histograms the keys that
// share the bytes found so far (warp-aggregated shared-memory atomics, so
// many equal keys cost one atomic a warp) and one warp scans the 256 bins.
// It stops as soon as the r-th key is the last of its bin: then exactly r
// keys are <= V (V's unread bytes all ones) and it returns true.  Else it
// returns false, V is the r-th key and `below` keys are < V.  `hist` holds
// sizeof(U) * 256 ints, zeroed and behind a barrier before the call;
// `state` 3 ints.  Every thread of the block calls it.
template <class U, class Get>
__device__ bool block_radix_select(Get get, int n, int r, int* hist, int* state, U& V,
                                   int& below) {
  constexpr int kPasses = sizeof(U);
  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31;
  U prefix = 0, mask = 0;
  int need = r;
  below = 0;
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = 8 * (kPasses - 1 - pass);
    int* h = hist + pass * 256;
    for (int base = 0; base < n; base += T) {  // uniform trip count: full-warp match
      const int s = base + tid;
      int dig = 256;
      if (s < n) {
        const U v = get(s);
        if ((v & mask) == prefix) dig = (int)((v >> shift) & 255);
      }
      const unsigned peers = __match_any_sync(kFull, dig);
      if (dig < 256 && lane == __ffs(peers) - 1) atomicAdd(&h[dig], __popc(peers));
    }
    __syncthreads();
    if (tid < 32) {
      int c[8], sum = 0;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        c[t] = h[lane * 8 + t];
        sum += c[t];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += up;
      }
      int acc = incl - sum;
      if (acc < need && need <= incl) {
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          if (acc + c[t] >= need) {
            state[0] = lane * 8 + t;
            state[1] = acc;
            state[2] = acc + c[t] == need;
            break;
          }
          acc += c[t];
        }
      }
    }
    __syncthreads();
    const int dig = state[0], acc = state[1], last = state[2];
    need -= acc;
    below += acc;
    prefix |= (U)dig << shift;
    mask |= (U)255 << shift;
    if (last) {
      V = prefix | ~mask;
      return true;
    }
  }
  V = prefix;
  return false;
}

// The first r of the n keys (get(s), s) — the key, then the position s —
// in no particular order: put(i, s) once for each i < min(r, n), with the
// chosen positions s.  Keys below the r-th key are all chosen, and of
// those equal to it the lowest positions.  Every thread of the block calls
// it; `hist` and `state` as for block_radix_select, and state[3] zeroed
// too (the count of keys put so far).
template <class U, class Get, class Put>
__device__ void block_select(Get get, int n, int r, int* hist, int* state, Put put) {
  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = T >> 5;
  if (r >= n) {
    for (int s = tid; s < n; s += T) put(s, s);
    return;
  }
  U V;
  int below;
  const bool all_le = block_radix_select<U>(get, n, r, hist, state, V, below);
  const int take = r - below;  // keys equal to V, taken in position order
  int* wcnt = hist;  // the histograms are spent: per-(round, warp) counts of keys equal to V
  if (!all_le) {
    for (int base = 0, j = 0; base < n; base += T, ++j) {
      const int s = base + tid;
      const unsigned eq = __ballot_sync(kFull, s < n && get(s) == V);
      if (lane == 0) wcnt[j * nwarps + warp] = __popc(eq);
    }
    __syncthreads();
  }
  for (int base = 0, j = 0; base < n; base += T, ++j) {
    const int s = base + tid;
    const U v = s < n ? get(s) : (U)0;
    const bool tie = !all_le && s < n && v == V;
    const unsigned eq = __ballot_sync(kFull, tie);
    bool chosen = s < n && (all_le ? v <= V : v < V);
    if (tie) {
      int rank = __popc(eq & ((1u << lane) - 1));
      for (int i = 0; i < j * nwarps + warp; ++i) rank += wcnt[i];
      chosen = rank < take;
    }
    const unsigned ch = __ballot_sync(kFull, chosen);
    int at = 0;
    if (lane == 0 && ch) at = atomicAdd(&state[3], __popc(ch));
    at = __shfl_sync(kFull, at, 0) + __popc(ch & ((1u << lane) - 1));
    if (chosen) put(at, s);
  }
}

}  // namespace sel
