// Fused two-choice hash probe for Hopper (sm_90a), up to two tables a
// launch.
//
// Replaces the Pallas TPU kernel `ht_lookup_fused`
// (tigerbeetle_tpu/ops/pallas_kernels.py:80, body `_probe_kernel` :57)
// and computes, for each (table, keys) segment, exactly what its plain
// PyTorch twin `tigerbeetle_tpu_torch/ops/hash_table.py::ht_lookup`
// computes:
//   b1, b2 = _buckets(k_hi, k_lo, B)          (hash_table.py `_buckets`)
//   for each of the two bucket rows, match the 8 slots against (hi, lo)
//   (key 0 never matches), OR the hits, and take
//   val = max over slots of (match ? int32(slot_val) : -1),
//   the second bucket's answer winning where it hits.
// An orphan slot (stored -2) therefore reports found=1, val=-1.
//
// Table: (B+1, 24) u64 rows laid out [key_hi x 8 | key_lo x 8 | val x 8]
// (192 bytes a row); PyTorch hands the u64 lanes over as int64 tensors
// and the kernel reads the same bits as uint64_t.
//
// What bounds it on an H100 at the main path's sizes: latency, not
// bytes. Each query reads its 16-byte key, the 128-byte key halves of two
// random bucket rows, one 32-byte sector of vals when it hits, and writes
// 5 bytes: N = 16,384 queries move ~4.7 MB, ~1.4 us at 3.35 TB/s, less
// than a launch and the two dependent device-memory round trips (the
// key, then the rows) that every query pays. The one-query launch
// (`floor_ms` in chip_smoke.py) takes most of the full probe's time:
// measured by chip_smoke.py on an H100 80GB HBM3 at 700 W, one query
// 0.0016-0.0019 ms, 16,384 cold transfer-table queries 0.0041-0.0045 ms,
// both tables' 32,768 queries in one launch 0.0050-0.0051 ms. The
// transfer table at the default capacities is ~201 MB, past the 50 MB
// L2 and far past shared memory, so the TPU design (the whole table
// resident in VMEM behind a 12 MiB gate) does not carry over: the rows
// are read straight from device memory.
//
// Design:
//   - one launch probes up to two tables (the create_transfers path
//     probes the account table and the transfer table at the same
//     stage), the segments passed by value in a __grid_constant__
//     parameter block, one grid over the sum of the queries. The kernel
//     is specialised on the segment count: a thread of a two-table
//     launch finds its segment with one compare, a one-table launch
//     reads its fields at fixed offsets (searching for the segment cost
//     the one-table probe measurable time on the L2-resident account
//     table, PERF.md);
//   - a group of 8 lanes per query, one slot a lane; each lane reads its
//     key_hi and key_lo slots from EACH bucket row before it compares
//     anything: 4 independent 8-byte loads a lane, both rows in flight
//     together, a group's reads of one key half one coalesced 64-byte
//     segment. Measured, this body is level with the one-row-at-a-time
//     body it replaces: the probe's time is the launch plus the
//     dependent round trips, key -> rows -> val, that every query pays
//     either way. A 4-lane group (two slots a lane, 16-byte loads) with
//     non-allocating loads (ld.global.nc.L1::no_allocate) measured
//     slower on the account table and is not used;
//   - then the match; only a matching slot's lane reads its val; the
//     hit/max reduction over the group is 3 __shfl_xor_sync steps;
//   - a zero key (and the grid's ragged tail) reads nothing;
//   - the hash is computed in the kernel (native uint64_t:
//     multiplications wrap, shifts are logical), so no bucket-index
//     tensors are made.

#include <cuda_runtime.h>
#include <stdint.h>

// One segment as the caller hands it over (the ctypes structure
// of the same name in ops/_build.py mirrors it field for field). It lives
// outside the unnamed namespace so that the C entry point taking it keeps
// external linkage.
struct ProbeSegment {
  const void* packed;   // (n_buckets + 1, 24) u64
  long long n_buckets;  // B, a power of two
  const void* k_hi;     // n u64
  const void* k_lo;     // n u64
  long long n;
  void* found;          // n bool
  void* val;            // n int32
};

namespace {

constexpr int kSlots = 8;
constexpr int kRowWords = 3 * kSlots;
constexpr int kLanes = kSlots;  // a query's group: one slot a lane
constexpr int kThreads = 256;
constexpr int kMaxSegments = 2;

constexpr uint64_t kC1 = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kC2 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t kC3 = 0xD6E8FEB86659FD93ull;
constexpr uint64_t kC4 = 0x2545F4914F6CDD1Dull;

struct Segment {
  const uint64_t* packed;
  uint64_t bucket_mask;  // B - 1
  const uint64_t* k_hi;
  const uint64_t* k_lo;
  bool* found;
  int32_t* val;
  long long begin;       // first query of the segment
};

struct Params {
  Segment seg[kMaxSegments];
  long long total;       // queries over all segments
};

// kSeg: the segments of the launch. A one-table launch reads its
// segment's fields at fixed offsets and searches nothing.
template <int kSeg>
__global__ void __launch_bounds__(kThreads)
ht_probe_kernel(const __grid_constant__ Params p) {
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  const long long q = tid / kLanes;
  const int lane = static_cast<int>(tid % kLanes);
  const bool active = q < p.total;
  const Segment& g = kSeg == 2 && q >= p.seg[1].begin ? p.seg[1] : p.seg[0];
  const long long i = kSeg == 2 ? q - g.begin : q;
  uint64_t k_hi = 0, k_lo = 0;
  if (active) {
    k_hi = __ldg(reinterpret_cast<const unsigned long long*>(g.k_hi) + i);
    k_lo = __ldg(reinterpret_cast<const unsigned long long*>(g.k_lo) + i);
  }
  const bool querying = (k_hi | k_lo) != 0;

  uint64_t h1 = (k_lo ^ (k_hi * kC1)) * kC2;
  h1 ^= h1 >> 31;
  uint64_t h2 = (k_hi ^ (k_lo * kC3)) * kC4;
  h2 ^= h2 >> 29;
  const uint64_t* row1 = g.packed + (h1 & g.bucket_mask) * kRowWords;
  const uint64_t* row2 = g.packed + (h2 & g.bucket_mask) * kRowWords;

  // Both rows' key halves, all four loads issued before any compare.
  uint64_t hi1 = 0, lo1 = 0, hi2 = 0, lo2 = 0;
  if (querying) {
    hi1 = row1[lane];
    lo1 = row1[kSlots + lane];
    hi2 = row2[lane];
    lo2 = row2[kSlots + lane];
  }
  const bool m1 = querying && hi1 == k_hi && lo1 == k_lo;
  const bool m2 = querying && hi2 == k_hi && lo2 == k_lo;
  // A slot contributes its val (the low half of the stored u64) where it
  // matches, -1 where it does not; only a matching slot's lane reads it.
  int hit1 = m1, hit2 = m2;
  int32_t val1 = m1 ? static_cast<int32_t>(row1[2 * kSlots + lane]) : -1;
  int32_t val2 = m2 ? static_cast<int32_t>(row2[2 * kSlots + lane]) : -1;
  // Every lane of the warp reaches the shuffles (no early exit); the
  // xor offsets stay inside a query's group of kLanes lanes.
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    hit1 |= __shfl_xor_sync(0xffffffffu, hit1, off);
    hit2 |= __shfl_xor_sync(0xffffffffu, hit2, off);
    val1 = max(val1, __shfl_xor_sync(0xffffffffu, val1, off));
    val2 = max(val2, __shfl_xor_sync(0xffffffffu, val2, off));
  }
  if (active && lane == 0) {
    g.found[i] = (hit1 | hit2) != 0;
    g.val[i] = hit2 ? val2 : (hit1 ? val1 : -1);
  }
}

}  // namespace

// C entry point (bound with ctypes). `segs` holds n_seg (1 or 2)
// segments; a segment with n == 0 probes nothing. Launches once on
// `stream` (not at all when there is no query), does not synchronise,
// and returns cudaGetLastError() of the launch.
extern "C" int ht_probe_launch(const ProbeSegment* segs, int n_seg,
                               void* stream) {
  if (n_seg < 1 || n_seg > kMaxSegments) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = {};
  long long total = 0;
  for (int s = 0; s < n_seg; ++s) {
    const ProbeSegment& h = segs[s];
    if (h.n < 0 || h.n_buckets < 1 || (h.n_buckets & (h.n_buckets - 1))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    Segment& g = p.seg[s];
    g.packed = static_cast<const uint64_t*>(h.packed);
    g.bucket_mask = static_cast<uint64_t>(h.n_buckets - 1);
    g.k_hi = static_cast<const uint64_t*>(h.k_hi);
    g.k_lo = static_cast<const uint64_t*>(h.k_lo);
    g.found = static_cast<bool*>(h.found);
    g.val = static_cast<int32_t*>(h.val);
    g.begin = total;
    total += h.n;
  }
  p.total = total;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const long long threads_total = total * kLanes;
  const unsigned int blocks =
      static_cast<unsigned int>((threads_total + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_seg == 1) {
    ht_probe_kernel<1><<<blocks, kThreads, 0, st>>>(p);
  } else {
    ht_probe_kernel<2><<<blocks, kThreads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
