// Segmented row gather for Hopper (sm_90a). For each of up to 4 segments
// s of one launch: out_s[i, :] = table_s[clamp(rows_s[i]), :] & mask_s.
//
// Replaces the eight Pallas TPU row-gather kernels of the repo, all of
// them formulations of one function, `table[rows]` on a (4097, 48) u32
// table at 8,192 rows (two of them gather only the low 16-bit limb):
//   onchip/gather_probe.py:31  k_take       jnp.take
//   onchip/gather_probe.py:35  k_taa        take_along_axis
//   onchip/gather_probe.py:40  k_loop       a loop of row copies
//   onchip/gather_probe.py:47  k_onehot     (table & 0xFFFF), one-hot f32 matmul
//   onchip/gather_probe2.py:31 k_smem_loop  rows prefetched to SMEM
//   onchip/gather_probe2.py:56 k_taa32      int32 take_along_axis
//   onchip/gather_probe2.py:74 k_onehot32   (table & 0xFFFF), int32->f32 casts
//   onchip/gather_probe2.py:101 k_blk       an 8-block grid of 1024 rows
// and computes, segment by segment, exactly what its plain PyTorch twin
// `tigerbeetle_tpu_torch/ops/row_gather.py::row_gather_plain` computes:
//   table[rows.clamp(0, B - 1)] & mask
// (the clamp is JAX's `x[rows]` semantics). On the port's main path it
// gathers the account and transfer rows of create_transfers (the u64
// stores viewed as u32 pairs, which is what the probes were written for).
//
// What bounds it on an H100 at the main path's sizes: latency, not
// bytes. A gather of 16,384 rows of 160 B moves ~5.4 MB, 0.0016 ms at
// 3.35 TB/s, less than one launch plus two dependent device-memory
// round trips (the index, then the row); the one-row launch alone
// (`floor_ms` in chip_smoke.py) takes most of the time the full gather
// does. Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W: one row
// 0.0014-0.0019 ms, the 16,384 cold transfer rows 0.0033 ms (PERF.md).
// So the design cuts fixed cost and keeps loads in flight:
//   - one launch serves up to 4 segments (tables that are gathered at
//     the same stage, often at one shared rows array), so the main path
//     pays one launch where it paid one per table. The segments travel
//     by value in a __grid_constant__ parameter block; one flat work
//     space covers (segment, row, chunk), cut by per-segment prefix
//     counts;
//   - an item is one 16-byte chunk of an output row (int4 loads and
//     stores) where the row's width is a multiple of 4 words and both
//     pointers are 16-byte aligned, else one 32-bit word;
//   - a thread takes one item a pass: its index load, its row load, its
//     store; neighbouring threads take neighbouring chunks (one
//     coalesced segment a row). Two or four items a thread (all index
//     loads, then all row loads, then the stores) measured slower at
//     every main path shape (PERF.md): they leave fewer warps a SM to
//     overlap the round trips;
//   - the grid is at most one resident wave (blocks a SM x SMs), with a
//     grid-stride loop past it;
//   - rows are read through the read-only path without allocating in L1
//     (each gathered chunk is used once). An L2::256B prefetch hint on a
//     row's first chunk measured no faster (a row's other chunks are
//     loaded by neighbouring threads at the same time) and is not used.
// No shared memory: each gathered row is used by one output row only.

#include <cuda_runtime.h>
#include <stdint.h>

// One segment as the caller hands it over (the ctypes structure
// of the same name in ops/_build.py mirrors it field for field). It lives
// outside the unnamed namespace so that the C entry point taking it keeps
// external linkage.
struct RowGatherSegment {
  const void* table;   // contiguous (n_rows, width) 32-bit words
  const void* rows;    // n int32 or int64 indexes
  void* out;           // contiguous (n, width) 32-bit words
  long long n_rows;
  long long n;
  long long width;     // 32-bit words a row
  int rows_are_64;
  unsigned int mask;
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSegments = 4;

struct Segment {
  const char* table;
  const void* rows;
  char* out;
  long long last_row;       // n_rows - 1
  unsigned long long begin; // first item of the segment (absent: ~0)
  unsigned int chunks;      // items a row
  unsigned int mask;
  int vec;                  // 1: 16-byte items, 0: 32-bit items
  int rows_are_64;
};

struct Params {
  Segment seg[kMaxSegments];
  unsigned long long total;  // items over all segments
};

__device__ __forceinline__ int4 load_chunk(const char* p) {
  int4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ int load_word(const char* p) {
  int v;
  asm volatile("ld.global.nc.L1::no_allocate.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p));
  return v;
}

// Off: the flat item offset type, 32 bits whenever the launch's items fit
// (the divisions below are then 32-bit).
template <typename Off>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const __grid_constant__ Params p) {
  const Off total = static_cast<Off>(p.total);
  const Off stride = static_cast<Off>(gridDim.x) * kThreads;
  for (Off t = static_cast<Off>(blockIdx.x) * kThreads + threadIdx.x;
       t < total; t += stride) {
    // The item's segment, output row and chunk.
    int s = 0;
#pragma unroll
    for (int j = 1; j < kMaxSegments; ++j) {
      s += static_cast<unsigned long long>(t) >= p.seg[j].begin;
    }
    const Segment& g = p.seg[s];
    const Off item = t - static_cast<Off>(g.begin);  // place in the output
    const Off i = item / static_cast<Off>(g.chunks);
    const Off chunk = item - i * static_cast<Off>(g.chunks);
    long long r = g.rows_are_64
                      ? __ldg(static_cast<const long long*>(g.rows) + i)
                      : static_cast<long long>(
                            __ldg(static_cast<const int*>(g.rows) + i));
    r = r < 0 ? 0 : r;
    r = r > g.last_row ? g.last_row : r;
    const long long at = r * g.chunks + static_cast<long long>(chunk);
    const int m = static_cast<int>(g.mask);
    if (g.vec) {
      int4 w = load_chunk(g.table + at * 16);
      w.x &= m;
      w.y &= m;
      w.z &= m;
      w.w &= m;
      reinterpret_cast<int4*>(g.out)[item] = w;
    } else {
      reinterpret_cast<int*>(g.out)[item] = load_word(g.table + at * 4) & m;
    }
  }
}

// Blocks of one resident wave of `kernel` on the current device: SMs x
// resident blocks a SM, computed at the first launch on each device and
// kept.
template <typename Off>
cudaError_t wave_blocks(long long* blocks) {
  constexpr int kMaxDevices = 64;
  static long long cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  long long wave = dev < kMaxDevices ? cached[dev] : 0;
  if (wave == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, row_gather_kernel<Off>, kThreads, 0);
    }
    if (err != cudaSuccess) return err;
    wave = static_cast<long long>(sms) * (per_sm < 1 ? 1 : per_sm);
    if (dev < kMaxDevices) cached[dev] = wave;
  }
  *blocks = wave;
  return cudaSuccess;
}

template <typename Off>
int launch(const Params& p, cudaStream_t stream) {
  long long wave = 0;
  const cudaError_t err = wave_blocks<Off>(&wave);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks =
      (static_cast<long long>(p.total) + kThreads - 1) / kThreads;
  if (blocks > wave) blocks = wave;
  row_gather_kernel<Off>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (bound with ctypes). `segs` holds n_seg (1..4) segments;
// a segment with n == 0 or width == 0 gathers nothing. Launches once on
// `stream` (not at all when no segment has work), does not synchronise,
// and returns cudaGetLastError() of the launch.
extern "C" int row_gather_launch(const RowGatherSegment* segs, int n_seg,
                                 void* stream) {
  if (n_seg < 1 || n_seg > kMaxSegments) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = {};
  unsigned long long total = 0;
  for (int s = 0; s < kMaxSegments; ++s) {
    Segment& g = p.seg[s];
    g.begin = ~0ull;
    if (s >= n_seg) continue;
    const RowGatherSegment& h = segs[s];
    if (h.n < 0 || h.width < 0 || (h.n > 0 && h.n_rows < 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(h.table) |
          reinterpret_cast<uintptr_t>(h.out)) & 15) == 0;
    g.vec = aligned && h.width % 4 == 0;
    g.chunks = static_cast<unsigned int>(g.vec ? h.width / 4 : h.width);
    g.table = static_cast<const char*>(h.table);
    g.rows = h.rows;
    g.out = static_cast<char*>(h.out);
    g.last_row = h.n_rows - 1;
    g.mask = h.mask;
    g.rows_are_64 = h.rows_are_64 != 0;
    g.begin = total;
    total += static_cast<unsigned long long>(h.n) * g.chunks;
  }
  // A segment with no items shares its begin with the next one; the
  // kernel's segment search then skips it.
  p.total = total;
  if (total == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total < (1ull << 31)) return launch<uint32_t>(p, s);
  return launch<unsigned long long>(p, s);
}
