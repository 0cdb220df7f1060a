// Fused two-choice hash probe for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ht_lookup_fused`
// (tigerbeetle_tpu/ops/pallas_kernels.py:80, body `_probe_kernel` :57)
// and computes exactly what its plain PyTorch twin
// `tigerbeetle_tpu_torch/ops/hash_table.py::ht_lookup` computes:
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
// What bounds it on an H100: bytes. Each query reads its 16-byte key,
// the 128-byte key halves of two random bucket rows, one 32-byte sector
// of vals when it hits, and writes 5 bytes, so N = 16384 queries move
// ~4.7 MB: ~1.4 us at 3.35 TB/s, less than a launch. The transfer table at the default capacities is ~201 MB, past
// the 50 MB L2 and far past shared memory, so the TPU design (the whole
// table resident in VMEM behind a 12 MiB gate) does not carry over: the
// rows are read straight from device memory.
//
// Design: one 8-lane group per query, lane = slot. A group's 8 lanes
// read the 8 consecutive u64 of a column group together (one 64-byte
// coalesced segment), the val column is read only by lanes whose slot
// matched, and the hit/max reduction is three __shfl_xor_sync steps.
// Eight threads per query keep ~130k threads in flight at N = 16384,
// enough independent loads to cover device-memory latency for a batch
// this small, where one thread per query would leave most SMs idle.
// The hash is computed in the kernel (native uint64_t: multiplications
// wrap, shifts are logical), so no bucket-index tensors are made.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 8;
constexpr int kRowWords = 3 * kSlots;
constexpr int kThreads = 256;

constexpr uint64_t kC1 = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kC2 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t kC3 = 0xD6E8FEB86659FD93ull;
constexpr uint64_t kC4 = 0x2545F4914F6CDD1Dull;

// Probe one bucket row for this lane's slot; returns the group-wide
// (hit, max lane value). Every lane of the warp calls it (no early exit),
// so the full-mask shuffles are well defined.
__device__ __forceinline__ void probe_row(const uint64_t* __restrict__ row,
                                          int slot, uint64_t k_hi,
                                          uint64_t k_lo, bool querying,
                                          int* hit, int* lane_val) {
  const uint64_t s_hi = row[slot];
  const uint64_t s_lo = row[kSlots + slot];
  const bool match = querying && s_hi == k_hi && s_lo == k_lo;
  int h = match ? 1 : 0;
  int v = match ? static_cast<int32_t>(row[2 * kSlots + slot]) : -1;
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) {
    h |= __shfl_xor_sync(0xffffffffu, h, off);
    v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  *hit = h;
  *lane_val = v;
}

__global__ void __launch_bounds__(kThreads)
ht_probe_kernel(const uint64_t* __restrict__ packed, uint64_t n_buckets,
                const uint64_t* __restrict__ k_hi_in,
                const uint64_t* __restrict__ k_lo_in, int64_t n,
                bool* __restrict__ found_out, int32_t* __restrict__ val_out) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t q = tid >> 3;
  const int slot = static_cast<int>(tid & 7);
  const bool active = q < n;
  // Inactive lanes (the grid's ragged tail) probe bucket 0 with the
  // empty key, which matches nothing, and store nothing.
  const uint64_t k_hi = active ? k_hi_in[q] : 0;
  const uint64_t k_lo = active ? k_lo_in[q] : 0;
  const bool querying = !(k_hi == 0 && k_lo == 0);

  uint64_t h1 = (k_lo ^ (k_hi * kC1)) * kC2;
  h1 ^= h1 >> 31;
  uint64_t h2 = (k_hi ^ (k_lo * kC3)) * kC4;
  h2 ^= h2 >> 29;
  const uint64_t mask = n_buckets - 1;
  const uint64_t b1 = h1 & mask;
  const uint64_t b2 = h2 & mask;

  int hit1, val1, hit2, val2;
  probe_row(packed + b1 * kRowWords, slot, k_hi, k_lo, querying, &hit1,
            &val1);
  probe_row(packed + b2 * kRowWords, slot, k_hi, k_lo, querying, &hit2,
            &val2);
  int32_t val = -1;
  if (hit1) val = val1;
  if (hit2) val = val2;
  if (active && slot == 0) {
    found_out[q] = (hit1 | hit2) != 0;
    val_out[q] = val;
  }
}

}  // namespace

// C entry point (bound with ctypes). `n_buckets` is B, a power of two;
// the table holds B + 1 rows. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() of the launch.
extern "C" int ht_probe_launch(const void* packed, long long n_buckets,
                               const void* k_hi, const void* k_lo,
                               long long n, void* found, void* val,
                               void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const long long threads_total = n * kSlots;
  const unsigned int blocks =
      static_cast<unsigned int>((threads_total + kThreads - 1) / kThreads);
  ht_probe_kernel<<<blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(packed),
      static_cast<uint64_t>(n_buckets),
      static_cast<const uint64_t*>(k_hi), static_cast<const uint64_t*>(k_lo),
      static_cast<int64_t>(n), static_cast<bool*>(found),
      static_cast<int32_t*>(val));
  return static_cast<int>(cudaGetLastError());
}
