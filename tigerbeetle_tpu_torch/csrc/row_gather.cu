// Row gather for Hopper (sm_90a): out[i, :] = table[clamp(rows[i]), :] & mask.
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
// and computes exactly what its plain PyTorch twin
// `tigerbeetle_tpu_torch/ops/row_gather.py::row_gather_plain` computes:
//   table[rows.clamp(0, B - 1)] & mask
// (the clamp is JAX's `x[rows]` semantics). On the port's main path it
// gathers the account and transfer rows of create_transfers (the u64
// stores viewed as u32 pairs, which is what the probes were written for).
//
// What bounds it on an H100: bytes. The function moves no arithmetic to
// speak of; it reads each gathered row once (in 32-byte sectors), reads
// the indexes once and writes the output once. So the design only has
// to keep loads wide and many in flight:
//   - one thread per 16-byte chunk of an output row (int4 loads and
//     stores) when the row's byte width is a multiple of 16 and both
//     pointers are 16-byte aligned; otherwise one thread per 32-bit word;
//   - neighbouring threads take neighbouring chunks of one row, so a
//     row's read and its output write are each one coalesced segment;
//   - a grid-stride loop over (row, chunk), the mask applied per word.
// No shared memory: each gathered row is used by one output row only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;  // 16 resident blocks a SM

template <typename Index>
__device__ __forceinline__ long long clamp_row(const Index* rows, long long i,
                                               long long n_rows) {
  long long r = static_cast<long long>(rows[i]);
  r = r < 0 ? 0 : r;
  return r >= n_rows ? n_rows - 1 : r;
}

template <typename Index>
__global__ void __launch_bounds__(kThreads)
row_gather_vec4(const int4* __restrict__ table, long long n_rows,
                long long chunks, const Index* __restrict__ rows,
                long long n, unsigned int mask, int4* __restrict__ out) {
  const long long total = n * chunks;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int m = static_cast<int>(mask);
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    const long long i = t / chunks;
    const long long c = t - i * chunks;
    const long long r = clamp_row(rows, i, n_rows);
    int4 v = table[r * chunks + c];
    v.x &= m;
    v.y &= m;
    v.z &= m;
    v.w &= m;
    out[t] = v;
  }
}

template <typename Index>
__global__ void __launch_bounds__(kThreads)
row_gather_word(const unsigned int* __restrict__ table, long long n_rows,
                long long width, const Index* __restrict__ rows, long long n,
                unsigned int mask, unsigned int* __restrict__ out) {
  const long long total = n * width;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    const long long i = t / width;
    const long long c = t - i * width;
    const long long r = clamp_row(rows, i, n_rows);
    out[t] = table[r * width + c] & mask;
  }
}

unsigned int grid_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned int>(blocks < 1 ? 1 : blocks);
}

template <typename Index>
int launch(const void* table, long long n_rows, long long width,
           const void* rows, long long n, unsigned int mask, void* out,
           cudaStream_t stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(table) |
        reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (aligned && width % 4 == 0) {
    const long long chunks = width / 4;
    row_gather_vec4<Index><<<grid_for(n * chunks), kThreads, 0, stream>>>(
        static_cast<const int4*>(table), n_rows, chunks,
        static_cast<const Index*>(rows), n, mask, static_cast<int4*>(out));
  } else {
    row_gather_word<Index><<<grid_for(n * width), kThreads, 0, stream>>>(
        static_cast<const unsigned int*>(table), n_rows, width,
        static_cast<const Index*>(rows), n, mask,
        static_cast<unsigned int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (bound with ctypes). `table` is a contiguous (n_rows,
// width) array of 32-bit words, `rows` n int32 (rows_are_64 == 0) or
// int64 indexes, `out` a contiguous (n, width) array of 32-bit words.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launch.
extern "C" int row_gather_launch(const void* table, long long n_rows,
                                 long long width, const void* rows,
                                 int rows_are_64, long long n,
                                 unsigned int mask, void* out, void* stream) {
  if (n <= 0 || width <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows_are_64) {
    return launch<int64_t>(table, n_rows, width, rows, n, mask, out, s);
  }
  return launch<int32_t>(table, n_rows, width, rows, n, mask, out, s);
}
