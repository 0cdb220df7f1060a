// Host emulation of the CUDA constructs tigerbeetle_tpu_torch/csrc/
// create_seq.cu uses, so that g++ can build that source for the CPU and
// tests/test_torch_create_seq_host.py can run its kernels there. One
// launch is one block: a std::thread a CUDA thread, a std::barrier for
// __syncthreads and one a warp for the warp intrinsics (every lane of a
// warp must reach the same intrinsics in the same order, as the kernels'
// warp code does). cp.async is a plain copy (the test's source transform
// replaces the inline PTX), so a wait has nothing left to wait for.
#pragma once

#include <barrier>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __grid_constant__
#define __launch_bounds__(...)
#define __align__(x) alignas(x)

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
constexpr int kEmuSmemBytes = 232448;  // sm_90's dynamic shared memory

// A shared-memory size the card refuses is refused here too.
template <class F>
inline int cudaFuncSetAttribute(F, int, int bytes) {
  return bytes > kEmuSmemBytes ? 2 : 0;
}
inline int cudaGetLastError() { return 0; }

struct Dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local Dim3 threadIdx;
inline Dim3 blockDim;
alignas(16) inline unsigned char emu_smem[kEmuSmemBytes];
inline std::unique_ptr<std::barrier<>> emu_block_bar;
inline std::unique_ptr<std::barrier<>> emu_warp_bar[32];
inline uint64_t emu_xchg[32][32];

inline void __syncthreads() { emu_block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xFFFFFFFFu) {
  emu_warp_bar[threadIdx.x / 32]->arrive_and_wait();
}

// Every lane of the calling warp posts `mine`; returns lane `src`'s.
template <class T>
inline T emu_exchange(T mine, int src) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint64_t raw = 0;
  std::memcpy(&raw, &mine, sizeof(T));
  emu_xchg[w][lane] = raw;
  emu_warp_bar[w]->arrive_and_wait();
  T out;
  raw = emu_xchg[w][src];
  std::memcpy(&out, &raw, sizeof(T));
  emu_warp_bar[w]->arrive_and_wait();
  return out;
}

// The lanes whose posted value `keep(theirs, mine)` accepts, as a mask.
inline unsigned emu_lanes(uint64_t mine, bool (*keep)(uint64_t, uint64_t)) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  emu_xchg[w][lane] = mine;
  emu_warp_bar[w]->arrive_and_wait();
  unsigned m = 0;
  for (int k = 0; k < 32; ++k) {
    if (keep(emu_xchg[w][k], mine)) m |= 1u << k;
  }
  emu_warp_bar[w]->arrive_and_wait();
  return m;
}
inline bool emu_equal(uint64_t a, uint64_t b) { return a == b; }
inline bool emu_set(uint64_t a, uint64_t) { return a != 0; }

template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  return emu_exchange(v, src);
}
template <class T>
inline T __shfl_up_sync(unsigned, T v, int d) {
  const int lane = threadIdx.x % 32;
  return emu_exchange(v, lane >= d ? lane - d : lane);
}
inline unsigned __match_any_sync(unsigned, int v) {
  return emu_lanes(static_cast<uint64_t>(static_cast<int64_t>(v)),
                   emu_equal);
}
inline bool __any_sync(unsigned, bool p) { return emu_lanes(p, emu_set); }
inline unsigned __ballot_sync(unsigned, bool p) {
  return emu_lanes(p, emu_set);
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(int v) { return __builtin_ffs(v); }
inline unsigned __cvta_generic_to_shared(const void*) { return 0; }

// kernel<<<1, threads, ...>>>(args): one block, run to its end.
template <class K, class A>
inline void emu_launch(K kernel, int threads, const A& args) {
  blockDim.x = threads;
  emu_block_bar = std::make_unique<std::barrier<>>(threads);
  for (int w = 0; w < (threads + 31) / 32; ++w) {
    emu_warp_bar[w] = std::make_unique<std::barrier<>>(32);
  }
  std::vector<std::thread> block;
  for (int t = 0; t < threads; ++t) {
    block.emplace_back([&, t] {
      threadIdx.x = t;
      kernel(args);
    });
  }
  for (auto& th : block) th.join();
}
