// A stand-in for <cuda_runtime.h> that lets the port's CUDA sources
// (tpt_torch/csrc/*.cu) compile with a host C++20 compiler and run on the
// CPU, so a test can hold a kernel's own source against the plain PyTorch
// version without a card (tests/test_torch_csrc_emu.py,
// tests/test_torch_csrc_emu_treelet.py, tests/test_torch_csrc_emu_svgf.py).
//
// A launch runs its blocks one after another (grids and blocks of up to
// three dimensions; the warps divide a block's threads in linear order).
// The threads of a block are
// fibers on the calling thread (started with ucontext, then switched with
// _setjmp/_longjmp, which skip swapcontext's signal-mask system calls),
// run one at a time: a thread runs until it waits on a barrier, then the
// next runnable one runs, so no OS thread is created and a loaded machine
// does not slow the barriers down. __shared__ variables become
// function-local statics, which the threads of the running block share.
// __syncthreads is a barrier over the block, and __syncthreads_or/_count
// block-wide votes through the same per-thread exchange words. Dynamic
// shared memory (DYNAMIC_SHARED, which a source uses in place of its
// extern __shared__ array) is one static buffer of a block's largest
// size. The warp intrinsics (shuffles, votes, reductions) exchange values through a per-block array between two
// waits on a barrier of the threads named in the mask (one barrier per
// warp and mask), so every thread of the mask must call them, as CUDA
// requires. __ldg is a plain load. The emulated card has 2 SMs of one
// resident block each (the occupancy queries). Inline PTX sits under
// __CUDA_ARCH__ in the sources and is not compiled here. The sources are compiled with
// -ffp-contract=off, so float arithmetic rounds as the card's does with
// -fmad=false; launches are rewritten from k<<<grid, block, smem,
// stream>>>(args) to emu_launch(grid, block, [&] { k(args); }) by the
// test.

#pragma once

#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <setjmp.h>
#include <ucontext.h>

#include <algorithm>
#include <functional>
#include <map>
#include <memory>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define DYNAMIC_SHARED (emu::dynamic_shared())

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };

struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() = default;
  dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

struct cudaFuncAttributes {
  int numRegs = 0, maxThreadsPerBlock = 0;
  size_t localSizeBytes = 0, sharedSizeBytes = 0;
};
template <class T>
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, T) {
  *a = cudaFuncAttributes{};
  return cudaSuccess;
}
template <class T>
inline cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// the emulated card: 2 SMs that hold one block each, so a launch sized
// to one wave of resident blocks is smaller than most test pools
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 2;
  return cudaSuccess;
}
template <class T>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, T, int, size_t) {
  *n = 1;
  return cudaSuccess;
}

inline dim3 threadIdx, blockIdx, blockDim, gridDim;

using std::max;
using std::min;
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(unsigned v) { return __builtin_ffs((int)v); }
inline int __clz(unsigned v) { return v ? __builtin_clz(v) : 32; }
inline float __int_as_float(int v) {
  float f;
  memcpy(&f, &v, 4);
  return f;
}
inline int __float_as_int(float v) {
  int i;
  memcpy(&i, &v, 4);
  return i;
}
template <class T>
inline T __ldg(const T* p) { return *p; }

namespace emu {

struct Barrier {
  int needed = 0, arrived = 0;
  unsigned long long gen = 0;
};

struct Fiber {
  ucontext_t ctx;   // the fiber's first entry
  jmp_buf jb;       // where it waits
  std::unique_ptr<char[]> stack;
  bool started = false, done = false;
  const Barrier* wait = nullptr;  // the barrier it waits on, if any
  unsigned long long wait_gen = 0;
};

constexpr size_t kStack = 64 * 1024;  // a kernel's frames and arrays

struct Block {
  std::vector<Fiber> fibers;
  Barrier all;
  std::map<std::pair<int, unsigned>, Barrier> masks;
  std::vector<unsigned long long> slot;  // one exchange word a thread
  ucontext_t sched;
  jmp_buf sched_jb;  // the scheduler, between two fibers' turns
  int cur = 0;
  std::function<void()> body;
};

inline Block* current = nullptr;  // the block that runs now

// a block's dynamic shared memory (CUDA's most: 227 KB)
inline unsigned char* dynamic_shared() {
  alignas(16) static unsigned char buf[232448];
  return buf;
}

// the thread's linear index in its block, which the warps divide
inline int tid() {
  return (int)(threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y *
                                           threadIdx.z));
}

inline int lane() { return tid() & 31; }

// arrive at `b` and wait until every thread it names has arrived
inline void wait(Barrier& b) {
  const unsigned long long g = b.gen;
  if (++b.arrived == b.needed) {
    b.arrived = 0;
    ++b.gen;
    return;
  }
  Fiber& f = current->fibers[current->cur];
  f.wait = &b;
  f.wait_gen = g;
  // _setjmp/_longjmp switch without swapcontext's signal-mask syscalls
  if (!_setjmp(f.jb)) _longjmp(current->sched_jb, 1);
  f.wait = nullptr;
}

inline Barrier& mask_barrier(unsigned mask) {
  const int warp = tid() >> 5;
  Barrier& b = current->masks[{warp, mask}];
  if (!b.needed) b.needed = __builtin_popcount(mask);
  return b;
}

// every thread of `mask` posts `v`; returns the word lane `src` posted
template <class T>
inline unsigned long long exchange(unsigned mask, T v, int src) {
  unsigned long long w = 0;
  memcpy(&w, &v, sizeof(T));
  Barrier& bar = mask_barrier(mask);
  const int base = tid() & ~31;
  current->slot[tid()] = w;
  wait(bar);
  const unsigned long long r = current->slot[base + src];
  wait(bar);
  return r;
}

// every thread of `mask` posts `v`; returns f over the mask's lanes
template <class T, class F>
inline T gather(unsigned mask, T v, F f) {
  unsigned long long w = 0;
  memcpy(&w, &v, sizeof(T));
  Barrier& bar = mask_barrier(mask);
  const int base = tid() & ~31;
  current->slot[tid()] = w;
  wait(bar);
  T acc{};
  bool first = true;
  for (int k = 0; k < 32; ++k) {
    if (!(mask >> k & 1u)) continue;
    T x;
    memcpy(&x, &current->slot[base + k], sizeof(T));
    acc = first ? x : f(acc, x, k);
    first = false;
  }
  wait(bar);
  return acc;
}

inline void fiber_main() {
  current->body();
  current->fibers[current->cur].done = true;
  _longjmp(current->sched_jb, 1);
}

}  // namespace emu

template <class T>
inline T __shfl_sync(unsigned mask, T v, int src) {
  const unsigned long long w = emu::exchange(mask, v, src & 31);
  T r;
  memcpy(&r, &w, sizeof(T));
  return r;
}
template <class T>
inline T __shfl_xor_sync(unsigned mask, T v, int off) {
  const unsigned long long w = emu::exchange(mask, v, (emu::lane() ^ off) & 31);
  T r;
  memcpy(&r, &w, sizeof(T));
  return r;
}
inline unsigned __ballot_sync(unsigned mask, bool p) {
  const unsigned bit = p ? 1u << emu::lane() : 0u;
  return emu::gather(mask, bit, [](unsigned a, unsigned b, int) {
    return a | b;
  });
}
inline bool __any_sync(unsigned mask, bool p) {
  return __ballot_sync(mask, p) != 0;
}
inline unsigned __reduce_or_sync(unsigned mask, unsigned v) {
  return emu::gather(mask, v, [](unsigned a, unsigned b, int) {
    return a | b;
  });
}
inline unsigned __reduce_min_sync(unsigned mask, unsigned v) {
  return emu::gather(mask, v, [](unsigned a, unsigned b, int) {
    return a < b ? a : b;
  });
}
inline int __reduce_add_sync(unsigned mask, int v) {
  return emu::gather(mask, v, [](int a, int b, int) { return a + b; });
}
inline void __syncthreads() { emu::wait(emu::current->all); }

namespace emu {
// every thread of the block posts `p`; returns the count of non-zero ones
inline int block_count(int p) {
  current->slot[tid()] = p != 0;
  wait(current->all);
  int n = 0;
  for (unsigned long long w : current->slot) n += (int)w;
  wait(current->all);
  return n;
}
}  // namespace emu

inline int __syncthreads_count(int p) { return emu::block_count(p); }
inline int __syncthreads_or(int p) { return emu::block_count(p) != 0; }

// one thread runs at a time, so atomics are plain read-modify-writes
inline int atomicAdd(int* p, int v) {
  const int old = *p;
  *p += v;
  return old;
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  const unsigned long long old = *p;
  *p += v;
  return old;
}
inline unsigned atomicOr(unsigned* p, unsigned v) {
  const unsigned old = *p;
  *p |= v;
  return old;
}
template <class T>
inline T atomicMin(T* p, T v) {
  const T old = *p;
  *p = v < old ? v : old;
  return old;
}
template <class T>
inline T atomicMax(T* p, T v) {
  const T old = *p;
  *p = v > old ? v : old;
  return old;
}

// runs `f` as the kernel body of every thread of a grid x block launch:
// a block's threads are fibers, resumed in turn, each until it waits on a
// barrier that is not yet complete or ends
template <class F>
inline void emu_launch(dim3 grid, dim3 block, F f) {
  const int nt = (int)(block.x * block.y * block.z);
  blockDim = block;
  gridDim = grid;
  const unsigned nb = grid.x * grid.y * grid.z;
  for (unsigned b = 0; b < nb; ++b) {
    emu::Block blk;
    blk.fibers.resize(nt);
    blk.all.needed = nt;
    blk.slot.assign(nt, 0);
    blk.body = f;
    emu::current = &blk;
    blockIdx = dim3(b % grid.x, b / grid.x % grid.y, b / (grid.x * grid.y));
    for (auto& fb : blk.fibers) {
      fb.stack.reset(new char[emu::kStack]);
      getcontext(&fb.ctx);
      fb.ctx.uc_stack.ss_sp = fb.stack.get();
      fb.ctx.uc_stack.ss_size = emu::kStack;
      fb.ctx.uc_link = &blk.sched;
      makecontext(&fb.ctx, emu::fiber_main, 0);
    }
    for (bool left = true; left;) {
      left = false;
      bool ran = false;
      for (int t = 0; t < nt; ++t) {
        emu::Fiber& fb = blk.fibers[t];
        if (fb.done) continue;
        left = true;
        if (fb.wait && fb.wait->gen == fb.wait_gen) continue;
        blk.cur = t;
        threadIdx = dim3(t % block.x, t / block.x % block.y,
                         t / (block.x * block.y));
        if (!_setjmp(blk.sched_jb)) {
          if (fb.started) {
            _longjmp(fb.jb, 1);
          } else {
            fb.started = true;
            swapcontext(&blk.sched, &fb.ctx);
          }
        }
        ran = true;
      }
      if (left && !ran) {
        fprintf(stderr, "emu_launch: every thread of block %u waits\n", b);
        abort();
      }
    }
    emu::current = nullptr;
  }
}
