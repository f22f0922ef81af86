// The tile design of the one-tick kernel (#1, tick_kernel.cu) and the K-tick
// kernel (#7, fused_tick_kernel.cu): a block of B threads runs a tile of B
// neighbouring groups, one thread a group, on a copy of part of the tile's
// working set in shared memory: the staged aux rows and the two §10 due
// planes.
//
// The state is groups-minor, so each (rows, G) tensor's slice for a tile is
// `rows` runs of B contiguous elements; in shared memory a tensor's slice
// sits as [row][lane] (a warp's 32 lanes on 32 neighbouring elements: no
// bank conflict), at the byte offset its Seg names in the tile buffer. A
// Plan lists the staged tensors (Segs) of one launch: the host fills it
// (the tick kernels' launchers) and the kernel reads it from its parameter
// space. A tile comes in in two ways, chosen per tensor by G, B and the
// dtype alone:
//
// - bulk: where every row of the tensor starts on a 16-byte boundary (its
//   base and G * dtype both multiples of 16: true at G = 102,400 for every
//   dtype) and the tile's row slice is a multiple of 16 bytes, the lanes of
//   warp 0 issue one cp.async.bulk a row against the buffer's mbarrier, all
//   before anyone waits (copy_floor.cu's pattern);
// - per thread: otherwise (G = 4,099; a ragged last tile of 8 int8
//   groups), each thread loads its own column of every row, eight rows in
//   flight, before the tile's wait.
//
// What the tile changed goes back the same way: the due-plane rows some
// thread of the tile wrote, flagged in shared memory as they are written.
// The bulk stores are drained before the block exits.
//
// The tile is 64 groups; the aux rows and the two due planes are what it
// stages. That is the variant the one-call A/Bs found fastest (PERF.md
// §6): 32 groups a tile, the state rows or all 13 slot planes staged
// too, the aux left in device memory and lowered register budgets all
// lost to it.
//
// Compiled with -DRAFT_HOST_STUB (the CPU rehearsal: g++ against a stub
// cuda_runtime.h, each block's threads run as host threads), the bulk
// copies are memcpy and the mbarrier a no-op: the per-thread path is taken
// exactly where the card takes it.

#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "tick_body.cuh"

namespace raft {
namespace tile {

constexpr int B = 64;
// The written-row flags of the two due planes: one byte a (plane, row).
constexpr int kFlags = 2 * N * N;

// One staged tensor. rows == 0: not staged.
struct Seg {
  char* g;         // device base of the (rows, G) tensor
  int off;         // byte offset of its [rows][B] slice in a tile buffer
  int16_t rows;
  int16_t flag0;   // wb: the written flag of its row 0
  int8_t es;       // bytes an element
  int8_t wb;       // 1: write back the flagged rows (else none)
  int8_t bulk;     // rows 16-byte aligned in device memory
  int8_t pad;
};

template <int kCap>
struct Plan {
  Seg seg[kCap];
  int nseg;
  int bytes;  // one tile buffer (a multiple of 128)
};

// Host: segment i of `pl` (added in index order): `rows` rows of `es`-byte
// elements of the (rows, G) tensor at `ptr` (null or rows 0: not staged).
template <int kCap>
inline void add_seg(Plan<kCap>& pl, int i, void* ptr, int rows, int es,
                    int wb, int flag0, long long G) {
  Seg& s = pl.seg[i];
  s.g = static_cast<char*>(ptr);
  s.rows = static_cast<int16_t>(ptr ? rows : 0);
  s.es = static_cast<int8_t>(es);
  s.wb = static_cast<int8_t>(wb);
  s.flag0 = static_cast<int16_t>(flag0);
  s.bulk = static_cast<int8_t>(
      (reinterpret_cast<uintptr_t>(ptr) % 16 == 0) && (G * es) % 16 == 0);
  s.pad = 0;
  s.off = pl.bytes;
  pl.bytes += (s.rows * B * es + 127) / 128 * 128;
  if (i + 1 > pl.nseg) pl.nseg = i + 1;
}

template <int kCap>
inline void clear(Plan<kCap>& pl) {
  std::memset(&pl, 0, sizeof(pl));
}

// Host: the bytes a group's staged rows take (`out`: only those written
// back, counted as if every row were).
template <int kCap>
inline long long group_bytes(const Plan<kCap>& pl, bool out) {
  long long n = 0;
  for (int i = 0; i < pl.nseg; ++i)
    if (!out || pl.seg[i].wb) n += pl.seg[i].rows * pl.seg[i].es;
  return n;
}

#ifdef RAFT_HOST_STUB
// The CPU rehearsal: a bulk copy is a memcpy by the issuing thread, done
// before the block's barrier that precedes every wait.
__device__ inline void bar_init(uint64_t*) {}
__device__ inline void bar_expect(uint64_t*, uint32_t) {}
__device__ inline void bar_wait(uint64_t*, uint32_t) {}
__device__ inline void bulk_g2s(void* dst, const void* src, uint32_t n,
                                uint64_t*) {
  std::memcpy(dst, src, n);
}
__device__ inline void bulk_s2g(void* dst, const void* src, uint32_t n) {
  std::memcpy(dst, src, n);
}
__device__ inline void bulk_commit() {}
__device__ inline void bulk_wait() {}
__device__ inline void fence_async() {}
inline void syncwarp() {}
#else
__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(saddr(b))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void bar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   saddr(b)),
               "r"(bytes)
               : "memory");
}
// Bounded: a phase that never completes (a miscounted transaction) traps,
// failing the launch, rather than spinning the card forever.
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = saddr(b);
  for (long long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1ll << 28)) __trap();
  }
}
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t n, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(saddr(dst)),
      "l"(src), "r"(n), "r"(saddr(b))
      : "memory");
}
__device__ __forceinline__ void bulk_s2g(void* dst, const void* src,
                                         uint32_t n) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::
                   "l"(dst),
               "r"(saddr(src)), "r"(n)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// Generic-proxy writes to shared memory made visible to the bulk stores.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void syncwarp() { __syncwarp(); }
#endif

// Host and device: the launchers count the bulk-copied tensors with it.
__host__ __device__ __forceinline__ bool bulk_ok(const Seg& s, int nb) {
  return s.rows > 0 && s.bulk && (nb * s.es) % 16 == 0;
}

// Warp 0: the bulk loads of a tile (groups g0 .. g0 + nb) into `buf`, on
// `bar` (one arrival, the bytes expected).
template <int kCap>
__device__ __forceinline__ void issue_loads(const Plan<kCap>& pl, char* buf,
                                            int64_t G, int64_t g0, int nb,
                                            uint64_t* bar) {
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  if (lane == 0) {
    uint32_t total = 0;
    for (int i = 0; i < pl.nseg; ++i)
      if (bulk_ok(pl.seg[i], nb))
        total += static_cast<uint32_t>(pl.seg[i].rows) * nb * pl.seg[i].es;
    bar_expect(bar, total);
  }
  syncwarp();
  for (int i = 0; i < pl.nseg; ++i) {
    const Seg& s = pl.seg[i];
    if (!bulk_ok(s, nb)) continue;
    for (int r = lane; r < s.rows; r += 32)
      bulk_g2s(buf + s.off + static_cast<int64_t>(r) * B * s.es,
               s.g + (static_cast<int64_t>(r) * G + g0) * s.es,
               static_cast<uint32_t>(nb * s.es), bar);
  }
}

template <typename T>
__device__ __forceinline__ void copy_rows(char* dst, int64_t dstride,
                                          const char* src, int64_t sstride,
                                          int rows) {
#pragma unroll 8
  for (int r = 0; r < rows; ++r)
    *reinterpret_cast<T*>(dst + r * dstride) =
        *reinterpret_cast<const T*>(src + r * sstride);
}

__device__ __forceinline__ void copy_col(char* dst, int64_t dstride,
                                         const char* src, int64_t sstride,
                                         int rows, int es) {
  if (es == 1) copy_rows<uint8_t>(dst, dstride, src, sstride, rows);
  else if (es == 2) copy_rows<uint16_t>(dst, dstride, src, sstride, rows);
  else copy_rows<uint32_t>(dst, dstride, src, sstride, rows);
}

// Every thread: its own column of each segment the bulk path does not take.
template <int kCap>
__device__ __forceinline__ void load_rest(const Plan<kCap>& pl, char* buf,
                                          int64_t G, int64_t g0, int nb) {
  const int lane = threadIdx.x;
  if (lane >= nb) return;
  for (int i = 0; i < pl.nseg; ++i) {
    const Seg& s = pl.seg[i];
    if (s.rows == 0 || bulk_ok(s, nb)) continue;
    copy_col(buf + s.off + lane * s.es, static_cast<int64_t>(B) * s.es,
             s.g + (g0 + lane) * s.es,
             G * s.es, s.rows, s.es);
  }
}

// After the tile's writes, a fence_async and a block barrier: every row to
// write back — bulk stores by warp 0's lanes (committed as one group each),
// the rest by each thread for its own column. `flags`: the written-row
// flags.
template <int kCap>
__device__ __forceinline__ void write_back(const Plan<kCap>& pl, char* buf,
                                           int64_t G, int64_t g0, int nb,
                                           const uint8_t* flags) {
  const int lane = threadIdx.x;
  if (lane < 32) {
    for (int i = 0; i < pl.nseg; ++i) {
      const Seg& s = pl.seg[i];
      if (s.wb == 0 || !bulk_ok(s, nb)) continue;
      for (int r = lane; r < s.rows; r += 32)
        if (flags[s.flag0 + r])
          bulk_s2g(s.g + (static_cast<int64_t>(r) * G + g0) * s.es,
                   buf + s.off + static_cast<int64_t>(r) * B * s.es,
                   static_cast<uint32_t>(nb * s.es));
    }
    bulk_commit();
  }
  if (lane >= nb) return;
  for (int i = 0; i < pl.nseg; ++i) {
    const Seg& s = pl.seg[i];
    if (s.wb == 0 || s.rows == 0 || bulk_ok(s, nb)) continue;
    for (int r = 0; r < s.rows; ++r) {
      if (!flags[s.flag0 + r]) continue;
      const char* src = buf + s.off + (static_cast<int64_t>(r) * B + lane) *
                                          s.es;
      char* dst = s.g + (static_cast<int64_t>(r) * G + g0 + lane) * s.es;
      if (s.es == 1) *reinterpret_cast<uint8_t*>(dst) =
          *reinterpret_cast<const uint8_t*>(src);
      else if (s.es == 2) *reinterpret_cast<uint16_t*>(dst) =
          *reinterpret_cast<const uint16_t*>(src);
      else *reinterpret_cast<uint32_t*>(dst) =
          *reinterpret_cast<const uint32_t*>(src);
    }
  }
}

// The §10 slots of a tile: the two due planes in the tile buffer (segments
// kDue0 and kDue0 + 1 of the plan, [row][lane]), every written row flagged;
// the payloads, and the logs, in device memory through Base (WideMem<LT>
// or PackedMem), whose `g` is the thread's group.
template <typename Base, int kDue0, int kCap>
struct TileMem : Base {
  char* buf;
  const Plan<kCap>* pl;
  uint8_t* flags;
  int lane;
  __device__ __forceinline__ char* due(Slot f) const {
    return buf + pl->seg[kDue0 + (f == AQ_DUE)].off;
  }
  __device__ __forceinline__ int get(Slot f, int q) const {
    if (f != VQ_DUE && f != AQ_DUE) return Base::get(f, q);
    if constexpr (Base::kPacked)
      return ld_w(due(f), this->k.narrow8 & W8_DUE, q * B + lane);
    else
      return reinterpret_cast<const int16_t*>(due(f))[q * B + lane];
  }
  __device__ __forceinline__ void put(Slot f, int q, int v) {
    if (f != VQ_DUE && f != AQ_DUE) {
      Base::put(f, q, v);
      return;
    }
    if constexpr (Base::kPacked)
      st_w(due(f), this->k.narrow8 & W8_DUE, q * B + lane, v, this->ov);
    else
      reinterpret_cast<int16_t*>(due(f))[q * B + lane] =
          static_cast<int16_t>(v);
    flags[(f == AQ_DUE) * N * N + q] = 1;
  }
};

// Element bytes and rows of a staged tensor. rows: 1 = N, 2 = N*N, 4 =
// one. es < 0: a narrow field, int8 where the -es bit of Consts::narrow8 is
// set, else int16.
struct FieldShape {
  int8_t es, rows;
};

inline int shape_rows(FieldShape f) {
  return f.rows == 1 ? N : f.rows == 2 ? N * N : 1;
}
inline int shape_es(FieldShape f, int narrow8) {
  return f.es > 0 ? f.es : ((narrow8 & -f.es) ? 1 : 2);
}

template <typename Kern>
inline cudaError_t resident_blocks(Kern kern, int threads, size_t smem,
                                   int* out) {
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kern, threads, smem);
  if (e != cudaSuccess) return e;
  return *out < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

template <typename Kern>
inline cudaError_t describe(Kern kern, int threads, size_t smem,
                            long long* info) {
  int resident = 0;
  cudaError_t e = resident_blocks(kern, threads, smem, &resident);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, kern);
  if (e != cudaSuccess) return e;
  info[1] = threads;
  info[2] = static_cast<long long>(smem);
  info[3] = resident;
  info[4] = a.numRegs;
  info[5] = static_cast<long long>(a.localSizeBytes);
  return cudaSuccess;
}

}  // namespace tile
}  // namespace raft
