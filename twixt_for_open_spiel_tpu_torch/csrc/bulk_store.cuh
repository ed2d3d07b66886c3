// A ring of shared-memory slots drained to device memory by TMA bulk copies.
//
// The Hopper counterpart of a Pallas TPU kernel's double-buffered output
// stream (pltpu.make_async_copy into device memory, one DMA semaphore per
// slot): the block's threads fill a slot, one thread hands it to the Tensor
// Memory Accelerator with cp.async.bulk (a contiguous byte range, no tensor
// map), and the slot is refilled only once the copy has read it.  While a
// slot drains, the block fills the next; up to SLOTS - 1 copies stay in
// flight per block.
//
// Use, by every thread of the block, in the same order:
//
//   BulkStoreRing<SLOTS, SLOT_BYTES> ring(shared_base);   // SLOTS*SLOT_BYTES
//   for each piece of output:
//     unsigned char* slot = ring.acquire();   // barrier; the slot is free
//     ... write up to SLOT_BYTES into slot ...
//     ring.release(global_dst, bytes);        // barrier; thread 0 stores it
//   ring.drain();                             // before the block exits
//
// Bulk-copy groups belong to the thread that commits them, so thread 0
// issues, commits and waits for every copy.  ``bytes`` and both addresses
// must be multiples of 16; ``shared_base`` 128-byte aligned.
//
// A tile whose rows are not contiguous in device memory goes out instead by
// copy_tensor_2d (a TMA tensor copy through a CUtensorMap), in the same bulk
// groups: fence_shared_to_async, a barrier, then one thread copies, commits
// and later waits (wait_read before the slot is refilled, wait_all at exit).

#pragma once

#include <stdint.h>

namespace bulk_store {

// Make this thread's shared-memory writes visible to the async proxy (the
// TMA reads the slot through it).
__device__ __forceinline__ void fence_shared_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One bulk copy of ``bytes`` from shared memory to device memory, added to
// the calling thread's current bulk group.
__device__ __forceinline__ void copy(void* dst, const void* src, uint32_t bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(src));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(s), "r"(bytes) : "memory");
}

// One TMA tensor copy of a 2-D box from shared memory to device memory, at
// element coordinates (x innermost, y) of the tensor map ``map`` (the address
// of a __grid_constant__ CUtensorMap kernel parameter), added to the calling
// thread's current bulk group.  The part of the box outside the tensor is
// not stored.  ``src`` must be 128-byte aligned.
__device__ __forceinline__ void copy_tensor_2d(const void* map, const void* src, int x, int y) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(src));
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)), "r"(s), "r"(x), "r"(y) : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// Wait until every bulk group of this thread has completed.
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int SLOTS, int SLOT_BYTES>
struct BulkStoreRing {
  static_assert(SLOTS >= 2, "a ring needs a slot to fill while one drains");
  static_assert(SLOT_BYTES % 16 == 0, "bulk copies move multiples of 16 bytes");

  unsigned char* base;
  int next = 0;

  __device__ explicit BulkStoreRing(unsigned char* shared_base) : base(shared_base) {}

  // The next slot, once the copy that last read it is done with it.
  __device__ unsigned char* acquire() {
    if (threadIdx.x == 0) wait_read<SLOTS - 1>();
    __syncthreads();
    return base + (next % SLOTS) * SLOT_BYTES;
  }

  // Store ``bytes`` of the slot just filled at ``dst``.
  __device__ void release(void* dst, uint32_t bytes) {
    fence_shared_to_async();
    __syncthreads();
    if (threadIdx.x == 0) {
      copy(dst, base + (next % SLOTS) * SLOT_BYTES, bytes);
      commit();
    }
    ++next;
  }

  // Every copy done: the slots may be freed.
  __device__ void drain() {
    if (threadIdx.x == 0) wait_all();
    __syncthreads();
  }
};

}  // namespace bulk_store
