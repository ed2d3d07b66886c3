// Store-stream probe: the obs-DMA skeleton of the fused rollout, for Hopper.
//
// Replaces the Pallas TPU kernel scripts/repro_mosaic_dma_tile.py::
// build_skeleton: each of ``steps`` steps writes k + j into row j of a
// 2-slot staging buffer and streams it to device memory, so that
//   out[k * rows + j, g * subl + s, l] = k + j
// for out u32 [steps * rows, grid * subl, lanes].  On the TPU ``grid`` is the
// number of programs; on the card it is only a shape: output row k*rows + j
// is ``width = grid*subl*lanes`` contiguous words, so the whole output is one
// contiguous run of words whose value depends on the row alone.
//
// Design: a persistent grid of about two blocks per SM (the SM count is read
// from the device) walks the output in chunks of one slot (16 KB), chunk c
// holding words [c * SLOT_WORDS, (c + 1) * SLOT_WORDS), block b taking chunks
// b, b + gridDim.x, ...  Each chunk is staged in a 4-slot ring in shared
// memory and stored by one TMA bulk copy (cp.async.bulk, bulk_store.cuh): the
// threads fill a slot with 16-byte vectors, one thread issues the copy, and a
// slot is refilled only when the copy issued three chunks earlier has read
// it.  The last chunk is ragged; its size is still a multiple of 16 bytes
// because width % 4 == 0.
//
// What bounds it: bytes.  It reads nothing and writes
// steps * rows * width * 4 bytes, at most 3.35 TB/s.  Every SM stores,
// whatever ``grid`` is, and each keeps up to 2 * 3 copies (96 KB) in flight.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (see ops/_cuda.py).  Plain C entry points, bound with
// ctypes; no PyTorch headers.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "bulk_store.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SLOTS = 4;
constexpr int SLOT_BYTES = 16384;
constexpr int SLOT_WORDS = SLOT_BYTES / 4;
constexpr int BLOCKS_PER_SM = 2;

__global__ void __launch_bounds__(THREADS) store_skeleton_kernel(
    uint32_t* __restrict__ out, long long total_words, int rows, int width) {
  extern __shared__ __align__(128) unsigned char smem[];
  bulk_store::BulkStoreRing<SLOTS, SLOT_BYTES> ring(smem);
  const long long chunks = (total_words + SLOT_WORDS - 1) / SLOT_WORDS;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    const long long w0 = c * SLOT_WORDS;
    const int words = (int)min((long long)SLOT_WORDS, total_words - w0);
    uint4* slot = reinterpret_cast<uint4*>(ring.acquire());
    // the chunk starts at column col0 of output row row0 = (k0, j0); a
    // 16-byte vector never straddles two rows (width % 4 == 0)
    const long long row0 = w0 / width;
    const int col0 = (int)(w0 - row0 * width);
    const int k0 = (int)(row0 / rows);
    const int j0 = (int)(row0 - (long long)k0 * rows);
    for (int v = threadIdx.x; v < words / 4; v += THREADS) {
      const int j = j0 + (col0 + 4 * v) / width;
      const int dk = j / rows;
      const uint32_t value = (uint32_t)(k0 + dk + (j - dk * rows));
      slot[v] = make_uint4(value, value, value, value);
    }
    ring.release(out + w0, (uint32_t)words * 4u);
  }
  ring.drain();
}

}  // namespace

extern "C" {

// Launch the probe on ``stream``; returns a CUDA error code (0 = ok).
// ``out`` is a device pointer to u32 [steps * rows, grid * subl, lanes];
// subl * lanes must be a multiple of 4 (16-byte vectors and copies).
int twixt_store_skeleton(void* out, int rows, int steps, int subl, int lanes, int grid,
                         void* stream) {
  const long long width = (long long)subl * lanes * grid;
  if (rows < 1 || steps < 0 || subl < 1 || lanes < 1 || grid < 1 ||
      ((long long)subl * lanes) % 4 != 0 || width > (1 << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(store_skeleton_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SLOTS * SLOT_BYTES);
  }
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)steps * rows * width;
  const long long chunks = (total + SLOT_WORDS - 1) / SLOT_WORDS;
  const int blocks = (int)std::max(1LL, std::min(chunks, (long long)BLOCKS_PER_SM * sms));
  store_skeleton_kernel<<<blocks, THREADS, SLOTS * SLOT_BYTES, (cudaStream_t)stream>>>(
      (uint32_t*)out, total, rows, (int)width);
  return (int)cudaGetLastError();
}

const char* twixt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
