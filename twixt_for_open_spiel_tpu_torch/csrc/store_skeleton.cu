// Store-stream probe: the obs-DMA skeleton of the fused rollout, for Hopper.
//
// Replaces the Pallas TPU kernel scripts/repro_mosaic_dma_tile.py::
// build_skeleton: each of ``steps`` steps writes k + j into row j of a
// 2-slot staging buffer and streams it to device memory, so that
//   out[k * rows + j, g * subl + s, l] = k + j
// for out u32 [steps * rows, grid * subl, lanes].  The TPU kernel streams
// each step's slab with double-buffered async DMA; here one block runs one
// grid program, fills a 2-slot staging buffer in shared memory one word per
// thread, and stores it to device memory with coalesced 16-byte stores.
// The fill and the store map words to threads differently, so the slot is
// a real hand-off (one barrier per chunk; with two slots the next chunk's
// fill never overwrites a slot still being stored).
//
// Its job is a yardstick: the rate at which this store pattern reaches
// device memory, beside the obs stream of the fused bitboard rollout (same
// [T, 12*P, B] shape at board 24).  What bounds it: bytes.  It reads
// nothing and writes steps * rows * grid * subl * lanes * 4 bytes, at most
// 3.35 TB/s; how near it gets depends on how many SMs have a block (one per
// grid program) and on the stores in flight per SM.  Plain stores here;
// TMA bulk stores (cp.async.bulk) are later work (PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (see ops/_cuda.py).  Plain C entry points, bound with
// ctypes; no PyTorch headers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SLOT_WORDS = 4096;  // 16 KB a slot, two slots
constexpr int WORDS_PER_THREAD = SLOT_WORDS / THREADS;
constexpr int VECS_PER_THREAD = WORDS_PER_THREAD / 4;

// One chunk is a block of ``ch`` whole rows of this program's ``width``
// words, or (when a row is wider than a slot) a ``cw``-word piece of one
// row; a word's place in a chunk is (row r, column c), slot index r*cw + c.
__global__ void __launch_bounds__(THREADS) store_skeleton_kernel(
    uint32_t* __restrict__ out, int rows, int steps, int width, int grid) {
  __shared__ __align__(16) uint32_t stage[2][SLOT_WORDS];
  const int g = blockIdx.x;
  const int cw = min(width, SLOT_WORDS);
  const int ch = SLOT_WORDS / cw;
  const long long row_stride = (long long)grid * width;

  // each thread's fixed words of a chunk: fill word i = tid + t * THREADS;
  // store vector v = tid + t * THREADS (words 4v .. 4v+3)
  int fill_r[WORDS_PER_THREAD];
#pragma unroll
  for (int t = 0; t < WORDS_PER_THREAD; ++t) fill_r[t] = (threadIdx.x + t * THREADS) / cw;
  int vec_r[VECS_PER_THREAD], vec_c[VECS_PER_THREAD];
#pragma unroll
  for (int t = 0; t < VECS_PER_THREAD; ++t) {
    const int w = 4 * (threadIdx.x + t * THREADS);
    vec_r[t] = w / cw;
    vec_c[t] = w - vec_r[t] * cw;
  }

  int chunk = 0;
  for (int k = 0; k < steps; ++k) {
    for (int j0 = 0; j0 < rows; j0 += ch) {
      const int nr = min(ch, rows - j0);
      for (int c0 = 0; c0 < width; c0 += cw, ++chunk) {
        const int nc = min(cw, width - c0);
        uint32_t* slot = stage[chunk & 1];
#pragma unroll
        for (int t = 0; t < WORDS_PER_THREAD; ++t) {
          // a word whose row lies past the chunk is never stored
          if (fill_r[t] < nr) slot[threadIdx.x + t * THREADS] = (uint32_t)(k + j0 + fill_r[t]);
        }
        __syncthreads();
        const uint4* vslot = reinterpret_cast<const uint4*>(slot);
#pragma unroll
        for (int t = 0; t < VECS_PER_THREAD; ++t) {
          if (vec_r[t] < nr && vec_c[t] < nc) {
            const long long row = (long long)k * rows + j0 + vec_r[t];
            uint4* dst = reinterpret_cast<uint4*>(out + row * row_stride +
                                                  (long long)g * width + c0 + vec_c[t]);
            *dst = vslot[threadIdx.x + t * THREADS];
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Launch the probe on ``stream``; returns cudaGetLastError() (0 = ok).
// ``out`` is a device pointer to u32 [steps * rows, grid * subl, lanes];
// subl * lanes must be a multiple of 4 (16-byte stores).
int twixt_store_skeleton(void* out, int rows, int steps, int subl, int lanes, int grid,
                         void* stream) {
  const long long width = (long long)subl * lanes;
  if (rows < 1 || steps < 0 || subl < 1 || lanes < 1 || grid < 1 || width % 4 != 0 ||
      width > (1 << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  store_skeleton_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, rows, steps, (int)width, grid);
  return (int)cudaGetLastError();
}

const char* twixt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
