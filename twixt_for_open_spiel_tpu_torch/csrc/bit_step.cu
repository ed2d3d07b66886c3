// One lockstep engine step over slot-indexed state, for Hopper (S1a).
//
// Not a TPU kernel: inside the JAX search's jitted simulation XLA fuses the
// node-state gather (twixt_for_open_spiel_tpu/models/mcts.py:191
// _gather_node_state), the bitboard step (ops/bitboard.py:276 step_bits),
// the new mover's legal mask (bit_legal_mask_flat) and the slot write
// (mcts.py:228 _set_node_state) into device code.  The port ran those as
// about 1,450 small torch ops a step; an H100 profile of the search named
// them (PERF.md §5), so they are one kernel here.  The same kernel is the
// port's plain lockstep step (ops/bitboard.py::step_bits on CUDA tensors):
// one source slot, one destination slot.
//
// Semantics: ops/bit_step.py::bit_step_reference (the plain torch version)
// and bit-identical to it; the step is csrc/bit_step.cuh, which K1 shares.
//
// Layout in device memory (env trailing, the search tree's node buffers):
//   planes   u32 [S_in, 16, P, B]   compid i16 [S_in, n, n, B]
//   scalars  i32 [S_in, 5, B]       src    i64 [B] (null: slot 0 everywhere)
//   action   i64 [B]
//   out_*    the same layout with S_out slots: slot ``dst`` of every env
//   legal    bool [B, n*n] the new mover's legal mask, ascending action
//            order (null: not written)
// The source and destination buffers may be the same tensors (the search
// writes the child into the tree it reads the parent from): a block reads
// every slot its envs need into shared memory before any of them is
// written, and an env's column is touched by its own block only.
//
// Design.  A block holds ENVS_PER_BLOCK envs, one warp each, as K1 does: the
// block copies its envs' source slots (16 P words and n*n halves an env)
// into shared memory, env fastest, each warp runs bit_step.cuh's step_bits
// on its env with the scalars in registers, and the block copies the
// stepped states to the destination slot; each warp then writes its env's
// legal mask, lane-parallel over the n*n actions.  A slot index outside
// [0, S_in) traps, as torch's device-side index check does.
//
// What bounds it on this card: at the search's shapes (board 12, B=512) it
// moves about 1.5 MB, under a microsecond at 3.35 TB/s, so the launch and
// the step's dependent shared-memory latency set its time.  The [.., B]
// rows are read and written a word an env (a 32-byte sector for 4 bytes
// where the envs' slots differ); coalescing them is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (see ops/_cuda.py).  Plain C entry points, bound with
// ctypes; no PyTorch headers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bit_step.cuh"

namespace {

using namespace twixt;

constexpr int ENVS_PER_BLOCK = 4;

__host__ __device__ constexpr int shared_bytes(int n) {
  return geo_bytes() + ENVS_PER_BLOCK * env_bytes(n);
}

__global__ void __launch_bounds__(ENVS_PER_BLOCK * WARP) bit_step_kernel(
    const uint32_t* planes, const short* compid, const int* scalars, const long long* src,
    const long long* action, uint32_t* out_planes, short* out_compid, int* out_scalars,
    int dst, bool* legal, const int* __restrict__ geo_table, int n, int batch, int slots_in) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long s_src[ENVS_PER_BLOCK];
  const int p = n + 2 * PAD;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int env0 = blockIdx.x * ENVS_PER_BLOCK;
  const int live = min(ENVS_PER_BLOCK, batch - env0);  // warps of this block with an env
  int* s_geo = reinterpret_cast<int*>(smem);
  unsigned char* states = smem + geo_bytes();
  const int ebytes = env_bytes(n);
  auto env_at = [&](int w) { return Env(states + w * ebytes, n, p); };
  const long long b = batch;
  const int words = NUM_PLANES * p, cells = n * n;

  if (threadIdx.x < live) {
    const long long slot = src ? src[env0 + threadIdx.x] : 0;
    if (slot < 0 || slot >= slots_in) __trap();
    s_src[threadIdx.x] = slot;
  }
  for (int i = threadIdx.x; i < GEO_LEN; i += blockDim.x) s_geo[i] = geo_table[i];
  __syncthreads();
  // the block's envs' source slots, env fastest: neighbouring threads read
  // neighbouring words where the envs share a slot
  for (int i = threadIdx.x; i < (words + cells) * live; i += blockDim.x) {
    const int j = i / live, w = i - j * live;
    const Env e = env_at(w);
    const long long env = env0 + w, slot = s_src[w];
    if (j < words) {
      e.planes[j] = planes[(slot * words + j) * b + env];
    } else {
      e.compid[j - words] = compid[(slot * cells + (j - words)) * b + env];
    }
  }
  __syncthreads();

  if (warp < live) {
    const long long env = env0 + warp;
    const int* sc = scalars + s_src[warp] * NUM_SCALARS * b + env;
    Scalars s{sc[0], sc[b], sc[2 * b], sc[3 * b], sc[4 * b]};
    const Env e = env_at(warp);
    step_bits(e, s, (int)action[env], s_geo, lane);
    if (lane < NUM_SCALARS) {
      const int v = lane == 0 ? s.cur : lane == 1 ? s.mc : lane == 2 ? s.move_one
                  : lane == 3 ? s.swapped : s.result;
      out_scalars[((long long)dst * NUM_SCALARS + lane) * b + env] = v;
    }
    if (legal != nullptr) {
      // bit_legal_mask_flat of the new state for its mover (clipped to 0..1)
      const int plane = LEGAL + min(max(s.cur, 0), 1);
      for (int a = lane; a < cells; a += WARP) {
        const int x = a / n, y = a - x * n;
        legal[env * cells + a] = (e.w(plane, x + PAD) >> (y + PAD)) & 1u;
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < (words + cells) * live; i += blockDim.x) {
    const int j = i / live, w = i - j * live;
    const Env e = env_at(w);
    const long long env = env0 + w;
    if (j < words) {
      out_planes[((long long)dst * words + j) * b + env] = e.planes[j];
    } else {
      out_compid[((long long)dst * cells + (j - words)) * b + env] = e.compid[j - words];
    }
  }
}

}  // namespace

extern "C" {

// Launch the step on ``stream``; returns a CUDA error code (0 = ok).
// Pointers are device pointers of the wrapper's tensors (layouts above);
// ``src`` and ``legal`` may be null.
int twixt_bit_step(const void* planes, const void* compid, const void* scalars, const void* src,
                   const void* action, void* out_planes, void* out_compid, void* out_scalars,
                   int dst, void* legal, const void* geo_table, int board_size, int batch,
                   int slots_in, void* stream) {
  if (board_size < MIN_N || board_size > MAX_N || batch < 1 || dst < 0 || slots_in < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (batch + ENVS_PER_BLOCK - 1) / ENVS_PER_BLOCK;
  bit_step_kernel<<<blocks, ENVS_PER_BLOCK * WARP, shared_bytes(board_size),
                    (cudaStream_t)stream>>>(
      (const uint32_t*)planes, (const short*)compid, (const int*)scalars,
      (const long long*)src, (const long long*)action, (uint32_t*)out_planes,
      (short*)out_compid, (int*)out_scalars, dst, (bool*)legal, (const int*)geo_table,
      board_size, batch, slots_in);
  return (int)cudaGetLastError();
}

const char* twixt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
