// One lockstep engine step over slot-indexed state, for Hopper (S1a).
//
// Not a TPU kernel: inside the JAX search's jitted simulation XLA fuses the
// node-state gather (twixt_for_open_spiel_tpu/models/mcts.py:191
// _gather_node_state), the bitboard step (ops/bitboard.py:276 step_bits),
// the new mover's legal mask (bit_legal_mask_flat), the child's terminal
// flag and value (mcts.py:380-388) and the slot write (mcts.py:228
// _set_node_state) into device code.  The port ran those as about 1,450
// small torch ops a step; an H100 profile of the search named them
// (PERF.md §5), so they are one kernel here.  The same kernel is the port's
// plain lockstep step (ops/bitboard.py::step_bits on CUDA tensors): one
// source slot, one destination slot.
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
//   terminal bool, tval f32: element env * outcome_stride of each (the
//            tree's [B, S_out] rows at column dst; null: not written): the
//            child's terminal flag and its value for the parent's mover,
//            +1 won, 0 drawn or open, -1 lost
// The source and destination buffers may be the same tensors (the search
// writes the child into the tree it reads the parent from): a block reads
// every slot its envs need into shared memory before any of them is
// written, and an env's column is touched by its own block only.
//
// What bounds it on this card: at the search's shapes (board 12, B=512) it
// moves about 1.5 MB, under a microsecond at 3.35 TB/s; in the search form
// each env's parent slot differs, so a 4-byte word of it costs a 32-byte
// sector, about 7 MB of L2 traffic, still under a microsecond.  What costs
// is latency: the launch, every dependent round trip to memory, and the
// step's chain of shared-memory operations.  The design pays two round
// trips before the step:
//   1. every thread loads the slot of the env it copies (src) and its
//      warp's action; meanwhile the geometry table goes from constant
//      memory (set once a device from K1's table) to shared memory (no
//      global load, no barrier before 2);
//   2. every thread issues its share of its env's slot with cp.async
//      (global to shared, 4 bytes each, no register held): the 16 P
//      planes words, the 5 scalars and, for each of the n*n int16 compid
//      cells, the aligned 4-byte word that holds the env's half (the other
//      half rides along and is dropped; a half with no word around it in
//      the tensor, its first or last, is loaded alone), then waits once
//      (cp.async.wait_all), unpacks its own halves and meets the block at
//      one barrier.  A register-staged load would need an unrolled bound
//      per board size and the registers to hold up to 33 words a thread;
//      cp.async needs neither.
// A block holds ENVS_PER_BLOCK = 8 envs, one warp each for the step, and
// copies with the env fastest: 8 envs x 4 bytes of one word make a full
// 32-byte sector of the destination slot (and of the source slot in the
// one-slot form, where every env reads slot 0).  Each warp runs
// bit_step.cuh's step_bits on its env with the scalars in registers, writes
// its scalars, terminal flag and value and legal mask lane-parallel; then
// the block copies the stepped states out as it copied them in.  An env's
// region in shared memory is 4 mod 8 words long, so a warp's 8 envs x 4
// words land on 32 banks.  A slot index outside [0, S_in) traps, as torch's
// device-side index check does.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (see ops/_cuda.py).  Plain C entry points, bound with
// ctypes; no PyTorch headers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bit_step.cuh"

namespace {

using namespace twixt;

constexpr int ENVS_PER_BLOCK = 8;
constexpr int THREADS = ENVS_PER_BLOCK * WARP;
constexpr int COPY_ROWS = THREADS / ENVS_PER_BLOCK;  // words of one env a pass of the block
constexpr int SCALAR_WORDS = 8;                      // an env's 5 scalars, padded
constexpr int SMEM_LIMIT = 48 * 1024;                // no opt-in above it

// ops/geometry.py's OFFSETS [8][2] then CROSSERS [8][9][3] (dx, dy, dir2):
// ops/_cuda.py::geo_table, K1's table, set on each device before its first
// launch (twixt_bit_step_set_geometry)
__constant__ int GEO_TABLE[GEO_LEN];

// An env's region of shared memory: its Env (planes, compid), then the
// compid words as copied (a u32 a cell), then its scalars; 4 mod 8 words.
__host__ __device__ constexpr int stage_offset(int n) { return env_bytes(n); }
__host__ __device__ constexpr int scalars_offset(int n) { return env_bytes(n) + n * n * 4; }
__host__ __device__ constexpr int env_stride(int n) {
  return round_up(scalars_offset(n) + SCALAR_WORDS * 4, 32) + 16;
}
__host__ __device__ constexpr int shared_bytes(int n) {
  return geo_bytes() + ENVS_PER_BLOCK * env_stride(n);
}
static_assert(shared_bytes(MAX_N) <= SMEM_LIMIT, "every board fits a block without opt-in");

__device__ __forceinline__ void copy4(void* smem, const void* gmem) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to), "l"(gmem) : "memory");
}

__global__ void __launch_bounds__(THREADS) bit_step_kernel(
    const uint32_t* planes, const short* compid, const int* scalars, const long long* src,
    const long long* action, uint32_t* out_planes, short* out_compid, int* out_scalars,
    int dst, bool* legal, bool* terminal, float* tval, int outcome_stride, int n, int batch,
    int slots_in) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = n + 2 * PAD;
  const int words = NUM_PLANES * p, cells = n * n;
  const long long b = batch;
  const int t = threadIdx.x, warp = t / WARP, lane = t % WARP;
  const long long env0 = (long long)blockIdx.x * ENVS_PER_BLOCK;
  int* s_geo = reinterpret_cast<int*>(smem);
  unsigned char* regions = smem + geo_bytes();
  const int stride = env_stride(n);

  // the copies run env fastest: thread t copies rows t / 8, t / 8 + 32, ...
  // of env t % 8; warp w steps env w
  const int cw = t % ENVS_PER_BLOCK, row0 = t / ENVS_PER_BLOCK;
  const long long cenv = env0 + cw, senv = env0 + warp;
  const bool copies = cenv < b, steps = senv < b;

  // round trip 1: the copied env's slot and the stepped env's action
  const long long slot = (copies && src != nullptr) ? src[cenv] : 0;
  const int act = steps ? (int)action[senv] : 0;
  for (int i = t; i < GEO_LEN; i += THREADS) s_geo[i] = GEO_TABLE[i];

  // round trip 2: the env's source slot, every word in flight at once
  unsigned char* mine = regions + cw * stride;
  uint32_t* stage = reinterpret_cast<uint32_t*>(mine + stage_offset(n));
  const long long cid0 = slot * cells * b + cenv;  // element of cell 0
  const long long last = (long long)slots_in * cells * b - 1;  // compid's last element
  // the 4-byte word that holds element e of compid holds a half of the
  // tensor beside it, unless e is the first element at the word's high half
  // or the last at its low half (compid may start at any 2-byte address)
  auto paired = [&](long long e) {
    return ((uintptr_t)(compid + e) & 2u) ? e > 0 : e < last;
  };
  if (copies) {
    if (slot < 0 || slot >= slots_in) __trap();
    uint32_t* e_planes = reinterpret_cast<uint32_t*>(mine);
    const uint32_t* gp = planes + slot * words * b + cenv;
    for (int j = row0; j < words; j += COPY_ROWS) copy4(e_planes + j, gp + j * b);
    for (int c = row0; c < cells; c += COPY_ROWS) {
      const short* half = compid + (cid0 + c * b);
      if (paired(cid0 + c * b)) {
        copy4(stage + c, (const void*)((uintptr_t)half & ~(uintptr_t)3));
      } else {  // no word around it lies in the tensor: the half alone
        stage[c] = (uint16_t)*half;
      }
    }
    if (row0 < NUM_SCALARS) {
      copy4(reinterpret_cast<int*>(mine + scalars_offset(n)) + row0,
            scalars + (slot * NUM_SCALARS + row0) * b + cenv);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (copies) {  // this thread's own copies are complete: keep its halves
    short* e_compid = reinterpret_cast<short*>(mine + NUM_PLANES * p * 4);
    for (int c = row0; c < cells; c += COPY_ROWS) {
      const long long e = cid0 + c * b;
      const uint32_t word = stage[c];
      const int shift = ((uintptr_t)(compid + e) & 2u) ? 16 : 0;  // little-endian halves
      e_compid[c] = (short)(uint16_t)(paired(e) ? word >> shift : word);
    }
  }
  __syncthreads();

  if (steps) {
    unsigned char* region = regions + warp * stride;
    const Env e(region, n, p);
    const int* sc = reinterpret_cast<const int*>(region + scalars_offset(n));
    Scalars s{sc[0], sc[1], sc[2], sc[3], sc[4]};
    const int mover = min(max(s.cur, 0), 1);  // the parent's, for the child's value
    step_bits(e, s, act, s_geo, lane);
    if (lane < NUM_SCALARS) {
      const int v = lane == 0 ? s.cur : lane == 1 ? s.mc : lane == 2 ? s.move_one
                  : lane == 3 ? s.swapped : s.result;
      out_scalars[((long long)dst * NUM_SCALARS + lane) * b + senv] = v;
    }
    if (lane == 0 && terminal != nullptr) {
      const bool term = s.result != RESULT_OPEN;
      terminal[senv * outcome_stride] = term;
      tval[senv * outcome_stride] = !term ? 0.0f
                                    : s.result == RESULT_RED_WIN + mover ? 1.0f
                                    : s.result == RESULT_DRAW ? 0.0f : -1.0f;
    }
    if (legal != nullptr) {
      // bit_legal_mask_flat of the new state for its mover (clipped to 0..1)
      const int plane = LEGAL + min(max(s.cur, 0), 1);
      for (int a = lane; a < cells; a += WARP) {
        const int x = a / n, y = a - x * n;
        legal[senv * cells + a] = (e.w(plane, x + PAD) >> (y + PAD)) & 1u;
      }
    }
  }
  __syncthreads();

  if (copies) {  // the stepped state out, as it came in
    const uint32_t* e_planes = reinterpret_cast<const uint32_t*>(mine);
    const short* e_compid = reinterpret_cast<const short*>(mine + NUM_PLANES * p * 4);
    uint32_t* op = out_planes + (long long)dst * words * b + cenv;
    for (int j = row0; j < words; j += COPY_ROWS) op[j * b] = e_planes[j];
    short* oc = out_compid + (long long)dst * cells * b + cenv;
    for (int c = row0; c < cells; c += COPY_ROWS) oc[c * b] = e_compid[c];
  }
}

}  // namespace

extern "C" {

// Launch the step on ``stream``; returns a CUDA error code (0 = ok).
// Pointers are device pointers of the wrapper's tensors (layouts above);
// ``src``, ``legal`` and ``terminal``/``tval`` may be null.
int twixt_bit_step(const void* planes, const void* compid, const void* scalars, const void* src,
                   const void* action, void* out_planes, void* out_compid, void* out_scalars,
                   int dst, void* legal, void* terminal, void* tval, int outcome_stride,
                   int board_size, int batch, int slots_in, void* stream) {
  if (board_size < MIN_N || board_size > MAX_N || batch < 1 || dst < 0 || slots_in < 1 ||
      (terminal == nullptr) != (tval == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (batch + ENVS_PER_BLOCK - 1) / ENVS_PER_BLOCK;
  bit_step_kernel<<<blocks, THREADS, shared_bytes(board_size), (cudaStream_t)stream>>>(
      (const uint32_t*)planes, (const short*)compid, (const int*)scalars,
      (const long long*)src, (const long long*)action, (uint32_t*)out_planes,
      (short*)out_compid, (int*)out_scalars, dst, (bool*)legal, (bool*)terminal, (float*)tval,
      outcome_stride, board_size, batch, slots_in);
  return (int)cudaGetLastError();
}

// Copy the geometry table (GEO_LEN ints in host memory, ops/_cuda.py::
// geo_table) into the current device's constant memory, and wait for the
// copy, so that a launch on any stream finds it; returns a CUDA error code.
int twixt_bit_step_set_geometry(const int* table, int len) {
  if (len != GEO_LEN) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaMemcpyToSymbol(GEO_TABLE, table, GEO_LEN * sizeof(int));
  return (int)(err != cudaSuccess ? err : cudaDeviceSynchronize());
}

// The envs a block of a launch (ops/_cuda.py::envs_per_block).
int twixt_bit_step_envs_per_block() { return ENVS_PER_BLOCK; }

const char* twixt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
