// Fused lockstep random rollout on the TwixT bitboard engine, for Hopper.
//
// Replaces the Pallas TPU kernel twixt_for_open_spiel_tpu/ops/
// fused_bit_rollout.py::fused_bit_rollout (kernel body _make_kernel.kernel),
// both of its arms: emit_obs=False (K1, the rollout) and emit_obs=True (K2,
// the rollout plus the per-step packed learner wire).  The JAX kernel keeps a
// batch tile of envs in VMEM and runs the vectorised step_bits over it, with
// the wire going out through a double-buffered DMA stream; here one warp runs
// one env with its state in shared memory, and the wire is staged in shared
// memory and stored by TMA tensor copies.
//
// Semantics are those of ops/bitboard.py of this package (the plain torch
// version) and must stay bit-identical to it (the step itself, with Env,
// Scalars and the hash, is csrc/bit_step.cuh, shared with the one-step
// kernel csrc/bit_step.cu): the same counter-hash noise
// keyed by the global env index (so the launch shape changes no result), the
// same float32 draw of the rank k (__fmul_rn, __float2int_rz, the clamp), the
// same popcount-rank selection, the same step_bits, the same auto-reset.
// bit_at keeps shifts outside [0, 32) at 0, as the JAX shift gives (a CUDA
// shift by 32 or more is undefined); floordiv/floormod are jnp's // and %.
//
// Layout in device memory (the JAX layout, env trailing):
//   planes   u32 [16, P, B]  red, blue, links[4], blocked[4], legal[2], flags[4]
//   compid   i16 [n, n, B]
//   scalars  i32 [5, B]      current_player, move_counter, move_one,
//                            swapped, result
//   obs      u32 [T, 12, P, B] (emit_obs only)
// updated in place (the wrapper hands in fresh copies of the caller's state).
//
// Design.  A block holds W envs, one warp each.  At launch the block copies
// its envs' planes and compid into shared memory (16 P words + n*n halves an
// env: 1.0 KB at n=8, 3.1 KB at n=24), with one copy of the initial state
// for resets and the geometry table; the state goes back once at the end.
// Scalars live in registers, the same in every lane.  Lane x owns padded row
// x (P <= 30 rows fit the warp) and compid row x:
//   * the draw: lane x popcounts row x of the mover's legal plane, an
//     inclusive __shfl_up_sync scan gives the running counts (the last
//     lane's is the total), every lane computes the same k, __ballot_sync
//     finds the one row with cum_prev <= k < cum, and that row's word and
//     rank are shuffled to every lane for select_kth_bit;
//   * the local step: the owners of rows m1x and ex undo the swap, clear
//     move one's legal bits and place the peg; lanes 0-7 take one direction
//     each and read the pre-move links, flags and compid; __ballot_sync and
//     __syncwarp order every read before the first write; the 8 direction
//     lanes then write distinct (plane, row) words (every knight offset has
//     dx != 0, so a west endpoint is never the peg's row);
//   * the merge: lane x scans its n compid cells against the <= 8 linked
//     ids held in registers and stamps the merged flags on its own row;
//   * the opponent-has-legal test (__any_sync) and the reset copy (16-byte
//     vectors of the initial state) are lane-parallel.
// Warps past the batch in the last block run no steps but reach every block
// barrier.
//
// K2's wire.  Before each move every warp writes its env's 12 packed planes
// (the pre-move state; an env that finished at step k-1 shows its reset
// state) into a shared-memory tile [12 P rows][W envs]: lane x writes row x
// of each plane.  After one block barrier, thread 0 stores the tile as two
// boxes of 6 planes (a TMA box dimension is at most 256 and 12 P reaches
// 360) with cp.async.bulk.tensor.2d through a CUtensorMap over obs viewed as
// [T*12*P, B] int32; the TMA clips the ragged batch edge.  The tiles form a
// ring of SLOTS = 2: before the barrier of step k thread 0 waits until the
// copy of step k-1 has read its slot (cp.async.bulk.wait_group.read 0), so
// the slot written at step k+1 is free; each writer fences its stores to the
// async proxy first.  A tensor map's row stride must be a multiple of 16
// bytes, so the TMA path needs B % 4 == 0 and W % 4 == 0 (a 16-byte inner
// box); for any other B the block stores the staged tile with plain
// coalesced stores after the same barrier.  The path is chosen by shape, in
// the launch: it is no fallback.
//
// W and SLOTS.  W (1..16) comes from the occupancy calculator with the
// shared memory W + 1 envs, the geometry table and, for K2, the ring need,
// capped at B / SMs so that small batches spread over the SMs (multiples of
// 4 only on the TMA path).  SLOTS = 2 because a step is long (microseconds)
// against a tile's copy, so one slot in flight while the next fills is
// enough, and a third slot would cost blocks: at n=24, W=16 a slot is 23 KB,
// so two slots and 17 envs take 97 KB and two blocks (32 warps) fit an SM.
//
// What bounds it on this card: instruction issue for K1 (the step's
// direction probes, votes and shuffles, the merge scan), and the obs bytes
// for K2 (12 P words an env-step).  The state never leaves shared memory
// during the launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (see ops/_cuda.py).  Plain C entry points, bound with
// ctypes; no PyTorch headers.  cuTensorMapEncodeTiled is reached through
// cudaGetDriverEntryPoint, so the library links only the CUDA runtime.

#include <cuda.h>  // CUtensorMap and its enums: types only, no libcuda link
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "bit_step.cuh"
#include "bulk_store.cuh"

namespace {

using namespace twixt;

constexpr int NUM_OBS_PLANES = 12;
constexpr int BOXES = 2;  // the obs tile of a step goes out as 2 boxes
constexpr int PLANES_PER_BOX = NUM_OBS_PLANES / BOXES;
constexpr int MAX_BOX_DIM = 256;
constexpr int TMA_ENV_MULTIPLE = 4;  // W and B: a 16-byte inner box and row stride
constexpr int SLOTS = 2;
constexpr int SMEM_ALIGN = 128;  // a TMA copy's shared-memory source
constexpr int MAX_ENVS_PER_BLOCK = 16;

static_assert(PLANES_PER_BOX * MAX_P <= MAX_BOX_DIM, "a box of planes fits the TMA");
static_assert(MAX_ENVS_PER_BLOCK % TMA_ENV_MULTIPLE == 0, "the TMA path reaches the cap");

// --- shared memory, in bytes (env_bytes and geo_bytes: bit_step.cuh) --------
// one box of a step's obs tile: PLANES_PER_BOX * P rows of W words
__host__ __device__ constexpr int box_bytes(int n, int envs) {
  return round_up(PLANES_PER_BOX * (n + 2 * PAD) * envs * 4, SMEM_ALIGN);
}
__host__ __device__ constexpr int ring_bytes(int n, int envs, bool obs) {
  return obs ? SLOTS * BOXES * box_bytes(n, envs) : 0;
}
// the block's dynamic shared memory: alignment slack, the obs ring, the
// geometry table, the initial state and W envs
__host__ __device__ constexpr int shared_bytes(int n, int envs, bool obs) {
  return SMEM_ALIGN + ring_bytes(n, envs, obs) + geo_bytes() + (envs + 1) * env_bytes(n);
}

// Uniform legal action by popcount rank (ops/bitboard.py::sample_bits), by
// the env's warp: lane x counts row x, a scan and a ballot find the row.
__device__ int sample_action(const Env& e, int cur, uint32_t noise, int lane) {
  const uint32_t r = e.row(LEGAL + min(max(cur, 0), 1), lane);
  const int cnt = __popc(r);
  int cum = cnt;
#pragma unroll
  for (int o = 1; o < WARP; o <<= 1) {
    const int v = __shfl_up_sync(FULL, cum, o);
    if (lane >= o) cum += v;
  }
  const int total = __shfl_sync(FULL, cum, WARP - 1);
  const uint32_t bits = hash_u32(noise);
  // float32 throughout, no contraction: u = (bits >> 8) * 2^-24, k = u*total
  const float u = __fmul_rn((float)(int)(bits >> 8), 1.0f / 16777216.0f);
  int k = __float2int_rz(__fmul_rn(u, (float)total));
  k = max(min(k, total - 1), 0);
  const int prev = cum - cnt;
  const unsigned hit = __ballot_sync(FULL, prev <= k && k < cum);
  // no legal cell: the plain version's empty selection (row BIG, word 0)
  const int src = hit ? __ffs(hit) - 1 : 0;
  const uint32_t word = hit ? __shfl_sync(FULL, r, src) : 0u;
  const int kin = hit ? k - __shfl_sync(FULL, prev, src) : 0;
  const int col = hit ? src : BIG;
  return (col - PAD) * e.n + (select_kth_bit(word, kin) - PAD);
}

// The 12 packed observation planes of the env's current state, with the
// mover's legal plane in the low 3 bits of planes 0..7 (ops/observe.py:
// bit_observation_packed_lanes + pack_legal_into_lanes), into column
// ``warp`` of a staging tile: lane x writes row x of each plane.
__device__ void stage_obs(const Env& e, int cur, unsigned char* slot, int box, int envs,
                          int warp, int lane, const int* geo) {
  const int p = e.p;
  const int x = lane < p ? lane : 0;
  uint32_t l[4], any_link = 0u, blocked_e = 0u;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    l[d] = e.w(LINKS + d, x);
    any_link |= l[d];
    blocked_e |= e.w(BLOCKED + d, x);
  }
#pragma unroll
  for (int d = 4; d < 8; ++d) {  // west directions: expand_planes, rolled mod P
    const int dx = geo[GEO_OFFSETS + 2 * d], dy = geo[GEO_OFFSETS + 2 * d + 1];
    const uint32_t src = __shfl_sync(FULL, l[d - 4], floormod(x + dx, p));
    any_link |= (dy > 0) ? (src >> dy) : (src << -dy);
  }
  if (lane >= p) return;
  const uint32_t red = e.w(RED, x), blue = e.w(BLUE, x);
  const uint32_t leg = e.w(LEGAL + min(max(cur, 0), 1), x);
  uint32_t planes[NUM_OBS_PLANES];
  planes[0] = red & ~any_link;
  planes[6] = blue & ~any_link;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    planes[1 + d] = red & l[d];
    planes[7 + d] = blue & l[d];
  }
  planes[5] = red & blocked_e;
  planes[11] = blue & blocked_e;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    planes[j] = (planes[j] & ~7u) | ((leg >> (PAD + 3 * j)) & 7u);
  }
#pragma unroll
  for (int j = 0; j < NUM_OBS_PLANES; ++j) {
    uint32_t* tile = reinterpret_cast<uint32_t*>(slot + (j / PLANES_PER_BOX) * box);
    tile[((j % PLANES_PER_BOX) * p + x) * envs + warp] = planes[j];
  }
}

__global__ void __launch_bounds__(MAX_ENVS_PER_BLOCK * WARP, 2) fused_bit_rollout_kernel(
    uint32_t* __restrict__ planes, short* __restrict__ compid, int* __restrict__ scalars,
    int* __restrict__ episodes, int* __restrict__ results, uint32_t* __restrict__ obs,
    const uint32_t* __restrict__ init_planes, const short* __restrict__ init_compid,
    const int* __restrict__ init_scalars, const int* __restrict__ geo_table,
    const __grid_constant__ CUtensorMap obs_map, int obs_by_tma, uint32_t seed, int n,
    int num_steps, int batch) {
  extern __shared__ unsigned char smem_raw[];
  // the ring's boxes are TMA sources: align the base to SMEM_ALIGN
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((SMEM_ALIGN - raw % SMEM_ALIGN) % SMEM_ALIGN);
  const int p = n + 2 * PAD;
  const int envs = blockDim.x / WARP;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int env0 = blockIdx.x * envs;
  const int live = min(envs, batch - env0);  // warps of this block with an env
  const bool emit = obs != nullptr;
  const int box = box_bytes(n, envs);
  unsigned char* ring = smem;
  int* s_geo = reinterpret_cast<int*>(smem + ring_bytes(n, envs, emit));
  unsigned char* states = reinterpret_cast<unsigned char*>(s_geo) + geo_bytes();
  const int ebytes = env_bytes(n);
  const Env init(states, n, p);
  auto env_at = [&](int w) { return Env(states + (1 + w) * ebytes, n, p); };

  const int words = NUM_PLANES * p, cells = n * n;
  for (int i = threadIdx.x; i < GEO_LEN; i += blockDim.x) s_geo[i] = geo_table[i];
  for (int i = threadIdx.x; i < words; i += blockDim.x) init.planes[i] = init_planes[i];
  for (int i = threadIdx.x; i < cells; i += blockDim.x) init.compid[i] = init_compid[i];
  // the block's envs, env fastest: neighbouring threads read neighbouring
  // words (word j of env0 + w is planes[j * B + env0 + w])
  for (int i = threadIdx.x; i < (words + cells) * live; i += blockDim.x) {
    const int j = i / live, w = i - j * live;
    const Env e = env_at(w);
    if (j < words) {
      e.planes[j] = planes[(long long)j * batch + env0 + w];
    } else {
      e.compid[j - words] = compid[(long long)(j - words) * batch + env0 + w];
    }
  }
  __syncthreads();

  const bool alive = warp < live;
  const int env = env0 + warp;
  const Env e = env_at(warp);
  Scalars s{0, 0, 0, 0, 0};
  if (alive) {
    s = Scalars{scalars[0 * (long long)batch + env], scalars[1 * (long long)batch + env],
                scalars[2 * (long long)batch + env], scalars[3 * (long long)batch + env],
                scalars[4 * (long long)batch + env]};
  }
  const Scalars s0{__ldg(init_scalars + 0), __ldg(init_scalars + 1), __ldg(init_scalars + 2),
                   __ldg(init_scalars + 3), __ldg(init_scalars + 4)};
  const uint4* init_vec = reinterpret_cast<const uint4*>(init.planes);
  uint4* env_vec = reinterpret_cast<uint4*>(e.planes);

  int ep = 0, r0 = 0, r1 = 0, r2 = 0, r3 = 0;
  for (int k = 0; k < num_steps; ++k) {
    if (emit) {
      // the pre-move wire of step k: stage, one barrier, store
      unsigned char* slot = ring + (k % SLOTS) * BOXES * box;
      if (alive) stage_obs(e, s.cur, slot, box, envs, warp, lane, s_geo);
      if (obs_by_tma) {
        bulk_store::fence_shared_to_async();
        // the copy of step k-1 has read its slot: step k+1 may refill it
        if (threadIdx.x == 0) bulk_store::wait_read<SLOTS - 2>();
      }
      __syncthreads();
      const int row0 = k * NUM_OBS_PLANES * p;
      if (obs_by_tma) {
        if (threadIdx.x == 0) {
#pragma unroll
          for (int h = 0; h < BOXES; ++h) {
            bulk_store::copy_tensor_2d(&obs_map, slot + h * box, env0,
                                       row0 + h * PLANES_PER_BOX * p);
          }
          bulk_store::commit();
        }
      } else {
        // B % 4 != 0: plain stores, env fastest (coalesced)
        for (int i = threadIdx.x; i < NUM_OBS_PLANES * p * live; i += blockDim.x) {
          const int r = i / live, w = i - r * live;
          const int h = r / (PLANES_PER_BOX * p), rr = r - h * PLANES_PER_BOX * p;
          obs[((long long)row0 + r) * batch + env0 + w] =
              reinterpret_cast<const uint32_t*>(slot + h * box)[rr * envs + w];
        }
      }
    }
    if (!alive) continue;
    __syncwarp();
    const uint32_t noise = hash_u32(seed + 2654435761u * (uint32_t)(k + 1)) +
                           (uint32_t)env * 0x9E3779B9u;
    const int result = step_bits(e, s, sample_action(e, s.cur, noise, lane), s_geo, lane);
    if (result != RESULT_OPEN) {
      // auto-reset to the batch-1 initial state built by the wrapper
      ++ep;
      r0 += result == 0;
      r1 += result == 1;
      r2 += result == 2;
      r3 += result == 3;
      for (int i = lane; i < ebytes / 16; i += WARP) env_vec[i] = init_vec[i];
      s = s0;
      __syncwarp();  // the next staging reads rows other lanes copied
    }
  }
  if (emit && obs_by_tma && threadIdx.x == 0) bulk_store::wait_all();
  if (alive) {
    if (lane == 0) {
      episodes[env] = ep;
      results[0 * (long long)batch + env] = r0;
      results[1 * (long long)batch + env] = r1;
      results[2 * (long long)batch + env] = r2;
      results[3 * (long long)batch + env] = r3;
    }
    if (lane < NUM_SCALARS) {
      const int v = lane == 0 ? s.cur : lane == 1 ? s.mc : lane == 2 ? s.move_one
                  : lane == 3 ? s.swapped : s.result;
      scalars[(long long)lane * batch + env] = v;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < (words + cells) * live; i += blockDim.x) {
    const int j = i / live, w = i - j * live;
    const Env o = env_at(w);
    if (j < words) {
      planes[(long long)j * batch + env0 + w] = o.planes[j];
    } else {
      compid[(long long)(j - words) * batch + env0 + w] = o.compid[j - words];
    }
  }
}

// The envs (warps) per block at this board size and batch: the most envs
// resident per SM (by the occupancy calculator, with the shared memory that
// many envs and the obs ring need), over W = 1 .. min(16, B / SMs) so that
// small batches still spread over every SM (multiples of 4 only when the
// wire goes out by TMA); ties go to the larger W.  Returns a CUDA error code
// and sets *envs and *smem.
cudaError_t launch_shape(int n, int batch, bool obs, bool tma, int* envs, int* smem) {
  int device = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(fused_bit_rollout_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  }
  if (err != cudaSuccess) return err;
  const int step = tma ? TMA_ENV_MULTIPLE : 1;
  const int cap = max(step, min(MAX_ENVS_PER_BLOCK, batch / max(sms, 1)));
  int best = 0, best_resident = -1;
  for (int w = step; w <= cap && shared_bytes(n, w, obs) <= optin; w += step) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fused_bit_rollout_kernel,
                                                        w * WARP, shared_bytes(n, w, obs));
    if (err != cudaSuccess) return err;
    if (blocks * w >= best_resident) {
      best_resident = blocks * w;
      best = w;
    }
  }
  if (best == 0) return cudaErrorInvalidConfiguration;
  *envs = best;
  *smem = shared_bytes(n, best, obs);
  return cudaSuccess;
}

// cuTensorMapEncodeTiled (CUDA 12.0), reached through the runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* found = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &found, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &found, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess) return err;
    if (status != cudaDriverEntryPointSuccess || found == nullptr) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(found);
  }
  *fn = cached;
  return cudaSuccess;
}

// The tensor map of obs viewed as [T*12*P rows, B] int32, in boxes of
// PLANES_PER_BOX planes by W envs.
cudaError_t obs_tensor_map(CUtensorMap* map, void* obs, int n, int num_steps, int batch,
                           int envs) {
  EncodeTiled encode = nullptr;
  const cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const int p = n + 2 * PAD;
  const cuuint64_t dims[2] = {(cuuint64_t)batch, (cuuint64_t)num_steps * NUM_OBS_PLANES * p};
  const cuuint64_t strides[1] = {(cuuint64_t)batch * 4};
  const cuuint32_t box[2] = {(cuuint32_t)envs, (cuuint32_t)(PLANES_PER_BOX * p)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, obs, dims, strides, box,
                              elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

bool valid(int board_size, int batch, int num_steps) {
  return board_size >= MIN_N && board_size <= MAX_N && batch >= 1 && num_steps >= 0;
}

// The wire goes out by TMA when its rows are whole 16-byte vectors.
bool by_tma(bool obs, int batch, int num_steps) {
  return obs && num_steps > 0 && batch % TMA_ENV_MULTIPLE == 0;
}

}  // namespace

extern "C" {

// Launch the rollout on ``stream``; returns a CUDA error code (0 = ok).
// Pointers are device pointers of the wrapper's tensors (layouts above);
// ``obs`` is null unless the per-step wire is wanted; init_planes [16, P],
// init_compid [n, n] and init_scalars [5] hold one env's initial state.
int twixt_fused_bit_rollout(void* planes, void* compid, void* scalars, void* episodes,
                            void* results, void* obs, const void* init_planes,
                            const void* init_compid, const void* init_scalars,
                            const void* geo_table, unsigned int seed, int board_size,
                            int num_steps, int batch, void* stream) {
  if (!valid(board_size, batch, num_steps)) return (int)cudaErrorInvalidValue;
  const bool emit = obs != nullptr;
  const bool tma = by_tma(emit, batch, num_steps);
  int envs = 0, smem = 0;
  cudaError_t err = launch_shape(board_size, batch, emit, tma, &envs, &smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (tma) {
    err = obs_tensor_map(&map, obs, board_size, num_steps, batch, envs);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (batch + envs - 1) / envs;
  fused_bit_rollout_kernel<<<blocks, envs * WARP, smem, (cudaStream_t)stream>>>(
      (uint32_t*)planes, (short*)compid, (int*)scalars, (int*)episodes, (int*)results,
      (uint32_t*)obs, (const uint32_t*)init_planes, (const short*)init_compid,
      (const int*)init_scalars, (const int*)geo_table, map, tma ? 1 : 0, (uint32_t)seed,
      board_size, num_steps, batch);
  return (int)cudaGetLastError();
}

// The envs per block a launch at this board size, batch and arm takes, or
// minus a CUDA error code.
int twixt_fused_bit_rollout_envs_per_block(int board_size, int batch, int emit_obs) {
  if (!valid(board_size, batch, 0)) return -(int)cudaErrorInvalidValue;
  int envs = 0, smem = 0;
  const cudaError_t err = launch_shape(board_size, batch, emit_obs != 0,
                                       by_tma(emit_obs != 0, batch, 1), &envs, &smem);
  return err == cudaSuccess ? envs : -(int)err;
}

const char* twixt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
