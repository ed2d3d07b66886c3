// Fused lockstep random rollout on the canonical TwixT engine, for Hopper.
//
// Replaces the Pallas TPU kernel scripts/archive_fused_tensor_rollout.py::
// fused_random_rollout (kernel body _make_kernel.kernel): num_steps lockstep
// random-policy steps of every env, with Gumbel-max sampling keyed by a
// counter hash, the canonical transition ops/step.py::step_impl and
// auto-reset, recording every action and every pre-reset result.  The TPU
// kernel keeps a batch tile in VMEM and runs step_impl as ~80 whole-board
// shifts; here one warp runs one env with its board in shared memory, and
// the step touches only what the peg reaches: its 8 knight neighbours and
// their 72 crossing probes (geometry.CROSSERS), a compid/flags remap scan
// when a link merges components, the legal-cell removal and the
// opponent-has-legal test.
//
// Semantics are those of ops/fused_tensor_rollout.py of this package (the
// plain torch version) and of the JAX kernel, bit for bit:
//   * program = env / tile, e = env % tile (tile is semantic: it keys the
//     random stream); seed' = seed + program * 0x01000193 (mod 2^32);
//   * noise_k = hash(seed' + 2654435761 * (k + 1));
//   * bits(cell) = hash(cell * 0x9E3779B9 + e * 0x85EBCA6B + noise_k), with
//     cell = x * P + y on the padded board;
//   * u = float(bits >> 8) * 2^-24, u = max(u, 1e-7), g = -log(-log(u)) in
//     float32 with logf (not __logf; built without --use_fast_math);
//   * the action is the smallest action id (x-PAD)*n + (y-PAD) among the
//     legal cells whose g is the maximum, over the whole padded board;
//   * a finished env takes the whole initial state; results[k] is the
//     pre-reset result.
// Every board index is wrapped into [0, P) as the TPU kernel's roll-based
// shifts do, so no input can index out of bounds.
//
// Layout in device memory (the JAX kernel's int32 working layout, env
// trailing):
//   cells    i32 [7, P, P, B]  color, links, blocked, compid, flags, legal[2]
//   scalars  i32 [5, B]        current_player, move_counter, move_one,
//                              swapped, result
//   actions, results  i32 [K, B]
// updated in place (the wrapper hands in fresh int32 copies).
//
// Design.  A block holds W envs, one warp each (W from the shared memory an
// env needs, the SM count and the batch: launch_shape below).  At launch
// the block copies its envs' boards into shared memory in the canonical
// dtypes, 8 bytes a cell (compid i16, color i8, links, blocked, flags and
// the two legal planes u8: exact for every state the wrapper takes, whose
// planes already have these dtypes), plus one copy of the initial board and
// a table of each cell's action id.  All num_steps steps run there; the
// boards go back once at the end.  Per step, lane l takes the cells
// c = l (mod 32):
//   * the draw: each lane keeps the best (g, id) of its legal cells, then a
//     butterfly of __shfl_xor_sync picks the warp's best (larger g, and on
//     equal g the smaller id: a total order, so the reduction order does
//     not change the result);
//   * the local step: lanes 0-7 take one direction each; every direction
//     reads the pre-move links before any link is written (the ballot that
//     gathers them orders the reads before the writes);
//   * the merge rescan, the opponent-has-legal scan (then __any_sync) and a
//     reset (a copy of the block's initial board) are lane-parallel.
// Scalars live in registers, the same in every lane; lane 0 writes actions
// and results.  Warps past the batch in the last block run no steps.
//
// What bounds it on this card: instruction issue.  A step hashes and takes
// two logf of every legal cell (~500 at board 24) and scans P*P cells up to
// three times; the state stays in shared memory, so device memory carries
// only the launch's state copy and the actions/results stream.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (see ops/_cuda.py).  Plain C entry points, bound with
// ctypes; no PyTorch headers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int PAD = 3;
constexpr int MIN_N = 5;
constexpr int MAX_N = 24;
constexpr int NUM_CELL_PLANES = 7;
constexpr int NUM_SCALARS = 5;
constexpr int BIG = 1 << 20;
constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_ENVS_PER_BLOCK = 16;
// geometry table: OFFSETS [8][2] then CROSSERS [8][9][3] (dx, dy, dir2)
constexpr int GEO_OFFSETS = 0;
constexpr int GEO_CROSSERS = 16;
constexpr int GEO_LEN = 16 + 8 * 9 * 3;

enum Plane { COLOR = 0, LINKS = 1, BLOCKED = 2, COMPID = 3, FLAGS = 4, LEGAL = 5 };
enum Scalar { CUR = 0, MC = 1, MOVE_ONE = 2, SWAPPED = 3, RESULT = 4 };

constexpr int COLOR_EMPTY = 2;
constexpr int RESULT_OPEN = 0;
constexpr int RESULT_RED_WIN = 1;
constexpr int RESULT_DRAW = 3;
constexpr int TERMINAL_PLAYER_ID = -4;

__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) / 16 * 16; }
// shared memory of one board (8 bytes a cell) and of the action-id table
__host__ __device__ constexpr int board_bytes(int pp) { return round16(8 * pp); }
__host__ __device__ constexpr int id_table_bytes(int pp) { return round16(2 * pp); }
__host__ __device__ constexpr int shared_bytes(int pp, int envs) {
  return id_table_bytes(pp) + (envs + 1) * board_bytes(pp);
}

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// floor division / modulo, as jnp's // and % on int32
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__device__ __forceinline__ int floormod(int a, int b) {
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// One board in shared memory: compid i16 [P*P], then color i8, links,
// blocked, flags, legal[0], legal[1] u8 [P*P] each.
struct Board {
  unsigned char* base;
  int pp;

  __device__ int16_t* compid() const { return reinterpret_cast<int16_t*>(base); }
  __device__ int8_t* color() const { return reinterpret_cast<int8_t*>(base + 2 * pp); }
  __device__ uint8_t* links() const { return base + 3 * pp; }
  __device__ uint8_t* blocked() const { return base + 4 * pp; }
  __device__ uint8_t* flags() const { return base + 5 * pp; }
  __device__ uint8_t* legal(int i) const { return base + (6 + i) * pp; }

  // a byte plane's byte, by the device layout's plane index (not COMPID)
  __device__ unsigned char* byte(int plane, int c) const {
    return base + (plane + 2 - (plane > COMPID ? 1 : 0)) * pp + c;
  }
  __device__ int get(int plane, int c) const {
    if (plane == COMPID) return compid()[c];
    const unsigned char v = *byte(plane, c);
    return plane == COLOR ? (int)(int8_t)v : (int)v;
  }
  __device__ void set(int plane, int c, int v) const {
    if (plane == COMPID) {
      compid()[c] = (int16_t)v;
    } else {
      *byte(plane, c) = (unsigned char)v;
    }
  }
};

// The env's scalars, the same in every lane of its warp.
struct Scalars {
  int cur, mc, move_one, swapped, result;
};

// Gumbel-max legal action of the player to move (_sample_actions): each
// lane its cells c = lane (mod 32), then the warp's best pair.
__device__ int sample_action(const Board& b, const int16_t* cell_id, int cur, uint32_t mix,
                             int lane) {
  const uint8_t* legal = b.legal(min(max(cur, 0), 1));
  float best = -INFINITY;
  int action = BIG;
#pragma unroll 1
  for (int c = lane; c < b.pp; c += WARP) {
    if (legal[c] == 0) continue;
    const uint32_t bits = hash_u32((uint32_t)c * 0x9E3779B9u + mix);
    float u = __fmul_rn((float)(int)(bits >> 8), 1.0f / 16777216.0f);
    u = fmaxf(u, 1e-7f);
    const float g = -logf(-logf(u));
    const int id = cell_id[c];
    if (g > best || (g == best && id < action)) {
      best = g;
      action = id;
    }
  }
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) {
    const float og = __shfl_xor_sync(FULL, best, o);
    const int oid = __shfl_xor_sync(FULL, action, o);
    if (og > best || (og == best && oid < action)) {
      best = og;
      action = oid;
    }
  }
  return action;
}

// ops/step.py::step for one env, by its warp; updates ``s`` and returns the
// new result.
__device__ int step(const Board& b, Scalars& s, int action, const int* geo, int n, int p,
                    int lane) {
  const int pp = b.pp;
  const int player = s.cur;
  const int8_t player_c = (int8_t)player;  // as the color plane's dtype
  const int mc = s.mc;
  const int move_one = s.move_one;
  const bool is_swap = (mc == 1) && (action == move_one);
  auto wrap = [p](int v) { return v < 0 ? v + p : (v >= p ? v - p : v); };

  // swap: undo move one (twixtboard.cc:450-455); move 2 without swap: move
  // one leaves both legal sets
  const int m1x = floordiv(move_one, n) + PAD, m1y = floormod(move_one, n) + PAD;
  const bool m1_on = m1x >= 0 && m1x < p;
  if (lane == 0 && m1_on) {
    const int m1 = m1x * p + m1y;
    if (is_swap) b.color()[m1] = COLOR_EMPTY;
    if (mc == 1 && !is_swap) {
      b.legal(0)[m1] = 0;
      b.legal(1)[m1] = 0;
    }
  }

  int eff = action;
  if (is_swap) eff = floormod(action, n) * n + (n - 1 - floordiv(action, n));
  const int ex = floordiv(eff, n) + PAD, ey = floormod(eff, n) + PAD;
  const bool me_on = ex >= 0 && ex < p;  // ey is always on the board

  int nf = 0;  // the merged flag byte (0 when the peg is off the board)
  if (me_on) {
    const int me = ex * p + ey;
    if (lane == 0) b.color()[me] = player_c;
    __syncwarp();

    // lane d < 8: direction d.  Its neighbour is a cell of its own (P >= 11,
    // offsets <= 2), never the peg's.
    bool lk = false, bk = false;
    int target = 0, nflags = 0, ncid = BIG;  // BIG: no linked component
    if (lane < 8) {
      target = wrap(ex + geo[GEO_OFFSETS + 2 * lane]) * p +
               wrap(ey + geo[GEO_OFFSETS + 2 * lane + 1]);
      if (b.color()[target] == player_c) {
        const int* cr = geo + GEO_CROSSERS + lane * 27;
        bool crossed = false;
        for (int j = 0; j < 9 && !crossed; ++j) {
          crossed = (b.links()[wrap(ex + cr[3 * j]) * p + wrap(ey + cr[3 * j + 1])] >>
                     cr[3 * j + 2]) & 1;
        }
        lk = !crossed;
        bk = crossed;
      }
      if (lk) {
        nflags = b.flags()[target];
        const int cid = b.compid()[target];
        if (cid >= 0) ncid = cid;
      }
    }
    // every read of the pre-move links, flags and compid is done once the
    // warp has voted
    const unsigned linked = __ballot_sync(FULL, lk);
    const unsigned blkd = __ballot_sync(FULL, bk);
    nf = b.flags()[me] | (int)__reduce_or_sync(FULL, (unsigned)nflags);
    const int nid = min(eff, __reduce_min_sync(FULL, ncid));
    const bool any_cid = __any_sync(FULL, ncid != BIG);
    int cids[8];
#pragma unroll
    for (int d = 0; d < 8; ++d) cids[d] = __shfl_sync(FULL, ncid, d);

    // link / blocked bits on both endpoints
    if (lane < 8) {
      const uint8_t back = (uint8_t)(1u << ((lane + 4) & 7));
      if (lk) b.links()[target] |= back;
      if (bk) b.blocked()[target] |= back;
    } else if (lane == 8) {
      b.links()[me] |= (uint8_t)linked;
      b.blocked()[me] |= (uint8_t)blkd;
    }

    // union-find merge: the peg and every cell of the linked components
    // take the smallest id and the merged flag byte
    if (any_cid) {
      for (int c = lane; c < pp; c += WARP) {
        const int v = b.compid()[c];
        bool hit = c == me;
#pragma unroll
        for (int i = 0; i < 8; ++i) hit |= v == cids[i];
        if (hit) {
          b.compid()[c] = (int16_t)nid;
          b.flags()[c] = (uint8_t)nf;
        }
      }
    } else if (lane == 0) {
      b.compid()[me] = (int16_t)nid;
      b.flags()[me] = (uint8_t)nf;
    }

    // legal bookkeeping: move one stays legal for one ply
    if (lane == 0 && mc != 0) {
      b.legal(0)[me] = 0;
      b.legal(1)[me] = 0;
    }
  }
  __syncwarp();

  // result (UpdateResult, twixtboard.cc:192-207)
  const int sh = player * 2;
  const bool win = sh >= 0 && sh + 1 < 32 && ((nf >> sh) & 1) && ((nf >> (sh + 1)) & 1);
  const int opp = 1 - player;
  const uint8_t* opp_legal = b.legal(opp == 0 ? 0 : 1);
  bool found = false;
  for (int c = lane; c < pp && !found; c += WARP) found = opp_legal[c] != 0;
  const bool opp_has_legal = __any_sync(FULL, found);
  const int result =
      win ? RESULT_RED_WIN + player : (opp_has_legal ? RESULT_OPEN : RESULT_DRAW);

  s.cur = (result == RESULT_OPEN) ? opp : TERMINAL_PLAYER_ID;
  s.move_one = (mc == 0) ? eff : move_one;
  s.mc = mc + 1;
  s.swapped |= is_swap ? 1 : 0;
  s.result = result;
  return result;
}

__global__ void __launch_bounds__(MAX_ENVS_PER_BLOCK * WARP, 2) fused_tensor_rollout_kernel(
    int* __restrict__ cells, int* __restrict__ scalars, int* __restrict__ actions,
    int* __restrict__ results, const int* __restrict__ init_cells,
    const int* __restrict__ init_scalars, const int* __restrict__ geo_table,
    uint32_t seed, int n, int num_steps, int batch, int tile) {
  __shared__ int s_geo[GEO_LEN];
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = n + 2 * PAD, pp = p * p;
  const int envs = blockDim.x / WARP;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int env0 = blockIdx.x * envs;
  const int live = min(envs, batch - env0);  // warps of this block with an env
  int16_t* cell_id = reinterpret_cast<int16_t*>(smem);
  const Board init{smem + id_table_bytes(pp), pp};
  auto board = [&](int w) {
    return Board{smem + id_table_bytes(pp) + (1 + w) * board_bytes(pp), pp};
  };

  for (int i = threadIdx.x; i < GEO_LEN; i += blockDim.x) s_geo[i] = geo_table[i];
  for (int c = threadIdx.x; c < pp; c += blockDim.x) {
    cell_id[c] = (int16_t)((c / p - PAD) * n + (c % p - PAD));
  }
  for (int i = threadIdx.x; i < NUM_CELL_PLANES * pp; i += blockDim.x) {
    init.set(i / pp, i % pp, __ldg(init_cells + i));
  }
  // the block's boards, env fastest: neighbouring threads read neighbouring
  // words (plane-cell pc of env0 + w is cells[pc * B + env0 + w])
  for (int i = threadIdx.x; i < NUM_CELL_PLANES * pp * live; i += blockDim.x) {
    const int pc = i / live, w = i - pc * live;
    board(w).set(pc / pp, pc % pp, cells[(long long)pc * batch + env0 + w]);
  }
  __syncthreads();

  if (warp < live) {
    const Board b = board(warp);
    const int env = env0 + warp;
    Scalars s{scalars[(long long)CUR * batch + env], scalars[(long long)MC * batch + env],
              scalars[(long long)MOVE_ONE * batch + env],
              scalars[(long long)SWAPPED * batch + env],
              scalars[(long long)RESULT * batch + env]};
    const Scalars s0{__ldg(init_scalars + CUR), __ldg(init_scalars + MC),
                     __ldg(init_scalars + MOVE_ONE), __ldg(init_scalars + SWAPPED),
                     __ldg(init_scalars + RESULT)};
    const uint32_t program_seed = seed + (uint32_t)(env / tile) * 0x01000193u;
    const uint32_t e_in_tile = (uint32_t)(env % tile);
    const uint4* init_vec = reinterpret_cast<const uint4*>(init.base);
    uint4* board_vec = reinterpret_cast<uint4*>(b.base);

    for (int k = 0; k < num_steps; ++k) {
      __syncwarp();
      const uint32_t noise = hash_u32(program_seed + 2654435761u * (uint32_t)(k + 1));
      const int action = sample_action(b, cell_id, s.cur, e_in_tile * 0x85EBCA6Bu + noise,
                                       lane);
      const int result = step(b, s, action, s_geo, n, p, lane);
      if (lane == 0) {
        actions[(long long)k * batch + env] = action;
        results[(long long)k * batch + env] = result;
      }
      if (result != RESULT_OPEN) {
        // auto-reset: the whole initial state, swapped included
        __syncwarp();
        for (int i = lane; i < board_bytes(pp) / 16; i += WARP) board_vec[i] = init_vec[i];
        s = s0;
      }
    }
    if (lane < NUM_SCALARS) {
      const int v = lane == CUR ? s.cur : lane == MC ? s.mc : lane == MOVE_ONE ? s.move_one
                  : lane == SWAPPED ? s.swapped : s.result;
      scalars[(long long)lane * batch + env] = v;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < NUM_CELL_PLANES * pp * live; i += blockDim.x) {
    const int pc = i / live, w = i - pc * live;
    cells[(long long)pc * batch + env0 + w] = board(w).get(pc / pp, pc % pp);
  }
}

// The envs (warps) per block at this board size and batch: the most envs
// resident per SM (by the occupancy calculator, with the shared memory that
// many boards need), over W = 1 .. min(16, batch / SMs) so that small
// batches still spread over every SM; ties go to the larger W.  Returns a
// CUDA error code and sets *envs and *smem.
cudaError_t launch_shape(int n, int batch, int* envs, int* smem) {
  const int p = n + 2 * PAD, pp = p * p;
  int device = 0, sms = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fused_tensor_rollout_kernel);
  const int max_dynamic = optin - (int)attr.sharedSizeBytes;
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(fused_tensor_rollout_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, max_dynamic);
  }
  if (err != cudaSuccess) return err;
  const int cap = max(1, min(MAX_ENVS_PER_BLOCK, batch / max(sms, 1)));
  int best = 1, best_resident = -1;
  for (int w = 1; w <= cap && shared_bytes(pp, w) <= max_dynamic; ++w) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fused_tensor_rollout_kernel, w * WARP, shared_bytes(pp, w));
    if (err != cudaSuccess) return err;
    if (blocks * w >= best_resident) {
      best_resident = blocks * w;
      best = w;
    }
  }
  *envs = best;
  *smem = shared_bytes(pp, best);
  return cudaSuccess;
}

bool valid(int board_size, int batch, int num_steps, int tile) {
  return board_size >= MIN_N && board_size <= MAX_N && batch >= 1 && num_steps >= 0 &&
         tile >= 1 && batch % tile == 0;
}

}  // namespace

extern "C" {

// Launch the rollout on ``stream``; returns a CUDA error code (0 = ok).
// Pointers are device pointers of the wrapper's tensors (layouts above);
// init_cells [7, P, P] and init_scalars [5] hold one env's initial state.
int twixt_fused_tensor_rollout(void* cells, void* scalars, void* actions, void* results,
                               const void* init_cells, const void* init_scalars,
                               const void* geo_table, unsigned int seed, int board_size,
                               int num_steps, int batch, int tile, void* stream) {
  if (!valid(board_size, batch, num_steps, tile)) return (int)cudaErrorInvalidValue;
  int envs = 0, smem = 0;
  const cudaError_t err = launch_shape(board_size, batch, &envs, &smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (batch + envs - 1) / envs;
  fused_tensor_rollout_kernel<<<blocks, envs * WARP, smem, (cudaStream_t)stream>>>(
      (int*)cells, (int*)scalars, (int*)actions, (int*)results, (const int*)init_cells,
      (const int*)init_scalars, (const int*)geo_table, (uint32_t)seed, board_size,
      num_steps, batch, tile);
  return (int)cudaGetLastError();
}

// The envs per block a launch at this board size and batch takes, or minus
// a CUDA error code.
int twixt_fused_tensor_rollout_envs_per_block(int board_size, int batch) {
  if (!valid(board_size, batch, 0, 1)) return -(int)cudaErrorInvalidValue;
  int envs = 0, smem = 0;
  const cudaError_t err = launch_shape(board_size, batch, &envs, &smem);
  return err == cudaSuccess ? envs : -(int)err;
}

const char* twixt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
