// Fused lockstep random rollout on the canonical TwixT engine, for Hopper.
//
// Replaces the Pallas TPU kernel scripts/archive_fused_tensor_rollout.py::
// fused_random_rollout (kernel body _make_kernel.kernel): num_steps lockstep
// random-policy steps of every env, with Gumbel-max sampling keyed by a
// counter hash, the canonical transition ops/step.py::step_impl and
// auto-reset, recording every action and every pre-reset result.  The TPU
// kernel keeps a batch tile in VMEM and runs step_impl as ~80 whole-board
// shifts; here one thread runs one env, and the step touches only what the
// peg reaches: its 8 knight neighbours and their 72 crossing probes
// (geometry.CROSSERS), a compid/flags remap scan when a link merges
// components, the legal-cell removal and the opponent-has-legal test.
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
// Layout (the JAX kernel's int32 working layout, env trailing, so
// neighbouring threads touch neighbouring words and every access
// coalesces):
//   cells    i32 [7, P, P, B]  color, links, blocked, compid, flags, legal[2]
//   scalars  i32 [5, B]        current_player, move_counter, move_one,
//                              swapped, result
//   actions, results  i32 [K, B]
// updated in place (the wrapper hands in fresh int32 copies).
//
// What bounds it on this card: per-env serial work, not bytes.  A step
// scans the mover's legal plane (P*P words) and spends a hash and two logf
// on every legal cell (~500 at board 24), plus a P*P compid scan whenever
// a link merges components; the state (7 P*P words per env, 25 KB at board
// 24) lives in device memory and is served by L1/L2.  This first design
// only keeps every access coalesced and the step local; fewer cells per
// draw, the state in shared memory, or a warp per env is later work
// (PERF.md).
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
constexpr int THREADS = 64;
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

// One env's view of the state buffers.
struct Env {
  int* cells;
  int* scalars;
  long long batch;
  int env;
  int n;
  int p;

  // board index wrapped into [0, P): the roll of the TPU kernel's shifts
  // (every offset is at most PAD, so one correction suffices)
  __device__ int wrap(int v) const { return v < 0 ? v + p : (v >= p ? v - p : v); }
  __device__ int& c(int plane, int x, int y) const {
    return cells[(((long long)plane * p + x) * p + y) * batch + env];
  }
  __device__ int& s(int i) const { return scalars[(long long)i * batch + env]; }
};

// Gumbel-max legal action of the player to move (_sample_actions).
__device__ int sample_action(const Env& e, uint32_t noise, uint32_t e_in_tile) {
  const int plane = LEGAL + min(max(e.s(CUR), 0), 1);
  const uint32_t mix = e_in_tile * 0x85EBCA6Bu + noise;
  float best = -INFINITY;
  int action = BIG;
  for (int x = 0; x < e.p; ++x) {
    for (int y = 0; y < e.p; ++y) {
      if (e.c(plane, x, y) == 0) continue;
      const uint32_t cell = (uint32_t)(x * e.p + y);
      const uint32_t bits = hash_u32(cell * 0x9E3779B9u + mix);
      float u = __fmul_rn((float)(int)(bits >> 8), 1.0f / 16777216.0f);
      u = fmaxf(u, 1e-7f);
      const float g = -logf(-logf(u));
      const int id = (x - PAD) * e.n + (y - PAD);
      if (g > best || (g == best && id < action)) {
        best = g;
        action = id;
      }
    }
  }
  return action;
}

// ops/step.py::step for one env; returns the new result.
__device__ int step(const Env& e, int action, const int* geo) {
  const int n = e.n, p = e.p;
  const int player = e.s(CUR);
  const int mc = e.s(MC);
  const int move_one = e.s(MOVE_ONE);
  const bool is_swap = (mc == 1) && (action == move_one);

  // swap: undo move one (twixtboard.cc:450-455)
  const int m1x = floordiv(move_one, n) + PAD, m1y = floormod(move_one, n) + PAD;
  const bool m1_on = m1x >= 0 && m1x < p;
  if (is_swap && m1_on) e.c(COLOR, m1x, m1y) = COLOR_EMPTY;

  int eff = action;
  if (is_swap) eff = floormod(action, n) * n + (n - 1 - floordiv(action, n));
  const int ex = floordiv(eff, n) + PAD, ey = floormod(eff, n) + PAD;
  const bool me_on = ex >= 0 && ex < p;  // ey is always on the board

  // move 2 without swap: move one leaves both legal sets
  if (mc == 1 && !is_swap && m1_on) {
    e.c(LEGAL, m1x, m1y) = 0;
    e.c(LEGAL + 1, m1x, m1y) = 0;
  }

  int nf = 0;  // the merged flag byte (0 when the peg is off the board)
  if (me_on) {
    e.c(COLOR, ex, ey) = player;

    // links / blocked: all 8 directions read the pre-move links
    const int* off = geo + GEO_OFFSETS;
    unsigned linked = 0u, blkd = 0u;
    for (int d = 0; d < 8; ++d) {
      if (e.c(COLOR, e.wrap(ex + off[2 * d]), e.wrap(ey + off[2 * d + 1])) != player) continue;
      bool crossed = false;
      const int* cr = geo + GEO_CROSSERS + d * 27;
      for (int j = 0; j < 9 && !crossed; ++j) {
        crossed = (e.c(LINKS, e.wrap(ex + cr[3 * j]), e.wrap(ey + cr[3 * j + 1])) >>
                   cr[3 * j + 2]) & 1;
      }
      if (crossed) {
        blkd |= 1u << d;
      } else {
        linked |= 1u << d;
      }
    }

    // merged flag byte and neighbour component ids, from the pre-merge
    // flags / compid
    nf = e.c(FLAGS, ex, ey);
    int nid = eff;
    int cids[8];  // -1: no new link in that direction (never matches)
    bool any_cid = false;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      cids[d] = -1;
      if (!((linked >> d) & 1u)) continue;
      const int tx = e.wrap(ex + off[2 * d]), ty = e.wrap(ey + off[2 * d + 1]);
      nf |= e.c(FLAGS, tx, ty);
      const int cid = e.c(COMPID, tx, ty);
      if (cid >= 0) {
        nid = min(nid, cid);
        cids[d] = cid;
        any_cid = true;
      }
    }

    // link / blocked bits on both endpoints
    for (int d = 0; d < 8; ++d) {
      const unsigned mask = 1u << d;
      if (!((linked | blkd) & mask)) continue;
      const int plane = (linked & mask) ? LINKS : BLOCKED;
      const int tx = e.wrap(ex + off[2 * d]), ty = e.wrap(ey + off[2 * d + 1]);
      e.c(plane, ex, ey) |= 1 << d;
      e.c(plane, tx, ty) |= 1 << ((d + 4) & 7);
    }

    // union-find merge: the peg and every cell of the linked components
    // take the smallest id and the merged flag byte
    if (any_cid) {
      for (int x = 0; x < p; ++x) {
        for (int y = 0; y < p; ++y) {
          const int v = e.c(COMPID, x, y);
          bool hit = (x == ex) && (y == ey);
#pragma unroll
          for (int i = 0; i < 8; ++i) hit |= (cids[i] >= 0) && (v == cids[i]);
          if (hit) {
            e.c(COMPID, x, y) = nid;
            e.c(FLAGS, x, y) = nf;
          }
        }
      }
    } else {
      e.c(COMPID, ex, ey) = nid;
      e.c(FLAGS, ex, ey) = nf;
    }

    // legal bookkeeping: move one stays legal for one ply
    if (mc != 0) {
      e.c(LEGAL, ex, ey) = 0;
      e.c(LEGAL + 1, ex, ey) = 0;
    }
  }

  // result (UpdateResult, twixtboard.cc:192-207)
  const int sh = player * 2;
  const bool win = sh >= 0 && sh + 1 < 32 && ((nf >> sh) & 1) && ((nf >> (sh + 1)) & 1);
  const int opp = 1 - player;
  const int opp_plane = (opp == 0) ? LEGAL : LEGAL + 1;
  bool opp_has_legal = false;
  for (int x = 0; x < p && !opp_has_legal; ++x) {
    for (int y = 0; y < p && !opp_has_legal; ++y) opp_has_legal = e.c(opp_plane, x, y) != 0;
  }
  const int result =
      win ? RESULT_RED_WIN + player : (opp_has_legal ? RESULT_OPEN : RESULT_DRAW);

  e.s(CUR) = (result == RESULT_OPEN) ? opp : TERMINAL_PLAYER_ID;
  e.s(MC) = mc + 1;
  e.s(MOVE_ONE) = (mc == 0) ? eff : move_one;
  e.s(SWAPPED) |= is_swap ? 1 : 0;
  e.s(RESULT) = result;
  return result;
}

__global__ void __launch_bounds__(THREADS) fused_tensor_rollout_kernel(
    int* __restrict__ cells, int* __restrict__ scalars, int* __restrict__ actions,
    int* __restrict__ results, const int* __restrict__ init_cells,
    const int* __restrict__ init_scalars, const int* __restrict__ geo_table,
    uint32_t seed, int n, int num_steps, int batch, int tile) {
  __shared__ int s_geo[GEO_LEN];
  for (int i = threadIdx.x; i < GEO_LEN; i += blockDim.x) s_geo[i] = geo_table[i];
  __syncthreads();

  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= batch) return;
  const int p = n + 2 * PAD;
  const Env e{cells, scalars, (long long)batch, env, n, p};
  const uint32_t program_seed = seed + (uint32_t)(env / tile) * 0x01000193u;
  const uint32_t e_in_tile = (uint32_t)(env % tile);

  for (int k = 0; k < num_steps; ++k) {
    const uint32_t noise = hash_u32(program_seed + 2654435761u * (uint32_t)(k + 1));
    const int action = sample_action(e, noise, e_in_tile);
    const int result = step(e, action, s_geo);
    actions[(long long)k * batch + env] = action;
    results[(long long)k * batch + env] = result;
    if (result != RESULT_OPEN) {
      // auto-reset: the whole initial state, swapped included
      for (int i = 0; i < NUM_CELL_PLANES * p * p; ++i) {
        cells[(long long)i * batch + env] = __ldg(init_cells + i);
      }
      for (int i = 0; i < NUM_SCALARS; ++i) e.s(i) = __ldg(init_scalars + i);
    }
  }
}

}  // namespace

extern "C" {

// Launch the rollout on ``stream``; returns cudaGetLastError() (0 = ok).
// Pointers are device pointers of the wrapper's tensors (layouts above);
// init_cells [7, P, P] and init_scalars [5] hold one env's initial state.
int twixt_fused_tensor_rollout(void* cells, void* scalars, void* actions, void* results,
                               const void* init_cells, const void* init_scalars,
                               const void* geo_table, unsigned int seed, int board_size,
                               int num_steps, int batch, int tile, void* stream) {
  if (board_size < MIN_N || board_size > MAX_N || batch < 1 || num_steps < 0 ||
      tile < 1 || batch % tile != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (batch + THREADS - 1) / THREADS;
  fused_tensor_rollout_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (int*)cells, (int*)scalars, (int*)actions, (int*)results, (const int*)init_cells,
      (const int*)init_scalars, (const int*)geo_table, (uint32_t)seed, board_size,
      num_steps, batch, tile);
  return (int)cudaGetLastError();
}

const char* twixt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
