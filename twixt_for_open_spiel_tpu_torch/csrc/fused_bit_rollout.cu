// Fused lockstep random rollout on the TwixT bitboard engine, for Hopper.
//
// Replaces the Pallas TPU kernel twixt_for_open_spiel_tpu/ops/
// fused_bit_rollout.py::fused_bit_rollout (kernel body _make_kernel.kernel),
// both of its arms: emit_obs=False (the rollout) and emit_obs=True (the
// rollout plus the per-step packed learner wire).  The JAX kernel keeps a
// batch tile of envs in VMEM and runs the vectorised step_bits over it; on
// the card the same work becomes one thread per env running the step as the
// per-env scalar code it describes, for all num_steps in one launch.
//
// Semantics are those of ops/bitboard.py of this package (the plain torch
// version) and must stay bit-identical to it: the same counter-hash noise
// keyed by the global env index, the same float32 draw of the rank k, the
// same popcount-rank selection, the same step_bits, the same auto-reset.
//
// Layout (the JAX layout, env trailing, so neighbouring threads touch
// neighbouring words and every access coalesces):
//   planes   u32 [16, P, B]  red, blue, links[4], blocked[4], legal[2], flags[4]
//   compid   i16 [n, n, B]
//   scalars  i32 [5, B]      current_player, move_counter, move_one,
//                            swapped, result
//   obs      u32 [T, 12, P, B] (emit_obs only)
// updated in place (the wrapper hands in fresh copies of the caller's state).
//
// What bounds it on this card: per-env serial integer work (a step reads
// ~100-300 words that depend on the peg's position, plus an n*n compid scan
// when a link merges components), over 1-3 KB of state per env that lives
// in device memory and is served by L1/L2.  Nothing here is bandwidth- or
// FLOP-bound: the limits are how many SMs have envs to run (at B = 4096 the
// grid is 16 blocks of 256 threads for 132 SMs) and, on each SM, issuing
// this branchy scalar code (at board 8 one block already fills an SM) or
// waiting on memory (at board 24).  This first design does nothing about
// that beyond coalescing and reading each word only where the step needs
// it (direct indexing instead of the TPU's masked whole-plane reductions);
// a warp per env or state in shared memory is later work (PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (see ops/_cuda.py).  Plain C entry points, bound with
// ctypes; no PyTorch headers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PAD = 3;
constexpr int NUM_PLANES = 16;
constexpr int MIN_N = 5;
constexpr int MAX_N = 24;
constexpr int MAX_P = MAX_N + 2 * PAD;
constexpr int NUM_SCALARS = 5;
constexpr int BIG = 1 << 20;
constexpr int THREADS = 256;
// geometry table: OFFSETS [8][2] then CROSSERS [8][9][3] (dx, dy, dir2)
constexpr int GEO_OFFSETS = 0;
constexpr int GEO_CROSSERS = 16;
constexpr int GEO_LEN = 16 + 8 * 9 * 3;

enum Plane { RED = 0, BLUE = 1, LINKS = 2, BLOCKED = 6, LEGAL = 10, FLAGS = 12 };
enum Scalar { CUR = 0, MC = 1, MOVE_ONE = 2, SWAPPED = 3, RESULT = 4 };

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

// u32 1 << y, 0 where the JAX shift would shift the bit out
__device__ __forceinline__ uint32_t bit_at(int y) {
  return (y >= 0 && y < 32) ? (1u << y) : 0u;
}
__device__ __forceinline__ bool probe(uint32_t word, int y) {
  return (word & bit_at(y)) != 0u;
}

// One env's view of the state buffers.
struct Env {
  uint32_t* planes;
  short* compid;
  int* scalars;
  long long batch;
  int env;
  int n;
  int p;

  __device__ uint32_t& w(int plane, int x) const {
    return planes[((long long)plane * p + x) * batch + env];
  }
  // word of row x, 0 off the plane (the JAX masked row reduction's value)
  __device__ uint32_t row(int plane, int x) const {
    return (x >= 0 && x < p) ? w(plane, x) : 0u;
  }
  __device__ short& c(int x, int y) const {
    return compid[((long long)x * n + y) * batch + env];
  }
  __device__ int& s(int i) const { return scalars[(long long)i * batch + env]; }
};

// Position of the (k+1)-th lowest set bit: the 5-step halving search of
// ops/bitboard.py::_select_kth_bit.
__device__ __forceinline__ int select_kth_bit(uint32_t w, int k) {
  int pos = 0;
#pragma unroll
  for (int width = 16; width >= 1; width >>= 1) {
    int cnt = __popc((w >> pos) & ((1u << width) - 1u));
    if (k >= cnt) {
      k -= cnt;
      pos += width;
    }
  }
  return pos;
}

// Uniform legal action by popcount rank (ops/bitboard.py::sample_bits).
__device__ int sample_action(const Env& e, uint32_t noise) {
  const int plane = LEGAL + min(max(e.s(CUR), 0), 1);
  int total = 0;
  for (int x = 0; x < e.p; ++x) total += __popc(e.w(plane, x));
  const uint32_t bits = hash_u32(noise);
  // float32 throughout, no contraction: u = (bits >> 8) * 2^-24, k = u*total
  const float u = __fmul_rn((float)(int)(bits >> 8), 1.0f / 16777216.0f);
  int k = __float2int_rz(__fmul_rn(u, (float)total));
  k = max(min(k, total - 1), 0);
  int run = 0, col = BIG, kin = 0;
  uint32_t word = 0u;
  for (int x = 0; x < e.p; ++x) {
    const uint32_t r = e.w(plane, x);
    const int c = __popc(r);
    if (run <= k && run + c > k) {
      col = x;
      word = r;
      kin = k - run;
    }
    run += c;
  }
  return (col - PAD) * e.n + (select_kth_bit(word, kin) - PAD);
}

// Clear (x, y)'s bit of a plane; a cell off the plane has no bit.
__device__ __forceinline__ void clear_cell(const Env& e, int plane, int x, int y) {
  if (x >= 0 && x < e.p) e.w(plane, x) &= ~bit_at(y);
}

// ops/bitboard.py::step_bits for one env; returns the new result.
__device__ int step_bits(const Env& e, int action, const int* geo) {
  const int n = e.n;
  const int player = e.s(CUR);
  const int mc = e.s(MC);
  const int move_one = e.s(MOVE_ONE);
  const bool is_swap = (mc == 1) && (action == move_one);

  // swap undo (twixtboard.cc:450-455): clear move one's peg
  const int m1x = floordiv(move_one, n) + PAD;
  const int m1y = floormod(move_one, n) + PAD;
  if (is_swap) {
    clear_cell(e, RED, m1x, m1y);
    clear_cell(e, BLUE, m1x, m1y);
  }
  int eff = action;
  if (is_swap) {
    const int ax = floordiv(action, n), ay = floormod(action, n);
    eff = ay * n + (n - 1 - ax);  // swap_rotate_action
  }
  const int px = floordiv(eff, n), py = floormod(eff, n);
  const int ex = px + PAD, ey = py + PAD;
  const bool me_row = ex >= 0 && ex < e.p;
  const uint32_t meb = bit_at(ey);

  // move 2 without swap: move one leaves both legal sets
  if (mc == 1 && !is_swap) {
    clear_cell(e, LEGAL, m1x, m1y);
    clear_cell(e, LEGAL + 1, m1x, m1y);
  }
  // place the peg
  const int mine = (player == 0) ? RED : BLUE;
  if (me_row) e.w(mine, ex) |= meb;

  // links / blocked (SetPegAndLinks, twixtboard.cc:501-571): every probe
  // reads the pre-move links, so updates wait until all 8 are decided
  const int* off = geo + GEO_OFFSETS;
  unsigned linked = 0u, blkd = 0u;
  for (int d = 0; d < 8; ++d) {
    const int dx = off[2 * d], dy = off[2 * d + 1];
    if (!probe(e.row(mine, ex + dx), ey + dy)) continue;
    bool crossed = false;
    const int* cr = geo + GEO_CROSSERS + d * 27;
    for (int j = 0; j < 9; ++j) {
      crossed |= probe(e.row(LINKS + cr[3 * j + 2], ex + cr[3 * j]),
                       ey + cr[3 * j + 1]);
    }
    if (crossed) {
      blkd |= 1u << d;
    } else {
      linked |= 1u << d;
    }
  }

  // merged flag byte: own cell's flags | flags of each newly linked
  // neighbour (pre-move flags)
  int nf = 0;
  for (int b = 0; b < 4; ++b) {
    bool got = probe(e.row(FLAGS + b, ex), ey);
    for (int d = 0; d < 8; ++d) {
      if ((linked >> d) & 1u) {
        got |= probe(e.row(FLAGS + b, ex + off[2 * d]), ey + off[2 * d + 1]);
      }
    }
    if (got) nf |= 1 << b;
  }

  // link / blocked bits land on the pair's west endpoint, in its canonical
  // direction: on the new peg for d < 4, on the neighbour for d >= 4
  if (me_row) {
    for (int d = 0; d < 8; ++d) {
      const unsigned mask = 1u << d;
      if (!((linked | blkd) & mask)) continue;
      const int base = (linked & mask) ? LINKS : BLOCKED;
      if (d < 4) {
        e.w(base + d, ex) |= meb;
      } else {
        const int dx = off[2 * d], dy = off[2 * d + 1];
        const int tx = ((ex + dx) % e.p + e.p) % e.p;  // _shiftp rolls
        e.w(base + d - 4, tx) |= bit_at(ey + dy);
      }
    }
  }

  // union-find merge: the new id is the smallest of the peg's own id and
  // its linked neighbours' ids; every cell of those components takes it
  int nid = eff;
  short cids[8];
  int ncid = 0;
  for (int d = 0; d < 8; ++d) {
    if (!((linked >> d) & 1u)) continue;
    const int cx = px + off[2 * d], cy = py + off[2 * d + 1];
    const short cid =
        (cx >= 0 && cx < n && cy >= 0 && cy < n) ? e.c(cx, cy) : (short)-20000;
    if (cid >= 0) {
      nid = min(nid, (int)cid);
      cids[ncid++] = cid;
    }
  }
  const short nid16 = (short)nid;
  if (ncid == 0) {
    // no linked component: the hit set is the peg's own cell
    if (px >= 0 && px < n && py >= 0 && py < n) {
      e.c(px, py) = nid16;
      for (int b = 0; b < 4; ++b) {
        if ((nf >> b) & 1) e.w(FLAGS + b, ex) |= meb;
      }
    }
  } else {
    for (int x = 0; x < n; ++x) {
      uint32_t hit_word = 0u;
      for (int y = 0; y < n; ++y) {
        const short v = e.c(x, y);
        bool hit = (x == px) && (y == py);
#pragma unroll
        for (int i = 0; i < 8; ++i) hit |= (i < ncid) && (v == cids[i]);
        if (hit) {
          e.c(x, y) = nid16;
          hit_word |= 1u << (y + PAD);
        }
      }
      if (hit_word) {
        // stamp the merged flag byte on the whole united component
        for (int b = 0; b < 4; ++b) {
          if ((nf >> b) & 1) e.w(FLAGS + b, x + PAD) |= hit_word;
        }
      }
    }
  }

  // legal bookkeeping: move one stays legal for one ply
  if (mc != 0 && me_row) {
    e.w(LEGAL, ex) &= ~meb;
    e.w(LEGAL + 1, ex) &= ~meb;
  }

  // result (UpdateResult, twixtboard.cc:192-207)
  const int sh = player * 2;
  const bool win = sh >= 0 && sh + 1 < 32 && ((nf >> sh) & 1) && ((nf >> (sh + 1)) & 1);
  const int opp = 1 - player;
  const int opp_plane = (opp == 0) ? LEGAL : LEGAL + 1;
  bool opp_has_legal = false;
  for (int x = 0; x < e.p && !opp_has_legal; ++x) opp_has_legal = e.w(opp_plane, x) != 0u;
  const int result =
      win ? RESULT_RED_WIN + player : (opp_has_legal ? RESULT_OPEN : RESULT_DRAW);

  e.s(CUR) = (result == RESULT_OPEN) ? opp : TERMINAL_PLAYER_ID;
  e.s(MC) = mc + 1;
  e.s(MOVE_ONE) = (mc == 0) ? eff : move_one;
  e.s(SWAPPED) |= is_swap ? 1 : 0;
  e.s(RESULT) = result;
  return result;
}

// The 12 packed observation planes of the pre-move state, with the mover's
// legal plane in the low 3 bits of planes 0..7 (ops/observe.py:
// bit_observation_packed_lanes + pack_legal_into_lanes).
__device__ void emit_obs(const Env& e, uint32_t* obs, int step, const int* geo) {
  const int* off = geo + GEO_OFFSETS;
  const int legal = LEGAL + min(max(e.s(CUR), 0), 1);
  for (int x = 0; x < e.p; ++x) {
    uint32_t l[4], any_link = 0u, blocked_e = 0u;
    for (int d = 0; d < 4; ++d) {
      l[d] = e.w(LINKS + d, x);
      any_link |= l[d];
      blocked_e |= e.w(BLOCKED + d, x);
    }
    for (int d = 4; d < 8; ++d) {  // west directions: expand_planes
      const int dx = off[2 * d], dy = off[2 * d + 1];
      const uint32_t src = e.w(LINKS + d - 4, ((x + dx) % e.p + e.p) % e.p);
      any_link |= (dy > 0) ? (src >> dy) : (src << -dy);
    }
    const uint32_t red = e.w(RED, x), blue = e.w(BLUE, x);
    const uint32_t leg = e.w(legal, x);
    uint32_t planes[12];
    planes[0] = red & ~any_link;
    planes[6] = blue & ~any_link;
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
    for (int j = 0; j < 12; ++j) {
      obs[(((long long)step * 12 + j) * e.p + x) * e.batch + e.env] = planes[j];
    }
  }
}

__global__ void __launch_bounds__(THREADS) fused_bit_rollout_kernel(
    uint32_t* __restrict__ planes, short* __restrict__ compid,
    int* __restrict__ scalars, int* __restrict__ episodes,
    int* __restrict__ results, uint32_t* __restrict__ obs,
    const uint32_t* __restrict__ init_planes,
    const short* __restrict__ init_compid,
    const int* __restrict__ init_scalars, const int* __restrict__ geo_table,
    uint32_t seed, int n, int num_steps, int batch) {
  __shared__ int s_geo[GEO_LEN];
  __shared__ uint32_t s_init_planes[NUM_PLANES * MAX_P];
  __shared__ short s_init_compid[MAX_N * MAX_N];
  __shared__ int s_init_scalars[NUM_SCALARS];
  const int p = n + 2 * PAD;
  for (int i = threadIdx.x; i < GEO_LEN; i += blockDim.x) s_geo[i] = geo_table[i];
  for (int i = threadIdx.x; i < NUM_PLANES * p; i += blockDim.x)
    s_init_planes[i] = init_planes[i];
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) s_init_compid[i] = init_compid[i];
  if (threadIdx.x < NUM_SCALARS) s_init_scalars[threadIdx.x] = init_scalars[threadIdx.x];
  __syncthreads();

  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= batch) return;  // the ragged edge
  const Env e{planes, compid, scalars, (long long)batch, env, n, p};

  int ep = 0, r0 = 0, r1 = 0, r2 = 0, r3 = 0;
  for (int k = 0; k < num_steps; ++k) {
    if (obs != nullptr) emit_obs(e, obs, k, s_geo);
    const uint32_t noise = hash_u32(seed + 2654435761u * (uint32_t)(k + 1)) +
                           (uint32_t)env * 0x9E3779B9u;
    const int result = step_bits(e, sample_action(e, noise), s_geo);
    if (result != RESULT_OPEN) {
      // auto-reset to the batch-1 initial state built by the wrapper
      ++ep;
      r0 += result == 0;
      r1 += result == 1;
      r2 += result == 2;
      r3 += result == 3;
      for (int i = 0; i < NUM_PLANES * p; ++i) e.w(i / p, i % p) = s_init_planes[i];
      for (int i = 0; i < n * n; ++i) e.c(i / n, i % n) = s_init_compid[i];
      for (int i = 0; i < NUM_SCALARS; ++i) e.s(i) = s_init_scalars[i];
    }
  }
  episodes[env] = ep;
  results[0 * (long long)batch + env] = r0;
  results[1 * (long long)batch + env] = r1;
  results[2 * (long long)batch + env] = r2;
  results[3 * (long long)batch + env] = r3;
}

}  // namespace

extern "C" {

// Launch the rollout on ``stream``; returns cudaGetLastError() (0 = ok).
// Pointers are device pointers of the wrapper's tensors (layouts above);
// ``obs`` is null unless the per-step wire is wanted.
int twixt_fused_bit_rollout(void* planes, void* compid, void* scalars,
                            void* episodes, void* results, void* obs,
                            const void* init_planes, const void* init_compid,
                            const void* init_scalars, const void* geo_table,
                            unsigned int seed, int board_size, int num_steps,
                            int batch, void* stream) {
  if (board_size < MIN_N || board_size > MAX_N || batch < 1 || num_steps < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (batch + THREADS - 1) / THREADS;
  fused_bit_rollout_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (uint32_t*)planes, (short*)compid, (int*)scalars, (int*)episodes,
      (int*)results, (uint32_t*)obs, (const uint32_t*)init_planes,
      (const short*)init_compid, (const int*)init_scalars,
      (const int*)geo_table, (uint32_t)seed, board_size, num_steps, batch);
  return (int)cudaGetLastError();
}

const char* twixt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
