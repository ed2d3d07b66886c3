// The TwixT bitboard engine's step as device code, for one env by one warp.
//
// Shared by the whole-rollout kernel (csrc/fused_bit_rollout.cu, K1 and K2)
// and the one-step kernel over slot-indexed state (csrc/bit_step.cu, S1a).
// Semantics are those of ops/bitboard.py of this package (the plain torch
// version) and must stay bit-identical to it.  bit_at keeps shifts outside
// [0, 32) at 0, as the JAX shift gives (a CUDA shift by 32 or more is
// undefined); floordiv/floormod are jnp's // and %.
//
// One env's state lives in shared memory (Env: 16 planes of P words, then
// compid n*n int16); its scalars live in registers, the same in every lane
// of the warp.  Lane x owns padded row x (P <= 30 rows fit the warp) and
// compid row x.  The geometry table (geo) is OFFSETS [8][2] then CROSSERS
// [8][9][3] (dx, dy, dir2), as ops/_cuda.py::geo_table builds it.

#pragma once

#include <stdint.h>

namespace twixt {

constexpr int PAD = 3;
constexpr int NUM_PLANES = 16;
constexpr int MIN_N = 5;
constexpr int MAX_N = 24;
constexpr int MAX_P = MAX_N + 2 * PAD;
constexpr int NUM_SCALARS = 5;
constexpr int BIG = 1 << 20;
constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
// geometry table: OFFSETS [8][2] then CROSSERS [8][9][3] (dx, dy, dir2)
constexpr int GEO_OFFSETS = 0;
constexpr int GEO_CROSSERS = 16;
constexpr int GEO_LEN = 16 + 8 * 9 * 3;

static_assert(MAX_P <= WARP, "one lane per padded row");

enum Plane { RED = 0, BLUE = 1, LINKS = 2, BLOCKED = 6, LEGAL = 10, FLAGS = 12 };

constexpr int RESULT_OPEN = 0;
constexpr int RESULT_RED_WIN = 1;
constexpr int RESULT_DRAW = 3;
constexpr int TERMINAL_PLAYER_ID = -4;

__host__ __device__ constexpr int round_up(int v, int a) { return (v + a - 1) / a * a; }
// one env in shared memory: 16 planes of P words, then compid n*n int16
__host__ __device__ constexpr int env_bytes(int n) {
  return round_up(NUM_PLANES * (n + 2 * PAD) * 4 + n * n * 2, 16);
}
__host__ __device__ constexpr int geo_bytes() { return round_up(GEO_LEN * 4, 16); }

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

// One env's state in shared memory: planes [16][P] words, compid [n][n].
struct Env {
  uint32_t* planes;
  short* compid;
  int n;
  int p;

  __device__ Env(unsigned char* base, int n_, int p_)
      : planes(reinterpret_cast<uint32_t*>(base)),
        compid(reinterpret_cast<short*>(base + NUM_PLANES * p_ * 4)), n(n_), p(p_) {}

  __device__ uint32_t& w(int plane, int x) const { return planes[plane * p + x]; }
  // word of row x, 0 off the plane (the JAX masked row reduction's value)
  __device__ uint32_t row(int plane, int x) const {
    return (x >= 0 && x < p) ? w(plane, x) : 0u;
  }
  __device__ short& c(int x, int y) const { return compid[x * n + y]; }
};

// The env's scalars, the same in every lane of its warp.
struct Scalars {
  int cur, mc, move_one, swapped, result;
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

// ops/bitboard.py::step_bits for one env, by its warp (all 32 lanes); updates
// ``s`` and returns the new result.
//   * the owners of rows m1x and ex undo the swap, clear move one's legal bits
//     and place the peg;
//   * lanes 0-7 take one direction each and read the pre-move links, flags
//     and compid; __ballot_sync and __syncwarp order every read before the
//     first write; the 8 direction lanes then write distinct (plane, row)
//     words (every knight offset has dx != 0, so a west endpoint is never the
//     peg's row);
//   * the merge: lane x scans its n compid cells against the <= 8 linked ids
//     held in registers and stamps the merged flags on its own row;
//   * the opponent-has-legal test is a __any_sync over the rows.
__device__ int step_bits(const Env& e, Scalars& s, int action, const int* geo, int lane) {
  const int n = e.n, p = e.p;
  const int player = s.cur;
  const int mc = s.mc;
  const int move_one = s.move_one;
  const bool is_swap = (mc == 1) && (action == move_one);
  const int m1x = floordiv(move_one, n) + PAD;
  const int m1y = floormod(move_one, n) + PAD;
  int eff = action;
  if (is_swap) {
    const int ax = floordiv(action, n), ay = floormod(action, n);
    eff = ay * n + (n - 1 - ax);  // swap_rotate_action
  }
  const int px = floordiv(eff, n), py = floormod(eff, n);
  const int ex = px + PAD, ey = py + PAD;
  const bool me_row = ex >= 0 && ex < p;
  const uint32_t meb = bit_at(ey);
  const int mine = (player == 0) ? RED : BLUE;

  // the owners of rows m1x and ex: swap undo (twixtboard.cc:450-455) or,
  // on move 2 without swap, move one leaves both legal sets; then the peg
  if (lane < p) {
    if (lane == m1x) {
      const uint32_t keep = ~bit_at(m1y);
      if (is_swap) {
        e.w(RED, lane) &= keep;
        e.w(BLUE, lane) &= keep;
      } else if (mc == 1) {
        e.w(LEGAL, lane) &= keep;
        e.w(LEGAL + 1, lane) &= keep;
      }
    }
    if (lane == ex) e.w(mine, lane) |= meb;
  }
  __syncwarp();

  // lane d < 8: direction d (SetPegAndLinks, twixtboard.cc:501-571), on the
  // pre-move links; a linked neighbour's flags and component id
  const int* off = geo + GEO_OFFSETS;
  bool lk = false, bk = false;
  int nflags = 0, ncid = BIG;  // BIG: no linked component
  if (lane < 8) {
    const int dx = off[2 * lane], dy = off[2 * lane + 1];
    if (probe(e.row(mine, ex + dx), ey + dy)) {
      const int* cr = geo + GEO_CROSSERS + lane * 27;
      bool crossed = false;
      for (int j = 0; j < 9; ++j) {
        crossed |= probe(e.row(LINKS + cr[3 * j + 2], ex + cr[3 * j]), ey + cr[3 * j + 1]);
      }
      lk = !crossed;
      bk = crossed;
    }
    if (lk) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (probe(e.row(FLAGS + b, ex + dx), ey + dy)) nflags |= 1 << b;
      }
      const int cx = px + dx, cy = py + dy;
      const int cid = (cx >= 0 && cx < n && cy >= 0 && cy < n) ? e.c(cx, cy) : -20000;
      if (cid >= 0) ncid = cid;
    }
  }
  int own = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (probe(e.row(FLAGS + b, ex), ey)) own |= 1 << b;
  }
  const unsigned linked = __ballot_sync(FULL, lk);
  const unsigned blkd = __ballot_sync(FULL, bk);
  // merged flag byte: own cell's flags | flags of each newly linked neighbour
  const int nf = own | (int)__reduce_or_sync(FULL, (unsigned)nflags);
  // union-find: the new id is the smallest of the peg's own id and its
  // linked neighbours' ids
  const int nid = min(eff, __reduce_min_sync(FULL, ncid));
  const bool any_cid = __any_sync(FULL, ncid != BIG);
  int cids[8];
#pragma unroll
  for (int d = 0; d < 8; ++d) cids[d] = __shfl_sync(FULL, ncid, d);
  __syncwarp();  // every read of the pre-move state is done

  // link / blocked bits land on the pair's west endpoint, in its canonical
  // direction: on the new peg for d < 4, on the neighbour for d >= 4
  if (me_row && lane < 8 && ((linked | blkd) >> lane & 1u)) {
    const int base = (linked >> lane & 1u) ? LINKS : BLOCKED;
    if (lane < 4) {
      e.w(base + lane, ex) |= meb;
    } else {
      const int dx = off[2 * lane], dy = off[2 * lane + 1];
      const int tx = ((ex + dx) % p + p) % p;  // _shiftp rolls
      e.w(base + lane - 4, tx) |= bit_at(ey + dy);
    }
  }

  // every cell of the united components takes the new id, and its row the
  // merged flags; with no linked component the hit set is the peg's cell
  const short nid16 = (short)nid;
  if (any_cid) {
    if (lane < n) {
      uint32_t hit_word = 0u;
      for (int y = 0; y < n; ++y) {
        const short v = e.c(lane, y);
        bool hit = (lane == px) && (y == py);
#pragma unroll
        for (int i = 0; i < 8; ++i) hit |= v == cids[i];
        if (hit) {
          e.c(lane, y) = nid16;
          hit_word |= 1u << (y + PAD);
        }
      }
      if (hit_word) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if ((nf >> b) & 1) e.w(FLAGS + b, lane + PAD) |= hit_word;
        }
      }
    }
  } else if (lane == px && py >= 0 && py < n && px < n) {
    e.c(px, py) = nid16;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if ((nf >> b) & 1) e.w(FLAGS + b, ex) |= meb;
    }
  }

  // legal bookkeeping: move one stays legal for one ply
  if (mc != 0 && me_row && lane == ex) {
    e.w(LEGAL, ex) &= ~meb;
    e.w(LEGAL + 1, ex) &= ~meb;
  }
  __syncwarp();

  // result (UpdateResult, twixtboard.cc:192-207); each lane reads its own row
  const int sh = player * 2;
  const bool win = sh >= 0 && sh + 1 < 32 && ((nf >> sh) & 1) && ((nf >> (sh + 1)) & 1);
  const int opp = 1 - player;
  const int opp_plane = (opp == 0) ? LEGAL : LEGAL + 1;
  const bool opp_has_legal = __any_sync(FULL, e.row(opp_plane, lane) != 0u);
  const int result =
      win ? RESULT_RED_WIN + player : (opp_has_legal ? RESULT_OPEN : RESULT_DRAW);

  s.cur = (result == RESULT_OPEN) ? opp : TERMINAL_PLAYER_ID;
  s.mc = mc + 1;
  s.move_one = (mc == 0) ? eff : move_one;
  s.swapped |= is_swap ? 1 : 0;
  s.result = result;
  return result;
}

}  // namespace twixt
