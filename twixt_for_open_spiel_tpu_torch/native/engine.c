/* Native host-runtime TwixT engine (C, loaded via ctypes).
 *
 * The TPU compute path of this framework is compiled XLA (ops/); this file
 * is the native *host* engine — the runtime analogue of the reference's C++
 * board engine (twixtboard.cc) for single-state, host-driven play: fast
 * interactive stepping, host-side rollouts, and deep randomized
 * cross-checking of the tensor engines.  Semantics follow the reference
 * exactly (file:line citations inline); representation does not — this is a
 * flat-array engine with a derived crossing table, not a translation of the
 * reference's struct-of-Cells + global BlockerMap design.
 *
 * Exactness is enforced by tests/test_native_engine.py: randomized full
 * games are replayed through the independent Python oracle (tests/oracle.py)
 * and the JAX engines with identical trajectories required.
 */

#include <stdint.h>
#include <string.h>

#define MAXN 24
#define NCELL (MAXN * MAXN)
#define NUM_DIRS 8

/* results (reference twixtboard.h:44-50) */
#define OPEN 0
#define RED_WIN 1
#define BLUE_WIN 2
#define DRAW 3
#define TERMINAL_PLAYER (-4) /* OpenSpiel kTerminalPlayerId */

/* the 8 knight-move directions, index == Compass value
 * (reference twixtcell.h:58-68) */
static const int OFF[NUM_DIRS][2] = {
    {1, 2},  {2, 1},  {2, -1},  {1, -2},
    {-1, -2}, {-2, -1}, {-2, 1}, {-1, 2},
};

/* Crossing table: for each direction d, the 9 links that geometrically
 * cross link ((0,0) -> OFF[d]), as (ox, oy, d2) with d2 canonicalised to
 * the four east-side directions.  DERIVED at init from segment
 * intersection — the native equivalent of ops/geometry.py CROSSERS (and of
 * the reference's hand-written kLinkDescriptorTable blocking_links,
 * twixtboard.cc:38-144). */
static int CROSS[NUM_DIRS][9][3];
static int cross_ready = 0;

static long orient(long ax, long ay, long bx, long by, long cx, long cy) {
    return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
}

static int properly_intersect(int ax, int ay, int bx, int by, int cx,
                              int cy, int dx, int dy) {
    long o1 = orient(ax, ay, bx, by, cx, cy);
    long o2 = orient(ax, ay, bx, by, dx, dy);
    long o3 = orient(cx, cy, dx, dy, ax, ay);
    long o4 = orient(cx, cy, dx, dy, bx, by);
    return (o1 * o2 < 0) && (o3 * o4 < 0);
}

static void build_cross_table(void) {
    if (cross_ready) return;
    for (int d = 0; d < NUM_DIRS; d++) {
        int k = 0;
        for (int d2 = 0; d2 < 4; d2++) { /* canonical east dirs NNE..SSE */
            for (int ox = -3; ox <= 3; ox++) {
                for (int oy = -3; oy <= 3; oy++) {
                    int ex = ox + OFF[d2][0], ey = oy + OFF[d2][1];
                    if (properly_intersect(0, 0, OFF[d][0], OFF[d][1], ox,
                                           oy, ex, ey) &&
                        k < 9) {
                        CROSS[d][k][0] = ox;
                        CROSS[d][k][1] = oy;
                        CROSS[d][k][2] = d2;
                        k++;
                    }
                }
            }
        }
        /* each link is crossed by exactly 9 others (twixtboard.cc:38-144) */
        if (k != 9) {
            cross_ready = -1;
            return;
        }
    }
    cross_ready = 1;
}

/* colors (reference twixtboard.h) */
#define C_RED 0
#define C_BLUE 1
#define C_EMPTY 2
#define C_OFFBOARD 3

typedef struct {
    int32_t n;
    int32_t current;      /* player to move, or TERMINAL_PLAYER */
    int32_t move_counter;
    int32_t move_one;     /* action of move 1, -1 before */
    int32_t swapped;
    int32_t result;
    int8_t color[NCELL];
    uint8_t links[NCELL];   /* bit d: link in direction d */
    uint8_t blocked[NCELL]; /* bit d: blocked neighbor in direction d */
    uint8_t flags[NCELL];   /* bit (p*2+b): linked to border b for player p */
    uint8_t legal[2][NCELL];
} Engine;

int twixt_engine_sizeof(void) { return (int)sizeof(Engine); }

static int off_board(int n, int x, int y) {
    if (x < 0 || x >= n || y < 0 || y >= n) return 1;
    return (x == 0 || x == n - 1) && (y == 0 || y == n - 1);
}

/* reference twixtboard.cc:209-276 (InitializeCells / InitializeLegalActions);
 * the whole construction collapses to one pass over the flat arrays. */
void twixt_engine_reset(Engine *e, int n) {
    build_cross_table();
    memset(e, 0, sizeof(Engine));
    e->n = n;
    e->current = C_RED;
    e->move_one = -1;
    e->result = OPEN;
    for (int x = 0; x < n; x++) {
        for (int y = 0; y < n; y++) {
            int a = x * n + y;
            if (off_board(n, x, y)) {
                e->color[a] = C_OFFBOARD;
                continue;
            }
            e->color[a] = C_EMPTY;
            /* initial border flags: exclusive chain, corners excluded
             * (reference twixtboard.cc:219-231) */
            if (x == 0)
                e->flags[a] = 1 << (1 * 2 + 0);
            else if (x == n - 1)
                e->flags[a] = 1 << (1 * 2 + 1);
            else if (y == 0)
                e->flags[a] = 1 << (0 * 2 + 0);
            else if (y == n - 1)
                e->flags[a] = 1 << (0 * 2 + 1);
            /* red may not play the x-border columns, blue not the y-border
             * rows (reference twixtboard.cc:252-276) */
            e->legal[0][a] = !(x == 0 || x == n - 1);
            e->legal[1][a] = !(y == 0 || y == n - 1);
        }
    }
}

/* SetPegAndLinks (reference twixtboard.cc:501-571): place peg, link to
 * same-color knight neighbors unless a crossing link blocks, then flood
 * border flags to fixpoint over the merged component. */
static void set_peg_and_links(Engine *e, int player, int px, int py) {
    int n = e->n;
    int a = px * n + py;
    e->color[a] = (int8_t)player;
    int made_link = 0;
    for (int d = 0; d < NUM_DIRS; d++) {
        int tx = px + OFF[d][0], ty = py + OFF[d][1];
        if (off_board(n, tx, ty)) continue;
        int t = tx * n + ty;
        if (e->color[t] != player) continue;
        int crossed = 0;
        for (int k = 0; k < 9; k++) {
            int qx = px + CROSS[d][k][0], qy = py + CROSS[d][k][1];
            if (qx < 0 || qx >= n || qy < 0 || qy >= n) continue;
            if (e->links[qx * n + qy] & (1u << CROSS[d][k][2])) {
                crossed = 1;
                break;
            }
        }
        int od = (d + 4) % NUM_DIRS;
        if (crossed) {
            /* blocked bits recorded on BOTH endpoints
             * (reference twixtboard.cc:536-541) */
            e->blocked[a] |= (uint8_t)(1u << d);
            e->blocked[t] |= (uint8_t)(1u << od);
        } else {
            e->links[a] |= (uint8_t)(1u << d);
            e->links[t] |= (uint8_t)(1u << od);
            made_link = 1;
        }
    }
    if (!made_link) return;
    /* flags fixpoint == whole connected component of the new peg carries the
     * union of its members' flags (the reference maintains this invariant
     * incrementally via ExploreLocalGraph, twixtboard.cc:573-588) */
    /* stack-local scratch (no statics: the reference's global BlockerMap is
     * a known shared-mutable wart this engine deliberately avoids) */
    int stack[NCELL];
    uint8_t seen[NCELL];
    int members[NCELL];
    memset(seen, 0, (size_t)(n * n));
    int top = 0;
    stack[top++] = a;
    seen[a] = 1;
    uint8_t uni = 0;
    int count = 0;
    while (top > 0) {
        int c = stack[--top];
        members[count++] = c;
        uni |= e->flags[c];
        int cx = c / n, cy = c % n;
        uint8_t lk = e->links[c];
        for (int d = 0; d < NUM_DIRS; d++) {
            if (!(lk & (1u << d))) continue;
            int q = (cx + OFF[d][0]) * n + (cy + OFF[d][1]);
            if (!seen[q]) {
                seen[q] = 1;
                stack[top++] = q;
            }
        }
    }
    for (int i = 0; i < count; i++) e->flags[members[i]] = uni;
}

/* ApplyAction incl. swap rule + UpdateResult + turn flip
 * (reference twixtboard.cc:457-499, 192-207; twixt.h:93-104).
 * Returns 0, or -1 if the action is illegal / the game is over. */
int twixt_engine_apply(Engine *e, int action) {
    int n = e->n;
    if (e->result != OPEN) return -1;
    if (action < 0 || action >= n * n) return -1;
    int player = e->current;
    if (!e->legal[player][action]) return -1;
    int px = action / n, py = action % n;

    if (e->move_counter == 1) {
        if (action == e->move_one) {
            /* swap: undo move one, place blue at the 90°-cw rotation
             * (reference twixtboard.cc:450-474) */
            e->swapped = 1;
            e->color[e->move_one] = C_EMPTY;
            int ox = px, oy = py;
            px = oy;
            py = n - 1 - ox;
        } else {
            /* move one leaves the legal lists only now
             * (reference twixtboard.cc:485-493) */
            e->legal[0][e->move_one] = 0;
            e->legal[1][e->move_one] = 0;
        }
    }

    set_peg_and_links(e, player, px, py);

    if (e->move_counter == 0) {
        e->move_one = px * n + py;
    } else {
        int a = px * n + py;
        e->legal[0][a] = 0;
        e->legal[1][a] = 0;
    }
    e->move_counter++;

    /* UpdateResult: win iff the placed peg's component touches both own
     * borders; else draw iff the opponent has no legal action
     * (reference twixtboard.cc:192-207) */
    uint8_t f = e->flags[px * n + py];
    int both = ((f >> (player * 2)) & 3) == 3;
    if (both) {
        e->result = (player == C_RED) ? RED_WIN : BLUE_WIN;
    } else {
        int opp = 1 - player;
        int any = 0;
        for (int a = 0; a < n * n; a++)
            if (e->legal[opp][a]) {
                any = 1;
                break;
            }
        if (!any) e->result = DRAW;
    }
    e->current = (e->result == OPEN) ? 1 - player : TERMINAL_PLAYER;
    return 0;
}

int twixt_engine_current(const Engine *e) { return e->current; }
int twixt_engine_result(const Engine *e) { return e->result; }
int twixt_engine_move_counter(const Engine *e) { return e->move_counter; }
int twixt_engine_swapped(const Engine *e) { return e->swapped; }
int twixt_engine_move_one(const Engine *e) { return e->move_one; }

/* Copy the player's legal mask (n*n bytes); returns the legal count, or 0
 * with an all-zero mask at terminal (reference twixt.h:86-90). */
int twixt_engine_legal_mask(const Engine *e, int player, uint8_t *out) {
    int n2 = e->n * e->n;
    if (e->result != OPEN) {
        memset(out, 0, (size_t)n2);
        return 0;
    }
    memcpy(out, e->legal[player], (size_t)n2);
    int c = 0;
    for (int a = 0; a < n2; a++) c += out[a];
    return c;
}

/* Full state readback for deep cross-checks against the tensor engines. */
void twixt_engine_snapshot(const Engine *e, int8_t *color, uint8_t *links,
                           uint8_t *blocked, uint8_t *flags) {
    size_t n2 = (size_t)(e->n * e->n);
    if (color) memcpy(color, e->color, n2);
    if (links) memcpy(links, e->links, n2);
    if (blocked) memcpy(blocked, e->blocked, n2);
    if (flags) memcpy(flags, e->flags, n2);
}

/* splitmix64 — independent of every RNG in the JAX paths on purpose. */
static uint64_t splitmix64(uint64_t *s) {
    uint64_t z = (*s += 0x9E3779B97F4A7C15ull);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
}

/* Play one full uniform-random game; records the action sequence and
 * returns the move count (the host-native RandomSimTest driver,
 * reference twixt_test.cc:28). */
int twixt_engine_random_game(int n, uint64_t seed, int32_t *actions_out,
                             int max_actions, int32_t *result_out) {
    Engine e;
    twixt_engine_reset(&e, n);
    int32_t legal[NCELL];
    int moves = 0;
    uint64_t rng = seed ? seed : 1;
    while (e.result == OPEN && moves < max_actions) {
        int cnt = 0;
        for (int a = 0; a < n * n; a++)
            if (e.legal[e.current][a]) legal[cnt++] = a;
        if (cnt == 0) break; /* unreachable: draw is set on empty-legal */
        int a = legal[splitmix64(&rng) % (uint64_t)cnt];
        twixt_engine_apply(&e, a);
        if (actions_out) actions_out[moves] = a;
        moves++;
    }
    if (result_out) *result_out = e.result;
    return moves;
}

/* Batch of host-native random games: total moves played (throughput metric
 * for the host engine benchmark) with per-result tallies in results[4]. */
long twixt_engine_random_games(int n, uint64_t seed, int num_games,
                               int32_t *results4) {
    long total = 0;
    for (int g = 0; g < num_games; g++) {
        int32_t res = 0;
        total += twixt_engine_random_game(
            n, seed + (uint64_t)g * 0x9E3779B97F4A7C15ull, 0, NCELL + 2,
            &res);
        if (results4 && res >= 0 && res < 4) results4[res]++;
    }
    return total;
}
