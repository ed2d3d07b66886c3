"""Models of the bitboard rollout kernel's warp-per-env design, held against
the plain torch version and the JAX engine on the CPU.

``csrc/fused_bit_rollout.cu`` runs one warp per env with its state in shared
memory, and stages K2's packed wire in a shared-memory tile that TMA tensor
copies store.  The kernel runs only on the card (``chip_smoke.py`` holds it
to the plain version there); these tests pin, at small sizes, the pieces of
its algorithm that the plain version does another way: the lane-parallel
draw, the direction lanes' writes, the staging tile and its box walk, the
constants that size its shared memory and its TMA boxes, and the wrapper's
cached tables.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twixt_for_open_spiel_tpu.ops import bitboard as jbit
from twixt_for_open_spiel_tpu_torch.ops import _cuda
from twixt_for_open_spiel_tpu_torch.ops import bitboard as tbit
from twixt_for_open_spiel_tpu_torch.ops import fused_bit_rollout as fbr
from twixt_for_open_spiel_tpu_torch.ops import fused_tensor_rollout as ftr
from twixt_for_open_spiel_tpu_torch.ops import geometry as geo
from twixt_for_open_spiel_tpu_torch.ops import state as tstate

torch.set_num_threads(1)

SOURCE = _cuda.CSRC / "fused_bit_rollout.cu"
HEADER = _cuda.CSRC / "bit_step.cuh"  # the step and its constants, shared with S1a
WARP = 32
BIG = 1 << 20

_sample_j = jax.jit(jbit.sample_bits, static_argnums=1)


def kernel_constants() -> dict:
    """The kernel's sizing constants as its source and the step's header set
    them."""
    text = SOURCE.read_text() + HEADER.read_text()
    names = ("PAD", "NUM_PLANES", "MAX_N", "NUM_OBS_PLANES", "BOXES", "MAX_BOX_DIM",
             "TMA_ENV_MULTIPLE", "SLOTS", "SMEM_ALIGN", "MAX_ENVS_PER_BLOCK")
    out = {
        name: int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))
        for name in names
    }
    geo_len = re.search(r"constexpr int GEO_LEN = ([\d +*]+);", text).group(1)
    out["GEO_LEN"] = eval(geo_len)  # digits, + and * only
    out["PLANES_PER_BOX"] = out["NUM_OBS_PLANES"] // out["BOXES"]
    return out


K = kernel_constants()


def round_up(v, a):
    return (v + a - 1) // a * a


def env_bytes(n):
    return round_up(K["NUM_PLANES"] * (n + 2 * K["PAD"]) * 4 + n * n * 2, 16)


def box_bytes(n, envs):
    return round_up(K["PLANES_PER_BOX"] * (n + 2 * K["PAD"]) * envs * 4, K["SMEM_ALIGN"])


def shared_bytes(n, envs, obs):
    """The kernel's shared_bytes(): alignment slack, the obs ring, the
    geometry table, the initial state and W envs."""
    ring = K["SLOTS"] * K["BOXES"] * box_bytes(n, envs) if obs else 0
    return K["SMEM_ALIGN"] + ring + round_up(K["GEO_LEN"] * 4, 16) + (envs + 1) * env_bytes(n)


# --- (a) the lane-parallel draw ---------------------------------------------


def warp_sample_bits(bs, n, noise):
    """The kernel's draw, over a batch: lane x popcounts row x of the
    mover's legal plane (0 past P), an inclusive __shfl_up_sync scan
    (offsets 1 .. 16) gives the running counts and lane 31 the total, every
    lane computes the same float32 k, __ballot_sync of cum_prev <= k < cum
    names the row, and its word and rank go to select_kth_bit.  Returns the
    actions int32 [B] and the ballots bool [32, B]."""
    legal = tbit._mover_legal(bs)
    p, b = legal.shape
    rows = torch.zeros((WARP, b), dtype=torch.int32)
    rows[:p] = legal
    cnt = tbit._popcount(rows)
    cum = cnt.clone()
    lanes = torch.arange(WARP)
    for o in (1, 2, 4, 8, 16):
        up = cum[(lanes - o).clamp(min=0)]
        cum = torch.where((lanes >= o)[:, None], cum + up, cum)
    total = cum[WARP - 1]
    bits = tbit._hash_u32(noise)
    u = (bits >> 8).to(torch.int32).to(torch.float32) * (1.0 / 16777216.0)
    k = (u * total.to(torch.float32)).to(torch.int32)
    k = torch.clamp_min(torch.minimum(k, total - 1), 0)
    prev = cum - cnt
    ballot = (prev <= k) & (k < cum)
    hit = ballot.any(dim=0)
    src = ballot.to(torch.int32).argmax(dim=0)  # __ffs: the lowest set lane
    word = torch.where(hit, rows.gather(0, src[None])[0], 0)
    kin = torch.where(hit, k - prev.gather(0, src[None])[0], 0)
    col = torch.where(hit, src.to(torch.int32), BIG)
    y = tbit._select_kth_bit(word, kin)
    return (col - geo.PAD) * n + (y - geo.PAD), ballot


def drawn_states(n, batch, steps, seed):
    """(state, noise) before each draw of the plain rollout."""
    bs = tbit.bit_reset(n, batch, "cpu")
    init = tbit.bit_reset(n, 1, "cpu")
    env = torch.arange(batch, dtype=torch.int64)
    for k in range(steps):
        noise = tbit.rollout_noise(seed, k, env)
        yield bs, noise
        bs = tbit._reset_done(tbit.step_bits(bs, n, tbit.sample_bits(bs, n, noise)), init)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n,steps", [(5, 40), (8, 30), (12, 20), (24, 12)])
def test_warp_draw_matches_sample_bits_and_jax(n, steps, seed):
    for bs, noise in drawn_states(n, 16, steps, seed):
        got, ballot = warp_sample_bits(bs, n, noise)
        assert (ballot.sum(dim=0) == 1).all()  # one row a draw: every state has a legal cell
        assert torch.equal(got, tbit.sample_bits(bs, n, noise))
    # the same fields and tuple structure in both engines
    leaves = tbit.bitstate_from_leaves(jnp.asarray(a) for a in tbit.bitstate_to_numpy(bs))
    jbs = jbit.BitState(**leaves._asdict())
    want = _sample_j(jbs, n, jnp.asarray(noise.numpy().astype(np.uint32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [5, 8, 12, 24])
def test_warp_draw_takes_the_last_legal_bit_when_k_is_the_last(n, monkeypatch):
    states = [bs for bs, _ in drawn_states(n, 16, 6, 3)]
    # every hash bit set: u = 1 - 2^-24, k = total - 1, the highest legal action
    monkeypatch.setattr(tbit, "_hash_u32", lambda x: x * 0 + 0xFFFFFFFF)
    for bs in states:
        noise = torch.zeros(16, dtype=torch.int64)
        got, _ = warp_sample_bits(bs, n, noise)
        assert torch.equal(got, tbit.sample_bits(bs, n, noise))
        legal = tbit.bit_legal_mask_flat(bs, bs.current_player.clamp(0, 1), n)
        last = n * n - 1 - legal.flip(0).to(torch.int32).argmax(dim=0)
        assert torch.equal(got, last.to(torch.int32))


@pytest.mark.parametrize("n", [5, 8, 12, 24])
def test_warp_draw_of_a_single_legal_cell_and_of_none(n):
    p = n + 2 * geo.PAD
    bs = tbit.bit_reset(n, 6, "cpu")
    rng = np.random.default_rng(n)
    cells = rng.integers(0, n * n, 6)
    one = torch.zeros((p, 6), dtype=torch.int32)
    for e, a in enumerate(cells):
        one[a // n + geo.PAD, e] = 1 << (a % n + geo.PAD)
    none = torch.zeros_like(one)
    noise = torch.from_numpy(rng.integers(0, 2**32, 6, dtype=np.uint64).astype(np.int64))
    for legal in ((one, one), (none, none)):
        s = bs._replace(legal=legal)
        got, ballot = warp_sample_bits(s, n, noise)
        assert torch.equal(got, tbit.sample_bits(s, n, noise))
        if legal[0] is one:
            assert got.tolist() == cells.tolist()
        else:  # no legal cell: the empty selection, row BIG and bit 31
            assert not ballot.any()
            assert (got == (BIG - geo.PAD) * n + 31 - geo.PAD).all()


# --- (b) the direction lanes' writes ------------------------------------------


def direction_words(p, ex):
    """(canonical direction, row) of the word lane d writes for a link or a
    blocked pair: the peg's row for d < 4, the rolled neighbour row for
    d >= 4 (links and blocked planes share the index)."""
    out = []
    for d in range(geo.NUM_DIRS):
        dx = int(geo.OFFSETS[d][0])
        out.append((d, ex) if d < 4 else (d - 4, (ex + dx) % p))
    return out


def test_every_knight_offset_moves_along_x():
    assert all(int(dx) != 0 and abs(int(dx)) <= 2 for dx, _ in geo.OFFSETS)


@pytest.mark.parametrize("n", range(geo.MIN_BOARD_SIZE, geo.MAX_BOARD_SIZE + 1))
def test_direction_lanes_write_distinct_words(n):
    p = n + 2 * geo.PAD
    assert p <= WARP  # one lane per padded row
    for ex in range(p):
        words = direction_words(p, ex)
        assert len(set(words)) == geo.NUM_DIRS
        assert all(row != ex for _, row in words[4:])  # a west endpoint is never the peg's row
    # the words the plain step changes in the link and blocked planes are
    # among the direction lanes' words for the peg's row
    for before, noise in drawn_states(n, 8, 12, n):
        action = tbit.sample_bits(before, n, noise)
        after = tbit.step_bits(before, n, action)
        eff = torch.where(
            (before.move_counter == 1) & (action == before.move_one),
            tstate.swap_rotate_action(action, n), action,
        )
        for e in range(8):
            allowed = set(direction_words(p, int(eff[e]) // n + geo.PAD))
            for planes_b, planes_a in ((before.links, after.links),
                                       (before.blocked, after.blocked)):
                for d in range(4):
                    rows = (planes_b[d][:, e] != planes_a[d][:, e]).nonzero().flatten()
                    assert {(d, int(r)) for r in rows} <= allowed


# --- (c) the staging tile and its box walk ------------------------------------


def staging_walk(n, batch, envs, steps):
    """The kernel's K2 stores, word by word, for an obs stream whose words
    are all distinct: each block's warps stage their env's 12 P rows into
    the ring's slot k % SLOTS (two boxes of PLANES_PER_BOX planes, each
    SMEM_ALIGN-aligned), then the tile goes out as BOXES tensor copies
    clipped at the batch edge (B % 4 == 0) or by plain stores of the live
    columns.  Returns (times each word is stored, the words stored, the
    stream)."""
    p = n + 2 * K["PAD"]
    rows = K["NUM_OBS_PLANES"] * p
    per_box = K["PLANES_PER_BOX"] * p
    box_words = box_bytes(n, envs) // 4
    tma = batch % K["TMA_ENV_MULTIPLE"] == 0
    if tma:
        assert envs % K["TMA_ENV_MULTIPLE"] == 0 and (envs * 4) % 16 == 0
        assert envs <= K["MAX_BOX_DIM"] and per_box <= K["MAX_BOX_DIM"]
    stream = np.arange(steps * rows * batch, dtype=np.int64).reshape(steps, 12, p, batch)
    flat = stream.reshape(steps * rows, batch)
    stored = np.zeros_like(flat)
    out = np.full_like(flat, -1)
    x, j = np.meshgrid(np.arange(p), np.arange(K["NUM_OBS_PLANES"]), indexing="ij")
    for env0 in range(0, batch, envs):
        live = min(envs, batch - env0)
        ring = np.full((K["SLOTS"], K["BOXES"], box_words), -7, np.int64)
        pending = []  # steps whose copies may still read their slot
        for k in range(steps):
            slot = k % K["SLOTS"]
            assert all(u % K["SLOTS"] != slot for u in pending)
            for w in range(live):  # lane x writes row x of each plane
                where = ((j % K["PLANES_PER_BOX"]) * p + x) * envs + w
                ring[slot, j // K["PLANES_PER_BOX"], where] = stream[k, j, x, env0 + w]
            # thread 0 before the barrier: wait_read<SLOTS - 2>
            pending = pending[len(pending) - (K["SLOTS"] - 2):] if K["SLOTS"] > 2 else []
            row0 = k * rows
            if tma:
                for h in range(K["BOXES"]):
                    tile = ring[slot, h, : per_box * envs].reshape(per_box, envs)
                    r0 = row0 + h * per_box
                    cols = min(envs, batch - env0)  # the TMA clips the box
                    stored[r0 : r0 + per_box, env0 : env0 + cols] += 1
                    out[r0 : r0 + per_box, env0 : env0 + cols] = tile[:, :cols]
                pending.append(k)
            else:
                i = np.arange(rows * live)
                r, w = i // live, i % live
                h, rr = r // per_box, r % per_box
                np.add.at(stored, (row0 + r, env0 + w), 1)
                out[row0 + r, env0 + w] = ring[slot, h, rr * envs + w]
    return stored, out, flat


@pytest.mark.parametrize(
    "n,batch,envs",
    [
        (5, 1, 1),      # a single env: plain stores
        (5, 8, 4),      # two whole blocks, by TMA
        (8, 68, 16),    # by TMA, a last block of 4 envs
        (8, 103, 5),    # B % 4 != 0 and no multiple of W: plain stores
        (12, 30, 7),    # plain stores, a last block of 2 envs
        (24, 40, 12),   # full width by TMA, a last block of 4 envs
        (24, 36, 16),   # full width by TMA, W = 16
        (24, 9, 16),    # fewer envs than W, plain stores
    ],
)
def test_staging_walk_stores_every_word_once_with_its_value(n, batch, envs):
    stored, out, want = staging_walk(n, batch, envs, steps=3)
    assert (stored == 1).all()
    np.testing.assert_array_equal(out, want)


def test_staging_lanes_write_what_the_plain_wire_holds():
    # lane x's 12 words of the tile are the plain version's wire at row x
    n, b = 8, 12
    _, _, obs = fbr.fused_bit_rollout_reference(2, n, 20, tbit.bit_reset(n, b, "cpu"),
                                                emit_obs=True)
    p = n + 2 * geo.PAD
    for k in (0, 19):
        bs, _ = fbr.fused_bit_rollout_reference(2, n, k, tbit.bit_reset(n, b, "cpu"))
        links = torch.stack(bs.links)  # [4, P, B]
        any_link = links[0] | links[1] | links[2] | links[3]
        for d in range(4, 8):  # the west expansion: a shuffle from lane (x + dx) mod P
            dx, dy = (int(v) for v in geo.OFFSETS[d])
            src = links[d - 4][(torch.arange(p) + dx) % p]
            any_link |= (src >> dy) if dy > 0 else (src << -dy)
        leg = tbit._mover_legal(bs)
        blocked_e = bs.blocked[0] | bs.blocked[1] | bs.blocked[2] | bs.blocked[3]
        planes = [bs.red & ~any_link, *(bs.red & links[d] for d in range(4)), bs.red & blocked_e,
                  bs.blue & ~any_link, *(bs.blue & links[d] for d in range(4)),
                  bs.blue & blocked_e]
        planes = [(pl & ~7) | ((leg >> (geo.PAD + 3 * j)) & 7) if j < 8 else pl
                  for j, pl in enumerate(planes)]
        assert torch.equal(torch.stack(planes), obs[k])


# --- (d) the constants fit the card -------------------------------------------


def test_kernel_constants_fit_the_warp_and_the_tma():
    assert K["MAX_N"] + 2 * K["PAD"] <= WARP  # one lane per padded row
    assert K["BOXES"] * K["PLANES_PER_BOX"] == K["NUM_OBS_PLANES"] == 12
    assert K["MAX_BOX_DIM"] == 256  # the TMA's limit on a box dimension
    assert 2 <= K["SLOTS"] <= 4
    assert K["SMEM_ALIGN"] % 128 == 0  # a tensor copy's shared-memory source
    assert (K["TMA_ENV_MULTIPLE"] * 4) % 16 == 0  # a 16-byte inner box and row stride
    assert K["MAX_ENVS_PER_BLOCK"] % K["TMA_ENV_MULTIPLE"] == 0
    assert K["MAX_ENVS_PER_BLOCK"] * WARP <= 1024
    assert K["GEO_LEN"] == geo.OFFSETS.size + geo.CROSSERS.size


@pytest.mark.parametrize("n", range(geo.MIN_BOARD_SIZE, geo.MAX_BOARD_SIZE + 1))
def test_shared_memory_and_boxes_fit_at_every_board_size(n):
    p = n + 2 * K["PAD"]
    optin, per_sm, reserved = 227 * 1024, 228 * 1024, 1024  # H100, per block / per SM
    assert K["PLANES_PER_BOX"] * p <= K["MAX_BOX_DIM"]
    for envs in range(K["TMA_ENV_MULTIPLE"], K["MAX_ENVS_PER_BLOCK"] + 1, K["TMA_ENV_MULTIPLE"]):
        assert envs <= K["MAX_BOX_DIM"] and (envs * 4) % 16 == 0
        assert box_bytes(n, envs) % K["SMEM_ALIGN"] == 0
    assert env_bytes(n) % 16 == 0  # the reset copies 16-byte vectors
    top = K["MAX_ENVS_PER_BLOCK"]
    for obs in (False, True):
        assert shared_bytes(n, top, obs) <= optin
        # two blocks of the widest tile fit an SM
        assert 2 * (shared_bytes(n, top, obs) + reserved) <= per_sm


# --- (e) the wrappers' cached tables -------------------------------------------


@pytest.mark.parametrize("n", [5, 8, 24])
def test_bit_wrapper_tables_are_the_reset_and_built_once(n):
    dev = torch.device("cpu")
    fbr._initial_state.cache_clear()
    planes, compid, scalars = fbr._initial_state(n, dev)
    init = tbit.bitstate_leaves(tbit.bit_reset(n, 1, "cpu"))
    assert torch.equal(planes, torch.stack(init[:16])[..., 0])
    assert torch.equal(compid, init[16][..., 0]) and compid.dtype == torch.int16
    assert torch.equal(scalars, torch.stack(init[17:])[:, 0])
    assert all(t.is_contiguous() for t in (planes, compid, scalars))
    assert fbr._initial_state(n, dev) is fbr._initial_state(n, dev)
    assert fbr._initial_state.cache_info().misses == 1


@pytest.mark.parametrize("n", [5, 24])
def test_tensor_wrapper_tables_are_the_reset_and_built_once(n):
    dev = torch.device("cpu")
    ftr._initial_state.cache_clear()
    cells, scalars = ftr._initial_state(n, dev)
    init = tstate.reset(n, "cpu")
    assert torch.equal(cells, ftr._cells(init)) and torch.equal(scalars, ftr._scalars(init))
    assert ftr._initial_state(n, dev) is ftr._initial_state(n, dev)
    assert ftr._initial_state.cache_info().misses == 1


def test_geometry_table_is_built_once_per_device():
    dev = torch.device("cpu")
    _cuda.geo_table.cache_clear()
    table = _cuda.geo_table(dev)
    want = np.concatenate([geo.OFFSETS.reshape(-1), geo.CROSSERS.reshape(-1)])
    assert table.dtype == torch.int32 and table.numel() == K["GEO_LEN"]
    np.testing.assert_array_equal(table.numpy(), want)
    assert _cuda.geo_table(dev) is table and _cuda.geo_table.cache_info().misses == 1


def test_envs_per_block_needs_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        fbr.envs_per_block(8, 4096, False, "cpu")
