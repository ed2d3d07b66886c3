"""Observation tensors and the packed observation wire
(``twixt_for_open_spiel_tpu/ops/observe.py``).

The 12 observation planes (reference twixt.cc:76-132) as the float tensor
``[12, size, size-2, *B]`` from the canonical state (``observation``) or
straight from the bitplanes (``bit_observation``), and as the learner's
wire: packed column words with the mover's legal plane riding in the
words' free low bits, and the decoders a learner applies.  Words are int32
here and bit-equal to the JAX u32 words (no word ever has bit 31 set).

Plane semantics: plane 0 / 6 = peg of that colour with no links, planes
1+d / 7+d = canonical east link in direction d, plane 5 / 11 = blocked east
neighbours.  The coordinate remaps (reference twixtboard.cc:590-597) are
applied at decode time.
"""

from __future__ import annotations

import torch

from twixt_for_open_spiel_tpu_torch.ops import geometry as geo
from twixt_for_open_spiel_tpu_torch.ops.bitboard import (
    _mover_legal,
    _unpack_bool,
    expand_planes,
)
from twixt_for_open_spiel_tpu_torch.ops.state import padded_size

_I32 = torch.int32


def _red_view(arr: torch.Tensor, size: int) -> torch.Tensor:
    """[P, P, *B] board -> [size, size-2, *B]: out[r, c] = core[c+1, size-1-r]."""
    core = arr[geo.PAD : geo.PAD + size, geo.PAD : geo.PAD + size]
    return core.transpose(0, 1).flip(0)[:, 1 : size - 1]


def _blue_view(arr: torch.Tensor, size: int) -> torch.Tensor:
    """[P, P, *B] board -> [size, size-2, *B]: out[r, c] = core[size-1-r, size-2-c]."""
    core = arr[geo.PAD : geo.PAD + size, geo.PAD : geo.PAD + size]
    return core.flip(0, 1)[:, 1 : size - 1]


def observation(state, board_size: int) -> torch.Tensor:
    """float32 [12, size, size-2, *B] observation of the canonical state;
    the same for both observing players (reference twixt.cc:101-132)."""
    planes = []
    for color_val, view in ((geo.COLOR_RED, _red_view), (geo.COLOR_BLUE, _blue_view)):
        is_color = view(state.color == color_val, board_size)
        links = view(state.links, board_size)
        blocked = view(state.blocked, board_size)
        planes.append(is_color & (links == 0))  # plane 0 / 6
        for d in range(4):  # planes 1-4 / 7-10: NNE, ENE, ESE, SSE
            planes.append(is_color & (((links >> d) & 1) != 0))
        planes.append(is_color & ((blocked & 15) != 0))  # plane 5 / 11
    return torch.stack(planes).to(torch.float32)


def observation_nchw(state, board_size: int) -> torch.Tensor:
    """Batched observation in the network's layout: [B, 12, size, size-2]."""
    return observation(state, board_size).movedim(-1, 0)


def bit_observation(bs, board_size: int, dtype=torch.float32) -> torch.Tensor:
    """The observation straight from the bitplanes, [12, size, size-2, *B]
    in ``dtype`` (binary planes, so bfloat16 is exact): the canonical east
    link planes, "no links" from the 8 expanded directions, and "blocked
    east" as the OR of the canonical blocked planes."""
    p = padded_size(board_size)
    any_link = bs.links[0]
    for plane in expand_planes(bs.links)[1:]:
        any_link = any_link | plane
    blocked_e = bs.blocked[0] | bs.blocked[1] | bs.blocked[2] | bs.blocked[3]
    has_links = _unpack_bool(any_link, p)
    blocked = _unpack_bool(blocked_e, p)
    east = [_unpack_bool(plane, p) for plane in bs.links]
    planes = []
    for color_plane, view in ((bs.red, _red_view), (bs.blue, _blue_view)):
        c = view(_unpack_bool(color_plane, p), board_size)
        planes.append(c & ~view(has_links, board_size))  # plane 0 / 6
        for d in range(4):  # planes 1-4 / 7-10
            planes.append(c & view(east[d], board_size))
        planes.append(c & view(blocked, board_size))  # plane 5 / 11
    return torch.stack(planes).to(dtype)


def bit_observation_packed_lanes(bs, board_size: int) -> torch.Tensor:
    """Observation as packed column words in the engine's lane-major
    layout: int32 [12, P, B]."""
    any_link = bs.links[0]
    for plane in expand_planes(bs.links)[1:]:
        any_link = any_link | plane
    blocked_e = bs.blocked[0] | bs.blocked[1] | bs.blocked[2] | bs.blocked[3]
    packed = []
    for is_color in (bs.red, bs.blue):
        packed.append(is_color & ~any_link)  # plane 0 / 6
        for d in range(4):  # planes 1-4 / 7-10
            packed.append(is_color & bs.links[d])
        packed.append(is_color & blocked_e)  # plane 5 / 11
    return torch.stack(packed)


# Every packed word's live bits sit at y in [PAD, PAD+n), leaving the low
# PAD=3 bits free: the mover's legal word for a column is split into 3-bit
# chunks carried by planes 0..7 of the same column (8 x 3 = 24 bits >= n).
_LEGAL_CHUNK_BITS = 3
_LEGAL_CHUNK_PLANES = 8
assert _LEGAL_CHUNK_BITS == geo.PAD
assert _LEGAL_CHUNK_BITS * _LEGAL_CHUNK_PLANES >= geo.MAX_BOARD_SIZE


def pack_legal_into_lanes(stack: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """OR the legal plane's 3-bit chunks into the low bits of obs planes
    0..7 (``stack`` [12, P, B], ``legal`` [P, B]), clearing those bits
    first.  Inverse: :func:`legal_words_from_obs`."""
    one_chunk = (1 << _LEGAL_CHUNK_BITS) - 1
    planes = []
    for k in range(_LEGAL_CHUNK_PLANES):
        chunk = (legal >> (geo.PAD + _LEGAL_CHUNK_BITS * k)) & one_chunk
        planes.append((stack[k] & ~one_chunk) | chunk)
    return torch.cat([torch.stack(planes), stack[_LEGAL_CHUNK_PLANES:]], dim=0)


def legal_words_from_obs(pk: torch.Tensor) -> torch.Tensor:
    """Recover the packed legal words from wire words ([..., 12, P] with the
    legal chunks in planes 0..7's low bits) -> [..., P]."""
    one_chunk = (1 << _LEGAL_CHUNK_BITS) - 1
    legal = torch.zeros_like(pk[..., 0, :])
    for k in range(_LEGAL_CHUNK_PLANES):
        legal = legal | (
            (pk[..., k, :] & one_chunk) << (geo.PAD + _LEGAL_CHUNK_BITS * k)
        )
    return legal


def bit_observation_packed_with_legal(bs, board_size: int) -> torch.Tensor:
    """The full self-play wire as one array: int32 [B, 12*P], the 12 packed
    planes with the mover's legal plane in their free low bits."""
    full = pack_legal_into_lanes(
        bit_observation_packed_lanes(bs, board_size), _mover_legal(bs)
    )
    return full.permute(2, 0, 1).reshape(full.shape[-1], -1)


def unpack_observation_nchw(pk: torch.Tensor, board_size: int,
                            dtype=torch.float32) -> torch.Tensor:
    """Decode packed words ([..., 12, P]) to the network layout
    [..., 12, size, size-2].  Red block: out[r, c] = bit(word[pad+c+1],
    pad+n-1-r); blue block: out[r, c] = bit(word[pad+n-1-r], pad+n-2-c)."""
    n = board_size
    pad = geo.PAD
    lead = pk.shape[:-2]
    pk = pk.reshape((-1,) + pk.shape[-2:])
    dev = pk.device
    red_pk, blue_pk = pk[:, :6, :], pk[:, 6:, :]
    words_r = red_pk[:, :, pad + 1 : pad + n - 1]  # [B, 6, n-2]
    shifts_r = (pad + n - 1 - torch.arange(n, dtype=_I32, device=dev)).reshape(
        1, 1, n, 1
    )
    red_obs = (words_r.unsqueeze(2) >> shifts_r) & 1  # [B, 6, n, n-2]
    words_b = blue_pk[:, :, pad : pad + n].flip(-1)  # [B, 6, n]
    shifts_b = (
        pad + n - 2 - torch.arange(n - 2, dtype=_I32, device=dev)
    ).reshape(1, 1, 1, n - 2)
    blue_obs = (words_b.unsqueeze(3) >> shifts_b) & 1  # [B, 6, n, n-2]
    out = torch.cat([red_obs, blue_obs], dim=1).to(dtype)
    return out.reshape(lead + out.shape[1:])


def unpack_legal_words_flat(words: torch.Tensor, board_size: int) -> torch.Tensor:
    """Decode packed legal words ([..., P]) to the flat legal mask over the
    action space: bool [..., n*n], ascending action order."""
    n = board_size
    pad = geo.PAD
    core = words[..., pad : pad + n]  # [..., n]
    ys = torch.arange(pad, pad + n, dtype=_I32, device=words.device)
    bits = ((core.unsqueeze(-1) >> ys) & 1) != 0  # [..., n, n]
    return bits.reshape(bits.shape[:-2] + (n * n,))


def bit_observation_nchw(bs, board_size: int, dtype=torch.float32) -> torch.Tensor:
    """Batched bitboard observation in the network's layout
    [B, 12, size, size-2]: the packed planes, one packed transpose, then
    :func:`unpack_observation_nchw`.  Other batch shapes take the unpacked
    path, as in JAX."""
    if bs.red.ndim != 2:
        return bit_observation(bs, board_size, dtype).movedim(-1, 0)
    pk = bit_observation_packed_lanes(bs, board_size).permute(2, 0, 1)
    return unpack_observation_nchw(pk, board_size, dtype)
