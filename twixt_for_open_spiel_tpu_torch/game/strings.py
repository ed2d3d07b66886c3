"""Host-side action/string codecs (``twixt_for_open_spiel_tpu/game/strings.py``,
a pinned copy).

Reference: TwixTState::ActionToString (twixt.cc:67-74),
Board::ActionToPosition / PositionToAction (twixtboard.cc:599-605).
The reference's ``StringToAction`` (twixtboard.cc:607-613) is dead code and
is deliberately not reproduced.
"""

from __future__ import annotations

from twixt_for_open_spiel_tpu_torch.ops.geometry import RED


def action_to_string(player: int, action: int, board_size: int) -> str:
    """e.g. player 0, action 19, size 8 -> "xc5"."""
    x, y = action // board_size, action % board_size
    return ("x" if player == RED else "o") + chr(ord("a") + x) + str(
        board_size - y
    )
