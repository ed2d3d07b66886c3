"""The OpenSpiel-shaped host side of the port (``twixt_for_open_spiel_tpu/game``).

  openspiel.py    ``load_game``, ``TwixTGame``, ``TwixTState``, ``SpielError``,
                  the game-and-state text format
  playthrough.py  the golden playthrough format: ``generate``
  render.py       the byte-exact board string (the C renderer, else Python)
  strings.py      ``action_to_string``
"""

from twixt_for_open_spiel_tpu_torch.game.openspiel import (
    SpielError,
    TwixTGame,
    TwixTState,
    deserialize_game_and_state,
    load_game,
    serialize_game_and_state,
)
from twixt_for_open_spiel_tpu_torch.game.render import render
from twixt_for_open_spiel_tpu_torch.game.strings import action_to_string

__all__ = [
    "SpielError",
    "TwixTGame",
    "TwixTState",
    "load_game",
    "serialize_game_and_state",
    "deserialize_game_and_state",
    "render",
    "action_to_string",
]
