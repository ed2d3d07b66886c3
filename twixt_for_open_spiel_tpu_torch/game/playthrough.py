"""Golden-playthrough serialization
(``twixt_for_open_spiel_tpu/game/playthrough.py``).

Regenerates the OpenSpiel playthrough format byte-exactly for a given action
sequence, so the reference's
``open_spiel/integration_tests/playthroughs/playthrough.txt`` can be diffed
verbatim against this engine's output — the parity gate of the whole project
(BASELINE.json:2).  The game's tensors may live on any device; the format
is built on the host from the adapter's Python values and numpy arrays.

The reference file dumps a full state block for some states and only the
``# State k`` header for others; ``generate`` takes the set of fully dumped
state indices so the golden file's own sampling pattern can be replayed.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Set

import numpy as np

from twixt_for_open_spiel_tpu_torch.game.openspiel import TwixTGame, TwixTState

_TENSOR_ONE = "◉"  # ◉
_TENSOR_ZERO = "◯"  # ◯


def _quote(s: str) -> str:
    """C-style minimal escaping used by the playthrough format."""
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n"
    ) + '"'


def _fmt_g(v: float) -> str:
    """%g-style float used inside vectors: 1.0 -> "1", -1.0 -> "-1"."""
    return f"{v:g}"


def _vec(vals: Iterable[float]) -> str:
    return "[" + ", ".join(_fmt_g(v) for v in vals) + "]"


def _int_list(vals: Iterable[int]) -> str:
    return "[" + ", ".join(str(v) for v in vals) + "]"


def _str_list(vals: Iterable[str]) -> str:
    return "[" + ", ".join(f'"{v}"' for v in vals) + "]"


def _tensor_block(t: np.ndarray) -> List[str]:
    """12 x size x (size-2) tensor as the ◯/◉ block: one line per board row
    (dim 1), one 6-char group per plane (dim 0), two spaces between groups."""
    planes, rows, cols = t.shape
    lines = []
    for r in range(rows):
        groups = []
        for p in range(planes):
            groups.append(
                "".join(
                    _TENSOR_ONE if t[p, r, c] else _TENSOR_ZERO
                    for c in range(cols)
                )
            )
        lines.append("  ".join(groups))
    return lines


def header_lines(game: TwixTGame) -> List[str]:
    """The game-facts preamble (golden playthrough lines 1-31)."""
    params = game.get_parameters()
    params_str = ",".join(
        f"{k}={params[k]}" for k in sorted(params)
    )
    n = game.num_distinct_actions()
    return [
        "game: twixt",
        "",
        "GameType.chance_mode = ChanceMode.DETERMINISTIC",
        "GameType.dynamics = Dynamics.SEQUENTIAL",
        "GameType.information = Information.PERFECT_INFORMATION",
        'GameType.long_name = "TwixT"',
        "GameType.max_num_players = 2",
        "GameType.min_num_players = 2",
        'GameType.parameter_specification = ["ansi_color_output", '
        '"board_size"]',
        "GameType.provides_information_state_string = True",
        "GameType.provides_information_state_tensor = False",
        "GameType.provides_observation_string = True",
        "GameType.provides_observation_tensor = True",
        "GameType.provides_factored_observation_string = False",
        "GameType.reward_model = RewardModel.TERMINAL",
        'GameType.short_name = "twixt"',
        "GameType.utility = Utility.ZERO_SUM",
        "",
        f"NumDistinctActions() = {n}",
        f"PolicyTensorShape() = [{n}]",
        f"MaxChanceOutcomes() = {game.max_chance_outcomes()}",
        f"GetParameters() = {{{params_str}}}",
        f"NumPlayers() = {game.num_players()}",
        f"MinUtility() = {game.min_utility()}",
        f"MaxUtility() = {game.max_utility()}",
        f"UtilitySum() = {game.utility_sum()}",
        "ObservationTensorShape() = "
        + str(game.observation_tensor_shape()),
        "ObservationTensorLayout() = TensorLayout.CHW",
        f"ObservationTensorSize() = {game.observation_tensor_size()}",
        f"MaxGameLength() = {game.max_game_length()}",
        f"ToString() = {_quote(str(game))}",
    ]


def state_lines(state: TwixTState) -> List[str]:
    """Full state dump block (without the '# State k' header line)."""
    lines = []
    board = state.to_string()
    for line in board.splitlines():
        lines.append(("# " + line).rstrip())
    lines.append(f"IsTerminal() = {state.is_terminal()}")
    lines.append(f"History() = {_int_list(state.history)}")
    lines.append(f"HistoryString() = {_quote(state.history_str())}")
    lines.append("IsChanceNode() = False")
    lines.append("IsSimultaneousNode() = False")
    lines.append(f"CurrentPlayer() = {state.current_player()}")
    for p in range(2):
        lines.append(
            f"InformationStateString({p}) = "
            f"{_quote(state.information_state_string(p))}"
        )
    for p in range(2):
        lines.append(
            f"ObservationString({p}) = "
            f"{_quote(state.observation_string(p))}"
        )
    for p in range(2):
        lines.append(f"ObservationTensor({p}):")
        lines.extend(_tensor_block(state.observation_tensor(p)))
    lines.append(f"Rewards() = {_vec(state.rewards())}")
    lines.append(f"Returns() = {_vec(state.returns())}")
    if not state.is_terminal():
        lines.append(f"LegalActions() = {_int_list(state.legal_actions())}")
        lines.append(
            f"StringLegalActions() = {_str_list(state.string_legal_actions())}"
        )
    return lines


def generate(
    game: TwixTGame,
    actions: Sequence[int],
    full_dump_states: Optional[Set[int]] = None,
) -> str:
    """Regenerate a playthrough file for ``actions``.

    ``full_dump_states``: indices of states serialized in full (default all).
    The terminal/last state is always fully dumped, matching the reference
    generator's behavior.
    """
    state = game.new_initial_state()
    out = header_lines(game)
    out.append("")
    n_states = len(actions) + 1
    for k in range(n_states):
        out.append(f"# State {k}")
        dump = full_dump_states is None or k in full_dump_states
        if k == n_states - 1:
            dump = True
        if dump:
            out.extend(state_lines(state))
            if k < n_states - 1:
                out.append("")
        if k < n_states - 1:
            a = actions[k]
            s = state.action_to_string(state.current_player(), a)
            out.append(f'# Apply action "{s}"')
            out.append(f"action: {a}")
            out.append("")
            state.apply_action(a)
    return "\n".join(out) + "\n"
