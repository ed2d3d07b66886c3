"""The port's OpenSpiel adapter (``twixt_for_open_spiel_tpu_torch/game``)
on the CPU: the checks of ``tests/test_game_api.py`` against the port, the
device keyword, and the port against the JAX adapter state by state on
seeded random games.  Every equality is exact: strings, ints, and the
float32 0/1 observation tensors."""

import random

import numpy as np
import pytest
import torch

from twixt_for_open_spiel_tpu.game import openspiel as jax_game
from twixt_for_open_spiel_tpu_torch.game import (
    SpielError,
    deserialize_game_and_state,
    load_game as port_load_game,
    serialize_game_and_state,
)
from twixt_for_open_spiel_tpu_torch.game import openspiel as port_game


def load_game(name, params=None):
    return port_load_game(name, params, device="cpu")


# --- tests/test_game_api.py, against the port


def test_load_defaults():
    g = load_game("twixt")
    assert g.board_size == 8
    assert g.ansi_color_output is True
    assert g.num_distinct_actions() == 64
    assert g.observation_tensor_shape() == [12, 8, 6]
    assert g.observation_tensor_size() == 576
    assert g.max_game_length() == 61
    assert g.min_utility() == -1.0
    assert g.max_utility() == 1.0
    assert g.utility_sum() == 0.0
    assert str(g) == "twixt()"


def test_load_params_ok():
    assert load_game("twixt", {"ansi_color_output": True}).ansi_color_output
    assert load_game("twixt", {"board_size": 10}).board_size == 10
    assert load_game("twixt(board_size=10)").board_size == 10
    assert load_game("twixt(board_size=5,ansi_color_output=false)").board_size == 5


@pytest.mark.parametrize("size", [30, 3])
def test_board_size_out_of_range(size):
    with pytest.raises(SpielError) as e:
        load_game("twixt", {"board_size": size})
    assert str(e.value) == f"board_size out of range [5..24]: {size}"


@pytest.mark.parametrize("key", ["bad_param", "device"])
def test_unknown_parameter(key):
    # the device is a keyword, never an OpenSpiel parameter
    with pytest.raises(SpielError) as e:
        load_game("twixt", {key: 3})
    assert str(e.value) == (
        f"Unknown parameter '{key}'. "
        "Available parameters are: ansi_color_output, board_size"
    )


def test_illegal_action_message():
    g = load_game("twixt")
    s = g.new_initial_state()
    for a in (21, 38, 15, 11):
        s.apply_action(a)
    with pytest.raises(SpielError) as e:
        s.apply_action(11)
    assert str(e.value) == "Not a legal action: 11"


def test_action_to_string():
    g = load_game("twixt")
    s = g.new_initial_state()
    assert s.action_to_string(0, 19) == "xc5"
    assert s.action_to_string(1, 43) == "of5"
    assert s.action_to_string(0, 29) == "xd3"


def test_clone_independent():
    g = load_game("twixt")
    s = g.new_initial_state()
    s.apply_action(19)
    c = s.clone()
    assert c.tensor_state is s.tensor_state  # shared until one side moves
    before = [x.clone() for x in s.tensor_state]
    c.apply_action(19)  # swap on the clone only
    assert not s.is_terminal()
    assert s.current_player() == 1
    assert c.current_player() == 0
    assert s.history == [19] and c.history == [19, 19]
    # the port's step wrote none of the shared tensors in place
    assert all(torch.equal(a, b) for a, b in zip(before, s.tensor_state))
    assert bool(c.tensor_state.swapped) and not bool(s.tensor_state.swapped)


def test_undo_action_is_noop():
    g = load_game("twixt")
    s = g.new_initial_state()
    s.apply_action(19)
    before = s.to_string()
    s.undo_action(0, 19)
    assert s.to_string() == before


def test_ansi_color_output_false_renders_plain():
    g = load_game("twixt(ansi_color_output=false)")
    s = g.new_initial_state()
    out = s.to_string()
    assert "\x1b[" not in out
    assert "[swapped]" not in out
    s.apply_action(19)
    s.apply_action(19)
    assert "[swapped]" in s.to_string()


def test_serialize_game_and_state_roundtrip():
    game = load_game("twixt(board_size=5,ansi_color_output=false)")
    state = game.new_initial_state()
    for a in [6, 6, 11, 12]:  # includes a swap
        state.apply_action(a)
    text = serialize_game_and_state(game, state)
    assert text.startswith(
        "# Automatically generated by OpenSpiel SerializeGameAndState\n"
        "[Game]\ntwixt("
    )
    game2, state2 = deserialize_game_and_state(text, device="cpu")
    assert game2.get_parameters() == game.get_parameters()
    assert state2.history == state.history
    assert state2.to_string() == state.to_string()
    assert state2.current_player() == state.current_player()
    with pytest.raises(SpielError) as e:
        deserialize_game_and_state("no sections", device="cpu")
    assert str(e.value) == "Expected a game and state section: 'no sections'"


def test_state_mask_and_bookkeeping_accessors():
    g = load_game("twixt(board_size=8)")
    s = g.new_initial_state()
    assert s.is_chance_node() is False
    assert s.num_players() == 2
    assert s.move_number() == 0
    mask = s.legal_actions_mask()
    assert len(mask) == 64 and sum(mask) == 48
    assert [a for a, m in enumerate(mask) if m] == s.legal_actions()
    s.apply_action(19)
    assert s.move_number() == 1
    assert s.legal_actions_mask()[19] == 1
    assert s.current_player() == 1
    assert s.legal_actions(0) == []
    assert sum(s.legal_actions_mask(0)) == 0
    assert s.legal_actions(1) == s.legal_actions()
    for p in (2, -2):
        with pytest.raises(SpielError) as e:
            s.legal_actions(p)
        assert str(e.value) == f"player >= 0 && player < num_players: {p}"
    assert s.legal_actions_for_player(1) == s.legal_actions()
    assert 19 in s.legal_actions_for_player(0)
    assert len(s.legal_actions_for_player(0)) == 48


@pytest.mark.parametrize("name,message", [
    ("chess", "Unknown game 'chess'"),
    ("twixt(board_size=8", "Badly formatted game string: twixt(board_size=8"),
])
def test_load_game_errors(name, message):
    with pytest.raises(SpielError) as e:
        load_game(name)
    assert str(e.value) == message


# --- the device keyword


def test_device_is_a_keyword_outside_the_parameters():
    g = port_load_game("twixt(board_size=10)", {"ansi_color_output": False}, device="cpu")
    j = jax_game.load_game("twixt(board_size=10)", {"ansi_color_output": False})
    assert str(g) == str(j) == "twixt(ansi_color_output=false,board_size=10)"
    assert g.get_parameters() == j.get_parameters()
    assert g.device == torch.device("cpu")
    s = g.new_initial_state()
    s.apply_action(23)
    assert all(t.device.type == "cpu" for t in s.tensor_state)


def test_device_defaults_to_the_card():
    assert port_load_game("twixt").device == torch.device("cuda")
    assert port_game.TwixTGame().device == torch.device("cuda")
    if not torch.cuda.is_available():
        # no fallback: a state of the default game needs the card
        with pytest.raises((AssertionError, RuntimeError)):
            port_load_game("twixt").new_initial_state()


# --- the port against the JAX adapter, state by state


def _state_facts(state):
    facts = {
        "obs": np.stack([state.observation_tensor(p) for p in (0, 1)]),
        "legal": state.legal_actions(),
        "player": state.current_player(),
        "returns": state.returns(),
        "history": state.history_str(),
        "serialize": state.serialize(),
        "terminal": state.is_terminal(),
    }
    return facts


@pytest.mark.parametrize("n,seed", [(5, 0), (8, 1), (12, 2)])
def test_random_game_matches_jax(n, seed):
    rng = random.Random(seed)
    names = (f"twixt(board_size={n})", f"twixt(board_size={n},ansi_color_output=false)")
    ports = [load_game(name).new_initial_state() for name in names]
    jaxs = [jax_game.load_game(name).new_initial_state() for name in names]
    steps = 0
    while True:
        for p, j in zip(ports, jaxs):
            assert p.to_string() == j.to_string()
        got, want = _state_facts(ports[0]), _state_facts(jaxs[0])
        assert got["obs"].dtype == want["obs"].dtype == np.float32
        assert np.array_equal(got.pop("obs"), want.pop("obs"))
        assert got == want
        if got["terminal"]:
            for s in (ports[0], jaxs[0]):  # no player to observe for
                with pytest.raises(Exception, match="player >= 0 && player < num_players: -4"):
                    s.observation_tensor()
            break
        action = rng.choice(got["legal"])
        if steps == 1 and rng.random() < 0.5 and ports[0].history[0] in got["legal"]:
            action = ports[0].history[0]  # the swap
        for s in (*ports, *jaxs):
            s.apply_action(action)
        steps += 1
    assert steps > 4


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_carried_across(direction):
    rng = random.Random(7)
    name = "twixt(board_size=7,ansi_color_output=false)"
    src_mod, dst_mod = (jax_game, port_game) if direction == "jax_to_port" else (port_game, jax_game)
    kw = {"device": "cpu"}
    src_game = src_mod.load_game(name, **(kw if src_mod is port_game else {}))
    state = src_game.new_initial_state()
    for _ in range(12):
        state.apply_action(rng.choice(state.legal_actions()))
    text = src_mod.serialize_game_and_state(src_game, state)
    game2, state2 = dst_mod.deserialize_game_and_state(
        text, **(kw if dst_mod is port_game else {}))
    assert str(game2) == str(src_game)
    assert state2.history == state.history
    assert state2.to_string() == state.to_string()
    assert np.array_equal(state2.observation_tensor(), state.observation_tensor())
    assert dst_mod.serialize_game_and_state(game2, state2) == text
