"""The port's golden playthrough (``game/playthrough.py``) on the CPU:
BASELINE config 1, the byte-exact ``tests/fixtures/playthrough_board8.txt``,
and the port's ``generate`` byte-equal to the JAX package's on seeded random
games at other board sizes."""

import random

import pytest

from twixt_for_open_spiel_tpu.game import load_game as jax_load_game
from twixt_for_open_spiel_tpu.game.playthrough import generate as jax_generate
from twixt_for_open_spiel_tpu.game.playthrough import header_lines as jax_header_lines
from twixt_for_open_spiel_tpu_torch.game import load_game
from twixt_for_open_spiel_tpu_torch.game.playthrough import generate, header_lines
from twixt_for_open_spiel_tpu_torch.game.render import (
    ANSI_BLUE,
    ANSI_DEFAULT,
    ANSI_RED,
    render_native,
    render_py,
)

from tests.torch_port_cases import PLAYTHROUGH_FIXTURE, playthrough_structure


@pytest.fixture(scope="module")
def golden_text():
    return PLAYTHROUGH_FIXTURE.read_text()


def test_playthrough_byte_exact(golden_text):
    actions, dumped = playthrough_structure(golden_text)
    assert len(actions) == 35
    ours = generate(load_game("twixt", device="cpu"), actions, full_dump_states=dumped)
    glines, olines = golden_text.split("\n"), ours.split("\n")
    for i, (g, o) in enumerate(zip(glines, olines)):
        assert g == o, f"line {i + 1}:\n golden: {g!r}\n   ours: {o!r}"
    assert len(glines) == len(olines)
    assert ours == golden_text


def test_non_ansi_render_is_stripped_golden(golden_text):
    def strip(s):
        for code in (ANSI_RED, ANSI_BLUE, ANSI_DEFAULT):
            s = s.replace(code, "")
        return s

    actions, _ = playthrough_structure(golden_text)
    s = load_game("twixt", device="cpu").new_initial_state()
    sp = load_game("twixt(ansi_color_output=false)", device="cpu").new_initial_state()
    for a in [None] + actions:
        if a is not None:
            s.apply_action(a)
            sp.apply_action(a)
        expected = strip(s.to_string())
        assert sp.to_string() == expected
        t = sp.tensor_state
        args = (t.color, t.links, 8, bool(t.swapped), int(t.result), False)
        assert render_py(*args) == expected
        assert render_native(*args) == expected  # the C build is required


def test_final_state_is_red_win(golden_text):
    actions, _ = playthrough_structure(golden_text)
    s = load_game("twixt", device="cpu").new_initial_state()
    for a in actions:
        s.apply_action(a)
    assert s.is_terminal()
    assert s.returns() == [1.0, -1.0]
    assert s.current_player() == -4


@pytest.mark.parametrize("name", ["twixt", "twixt(board_size=12,ansi_color_output=false)",
                                  "twixt(board_size=24)"])
def test_header_matches_jax(name):
    assert header_lines(load_game(name, device="cpu")) == jax_header_lines(jax_load_game(name))


@pytest.mark.parametrize("n,seed", [(5, 3), (12, 4)])
def test_generate_matches_jax(n, seed):
    rng = random.Random(seed)
    name = f"twixt(board_size={n})"
    s = load_game(name, device="cpu").new_initial_state()
    actions = []
    while not s.is_terminal() and len(actions) < 40:
        actions.append(rng.choice(s.legal_actions()))
        s.apply_action(actions[-1])
    dumped = {k for k in range(len(actions) + 1) if rng.random() < 0.4}
    ours = generate(load_game(name, device="cpu"), actions, full_dump_states=dumped)
    assert ours == jax_generate(jax_load_game(name), actions, full_dump_states=dumped)
    assert ours.count("ObservationTensor(0):") == len(dumped | {len(actions)})
