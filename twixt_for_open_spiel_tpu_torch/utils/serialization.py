"""Checkpoint / resume (``twixt_for_open_spiel_tpu/utils/serialization.py``).

Three mechanisms, as in the JAX module:

  * **History replay** — any game state is reconstructible from its action
    sequence (the reference's ``History()`` replay, playthrough.txt:674):
    ``serialize_state`` / ``deserialize_state``, the canonical,
    version-stable restore path for game states.
  * **Tree snapshots** — a tree (tuples, named tuples, lists, dicts) of
    tensors or arrays, such as a ``BitState`` or a ``state_dict``:
    ``save_pytree`` writes its leaves as CPU tensors with ``torch.save``
    (the port's own format; JAX's module writes orbax checkpoints), and
    ``load_pytree`` gives them back as numpy arrays in the structure of a
    tree like it.
  * **Training checkpoints** — a directory in the JAX layout: ``params``
    (the module's ``state_dict``), ``opt_state`` (the optimizer's
    ``state_dict``), each written by ``torch.save``, and the marker
    ``iteration.txt``, written last.

Each file is written to a temporary name and renamed into place, so a run
cut short leaves the previous file whole.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

from twixt_for_open_spiel_tpu_torch.game.openspiel import TwixTGame, TwixTState


def _replace(path: str, write) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    write(tmp)
    os.replace(tmp, path)


# --- history replay (canonical game-state checkpointing)

def serialize_state(state: TwixTState) -> str:
    """Action history, one action per line (OpenSpiel's wire format)."""
    return "\n".join(str(a) for a in state.history)


def deserialize_state(game: TwixTGame, data: str) -> TwixTState:
    """The state reached by replaying ``data``'s actions on ``game``'s
    device."""
    state = game.new_initial_state()
    for line in filter(None, data.split("\n")):
        state.apply_action(int(line))
    return state


# --- tree snapshots

def _host_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    return torch.from_numpy(np.array(leaf))


def save_pytree(path: str, tree) -> None:
    """Write ``tree``'s leaves (tensors on any device, arrays, numbers) to
    ``path``."""
    leaves = [_host_tensor(x) for x in tree_leaves(tree)]
    _replace(path, lambda tmp: torch.save(leaves, tmp))


def load_pytree(path: str, like):
    """The tree saved at ``path``, with numpy leaves in ``like``'s
    structure; raises ValueError when the leaves' count or shapes differ
    from ``like``'s."""
    leaves = torch.load(path, map_location="cpu", weights_only=True)
    want, spec = tree_flatten(like)
    shapes = [tuple(np.shape(x)) for x in want]
    if [tuple(t.shape) for t in leaves] != shapes:
        raise ValueError(f"{path} holds {len(leaves)} leaves that do not match "
                         f"the {len(want)} leaves of shapes {shapes}")
    return tree_unflatten([t.numpy() for t in leaves], spec)


# --- training checkpoints

def save_training(ckpt_dir: str, params, opt_state, iteration: int) -> None:
    """Write the ``state_dict``s of ``params`` (the module) and
    ``opt_state`` (its optimizer), then the iteration marker, to
    ``ckpt_dir``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    for name, obj in (("params", params), ("opt_state", opt_state)):
        _replace(os.path.join(ckpt_dir, name),
                 lambda tmp, state=obj.state_dict(): torch.save(state, tmp))

    def marker(tmp):
        with open(tmp, "w") as f:
            f.write(str(iteration))

    _replace(os.path.join(ckpt_dir, "iteration.txt"), marker)


def restore_training(ckpt_dir: str, device="cuda"):
    """(params state_dict, optimizer state_dict, iteration) with the tensors
    on ``device``, or None when ``ckpt_dir`` has no iteration marker."""
    marker = os.path.join(ckpt_dir, "iteration.txt")
    if not os.path.exists(marker):
        return None
    params, opt_state = (
        torch.load(os.path.join(ckpt_dir, name), map_location=device, weights_only=True)
        for name in ("params", "opt_state"))
    with open(marker) as f:
        iteration = int(f.read().strip())
    return params, opt_state, iteration
