"""Training checkpoints (``twixt_for_open_spiel_tpu/utils/serialization.py``
``save_training`` / ``restore_training``).

A checkpoint is a directory in the JAX layout: ``params`` (the module's
``state_dict``), ``opt_state`` (the optimizer's ``state_dict``), each
written by ``torch.save``, and the marker ``iteration.txt``, written last.
Each file is written to a temporary name and renamed into place, so a run
cut short leaves the previous file whole.
"""

from __future__ import annotations

import os

import torch


def _replace(path: str, write) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    write(tmp)
    os.replace(tmp, path)


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
