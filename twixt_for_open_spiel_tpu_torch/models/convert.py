"""Carry flax parameters of the JAX ``AZNet`` into the port's net, and back.

The JAX net's variables are a nested dict ``{"params": {"Conv_0":
{"kernel", "bias"}, "LayerNorm_0": {"scale", "bias"}, "ResBlock_0": {...},
...}}`` with flax's layouts: convolution kernels HWIO, Dense kernels
``[in, out]``.  The port's ``AZNet`` (``models/network.py``) stores OIHW
convolutions and ``[out, in]`` Dense weights under its own names.  The
tables below name each flax module's torch counterpart; the converters
check the leaf set both ways and fail on any leaf missing or extra.

Only numpy crosses the boundary (a JAX array converts with ``np.asarray``),
so this module imports neither jax nor flax.

The optimizer state crosses too: optax's Adam moments (``count``, ``mu``,
``nu`` of ``ScaleByAdamState``) map to torch AdamW's ``step``, ``exp_avg``
and ``exp_avg_sq``, so a JAX training state continues in the port.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_LEAVES = {  # kind -> ((flax leaf, torch leaf), ...)
    "conv": (("kernel", "weight"), ("bias", "bias")),
    "dense": (("kernel", "weight"), ("bias", "bias")),
    "norm": (("scale", "weight"), ("bias", "bias")),
}


def flax_layout(blocks: int) -> list:
    """``(flax module path, torch module name, kind)`` for every module of
    an ``AZNet`` with ``blocks`` residual blocks, in flax's creation order
    (flax numbers each module type in the order ``__call__`` creates it)."""
    layout = [(("Conv_0",), "stem", "conv"), (("LayerNorm_0",), "stem_norm", "norm")]
    for i in range(blocks):
        for j in range(2):
            layout += [
                ((f"ResBlock_{i}", f"Conv_{j}"), f"blocks.{i}.conv{j}", "conv"),
                ((f"ResBlock_{i}", f"LayerNorm_{j}"), f"blocks.{i}.norm{j}", "norm"),
            ]
    layout += [
        (("Conv_1",), "policy_conv", "conv"),
        (("LayerNorm_1",), "policy_norm", "norm"),
        (("Dense_0",), "policy_out", "dense"),
        (("Conv_2",), "value_conv", "conv"),
        (("LayerNorm_2",), "value_norm", "norm"),
        (("Dense_1",), "value_hidden", "dense"),
        (("LayerNorm_3",), "value_hidden_norm", "norm"),
        (("Dense_2",), "value_out", "dense"),
    ]
    return layout


def _flatten(tree, prefix=()) -> dict:
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(_flatten(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = np.asarray(value)
    return out


def _blocks_of(names) -> int:
    return len({n[1] for n in names if len(n) > 2 and n[1].startswith("ResBlock_")})


def _to_torch(kind: str, leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf != "kernel":
        return a
    if kind == "conv":  # HWIO -> OIHW
        return a.transpose(3, 2, 0, 1)
    return a.T  # Dense [in, out] -> [out, in]


def _to_flax(kind: str, leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf != "kernel":
        return a
    if kind == "conv":  # OIHW -> HWIO
        return a.transpose(2, 3, 1, 0)
    return a.T


def _check_names(got, want, what: str) -> None:
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"{what}: missing {missing}, extra {extra}")


def params_from_flax(tree) -> dict:
    """The flax variables ``{"params": {...}}`` (leaves numpy-convertible)
    as a ``state_dict`` of float32 CPU tensors for the port's ``AZNet``."""
    flat = _flatten(tree)
    layout = flax_layout(_blocks_of(flat))
    want = {("params",) + path + (leaf,): (name, kind, tleaf)
            for path, name, kind in layout for leaf, tleaf in _LEAVES[kind]}
    _check_names(flat, want, "flax parameter tree")
    state = {}
    for key, (name, kind, tleaf) in want.items():
        a = _to_torch(kind, key[-1], flat[key]).astype(np.float32)
        state[f"{name}.{tleaf}"] = torch.from_numpy(np.ascontiguousarray(a))
    return state


def params_to_flax(state: dict) -> dict:
    """The inverse of :func:`params_from_flax`: a ``state_dict`` of the
    port's ``AZNet`` as flax variables of numpy float32 arrays."""
    blocks = len({k.split(".")[1] for k in state if k.startswith("blocks.")})
    layout = flax_layout(blocks)
    want = {f"{name}.{tleaf}": (path, kind, leaf)
            for path, name, kind in layout for leaf, tleaf in _LEAVES[kind]}
    _check_names(state, want, "torch state_dict")
    out: dict = {"params": {}}
    for key, (path, kind, leaf) in want.items():
        node = out["params"]
        for part in path:
            node = node.setdefault(part, {})
        a = state[key].detach().float().cpu().numpy()
        node[leaf] = np.ascontiguousarray(_to_flax(kind, leaf, a))
    return out


@torch.no_grad()
def load_flax_params(net, tree):
    """Copy flax variables into ``net`` in place (on its device); raises on a
    leaf missing, extra or of the wrong shape.  Returns ``net``."""
    net.load_state_dict(params_from_flax(tree), strict=True)
    return net


# --- optimizer state: optax's Adam moments <-> torch's AdamW state ---------

def _is_adam(node) -> bool:
    return {"count", "mu", "nu"} <= set(getattr(node, "_fields", ()))


def _adam_node(tree):
    """The first node of an optax state (nested tuples and namedtuples) with
    ``count``, ``mu`` and ``nu`` fields: ``ScaleByAdamState``."""
    if _is_adam(tree):
        return tree
    if isinstance(tree, (tuple, list)):
        for node in tree:
            found = _adam_node(node)
            if found is not None:
                return found
    return None


def _param_ids(optimizer, net) -> list:
    """``(optimizer state id, parameter name)`` for every parameter of
    ``net``, which ``optimizer`` must hold in ``net.parameters()`` order."""
    ids = [i for group in optimizer.state_dict()["param_groups"] for i in group["params"]]
    names = [name for name, _ in net.named_parameters()]
    if len(ids) != len(names):
        raise ValueError(f"the optimizer holds {len(ids)} tensors, the net {len(names)}")
    return list(zip(ids, names))


def opt_state_from_optax(opt_state, optimizer, net) -> dict:
    """The optax state of ``chain(clip_by_global_norm, adamw)`` (leaves
    numpy-convertible) as a ``state_dict`` for ``optimizer``, a torch AdamW
    over ``net.parameters()``: ``count`` -> ``step``, ``mu`` ->
    ``exp_avg``, ``nu`` -> ``exp_avg_sq``, each moment carried across as
    :func:`params_from_flax` carries the parameters.  Load it with
    ``optimizer.load_state_dict``; the hyperparameters stay the
    optimizer's."""
    adam = _adam_node(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optax state")
    mu, nu = params_from_flax(adam.mu), params_from_flax(adam.nu)
    step = float(np.asarray(adam.count))
    state = {
        i: {"step": torch.tensor(step), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
        for i, name in _param_ids(optimizer, net)
    }
    return {"state": state, "param_groups": optimizer.state_dict()["param_groups"]}


def opt_state_to_optax(optimizer, net, like):
    """The inverse of :func:`opt_state_from_optax`: ``like`` (an optax
    state of the same chain, e.g. ``opt.init(params)``) with its Adam node's
    ``count``, ``mu`` and ``nu`` taken from ``optimizer`` (numpy leaves).
    A parameter the optimizer has not stepped yet has zero moments."""
    state = optimizer.state_dict()["state"]
    mu, nu, steps = {}, {}, set()
    params = dict(net.named_parameters())
    for i, name in _param_ids(optimizer, net):
        s = state.get(i)
        zeros = torch.zeros_like(params[name], device="cpu")
        mu[name] = zeros if s is None else s["exp_avg"]
        nu[name] = zeros if s is None else s["exp_avg_sq"]
        steps.add(0 if s is None else int(s["step"]))
    if len(steps) != 1:
        raise ValueError(f"the parameters were stepped unequally: {sorted(steps)}")
    count = np.asarray(steps.pop(), np.int32)

    def rebuild(node):
        if _is_adam(node):
            return node._replace(count=count, mu=params_to_flax(mu), nu=params_to_flax(nu))
        if isinstance(node, tuple):
            items = [rebuild(x) for x in node]
            return type(node)(*items) if hasattr(node, "_fields") else tuple(items)
        return node

    if _adam_node(like) is None:
        raise ValueError("no Adam state (count, mu, nu) in the optax state")
    return rebuild(like)
