"""Carry the reference's flax variables over to the port's ``state_dict``.

``flax_to_torch`` takes ``{"params": ..., "batch_stats": ...}`` as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, variables)``) and maps
each leaf by its path:

- ``<path>/conv/kernel``, HWIO → ``<path>.weight``, OIHW;
- ``final_dense/kernel``, (in, out) → ``final_dense.weight``, (out, in);
  ``final_dense/bias`` → ``final_dense.bias``; the MLP's ``hidden`` and
  ``softmax_linear`` likewise;
- ``<path>/bn/scale``, ``bias`` → ``<path>.weight``, ``<path>.bias``;
- batch_stats ``<path>/bn/mean``, ``var`` → ``<path>.running_mean``,
  ``<path>.running_var``.

The fused blocks keep the plain blocks' tree in both packages, so one
mapping covers both. An unknown leaf raises.

``flax_opt_state_to_torch`` maps optax's momentum trace (the params tree's
shape, ``opt_state[0].trace`` of ``optax.sgd(lr, momentum)``) onto the
port's momentum buffers by the same rules, so a whole train state carries
across (``TrainState.load_momentum_buffers``).

``reference_layout`` runs the parameter rules backwards: a port parameter's
reference path, its shape in the reference's layout and, for each
reference axis, the port's axis, so that a rule stated over the
reference's axes (the zero1 partition's) picks the same axis in the port.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _map_leaf(collection: str, path: Tuple[str, ...],
              value: np.ndarray) -> Tuple[str, np.ndarray]:
    *head, parent, leaf = path
    name = ".".join(head)
    if collection == "params":
        if parent == "conv" and leaf == "kernel":
            return f"{name}.weight", value.transpose(3, 2, 0, 1)
        if parent == "bn" and leaf in ("scale", "bias"):
            return f"{name}.{'weight' if leaf == 'scale' else 'bias'}", value
        if parent in _DENSE_LAYERS and not head:
            if leaf == "kernel":
                return f"{parent}.weight", value.T
            if leaf == "bias":
                return f"{parent}.bias", value
    if collection == "batch_stats" and parent == "bn" and \
            leaf in ("mean", "var"):
        return f"{name}.running_{leaf}", value
    raise KeyError(f"no torch name for {collection}/{'/'.join(path)}")


# The dense layers at the top of the tree: the ResNets' head, the MLP's two.
_DENSE_LAYERS = ("final_dense", "hidden", "softmax_linear")
# Port axis of each reference axis: HWIO → OIHW, (in, out) → (out, in).
_CONV_AXES = (2, 3, 1, 0)
_DENSE_AXES = (1, 0)


def reference_layout(name: str, shape: Tuple[int, ...]
                     ) -> Tuple[str, Tuple[int, ...], Tuple[int, ...]]:
    """``(reference path, reference shape, port axis of each reference
    axis)`` of the port parameter ``name`` of ``shape``: the inverse of
    :func:`flax_opt_state_to_torch`'s mapping."""
    head, _, leaf = name.rpartition(".")
    shape = tuple(int(d) for d in shape)
    if head in _DENSE_LAYERS and leaf == "weight":
        axes, path = _DENSE_AXES, f"{head}/kernel"
    elif head in _DENSE_LAYERS and leaf == "bias":
        axes, path = (0,), f"{head}/bias"
    elif leaf == "weight" and len(shape) == 4:
        axes, path = _CONV_AXES, f"{head.replace('.', '/')}/conv/kernel"
    elif leaf in ("weight", "bias") and len(shape) == 1:
        axes = (0,)
        path = (f"{head.replace('.', '/')}/bn/"
                f"{'scale' if leaf == 'weight' else 'bias'}")
    else:
        raise KeyError(f"no reference leaf for {name} {shape}")
    return path, tuple(shape[a] for a in axes), axes


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(arr), dtype=torch.float32)


def flax_opt_state_to_torch(trace: Mapping) -> Dict[str, torch.Tensor]:
    """optax momentum trace (params-shaped, numpy leaves) → {parameter
    name: momentum buffer}."""
    return {name: _to_tensor(arr) for name, arr in (
        _map_leaf("params", path, value) for path, value in _leaves(trace))}


def flax_to_torch(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``{params, batch_stats}`` (numpy leaves) → ``state_dict``."""
    out = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            name, arr = _map_leaf(collection, path, value)
            out[name] = _to_tensor(arr)
    return out
