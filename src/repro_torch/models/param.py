"""Parameter specs and their materialisation as torch tensors.

Modules describe their parameters once as ``ParamSpec`` trees (shape +
initializer); :func:`init_params` makes tensors on the target device with
an explicit ``torch.Generator`` there, so a 4 B-parameter model is drawn
on the card without a host copy.  The logical sharding axes of the
reference's specs are left out: the port runs on one card.

Initial values follow the reference's rules (``fan_in`` uses
``prod(shape[:-1])`` of the possibly layer-stacked shape) but not its
random stream: ``jax.random`` and ``torch.Generator`` draw different
numbers from one seed.  Weights that must agree with the JAX package are
carried across with :func:`from_numpy_tree`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"              # normal | zeros | ones | fan_in
    scale: float = 1.0


def tree_items(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in the reference's flatten order (sorted dict
    keys, list order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from tree_items(x, path + (i,))
    else:
        yield path, tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, x) for x in tree]
    return fn(tree)


def stack_specs(specs, n: int):
    """Prepend a layer dim (the reference scans over it; the port loops)."""
    return tree_map(lambda s: ParamSpec((n,) + s.shape, s.init, s.scale),
                    specs)


def _init_tensor(spec: ParamSpec, gen: torch.Generator, dtype,
                 device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "fan_in":
        fan_in = spec.shape[0] if len(spec.shape) == 1 else int(
            np.prod(spec.shape[:-1]))
        std = spec.scale / math.sqrt(max(fan_in, 1))
    elif spec.init == "normal":
        std = spec.scale
    else:
        raise ValueError(spec.init)
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(dtype)


def init_params(specs, seed: int, dtype, device: torch.device):
    """Materialize a ParamSpec tree on ``device`` (one generator, leaves
    drawn in flatten order)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out: dict = {}
    for path, spec in tree_items(specs):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _init_tensor(spec, gen, dtype, device)
    return out


def _to_tensor(arr, device, dtype) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":   # ml_dtypes bf16 has no torch twin
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_numpy_tree(tree, device, dtype=None):
    """Carry a tree of numpy arrays (e.g. ``jax.tree.map(np.asarray,
    M.init(...))``) into torch tensors with the same leaf paths.
    ``dtype`` recasts floating leaves; ``None`` keeps each leaf's type."""
    device = torch.device(device)
    return tree_map(lambda a: _to_tensor(a, device, dtype), tree)
