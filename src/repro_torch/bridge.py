"""Weight bridge: a parameter tree held as numpy arrays -> the port's tree.

The JAX package's weights reach the port through numpy (jax.random cannot be
reproduced in torch, so parity tests build weights there and move them
here). The bridge reads nested dicts whose leaves are numpy arrays or
QTensor-like objects (anything with `q`, `scale`, `zero`, `fmt`, `group`) and
builds the same tree of torch tensors and `QTensor`s on a device.

numpy has no bfloat16 of its own; bf16 leaves travel as uint16 bit views
(`_VIEW_AS`, the same idea as the JAX package's checkpoint format): a leaf
whose dtype is named "bfloat16" (ml_dtypes' type, as `np.asarray` of a JAX
bf16 array gives) or a `(uint16 array, "bfloat16")` pair becomes a torch
bf16 tensor with the same bits.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.quant.qtensor import QTensor

# storage views for dtypes numpy cannot hold natively
_VIEW_AS = {"bfloat16": (np.uint16, torch.bfloat16)}


def from_storable(arr: np.ndarray, dtype_name: str, device="cpu"
                  ) -> torch.Tensor:
    """(numpy array, dtype name) -> torch tensor with the same bits."""
    if dtype_name in _VIEW_AS:
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(
            _VIEW_AS[dtype_name][1]).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _leaf(x: Any, device) -> torch.Tensor:
    if isinstance(x, tuple):
        return from_storable(x[0], x[1], device)
    arr = np.asarray(x)
    return from_storable(arr, arr.dtype.name, device)


def params_from_numpy(tree: Any, device="cpu") -> Any:
    """Nested dict of numpy leaves / QTensor-like nodes -> the port's tree."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if all(hasattr(tree, f) for f in ("q", "scale", "zero", "fmt", "group")):
        return QTensor(q=_leaf(tree.q, device), scale=_leaf(tree.scale, device),
                       zero=None if tree.zero is None
                       else _leaf(tree.zero, device),
                       fmt=str(tree.fmt), group=int(tree.group))
    return _leaf(tree, device)
