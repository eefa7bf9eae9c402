"""Checkpoint / resume for streaming chains (counterpart of
``srcdsp_tpu/checkpoint.py``).

The whole mutable universe of a running chain is one small tree of tensors
(overlap tails, NCO phase words, timing accumulators), so checkpointing is
exact: save the state plus the stream position every K blocks; resume =
load the state + seek the capture file to that block
(``io.capture.read_capture_blocks(start_block=...)``).

The file format is the reference's: ``<path>.npz`` holds ``leaf_0 ..
leaf_{n-1}`` in ``jax.tree_util``'s leaf order (``tree.flatten``) and
``block_index``; ``<path>.json`` holds ``block_index``, ``num_leaves``,
``treedef`` (advisory) and ``extra``. So a checkpoint the JAX package wrote
resumes here, and one written here has the JAX package's keys. The one
difference of content: the port keeps u32 phase words in int64 tensors
(``ops/nco.py``), and `restore` takes a uint32 or int32 leaf into an int64
example exactly.

The multi-host form (``save_orbax`` / ``restore_orbax`` in the reference)
belongs to the multi-process tier and is not here.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from srcdsp_tpu_torch import tree

#: stored integer dtypes an int64 example leaf takes exactly (the JAX
#: package's u32 phase words and int32 counters)
_INTO_INT64 = (np.dtype(np.uint32), np.dtype(np.int32))


def _host_leaves(leaves) -> list[np.ndarray]:
    """Every leaf as numpy, in one pass: each card tensor's copy is queued
    without a wait, then each card is synchronized once."""
    staged, cards = [], set()
    for x in leaves:
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.device.type == "cuda":
                cards.add(x.device)
                x = x.to("cpu", non_blocking=True)
        staged.append(x)
    for d in cards:
        torch.cuda.synchronize(d)
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in staged]


def save(path: str, state: Any, block_index: int, extra: dict | None = None) -> None:
    """Save a chain state + stream position. Overwrites `path`(.npz).

    Atomic: block_index travels INSIDE the .npz (one os.replace commits state
    and position together), and the .json sidecar is also replaced
    atomically; a crash at any point leaves either the old checkpoint or the
    new one, never a state/position mismatch.
    """
    leaves, treedef = tree.flatten(state)
    arrays = {f"leaf_{i}": a for i, a in enumerate(_host_leaves(leaves))}
    arrays["block_index"] = np.asarray(int(block_index))
    meta = {
        "block_index": int(block_index),
        "num_leaves": len(leaves),
        "treedef": str(treedef),
        "extra": extra or {},
    }
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path + ".npz")
    tmpj = path + ".tmp.json"
    with open(tmpj, "w") as f:
        json.dump(meta, f)
    os.replace(tmpj, path + ".json")


def _np_dtype(x) -> np.dtype:
    if isinstance(x, torch.Tensor):
        return torch.empty((), dtype=x.dtype).numpy().dtype
    return np.asarray(x).dtype


def _restore_leaf(i: int, arr: np.ndarray, ex) -> Any:
    """`arr` as the example leaf `ex`: same shape, same dtype (or a u32 /
    int32 array into an int64 example: every such value fits, so the cast is
    exact), a tensor on ex's device where ex is one."""
    shape = tuple(ex.shape) if isinstance(ex, torch.Tensor) else np.shape(ex)
    dtype = _np_dtype(ex)
    if arr.shape != shape or not (arr.dtype == dtype or (
            dtype == np.int64 and arr.dtype in _INTO_INT64)):
        raise ValueError(f"leaf {i}: checkpoint {arr.shape}/{arr.dtype} vs "
                         f"expected {shape}/{dtype}")
    arr = arr.astype(dtype, copy=False)
    return torch.as_tensor(arr, device=ex.device) if isinstance(ex, torch.Tensor) else arr


def restore(path: str, example_state: Any) -> tuple[Any, int]:
    """Load (state, block_index). `example_state` supplies the tree structure
    and the device of each leaf; its leaf VALUES are ignored. Raises
    ValueError on a different leaf count, shape or dtype."""
    with open(path + ".json") as f:
        meta = json.load(f)
    data = np.load(path + ".npz")
    # the position inside the .npz is authoritative (committed atomically
    # with the state); the .json value is advisory for humans
    if "block_index" in data:
        meta["block_index"] = int(data["block_index"])
    leaves, treedef = tree.flatten(example_state)
    if meta["num_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {meta['num_leaves']} leaves, expected {len(leaves)}")
    new_leaves = [_restore_leaf(i, data[f"leaf_{i}"], ex) for i, ex in enumerate(leaves)]
    return tree.unflatten(treedef, new_leaves), int(meta["block_index"])


def exists(path: str) -> bool:
    return os.path.exists(path + ".npz") and os.path.exists(path + ".json")


def delete(path: str) -> None:
    """Invalidate a checkpoint (call when the stream completes)."""
    for suffix in (".npz", ".json"):
        try:
            os.remove(path + suffix)
        except FileNotFoundError:
            pass
