"""Atomic, async checkpointing (port of ``repro.checkpoint.checkpointer``).

Layout:  <dir>/step_<n>/
           manifest.json          — tree structure, shapes, dtypes, step
           shard_0.npz            — flattened leaves (host numpy arrays)

A tree is a nested dict (string keys, flattened in sorted order, as a
JAX pytree), list or tuple whose leaves are tensors, numpy arrays or
numbers; ``None`` is an empty subtree. Fault-tolerance contract:
  * writes go to ``step_<n>.tmp`` then ``os.rename`` → a crash mid-write
    can never corrupt the latest checkpoint;
  * ``latest_step`` scans only committed directories;
  * ``AsyncCheckpointer`` copies every leaf to the host on the
    caller's thread (CPU tensors too) and writes on a background thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch


def _flatten(tree) -> tuple[list, Any]:
    """Leaves in pytree order and the structure to rebuild the tree."""
    if tree is None:
        return [], None
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, children = [], []
        for k in keys:
            sub, spec = _flatten(tree[k])
            leaves += sub
            children.append(spec)
        return leaves, {"dict": keys, "children": children}
    if isinstance(tree, (list, tuple)):
        leaves, children = [], []
        for x in tree:
            sub, spec = _flatten(x)
            leaves += sub
            children.append(spec)
        kind = "tuple" if isinstance(tree, tuple) else "list"
        return leaves, {kind: len(tree), "children": children}
    return [tree], "*"


def unflatten(structure, leaves: list):
    """Rebuild a tree of ``structure`` (from ``_flatten``) from leaves."""
    it = iter(leaves)

    def build(spec):
        if spec is None:
            return None
        if spec == "*":
            return next(it)
        children = [build(c) for c in spec["children"]]
        if "dict" in spec:
            return dict(zip(spec["dict"], children))
        return tuple(children) if "tuple" in spec else children

    out = build(structure)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def num_leaves(structure) -> int:
    if structure is None:
        return 0
    if structure == "*":
        return 1
    return sum(num_leaves(c) for c in structure["children"])


def _host(x) -> np.ndarray:
    """A leaf as a host numpy array of its own (bf16 widened: npz has no
    bf16): always a copy, never a view of the caller's storage, so a
    step that updates the state in place while a save is being written
    does not reach into that save."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    a = np.array(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def save(ckpt_dir: str, step: int, tree, *, max_keep: int = 3) -> str:
    """Atomic synchronous save. Returns the committed directory."""
    leaves, structure = _flatten(tree)
    leaves = [_host(x) for x in leaves]
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "shard_0.npz"),
             **{f"leaf_{i}": x for i, x in enumerate(leaves)})
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "treedef": json.dumps(structure),
        "shapes": [list(x.shape) for x in leaves],
        "dtypes": [str(x.dtype) for x in leaves],
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, max_keep)
    return final


def _gc(ckpt_dir: str, max_keep: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-max_keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return out


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def _restore_leaf(got: np.ndarray, want):
    if tuple(got.shape) != tuple(np.shape(want)):
        raise ValueError(f"shape mismatch {got.shape} vs {np.shape(want)}")
    if isinstance(want, torch.Tensor):
        return torch.from_numpy(np.array(got)).to(device=want.device,
                                                  dtype=want.dtype)
    return np.asarray(got).astype(np.asarray(want).dtype)


def restore(ckpt_dir: str, step: int, like):
    """Restore into the structure of ``like`` (a tree of tensors or
    arrays): shapes are validated, and each leaf comes back with the
    type, dtype and device of its ``like`` leaf."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "shard_0.npz")) as data:
        leaves = [data[f"leaf_{i}"] for i in range(manifest["n_leaves"])]
    like_leaves, structure = _flatten(like)
    if len(leaves) != len(like_leaves):
        raise ValueError(f"leaf count mismatch: {len(leaves)} vs "
                         f"{len(like_leaves)}")
    return unflatten(structure, [_restore_leaf(g, w)
                                 for g, w in zip(leaves, like_leaves)])


class AsyncCheckpointer:
    """Background-thread saver: snapshot on the caller thread (a host
    copy of every leaf), write on the worker. At most one in-flight save; a new save
    waits for the previous one (bounded host memory)."""

    def __init__(self, ckpt_dir: str, max_keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.max_keep = max_keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, tree) -> None:
        self.wait()
        leaves, structure = _flatten(tree)
        host_tree = unflatten(structure, [_host(x) for x in leaves])

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, max_keep=self.max_keep)
            except BaseException as e:      # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the in-flight save is committed; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
