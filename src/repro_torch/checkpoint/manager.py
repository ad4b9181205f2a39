"""Step-atomic, async-capable checkpointing, PyTorch port of
:mod:`repro.checkpoint.manager`, in the reference's layout (one directory
per step, atomic via rename):

    <root>/step_000000123.tmp/...   (written)
    <root>/step_000000123/          (renamed on completion = commit point)
        manifest.json               (step, number of leaves, tree structure)
        arr_<idx>.npy               (one file per leaf)

Leaves are numbered in the reference's order (JAX flattens a dict in
sorted key order, a list in its own), so a checkpoint written by either
package restores into the other's tree of the same structure.  bfloat16
leaves are widened to float32 on save (lossless; ``np.save`` has no
bfloat16 without ``ml_dtypes``, which the port does not need) and
``restore`` casts each leaf back to the dtype and device of the tree it
restores into.  Async: the copy to host memory is synchronous and owns
its memory (a consistent snapshot, even of a CPU tree that the train step
then updates in place), the file writes run on a worker thread so the train
loop continues; ``wait()`` joins before the next save.  The reference's
re-sharding restore (``shardings``) is not ported: the port restores onto
the like tree's device.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

MANIFEST = "manifest.json"


def _leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples in JAX's order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _unflatten(like, leaves):
    """A tree shaped as ``like`` holding ``leaves`` in JAX's leaf order."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _treedef(tree) -> str:
    """The tree's structure as ``str`` of a JAX treedef spells it."""
    def walk(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(walk(v) for v in t) + "]"
        if isinstance(t, tuple):
            return "(" + ", ".join(walk(v) for v in t) + ("," if len(t) == 1 else "") + ")"
        return "*"
    return f"PyTreeDef({walk(tree)})"


def _to_numpy(x) -> np.ndarray:
    """A host copy of ``x`` that owns its memory (bfloat16 widened), so a
    later in-place update of ``x`` cannot reach a pending write."""
    if isinstance(x, torch.Tensor):
        dtype = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
        return x.detach().to("cpu", dtype, copy=True).numpy()
    return np.array(x, copy=True)


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ---- save -------------------------------------------------------------

    def save(self, step: int, tree, blocking: bool = False) -> None:
        """Snapshot ``tree`` at ``step``. The copy to host memory happens
        here (a consistent snapshot); file I/O is async unless
        ``blocking``."""
        self.wait()
        leaves = [_to_numpy(x) for x in _leaves(tree)]
        treedef = _treedef(tree)

        def _write():
            tmp = os.path.join(self.root, f"step_{step:09d}.tmp")
            final = os.path.join(self.root, f"step_{step:09d}")
            os.makedirs(tmp, exist_ok=True)
            for i, leaf in enumerate(leaves):
                np.save(os.path.join(tmp, f"arr_{i}.npy"), leaf)
            with open(os.path.join(tmp, MANIFEST), "w") as f:
                json.dump({"step": step, "num_leaves": len(leaves), "treedef": treedef}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # commit point
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:09d}"), ignore_errors=True)

    # ---- restore ------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.root, name, MANIFEST)):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like_tree):
        """Load ``step``'s arrays into the structure of ``like_tree``, each
        leaf cast to the dtype of the like tree's leaf, on its device."""
        path = os.path.join(self.root, f"step_{step:09d}")
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
        likes = _leaves(like_tree)
        assert manifest["num_leaves"] == len(likes), "tree structure changed"
        loaded = [torch.from_numpy(np.load(os.path.join(path, f"arr_{i}.npy")))
                  .to(dtype=like.dtype, device=like.device)
                  for i, like in enumerate(likes)]
        return _unflatten(like_tree, iter(loaded))
