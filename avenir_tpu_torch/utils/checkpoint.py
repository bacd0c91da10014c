"""Checkpoint/resume — step-stamped snapshots of a state tree; port of
``avenir_tpu/utils/checkpoint.py`` with its on-disk format unchanged, so
each package restores the other's snapshots.

A :class:`CheckpointManager` writes step-stamped snapshots of any JSON +
array state tree to a directory, keeps the last K, and restores the latest
on resume (the streamed count jobs' ``StreamCheckpointer``,
``jobs/base.py``).

State trees are nested dicts whose leaves are numpy arrays (or anything
with ``shape`` and ``dtype``), scalars, strings, lists, or None. Arrays go
into one ``arrays.npz`` per snapshot; the structure (with array
placeholders) goes into ``state.json`` — no pickle.  Overwriting a
snapshot moves the old one to ``<step>.bak`` first, which a later load or
manager recovers after a crash.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np

_ARRAY_TAG = "__array__"
_TUPLE_TAG = "__tuple__"
_DICT_TAG = "__dict__"
_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointError(RuntimeError):
    """A snapshot that cannot be restored WHOLE: torn structure, missing
    array payload, or a directory that vanished mid-read.  Restore paths
    must surface this loudly — a partial tree restoring silently is the
    corruption class the atomic save discipline exists to prevent."""


def _escape(key: str) -> str:
    """Array-namespace path escaping: user dict keys may contain '/' (ids are
    user-controlled), which must not collide with the path separator."""
    return key.replace("%", "%25").replace("/", "%2F")


def _flatten(tree: Any, prefix: str, arrays: Dict[str, np.ndarray]) -> Any:
    """Replace array leaves with tagged references; collect arrays."""
    if isinstance(tree, dict):
        out = {k: _flatten(v, f"{prefix}/{_escape(str(k))}", arrays)
               for k, v in tree.items()}
        # a user dict whose single key equals a marker tag would be
        # misread on load — wrap it so decoding stays unambiguous
        if len(out) == 1 and next(iter(out)) in (_ARRAY_TAG, _TUPLE_TAG, _DICT_TAG):
            return {_DICT_TAG: out}
        return out
    if isinstance(tree, (list, tuple)):
        out = [_flatten(v, f"{prefix}/{i}", arrays) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else {_TUPLE_TAG: out}
    # numpy scalars also expose .shape/.dtype — convert them first so they
    # round-trip as Python scalars, not 0-d arrays
    if isinstance(tree, np.bool_):
        return bool(tree)
    if isinstance(tree, np.integer):
        return int(tree)
    if isinstance(tree, np.floating):
        return float(tree)
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        # "k:" guard: np.savez(file, **kwds) would reject a bare key named
        # "file" (collides with its positional parameter)
        key = "k:" + prefix.lstrip("/")
        arrays[key] = np.asarray(tree)
        return {_ARRAY_TAG: key}
    if isinstance(tree, (str, int, float, bool)) or tree is None:
        return tree
    raise TypeError(f"unsupported checkpoint leaf type {type(tree)!r} at {prefix}")


def _unflatten(node: Any, arrays: Dict[str, np.ndarray]) -> Any:
    if isinstance(node, dict):
        if _ARRAY_TAG in node and len(node) == 1:
            ref = node[_ARRAY_TAG]
            if ref not in arrays:
                # the structure references an array the payload lacks: a
                # torn snapshot (external interference — the atomic save
                # never produces this) must refuse, not restore partially
                raise CheckpointError(
                    f"snapshot structure references array {ref!r} missing "
                    f"from arrays.npz — torn snapshot; refusing to "
                    f"restore a partial tree")
            return arrays[ref]
        if _TUPLE_TAG in node and len(node) == 1:
            return tuple(_unflatten(v, arrays) for v in node[_TUPLE_TAG])
        if _DICT_TAG in node and len(node) == 1:
            return {k: _unflatten(v, arrays) for k, v in node[_DICT_TAG].items()}
        return {k: _unflatten(v, arrays) for k, v in node.items()}
    if isinstance(node, list):
        return [_unflatten(v, arrays) for v in node]
    return node


def save_state(path: str, state: Any) -> None:
    """Write one snapshot atomically (temp dir + rename)."""
    parent = os.path.dirname(path.rstrip(os.sep)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".ckpt_", dir=parent)
    try:
        arrays: Dict[str, np.ndarray] = {}
        structure = _flatten(state, "", arrays)
        with open(os.path.join(tmp, "state.json"), "w") as fh:
            json.dump(structure, fh)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        if os.path.exists(path):
            # move the old snapshot to a visible <path>.bak before swapping
            # the new one in: a crash in the window leaves the .bak, which
            # load_state and CheckpointManager both know how to recover
            bak = path.rstrip(os.sep) + ".bak"
            shutil.rmtree(bak, ignore_errors=True)      # stale prior crash
            os.replace(path, bak)
            try:
                os.replace(tmp, path)
            except BaseException:
                os.replace(bak, path)                   # roll back
                raise
            shutil.rmtree(bak, ignore_errors=True)
        else:
            os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load_state(path: str) -> Any:
    if not os.path.exists(os.path.join(path, "state.json")) and \
            os.path.exists(path.rstrip(os.sep) + ".bak"):
        # crash during an overwrite swap: the complete old snapshot is at .bak
        path = path.rstrip(os.sep) + ".bak"
    with open(os.path.join(path, "state.json")) as fh:
        try:
            structure = json.load(fh)
        except ValueError as e:
            raise CheckpointError(
                f"snapshot structure {path!r}/state.json is not valid "
                f"JSON ({e}) — torn snapshot; refusing to restore a "
                f"partial tree") from e
    npz_path = os.path.join(path, "arrays.npz")
    arrays = dict(np.load(npz_path, allow_pickle=False)) if os.path.exists(npz_path) else {}
    return _unflatten(structure, arrays)


class CheckpointManager:
    """Step-stamped snapshot directory with retention.

    ::

        mgr = CheckpointManager(dir, keep=3)
        mgr.save(step, {"weights": w, "round": r})
        state = mgr.restore()          # latest, or None if empty
    """

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._recover()

    def _recover(self) -> None:
        """Finish any overwrite swap interrupted by a crash: promote orphaned
        ``step_N.bak`` snapshots, drop redundant ones, and sweep leftover
        ``.ckpt_*`` temp dirs (each holds a full-size snapshot copy).
        Single-writer assumption: no concurrent save may be in flight."""
        for name in os.listdir(self.directory):
            if name.startswith(".ckpt_"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
                continue
            if not name.endswith(".bak") or not _STEP_RE.match(name[:-4]):
                continue
            bak = os.path.join(self.directory, name)
            live = bak[:-4]
            if os.path.exists(live):
                shutil.rmtree(bak, ignore_errors=True)
            else:
                os.replace(bak, live)

    def _steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.isdir(os.path.join(self.directory, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, step: int, state: Any) -> str:
        path = os.path.join(self.directory, f"step_{step}")
        save_state(path, state)
        for old in self._steps()[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{old}"),
                          ignore_errors=True)
        return path

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, *,
                reshard_to=None) -> Optional[Any]:
        """Restore a snapshot — whole, or not at all.

        Latest-step restore (``step=None``) tolerates a snapshot that
        vanishes between the directory listing and the read (a concurrent
        retention sweep racing ``_steps()``): it falls back to the next-
        newest intact snapshot.  A torn snapshot raises
        :class:`CheckpointError` instead.

        ``reshard_to``: a target topology — a ``parallel/shard.ShardSpec``,
        a ``:mesh:<axis><n>`` suffix, or ``""`` for unsharded — onto which
        every mesh-qualified accumulator entry of the tree is re-keyed
        (``checkpoint/reshard.py``; ``ReshardError`` on state that cannot
        move).  None (the default) returns the tree exactly as written,
        qualifiers included: pass ``""``, not None, to strip them."""
        steps = [step] if step is not None else \
            list(reversed(self._steps()))
        state = missing = object()
        for s in steps:
            try:
                state = load_state(os.path.join(self.directory, f"step_{s}"))
                break
            except FileNotFoundError:
                if step is not None:
                    raise
        if state is missing:
            return None
        if reshard_to is not None:
            from avenir_tpu_torch.checkpoint import reshard

            state, _ = reshard.reshard_state_tree(state, reshard_to)
        return state

    def clear(self) -> None:
        """Remove every manager-owned entry (``step_N`` snapshots, their
        ``.bak`` twins, ``.ckpt_*`` temps), then the directory itself —
        but ONLY if nothing else lives there.  Users may point the
        checkpoint dir at a shared area holding unrelated files; a
        successful run must never delete those."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return
        for name in names:
            owned = (name.startswith(".ckpt_") or _STEP_RE.match(name)
                     or (name.endswith(".bak") and _STEP_RE.match(name[:-4])))
            if owned:
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
        try:
            os.rmdir(self.directory)        # only succeeds when empty
        except OSError:
            pass
