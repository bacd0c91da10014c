"""Topology-portable checkpoints — port of
``avenir_tpu/checkpoint/reshard.py``.

A sharded fold keys its gram under a mesh qualifier
(``parallel/shard.py::ShardSpec.g_suffix``: ``:mesh:<axis><n>``, or
``:mesh:<proc><p>x<data><n>`` across processes), so a snapshot restored
under another topology is refused rather than summed with fresh counts.
This module moves a snapshot across that gate on purpose
(``shard.reshard.on.restore``): every mesh-qualified entry is re-keyed
for the target topology, its value untouched, or the state is refused
with a :class:`ReshardError` naming the key.

Why re-keying is exact: each qualified entry is a 64-bit host total that
the fold already reduced over every shard (and every process) of the
source mesh — int64 counts, and float64 moment sums where the partials
are exact — so an 8-way fold's totals are the 4-way fold's byte for
byte.  The qualifier exists to prevent a silent cross-topology sum, not
because the numbers differ; the crossing is journaled
(``checkpoint.reshard``).

Refused: a ``g:`` key whose qualifier is neither the declared source nor
the target; two entries that would collide under one target key; and
(in ``pipeline/scan.py::ChunkFolder.adopt_state``, which owns the
routing) a foreign base layout or chunked-einsum counts promoted onto a
gram routing.  The suffix strings are the JAX package's letter for
letter, so each package restores the other's snapshots.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

MESH_TAG = ":mesh:"


class ReshardError(ValueError):
    """State that cannot be redistributed to the target topology; the
    message names the offending key."""


def spec_suffix(spec) -> str:
    """The mesh qualifier of a topology operand: a ``ShardSpec``-like
    object (its ``g_suffix``), an explicit suffix string
    (``":mesh:data4"`` or ``""``), or None (unsharded)."""
    if spec is None:
        return ""
    if isinstance(spec, str):
        if spec and not spec.startswith(MESH_TAG):
            raise ReshardError(
                f"target suffix {spec!r} is not a {MESH_TAG}<axis><n> "
                f"mesh qualifier")
        return spec
    return spec.g_suffix


def split_mesh_key(key: str) -> Tuple[str, str]:
    """``"g:cls:f4:b5:c2:mesh:data8"`` → ``("g:cls:f4:b5:c2",
    ":mesh:data8")``; an unqualified key keeps an empty suffix."""
    pos = key.find(MESH_TAG)
    if pos < 0:
        return key, ""
    return key[:pos], key[pos:]


def state_suffix(state: Dict[str, Any]) -> Optional[str]:
    """The one mesh suffix an accumulator-state mapping was folded under:
    ``":mesh:<axis><n>"``, ``""`` for an unqualified gram, None when it
    holds no gram key (no topology evidence).  Raises
    :class:`ReshardError` on two suffixes in one mapping."""
    seen: Dict[str, str] = {}
    for key in state:
        if isinstance(key, str) and key.startswith("g:"):
            _, sfx = split_mesh_key(key)
            seen[sfx] = key
    if len(seen) > 1:
        raise ReshardError(
            f"mixed-topology accumulator state: gram keys "
            f"{sorted(seen.values())} carry different mesh qualifiers — "
            f"state folded under two topologies cannot be redistributed")
    return next(iter(seen), None)


def snapshot_suffix(state: Dict[str, Any]) -> Optional[str]:
    """The writing topology of a whole snapshot: its recorded ``"shard"``
    field when present, else inferred from the gram keys of every
    accumulator mapping it holds (``ring[i]["state"]``, ``"acc"``; a pane
    with no gram does not vote).  None means no evidence;
    :class:`ReshardError` when two mappings disagree."""
    recorded = state.get("shard")
    if isinstance(recorded, str):
        return recorded
    votes = set()
    for rec in state.get("ring") or []:
        if isinstance(rec, dict):
            sfx = state_suffix(rec.get("state") or {})
            if sfx is not None:
                votes.add(sfx)
    if isinstance(state.get("acc"), dict):
        sfx = state_suffix(state["acc"])
        if sfx is not None:
            votes.add(sfx)
    if len(votes) > 1:
        raise ReshardError(
            f"snapshot holds accumulator state under {len(votes)} "
            f"different topologies ({sorted(votes)}) — mixed-topology "
            f"snapshots cannot be redistributed")
    return next(iter(votes), None)


def rekey_state(state: Dict[str, Any], target,
                source=None) -> Tuple[Dict[str, Any], List[str]]:
    """Re-key every mesh-qualified ``g:`` entry of one accumulator-state
    mapping for ``target``; values pass through untouched.

    ``target`` / ``source`` are :func:`spec_suffix` operands; a None
    source accepts whatever one suffix the state carries.  Returns
    ``(new_state, rekeyed_keys)``.  Raises :class:`ReshardError` on a
    suffix that is neither source nor target, or on a collision."""
    dst = spec_suffix(target)
    if source is not None:
        src = spec_suffix(source)
    else:
        inferred = state_suffix(state)
        src = dst if inferred is None else inferred
    out: Dict[str, Any] = {}
    rekeyed: List[str] = []
    for key, val in state.items():
        new_key = key
        if isinstance(key, str) and key.startswith("g:"):
            base, sfx = split_mesh_key(key)
            if sfx not in (src, dst):
                raise ReshardError(
                    f"gram state {key!r} was folded under topology "
                    f"{sfx or 'unsharded'!r}, not the declared source "
                    f"{src or 'unsharded'!r} — refusing to redistribute "
                    f"state of unknown provenance")
            new_key = base + dst
            if new_key != key:
                rekeyed.append(key)
        if new_key in out:
            raise ReshardError(
                f"redistributing {key!r} onto {new_key!r} collides with "
                f"another entry of the same state — the source mapping "
                f"already holds both topologies' totals")
        out[new_key] = val
    return out, rekeyed


def _is_acc_state(node: Any) -> bool:
    return isinstance(node, dict) and any(
        isinstance(k, str) and k.startswith("g:") for k in node)


def reshard_state_tree(tree: Any, target,
                       source=None) -> Tuple[Any, List[str]]:
    """Re-key every accumulator-state mapping (any dict holding a ``g:``
    key) of a checkpoint tree for ``target``: pane rings
    (``ring[i]["state"]``), stream totals (``"acc"``); cursors, row
    counters and LR histories pass through.  A top-level ``"shard"``
    entry (the recorded writing topology) becomes the target suffix.
    Returns ``(new_tree, rekeyed_keys)``."""
    rekeyed: List[str] = []

    def walk(node: Any) -> Any:
        if _is_acc_state(node):
            out, moved = rekey_state(node, target, source)
            rekeyed.extend(moved)
            return out
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        return node

    out = walk(tree)
    # only the top-level "shard" entry is the recorded writing topology;
    # nested dicts (component extras) may use the name freely
    if isinstance(out, dict) and isinstance(out.get("shard"), str):
        out["shard"] = spec_suffix(target)
    return out, rekeyed


def journal_reshard(src: str, dst: str, keys: int, directory: str = "",
                    run: str = "") -> None:
    """Journal one ``checkpoint.reshard`` crossing: the topology a snapshot
    was written under, the one it was redistributed onto, and how many
    accumulator entries moved."""
    from avenir_tpu_torch.telemetry import spans as tel

    tel.tracer().event("checkpoint.reshard",
                       dir=directory, run=run,
                       src=src or "unsharded", dst=dst or "unsharded",
                       keys=keys)


def describe(suffix: str) -> str:
    """A topology's name for messages: the suffix, or ``unsharded``."""
    return suffix or "unsharded"


def suffix_procs(suffix: str) -> int:
    """The process count a mesh qualifier encodes: ``:mesh:proc2xdata4``
    → 2, ``:mesh:data8`` / ``""`` → 1 (for messages and the journal; the
    re-keying itself ignores it)."""
    if not suffix:
        return 1
    m = re.match(rf"{re.escape(MESH_TAG)}([a-z]+)(\d+)x", suffix)
    return int(m.group(2)) if m else 1
