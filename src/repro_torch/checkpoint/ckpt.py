"""Flat-npz checkpointing of nested states (named tuples, dicts, lists of
tensors or arrays).

Leaves are stored under '/'-joined key paths written as the reference
package writes them: a named-tuple field as ``.name``, a dict entry as its
key, a list or tuple entry as its index, and a ``None`` field not at all.
So a replica carry checkpointed by either package restores into the
other's.  Restore validates the structure against a template, so a
checkpoint of another configuration fails loudly instead of mis-loading.

Saves are crash-safe: the payload is written to a temp file and moved into
place with ``os.replace``, then the metadata sidecar (which records the
payload's SHA-256) is committed the same way.  A missing sidecar therefore
means the save never completed; a digest mismatch means the payload was
corrupted or overwritten after the sidecar was committed.  Both raise on
load.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` pairs in the reference's flattening order."""
    if tree is None:
        return []
    if _is_namedtuple(tree):
        items = [(f".{name}", v) for name, v in zip(tree._fields, tree)]
    elif isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    out = []
    for key, value in items:
        out.extend(_leaves(value, prefix + (key,)))
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:  # npz has no bf16: store upcast
            leaf = leaf.float()
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _leaves(tree)}


def _rebuild(template, restored: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    """``template``'s structure with its leaves taken from ``restored``."""
    if template is None:
        return None
    if _is_namedtuple(template):
        return type(template)(*[_rebuild(v, restored, prefix + (f".{name}",))
                                for name, v in zip(template._fields, template)])
    if isinstance(template, dict):
        return {k: _rebuild(v, restored, prefix + (str(k),)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, restored, prefix + (str(i),))
                              for i, v in enumerate(template))
    return restored["/".join(prefix)]


def _payload_path(path: Path) -> Path:
    # np.savez appends .npz when the name does not already end with it;
    # mirror that so save and load agree on the final payload location.
    return path if path.suffix == ".npz" else Path(str(path) + ".npz")


def _sha256_file(path: Path) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            digest.update(block)
    return digest.hexdigest()


def save_checkpoint(path, tree, step: int = 0, metadata: Dict[str, Any] | None = None):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    payload = _payload_path(path)
    # The temp name keeps the .npz suffix so np.savez does not append another.
    tmp = payload.with_name(payload.name + ".tmp.npz")
    np.savez(tmp, **flat)
    digest = _sha256_file(tmp)
    os.replace(tmp, payload)  # atomic: readers see old payload or new, never partial
    meta = {"step": step, "keys": sorted(flat), "sha256": digest, **(metadata or {})}
    sidecar = path.with_suffix(".json")
    meta_tmp = sidecar.with_name(sidecar.name + ".tmp")
    meta_tmp.write_text(json.dumps(meta))
    os.replace(meta_tmp, sidecar)  # sidecar lands last: it is the commit marker


def load_checkpoint(path, template) -> Tuple[Any, int]:
    """Restore into the structure of ``template``; returns ``(tree, step)``.
    Each leaf takes its template leaf's dtype, and a tensor leaf its
    device."""
    path = Path(path)
    payload = _payload_path(path)
    sidecar = path.with_suffix(".json")
    if not sidecar.exists():
        raise FileNotFoundError(
            f"checkpoint sidecar {sidecar} is missing; the sidecar is written "
            f"last, so an absent one means the save was interrupted before it "
            f"committed — discard {payload} and fall back to an older checkpoint"
        )
    meta = json.loads(sidecar.read_text())
    recorded = meta.get("sha256")
    if recorded is not None:  # sidecars from before the digest existed load as-is
        actual = _sha256_file(payload)
        if actual != recorded:
            raise ValueError(
                f"checkpoint payload mismatch for {payload}: sha256 {actual} != "
                f"recorded {recorded}; the payload is corrupt or was overwritten "
                f"after the sidecar was committed"
            )
    data = np.load(payload)
    leaves = dict(_leaves(template))
    missing = set(leaves) - set(data.files)
    extra = set(data.files) - set(leaves)
    if missing or extra:
        raise ValueError(f"checkpoint mismatch: missing={sorted(missing)[:5]} extra={sorted(extra)[:5]}")
    restored = {}
    for key, leaf in leaves.items():
        arr = data[key]
        if tuple(arr.shape) != tuple(np.shape(leaf)):
            raise ValueError(f"shape mismatch at {key}: {arr.shape} vs {tuple(np.shape(leaf))}")
        if isinstance(leaf, torch.Tensor):
            restored[key] = torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
        else:
            restored[key] = np.asarray(arr).astype(np.asarray(leaf).dtype)
    return _rebuild(template, restored), meta["step"]
