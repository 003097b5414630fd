"""Checkpointing: a tree of tensors saved as npz + a JSON manifest, the twin
of ``repro/checkpoint/__init__.py`` in numpy and torch, with the same
on-disk format, so either package restores what the other saved.

It holds the full training state (dense replicas, embedding tables,
optimizer state, the sync algorithm's state, the step counter), so a
ShadowSync run can resume mid-stream: a CTR run sees its data once, and
resuming is what keeps a failure from losing it.

Format. Each save lands as a new *generation* directory
``<path>/gen-NNNNNN``: ``arrays.npz`` (one array a leaf) and
``manifest.json`` with ``dtypes`` (a leaf's stored dtype, ``"bfloat16"``
for bf16 leaves, which are stored as their ``uint16`` bits), ``crc32``
(over each leaf's STORED bytes), ``metadata`` and ``treedef`` (a
description of the tree that neither package reads back). Leaf names are
the JAX key paths (``tree.leaves_with_path``): ``w/bottom/0/w``,
``algo/.w_global``. A host ``int`` leaf (Gossip's round counter) is stored
as a 0-d ``int32`` and restored as an ``int``; a ``None`` subtree (MA's
state) stores nothing. bf16 bits go through ``torch.int16`` views, so no
numpy extension type is needed.

Crash safety. The arrays and manifest are written to a hidden temp
directory, fsynced file by file, and published with one ``os.replace``:
a reader never sees a torn generation, and ``save`` keeps the last
``keep`` of them. ``restore`` verifies each leaf's CRC32 and, on bit-rot or
truncation (``CheckpointCorruptError``), falls back to the newest intact
generation with a warning naming the corrupt leaf. A missing leaf or a
shape mismatch is a plain ``ValueError`` and never falls back: that would
hide a caller's mistake behind stale weights. The legacy flat layout
(``<path>/manifest.json``) still restores.

Elastic restore. ``restore_elastic`` resizes leaves whose shapes differ
only in the leading (replica) axis: shrink truncates, growth fills the new
rows with the saved replicas' mean, taken in numpy float32 as the JAX
package does. The fill is a placeholder that ``HogwildSim.load_state``
overwrites through the algorithm's join hook.

A tensor on the card is copied to the host (``.cpu()``) to be saved, and
restored onto the device of the template's leaf.
"""
from __future__ import annotations

import json
import os
import shutil
import warnings
import zipfile
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as T

_GEN_PREFIX = "gen-"
BF16 = "bfloat16"


class CheckpointCorruptError(ValueError):
    """A generation failed its integrity check (CRC32 mismatch, truncated
    archive, unreadable manifest). Distinct from the plain ``ValueError`` of
    a template or shape mismatch, because ONLY corruption may fall back to
    an older generation."""


# -- leaves <-> stored arrays -------------------------------------------------

def _stored(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as (the array written to the npz, its manifest dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        a = t.numpy()
    elif isinstance(leaf, int):
        a = np.asarray(leaf, np.int32)
    else:
        raise TypeError(f"cannot checkpoint a leaf of type {type(leaf).__name__}")
    return a, str(a.dtype)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()  # a host int


def _leaf(arr: np.ndarray, dtype: str, like):
    """A stored array back as a leaf of ``like``'s kind: a tensor on its
    device, or a host int."""
    if not isinstance(like, torch.Tensor):
        return int(arr)
    if dtype == BF16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(like.device)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _structure(tree: Any) -> str:
    return repr(T.map(lambda x: None if x is None else "*", tree))


# -- generation layout ----------------------------------------------------------

def _gen_dirs(path: str) -> List[Tuple[int, str]]:
    """(generation, dir) pairs under ``path``, newest first."""
    if not os.path.isdir(path):
        return []
    out = []
    for name in os.listdir(path):
        if not name.startswith(_GEN_PREFIX):
            continue
        try:
            g = int(name[len(_GEN_PREFIX):])
        except ValueError:
            continue
        out.append((g, os.path.join(path, name)))
    return sorted(out, reverse=True)


def _read_candidates(path: str) -> List[str]:
    """Checkpoint dirs to try, newest generation first; the legacy flat
    layout (manifest directly under ``path``) last."""
    cands = [d for _, d in _gen_dirs(path)]
    if os.path.exists(os.path.join(path, "manifest.json")):
        cands.append(path)
    if not cands:
        raise FileNotFoundError(
            f"no checkpoint at {path!r}: neither {_GEN_PREFIX}* generations "
            f"nor a flat manifest.json")
    return cands


def _fsync_file(fp: str) -> None:
    with open(fp, "rb") as f:
        os.fsync(f.fileno())


def _fsync_dir(d: str) -> None:
    fd = os.open(d, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(path: str, tree: Any, metadata: Optional[Dict[str, Any]] = None,
         *, keep: int = 2) -> None:
    """Crash-safe generational save: temp dir -> fsync -> one atomic
    ``os.replace``; the last ``keep`` generations are kept as fallbacks."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    os.makedirs(path, exist_ok=True)
    gens = _gen_dirs(path)
    next_gen = gens[0][0] + 1 if gens else 0
    final = os.path.join(path, f"{_GEN_PREFIX}{next_gen:06d}")
    tmp = os.path.join(path, f".tmp-{_GEN_PREFIX}{next_gen:06d}")
    if os.path.exists(tmp):  # debris of a save that crashed
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays, dtypes, crcs = {}, {}, {}
    for key, leaf in T.leaves_with_path(tree):
        arrays[key], dtypes[key] = _stored(leaf)
        crcs[key] = _crc(arrays[key])
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"treedef": _structure(tree), "dtypes": dtypes, "crc32": crcs,
                   "metadata": metadata or {}}, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_file(os.path.join(tmp, "arrays.npz"))
    _fsync_dir(tmp)
    # the publish: a crash before it leaves only an ignored .tmp-*, a crash
    # after it a complete generation
    os.replace(tmp, final)
    _fsync_dir(path)
    for _, old in _gen_dirs(path)[keep:]:
        shutil.rmtree(old, ignore_errors=True)


def generations(path: str) -> List[str]:
    """Generation directories under ``path``, newest first (empty for a
    legacy flat checkpoint)."""
    return [d for _, d in _gen_dirs(path)]


# -- reading ----------------------------------------------------------------------

def _open_gen(d: str) -> Tuple[Any, Dict[str, Any]]:
    """(npz handle, manifest) of one generation; every unreadable or
    truncated file is a ``CheckpointCorruptError``."""
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(d, "arrays.npz"))
    except (json.JSONDecodeError, zipfile.BadZipFile, EOFError, OSError) as e:
        raise CheckpointCorruptError(
            f"checkpoint generation at {d!r} is unreadable ({type(e).__name__}: {e})") from e
    return data, manifest


def _load_leaf(data, manifest, key: str, path: str) -> np.ndarray:
    """The stored array of ``key``, CRC-checked (bf16 still as its bits)."""
    if key not in data.files:
        have = ", ".join(sorted(data.files)[:8])
        raise ValueError(
            f"checkpoint at {path!r} has no leaf {key!r} required by the restore template "
            f"(checkpoint leaves include: {have}{', ...' if len(data.files) > 8 else ''})")
    try:
        arr = data[key]
    except (zipfile.BadZipFile, zlib.error, EOFError, OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"corrupt leaf {key!r} in checkpoint at {path!r}: undecodable "
            f"({type(e).__name__}: {e})") from e
    want = manifest.get("crc32", {}).get(key)  # legacy manifests have none
    if want is not None:
        got = _crc(arr)
        if got != want:
            raise CheckpointCorruptError(
                f"corrupt leaf {key!r} in checkpoint at {path!r}: crc32 mismatch "
                f"(manifest {want:#010x}, stored bytes {got:#010x})")
    return arr


def _with_fallback(path: str, fn: Callable[[str], Any]) -> Any:
    """``fn(gen_dir)`` on the newest generation, falling back to older ones
    ONLY on ``CheckpointCorruptError``."""
    cands = _read_candidates(path)
    first_err: Optional[CheckpointCorruptError] = None
    for i, d in enumerate(cands):
        try:
            return fn(d)
        except CheckpointCorruptError as e:
            first_err = first_err or e
            if i + 1 < len(cands):
                warnings.warn(f"{e}; falling back to older generation {cands[i + 1]!r}",
                              RuntimeWarning)
    raise CheckpointCorruptError(
        f"every generation of the checkpoint at {path!r} is corrupt; "
        f"first failure: {first_err}") from first_err


def read_metadata(path: str) -> Dict[str, Any]:
    """The manifest's metadata alone, for checks before any array loads."""
    return _with_fallback(path, lambda d: _open_gen(d)[1]["metadata"])


def restore(path: str, like: Any) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``like`` (shapes must match). Raises
    ``ValueError`` naming the leaf when one is missing or its shape differs,
    and ``CheckpointCorruptError`` when no intact generation is left."""
    tree, meta, _ = _with_fallback(path, lambda d: _restore_one(d, like, None))
    return tree, meta


def restore_elastic(path: str, like: Any, *,
                    may_resize: Optional[Callable[[str], bool]] = None
                    ) -> Tuple[Any, Dict[str, Any], Dict[str, Tuple]]:
    """``restore``, but leaves whose shapes differ ONLY in the leading
    (replica) axis are resized: shrink truncates, growth fills with the mean
    of the saved replicas. Returns ``(tree, metadata, resized)``, ``resized``
    mapping each resized key to ``(saved_shape, restored_shape)``.
    ``may_resize(key)`` names the leaves allowed to resize (``None``: all),
    so a row-count change of a non-replica leaf raises."""
    return _with_fallback(path, lambda d: _restore_one(d, like, may_resize or (lambda k: True)))


def _restore_one(d: str, like: Any, may_resize: Optional[Callable[[str], bool]]):
    data, manifest = _open_gen(d)
    out, resized = [], {}
    for key, leaf in T.leaves_with_path(like):
        arr = _load_leaf(data, manifest, key, d)
        dtype = manifest["dtypes"].get(key, str(arr.dtype))
        want = _shape(leaf)
        if arr.shape != want:
            if may_resize is None:
                raise ValueError(
                    f"shape mismatch restoring leaf {key!r} from {d!r}: checkpoint has "
                    f"{tuple(arr.shape)}, template expects {want} (use restore_elastic for "
                    f"replica-axis resizes)")
            if not (may_resize(key) and arr.ndim == len(want) >= 1
                    and arr.shape[1:] == want[1:]):
                raise ValueError(
                    f"shape mismatch restoring leaf {key!r} from {d!r}: checkpoint has "
                    f"{tuple(arr.shape)}, template expects {want}; only the leading (replica) "
                    f"axis of a replica-stacked leaf may differ")
            resized[key] = (tuple(arr.shape), want)
            arr = _resize_leading(arr, want[0], dtype)
        out.append(_leaf(arr, dtype, leaf))
    it = iter(out)
    tree = T.map(lambda x: None if x is None else next(it), like)
    return tree, manifest["metadata"], resized


def _resize_leading(arr: np.ndarray, target: int, dtype: str) -> np.ndarray:
    """Truncate or mean-fill the leading axis to ``target`` rows; the mean is
    taken in float32 (a bf16 leaf's bits widened exactly) and rounded back
    to the stored type."""
    if target <= arr.shape[0]:
        return arr[:target]
    if dtype == BF16:
        values = (arr.astype(np.uint32) << 16).view(np.float32)
    else:
        values = np.asarray(arr, np.float32)
    fill = np.broadcast_to(values.mean(axis=0, keepdims=True),
                           (target - arr.shape[0],) + arr.shape[1:])
    if dtype == BF16:  # round to nearest even, as the extension type does
        fill = torch.from_numpy(np.array(fill)).to(torch.bfloat16)
        fill = fill.view(torch.int16).numpy().view(np.uint16)
    return np.concatenate([arr, fill.astype(arr.dtype)], axis=0)
