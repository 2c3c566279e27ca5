"""Atomic numpy checkpoints of nested tensor state.

Port of the JAX package's ``repro.checkpoint.checkpoint``, with the same
layout and manifest schema, so the port reads checkpoints the JAX package
writes:

    <dir>/step_<N>/
      manifest.json   {"treedef", "num_leaves", "step",
                       "leaves": [{"index", "path", "shape", "dtype",
                                   "spec"}, ...]}
      arrays.npz      leaf_<i> per leaf (np.savez_compressed)

A state is a tree of dicts (flattened in sorted-key order, as JAX
flattens them), tuples, lists and NamedTuples, whose leaves are tensors,
numpy arrays or Python ints (stored as int32 scalars, restored as ints);
None is an empty subtree. Leaf paths are rendered as JAX's ``keystr``
renders them: ``['buffers']['feat'][0]``, ``['opt_state'].mu['b0']``.
bfloat16 leaves are stored as uint16 views with dtype "bfloat16", as JAX
stores them. ``spec`` is always "" (no sharding here).

The ``treedef`` entry is this package's own rendering of the structure;
a JAX checkpoint holds JAX's ``PyTreeDef`` string, which the port cannot
compare, so a restore validates each leaf's path, shape and dtype
instead, and the rendering only when the port wrote the checkpoint.

Saves are atomic: everything is written and fsynced into
``step_<N>.tmp``, which is ``os.replace``d onto the final name once
complete, and the parent directory is fsynced; a crash mid-save never
leaves a torn ``step_<N>`` for `latest_step` to pick. Transient
``OSError``s are retried with jittered exponential backoff.
"""
from __future__ import annotations

import json
import os
import random
import re
import shutil
import time

import numpy as np
import torch

#: The prefix of the port's own structure rendering in "treedef".
TREEDEF_PREFIX = "repro_torch "


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path=""):
    """[(keystr path, leaf)] in JAX's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{path}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _flatten(getattr(tree, f), f"{path}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, t in enumerate(tree)
                for kv in _flatten(t, f"{path}[{i}]")]
    return [(path, tree)]


def _structure(tree) -> str:
    """The port's rendering of a tree's structure (leaves as *)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return (type(tree).__name__ + "(" + ", ".join(
            f"{f}={_structure(getattr(tree, f))}" for f in tree._fields)
            + ")")
    if isinstance(tree, tuple):
        return "(" + ", ".join(_structure(t) for t in tree) + ("," if len(
            tree) == 1 else "") + ")"
    if isinstance(tree, list):
        return "[" + ", ".join(_structure(t) for t in tree) + "]"
    return "*"


def _unflatten(tree, leaves):
    """`tree`'s structure with its leaves taken in order from `leaves`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves)
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(t, leaves) for t in tree)
    return leaves.pop(0)


def _to_numpy(leaf):
    """(stored array, manifest dtype string) of one leaf."""
    if isinstance(leaf, bool) or not isinstance(
            leaf, (int, torch.Tensor, np.ndarray, np.generic)):
        raise TypeError(f"cannot checkpoint a leaf of type {type(leaf)}")
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32), "int32"
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _leaf_dtype(leaf) -> str:
    """The manifest dtype string a template leaf restores as."""
    if isinstance(leaf, int):
        return "int32"
    if isinstance(leaf, torch.Tensor):
        return ("bfloat16" if leaf.dtype == torch.bfloat16
                else str(torch.empty(0, dtype=leaf.dtype).numpy().dtype))
    return str(np.asarray(leaf).dtype)


def _fsync_dir_tree(path: str) -> None:
    """fsync every file under `path`, then the directory itself, so the
    rename that follows publishes durable contents."""
    for name in os.listdir(path):
        fd = os.open(os.path.join(path, name), os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_checkpoint(ckpt_dir: str, step: int, tree, overwrite: bool = True,
                    keep_last: int | None = None, retries: int = 3,
                    retry_delay: float = 0.05) -> str:
    """Atomically save `tree` as `<ckpt_dir>/step_<N>` (stage, fsync,
    rename, fsync the parent).

    Transient ``OSError``s are retried up to `retries` attempts in all
    with jittered exponential backoff; each attempt restages from
    scratch. `FileExistsError` under ``overwrite=False`` is a caller
    error and is never retried. With `keep_last`, all but the newest
    `keep_last` committed step dirs are pruned after the save lands (never
    the one just written; `.tmp` leftovers are not checkpoints and are
    swept only with their pruned step)."""
    if retries < 1:
        raise ValueError(f"retries must be >= 1, got {retries}")
    for attempt in range(retries):
        try:
            path = _write_checkpoint(ckpt_dir, step, tree, overwrite)
            break
        except FileExistsError:
            raise
        except OSError:
            if attempt == retries - 1:
                raise
            delay = retry_delay * (2 ** attempt)
            time.sleep(delay * (1.0 + random.random()))
    if keep_last is not None:
        _prune_checkpoints(ckpt_dir, keep_last, just_wrote=step)
    return path


def _write_checkpoint(ckpt_dir: str, step: int, tree,
                      overwrite: bool = True) -> str:
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = path + ".tmp"
    os.makedirs(ckpt_dir, exist_ok=True)
    if os.path.isdir(tmp):            # leftover from a crashed save
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(tree)
    arrays = {}
    manifest = {"treedef": TREEDEF_PREFIX + _structure(tree),
                "num_leaves": len(flat), "step": step, "leaves": []}
    for i, (leaf_path, leaf) in enumerate(flat):
        arr, dtype_str = _to_numpy(leaf)
        arrays[f"leaf_{i}"] = arr
        manifest["leaves"].append({
            "index": i, "path": leaf_path, "shape": list(arr.shape),
            "dtype": dtype_str, "spec": ""})
    np.savez_compressed(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    # durability before visibility: fsync the staged files, swap the
    # directory into place, then fsync the parent so the rename survives
    _fsync_dir_tree(tmp)
    if os.path.isdir(path):
        if not overwrite:
            raise FileExistsError(f"checkpoint exists: {path}")
        shutil.rmtree(path)
    os.replace(tmp, path)
    fd = os.open(ckpt_dir, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    return path


def _prune_checkpoints(ckpt_dir: str, keep_last: int, just_wrote: int):
    """Remove all but the newest `keep_last` committed `step_*` dirs; the
    dir just written is never pruned, and a `.tmp` leftover is swept only
    with its pruned step."""
    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    steps = sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                   if (m := re.fullmatch(r"step_(\d+)", d)))
    for s in steps[:-keep_last] if keep_last < len(steps) else []:
        if s == just_wrote:
            continue
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
        tmp = os.path.join(ckpt_dir, f"step_{s:08d}.tmp")
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    """The newest committed step under `ckpt_dir`, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def _step_path(ckpt_dir: str, step: int | None) -> str:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def read_manifest(ckpt_dir: str, step: int | None) -> dict:
    """The manifest of one checkpoint (the latest with `step=None`)."""
    with open(os.path.join(_step_path(ckpt_dir, step),
                           "manifest.json")) as f:
        return json.load(f)


def _restored(arr: np.ndarray, dtype_str: str, tmpl):
    """One stored array as the template leaf's type, on its device."""
    if isinstance(tmpl, int):
        return int(arr)
    arr = np.array(arr)               # a writable copy of the stored array
    if dtype_str == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    elif isinstance(tmpl, torch.Tensor):
        t = torch.from_numpy(arr)
    else:
        return arr
    return t.to(tmpl.device)


def restore_checkpoint(ckpt_dir: str, step: int | None, like):
    """Restore into the structure of `like` (a template tree).

    The template must match the saved state: the same number of leaves
    and, per leaf, the same path, shape and dtype; a checkpoint the port
    wrote must also have the template's structure rendering. Errors name
    the first mismatching leaf path."""
    path = _step_path(ckpt_dir, step)
    manifest = read_manifest(ckpt_dir, step)
    data = np.load(os.path.join(path, "arrays.npz"))
    flat = _flatten(like)
    if len(flat) != manifest["num_leaves"]:
        raise ValueError(
            f"checkpoint has {manifest['num_leaves']} leaves, template has "
            f"{len(flat)}")
    saved_def = manifest["treedef"]
    if saved_def.startswith(TREEDEF_PREFIX) and \
            saved_def != TREEDEF_PREFIX + _structure(like):
        raise ValueError(
            "checkpoint treedef does not match the template structure:\n"
            f"  saved:    {saved_def}\n"
            f"  template: {TREEDEF_PREFIX + _structure(like)}")
    out = []
    for i, (leaf_path, tmpl) in enumerate(flat):
        rec = manifest["leaves"][i]
        if rec["path"] != leaf_path:
            raise ValueError(
                f"checkpoint treedef does not match the template: leaf {i} "
                f"is {rec['path']} in the checkpoint, {leaf_path} in the "
                "template")
        arr = data[f"leaf_{i}"]
        shape = tuple(np.shape(tmpl)) if not isinstance(tmpl, int) else ()
        if tuple(arr.shape) != shape:
            raise ValueError(
                f"leaf {leaf_path}: checkpoint shape {tuple(arr.shape)} != "
                f"template shape {shape}")
        want = _leaf_dtype(tmpl)
        if rec["dtype"] != want:
            raise ValueError(
                f"leaf {leaf_path}: checkpoint dtype {rec['dtype']} != "
                f"template dtype {want} — restore into the state layout "
                "the checkpoint was saved from")
        out.append(_restored(arr, rec["dtype"], tmpl))
    return _unflatten(like, out)
