"""Fault-tolerant checkpointing: atomic, async, restartable.

The JAX package's ``checkpoint/checkpointer.py`` on the same on-disk layout,
so that either package's checkpoint restores in the port: one directory per
step, ``step_%010d``, holding ``shards.npz`` (one array per leaf, keys
``a0``, ``a1``, ... in leaf order) and ``manifest.json`` (step, each leaf's
name, key, shape and dtype, and the tree's structure).  Leaves are named and
ordered as JAX's ``tree_flatten_with_path`` names them: dict keys sorted,
list and tuple entries by index, joined by ``/``.  Writes go to
``<dir>.tmp`` and are renamed into place, so a crash mid-write never leaves
a half checkpoint behind the latest complete one; ``keep`` bounds how many
are kept.  ``save_async`` copies the tree to the host, then writes it on a
thread while training goes on.

bf16 leaves are written as the JAX package writes them (numpy saves an
``ml_dtypes`` bfloat16 array as raw 2-byte void records, descr ``<V2``; the
manifest says ``bfloat16``), so each ``.npy`` member of ``shards.npz`` holds
the bytes the JAX package would write, and they are restored by the
manifest's dtype: the bytes viewed as int16, then as ``torch.bfloat16``.  No
ml_dtypes is needed.  (The JAX
package's own ``restore`` cannot read such a leaf back: ROADMAP.md §3.)
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

Tree = Any


def _flatten_with_names(tree: Tree, prefix: str = "") -> list[tuple[str, Any]]:
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for name, sub in items:
        out += _flatten_with_names(sub, f"{prefix}/{name}" if prefix else name)
    return out


def _treedef(tree: Tree) -> str:
    """The tree's structure as JAX prints a ``PyTreeDef``'s body."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(x) for x in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_treedef(x) for x in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "*"


def _unflatten(like: Tree, leaves) -> Tree:
    """``like``'s structure filled from the iterator ``leaves`` (sorted-key
    order, as ``_flatten_with_names``); dicts keep ``like``'s key order."""
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves)


def _to_host(t) -> np.ndarray:
    """A leaf as the numpy array the JAX package would save: bf16 as raw
    2-byte records.  A DTensor is gathered whole first (a collective: every
    rank of its mesh saves)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    if _is_dtensor(t):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()  # the bits; saved as <V2
    return t.numpy()


def _host(tree: Tree) -> tuple[list, str]:
    """(name, host array, manifest dtype) of every leaf, and the structure."""
    leaves = []
    for name, t in _flatten_with_names(tree):
        arr = _to_host(t)
        bf16 = isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16
        leaves.append((name, arr, "bfloat16" if bf16 else str(arr.dtype)))
    return leaves, f"PyTreeDef({_treedef(tree)})"


def _savez(path: Path, leaves: list) -> None:
    """``np.savez`` of the leaves as keys ``a0``, ``a1``, ...; a bf16 leaf
    (its int16 bits) under the header numpy gives an ml_dtypes bfloat16
    array (descr ``<V2``)."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, (_, arr, dtype) in enumerate(leaves):
            with zf.open(f"a{i}.npy", "w", force_zip64=True) as f:
                if dtype == "bfloat16":
                    np.lib.format.write_array_header_1_0(
                        f, {"descr": "<V2", "fortran_order": False,
                            "shape": arr.shape})
                    f.write(np.ascontiguousarray(arr).tobytes())
                else:
                    np.lib.format.write_array(f, arr, allow_pickle=False)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.array(arr)  # an owned, writable copy (0-d stays 0-d)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _writes() -> bool:
    """Rank 0 of an initialized world writes (every rank gathers); a
    single process always writes."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _placement_leaves(tree) -> list:
    """The placement tuples of a tree that mirrors a checkpointed tree, in
    ``_flatten_with_names`` order (a tuple of ``Placement`` objects is a
    leaf, any other tuple a container)."""
    from torch.distributed.tensor import Placement

    if isinstance(tree, tuple) and all(isinstance(p, Placement)
                                       for p in tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _placement_leaves(tree[k])]
    return [x for t in tree for x in _placement_leaves(t)]


class Checkpointer:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Tree) -> Optional[Path]:
        self.wait()
        host = _host(tree)
        return self._write(step, *host) if _writes() else None

    def save_async(self, step: int, tree: Tree) -> None:
        self.wait()
        host = _host(tree)  # device -> host now
        if not _writes():
            return
        self._thread = threading.Thread(target=self._write,
                                        args=(step, *host), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, leaves: list, treedef: str) -> Path:
        final = self.dir / f"step_{step:010d}"
        tmp = Path(str(final) + ".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        _savez(tmp / "shards.npz", leaves)
        manifest = {"step": step, "leaves": [
            {"name": name, "key": f"a{i}", "shape": list(arr.shape),
             "dtype": dtype} for i, (name, arr, dtype) in enumerate(leaves)],
            "treedef": treedef}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)  # re-save of the same step
        os.replace(tmp, final)  # atomic publish
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and not p.name.endswith(".tmp"):
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Tree, step: Optional[int] = None,
                device=None, placements: Optional[Tree] = None,
                mesh=None) -> tuple[int, Tree]:
        """Restore into the structure of ``like`` (tensors): each leaf takes
        ``like``'s dtype and ``like``'s device, or ``device`` when given.
        With ``placements`` (a tree of DTensor placement tuples mirroring
        ``like``) and ``mesh`` each leaf is placed on ``mesh`` (the JAX
        ``shardings=``); a DTensor leaf of ``like`` takes its own mesh and
        placements.  Every rank reads the files.  Returns (step, tree)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        data = np.load(d / "shards.npz")
        by_name = {m["name"]: (m["key"], m["dtype"])
                   for m in manifest["leaves"]}
        named = _flatten_with_names(like)
        pls = [None] * len(named) if placements is None \
            else _placement_leaves(placements)
        if len(pls) != len(named):
            raise ValueError("placements do not mirror the restored tree")
        restored = []
        for (name, ref), pl in zip(named, pls):
            key, dtype = by_name[name]
            t = _from_host(data[key], dtype)
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"checkpoint leaf {name}: shape "
                                 f"{tuple(t.shape)}, expected "
                                 f"{tuple(ref.shape)}")
            restored.append(_place(t, ref, device, pl, mesh))
        return manifest["step"], _unflatten(like, iter(restored))


def _place(t: torch.Tensor, ref, device, pl, mesh) -> torch.Tensor:
    """A restored leaf in ``ref``'s dtype on its device, or as a DTensor on
    ``mesh`` by ``pl`` (or on ``ref``'s own mesh and placements)."""
    if pl is None and _is_dtensor(ref):
        pl, mesh = ref.placements, ref.device_mesh
    if pl is None:
        return t.to(device=ref.device if device is None else device,
                    dtype=ref.dtype)
    from torch.distributed.tensor import distribute_tensor

    if mesh is None:
        raise ValueError("restore: placements need a mesh")
    return distribute_tensor(t.to(device=mesh.device_type, dtype=ref.dtype),
                             mesh, pl)
