"""Checkpointing — port of the reference's ``checkpoint/__init__.py``:
flat-npz tree snapshots with step management, keep-k GC and async
(background-thread) saves, in the reference's on-disk format, so each
package reads what the other wrote, bit for bit.

Format: ``<dir>/step_<12 digits>/arrays.npz`` + ``meta.json``, whose
``_dtypes`` records every leaf's true dtype. Writes go to a ``.tmp`` dir
that is renamed into place, so a killed job never leaves a half-written
step (``all_steps`` sees only complete ones).

bfloat16 without ``ml_dtypes``: numpy has no bf16, so a bf16 leaf is
stored as its raw 2-byte words (``|V2``, as ``np.savez`` writes the
reference's ``ml_dtypes`` arrays) with ``"bfloat16"`` in ``_dtypes``, and
read back through a ``uint16`` view into ``torch.bfloat16``.

``restore(..., device=)`` puts leaves on one device; ``shardings=`` (the
reference's elastic restore) places every leaf it names as a DTensor on
its ``(mesh, placements)``, whatever mesh wrote the file: a DTensor leaf is
saved as its whole value, so files are the same bit for bit whatever the
layout that wrote them.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.treeutil import flatten_with_path, tree_get, unflatten

__all__ = ["save", "restore", "latest_step", "all_steps", "Checkpointer",
           "dtype_name"]


def dtype_name(t) -> str:
    """The numpy name of a tensor's or array's dtype (``"bfloat16"``,
    ``"int8"``, ...), as the reference's ``str(np.dtype)`` spells it."""
    if isinstance(t, torch.Tensor):
        return str(t.dtype).removeprefix("torch.")
    return str(np.asarray(t).dtype)


def _to_numpy(v) -> np.ndarray:
    """A host copy of one leaf in its logical C order; bf16 as ``|V2``."""
    if isinstance(v, torch.Tensor):
        from torch.distributed.tensor import DTensor
        if isinstance(v, DTensor):         # its whole value (a gather)
            v = v.full_tensor()
        t = v.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
            return t.numpy().view(np.uint16).view("V2").copy()
        return t.numpy().copy()
    return np.array(v)


def _to_torch(a: np.ndarray, want: str, device) -> torch.Tensor:
    if want == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    if str(a.dtype) != want:
        a = a.view(np.dtype(want))
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _np_flat(tree: Any) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in flatten_with_path(tree).items()}


def _dtypes(tree: Any) -> Dict[str, str]:
    return {k: dtype_name(v) for k, v in flatten_with_path(tree).items()}


def _write(ckpt_dir: str, step: int, flat: Dict[str, np.ndarray],
           dtypes: Dict[str, str], meta: Optional[Dict], keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:012d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "_dtypes": dtypes, **(meta or {})}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, tree: Any, *, meta: Optional[Dict] = None,
         keep: int = 3) -> str:
    """Synchronous atomic save of a tree of tensors or arrays (one host
    copy per leaf). Returns the checkpoint path."""
    return _write(ckpt_dir, step, _np_flat(tree), _dtypes(tree), meta, keep)


def _gc(ckpt_dir: str, keep: int):
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:012d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp") \
                and os.path.exists(os.path.join(ckpt_dir, name, "meta.json")):
            out.append(int(name[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: Optional[int] = None, *,
            device="cpu", shardings: Any = None) -> tuple:
    """Load (tree of torch tensors, meta); every leaf comes back with the
    dtype ``_dtypes`` records, bf16 included. ``shardings``: a tree (a
    prefix of the checkpoint's) of ``(mesh, placements)``; each leaf it
    names is placed there as a DTensor (``distribute_tensor`` on the
    mesh's device type: the elastic restore onto any mesh), every other
    leaf goes to ``device``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:012d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    dtypes = meta.pop("_dtypes", {})
    out = {}
    for k, a in flat.items():
        want = dtypes.get(k, str(a.dtype))
        try:
            sh = None if shardings is None else tree_get(shardings, k)
        except KeyError:                 # a leaf the shardings do not name
            sh = None
        if sh is None:
            out[k] = _to_torch(a, want, device)
            continue
        from torch.distributed.tensor import distribute_tensor
        mesh, placements = sh
        # every rank reads the whole file: each keeps its own chunk
        out[k] = distribute_tensor(_to_torch(a, want, mesh.device_type),
                                   mesh, placements, src_data_rank=None)
    return unflatten(out), meta


class Checkpointer:
    """Async checkpointer: ``save_async`` copies the tree to the host now
    and returns; a background thread writes it (one in flight at a time —
    the next save waits for the last)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, tree: Any, meta: Optional[Dict] = None):
        self.wait()
        flat, dtypes = _np_flat(tree), _dtypes(tree)     # snapshot now

        def work():
            try:
                _write(self.ckpt_dir, step, flat, dtypes, meta, self.keep)
            except BaseException as e:   # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
