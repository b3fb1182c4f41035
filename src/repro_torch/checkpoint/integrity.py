"""Weight-store integrity: golden manifests and the canary probe — port of
the reference's ``checkpoint/integrity.py``.

The whole packed weight image stays resident for the life of the service,
so a flipped bit in a container serves wrong weights until something
notices:

  * **Golden manifest** — a CRC32 per protected leaf (``qp`` container
    words, ``q`` levels, ``delta`` scales; every leaf of a float master),
    over the leaf's bytes in its logical C order, computed once at load
    (:func:`build_manifest`) and persisted with a golden copy of the leaves
    (:func:`save_golden`) so a corrupt leaf can be reloaded alone.
  * **Canary probe** — :func:`make_probe`: each protected leaf, its bits
    read as unsigned words (a float through an integer view), is dotted
    with odd multipliers ``r_j = (j * 2654435761 mod 2**32) | 1`` modulo
    ``2**32``. A flip of bit b in word j moves the sum by ``r_j * 2**b``,
    never 0 mod 2**32 since ``r_j`` is odd, so any single-bit corruption is
    detected and localized to its leaf. The fingerprints equal the
    reference's for the same tree.

torch has no full uint32 arithmetic and a product of two 32-bit values
overflows int64, so the probe splits ``r`` into 16-bit halves in int64:
``w * r = w * r_lo + ((w * r_hi) mod 2**16) * 2**16  (mod 2**32)``, each
term below 2**48, every partial sum masked to 32 bits. It works a leaf at a
time in chunks of ``_CHUNK`` words, so its temporaries stay bounded, and it
is plain torch ops: the engine captures it as a CUDA graph of its own.
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.core.treeutil import flatten_with_path, tree_get

__all__ = ["protected_paths", "build_manifest", "verify_manifest",
           "save_manifest", "load_manifest", "make_probe", "fingerprints",
           "save_golden", "load_golden", "flip_bit_"]

# the weight-store leaves a serve-form tree protects: packed container
# words, quantized levels, and their per-channel scales
_SERVE_LEAVES = ("qp", "q", "delta")
_MULT = 2654435761                    # Knuth's multiplicative hash constant
_U32 = 0xFFFFFFFF
_CHUNK = 1 << 22                      # words a probe step reads at most
_INT_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}


def _basename(path: str) -> str:
    return path.rsplit("/", 1)[-1]


def protected_paths(tree: Any) -> List[str]:
    """Tree paths the integrity machinery covers: the ``qp`` / ``q`` /
    ``delta`` leaves of a serve form, else every tensor leaf (a float
    master's whole store is the resident image)."""
    flat = flatten_with_path(tree)
    serve = [p for p in flat if _basename(p) in _SERVE_LEAVES]
    if serve:
        return sorted(serve)
    return sorted(p for p, v in flat.items() if isinstance(v, torch.Tensor))


def _host_bytes(leaf: torch.Tensor) -> bytes:
    """The leaf's bytes in its logical C order (a K-major view is read as
    the (K, N) array it stands for)."""
    return checkpoint._to_numpy(leaf).tobytes()


def _crc(leaf: torch.Tensor) -> int:
    return zlib.crc32(_host_bytes(leaf)) & _U32


def build_manifest(tree: Any,
                   paths: Optional[List[str]] = None) -> Dict[str, Dict]:
    """{path: {crc32, shape, dtype}} over the protected leaves."""
    paths = protected_paths(tree) if paths is None else paths
    out: Dict[str, Dict] = {}
    for p in paths:
        leaf = tree_get(tree, p)
        out[p] = {"crc32": _crc(leaf), "shape": list(leaf.shape),
                  "dtype": checkpoint.dtype_name(leaf)}
    return out


def verify_manifest(tree: Any, manifest: Dict[str, Dict]) -> List[str]:
    """Paths whose current bytes disagree with the manifest (crc, shape or
    dtype); empty means the store matches its golden state. The exact host
    oracle the probe is tested against, and the post-heal check."""
    bad: List[str] = []
    for p, rec in manifest.items():
        leaf = tree_get(tree, p)
        if (list(leaf.shape) != rec["shape"]
                or checkpoint.dtype_name(leaf) != rec["dtype"]
                or _crc(leaf) != rec["crc32"]):
            bad.append(p)
    return sorted(bad)


def save_manifest(path: str, manifest: Dict[str, Dict]):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def load_manifest(path: str) -> Dict[str, Dict]:
    with open(path) as f:
        return json.load(f)


# --- the canary probe ---------------------------------------------------------

def _words(chunk: torch.Tensor) -> torch.Tensor:
    """The reference's uint32 words of a flat chunk, in int64: a float's
    bits through the integer view of its size, zero-extended; an integer
    sign-extended to 32 bits (``astype(uint32)``)."""
    if chunk.is_floating_point():
        size = chunk.element_size()
        return chunk.view(_INT_OF_SIZE[size]).to(torch.int64) \
            & ((1 << (8 * size)) - 1)
    return chunk.to(torch.int64) & _U32


def _fingerprint_one(x: torch.Tensor) -> torch.Tensor:
    """sum_j words_j * r_j mod 2**32 over the leaf in logical C order, as a
    0-dim int64 tensor, chunk by chunk along the leading dim."""
    x = x.reshape(1, -1) if x.dim() < 2 else x
    row = x[0].numel()
    step = max(1, _CHUNK // max(row, 1))
    acc = torch.zeros((), dtype=torch.int64, device=x.device)
    for i0 in range(0, x.shape[0], step):
        v = _words(x[i0:i0 + step].reshape(-1))
        j = torch.arange(i0 * row, i0 * row + v.numel(), dtype=torch.int64,
                         device=x.device)
        r = ((j * _MULT) & _U32) | 1
        t = (v * (r & 0xFFFF) + (((v * (r >> 16)) & 0xFFFF) << 16)) & _U32
        acc = (acc + t.sum()) & _U32
    return acc


def make_probe(tree: Any, paths: Optional[List[str]] = None
               ) -> Tuple[List[str], Callable[[Any], torch.Tensor]]:
    """(paths, probe_fn): ``probe_fn(tree) -> (len(paths),)`` int64
    fingerprints, each in [0, 2**32). One per protected leaf, so a
    mismatch against the golden vector names the corrupt leaf. Plain torch
    ops with no host sync: it can be captured as a graph."""
    paths = protected_paths(tree) if paths is None else paths

    def probe(t):
        return torch.stack([_fingerprint_one(tree_get(t, p)) for p in paths])

    return paths, probe


def fingerprints(tree: Any, paths: Optional[List[str]] = None) -> np.ndarray:
    """One-shot host fingerprints, uint32 as the reference returns them."""
    paths, probe = make_probe(tree, paths)
    with torch.no_grad():
        return probe(tree).cpu().numpy().astype(np.uint32)


@torch.no_grad()
def flip_bit_(tree: Any, path: str, bit: int) -> None:
    """XOR one bit of the leaf at ``path``, in place in its storage (a
    captured graph reading the leaf sees the flip). ``bit`` counts in the
    leaf's logical C order, little-endian within an element — the
    reference's byte view of ``np.asarray(leaf)`` — and wraps modulo the
    leaf's bit count."""
    leaf = tree_get(tree, path)
    size = leaf.element_size()
    b = int(bit) % (leaf.numel() * size * 8)
    elem, within = divmod(b // 8, size)
    pos = within * 8 + b % 8
    idx = tuple(int(i) for i in np.unravel_index(elem, tuple(leaf.shape)))
    ints = leaf.view(_INT_OF_SIZE[size])
    ints[idx] ^= (1 << pos) if pos < 8 * size - 1 else -(1 << pos)


# --- golden store -------------------------------------------------------------

def save_golden(golden_dir: str, tree: Any,
                paths: Optional[List[str]] = None) -> Dict[str, Dict]:
    """Persist the golden copy of the protected leaves and their manifest
    under ``golden_dir`` (atomic, through the checkpoint store). Returns the
    manifest: what the self-heal reloads from."""
    paths = protected_paths(tree) if paths is None else paths
    flat = {p: tree_get(tree, p) for p in paths}
    manifest = build_manifest(tree, paths)
    checkpoint.save(golden_dir, 0, flat, meta={"kind": "golden"})
    save_manifest(os.path.join(golden_dir, "manifest.json"), manifest)
    return manifest


def load_golden(golden_dir: str
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Dict]]:
    """(flat {path: host tensor}, manifest) back from :func:`save_golden`."""
    tree, _ = checkpoint.restore(golden_dir, 0)
    manifest = load_manifest(os.path.join(golden_dir, "manifest.json"))
    return flatten_with_path(tree), manifest
