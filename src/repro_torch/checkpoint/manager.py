"""Async, atomic checkpointing — port of ``repro/checkpoint/manager.py``,
with the same on-disk format.

Layout per step::

    <dir>/step-000042/
        arrays.npz          flattened "/"-joined key paths -> np arrays
        manifest.json       step, array index (shape/dtype + crc), extra
    <dir>/LATEST            text file naming the newest durable step

  * durability   — writes go to ``step-N.tmp`` then atomically rename; a
                   crash mid-write can never corrupt the latest durable
                   checkpoint, and LATEST is updated only after rename.
  * async        — ``save()`` snapshots to host memory synchronously and
                   does serialization/IO on a background thread.
  * placement    — arrays are stored whole: ``save`` of a placed leaf
                   (a ``sharding.SlotArray``) writes the gathered global
                   array, so a checkpoint does not depend on a layout.
                   ``restore(..., device=...)`` puts the arrays on a
                   device; ``restore(..., shardings=...)`` — the elastic
                   restart — lays each onto the current slot mesh (a
                   ``NamedSharding`` tree matching the template, or one
                   for every leaf), so a 2 × 4 save restores onto 4 × 2 or
                   one device.  An index loads onto a mesh through
                   ``KNNIndex.load(mesh=...)``.
  * validation   — restore checks shapes/dtypes/crc against the manifest
                   and refuses partial checkpoints.

Leaves may be numpy arrays, scalars or torch tensors.  numpy has no
bfloat16 or float8 of its own, so those are stored as their raw byte view
(``uint8``) under the manifest's true dtype name, exactly as the JAX
package stores them, and restored as torch tensors of that dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import warnings
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.sharding import NamedSharding, SlotArray
from repro_torch.utils import tree_map

_SEP = "/"
FORMAT_VERSION = 1

# Dtype names of the manifest that numpy cannot hold without an extension
# package: stored as a raw byte view, restored through torch.
_TORCH_ONLY = {
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}
_TORCH_ONLY_NAME = {v: k for k, v in _TORCH_ONLY.items()}


class _Leaf:
    """One flattened array: the bytes ``np.savez`` stores and the true
    dtype and shape the manifest names."""

    def __init__(self, stored: np.ndarray, dtype: str, shape):
        self.stored, self.dtype, self.shape = stored, dtype, list(shape)

    def crc(self) -> int:
        return zlib.crc32(np.ascontiguousarray(self.stored).tobytes())


def _leaf(x) -> _Leaf:
    """A snapshot of one leaf: a copy, also of a tensor already on the CPU
    (``.cpu()`` would return the tensor itself, and an async write would
    then race the next step's in-place update)."""
    if isinstance(x, SlotArray):
        x = x.gather()
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True).contiguous()
        name = _TORCH_ONLY_NAME.get(t.dtype)
        if name is not None:
            return _Leaf(t.view(torch.uint8).numpy(), name, t.shape)
        v = t.numpy()
    else:
        v = np.array(x)
    return _Leaf(v, str(v.dtype), v.shape)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, _Leaf]:
    out: Dict[str, _Leaf] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{_SEP}"))
    elif tree is not None:
        out[prefix.rstrip(_SEP)] = _leaf(tree)
    return out


def _decode(raw: np.ndarray, dtype: str, shape):
    """The restored leaf (numpy, or torch for the dtypes numpy lacks) and
    the bytes its crc is taken over."""
    if dtype in _TORCH_ONLY:
        data = np.ascontiguousarray(raw).tobytes()
        if not data:
            return torch.empty(shape, dtype=_TORCH_ONLY[dtype]), data
        t = torch.frombuffer(bytearray(data), dtype=_TORCH_ONLY[dtype]).reshape(shape)
        return t, data
    want = np.dtype(dtype)
    v = raw if raw.dtype == want else np.frombuffer(raw.tobytes(), dtype=want).reshape(shape)
    return v, np.ascontiguousarray(v).tobytes()


def _unflatten_into(template: Any, flat: Dict[str, Any], prefix: str = "") -> Any:
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}{_SEP}")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        seq = [_unflatten_into(v, flat, f"{prefix}{i}{_SEP}")
               for i, v in enumerate(template)]
        return type(template)(seq)
    if template is None:
        return None
    return flat[prefix.rstrip(_SEP)]


def _to_device(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    if tree is None:
        return None
    return torch.as_tensor(tree, device=device)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1) if async_save else None
        self._pending: Optional[Future] = None
        self._lock = threading.Lock()

    # -- save --------------------------------------------------------------

    def save(self, step: int, tree: Any, *, extra: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot now, write in background (if async)."""
        flat = _flatten(tree)           # device->host happens here, sync
        if self._pool is None:
            self._write(step, flat, extra or {})
            return
        self.wait()                      # one in-flight write at a time
        self._pending = self._pool.submit(self._write, step, flat, extra or {})

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _phase(self, name: str, step: int) -> None:
        """Called at each phase of ``_write``: ``"pre-arrays"`` before the
        tmp directory is written, ``"pre-manifest"`` after ``arrays.npz``,
        ``"pre-latest"`` after the rename and before ``LATEST`` moves — the
        three partial states a crash can leave.  A no-op here;
        ``runtime.faults.CrashingCheckpointManager`` crashes there."""

    def _write(self, step: int, flat: Dict[str, _Leaf], extra: Dict[str, Any]) -> None:
        self._phase("pre-arrays", step)
        final = os.path.join(self.directory, f"step-{step:09d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **{k: v.stored for k, v in flat.items()})
        self._phase("pre-manifest", step)
        index = {k: {"shape": v.shape, "dtype": v.dtype, "crc": v.crc()}
                 for k, v in flat.items()}
        manifest = {"version": FORMAT_VERSION, "step": step, "index": index, "extra": extra}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._phase("pre-latest", step)
        with self._lock:
            with open(os.path.join(self.directory, "LATEST.tmp"), "w") as f:
                f.write(os.path.basename(final))
            os.replace(os.path.join(self.directory, "LATEST.tmp"),
                       os.path.join(self.directory, "LATEST"))
        self._gc()

    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.directory)
                       if d.startswith("step-") and not d.endswith(".tmp"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, d))

    # -- restore -----------------------------------------------------------

    def _is_durable(self, name: str) -> bool:
        """A step directory is durable iff the atomic rename completed:
        both payload files exist under the final (non-.tmp) name."""
        d = os.path.join(self.directory, name)
        return (os.path.isdir(d)
                and os.path.exists(os.path.join(d, "manifest.json"))
                and os.path.exists(os.path.join(d, "arrays.npz")))

    def durable_steps(self) -> list:
        """All durable step numbers, ascending."""
        out = []
        for d in sorted(os.listdir(self.directory)):
            if d.startswith("step-") and not d.endswith(".tmp") and self._is_durable(d):
                try:
                    out.append(int(d.split("-")[1]))
                except ValueError:
                    continue
        return out

    def latest_step(self) -> Optional[int]:
        """Newest durable step.  The LATEST pointer is a hint, not an
        authority: when it names a missing or partial directory (a crash
        between the step rename and the pointer update, or a corrupt
        pointer), fall back to the newest step with both payload files."""
        path = os.path.join(self.directory, "LATEST")
        name = None
        if os.path.exists(path):
            with open(path) as f:
                name = f.read().strip()
        if name is not None and self._is_durable(name):
            try:
                return int(name.split("-")[1])
            except (IndexError, ValueError):
                pass  # malformed pointer content — fall through to scan
        durable = self.durable_steps()
        if durable:
            if name is not None:
                warnings.warn(
                    f"LATEST points at {name!r} which is missing or "
                    f"partial in {self.directory}; falling back to newest "
                    f"durable step {durable[-1]}", RuntimeWarning, stacklevel=2)
            return durable[-1]
        return None

    def restore(self, template: Any, *, step: Optional[int] = None, shardings: Any = None,
                device=None):
        """Load into ``template``'s structure.  Leaves come back as numpy
        arrays (torch tensors for bfloat16/float8), as torch tensors on
        ``device`` when one is given, or placed on a slot mesh as
        ``SlotArray``s when ``shardings`` is given (a tree of
        ``NamedSharding`` matching the template, or a single one for every
        leaf) — the elastic restart.  Returns (tree, extra, step)."""
        if shardings is not None and device is not None:
            raise ValueError("restore takes shardings= or device=, not both")
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no durable checkpoint in {self.directory} "
                    f"(nothing was ever saved, or every save crashed "
                    f"before the atomic rename)")
        name = f"step-{step:09d}"
        if not self._is_durable(name):
            durable = self.durable_steps()
            hint = (f"; durable steps available: {durable}" if durable
                    else "; no durable steps exist in this directory")
            raise FileNotFoundError(
                f"checkpoint step {step} in {self.directory} is missing "
                f"or partial (a crash mid-write leaves no durable "
                f"step-{step:09d} directory){hint}. Pass step=None to "
                f"restore the newest durable step.")
        d = os.path.join(self.directory, name)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as npz:
            raw = dict(npz)
        flat = {}
        for k, meta in manifest["index"].items():
            v, data = _decode(raw[k], meta["dtype"], meta["shape"])
            dtype = _TORCH_ONLY_NAME.get(v.dtype) if isinstance(v, torch.Tensor) else str(v.dtype)
            if list(v.shape) != meta["shape"] or dtype != meta["dtype"]:
                raise ValueError(f"checkpoint corrupt: {k} mismatches manifest")
            if zlib.crc32(data) != meta["crc"]:
                raise ValueError(f"checkpoint corrupt: {k} crc mismatch")
            flat[k] = v
        tree = _unflatten_into(template, flat)
        if device is not None:
            tree = _to_device(tree, torch.device(device))
        elif isinstance(shardings, NamedSharding):
            tree = tree_map(shardings.place, tree)
        elif shardings is not None:
            tree = tree_map(lambda x, s: s.place(x), tree, shardings)
        return tree, manifest["extra"], step
