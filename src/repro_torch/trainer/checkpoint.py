"""Checkpointing: atomic, async, keep-N, restart.

Port of ``repro.trainer.checkpoint`` with the reference's on-disk format,
so that a checkpoint written by either package restores in the other: one
``.npz`` per step, its keys the ``/``-joined dict keys of the state tree,
every list of per-layer dicts stacked along a leading layer axis as the
reference stacks its layers (``transformer.params_to_numpy``), bf16 leaves
as raw 2-byte ``|V2`` values (what ``np.asarray`` of a JAX bf16 array
stores). Writes go to a temp file then ``os.replace`` (atomic on POSIX),
so a crash mid-write never corrupts the latest checkpoint.
``async_write=True`` hands serialisation to a background thread, at most
one in flight; the copy to the host happens in ``save`` itself.
"""
from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.transformer import leaf_from_numpy, params_to_numpy


def _flatten(tree) -> Dict[str, np.ndarray]:
    flat = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        else:
            flat[prefix] = t

    walk(params_to_numpy(tree), "")
    return flat


def _unflatten(template, flat: Dict[str, np.ndarray]):
    """``template``'s structure with each leaf read from ``flat``: a leaf
    inside a list of per-layer dicts is row ``i`` of the stacked array,
    cast to the template leaf's dtype on its device."""
    def walk(t, prefix, index):
        if isinstance(t, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else str(k), index)
                    for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, prefix, index + (i,)) for i, v in enumerate(t)]
        arr = flat[prefix][index] if index else flat[prefix]
        if isinstance(t, torch.Tensor):
            return leaf_from_numpy(arr, t)
        return arr

    return walk(template, "", ())


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- paths ---------------------------------------------------------------

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    def steps(self) -> List[int]:
        out = []
        for f in os.listdir(self.dir):
            m = re.fullmatch(r"ckpt_(\d+)\.npz", f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # -- save/restore ----------------------------------------------------------

    def _write(self, step: int, flat: Dict[str, np.ndarray]) -> None:
        tmp = self._path(step) + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, self._path(step))       # atomic
        self._gc()

    def save(self, step: int, state: Any, async_write: bool = False) -> None:
        flat = _flatten(state)                  # host transfer happens here
        self.wait()                             # one in-flight write max
        if async_write:
            self._thread = threading.Thread(target=self._write,
                                            args=(step, flat), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """The checkpoint at ``step`` (default the latest) in
        ``template``'s structure, dtypes and devices."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        with np.load(self._path(step)) as z:
            flat = {k: z[k] for k in z.files}
        return _unflatten(template, flat)

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            try:
                os.remove(self._path(s))
            except OSError:
                pass
