"""Mid-training checkpoint/resume for iterative trainers.

Counterpart of ``predictionio_tpu/core/checkpoint.py``. The reference
persists models only after training completes (SURVEY.md §5.4); a
trainer here (two-tower) can write an atomic checkpoint every ``every``
epochs and resume exactly — tables, optimizer state, epoch counter and
the epoch-order generator included — so an interrupted-and-resumed run
produces the same parameters as an uninterrupted one.

Safety properties owned here, not by the trainers:
  - a ``fingerprint`` of (config, data dims, data sample) travels with
    every checkpoint; restore ignores checkpoints whose fingerprint
    differs, so a later run on new data or a changed config starts
    fresh (with a warning) instead of adopting stale parameters or
    wrong-shape tables. The port's trainers add the part
    ``"predictionio_torch"`` to their fingerprint, so a directory the
    JAX trainer wrote is skipped as a different run and never misread.
    A checkpoint is read with an unpickler that resolves only the
    stdlib's containers and numpy: the classes of another package's state
    (optax's, say) load as inert placeholders, so reading such a file
    to compare its fingerprint imports nothing of that package.
  - atomicity: write to ``.tmp`` then ``os.replace``; a crash mid-write
    never corrupts the latest good checkpoint; a torn newest file falls
    back to the previous one. The two most recent checkpoints are kept.
  - one process: a ``torch.distributed`` world larger than 1 raises
    (multi-process training waits for ROADMAP.md queue 1 item 12).

Format: one pickle per checkpoint, ``{"epoch", "state", "fingerprint"}``
as in the JAX package; tensors in ``state`` are stored as numpy arrays
(copied to the host first, whatever device they were on), and the
trainer places them on its device on restore.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import re
from typing import Any, Optional, Tuple

import numpy as np
import torch

from predictionio_torch.parallel import multihost

log = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.pkl$")


def _as_array(part: Any) -> Any:
    """A torch tensor as its numpy array (by value, on the host); any
    other part unchanged."""
    if isinstance(part, torch.Tensor):
        return part.detach().cpu().numpy()
    return part


def train_fingerprint(*parts: Any) -> str:
    """Stable digest of a training run's identity: pass the config
    dataclass, dimension ints, and cheap data samples. numpy arrays and
    torch tensors are hashed by dtype, shape and content, anything else
    by ``repr``: the same digest as the JAX package's function for the
    same parts."""
    h = hashlib.md5()
    for part in parts:
        part = _as_array(part)
        if isinstance(part, np.ndarray):
            h.update(str(part.dtype).encode())
            h.update(str(part.shape).encode())
            h.update(np.ascontiguousarray(part).tobytes())
        else:
            h.update(repr(part).encode())
        h.update(b"|")
    return h.hexdigest()


def _to_host(tree: Any) -> Any:
    """Every tensor in a nest of dicts, lists and tuples -> numpy on the
    host; other leaves pass through."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return _as_array(tree)


class _Foreign:
    """Stands in for a class the checkpoint reader does not resolve:
    takes whatever pickle hands it and keeps it, inert."""

    def __new__(cls, *args, **kwargs):
        return super().__new__(cls)

    def __init__(self, *args, **kwargs):
        self.args = args

    def __setstate__(self, state):
        self.state = state


_SAFE_MODULES = ("builtins", "copyreg", "collections", "_codecs", "numpy")


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        root = module.split(".", 1)[0]
        if root in _SAFE_MODULES:
            return super().find_class(module, name)
        return type(name, (_Foreign,), {"__module__": module})


def _check_one_process() -> None:
    if multihost.process_count() > 1:
        raise NotImplementedError(
            "checkpointing a torch.distributed run: multi-process "
            "training is not ported to predictionio_torch yet "
            "(ROADMAP.md, queue 1 item 12)")


class TrainCheckpointer:
    """Epoch-granular checkpoint writer/reader over one directory."""

    def __init__(self, directory: str, every: int = 1, keep: int = 2,
                 fingerprint: Optional[str] = None):
        self.directory = directory
        self.every = max(1, int(every))
        self.keep = max(1, int(keep))
        self.fingerprint = fingerprint
        os.makedirs(directory, exist_ok=True)

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"ckpt_{epoch}.pkl")

    def _epochs_on_disk(self):
        out = []
        for name in os.listdir(self.directory):
            m = _CKPT_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def maybe_save(self, epoch: int, state: Any) -> bool:
        """Save after ``epoch`` completed epochs when due; returns
        whether a checkpoint was written. ``state`` is a nest of dicts,
        lists and tuples whose tensors (on any device) are copied to the
        host as numpy arrays."""
        if epoch % self.every:
            return False
        _check_one_process()
        path = self._path(epoch)
        with open(path + ".tmp", "wb") as f:
            pickle.dump({"epoch": epoch, "state": _to_host(state),
                         "fingerprint": self.fingerprint}, f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(path + ".tmp", path)
        for old in self._epochs_on_disk()[: -self.keep]:
            try:
                os.remove(self._path(old))
            except FileNotFoundError:
                pass
        log.info("checkpoint written: %s", path)
        return True

    def restore(self) -> Optional[Tuple[int, Any]]:
        """(completed_epochs, state) from the newest readable checkpoint
        whose fingerprint matches this run, or None. A torn newest file
        falls back to the previous one; a fingerprint mismatch (another
        run's data or config, or the JAX trainer's file) is skipped with
        a warning and the run starts fresh."""
        _check_one_process()
        for epoch in reversed(self._epochs_on_disk()):
            try:
                with open(self._path(epoch), "rb") as f:
                    doc = _CheckpointUnpickler(f).load()
            except Exception:  # noqa: BLE001 — fall back to older
                log.warning("unreadable checkpoint %s; trying older",
                            self._path(epoch))
                continue
            if not isinstance(doc, dict) or (
                    doc.get("fingerprint") != self.fingerprint):
                log.warning(
                    "checkpoint %s belongs to a different run "
                    "(config/data changed) — starting fresh",
                    self._path(epoch))
                return None
            return int(doc["epoch"]), doc["state"]
        return None
