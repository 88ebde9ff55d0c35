"""Numbered checkpoints: async writes, retention, crash-restart discovery.

The contract of ``repro.checkpoint.manager``:

  * ``save(step, tree)`` copies the tree to host memory and returns; a
    writer thread puts it on disk (:func:`~repro_torch.checkpoint.ckpt.
    write` is atomic), overlapping the next chunk of work;
  * at most ``keep`` newest checkpoints are retained;
  * ``latest_step()`` scans the directory, so a restarted job resumes
    from the newest complete checkpoint, and ``restore`` walks past a
    damaged newest one.

A tree of DTensors is gathered by every rank of its mesh in ``save``
and written by the mesh's first rank; ``wait`` returns on no rank of
that mesh before the write is on disk, so any rank may then restore it,
on any mesh (``shardings=``).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading

from repro_torch.checkpoint import ckpt

_STEP_RE = re.compile(r"^step_(\d+)$")

# What a damaged or concurrently deleted checkpoint surfaces as: a vanished
# directory or leaf file, a torn manifest, or leaves that do not match the
# target tree.
_DAMAGE = (FileNotFoundError, NotADirectoryError, json.JSONDecodeError,
           KeyError, ValueError)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        os.makedirs(directory, exist_ok=True)
        self._pending: threading.Thread | None = None
        self._error: BaseException | None = None
        self._mesh = None      # the mesh of the last tree saved
        # a writer that died mid-write leaves an orphaned temporary dir
        for name in os.listdir(directory):
            if name.startswith(".ckpt-tmp-"):
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def all_steps(self) -> list[int]:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        out = []
        for name in names:
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 ckpt.MANIFEST)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Block until the outstanding write is on disk; re-raise its
        error if it failed."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        mesh, self._mesh = self._mesh, None
        ckpt.mesh_barrier(mesh)
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree) -> None:
        self.wait()   # one outstanding write at a time
        self._mesh = ckpt.dtensor_mesh(tree)
        leaves = ckpt.host_leaves(tree)

        def write():
            try:
                ckpt.write(self._step_dir(step), leaves)
                self._gc()
            except Exception as e:   # re-raised by wait()
                self._error = e

        if ckpt.writes_here(self._mesh):
            if self.async_write:
                self._pending = threading.Thread(target=write, daemon=True)
                self._pending.start()
                return
            write()
        if not self.async_write:
            self.wait()

    def restore(self, target, step: int | None = None, shardings=None):
        """Restore ``step`` (explicit: a damaged one raises) or the newest
        restorable checkpoint, walking past damaged newer ones; placed by
        ``shardings`` as :func:`~repro_torch.checkpoint.ckpt.restore`
        places them."""
        self.wait()
        if step is not None:
            return ckpt.restore(self._step_dir(step), target, shardings)
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        err: Exception | None = None
        for s in reversed(steps):
            try:
                return ckpt.restore(self._step_dir(s), target, shardings)
            except _DAMAGE as e:
                err = e
        raise FileNotFoundError(
            f"no restorable checkpoint in {self.directory} "
            f"(newest failure: {err!r})")

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
