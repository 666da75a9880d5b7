"""Checkpoints (port of ``utils/checkpoint.py`` for the formats this port
reads and writes).

* ``save_checkpoint``: the model's reference-keyed ``state_dict`` as a
  ``.pth``, which loads with ``strict=True`` into this port's Reconstructor
  and into the reference's, as the JAX package's ``save_torch_checkpoint``
  output does (``CP_epoch{n}.pth``, the interrupt's ``last.pth``).
* ``save_train_state`` / ``load_train_state``: the whole train state, for
  ``--resume``: model, optimizer and plateau-scheduler state dicts, the
  optimizer step count, and the data-schedule position (epoch and
  optimizer steps done in it).  The JAX package writes it as
  ``last_state.msgpack``; this port as ``last_state.pth``.
* ``AsyncSaver``: the same writes on one background thread (the JAX
  package's orbax ``AsyncSaver``), which copies the tensors before it
  returns, so training may go on changing them.

Every write serializes to memory, writes ``<path>.tmp`` and renames it
over ``path``: a failed or interrupted save never truncates the previous
file.
"""
from __future__ import annotations

import io
import os
import queue
import threading
from typing import Any, Dict

import torch

__all__ = ["save_checkpoint", "save_train_state", "load_train_state", "train_state",
           "AsyncSaver", "atomic_write"]


def atomic_write(path: str, data: bytes) -> None:
    """Write ``data`` to ``path.tmp``, then rename it over ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _cpu_copy(obj):
    """``obj`` with every tensor replaced by a detached CPU copy of it."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _cpu_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu_copy(v) for v in obj)
    return obj


def _to_bytes(obj) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def save_checkpoint(path: str, model: torch.nn.Module) -> None:
    """The CPU copy of ``model.state_dict()`` as a ``.pth``."""
    atomic_write(path, _to_bytes(_cpu_copy(model.state_dict())))


def train_state(model, optimizer, scheduler, step: int, epoch: int = 0,
                opt_steps_done: int = 0) -> Dict[str, Any]:
    """A CPU snapshot of the train state: ``model``, ``optimizer`` and
    ``scheduler`` state dicts, ``step`` (optimizer steps taken), and the
    data-schedule position ``epoch`` / ``opt_steps_done``."""
    return _cpu_copy({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                      "scheduler": scheduler.state_dict(), "step": int(step),
                      "epoch": int(epoch), "opt_steps_done": int(opt_steps_done)})


def save_train_state(path: str, state: Dict[str, Any]) -> None:
    atomic_write(path, _to_bytes(state))


def load_train_state(path: str, model, optimizer, scheduler) -> Dict[str, Any]:
    """Restore a ``save_train_state`` file into ``model`` (strict),
    ``optimizer`` and ``scheduler``; returns the file's contents."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state["model"], strict=True)
    optimizer.load_state_dict(state["optimizer"])
    scheduler.load_state_dict(state["scheduler"])
    return state


class AsyncSaver:
    """Checkpoint writes on one background thread, in order.

    ``save(path, obj)`` copies ``obj``'s tensors to the host and returns;
    the thread serializes and writes them exactly as the synchronous save
    would (the same bytes).  ``wait()`` returns when every queued write is
    on disk and raises the first error a write met; ``close()`` waits and
    ends the thread.
    """

    def __init__(self):
        self._queue: "queue.Queue" = queue.Queue()
        self._error = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="sfh-async-checkpoint")
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                path, obj = item
                atomic_write(path, _to_bytes(obj))
            except Exception as e:    # handed to the caller by wait()
                self._error = self._error or e
            finally:
                self._queue.task_done()

    def save(self, path: str, obj) -> None:
        """Queue ``obj`` (a module's ``state_dict`` or a train state) for
        ``path``; its tensors are copied before this returns."""
        self._queue.put((path, _cpu_copy(obj)))

    def wait(self) -> None:
        self._queue.join()
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self) -> None:
        self.wait()
        self._queue.put(None)
        self._thread.join()
