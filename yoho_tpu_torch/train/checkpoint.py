"""Checkpoint/resume: atomic, async, preemption-safe.

The port's counterpart of the JAX package's ``train/checkpoint.py``, with
the same write discipline: serialize, write a temp file, atomic rename; a
single background writer that coalesces saves, flushes on close, and an
optional SIGTERM hook that writes the newest snapshot on the way down.

The files are flax's msgpack (``train/msgpack.py``, the port's own codec):

* ``save_params`` / ``load_params`` read and write the same params files
  as the JAX package (a flax params tree, ``nn.params.to_jax_params``);
* a checkpoint is ``{"step", "params", "opt_state"}``: ``step`` and
  ``params`` in the JAX package's layout, ``opt_state`` in the port's own
  (``train/optim.py``), marked by its ``"format"`` entry. A checkpoint of
  one package does not resume in the other: the port refuses a JAX
  checkpoint with a message, and flax's ``from_state_dict`` refuses the
  port's optimizer state (its keys differ).
"""

from __future__ import annotations

import os
import signal
import threading
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch

from yoho_tpu_torch.train import msgpack
from yoho_tpu_torch.train.optim import STATE_FORMAT


def to_host(tree):
    """A host copy of a tree (dicts) of tensors, arrays and scalars:
    tensors as numpy arrays of their type (bf16 stays a CPU bf16 tensor)."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().to("cpu", copy=True)
        return t if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


def _write(path: Path, tree) -> None:
    """``tree`` as flax msgpack at ``path``: a temp file, then an atomic
    rename."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        msgpack.dump(tree, f)
    os.replace(tmp, path)  # atomic on POSIX


def _restore(template, state, where: str = "params"):
    """flax's ``from_state_dict`` for nested dicts: every template key must
    be in the saved tree (``ValueError`` otherwise), saved keys the template
    lacks are ignored (stage 3 takes the ``encoder`` out of the stage-2
    artifact this way); the leaves come from ``state``. Unlike flax, a
    leaf of another shape than the template's raises ``ValueError``."""
    if isinstance(template, dict):
        missing = (sorted(set(map(str, template)) - set(state))
                   if isinstance(state, dict) else type(state).__name__)
        if missing:
            raise ValueError(f"the saved tree at {where} lacks the template's "
                             f"keys {missing}")
        return {k: _restore(v, state[str(k)], f"{where}/{k}") for k, v in template.items()}
    shape = tuple(getattr(template, "shape", ()))
    if tuple(getattr(state, "shape", ())) != shape:
        raise ValueError(f"{where}: saved shape {tuple(getattr(state, 'shape', ()))}, "
                         f"template {shape}")
    return state


def save_checkpoint(path, step: int, params, opt_state) -> None:
    """Blocking atomic save of (step, params, opt_state)."""
    payload = {"step": int(step), "params": to_host(params),
               "opt_state": to_host(opt_state)}
    _write(Path(path), payload)


def load_checkpoint(path, params_template, opt_state_template=None
                    ) -> Optional[Tuple[int, Any, Any]]:
    """Restore (step, params, opt_state) against templates; None if absent.
    Raises on a checkpoint the JAX package wrote."""
    path = Path(path)
    if not path.exists():
        return None
    payload = msgpack.loads(path.read_bytes())
    opt_state = payload.get("opt_state")
    if not (isinstance(opt_state, dict) and opt_state.get("format") == STATE_FORMAT):
        raise ValueError(
            f"{path} was not written by the PyTorch port (its optimizer state "
            "is not the port's): a checkpoint resumes only in the package "
            "that wrote it. Start from its params instead (load_params / "
            "load_jax_params), or pick a fresh output directory.")
    params = _restore(params_template, payload["params"])
    if opt_state_template is not None:
        opt_state = _restore(opt_state_template, opt_state, "opt_state")
    return int(payload["step"]), params, opt_state


class AsyncCheckpointer:
    """Single background writer; a save issued while one is in flight
    replaces the pending payload (coalescing), so the training loop never
    blocks and writes never interleave."""

    def __init__(self, path, install_sigterm: bool = False):
        self.path = Path(path)
        self._pending = None
        # RLock: the SIGTERM handler runs ON the main thread and may
        # interrupt save() while it holds this lock — a plain Lock would
        # deadlock the process exactly on the preemption path.
        self._cv = threading.Condition(threading.RLock())
        # Serializes the actual file write AND enforces snapshot ordering:
        # flush() (signal path) and the writer thread must never write the
        # same .tmp concurrently, and an older snapshot must never replace
        # a newer one after the fact.
        self._write_lock = threading.Lock()
        self._write_owner = None  # thread currently inside _write
        self._seq = 0
        self._written_seq = 0
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        if install_sigterm:
            try:
                prev = signal.getsignal(signal.SIGTERM)

                def _handler(signum, frame):
                    # Bounded-blocking: if the writer thread holds the
                    # write lock (writing an OLDER snapshot), wait for it
                    # and then write the newest one — unbounded grace is
                    # not guaranteed under preemption, hence the timeout.
                    # flush() itself detects the self-deadlock case (the
                    # handler interrupted a frame on THIS thread that
                    # holds the lock, e.g. close()'s flush) and re-stages
                    # instead of waiting.
                    self.flush(timeout=30.0)
                    if callable(prev):
                        prev(signum, frame)
                    elif prev is not signal.SIG_IGN:
                        # Default disposition: re-deliver so the process
                        # actually terminates (swallowing SIGTERM forces
                        # the supervisor to escalate to SIGKILL, which
                        # would land mid-write on a later checkpoint).
                        signal.signal(signum, signal.SIG_DFL)
                        os.kill(os.getpid(), signum)

                signal.signal(signal.SIGTERM, _handler)
            except ValueError:
                pass  # not the main thread

    def save(self, step: int, params, opt_state) -> None:
        # Host copies NOW so the snapshot is consistent even though training
        # updates the tensors in place next step.
        snapshot = (int(step), to_host(params), to_host(opt_state))
        with self._cv:
            self._seq += 1
            self._pending = (self._seq, snapshot)
            self._cv.notify()

    def _write(self, seq: int, payload, blocking: bool = True,
               timeout: float | None = None) -> bool:
        if timeout is not None:
            acquired = self._write_lock.acquire(timeout=timeout)
        else:
            acquired = self._write_lock.acquire(blocking=blocking)
        if not acquired:
            return False  # a write is already in flight (or timed out)
        self._write_owner = threading.current_thread()
        try:
            if seq <= self._written_seq:
                return True  # a newer snapshot already reached disk
            save_checkpoint(self.path, *payload)
            self._written_seq = seq
            return True
        finally:
            self._write_owner = None
            self._write_lock.release()

    def _run(self) -> None:
        while True:
            with self._cv:
                while self._pending is None and not self._stop:
                    self._cv.wait()
                if self._stop and self._pending is None:
                    return
            # Take the write lock BEFORE popping pending: flush() can
            # then rely on "pending is None and the lock is free" =>
            # the newest snapshot is durable (no window where a popped
            # snapshot exists outside both pending and the lock).
            self._write_lock.acquire()
            self._write_owner = threading.current_thread()
            try:
                with self._cv:
                    if self._pending is None:
                        continue  # flush() wrote it meanwhile
                    seq, payload = self._pending
                    self._pending = None
                if seq > self._written_seq:
                    try:
                        save_checkpoint(self.path, *payload)
                        self._written_seq = seq
                    except Exception as e:  # noqa: BLE001
                        # A transient write failure (ENOSPC, I/O) must
                        # not kill the writer thread — that would turn
                        # every later save() into a silent no-op. Warn
                        # and keep consuming; newer snapshots retry.
                        import warnings

                        warnings.warn(
                            f"async checkpoint write failed at seq {seq} "
                            f"({e}); the writer keeps running and newer "
                            "snapshots will retry")
            finally:
                self._write_owner = None
                self._write_lock.release()

    def _restage(self, item) -> None:
        """Put an un-written snapshot back as pending (unless a newer one
        was staged meanwhile) so it is never silently dropped."""
        with self._cv:
            if self._pending is None or self._pending[0] < item[0]:
                self._pending = item
                self._cv.notify()

    def flush(self, blocking: bool = True,
              timeout: float | None = None) -> None:
        """Write any pending snapshot synchronously (signal-safe: never
        interleaves with the writer thread, never regresses to an older
        snapshot). ``timeout`` bounds the wait on an in-flight write (the
        signal-handler path: wait for the writer thread to finish its
        older snapshot, then write the newest). If the lock holder is
        THIS thread — the handler interrupted a frame inside ``_write``
        — waiting would self-deadlock, so the snapshot is re-staged
        instead; likewise on a timeout or a ``blocking=False`` miss."""
        with self._cv:
            item, self._pending = self._pending, None
        if item is None:
            # Nothing staged — but the writer may be MID-WRITE of the
            # newest snapshot (it holds the write lock from before the
            # pop until durability). The SIGTERM path relies on flush()
            # returning only once that write is on disk, so wait
            # (bounded) for the lock instead of returning instantly and
            # letting the handler kill the process mid os.replace.
            if self._write_owner is threading.current_thread():
                return
            if timeout is not None:
                acquired = self._write_lock.acquire(timeout=timeout)
            else:
                acquired = self._write_lock.acquire(blocking=blocking)
            if acquired:
                self._write_lock.release()
            return
        if self._write_owner is threading.current_thread():
            self._restage(item)
            return
        if not self._write(*item, blocking=blocking, timeout=timeout):
            self._restage(item)

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=30)
        self.flush()


def save_params(path, params) -> None:
    """Export a params-only artifact (a flax params tree; the JAX
    package's ``load_params`` reads it)."""
    _write(Path(path), to_host(params))


def load_params(path, template=None):
    """Restore a params artifact (the JAX package's or the port's); None if
    absent. With a ``template`` the result is the saved tree cut to the
    template's keys, each of the template's shape (:func:`_restore`)."""
    path = Path(path)
    if not path.exists():
        return None
    tree = msgpack.loads(path.read_bytes())
    return tree if template is None else _restore(template, tree)
