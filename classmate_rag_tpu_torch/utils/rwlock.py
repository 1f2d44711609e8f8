"""Reader-writer lock for the serving daemon's device discipline.

Concurrent QUERY dispatches may overlap (their host work interleaves).
Index MUTATIONS (ingest/delete/vacuum) change the store's host arrays
and scatter into its resident tensors in place, and must run
exclusively.

Writer-preferring: arriving writers block new readers so a steady query
stream cannot starve an ingest.

Host copy of the JAX package's ``utils/rwlock.py`` (no JAX).
"""

from __future__ import annotations

import contextlib
import threading


class ReadWriteLock:
    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer_active = False
        self._writers_waiting = 0

    @contextlib.contextmanager
    def read(self):
        with self._cond:
            while self._writer_active or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if self._readers == 0:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def write(self):
        with self._cond:
            self._writers_waiting += 1
            while self._writer_active or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer_active = True
        try:
            yield
        finally:
            with self._cond:
                self._writer_active = False
                self._cond.notify_all()


def read_scope(lock):
    """Shared scope on a ReadWriteLock; falls back to exclusive for a
    plain threading.Lock (tests / embedders of MicroBatcher)."""
    return lock.read() if hasattr(lock, "read") else lock


def write_scope(lock):
    """Exclusive scope regardless of lock flavor."""
    return lock.write() if hasattr(lock, "write") else lock
