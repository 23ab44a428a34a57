"""Daemon-thread futures: the newref pipeline's searches and the warm-ups.

Unlike a ThreadPoolExecutor's workers, a daemon thread is not joined at
interpreter exit, so background work cannot hold up a process that is
exiting with an error; and unlike a best-effort thread, its error is kept
and raised where the caller joins it.  Its spans are children of the span
open where it was started (``utils.log.carry``).
"""

from __future__ import annotations

import threading

from wisecondorx_tpu_torch.utils.log import carry


class DaemonFuture:
    """Run ``fn`` on a daemon thread; ``result()`` re-raises its error."""

    def __init__(self, fn, name):
        self._out = self._exc = None
        self._thread = threading.Thread(target=self._run, args=(carry(fn),),
                                        name=name, daemon=True)
        self._thread.start()

    def _run(self, fn):
        try:
            self._out = fn()
        except BaseException as e:  # re-raised in result()
            self._exc = e

    def wait(self):
        self._thread.join()

    def failed(self) -> bool:
        """True once ``fn`` has ended with an error."""
        return not self._thread.is_alive() and self._exc is not None

    def result(self):
        self._thread.join()
        if self._exc is not None:
            raise self._exc
        return self._out


_once_lock = threading.Lock()


def start_once(registry: dict, key, fn, name) -> DaemonFuture:
    """``registry[key]``, started as ``DaemonFuture(fn, name)`` unless it
    is there already.  One that failed is started again, so its error is
    raised once and a later caller gets a fresh attempt."""
    with _once_lock:
        fut = registry.get(key)
        if fut is None or fut.failed():
            fut = registry[key] = DaemonFuture(fn, name)
        return fut
