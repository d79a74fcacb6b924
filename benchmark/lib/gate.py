"""The card's time of each unit of enqueued work, with the host's pace taken out.

A launch-bound train step runs on the card as fast as the host launches its
kernels, so its time on the card's clock is the host's time, stalls and all.
``Gate`` holds the work's stream at a wait on a flag in device memory while
the host enqueues one unit, then lets it go: CUDA events recorded after the
wait and after the unit time the unit as the card runs it with every launch
already queued.

    gate = Gate(dev)
    for ...:
        with gate.unit():
            work()
    gate.close()      # lets any held wait go and stops the watchdog
    sync()
    gate.unit_ms()    # the card's milliseconds of each unit

The wait and the release are the CUDA driver's stream memory operations:
``cuStreamWaitValue32`` on the work's stream and ``cuStreamWriteValue32`` on
a stream of the gate's own.  A unit cannot be held if it waits for the card,
or if it launches more than the card's launch queue holds behind a held
stream (about a thousand operations: an Inception train step's 1,421 do not
fit): the host then blocks inside the driver for ever.  A watchdog ends the
process, with a message and ``EXIT_STUCK``, once a unit has been held for
``STUCK_S`` seconds; it makes no driver call, which could block as well.
Off the card (the CPU tests) a unit is timed on the host's clock.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import sys
import threading
import time

import torch

STUCK_S = 30.0
EXIT_STUCK = 6
FREE = 0x7FFFFFFF  # above every unit's number: no wait holds
WAIT_GEQ = 0x0  # CU_STREAM_WAIT_VALUE_GEQ; a write's flags are 0 too: a plain write


def _driver() -> dict:
    lib = ctypes.CDLL("libcuda.so.1")
    fns = {}
    for name in ("cuStreamWaitValue32", "cuStreamWriteValue32"):
        fn = getattr(lib, name + "_v2", None) or getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint]
        fns[name] = fn
    return fns


class Gate:
    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self._units: list = []
        if not self.cuda:
            return
        self._fn = _driver()
        self._flag = torch.zeros(1, dtype=torch.int32, device=dev)
        torch.cuda.synchronize(dev)
        self._work = torch.cuda.current_stream(dev)
        self._side = torch.cuda.Stream(dev)  # non-blocking: never waits for the work
        self._held_since = None
        self._done = threading.Event()
        self._dog = threading.Thread(target=self._watch, name="gate-watchdog", daemon=True)
        self._dog.start()

    def _call(self, name: str, stream, value: int) -> None:
        err = self._fn[name](stream.cuda_stream, self._flag.data_ptr(), value, WAIT_GEQ)
        if err:
            raise RuntimeError(f"{name}: CUresult {err}")

    def _watch(self) -> None:
        while not self._done.wait(0.5):
            held = self._held_since
            if held is not None and time.perf_counter() - held > STUCK_S:
                print(f"benchmark: no result: a unit was held at the gate for {STUCK_S} s: it "
                      "waits for the card, or launches more than the card's queue holds behind "
                      "a held stream", file=sys.stderr, flush=True)
                os._exit(EXIT_STUCK)

    @contextlib.contextmanager
    def unit(self):
        if not self.cuda:
            t0 = time.perf_counter()
            yield
            self._units.append((time.perf_counter() - t0) * 1e3)
            return
        n = len(self._units) + 1
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        self._held_since = time.perf_counter()
        self._call("cuStreamWaitValue32", self._work, n)
        start.record(self._work)
        try:
            yield
        finally:
            end.record(self._work)
            self._call("cuStreamWriteValue32", self._side, n)
            self._held_since = None
            self._units.append((start, end))

    def close(self) -> None:
        """Lets every wait go and stops the watchdog; the caller then waits
        for the card before reading ``unit_ms``."""
        if not self.cuda:
            return
        self._done.set()
        self._dog.join()
        self._call("cuStreamWriteValue32", self._side, FREE)

    def unit_ms(self) -> list:
        if not self.cuda:
            return list(self._units)
        return [s.elapsed_time(e) for s, e in self._units]
