"""Host-side hang watchdog for distributed steps (port of
vo_tpu/parallel/watchdog.py, which imports no JAX; the port keeps its own
copy).

A collective whose peer has died blocks the calling thread until the
group's timeout, if any, with no word of where. This watchdog wraps any
blocking section:

    wd = StepWatchdog(timeout_s=60.0, on_timeout=dump_state)
    with wd.watch("ba all-reduce, frame 420"):
        out = step(state, batch)
        torch.cuda.synchronize()   # the section ends when the card has

On expiry it fires `on_timeout(tag, elapsed)` from a daemon thread (log,
checkpoint, or os._exit so that a supervisor restarts the process) while
the main thread stays blocked.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable


class StepWatchdog:
    def __init__(
        self,
        timeout_s: float = 60.0,
        on_timeout: Callable[[str, float], None] | None = None,
    ):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout or self._default_handler
        self.fired: list[str] = []  # tags that timed out (for tests/logs)

    @staticmethod
    def _default_handler(tag: str, elapsed: float) -> None:
        import sys

        print(
            f"[vo_tpu_torch watchdog] step '{tag}' exceeded "
            f"{elapsed:.1f}s — "
            "possible hung collective (dead peer?)",
            file=sys.stderr,
            flush=True,
        )

    @contextlib.contextmanager
    def watch(self, tag: str = "step"):
        done = threading.Event()
        start = time.monotonic()

        def sentinel():
            if not done.wait(self.timeout_s):
                self.fired.append(tag)
                self.on_timeout(tag, time.monotonic() - start)

        t = threading.Thread(target=sentinel, daemon=True)
        t.start()
        try:
            yield self
        finally:
            done.set()
