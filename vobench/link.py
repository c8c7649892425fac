"""The pipe between `run.py` and a worker: one JSON line per message, and
after it the raw bytes of the numpy arrays that its "blobs" entry lists
(name, dtype, shape), in that order."""

from __future__ import annotations

import json
import os
import sys

import numpy as np


class Link:
    def __init__(self, rfile, wfile):
        self.r, self.w = rfile, wfile

    @classmethod
    def worker(cls) -> "Link":
        """The worker's end: its own stdin and a private copy of its stdout;
        file descriptor 1 then points at stderr, so that nothing the program
        prints can corrupt a message."""
        out = os.fdopen(os.dup(1), "wb")
        os.dup2(2, 1)
        sys.stdout = sys.stderr
        return cls(sys.stdin.buffer, out)

    def send(self, msg: dict, blobs: dict | None = None) -> None:
        blobs = blobs or {}
        head = {**msg, "blobs": [[k, str(v.dtype), list(v.shape)]
                                 for k, v in blobs.items()]}
        self.w.write(json.dumps(head).encode() + b"\n")
        for v in blobs.values():
            self.w.write(np.ascontiguousarray(v).tobytes())
        self.w.flush()

    def recv(self) -> dict:
        line = self.r.readline()
        if not line:
            raise EOFError("the other end of the pipe closed")
        msg = json.loads(line)
        arrays = {}
        for name, dtype, shape in msg.pop("blobs", []):
            n = int(np.prod(shape)) * np.dtype(dtype).itemsize
            buf = self.r.read(n)
            if len(buf) != n:
                raise EOFError(f"blob {name}: {len(buf)} of {n} bytes")
            arrays[name] = np.frombuffer(buf, dtype=dtype).reshape(shape)
        if arrays:
            msg["arrays"] = arrays
        return msg
