"""Structured metrics logging: stdout + JSONL file (SURVEY.md §5).

The reference logs printf-style per-utterance logZx and per-epoch CV
accuracy; here every metric event is a JSON record with a step/epoch stamp,
mirrored to stdout, so benchmarks and tests can parse training curves.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, stream=None, quiet=False):
        self._fh = None
        self.quiet = quiet
        self._stream = stream if stream is not None else sys.stdout
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, kind: str, **fields) -> dict:
        rec = {"kind": kind, "t": round(time.time() - self._t0, 3), **fields}
        line = json.dumps(rec, default=float)
        if self._fh:
            self._fh.write(line + "\n")
        if not self.quiet:
            print(line, file=self._stream, flush=True)
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
