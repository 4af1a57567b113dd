"""Append-only trace of the calls that can block on the device (port of
``sslrec_tpu/utils/dispatch_trace.py``).

The trainer brackets each such call (an epoch's steps, the loss sync, an
evaluation, a state save) with ``mark()`` / ``done()`` lines in a
line-buffered file, so that a killed process leaves an attribution: the
last BEGIN without its END names the call that hung, with its arguments.

Enabled by ``SSLREC_TRACE_FILE``: the CLI sets it to
``runs_torch/dispatch_trace_<pid>.log`` unless it is set already; where it is
unset every call here is a no-op (tests, library use).  The variable is read
once, at the first call.

Kernels run asynchronously, so a hang inside a step may block Python only at
the next sync point; ``train.trace_sync`` synchronizes the card after every
step, which makes the attribution exact to the step and serialises the
steps' launches (for forensic runs only).
"""

from __future__ import annotations

import os
import time

_file = None
_enabled = None


def _fh():
    global _file, _enabled
    if _enabled is None:
        path = os.environ.get("SSLREC_TRACE_FILE")
        _enabled = bool(path)
        if _enabled:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            _file = open(path, "a", buffering=1)
            _file.write(f"# pid {os.getpid()} start {time.strftime('%Y-%m-%d %H:%M:%S')}\n")
    return _file


def mark(tag: str, **info) -> None:
    f = _fh()
    if f is not None:
        extra = " ".join(f"{k}={v}" for k, v in info.items())
        f.write(f"{time.time():.3f} BEGIN {tag} {extra}\n")


def done(tag: str) -> None:
    f = _fh()
    if f is not None:
        f.write(f"{time.time():.3f} END {tag}\n")


def reset() -> None:
    """Close the file and forget the variable's value, so that the next call
    reads ``SSLREC_TRACE_FILE`` again."""
    global _file, _enabled
    if _file is not None:
        _file.close()
    _file = _enabled = None
