"""Leveled logging with a replaceable sink — this decoder's analog
of the reference's ovlog (ovlog.c:37-115, ovlog.h:41-53): a global level
(ERROR..TRACE), a stderr default sink with per-level colored prefixes,
and a user-replaceable callback (ovdec_set_log_callback, ovdec.h:156).

Level comes from OPENVVC_LOG (name or number) or set_log_level(); the
default is INFO like the reference (ovlog.c:37).
"""

from __future__ import annotations

import os
import sys
import threading

ERROR, WARNING, INFO, VERBOSE, DEBUG, TRACE = range(6)

_NAMES = {"error": ERROR, "warning": WARNING, "info": INFO,
          "verbose": VERBOSE, "debug": DEBUG, "trace": TRACE}
_PREFIX = {ERROR: "\x1b[1;31m[ERROR]\x1b[0m",
           WARNING: "\x1b[1;33m[WARNING]\x1b[0m",
           INFO: "\x1b[1;32m[INFO]\x1b[0m",
           VERBOSE: "[VERBOSE]",
           DEBUG: "\x1b[1;34m[DEBUG]\x1b[0m",
           TRACE: "[TRACE]"}
_PLAIN = {ERROR: "[ERROR]", WARNING: "[WARNING]", INFO: "[INFO]",
          VERBOSE: "[VERBOSE]", DEBUG: "[DEBUG]", TRACE: "[TRACE]"}

_lock = threading.Lock()


def _env_level():
    v = os.environ.get("OPENVVC_LOG", "info").strip().lower()
    if v.isdigit():
        return max(ERROR, min(TRACE, int(v)))
    return _NAMES.get(v, INFO)


_level = _env_level()
_callback = None


def set_log_level(level) -> None:
    """ovlog_set_log_level parity (ovlog.h:49)."""
    global _level
    if isinstance(level, str):
        level = _NAMES.get(level.lower(), INFO)
    _level = int(level)


def get_log_level() -> int:
    return _level


def set_log_callback(fn) -> None:
    """Replace the sink: fn(level:int, message:str) — ovlog_set_callback
    parity (ovlog.h:53). Pass None to restore the stderr default."""
    global _callback
    _callback = fn


def ov_log(level, msg: str, *args) -> None:
    """Log `msg % args` at `level` (int or name). Cheap when filtered."""
    if isinstance(level, str):
        level = _NAMES.get(level.lower(), INFO)
    if level > _level:
        return
    if args:
        msg = msg % args
    cb = _callback
    if cb is not None:
        cb(level, msg)
        return
    pfx = _PREFIX[level] if sys.stderr.isatty() else _PLAIN[level]
    with _lock:
        print(f"{pfx} {msg}", file=sys.stderr)


def error(msg, *a):
    ov_log(ERROR, msg, *a)


def warning(msg, *a):
    ov_log(WARNING, msg, *a)


def info(msg, *a):
    ov_log(INFO, msg, *a)


def debug(msg, *a):
    ov_log(DEBUG, msg, *a)
