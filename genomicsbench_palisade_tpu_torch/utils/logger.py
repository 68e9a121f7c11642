"""Flye's logger and the memory lines of the reference drivers.

The port's own copy of genomicsbench_palisade_tpu/utils/logger.py's
`Logger`, `get_peak_rss` and `get_memory_size`: a singleton logger with
error/warning/info/debug levels, `[YYYY-MM-DD HH:MM:SS] LEVEL: msg` lines
and an optional file sink (benchmarks/kmer-cnt/logger.h), and peak-RSS
reporting (benchmarks/kmer-cnt/memory_info.h getPeakRSS, printed at
kmer_cnt.cpp:282-283 and msa_spoa_omp.cpp:499).
"""

from __future__ import annotations

import sys
import time


class Logger:
    """Singleton logger with Flye's line format (logger.h Logger::get())."""

    _instance = None

    def __init__(self):
        self.debugging = False
        self._file = None

    @classmethod
    def get(cls) -> "Logger":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def set_debugging(self, flag: bool):
        self.debugging = bool(flag)

    def set_output_file(self, path: str):
        if self._file is not None:
            self._file.close()
        self._file = open(path, "a")

    def _emit(self, level: str, msg: str, to_console: bool):
        stamp = time.strftime("[%Y-%m-%d %H:%M:%S]")
        line = f"{stamp} {level}: {msg}"
        if to_console:
            print(line, file=sys.stderr)
        if self._file is not None:
            self._file.write(line + "\n")
            self._file.flush()

    def error(self, msg):
        self._emit("ERROR", str(msg), True)

    def warning(self, msg):
        self._emit("WARNING", str(msg), True)

    def info(self, msg):
        self._emit("INFO", str(msg), True)

    def debug(self, msg):
        # debug lines always reach the file sink; the console only with --debug
        self._emit("DEBUG", str(msg), self.debugging)


def get_peak_rss() -> int:
    """Peak resident set size in bytes (memory_info.h getPeakRSS)."""
    try:
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # Linux reports KiB; macOS reports bytes
        return ru * 1024 if sys.platform != "darwin" else ru
    except Exception:
        return 0


def get_memory_size() -> int:
    """Total system RAM in bytes (memory_info.h getMemorySize)."""
    try:
        import os

        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError, AttributeError):
        return 0
