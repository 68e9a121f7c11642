"""Build the C++ host library from native/*.cpp at first use.

The port's counterpart of native/Makefile: the same sources and the same
flags (`-ffp-contract=off` is part of the bit-exact contract), built into
`build/native/` at the root of the checkout (a directory git ignores),
never into native/ itself.  Each source compiles to an object in its own
process, all started together, and the objects link into one library.

The library's file name carries a hash of the sources, the flags, the
compiler's version and the host CPU's model name and feature flags:
`-march=native` makes a library built on one CPU unsafe on another.  A
file lock beside it lets concurrent processes (pytest workers) build it
once; the library appears by an atomic rename.  The compiler's output goes to a .log beside it.  A
failed build raises with the compiler's stderr; nothing falls back.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# native/Makefile's SRCS, in its order
SRCS = ("fastio.cpp", "poaalign.cpp", "abeafill.cpp", "phmmf64.cpp", "sais.cpp", "bamio.cpp",
        "fmsearch.cpp", "events.cpp", "abea_tb.cpp", "ctc_beam.cpp", "minimizers.cpp", "dbg.cpp",
        "pileup_events.cpp", "poagraph.cpp", "eventalign.cpp", "pairsio.cpp", "kmercnt.cpp")
# native/Makefile's CXXFLAGS and LDFLAGS
CXXFLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fPIC", "-std=c++20", "-Wall")
LDFLAGS = ("-shared", "-lz")


def compiler() -> str:
    return os.environ.get("CXX", "g++")


def _compiler_version(cxx: str) -> str:
    try:
        proc = subprocess.run([cxx, "--version"], capture_output=True, text=True, timeout=60)
    except OSError as e:
        return f"unavailable: {e}"
    return proc.stdout.strip().splitlines()[0] if proc.stdout.strip() else f"rc {proc.returncode}"


def _cpuinfo(field: str) -> str:
    """The first `field` line of /proc/cpuinfo, or "unknown"."""
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.split(":", 1)[0].strip() == field:
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def cpu_model() -> str:
    """The host CPU's model name, as /proc/cpuinfo gives it."""
    return _cpuinfo("model name")


def library_path(cxxflags=CXXFLAGS, ldflags=LDFLAGS, cxx: str | None = None) -> Path:
    cxx = cxx or compiler()
    h = hashlib.sha256()
    for src in sorted(NATIVE_DIR.glob("*.cpp")) + sorted(NATIVE_DIR.glob("*.h")):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    for part in (" ".join(cxxflags), " ".join(ldflags), _compiler_version(cxx), cpu_model(),
                 _cpuinfo("flags")):
        h.update(b"\0" + part.encode())
    return BUILD_DIR / f"libgenomics_native-{h.hexdigest()[:16]}.so"


def build(cxxflags=CXXFLAGS, ldflags=LDFLAGS) -> Path:
    """Compile native/ unless its library is already built; return the
    library's path.  Concurrent callers wait on one lock and build once."""
    cxx = compiler()
    out = library_path(cxxflags, ldflags, cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return out
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            log, errors = [], []
            procs = []
            for src in SRCS:
                cmd = [cxx, *cxxflags, "-c", str(NATIVE_DIR / src),
                       "-o", str(Path(tmp) / src.replace(".cpp", ".o"))]
                try:
                    procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                        stderr=subprocess.PIPE, text=True)))
                except OSError as e:
                    errors.append(f"{' '.join(cmd)}: {e}")
            for cmd, proc in procs:
                stdout, stderr = proc.communicate()
                log.append(" ".join(cmd) + "\n" + stdout + stderr)
                if proc.returncode != 0:
                    errors.append(f"{' '.join(cmd)} (exit {proc.returncode}):\n{stderr}")
            if not errors:
                tmp_lib = Path(tmp) / out.name
                cmd = [cxx, *(str(Path(tmp) / s.replace(".cpp", ".o")) for s in SRCS),
                       "-o", str(tmp_lib), *ldflags]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
                if proc.returncode != 0:
                    errors.append(f"{' '.join(cmd)} (exit {proc.returncode}):\n{proc.stderr}")
            out.with_suffix(".log").write_text("\n".join(log))
            if errors:
                raise RuntimeError(f"{cxx} failed to build native/: "
                                   + "\n".join(errors)[-4000:])
            os.replace(tmp_lib, out)  # atomic: a concurrent loader never sees half a file
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The built library, built at the first call."""
    return ctypes.CDLL(str(build()))
