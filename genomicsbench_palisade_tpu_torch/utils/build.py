"""Build the port's CUDA sources at first use and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface, so `nvcc` builds it in
seconds into `build/torch_kernels/` at the root of the checkout (a
directory git ignores), and ctypes loads it.  The library's file name
carries a hash of the source and the flags, so an edit rebuilds and an
unchanged source is built once.  A failed build raises; nothing falls back.

Flags: sm_90a (Hopper), -O3, and -fmad=false so that no multiply and add
contract into an FMA (the kernels hold the oracle's rounding bit for bit).
Never --use_fast_math.  `defines` (("NAME", value) pairs, passed as -D)
set a source's compile-time constants: a wrapper passes its measured
table (lanes a pair, register banks), and a layout sweep builds variants
of it beside the wrapper's own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the build log
)
# the CUDA toolkit's usual home, tried after $CUDA_HOME/$CUDA_PATH and $PATH
CUDA_HOMES = ("/usr/local/cuda",)

_LIBS: dict = {}


def find_nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    for home in CUDA_HOMES:
        if (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from csrc/ at first "
        "use; install the CUDA toolkit and set CUDA_HOME or put nvcc on PATH")


def _flags(defines=()) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{k}={v}" for k, v in defines)


def library_path(name: str, defines=()) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(_flags(defines)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(name: str, defines=()) -> Path:
    """Compile csrc/<name>.cu unless its library is already built; return
    the library's path.  The compiler's output goes to a .log beside it."""
    out = library_path(name, defines)
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *_flags(defines), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def load(name: str, defines=()) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, built at the first call."""
    key = (name, tuple(defines))
    if key not in _LIBS:
        _LIBS[key] = ctypes.CDLL(str(build(name, defines)))
    return _LIBS[key]
