"""What the port's kernel wrappers (ops/*_cuda.py) share.

A `CudaKernel` is one C entry of a library built from csrc/<source>.cu by
utils/build.py.  The library is built and loaded at the first launch, never
at import.  `launch` runs the entry on PyTorch's current stream without
synchronising, raises with the library's own error string if the C side
refused the launch, and adds one to `launches`; nothing else touches the
count.  `check_tensor` holds one input to its device, dtype, shape and
contiguity, and `require_cuda` refuses tensors that are not on a card:
a wrapper never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import build


def require_cuda(name, dev):
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {dev}")


def check_tensor(name, key, t, dev, dtype, shape=None):
    """Raise unless `t` lies on `dev` with `dtype`, is contiguous and, when
    `shape` is given, has that shape."""
    if t.device != dev:
        raise ValueError(f"{name}: {key} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: {key} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {key} is not contiguous")


def with_defaults(defaults, defines=()) -> tuple:
    """The build's ("NAME", value) pairs: `defaults` (a wrapper's measured
    table, the only home of those constants: the source has no defaults of
    its own) with `defines` put over them."""
    merged = dict(defaults)
    merged.update(defines)
    return tuple(merged.items())


class CudaKernel:
    """The C entry `name` of csrc/<source>.cu.  `argtypes` end with the
    stream; the entry returns an int error code that `error_symbol` (a
    `const char *f(int)` of the same library) describes.  `defines` build
    a variant of the source's compile-time constants (utils/build.py)."""

    def __init__(self, name, source, argtypes, error_symbol, defines=()):
        self.name, self.source, self.defines = name, source, tuple(defines)
        self.argtypes, self.error_symbol = argtypes, error_symbol
        self.launches = 0
        self._fn = None
        self._errstr = None

    def _load(self):
        if self._fn is None:
            lib = build.load(self.source, self.defines)
            fn = getattr(lib, self.name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            errstr = getattr(lib, self.error_symbol)
            errstr.argtypes = [ctypes.c_int]
            errstr.restype = ctypes.c_char_p
            self._fn, self._errstr = fn, errstr
        return self._fn

    def launch(self, dev, *args):
        """Run the entry with `args` and the current stream of `dev`."""
        fn = self._load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: {self._errstr(err).decode()}")
        self.launches += 1
