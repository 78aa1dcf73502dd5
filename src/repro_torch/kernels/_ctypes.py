"""Calling a kernel's C entry point from Python: argument types, the
stream, and turning a non-zero return code into an exception."""
from __future__ import annotations

import ctypes

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _build

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def entry(kernel: str, symbol: str, argtypes):
    """The typed C function ``symbol`` of ``kernel``'s library (built at
    first use)."""
    lib = _build.load(kernel)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
    return fn


def check(kernel: str, code: int) -> None:
    """Raise if a launch returned non-zero (the kernel never ran)."""
    if code != 0:
        msg = _build.load(kernel).repro_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed ({code}): {msg}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(kernel: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if isinstance(t, DTensor):
            raise TypeError(
                f"{kernel}: the kernel reads raw pointers and takes each "
                f"rank's block of a DTensor, not the DTensor "
                f"(repro_torch.parallel.ctx.run_local)")
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{kernel}: the kernel takes CUDA tensors on one device, got "
                f"{[str(x.device) for x in tensors]} (CPU tensors go to the "
                f"plain version in kernels/{kernel}/ref.py)")
