"""The port's CUDA kernel library as its wrappers use it.

``libsedef_kernels.so`` (``native/build.py``: the hand-written kernels of
``sedef_tpu_torch/csrc/*.cu`` behind a plain C interface) is built and
loaded once per process; each entry point is bound through ``ctypes`` with
the C signature that its wrapper module declares, next to the code that
calls it.  Around a launch every wrapper does the same: check its tensor
arguments, launch on the current stream of the tensors' card, raise on a
CUDA error and count the launch on the wrapper, and move host arrays to
and from the card through pinned memory.  This module names no kernel.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

_LIB = None
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_BOUND: dict = {}


def library() -> ctypes.CDLL:
    """The compiled kernel library; built once per process, under a lock
    (align_stage calls the aligner from a thread pool)."""
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                from .build import build_cuda
                _LIB = ctypes.CDLL(str(build_cuda()))
    return _LIB


def function(name: str, argtypes: list, restype=ctypes.c_int):
    """The library's entry point ``name`` bound with the C signature
    (``argtypes``, ``restype``) its caller declares; bound once and
    cached.  A launch entry point returns a CUDA error code and takes its
    stream last."""
    fn = _BOUND.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = restype
        _BOUND[name] = fn
    return fn


def check(t: torch.Tensor, dtype: torch.dtype, ndim: int, name: str
          ) -> None:
    """``t`` is a contiguous ``ndim``-D ``dtype`` tensor on the CPU or a
    card, or this raises."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name} must be a {ndim}-D {dtype} tensor, got "
                         f"{t.dim()}-D {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def same_device(*ts: torch.Tensor) -> torch.device:
    """The one device of ``ts``, or ``ValueError``."""
    dev = ts[0].device
    if any(t.device != dev for t in ts[1:]):
        raise ValueError("all tensor arguments must share one device")
    return dev


def launch(wrapper, dev: torch.device, fn, *args) -> None:
    """Launch on ``dev``'s current stream (no synchronisation), raise on a
    CUDA error, and count the launch on ``wrapper``."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    if torch.cuda.current_device() == dev.index:
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, stream)
    if rc:
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: CUDA "
                           f"error {rc}")
    with _COUNT_LOCK:
        wrapper.launches += 1


def upload(a: np.ndarray, device) -> torch.Tensor:
    """a as an int32 tensor on ``device``: on a card one copy from pinned
    memory queued on the current stream (the host does not wait)."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.int32))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def pull(t: torch.Tensor):
    """(t on the host, the CUDA event after its copy or None): on a card
    one copy into pinned memory queued on the current stream; the host
    reads it once the event has passed."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    return host, done


def ptr(t) -> int | None:
    """``t``'s device address, or None (a NULL pointer) for no tensor."""
    return t.data_ptr() if t is not None else None
