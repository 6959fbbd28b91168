"""Timing and tracing helpers (counterpart of meshrcnn_tpu/utils/profiling.py;
reference: utils/time_decorator.py:4-15).

``time_this`` is the reference's wall-clock decorator; it waits for the card
when the result holds a CUDA tensor, so that queued kernels are inside the
time. ``trace(log_dir)`` records a ``torch.profiler`` trace (the CPU, and
the card when there is one) into ``log_dir`` as a Chrome trace file;
``annotate(name)`` names a range of it (``record_function``).
"""
from __future__ import annotations

import contextlib
import os
import time
from functools import wraps
from typing import Callable, Optional

import torch


def _holds_cuda(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, dict):
        return any(_holds_cuda(v) for v in out.values())
    if isinstance(out, (list, tuple)):
        return any(_holds_cuda(v) for v in out)
    if hasattr(out, "__dataclass_fields__"):
        return any(_holds_cuda(getattr(out, k)) for k in out.__dataclass_fields__)
    return False


def time_this(fn: Optional[Callable] = None, *, log: Optional[dict] = None):
    """Wall-clock timing decorator. With ``log`` given, appends each duration
    under the function's name; else prints it."""
    def deco(f):
        @wraps(f)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = f(*args, **kwargs)
            if _holds_cuda(out):
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if log is not None:
                log.setdefault(f.__name__, []).append(dt)
            else:
                print(f"{f.__name__}: {dt:.4f}s")
            return out
        return wrapper
    return deco(fn) if fn is not None else deco


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block into
    ``<log_dir>/trace.json`` (Chrome trace format, for Perfetto or
    chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range in profiler traces."""
    with torch.profiler.record_function(name):
        yield
