"""Profiling: ``torch.profiler`` traces and the program's named spans
(counterpart of exavatar_release_tpu/utils/profiling.py).

``trace`` writes a Chrome trace (chrome://tracing, Perfetto) of the host and,
where there is a card, of its kernels. ``span`` / ``spanned`` name the
program's layers in whatever profile is recording: each span is a
``record_function`` interval on the host, on the clock of the trace's kernel,
copy and idle intervals, nested in the span that encloses it on the same
thread. While no profile records, a span is one shared no-op.
"""
from __future__ import annotations

import contextlib
import functools
import os
from typing import Callable, Iterator, Optional, TypeVar

import torch

TRACE_FILE = "trace.json"

_NO_SPAN = contextlib.nullcontext()
_F = TypeVar("_F", bound=Callable)


def span(name: str):
    """A context naming the block ``name`` in the profile that is recording
    (``trace``'s, or any other ``torch.profiler`` profile); the shared no-op
    context while none is."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def spanned(name: str) -> Callable[[_F], _F]:
    """Decorator: every call of the function inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    where the card is there) and write ``log_dir/trace.json``, a Chrome
    trace that carries the program's spans. No-op when ``log_dir`` is None,
    so that call sites can stay unconditional."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
