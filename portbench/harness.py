"""What every cell shares: the card check, the cache directories, the
result line, the check of loaded modules, the traced window and its
reading, and the per-layer metric readers found by name."""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)  # the checkout
BUILD = os.path.join(ROOT, "build")
FORBIDDEN = ("jax", "jaxlib", "flax", "exavatar_release_tpu")
# annotations the traced run opens around the program's layer entries
SPANS = {"prepare": "portbench.prepare", "human_forward": "portbench.human_forward"}


def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths.
    The program's kernels build into ``build/kernels`` (its ``cuda_build``)."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def free_device() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def quantile(values: List[float], q: float) -> float:
    """The ``q`` quantile (0..1) of ``values``, linear between order
    statistics."""
    v = sorted(values)
    if len(v) == 1:
        return v[0]
    x = q * (len(v) - 1)
    i = int(x)
    return v[i] if i + 1 >= len(v) else v[i] + (x - i) * (v[i + 1] - v[i])


class Checks:
    """The numbers that decide ``correct``, each beside its limit."""

    def __init__(self):
        self.items: Dict[str, Dict[str, float]] = {}

    def add(self, name: str, value: float, limit: float) -> None:
        self.items[name] = {"value": float(value), "limit": float(limit)}

    def ok(self) -> bool:
        return bool(self.items) and all(v["value"] <= v["limit"] for v in self.items.values())

    def print(self) -> None:
        for k, v in self.items.items():
            sys.stderr.write(f"check {k}: {v['value']!r} limit {v['limit']!r} "
                             f"{'ok' if v['value'] <= v['limit'] else 'FAIL'}\n")
        sys.stderr.flush()


# --------------------------------------------------------------------------
# the traced window
# --------------------------------------------------------------------------


class Spans:
    """Wraps the program's layer entries in ``record_function`` annotations
    for the traced run only: ``(module, attribute, span name)``."""

    def __init__(self, targets):
        self.targets = targets
        self.saved = []

    def __enter__(self):
        import torch

        for mod, attr, span in self.targets:
            fn = getattr(mod, attr)

            def wrapped(*a, _fn=fn, _span=span, **k):
                with torch.profiler.record_function(_span):
                    return _fn(*a, **k)

            self.saved.append((mod, attr, fn))
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)
        self.saved.clear()


def traced(run_units: Callable[[], int], path: str, on_card: bool = True):
    """Runs ``run_units`` (returns how many units it ran) under
    ``torch.profiler`` and reads the Chrome trace it writes. Returns
    (units, host seconds, Trace). Off the card (the CPU tests) the trace
    holds host operations only."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        units = run_units()
        sync()
        window_s = time.perf_counter() - t0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    try:
        trace = read_trace(path)
    finally:
        os.remove(path)
    trace.window_s = window_s
    return units, window_s, trace


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def read_trace(path: str) -> SimpleNamespace:
    """Kernels (name, start us, duration us, correlation), the launches'
    host times by correlation, the device intervals, the host ops and the
    annotations of a Chrome trace written by ``torch.profiler``."""
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    kernels, device, launches, host, spans = [], [], {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur))
            if cat == "kernel":
                kernels.append((e.get("name", ""), ts, dur, args.get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "correlation" in args:
                launches[args["correlation"]] = ts
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, e.get("name", ""), e.get("tid")))
            if cat == "user_annotation":
                spans.append((e.get("name", ""), ts, ts + dur))
    return SimpleNamespace(kernels=kernels, device=device, launches=launches, host=host,
                           spans=spans, window_s=0.0)


def merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_seconds(trace) -> float:
    return sum(b - a for a, b in merged(trace.device)) * 1e-6


def kernels_in_span(trace, span: str):
    """Kernels launched from inside any annotation named ``span``."""
    iv = sorted((a, b) for n, a, b in trace.spans if n == span)
    if not iv:
        return None
    import bisect

    starts = [a for a, _ in iv]
    out = []
    for k in trace.kernels:
        t = trace.launches.get(k[3])
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= iv[i][1]:
            out.append(k)
    return out


def breakdown(trace, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle gaps,
    each gap named by the innermost host operation running at its middle."""
    by_name: Dict[str, float] = {}
    for name, _, dur, _ in trace.kernels:
        key = name[:96]
        by_name[key] = by_name.get(key, 0.0) + dur * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = merged(trace.device)
    gaps = [(b0[1], b1[0]) for b0, b1 in zip(busy, busy[1:]) if b1[0] > b0[1]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inner = [h for h in trace.host if h[0] <= mid <= h[1]]
        name = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "host: no operation"
        named.append([f"host: {name}"[:96] if inner else name, (b - a) * 1e-6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


# --------------------------------------------------------------------------
# per-layer metric readers, found by name
# --------------------------------------------------------------------------


def load_reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(bench: dict, cell: str, ctx) -> Dict[str, dict]:
    """Every per-layer metric of ``cell``: each reader returns a number or
    None, and a metric whose reader finds nothing to read is left out."""
    out = {}
    for m in bench["per_layer"]:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        value = load_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_block(count: int, peak: int, trace_s: Optional[tuple] = None) -> dict:
    import torch

    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
         "memory_peak_bytes": int(peak)}
    if trace_s is not None:
        d["busy_s"], d["window_s"] = trace_s
    return d
