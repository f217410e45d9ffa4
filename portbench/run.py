#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell (``workloads`` in
``BENCHMARK.json``) names a configuration (``portbench/configs/<name>.json``)
and a traffic mix (``portbench/traffic/<name>.json``, whose ``driver`` is the
generator under ``portbench/drivers/``). A run builds the program from the
seed, warms up, measures for ``--seconds``, then holds what the timed path
produced against the plain reference (``portbench/reference/``). Its last
line on standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones), ``device`` and, traced, ``breakdown``; last, under
``checks``, each number compared beside its limit, which also end standard
error. It exits non-zero with no result line without enough CUDA cards, or
if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402

harness.set_cache_dirs()


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cell_spec(bench: dict, workload: str):
    """(cell, configuration dict, traffic dict) of ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = harness.load_json(os.path.join(ROOT, conf["file"]))
    traffic = harness.load_json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json"))
    return cell, cfg, traffic


def log(msg: str) -> None:
    sys.stderr.write(f"[portbench {time.perf_counter() - T_START:8.2f}s] {msg}\n")
    sys.stderr.flush()


def main(argv=None, device=None, cfg=None, traffic=None, bench=None) -> int:
    """``device``, ``cfg``, ``traffic`` and ``bench`` replace the card and the
    cell's files in the CPU tests; a run of the benchmark gives none."""
    args = parse(argv)
    bench = bench or harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, cell_cfg, cell_traffic = cell_spec(bench, args.workload)
    cfg, traffic = cfg or cell_cfg, traffic or cell_traffic

    import torch

    log("torch imported")
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            log(f"needs {cell['chips']} CUDA card(s), found {found}: no result")
            return 3
        device = "cuda"
        from exavatar_release_tpu_torch import cuda_build

        cuda_build.build()
        torch.zeros(1, device=device)
        log("kernels built, card initialised")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device == "cuda"
    marks = {}
    env = SimpleNamespace(
        cfg=cfg, traffic=traffic, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device=device, log=log, checks=harness.Checks(),
        mark_setup=lambda: marks.setdefault("setup", time.perf_counter() - T_START),
        reset_peak=(torch.cuda.reset_peak_memory_stats if on_card else (lambda: None)),
        peak=(torch.cuda.max_memory_allocated if on_card else (lambda: 0)),
        traced=lambda units: harness.traced(
            units, os.path.join(harness.BUILD, "portbench", "trace.json"), on_card),
    )
    driver = importlib.import_module(f"drivers.{traffic['driver']}")
    res = driver.run(env)

    found = harness.forbidden_modules()
    if found:
        log(f"modules of JAX or of the JAX package are loaded: {found}; no result")
        return 4
    metrics = {}
    if env.trace:
        ctx = SimpleNamespace(**res)
        metrics = harness.read_metrics(bench, cell["name"], ctx)
        log(f"launch counters of the program per unit: {res.get('launch_counters')}")
        log(f"compositing work per unit on the reference: {res.get('work')}")
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        e2e = dict(res["end_to_end"], setup_s=marks["setup"])
        metrics = {k: {"value": v, "unit": units[k]} for k, v in e2e.items()}
    trace_s = None
    if env.trace:
        trace_s = (harness.busy_seconds(res["trace"]), res["trace"].window_s)
        out_breakdown = harness.breakdown(res["trace"])
    out = {
        "correct": env.checks.ok() and res["attempted"] > 0,
        "attempted": res["attempted"],
        "failed": res["failed"],
        "metrics": metrics,
        "device": (harness.device_block(cell["chips"], res["peak"], trace_s) if on_card
                   else {"platform": "cpu", "kind": "cpu", "count": 1,
                         "memory_peak_bytes": 0}),
    }
    if env.trace:
        out["breakdown"] = out_breakdown
    log(f"card: {harness.card_line() if on_card else 'cpu'}")
    out["checks"] = env.checks.items
    env.checks.print()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
