"""A tiny run of each traffic mix on the CPU, untraced and traced, prints
a well-formed last line with ``correct`` true, and leaves no module of JAX
or of the JAX package loaded."""
import json
import sys

import pytest

import run
import tiny

CELLS = {"train_s20k": "train_steady", "animate_s20k": "animate_motion"}
E2E = {"train_s20k": {"train_step_ms", "setup_s"},
       "animate_s20k": {"frame_ms", "frame_ms_p95", "setup_s"}}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_tiny_run_prints_the_contract_line(cell, trace, capsys):
    rc = run.main(tiny.args(cell, 3_000_000_019 + trace, trace), device="cpu",
                  cfg=tiny.config(), traffic=tiny.traffic(CELLS[cell]))
    assert rc == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == E2E[cell]
    # the checks end standard error, each beside its limit
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)
    assert not [m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "exavatar_release_tpu")]


def test_no_card_no_result(capsys):
    """Without a CUDA card the command exits non-zero and prints no line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(tiny.args("animate_s20k", 1, 0)) != 0
    assert capsys.readouterr().out == ""
