"""The port's utils/profiling.py against the JAX package's: the roofline
model key for key at the JAX peaks (exact: the same integer counts and one
division each), the step meter's arithmetic, and the trace on the CPU."""
import json
import os

import numpy as np
import pytest
import torch

from exavatar_release_tpu.utils import profiling as jp
from exavatar_release_tpu_torch.utils import profiling as tp

torch.set_num_threads(2)

# the JAX defaults (TPU figures); the port's defaults are the H100's
JAX_PEAKS = dict(peak_flops=2.0e14, peak_bw=8.0e11)


@pytest.mark.parametrize("img,tile,K,chunk", [((1080, 1920), (32, 128), 1024, 256),
                                              ((48, 64), (8, 128), 512, 128),
                                              ((513, 897), (16, 64), 300, 64)])
def test_composite_roofline_matches_jax(img, tile, K, chunk):
    want = jp.composite_roofline(img, *tile, K, chunk, **JAX_PEAKS)
    got = tp.composite_roofline(img, *tile, K, chunk, **JAX_PEAKS)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k], k
    h100 = tp.composite_roofline(img, *tile, K, chunk)
    assert h100["flops"] == want["flops"] and h100["bytes"] == want["bytes"]
    assert h100["t_compute"] == want["flops"] / 67e12
    assert h100["t_memory"] == want["bytes"] / 3.35e12


def test_step_rater(monkeypatch):
    """The port's meter and the JAX package's on one clock (their window
    drops the oldest tick past ``window``)."""
    ticks = [10.0, 10.5, 11.0, 12.0, 14.0, 14.25]

    def run(cls):
        clock = iter(ticks)
        monkeypatch.setattr(tp.time, "perf_counter", lambda: next(clock))
        r = cls(pixels_per_step=100, window=3)
        return [r.tick() for _ in ticks]

    got, want = run(tp.StepRater), run(jp.StepRater)
    assert got[0] is None and want[0] is None
    assert got == want
    np.testing.assert_allclose([got[2]["steps_per_s"], got[2]["rays_per_s"]], [2.0, 200.0])
    np.testing.assert_allclose(got[4]["steps_per_s"], 1.0 / 1.5)  # (14 - 11) / 2


def test_trace_none_is_a_noop(tmp_path):
    before = set(os.listdir(tmp_path))
    with tp.trace(None):
        x = torch.ones(3) * 2
    assert float(x.sum()) == 6.0 and set(os.listdir(tmp_path)) == before


def test_trace_writes_a_chrome_trace(tmp_path):
    d = tmp_path / "prof"
    with tp.trace(str(d)):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    with open(d / tp.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
