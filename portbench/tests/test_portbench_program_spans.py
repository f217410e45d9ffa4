"""The readers of the program's own spans (``metrics/program_spans.py``):
each on a hand-made trace, and None where its span is absent; and on tiny
traced CPU runs, the program's ``raster.prepare`` and ``human.forward``
spans hold the same host operations as the annotations the traced run puts
around ``api.prepare`` and ``apps.animate.human_forward``."""
import json
from types import SimpleNamespace

import pytest

import harness
import run
import tiny

# kernels (name, start us, duration us, correlation), launched at the host
# times of ``LAUNCHES``; two units of a train cell
KERNELS = [("k_human", 10.0, 4000.0, 1), ("k_face", 20.0, 1000.0, 2),
           ("k_lpips", 30.0, 3000.0, 3), ("k_bwd", 40.0, 50000.0, 4), ("k_adam", 50.0, 2000.0, 5),
           ("k_human", 110.0, 6000.0, 6), ("k_bwd", 140.0, 30000.0, 7),
           ("k_outside", 190.0, 9000.0, 8)]
LAUNCHES = {1: 1.5, 2: 2.5, 3: 3.5, 4: 4.5, 5: 5.5, 6: 11.5, 7: 14.5, 8: 19.5}
SPANS = [("train.step", 1.0, 6.0), ("model.forward", 1.0, 4.0), ("human.forward", 1.0, 2.0),
         ("face.render", 2.0, 3.0), ("sync.mesh_tiles", 2.2, 2.3), ("loss.lpips", 3.0, 4.0),
         ("sync.window_origin", 3.1, 3.2), ("train.backward", 4.0, 5.0),
         ("train.update", 5.0, 6.0),
         ("train.step", 11.0, 16.0), ("human.forward", 11.0, 12.0),
         ("sync.window_origin", 12.1, 12.2), ("train.backward", 14.0, 15.0),
         ("sync.drop_counters", 18.0, 19.0), ("portbench.prepare", 6.5, 9.5)]
# the card's busy intervals (us): idle 0.5 in the first step's forward, 0.6
# and 0.4 in the backwards, 3.0 between the steps (inside only the traced
# run's own annotation) and 3.0 after them, 1.0 of it in sync.drop_counters
DEVICE = [(0.0, 1.5), (2.0, 4.2), (4.8, 7.0), (10.0, 14.5), (14.9, 17.0), (20.0, 21.0)]
EXPECTED = {"human_fwd_ms.train": 5.0, "face_render_ms.train": 0.5, "lpips_ms.train": 1.5,
            "backward_ms.train": 40.0, "update_ms.train": 1.0, "host_reads.train": 1.5,
            "backward_idle_ms.train": 0.5e-3, "idle_unspanned_ms.train": 2.5e-3,
            "idle_unspanned_ms.animate": 2.5e-3}
# the span whose absence silences the reader; None: only the absence of
# every program span does
SPAN_OF = {"human_fwd_ms.train": "human.forward", "face_render_ms.train": "face.render",
           "lpips_ms.train": "loss.lpips", "backward_ms.train": "train.backward",
           "update_ms.train": "train.update", "host_reads.train": "train.step",
           "backward_idle_ms.train": "train.backward", "idle_unspanned_ms.train": None,
           "idle_unspanned_ms.animate": None}


def ctx(spans, device=DEVICE):
    trace = SimpleNamespace(kernels=KERNELS, launches=LAUNCHES, spans=spans, host=[],
                            device=device, window_s=1.0)
    return SimpleNamespace(trace=trace, units=2)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_on_a_hand_made_trace(metric):
    reader = harness.load_reader(metric)
    assert reader.read(ctx(SPANS)) == pytest.approx(EXPECTED[metric], rel=1e-12)
    if SPAN_OF[metric] is not None:
        assert reader.read(ctx([s for s in SPANS if s[0] != SPAN_OF[metric]])) is None
    assert reader.read(ctx([s for s in SPANS if s[0].startswith("portbench.")])) is None
    assert reader.read(ctx([])) is None
    if "idle" in metric:  # a trace with no device work has no idle to split
        assert reader.read(ctx(SPANS, device=[])) is None


def test_readers_are_in_the_benchmark():
    bench = harness.load_json(f"{harness.ROOT}/BENCHMARK.json")
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in EXPECTED:
        m = entries[name]
        assert m["source"] == "program_span"
        if name.endswith(".animate"):
            assert m["moves"] == "frame_ms" and m["workloads"] == ["animate_s20k"]
        else:
            assert m["moves"] == "train_step_ms"
            assert m["workloads"] == ["train_s20k", "train_s131k"]


def traced_run(monkeypatch, capsys, cell: str, traffic: str, seed: int):
    """A tiny traced run of ``cell`` on the CPU: (its result line, its
    parsed trace)."""
    kept = []
    traced = harness.traced

    def keep(*a, **k):
        out = traced(*a, **k)
        kept.append(out[2])
        return out

    monkeypatch.setattr(harness, "traced", keep)
    assert run.main(tiny.args(cell, seed, 1), device="cpu", cfg=tiny.config(),
                    traffic=tiny.traffic(traffic)) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    (trace,) = kept
    return line, trace


def host_ops_inside(trace, span: str):
    """Names of the host operations that start inside any ``span``, other
    than the annotations themselves, in order."""
    iv = [(a, b) for n, a, b in trace.spans if n == span]
    assert iv
    marks = {n for n, _, _ in trace.spans}
    return sorted((t0, name) for t0, _, name, _ in trace.host
                  if name not in marks and any(a <= t0 <= b for a, b in iv))


@pytest.mark.parametrize("cell,traffic,pairs", [
    ("train_s20k", "train_steady", [("raster.prepare", "prepare")]),
    ("animate_s20k", "animate_motion", [("raster.prepare", "prepare"),
                                        ("human.forward", "human_forward")]),
])
def test_program_spans_hold_what_the_annotations_hold(monkeypatch, capsys, cell, traffic, pairs):
    """Same host operations inside the program's span as inside the
    harness's annotation, and in a train cell the new metrics in the line:
    the tiny 64x256 image is no larger than the face window, so the LPIPS
    crop's two origins and the two face-mesh binnings wait for the host."""
    line, trace = traced_run(monkeypatch, capsys, cell, traffic, 3_000_000_101)
    for program, annotated in pairs:
        ops = host_ops_inside(trace, program)
        assert ops and ops == host_ops_inside(trace, harness.SPANS[annotated])
    if cell.startswith("train"):
        # the CPU trace has kernels of no device: the idle readers are silent
        train = {m for m in EXPECTED if m.endswith(".train")}
        assert {m for m in train if "idle" not in m} == train & set(line["metrics"])
        assert line["metrics"]["host_reads.train"]["value"] == 4.0
