"""The port's utils/profiling.py on the CPU: ``trace`` writes a Chrome
trace; ``span`` is one shared no-op while no profile records and a nested
``record_function`` interval while one does; and the program's spans sit at
its layer boundaries, counted and nested, in a traced train step and a
traced two-pose animation."""
import dataclasses
import json
import os
import sys

import pytest
import torch

from exavatar_release_tpu_torch.utils import profiling as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the seeded tiny avatar and frame)

torch.set_num_threads(2)

TINY = dict(rings=8, segs=12, triplane_ch=8, triplane_res=16)


def annotations(path):
    """(name, start, end, thread) of every span in a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("tid"))
            for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def inside(spans, outer):
    """The spans of ``spans`` that lie within ``outer`` on its thread."""
    _, a, b, tid = outer
    return [s for s in spans if s is not outer and s[3] == tid and a <= s[1] and s[2] <= b]


def named(spans, name):
    return [s for s in spans if s[0] == name]


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


def test_span_is_the_shared_noop_while_nothing_records():
    assert not torch.autograd._profiler_enabled()
    a, b = tp.span("train.step"), tp.span("raster.prepare")
    assert a is b is tp._NO_SPAN
    with a as inner:
        assert inner is None


def test_spanned_calls_through_while_nothing_records():
    @tp.spanned("layer.f")
    def f(x, scale=1.0):
        """doc"""
        return x * scale

    assert f.__name__ == "f" and f.__doc__ == "doc"
    assert float(f(torch.ones(2), scale=3.0).sum()) == 6.0


def test_plain_ops_under_a_profile_leave_no_span(tmp_path):
    with tp.trace(str(tmp_path)):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8)).sum()
    assert annotations(tmp_path / tp.TRACE_FILE) == []


@pytest.mark.parametrize("form", ["span", "spanned"])
def test_nested_spans_in_the_chrome_trace(tmp_path, form):
    """Under ``trace``, two inner spans inside one outer span, in order,
    whether opened by ``span`` or by a ``spanned`` function."""
    if form == "span":
        def inner(x):
            with tp.span("layer.inner"):
                return torch.mm(x, x)
    else:
        inner = tp.spanned("layer.inner")(lambda x: torch.mm(x, x))

    with tp.trace(str(tmp_path)):
        with tp.span("layer.outer"):
            y = inner(inner(torch.ones(4, 4)))
    assert float(y[0, 0]) == 64.0
    spans = annotations(tmp_path / tp.TRACE_FILE)
    (outer,) = named(spans, "layer.outer")
    inners = named(spans, "layer.inner")
    assert len(inners) == 2 and sorted(inside(spans, outer)) == sorted(inners)
    assert inners[0][2] <= inners[1][1] or inners[1][2] <= inners[0][1]


@pytest.fixture(scope="module")
def traced_train_step(tmp_path_factory):
    """The spans of one traced ``train_step`` on a tiny port-only state
    whose 64x256 image is wider than its face window and its LPIPS crop."""
    from exavatar_release_tpu_torch.ops.rasterizer.api import RasterizeSettings
    from exavatar_release_tpu_torch.train import optim
    from exavatar_release_tpu_torch.train.loop import init_train_state, train_step

    cfg, trainables, scene_aux, bundle, frame, bg = chip_smoke.build_frame(
        "cpu", img=(64, 256), focal=60.0, scene_capacity=512, scene_live=300, tex=16,
        lpips_net="alex", **TINY)
    cfg = dataclasses.replace(cfg, face_render_h=32, face_render_w=64, lpips_crop_h=48,
                              lpips_crop_w=96)
    opt = optim.make_optimizer(trainables, cfg, float(scene_aux.cam_dist_radius), 30000)
    state = init_train_state(trainables, scene_aux, opt)
    d = tmp_path_factory.mktemp("train_trace")
    with tp.trace(str(d)):
        state, losses = train_step(state, bundle, frame, opt, cfg, is_warmup=False, bg=bg,
                                   settings=RasterizeSettings(pair_major=True))
    assert torch.isfinite(losses["total"]) and state.itr == 1
    return annotations(d / tp.TRACE_FILE)


@pytest.mark.parametrize("outer,name,count", [
    ("train.step", "model.forward", 1),
    ("train.step", "train.backward", 1),
    ("train.step", "train.outputs", 1),
    ("train.step", "train.update", 1),
    ("model.forward", "raster.prepare", 5),
    ("model.forward", "raster.composite", 5),
    ("model.forward", "human.forward", 1),
    ("model.forward", "face.render", 2),
    ("model.forward", "loss.lpips", 2),
    ("model.forward", "sync.window_origin", 4),
    ("model.forward", "sync.mesh_tiles", 2),
])
def test_train_step_spans(traced_train_step, outer, name, count):
    """Each layer's spans lie inside one ``train.step`` (one step, one
    unit), under their layer, and nowhere else."""
    spans = traced_train_step
    (step,) = named(spans, "train.step")
    (parent,) = named(spans, outer)
    assert parent is step or parent in inside(spans, step)
    found = named(spans, name)
    assert len(found) == count
    assert sorted(named(inside(spans, parent), name)) == sorted(found)


def test_render_motion_spans(tmp_path):
    """Two poses: two ``animate.frame`` spans, each holding one
    ``human.forward`` and one ``raster.prepare``."""
    from exavatar_release_tpu_torch.apps.animate import render_motion
    from exavatar_release_tpu_torch.core.camera import Camera
    from exavatar_release_tpu_torch.ops.rasterizer.api import RasterizeSettings

    prior, cfg, human, buffers, id_info, poses = chip_smoke.build_avatar(
        "cpu", num_poses=2, **TINY)
    H, W = 64, 96
    cam = Camera(torch.eye(3), torch.zeros(3), torch.tensor([60.0, 60.0]),
                 torch.tensor([W / 2.0, H / 2.0]))
    with tp.trace(str(tmp_path)), torch.no_grad():
        frames = render_motion(human, buffers, prior, id_info, poses, [cam, cam], cfg,
                               RasterizeSettings(pair_major=True), (H, W))
    assert len(frames) == 2 and frames[0]["img"].shape == (H, W, 3)
    spans = annotations(tmp_path / tp.TRACE_FILE)
    units = named(spans, "animate.frame")
    assert len(units) == 2
    for unit in units:
        held = inside(spans, unit)
        assert len(named(held, "human.forward")) == 1
        assert len(named(held, "raster.prepare")) == 1
    assert len(named(spans, "human.forward")) == len(named(spans, "raster.prepare")) == 2
