"""The rasterizer's capacity governor and the scene's capacity growth in the
PyTorch port, on the CPU: the cases of tests/test_train.py for the JAX class
(bounded growth, the switch to pair-major, training from absurdly small
capacities healed within 8 steps), every branch of ``update`` against the JAX
class on the same counter sequences (the settings both end with are equal,
field by field), and ``grow_scene_capacity`` with a further step and a
densify pass at the new capacity.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from exavatar_release_tpu.ops.rasterizer.api import RasterizeSettings as JSettings
from exavatar_release_tpu.train.loop import RasterCapacityGovernor as JGovernor
from exavatar_release_tpu_torch.avatar import convert
from exavatar_release_tpu_torch.ops.rasterizer.api import RasterizeSettings
from exavatar_release_tpu_torch.train import loop as tl
from exavatar_release_tpu_torch.train.optim import make_optimizer
from torch_frame_fixture import TwinFrame, _fields

torch.set_num_threads(2)

SHARED = ("max_per_tile", "pair_major", "max_pairs", "pairs_per_gaussian")


def test_growth_is_bounded():
    gov = tl.RasterCapacityGovernor(
        RasterizeSettings(max_per_tile=8192, pairs_per_gaussian=8192, backend="ref"),
        patience=1, max_per_tile_ceiling=16384)
    for _ in range(20):
        gov.update(1e9, 1e9)
    assert gov.settings.max_per_tile == 16384
    assert gov.settings.pairs_per_gaussian == (1 << 24) // 1024
    assert not gov.settings.pair_major  # backend "ref" has no pair-major path


def test_sustained_truncation_switches_to_pair_major():
    gov = tl.RasterCapacityGovernor(RasterizeSettings(max_per_tile=1024), patience=1,
                                    pair_major_threshold=4096)
    grown = []
    while not gov.settings.pair_major:
        gov.update(0.0, 1e6)
        grown.append(gov.settings.max_per_tile)
    # 1024 -> 2048 -> 4096, then the switch instead of a further doubling
    assert grown == [2048, 4096, 4096]
    before = gov.settings
    gov.update(0.0, 0.0)
    assert gov.settings == before


def _sequence(seed, n=40):
    rng = np.random.default_rng(seed)
    on = lambda p: (rng.uniform(size=n) < p) * rng.integers(1, 1000, n).astype(float)
    return list(zip(on(0.6), on(0.6), on(0.5)))


@pytest.mark.parametrize("case", ["defaults", "explicit_budget", "ref_backend", "exchange_cap"])
def test_update_against_the_jax_class(case):
    kw = dict(defaults=dict(max_per_tile=256, pairs_per_gaussian=2),
              explicit_budget=dict(max_per_tile=512, max_pairs=1 << 20),
              ref_backend=dict(max_per_tile=2048, backend="ref"),
              exchange_cap=dict(max_per_tile=1024))[case]
    gkw = dict(patience=2, pair_major_threshold=2048, max_pairs_ceiling=1 << 22)
    if case == "exchange_cap":
        gkw.update(exchange_cap_floor=3000, patience=1)
    j_kw = dict(kw)
    if j_kw.get("backend") != "ref":
        j_kw["backend"] = "pallas"
    logs = ([], [])
    jg = JGovernor(JSettings(**j_kw), log=logs[0].append, **gkw)
    tg = tl.RasterCapacityGovernor(RasterizeSettings(**kw), log=logs[1].append, **gkw)
    for i, (pairs, trunc, xovf) in enumerate(_sequence(len(case))):
        js = jg.update(pairs, trunc, xovf)
        ts = tg.update(pairs, trunc, xovf)
        for f in SHARED:
            assert getattr(ts, f) == getattr(js, f), (i, f)
        # the JAX package keeps the exchange's capacity in its settings; the
        # port's class keeps it itself until a sharded render reads it
        assert tg.exchange_cap == js.exchange_cap, i
    assert logs[0] == logs[1] and logs[0]
    if case == "exchange_cap":
        assert tg.exchange_cap >= 6000  # grown from the caller's floor, never below it


@pytest.fixture(scope="module")
def port():
    """The port's train state from the fixture's untouched initial weights,
    whose scene Gaussians are meter-sized (a sparse cloud's KNN scales)."""
    twin = TwinFrame()
    j = twin.j
    tr = convert.trainables_from_jax(_fields(j.scene_state.params), _fields(j.human_params),
                                     _fields(j.param_frames), twin.t_cfg, device="cpu")
    opt = make_optimizer(tr, twin.t_cfg, 3.0, 100)
    return twin, tl.init_train_state(tr, twin.t_scene_aux, opt), opt


def test_grows_until_zero_drops_with_absurd_capacities(port):
    twin, state, opt = port
    state = copy.deepcopy(state)
    tiny = dataclasses.replace(twin.t_settings, max_per_tile=32, pairs_per_gaussian=1)
    gov = tl.RasterCapacityGovernor(tiny, patience=1)
    gen = torch.Generator().manual_seed(0)
    first = None
    for _ in range(8):
        state, losses = tl.train_step(state, twin.t_bundle, twin.t_frame(0), opt, twin.t_cfg,
                                      True, settings=gov.settings, generator=gen)
        d_pairs, d_trunc = float(losses["raster_dropped_pairs"]), float(losses["raster_truncated"])
        assert float(losses["raster_dropped"]) == d_pairs + d_trunc
        first = d_pairs + d_trunc if first is None else first
        if d_pairs == 0 and d_trunc == 0:
            break
        gov.update(d_pairs, d_trunc)
    assert first > 0, "the fixture must start in the overflow regime"
    assert d_pairs == 0 and d_trunc == 0, (d_pairs, d_trunc, gov.settings)
    assert gov.settings.pairs_per_gaussian > 1


def test_grow_scene_capacity_and_a_further_step(port):
    twin, state, opt = port
    state = copy.deepcopy(state)
    C = state.trainables.scene.mean.shape[0]
    state, _ = tl.train_step(state, twin.t_bundle, twin.t_frame(0), opt, twin.t_cfg, True,
                             settings=twin.t_settings, bg=torch.full((3,), 0.5))
    old = {k: p.detach().clone() for k, p in state.trainables.named_parameters()}
    old_mu = {k: v.clone() for k, v in state.opt_state.mu.items()}
    assert tl.grow_scene_capacity(state, C) is state
    with pytest.raises(ValueError):
        tl.grow_scene_capacity(state, C - 1)
    grown = tl.grow_scene_capacity(state, 2 * C)
    sc = grown.trainables.scene
    names = {k for k, _ in grown.trainables.named_parameters()}
    assert names == set(old) and len(names) == 79
    for k, p in grown.trainables.named_parameters():
        if k.startswith("scene."):
            assert p.shape[0] == 2 * C and isinstance(p, torch.nn.Parameter) and p.requires_grad
            assert torch.equal(p[:C].detach(), old[k])
            for m in (grown.opt_state.mu[k], grown.opt_state.nu[k]):
                assert m.shape == p.shape and not m[C:].any()
            assert torch.equal(grown.opt_state.mu[k][:C], old_mu[k])
        else:
            assert torch.equal(p.detach(), old[k]) and grown.opt_state.mu[k] is not None
    # new rows: dead, zero, identity 6D rotations
    assert not grown.scene_aux.live[C:].any() and grown.scene_aux.live.shape == (2 * C,)
    assert grown.scene_aux.live.dtype == torch.bool
    assert not sc.mean[C:].any() and not sc.opacity[C:].any()
    assert torch.equal(sc.rotation[C:].detach(),
                       torch.tensor([1.0, 0, 0, 0, 1, 0]).repeat(C, 1))
    assert grown.opt_state.count == 1 and grown.itr == 1
    # one more step and a densify pass at the new capacity
    grown, losses = tl.train_step(grown, twin.t_bundle, twin.t_frame(0), opt, twin.t_cfg, False,
                                  settings=twin.t_settings, bg=torch.full((3,), 0.5))
    assert np.isfinite(float(losses["total"])) and grown.opt_state.count == 2
    assert not grown.opt_state.mu["scene.mean"][C:].any()  # dead rows get no gradient
    cfg = twin.t_cfg
    aux = dataclasses.replace(grown.scene_aux, xyz_grad_accum=torch.ones(2 * C),
                              track_cnt=torch.ones(2 * C))
    grown, stats = tl.maybe_adjust_gaussians(
        grown._replace(scene_aux=aux), cfg.densify_start_itr + cfg.densify_interval, cfg,
        generator=torch.Generator().manual_seed(1))
    assert stats is not None and int(stats["n_live"]) > 0 and int(stats["n_dropped"]) == 0
    assert int(stats["n_live"]) == int(grown.scene_aux.live.sum()) > 200
    assert all(bool(torch.isfinite(p).all()) for p in grown.trainables.parameters())
