"""The reference agrees with the program's CPU path at a tiny size, and the
lower-precision control (TF32, emulated off the card) fails the limits.

The rasterizer is held alone too: the reference's blocked compositor with
its closed-form backward against the program's plain versions (CPU tensors
run them), pair-major and dense, outputs and input gradients."""
from types import SimpleNamespace

import pytest
import torch

import control
import tiny
from reference.ops.rasterizer import api as ref_api
from test_portbench_counts import H, W, scene


@pytest.mark.parametrize("pair_major", [True, False], ids=["pair_major", "dense"])
def test_rasterizer_against_the_program(pair_major):
    from exavatar_release_tpu_torch.ops.rasterizer import api as prog_api

    args = scene(60, 5)
    settings = prog_api.RasterizeSettings(pair_major=pair_major)
    outs, grads = [], []
    for rasterize, kw in ((ref_api.rasterize, {}), (prog_api.rasterize, {"settings": settings})):
        params = [a.clone().requires_grad_(True) for a in args[:5]]
        offset = torch.zeros(60, 2, requires_grad=True)
        bg = torch.tensor([0.2, 0.5, 0.9], requires_grad=True)
        out = rasterize(*params, args[5], args[6], (H, W), bg, mean2d_offset=offset, **kw)
        g = torch.Generator().manual_seed(3)
        loss = sum((out[k] * torch.rand(out[k].shape, generator=g)).sum()
                   for k in ("img", "depth", "mask"))
        grads.append(torch.autograd.grad(loss, params + [offset, bg]))
        outs.append(out)
    for k in ("img", "depth", "mask"):
        assert torch.allclose(outs[0][k], outs[1][k], atol=2e-6, rtol=1e-5), k
    for a, b in zip(*grads):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * max(scale, 1e-6)


@pytest.mark.parametrize("mix", ["train_steady", "animate_motion"])
def test_program_passes_and_control_fails(mix):
    traffic = tiny.traffic(mix)
    env = SimpleNamespace(cfg=tiny.config(), traffic=traffic, device="cpu", seed=0,
                          log=lambda m: None)
    r = control.readings(env, 11)
    limits = traffic["limits"]
    assert all(r["program"][k] <= limits[k] for k in limits), r["program"]
    assert any(r["control"][k] > limits[k] for k in limits), r["control"]


@pytest.mark.cuda
@pytest.mark.parametrize("mix", ["train_steady", "animate_motion"])
def test_control_fails_on_the_card(mix):
    """The same on the card, where the control is TF32 itself."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is TF32 on the card")
    from exavatar_release_tpu_torch import cuda_build

    cuda_build.build()
    traffic = tiny.traffic(mix)
    env = SimpleNamespace(cfg=tiny.config(), traffic=traffic, device="cuda", seed=0,
                          log=lambda m: None)
    r = control.readings(env, 11)
    limits = traffic["limits"]
    assert all(r["program"][k] <= limits[k] for k in limits), r["program"]
    assert any(r["control"][k] > limits[k] for k in limits), r["control"]
