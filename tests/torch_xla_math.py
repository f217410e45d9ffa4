"""A test seam that gives the port the JAX package's transcendentals.

``with xla_transcendentals(): ...`` replaces ``torch.exp``, ``torch.log``,
``torch.log1p``, ``torch.tan``, ``torch.atan``, ``torch.sin``,
``torch.cos``, ``torch.tanh``, ``torch.sigmoid`` and ``torch.atan2`` (and
the ``Tensor`` methods of the same names) for the duration of the block:
the transcendentals that the port's rasterizer (exp, log, log1p, tan,
atan), ``human_forward`` (exp, tanh, sin, cos, atan2), the scene's
densification (exp, log, sigmoid) and the fitting (sin, cos, atan2) call.
On float32 CPU tensors of one shape each replacement computes its value
with ``jax.jit`` of the JAX package's function (``jnp.exp``,
``jnp.arctan``, ``jax.nn.sigmoid``, ...) on the same numbers; any other
argument goes to the original function. Each replacement is a
``torch.autograd.Function`` whose backward is the function's own
derivative in torch (exp ``g*out``, log ``g/x``, log1p ``g/(1+x)``, tan
``g*(1+out^2)``, atan ``g/(1+x^2)``, sin ``g*cos x``, cos ``-g*sin x``,
tanh ``(g+g*out)(1-out)``, sigmoid ``g*out*(1-out)``, atan2(a, b)
``g*b/(a^2+b^2)`` and ``-g*a/(a^2+b^2)``; the cos and sin being the
seam's while it is active): the derivative rules of JAX's own primitives.
``sqrt`` is correctly rounded in both libraries and needs no entry.

Why: the port computes what the JAX package computes, expression for
expression, but the float32 ``exp`` of XLA's CPU backend and the one of
torch's CPU kernels round differently, and torch's differs again between its
vectorised and scalar loops (which one runs depends on the ISA and on the
tensor's shape). On 1M float32 arguments in [-6, 0], ``jax.jit(jnp.exp)``
differs from the correctly rounded value on 97,324, torch's vectorised
``exp`` on 10,043 and its scalar path (a 7-element tensor) on none. One ulp
of ``ndc_x`` moves a pixel coordinate near 0 by 1.5e-5 at W = 256, and a
few ulps of alpha move a golden pixel by 1e-6 to 3e-6: the comparisons at
1e-6 (img, mask), 1e-5 (depth) and 1e-5 (projection) failed or passed with
the host. XLA emits each function alone as its own polynomial code, the same
on every host and for every array length: the JAX reference run op by op
reproduces tests/goldens/scene*.npz, made on another host, to 0.0 (the same
reference jitted as one program, whose fusions evaluate otherwise, is up to
2.6e-6 off them). Under the seam the port's renders of the goldens come
within 1.2e-7 to 3.0e-7 (img), 1.8e-7 to 4.2e-7 (mask) and 6.0e-7 to
8.3e-7 (depth), and its projection's mean2d equals JAX's (params within
7.2e-7; 6.1e-5 without the seam). A failure under the seam is a fault of
the port; a failure of a test's case without it is a math library's
rounding beyond the bound that case states.

Test code: it imports JAX, and the port never imports it.
"""
from __future__ import annotations

import contextlib
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# torch name -> (the JAX function, backward(g, *inputs, out) -> input grads)
_FNS = {
    "exp": (jnp.exp, lambda g, x, y: (g * y,)),
    "log": (jnp.log, lambda g, x, y: (g / x,)),
    "log1p": (jnp.log1p, lambda g, x, y: (g / (1.0 + x),)),
    "tan": (jnp.tan, lambda g, x, y: (g * (1.0 + y * y),)),
    "atan": (jnp.arctan, lambda g, x, y: (g / (1.0 + x * x),)),
    "sin": (jnp.sin, lambda g, x, y: (g * torch.cos(x),)),
    "cos": (jnp.cos, lambda g, x, y: (-g * torch.sin(x),)),
    "tanh": (jnp.tanh, lambda g, x, y: ((g + g * y) * (1.0 - y),)),
    "sigmoid": (jax.nn.sigmoid, lambda g, x, y: (g * (y * (1.0 - y)),)),
    "atan2": (jnp.arctan2, lambda g, a, b, y: (g * (b / (a * a + b * b)),
                                              g * (-a / (a * a + b * b)))),
}
NAMES = tuple(_FNS)
_MIN_BUCKET = 256


@functools.lru_cache(maxsize=None)
def _jitted(name):
    return jax.jit(_FNS[name][0])


def _xla_values(name: str, *xs: torch.Tensor) -> torch.Tensor:
    """XLA's values of ``name`` at xs (all of one shape). The flat inputs
    are padded to a power of two, so a few compiles serve every shape:
    XLA's result for an element does not depend on the array's length."""
    n = xs[0].numel()
    size = max(_MIN_BUCKET, 1 << max(n - 1, 0).bit_length())
    flat = [np.pad(x.detach().reshape(-1).numpy(), (0, size - n)) for x in xs]
    y = np.asarray(_jitted(name)(*flat))[:n]
    return torch.from_numpy(y.copy()).reshape(xs[0].shape)


@functools.lru_cache(maxsize=None)
def _autograd_fn(name: str):
    backward = _FNS[name][1]

    def forward(*xs):
        return _xla_values(name, *xs)

    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, output)

    def bwd(ctx, g):
        return backward(g, *ctx.saved_tensors)

    def vmap(info, in_dims, *xs):
        # elementwise: every input batched along dim 0, the output too
        xs = [x.movedim(d, 0) if d is not None
              else x.expand(info.batch_size, *x.shape) for x, d in zip(xs, in_dims)]
        return fn.apply(*xs), 0

    fn = type(f"Xla_{name}", (torch.autograd.Function,), {
        "forward": staticmethod(forward), "setup_context": staticmethod(setup_context),
        "backward": staticmethod(bwd), "vmap": staticmethod(vmap)})
    return fn


def _routes_to_xla(xs, kw) -> bool:
    return (not kw and all(isinstance(x, torch.Tensor) and x.dtype == torch.float32
                           and x.device.type == "cpu" and x.shape == xs[0].shape
                           for x in xs))


def _replacement(original, fn):
    @functools.wraps(original)
    def call(*xs, **kw):
        if _routes_to_xla(xs, kw):
            return fn.apply(*xs)
        return original(*xs, **kw)

    return call


@contextlib.contextmanager
def xla_transcendentals(enabled: bool = True):
    """Within the block, the port's float32 CPU transcendentals are XLA's.
    ``enabled=False`` is a no-op, for a test's case on the port's own libm."""
    if not enabled:
        yield
        return
    saved = []
    try:
        for name in NAMES:
            fn = _autograd_fn(name)
            for owner in (torch, torch.Tensor):
                original = getattr(owner, name)
                saved.append((owner, name, original))
                setattr(owner, name, _replacement(original, fn))
        yield
    finally:
        for owner, name, original in reversed(saved):
            setattr(owner, name, original)


def seam_cases(*axes):
    """pytest params for the product of ``axes`` (each a dict of id ->
    value, or a list of strings, each its own id) and a last argument
    ``seam``: every combination under the seam, with the id it had before
    the seam existed, then on the port's own libm, its id ending in
    ``torch_libm``."""
    axes = [a.items() if isinstance(a, dict) else [(v, v) for v in a] for a in axes]
    cases = []
    for seam in (True, False):
        for combo in itertools.product(*axes):
            tag = "-".join(k for k, _ in combo) + ("" if seam else "-torch_libm")
            cases.append(pytest.param(*(v for _, v in combo), seam, id=tag))
    return cases
