"""One compile per check for the tests' JAX programs (imports no torch).

Run op by op, a JAX reference costs one XLA compile per operation; the tests
run each reference as one program instead, compiled with ``FAST_COMPILE``.
"""
from concurrent.futures import ThreadPoolExecutor

import jax

# XLA options for the tests' one-shot programs: they run once at a tiny size,
# so LLVM's optimisation passes cost more than they save
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def fast_jit(fn, **kw):
    """``jax.jit(fn, **kw)`` compiled with ``FAST_COMPILE``: one program for a
    reference that would cost a compile per operation run op by op."""
    return jax.jit(fn, compiler_options=FAST_COMPILE, **kw)


_COMPILERS = ThreadPoolExecutor(4)


def compile_async(jitted, *args, **kw):
    """Traces ``jitted`` for these arguments here and compiles it in a worker
    thread: XLA compiles without holding the GIL, so the next program's trace
    overlaps this one's compile. Returns a future of the compiled program,
    which takes the non-static arguments."""
    return _COMPILERS.submit(jitted.trace(*args, **kw).lower().compile)
