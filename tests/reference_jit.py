"""``jax.jit`` for the reference programs the port's tests compare against.

The tests compile many small reference programs (one per configuration or
cluster shape) and run each a few times, so XLA's compile time dominates
them.  These programs are compiled with the backend's optimisation passes
off, which roughly halves the compile time (the reference's single defrag
decisions: 53.5 s -> 23.3 s for 40 random clusters on an 8-core CPU) and
gives the same results: the decisions are bit-identical, and the model
outputs stay within each test's stated tolerance.
"""

import functools

import jax

#: XLA compile options of the reference programs in the port's tests
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}

jit = functools.partial(jax.jit, compiler_options=FAST_COMPILE)
