"""Platform query, engine names and routing announcements.

The reference prints its device placement and Taylor-term decisions
(main_grape/grape.py:53, core/system_parameters.py:233-238).  The more
consequential decision HERE is which compute engine a run lands on, so
every run/batch prints ONE line naming the choice.

``on_gpu`` is the one place the program asks which platform it runs on;
the engine ladders (ops/propagation.py) and the batch router
(parallel/batch.py) take its answer.

Set ``QOC_TPU_QUIET=1`` to silence the routing lines (tests that parse
stdout, embedding in notebooks, ...).
"""

from __future__ import annotations

import os

ENGINES = ("auto", "pscan", "associative", "scan")
BACKENDS = ("auto", "xla-cols", "xla")


def on_gpu() -> bool:
    """True when JAX's default backend is an NVIDIA GPU.  Every other
    platform takes the CPU choices (serial scan engines, vmapped batch)."""
    import jax

    return jax.default_backend() == "gpu"


def check_engine(engine: str) -> str:
    if engine not in ENGINES:
        raise ValueError(
            f"engine {engine!r} does not exist; the engines are "
            + ", ".join(ENGINES))
    return engine


def check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(
            f"batch backend {backend!r} does not exist; the backends are "
            + ", ".join(BACKENDS))
    return backend


def announce(kind: str, choice: str) -> str:
    """Print and return the one-line routing decision."""
    line = f"[qoc-tpu] {kind}: {choice}"
    if os.environ.get("QOC_TPU_QUIET", "") != "1":
        print(line)
    return line


def resolve_single_engine(problem, gradient_mode: str, engine: str) -> str:
    """The concrete engine name the Grape forward resolves to — delegates
    to the same ladder functions (ops/propagation.py resolve_*_engine)
    models/forward.py uses, so the announcement cannot drift from what
    actually runs."""
    from .ops.propagation import (resolve_state_engine,
                                  resolve_unitary_engine)

    check_engine(engine)
    if engine != "auto":
        return engine
    p = problem
    M = 2 * p.state_num
    if p.state_transfer:
        return resolve_state_engine(M, p.steps, gradient_mode, on_gpu())
    if gradient_mode != "exact":
        return resolve_unitary_engine(M, p.steps, 0, "reference", False)
    return resolve_unitary_engine(M, p.steps, p.taylor_scaling,
                                  gradient_mode, on_gpu())
