"""Routing decisions as pure functions: the engine ladders and the batch
router (by shape, gradient mode and platform), the names that exist, the
compile-cache directory, and the optional h5py dependency."""

import numpy as np
import pytest

import qoc_tpu as q
from qoc_tpu.models.system import ControlProblem
from qoc_tpu.ops.propagation import (resolve_state_engine,
                                     resolve_unitary_engine)
from qoc_tpu.parallel.batch import resolve_backend
from qoc_tpu.routing import BACKENDS, ENGINES, on_gpu


@pytest.mark.parametrize("M, T, mode, gpu, want", [
    (4, 1000, "exact", True, "associative"),       # pi pulse
    (10, 100, "exact", True, "associative"),       # leakage transmon
    (16, 1000, "exact", True, "pscan"),
    (120, 1000, "exact", True, "pscan"),           # config 4 at spec
    (400, 200, "exact", True, "pscan"),            # config 5 dim 200
    (4000, 1000, "exact", True, "scan"),           # past both memory caps
    (120, 1000, "reference", True, "scan"),
    (4, 1000, "exact", False, "scan"),             # CPU
    (120, 1000, "exact", False, "scan"),
])
def test_state_ladder(M, T, mode, gpu, want):
    assert resolve_state_engine(M, T, mode, gpu) == want


@pytest.mark.parametrize("M, T, scaling, mode, gpu, want", [
    (10, 100, 2, "exact", True, "associative"),    # leakage gate
    (8, 1000, 2, "exact", True, "associative"),    # CNOT class
    (128, 200, 2, "exact", True, "pscan"),         # dim-64 unitary
    (128, 200, 8, "exact", True, "associative"),   # 2^8 reps past the cap
    (128, 200, 2, "reference", True, "associative"),
    (128, 200, 2, "exact", False, "associative"),  # CPU: by memory
    (1024, 1000, 0, "exact", False, "scan"),
])
def test_unitary_ladder(M, T, scaling, mode, gpu, want):
    assert resolve_unitary_engine(M, T, scaling, mode, gpu) == want


def test_ladders_name_only_existing_engines():
    seen = set()
    for M in (2, 4, 16, 64, 200, 800, 3000):
        for T in (10, 1000, 10000):
            for mode in ("exact", "reference"):
                for gpu in (True, False):
                    seen.add(resolve_state_engine(M, T, mode, gpu))
                    for s in (0, 2, 6):
                        seen.add(resolve_unitary_engine(M, T, s, mode, gpu))
    assert seen <= set(ENGINES) - {"auto"}
    assert seen == {"scan", "associative", "pscan"}


def _state_problem(use_inter_vecs=True):
    return ControlProblem.build(
        np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y], ["x", "y"],
        [np.array([0, 1], dtype=complex)], 2.0, 8,
        [np.array([1, 0], dtype=complex)], state_transfer=True,
        maxA=[0.7, 0.7], seed=0, use_inter_vecs=use_inter_vecs)


@pytest.mark.parametrize("rc, mode, sweep, gpu, inter, want", [
    (None, "exact", False, True, True, "xla-cols"),
    ({"speed_up": 0.1}, "exact", False, True, True, "xla-cols"),
    (None, "exact", False, False, True, "xla"),            # CPU
    (None, "reference", False, True, True, "xla"),
    (None, "exact", True, True, True, "xla"),              # mats sweep
    ({"speed_up": 0.1}, "exact", False, True, False, "xla"),
])
def test_batch_router(rc, mode, sweep, gpu, inter, want):
    p = _state_problem(use_inter_vecs=inter)
    assert resolve_backend(p, rc, mode, sweep, gpu) == want


def test_cpu_is_not_gpu():
    assert not on_gpu()


@pytest.mark.parametrize("engine", ["mega", "tree", "chain"])
def test_removed_engine_names_raise(engine):
    with pytest.raises(ValueError, match="pscan, associative, scan"):
        q.Grape(np.zeros((2, 2), dtype=complex), [q.SIGMA_X], ["x"],
                [np.array([0, 1], dtype=complex)], 2.0, 8,
                [np.array([1, 0], dtype=complex)], state_transfer=True,
                maxA=[0.7], seed=0, save=False, show_plots=False,
                engine=engine, convergence={"max_iterations": 1})


@pytest.mark.parametrize("backend", ["mega", "pallas"])
def test_removed_backend_names_raise(backend):
    from qoc_tpu.parallel.batch import batched_grape_adam

    with pytest.raises(ValueError, match="xla-cols, xla"):
        batched_grape_adam(_state_problem(), 2, backend=backend,
                           convergence={"max_iterations": 1})


def test_backend_names():
    assert BACKENDS == ("auto", "xla-cols", "xla")


def test_compile_cache_honours_environment():
    assert q.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x"}) is None


def test_compile_cache_defaults_to_checkout():
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(q.__file__)))
    assert q.compile_cache_dir({}) == os.path.join(root, ".jax_cache")
    assert q.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == \
        os.path.join(root, ".jax_cache")


def test_compile_cache_is_configured():
    import jax

    want = q.compile_cache_dir()
    if want is not None:
        assert jax.config.jax_compilation_cache_dir == want


def test_save_without_h5py_names_it(tmp_path, monkeypatch):
    from qoc_tpu.utils import h5

    monkeypatch.setattr(h5, "HAVE_H5PY", False)
    with pytest.raises(ImportError, match="h5py"):
        q.Grape(np.zeros((2, 2), dtype=complex), [q.SIGMA_X], ["x"],
                [np.array([0, 1], dtype=complex)], 2.0, 8,
                [np.array([1, 0], dtype=complex)], state_transfer=True,
                maxA=[0.7], seed=0, save=True, data_path=str(tmp_path),
                file_name="r", show_plots=False,
                convergence={"max_iterations": 1})
