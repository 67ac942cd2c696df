"""qoc_tpu — quantum optimal control (GRAPE) on JAX/XLA.

A from-scratch JAX/XLA re-design of the capabilities of
SchusterLab/quantum-optimal-control (GRAPE-Tensorflow): batched Taylor
matrix-exponential propagation, parallel-in-time associative scans, exact
or reference-parity gradients, the full regularization stack,
Adam / (L-)BFGS / EVOLVE drivers, h5-compatible persistence, differential
verification, and a multi-seed batch layer over jax.sharding meshes.

Public surface mirrors the reference's star-import convenience
(quantum_optimal_control/__init__.py:1-4): ``from qoc_tpu import Grape``
plus the model-building kit.
"""

import os as _os


def compile_cache_dir(environ=_os.environ):
    """Where this package points JAX's persistent compilation cache.

    ``None`` when ``JAX_COMPILATION_CACHE_DIR`` is set: JAX reads that
    variable itself and nothing is set in code.  Otherwise a fixed
    directory inside the checkout, so every process of every run finds
    the programs an earlier one compiled."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")


if compile_cache_dir() is not None:
    import jax as _jax

    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())

from .grape import Grape, GrapeResult
from .models.system import ControlProblem
from .models.gates import (
    qft, hadamard, Hadamard, rz, rx, transmon_gate, concerned, is_binary,
    hamming_distance, base_n, baseN, basis_string, Basis, bin_string, Bin,
)
from .models.operators import (
    kron_all, kron_all_reference, multi_kron, append_separate_krons,
    nn_chain_kron, annihilate, create, number,
    SIGMA_X, SIGMA_Y, SIGMA_Z, SIGMA_P, SIGMA_M,
)
from .models.dressed import (
    get_dressed_info, sort_ev, get_state_index, dressed_unitary,
)
from .ops.isomorphism import c_to_r_mat, c_to_r_vec, r_to_c_mat, r_to_c_vec

__version__ = "0.1.0"
