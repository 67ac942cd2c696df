"""The column-batched xla-cols backend (the GPU seed-batch path) against
the vmapped xla backend through the public batched runner: same per-seed
losses, pulses and convergence flags after the same Adam segment, across
extra sweep channels, per-seed freezing, unitary scaling, multi-vector
targets, column padding and the trajectory costs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import qoc_tpu as q
from qoc_tpu.models.system import ControlProblem
from qoc_tpu.ops.isomorphism import c_to_r_mat
from qoc_tpu.optim.convergence import ConvergenceSettings
from qoc_tpu.parallel.batch import init_seeds, make_batched_runner


def pi_problem(steps=16):
    return ControlProblem.build(
        np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y], ["x", "y"],
        [np.array([0, 1], dtype=complex)], 2.0, steps,
        [np.array([1, 0], dtype=complex)],
        state_transfer=True, maxA=[0.7, 0.7], seed=0)


def leakage_problem(steps=12):
    a = q.annihilate(3)
    psi0 = np.zeros(3, complex)
    psi0[0] = 1
    tgt = np.zeros(3, complex)
    tgt[1] = 1
    return ControlProblem.build(
        np.diag([0.0, 1.0, 1.95]) * 2 * np.pi,
        [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"], [tgt],
        2.0, steps, [psi0], state_transfer=True, maxA=[0.5, 0.5], seed=0)


def cnot_problem(scaling):
    CNOT = np.eye(4, dtype=complex)
    CNOT[2:, 2:] = [[0, 1], [1, 0]]
    XI = np.kron(q.SIGMA_X, np.eye(2))
    IX = np.kron(np.eye(2), q.SIGMA_X)
    ZZ = np.kron(q.SIGMA_Z, q.SIGMA_Z)
    return ControlProblem.build(
        np.zeros((4, 4), dtype=complex), [XI, IX, ZZ], ["xi", "ix", "zz"],
        CNOT, 4.0, 12, [0, 1, 2, 3], maxA=[1.0] * 3, seed=0,
        Taylor_terms=[8, scaling], no_scaling=scaling == 0)


def two_vector_problem():
    psi0s = [np.array([1, 0], dtype=complex), np.array([0, 1], dtype=complex)]
    tgts = [np.array([0, 1], dtype=complex), np.array([1, 0], dtype=complex)]
    return ControlProblem.build(
        np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y], ["x", "y"],
        tgts, 2.0, 16, psi0s, state_transfer=True, maxA=[0.7, 0.7], seed=0)


SCENARIOS = {
    # name: (problem builder, reg_coeffs, seeds, conv overrides)
    "pi_pulse": (pi_problem, None, 8, {}),
    "per_seed_freezing": (pi_problem, None, 8,
                          {"rate": 0.05, "conv_target": 0.22}),
    "max_iterations": (pi_problem, None, 4, {"max_iterations": 5}),
    "cnot_unitary_scaling": (lambda: cnot_problem(2), None, 3, {}),
    "cnot_no_scaling_smoothness": (lambda: cnot_problem(0),
                                   {"dwdt": 0.01, "envelope": 0.1}, 3, {}),
    "two_vectors": (two_vector_problem, None, 4, {}),
    "column_padding": (pi_problem, None, 130, {}),
    "pulse_costs": (pi_problem, {"amplitude": 0.3, "envelope": 0.2,
                                 "dwdt": 0.05, "d2wdt2": 0.001,
                                 "bandpass": 0.1, "band": [0.1, 3.0]}, 4, {}),
    "forbidden": (leakage_problem, {"forbidden_coeff_list": [4.0],
                                    "states_forbidden_list": [2],
                                    "dwdt": 0.01}, 3, {}),
    "speed_up": (leakage_problem, {"speed_up": 0.05, "amplitude": 0.02},
                 3, {}),
}


def _conv(**over):
    base = {"rate": 0.01, "update_step": 10, "max_iterations": 100,
            "conv_target": 1e-12}
    base.update(over)
    return ConvergenceSettings.from_dict(base)


def _segment(problem, conv, backend, u0, n, reg_coeffs=None, mats_b=None,
             extra_mats=None, sweep=False):
    init, run = make_batched_runner(
        problem, conv, reg_coeffs=reg_coeffs, backend=backend,
        extra_channel_mats=extra_mats, sweep_mats=sweep)
    return run(init(jnp.asarray(u0)), jnp.asarray(n, dtype=jnp.int32),
               mats_b)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_cols_matches_vmapped(name):
    build, rc, S, over = SCENARIOS[name]
    problem = build()
    conv = _conv(**over)
    u0 = np.asarray(init_seeds(problem, S, jax.random.PRNGKey(7)))
    cols = _segment(problem, conv, "xla-cols", u0, 12, reg_coeffs=rc)
    ref = _segment(problem, conv, "xla", u0, 12, reg_coeffs=rc)
    assert int(cols.iteration) == int(ref.iteration)
    np.testing.assert_array_equal(np.asarray(cols.done), np.asarray(ref.done))
    np.testing.assert_allclose(np.asarray(cols.loss), np.asarray(ref.loss),
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(cols.reg_loss),
                               np.asarray(ref.reg_loss), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(cols.u_base),
                               np.asarray(ref.u_base), atol=5e-4)
    if name == "per_seed_freezing":
        done = np.asarray(cols.done)
        assert done.any() and not done.all()


def test_extra_channels_match_per_seed_generators():
    """A constant-weight extra channel on xla-cols is the same Hamiltonian
    sweep as per-seed generator stacks (drift + w_s * extra) on the
    vmapped backend."""
    problem = pi_problem()
    S = 4
    num = c_to_r_mat(-1j * problem.dt * np.diag([0.0, 1.0])).astype(
        np.float32)
    ew = np.linspace(-0.3, 0.3, S)[:, None].astype(np.float32)
    mats_b = np.repeat(np.asarray(problem.mats)[None], S, axis=0)
    mats_b[:, 0] += ew[:, :, None] * num[None]
    u0 = np.asarray(init_seeds(problem, S, jax.random.PRNGKey(3)))
    conv = _conv()
    cols = _segment(problem, conv, "xla-cols", u0, 8,
                    mats_b=jnp.asarray(ew), extra_mats=num[None])
    ref = _segment(problem, conv, "xla", u0, 8, mats_b=jnp.asarray(mats_b),
                   sweep=True)
    np.testing.assert_allclose(np.asarray(cols.loss), np.asarray(ref.loss),
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(cols.u_base),
                               np.asarray(ref.u_base), atol=5e-4)
