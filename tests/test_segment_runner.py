"""The XLA segment runner ``Grape(method="Adam")`` drives
(optim/adam.py::make_segment_runner), on every exact-gradient engine,
against a float64 numpy oracle of the same forward model: loss, regularized
loss, gradient and the first Adam step, across the reference's seven cost
terms in state-transfer and unitary mode; plus V=16 concerned vectors,
segment composition, the convergence predicates and checkpoint resume."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import qoc_tpu as q
from qoc_tpu.models.forward import make_forward
from qoc_tpu.models.system import ControlProblem
from qoc_tpu.optim.adam import (
    init_adam_state,
    make_adam_optimizer,
    make_segment_runner,
)
from qoc_tpu.optim.convergence import ConvergenceSettings

ENGINES = ("scan", "associative", "pscan")


# --------------------------------------------------------------------------
# float64 numpy oracle of models/forward.py + models/costs.py
# --------------------------------------------------------------------------


def oracle_reg_loss(p, u, rc):
    """(fidelity loss, regularized loss) in float64 for pulse base ``u``."""
    rc = rc or {}
    mats = np.asarray(p.mats, np.float64)
    ow = np.sin(np.asarray(u, np.float64))
    w = np.concatenate([np.ones((1, p.steps)),
                        np.asarray(p.ops_max_amp, np.float64)[:, None] * ow])
    psi0 = np.asarray(p.initial_vectors, np.float64)
    tgt = np.asarray(p.target_vectors, np.float64)
    N, M, V = p.state_num, psi0.shape[0], psi0.shape[1]
    vecs = [psi0]
    psi = psi0 if p.state_transfer else np.asarray(p.U0_iso, np.float64) @ psi0
    for t in range(p.steps):
        A = np.einsum("k,kij->ij", w[:, t], mats)
        if p.state_transfer:        # powers 0..terms-1, no squaring
            acc, pn = psi.copy(), psi
            for n in range(1, p.taylor_terms):
                pn = A @ pn / n
                acc = acc + pn
            psi = acc
        else:                       # powers 0..terms, then squarings
            X = A / 2.0 ** p.taylor_scaling
            E, Xn = np.eye(M), np.eye(M)
            for n in range(1, p.taylor_terms + 1):
                Xn = X @ Xn / n
                E = E + Xn
            for _ in range(p.taylor_scaling):
                E = E @ E
            psi = E @ psi
        vecs.append(psi)
    vecs = np.stack(vecs)                                    # [T+1, M, V]

    def ip(a, b):                   # |sum_v <a_v|b_v>|^2 / V^2 on the iso
        re = np.sum(a[:N] * b[:N] + a[N:] * b[N:])
        im = np.sum(a[N:] * b[:N] - a[:N] * b[N:])
        return (re * re + im * im) / (V * V)

    loss = 1.0 - ip(vecs[-1], tgt)
    T, dt = p.steps, p.dt
    pad = np.pad(ow, ((0, 0), (2, 2)))
    reg = loss
    if "amplitude" in rc:
        reg += rc["amplitude"] / T * 0.5 * np.sum(ow ** 2)
    if "envelope" in rc:
        omg = np.asarray(p.one_minus_gauss, np.float64)
        reg += rc["envelope"] / T * 0.5 * np.sum((omg * ow) ** 2)
    if "dwdt" in rc:
        reg += rc["dwdt"] / T * 0.5 * np.sum((np.diff(pad, axis=1) / dt) ** 2)
    if "d2wdt2" in rc:
        d2 = (pad[:, 2:] - 2 * pad[:, 1:-1] + pad[:, :-2]) / dt ** 2
        reg += rc["d2wdt2"] / T * 0.5 * np.sum(d2 ** 2)
    if "bandpass" in rc:
        mag = np.abs(np.fft.fft(ow, axis=1))
        lo, hi = (np.asarray(rc["band"]) * p.total_time).astype(int)
        reg += rc["bandpass"] / T * (np.sum(mag[:, :lo])
                                     + np.sum(mag[:, hi:T // 2]))
    if "forbidden_coeff_list" in rc:
        fv = vecs
        if rc.get("forbid_dressed") and p.v_sorted_iso is not None:
            fv = np.einsum("ji,tjv->tiv",
                           np.asarray(p.v_sorted_iso, np.float64), vecs)
        for c, s in zip(rc["forbidden_coeff_list"],
                        rc["states_forbidden_list"]):
            pop = fv[:, s, :] ** 2 + fv[:, N + s, :] ** 2
            reg += c / T * 0.5 * np.sum(pop ** 2)
    if "speed_up" in rc:
        ip3 = sum(ip(v, tgt) for v in vecs)
        reg += rc["speed_up"] / T * 0.5 * (T + 1 - ip3) ** 2
    return loss, reg


def oracle_grad(p, u, rc, h=1e-6):
    """Central differences of the float64 regularized loss."""
    u = np.asarray(u, np.float64)
    g = np.zeros_like(u)
    for idx in np.ndindex(*u.shape):
        up, um = u.copy(), u.copy()
        up[idx] += h
        um[idx] -= h
        g[idx] = (oracle_reg_loss(p, up, rc)[1]
                  - oracle_reg_loss(p, um, rc)[1]) / (2 * h)
    return g


# --------------------------------------------------------------------------
# problems
# --------------------------------------------------------------------------


def leakage_problem(state_transfer, steps=16, dressed=False):
    """3-level ladder with a leakage level (regularization_functions.py
    71-85's use case); unitary mode runs one squaring."""
    a = q.annihilate(3)
    H0 = np.diag([0.0, 1.0, 1.95]) * 2 * np.pi
    if dressed:
        H0 = H0 + 0.3 * (a + a.conj().T)
    Hops = [a + a.conj().T, 1j * (a - a.conj().T)]
    kw = {"maxA": [0.5, 0.5], "seed": 0}
    if dressed:
        w_c, v_c, dressed_id = q.get_dressed_info(H0)
        kw["dressed_info"] = {"eigenvectors": v_c, "eigenvalues": np.real(w_c),
                              "dressed_id": dressed_id, "is_dressed": True}
    if state_transfer:
        psi0 = np.zeros(3, complex)
        psi0[0] = 1
        tgt = np.zeros(3, complex)
        tgt[1] = 1
        return ControlProblem.build(H0, Hops, ["x", "y"], [tgt], 3.0, steps,
                                    [psi0], state_transfer=True, **kw)
    return ControlProblem.build(H0, Hops, ["x", "y"],
                                q.transmon_gate(q.SIGMA_X, 3), 3.0, steps,
                                [0, 1], Taylor_terms=[6, 1], **kw)


FORB = {"forbidden_coeff_list": [5.0], "states_forbidden_list": [2]}
COSTS = {
    "fidelity": None,
    "amplitude": {"amplitude": 0.2},
    "envelope": {"envelope": 0.3},
    "dwdt": {"dwdt": 0.005},
    "d2wdt2": {"d2wdt2": 1e-5},
    "bandpass": {"bandpass": 0.5, "band": [0.5, 2.0]},
    "forbidden": FORB,
    "speed_up": {"speed_up": 2.0},
    "all_seven": dict(FORB, amplitude=0.05, envelope=0.02, dwdt=0.001,
                      d2wdt2=1e-7, bandpass=0.2, band=[0.5, 2.0],
                      speed_up=0.5),
}
MODES = {"state": True, "unitary": False}


def _conv(**over):
    base = {"rate": 0.01, "update_step": 10, "max_iterations": 200,
            "conv_target": 1e-12}
    base.update(over)
    return ConvergenceSettings.from_dict(base)


def _runner(problem, rc, engine, conv):
    _, loss_fn = make_forward(problem, reg_coeffs=rc, engine=engine,
                              lean=True)
    opt = make_adam_optimizer(conv)
    run_seg, _ = make_segment_runner(loss_fn, conv, opt)
    return loss_fn, opt, run_seg


def _check_against_oracle(problem, rc, engine):
    conv = _conv()
    loss_fn, opt, run_seg = _runner(problem, rc, engine, conv)
    u0 = np.asarray(problem.u0_base)
    st = run_seg(init_adam_state(u0, opt), jnp.asarray(1, dtype=jnp.int32))
    loss64, reg64 = oracle_reg_loss(problem, u0, rc)
    g64 = oracle_grad(problem, u0, rc)

    # metrics are evaluated at the pre-update iterate (run_session.py:56-58)
    np.testing.assert_allclose(float(st.loss), loss64, atol=1e-5)
    np.testing.assert_allclose(float(st.reg_loss), reg64,
                               rtol=1e-5, atol=1e-5)
    g = np.asarray(jax.grad(lambda x: loss_fn(x)[0])(jnp.asarray(u0)))
    scale = np.max(np.abs(g64))
    assert np.max(np.abs(g - g64)) <= 1e-4 * scale + 1e-7
    np.testing.assert_allclose(float(st.grad_squared),
                               0.5 * np.sum(g64 ** 2), rtol=1e-3)
    # first Adam step: u1 = u0 - lr * g / (|g| + eps), wherever the sign of
    # the gradient is resolved in float32
    u1 = u0 - conv.rate * g64 / (np.abs(g64) + 1e-8)
    sure = np.abs(g64) > 1e-3 * scale
    np.testing.assert_allclose(np.asarray(st.u_base)[sure], u1[sure],
                               atol=1e-5)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("cost", list(COSTS))
def test_matches_float64_oracle(cost, mode, engine):
    _check_against_oracle(leakage_problem(MODES[mode]), COSTS[cost], engine)


@pytest.mark.parametrize("engine", ENGINES)
def test_forbidden_dressed_matches_float64_oracle(engine):
    rc = dict(FORB, forbid_dressed=True)
    _check_against_oracle(leakage_problem(False, dressed=True), rc, engine)


@pytest.mark.parametrize("engine", ENGINES)
def test_sixteen_concerned_vectors(engine):
    """V=16: every basis state of a dim-16 gate is a concerned vector."""
    N = 16
    rng = np.random.default_rng(0)
    A_ = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
    H0 = (A_ + A_.conj().T) / 8
    Hop = np.diag(np.arange(N, dtype=float)) / 4
    U = np.eye(N, dtype=complex)
    U[:2, :2] = [[0, 1], [1, 0]]
    p = ControlProblem.build(
        H0, [Hop], ["a"], U, 2.0, 4, list(range(N)), maxA=[1.0], seed=0,
        Taylor_terms=[8, 1])
    assert p.initial_vectors.shape[1] == 16
    _check_against_oracle(p, {"dwdt": 0.001}, engine)


@pytest.mark.parametrize("engine", ENGINES)
def test_segments_compose(engine):
    """3 segments of 10 == 1 segment of 30 (state carries across calls)."""
    problem = leakage_problem(True)
    _, opt, run_seg = _runner(problem, None, engine, _conv())
    a = run_seg(init_adam_state(problem.u0_base, opt),
                jnp.asarray(30, dtype=jnp.int32))
    b = init_adam_state(problem.u0_base, opt)
    for stop in (10, 20, 30):
        b = run_seg(b, jnp.asarray(stop, dtype=jnp.int32))
    assert int(b.iteration) == 30
    np.testing.assert_allclose(np.asarray(a.u_base), np.asarray(b.u_base),
                               atol=1e-6)


@pytest.mark.parametrize("engine", ENGINES)
def test_convergence_freezes_iterate(engine):
    """An immediately satisfied conv_target: metrics evaluated, no update."""
    problem = leakage_problem(True)
    _, opt, run_seg = _runner(problem, None, engine, _conv(conv_target=2.0))
    st = run_seg(init_adam_state(problem.u0_base, opt),
                 jnp.asarray(10, dtype=jnp.int32))
    assert bool(st.done) and int(st.iteration) == 0
    np.testing.assert_array_equal(np.asarray(st.u_base),
                                  np.asarray(problem.u0_base))
    assert np.isfinite(float(st.loss))


@pytest.mark.parametrize("engine", ENGINES)
def test_max_iterations_predicate(engine):
    problem = leakage_problem(True)
    _, opt, run_seg = _runner(problem, None, engine, _conv(max_iterations=7))
    st = run_seg(init_adam_state(problem.u0_base, opt),
                 jnp.asarray(20, dtype=jnp.int32))
    assert bool(st.done) and int(st.iteration) == 7


def test_resume_round_trip(tmp_path):
    """Grape(save=True) checkpoints every update_step; resuming from the
    run file continues the same trajectory as an uninterrupted run."""
    kw = dict(state_transfer=True, maxA=[0.5, 0.5], seed=0,
              show_plots=False, method="Adam")
    a = q.annihilate(3)
    args = (np.diag([0.0, 1.0, 1.95]) * 2 * np.pi,
            [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"],
            [np.eye(3)[1].astype(complex)], 3.0, 16,
            [np.eye(3)[0].astype(complex)])
    conv = {"rate": 0.01, "update_step": 10, "conv_target": 1e-12}
    first = q.Grape(*args, **kw, convergence=dict(conv, max_iterations=10),
                    save=True, data_path=str(tmp_path), file_name="r")
    resumed = q.Grape(*args, **kw, convergence=dict(conv, max_iterations=20),
                      save=False, resume_from=first.file_path)
    straight = q.Grape(*args, **kw, convergence=dict(conv, max_iterations=20),
                       save=False)
    assert resumed.iterations == straight.iterations == 20
    np.testing.assert_allclose(resumed.u_base, straight.u_base, atol=1e-6)
