"""Loud input validation (round-5 hardening).

The reference validates exactly one thing — the initial-guess amplitude
bound (system_parameters.py:38-46) — and silently misbehaves on every
other malformed input (e.g. the README's 'forbidden' key spelling trap,
README.md:27 vs regularization_functions.py:71).  Every check here fails
fast with shape context instead.
"""

import numpy as np
import pytest

import qoc_tpu as q
from qoc_tpu.models.costs import validate_reg_coeffs
from qoc_tpu.models.system import ControlProblem


SX = np.array([[0, 1], [1, 0]], dtype=complex)
SY = np.array([[0, -1j], [1j, 0]], dtype=complex)
SZ = np.diag([1.0, -1.0]).astype(complex)


def _build(**kw):
    args = dict(
        H0=SZ, Hops=[SX, SY], Hnames=["x", "y"], U=SX,
        total_time=2.0, steps=10, states_concerned_list=[0],
        maxA=[4.0, 4.0], seed=0,
    )
    args.update(kw)
    return ControlProblem.build(**args)


def test_non_square_h0():
    with pytest.raises(ValueError, match=r"square.*\(2, 3\)"):
        _build(H0=np.zeros((2, 3)))


def test_hops_shape_mismatch():
    with pytest.raises(ValueError, match=r"Hops\[1\].*\(3, 3\)"):
        _build(Hops=[SX, np.zeros((3, 3))], maxA=[4.0, 4.0])


def test_hnames_length_mismatch():
    with pytest.raises(ValueError, match="Hnames has 1 entries for 2 Hops"):
        _build(Hnames=["x"])


def test_maxA_length_mismatch():
    with pytest.raises(ValueError, match=r"maxA has length 1.*K=2"):
        _build(maxA=[4.0])


def test_state_index_out_of_range():
    with pytest.raises(ValueError, match=r"states_concerned_list\[0\]=5"):
        _build(states_concerned_list=[5])


def test_state_transfer_vector_length():
    with pytest.raises(ValueError, match="state-transfer mode takes state "
                                         "VECTORS"):
        _build(state_transfer=True, states_concerned_list=[[1, 0, 0]],
               U=[[0, 1]])


def test_target_unitary_shape():
    with pytest.raises(ValueError, match=r"target U has shape \(3, 3\)"):
        _build(U=np.eye(3))


def test_u0_shape():
    with pytest.raises(ValueError, match=r"U0 has shape \(3, 3\)"):
        _build(U0=np.eye(3))


def test_bad_steps_and_time():
    with pytest.raises(ValueError, match="steps must be positive"):
        _build(steps=0)
    with pytest.raises(ValueError, match="total_time must be positive"):
        _build(total_time=0.0)


def test_non_hermitian_drift_warns():
    H_bad = np.array([[0.0, 1.0], [0.0, 0.0]], dtype=complex)
    with pytest.warns(UserWarning, match="not Hermitian"):
        _build(H0=H_bad)


def test_initial_guess_exceeds_maxA():
    with pytest.raises(ValueError, match="strength > max_amp"):
        _build(initial_guess=np.full((2, 10), 5.0))


# --- reg_coeffs validation -------------------------------------------------


def test_unknown_reg_key_suggests_nearest():
    with pytest.raises(KeyError, match="did you mean 'forbidden"):
        validate_reg_coeffs({"forbiden_coeff_list": [1.0],
                             "states_forbidden_list": [1]})


def test_reg_typo_amplitude():
    with pytest.raises(KeyError, match="did you mean 'amplitude'"):
        validate_reg_coeffs({"amplitudes": 0.1})


def test_forbidden_requires_states_list():
    with pytest.raises(ValueError, match="states_forbidden_list"):
        validate_reg_coeffs({"forbidden_coeff_list": [1.0]})


def test_forbidden_length_mismatch():
    with pytest.raises(ValueError, match="2 coefficients for 1"):
        validate_reg_coeffs({"forbidden_coeff_list": [1.0, 2.0],
                             "states_forbidden_list": [1]})


def test_forbidden_state_out_of_range():
    with pytest.raises(ValueError, match=r"states_forbidden_list\[0\]=9"):
        validate_reg_coeffs({"forbidden_coeff_list": [1.0],
                             "states_forbidden_list": [9]}, state_num=4)


def test_bandpass_requires_band():
    with pytest.raises(ValueError, match="'band'"):
        validate_reg_coeffs({"bandpass": 0.1})


def test_readme_forbidden_alias_accepted():
    # the README's documented spelling is a valid alias (SURVEY sec 2.5)
    validate_reg_coeffs({"forbidden": [1.0], "states_forbidden_list": [1]},
                        state_num=4)


def test_grape_validates_reg_coeffs_early(tmp_path):
    with pytest.raises(KeyError, match="did you mean"):
        q.Grape(SZ, [SX], ["x"], SX, 2.0, 10, [0], maxA=[4.0],
                save=False, show_plots=False, seed=0,
                reg_coeffs={"dwdt2": 0.1},
                convergence={"max_iterations": 2, "update_step": 2})


# --- routing announcements -------------------------------------------------


def test_routing_line_fires_on_fallback(capsys):
    """The batch router prints the backend it chose; off the GPU it falls
    back to the vmapped xla backend."""
    from qoc_tpu.parallel.batch import batched_grape_adam

    a = q.annihilate(3)
    psi0 = np.zeros(3, complex)
    psi0[0] = 1
    tgt = np.zeros(3, complex)
    tgt[1] = 1
    problem = ControlProblem.build(
        np.diag([0.0, 1.0, 1.9]), [a + a.conj().T], ["x"], [tgt],
        2.0, 8, [psi0], state_transfer=True, maxA=[1.0], seed=0,
        use_inter_vecs=False,
    )
    out = batched_grape_adam(
        problem, n_seeds=2,
        convergence={"rate": 0.05, "update_step": 4, "max_iterations": 4,
                     "conv_target": 1e-10},
        seed=0,
    )
    cap = capsys.readouterr().out
    assert "[qoc-tpu] batch backend: xla (vmapped generic forward)" in cap
    assert np.all(np.isfinite(out["losses"]))


def test_resolved_engine_attribute_matches_routing():
    """make_forward's .resolved_engine and routing.resolve_single_engine
    come from the same ladder functions — assert they agree across modes
    (drift here would make the printed routing line lie)."""
    from qoc_tpu.models.forward import make_forward
    from qoc_tpu.routing import resolve_single_engine

    a = q.annihilate(3)
    psi0 = np.zeros(3, complex)
    psi0[0] = 1
    tgt = np.zeros(3, complex)
    tgt[1] = 1
    st = ControlProblem.build(
        np.diag([0.0, 1.0, 1.9]), [a + a.conj().T], ["x"], [tgt],
        2.0, 8, [psi0], state_transfer=True, maxA=[1.0], seed=0)
    un = ControlProblem.build(
        np.diag([0.0, 1.0, 1.9]), [a + a.conj().T], ["x"],
        q.transmon_gate(q.SIGMA_X, 3), 2.0, 8, [0], maxA=[1.0], seed=0,
        Taylor_terms=[8, 1])
    for prob in (st, un):
        for rc in (None, {"speed_up": 0.1}):
            for eng in ("auto", "scan", "pscan"):
                _, loss_fn = make_forward(prob, reg_coeffs=rc,
                                          engine=eng, lean=True)
                want = resolve_single_engine(prob, "exact", eng)
                assert loss_fn.resolved_engine == want, (
                    prob.state_transfer, rc, eng,
                    loss_fn.resolved_engine, want)


def test_routing_quiet_env(capsys, monkeypatch):
    monkeypatch.setenv("QOC_TPU_QUIET", "1")
    from qoc_tpu.routing import announce

    line = announce("engine", "scan")
    assert capsys.readouterr().out == ""
    assert line == "[qoc-tpu] engine: scan"
