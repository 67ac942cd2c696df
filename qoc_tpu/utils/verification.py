"""Independent differential verification of saved runs.

Plays the role of helper_functions/qutip_verification.py:5-86: re-simulate
the optimized pulses stored in a run file with an *independent* integrator
and compare the stored intermediate states.  Four oracles:

  * ``scipy`` (always available): dense piecewise-constant propagation with
    ``scipy.linalg.expm`` in float64 — a different algorithm (Pade) and a
    different precision from the on-device Taylor kernel.
  * ``ode`` (always available): adaptive Runge-Kutta integration of the
    Schroedinger equation (scipy ``solve_ivp``, DOP853) with the
    reference's piecewise-constant ``uks[int(t/dt)]`` Hamiltonian lookup
    (qutip_verification.py:51-64) — the same algorithm CLASS as the
    reference's ``qt.sesolve`` oracle, with no qutip dependency.
  * ``qutip``: ``qt.sesolve`` itself, byte-for-byte the reference's oracle
    construction.  qutip is an OPTIONAL EXTRA (``pip install
    qoc_tpu[qutip]``), deliberately not vendored: requesting this oracle
    without it raises a documented error (tested), and everything shared
    with it — run-file loading and the piecewise-constant
    ``uks[k][int(t/dt)]`` pulse lookup (qutip_verification.py:51-61) — is
    factored into ``piecewise_uks_fns`` and exercised by the ``ode``
    oracle's tests.  The qutip-exclusive surface is three qt.* calls.
  * ``qutip-shim`` (always available): the SAME ``_qutip_states`` branch —
    Qobj wrapping, the time-dependent ``[H0, [Hk, u_fn]]`` list, sesolve,
    ``.full()`` readout — executed against ``utils.qutip_shim``, a
    clearly-labeled API-compatible stand-in backed by DOP853.  This gives
    the qutip branch executed coverage in environments where the real
    package cannot be installed; it never masquerades as qutip itself.

All read the identical h5 schema the reference writes (H0, Hops,
total_time, steps, uks[-1], inter_vecs_raw_{real,imag}[-1],
initial_vectors_c).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as la

from .h5 import H5File


def _load_run(datafile: str):
    import h5py

    with h5py.File(datafile, "r") as hf:
        gate_time = float(np.array(hf.get("total_time")))
        gate_steps = int(np.array(hf.get("steps")))
        H0 = np.array(hf.get("H0"))
        Hops = np.array(hf.get("Hops"))
        initial_vectors_c = np.array(hf.get("initial_vectors_c"))
        uks = np.array(hf.get("uks"))[-1]
        ivr = np.array(hf.get("inter_vecs_raw_real"))[-1]
        ivi = np.array(hf.get("inter_vecs_raw_imag"))[-1]
    return gate_time, gate_steps, H0, Hops, initial_vectors_c, uks, ivr + 1j * ivi


def scipy_oracle_states(H0, Hops, uks, total_time, steps, psi0_c):
    """Dense float64 piecewise-constant propagation (independent of the
    Taylor kernel): psi_{t+1} = expm(-i dt (H0 + sum_k u[k,t] H_k)) psi_t."""
    dt = total_time / steps
    psi = np.asarray(psi0_c, dtype=complex)
    states = [psi]
    for t in range(steps):
        H = np.asarray(H0, dtype=complex)
        for k in range(len(Hops)):
            H = H + uks[k, t] * np.asarray(Hops[k], dtype=complex)
        psi = la.expm(-1j * dt * H) @ psi
        states.append(psi)
    return np.stack(states, axis=1)  # [N, steps+1]


def verify_run(datafile: str, atol: float = 1e-4, oracle: str = "scipy"):
    """Compare stored intermediate states against an independent solver.

    Returns dict {max_abs_diff: [...], all_close: [...]}, one entry per
    initial vector — the reference's report shape
    (qutip_verification.py:82-86).
    """
    gate_time, steps, H0, Hops, init_vecs, uks, inter_vecs = _load_run(datafile)

    max_abs_diff_list, all_close_list = [], []
    for vid in range(len(init_vecs)):
        psi0 = init_vecs[vid]
        if oracle == "qutip":
            states = _qutip_states(H0, Hops, uks, gate_time, steps, psi0)
        elif oracle == "qutip-shim":
            from . import qutip_shim

            states = _qutip_states(H0, Hops, uks, gate_time, steps, psi0,
                                   qt=qutip_shim)
        elif oracle == "ode":
            states = ode_oracle_states(H0, Hops, uks, gate_time, steps, psi0)
        else:
            states = scipy_oracle_states(H0, Hops, uks, gate_time, steps, psi0)
        stored = inter_vecs[vid]  # [N, steps+1]
        abs_diff = np.abs(states) - np.abs(stored)
        max_abs_diff_list.append(float(np.max(np.abs(abs_diff))))
        all_close_list.append(bool(np.allclose(states, stored, atol=atol)))
    return {"max_abs_diff": max_abs_diff_list, "all_close": all_close_list}


def piecewise_uks_fns(uks, gate_time, steps):
    """Per-channel callables ``u_k(t)`` with the reference's
    piecewise-constant lookup ``uks[k][int(t/dt)]`` zero-padded one step
    past the horizon (qutip_verification.py:51-61).  Shared by the ``ode``
    and ``qutip`` oracles so the lookup semantics are tested even where
    qutip is not installed."""
    dt = gate_time / steps
    uks_pad = np.hstack([np.asarray(uks, dtype=float),
                         np.zeros((np.shape(uks)[0], 1))])

    def make(idx):
        def _fn(t, args=None):
            return uks_pad[idx][min(int(t / dt), steps)]

        return _fn

    return [make(k) for k in range(np.shape(uks)[0])]


def ode_oracle_states(H0, Hops, uks, gate_time, steps, psi0_c,
                      rtol=1e-9, atol=1e-11):
    """Adaptive ODE integration of i dpsi/dt = H(t) psi — the reference
    oracle's algorithm class (qt.sesolve is an adaptive ODE solver) built
    on scipy's DOP853, with the reference's piecewise-constant Hamiltonian
    lookup ``uks[k][int(t/dt)]`` (qutip_verification.py:51-64).  max_step
    = dt keeps the integrator from stepping across pulse discontinuities.
    """
    from scipy.integrate import solve_ivp

    dt = gate_time / steps
    u_fns = piecewise_uks_fns(uks, gate_time, steps)
    H0c = np.asarray(H0, dtype=complex)
    Hkc = [np.asarray(h, dtype=complex) for h in Hops]

    def rhs(t, y):
        H = H0c
        for fn, Hk in zip(u_fns, Hkc):
            H = H + fn(t) * Hk
        return -1j * (H @ y)

    tlist = np.linspace(0.0, gate_time, steps + 1)
    sol = solve_ivp(rhs, (0.0, gate_time),
                    np.asarray(psi0_c, dtype=complex), method="DOP853",
                    t_eval=tlist, rtol=rtol, atol=atol, max_step=dt)
    if not sol.success:
        raise RuntimeError(f"ODE oracle failed: {sol.message}")
    return sol.y  # [N, steps+1]


def _qutip_states(H0, Hops, uks, gate_time, steps, psi0_c, qt=None):
    """QuTiP sesolve oracle, reference construction
    (qutip_verification.py:35-71).  Requires the optional ``qutip`` extra
    (``pip install qoc_tpu[qutip]``); the pulse-lookup callables come from
    the shared, ode-oracle-tested ``piecewise_uks_fns``.

    ``qt`` injects a qutip-API-compatible module — utils.qutip_shim uses
    this to give the branch executed coverage (Qobj wrapping, the
    time-dependent Ht_list format, sesolve, .full() readout) where real
    qutip cannot be installed."""
    if qt is None:
        try:
            import qutip as qt
        except ImportError as e:
            raise ImportError(
                "oracle='qutip' needs the optional qutip extra: "
                "pip install qoc_tpu[qutip] (the 'ode' oracle is the "
                "dependency-free stand-in with the same algorithm class; "
                "oracle='qutip-shim' runs this exact construction on the "
                "built-in API-compatible shim)"
            ) from e

    tlist = np.linspace(0, gate_time, steps + 1)
    Ht_list = [qt.Qobj(H0)]
    for Hk, u_fn in zip(Hops, piecewise_uks_fns(uks, gate_time, steps)):
        Ht_list.append([qt.Qobj(Hk), u_fn])
    out = qt.sesolve(Ht_list, qt.Qobj(psi0_c), tlist, [])
    states = np.array([s.full() for s in out.states])[:, :, 0]
    return np.transpose(states)


def qutip_verification(datafile: str, atol: float):
    """Reference-compatible entry point (qutip_verification.py:5); falls
    back to the ``ode`` oracle (same adaptive-ODE algorithm class as
    sesolve) when qutip is unavailable — which it is in this environment."""
    try:
        import qutip  # noqa: F401

        oracle = "qutip"
    except ImportError:
        oracle = "ode"
    result = verify_run(datafile, atol=atol, oracle=oracle)
    print("simulation verification result for each initial state (%s oracle)"
          % oracle)
    print("================================================")
    print("max abs diff: " + str(result["max_abs_diff"]))
    print("all close: " + str(result["all_close"]))
    print("================================================")
    return result


def exact_unitary_grad_f64(problem, u_base):
    """EXACT float64 gradient through the full unitary-mode forward —
    Taylor series AND the scaling-squaring branch (the one code path
    unique to scaling>0 configs like CNOT).  Hand-derived adjoints:
    squarings E_{j+1} = E_j E_j backprop as
    Ebar_j = Ebar_{j+1} E_j^T + E_j^T Ebar_{j+1}; the Taylor polynomial
    backprops via Xbar = sum_n (1/n!) sum_{a+b=n-1} (X^T)^a Ebar (X^T)^b.
    This is the float64 oracle for every exact-gradient engine (pscan
    matvec adjoint, associative and XLA scan).  Returns (loss, dL/du)."""
    p = problem
    mats = np.asarray(p.mats, dtype=np.float64)
    U0 = np.asarray(p.U0_iso, np.float64)
    psi0 = np.asarray(p.initial_vectors, np.float64)
    tgt = np.asarray(p.target_vectors, np.float64)
    maxA = np.asarray(p.ops_max_amp, np.float64)
    order, scaling = p.taylor_terms, p.taylor_scaling
    N = p.state_num
    V = psi0.shape[1]
    T = p.steps
    M = mats.shape[-1]
    w = np.concatenate(
        [np.ones((1, T)), maxA[:, None] * np.sin(u_base)], axis=0)

    fact = [1.0]
    for n in range(1, order + 1):
        fact.append(fact[-1] * n)

    def fwd_one(A):
        X = A / (2.0 ** scaling)
        Xp = [np.eye(M)]
        for n in range(1, order + 1):
            Xp.append(X @ Xp[-1])
        E = sum(Xp[n] / fact[n] for n in range(order + 1))
        Es = [E]
        for _ in range(scaling):
            Es.append(Es[-1] @ Es[-1])
        return Xp, Es

    P, saved = [], []
    for t in range(T):
        A = np.einsum("k,kij->ij", w[:, t], mats)
        Xp, Es = fwd_one(A)
        saved.append((Xp, Es))
        P.append(Es[-1])

    R = [U0]
    for t in range(T):
        R.append(P[t] @ R[t])
    final = R[-1]
    L = [np.eye(M)]
    for t in range(T - 1, -1, -1):
        L.insert(0, L[0] @ P[t])
    lefts = L[1:]

    fv = final @ psi0
    a, b = fv[:N], fv[N:]
    c, d = tgt[:N], tgt[N:]
    Rr = np.sum(a * c + b * d)
    Ii = np.sum(b * c - a * d)
    loss = 1.0 - (Rr * Rr + Ii * Ii) / (V * V)
    Gv = np.zeros_like(fv)
    Gv[:N] = -(2 * Rr * c - 2 * Ii * d) / (V * V)
    Gv[N:] = -(2 * Rr * d + 2 * Ii * c) / (V * V)
    Fbar = Gv @ psi0.T

    wbar = np.zeros_like(w)
    for t in range(T):
        Pbar = lefts[t].T @ Fbar @ R[t].T
        Xp, Es = saved[t]
        Ebar = Pbar
        for j in range(scaling - 1, -1, -1):
            E = Es[j]
            Ebar = Ebar @ E.T + E.T @ Ebar
        Xbar = np.zeros((M, M))
        for n in range(1, order + 1):
            for a_ in range(n):
                Xbar += (Xp[a_].T @ Ebar @ Xp[n - 1 - a_].T) / fact[n]
        Abar = Xbar / (2.0 ** scaling)
        for k in range(1, len(mats)):
            wbar[k, t] = np.sum(Abar * mats[k])
    ubar = wbar[1:] * maxA[:, None] * np.cos(u_base)
    return loss, ubar
