"""Benchmark: GRAPE iterations/sec on the qubit pi pulse, plus the windows
of the other BASELINE configs.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"card", "windows", ...}.

Measurements (BASELINE.md targets):
  * single-problem GRAPE iterations/sec — one fused fwd+bwd+Adam update per
    iteration, fixed-count fori_loop (no early exit), on device;
  * wall-clock to fidelity 1-1e-4 with the real convergence-checking loop;
  * batched multi-seed throughput (seeds x iterations / sec) through the
    column-batched xla-cols loss;
  * transmon-cavity with bandpass + speed_up costs (BASELINE config 4).

``vs_baseline`` compares single-problem iterations/sec against the same
optimized loop on the host CPU — a *conservative* stand-in for the TF1 CPU
reference, which is Python-2.7-only and cannot run here, and which ran the
graph twice per iteration through a session boundary
(run_session.py:53-69).

Every metric is timed over ``REPEATS`` windows after a warm-up call that
compiles; each window ends in ``jax.block_until_ready``.  The JSON reports
the MEDIAN as the headline value and the relative spread (max-min)/median
per window.  A window that did not run on this platform is ``null``.  The
large windows run only on a GPU; the CPU run covers the small ones.

Run:  python bench.py
"""

import json
import statistics
import subprocess
import time

import numpy as np

REPEATS = 3


def _measure(window, units: float):
    """Run ``window()`` (one timed measurement ending in
    block_until_ready) REPEATS times; return (median_rate, spread, runs)
    in units/sec."""
    import jax

    rates = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        jax.block_until_ready(window())
        rates.append(units / (time.perf_counter() - t0))
    med = statistics.median(rates)
    spread = (max(rates) - min(rates)) / med if med else 0.0
    return med, spread, rates


def card_name_and_power_limit():
    """``name, power.limit`` of GPU 0 as nvidia-smi reports it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def _problem(steps=1000):
    import qoc_tpu as q
    from qoc_tpu.models.system import ControlProblem

    return ControlProblem.build(
        np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y], ["x", "y"],
        [np.array([0, 1], dtype=complex)], 10.0, steps,
        [np.array([1, 0], dtype=complex)],
        state_transfer=True, maxA=[0.7, 0.7], seed=0,
    )


def _conv(**over):
    from qoc_tpu.optim.convergence import ConvergenceSettings

    base = {"rate": 0.01, "update_step": 100, "max_iterations": 5000,
            "conv_target": 1e-4}
    base.update(over)
    return ConvergenceSettings.from_dict(base)


def _single_rate(problem, device, n_iters, engine="auto", reg_coeffs=None,
                 warm_iters=None):
    """Steady-state single-problem throughput via the fixed-count
    fori_loop runner (make_throughput_runner)."""
    import jax
    import jax.numpy as jnp
    from qoc_tpu.models.forward import make_forward
    from qoc_tpu.optim.adam import make_adam_optimizer, make_throughput_runner

    _, loss_fn = make_forward(problem, lean=True, engine=engine,
                              reg_coeffs=reg_coeffs)
    optimizer = make_adam_optimizer(_conv())
    run_n = make_throughput_runner(loss_fn, _conv(), optimizer)
    u = jax.device_put(jnp.asarray(problem.u0_base), device)
    os0 = jax.device_put(optimizer.init(jnp.asarray(problem.u0_base)),
                         device)
    jax.block_until_ready(run_n(u, os0, warm_iters or n_iters))
    return _measure(lambda: run_n(u, os0, n_iters), n_iters)


def _cols_runner(problem, reg_coeffs=None, extra_mats=None):
    """Fixed-count Adam over the column-batched loss:
    ``run_n(u [S,K,T], opt_state, extra_w [S,E] | None, n)``."""
    import jax
    import jax.numpy as jnp
    import optax
    from qoc_tpu.optim.adam import make_adam_optimizer
    from qoc_tpu.parallel.xla_batch import make_xla_batched_loss

    batched_loss = make_xla_batched_loss(problem, reg_coeffs,
                                         extra_channel_mats=extra_mats)
    opt = make_adam_optimizer(_conv())
    grad_all = jax.grad(lambda u, ew: jnp.sum(batched_loss(u, ew)[0]))

    @jax.jit
    def run_n(u, os_, ew, n):
        def body(_, c):
            u, os_ = c
            g = grad_all(u, ew)
            upd, os_ = jax.vmap(opt.update)(g, os_, u)
            return (jax.vmap(optax.apply_updates)(u, upd), os_)

        return jax.lax.fori_loop(0, n, body, (u, os_))

    return run_n, opt


def _cols_rate(problem, n_seeds, n_iters, reg_coeffs=None):
    """Aggregate (seeds x iterations)/sec through the xla-cols loss."""
    import jax
    from qoc_tpu.parallel.batch import init_seeds

    run_n, opt = _cols_runner(problem, reg_coeffs)
    u = init_seeds(problem, n_seeds, jax.random.PRNGKey(0))
    os0 = jax.vmap(opt.init)(u)
    jax.block_until_ready(run_n(u, os0, None, 2))
    return _measure(lambda: run_n(u, os0, None, n_iters), n_seeds * n_iters)


def iters_per_sec(device, engine="auto", n_iters=3000):
    """Qubit pi pulse, 1000 steps (BASELINE config 1)."""
    return _single_rate(_problem(), device, n_iters, engine=engine)


def batched_iters_per_sec(n_seeds=1024, n_iters=100):
    """Pi pulse, 1024 seeds through the column-batched loss."""
    return _cols_rate(_problem(), n_seeds, n_iters)


def leakage_iters_per_sec(device, n_iters=3000):
    """Flagship transmon-leakage throughput (BASELINE config 3) on the
    auto-routed engine."""
    from __graft_entry__ import FLAGSHIP_RC, _flagship_problem

    return _single_rate(_flagship_problem(), device, n_iters,
                        reg_coeffs=FLAGSHIP_RC)


def cavity_costs_iters_per_sec(device, n_iters=200):
    """BASELINE config 4: transmon x cavity (Hilbert dim 24) state transfer
    in the dressed basis with dwdt + bandpass + speed_up costs — the
    trajectory-reading config."""
    import qoc_tpu as q
    from qoc_tpu.models.system import ControlProblem

    ql, cl = 3, 8
    aq = q.annihilate(ql)
    ac = q.annihilate(cl)
    Iq, Ic = np.eye(ql), np.eye(cl)
    nq = np.kron(aq.conj().T @ aq, Ic)
    nc = np.kron(Iq, ac.conj().T @ ac)
    kerr = np.kron(aq.conj().T @ aq.conj().T @ aq @ aq, Ic)
    coupling = np.kron(aq, Ic) @ np.kron(Iq, ac).conj().T
    coupling = coupling + coupling.conj().T
    H0 = (2 * np.pi * 3.9 * nq + 2 * np.pi * 4.5 * nc
          - 2 * np.pi * 0.1 * kerr + 2 * np.pi * 0.1 * coupling)
    Hops = [np.kron(aq + aq.conj().T, Ic),
            np.kron(1j * (aq - aq.conj().T), Ic)]
    w_c, v_c, dressed_id = q.get_dressed_info(H0)
    psi0 = v_c[:, q.get_state_index(0, dressed_id)]
    tgt = v_c[:, q.get_state_index(1, dressed_id)]
    problem = ControlProblem.build(
        H0, Hops, ["qx", "qy"], [tgt], 20.0, 800, [psi0],
        state_transfer=True,
        dressed_info={"eigenvectors": v_c, "eigenvalues": np.real(w_c),
                      "dressed_id": dressed_id, "is_dressed": True},
        maxA=[2 * np.pi * 0.3] * 2, seed=0,
    )
    rc = {"dwdt": 0.0001, "bandpass": 0.1, "band": [0.1, 10.0],
          "speed_up": 0.001}
    return _single_rate(problem, device, n_iters, reg_coeffs=rc)


def cavity_dim60_iters_per_sec(device, n_iters=150):
    """BASELINE config 4 AT SPEC (dim 60 >= 50): the examples/jobs/
    transmon_cavity.json system — 3-level transmon x 20-level cavity in
    the qubit rotating frame, dressed basis, qubit+cavity drives, dwdt +
    bandpass + speed_up costs, 1000 steps."""
    import os
    import sys

    import qoc_tpu as q
    from qoc_tpu.models.system import ControlProblem

    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "examples", "jobs"))
    from make_transmon_cavity import MAXA, STEPS, TOTAL_TIME, build_system

    H0, Hops, Hnames = build_system()
    w_c, v_c, dressed_id = q.get_dressed_info(H0)
    psi0 = v_c[:, q.get_state_index(0, dressed_id)]
    tgt = v_c[:, q.get_state_index(1, dressed_id)]
    problem = ControlProblem.build(
        H0, Hops, Hnames, [tgt], TOTAL_TIME, STEPS, [psi0],
        state_transfer=True,
        dressed_info={"eigenvectors": v_c, "eigenvalues": np.real(w_c),
                      "dressed_id": dressed_id, "is_dressed": True},
        maxA=[MAXA] * 4, seed=0,
    )
    rc = {"dwdt": 0.0001, "bandpass": 0.1, "band": [0.1, 10.0],
          "speed_up": 0.0001}
    return _single_rate(problem, device, n_iters, reg_coeffs=rc,
                        warm_iters=3)


def cnot_reg_batched_seediters(n_seeds=128, n_iters=60):
    """Batched CNOT-class sweep (BASELINE config 2) WITH config 2's own
    smoothness + envelope reg_coeffs through the column-batched loss."""
    import qoc_tpu as q
    from qoc_tpu.models.system import ControlProblem

    CNOT = np.eye(4, dtype=complex)
    CNOT[2:, 2:] = [[0, 1], [1, 0]]
    XI = np.kron(q.SIGMA_X, np.eye(2))
    IX = np.kron(np.eye(2), q.SIGMA_X)
    ZZ = np.kron(q.SIGMA_Z, q.SIGMA_Z)
    problem = ControlProblem.build(
        np.zeros((4, 4), dtype=complex), [XI, IX, ZZ], ["xi", "ix", "zz"],
        CNOT, 10.0, 1000, [0, 1, 2, 3], maxA=[1.0] * 3, seed=0,
        Taylor_terms=[8, 2],
    )
    return _cols_rate(problem, n_seeds, n_iters,
                      reg_coeffs={"dwdt": 0.01, "envelope": 0.1})


def dim200_problem():
    """Qubit x 100-level cavity (Hilbert dim 200), 200 steps (BASELINE
    config 5 scale); returns (problem, cavity number operator)."""
    from qoc_tpu.models.system import ControlProblem

    Nc = 100
    a = np.kron(np.eye(2), np.diag(np.sqrt(np.arange(1, Nc)), 1))
    sm = np.kron(np.array([[0, 1], [0, 0]]), np.eye(Nc))
    H0 = (2 * np.pi * 0.1 * (a.conj().T @ a)
          + 2 * np.pi * 0.05 * (a.conj().T @ sm + a @ sm.conj().T))
    Hops = [sm + sm.conj().T, 1j * (sm - sm.conj().T), a + a.conj().T]
    psi0 = np.zeros(2 * Nc, complex)
    psi0[0] = 1
    tgt = np.zeros(2 * Nc, complex)
    tgt[Nc] = 1
    problem = ControlProblem.build(
        H0, Hops, ["x", "y", "c"], [tgt], 4.0, 200, [psi0],
        state_transfer=True, maxA=[2 * np.pi * 0.3] * 3, seed=0,
    )
    return problem, np.asarray(a.conj().T @ a)


def dim200_grid_4096_seediters(n_seeds=4096, n_iters=20, chunk=2048):
    """BASELINE config 5 AT SPEC: 4096 parallel seeds x detuning grid on
    the dim-200 multimode cavity through the column-batched xla-cols path
    (a cavity-frequency detuning as a constant extra channel per seed).
    The seed axis runs as per-launch chunks of ``chunk`` columns; the
    timed quantity covers ALL chunks, so the metric is aggregate
    seed-iters/s for the full 4096-seed workload."""
    import jax
    import jax.numpy as jnp
    from qoc_tpu.ops.isomorphism import c_to_r_mat
    from qoc_tpu.parallel.batch import init_seeds

    problem, n_op = dim200_problem()
    extra = np.stack([c_to_r_mat(-1j * problem.dt * n_op)]).astype(
        np.float32)
    deltas = np.linspace(-0.1, 0.1, n_seeds)[:, None].astype(np.float32)
    run_n, opt = _cols_runner(problem, extra_mats=extra)

    chunks = []
    for c0 in range(0, n_seeds, chunk):
        c1 = min(c0 + chunk, n_seeds)
        u = init_seeds(problem, c1 - c0, jax.random.PRNGKey(c0 // chunk))
        chunks.append((u, jax.vmap(opt.init)(u), jnp.asarray(deltas[c0:c1])))
    jax.block_until_ready(run_n(*chunks[0], 2))
    return _measure(lambda: [run_n(u, os0, ew, n_iters)
                             for u, os0, ew in chunks], n_seeds * n_iters)


def dim200_single_iters_per_sec(device, n_iters=60):
    """Single-problem dim-200 time-optimal state transfer (speed_up +
    dwdt costs) on the auto-routed engine."""
    problem, _ = dim200_problem()
    return _single_rate(problem, device, n_iters,
                        reg_coeffs={"speed_up": 0.001, "dwdt": 0.0001},
                        warm_iters=3)


def dim64_iters_per_sec(device, n_iters=240):
    """Unitary-mode GRAPE at Hilbert dim 64 (transmon-cavity scale,
    BASELINE config 4) [200 steps, 4 controls, Taylor order 8, 2
    squarings]."""
    return _single_rate(dim64_problem(), device, n_iters, warm_iters=3)


def dim64_problem():
    from qoc_tpu.models.system import ControlProblem

    N = 64
    rng = np.random.default_rng(0)

    def herm(n):
        A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
        return (A + A.conj().T) / 20

    H0 = np.diag(np.arange(N)).astype(complex) * 0.1
    Hops = [herm(N) for _ in range(4)]
    U = np.eye(N, dtype=complex)
    U[:2, :2] = [[0, 1], [1, 0]]
    return ControlProblem.build(
        H0, Hops, ["a", "b", "c", "d"], U, 10.0, 200, [0, 1, 2, 3],
        maxA=[1.0] * 4, seed=0, Taylor_terms=[8, 2],
    )


def dim200_sweep_iters_per_sec(n_seeds=64, n_iters=50, reg_coeffs=None):
    """BASELINE config 5 scale: dim-200 seed batch through the
    column-batched XLA chain (parallel/xla_batch.py)."""
    problem, _ = dim200_problem()
    return _cols_rate(problem, n_seeds, n_iters, reg_coeffs=reg_coeffs)


def wall_clock_to_fidelity(device, engine="auto", target=1e-4):
    """Wall-clock (excluding compile) to reach loss < target with the real
    convergence-checking segment loop Grape runs."""
    import jax
    import jax.numpy as jnp
    from qoc_tpu.models.forward import make_forward
    from qoc_tpu.optim.adam import (
        init_adam_state, make_adam_optimizer, make_segment_runner,
    )

    problem = _problem()
    conv = _conv(conv_target=target)
    _, loss_fn = make_forward(problem, lean=True, engine=engine)
    optimizer = make_adam_optimizer(conv)
    run_segment, _ = make_segment_runner(loss_fn, conv, optimizer)
    state0 = init_adam_state(
        jax.device_put(jnp.asarray(problem.u0_base), device), optimizer
    )
    jax.block_until_ready(
        run_segment(state0, jnp.asarray(conv.update_step, dtype=jnp.int32)))

    def once():
        st = state0
        while True:
            stop = jnp.asarray(int(st.iteration) + conv.update_step,
                               dtype=jnp.int32)
            st = run_segment(st, stop)
            if bool(st.done):
                break
        return jax.block_until_ready(st)

    walls, state = [], None
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        state = once()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    spread = (max(walls) - min(walls)) / wall if wall else 0.0
    return wall, spread, float(state.loss), int(state.iteration)


def main():
    import jax
    from qoc_tpu.routing import on_gpu

    primary = jax.devices()[0]
    gpu = on_gpu()
    windows = {}

    def rec(name, triple, run=True):
        """Record a window; ``run=False`` records it as not measured."""
        if not run:
            windows[name] = None
            return None
        med, spread, runs = triple()
        windows[name] = {"median": med, "spread": spread, "runs": runs}
        return med

    ips = rec("pi_pulse", lambda: iters_per_sec(primary))
    wall, wall_spread, loss, iters = wall_clock_to_fidelity(primary)
    rec("batched_1024seed", batched_iters_per_sec, gpu)
    d64 = rec("dim64_unitary", lambda: dim64_iters_per_sec(primary))
    rec("dim200_cavity_128seed",
        lambda: dim200_sweep_iters_per_sec(n_seeds=128), gpu)
    rec("dim200_cavity_64seed", dim200_sweep_iters_per_sec, gpu)
    rec("dim200_speedup_64seed", lambda: dim200_sweep_iters_per_sec(
        reg_coeffs={"speed_up": 0.001}), gpu)
    rec("dim200_single", lambda: dim200_single_iters_per_sec(primary), gpu)
    rec("cavity_costs_dim24", lambda: cavity_costs_iters_per_sec(primary))
    rec("cavity_costs_dim60", lambda: cavity_dim60_iters_per_sec(primary),
        gpu)
    rec("cnot_reg_batched_128seed", cnot_reg_batched_seediters, gpu)
    rec("dim200_4096seed_grid", dim200_grid_4096_seediters, gpu)
    rec("leakage", lambda: leakage_iters_per_sec(
        primary, n_iters=3000 if gpu else 300))
    if gpu:
        cpu = jax.devices("cpu")[0]
        cpu_ips = rec("cpu_baseline_pi_pulse",
                      lambda: iters_per_sec(cpu, "scan", n_iters=3000))
        cpu_d64 = rec("cpu_baseline_dim64",
                      lambda: dim64_iters_per_sec(cpu, n_iters=5))
        vs_baseline, d64_vs_cpu = ips / cpu_ips, d64 / cpu_d64
    else:
        vs_baseline = d64_vs_cpu = None

    print(json.dumps({
        "metric": "GRAPE iterations/sec (qubit pi pulse, 1000 steps)",
        "value": ips,
        "unit": "iters/sec",
        "vs_baseline": vs_baseline,
        "dim64_vs_cpu": d64_vs_cpu,
        "device": {"platform": primary.platform,
                   "kind": primary.device_kind,
                   "count": len(jax.devices())},
        "card": card_name_and_power_limit() if gpu else None,
        "wall_clock_to_1e-4_s": wall,
        "wall_clock_spread": wall_spread,
        "final_loss": loss,
        "iterations_to_target": iters,
        "repeats": REPEATS,
        "windows": windows,
    }))


if __name__ == "__main__":
    main()
