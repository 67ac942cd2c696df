"""Column-batched XLA loss (parallel/xla_batch.py): parity with the
per-seed forward, and the public batched API end-to-end."""

import numpy as np
import jax
import jax.numpy as jnp

import qoc_tpu as q
from qoc_tpu.models.forward import make_forward
from qoc_tpu.models.system import ControlProblem
from qoc_tpu.parallel.batch import batched_grape_adam, init_seeds
from qoc_tpu.parallel.xla_batch import (
    make_xla_batched_loss,
    xla_cols_supported,
)


def _problem(levels=5, steps=12):
    a = q.annihilate(levels)
    H0 = 2 * np.pi * (-0.2) / 2 * (a.conj().T @ a.conj().T @ a @ a)
    psi0 = np.zeros(levels, complex)
    psi0[0] = 1
    tgt = np.zeros(levels, complex)
    tgt[1] = 1
    return ControlProblem.build(
        H0, [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"], [tgt],
        3.0, steps, [psi0], state_transfer=True, maxA=[1.0, 1.0], seed=0,
    )


def _problem_unitary(steps=12):
    a = q.annihilate(3)
    return ControlProblem.build(
        np.diag([0.0, 1.0, 1.95]) * 2 * np.pi,
        [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"],
        q.transmon_gate(q.SIGMA_X, 3), 3.0, steps, [0],
        maxA=[0.6, 0.6], seed=0, Taylor_terms=[8, 2],
    )


def test_supported():
    assert xla_cols_supported(_problem(), None)
    # trajectory penalties are in-path: forbidden since round 4
    # (scan-carry projections), speed_up since round 5 (in-carry target
    # overlap) — both still need use_inter_vecs
    assert xla_cols_supported(_problem(), {"forbidden_coeff_list": [1.0],
                                           "states_forbidden_list": [2]})
    assert xla_cols_supported(_problem(), {"speed_up": 0.1})


def test_matches_per_seed_forward():
    problem = _problem()
    S = 3
    u = np.asarray(init_seeds(problem, S, jax.random.PRNGKey(0)))
    batched = make_xla_batched_loss(problem)
    reg_l, fid_l = batched(jnp.asarray(u))

    _, loss_fn = make_forward(problem, lean=True, engine="scan")
    for s in range(S):
        want, _ = loss_fn(jnp.asarray(u[s]))
        np.testing.assert_allclose(float(fid_l[s]), float(want), atol=1e-5)


def test_v12_matches_vmapped_generic():
    """V=12 concerned vectors on the column path: loss and gradient
    parity vs the vmapped generic forward."""
    N = 16
    rng = np.random.default_rng(0)
    A_ = rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))
    H0 = (A_ + A_.conj().T) / 8
    Hop = np.diag(np.arange(N, dtype=float)) / 4
    U = np.eye(N, dtype=complex)
    U[:2, :2] = [[0, 1], [1, 0]]
    p = ControlProblem.build(
        H0, [Hop, H0 @ Hop - Hop @ H0 + np.eye(N)], ["a", "b"], U, 4.0, 10,
        list(range(12)), maxA=[1.0, 1.0], seed=0, Taylor_terms=[8, 1])
    assert p.initial_vectors.shape[1] == 12
    assert xla_cols_supported(p, None)
    u = jnp.asarray(init_seeds(p, 3, jax.random.PRNGKey(1)))
    lx = make_xla_batched_loss(p)
    _, fx = lx(u)
    _, loss_fn = make_forward(p, lean=True, engine="scan")
    for s in range(3):
        want, _ = loss_fn(u[s])
        np.testing.assert_allclose(float(fx[s]), float(want), atol=1e-5)
    gx = jax.grad(lambda a: jnp.sum(lx(a)[0]))(u)
    gv = jax.vmap(jax.grad(lambda a: loss_fn(a)[0]))(u)
    np.testing.assert_allclose(np.asarray(gx), np.asarray(gv), atol=1e-5)


def test_speed_up_matches_vmapped_generic():
    """speed_up computed in the scan carry (round 5) matches the vmapped
    generic forward's inter_vecs-based cost — loss and gradient
    (regularization_functions.py:88-95 semantics)."""
    problem = _problem()
    S = 3
    u = jnp.asarray(init_seeds(problem, S, jax.random.PRNGKey(2)))
    reg = {"speed_up": 0.05, "amplitude": 0.02}
    lx = make_xla_batched_loss(problem, reg)
    rx, fx = lx(u)

    _, loss_fn = make_forward(problem, reg_coeffs=reg, lean=True,
                              engine="scan")
    for s in range(S):
        want_reg, out = loss_fn(u[s])
        np.testing.assert_allclose(float(fx[s]), float(out.loss), atol=1e-5)
        np.testing.assert_allclose(float(rx[s]), float(want_reg), atol=1e-4)

    gx = jax.grad(lambda a: jnp.sum(lx(a)[0]))(u)
    gv = jax.vmap(jax.grad(lambda a: loss_fn(a)[0]))(u)
    np.testing.assert_allclose(np.asarray(gx), np.asarray(gv), atol=2e-4)


def test_speed_up_unitary_mode_cols():
    """speed_up in UNITARY mode on the column path (inter_vecs are
    U_t @ psi0 there) against the generic forward — including a
    non-identity U0 (the t=0 term reads the RAW psi0 in both, U0 enters
    from t=1; tensorflow_state.py:229-242)."""
    a = q.annihilate(3)
    U0, _ = np.linalg.qr(np.eye(3) - 0.4j * (a + a.conj().T))
    for u0 in (None, U0):
        problem = ControlProblem.build(
            np.diag([0.0, 1.0, 1.95]) * 2 * np.pi,
            [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"],
            q.transmon_gate(q.SIGMA_X, 3), 3.0, 12, [0], U0=u0,
            maxA=[0.6, 0.6], seed=0, Taylor_terms=[8, 2],
        )
        S = 2
        u = jnp.asarray(init_seeds(problem, S, jax.random.PRNGKey(3)))
        reg = {"speed_up": 0.1}
        lx = make_xla_batched_loss(problem, reg)
        rx, fx = lx(u)
        _, loss_fn = make_forward(problem, reg_coeffs=reg, lean=True,
                                  engine="scan")
        for s in range(S):
            want_reg, out = loss_fn(u[s])
            np.testing.assert_allclose(float(rx[s]), float(want_reg),
                                       atol=1e-4)


def test_unitary_with_scaling_cols():
    """V=1 unitary problem with taylor_scaling > 0: the column backend
    matches the per-seed forward's loss AND gradient — the squaring branch
    on propagated columns."""
    a = q.annihilate(3)
    problem = ControlProblem.build(
        np.diag([0.0, 1.0, 1.95]) * 2 * np.pi,
        [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"],
        q.transmon_gate(q.SIGMA_X, 3), 3.0, 12, [0],
        maxA=[0.6, 0.6], seed=0, Taylor_terms=[8, 2],
    )
    assert problem.taylor_scaling == 2
    assert xla_cols_supported(problem, None)

    S = 3
    u = np.asarray(init_seeds(problem, S, jax.random.PRNGKey(2)))
    _, loss_fn = make_forward(problem, lean=True, engine="scan")

    batched = make_xla_batched_loss(problem)
    reg_l, fid_l = batched(jnp.asarray(u))
    for s in range(S):
        want, _ = loss_fn(jnp.asarray(u[s]))
        np.testing.assert_allclose(float(fid_l[s]), float(want), atol=1e-5)
    gb = jax.grad(lambda x: jnp.sum(batched(x)[0]))(jnp.asarray(u))
    for s in range(S):
        gs = jax.grad(lambda x: loss_fn(x)[0])(jnp.asarray(u[s]))
        np.testing.assert_allclose(np.asarray(gb[s]), np.asarray(gs),
                                   atol=2e-5)


def test_batched_grape_adam_xla_cols_backend():
    problem = _problem(levels=3, steps=10)
    out = batched_grape_adam(
        problem, n_seeds=4,
        convergence={"rate": 0.05, "update_step": 20, "max_iterations": 60,
                     "conv_target": 1e-3},
        seed=0, backend="xla-cols",
    )
    ref = batched_grape_adam(
        problem, n_seeds=4,
        convergence={"rate": 0.05, "update_step": 20, "max_iterations": 60,
                     "conv_target": 1e-3},
        seed=0, backend="xla",
    )
    np.testing.assert_allclose(out["losses"], ref["losses"], atol=1e-4)
    np.testing.assert_allclose(out["uks"], ref["uks"], atol=1e-3)


def test_forbidden_in_cols_matches_per_seed_forward():
    """Forbidden-state penalties on the column-batched path (scan-carry
    projection rows): per-seed reg losses and gradients match the generic
    forward with inter_vecs (regularization_functions.py:71-85)."""
    problem = _problem()
    rc = {"forbidden_coeff_list": [6.0, 3.0], "states_forbidden_list": [2, 3],
          "amplitude": 0.05}
    assert xla_cols_supported(problem, rc)
    S = 3
    u = np.asarray(init_seeds(problem, S, jax.random.PRNGKey(4)))
    batched = make_xla_batched_loss(problem, rc)
    reg_l, fid_l = batched(jnp.asarray(u))

    _, loss_fn = make_forward(problem, reg_coeffs=rc, lean=True,
                              engine="scan")
    gb = jax.grad(lambda x: jnp.sum(batched(x)[0]))(jnp.asarray(u))
    for s in range(S):
        want, out = loss_fn(jnp.asarray(u[s]))
        np.testing.assert_allclose(float(reg_l[s]), float(want), atol=1e-5)
        np.testing.assert_allclose(float(fid_l[s]), float(out.loss),
                                   atol=1e-5)
        gs = jax.grad(lambda x: loss_fn(x)[0])(jnp.asarray(u[s]))
        np.testing.assert_allclose(np.asarray(gb[s]), np.asarray(gs),
                                   atol=2e-5)


def test_forbidden_dressed_in_cols():
    """forbid_dressed folds the eigenbasis rotation into the projection
    rows on the column path too."""
    a = q.annihilate(4)
    H0 = (2 * np.pi * 0.1 * np.diag(np.arange(4.0))
          + 2 * np.pi * 0.02 * (a + a.conj().T))
    w_c, v_c, dressed_id = q.get_dressed_info(H0)
    di = {"eigenvectors": v_c, "eigenvalues": np.real(w_c),
          "dressed_id": dressed_id, "is_dressed": True}
    psi0 = v_c[:, q.get_state_index(0, dressed_id)]
    tgt = v_c[:, q.get_state_index(1, dressed_id)]
    problem = ControlProblem.build(
        H0, [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"], [tgt],
        3.0, 10, [psi0], state_transfer=True, dressed_info=di,
        maxA=[1.0, 1.0], seed=0,
    )
    rc = {"forbidden_coeff_list": [5.0], "states_forbidden_list": [3],
          "forbid_dressed": True}
    assert xla_cols_supported(problem, rc)
    S = 2
    u = np.asarray(init_seeds(problem, S, jax.random.PRNGKey(6)))
    batched = make_xla_batched_loss(problem, rc)
    reg_l, _ = batched(jnp.asarray(u))
    _, loss_fn = make_forward(problem, reg_coeffs=rc, lean=True,
                              engine="scan")
    for s in range(S):
        want, _ = loss_fn(jnp.asarray(u[s]))
        np.testing.assert_allclose(float(reg_l[s]), float(want), atol=1e-5)


def test_multi_vector_cols_matches_per_seed_forward():
    """V=2 concerned vectors on the column path: coherent group fidelity
    and gradients match the per-seed forward (unitary mode, scaling>0)."""
    a = q.annihilate(3)
    problem = ControlProblem.build(
        np.diag([0.0, 1.0, 1.95]) * 2 * np.pi,
        [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"],
        q.transmon_gate(q.SIGMA_X, 3), 3.0, 12, [0, 1],
        maxA=[0.6, 0.6], seed=0, Taylor_terms=[8, 2],
    )
    assert problem.initial_vectors.shape[1] == 2
    assert xla_cols_supported(problem, None)
    S = 3
    u = np.asarray(init_seeds(problem, S, jax.random.PRNGKey(2)))
    batched = make_xla_batched_loss(problem)
    _, fid_l = batched(jnp.asarray(u))
    _, loss_fn = make_forward(problem, lean=True, engine="scan")
    gb = jax.grad(lambda x: jnp.sum(batched(x)[0]))(jnp.asarray(u))
    for s in range(S):
        want, _ = loss_fn(jnp.asarray(u[s]))
        np.testing.assert_allclose(float(fid_l[s]), float(want), atol=1e-5)
        gs = jax.grad(lambda x: loss_fn(x)[0])(jnp.asarray(u[s]))
        np.testing.assert_allclose(np.asarray(gb[s]), np.asarray(gs),
                                   atol=2e-5)


def test_column_padding_invariance():
    """Results are independent of the lane padding: S=64 (padded to 128
    columns) equals the first 64 seeds of an S=128 run, and a small
    unpadded batch (C < 64) matches the per-seed forward."""
    problem = _problem(levels=3, steps=8)
    batched = make_xla_batched_loss(problem)
    u128 = np.asarray(init_seeds(problem, 128, jax.random.PRNGKey(9)))
    r128, f128 = batched(jnp.asarray(u128))
    r64, f64 = batched(jnp.asarray(u128[:64]))
    np.testing.assert_allclose(np.asarray(f64), np.asarray(f128)[:64],
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(r64), np.asarray(r128)[:64],
                               atol=1e-6)


def test_sharded_cols_runner_matches_xla_backend(eight_devices):
    """The shard_map'd fixed-count xla-cols runner (zero collectives, the
    pod path for large dims) reproduces the jit+NamedSharding xla backend:
    same per-seed losses after the same iteration count, independent of
    the mesh size."""
    from jax.sharding import Mesh
    from qoc_tpu.optim.convergence import ConvergenceSettings
    from qoc_tpu.parallel.xla_batch import make_xla_cols_sharded_runner

    problem = _problem(levels=3, steps=10)
    conv = ConvergenceSettings.from_dict(
        {"rate": 0.05, "update_step": 100, "max_iterations": 10 ** 6,
         "conv_target": -1.0})
    S = 16
    u0 = np.asarray(init_seeds(problem, S, jax.random.PRNGKey(11)))

    ref = None
    for D in (1, 4, 8):
        mesh = Mesh(np.array(jax.devices()[:D]), ("seed",))
        run = make_xla_cols_sharded_runner(problem, conv, mesh)
        u, fids, regs = run(u0, 6)
        if ref is None:
            ref = (np.asarray(u), np.asarray(fids))
        else:
            np.testing.assert_allclose(np.asarray(u), ref[0], atol=1e-6)
            np.testing.assert_allclose(np.asarray(fids), ref[1], atol=1e-6)

    # against the while_loop xla backend (metrics at the pre-update
    # iterate of the last iteration, batch.py body convention)
    from qoc_tpu.parallel.batch import make_batched_runner

    init_x, run_x = make_batched_runner(problem, conv, backend="xla")
    sx = run_x(init_x(jnp.asarray(u0)), jnp.asarray(6, dtype=jnp.int32),
               None)
    np.testing.assert_allclose(ref[1], np.asarray(sx.loss), atol=1e-5)


def test_sharded_cols_runner_with_sweep_and_forbidden(eight_devices):
    """Sharded xla-cols with extra detuning channels AND a forbidden-level
    penalty — the exact program shape of the config-5 pod sweep."""
    from jax.sharding import Mesh
    from qoc_tpu.optim.convergence import ConvergenceSettings
    from qoc_tpu.parallel.xla_batch import make_xla_cols_sharded_runner

    problem = _problem(levels=4, steps=8)
    rc = {"forbidden_coeff_list": [4.0], "states_forbidden_list": [3]}
    extra = np.stack([np.asarray(
        q.c_to_r_mat(-1j * problem.dt * np.diag(np.arange(4.0))))])
    conv = ConvergenceSettings.from_dict(
        {"rate": 0.05, "update_step": 100, "max_iterations": 10 ** 6,
         "conv_target": -1.0})
    S = 8
    u0 = np.asarray(init_seeds(problem, S, jax.random.PRNGKey(12)))
    ew = np.linspace(-0.2, 0.2, S)[:, None].astype(np.float32)

    mesh = Mesh(np.array(jax.devices()[:8]), ("seed",))
    run = make_xla_cols_sharded_runner(problem, conv, mesh, reg_coeffs=rc,
                                       extra_channel_mats=extra)
    u, fids, regs = run(u0, 4, extra_weights=ew)
    assert np.all(np.isfinite(np.asarray(regs)))
    assert np.all(np.asarray(regs) >= np.asarray(fids) - 1e-7)

    # single-device reference through the plain batched loss + optax
    import optax
    from qoc_tpu.optim.adam import make_adam_optimizer

    batched = make_xla_batched_loss(problem, rc, extra_channel_mats=extra)
    opt = make_adam_optimizer(conv)
    u_ref = jnp.asarray(u0)
    os_ = opt.init(u_ref)
    for _ in range(4):
        (_, (regs_r, fids_r)), g = jax.value_and_grad(
            lambda x: (lambda r: (jnp.sum(r[0]), r))(
                batched(x, jnp.asarray(ew))), has_aux=True)(u_ref)
        upd, os_ = opt.update(g, os_, u_ref)
        u_ref = optax.apply_updates(u_ref, upd)
    np.testing.assert_allclose(np.asarray(u), np.asarray(u_ref), atol=1e-5)
    np.testing.assert_allclose(np.asarray(regs), np.asarray(regs_r),
                               atol=1e-5)
