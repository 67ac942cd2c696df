"""Column-batched XLA loss for LARGE Hilbert dimensions.

The generic batched path (vmap of the per-seed forward) materializes a
per-seed step generator ``A_t [S, M, M]`` at every timestep — at dim 200
that is 41 MB of memory traffic per Taylor application, and the whole
iteration is bandwidth-bound.  This module batches seeds on the COLUMN
axis instead: the state block is ``[M, C]`` (C = seeds x V concerned
vectors), and each Taylor term is ONE ``[M, K'M] @ [K'M, C]`` matmul —
the per-seed weights are column scalings, so they commute into the
operand (``sum_k w_k (M_k @ pn) = [M_0|..|M_K'] @ stack_k(pn * w_k)``)
and the K'-channel mix happens inside the matmul contraction instead of
as K' separate dots + adds.  No per-seed matrices ever exist.

The column axis is zero-padded to a multiple of 128 ONLY when C > 128.
The rule was sized for a 128-wide matrix tile; it stays as it is until it
is measured on and off on the GPU.  Padded columns carry zero state and
zero weights and are sliced off before the fidelity/penalty reductions.

Scope: any number of concerned vectors (coherent inner_product_2D group
fidelity), state transfer or unitary mode (any taylor_scaling —
squarings run as repeated pre-scaled Taylor applications to the state
block, so no per-seed matrices exist), pulse-only penalties PLUS the
trajectory penalties: forbidden-state occupation (static projection rows
inside the scan carry — dressed rotation folded in host-side,
regularization_functions.py:71-85 via ``forbidden_static``) AND speed_up
(per-step coherent target overlap accumulated in the scan carry,
regularization_functions.py:88-95); constant-weight extra sweep
channels.  Used by make_batched_runner as the GPU seed-batch backend.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..models.costs import CostContext, total_reg_cost
from ..models.system import ControlProblem

HI = lax.Precision.HIGHEST

_FORB_KEYS = ("forbidden_coeff_list", "forbidden",
              "states_forbidden_list", "forbid_dressed")


def _forbidden_pairs(reg_coeffs):
    """[(coeff, level), ...] from either spelling, or []."""
    rc = reg_coeffs or {}
    coeffs = rc.get("forbidden_coeff_list", rc.get("forbidden"))
    if coeffs is None:
        return []
    return list(zip(coeffs, rc["states_forbidden_list"]))


def forbidden_static(problem, reg_coeffs):
    """Host-side statics for the forbidden-state penalties.

    Returns (forb, c0): ``forb`` is a tuple of (alpha, rs, rns) with the
    (optional) dressed rotation folded into per-level projection rows
    rs[j] = R[j, s], rns[j] = R[j, N+s] (one-hot when undressed,
    regularization_functions.py:73-80), and ``c0`` the constant t=0 (psi0)
    contribution — inter_vecs[0] is the RAW initial vectors in both modes.
    """
    rc = reg_coeffs or {}
    pairs = _forbidden_pairs(rc)
    Nc = problem.state_num
    R = (
        np.asarray(problem.v_sorted_iso, dtype=np.float64)
        if (problem.v_sorted_iso is not None
            and rc.get("forbid_dressed", False))
        else None
    )
    forb = []
    c0 = 0.0
    iv0 = np.asarray(problem.initial_vectors, dtype=np.float64)   # [2N, V]
    rot0 = iv0 if R is None else R.T @ iv0
    for coeff, s in pairs:
        alpha = float(coeff) / problem.steps
        if R is None:
            rs = tuple(1.0 if j == s else 0.0 for j in range(2 * Nc))
            rns = tuple(1.0 if j == Nc + s else 0.0 for j in range(2 * Nc))
        else:
            rs = tuple(float(x) for x in R[:, s])
            rns = tuple(float(x) for x in R[:, Nc + s])
        forb.append((alpha, rs, rns))
        pop0 = rot0[s] ** 2 + rot0[Nc + s] ** 2
        c0 += alpha * 0.5 * float(np.sum(pop0 ** 2))
    return tuple(forb), c0


def xla_cols_supported(problem: ControlProblem,
                       reg_coeffs: Optional[dict]) -> bool:
    rc = reg_coeffs or {}
    # any V: the per-seed group reductions here are plain XLA reshapes
    # (V=12 parity-tested vs the vmapped forward in tests/test_xla_batch.py)
    trajectory_keys = ("forbidden_coeff_list", "forbidden", "speed_up")
    if any(k in rc for k in trajectory_keys) and not problem.use_inter_vecs:
        # match costs.py's loud requirement: trajectory penalties need
        # intermediate states (the vmapped fallback raises the same error)
        return False
    return True


def make_xla_batched_loss(
    problem: ControlProblem,
    reg_coeffs: Optional[dict] = None,
    extra_channel_mats: Optional[np.ndarray] = None,
    remat: bool = True,
):
    """Build ``u_bases [S, K, T] -> (reg_losses [S], fid_losses [S])``.

    ``extra_channel_mats`` ([E, 2N, 2N] real iso) adds fixed operator
    channels with constant per-seed weights ``extra_weights [S, E]``.
    ``remat`` checkpoints each scan step (recompute-in-backward — the
    trajectory at [T, M, C] would otherwise dominate device memory for large M).
    """
    p = problem
    rc = reg_coeffs or {}
    mats_list = [jnp.asarray(p.mats)]
    if extra_channel_mats is not None:
        mats_list.append(jnp.asarray(extra_channel_mats, dtype=jnp.float32))
    mats = jnp.concatenate(mats_list, axis=0)          # [K', M, M]
    Kp = mats.shape[0]
    M = mats.shape[1]
    # horizontal stack [M, K'M] with mats_h[i, k*M+j] = mats[k, i, j]: one
    # deep-contraction matmul per Taylor term (see module docstring)
    mats_h = jnp.reshape(jnp.transpose(mats, (1, 0, 2)), (M, Kp * M))
    psi0 = jnp.asarray(p.initial_vectors)              # [M, V]
    if not p.state_transfer:
        psi0 = jnp.matmul(jnp.asarray(p.U0_iso), psi0, precision=HI)
    tgt = jnp.asarray(p.target_vectors)                # [M, V]
    V = psi0.shape[1]
    max_amp = jnp.asarray(p.ops_max_amp)
    one_minus_gauss = jnp.asarray(p.one_minus_gauss)
    N = p.state_num
    T = p.steps
    # forbidden-state penalty statics: per-term (alpha, projection rows)
    # with the optional dressed rotation folded in host-side
    forb, forb_c0 = forbidden_static(p, rc)
    if forb:
        f_alphas = jnp.asarray([f[0] for f in forb], dtype=jnp.float32)
        f_rows_s = jnp.asarray([f[1] for f in forb], dtype=jnp.float32)
        f_rows_ns = jnp.asarray([f[2] for f in forb], dtype=jnp.float32)
    # speed_up (regularization_functions.py:88-95): per-timestep coherent
    # target overlap, accumulated in the scan carry instead of storing
    # inter_vecs.  On the real iso, Re<psi|tgt> = psi . [c; d] and
    # Im<psi|tgt> = psi . [-d; c] — two column dots per step.
    has_su = "speed_up" in rc
    if has_su:
        su_alpha = float(rc["speed_up"]) / float(T)
        tgt_re_1 = tgt                                     # [M, V]
        tgt_im_1 = jnp.concatenate([-tgt[N:, :], tgt[:N, :]], axis=0)
        # t=0 term: inter_vecs[0] is the RAW packed psi0 in BOTH modes
        # (tensorflow_state.py:229-242 — U0 enters only from t=1), and it
        # is seed-independent, so it is one scalar
        psi0_raw = jnp.asarray(p.initial_vectors)
        re0 = jnp.sum(psi0_raw * tgt_re_1)
        im0 = jnp.sum(psi0_raw * tgt_im_1)
        su0_scalar = (re0 * re0 + im0 * im0) * (1.0 / (V * V))
    pulse_rc = {k: v for k, v in rc.items()
                if k not in _FORB_KEYS and k != "speed_up"}
    # matvec truncation (powers 0..order-1) for state transfer; unitary
    # mode keeps powers 0..taylor_terms (the ops/expm.py convention).  With
    # taylor_scaling s > 0, exp(A) = Taylor(A/2^s)^(2^s)
    # (tensorflow_state.py:31,43-44): on the column layout the step is
    # 2^s repeated Taylor applications of the pre-scaled generator to the
    # state block — the matrix squarings never materialize.
    order = p.taylor_terms if p.state_transfer else p.taylor_terms + 1
    scaling = 0 if p.state_transfer else p.taylor_scaling
    reps = 1 << scaling
    csc = 1.0 / reps

    def batched_loss(u_bases: jnp.ndarray,
                     extra_weights: Optional[jnp.ndarray] = None):
        S = u_bases.shape[0]
        C = S * V
        # pad the column axis to a multiple of 128 ONLY above 128 columns
        # (zero state + zero weights; sliced off before the reductions) —
        # at C <= 128 the pad would up-to-double the work (module docstring)
        Cp = C + ((-C) % 128 if C > 128 else 0)
        ops_weight = jnp.sin(u_bases)                          # [S, Kc, T]
        amps = max_amp[None, :, None] * ops_weight
        chans = [jnp.ones((S, 1, T), dtype=amps.dtype), amps]
        if extra_weights is not None:
            chans.append(jnp.broadcast_to(
                extra_weights[:, :, None].astype(amps.dtype),
                (S, extra_weights.shape[1], T)))
        w = jnp.concatenate(chans, axis=1)                     # [S, K', T]
        w_t = jnp.transpose(w, (2, 1, 0))                      # [T, K', S]
        if V > 1:
            w_t = jnp.repeat(w_t, V, axis=2)                   # [T, K', C]
        if Cp != C:
            w_t = jnp.pad(w_t, ((0, 0), (0, 0), (0, Cp - C)))
        psi_cols = jnp.tile(psi0, (1, S))                      # [M, C]
        if Cp != C:
            psi_cols = jnp.pad(psi_cols, ((0, 0), (0, Cp - C)))
        pen0 = jnp.zeros((Cp,), dtype=jnp.float32)
        if has_su:
            tgt_re = jnp.tile(tgt_re_1, (1, S))                # [M, C]
            tgt_im = jnp.tile(tgt_im_1, (1, S))
            if Cp != C:
                tgt_re = jnp.pad(tgt_re, ((0, 0), (0, Cp - C)))
                tgt_im = jnp.pad(tgt_im, ((0, 0), (0, Cp - C)))

        def seed_overlap(psi):
            """Coherent per-seed |<psi|tgt>|^2 / V^2 at one timestep."""
            re = jnp.sum(psi * tgt_re, axis=0)                 # [Cp]
            im = jnp.sum(psi * tgt_im, axis=0)
            re_s = jnp.sum(re[:C].reshape(S, V), axis=1)       # [S]
            im_s = jnp.sum(im[:C].reshape(S, V), axis=1)
            return (re_s * re_s + im_s * im_s) * (1.0 / (V * V))

        # t=0 term of the speed_up sum (inter_vecs includes the RAW
        # initial state, tensorflow_state.py:229-242; constant per seed)
        su0 = jnp.full((S,), su0_scalar, dtype=jnp.float32) if has_su \
            else jnp.zeros((S,), dtype=jnp.float32)

        def step(carry, wt):                                   # psi [M, Cp]
            psi, pen, su = carry
            for _ in range(reps):
                acc = psi
                pn = psi
                for n in range(1, order):
                    # stacked[k*M+j, c] = pn[j, c] * wt[k, c]
                    stacked = jnp.reshape(pn[None, :, :] * wt[:, None, :],
                                          (Kp * M, Cp))
                    pn = jnp.matmul(mats_h, stacked, precision=HI) \
                        * (csc / n)
                    acc = acc + pn
                psi = acc
            if forb:
                # level populations of the (possibly dressed) forbidden
                # rows at this timestep, accumulated as sum_t pop^2
                phi_s = jnp.matmul(f_rows_s, psi, precision=HI)
                phi_ns = jnp.matmul(f_rows_ns, psi, precision=HI)
                pop = phi_s * phi_s + phi_ns * phi_ns          # [F, Cp]
                pen = pen + jnp.sum(
                    f_alphas[:, None] * 0.5 * pop * pop, axis=0)
            if has_su:
                su = su + seed_overlap(psi)
            return (psi, pen, su), None

        body = jax.checkpoint(step) if remat else step
        (final, pen, su), _ = lax.scan(body, (psi_cols, pen0, su0), w_t)
        final = final[:, :C]

        # coherent group fidelity over each seed's V columns
        # (get_inner_product_2D, tensorflow_state.py:282-300)
        a = final[:N, :].reshape(N, S, V)
        b = final[N:, :].reshape(N, S, V)
        c, d = tgt[:N, :], tgt[N:, :]
        re = (jnp.einsum("nsv,nv->s", a, c, precision=HI)
              + jnp.einsum("nsv,nv->s", b, d, precision=HI))
        im = (jnp.einsum("nsv,nv->s", b, c, precision=HI)
              - jnp.einsum("nsv,nv->s", a, d, precision=HI))
        fid_losses = 1.0 - (re * re + im * im) * (1.0 / (V * V))

        reg_losses = fid_losses
        if forb:
            pen_seed = jnp.sum(pen[:C].reshape(S, V), axis=1) + forb_c0
            reg_losses = reg_losses + pen_seed
        if has_su:
            # alpha * 0.5 * (T+1 - sum_t ip_t)^2 (costs.py speed_up_cost)
            miss = float(T + 1) - su
            reg_losses = reg_losses + su_alpha * 0.5 * miss * miss
        if pulse_rc:
            def seed_reg(w_s):
                ctx = CostContext(
                    ops_weight=w_s, inter_vecs=None, target_vecs=tgt,
                    state_num=N, steps=T, dt=p.dt, total_time=p.total_time,
                    one_minus_gauss=one_minus_gauss, v_sorted_iso=None,
                )
                return total_reg_cost(ctx, pulse_rc)

            reg_losses = reg_losses + jax.vmap(seed_reg)(ops_weight)
        return reg_losses, fid_losses

    return batched_loss


def make_xla_cols_sharded_runner(
    problem: ControlProblem,
    conv,
    mesh,
    reg_coeffs: Optional[dict] = None,
    extra_channel_mats: Optional[np.ndarray] = None,
):
    """shard_map'd fixed-count Adam segments on the column-batched loss —
    the multi-device execution path for LARGE-dim sweeps (BASELINE
    config 5).

    Every device runs ``n`` complete Adam iterations on its LOCAL seed
    shard with ZERO collectives: seeds are independent, all state is
    seed-sharded, and (unlike the while_loop driver in batch.py, whose
    cross-seed ``any(~done)`` adds one scalar all-reduce per iteration)
    the fixed-count segment never communicates.  Several hosts work the
    same way after ``jax.distributed.initialize`` — each host launches
    its own shard.

    Returns ``run(u_bases [S, K, T], n, extra_weights [S, E] | None) ->
    (u' [S, K, T], losses [S], reg_losses [S])`` with the batch.py body's
    metric convention (losses evaluated at the pre-update iterate of the
    final iteration).  The jitted segment is cached per (n, S).
    """
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..optim.adam import make_adam_optimizer

    batched_loss = make_xla_batched_loss(
        problem, reg_coeffs, extra_channel_mats=extra_channel_mats)
    optimizer = make_adam_optimizer(conv)
    axis = mesh.axis_names[0]
    have_ew = extra_channel_mats is not None
    _cache: dict = {}

    def _seg(n: int):
        if n in _cache:
            return _cache[n]

        def local_seg(u_loc, ew_loc):
            ew = ew_loc if have_ew else None
            opt_state = optimizer.init(u_loc)

            def total(x):
                regs, fids = batched_loss(x, ew)
                return jnp.sum(regs), (regs, fids)

            def body(i, carry):
                u, os_, _, _ = carry
                (_, (regs, fids)), g = jax.value_and_grad(
                    total, has_aux=True)(u)
                updates, os_ = optimizer.update(g, os_, u)
                return (optax.apply_updates(u, updates), os_, fids, regs)

            z = jnp.zeros((u_loc.shape[0],), dtype=jnp.float32)
            u, _, fids, regs = lax.fori_loop(
                0, n, body, (u_loc, opt_state, z, z))
            return u, fids, regs

        specs_in = (P(axis), P(axis) if have_ew else P(axis))
        fn = jax.jit(jax.shard_map(
            local_seg, mesh=mesh,
            in_specs=specs_in,
            out_specs=(P(axis), P(axis), P(axis)),
            check_vma=False,
        ))
        _cache[n] = fn
        return fn

    def run(u_bases, n: int, extra_weights=None):
        shard = NamedSharding(mesh, P(axis))
        u = jax.device_put(jnp.asarray(u_bases, dtype=jnp.float32), shard)
        if have_ew:
            ew = jax.device_put(
                jnp.asarray(extra_weights, dtype=jnp.float32), shard)
        else:
            # dummy sharded operand keeps the signature static
            ew = jax.device_put(
                jnp.zeros((u.shape[0], 1), dtype=jnp.float32), shard)
        return _seg(int(n))(u, ew)

    run.lower_segment = lambda u_bases, n, extra_weights=None: _seg(
        int(n)).lower(
            jnp.asarray(u_bases, dtype=jnp.float32),
            jnp.asarray(extra_weights, dtype=jnp.float32) if have_ew
            else jnp.zeros((np.shape(u_bases)[0], 1), dtype=jnp.float32))
    return run
