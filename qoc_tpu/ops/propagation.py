"""Time propagation engines: scan, associative-scan, and state-transfer.

The reference builds a TF1 graph with ``steps`` chained matexp nodes
(tensorflow_state.py:204-261) — graph size O(steps), serial execution.  Here
propagation batches over time:

  * **Step generators** for *all* timesteps come from one einsum
    (``weighted_hamiltonians``) and the per-step matrix exponentials are one
    *batched* Taylor evaluation ``[T, M, M]`` — every matmul in the series is
    a T-way batched matmul instead of T small serial ones.
  * **Unitary chain** engines:
      - ``pscan`` (the accelerator default at M >= 16): the squaring branch
        expands into repeated serial sub-steps of the pre-squared Taylor
        propagator and the rank-V matvec-adjoint VJP carries the
        gradient — see ``pscan_chain`` / ``evolve_unitary_pscan``.
      - ``associative``: ``lax.associative_scan`` over batched matmul —
        O(log T) depth, all compute batched.  This is the parallel-in-time
        option SURVEY.md section 5 calls out; the accelerator default for
        small dimensions (final-only losses reduce through
        ``chain_product_tree``).
      - ``scan``: ``lax.scan`` carrying (U, psi) — flops-optimal for large M.
  * **State transfer** engines mirror the same ladder (pscan /
    associative / scan), mirroring tensorflow_state.py:244-261 semantics.

Gradient modes:
  * ``exact``  — plain JAX autodiff through the batched series (the forward
    approximant's true derivative).
  * ``reference`` — ``jax.custom_vjp`` replicating the reference's
    first-order GRAPE gradient for the coefficients
    (tensorflow_state.py:61-63, :112-114) and the adjoint ``exp(-A)``
    back-propagation of the state cotangent (:118-133), so optimization
    trajectories can be compared against the reference step-for-step.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from .expm import HIGHEST, _bmm, taylor_expm, taylor_expm_matvec, weighted_hamiltonians


# ---------------------------------------------------------------------------
# Step propagators (batched over time)
# ---------------------------------------------------------------------------


def step_propagators(mats, weights, order: int, scaling: int):
    """All per-timestep propagators ``P_t = exp(sum_k w[k,t] mats[k])``.

    mats: [K, M, M]; weights: [K, T]  ->  [T, M, M]
    """
    A = weighted_hamiltonians(mats, weights)
    return taylor_expm(A, order, scaling)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def step_propagators_ref_grad(mats, weights, order: int, scaling: int):
    """Batched step propagators with the *reference's* approximate gradient.

    Forward identical to ``step_propagators``.  Backward implements
    matexp_op_grad (tensorflow_state.py:49-65):
        dL/dw[k,t] = sum_ij  Gbar[t] * (mats[k] @ P[t]),   k >= 1
        dL/dw[0,t] = 0      (drift weight gets zero gradient, :54)
        dL/dmats   = 0      (:65)
    """
    return step_propagators(mats, weights, order, scaling)


def _step_ref_fwd(mats, weights, order, scaling):
    P = step_propagators(mats, weights, order, scaling)
    return P, (mats, P)


def _step_ref_bwd(order, scaling, res, G):
    mats, P = res
    # X[t] = G[t] @ P[t]^T ;  wbar[k,t] = sum_ij mats[k,i,j] X[t,i,j]
    X = jnp.einsum("tim,tjm->tij", G, P, precision=HIGHEST)
    wbar = jnp.einsum("kij,tij->kt", mats, X, precision=HIGHEST)
    wbar = wbar.at[0, :].set(0.0)
    return (jnp.zeros_like(mats), wbar)


step_propagators_ref_grad.defvjp(_step_ref_fwd, _step_ref_bwd)


# ---------------------------------------------------------------------------
# Unitary-mode chains
# ---------------------------------------------------------------------------


def chain_associative(P, U0, psi0):
    """Cumulative products via parallel-in-time associative scan.

    P: [T, M, M] step propagators; U0: [M, M]; psi0: [M, V].
    Returns (final_U [M,M], inter_vecs [T+1, M, V]).

    inter_states[t] = P_t @ ... @ P_0 @ U0   (tensorflow_state.py:214-220)
    """
    cum = lax.associative_scan(lambda a, b: _bmm(b, a), P)
    cumU = _bmm(cum, U0)  # [T, M, M]
    final_U = cumU[-1]
    vecs = _bmm(cumU, psi0)  # [T, M, V]
    inter_vecs = jnp.concatenate([psi0[None], vecs], axis=0)
    return final_U, inter_vecs


def chain_scan(P, U0, psi0, unroll: int = 1):
    """Serial scan chain carrying (U, psi) — flops-optimal for large M.

    The vector chain starts from ``U0 @ psi0``: the reference's
    inter_states include U0 (tensorflow_state.py:211-214) and
    inter_vec_t = inter_states[t] @ psi0, while entry 0 is the RAW packed
    psi0 (:233-238).  (Round-5 fix: the chain previously started the
    vector carry at psi0, silently dropping a non-identity U0 from the
    intermediate vectors — matching chain_associative and the reference
    now.)"""

    def body(carry, Pt):
        U, psi = carry
        U = _bmm(Pt, U)
        psi = _bmm(Pt, psi)
        return (U, psi), psi

    (final_U, _), vecs = lax.scan(body, (U0, _bmm(U0, psi0)), P,
                                  unroll=unroll)
    inter_vecs = jnp.concatenate([psi0[None], vecs], axis=0)
    return final_U, inter_vecs


def chain_scan_novecs(P, U0, unroll: int = 1):
    """Serial chain without intermediate vectors (use_inter_vecs=False)."""

    def body(U, Pt):
        return _bmm(Pt, U), None

    final_U, _ = lax.scan(body, U0, P, unroll=unroll)
    return final_U


def chain_product_tree(P):
    """Product P[T-1] @ ... @ P[0] via pairwise tree reduction.

    O(log T) depth of batched matmuls, ~2T matmul flops total, and — unlike
    ``lax.associative_scan`` — its VJP only touches the tree (cotangent on
    the single root), so it is the right primitive when ONLY the final
    propagator/state is needed.
    """
    while P.shape[0] > 1:
        T = P.shape[0]
        half = T // 2
        even = P[0 : 2 * half : 2]
        odd = P[1 : 2 * half : 2]
        prod = _bmm(odd, even)  # later-time factor on the left
        if T % 2 == 1:
            prod = jnp.concatenate([prod, P[T - 1 :]], axis=0)
        P = prod
    return P[0]


# ---------------------------------------------------------------------------
# Engine ladders (single source of truth — used by the chains, by
# models/forward.py, and by routing.py's announcements)
# ---------------------------------------------------------------------------


def resolve_state_engine(M: int, T: int, gradient_mode: str,
                         on_gpu: bool) -> str:
    """The state-transfer auto ladder: pscan (matvec-adjoint, M >= 16) ->
    associative (small M; final-only losses reduce through the product
    tree) -> scan (CPU, reference gradients, and the memory fallback)."""
    if gradient_mode == "exact" and on_gpu:
        if M >= 16 and 8 * T * M * M < (1 << 31):
            return "pscan"
        if 4 * T * M * M * 3 < (1 << 30):
            return "associative"
    return "scan"


def resolve_unitary_engine(M: int, T: int, scaling: int,
                           gradient_mode: str, on_gpu: bool) -> str:
    """The unitary-mode auto ladder (models/forward.py): pscan (rank-V
    adjoint via squaring expansion, M >= 16) -> associative / scan by
    memory."""
    if gradient_mode == "exact" and on_gpu:
        reps = 1 << scaling
        if M >= 16 and 8 * T * reps * M * M < (1 << 31):
            return "pscan"
    return pick_engine(M, T)


# ---------------------------------------------------------------------------
# State-transfer chain
# ---------------------------------------------------------------------------


def _pscan_run(mats, weights, psi0, order, reps):
    A = weighted_hamiltonians(mats, weights)
    if reps > 1:
        A = A / reps                  # exp(A) = Q^reps, Q = Taylor(A/reps)
    Q = taylor_expm(A, order - 1, 0)  # powers 0..order-1, no squaring

    def body(psi, Qt):
        outs = []
        for _ in range(reps):
            psi = jnp.matmul(Qt, psi, precision=HIGHEST)
            outs.append(psi)
        return psi, jnp.stack(outs)   # [reps, M, V]

    _, v = lax.scan(body, psi0, Q, unroll=8 if reps == 1 else 2)
    T, M, V = weights.shape[1], psi0.shape[0], psi0.shape[1]
    flat = v.reshape(T * reps, M, V)
    vecs = jnp.concatenate([psi0[None], flat], axis=0)
    return vecs, A, Q


def pscan_chain(mats, weights, psi0, order, reps=1):
    """Batched-propagator state chain — tile padding wrapper.

    Zero-pads M up to the next multiple of 128 when the data growth is
    small ((Mp/M)^2 <= 1.3 — M=120 qualifies, M=400 -> 512 does not).  The
    rule was sized for a 128-wide matrix tile and is kept as it stands
    until it is measured on and off on the GPU.  Padded generator
    rows/columns are zero, so the padded block of Q is exactly the
    identity acting on zero state rows — the math is unchanged, and
    pad/slice are linear ops autodiff handles around the custom-VJP core
    (``_pscan_chain_core``).
    """
    M = psi0.shape[0]
    Mp = M + (-M) % 128
    if Mp != M and 10 * Mp * Mp <= 13 * M * M:
        pad = Mp - M
        mats_p = jnp.pad(mats, ((0, 0), (0, pad), (0, pad)))
        psi0_p = jnp.pad(psi0, ((0, pad), (0, 0)))
        vecs = _pscan_chain_core(mats_p, weights, psi0_p, order, reps)
        return vecs[:, :M, :]
    return _pscan_chain_core(mats, weights, psi0, order, reps)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4))
def _pscan_chain_core(mats, weights, psi0, order, reps=1):
    """Batched-propagator state chain with a matvec-adjoint backward.

    Forward (the ``pscan`` engine): Q_t = Taylor_{0..order-1}(A_t / reps)
    as ONE batched [T, M, M] series, then the serial state
    sweep applying Q_t ``reps`` times per timestep (``reps = 2**scaling``
    expands the unitary-mode squaring chain into repeated sub-steps —
    exp(A) = Taylor(A/2^s)^(2^s), tensorflow_state.py:31,43-44).
    Returns the full sub-step trajectory ``[T*reps + 1, M, V]``; for
    state transfer reps=1 and this is the ordinary [T+1, M, V].

    Backward: the trajectory cotangent against a matrix product chain is
    rank-V per step, so the exact polynomial gradient needs NO M^3 work —
    this is the GRAPE adjoint (the reference's matvecexp_op_grad idea,
    tensorflow_state.py:118-133, made exact and batched):

      * reverse adjoint sweep  lam_{i-1} = Q^T lam_i + g_{i-1}
        (T*reps serial transpose-matvecs);
      * batched power ladders  f_l = A^l psi_prev,  b_j = (A^T)^j lam
        over every sub-step (each ladder step is one bandwidth pass over
        A — parallel over t);
      * exact truncated-series pairing
          Abar_t = sum_r sum_{j+l+1 <= q} b_j f_l^T / (j+l+1)!
        (two batched matmuls via the coefficient table), then
        wbar = <mats_k, Abar_t>/reps, matsbar = sum_t w_kt Abar_t / reps.

    This removes the 2x-forward M^3 Taylor backward of plain autodiff.
    """
    vecs, _, _ = _pscan_run(mats, weights, psi0, order, reps)
    return vecs


def _pscan_chain_fwd(mats, weights, psi0, order, reps):
    vecs, A, Q = _pscan_run(mats, weights, psi0, order, reps)
    return vecs, (mats, weights, A, Q, vecs)


def _pscan_chain_bwd(order, reps, res, g):
    import numpy as _np

    mats, weights, A, Q, vecs = res
    q = order - 1                     # highest kept power in Q
    T = weights.shape[1]
    M, V = vecs.shape[1], vecs.shape[2]
    g0 = g[0]
    gsub = g[1:].reshape(T, reps, M, V)

    # reverse adjoint sweep over blocks t = T-1..0; carry mu = the
    # cotangent pulled back through the first sub-step of block t+1.
    # Within a block, sub-steps r = reps-1..0:
    #   lam_{t,r} = mu + g[t,r];  mu = Q_t^T lam_{t,r}
    def body(mu, xs):
        Qt, gt = xs                   # gt: [reps, M, V]
        QtT = jnp.swapaxes(Qt, -1, -2)
        lams_r = [None] * reps
        for r in range(reps - 1, -1, -1):
            lam = mu + gt[r]
            lams_r[r] = lam
            mu = jnp.matmul(QtT, lam, precision=HIGHEST)
        return mu, jnp.stack(lams_r)  # [reps, M, V]

    mu0, lams = lax.scan(body, jnp.zeros_like(g0), (Q, gsub),
                         reverse=True, unroll=8 if reps == 1 else 2)
    psi0_bar = mu0 + g0
    # lams[t, r] = full cotangent of the state AFTER sub-step (t, r)

    if q < 1:
        return jnp.zeros_like(mats), jnp.zeros_like(weights), psi0_bar

    # states BEFORE each sub-step, in the same [T, reps, M, V] layout
    pre = vecs[:-1].reshape(T, reps, M, V)
    At = jnp.swapaxes(A, -1, -2)

    def ladder(A_, x0):               # [T, reps, M, V] -> [T, reps, q, M, V]
        xs = [x0]
        for _ in range(1, q):
            xs.append(jnp.einsum("tmn,trnv->trmv", A_, xs[-1],
                                 precision=HIGHEST))
        return jnp.stack(xs, axis=2)

    F = ladder(A, pre)                # f_l = A^l psi_prev
    B = ladder(At, lams)              # b_j = (A^T)^j lam

    fact = _np.ones(2 * q, dtype=_np.float64)
    for n in range(1, 2 * q):
        fact[n] = fact[n - 1] * n
    C = _np.zeros((q, q), dtype=_np.float32)
    for j in range(q):
        for l in range(q):
            if j + l + 1 <= q:
                C[j, l] = 1.0 / fact[j + l + 1]
    C = jnp.asarray(C)

    CF = jnp.einsum("jl,trlnv->trjnv", C, F, precision=HIGHEST)
    Abar = jnp.einsum("trjmv,trjnv->tmn", B, CF, precision=HIGHEST)
    inv = 1.0 / reps                  # dA_scaled/dw = mats/reps
    wbar = inv * jnp.einsum("kmn,tmn->kt", mats, Abar, precision=HIGHEST)
    matsbar = inv * jnp.einsum("kt,tmn->kmn", weights, Abar,
                               precision=HIGHEST)
    return matsbar, wbar, psi0_bar


_pscan_chain_core.defvjp(_pscan_chain_fwd, _pscan_chain_bwd)


def evolve_unitary_pscan(mats, weights, U0, psi0, order, scaling,
                         use_inter_vecs):
    """Unitary-mode forward through the state-column pscan chain.

    The optimization loss in unitary mode reads the final unitary ONLY
    through ``final_vecs = U_total @ psi0`` (rank-V), so the gradient can
    ride the same matvec-adjoint chain as state transfer: the squaring
    branch exp(A) = Taylor(A/2^s)^(2^s) expands into ``2^s`` repeated
    Q-applications per timestep (``pscan_chain`` reps).  The
    ``unitary_scale`` diagnostic 0.5/N * sum(F^T F) needs no full
    unitary either: sum_ij (F^T F)_ij = ||F @ 1||^2, so ONE extra
    propagated ones-column yields it exactly.

    Returns (final_vecs [M, V], unitary_scale scalar, inter_vecs or
    None).  The full final unitary, when a caller needs it for output,
    should be computed forward-only (stop_gradient product tree) — see
    models/forward.py.
    """
    reps = 1 << scaling
    M = psi0.shape[0]
    V = psi0.shape[1]
    N = M // 2
    s0 = jnp.matmul(U0, psi0, precision=HIGHEST)
    ones_col = jnp.matmul(U0, jnp.ones((M, 1), dtype=psi0.dtype),
                          precision=HIGHEST)
    cols = jnp.concatenate([s0, ones_col], axis=1)
    vecs_all = pscan_chain(mats, weights, cols, order + 1, reps)
    final = vecs_all[-1]
    final_vecs = final[:, :V]
    unitary_scale = (0.5 / N) * jnp.sum(jnp.square(final[:, V]))
    inter_vecs = None
    if use_inter_vecs:
        # reference convention: entry 0 is the RAW packed psi0
        # (tensorflow_state.py:229-242); entries >= 1 include U0
        inter_vecs = jnp.concatenate(
            [psi0[None], vecs_all[reps::reps, :, :V]], axis=0)
    return final_vecs, unitary_scale, inter_vecs


def _matvec_step(A, psi, order: int):
    return taylor_expm_matvec(A, psi, order)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def _matvec_step_ref(mats, w_t, psi, order: int):
    """One state-transfer step with the reference's custom gradient.

    Forward: psi' = exp(A_t) psi with A_t = sum_k w_t[k] mats[k], Taylor
    order ``order-1`` (tensorflow_state.py:77-97).
    Backward (matvecexp_op_grad, :100-133):
        wbar[k]  = sum( Gbar * (mats[k] @ psi') ),  k >= 1;  wbar[0] = 0
        psibar   = exp(-A_t) Gbar   (adjoint evolution of the cotangent)
    """
    A = jnp.einsum("k,kij->ij", w_t, mats, precision=HIGHEST)
    return taylor_expm_matvec(A, psi, order)


def _matvec_ref_fwd(mats, w_t, psi, order):
    A = jnp.einsum("k,kij->ij", w_t, mats, precision=HIGHEST)
    out = taylor_expm_matvec(A, psi, order)
    return out, (mats, w_t, out)


def _matvec_ref_bwd(order, res, G):
    mats, w_t, out = res
    Hk_out = jnp.einsum("kij,jv->kiv", mats, out, precision=HIGHEST)
    wbar = jnp.einsum("kiv,iv->k", Hk_out, G, precision=HIGHEST)
    wbar = wbar.at[0].set(0.0)
    A_neg = jnp.einsum("k,kij->ij", -w_t, mats, precision=HIGHEST)
    psibar = taylor_expm_matvec(A_neg, G, order)
    return (jnp.zeros_like(mats), wbar, psibar)


_matvec_step_ref.defvjp(_matvec_ref_fwd, _matvec_ref_bwd)


def state_transfer_chain(
    mats,
    weights,
    psi0,
    order: int,
    gradient_mode: str = "exact",
    remat: bool = False,
    engine: str = "auto",
    final_only: bool = False,
):
    """Evolve stacked state vectors through all timesteps.

    mats: [K, M, M]; weights: [K, T]; psi0: [M, V].
    Returns inter_vecs [T+1, M, V]; final state is inter_vecs[-1]
    (tensorflow_state.py:244-261).  With ``final_only``, returns just
    ``[1, M, V]`` (the final state) and uses the cheapest formulation
    (product tree / output-free scan).

    Engines:
      * ``associative``: form all step propagators with a batched Taylor
        series (same truncation order-1, no scaling — the state-transfer
        convention) and cumulative-product them with
        ``lax.associative_scan`` — O(log T) depth instead of T serial
        matvecs.  Only for exact gradients.
      * ``pscan``: batched Taylor step propagators (parallel over the time
        axis) + a serial [M,M]@[M,V] state scan with the
        matvec-adjoint custom VJP (``pscan_chain``) — same math as
        ``associative`` with the O(T) cumulative matrix products replaced
        by O(T) mat-VECS and the M^3 Taylor backward replaced by batched
        power ladders.  Only for exact gradients.
      * ``scan``: the serial matvec recursion (flops-optimal, required for
        the reference gradient mode whose custom VJP is per-step).
    """
    if engine == "auto":
        from ..routing import on_gpu

        engine = resolve_state_engine(
            mats.shape[-1], weights.shape[-1], gradient_mode, on_gpu())

    if engine == "associative" and gradient_mode == "exact":
        # Taylor series with the matvec truncation (powers 0..order-1),
        # applied to matrices: matches the serial chain exactly.
        P = step_propagators(mats, weights, order - 1, 0)
        if final_only:
            final = _bmm(chain_product_tree(P), psi0)
            return final[None]
        cum = lax.associative_scan(lambda a, b: _bmm(b, a), P)
        vecs = _bmm(cum, psi0)
        return jnp.concatenate([psi0[None], vecs], axis=0)

    if engine == "pscan" and gradient_mode == "exact":
        # batched Taylor (same matvec truncation) + serial state scan,
        # with the matvec-adjoint custom VJP (see pscan_chain): the
        # parallel [T,M,M] work is batched, the serial sweeps are
        # mat-VECS in both directions, and the backward needs no M^3
        # Taylor re-differentiation.  Its memory never exceeds P + the
        # power ladders, where the associative form's autodiff keeps every
        # cumulative product alive.
        vecs = pscan_chain(mats, weights, psi0, order, 1)
        if final_only:
            return vecs[-1][None]
        return vecs

    if gradient_mode == "reference":

        def step(psi, w_t):
            return _matvec_step_ref(mats, w_t, psi, order)

    else:

        def step(psi, w_t):
            A = jnp.einsum("k,kij->ij", w_t, mats, precision=HIGHEST)
            return _matvec_step(A, psi, order)

    if final_only:
        if remat:
            # O(sqrt(T)) memory: two-level scan with rematerialized chunks
            # (the reference's recompute-in-backward Defun generalized,
            # tensorflow_state.py:58; SURVEY.md section 5 long-horizon row).
            # Zero-padded steps are exact no-ops (all weights 0 -> A=0 ->
            # exp(0) psi = psi at any Taylor order).
            T = weights.shape[1]
            K = weights.shape[0]
            chunk = max(int(T ** 0.5), 1)
            Tc = -(-T // chunk) * chunk
            w_t = jnp.pad(weights.T, ((0, Tc - T), (0, 0)))
            w_chunks = w_t.reshape(Tc // chunk, chunk, K)

            @jax.checkpoint
            def outer(psi, wchunk):
                def inner(psi, w_row):
                    return step(psi, w_row), None

                psi, _ = lax.scan(inner, psi, wchunk)
                return psi, None

            final, _ = lax.scan(outer, psi0, w_chunks)
            return final[None]
        body = lambda psi, w_t: (step(psi, w_t), None)
        final, _ = lax.scan(body, psi0, weights.T)
        return final[None]

    body = lambda psi, w_t: ((lambda out: (out, out))(step(psi, w_t)))
    if remat:
        body = jax.checkpoint(body)
    _, vecs = lax.scan(body, psi0, weights.T)
    return jnp.concatenate([psi0[None], vecs], axis=0)


# ---------------------------------------------------------------------------
# Full forward model
# ---------------------------------------------------------------------------


def evolve_unitary(
    mats,
    weights,
    U0,
    psi0,
    order: int,
    scaling: int,
    gradient_mode: str = "exact",
    engine: str = "associative",
    use_inter_vecs: bool = True,
    remat: bool = False,
):
    """Unitary-mode forward: returns (final_U, inter_vecs or None).

    The per-step generator coefficients are pre-divided by 2**scaling
    (tensorflow_state.py:31) inside ``taylor_expm``.
    """
    if gradient_mode == "reference":
        P = step_propagators_ref_grad(mats, weights, order, scaling)
    else:
        if remat:
            P = jax.checkpoint(
                lambda m, w: step_propagators(m, w, order, scaling)
            )(mats, weights)
        else:
            P = step_propagators(mats, weights, order, scaling)

    if not use_inter_vecs:
        if engine == "scan":
            final_U = chain_scan_novecs(P, U0)
        else:
            final_U = _bmm(chain_product_tree(P), U0)
        return final_U, None

    if engine == "associative":
        return chain_associative(P, U0, psi0)
    return chain_scan(P, U0, psi0)


def pick_engine(dim_real: int, steps: int) -> str:
    """Heuristic: parallel-in-time wins while T copies of [M,M] fit easily.

    The associative scan stores O(T) MxM cumulative products; cap the
    working set around 1 GiB of float32 before falling back to the serial
    (flops-optimal) scan.
    """
    bytes_needed = 4 * steps * dim_real * dim_real * 3  # P, cum, vjp slack
    return "associative" if bytes_needed < (1 << 30) else "scan"
