"""The forward model: pulse weights -> propagation -> loss + metrics.

Pure-functional replacement for the reference's graph assembly
(tensorflow_state.py:323-340 `init_training_loss` + the propagation wiring
in `build_graph`, :366-394).  ``make_forward`` closes over a
``ControlProblem`` and returns pure functions suitable for jit / grad /
vmap / shard_map.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops.expm import HIGHEST
from ..ops.inner_products import inner_product_2d
from ..ops.propagation import evolve_unitary, state_transfer_chain
from .costs import CostContext, total_reg_cost
from .system import ControlProblem


class ForwardOutput(NamedTuple):
    loss: jnp.ndarray          # fidelity loss 1 - F
    reg_loss: jnp.ndarray      # loss + penalties (the optimization target)
    unitary_scale: jnp.ndarray # unitarity diagnostic (tensorflow_state.py:225,:335)
    final_state: jnp.ndarray   # [2N, 2N] final unitary, or [2N, V] final vecs
    inter_vecs: Optional[jnp.ndarray]  # [T+1, 2N, V] or None
    ops_weight: jnp.ndarray    # [K, T] normalized weights sin(base)


INTER_VEC_COSTS = ("forbidden_coeff_list", "forbidden", "speed_up")


def make_forward(
    problem: ControlProblem,
    reg_coeffs: Optional[dict] = None,
    gradient_mode: str = "exact",
    engine: str = "auto",
    remat: bool = False,
    lean: bool = False,
    representation: str = "auto",
):
    """Build the pure forward function ``u_base [K,T] -> ForwardOutput``.

    ``lean=True`` builds the *optimization* forward: intermediate states are
    only materialized (and differentiated through) when a selected cost
    actually reads them — otherwise the chain reduces straight to the final
    state via the product tree.  The default (lean=False) is the *analysis*
    forward and always emits inter_vecs when use_inter_vecs (the
    reference's plotting/h5 contract, tensorflow_state.py:381-384).

    ``representation``: 'iso' propagates the real 2Nx2N isomorphism (the
    reference's choice, SURVEY sec 2.1); 'complex' propagates native
    complex64 NxN with half the matmul flops, but XLA splits every
    non-matmul complex op into real/imag pairs; 'auto' resolves to 'iso'
    until the two are measured against each other on the GPU.  'complex'
    remains a tested, numerically-identical alternative.  Outputs
    (final_state, inter_vecs) are always in iso layout.
    """
    from ..routing import check_engine, resolve_single_engine

    check_engine(engine)
    p = problem
    if representation == "auto":
        representation = "iso"
    if representation == "complex":
        if gradient_mode != "exact":
            raise ValueError(
                "representation='complex' supports only exact gradients; "
                "the reference-parity custom VJPs are iso-layout"
            )
        return _make_forward_complex(p, reg_coeffs, engine, remat, lean)
    mats = jnp.asarray(p.mats)
    U0 = jnp.asarray(p.U0_iso)
    psi0 = jnp.asarray(p.initial_vectors)
    target_vecs = jnp.asarray(p.target_vectors)
    max_amp = jnp.asarray(p.ops_max_amp)
    one_minus_gauss = jnp.asarray(p.one_minus_gauss)
    v_sorted_iso = (
        jnp.asarray(p.v_sorted_iso) if p.v_sorted_iso is not None else None
    )
    # does any selected cost need the intermediate states?
    if lean:
        needs_inter = p.use_inter_vecs and any(
            k in (reg_coeffs or {}) for k in INTER_VEC_COSTS
        )
    else:
        needs_inter = p.use_inter_vecs
    N = p.state_num

    # resolve the concrete engine at build time (single source of truth:
    # the ladders in ops/propagation.py) — consumed by the chain below
    # and exposed as ``.resolved_engine`` for routing announcements
    resolved_engine = resolve_single_engine(p, gradient_mode, engine)

    def forward(u_base: jnp.ndarray, mats_in: jnp.ndarray | None = None) -> ForwardOutput:
        """mats_in overrides the closed-over generators — the hook the
        Hamiltonian-sweep layer (parallel/batch.py) vmaps over."""
        mats_ = mats if mats_in is None else mats_in
        ops_weight = jnp.sin(u_base)  # hard |u| <= maxA bound (tensorflow_state.py:176)
        amps = max_amp[:, None] * ops_weight
        ones = jnp.ones((1, p.steps), dtype=amps.dtype)
        weights = jnp.concatenate([ones, amps], axis=0)  # [K+1, T], row 0 = drift

        if p.state_transfer:
            inter_vecs = state_transfer_chain(
                mats_, weights, psi0, p.taylor_terms,
                gradient_mode=gradient_mode, remat=remat,
                engine=resolved_engine, final_only=not needs_inter,
            )
            final_vecs = inter_vecs[-1]
            loss = 1.0 - inner_product_2d(final_vecs, target_vecs, N)
            unitary_scale = inner_product_2d(final_vecs, final_vecs, N)
            final_state = final_vecs
            if not needs_inter:
                inter_vecs = None
        else:
            from ..ops.propagation import (
                chain_product_tree,
                evolve_unitary_pscan,
                step_propagators,
            )

            if resolved_engine == "pscan" and gradient_mode == "exact":
                # rank-V adjoint chain: the loss reads the unitary only
                # through final_vecs, so the full product is needed just
                # as an OUTPUT — computed forward-only (stop_gradient)
                # and dead-code-eliminated inside optimization loops
                # that never read final_state
                final_vecs, unitary_scale, inter_vecs = evolve_unitary_pscan(
                    mats_, weights, U0, psi0, p.taylor_terms,
                    p.taylor_scaling, use_inter_vecs=needs_inter,
                )
                final_U = jax.lax.stop_gradient(jnp.matmul(
                    chain_product_tree(step_propagators(
                        mats_, weights, p.taylor_terms, p.taylor_scaling)),
                    U0, precision=HIGHEST))
            else:
                final_U, inter_vecs = evolve_unitary(
                    mats_, weights, U0, psi0, p.taylor_terms, p.taylor_scaling,
                    gradient_mode=gradient_mode, engine=resolved_engine,
                    use_inter_vecs=needs_inter, remat=remat,
                )
                final_vecs = jnp.matmul(final_U, psi0, precision=HIGHEST)
                unitary_scale = (0.5 / N) * jnp.sum(
                    jnp.matmul(final_U.T, final_U, precision=HIGHEST)
                )
            loss = 1.0 - inner_product_2d(final_vecs, target_vecs, N)
            final_state = final_U

        ctx = CostContext(
            ops_weight=ops_weight,
            inter_vecs=inter_vecs,
            target_vecs=target_vecs,
            state_num=N,
            steps=p.steps,
            dt=p.dt,
            total_time=p.total_time,
            one_minus_gauss=one_minus_gauss,
            v_sorted_iso=v_sorted_iso,
        )
        reg_loss = loss + total_reg_cost(ctx, reg_coeffs)
        return ForwardOutput(loss, reg_loss, unitary_scale, final_state,
                             inter_vecs, ops_weight)

    def loss_fn(u_base: jnp.ndarray, mats_in: jnp.ndarray | None = None):
        out = forward(u_base, mats_in)
        return out.reg_loss, out

    forward.resolved_engine = resolved_engine
    loss_fn.resolved_engine = resolved_engine
    return forward, loss_fn


def _make_forward_complex(p, reg_coeffs, engine, remat, lean):
    """Native-complex64 forward: same math, half the matmul flops.

    Propagation runs on [N, N] complex64 (XLA lowers complex matmuls to
    real matmuls on the half-size operands); the loss, penalties, and
    all outputs are converted to the iso layout at the boundary so every
    downstream consumer (costs, analysis, persistence) is unchanged.
    """
    from ..ops.expm import taylor_expm, weighted_hamiltonians, _bmm
    from ..ops.propagation import chain_product_tree

    mats_c = jnp.asarray(p.mats_c, dtype=jnp.complex64)
    U0_c = jnp.asarray(p.U0_c, dtype=jnp.complex64)
    psi0_arr = p.initial_vectors_c.T
    psi0_c = jnp.asarray(psi0_arr, dtype=jnp.complex64)
    N = p.state_num
    V = psi0_arr.shape[1]
    tv_iso = jnp.asarray(p.target_vectors)
    max_amp = jnp.asarray(p.ops_max_amp)
    one_minus_gauss = jnp.asarray(p.one_minus_gauss)
    v_sorted_iso = (
        jnp.asarray(p.v_sorted_iso) if p.v_sorted_iso is not None else None
    )

    if lean:
        needs_inter = p.use_inter_vecs and any(
            k in (reg_coeffs or {}) for k in INTER_VEC_COSTS
        )
    else:
        needs_inter = p.use_inter_vecs

    def vecs_to_iso(vc):
        # [..., N, V] complex -> [..., 2N, V] iso
        return jnp.concatenate([jnp.real(vc), jnp.imag(vc)], axis=-2)

    def mat_to_iso(Mc):
        re, im = jnp.real(Mc), jnp.imag(Mc)
        return jnp.concatenate(
            [jnp.concatenate([re, -im], axis=-1),
             jnp.concatenate([im, re], axis=-1)], axis=-2
        )

    def forward(u_base, mats_in=None):
        target_c = tv_iso[:N, :] + 1j * tv_iso[N:, :]

        def fidelity_loss(final_c):
            # 1 - |sum_v <t_v|psi_v>|^2 / V^2 (coherent, = inner_product_2D)
            ov = jnp.sum(jnp.conj(target_c) * final_c)
            return 1.0 - (jnp.real(ov) ** 2 + jnp.imag(ov) ** 2) / (V * V)

        mats_ = mats_c if mats_in is None else mats_in
        ops_weight = jnp.sin(u_base)
        amps = max_amp[:, None] * ops_weight
        ones = jnp.ones((1, p.steps), dtype=amps.dtype)
        weights = jnp.concatenate([ones, amps], axis=0)
        A = weighted_hamiltonians(mats_, weights.astype(jnp.complex64))

        if p.state_transfer:
            order, scaling = p.taylor_terms - 1, 0
        else:
            order, scaling = p.taylor_terms, p.taylor_scaling
        P = taylor_expm(A, order, scaling)                 # [T, N, N]

        if needs_inter:
            from jax import lax

            cum = lax.associative_scan(lambda a, b: _bmm(b, a), P)
            cumU = _bmm(cum, U0_c)
            final_U = cumU[-1]
            vecs_c = _bmm(cumU, psi0_c)
            inter_c = jnp.concatenate(
                [(_bmm(U0_c, psi0_c))[None], vecs_c], axis=0)
            inter_vecs = vecs_to_iso(inter_c)
        else:
            final_U = _bmm(chain_product_tree(P), U0_c)
            inter_vecs = None

        final_c = _bmm(final_U, psi0_c)
        loss = fidelity_loss(final_c)

        if p.state_transfer:
            final_state = vecs_to_iso(final_c)
            # ip2d(final, final) (tensorflow_state.py:335)
            ov = jnp.sum(jnp.conj(final_c) * final_c)
            unitary_scale = (jnp.real(ov) ** 2 + jnp.imag(ov) ** 2) / (V * V)
        else:
            F = mat_to_iso(final_U)
            final_state = F
            unitary_scale = (0.5 / N) * jnp.sum(
                jnp.matmul(F.T, F, precision=HIGHEST))

        ctx = CostContext(
            ops_weight=ops_weight,
            inter_vecs=inter_vecs,
            target_vecs=tv_iso,
            state_num=N,
            steps=p.steps,
            dt=p.dt,
            total_time=p.total_time,
            one_minus_gauss=one_minus_gauss,
            v_sorted_iso=v_sorted_iso,
        )
        reg_loss = loss + total_reg_cost(ctx, reg_coeffs)
        return ForwardOutput(loss, reg_loss, unitary_scale, final_state,
                             inter_vecs, ops_weight)

    def loss_fn(u_base, mats_in=None):
        out = forward(u_base, mats_in)
        return out.reg_loss, out

    forward.resolved_engine = "complex"
    loss_fn.resolved_engine = "complex"
    return forward, loss_fn
