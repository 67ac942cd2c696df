"""Explicit SPMD batched optimization via jax.shard_map + psum collectives.

The jit+NamedSharding path (parallel/batch.py) lets XLA infer the
partitioning.  This module is the explicit counterpart: each device owns a
local shard of the seed axis, the per-seed Adam step runs on local data
only (zero cross-device traffic in the hot loop — seeds are independent),
and the *aggregate* convergence statistics (global best loss, number of
converged seeds) are computed with ``lax.psum``/``lax.pmin`` over the 1-D
seed mesh axis.  Over several hosts, initialize ``jax.distributed`` first
and build the mesh over all devices; the same code spans them.

This is the layer SURVEY.md section 2.7 calls for (collective reductions
of gradient/fidelity statistics) — there is no reference analog to cite.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.forward import make_forward
from ..models.system import ControlProblem
from ..optim.adam import make_adam_optimizer
from ..optim.convergence import ConvergenceSettings
from .mesh import BATCH_AXIS


class ShardedStats(NamedTuple):
    """Globally psum/pmin-reduced statistics (identical on every device)."""

    best_loss: jnp.ndarray     # global min fidelity loss
    mean_loss: jnp.ndarray     # global mean
    n_converged: jnp.ndarray   # global count of seeds below conv_target
    grad_norm: jnp.ndarray     # global l2 of all per-seed gradients


def make_shard_map_step(
    problem: ControlProblem,
    conv: ConvergenceSettings,
    mesh: Mesh,
    reg_coeffs: Optional[dict] = None,
    engine: str = "scan",
    steps_per_call: int = 1,
):
    """Build ``step(u_bases, opt_state) -> (u, opt_state, ShardedStats)``.

    ``u_bases [S, K, T]`` must be sharded over ``mesh`` on axis 0 (S a
    multiple of the mesh size).  The returned step advances
    ``steps_per_call`` Adam iterations inside ONE sharded program (a local
    fori_loop — seeds are independent, so no collectives fire until the
    final stats reduction); stats are psum/pmin-reduced across the mesh
    axis at the end of the call.
    """
    _, loss_fn = make_forward(
        problem, reg_coeffs=reg_coeffs, engine=engine, lean=True,
    )
    optimizer = make_adam_optimizer(conv)

    def seed_step(u, opt_st):
        (reg_loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(u)
        updates, opt_st = optimizer.update(grads, opt_st, u)
        return optax.apply_updates(u, updates), opt_st, out.loss, grads

    v_seed_step = jax.vmap(seed_step)

    def local_step(u_local, opt_local):
        def body(_, carry):
            u, opt_st, _, _ = carry
            return v_seed_step(u, opt_st)

        init = v_seed_step(u_local, opt_local)
        u, opt_st, losses, grads = jax.lax.fori_loop(
            1, steps_per_call, body, init
        )
        # --- explicit collectives over the mesh axis ---------------------
        best = jax.lax.pmin(jnp.min(losses), BATCH_AXIS)
        total = jax.lax.psum(jnp.sum(losses), BATCH_AXIS)
        count = jax.lax.psum(jnp.asarray(losses.shape[0], jnp.float32),
                             BATCH_AXIS)
        n_conv = jax.lax.psum(
            jnp.sum((losses < conv.conv_target).astype(jnp.float32)),
            BATCH_AXIS,
        )
        gsq = jax.lax.psum(jnp.sum(jnp.square(grads)), BATCH_AXIS)
        stats = ShardedStats(best, total / count, n_conv, jnp.sqrt(gsq))
        return u, opt_st, stats

    shard = P(BATCH_AXIS)
    rep = P()
    opt_spec = jax.tree_util.tree_map(lambda _: shard, optimizer.init(
        jnp.zeros((1, problem.ops_len, problem.steps), jnp.float32)))
    stats_spec = ShardedStats(rep, rep, rep, rep)

    step = jax.jit(
        jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(shard, opt_spec),
            out_specs=(shard, opt_spec, stats_spec),
            # closed-over problem constants (generators, targets) are
            # replicated, not device-varying; skip varying-axes checking
            check_vma=False,
        )
    )

    def init(u_bases):
        u_bases = jax.device_put(
            jnp.asarray(u_bases), NamedSharding(mesh, shard))
        opt_state = jax.jit(
            jax.vmap(optimizer.init),
            out_shardings=jax.tree_util.tree_map(
                lambda s: NamedSharding(mesh, s), opt_spec),
        )(u_bases)
        return u_bases, opt_state

    return init, step
