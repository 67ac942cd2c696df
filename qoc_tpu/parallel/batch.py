"""Batched GRAPE: many seeds / Hamiltonian sweeps per step.

A single 2Nx2N matrix exponential leaves most of an accelerator idle, so
whole optimizations are batched over a seed axis (and optionally a
Hamiltonian-parameter axis) and that axis is sharded over a device mesh.
Each seed keeps its own Adam state and its own convergence flag (per-seed
early-stop masks — converged seeds freeze while the batch keeps
stepping); aggregate metrics are jnp reductions that XLA lowers to
all-reduces across the mesh when sharded.

There is no reference analog (SURVEY.md section 2.7): this layer is the
new capability the BASELINE.json multi-seed config targets.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp
import optax

from ..models.forward import make_forward
from ..models.system import ControlProblem
from ..optim.adam import make_adam_optimizer
from ..optim.convergence import ConvergenceSettings
from .mesh import batch_sharding


class BatchState(NamedTuple):
    u_base: jnp.ndarray        # [S, K, T]
    opt_state: optax.OptState  # vmapped over S
    iteration: jnp.ndarray     # [] global iteration counter
    loss: jnp.ndarray          # [S]
    reg_loss: jnp.ndarray      # [S]
    grad_squared: jnp.ndarray  # [S]
    done: jnp.ndarray          # [S] bool


def init_seeds(
    problem: ControlProblem, n_seeds: int, key: jax.Array
) -> jnp.ndarray:
    """Per-seed random initial pulses, stddev 1/sqrt(steps)
    (system_parameters.py:278-282), with explicit jax.random keys."""
    return (
        jax.random.normal(
            key, (n_seeds, problem.ops_len, problem.steps), dtype=jnp.float32
        )
        / np.sqrt(problem.steps)
    )


def resolve_backend(problem: ControlProblem, reg_coeffs: Optional[dict],
                    gradient_mode: str, sweep_mats: bool,
                    on_gpu: bool) -> str:
    """The 'auto' batch backend: the column-batched xla-cols chain on a GPU
    when the problem supports it (shared generators, exact gradients),
    else the vmapped generic xla backend."""
    from .xla_batch import xla_cols_supported

    if (on_gpu and gradient_mode == "exact" and not sweep_mats
            and xla_cols_supported(problem, reg_coeffs)):
        return "xla-cols"
    return "xla"


def make_batched_runner(
    problem: ControlProblem,
    conv: ConvergenceSettings,
    reg_coeffs: Optional[dict] = None,
    gradient_mode: str = "exact",
    engine: str = "auto",
    remat: bool = False,
    sweep_mats: bool = False,
    backend: str = "auto",
    extra_channel_mats=None,
):
    """Build (init_state, run_segment) for S-way batched Adam.

    If ``sweep_mats``, the runner's state carries per-seed generator stacks
    ``mats [S, K+1, M, M]`` (a Hamiltonian parameter sweep); otherwise all
    seeds share the problem's generators.

    ``backend``:
      * 'xla-cols' — column-batched XLA chain (any V, all 7 costs incl.
        in-carry forbidden + speed_up, constant extra channels;
        parallel/xla_batch.py).
      * 'xla'    — vmapped generic forward (always available; the only
        backend for per-seed mats sweeps).
      * 'auto'   — xla-cols on a GPU when the problem supports it, else
        xla.

    ``extra_channel_mats`` ([E, 2N, 2N] real iso, xla-cols backend):
    fixed operator channels whose constant per-seed weights ride the
    runner's ``mats_b`` operand as ``extra_weights [S, E]`` — the
    linear Hamiltonian-sweep mechanism.
    """
    from ..routing import announce, check_backend, on_gpu
    from .xla_batch import make_xla_batched_loss

    check_backend(backend)
    optimizer = make_adam_optimizer(conv)

    _DESCR = {
        "xla-cols": "xla-cols (column-batched XLA chain)",
        "xla": "xla (vmapped generic forward)",
    }
    if backend == "auto":
        backend = resolve_backend(problem, reg_coeffs, gradient_mode,
                                  sweep_mats, on_gpu())
        announce("batch backend", _DESCR[backend])
    else:
        announce("batch backend", _DESCR[backend] + " (forced)")

    if backend == "xla-cols":
        batched_loss = make_xla_batched_loss(
            problem, reg_coeffs, extra_channel_mats=extra_channel_mats
        )

        def _total(u_bases, extra_w):
            reg_losses, fid_losses = batched_loss(u_bases, extra_w)
            return jnp.sum(reg_losses), (reg_losses, fid_losses)

        def batch_metrics(u_bases, mats_b):
            (_, (reg_losses, fid_losses)), grads = jax.value_and_grad(
                _total, has_aux=True
            )(u_bases, mats_b)
            g2 = 0.5 * jnp.sum(jnp.square(grads), axis=(1, 2))
            return fid_losses, reg_losses, g2, grads

    else:
        # Under vmap the serial scan is the right per-seed engine — batched
        # matvecs, minimal memory traffic.
        xla_engine = "scan" if engine == "auto" else engine
        _, loss_fn = make_forward(
            problem, reg_coeffs=reg_coeffs, gradient_mode=gradient_mode,
            engine=xla_engine, remat=remat, lean=True,
        )

        def seed_metrics(u_base, mats_in):
            (reg_loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                u_base, mats_in
            )
            g2 = 0.5 * jnp.sum(jnp.square(grads))
            return out.loss, reg_loss, g2, grads

        batch_metrics = jax.vmap(
            seed_metrics, in_axes=(0, 0 if sweep_mats else None)
        )

    def seed_update(u_base, opt_state, grads, done):
        # ``done`` is a per-seed scalar bool (vmapped), so jnp.where
        # broadcasts against leaves of any rank without reshaping them.
        updates, new_opt = optimizer.update(grads, opt_state, u_base)
        new_u = optax.apply_updates(u_base, updates)
        u = jnp.where(done, u_base, new_u)
        opt = jax.tree_util.tree_map(
            lambda new, old: jnp.where(done, old, new), new_opt, opt_state
        )
        return u, opt

    v_update = jax.vmap(seed_update, in_axes=(0, 0, 0, 0))

    def init_state(u_bases: jnp.ndarray) -> BatchState:
        S = u_bases.shape[0]
        opt_state = jax.vmap(optimizer.init)(u_bases)
        inf = jnp.full((S,), jnp.inf, dtype=jnp.float32)
        return BatchState(
            u_base=jnp.asarray(u_bases),
            opt_state=opt_state,
            iteration=jnp.asarray(0, dtype=jnp.int32),
            loss=inf, reg_loss=inf, grad_squared=inf,
            done=jnp.zeros((S,), dtype=bool),
        )

    def cond(carry):
        s, stop_at, _ = carry
        return jnp.logical_and(jnp.any(~s.done), s.iteration < stop_at)

    def body(carry):
        s, stop_at, mats_b = carry
        loss, reg_loss, g2, grads = batch_metrics(s.u_base, mats_b)
        converged = (
            (loss < conv.conv_target)
            | (g2 < conv.min_grad)
            | (s.iteration >= conv.max_iterations)
            | s.done
        )
        u, opt = v_update(s.u_base, s.opt_state, grads, converged)
        return (
            BatchState(u, opt, s.iteration + 1, loss, reg_loss, g2, converged),
            stop_at,
            mats_b,
        )

    def _run(state: BatchState, stop_at, mats_b):
        out, _, _ = jax.lax.while_loop(cond, body, (state, stop_at, mats_b))
        return out

    # Sharding is carried by the operands (device_put on the seed axis in
    # batched_grape_adam); jit propagates it through the while_loop, and XLA
    # inserts the collectives for the any()/all() reductions.
    run_segment = jax.jit(_run)

    return init_state, run_segment


def batched_grape_adam(
    problem: ControlProblem,
    n_seeds: int,
    convergence: Optional[dict] = None,
    reg_coeffs: Optional[dict] = None,
    seed: int = 0,
    mesh=None,
    mats_batch: Optional[np.ndarray] = None,
    gradient_mode: str = "exact",
    engine: str = "auto",
    backend: str = "auto",
    extra_channels=None,
    progress: Optional[Callable] = None,
):
    """Optimize ``n_seeds`` independent pulse initializations in parallel.

    Returns a dict with per-seed losses, pulses, iteration counts, and the
    best seed's physical pulse amplitudes.  With ``mesh`` given, the seed
    axis is sharded over the mesh devices (data-parallel).

    Hamiltonian sweeps, two mechanisms:
      * ``mats_batch`` ([S, K+1, 2N, 2N]): fully general per-seed
        generators, XLA backend;
      * ``extra_channels=(extra_mats [E, 2N, 2N], extra_weights [S, E])``:
        swept terms expressed as fixed operator channels with constant
        per-seed weights — rides the column-batched xla-cols backend.
    """
    from ..models.costs import validate_reg_coeffs

    validate_reg_coeffs(reg_coeffs, state_num=problem.state_num)
    conv = ConvergenceSettings.from_dict(convergence)
    sweep = mats_batch is not None
    if sweep and extra_channels is not None:
        raise ValueError("pass either mats_batch or extra_channels, not both")
    extra_mats = extra_w = None
    if extra_channels is not None:
        # extra channels ride only the column-batched XLA path (the
        # generic vmapped backend has no constant-channel operand)
        from ..routing import check_backend
        from .xla_batch import xla_cols_supported

        extra_mats, extra_w = extra_channels
        if check_backend(backend) == "auto":
            if not xla_cols_supported(problem, reg_coeffs):
                raise ValueError(
                    "extra_channels need the column-batched xla-cols "
                    "backend; this problem/cost combination does not "
                    "support it")
            backend = "xla-cols"
    init_state, run_segment = make_batched_runner(
        problem, conv, reg_coeffs=reg_coeffs, gradient_mode=gradient_mode,
        engine=engine, sweep_mats=sweep, backend=backend,
        extra_channel_mats=extra_mats,
    )
    key = jax.random.PRNGKey(seed)
    u_bases = init_seeds(problem, n_seeds, key)
    if sweep:
        mats_b = jnp.asarray(mats_batch)
    elif extra_w is not None:
        mats_b = jnp.asarray(extra_w, dtype=jnp.float32)
    else:
        mats_b = None

    if mesh is not None:
        shard = batch_sharding(mesh)
        u_bases = jax.device_put(u_bases, shard)
        if mats_b is not None:
            mats_b = jax.device_put(mats_b, shard)

    state = init_state(u_bases)
    while True:
        stop_at = jnp.asarray(
            min(int(state.iteration) + conv.update_step,
                conv.max_iterations + 1),
            dtype=jnp.int32,
        )
        state = run_segment(state, stop_at, mats_b)
        if progress is not None:
            progress(int(state.iteration), np.asarray(state.loss),
                     np.asarray(state.done))
        if bool(jnp.all(state.done)) or int(state.iteration) > conv.max_iterations:
            break

    losses = np.asarray(state.loss)
    best = int(np.argmin(losses))
    max_amp = np.asarray(problem.ops_max_amp)[None, :, None]
    uks_all = max_amp * np.sin(np.asarray(state.u_base))
    return {
        "losses": losses,
        "reg_losses": np.asarray(state.reg_loss),
        "iterations": int(state.iteration),
        "u_base": np.asarray(state.u_base),
        "uks": uks_all,
        "best_seed": best,
        "best_uks": uks_all[best],
        "best_loss": float(losses[best]),
        "converged": np.asarray(state.done),
    }
