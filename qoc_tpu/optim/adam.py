"""On-device Adam driver.

The reference's Adam loop (run_session.py:47-69) crosses the host<->device
boundary twice per iteration and runs the graph twice (metrics run + update
run) — a documented inefficiency (SURVEY.md section 2.6).  Here the whole
loop runs on device: one fused value-and-grad + Adam update per iteration,
with the convergence test (loss < conv_target, |grad|^2 < min_grad,
iter >= max_iterations; run_session.py:56-58) evaluated *inside* a
``lax.while_loop``.  The host only syncs once per ``update_step`` segment to
record history / persist checkpoints, so steady-state throughput is pure
device time.

Semantics parity: metrics are evaluated at the *current* iterate before the
update is applied, and on convergence the final update is skipped — exactly
the reference's "run metrics, test, then optimize" ordering.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax

from .convergence import ConvergenceSettings


class AdamState(NamedTuple):
    u_base: jnp.ndarray
    opt_state: optax.OptState
    iteration: jnp.ndarray     # int32
    loss: jnp.ndarray
    reg_loss: jnp.ndarray
    grad_squared: jnp.ndarray
    unitary_scale: jnp.ndarray
    done: jnp.ndarray          # bool


def _scale_by_exp_decay_lr(rate: float, decay: float):
    """lr_i = rate * exp(-i/decay) (run_session.py:66), tracked as carried
    state multiplied by the constant factor exp(-1/decay) each step.

    Equivalent to ``optax.scale_by_schedule`` with the exponential schedule,
    but avoids evaluating exp(-count/decay) on a traced counter inside the
    optimization loop: one multiply per step instead of an exp."""
    import numpy as np

    factor = float(np.exp(-1.0 / float(decay)))

    def init(params):
        del params
        return {"lr": jnp.asarray(rate, dtype=jnp.float32)}

    def update(updates, state, params=None):
        del params
        lr = state["lr"]
        scaled = jax.tree_util.tree_map(lambda g: lr * g, updates)
        return scaled, {"lr": lr * factor}

    return optax.GradientTransformation(init, update)


def make_adam_optimizer(conv: ConvergenceSettings) -> optax.GradientTransformation:
    """Adam with the reference's exponential LR schedule
    rate * exp(-iter/decay) (run_session.py:66), TF1 Adam hyperparameters
    (beta1=0.9, beta2=0.999, eps=1e-8)."""
    return optax.chain(
        optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8),
        _scale_by_exp_decay_lr(conv.rate, conv.learning_rate_decay),
        optax.scale(-1.0),
    )


def make_segment_runner(
    loss_fn: Callable,
    conv: ConvergenceSettings,
    optimizer: optax.GradientTransformation,
):
    """Jitted runner advancing up to ``n`` iterations with in-loop early exit.

    ``loss_fn(u_base) -> (reg_loss, ForwardOutput)``.
    """

    vg = jax.value_and_grad(loss_fn, has_aux=True)

    def metrics_of(u_base):
        (reg_loss, out), grads = vg(u_base)
        g2 = 0.5 * jnp.sum(jnp.square(grads))  # tf.nn.l2_loss convention
        return out.loss, reg_loss, g2, out.unitary_scale, grads

    def cond(state_and_stop):
        s, stop_at = state_and_stop
        return jnp.logical_and(~s.done, s.iteration < stop_at)

    def body(state_and_stop):
        s, stop_at = state_and_stop
        loss, reg_loss, g2, uscale, grads = metrics_of(s.u_base)
        converged = jnp.logical_or(
            loss < conv.conv_target,
            jnp.logical_or(g2 < conv.min_grad,
                           s.iteration >= conv.max_iterations),
        )
        updates, new_opt_state = optimizer.update(grads, s.opt_state, s.u_base)
        new_u = optax.apply_updates(s.u_base, updates)
        # on convergence: keep the current iterate, don't step past it
        u_base = jnp.where(converged, s.u_base, new_u)
        opt_state = jax.tree_util.tree_map(
            lambda new, old: jnp.where(converged, old, new),
            new_opt_state, s.opt_state,
        )
        iteration = jnp.where(converged, s.iteration, s.iteration + 1)
        return (
            AdamState(u_base, opt_state, iteration, loss, reg_loss, g2,
                      uscale, converged),
            stop_at,
        )

    @jax.jit
    def run_segment(state: AdamState, stop_at: jnp.ndarray) -> AdamState:
        out, _ = jax.lax.while_loop(cond, body, (state, stop_at))
        return out

    @jax.jit
    def eval_metrics(u_base):
        loss, reg_loss, g2, uscale, _ = metrics_of(u_base)
        return loss, reg_loss, g2, uscale

    return run_segment, eval_metrics


def init_adam_state(u_base, optimizer) -> AdamState:
    u_base = jnp.asarray(u_base)
    zero = jnp.asarray(0.0, dtype=jnp.float32)
    return AdamState(
        u_base=u_base,
        opt_state=optimizer.init(u_base),
        iteration=jnp.asarray(0, dtype=jnp.int32),
        loss=zero + jnp.inf,
        reg_loss=zero + jnp.inf,
        grad_squared=zero + jnp.inf,
        unitary_scale=zero,
        done=jnp.asarray(False),
    )


def make_throughput_runner(
    loss_fn: Callable,
    conv: ConvergenceSettings,
    optimizer: optax.GradientTransformation,
):
    """Fixed-iteration-count runner for benchmarking: a ``fori_loop`` with NO
    convergence test, so the measured work is exactly ``n`` fused
    fwd+bwd+update iterations regardless of the loss trajectory."""
    vg = jax.value_and_grad(loss_fn, has_aux=True)

    @jax.jit
    def run_n(u_base, opt_state, n):
        def body(_, carry):
            u, os = carry
            (_, __), grads = vg(u)
            updates, os = optimizer.update(grads, os, u)
            return (optax.apply_updates(u, updates), os)

        return jax.lax.fori_loop(0, n, body, (u_base, opt_state))

    return run_n
