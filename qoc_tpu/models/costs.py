"""Composable cost/regularization registry — pure JAX functions.

The reference's regularization stack (core/regularization_functions.py:7-97)
is a monolithic graph-builder keyed by the ``reg_coeffs`` dict.  Here every
penalty is a pure function ``f(ctx, cfg) -> scalar`` registered by name; the
total regularized loss is the fidelity loss plus the sum of selected
penalties.  All functions are jit/vmap/grad-safe, so the same registry
drives single runs and multi-device batched sweeps.

Semantics notes (kept bit-faithful to the reference):
  * l2(x) = 0.5 * sum(x^2)  (tf.nn.l2_loss).
  * Penalties 'amplitude'/'envelope'/'dwdt'/'d2wdt2'/'bandpass' act on the
    *normalized* weights sin(base) in [-1, 1], NOT the physical amplitudes
    (regularization_functions.py:18,25,30,41,55).
  * 'forbidden_coeff_list' and 'speed_up' read intermediate states
    [T+1, 2N, V] and are unavailable when use_inter_vecs=False — we raise a
    loud error instead of the reference's silent invalidation (SURVEY.md
    section 7, quirk 8).
  * 'bandpass' uses an FFT over the time axis on every backend (the
    reference raised on CPU, regularization_functions.py:49-50 — no such
    restriction here).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import jax.numpy as jnp
from jax import lax

from ..ops.inner_products import inner_product_3d


def _l2(x: jnp.ndarray) -> jnp.ndarray:
    return 0.5 * jnp.sum(jnp.square(x))


class CostContext:
    """Bag of tensors the cost functions may read.

    Attributes:
      ops_weight:       [K, T] normalized weights sin(base).
      inter_vecs:       [T+1, 2N, V] intermediate states (or None).
      target_vecs:      [2N, V].
      state_num:        N (complex dimension).
      steps, dt, total_time: horizon parameters.
      one_minus_gauss:  [K, T] envelope mask (system_parameters.py:253-266).
      v_sorted_iso:     [2N, 2N] dressed rotation (real iso) or None.
    """

    def __init__(self, **kw):
        self.__dict__.update(kw)


CostFn = Callable[[CostContext, dict], jnp.ndarray]
REGISTRY: Dict[str, CostFn] = {}


def register(name: str):
    def deco(fn: CostFn) -> CostFn:
        REGISTRY[name] = fn
        return fn

    return deco


@register("amplitude")
def amplitude_cost(ctx, reg_coeffs):
    """coeff/steps * l2(ops_weight) (regularization_functions.py:15-18)."""
    alpha = reg_coeffs["amplitude"] / float(ctx.steps)
    return alpha * _l2(ctx.ops_weight)


@register("envelope")
def envelope_cost(ctx, reg_coeffs):
    """Penalize weight outside a Gaussian envelope
    (regularization_functions.py:21-25)."""
    alpha = reg_coeffs["envelope"] / float(ctx.steps)
    return alpha * _l2(ctx.one_minus_gauss * ctx.ops_weight)


def _padded_weights(ctx):
    """[zeros(2), w, zeros(2)] along time (regularization_functions.py:29-31)."""
    K = ctx.ops_weight.shape[0]
    z = jnp.zeros((K, 2), dtype=ctx.ops_weight.dtype)
    return jnp.concatenate([z, ctx.ops_weight, z], axis=1)


@register("dwdt")
def dwdt_cost(ctx, reg_coeffs):
    """First finite difference of the padded pulse
    (regularization_functions.py:28-35)."""
    alpha = reg_coeffs["dwdt"] / float(ctx.steps)
    w = _padded_weights(ctx)
    return alpha * _l2((w[:, 1:] - w[:, : ctx.steps + 3]) / ctx.dt)


@register("d2wdt2")
def d2wdt2_cost(ctx, reg_coeffs):
    """Second finite difference (regularization_functions.py:38-45)."""
    alpha = reg_coeffs["d2wdt2"] / float(ctx.steps)
    w = _padded_weights(ctx)
    d2 = (w[:, 2:] - 2 * w[:, 1 : ctx.steps + 3] + w[:, : ctx.steps + 2]) / (
        ctx.dt ** 2
    )
    return alpha * _l2(d2)


@register("bandpass")
def bandpass_cost(ctx, reg_coeffs):
    """Penalize spectral weight outside [band0, band1]
    (regularization_functions.py:47-67)."""
    alpha = reg_coeffs["bandpass"] / float(ctx.steps)
    fft_mag = jnp.abs(jnp.fft.fft(ctx.ops_weight.astype(jnp.complex64), axis=1))
    band = np.asarray(reg_coeffs["band"], dtype=float)
    band_id = (band * float(ctx.total_time)).astype(int)
    half_id = int(ctx.steps / 2)
    lo = jnp.sum(fft_mag[:, 0 : int(band_id[0])])
    hi = jnp.sum(fft_mag[:, int(band_id[1]) : half_id])
    return alpha * (lo + hi)


@register("forbidden_coeff_list")
def forbidden_cost(ctx, reg_coeffs):
    """Per-(coeff, level) forbidden-state occupation penalty
    (regularization_functions.py:71-85), with optional dressed-basis
    rotation when reg_coeffs['forbid_dressed'] and the system is dressed."""
    if ctx.inter_vecs is None:
        raise ValueError(
            "forbidden-state cost requires intermediate states; "
            "set use_inter_vecs=True"
        )
    vecs = ctx.inter_vecs  # [T+1, 2N, V]
    if ctx.v_sorted_iso is not None and reg_coeffs.get("forbid_dressed", False):
        vecs = jnp.einsum("ji,tjv->tiv", ctx.v_sorted_iso, vecs,
                          precision=lax.Precision.HIGHEST)
    total = jnp.asarray(0.0, dtype=vecs.dtype)
    n = ctx.state_num
    for coeff, state in zip(
        reg_coeffs["forbidden_coeff_list"], reg_coeffs["states_forbidden_list"]
    ):
        alpha = coeff / float(ctx.steps)
        pop = jnp.square(vecs[:, state, :]) + jnp.square(vecs[:, n + state, :])
        # reference loops per concerned vector with l2 over time
        # (sum over vectors == sum of per-vector l2 losses)
        total = total + alpha * _l2(pop)
    return total


@register("speed_up")
def speed_up_cost(ctx, reg_coeffs):
    """Reward target overlap at every intermediate time
    (regularization_functions.py:88-95)."""
    if ctx.inter_vecs is None:
        raise ValueError("speed_up cost requires intermediate states; "
                         "set use_inter_vecs=True")
    alpha = reg_coeffs["speed_up"] / float(ctx.steps)
    T1 = ctx.inter_vecs.shape[0]  # steps + 1
    target_tiled = jnp.broadcast_to(
        ctx.target_vecs[None, :, :], (T1,) + ctx.target_vecs.shape
    )
    ip3 = inner_product_3d(ctx.inter_vecs, target_tiled, ctx.state_num)
    return alpha * 0.5 * jnp.square(T1 - ip3)


# keys that are parameters of other costs, not costs themselves
_AUX_KEYS = {"band", "states_forbidden_list", "forbid_dressed"}


def validate_reg_coeffs(reg_coeffs: dict | None,
                        state_num: int | None = None) -> None:
    """Loud, early reg_coeffs validation with nearest-key suggestions.

    The reference silently ignores unknown keys and its README documents
    'forbidden' while the code reads 'forbidden_coeff_list'
    (README.md:27 vs regularization_functions.py:71 — the trap SURVEY
    sec 2.5 notes).  Here a typo'd key fails immediately with the closest
    known spelling, paired list lengths are checked, and (when state_num
    is given) forbidden level indices are range-checked.
    """
    if not reg_coeffs:
        return
    import difflib

    valid = set(REGISTRY) | _AUX_KEYS | {"forbidden"}
    for key in reg_coeffs:
        if key not in valid:
            close = difflib.get_close_matches(key, sorted(valid), n=1)
            hint = f"; did you mean {close[0]!r}?" if close else ""
            raise KeyError(
                f"unknown reg_coeffs key {key!r}{hint} "
                f"(known: {sorted(valid)})")
    forb = reg_coeffs.get("forbidden_coeff_list",
                          reg_coeffs.get("forbidden"))
    if forb is not None:
        states = reg_coeffs.get("states_forbidden_list")
        if states is None:
            raise ValueError(
                "'forbidden_coeff_list' requires a matching "
                "'states_forbidden_list' of level indices")
        if len(forb) != len(states):
            raise ValueError(
                f"forbidden_coeff_list has {len(forb)} coefficients for "
                f"{len(states)} states_forbidden_list entries")
        if state_num is not None:
            for i, s in enumerate(states):
                if not 0 <= int(s) < state_num:
                    raise ValueError(
                        f"states_forbidden_list[{i}]={s} is outside the "
                        f"{state_num}-dimensional Hilbert space")
    if "bandpass" in reg_coeffs and "band" not in reg_coeffs:
        raise ValueError(
            "'bandpass' requires 'band' = [f_lo, f_hi] "
            "(regularization_functions.py:47-67)")


def total_reg_cost(ctx: CostContext, reg_coeffs: dict | None) -> jnp.ndarray:
    """Sum all penalties selected by reg_coeffs (regularization_functions.py:7-97).

    Also accepts the README's documented 'forbidden' spelling as an alias for
    'forbidden_coeff_list' (SURVEY.md section 2.5 note) when given the list
    form.
    """
    if not reg_coeffs:
        return jnp.asarray(0.0, dtype=jnp.float32)
    total = jnp.asarray(0.0, dtype=jnp.float32)
    for key in reg_coeffs:
        if key in _AUX_KEYS:
            continue
        name = "forbidden_coeff_list" if key == "forbidden" else key
        if name not in REGISTRY:
            import difflib

            close = difflib.get_close_matches(
                key, sorted(set(REGISTRY) | {"forbidden"}), n=1)
            hint = f"; did you mean {close[0]!r}?" if close else ""
            raise KeyError(
                f"unknown reg_coeffs key {key!r}{hint} "
                f"(known: {sorted(REGISTRY)})"
            )
        cfg = dict(reg_coeffs)
        if key == "forbidden":
            cfg["forbidden_coeff_list"] = reg_coeffs["forbidden"]
        total = total + REGISTRY[name](ctx, cfg)
    return total
