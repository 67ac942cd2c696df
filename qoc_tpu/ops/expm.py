"""Batched Taylor matrix exponentials — the hot kernels of the framework.

The reference (core/tensorflow_state.py:25-46, :77-97) computes one matrix
exponential per timestep, serially, as an unrolled TF1 graph.  Here the same
Taylor + scaling-and-squaring approximant is computed for *all* timesteps (and
optionally all batched problems) in a single batched primitive: every matmul
in the Taylor recurrence is a ``[T, M, M] x [T, M, M]`` batched matmul.
All matmuls run at float32 ``Precision.HIGHEST`` so unitarity stays inside
the reference's 1e-4 ``Unitary_error`` budget (SURVEY.md section 7, hard
part 4); on a GPU this also keeps XLA from choosing TF32.

Conventions (matching tensorflow_state.py):
  * ``matexp``  (unitary mode)     uses Taylor orders 0..order  and
    ``scaling`` squarings, with coefficients pre-divided by ``2**scaling``
    (tensorflow_state.py:31,37-44).
  * ``matvec``  (state transfer)   uses Taylor orders 0..order-1 and *no*
    scaling/squaring (tensorflow_state.py:85,92-97) — a deliberate quirk of
    the reference that we reproduce for parity.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

HIGHEST = lax.Precision.HIGHEST


def _bmm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched matmul at full float32 precision.

    HIGHEST is not configurable: reduced-precision passes (bf16 or TF32)
    move ``|unitary_scale - 1|`` far past the 1e-4 ``Unitary_error``
    budget at Hilbert dim 64.
    """
    return jnp.matmul(a, b, precision=HIGHEST)


def taylor_expm(A: jnp.ndarray, order: int, scaling: int) -> jnp.ndarray:
    """exp(A) for a batch of matrices via Taylor series + scaling/squaring.

    Args:
      A: ``[..., M, M]`` real (or complex) matrices.
      order: highest Taylor power kept (inclusive), i.e. sum_{n=0}^{order}.
      scaling: number of squarings; the series is evaluated on ``A / 2**s``.

    Matches the truncation of get_matexp (tensorflow_state.py:25-46): terms
    ``I + H + H^2/2! + ... + H^order/order!`` followed by ``scaling``
    squarings.
    """
    if scaling:
        A = A / (2.0 ** scaling)
    I = jnp.broadcast_to(jnp.eye(A.shape[-1], dtype=A.dtype), A.shape)
    # Direct accumulation, same association order as the reference
    # (tensorflow_state.py:37-41): E += A^n / n! with A^n built incrementally.
    E = I + A
    An = A
    factorial = 1.0
    for n in range(2, order + 1):
        factorial *= n
        An = _bmm(A, An)
        E = E + An / factorial
    for _ in range(scaling):
        E = _bmm(E, E)
    return E


def taylor_expm_matvec(A: jnp.ndarray, psi: jnp.ndarray, order: int) -> jnp.ndarray:
    """exp(A) @ psi via the Taylor mat-vec recurrence, *no* scaling/squaring.

    Args:
      A: ``[M, M]`` (or batched ``[..., M, M]``).
      psi: ``[M, V]`` stacked state vectors (or batched accordingly).
      order: the reference's ``taylor_terms``; the series keeps powers
        ``0..order-1`` (the off-by-one of tensorflow_state.py:92 is
        intentional parity).
    """
    out = psi
    pn = psi
    factorial = 1.0
    for n in range(1, order):
        factorial *= n
        pn = _bmm(A, pn)
        out = out + pn / factorial
    return out


def weighted_hamiltonians(mats: jnp.ndarray, weights: jnp.ndarray) -> jnp.ndarray:
    """Assemble per-timestep step generators A_t = sum_k w[k,t] * mats[k].

    Args:
      mats: ``[K, M, M]`` stacked constant generators ``-i*dt*H_k`` in real
        isomorphism form (system_parameters.py:194-251 analog, minus the
        trailing identity — the identity lives inside ``taylor_expm``).
      weights: ``[K, T]`` per-timestep coefficients (row 0 is the constant
        1.0 drift weight, tensorflow_state.py:172-181).

    Returns: ``[T, M, M]``.

    This one einsum replaces the reference's per-step ``tf.add_n`` chains —
    it is a single ``[T,K] x [K, M*M]`` matmul.
    """
    return jnp.einsum("kt,kij->tij", weights, mats, precision=HIGHEST)
