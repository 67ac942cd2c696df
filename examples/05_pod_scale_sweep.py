"""Multi-device seed x Hamiltonian sweep (BASELINE config 5).

Thousands of parallel GRAPE optimizations — random pulse seeds crossed
with a Hamiltonian-parameter grid — batched through the parallel layer
and sharded over a 1-D jax.sharding.Mesh on the seed axis.  Over several
hosts, initialize with ``qoc_tpu.parallel.mesh.init_distributed()``
first; the seed axis then shards across all of their devices.

Two programs:

  * default: a quick demonstration sweep (512 seeds, 2x2 pi pulse,
    detuning grid through the column-batched xla-cols backend);
  * ``--full``: BASELINE config 5 AT SPEC — **4096 seeds x a 64-point
    cavity-detuning grid on the dim-200 multimode cavity** (qubit x
    100-level cavity), optimized through the column-batched xla-cols
    backend (parallel/xla_batch.py) with per-seed convergence freezing.
    Writes CONFIG5_RESULTS.json: solves/s, best-seed fidelity, converged
    count.

Run:  python examples/05_pod_scale_sweep.py [--full] [--seeds N] [--iters N]
"""

import argparse
import json
import time

import numpy as np
import jax
import jax.numpy as jnp

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import qoc_tpu as q
from qoc_tpu.models.system import ControlProblem
from qoc_tpu.ops.isomorphism import c_to_r_mat
from qoc_tpu.parallel.batch import batched_grape_adam, init_seeds
from qoc_tpu.parallel.mesh import make_mesh


def build_dim200():
    """Qubit x 100-level cavity (Hilbert dim 200), qubit rotating frame."""
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
    n_op = np.asarray(a.conj().T @ a)
    return problem, n_op


def run_full(n_seeds=4096, n_grid=64, max_iterations=1200,
             conv_target=1e-4, out_json="CONFIG5_RESULTS.json",
             chunk=2048, rate=0.06):
    """BASELINE config 5 at spec: n_seeds (random pulse inits) x n_grid
    (cavity detunings, repeated across the seed axis) on dim 200 through
    the column-batched backend.  The detuning rides as one constant-weight
    extra operator channel per seed (-1j*dt*delta*n_cavity).

    The seed axis is processed in per-launch chunks of ``chunk`` columns,
    which bounds the device memory of one launch; whether one GPU takes
    all 4096 columns in a single launch has not been measured.  Chunk c
    uses ``seed=c`` for its random inits; the detuning pattern
    ``grid[s % n_grid]`` is global across chunks, so every grid point
    still sees n_seeds/n_grid distinct random inits."""
    problem, n_op = build_dim200()
    extra = np.stack(
        [c_to_r_mat(-1j * problem.dt * n_op)]).astype(np.float32)
    # the grid repeats over the seed axis: seed s gets detuning
    # grid[s % n_grid] — every grid point sees n_seeds/n_grid random inits
    grid = np.linspace(-0.1, 0.1, n_grid).astype(np.float32)
    deltas = grid[np.arange(n_seeds) % n_grid][:, None]

    t0 = time.time()
    losses_all, conv_all = [], []
    iters_total = 0
    for c0 in range(0, n_seeds, chunk):
        c1 = min(c0 + chunk, n_seeds)

        def progress(it, losses, done, c0=c0, c1=c1):
            print(f"  seeds [{c0}:{c1}] iter {it}: best "
                  f"{np.min(losses):.2e} converged "
                  f"{int(np.sum(done))}/{c1 - c0}", flush=True)

        # rate 0.06 measured optimal for this problem class (512-seed LR
        # sweep, round 5): all seeds cross the 1e-4 gate in ~700-750
        # iterations vs ~1400 at the 0.02 default — 0.04 needs ~1000,
        # 0.08 overshoots (~970)
        out = batched_grape_adam(
            problem, n_seeds=c1 - c0,
            convergence={"rate": rate, "update_step": 50,
                         "max_iterations": max_iterations,
                         "conv_target": conv_target},
            seed=c0 // chunk, backend="xla-cols",
            extra_channels=(extra, deltas[c0:c1]),
            progress=progress,
        )
        losses_all.append(out["losses"])
        conv_all.append(out["converged"])
        iters_total += (c1 - c0) * out["iterations"]
    wall = time.time() - t0
    losses = np.concatenate(losses_all)
    converged = np.concatenate(conv_all)
    conv_count = int(np.sum(converged & (losses < conv_target)))
    solves = iters_total
    below_gate = int(np.sum(losses < conv_target))
    best_per_grid = {
        float(g): float(np.min(losses[np.arange(n_seeds) % n_grid == i]))
        for i, g in enumerate(grid[:8])
    }
    rep = {
        "config": "BASELINE config 5 (dim 200, 4096 seeds x detuning grid)",
        "n_seeds": n_seeds,
        "n_grid": n_grid,
        "dim": problem.state_num,
        "steps": problem.steps,
        "iterations": iters_total // n_seeds,
        "chunk_cols_per_launch": chunk,
        "wall_s": round(wall, 1),
        "seed_iters_per_sec": round(solves / wall, 1),
        "best_loss": float(np.min(losses)),
        "best_fidelity": 1.0 - float(np.min(losses)),
        "converged_count": conv_count,
        "converged_frac": round(conv_count / n_seeds, 4),
        "seeds_below_gate": below_gate,
        # the BASELINE pod metric: completed optimizations (loss < gate)
        # per second of wall clock, the conv_target-loop semantics of
        # run_session.py:56-58 at pod scale
        "solves_per_sec": round(conv_count / wall, 3),
        "median_loss": float(np.median(losses)),
        "best_loss_first_8_grid_points": best_per_grid,
    }
    print(json.dumps(rep, indent=1))
    with open(out_json, "w") as f:
        json.dump(rep, f, indent=1)
    print(f"wrote {out_json}")
    return rep


def run_quick():
    n_seeds = 512
    problem = ControlProblem.build(
        np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y], ["x", "y"],
        [np.array([0, 1], dtype=complex)], 10.0, 1000,
        [np.array([1, 0], dtype=complex)],
        state_transfer=True, maxA=[0.7, 0.7], seed=0,
    )

    # --- seeds-only batch, sharded over all local devices ----------------
    mesh = make_mesh()
    out = batched_grape_adam(
        problem, n_seeds=n_seeds,
        convergence={"rate": 0.01, "update_step": 100,
                     "max_iterations": 2000, "conv_target": 1e-6},
        seed=0, mesh=mesh,
    )
    print(f"{n_seeds} seeds: best loss {out['best_loss']:.2e}, "
          f"{int(np.sum(out['converged']))} converged")

    # --- detuning sweep OPTIMIZED through the column-batched backend:
    # the detuning rides as a constant-weight extra operator channel ------
    from qoc_tpu.optim.convergence import ConvergenceSettings
    from qoc_tpu.parallel.batch import make_batched_runner
    from qoc_tpu.parallel.mesh import batch_sharding

    NUM = np.diag([0.0, 1.0]).astype(complex)
    extra = np.stack(
        [c_to_r_mat(-1j * problem.dt * NUM)]).astype(np.float32)
    conv = ConvergenceSettings.from_dict(
        {"rate": 0.01, "update_step": 100, "max_iterations": 2000,
         "conv_target": 1e-6})
    deltas = np.linspace(0.0, 0.2, n_seeds)[:, None].astype(np.float32)
    shard = batch_sharding(mesh)
    u = jax.device_put(init_seeds(problem, n_seeds, jax.random.PRNGKey(1)),
                       shard)
    init_state, run_segment = make_batched_runner(
        problem, conv, backend="xla-cols", extra_channel_mats=extra)
    state = run_segment(init_state(u), jnp.asarray(500, dtype=jnp.int32),
                        jax.device_put(jnp.asarray(deltas), shard))
    losses = np.asarray(state.loss)
    print(f"sweep after 500 iters: best {losses.min():.2e} "
          f"worst {losses.max():.2e} (detuning 0..0.2)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="run BASELINE config 5 at spec (4096 seeds, dim 200)")
    ap.add_argument("--seeds", type=int, default=4096)
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--iters", type=int, default=1200)
    ap.add_argument("--rate", type=float, default=0.06)
    args = ap.parse_args()
    if args.full:
        run_full(n_seeds=args.seeds, n_grid=args.grid,
                 max_iterations=args.iters, rate=args.rate)
    else:
        run_quick()


if __name__ == "__main__":
    main()
