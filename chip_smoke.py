"""Smoke test of GRAPE on an NVIDIA GPU: the quickest proof that the system
still starts on the card and gives right answers there.

Runs the main paths end to end through the entry points a user calls, at
the widths of the BASELINE configs, in ONE process (one process per card):

  (a) pi pulse through ``Grape(method="Adam")`` to loss < 1e-4;
  (b) BASELINE config 3, the 5-level transmon with forbidden-state costs;
  (c) BASELINE config 4 at spec (dim 60, T=1000, bandpass + speed_up +
      dwdt) loaded through the CLI's own ``load_config``;
  (d) the dim-64 unitary: the pscan and scan engines against the float64
      exact gradient;
  (e) BASELINE config 5: dim 200, 128 seeds through ``batched_grape_adam``
      (xla-cols), 8 of them against the vmapped xla backend.

``--four-cards`` runs only the sharded config-5 sweep (512 seeds over a
4-device mesh) and what it is compared with on one card.

Every single-problem fidelity is checked against a float64 scipy ``expm``
propagation of the optimized pulse.  Tolerances and why:
  * oracle vs ``fidelity_f64`` <= 1e-5: both are float64; the gap is the
    Taylor truncation of ``fidelity_f64``, far below 1e-5;
  * float32 vs float64 1e-5 (loss) / 1e-4 (relative l2 of a gradient) /
    1e-4 (|unitary_scale - 1|), and backend agreement 5e-5 (per-seed
    losses after several Adam steps): every matmul runs true float32
    (``Precision.HIGHEST``, no TF32) on the card, but sums in another
    order than the CPU and the other backend, and Adam's first steps
    amplify the last bits.  The scan engine's float32 matrix chain gets
    looser bounds (see phase d).

Each phase prints one line ``phase <name>: {json}`` with its numbers, the
time of its first call (compilation included) and its warm rate.  The
last line is ``{"ok": true, "device": {...}}``.  A failed check raises and
the script exits non-zero; it also exits non-zero, printing no result,
when JAX finds no GPU or when the script is not inside a checkout.

Run from the root of a checkout:  python chip_smoke.py [--four-cards]
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def report(name, **numbers):
    print(f"phase {name}: " + json.dumps(numbers), flush=True)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def twice(fn):
    """(result of the warm call, first-call s, warm-call s)."""
    _, first = timed(fn)
    out, warm = timed(fn)
    return out, first, warm


def expm_fidelity(problem, uks):
    """Final fidelity of the pulse ``uks`` by float64 piecewise-constant
    propagation with scipy's ``expm`` — independent of the Taylor kernel,
    same targets and U0 frame as ``analysis.fidelity_f64``."""
    import scipy.linalg as la

    n = problem.state_num
    H0 = np.asarray(problem.H0_c, dtype=np.complex128)
    Hops = [np.asarray(h, dtype=np.complex128) for h in problem.ops_c]
    uks = np.asarray(uks, dtype=np.float64)
    psi = np.asarray(problem.initial_vectors_c, dtype=np.complex128).T
    if problem.U_c is not None:
        Uc = np.asarray(problem.U_c, dtype=np.complex128)
        targets = Uc.T if problem.state_transfer else Uc @ psi
    else:
        tv = np.asarray(problem.target_vectors, dtype=np.float64)
        targets = tv[:n, :] + 1j * tv[n:2 * n, :]
    if not problem.state_transfer:
        psi = np.asarray(problem.U0_c, dtype=np.complex128) @ psi
    for t in range(problem.steps):
        H = H0 + sum(u * h for u, h in zip(uks[:, t], Hops))
        psi = la.expm(-1j * problem.dt * H) @ psi
    V = psi.shape[1]
    return float(np.abs(np.sum(np.conj(targets) * psi)) ** 2 / (V * V))


def check_against_oracle(name, res):
    """The loss is finite and the optimized pulse's two float64
    fidelities agree."""
    oracle = expm_fidelity(res.problem, res.uks)
    check(np.isfinite(res.loss) and np.isfinite(res.reg_loss),
          f"{name}: non-finite loss {res.loss}, {res.reg_loss}")
    check(abs(res.fidelity_f64 - oracle) <= 1e-5,
          f"{name}: fidelity_f64 {res.fidelity_f64} vs expm oracle {oracle}")
    return oracle


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_pi_pulse(steps=1000):
    """(a) 2x2 pi pulse, T=1000, through Grape(method="Adam") to 1-1e-4."""
    import qoc_tpu as q

    def run():
        return q.Grape(
            np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y],
            ["x", "y"], [np.array([0, 1], dtype=complex)], 10.0, steps,
            [np.array([1, 0], dtype=complex)],
            convergence={"rate": 0.01, "update_step": 100,
                         "max_iterations": 5000, "conv_target": 1e-4},
            state_transfer=True, maxA=[0.7, 0.7], seed=0, method="Adam",
            save=False, show_plots=False)

    res, first, warm = twice(run)
    check(res.loss < 1e-4, f"pi pulse did not converge: loss {res.loss}")
    oracle = check_against_oracle("pi pulse", res)
    report("a_pi_pulse", loss=res.loss, iterations=res.iterations,
           fidelity_f64=res.fidelity_f64, fidelity_expm=oracle,
           first_call_s=first, warm_call_s=warm,
           warm_it_per_s=res.iterations / warm)


def phase_leakage(iterations=300):
    """(b) BASELINE config 3: 5-level transmon X gate with forbidden-state
    and dwdt costs, a few hundred Adam iterations through Grape."""
    import qoc_tpu as q
    from __graft_entry__ import FLAGSHIP_RC, flagship_args

    args, kwargs = flagship_args()

    def run():
        return q.Grape(
            *args, **kwargs, reg_coeffs=FLAGSHIP_RC, method="Adam",
            convergence={"rate": 0.01, "update_step": 100,
                         "max_iterations": iterations, "conv_target": 1e-8},
            save=False, show_plots=False)

    res, first, warm = twice(run)
    oracle = check_against_oracle("leakage", res)
    costs = res.history.reg_costs
    check(costs[-1] <= costs[0], f"leakage reg loss rose: {costs}")
    report("b_leakage", loss=res.loss, reg_loss=res.reg_loss,
           iterations=res.iterations, fidelity_f64=res.fidelity_f64,
           fidelity_expm=oracle, first_call_s=first, warm_call_s=warm,
           warm_it_per_s=res.iterations / warm)


def phase_transmon_cavity(spec="examples/jobs/transmon_cavity.json",
                          segments=3):
    """(c) BASELINE config 4 at spec, loaded as the CLI loads a job, run
    for a few update_step segments without writing a run file."""
    from qoc_tpu import Grape
    from qoc_tpu.cli import load_config

    def run():
        cfg = load_config(os.path.join(HERE, spec))
        cfg["save"] = False
        cfg["show_plots"] = False
        conv = dict(cfg.get("convergence") or {})
        conv["max_iterations"] = segments * int(conv.get("update_step", 100))
        cfg["convergence"] = conv
        return Grape(**cfg)

    res, first, warm = twice(run)
    oracle = check_against_oracle("transmon cavity", res)
    costs = res.history.reg_costs
    check(costs[-1] <= costs[0], f"cavity reg loss rose: {costs}")
    report("c_transmon_cavity", dim=2 * res.problem.state_num,
           steps=res.problem.steps, loss=res.loss, reg_loss=res.reg_loss,
           iterations=res.iterations, fidelity_f64=res.fidelity_f64,
           fidelity_expm=oracle, first_call_s=first, warm_call_s=warm,
           warm_it_per_s=res.iterations / warm)


def phase_dim64_unitary(problem=None, repeats=20):
    """(d) the dim-64 unitary: loss, exact gradient and unitarity of the
    pscan engine (the GPU ladder's pick) and of the scan engine, each
    against the float64 exact gradient of the same Taylor approximant.

    The scan engine chains full [M, M] propagators and squarings in
    float32; at M=128, T=200 its error is 7.3e-5 in the loss, 4.1e-4
    relative l2 in the gradient and 2.9e-4 in unitary_scale, the same on
    the CPU and the H100, so it meets the looser bounds below; pscan
    propagates vectors and holds the tight ones."""
    import jax
    import jax.numpy as jnp
    from bench import dim64_problem
    from qoc_tpu.models.forward import make_forward
    from qoc_tpu.utils.verification import exact_unitary_grad_f64

    problem = problem if problem is not None else dim64_problem()
    loss64, grad64 = exact_unitary_grad_f64(
        problem, np.asarray(problem.u0_base, np.float64))
    bounds = {"pscan": (1e-5, 1e-4, 1e-4), "scan": (2e-4, 1e-3, 1e-3)}
    u = jnp.asarray(problem.u0_base)
    numbers = {"loss_f64": loss64}
    for engine, (tol_loss, tol_grad, tol_unit) in bounds.items():
        _, loss_fn = make_forward(problem, engine=engine, lean=True)
        vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        _, first = timed(lambda: jax.block_until_ready(vg(u)))
        _, total = timed(lambda: jax.block_until_ready(
            [vg(u) for _ in range(repeats)]))
        (_, out), grad = vg(u)
        dev_loss = abs(float(out.loss) - loss64)
        rel = float(np.linalg.norm(np.asarray(grad, np.float64) - grad64)
                    / np.linalg.norm(grad64))
        dev_unit = abs(float(out.unitary_scale) - 1.0)
        check(dev_loss <= tol_loss, f"dim64 {engine} loss off by {dev_loss}")
        check(rel <= tol_grad, f"dim64 {engine} gradient rel l2 {rel}")
        check(dev_unit <= tol_unit,
              f"dim64 {engine} |unitary_scale - 1| = {dev_unit}")
        numbers[engine] = {"loss": float(out.loss), "loss_dev": dev_loss,
                           "grad_rel_l2": rel, "unitary_dev": dev_unit,
                           "first_call_s": first,
                           "warm_evals_per_s": repeats / total}
    report("d_dim64_unitary", dim=2 * problem.state_num, **numbers)


def phase_config5_sweep(problem=None, n_seeds=128, n_compare=8,
                        iterations=30):
    """(e) BASELINE config 5: dim 200, T=200, ``n_seeds`` seeds through
    batched_grape_adam (xla-cols on a GPU); ``n_compare`` of them re-run
    on the vmapped xla backend from the same initial pulses."""
    import jax
    import jax.numpy as jnp
    from bench import dim200_problem
    from qoc_tpu.optim.convergence import ConvergenceSettings
    from qoc_tpu.parallel.batch import (
        batched_grape_adam, init_seeds, make_batched_runner, resolve_backend)

    problem = problem if problem is not None else dim200_problem()[0]
    check(resolve_backend(problem, None, "exact", False, True) == "xla-cols",
          "the GPU batch router does not pick xla-cols for config 5")
    conv = {"rate": 0.06, "update_step": 10, "max_iterations": iterations,
            "conv_target": 1e-4}
    out, first, warm = twice(lambda: batched_grape_adam(
        problem, n_seeds=n_seeds, convergence=conv, seed=0))
    check(np.all(np.isfinite(out["losses"])), "config 5: non-finite losses")

    u0 = init_seeds(problem, n_seeds, jax.random.PRNGKey(0))[:n_compare]
    init_x, run_x = make_batched_runner(
        problem, ConvergenceSettings.from_dict(conv), backend="xla")
    ref = run_x(init_x(u0), jnp.asarray(out["iterations"], dtype=jnp.int32),
                None)
    dev = float(np.max(np.abs(np.asarray(ref.loss)
                              - out["losses"][:n_compare])))
    check(dev <= 5e-5, f"config 5: xla-cols vs xla per-seed losses {dev}")
    report("e_config5_sweep", dim=2 * problem.state_num, seeds=n_seeds,
           iterations=out["iterations"], best_loss=out["best_loss"],
           max_loss_dev_vs_xla=dev, first_call_s=first, warm_call_s=warm,
           warm_seed_it_per_s=n_seeds * out["iterations"] / warm)


def phase_four_cards(problem=None, n_seeds=512, iterations=10,
                     n_stats=32, n_devices=4):
    """Config-5 sweep sharded over a 1-D mesh of ``n_devices`` cards,
    through make_xla_cols_sharded_runner and batched_grape_adam(mesh=...),
    each against the same seeds on one card; psum/pmin statistics of
    parallel/shard.py against the per-seed losses."""
    import jax
    from bench import dim200_problem
    from qoc_tpu.optim.convergence import ConvergenceSettings
    from qoc_tpu.parallel.batch import batched_grape_adam, init_seeds
    from qoc_tpu.parallel.mesh import make_mesh
    from qoc_tpu.parallel.shard import make_shard_map_step
    from qoc_tpu.parallel.xla_batch import make_xla_cols_sharded_runner

    check(len(jax.devices()) >= n_devices,
          f"need {n_devices} devices, found {len(jax.devices())}")
    problem = problem if problem is not None else dim200_problem()[0]
    conv_d = {"rate": 0.06, "update_step": iterations,
              "max_iterations": iterations, "conv_target": 1e-4}
    conv = ConvergenceSettings.from_dict(conv_d)
    mesh, mesh1 = make_mesh(n_devices), make_mesh(1)
    u0 = np.asarray(init_seeds(problem, n_seeds, jax.random.PRNGKey(0)))

    (u_n, fids_n, _), first = timed(lambda: jax.block_until_ready(
        make_xla_cols_sharded_runner(problem, conv, mesh)(u0, iterations)))
    (_, fids_1, _), first_1 = timed(lambda: jax.block_until_ready(
        make_xla_cols_sharded_runner(problem, conv, mesh1)(u0, iterations)))
    fids_n, fids_1 = np.asarray(fids_n), np.asarray(fids_1)
    dev_runner = float(np.max(np.abs(fids_n - fids_1)))
    check(dev_runner <= 5e-5,
          f"sharded xla-cols runner vs one card: {dev_runner}")

    out_n, first_b = timed(lambda: batched_grape_adam(
        problem, n_seeds=n_seeds, convergence=conv_d, seed=0, mesh=mesh))
    out_1, first_b1 = timed(lambda: batched_grape_adam(
        problem, n_seeds=n_seeds, convergence=conv_d, seed=0))
    dev_batch = float(np.max(np.abs(out_n["losses"] - out_1["losses"])))
    check(dev_batch <= 5e-5,
          f"batched_grape_adam(mesh) vs one card: {dev_batch}")

    init_s, step_s = make_shard_map_step(
        problem, conv, mesh, steps_per_call=iterations)
    _, _, stats = step_s(*init_s(u0[:n_stats]))
    ref = fids_1[:n_stats]
    dev_best = abs(float(stats.best_loss) - float(ref.min()))
    dev_mean = abs(float(stats.mean_loss) - float(ref.mean()))
    check(dev_best <= 5e-5 and dev_mean <= 5e-5,
          f"psum/pmin stats vs per-seed losses: {dev_best}, {dev_mean}")

    cards = jax.devices()[:n_devices]
    in_use = [(d.memory_stats() or {}).get("bytes_in_use") for d in cards]
    if cards[0].platform == "gpu":
        check(all(b and b > 0 for b in in_use),
              f"a card holds no data: {in_use}")
    del u_n
    report("four_cards_config5", devices=n_devices, seeds=n_seeds,
           iterations=iterations, max_loss_dev_runner=dev_runner,
           max_loss_dev_batched=dev_batch, stats_dev_best=dev_best,
           stats_dev_mean=dev_mean, bytes_in_use=in_use,
           runner_first_call_s=first, runner_one_card_first_call_s=first_1,
           batched_first_call_s=first_b, batched_one_card_first_call_s=first_b1)


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------


def require_checkout():
    """Import the program from the checkout this script lives in."""
    sys.path.insert(0, HERE)
    try:
        import qoc_tpu
    except ImportError:
        sys.exit("chip_smoke.py: qoc_tpu not found beside the script; "
                 "run it from the root of a checkout")
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(
        qoc_tpu.__file__)))
    if pkg_root != HERE:
        sys.exit(f"chip_smoke.py: qoc_tpu imported from {pkg_root}, "
                 "not from this checkout")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the config-5 sweep sharded over 4 cards")
    args = ap.parse_args(argv)

    require_checkout()
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke.py needs a GPU; JAX found "
                 f"{devices[0].platform} devices only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    for line in smi.stdout.strip().splitlines():
        print(line.strip(), flush=True)

    if args.four_cards:
        phase_four_cards()
    else:
        phase_pi_pulse()
        phase_leakage()
        phase_transmon_cavity()
        phase_dim64_unitary()
        phase_config5_sweep()

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
