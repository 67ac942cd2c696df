"""Full-scale reference-example parity pack (BASELINE.md correctness row).

Runs the three BASELINE configs at published scale (steps = 1000, the
reference's real convergence budgets: rate 0.01, decay 2500, 5000-iteration
cap — grape.py:92 / convergence.py:16-49) through the exact
``python -m qoc_tpu run`` job-spec path, then measures, per config:

  * final fidelity 1 - loss and iterations to convergence;
  * independent-oracle re-simulation (scipy float64 expm AND the adaptive
    ODE integrator — the reference's qutip_verification flow,
    qutip_verification.py:75-86): max-abs-diff of stored vs re-simulated
    intermediate states, and the all_close verdict at atol 1e-4;
  * oracle-fidelity delta: |(1 - reported_loss) - F_oracle| where F_oracle
    is the coherent gate fidelity recomputed in float64 from the SAVED
    pulses by the independent propagator — the measurable form of
    BASELINE.md's "final-unitary fidelity delta < 1e-6" criterion (the TF1
    reference itself cannot execute here: Python 2.7-only, setup.py:4-6);
  * cross-engine uks agreement: the auto-routed engine (pscan or
    associative on a GPU) vs the serial scan path over a 200-iteration
    prefix at full scale (identical math, independent implementations).  Long-horizon whole-run uks comparison is not
    well-posed — float32 rounding differences amplify chaotically through
    5000 nonconvex iterations, on the reference exactly as here — so the
    per-trajectory criterion is measured on a prefix where rounding noise
    has not yet mixed.

Usage:  python examples/parity_pack.py [outdir]
Writes <outdir>/PARITY_RESULTS.json and prints a markdown table.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIG_NAMES = ["spin_pi", "cnot", "transmon_leakage", "transmon_cavity"]
JOBS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jobs")


def oracle_fidelity(h5path: str) -> float:
    """Coherent gate fidelity |sum_v <t_v|psi_v^oracle>|^2 / V^2 recomputed
    in float64 from the saved pulses by the independent expm propagator
    (inner_product_2D semantics, tensorflow_state.py:282-300)."""
    import h5py
    from qoc_tpu.utils.verification import scipy_oracle_states

    with h5py.File(h5path, "r") as hf:
        total_time = float(np.array(hf["total_time"]))
        steps = int(np.array(hf["steps"]))
        H0 = np.array(hf["H0"])
        Hops = np.array(hf["Hops"])
        init_vecs = np.array(hf["initial_vectors_c"])     # [V, N]
        uks = np.array(hf["uks"])[-1]
        U = np.array(hf["U"])
        state_transfer = U.ndim == 2 and U.shape[0] != U.shape[1]
        if U.ndim == 1:
            U = U[None, :]
            state_transfer = True

    V = len(init_vecs)
    ov = 0.0 + 0.0j
    for v in range(V):
        final = scipy_oracle_states(
            H0, Hops, uks, total_time, steps, init_vecs[v])[:, -1]
        if U.shape == (len(init_vecs[v]), len(init_vecs[v])) and not state_transfer:
            target = U @ init_vecs[v]
        else:
            target = U[v]
        ov += np.vdot(target, final)
    return float(np.abs(ov) ** 2 / (V * V))


def uks_prefix_agreement(cfg: dict, n_iters: int = 200) -> float:
    """max|u_auto - u_scan| after ``n_iters`` full-scale iterations of the
    auto-routed engine vs the serial scan path (both exact-gradient Adam)."""
    from qoc_tpu import Grape

    base = dict(cfg)
    base.pop("data_path", None)
    base.update(save=False, show_plots=False)
    base["convergence"] = dict(
        cfg.get("convergence") or {},
        max_iterations=n_iters, conv_target=-1.0, update_step=n_iters)
    r_auto = Grape(**base, engine="auto")
    r_scan = Grape(**base, engine="scan")
    return float(np.max(np.abs(np.asarray(r_auto.uks)
                               - np.asarray(r_scan.uks))))


def run_pack(outdir: str):
    from qoc_tpu.cli import load_config
    from qoc_tpu import Grape
    from qoc_tpu.utils.verification import verify_run

    os.makedirs(outdir, exist_ok=True)
    results = []
    for name in CONFIG_NAMES:
        spec = os.path.join(JOBS_DIR, f"{name}.json")
        cfg = load_config(spec)
        cfg["data_path"] = outdir
        cfg["file_name"] = name
        print(f"=== {name}: optimizing at published scale ===", flush=True)
        t0 = time.time()
        res = Grape(**cfg)
        wall = time.time() - t0
        print(f"  loss={res.loss:.3e} iters={res.iterations} "
              f"wall={wall:.1f}s", flush=True)

        ver = verify_run(res.file_path, atol=1e-4)
        ver_ode = verify_run(res.file_path, atol=1e-4, oracle="ode")
        f_oracle = oracle_fidelity(res.file_path)
        # primary criterion: the framework's float64 Taylor readout vs the
        # independent float64 Pade oracle — algorithm-vs-algorithm agreement.
        # The raw float32 on-device loss is kept as a secondary column: at
        # dims >= 50 it carries a ~1e-5 f32 accumulation floor that is a
        # property of float width (identical in the f32 TF1 reference), not
        # of either algorithm (measured: config 4's f32 recompute is
        # bit-identical at Taylor order 15 and 20).
        delta = abs(res.fidelity_f64 - f_oracle)
        delta_f32 = abs((1.0 - res.loss) - f_oracle)
        print(f"  oracle F={f_oracle:.9f} delta={delta:.2e} "
              f"delta_f32_reported={delta_f32:.2e} "
              f"expm max_abs_diff={max(ver['max_abs_diff']):.2e} "
              f"ode max_abs_diff={max(ver_ode['max_abs_diff']):.2e}",
              flush=True)
        du = uks_prefix_agreement(cfg)
        print(f"  uks 200-iter auto-vs-scan max|du|={du:.2e}", flush=True)

        results.append({
            "config": name,
            "steps": cfg["steps"],
            "total_time": cfg["total_time"],
            "final_loss": res.loss,
            "final_fidelity": 1.0 - res.loss,
            "fidelity_f64": res.fidelity_f64,
            "iterations": res.iterations,
            "wall_s": round(wall, 1),
            "oracle_fidelity": f_oracle,
            # key renamed (was 'oracle_fidelity_delta' through round 3,
            # measuring the f32 on-device fidelity): this is the f64
            # Taylor-vs-Pade comparison, explicitly labeled, while the f32
            # delta continues the old series under its own name
            "oracle_fidelity_delta_f64": delta,
            "oracle_fidelity_delta": delta_f32,
            "verify_expm_max_abs_diff": max(ver["max_abs_diff"]),
            "verify_expm_all_close": all(ver["all_close"]),
            "verify_ode_max_abs_diff": max(ver_ode["max_abs_diff"]),
            "verify_ode_all_close": all(ver_ode["all_close"]),
            "uks_prefix_200_max_dev": du,
            "run_file": res.file_path,
        })

    with open(os.path.join(outdir, "PARITY_RESULTS.json"), "w") as f:
        json.dump(results, f, indent=1)

    print("\n| config | steps | fidelity | iters | oracle-F delta (f64) | "
          "expm maxdiff | ode maxdiff | uks prefix dev |")
    print("|---|---|---|---|---|---|---|---|")
    for r in results:
        print(f"| {r['config']} | {r['steps']} | "
              f"{r['final_fidelity']:.8f} | {r['iterations']} | "
              f"{r['oracle_fidelity_delta_f64']:.2e} | "
              f"{r['verify_expm_max_abs_diff']:.2e} | "
              f"{r['verify_ode_max_abs_diff']:.2e} | "
              f"{r['uks_prefix_200_max_dev']:.2e} |")
    return results


if __name__ == "__main__":
    run_pack(sys.argv[1] if len(sys.argv) > 1 else "build/parity_runs")
