"""uks cross-engine divergence analysis (PARITY.md criterion evidence).

PARITY.md compares optimized-pulse prefixes between the engine Grape's
GPU auto ladder picks (pscan or associative) and the XLA scan engine.  The CNOT config's 200-iteration deviation sits
~3 orders above spin_pi/leakage's, so this tool distinguishes the two
possible causes:

  * **rounding-seeded chaos**: both engines compute the same math with
    different float32 reassociations; a nonconvex Adam trajectory
    amplifies any initial rounding difference exponentially.  Prediction:
    the auto-vs-scan divergence curve grows SMOOTHLY at the same
    exponential rate as a control experiment — the SAME engine run twice
    from initial pulses differing by one float32 ulp.
  * **a real engine discrepancy** (e.g. in the squaring branch, the one
    code path unique to CNOT's scaling>0): prediction — a jump or a
    systematically larger divergence than the ulp control, and a
    per-iteration gradient mismatch at iteration 0 beyond rounding.

Measures, at every `stride` iterations up to `n_iters`:
  max|uks_auto - uks_scan|   (cross-engine)
  max|uks_scan - uks_scan'|  (ulp-perturbation control, same engine)
and the iteration-0 single-gradient cross-check.  Writes JSON + a
markdown row block for PARITY.md.

Usage:  python tools/uks_divergence.py [--config examples/jobs/cnot.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def divergence_curves(cfg_path: str, n_iters: int = 200, stride: int = 10):
    import jax
    import jax.numpy as jnp

    from qoc_tpu.cli import load_config
    from qoc_tpu.models.forward import make_forward
    from qoc_tpu.models.system import ControlProblem
    from qoc_tpu.ops.propagation import (
        resolve_state_engine, resolve_unitary_engine)
    from qoc_tpu.optim.adam import (
        init_adam_state, make_adam_optimizer, make_segment_runner)
    from qoc_tpu.optim.convergence import ConvergenceSettings

    cfg = load_config(cfg_path)
    rc = cfg.get("reg_coeffs") or None
    problem = ControlProblem.build(
        cfg["H0"], cfg["Hops"], cfg["Hnames"], cfg["U"], cfg["total_time"],
        cfg["steps"], cfg["states_concerned_list"],
        maxA=cfg.get("maxA"), seed=cfg.get("seed", 0),
        state_transfer=cfg.get("state_transfer", False),
        dressed_info=cfg.get("dressed_info"),
    )
    conv = ConvergenceSettings.from_dict(
        dict(cfg.get("convergence") or {}, conv_target=-1.0,
             min_grad=-1.0, max_iterations=10 ** 6))
    maxamp = np.asarray(problem.ops_max_amp)[:, None]
    optimizer = make_adam_optimizer(conv)

    # --- engine A: the engine Grape's auto ladder picks on the GPU ---
    M = 2 * problem.state_num
    if problem.state_transfer:
        engine_a = resolve_state_engine(M, problem.steps, "exact", True)
    else:
        engine_a = resolve_unitary_engine(
            M, problem.steps, problem.taylor_scaling, "exact", True)
    _, loss_a = make_forward(problem, lean=True, engine=engine_a,
                             reg_coeffs=rc)
    run_a, _ = make_segment_runner(loss_a, conv, optimizer)
    s = init_adam_state(problem.u0_base, optimizer)
    uks_a = {}
    for it in range(0, n_iters, stride):
        s = run_a(s, jnp.asarray(it + stride, dtype=jnp.int32))
        uks_a[it + stride] = maxamp * np.sin(np.asarray(s.u_base))
    g_a = np.asarray(jax.grad(lambda u: loss_a(u)[0])(
        jnp.asarray(problem.u0_base)))

    # --- engine B: the serial scan (XLA), same segments, + ulp control ---
    _, loss_fn = make_forward(problem, lean=True, engine="scan",
                              reg_coeffs=rc)
    run_seg, _ = make_segment_runner(loss_fn, conv, optimizer)

    def scan_traj(u0):
        s = init_adam_state(u0, optimizer)
        out = {}
        for it in range(0, n_iters, stride):
            s = run_seg(s, jnp.asarray(it + stride, dtype=jnp.int32))
            out[it + stride] = maxamp * np.sin(np.asarray(s.u_base))
        return out

    uks_scan = scan_traj(problem.u0_base)
    # control: EVERY entry one float32 ulp up — the closest analog of the
    # per-op reassociation noise that separates two engines.  (A single
    # 1-ulp entry is sub-resolution: f32 sin() rounds it away and the two
    # trajectories stay bit-identical — measured.)
    u0p = np.nextafter(np.asarray(problem.u0_base, dtype=np.float32),
                       np.float32(np.inf))
    uks_ulp = scan_traj(jnp.asarray(u0p))

    # --- iteration-0 gradient cross-check (engine math, no trajectory) ---
    g_scan = np.asarray(jax.grad(lambda u: loss_fn(u)[0])(
        jnp.asarray(problem.u0_base)))
    g0_dev = float(np.max(np.abs(g_a - g_scan)))
    g0_scale = float(np.max(np.abs(g_scan)))

    rows = []
    for it in sorted(uks_scan):
        rows.append({
            "iteration": it,
            "cross_engine": float(np.max(np.abs(uks_a[it]
                                                - uks_scan[it]))),
            "ulp_control": float(np.max(np.abs(uks_ulp[it]
                                               - uks_scan[it]))),
        })

    def rate(key):
        """log10 growth per iteration over the positive entries."""
        pts = [(r["iteration"], r[key]) for r in rows if r[key] > 0]
        if len(pts) < 2:
            return None
        its = np.array([p[0] for p in pts], float)
        lg = np.log10([p[1] for p in pts])
        return float(np.polyfit(its, lg, 1)[0])

    return {
        "config": os.path.basename(cfg_path),
        "engines": f"{engine_a} vs scan",
        "n_iters": n_iters,
        "grad_iter0_max_abs_dev": g0_dev,
        "grad_iter0_scale": g0_scale,
        "rows": rows,
        "growth_log10_per_iter": {
            "cross_engine": rate("cross_engine"),
            "ulp_control": rate("ulp_control"),
        },
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "examples", "jobs", "cnot.json"))
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    rep = divergence_curves(args.config, n_iters=args.iters)
    txt = json.dumps(rep, indent=1)
    print(txt)
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt)
    print(f"\n| iter | {rep['engines']} | ulp control (scan-vs-scan) |")
    print("|---|---|---|")
    for r in rep["rows"]:
        print(f"| {r['iteration']} | {r['cross_engine']:.2e} | "
              f"{r['ulp_control']:.2e} |")


if __name__ == "__main__":
    main()
