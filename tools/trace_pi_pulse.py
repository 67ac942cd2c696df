"""Device trace of one pi-pulse Adam segment: kernels per iteration, device
busy time per iteration and the device's idle share.

Runs one ``update_step`` segment of the qubit pi pulse (BASELINE config 1,
T=1000) through the segment runner ``Grape(method="Adam")`` uses, under
``jax.profiler``, and reduces the trace: for every device plane the number
of kernel events, the union of their intervals (busy time), the window
from the first to the last event, and the kernels with the most time.

Run:  python tools/trace_pi_pulse.py [--out chiprun_out/trace_pi_pulse]
"""

import argparse
import glob
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def busy_ns(intervals):
    """Length of the union of [start, end) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(xplane_path, iterations):
    """Per device plane: per-line event counts and busy time, and over the
    kernel lines (``Stream ...``, or every line where none is so named)
    the kernel count, busy time, window and top kernels."""
    from jax.profiler import ProfileData

    out = {}
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith("/device:"):
            continue
        lines = {line.name: [(e.start_ns, e.end_ns, e.name)
                             for e in line.events] for line in plane.lines}
        kernel_lines = [n for n in lines if n.startswith("Stream")] or list(
            lines)
        events = [ev for n in kernel_lines for ev in lines[n]]
        summary = {"lines": {
            n: {"events": len(evs),
                "busy_us_per_iteration": busy_ns(
                    [(s, e) for s, e, _ in evs]) / 1e3 / iterations}
            for n, evs in lines.items()}}
        if events:
            per_name = {}
            for s, e, name in events:
                per_name[name] = per_name.get(name, 0) + (e - s)
            busy = busy_ns([(s, e) for s, e, _ in events])
            window = (max(e for _, e, _ in events)
                      - min(s for s, _, _ in events))
            top = sorted(per_name.items(), key=lambda kv: -kv[1])[:12]
            summary.update({
                "kernel_lines": kernel_lines,
                "kernels_per_iteration": len(events) / iterations,
                "busy_us_per_iteration": busy / 1e3 / iterations,
                "window_us_per_iteration": window / 1e3 / iterations,
                "idle_share_in_window": 1.0 - busy / window if window else 0.0,
                "top_kernels_us": {n: t / 1e3 for n, t in top},
            })
        out[plane.name] = summary
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "trace_pi_pulse"))
    ap.add_argument("--iterations", type=int, default=100)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from bench import _conv, _problem
    from qoc_tpu.models.forward import make_forward
    from qoc_tpu.optim.adam import (
        init_adam_state, make_adam_optimizer, make_segment_runner)
    from qoc_tpu.utils.profiling import trace

    problem = _problem()
    conv = _conv(conv_target=-1.0, update_step=args.iterations)
    _, loss_fn = make_forward(problem, lean=True, engine="auto")
    optimizer = make_adam_optimizer(conv)
    run_segment, _ = make_segment_runner(loss_fn, conv, optimizer)
    state0 = init_adam_state(jnp.asarray(problem.u0_base), optimizer)
    stop = jnp.asarray(args.iterations, dtype=jnp.int32)
    jax.block_until_ready(run_segment(state0, stop))   # compile + warm

    with trace(args.out):
        jax.block_until_ready(run_segment(state0, stop))
    path = sorted(glob.glob(os.path.join(
        args.out, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    summary = {"engine": loss_fn.resolved_engine,
               "iterations": args.iterations,
               "device": jax.devices()[0].device_kind,
               "planes": reduce_trace(path, args.iterations)}
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
