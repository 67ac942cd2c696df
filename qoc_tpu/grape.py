"""Public API: ``Grape(...)`` — drop-in entry point plus JAX-native extras.

Signature-compatible with the reference entry point
(main_grape/grape.py:19): same positional arguments, same keyword defaults,
same ``(uks, U_final)`` return.  GPU/sparse-specific knobs (``use_gpu``,
``sparse_H/U/K``) are accepted and ignored — XLA owns placement and the
dense path is the performance path (SURVEY.md section 5, sparse row).

New keywords:
  * ``gradient_mode``: 'exact' (autodiff through the Taylor propagator,
    default) or 'reference' (the reference's first-order GRAPE gradient via
    custom_vjp, tensorflow_state.py:49-142, for trajectory parity).
  * ``engine``: 'auto' | 'associative' (parallel-in-time) | 'pscan'
    (batched propagators + serial state scan) | 'scan'.
  * ``seed``: explicit RNG seed for the default random initial pulse
    (the reference uses unseeded np.random, system_parameters.py:282).
  * ``remat``: rematerialize propagators in the backward pass for long
    horizons (the reference's recompute-in-backward Defun precedent,
    tensorflow_state.py:58).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from .models.forward import make_forward
from .models.system import ControlProblem
from .optim.adam import init_adam_state, make_adam_optimizer, make_segment_runner
from .optim.convergence import ConvergenceSettings, History
from .optim.scipy_bridge import run_scipy_optimizer
from .utils import analysis as _analysis
from .utils.h5 import next_run_path, save_run_inputs


class GrapeResult:
    """Everything a run produced (the reference returns only (uks, Uf))."""

    def __init__(self, uks, Uf, u_base, loss, reg_loss, unitary_scale,
                 iterations, history, file_path, inter_vecs=None, problem=None,
                 nfev=None, fidelity_f64=None):
        self.uks = uks
        self.Uf = Uf
        self.u_base = u_base
        self.loss = loss
        self.reg_loss = reg_loss
        self.unitary_scale = unitary_scale
        self.iterations = iterations
        self.history = history
        self.file_path = file_path
        self.inter_vecs = inter_vecs
        self.problem = problem
        # scipy-bridge methods: number of function evaluations (each
        # L-BFGS-B line-search probe is one), distinct from `iterations`
        self.nfev = nfev
        # float64 recompute of the final fidelity by the framework's own
        # Taylor propagation (analysis.fidelity_f64): removes the f32
        # accumulation floor from oracle comparisons
        self.fidelity_f64 = fidelity_f64

    def __iter__(self):  # allow `uks, Uf = Grape(...)` tuple unpacking
        return iter((self.uks, self.Uf))


def Grape(
    H0,
    Hops,
    Hnames,
    U,
    total_time,
    steps,
    states_concerned_list,
    convergence: Optional[dict] = None,
    U0=None,
    reg_coeffs: Optional[dict] = None,
    dressed_info: Optional[dict] = None,
    maxA=None,
    use_gpu: bool = True,            # accepted for compat; XLA places
    sparse_H: bool = True,           # accepted for compat; always dense
    sparse_U: bool = False,
    sparse_K: bool = False,
    draw=None,
    initial_guess=None,
    show_plots: bool = True,
    unitary_error: float = 1e-4,
    method: str = "Adam",
    state_transfer: bool = False,
    no_scaling: bool = False,
    freq_unit: str = "GHz",
    file_name: Optional[str] = None,
    save: bool = True,
    data_path: Optional[str] = None,
    Taylor_terms=None,
    use_inter_vecs: bool = True,
    # --- extensions ---
    gradient_mode: str = "exact",
    engine: str = "auto",
    seed: Optional[int] = None,
    remat: bool = False,
    resume_from: Optional[str] = None,
) -> GrapeResult:
    grape_start_time = time.time()

    freq_time_unit_dict = {"GHz": "ns", "MHz": "us", "KHz": "ms", "Hz": "s"}
    time_unit = freq_time_unit_dict[freq_unit]

    file_path = None
    if save:
        if file_name is None:
            raise ValueError("Grape function input: file_name, is not specified.")
        if data_path is None:
            raise ValueError("Grape function input: data_path, is not specified.")
        file_path = next_run_path(data_path, file_name)
        print("data saved at: " + str(file_path))

    conv = ConvergenceSettings.from_dict(convergence)

    if save:
        save_run_inputs(
            file_path,
            H0=H0, Hops=Hops, Hnames=Hnames, U=U,
            total_time=total_time, steps=steps,
            states_concerned_list=states_concerned_list,
            maxA=maxA, initial_guess=initial_guess, method=method,
            convergence=convergence
            or {"rate": conv.rate, "update_step": conv.update_step,
                "max_iterations": conv.max_iterations,
                "conv_target": conv.conv_target,
                "learning_rate_decay": conv.learning_rate_decay},
            reg_coeffs=reg_coeffs, dressed_info=dressed_info,
            use_gpu=use_gpu, sparse_H=sparse_H, sparse_U=sparse_U,
            sparse_K=sparse_K,
        )

    problem = ControlProblem.build(
        H0, Hops, Hnames, U, total_time, steps, states_concerned_list,
        U0=U0, dressed_info=dressed_info, maxA=maxA,
        initial_guess=initial_guess, unitary_error=unitary_error,
        state_transfer=state_transfer, no_scaling=no_scaling,
        Taylor_terms=Taylor_terms, use_inter_vecs=use_inter_vecs, seed=seed,
    )
    from .models.costs import validate_reg_coeffs

    validate_reg_coeffs(reg_coeffs, state_num=problem.state_num)
    print(
        "Using %d Taylor terms and %d Scaling & Squaring terms"
        % (problem.taylor_terms, problem.taylor_scaling)
    )
    if save:
        from .utils.h5 import H5File

        with H5File(file_path, "a") as hf:
            hf.add("taylor_terms", problem.taylor_terms)
            hf.add("taylor_scaling", problem.taylor_scaling)
            hf.add("initial_vectors_c", problem.initial_vectors_c)

    # analysis forward (emits inter_vecs) vs lean optimization loss (skips
    # intermediate-state materialization unless a cost reads it)
    forward, _ = make_forward(
        problem, reg_coeffs=reg_coeffs, gradient_mode=gradient_mode,
        engine=engine, remat=remat, lean=False,
    )
    # jit: the analysis forward is ONE program instead of dozens of eager
    # op dispatches
    import jax as _jax

    forward = _jax.jit(forward)
    _, loss_fn = make_forward(
        problem, reg_coeffs=reg_coeffs, gradient_mode=gradient_mode,
        engine=engine, remat=remat, lean=True,
    )

    history = History()
    method_u = method.upper()

    def display_dashboard(u_base):
        """Live dashboard refresh (convergence.py:121-222 behavior): only
        meaningful inside IPython; headless runs fall through to prints."""
        try:
            from IPython import display as ipy_display
            from IPython import get_ipython

            if get_ipython() is None:
                return
        except ImportError:
            return
        from .utils import plotting as _plotting

        out = forward(u_base)
        fig = _plotting.plot_summary(
            problem, history,
            uks=_analysis.uks_from_base(problem, u_base),
            final_state_c=(
                None if problem.state_transfer
                else _analysis.final_state_to_complex(
                    problem, np.asarray(out.final_state))
            ),
            inter_vecs=(
                np.asarray(out.inter_vecs)
                if out.inter_vecs is not None else None
            ),
            reg_coeffs=reg_coeffs, time_unit=time_unit, draw=draw,
        )
        ipy_display.display(fig)
        ipy_display.clear_output(wait=True)
        import matplotlib.pyplot as plt

        plt.close(fig)

    # periodic evolution snapshots: the reference appends inter_vecs_* /
    # final_state every evol_save_step iterations (run_session.py:84-91,
    # convergence.py:64-68 -> analysis.py:31-33,62-99), building a
    # training-time evolution history in the run file.
    evol_state = {"last_idx": 0}

    def maybe_save_evolution(iteration, u_base):
        es = conv.evol_save_step
        if not save or es <= 0 or iteration <= 0:
            return
        idx = iteration // es
        if idx <= evol_state["last_idx"]:
            return
        evol_state["last_idx"] = idx
        out = forward(u_base)
        _analysis.append_evolution(
            file_path, problem, np.asarray(out.final_state),
            np.asarray(out.inter_vecs) if out.inter_vecs is not None else None,
        )

    def evol_boundary_step(iteration, loss, reg_loss, uscale, u_base,
                           start_time):
        """Evol-grid-only boundary (iteration % evol_save_step == 0 but not
        on the update_step grid): the reference calls save_data() here too
        (run_session.py:84-91), appending a full metrics row — error,
        reg_error, uks, iteration, run_time, unitary_scale — before the
        evolution snapshot, so every snapshot pairs with a metrics row."""
        es = conv.evol_save_step
        if (save and es > 0 and iteration > 0 and iteration % es == 0
                and iteration // es > evol_state["last_idx"]):
            _analysis.append_metrics(
                file_path, error=loss, reg_error=reg_loss,
                uks=_analysis.uks_from_base(problem, u_base),
                iteration=iteration, run_time=time.time() - start_time,
                unitary_scale=uscale,
            )
        maybe_save_evolution(iteration, u_base)

    def save_step(iteration, loss, reg_loss, g2, uscale, u_base, start_time,
                  lr=None):
        history.record(iteration, loss, reg_loss, g2, uscale, lr=lr)
        if save:
            _analysis.append_metrics(
                file_path,
                error=loss, reg_error=reg_loss,
                uks=_analysis.uks_from_base(problem, u_base),
                iteration=iteration,
                run_time=time.time() - start_time,
                unitary_scale=uscale,
            )
        maybe_save_evolution(iteration, u_base)
        if show_plots:
            display_dashboard(u_base)
        else:
            print(
                "Error = :%1.2e; Runtime: %.1fs; Iterations = %d, "
                "grads =  %10.3e, unitary_metric = %.5f"
                % (loss, time.time() - start_time, iteration, g2, uscale)
            )

    def next_stop(it: int) -> int:
        """Next segment boundary: the update_step grid AND (when saving)
        the evol_save_step grid, so evol_save_step < update_step keeps its
        exact cadence (run_session.py:84-91 saves inside the iteration
        loop; here segments are chunked to land on every save point)."""
        nxt = (it // conv.update_step + 1) * conv.update_step
        es = conv.evol_save_step
        if save and es > 0:
            nxt = min(nxt, (it // es + 1) * es)
        return min(nxt, conv.max_iterations + 1)

    start_time = time.time()
    nfev = None

    if method_u == "EVOLVE":
        out = forward(problem.u0_base)
        u_base = np.asarray(problem.u0_base)
        loss, reg_loss, uscale = (
            float(out.loss), float(out.reg_loss), float(out.unitary_scale))
        iterations = 0
        save_step(0, loss, reg_loss, 0.0, uscale, u_base, start_time)
        final_state = np.asarray(out.final_state)
        inter_vecs = (
            np.asarray(out.inter_vecs) if out.inter_vecs is not None else None
        )
    elif method_u == "ADAM":
        import jax.numpy as jnp

        from .routing import announce

        # the name the lean loss actually resolved to (attached by
        # make_forward from the shared ladder functions)
        announce("engine", loss_fn.resolved_engine)
        optimizer = make_adam_optimizer(conv)
        run_segment, _ = make_segment_runner(loss_fn, conv, optimizer)
        state = init_adam_state(problem.u0_base, optimizer)

        if resume_from is not None:
            from .utils.checkpoint import load_checkpoint

            u_r, opt_r, it_r = load_checkpoint(
                resume_from, state.u_base, state.opt_state)
            state = state._replace(
                u_base=u_r, opt_state=opt_r,
                iteration=jnp.asarray(it_r, dtype=jnp.int32),
            )
            print(f"resumed from {resume_from} at iteration {it_r}")

        try:
            while True:
                it = int(state.iteration)
                stop_at = next_stop(it)
                state = run_segment(
                    state, jnp.asarray(stop_at, dtype=jnp.int32))
                it_now = int(state.iteration)
                done = bool(state.done)
                if it_now % conv.update_step == 0 or done:
                    save_step(
                        it_now, float(state.loss),
                        float(state.reg_loss), float(state.grad_squared),
                        float(state.unitary_scale), np.asarray(state.u_base),
                        start_time,
                        lr=conv.learning_rate(it_now),
                    )
                    if save:
                        from .utils.checkpoint import save_checkpoint

                        save_checkpoint(file_path, state.u_base,
                                        state.opt_state, it_now)
                else:
                    # evol-grid-only boundary: metrics row + snapshot
                    # (run_session.py:84-91 parity)
                    evol_boundary_step(
                        it_now, float(state.loss), float(state.reg_loss),
                        float(state.unitary_scale), np.asarray(state.u_base),
                        start_time)
                if done:
                    break
        except KeyboardInterrupt:
            # graceful interrupt (grape.py:130-139): persist wall clock and
            # the latest checkpoint, return the current iterate — unlike the
            # reference, the run is resumable via resume_from=<file>.
            if save:
                from .utils.checkpoint import save_checkpoint
                from .utils.h5 import H5File

                save_checkpoint(file_path, state.u_base, state.opt_state,
                                int(state.iteration))
                with H5File(file_path, "a") as hf:
                    hf.add("wall_clock_time",
                           np.array(time.time() - grape_start_time))
                print("interrupted; data saved at: " + str(file_path))
        u_base = np.asarray(state.u_base)
        loss, reg_loss = float(state.loss), float(state.reg_loss)
        uscale = float(state.unitary_scale)
        iterations = int(state.iteration)
        out = forward(u_base)
        final_state = np.asarray(out.final_state)
        inter_vecs = (
            np.asarray(out.inter_vecs) if out.inter_vecs is not None else None
        )
    elif method_u in ("L-BFGS-JAX", "LBFGS", "LBFGS-JAX"):
        # native on-device L-BFGS (optax) — the fast path; use 'L-BFGS-B'
        # for the scipy bridge with exact reference-parity options
        from .optim.lbfgs import make_lbfgs_runner

        import jax.numpy as jnp

        init_state, run_segment = make_lbfgs_runner(loss_fn, conv)
        state = init_state(problem.u0_base)
        while True:
            it = int(state.iteration)
            stop_at = next_stop(it)
            state = run_segment(state, jnp.asarray(stop_at, dtype=jnp.int32))
            it_now = int(state.iteration)
            done = bool(state.done)
            if it_now % conv.update_step == 0 or done:
                save_step(
                    it_now, float(state.loss),
                    float(state.reg_loss), float(state.grad_squared),
                    float(state.unitary_scale), np.asarray(state.u_base),
                    start_time,
                )
            else:
                evol_boundary_step(
                    it_now, float(state.loss), float(state.reg_loss),
                    float(state.unitary_scale), np.asarray(state.u_base),
                    start_time)
            if done:
                break
        u_base = np.asarray(state.u_base)
        loss, reg_loss = float(state.loss), float(state.reg_loss)
        uscale = float(state.unitary_scale)
        iterations = int(state.iteration)
        out = forward(u_base)
        final_state = np.asarray(out.final_state)
        inter_vecs = (
            np.asarray(out.inter_vecs) if out.inter_vecs is not None else None
        )
    elif method_u in ("BFGS", "L-BFGS-B"):
        print("Starting " + method_u + " Optimization")
        update_step = conv.update_step
        ncalls = {"n": 0}

        def cb(iteration, loss, reg_loss, g2, uscale, u_base):
            if iteration % update_step == 0:
                save_step(iteration, loss, reg_loss, g2, uscale, u_base,
                          start_time)

        u_base, res = run_scipy_optimizer(
            loss_fn, problem.u0_base, conv, method=method_u, callback=cb
        )
        print(method_u + " optimization done")
        out = forward(u_base)
        loss, reg_loss = float(out.loss), float(out.reg_loss)
        uscale = float(out.unitary_scale)
        # honest accounting: `nit` is optimizer iterations (the reference's
        # per-eval counter, run_session.py:151-167, conflates line-search
        # probes with iterations); function evaluations stay separately
        # available as GrapeResult.nfev.
        iterations = int(res.get("nit", res.get("nfev", 0)))
        nfev = int(res.get("nfev", 0))
        if not show_plots:
            print(res.message)
            print("Error = %1.2e" % loss)
            print("Total time is " + str(time.time() - start_time))
        final_state = np.asarray(out.final_state)
        inter_vecs = (
            np.asarray(out.inter_vecs) if out.inter_vecs is not None else None
        )
    else:
        raise ValueError(f"unknown method {method!r}")

    # final snapshots (run_session.py:94-110)
    uks = _analysis.uks_from_base(problem, u_base)
    # float64 fidelity readout: the optimizer's loss stays float32 (bit-
    # compatible with the on-device value); this companion number removes
    # the ~1e-5 f32 accumulation floor at dims >= 50 so oracle comparisons
    # measure algorithm agreement, not float width (see analysis.fidelity_f64)
    fid64 = _analysis.fidelity_f64(problem, uks)
    if save:
        _analysis.append_metrics(
            file_path, error=loss, reg_error=reg_loss, uks=uks,
            iteration=iterations, run_time=time.time() - start_time,
            unitary_scale=uscale,
        )
        _analysis.append_evolution(file_path, problem, final_state, inter_vecs)

    if problem.state_transfer:
        Uf = []
    else:
        Uf = _analysis.final_state_to_complex(problem, final_state)

    if save:
        from .utils.h5 import H5File

        with H5File(file_path, "a") as hf:
            hf.add("wall_clock_time", np.array(time.time() - grape_start_time))
            hf.add("fidelity_f64", np.array(fid64))
        print("data saved at: " + str(file_path))

    return GrapeResult(
        uks=uks, Uf=Uf, u_base=u_base, loss=loss, reg_loss=reg_loss,
        unitary_scale=uscale, iterations=iterations, history=history,
        file_path=file_path, inter_vecs=inter_vecs, problem=problem,
        nfev=nfev, fidelity_f64=fid64,
    )
