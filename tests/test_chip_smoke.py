"""chip_smoke.py: it refuses to run off the GPU or outside a checkout, and
each of its phases passes at a small size on the CPU (the rehearsal of
the on-card run; its timings here mean nothing)."""

import os
import shutil
import subprocess
import sys

import numpy as np

import qoc_tpu as q
from qoc_tpu.models.system import ControlProblem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu():
    r = _run([os.path.join(ROOT, "chip_smoke.py")], ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_exits_nonzero_outside_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def _small_cavity(levels=4, steps=10):
    a = q.annihilate(levels)
    H0 = 2 * np.pi * (-0.2) / 2 * (a.conj().T @ a.conj().T @ a @ a)
    psi0 = np.zeros(levels, complex)
    psi0[0] = 1
    tgt = np.zeros(levels, complex)
    tgt[1] = 1
    return ControlProblem.build(
        H0, [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"], [tgt],
        3.0, steps, [psi0], state_transfer=True, maxA=[1.0, 1.0], seed=0)


def test_phase_pi_pulse(capsys):
    chip_smoke.phase_pi_pulse()
    assert "phase a_pi_pulse:" in capsys.readouterr().out


def test_phase_leakage(capsys):
    chip_smoke.phase_leakage(iterations=200)
    assert "phase b_leakage:" in capsys.readouterr().out


def test_phase_job_spec(capsys):
    chip_smoke.phase_transmon_cavity(spec="examples/jobs/spin_pi.json",
                                     segments=2)
    assert "phase c_transmon_cavity:" in capsys.readouterr().out


def test_phase_unitary_engines(capsys):
    a = q.annihilate(4)
    problem = ControlProblem.build(
        np.diag(np.arange(4.0)) * 0.3, [a + a.conj().T, 1j * (a - a.conj().T)],
        ["x", "y"], q.transmon_gate(q.SIGMA_X, 4), 3.0, 12, [0, 1],
        maxA=[0.6, 0.6], seed=0, Taylor_terms=[8, 2])
    chip_smoke.phase_dim64_unitary(problem, repeats=2)
    assert "phase d_dim64_unitary:" in capsys.readouterr().out


def test_phase_seed_sweep(capsys):
    chip_smoke.phase_config5_sweep(_small_cavity(), n_seeds=16, n_compare=4,
                                   iterations=6)
    assert "phase e_config5_sweep:" in capsys.readouterr().out


def test_phase_four_devices(eight_devices, capsys):
    chip_smoke.phase_four_cards(_small_cavity(), n_seeds=16, iterations=3,
                                n_stats=8)
    assert "phase four_cards_config5:" in capsys.readouterr().out
