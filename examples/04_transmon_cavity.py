"""Transmon-cavity state transfer (BASELINE config 4) at dim 60.

Dispersive cQED in the qubit rotating frame: a 3-level transmon coupled
to a 20-level cavity, dressed (eigen)basis bookkeeping
(system_parameters.py:75-80 semantics), qubit x/y + cavity x/y drives,
and the trajectory-reading costs — bandpass + speed-up + dwdt
(regularization_functions.py:47-95) — at matmul-bound dims.  Prepares one cavity
photon: dressed |g,1> from the dressed vacuum.

The full-scale job spec lives at examples/jobs/transmon_cavity.json
(regenerate with examples/jobs/make_transmon_cavity.py); this script runs
the same system with a shorter iteration budget.

Run:  python examples/04_transmon_cavity.py
"""

import numpy as np

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
_sys.path.insert(0, _os.path.join(
    _os.path.dirname(_os.path.abspath(__file__)), "jobs"))

import qoc_tpu as q
from make_transmon_cavity import MAXA, STEPS, TOTAL_TIME, build_system


def main():
    H0, Hops, Hnames = build_system()
    dim = len(H0)
    print("dim:", dim)

    # dressed-state bookkeeping (grape_functions.py:9-24 semantics)
    w_c, v_c, dressed_id = q.get_dressed_info(H0)
    dressed_info = {
        "eigenvectors": v_c,
        "eigenvalues": np.real(w_c),
        "dressed_id": dressed_id,
        "is_dressed": True,
    }
    psi0 = v_c[:, q.get_state_index(0, dressed_id)]
    target = v_c[:, q.get_state_index(1, dressed_id)]

    uks, Uf = q.Grape(
        H0, Hops, Hnames, [target], TOTAL_TIME, STEPS, [psi0],
        state_transfer=True,
        dressed_info=dressed_info,
        reg_coeffs={
            "dwdt": 0.0001,
            "bandpass": 0.1, "band": [0.1, 10.0],
            "speed_up": 0.0001,
        },
        convergence={"rate": 0.02, "update_step": 200,
                     "max_iterations": 2000, "conv_target": 1e-5},
        maxA=[MAXA] * 4,
        seed=0,
        method="Adam",
        show_plots=False,
        save=False,
    )
    print("pulse shape:", np.shape(uks))


if __name__ == "__main__":
    main()
