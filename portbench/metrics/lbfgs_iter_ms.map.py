"""Milliseconds an L-BFGS iteration: ``phase_s['lbfgs']`` over the batch's
largest L-BFGS iteration count (``n_iter_lbfgs``), the mean over the
window's fits that recorded spans outside the profiler."""

import numpy as np


def read(ctx):
    if ctx.mode != "optimize":
        return None
    v = []
    for f in ctx.spans():
        d = f.diagnostics
        if "lbfgs" not in d.get("phase_s", {}):
            continue
        v.append(1e3 * d["phase_s"]["lbfgs"]
                 / max(1.0, float(np.max(d["n_iter_lbfgs"]))))
    return sum(v) / len(v) if v else None
