"""K1 (csrc/traj.cu, one launch a draw) against its float32 bound: the
kernel's device time from the trace, by name, against the larger of its
operation and byte bounds at the cell's shapes, summed over the traced
fit's launches, in %.

A launch of R rows and n_leap leapfrogs needs 2 (2n) K + 6 K^2 FMAs a row
and leaf (the forward and backward products with A and the three L) at
the fp32 CUDA-core peak, and reads and writes its rows' state once
(q, p0, grad, m_inv, targets: 4 D + 2n + 2 words a row; its outputs 2 D +
4; the per-leaf selection noise n_leap R) and the shared matrices once."""

from portbench import peaks

PATTERN = "traj_kernel"


def bound_s(n, K, D, R, n_leap):
    """(operation seconds, byte seconds) of one launch."""
    n2 = 2 * n
    fma = 2 * n2 * K + 6 * K * K
    ops_s = 2.0 * R * n_leap * fma / peaks.FP32_FLOPS
    nbytes = 4.0 * (R * (4 * D + n2 + 2) + n_leap * R + n2 * K + 3 * K * K
                    + 3 * n2 + 8 + R * (2 * D + 4))
    return ops_s, nbytes / peaks.HBM_BYTES_S


def share(summary, shapes, schedule):
    """% of the launches' summed bound in their summed device time;
    ``schedule`` the leapfrog count of each launch in order."""
    from portbench.devtrace import kernel_time
    n_launch, secs = kernel_time(summary, PATTERN)
    if n_launch == 0 or secs <= 0:
        return None
    sched = list(schedule)[:n_launch]
    sched += [sched[-1]] * (n_launch - len(sched))
    total = sum(max(bound_s(shapes["n"], shapes["K"][0], shapes["D"],
                            shapes["R"], nl)) for nl in sched)
    return 100.0 * total / secs


def read(ctx):
    if ctx.trace is None or ctx.mode != "sample":
        return None
    cfg, sh = ctx.cell.config, ctx.cell.traffic.get("shmc", {})
    if not sh:
        return None
    warm = sh.get("warm_steps") or sh["n_steps"]
    schedule = [warm] * cfg["warmup"] + [sh["n_steps"]] * cfg["samples"]
    return share(ctx.trace, ctx.shapes, schedule)
