"""The whole fit's share of the float32 peak: the posterior-gradient
FLOPs that the cell's leapfrog steps need, over a fit's wall time, in %.

The count is the work these inputs need, whatever code computes it: rows
(spectra x chains) x leaves (warm_steps a warmup draw, n_steps a sampling
draw) x FLOPs a gradient. A gradient of a distribution with K basis
functions on n frequencies is its forward and backward products with A
(2n x K) and the three L (K x K): 2 (2 (2n) K + 6 K^2) FLOPs (2 x 93,930
for the ZARC series model's n=81, K=101), summed over distributions.
The wall time is the mean of the window's plain fits (timing=False, no
profiler: called as the end-to-end run calls them), so this is the
cell's rate in other units; it stays beside ``k1_roofline`` so that a
gain claimed for K1 is still bounded once K1 is fused away."""

from portbench import peaks


def flops_per_gradient(n, Ks):
    return sum(2.0 * (2 * (2 * n) * K + 6 * K * K) for K in Ks)


def read(ctx):
    if ctx.mode != "sample":
        return None
    cfg, sh = ctx.cell.config, ctx.cell.traffic.get("shmc")
    if not sh:
        return None
    rows = ctx.cell.traffic["batch"] * cfg["chains"]
    leaves = ((sh.get("warm_steps") or sh["n_steps"]) * cfg["warmup"]
              + sh["n_steps"] * cfg["samples"])
    flops = rows * leaves * flops_per_gradient(ctx.shapes["n"],
                                               ctx.shapes["K"])
    walls = [f.end - f.start for f in ctx.plain()]
    if not walls:
        return None
    return 100.0 * flops / (sum(walls) / len(walls)) / peaks.FP32_FLOPS
