"""The cells at sizes a CPU test run can hold: every configuration and
traffic setting as the cell has it, a batch of a few spectra and one
batch in the pool; no warm-up fit and one fit in the window. The
sampling cells take 8 spectra, the entry's smallest padded batch, so
that, as at the cells' own sizes, every row of the sampler is a real
spectrum that the checks read."""

import json

import torch

from portbench import core

SIZES = {"zarc-shmc": 8, "sp-shmc": 8, "zarc-map": 4}
SEED = 2 ** 33 + 4242


def fit(workload, seed=SEED, control=False, **traffic):
    """(result line, {number: (worst, limit, passed)}, the control's);
    ``traffic`` overrides further keys of the cell's traffic."""
    torch.set_num_threads(1)
    return core.run(workload, seed, 0.0, 0, device="cpu", control=control,
                    warm=False,
                    override={"traffic": {"batch": SIZES[workload],
                                          "pool": 1, **traffic}})


def failing(verdict):
    """Names of the numbers outside their limits."""
    return sorted(k for k, v in verdict.items() if not v[2])


def load_config(name):
    """The configuration file ``configs/<name>.json``."""
    return json.loads((core.HERE / "configs" / f"{name}.json").read_text())
