"""On the card, at each cell's own size: a fit of three seeds is correct,
and its control (the reference at TF32 in the program's place) fails at
least one number of the cell. Each run is one fit in the window and no
warm-up."""

import pytest

from portbench import core

CELLS = ("zarc-shmc", "sp-shmc", "zarc-map")
SEEDS = (2 ** 32 + 101, 2 ** 32 + 202, 2 ** 32 + 303)


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", CELLS)
def test_cell_and_control_on_the_card(card, workload, seed):
    out, verdict, ctl = core.run(workload, seed, 0.0, 0, control=True,
                                 warm=False)
    cell = core.load_cell(workload)
    for line in (core.check_lines(verdict, cell.limits)
                 + core.check_lines(ctl, cell.limits, "control")):
        print(f"[{workload} {seed}] {line}")
    assert out["correct"], [k for k, v in verdict.items() if not v[2]]
    assert any(not v[2] for v in ctl.values())
