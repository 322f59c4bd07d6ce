"""sp-shmc at a CPU size: a sound run is correct and its TF32 control is
not. The faults are in test_portbench_faults_sp_shmc.py."""

from portbench.tests import cpu_cells


def test_sound_run_and_control():
    out, verdict, ctl = cpu_cells.fit("sp-shmc", control=True)
    assert out["correct"], cpu_cells.failing(verdict)
    assert cpu_cells.failing(ctl), ctl
