"""zarc-map at a CPU size: a sound run is correct and its TF32 control
is not; with the timed path broken underneath (the L-BFGS, the polish,
the objective) ``correct`` comes out false."""

import torch

from bayes_drt_tpu_torch.infer.map import MapResult
from bayes_drt_tpu_torch.parallel import batch
from portbench.tests import cpu_cells

W = "zarc-map"


def test_sound_run_and_control():
    out, verdict, ctl = cpu_cells.fit(W, control=True)
    assert out["correct"], cpu_cells.failing(verdict)
    assert cpu_cells.failing(ctl), ctl


def test_state_unchanged(monkeypatch):
    def unchanged(value_and_grad, x0, *args, **kw):
        rows = torch.arange(x0.shape[0])
        try:
            v, g = value_and_grad(x0, rows)
        except TypeError:
            v, g = value_and_grad(x0)
        n = torch.zeros(x0.shape[0], dtype=torch.int32)
        return MapResult(x0.clone(), v, g.abs().amax(dim=1), n,
                         torch.zeros_like(n, dtype=torch.bool))

    monkeypatch.setattr(batch, "run_lbfgs", unchanged)
    monkeypatch.setattr(batch, "newton_polish",
                        lambda vg, hess, x0, **kw: unchanged(vg, x0))
    out, verdict, _ = cpu_cells.fit(W)
    assert not out["correct"]
    assert "grad_med" in cpu_cells.failing(verdict)


def test_half_the_batch_left_out(monkeypatch):
    orig = batch.MapObjective.value_and_grad

    def vg(self, q, rows=None):
        v, g = orig(self, q, rows)
        h = v.shape[0] // 2
        return (torch.cat([v[:h], v[:h].mean().expand(v.shape[0] - h)]),
                torch.cat([g[:h], g[:h].mean(0, keepdim=True).expand_as(
                    g[h:])]))

    monkeypatch.setattr(batch.MapObjective, "value_and_grad", vg)
    out, verdict, _ = cpu_cells.fit(W)
    assert not out["correct"]
    assert "value_gap" in cpu_cells.failing(verdict)


def test_answer_altered(monkeypatch):
    orig = batch.newton_polish

    def polish(*args, **kw):
        res = orig(*args, **kw)
        value = res.value.clone()
        value[0] += 1.0
        return res._replace(value=value)

    monkeypatch.setattr(batch, "newton_polish", polish)
    out, verdict, _ = cpu_cells.fit(W)
    assert not out["correct"]
    assert "value_gap" in cpu_cells.failing(verdict)


def test_coefficients_altered(monkeypatch):
    orig = batch._map_result

    def result(*args, **kw):
        res = orig(*args, **kw)
        coef = res.coef.copy()
        coef[0] *= 1.01
        return res._replace(coef=coef)

    monkeypatch.setattr(batch, "_map_result", result)
    out, verdict, _ = cpu_cells.fit(W)
    assert not out["correct"]
    assert "coef_gap" in cpu_cells.failing(verdict)
