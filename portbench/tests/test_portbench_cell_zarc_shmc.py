"""zarc-shmc at a CPU size: a sound run is correct and its TF32 control
is not; with the timed path broken underneath (the trajectory that K1
computes on the card, its plain form here) ``correct`` comes out false.
The escalation refit is off here (a NUTS md8 refit takes minutes on the
CPU); ``test_escalated_number`` holds the number that catches a sampler
whose every spectrum the refit has to redo."""

import numpy as np
import torch

from bayes_drt_tpu_torch.infer import shmc_flat
from portbench import compare
from portbench.tests import cpu_cells

W = "zarc-shmc"


def run(control=False):
    return cpu_cells.fit(W, control=control, escalate=False)


def test_sound_run_and_control():
    out, verdict, ctl = run(control=True)
    assert out["correct"], cpu_cells.failing(verdict)
    assert cpu_cells.failing(ctl), ctl


def test_state_unchanged(monkeypatch):
    def traj(spec, n_leap, max_e, shared, q, p0, grad, logp, *rest):
        z = torch.zeros_like(logp)
        return q, logp, grad, z, z, torch.zeros_like(logp, dtype=torch.bool)

    monkeypatch.setattr(shmc_flat, "traj_fused", traj)
    out, verdict, _ = run()
    assert not out["correct"]
    assert "rmse" in cpu_cells.failing(verdict)


def test_half_the_batch_left_out(monkeypatch):
    orig = shmc_flat.traj_fused

    def traj(*args):
        out = list(orig(*args))
        h = out[0].shape[0] // 2
        for i, o in enumerate(out):
            m = o[:h].to(torch.float64).mean(0, keepdim=True)
            out[i] = torch.cat([o[:h], (m > 0.5 if o.dtype == torch.bool
                                        else m.to(o.dtype)).expand_as(o[h:])])
        return tuple(out)

    monkeypatch.setattr(shmc_flat, "traj_fused", traj)
    out, verdict, _ = run()
    assert not out["correct"]
    assert "logp_gap" in cpu_cells.failing(verdict)


def test_answer_altered(monkeypatch):
    orig = shmc_flat.traj_fused

    def traj(*args):
        out = list(orig(*args))
        out[1] = out[1].clone()
        out[1][0] += 1.0
        return tuple(out)

    monkeypatch.setattr(shmc_flat, "traj_fused", traj)
    out, verdict, _ = run()
    assert not out["correct"]
    assert "logp_gap" in cpu_cells.failing(verdict)


def test_escalated_number():
    class R:
        diagnostics = {"escalated": np.ones(8, bool)}

    fit = compare.Fit(np.zeros((8, 3)), R(), {}, 4, {})
    assert compare.escalated(fit, None) == 100.0
    R.diagnostics = {"escalated": np.zeros(8, bool)}
    assert compare.escalated(fit, None) == 0.0


def test_last_draw_reads_the_entry_before_the_probe():
    """The last draw's states come from ``state_q``; its log density and
    gradient from ``state_logp``/``state_grad`` where the entry returns
    them, else from the probe, on the spectra that were not refitted."""
    b, c, d = 3, 2, 4
    sq = np.arange(b * c * d, dtype=np.float32).reshape(b, c, d)
    lp = torch.arange(8, dtype=torch.float32)        # padded rows
    g = torch.ones(8, d)

    class R:
        diagnostics = {"state_q": sq,
                       "escalated": np.array([False, True, False])}

    fit = compare.Fit(np.zeros((b, 5)), R(), {"sampled": [(None, lp, g)]},
                      c, {})
    q, lp_got, _, spec = compare._last_draw(fit)
    assert spec.tolist() == [0, 0, 2, 2]
    assert lp_got.tolist() == [0.0, 1.0, 4.0, 5.0]
    np.testing.assert_array_equal(q.numpy(), sq[[0, 0, 2, 2], [0, 1, 0, 1]])

    R.diagnostics = dict(R.diagnostics, state_logp=-np.ones((b, c)),
                         state_grad=np.zeros((b, c, d)))
    fit = compare.Fit(np.zeros((b, 5)), R(), {"sampled": []}, c, {})
    q, lp_got, g_got, spec = compare._last_draw(fit)
    assert spec.tolist() == [0, 0, 1, 1, 2, 2]
    assert lp_got.tolist() == [-1.0] * 6 and not g_got.any()
    assert compare.state_match(fit, None) == 0.0
