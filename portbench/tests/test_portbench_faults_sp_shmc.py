"""sp-shmc at a CPU size with the timed path broken underneath (the
generic sampler's trajectory: on the card a CUDA graph of autograd
leaves, here the same trajectory eagerly): ``correct`` comes out
false."""

import torch

from bayes_drt_tpu_torch.infer import chees
from portbench.tests import cpu_cells

W = "sp-shmc"


def test_state_unchanged(monkeypatch):
    def traj(vg, n_leap, max_e, q, p0, grad, logp, *rest, **kw):
        z = torch.zeros_like(logp)
        return q, logp, grad, z, z, torch.zeros_like(logp, dtype=torch.bool)

    monkeypatch.setattr(chees, "shmc_trajectory", traj)
    out, verdict, _ = cpu_cells.fit(W)
    assert not out["correct"]
    assert "drt_rmse" in cpu_cells.failing(verdict)


def test_half_the_batch_left_out(monkeypatch):
    orig = chees.shmc_trajectory

    def traj(*args, **kw):
        out = list(orig(*args, **kw))
        h = out[0].shape[0] // 2
        for i, o in enumerate(out):
            m = o[:h].to(torch.float64).mean(0, keepdim=True)
            out[i] = torch.cat([o[:h], (m > 0.5 if o.dtype == torch.bool
                                        else m.to(o.dtype)).expand_as(o[h:])])
        return tuple(out)

    monkeypatch.setattr(chees, "shmc_trajectory", traj)
    out, verdict, _ = cpu_cells.fit(W)
    assert not out["correct"]
    assert "logp_gap" in cpu_cells.failing(verdict)


def test_answer_altered(monkeypatch):
    orig = chees.shmc_trajectory

    def traj(*args, **kw):
        out = list(orig(*args, **kw))
        out[1] = out[1].clone()
        out[1][0] += 1.0
        return tuple(out)

    monkeypatch.setattr(chees, "shmc_trajectory", traj)
    out, verdict, _ = cpu_cells.fit(W)
    assert not out["correct"]
    assert "logp_gap" in cpu_cells.failing(verdict)
