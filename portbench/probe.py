"""Read-only taps on what the timed path produces, for the checks.

The checks read a fit's public outputs wherever the entry returns them:
the last draw's states (``diagnostics['state_q']``), the posterior means
and bands, the MAP coefficients. Two things it does not return, and the
probe keeps them:

- the log density and gradient that the last draw's trajectory (the K1
  kernel, or the generic sampler's graphed autograd trajectory) computed
  at those states: ``run_shmc`` (``infer/chees.py``, also bound in
  ``infer/shmc_flat.py``), the adaptation loop of both SHMC samplers, has
  its ``traj`` argument wrapped, and after the loop the last
  trajectory's (q, logp, grad) are kept, cloned on the device (no host
  synchronization);
- the MAP optimum's unconstrained rows and objective: ``_map_result``
  (``parallel/batch.py``), which turns them into the result, is wrapped
  and its ``MapResult`` (params, value) kept.

Where a fit's diagnostics carry ``state_logp`` and ``state_grad`` (at
``state_q``), or ``map_params`` and ``map_value``, the checks read those
instead and need no tap (``compare.py``): the program can offer them as
a documented hook and then move or rename these two functions freely.

``Probe.take`` hands over what one fit left and clears it."""

from __future__ import annotations


class Probe:
    def __init__(self):
        self.sampled = []
        self.optima = []
        self._undo = []

    def install(self):
        from bayes_drt_tpu_torch.infer import chees, shmc_flat
        from bayes_drt_tpu_torch.parallel import batch
        run_shmc = chees.run_shmc
        map_result = batch._map_result

        def tapped_run_shmc(value_and_grad, traj, *args, **kw):
            last = []

            def tap(*targs):
                out = traj(*targs)
                last[:] = [out]
                return out

            res = run_shmc(value_and_grad, tap, *args, **kw)
            if last:
                q, logp, grad = last[0][:3]
                self.sampled.append((q.clone(), logp.clone(), grad.clone()))
            return res

        def tapped_map_result(cfg, data, res, *args, **kw):
            self.optima.append((res.params, res.value))
            return map_result(cfg, data, res, *args, **kw)

        for mod, name, new in ((chees, "run_shmc", tapped_run_shmc),
                               (shmc_flat, "run_shmc", tapped_run_shmc),
                               (batch, "_map_result", tapped_map_result)):
            self._undo.append((mod, name, getattr(mod, name)))
            setattr(mod, name, new)
        return self

    def uninstall(self):
        for mod, name, old in reversed(self._undo):
            setattr(mod, name, old)
        self._undo = []

    def take(self):
        out = {"sampled": self.sampled, "optima": self.optima}
        self.sampled, self.optima = [], []
        return out
