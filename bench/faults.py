"""Faults planted under the timed path, to show that the comparison catches
them (``tests/test_bench_correct.py`` at a CPU size; ``calibrate.py
--fault`` at a cell's own size on the card). Each takes a
``pytest.MonkeyPatch`` and the configuration's entry (``service``) and
breaks the program underneath the benchmark:

* ``step_unchanged``: a step of the padded engine's loop that returns its
  state unchanged;
* ``answer_altered``: the first answer of each batch ×1.01 where it is
  produced;
* ``half_dropped``: half of each flush's answers left out;
* ``small_nu_altered``: the answers to the requests of the smallest ν
  (under 2.15e-3, the lowest stratum of the service cells) ×1.01 as the
  service hands them out, every other answer untouched.
"""

from __future__ import annotations

import dataclasses

SMALL_NU = 2.15e-3


def step_unchanged(mp, entry: str) -> None:
    from repro_torch.core import adaptive_padded

    mp.setattr(adaptive_padded, "_trip", lambda q, pre, st, hvp, **kw: st)


def answer_altered(mp, entry: str) -> None:
    from repro_torch.core import adaptive_padded

    finalize = adaptive_padded._finalize

    def altered(*args, **kw):
        x, stats = finalize(*args, **kw)
        x = x.clone()
        x[0] *= 1.01
        return x, stats

    mp.setattr(adaptive_padded, "_finalize", altered)


def half_dropped(mp, entry: str) -> None:
    from repro_torch.serve import solver_service

    flush = solver_service.SolverService.flush

    def halved(self, *args, **kw):
        out = flush(self, *args, **kw)
        return {k: v for i, (k, v) in enumerate(sorted(out.items())) if i % 2 == 0}

    mp.setattr(solver_service.SolverService, "flush", halved)


def small_nu_altered(mp, entry: str) -> None:
    from repro_torch.serve import solver_service

    cls = solver_service.SolverService
    submit, flush = cls.submit, cls.flush
    small = set()

    def noted(self, A, y, nu, *args, **kw):
        rid = submit(self, A, y, nu, *args, **kw)
        if nu < SMALL_NU:
            small.add(rid)
        return rid

    def altered(self, *args, **kw):
        out = flush(self, *args, **kw)
        return {k: dataclasses.replace(v, x=v.x * 1.01) if k in small else v
                for k, v in out.items()}

    mp.setattr(cls, "submit", noted)
    mp.setattr(cls, "flush", altered)


FAULTS = {f.__name__: f for f in (step_unchanged, answer_altered, half_dropped,
                                  small_nu_altered)}
