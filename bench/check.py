"""What every comparison that decides ``correct`` shares.

A configuration names its comparison (``check.module``): the file
``bench/checks/<module>.py``, with ``compare(pool, answers, attempted,
spec)``, which returns a ``Verdict``, and ``control(pool, answers)``, which
puts the control in the program's place. ``numbers`` gives the two numbers
that every kind of answer has:

* ``missing_answers``: requests submitted that got no answer (limit 0);
* ``uncertified_share``: the share of answers that the program did not
  certify (a dense fallback's answer may be right, but it is not what the
  timed path is for: a loop that stopped working shows here).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Answer:
    index: int             # the problem's index in the pool
    x: torch.Tensor        # the answer, in the request's coordinates
    certified: bool        # the program certified it (status OK or RETRIED)
    window: bool = True    # answered in the measured window, not in the traced slice


@dataclasses.dataclass
class Verdict:
    numbers: dict          # name -> (value, limit)
    correct: bool
    passed: list           # per answer: within its limit

    def certified_correct(self, answers) -> int:
        """Answers of the measured window, certified and within their limit."""
        return sum(1 for a, ok in zip(answers, self.passed) if ok and a.certified and a.window)


def numbers(answers, attempted: int, limits: dict) -> dict:
    """``missing_answers`` and ``uncertified_share``, each with its limit."""
    uncertified = sum(1 for a in answers if not a.certified) / max(len(answers), 1)
    return {"missing_answers": (attempted - len(answers), int(limits["missing_answers"])),
            "uncertified_share": (uncertified, float(limits["uncertified_share"]))}


def verdict(answers, numbers: dict, passed: list) -> Verdict:
    """Correct when there are answers and every number is within its limit."""
    correct = bool(answers) and all(v <= lim for v, lim in numbers.values())
    return Verdict(numbers=numbers, correct=correct, passed=passed)
