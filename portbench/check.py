"""The comparison that decides ``correct``.

After the window has closed, the device's peak read and the program's
state freed, the plain reference that the configuration names
(``reference/<reference>.py``) works out again the sampled answers from
the inputs the driver made from the seed, and the answers the timed path
produced are compared with them exactly.  A reference has
``expected(inputs, queries)`` and ``control(inputs, queries)``, each a
list of arrays [..., answer] a query.  Every number compared has its
limit:

- ``share_mismatches``: sampled answers that differ from the reference
  in any byte; at most 0 (the comparison is exact).
- ``answers_missing``: sampled answers that never came whole, and the
  answers of requests that failed; at most 0.
- ``answers_compared``: sampled answers compared; at least the traffic's
  ``min_compared``, so that a run cannot pass by comparing nothing.

The control (``control=True``) puts the reference's ``control`` in the
program's place: the reference with one guarantee of the configuration
broken.  It has to fail.
"""

from __future__ import annotations

import importlib

import numpy as np

from portbench.generator import MODULE

__all__ = ["compare", "limits_hold", "load_reference"]


def load_reference(name: str):
    """The module ``reference/<name>.py``."""
    if not MODULE.match(name):
        raise ValueError(f"reference name {name!r} is not a module name")
    return importlib.import_module(f"portbench.reference.{name}")


def compare(cell, samples: list, failed: int, min_compared: int,
            control: bool = False) -> dict:
    """The numbers compared, each with its limit, for the samples of a
    finished window (``generator.Sample``; ``got`` on the host)."""
    whole = [s for s in samples if s.got is not None]
    missing = sum(s.answers for s in samples if s.got is None) \
        + failed * cell.evals_per_request
    mismatches = compared = 0
    if whole:
        ref = load_reference(cell.config["reference"])
        queries = [s.query for s in whole]
        want = ref.expected(cell.inputs, queries)
        got = (ref.control(cell.inputs, queries) if control
               else [np.asarray(s.got) for s in whole])
        for w, g in zip(want, got):
            w = w.reshape(-1, w.shape[-1])
            if g.size != w.size:
                mismatches += len(w)
            else:
                mismatches += int(np.count_nonzero(
                    (g.reshape(w.shape) != w).any(axis=1)))
            compared += len(w)
    return {
        "share_mismatches": {"value": mismatches, "max": 0},
        "answers_missing": {"value": int(missing), "max": 0},
        "answers_compared": {"value": compared, "min": int(min_compared)},
    }


def limits_hold(checks: dict) -> bool:
    """Whether every number lies within its limit."""
    return all(("max" not in c or c["value"] <= c["max"])
               and ("min" not in c or c["value"] >= c["min"])
               for c in checks.values())
