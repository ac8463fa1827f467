"""The comparison that decides ``correct``.

Both sides hand over the same readings of the first steps of training (see
``TrainEntry.setup`` in ``entries/train.py``): each step's losses, each leaf's gradient norm as
the optimizer took it after the first step (Adam's first moment), each
leaf's change after the last probed step, and the predictions where the step
makes them.  The numbers compared:

- ``loss_gap``: the largest ``|l - l_ref| / |l_ref|`` over the steps' losses;
  ``first_loss_gap`` the same of the first step's first loss, which no update
  has touched yet;
- ``grad_gap``: the largest ``|n - n_ref| / max(n_ref, median_ref)`` over the
  leaves, ``n`` a leaf's norm and ``median_ref`` the median leaf's norm in
  the reference, per network;
- ``delta_gap``: the same over the leaves' changes, leaving out the leaves
  whose reference gradient is under a thousandth of the median leaf's: they
  move by round-off alone; ``grad_gap_median`` and ``delta_gap_median`` the
  median leaf's gap;
- ``pred_mismatch``: the share of real utterances whose predicted class
  differs.

A number is compared where the configuration gives it a limit; the others are
reported.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Mapping, Sequence

ROUND_OFF = 1e-3  # a leaf whose reference gradient is under this share of the median's


def _norm_gaps(got: Sequence[float], want: Sequence[float], groups: Sequence[str],
               keep: Sequence[bool]) -> List[float]:
    medians: Dict[str, float] = {}
    for g in set(groups):
        medians[g] = statistics.median(w for w, gg in zip(want, groups) if gg == g)
    return [abs(n - w) / max(w, medians[g], 1e-30)
            for n, w, g, k in zip(got, want, groups, keep) if k]


def readings(prog: Mapping, ref: Mapping) -> Dict[str, float]:
    groups = ref["groups"]
    medians = {g: statistics.median(w for w, gg in zip(ref["grad"], groups) if gg == g)
               for g in set(groups)}
    moved = [w >= ROUND_OFF * medians[g] for w, g in zip(ref["grad"], groups)]
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for pa, pb in zip(prog["losses"], ref["losses"]) for a, b in zip(pa, pb))
    grad = _norm_gaps(prog["grad"], ref["grad"], groups, [True] * len(groups))
    delta = _norm_gaps(prog["delta"], ref["delta"], groups, moved)
    first, first_ref = prog["losses"][0][0], ref["losses"][0][0]
    out = {
        "loss_gap": loss_gap,
        "first_loss_gap": abs(first - first_ref) / max(abs(first_ref), 1e-30),
        "grad_gap": max(grad),
        "grad_gap_median": statistics.median(grad),
        "delta_gap": max(delta),
        "delta_gap_median": statistics.median(delta),
    }
    if prog.get("preds") is not None and ref.get("preds") is not None:
        total = differ = 0
        for p, r, m in zip(prog["preds"], ref["preds"], ref["pred_masks"]):
            total += sum(m)
            differ += sum(1 for a, b, k in zip(p, r, m) if k and a != b)
        out["pred_mismatch"] = differ / max(total, 1)
    return out


def judge(values: Mapping[str, float], limits: Mapping[str, float]) -> List[dict]:
    """Each reading with its limit (None where it is not compared) and whether it passed."""
    out = []
    for name, value in values.items():
        limit = limits.get(name)
        ok = limit is None or (value == value and value <= limit)
        out.append({"name": name, "value": value, "limit": limit, "ok": ok})
    return out
