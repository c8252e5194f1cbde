"""The comparison that decides ``correct``: the program's first three
training steps against the plain reference's from the same inputs and
parameters.

Three numbers, each with its limit:

* ``loss``: the largest relative gap of the three steps' losses;
* ``grad``: over the leaves, the largest gap between the norms of the
  first gradient as the optimizer got it (decay included), over the
  larger of the reference leaf's norm and the median leaf's;
* ``change``: the same for the parameters' change after the three
  steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (the others move under Adam by
  round-off alone).
"""
import math
import statistics
import sys
from typing import Dict

import torch

LEAF_FLOOR = 1e-3


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            d.items()}


def _gap(got: float, want: float, scale: float) -> float:
    v = abs(got - want) / scale if scale > 0 else abs(got - want)
    return v if math.isfinite(v) else math.inf


def _leaf_gap(got: dict, want: dict, keep) -> float:
    g, w = _norms(got), _norms(want)
    names = [k for k in w if k in keep]
    if not names:
        return math.inf
    med = statistics.median(w[k] for k in names)
    return max(_gap(g.get(k, math.nan), w[k], max(w[k], med))
               for k in names)


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: dicts of ``losses`` (floats), ``grad1`` and
    ``change`` (leaf name -> tensor)."""
    loss = max((_gap(p, r, abs(r)) for p, r in
                zip(prog["losses"], ref["losses"])), default=math.inf)
    if len(prog["losses"]) != len(ref["losses"]):
        loss = math.inf
    grad = _leaf_gap(prog["grad1"], ref["grad1"], set(ref["grad1"]))
    gn = _norms(ref["grad1"])
    med = statistics.median(gn.values())
    moving = {k for k, v in gn.items() if v >= LEAF_FLOOR * med}
    change = _leaf_gap(prog["change"], ref["change"], moving)
    return dict(loss=loss, grad=grad, change=change)


def details(prog: dict, ref: dict) -> dict:
    """Each step's loss gap and each leaf's gradient and change gaps (the
    terms whose largest ``gaps`` reports)."""
    def leaves(key):
        g, w = _norms(prog[key]), _norms(ref[key])
        med = statistics.median(w.values())
        return {k: _gap(g[k], w[k], max(w[k], med)) for k in w}

    return dict(loss=[_gap(p, r, abs(r)) for p, r in
                      zip(prog["losses"], ref["losses"])],
                grad=leaves("grad1"), change=leaves("change"))


def judge(values: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit.  A number that is not finite reads as the largest float, so
    that the row stays valid JSON."""
    rows = {k: {"value": min(values[k], sys.float_info.max),
                "limit": limits[k]} for k in limits}
    return all(r["value"] <= r["limit"] for r in rows.values()), rows
