"""The comparison that decides `correct`: the program's first training steps
against the plain reference's, number by number, each against its limit.

Numbers (each the worst case, so larger is worse):

  loss_gap    max over the steps of |loss - ref| / |ref|
  grad_gap    max over the leaves of | |g| - |g_ref| | / max(|g_ref|, median
              leaf's |g_ref|), the first step's gradient
  update_gap  the same over the leaves' change |p - p0| after the last step,
              leaving out leaves whose reference gradient is under a
              thousandth of the median leaf's (Adam moves those by round-off)
  eval_gap    max over the epochs and the train / val / test masks of the
              difference in correctly classified nodes

The cell's workload file gives the limits (`limits`); a number it gives no
limit is read and printed but not compared (`PERF.md` says why).
"""

from __future__ import annotations

import math
import statistics

NUMBERS = ("loss_gap", "grad_gap", "update_gap", "eval_gap")
QUIET_GRADIENT = 1e-3  # of the median leaf's reference gradient


def _leaf_gap(prog: dict, ref: dict, leaves) -> float:
    floor = statistics.median(ref[n] for n in leaves)
    return max(abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30) for n in leaves)


def detail(prog: dict, ref: dict) -> dict:
    """Each step's loss gap and each leaf's gradient and change gap, for a
    look at what drives the numbers."""
    leaves = sorted(ref["grad_norms"])

    def per_leaf(key):
        floor = statistics.median(ref[key][n] for n in leaves)
        return {n: abs(prog[key][n] - ref[key][n]) / max(ref[key][n], floor, 1e-30)
                for n in leaves}

    return {"loss_steps": [abs(a - b) / max(abs(b), 1e-30)
                           for a, b in zip(prog["losses"], ref["losses"])],
            "grad_leaves": per_leaf("grad_norms"), "change_leaves": per_leaf("changes")}


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers compared, from `Program.follow`'s and the reference's
    `follow`'s readings."""
    if set(prog["grad_norms"]) != set(ref["grad_norms"]):
        raise ValueError(f"leaves differ: {sorted(prog['grad_norms'])} against "
                         f"{sorted(ref['grad_norms'])}")
    leaves = sorted(ref["grad_norms"])
    median_grad = statistics.median(ref["grad_norms"][n] for n in leaves)
    moving = [n for n in leaves if ref["grad_norms"][n] >= QUIET_GRADIENT * median_grad]
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"]))
    evals = max(abs(a - b) for pa, ra in zip(prog["correct"], ref["correct"])
                for a, b in zip(pa, ra))
    out = {"loss_gap": loss,
           "grad_gap": _leaf_gap(prog["grad_norms"], ref["grad_norms"], leaves),
           "update_gap": _leaf_gap(prog["changes"], ref["changes"], moving),
           "eval_gap": float(evals)}
    if len(prog["losses"]) != len(ref["losses"]) or not all(map(math.isfinite, prog["losses"])):
        out["loss_gap"] = math.inf
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that `limits`
    names: correct where each is finite and within its limit."""
    unknown = set(limits) - set(NUMBERS)
    if unknown or not limits:
        raise ValueError(f"limits must name some of {NUMBERS}, got {sorted(limits)}")
    table = {n: {"value": numbers[n], "limit": limits[n]} for n in NUMBERS if n in limits}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in table.values())
    return ok, table
