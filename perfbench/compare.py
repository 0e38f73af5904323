"""The numbers that decide ``correct``, each the program's distance from the
reference, and the verdict against the cell's limits.

Training (``train_numbers``), over the first steps:

- ``loss``: the largest relative gap of a step's loss;
- ``grad``: the first gradient as the optimizer took it (clipped), by its
  worst leaf: the gap between the program's and the reference's norm of
  the leaf, over the larger of the reference's norm of that leaf and the
  median leaf's;
- ``change``: the parameters' change over the steps, by the same measure.
  Leaves whose reference gradient is under a thousandth of the median
  leaf's move under Adam by round-off alone and are left out of it.

A leaf left unmoved on one side, or moved double, reads about 1.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

ROUNDOFF_GRAD = 1e-3  # of the median leaf's gradient norm


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], leaves):
    """(the largest gap over ``leaves``, its leaf)."""
    med = statistics.median(ref[k] for k in leaves)
    worst = (0.0, "")
    for k in leaves:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if not math.isfinite(gap):
            return math.inf, k
        worst = max(worst, (gap, k))
    return worst


def train_numbers(losses: List[float], grads: Dict[str, float], change: Dict[str, float],
                  ref: dict, leaves: Optional[dict] = None) -> Dict[str, float]:
    """The three numbers; ``leaves``, where given, gets the worst leaf of
    ``grad`` and ``change``."""
    loss = max((abs(a - b) / abs(b) if math.isfinite(a) else math.inf)
               for a, b in zip(losses, ref["losses"]))
    rg = ref["grad_norms"]
    med = statistics.median(rg.values())
    moving = [k for k in rg if rg[k] >= ROUNDOFF_GRAD * med]
    grad, grad_leaf = worst_leaf(grads, rg, list(rg))
    chg, chg_leaf = worst_leaf(change, ref["change_norms"], moving)
    if leaves is not None:
        leaves.update(grad=grad_leaf, change=chg_leaf)
    return {"loss": loss, "grad": grad, "change": chg}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number is finite and within its limit."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
