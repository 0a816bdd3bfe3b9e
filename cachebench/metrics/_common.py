"""Helpers the readers share."""
from __future__ import annotations

import statistics


def stage_mean_ms(batches, names, only_misses: bool = False):
    """Mean over batches of the summed stage seconds ``names``, in ms."""
    xs = [sum(b.stages.get(n, 0.0) for n in names) for b in batches
          if b.stages and (b.generated or not only_misses)]
    return statistics.fmean(xs) * 1e3 if xs else None


def deploy(view):
    return view.cell.config["model"], view.cell.config["deploy"]
