"""The reference's side of the check: column tasks on worker processes,
and the gap between a judged number and the reference's.

A task is one column for a year (the ensemble's annual totals) or one
cell's members through an assimilation window; ``run_tasks`` runs them on
``spawn`` workers, each importing only this module and ``oracle``, and
stops and waits for every worker before it returns.  Nothing here imports
the program.
"""

from __future__ import annotations

import math
import multiprocessing
import os

import numpy as np

from . import oracle


def _year(task: dict, M) -> dict:
    """Annual totals of one member-cell: ``task["column"]`` is its
    parameters (the member's multipliers applied) and its start state,
    ``task["forcing"]`` its days."""
    geo = oracle.Geometry(task["zi"])
    col = oracle.Column(task["column"], M)
    sums = dict(evap=0.0, runoff=0.0, npp=0.0)
    for f in task["forcing"]:
        day = oracle.run_day(col, f, geo, task["nisurf"], task["zd09_every"],
                             M)
        for k in sums:
            sums[k] = sums[k] + day[k]
    return {k: float(v) for k, v in sums.items()}


def _window(task: dict, M) -> dict:
    """One cell's members through an assimilation window: each day every
    member forecasts with hksat scaled by its log-multiplier, then the
    cell's analysis.  Returns the log-multipliers' mean and spread, the
    members' end states and the members' mean predicted ET each day."""
    geo = oracle.Geometry(task["zi"])
    base_hksat = task["column"]["hksat"]
    members = [oracle.Column(task["column"], M) for _ in task["theta"]]
    theta = [M.num(t) for t in task["theta"]]
    m = len(members)
    y_mean = []
    for d, f in enumerate(task["forcing"]):
        ys = []
        for col, t in zip(members, theta):
            mult = M.exp(t)
            col.hksat = [M.num(h) * mult for h in base_hksat]
            ys.append(oracle.run_day(col, f, geo, task["nisurf"],
                                     task["zd09_every"], M)["evap"])
        y_mean.append(float(sum(ys) / m))
        theta = oracle.enkf_cell(
            members, ys, M.num(task["obs"][d]), task["mask"][d],
            task["obs_err_std"], task["rtps"], theta, task["theta_bounds"],
            geo, M)
    mean = sum(theta) / m
    std = M.sqrt(sum((t - mean) * (t - mean) for t in theta) / m)
    return dict(theta_mean=float(mean), theta_std=float(std),
                y_pred_mean=y_mean, members=[c.state() for c in members])


_TASKS = dict(year=_year, window=_window)


def run_task(task: dict) -> dict:
    """One task in the arithmetic it names; an arithmetic fault (a domain
    error, an overflow, a division by zero) is returned as ``error``."""
    M = oracle.ARITHMETIC[task["arithmetic"]]
    try:
        return _TASKS[task["kind"]](task, M)
    except (ArithmeticError, ValueError) as e:
        return dict(error=f"{type(e).__name__}: {e}")


def run_tasks(tasks: list, arithmetic: str) -> list:
    """Every task in ``arithmetic``, one worker a CPU, results in the
    tasks' order."""
    tasks = [dict(t, arithmetic=arithmetic) for t in tasks]
    processes = min(len(tasks), os.cpu_count() or 1)
    if processes <= 1:
        return [run_task(t) for t in tasks]
    ctx = multiprocessing.get_context("spawn")
    pool = ctx.Pool(processes)
    try:
        return pool.map(run_task, tasks, chunksize=1)
    finally:
        pool.close()
        pool.join()


def gap(judged, reference) -> float:
    """The widest gap between judged numbers and the reference's, each
    against the larger of its reference number's magnitude and the median
    magnitude of them all (some totals are all but zero); a judged number
    that is not finite, or a missing one, reads infinity."""
    judged = np.asarray(judged, np.float64).ravel()
    reference = np.asarray(reference, np.float64).ravel()
    if judged.shape != reference.shape or judged.size == 0:
        return math.inf
    if not np.all(np.isfinite(judged)):
        return math.inf
    scale = np.maximum(np.abs(reference), np.median(np.abs(reference)))
    scale = np.where(scale > 0.0, scale, 1.0)
    return float(np.max(np.abs(judged - reference) / scale))
