"""Generic greedy local search (hillclimbing) with a recorded trajectory
(counterpart of ``repro.core.localsearch``, copied: it is pure Python).

The accept/reject loop that ``repro.launch.hillclimb`` runs by hand over
dry-run cells — propose a neighbor, evaluate, keep it iff it scores better —
generalized into a reusable engine: ``tune_cluster`` climbs fleet-count
vectors with it, and any future co-design search (format mixes, slot plans)
can reuse it instead of re-rolling the loop.

Kept deliberately tiny and deterministic:

  * **Best-improvement** steps: every neighbor of the current state is
    scored each round and the best strictly-improving one is taken; the
    search stops at the first local optimum (or ``max_iters``).
  * Scores are compared with ``>`` — floats and tuples both work (use
    tuples for lexicographic objectives, e.g. ``(throughput, -power)``).
  * ``score`` returning ``None`` marks a state infeasible; infeasible
    states are never stepped to (the initial state must be feasible).
  * States are memoized by ``key`` (default ``repr``) so re-visited
    neighbors cost nothing — the analogue of the dry-run launcher skipping
    cells already in its results file.

It lives in ``core``, as in the JAX package, apart from the launcher
(which mutates ``XLA_FLAGS`` at import time).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, TypeVar

S = TypeVar("S")


@dataclasses.dataclass
class SearchResult:
    """Outcome of one ``hillclimb`` run."""

    best: object
    best_score: object
    #: one row per evaluated state: dict(state=, score=, accepted=, iter=)
    trajectory: List[Dict[str, object]]
    evaluations: int
    iterations: int
    converged: bool  # stopped at a local optimum (not the iteration cap)


def hillclimb(init: S,
              neighbors: Callable[[S], Iterable[S]],
              score: Callable[[S], Optional[object]],
              *,
              max_iters: int = 100,
              key: Callable[[S], object] = repr) -> SearchResult:
    """Greedy best-improvement local search from ``init``.

    ``neighbors(state)`` yields candidate successor states;
    ``score(state)`` returns a comparable value (higher is better) or
    ``None`` for infeasible states.  Returns the best state found with the
    full evaluation trajectory.  Raises ``ValueError`` if ``init`` itself
    is infeasible — the caller picked a bad anchor, and silently returning
    it would look like a converged search.
    """
    memo: Dict[object, Optional[object]] = {}
    trajectory: List[Dict[str, object]] = []
    evals = 0

    def evaluate(state: S, it: int) -> Optional[object]:
        nonlocal evals
        k = key(state)
        if k in memo:
            return memo[k]
        s = score(state)
        evals += 1
        memo[k] = s
        trajectory.append(dict(state=state, score=s, iter=it,
                               accepted=False))
        return s

    best, best_score = init, evaluate(init, 0)
    if best_score is None:
        raise ValueError(f"infeasible initial state: {init!r}")
    trajectory[-1]["accepted"] = True
    converged = False
    it = 0
    for it in range(1, max_iters + 1):
        step_best, step_score = None, None
        for cand in neighbors(best):
            s = evaluate(cand, it)
            if s is None:
                continue
            if step_score is None or s > step_score:
                step_best, step_score = cand, s
        if step_score is None or not step_score > best_score:
            converged = True  # local optimum
            break
        best, best_score = step_best, step_score
        for row in reversed(trajectory):
            if key(row["state"]) == key(best):
                row["accepted"] = True
                break
    return SearchResult(best=best, best_score=best_score,
                        trajectory=trajectory, evaluations=evals,
                        iterations=it, converged=converged)
