"""How a serving run's ``correct`` is decided.

Every answer that came back in the window is judged, after the window,
against the plain reference (``vdb_bench.reference``), from the queries
drawn again from the run's seed and the database rows the benchmark drew
itself. Three numbers, each with the limit that the cell's file gives
(``checks``):

- ``missing_answers``: queries sent in the window without a whole answer
  (a request that raised, or came back with fewer rows or fewer than
  ``k`` ids); limit 0.
- ``dist_rel_err``: the largest ``|served - reference| / reference`` over
  every served distance, the reference being the float64 distance of the
  served id from its query; +inf where a served id is no row or repeats
  within its answer. It holds the rerank, the id mapping back to the
  caller's rows (``orig_row``) and the metric's scaling to the exact
  answer for the ids returned.
- ``recall_at_10``: on ``SAMPLE`` queries drawn from the seed among all
  answered ones, the share of the ``k`` served ids whose reference
  distance is within the exact ``k``-th distance (ann-benchmarks' rule,
  so a tie with the ``k``-th row counts); it holds the build, the pack,
  the scan and the shortlist to the exact answer.
- ``nn_missed``: on the same queries, the share whose exact nearest row
  is not among the served ids (a served id at the nearest distance
  counts): one minus FAISS's "1-recall@10". The scan's precision shows
  here first: a true nearest row is lost only when rounding pushes it
  below the shortlist's cut, which a lower precision does several times
  as often, while most of the losses that recall counts lie at the 8th
  to 10th place, near the cut for either precision.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vdb_bench.recipe import stream_seed
from vdb_bench.reference.knn import distances, exact_knn

SAMPLE = 8000
# a served id within this share of the exact k-th distance is a hit
TIE_REL = 1e-9


def judge(rows, metric: str, k: int, answers, query_of, limits: dict,
          seed: int) -> dict:
    """The checks of a serving window: ``{name: (value, limit, ok)}``.

    ``rows``: the benchmark's ``[n, d]`` database on the device.
    ``answers``: one entry a request, ``(ids [q, k], dist [q, k])`` as
    numpy arrays, or ``None`` for a request that raised; ``query_of(i)``
    draws request ``i``'s queries again, on the device, with the count
    that was sent."""
    dev = rows.device
    missing = 0
    worst = 0.0
    answered = []  # (request, rows of it that are whole answers)
    for i, ans in enumerate(answers):
        queries = query_of(i)
        sent = queries.shape[0]
        if ans is None:
            missing += sent
            continue
        ids, dist = ans
        if ids.ndim != 2 or ids.shape[1] != k or dist.shape != ids.shape:
            missing += sent
            continue
        got = min(sent, ids.shape[0])
        missing += sent - got
        ref = distances(rows, queries[:got], torch.as_tensor(ids[:got]),
                        metric)
        served = torch.as_tensor(dist[:got], device=dev, dtype=torch.float64)
        err = (served - ref).abs() / ref.clamp_min(1e-300)
        err = torch.where((served == ref), 0.0, err)  # 0/0 and inf == inf
        err = torch.where(torch.isnan(err) | torch.isinf(ref),
                          math.inf, err)
        worst = max(worst, float(err.max())) if err.numel() else worst
        answered.append((i, got))

    recall, nn_missed = _recall(rows, metric, k, answers, answered,
                                query_of, seed)
    out = {
        "missing_answers": (missing, limits["missing_answers"],
                            missing <= limits["missing_answers"]),
        "dist_rel_err": (worst, limits["dist_rel_err"],
                         worst <= limits["dist_rel_err"]),
        "recall_at_10": (recall, limits["recall_at_10"],
                         recall >= limits["recall_at_10"]),
        "nn_missed": (nn_missed, limits["nn_missed"],
                      nn_missed <= limits["nn_missed"]),
    }
    return out


def _recall(rows, metric, k, answers, answered, query_of, seed):
    """``(recall@k, nn_missed)`` of the served ids on a sample drawn from
    ``seed``."""
    total = sum(got for _, got in answered)
    if total == 0:
        return 0.0, 1.0
    rng = np.random.Generator(np.random.PCG64(stream_seed(seed, "sample")))
    pick = np.sort(rng.choice(total, size=min(SAMPLE, total),
                              replace=False))
    starts = np.cumsum([0] + [got for _, got in answered])
    qs, served = [], []
    for j, (i, got) in enumerate(answered):
        mine = pick[(pick >= starts[j]) & (pick < starts[j + 1])] - starts[j]
        if mine.size == 0:
            continue
        qs.append(query_of(i)[torch.as_tensor(mine, device=rows.device)])
        served.append(answers[i][0][mine])
    queries = torch.cat(qs)
    served = torch.as_tensor(np.concatenate(served))
    _, truth_d = exact_knn(rows, queries, k, metric)
    kth = truth_d[:, k - 1:k] * (1.0 + TIE_REL)
    got_d = distances(rows, queries, served, metric)
    hits = (got_d <= kth).sum()
    nearest = truth_d[:, :1] * (1.0 + TIE_REL)
    missed = ~(got_d <= nearest).any(dim=1)
    q = queries.shape[0]
    return float(hits) / (q * k), float(missed.sum()) / q
