"""``churn``: k-NN batches served by ``DynamicIndex`` while it takes adds
and removes, from one closed-loop client.

The system is the program's mutable index on its normal path, through its
public API alone: ``DynamicIndex(rows, leaf_size=...)``, then ``knn(queries,
k, exact=False, packed=True)`` (the bf16 packed full scan of the main
segment with its tombstones folded in, and the delta merged exactly),
``add(rows)`` and ``remove_ids(ids)``.

Set-up: the configuration's rows are drawn on the card (ids 0 to n - 1);
``DynamicIndex`` builds and packs them; ``remove_ids`` retires
``removed_at_start`` of them, drawn from the seed; ``add`` puts
``delta_rows`` fresh recipe rows in the delta, ``add_rows`` a call; two
requests of the window's shape warm every kernel.

One cycle of the window, in one closed loop:

1. a request of ``request_queries`` queries through ``knn``: fresh recipe
   queries, then ``fresh_probes`` drawn within ``probe_sigma`` of the rows
   added in the cycle before (read-your-writes), then ``removed_probes``
   within ``probe_sigma`` of the rows removed in the cycle before (removals
   hold), each probe scaled to unit length as the rows are;
2. ``add`` of ``add_rows`` fresh recipe rows, as a host array;
3. ``remove_ids`` of the oldest live add (``add_rows`` ids, which expire,
   so the delta holds ``delta_rows``) and of ``remove_main`` live ids of
   the built rows, in the seed's order.

The client draws cycle ``i``'s rows and ids and request ``i + 1``'s
queries on a stream of its own while request ``i`` is served, so its work
neither lengthens a request nor stands between two. End-to-end: ``qps``,
the queries answered over the window (its start to the last answer, the
mutations inside the loop), and ``p95_ms``, the 95th percentile of the
requests' latency.

``correct`` (``check``): after the window, with the program's state freed,
the acknowledged mutations are replayed in order into the plain live-set
reference (``reference.live.LiveSet``), and every answer is judged against
the set that was live when its request was sent:

- ``missing_answers``: queries sent without a whole answer; limit 0;
- ``removed_served``: served ids that were removed before the request was
  sent, or never added; limit 0;
- ``dist_rel_err``: the largest relative error of a served distance
  against the float64 squared distance of the served id's row;
- ``recall_at_10`` and ``nn_missed``, on ``correct.SAMPLE`` queries drawn
  from the seed among all answered, as in the serving cells but against
  the live set;
- ``fresh_nn_missed``: on every fresh probe of ``fresh_sample_requests``
  requests drawn from the seed, the share whose exact nearest live row is
  not served.

An add must acknowledge the ids the live set gives (the next integers in
insert order); one that does not, or a call that raises, is a failed
operation. ``attempted`` counts requests, adds and removes.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import sys
import time
import traceback

import numpy as np
import torch

from vdb_bench import trace as T
from vdb_bench.core import Result, Run, sync
from vdb_bench.correct import SAMPLE, TIE_REL
from vdb_bench.recipe import Recipe, draw, stream_seed, styled
from vdb_bench.reference.knn import LowReference
from vdb_bench.reference.live import LiveSet

WARM_REQUESTS = 2


class ProgramChurn:
    """The system under test: the program's ``DynamicIndex``."""

    def __init__(self, rows: torch.Tensor, cfg: dict):
        from vector_database_tpu_torch import DynamicIndex
        self.index = DynamicIndex(rows, leaf_size=cfg["leaf_size"])
        self.k = cfg["k"]

    def query(self, queries):
        return self.index.knn(queries, k=self.k, exact=False, packed=True)

    def add(self, rows):
        return self.index.add(rows)

    def remove_ids(self, ids):
        return self.index.remove_ids(ids)


@dataclasses.dataclass
class Cycle:
    """What the client prepared for one cycle: the rows it adds (on the
    card, and copied into a page-locked host buffer), the ids it removes,
    and the rows of those ids (the next request probes near both)."""

    rows: torch.Tensor
    host: np.ndarray
    remove: np.ndarray
    removed_rows: torch.Tensor
    done: object = None


@dataclasses.dataclass
class State:
    recipe: Recipe
    rows: torch.Tensor  # the built rows, ids 0 to n - 1
    system: object
    mix: dict
    k: int
    client: "Client" = None
    # the acknowledged mutations and the requests, in the order they
    # happened: ("add", rows, ids), ("remove", ids), ("request", i)
    log: list = dataclasses.field(default_factory=list)
    # request i's probe sources: the rows added and removed before it
    sources: dict = dataclasses.field(default_factory=dict)
    answers: list = dataclasses.field(default_factory=list)
    next_id: int = 0


def cycle_rows(recipe: Recipe, cycle: int, count: int) -> torch.Tensor:
    """Cycle ``cycle``'s rows to add, from a generator of their own."""
    g = torch.Generator(device=recipe.dev).manual_seed(
        stream_seed(recipe.seed, "add", cycle))
    return styled(draw(g, recipe.cent, count), recipe.style)


def request_queries(recipe: Recipe, mix: dict, i: int, added: torch.Tensor,
                    removed: torch.Tensor):
    """Request ``i``'s queries on the device: fresh recipe queries, then
    probes near rows of ``added``, then near rows of ``removed``;
    ``(queries, positions in added of the fresh probes)``."""
    count = int(mix["request_queries"])
    n_add, n_rem = int(mix["fresh_probes"]), int(mix["removed_probes"])
    fresh = recipe.queries(i, count - n_add - n_rem)
    g = torch.Generator(device=recipe.dev).manual_seed(
        stream_seed(recipe.seed, "probes", i))
    pa = torch.randperm(added.shape[0], generator=g,
                        device=recipe.dev)[:n_add]
    pr = torch.randperm(removed.shape[0], generator=g,
                        device=recipe.dev)[:n_rem]
    probes = torch.cat([added[pa], removed[pr]])
    probes += float(mix["probe_sigma"]) * torch.randn(
        probes.shape, generator=g, device=recipe.dev)
    return torch.cat([fresh, styled(probes, recipe.style)]), pa


class Client:
    """The client's own work, off the requests' path: ``prepare(i)`` draws
    cycle ``i``'s rows and ids and request ``i + 1``'s queries on a stream
    of its own into page-locked buffers; ``queries(i)`` and ``cycle(i)``
    hand them over once they are there."""

    def __init__(self, state: State, cfg: dict, run: Run):
        self.state = state
        self.recipe, self.mix = state.recipe, state.mix
        card = run.dev.type == "cuda"
        self.stream = torch.cuda.Stream(run.dev) if card else None
        d = self.recipe.d
        self.qbufs = [torch.empty((int(self.mix["request_queries"]), d),
                                  pin_memory=card) for _ in range(2)]
        self.abufs = [torch.empty((int(self.mix["add_rows"]), d),
                                  pin_memory=card) for _ in range(2)]
        rng = np.random.Generator(np.random.PCG64(
            stream_seed(run.seed, "main-removals")))
        self.main_order = rng.permutation(state.rows.shape[0])
        self.main_next = int(cfg["removed_at_start"])
        self.fifo = collections.deque()  # (ids, rows) of the live adds
        self.pending_q, self.pending_c = {}, {}

    def _on_stream(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def _event(self):
        if self.stream is None:
            return None
        done = torch.cuda.Event()
        done.record(self.stream)
        return done

    def setup_removal(self):
        """The removal that set-up makes, ``(ids, their rows)``: the first
        ``removed_at_start`` ids in the seed's order."""
        ids = self.main_order[:self.main_next]
        return ids, self.state.rows[torch.as_tensor(ids,
                                                     device=self.recipe.dev)]

    def prepare_queries(self, i: int, added, removed) -> None:
        """Request ``i``'s queries, probing near ``added`` and
        ``removed``, into its buffer."""
        self.state.sources[i] = (added, removed)
        with T.span("client.prepare"), self._on_stream():
            x, _ = request_queries(self.recipe, self.mix, i, added, removed)
            self.qbufs[i % 2].copy_(x, non_blocking=self.stream is not None)
            self.pending_q[i] = (x, self._event())

    def prepare(self, i: int) -> None:
        """Cycle ``i``'s rows and ids, then request ``i + 1``'s queries."""
        with T.span("client.prepare"), self._on_stream():
            rows = cycle_rows(self.recipe, i, int(self.mix["add_rows"]))
            host = self.abufs[i % 2]
            host.copy_(rows, non_blocking=self.stream is not None)
            old_ids, old_rows = self.fifo[0]
            main = self.main_order[self.main_next:self.main_next
                                   + int(self.mix["remove_main"])]
            removed = torch.cat([old_rows, self.state.rows[
                torch.as_tensor(main, device=self.recipe.dev)]])
            cyc = Cycle(rows=rows, host=host.numpy(),
                        remove=np.concatenate([old_ids, main]),
                        removed_rows=removed, done=self._event())
        self.pending_c[i] = cyc
        self.prepare_queries(i + 1, rows, removed)

    def queries(self, i: int) -> np.ndarray:
        _, done = self.pending_q.pop(i)
        if done is not None:
            done.synchronize()
        return self.qbufs[i % 2].numpy()

    def cycle(self, i: int) -> Cycle:
        cyc = self.pending_c.pop(i)
        if cyc.done is not None:
            cyc.done.synchronize()
        return cyc

    def added(self, ids: np.ndarray, rows: torch.Tensor) -> None:
        self.fifo.append((ids, rows))

    def removed(self) -> None:
        """A cycle's removal is acknowledged: the oldest add has expired
        and the main ids are gone."""
        self.fifo.popleft()
        self.main_next += int(self.mix["remove_main"])

    def delta_rows(self) -> int:
        return sum(ids.size for ids, _ in self.fifo)

    def close(self) -> None:
        for _, done in list(self.pending_q.values()):
            if done is not None:
                done.synchronize()
        for cyc in self.pending_c.values():
            if cyc.done is not None:
                cyc.done.synchronize()
        self.pending_q.clear()
        self.pending_c.clear()


def _add(state: State, rows: torch.Tensor, host) -> bool:
    """One acknowledged add, logged; False where it raised or gave other
    ids than the next in insert order."""
    want = np.arange(state.next_id, state.next_id + rows.shape[0])
    got = np.asarray(state.system.add(host), dtype=np.int64)
    state.next_id += rows.shape[0]
    state.log.append(("add", rows, want))
    state.client.added(want, rows)
    return got.shape == want.shape and bool((got == want).all())


def setup(run: Run) -> State:
    cfg, mix = run.cell.config, run.cell.mix
    recipe = Recipe(cfg, run.seed, run.dev)
    rows = recipe.rows()
    state = State(recipe=recipe, rows=rows,
                  system=ProgramChurn(rows, cfg), mix=mix, k=cfg["k"],
                  next_id=rows.shape[0])
    state.log.append(("add", rows, np.arange(rows.shape[0])))
    state.client = Client(state, cfg, run)
    gone, gone_rows = state.client.setup_removal()
    state.system.remove_ids(gone)
    state.log.append(("remove", gone))
    step = int(mix["add_rows"])
    cycles = int(cfg["delta_rows"]) // step
    for c in range(-cycles, 0):
        added = cycle_rows(recipe, c, step)
        if not _add(state, added, added.cpu().numpy()):
            raise RuntimeError(f"set-up add {c} was not acknowledged")
    count = int(mix["request_queries"])
    for j in range(WARM_REQUESTS):
        state.system.query(recipe.queries(-1 - j, count).cpu().numpy())
    state.client.prepare_queries(0, added, gone_rows)
    sync(run.dev)
    return state


def window(run: Run, state: State) -> Result:
    sys_, client = state.system, state.client
    lat, answered, failed, attempted = [], 0, 0, 0
    traced_queries = traced_cycles = 0
    merges = []  # (queries answered, live delta rows) of traced requests
    tracer = T.Tracer(run.dev, run.traced)
    t_start = time.perf_counter()
    t_last = t_start
    i = 0
    while i == 0 or time.perf_counter() - t_start < run.seconds:
        with T.span("client.queries"):
            queries = client.queries(i)
        client.prepare(i)
        delta = client.delta_rows()
        t0 = time.perf_counter()
        try:
            with T.span("request"):
                ids, dist = sys_.query(queries)
            ans = (np.asarray(ids), np.asarray(dist))
        except Exception:
            if failed == 0:
                traceback.print_exc()
            ans = None
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        state.log.append(("request", i))
        state.answers.append(ans)
        attempted += 1
        if ans is None or ans[0].shape != (queries.shape[0], state.k):
            failed += 1
        else:
            answered += queries.shape[0]
            t_last = t1
            if tracer.running:
                merges.append((queries.shape[0], delta))
        with T.span("client.cycle"):
            cyc = client.cycle(i)
        for op in ("add", "remove"):
            attempted += 1
            try:
                with T.span(op):
                    if op == "add":
                        ok = _add(state, cyc.rows, cyc.host)
                    else:
                        sys_.remove_ids(cyc.remove)
                        state.log.append(("remove", cyc.remove))
                        client.removed()
                        ok = True
            except Exception:
                if failed == 0:
                    traceback.print_exc()
                ok = False
            failed += not ok
        i += 1
        if tracer.running:
            traced_queries, traced_cycles = answered, i
            tracer.stop_after(time.perf_counter() - t_start)
    tracer.stop()
    client.close()
    summary = tracer.summary()
    if summary is not None:
        summary.kind = "churn"
        summary.queries = traced_queries
        summary.requests = traced_cycles
        summary.work = {"d": state.recipe.d, "k": state.k, "merges": merges}
    e2e = {
        "qps": answered / (t_last - t_start) if answered else 0.0,
        "p95_ms": float(np.percentile(np.asarray(lat), 95)) * 1e3,
    }
    print(f"window: {i} cycles, {answered} queries answered in "
          f"{t_last - t_start:.3f} s", file=sys.stderr)
    return Result(attempted=attempted, failed=failed, end_to_end=e2e,
                  summary=summary)


def replay(state: State):
    """The live-set reference with every acknowledged mutation of the log
    applied in order, and the version at which each request was sent."""
    live = LiveSet(state.rows.device)
    versions = {}
    for entry in state.log:
        if entry[0] == "add":
            ids = live.add(entry[1])
            if not torch.equal(ids.cpu(), torch.as_tensor(entry[2])):
                raise RuntimeError("the live set gave other ids")
        elif entry[0] == "remove":
            live.remove_ids(torch.as_tensor(entry[1]))
        else:
            versions[entry[1]] = live.version
    return live, versions


def check(run: Run, state: State, result: Result) -> dict:
    """Frees the program's state, then judges every answer against the
    set that was live when its request was sent."""
    state.system = state.client = None
    if run.dev.type == "cuda":
        torch.cuda.empty_cache()
    live, versions = replay(state)
    return judge(live, versions, state, run.cell.spec["checks"], run.seed)


def judge(live: LiveSet, versions: dict, state: State, limits: dict,
          seed: int) -> dict:
    mix, k = state.mix, state.k
    dev = state.rows.device
    count = int(mix["request_queries"])
    first_probe = count - int(mix["fresh_probes"]) - int(mix["removed_probes"])
    missing = removed = 0
    worst = 0.0
    answered = []  # (request, whole answers)
    for i, ans in enumerate(state.answers):
        if ans is None:
            missing += count
            continue
        ids, dist = ans
        if ids.ndim != 2 or ids.shape[1] != k or dist.shape != ids.shape:
            missing += count
            continue
        got = min(count, ids.shape[0])
        missing += count - got
        queries, _ = request_queries(state.recipe, mix, i,
                                     *state.sources[i])
        served = torch.as_tensor(ids[:got], device=dev)
        ref = live.distances(queries[:got], served)
        d = torch.as_tensor(dist[:got], device=dev, dtype=torch.float64)
        err = (d - ref).abs() / ref.clamp_min(1e-300)
        err = torch.where(d == ref, 0.0, err)
        err = torch.where(torch.isnan(err) | torch.isinf(ref), math.inf, err)
        worst = max(worst, float(err.max())) if err.numel() else worst
        # -1 is an empty slot (dist_rel_err fails it); any other id must
        # be live when the request was sent
        removed += int(((served != -1)
                        & ~live.is_live(served, versions[i])).sum())
        answered.append((i, got))

    recall, nn_missed, fresh_missed, probed = _sampled(
        live, versions, state, answered, first_probe, seed)
    print(f"fresh probes whose nearest live row is the probed row: "
          f"{probed!r}", file=sys.stderr)
    return {
        "missing_answers": (missing, limits["missing_answers"],
                            missing <= limits["missing_answers"]),
        "removed_served": (removed, limits["removed_served"],
                           removed <= limits["removed_served"]),
        "dist_rel_err": (worst, limits["dist_rel_err"],
                         worst <= limits["dist_rel_err"]),
        "recall_at_10": (recall, limits["recall_at_10"],
                         recall >= limits["recall_at_10"]),
        "nn_missed": (nn_missed, limits["nn_missed"],
                      nn_missed <= limits["nn_missed"]),
        "fresh_nn_missed": (fresh_missed, limits["fresh_nn_missed"],
                            fresh_missed <= limits["fresh_nn_missed"]),
    }


def _sampled(live, versions, state, answered, first_probe, seed):
    """``(recall@k, nn_missed)`` on ``SAMPLE`` queries drawn from the seed
    among all answered, ``fresh_nn_missed`` on the fresh probes of
    ``fresh_sample_requests`` answered requests drawn from the seed, and
    the share of those probes whose nearest live row is the row probed;
    every query judged against the set live when its request was sent,
    in one pass of the reference."""
    mix, k = state.mix, state.k
    dev = state.rows.device
    total = sum(got for _, got in answered)
    if total == 0:
        return 0.0, 1.0, 1.0, 0.0
    rng = np.random.Generator(np.random.PCG64(stream_seed(seed, "sample")))
    pick = np.sort(rng.choice(total, size=min(SAMPLE, total), replace=False))
    rng = np.random.Generator(np.random.PCG64(stream_seed(seed, "fresh")))
    n_req = min(int(mix["fresh_sample_requests"]), len(answered))
    fresh_req = set(rng.choice(len(answered), size=n_req,
                               replace=False).tolist())
    n_fresh = int(mix["fresh_probes"])
    starts = np.cumsum([0] + [got for _, got in answered])
    qs, served, at, kinds, probed_ids = [], [], [], [], []
    for j, (i, got) in enumerate(answered):
        mine = pick[(pick >= starts[j]) & (pick < starts[j + 1])] - starts[j]
        fresh = (np.arange(first_probe, min(first_probe + n_fresh, got))
                 if j in fresh_req else np.zeros(0, np.int64))
        if mine.size == 0 and fresh.size == 0:
            continue
        queries, pa = request_queries(state.recipe, mix, i,
                                      *state.sources[i])
        rows = np.concatenate([mine, fresh])
        qs.append(queries[torch.as_tensor(rows, device=dev)])
        served.append(state.answers[i][0][rows])
        at += [versions[i]] * rows.size
        kinds += [0] * mine.size + [1] * fresh.size
        if fresh.size:
            # the ids of the rows added before request i, by position
            added_ids = _added_ids_before(state, i)
            probed_ids.append(added_ids[pa[:fresh.size].cpu().numpy()])
    queries = torch.cat(qs)
    served = torch.as_tensor(np.concatenate(served), device=dev)
    at = torch.tensor(at, device=dev)
    truth_i, truth_d = live.knn(queries, k, at=at)
    # a served id that was not live counts for nothing
    got_d = torch.where(live.is_live(served, at),
                        live.distances(queries, served), math.inf)
    nearest = truth_d[:, :1] * (1.0 + TIE_REL)
    missed = ~(got_d <= nearest).any(dim=1)
    kinds = torch.tensor(kinds, device=dev, dtype=torch.bool)
    sample = ~kinds
    q = int(sample.sum())
    kth = truth_d[:, k - 1:k] * (1.0 + TIE_REL)
    hits = (got_d[sample] <= kth[sample]).sum()
    recall = float(hits) / (q * k) if q else 0.0
    nn_missed = float(missed[sample].sum()) / q if q else 1.0
    nf = int(kinds.sum())
    fresh_missed = float(missed[kinds].sum()) / nf if nf else 1.0
    probed = 0.0
    if nf:
        want = torch.as_tensor(np.concatenate(probed_ids), device=dev)
        probed = float((truth_i[kinds, 0] == want).sum()) / nf
    return recall, nn_missed, fresh_missed, probed


def _added_ids_before(state: State, i: int) -> np.ndarray:
    """The ids of the last add acknowledged before request ``i``."""
    last = None
    for entry in state.log:
        if entry[0] == "add":
            last = entry[2]
        elif entry[0] == "request" and entry[1] == i:
            return last
    raise KeyError(i)


# --- controls and faults ----------------------------------------------


class LowLive:
    """A precision fault: the reference computed in int8 or float8 e4m3
    (``reference.knn.LowReference``) over the rows live now, in the
    program's place, with no shortlist and no exact rerank."""

    def __init__(self, state: State, fmt: str):
        self.live, _ = replay(state)
        self.k, self.fmt = state.k, fmt

    def query(self, queries):
        ids = torch.nonzero(self.live.live()).squeeze(1)
        low = LowReference(self.live.rows()[ids], "l2", self.k, self.fmt)
        pos, dist = low.query(queries)
        return ids.cpu()[pos.long()].numpy(), dist.numpy()

    def add(self, rows):
        return self.live.add(torch.as_tensor(rows).to(
            self.live.device).clone()).cpu().numpy()

    def remove_ids(self, ids):
        return self.live.remove_ids(ids)


class _Late:
    """A fault: every mutation is acknowledged at once (the ids an add
    would get) but applied only when the next cycle's first one comes."""

    def __init__(self, inner, next_id: int):
        self.inner, self.next_id, self.pending = inner, next_id, []

    def query(self, queries):
        return self.inner.query(queries)

    def add(self, rows):
        for op, arg in self.pending:
            getattr(self.inner, op)(arg)
        self.pending = [("add", np.array(rows))]
        ids = np.arange(self.next_id, self.next_id + len(rows))
        self.next_id += len(rows)
        return ids

    def remove_ids(self, ids):
        self.pending.append(("remove_ids", np.array(ids)))
        return len(ids)


class _NoTombstones:
    """A fault: removals of the built rows are never applied (the main
    segment's tombstones are ignored); the delta's still are."""

    def __init__(self, inner, n_main: int):
        self.inner, self.n_main = inner, n_main
        index = inner.index
        index._main_alive[:] = True  # forget set-up's tombstones too
        index._invalidate_main()

    def query(self, queries):
        return self.inner.query(queries)

    def add(self, rows):
        return self.inner.add(rows)

    def remove_ids(self, ids):
        ids = np.asarray(ids)
        return self.inner.remove_ids(ids[ids >= self.n_main])


def _no_delta(state: State):
    """A fault: the delta is never merged into an answer."""
    system = state.system
    system.index.merge_delta = lambda queries, ids, d2, k, **kw: (ids, d2)
    return system


FAULTS = {
    "no-delta": _no_delta,
    "no-tombstones": lambda state: _NoTombstones(state.system,
                                                 state.rows.shape[0]),
    "late": lambda state: _Late(state.system, state.next_id),
}


def control_system(state: State, fmt: str):
    """A fault in the program's place: ``int8`` or ``fp8`` (the reference
    in that precision over the live rows; the program's state is dropped
    first), or one of ``FAULTS`` around the program."""
    if fmt in FAULTS:
        return FAULTS[fmt](state)
    state.system = None
    if state.rows.is_cuda:
        torch.cuda.empty_cache()
    return LowLive(state, fmt)
