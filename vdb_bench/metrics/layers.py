"""The program's layers in a traced window: device time charged to the
program's own spans, idle time under them, and its counters.

The program names its layers with ``torch.profiler`` spans whose names
start with ``vdb_torch.`` (``vector_database_tpu_torch/utils/profiling``).
A device operation belongs to the innermost program span around the host
call that launched it (``attribute``). The profiler ties the two by a
correlation id, which ``trace.Summary`` does not keep, so ``pair`` ties
them again from what it keeps: the program runs on one stream, where the
card runs operations in the order the host launched them.

The order alone is not enough. ``trace.summarize`` takes the correlation
ids of every host event inside the client's spans as the client's
launches, aten operators among them, whose ids count apart from the CUDA
runtime's; in a process's first profiled window the two counts overlap,
so a few of the program's operations (about one in 140 in the deep
serving cell) are left out as the client's. ``pair`` therefore splits
the window at the program's host synchronisations (every operation
launched before one has run by its end), learns for each run of launches
inside one span the names of the operations it launches (the most common
among the places the run could sit), and aligns each part's operations
to its launches, skipping as many launches as operations are missing, so
that the most names agree (``_align``); then it learns the names again
from that alignment, and aligns again. Against the profiler's own ids
(traces of the cells on an H100) this pairs every operation of the deep
serving cell's window, and of windows with four times as many left out.
Where a part holds more operations than launches (the device's clock
has drifted from the host's, as it can in a process's later profiled
windows) the pairing is refused and the readers find nothing to read.

``counters`` reads the program's ``COUNTERS`` over the whole run (the
warm-up and the window), or None where the program keeps none.
"""

from __future__ import annotations

import bisect

PROGRAM = "vdb_torch."
CLIENT = "vdb_bench.client."  # the benchmark client's spans (trace.CLIENT)
# host calls that put one operation on the device, by the kind of the
# operation (its name on the device's timeline)
_LAUNCH = (("kernel", ("cudaLaunch", "cuLaunch")),
           ("memcpy", ("cudaMemcpy", "cuMemcpy")),
           ("memset", ("cudaMemset", "cuMemset")))
_NOT_LAUNCH = ("cudaLaunchHostFunc", "cuLaunchHostFunc")


def call_kind(name: str) -> str | None:
    """The kind of device operation a host call launches, or None."""
    if name.startswith(_NOT_LAUNCH):
        return None
    for kind, prefixes in _LAUNCH:
        if name.startswith(prefixes):
            return kind
    return None


def op_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def attribute(ops, calls, spans) -> dict:
    """``{innermost program span, or "": device nanoseconds}``.

    ``ops``: ``(name, start_ns, end_ns, correlation)`` of device
    operations; ``calls``: ``(start_ns, correlation)`` of the host calls
    that launched them; ``spans``: ``(name, start_ns, end_ns)`` of host
    spans, nested as on one thread: the program's (``vdb_torch.``) and the
    client's (``vdb_bench.client.``). An operation launched inside a client
    span is the client's and left out; one launched in no program span, or
    by no call among ``calls``, counts under ``""``."""
    spans = sorted((sp for sp in spans if sp[0].startswith((PROGRAM,
                                                            CLIENT))),
                   key=lambda sp: (sp[1], -sp[2]))
    where, stack, i = {}, [], 0
    for s, corr in sorted(calls):
        while i < len(spans) and spans[i][1] <= s:
            while stack and stack[-1][2] <= spans[i][1]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] <= s:
            stack.pop()
        where[corr] = stack[-1][0] if stack else ""
    out = {}
    for _, s, e, corr in ops:
        key = where.get(corr, "")
        if key.startswith(CLIENT):
            continue
        out[key] = out.get(key, 0) + (e - s)
    return out


SYNC = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


def launches(t):
    """``(calls, syncs)``: the program's launch calls in order, each
    ``(start_ns, kind, context, span)`` (``context`` the innermost aten
    operator or program span around it, ``span`` the innermost program
    span instance, ``(name, start_ns)``), and the ends of its host
    synchronisations; calls inside the client's spans are left out."""
    calls, syncs, stack = [], [], []
    for op in sorted(t.host_ops, key=lambda op: (op[1], -op[2])):
        name, s, e = op
        # the profiler's own threads' events need not nest with these
        stack = [o for o in stack if o[2] > s]
        if not any(n.startswith(CLIENT) for n, _, _ in stack + [op]):
            kind = call_kind(name)
            if kind is not None:
                ctx = next((n for n, _, _ in reversed(stack)
                            if n.startswith(("aten::", PROGRAM))), "")
                span = next(((n, s0) for n, s0, _ in reversed(stack)
                             if n.startswith(PROGRAM)), ("", 0))
                calls.append((s, kind, ctx, span))
            elif name.startswith(SYNC):
                syncs.append(e)
        stack.append(op)
    return calls, syncs


def _runs(calls, lo, hi):
    """``[(first, end, signature)]``: the runs of ``calls[lo:hi]`` that lie
    in one span instance, each with its span's name and its calls'
    kinds and contexts."""
    out, i = [], lo
    while i < hi:
        j = i + 1
        while j < hi and calls[j][3] == calls[i][3]:
            j += 1
        out.append((i, j, (calls[i][3][0], tuple(c[1:3]
                                                 for c in calls[i:j]))))
        i = j
    return out


def _templates(calls, ops, parts) -> dict:
    """The names a run of each signature launches: the most common of the
    candidates, the slices of operations the run could pair with in its
    part (as many places as operations are missing there)."""
    votes = {}
    for ci, cj, oi, oj in parts:
        missing = (cj - ci) - (oj - oi)
        for a, b, sig in _runs(calls, ci, cj):
            seen = set()
            for s in range(missing + 1):
                lo = oi + (a - ci) - s
                if lo < oi or lo + (b - a) > oj:
                    continue
                seen.add(tuple(op[0] for op in ops[lo:lo + (b - a)]))
            for cand in seen:
                tally = votes.setdefault(sig, {})
                tally[cand] = tally.get(cand, 0) + 1
    return {sig: max(tally, key=tally.get) for sig, tally in votes.items()}


def _align(calls, ops, part, expect):
    """``[call index of each operation]`` of one part: operations in order
    against launches in order with ``missing`` launches skipped, the
    kinds equal, and the most names equal to ``expect`` (a banded dynamic
    program over the skips so far). Between launches of the same name,
    which the names cannot tell apart, it takes the one that launched
    before the operation started, then the latest such. None where no
    alignment exists."""
    ci, cj, oi, oj = part
    missing = (cj - ci) - (oj - oi)
    if missing == 0:
        return list(range(ci, cj))
    none = (float("-inf"),)
    score, back = [(0, 0, 0)] * (missing + 1), []
    for k in range(oj - oi):
        name, start, _ = ops[oi + k]
        kind = op_kind(name)
        best, arg = none, -1
        row, ptr = [none] * (missing + 1), [-1] * (missing + 1)
        for s in range(missing + 1):
            if score[s] > best:
                best, arg = score[s], s
            c = ci + k + s
            if best > none and calls[c][1] == kind:
                late = start - calls[c][0]
                row[s] = (best[0] + (expect[c - ci] == name),
                          best[1] - (late < 0), best[2] - max(late, 0))
                ptr[s] = arg
        back.append(ptr)
        score = row
    s = max(range(missing + 1), key=score.__getitem__)
    if score[s] == none:
        return None
    out = [0] * (oj - oi)
    for k in range(oj - oi - 1, -1, -1):
        out[k] = ci + k + s
        s = back[k][s]
    return out


def pair(t, rounds: int = 3):
    """``(ops, calls)`` as ``attribute`` takes them, from a ``Summary``:
    the program's device operations paired with its launch calls (see the
    module's docstring); None where they cannot be paired. Each of the
    ``rounds`` after the first learns the runs' names again from the
    last alignment, where each run sits in one place."""
    calls, syncs = launches(t)
    ops = sorted(t.device_ops, key=lambda op: op[1])
    c_at, o_at = [c[0] for c in calls], [op[1] for op in ops]
    parts, ci, oi = [], 0, 0
    for end in sorted(syncs) + [float("inf")]:
        cj = max(ci, bisect.bisect_left(c_at, end))
        oj = max(oi, bisect.bisect_left(o_at, end))
        if cj - ci < oj - oi:
            return None
        if cj > ci:
            parts.append((ci, cj, oi, oj))
        ci, oi = cj, oj
    tmpl = _templates(calls, ops, parts)
    for again in range(rounds):
        if again:
            tmpl = _relearn(calls, ops, parts, match)
        match = []
        for part in parts:
            expect = []
            for a, b, sig in _runs(calls, part[0], part[1]):
                expect += tmpl.get(sig, (None,) * (b - a))
            got = _align(calls, ops, part, expect)
            if got is None:
                return None
            match += got
    return ([(op[0], op[1], op[2], c) for op, c in zip(ops, match)],
            [(c[0], i) for i, c in enumerate(calls)])


def _relearn(calls, ops, parts, match) -> dict:
    """The names each run signature launched where an alignment (``match``,
    the call of each operation) put every one of its calls."""
    name_of = {c: op[0] for op, c in zip(ops, match)}
    votes = {}
    for ci, cj, _, _ in parts:
        for a, b, sig in _runs(calls, ci, cj):
            names = tuple(name_of.get(c) for c in range(a, b))
            if None not in names:
                tally = votes.setdefault(sig, {})
                tally[names] = tally.get(names, 0) + 1
    return {sig: max(tally, key=tally.get) for sig, tally in votes.items()}


_last = [None, None]  # the summary read last, and its layers


def layer_ns(t) -> dict | None:
    """``attribute`` over a ``Summary`` (None where ``pair`` refuses)."""
    if _last[0] is not t:
        paired = pair(t)
        _last[:] = [t, None if paired is None
                    else attribute(*paired, t.host_ops)]
    return _last[1]


def program_idle_ns(t) -> int | None:
    """Nanoseconds of the window in which no device operation runs and
    the host is inside a program span: every gap between device
    operations whose middle lies in a ``vdb_torch.`` span. None where the
    window holds no program span or no device operation."""
    spans = sorted((s, e) for n, s, e in t.host_ops if n.startswith(PROGRAM))
    if not spans or not t.device_ops:
        return None
    union = []
    for s, e in spans:
        if union and s <= union[-1][1]:
            union[-1][1] = max(union[-1][1], e)
        else:
            union.append([s, e])
    starts = [s for s, _ in union]
    t0, t1 = t.window_ns
    gaps, last = [], t0
    for s, e in t.busy_intervals():
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if t1 > last:
        gaps.append((last, t1))
    idle = 0
    for s, e in gaps:
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and union[i][1] >= mid:
            idle += e - s
    return idle


def counters() -> dict | None:
    """The program's process-wide counters, or None where it has none."""
    try:
        from vector_database_tpu_torch.utils.profiling import COUNTERS
    except ImportError:
        return None
    return dict(COUNTERS)


def per_query_us(t, span: str) -> float | None:
    """Device microseconds under ``span`` per query answered in a serving
    cell's traced window."""
    if t.kind != "serve_batch" or not t.queries:
        return None
    ns = (layer_ns(t) or {}).get(span)
    return None if ns is None else ns / 1e3 / t.queries


def per_operation_ms(t, span: str) -> float | None:
    """Device milliseconds under ``span`` per rebuild operation traced."""
    if t.kind != "rebuild" or not t.requests:
        return None
    ns = (layer_ns(t) or {}).get(span)
    return None if ns is None else ns / 1e6 / t.requests
