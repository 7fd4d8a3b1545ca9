"""The traced run's reading of ``torch.profiler``, summarised in memory.

A traced sub-window is one ``record_function`` span (``TRACED``), so its
ends lie on the profiler's own clock beside every host and device event.
``summarize`` keeps, inside it, the program's device operations (kernels,
copies, sets; not the client's, which are launched inside its
``client.*`` spans),
the host operations and the benchmark's spans, and nothing is written to
disk.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses

import torch

SECONDS = 2.0  # the traced sub-window, at the window's start
TRACED = "vdb_bench.traced"
CLIENT = "vdb_bench.client."  # spans of the benchmark's own client work
NAME_CHARS = 160  # a kernel's name is cut to this many characters


@dataclasses.dataclass
class Summary:
    """What the per-layer readers read.

    ``device_ops``: ``(name, start_ns, end_ns)`` of each of the program's
    device operations in the traced window; ``host_ops`` the same for host operations (the
    benchmark's spans among them); ``window_ns``: the window's ends.
    ``kind``, ``queries``, ``requests``, ``work`` and ``spans`` are the
    run's: its traffic kind, the queries and requests answered in the
    window, the sizes that
    count the work (``n``, ``d``, ``m``, ``block``, ``probes``), and the
    benchmark's own spans, ``{name: [seconds, ...]}``; ``client_ops``
    counts the client's device operations, which are left out."""

    device_ops: list
    host_ops: list
    window_ns: tuple
    kind: str = ""
    queries: int = 0
    requests: int = 0
    work: dict = dataclasses.field(default_factory=dict)
    spans: dict = dataclasses.field(default_factory=dict)
    client_ops: int = 0  # the client's device operations left out

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, in order."""
        out = []
        for _, s, e in sorted(self.device_ops, key=lambda op: op[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_totals(self) -> list:
        """``[[name, seconds], ...]``, the longest total first."""
        tot = {}
        for name, s, e in self.device_ops:
            tot[name] = tot.get(name, 0) + (e - s)
        return sorted(([n, t / 1e9] for n, t in tot.items()),
                      key=lambda x: -x[1])

    def idle_by_host(self) -> list:
        """``[[what the host did, idle seconds], ...]``: every gap between
        device operations, named by the benchmark span and the innermost
        host operation under way at its middle, summed by name, the
        longest first."""
        t0, t1 = self.window_ns
        gaps, last = [], t0
        for s, e in self.busy_intervals():
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        if t1 > last:
            gaps.append((last, t1))
        spans = sorted((op for op in self.host_ops
                        if op[0].startswith("vdb_bench.")
                        and op[0] != TRACED), key=lambda op: op[1])
        ops = sorted((op for op in self.host_ops
                      if not op[0].startswith("vdb_bench.")),
                     key=lambda op: op[1])
        starts = [op[1] for op in ops]
        tot = {}
        for s, e in gaps:
            mid = (s + e) // 2
            key = _host_at(spans, ops, starts, mid)
            tot[key] = tot.get(key, 0) + (e - s)
        return sorted(([n, t / 1e9] for n, t in tot.items()),
                      key=lambda x: -x[1])


def _host_at(spans, ops, starts, t, look_back: int = 4000) -> str:
    """``"span/op"``: the benchmark span (they follow one another) and the
    innermost host operation under way at time ``t`` (``-`` where none
    is); ``spans`` and ``ops`` sorted by start."""
    i = bisect.bisect_right(spans, t, key=lambda sp: sp[1]) - 1
    span = spans[i][0] if i >= 0 and spans[i][2] >= t else None
    inner = None
    hi = bisect.bisect_right(starts, t)
    for name, s, e in reversed(ops[max(0, hi - look_back):hi]):
        if e >= t:
            inner = name
            break
    span = span[len("vdb_bench."):] if span else "-"
    return f"{span}/{inner or '-'}"


@contextlib.contextmanager
def profiled(dev: torch.device):
    """A ``torch.profiler.profile`` of the host and, on a card, the device;
    yields the profiler (read it after the block)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


class Tracer:
    """Profiles the first ``SECONDS`` of a traced window (nothing for an
    untraced one): made just before the window opens, told the elapsed
    time after each request or operation (``stop_after``), and stopped
    when the window closes; ``summary()`` reads it."""

    def __init__(self, dev: torch.device, traced: bool):
        self.prof, self._open = None, None
        if traced:
            self._open = contextlib.ExitStack()
            self.prof = self._open.enter_context(profiled(dev))
            self._open.enter_context(span("traced"))

    @property
    def running(self) -> bool:
        return self._open is not None

    def stop_after(self, elapsed: float) -> None:
        if self.running and elapsed >= SECONDS:
            self.stop()

    def stop(self) -> None:
        if self.running:
            self._open.close()
            self._open = None

    def summary(self):
        return None if self.prof is None else summarize(self.prof)


def span(name: str):
    """A benchmark span that the profiler records when it runs."""
    return torch.profiler.record_function(f"vdb_bench.{name}")


def _correlation(ev) -> int:
    """The id that ties a device operation to the host call that
    launched it (0 where the profiler gives none)."""
    get = getattr(ev, "correlation_id", None)
    return int(get()) if get is not None else 0


def _linked(ev) -> int:
    get = getattr(ev, "linked_correlation_id", None)
    return int(get()) if get is not None else 0


def summarize(prof) -> Summary:
    """The events of ``prof`` inside its ``TRACED`` span."""
    dev_ops, host_ops, window = [], [], None
    links = []  # (device op's index, its correlation ids)
    calls = []  # (start, correlation id) of host calls that launch work
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            # a span's shadow on the device's timeline is no operation
            shadow = getattr(ev, "is_user_annotation", lambda: False)()
            if not (shadow or name.startswith("vdb_bench.")):
                links.append({_correlation(ev), _linked(ev)} - {0})
                dev_ops.append((name[:NAME_CHARS], s, e))
        else:
            if name == TRACED:
                window = (s, e)
            host_ops.append((name[:NAME_CHARS], s, e))
            if _correlation(ev):
                calls.append((s, _correlation(ev)))
    if window is None:
        raise RuntimeError(f"the profiler recorded no {TRACED} span")
    t0, t1 = window
    host_ops = [op for op in host_ops if op[2] > t0 and op[1] < t1]
    # the client's own device work (drawing and copying its queries) is
    # launched inside its spans and may run beside a request: it is not
    # the program's
    client = sorted((s, e) for n, s, e in host_ops if n.startswith(CLIENT))
    starts = [s for s, _ in client]

    def the_clients(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and client[i][1] >= t

    launched = {c for s, c in calls if the_clients(s)}
    inside = [(op, link) for op, link in zip(dev_ops, links)
              if op[2] > t0 and op[1] < t1]
    dev_ops = [(n, max(s, t0), min(e, t1)) for (n, s, e), link in inside
               if not link & launched]
    return Summary(device_ops=dev_ops, host_ops=host_ops, window_ns=window,
                   client_ops=len(inside) - len(dev_ops))
