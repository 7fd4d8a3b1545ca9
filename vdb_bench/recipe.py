"""The benchmark's data: a frozen copy of the port's bench recipe.

``clustered`` is ``vector_database_tpu_torch/benchmarks/_harness.py``'s
``clustered`` as it stood when this benchmark was written, copied so that
a change to the program cannot change the data it is measured on.
``centres`` and ``draw`` split it into its steps (the same generator
calls in the same order), so that a run can draw every request's queries
from the database's own centres with a generator of its own.

A configuration names a ``style`` that maps the recipe onto its source's
value range:

- ``unit``: each row scaled to unit length, as ann-benchmarks' angular
  sets are;
- ``sift``: ``x * 64 + 64`` (centres uniform in [0, 128), noise sigma
  3.2), rounded and clipped to [0, 255], SIFT's non-negative integers.
"""

from __future__ import annotations

import hashlib

import torch

SIGMA = 0.05


def clustered(n: int, d: int, q: int, seed: int, dev: torch.device):
    """The bench recipe on the device: ``max(64, n // 1000)`` centres
    uniform in [-1, 1], rows and queries each a random centre plus
    N(0, 0.05^2) noise; ``(train [n, d], test [q, d])`` from a seeded
    ``torch.Generator``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    c = max(64, n // 1000)
    centers = torch.rand((c, d), generator=g, device=dev) * 2 - 1
    train = torch.randn((n, d), generator=g, device=dev).mul_(0.05)
    train += centers[torch.randint(0, c, (n,), generator=g, device=dev)]
    test = torch.randn((q, d), generator=g, device=dev).mul_(0.05)
    test += centers[torch.randint(0, c, (q,), generator=g, device=dev)]
    return train, test


def stream_seed(seed: int, *parts) -> int:
    """A 63-bit generator seed for one stream of a run (``"rows"``,
    ``("queries", i)``, ...), the same for the same ``seed`` and parts."""
    h = hashlib.blake2b(repr((int(seed),) + parts).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def centres(g: torch.Generator, n: int, d: int) -> torch.Tensor:
    """The recipe's first draw: ``max(64, n // 1000)`` centres."""
    c = max(64, n // 1000)
    return torch.rand((c, d), generator=g, device=g.device) * 2 - 1


def draw(g: torch.Generator, cent: torch.Tensor, count: int) -> torch.Tensor:
    """``count`` rows: a random centre each plus N(0, SIGMA^2) noise, in
    the recipe's order of draws."""
    c, d = cent.shape
    x = torch.randn((count, d), generator=g, device=g.device).mul_(SIGMA)
    x += cent[torch.randint(0, c, (count,), generator=g, device=g.device)]
    return x


def styled(x: torch.Tensor, style: str) -> torch.Tensor:
    """``x`` mapped onto the source's values (in place where it can)."""
    if style == "unit":
        return x.div_(torch.linalg.vector_norm(x, dim=1, keepdim=True))
    if style == "sift":
        return x.mul_(64.0).add_(64.0).round_().clamp_(0.0, 255.0)
    raise ValueError(f"unknown recipe style {style!r}")


class Recipe:
    """One run's data: the database rows and any number of query sets,
    all from ``seed``. The rows come from the recipe's generator as
    ``clustered`` draws them; request ``i``'s queries from a generator of
    their own over the same centres, so no two requests share a query."""

    def __init__(self, config: dict, seed: int, dev: torch.device):
        self.n, self.d = int(config["n"]), int(config["d"])
        self.style = config["recipe"]["style"]
        self.seed = seed
        self.dev = torch.device(dev)
        g = torch.Generator(device=self.dev).manual_seed(
            stream_seed(seed, "rows"))
        self.cent = centres(g, self.n, self.d)
        self._g_rows = g

    def rows(self) -> torch.Tensor:
        """The ``[n, d]`` float32 database (call once: it continues the
        generator that drew the centres)."""
        return styled(draw(self._g_rows, self.cent, self.n), self.style)

    def queries(self, i: int, count: int) -> torch.Tensor:
        """Request ``i``'s ``[count, d]`` queries, on the device."""
        g = torch.Generator(device=self.dev).manual_seed(
            stream_seed(self.seed, "queries", i))
        return styled(draw(g, self.cent, count), self.style)
