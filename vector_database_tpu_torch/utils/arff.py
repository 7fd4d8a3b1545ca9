"""Minimal ARFF ingestion + min-max normalization (a copy of
``vector_database_tpu/utils/arff.py``: numpy only).

The reference's test suite ingests a real clustering dataset in ARFF
format (2d-10c.arff via ArffTools, MempryVectorIndex.Tests/
MemoryVectorIndexTests.cs:116-134, 306-339) and min-max-normalizes each
attribute into [-1, 1] before indexing (the ``Dataset`` helper,
MemoryVectorIndexTests.cs:238-304). This module is that pipeline: a
dependency-free parser for numeric ARFF relations (the
only kind the reference consumes) plus the same normalization.

The repo vendors a real fixture at ``tests/data/digits-64.arff`` (UCI
optical-digits, 1797 real 8x8 handwritten-digit images): the tests run
without network access, so they cannot fetch the clustering-benchmark
file the reference downloads at test time.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def load_arff(path: str) -> Tuple[np.ndarray, list[str], Optional[np.ndarray]]:
    """Parse a numeric ARFF file.

    Returns ``(data [N, D] float32, attribute_names, labels)``. A trailing
    nominal attribute (``{a,b,...}`` domain) is split off as integer
    ``labels``; all other attributes must be NUMERIC/REAL/INTEGER.
    Comment lines (%), blank lines, and case-insensitive headers are
    handled; sparse ARFF and strings are not (the reference never uses
    them).
    """
    names: list[str] = []
    nominal: list[Optional[dict]] = []
    rows: list[list[float]] = []
    in_data = False
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("%"):
                continue
            low = line.lower()
            if not in_data:
                if low.startswith("@attribute"):
                    rest = line.split(None, 1)[1]
                    if "{" in rest:
                        name = rest[: rest.index("{")].strip().strip("'\"")
                        domain = [
                            v.strip()
                            for v in rest[
                                rest.index("{") + 1 : rest.rindex("}")
                            ].split(",")
                        ]
                        names.append(name)
                        nominal.append(
                            {v: i for i, v in enumerate(domain)}
                        )
                    else:
                        parts = rest.split()
                        kind = parts[-1].lower()
                        if kind not in ("numeric", "real", "integer"):
                            raise ValueError(
                                f"unsupported ARFF attribute type: {kind}"
                            )
                        names.append(
                            " ".join(parts[:-1]).strip().strip("'\"")
                        )
                        nominal.append(None)
                elif low.startswith("@data"):
                    in_data = True
                continue
            vals = [v.strip() for v in line.split(",")]
            if len(vals) != len(names):
                raise ValueError(
                    f"row width {len(vals)} != {len(names)} attributes"
                )
            rows.append(
                [
                    float(v) if dom is None else float(dom[v])
                    for v, dom in zip(vals, nominal)
                ]
            )
    mat = np.asarray(rows, dtype=np.float32)
    if mat.size == 0:
        # zero data rows parse to shape (0,) — keep the documented
        # [N, D] contract (and mat[:, -1] below) working at N == 0
        mat = np.zeros((0, len(names)), np.float32)
    label_cols = [i for i, dom in enumerate(nominal) if dom is not None]
    if label_cols:
        if label_cols != [len(names) - 1]:
            raise ValueError("only a trailing nominal class is supported")
        labels = mat[:, -1].astype(np.int32)
        mat = mat[:, :-1]
        names = names[:-1]
        return mat, names, labels
    return mat, names, None


def minmax_normalize(
    data: np.ndarray, lo: float = -1.0, hi: float = 1.0
) -> np.ndarray:
    """Per-attribute min-max normalization into ``[lo, hi]`` — the
    reference's ``Dataset`` preprocessing (MemoryVectorIndexTests.cs:
    238-304). Constant attributes map to the interval midpoint."""
    data = np.asarray(data, np.float32)
    mn = data.min(axis=0)
    mx = data.max(axis=0)
    span = mx - mn
    safe = np.where(span > 0, span, 1.0)
    unit = (data - mn) / safe  # [0, 1]
    unit = np.where(span > 0, unit, 0.5)
    return (lo + (hi - lo) * unit).astype(np.float32)
