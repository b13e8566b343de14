"""Minimal Prometheus text-exposition (0.0.4) linter.

Counterpart of ``accelerate_tpu/observability/promlint.py`` (pure Python,
copied so that the port imports nothing of the JAX package).

Validates the gateway's ``/metrics`` body without external
dependencies: every sample series must be preceded by ``# HELP`` and
``# TYPE`` lines for its family, histogram families must expose
cumulative ``_bucket{le=...}`` series ending in ``le="+Inf"`` with a
matching ``_count``, and no family may be declared twice. Used by the
exposition-format lint test and available to deployments that want to
gate a scrape config on a known-good body.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

__all__ = ["lint_prometheus_text", "parse_sample_line"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>\S+)(?:\s+\d+)?$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

#: suffixes a histogram (or summary) family fans out into
_FAMILY_SUFFIXES = ("_bucket", "_sum", "_count")


def parse_sample_line(line: str) -> Optional[Tuple[str, Dict[str, str], str]]:
    """``(name, labels, value)`` for a sample line, or None if malformed."""
    m = _SAMPLE_RE.match(line)
    if m is None:
        return None
    labels: Dict[str, str] = {}
    raw = m.group("labels")
    if raw:
        consumed = 0
        for lm in _LABEL_RE.finditer(raw):
            labels[lm.group(1)] = lm.group(2)
            consumed = lm.end()
        # tolerate the trailing comma prometheus allows; reject garbage
        if raw[consumed:].strip(", ") != "":
            return None
    return m.group("name"), labels, m.group("value")


def _family_of(name: str, types: Dict[str, str]) -> str:
    """Map a sample name to its declared family (histogram samples like
    ``x_bucket`` belong to family ``x``)."""
    if name in types:
        return name
    for suffix in _FAMILY_SUFFIXES:
        if name.endswith(suffix):
            base = name[: -len(suffix)]
            if types.get(base) in ("histogram", "summary"):
                return base
    return name


def lint_prometheus_text(text: str) -> List[str]:
    """Lint an exposition body; returns problems (empty list = valid)."""
    problems: List[str] = []
    helps: Dict[str, str] = {}
    types: Dict[str, str] = {}
    samples: List[Tuple[int, str, Dict[str, str], float]] = []

    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) < 3:
                problems.append(f"line {lineno}: malformed HELP")
                continue
            name = parts[2]
            if name in helps:
                problems.append(f"line {lineno}: duplicate HELP for {name}")
            helps[name] = parts[3] if len(parts) > 3 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4:
                problems.append(f"line {lineno}: malformed TYPE")
                continue
            name, mtype = parts[2], parts[3]
            if name in types:
                problems.append(f"line {lineno}: duplicate TYPE for {name}")
            if mtype not in ("counter", "gauge", "histogram", "summary",
                             "untyped"):
                problems.append(
                    f"line {lineno}: unknown type {mtype!r} for {name}")
            types[name] = mtype
            continue
        if line.startswith("#"):
            continue  # plain comment
        parsed = parse_sample_line(line)
        if parsed is None:
            problems.append(f"line {lineno}: unparseable sample {line!r}")
            continue
        name, labels, raw_value = parsed
        if not _NAME_RE.match(name):
            problems.append(f"line {lineno}: invalid metric name {name!r}")
            continue
        try:
            value = float(raw_value)
        except ValueError:
            problems.append(
                f"line {lineno}: non-numeric value {raw_value!r} for {name}")
            continue
        samples.append((lineno, name, labels, value))

    seen_series = set()
    hist_buckets: Dict[str, List[Tuple[str, float]]] = {}
    hist_counts: Dict[str, float] = {}
    for lineno, name, labels, value in samples:
        family = _family_of(name, types)
        if family not in helps:
            problems.append(f"line {lineno}: {name} has no # HELP ({family})")
        if family not in types:
            problems.append(f"line {lineno}: {name} has no # TYPE ({family})")
        key = (name, tuple(sorted(labels.items())))
        if key in seen_series:
            problems.append(f"line {lineno}: duplicate series {name}{labels}")
        seen_series.add(key)
        if types.get(family) == "histogram":
            if name == family + "_bucket":
                le = labels.get("le")
                if le is None:
                    problems.append(
                        f"line {lineno}: histogram bucket without le label")
                else:
                    hist_buckets.setdefault(family, []).append((le, value))
            elif name == family + "_count":
                hist_counts[family] = value
            elif name not in (family + "_sum",):
                problems.append(
                    f"line {lineno}: unexpected histogram sample {name}")

    for family, mtype in types.items():
        if mtype != "histogram":
            continue
        buckets = hist_buckets.get(family)
        if not buckets:
            problems.append(f"histogram {family}: no _bucket samples")
            continue
        if buckets[-1][0] != "+Inf":
            problems.append(
                f"histogram {family}: buckets do not end in le=\"+Inf\" "
                f"(last le={buckets[-1][0]!r})")
        prev_le, prev_count = None, None
        for le, count in buckets:
            le_f = float("inf") if le == "+Inf" else float(le)
            if prev_le is not None:
                if le_f <= prev_le:
                    problems.append(
                        f"histogram {family}: le={le} out of order")
                if count < prev_count:
                    problems.append(
                        f"histogram {family}: bucket counts not cumulative "
                        f"(le={le} count {count} < {prev_count})")
            prev_le, prev_count = le_f, count
        if family in hist_counts and buckets[-1][1] != hist_counts[family]:
            problems.append(
                f"histogram {family}: _count {hist_counts[family]} != "
                f"+Inf bucket {buckets[-1][1]}")

    return problems
