"""Turn raw per-stream results into the open-loop serving report.

Counterpart of ``accelerate_tpu/loadgen/report.py``. The report is the
contract between the harness and everything that consumes it —
``chip_smoke.py`` (phase 4e), the ``accelerate-tpu-torch loadtest`` CLI,
and the conformance tests —
so it is plain JSON-serialisable data with explicit conventions:

* Latency percentiles are computed over **offered** streams, not
  completed ones: a stream the saturated server refused (or never
  finished) has unbounded TTFT. Unbounded values surface two ways —
  ``None`` in the honest percentiles plus an ``unbounded_fraction``,
  and finite ``*_clamped`` twins (unbounded replaced by ``clamp_s``)
  for guard ratios and trajectory payloads that need numbers.
* Every stream lands in exactly ONE outcome bucket, so
  ``sum(outcomes.values()) == offered.n`` is the token-accounting
  balance the conformance tests assert.
"""

from __future__ import annotations

import math
from typing import Optional

__all__ = ["percentile", "build_report"]

#: non-2xx codes that are *structured* refusals — anything else under
#: overload is a conformance failure.
_STRUCTURED = (408, 429, 503)
#: of those, the ones that must carry a bounded Retry-After.
_NEEDS_RETRY_AFTER = (429, 503)


def percentile(values, q: float) -> Optional[float]:
    """Nearest-rank percentile (q in [0, 100]) tolerant of ``inf``
    entries; returns None for an empty list and ``inf`` stays ``inf``
    (callers decide how to serialise it)."""
    vals = sorted(values)
    if not vals:
        return None
    if not 0 <= q <= 100:
        raise ValueError("q must be in [0, 100]")
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return float(vals[rank - 1])


def _pcts(values, clamp_s: Optional[float]) -> dict:
    """{p50, p99, p999, mean} twice: honest (None for unbounded) and
    clamped (inf -> clamp_s, always finite when clamp_s given)."""
    def scrub(v):
        return None if v is None or math.isinf(v) else v

    out = {}
    for name, q in (("p50", 50.0), ("p99", 99.0), ("p999", 99.9)):
        out[name] = scrub(percentile(values, q))
    finite = [v for v in values if not math.isinf(v)]
    out["mean"] = (sum(finite) / len(finite)) if finite else None
    out["unbounded_fraction"] = (
        (len(values) - len(finite)) / len(values) if values else 0.0)
    if clamp_s is not None:
        clamped = [min(v, clamp_s) for v in values]
        for name, q in (("p50", 50.0), ("p99", 99.0), ("p999", 99.9)):
            out[f"{name}_clamped"] = percentile(clamped, q)
    return out


def _bucket(r) -> str:
    """The one outcome bucket a stream belongs to (precedence order)."""
    if r.code is None:
        return "connect_error"
    if not 200 <= r.code < 300:
        return f"http_{r.code}"
    if r.aborted:
        return "aborted"
    if r.truncated:
        return "truncated_sse"
    if r.done is None:
        return "no_summary"  # JSON (non-stream) body missing — a bug
    status = r.done.get("status")
    return "completed" if status == "completed" else f"stream_{status}"


def build_report(run: dict, schedule, profile=None, *,
                 slo_ttft_s: Optional[float] = None,
                 clamp_s: Optional[float] = None,
                 server_metrics: Optional[dict] = None) -> dict:
    """Build the JSON report from a :func:`~.generator.run_open_loop`
    result. ``slo_ttft_s`` defines goodput (completions whose TTFT met
    the SLO, per second of wall time); ``clamp_s`` bounds the clamped
    percentile twins (defaults to the run's wall time)."""
    results = run["results"]
    n = len(results)
    if clamp_s is None:
        clamp_s = run.get("wall_s")
    outcomes: dict = {}
    for r in results:
        b = _bucket(r)
        outcomes[b] = outcomes.get(b, 0) + 1
    completed = [r for r in results if r.completed]

    # -- latency over OFFERED streams -------------------------------------
    inf = float("inf")
    ttfts = [r.ttft_s if r.ttft_s is not None else inf for r in results]
    itls: list = []
    for r in results:
        itls.extend(r.token_gaps_s)

    # -- goodput -----------------------------------------------------------
    def met_slo(r) -> bool:
        if slo_ttft_s is None:
            return True
        return r.ttft_s is not None and r.ttft_s <= slo_ttft_s

    good = sum(1 for r in completed if met_slo(r))
    wall = float(run.get("wall_s") or 0.0) or None

    # -- conformance -------------------------------------------------------
    non2xx = [r for r in results
              if r.code is not None and not 200 <= r.code < 300]
    unstructured = [r for r in non2xx if r.code not in _STRUCTURED]
    missing_retry = [r for r in non2xx
                     if r.code in _NEEDS_RETRY_AFTER
                     and (r.retry_after_s is None or r.retry_after_s < 0)]
    retry_afters = [r.retry_after_s for r in non2xx
                    if r.retry_after_s is not None and r.retry_after_s >= 0]
    # Token accounting: the gateway's final summary repeats the full
    # token list, so streamed-vs-summary mismatch means a duplicated or
    # lost SSE token event.
    token_mismatches = sum(
        1 for r in completed
        if r.done.get("tokens") is not None
        and r.tokens != [int(t) for t in r.done["tokens"]])

    # -- per-priority-class breakdown --------------------------------------
    # Keyed on the class each request DECLARED (the body's "priority";
    # requests without one land under "_none") — the legibility layer for
    # SLO claims: one run shows interactive's clamped tail next to
    # batch's, over offered streams per class like the headline numbers.
    def _class_of(r) -> str:
        body = r.request or {}
        return body.get("priority") or "_none"

    per_priority: dict = {}
    for r in results:
        per_priority.setdefault(_class_of(r), []).append(r)
    priority_report = {}
    for cls in sorted(per_priority):
        rs = per_priority[cls]
        cls_completed = [r for r in rs if r.completed]
        cls_good = sum(1 for r in cls_completed if met_slo(r))
        cls_ttfts = [r.ttft_s if r.ttft_s is not None else inf for r in rs]
        cls_itls: list = []
        for r in rs:
            cls_itls.extend(r.token_gaps_s)
        priority_report[cls] = {
            "offered": len(rs),
            "completed": len(cls_completed),
            "within_slo": cls_good,
            "goodput_rps": (cls_good / wall) if wall else None,
            "ttft_s": _pcts(cls_ttfts, clamp_s),
            "itl_s": _pcts(cls_itls, clamp_s),
        }

    report = {
        "offered": dict(schedule.describe(),
                        **({"profile": profile.describe()}
                           if profile is not None else {})),
        "run": {
            "wall_s": run.get("wall_s"),
            "process_cpu_s": run.get("process_cpu_s"),
            "host_cpu_s_per_stream": (
                run["process_cpu_s"] / n
                if run.get("process_cpu_s") is not None and n else None),
        },
        "outcomes": outcomes,
        "counters_balance": sum(outcomes.values()) == n,
        "goodput": {
            "slo_ttft_s": slo_ttft_s,
            "completed": len(completed),
            "within_slo": good,
            "goodput_rps": (good / wall) if wall else None,
        },
        "ttft_s": _pcts(ttfts, clamp_s),
        "itl_s": _pcts(itls, clamp_s),
        "per_priority": priority_report,
        "conformance": {
            "non_2xx": len(non2xx),
            "unstructured_non_2xx": len(unstructured),
            "missing_retry_after": len(missing_retry),
            "max_retry_after_s": max(retry_afters, default=None),
            "truncated_sse": outcomes.get("truncated_sse", 0),
            "token_mismatches": token_mismatches,
            "heartbeats": sum(r.heartbeats for r in results),
        },
    }
    if server_metrics:
        report["server_metrics"] = dict(server_metrics)
    return report
