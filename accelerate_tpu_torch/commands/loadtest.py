"""``accelerate-tpu-torch loadtest`` — open-loop SSE load against a gateway.

Counterpart of ``accelerate_tpu/commands/loadtest.py``. Drives a seeded
:mod:`accelerate_tpu_torch.loadgen` schedule (heavy-tailed inter-arrivals
and request shapes) from one asyncio client against either a running
gateway (``--url``) or a self-hosted tiny-model fleet (the default — the
demo/smoke path, same as ``accelerate-tpu-torch serve --model tiny``; on
``cuda`` unless ``--device cpu``), then prints the JSON report: goodput, p50/p99/p99.9
TTFT and ITL measured from each stream's *scheduled* arrival, a
per-priority-class breakdown (goodput and latency tails per declared
traffic class — the SLO-control legibility view), 429/Retry-After
conformance, token-accounting balance, and host CPU per stream.

``--check`` turns conformance into the exit code: non-zero when any
non-2xx was unstructured, a 429/503 lacked a bounded ``Retry-After``,
an SSE body was truncated, or streamed tokens disagreed with the final
summary — the same gate the overload tests pin.
"""

from __future__ import annotations

import argparse
import json
import sys


def _parse_priorities(spec: str):
    """``"interactive=0.2,batch=0.8"`` -> ``(("interactive", 0.2), ...)``."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, eq, weight = part.partition("=")
        try:
            w = float(weight)
        except ValueError:
            w = -1.0
        if not eq or not name.strip() or w <= 0:
            raise SystemExit(
                f"--priorities: expected CLASS=WEIGHT[,CLASS=WEIGHT...] "
                f"with positive weights (got {part!r})")
        out.append((name.strip(), w))
    if not out:
        raise SystemExit("--priorities: no classes given")
    return tuple(out)


def loadtest_command(args) -> int:
    from ..loadgen import (
        ArrivalSchedule,
        TrafficProfile,
        build_report,
        fetch_gateway_metrics,
        run_open_loop,
    )

    gw = None
    url = args.url
    if url is None:
        import torch

        from ..models.llama import LlamaConfig, LlamaForCausalLM
        from ..serving import (
            GatewayConfig,
            ReplicaSet,
            ServingEngine,
            ServingGateway,
        )
        from ..utils.device import resolve_device

        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            raise SystemExit(f"loadtest: {e} (--device cpu self-hosts on the "
                             "CPU)") from None
        gen = torch.Generator(device=device).manual_seed(args.seed)
        model = LlamaForCausalLM(LlamaConfig.tiny(), device=device,
                                 generator=gen).eval()
        print(f"self-hosting {args.replicas} tiny replica(s) on {device} "
              f"({args.server} front end) ...", file=sys.stderr, flush=True)
        rs = ReplicaSet.from_factory(
            lambda: ServingEngine(
                model, max_slots=args.max_slots, max_len=args.max_len,
                max_queued=max(64, 2 * args.n_streams), device=device),
            args.replicas)
        gw = ServingGateway(rs, config=GatewayConfig(server=args.server,
                                                     port=0))
        gw.start()
        url = gw.url
    sched = ArrivalSchedule(args.n_streams, 1.0 / args.rps,
                            dist=args.dist, sigma=args.sigma,
                            alpha=args.alpha, seed=args.seed)
    profile_kw = {}
    if args.priorities is not None:
        profile_kw["priorities"] = _parse_priorities(args.priorities)
    profile = TrafficProfile(
        prompt_len_median=args.prompt_len, prompt_len_max=args.prompt_max,
        out_tokens_median=args.out_tokens, out_tokens_max=args.out_max,
        sampled_fraction=args.sampled_fraction, timeout_s=args.timeout,
        seed=args.seed + 1, **profile_kw)
    try:
        run = run_open_loop(url, sched, profile,
                            vocab_size=args.vocab_size,
                            wall_deadline_s=args.wall_deadline)
        try:
            metrics = fetch_gateway_metrics(url)
        except Exception:  # noqa: BLE001 - a dead server still reports
            metrics = None
        report = build_report(run, sched, profile,
                              slo_ttft_s=args.slo_ttft,
                              clamp_s=args.wall_deadline,
                              server_metrics=metrics)
    finally:
        if gw is not None:
            gw.shutdown(drain=False)
    text = json.dumps(report, indent=2, sort_keys=True)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text + "\n")
        print(f"wrote {args.output}", file=sys.stderr)
    else:
        print(text)
    conf = report["conformance"]
    ok = (conf["unstructured_non_2xx"] == 0
          and conf["missing_retry_after"] == 0
          and conf["truncated_sse"] == 0
          and conf["token_mismatches"] == 0
          and report["counters_balance"])
    print(f"offered {sched.n} streams @ {sched.offered_rps:.1f} rps -> "
          f"{report['goodput']['completed']} completed, "
          f"{conf['non_2xx']} refused, conformance "
          f"{'OK' if ok else 'VIOLATED'}", file=sys.stderr)

    def _ms(v):
        return "-" if v is None else f"{v * 1e3:.0f}ms"

    for cls, pr in sorted(report.get("per_priority", {}).items()):
        print(f"  class {cls}: {pr['completed']}/{pr['offered']} completed, "
              f"{pr['within_slo']} within SLO, "
              f"ttft p50 {_ms(pr['ttft_s'].get('p50_clamped'))} "
              f"p99 {_ms(pr['ttft_s'].get('p99_clamped'))}, "
              f"itl p50 {_ms(pr['itl_s'].get('p50_clamped'))} "
              f"p99 {_ms(pr['itl_s'].get('p99_clamped'))} (clamped)",
              file=sys.stderr)
    return 0 if (ok or not args.check) else 1


def loadtest_command_parser(subparsers=None):
    help_ = ("Open-loop SSE load (heavy-tailed arrivals) against a "
             "serving gateway; prints the goodput/TTFT/conformance "
             "JSON report")
    if subparsers is not None:
        parser = subparsers.add_parser("loadtest", description=help_,
                                       help=help_)
    else:
        parser = argparse.ArgumentParser("accelerate-tpu-torch loadtest",
                                         description=help_)
    parser.add_argument("--url", default=None,
                        help="Target gateway base URL (e.g. "
                             "http://127.0.0.1:8000); omitted -> "
                             "self-host a tiny-model fleet")
    parser.add_argument("--server", default="asyncio",
                        choices=("asyncio", "threading"),
                        help="Self-hosted front end (ignored with --url)")
    parser.add_argument("--replicas", type=int, default=1,
                        help="Self-hosted replica count")
    parser.add_argument("--device", default=None,
                        help="Self-hosted fleet's device (default cuda; "
                             "'cpu' to self-host on the CPU)")
    parser.add_argument("--max-slots", type=int, default=4,
                        help="Self-hosted decode slots per replica")
    parser.add_argument("--max-len", type=int, default=128,
                        help="Self-hosted per-slot max sequence length")
    parser.add_argument("--n-streams", type=int, default=200,
                        help="Streams to schedule")
    parser.add_argument("--rps", type=float, default=50.0,
                        help="Target offered arrival rate "
                             "(1/mean inter-arrival)")
    parser.add_argument("--dist", default="lognormal",
                        choices=("lognormal", "pareto", "uniform"),
                        help="Inter-arrival distribution")
    parser.add_argument("--sigma", type=float, default=1.0,
                        help="Lognormal burstiness (log-space sigma)")
    parser.add_argument("--alpha", type=float, default=1.5,
                        help="Pareto tail index (>1)")
    parser.add_argument("--prompt-len", type=int, default=16,
                        help="Median prompt length (lognormal tail)")
    parser.add_argument("--prompt-max", type=int, default=64,
                        help="Prompt length clip")
    parser.add_argument("--out-tokens", type=int, default=12,
                        help="Median max_new_tokens (lognormal tail)")
    parser.add_argument("--out-max", type=int, default=48,
                        help="max_new_tokens clip")
    parser.add_argument("--priorities", default=None,
                        metavar="CLASS=WEIGHT[,...]",
                        help="Traffic-class mix, e.g. "
                             "'interactive=0.2,batch=0.8' (default: the "
                             "profile's 80/20 interactive/batch split); "
                             "the report breaks goodput and latency "
                             "tails out per class")
    parser.add_argument("--sampled-fraction", type=float, default=0.5,
                        help="Fraction of requests with a sampling seed")
    parser.add_argument("--vocab-size", type=int, default=256,
                        help="Prompt token-id range (match the model)")
    parser.add_argument("--timeout", type=float, default=None,
                        help="Per-request deadline forwarded in the body")
    parser.add_argument("--slo-ttft", type=float, default=2.0,
                        help="Goodput SLO: TTFT bound (s) from scheduled "
                             "arrival")
    parser.add_argument("--wall-deadline", type=float, default=120.0,
                        help="Abort streams still open after this many "
                             "seconds (bounds the run; aborted streams "
                             "count as not completed)")
    parser.add_argument("--seed", type=int, default=0,
                        help="Schedule/profile RNG seed")
    parser.add_argument("--output", default=None,
                        help="Write the JSON report here instead of stdout")
    parser.add_argument("--check", action="store_true",
                        help="Exit non-zero on any overload-conformance "
                             "violation (unstructured non-2xx, missing "
                             "Retry-After, truncated SSE, token mismatch)")
    if subparsers is not None:
        parser.set_defaults(func=loadtest_command)
    return parser
