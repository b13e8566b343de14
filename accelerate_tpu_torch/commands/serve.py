"""`accelerate-tpu-torch serve` — launch the HTTP serving gateway over N
continuous-batching engine replicas on one CUDA card.

Counterpart of ``accelerate_tpu/commands/serve.py``. Two ways to point it
at a model:

* ``--model tiny`` — a tiny Llama with random weights drawn from
  ``--seed``: the demo/smoke path, enough to exercise the full HTTP
  surface.
* ``--model pkg.mod:factory`` — an import path to a zero-arg callable
  returning a port ``LlamaForCausalLM`` on the serving device. The port's
  model holds its own weights, so the factory returns the model alone
  (the JAX command's factory returns ``(model, params)``); every replica
  serves that one model, each from its own engine.

It runs on ``cuda`` unless ``--device cpu`` is given: without a card and
without that flag it exits with an error. The process serves until
SIGTERM/SIGINT, then drains gracefully: readyz goes 503, in-flight
streams finish, replicas shut down, and the process exits 0.
"""

from __future__ import annotations

import argparse
import importlib
import time


def _resolve_device(args):
    from ..utils.device import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"serve: {e} (--device cpu serves on the CPU)") from None


def _resolve_model(spec: str, args, device):
    import torch

    from ..models.llama import LlamaConfig, LlamaForCausalLM

    if spec == "tiny":
        gen = torch.Generator(device=device).manual_seed(args.seed)
        return LlamaForCausalLM(LlamaConfig.tiny(), device=device, generator=gen).eval()
    if ":" not in spec:
        raise SystemExit(
            f"--model must be 'tiny' or 'pkg.mod:factory' (got {spec!r})")
    mod_name, _, attr = spec.partition(":")
    factory = getattr(importlib.import_module(mod_name), attr)
    model = factory()
    if not isinstance(model, LlamaForCausalLM):
        raise SystemExit(
            f"{spec} must return an accelerate_tpu_torch LlamaForCausalLM "
            f"(got {type(model).__name__})")
    return model


def _parse_adapter_specs(specs):
    """``--adapter NAME=PATH`` pairs → list of (name, path)."""
    out = []
    for spec in specs or ():
        name, sep, path = spec.partition("=")
        if not sep or not name or not path:
            raise SystemExit(
                f"--adapter must be NAME=PATH (got {spec!r})")
        out.append((name, path))
    return out


def _parse_tenant_floats(specs, flag: str, what: str):
    """``NAME=FLOAT`` pairs → dict (None when no pairs). ``*`` is the
    wildcard tenant (default for anyone unlisted); ``_base`` is
    base-model traffic."""
    out = {}
    for spec in specs or ():
        name, sep, val = spec.partition("=")
        if not sep or not name:
            raise SystemExit(f"{flag} must be TENANT={what} (got {spec!r})")
        try:
            out[name] = float(val)
        except ValueError:
            raise SystemExit(
                f"{flag}: {what} must be a number (got {spec!r})") from None
        if out[name] <= 0:
            raise SystemExit(f"{flag}: {what} must be > 0 (got {spec!r})")
    return out or None


def serve_command(args) -> int:
    from ..serving import (
        FleetSupervisor,
        GatewayConfig,
        ReplicaSet,
        ServingEngine,
        ServingGateway,
    )

    # Validate cheap usage errors before any model build/warmup.
    # --autoscale-max turns the fixed fleet into a min..max elastic one:
    # `autoscale_min` replicas run, the rest sit PARKED (factory retained,
    # no engine) until the supervisor's autoscaler unparks them.
    autoscale = args.autoscale_max is not None
    if autoscale:
        autoscale_min = (args.autoscale_min if args.autoscale_min is not None
                         else 1)
        if autoscale_min < 1:
            raise SystemExit("--autoscale-min must be >= 1")
        if args.autoscale_max < autoscale_min:
            raise SystemExit("--autoscale-max must be >= --autoscale-min")
        n_build = autoscale_min
    else:
        autoscale_min = args.replicas
        n_build = args.replicas
    rate_limits = _parse_tenant_floats(args.rate_limit, "--rate-limit", "RPS")
    fair_share = _parse_tenant_floats(args.fair_share, "--fair-share",
                                      "WEIGHT")
    if args.tp > 1:
        raise SystemExit("--tp > 1 (tensor-parallel slices) is not ported to "
                         "the PyTorch fleet yet (ROADMAP.md, A8)")
    device = _resolve_device(args)

    model = _resolve_model(args.model, args, device)
    adapter_specs = _parse_adapter_specs(args.adapter)
    max_adapters = args.max_adapters
    if adapter_specs and max_adapters < 2:
        # Preloading adapters implies multi-tenant serving; size the bank
        # to fit them all (plus the reserved base row) if not asked for.
        max_adapters = len(adapter_specs) + 1

    def make_bank():
        if max_adapters < 2:
            return None
        from ..adapters import AdapterBank, LoRAConfig

        return AdapterBank(model, config=LoRAConfig(rank=args.lora_rank),
                           max_adapters=max_adapters)

    paging = dict(paged=(False if args.no_paged else None),
                  page_size=args.page_size, max_pages=args.max_pages,
                  kv_dtype=args.kv_dtype, weights_dtype=args.weights_dtype)
    spec = {}
    if args.draft_model:
        spec = dict(draft_model=_resolve_model(args.draft_model, args, device),
                    spec_tokens=args.spec_tokens)
    elif args.spec_lookup:
        spec = dict(spec_lookup=args.spec_lookup,
                    spec_tokens=args.spec_tokens)

    priority_policy = "default" if args.priority_preemption else None

    def factory():
        # Every replica serves the same model: the weights are on the card
        # once, each engine keeps its own pool, graphs and stream.
        return ServingEngine(
            model, max_slots=args.max_slots, max_len=args.max_len,
            max_queued=args.max_queued, eos_token_id=args.eos_token_id,
            prefill_chunk=args.prefill_chunk,
            prefix_cache_mb=args.prefix_cache_mb,
            priority_policy=priority_policy,
            adapters=make_bank(), trace_dir=args.trace_dir, device=device,
            **paging, **spec)

    print(f"warming up {n_build} replica(s) on {device} "
          f"(slots={args.max_slots}, max_len={args.max_len}, "
          f"chunk={args.prefill_chunk}"
          + (f", kv={args.kv_dtype}" if args.kv_dtype else "")
          + (f", weights={args.weights_dtype}" if args.weights_dtype else "")
          + (f", adapters={max_adapters - 1}" if max_adapters >= 2 else "")
          + (f", spec=draft K={args.spec_tokens}" if args.draft_model
             else "")
          + (f", spec=lookup n={args.spec_lookup} K={args.spec_tokens}"
             if args.spec_lookup else "")
          + ") ...", flush=True)
    replica_set = ReplicaSet.from_factory(factory, n_build)
    if autoscale:
        for _ in range(args.autoscale_max - autoscale_min):
            replica_set.add_parked(factory)
    if adapter_specs:
        from ..adapters import load_adapter

        for name, path in adapter_specs:
            adapter, meta = load_adapter(path)
            replica_set.register_adapter(name, adapter)
            print(f"registered adapter {name!r} from {path} "
                  f"(rank {meta.get('rank', '?')})", flush=True)
    gateway = ServingGateway(
        replica_set,
        config=GatewayConfig(host=args.host, port=args.port,
                             default_max_new_tokens=args.default_max_new_tokens,
                             max_connections=args.max_connections,
                             rate_limits=rate_limits,
                             fair_share_weights=fair_share))
    gateway.start()
    gateway.install_signal_handlers()
    supervisor = None
    if args.supervise or autoscale:
        autoscaler = None
        if autoscale:
            from ..serving import AutoscaleConfig, FleetAutoscaler

            autoscaler = FleetAutoscaler(
                replica_set,
                config=AutoscaleConfig(min_replicas=autoscale_min,
                                       max_replicas=args.autoscale_max))
        supervisor = FleetSupervisor(
            replica_set, hang_timeout_s=args.hang_timeout,
            max_restarts=args.max_restarts, autoscaler=autoscaler)
        supervisor.start()
        print(f"supervisor on (hang_timeout={args.hang_timeout:g}s, "
              f"max_restarts={args.max_restarts} before the circuit "
              "breaker parks a replica"
              + (f", autoscale {autoscale_min}..{args.autoscale_max}"
                 if autoscale else "")
              + ")", flush=True)
    print(f"serving on {gateway.url}  "
          "(POST /v1/completions, GET /healthz /readyz /metrics "
          "/debug/trace)",
          flush=True)
    print("press Ctrl-C (or send SIGTERM) to drain and exit",
          flush=True)
    try:
        while gateway._server is not None:
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    if supervisor is not None:
        supervisor.stop()  # before replica shutdown: no restarts of drained engines
    gateway.shutdown(drain=True)  # idempotent; covers the no-signal path
    print("gateway drained; bye", flush=True)
    return 0


def serve_command_parser(subparsers=None):
    description = ("Serve a model over HTTP: continuous-batching engine "
                   "replicas behind a routing gateway")
    if subparsers is not None:
        parser = subparsers.add_parser("serve", description=description)
    else:
        parser = argparse.ArgumentParser("accelerate-tpu-torch serve",
                                         description=description)
    parser.add_argument("--model", default="tiny",
                        help="'tiny' (random demo model) or 'pkg.mod:factory' "
                             "returning an accelerate_tpu_torch "
                             "LlamaForCausalLM on the serving device (the "
                             "model holds its weights: no params)")
    parser.add_argument("--device", default=None,
                        help="Serving device (default cuda; without a card "
                             "the command exits with an error unless "
                             "'--device cpu' is given)")
    parser.add_argument("--replicas", type=int, default=1,
                        help="Engine replicas behind the gateway")
    parser.add_argument("--tp", type=int, default=1,
                        help="Tensor-parallel width per replica; only 1 is "
                             "ported (ROADMAP.md, A8)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000,
                        help="TCP port (0 = OS-assigned ephemeral)")
    parser.add_argument("--max-slots", type=int, default=4,
                        help="Decode lanes per replica")
    parser.add_argument("--max-len", type=int, default=128,
                        help="Per-slot KV capacity (prompt + new tokens)")
    parser.add_argument("--max-queued", type=int, default=64,
                        help="Admission queue bound per replica")
    parser.add_argument("--prefill-chunk", type=int, default=32,
                        help="Chunked-prefill width")
    parser.add_argument("--prefix-cache-mb", type=float, default=64.0,
                        help="Prefix KV cache budget per replica (0 = off)")
    parser.add_argument("--page-size", type=int, default=None,
                        help="Tokens per KV page (default: prefill chunk, so "
                             "prefix-cache blocks alias onto pages 1:1; must "
                             "divide the chunk)")
    parser.add_argument("--max-pages", type=int, default=None,
                        help="KV pool pages per replica (default: enough for "
                             "every slot at max_len — same memory as dense; "
                             "lower it to oversubscribe capacity and rely on "
                             "preemption under pressure)")
    parser.add_argument("--no-paged", action="store_true",
                        help="Use the dense per-slot KV layout instead of "
                             "the paged pool (the pre-paging engine; also "
                             "the A/B baseline)")
    parser.add_argument("--kv-dtype", default=None, choices=["int8"],
                        help="Store KV pages quantized (per-page scales): "
                             "~2x concurrent streams from the same pool "
                             "bytes at bounded logprob divergence; omit for "
                             "the bit-exact full-precision pool (paged "
                             "engines only)")
    parser.add_argument("--weights-dtype", default=None, choices=["int8"],
                        help="Store base weights per-channel int8, "
                             "dequantized on the fly (LoRA adapters stay "
                             "full precision and exact); omit for "
                             "full-precision weights")
    parser.add_argument("--eos-token-id", type=int, default=None)
    parser.add_argument("--default-max-new-tokens", type=int, default=32,
                        help="Used when a request omits max_new_tokens")
    parser.add_argument("--max-connections", type=int, default=64,
                        help="Concurrent in-flight HTTP exchanges")
    parser.add_argument("--seed", type=int, default=0,
                        help="Weight seed for --model tiny")
    parser.add_argument("--max-adapters", type=int, default=0,
                        help="Device LoRA bank rows per replica, incl. the "
                             "reserved base row (0/1 = no adapter bank; "
                             ">= 2 enables multi-tenant serving)")
    parser.add_argument("--lora-rank", type=int, default=8,
                        help="Bank rank ceiling: registered adapters of any "
                             "lower rank are zero-padded up to it")
    parser.add_argument("--adapter", action="append", metavar="NAME=PATH",
                        help="Preload a saved adapter (save_adapter dir) "
                             "under NAME on every replica; repeatable. "
                             "Implies an adapter bank sized to fit")
    parser.add_argument("--priority-preemption",
                        action=argparse.BooleanOptionalAction, default=True,
                        help="Act on per-request priority classes "
                             "(interactive/standard/batch): priority "
                             "admission queues and lowest-class-first "
                             "preemption victim selection. "
                             "--no-priority-preemption reverts to "
                             "measurement-only FCFS (the A/B baseline)")
    parser.add_argument("--rate-limit", action="append",
                        metavar="TENANT=RPS",
                        help="Per-tenant token-bucket rate limit at the "
                             "gateway (tenant = adapter name, '_base' for "
                             "base-model traffic, '*' for everyone "
                             "unlisted); repeatable. Over-limit requests "
                             "get a structured 429 with Retry-After from "
                             "bucket refill time")
    parser.add_argument("--fair-share", action="append",
                        metavar="TENANT=WEIGHT",
                        help="Weighted fair-share admission under pressure "
                             "(work-conserving: only binds near capacity); "
                             "tenants as for --rate-limit, default weight "
                             "1.0; repeatable")
    parser.add_argument("--autoscale-min", type=int, default=None,
                        help="Elastic fleet floor: replicas kept running "
                             "(default 1 when --autoscale-max is set; "
                             "ignored otherwise)")
    parser.add_argument("--autoscale-max", type=int, default=None,
                        help="Elastic fleet ceiling: surplus replicas sit "
                             "PARKED (factory retained, engine released) "
                             "until queue depth or standing page pressure "
                             "makes the supervisor's autoscaler unpark "
                             "them; idle replicas drain back down. Implies "
                             "--supervise; overrides --replicas")
    parser.add_argument("--supervise", action="store_true",
                        help="Run a FleetSupervisor over the replicas: "
                             "heartbeat watchdog fencing hung engines, "
                             "auto-restart of failed replicas (rebuild + "
                             "re-warm + adapter re-registration), and a "
                             "crash-loop circuit breaker")
    parser.add_argument("--hang-timeout", type=float, default=10.0,
                        help="Supervisor watchdog: heartbeat silence (s) "
                             "past which a live, error-less replica is "
                             "fenced as hung")
    parser.add_argument("--max-restarts", type=int, default=3,
                        help="Supervisor circuit breaker: restart attempts "
                             "per replica within the window before it is "
                             "parked in CRASH_LOOP")
    parser.add_argument("--draft-model", default=None,
                        help="Speculative decoding draft: 'tiny' or "
                             "'pkg.mod:factory' returning a model with the "
                             "SAME vocab as --model; every replica then "
                             "decodes speculatively (paged engines only; "
                             "composes with sampling, adapters, and the "
                             "prefix cache)")
    parser.add_argument("--spec-tokens", type=int, default=4,
                        help="Proposed tokens per speculative verify step "
                             "(K); used with --draft-model or --spec-lookup")
    parser.add_argument("--spec-lookup", type=int, default=None,
                        help="Draft-FREE prompt-lookup speculation: n-gram "
                             "width matched against each stream's "
                             "prompt+output to propose the next K tokens "
                             "(mutually exclusive with --draft-model; "
                             "strongest on doc/RAG traffic that repeats "
                             "its prompt)")
    parser.add_argument("--trace-dir", default=None,
                        help="Directory each replica dumps its Chrome-trace "
                             "span buffer and flight-recorder events into on "
                             "shutdown (and automatically on a fatal engine "
                             "error); live traces are also at GET "
                             "/debug/trace?id=<trace_id>")
    if subparsers is not None:
        parser.set_defaults(func=serve_command)
    return parser
