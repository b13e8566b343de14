"""Shared pieces of the fleet's CPU tests (router, supervisor, gateway,
control): JAX engines that serve beside the port's, and small HTTP helpers.

The JAX package's ``CompileWatcher.stop`` calls a private jax hook that
jax 0.9.0 no longer has, so a JAX engine (and a JAX gateway) would raise
from it on the way out. Both build their watcher only when none is set
(``ServingEngine.start``, ``ServingGateway.start``), so the tests hand them
:class:`NullCompileWatcher` first; nothing in the JAX package changes."""

import json
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import torch

from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu_torch.serving import ServingEngine

from torch_serving_common import WAIT


class NullCompileWatcher:
    """Stands in for the JAX ``CompileWatcher``: counts nothing, stops
    cleanly."""

    events: list = []

    def start(self):
        return self

    def stop(self):
        pass

    def reset(self):
        pass

    def summary(self):
        return {"compile_events": 0, "compile_secs": 0.0, "compilation_cache_hits": 0}


def jax_engine(module, params, **kw):
    """A started JAX engine (f32 cache) with the null watcher."""
    kw.setdefault("cache_dtype", jnp.float32)
    engine = JaxServingEngine(module, params, autostart=False, **kw)
    engine._compile_watcher = NullCompileWatcher()
    engine.start()
    return engine


def port_engine(model, **kw):
    """A started CPU engine of the port (f32 cache)."""
    kw.setdefault("cache_dtype", torch.float32)
    return ServingEngine(model, device="cpu", **kw)


def wait_for(predicate, timeout=WAIT, what="condition"):
    """Poll ``predicate`` until it holds; fail after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout}s waiting for {what}")
        time.sleep(0.01)


def post(url, payload, timeout=WAIT, headers=None, raw=None, path="/v1/completions"):
    """POST ``path``: ``(status, body, headers)``; the body parsed as JSON,
    or left as text for an event stream."""
    data = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = resp.read().decode()
            ctype = resp.headers.get("Content-Type", "")
            return (resp.status, body if "event-stream" in ctype else json.loads(body),
                    dict(resp.headers))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def get(url, path, timeout=WAIT):
    """GET ``path``: ``(status, text, headers)``."""
    try:
        with urllib.request.urlopen(url + path, timeout=timeout) as resp:
            return resp.status, resp.read().decode(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


def families(text):
    """The metric families a ``/metrics`` body declares."""
    return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")}


def samples(text):
    """Unlabelled samples of a ``/metrics`` body: ``{name: value}``."""
    return {line.split()[0]: float(line.split()[1]) for line in text.splitlines()
            if line and not line.startswith("#") and "{" not in line}


def sse_events(text):
    """The JSON events of an SSE body, in order."""
    return [json.loads(block[len("data: "):]) for block in text.split("\n\n")
            if block.startswith("data: ")]
