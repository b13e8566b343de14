"""Deterministic fault injection for serving engines.

Counterpart of ``accelerate_tpu/serving/chaos.py``, the same script run
by the PyTorch engine. A :class:`ChaosSchedule` is a script of faults
keyed on the engine's **decode-tick counter** — the clock that advances
with token progress — so a fault fires at exactly the same point in the token stream on every
run, regardless of host speed. The engine applies the schedule at the
top of every run-loop iteration (``ServingEngine(chaos=...)``), which
gives three primitives:

* **kill** — at tick T, raise through the engine's existing fault
  injection (:meth:`~.engine.ServingEngine.kill`): the run loop dies
  through its normal fatal path, every in-flight and queued request is
  retired FAILED, and the router fails them over token-exact. The
  injected error is a :class:`ChaosKilled` so postmortems distinguish
  scripted deaths from real ones.
* **hang** — at tick T, freeze the engine's published heartbeat for a
  duration while the loop keeps serving. To a
  :class:`~.supervisor.FleetSupervisor` watchdog this is
  indistinguishable from a wedged graph replay (`engine.error` stays
  None, the heartbeat stalls), which is precisely the failure mode lazy
  health checks can never catch — the watchdog must fence on liveness
  alone.
* **slow** — between ticks T0 and T1, sleep ``delay_s`` per loop
  iteration: degraded-but-alive, the gray-failure mode that stresses
  deadline handling and drain-rate estimation without killing anything.
* **wedge** — at tick T, stall the engine INSIDE the next reconcile
  barrier of a LAUNCHED tick for ``duration_s``, before its sync: unlike
  ``hang`` (which fakes a stall by freezing the published heartbeat
  while the loop serves on), a wedge genuinely stops the loop mid
  device-wait — the case the async runtime's one-tick-ahead dispatch
  makes interesting, because the heartbeat republished at the reconcile
  barrier is what keeps a watchdog's detection latency within
  ``hang_timeout_s`` there.

Schedules are engine-thread only once attached (the engine calls
:meth:`apply` from its run loop); build and attach them before
``start()``. One schedule drives one engine — faults carry fired-state.
"""

from __future__ import annotations

import time
from typing import Optional

__all__ = ["ChaosKilled", "ChaosSchedule"]


class ChaosKilled(RuntimeError):
    """The error a scripted :meth:`ChaosSchedule.kill` injects — lets
    tests and postmortems tell a chaos-harness death from a real one."""


class ChaosSchedule:
    """A deterministic script of engine faults keyed on decode ticks.

    Builder methods chain::

        chaos = ChaosSchedule().kill(at_tick=8)
        engine = ServingEngine(model, params, chaos=chaos)

        ChaosSchedule().hang(at_tick=5)            # until killed/fenced
        ChaosSchedule().hang(at_tick=5, duration_s=0.5)  # self-healing
        ChaosSchedule().slow(from_tick=2, until_tick=10, delay_s=0.01)

    ``at_tick`` compares against :attr:`~.engine.ServingEngine.
    decode_ticks` with ``>=``, so a fault scheduled past the stream's
    end simply never fires (and :meth:`fired` reports which did).
    """

    def __init__(self):
        self._events: list[dict] = []

    # -- builders --------------------------------------------------------
    def kill(self, at_tick: int,
             error: Optional[BaseException] = None) -> "ChaosSchedule":
        """Script a replica death at decode tick ``at_tick`` (routed
        through ``engine.kill`` → the normal engine-fatal path)."""
        self._events.append({"kind": "kill", "at": int(at_tick),
                             "error": error, "fired": False})
        return self

    def hang(self, at_tick: int,
             duration_s: Optional[float] = None) -> "ChaosSchedule":
        """Script a hang at decode tick ``at_tick``: the heartbeat
        freezes (``duration_s=None`` = forever, i.e. until a watchdog
        kills the engine) while the loop keeps serving."""
        self._events.append({"kind": "hang", "at": int(at_tick),
                             "duration_s": duration_s, "until": None,
                             "fired": False})
        return self

    def slow(self, from_tick: int, until_tick: int,
             delay_s: float) -> "ChaosSchedule":
        """Script degraded ticks: sleep ``delay_s`` per loop iteration
        while ``from_tick <= decode_ticks < until_tick``."""
        if until_tick <= from_tick:
            raise ValueError(f"until_tick must exceed from_tick "
                             f"(got {from_tick}..{until_tick})")
        self._events.append({"kind": "slow", "at": int(from_tick),
                             "until_tick": int(until_tick),
                             "delay_s": float(delay_s), "fired": False})
        return self

    def wedge(self, at_tick: int, duration_s: float) -> "ChaosSchedule":
        """Script a genuine stall: at decode tick ``at_tick`` the engine
        sleeps ``duration_s`` inside its next reconcile barrier — a
        launched tick that "never returns" for that long. The
        loop truly stops (no heartbeats, no commits), then resumes."""
        if duration_s <= 0:
            raise ValueError(f"duration_s must be > 0 (got {duration_s})")
        self._events.append({"kind": "wedge", "at": int(at_tick),
                             "duration_s": float(duration_s),
                             "fired": False})
        return self

    # -- introspection ---------------------------------------------------
    def fired(self) -> list[str]:
        """Kinds of the events that have fired, in script order."""
        return [e["kind"] for e in self._events if e["fired"]]

    def __repr__(self):
        parts = ", ".join(
            f"{e['kind']}@{e['at']}{'*' if e['fired'] else ''}"
            for e in self._events)
        return f"ChaosSchedule({parts})"

    # -- engine hook -----------------------------------------------------
    def apply(self, engine):
        """Run due events against ``engine``. Called by the engine's run
        loop every iteration, BEFORE it checks its fail injection — a
        scripted kill therefore takes effect the same iteration it
        fires."""
        ticks = engine.decode_ticks
        now = time.monotonic()
        for e in self._events:
            kind = e["kind"]
            if kind == "kill":
                if not e["fired"] and ticks >= e["at"]:
                    e["fired"] = True
                    err = e["error"] if e["error"] is not None else \
                        ChaosKilled(f"chaos: scripted kill at tick {ticks}")
                    engine._flight.record("chaos_kill", tick=ticks)
                    engine.kill(err)
            elif kind == "hang":
                if not e["fired"] and ticks >= e["at"]:
                    e["fired"] = True
                    e["until"] = (None if e["duration_s"] is None
                                  else now + e["duration_s"])
                    engine._heartbeat_frozen = True
                    engine._flight.record(
                        "chaos_hang", tick=ticks,
                        duration_s=e["duration_s"])
                elif (e["fired"] and e["until"] is not None
                        and now >= e["until"]):
                    e["until"] = None
                    engine._heartbeat_frozen = False
                    engine._flight.record("chaos_hang_end", tick=ticks)
            elif kind == "wedge":
                if not e["fired"] and ticks >= e["at"]:
                    e["fired"] = True
                    engine._wedge_s = e["duration_s"]
                    engine._flight.record("chaos_wedge", tick=ticks,
                                          duration_s=e["duration_s"])
            elif kind == "slow":
                if e["at"] <= ticks < e["until_tick"]:
                    if not e["fired"]:
                        e["fired"] = True
                        engine._flight.record(
                            "chaos_slow", tick=ticks,
                            delay_s=e["delay_s"],
                            until_tick=e["until_tick"])
                    time.sleep(e["delay_s"])
