"""Bounded explicit-state model checking over the REAL serving objects.

The serving control plane is a pile of interacting state machines —
block refcounts, adapter pins, radix leases, the exactly-once token
ledger — whose invariants the unit tests only exercise on a handful of
seeded traces.  This module is the TLA+/Alloy-style small-scope
complement: breadth-first exploration of EVERY event interleaving from
a small initial state, checking safety invariants after each transition
and terminal invariants at quiescence.

Two design decisions carry the whole thing:

- **Models drive the real objects.**  A ``ProtocolModel`` wraps the
  actual ``BlockAllocator`` / ``Scheduler`` / ``PrefixCache`` instances — the
  repo's injectable clocks and pure decision functions make the
  world host-side, deterministic, and ``deepcopy``-able, so a checker
  state is just a deep copy of live objects.  There is no abstract
  re-implementation to drift from the shipped code.
- **Counterexamples are replayable event scripts.**  A violation is a
  path of ``(name, *args)`` event tuples from the initial state.  The
  path is minimized by greedy event deletion (each candidate re-run
  from scratch) and serialized as JSON; ``replay_script`` re-executes
  one against the current code and raises ``ProtocolViolation`` iff
  the violation still reproduces — which is exactly the shape of a
  failing pytest case.

The exploration is bounded (``max_states`` / ``max_depth``) and the
result records whether the frontier was exhausted (``complete``) so a
truncated search can never masquerade as a proof.

The PyTorch package's copy of the JAX package's
``analysis/model_check.py``; the protocol models over this package's
serving objects are in ``analysis/protocol.py``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import time
from collections import deque
from typing import Any, Callable, Iterable

# An event is a hashable, JSON-serializable tuple: ("name", arg, ...).
Event = tuple


class ProtocolViolation(AssertionError):
    """A protocol safety/liveness invariant failed (rule + message)."""

    def __init__(self, code: str, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code
        self.message = message


class ProtocolModel:
    """One checkable protocol: initial world, events, invariants.

    Subclasses wrap REAL objects in an opaque ``world`` value and
    implement:

    - ``initial()`` — build a fresh world (must be deterministic);
    - ``enabled(world)`` — the event tuples applicable now;
    - ``apply(world, event)`` — mutate ``world`` (the checker owns
      copying); exceptions raised by the underlying objects are
      classified as violations via ``classify``;
    - ``violations(world)`` — ``(code, message)`` safety violations;
    - ``quiescent(world)`` / ``terminal_violations(world)`` — the
      liveness side: quiescence must imply a clean terminal state;
    - ``fingerprint(world)`` — hashable canonical state for dedup.
    """

    name = "model"
    rule = "PC001"            # default code for exceptions in apply()
    liveness_rule = "PC006"   # code for stuck / dirty-terminal states

    def __init__(self, scope: dict | None = None):
        self.scope = dict(scope or {})

    def initial(self) -> Any:
        raise NotImplementedError

    def enabled(self, world: Any) -> list[Event]:
        raise NotImplementedError

    def apply(self, world: Any, event: Event) -> None:
        raise NotImplementedError

    def violations(self, world: Any) -> list[tuple[str, str]]:
        return []

    def quiescent(self, world: Any) -> bool:
        return False

    def terminal_violations(self, world: Any) -> list[tuple[str, str]]:
        return []

    def fingerprint(self, world: Any) -> Any:
        raise NotImplementedError

    def classify(self, exc: BaseException) -> str:
        """Rule code for an exception the real objects raised — their
        own loud contracts (double-free ValueError, invariant
        AssertionError) ARE protocol violations under a legal event
        sequence."""
        if isinstance(exc, ProtocolViolation):
            return exc.code
        return self.rule


# -- canonical state fingerprints ---------------------------------------------

_ATOMIC = (str, int, float, bool, bytes, type(None))


def canonical(obj: Any, *, exclude: frozenset[str] = frozenset(),
              _memo: dict | None = None) -> Any:
    """Hashable canonical form of an object graph: dicts sorted,
    cycles broken with back-references, attributes named in
    ``exclude`` dropped (journals, caches — anything that never feeds
    back into behavior).  Deterministic for structurally identical
    graphs, so it serves as a visited-state fingerprint."""
    if isinstance(obj, _ATOMIC):
        return obj
    if _memo is None:
        _memo = {}
    oid = id(obj)
    if oid in _memo:
        return ("@", _memo[oid])
    _memo[oid] = len(_memo)
    if isinstance(obj, (list, tuple, deque)):
        return ("L",) + tuple(
            canonical(x, exclude=exclude, _memo=_memo) for x in obj)
    if isinstance(obj, (set, frozenset)):
        items = [canonical(x, exclude=exclude, _memo=_memo) for x in obj]
        return ("S",) + tuple(sorted(items, key=repr))
    if isinstance(obj, dict):
        items = [
            (canonical(k, exclude=exclude, _memo=_memo),
             canonical(v, exclude=exclude, _memo=_memo))
            for k, v in obj.items()]
        return ("D",) + tuple(sorted(items, key=repr))
    d = getattr(obj, "__dict__", None)
    if d is None:
        # functions, bound methods, and other opaque leaves: identity
        # by name only — the shared clock/journal plumbing, never state
        return ("F", getattr(obj, "__name__", type(obj).__name__))
    return ("O", type(obj).__name__) + tuple(
        (k, canonical(v, exclude=exclude, _memo=_memo))
        for k, v in sorted(d.items()) if k not in exclude)


# -- results ------------------------------------------------------------------


@dataclasses.dataclass
class Counterexample:
    """A violating event path from the model's initial state."""

    model: str
    scope: dict
    code: str
    message: str
    events: list[Event]
    minimized: bool = False

    def to_json(self) -> dict:
        return {"model": self.model, "scope": self.scope,
                "code": self.code, "message": self.message,
                "minimized": self.minimized,
                "events": [list(e) for e in self.events]}

    @classmethod
    def from_json(cls, data: dict) -> "Counterexample":
        return cls(model=data["model"], scope=dict(data.get("scope", {})),
                   code=data["code"], message=data.get("message", ""),
                   minimized=bool(data.get("minimized", False)),
                   events=[tuple(e) for e in data["events"]])


@dataclasses.dataclass
class ModelResult:
    """One model's exploration stats + any counterexamples."""

    model: str
    scope: dict
    states: int = 0            # distinct states visited (incl. initial)
    transitions: int = 0       # apply() calls
    depth: int = 0             # deepest explored path
    frontier_peak: int = 0
    wall_s: float = 0.0
    complete: bool = True      # frontier exhausted within the caps
    counterexamples: list[Counterexample] = dataclasses.field(
        default_factory=list)

    def to_json(self) -> dict:
        return {"model": self.model, "scope": self.scope,
                "states": self.states, "transitions": self.transitions,
                "depth": self.depth, "frontier_peak": self.frontier_peak,
                "wall_s": round(self.wall_s, 3),
                "complete": self.complete,
                "counterexamples": [c.to_json()
                                    for c in self.counterexamples]}


# -- replay + minimization ----------------------------------------------------

_INVALID = object()  # replay sentinel: an event was not enabled


def _step_violation(model: ProtocolModel, world: Any
                    ) -> tuple[str, str] | None:
    v = model.violations(world)
    if v:
        return v[0]
    if model.quiescent(world):
        tv = model.terminal_violations(world)
        if tv:
            return tv[0]
    return None


def replay(model: ProtocolModel, events: Iterable[Event]
           ) -> tuple[str, str] | None:
    """Re-run an event path from a fresh initial world.  Returns the
    first ``(code, message)`` violation, ``None`` for a clean run, or
    the ``_INVALID`` sentinel when an event was not enabled at its
    turn (a minimization candidate that broke causality)."""
    world = model.initial()
    v = _step_violation(model, world)
    if v:
        return v
    for ev in events:
        ev = tuple(ev)
        if ev not in model.enabled(world):
            return _INVALID  # type: ignore[return-value]
        try:
            model.apply(world, ev)
        except Exception as e:  # the real objects' loud contracts
            return (model.classify(e), f"{type(e).__name__}: {e}")
        v = _step_violation(model, world)
        if v:
            return v
    # mirror explore()'s deadlock rule so stuck-state counterexamples
    # replay: a path ending with no enabled events must be quiescent
    if not model.enabled(world) and not model.quiescent(world):
        return (model.liveness_rule,
                "stuck: no enabled events but the world is not "
                "quiescent")
    return None


def minimize(model: ProtocolModel, cx: Counterexample) -> Counterexample:
    """Greedy event deletion: drop any event whose removal still
    yields a violation (of any code), to a fixpoint.  Each candidate
    replays from scratch, so the result is guaranteed replayable."""
    events = list(cx.events)
    code, message = cx.code, cx.message
    changed = True
    while changed:
        changed = False
        for i in range(len(events)):
            cand = events[:i] + events[i + 1:]
            got = replay(model, cand)
            if got is not None and got is not _INVALID:
                events, (code, message) = cand, got
                changed = True
                break
    return Counterexample(model=cx.model, scope=cx.scope, code=code,
                          message=message, events=events, minimized=True)


# -- exploration --------------------------------------------------------------


def explore(model: ProtocolModel, *, max_states: int = 200_000,
            max_depth: int = 400, max_violations: int = 3,
            minimize_counterexamples: bool = True) -> ModelResult:
    """Bounded BFS over all event interleavings from the initial
    state.  Violating states are recorded (path = counterexample) and
    not expanded; distinct states dedup on ``model.fingerprint``.
    Deadlocks (no enabled events, not quiescent) and dirty quiescent
    states are liveness violations."""
    t0 = time.perf_counter()
    res = ModelResult(model=model.name, scope=dict(model.scope))
    init = model.initial()
    res.states = 1

    def record(path: list[Event], code: str, message: str) -> None:
        if any(c.code == code for c in res.counterexamples):
            return  # keep the first (shortest — BFS) path per rule
        res.counterexamples.append(Counterexample(
            model=model.name, scope=dict(model.scope), code=code,
            message=message, events=list(path)))

    v = _step_violation(model, init)
    if v:
        record([], *v)
    visited = {model.fingerprint(init)}
    frontier: deque[tuple[Any, list[Event]]] = deque([(init, [])])
    while frontier and len(res.counterexamples) < max_violations:
        res.frontier_peak = max(res.frontier_peak, len(frontier))
        world, path = frontier.popleft()
        events = model.enabled(world)
        if not events:
            if not model.quiescent(world):
                record(path, model.liveness_rule,
                       "stuck: no enabled events but the world is not "
                       "quiescent")
            continue
        if len(path) >= max_depth:
            res.complete = False
            continue
        for ev in events:
            if len(res.counterexamples) >= max_violations:
                break
            child = copy.deepcopy(world)
            res.transitions += 1
            try:
                model.apply(child, ev)
                viol = _step_violation(model, child)
            except Exception as e:
                viol = (model.classify(e), f"{type(e).__name__}: {e}")
            if viol:
                record(path + [ev], *viol)
                continue  # violating states are terminal for search
            fp = model.fingerprint(child)
            if fp in visited:
                continue
            if len(visited) >= max_states:
                res.complete = False
                continue
            visited.add(fp)
            res.states += 1
            res.depth = max(res.depth, len(path) + 1)
            frontier.append((child, path + [ev]))
    if frontier and len(res.counterexamples) >= max_violations:
        res.complete = False
    if minimize_counterexamples:
        res.counterexamples = [minimize(model, c)
                               for c in res.counterexamples]
    res.wall_s = time.perf_counter() - t0
    return res


# -- replayable scripts -------------------------------------------------------


def save_script(cx: Counterexample, path: str) -> None:
    with open(path, "w") as f:
        json.dump(cx.to_json(), f, indent=2, sort_keys=True)
        f.write("\n")


def load_script(path: str) -> Counterexample:
    with open(path) as f:
        return Counterexample.from_json(json.load(f))


def replay_script(script: Counterexample | dict | str,
                  build_model: Callable[[str, dict], ProtocolModel]
                  ) -> None:
    """Re-execute a counterexample script against the CURRENT code.

    ``build_model`` maps ``(model_name, scope) -> ProtocolModel``.
    Raises ``ProtocolViolation`` iff the
    violation still reproduces — so a pytest that calls this fails
    exactly while the protocol bug is present — and ``ValueError``
    when the script no longer applies (an event stopped being
    enabled: the protocol changed shape, re-run the checker)."""
    if isinstance(script, str):
        script = load_script(script)
    elif isinstance(script, dict):
        script = Counterexample.from_json(script)
    model = build_model(script.model, script.scope)
    got = replay(model, script.events)
    if got is _INVALID:
        raise ValueError(
            f"counterexample script for {script.model!r} no longer "
            "applies (an event is not enabled — the protocol changed); "
            "re-run `tadnn check --protocol`")
    if got is not None:
        code, message = got
        raise ProtocolViolation(code, message)


__all__ = [
    "Counterexample", "Event", "ModelResult", "ProtocolModel",
    "ProtocolViolation", "canonical", "explore", "load_script",
    "minimize", "replay", "replay_script", "save_script",
]
