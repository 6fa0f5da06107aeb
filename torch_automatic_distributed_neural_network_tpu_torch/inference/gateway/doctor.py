"""Fleet post-mortem: ``tadnn doctor --gateway-dir``.

The serving twin of ``doctor --launch-dir`` (training/launch.py): read
a gateway journal — including its rotated ``<path>.1`` generation —
and reconstruct the fleet's failure story offline: per-replica last
heartbeats, failovers with the rids they salvaged, hedge win/loss
record, circuit-breaker transitions, the degrade/restore history, and
which replica broke the cohort first.  The verdict (``ok``) is the
serving contract itself: every accepted request either completed or is
explicitly accounted for as lost.

The PyTorch package's copy of the JAX package's
``inference/gateway/doctor.py``, on the port's ``Journal``: both read
the same journal to the same report.
"""

from __future__ import annotations

import os

from ...obs.journal import Journal


def _journal_path(gateway_dir: str) -> str | None:
    """Accept a journal file directly or a directory holding one."""
    if os.path.isfile(gateway_dir):
        return gateway_dir
    if os.path.isdir(gateway_dir):
        for name in ("journal.jsonl", "gateway.jsonl", "chaos.jsonl"):
            p = os.path.join(gateway_dir, name)
            if os.path.isfile(p):
                return p
        jsonl = sorted(
            n for n in os.listdir(gateway_dir)
            if n.endswith(".jsonl"))
        if jsonl:
            return os.path.join(gateway_dir, jsonl[0])
    return None


def gateway_doctor(gateway_dir: str) -> dict:
    """Fleet health from a gateway journal (rotation-aware)."""
    path = _journal_path(gateway_dir)
    if path is None:
        return {"directory": os.path.abspath(gateway_dir),
                "error": "no journal (*.jsonl) found", "ok": False}
    records: list[dict] = []
    rotated = path + ".1"
    if os.path.isfile(rotated):
        records.extend(Journal.read(rotated))
    records.extend(Journal.read(path))

    t_end = 0.0
    replicas: dict[str, dict] = {}
    accepted: dict[int, dict] = {}
    done: set[int] = set()
    failovers: list[dict] = []
    parked: list[int] = []
    hedges = {"dispatched": 0, "won": 0, "lost": 0}
    breaker: list[dict] = []
    degrade: list[dict] = []
    rejects: dict[str, int] = {}
    faults: list[dict] = []

    def rep(name: str) -> dict:
        return replicas.setdefault(name, {
            "last_heartbeat_t": None, "steps": 0, "failed_over": False,
            "fault": None, "breaker_opens": 0})

    for r in records:
        name = r.get("name")
        t = r.get("t")
        if isinstance(t, (int, float)):
            t_end = max(t_end, t)
        if name == "serve.step":
            info = rep(r.get("replica", "?"))
            info["steps"] += 1
            if isinstance(t, (int, float)):
                info["last_heartbeat_t"] = t
        elif name == "gateway.request":
            accepted[r.get("rid")] = {
                "tenant": r.get("tenant"),
                "replica": r.get("replica")}
        elif name == "serve.request_done":
            done.add(r.get("rid"))
        elif name == "gateway.reject":
            kind = r.get("kind", "?")
            rejects[kind] = rejects.get(kind, 0) + 1
        elif name == "gateway.failover":
            if r.get("kind") == "parked":
                parked.append(r.get("rid"))
            else:
                failovers.append({
                    "t": t, "replica": r.get("replica"),
                    "reason": r.get("reason"),
                    "n_requeued": r.get("n_requeued"),
                    "rids": r.get("rids")})
                rep(r.get("replica", "?"))["failed_over"] = True
        elif name == "gateway.hedge":
            if r.get("kind") == "dispatch":
                hedges["dispatched"] += 1
            elif r.get("kind") == "win":
                key = ("won" if r.get("winner") == "hedge" else "lost")
                hedges[key] += 1
        elif name == "gateway.breaker":
            breaker.append({"t": t, "replica": r.get("replica"),
                            "from": r.get("from"), "to": r.get("to")})
            if r.get("to") == "open":
                rep(r.get("replica", "?"))["breaker_opens"] += 1
        elif name in ("gateway.degrade", "gateway.restore"):
            degrade.append({
                "t": t, "kind": name.split(".", 1)[1],
                "level": r.get("level"), "prev": r.get("prev"),
                "reason": r.get("reason"),
                "shed_classes": r.get("shed_classes")})
        elif name == "chaos.fault":
            faults.append({"t": t, "kind": r.get("kind"),
                           "replica": r.get("replica")})
            rep(r.get("replica", "?"))["fault"] = r.get("kind")

    for info in replicas.values():
        hb = info["last_heartbeat_t"]
        info["heartbeat_age_s"] = (round(t_end - hb, 6)
                                   if hb is not None else None)

    lost = sorted(rid for rid in accepted if rid not in done)
    # "who broke the cohort": the earliest hard failure signal —
    # a failover beats a breaker-open beats an injected fault
    culprit = None
    candidates = (
        [(f["t"], "failover", f["replica"]) for f in failovers]
        + [(b["t"], "breaker_open", b["replica"])
           for b in breaker if b["to"] == "open"]
        + [(f["t"], f"fault:{f['kind']}", f["replica"])
           for f in faults])
    if candidates:
        t0, how, who = min(candidates,
                           key=lambda c: (c[0] if c[0] is not None
                                          else float("inf")))
        culprit = {"replica": who, "how": how, "t": t0}

    return {
        "directory": os.path.abspath(gateway_dir),
        "journal": path,
        "rotated_generation": os.path.isfile(rotated),
        "n_records": len(records),
        "replicas": {k: replicas[k] for k in sorted(replicas)},
        "accepted": len(accepted),
        "done": len(done & set(accepted)),
        "lost_rids": lost,
        "rejects": rejects,
        "failovers": failovers,
        "parked_rids": parked,
        "hedges": hedges,
        "breaker_transitions": breaker,
        "degrade_history": degrade,
        "culprit": culprit,
        "ok": not lost,
    }


def format_gateway_doctor(doc: dict) -> str:
    if doc.get("error"):
        return (f"gateway dir: {doc['directory']}\n"
                f"error: {doc['error']}")
    lines = [f"gateway journal: {doc['journal']}"
             + (" (+ rotated generation)"
                if doc.get("rotated_generation") else "")]
    lines.append(
        f"requests: {doc['accepted']} accepted, {doc['done']} done, "
        f"{len(doc['lost_rids'])} lost"
        + (f", rejects {doc['rejects']}" if doc["rejects"] else ""))
    for name, info in doc.get("replicas", {}).items():
        age = info.get("heartbeat_age_s")
        bits = [f"{info['steps']} steps",
                ("last beat " + (f"{age:.3f}s before end"
                                 if age is not None else "never"))]
        if info.get("failed_over"):
            bits.append("FAILED OVER")
        if info.get("breaker_opens"):
            bits.append(f"breaker opened x{info['breaker_opens']}")
        if info.get("fault"):
            bits.append(f"injected fault: {info['fault']}")
        lines.append(f"  {name}: " + ", ".join(bits))
    for f in doc.get("failovers", []):
        lines.append(
            f"failover: {f['replica']} ({f['reason']}) salvaged "
            f"{f['n_requeued']} request(s) at t={f['t']:.3f}s")
    h = doc.get("hedges", {})
    if h.get("dispatched"):
        lines.append(f"hedges: {h['dispatched']} dispatched, "
                     f"{h['won']} won, {h['lost']} lost")
    for d in doc.get("degrade_history", []):
        lines.append(f"{d['kind']}: level {d.get('prev')} -> "
                     f"{d['level']} ({d.get('reason') or '?'})"
                     + (f", shed {d['shed_classes']}"
                        if d.get("shed_classes") else ""))
    c = doc.get("culprit")
    if c:
        lines.append(f"cohort broken first by: {c['replica']} "
                     f"({c['how']}, t={c['t']:.3f}s)")
    lines.append("verdict: "
                 + ("OK — every accepted request completed"
                    if doc.get("ok")
                    else f"LOST {len(doc['lost_rids'])} request(s): "
                         f"{doc['lost_rids'][:16]}"))
    return "\n".join(lines)
