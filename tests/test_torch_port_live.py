"""Live serving telemetry in the PyTorch port (``obs/live.py``,
``Journal.follow``) against the JAX package's, on the same inputs.

- ``LatencySketch``: quantiles, mean, merge and the JSON round trip of a
  seeded log-normal sample (plus zeros, negatives, nan and inf, which
  both drop or clamp alike) equal JAX's exactly;
- ``LiveAggregator`` / ``aggregate_stream``: a seeded stream of 600
  ``serve.*`` records (request completions under both the current name
  and its deprecated alias, steps with and without token counts,
  preemptions, speculation, records of other kinds, records with no
  time stamp) folded into 0.25 s windows: every sealed window, the
  run-wide summary and ``stale()`` on an injected clock equal JAX's
  (floats within 1e-12 relative: the same arithmetic in the same order,
  compared with a bound rather than bitwise in case the summation order
  of a platform's ``math`` differs);
- ``Journal.follow`` tails a file that another thread appends to: every
  complete record arrives once, in order, a torn last line is held until
  its newline arrives, an interior corrupt line is skipped with a
  warning, ``stop`` and ``idle_timeout`` end the tail, a file that does
  not exist yet is waited for, and JAX's ``follow`` reads the finished
  file to the same records.
"""

import json
import math
import threading
import time
import warnings

import numpy as np
import pytest

from torch_automatic_distributed_neural_network_tpu.obs import live as jlive
from torch_automatic_distributed_neural_network_tpu.obs.journal import (
    Journal as JJournal,
)
from torch_automatic_distributed_neural_network_tpu_torch.obs import live
from torch_automatic_distributed_neural_network_tpu_torch.obs.journal import (
    Journal,
)

REL = 1e-12


def _close(a, b) -> bool:
    """Equal structures, floats within ``REL`` relative."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_close(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_close(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and isinstance(b, float):
        return math.isclose(a, b, rel_tol=REL, abs_tol=0.0) or a == b
    return a == b


def _samples(seed=0, n=2000):
    rs = np.random.RandomState(seed)
    vals = list(rs.lognormal(-3.0, 1.2, size=n))
    return vals + [0.0, -1.0, 1e-9, float("nan"), float("inf"), 42.0]


@pytest.mark.parametrize("growth", [1.08, 1.5])
def test_latency_sketch_matches_jax(growth):
    vals = _samples()
    a, b = live.LatencySketch(growth=growth), jlive.LatencySketch(
        growth=growth)
    for v in vals[:1500]:
        a.add(v)
        b.add(v)
    a2, b2 = live.LatencySketch(growth=growth), jlive.LatencySketch(
        growth=growth)
    for v in vals[1500:]:
        a2.add(v)
        b2.add(v)
    a.merge(a2)
    b.merge(b2)
    qs = [0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0]
    assert _close([a.percentile(q) for q in qs], [b.percentile(q) for q in qs])
    assert _close(a.mean, b.mean) and a.n == b.n
    assert a.to_json() == b.to_json()
    back = live.LatencySketch.from_json(b.to_json())
    assert back.to_json() == b.to_json()
    # the reported percentile sits within sqrt(growth) of the true one
    true = float(np.percentile([v for v in vals if math.isfinite(v)
                                and v > 0], 50))
    assert abs(math.log(a.percentile(0.5) / true)) <= math.log(growth)
    with pytest.raises(ValueError):
        a.merge(live.LatencySketch(growth=growth + 0.1))
    with pytest.raises(ValueError):
        live.LatencySketch(growth=1.0)
    assert live.LatencySketch().percentile(0.5) is None


def _stream(seed=1, n=600):
    """A seeded serve.* record stream on monotonic ``t`` stamps."""
    rs = np.random.RandomState(seed)
    t, out = 0.0, []
    for i in range(n):
        t += float(rs.exponential(0.01))
        if i > 400 and i < 430:
            t += 0.05  # a quiet stretch: windows with no traffic
        kind = rs.randint(8)
        if kind in (0, 1):
            rec = {"name": "serve.request_done" if kind == 0
                   else "serve.request",  # the deprecated alias
                   "rid": i, "ttft_s": float(rs.lognormal(-4, 1)),
                   "itl_s": [float(x) for x in rs.lognormal(-5, 0.5,
                                                            rs.randint(4))],
                   "total_s": float(rs.lognormal(-2, 1)),
                   "n_new": int(rs.randint(1, 64)),
                   "cached_tokens": int(rs.randint(0, 32)),
                   "n_prompt": int(rs.randint(32, 256))}
        elif kind in (2, 3, 4):
            rec = {"name": "serve.step", "occupancy": float(rs.rand()),
                   "n_queued": int(rs.randint(0, 8))}
            if kind != 4:
                rec["new_tokens"] = int(rs.randint(0, 8))
        elif kind == 5:
            rec = {"name": "serve.preempt", "rid": i}
        elif kind == 6:
            rec = {"name": "serve.speculate", "drafted": int(rs.randint(8)),
                   "accepted": int(rs.randint(4))}
        else:
            rec = {"name": "ckpt.save", "step": i}
        if rs.rand() < 0.02:
            rec["t"] = None  # no usable stamp: skipped by both
        else:
            rec["t"] = t
        out.append(rec)
    return out


@pytest.mark.parametrize("window_s", [0.25, 1.0])
def test_live_aggregator_windows_match_jax(window_s):
    recs = _stream()
    clock = [0.0]
    a = live.LiveAggregator(window_s, clock=lambda: clock[0])
    b = jlive.LiveAggregator(window_s, clock=lambda: clock[0])
    closed_a, closed_b, stale = [], [], []
    for rec in recs:
        clock[0] += 0.003
        closed_a += a.add(dict(rec))
        closed_b += b.add(dict(rec))
        stale.append((a.stale(0.01), b.stale(0.01)))
    assert all(x == y for x, y in stale) and not any(x for x, _ in stale)
    clock[0] += 10.0
    assert a.stale() and b.stale()
    closed_a.append(a.flush())
    closed_b.append(b.flush())
    assert len(closed_a) > 3 and _close(closed_a, closed_b)
    assert _close(a.windows, b.windows)
    assert _close(a.summary(), b.summary())
    assert a.summary()["n_done"] == sum(
        1 for r in recs if r["t"] is not None
        and r["name"] in ("serve.request_done", "serve.request"))
    # the generator over the same stream, and its JAX twin
    assert _close(list(live.aggregate_stream(recs, window_s=window_s)),
                  list(jlive.aggregate_stream(recs, window_s=window_s)))
    with pytest.raises(ValueError):
        live.LiveAggregator(0.0)


def _line(rec) -> str:
    return json.dumps(rec) + "\n"


def test_journal_follow_tails_a_writer_with_a_torn_line(tmp_path):
    """A writer thread appends 40 records, one of them torn across two
    writes with a pause between, and one corrupt interior line; the
    follower sees each complete record once, in order, and stops after
    ``idle_timeout`` of silence."""
    path = str(tmp_path / "journal.jsonl")
    recs = [{"name": "serve.step", "t": i * 0.1, "i": i} for i in range(40)]
    written = threading.Event()

    def writer():
        time.sleep(0.05)  # the follower starts before the file exists
        with open(path, "a") as f:
            for i, rec in enumerate(recs):
                text = _line(rec)
                if i == 20:
                    f.write(text[:9])
                    f.flush()
                    time.sleep(0.08)  # the reader sees a torn line
                    f.write(text[9:])
                elif i == 30:
                    f.write("{not json\n")
                    f.write(text)
                else:
                    f.write(text)
                f.flush()
                if i % 10 == 0:
                    time.sleep(0.01)
        written.set()

    th = threading.Thread(target=writer)
    th.start()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = list(Journal.follow(path, poll_s=0.01, idle_timeout=0.5))
    th.join(timeout=10)
    assert not th.is_alive() and written.is_set()
    assert got == recs
    assert any("torn/corrupt" in str(w.message) for w in caught)
    # JAX's follow reads the finished file to the same records
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = list(JJournal.follow(path, poll_s=0.01, idle_timeout=0.05))
    assert got == want


def test_journal_follow_stop_sleep_and_a_missing_file(tmp_path):
    """An injected ``sleep`` drives the loop without waiting; ``stop``
    ends it between polls; a file that never appears ends the wait at
    ``idle_timeout``; a torn final line that never completes is not
    yielded."""
    path = tmp_path / "j.jsonl"
    naps = []
    assert list(Journal.follow(str(path), poll_s=0.5, idle_timeout=2.0,
                               sleep=naps.append)) == []
    assert naps == [0.5] * 4
    path.write_text(_line({"name": "a", "t": 0}) + '{"name": "b", "t"')
    naps.clear()
    assert list(Journal.follow(str(path), poll_s=0.5, idle_timeout=1.0,
                               sleep=naps.append)) == [{"name": "a", "t": 0}]
    assert naps == [0.5, 0.5]
    calls = []

    def stop():
        calls.append(1)
        return len(calls) >= 3

    got = list(Journal.follow(str(path), poll_s=0.5, stop=stop,
                              sleep=lambda s: None))
    assert got == [{"name": "a", "t": 0}] and len(calls) == 3
