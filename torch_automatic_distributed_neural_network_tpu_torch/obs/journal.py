"""Span/event journal — the writer side of the JAX package's journal.

The port writes the same JSON lines as the JAX package's
``obs/journal.py``, so its records stay readable by that package's
``tadnn report``.  Here: the writer, live taps (``subscribe``),
size-capped rotation, the in-memory filter ``named``, the torn-line
tolerant reader ``Journal.read`` and its live tail ``Journal.follow``,
the process-default helpers (``as_default`` and the module-level
``event`` / ``span``, which library code logs through), and emit-time
validation against the event schema registry (``obs/schema.py``,
``validate=True``).

Every record carries BOTH clocks:

- ``t``: seconds on the process monotonic clock relative to journal
  creation — durations and ordering survive wall-clock jumps;
- ``wall``: unix time — joinable against logs.

Zero-dep (json/time/os and the stdlib schema registry; torch.distributed is read lazily, for
rank-0 gating)::

    j = Journal("run/journal.jsonl")
    j.event("serve.preempt", rid=3)              # point event
    with j.span("serve.prefill", rid=3):         # timed span
        ...
    set_default(j)                               # process-global sink:
    event("ckpt.corrupt", step=30)               # library code logs here

With no default installed, module-level ``span``/``event`` are cheap
no-ops (a null journal), so instrumented code costs nothing in
un-observed runs.
``TADNN_JOURNAL=<path>`` in the environment installs a default sink
automatically on first use.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import warnings
from typing import Any, IO, Iterator

from . import schema as _schema


def _process_index() -> int:
    """This process's rank when torch.distributed is initialized, else 0."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None:
        return 0
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class Journal:
    """Monotonic-timestamped JSONL event/span sink.

    ``path=None`` keeps records in memory only (``self.records``) — the
    test/tooling mode.  ``host0_only=True`` (default) makes non-zero
    ranks' journals silent no-ops so multi-process runs produce one file.

    ``max_bytes`` (or ``TADNN_JOURNAL_MAX_BYTES`` in the environment)
    caps the file: when a write crosses the cap the file rotates to
    ``<path>.1`` (one generation, overwritten) and the journal keeps
    appending to a fresh file, led by a ``journal.rotated`` record.

    ``validate=True`` (or ``TADNN_JOURNAL_VALIDATE=1``) checks every
    record against the event schema registry (:mod:`.schema`) at emit
    time and raises :class:`~.schema.JournalContractError` at the site
    that emitted a drifting record.  Off by default.
    """

    def __init__(self, path: str | None = None, *,
                 host0_only: bool = True, meta: dict | None = None,
                 max_bytes: int | None = None,
                 validate: bool | None = None,
                 clock=time.monotonic):
        self.path = path
        if validate is None:
            validate = os.environ.get(
                "TADNN_JOURNAL_VALIDATE", "").strip() not in ("", "0")
        self.validate = bool(validate)
        self.enabled = (not host0_only) or _process_index() == 0
        # ``t`` stamps come from here: inject a virtual clock and every
        # record's event-time is replayable (the gateway's chaos
        # scenarios journal byte-identical sequences this way)
        self._clock = clock
        self._t0 = clock()
        self._depth = 0
        self._file: IO | None = None
        self.records: list[dict] = []  # in-memory sink when path is None
        self.counts: dict[str, int] = {}
        # live taps: called with each record as it is written
        self._subscribers: list = []
        if max_bytes is None:
            try:
                max_bytes = int(
                    os.environ.get("TADNN_JOURNAL_MAX_BYTES", "0")) or None
            except ValueError:
                max_bytes = None
        self._max_bytes = max_bytes
        self._rotating = False
        self.rotations = 0
        if self.enabled and path:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            self._file = open(path, "a")
        if self.enabled:
            self.event("journal.start", **(meta or {}))

    def _write(self, rec: dict) -> None:
        if not self.enabled:
            return
        if self.validate:
            problems = _schema.validate_record(rec)
            if problems:
                detail = "; ".join(f"{c}: {m}" for c, m in problems)
                raise _schema.JournalContractError(
                    f"journal record violates its event schema ({detail})")
        name = rec.get("name", "?")
        self.counts[name] = self.counts.get(name, 0) + 1
        if self._file is not None:
            self._file.write(json.dumps(rec, default=str) + "\n")
            self._file.flush()
            if (self._max_bytes and not self._rotating
                    and self._file.tell() >= self._max_bytes):
                self._rotate()
        else:
            self.records.append(rec)
        for fn in self._subscribers:
            fn(rec)

    def subscribe(self, fn) -> None:
        """Register a live tap: ``fn(rec)`` runs for every record this
        journal writes, file-backed or in-memory."""
        self._subscribers.append(fn)

    def _rotate(self) -> None:
        """Move the full file to ``<path>.1`` (replacing any previous
        generation) and reopen fresh.  The rotated event lands first in
        the new file so a reader knows records were shed."""
        self._file.close()
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:
            # best-effort (read-only fs mid-run): keep appending rather
            # than lose the sink
            self._file = open(self.path, "a")
            return
        self._file = open(self.path, "a")
        self.rotations += 1
        # guards the rotated event's own write: with a cap smaller than
        # one record it would otherwise recurse forever
        self._rotating = True
        try:
            self.event("journal.rotated", rotations=self.rotations,
                       max_bytes=self._max_bytes)
        finally:
            self._rotating = False

    def event(self, name: str, **fields: Any) -> dict | None:
        """One point-in-time record: ``{"kind": "event", "name": ...}``."""
        if not self.enabled:
            return None
        rec = {"kind": "event", "name": name,
               "t": self._clock() - self._t0, "wall": time.time(),
               "depth": self._depth, **fields}
        self._write(rec)
        return rec

    @contextlib.contextmanager
    def span(self, name: str, **fields: Any) -> Iterator[dict]:
        """Timed region.  Yields the record-in-progress so callers can
        attach result fields before it is written on exit; exceptions are
        recorded (``error`` field) and re-raised."""
        rec: dict[str, Any] = {"kind": "span", "name": name, **fields}
        if not self.enabled:
            yield rec
            return
        t_start = self._clock()
        rec["t"] = t_start - self._t0
        rec["wall"] = time.time()
        rec["depth"] = self._depth
        self._depth += 1
        try:
            yield rec
        except BaseException as e:
            rec["error"] = f"{type(e).__name__}: {e}"
            raise
        finally:
            self._depth -= 1
            rec["dur_s"] = self._clock() - t_start
            self._write(rec)

    def named(self, prefix: str) -> list[dict]:
        """In-memory records (``path=None`` mode) whose name is
        ``prefix`` or lives under it as a dotted namespace — ``'ckpt'``
        matches ``ckpt.save`` and ``ckpt.corrupt``."""
        return [
            rec for rec in self.records
            if rec.get("name", "") == prefix
            or rec.get("name", "").startswith(prefix + ".")
        ]

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @staticmethod
    def read(path: str) -> list[dict]:
        """Parse a journal file, skipping torn/partial JSONL lines (a
        crashed writer leaves a torn final line) and non-dict lines, with
        one warning per file."""
        out: list[dict] = []
        bad = 0
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    bad += 1
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
                else:
                    bad += 1
        if bad and path not in _warned_corrupt:
            _warned_corrupt.add(path)
            warnings.warn(
                f"journal {path}: skipped {bad} torn/corrupt line(s) "
                f"({len(out)} readable records kept)", stacklevel=2)
        return out

    @staticmethod
    def follow(path: str, *, poll_s: float = 0.2,
               idle_timeout: float | None = None,
               stop=None, sleep=time.sleep) -> Iterator[dict]:
        """Tail a journal file as a concurrent writer appends to it.

        Yields each record as soon as its line is complete.  A torn
        final line — the writer seen mid-record — is buffered until its
        newline arrives, so a live reader never drops the record a
        crash-time reader would have skipped; interior corrupt lines
        are skipped with the same once-per-file warning as ``read``.

        Stops when ``stop()`` returns true (checked between polls) or
        after ``idle_timeout`` seconds with no new bytes (None = follow
        forever).  ``sleep`` is injectable so tests can drive the tail
        loop without real waiting.

        The path may not exist yet (a monitor is routinely started
        before the engine's first event): creation is polled for under
        the same ``idle_timeout`` budget instead of raising.

        Size-capped rotation is survived: when the writer rotates the
        file out from under the tail (``os.replace`` to ``<path>.1`` —
        the open fd now points at the OLD generation) or truncates it,
        the follower detects the inode swap / size shrink, reopens the
        fresh file from the top, and warns once per rotation; a torn
        buffer from the old generation is dropped (its tail lives in
        ``<path>.1``, not the stream)."""
        buf = ""
        idle = 0.0
        while not os.path.exists(path):
            if stop is not None and stop():
                return
            if idle_timeout is not None and idle >= idle_timeout:
                return
            sleep(poll_s)
            idle += poll_s
        idle = 0.0
        f = open(path)
        try:
            while True:
                chunk = f.read()
                if chunk:
                    idle = 0.0
                    buf += chunk
                    while "\n" in buf:
                        line, _, buf = buf.partition("\n")
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            rec = None
                        if isinstance(rec, dict):
                            yield rec
                            continue
                        if path not in _warned_corrupt:
                            _warned_corrupt.add(path)
                            warnings.warn(
                                f"journal {path}: skipping torn/corrupt "
                                f"line(s) while following", stacklevel=2)
                    continue
                # no new bytes on the open fd: check whether the file
                # was rotated (replaced: different inode at the path)
                # or truncated (shrunk below our read position) and
                # re-attach to the live generation if so
                rotated = False
                try:
                    disk = os.stat(path)
                    here = os.fstat(f.fileno())
                    if disk.st_ino != here.st_ino:
                        rotated = True
                    elif disk.st_size < f.tell():
                        rotated = True
                except OSError:
                    # path briefly absent mid-replace: treat as idle,
                    # the next poll sees the new file
                    pass
                if rotated:
                    warnings.warn(
                        f"journal {path}: rotated mid-follow, "
                        f"re-attached to the new generation"
                        + (" (dropped a torn partial line)"
                           if buf.strip() else ""), stacklevel=2)
                    f.close()
                    f = open(path)
                    buf = ""
                    idle = 0.0
                    continue
                if stop is not None and stop():
                    return
                if idle_timeout is not None and idle >= idle_timeout:
                    return
                sleep(poll_s)
                idle += poll_s
        finally:
            f.close()


# paths already warned about corrupt lines (once-per-file, process-wide)
_warned_corrupt: set[str] = set()


class _NullJournal(Journal):
    """Sink of last resort: every call is a no-op."""

    def __init__(self):  # noqa: D401 — deliberately skips Journal.__init__
        self.path = None
        self.enabled = False
        self._file = None
        self.records = []
        self.counts = {}
        self._subscribers = []
        self._depth = 0
        self._clock = time.monotonic
        self._t0 = time.monotonic()


_NULL = _NullJournal()
_default: Journal | None = None


def set_default(journal: Journal | None) -> Journal | None:
    """Install (or clear, with None) the process-global journal."""
    global _default
    _default = journal
    return journal


def get_default() -> Journal:
    """The process-global journal; honors ``TADNN_JOURNAL`` env on first
    call; a silent null sink when nothing is configured."""
    global _default
    if _default is None:
        env = os.environ.get("TADNN_JOURNAL")
        if env:
            _default = Journal(env)
    return _default if _default is not None else _NULL


@contextlib.contextmanager
def as_default(journal: Journal | None) -> Iterator[Journal]:
    """Temporarily install ``journal`` as the process default (restores
    the previous default on exit).  ``None`` is a pass-through."""
    global _default
    if journal is None:
        yield get_default()
        return
    prev = _default
    _default = journal
    try:
        yield journal
    finally:
        _default = prev


def event(name: str, **fields: Any) -> dict | None:
    """Module-level event on the default journal (no-op when unset)."""
    return get_default().event(name, **fields)


def span(name: str, **fields: Any):
    """Module-level span on the default journal (no-op when unset)."""
    return get_default().span(name, **fields)
