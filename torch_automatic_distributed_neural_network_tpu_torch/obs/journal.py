"""Span/event journal — the writer side of the JAX package's journal.

The port writes the same JSON lines as the JAX package's
``obs/journal.py``, so its records stay readable by that package's
``tadnn report``.  Here: the writer, live taps (``subscribe``),
size-capped rotation, the in-memory filter ``named``, the torn-line
tolerant reader ``Journal.read``, and the process-default helpers
(``as_default`` and the module-level ``event`` / ``span``, which library
code logs through).  Following a live file and the schema registry stay
in the JAX package (ROADMAP Queue 1 item 7).

Every record carries BOTH clocks:

- ``t``: seconds on the process monotonic clock relative to journal
  creation — durations and ordering survive wall-clock jumps;
- ``wall``: unix time — joinable against logs.

Zero-dep (json/time/os only; torch.distributed is read lazily, for
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

    ``validate=True`` (or ``TADNN_JOURNAL_VALIDATE=1``) asks for
    emit-time checks against the event schema registry, which the port
    does not have yet: it raises at construction.  Audit a journal the
    port wrote with the JAX package's ``tadnn check --journal
    --journal-file FILE``.
    """

    def __init__(self, path: str | None = None, *,
                 host0_only: bool = True, meta: dict | None = None,
                 max_bytes: int | None = None,
                 validate: bool | None = None):
        self.path = path
        if validate is None:
            validate = os.environ.get(
                "TADNN_JOURNAL_VALIDATE", "").strip() not in ("", "0")
        if validate:
            raise NotImplementedError(
                "journal schema validation is not ported yet (unset "
                "TADNN_JOURNAL_VALIDATE); audit the written journal with "
                "the JAX package's `tadnn check --journal --journal-file "
                "FILE`")
        self.enabled = (not host0_only) or _process_index() == 0
        self._t0 = time.monotonic()
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
               "t": time.monotonic() - self._t0, "wall": time.time(),
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
        t_start = time.monotonic()
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
            rec["dur_s"] = time.monotonic() - t_start
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
