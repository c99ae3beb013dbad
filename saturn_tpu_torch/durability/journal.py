"""Append-only, checksummed write-ahead journal (JSONL segments).

Counterpart of ``saturn_tpu/durability/journal.py``, byte for byte in what
it writes: the JAX package's ``replay`` reads a journal this module wrote,
and this module reads one the JAX package wrote. One JSON object per line::

    {"crc":"9a3f01c2","data":{...},"kind":"task_progress","seq":412,"ts":1754390400.123456}

``seq`` rises by one from record to record, across segments and across
process incarnations (a writer opened on an existing directory continues
from the last durable ``seq``). ``crc`` is the CRC32 of the record without
its ``crc`` field, encoded as every record is encoded: sorted keys, compact
separators. A record that fails either check is the durable cut:
:func:`recover` moves everything from it on into a ``.corrupt`` sidecar.

Write path:

- ``append`` buffers one encoded record (thread-safe: the engine's launcher
  threads and the checkpoint writer thread append while the orchestrator's
  thread commits);
- ``commit`` is a group commit, one ``write`` and one ``fsync`` for every
  record buffered since the last one. What was appended and not committed
  dies with the process: "committed means it survives SIGKILL";
- segments (``wal-000001.jsonl``, ...) rotate past ``segment_max_bytes``:
  the next one is written as a ``.tmp`` with its ``segment_open`` header
  fsync'd, then renamed into place, and the directory fsync'd, so a crash
  mid-rotation leaves a ``.tmp`` that recovery deletes, never a
  half-made segment.

``barrier(point, **ctx)`` calls the crash harness's callback
(``resilience/crash.py``) at each durability edge: ``pre-commit``,
``mid-fsync``, ``post-commit``, ``pre-rotate``, ``post-rename``, and the
points a caller crosses itself (the orchestrator's ``mid-interval`` and
``post-rollback``).

A directory that cannot be created, written or fsync'd raises: nothing
falls back to running without a journal.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger("saturn_tpu_torch")

_SEGMENT_PREFIX = "wal-"
_SEGMENT_SUFFIX = ".jsonl"
_JSON_OPTS = {"sort_keys": True, "separators": (",", ":"), "default": str}


class JournalCorruptError(RuntimeError):
    """A record failed its CRC or sequence check where the caller asked for
    a strict replay."""


def _segment_path(root: str, index: int) -> str:
    return os.path.join(root, f"{_SEGMENT_PREFIX}{index:06d}{_SEGMENT_SUFFIX}")


def _segment_index(name: str) -> Optional[int]:
    if not (name.startswith(_SEGMENT_PREFIX) and name.endswith(_SEGMENT_SUFFIX)):
        return None
    try:
        return int(name[len(_SEGMENT_PREFIX):-len(_SEGMENT_SUFFIX)])
    except ValueError:
        return None


def _segments(root: str) -> List[Tuple[int, str]]:
    return sorted((idx, name) for name in os.listdir(root)
                  if (idx := _segment_index(name)) is not None)


def _crc_of(body: Dict[str, Any]) -> str:
    return format(zlib.crc32(json.dumps(body, **_JSON_OPTS).encode("utf-8")), "08x")


def _verify_line(line: str, prev_seq: Optional[int]) -> Optional[Dict[str, Any]]:
    """Parse, checksum and sequence-check one record line; None if corrupt."""
    try:
        rec = json.loads(line)
    except ValueError:
        return None
    if not isinstance(rec, dict) or "crc" not in rec or "seq" not in rec:
        return None
    claimed = rec.pop("crc")
    if _crc_of(rec) != claimed:
        return None
    if prev_seq is not None and rec["seq"] != prev_seq + 1:
        return None  # a gap or a repeat: an earlier durable cut was lost
    return rec


def _read_segment(path: str, prev_seq: Optional[int]):
    """The verified records of one segment from its start, the byte offset
    where they end, and the segment's length."""
    with open(path, "rb") as f:
        raw = f.read()
    records, offset = [], 0
    while offset < len(raw):
        nl = raw.find(b"\n", offset)
        if nl < 0:
            break  # trailing bytes without a newline: a torn append
        rec = _verify_line(raw[offset:nl].decode("utf-8", "replace"), prev_seq)
        if rec is None:
            break
        prev_seq = rec["seq"]
        records.append(rec)
        offset = nl + 1
    return records, offset, len(raw)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _sidecar(path: str) -> str:
    """The first free ``.corrupt`` name for ``path``: ``.corrupt``,
    ``.corrupt.2``, ... (the JAX journal's numbering)."""
    sidecar, n = path + ".corrupt", 1
    while os.path.exists(sidecar):
        n += 1
        sidecar = f"{path}.corrupt.{n}"
    return sidecar


def _quarantine_bytes(seg_path: str, offset: int) -> str:
    """Move everything of a segment from ``offset`` on into a ``.corrupt``
    sidecar (written as a ``.tmp``, fsync'd, renamed, the directory
    fsync'd) and truncate the segment back to the durable cut."""
    sidecar = _sidecar(seg_path)
    with open(seg_path, "rb") as f:
        f.seek(offset)
        bad = f.read()
    tmp = sidecar + ".tmp"
    with open(tmp, "wb") as f:
        f.write(bad)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, sidecar)
    _fsync_dir(os.path.dirname(sidecar) or ".")
    with open(seg_path, "r+b") as f:
        f.truncate(offset)
        f.flush()
        os.fsync(f.fileno())
    return sidecar


def recover(root: str) -> Dict[str, Any]:
    """Scan the journal directory, quarantine whatever lies past the last
    durable cut, and report what survived.

    Mutating and idempotent: ``.tmp`` files (a crash mid-rotation) are
    deleted; a torn or corrupt tail goes to ``<segment>.corrupt`` and the
    segment is truncated to the cut; every later segment, valid or not, is
    renamed to a sidecar too, since it continues a history that was lost.
    Returns ``{"segments", "records", "last_seq", "quarantined": [paths]}``.
    """
    report: Dict[str, Any] = {"segments": 0, "records": 0, "last_seq": None,
                              "quarantined": []}
    if not os.path.isdir(root):
        return report
    for name in sorted(os.listdir(root)):
        if name.endswith(".tmp"):
            os.unlink(os.path.join(root, name))
    prev_seq: Optional[int] = None
    cut_found = False
    for _, name in _segments(root):
        seg_path = os.path.join(root, name)
        if cut_found:
            sidecar = _sidecar(seg_path)
            os.replace(seg_path, sidecar)
            _fsync_dir(root)
            report["quarantined"].append(sidecar)
            continue
        report["segments"] += 1
        records, offset, size = _read_segment(seg_path, prev_seq)
        if records:
            prev_seq = records[-1]["seq"]
        report["records"] += len(records)
        if offset < size:
            sidecar = _quarantine_bytes(seg_path, offset)
            report["quarantined"].append(sidecar)
            logger.warning("journal recovery: quarantined %d torn or corrupt byte(s) of "
                           "%s to %s (rolled back to seq %s)", size - offset, seg_path,
                           sidecar, prev_seq)
            cut_found = True
    report["last_seq"] = prev_seq
    return report


def replay(root: str, strict: bool = False) -> List[Dict[str, Any]]:
    """Every durable record, in sequence order. Non-mutating: it stops at the
    first bad record, or with ``strict=True`` raises
    :class:`JournalCorruptError` there (call :func:`recover` first to
    quarantine a bad tail)."""
    out: List[Dict[str, Any]] = []
    if not os.path.isdir(root):
        return out
    prev_seq: Optional[int] = None
    for _, name in _segments(root):
        seg_path = os.path.join(root, name)
        records, offset, size = _read_segment(seg_path, prev_seq)
        out.extend(records)
        if records:
            prev_seq = records[-1]["seq"]
        if offset < size:
            if strict:
                raise JournalCorruptError(
                    f"corrupt or torn journal record in {seg_path} at byte {offset} "
                    f"(after seq {prev_seq})")
            return out
    return out


def replay_reconciled(root: str) -> List[Dict[str, Any]]:
    """Every durable record of every writer incarnation, in ``(seq,
    incarnation)`` order, a later incarnation's record winning a repeated
    ``seq``.

    :func:`replay` stops at the first discontinuity, which is right for
    recovery but drops a later incarnation that began from an older cut
    than the bytes a reader now sees. For trace analysis this reads each
    segment up to its own torn tail, starts a new incarnation wherever a
    segment's first ``seq`` does not continue the previous segment's, and
    merges. Non-mutating; never raises on corruption."""
    if not os.path.isdir(root):
        return []
    tagged: List[Tuple[int, int, Dict[str, Any]]] = []
    incarnation, prev_last = -1, None
    for _, name in _segments(root):
        records, _, _ = _read_segment(os.path.join(root, name), None)
        if not records:
            continue
        if prev_last is None or records[0]["seq"] != prev_last + 1:
            incarnation += 1
        prev_last = records[-1]["seq"]
        tagged.extend((rec["seq"], incarnation, rec) for rec in records)
    tagged.sort(key=lambda t: (t[0], t[1]))
    out: List[Dict[str, Any]] = []
    for seq, _, rec in tagged:
        if out and out[-1]["seq"] == seq:
            out[-1] = rec
        else:
            out.append(rec)
    return out


class Journal:
    """The write-ahead journal: ``append`` / ``commit`` over rotating
    segments.

    Opening a directory runs :func:`recover` first (its report is
    ``recovery_report``), then starts a fresh segment whose ``seq``
    continues from the last durable record, so a new incarnation never
    writes into an earlier one's files."""

    def __init__(
        self,
        root: str,
        segment_max_bytes: int = 4 * 1024 * 1024,
        barrier: Optional[Callable[[str, Dict[str, Any]], None]] = None,
        sync: bool = True,
    ):
        self.root = root
        self.segment_max_bytes = segment_max_bytes
        # False: write the same bytes without an fsync (a simulator's journal,
        # ``twin/runner.py``); nothing it writes survives a power cut
        self.sync = sync
        self._barrier_cb = barrier
        # re-entrant: ``log`` commits under the lock it appended under
        self._lock = threading.RLock()
        self._buf: List[bytes] = []
        self._closed = False
        os.makedirs(root, exist_ok=True)
        self.recovery_report = recover(root)
        self._seq = self.recovery_report["last_seq"] or 0
        taken = [idx for name in os.listdir(root)
                 if (idx := _segment_index(name.split(".corrupt")[0])) is not None]
        self._segment_index = max(taken) + 1 if taken else 1
        self._fh = None
        self._path = ""
        self._size = 0
        self._open_segment()

    def barrier(self, point: str, **ctx) -> None:
        """Cross a named durability barrier (the crash harness's hook)."""
        cb = self._barrier_cb
        if cb is not None:
            cb(point, ctx)

    def _encode(self, kind: str, data: Dict[str, Any]) -> bytes:
        self._seq += 1
        body = {"seq": self._seq, "ts": round(time.time(), 6), "kind": kind, "data": data}
        rec = dict(body, crc=_crc_of(body))
        return (json.dumps(rec, **_JSON_OPTS) + "\n").encode("utf-8")

    def _open_segment(self) -> None:
        path = _segment_path(self.root, self._segment_index)
        tmp = path + ".tmp"
        header = self._encode("segment_open",
                              {"segment": self._segment_index, "pid": os.getpid()})
        with open(tmp, "wb") as f:
            f.write(header)
            f.flush()
            if self.sync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if self.sync:
            _fsync_dir(self.root)
        self._path = path
        self._fh = open(path, "ab")
        self._size = os.path.getsize(path)
        self.barrier("post-rename", path=path, segment=self._segment_index)

    def _rotate(self) -> None:
        self.barrier("pre-rotate", path=self._path)
        self._fh.flush()
        if self.sync:
            os.fsync(self._fh.fileno())
        self._fh.close()
        self._segment_index += 1
        self._open_segment()

    def append(self, kind: str, **data) -> int:
        """Buffer one record and return its ``seq``. Not durable until the
        next :meth:`commit`."""
        with self._lock:
            if self._closed:
                raise RuntimeError("journal is closed")
            self._buf.append(self._encode(kind, data))
            return self._seq

    def log(self, kind: str, **data) -> int:
        """``append`` and ``commit`` at once, for a record that must be
        durable before the caller goes on."""
        with self._lock:
            seq = self.append(kind, **data)
            self.commit()
            return seq

    def commit(self) -> int:
        """Group-commit every buffered record: one write, one fsync. Returns
        how many records became durable."""
        with self._lock:
            if self._closed:
                raise RuntimeError("journal is closed")
            if not self._buf:
                return 0
            self.barrier("pre-commit", path=self._path, pending=len(self._buf))
            payload = b"".join(self._buf)
            n = len(self._buf)
            self._buf.clear()
            start = self._size
            self._fh.write(payload)
            self._fh.flush()
            # written and not yet fsync'd: a power cut here is the torn tail
            # that recovery quarantines
            self.barrier("mid-fsync", path=self._path, start=start,
                         end=start + len(payload))
            if self.sync:
                os.fsync(self._fh.fileno())
            self._size += len(payload)
            self.barrier("post-commit", path=self._path, seq=self._seq)
            if self._size >= self.segment_max_bytes:
                self._rotate()
            return n

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._buf)

    def close(self) -> None:
        """Commit what is buffered, fsync and close. A simulated kill skips
        this: a dead process flushes nothing."""
        with self._lock:
            if self._closed:
                return
            self.commit()
            self._closed = True
            self._fh.flush()
            if self.sync:
                os.fsync(self._fh.fileno())
            self._fh.close()

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
