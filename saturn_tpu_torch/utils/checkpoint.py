"""Train-state checkpoints in the JAX package's sharded manifest format.

Counterpart of ``saturn_tpu/utils/checkpoint.py``, format for format. The
checkpoint path holds a checksummed JSON manifest (``MANIFEST_FORMAT``,
``MANIFEST_VERSION``): every leaf of the train state under its JAX tree path
(``models/convert.state_layout``: ``params/...``, ``opt_state/0/mu/...``,
``opt_state/0/count``, ``step``), its shape, dtype and stored dtype, and its
shards, each a ``(start, stop)`` extent per dimension and the member of a
shard file that holds it; and the fingerprint of the leaves' partition
specs. The bytes live beside it in ``<path>.g<GEN>.r<RANK>.npz`` files; the
port runs one process, rank 0, which writes every block one of its
positions owns into one ``.r0.npz``, each block once (replicas dedupe to the
lowest position, as the JAX package dedupes to the lowest device).
bfloat16 and float8 leaves are stored widened to float32 (``_stored``).
``GEN`` is a per-save generation: a save writes its shard file, then the
manifest to a temporary file renamed over the path (the commit point, after
which the publish hooks run and the older generations' shard files are
removed), so a save killed at any point leaves the previous generation
readable. The crash harness's barriers (``set_crash_barrier``) bracket the
two renames: ``mid-shard-write`` and ``pre-manifest-rename``, crossed by the
synchronous ``save`` only: a kill raised inside ``save_async``'s writer
thread could not end the process it simulates.

A checkpoint written by either package restores in the other: the keys are
the JAX tree's, the extents mesh-agnostic. ``restore`` / ``restore_sharded``
place a checkpoint onto any state: each position of the state's block reads
only the blocks its extent needs (``parallel/sharding.extent`` under the
state's ``placement``: replicated for dp and one device, a rule's specs for
fsdp and tp, over the block's ``data`` or ``data`` x ``model`` mesh), one
leaf at a time, so no host ever holds the whole state twice.

``save_async`` takes the host copy (pinned, one device-to-host copy per
tensor) at the call and leaves the disk write to a thread, one in-flight
write per path: every read, second write, ``exists`` and ``wait`` of that
path waits for it, and a failed write re-raises there (or at ``flush``);
of two failures of a path the first is kept. A state in host memory
(offload's) is written with ``snapshot=False``, from its live tensors; its
owner calls ``wait`` before they change.

Readers sniff the first byte: ``{`` is a manifest of either package; ``PK``
is a single-file checkpoint, the port's ``torch.save`` file from before the
manifest or the JAX package's ``.npz``, both still restorable. ``verify``
checks a manifest's checksum, every shard file's zip CRCs and members, and
that the extents cover every leaf; a reader that cannot read a checkpoint
moves it to a ``.corrupt`` sidecar (``quarantine``) and raises
:class:`CheckpointCorruptError`.
"""

from __future__ import annotations

import glob
import hashlib
import json
import logging
import os
import re
import tempfile
import threading
import time
import zipfile
import zlib
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from saturn_tpu_torch.models import convert
from saturn_tpu_torch.parallel import sharding

log = logging.getLogger("saturn_tpu_torch")

#: Manifest self-identification; readers sniff the first byte (``{`` against
#: zip's ``PK``) and then check this field.
MANIFEST_FORMAT = "saturn-ckpt-manifest"
MANIFEST_VERSION = 1

#: Shard files committed beside a manifest: ``<path>.g<GEN>.r<RANK>.npz``.
_SHARD_RE = re.compile(r"\.g([0-9a-f]+)\.r(\d+)\.npz$")

#: The process that writes: the port runs one.
_RANK = 0


class CheckpointCorruptError(RuntimeError):
    """A checkpoint exists on disk and cannot be read back. It has already
    been moved to a ``.corrupt`` sidecar when this is raised."""

    def __init__(self, path: str, quarantined: str, cause: str):
        self.path = path
        self.quarantined = quarantined
        super().__init__(f"checkpoint {path} is corrupt ({cause}); quarantined to "
                         f"{quarantined}")


def quarantine(path: str) -> str:
    """Rename an unreadable checkpoint to the first free sidecar of
    ``.corrupt``, ``.corrupt.1``, ... and return it (the path itself, the
    file left in place, if the rename fails)."""
    sidecar, n = path + ".corrupt", 0
    while os.path.exists(sidecar):
        n += 1
        sidecar = f"{path}.corrupt.{n}"
    try:
        os.replace(path, sidecar)
    except OSError:
        log.exception("failed to quarantine %s", path)
        return path
    return sidecar


# ------------------------------------------------------------ crash barriers
_CRASH_BARRIER: Optional[Callable[[str, Dict[str, Any]], None]] = None


def set_crash_barrier(cb: Optional[Callable[[str, Dict[str, Any]], None]]) -> None:
    """Install (``None`` clears) the crash harness's callback, called as
    ``cb(point, ctx)`` by ``save`` at ``mid-shard-write`` (the shard file
    staged, not renamed) and ``pre-manifest-rename`` (the shards durable,
    the manifest not renamed)."""
    global _CRASH_BARRIER
    _CRASH_BARRIER = cb


def barrier(point: str, **ctx: Any) -> None:
    """Cross the crash harness's barrier ``point`` through the installed
    callback, if any (the fused unfuse path's ``fused.unfuse`` too)."""
    cb = _CRASH_BARRIER
    if cb is not None:
        cb(point, ctx)


# ---------------------------------------------------------------- sniff/read
def _is_manifest_file(path: str) -> bool:
    """A manifest is JSON (first byte ``{``), a single-file checkpoint a zip
    (``PK``). Raises OSError for a path that cannot be opened."""
    with open(path, "rb") as f:
        return f.read(1) == b"{"


def _is_torch_file(path: str) -> bool:
    """Whether a zip checkpoint is a ``torch.save`` archive (a ``data.pkl``
    record), not an ``.npz``."""
    with zipfile.ZipFile(path) as zf:
        return any(n.endswith("data.pkl") for n in zf.namelist())


def _is_torch_file_safe(path: str) -> bool:
    """:func:`_is_torch_file` of a single-file checkpoint; False for a
    manifest or an unreadable file."""
    try:
        return not _is_manifest_file(path) and _is_torch_file(path)
    except Exception:
        return False


def _manifest_checksum(body: Dict[str, Any]) -> str:
    """CRC-32 of the canonical (sorted-key, no-whitespace) JSON body without
    its ``checksum`` field: a torn or edited manifest fails closed."""
    scrubbed = {k: v for k, v in body.items() if k != "checksum"}
    canon = json.dumps(scrubbed, sort_keys=True, separators=(",", ":"))
    return f"{zlib.crc32(canon.encode('utf-8')) & 0xFFFFFFFF:08x}"


def _read_manifest(path: str) -> Dict[str, Any]:
    """Parse and check a manifest; ``ValueError`` on any mismatch."""
    with open(path, "r", encoding="utf-8") as f:
        body = json.load(f)
    if body.get("format") != MANIFEST_FORMAT:
        raise ValueError(f"not a {MANIFEST_FORMAT} file")
    if int(body.get("version", -1)) > MANIFEST_VERSION:
        raise ValueError(f"manifest version {body['version']} is newer than this reader "
                         f"({MANIFEST_VERSION})")
    want, got = body.get("checksum"), _manifest_checksum(body)
    if want != got:
        raise ValueError(f"manifest checksum mismatch ({want} != {got})")
    return body


def verify(path: str) -> bool:
    """Whether a published checkpoint reads back, without loading it. A
    manifest: its checksum, every shard file present with every zip CRC
    intact and the members it names, and extents that cover each leaf. A
    single file: its zip directory and CRCs (and a ``data.pkl`` record for
    a ``torch.save`` file). False for a missing, truncated, partial or
    corrupt checkpoint; never raises."""
    try:
        if _is_manifest_file(path):
            m = _read_manifest(path)
            d = os.path.dirname(os.path.abspath(path))
            members: Dict[str, set] = {}
            for entry in m["leaves"].values():
                covered = 0
                for sh in entry["shards"]:
                    members.setdefault(sh["file"], set()).add(sh["key"])
                    covered += int(np.prod([max(int(b) - int(a), 0) for a, b in sh["index"]]))
                if covered != int(np.prod([int(x) for x in entry["shape"]])):
                    return False  # a partial shard set
            for fname, keys in members.items():
                with zipfile.ZipFile(os.path.join(d, fname)) as zf:
                    if zf.testzip() is not None:
                        return False
                    if not keys <= {os.path.splitext(n)[0] for n in zf.namelist()}:
                        return False
            return True
        with zipfile.ZipFile(path) as zf:
            names = zf.namelist()
            if any(n.endswith(".pkl") for n in names) and not any(
                    n.endswith("/data.pkl") or n == "data.pkl" for n in names):
                return False
            return zf.testzip() is None
    except Exception:
        return False


# ------------------------------------------------------------ publish hooks
_PUBLISH_HOOKS: List[Callable[[str, str], None]] = []


def add_publish_hook(hook: Callable[[str, str], None]) -> None:
    """Call ``hook(stem, absolute path)`` after every manifest rename, from
    the thread that wrote it (the writer thread for ``save_async``). A hook
    must be cheap; one that raises is logged and skipped."""
    _PUBLISH_HOOKS.append(hook)


def remove_publish_hook(hook: Callable[[str, str], None]) -> None:
    try:
        _PUBLISH_HOOKS.remove(hook)
    except ValueError:
        pass


def _notify_published(path: str) -> None:
    stem = os.path.splitext(os.path.basename(path))[0]
    for hook in list(_PUBLISH_HOOKS):
        try:
            hook(stem, os.path.abspath(path))
        except Exception:
            log.exception("checkpoint publish hook failed for %s", path)


# ---------------------------------------------------------- the state's view
def _stored(arr: np.ndarray) -> np.ndarray:
    """npz holds no bfloat16 or float8: they are stored widened to float32;
    a restore narrows them to the destination's dtype."""
    if arr.dtype.kind == "V" or "bfloat16" in str(arr.dtype) or "float8" in str(arr.dtype):
        return arr.astype(np.float32)
    return arr


def _stored_name(dtype_name: str) -> str:
    return "float32" if ("bfloat16" in dtype_name or "float8" in dtype_name) else dtype_name


def _positions(state: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The positions of a state's block, position 0 first: each a dict with
    ``params`` (the model), ``opt_state`` and, for a sharded state,
    ``shards`` (the tensors its optimizer steps, by parameter name)."""
    return state.get("replicas") or [state]


def _placement(state: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, int]]:
    """(specs by leaf key, mesh axes) of a state: its ``placement``, or every
    leaf replicated over its positions (dp, one device)."""
    pl = state.get("placement")
    if pl is not None:
        return pl["specs"], pl["mesh_axes"]
    return {}, {"data": len(_positions(state))}


def _named(model: Any) -> Dict[str, torch.Tensor]:
    try:
        return dict(model.state_dict(keep_vars=True))
    except TypeError:  # a view whose state_dict takes no arguments
        return dict(model.state_dict())


class _View:
    """One position's tensors by parameter name: its shard where the state
    is sharded, else the model's own tensor; and their optimizer state."""

    def __init__(self, rep: Dict[str, Any]):
        self.shards = rep.get("shards") or {}
        self.named = _named(rep["params"])
        self.opt = rep["opt_state"]

    def tensor(self, name: str) -> torch.Tensor:
        t = self.shards.get(name)
        return self.named[name] if t is None else t

    def opt_state(self, name: str) -> Dict[str, Any]:
        return self.opt.state.get(self.tensor(name), {})

    def stepped(self) -> List[torch.Tensor]:
        return [p for g in self.opt.param_groups for p in g["params"]]


def _layout(state: Dict[str, Any]) -> List[convert.Leaf]:
    """The state's leaves: its placement's ``layout`` where it keeps one
    (tp, whose positions' models hold only their extents), else position
    0's model and optimizer's."""
    layout = (state.get("placement") or {}).get("layout")
    if layout is not None:
        return layout
    rep = _positions(state)[0]
    return convert.state_layout(rep["params"], rep["opt_state"])


def _step_counts(view: _View) -> List[torch.Tensor]:
    """Every step count the position's optimizer keeps (one per parameter
    that has stepped); the JAX layout keeps one, so they must agree."""
    return [st["step"] for p in view.stepped() for st in [view.opt.state.get(p)]
            if st and isinstance(st.get("step"), torch.Tensor)]


def _jsonable(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.item() if obj.numel() == 1 else obj.tolist()
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return str(obj)


# ----------------------------------------------------------------- snapshot
class _Snapshot:
    """A save's manifest body and its members: ``(member key, make)``, where
    ``make()`` gives the member's array. With a host copy the tensors were
    copied at the snapshot; without one ``make`` reads the live tensors."""

    __slots__ = ("manifest", "members", "gen")

    def __init__(self, manifest: Dict[str, Any], members: List[Tuple[str, Callable]], gen: str):
        self.manifest, self.members, self.gen = manifest, members, gen


def _host(t: torch.Tensor, copy: bool, pending: Dict[Any, Any]) -> torch.Tensor:
    """``t`` in host memory: a copy (pinned, queued on the current stream
    without a wait, for a tensor on the card) or, without ``copy``, the
    host tensor itself."""
    t = t.detach()
    if not copy:
        if t.device.type != "cpu":
            raise ValueError(f"a snapshot=False write needs a state in host memory; a tensor "
                             f"is on {t.device}")
        return t
    if not t.is_cuda:
        return t.contiguous() if not t.is_contiguous() else t.clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t.contiguous(), non_blocking=True)
    pending.setdefault(t.device, torch.cuda.current_stream(t.device))
    return host


def _np(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy, bfloat16 and float8 widened to float32 (as
    ``_stored`` widens them: numpy has neither)."""
    if t.dtype == torch.bfloat16 or "float8" in str(t.dtype):
        t = t.float()
    return t.numpy()


def _jax_block(leaf: convert.Leaf, parts: List[torch.Tensor]) -> np.ndarray:
    """A leaf's JAX block from the port tensors' blocks (one per layer of a
    stacked leaf)."""
    arrs = [_np(t) for t in parts]
    if leaf.transpose:
        arrs = [a.T for a in arrs]
    out = np.stack(arrs) if leaf.stacked else arrs[0]
    return _stored(np.ascontiguousarray(out) if out.ndim else out)


def _snapshot(path: str, state: Dict[str, Any], copy: bool = True) -> _Snapshot:
    gen = f"{time.time_ns():x}"
    base = os.path.basename(path)
    fname = f"{base}.g{gen}.r{_RANK}.npz"
    specs, mesh_axes = _placement(state)
    views = [_View(rep) for rep in _positions(state)]
    pending: Dict[Any, Any] = {}
    leaves: Dict[str, Any] = {}
    members: List[Tuple[str, Callable]] = []
    fingerprint = []
    counts = [_step_counts(v) for v in views]
    for leaf in _layout(state):
        spec = tuple(specs.get(leaf.key, ()))
        exts = sharding.extents(spec, leaf.shape, mesh_axes)
        owners: Dict[Any, int] = {}
        for r, e in enumerate(exts):
            owners.setdefault(e, r)
        shards = []
        for i, ext in enumerate(sorted(owners)):
            member = f"{leaf.key}#s{i}"
            shards.append({"index": [[a, b] for a, b in ext], "file": fname, "key": member})
            members.append((member, _producer(leaf, ext, views[owners[ext]],
                                              counts[owners[ext]], state, copy, pending)))
        dtype = convert.leaf_dtype_name(leaf)
        leaves[leaf.key] = {"shape": list(leaf.shape), "dtype": dtype,
                            "stored_dtype": _stored_name(dtype), "shards": shards}
        fingerprint.append([leaf.key, sharding.spec_str(spec)])
    for stream in pending.values():
        stream.synchronize()
    rep = views[0]
    names = [n for n, _ in _positions(state)[0]["params"].named_parameters()]
    manifest = {
        "format": MANIFEST_FORMAT,
        "version": MANIFEST_VERSION,
        "generation": gen,
        "pspec_fingerprint": hashlib.sha1(json.dumps(
            sorted(fingerprint), separators=(",", ":")).encode("utf-8")).hexdigest()[:12],
        "leaves": leaves,
        # what ``load`` needs to give the torch payload back: the
        # optimizer's parameter order by name and its param groups
        "torch": {"names": names,
                  "param_groups": _jsonable(rep.opt.state_dict()["param_groups"])},
    }
    return _Snapshot(manifest, members, gen)


class _Block:
    """A member's array as its shape, dtype and C-order chunks (a stacked
    leaf's layers one after another), so a writer copies one layer at a
    time and never stacks the leaf."""

    __slots__ = ("shape", "dtype", "chunks")

    def __init__(self, shape, dtype, chunks: Iterable[np.ndarray]):
        self.shape, self.dtype, self.chunks = tuple(shape), np.dtype(dtype), chunks


def _layers(leaf: convert.Leaf, parts: List[torch.Tensor], oriented: bool) -> _Block:
    """A leaf's JAX block from the port tensors' blocks (one per layer of a
    stacked leaf), widened as stored; each transposed here unless it is
    already in the JAX orientation (``oriented``)."""
    flip = leaf.transpose and not oriented

    def chunk(t: torch.Tensor) -> np.ndarray:
        # torch's copy of a transpose runs on every core, numpy's on one
        return _np(t.t().contiguous() if flip else t)

    first = parts[0].shape
    per = tuple(reversed(first)) if flip else tuple(first)
    shape = (len(parts), *per) if leaf.stacked else per
    return _Block(shape, _np(parts[0].reshape(-1)[:0]).dtype, (chunk(t) for t in parts))


def _producer(leaf: convert.Leaf, ext, view: _View, count, state, copy: bool,
              pending) -> Callable[[], Any]:
    if leaf.kind == "task_step":
        value = int(state["step"])
        return lambda: np.asarray(value, dtype=np.int32)
    if leaf.kind == "count":
        held = [_host(t, copy, pending) for t in count]

        def make_count() -> np.ndarray:
            values = sorted({float(t) for t in held})
            if len(values) > 1:
                raise ValueError(f"the optimizer's parameters have different step counts "
                                 f"{values}: the JAX layout keeps one count")
            return np.asarray(int(values[0]) if values else 0, dtype=np.int32)

        return make_count
    parts = []
    for j, name in enumerate(leaf.names):
        if leaf.port_extent(ext, j) is None:
            continue
        t = view.tensor(name)
        if leaf.kind != "param":
            st = view.opt_state(name).get(leaf.kind)
            t = torch.zeros_like(t) if st is None else st
        # a copy is taken in the JAX orientation (on the card: a transpose
        # there, not on the writer thread)
        parts.append(_host(t.t() if copy and leaf.transpose else t, copy, pending))
    return lambda: _layers(leaf, parts, oriented=copy)


# ------------------------------------------------------------------- writes
def _write_npz(f, members: Iterable[Tuple[str, Callable[[], Any]]]) -> None:
    """``np.savez``'s file, one member at a time: each member (an array or
    a :class:`_Block`) is made just before it is written, a block layer by
    layer, so at most one layer is copied at once."""
    with zipfile.ZipFile(f, "w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, make in members:
            blk = make()
            with zf.open(key + ".npy", "w", force_zip64=True) as out:
                if isinstance(blk, _Block):
                    np.lib.format.write_array_header_1_0(out, {
                        "descr": np.lib.format.dtype_to_descr(blk.dtype),
                        "fortran_order": False, "shape": blk.shape})
                    for chunk in blk.chunks:
                        out.write(memoryview(np.ascontiguousarray(chunk)).cast("B"))
                else:
                    np.lib.format.write_array(out, np.asanyarray(blk), allow_pickle=False)


def _gc_stale_generations(path: str, keep_gen: str) -> None:
    """After the manifest rename the other generations' shard files are
    unreachable: remove them (a failure only leaks disk)."""
    for f in glob.glob(glob.escape(path) + ".g*.npz"):
        m = _SHARD_RE.search(f)
        if m and m.group(1) != keep_gen:
            try:
                os.unlink(f)
            except OSError:
                log.warning("could not remove stale checkpoint shard %s", f)


def _commit_snapshot(path: str, snap: _Snapshot, barriers: bool) -> None:
    """Stage and rename the shard file, then stage and rename the manifest
    (the commit point) and notify publication; ``barriers``: cross the
    crash harness's two barriers before the renames."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    cb = _CRASH_BARRIER if barriers else None
    if snap.members:
        fname = os.path.join(d, f"{os.path.basename(path)}.g{snap.gen}.r{_RANK}.npz")
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                _write_npz(f, snap.members)
            if cb is not None:
                cb("mid-shard-write", {"path": fname, "tmp": tmp, "gen": snap.gen})
            os.replace(tmp, fname)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    body = dict(snap.manifest)
    body["checksum"] = _manifest_checksum(body)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(body, f, separators=(",", ":"))
        if cb is not None:
            cb("pre-manifest-rename", {"path": path, "tmp": tmp, "gen": snap.gen})
        os.replace(tmp, path)
        _notify_published(path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _gc_stale_generations(path, snap.gen)


def _write(path: str, snap: _Snapshot) -> None:
    """The disk half of ``save_async``, on its writer thread: the commit
    without the crash harness's barriers."""
    _commit_snapshot(path, snap, barriers=False)


def save(path: str, state: Dict[str, Any]) -> None:
    """Write ``state`` to ``path`` now: the shard file, then the manifest,
    crossing the crash harness's barriers. A kill at any point leaves the
    previous checkpoint readable."""
    _wait_pending(path)
    _commit_snapshot(path, _snapshot(path, state), barriers=True)


# --------------------------------------------------------------- async writes
_PENDING: Dict[str, threading.Thread] = {}
_FAILED: Dict[str, BaseException] = {}
_PENDING_LOCK = threading.Lock()


def wait(path: str) -> None:
    """Join the in-flight write of ``path``, if any; re-raise its failure."""
    _wait_pending(path)


def _wait_pending(path: str) -> None:
    key = os.path.abspath(path)
    with _PENDING_LOCK:
        t = _PENDING.get(key)
    if t is not None:
        t.join()
    with _PENDING_LOCK:
        err = _FAILED.pop(key, None)
    if err is not None:
        raise RuntimeError(f"async checkpoint write to {path} failed") from err


def _record_async_failure(key: str, path: str, err: BaseException) -> None:
    """Keep a writer's failure for the next join point; of two unconsumed
    failures of a path the first is kept, the second logged."""
    with _PENDING_LOCK:
        prev = _FAILED.get(key)
        if prev is not None:
            log.warning("async checkpoint write to %s failed again (%r); keeping the first "
                        "error %r", path, err, prev)
        else:
            _FAILED[key] = err


def save_async(path: str, state: Dict[str, Any], snapshot: bool = True) -> None:
    """``save`` with the disk write on a thread: the host copy of every
    block is taken here (the caller goes on updating the state in place).
    ``snapshot=False`` writes the state's own tensors, which must be in host
    memory and must not change before ``wait(path)`` returns."""
    _wait_pending(path)  # at most one in-flight write per path
    snap = _snapshot(path, state, copy=snapshot)
    key = os.path.abspath(path)

    def write():
        try:
            _write(path, snap)
        except BaseException as e:  # re-raised at the next join point
            log.exception("async checkpoint write to %s failed", path)
            _record_async_failure(key, path, e)
        finally:
            with _PENDING_LOCK:
                if _PENDING.get(key) is threading.current_thread():
                    del _PENDING[key]

    t = threading.Thread(target=write, name=f"ckpt-{os.path.basename(path)}", daemon=True)
    with _PENDING_LOCK:
        _PENDING[key] = t
    t.start()


def flush() -> None:
    """Join every outstanding write; re-raise the first failure."""
    with _PENDING_LOCK:
        threads = list(_PENDING.values())
    for t in threads:
        t.join()
    with _PENDING_LOCK:
        errs = dict(_FAILED)
        _FAILED.clear()
    for path, err in errs.items():
        raise RuntimeError(f"async checkpoint write to {path} failed") from err


# --------------------------------------------------------------------- reads
class _ShardReader:
    """The shard files of one manifest, opened at first use. A member
    stored uncompressed (``np.savez`` stores every one) is memory-mapped
    where it lies in the file: a block reads only its own pages, and no
    leaf is copied to be read. ``verify`` checks the members' CRCs."""

    def __init__(self, path: str):
        self._dir = os.path.dirname(os.path.abspath(path))
        self._open: Dict[str, Any] = {}

    def member(self, fname: str, key: str) -> np.ndarray:
        zf = self._open.get(fname)
        fpath = os.path.join(self._dir, fname)
        if zf is None:
            zf = self._open[fname] = zipfile.ZipFile(fpath)
        info = zf.getinfo(key + ".npy")
        if info.compress_type != zipfile.ZIP_STORED:
            with zf.open(info) as f:
                return np.lib.format.read_array(f, allow_pickle=False)
        with open(fpath, "rb") as f:
            f.seek(info.header_offset)
            local = f.read(30)
            if local[:4] != b"PK\x03\x04":
                raise ValueError(f"{fname}: member {key} has no local header")
            name_len, extra_len = int.from_bytes(local[26:28], "little"), int.from_bytes(
                local[28:30], "little")
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            shape, fortran, dtype = (np.lib.format.read_array_header_1_0(f) if version == (1, 0)
                                     else np.lib.format.read_array_header_2_0(f))
            offset = f.tell()
            if not shape:  # a scalar: its few bytes, read
                return np.frombuffer(f.read(dtype.itemsize), dtype=dtype).reshape(())
        if 0 in shape:
            return np.zeros(shape, dtype=dtype)
        return np.memmap(fpath, dtype=dtype, mode="r", offset=offset, shape=shape,
                         order="F" if fortran else "C")

    def close(self) -> None:
        for zf in self._open.values():
            try:
                zf.close()
            except Exception:
                pass
        self._open.clear()


def _assemble_block(entry: Dict[str, Any], reader: _ShardReader, block, dtype) -> np.ndarray:
    """One block (``(start, stop)`` per dimension) of a leaf from its shards;
    a block that is one shard is that member."""
    shape = tuple(b - a for a, b in block)
    for sh in entry["shards"]:
        if tuple((int(a), int(b)) for a, b in sh["index"]) == tuple(block):
            return reader.member(sh["file"], sh["key"]).astype(dtype, copy=False)
    out = np.empty(shape, dtype=dtype)
    covered = 0
    for sh in entry["shards"]:
        src, dst, n = [], [], 1
        for (bs, be), (ss, se) in zip(block, sh["index"]):
            lo, hi = max(bs, int(ss)), min(be, int(se))
            if lo >= hi:
                n = 0
                break
            src.append(slice(lo - int(ss), hi - int(ss)))
            dst.append(slice(lo - bs, hi - bs))
            n *= hi - lo
        if n == 0:
            continue
        out[tuple(dst)] = reader.member(sh["file"], sh["key"])[tuple(src)].astype(dtype, copy=False)
        covered += n
    if covered < int(np.prod(shape)):
        raise ValueError(f"shard set does not cover block {block} ({covered}/"
                         f"{int(np.prod(shape))} elements)")
    return out


def _full(shape) -> Tuple[Tuple[int, int], ...]:
    return tuple((0, int(d)) for d in shape)


class _ManifestSource:
    """Blocks of a manifest's leaves."""

    def __init__(self, path: str, manifest: Dict[str, Any]):
        self.manifest = manifest
        self.reader = _ShardReader(path)

    def keys(self):
        return self.manifest["leaves"].keys()

    def shape(self, key: str) -> Tuple[int, ...]:
        return tuple(self.manifest["leaves"][key]["shape"])

    def block(self, key: str, ext, dtype) -> np.ndarray:
        return _assemble_block(self.manifest["leaves"][key], self.reader, ext, dtype)

    def close(self) -> None:
        self.reader.close()


class _ArraySource:
    """Blocks of full arrays by key (``get(key)``, one leaf at a time)."""

    def __init__(self, get: Callable[[str], np.ndarray], keys: Iterable[str]):
        self._get, self._keys = get, list(keys)
        self._last: Tuple[Optional[str], Any] = (None, None)

    def keys(self):
        return self._keys

    def _arr(self, key: str) -> np.ndarray:
        if self._last[0] != key:
            self._last = (key, self._get(key))
        return self._last[1]

    def shape(self, key: str) -> Tuple[int, ...]:
        return tuple(np.shape(self._arr(key)))

    def block(self, key: str, ext, dtype) -> np.ndarray:
        arr = np.asarray(self._arr(key))
        return arr[tuple(slice(a, b) for a, b in ext)].astype(dtype, copy=False)

    def close(self) -> None:
        self._last = (None, None)


def _load_manifest_arrays(path: str, manifest: Dict[str, Any]) -> Dict[str, np.ndarray]:
    reader = _ShardReader(path)
    try:
        return {key: np.array(_assemble_block(entry, reader, _full(entry["shape"]),
                                              np.dtype(entry["stored_dtype"])))
                for key, entry in manifest["leaves"].items()}
    finally:
        reader.close()


def _corrupt(path: str, e: BaseException) -> CheckpointCorruptError:
    sidecar = quarantine(path)
    log.warning("checkpoint %s unreadable (%r); quarantined to %s", path, e, sidecar)
    return CheckpointCorruptError(path, sidecar, repr(e))


def load_arrays(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint as ``{tree path: full host array}`` in its stored dtype
    (bfloat16 leaves widened to float32), from a manifest or a JAX
    single-file ``.npz``. A missing path raises ``FileNotFoundError``; an
    unreadable or partial checkpoint is quarantined and raises
    :class:`CheckpointCorruptError`."""
    _wait_pending(path)
    is_manifest = _is_manifest_file(path)
    try:
        if is_manifest:
            return _load_manifest_arrays(path, _read_manifest(path))
        if _is_torch_file(path):
            raise ValueError("a torch.save checkpoint of the port before the manifest: "
                             "read it with load or restore")
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    except ValueError as e:
        if not is_manifest and "torch.save" in str(e):
            raise
        raise _corrupt(path, e) from e
    except Exception as e:
        raise _corrupt(path, e) from e


def _torch_payload(path: str, mmap: bool = True) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True, mmap=mmap)


def _legacy_torch_source(payload: Dict[str, Any], layout: List[convert.Leaf],
                         model_names: List[str]) -> _ArraySource:
    """The JAX-layout arrays of a pre-manifest ``torch.save`` payload:
    parameters by name, optimizer state by the model's parameter order."""
    by_key = {leaf.key: leaf for leaf in layout}
    per = payload["opt_state"].get("state", {})
    index_of = {n: i for i, n in enumerate(model_names)}

    def get(key: str) -> np.ndarray:
        leaf = by_key[key]
        if leaf.kind == "task_step":
            return np.asarray(int(payload["step"]), dtype=np.int32)
        if leaf.kind == "count":
            steps = [float(s["step"]) for s in per.values() if "step" in s]
            return np.asarray(int(steps[0]) if steps else 0, dtype=np.int32)
        if leaf.kind == "param":
            parts = [payload["params"][n] for n in leaf.names]
        else:
            parts = [per.get(index_of[n], {}).get(leaf.kind) for n in leaf.names]
            parts = [torch.zeros_like(payload["params"][n]) if t is None else t
                     for t, n in zip(parts, leaf.names)]
        return _jax_block(leaf, [t.detach() for t in parts])

    return _ArraySource(get, by_key)


# ------------------------------------------------------------------ restore
def _restore_leaves(layout: List[convert.Leaf], source, rep: Dict[str, Any]) -> List[convert.Leaf]:
    """The destination's leaves. Where the optimizer's state is keyed by
    parameter name (a model without the JAX tree, or a user's optimizer),
    they are the ``opt_state/<name>/<key>`` leaves the checkpoint holds: a
    fresh optimizer holds no state to lay out yet."""
    kind = convert.optimizer_kind(rep["opt_state"])
    if kind == "sgd" or (kind == "adam" and convert.jax_layout(rep["params"])):
        return layout
    names = {n for n, _ in rep["params"].named_parameters()}
    out = [leaf for leaf in layout if leaf.kind in ("param", "task_step")]
    for key in source.keys():
        m = re.fullmatch(r"opt_state/([^/]+)/([^/]+)", key)
        if m and m.group(1) in names:
            out.append(convert.Leaf(key, source.shape(key), torch.float32, (m.group(1),),
                                    kind=m.group(2)))
    return sorted(out, key=lambda leaf: leaf.key)


class _Groups:
    """The param group of each tensor an optimizer steps."""

    def __init__(self, opt):
        self.of = {id(p): g for g in opt.param_groups for p in g["params"]}

    def step_tensor(self, t: torch.Tensor, value: float) -> torch.Tensor:
        g = self.of.get(id(t), {})
        on_device = bool(g.get("capturable") or g.get("fused"))
        return torch.tensor(float(value), dtype=torch.float32,
                            device=t.device if on_device else "cpu")


def _fill(leaf: convert.Leaf, ext, arr: np.ndarray, view: _View, groups: _Groups,
          state: Dict[str, Any]) -> None:
    """Write one position's block ``arr`` (extent ``ext``) of a leaf into
    its tensors."""
    if leaf.kind == "task_step":
        state["step"] = int(arr)
        return
    if leaf.kind == "count":
        for t in view.stepped():
            st = view.opt.state.setdefault(t, {})
            if isinstance(st.get("step"), torch.Tensor):
                st["step"].fill_(float(arr))
            else:
                st["step"] = groups.step_tensor(t, float(arr))
        return
    for j, name in enumerate(leaf.names):
        pe = leaf.port_extent(ext, j)
        if pe is None:
            continue
        sub = _tensor_of(arr[j - ext[0][0]] if leaf.stacked else arr)
        own = view.tensor(name)
        want = tuple(b - a for a, b in pe)
        if leaf.kind == "param":
            target = own
        else:
            # the optimizer's own state tensor where it has one of this
            # shape (a host-resident state's, filled in place), else a new
            # one: a moment beside its parameter, a per-parameter step count
            # where the optimizer keeps it
            st = view.opt.state.setdefault(own, {})
            target = st.get(leaf.kind)
            if not isinstance(target, torch.Tensor) or tuple(target.shape) != want:
                if leaf.kind == "step" and not want:
                    target = groups.step_tensor(own, 0.0)
                elif want == tuple(own.shape):
                    target = torch.empty_like(own)
                else:
                    target = torch.empty(want, dtype=sub.dtype, device=own.device)
                st[leaf.kind] = target
        if tuple(target.shape) != want:
            raise ValueError(f"{leaf.key}: a position holds {tuple(target.shape)} of "
                             f"{name}, its extent is {want}")
        with torch.no_grad():
            if leaf.transpose:
                # the block goes over as it is stored; the transpose is a
                # copy on the card, or on every host core
                sub = (sub.to(target.device) if target.is_cuda else sub).t()
            target.copy_(sub)


def _tensor_of(arr: np.ndarray) -> torch.Tensor:
    """A host array as a tensor without a copy (an npz member is read-only;
    the tensor is only read)."""
    import warnings

    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(arr)


def _place(path: str, source, state: Dict[str, Any]) -> None:
    specs, mesh_axes = _placement(state)
    reps = _positions(state)
    views = [_View(rep) for rep in reps]
    groups = [_Groups(v.opt) for v in views]
    leaves = _restore_leaves(_layout(state), source, reps[0])
    have = set(source.keys())
    for leaf in leaves:
        if leaf.key not in have:
            raise KeyError(f"checkpoint at {path!r} has no array for tree path {leaf.key!r}")
        if source.shape(leaf.key) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch at {leaf.key!r}: saved "
                             f"{source.shape(leaf.key)} against {tuple(leaf.shape)}")
        exts = sharding.extents(tuple(specs.get(leaf.key, ())), leaf.shape, mesh_axes)
        dtype = np.dtype(_stored_name(convert.leaf_dtype_name(leaf)))
        block: Tuple[Any, Any] = (None, None)
        for r, view in enumerate(views):
            if block[0] != exts[r]:  # replicas of one extent read it once
                block = (exts[r], source.block(leaf.key, exts[r], dtype))
            _fill(leaf, exts[r], block[1], view, groups[r], state)


def restore_sharded(path: str, state: Dict[str, Any]) -> Dict[str, Any]:
    """Place a checkpoint onto ``state`` (in place) and return it: each
    position of the state's block reads the blocks of its extent under the
    state's placement (a rule's specs for a sharded state, replicated for
    dp and one device), one leaf at a time. The cross-technique, cross-block restore:
    a checkpoint of any technique and block restores onto any other.

    The optimizer keeps its own settings (capturable on the card, fused on
    the host); its state tensors are the ones it holds where they exist
    (a host-resident state's, filled in place), else new ones, and every
    parameter's step count is the checkpoint's one count. A CUDA graph
    captured on ``state`` before this call is stale
    (``parallel/spmd_base.py`` captures again). A pre-manifest ``torch.save``
    file restores as before; a missing leaf raises ``KeyError``, a shape
    mismatch ``ValueError``, an unreadable checkpoint is quarantined and
    raises :class:`CheckpointCorruptError`."""
    _wait_pending(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    reps = _positions(state)
    names = [n for n, _ in reps[0]["params"].named_parameters()]
    if reps[0].get("shards") is None and _is_torch_file_safe(path):
        return _restore_torch_file(path, state)
    try:
        if _is_manifest_file(path):
            source = _ManifestSource(path, _read_manifest(path))
        elif _is_torch_file(path):
            source = _legacy_torch_source(_torch_payload(path), _layout(state), names)
        else:
            data = np.load(path)
            source = _ArraySource(lambda k: data[k], data.files)
    except Exception as e:
        raise _corrupt(path, e) from e
    try:
        _place(path, source, state)
    except (KeyError, ValueError):
        raise
    except Exception as e:
        raise _corrupt(path, e) from e
    finally:
        source.close()
    return state


#: Load a checkpoint into a state in place (the JAX package's ``restore``
#: returns host arrays; the port's state holds its own tensors, so both
#: names place the checkpoint by the state's placement).
restore = restore_sharded


def _in_place(opt) -> bool:
    """Whether every parameter of ``opt`` already has its state tensors (a
    host-resident state allocates them up front, in pinned memory)."""
    params = [p for g in opt.param_groups for p in g["params"]]
    return bool(params) and all(opt.state.get(p) for p in params)


def _clone_tensors(obj):
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, dict):
        return {k: _clone_tensors(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_clone_tensors(v) for v in obj)
    return obj


def _restore_torch_file(path: str, state: Dict[str, Any]) -> Dict[str, Any]:
    """A pre-manifest ``torch.save`` checkpoint into a replicated state, as
    it was restored before the manifest: every replica gets the payload."""
    in_place = _in_place(state["opt_state"])
    saved = load(path, mmap=in_place)
    for r, rep in enumerate(_positions(state)):
        if r and not next(rep["params"].parameters()).is_cuda:
            saved = dict(saved, opt_state=_clone_tensors(saved["opt_state"]))
        _restore_replica(rep["params"], rep["opt_state"], saved, in_place)
    state["step"] = int(saved["step"])
    return state


def _restore_replica(model, opt, saved: Dict[str, Any], in_place: bool) -> None:
    model.load_state_dict(saved["params"])
    if in_place:
        params = [p for g in opt.param_groups for p in g["params"]]
        with torch.no_grad():
            for i, per_param in saved["opt_state"]["state"].items():
                own = opt.state[params[int(i)]]
                for k, v in per_param.items():
                    if isinstance(v, torch.Tensor):
                        own[k].copy_(v)
                    else:
                        own[k] = v
    else:
        sd = saved["opt_state"]
        keep = [{k: v for k, v in g.items() if k != "params"} for g in opt.param_groups]
        sd = dict(sd, param_groups=[dict(g, **own) for g, own in zip(sd["param_groups"], keep)])
        opt.load_state_dict(sd)


# ----------------------------------------------------------------- payloads
def _port_tensors(arrays: Dict[str, np.ndarray], prefix: str,
                  dtypes: Dict[str, str]) -> Dict[str, torch.Tensor]:
    """The leaves under ``prefix`` as the port's tensors by name: a block
    leaf (``blocks/<module>/<leaf>``, stacked) one tensor per layer, a
    kernel transposed (:func:`convert.params_from_jax`'s map), any other
    path with its ``/`` read as ``.``; each in the leaf's dtype."""
    out: Dict[str, torch.Tensor] = {}
    for key, arr in arrays.items():
        if not key.startswith(prefix):
            continue
        dtype = getattr(torch, dtypes.get(key, ""), None)
        rest = key[len(prefix):].split("/")
        if len(rest) == 3 and rest[0] == "blocks":
            mod, leaf = rest[1], rest[2]
            for i in range(arr.shape[0]):
                t = torch.from_numpy(np.ascontiguousarray(arr[i].T if leaf == "kernel" else arr[i]))
                name = f"blocks.{i}.{mod}.{'weight' if leaf == 'kernel' else leaf}"
                out[name] = t if dtype is None else t.to(dtype)
        else:
            t = torch.from_numpy(np.array(arr))
            out[".".join(rest)] = t if dtype is None else t.to(dtype)
    return out


def _payload_from_arrays(arrays: Dict[str, np.ndarray], meta: Optional[Dict[str, Any]],
                         dtypes: Dict[str, str]) -> Dict[str, Any]:
    """The torch payload of a checkpoint's arrays: ``{"params": state_dict,
    "opt_state": optimizer state_dict, "step": int}``, the optimizer's state
    by the parameter order the writer recorded (the leaves' order for a JAX
    package's checkpoint)."""
    params = _port_tensors(arrays, "params/", dtypes)
    names = list(meta["names"]) if meta else list(params)
    state: Dict[int, Dict[str, Any]] = {}
    if "opt_state/0/count" in arrays:
        count = torch.tensor(float(arrays["opt_state/0/count"]), dtype=torch.float32)
        mu = _port_tensors(arrays, "opt_state/0/mu/", dtypes)
        nu = _port_tensors(arrays, "opt_state/0/nu/", dtypes)
        for i, n in enumerate(names):
            if n in mu:
                state[i] = {"step": count.clone(), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
    else:
        for i, n in enumerate(names):
            per = {k.rsplit("/", 1)[1]: torch.from_numpy(np.array(v))
                   for k, v in arrays.items() if k.startswith(f"opt_state/{n}/")}
            if per:
                state[i] = per
    groups = (meta or {}).get("param_groups") or [{"params": list(range(len(names)))}]
    return {"params": params, "opt_state": {"state": state, "param_groups": groups},
            "step": int(arrays["step"])}


def load(path: str, map_location="cpu", mmap: bool = False) -> Dict[str, Any]:
    """A checkpoint as the torch payload ``{"params": state_dict,
    "opt_state": optimizer state_dict, "step": int}``, in host memory, from
    any format (a pre-manifest ``torch.save`` file as it was written, its
    tensors memory-mapped with ``mmap``). A missing path raises
    ``FileNotFoundError``; an unreadable checkpoint is quarantined and
    raises :class:`CheckpointCorruptError`."""
    _wait_pending(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    try:
        if _is_manifest_file(path):
            m = _read_manifest(path)
            dtypes = {k: e["dtype"] for k, e in m["leaves"].items()}
            return _payload_from_arrays(_load_manifest_arrays(path, m), m.get("torch"), dtypes)
        if _is_torch_file(path):
            return torch.load(path, map_location=map_location, weights_only=True, mmap=mmap)
        with np.load(path) as data:
            arrays = {k: data[k] for k in data.files}
        return _payload_from_arrays(arrays, None, {})
    except Exception as e:
        raise _corrupt(path, e) from e


def saved_step(path: str) -> int:
    """The step count of a checkpoint, read without its other leaves."""
    _wait_pending(path)
    if _is_manifest_file(path):
        source = _ManifestSource(path, _read_manifest(path))
        try:
            return int(source.block("step", (), np.dtype("int32")))
        finally:
            source.close()
    if _is_torch_file(path):
        return int(_torch_payload(path)["step"])
    with np.load(path) as data:
        return int(data["step"])


def exists(path: str) -> bool:
    """Whether a checkpoint is at ``path`` (after its in-flight write)."""
    _wait_pending(path)
    return os.path.exists(path)


def delete(path: str) -> None:
    """Remove a checkpoint: the manifest (or single file) and every
    generation's shard files; sidecars stay (evidence, not state)."""
    try:
        _wait_pending(path)
    except RuntimeError:
        pass  # a failed write is moot: the checkpoint goes
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass
    for f in glob.glob(glob.escape(path) + ".g*.npz"):
        if _SHARD_RE.search(f):
            try:
                os.unlink(f)
            except OSError:
                log.warning("could not remove checkpoint shard %s", f)


# ------------------------------------------------------------------- views
def summarize(path: str) -> Dict[str, Any]:
    """One checkpoint's summary: format, leaf, shard and shard-file counts,
    bytes on disk, partition-spec fingerprint, generation and ``verify``'s
    verdict. Never raises: an unreadable checkpoint reports ``ok: False``."""
    out: Dict[str, Any] = {"path": path, "ok": False, "format": None, "leaves": 0,
                           "shards": 0, "shard_files": 0, "bytes": 0,
                           "pspec_fingerprint": None, "generation": None}
    try:
        out["bytes"] = os.path.getsize(path)
        if _is_manifest_file(path):
            out["format"] = "sharded-manifest"
            m = _read_manifest(path)
            out["generation"] = m.get("generation")
            out["pspec_fingerprint"] = m.get("pspec_fingerprint")
            out["leaves"] = len(m["leaves"])
            d = os.path.dirname(os.path.abspath(path))
            files = set()
            for entry in m["leaves"].values():
                out["shards"] += len(entry["shards"])
                files.update(sh["file"] for sh in entry["shards"])
            out["shard_files"] = len(files)
            for fname in files:
                fpath = os.path.join(d, fname)
                if os.path.exists(fpath):
                    out["bytes"] += os.path.getsize(fpath)
        elif _is_torch_file(path):
            out["format"] = "legacy-torch"
            payload = _torch_payload(path)
            out["leaves"] = out["shards"] = len(payload["params"])
            out["shard_files"] = 1
        else:
            out["format"] = "legacy-npz"
            with np.load(path) as data:
                out["leaves"] = out["shards"] = len(data.files)
            out["shard_files"] = 1
        out["ok"] = verify(path)
    except Exception as e:
        out["error"] = repr(e)
    return out


def summarize_dir(directory: str) -> Dict[str, Any]:
    """A directory's checkpoints (manifest or single file), ``.corrupt``
    sidecars, and shard files no readable manifest names."""
    directory = os.path.abspath(directory)
    checkpoints, sidecars, shard_files, referenced = [], [], set(), set()
    for name in sorted(os.listdir(directory)):
        full = os.path.join(directory, name)
        if not os.path.isfile(full) or name.endswith(".tmp"):
            continue
        if ".corrupt" in name:
            sidecars.append(name)
            continue
        if _SHARD_RE.search(name):
            shard_files.add(name)
            continue
        if name.endswith((".npz", ".pt")):
            summ = summarize(full)
            checkpoints.append(summ)
            if summ.get("format") == "sharded-manifest" and summ.get("ok"):
                for entry in _read_manifest(full)["leaves"].values():
                    referenced.update(sh["file"] for sh in entry["shards"])
    return {"dir": directory, "checkpoints": checkpoints, "corrupt_sidecars": sidecars,
            "orphan_shards": sorted(shard_files - referenced),
            "total_bytes": sum(c.get("bytes", 0) for c in checkpoints)}
