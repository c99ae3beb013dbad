"""Wire protocol of the JSONL-over-TCP gateway: frames and typed errors.

Counterpart of ``saturn_tpu/service/gateway/protocol.py``, frame for frame
(the same compact, key-sorted JSON, so a frame either package encodes is
the other's byte for byte). One frame per line, UTF-8 JSON, newline
terminated. Requests carry::

    {"op": "submit", "rid": "<session>:<n>", "session": "<client id>",
     "deadline_s": 5.0, "dedup_key": "<session>:d<n>",
     "job": {"name": ..., "total_batches": ..., "priority": ...,
             "deadline_s": ..., "max_retries": ..., "spec": {...}}}

and responses::

    {"rid": "<echoed>", "ok": true,  "result": {...}}
    {"rid": "<echoed>", "ok": false, "error": {"code": "GW_RETRY_AFTER",
     "message": ..., "retriable": true, "retry_after_s": 0.5}}

``rid`` correlates a response with its request: a hostile wire may
duplicate or reorder frames (``resilience/netchaos.py``), so the client
matches by ``rid`` and drops strays. The error codes are closed
(:data:`ERROR_CODES`); :func:`classify_exception` is the one mapping from
the service's exceptions (a duplicate live name, an unknown job id) to
wire errors, and :class:`GatewayError` round-trips through ``to_wire`` /
``from_wire``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

#: Hard per-frame byte cap, the newline included.
MAX_FRAME_BYTES = 256 * 1024

#: Protocol revision, echoed by ``hello``.
PROTO_VERSION = 1

GW_BADFRAME = "GW_BADFRAME"                  # unparseable or oversized frame
GW_BADREQUEST = "GW_BADREQUEST"              # missing or invalid fields, unknown op
GW_DUPLICATE_NAME = "GW_DUPLICATE_NAME"      # the task name is live already
GW_DEADLINE_EXPIRED = "GW_DEADLINE_EXPIRED"  # the request's deadline passed before admission
GW_RETRY_AFTER = "GW_RETRY_AFTER"            # backpressure: an inflight window is full
GW_DRAINING = "GW_DRAINING"                  # the gateway is draining
GW_UNKNOWN_JOB = "GW_UNKNOWN_JOB"            # status / wait / cancel of an unknown id
GW_INTERNAL = "GW_INTERNAL"                  # an unexpected exception of the server
GW_UNAVAILABLE = "GW_UNAVAILABLE"            # client side: every attempt failed
GW_TENANT_OVER_QUOTA = "GW_TENANT_OVER_QUOTA"  # the tenant's inflight window is full
GW_STALE_EPOCH = "GW_STALE_EPOCH"            # the replica lost its lease before the
#                                              commit point: nothing was admitted

ERROR_CODES = frozenset({
    GW_BADFRAME, GW_BADREQUEST, GW_DUPLICATE_NAME, GW_DEADLINE_EXPIRED, GW_RETRY_AFTER,
    GW_DRAINING, GW_UNKNOWN_JOB, GW_INTERNAL, GW_UNAVAILABLE, GW_TENANT_OVER_QUOTA,
    GW_STALE_EPOCH,
})

#: Codes a client retries (after a backoff, or ``retry_after_s``); every
#: other code ends the call.
RETRIABLE_CODES = frozenset({
    GW_RETRY_AFTER, GW_DRAINING, GW_UNAVAILABLE, GW_TENANT_OVER_QUOTA, GW_STALE_EPOCH,
})


class GatewayError(Exception):
    """A typed failure that crosses the wire. ``retriable`` defaults from
    the code; ``retry_after_s`` is the server's backpressure hint."""

    def __init__(self, code: str, message: str = "", *, retriable: Optional[bool] = None,
                 retry_after_s: Optional[float] = None):
        if code not in ERROR_CODES:
            raise ValueError(f"unknown gateway error code {code!r}")
        super().__init__(f"{code}: {message}" if message else code)
        self.code = code
        self.message = message
        self.retriable = retriable if retriable is not None else code in RETRIABLE_CODES
        self.retry_after_s = retry_after_s

    def to_wire(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"code": self.code, "message": self.message,
                               "retriable": self.retriable}
        if self.retry_after_s is not None:
            out["retry_after_s"] = round(float(self.retry_after_s), 6)
        return out

    @classmethod
    def from_wire(cls, payload: Any) -> "GatewayError":
        if not isinstance(payload, dict):
            return cls(GW_INTERNAL, f"malformed error payload: {payload!r}")
        code = payload.get("code")
        if code not in ERROR_CODES:
            return cls(GW_INTERNAL, f"unknown error code {code!r}: {payload.get('message', '')}")
        return cls(code, str(payload.get("message", "")),
                   retriable=bool(payload.get("retriable", code in RETRIABLE_CODES)),
                   retry_after_s=payload.get("retry_after_s"))


def classify_exception(exc: BaseException) -> GatewayError:
    """The wire error of a service exception: the queue's duplicate live
    name (``GW_DUPLICATE_NAME``) and other ``ValueError``s
    (``GW_BADREQUEST``), the registry's unknown job id (``KeyError``,
    ``GW_UNKNOWN_JOB``), anything else ``GW_INTERNAL`` with the exception's
    type in the message."""
    if isinstance(exc, GatewayError):
        return exc
    if isinstance(exc, KeyError):
        return GatewayError(GW_UNKNOWN_JOB, str(exc.args[0]) if exc.args else "unknown job id")
    if isinstance(exc, ValueError):
        if "already live" in str(exc):
            return GatewayError(GW_DUPLICATE_NAME, str(exc))
        return GatewayError(GW_BADREQUEST, str(exc))
    return GatewayError(GW_INTERNAL, f"{type(exc).__name__}: {exc}")


def encode_frame(obj: Dict[str, Any]) -> bytes:
    """One compact, key-sorted JSON object and a newline; a frame over the
    cap raises ``GW_BADFRAME``."""
    data = (json.dumps(obj, sort_keys=True, separators=(",", ":"), default=str)
            + "\n").encode("utf-8")
    if len(data) > MAX_FRAME_BYTES:
        raise GatewayError(GW_BADFRAME, f"frame of {len(data)} bytes exceeds the "
                                        f"{MAX_FRAME_BYTES}-byte cap")
    return data


def decode_frame(line: bytes) -> Dict[str, Any]:
    """One received line as a frame dict, or ``GW_BADFRAME``. A line at the
    cap without its newline is the head of an oversized frame: the
    connection cannot recover, so the caller answers and closes."""
    if len(line) > MAX_FRAME_BYTES or (len(line) >= MAX_FRAME_BYTES
                                       and not line.endswith(b"\n")):
        raise GatewayError(GW_BADFRAME, f"frame exceeds the {MAX_FRAME_BYTES}-byte cap")
    try:
        obj = json.loads(line.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError, ValueError) as e:
        raise GatewayError(GW_BADFRAME, f"unparseable frame: {e}") from e
    if not isinstance(obj, dict):
        raise GatewayError(GW_BADFRAME, f"frame is {type(obj).__name__}, expected object")
    return obj


def ok_response(rid: Any, result: Dict[str, Any]) -> Dict[str, Any]:
    return {"rid": rid, "ok": True, "result": result}


def error_response(rid: Any, err: GatewayError) -> Dict[str, Any]:
    return {"rid": rid, "ok": False, "error": err.to_wire()}
