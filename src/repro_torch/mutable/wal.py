"""Write-ahead log: crash-durable write persistence for ``MutableEngine``.

The in-memory oplog is the merge's source of truth but dies with the
process; the WAL is its on-disk twin. Every acknowledged write appends one
binary record *before* it is applied to the live (delta, tombstones)
state, so a restart reconstructs the exact logical corpus by replaying the
log over the last saved index (``MutableEngine(engine, wal_path=...)``
replays automatically on construction).

File layout — one JSON header line, then fixed-layout records:

    {"format": "stable-wal-v1", "feat_dim": M, "attr_dim": L}\n
    b"U" + <int64 id> + M×f32 vector + L×i32 attrs      (upsert)
    b"D" + <int64 id>                                   (delete)

Fixed record layouts make replay allocation-free and make a *torn tail* —
a record cut short mid-write by a crash — detectable by length alone:
``replay`` returns every complete record and truncates the partial tail
away, so the next append starts from a clean record boundary.

Appends are flushed per record (survives a process crash);
``fsync=True`` extends durability to OS/power failure at a heavy
per-write cost. ``reset`` rewrites the log atomically (tmp + rename) —
the checkpoint path: once the merged index is saved, only the
post-checkpoint tail needs to survive.

This module is the reference's ``repro.mutable.wal`` kept as a copy (it
needs numpy only), with the byte format unchanged: each package replays the
other's log.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Iterable, Optional

import numpy as np

__all__ = ["WAL_FORMAT", "WriteAheadLog"]

WAL_FORMAT = "stable-wal-v1"

_ID = struct.Struct("<q")


class WriteAheadLog:
    """Append/replay/reset over one log file. Records are plain tuples
    ``(kind, id, vector, attrs)`` — ``kind`` in {"upsert", "delete"},
    arrays ``None`` for deletes — so the log has no dependency on the
    engine layer that wraps it."""

    def __init__(
        self, path: str, feat_dim: int, attr_dim: int, fsync: bool = False
    ):
        self.path = path
        self.feat_dim = int(feat_dim)
        self.attr_dim = int(attr_dim)
        self.fsync = fsync
        self._upsert_body = 8 + 4 * self.feat_dim + 4 * self.attr_dim
        if os.path.exists(path):
            self._check_header()
        else:
            self._rewrite(())
        self._f = open(path, "ab")

    # -- internals -----------------------------------------------------------

    def _header(self) -> bytes:
        return (
            json.dumps(
                {
                    "format": WAL_FORMAT,
                    "feat_dim": self.feat_dim,
                    "attr_dim": self.attr_dim,
                }
            )
            + "\n"
        ).encode()

    def _check_header(self) -> None:
        with open(self.path, "rb") as f:
            line = f.readline()
        try:
            meta = json.loads(line)
        except ValueError as e:
            raise ValueError(f"{self.path}: not a WAL (bad header)") from e
        if meta.get("format") != WAL_FORMAT:
            raise ValueError(
                f"{self.path}: format {meta.get('format')!r} != {WAL_FORMAT}"
            )
        dims = (meta.get("feat_dim"), meta.get("attr_dim"))
        if dims != (self.feat_dim, self.attr_dim):
            raise ValueError(
                f"{self.path}: WAL dims {dims} != engine "
                f"({self.feat_dim}, {self.attr_dim})"
            )

    def _encode(self, kind, id, vector=None, attrs=None) -> bytes:
        if kind == "delete":
            return b"D" + _ID.pack(int(id))
        if kind != "upsert":
            raise ValueError(f"unknown op kind {kind!r}")
        vec = np.ascontiguousarray(vector, np.float32)
        at = np.ascontiguousarray(attrs, np.int32)
        if vec.shape != (self.feat_dim,) or at.shape != (self.attr_dim,):
            raise ValueError(
                f"op arrays {vec.shape}/{at.shape} != WAL dims "
                f"({self.feat_dim},)/({self.attr_dim},)"
            )
        return b"U" + _ID.pack(int(id)) + vec.tobytes() + at.tobytes()

    def _rewrite(self, ops: Iterable[tuple]) -> None:
        """Atomic whole-log rewrite: header + ``ops`` into a tmp file, then
        rename over the live log."""
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(self._header())
            for kind, id, vector, attrs in ops:
                f.write(self._encode(kind, id, vector, attrs))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    # -- public API ----------------------------------------------------------

    def append(self, kind: str, id: int, vector=None, attrs=None) -> None:
        """Log one write. Flushed before return — callers apply the op to
        live state only after this succeeds (log-before-apply)."""
        self._f.write(self._encode(kind, id, vector, attrs))
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())

    def replay(self) -> list[tuple]:
        """All complete records, in append order. A torn tail (crash
        mid-append) is truncated off the file so subsequent appends start
        at a record boundary."""
        ops: list[tuple] = []
        with open(self.path, "rb") as f:
            f.readline()  # header (validated at construction)
            good = f.tell()
            while True:
                kind = f.read(1)
                if not kind:
                    break
                if kind == b"D":
                    body = f.read(_ID.size)
                    if len(body) < _ID.size:
                        break  # torn tail
                    ops.append(("delete", _ID.unpack(body)[0], None, None))
                elif kind == b"U":
                    body = f.read(self._upsert_body)
                    if len(body) < self._upsert_body:
                        break  # torn tail
                    (id,) = _ID.unpack_from(body)
                    vec = np.frombuffer(
                        body, np.float32, self.feat_dim, offset=8
                    ).copy()
                    at = np.frombuffer(
                        body, np.int32, self.attr_dim,
                        offset=8 + 4 * self.feat_dim,
                    ).copy()
                    ops.append(("upsert", id, vec, at))
                else:
                    raise ValueError(
                        f"{self.path}: corrupt record kind {kind!r} at "
                        f"offset {f.tell() - 1}"
                    )
                good = f.tell()
            torn = f.seek(0, os.SEEK_END) > good
        if torn:
            with open(self.path, "r+b") as f:
                f.truncate(good)
        return ops

    def reset(self, ops: Iterable[tuple] = ()) -> None:
        """Atomically replace the log contents with ``ops`` (empty by
        default) — called after a checkpoint makes the prefix durable
        elsewhere."""
        self._f.close()
        self._rewrite(ops)
        self._f = open(self.path, "ab")

    @property
    def n_bytes(self) -> int:
        """Current on-disk size (observability; grows until checkpoint)."""
        self._f.flush()
        return os.path.getsize(self.path)

    def close(self) -> None:
        if self._f is not None and not self._f.closed:
            self._f.close()
