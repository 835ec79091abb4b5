"""Versioned on-disk record store: the port's copy of the JAX package's
``serve/cache_store.py``. The calibration pass persists its fitted
profile through it (``kernels/calibrate.save_profile`` /
``load_profile``).

File format (all integers little-endian)::

    record := u32 payload_len | u32 crc32(payload) | payload
    file   := header-record, entry-record*

The header payload is a pickled ``{"magic", "schema"}`` dict; entry
payloads are pickled ``(key, value)`` pairs. Two write paths, two
guarantees:

* :meth:`CacheStore.save` rewrites the whole file via a temp file +
  ``os.replace`` — atomic on POSIX, so a crash mid-save leaves the old
  store intact, never a half-written one.
* :meth:`CacheStore.append` appends entry records to the existing file
  (creating it with a header first). A crash mid-append can only tear
  the *tail* record, and :meth:`load` recovers by keeping every record
  up to the first length/checksum violation.

:meth:`load` never raises on store damage: a missing file, foreign
magic, schema-version mismatch, or corrupt header all fall back to a
cold start (empty dict) with the reason recorded in
:attr:`CacheStore.last_load`. Schema bumps therefore cost a warm cache,
never a crashed server.
"""
from __future__ import annotations

import dataclasses
import io
import os
import pickle
import struct
import tempfile
import zlib

__all__ = ["CacheStore", "SCHEMA_VERSION", "MAGIC"]

#: Bump when the record families change shape in a way pickle cannot
#: bridge; old stores then load as a cold start.
SCHEMA_VERSION = 2
MAGIC = "mcmcomm-sweep-cache"

_LEN = struct.Struct("<II")    # payload_len, crc32


@dataclasses.dataclass
class LoadInfo:
    """Outcome of the last :meth:`CacheStore.load` — cold-start reasons
    are data, not exceptions (the server logs them and proceeds)."""

    entries: int = 0
    cold_start: bool = False
    reason: str = ""
    torn_tail: bool = False     # file ended mid-record; prefix recovered


class CacheStore:
    def __init__(self, path: str):
        self.path = os.fspath(path)
        self.last_load = LoadInfo()

    # ------------------------------------------------------------ write
    def _header_bytes(self) -> bytes:
        return _pack_record(pickle.dumps(
            {"magic": MAGIC, "schema": SCHEMA_VERSION},
            protocol=pickle.HIGHEST_PROTOCOL))

    def save(self, entries: dict) -> int:
        """Atomically rewrite the store with ``entries``; returns the
        entry count. tmp-file + fsync + ``os.replace`` — a crash at any
        point leaves either the old file or the new one, never a mix."""
        buf = io.BytesIO()
        buf.write(self._header_bytes())
        for item in entries.items():
            buf.write(_pack_record(
                pickle.dumps(item, protocol=pickle.HIGHEST_PROTOCOL)))
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".sweep-cache-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(buf.getvalue())
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return len(entries)

    def append(self, entries: dict) -> int:
        """Append ``entries`` to the store (header written first if the
        file does not exist); returns the entry count. A crash mid-append
        tears at most the tail record — :meth:`load` drops it."""
        if not entries:
            return 0
        if not os.path.exists(self.path):
            return self.save(entries)
        with open(self.path, "ab") as f:
            for item in entries.items():
                f.write(_pack_record(
                    pickle.dumps(item, protocol=pickle.HIGHEST_PROTOCOL)))
            f.flush()
            os.fsync(f.fileno())
        return len(entries)

    # ------------------------------------------------------------- read
    def load(self) -> dict:
        """Read the store into ``{fingerprint: record}``. Damage never
        raises: bad header/magic/schema → cold start (``{}``); a torn
        tail record → the intact prefix. Duplicate keys (an appended
        re-solve) resolve last-writer-wins. Details in
        :attr:`last_load`."""
        info = LoadInfo()
        self.last_load = info
        if not os.path.exists(self.path):
            info.cold_start, info.reason = True, "no store file"
            return {}
        with open(self.path, "rb") as f:
            blob = f.read()
        records, torn = _unpack_records(blob)
        info.torn_tail = torn
        if not records:
            info.cold_start, info.reason = True, "empty/unreadable store"
            return {}
        try:
            header = pickle.loads(records[0])
            magic, schema = header["magic"], header["schema"]
        except Exception:
            info.cold_start, info.reason = True, "corrupt header"
            return {}
        if magic != MAGIC:
            info.cold_start, info.reason = True, f"foreign magic {magic!r}"
            return {}
        if schema != SCHEMA_VERSION:
            info.cold_start = True
            info.reason = (f"schema {schema} != {SCHEMA_VERSION} "
                           f"(cold start)")
            return {}
        out: dict = {}
        for payload in records[1:]:
            try:
                key, value = pickle.loads(payload)
            except Exception:
                # An unpicklable entry (e.g. written by a newer code
                # version) skips just that entry, not the store.
                info.torn_tail = True
                continue
            out[key] = value
        info.entries = len(out)
        return out


def _pack_record(payload: bytes) -> bytes:
    return _LEN.pack(len(payload), zlib.crc32(payload)) + payload


def _unpack_records(blob: bytes) -> tuple[list[bytes], bool]:
    """Split a store blob into payloads; stops at the first torn record
    (short length prefix, short payload, or checksum mismatch) and
    reports whether anything was dropped."""
    records: list[bytes] = []
    off, n = 0, len(blob)
    while off < n:
        if off + _LEN.size > n:
            return records, True
        length, crc = _LEN.unpack_from(blob, off)
        off += _LEN.size
        if off + length > n:
            return records, True
        payload = blob[off: off + length]
        if zlib.crc32(payload) != crc:
            return records, True
        records.append(payload)
        off += length
    return records, False
