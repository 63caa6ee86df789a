"""Checksummed ``.npz`` files (the port of ``flox_tpu/store.py``, its
checksum helpers only).

A checksummed file carries a ``__header__`` member with the format version,
caller metadata and a blake2b digest of every array (over its bytes, dtype
and shape), and lands atomically: written to a temporary file, fsynced and
renamed, the directory fsynced after. A torn or bit-flipped file then fails
:func:`read_checksummed_npz` instead of loading wrong arrays. The streaming
checkpointer (``resilience``) spills its snapshots this way.

Left out until ROADMAP A9 ports it: the durable incremental aggregation store
(``IncrementalAggregationStore``, ``open_store``), its journal and its fault
plan.
"""

from __future__ import annotations

import hashlib
import io
import json
import os

import numpy as np

__all__ = ["StoreCorruptionError", "read_checksummed_npz", "write_checksummed_npz"]

#: on-disk format version of checksummed files
STORE_FORMAT_VERSION = 1

_HEADER_KEY = "__header__"


class StoreCorruptionError(RuntimeError):
    """A checksummed file failed verification; carries the file's name."""

    def __init__(self, segment: str, message: str) -> None:
        super().__init__(f"{message} (segment: {segment})")
        self.segment = segment


def _digest(data: bytes) -> str:
    return hashlib.blake2b(data, digest_size=16).hexdigest()


def _array_digest(arr: np.ndarray) -> str:
    a = np.ascontiguousarray(arr)
    return _digest(a.tobytes() + f"|{a.dtype.str}|{a.shape}".encode())


def _fsync_dir(path: str) -> None:
    # a rename is durable only once the directory entry reaches the disk
    try:
        fd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    except OSError:  # a file system without directory handles
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _land_bytes(path: str, data: bytes, *, fsync: bool) -> None:
    """tmp -> fsync -> rename, then the directory's fsync."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync:
        _fsync_dir(path)


def write_checksummed_npz(path: str, arrays: dict, meta: dict, *, fsync: bool = True) -> None:
    """Write a checksummed, format-versioned ``.npz`` atomically."""
    header = {
        "format": STORE_FORMAT_VERSION,
        "meta": meta,
        "digests": {name: _array_digest(np.asarray(a)) for name, a in arrays.items()},
    }
    hdr = np.frombuffer(json.dumps(header, sort_keys=True).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **{_HEADER_KEY: hdr}, **arrays)
    _land_bytes(path, buf.getvalue(), fsync=fsync)


def read_checksummed_npz(path: str) -> tuple[dict, dict]:
    """Load and verify a checksummed ``.npz``: ``(arrays, meta)``.

    Raises :class:`StoreCorruptionError` on any verification failure (an
    unreadable zip, a missing or unknown header, a format from the future, a
    digest mismatch); ``FileNotFoundError`` passes through (absence is not
    corruption)."""
    name = os.path.basename(path)
    try:
        with np.load(path, allow_pickle=False) as z:
            if _HEADER_KEY not in z.files:
                raise StoreCorruptionError(name, "missing checksummed header")
            header = json.loads(z[_HEADER_KEY].tobytes().decode())
            if int(header.get("format", -1)) > STORE_FORMAT_VERSION:
                raise StoreCorruptionError(
                    name, f"format {header.get('format')} is from the future")
            digests = header.get("digests", {})
            arrays = {}
            for arr_name in z.files:
                if arr_name == _HEADER_KEY:
                    continue
                arr = z[arr_name]
                want = digests.get(arr_name)
                if want is None or _array_digest(arr) != want:
                    raise StoreCorruptionError(name, f"checksum mismatch on array {arr_name!r}")
                arrays[arr_name] = arr
            if set(digests) - set(arrays):
                raise StoreCorruptionError(
                    name, f"arrays missing: {sorted(set(digests) - set(arrays))}")
    except (FileNotFoundError, StoreCorruptionError):
        raise
    except Exception as exc:
        # BadZipFile, ValueError, a truncated read: every way a torn or
        # mangled file fails to parse means the same thing
        raise StoreCorruptionError(name, f"unreadable file ({exc})") from exc
    return arrays, header.get("meta", {})
