"""Durable incremental aggregation store (the port of ``flox_tpu/store.py``).

An :class:`IncrementalAggregationStore` appends newly arrived slabs to
persisted per-group intermediate state and answers finalized queries without
recomputing history. The stored carry is the fused statistic set's legs
(:func:`aggregations.plan_fused`: one deduplicated chunk plan for all the
requested statistics), held as one :class:`~multiarray.PresentGroups` layer
per leg: a million-label universe persists only the groups ever seen, and two
slabs with different present groups fold by the union merge
(``PresentGroups.merge``, ``merge_present_var``).

**Compute on the card, carry on the host.** A slab's legs are computed on the
store's device by :func:`aggregations.fused_chunk_stats` over the slab's
present groups plus one pad column (one multi-statistic or segment-sum
launch for the fusable legs), then copied to the host, where the carry is
merged and persisted. The engines are ``"torch"`` (the default, on
``device``, which defaults to CUDA and raises where there is none) and
``"numpy"`` (the host engine, run only when named). A journal whose create
record names the reference's ``"jax"`` engine opens as ``"torch"``; the port
writes ``"torch"``. Query finalizes on the store's device and returns
tensors there.

On-disk layout of a store directory (the reference's, byte for byte)::

    journal.log            append-only log; one checksummed JSON record per
                           line (create / append intent / compact commit)
    seg-<g>.npz            delta segment: generation g's present-group layers
    seg-<lo>-<hi>.npz      compacted segment covering generations lo..hi
    *.corrupt[.N]          quarantined segments (never read again)

The durability protocol:

* **Exactly-once ingestion.** ``append`` journals the slab's fingerprint and
  generation (fsynced) before any state lands; the delta segment's landing
  is the commit point. A replayed slab whose fingerprint is committed acks
  as a no-op; a crash between the intent and the segment leaves an intent
  that recovery skips, and the client's retry ingests the slab once.
* **Checksummed atomic segments.** Every segment is a format-versioned
  ``.npz`` with a blake2b digest per array in its header, landed tmp ->
  fsync -> rename (and the directory fsynced), so a torn write can only
  exist as a detectable half-file.
* **Recovery on open.** The journal replays with per-line checksums (a torn
  tail line is dropped and truncated away), every live segment is verified,
  an unverifiable tail append rolls back to the last complete generation,
  and damage mid-history raises :class:`StoreCorruptionError` after
  quarantining the file.
* **Crash-safe compaction.** The merged segment lands and the journal's
  compact record fsyncs before any replaced segment is deleted; recovery
  falls back to the replaced segments when the compacted one is damaged,
  and finishes interrupted deletes.

:func:`faults.store_inject` kills, tears or flips any durable write; the
recovery-matrix tests kill at every write and check that the reopened store
equals an uninterrupted run bit for bit.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import threading
import warnings
from typing import Any

import numpy as np
import torch

from . import faults, utils
from .aggregations import FusedAggregation, fused_chunk_stats, plan_fused
from .multiarray import MultiArray, PresentGroups, merge_present_var

__all__ = [
    "IncrementalAggregationStore",
    "StoreCorruptionError",
    "open_store",
    "read_checksummed_npz",
    "write_checksummed_npz",
]

#: on-disk format version of checksummed files and the journal
STORE_FORMAT_VERSION = 1

_JOURNAL = "journal.log"
_HEADER_KEY = "__header__"

#: the reference's engine names in the port
_ENGINES = {"torch": "torch", "jax": "torch", "numpy": "numpy"}


class StoreCorruptionError(RuntimeError):
    """Damage that recovery cannot roll back: a checksummed file, a segment
    mid-history or the journal itself failed verification. Carries the
    file's name, so an operator finds the quarantined ``.corrupt`` copy."""

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


def _land_bytes(path: str, data: bytes, *, kind: str, fsync: bool) -> None:
    """Every durable file goes through here: one :func:`faults.store_poke`
    fault point, then tmp -> fsync -> rename, the directory fsynced after."""
    action = faults.store_poke(kind, path) if faults.store_active() else None
    if action == "kill":
        raise faults.StoreWriteKilled(f"before {os.path.basename(path)}")
    if action == "torn":
        # the rename landed but the bytes did not: half a file at the final
        # path, then death
        with open(path, "wb") as f:
            f.write(data[: max(1, len(data) // 2)])
        raise faults.StoreWriteKilled(f"torn write of {os.path.basename(path)}")
    if action == "flip":
        mangled = bytearray(data)
        mangled[len(mangled) // 2] ^= 0x40
        data = bytes(mangled)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync:
        _fsync_dir(path)


def write_checksummed_npz(path: str, arrays: dict, meta: dict, *, kind: str = "segment",
                          fsync: bool = True) -> None:
    """Write a checksummed, format-versioned ``.npz`` atomically.

    The ``__header__`` member carries ``{"format", "meta", "digests"}`` with a
    blake2b digest per array (over its bytes, dtype and shape), so a torn or
    bit-flipped file fails :func:`read_checksummed_npz` instead of loading
    wrong arrays. The streaming checkpointer (``resilience``) spills its
    snapshots this way too."""
    header = {
        "format": STORE_FORMAT_VERSION,
        "meta": meta,
        "digests": {name: _array_digest(np.asarray(a)) for name, a in arrays.items()},
    }
    hdr = np.frombuffer(json.dumps(header, sort_keys=True).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **{_HEADER_KEY: hdr}, **arrays)
    _land_bytes(path, buf.getvalue(), kind=kind, fsync=fsync)


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
        raise StoreCorruptionError(name, f"unreadable segment ({exc})") from exc
    return arrays, header.get("meta", {})


# ---------------------------------------------------------------------------
# the journal: one checksummed JSON record per line
# ---------------------------------------------------------------------------


def _journal_line(record: dict) -> bytes:
    body = json.dumps(record, sort_keys=True)
    return (body + "\t#" + _digest(body.encode()) + "\n").encode()


def _parse_journal(path: str) -> tuple[list[dict], bool, int]:
    """Replay the journal: ``(records, dropped_tail, valid_bytes)``.

    A line failing its checksum at the tail (nothing valid after it) is a
    torn write: dropped, and reported by the flag. A bad line with valid
    lines after it is damage mid-history: :class:`StoreCorruptionError`.
    ``valid_bytes`` is the length of the longest prefix of complete, valid
    records, where a torn tail is truncated so that the next append starts
    on a clean line instead of gluing onto the half-written one."""
    with open(path, "rb") as f:
        raw = f.read()
    records: list[dict] = []
    bad_at: int | None = None
    valid_bytes = 0
    offset = 0
    for i, line in enumerate(raw.split(b"\n")):
        line_end = min(offset + len(line) + 1, len(raw))
        if line.strip():
            rec = None
            try:
                body, got = line.decode().rsplit("\t#", 1)
                if _digest(body.encode()) == got:
                    rec = json.loads(body)
            except (ValueError, UnicodeDecodeError):
                rec = None
            if rec is None:
                if bad_at is None:
                    bad_at = i
            else:
                if bad_at is not None:
                    raise StoreCorruptionError(
                        _JOURNAL, f"journal line {bad_at + 1} failed its checksum mid-history")
                records.append(rec)
                valid_bytes = line_end
        offset = line_end
    return records, bad_at is not None, valid_bytes


def _append_journal(path: str, record: dict, *, fsync: bool) -> None:
    data = _journal_line(record)
    action = faults.store_poke("journal", path) if faults.store_active() else None
    if action == "kill":
        raise faults.StoreWriteKilled("before journal append")
    if action == "torn":
        data = data[: max(1, len(data) // 2)]
    elif action == "flip":
        mangled = bytearray(data)
        mangled[len(mangled) // 3] ^= 0x40
        data = bytes(mangled)
    with open(path, "ab") as f:
        f.write(data)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    if action == "torn":
        raise faults.StoreWriteKilled("torn journal append")


# ---------------------------------------------------------------------------
# layers <-> npz arrays
# ---------------------------------------------------------------------------


def _layers_to_arrays(layers: list) -> dict:
    arrays: dict[str, np.ndarray] = {}
    for i, layer in enumerate(layers):
        if isinstance(layer, tuple):  # the variance triple (m2, total, count)
            arrays[f"leg{i}.present"] = layer[0].present
            for pg, leaf in zip(layer, ("m2", "total", "count")):
                arrays[f"leg{i}.{leaf}"] = np.asarray(pg.values)
        else:
            arrays[f"leg{i}.present"] = layer.present
            arrays[f"leg{i}.values"] = np.asarray(layer.values)
    return arrays


def _arrays_to_layers(arrays: dict, fused: FusedAggregation, size: int) -> list:
    layers: list = []
    for i, op in enumerate(fused.combine):
        present = arrays[f"leg{i}.present"]
        if op == "var":
            layers.append(tuple(PresentGroups(present, arrays[f"leg{i}.{leaf}"], size)
                                for leaf in ("m2", "total", "count")))
        else:
            layers.append(PresentGroups(present, arrays[f"leg{i}.values"], size))
    return layers


def _host(t: Any) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _as_layers(inters: list, present: np.ndarray, size: int, fused: FusedAggregation) -> list:
    """Chunk intermediates (tensors) as host PresentGroups layers. Count legs
    are carried in int64, as the reference's carry holds them (the kernels
    count a slab in int32; a long-lived carry must not wrap)."""
    layers: list = []
    for entry, inter in zip(fused.chunk, inters):
        name = entry[0] if isinstance(entry, tuple) else entry
        if isinstance(inter, MultiArray):
            layers.append(tuple(PresentGroups(present, _host(leaf), size)
                                for leaf in inter.arrays))
        else:
            values = _host(inter)
            if name in ("len", "nanlen"):
                values = values.astype(np.int64)
            layers.append(PresentGroups(present, values, size))
    return layers


class IncrementalAggregationStore:
    """One durable store: open it with :meth:`create` or :meth:`open` (or
    :func:`open_store`), then :meth:`append` slabs, :meth:`query` finalized
    statistics and :meth:`compact` history. Thread-safe (one lock per
    store). The carry is host numpy, so recovery and a serving replica's
    restage never depend on a live device; slabs are reduced on ``device``."""

    def __init__(self, path: str, *, _token: object = None) -> None:
        if _token is not _CTOR_TOKEN:
            raise TypeError("use IncrementalAggregationStore.create/.open")
        self.path = str(path)
        self.name = os.path.basename(os.path.normpath(self.path))
        self._lock = threading.RLock()
        self._layers: list | None = None
        self._lead_shape: tuple = ()
        self._gen = 0
        self._ingested: set[str] = set()
        #: committed deltas since the last compaction: (gen, segment | None)
        self._live: list[tuple[int, str | None]] = []
        self._base: str | None = None
        self._base_lo = 1
        self.recovered = False

    # -- construction -------------------------------------------------------

    @classmethod
    def create(
        cls,
        path: str,
        *,
        funcs,
        size: int,
        array_dtype: Any = "float64",
        fill_value: Any = None,
        min_count: int = 0,
        finalize_kwargs: Any = None,
        engine: str = "torch",
        device: Any = None,
    ) -> "IncrementalAggregationStore":
        """Create an empty store at ``path`` (the directory must not hold
        one yet). The plan (statistic set, label-universe size, slab dtype,
        fills) is fixed here and persisted in the journal's create record.
        ``engine`` is ``"torch"`` (slabs reduced on ``device``, CUDA unless
        the caller names the CPU) or ``"numpy"`` (the host engine)."""
        engine = _resolve_engine(engine)
        dev = _store_device(engine, device)
        os.makedirs(path, exist_ok=True)
        jpath = os.path.join(path, _JOURNAL)
        if os.path.exists(jpath):
            raise FileExistsError(f"store already exists at {path}")
        self = cls(path, _token=_CTOR_TOKEN)
        self._setup_plan(
            funcs=tuple(funcs), size=int(size), array_dtype=np.dtype(array_dtype).name,
            fill_value=fill_value, min_count=int(min_count), finalize_kwargs=finalize_kwargs,
            engine=engine, device=dev,
        )
        _append_journal(
            jpath,
            {
                "rec": "create", "format": STORE_FORMAT_VERSION,
                "funcs": list(self.funcs), "size": self.size,
                "array_dtype": self.array_dtype.name, "fill_value": fill_value,
                "min_count": self.min_count, "finalize_kwargs": finalize_kwargs,
                "engine": engine,
            },
            fsync=self._fsync,
        )
        from . import telemetry

        telemetry.METRICS.inc("store.opens")
        return self

    @classmethod
    def open(cls, path: str, *, device: Any = None) -> "IncrementalAggregationStore":
        """Open an existing store, running crash recovery: replay the
        journal, verify every live segment, roll back an unverifiable tail
        append, quarantine damage, finish interrupted compactions."""
        jpath = os.path.join(path, _JOURNAL)
        if not os.path.exists(jpath):
            raise FileNotFoundError(f"no store at {path}")
        records, dropped_tail, valid_bytes = _parse_journal(jpath)
        if not records or records[0].get("rec") != "create":
            raise StoreCorruptionError(_JOURNAL, "journal has no create record")
        c = records[0]
        engine = _resolve_engine(c.get("engine", "numpy"))
        dev = _store_device(engine, device)
        self = cls(path, _token=_CTOR_TOKEN)
        if dropped_tail:
            # repair the torn tail now: the next append would otherwise glue
            # its record onto the half-written bytes, and a later open would
            # drop that acknowledged generation as a torn tail
            with open(jpath, "r+b") as f:
                f.truncate(valid_bytes)
                f.flush()
                os.fsync(f.fileno())
        self._setup_plan(
            funcs=tuple(c["funcs"]), size=int(c["size"]), array_dtype=c["array_dtype"],
            fill_value=c.get("fill_value"), min_count=int(c.get("min_count", 0)),
            finalize_kwargs=c.get("finalize_kwargs"), engine=engine, device=dev,
        )
        self.recovered = dropped_tail
        self._recover(records[1:])
        from . import telemetry

        telemetry.METRICS.inc("store.opens")
        if self.recovered:
            telemetry.METRICS.inc("store.recoveries")
        return self

    def _setup_plan(self, *, funcs, size, array_dtype, fill_value, min_count,
                    finalize_kwargs, engine, device) -> None:
        self.funcs = tuple(funcs)
        self.size = int(size)
        if self.size <= 0:
            raise ValueError(f"store size must be positive, got {size}")
        self.array_dtype = np.dtype(array_dtype)
        self.fill_value = fill_value
        self.min_count = int(min_count)
        self.finalize_kwargs = finalize_kwargs
        self.engine = engine
        self.device = device
        self.fused: FusedAggregation = plan_fused(
            self.funcs, None, utils.torch_dtype(self.array_dtype), fill_value, self.min_count,
            finalize_kwargs)
        from .options import OPTIONS

        self._fsync = OPTIONS["store_fsync"] != "off"
        self._compact_threshold = int(OPTIONS["store_compact_threshold"])

    # -- recovery -----------------------------------------------------------

    def _seg_path(self, seg: str) -> str:
        return os.path.join(self.path, seg)

    def _quarantine(self, seg: str) -> str | None:
        src = self._seg_path(seg)
        if not os.path.exists(src):
            return None
        dst = src + ".corrupt"
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = src + f".corrupt.{n}"
        os.replace(src, dst)
        return os.path.basename(dst)

    def _verify_entry(self, entry: dict) -> tuple[dict, dict] | None:
        """Load and verify one entry's segment against the journal's claim;
        None when it is not usable (missing, torn, rotten, or another
        record's)."""
        try:
            arrays, meta = read_checksummed_npz(self._seg_path(entry["seg"]))
        except (FileNotFoundError, StoreCorruptionError):
            return None
        if entry["kind"] == "delta":
            if meta.get("gen") != entry["gen"] or meta.get("slab") != entry["fp"]:
                return None
        elif meta.get("lo") != entry["lo"] or meta.get("hi") != entry["hi"]:
            return None
        return arrays, meta

    def _resolve_stack(self, stack: list[dict], warn: list[str]) -> list[dict]:
        """The journal's entry stack -> the verified entries recovery folds,
        under the tail-rollback and compaction-fallback rules. Each verified
        entry carries its arrays under ``"loaded"``."""
        if stack and stack[0]["kind"] == "compact":
            head = stack[0]
            if head["empty"]:
                return [head] + self._resolve_stack(stack[1:], warn)
            loaded = self._verify_entry(head)
            if loaded is not None:
                head["loaded"] = loaded
                return [head] + self._resolve_stack(stack[1:], warn)
            # the compacted segment is damaged: fall back to the segments it
            # replaced while they still verify (a kill during the swap)
            q = self._quarantine(head["seg"])
            warn.append(
                f"compacted segment {head['seg']} failed verification"
                + (f" (quarantined as {q})" if q else "")
                + "; falling back to its replaced segments")
            return self._resolve_stack(head["prev"] + stack[1:], warn)
        out: list[dict] = []
        for i, entry in enumerate(stack):
            if entry["kind"] == "empty":
                out.append(entry)
                continue
            loaded = self._verify_entry(entry)
            if loaded is not None:
                entry["loaded"] = loaded
                out.append(entry)
                continue
            if i == len(stack) - 1:
                # an unverifiable tail append, the crash mid-append: roll back
                # to the last complete generation
                q = self._quarantine(entry["seg"])
                warn.append(
                    f"rolling back generation {entry['gen']}: segment {entry['seg']} is torn "
                    "or missing" + (f" (quarantined as {q})" if q else ""))
                continue
            self._quarantine(entry["seg"])
            raise StoreCorruptionError(
                entry["seg"],
                f"mid-history segment for generation {entry['gen']} failed verification "
                "(quarantined)")
        return out

    def _recover(self, records: list[dict]) -> None:
        stack: list[dict] = []
        gen_fp: dict[int, str] = {}
        for r in records:
            if r.get("rec") == "append":
                gen = int(r["gen"])
                stack = [e for e in stack if e["kind"] == "compact" or e["gen"] != gen]
                stack.append({"kind": "empty" if r.get("empty") else "delta", "gen": gen,
                              "seg": r.get("seg"), "fp": r["slab"]})
                gen_fp[gen] = r["slab"]
            elif r.get("rec") == "compact":
                stack = [{"kind": "compact", "lo": int(r["lo"]), "hi": int(r["hi"]),
                          "seg": r["seg"], "empty": bool(r.get("empty")), "prev": stack}]
        warn: list[str] = []
        resolved = self._resolve_stack(stack, warn)
        if warn:
            self.recovered = True
            for w in warn:
                warnings.warn(f"store {self.name}: {w}", RuntimeWarning, stacklevel=3)
        # fold the verified entries, in order, into the carry
        self._gen = 0
        referenced: set[str] = set()
        for entry in resolved:
            if entry["kind"] == "compact":
                self._gen = entry["hi"]
                self._base_lo = entry["lo"]
                if not entry["empty"]:
                    arrays, meta = entry["loaded"]
                    self._layers = _arrays_to_layers(arrays, self.fused, self.size)
                    self._lead_shape = tuple(meta.get("lead_shape", ()))
                    self._base = entry["seg"]
                    referenced.add(entry["seg"])
            elif entry["kind"] == "empty":
                self._gen = entry["gen"]
                self._live.append((entry["gen"], None))
            else:
                arrays, meta = entry["loaded"]
                layers = _arrays_to_layers(arrays, self.fused, self.size)
                self._merge_layers(layers, tuple(meta.get("lead_shape", ())))
                self._gen = entry["gen"]
                self._live.append((entry["gen"], entry["seg"]))
                referenced.add(entry["seg"])
        self._ingested = {fp for g, fp in gen_fp.items() if g <= self._gen}
        # finish interrupted swaps and drop orphans: a segment file that the
        # resolved state does not reference is garbage (an uncommitted
        # compaction, a replaced segment whose delete was killed)
        for fn in sorted(os.listdir(self.path)):
            full = os.path.join(self.path, fn)
            if fn.endswith(".tmp"):
                with contextlib.suppress(OSError):
                    os.unlink(full)
            elif fn.startswith("seg-") and fn.endswith(".npz") and fn not in referenced:
                with contextlib.suppress(OSError):
                    os.unlink(full)

    # -- slab math ----------------------------------------------------------

    def _slab_fingerprint(self, codes: np.ndarray, array: np.ndarray) -> str:
        h = hashlib.blake2b(digest_size=16)
        h.update(np.ascontiguousarray(codes).tobytes())
        h.update(f"|{codes.dtype.str}|{codes.shape}|".encode())
        h.update(np.ascontiguousarray(array).tobytes())
        h.update(f"|{array.dtype.str}|{array.shape}".encode())
        return h.hexdigest()

    def _stats(self, codes: np.ndarray, array: np.ndarray, size: int) -> list:
        """The fused legs of one slab over ``size`` groups, on the store's
        device."""
        codes_t = torch.from_numpy(np.ascontiguousarray(codes, dtype=np.int32))
        return fused_chunk_stats(self.fused, codes_t.to(self.device),
                                 utils.as_tensor(array, self.device), size=size,
                                 engine=self.engine)

    def _slab_layers(self, codes: np.ndarray, array: np.ndarray) -> list | None:
        valid = (codes >= 0) & (codes < self.size)
        if not valid.all():
            array = array[..., valid]
            codes = codes[valid]
        if codes.size == 0:
            return None
        present, cidx = np.unique(codes, return_inverse=True)
        # one column past the present groups: no element maps there, so the
        # kernels fill it with each leg's identity, the pad column that
        # PresentGroups.scatter_dense and .merge expect
        inters = self._stats(cidx.reshape(-1), array, len(present) + 1)
        return _as_layers(inters, present, self.size, self.fused)

    def _merge_layers(self, layers: list, lead_shape: tuple) -> None:
        if self._layers is None:
            self._layers = layers
            self._lead_shape = lead_shape
            return
        if lead_shape != self._lead_shape:
            raise ValueError(
                f"slab lead shape {lead_shape} != store lead shape {self._lead_shape}")
        merged: list = []
        for cur, new, op in zip(self._layers, layers, self.fused.combine):
            merged.append(merge_present_var(cur, new) if op == "var" else cur.merge(new, op))
        self._layers = merged

    # -- public API ---------------------------------------------------------

    def append(self, codes, array, *, slab_id: str | None = None) -> dict:
        """Ingest one slab exactly once. ``codes`` are dense group codes in
        ``[0, size)`` (codes out of range are dropped, the missing-label
        convention); ``array`` is ``(..., len(codes))``, host numpy or a
        tensor, cast to the store's slab dtype. ``slab_id`` replaces the
        content fingerprint as the idempotency key. Returns the ack dict:
        ``ack`` is ``"ingested"`` or ``"slab_already_ingested"`` (a replay,
        a no-op)."""
        from . import telemetry

        codes = utils.asarray_host(codes).reshape(-1)
        array = np.asarray(utils.asarray_host(array), dtype=self.array_dtype)
        if array.shape[-1] != codes.shape[0]:
            raise ValueError(
                f"array trailing axis {array.shape[-1]} != len(codes) {codes.shape[0]}")
        fp = str(slab_id) if slab_id is not None else self._slab_fingerprint(codes, array)
        with self._lock:
            if fp in self._ingested:
                telemetry.METRICS.inc("store.duplicates")
                return {"store": self.name, "ack": "slab_already_ingested", "gen": self._gen,
                        "slab": fp}
            layers = self._slab_layers(codes, array)
            gen = self._gen + 1
            seg = f"seg-{gen:08d}.npz" if layers is not None else None
            # the intent first: fingerprint and generation are durable before
            # any state lands, the exactly-once ledger
            _append_journal(
                os.path.join(self.path, _JOURNAL),
                {"rec": "append", "gen": gen, "slab": fp, "seg": seg,
                 "empty": layers is None},
                fsync=self._fsync,
            )
            if layers is not None:
                write_checksummed_npz(
                    self._seg_path(seg), _layers_to_arrays(layers),
                    {"kind": "delta", "gen": gen, "slab": fp,
                     "lead_shape": list(array.shape[:-1])},
                    kind="segment", fsync=self._fsync,
                )
                # the commit point: the verified segment is the commit
                self._merge_layers(layers, array.shape[:-1])
            self._gen = gen
            self._ingested.add(fp)
            self._live.append((gen, seg))
            telemetry.METRICS.inc("store.appends")
            telemetry.METRICS.inc("store.append_bytes", int(array.nbytes))
            n_live = len([1 for _, s in self._live if s is not None])
            if self._compact_threshold and n_live > self._compact_threshold:
                self.compact()
            return {"store": self.name, "ack": "ingested", "gen": gen, "slab": fp,
                    "n_present": 0 if self._layers is None else self._n_present()}

    @property
    def gen(self) -> int:
        """The last durable generation (0: an empty store)."""
        return self._gen

    def _n_present(self) -> int:
        first = self._layers[0]
        pg = first[0] if isinstance(first, tuple) else first
        return pg.n_present

    def _dense_inters(self) -> list:
        """The carry scattered to the dense ``(..., size)`` layout, as
        tensors on the store's device."""
        layers = self._layers
        if layers is None:
            # an empty store: a zero-element slab through the real kernels
            # gives every leg its fill or identity in the right dtype
            inters = self._stats(np.zeros(0, dtype=np.int32),
                                 np.zeros(self._lead_shape + (0,), dtype=self.array_dtype), 1)
            layers = _as_layers(inters, np.zeros(0, dtype=np.int64), self.size, self.fused)

        def dense(pg: PresentGroups) -> torch.Tensor:
            return utils.as_tensor(pg.scatter_dense(), self.device)

        return [MultiArray(tuple(dense(pg) for pg in layer)) if isinstance(layer, tuple)
                else dense(layer) for layer in layers]

    def query(self, funcs=None) -> dict:
        """Finalized ``{func: dense (..., size) tensor}`` on the store's
        device for the requested statistics (default: all), from the
        persisted carry: history is never recomputed."""
        from . import telemetry
        from .fusion import finalize_many

        sel = tuple(funcs) if funcs is not None else self.funcs
        unknown = [f for f in sel if f not in self.funcs]
        if unknown:
            raise ValueError(
                f"store {self.name} does not carry {unknown!r} (created with {list(self.funcs)})")
        with self._lock:
            results = self.fused.finalize_fused(self._dense_inters())
            out = finalize_many(self.fused, results)
            telemetry.METRICS.inc("store.queries")
            return {f: out[f] for f in sel}

    def compact(self) -> dict:
        """Fold every live segment into one covering segment. Crash-safe:
        the merged segment lands and the journal's compact record fsyncs
        before any replaced segment is deleted, so a kill at any point
        leaves either the old segments or the new one fully live."""
        from . import telemetry

        with self._lock:
            live_segs = [s for _, s in self._live if s is not None]
            if not live_segs and self._base is None:
                return {"store": self.name, "compacted": False, "gen": self._gen,
                        "segments": 0}
            if self._base is None and len(live_segs) < 2:
                return {"store": self.name, "compacted": False, "gen": self._gen,
                        "segments": len(live_segs)}
            lo, hi = self._base_lo, self._gen
            seg = f"seg-{lo:08d}-{hi:08d}.npz"
            empty = self._layers is None
            if not empty:
                write_checksummed_npz(
                    self._seg_path(seg), _layers_to_arrays(self._layers),
                    {"kind": "compact", "lo": lo, "hi": hi,
                     "lead_shape": list(self._lead_shape)},
                    kind="segment", fsync=self._fsync,
                )
            replaced = ([self._base] if self._base else []) + live_segs
            # the journal record is the commit: from here the compacted
            # segment is the base and the replaced ones are garbage
            _append_journal(
                os.path.join(self.path, _JOURNAL),
                {"rec": "compact", "lo": lo, "hi": hi, "seg": seg, "empty": empty,
                 "replaces": replaced},
                fsync=self._fsync,
            )
            self._base = None if empty else seg
            self._live = []
            for old in replaced:
                if old == seg:
                    continue
                path = self._seg_path(old)
                action = faults.store_poke("swap", path) if faults.store_active() else None
                if action == "kill":
                    raise faults.StoreWriteKilled(f"before swap delete of {old}")
                with contextlib.suppress(FileNotFoundError):
                    os.unlink(path)
            telemetry.METRICS.inc("store.compactions")
            return {"store": self.name, "compacted": True, "gen": self._gen,
                    "segments": 0 if empty else 1, "replaced": len(replaced)}

    def info(self) -> dict:
        """A JSON-able snapshot (no device, no disk)."""
        with self._lock:
            return {
                "store": self.name, "path": self.path,
                "funcs": list(self.funcs), "size": self.size,
                "array_dtype": self.array_dtype.name, "engine": self.engine,
                "device": str(self.device),
                "gen": self._gen, "slabs": len(self._ingested),
                "n_present": 0 if self._layers is None else self._n_present(),
                "segments": (1 if self._base else 0)
                + len([1 for _, s in self._live if s is not None]),
                "recovered": self.recovered,
                "nbytes": self._state_nbytes(),
            }

    def _state_nbytes(self) -> int:
        if self._layers is None:
            return 0
        total = 0
        for layer in self._layers:
            for pg in layer if isinstance(layer, tuple) else (layer,):
                total += int(np.asarray(pg.values).nbytes) + int(pg.present.nbytes)
        return total


_CTOR_TOKEN = object()


def _resolve_engine(engine: str) -> str:
    if engine not in _ENGINES:
        raise ValueError(f"store engine must be 'torch' or 'numpy', got {engine!r}")
    return _ENGINES[engine]


def _store_device(engine: str, device: Any) -> torch.device:
    """The host engine runs on the CPU; the torch engine on ``device``
    (CUDA unless the caller names the CPU)."""
    if engine == "numpy":
        return torch.device("cpu")
    return utils.resolve_device(device)


def open_store(path: str, *, create: dict | None = None,
               device: Any = None) -> IncrementalAggregationStore:
    """Open the store at ``path``; when there is none and ``create`` gives
    the plan (``{"funcs", "size", ...}``, the :meth:`create` keywords),
    create it instead."""
    if os.path.exists(os.path.join(path, _JOURNAL)):
        return IncrementalAggregationStore.open(path, device=device)
    if create is None:
        raise FileNotFoundError(f"no store at {path}")
    return IncrementalAggregationStore.create(path, device=device, **create)
