"""Cost cards: the work a program's hand kernels declare, its roofline time,
and the drift between that model and the device time observed (the port of
``flox_tpu/costmodel.py``).

The reference reads XLA's analytical counts from each compiled program. The
port compiles no programs; its work on the card is done by the hand-written
kernels, and each kernel's wrapper in :mod:`.cuda_kernels` declares what one
launch must move and compute (:func:`note_launch`): every input read once
and every output written once, and its operations, the same counts as the
bound column of the kernels' table in PERF.md.

* **Cards** (:func:`capture`, :func:`ensure_card`): a dispatch site (the
  eager kernels of ``core``, the fused programs of ``fusion``, a mesh
  rank's program, a streaming pass) opens a capture around its launches;
  the card holds the sum over the kernels launched inside it (bytes,
  operations, launches per kernel) and a roofline ``predicted_ms``: the
  larger of bytes over the device's memory rate and operations over its
  float32 rate. Torch ops between the kernels are not on the card: it says
  so (``covers``), and never guesses their cost.
* **Peak table** (:data:`PEAK_TABLE`): keyed by the device's name
  (``torch.cuda.get_device_name()``). A device that is not in it, or the
  CPU, gets a card with ``analysis: "unavailable"`` and no prediction.
* **Roofline join** (:func:`publish_gauges`, :func:`program_report`): the
  ledger row of a label (``telemetry.cost_by_program``) meets its card:
  achieved GB/s, utilization and the ``program.utilization`` /
  ``program.predicted_ms`` gauges.
* **Drift sentinel** (:func:`drift_report`): programs whose observed time
  per dispatch exceeds ``costmodel_drift_threshold`` times the model
  (floored at ``costmodel_overhead_ms``).
* **Capture stamping** (:func:`dispatch_marks`, :func:`stamp_capture`): a
  ``profiling.start_capture`` directory is stamped with the programs
  dispatched inside its window.
* **Autotune prior** (:func:`analytic_prior`): the cold-start decision of an
  autotune family with no measured band, from the card's peak row.

Everything is gated on :func:`enabled`: ``costmodel`` and ``telemetry``.
"""

from __future__ import annotations

import contextvars
import hashlib
import logging
import threading
import time
from typing import Any

from . import telemetry
from .options import OPTIONS

logger = logging.getLogger(__name__)

__all__ = [
    "PEAK_TABLE",
    "analytic_prior",
    "capture",
    "card_for",
    "cards",
    "device_name",
    "dispatch_marks",
    "drift_report",
    "enabled",
    "ensure_card",
    "note_launch",
    "peaks_for",
    "predicted_ms",
    "program_report",
    "publish_gauges",
    "serve_alias",
    "stamp_capture",
]

#: roofline peaks per device name: memory rate (GB/s) and float32 rate
#: (GFLOP/s). The H100 row is NVIDIA's data sheet for the SXM part, at its
#: full 700 W power limit; a card set below it runs slower under load, so
#: every card carries the power limit it was recorded at.
PEAK_TABLE: dict[str, dict[str, Any]] = {
    "NVIDIA H100 80GB HBM3": {
        "bw_gbps": 3350.0,
        "gflops": 67_000.0,
        "source": "H100 SXM data sheet: 3.35 TB/s HBM3, 67 TFLOP/s float32, at 700 W",
    },
}

#: digest -> card, bounded; label -> digest of its newest card
_CARD_REGISTRY: dict[str, dict] = {}
_CARD_LABELS: dict[str, str] = {}
_REGISTRY_MAX = 1024
_LOCK = threading.RLock()

#: the captures open in this context (innermost last): a launch is noted in
#: every one of them, so an outer dispatch site's card holds its inner ones'
_CAPTURES: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "flox_torch_costmodel_captures", default=())

#: device index -> power limit string (``nvidia-smi``), read once
_POWER_LIMITS: dict[int, str | None] = {}

#: the serving plane's program label for whatever runs inside its dispatch:
#: cards recorded (or re-touched) inside a :func:`serve_alias` scope also
#: index under the serving label, so a ``serve[nanmean#ab12]`` ledger row
#: joins the card of the kernels its dispatch launched
_ALIAS: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "flox_tpu_torch_costmodel_alias", default=None
)


def enabled() -> bool:
    """Whether the cost-card plane is on: ``OPTIONS["costmodel"]`` AND
    telemetry (cards join the cost ledger, which exists only enabled)."""
    return bool(OPTIONS["costmodel"]) and telemetry.enabled()


def device_name(device: Any = None) -> str:
    """The peak table's key of ``device``: the CUDA device's name, or
    ``"cpu"``."""
    import torch

    dev = torch.device(device) if device is not None else torch.device("cpu")
    if dev.type != "cuda":
        return dev.type
    return torch.cuda.get_device_name(dev)


def _device_index(device: Any) -> int | None:
    """The CUDA index of ``device`` (None off the card)."""
    import torch

    dev = torch.device(device) if device is not None else torch.device("cpu")
    if dev.type != "cuda":
        return None
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _power_limit(index: int | None) -> str | None:
    """A card's power limit as ``nvidia-smi`` reports it: read once per card,
    when a card is first read (never on a dispatch); None off the card or
    where ``nvidia-smi`` cannot answer."""
    import subprocess

    if index is None:
        return None
    if index not in _POWER_LIMITS:
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                 "-i", str(index)], capture_output=True, text=True, timeout=10, check=True)
            _POWER_LIMITS[index] = out.stdout.strip() or None
        except (OSError, subprocess.SubprocessError):
            _POWER_LIMITS[index] = None
    return _POWER_LIMITS[index]


def peaks_for(name: str | None) -> dict[str, Any] | None:
    """The :data:`PEAK_TABLE` row of a device name, or None."""
    return PEAK_TABLE.get(name) if name is not None else None


def predicted_ms(card: dict, device: str | None = None) -> float:
    """Roofline time of one dispatch of the card's program: the larger of
    bytes over the memory rate and operations over the float32 rate, in ms;
    0.0 for a device with no peak row."""
    peaks = peaks_for(device or card.get("device"))
    if peaks is None:
        return 0.0
    bw_s = float(card.get("bytes_accessed", 0.0)) / (peaks["bw_gbps"] * 1e9)
    fl_s = float(card.get("flops", 0.0)) / (peaks["gflops"] * 1e9)
    return max(bw_s, fl_s) * 1e3


class _Capture:
    """The launches noted inside one dispatch site: kernel name ->
    ``[launches, bytes, flops]``."""

    __slots__ = ("kernels", "_token")

    def __init__(self) -> None:
        self.kernels: dict[str, list] = {}
        self._token: contextvars.Token | None = None

    def __enter__(self) -> "_Capture":
        self._token = _CAPTURES.set(_CAPTURES.get() + (self,))
        return self

    def __exit__(self, *exc: Any) -> bool:
        if self._token is not None:
            try:
                _CAPTURES.reset(self._token)
            except ValueError:  # closed in another context (a generator's late close)
                _CAPTURES.set(tuple(c for c in _CAPTURES.get() if c is not self))
            self._token = None
        return False

    def add(self, kernel: str, nbytes: int, flops: int) -> None:
        row = self.kernels.setdefault(kernel, [0, 0, 0])
        row[0] += 1
        row[1] += int(nbytes)
        row[2] += int(flops)


class _NoCapture:
    __slots__ = ()

    def __enter__(self) -> "_NoCapture":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


_NO_CAPTURE = _NoCapture()


def capture():
    """A context manager collecting the hand-kernel launches of one
    dispatch for :func:`ensure_card`; the shared no-op singleton when the
    plane is off (nothing is allocated)."""
    if not enabled():
        return _NO_CAPTURE
    return _Capture()


def note_launch(kernel: str, nbytes: int, flops: int) -> None:
    """A kernel wrapper's declaration of one launch: the bytes it must move
    (each input read once, each output written once) and its operations.
    Noted in every open :func:`capture`; free when none is open."""
    for cap in _CAPTURES.get():
        cap.add(kernel, nbytes, flops)


def _digest(label: str, sig: str) -> str:
    return hashlib.blake2b(f"{label}\x1f{sig}".encode(), digest_size=12).hexdigest()


class serve_alias:
    """Bind the serving plane's program label: every card recorded or
    re-touched inside also indexes under ``label``. ``None`` binds nothing."""

    __slots__ = ("_label", "_token")

    def __init__(self, label: str | None) -> None:
        self._label = label
        self._token: contextvars.Token | None = None

    def __enter__(self) -> "serve_alias":
        if self._label is not None:
            self._token = _ALIAS.set(str(self._label))
        return self

    def __exit__(self, *exc: Any) -> bool:
        if self._token is not None:
            _ALIAS.reset(self._token)
            self._token = None
        return False


def _index(label: str, digest: str) -> None:
    """Point ``label``, and the active serve alias, at ``digest``. Callers
    hold :data:`_LOCK`."""
    _CARD_LABELS[label] = digest
    alias = _ALIAS.get()
    if alias is not None:
        _CARD_LABELS[alias] = digest


def ensure_card(label: str, cap: Any, device: Any = None) -> str | None:
    """Record (once per label and work signature) the card of the launches
    ``cap`` collected for the program ``label`` on ``device``. Returns the
    card digest, or None when the plane is off. Never raises."""
    if not enabled() or not isinstance(cap, _Capture):
        return None
    try:
        kernels = {k: {"launches": v[0], "bytes": v[1], "flops": v[2]}
                   for k, v in sorted(cap.kernels.items())}
        name = device_name(device)
        sig = repr((name, sorted((k, tuple(v.values())) for k, v in kernels.items())))
        digest = _digest(label, sig)
        with _LOCK:
            if digest in _CARD_REGISTRY:
                _index(label, digest)
                return digest
            if len(_CARD_REGISTRY) >= _REGISTRY_MAX:
                telemetry.count("costmodel.cards_dropped")
                return None
        t0 = time.perf_counter()
        peaks = peaks_for(name)
        card: dict[str, Any] = {
            "label": label,
            "digest": digest,
            "device": name,
            "device_index": _device_index(device),
            "flops": float(sum(v["flops"] for v in kernels.values())),
            "bytes_accessed": float(sum(v["bytes"] for v in kernels.values())),
            "kernels": kernels,
            "covers": "hand kernels only; torch ops between them are not counted",
            "compile_ms": 0.0,
            "recorded_at": time.time(),
        }
        if peaks is None:
            card["analysis"] = f"unavailable:no peak row for {name!r}"
        elif not kernels:
            card["analysis"] = "unavailable:no hand kernel launched"
        else:
            card["analysis"] = "ok"
            card["peaks"] = dict(peaks)
        card["predicted_ms"] = round(predicted_ms(card), 6) if card["analysis"] == "ok" else 0.0
        with _LOCK:
            _CARD_REGISTRY[digest] = card
            _index(label, digest)
        telemetry.METRICS.inc("costmodel.card_analysis_ms", (time.perf_counter() - t0) * 1e3)
        telemetry.count("costmodel.cards_recorded")
        return digest
    except Exception as exc:  # noqa: BLE001 - observability never breaks a dispatch
        logger.debug("cost card for %r failed: %s", label, exc)
        telemetry.count("costmodel.card_errors")
        return None


def _read(card: dict) -> dict:
    """A copy of a card as it is read: with its card's power limit, the
    label the peak row's rates stand beside."""
    return dict(card, power_limit=_power_limit(card.get("device_index")))


def cards() -> dict[str, dict]:
    """A locked copy of the card registry (digest -> card)."""
    with _LOCK:
        registry = dict(_CARD_REGISTRY)
    return {digest: _read(card) for digest, card in registry.items()}


def _card(label: str) -> dict | None:
    with _LOCK:
        digest = _CARD_LABELS.get(label)
        return _CARD_REGISTRY.get(digest) if digest is not None else None


def card_for(label: str) -> dict | None:
    """The newest card recorded under ``label``."""
    card = _card(label)
    return _read(card) if card is not None else None


def _net_device_ms(entry: dict) -> float:
    """Observed device time net of the compile time the row billed (always
    0 in the port, which compiles nothing)."""
    return max(0.0, float(entry.get("device_ms", 0.0)) - float(entry.get("compile_ms", 0.0)))


def _utilization(entry: dict, card: dict) -> dict[str, float]:
    """The roofline join of one ledger row and its card: achieved GB/s and
    GFLOP/s, and utilization = model time / observed time."""
    device_ms = _net_device_ms(entry)
    dispatches = int(entry.get("dispatches", 0))
    if device_ms <= 0.0 or dispatches <= 0:
        return {"utilization": 0.0, "achieved_gbps": 0.0, "achieved_gflops": 0.0}
    seconds = device_ms / 1e3
    achieved_gbps = float(card.get("bytes_accessed", 0.0)) * dispatches / seconds / 1e9
    achieved_gflops = float(card.get("flops", 0.0)) * dispatches / seconds / 1e9
    util = float(card.get("predicted_ms", 0.0)) * dispatches / device_ms
    return {
        "utilization": round(util, 6),
        "achieved_gbps": round(achieved_gbps, 6),
        "achieved_gflops": round(achieved_gflops, 6),
    }


def publish_gauges(label: str, entry: dict) -> None:
    """Update ``program.utilization|program=<label>`` and
    ``program.predicted_ms|program=<label>`` from one ledger row. No-op
    without an analysed card for the label."""
    card = _card(label)
    if card is None or not str(card.get("analysis", "")).startswith("ok"):
        return
    safe = _label_safe(label)
    join = _utilization(entry, card)
    telemetry.METRICS.set_gauge(f"program.utilization|program={safe}", join["utilization"])
    telemetry.METRICS.set_gauge(f"program.predicted_ms|program={safe}",
                                float(card["predicted_ms"]))


def _label_safe(label: str) -> str:
    return str(label).replace("|", "_").replace("=", "_")[:120]


def program_report(top: int | None = None, program: str | None = None) -> dict:
    """The card table joined with the observed cost ledger: one row per
    program label, the card plus ``observed`` (the ledger row), the
    roofline join and the drift ratio against the overhead-floored model.
    ``program`` filters labels by substring; ``top`` keeps the K rows with
    the most observed device time."""
    ledger = telemetry.cost_by_program()
    with _LOCK:
        labels = dict(_CARD_LABELS)
        registry = dict(_CARD_REGISTRY)
    registry = {d: _read(c) for d, c in registry.items()}
    overhead = float(OPTIONS["costmodel_overhead_ms"])
    rows: dict[str, dict] = {}
    for label, digest in labels.items():
        card = registry.get(digest)
        if card is None or (program is not None and program not in label):
            continue
        row = dict(card, label=label)
        entry = ledger.get(label)
        row["observed"] = dict(entry) if entry is not None else None
        if entry is not None:
            row.update(_utilization(entry, card))
            dispatches = int(entry.get("dispatches", 0))
            if dispatches > 0:
                obs_ms = _net_device_ms(entry) / dispatches
                model_ms = max(float(card.get("predicted_ms", 0.0)), overhead)
                row["observed_ms_per_dispatch"] = round(obs_ms, 6)
                row["model_ms"] = round(model_ms, 6)
                row["drift_ratio"] = round(obs_ms / model_ms, 6) if model_ms else None
        rows[label] = row
    if top is not None:
        ranked = sorted(
            rows.items(),
            key=lambda kv: (
                -float((kv[1].get("observed") or {}).get("device_ms", 0.0)),
                -int((kv[1].get("observed") or {}).get("dispatches", 0)),
                kv[0],
            ),
        )
        rows = dict(ranked[:top])
    return {
        "programs": rows,
        "peaks": {name: dict(row) for name, row in PEAK_TABLE.items()},
        "overhead_ms": overhead,
        "drift_threshold": float(OPTIONS["costmodel_drift_threshold"]),
        "datasets": telemetry.cost_by_dataset(),
    }


def drift_report(rows: dict | None = None, threshold: float | None = None) -> dict:
    """The predicted-vs-observed drift sentinel: a program drifts when its
    observed device time per dispatch exceeds ``threshold`` times the model
    (the roofline prediction floored at ``costmodel_overhead_ms``). A
    program seen once is reported, never flagged. ``rows`` defaults to the
    live :func:`program_report` table and takes a saved one's
    ``programs`` mapping too."""
    if threshold is None:
        threshold = float(OPTIONS["costmodel_drift_threshold"])
    if rows is None:
        rows = program_report()["programs"]
    out_rows = []
    flagged = []
    for label in sorted(rows):
        row = rows[label]
        ratio = row.get("drift_ratio")
        if ratio is None or not str(row.get("analysis", "")).startswith("ok"):
            continue
        dispatches = int((row.get("observed") or {}).get("dispatches", 0))
        verdict = dispatches >= 2 and float(ratio) > float(threshold)
        out_rows.append({
            "program": label,
            "observed_ms_per_dispatch": row.get("observed_ms_per_dispatch"),
            "predicted_ms": row.get("predicted_ms"),
            "model_ms": row.get("model_ms"),
            "drift_ratio": ratio,
            "flagged": verdict,
        })
        if verdict:
            flagged.append(label)
    if flagged:
        telemetry.count("costmodel.drift_flagged", len(flagged))
    return {
        "threshold": float(threshold),
        "overhead_ms": float(OPTIONS["costmodel_overhead_ms"]),
        "rows": out_rows,
        "flagged": flagged,
    }


# ---------------------------------------------------------------------------
# autotune prior: the roofline model as the cold-start decision
# ---------------------------------------------------------------------------


def _itemsize(dtype: Any) -> int:
    import numpy as np
    import torch

    name = str(dtype).removeprefix("torch.") if dtype is not None else "float64"
    tdt = getattr(torch, name, None)
    if isinstance(tdt, torch.dtype):
        return tdt.itemsize
    try:
        return np.dtype(name).itemsize
    except TypeError:
        return 8


def analytic_prior(family: str, fallback: str, candidates: tuple, *, dtype: Any = None,
                   ngroups: int = 0, nelems: int = 0, platform: str = "cpu") -> str | None:
    """The roofline's verdict for an autotune family with no measured band,
    or None (the heuristic stands).

    Only on a card with a :data:`PEAK_TABLE` row: the CPU and unknown cards
    are ``"unavailable"``, as their cost cards are. Each candidate is
    modelled as passes over the bytes the kernel wrappers declare, the data
    read once and the accumulators written once, at the card's memory rate:

    * ``fused``: one read for the whole statistic set against one per
      statistic, so fused wins at every size;
    * ``highcard``: dense reads the data once and writes three
      ``ngroups``-wide accumulators; sort reads it three times (the host
      unique pass and the compact relabel) and writes accumulators over at
      most ``nelems`` present groups;
    * ``segment_sum`` (the reference's model): the one-hot GEMM's
      ``2 * nelems * ngroups`` operations at the card's float32 rate against
      ``index_add_``'s one read at a twentieth of the memory rate (atomic
      updates do not stream).

    Counted on ``costmodel.prior_consults`` and ``costmodel.prior_decisions``.
    """
    if not enabled():
        return None
    telemetry.count("costmodel.prior_consults")
    if platform != "cuda":
        return None
    import torch

    if not torch.cuda.is_available():
        return None
    peaks = peaks_for(device_name("cuda"))
    if peaks is None:
        return None
    itemsize = _itemsize(dtype)
    rate = peaks["bw_gbps"] * 1e9 / 1e3  # bytes per ms
    data_bytes = max(0, int(nelems)) * itemsize
    cands = set(candidates)
    n_acc = 3
    choice: str | None = None
    if family == "fused" and {"fused", "sequential"} <= cands:
        choice = "fused"
    elif family == "highcard" and {"dense", "sort"} <= cands:
        present_cap = min(max(0, int(nelems)), max(1, int(ngroups)))
        dense_ms = (data_bytes + n_acc * max(1, ngroups) * itemsize) / rate
        sort_ms = (3 * data_bytes + n_acc * present_cap * itemsize) / rate
        choice = "sort" if sort_ms < dense_ms else "dense"
    elif family == "segment_sum" and {"matmul", "scatter"} <= cands:
        matmul_ms = 2.0 * max(0, int(nelems)) * max(1, int(ngroups)) / (peaks["gflops"] * 1e6)
        scatter_ms = data_bytes / (0.05 * rate)
        choice = "matmul" if matmul_ms < scatter_ms else "scatter"
    if choice is None or choice not in cands:
        return None
    telemetry.count("costmodel.prior_decisions")
    return choice


# ---------------------------------------------------------------------------
# capture stamping: tie a profiler capture directory to the programs it saw
# ---------------------------------------------------------------------------


def dispatch_marks() -> dict[str, int]:
    """Per-label cumulative dispatch counts from the cost ledger: the
    snapshot ``profiling.start_capture`` takes when its window opens."""
    return {label: int(entry.get("dispatches", 0))
            for label, entry in telemetry.cost_by_program().items()}


def stamp_capture(capture_dir: str, marks: dict[str, int] | None) -> str | None:
    """Write ``programs.json`` into a finished capture directory: the labels
    dispatched inside the window (dispatches now minus ``marks``), each with
    its card digest. Never raises; returns the path or None."""
    import json
    import os

    try:
        now = dispatch_marks()
        before = marks or {}
        with _LOCK:
            labels = dict(_CARD_LABELS)
        window = {label: {"dispatches": total - int(before.get(label, 0)),
                          "digest": labels.get(label)}
                  for label, total in now.items() if total > int(before.get(label, 0))}
        path = os.path.join(str(capture_dir), "programs.json")
        payload = {"programs": window, "replica": telemetry.replica_instance(),
                   "host": telemetry.host_name()}
        os.makedirs(str(capture_dir), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path
    except Exception as exc:  # noqa: BLE001 - stamping never breaks a capture
        logger.debug("capture stamp for %s failed: %s", capture_dir, exc)
        return None
