"""``python -m flox_tpu_torch.serve`` — JSON-lines serving loop (the port of
``flox_tpu/serve/__main__.py``).

Requests reduce on ``--device`` (default ``cuda``; without CUDA the default
raises, and ``--device cpu`` runs on the CPU). Resident datasets and stores
live on the same device.

One JSON object per input line (stdin by default, ``--input FILE`` for
scripted runs), one JSON object per output line. Request lines carry the
:class:`~flox_tpu_torch.serve.AggregationRequest` fields::

    {"id": "r1", "func": "sum", "array": [...], "by": [...],
     "options": {"default_engine": "numpy"}, "deadline": 0.5}

and are submitted CONCURRENTLY as they are read — lines arriving within
the batching window coalesce / micro-batch exactly as library callers do.
Responses are emitted as each completes (match them by ``id``)::

    {"id": "r1", "ok": true, "result": [...], "groups": [...],
     "coalesced": false, "batch": 1, "queue_ms": 0.4, "device_ms": 2.1}
    {"id": "r2", "ok": false, "error": "LoadShedError", "code": "load_shed",
     "retry_after_ms": 2.0, "message": "..."}

Serving-layer failures carry a machine-readable ``code``
(``load_shed`` / ``deadline_exceeded`` / ``circuit_open`` /
``device_lost`` / ``watchdog_timeout`` / ``draining``) plus an optional
``retry_after_ms`` hint, so clients branch on the code instead of
string-matching Python class names.

Control lines use ``op`` instead of ``func``:

* ``{"op": "warmup"}`` — replay the warmup manifest (:func:`serve.aot.warmup`);
  responds with ``{"warmed": N, "compiles": <kernel libraries nvcc built
  in this process>}``.
* ``{"op": "stats"}`` — cache.stats() + the telemetry counter snapshot +
  ``compiles`` (the kernel libraries built in this process: the
  two-process warm-restart check reads it; the per-program/per-tenant cost
  ledger rides ``cache.cost_by_program`` / ``cache.cost_by_tenant``;
  breaker state rides ``cache.serve_breakers``).
* ``{"op": "put_dataset", "name", "array", "by", "expected_groups"}``,
  ``{"op": "del_dataset", "name"}``, ``{"op": "list_datasets"}`` — the
  resident dataset registry (:mod:`.registry`).
* ``{"op": "append", "store", "codes", "array", "slab_id", "create"}``,
  ``{"op": "query", "store", "funcs"}``, ``{"op": "compact", "store"}``,
  ``{"op": "list_stores"}`` — the durable stores under
  ``OPTIONS["store_root"]`` (:mod:`.stores`).
* ``{"op": "profile", "seconds": N}`` — start an on-demand capture
  into ``OPTIONS["profile_dir"]`` (409-equivalent ``"busy"`` while one
  runs, ``"unavailable"`` on profiler-less backends).
* ``{"op": "drain"}`` — wait for every in-flight request before reading on
  (scripted runs use it to sequence assertions).
* ``{"op": "shutdown"}`` — graceful drain: admission stops, ``/readyz``
  flips 503 immediately, in-flight requests finish within
  ``serve_drain_timeout``, the flight recorder dumps, and the process
  exits 0. SIGTERM triggers the exact same path (the supervisor's
  rolling-restart signal must never kill a request mid-flight).

Request lines may carry a ``"tenant"`` tag: it feeds the per-tenant cost
ledger and a ``serve.request_ms{tenant=...}`` histogram on /metrics
without affecting coalescing or results.

The loop exits at EOF after draining in-flight work. Malformed lines get
an ``ok: false`` response with ``error: "protocol"`` — one bad client line
must never take the replica down.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import sys
import threading
import time
from typing import Any

import numpy as np

from .. import _build
from . import aot
from .dispatcher import AggregationRequest, Dispatcher, ServeError

_REQUEST_FIELDS = frozenset(
    {
        "func", "array", "by", "expected_groups", "fill_value", "dtype",
        "min_count", "engine", "finalize_kwargs", "options", "deadline",
        "tenant", "traceparent", "dataset", "rows", "mask",
    }
)

#: soft bound on lines buffered ahead of the serve loop — a scripted
#: multi-GB request file must not load wholesale into the line queue
_READER_HIGH_WATER = 512


def _emit(obj: dict) -> None:
    # all emits run on the event-loop thread, so lines never interleave
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def _counters() -> dict:
    from .. import cache
    from ..telemetry import METRICS

    return {"cache": cache.stats(), "counters": METRICS.snapshot(),
            "compiles": _build.BUILDS["count"]}


def _error_response(rid: str, exc: Exception) -> dict:
    """The typed error envelope: the exception class (back-compat), the
    machine-readable ``code``, and the ``retry_after_ms`` hint when the
    failure kind has one (load shed, open breaker)."""
    out: dict[str, Any] = {
        "id": rid, "ok": False,
        "error": type(exc).__name__, "message": str(exc),
    }
    if isinstance(exc, ServeError):
        out["code"] = exc.code
        if exc.retry_after_ms is not None:
            out["retry_after_ms"] = round(float(exc.retry_after_ms), 3)
        if exc.program is not None:
            out["program"] = exc.program
    else:
        out["code"] = "execution"
    return out


async def _serve_request(dispatcher: Dispatcher, line_no: int, msg: dict) -> None:
    from .. import telemetry

    rid = msg.get("id", f"line-{line_no}")
    try:
        unknown = set(msg) - _REQUEST_FIELDS - {"id"}
        if unknown:
            raise ValueError(f"unknown request fields: {sorted(unknown)}")
        if msg.get("dataset") is not None and (
            msg.get("by") is not None or msg.get("expected_groups") is not None
        ):
            raise ValueError(
                "a 'dataset' request must not also carry 'by'/"
                "'expected_groups' — they were fixed at put_dataset time"
            )
        request = AggregationRequest(
            request_id=rid, **{k: v for k, v in msg.items() if k != "id"}
        )
    except Exception as exc:  # noqa: BLE001 — malformed envelope, client's bug
        telemetry.record_serve_error(exc, what=f"protocol line {line_no}")
        _emit({"id": rid, "ok": False, "error": "protocol", "code": "protocol",
               "message": str(exc)})
        return
    try:
        result = await dispatcher.submit(request)
    except ServeError as exc:
        _emit(_error_response(rid, exc))
    except Exception as exc:  # noqa: BLE001 — execution failed, NOT a protocol
        # error: report the real class so clients can tell a bad func/dtype
        # apart from a malformed line (and never kill the loop over it).
        # The flight ring keeps the record: the dispatcher already
        # classified the failure, this preserves WHICH request wore it.
        telemetry.record_serve_error(exc, what=f"request {rid}")
        _emit(_error_response(rid, exc))
    else:
        # multi-statistic requests (func = a list of names) answer with a
        # {func: values} object; single statistics stay a flat list
        if isinstance(result.result, dict):
            payload = {k: np.asarray(v).tolist() for k, v in result.result.items()}
        else:
            payload = np.asarray(result.result).tolist()
        out = {
            "id": rid,
            "ok": True,
            "result": payload,
            "groups": np.asarray(result.groups).tolist(),
            "coalesced": result.coalesced,
            "batch": result.batch_size,
            "queue_ms": round(result.queue_ms, 3),
            "device_ms": round(result.device_ms, 3),
        }
        if result.traceparent is not None:
            # trace-context echo: same trace id the request carried, this
            # replica's handling as the new parent span — the hop chains
            out["traceparent"] = result.traceparent
            out["trace_id"] = result.trace_id
        _emit(out)


def _start_reader(stream: Any, loop: asyncio.AbstractEventLoop) -> asyncio.Queue:
    """Feed input lines into an asyncio queue from a daemon thread.

    A daemon reader (instead of ``asyncio.to_thread(stream.readline)``)
    is what makes the graceful drain exit-able: a drain that begins while
    the process is blocked reading stdin must not wait for one more line —
    the loop simply stops consuming the queue, and the parked thread dies
    with the process instead of wedging executor shutdown."""
    queue: asyncio.Queue = asyncio.Queue()

    def _read() -> None:
        line_no = 0
        try:
            for line in stream:
                line_no += 1
                while queue.qsize() > _READER_HIGH_WATER:
                    time.sleep(0.005)  # soft back-pressure on scripted files
                loop.call_soon_threadsafe(queue.put_nowait, (line_no, line))
        except (RuntimeError, ValueError, OSError):
            pass  # loop closed / stream torn down mid-read: exit quietly
        try:
            loop.call_soon_threadsafe(queue.put_nowait, None)  # EOF sentinel
        except RuntimeError:
            pass

    threading.Thread(target=_read, name="flox-tpu-torch-serve-reader", daemon=True).start()
    return queue


async def _drain_and_exit(
    dispatcher: Dispatcher, pending: set[asyncio.Task], source: str
) -> None:
    """Finish in-flight work within ``serve_drain_timeout``, then dump.

    Requests still unfinished past the budget are cancelled (their waiters
    see the cancellation, never a silent drop) and counted on
    ``serve.drain_abandoned``."""
    from .. import telemetry
    from ..options import OPTIONS
    from ..telemetry import METRICS

    budget = float(OPTIONS["serve_drain_timeout"] or 0)
    deadline = time.monotonic() + budget
    abandoned = 0
    if pending:
        done, not_done = await asyncio.wait(
            set(pending), timeout=budget if budget > 0 else 0
        )
        for task in not_done:
            task.cancel()
            abandoned += 1
    remaining = max(0.0, deadline - time.monotonic())
    try:
        await asyncio.wait_for(dispatcher.close(), remaining or 0.001)
    except (asyncio.TimeoutError, TimeoutError):
        abandoned += 1
    if abandoned:
        METRICS.inc("serve.drain_abandoned", abandoned)
    # flight_dump writes files: off the loop so a slow disk cannot stall
    # the final shutdown handshake
    await asyncio.to_thread(telemetry.flight_dump, reason=f"drain:{source}")
    _emit(
        {
            "op": "shutdown", "ok": True, "source": source,
            "abandoned": abandoned,
        }
    )


async def _amain(args: argparse.Namespace) -> int:
    import signal

    from .. import exposition, utils
    from ..options import OPTIONS, set_options

    device = utils.resolve_device(args.device)
    if args.aot_dir:
        set_options(serve_aot_dir=args.aot_dir)
    if args.replica_id:
        # validated like any set_options value (label-safe, bounded): a
        # bad --replica-id dies at startup, not at first scrape
        set_options(replica_id=args.replica_id)
    metrics_port = (
        args.metrics_port if args.metrics_port is not None else OPTIONS["metrics_port"]
    )
    from .. import telemetry

    if metrics_port:
        bound = exposition.start_metrics_server(port=metrics_port, host=args.metrics_host)
        _emit({"op": "metrics", "port": bound,
               "replica": telemetry.replica_instance()})
    # a clock anchor near startup: a trace join aligns this replica's jsonl
    # export onto a shared timeline from it (no-op, telemetry off)
    telemetry.anchor_event()
    if args.warmup:
        warmed = await asyncio.to_thread(aot.warmup, device=device)
        _emit({"warmed": warmed, "compiles": _build.BUILDS["count"]})
    # /readyz flips here: the warmup manifest (when requested) has been
    # replayed, so a load balancer routing on readiness never hands traffic
    # to a replica still building its kernels
    exposition.set_ready(True)
    dispatcher = Dispatcher(
        queue_depth=args.queue_depth,
        deadline=args.deadline,
        microbatch_max=args.microbatch_max,
        batch_window=args.batch_window,
        device=device,
    )
    # the SLO canary prober: known-answer requests on a period, billed to the
    # reserved tenant, feeding the correctness SLO; off at 0 (the default)
    canary_interval = (
        args.canary_interval if args.canary_interval is not None
        else OPTIONS["slo_canary_interval"]
    )
    canary_task: asyncio.Task | None = None
    if canary_interval:
        from .. import slo

        canary_task = asyncio.ensure_future(slo.canary_loop(dispatcher, float(canary_interval)))
        _emit({"op": "canary", "interval": float(canary_interval)})
    drain_event = asyncio.Event()
    drain_state: dict[str, str] = {}

    def _begin_drain(source: str) -> None:
        # idempotent: a second SIGTERM during a drain changes nothing.
        # Readiness flips 503 FIRST (the router stops routing), THEN
        # admission closes, THEN in-flight work finishes.
        if drain_state:
            return
        drain_state["source"] = source
        exposition.set_ready(False, reason="draining")
        dispatcher.begin_drain()
        drain_event.set()

    loop = asyncio.get_running_loop()
    try:
        loop.add_signal_handler(
            signal.SIGTERM, _begin_drain, "SIGTERM"
        )
    except (NotImplementedError, RuntimeError, ValueError):
        pass  # platform without unix signals: the shutdown op still drains
    stream = (
        sys.stdin
        if args.input == "-"
        else open(args.input)  # startup: nothing else is scheduled on the loop yet
    )
    queue = _start_reader(stream, loop)
    pending: set[asyncio.Task] = set()
    # ONE long-lived drain sentinel raced against each line read — per-line
    # task churn would put two allocations and a cancellation on the hot
    # path of every request line for a pure signal
    drainer = asyncio.ensure_future(drain_event.wait())
    try:
        while not drain_event.is_set():
            getter = asyncio.ensure_future(queue.get())
            done, _ = await asyncio.wait(
                {getter, drainer}, return_when=asyncio.FIRST_COMPLETED
            )
            if getter not in done:
                getter.cancel()
                break  # drain began while blocked on input
            item = getter.result()
            if item is None:
                break  # EOF
            line_no, line = item
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
                assert isinstance(msg, dict)
            # not a retry loop: lines are independent client requests, and
            # one malformed line must never kill the replica
            except Exception as exc:  # noqa: BLE001
                from .. import telemetry

                telemetry.record_serve_error(exc, what=f"malformed line {line_no}")
                _emit(
                    {
                        "id": f"line-{line_no}", "ok": False, "error": "protocol",
                        "code": "protocol",
                        "message": f"malformed JSON on line {line_no}",
                    }
                )
                continue
            op = msg.get("op")
            if op == "stats":
                _emit({"op": "stats", **_counters()})
            elif op == "profile":
                # on-demand capture: starts immediately, stops on a
                # timer thread — the serve loop never blocks behind the
                # window, and a busy/unavailable capture is an answer, not
                # a crash (same contract as /debug/profile)
                from .. import profiling

                try:
                    # start_capture rotates old capture dirs (rmtree) and
                    # touches the filesystem before arming the profiler:
                    # off the loop, like every other disk path in serve
                    capture_dir = await asyncio.to_thread(
                        profiling.start_capture,
                        seconds=float(msg.get("seconds", 5.0)),
                    )
                except profiling.CaptureBusyError as exc:
                    _emit({"op": "profile", "ok": False, "error": "busy",
                           "code": "busy", "message": str(exc)})
                except profiling.CaptureUnavailableError as exc:
                    _emit({"op": "profile", "ok": False, "error": "unavailable",
                           "code": "unavailable", "message": str(exc)})
                except (ValueError, TypeError) as exc:
                    _emit({"op": "profile", "ok": False, "error": "protocol",
                           "code": "protocol", "message": str(exc)})
                else:
                    _emit({"op": "profile", "ok": True, "dir": capture_dir})
            elif op == "warmup":
                warmed = await asyncio.to_thread(aot.warmup, device=device)
                exposition.set_ready(True)
                _emit({"warmed": warmed, "compiles": _build.BUILDS["count"]})
            elif op == "put_dataset":
                # factorize + stage happen here, ONCE: off the loop (a
                # multi-GB put must not stall every in-flight request's
                # admission), then every later {"dataset": name} request
                # skips parse, factorize, and the host-to-device copy
                from . import registry

                try:
                    info = await asyncio.to_thread(
                        registry.put,
                        msg.get("name"),
                        array=msg.get("array"),
                        by=msg.get("by"),
                        expected_groups=msg.get("expected_groups"),
                        sort=bool(msg.get("sort", True)),
                        device=device,
                    )
                # not a retry loop: the put is one client request, and a bad
                # payload (or a put racing device loss) must be answered,
                # never kill the replica
                except Exception as exc:  # noqa: BLE001
                    from .. import telemetry

                    telemetry.record_serve_error(exc, what="put_dataset")
                    _emit({"op": "put_dataset", "ok": False,
                           "name": msg.get("name"), "error": type(exc).__name__,
                           "code": "protocol", "message": str(exc)})
                else:
                    _emit({"op": "put_dataset", "ok": True, **info})
            elif op == "del_dataset":
                from . import registry

                # same answer-never-crash contract as put_dataset: a
                # malformed name (unhashable, say) must come back as a
                # typed protocol answer, not unwind the loop
                try:
                    deleted = registry.delete(msg.get("name"))
                except Exception as exc:  # noqa: BLE001
                    from .. import telemetry

                    telemetry.record_serve_error(exc, what="del_dataset")
                    _emit({"op": "del_dataset", "ok": False,
                           "name": msg.get("name"), "error": type(exc).__name__,
                           "code": "protocol", "message": str(exc)})
                else:
                    _emit({"op": "del_dataset", "ok": True,
                           "name": msg.get("name"), "deleted": bool(deleted)})
            elif op == "list_datasets":
                from . import registry

                try:
                    listing = registry.list_datasets()
                    stats = registry.registry_stats()
                except Exception as exc:  # noqa: BLE001
                    from .. import telemetry

                    telemetry.record_serve_error(exc, what="list_datasets")
                    _emit({"op": "list_datasets", "ok": False,
                           "error": type(exc).__name__,
                           "code": "execution", "message": str(exc)})
                else:
                    _emit({"op": "list_datasets", "ok": True,
                           "datasets": listing, "stats": stats})
            elif op in ("append", "query", "compact", "list_stores"):
                # durable incremental aggregation stores (store.py):
                # every store op touches the WAL/segments on disk, so each
                # runs off the loop like put_dataset. Failures answer with
                # the typed codes (unknown_store / store_corruption); an
                # exactly-once replay is an OK answer with
                # ack == "slab_already_ingested", never an error.
                from . import stores

                try:
                    if op == "append":
                        out = await asyncio.to_thread(
                            stores.append,
                            msg.get("store"),
                            msg.get("codes"),
                            msg.get("array"),
                            slab_id=msg.get("slab_id"),
                            create=msg.get("create"),
                            device=device,
                        )
                    elif op == "query":
                        res = await asyncio.to_thread(
                            stores.query, msg.get("store"), msg.get("funcs"), device=device
                        )
                        out = {
                            "store": msg.get("store"),
                            "result": {k: np.asarray(v).tolist() for k, v in res.items()},
                        }
                    elif op == "compact":
                        out = await asyncio.to_thread(stores.compact, msg.get("store"))
                    else:
                        out = {"stores": await asyncio.to_thread(stores.list_stores)}
                except ServeError as exc:
                    _emit({"op": op, "store": msg.get("store"),
                           **_error_response(msg.get("id", f"line-{line_no}"), exc)})
                # not a retry loop: one store op is one client request, and a
                # bad payload must be answered, never kill the replica
                except Exception as exc:  # noqa: BLE001
                    from .. import telemetry

                    telemetry.record_serve_error(exc, what=f"store op {op}")
                    _emit({"op": op, "ok": False, "store": msg.get("store"),
                           "error": type(exc).__name__, "code": "protocol",
                           "message": str(exc)})
                else:
                    _emit({"op": op, "ok": True, **out})
            elif op == "drain":
                if pending:
                    await asyncio.gather(*pending, return_exceptions=True)
                await dispatcher.close()
                _emit({"op": "drain", "ok": True})
            elif op == "shutdown":
                _begin_drain("shutdown-op")
                break
            elif op is not None:
                _emit(
                    {
                        "id": msg.get("id", f"line-{line_no}"), "ok": False,
                        "error": "protocol", "code": "protocol",
                        "message": f"unknown op {op!r}",
                    }
                )
            else:
                task = asyncio.create_task(_serve_request(dispatcher, line_no, msg))
                pending.add(task)
                task.add_done_callback(pending.discard)
    finally:
        drainer.cancel()
        if canary_task is not None:
            # cancelled before the drain, so no probe races closed admission
            canary_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await canary_task
        if drain_state:
            await _drain_and_exit(dispatcher, pending, drain_state["source"])
        else:
            # EOF: the scripted-run path — finish everything, unbounded,
            # exactly as before the drain machinery existed
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
            await dispatcher.close()
        if stream is not sys.stdin:
            stream.close()
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m flox_tpu_torch.serve",
        description="JSON-lines groupby serving loop (one request per line)",
    )
    parser.add_argument("--input", default="-", help="request file, or - for stdin")
    parser.add_argument(
        "--device", default="cuda",
        help="device every request reduces on (default cuda; cpu runs on the CPU)",
    )
    parser.add_argument(
        "--aot-dir", default=None,
        help="warmup manifest directory (overrides FLOX_TPU_SERVE_AOT_DIR)",
    )
    parser.add_argument(
        "--warmup", action="store_true",
        help="replay the warmup manifest before reading requests",
    )
    parser.add_argument("--queue-depth", type=int, default=None)
    parser.add_argument("--deadline", type=float, default=None)
    parser.add_argument("--microbatch-max", type=int, default=None)
    parser.add_argument("--batch-window", type=float, default=None)
    parser.add_argument(
        "--canary-interval", type=float, default=None,
        help="seconds between SLO canary-prober cycles (known-answer requests "
        "billed to the reserved __canary__ tenant, feeding the correctness SLO; "
        "overrides FLOX_TPU_SLO_CANARY_INTERVAL; 0 keeps the prober off)",
    )
    parser.add_argument(
        "--metrics-port", type=int, default=None,
        help="serve /metrics + /healthz + /readyz on this port "
        "(overrides FLOX_TPU_METRICS_PORT; 0 keeps the endpoint off)",
    )
    parser.add_argument(
        "--replica-id", default=None,
        help="this replica's stable fleet identity (overrides "
        "FLOX_TPU_REPLICA_ID): labels every /metrics series and "
        "/debug/costs payload, prefixes generated request ids, and stamps "
        "telemetry exports",
    )
    parser.add_argument(
        "--metrics-host", default="127.0.0.1",
        help="bind address for the metrics endpoint — the loopback default "
        "suits sidecar scrapers; pass 0.0.0.0 for a remote Prometheus",
    )
    args = parser.parse_args(argv)
    from .. import profiling, telemetry

    # SIGUSR2 leaves a flight-recorder dump (no-op unless telemetry +
    # FLOX_TPU_FLIGHT_RECORDER_PATH are configured); SIGUSR1 starts an
    # on-demand capture into OPTIONS["profile_dir"]. Both must be
    # installed on the main thread, before the loop starts. SIGTERM is
    # deliberately NOT taken here (sigterm=False): the serve loop registers
    # its own handler for the graceful drain — finish in-flight requests,
    # flight-dump, exit 0 — instead of the dump-and-die-143 default.
    telemetry.install_signal_dumps(sigterm=False)
    profiling.install_capture_signal()
    try:
        return asyncio.run(_amain(args))
    except Exception as exc:
        # an unhandled serve-loop exception is exactly what the flight
        # recorder exists for: dump the last N records, then die loudly.
        # Exception, not BaseException: Ctrl-C / SystemExit are clean
        # shutdowns and must not overwrite a genuine earlier fatal dump
        # with a post-shutdown snapshot labeled as a crash
        telemetry.flight_dump(reason=f"serve-loop:{type(exc).__name__}")
        raise


if __name__ == "__main__":
    sys.exit(main())
