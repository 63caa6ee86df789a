"""The port's top-level names against the reference's (ROADMAP C5)."""

import flox_tpu
import flox_tpu_torch

#: names of ``flox_tpu.__all__`` the port has not ported yet, each with the
#: ROADMAP item that brings it (none are left)
ALLOWED_GAPS: dict[str, str] = {}


def test_every_reference_name_is_exported():
    missing = set(flox_tpu.__all__) - set(flox_tpu_torch.__all__)
    assert missing == set(ALLOWED_GAPS), sorted(missing ^ set(ALLOWED_GAPS))


def test_exported_names_resolve():
    for name in flox_tpu_torch.__all__:
        assert getattr(flox_tpu_torch, name) is not None, name
    for name in ("rechunk_for_blockwise", "rechunk_for_cohorts", "reshard_for_blockwise",
                 "streaming_groupby_reduce", "streaming_groupby_aggregate_many",
                 "streaming_groupby_scan"):
        assert callable(getattr(flox_tpu_torch, name)), name
    for module in ("autotune", "cache", "cohorts", "faults", "fleet", "profiling", "resilience",
                   "kernels", "serve", "slo", "telemetry"):
        assert getattr(flox_tpu_torch, module).__name__ == f"flox_tpu_torch.{module}"
    from flox_tpu_torch import cache, exposition, serve, store

    for name in ("LRUCache", "clear_all", "stats"):
        assert callable(getattr(cache, name)), name
    for name in ("Dispatcher", "AggregationRequest", "ServeResult", "payload_digest"):
        assert getattr(serve, name) is getattr(serve.dispatcher, name), name
    for module in ("aot", "breaker", "registry", "stores"):
        assert getattr(serve, module).__name__ == f"flox_tpu_torch.serve.{module}"
    for name in ("IncrementalAggregationStore", "open_store"):
        assert getattr(store, name) is not None, name
    for name in ("prometheus_text", "start_metrics_server", "stop_metrics_server", "set_ready",
                 "ready", "ready_reason", "MetricsServer"):
        assert getattr(exposition, name) is not None, name


def test_gaps_are_still_gaps():
    # a gap that the port fills leaves this list
    for name in ALLOWED_GAPS:
        assert not hasattr(flox_tpu_torch, name), name
