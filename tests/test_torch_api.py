"""The port's top-level names against the reference's (ROADMAP C5)."""

import flox_tpu
import flox_tpu_torch

#: names of ``flox_tpu.__all__`` the port has not ported yet, each with the
#: ROADMAP item that brings it
ALLOWED_GAPS = {
    "autotune": "A9 (autotune)",
    "cache": "A9 (cache)",
    "serve": "A9 (serving)",
    "telemetry": "A9 (observability base)",
}


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
    for module in ("cohorts", "faults", "profiling", "resilience", "kernels"):
        assert getattr(flox_tpu_torch, module).__name__ == f"flox_tpu_torch.{module}"


def test_gaps_are_still_gaps():
    # a gap that the port fills leaves this list
    for name in ALLOWED_GAPS:
        assert not hasattr(flox_tpu_torch, name), name
