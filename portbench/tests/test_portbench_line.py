"""The result line's keys and the verdict (CPU)."""

import json
from types import SimpleNamespace

import torch

from portbench import run
from portbench.spec import Spec

SPEC = Spec()
LIMITS = {"max_rel_err": 1e-5, "nonfinite_mismatch": 0, "groups_mismatch": 0,
          "shape_mismatch": 0, "missing_result": 0}


def _out(trace=None, numbers=None, failed=0):
    r = SimpleNamespace(calls=300, call_s=[0.025] * 300, window_s=7.6, bytes_global=54.7e9,
                        bytes_card=54.7e9, peak_bytes=54_800_000_000, setup_s=14.2, trace=trace,
                        world=1, peaks=SPEC.peaks("NVIDIA H100 80GB HBM3"))
    n = {"max_rel_err": 1e-7, "nonfinite_mismatch": 0, "groups_mismatch": 0,
         "shape_mismatch": 0, "missing_result": 0, "compared": 6238080}
    n.update(numbers or {})
    return {"run": r, "numbers": n, "failed": failed, "errors": [], "attempted": 300,
            "builds": {"count": 0, "seconds": 0.0}, "warm_s": 0.025, "kept_index": 17,
            "reference_s": 2.0, "busy_s": 0.9, "setup_parts": {}, "limits": LIMITS, "device": torch.device("cpu")}


def _args(trace):
    return {"workload": "era5-month-nanmean", "seed": 3000000001, "seconds": 7.5, "trace": trace}


def test_untraced_line_keys():
    line = run.result_line(SPEC, _args(0), _out())
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert set(line["metrics"]) == {"reduce_gbps", "call_p95_ms", "peak_gb", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["device"]) >= {"platform", "count", "memory_peak_bytes"}
    assert line["checks"]["max_rel_err"] == {"value": 1e-7, "limit": 1e-5}
    json.dumps(line)


def test_oisst_reports_no_tail():
    args = dict(_args(0), workload="oisst-doy-nanmean")
    assert "call_p95_ms" not in run.result_line(SPEC, args, _out())["metrics"]


def test_traced_line_has_per_layer_metrics_and_breakdown():
    trace = {"calls": 40, "wall_s": 1.1, "busy_s": 1.0, "ops": 900,
             "kind_s": {"csrc": 0.96, "nccl": 0.0, "other": 0.04},
             "span_s": {"groupby_reduce": 0.04, "factorize": 0.004}, "entry": "groupby_reduce",
             "device_ops": [["segment_reduce_kernel", 0.96]], "idle_gaps": [["harness", 0.1]]}
    line = run.result_line(SPEC, _args(1), _out(trace=trace))
    assert set(line["metrics"]) == {"kernel_roofline", "other_device_ms",
                                    "factorize_ms", "host_call_ms", "device_idle_pct"}
    assert line["device"]["busy_s"] == 0.9 and line["device"]["window_s"] == 1.1
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(line)[-1] == "checks"


def test_verdict():
    assert not run.result_line(SPEC, _args(0), _out(numbers={"max_rel_err": 2e-5}))["correct"]
    assert not run.result_line(SPEC, _args(0), _out(numbers={"nonfinite_mismatch": 1}))["correct"]
    assert not run.result_line(SPEC, _args(0), _out(numbers={"compared": 0}))["correct"]
    assert not run.result_line(SPEC, _args(0), _out(failed=1))["correct"]


def test_no_card_no_run(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "era5-month-nanmean", "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""
