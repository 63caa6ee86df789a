"""The float64 ERA5 configuration, the month x hour traffic, their two cells
and ``matmul_ms``: found by name, read from stub traces, and run end to end
at a few rows on the CPU."""

from types import SimpleNamespace

import pytest
import torch

import flox_tpu_torch
from portbench import cellrun, run, tracemath
from portbench.spec import Spec

SPEC = Spec()
F64, MONTHHOUR = "era5-f64-month-nanmean", "era5-monthhour-nanmean"


def test_spec_finds_the_new_parts():
    cfg = SPEC.config("era5-hourly-0p25-f64")
    assert cfg["field"]["dtype"] == "float64" and cfg["nlat"] * cfg["nlon"] == 259200
    assert cfg["published"]["nlat"] == 721
    f64, mh = SPEC.cell(F64), SPEC.cell(MONTHHOUR)
    assert (f64["config"], f64["traffic"], f64["chips"]) == ("era5-hourly-0p25-f64",
                                                             "month-nanmean", 1)
    assert (mh["config"], mh["traffic"], mh["chips"]) == ("era5-hourly-0p25",
                                                          "monthhour-nanmean", 1)
    assert SPEC.traffic("monthhour-nanmean")["by"] == ["month", "hour"]
    assert "matmul_ms" in {m["name"] for m in SPEC.metrics(F64, True)}
    assert "matmul_ms" not in {m["name"] for m in SPEC.metrics(MONTHHOUR, True)}
    assert "matmul_ms" not in {m["name"] for m in SPEC.metrics("era5-month-nanmean", True)}


def test_matmul_ms_reads_the_span_a_call():
    read = SPEC.reader("matmul_ms")
    span_s = {"groupby_reduce": 0.64, "matmul": 0.62}
    assert read(SimpleNamespace(trace={"calls": 2, "span_s": span_s})) == pytest.approx(310.0)
    assert read(SimpleNamespace(trace={"calls": 2, "span_s": {"groupby_reduce": 0.1}})) is None
    assert read(SimpleNamespace(trace=None)) is None


def test_f64_cell_counts_eight_bytes_an_element():
    cell = cellrun.Cell(SPEC, F64, 2**31 + 5, "cpu", nrows=4)
    cell.make_data()
    assert cell.local.dtype == torch.float64
    assert cell.bytes_global() == 4 * 26304 * 8


def test_month_hour_cell_has_288_composite_groups():
    cell = cellrun.Cell(SPEC, MONTHHOUR, 2**31 + 6, "cpu", nrows=4)
    cell.make_data()
    assert cell.group_shape == (12, 24) and cell.ngroups == 288
    assert cell.bytes_card() == tracemath.call_bytes(4, 26304, 4, 288, 1)


@pytest.mark.parametrize("workload, impl", [(F64, "auto"), (F64, "matmul"), (MONTHHOUR, "auto")])
def test_new_cells_run_on_the_cpu(workload, impl):
    args = {"workload": workload, "seed": 2**31 + 1117, "seconds": 0.2, "trace": 1}
    with flox_tpu_torch.set_options(segment_sum_impl=impl):
        line = run.result_line(SPEC, args, run.run_cell(SPEC, args, device="cpu", nrows=8))
    assert line["correct"], line["checks"]
    assert ("matmul_ms" in line["metrics"]) == (impl == "matmul")
