"""float64 climatologies and two groupers through the port, on the CPU,
against the benchmark's plain float64 reference (``portbench/reference``).

The data is what xarray's CF decoding hands an analyst for ERA5 (float64),
at a small size: 64 rows over two years of hourly steps (2016-2017, 17544
hours) on the benchmark's own calendar (``portbench.labels``), seeded, with
whole NaN rows, scattered NaNs and a few +-inf. The parts:

* the month nanmean through ``groupby_reduce`` on the default route
  (``index_add_`` on the CPU) and on the one-hot GEMM
  (``segment_sum_impl="matmul"``, the route a float64 month nanmean takes
  on a CUDA card);
* the month x hour nanmean (288 composite labels from two groupers) in
  float32 and float64;
* the GEMM's ``matmul`` span and ``kernels.matmul_blocks`` counter, on and
  off.

Bars. float64: ``|got - want| <= 1e-12 * max(|want|, 15)`` (15: the field's
spread, the harness's ``Judge`` scale). A float64 sum of n terms in another
order differs by at most (n - 1) * 2**-53 of the sum of their magnitudes:
at most 744 hours a month, under 1e-13 of a mean near 288, so 1e-12 leaves
ten times that; a float32 computation (inputs or sums) misses by 1e-8 or
more, and the float32-summed control is checked to fail it. float32: the
benchmark cell's own limit, 1e-5. Non-finite outputs must match exactly
(NaN for NaN, each infinity with its sign). Nothing here imports the JAX
package.
"""

import math

import numpy as np
import pytest
import torch

import flox_tpu_torch
from flox_tpu_torch import telemetry
from flox_tpu_torch.options import OPTIONS
from portbench import labels
from portbench.reference import grouped

CALENDAR = {"start": "2016-01-01T00", "step": "1h", "count": 17544}
ROWS = 64
SCALE = 15.0
F64_TOL = 1e-12
F32_TOL = 1e-5


def _by(*fields):
    t = labels.timestamps(CALENDAR)
    return [labels.FIELDS[f](t) for f in fields]


def _field(dtype=torch.float64, seed=20160101):
    gen = torch.Generator().manual_seed(seed)
    x = torch.empty((ROWS, CALENDAR["count"]), dtype=torch.float64).normal_(288.0, SCALE,
                                                                           generator=gen)
    x[[3, 40]] = float("nan")  # whole NaN rows
    x[5, ::97] = float("nan")  # scattered NaNs
    x[7, 100] = float("inf")  # one month of row 7 is +inf
    x[9, 200], x[9, 201] = float("inf"), float("-inf")  # inf - inf: one month of row 9 is NaN
    x[11, 9000] = float("-inf")
    return x.to(dtype)


def _reference(x, by, dtype=torch.float64):
    codes, uniques, shape = grouped.codes_of(by)
    want = grouped.FUNCS["nanmean"](x, torch.as_tensor(codes), math.prod(shape), dtype)
    return want.reshape((x.shape[0],) + shape), uniques


def _gap(got, want):
    """The widest finite gap over ``max(|want|, SCALE)``; asserts the
    non-finite outputs match."""
    got, want = got.to(torch.float64), want.to(torch.float64)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got[torch.isinf(want)], want[torch.isinf(want)])
    return float(((got - want).abs() / want.abs().clamp_min(SCALE))[fin].max())


@pytest.fixture(autouse=True)
def _clean_telemetry():
    with flox_tpu_torch.set_options(telemetry=False, telemetry_export_path=None,
                                    costmodel=False):
        telemetry.reset()
        yield
        telemetry.reset()


@pytest.mark.parametrize("impl", ["auto", "matmul"])
def test_float64_month_nanmean(impl):
    x = _field()
    (month,) = _by("month")
    want, uniques = _reference(x, [month])
    with flox_tpu_torch.set_options(segment_sum_impl=impl):
        got, groups = flox_tpu_torch.groupby_reduce(x, month, func="nanmean", device="cpu")
    assert got.dtype == torch.float64 and tuple(got.shape) == (ROWS, 12)
    np.testing.assert_array_equal(groups, uniques[0])
    assert _gap(got, want) <= F64_TOL
    # the edge cases are there: all-NaN rows, a +inf month, an inf - inf month
    assert torch.isnan(got[3]).all() and torch.isinf(got[7]).sum() == 1
    assert torch.isnan(got[9]).sum() == 1 and torch.isfinite(got[5]).all()


def test_float64_tolerance_fails_a_float32_computation():
    x = _field()
    (month,) = _by("month")
    want, _ = _reference(x, [month])
    codes, _, _ = grouped.codes_of([month])
    control = grouped.FUNCS["nanmean"](x.float(), torch.as_tensor(codes), 12, torch.float32)
    assert _gap(control, want) > 10 * F64_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_month_hour_nanmean(dtype):
    x = _field(dtype)
    by = _by("month", "hour")
    want, uniques = _reference(x, by)
    got, months, hours = flox_tpu_torch.groupby_reduce(x, *by, func="nanmean", device="cpu")
    assert got.dtype == dtype and tuple(got.shape) == (ROWS, 12, 24)
    np.testing.assert_array_equal(months, uniques[0])
    np.testing.assert_array_equal(hours, uniques[1])
    assert _gap(got, want) <= (F64_TOL if dtype == torch.float64 else F32_TOL)


def _gemm_call():
    """One GEMM-route nanmean with a block of 8 rows (the least
    ``matmul_block_bytes``, 1 MiB, over 4 masks of 17544 float64 columns);
    the blocks it must run."""
    x = _field()
    (month,) = _by("month")
    with flox_tpu_torch.set_options(segment_sum_impl="matmul", matmul_block_bytes=2**20):
        n = x.shape[-1]
        rows = max(8, OPTIONS["matmul_block_bytes"] // (4 * n * x.element_size()) // 8 * 8)
        flox_tpu_torch.groupby_reduce(x, month, func="nanmean", device="cpu")
    return x, -(-ROWS // rows)


def test_gemm_span_and_counter():
    with flox_tpu_torch.set_options(telemetry=True):
        before = telemetry.METRICS.get("kernels.matmul_blocks")
        x, blocks = _gemm_call()
        grown = telemetry.METRICS.get("kernels.matmul_blocks") - before
    assert blocks == 8
    spans = [r for r in telemetry.drain() if r["type"] == "span" and r["name"] == "matmul"]
    assert len(spans) == 1
    assert spans[0]["attrs"] == {"k": ROWS, "n": CALENDAR["count"], "size": 12,
                                 "dtype": "float64", "blocks": blocks,
                                 "nbytes": x.numel() * 8}
    assert grown == blocks


def test_gemm_records_nothing_with_telemetry_off():
    assert telemetry.span("matmul") is telemetry._NOOP
    _gemm_call()
    assert telemetry.spans() == []
    assert telemetry.METRICS.snapshot() == {}

