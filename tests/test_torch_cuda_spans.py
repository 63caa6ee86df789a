"""The kernel wrappers' spans on a CUDA device: ``bins`` and ``launch`` around
each hand-written kernel, with the bytes the cost cards declare, and the
profiler's ranges that tie each device op to the span that launched it.

These tests carry the ``cuda`` marker and skip without a card. The file
imports no JAX, so that it runs on a card machine without it:

    python -m pytest tests/test_torch_cuda_spans.py -m cuda --noconftest -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import flox_tpu_torch
from flox_tpu_torch import cuda_kernels as ck, telemetry


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    with flox_tpu_torch.set_options(telemetry=False):
        telemetry.reset()
        yield torch.device("cuda")
        telemetry.reset()


def _spans(name):
    return [r for r in telemetry.spans() if r["type"] == "span" and r["name"] == name]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel, call, out_bytes", [
    ("segment_sum", lambda d, c: ck.segment_sum_raw(d, c, 12), 4 * 12 * 64 * 4),
    ("segment_sum_radixbin", lambda d, c: ck.segment_sum_radixbin_raw(d, c, 12),
     4 * 12 * 64 * 4),
    ("segment_minmax", lambda d, c: ck.segment_minmax(d, c, 12, "max"), 12 * 64 * 4),
    ("segment_multistat", lambda d, c: ck.segment_multistat(d, c, 12), 12 * 64 * (16 + 8)),
    ("segment_cumsum", lambda d, c: ck.segment_cumsum(d, c, 12, True), 64 * 1000 * 4),
])
def test_launch_span_names_the_kernel_and_its_bytes(cuda_device, kernel, call, out_bytes):
    """The ``launch`` span names the kernel and its bytes; B1, B2 and B3 add
    their walk's ``window``: 1000 columns over 12 groups take B1's window
    walk (8), B2 and B3 their run walk (1)."""
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.normal(size=(64, 1000)).astype(np.float32)).to(cuda_device)
    codes = torch.from_numpy(rng.integers(0, 12, 1000)).to(cuda_device)
    with flox_tpu_torch.set_options(telemetry=True):
        call(data, codes)
    (launch,) = _spans("launch")
    window = {"segment_sum": 8, "segment_minmax": 1, "segment_multistat": 1}
    assert launch["attrs"] == {"kernel": kernel,
                               "nbytes": 64 * 1000 * 4 + 1000 * 4 + out_bytes,
                               **({"window": window[kernel]} if kernel in window else {})}
    if kernel != "segment_cumsum":  # B4 reads the codes as they are
        (bins,) = _spans("bins")
        assert bins["attrs"] == {"n": 1000, "size": 12}
        assert bins["ts_us"] + bins["dur_us"] <= launch["ts_us"]


@pytest.mark.cuda
def test_kernel_device_time_falls_under_its_launch_range(cuda_device):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from portbench import spanattr, tracemath

    rng = np.random.default_rng(1)
    data = rng.normal(size=(4096, 8760)).astype(np.float32)
    labels = (np.arange(8760) // 730) % 12
    x = torch.from_numpy(data).to(cuda_device)
    with flox_tpu_torch.set_options(telemetry=True):
        flox_tpu_torch.groupby_reduce(x, labels, func="nanmean")  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            flox_tpu_torch.groupby_reduce(x, labels, func="nanmean")
            torch.cuda.synchronize()
    events = list(prof.events())
    names = {e.name for e in events if getattr(e, "is_user_annotation", False)}
    assert {"groupby_reduce", "factorize", "dispatch", "bins", "launch", "legs"} <= names
    by = spanattr.span_device_s(*spanattr.from_events(events))
    kernels = tracemath.csrc_kernels()
    csrc = sum((e.time_range.end - e.time_range.start) / 1e6 for e in events
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
               and tracemath.kind(e.name, kernels) == "csrc")
    assert by["launch"] == pytest.approx(csrc, rel=1e-9)
    assert by.get(spanattr.NONE, 0.0) <= 0.01 * sum(by.values())
    assert by.get("legs", 0.0) > 0
