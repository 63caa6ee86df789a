"""The port's autotuner on a CUDA device: the segment-sum sweep times the
hand-written kernels against each other with each repetition synchronized,
a kernel candidate that fails to launch raises out of the call, the tuned
month mean is bit for bit the untuned call on the kernel it chose, no
decision moves a call off the kernels, and the engine family stays on the
card.

These tests carry the ``cuda`` marker and skip without a card. The file
imports no JAX, so that it runs on a card machine without it:

    python -m pytest tests/test_torch_cuda_autotune.py -m cuda --noconftest -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import flox_tpu_torch
from flox_tpu_torch import autotune, cache, core, cuda_kernels


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep's kernel candidates run only on the card")
    with flox_tpu_torch.set_options(autotune=False, autotune_cache_path=None):
        cache.clear_all()
        yield torch.device("cuda")
        cache.clear_all()


@pytest.mark.cuda
def test_segment_sum_sweep_times_the_kernels_synchronized(cuda_device, monkeypatch):
    syncs = []
    real = torch.cuda.synchronize

    def counting(*args, **kwargs):
        syncs.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "synchronize", counting)
    with flox_tpu_torch.set_options(autotune=True):
        autotune.prime_reduce("nanmean", torch.float32, 12, 1 << 24, cuda_device)
    key = autotune.make_key("segment_sum", dtype="float32", ngroups=12, nelems=1 << 24,
                            platform="cuda")
    cands = autotune._AUTOTUNE_CACHE[key]["candidates"]
    assert set(cands) == {"kernel", "radixbin"}  # index_add_ is no candidate here
    assert all(c["gbps"] > 0 for c in cands.values())
    # one warm call and two timed reps per candidate, each synchronized
    assert len(syncs) >= 3 * len(cands)


@pytest.mark.cuda
def test_failing_kernel_candidate_raises(cuda_device, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("segment-sum kernel failed to launch")

    monkeypatch.setattr(cuda_kernels, "segment_sum", broken)
    x = torch.randn(8, 4096, device=cuda_device)
    labels = np.arange(4096) % 12
    with flox_tpu_torch.set_options(autotune=True):
        with pytest.raises(RuntimeError, match="failed to launch"):
            flox_tpu_torch.groupby_reduce(x, labels, func="nanmean")


@pytest.mark.cuda
def test_tuned_month_mean_matches_untuned(cuda_device):
    x = torch.randn(64, 8760, device=cuda_device)
    labels = (np.arange(8760) // 730) % 12
    off, _ = flox_tpu_torch.groupby_reduce(x, labels, func="nanmean")
    with flox_tpu_torch.set_options(autotune=True):
        on, _ = flox_tpu_torch.groupby_reduce(x, labels, func="nanmean")
    record = autotune.decision_record()
    assert record["sweeps"] >= 1
    (winner,) = [w["winner"] for k, w in record["winners"].items()
                 if k.startswith("segment_sum|cuda|float32")]
    assert winner in ("kernel", "radixbin")
    kernel = {"kernel": "segment_sum", "radixbin": "segment_sum_radixbin"}[winner]
    with flox_tpu_torch.set_options(segment_sum_impl=winner):
        pinned, _ = flox_tpu_torch.groupby_reduce(x, labels, func="nanmean")
    cuda_kernels.reset_launches()
    with flox_tpu_torch.set_options(autotune=True):
        again, _ = flox_tpu_torch.groupby_reduce(x, labels, func="nanmean")
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES[kernel] == 1
    assert torch.equal(on, pinned) and torch.equal(again, pinned)
    torch.testing.assert_close(on, off, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_highcard_dense_winner_cannot_leave_the_kernels(cuda_device):
    x = torch.randn(4, 8192, device=cuda_device)
    labels = np.arange(8192) // 4  # 2048 days of a 36524-day universe
    kw = dict(func="nanmean", expected_groups=np.arange(36524))
    with flox_tpu_torch.set_options(sort_engine_min_groups=1 << 15):
        off, _ = flox_tpu_torch.groupby_reduce(x, labels, **kw)
        for cand, gbps in (("dense", 99.0), ("sort", 1.0)):
            autotune.record("highcard", cand, gbps, dtype="float32", ngroups=36524,
                            nelems=x.numel(), platform="cuda")
        cuda_kernels.reset_launches()
        with flox_tpu_torch.set_options(autotune=True):
            on, _ = flox_tpu_torch.groupby_reduce(x, labels, **kw)
        torch.cuda.synchronize()
    # dense accumulators over 36524 groups would be index_add_: the call
    # stays on the sort engine's radix-binning kernel
    assert cuda_kernels.LAUNCHES["segment_sum_radixbin"] >= 1
    # absent days are NaN in both
    torch.testing.assert_close(on, off, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
def test_engine_family_stays_on_the_card(cuda_device):
    host = np.random.default_rng(0).normal(size=512)
    autotune.record("engine", "numpy", 99.0, dtype="float64", nelems=512, platform="cuda")
    with flox_tpu_torch.set_options(autotune=True):
        assert core._tuned_engine("torch", host, None) == "torch"
        out, _ = flox_tpu_torch.groupby_reduce(host, np.arange(512) % 4, func="sum")
    assert out.device.type == "cuda"
