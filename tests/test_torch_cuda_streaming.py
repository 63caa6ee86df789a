"""The port's streaming staging on a CUDA device: the pinned ring, the side
copy stream and its events, a mesh rank's shard staging, a streamed call
against its CPU run, and the cost ledger's device time from CUDA events.

These tests carry the ``cuda`` marker and skip without a card. The file
imports no JAX, so that it runs on a card machine without it:

    python -m pytest tests/test_torch_cuda_streaming.py -m cuda --noconftest -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from flox_tpu_torch.pipeline import SlabStager, stream_slabs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned-buffer staging runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 1, 3])
def test_cuda_staging_bytes_and_ring(cuda_device, depth):
    rng = np.random.default_rng(1)
    data = rng.normal(size=(64, 1000)).astype(np.float32)
    codes = rng.integers(0, 12, 1000).astype(np.int32)
    st = SlabStager(lambda s, e: data[:, s:e], codes, n=1000, batch_len=96, lead_shape=(64,),
                    device=cuda_device)
    got = []
    for sl in stream_slabs(st, prefetch=depth):
        assert sl.data.device.type == "cuda" and sl.data.is_contiguous()
        got.append((sl.data + 0).cpu())  # a kernel on the compute stream reads it
    assert torch.equal(torch.cat(got, dim=1), torch.from_numpy(data))
    assert st._ring is not None and st._ring._count <= max(1, depth) + 1
    assert all(buf[0].is_pinned() for buf in st._ring._free)


@pytest.mark.cuda
def test_cuda_streaming_matches_cpu(cuda_device):
    from flox_tpu_torch import streaming as pst

    rng = np.random.default_rng(2)
    data = rng.normal(size=(300, 2048)).astype(np.float32)
    labels = (np.arange(2048) // 171) % 12
    got, _ = pst.streaming_groupby_reduce(data, labels, func="nanmean", batch_len=500)
    want, _ = pst.streaming_groupby_reduce(data, labels, func="nanmean", batch_len=500,
                                           device="cpu")
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cuda_shard_staging_copies_only_the_rank_columns(cuda_device):
    rng = np.random.default_rng(3)
    data = rng.normal(size=(16, 1000)).astype(np.float32)
    codes = rng.integers(0, 12, 1000).astype(np.int32)
    calls = []

    def loader(s, e):
        calls.append((s, e))
        return data[:, s:e]

    st = SlabStager(loader, codes, n=1000, batch_len=400, lead_shape=(16,), device=cuda_device,
                    shard=(4, 1))
    got = [(sl.offset, sl.data.cpu()) for sl in stream_slabs(st, prefetch=2)]
    # slabs [0, 400), [400, 800), [800, 1000): rank 1 of 4 holds columns
    # [100, 200), [500, 600) and [850, 900)
    assert sorted(calls) == [(100, 200), (500, 600), (850, 900)]
    for offset, chunk in got:
        assert torch.equal(chunk, torch.from_numpy(data[:, offset:offset + chunk.shape[1]]))


@pytest.mark.cuda
def test_cuda_ledger_device_time_from_events(cuda_device):
    import flox_tpu_torch
    from flox_tpu_torch import telemetry

    x = torch.randn(512, 4096, device=cuda_device)
    labels = np.arange(4096) % 12
    off, _ = flox_tpu_torch.groupby_reduce(x, labels, func="nanmean")
    telemetry.reset()
    try:
        with flox_tpu_torch.set_options(telemetry=True, costmodel=True):
            on, _ = flox_tpu_torch.groupby_reduce(x, labels, func="nanmean")
            assert telemetry._PENDING_DEVICE  # not read on the dispatch path
            row = telemetry.cost_by_program()["bundle[nanmean]"]
            assert not telemetry._PENDING_DEVICE
    finally:
        telemetry.reset()
    assert torch.equal(on, off)
    assert row["dispatches"] == 1 and row["device_ms"] > 0
