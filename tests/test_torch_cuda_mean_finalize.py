"""The mean finalize kernel (``csrc/mean_finalize.cu``) against its plain
version, and the skipna mean's route to it, on a CUDA device.

These tests carry the ``cuda`` marker and skip without a card. The file
imports no JAX, so that it runs on a card machine without it:

    python -m pytest tests/test_torch_cuda_mean_finalize.py -m cuda --noconftest -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import flox_tpu_torch
from flox_tpu_torch import cuda_kernels as ck
from flox_tpu_torch import kernels, telemetry


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same bits, every NaN counted equal to every NaN (payloads aside)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    iview = torch.int32 if a.dtype == torch.float32 else torch.int16
    return torch.equal(na, nb) and torch.equal(a[~na].view(iview), b[~nb].view(iview))


def _legs(size, k, seed, device):
    """Raw legs with +inf, -inf, both, all-NaN groups and empty groups."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    rowcount = torch.randint(0, 40, (size,), generator=g, device=device, dtype=torch.int32)
    rowcount[::7] = 0
    rows = rowcount[:, None].float()
    nan_c = torch.floor(torch.rand((size, k), generator=g, device=device) * (rows + 1))
    nan_c[1::5] = rows[1::5]
    r = torch.rand((size, k), generator=g, device=device)
    pos_c = (r < 0.05).float()
    neg_c = ((r > 0.03) & (r < 0.08)).float() * 2
    sums = torch.randn((size, k), generator=g, device=device) * 100
    return [t.contiguous() for t in (sums, nan_c, pos_c, neg_c)], rowcount


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fill", [float("nan"), -999.0])
@pytest.mark.parametrize("size, k", [(45, 1037), (1, 33), (12, 4096), (600, 100)])
def test_kernel_is_its_plain_version(cuda_device, dtype, fill, size, k):
    """Bit for bit, NaN payloads aside, at ragged shapes (tiles cut on both
    sides); one launch counted."""
    legs, rowcount = _legs(size, k, size * k, cuda_device)
    before = ck.LAUNCHES["mean_finalize"]
    got = ck.mean_finalize(*legs, rowcount, fill, dtype)
    want = ck.mean_finalize_plain(*legs, rowcount, fill, dtype)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["mean_finalize"] == before + 1
    assert got.is_contiguous() and tuple(got.shape) == (k, size) and got.dtype == dtype
    assert _bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("impl, size, kernel", [("kernel", 12, "segment_sum"),
                                                ("radixbin", 1096, "segment_sum_radixbin")])
def test_nanmean_takes_the_pass(cuda_device, dtype, impl, size, kernel):
    """``groupby_reduce`` nanmean on the card: one segment-sum launch and one
    mean finalize launch, no read-back in between, and the bits of the
    torch passes that finish the mean off the route."""
    rng = np.random.default_rng(size)
    data = torch.from_numpy(rng.normal(size=(300, 2000)).astype(np.float32)).to(cuda_device)
    data[data > 2.0] = float("nan")
    data[0, :] = float("nan")
    data = data.to(dtype)
    labels = rng.integers(0, size, 2000)
    labels[labels == 3] = 4
    with flox_tpu_torch.set_options(segment_sum_impl=impl, telemetry=True):
        telemetry.reset()
        ck.reset_launches()
        got, _ = flox_tpu_torch.groupby_reduce(data, labels, func="nanmean",
                                               expected_groups=np.arange(size))
        torch.cuda.synchronize()
        counted = telemetry.METRICS.get("kernels.mean_finalize_launches")
        telemetry.reset()
    launches = {k: v for k, v in ck.LAUNCHES.items() if v}
    assert launches == {kernel: 1, "mean_finalize": 1}
    assert counted == 1
    with pytest.MonkeyPatch.context() as mp, flox_tpu_torch.set_options(segment_sum_impl=impl):
        mp.setattr(kernels, "_mean_pass", lambda *a: False)
        want, _ = flox_tpu_torch.groupby_reduce(data, labels, func="nanmean",
                                                expected_groups=np.arange(size))
    assert got.stride() == want.stride() and _bits_equal(got, want)
