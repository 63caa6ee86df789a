"""The plain reference against hand-computed results (CPU)."""

import math

import numpy as np
import pytest
import torch

from portbench.reference import grouped

NAN = float("nan")


def _x():
    return torch.tensor([[1.0, 2.0, 4.0, 8.0, 16.0],
                         [NAN, 3.0, NAN, 5.0, 7.0],
                         [NAN, NAN, NAN, NAN, NAN]], dtype=torch.float32)


CODES = torch.tensor([0, 0, 1, 1, 2])


@pytest.mark.parametrize("func, want", [
    ("nansum", [[3, 12, 16], [3, 5, 7], [0, 0, 0]]),
    ("sum", [[3, 12, 16], [NAN, NAN, 7], [NAN, NAN, NAN]]),
    ("count", [[2, 2, 1], [1, 1, 1], [0, 0, 0]]),
    ("nanmean", [[1.5, 6, 16], [3, 5, 7], [NAN, NAN, NAN]]),
    ("mean", [[1.5, 6, 16], [NAN, NAN, 7], [NAN, NAN, NAN]]),
    ("nanmax", [[2, 8, 16], [3, 5, 7], [NAN, NAN, NAN]]),
    ("nanmin", [[1, 4, 16], [3, 5, 7], [NAN, NAN, NAN]]),
    ("max", [[2, 8, 16], [NAN, NAN, 7], [NAN, NAN, NAN]]),
    ("nanvar", [[0.25, 4, 0], [0, 0, 0], [NAN, NAN, NAN]]),
    ("nanstd", [[0.5, 2, 0], [0, 0, 0], [NAN, NAN, NAN]]),
])
def test_reference_by_hand(func, want):
    got = grouped.reduce_block(_x(), CODES, 3, func)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.array(want, dtype=np.float64))


def test_codes_of_sorted_uniques_and_two_groupers():
    codes, groups, shape = grouped.codes_of([np.array([5, 3, 5, 9])])
    assert codes.tolist() == [1, 0, 1, 2] and groups[0].tolist() == [3, 5, 9] and shape == (3,)
    codes, groups, shape = grouped.codes_of([np.array([1, 1, 2, 2]), np.array([0, 1, 0, 1])])
    assert codes.tolist() == [0, 1, 2, 3] and shape == (2, 2)


def test_judge_counts_nonfinite_and_scales_gaps():
    want = torch.tensor([[1.0, NAN, 300.0, 0.0]], dtype=torch.float64)
    got = torch.tensor([[1.0, NAN, 300.03, 0.015]], dtype=torch.float32)
    j = grouped.Judge(scale=15.0)
    j.add(got, want)
    assert j.nonfinite_mismatch == 0 and j.compared == 4
    assert math.isclose(j.max_rel_err, 1e-3, rel_tol=1e-3)  # 0.015 / 15 beats 0.03 / 300
    j.add(torch.tensor([[NAN, 1.0]]), torch.tensor([[2.0, float("inf")]], dtype=torch.float64))
    assert j.nonfinite_mismatch == 2


def test_control_is_the_reference_in_bfloat16():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((8, 744), generator=g) * 15 + 288
    codes = torch.arange(744) // 62
    want = grouped.reduce_block(x, codes, 12, "nanmean")
    ctl = grouped.reduce_block(x, codes, 12, "nanmean", "bfloat16")
    assert ctl.dtype == torch.float32
    gap = ((ctl - want).abs() / want.abs()).max().item()
    assert 1e-5 < gap < 1e-2
    with pytest.raises(ValueError):
        grouped.reduce_block(x, codes, 12, "nanmean", "float16")
