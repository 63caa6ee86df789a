"""The port's cohort detection, resharding and layout plots
(flox_tpu_torch.cohorts, .rechunk, .visualize) against flox_tpu's, on the CPU.

The labels and chunk layouts are those of tests/test_cohorts.py and of the
reference snapshot scenarios (tests/cohort_scenarios.py). Every comparison
is exact: methods, cohort mappings (keys, label lists and their order),
ownership permutations, resharded layouts and the plotted arrays.
"""

import numpy as np
import pytest
import torch

from flox_tpu import cohorts as rc
from flox_tpu import rechunk as rr
from flox_tpu_torch import cohorts as pc
from flox_tpu_torch import rechunk as pr

from cohort_scenarios import SCENARIOS


def _same_detection(labels, chunks, **kw):
    ref = rc.find_group_cohorts(labels, chunks, **kw)
    got = pc.find_group_cohorts(labels, chunks, **kw)
    assert got[0] == ref[0]
    assert list(got[1].items()) == list(ref[1].items())
    return got


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_snapshot_scenarios(name):
    labels, chunks, size = SCENARIOS[name]()
    _same_detection(labels, chunks, expected_groups=range(size))


def _cases():
    """(labels, chunks, kwargs) of tests/test_cohorts.py's scenarios."""
    nh = 24 * 365 * 2
    day = (np.arange(nh) // 24) % 365
    rng = np.random.default_rng(0)
    month = np.arange(12 * 20) % 12
    nhours = 24 * 365
    mh = (((np.arange(nhours) // 24) % 365 // 30.44).astype(np.int64) % 12) * 24 + (
        np.arange(nhours) % 24)
    periodic = np.tile(np.arange(12), 4)
    by = np.arange(240) // 24
    google = np.arange(365 * 2) % 365
    big = np.random.default_rng(1).integers(0, 5000, size=200_000)
    return {
        "single-chunk": (np.array([0, 0, 1, 1, 2]), (5,), {}),
        "one-chunk-per-label": (np.repeat([0, 1, 2, 3], 4), (4, 4, 4, 4), {}),
        "all-labels-everywhere": (np.tile([0, 1, 2, 3], 8), (8, 8, 8, 8), {}),
        "periodic": (periodic, pc.chunks_from_shards(48, 16), {}),
        "era5-dayofyear": (day, pc.chunks_from_shards(nh, nh // 48),
                           {"expected_groups": range(365)}),
        "merge-true": (np.tile(np.arange(12), 24), pc.chunks_from_shards(288, 96),
                       {"merge": True}),
        "merge-false": (np.tile(np.arange(12), 24), pc.chunks_from_shards(288, 96),
                        {"merge": False}),
        "oisst": (np.arange(365 * 40) % 365, pc.chunks_from_shards(365 * 40, 365 * 4),
                  {"expected_groups": range(365)}),
        "perfect-monthly": (month, pc.chunks_from_shards(240, 60),
                            {"expected_groups": range(12)}),
        "perfect-blockwise": (by, pc.chunks_from_shards(240, 10),
                              {"expected_groups": range(10)}),
        "era5-google": (google, pc.chunks_from_shards(730, 730),
                        {"expected_groups": range(365)}),
        "nwm-2d": (rng.integers(0, 900, size=(450, 360)).reshape(-1),
                   pc.chunks_from_shards(450 * 360, 25), {"expected_groups": range(900)}),
        "random-big-array": (big, pc.chunks_from_shards(big.size, 20),
                             {"expected_groups": range(5000)}),
        "era5-monthhour": (mh, pc.chunks_from_shards(nhours, nhours // 48),
                           {"expected_groups": range(288)}),
        "shards-of-a-mesh": (np.arange(111) % 5, pc.chunks_from_shards(111, 4),
                             {"expected_groups": range(5)}),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_detection_cases(name):
    labels, chunks, kw = _cases()[name]
    _same_detection(labels, chunks, **kw)


@pytest.mark.parametrize("n,shards", [(10, 4), (8, 4), (111, 8), (1, 3), (0, 2)])
def test_chunks_from_shards(n, shards):
    assert pc.chunks_from_shards(n, shards) == rc.chunks_from_shards(n, shards)


def test_cohorts_memoized():
    pc._COHORTS_CACHE.clear()
    labels = np.tile(np.arange(12), 100)
    chunks = pc.chunks_from_shards(len(labels), 8)
    assert pc.find_group_cohorts(labels, chunks) is pc.find_group_cohorts(labels, chunks)


@pytest.mark.parametrize("mapping,size,shards", [
    ({}, 12, 4),
    ({(0,): [0, 1, 2], (1,): [3, 4, 5], (2,): [6, 7, 8], (3,): [9, 10, 11]}, 12, 4),
    ({(0,): [0, 4], (1,): [1, 3], (2,): [2]}, 5, 3),
    ({(0, 1): [0, 1, 2, 3, 4, 5], (2,): [6], (3,): [7, 8]}, 12, 4),
], ids=["empty", "identity", "padded", "wide-cohort"])
def test_ownership_permutation(mapping, size, shards):
    ref = rc.ownership_permutation(mapping, size, shards)
    got = pc.ownership_permutation(mapping, size, shards)
    assert (got is None) == (ref is None)
    if ref is not None:
        np.testing.assert_array_equal(got, ref)


def test_ownership_permutation_of_detected_cohorts():
    labels = np.concatenate([np.tile([s, s + 4, s + 8], 8) for s in range(4)])
    _, mapping = _same_detection(labels, pc.chunks_from_shards(labels.size, 4),
                                 expected_groups=range(12))
    np.testing.assert_array_equal(pc.ownership_permutation(mapping, 12, 4),
                                  rc.ownership_permutation(mapping, 12, 4))


# ---------------------------------------------------------------------------
# rechunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 3, 4, 8])
@pytest.mark.parametrize("labels", ["random", "sorted", "missing"])
def test_reshard_for_blockwise(labels, shards):
    rng = np.random.default_rng(shards)
    codes = rng.integers(0, 7, 200).astype(np.int64)
    if labels == "sorted":
        codes = np.sort(codes)
    elif labels == "missing":
        codes[rng.random(200) < 0.2] = -1
    ref = rr.reshard_for_blockwise(codes, shards)
    got = pr.reshard_for_blockwise(codes, shards)
    np.testing.assert_array_equal(got.permutation, ref.permutation)
    np.testing.assert_array_equal(got.codes, ref.codes)
    assert (got.n_shards, got.shard_len) == (ref.n_shards, ref.shard_len)
    data = rng.normal(size=(2, 200))
    np.testing.assert_array_equal(got.apply(data, device="cpu").numpy(),
                                  np.asarray(ref.apply(data)))
    ints = rng.integers(0, 9, 200)
    np.testing.assert_array_equal(got.apply(torch.from_numpy(ints)).numpy(),
                                  np.asarray(ref.apply(ints)))


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_rechunk_for_blockwise(axis):
    rng = np.random.default_rng(7)
    data = rng.normal(size=(30, 30))
    labels = rng.integers(0, 5, 30)
    ref = rr.rechunk_for_blockwise(data, axis, labels, n_shards=4)
    got = pr.rechunk_for_blockwise(data, axis, labels, n_shards=4, device="cpu")
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])


@pytest.mark.parametrize("chunksize,debug", [(None, False), (48, False), (48, True), (5, True)])
def test_rechunk_for_cohorts(chunksize, debug):
    labels = np.tile(np.repeat(np.arange(12), 30), 3)
    kw = dict(force_new_chunk_at=[0], chunksize=chunksize, debug=debug)
    assert (pr.rechunk_for_cohorts(None, 0, labels, **kw)
            == rr.rechunk_for_cohorts(None, 0, labels, **kw))


def test_rechunk_for_cohorts_misaligned_raises():
    with pytest.raises(ValueError, match="do not align"):
        pr.rechunk_for_cohorts(np.ones(5), 0, np.arange(6), force_new_chunk_at=[0])


# ---------------------------------------------------------------------------
# visualize
# ---------------------------------------------------------------------------


def _plots(module):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = np.tile(np.repeat(np.arange(6), 4), 3)
    chunks = pc.chunks_from_shards(labels.size, 4)
    _, mapping = pc.find_group_cohorts(labels, chunks)
    axes = [
        module.visualize_groups_1d(labels, chunks=chunks),
        module.visualize_cohorts_2d(mapping, nlabels=6, nchunks=len(chunks)),
        module.visualize_groups_2d(labels.reshape(6, 12)),
    ]
    out = [(np.asarray(ax.images[0].get_array()),
            [tuple(line.get_xdata()) for line in ax.lines]) for ax in axes]
    plt.close("all")
    return out


def test_visualize_same_plots():
    pytest.importorskip("matplotlib")
    from flox_tpu import visualize as rv
    from flox_tpu_torch import visualize as pv

    for (img_g, lines_g), (img_r, lines_r) in zip(_plots(pv), _plots(rv)):
        np.testing.assert_array_equal(img_g, img_r)
        assert lines_g == lines_r
