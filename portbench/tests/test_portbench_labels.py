"""Calendar labels of the traffic mixes (CPU)."""

import numpy as np

from portbench import labels
from portbench.spec import Spec

SPEC = Spec()


def _by(config, traffic):
    return labels.groupers(SPEC.traffic(traffic), SPEC.config(config))[0]


def test_era5_months_in_sorted_runs():
    month = _by("era5-hourly-0p25", "month-nanmean")
    assert month.size == 26304
    assert np.array_equal(np.unique(month), np.arange(1, 13))
    runs = labels.run_lengths(month)
    assert len(runs) == 36  # 12 months x 3 years
    assert set(runs.tolist()) == {672, 696, 720, 744}  # Feb, Feb 2016, 30 and 31 days
    assert runs[1] == 696 and runs[13] == 672  # February 2016 is a leap month


def test_era5_days_in_runs_of_24():
    day = _by("era5-hourly-0p25", "day-nanmean")
    assert len(np.unique(day)) == 1096
    assert set(labels.run_lengths(day).tolist()) == {24}
    assert day[0] == np.datetime64("2016-01-01", "D").astype(np.int64)


def test_era5_hourly_dayofyear():
    doy = _by("era5-hourly-0p25", "doy-nanmean")
    assert np.array_equal(np.unique(doy), np.arange(1, 367))
    assert set(labels.run_lengths(doy).tolist()) == {24}
    counts = np.bincount(doy)[1:]
    assert counts[365] == 24  # day 366 only in 2016
    assert set(counts[:365].tolist()) == {72}


def test_oisst_dayofyear_and_leap_days():
    doy = _by("oisst-v2.1-daily-0p25", "doy-nanmean")
    t = labels.timestamps(SPEC.config("oisst-v2.1-daily-0p25")["time"])
    assert doy.size == 14532 and t[0] == np.datetime64("1981-09-01")
    assert t[-1] == np.datetime64("2021-06-14")
    assert len(np.unique(doy)) == 366
    assert set(labels.run_lengths(doy).tolist()) == {1}  # a new group every column
    counts = np.bincount(doy)
    assert counts[366] == 10  # the leap years 1984 to 2020
    feb29 = t[(t.astype("datetime64[M]").astype(int) % 12 == 1)
              & ((t - t.astype("datetime64[M]").astype(t.dtype)).astype(int) == 28)]
    assert len(feb29) == 10 and set(doy[np.isin(t, feb29)].tolist()) == {60}


def test_hour_field():
    t = labels.timestamps({"start": "2016-01-01T00", "step": "1h", "count": 48})
    assert np.array_equal(labels.FIELDS["hour"](t), np.tile(np.arange(24), 2))
