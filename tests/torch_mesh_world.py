"""A spawned ``torch.distributed`` world of CPU ranks that runs the port's mesh
cases (flox_tpu_torch.parallel) for tests/test_torch_sharded.py, and its
streamed mesh cases (``STREAM_CASE_IDS``: the ``streaming_groupby_*`` entry
points with ``mesh=``) for tests/test_torch_mesh_streaming.py.

This module imports numpy, torch and flox_tpu_torch only: every spawned rank
re-imports it, so it stays cheap and never imports JAX. The cases are
described here once (:func:`case`): their inputs are made from a seed per
case with numpy, and the test process feeds the same inputs to flox_tpu's
mesh programs.

:func:`run_world` spawns the ranks (gloo, the ``spawn`` start method, one
thread each), runs every case on every rank in the same order, and collects
each rank's results. The parent waits with a deadline and terminates the
ranks when it passes, so a hung collective fails the caller instead of
stalling the test run.
"""

from __future__ import annotations

import logging
import os
import pickle
import time
import warnings
import zlib
from datetime import timedelta

import numpy as np

NRANKS = 4

MESH_FUNCS = [
    "sum", "nansum", "prod", "nanprod", "mean", "nanmean", "var", "nanvar",
    "std", "nanstd", "max", "nanmax", "min", "nanmin", "count", "all", "any",
    "argmax", "nanargmax", "argmin", "nanargmin",
    "first", "last", "nanfirst", "nanlast",
]
ORDER_STATS = [
    ("nanmedian", {}),
    ("median", {}),
    ("nanquantile", {"q": 0.9}),
    ("quantile", {"q": [0.25, 0.5, 0.75]}),
    ("nanquantile", {"q": 0.3, "method": "nearest"}),
    ("nanquantile", {"q": 0.7, "method": "midpoint"}),
    ("quantile", {"q": 0.5, "method": "median_unbiased"}),
]
SCAN_FUNCS = ["cumsum", "nancumsum", "ffill", "bfill"]
#: the blocked program's funcs and their dense legs (counts + chunk legs)
BLOCKED_LEGS = {"nansum": 2, "nanmean": 3, "nanvar": 4, "count": 2}
COMPLEX_FUNCS = ["sum", "nansum", "mean", "nanmean", "count", "first", "last"]


def _rng(cid: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(cid.encode()))


def _data(rng, shape, add_nan: bool):
    values = np.round(rng.normal(size=shape), 1)
    if add_nan:
        values[..., rng.random(shape[-1]) < 0.25] = np.nan
    return values


def _case_ids() -> list[str]:
    ids = [f"funcs-{f}-{m}-{'nan' if nan else 'finite'}" for f in MESH_FUNCS
           for m in ("map-reduce", "cohorts") for nan in (False, True)]
    ids += [f"2d-{f}" for f in ("sum", "nanmean", "var", "max", "first", "nanargmax")]
    ids += ["expected-groups", "partial-axis", "auto-method"]
    ids += ["blockwise-sum", "blockwise-nanmedian", "blockwise-quantile", "blockwise-reshard"]
    ids += [f"orderstat-{i}" for i in range(len(ORDER_STATS))]
    ids += ["orderstat-cohorts", "orderstat-int", "orderstat-mode-raises"]
    ids += ["min-count-nansum"] + [f"min-count-{f}" for f in ("nanmean", "nanvar", "nanargmax")]
    ids += [f"scan-{f}-{'nan' if nan else 'finite'}" for f in SCAN_FUNCS for nan in (False, True)]
    ids += ["scan-2d", "scan-blockwise", "scan-td-cumsum", "scan-td-nancumsum",
            "scan-nat-boundary-cumsum", "scan-nat-boundary-nancumsum"]
    ids += [f"datetime-{f}" for f in ("max", "nanmax", "min", "nanmin",
                                      "first", "last", "nanfirst", "nanlast")]
    ids += [f"rms-{m}" for m in ("map-reduce", "cohorts", "blockwise")]
    ids += [f"aligned-{f}" for f in ("nanmean", "nanvar", "nansum")]
    ids += [f"blocked-{f}" for f in BLOCKED_LEGS]
    ids += ["blocked-min-count", "blocked-100k-nanmean", "blocked-million",
            "blocked-raises-peak", "blocked-raises-non-additive"]
    ids += [f"mesh2-{f}" for f in ("nanmean", "nanvar", "max", "nanargmax", "first")]
    ids += ["mesh2-cohorts", "mesh2-scan", "mesh2-bogus-axis", "mesh2-auto-ici",
            "mesh2-auto-both"]
    ids += ["dtensor", "many-map-reduce", "many-cohorts", "sort-engine", "xarray-rechunk-blockwise",
            "xarray-rechunk-cohorts"]
    ids += [f"complex-{f}" for f in COMPLEX_FUNCS]
    return ids


CASE_IDS = _case_ids()

#: the reference's streaming aggregations (tests/test_streaming.py STREAM_FUNCS)
STREAM_FUNCS = [
    "sum", "nansum", "prod", "nanprod", "mean", "nanmean", "var", "nanvar",
    "std", "nanstd", "max", "nanmax", "min", "nanmin", "count", "all", "any",
    "argmax", "argmin", "nanargmax", "nanargmin",
    "first", "last", "nanfirst", "nanlast",
]
STREAM_DT_FUNCS = ["min", "nanmax", "first", "nanlast", "mean", "count"]
STREAM_KILL_KINDS = ["reduce", "scan", "quantile"]
#: funcs streamed with a tail slab of 2 columns, so ranks 2 and 3 hold empty
#: shards of it and must fold in the identity
STREAM_TAIL_FUNCS = ["nanmean", "max", "argmax", "nanlast", "nanvar", "nanmedian", "nancumsum"]


def _stream_case_ids() -> list[str]:
    ids = [f"stream-{f}" for f in STREAM_FUNCS]
    ids += ["stream-batch-rounds", "stream-loader", "stream-rms", "stream-min-count"]
    ids += [f"stream-datetime-{f}" for f in STREAM_DT_FUNCS]
    ids += ["stream-blocked-sum", "stream-blocked-nanvar", "stream-blocked-100k",
            "stream-blocked-dense-sum", "stream-blocked-dense-nanvar",
            "stream-nonadditive-sort", "stream-nonadditive-raises"]
    ids += ["stream-median-nan", "stream-quantile-2axis", "stream-nanmedian",
            "stream-nanquantile"]
    ids += ["stream-many-trio", "stream-many-five"]
    ids += [f"stream-scan-{f}" for f in SCAN_FUNCS]
    ids += ["stream-scan-td-nat", "stream-scan-int-writer", "stream-scan-dt-ffill"]
    ids += ["stream-split-argmax"] + [f"stream-kill-{k}" for k in STREAM_KILL_KINDS]
    ids += [f"stream-tail-{f}" for f in STREAM_TAIL_FUNCS]
    return ids


STREAM_CASE_IDS = _stream_case_ids()


def _mdata():
    """TestMeshStreaming's data (tests/test_streaming.py)."""
    rng = np.random.default_rng(11)
    n = 6000
    vals = rng.normal(size=(4, n))
    vals[:, ::13] = np.nan
    return vals, rng.integers(0, 9, n)


def _qdata():
    """TestStreamingOrderStats's data."""
    rng = np.random.default_rng(23)
    n = 5000
    vals = rng.normal(size=(3, n))
    vals[:, ::11] = np.nan
    return vals, rng.integers(0, 9, n)


def _msdata():
    """TestMeshStreamingScan's data."""
    rng = np.random.default_rng(41)
    n = 4096
    vals = rng.normal(size=(2, n))
    vals[:, ::9] = np.nan
    return vals, rng.integers(0, 6, n)


def _rdata():
    """The resilience tests' data (tests/test_resilience.py's fixture)."""
    rng = np.random.default_rng(0)
    n = 4000
    vals = rng.normal(size=(3, n))
    vals[:, ::17] = np.nan
    return vals, rng.integers(0, 8, n)


def stream_case(cid: str) -> dict:
    """One streamed mesh case, in :func:`case`'s form; ``special`` names what
    each side builds in its own way: "loader" (a loader instead of the host
    array), "writer" (an ``out=`` writer), "rms" (the custom aggregation),
    "dense" (the pinned dense engine: "torch" here, "jax" there), "oom" (a
    dispatch-side OOM at ``kw``'s first slab past 800), "kill" (a
    kill-and-resume run of ``kind``)."""
    out = {"entry": "streaming_groupby_reduce", "mesh": "1d", "ceiling": None,
           "special": None}
    name = cid[len("stream-"):]
    parts = name.split("-")
    if name in STREAM_FUNCS:
        vals, labels = _mdata()
        v = vals if name not in ("any", "all") else ~np.isnan(vals)
        out.update(args=(v, labels), kw=dict(func=name, batch_len=997))
    elif name == "batch-rounds":
        out.update(args=_mdata(), kw=dict(func="nansum", batch_len=1001))
    elif name == "loader":
        out.update(args=_mdata(), kw=dict(func="nanmean", batch_len=512), special="loader")
    elif name == "rms":
        out.update(args=_mdata(), kw=dict(batch_len=800), special="rms")
    elif name == "min-count":
        out.update(args=_mdata(), kw=dict(func="nansum", min_count=800, batch_len=900))
    elif parts[0] == "datetime":
        rng = np.random.default_rng(5)
        n = 4000
        labels = rng.integers(0, 6, n)
        dt = (np.datetime64("2021-06-01")
              + rng.integers(0, 10**6, n).astype("timedelta64[s]")).astype("datetime64[ns]")
        dt[rng.random(n) < 0.04] = np.datetime64("NaT")
        out.update(args=(dt, labels), kw=dict(func=parts[1], batch_len=640))
    elif parts[0] == "blocked":
        rng = np.random.default_rng(17)
        if parts[1] == "dense":
            # the dense engine pinned, so the sort engine cannot take the
            # call: above the ceiling the owner-by-owner form runs
            n, size = 6000, 40_000
            out.update(args=(rng.normal(size=(4, n)), rng.integers(0, size, n)),
                       ceiling=(2 if parts[2] == "sum" else 3) * 2**20, special="dense",
                       kw=dict(func=parts[2], expected_groups=np.arange(size), batch_len=800))
        elif parts[1] == "100k":
            # __graft_entry__.dryrun_multichip's streamed 100,000-group sum
            n = 2048
            codes = rng.integers(0, 100_000, n)
            out.update(args=(np.round(rng.normal(size=n), 2), codes), ceiling=1_100_000,
                       kw=dict(func="sum", expected_groups=np.arange(100_000),
                               fill_value=0.0, batch_len=n // 2))
        else:
            n, size = 6000, 40_000
            labels = rng.integers(0, size, n)
            vals = rng.normal(size=(4, n))
            kw = dict(func=parts[1], expected_groups=np.arange(size), batch_len=800)
            if parts[1] == "sum":
                kw["fill_value"] = 0
            out.update(args=(vals, labels), ceiling=4 * 2**20, kw=kw)
    elif parts[0] == "nonadditive":
        rng = np.random.default_rng(17)
        n, size = 2000, 40_000
        labels = rng.integers(0, size, n)
        vals = rng.normal(size=(4, n))
        out.update(args=(vals, labels), ceiling=2 * 2**20,
                   kw=dict(func="max", expected_groups=np.arange(size), batch_len=800),
                   special="dense" if parts[1] == "raises" else None)
    elif name == "median-nan":
        # one NaN, in slab 1's third shard: only the max over the ranks of
        # the non-skipna NaN flags carries it to the other ranks
        rng = np.random.default_rng(99)
        n, batch_len = 4096, 1024
        labels = rng.integers(0, 9, n)
        vals = rng.normal(size=(2, n))
        vals[:, batch_len + 2 * (batch_len // NRANKS) + 3] = np.nan
        out.update(args=(vals, labels), kw=dict(func="median", batch_len=batch_len))
    elif name == "quantile-2axis":
        out.update(args=_qdata(), mesh="2d",
                   kw=dict(func="nanmedian", batch_len=700, axis_name=("dcn", "ici")))
    elif name == "nanmedian":
        out.update(args=_qdata(), kw=dict(func="nanmedian", batch_len=700))
    elif name == "nanquantile":
        out.update(args=_qdata(), kw=dict(func="nanquantile", batch_len=700,
                                          finalize_kwargs={"q": [0.1, 0.9]}))
    elif parts[0] == "many":
        funcs = (("nanmean", "nanmin", "nanmax") if parts[1] == "trio"
                 else ("count", "nanmean", "nanstd", "nanmin", "nanmax"))
        out.update(entry="streaming_groupby_aggregate_many", args=_mdata(),
                   kw=dict(funcs=funcs, batch_len=997))
    elif parts[0] == "scan":
        out["entry"] = "streaming_groupby_scan"
        vals, labels = _msdata()
        n = labels.shape[0]
        if parts[1] in SCAN_FUNCS:
            out.update(args=(vals, labels), kw=dict(func=parts[1], batch_len=1000))
        elif parts[1] == "td":
            td = np.random.default_rng(6).integers(1, 100, n).astype("timedelta64[ns]")
            td[7] = np.timedelta64("NaT")
            out.update(args=(td, labels), kw=dict(func="cumsum", batch_len=1000))
        elif parts[1] == "int":
            out.update(args=((np.arange(n) % 97).astype(np.int32), labels),
                       kw=dict(func="cumsum", batch_len=1000), special="writer")
        else:
            rng = np.random.default_rng(8)
            dt = np.datetime64("2020-01-01", "ns") + rng.integers(0, 10**9, n).astype(
                "timedelta64[ns]")
            dt[::13] = np.datetime64("NaT")
            out.update(args=(dt, labels), kw=dict(func="ffill", batch_len=1000))
    elif parts[0] == "tail":
        rng = np.random.default_rng(31)
        n = 4002  # slabs of 1000 columns, then a tail of 2: one column for ranks 0 and 1
        vals = rng.normal(size=(3, n))
        vals[:, ::7] = np.nan
        labels = rng.integers(0, 5, n)
        out.update(args=(vals, labels), kw=dict(func=parts[1], batch_len=1000))
        if parts[1] == "nancumsum":
            out["entry"] = "streaming_groupby_scan"
    elif name == "split-argmax":
        vals, labels = _rdata()
        out.update(args=(np.nan_to_num(vals, nan=0.5)[:, :2400], labels[:2400]),
                   kw=dict(func="argmax", batch_len=800), special="oom")
    elif name == "raise":
        # rank 1's loader fails on its shard of the last slab: the other
        # ranks are then waiting in the final combine
        out.update(args=_rdata(), kw=dict(func="nanmean", batch_len=800), special="raise")
    elif parts[0] == "kill":
        vals, labels = _rdata()
        vals, labels = vals[:, :2400], labels[:2400]
        if parts[1] == "quantile":
            vals = vals.astype(np.float32)  # 33 passes, not 65
        kw = dict(func={"reduce": "nanmean", "quantile": "nanmedian"}.get(parts[1], "nancumsum"),
                  batch_len=800)
        out.update(args=(vals, labels), kw=kw, special="kill", kind=parts[1],
                   entry="streaming_groupby_scan" if parts[1] == "scan"
                   else "streaming_groupby_reduce")
    else:
        raise KeyError(cid)
    return out


def case(cid: str) -> dict:
    """One case: ``entry`` (the entry point's name), ``args`` (numpy inputs),
    ``kw`` (keyword arguments both packages take), ``mesh`` ("1d", "2d", or
    None for the default mesh) and, where it applies, ``ceiling`` (a
    ``dense_intermediate_bytes_max`` to set around the call) and ``special``
    (a case each side builds in its own way: a custom Aggregation, a
    resharded layout, a DTensor, a direct scan program)."""
    if cid.startswith("stream-"):
        return stream_case(cid)
    rng = _rng(cid)
    out = {"entry": "groupby_reduce", "mesh": "1d", "ceiling": None, "special": None}
    parts = cid.split("-")
    if parts[0] == "funcs":
        func, method, nan = parts[1], "-".join(parts[2:-1]), parts[-1] == "nan"
        n, size = 111, 5  # not a multiple of the shard count
        codes = rng.integers(0, size, n).astype(np.int64)
        fkw = {"ddof": 1} if "var" in func or "std" in func else None
        out.update(args=(_data(rng, (n,), nan), codes),
                   kw=dict(func=func, method=method, finalize_kwargs=fkw))
    elif parts[0] == "2d":
        n = 64
        codes = rng.integers(0, 4, n).astype(np.int64)
        out.update(args=(_data(rng, (3, n), True), codes),
                   kw=dict(func=parts[1], method="map-reduce"))
    elif cid == "expected-groups":
        out.update(args=(np.arange(50.0), np.array([1, 1, 3, 3, 5] * 10)),
                   kw=dict(func="nanmean", method="map-reduce",
                           expected_groups=np.array([1, 2, 3, 4, 5])))
    elif cid == "partial-axis":
        labels = np.array([[0, 1, 0, 1] * 8, [1, 1, 0, 0] * 8])
        out.update(args=(np.round(rng.normal(size=(2, 32)), 1), labels),
                   kw=dict(func="sum", axis=-1, method="map-reduce"))
    elif cid == "auto-method":
        out.update(args=(np.arange(240.0), np.tile([0, 1, 2], 80)), kw=dict(func="nanmean"))
    elif parts[0] == "blockwise":
        per = 16
        codes = np.repeat(np.arange(NRANKS), per).astype(np.int64)  # group d on shard d
        values = np.round(rng.normal(size=NRANKS * per), 1)
        kind = parts[1]
        if kind == "reshard":
            codes = rng.integers(0, 7, 200).astype(np.int64)
            values = np.round(rng.normal(size=200), 1)
            out.update(special="reshard")
        func = {"sum": "sum", "nanmedian": "nanmedian", "quantile": "quantile",
                "reshard": "nanmedian"}[kind]
        fkw = {"q": [0.25, 0.5, 0.75]} if kind == "quantile" else None
        out.update(args=(values, codes),
                   kw=dict(func=func, method="blockwise", finalize_kwargs=fkw))
    elif parts[0] == "orderstat":
        n = 4096
        if parts[1] in ("cohorts", "int", "mode"):
            labels = rng.integers(0, 7 if parts[1] == "int" else 5, 1024 if parts[1] == "int"
                                  else 512)
            values = (rng.integers(-50, 50, size=1024) if parts[1] == "int"
                      else rng.normal(size=512))
            func = {"cohorts": "nanmedian", "int": "median"}.get(parts[1], "mode")
            method = "cohorts" if parts[1] == "cohorts" else "map-reduce"
            if parts[1] == "mode":
                values, labels = np.arange(8.0), np.array([0, 1] * 4)
            out.update(args=(values, labels), kw=dict(func=func, method=method))
        else:
            func, fkw = ORDER_STATS[int(parts[1])]
            labels = rng.integers(0, 11, n)
            values = rng.normal(size=(3, n))
            values[:, ::7] = np.nan  # groups span every shard; NaNs everywhere
            out.update(args=(values, labels),
                       kw=dict(func=func, method="map-reduce", finalize_kwargs=fkw or None))
    elif parts[0] == "min":
        if parts[2] == "nansum":
            out.update(args=(np.array([1.0, np.nan, np.nan] * 8), np.array([0, 0, 1] * 8)),
                       kw=dict(func="nansum", min_count=20, method="map-reduce"))
        else:
            fkw = {"ddof": 1} if parts[2] == "nanvar" else None
            out.update(args=(np.tile([1.0, 3.0, np.nan], 8), np.tile([0, 0, 1], 8)),
                       kw=dict(func=parts[2], min_count=2, method="map-reduce",
                               finalize_kwargs=fkw))
    elif parts[0] == "scan":
        out["entry"] = "groupby_scan"
        if parts[1] in SCAN_FUNCS:
            n = 117
            codes = rng.integers(0, 5, n).astype(np.int64)
            out.update(args=(_data(rng, (n,), parts[2] == "nan"), codes),
                       kw=dict(func=parts[1], method="blelloch"))
        elif parts[1] == "2d":
            codes = rng.integers(0, 4, 64).astype(np.int64)
            out.update(args=(_data(rng, (3, 64), True), codes),
                       kw=dict(func="nancumsum", method="blelloch"))
        elif parts[1] == "blockwise":
            codes = np.repeat(np.arange(NRANKS), 8).astype(np.int64)
            out.update(args=(np.round(rng.normal(size=4 * 8), 1), codes),
                       kw=dict(func="cumsum", method="blockwise"))
        elif parts[1] == "td":
            n = 117
            codes = rng.integers(0, 5, n).astype(np.int64)
            td = rng.integers(1, 1000, n).astype("timedelta64[ns]")
            td[rng.random(n) < 0.2] = np.timedelta64("NaT")
            out.update(args=(td, codes), kw=dict(func=parts[2], method="blelloch"))
        else:  # a NaT on the first shard poisons its group on every later one
            n = NRANKS * 8
            codes = np.tile([0, 1], n // 2).astype(np.int64)
            td = np.ones(n).astype("timedelta64[ns]")
            td[2] = np.timedelta64("NaT")
            out.update(args=(td, codes), kw=dict(func=parts[3], method="blelloch"))
    elif parts[0] == "datetime":
        if parts[1].endswith(("max", "min")):
            dt = np.array(["2020-01-03", "2020-01-01", "NaT", "2020-01-05"],
                          dtype="datetime64[ns]")
            labels = np.array([0, 0, 1, 1])
        else:
            dt = np.array(["2020-01-03", "NaT", "2020-01-01", "2020-01-05", "NaT",
                           "2020-01-02"], dtype="datetime64[ns]")
            labels = np.array([0, 0, 0, 1, 1, 1])
        out.update(args=(dt, labels), kw=dict(func=parts[1], method="map-reduce"))
    elif parts[0] == "rms":
        method = "-".join(parts[1:])
        vals = np.random.default_rng(0).normal(size=96)
        labels = np.arange(96) // 24 if method == "blockwise" else np.arange(96) % 5
        out.update(args=(vals, labels), kw=dict(method=method), special="rms")
    elif parts[0] == "aligned":
        # shard s holds months {s, s+4, s+8}: shard-local cohorts,
        # interleaved along the group axis
        labels = np.concatenate([np.tile([s, s + 4, s + 8], 8) for s in range(NRANKS)])
        vals = np.random.default_rng(1).normal(size=(5, labels.shape[0]))
        out.update(args=(vals, labels), kw=dict(func=parts[1], method="cohorts"))
    elif parts[0] == "blocked":
        kind = parts[1]
        if kind in BLOCKED_LEGS:
            size, n = 30_000, 240
            codes = rng.integers(0, 37, n).astype(np.int64)
            vals = np.round(rng.normal(size=(3, n)), 3)
            vals[:, rng.random(n) < 0.2] = np.nan
            result_bytes = 3 * size * 8
            # above the dense estimate's ceiling, within the blocked peak's
            ceiling = result_bytes * (1 + BLOCKED_LEGS[kind] / NRANKS)
            out.update(args=(vals, codes), ceiling=int(ceiling),
                       kw=dict(func=kind, expected_groups=np.arange(size), method="map-reduce"))
        elif kind == "min":
            out.update(args=(np.array([1.0, np.nan, np.nan] * 8), np.array([0, 0, 1] * 8)),
                       ceiling=1_200_000,
                       kw=dict(func="nansum", min_count=20, method="map-reduce",
                               expected_groups=np.arange(100_000)))
        elif kind == "100k":
            codes = rng.integers(0, 100_000, 2048).astype(np.int64)
            vals = _data(rng, (2048,), True)
            out.update(args=(vals, codes), ceiling=1_500_000,
                       kw=dict(func="nanmean", method="map-reduce",
                               expected_groups=np.arange(100_000)))
        elif kind == "million":
            size = 1_000_000
            out.update(args=(np.ones(4096), rng.integers(0, size, 4096).astype(np.int64)),
                       ceiling=12 * 2**20,
                       kw=dict(func="sum", expected_groups=np.arange(size),
                               method="map-reduce"))
        elif parts[2] == "peak":
            out.update(args=(np.ones(64), np.arange(64) % 8), ceiling=2**20,
                       kw=dict(func="sum", expected_groups=np.arange(1_000_000),
                               method="map-reduce"))
        else:
            codes = rng.integers(0, 12, 96).astype(np.int64)
            out.update(args=(rng.normal(size=96), codes), ceiling=2**20,
                       kw=dict(func="nanfirst", expected_groups=np.arange(200_000),
                               method="map-reduce"))
    elif parts[0] == "mesh2":
        out["mesh"] = "2d"
        both = ("dcn", "ici")
        if parts[1] in ("cohorts", "scan"):
            codes = rng.integers(0, 6, 96).astype(np.int64)
            values = _data(rng, (96,), False)
            if parts[1] == "scan":
                out.update(entry="sharded_groupby_scan", special="scan_direct")
                out.update(args=(values, codes), kw=dict(func="cumsum", size=6,
                                                         axis_name=both))
            else:
                out.update(args=(values, codes),
                           kw=dict(func="nansum", method="cohorts", axis_name=both))
        elif parts[1] == "bogus":
            out.update(args=(np.arange(16.0), np.arange(16) % 2),
                       kw=dict(func="sum", method="map-reduce", axis_name="bogus"))
        elif parts[1] == "auto":
            vals = np.random.default_rng(2).normal(size=(5, 96))
            labels = np.arange(96) // 24
            if parts[2] == "ici":
                out.update(args=(vals, labels), kw=dict(func="nansum", axis_name="ici"))
            else:
                out.update(args=(vals, labels), kw=dict(func="nanmean", axis_name=both))
        else:
            n = 103
            codes = rng.integers(0, 5, n).astype(np.int64)
            out.update(args=(_data(rng, (n,), True), codes),
                       kw=dict(func=parts[1], method="map-reduce", axis_name=both))
    elif cid == "dtensor":
        codes = rng.integers(0, 4, 128).astype(np.int64)
        out.update(args=(_data(rng, (128,), False), codes),
                   kw=dict(func="nanmean", method="map-reduce"), special="dtensor")
    elif parts[0] == "many":
        method = "-".join(parts[1:])
        funcs = (("count", "nanmean", "nanstd", "nanmin", "nanmax") if method == "map-reduce"
                 else ("nanmean", "count", "nansum"))
        codes = rng.integers(0, 6, 150).astype(np.int64)
        out.update(entry="groupby_aggregate_many",
                   args=(_data(rng, (4, 150), True), codes),
                   kw=dict(funcs=funcs, method=method,
                           finalize_kwargs={"nanstd": {"ddof": 1}}))
    elif cid == "sort-engine":
        codes = 700 + rng.integers(0, 9, 90).astype(np.int64)
        out.update(args=(_data(rng, (2, 90), True), codes),
                   kw=dict(func="nanmean", method="map-reduce", engine="sort",
                           expected_groups=np.arange(2000)))
    elif parts[0] == "xarray":
        n = 120
        labels = rng.integers(0, 7, n)
        values = np.round(rng.normal(size=(3, n)), 1)
        if parts[2] == "blockwise":
            out.update(args=(values, labels), special="xr_reshard",
                       kw=dict(func="nanmedian", method="blockwise", expected_groups=np.arange(7)))
        else:
            out.update(args=(values, (np.arange(n) // 10) % 12), special="xr_cohorts", kw={})
    elif parts[0] == "complex":
        r = np.random.default_rng(0)
        vals = r.normal(size=96) + 1j * r.normal(size=96)
        out.update(args=(vals, np.arange(96) % 5), kw=dict(func=parts[1], method="map-reduce"))
    else:
        raise KeyError(cid)
    return out


# ---------------------------------------------------------------------------
# the port's side, on a rank
# ---------------------------------------------------------------------------


def _rms_port():
    import flox_tpu_torch
    from flox_tpu_torch.kernels import generic_kernel

    def sq_sum(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
        return generic_kernel("nansum", group_idx, array * array, size=size, fill_value=0.0)

    def cnt(group_idx, array, *, axis=-1, size, fill_value=None, dtype=None, **kw):
        return generic_kernel("nanlen", group_idx, array, size=size)

    return flox_tpu_torch.Aggregation(
        "rms", numpy=(sq_sum, cnt), chunk=(sq_sum, cnt),
        combine=(lambda s: s.sum(0), lambda s: s.sum(0)),
        finalize=lambda ss, n, **kw: (ss / n) ** 0.5,
        fill_value={"intermediate": (0.0, 0)}, final_fill_value=np.nan,
    )


def _to_host(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_to_host(v) for v in x)
    return x


def _kill_and_resume(entry, args, kw, kind: str):
    """Kill the stream (every rank at the same dispatch), resume it in the
    same processes, and return the resumed result, after checking that it
    resumed and is bit for bit the uninterrupted run."""
    import flox_tpu_torch
    from flox_tpu_torch import faults, profiling

    fn = getattr(flox_tpu_torch, entry)
    buf = np.full(args[0].shape, np.nan, dtype=args[0].dtype)

    def run():
        # the scan writes into one buffer: the killed run writes the slabs
        # before the kill and the resumed run the rest, so a slab that
        # neither writes stays NaN and fails the comparison
        if kind == "scan":
            r = fn(*args, out=lambda s, e, res: buf.__setitem__((..., slice(s, e)), res), **kw)
            assert r is None
            return (buf.copy(),)
        return (_to_host(fn(*args, **kw)[0]),)

    base = run()
    buf[...] = np.nan
    plan = {"kill_after": 8} if kind == "quantile" else {"kill_at": [2 * kw["batch_len"]]}
    with flox_tpu_torch.set_options(stream_checkpoint_every=1):
        with faults.inject(**plan):
            try:
                run()
            except faults.StreamKilled:
                pass
            else:
                raise AssertionError("the fault plan did not kill the stream")
        with profiling.stream_monitor() as reports:
            got = run()
    assert reports[-1].counters.resumed_at is not None, "the stream did not resume"
    assert got[0].tobytes() == base[0].tobytes(), "the resumed run differs from the base run"
    return got


def _run_stream_case(c, args, kw):
    """A streamed mesh case on this rank (see :func:`stream_case`)."""
    import flox_tpu_torch
    from flox_tpu_torch import faults

    fn = getattr(flox_tpu_torch, c["entry"])
    special = c["special"]
    if special == "kill":
        return _kill_and_resume(c["entry"], args, kw, c["kind"])
    if special == "rms":
        kw["func"] = _rms_port()
    elif special == "dense":
        kw["engine"] = "torch"
    calls: list = []
    if special == "loader":
        arr = args[0]

        def loader(s, e):
            calls.append((s, e))
            return arr[..., s:e]

        args = (loader,) + tuple(args[1:])
    if special == "raise":
        import torch.distributed as dist

        arr, rank = args[0], dist.get_rank()

        def loader(s, e):
            if rank == 1 and s >= 1600:  # its shard of the last slab
                raise ValueError(f"rank 1 cannot read [{s}:{e})")
            return arr[..., s:e]

        args = (loader,) + tuple(args[1:])
    if special == "writer":
        buf = np.empty(args[0].shape, np.int64)
        r = fn(*args, out=lambda s, e, res: buf.__setitem__((..., slice(s, e)), res), **kw)
        assert r is None
        return (buf,)
    if special == "oom":
        with faults.inject(oom_at=[800]) as plan:
            out = fn(*args, **kw)
        assert ("SimulatedOOM", 800, 1600) in plan.log, plan.log
    else:
        out = fn(*args, **kw)
    out = _to_host(out) if isinstance(out, tuple) else (_to_host(out),)
    if special == "loader":
        out = out + (np.asarray(calls, dtype=np.int64).reshape(-1, 2),)
    return out


def run_port_case(cid: str, meshes: dict):
    """The case on this rank: ``(result, *groups)`` as host arrays."""
    import torch

    import flox_tpu_torch
    from flox_tpu_torch import rechunk
    from flox_tpu_torch.parallel import sharded_groupby_scan
    from flox_tpu_torch.aggregations import _initialize_scan

    c = case(cid)
    kw = dict(c["kw"], mesh=meshes[c["mesh"]])
    args = c["args"]
    if cid.startswith("stream-"):
        with flox_tpu_torch.set_options(**({"dense_intermediate_bytes_max": c["ceiling"]}
                                           if c["ceiling"] else {})):
            return _run_stream_case(c, args, kw)
    if c["special"] == "rms":
        kw["func"] = _rms_port()
    elif c["special"] == "reshard":
        layout = rechunk.reshard_for_blockwise(args[1], NRANKS)
        args = (layout.apply(args[0], device="cpu"), layout.codes)
        kw["expected_groups"] = np.arange(7)
    elif c["special"] == "dtensor":
        from torch.distributed.tensor import Shard, distribute_tensor

        args = (distribute_tensor(torch.from_numpy(args[0]), kw["mesh"], [Shard(0)]), args[1])
    elif c["special"] == "scan_direct":
        scan = _initialize_scan(kw.pop("func"))
        return (_to_host(sharded_groupby_scan(args[0], args[1], scan, **kw)),)
    elif c["special"] in ("xr_reshard", "xr_cohorts"):
        from flox_tpu_torch import xarray as pxr, xrlite

        da = xrlite.DataArray(args[0], dims=("x", "time"), coords={"label": ("time", args[1])})
        if c["special"] == "xr_cohorts":
            return (np.asarray(pxr.rechunk_for_cohorts(da, "time", args[1], [0], chunksize=20)),)
        out, codes, _groups = pxr.rechunk_for_blockwise(da, "time", args[1], device="cpu")
        args = (out.data, codes)
    with flox_tpu_torch.set_options(**({"dense_intermediate_bytes_max": c["ceiling"]}
                                       if c["ceiling"] else {})):
        out = getattr(flox_tpu_torch, c["entry"])(*args, **kw)
    return _to_host(out) if isinstance(out, tuple) else (_to_host(out),)


def _tuned_ranks_case(rank: int, mesh) -> tuple:
    """The autotuner on a mesh whose ranks' stores disagree (rank 0's slab
    budget 2^16 bytes and the dense carry, rank 1's 2^18 bytes and the sort
    carry; the fused pass losing on rank 0 only): a streamed nansum over a
    3000-label universe, 200 labels present, and an in-memory aggregate_many.
    Returns the tuned results, the untuned calls at the agreed choices (the
    smaller budget, the sort carry, the fused pass) and the two picks."""
    import flox_tpu_torch
    from flox_tpu_torch import autotune, cache, streaming

    rng = np.random.default_rng(11)
    n, rows, size = 4000, 64, 3000
    vals = rng.normal(size=(rows, n)).astype(np.float32)
    vals[:, ::17] = np.nan
    labels = (np.arange(n) % 200) * 15
    universe = np.arange(size)
    nelems = rows * n
    with flox_tpu_torch.set_options(autotune=False, autotune_cache_path=None,
                                    sort_engine_min_groups=1024):
        cache.clear_all()
        mine, other = ("2^16", "2^18") if rank == 0 else ("2^18", "2^16")
        autotune.record("stream_slab", mine, 99.0, nelems=nelems, platform="cpu")
        autotune.record("stream_slab", other, 1.0, nelems=nelems, platform="cpu")
        win, lose = ("dense", "sort") if rank == 0 else ("sort", "dense")
        hkey = dict(dtype="float32", ngroups=size, nelems=nelems, platform="cpu")
        autotune.record("highcard", win, 99.0, **hkey)
        autotune.record("highcard", lose, 1.0, **hkey)
        fwin, flose = ("sequential", "fused") if rank == 0 else ("fused", "sequential")
        fkey = dict(dtype="float32", ngroups=12, nelems=nelems, platform="cpu")
        autotune.record("fused", fwin, 99.0, **fkey)
        autotune.record("fused", flose, 1.0, **fkey)
        months = (np.arange(n) // 334) % 12
        kw = dict(func="nansum", expected_groups=universe, mesh=mesh)
        with flox_tpu_torch.set_options(autotune=True):
            picks = (autotune.pick_stream_batch_bytes(streaming._DEFAULT_BATCH_BYTES,
                                                      nelems=nelems, platform="cpu"),
                     autotune.decide("highcard", "none", ("dense", "sort"), **hkey))
            tuned = flox_tpu_torch.streaming_groupby_reduce(vals, labels, **kw)[0]
            many = flox_tpu_torch.groupby_aggregate_many(vals, months, funcs=("nanmean", "nanmax"),
                                                         mesh=mesh)[0]
        untuned = flox_tpu_torch.streaming_groupby_reduce(vals, labels, batch_bytes=1 << 16,
                                                          engine="sort", **kw)[0]
        many_off = flox_tpu_torch.groupby_aggregate_many(vals, months,
                                                         funcs=("nanmean", "nanmax"), mesh=mesh)[0]
        cache.clear_all()
    return (_to_host(tuned), _to_host(untuned),
            *[_to_host(many[f]) for f in many], *[_to_host(many_off[f]) for f in many_off],
            np.asarray([picks[0], picks[1] == "sort"], dtype=np.int64))


def _collective_spans_case(mesh) -> tuple:
    """A map-reduce and a cohorts nanmean with telemetry on: each
    ``collective`` span's attributes, and the ``mesh.*`` counters."""
    import flox_tpu_torch
    from flox_tpu_torch import telemetry

    rng = np.random.default_rng(12)
    vals = rng.normal(size=(3, 40))
    vals[:, ::5] = np.nan
    telemetry.reset()
    with flox_tpu_torch.set_options(telemetry=True):
        for method in ("map-reduce", "cohorts"):
            flox_tpu_torch.groupby_reduce(vals, np.arange(40) % 5, func="nanmean",
                                          method=method, mesh=mesh)
    spans = [r["attrs"] for r in telemetry.drain()
             if r["type"] == "span" and r["name"] == "collective"]
    counters = {k: v for k, v in telemetry.METRICS.counters().items() if k.startswith("mesh.")}
    telemetry.reset()
    return spans, counters


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _worker(rank: int, world: int, init_file: str, out_dir: str, case_ids: list,
            timeout_s: float, hang_rank) -> None:
    import torch

    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=timeout_s))
    from flox_tpu_torch.parallel import make_mesh

    meshes = {"1d": make_mesh(device_type="cpu"), None: None}
    if world == NRANKS:
        meshes["2d"] = make_mesh(shape=(2, 2), axis_names=("dcn", "ici"), device_type="cpu")
    capture = _Capture()
    logger = logging.getLogger("flox_tpu_torch.parallel.mapreduce")
    logger.addHandler(capture)
    logger.setLevel(logging.DEBUG)
    results = {}
    for cid in case_ids:
        capture.lines.clear()
        if cid == "tuned-ranks":
            try:
                results[cid] = ("ok", _tuned_ranks_case(rank, meshes["1d"]), [])
            except Exception as err:  # noqa: BLE001 - reported to the test
                results[cid] = ("err", type(err).__name__, str(err))
            continue
        if cid == "collective-spans":
            try:
                results[cid] = ("ok", _collective_spans_case(meshes["1d"]), [])
            except Exception as err:  # noqa: BLE001 - reported to the test
                results[cid] = ("err", type(err).__name__, str(err))
            continue
        if cid == "hang":  # a rank that never reaches the collective
            if rank == hang_rank:
                time.sleep(3600)
            x = torch.ones(1)
            dist.all_reduce(x)
            results[cid] = ("ok", (x.numpy(),), [])
            continue
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                got = run_port_case(cid, meshes)
            notes = list(capture.lines) + [str(w.message) for w in caught]
            results[cid] = ("ok", got, notes)
        except Exception as err:  # noqa: BLE001 - the test compares it with the reference's
            results[cid] = ("err", type(err).__name__, str(err))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


def _resume_worker(rank: int, world: int, init_file: str, out_dir: str, spill_dir: str,
                   kill: str, timeout_s: float) -> None:
    """One rank of a checkpoint world: stream the ``stream-kill-reduce``
    case with snapshots spilled to ``spill_dir``. ``kill``: "none" (a plain
    run, which resumes when the spill allows it), "all" (every rank killed
    at slab 2) or "one" (only rank 1 killed there: the others then fail in
    the final combine). A killed rank records its outcome and leaves
    without closing the world."""
    import torch

    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=timeout_s))
    import flox_tpu_torch
    from flox_tpu_torch import faults, profiling
    from flox_tpu_torch.parallel import make_mesh

    c = stream_case("stream-kill-reduce")
    kw = dict(c["kw"], mesh=make_mesh(device_type="cpu"))
    outcome: tuple
    killed = kill == "all" or (kill == "one" and rank == 1)
    with flox_tpu_torch.set_options(stream_checkpoint_every=1, stream_checkpoint_path=spill_dir):
        try:
            with faults.inject(**({"kill_at": [2 * kw["batch_len"]]} if killed else {})):
                with profiling.stream_monitor() as reports:
                    got, _ = flox_tpu_torch.streaming_groupby_reduce(*c["args"], **kw)
            outcome = ("ok", _to_host(got), reports[-1].counters.resumed_at)
        except faults.StreamKilled:
            outcome = ("killed",)
        except Exception as err:  # noqa: BLE001 - a peer's failure, reported to the test
            outcome = ("err", type(err).__name__, str(err))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(outcome, f)
    if outcome[0] == "killed":
        os._exit(0)  # a killed process: its peers find its connections closed
    dist.destroy_process_group()


def run_resume_world(out_dir: str, spill_dir: str, kill: str, *, world: int = NRANKS,
                     deadline_s: float = 90.0, timeout_s: float = 20.0) -> list:
    """Spawn a fresh checkpoint world (:func:`_resume_worker`) and return each
    rank's outcome; a rank that is still running at the deadline is
    terminated and reported as None."""
    import torch.multiprocessing as mp

    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.get_context("spawn")
    init_file = os.path.join(out_dir, "init")
    procs = [ctx.Process(target=_resume_worker, args=(r, world, init_file, out_dir, spill_dir,
                                                      kill, timeout_s), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
    out = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                out.append(pickle.load(f))
        else:
            out.append(None)
    return out


class WorldFailed(RuntimeError):
    """A rank of the world crashed, or the world missed its deadline."""


def run_world(case_ids: list, out_dir: str, *, world: int = NRANKS, deadline_s: float = 120.0,
              timeout_s: float = 60.0, hang_rank=None) -> list[dict]:
    """Spawn ``world`` gloo ranks on the CPU, run ``case_ids`` on each, and
    return each rank's ``{case: outcome}``. Raises :class:`WorldFailed`
    (after terminating every rank) when a rank exits nonzero or the world
    is not done within ``deadline_s`` seconds."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    init_file = os.path.join(out_dir, "init")
    procs = [ctx.Process(target=_worker, args=(r, world, init_file, out_dir, list(case_ids),
                                               timeout_s, hang_rank), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        if alive:
            raise WorldFailed(f"ranks {alive} still running after the {deadline_s} s deadline")
        bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
        if bad:
            raise WorldFailed(f"ranks exited nonzero: {bad}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
