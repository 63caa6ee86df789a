"""A configuration, a traffic mix, a cell and a metric added as files are
found by name, with no file of the harness edited (CPU)."""

import json
import shutil
from pathlib import Path

from portbench import run
from portbench.spec import HERE, ROOT, Spec

NEW_METRIC = '''"""calls_done: the calls completed in the window."""


def read(run):
    return float(run.calls)
'''


def test_new_files_are_found(tmp_path: Path):
    bench_dir = tmp_path / "portbench"
    for sub in ("configs", "cells", "traffic", "metrics"):
        shutil.copytree(HERE / sub, bench_dir / sub)
    shutil.copy(HERE / "peaks.json", bench_dir / "peaks.json")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    # a new configuration: a small hourly grid of its own
    cfg = json.loads((HERE / "configs" / "era5-hourly-0p25.json").read_text())
    cfg.update(nlat=4, nlon=8, time={"start": "2020-01-01T00", "step": "1h", "count": 8784})
    cfg["field"] = {"dtype": "float32", "mean": 250.0, "std": 20.0, "nan_rows_share": 0.25}
    (bench_dir / "configs" / "tiny-grid.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny-grid", "source": "https://example.org/tiny",
                             "file": "portbench/configs/tiny-grid.json", "reduced": [],
                             "why": "a test"})
    # a new traffic mix (data only) and a new cell
    (bench_dir / "traffic" / "hour-nanmax.json").write_text(json.dumps(
        {"entry": "groupby_reduce", "kwargs": {"func": "nanmax"}, "by": ["hour"],
         "result_legs": 1}))
    cell = json.loads((HERE / "cells" / "era5-month-nanmean.json").read_text())
    cell.update(config="tiny-grid", traffic="hour-nanmax")
    (bench_dir / "cells" / "tiny-hour-nanmax.json").write_text(json.dumps(cell))
    bench["workloads"].append({"name": "tiny-hour-nanmax", "config": "tiny-grid",
                               "traffic": "hour-nanmax", "chips": 1, "why": "a test"})
    # a new end-to-end metric, reported in the new cell only
    (bench_dir / "metrics" / "calls_done.py").write_text(NEW_METRIC)
    bench["end_to_end"].append({"name": "calls_done", "unit": "calls", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny-hour-nanmax"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = Spec(tmp_path, bench_dir)
    args = {"workload": "tiny-hour-nanmax", "seed": 2**31 + 11, "seconds": 0.2, "trace": 0}
    line = run.result_line(spec, args, run.run_cell(spec, args, device="cpu"))
    assert line["correct"], line["checks"]
    assert line["metrics"]["calls_done"]["value"] >= 1
    assert {"reduce_gbps", "setup_s"} <= set(line["metrics"])  # no peak on the CPU
    assert line["checks"]["nonfinite_mismatch"]["value"] == 0
    # the cells already there do not report it
    assert "calls_done" not in {m["name"] for m in spec.metrics("era5-month-nanmean", False)}
