"""What the harness and the reference import (CPU, fresh interpreters)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench.spec import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "flox_tpu"}

RUN_A_CELL = """
import json, sys
from portbench import run, control
from portbench.spec import Spec
spec = Spec()
for m in spec.bench["end_to_end"] + spec.bench["per_layer"]:
    spec.reader(m["name"])
args = {"workload": "era5-month-nanmean", "seed": 5, "seconds": 0.1, "trace": 1}
line = run.result_line(spec, args, run.run_cell(spec, args, device="cpu", nrows=8))
print(json.dumps({"correct": line["correct"],
                  "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def _fresh(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_no_flox_tpu():
    got = _fresh(RUN_A_CELL)
    assert got["correct"]
    assert "flox_tpu_torch" in got["top"]  # the whole names are compared, not prefixes
    assert not FORBIDDEN & set(got["top"])


def test_the_reference_imports_nothing_of_the_program():
    got = _fresh("import json, sys; import portbench.reference.grouped; "
                 "print(json.dumps({'top': sorted({m.split('.')[0] for m in sys.modules})}))")
    assert not (FORBIDDEN | {"flox_tpu_torch"}) & set(got["top"])
    for path in (HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in FORBIDDEN | {"flox_tpu_torch", "portbench"}, (path, name)


def test_no_harness_source_names_jax_or_flox_tpu():
    for path in Path(HERE).rglob("*.py"):
        if "tests" in path.parts:
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = {(node.module or "").split(".")[0]}
            else:
                continue
            assert not FORBIDDEN & tops, (path, tops)
