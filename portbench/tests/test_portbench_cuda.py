"""The harness on a card, at small row counts (skips without CUDA).

Run on the card: ``python3 -m pytest portbench/tests -m cuda -q``.
"""

import pytest
import torch

from portbench import cellrun, fields, run
from portbench.spec import Spec

pytestmark = pytest.mark.cuda
SPEC = Spec()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def test_remade_blocks_equal_the_resident_shard(card):
    cfg = dict(SPEC.config("oisst-v2.1-daily-0p25"), gen_rows=1000)
    shard = fields.make_shard(cfg, 2500, 300, 2**31 + 3, 2, card)
    for b in range(3):
        block = fields.remake_block(cfg, 2500, 300, 2**31 + 3, 2, b, card)
        assert torch.equal(block.isnan(), shard[b * 1000:(b + 1) * 1000].isnan())
        assert torch.equal(block.nan_to_num(), shard[b * 1000:(b + 1) * 1000].nan_to_num())


@pytest.mark.parametrize("name", ["era5-month-nanmean", "era5-daily-nanmean",
                                  "oisst-doy-nanmean"])
def test_short_traced_run(card, name):
    args = {"workload": name, "seed": 2**31 + 9, "seconds": 0.5, "trace": 1}
    line = run.result_line(SPEC, args, run.run_cell(SPEC, args, device="cuda", nrows=4096))
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0
    assert {"kernel_roofline", "other_device_ms", "device_idle_pct"} <= set(line["metrics"])
    assert 0 < line["metrics"]["kernel_roofline"]["value"] <= 105


def test_cell_bytes(card):
    cell = cellrun.Cell(SPEC, "era5-month-nanmean", 1, card, nrows=64)
    cell.make_data()
    assert cell.bytes_global() == 64 * 26304 * 4
