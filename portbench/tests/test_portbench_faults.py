"""The harness's verdict with the timed path broken underneath (CPU).

Each fault a cell can have, planted under the entry point the harness
calls, makes ``correct`` come out false; the sound program and the
harness together make it true. The control (the reference in bfloat16, put
in the program's place) fails each cell's limit at a small size.
"""

import numpy as np
import pytest
import torch

import flox_tpu_torch
from portbench import cellrun, run
from portbench.reference import grouped
from portbench.spec import Spec

SPEC = Spec()
ONE_CARD = ["era5-month-nanmean", "oisst-doy-nanmean", "era5-daily-nanmean"]
REAL = flox_tpu_torch.groupby_reduce


def _run(name, nrows=16, hook=None):
    args = {"workload": name, "seed": 2**31 + 5, "seconds": 0.05, "trace": 0}
    return run.result_line(SPEC, args, run.run_cell(SPEC, args, device="cpu", nrows=nrows,
                                                    hook=hook))


def half_the_batch(array, *by, **kw):
    """Every other column left out: each mean taken over the rest."""
    keep = np.arange(array.shape[-1]) % 2 == 0
    return REAL(array[..., torch.from_numpy(keep)], *(b[keep] for b in by), **kw)


def answer_altered(array, *by, **kw):
    out = REAL(array, *by, **kw)
    out[0][3, 5] += 0.01  # one output, where it is produced
    return out


def control_in_place(array, *by, **kw):
    """The control: the reference from bfloat16 inputs, float32 sums."""
    codes, groups, shape = grouped.codes_of(list(by))
    res = grouped.reduce_block(array, torch.as_tensor(codes), int(np.prod(shape)), kw["func"],
                               "bfloat16")
    return (res.reshape(array.shape[:-1] + shape),) + tuple(groups)


@pytest.mark.parametrize("name", ONE_CARD)
def test_sound_run_is_correct(name):
    assert _run(name)["correct"]


@pytest.mark.parametrize("fault", [half_the_batch, answer_altered, control_in_place])
@pytest.mark.parametrize("name", ONE_CARD)
def test_fault_is_not_correct(name, fault, monkeypatch):
    monkeypatch.setattr(flox_tpu_torch, "groupby_reduce", fault)
    line = _run(name, nrows=64)
    assert not line["correct"], line["checks"]


def test_control_fails_the_limit_at_full_width():
    """The control's widest gap on the one-card cells' own labels, at 256
    rows: at least three times under the limit it must exceed."""
    for name in ONE_CARD:
        cell = cellrun.Cell(SPEC, name, 7, "cpu", nrows=256)
        cell.make_data()
        judge = grouped.Judge(cell.config["field"]["std"])
        codes = torch.as_tensor(cell.codes)
        for _, _, x in cell.resident_blocks():
            want = grouped.reduce_block(x, codes, cell.ngroups, "nanmean")
            judge.add(grouped.reduce_block(x, codes, cell.ngroups, "nanmean", "bfloat16"), want)
        assert judge.max_rel_err > cell.cell["limits"]["max_rel_err"], name


def no_exchange():
    """The exchange between cards left out: every collective keeps the local
    part (runs in each rank of the spawned world)."""
    from flox_tpu_torch.parallel import mesh

    mesh.Collectives._reduce = lambda self, x, op: x

    def local_tile(self, x):
        t = x.shape[0] // self.size
        return x[self.index * t:(self.index + 1) * t]

    mesh.Collectives.psum_scatter = local_tile


def test_mesh_cell_sound_and_without_its_exchange(monkeypatch):
    from flox_tpu_torch.parallel import mesh

    for name in ("_reduce", "psum_scatter"):  # rank 0 is this process: undone after
        monkeypatch.setattr(mesh.Collectives, name, getattr(mesh.Collectives, name))
    assert _run("era5-doy-4card", nrows=8)["correct"]
    line = _run("era5-doy-4card", nrows=8, hook=no_exchange)
    assert not line["correct"], line["checks"]


def flax_on_rank_1():
    """A module named like a forbidden one, loaded on rank 1 alone."""
    import sys
    import types

    import torch.distributed as dist

    if dist.get_rank() == 1:
        sys.modules["flax"] = types.ModuleType("flax")


def test_a_module_loaded_on_another_rank_reaches_rank_0():
    args = {"workload": "era5-doy-4card", "seed": 2**31 + 5, "seconds": 0.05, "trace": 0}
    out = run.run_cell(SPEC, args, device="cpu", nrows=8, hook=flax_on_rank_1)
    assert out["loaded"] == ["flax"]
    assert "flax" not in run.forbidden_modules()  # rank 0 itself never loaded it


@pytest.mark.parametrize("out", [{"loaded": ["flax"], "trace_faults": 0},
                                 {"loaded": [], "trace_faults": 1}])
def test_main_prints_no_result_for_a_forbidden_module_or_an_unread_trace(out, monkeypatch,
                                                                        capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(run, "run_cell", lambda spec, args, **kw: out)
    monkeypatch.setattr(run, "result_line", lambda spec, args, o: {"checks": {}})
    rc = run.main(["--workload", "era5-doy-4card", "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""
