"""One run of one cell on one rank: set-up, window, trace, reference.

The harness drives the program's public entry point the way an analyst's
process does: the data resident on the card, numpy labels from the
calendar, calls back to back in a closed loop of one caller, each ending in a
synchronize. The untraced run sets no option of the program; the traced run
turns its telemetry on and profiles a short slice in the middle of the
window.
"""

from __future__ import annotations

import math
import random
import time

import numpy as np
import torch

from . import devtrace, fields, labels, tracemath
from .reference import grouped

REF_BYTES = 4e9  # the reference's working set a block of rows
WORST = ("max_rel_err", "shape_mismatch", "groups_mismatch", "missing_result")  # max over ranks
TOTAL = ("nonfinite_mismatch", "compared")  # summed over ranks
TRACE_SECONDS = 2.0  # the profiled slice's length


def over_ranks(worst: dict, total: dict, dist, dev) -> tuple[dict, dict]:
    """``worst`` maxed and ``total`` summed over every rank (as they are
    without ``dist``)."""
    if dist is None:
        return worst, total
    out = []
    for values, op in ((worst, dist.ReduceOp.MAX), (total, dist.ReduceOp.SUM)):
        t = torch.tensor([float(v) for v in values.values()], dtype=torch.float64, device=dev)
        dist.all_reduce(t, op=op)
        out.append(dict(zip(values, t.tolist())))
    return out[0], out[1]


class Cell:
    """A cell's data and call on rank ``rank`` of ``world``."""

    def __init__(self, spec, name: str, seed: int, device, rank: int = 0, world: int = 1,
                 nrows: int | None = None):
        self.cell = spec.cell(name)
        self.config = spec.config(self.cell["config"])
        self.traffic = spec.traffic(self.cell["traffic"])
        self.seed = int(seed)
        self.device = torch.device(device)
        self.rank, self.world = rank, world
        self.by = labels.groupers(self.traffic, self.config)
        self.ncols = int(self.by[0].size)
        grid = self.config["published"] if self.cell.get("rows") == "whole" else self.config
        self.nrows = int(nrows if nrows is not None else grid["nlat"] * grid["nlon"])
        self.lo, self.hi = fields.shard_bounds(self.ncols, world, rank)
        self.codes, self.groups, self.group_shape = grouped.codes_of(self.by)
        self.ngroups = int(np.prod(self.group_shape))
        self.mesh = None
        self.data = None

    # -- data and call -----------------------------------------------------

    def make_data(self, mesh=None) -> None:
        local = fields.make_shard(self.config, self.nrows, self.hi - self.lo, self.seed,
                                  self.rank, self.device)
        self.local = local
        if mesh is None:
            self.data = local
            return
        from torch.distributed.tensor import DTensor, Shard

        self.mesh = mesh
        self.data = DTensor.from_local(local, mesh, [Shard(1)], run_check=False)

    def call(self):
        import flox_tpu_torch

        entry = getattr(flox_tpu_torch, self.traffic["entry"])
        kwargs = dict(self.traffic.get("kwargs", {}))
        if self.mesh is not None:
            kwargs["mesh"] = self.mesh
        if self.device.type == "cpu":
            kwargs["device"] = "cpu"
        return entry(self.data, *self.by, **kwargs)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def timed_call(self):
        t0 = time.perf_counter()
        out = self.call()
        self.sync()
        return out, t0, time.perf_counter()

    # -- bytes -------------------------------------------------------------

    def bytes_global(self) -> int:
        """The input bytes of one call, over all cards."""
        return self.nrows * self.ncols * self.local.element_size()

    def bytes_card(self) -> int:
        """The bytes one call must move on this card (:func:`tracemath.call_bytes`)."""
        return tracemath.call_bytes(self.nrows, self.hi - self.lo, self.local.element_size(),
                                    self.ngroups, int(self.traffic.get("result_legs", 1)))

    # -- the reference -----------------------------------------------------

    def legs(self, out) -> list[tuple[str, torch.Tensor]]:
        result = out[0]
        kwargs = self.traffic.get("kwargs", {})
        if isinstance(result, dict):
            return [(f, result[f]) for f in kwargs["funcs"]]
        return [(kwargs["func"], result)]

    def judge(self, out, row_blocks) -> dict:
        """The numbers compared, for the rows in ``row_blocks``: an iterable
        of ``(r0, r1, x)`` with ``x`` the float input rows ``[r0, r1)`` over
        the whole time axis."""
        legs = self.legs(out)
        numbers = {"shape_mismatch": 0, "groups_mismatch": 0, "missing_result": 0}
        want_shape = (self.nrows,) + tuple(self.group_shape)
        for _, res in legs:
            if tuple(res.shape) != want_shape:
                numbers["shape_mismatch"] += 1
        got_groups = [np.asarray(g) for g in out[1:]]
        if len(got_groups) != len(self.groups) or not all(
                g.shape == u.shape and np.array_equal(g, u)
                for g, u in zip(got_groups, self.groups)):
            numbers["groups_mismatch"] = 1
        judge = grouped.Judge(self.config["field"]["std"])
        if numbers["shape_mismatch"] == 0:
            codes = torch.as_tensor(self.codes, device=self.device)
            for r0, r1, x in row_blocks:
                for func, res in legs:
                    want = grouped.reduce_block(x, codes, self.ngroups, func)
                    judge.add(res.reshape(self.nrows, -1)[r0:r1], want)
        numbers["max_rel_err"] = judge.max_rel_err
        numbers["nonfinite_mismatch"] = judge.nonfinite_mismatch
        numbers["compared"] = judge.compared
        return numbers

    def ref_rows(self) -> int:
        return max(1, min(self.nrows, int(REF_BYTES // (self.ncols * 40))))

    def resident_blocks(self):
        """Row blocks of the resident data (a one-card cell)."""
        step = self.ref_rows()
        for r0 in range(0, self.nrows, step):
            r1 = min(r0 + step, self.nrows)
            yield r0, r1, self.local[r0:r1]

    def remade_blocks(self, blocks: list[int]):
        """Row blocks remade from the seed, every shard of the time axis
        side by side (a sharded cell: no card holds the whole array)."""
        gen = fields.gen_rows(self.config)
        step = self.ref_rows()
        for b in blocks:
            parts = []
            for s in range(self.world):
                lo, hi = fields.shard_bounds(self.ncols, self.world, s)
                parts.append(fields.remake_block(self.config, self.nrows, hi - lo, self.seed, s,
                                                 b, self.device))
            whole = torch.cat(parts, dim=1)
            del parts
            for a in range(0, whole.shape[0], step):
                r0 = b * gen + a
                yield r0, r0 + min(step, whole.shape[0] - a), whole[a:a + step]
            del whole

    def my_blocks(self) -> list[int]:
        nblocks = -(-self.nrows // fields.gen_rows(self.config))
        return list(range(self.rank, nblocks, self.world))


class Window:
    """The closed loop: calls back to back until ``seconds`` have passed.

    On a mesh every rank must make the same calls, and a host exchange after
    each would pace the ranks: the ranks run ``first`` calls, then rank 0
    says through ``agree`` (which hands every rank rank 0's number) how many
    more its clock wants, and so on until it wants none. One result, drawn
    from the seed among all calls, is kept for the reference; the others are
    dropped."""

    def __init__(self, cell: Cell, seconds: float, trace_slice: tuple[int, int] | None = None,
                 agree=None, first: int = 1):
        self.cell = cell
        self.seconds = seconds
        self.agree = agree
        self.target = first
        self.trace_slice = trace_slice  # (first call, calls) to profile
        self.times: list[float] = []
        self.failed = 0
        self.errors: list[str] = []
        self.kept = None
        self.kept_index = -1
        self.window_s = 0.0
        self.slice = None
        self.slicing = False
        self.slice_calls: list[tuple[float, float]] = []
        self.records: list[dict] = []

    def run(self) -> None:
        rng = random.Random(self.cell.seed)
        cell = self.cell
        cell.sync()
        start = time.perf_counter()
        deadline = start + self.seconds
        i = 0
        end = start
        while True:
            if self.trace_slice and not self.slicing and (i == self.trace_slice[0] or (
                    self.agree is None and time.perf_counter() - start >= self.seconds / 2)):
                self._slice_start()
            try:
                out, t0, t1 = cell.timed_call()
            except Exception as exc:  # noqa: BLE001 - counted, reported, and not correct
                cell.sync()
                out, t0, t1 = None, end, time.perf_counter()
                self.failed += 1
                self.errors.append(f"{type(exc).__name__}: {exc}")
            end = t1
            self.times.append(t1 - t0)
            if self.slicing:
                self.slice_calls.append((t0, t1))
                if len(self.slice_calls) == self.trace_slice[1]:
                    self._slice_stop()
            i += 1
            if out is not None and rng.random() * i < 1.0:
                self.kept, self.kept_index = out, i - 1
            del out
            done = t1 >= deadline and not self.slicing
            if self.agree is None:
                if done:
                    break
            elif i >= self.target:
                more = 0 if done else max(1, math.ceil((deadline - t1) * i / (t1 - start)))
                more = self.agree(more)
                if more == 0:
                    break
                self.target = i + more
        if self.slicing:
            self._slice_stop()
        self.window_s = end - start

    def _slice_start(self) -> None:
        from flox_tpu_torch import telemetry

        telemetry.drain()
        self.slice = devtrace.Slice(self.cell.device.type)
        self.slice.start()
        self.slicing = True

    def _slice_stop(self) -> None:
        from flox_tpu_torch import telemetry

        self.slice.stop()
        self.records = telemetry.drain()
        self.slicing = False
        self.trace_slice = None

    def trace(self, kernels: list[str]) -> dict | None:
        if not self.slice_calls:
            return None
        entry = self.cell.traffic["entry"]
        ops = self.slice.device_ops()
        spans = devtrace.span_paths(self.records, entry, self.slice_calls)
        return devtrace.summarize(ops, spans, self.slice_calls, kernels, entry)


def slice_plan(call_s: float, calls: int) -> tuple[int, int]:
    """The profiled slice: about :data:`TRACE_SECONDS` of calls (3 to 400),
    centred in a window of ``calls`` calls, or started half-way through the
    window's time if that comes first."""
    n = min(400, max(3, math.ceil(TRACE_SECONDS / max(call_s, 1e-6))))
    return max(0, calls // 2 - n // 2), n
