"""The port's SLO plane (flox_tpu_torch.slo), its fault hooks and the
stress harness, against the reference's.

The reference's behaviours on the port: the spec and its validation, the
alert lifecycle on a synthetic clock, the SLI collectors, the canary prober
over the port's Dispatcher, registry and stores (billed outside the user
SLOs), the surfaces (``/slo``, ``/alerts``, the CLI, the flight-dump header,
the cache panel) and plane neutrality. Parity: the same spec and the same
``slo_inject`` bursts give the same ``evaluate()`` payload and the same
``/slo`` and ``/alerts`` JSON in both packages. The serve loop runs canary
cycles with ``--canary-interval`` and answers ``/slo`` and ``/alerts``.
Dispatchers run on the CPU; the clock is synthetic.
"""

from __future__ import annotations

import asyncio
import json
import os
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import flox_tpu
import flox_tpu_torch
from flox_tpu import (cache as ref_cache, exposition as ref_exposition, faults as ref_faults,
                      slo as ref_slo, telemetry as ref_telemetry)
from flox_tpu_torch import cache, exposition, faults, slo, telemetry
from flox_tpu_torch.faults import LockOrderViolation, stress_schedule
from flox_tpu_torch.serve import Dispatcher, payload_digest
from flox_tpu_torch.telemetry import METRICS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_plane():
    with flox_tpu_torch.set_options(telemetry=False, telemetry_export_path=None,
                                    flight_recorder_path=None, slo_path=None,
                                    serve_aot_dir=None):
        cache.clear_all()
        telemetry.reset()
        exposition.set_ready(False)
        yield
        cache.clear_all()
        telemetry.reset()
    exposition.stop_metrics_server()
    exposition.set_ready(False)


@pytest.fixture
def ref_plane():
    with flox_tpu.set_options(telemetry=False, telemetry_export_path=None,
                              flight_recorder_path=None, slo_path=None):
        ref_cache.clear_all()
        ref_telemetry.reset()
        yield
        ref_cache.clear_all()
        ref_telemetry.reset()
    ref_exposition.stop_metrics_server()


def _canary_cycle(cycle=1):
    async def go():
        dispatcher = Dispatcher(device="cpu")
        verdicts = await slo.canary_cycle(dispatcher, cycle)
        await dispatcher.close()
        return verdicts

    return asyncio.run(asyncio.wait_for(go(), 60))


def _walk_to_firing(plan, objective="availability", bad=500):
    slo.evaluate()
    plan.burst(objective, bad=bad)
    plan.advance(60)
    slo.evaluate()
    plan.advance(60)
    return slo.evaluate()


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class TestSpec:
    def test_defaults_when_no_path(self):
        spec = slo.load_spec()
        assert [o["name"] for o in spec["objectives"]] == [
            "latency", "availability", "correctness", "freshness"]
        assert [w["name"] for w in spec["windows"]] == ["fast", "slow"]
        fast = spec["windows"][0]
        assert (fast["short_s"], fast["long_s"], fast["burn_rate"]) == (300.0, 3600.0, 14.4)
        assert fast["severity"] == "page"
        assert spec == ref_slo.load_spec(force=True)

    def test_json_path_roundtrip(self, tmp_path):
        p = tmp_path / "slo.json"
        p.write_text(json.dumps({
            "objectives": [{"name": "avail", "kind": "availability", "target": 0.99}],
            "windows": [{"name": "only", "short_s": 60, "long_s": 600, "burn_rate": 2.0,
                         "severity": "page"}],
        }))
        with flox_tpu_torch.set_options(slo_path=str(p)):
            spec = slo.load_spec(force=True)
        assert spec["objectives"][0]["name"] == "avail"
        assert spec["windows"][0]["burn_rate"] == 2.0
        assert spec == ref_slo.load_spec(str(p), force=True)

    def test_toml_path(self, tmp_path):
        p = tmp_path / "slo.toml"
        p.write_text("[[objectives]]\n"
                     'name = "lat"\nkind = "latency"\ntarget = 0.95\nthreshold_ms = 50.0\n'
                     "[[windows]]\n"
                     'name = "w"\nshort_s = 60.0\nlong_s = 600.0\nburn_rate = 1.0\n')
        spec = slo.load_spec(str(p), force=True)
        assert spec["objectives"][0]["threshold_ms"] == 50.0
        assert spec["windows"][0]["severity"] == "ticket"

    @pytest.mark.parametrize("bad", [
        {"objectives": []},
        {"objectives": [{"name": "x", "kind": "nope", "target": 0.9}]},
        {"objectives": [{"name": "x", "kind": "availability", "target": 1.5}]},
        {"objectives": [{"name": "a|b", "kind": "availability", "target": 0.9}]},
        {"objectives": [{"name": "x", "kind": "latency", "target": 0.9}]},
        {"objectives": [{"name": "x", "kind": "freshness", "target": 0.9}]},
        {"objectives": [{"name": "x", "kind": "availability", "target": 0.9, "typo_key": 1}]},
        {"objectives": [{"name": "x", "kind": "availability", "target": 0.9}],
         "windows": [{"name": "w", "short_s": 600, "long_s": 60, "burn_rate": 1}]},
        {"objectives": [{"name": "x", "kind": "availability", "target": 0.9}],
         "surprise": True},
    ])
    def test_invalid_specs_raise(self, bad):
        with pytest.raises(ValueError, match="invalid SLO spec") as got:
            slo.validate_spec(bad)
        with pytest.raises(ValueError) as want:
            ref_slo.validate_spec(bad)
        assert str(got.value) == str(want.value)

    def test_unreadable_path_raises(self, tmp_path):
        with pytest.raises(ValueError, match="cannot read"):
            slo.load_spec(str(tmp_path / "missing.json"), force=True)
        garbage = tmp_path / "garbage.json"
        garbage.write_text("{nope")
        with pytest.raises(ValueError, match="cannot parse"):
            slo.load_spec(str(garbage), force=True)

    def test_per_objective_windows_override(self):
        spec = slo.validate_spec({"objectives": [{
            "name": "x", "kind": "availability", "target": 0.9,
            "windows": [{"name": "own", "short_s": 10, "long_s": 100, "burn_rate": 3.0}]}]})
        assert spec["objectives"][0]["windows"][0]["name"] == "own"
        assert [w["name"] for w in spec["windows"]] == ["fast", "slow"]


class TestAlertLifecycle:
    def test_pending_firing_resolved(self, tmp_path):
        dump = tmp_path / "flight.jsonl"
        with flox_tpu_torch.set_options(telemetry=True, flight_recorder_path=str(dump)):
            with faults.slo_inject(clock0=1000.0) as plan:
                assert slo.evaluate()["healthy"] is True
                plan.burst("availability", bad=500)
                plan.advance(60)
                payload = slo.evaluate()
                rows = {(a["objective"], a["window"]): a for a in payload["alerts"]}
                assert rows[("availability", "fast")]["state"] == "pending"
                assert payload["healthy"] is True
                plan.advance(60)
                payload = slo.evaluate()
                rows = {(a["objective"], a["window"]): a for a in payload["alerts"]}
                fast = rows[("availability", "fast")]
                assert fast["state"] == "firing" and fast["severity"] == "page"
                assert rows[("availability", "slow")]["state"] == "firing"
                assert payload["healthy"] is False
                obj = next(o for o in payload["objectives"] if o["name"] == "availability")
                assert obj["healthy"] is False
                assert fast["burn_short"] > 14.4 and obj["budget_remaining"] < 0
                assert METRICS.get("alert.pages") == 1
                assert METRICS.get("alert.fired") == 2
                assert dump.exists()
                events = [r.get("name") for r in telemetry.FLIGHT_RECORDER.records()]
                assert "alert-firing" in events and "capture-hint" in events
            payload = slo.evaluate()
            assert payload["healthy"] is True
            assert all(a["state"] == "resolved" for a in payload["alerts"])
            assert METRICS.get("alert.resolved_total") == 2

    def test_one_evaluation_blip_never_fires(self):
        with faults.slo_inject(clock0=1000.0) as plan:
            slo.evaluate()
            plan.burst("availability", bad=50)
            plan.advance(60)
            assert any(a["state"] == "pending" for a in slo.evaluate()["alerts"])
        assert slo.evaluate()["alerts"] == []
        assert METRICS.get("alert.fired") == 0

    def test_breach_requires_both_windows(self):
        with faults.slo_inject(clock0=1000.0) as plan:
            slo.evaluate()
            plan.burst("availability", bad=500)
            plan.advance(60)
            slo.evaluate()
            plan.advance(400)
            slo.evaluate()
            rows = {(a["objective"], a["window"]): a for a in slo.evaluate()["alerts"]}
            fast = rows.get(("availability", "fast"))
            assert fast is None or fast["state"] != "firing"

    def test_plan_without_clock_refuses_advance(self):
        with faults.slo_inject() as plan:
            assert faults.slo_active() and faults.slo_now() is None
            with pytest.raises(ValueError, match="no clock"):
                plan.advance(1.0)
        assert not faults.slo_active()


#: injection scripts replayed on both packages: (kind, args)
SCRIPTS = {
    "page-then-resolve": [("eval",), ("burst", "availability", 0, 500), ("adv", 60),
                          ("eval",), ("adv", 60), ("eval",), ("out",), ("eval",)],
    "blip": [("eval",), ("burst", "correctness", 1, 40), ("adv", 30), ("eval",), ("out",),
             ("eval",)],
    "slow-burn": [("eval",), ("burst", "latency", 990, 10), ("adv", 3000), ("eval",),
                  ("burst", "latency", 990, 30), ("adv", 30000), ("eval",), ("adv", 400),
                  ("eval",)],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_same_bursts_same_payloads(name, ref_plane):
    """The same spec and the same bursts give the same ``evaluate()``
    payloads (the synthetic clock is ``evaluated_at``)."""
    got, want = [], []
    for pkg_slo, pkg_faults, out in ((slo, faults, got), (ref_slo, ref_faults, want)):
        ctx = pkg_faults.slo_inject(clock0=5000.0)
        plan = ctx.__enter__()
        live = True
        try:
            for step in SCRIPTS[name]:
                if step[0] == "eval":
                    out.append(pkg_slo.evaluate(now=None if live else 99999.0))
                elif step[0] == "burst":
                    plan.burst(step[1], good=step[2], bad=step[3])
                elif step[0] == "adv":
                    plan.advance(step[1])
                elif step[0] == "out":
                    ctx.__exit__(None, None, None)
                    live = False
        finally:
            if live:
                ctx.__exit__(None, None, None)
        out.append(pkg_slo.slo_stats())
        out.append(pkg_slo.alert_snapshot())
    assert got == want


def test_same_slo_and_alerts_json(ref_plane):
    """``/slo`` and ``/alerts`` over HTTP answer the same JSON in both
    packages (identity labels aside) before, during and after an alert."""
    bodies = {}
    for key, pkg_exp, pkg_faults in (("port", exposition, faults),
                                     ("ref", ref_exposition, ref_faults)):
        with pkg_faults.slo_inject(clock0=7000.0) as plan:
            port = pkg_exp.start_metrics_server(port=0)
            try:
                seen = []
                for step in range(3):
                    if step == 1:
                        plan.burst("availability", bad=500)
                    plan.advance(60)
                    for path in ("/slo", "/alerts"):
                        status, body = _get(port, path)
                        assert status == 200
                        body.pop("replica"), body.pop("host")
                        seen.append(body)
            finally:
                pkg_exp.stop_metrics_server()
        bodies[key] = seen
    assert bodies["port"] == bodies["ref"]
    assert bodies["port"][-1]["alerts"]  # the page fired in both


class TestCollectors:
    def test_latency_buckets_split_on_threshold(self):
        METRICS.observe("serve.request_ms", 5.0)
        METRICS.observe("serve.request_ms", 4000.0)
        lat = next(o for o in slo.evaluate()["objectives"] if o["kind"] == "latency")
        assert (lat["good"], lat["bad"]) == (1.0, 1.0)

    def test_tenant_latency_objective_reads_its_histogram(self, tmp_path):
        p = tmp_path / "slo.json"
        p.write_text(json.dumps({"objectives": [
            {"name": "acme", "kind": "latency", "target": 0.9, "threshold_ms": 10.0,
             "tenant": "acme"}]}))
        with flox_tpu_torch.set_options(slo_path=str(p)):
            label = telemetry.tenant_label("acme")
            METRICS.observe(f"serve.request_ms|tenant={label}", 50.0)
            METRICS.observe("serve.request_ms", 1.0)
            obj = slo.evaluate()["objectives"][0]
        assert (obj["good"], obj["bad"]) == (0.0, 1.0)

    def test_availability_taxonomy_excludes_drain_and_protocol(self):
        METRICS.inc("serve.requests", 10)
        METRICS.inc("serve.shed", 2)
        METRICS.inc("serve.drain_rejected", 5)
        METRICS.inc("serve.protocol_errors", 3)
        avail = next(o for o in slo.evaluate()["objectives"] if o["kind"] == "availability")
        assert (avail["good"], avail["bad"]) == (8.0, 2.0)

    def test_freshness_ticks_from_store_staleness(self, tmp_path):
        from flox_tpu_torch.serve import stores as serve_stores

        spec_path = tmp_path / "slo.json"
        spec_path.write_text(json.dumps({"objectives": [
            {"name": "fresh", "kind": "freshness", "target": 0.9, "max_staleness_s": 100.0}]}))
        with flox_tpu_torch.set_options(store_root=str(tmp_path / "stores"),
                                        slo_path=str(spec_path), store_fsync="off"):
            for name in ("user-store", slo.CANARY_STORE):
                serve_stores.append(name, np.array([0, 1]), np.array([1.0, 2.0]),
                                    slab_id="s0", create={"funcs": ["sum"], "size": 2},
                                    device="cpu")
            fresh = next(o for o in slo.evaluate()["objectives"] if o["name"] == "fresh")
            assert (fresh["good"], fresh["bad"]) == (1.0, 0.0)
            for entry in serve_stores._STORE_TABLE.values():
                entry.last_ack -= 1000.0
            fresh = next(o for o in slo.evaluate()["objectives"] if o["name"] == "fresh")
            assert (fresh["good"], fresh["bad"]) == (1.0, 1.0)


class TestCanary:
    def test_cycle_all_green_without_store_root(self):
        with flox_tpu_torch.set_options(telemetry=True):
            verdicts = _canary_cycle()
        assert verdicts == {"reduce": True, "multistat": True, "dataset": True, "store": None}
        assert METRICS.get("canary.ok") == 3.0
        assert METRICS.get("canary.failures") == 0.0

    def test_store_probe_roundtrips(self, tmp_path):
        with flox_tpu_torch.set_options(telemetry=True, store_root=str(tmp_path),
                                        store_fsync="off"):
            assert _canary_cycle()["store"] is True
            assert _canary_cycle(cycle=2)["store"] is True  # an exactly-once replay

    def test_canary_answers_are_exact_in_every_order(self):
        # the payload's sums are small integers: exact whatever order a
        # scatter adds them in
        arr = np.asarray(slo._CANARY_ARRAY)
        for perm in ([0, 1, 2, 3], [3, 2, 1, 0], [2, 0, 3, 1]):
            sums = np.zeros(2)
            np.add.at(sums, np.asarray(slo._CANARY_BY)[perm], arr[perm])
            assert np.array_equal(sums, slo._EXPECTED["sum"])
        assert all(float(v).is_integer() and abs(v) < 2**24 for v in arr)

    def test_canary_billed_outside_user_slos(self):
        with flox_tpu_torch.set_options(telemetry=True):
            _canary_cycle()
            assert METRICS.get("serve.requests") == 0.0
            assert METRICS.get("canary.requests") == 3.0
            assert slo.CANARY_TENANT not in telemetry.cost_by_tenant()
            assert slo.CANARY_TENANT in telemetry.cost_by_tenant(include_canary=True)
            hist = METRICS.histograms().get("serve.request_ms")
            assert hist is None or hist["count"] == 0

    def test_canary_never_consumes_a_tenant_slot(self):
        with flox_tpu_torch.set_options(telemetry=True):
            for i in range(telemetry._TENANT_MAX):
                telemetry.tenant_label(f"t{i}")
            assert telemetry.tenant_label("newcomer") == "_other"
            assert telemetry.tenant_label(slo.CANARY_TENANT) == slo.CANARY_TENANT
            assert slo.CANARY_TENANT not in telemetry._TENANT_LABELS

    def test_injected_wrong_answer_burns_correctness_not_availability(self):
        with flox_tpu_torch.set_options(telemetry=True):
            with faults.slo_inject(corrupt_canary={"reduce": 1}):
                verdicts = _canary_cycle()
            assert verdicts["reduce"] is False and verdicts["multistat"] is True
            assert METRICS.get("canary.failures") == 1.0
            assert METRICS.get("canary.failures|op=reduce") == 1.0
            payload = slo.evaluate()
            kinds = {o["kind"]: o for o in payload["objectives"]}
            assert kinds["correctness"]["bad"] == 1.0
            assert (kinds["availability"]["good"], kinds["availability"]["bad"]) == (0.0, 0.0)
            events = [r.get("name") for r in telemetry.FLIGHT_RECORDER.records()]
            assert "canary-failure" in events

    def test_wildcard_corruption_hits_every_op(self):
        with flox_tpu_torch.set_options(telemetry=True):
            with faults.slo_inject(corrupt_canary={"*": -1}) as plan:
                verdicts = _canary_cycle()
        assert verdicts["reduce"] is verdicts["multistat"] is verdicts["dataset"] is False
        assert [e[1] for e in plan.log] == ["reduce", "multistat", "dataset"]

    def test_a_raising_probe_is_a_correctness_failure(self, monkeypatch):
        from flox_tpu_torch.serve import registry

        def broken(*args, **kwargs):
            raise RuntimeError("registry down")

        monkeypatch.setattr(registry, "put", broken)
        verdicts = _canary_cycle()
        assert verdicts["dataset"] is False and verdicts["reduce"] is True
        assert slo.slo_stats()["canary"] == {"probes": 3, "failures": 1}

    def test_corrupted_canary_pages_and_dumps(self, tmp_path):
        """A page-severity correctness alert goes pending -> firing on the
        synthetic clock, writes a flight dump and appears in ``/alerts``."""
        dump = tmp_path / "flight.jsonl"
        with flox_tpu_torch.set_options(telemetry=True, flight_recorder_path=str(dump)):
            port = exposition.start_metrics_server(port=0)
            with faults.slo_inject(clock0=1000.0, corrupt_canary={"*": -1}) as plan:
                slo.evaluate()
                _canary_cycle(1)
                plan.advance(60)
                states = [a["state"] for a in slo.evaluate()["alerts"]
                          if (a["objective"], a["window"]) == ("correctness", "fast")]
                assert states == ["pending"]
                _canary_cycle(2)
                plan.advance(60)
                status, body = _get(port, "/alerts")
        assert status == 200
        rows = {(a["objective"], a["window"]): a for a in body["alerts"]}
        assert rows[("correctness", "fast")]["state"] == "firing"
        assert rows[("correctness", "fast")]["severity"] == "page"
        header = json.loads(dump.read_text().splitlines()[0])
        assert header["attrs"]["reason"] == "alert:correctness:fast"
        assert "correctness/fast[page]" in header["attrs"]["alerts"]["firing"]


class TestSurfaces:
    def test_slo_and_alerts_endpoints(self):
        with flox_tpu_torch.set_options(telemetry=True):
            port = exposition.start_metrics_server(port=0)
            status, payload = _get(port, "/slo")
            assert status == 200 and payload["healthy"] is True
            assert {o["kind"] for o in payload["objectives"]} == {
                "latency", "availability", "correctness", "freshness"}
            assert "replica" in payload
            status, body = _get(port, "/alerts")
            assert body["alerts"] == [] and body["healthy"] is True
            assert METRICS.get("slo.objectives") == 4.0

    def test_bad_spec_is_a_500_not_a_silent_pass(self, tmp_path):
        bad = tmp_path / "bad.json"
        bad.write_text(json.dumps({"objectives": [{"name": "x"}]}))
        with flox_tpu_torch.set_options(telemetry=True, slo_path=str(bad)):
            port = exposition.start_metrics_server(port=0)
            for path in ("/slo", "/alerts"):
                status, body = _get(port, path)
                assert status == 500 and "invalid SLO spec" in body["error"]
            assert METRICS.get("slo.spec_errors") >= 1.0

    def test_cli_exit_codes_gate_deploys(self, capsys):
        assert telemetry.main(["slo"]) == 0
        out = capsys.readouterr().out
        assert "availability" in out and "burn" in out
        with faults.slo_inject(clock0=1000.0) as plan:
            slo.evaluate()
            plan.burst("availability", bad=500)
            plan.advance(60)
            slo.evaluate()
            plan.advance(60)
            assert telemetry.main(["slo"]) == 2
            assert "FIRING" in capsys.readouterr().out.upper()

    def test_cli_reads_slo_scrape_file_as_the_reference_does(self, tmp_path, capsys):
        with faults.slo_inject(clock0=1000.0) as plan:
            payload = _walk_to_firing(plan)
        p = tmp_path / "scrape.json"
        p.write_text(json.dumps(payload))
        assert telemetry.main(["slo", str(p)]) == 2
        got = capsys.readouterr().out
        assert ref_telemetry.main(["slo", str(p)]) == 2
        assert got == capsys.readouterr().out

    def test_flight_dump_header_and_report_carry_alert_state(self, tmp_path, capsys):
        dump = tmp_path / "flight.jsonl"
        with flox_tpu_torch.set_options(telemetry=True, flight_recorder_path=str(dump)):
            with faults.slo_inject(clock0=1000.0) as plan:
                _walk_to_firing(plan)
                header = json.loads(dump.read_text().splitlines()[0])
                assert "availability/fast[page]" in header["attrs"]["alerts"]["firing"]
        assert telemetry.main(["report", str(dump)]) == 0
        out = capsys.readouterr().out
        assert "slo / alert plane:" in out and "alert-firing" in out

    def test_cache_stats_panel_and_clear_all(self):
        with faults.slo_inject(clock0=1000.0) as plan:
            _walk_to_firing(plan)
            panel = cache.stats()["slo"]
            assert panel["alerts"]["firing"] == 2 and panel["snapshots"] == 3
            cache.clear_all()
            assert slo.alerts() == [] and slo.slo_stats()["snapshots"] == 0

    def test_telemetry_reset_clears_the_plane(self):
        with faults.slo_inject(clock0=1000.0) as plan:
            _walk_to_firing(plan)
        telemetry.reset()
        assert slo.slo_stats() == {"spec_path": None, "snapshots": 0,
                                   "alerts": {"firing": 0, "pending": 0, "resolved": 0},
                                   "canary": {"probes": 0, "failures": 0}}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_loop_canary_answers_slo_and_alerts(tmp_path):
    """``python -m flox_tpu_torch.serve --device cpu --canary-interval 0.2``
    runs canary cycles, and its ``/slo`` and ``/alerts`` answer 200 with the
    reference's shapes: healthy correctness and availability objectives fed
    by the probes, no alerts."""
    port = _free_port()
    env = dict(os.environ, FLOX_TPU_TELEMETRY="1")
    env.pop("FLOX_TPU_TELEMETRY_EXPORT_PATH", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "flox_tpu_torch.serve", "--device", "cpu",
         "--canary-interval", "0.2", "--metrics-port", str(port)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO,
        env=env, text=True)
    try:
        heads = [json.loads(proc.stdout.readline()) for _ in range(2)]
        assert {h["op"] for h in heads} == {"metrics", "canary"}
        deadline = time.monotonic() + 60
        good = 0.0
        while good < 9 and time.monotonic() < deadline:
            time.sleep(0.3)
            status, payload = _get(port, "/slo")
            assert status == 200
            kinds = {o["kind"]: o for o in payload["objectives"]}
            good = kinds["correctness"]["good"]
        assert good >= 9 and kinds["correctness"]["bad"] == 0
        assert kinds["correctness"]["healthy"] and kinds["availability"]["healthy"]
        ref_keys = set(ref_slo.evaluate()) | {"replica", "host"}
        assert set(payload) == ref_keys
        status, body = _get(port, "/alerts")
        assert status == 200 and body["alerts"] == [] and body["healthy"] is True
        assert set(body) == {"alerts", "healthy", "evaluated_at", "replica", "host"}
        proc.stdin.write('{"op": "shutdown"}\n')
        proc.stdin.flush()
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err


class TestPlaneNeutrality:
    def test_bit_identity_with_slo_plane_enabled(self):
        vals = np.random.default_rng(3).normal(size=(4, 64))
        codes = np.arange(64) % 7
        baseline, _ = flox_tpu_torch.groupby_reduce(vals, codes, func="nanmean", device="cpu")
        with flox_tpu_torch.set_options(telemetry=True):
            with faults.slo_inject(clock0=1000.0) as plan:
                slo.evaluate()
                plan.burst("availability", bad=500)
                plan.advance(60)
                slo.evaluate()
                _canary_cycle()
                lit, _ = flox_tpu_torch.groupby_reduce(vals, codes, func="nanmean",
                                                       device="cpu")
        assert baseline.numpy().tobytes() == lit.numpy().tobytes()

    def test_evaluate_without_serve_layer_is_healthy(self):
        payload = slo.evaluate()
        assert payload["healthy"] is True
        assert all(o["good"] == 0 and o["bad"] == 0 for o in payload["objectives"])


# -- the schedule-stress harness ----------------------------------------------


@pytest.fixture
def demo():
    name = "torch_stress_demo_mod"
    mod = types.ModuleType(name)
    mod._A, mod._B, mod._R = threading.Lock(), threading.Lock(), threading.RLock()
    sys.modules[name] = mod
    yield mod
    sys.modules.pop(name, None)


class TestStressSchedule:
    def test_switch_interval_set_and_restored(self):
        prev = sys.getswitchinterval()
        with pytest.raises(RuntimeError):
            with stress_schedule(switch_interval=1e-6) as watcher:
                assert watcher is None
                assert sys.getswitchinterval() == pytest.approx(1e-6)
                raise RuntimeError("body failed")
        assert sys.getswitchinterval() == pytest.approx(prev)

    def test_wraps_restores_and_catches_inversions(self, demo):
        raw_a = demo._A
        with stress_schedule(watch=(demo.__name__,)):
            assert demo._A is not raw_a
            with demo._A:
                with demo._B:
                    pass
            with pytest.raises(LockOrderViolation, match="inversion"):
                with demo._B:
                    with demo._A:
                        pass
            with pytest.raises(LockOrderViolation, match="self-deadlock"):
                with demo._A:
                    with demo._A:
                        pass
            with demo._R:
                with demo._R:
                    pass
        assert demo._A is raw_a

    def test_seeded_graph_from_file(self, tmp_path, demo):
        graph = tmp_path / "graph.json"
        graph.write_text(json.dumps({"edges": [
            {"from": f"{demo.__name__}._A", "to": f"{demo.__name__}._B", "site": "x.py:1"}]}))
        with stress_schedule(watch=(demo.__name__,), order_graph=str(graph)):
            with pytest.raises(LockOrderViolation):
                with demo._B:
                    with demo._A:
                        pass

    def test_port_planes_race_clean_under_stress(self):
        """The port's module locks (SLO plane, autotune store, exposition,
        telemetry) under a ~1 µs switch interval with their acquire order
        checked: concurrent evaluations, records and readiness flips."""
        from flox_tpu_torch import autotune

        watch = ("flox_tpu_torch.slo", "flox_tpu_torch.autotune",
                 "flox_tpu_torch.exposition")
        errors = []

        def work(n):
            try:
                for i in range(40):
                    slo.evaluate()
                    autotune.record("stream_prefetch", str(i % 3), 1.0 + n, nelems=1 << 20,
                                    platform="cpu")
                    exposition.set_ready(i % 2 == 0, reason=f"t{n}")
                    slo.record_canary("reduce", True)
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        with stress_schedule(watch=watch):
            threads = [threading.Thread(target=work, args=(n,)) for n in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not errors
        assert slo.slo_stats()["canary"]["probes"] == 160
        assert slo.slo_stats()["snapshots"] == 160

    def test_quarantine_replays_under_stress(self):
        """A serve-chaos case re-run under the stress schedule: one poisoned
        member of a micro-batch fails alone, its peers bit for bit their solo
        runs, with the dispatcher's and the plane's module locks watched."""
        labels = np.random.default_rng(0).integers(0, 5, size=64)
        payloads = [np.arange(64, dtype=np.float64) + 10 * i for i in range(4)]
        solo = [flox_tpu_torch.groupby_reduce(p, labels, func="sum", device="cpu")[0]
                for p in payloads]

        async def main():
            d = Dispatcher(device="cpu", batch_window=0.05)
            with faults.serve_inject(poison_digests=[payload_digest(payloads[2])]):
                results = await asyncio.gather(
                    *[d.submit(func="sum", array=p, by=labels) for p in payloads],
                    return_exceptions=True)
            await d.close()
            return results

        with stress_schedule(watch=("flox_tpu_torch.serve.dispatcher",
                                    "flox_tpu_torch.serve.breaker", "flox_tpu_torch.telemetry",
                                    "flox_tpu_torch.slo")):
            results = asyncio.run(asyncio.wait_for(main(), 120))
        for i, (got, want) in enumerate(zip(results, solo)):
            if i == 2:
                assert isinstance(got, faults.SimulatedCompileError), got
            else:
                assert np.asarray(got.result).tobytes() == want.numpy().tobytes()

    def test_autotune_register_atexit_takes_lock(self, monkeypatch):
        from flox_tpu_torch import autotune

        events = []

        class Probe:
            def __enter__(self):
                events.append("acquire")

            def __exit__(self, *exc):
                events.append("release")
                return False

        monkeypatch.setattr(autotune, "_LOCK", Probe())
        monkeypatch.setitem(autotune._AUTOTUNE_STATE, "atexit", True)
        autotune._register_atexit()
        assert events == ["acquire", "release"]

    def test_exports(self):
        for name in ("stress_schedule", "LockOrderViolation", "slo_inject", "slo_now",
                     "slo_injected", "slo_active", "slo_canary_corrupt"):
            assert name in faults.__all__ and callable(getattr(faults, name)), name
