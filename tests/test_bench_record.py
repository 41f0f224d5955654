"""The bench's incremental-emission record (bench.py).  A timeout may kill
bench.py at any instant, so the guarantees under test are: every stage re-prints a
complete cumulative JSON line on stdout; a failing stage degrades to an
error key without stopping later stages; budget-exhausted optional stages
skip with a recorded reason while judged stages still run; NaN values
serialise as null (parseable record)."""

import json

import pytest


@pytest.fixture
def bench(monkeypatch):
    import bench as b

    monkeypatch.setattr(b, "_BUDGET_S", 1e9)
    return b


def _lines(capsys):
    return [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()]


def test_emit_after_every_stage_and_error_isolation(bench, capsys):
    rec = bench._Record()
    rec.run_stage("ok", lambda: rec.extras.__setitem__("x", 1))
    rec.run_stage("boom", lambda: 1 / 0)
    rec.run_stage("after", lambda: rec.extras.__setitem__("y", 2))
    lines = _lines(capsys)
    assert len(lines) == 3
    # each line is a complete record-so-far with the headline fields
    for ln in lines:
        assert ln["metric"] == "batched_2d_bilinear_interp"
    assert lines[0]["x"] == 1
    assert "division" in lines[1]["boom_error"]
    assert lines[2]["y"] == 2 and lines[2]["x"] == 1
    assert set(lines[2]["stage_seconds"]) == {"ok", "boom", "after"}


def test_budget_skips_optional_but_not_judged(bench, capsys, monkeypatch):
    monkeypatch.setattr(bench, "_BUDGET_S", -1.0)   # budget already spent
    rec = bench._Record()
    ran = []
    rec.run_stage("opt", lambda: ran.append("opt"), min_budget_s=60)
    rec.run_stage("judged", lambda: ran.append("judged"), judged=True)
    assert ran == ["judged"]
    last = _lines(capsys)[-1]
    assert "opt_skipped" in last and "judged" in last["stage_seconds"]


def test_nan_serialises_as_null(bench, capsys):
    rec = bench._Record()
    rec.extras["bad"] = float("nan")
    rec.extras["inf"] = float("inf")
    rec.emit()
    last = _lines(capsys)[-1]
    assert last["bad"] is None and last["inf"] is None


def test_json_safe_is_recursive(bench, capsys):
    """Nested non-finite values (device record, cold-start breakdown and
    other nested dicts/lists) must serialise as null too."""
    rec = bench._Record()
    rec.extras["probe"] = {"rtt_ms": float("nan"), "ok": 1.5}
    rec.extras["spread"] = [1.0, float("inf")]
    rec.extras["deep"] = {"a": {"b": [float("nan")]}}
    rec.emit()
    last = _lines(capsys)[-1]
    assert last["probe"] == {"rtt_ms": None, "ok": 1.5}
    assert last["spread"] == [1.0, None]
    assert last["deep"] == {"a": {"b": [None]}}
