"""BENCHMARK.json and the files it names: keys, names and units, each
cell's files, the metrics each cell reports, the result line's keys, and
the check of loaded modules by whole top-level name."""
import json
import os
import re
import sys

import pytest

from perfbench import core
from perfbench import run as runner

BENCH = runner.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
ENTRY_KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
              "workloads": {"name", "config", "traffic", "chips", "why"},
              "end_to_end": {"name", "unit", "better", "bound", "source"},
              "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    n = 24  # the most cells later PRs may reach
    assert 2 + 14 * n * (BENCH["run_seconds"] + 60) + n * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(core.ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_have_just_their_keys_and_lawful_names(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = set(e) - ENTRY_KEYS[section]
        assert set(e) >= ENTRY_KEYS[section] and extra <= ({"workloads"} if "unit" in e else set())
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert TEXT.match(e[key]), e[key]


def test_configs_cells_and_their_files():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    used = {w["config"] for w in cells.values()}
    for c in BENCH["configs"]:
        assert c["name"] in used and c["file"].startswith("perfbench/")
        assert c["reduced"] == [] or all(NAME.match(k) for k in c["reduced"])
        assert core.load_json("configs", f"{c['name']}.json")["name"] == c["name"]
    pairs = [(w["config"], w["traffic"]) for w in cells.values()]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    for name, w in cells.items():
        cell = core.load_json("cells", f"{name}.json")
        assert (cell["config"], cell["traffic"], cell["chips"]) == (w["config"], w["traffic"],
                                                                    w["chips"])
        assert w["chips"] in (1, 4)
        core.load_json("traffic", f"{w['traffic']}.json")
        assert os.path.exists(os.path.join(core.BENCH_DIR, "drivers", f"{cell['driver']}.py"))
        assert core.load_json("limits", f"{name}.json")


def test_metrics_each_cell_reports():
    cells = [w["name"] for w in BENCH["workloads"]]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                    "program_counter", "host_clock")
        assert os.path.exists(os.path.join(core.BENCH_DIR, "metrics", f"{m['name']}.py"))
        for w in m.get("workloads", cells):
            assert w in e2e[m["moves"]].get("workloads", cells), (m["name"], w)
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
        layers.setdefault(m["layer"], set()).add(m["name"])
    for cell in cells:
        reported = [n for n, _ in runner.metrics_for(BENCH, cell, False)]
        assert "setup_s" in reported and len(reported) >= 2
        assert runner.metrics_for(BENCH, cell, True)


def test_result_line_keys_and_checks_last():
    from types import SimpleNamespace
    res = core.RunResult(e2e={"clips_per_s": 7.5, "setup_s": 20.0, "peak_mem_gib": 4.0},
                         layer={}, checks=[core.Check("tokens_differ", 0.0, 10.0)],
                         attempted=8, failed=0, memory_peak_bytes=2 ** 32, count=1)
    ctx = SimpleNamespace(trace=False)
    names = runner.metrics_for(BENCH, "serve.rgb2depth.b8", False)
    line = runner.result_line(ctx, res, names, "NVIDIA H100 80GB HBM3")
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert line["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                              "memory_peak_bytes": 2 ** 32}
    assert line["metrics"]["clips_per_s"] == {"value": 7.5, "unit": "clips/s"}
    res.checks.append(core.Check("gap_max", 0.5, 0.25))
    assert runner.result_line(ctx, res, names, "x")["correct"] is False
    json.dumps(line)


def test_loaded_modules_are_checked_by_whole_top_level_name(monkeypatch):
    for name in ("egom2p_tpu_like", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert not {"egom2p_tpu", "jax", "flax"} & set(core.forbidden_modules())
    monkeypatch.setitem(sys.modules, "egom2p_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "optax", object())
    found = core.forbidden_modules()
    assert "egom2p_tpu" in found and "optax" in found


def test_harness_and_reference_import_no_forbidden_package():
    """The harness's own sources name none of the JAX packages, and the
    reference imports nothing of the port."""
    banned = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|egom2p_tpu)\b", re.M)
    port = re.compile(r"^\s*(import|from)\s+egom2p_torch\b", re.M)
    for root, _, files in os.walk(core.BENCH_DIR):
        for fn in files:
            if fn.endswith(".py"):
                src = open(os.path.join(root, fn)).read()
                assert not banned.search(src), fn
                if os.path.basename(root) == "reference":
                    assert not port.search(src), fn


@pytest.mark.parametrize("cell", sorted(w["name"] for w in BENCH["workloads"]))
def test_every_traffic_key_is_read_by_the_cells_driver(cell):
    """A cell's traffic holds only keys its driver reads; one more is refused."""
    import importlib
    ctx = runner.context(cell, 1, 1.0, False, None)
    driver = importlib.import_module(f"perfbench.drivers.{ctx.cell['driver']}")
    runner.check_traffic(ctx.traffic, driver)
    with pytest.raises(ValueError, match="in_flight"):
        runner.check_traffic(dict(ctx.traffic, in_flight=2), driver)
