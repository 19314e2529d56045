"""BENCHMARK.json against the benchmark's files, and the import guard."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_name_file_and_reader_exists():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + [
        w["name"] for w in BENCH["workloads"]] + [
        c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    for w in BENCH["workloads"]:
        wl = json.loads((ROOT / "portbench" / "workloads"
                         / f"{w['name']}.json").read_text())
        assert wl["config"] == w["config"] and wl["why"]
        assert (ROOT / "portbench" / "drivers"
                / f"{wl['driver']}.py").exists()
        assert (ROOT / "portbench" / "generators"
                / f"{wl['generator']}.py").exists()
    for m in BENCH["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
        e2e = [e for e in BENCH["end_to_end"] if e["name"] == m["moves"]]
        assert e2e and set(m["workloads"]) <= set(e2e[0].get(
            "workloads", m["workloads"]))


def test_import_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxfoo", object())
    monkeypatch.setitem(sys.modules, "exprgrad_tpu_like", object())
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert forbidden_modules() == ["jax"]


def test_nothing_the_benchmark_loads_imports_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.run, portbench.control, "
            "portbench.drivers.serve_open, portbench.drivers.train_steps, "
            "portbench.generators.open_loglen, "
            "portbench.generators.zipf_tokens; "
            "import exprgrad_torch.models; "
            "from portbench.harness import forbidden_modules; "
            "[portbench.run.reader(m) for m in %r]; "
            "print(forbidden_modules())") % (
        str(ROOT), [m["name"] for m in BENCH["per_layer"]])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card(tmp_path):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "mistral7b.chat", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
