"""The harness finds every configuration, cell, traffic mix, driver, limit
file and per-layer reader by its name; a new cell and metric are files
and entries only; the result line's shape; nothing it runs imports JAX;
and a run without a card fails instead of falling back to the CPU."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import types

import pytest

from port_bench import run as bench_run
from port_bench.harness import HERE, ROOT, Check, Result

FORBIDDEN = {"jax", "jaxlib", "flax", "lichtfeld_studio_tpu"}


def test_every_name_in_benchmark_json_has_its_files():
    spec = bench_run.bench()
    for cell in spec["workloads"]:
        ctx = bench_run.cell_context(cell["name"], 1, 1.0, False, spec)
        assert ctx.config["name"] == cell["config"]
        assert hasattr(bench_run.driver(ctx), "run")
    for m in spec["per_layer"]:
        reader = bench_run.load_module(HERE / "metrics" / f"{m['name']}.py", "r_" + m["name"])
        assert reader.read({}) is None  # nothing to read: the metric is left out


def test_a_throwaway_cell_and_metric_are_new_files_and_entries(tmp_path):
    for d in ("traffic", "limits", "drivers", "metrics"):
        (tmp_path / d).mkdir()
    (tmp_path / "traffic" / "probe.json").write_text(json.dumps({"driver": "probe", "params": {"k": 3}}))
    (tmp_path / "limits" / "garden4-mcmc.probe.json").write_text(json.dumps({"gap": 0.5}))
    (tmp_path / "drivers" / "probe.py").write_text(
        "from port_bench.harness import Check, Result\n"
        "def run(ctx):\n"
        "    ctx.start_window()\n"
        "    return Result(metrics={'probe_s': 1.5 * ctx.traffic['params']['k']}, attempted=3,\n"
        "                  failed=0, memory_peak_bytes=7, checks=[Check('gap', 0.25, ctx.limits['gap'])],\n"
        "                  readings={'k': ctx.traffic['params']['k']})\n")
    (tmp_path / "metrics" / "probe_k.probe.py").write_text("def read(rec):\n    return rec.get('k')\n")
    spec = bench_run.bench()
    spec["workloads"].append({"name": "garden4-mcmc.probe", "config": "garden4-mcmc",
                              "traffic": "probe", "chips": 1, "why": "a throwaway cell"})
    spec["end_to_end"].append({"name": "probe_s", "unit": "s", "better": "lower", "bound": 0.1,
                               "source": "host_clock", "workloads": ["garden4-mcmc.probe"]})
    spec["per_layer"].append({"name": "probe_k.probe", "unit": "count", "better": "lower",
                              "source": "program_counter", "layer": "probe", "moves": "probe_s",
                              "workloads": ["garden4-mcmc.probe"]})
    for trace in (False, True):
        ctx = bench_run.cell_context("garden4-mcmc.probe", 1, 1.0, trace, spec, base=tmp_path)
        res = bench_run.driver(ctx).run(ctx)
        res.trace = {"breakdown": {"device_ops": [], "idle_gaps": []}}
        line = bench_run.result_line(spec, ctx, res, 2.0, {"platform": "gpu"})
        assert line["correct"]
        if trace:
            assert line["metrics"] == {"probe_k.probe": {"value": 3, "unit": "count"}}
        else:
            assert set(line["metrics"]) == {"probe_s", "peak_mem_gib", "setup_s"}
            assert line["metrics"]["probe_s"]["value"] == 4.5


def test_the_result_line_has_the_contract_keys_and_checks_last():
    spec = bench_run.bench()
    ctx = bench_run.cell_context("garden4-mcmc.train", 1, 1.0, False, spec)
    res = Result(metrics={"train_it_s": 20.0, "peak_mem_gib": 4.0}, attempted=400, failed=0,
                 memory_peak_bytes=4 << 30,
                 checks=[Check("loss_gap", 1e-7, 1e-4), Check("grad_diff", 2.0, 1.0)])
    line = bench_run.result_line(spec, ctx, res, 30.0, {"platform": "gpu", "kind": "x",
                                                       "count": 1, "memory_peak_bytes": 4 << 30})
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is False  # one number over its limit
    assert set(line["metrics"]) == {"train_it_s", "peak_mem_gib", "setup_s"}
    assert json.loads(json.dumps(line)) == line


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("part", ["", "reference", "scene", "work", "drivers", "metrics"])
def test_no_jax_and_a_reference_free_of_the_program(part):
    files = sorted((HERE / part).glob("*.py")) if part else sorted(HERE.glob("*.py"))
    assert files
    for f in files:
        tops = {name.split(".")[0] for name in _imports(f)}
        assert not tops & FORBIDDEN, f
        if part in ("reference", "scene", "work"):
            assert "lichtfeld_studio_tpu_torch" not in tops, f


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "lichtfeld_studio_tpu_torch_probe", types.ModuleType("x"))
    assert "lichtfeld_studio_tpu" not in bench_run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.probe", types.ModuleType("jaxlib.probe"))
    assert "jaxlib" in bench_run.forbidden_modules()


def test_a_run_without_a_card_fails_and_prints_no_result():
    p = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", "garden4-mcmc.train",
                        "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                            "HOME": str(ROOT / "build"), **{k: v for k, v in __import__("os").environ.items()
                                                             if k in ("PYTHONPATH", "LD_LIBRARY_PATH")}})
    assert p.returncode != 0
    assert "torch.cuda.is_available() is false" in p.stderr
    assert not p.stdout.strip()
