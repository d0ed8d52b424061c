"""The harness finds what a later change adds as files and entries only, and
prints the contract's result."""

import json
import os
import subprocess
import sys

from benchmark.tests.conftest import ROOT
from benchmark.tests.tiny import load, run_cell, save, tiny_root

CELLS = ("lgd_rnn6.train.b64w256", "birnn6.train.b64w256", "lgd_rnn6.infer.s64c256",
         "lgd_rnn6.serve.live_c16")


def test_added_cell_config_traffic_and_metric_are_found(tmp_path):
    root = tiny_root(tmp_path)
    bench = os.path.join(root, "benchmark")
    cfg = load(os.path.join(bench, "configs", "lgd_rnn6.json"))
    cfg["name"] = "lgd_rnn6_n3"
    cfg["flags"]["m_num_iterations"] = 3
    save(os.path.join(bench, "configs", "lgd_rnn6_n3.json"), cfg)
    save(os.path.join(bench, "traffic", "train_b2w4.json"),
         {"driver": "train", "batch": 2, "window": 4, "pool": 3, "warmup": 1, "trace_seconds": 0.1})
    with open(os.path.join(bench, "metrics", "steps_traced.train.py"), "w") as f:
        f.write("def read(run):\n    return float(run.calls_traced) or None\n")
    cell = "lgd_rnn6_n3.train.b2w4"
    save(os.path.join(bench, "limits", cell + ".json"),
         load(os.path.join(bench, "limits", "lgd_rnn6.train.b64w256.json")))
    spec = load(os.path.join(root, "BENCHMARK.json"))
    spec["configs"].append({"name": "lgd_rnn6_n3", "source": "https://example.org",
                            "file": "benchmark/configs/lgd_rnn6_n3.json",
                            "reduced": ["m_num_iterations"], "why": "a test"})
    spec["workloads"].append({"name": cell, "config": "lgd_rnn6_n3", "traffic": "train_b2w4",
                              "chips": 1, "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "lgd_rnn6.train.b64w256" in m.get("workloads", ()):
            m["workloads"].append(cell)
    spec["per_layer"].append({"name": "steps_traced.train", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "training",
                              "moves": "train_frames_per_s", "workloads": [cell]})
    save(os.path.join(root, "BENCHMARK.json"), spec)
    plain = run_cell(root, cell)
    assert plain["correct"]
    assert set(plain["metrics"]) == {"train_frames_per_s", "peak_mem_gib", "setup_s"}
    traced = run_cell(root, cell, trace=True)
    assert traced["metrics"]["steps_traced.train"]["value"] >= 1
    assert {"train.step_ms_p50.train", "mfu.train"} <= set(traced["metrics"])


def test_result_keys_and_compared_last(tmp_path):
    root = tiny_root(tmp_path)
    for cell in CELLS:
        res = run_cell(root, cell)
        assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"], cell
        assert list(res)[-1] == "compared", cell
        assert res["correct"], (cell, res["compared"])
        assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
        spec = load(os.path.join(root, "BENCHMARK.json"))
        want = {m["name"] for m in spec["end_to_end"] if cell in m.get("workloads", [cell])}
        assert set(res["metrics"]) == want, cell
        for item in res["compared"].values():
            assert set(item) == {"value", "limit"}


def test_traced_result_has_device_window_and_breakdown(tmp_path):
    root = tiny_root(tmp_path)
    res = run_cell(root, "lgd_rnn6.infer.s64c256", trace=True)
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "serve.step_ms_p50.infer" in res["metrics"]
    # the CPU traces no device: no share of a roofline or of the device is read
    assert "lstm_stack_roofline.infer" not in res["metrics"]
    assert "device_idle.infer" not in res["metrics"]


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    args = ["--workload", CELLS[0], "--seed", "3", "--seconds", "1", "--trace", "0"]
    out = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"), *args],
                         capture_output=True, text=True, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    root = tiny_root(tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=root,
                         capture_output=True, text=True, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_json_names_existing_files():
    spec = load(os.path.join(ROOT, "BENCHMARK.json"))
    for c in spec["configs"]:
        cfg = load(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and os.path.exists(os.path.join(ROOT, cfg["reference"]))
    for w in spec["workloads"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(ROOT, "benchmark", "limits", w["name"] + ".json"))
    for m in spec["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))
    json.dumps(spec)


def test_benchmark_json_keeps_the_format():
    import re
    spec = load(os.path.join(ROOT, "BENCHMARK.json"))
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    for section, allowed in keys.items():
        names = [e["name"] for e in spec[section]]
        assert len(names) == len(set(names)), section
        for e in spec[section]:
            assert set(e) <= allowed and name.match(e["name"]), e
            for text in ("why", "layer", "source"):
                assert text not in e or 1 <= len(e[text]) <= 200 and "\n" not in e[text], e
            if "unit" in e:
                assert unit.match(e["unit"]) and e["better"] in ("lower", "higher"), e
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
    for w in spec["workloads"]:
        assert w["chips"] == 1 and name.match(w["traffic"])
        reported = [m for m in spec["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert {"setup_s"} < {m["name"] for m in reported}
        assert any(w["name"] in m["workloads"] for m in spec["per_layer"])
