"""The harness is driven by data: a new configuration, traffic mix and
per-layer metric are files and ``BENCHMARK.json`` entries alone; the contract's
character sets are enforced; without a card the run prints no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def copy_benchmark(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    with open(tmp_path / "BENCHMARK.json") as f:
        return json.load(f)


def in_copy(tmp_path, code):
    return subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, '.')\n" + code],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120)


def test_new_config_traffic_and_metric_are_files_and_entries(tmp_path):
    spec = copy_benchmark(tmp_path)
    before = {p: open(p, "rb").read() for p in
              (str(q) for q in (tmp_path / "benchmark").rglob("*") if q.is_file())}
    b = tmp_path / "benchmark"
    conf = json.load(open(b / "configs" / "sdt_bp.json"))
    conf["name"] = "sdt_bp_b"
    json.dump(conf, open(b / "configs" / "sdt_bp_b.json", "w"))
    traffic = json.load(open(b / "traffic" / "serve_b128.json"))
    traffic["batch"] = 64
    json.dump(traffic, open(b / "traffic" / "serve_b64.json", "w"))
    json.dump({"pose_err": 0.1, "worst_clip_pose_err": 0.1},
              open(b / "limits" / "sdt_bp_b.serve_b64.json", "w"))
    (b / "layer_metrics" / "serve.calls_per_s.py").write_text(
        "def read(ctx):\n    return ctx['work']['calls'] / ctx['window_s']\n")
    spec["configs"].append({"name": "sdt_bp_b", "source": "a copy", "reduced": [],
                            "file": "benchmark/configs/sdt_bp_b.json", "why": "a test"})
    spec["workloads"].append({"name": "sdt_bp_b.serve_b64", "config": "sdt_bp_b",
                              "traffic": "serve_b64", "chips": 1, "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("sdt_bp_b.serve_b64")
    spec["per_layer"].append({"name": "serve.calls_per_s", "unit": "calls/s",
                              "better": "higher", "source": "host_clock",
                              "layer": "serving forward", "moves": "serve_pose_frames_per_s",
                              "workloads": ["sdt_bp_b.serve_b64"]})
    json.dump(spec, open(tmp_path / "BENCHMARK.json", "w"))
    out = in_copy(tmp_path, """
from benchmark import spec, run
c = spec.cell(spec.load('.'), 'sdt_bp_b.serve_b64')
ctx = {'work': {'calls': 10}, 'window_s': 2.0}
print(c['traffic_file']['batch'], c['config_file']['name'], [m['name'] for m in c['per_layer']],
      run.read_layer_metrics(c, ctx))
""")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[0] == ("64 sdt_bp_b ['serve.calls_per_s'] "
                                         "{'serve.calls_per_s': {'value': 5.0, 'unit': 'calls/s'}}")
    for path, data in before.items():
        assert open(path, "rb").read() == data, f"{path} was edited"


@pytest.mark.parametrize("where,key,value", [
    ("workloads", "name", "sdt bp.serve"), ("workloads", "name", "a,b"),
    ("workloads", "name", "x/y"), ("per_layer", "unit", "tokens per second"),
    ("per_layer", "unit", "µs"), ("end_to_end", "name", "été"),
    ("end_to_end", "bound", 0.3), ("per_layer", "better", "faster"),
    ("workloads", "chips", 2), ("per_layer", "source", "guess"),
    ("workloads", "why", "two\nlines")])
def test_the_contract_refuses(tmp_path, where, key, value):
    spec = copy_benchmark(tmp_path)
    spec[where][0][key] = value
    json.dump(spec, open(tmp_path / "BENCHMARK.json", "w"))
    out = in_copy(tmp_path, "from benchmark import spec\nspec.load('.')")
    assert out.returncode != 0 and "SpecError" in out.stderr, out.stderr[-1000:]


def test_the_committed_spec_holds():
    sys.path.insert(0, ROOT)
    from benchmark import spec

    s = spec.load(ROOT)
    assert [w["name"] for w in s["workloads"]] == [
        "sdt_bp.serve_b128", "sdt_bp.train_b32_k8", "s2g_gan.serve_b128"]
    assert all(w["chips"] == 1 for w in s["workloads"])


def test_without_a_card_no_result(tmp_path):
    """Run as the driver runs it, in a directory of BENCHMARK.json and the
    benchmark's folder alone: a non-zero exit, nothing on standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    copy_benchmark(tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sdt_bp.serve_b128",
                          "--seed", str(2 ** 33 + 3), "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == "", (out.returncode, out.stdout)


@pytest.mark.gpu
def test_a_cell_runs_on_the_card(card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sdt_bp.serve_b128",
                          "--seed", str(2 ** 33 + 5), "--seconds", "2", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", line
    assert "serve.stem_roofline" in line["metrics"] and line["breakdown"]["device_ops"]
