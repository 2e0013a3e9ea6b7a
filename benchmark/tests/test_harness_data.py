"""The harness is driven by data: a new configuration, traffic mix and
per-layer metric are files and ``BENCHMARK.json`` entries alone, and so are a
new architecture (a model module and its reference) and a new traffic kind;
the contract's character sets are enforced; without a card the run prints no
result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# a toy architecture and traffic kind, laid out as the benchmark's folder
TOY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "toy")


def copy_benchmark(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    with open(tmp_path / "BENCHMARK.json") as f:
        return json.load(f)


def in_copy(tmp_path, code):
    """``code`` run in the copy: its ``benchmark`` first on the path, then the
    repository's root for the port."""
    head = f"import sys; sys.path.insert(0, '.'); sys.path.append({ROOT!r})\n"
    return subprocess.run([sys.executable, "-c", head + code],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120)


def files_of(folder):
    return {str(q): q.read_bytes() for q in folder.rglob("*") if q.is_file()}


def add_cell(spec, config, traffic, metric):
    """Entries for a new cell ``<config>.<traffic>``: it reports
    ``serve_pose_frames_per_s`` and the per-layer ``metric``."""
    name = f"{config}.{traffic}"
    spec["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1,
                              "why": "a test"})
    rate = next(m for m in spec["end_to_end"] if m["name"] == "serve_pose_frames_per_s")
    rate["workloads"].append(name)
    next(m for m in spec["per_layer"] if m["name"] == metric)["workloads"].append(name)
    return name


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


def test_new_architecture_and_kind_are_files_and_entries(tmp_path):
    """A toy architecture (``models/toy_mel_head.py`` with a leaf kind of its
    own, ``reference/toy_mel_head.py``) and a toy traffic kind
    (``kinds/toy_mel_serve.py``: the port's mel and the toy head) added to a
    copy of the benchmark as new files and entries: a run is ``correct``, the
    control is not, and no file that was there changed."""
    spec = copy_benchmark(tmp_path)
    b = tmp_path / "benchmark"
    before = files_of(b)
    for src, _, names in os.walk(TOY):
        for n in names:
            if n.endswith((".py", ".json")):
                dst = b / os.path.relpath(os.path.join(src, n), TOY)
                assert not dst.exists(), dst
                shutil.copy(os.path.join(src, n), dst)
    spec["configs"].append({"name": "toy_mel_head", "source": "a test", "reduced": [],
                            "file": "benchmark/configs/toy_mel_head.json", "why": "a test"})
    spec["per_layer"].append({"name": "toy.calls_per_s", "unit": "calls/s", "better": "higher",
                              "source": "host_clock", "layer": "toy forward",
                              "moves": "serve_pose_frames_per_s", "workloads": []})
    add_cell(spec, "toy_mel_head", "toy_b2", "toy.calls_per_s")
    json.dump(spec, open(tmp_path / "BENCHMARK.json", "w"))
    out = in_copy(tmp_path, """
import json
from benchmark import correct, drivers, run, spec, tracing
c = spec.cell(spec.load('.'), 'toy_mel_head.toy_b2')
r = run.run(c, 2 ** 33 + 21, 0.2, False, 'cpu')
d = drivers.make(c, 2 ** 33 + 23, 'cpu', tracing.Spans())
d.setup()
d.window(0.05, tracing.Window(False, 'cpu'))
gain = d.weights['proj.gain']
print(json.dumps({'correct': r['correct'], 'metrics': sorted(r['metrics']),
                  'checks': r['checks'], 'model': d.mm.__name__, 'kind': type(d).__module__,
                  'gain': [float(gain.min()), float(gain.max())],
                  'control': correct.judge(d.check(True), c['limits'])[0]}))
""")
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is True and got["control"] is False, got
    assert got["metrics"] == ["serve_pose_frames_per_s", "setup_s"], got
    assert got["model"] == "benchmark.models.toy_mel_head", got
    assert got["kind"] == "benchmark.kinds.toy_mel_serve", got
    assert 0.7 < got["gain"][0] < 1.0 < got["gain"][1] < 1.3, got  # the toy_gain init
    after = files_of(b)
    assert {p: after[p] for p in before} == before, "a file of the benchmark was edited"


@pytest.mark.parametrize("fault", [None, "kind", "model_module"])
def test_spec_refuses_an_unknown_kind_or_model_module(tmp_path, fault):
    """A cell whose traffic names a kind that is not a file, or whose configuration names a model module that is not a file, is
    refused by ``spec.load``; the same entries without the fault load."""
    spec = copy_benchmark(tmp_path)
    b = tmp_path / "benchmark"
    traffic = json.load(open(b / "traffic" / "serve_b128.json"))
    traffic["kind"] = "no_such_kind" if fault == "kind" else "serve"
    json.dump(traffic, open(b / "traffic" / "serve_b2.json", "w"))
    conf = json.load(open(b / "configs" / "sdt_bp.json"))
    conf["model_module"] = "no_such_model" if fault == "model_module" else "sequence_generator_cnn"
    json.dump(conf, open(b / "configs" / "sdt_bp_m.json", "w"))
    spec["configs"].append({"name": "sdt_bp_m", "source": "a copy", "reduced": [],
                            "file": "benchmark/configs/sdt_bp_m.json", "why": "a test"})
    name = add_cell(spec, "sdt_bp_m", "serve_b2", "serve.mfu")
    json.dump({"pose_err": 0.1}, open(b / "limits" / f"{name}.json", "w"))
    json.dump(spec, open(tmp_path / "BENCHMARK.json", "w"))
    out = in_copy(tmp_path, "from benchmark import spec\nspec.load('.')")
    if fault is None:
        assert out.returncode == 0, out.stderr[-1000:]
    else:
        assert out.returncode != 0 and "SpecError" in out.stderr, out.stderr[-1000:]
        assert {"kind": "no_such_kind", "model_module": "no_such_model"}[fault] in out.stderr


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
