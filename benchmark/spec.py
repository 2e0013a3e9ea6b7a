"""``BENCHMARK.json``: its contract checked, and each name found as a file.

A configuration is ``configs/<config>.json``, whose model is
``models/<model_module>.py`` (``sequence_generator_cnn`` where the file names
none), a traffic mix ``traffic/<traffic>.json`` (the parameters of a kind,
``kinds/<kind>.py``), a per-layer metric ``layer_metrics/<metric>.py`` (a
reader, ``read(ctx)``), and the limits of a cell's correctness check
``limits/<cell>.json``, all beside this file. A new cell, mix, kind,
configuration, model or metric is new files and entries only.
"""

import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}\Z")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
DEFAULT_MODEL = "sequence_generator_cnn"


class SpecError(ValueError):
    """``BENCHMARK.json`` breaks the contract."""


def _need(ok: bool, what: str) -> None:
    if not ok:
        raise SpecError(what)


def _text(value, what: str) -> None:
    _need(isinstance(value, str) and 1 <= len(value) <= 200 and "\n" not in value
          and "\t" not in value and "\r" not in value, f"{what}: 1-200 characters on one line")


def _name(value, what: str) -> None:
    _need(isinstance(value, str) and NAME.match(value) is not None,
          f"{what} {value!r}: a name of letters, digits, '_', '.', '-' (at most 64)")


def _keys(entry: dict, keys: set, what: str, optional=("workloads",)) -> None:
    extra = set(entry) - keys - set(optional)
    _need(isinstance(entry, dict) and keys <= set(entry) and not extra,
          f"{what}: keys {sorted(keys)} (and {list(optional)}), got {sorted(entry)}")


def validate(spec: dict, root: str) -> None:
    """Raise ``SpecError`` where ``spec`` breaks the contract or names a file
    that is not there."""
    _need(set(spec) == TOP, f"top-level keys must be {sorted(TOP)}, got {sorted(spec)}")
    cmd, paths = spec["command"], spec["paths"]
    _need(isinstance(cmd, list) and 1 <= len(cmd) <= 32, "command: 1-32 strings")
    for word in cmd:
        _text(word, "command word")
        _need(not word.startswith("/") and ".." not in word.split("/"),
              f"command word {word!r} leaves the repository")
    _need(isinstance(paths, list) and 1 <= len(paths) <= 16, "paths: 1-16 directories")
    for p in paths:
        _need(isinstance(p, str) and PATH.match(p) is not None and not p.startswith("/")
              and ".." not in p.split("/"), f"path {p!r}")
    rs = spec["run_seconds"]
    _need(isinstance(rs, int) and not isinstance(rs, bool) and 1 <= rs <= 51,
          "run_seconds: a whole number from 1 to 51")

    configs = spec["configs"]
    _need(isinstance(configs, list) and 1 <= len(configs) <= 24, "configs: 1-24 entries")
    files = set()
    for c in configs:
        _keys(c, CONFIG_KEYS, f"config {c.get('name')}", optional=())
        _name(c["name"], "config name")
        _text(c["source"], f"config {c['name']} source")
        _text(c["why"], f"config {c['name']} why")
        _need(any(c["file"].startswith(p.rstrip("/") + "/") for p in paths),
              f"config {c['name']}: file {c['file']!r} is not under paths")
        _need(c["file"] not in files, f"config {c['name']}: file shared with another")
        files.add(c["file"])
        _need(os.path.isfile(os.path.join(root, c["file"])), f"config file {c['file']} missing")
        with open(os.path.join(root, c["file"])) as f:
            module = model_name(json.load(f))
        _need(isinstance(module, str) and module.isidentifier()
              and os.path.isfile(model_path(module)),
              f"config {c['name']}: model module {module!r} is not a file models/<name>.py")
        _need(isinstance(c["reduced"], list) and len(c["reduced"]) <= 16,
              f"config {c['name']}: reduced has at most 16 keys")
        for k in c["reduced"]:
            _name(k, f"config {c['name']} reduced key")
    config_names = [c["name"] for c in configs]

    cells = spec["workloads"]
    _need(isinstance(cells, list) and 1 <= len(cells) <= 24, "workloads: 1-24 cells")
    pairs = set()
    for w in cells:
        _keys(w, CELL_KEYS, f"cell {w.get('name')}", optional=())
        for k in ("name", "config", "traffic"):
            _name(w[k], f"cell {k}")
        _text(w["why"], f"cell {w['name']} why")
        _need(w["config"] in config_names, f"cell {w['name']}: unknown config {w['config']}")
        _need(w["chips"] in (1, 4), f"cell {w['name']}: chips is 1 or 4")
        _need((w["config"], w["traffic"]) not in pairs,
              f"cell {w['name']}: configuration and traffic already paired")
        pairs.add((w["config"], w["traffic"]))
        _need(os.path.isfile(traffic_path(w["traffic"])), f"traffic file of {w['traffic']} missing")
        with open(traffic_path(w["traffic"])) as f:
            kind = json.load(f).get("kind")
        _need(isinstance(kind, str) and kind.isidentifier() and os.path.isfile(kind_path(kind)),
              f"traffic {w['traffic']}: kind {kind!r} is not a file kinds/<kind>.py")
        _need(os.path.isfile(limits_path(w["name"])), f"limits file of {w['name']} missing")
    _need(sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4),
          "too many four-chip cells")
    _need(all(any(w["config"] == c for w in cells) for c in config_names),
          "every configuration is used by a cell")
    cell_names = [w["name"] for w in cells]

    e2e, layer = spec["end_to_end"], spec["per_layer"]
    _need(isinstance(e2e, list) and 1 <= len(e2e) <= 16, "end_to_end: 1-16 metrics")
    _need(isinstance(layer, list) and 1 <= len(layer) <= 128, "per_layer: 1-128 metrics")
    for m in e2e:
        _keys(m, E2E_KEYS, f"metric {m.get('name')}")
        _need(m["source"] in ("host_clock", "device_trace"),
              f"{m['name']}: an end-to-end metric comes from host_clock or device_trace")
        _need(isinstance(m["bound"], (int, float)) and 0 < m["bound"] <= 0.25,
              f"{m['name']}: bound in (0, 0.25]")
    for m in layer:
        _keys(m, LAYER_KEYS, f"metric {m.get('name')}")
        _text(m["layer"], f"{m['name']} layer")
        _need(m["source"] in SOURCES, f"{m['name']}: source one of {sorted(SOURCES)}")
        _need(m["moves"] in [x["name"] for x in e2e], f"{m['name']}: moves no end-to-end metric")
        _need(os.path.isfile(metric_path(m["name"])), f"reader of {m['name']} missing")
    for m in e2e + layer:
        _name(m["name"], "metric name")
        _need(isinstance(m["unit"], str) and UNIT.match(m["unit"]) is not None,
              f"{m['name']}: unit {m.get('unit')!r}")
        _need(m["better"] in ("lower", "higher"), f"{m['name']}: better is lower or higher")
        for w in m.get("workloads", []):
            _need(w in cell_names, f"{m['name']}: unknown cell {w}")
    names = config_names + cell_names + [m["name"] for m in e2e + layer]
    _need(len(set(config_names)) == len(config_names) and len(set(cell_names)) == len(cell_names)
          and len({m["name"] for m in e2e + layer}) == len(e2e) + len(layer), "a name repeats")
    _need(all(isinstance(n, str) for n in names), "names are strings")
    _need("setup_s" in [m["name"] for m in e2e], "end_to_end has setup_s")
    for w in cell_names:
        mine = [m["name"] for m in e2e if w in m.get("workloads", cell_names)]
        _need("setup_s" in mine and len(mine) >= 2,
              f"cell {w}: reports setup_s and another end-to-end metric")
        _need(any(w in m.get("workloads", cell_names) for m in layer),
              f"cell {w}: reports a per-layer metric")
        for m in layer:
            if w in m.get("workloads", cell_names):
                _need(m["moves"] in mine, f"cell {w}: {m['name']} moves {m['moves']}, "
                                          "which the cell does not report")


def traffic_path(name: str) -> str:
    return os.path.join(HERE, "traffic", f"{name}.json")


def limits_path(cell: str) -> str:
    return os.path.join(HERE, "limits", f"{cell}.json")


def metric_path(name: str) -> str:
    return os.path.join(HERE, "layer_metrics", f"{name}.py")


def kind_path(kind: str) -> str:
    return os.path.join(HERE, "kinds", f"{kind}.py")


def model_path(module: str) -> str:
    return os.path.join(HERE, "models", f"{module}.py")


def model_name(conf: dict) -> str:
    """The model module a configuration file names, or the default."""
    return conf.get("model_module", DEFAULT_MODEL)


def load(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    validate(spec, root)
    return spec


def cell(spec: dict, name: str) -> dict:
    """The cell ``name`` with its configuration, traffic, limits and metrics."""
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise SpecError(f"no cell {name!r}; cells: {[w['name'] for w in spec['workloads']]}")
    w = dict(found[0])
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    with open(os.path.join(os.path.dirname(HERE), conf["file"])) as f:
        w["config_file"] = json.load(f)
    with open(traffic_path(w["traffic"])) as f:
        w["traffic_file"] = json.load(f)
    with open(limits_path(name)) as f:
        w["limits"] = json.load(f)
    names = [x["name"] for x in spec["workloads"]]
    w["end_to_end"] = [m for m in spec["end_to_end"] if name in m.get("workloads", names)]
    w["per_layer"] = [m for m in spec["per_layer"] if name in m.get("workloads", names)]
    return w
