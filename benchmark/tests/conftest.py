"""Fixtures of the benchmark's tests: small cells on the CPU, and the card
decided inside a fixture (never while a module is imported)."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL = {"serve": dict(batch=2, buffers=2, keep=3),
         "train_cache": dict(batch=4, clips=16, steps_per_dispatch=2),
         "demo": dict(pool=2, min_s=2.0, max_s=4.0, keep=3)}
# cells whose traffic, limits and readers are kept but that BENCHMARK.json does
# not run (PERF.md, Open questions): their checks are still tested here
DORMANT = [{"name": "sdt_bp.demo_b1", "config": "sdt_bp", "traffic": "demo_b1", "chips": 1}]


@pytest.fixture(scope="session")
def bench_spec():
    from benchmark import spec

    loaded = spec.load(ROOT)
    return dict(loaded, workloads=loaded["workloads"] + DORMANT)


@pytest.fixture
def small_cell(bench_spec):
    """``small_cell(name, precision=None)``: the cell with its traffic cut to a
    size the CPU runs in seconds (every width kept)."""
    from benchmark import spec

    def make(name, precision=None):
        cell = copy.deepcopy(spec.cell(bench_spec, name))
        cell["traffic_file"].update(SMALL[cell["traffic_file"]["kind"]])
        if precision:
            cell["config_file"]["port_config"]["opts"] += ["TRAIN.PRECISION", precision]
            cell["config_file"]["model"]["precision"] = precision
        return cell

    return make


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
