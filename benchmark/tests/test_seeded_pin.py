"""What the harness makes from a seed stays what it was before the model
modules (``models/``) took over the model's leaves, inits, port state and
reference: the seeded weights (and SDT-BP's code bank), the inputs, the
reference's poses of the serving cells' inputs and SDT-BP's three reference
train steps.

Every value below was computed once, on the commit before the model modules,
by the same steps through that commit's ``generator_weights``,
``correct.reference_poses`` and ``correct.reference_steps``, on the CPU at one
thread. Each group is pinned by one sha256 over its tensors' bytes in order.
The weights and inputs are the seed's random draws, scaled, and are held to
their digests everywhere. The poses and steps are float32 sums, whose last
bits follow the CPU's vector paths and the torch build: they are held to
their digests on the CPU capability and torch version they were taken on
(``PINNED_ON``), and everywhere to their norm and eight values at fixed
places, within ``TOL`` of the norm. Summing in another order (four threads
against one) moves those by 1e-9 of the norm for the poses and 7e-8 for the
steps; a change of the math moves them far past ``TOL``."""

import hashlib

import pytest
import torch

from benchmark import drivers, tracing

SEED = 2 ** 33 + 17
PINNED_ON = ("AVX512", "2.13.0")  # torch.backends.cpu.get_cpu_capability(), torch version
TOL = 1e-5
DIGESTS = {
    "sdt_bp.serve_b128": {
        "weights": "07375887fe9cb89d8a36232c854cdc368e9012f60ae0b89ab0989dfb2254c9a5",
        "inputs": "f5f37960e6367c29038bea3e0c96f8aef50149245010eb2fcf21f413c2c35f6a",
        "poses": "260e080c1cce690e54160176e7d2290fddb6b90ff1b633dde0aaea231c4124f0"},
    "s2g_gan.serve_b128": {
        "weights": "df769b76595ecbf7fe6e73658fb3639ec1fedba0490a92cfa3bf9ab88b74e418",
        "inputs": "2f7240faeab4bb641e717030b64e07a0a9084e8be987c9af31639a535a3df4b8",
        "poses": "4df2b302d707722bc6a2485cd9de355b82a34c1500b5aef854f10d4bdefd3ffc"},
    "sdt_bp.train_b32_k8": {
        "weights": "07d5be764d23df65e1ce3178b5f8c2c868f67282dd0f79596d0a6c25a685119a",
        "inputs": "acefb5610a8dd5ae2ecc7efda97c354d59797d2a57ec316fa814aa76354b17a5",
        "steps": "181f2edf7f30fa199e2f6de8bbae2796c57f8a404fbebf790282a71315d28ccf"},
}
# the norm, then eight values at evenly spaced places of the flattened group
VALUES = {
    "sdt_bp.serve_b128": [
        33743.05336010429, -13.267637252807617, -81.09857177734375, 18.386093139648438,
        -188.93405151367188, -31.831424713134766, 207.4700927734375, -32.78336715698242,
        244.74267578125],
    "s2g_gan.serve_b128": [
        42190.74617127828, -39.93385314941406, -75.85022735595703, 4.222084045410156,
        -170.8965301513672, -39.17082595825195, 69.07880401611328, -131.24041748046875,
        150.4757537841797],
    "sdt_bp.train_b32_k8": [
        2.675974023713205, 0.030984580516815186, -2.1354329874156974e-05,
        0.0007745078182779253, -3.310169267933816e-05, -9.98377799987793e-06,
        -2.6702880859375e-05, 0.0002928720787167549, -0.00028620287775993347],
}


def digest(items) -> str:
    h = hashlib.sha256()
    for name, t in items:
        h.update(name.encode())
        h.update(t.detach().float().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def values(items) -> list:
    v = torch.cat([t.detach().double().flatten() for _, t in items])
    at = torch.linspace(0, v.numel() - 1, 8).round().long()
    return [float(v.norm())] + [float(x) for x in v[at]]


def holds(name: str, group: str, items) -> None:
    got, want = values(items), VALUES[name]
    assert max(abs(a - b) for a, b in zip(got, want)) <= TOL * want[0], (got, want)
    here = (torch.backends.cpu.get_cpu_capability(), torch.__version__.split("+")[0])
    if here == PINNED_ON:
        assert digest(items) == DIGESTS[name][group]


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("name", ["sdt_bp.serve_b128", "s2g_gan.serve_b128"])
def test_serving_weights_inputs_and_reference_poses(small_cell, one_thread, name):
    d = drivers.make(small_cell(name), SEED, "cpu", tracing.Spans())
    d.setup()
    inputs, poses = [], []
    for b, (audio, code) in enumerate(d.bufs):
        inputs.append((f"audio{b}", audio))
        if code is not None:
            inputs.append((f"code{b}", code))
        poses.append((f"poses{b}", d.mm.reference_poses(d.weights, audio, code, d.model,
                                                        d.stat())))
    assert digest(d.weights.items()) == DIGESTS[name]["weights"]
    assert digest(inputs) == DIGESTS[name]["inputs"]
    holds(name, "poses", poses)


def test_sdt_bp_reference_train_steps(small_cell, one_thread):
    name = "sdt_bp.train_b32_k8"
    d = drivers.make(small_cell(name), SEED, "cpu", tracing.Spans())
    d.setup()
    batches = []
    for rows in d.setup_rows[:3]:
        idx = torch.as_tensor(rows)
        batches.append({k: d.cache[k][idx] for k in ("audio", "poses", "clip_index")})
    ref = d.mm.reference_steps(d.weights, d.bank0, batches, d.model)
    losses = [(f"{i}.{k}", torch.tensor(v, dtype=torch.float64))
              for i, step in enumerate(ref["losses"]) for k, v in sorted(step.items())]
    steps = (losses + [("grad." + k, ref["grad"][k]) for k in sorted(ref["grad"])]
             + [("change." + k, ref["change"][k]) for k in sorted(ref["change"])])
    assert (digest(list(d.weights.items()) + [("clips_code", d.bank0)])
            == DIGESTS[name]["weights"])
    assert digest([(f"{i}.{k}", b[k]) for i, b in enumerate(batches)
                   for k in ("audio", "poses", "clip_index")]) == DIGESTS[name]["inputs"]
    holds(name, "steps", steps)
