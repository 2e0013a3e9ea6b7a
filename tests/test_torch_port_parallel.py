"""The port's ranks (``speechdrivestemplates_tpu_torch/parallel/dist.py``):
JAX's loader shards, the collectives over gloo ranks, the parallel keys, and
the one-process run untouched by them.

Multi-rank cases start their ranks with ``parallel.dist.spawn`` (fresh
interpreters, gloo on the CPU, a free port each launch, rendezvous failures
retried, a failure of the function never), each launch bounded by its own
timeout; the workers are this module's functions.
"""

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from speechdrivestemplates_tpu_torch.parallel import dist as pdist

ROOT = Path(__file__).resolve().parent.parent
RANK_TIMEOUT_S = 300


@pytest.fixture(scope="module", autouse=True)
def rank_threads():
    """Two intra-op threads a spawned rank (they inherit the variable) and in
    this process while the module runs: the test session runs several
    workers on the host's cores already."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with pytest.MonkeyPatch.context() as m:
            m.setenv("OMP_NUM_THREADS", "2")
            yield
    finally:
        torch.set_num_threads(threads)


def _spawn(fn, world, *args):
    return pdist.spawn(fn, world, args, device="cpu", timeout_s=RANK_TIMEOUT_S)


# ---- JAX's shards -------------------------------------------------------------------

@pytest.mark.parametrize("num_items,num_shards", [(10, 2), (35, 2), (35, 4), (9, 3), (4, 4)])
def test_shard_indices_are_the_jax_loaders(num_items, num_shards):
    """Each shard's rows over two epochs, train (shuffled, full batches) and
    eval (in order, the ragged batch kept), are JAX ``DataLoader(num_shards,
    shard_index)``'s; the shards are disjoint up to the head-repeat padding,
    cover every row and hold as many rows each."""
    from speechdrivestemplates_tpu.datasets.gesture_dataset import DataLoader
    from speechdrivestemplates_tpu_torch.datasets.gesture_dataset import (EpochBatches,
                                                                          shard_indices)

    items, per = list(range(num_items)), -(-num_items // num_shards)
    for epoch in (1, 2):
        shards = []
        for s in range(num_shards):
            jl = DataLoader(items, batch_size=2, shuffle=True, drop_last=True, seed=3,
                            num_shards=num_shards, shard_index=s)
            jl.set_epoch(epoch)
            port = EpochBatches(num_items, 2, 3, num_shards, s)
            port.set_epoch(epoch)
            assert [b.tolist() for b in port.index_batches()] == \
                [b.tolist() for b in jl.index_batches()]
            assert len(port) == len(jl)
            shards.append(shard_indices(num_items, num_shards, s, 3 + epoch))
            np.testing.assert_array_equal(shards[-1], jl._indices())
            je = DataLoader(items, batch_size=2, num_shards=num_shards, shard_index=s)
            np.testing.assert_array_equal(shard_indices(num_items, num_shards, s), je._indices())
        assert {len(x) for x in shards} == {per}
        rows = np.concatenate(shards)
        assert sorted(set(rows.tolist())) == items
        pad = per * num_shards - num_items
        # the padding repeats the shuffled order's head: those rows appear twice
        order = shard_indices(num_items, 1, 0, 3 + epoch)
        counts = np.bincount(rows, minlength=num_items)
        assert sorted(np.nonzero(counts == 2)[0].tolist()) == sorted(order[:pad].tolist())


@pytest.fixture(scope="module")
def speaker(tmp_path_factory):
    from speechdrivestemplates_tpu_torch.datasets.synthetic import make_synthetic_speaker

    root = str(tmp_path_factory.mktemp("par") / "speakers")
    make_synthetic_speaker(root, "oliver", num_train=10, num_dev=7, audio_length=16000,
                           num_frames=64)
    return root


@pytest.mark.parametrize("world", [2, 3])
def test_the_trainers_loaders_take_each_ranks_shard(monkeypatch, speaker, world):
    """``train_loader`` and ``eval_loader`` as rank r of ``world`` see: the
    per-rank batch TRAIN.BATCH_SIZE // world (TEST.BATCH_SIZE // world) of
    JAX's shard r (JAX ``trainer.py`` ``setup_dataset``)."""
    from speechdrivestemplates_tpu.datasets.gesture_dataset import DataLoader
    from speechdrivestemplates_tpu_torch.config import apply_overrides, pose2pose
    from speechdrivestemplates_tpu_torch.pipelines import trainer

    cfg = apply_overrides(pose2pose(), ["DATASET.ROOT_DIR", speaker, "SYS.NUM_WORKERS", "0",
                                        "TRAIN.BATCH_SIZE", "6", "TEST.BATCH_SIZE", "4"])
    monkeypatch.setattr(pdist, "distributed", lambda: True)
    monkeypatch.setattr(pdist, "world_size", lambda: world)
    for r in range(world):
        monkeypatch.setattr(pdist, "rank", lambda r=r: r)
        tl, el = trainer.train_loader(cfg), trainer.eval_loader(cfg)
        jt = DataLoader(list(range(10)), 6 // world, shuffle=True, drop_last=True, seed=0,
                        num_shards=world, shard_index=r)
        je = DataLoader(list(range(7)), 4 // world, num_shards=world, shard_index=r)
        for epoch in (1, 2):
            tl.batch_sampler.set_epoch(epoch)
            jt.set_epoch(epoch)
            assert [b["clip_index"].tolist() for b in tl] == \
                [b.tolist() for b in jt.index_batches()]
        assert [b["clip_index"].tolist() for b in el] == [b.tolist() for b in je.index_batches()]


def test_batches_smaller_than_the_ranks_are_refused(monkeypatch, speaker):
    from speechdrivestemplates_tpu_torch.config import apply_overrides, pose2pose
    from speechdrivestemplates_tpu_torch.pipelines import trainer

    cfg = apply_overrides(pose2pose(), ["DATASET.ROOT_DIR", speaker, "SYS.NUM_WORKERS", "0",
                                        "TRAIN.BATCH_SIZE", "2", "TEST.BATCH_SIZE", "2"])
    monkeypatch.setattr(pdist, "distributed", lambda: True)
    monkeypatch.setattr(pdist, "world_size", lambda: 3)
    monkeypatch.setattr(pdist, "rank", lambda: 0)
    with pytest.raises(ValueError, match="TRAIN.BATCH_SIZE 2 is less than the 3 ranks"):
        trainer.train_loader(cfg)
    with pytest.raises(ValueError, match="TEST.BATCH_SIZE 2 is less than the 3 ranks"):
        trainer.eval_loader(cfg)


# ---- the collectives over two gloo ranks --------------------------------------------

def _state_digest(state) -> str:
    h = hashlib.sha256()
    for k, v in sorted(state.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _collectives_worker(rank, device):
    """Every collective of ``parallel/dist.py`` on known inputs, and a BN
    layer and a seeded train state, on this rank."""
    from speechdrivestemplates_tpu_torch.config import s2g
    from speechdrivestemplates_tpu_torch.models.blocks import BatchNorm
    from speechdrivestemplates_tpu_torch.pipelines.voice2pose import Voice2PoseTrainState

    world = pdist.world_size()
    out = {"rank": pdist.rank(), "world": world, "master": pdist.is_master()}
    w = torch.arange(1.0, 4.0, dtype=torch.float64)
    x = torch.full((3,), float(rank + 1), dtype=torch.float64, requires_grad=True)
    y = pdist.all_reduce_sum(x * w)
    y.sum().backward()
    out.update(sum=y.detach(), sum_grad=x.grad)
    local = torch.from_numpy(np.random.RandomState(rank).randn(5, 4, 3))
    out["local"] = local
    out["var_mean"] = pdist.batch_var_mean(local, (0, 2), correction=1)
    out["mean_over_ranks"] = pdist.mean_over_ranks(local.mean())
    out["gathered"] = pdist.gather_rows(local)
    out["gathered_dim2"] = pdist.gather_rows(local, dim=2)
    g = torch.Generator().manual_seed(7)
    out["drawn"] = pdist.draw_rows(lambda n: torch.randn(n, 3, generator=g), 2)
    out["after_draw"] = torch.randn(2, generator=g)
    out["agree_one"] = pdist.agree(rank == world - 1)
    out["agree_none"] = pdist.agree(False)
    out["broadcast"] = pdist.broadcast_object({"from": rank})
    pdist.barrier()
    p = torch.nn.Parameter(torch.zeros(2, 2))
    q = torch.nn.Parameter(torch.zeros(3, dtype=torch.float64))
    p.grad, q.grad = torch.full((2, 2), float(rank)), torch.full((3,), 2.0 * rank,
                                                                 dtype=torch.float64)
    pdist.average_gradients([p, q, torch.nn.Parameter(torch.zeros(1))])
    out["avg_grads"] = (p.grad, q.grad)
    # a train-mode BN layer on this rank's rows, a loss of the global batch
    bn = BatchNorm(4).double()
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 2.0, 4))
        bn.bias.copy_(torch.linspace(-1.0, 1.0, 4))
    h = torch.from_numpy(np.random.RandomState(10 + rank).randn(3, 4, 6) * 2 + 1)
    yb = bn(h)
    loss = pdist.mean_over_ranks((yb ** 2 * torch.linspace(1, 2, 6, dtype=torch.float64)).mean())
    loss.backward()
    pdist.average_gradients(bn.parameters())
    out["bn"] = {"x": h, "y": yb.detach(), "loss": loss.detach(), "grad_w": bn.weight.grad,
                 "grad_b": bn.bias.grad, "running_mean": bn.running_mean.clone(),
                 "running_var": bn.running_var.clone()}
    out["state_digest"] = _state_digest(Voice2PoseTrainState(s2g(precision="fp32"), 8, "cpu"))
    return out


@pytest.fixture(scope="module")
def ranks():
    return _spawn(_collectives_worker, 2)


def test_ranks_know_their_place(ranks):
    assert [(r["rank"], r["world"], r["master"]) for r in ranks] == [(0, 2, True),
                                                                      (1, 2, False)]


def test_all_reduce_sum_sums_values_and_gradients(ranks):
    """Forward: the sum over ranks. Backward: each rank's gradient is the sum
    over ranks of the gradients flowing in (each rank backpropagates the same
    global loss), so d(sum y)/dx = world * w."""
    w = torch.arange(1.0, 4.0, dtype=torch.float64)
    for r in ranks:
        assert torch.equal(r["sum"], 3.0 * w)
        assert torch.equal(r["sum_grad"], 2.0 * w)


def test_global_batch_statistics_and_rows(ranks):
    full = torch.cat([r["local"] for r in ranks])
    var, mean = torch.var_mean(full, dim=(0, 2), correction=1)
    for r in ranks:
        v, m, n = r["var_mean"]
        assert n == full.shape[0] * full.shape[2]
        torch.testing.assert_close(v, var, rtol=1e-12, atol=0)
        torch.testing.assert_close(m, mean, rtol=1e-12, atol=1e-15)
        torch.testing.assert_close(r["mean_over_ranks"], full.mean(), rtol=1e-12, atol=0)
        assert torch.equal(r["gathered"], full)
        assert torch.equal(r["gathered_dim2"], torch.cat([q["local"] for q in ranks], dim=2))


def test_draws_for_the_global_batch_keep_the_generators_in_step(ranks):
    g = torch.Generator().manual_seed(7)
    whole = torch.randn(4, 3, generator=g)
    after = torch.randn(2, generator=g)
    for i, r in enumerate(ranks):
        assert torch.equal(r["drawn"], whole[2 * i:2 * i + 2])
        assert torch.equal(r["after_draw"], after)


def test_agree_broadcast_and_gradient_mean(ranks):
    for r in ranks:
        assert r["agree_one"] is True and r["agree_none"] is False
        assert r["broadcast"] == {"from": 0}
        assert torch.equal(r["avg_grads"][0], torch.full((2, 2), 0.5))
        assert torch.equal(r["avg_grads"][1], torch.full((3,), 1.0, dtype=torch.float64))


def test_batch_norm_takes_the_global_batch_with_its_gradient(ranks):
    """Two ranks' train-mode BN = one BN over both ranks' rows: the output,
    the running statistics (the global n / (n - 1)), and, after the mean over
    ranks of the gradients, the weight's and bias's gradient of the global
    loss (a factor of the world size off would show here)."""
    from speechdrivestemplates_tpu_torch.models.blocks import BatchNorm

    bn = BatchNorm(4).double()
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 2.0, 4))
        bn.bias.copy_(torch.linspace(-1.0, 1.0, 4))
    x = torch.cat([r["bn"]["x"] for r in ranks])
    y = bn(x)
    ((y ** 2 * torch.linspace(1, 2, 6, dtype=torch.float64)).mean()).backward()
    for i, r in enumerate(ranks):
        b = r["bn"]
        torch.testing.assert_close(b["y"], y[3 * i:3 * i + 3].detach(), rtol=1e-12, atol=1e-12)
        for k in ("running_mean", "running_var"):
            torch.testing.assert_close(b[k], getattr(bn, k), rtol=1e-12, atol=1e-14)
        torch.testing.assert_close(b["grad_w"], bn.weight.grad, rtol=1e-10, atol=1e-14)
        torch.testing.assert_close(b["grad_b"], bn.bias.grad, rtol=1e-10, atol=1e-14)


def test_every_rank_builds_the_same_seeded_state(ranks):
    """JAX ``replicate``/``device_init`` map to a seeded build on every rank:
    the states (s2g: generator, discriminator, pose encoder, optimizers'
    parameters) are equal bit for bit, so nothing is broadcast."""
    assert ranks[0]["state_digest"] == ranks[1]["state_digest"]


def test_a_failing_rank_is_reported_and_never_retried(monkeypatch):
    """A rank's exception comes back with its traceback; the others, left
    waiting in a collective, are ended; the launch is not made again."""
    launches = []
    once = pdist._spawn_once

    def counted(*a, **k):
        launches.append(a)
        return once(*a, **k)

    monkeypatch.setattr(pdist, "_spawn_once", counted)
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*rank 1 refuses"):
        _spawn(_fail_on_rank_1, 2)
    assert len(launches) == 1


def _fail_on_rank_1(rank, device):
    if rank == 1:
        raise ValueError("rank 1 refuses")
    pdist.barrier()  # left waiting: the parent ends it


# ---- the parallel keys ---------------------------------------------------------------

def test_the_parallel_keys_are_accepted_and_mapped():
    from speechdrivestemplates_tpu_torch.config import apply_overrides, load_config, sdt_bp

    cfg = load_config(None, ["SYS.DISTRIBUTED", "True", "SYS.WORLD_SIZE", "2",
                             "SYS.MASTER_ADDR", "10.0.0.2", "SYS.MASTER_PORT", "29500",
                             "SYS.MESH.DATA", "2", "DEMO.SEQUENCE_PARALLEL", "True"])
    assert (cfg.SYS.DISTRIBUTED, cfg.SYS.WORLD_SIZE, cfg.SYS.MESH.DATA) == (True, 2, 2)
    with pytest.raises(ValueError, match="SYS.MESH.DATA 4 with SYS.WORLD_SIZE 2.*the port.s is its ranks"):
        load_config(None, ["SYS.WORLD_SIZE", "2", "SYS.MESH.DATA", "4"])
    with pytest.raises(ValueError, match="SYS.WORLD_SIZE 0"):
        load_config(None, ["SYS.WORLD_SIZE", "0"])
    for data in ("-1", "0"):
        apply_overrides(sdt_bp(), ["SYS.WORLD_SIZE", "3", "SYS.MESH.DATA", data])


def test_one_rank_defaults_start_no_group_and_no_process(monkeypatch, speaker, tmp_path):
    """The default keys run ``main`` in this process with no process group:
    no spawn, no rendezvous, no collective."""
    import torch.distributed as tdist

    from speechdrivestemplates_tpu_torch import main

    def refuse(*a, **k):
        raise AssertionError("a one-rank run called torch.distributed")

    for name in ("init_process_group", "all_reduce", "broadcast", "barrier",
                 "broadcast_object_list", "all_gather"):
        monkeypatch.setattr(tdist, name, refuse)
    monkeypatch.setattr(pdist, "spawn", refuse)
    out = main.main(["--device", "cpu", "--config_file", str(ROOT / "configs" / "pose2pose.yaml"),
                     "DATASET.ROOT_DIR", speaker, "SYS.OUTPUT_DIR", str(tmp_path),
                     "TRAIN.NUM_EPOCHS", "1", "TRAIN.BATCH_SIZE", "4", "TRAIN.VALIDATE", "False",
                     "TRAIN.SAVE_VIDEO", "False", "SYS.NUM_WORKERS", "0"])
    assert out["steps"] == 2 and np.isfinite(out["losses"]["reg_loss"])
    assert not pdist.distributed()


# ---- the one-process step and eval: the arithmetic before the ranks ---------------------

def _bn_forward_before(self, x):
    """``BatchNorm.forward`` as it was before the ranks were ported."""
    from speechdrivestemplates_tpu_torch.models import blocks

    xf = x.to(blocks._stats_dtype(x))
    if self.training:
        dims = (0, *range(2, x.ndim))
        var, mean = torch.var_mean(xf, dim=dims, correction=0)
        n = xf.numel() // xf.shape[1]
        with torch.no_grad():
            m = 1.0 - blocks.BN_MOMENTUM
            self.running_mean.copy_(m * self.running_mean + blocks.BN_MOMENTUM * mean)
            self.running_var.copy_(m * self.running_var
                                   + blocks.BN_MOMENTUM * (var * (n / max(n - 1, 1))))
            self.num_batches_tracked += 1
    else:
        mean, var = self.running_mean, self.running_var
    shape = (-1,) + (1,) * (x.ndim - 2)
    y = (xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + blocks.NORM_EPS)
    return y * self.weight.view(shape) + self.bias.view(shape)


def _generator_losses_before(pred, gt, code, cfg, score_fake=None):
    """``voice2pose.generator_losses`` as it was before the ranks."""
    gcfg = cfg.VOICE2POSE.GENERATOR
    reg = (pred - gt).abs().mean() * gcfg.LAMBDA_REG
    losses = {"G_reg_loss": reg}
    g_loss = reg
    if code is not None:
        if code.ndim == 3:
            code = code.transpose(1, 2).reshape(-1, code.shape[1])
        mu, var = code.mean(0), code.var(0, correction=1)
        safe = torch.where(var > 0, var, torch.ones_like(var))
        kl = 0.5 * (-torch.log(safe) + mu ** 2 + var - 1.0).mean() * gcfg.LAMBDA_CLIP_KL
        kl = torch.where((var != 0).all(), kl, torch.zeros_like(kl))
        losses["G_clipcode_kl_loss"] = kl
        g_loss = g_loss + kl
    if score_fake is not None:
        gan = ((score_fake - 1.0) ** 2).mean() * cfg.VOICE2POSE.POSE_DISCRIMINATOR.LAMBDA_GAN
        losses["G_pose_gan_loss"] = gan
        g_loss = g_loss + gan
    losses["G_loss"] = g_loss
    return g_loss, losses


@pytest.mark.parametrize("preset", ["sdt_bp", "s2g"])
def test_one_process_step_and_eval_are_the_arithmetic_before_the_ranks(monkeypatch, speaker,
                                                                        preset):
    """Without a process group a train step (BN, the KL, the optimizers) and an
    evaluation are bit for bit what they were before the ranks were ported:
    the same run with the earlier BatchNorm, KL and no gradient mean put back
    ends with equal weights, statistics, losses and metrics, and neither run
    touches ``torch.distributed``."""
    import torch.distributed as tdist

    from speechdrivestemplates_tpu_torch import config as C
    from speechdrivestemplates_tpu_torch.models.blocks import BatchNorm
    from speechdrivestemplates_tpu_torch.pipelines import trainer, voice2pose

    def refuse(*a, **k):
        raise AssertionError("a one-process step called torch.distributed")

    for name in ("all_reduce", "broadcast", "barrier", "broadcast_object_list"):
        monkeypatch.setattr(tdist, name, refuse)
    cfg = C.apply_overrides(getattr(C, preset)(precision="fp32"), [
        "DATASET.ROOT_DIR", speaker, "SYS.NUM_WORKERS", "0", "TRAIN.BATCH_SIZE", "4",
        "TEST.BATCH_SIZE", "8", "TRAIN.LR", "1e-3"])

    def run():
        loader = trainer.train_loader(cfg)
        loader.batch_sampler.set_epoch(1)
        state = voice2pose.Voice2PoseTrainState(cfg, len(loader.dataset), "cpu")
        if state.clips_code is not None:  # an active KL from the first step
            with torch.no_grad():
                state.clips_code.copy_(torch.from_numpy(
                    np.random.RandomState(5).randn(*state.clips_code.shape).astype(np.float32)))
        losses = [voice2pose.train_step(state, next(iter(loader)))[0]]
        # one batch of 7; s2g's eval-mode BN reads running statistics alone
        metrics = trainer.evaluate(state, trainer.eval_loader(cfg)) if preset == "sdt_bp" else {}
        return state.state_dict(), losses, metrics

    now = run()
    with monkeypatch.context() as m:
        m.setattr(BatchNorm, "forward", _bn_forward_before)
        m.setattr(voice2pose, "generator_losses", _generator_losses_before)
        m.setattr(pdist, "average_gradients", lambda params: None)
        before = run()
    assert now[0].keys() == before[0].keys()
    for k in now[0]:
        assert torch.equal(now[0][k], before[0][k]), k
    a, b = now[1][0], before[1][0]
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    if preset == "sdt_bp":
        assert float(now[1][0]["G_clipcode_kl_loss"]) > 0
    assert now[2] == before[2]
