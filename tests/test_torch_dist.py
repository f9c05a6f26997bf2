"""Data parallelism and the time-sharded decode over real ranks: gloo
processes on the CPU (``parallel.run_ranks``: spawned, a ``FileStore``
rendezvous under a temporary directory, so the tests' workers never race
for a port; every spawn with a timeout of its own).

- The 2-rank data-parallel loss and gradients against one process on the
  concatenated batch, mirroring tests/dist/test_multiprocess.py (loss rtol
  1e-6, gradients rtol 1e-5 / atol 1e-7, the two ranks' gradients bit-equal),
  with the loader's shards and with ranks of very different frame counts,
  where the mean of the ranks' means is wrong;
- an epoch where one rank's shard ends a batch early;
- ``assert_replicated`` passing on replicas and raising on a perturbed rank;
- the time-sharded decode's layout (ii), one chunk a rank, equal to layout
  (i);
- ``dryrun_multichip(2)`` and ``bench_scaling(check=True)`` at n = 1, 2,
  mirroring tests/dist/test_data_parallel.py's scaling check.
"""
import numpy as np
import pytest
import torch

from asr_craft_tpu_torch import bench, data, flagship
from asr_craft_tpu_torch.models.crf import CrfConfig, crf_loss
from asr_craft_tpu_torch.parallel import make_batch_put, make_mesh
from asr_craft_tpu_torch.parallel.mesh import run_ranks
from asr_craft_tpu_torch.train import TrainConfig, Trainer, make_train_step
from asr_craft_tpu_torch.utils import diagnostics
from asr_craft_tpu_torch.utils.logging import MetricsLogger

TIMEOUT = 120.0
CFG = dict(num_labels=4, feat_dim=4)


def _corpus(n):
    scfg = data.SyntheticConfig(num_labels=4, feat_dim=4, noise=0.3, seed=7,
                                min_len=12, max_len=24)
    return data.generate_corpus(scfg, n)[:2]


def _shard_batch(rank, kind, local_batch=2):
    """Rank ``rank``'s batch (numpy): its loader shard's first batch, or
    for ``unequal`` rank 0 two full rows and rank 1 rows of 3 and 5
    frames."""
    feats, labels = _corpus(4 * local_batch)
    loader = data.UtteranceLoader(feats, labels, data.LoaderConfig(
        batch_size=local_batch, buckets=(32,), shuffle=False, shard_id=rank,
        num_shards=2))
    batch = next(iter(loader.epoch_batches(0)))
    if kind == "unequal":
        batch["lengths"] = (np.array([32, 32], np.int32) if rank == 0 else
                            np.array([3, 5], np.int32))
    return {k: batch[k] for k in ("feats", "labels", "lengths")}


def _params(device="cpu"):
    cfg = CrfConfig(**CFG)
    return cfg, {k: v.requires_grad_(True) for k, v in cfg.init_params(
        torch.Generator().manual_seed(0), 0.1, device).items()}


def _dp_case(kind):
    """One rank: the data-parallel loss and gradient of its shard (the
    step's ``grad_step``), then one SGD step with the replicas checked."""
    mesh = make_mesh(2)
    cfg, params = _params()
    step, opt = make_train_step(cfg, TrainConfig(lr=0.2, momentum=0.9),
                                mesh=mesh)
    batch = make_batch_put(mesh)(_shard_batch(mesh.rank, kind))
    acc = {k: torch.zeros_like(v.detach()) for k, v in params.items()}
    _, m = step.grad_step(params, acc, batch)
    out = {"loss": float(m["loss"]), "frames": int(m["frames"]),
           **{f"grad_{k}": v.numpy().copy() for k, v in acc.items()}}
    step(params, opt.init(params), {}, batch, 0.2)
    diagnostics.assert_replicated(params)
    return out


def _uneven_epoch():
    """One rank of an epoch of 5 utterances, 2 a batch: rank 0 takes 2
    batches, rank 1 one and then an empty one."""
    mesh = make_mesh()
    feats, labels = _corpus(5)
    loader = data.UtteranceLoader(feats, labels, data.LoaderConfig(
        batch_size=2, buckets=(32,), shuffle=False, shard_id=mesh.rank,
        num_shards=2))
    tr = Trainer(CrfConfig(**CFG), TrainConfig(lr=0.1, prefetch=0),
                 logger=MetricsLogger(quiet=True), device="cpu", mesh=mesh)
    out = tr.train_epoch(loader)
    diagnostics.assert_replicated(tr.params)
    return {"steps": tr.step, "frames": out["frames"],
            "loss": out["mean_loss"]}


def _replicated_case():
    mesh = make_mesh()
    tree = {"w": torch.arange(6.0), "b": torch.ones(2, 3)}
    diagnostics.assert_replicated(tree)
    if mesh.rank == 1:
        tree["w"][4] += 0.5
    try:
        diagnostics.assert_replicated(tree)
    except AssertionError as exc:
        return str(exc)
    return None


def _timeshard_case():
    """Layout (ii) over the 2 ranks and layout (i) in each rank: logZ, the
    tropical score and the exact and pruned decodes."""
    from asr_craft_tpu_torch.parallel import timeshard as P
    rng = np.random.default_rng(3)
    state = torch.from_numpy(rng.normal(size=(3, 20, 6)).astype(np.float32))
    trans = torch.from_numpy(rng.normal(size=(6, 6)).astype(np.float32))
    lengths = torch.tensor([20, 7, 12])
    out = {}
    for layout, mesh in (("ii", P.time_mesh(distributed=True)),
                         ("i", P.time_mesh(2, "cpu"))):
        out[layout] = {
            "logZ": P.sharded_log_partition(state, trans, lengths, mesh),
            "best": P.sharded_log_partition(state, trans, lengths, mesh,
                                            "tropical"),
            "exact": P.sharded_viterbi(state, trans, lengths, mesh),
            "pruned": P.sharded_viterbi(state, trans, lengths, mesh,
                                        beam_labels=3)}
    return out


def _single(kind):
    """One process on the concatenated batch (rank 0's rows first)."""
    shards = [_shard_batch(r, kind) for r in range(2)]
    batch = {k: torch.from_numpy(np.concatenate([s[k] for s in shards]))
             for k in shards[0]}
    cfg, params = _params()
    loss, _ = crf_loss(cfg, params, batch["feats"], batch["labels"],
                       batch["lengths"])
    grads = torch.autograd.grad(loss, list(params.values()))
    means = []               # DistributedDataParallel's average of means
    for s in shards:
        lr, _ = crf_loss(cfg, params, *(torch.from_numpy(s[k]) for k in
                                        ("feats", "labels", "lengths")))
        means.append(torch.autograd.grad(lr, list(params.values())))
    ddp = {k: ((a + b) / 2).numpy() for k, a, b in zip(params, *means)}
    return (float(loss.detach()),
            {k: g.numpy() for k, g in zip(params, grads)}, ddp,
            int(batch["lengths"].sum()))


@pytest.mark.parametrize("kind", ["loader", "unequal"])
def test_two_rank_dp_matches_single_process(kind):
    ranks = run_ranks(_dp_case, 2, kind, device="cpu", timeout=TIMEOUT)
    loss, grads, ddp, frames = _single(kind)
    for got in ranks:
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-6, atol=1e-7)
        assert got["frames"] == frames
        for k, v in grads.items():
            np.testing.assert_allclose(got[f"grad_{k}"], v, rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    for k in grads:           # both ranks hold the same reduced gradient
        np.testing.assert_array_equal(ranks[0][f"grad_{k}"],
                                      ranks[1][f"grad_{k}"])
    if kind == "unequal":     # the case that catches a mean of means
        gap = max(float(np.abs(ddp[k] - grads[k]).max()) for k in grads)
        assert gap > 1e-3, gap


def test_epoch_with_a_shard_one_batch_short():
    ranks = run_ranks(_uneven_epoch, 2, device="cpu", timeout=TIMEOUT)
    feats, _ = _corpus(5)
    assert ranks[0] == ranks[1]
    assert ranks[0]["steps"] == 2
    assert ranks[0]["frames"] == sum(len(f) for f in feats)
    assert np.isfinite(ranks[0]["loss"])


def test_assert_replicated_over_two_ranks():
    msgs = run_ranks(_replicated_case, 2, device="cpu", timeout=TIMEOUT)
    for msg in msgs:            # each rank sees rank 1 diverge
        assert msg is not None and "diverges across ranks 0 vs 1" in msg
        assert "'w'" in msg and "0.5" in msg


def test_timeshard_layout_ii_equals_layout_i():
    for rank in run_ranks(_timeshard_case, 2, device="cpu",
                          timeout=TIMEOUT):
        for key in ("logZ", "best"):
            assert torch.equal(rank["ii"][key], rank["i"][key]), key
        for key in ("exact", "pruned"):
            for got, want in zip(rank["ii"][key], rank["i"][key]):
                assert torch.equal(got, want), key


def test_dryrun_multichip_two_ranks(capsys):
    loss = flagship.dryrun_multichip(2, device="cpu")
    assert np.isfinite(loss)
    assert "dryrun_multichip(2): loss=" in capsys.readouterr().out


def test_scaling_check_two_ranks():
    rows = bench.bench_scaling(per_device_batch=2, T=32, steps=3, check=True,
                               device="cpu", ranks=2)
    assert rows["check_ok"] is True and rows["device"] == "cpu"
    for n in (1, 2):
        assert rows[n]["check"]["ok"], rows[n]
        assert rows[n]["audio_s_per_s"] > 0 and rows[n]["ms_per_step"] > 0
    assert rows[1]["efficiency"] == 1.0
    assert rows[1]["check"]["loss_rel"] == rows[1]["check"][
        "grad_max_rel"] == 0.0                    # one rank: bit for bit


def test_run_ranks_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match=r"ranks \[(0, )?1\] of 2 failed \(exit codes \[(1, )?1\]\)"):
        run_ranks(_fail_on_rank_1, 2, device="cpu", timeout=TIMEOUT)


def _fail_on_rank_1():
    if make_mesh().rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return 0
