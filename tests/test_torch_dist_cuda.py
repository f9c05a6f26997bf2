"""The data-parallel step and the time-sharded decode on the card.

Marked ``cuda``: NCCL needs the card, so these tests skip on a host without
an NVIDIA GPU.  On one, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_dist_cuda.py -q

The machine holds one GPU and NCCL runs one rank a GPU, so the group has
one rank: it still issues every collective (the frame count's and the
gradient's all-reduce, inside the step's CUDA graph), and a sum over one
rank changes nothing, so the data-parallel step must equal the compiled
step of one process bit for bit.  The decode: ``sharded_decode`` on the
card against ``decode()`` (K8 and its traceback) at config 5.
"""
import contextlib

import numpy as np
import pytest
import torch

from asr_craft_tpu_torch import flagship
from asr_craft_tpu_torch.models.crf import decode
from asr_craft_tpu_torch.train import TrainConfig, Trainer, graphs
from asr_craft_tpu_torch.utils.logging import MetricsLogger

pytestmark = pytest.mark.cuda
B, T, STEPS = 16, 128, 8


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: NCCL has no CPU mode")
    import torch.distributed as dist
    from asr_craft_tpu_torch.parallel import initialize_distributed, make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    store = tmp_path_factory.mktemp("nccl") / "store"
    initialize_distributed(f"file://{store}", 1, 0, "cuda")
    try:
        yield make_mesh(1)
    finally:
        dist.destroy_process_group()


def _train(mesh, cfg, spc, eager, dp):
    params = cfg.init_params(torch.Generator().manual_seed(0), 0.01,
                             mesh.device)
    tr = Trainer(cfg, TrainConfig(lr=0.3, momentum=0.9), params=params,
                 logger=MetricsLogger(quiet=True), mesh=mesh if dp else None)
    batches = [flagship.tiny_batch(cfg, B, T, s, mesh.device)
               for s in range(STEPS)]
    with graphs.disabled() if eager else contextlib.nullcontext():
        if spc == 1:
            ms = [tr.train_step(b, 0.3) for b in batches]
            m = {k: torch.stack([x[k] for x in ms]) for k in ms[0]}
        else:
            tr.multi_step(batches, 0.3)
            m = tr.multi_step(batches, 0.3)
    return m, tr.params


@pytest.mark.parametrize("eager", [False, True], ids=["graph", "eager"])
@pytest.mark.parametrize("spc", [1, STEPS])
@pytest.mark.parametrize("name", ["flagship", "swbd"])
def test_one_rank_dp_step_equals_compiled_step(mesh, name, spc, eager):
    cfg = getattr(flagship, name)()
    m_dp, p_dp = _train(mesh, cfg, spc, eager, dp=True)
    m_1, p_1 = _train(mesh, cfg, spc, eager, dp=False)
    for k in ("loss", "grad_norm", "frames"):
        assert torch.equal(m_dp[k], m_1[k]), k
    torch.testing.assert_close(m_dp["mean_logZ"], m_1["mean_logZ"],
                               rtol=1e-6, atol=0.0)
    for k in p_1:
        assert torch.equal(p_dp[k], p_1[k]), k


def test_sharded_decode_on_the_card(mesh):
    from asr_craft_tpu_torch.ops.viterbi import path_score
    from asr_craft_tpu_torch.parallel.timeshard import sharded_decode
    cfg = flagship.swbd()
    params = cfg.init_params(torch.Generator().manual_seed(0), 0.1,
                             mesh.device)
    batch = flagship.tiny_batch(cfg, 4, 256, 0, mesh.device)
    lengths = torch.tensor([256, 200, 77, 5], dtype=torch.int32,
                           device=mesh.device)
    _, path, score = sharded_decode(cfg, params, batch["feats"], lengths, 8)
    assert path.device.type == "cuda"
    _, rpath, rscore = decode(cfg, params, batch["feats"], lengths)
    np.testing.assert_allclose(score.cpu(), rscore.cpu(), rtol=1e-5)
    same = (path == rpath).all(dim=1)
    if not bool(same.all()):                    # the near-tie rule
        from asr_craft_tpu_torch.models.crf import (apply_boundaries,
                                                    potentials)
        state, trans = potentials(cfg, params, batch["feats"])
        state = apply_boundaries(cfg, state, lengths)
        np.testing.assert_allclose(
            path_score(state, trans, path, lengths).cpu(),
            path_score(state, trans, rpath, lengths).cpu(), rtol=1e-5)
