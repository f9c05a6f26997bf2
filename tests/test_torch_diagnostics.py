"""The port's observability utilities
(``asr_craft_tpu_torch.utils.diagnostics``): the cases of
``tests/unit/test_diagnostics.py`` for the PyTorch twins, and ``--debug_nans``
through both packages' train CLIs on the same poisoned weight file: each
raises ``FloatingPointError``, and each runs to its end without the flag.
"""
import json
import os
import socket

import jax
import numpy as np
import pytest
import torch

from asr_craft_tpu.cli import train as jax_cli
from asr_craft_tpu.models import weights as jax_weights
from asr_craft_tpu.models.crf import CrfConfig as JaxCrfConfig
from asr_craft_tpu.utils import diagnostics as jax_diagnostics
from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.cli import train as port_cli
from asr_craft_tpu_torch.utils import diagnostics

P = 4
TRAIN = ["--synthetic_utts", "12", "--crf_label_size", str(P),
         "--crf_states", "3", "--window_extent", "1", "--crf_transftr_end",
         str(3 * P), "--bucket_sizes", "64,128", "--batch_size", "8",
         "--crf_lr", "0.5", "--crf_epochs", "1", "--log_every", "1000"]


@pytest.fixture(autouse=True)
def _debug_flags_off():
    yield
    diagnostics.enable_debug_nans(False)
    jax_diagnostics.enable_debug_nans(False)
    kernels.set_backend("auto")


def test_assert_replicated_passes_with_one_process():
    tree = {"w": torch.ones(4, 4)}
    diagnostics.assert_replicated(tree)                   # not initialised
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        diagnostics.assert_replicated(tree)               # a world of one
    finally:
        dist.destroy_process_group()


def test_assert_replicated_detects_divergence(monkeypatch):
    """Two ranks, stood in for by a gather that hands back one diverged
    copy (the multi-process run comes with the data-parallel slice)."""
    import torch.distributed as dist

    def gather(copies, mine):
        for rank, c in enumerate(copies):
            c.copy_(mine + (0.5 if rank == 1 else 0.0))

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "all_gather", gather)
    with pytest.raises(AssertionError, match=r"params\['w'\] diverges.*0.5"):
        diagnostics.assert_replicated({"w": torch.arange(8.0)})
    diagnostics.assert_replicated({"w": torch.arange(8.0)}, atol=0.6)


def test_grad_sync_hook_cadence(monkeypatch):
    calls = []
    monkeypatch.setattr(diagnostics, "assert_replicated",
                        lambda t, **k: calls.append(1))
    hook = diagnostics.grad_sync_check_hook(every=3)
    for step in range(1, 10):
        hook(step, {})
    assert len(calls) == 3  # steps 3, 6, 9


def test_profiler_session_writes_trace(tmp_path):
    d = str(tmp_path / "trace")
    with diagnostics.profiler_session(d):
        with diagnostics.step_annotation("train", 0):
            torch.ones(8, 8).sum().item()
    found = []
    for root, _, files in os.walk(d):
        found.extend(files)
    assert found == ["trace.json"]
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(e.get("name") == "train#0" for e in trace["traceEvents"])


def test_profiler_session_noop():
    with diagnostics.profiler_session(None):
        pass


def test_debug_nans_toggle():
    diagnostics.enable_debug_nans(True)
    assert diagnostics.debug_nans_enabled()
    assert torch.is_anomaly_enabled()
    bad = torch.log(torch.zeros(())) / torch.zeros(())
    with pytest.raises(FloatingPointError, match="step 7"):
        diagnostics.check_finite("toggle", 7, loss=bad)
    with pytest.raises(FloatingPointError, match="grad_norm"):
        diagnostics.check_finite("toggle", 0, loss=torch.ones(()),
                                 grad_norm=torch.tensor(float("inf")))
    diagnostics.check_finite("toggle", 0, loss=torch.ones(3))
    diagnostics.enable_debug_nans(False)
    assert not diagnostics.debug_nans_enabled()
    assert not torch.is_anomaly_enabled()


def test_deterministic_key():
    k1 = diagnostics.deterministic(7)
    k2 = diagnostics.deterministic(7)
    np.testing.assert_array_equal(torch.randn(5, generator=k1).numpy(),
                                  torch.randn(5, generator=k2).numpy())
    assert not torch.are_deterministic_algorithms_enabled()


def _poisoned(tmp_path):
    cfg = JaxCrfConfig(num_labels=P, feat_dim=3 * P, num_states=3,
                       trans_range=(0, 3 * P))
    params = {k: np.array(v) for k, v in cfg.init_params().items()}
    params["w_state"][0, 0] = np.nan
    path = tmp_path / "poisoned.dat"
    jax_weights.save_raw(str(path), cfg.fmap, params)
    return str(path)


@pytest.mark.parametrize("who", ["port", "jax"])
def test_debug_nans_through_the_train_cli(tmp_path, who, capsys):
    weights = _poisoned(tmp_path)
    main, dev = ((port_cli.main, ["--device", "cpu"]) if who == "port"
                 else (jax_cli.main, ["--platform", "cpu"]))
    argv = TRAIN + dev + ["--init_weight_file", weights]
    with pytest.raises(FloatingPointError):
        main(argv + ["--out_dir", str(tmp_path / "flag"), "--debug_nans"])
    diagnostics.enable_debug_nans(False)
    jax_diagnostics.enable_debug_nans(False)
    assert main(argv + ["--out_dir", str(tmp_path / "plain")]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert recs[-1]["kind"] == "done"
    assert (tmp_path / "plain" / "weights.final.dat").exists()
    assert jax.config.jax_debug_nans is False


def test_debug_nans_names_the_step_and_leaves_a_clean_run_alone(tmp_path,
                                                               capsys):
    """The port's error names the step; on finite weights the flag changes
    no number."""
    with pytest.raises(FloatingPointError, match="step 0"):
        port_cli.main(TRAIN + ["--device", "cpu", "--init_weight_file",
                               _poisoned(tmp_path), "--debug_nans",
                               "--out_dir", str(tmp_path / "bad")])
    capsys.readouterr()
    losses = []
    for tag, flag in (("on", ["--debug_nans"]), ("off", [])):
        assert port_cli.main(TRAIN + ["--device", "cpu", "--out_dir",
                                      str(tmp_path / tag)] + flag) == 0
        recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("{")]
        losses.append([r["mean_loss"] for r in recs
                       if r["kind"] == "train_epoch"])
    assert losses[0] == losses[1] and np.isfinite(losses[0]).all()
