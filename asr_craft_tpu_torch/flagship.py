"""The flagship model, the shared-transition configs and numpy-seeded
inputs, shared by tests and chip_smoke.

Counterpart of ``__graft_entry__._flagship`` / ``_tiny_batch`` /
``entry`` / ``dryrun_multichip``: BASELINE
config 2, a TIMIT-shaped triphone-state CRF — 48 phones x 3 states over
MLP-posterior features with a +/-1 context window (144 dims), and
frame-dependent transition features over all dims.  Beside it, the
shared-transition (bias-only) configs 1, 3 and 5 at their recipes' widths
(:func:`timit_mono`, :func:`wsj_crandem`, :func:`swbd`), with the feature
width of the synthetic posterior corpus: P posteriors x (2 * window + 1)
frames, and the segmental CRF of config 4 (:func:`scrf`) at the width the
JAX package benches it at.  Inputs come from ``numpy.random.default_rng`` so
both packages can be fed the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from asr_craft_tpu_torch.models.crf import CrfConfig, crf_loss
from asr_craft_tpu_torch.models.segmental import SegCrfConfig


def flagship() -> CrfConfig:
    return CrfConfig(num_labels=48, feat_dim=144, num_states=3,
                     trans_range=(0, 144))


def timit_mono() -> CrfConfig:
    """BASELINE config 1 (``recipes/timit_mono.py``): 48 phones, one state,
    a +/-1 window (144 dims), bias-only transitions."""
    return CrfConfig(num_labels=48, feat_dim=48 * 3)


def wsj_crandem() -> CrfConfig:
    """BASELINE config 3 (``recipes/wsj_crandem.py``): 42 phones, one
    state, a +/-2 window (210 dims), bias-only transitions; the recipe
    decodes with ``--normalize utt --beam_threshold 8``."""
    return CrfConfig(num_labels=42, feat_dim=42 * 5)


def swbd() -> CrfConfig:
    """BASELINE config 5 (``recipes/swbd_multihost.py``): 46 phones x 3
    states (138 labels), a +/-2 window (230 dims), bias-only
    transitions."""
    return CrfConfig(num_labels=46, feat_dim=46 * 5, num_states=3)


def scrf() -> SegCrfConfig:
    """BASELINE config 4 (``recipes/scrf.py``) at the width of the JAX
    package's segmental bench (``bench.py``, B=128, T=512): 48 labels, 144
    dims, segments of up to 16 frames."""
    return SegCrfConfig(num_labels=48, feat_dim=144, max_dur=16)


def scrf_batch(cfg: SegCrfConfig, B: int = 128, T: int = 512, seed: int = 0,
               device="cpu", ragged: bool = False) -> dict:
    """The segmental bench's batch: N(0, 1) frames and labels in runs of 4
    frames, all rows full; ``ragged``: lengths on run ends from
    :func:`ragged_lengths` (row 0 full, the last row empty)."""
    batch = tiny_batch(cfg, B, T, seed, device)
    if ragged:
        lengths = (ragged_lengths(B, T, seed) + 3) // 4 * 4
        lengths[-1] = 0
        batch["lengths"] = torch.from_numpy(lengths).to(device)
    return batch


def tiny_batch(cfg, B: int = 8, T: int = 64, seed: int = 0,
               device="cpu") -> dict:
    """The JAX ``_tiny_batch``: N(0, 1) frames, phone runs of 4 frames,
    full lengths; tensors on ``device``."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, T, cfg.feat_dim)).astype(np.float32)
    runs = np.repeat(rng.integers(0, cfg.num_labels, size=(B, T // 4)), 4,
                     axis=1)
    return {"feats": torch.from_numpy(feats).to(device),
            "labels": torch.from_numpy(
                runs[:, :T].astype(np.int32)).to(device),
            "lengths": torch.full((B,), T, dtype=torch.int32, device=device)}


def entry(device="cuda"):
    """``(fn, args)``: the flagship forward step, ``fn(*args)`` the mean
    per-frame loss of :func:`crf_loss` on :func:`tiny_batch`, with params
    ``init_params`` at scale 0.01 from a generator seeded 0.  On the card
    unless ``device`` asks for another (``"cpu"``: the plain versions);
    raises where there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"entry(device={device}): no CUDA device is "
                           "available (pass device='cpu' to run the plain "
                           "versions on the CPU)")
    cfg = flagship()
    params = cfg.init_params(torch.Generator().manual_seed(0), 0.01, device)
    batch = tiny_batch(cfg, device=device)

    def fn(params, feats, labels, lengths):
        loss, _ = crf_loss(cfg, params, feats, labels, lengths)
        return loss

    return fn, (params, batch["feats"], batch["labels"], batch["lengths"])


def _dryrun_rank() -> float:
    """One rank of :func:`dryrun_multichip`."""
    from asr_craft_tpu_torch.parallel import make_batch_put, make_mesh
    from asr_craft_tpu_torch.train import TrainConfig, make_train_step
    from asr_craft_tpu_torch.utils.diagnostics import assert_replicated
    mesh = make_mesh()
    cfg = flagship()
    tc = TrainConfig(lr=0.1)
    params = {k: v.requires_grad_(True) for k, v in cfg.init_params(
        torch.Generator().manual_seed(0), 0.01, mesh.device).items()}
    before = {k: v.detach().clone() for k, v in params.items()}
    step_fn, opt = make_train_step(cfg, tc, mesh=mesh)
    batch = make_batch_put(mesh)(tiny_batch(cfg, B=2 * mesh.size, T=32),
                                 global_batch=True)
    _, _, _, metrics = step_fn(params, opt.init(params), {}, batch, tc.lr)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise FloatingPointError(f"dryrun_multichip: loss {loss}")
    if all(torch.equal(v, before[k]) for k, v in params.items()):
        raise AssertionError("dryrun_multichip: the step changed no "
                             "parameter")
    assert_replicated(params)
    return loss


def dryrun_multichip(n_devices: int, device="cuda") -> float:
    """One full data-parallel training step of the flagship over
    ``n_devices`` ranks, the twin of ``__graft_entry__.dryrun_multichip``:
    ``n_devices`` spawned processes, one GPU a rank (NCCL) unless
    ``device`` asks for gloo ranks on the CPU; a global batch of 2 rows a
    rank at T=32.  Each rank asserts a finite loss, changed parameters and
    parameters equal on every rank (``assert_replicated``).  Returns the
    loss; raises where a rank failed or there are too few GPUs."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"dryrun_multichip(device={device}): no CUDA "
                           "device is available (pass device='cpu' for "
                           "gloo ranks on the CPU)")
    from asr_craft_tpu_torch.parallel.mesh import run_ranks
    losses = run_ranks(_dryrun_rank, n_devices, device=device.type,
                       timeout=600.0)
    if len(set(losses)) != 1:
        raise AssertionError(f"dryrun_multichip: the ranks' losses differ "
                             f"{losses}")
    print(f"dryrun_multichip({n_devices}): loss={losses[0]:.4f} ok")
    return losses[0]


def ragged_lengths(B: int, T: int, seed: int = 0) -> np.ndarray:
    """(B,) int32 lengths in [1, T] with row 0 full and the last row empty,
    the loader's padding row (uid < 0)."""
    lengths = np.random.default_rng(seed).integers(1, T + 1, size=B)
    lengths[0] = T
    lengths[-1] = 0
    return lengths.astype(np.int32)


def posterior_model(cfg: CrfConfig, window_extent: int = 1, seed: int = 0,
                    trans_scale: float = 0.01) -> dict:
    """A hand-set model (numpy arrays) that decodes posterior features:
    the centre window's posterior of phone p feeds p's states with weight
    4, transition weights (``w_trans``, or ``b_trans`` for a model with
    shared transitions, which would tie everywhere at zero) are
    ``trans_scale * N(0, 1)`` from ``seed``, and everything else is zero.
    Needs the synthetic corpus's layout: ``feat_dim = num_labels * (2 *
    window_extent + 1)``."""
    P, ns = cfg.num_labels, cfg.num_states
    if cfg.feat_dim != P * (2 * window_extent + 1):
        raise ValueError(f"feat_dim {cfg.feat_dim} is not {P} posteriors "
                         f"x {2 * window_extent + 1} frames")
    params = {k: np.zeros(s, np.float32)
              for k, s in cfg.fmap.param_shapes().items()}
    centre = window_extent * P
    for p in range(P):
        params["w_state"][centre + p - cfg.fmap.state_range[0],
                          ns * p:ns * p + ns] = 4.0
    key = "w_trans" if "w_trans" in params else "b_trans"
    rng = np.random.default_rng(seed)
    params[key] = (trans_scale * rng.normal(
        size=params[key].shape)).astype(np.float32)
    return params


def word_corpus(out_dir) -> int:
    """The word-decode fixture of ``tests/e2e/test_word_decode.py``: 80
    utterances of ``generate_word_corpus(WordCorpusConfig(num_words=6,
    noise=0.2, seed=7))`` (noisy one-hot phone posteriors, 6 words with
    disjoint phones).  Writes ``train.pf`` (70 utterances), ``test.pf``
    (10), ``lex.txt`` and ``refs.txt`` (the test transcripts, keys
    ``utt000000`` ...) under ``out_dir``; returns the number of phones.
    The generator and the pfile writer are the port's ``data`` modules."""
    from pathlib import Path

    from asr_craft_tpu_torch.data import PFile, WordCorpusConfig, write_pfile
    from asr_craft_tpu_torch.data.synthetic import generate_word_corpus
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    cfg = WordCorpusConfig(num_words=6, noise=0.2, seed=7)
    feats, labels, word_seqs, lexicon, words = generate_word_corpus(cfg, 80)
    write_pfile(out / "train.pf", PFile(feats[:70], labels[:70]))
    write_pfile(out / "test.pf", PFile(feats[70:], labels[70:]))
    with open(out / "lex.txt", "w") as f:
        for w in words:
            f.write(f"{w} {' '.join(map(str, lexicon[w]))}\n")
    with open(out / "refs.txt", "w") as f:
        for i, ws in enumerate(word_seqs[70:]):
            f.write(f"utt{i:06d} {' '.join(ws)}\n")
    return 1 + max(p for ps in lexicon.values() for p in ps)
