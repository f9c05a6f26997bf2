"""Synthetic corpora for tests, recipes, and benchmarks.

The reference was validated on TIMIT/WSJ data that is not redistributable;
the framework's e2e tests and benchmarks instead use generated corpora with
known structure (SURVEY.md §4.2 item 7): "MLP-posterior-like" features that
are a noisy one-hot encoding of a hidden phone sequence with realistic
duration structure, so a correct CRF trains to ~0 error in seconds and any
regression is visible.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticConfig:
    num_labels: int = 48          # TIMIT training set size
    feat_dim: int = 48            # posterior-like features (== num_labels)
    mean_dur: float = 6.0         # mean phone duration in frames
    min_dur: int = 2
    noise: float = 0.5            # feature noise std
    confusion: float = 0.15       # prob mass leaked to a confusable label
    min_len: int = 20
    max_len: int = 200
    seed: int = 0


def _durations(rng, n, cfg):
    d = rng.poisson(cfg.mean_dur - cfg.min_dur, size=n) + cfg.min_dur
    return d


def generate_utterance(rng, cfg: SyntheticConfig,
                       T: int) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """Returns (feats (T, feat_dim), frame_labels (T,), phone_seq)."""
    labels = np.zeros(T, np.int32)
    phones: List[int] = []
    t = 0
    while t < T:
        p = int(rng.integers(cfg.num_labels))
        if phones and p == phones[-1]:
            continue  # adjacent distinct phones, like real transcripts
        d = int(_durations(rng, 1, cfg)[0])
        # absorb the tail into this run so no phone is truncated below
        # min_dur (a too-short final run cannot traverse an n-state
        # topology and would make the training numerator empty)
        if T - (t + d) < cfg.min_dur:
            d = T - t
        labels[t:t + d] = p
        phones.append(p)
        t += d
    # one-hot posteriors + structured confusion (label l leaks to l+1) + noise
    feats = np.full((T, cfg.feat_dim), 0.0, np.float32)
    eye = np.eye(cfg.num_labels, cfg.feat_dim, dtype=np.float32)
    conf = np.roll(eye, 1, axis=1)
    feats += (1 - cfg.confusion) * eye[labels] + cfg.confusion * conf[labels]
    feats += rng.normal(scale=cfg.noise, size=feats.shape).astype(np.float32)
    return feats, labels, phones


def generate_corpus(cfg: SyntheticConfig, num_utts: int):
    """Returns (features list[(T_i, D)], frame_labels list[(T_i,)],
    phone_seqs list[list[int]])."""
    rng = np.random.default_rng(cfg.seed)
    feats, labels, phones = [], [], []
    for _ in range(num_utts):
        T = int(rng.integers(cfg.min_len, cfg.max_len + 1))
        f, l, p = generate_utterance(rng, cfg, T)
        feats.append(f)
        labels.append(l)
        phones.append(p)
    return feats, labels, phones


@dataclasses.dataclass
class WordCorpusConfig:
    """Synthetic word-level corpus for exercising the FST decode path
    (lexicon composition + WER).  Words get DISJOINT phone inventories so
    the phone-sequence -> word-sequence map is unambiguous and a correct
    decoder reaches ~0 WER on clean data."""

    num_words: int = 8
    min_pron: int = 2             # phones per word
    max_pron: int = 4
    min_words: int = 2            # words per utterance
    max_words: int = 6
    mean_dur: float = 5.0         # frames per phone
    min_dur: int = 2
    noise: float = 0.3
    seed: int = 0
    # WSJ-scale mode: a SHARED phone inventory of this size (0 keeps the
    # legacy disjoint-inventory corpus).  Words get distinct random
    # pronunciations over the shared phones — acoustically confusable
    # (shared prefixes, near-homophones), which is what makes a 5k-word
    # lexicon + LM decode a real search problem rather than a lookup.
    shared_phones: int = 0
    zipf_a: float = 0.0           # >0: Zipf word-frequency skew


def generate_word_corpus(cfg: WordCorpusConfig, num_utts: int):
    """Returns (feats, frame_labels, word_seqs, lexicon, words):
    ``lexicon`` maps word -> phone-id list; ``words`` is the word list;
    features are noisy one-hot phone posteriors (feat_dim = num phones)."""
    rng = np.random.default_rng(cfg.seed)
    lexicon, words = {}, []
    if cfg.shared_phones:
        num_phones = cfg.shared_phones
        seen_prons = set()
        for w in range(cfg.num_words):
            while True:
                k = int(rng.integers(cfg.min_pron, cfg.max_pron + 1))
                pron = tuple(int(p) for p in
                             rng.integers(0, num_phones, size=k))
                if pron not in seen_prons:
                    seen_prons.add(pron)
                    break
            word = f"w{w:05d}"
            lexicon[word] = list(pron)
            words.append(word)
    else:
        next_ph = 0
        for w in range(cfg.num_words):
            k = int(rng.integers(cfg.min_pron, cfg.max_pron + 1))
            word = f"w{w:02d}"
            lexicon[word] = list(range(next_ph, next_ph + k))
            words.append(word)
            next_ph += k
        num_phones = next_ph

    if cfg.zipf_a > 0:
        pw = 1.0 / np.arange(1, cfg.num_words + 1) ** cfg.zipf_a
        pw /= pw.sum()
    else:
        pw = np.full(cfg.num_words, 1.0 / cfg.num_words)

    feats, frame_labels, word_seqs = [], [], []
    for _ in range(num_utts):
        nw = int(rng.integers(cfg.min_words, cfg.max_words + 1))
        wseq = [words[int(i)] for i in
                rng.choice(cfg.num_words, size=nw, p=pw)]
        phones = [p for w in wseq for p in lexicon[w]]
        durs = rng.poisson(cfg.mean_dur - cfg.min_dur,
                           size=len(phones)) + cfg.min_dur
        labels = np.repeat(np.asarray(phones, np.int32), durs)
        x = np.eye(num_phones, dtype=np.float32)[labels]
        x += rng.normal(scale=cfg.noise, size=x.shape).astype(np.float32)
        feats.append(x)
        frame_labels.append(labels)
        word_seqs.append(wseq)
    return feats, frame_labels, word_seqs, lexicon, words


def nstate_frame_labels(frame_labels: np.ndarray, num_states: int) -> np.ndarray:
    """Expand phone frame labels to a topology-legal state path: each phone
    run spends roughly equal time in each of its left-to-right states (a
    crude forced alignment for n-state training fixtures)."""
    out = np.zeros_like(frame_labels)
    t = 0
    T = len(frame_labels)
    while t < T:
        p = frame_labels[t]
        e = t
        while e < T and frame_labels[e] == p:
            e += 1
        run = e - t
        for i in range(run):
            st = min(i * num_states // run, num_states - 1)
            out[t + i] = p * num_states + st
        t = e
    return out
