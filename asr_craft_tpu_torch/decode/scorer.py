"""Error-rate scoring: edit distance, frame collapsing, TIMIT phone folding.

The reference scores decode output against MLF reference transcripts
(``CRF_MLFManager`` + external HTK ``HResults`` in upstream recipes —
SURVEY.md §2.1, §3.2); here scoring is built in: Levenshtein alignment for
PER/WER and the standard TIMIT 48->39 folding (Lee & Hon 1989) used by every
published CRaFT/Crandem result (SURVEY.md §5 metrics).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

# The 48-phone TIMIT training set, alphabetical, and the standard fold to the
# 39-phone scoring set: {ao->aa, ax->ah, cl->sil, el->l, en->n, epi->sil,
# ix->ih, vcl->sil, zh->sh}.
TIMIT_48 = [
    "aa", "ae", "ah", "ao", "aw", "ax", "ay", "b", "ch", "cl", "d", "dh",
    "dx", "eh", "el", "en", "epi", "er", "ey", "f", "g", "hh", "ih", "ix",
    "iy", "jh", "k", "l", "m", "n", "ng", "ow", "oy", "p", "r", "s", "sh",
    "sil", "t", "th", "uh", "uw", "v", "vcl", "w", "y", "z", "zh",
]
TIMIT_48_TO_39 = {
    "ao": "aa", "ax": "ah", "cl": "sil", "el": "l", "en": "n",
    "epi": "sil", "ix": "ih", "vcl": "sil", "zh": "sh",
}
TIMIT_39 = sorted({TIMIT_48_TO_39.get(p, p) for p in TIMIT_48})
assert len(TIMIT_39) == 39 and len(TIMIT_48) == 48


def timit_fold_indices() -> np.ndarray:
    """(48,) int map from 48-set index to 39-set index."""
    to39 = {p: i for i, p in enumerate(TIMIT_39)}
    return np.asarray([to39[TIMIT_48_TO_39.get(p, p)] for p in TIMIT_48],
                      dtype=np.int32)


def collapse_frames(frame_labels: Sequence[int], length: int = None,
                    drop: Sequence[int] = ()) -> List[int]:
    """Collapse per-frame labels to a phone sequence: merge consecutive
    repeats, then drop labels in ``drop`` (e.g. silence for scoring)."""
    labs = list(frame_labels[:length] if length is not None else frame_labels)
    out: List[int] = []
    for x in labs:
        x = int(x)
        if not out or out[-1] != x:
            out.append(x)
    return [x for x in out if x not in set(drop)]


def edit_distance(ref: Sequence, hyp: Sequence) -> Tuple[int, Dict[str, int]]:
    """Levenshtein distance with uniform costs.  Returns (distance,
    {"sub": s, "ins": i, "del": d}) using the standard traceback
    (ties resolved substitution-first, matching HResults conventions)."""
    n, m = len(ref), len(hyp)
    dist = np.zeros((n + 1, m + 1), np.int32)
    dist[:, 0] = np.arange(n + 1)
    dist[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            sub = dist[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])
            dist[i, j] = min(sub, dist[i - 1, j] + 1, dist[i, j - 1] + 1)
    # traceback to classify errors
    i, j, s, ins, dl = n, m, 0, 0, 0
    while i > 0 or j > 0:
        if (i > 0 and j > 0
                and dist[i, j] == dist[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])):
            s += ref[i - 1] != hyp[j - 1]
            i, j = i - 1, j - 1
        elif i > 0 and dist[i, j] == dist[i - 1, j] + 1:
            dl += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return int(dist[n, m]), {"sub": int(s), "ins": int(ins), "del": int(dl)}


class ErrorRateScorer:
    """Accumulates PER/WER over a corpus."""

    def __init__(self):
        self.errors = 0
        self.tokens = 0
        self.sub = self.ins = self.dele = 0
        self.sentences = 0
        self.sentence_errors = 0

    def add(self, ref: Sequence, hyp: Sequence) -> None:
        d, parts = edit_distance(ref, hyp)
        self.errors += d
        self.tokens += len(ref)
        self.sub += parts["sub"]
        self.ins += parts["ins"]
        self.dele += parts["del"]
        self.sentences += 1
        self.sentence_errors += d > 0

    @property
    def error_rate(self) -> float:
        return self.errors / max(self.tokens, 1)

    def summary(self) -> Dict[str, float]:
        return {
            "error_rate": self.error_rate,
            "errors": self.errors, "tokens": self.tokens,
            "sub": self.sub, "ins": self.ins, "del": self.dele,
            "sentence_error_rate": self.sentence_errors / max(self.sentences, 1),
        }


def score_batch(scorer: ErrorRateScorer, ref_seqs: List[List[int]],
                hyp_frames: np.ndarray, lengths: np.ndarray,
                fold: np.ndarray = None, drop: Sequence[int] = ()) -> None:
    """Score a batch of frame-level hypotheses against reference phone
    sequences.  ``fold``: optional index map applied to both (e.g. 48->39)."""
    for b, ref in enumerate(ref_seqs):
        if ref is None:
            continue
        hyp = collapse_frames(hyp_frames[b], int(lengths[b]))
        if fold is not None:
            ref = [int(fold[x]) for x in ref]
            hyp = [int(fold[x]) for x in hyp]
        # fold-induced repeats collapse again; drop after folding
        ref = [x for x in collapse_frames(ref) if x not in set(drop)]
        hyp = [x for x in collapse_frames(hyp) if x not in set(drop)]
        scorer.add(ref, hyp)
