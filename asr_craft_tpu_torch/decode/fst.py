"""Weighted FSTs for word decoding: lattice building, composition,
shortest path.

Capability parity with the reference's OpenFst-based decode path
(``buildLattice`` -> ``fst::Compose(lattice,
lexicon o LM)`` -> ``fst::ShortestPath`` — SURVEY.md §2.1, §3.2), built
from scratch: a compact arc-array FST representation, tropical (min-plus,
negative-log) weights, epsilon-free-right composition with left-output-
epsilon handling, and DAG shortest path.

This is deliberately OFF the TPU hot path (BASELINE: dense DP on chip;
"host-side lexicon/LM composition" in SURVEY.md §1 target map): the chip
produces frame potentials / n-best phone lattices; words are found here.
A C++ backend (native/fst.cpp via ctypes) accelerates compose+shortest-path
for production lattices; this module is the reference implementation and
fallback.

Conventions: label 0 is epsilon.  Phone labels are offset by +1 when
entering FST land; word labels are 1-based indices into the word list.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

INF = np.float32(np.inf)


@dataclasses.dataclass
class Fst:
    """Arc-array weighted FST (tropical / negative-log weights)."""

    num_states: int
    start: int
    # parallel arc arrays
    src: np.ndarray        # int32 (A,)
    dst: np.ndarray        # int32 (A,)
    ilabel: np.ndarray     # int32 (A,), 0 = epsilon
    olabel: np.ndarray     # int32 (A,), 0 = epsilon
    weight: np.ndarray     # float32 (A,)
    final: np.ndarray      # float32 (num_states,), inf = non-final

    @classmethod
    def from_arcs(cls, num_states: int, start: int,
                  arcs: Sequence[Tuple[int, int, int, int, float]],
                  finals: Dict[int, float]) -> "Fst":
        a = np.asarray(arcs, dtype=np.float64).reshape(-1, 5)
        final = np.full((num_states,), np.inf, np.float32)
        for s, w in finals.items():
            final[s] = w
        return cls(num_states, start,
                   a[:, 0].astype(np.int32), a[:, 1].astype(np.int32),
                   a[:, 2].astype(np.int32), a[:, 3].astype(np.int32),
                   a[:, 4].astype(np.float32), final)

    @property
    def num_arcs(self) -> int:
        return len(self.src)


def linear_acceptor(labels: Sequence[int], weights=None) -> Fst:
    """A straight-line acceptor over 1-based labels."""
    n = len(labels)
    w = weights if weights is not None else [0.0] * n
    arcs = [(i, i + 1, int(labels[i]), int(labels[i]), float(w[i]))
            for i in range(n)]
    return Fst.from_arcs(n + 1, 0, arcs, {n: 0.0})


def lattice_fst(log_phi_state: np.ndarray, log_phi_trans: np.ndarray,
                length: int, prune_margin: Optional[float] = None,
                num_states: int = 1) -> Fst:
    """Per-utterance frame lattice (the reference's ``buildLattice`` analogue).

    States: (t, label) + a start superstate; one arc per (t, prev, lab) with
    weight ``-(state[t, lab] + trans[prev, lab])`` (negative log potential).
    ``prune_margin``: drop arcs into (t, lab) whose best path score falls
    more than the margin below the frame's best (lattice beam).
    Arcs whose potential is -inf (topology/boundary masking) are dropped.

    Input labels are the expanded-state ids (1-based; 0 = epsilon); output
    labels are the PHONE ids (``lab // num_states + 1``), so composing with
    :func:`collapser_fst` + a lexicon works for any n-state topology.
    Construction is vectorized (one numpy block per frame), not per-arc.
    """
    state = np.asarray(log_phi_state, np.float64)[:length]
    trans = np.asarray(log_phi_trans, np.float64)  # (L, L) or (T, L, L)
    T, L = state.shape
    trans_t = ((lambda t: trans) if trans.ndim == 2
               else (lambda t: trans[t]))
    phone_of = np.arange(L, dtype=np.int32) // num_states + 1
    srcs, dsts, ils, ols, wgts = [], [], [], [], []

    def sid(t, l):  # lattice state id for (frame t, expanded label l)
        return 1 + t * L + l

    # frame 0 arcs from the start superstate
    keep_prev = np.isfinite(state[0])
    l0 = np.nonzero(keep_prev)[0].astype(np.int32)
    srcs.append(np.zeros(len(l0), np.int32))
    dsts.append(sid(0, l0).astype(np.int32))
    ils.append(l0 + 1)
    ols.append(phone_of[l0])
    wgts.append(-state[0, l0])

    delta = state[0].copy()
    for t in range(1, T):
        tr = trans_t(t)
        cand = delta[:, None] + tr + state[t][None, :]
        new = cand.max(axis=0)
        keep = np.isfinite(new)
        if prune_margin is not None:
            keep &= new >= new.max() - prune_margin
        li = np.nonzero(keep)[0].astype(np.int32)
        pi = np.nonzero(keep_prev)[0].astype(np.int32)
        # arc weight -(state[t,l] + trans[p,l]); drop -inf (masked) arcs
        w = -(state[t, li][None, :] + tr[np.ix_(pi, li)])  # (P, K)
        ok = np.isfinite(w)
        pj, lj = np.nonzero(ok)
        srcs.append(sid(t - 1, pi[pj]).astype(np.int32))
        dsts.append(sid(t, li[lj]).astype(np.int32))
        ils.append(li[lj] + 1)
        ols.append(phone_of[li[lj]])
        wgts.append(w[pj, lj])
        delta, keep_prev = new, keep

    final = np.full((1 + T * L,), np.inf, np.float32)
    final[sid(T - 1, np.nonzero(keep_prev)[0])] = 0.0
    return Fst(1 + T * L, 0,
               np.concatenate(srcs), np.concatenate(dsts),
               np.concatenate(ils), np.concatenate(ols),
               np.concatenate(wgts).astype(np.float32), final)


def collapser_fst(num_phones: int) -> Fst:
    """Frame-run collapser transducer C: maps a sequence of per-frame phone
    labels to its run-collapsed phone sequence (repeats -> epsilon output),
    exactly :func:`asr_craft_tpu_torch.decode.scorer.collapse_frames` semantics.

    Composing ``frame_lattice o C o lexicon`` lets the loop-free lexicon
    trie match multi-frame phones — the FST-land equivalent of the
    reference decoder's frame-to-phone collapsing before word lookup.
    State 0 = start; state p+1 = "last phone was p".  All states final.
    Note: adjacent IDENTICAL phones merge (no way to say "aa" as two a's),
    matching the frame-label representation's inherent limit.
    """
    L = num_phones
    arcs = []
    for p in range(L):
        arcs.append((0, p + 1, p + 1, p + 1, 0.0))       # first frame
        arcs.append((p + 1, p + 1, p + 1, 0, 0.0))       # repeat -> eps
        for q in range(L):
            if q != p:
                arcs.append((p + 1, q + 1, q + 1, q + 1, 0.0))
    finals = {s: 0.0 for s in range(L + 1)}
    return Fst.from_arcs(L + 1, 0, arcs, finals)


def lexicon_fst(lexicon: Dict[str, Sequence[int]],
                words: List[str]) -> Fst:
    """Closed pronunciation-trie transducer: phone labels (1-based input)
    -> word labels (1-based index into ``words``, emitted on the last phone
    arc, which loops back to the root).  Root is final (empty word seq)."""
    root = 0
    next_state = 1
    trie: Dict[Tuple[int, int], int] = {}
    arcs = []
    for wi, word in enumerate(words):
        phones = list(lexicon[word])
        if not phones:
            raise ValueError(f"empty pronunciation for {word!r}")
        cur = root
        for ph in phones[:-1]:
            key = (cur, ph + 1)
            if key not in trie:
                trie[key] = next_state
                arcs.append((cur, next_state, ph + 1, 0, 0.0))
                next_state += 1
            cur = trie[key]
        arcs.append((cur, root, phones[-1] + 1, wi + 1, 0.0))
    return Fst.from_arcs(next_state, root, arcs, {root: 0.0})


def bigram_lm_fst(num_words: int, logp: np.ndarray,
                  logp_init: np.ndarray, logp_final: np.ndarray) -> Fst:
    """Bigram word LM acceptor: state 0 = <s>, state w = after word w-1.

    ``logp[u, w]`` = log p(w|u); ``logp_init[w]`` = log p(w|<s>);
    ``logp_final[u]`` = log p(</s>|u).  Word labels are 1-based.
    """
    arcs = []
    for w in range(num_words):
        arcs.append((0, w + 1, w + 1, w + 1, -float(logp_init[w])))
    for u in range(num_words):
        for w in range(num_words):
            arcs.append((u + 1, w + 1, w + 1, w + 1, -float(logp[u, w])))
    finals = {u + 1: -float(logp_final[u]) for u in range(num_words)}
    finals[0] = 0.0
    return Fst.from_arcs(num_words + 1, 0, arcs, finals)


def backoff_bigram_lm_fst(num_words: int, bigrams, logp_uni,
                          alpha, logp_final, logp_init=None) -> Fst:
    """Katz/interpolated-style PRUNED backoff bigram acceptor.

    The dense :func:`bigram_lm_fst` needs W^2 arcs — 25M at a 5k-word WSJ
    vocabulary.  This one keeps only SEEN bigrams plus a shared
    backoff state: each history state carries an input-EPSILON arc
    (ilabel 0) of weight ``-log alpha(u)`` to the backoff state, whose W
    unigram arcs cover every unseen continuation.  Arc count is
    O(num seen bigrams + 2W) — the standard ARPA-style FST approximation
    (the tropical decoder takes max over the explicit-vs-backoff paths).

    ``bigrams``: dict (u, w) -> log p(w|u) with u in {-1 (<s>), 0..W-1};
    ``alpha``: dict u -> backoff log-weight; ``logp_uni[w]``; ``logp_final
    [u]`` = log p(</s>|u) over u in {-1, 0..W-1}.  States: 0 = <s>,
    1..W = histories, W+1 = backoff.  Consumers must be epsilon-aware:
    :func:`eps_closure` (the OTF decoders are); :func:`compose` rejects
    input-epsilon B — small vocabularies can densify with
    :func:`remove_input_epsilons` first.
    """
    BO = num_words + 1
    arcs = []
    st = lambda u: 0 if u == -1 else u + 1
    for (u, w), lp in bigrams.items():
        arcs.append((st(u), w + 1, w + 1, w + 1, -float(lp)))
    for u in set([-1] + list(range(num_words))):
        a = alpha.get(u, 0.0)
        arcs.append((st(u), BO, 0, 0, -float(a)))
    for w in range(num_words):
        arcs.append((BO, w + 1, w + 1, w + 1, -float(logp_uni[w])))
    finals = {st(u): -float(lp) for u, lp in logp_final.items()}
    return Fst.from_arcs(num_words + 2, 0, arcs, finals)


def estimate_backoff_bigram(word_seqs, words, discount: float = 0.5
                            ) -> Fst:
    """Absolute-discounting backoff bigram estimated from transcripts,
    returned as a pruned :func:`backoff_bigram_lm_fst` (arc count O(seen
    bigrams + 2W) — the scalable form for WSJ-size vocabularies; the
    reference consumes externally-built LM FSTs, this is the built-in
    estimator for recipes/tests).

    p(w|u) = max(c(u,w) - d, 0)/c(u) for seen, alpha(u) * p_uni(w) backoff
    with alpha(u) = d * |successors(u)| / c(u); <s> is history -1 and
    </s> is modeled by the final weights.
    """
    widx = {w: i for i, w in enumerate(words)}
    W = len(words)
    cnt: Dict[Tuple[int, int], int] = {}
    hist = {-1: 0}
    uni = np.ones(W)                      # add-1 unigram
    for ws in word_seqs:
        prev = -1
        for w in ws:
            i = widx[w]
            cnt[(prev, i)] = cnt.get((prev, i), 0) + 1
            hist[prev] = hist.get(prev, 0) + 1
            uni[i] += 1
            prev = i
        cnt[(prev, -2)] = cnt.get((prev, -2), 0) + 1   # </s>
        hist[prev] = hist.get(prev, 0) + 1
    logp_uni = np.log(uni / uni.sum())
    bigrams = {}
    nsucc: Dict[int, int] = {}
    for (u, w), c in cnt.items():
        nsucc[u] = nsucc.get(u, 0) + 1
        if w >= 0:
            bigrams[(u, w)] = np.log(max(c - discount, 0.25 * discount)
                                     / hist[u])
    alpha = {}
    for u in range(-1, W):
        h = hist.get(u, 0)
        if h == 0:
            alpha[u] = 0.0                # unseen history: pure backoff
        else:
            alpha[u] = float(np.log(max(
                discount * nsucc.get(u, 1) / h, 1e-6)))
    # final (</s>) weights: discounted where seen, floor elsewhere
    logp_final = {}
    for u in range(-1, W):
        c = cnt.get((u, -2), 0)
        h = hist.get(u, 0)
        logp_final[u] = float(np.log(max(c - discount, 0.25 * discount)
                                     / h)) if h else float(np.log(0.1))
    return backoff_bigram_lm_fst(W, bigrams, logp_uni, alpha, logp_final)


def eps_closure(f: Fst):
    """Per-state input-epsilon closure: state -> list of (state', weight')
    pairs (self included at 0) reachable via ilabel-0 arcs, min-weight
    (Dijkstra over the epsilon subgraph; cycle-safe).  Used by the OTF
    decoders to consume backoff-LM epsilons on the fly."""
    import heapq as hq
    eps: Dict[int, List[Tuple[int, float]]] = {}
    for j in range(f.num_arcs):
        if f.ilabel[j] == 0:
            eps.setdefault(int(f.src[j]), []).append(
                (int(f.dst[j]), float(f.weight[j])))
    out: Dict[int, List[Tuple[int, float]]] = {}
    for s in range(f.num_states):
        best = {s: 0.0}
        heap = [(0.0, s)]
        while heap:
            w, u = hq.heappop(heap)
            if w > best.get(u, np.inf):
                continue
            for v, aw in eps.get(u, ()):
                nw = w + aw
                if nw < best.get(v, np.inf):
                    best[v] = nw
                    hq.heappush(heap, (nw, v))
        out[s] = sorted(best.items(), key=lambda kv: kv[1])
    return out


def remove_input_epsilons(f: Fst) -> Fst:
    """Epsilon-remove (input side, tropical): replace each state's arcs by
    the closure-expanded arc set and closure-min finals.  Densifies — use
    only for small graphs (e.g. to feed :func:`compose`, which requires an
    input-epsilon-free B)."""
    clos = eps_closure(f)
    by_src: Dict[int, List[int]] = {}
    for j in range(f.num_arcs):
        if f.ilabel[j] != 0:
            by_src.setdefault(int(f.src[j]), []).append(j)
    arcs = []
    finals: Dict[int, float] = {}
    for s in range(f.num_states):
        best: Dict[Tuple[int, int, int], float] = {}
        fbest = np.inf
        for s2, w2 in clos[s]:
            if np.isfinite(f.final[s2]):
                fbest = min(fbest, w2 + float(f.final[s2]))
            for j in by_src.get(s2, ()):
                key = (int(f.dst[j]), int(f.ilabel[j]), int(f.olabel[j]))
                w = w2 + float(f.weight[j])
                if w < best.get(key, np.inf):
                    best[key] = w
        for (d, il, ol), w in best.items():
            arcs.append((s, d, il, ol, w))
        if np.isfinite(fbest):
            finals[s] = float(fbest)
    return Fst.from_arcs(f.num_states, f.start, arcs, finals)


def compose(a: Fst, b: Fst) -> Fst:
    """Composition A o B matching ``a.olabel == b.ilabel``.

    B must be input-epsilon-free (true for our lexicons and LMs).  Arcs of A
    with epsilon output advance A alone.  Reachable-product construction.
    """
    from collections import deque
    # index B arcs by (state, ilabel)
    b_index: Dict[Tuple[int, int], List[int]] = {}
    for j in range(b.num_arcs):
        if b.ilabel[j] == 0:
            raise ValueError("compose: B must be input-epsilon-free")
        b_index.setdefault((int(b.src[j]), int(b.ilabel[j])), []).append(j)
    a_index: Dict[int, List[int]] = {}
    for i in range(a.num_arcs):
        a_index.setdefault(int(a.src[i]), []).append(i)

    pair_id: Dict[Tuple[int, int], int] = {}
    arcs = []
    finals: Dict[int, float] = {}

    def get_id(p):
        if p not in pair_id:
            pair_id[p] = len(pair_id)
        return pair_id[p]

    start = get_id((a.start, b.start))
    queue = deque([(a.start, b.start)])
    seen = {(a.start, b.start)}
    while queue:
        sa, sb = queue.popleft()
        s = get_id((sa, sb))
        fa, fb = a.final[sa], b.final[sb]
        if np.isfinite(fa) and np.isfinite(fb):
            finals[s] = float(fa + fb)
        for i in a_index.get(sa, ()):  # arcs of A from sa
            ol = int(a.olabel[i])
            if ol == 0:  # output-epsilon: advance A alone
                nxt = (int(a.dst[i]), sb)
                arcs.append((s, get_id(nxt), int(a.ilabel[i]), 0,
                             float(a.weight[i])))
                if nxt not in seen:
                    seen.add(nxt)
                    queue.append(nxt)
            else:
                for j in b_index.get((sb, ol), ()):
                    nxt = (int(a.dst[i]), int(b.dst[j]))
                    arcs.append((s, get_id(nxt), int(a.ilabel[i]),
                                 int(b.olabel[j]),
                                 float(a.weight[i] + b.weight[j])))
                    if nxt not in seen:
                        seen.add(nxt)
                        queue.append(nxt)
    if not arcs:
        arcs = np.zeros((0, 5))
    return Fst.from_arcs(max(len(pair_id), 1), start, arcs, finals)


def shortest_path(f: Fst) -> Tuple[List[int], List[int], float]:
    """Min-weight accepting path of an ACYCLIC FST.

    Returns (ilabels, olabels, total_weight) with epsilons removed; raises
    if the FST is cyclic or has no accepting path.
    """
    # topological order by Kahn's algorithm
    indeg = np.zeros(f.num_states, np.int64)
    np.add.at(indeg, f.dst, 1)
    adj: Dict[int, List[int]] = {}
    for i in range(f.num_arcs):
        adj.setdefault(int(f.src[i]), []).append(i)
    from collections import deque
    order = []
    q = deque([s for s in range(f.num_states) if indeg[s] == 0])
    while q:
        s = q.popleft()
        order.append(s)
        for i in adj.get(s, ()):
            indeg[f.dst[i]] -= 1
            if indeg[f.dst[i]] == 0:
                q.append(int(f.dst[i]))
    if len(order) != f.num_states:
        raise ValueError("shortest_path: FST has a cycle")

    dist = np.full(f.num_states, np.inf)
    back = np.full(f.num_states, -1, np.int64)
    dist[f.start] = 0.0
    for s in order:
        if not np.isfinite(dist[s]):
            continue
        for i in adj.get(s, ()):
            nd = dist[s] + f.weight[i]
            d = int(f.dst[i])
            if nd < dist[d]:
                dist[d] = nd
                back[d] = i
    total = dist + f.final
    if not np.isfinite(total).any():
        raise ValueError("shortest_path: no accepting path")
    end = int(np.argmin(total))
    ilabs, olabs = [], []
    s = end
    while back[s] >= 0:
        i = int(back[s])
        if f.ilabel[i]:
            ilabs.append(int(f.ilabel[i]))
        if f.olabel[i]:
            olabs.append(int(f.olabel[i]))
        s = int(f.src[i])
    return ilabs[::-1], olabs[::-1], float(total[end])


def shortest_paths_n(f: Fst, n: int):
    """N best accepting paths of an ACYCLIC FST (fst::ShortestPath(n)
    parity).  Returns a list of (ilabels, olabels, weight), best first.

    DAG DP keeping the top-n partial paths per state (each entry carries its
    own backpointer chain), so paths may share prefixes but are distinct
    arc sequences.
    """
    indeg = np.zeros(f.num_states, np.int64)
    np.add.at(indeg, f.dst, 1)
    adj: Dict[int, List[int]] = {}
    for i in range(f.num_arcs):
        adj.setdefault(int(f.src[i]), []).append(i)
    from collections import deque
    order = []
    q = deque([s for s in range(f.num_states) if indeg[s] == 0])
    while q:
        s = q.popleft()
        order.append(s)
        for i in adj.get(s, ()):
            indeg[f.dst[i]] -= 1
            if indeg[f.dst[i]] == 0:
                q.append(int(f.dst[i]))
    if len(order) != f.num_states:
        raise ValueError("shortest_paths_n: FST has a cycle")

    # per-state list of (dist, arc_idx, parent_entry) capped at n
    entries: Dict[int, List[Tuple[float, int, Optional[tuple]]]] = {
        f.start: [(0.0, -1, None)]}
    for s in order:
        cur = entries.get(s)
        if not cur:
            continue
        for i in adj.get(s, ()):
            d = int(f.dst[i])
            lst = entries.setdefault(d, [])
            for ent in cur:
                lst.append((ent[0] + float(f.weight[i]), i, ent))
            lst.sort(key=lambda e: e[0])
            del lst[n:]

    finals = []
    for s, lst in entries.items():
        if np.isfinite(f.final[s]):
            for ent in lst:
                finals.append((ent[0] + float(f.final[s]), ent))
    finals.sort(key=lambda e: e[0])
    out = []
    for total, ent in finals[:n]:
        ilabs, olabs = [], []
        while ent is not None and ent[1] >= 0:
            i = ent[1]
            if f.ilabel[i]:
                ilabs.append(int(f.ilabel[i]))
            if f.olabel[i]:
                olabs.append(int(f.olabel[i]))
            ent = ent[2]
        out.append((ilabs[::-1], olabs[::-1], total))
    return out


def compose_decode_graph(log_phi_state, log_phi_trans, length,
                         lexicon: Dict[str, Sequence[int]],
                         words: List[str],
                         lm: Optional[Fst] = None,
                         prune_margin: Optional[float] = None,
                         lm_weight: float = 1.0,
                         num_states: int = 1,
                         backend: str = "auto") -> Fst:
    """``frame_lattice o collapser o lexicon [o LM]`` — the acyclic search
    graph whose shortest path is the best word sequence.  Input labels are
    expanded-state ids; output labels are word ids (1-based)."""
    lat = lattice_fst(np.asarray(log_phi_state), np.asarray(log_phi_trans),
                      int(length), prune_margin, num_states=num_states)
    ops = get_backend(backend)
    num_phones = log_phi_state.shape[-1] // num_states
    lw = ops.compose(lat, collapser_fst(num_phones))
    lw = ops.compose(lw, lexicon_fst(lexicon, words))
    if lm is not None:
        if lm_weight != 1.0:
            lm = dataclasses.replace(lm, weight=lm.weight * lm_weight,
                                     final=lm.final * lm_weight)
        lw = ops.compose(lw, lm)
    return lw


def decode_words(log_phi_state, log_phi_trans, length,
                 lexicon: Dict[str, Sequence[int]], words: List[str],
                 lm: Optional[Fst] = None,
                 prune_margin: Optional[float] = None,
                 lm_weight: float = 1.0,
                 num_states: int = 1,
                 backend: str = "auto") -> Tuple[List[str], List[int], float]:
    """Full word decode: lattice o collapser o lexicon [o LM] -> shortest
    path (the ``CRFFstDecode`` pipeline, SURVEY.md §3.2).

    Returns (word sequence, expanded-state frame path, path weight)."""
    lw = compose_decode_graph(log_phi_state, log_phi_trans, length, lexicon,
                              words, lm, prune_margin, lm_weight, num_states,
                              backend)
    ops = get_backend(backend)
    states, wids, weight = ops.shortest_path(lw)
    return [words[w - 1] for w in wids], [s - 1 for s in states], weight


def decode_words_nbest(log_phi_state, log_phi_trans, length,
                       lexicon: Dict[str, Sequence[int]], words: List[str],
                       n: int,
                       lm: Optional[Fst] = None,
                       prune_margin: Optional[float] = None,
                       lm_weight: float = 1.0,
                       num_states: int = 1,
                       backend: str = "auto"):
    """N-best word decode (``fst::ShortestPath(n)`` parity).  Returns a list
    of (word sequence, expanded-state frame path, weight), best first."""
    lw = compose_decode_graph(log_phi_state, log_phi_trans, length, lexicon,
                              words, lm, prune_margin, lm_weight, num_states,
                              backend)
    out = []
    for states, wids, weight in shortest_paths_n(lw, n):
        out.append(([words[w - 1] for w in wids],
                    [s - 1 for s in states], weight))
    return out


def read_lexicon(path, phone_index: Optional[Dict[str, int]] = None
                 ) -> Tuple[Dict[str, List[int]], List[str]]:
    """Parse a pronunciation lexicon: one ``word ph1 ph2 ...`` per line.
    Phones are looked up in ``phone_index`` (name -> 0-based id) when given,
    else parsed as integer ids.  Returns (lexicon, word list in file order).
    """
    lexicon: Dict[str, List[int]] = {}
    words: List[str] = []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            word, phs = parts[0], parts[1:]
            if not phs:
                raise ValueError(f"lexicon: no pronunciation for {word!r}")
            ids = [phone_index[p] if phone_index else int(p) for p in phs]
            if word in lexicon:
                raise ValueError(
                    f"lexicon: duplicate entry {word!r} (one pronunciation "
                    "per word; use distinct word symbols for variants)")
            lexicon[word] = ids
            words.append(word)
    return lexicon, words


def write_fst_text(f: Fst, path) -> None:
    """AT&T/OpenFst text format (``src dst ilabel olabel weight`` lines,
    finals as ``state weight``) — the reference can emit lattices as FST
    files for offline rescoring; this is the interchange format."""
    with open(path, "w") as out:
        # OpenFst convention: the first line's source is the start state
        order = np.argsort(f.src != f.start, kind="stable")
        for i in order:
            out.write(f"{f.src[i]} {f.dst[i]} {f.ilabel[i]} "
                      f"{f.olabel[i]} {f.weight[i]:.7g}\n")
        for s in range(f.num_states):
            if np.isfinite(f.final[s]):
                out.write(f"{s} {f.final[s]:.7g}\n")


def read_fst_text(path, start: Optional[int] = None) -> Fst:
    arcs, finals = [], {}
    first_src = None
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if len(parts) >= 4:
                s, d, il, ol = map(int, parts[:4])
                w = float(parts[4]) if len(parts) > 4 else 0.0
                arcs.append((s, d, il, ol, w))
                if first_src is None:
                    first_src = s
            else:
                finals[int(parts[0])] = (float(parts[1])
                                         if len(parts) > 1 else 0.0)
    ns = 1 + max([max(a[0], a[1]) for a in arcs] + list(finals) + [0])
    return Fst.from_arcs(ns, start if start is not None else
                         (first_src or 0), arcs, finals)


class _PyBackend:
    compose = staticmethod(compose)
    shortest_path = staticmethod(shortest_path)


def get_backend(name: str = "auto"):
    """"py", "native" (C++ via ctypes), or "auto" (native if built)."""
    if name == "py":
        return _PyBackend
    try:
        from asr_craft_tpu_torch.decode import fst_native
        if fst_native.available():
            return fst_native
        if name == "native":
            raise RuntimeError("native fst backend not built")
    except ImportError:
        if name == "native":
            raise
    return _PyBackend
