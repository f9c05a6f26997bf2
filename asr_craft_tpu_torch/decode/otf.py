"""On-the-fly FST-composed beam Viterbi (the reference
``CRF_ViterbiDecoder``'s flagship mode — SURVEY.md §2.1 "time-synchronous
beam-pruned Viterbi with on-the-fly composition against dictionary/LM FST",
§3.3).

Where :func:`asr_craft_tpu_torch.decode.fst.decode_words` materializes the full
frame lattice and composes offline, this decoder never builds the lattice:
tokens ``(expanded state l, grammar state g)`` are passed time-synchronously
through the phone-input search graph G = lexicon [o LM], with Viterbi
recombination per token and threshold / max-active beam pruning per frame.
The frame-run collapser is implicit: G advances only when the phone
identity changes between frames (identical semantics to composing with
``collapser_fst`` — adjacent identical phones merge).

Host-side by design (BASELINE: dense DP on chip, word search on host); the
production path is the C++ twin (``craft_otf_decode`` in native/fst.cpp via
decode.fst_native), held to this reference implementation in
tests/unit/test_otf.py.  With no beam it is exact: equal weight to the
offline composed shortest path.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from asr_craft_tpu_torch.decode.fst import Fst, compose, lexicon_fst

_FINITE = -1e29          # potentials below this are semiring zeros


def build_search_graph(lexicon: Dict[str, List[int]], words: List[str],
                       lm: Optional[Fst] = None, lm_weight: float = 1.0,
                       backend: str = "auto") -> Fst:
    """Phone-input word-output search graph G = lexicon [o LM] (weights of
    the LM scaled by ``lm_weight``) for :func:`otf_decode_words`."""
    import dataclasses

    from asr_craft_tpu_torch.decode.fst import get_backend
    g = lexicon_fst(lexicon, words)
    if lm is not None:
        if lm_weight != 1.0:
            lm = dataclasses.replace(lm, weight=lm.weight * lm_weight,
                                     final=lm.final * lm_weight)
        g = get_backend(backend).compose(g, lm)
    return g


def _prune(tokens: dict, beam_threshold, max_active, phi=None):
    """Beam pruning.  ``phi``: lookahead — an array of per-lexicon-state
    potentials (:func:`lm_lookahead_potentials`), or a callable
    ``phi(token_key) -> float`` (the exact per-history lookahead).  When
    given, the PRUNING key is ``score + phi`` — charging the upcoming
    word's LM cost before the word boundary; stored scores (and
    therefore the decoded path and weight) are untouched."""
    if not tokens:
        return tokens
    items = list(tokens.items())
    floor = getattr(phi, "la_floor", None) if callable(phi) else None
    if (floor is not None and beam_threshold is not None
            and len(items) > 8):
        # lazy two-pass: phi >= floor, so key >= sc + floor.  Seed the
        # bound with the key of the min-sc token (k0 >= the true best
        # key), then skip phi entirely for tokens provably outside the
        # beam on raw score — exact, and phi (an RMQ + memo) is only
        # evaluated near the beam.
        k0_kv = min(items, key=lambda kv: kv[1][0])
        k0 = k0_kv[1][0] + phi(k0_kv[0])
        lim = k0 + beam_threshold
        best = k0
        pairs = []
        for kv in items:
            sc = kv[1][0]
            if sc + floor > lim:
                continue               # key >= sc+floor > best+threshold
            ky = sc + phi(kv[0])
            if ky < best:
                best = ky
            pairs.append((ky, kv))
        cut = best + beam_threshold
        pairs = [(ky, kv) for ky, kv in pairs if ky <= cut]
    else:
        if phi is None:                 # keys computed ONCE per token
            keys = [e[0] for _, e in items]
        elif callable(phi):
            keys = [e[0] + phi(k) for k, e in items]
        else:
            keys = [e[0] + phi[k[1]] for k, e in items]
        pairs = list(zip(keys, items))
        if beam_threshold is not None:
            cut = min(keys) + beam_threshold
            pairs = [(ky, kv) for ky, kv in pairs if ky <= cut]
    if max_active is not None and len(pairs) > max_active:
        pairs = heapq.nsmallest(max_active, pairs, key=lambda p: p[0])
    return dict(kv for _, kv in pairs)


def lm_lookahead_potentials(lex: Fst, lm: Fst,
                            lm_weight: float = 1.0) -> np.ndarray:
    """Per-lexicon-state NEXT-WORD lookahead potentials (the weight
    pushing the reference decoder class carries in its lexical tree —
    VERDICT r4 missing #1).

    ``phi[s]`` = min over completions of the word pending at trie state
    ``s`` (paths s -> root) of the remaining lexicon arc weights plus an
    ADMISSIBLE lower bound ``lb(w)`` on the LM cost of the word emitted:
    lb(w) = (most favourable epsilon-closure prefix) + (min explicit LM
    arc weight for w), which lower-bounds ``advance(u, w)`` for every
    history u.  phi[root] = 0 (no pending word).  Adding phi to the
    PRUNING key makes tight beams behave like wide ones: a token heading
    toward an improbable word is charged for it before the word
    boundary.  Branches whose words the LM cannot emit get +inf (they
    could never complete — pruning them early is consistent).  Path
    scores are unchanged, so with no beam the decode stays exact."""
    from asr_craft_tpu_torch.decode.fst import eps_closure
    clos = eps_closure(lm)
    minw: Dict[int, float] = {}
    for j in range(lm.num_arcs):
        il = int(lm.ilabel[j])
        if il:
            w = float(lm.weight[j])
            if il not in minw or w < minw[il]:
                minw[il] = w
    closmin = 0.0
    for s in range(lm.num_states):
        for _, w2 in clos[s]:
            closmin = min(closmin, float(w2))
    lb = {w: lm_weight * (closmin + mw) for w, mw in minw.items()}

    out: Dict[int, List[int]] = {}
    for j in range(lex.num_arcs):
        out.setdefault(int(lex.src[j]), []).append(j)
    root = lex.start
    phi = np.full(lex.num_states, np.inf)
    phi[root] = 0.0
    for s in reversed(_trie_order(lex)):  # children before parents
        if s == root:
            continue
        best = np.inf
        for j in out.get(s, ()):
            d = int(lex.dst[j])
            w = float(lex.weight[j])
            ol = int(lex.olabel[j])
            if ol:
                w += lb.get(ol, np.inf)
            cont = 0.0 if d == root else phi[d]
            best = min(best, w + cont)
        phi[s] = best
    return phi


def _trie_order(lex: Fst) -> List[int]:
    """DFS preorder of the lexicon trie from the root (word arcs back to
    the root are terminal) — reversed, it visits children before
    parents."""
    out: Dict[int, List[int]] = {}
    for j in range(lex.num_arcs):
        out.setdefault(int(lex.src[j]), []).append(j)
    order: List[int] = []
    seen = {lex.start}
    stack = [lex.start]
    while stack:
        s = stack.pop()
        order.append(s)
        for j in out.get(s, ()):
            d = int(lex.dst[j])
            if d not in seen:
                seen.add(d)
                stack.append(d)
    return order


def make_exact_lookahead(lex: Fst, lm: Fst, lm_weight: float = 1.0):
    """Reusable exact-lookahead callable for the python decoder: carries
    its tables and memo ACROSS calls, so a CLI decoding many utterances
    builds the interval/RMQ structure once per corpus.  Pass the result
    as ``lookahead=`` to :func:`otf_decode_words_dynamic` with
    ``backend='py'`` (the native backend builds its own tables in
    C++)."""
    return _exact_lookahead(lex, lm, lm_weight)


def _exact_lookahead(lex: Fst, lm: Fst, lm_weight: float = 1.0):
    """EXACT per-history LM lookahead as interval range-min queries —
    ``la(u, s)`` = min over completions of the word pending at trie
    state s of (remaining lexicon weights + the ACTUAL LM cost
    ``advance(u, w)``).  Added to the pruning key, this makes the beam
    rank tokens by their true best next-word-completed score (A*-style
    f-value) — the full-lookahead upgrade of the context-independent
    :func:`lm_lookahead_potentials` (which lower-bounds over ALL
    histories and blurs deep in the trie).

    Design (r5, replacing the lazy per-(u, s) recursion whose cache
    miss on a root-adjacent state walked the WHOLE subtree per history
    — measured 0.24 utts/s vs 4.5 without lookahead at 5k words):

    - A DFS over the lexicon's NON-emitting arcs orders the
      word-emitting ("leaf") arcs so every trie state's reachable words
      form one contiguous leaf interval ``[lo[s], hi[s])`` (the trie is
      a tree — :func:`asr_craft_tpu_torch.decode.fst.lexicon_fst`).
    - Per LM state v, the explicit word arcs — expanded per
      pronunciation leaf, sorted by leaf index, with value = lexicon
      root->leaf path cost + lm_weight * arc weight — carry a
      sparse-table RMQ (levels[k][i] = min over val[i : i + 2^k]).
    - ``la(u, s) = min over (v, cw) in eps-closure(u) of
      (lm_weight * cw + rangemin_v(lo[s], hi[s])) - pref[s]``:
      min commutes over the closure paths, so this equals the old
      recursion exactly, at O(|closure| * log) per query with NO
      per-history precompute at all.

    Falls back to the recursive form when the non-emitting arcs are not
    a tree (shared suffixes / cycles — never produced by
    ``lexicon_fst``)."""
    from asr_craft_tpu_torch.decode.fst import eps_closure
    root = lex.start
    tree: Dict[int, List[Tuple[int, float]]] = {}
    emit: Dict[int, List[Tuple[int, float]]] = {}
    for j in range(lex.num_arcs):
        s, d = int(lex.src[j]), int(lex.dst[j])
        w, ol = float(lex.weight[j]), int(lex.olabel[j])
        if ol:
            emit.setdefault(s, []).append((ol, w))
        else:
            tree.setdefault(s, []).append((d, w))

    pref = np.zeros(lex.num_states)
    lo = np.zeros(lex.num_states, np.int64)
    hi = np.zeros(lex.num_states, np.int64)
    leaf_word: List[int] = []
    leaf_cost: List[float] = []
    seen = {root}

    def enter(s: int) -> None:
        lo[s] = len(leaf_word)
        for ol, w in emit.get(s, ()):
            leaf_word.append(ol)
            leaf_cost.append(pref[s] + w)

    enter(root)
    stack = [(root, iter(tree.get(root, ())))]
    while stack:
        s, it = stack[-1]
        nxt = next(it, None)
        if nxt is None:
            hi[s] = len(leaf_word)
            stack.pop()
            continue
        d, w = nxt
        if d in seen:                      # not a trie — fall back
            lm_adv, _ = _lm_closed(lm, lm_weight)
            return _exact_lookahead_lazy(lex, lm_adv)
        seen.add(d)
        pref[d] = pref[s] + w
        enter(d)
        stack.append((d, iter(tree.get(d, ()))))

    wleaf: Dict[int, List[int]] = {}
    for i, wd in enumerate(leaf_word):
        wleaf.setdefault(wd, []).append(i)
    leafc = np.asarray(leaf_cost)

    clos = eps_closure(lm)
    by_src: Dict[int, List[Tuple[int, float]]] = {}
    for j in range(lm.num_arcs):
        il = int(lm.ilabel[j])
        if il:
            by_src.setdefault(int(lm.src[j]),
                              []).append((il, float(lm.weight[j])))
    tables: Dict[int, Tuple[np.ndarray, List[np.ndarray]]] = {}

    def table_of(v: int):
        tb = tables.get(v)
        if tb is None:
            ent: List[Tuple[int, float]] = []
            for il, aw in by_src.get(v, ()):
                for e in wleaf.get(il, ()):
                    ent.append((e, float(leafc[e]) + lm_weight * aw))
            ent.sort()
            pos = np.array([e for e, _ in ent], np.int64)
            levels = [np.array([c for _, c in ent])]
            half = 1
            while 2 * half <= len(pos):
                p = levels[-1]
                levels.append(np.minimum(p[:-half], p[half:]))
                half *= 2
            tb = (pos, levels)
            tables[v] = tb
        return tb

    memo: Dict[Tuple[int, int], float] = {}

    def la_of(u: int, s: int) -> float:
        if s == root:
            return 0.0
        v = memo.get((u, s))
        if v is None:
            l, h = int(lo[s]), int(hi[s])
            best = np.inf
            for u2, w2 in clos[u]:
                pos, levels = table_of(int(u2))
                a = int(np.searchsorted(pos, l, "left"))
                b = int(np.searchsorted(pos, h, "left"))
                if b <= a:
                    continue
                k = (b - a).bit_length() - 1
                m = min(float(levels[k][a]), float(levels[k][b - (1 << k)]))
                c = lm_weight * float(w2) + m
                if c < best:
                    best = c
            v = best - float(pref[s])
            memo[(u, s)] = v
        return v

    fn = lambda key: la_of(key[2], key[1])
    # global lower bound on la (la_floor): lets _prune skip the RMQ for
    # tokens provably outside the beam on raw score (key >= sc + floor)
    if lm_weight >= 0:
        min_aw = min((aw for arcs in by_src.values() for _, aw in arcs),
                     default=0.0)
        min_cw = min((float(w2) for cl in clos.values() for _, w2 in cl),
                     default=0.0)
        min_leafc = float(leafc.min()) if len(leafc) else 0.0
        max_pref = float(pref.max()) if lex.num_states else 0.0
        fn.la_floor = min(0.0, lm_weight * (min_aw + min_cw)
                          + min_leafc - max_pref)
    return fn


def _exact_lookahead_lazy(lex: Fst, lm_adv):
    """Recursive fallback for non-trie lexicons (shared-suffix DAGs):
    per-(history, trie-state) memoized min over completions — correct
    everywhere, but a cache miss near the root walks the whole subtree
    per history."""
    out: Dict[int, List[Tuple[int, float, int]]] = {}
    for j in range(lex.num_arcs):
        out.setdefault(int(lex.src[j]), []).append(
            (int(lex.dst[j]), float(lex.weight[j]), int(lex.olabel[j])))
    root = lex.start
    memo: Dict[Tuple[int, int], float] = {}

    def la_of(u: int, s: int) -> float:
        if s == root:
            return 0.0
        v = memo.get((u, s))
        if v is not None:
            return v
        best = np.inf
        for d, w, ol in out.get(s, ()):
            if ol:
                a = lm_adv(u, ol)
                if a is None:
                    continue
                w = w + a[1]
            elif d != root:
                w = w + la_of(u, d)
            if w < best:
                best = w
        memo[(u, s)] = best
        return best

    return lambda key: la_of(key[2], key[1])


def otf_decode_words(log_phi_state, log_phi_trans, length, graph: Fst,
                     words: List[str], num_states: int = 1,
                     beam_threshold: Optional[float] = None,
                     max_active: Optional[int] = None,
                     backend: str = "auto"
                     ) -> Tuple[List[str], List[int], float]:
    """Beam word decode without lattice materialization.

    ``log_phi_state``: (T, L') potentials; ``graph``: phone-input search
    graph from :func:`build_search_graph`.  ``beam_threshold``: drop tokens
    more than this above the frame-best weight; ``max_active``: keep at
    most this many tokens per frame.  Both None = exact (equals the offline
    composed shortest path).  Returns (word seq, expanded-state frame path,
    weight).  Raises ValueError when no hypothesis survives (beam too
    narrow / lexicon cannot cover the utterance).
    """
    if backend != "py":
        from asr_craft_tpu_torch.decode import fst_native
        if fst_native.available() and hasattr(fst_native, "otf_decode"):
            return fst_native.otf_decode(
                log_phi_state, log_phi_trans, length, graph, words,
                num_states, beam_threshold, max_active)
        if backend == "native":
            raise RuntimeError("native fst backend not built")
    state = np.asarray(log_phi_state, np.float64)[:int(length)]
    trans = np.asarray(log_phi_trans, np.float64)
    T, L = state.shape
    phone_of = (np.arange(L) // num_states + 1).astype(np.int64)
    gi: Dict[Tuple[int, int], List[int]] = {}
    for j in range(graph.num_arcs):
        gi.setdefault((int(graph.src[j]), int(graph.ilabel[j])),
                      []).append(j)

    # per-frame token stores: (l, g) -> [weight, parent entry id, word]
    cur: dict = {}
    for l in range(L):
        if state[0, l] < _FINITE:
            continue
        base = -state[0, l]
        for j in gi.get((graph.start, int(phone_of[l])), ()):
            key = (l, int(graph.dst[j]))
            sc = base + float(graph.weight[j])
            e = cur.get(key)
            if e is None or sc < e[0]:
                cur[key] = [sc, -1, int(graph.olabel[j])]
    frames = [list(_prune(cur, beam_threshold, max_active).items())]

    for t in range(1, T):
        tr = trans if trans.ndim == 2 else trans[t]
        nxt: dict = {}
        for eid, ((l, g), (sc, _, _)) in enumerate(frames[-1]):
            arc_w = tr[l] + state[t]                       # (L,)
            for lp in range(L):
                if arc_w[lp] < _FINITE:
                    continue
                ns = sc - arc_w[lp]
                if phone_of[lp] == phone_of[l]:            # run continues
                    e = nxt.get((lp, g))
                    if e is None or ns < e[0]:
                        nxt[(lp, g)] = [ns, eid, 0]
                else:                                      # advance G
                    for j in gi.get((g, int(phone_of[lp])), ()):
                        key = (lp, int(graph.dst[j]))
                        s2 = ns + float(graph.weight[j])
                        e = nxt.get(key)
                        if e is None or s2 < e[0]:
                            nxt[key] = [s2, eid, int(graph.olabel[j])]
        frames.append(list(_prune(nxt, beam_threshold, max_active).items()))

    best = None
    for eid, ((l, g), (sc, _, _)) in enumerate(frames[-1]):
        f = float(graph.final[g])
        if np.isfinite(f) and (best is None or sc + f < best[0]):
            best = (sc + f, eid)
    if best is None:
        raise ValueError("otf_decode: no accepting hypothesis (beam too "
                         "narrow or lexicon cannot cover the utterance)")

    path, wids = [], []
    eid = best[1]
    for t in range(T - 1, -1, -1):
        (l, _), (_, parent, word) = frames[t][eid]
        path.append(int(l))
        if word:
            wids.append(int(word))
        eid = parent
    path.reverse()
    wids.reverse()
    return [words[w - 1] for w in wids], path, float(best[0])


# ---------------------------------------------------------------------------
# fully dynamic composition (WSJ-scale lexicons)
# ---------------------------------------------------------------------------

def _lm_closed(lm: Fst, lm_weight: float):
    """Memoized epsilon-closed LM advance: (state, word) -> (dst, weight),
    and the closed final-weight vector.  Backoff bigram LMs reach unseen
    continuations through their input-epsilon backoff arcs; the closure
    takes the min-weight path (explicit bigram vs backoff+unigram)."""
    from asr_craft_tpu_torch.decode.fst import eps_closure
    clos = eps_closure(lm)
    index: Dict[Tuple[int, int], List[int]] = {}
    for j in range(lm.num_arcs):
        il = int(lm.ilabel[j])
        if il:
            index.setdefault((int(lm.src[j]), il), []).append(j)
    finals = np.full(lm.num_states, np.inf)
    for s in range(lm.num_states):
        for s2, w2 in clos[s]:
            f = float(lm.final[s2])
            if np.isfinite(f):
                finals[s] = min(finals[s], w2 + f)
    memo: Dict[Tuple[int, int], Optional[Tuple[int, float]]] = {}

    def advance(u: int, word: int):
        key = (u, word)
        if key in memo:
            return memo[key]
        best = None
        for u2, w2 in clos[u]:
            for j in index.get((u2, word), ()):
                w = w2 + float(lm.weight[j])
                if best is None or w < best[1]:
                    best = (int(lm.dst[j]), w)
        if best is not None:
            best = (best[0], lm_weight * best[1])
        memo[key] = best
        return best

    return advance, finals * lm_weight


def otf_decode_words_dynamic(log_phi_state, log_phi_trans, length,
                             lex: Fst, words: List[str],
                             lm: Optional[Fst] = None,
                             lm_weight: float = 1.0,
                             num_states: int = 1,
                             beam_threshold: Optional[float] = None,
                             max_active: Optional[int] = None,
                             backend: str = "auto",
                             lookahead: bool = True
                             ) -> Tuple[List[str], List[int], float]:
    """Beam word decode with FULLY dynamic composition — no composed
    search graph is ever built.

    :func:`otf_decode_words` takes a pre-composed G = lexicon o LM, whose
    state space is the trie x history PRODUCT — ~135M pairs at a 5k-word
    lexicon with a bigram LM, unbuildable.  Here tokens carry the triple
    ``(expanded state l, lexicon state, LM state)``; the LM advances only
    when the lexicon emits a word (epsilon-closed, so pruned BACKOFF LMs
    — :func:`asr_craft_tpu_torch.decode.fst.backoff_bigram_lm_fst` — work
    directly).  This is the reference decoder's actual architecture
    (SURVEY.md §3.3: on-the-fly composition against dictionary/LM FST);
    memory is bounded by the live beam, not the graph product.  Exact
    (equal weight to the offline composed shortest path) when both beams
    are None; the C++ twin is ``craft_otf_decode_dynamic``
    (native/fst.cpp), held to this implementation in tests/unit/test_otf.

    ``lookahead`` (default on, r5): LM lookahead in the PRUNING key only
    — path scores unchanged, search error at tight beams sharply
    reduced.  ``True`` = EXACT per-history lookahead (lazy per-LM-state
    tables; the pruning key becomes the true best next-word-completed
    score); an ndarray = static per-trie-state potentials
    (:func:`lm_lookahead_potentials`); ``False`` = off.
    """
    static_phi = (np.asarray(lookahead, np.float64)
                  if isinstance(lookahead, np.ndarray) else None)
    if backend != "py" and not callable(lookahead):
        from asr_craft_tpu_torch.decode import fst_native
        if fst_native.available() and hasattr(fst_native,
                                              "otf_decode_dynamic"):
            return fst_native.otf_decode_dynamic(
                log_phi_state, log_phi_trans, length, lex, words, lm,
                lm_weight, num_states, beam_threshold, max_active,
                lookahead=(static_phi if static_phi is not None
                           else bool(lookahead and lm is not None)))
        if backend == "native":
            raise RuntimeError("native fst backend not built")
    state = np.asarray(log_phi_state, np.float64)[:int(length)]
    trans = np.asarray(log_phi_trans, np.float64)
    T, L = state.shape
    phone_of = (np.arange(L) // num_states + 1).astype(np.int64)
    # arcs grouped by SOURCE trie state: token expansion is ARC-driven
    # (a deep trie state has 1-3 continuations vs all phones)
    arcs_by_src: Dict[int, List[Tuple[int, int, float, int]]] = {}
    for j in range(lex.num_arcs):
        arcs_by_src.setdefault(int(lex.src[j]), []).append(
            (int(lex.ilabel[j]), int(lex.dst[j]), float(lex.weight[j]),
             int(lex.olabel[j])))
    if lm is not None:
        lm_adv, lm_fin = _lm_closed(lm, lm_weight)
        lm0 = lm.start
    else:
        lm_adv, lm_fin, lm0 = None, None, 0
    if static_phi is not None:
        phi = static_phi
    elif callable(lookahead):
        phi = lookahead                 # make_exact_lookahead (memo shared)
    elif lookahead and lm is not None:
        phi = _exact_lookahead(lex, lm, lm_weight)
    else:
        phi = None

    def expand_arcs(store, lexs, lms, ph, w_lp, sc, parent):
        """ARC-driven: take each out-arc of trie state ``lexs`` whose
        phone q differs from the token's phone ``ph`` (q == ph would
        continue the frame run instead), relaxing every expanded state
        of q — the same relaxation set as the per-destination-label
        form, at out-degree * ns iterations instead of L.  ``w_lp``:
        per-destination acoustic+transition weight vector."""
        for q, dst, aw, word in arcs_by_src.get(lexs, ()):
            if q == ph or q < 1 or q * num_states > L:
                continue
            sc2 = sc + aw
            lm2 = lms
            if word and lm_adv is not None:
                a = lm_adv(lms, word)
                if a is None:
                    continue
                lm2, lw = a
                sc2 += lw
            for lp in range((q - 1) * num_states, q * num_states):
                w = w_lp[lp]
                if w < _FINITE:
                    continue
                key = (lp, dst, lm2)
                s3 = sc2 - w
                e = store.get(key)
                if e is None or s3 < e[0]:
                    store[key] = [s3, parent, word]

    cur: dict = {}
    expand_arcs(cur, lex.start, lm0, 0, state[0], 0.0, -1)
    frames = [list(_prune(cur, beam_threshold, max_active, phi).items())]

    for t in range(1, T):
        tr = trans if trans.ndim == 2 else trans[t]
        st_t = state[t]
        nxt: dict = {}
        for eid, ((l, lexs, lms), (sc, _, _)) in enumerate(frames[-1]):
            arc_w = tr[l] + st_t
            ph = int(phone_of[l])
            for lp in range((ph - 1) * num_states, ph * num_states):
                w = arc_w[lp]                      # run continues
                if w < _FINITE:
                    continue
                key = (lp, lexs, lms)
                ns = sc - w
                e = nxt.get(key)
                if e is None or ns < e[0]:
                    nxt[key] = [ns, eid, 0]
            expand_arcs(nxt, lexs, lms, ph, arc_w, sc, eid)
        frames.append(list(_prune(nxt, beam_threshold, max_active,
                                  phi).items()))

    best = None
    for eid, ((l, lexs, lms), (sc, _, _)) in enumerate(frames[-1]):
        f = float(lex.final[lexs])
        if not np.isfinite(f):
            continue
        tot = sc + f
        if lm_fin is not None:
            if not np.isfinite(lm_fin[lms]):
                continue
            tot += float(lm_fin[lms])
        if best is None or tot < best[0]:
            best = (tot, eid)
    if best is None:
        raise ValueError("otf_decode_dynamic: no accepting hypothesis "
                         "(beam too narrow or lexicon cannot cover the "
                         "utterance)")

    path, wids = [], []
    eid = best[1]
    for t in range(T - 1, -1, -1):
        (l, _, _), (_, parent, word) = frames[t][eid]
        path.append(int(l))
        if word:
            wids.append(int(word))
        eid = parent
    path.reverse()
    wids.reverse()
    return [words[w - 1] for w in wids], path, float(best[0])
