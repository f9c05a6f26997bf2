"""Time-axis sharding of the DP recursions (the lattice-sharded decode).

Counterpart of :mod:`asr_craft_tpu.parallel.timeshard`, the same names,
arguments and contracts.  It rests on the associativity of the semiring
matrix product: with per-frame transfer matrices

    M_0[p, l] = state[0][l] if p == 0 else NEG_INF     (virtual start)
    M_t[p, l] = trans[p, l] + state[t][l]              (1 <= t < length)
    M_t       = the semiring identity                  (t >= length)

the alpha recursion is the prefix product ``e_0 (x) M_0 (x) ... (x) M_t``.
The time axis is cut into N chunks of ``T / N`` frames, and each chunk

1. reduces its frames to one (B, L, L) transfer matrix
   (:func:`_local_chunk_product`, or :func:`_pruned_chunk_product` in the
   survivor space of ``beam_labels``),
2. gathers every chunk's matrix and prefix-multiplies them into its
   boundary alpha (:func:`_boundary_alphas`); logZ falls out here,
3. runs the vector recursion from that alpha over its own frames
   (:func:`_local_vector_scan`).

The Viterbi traceback is sequential right to left: each chunk needs only
the label at its right neighbour's first frame.

Two layouts share these per-chunk functions (:func:`time_mesh` says which
runs):

- (i) one device, the N chunks along a leading axis, the counterpart of the
  JAX N-device mesh on one host: the gather is the stacked products, and
  the label chain a loop over chunks, rightmost first;
- (ii) a process group of N ranks, one chunk each: ``dist.all_gather`` of
  the (B, L, L) products, the label chain by ``dist.send`` / ``dist.recv``
  of (B,) labels, and the path gathered at the end.

The chunk product is plain PyTorch, as the JAX package computes it in XLA
outside any Pallas kernel.  It is contracted in blocks of the summed index
k, the semiring sum carried across blocks, so no intermediate holds more
than ``_BLOCK_BYTES``: the whole ``prod[:, :, :, None] + M[:, None, :, :]``
of the JAX code would be B * L**3 floats a chunk and frame.  Step 1 costs
O(T L^3) where the unsharded scan costs O(T L^2), so exact time sharding
does more work than the unsharded decode; ``beam_labels`` K brings step 1
to O(T K^3).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from asr_craft_tpu_torch.ops.semiring import (LOG, NEG_INF, TROPICAL,
                                              get_semiring)

__all__ = ["time_mesh", "sharded_log_partition", "sharded_viterbi",
           "survivor_mask", "sharded_decode"]

# the largest intermediate of a blocked semiring product (bytes)
_BLOCK_BYTES = 256 << 20


@dataclasses.dataclass(frozen=True)
class TimeMesh:
    """N time chunks: layout (i), all on ``device``, or (``distributed``)
    layout (ii), one chunk a rank of the default process group (``rank``:
    this rank's chunk)."""

    n: int
    device: torch.device
    distributed: bool = False
    rank: int = 0


def time_mesh(n_devices: Optional[int] = None, device="cuda",
              distributed: bool = False) -> TimeMesh:
    """The time axis of N chunks.  Layout (i) (the default): all N chunks
    on ``device``, the card unless the caller asks for the CPU (raises
    without one).  ``distributed``: layout (ii), one chunk a rank of the
    initialised default group, on the rank's device; raises unless N
    (default: the world's size) equals the world's size."""
    if distributed:
        if not dist.is_initialized():
            raise RuntimeError("time_mesh(distributed=True): "
                               "torch.distributed is not initialised")
        world = dist.get_world_size()
        n = world if n_devices is None else n_devices
        if n != world:
            raise ValueError(f"time_mesh({n}, distributed=True): layout (ii) "
                             f"runs one chunk a rank, and the world has "
                             f"{world}")
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        return TimeMesh(n, dev, True, dist.get_rank())
    if n_devices is None or n_devices < 1:
        raise ValueError(f"time_mesh({n_devices}): give the number of "
                         "chunks")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"time_mesh(device={dev}): no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return TimeMesh(n_devices, dev)


# ---------------------------------------------------------------------------
# Per-chunk functions.  A chunk-stacked tensor has a leading axis of C chunks
# (N in layout (i), 1 in layout (ii)); ``offsets (C,)`` are the chunks'
# first global frames.
# ---------------------------------------------------------------------------

def _combine(sr, acc, blk):
    """``acc (+) blk``, the semiring sum of two partial results."""
    if acc is None:
        return blk
    if sr.name == "tropical":
        return torch.maximum(acc, blk)
    return sr.sum(torch.stack([acc, blk]), dim=0)


def _semiring_bmm(sr, a, b):
    """Batched semiring product ``out[n, i, j] = sum_k(a[n, i, k] + b[n, k,
    j])`` of ``a (N, I, K)`` and ``b (N, K, J)``, in blocks of k whose
    ``(N, I, kb, J)`` sums stay under ``_BLOCK_BYTES``."""
    N, I, K = a.shape
    J = b.shape[-1]
    kb = max(1, min(K, _BLOCK_BYTES // max(1, N * I * J * a.element_size())))
    acc = None
    for k0 in range(0, K, kb):
        x = a[:, :, k0:k0 + kb, None] + b[:, None, k0:k0 + kb, :]
        acc = _combine(sr, acc, sr.sum(x, dim=2))
    return acc


def _eye(n, L, dtype, device):
    """``n`` semiring identities (0 on the diagonal, NEG_INF off it)."""
    eye = torch.full((L, L), NEG_INF, dtype=dtype, device=device)
    eye.fill_diagonal_(0.0)
    return eye.expand(n, L, L)


def _frame_valid(offsets, j, lengths):
    """(C * B,) whether global frame ``offsets + j`` lies inside each
    row."""
    g = offsets[:, None] + j
    return (g < lengths[None, :]).reshape(-1)


def _local_chunk_product(state_c, trans, lengths, offsets, sr):
    """Reduce each chunk to one transfer matrix: ``state_c (C, B, Tl, L)``
    -> ``(C, B, L, L)``."""
    C, B, Tl, L = state_c.shape
    S = state_c.reshape(C * B, Tl, L)
    prod = _eye(C * B, L, state_c.dtype, state_c.device)
    rows = torch.arange(L, device=state_c.device)
    for j in range(Tl):
        st = S[:, j]
        M = trans[None] + st[:, None, :]
        if j == 0:                  # the virtual start, at global frame 0
            start = (offsets == 0).repeat_interleave(B)
            M0 = torch.where(rows[None, :, None] == 0, st[:, None, :],
                             NEG_INF)
            M = torch.where(start[:, None, None], M0, M)
        new = _semiring_bmm(sr, prod, M)
        prod = torch.where(_frame_valid(offsets, j, lengths)[:, None, None],
                           new, prod)
    return prod.reshape(C, B, L, L)


def _local_vector_scan(state_c, trans, lengths, offsets, alpha_in, sr):
    """The vector recursion over each chunk from its boundary alpha
    ``alpha_in (C, B, L)``.  Returns alphas (deltas) ``(C, B, Tl, L)``."""
    C, B, Tl, L = state_c.shape
    S = state_c.reshape(C * B, Tl, L)
    alpha = alpha_in.reshape(C * B, L)
    out = []
    for j in range(Tl):
        st = S[:, j]
        new = sr.sum(alpha[:, :, None] + trans[None], dim=1) + st
        if j == 0:
            start = (offsets == 0).repeat_interleave(B)
            new = torch.where(start[:, None], st, new)
        alpha = torch.where(_frame_valid(offsets, j, lengths)[:, None], new,
                            alpha)
        out.append(alpha)
    return torch.stack(out, dim=1).reshape(C, B, Tl, L)


def _boundary_alphas(prods, sr):
    """``prods (N, B, L, L)``, every chunk's product in order.  Returns
    (alpha_in (N, B, L), the alpha entering each chunk; alpha_final (B, L),
    after all of them)."""
    N, B, L, _ = prods.shape
    a = torch.full((B, L), NEG_INF, dtype=prods.dtype, device=prods.device)
    a[:, 0] = 0.0
    ins = []
    for j in range(N):
        ins.append(a)
        a = sr.sum(a[:, :, None] + prods[j], dim=1)
    return torch.stack(ins), a


def _chunk_survivors(state_c, lengths, offsets, K: int):
    """Each (chunk, row)'s K surviving labels by peak state over the
    chunk's valid frames: ``(C, B, K)`` int64, ascending.  Among equal
    peaks the lower label survives first, as ``lax.top_k`` takes them: a
    stable descending sort (``torch.topk`` promises no order on ties)."""
    C, B, Tl, L = state_c.shape
    g = offsets[:, None] + torch.arange(Tl, device=state_c.device)[None, :]
    valid = g[:, None, :] < lengths[None, :, None]              # (C, B, Tl)
    peak = torch.where(valid[..., None], state_c, NEG_INF).amax(dim=2)
    order = torch.sort(peak, dim=-1, descending=True, stable=True).indices
    return torch.sort(order[..., :K], dim=-1).values


def _survivor_onehot(surv, L):
    """(C, B, L) bool: the survivor sets ``surv (C, B, K)`` as masks."""
    m = torch.zeros((*surv.shape[:-1], L), dtype=torch.bool,
                    device=surv.device)
    return m.scatter_(-1, surv, True)


def _pruned_chunk_product(state_c, trans, lengths, offsets, sr, surv):
    """Each chunk's transfer product restricted to its survivors ``surv (C,
    B, K)``, expanded back to ``(C, B, L, L)`` (non-survivor columns are
    semiring zeros).  The first factor keeps its rows in the full label
    space: a row is the label before the chunk, in the previous chunk's
    survivor domain."""
    C, B, Tl, L = state_c.shape
    K = surv.shape[-1]
    CB = C * B
    S = state_c.reshape(CB, Tl, L)
    sv = surv.reshape(CB, K)
    state_k = torch.gather(S, 2, sv[:, None, :].expand(CB, Tl, K))
    trans_kk = trans[sv[:, :, None], sv[:, None, :]]            # (CB, K, K)
    inner = _eye(CB, K, state_c.dtype, state_c.device)
    for j in range(1, Tl):
        M = trans_kk + state_k[:, j][:, None, :]
        new = _semiring_bmm(sr, inner, M)
        inner = torch.where(
            _frame_valid(offsets, j, lengths)[:, None, None], new, inner)
    first = state_k[:, 0][:, None, :]                           # (CB, 1, K)
    Mf = trans[:, sv].permute(1, 0, 2) + first                  # (CB, L, K)
    start = (offsets == 0).repeat_interleave(B)
    Mf = torch.where(start[:, None, None], first.expand(CB, L, K), Mf)
    comp = _semiring_bmm(sr, Mf, inner)                         # (CB, L, K)
    full = torch.full((CB, L, L), NEG_INF, dtype=comp.dtype,
                      device=comp.device)
    full.scatter_(2, sv[:, None, :].expand(CB, L, K), comp)
    live = _frame_valid(offsets, 0, lengths)[:, None, None]
    out = torch.where(live, full, _eye(CB, L, comp.dtype, comp.device))
    return out.reshape(C, B, L, L)


def survivor_mask(state, lengths, n_chunks: int, K: int):
    """``(B, T, L)`` bool: the label-survivor sets the pruned sharded decode
    uses, materialised for the unsharded reference path (a test utility:
    the sharded path never builds it)."""
    B, T, L = state.shape
    Tl = T // n_chunks
    chunks = state[:, :n_chunks * Tl].reshape(B, n_chunks, Tl, L)
    offsets = torch.arange(n_chunks, device=state.device) * Tl
    surv = _chunk_survivors(chunks.transpose(0, 1),
                            lengths.to(state.device), offsets, K)
    onehot = _survivor_onehot(surv, L)                          # (N, B, L)
    return onehot.transpose(0, 1)[:, :, None, :].expand(
        B, n_chunks, Tl, L).reshape(B, n_chunks * Tl, L)


# ---------------------------------------------------------------------------
# The two layouts.
# ---------------------------------------------------------------------------

def _chunks(state, mesh: TimeMesh):
    """``(state_c (C, B, Tl, L), offsets (C,))``: every chunk in layout
    (i), the rank's own in layout (ii)."""
    B, T, L = state.shape
    if T % mesh.n:
        raise ValueError(f"T={T} does not divide into {mesh.n} chunks")
    Tl = T // mesh.n
    dev = state.device
    if mesh.distributed:
        chunk = state[:, mesh.rank * Tl:(mesh.rank + 1) * Tl]
        return chunk[None], torch.tensor([mesh.rank * Tl], device=dev)
    state_c = state.reshape(B, mesh.n, Tl, L).transpose(0, 1)
    return state_c, torch.arange(mesh.n, device=dev) * Tl


def _gather_products(prod, mesh: TimeMesh):
    """(N, B, L, L): every chunk's product, in chunk order."""
    if not mesh.distributed:
        return prod
    parts = [torch.empty_like(prod[0]) for _ in range(mesh.n)]
    dist.all_gather(parts, prod[0].contiguous())
    return torch.stack(parts)


def _inputs(state, trans, lengths, mesh):
    dev = mesh.device
    return (state.to(dev), trans.to(dev),
            lengths.to(device=dev, dtype=torch.int64))


def sharded_log_partition(state, trans, lengths, mesh: TimeMesh,
                          semiring=LOG):
    """logZ (``LOG``) or the best path's score (``TROPICAL``) of ``state
    (B, T, L)``, ``trans (L, L)``, with the time axis cut into the mesh's N
    chunks (T must divide by N).  ``(B,)`` on the mesh's device, the same on
    every rank in layout (ii).  A row of length 0 gives 0 (the semiring
    sum of the start vector), as in the JAX package, where the unsharded
    recursion reads frame 0."""
    sr = get_semiring(semiring)
    state, trans, lengths = _inputs(state, trans, lengths, mesh)
    state_c, offsets = _chunks(state, mesh)
    prod = _local_chunk_product(state_c, trans, lengths, offsets, sr)
    _, a_final = _boundary_alphas(_gather_products(prod, mesh), sr)
    return sr.sum(a_final, dim=-1)


def _traceback_chunk(deltas, trans, lengths, offset, last, lab_in):
    """One chunk's labels right to left from ``lab_in``, the label at the
    next chunk's first frame: ``deltas (B, Tl, L)`` -> ``(path (B, Tl),
    the label at its first frame)``.  ``lab[g] = last`` for ``g >= length
    - 1``, else the first ``argmax_p(delta[g][p] + trans[p,
    lab[g + 1]])``."""
    B, Tl, L = deltas.shape
    lab, ends = lab_in, lengths - 1 - offset
    out = [None] * Tl
    for j in range(Tl - 1, -1, -1):
        x = deltas[:, j] + trans[:, lab].T
        best = torch.argmax(x, dim=-1)
        lab = torch.where(ends <= j, last, best)
        out[j] = lab
    return torch.stack(out, dim=1), lab


def sharded_viterbi(state, trans, lengths, mesh: TimeMesh,
                    beam_labels: Optional[int] = None):
    """Viterbi with the time axis cut into the mesh's N chunks (T must
    divide by N).  Returns ``(path (B, T) int32, score (B,))`` on the mesh's
    device (the whole path on every rank in layout (ii)); frames past a
    row's length repeat its final label.

    ``beam_labels`` K < L: each chunk keeps the K labels of highest peak
    state over its valid frames, and its product runs in that survivor
    space.  The result equals the unsharded decode on the lattice masked by
    :func:`survivor_mask` exactly."""
    sr = TROPICAL
    state, trans, lengths = _inputs(state, trans, lengths, mesh)
    B, T, L = state.shape
    state_c, offsets = _chunks(state, mesh)
    if beam_labels is not None and beam_labels < L:
        surv = _chunk_survivors(state_c, lengths, offsets, beam_labels)
        prod = _pruned_chunk_product(state_c, trans, lengths, offsets, sr,
                                     surv)
        state_c = torch.where(_survivor_onehot(surv, L)[:, :, None, :],
                              state_c, NEG_INF)
    else:
        prod = _local_chunk_product(state_c, trans, lengths, offsets, sr)
    ins, a_final = _boundary_alphas(_gather_products(prod, mesh), sr)
    alpha_in = ins[mesh.rank:mesh.rank + 1] if mesh.distributed else ins
    deltas = _local_vector_scan(state_c, trans, lengths, offsets, alpha_in,
                                sr)
    score, last = a_final.max(dim=-1)
    Tl = T // mesh.n

    if mesh.distributed:
        lab_in = torch.zeros_like(last)
        if mesh.rank < mesh.n - 1:
            dist.recv(lab_in, mesh.rank + 1)
        path_loc, lab_first = _traceback_chunk(
            deltas[0], trans, lengths, mesh.rank * Tl, last, lab_in)
        if mesh.rank > 0:
            dist.send(lab_first.contiguous(), mesh.rank - 1)
        parts = [torch.empty_like(path_loc) for _ in range(mesh.n)]
        dist.all_gather(parts, path_loc.contiguous())
        path = torch.cat(parts, dim=1)
    else:
        lab, parts = torch.zeros_like(last), [None] * mesh.n
        for c in range(mesh.n - 1, -1, -1):         # rightmost chunk first
            parts[c], lab = _traceback_chunk(deltas[c], trans, lengths,
                                             c * Tl, last, lab)
        path = torch.cat(parts, dim=1)
    # frames past a row's length repeat its final label (ops.viterbi)
    t = torch.arange(T, device=state.device)[None, :]
    path = torch.where(t < lengths[:, None], path, last[:, None])
    return path.to(torch.int32), score


def sharded_decode(cfg, params, feats, lengths, n_shards: int,
                   beam_labels: Optional[int] = None, sparse=None,
                   device="cuda", mesh: Optional[TimeMesh] = None):
    """Config 5's lattice-sharded decode (``cli.decode --time_shard N
    [--shard_beam_labels K]``): potentials -> boundary-masked state ->
    :func:`sharded_viterbi` over ``n_shards`` time chunks -> per-frame
    phones.  Returns ``(phone_frames (B, T), state_paths (B, T), scores
    (B,))``, the ``models.crf.decode`` contract: equal to the unsharded
    decode, or with ``beam_labels`` to the unsharded decode on the
    survivor-masked lattice.

    Runs layout (i) on ``device``, the card unless the caller asks for the
    CPU, or on ``mesh`` where one is given (layout (ii):
    ``time_mesh(n_shards, distributed=True)``).  Frame-dependent-transition
    configs raise ``ValueError``: their factored planes carry no (L', L')
    matrix to reduce.  A sparse feature map is densified first.  T is
    padded up to a multiple of ``n_shards`` (padding frames are inert:
    every recursion gates on ``lengths``).  A row of length 0 (the
    loader's padding) scores 0 with label 0 throughout, as in the JAX
    package, where the unsharded decode scores frame 0's best state."""
    from asr_craft_tpu_torch.models.crf import apply_boundaries
    from asr_craft_tpu_torch.models.feature_map import (dense_potentials,
                                                        densify_sparse)
    if cfg.fmap.frame_dependent_trans:
        raise ValueError(
            "time-sharded decode needs a frame-independent (L', L') "
            "transition matrix; frame-dependent-transition configs "
            "(trans_range non-empty) decode on the factored fdt path")
    mesh = mesh or time_mesh(n_shards, device)
    if mesh.n != n_shards:
        raise ValueError(f"sharded_decode({n_shards}) on a mesh of "
                         f"{mesh.n} chunks")
    dev = mesh.device
    params = {k: v.to(dev) for k, v in params.items()}
    if sparse is not None:
        feats = densify_sparse(sparse[0].to(dev), sparse[1].to(dev),
                               cfg.feat_dim)
    state, trans = dense_potentials(cfg.fmap, params, feats.to(dev))
    if cfg.num_states > 1:
        trans = trans + torch.from_numpy(
            cfg.topology.transition_penalty()).to(dev)
    lengths = lengths.to(dev)
    state = apply_boundaries(cfg, state, lengths)
    B, T, L = state.shape
    Tp = -(-T // n_shards) * n_shards
    if Tp != T:
        state = torch.nn.functional.pad(state, (0, 0, 0, Tp - T))
    path, score = sharded_viterbi(state, trans, lengths, mesh,
                                  beam_labels=beam_labels)
    path = path[:, :T]
    return cfg.topology.path_to_phones(path), path, score
