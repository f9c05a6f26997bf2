"""The comparisons that decide ``correct``: what the timed path produced
against the plain reference (``reference/``), worked out again from the
same weights and frames.  Each returns ``{name: number}``; the cell's
``limits/<workload>.json`` holds each number's limit.

Training: from the program's parameters before and after the checked
steps, their losses and gradient norms.  Each gap is relative: a loss and a
gradient norm against the reference's; a leaf's change as the gap between
the program's norm of it and the reference's, over the reference's norm
of that leaf or of the median leaf, whichever is larger.  A leaf whose
reference gradient is under a thousandth of the median leaf's is left out
(round-off alone moves it).
"""
from __future__ import annotations

import numpy as np
import torch

from crfbench.reference import crf as ref_crf
from crfbench.reference import scrf as ref_scrf

DT = torch.float64


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.to(DT))) for k, v in
            tree.items()}


def leaf_gap(prog: dict, ref: dict, keep) -> float:
    """The worst leaf's gap of norms: ``prog`` and ``ref`` map leaves to
    their norms."""
    med = float(np.median([ref[k] for k in keep]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-300)
               for k in keep)


def reference_train(params0: dict, batches: list, lr: float, model: dict,
                    device) -> dict:
    """Follow SGD steps of the reference from ``params0``, one a batch of
    ``batches``, each step's loss its batch's summed NLL over its frames.
    Returns the losses, the gradient norms, the first gradient and the
    parameters after each step (float64)."""
    ns = model["num_states"]
    sr = model.get("state_range")
    tr = tuple(model.get("trans_range", (0, 0)))
    p = {k: v.to(device, DT).clone() for k, v in params0.items()}
    losses, gnorms, after, first = [], [], [], None
    for b in batches:
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        nll_sum, _, frames = ref_crf.loss(leaves, b["feats"].to(device),
                                          b["labels"].to(device),
                                          b["lengths"].to(device), ns, sr,
                                          tr)
        loss = nll_sum / frames
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()), allow_unused=True)))
        grads = {k: torch.zeros_like(p[k]) if g is None else g
                 for k, g in grads.items()}
        losses.append(float(loss.detach()))
        gnorms.append(float(torch.sqrt(sum((g * g).sum()
                                           for g in grads.values()))))
        if first is None:
            first = grads
        p = {k: v - lr * grads[k] for k, v in p.items()}
        after.append(p)
    return {"losses": losses, "grad_norms": gnorms, "first_grad": first,
            "params": after}


def train_numbers(obs: dict, ref: dict) -> dict:
    """The training cells' numbers.  ``obs``: the program's ``params0``,
    ``params_after`` (after the checked steps), ``losses`` and
    ``grad_norms`` a step."""
    ref_g = _norms(ref["first_grad"])
    med = float(np.median(list(ref_g.values())))
    keep = [k for k, v in ref_g.items() if v >= 1e-3 * med]
    p0 = {k: v.to(DT) for k, v in obs["params0"].items()}
    dprog = _norms({k: obs["params_after"][k].to(DT) - p0[k] for k in p0})
    dref = _norms({k: ref["params"][-1][k].cpu() - p0[k] for k in p0})
    lp = np.asarray(obs["losses"], np.float64)
    lr_ = np.asarray(ref["losses"], np.float64)
    gp = np.asarray(obs["grad_norms"], np.float64)
    gr = np.asarray(ref["grad_norms"], np.float64)
    out = {"loss_gap": float(np.max(np.abs(lp - lr_) / np.abs(lr_))),
           "grad_norm_gap": float(np.max(np.abs(gp - gr) / gr)),
           "change_gap": leaf_gap(dprog, dref, keep)}
    return out


def _rel(gap, scale):
    """``|gap|`` over ``|scale|``, at least 1."""
    return gap.abs() / scale.abs().clamp(min=1.0)


def crf_decode_numbers(params: dict, batches: list, results: list,
                       model: dict, device) -> dict:
    """The linear-chain decode: over the sampled batches' rows, the
    widest gap by which a served path's reference score lies below the
    reference's best (``path_gap``), and the widest gap between the score
    the program reported and its path's reference score (``score_gap``);
    both over the best score's magnitude (at least 1)."""
    ns = model["num_states"]
    sr = model.get("state_range")
    tr = tuple(model.get("trans_range", (0, 0)))
    p = {k: v.to(device) for k, v in params.items()}
    path_gap = score_gap = 0.0
    for b, (paths, scores) in zip(batches, results):
        feats, lengths = b["feats"].to(device), b["lengths"].to(device)
        best = ref_crf.best_scores(p, feats, lengths, ns, sr, tr)
        mine = ref_crf.path_scores(p, feats, paths.to(device), lengths, ns,
                                   sr, tr)
        live = lengths > 0
        pg = _rel(best - mine, best)[live]
        sg = _rel(scores.to(device, DT) - mine, best)[live]
        path_gap = max(path_gap, float(pg.max()))
        score_gap = max(score_gap, float(sg.max()))
    return {"path_gap": path_gap, "score_gap": score_gap}


def scrf_decode_numbers(params: dict, batches: list, results: list,
                        model: dict, device) -> dict:
    """The segmental decode: the same two gaps over the sampled batches'
    rows, with the served segmentation's reference score (NEG where it does
    not tile the row)."""
    Dmax = model["max_dur"]
    p = {k: v.to(device) for k, v in params.items()}
    path_gap = score_gap = 0.0
    for b, (starts, labels, n_segs, scores) in zip(batches, results):
        feats, lengths = b["feats"].to(device), b["lengths"].to(device)
        best = ref_scrf.best_scores(p, feats, lengths, Dmax)
        mine = ref_scrf.segmentation_scores(p, feats, starts, labels,
                                            n_segs, lengths, Dmax)
        live = lengths > 0
        pg = _rel(best - mine, best)[live]
        sg = _rel(scores.to(device, DT) - mine, best)[live]
        path_gap = max(path_gap, float(pg.max()))
        score_gap = max(score_gap, float(sg.max()))
    return {"path_gap": path_gap, "score_gap": score_gap}
