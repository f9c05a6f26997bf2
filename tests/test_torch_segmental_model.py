"""The port's SCRF model layer (``models/segmental``) against the JAX
package's on identical numpy-seeded parameters and inputs: potentials, the
four gold scorers, both losses in value and parameter gradients, the decodes,
marker packing and the ``.npz`` weight files.

Tolerances: fp32, rtol 1e-5 / atol 1e-4 on potentials, scores and logZ,
rtol 1e-5 on losses; parameter gradients within 1e-4 of their largest
entry; segmentations equal (the near-tie rule would apply where one
differs: both must score within 1e-5 relative)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_craft_tpu.models import segmental as jm
from asr_craft_tpu.models import weights as jweights
from asr_craft_tpu.ops import segmental_stream as jss
from asr_craft_tpu_torch.models import segmental as tm
from asr_craft_tpu_torch.models import weights as tweights
from asr_craft_tpu_torch.ops import segmental_stream as tss
from asr_craft_tpu_torch.ops.semiring import NEG_INF

TOL = dict(rtol=1e-5, atol=1e-4)
CONFIGS = [dict(), dict(pooling="sum"), dict(use_dur_feature=False),
           dict(use_seg_bias=False, use_dur_feature=False),
           dict(num_states=3), dict(num_states=2, pooling="sum")]


def _setup(seed, B=4, T=12, D=5, L=4, Dmax=5, scale=0.4, run=2, **kw):
    rng = np.random.default_rng(seed)
    jcfg = jm.SegCrfConfig(num_labels=L, feat_dim=D, max_dur=Dmax, **kw)
    tcfg = tm.SegCrfConfig(num_labels=L, feat_dim=D, max_dur=Dmax, **kw)
    assert tcfg.param_shapes() == jcfg.param_shapes()
    params = {k: (scale * rng.normal(size=s)).astype(np.float32)
              for k, s in sorted(jcfg.param_shapes().items())}
    feats = rng.normal(size=(B, T, D)).astype(np.float32)
    labels = np.repeat(rng.integers(0, L, size=(B, T // run + 1)), run,
                       axis=1)[:, :T].astype(np.int32)
    lengths = (rng.integers(1, T // run + 1, size=B) * run).astype(np.int32)
    lengths[0] = T
    return jcfg, tcfg, params, feats, labels, lengths


def _j(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def _t(params, grad=False):
    out = tweights.params_from_numpy(params)
    return {k: v.requires_grad_(grad) for k, v in out.items()}


def _rel(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-4 * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("kw", CONFIGS)
def test_seg_potentials_match_jax(kw):
    jcfg, tcfg, params, feats, _, _ = _setup(0, **kw)
    jseg, jtr = jm.seg_potentials(jcfg, _j(params), jnp.asarray(feats))
    tseg, ttr = tm.seg_potentials(tcfg, _t(params), torch.from_numpy(feats))
    np.testing.assert_allclose(tseg.numpy(), np.asarray(jseg), **TOL)
    np.testing.assert_array_equal(ttr.numpy(), np.asarray(jtr))
    jf, jb = jm._frame_scores_and_bias(jcfg, _j(params), jnp.asarray(feats))
    tf, tb = tm._frame_scores_and_bias(tcfg, _t(params),
                                       torch.from_numpy(feats))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **TOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **TOL)
    if "num_states" in kw:
        np.testing.assert_array_equal(
            tm.nstate_cuts(5, kw["num_states"]),
            jm.nstate_cuts(5, kw["num_states"]))


def test_init_params_seeded_and_zero():
    cfg = tm.SegCrfConfig(num_labels=4, feat_dim=5, max_dur=3, num_states=2)
    a = cfg.init_params(torch.Generator().manual_seed(4), 0.1)
    b = cfg.init_params(torch.Generator().manual_seed(4), 0.1)
    assert {k: tuple(v.shape) for k, v in a.items()} == cfg.param_shapes()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["w_frame"].std()) == pytest.approx(0.1, rel=0.5)
    assert all(float(v.abs().max()) == 0.0
               for v in cfg.init_params().values())


@pytest.mark.parametrize("mean_pool", [True, False])
@pytest.mark.parametrize("long_run", [False, True])
def test_gold_scorers_match_jax(mean_pool, long_run):
    """The dense, streamed, n-state and batched gold scorers; with
    ``long_run`` a gold run longer than Dmax poisons the score with NEG_INF
    per bad segment and carries no pool or bias gradient."""
    B, T, L, Dmax, ns = 4, 12, 4, 4, 2
    rng = np.random.default_rng(1)
    frame = rng.normal(size=(B, T, L)).astype(np.float32)
    frame_ns = rng.normal(size=(B, T, ns, L)).astype(np.float32)
    seg = rng.normal(size=(B, T, Dmax, L)).astype(np.float32)
    bias = rng.normal(size=(Dmax, L)).astype(np.float32)
    trans = rng.normal(size=(L, L)).astype(np.float32)
    labels = np.repeat(rng.integers(0, L, size=(B, 6)), 2, axis=1).astype(
        np.int32)
    if long_run:
        labels[1, 2:9] = 3                      # a run of 7 > Dmax
    lengths = np.array([12, 10, 7, 0], np.int32)
    cuts = jss.nstate_cuts(Dmax, ns)
    for b in range(B):
        n = int(lengths[b])
        jl, tl = jnp.asarray(labels[b]), torch.from_numpy(labels[b])
        pairs = [
            (jm.gold_segment_score(jnp.asarray(seg[b]), jnp.asarray(trans),
                                   jl, n),
             tm.gold_segment_score(torch.from_numpy(seg[b]),
                                   torch.from_numpy(trans), tl, n)),
            (jm.gold_segment_score_stream(
                jnp.asarray(frame[b]), jnp.asarray(bias), jnp.asarray(trans),
                jl, n, mean_pool),
             tm.gold_segment_score_stream(
                 torch.from_numpy(frame[b]), torch.from_numpy(bias),
                 torch.from_numpy(trans), tl, n, mean_pool)),
            (jm.gold_segment_score_stream_ns(
                jnp.asarray(frame_ns[b]), jnp.asarray(bias),
                jnp.asarray(trans), jl, n, cuts, mean_pool),
             tm.gold_segment_score_stream_ns(
                 torch.from_numpy(frame_ns[b]), torch.from_numpy(bias),
                 torch.from_numpy(trans), tl, n, cuts, mean_pool))]
        for want, got in pairs:
            np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                       atol=1e-4)
            if long_run and b == 1:
                assert float(got) <= NEG_INF * 0.5

    def jobj(f, bi, tr):
        return jnp.sum(jm.gold_segment_score_batch(
            f, bi, tr, jnp.asarray(labels), jnp.asarray(lengths), mean_pool))

    jgold = jm.gold_segment_score_batch(
        jnp.asarray(frame), jnp.asarray(bias), jnp.asarray(trans),
        jnp.asarray(labels), jnp.asarray(lengths), mean_pool)
    jg = jax.grad(jobj, argnums=(0, 1, 2))(
        jnp.asarray(frame), jnp.asarray(bias), jnp.asarray(trans))
    f, bi, tr = (torch.from_numpy(x).requires_grad_(True)
                 for x in (frame, bias, trans))
    gold = tm.gold_segment_score_batch(f, bi, tr, torch.from_numpy(labels),
                                       torch.from_numpy(lengths), mean_pool)
    gold.sum().backward()
    np.testing.assert_allclose(gold.detach().numpy(), np.asarray(jgold),
                               rtol=1e-5, atol=1e-4)
    assert float(gold.detach()[3]) == 0.0       # the empty row scores nothing
    for got, want in zip((f.grad, bi.grad, tr.grad), jg):
        _rel(got, want)
    if long_run:
        assert float(f.grad[1, 2:9].abs().max()) == 0.0


@pytest.mark.parametrize("kw", [dict(), dict(pooling="sum"),
                                dict(use_seg_bias=False),
                                dict(num_states=3), dict(num_states=2)])
def test_losses_match_each_other_and_jax(kw):
    """scrf_loss == scrf_loss_fused in value and parameter gradients, and
    both equal the JAX values (whose fused path is the XLA scans here)."""
    jcfg, tcfg, params, feats, labels, lengths = _setup(2, **kw)
    lengths[-1] = 0                              # a padding row
    jargs = (jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(lengths))
    jl, jaux = jm.scrf_loss_fused(jcfg, _j(params), *jargs)
    jg = jax.grad(lambda p: jm.scrf_loss_fused(jcfg, p, *jargs)[0])(
        _j(params))
    jld, _ = jm.scrf_loss(jcfg, _j(params), *jargs)
    np.testing.assert_allclose(float(jld), float(jl), rtol=1e-5)
    targs = (torch.from_numpy(feats), torch.from_numpy(labels),
             torch.from_numpy(lengths))
    for loss_fn in (tm.scrf_loss_fused, tm.scrf_loss):
        p = _t(params, grad=True)
        loss, aux = loss_fn(tcfg, p, *targs)
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
        live = lengths > 0
        for key in ("logZ", "gold", "nll"):
            np.testing.assert_allclose(
                aux[key].detach().numpy()[live], np.asarray(jaux[key])[live],
                **TOL, err_msg=key)
        assert float(aux["nll"].detach()[-1]) == 0.0
        assert (aux["gold"].detach().numpy()[live]
                <= aux["logZ"].detach().numpy()[live] + 1e-4).all()
        for k in p:
            _rel(p[k].grad, jg[k], f"{loss_fn.__name__} {k}")
    z = tm.scrf_log_partition_fused(tcfg, _t(params), targs[0], targs[2])
    jz = jm.scrf_log_partition_fused(jcfg, _j(params), jargs[0], jargs[2])
    np.testing.assert_allclose(z.numpy()[live], np.asarray(jz)[live], **TOL)


def _same_segments(got, want, lengths):
    (ts, tl, tn, tsc), (js, jl, jn, jsc) = got, want
    live = lengths > 0
    np.testing.assert_allclose(tsc.numpy()[live], np.asarray(jsc)[live],
                               **TOL)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    for b in range(len(lengths)):
        k = int(tn[b])
        np.testing.assert_array_equal(ts.numpy()[b, :k],
                                      np.asarray(js)[b, :k])
        np.testing.assert_array_equal(tl.numpy()[b, :k],
                                      np.asarray(jl)[b, :k])


@pytest.mark.parametrize("kw,beams", [
    (dict(), {}), (dict(pooling="sum"), {}),
    (dict(), dict(beam_threshold=1.5)), (dict(), dict(beam_width=2)),
    (dict(), dict(beam_threshold=2.0, beam_width=3)),
    (dict(num_states=2), {}), (dict(num_states=2), dict(beam_width=2)),
    (dict(num_states=3), dict(beam_threshold=1.5))])
def test_decodes_match_each_other_and_jax(kw, beams):
    """scrf_decode (K12/K13's plain versions for one sub-state without
    beam_width; the generic frame loop otherwise) == the JAX streaming
    decode; exact decodes == scrf_decode_dense in both packages."""
    jcfg, tcfg, params, feats, _, lengths = _setup(3, B=5, T=14, **kw)
    lengths[-1] = 0
    jout = jm.scrf_decode(jcfg, _j(params), jnp.asarray(feats),
                          jnp.asarray(lengths), **beams)
    tout = tm.scrf_decode(tcfg, _t(params), torch.from_numpy(feats),
                          torch.from_numpy(lengths), **beams)
    _same_segments(tout, jout, lengths)
    assert tout[0].dtype == tout[1].dtype == tout[2].dtype == torch.int32
    if not beams:
        live = lengths > 0
        dense = tm.scrf_decode_dense(tcfg, _t(params),
                                     torch.from_numpy(feats[live]),
                                     torch.from_numpy(lengths[live]))
        jdense = jm.scrf_decode_dense(jcfg, _j(params),
                                      jnp.asarray(feats[live]),
                                      jnp.asarray(lengths[live]))
        _same_segments(dense, jdense, lengths[live])
        _same_segments(tuple(x[:int(live.sum())] for x in tout), jdense,
                       lengths[live])
    frames, scores = tm.scrf_frame_labels(tcfg, _t(params),
                                          torch.from_numpy(feats),
                                          torch.from_numpy(lengths))
    jframes, _ = jm.scrf_frame_labels(jcfg, _j(params), jnp.asarray(feats),
                                      jnp.asarray(lengths))
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jframes))


@pytest.mark.parametrize("case", ["mixed", "none", "every_frame", "one_frame"])
def test_pack_segment_markers_edges(case):
    rng = np.random.default_rng(4)
    B, T = 4, 1 if case == "one_frame" else 9
    end_lab = np.full((B, T), -1, np.int32)
    end_start = np.zeros((B, T), np.int32)
    if case != "none":
        for b in range(B):
            ends = (np.arange(T) if case in ("every_frame", "one_frame")
                    else np.sort(rng.choice(T, size=b, replace=False)))
            prev = 0
            for t in ends:
                end_lab[b, t], end_start[b, t] = rng.integers(0, 5), prev
                prev = t + 1
    want = jss._pack_segment_markers(jnp.asarray(end_lab.T),
                                     jnp.asarray(end_start.T))
    got = tss._pack_segment_markers(torch.from_numpy(end_lab),
                                    torch.from_numpy(end_start))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.dtype == torch.int32


@pytest.mark.parametrize("ns", [1, 3])
def test_npz_weights_cross_packages(tmp_path, ns):
    """save_npz / load_npz: a file of either package loads in the other, and
    the decode of the loaded weights is the decode of the originals."""
    jcfg, tcfg, params, feats, _, lengths = _setup(5, num_states=ns)
    jweights.save_npz(tmp_path / "j.npz", params)
    got = tweights.load_npz(tmp_path / "j.npz")
    assert set(got) == set(params)
    for k, v in params.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v)
    tweights.save_npz(tmp_path / "t.npz", _t(params, grad=True))
    back = jweights.load_npz(tmp_path / "t.npz")
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], v)
    args = (torch.from_numpy(feats), torch.from_numpy(lengths))
    a = tm.scrf_decode(tcfg, got, *args)
    b = tm.scrf_decode(tcfg, tweights.load_npz(tmp_path / "t.npz"), *args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_non_highest_precision_takes_the_plain_path_on_cpu_only():
    """precision != 'highest' is a JAX matmul setting: on a CPU tensor the
    port computes in fp32 anyway; where a kernel would serve the tensor it
    raises (the kernels are IEEE fp32 only)."""
    from asr_craft_tpu_torch import kernels
    _, tcfg, params, feats, labels, lengths = _setup(6, precision="default")
    args = (torch.from_numpy(feats), torch.from_numpy(labels),
            torch.from_numpy(lengths))
    loss, _ = tm.scrf_loss_fused(tcfg, _t(params), *args)
    assert torch.isfinite(loss)
    kernels.set_backend("cuda")
    try:
        with pytest.raises(NotImplementedError, match="precision"):
            tm.scrf_loss_fused(tcfg, _t(params), *args)
        with pytest.raises(NotImplementedError, match="precision"):
            tm.scrf_decode(tcfg, _t(params), args[0], args[2])
    finally:
        kernels.set_backend("auto")
