"""ctypes bridge to the native FST backend (native/fst.cpp).

Builds ``native/libcraftfst.so`` on first use (``make -C native``) and
exposes the same ``compose`` / ``shortest_path`` API as the Python reference
implementation in :mod:`asr_craft_tpu_torch.decode.fst` (which is also the
correctness oracle for it — tests/unit/test_fst_native.py).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libcraftfst.so")
_lib = None
_build_failed = False


def _i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def _f32(a):
    return np.ascontiguousarray(a, dtype=np.float32)


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    try:
        if not os.path.exists(_LIB_PATH):
            subprocess.run(["make", "-C", _NATIVE_DIR, "libcraftfst.so"],
                           check=True, capture_output=True, timeout=120)
        lib = ctypes.CDLL(_LIB_PATH)
    except Exception:
        _build_failed = True
        return None
    I, F, V = ctypes.c_int32, ctypes.c_float, ctypes.c_void_p
    ip = np.ctypeslib.ndpointer(np.int32, flags="C")
    fp = np.ctypeslib.ndpointer(np.float32, flags="C")
    lib.craft_compose.restype = V
    lib.craft_compose.argtypes = [I, I, I, ip, ip, ip, ip, fp, fp] * 2
    lib.craft_fst_free.argtypes = [V]
    lib.craft_fst_num_states.restype = I
    lib.craft_fst_num_states.argtypes = [V]
    lib.craft_fst_num_arcs.restype = I
    lib.craft_fst_num_arcs.argtypes = [V]
    lib.craft_fst_start.restype = I
    lib.craft_fst_start.argtypes = [V]
    lib.craft_fst_export.argtypes = [V, ip, ip, ip, ip, fp, fp]
    lib.craft_shortest_path.restype = I
    lib.craft_shortest_path.argtypes = [
        I, I, I, ip, ip, ip, ip, fp, fp, I, ip, ip,
        ctypes.POINTER(I), ctypes.POINTER(I), ctypes.POINTER(F)]
    D = ctypes.c_double
    dp = np.ctypeslib.ndpointer(np.float64, flags="C")
    lib.craft_otf_decode.restype = I
    lib.craft_otf_decode.argtypes = [
        I, I, dp, dp, I, I,
        I, I, I, ip, ip, ip, ip, fp, fp,
        D, I, I, ip, ctypes.POINTER(I), ip, ctypes.POINTER(D)]
    lib.craft_otf_decode_dynamic.restype = I
    lib.craft_otf_decode_dynamic.argtypes = [
        I, I, dp, dp, I, I,
        I, I, I, ip, ip, ip, ip, fp, fp,
        I, I, I, ip, ip, ip, ip, fp, fp, D,
        D, I, dp, I,
        I, ip, ctypes.POINTER(I), ip, ctypes.POINTER(D)]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def compose(a, b):
    from asr_craft_tpu_torch.decode.fst import Fst
    lib = _load()
    h = lib.craft_compose(
        a.num_states, a.start, a.num_arcs,
        _i32(a.src), _i32(a.dst), _i32(a.ilabel), _i32(a.olabel),
        _f32(a.weight), _f32(a.final),
        b.num_states, b.start, b.num_arcs,
        _i32(b.src), _i32(b.dst), _i32(b.ilabel), _i32(b.olabel),
        _f32(b.weight), _f32(b.final))
    if not h:
        raise ValueError("compose: B must be input-epsilon-free")
    try:
        ns = lib.craft_fst_num_states(h)
        na = lib.craft_fst_num_arcs(h)
        start = lib.craft_fst_start(h)
        src = np.empty(na, np.int32)
        dst = np.empty(na, np.int32)
        il = np.empty(na, np.int32)
        ol = np.empty(na, np.int32)
        w = np.empty(na, np.float32)
        final = np.empty(ns, np.float32)
        lib.craft_fst_export(h, src, dst, il, ol, w, final)
    finally:
        lib.craft_fst_free(h)
    return Fst(ns, start, src, dst, il, ol, w, final)


def shortest_path(f) -> Tuple[List[int], List[int], float]:
    lib = _load()
    max_out = f.num_arcs + 1
    out_il = np.empty(max_out, np.int32)
    out_ol = np.empty(max_out, np.int32)
    ni = ctypes.c_int32()
    no = ctypes.c_int32()
    wgt = ctypes.c_float()
    rc = lib.craft_shortest_path(
        f.num_states, f.start, f.num_arcs,
        _i32(f.src), _i32(f.dst), _i32(f.ilabel), _i32(f.olabel),
        _f32(f.weight), _f32(f.final),
        max_out, out_il, out_ol,
        ctypes.byref(ni), ctypes.byref(no), ctypes.byref(wgt))
    if rc == 1:
        raise ValueError("shortest_path: FST has a cycle")
    if rc == 2:
        raise ValueError("shortest_path: no accepting path")
    if rc != 0:
        raise RuntimeError(f"shortest_path: native error {rc}")
    return (out_il[:ni.value].tolist(), out_ol[:no.value].tolist(),
            float(wgt.value))


def otf_decode(log_phi_state, log_phi_trans, length, graph, words,
               num_states=1, beam_threshold=None, max_active=None
               ) -> Tuple[List[str], List[int], float]:
    """Native on-the-fly composed beam Viterbi (craft_otf_decode); same
    contract as decode.otf.otf_decode_words."""
    lib = _load()
    state = np.ascontiguousarray(
        np.asarray(log_phi_state, np.float64)[:int(length)])
    trans = np.ascontiguousarray(np.asarray(log_phi_trans, np.float64))
    T, L = state.shape
    frame_dep = 1 if trans.ndim == 3 else 0
    if frame_dep:
        trans = np.ascontiguousarray(trans[:T])
    max_words = T + 1
    out_words = np.empty(max_words, np.int32)
    out_path = np.empty(T, np.int32)
    nw = ctypes.c_int32()
    wgt = ctypes.c_double()
    rc = lib.craft_otf_decode(
        T, L, state, trans, frame_dep, int(num_states),
        graph.num_states, graph.start, graph.num_arcs,
        _i32(graph.src), _i32(graph.dst), _i32(graph.ilabel),
        _i32(graph.olabel), _f32(graph.weight), _f32(graph.final),
        -1.0 if beam_threshold is None else float(beam_threshold),
        0 if max_active is None else int(max_active),
        max_words, out_words, ctypes.byref(nw), out_path,
        ctypes.byref(wgt))
    if rc == 2:
        raise ValueError("otf_decode: no accepting hypothesis (beam too "
                         "narrow or lexicon cannot cover the utterance)")
    if rc != 0:
        raise RuntimeError(f"otf_decode: native error {rc}")
    return ([words[w - 1] for w in out_words[:nw.value]],
            out_path.tolist(), float(wgt.value))


def otf_decode_dynamic(log_phi_state, log_phi_trans, length, lex, words,
                       lm=None, lm_weight=1.0, num_states=1,
                       beam_threshold=None, max_active=None,
                       lookahead=None
                       ) -> Tuple[List[str], List[int], float]:
    """ctypes wrapper for craft_otf_decode_dynamic (fully dynamic
    lexicon/LM composition — see decode.otf.otf_decode_words_dynamic).
    ``lookahead``: True = exact per-history LM lookahead; an ndarray =
    static per-lexicon-state potentials
    (decode.otf.lm_lookahead_potentials); None/False = off."""
    import ctypes

    lib = _load()
    state = np.ascontiguousarray(
        np.asarray(log_phi_state, np.float64)[:int(length)])
    trans = np.ascontiguousarray(np.asarray(log_phi_trans, np.float64))
    T, L = state.shape
    fdep = 1 if trans.ndim == 3 else 0
    zero_i = np.zeros(0, np.int32)
    zero_f = np.zeros(0, np.float32)
    max_words = T + 1
    out_words = np.empty(max_words, np.int32)
    out_path = np.empty(T, np.int32)
    nw = ctypes.c_int32()
    wgt = ctypes.c_double()
    lm_args = ((lm.num_states, lm.start, lm.num_arcs, _i32(lm.src),
                _i32(lm.dst), _i32(lm.ilabel), _i32(lm.olabel),
                _f32(lm.weight), _f32(lm.final))
               if lm is not None else
               (0, 0, 0, zero_i, zero_i, zero_i, zero_i, zero_f, zero_f))
    la_exact = 0
    if isinstance(lookahead, np.ndarray):
        # inf potentials (word unreachable in the LM) must survive the
        # C side's arithmetic: clamp to a huge finite value
        la = np.ascontiguousarray(
            np.minimum(np.asarray(lookahead, np.float64), 1e290))
    else:
        la = np.zeros(lex.num_states, np.float64)
        la_exact = 1 if lookahead else 0
    rc = lib.craft_otf_decode_dynamic(
        T, L, state, trans, fdep, num_states,
        lex.num_states, lex.start, lex.num_arcs, _i32(lex.src),
        _i32(lex.dst), _i32(lex.ilabel), _i32(lex.olabel),
        _f32(lex.weight), _f32(lex.final),
        *lm_args, float(lm_weight),
        -1.0 if beam_threshold is None else float(beam_threshold),
        0 if max_active is None else int(max_active), la, la_exact,
        max_words, out_words, ctypes.byref(nw), out_path,
        ctypes.byref(wgt))
    if rc == 2:
        raise ValueError("otf_decode_dynamic: no accepting hypothesis "
                         "(beam too narrow or lexicon cannot cover the "
                         "utterance)")
    if rc != 0:
        raise RuntimeError(f"otf_decode_dynamic: native error {rc}")
    return ([words[w - 1] for w in out_words[:nw.value]],
            out_path.tolist(), float(wgt.value))
