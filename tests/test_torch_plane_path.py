"""The plane kernel's choice of design, on the CPU: ``kernels.fdt_train.
plane_path`` and what ``fdt_planes_cuda`` hands the library for it.

The kernel (``csrc/fdt_mma.cu`` ``fdt_train_plane_kernel``) has two designs:
the wgmma path, which reads tiles of frames by TMA and so needs each
frame's row of ``Du`` floats 16-byte aligned (the base of ``feats``,
``D``, ``u0`` and ``Du`` multiples of 4) and ``0 < Du <= 144``, and the
mma.sync tiles for every other input.  The wrapper chooses, passes the
choice to the library and counts the launch, once a call, in the
diagnostics counter ``<key>[<path>]`` (``kernels.fdt_train_plane[...]``, or
the decode's ``kernels.fdt_viterbi_plane[...]``).  The library here is a
stand-in that records its arguments.
"""
import contextlib

import pytest
import torch

from asr_craft_tpu_torch.kernels import fdt_train as K
from asr_craft_tpu_torch.utils import diagnostics


def _feats(B, T, D, offset=0):
    """(B, T, D) float32 frames whose first element lies ``offset`` floats
    into a fresh buffer (an offset of 1 leaves the base 4 bytes past a
    16-byte boundary)."""
    buf = torch.zeros(B * T * D + 8)
    assert buf.data_ptr() % 16 == 0
    return buf[offset:offset + B * T * D].view(B, T, D)


@pytest.mark.parametrize("D,u0,u1,offset,path", [
    (144, 0, 144, 0, "wgmma"),          # the flagship: config 2's frames
    (148, 4, 148, 0, "wgmma"),          # a window that starts at dim 4
    (16, 0, 16, 0, "wgmma"),            # P = 128's test widths
    (144, 0, 144, 4, "wgmma"),          # a sub-batch 16 bytes in
    (12, 2, 12, 0, "mma_sync"),         # u0 % 4 != 0
    (144, 1, 145 - 4, 0, "mma_sync"),   # u0 = 1
    (144, 0, 144, 1, "mma_sync"),       # the base 4 bytes off 16
    (20, 4, 17, 0, "mma_sync"),         # Du = 13
    (18, 0, 16, 0, "mma_sync"),         # D = 18: rows 8 bytes apart
    (160, 0, 148, 0, "mma_sync"),       # Du = 148: deeper than a slab
    (8, 4, 4, 0, "mma_sync")])          # Du = 0
def test_plane_path_rule(D, u0, u1, offset, path):
    assert K.plane_path(_feats(2, 3, D, offset), u0=u0,
                        Du=u1 - u0) == path


def _stand_ins(monkeypatch, lib):
    """The library replaced by ``lib``; the checks of a CUDA tensor hold
    the rest of what they check (type, rank, contiguity) on the CPU."""
    def check_tensor(name, t, dtype, ndim, device):
        assert t.dtype == dtype and t.dim() == ndim and t.is_contiguous()

    monkeypatch.setattr(K, "_library", lambda: lib)
    monkeypatch.setattr(K, "_stream", lambda dev: 0)
    monkeypatch.setattr(K._build, "check_tensor", check_tensor)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())


class _Library:
    """A stand-in for the kernels' library: records each fdt_train_plane
    call's arguments and succeeds."""

    def __init__(self):
        self.calls = []

    def fdt_train_plane(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
def test_planes_wrapper_passes_and_counts_the_path(monkeypatch, precision):
    """fdt_planes_cuda on CPU tensors with the stand-in library: each call
    hands the library the path its inputs allow (1 wgmma, 0 mma.sync) and
    the precision's code, and counts one launch under its key and path."""
    from asr_craft_tpu_torch.ops import precision as prec
    lib = _Library()
    _stand_ins(monkeypatch, lib)
    R = 3 * 3 * 5 + 5 * 5                      # P = 5, ns = 3: R = 70
    ran = {}
    cases = [(_feats(2, 5, 144), 0, 144, 1),
             (_feats(2, 5, 12), 2, 12, 0),
             (_feats(3, 4, 144, offset=1), 0, 144, 0),
             (_feats(1, 7, 20), 4, 16, 1)]
    for i, (feats, u0, u1, code) in enumerate(cases):
        Wall = torch.zeros((R, u1 - u0 + 1))
        key = ("kernels.fdt_viterbi_plane" if i % 2
               else "kernels.fdt_train_plane")
        with diagnostics.held_launches() as one:
            planes = K.fdt_planes_cuda(Wall, feats, u0=u0, u1=u1, key=key,
                                       precision=precision)
        assert len(one) == 1
        ran.update(one)
        B, T, D = feats.shape
        assert planes.shape == (B, T, 72)
        args = lib.calls[-1]
        assert args[0] == feats.data_ptr() and args[3] == planes.data_ptr()
        assert args[4:11] == (B * T, D, u0, u1 - u0, (u1 - u0 + 3) // 4 * 4,
                              R, 72)
        assert args[11:13] == (prec.CODES[precision], code)
    assert len(lib.calls) == len(cases)
    assert ran == {"kernels.fdt_train_plane[wgmma]": 1,
                   "kernels.fdt_viterbi_plane[mma_sync]": 1,
                   "kernels.fdt_train_plane[mma_sync]": 1,
                   "kernels.fdt_viterbi_plane[wgmma]": 1}


def test_planes_wrapper_counts_nothing_for_no_frames(monkeypatch):
    """No frames: no launch, no count, an empty (B, 0, R4) result."""
    lib = _Library()
    _stand_ins(monkeypatch, lib)
    before = diagnostics.summary()["counters"]
    planes = K.fdt_planes_cuda(torch.zeros((70, 145)), _feats(3, 0, 144),
                               u0=0, u1=144)
    assert planes.shape == (3, 0, 72) and not lib.calls
    assert diagnostics.summary()["counters"] == before
