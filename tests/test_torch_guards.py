"""Guards of the port: no import of JAX or of the JAX package, no silent
fallback from the device or the kernel, and build commands that target
Hopper from csrc/ only."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import asr_craft_tpu_torch
from asr_craft_tpu_torch import kernels
from asr_craft_tpu_torch.cli import decode as port_cli
from asr_craft_tpu_torch.cli import train as port_train_cli
from asr_craft_tpu_torch.kernels import _build, fdt_train
from asr_craft_tpu_torch.kernels.fdt_viterbi import (fdt_viterbi_cuda,
                                                     fdt_viterbi_wall,
                                                     launches)
from asr_craft_tpu_torch.kernels.wall import build_wall
from asr_craft_tpu_torch.models.crf import CrfConfig, crf_loss, decode

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import pkgutil, importlib, sys
import asr_craft_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for n in names:
    importlib.import_module(n)
for n in ('kernels.wall', 'kernels.fdt_train', 'train.trainer',
          'train.checkpoint', 'cli.train', 'kernels.viterbi',
          'ops.viterbi', 'kernels.fwdbwd', 'ops.mxu', 'ops.fwdbwd',
          'cli.common', 'utils.logging', 'data.loader', 'data.synthetic',
          'data.pfile_native', 'decode.scorer', 'decode.fst',
          'decode.fst_native', 'decode.otf', 'ops.segmental',
          'ops.segmental_stream', 'kernels.segmental', 'models.segmental',
          'recipes.scrf'):
    assert 'asr_craft_tpu_torch.' + n in names, n
assert len(names) >= 40, names
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'asr_craft_tpu'))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    """Every module of the port, imported in a fresh interpreter, loads
    neither jax nor any module of the JAX package ``asr_craft_tpu``."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _assert_imports_only_the_port(path):
    for line in path.read_text().splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert "jax" not in words[1], (path, line)
            assert not words[1].startswith("asr_craft_tpu."), (path, line)
            assert words[1] != "asr_craft_tpu", (path, line)


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py names only the port (and torch/numpy)."""
    _assert_imports_only_the_port(REPO / "chip_smoke.py")


def test_port_sources_name_no_jax_package_import():
    """No import line of any module of the port names jax or the JAX
    package, not even inside a function (where the fresh-interpreter test
    would not see it)."""
    pkg = REPO / "asr_craft_tpu_torch"
    files = sorted(f for f in pkg.rglob("*.py")
                   if "_build" not in f.relative_to(pkg).parts)  # outputs
    assert len(files) >= 40
    for path in files:
        _assert_imports_only_the_port(path)


def test_device_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the guard is for hosts "
                    "without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["--synthetic_utts", "2", "--crf_label_size", "3",
                       "--weight_file", str(tmp_path / "missing.dat")])


def test_train_device_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the guard is for hosts "
                    "without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train_cli.main(["--synthetic_utts", "4", "--crf_label_size",
                             "3", "--crf_transftr_end", "3",
                             "--out_dir", str(tmp_path)])


def test_cuda_backend_on_cpu_tensor_raises_in_fdt_nll_dual():
    """Under the 'cuda' backend the training Function launches K1 or
    raises: a CPU tensor never reaches the plain version."""
    cfg = CrfConfig(num_labels=3, feat_dim=4, num_states=2,
                    trans_range=(0, 4))
    params = cfg.init_params(torch.Generator().manual_seed(0), 0.1)
    Wall, u0, u1, dims = build_wall(params, cfg.fmap, 2)
    feats = torch.zeros((2, 5, 4))
    labels = torch.zeros((2, 5), dtype=torch.int32)
    lengths = torch.tensor([5, 3], dtype=torch.int32)
    before = dict(fdt_train.launches)
    kernels.set_backend("cuda")
    try:
        with pytest.raises(ValueError, match="CUDA tensor"):
            fdt_train.FdtNllDual.apply(Wall, feats, labels, lengths, u0, u1,
                                       2, 3, 2, True, False)
        with pytest.raises(ValueError, match="CUDA tensor"):
            crf_loss(cfg, params, feats, labels, lengths)
    finally:
        kernels.set_backend("auto")
    assert fdt_train.launches == before


def test_library_hash_covers_headers(tmp_path):
    """An edited header must not load a stale library: the library name
    hashes csrc/*.cuh as well as csrc/*.cu."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    assert [h.name for h in _build.headers(csrc)] == ["fdt_common.cuh"]
    before = _build.library_path(csrc)
    assert before == _build.library_path()
    with open(csrc / "fdt_common.cuh", "a") as f:
        f.write("// edited\n")
    assert _build.library_path(csrc) != before
    assert _build.sources(csrc) == sorted(csrc.glob("*.cu"))


def _tiny_wall():
    cfg = CrfConfig(num_labels=3, feat_dim=4, num_states=2,
                    trans_range=(0, 4))
    params = cfg.init_params(torch.Generator().manual_seed(0), 0.1)
    Wall, u0, u1, dims = build_wall(params, cfg.fmap, cfg.num_states)
    feats = torch.zeros((2, 5, 4))
    lengths = torch.tensor([5, 3], dtype=torch.int32)
    kw = dict(u0=u0, u1=u1, ns=2, P=dims["P"])
    return cfg, params, Wall, feats, lengths, kw


def test_cuda_backend_on_cpu_tensor_raises():
    cfg, params, Wall, feats, lengths, kw = _tiny_wall()
    before = dict(launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fdt_viterbi_cuda(Wall, feats, lengths, **kw)
    kernels.set_backend("cuda")
    try:
        assert kernels.use_kernel(feats) is True
        with pytest.raises(ValueError, match="CUDA tensor"):
            fdt_viterbi_wall(Wall, feats, lengths, **kw)
        with pytest.raises(ValueError, match="CUDA tensor"):
            decode(cfg, params, feats, lengths)
    finally:
        kernels.set_backend("auto")
    assert launches == before


def test_auto_backend_takes_plain_only_for_cpu_tensors():
    cpu = torch.zeros(1)
    assert kernels.use_kernel(cpu) is False             # auto
    kernels.set_backend("torch")
    try:
        assert kernels.use_kernel(cpu) is False
    finally:
        kernels.set_backend("auto")
    with pytest.raises(ValueError):
        kernels.set_backend("xla")
    cfg, params, Wall, feats, lengths, kw = _tiny_wall()
    before = dict(launches)
    paths, scores = fdt_viterbi_wall(Wall, feats, lengths, **kw)
    assert paths.shape == (2, 5) and torch.isfinite(scores).all()
    assert launches == before


def test_nvcc_command_targets_sm90a_from_csrc_only():
    """One compile command per source (they run side by side), then one
    link of their objects into the shared library."""
    srcs = _build.sources()
    assert srcs and all(s.suffix == ".cu" for s in srcs)
    assert {"fwdbwd.cu", "segmental.cu"} <= {s.name for s in srcs}
    objs = [_build.BUILD_DIR / f"{s.stem}.o" for s in srcs]
    inputs = []
    for src, obj in zip(srcs, objs):
        cmd = _build.nvcc_command(src, obj)
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert cmd[cmd.index("arch=compute_90a,code=sm_90a") - 1] == \
            "-gencode"
        for flag in ("-std=c++17", "-O3", "-c", "-fPIC"):
            assert flag in cmd
        assert cmd[cmd.index("-o") + 1] == str(obj)
        inputs += [Path(a) for a in cmd
                   if a.endswith((".cu", ".cuh", ".cpp"))]
    assert inputs == srcs
    link = _build.link_command(objs, _build.BUILD_DIR / "lib.so")
    assert "-shared" in link and link[-len(objs):] == [str(o) for o in objs]
    assert link[link.index("-o") + 1] == str(_build.BUILD_DIR / "lib.so")
    csrc = Path(asr_craft_tpu_torch.__file__).parent / "csrc"
    assert all(p.resolve().parent == csrc.resolve() for p in inputs)
    lib = _build.library_path()
    assert lib.parent == _build.BUILD_DIR
    assert lib.name.startswith("libasr_craft_kernels_")


def test_cuda_backend_on_cpu_tensor_raises_in_the_segmental_path():
    """Under the 'cuda' backend the segmental loss and decode launch K9 /
    K12 or raise: a CPU tensor never reaches the plain version."""
    from asr_craft_tpu_torch.kernels import segmental
    from asr_craft_tpu_torch.models.segmental import (SegCrfConfig,
                                                      scrf_decode,
                                                      scrf_loss_fused)
    cfg = SegCrfConfig(num_labels=3, feat_dim=4, max_dur=3)
    params = cfg.init_params(torch.Generator().manual_seed(0), 0.1)
    feats = torch.zeros((2, 6, 4))
    labels = torch.zeros((2, 6), dtype=torch.int32)
    lengths = torch.tensor([6, 2], dtype=torch.int32)
    before = dict(segmental.launches)
    kernels.set_backend("cuda")
    try:
        with pytest.raises(ValueError, match="CUDA tensor"):
            scrf_loss_fused(cfg, params, feats, labels, lengths)
        with pytest.raises(ValueError, match="CUDA tensor"):
            scrf_decode(cfg, params, feats, lengths)
    finally:
        kernels.set_backend("auto")
    assert segmental.launches == before
    loss, _ = scrf_loss_fused(cfg, params, feats, labels, lengths)
    assert torch.isfinite(loss) and segmental.launches == before
