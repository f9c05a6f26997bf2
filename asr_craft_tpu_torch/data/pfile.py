"""ICSI pfile reader/writer.

The reference's primary feature/label container is the ICSI QuickNet pfile
(``QN_InFtrStream_PFile`` / ``QN_InLabStream_PFile`` — SURVEY.md §2.1 L0/L1).
The format (per the public QuickNet documentation; no reference binaries are
available, so the contract here is self-round-trip plus the documented
layout, SURVEY.md §7.3 item 7):

- a 32768-byte ASCII header of ``-key value`` lines;
- a data section of big-endian 32-bit words, one row per frame:
  ``[sentence_id u32, frame_id u32, features f32 x D, labels u32 x K]``;
- a sentence-index section of ``num_sentences + 1`` u32 row offsets.

Only the universally-used subset is implemented: 2-D frame data with feature
and label columns, one label stream.
"""
from __future__ import annotations

import io
from typing import List, Optional, Tuple

import numpy as np

HEADER_SIZE = 32768


class PFile:
    """An in-memory pfile: per-sentence features and labels."""

    def __init__(self, features: List[np.ndarray],
                 labels: Optional[List[np.ndarray]] = None):
        if labels is not None and len(labels) != len(features):
            raise ValueError("features/labels sentence count mismatch")
        for i, f in enumerate(features):
            if f.ndim != 2:
                raise ValueError(f"sentence {i}: features must be (T, D)")
            if labels is not None and len(labels[i]) != len(f):
                raise ValueError(f"sentence {i}: label/frame count mismatch")
        self.features = [np.asarray(f, np.float32) for f in features]
        self.labels = (None if labels is None
                       else [np.asarray(l, np.uint32) for l in labels])

    @property
    def num_sentences(self) -> int:
        return len(self.features)

    @property
    def num_features(self) -> int:
        return self.features[0].shape[1] if self.features else 0

    @property
    def num_labels_cols(self) -> int:
        return 0 if self.labels is None else 1

    def __iter__(self):
        for i in range(self.num_sentences):
            yield (self.features[i],
                   None if self.labels is None else self.labels[i])


def write_pfile(path, pf: PFile) -> None:
    nf = sum(len(f) for f in pf.features)
    D, K = pf.num_features, pf.num_labels_cols
    ncol = 2 + D + K
    header = io.StringIO()
    header.write(f"-pfile_header version 0 size {HEADER_SIZE}\n")
    header.write(f"-num_sentences {pf.num_sentences}\n")
    header.write(f"-num_frames {nf}\n")
    header.write("-first_feature_column 2\n")
    header.write(f"-num_features {D}\n")
    header.write(f"-first_label_column {2 + D}\n")
    header.write(f"-num_labels {K}\n")
    header.write(f"-format dd{'f' * D}{'d' * K}\n")
    header.write(f"-data size {nf * ncol} offset 0 ndim 2 "
                 f"nrow {nf} ncol {ncol}\n")
    header.write(f"-sent_table_data size {pf.num_sentences + 1} "
                 f"offset {nf * ncol} ndim 1\n")
    header.write("-end\n")
    hbytes = header.getvalue().encode("ascii")
    if len(hbytes) > HEADER_SIZE:
        raise ValueError("pfile header overflow")

    rows = np.zeros((nf, ncol), dtype=">u4")
    offsets = [0]
    r = 0
    for sid, (feats, labs) in enumerate(pf):
        T = len(feats)
        rows[r:r + T, 0] = sid
        rows[r:r + T, 1] = np.arange(T)
        rows[r:r + T, 2:2 + D] = feats.astype(">f4").view(">u4")
        if K:
            rows[r:r + T, 2 + D] = labs.astype(">u4")
        r += T
        offsets.append(r)

    with open(path, "wb") as f:
        f.write(hbytes.ljust(HEADER_SIZE, b"\0"))
        f.write(rows.tobytes())
        f.write(np.asarray(offsets, dtype=">u4").tobytes())


def _parse_header(raw: bytes) -> dict:
    info = {}
    for line in raw.split(b"\n"):
        line = line.rstrip(b"\0").decode("ascii", "replace").strip()
        if not line or not line.startswith("-"):
            continue
        if line == "-end":
            break
        parts = line[1:].split()
        key, vals = parts[0], parts[1:]
        info[key] = vals
    return info


def read_pfile(path) -> PFile:
    with open(path, "rb") as f:
        info = _parse_header(f.read(HEADER_SIZE))
        ns = int(info["num_sentences"][0])
        nf = int(info["num_frames"][0])
        D = int(info["num_features"][0])
        K = int(info["num_labels"][0])
        first_f = int(info.get("first_feature_column", ["2"])[0])
        ncol = 2 + D + K
        rows = np.frombuffer(f.read(nf * ncol * 4), dtype=">u4")
        rows = rows.reshape(nf, ncol)
        sent = np.frombuffer(f.read((ns + 1) * 4), dtype=">u4")
    feats_all = rows[:, first_f:first_f + D].view(">f4").astype(np.float32)
    labs_all = (rows[:, first_f + D].astype(np.uint32) if K else None)
    features, labels = [], ([] if K else None)
    for s in range(ns):
        a, b = int(sent[s]), int(sent[s + 1])
        features.append(feats_all[a:b])
        if K:
            labels.append(labs_all[a:b])
    return PFile(features, labels)
