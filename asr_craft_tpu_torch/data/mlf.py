"""HTK Master Label File (MLF) parsing.

Replaces ``CRF_MLFManager`` (SURVEY.md §2.1): reference transcripts for
decode-time scoring.  Format:

    #!MLF!#
    "*/utt1.lab"
    [start end] label [score]
    ...
    .
    "*/utt2.lab"
    ...

Times (optional) are 100ns units.  Returns a dict utterance-key ->
list of (start_frame, end_frame, label).
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Tuple

Segment = Tuple[int, int, str]


def _utt_key(quoted: str) -> str:
    name = quoted.strip().strip('"')
    base = os.path.basename(name)
    return os.path.splitext(base)[0]


def read_mlf(path, frame_period: int = 100000) -> Dict[str, List[Segment]]:
    utts: Dict[str, List[Segment]] = {}
    cur = None
    with open(path) as f:
        first = f.readline()
        if not first.startswith("#!MLF!#"):
            raise ValueError(f"{path} is not an MLF (missing #!MLF!# header)")
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith('"'):
                cur = _utt_key(line)
                utts[cur] = []
            elif line == ".":
                cur = None
            else:
                if cur is None:
                    raise ValueError(f"MLF entry outside utterance: {line!r}")
                parts = line.split()
                if len(parts) >= 3 and re.fullmatch(r"-?\d+", parts[0]):
                    s, e = int(parts[0]), int(parts[1])
                    utts[cur].append((s // frame_period, e // frame_period,
                                      parts[2]))
                else:
                    utts[cur].append((-1, -1, parts[0]))
    return utts


def write_mlf(path, utts: Dict[str, List[Segment]],
              frame_period: int = 100000) -> None:
    with open(path, "w") as f:
        f.write("#!MLF!#\n")
        for key, segs in utts.items():
            f.write(f'"*/{key}.lab"\n')
            for s, e, lab in segs:
                if s < 0:
                    f.write(f"{lab}\n")
                else:
                    f.write(f"{s * frame_period} {e * frame_period} {lab}\n")
            f.write(".\n")


def mlf_to_label_seqs(utts: Dict[str, List[Segment]],
                      label_map: Dict[str, int]) -> Dict[str, List[int]]:
    """Collapse MLF segments to integer label sequences (one per segment)."""
    return {k: [label_map[lab] for (_, _, lab) in segs]
            for k, segs in utts.items()}
