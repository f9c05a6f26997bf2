"""Label topologies: monophone and left-to-right n-state-per-phone.

Counterpart of :mod:`asr_craft_tpu.models.topology`.  The structural masks
stay numpy (they are constants of the configuration); the per-batch maps
(``clamp_mask``, ``path_to_phones``) work on tensors.

Expanded-state index convention: state ``s`` of phone ``p`` is
``p * num_states + s``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from asr_craft_tpu_torch.ops.semiring import NEG_INF


@dataclasses.dataclass(frozen=True)
class Topology:
    """num_labels phones x num_states left-to-right states each."""

    num_labels: int
    num_states: int = 1

    @property
    def num_expanded(self) -> int:
        return self.num_labels * self.num_states

    def expand(self, phone):
        """First expanded state of each phone label (entry state)."""
        return phone * self.num_states

    def phone_of(self, state):
        """Map expanded-state index -> phone label (arrays or tensors)."""
        return state // self.num_states

    def transition_mask(self) -> np.ndarray:
        """(L', L') bool: self-loops, within-phone advances, and
        last-state -> first-state of any phone; all-True for monophone."""
        n, k = self.num_labels, self.num_states
        idx = np.arange(n * k)
        st = idx % k
        mask = np.zeros((n * k, n * k), dtype=bool)
        mask[idx, idx] = True
        adv = st < k - 1
        mask[idx[adv], idx[adv] + 1] = True
        mask[np.ix_(idx[st == k - 1], idx[st == 0])] = True
        return mask

    def transition_penalty(self, dtype=np.float32) -> np.ndarray:
        """(L', L') additive penalty: 0 where allowed, NEG_INF otherwise."""
        return np.where(self.transition_mask(), 0.0, NEG_INF).astype(dtype)

    def start_penalty(self, dtype=np.float32) -> np.ndarray:
        """(L',): paths begin in a phone's first state."""
        st = np.arange(self.num_expanded) % self.num_states
        return np.where(st == 0, 0.0, NEG_INF).astype(dtype)

    def end_penalty(self, dtype=np.float32) -> np.ndarray:
        """(L',): paths end in a phone's last state."""
        st = np.arange(self.num_expanded) % self.num_states
        return np.where(st == self.num_states - 1, 0.0, NEG_INF).astype(dtype)

    def clamp_mask(self, phone_labels: torch.Tensor) -> torch.Tensor:
        """(..., T) phone labels -> (..., T, L') additive penalty clamping
        each frame to the states of its phone (the numerator lattice)."""
        states = torch.arange(self.num_expanded, device=phone_labels.device)
        ok = self.phone_of(states) == phone_labels[..., None]
        return torch.where(ok, 0.0, NEG_INF).to(torch.float32)

    def path_to_phones(self, state_path: torch.Tensor) -> torch.Tensor:
        """Collapse an expanded-state Viterbi path to per-frame phones."""
        return self.phone_of(state_path)
