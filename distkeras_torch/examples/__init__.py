"""Runnable example workflows of the PyTorch port: the JAX package's
``examples/`` (``workflow``, ``baseline``, ``higgs_workflow``,
``streaming``, ``lm_workflow``, ``ctr_workflow``) with the same flags, printed lines,
accuracy gates and exit codes, installed as the ``distkeras-torch-*``
console scripts.

They run on the CUDA card.  ``--cpu N`` runs them on the CPU instead, with
``N`` workers stacked on it wherever the JAX example would have had ``N``
devices (the default worker count of the distributed trainers); without
``--cpu`` a machine with no card raises the platform's error.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from distkeras_torch.platform import resolve_device


def run_device(cpu: int, workers: Optional[int] = None) -> Tuple[torch.device, Optional[int]]:
    """``(device, default worker count)`` of an example's ``--cpu`` and
    ``--workers`` flags: ``--cpu N`` is the CPU with ``workers or N``;
    otherwise the card (raising without one) and ``workers`` (``None``: one
    per visible card)."""
    if cpu:
        return torch.device("cpu"), workers or int(cpu)
    return resolve_device(None), workers
