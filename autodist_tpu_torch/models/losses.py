"""Loss-head math shared by the LM families.

Counterpart of ``autodist_tpu/models/losses.py``.
"""
from __future__ import annotations

import torch


def cross_entropy_from_logits(logits, targets):
    """Per-position negative log-likelihood of ``targets`` under
    ``logits [..., V]`` (promoted to fp32 for the softmax); ``targets``
    are integer ids shaped like ``logits[..., 0]``.  Returns fp32 nll of
    ``targets.shape``; reduce at the call site."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
