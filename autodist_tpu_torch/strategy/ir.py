"""The Strategy IR normalizers the serving engine reads.

A copy of ``normalize_kernel``, ``normalize_kv_layout``,
``normalize_prefill_chunk``, ``normalize_prefix_caching`` and
``normalize_speculative`` from ``autodist_tpu/strategy/ir.py``, with the
same canonical forms and the same errors, so that an engine kwarg or a
strategy's ``parallel`` record means the same thing to both packages.
The rest of the IR (the ``Strategy`` object, precision policies, JSON
serialization) is not ported yet.
"""
from __future__ import annotations

from autodist_tpu_torch.kernel import KERNEL_CHOICES


class UnknownKernelError(ValueError):
    """A kernel name outside :data:`~autodist_tpu_torch.kernel
    .KERNEL_CHOICES`."""


def normalize_kernel(policy) -> dict:
    """Canonicalize a fused-kernel election.

    ``None``/``{}``/``False``/``""`` -> ``{}``; ``True``/``"all"``
    elects every kernel; a bare name or an iterable of names elects
    those; a dict keeps only truthy entries.  The canonical form maps
    each elected name to ``True``.  Unknown names raise
    :class:`UnknownKernelError`.
    """
    if policy in (None, False, "", {}, (), []):
        return {}
    if policy is True or policy == "all":
        return {k: True for k in KERNEL_CHOICES}
    if isinstance(policy, str):
        policy = (policy,)
    if isinstance(policy, dict):
        names = [k for k, v in policy.items() if v]
    elif isinstance(policy, (list, tuple, set, frozenset)):
        names = list(policy)
    else:
        raise UnknownKernelError(
            f"kernel election must be a name, an iterable of names, or "
            f"a name->bool dict; got {type(policy).__name__}")
    out = {}
    for name in names:
        if name not in KERNEL_CHOICES:
            raise UnknownKernelError(
                f"unknown kernel {name!r}; expected one of "
                f"{list(KERNEL_CHOICES)}")
        out[name] = True
    return {k: True for k in KERNEL_CHOICES if k in out}


KV_LAYOUTS = ("dense", "paged")


class UnknownKVLayoutError(ValueError):
    """A kv_layout outside :data:`KV_LAYOUTS`."""


def normalize_kv_layout(value) -> str:
    """``None``/``""`` -> ``"dense"``; unknown names raise
    :class:`UnknownKVLayoutError`."""
    if value in (None, ""):
        return "dense"
    if value not in KV_LAYOUTS:
        raise UnknownKVLayoutError(
            f"unknown kv_layout {value!r}; expected one of "
            f"{list(KV_LAYOUTS)}")
    return str(value)


def normalize_prefill_chunk(value):
    """``None``/``0``/``False`` -> ``None`` (single-shot prefill); a
    positive int is the chunk length in tokens.  Anything else raises
    ``ValueError``."""
    if value in (None, 0, False, ""):
        return None
    if isinstance(value, bool) or not isinstance(value, int) or value < 1:
        raise ValueError(
            f"prefill_chunk must be None or a positive int (tokens per "
            f"prefill chunk); got {value!r}")
    return int(value)


def normalize_prefix_caching(value) -> bool:
    """Truthy -> ``True``, anything falsy -> ``False``."""
    return bool(value)


def normalize_speculative(value):
    """``None``/``0``/``False`` -> ``None`` (vanilla decode); a positive
    int is the number of draft tokens per verify step.  Anything else
    raises ``ValueError``."""
    if value in (None, 0, False, ""):
        return None
    if isinstance(value, bool) or not isinstance(value, int) or value < 1:
        raise ValueError(
            f"speculative must be None or a positive int (draft tokens "
            f"per verify step); got {value!r}")
    return int(value)
