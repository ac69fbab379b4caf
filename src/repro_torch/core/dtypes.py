"""Kernel dtype policy of the port: the int32 policy only.

Labels, residuals and excess are int32; the label-infinity sentinel is
``2**30`` (every real label is strictly below it, and ``INF + 1`` cannot
overflow).  The narrow int16/int8 policies of the reference are not ported
yet (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import dataclasses

import torch

INF_LABEL_WIDE = 2 ** 30

DTYPE_POLICIES = ("int32",)


@dataclasses.dataclass(frozen=True)
class KernelDtypes:
    """Storage dtypes of the three value families a region kernel holds."""

    label: str = "int32"
    flow: str = "int32"
    mask: str = "int32"


WIDE = KernelDtypes()


def inf_label_for(dtype) -> int:
    """The label-infinity sentinel for a label dtype (int32 only)."""
    if dtype not in ("int32", torch.int32):
        raise ValueError(f"label dtype {dtype} is not int32; narrow labels "
                         f"are ROADMAP queue 1, item 9")
    return INF_LABEL_WIDE


def check_policy(policy: str) -> KernelDtypes:
    """Resolve a ``dtype_policy``; anything but ``"int32"`` is refused."""
    if policy not in DTYPE_POLICIES:
        raise ValueError(
            f"dtype_policy {policy!r} is not ported: only 'int32' is; the "
            f"narrow int16/int8 policies are ROADMAP queue 1, item 9")
    return WIDE
