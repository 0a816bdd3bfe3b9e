"""Collective traffic per rank, by kind (PyTorch port of
``repro.launch.hlo_analysis.collective_stats``).

The reference parses compiled HLO, and walks its call graph to multiply
each ``while`` body's collectives by the loop's trip count. The port runs
its layers eagerly, so every layer's collectives are dispatched as they
run: ``CollectiveCounter``, a ``TorchDispatchMode``, counts the
functional collectives (``_c10d_functional.*``, what DTensor's
redistributions and ``local_map`` bodies call) as they are dispatched, and
no trip count needs recovering.

Per-rank convention (ring algorithms), the reference's: all-gather counts
its result, reduce-scatter its operand, all-to-all its operand, and
all-reduce twice its operand (its reduce-scatter and all-gather phases);
the (n-1)/n ring factor is folded to 1. ``collective-permute`` is kept as
a key; nothing in the port dispatches one.
"""
from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
MULT = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
        "all-to-all": 1.0, "collective-permute": 1.0}
NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")

#: op name -> (kind, whether its result (else its operand) is counted)
_OPS = {
    "all_gather_into_tensor": ("all-gather", True),
    "all_gather_into_tensor_coalesced": ("all-gather", True),
    "reduce_scatter_tensor": ("reduce-scatter", False),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", False),
    "all_reduce": ("all-reduce", False),
    "all_reduce_": ("all-reduce", False),
    "all_reduce_coalesced": ("all-reduce", False),
    "all_reduce_coalesced_": ("all-reduce", False),
    "all_to_all_single": ("all-to-all", False),
}


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.nbytes
    if isinstance(x, (list, tuple)):
        return sum(_bytes(t) for t in x)
    return 0


class CollectiveCounter(TorchDispatchMode):
    """Counts the functional collectives dispatched under it (on local
    tensors, any device, ``meta`` included). ``stats()`` gives the
    reference's keys: ``bytes`` and ``count`` by kind, ``total_bytes``,
    and ``static_count`` (the reference's count of collective
    instructions in the program text: here every dispatched call, the
    same as ``count``)."""

    def __init__(self):
        super().__init__()
        self.nbytes: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        if packet.__module__.split(".")[-1] in NAMESPACES \
                or getattr(packet, "_qualified_op_name", "").split("::")[0] \
                in NAMESPACES:
            hit = _OPS.get(packet.__name__)
            if hit is not None:
                kind, result = hit
                n = _bytes(out) if result else _bytes(args[0])
                self.nbytes[kind] += MULT[kind] * n
                self.calls[kind] += 1
        return out

    def stats(self) -> dict:
        return {
            "bytes": {k: float(v) for k, v in self.nbytes.items()},
            "count": {k: float(v) for k, v in self.calls.items()},
            "total_bytes": float(sum(self.nbytes.values())),
            "static_count": {k: int(self.calls.get(k, 0)) for k in KINDS},
        }
