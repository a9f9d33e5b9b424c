"""Three-term roofline model of one NVIDIA H100 SXM (counterpart of
``repro.roofline.analysis``):

  compute term    = FLOPs      / (chips * peak FLOP/s)
  memory term     = bytes      / (chips * HBM bandwidth)
  collective term = coll_bytes / (chips * link bandwidth)

``HW`` holds the card's published peaks (NVIDIA's data sheet, SXM part,
dense, at the 700 W power limit): ``peak_flops`` is float32 outside the
tensor cores, the rate of the port's GEMMs (float32 with TF32 off);
``tf32_flops`` is the TF32 tensor-core rate, the route of the flash and
SSD kernels' 3xTF32 products; ``link_bw`` is NVLink, 450 GB/s each way.

collective_bytes sums the result bytes of every collective a DTensor
program issues, with the reference's op-specific traffic multiplier
(ring all-reduce moves ~2x its buffer; the others ~1x).  The reference
parses them out of XLA's post-SPMD HLO text; the port has no HLO, so
``roofline/measure.py`` records each ``_c10d_functional`` op (all-gather,
all-reduce, reduce-scatter, all-to-all) and DTensor's own shard-to-shard
all-to-all (and any permute, send or receive) that each rank dispatches,
with its result's bytes, and ``parse_collectives``/``collective_bytes``
read that record.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class HW:
    """NVIDIA H100 SXM."""
    peak_flops: float = 67e12        # float32 FLOP/s, CUDA cores
    tf32_flops: float = 495e12       # TF32 tensor-core FLOP/s
    hbm_bw: float = 3.35e12          # B/s
    link_bw: float = 450e9           # B/s, NVLink each way


_TRAFFIC_MULT = {
    "all-reduce": 2.0,        # ring: reduce-scatter + all-gather
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}
# namespaces of the collective operators and the kind each name maps to
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional",
                          "_c10d_functional_autograd", "_dtensor", "c10d")
_KIND_OF = (("all_gather", "all-gather"), ("allgather", "all-gather"),
            ("reduce_scatter", "reduce-scatter"),
            ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
            ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
            ("permute", "collective-permute"),
            ("send", "collective-permute"), ("recv", "collective-permute"))
_NOT_COLLECTIVE = ("wait_tensor", "barrier")


def collective_kind(op_name: str) -> Optional[str]:
    """The collective kind of an operator's qualified name
    (``"_c10d_functional.all_gather_into_tensor.default"`` ->
    ``"all-gather"``); None for an operator that moves nothing between
    ranks.  Raises for a collective of no known kind, so that nothing a
    rank sends goes uncounted."""
    namespace, _, rest = op_name.partition(".")
    if namespace not in _COLLECTIVE_NAMESPACES or rest.startswith(
            _NOT_COLLECTIVE):
        return None
    for pattern, kind in _KIND_OF:
        if pattern in rest:
            return kind
    if namespace == "_dtensor":
        return None
    raise ValueError(f"collective {op_name} has no known kind")


def parse_collectives(calls: Iterable[Tuple[str, int]]
                      ) -> List[Tuple[str, int]]:
    """[(operator name, result bytes), ...] as one rank dispatched them ->
    [(op_kind, traffic_bytes_per_device), ...]."""
    out = []
    for name, nbytes in calls:
        kind = collective_kind(name)
        if kind is not None:
            out.append((kind, int(nbytes * _TRAFFIC_MULT[kind])))
    return out


def collective_bytes(calls: Iterable[Tuple[str, int]]) -> Dict[str, float]:
    """Traffic bytes per device by kind, and their ``total``."""
    per_kind: Dict[str, float] = {}
    for kind, b in parse_collectives(calls):
        per_kind[kind] = per_kind.get(kind, 0) + b
    per_kind["total"] = sum(per_kind.values())
    return per_kind


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float, hw: HW = HW()
                   ) -> Dict[str, float]:
    t_c = flops_per_dev / hw.peak_flops
    t_m = bytes_per_dev / hw.hbm_bw
    t_x = coll_bytes_per_dev / hw.link_bw
    dom = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))[1]
    return {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
            "dominant": dom}


def model_flops(cfg: ArchConfig, tokens: int, *, train: bool) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); 2*N*D for
    inference."""
    n = cfg.active_param_count()
    mult = 6.0 if train else 2.0
    return mult * n * tokens
