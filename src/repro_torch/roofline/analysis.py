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

The reference also parses collective bytes out of XLA's post-SPMD HLO
text (``parse_collectives``, ``collective_bytes``).  The port has no HLO
and no mesh yet: those two have no counterpart until the mesh and
sharding slice (``launch/mesh.py``, ``sharding.py``), and a caller passes
its collective bytes to ``roofline_terms`` itself.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class HW:
    """NVIDIA H100 SXM."""
    peak_flops: float = 67e12        # float32 FLOP/s, CUDA cores
    tf32_flops: float = 495e12       # TF32 tensor-core FLOP/s
    hbm_bw: float = 3.35e12          # B/s
    link_bw: float = 450e9           # B/s, NVLink each way


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
