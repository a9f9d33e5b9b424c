"""Roofline of the port on the H100 (counterpart of ``repro.roofline``)."""
from repro_torch.roofline.analysis import (HW, collective_bytes,  # noqa: F401
                                           model_flops, parse_collectives,
                                           roofline_terms)
from repro_torch.roofline.measure import (achieved_point,  # noqa: F401
                                          counted_call, measure, op_cost,
                                          timed_best)
