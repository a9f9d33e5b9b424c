"""Roofline of the port on the H100 (counterpart of ``repro.roofline``)."""
from repro_torch.roofline.analysis import (HW, model_flops,  # noqa: F401
                                           roofline_terms)
from repro_torch.roofline.measure import (achieved_point, measure,  # noqa: F401
                                          op_cost, timed_best)
