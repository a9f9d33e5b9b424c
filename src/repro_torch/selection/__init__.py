"""Selection policies: non-RL subset selectors behind the agent surface
(counterpart of ``repro.selection``).

See ``docs/policies.md`` for the interface contract and knobs; the port's
policies are numpy over the port's subset core, bit-identical to the
reference's given the same features.  ``frontier`` is not imported here.
"""
from repro_torch.selection.base import SelectorPolicy  # noqa: F401
from repro_torch.selection.cascade import (CascadeSelector,  # noqa: F401
                                     detection_confidence)
from repro_torch.selection.hybrid import HybridSelector  # noqa: F401
from repro_torch.selection.mct import MCTSelector  # noqa: F401
