# Armol's selector, serving half: the combinatorial action mapping, the
# SAC actor and the state feature extractor.  The environment and trace
# substrate is repro_torch.federation.
from repro_torch.core.action_space import (codebook,  # noqa: F401
                                           nearest_in_codebook,
                                           threshold_map)
from repro_torch.core.sac import SAC, SACConfig  # noqa: F401
