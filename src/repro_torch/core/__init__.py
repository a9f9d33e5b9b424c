# Armol's selector: the combinatorial action mapping, the SAC and TD3
# agents with their fused update blocks, the replay buffer and the
# off-policy training drivers.  The environment and trace substrate is
# repro_torch.federation.
from repro_torch.core.action_space import (codebook,  # noqa: F401
                                           k_nearest, nearest_in_codebook,
                                           threshold_map,
                                           wolpertinger_select)
from repro_torch.core.blocks import update_block  # noqa: F401
from repro_torch.core.replay_buffer import ReplayBuffer  # noqa: F401
from repro_torch.core.sac import SAC, SACConfig  # noqa: F401
from repro_torch.core.td3 import TD3, TD3Config  # noqa: F401
