# Armol's selector: the combinatorial action mapping, the SAC, TD3 and
# PPO agents with their fused update blocks, the numpy and
# device-resident replay buffers and the training drivers.  The environment and trace substrate is
# repro_torch.federation.
from repro_torch.core.action_space import (codebook,  # noqa: F401
                                           k_nearest, nearest_in_codebook,
                                           threshold_map,
                                           wolpertinger_select)
from repro_torch.core.blocks import update_block  # noqa: F401
from repro_torch.core.device_replay import DeviceReplayBuffer  # noqa: F401
from repro_torch.core.ppo import PPO, PPOConfig  # noqa: F401
from repro_torch.core.replay_buffer import ReplayBuffer  # noqa: F401
from repro_torch.core.sac import SAC, SACConfig  # noqa: F401
from repro_torch.core.td3 import TD3, TD3Config  # noqa: F401
