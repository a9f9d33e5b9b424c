"""LM training of the port (counterpart of ``repro.training``)."""
from repro_torch.training.train_step import (TrainState,  # noqa: F401
                                             init_train_state,
                                             make_train_step)
