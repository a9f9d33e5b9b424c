from repro_torch.federation.vocab import (COCO_TEMPLATE,  # noqa: F401
                                          WordGrouper)
from repro_torch.federation.providers import (  # noqa: F401
    ProviderProfile, default_providers, scalability_providers)
from repro_torch.federation.traces import (TraceSet,  # noqa: F401
                                           generate_traces)
from repro_torch.federation.env import ArmolEnv  # noqa: F401
from repro_torch.federation.evaluation import (  # noqa: F401
    SubsetEvaluationCore, action_to_mask, mask_to_action, popcount_masks)
