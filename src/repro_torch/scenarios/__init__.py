"""Online adaptation on a non-stationary provider pool (counterpart of
``repro.scenarios``): schedules, the dynamic pool, the non-stationary env
and the online driver."""
from repro_torch.scenarios.schedule import (ProviderEvent,  # noqa: F401
                                            ScenarioSchedule,
                                            BUILTIN_SCENARIOS,
                                            build_scenario, random_scenario)
from repro_torch.scenarios.pool import (DynamicProviderPool,  # noqa: F401
                                        PoolSnapshot, PoolView,
                                        build_segment_traces)
from repro_torch.scenarios.env import NonStationaryArmolEnv  # noqa: F401
from repro_torch.scenarios.online import (evaluate_segment,  # noqa: F401
                                          run_online)
