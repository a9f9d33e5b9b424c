"""Property-based cascade contract on the port (hypothesis), the mirror
of ``tests/test_selection_fuzz.py``: for arbitrary thresholds, betas and
trace seeds the port's cascade never pays for a second provider once an
image's confidence clears the threshold, every served subset contains
the base provider, and its masks equal the reference's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
hypothesis = pytest.importorskip("hypothesis")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.federation.env import ArmolEnv as JArmolEnv  # noqa: E402
from repro.federation.providers import (  # noqa: E402
    default_providers as j_default)
from repro.federation.traces import generate_traces as j_traces  # noqa: E402
from repro.selection import CascadeSelector as JCascade  # noqa: E402
from repro_torch.federation.env import ArmolEnv  # noqa: E402
from repro_torch.federation.providers import default_providers  # noqa: E402
from repro_torch.federation.traces import generate_traces  # noqa: E402
from repro_torch.selection import CascadeSelector  # noqa: E402

PROVS = default_providers()
J_PROVS = j_default()
_ENVS = {}


def _envs(seed: int):
    if seed not in _ENVS:
        before = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            t = ArmolEnv(generate_traces(PROVS, 30, seed=seed), mode="gt",
                         beta=0.0, seed=seed + 1, device="cpu")
        finally:
            torch.set_num_threads(before)
        j = JArmolEnv(j_traces(J_PROVS, 30, seed=seed), mode="gt", beta=0.0,
                      seed=seed + 1)
        _ENVS[seed] = (t, j)
    return _ENVS[seed]


@settings(max_examples=40, deadline=None)
@given(threshold=st.one_of(st.floats(0.0, 1.2), st.just(float("inf"))),
       beta=st.floats(-1.0, 0.0),
       seed=st.integers(0, 3))
def test_cascade_never_pays_past_a_passing_threshold(threshold, beta, seed):
    env, jenv = _envs(seed)
    cas = CascadeSelector(env, beta=beta, threshold=threshold)
    jcas = JCascade(jenv, beta=beta, threshold=threshold)
    imgs = [int(i) for i in env.test_idx]
    confs = np.asarray([cas.confidence(i) for i in imgs])
    masks = cas.select_masks(imgs)
    np.testing.assert_array_equal(masks, jcas.select_masks(imgs))
    assert cas.calibration == jcas.calibration
    for conf, mask in zip(confs, masks):
        mask = int(mask)
        assert mask & cas.base_mask, "every subset contains the base"
        if conf >= cas.threshold:
            assert mask == cas.base_mask, (
                f"confidence {conf} passed threshold {cas.threshold} but "
                f"the cascade paid for mask {mask:b}")
