"""The port's LM training (``Model.forward``, ``lm_loss``,
``chunked_lm_loss``, ``make_train_step``, ``train_state_from_jax``, the
schedules) against the reference: the four dense archs.  The cases and
their tolerances are in ``torch_lm_train_cases.py``;
``test_torch_lm_train_moe.py``, ``test_torch_lm_train_ssm.py`` and
``test_torch_lm_train_cross.py`` run them for the other six archs."""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_lm_train_cases import *  # noqa: F401,F403,E402
from torch_lm_train_cases import (B, S, close, jax, lm_fixture,  # noqa: E402
                                  ts)

ARCHS = ["qwen1.5-0.5b", "qwen1.5-110b", "stablelm-12b",
         "command-r-plus-104b"]
lm = lm_fixture(ARCHS)


@pytest.mark.parametrize("window", [16, 40])
def test_windowed_forward_equals_the_reference(lm, window):
    """``window`` > 0: sliding-window causal attention in every layer."""
    with torch.no_grad():
        logits, _ = lm["model"].forward(lm["batch"], window=window)
        full, _ = lm["model"].forward(lm["batch"])
    jl, _ = jax.jit(lm["jmodel"].forward, static_argnames="window")(
        lm["jparams"], lm["jbatch"], window=window)
    close(logits, jl)
    assert float((full - logits).abs().max()) > 1e-3   # the mask bites
