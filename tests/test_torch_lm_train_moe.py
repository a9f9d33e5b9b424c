"""The port's LM training against the reference: the moe archs
(olmoe-1b-7b with GQA and qk-norm, deepseek-v2-236b with MLA, a first
dense layer and a shared expert), aux loss included.  The cases and their
tolerances are in ``torch_lm_train_cases.py``."""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_lm_train_cases import *  # noqa: F401,F403,E402
from torch_lm_train_cases import lm_fixture  # noqa: E402

ARCHS = ["olmoe-1b-7b", "deepseek-v2-236b"]
lm = lm_fixture(ARCHS)
