"""The port's LM training against the reference: the ssm (mamba2-370m)
and hybrid (zamba2-2.7b: Mamba-2 blocks and one shared attention block
after each super-block) archs, through the SSD scan over two chunks.  The
cases and their tolerances are in ``torch_lm_train_cases.py``."""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_lm_train_cases import *  # noqa: F401,F403,E402
from torch_lm_train_cases import lm_fixture  # noqa: E402

ARCHS = ["mamba2-370m", "zamba2-2.7b"]
lm = lm_fixture(ARCHS)
