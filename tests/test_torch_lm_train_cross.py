"""The port's LM training against the reference: the vlm
(llama-3.2-vision-11b: a self block, then the gated cross layer over
image embeddings) and audio (seamless-m4t-medium: a non-causal encoder,
decoder blocks with cross-attention) archs, every all-zero leaf drawn as
noise so the cross path is live.  The cases and their tolerances are in
``torch_lm_train_cases.py``."""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_lm_train_cases import *  # noqa: F401,F403,E402
from torch_lm_train_cases import lm_fixture  # noqa: E402

ARCHS = ["llama-3.2-vision-11b", "seamless-m4t-medium"]
lm = lm_fixture(ARCHS)
