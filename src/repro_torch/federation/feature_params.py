"""The state feature extractor's fixed weights.

The reference draws them from ``jax.random.PRNGKey(7)``
(``repro.federation.env``); the port cannot draw JAX's random bits, so the
3,019 floats are committed as ``feature_params.npz`` beside this module,
in the reference's layout (HWIO convs, (fan_in, fan_out) head).  This
command regenerates the file from the reference package on the CPU, from
the root of the checkout:

    PYTHONPATH=src JAX_PLATFORMS=cpu python -c "import jax, numpy as np; from repro.core.networks import init_feature_extractor as f; p = f(jax.random.PRNGKey(7)); np.savez('src/repro_torch/federation/feature_params.npz', **{f'convs.{i}.{k}': np.asarray(l[k]) for i, l in enumerate(p['convs']) for k in l}, **{f'head.{k}': np.asarray(v) for k, v in p['head'].items()})"
"""  # noqa: E501
from __future__ import annotations

from pathlib import Path

import numpy as np

from repro_torch.convert import (feature_extractor_from_jax,
                                 unflatten_feature_params)
from repro_torch.core.networks import FeatureExtractor

PATH = Path(__file__).resolve().parent / "feature_params.npz"


def load_params() -> dict:
    """The reference-layout nested parameter dict."""
    with np.load(PATH) as flat:
        return unflatten_feature_params(dict(flat))


def load_feature_extractor() -> FeatureExtractor:
    """The extractor with the committed weights, on the CPU."""
    return feature_extractor_from_jax(load_params())
