"""``repro_torch.checkpoint.store`` (after the reference's
``test_substrates.py`` checkpoint tests): the file pair of the reference
(``.npz`` + ``.meta.json``, bfloat16 as a ``uint16`` view), a round trip
of a nested tree with a bf16 leaf, and a raise on a shape or leaf-count
mismatch.  Where JAX is installed, the reference's ``load_pytree`` reads
a file the port wrote, and the port reads one the reference wrote."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.store import load_pytree, save_pytree  # noqa: E402


def tree():
    return {"a": torch.tensor([1.0, 2.0], dtype=torch.bfloat16),
            "b": {"c": torch.arange(6, dtype=torch.int32).reshape(2, 3)},
            "d": torch.tensor(3.5),
            "e": [torch.ones(2, 2), torch.zeros(3, dtype=torch.float64)]}


def zeros_like(t):
    if isinstance(t, dict):
        return {k: zeros_like(v) for k, v in t.items()}
    if isinstance(t, list):
        return [zeros_like(v) for v in t]
    return torch.zeros_like(t)


def test_roundtrip_with_a_bf16_leaf(tmp_path):
    path = os.path.join(tmp_path, "ckpt")
    save_pytree(path, tree())
    meta = json.loads((tmp_path / "ckpt.meta.json").read_text())
    assert meta["n"] == 5 and meta["dtypes"][0] == "__bf16__"
    with np.load(tmp_path / "ckpt.npz") as data:
        assert data["leaf_0"].dtype == np.uint16
    out = load_pytree(path + ".npz", zeros_like(tree()))
    assert out["a"].dtype == torch.bfloat16
    assert out["a"].tolist() == [1.0, 2.0]
    for got, want in ((out["b"]["c"], tree()["b"]["c"]),
                      (out["d"], tree()["d"]), (out["e"][0], tree()["e"][0]),
                      (out["e"][1], tree()["e"][1])):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


def test_model_parameters_roundtrip(tmp_path):
    from repro_torch.configs.base import get_arch
    from repro_torch.models.model import Model
    cfg = get_arch("qwen1.5-0.5b").reduced()
    model = Model(cfg, device="cpu", seed=0)
    path = str(tmp_path / "params")
    save_pytree(path, dict(model.named_parameters()))
    other = Model(cfg, device="cpu", seed=1)
    like = dict(other.named_parameters())
    out = load_pytree(path, like)
    for name, p in model.named_parameters():
        assert torch.equal(out[name], p.detach()), name


def test_shape_or_leaf_count_mismatch_raises(tmp_path):
    path = os.path.join(tmp_path, "ckpt.npz")
    save_pytree(path, {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="leaf 0"):
        load_pytree(path, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="1 leaves, target has 2"):
        load_pytree(path, {"a": torch.zeros(2), "b": torch.zeros(1)})


def test_files_read_by_the_other_package(tmp_path):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.checkpoint.store import load_pytree as jload
    from repro.checkpoint.store import save_pytree as jsave
    save_pytree(str(tmp_path / "port"), tree())
    jlike = jax.tree.map(lambda t: jnp.zeros(t.shape), zeros_like(tree()),
                         is_leaf=lambda t: isinstance(t, torch.Tensor))
    got = jload(str(tmp_path / "port"), jlike)
    assert got["a"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["b"]["c"]),
                                  tree()["b"]["c"].numpy())
    jsave(str(tmp_path / "ref"), got)
    back = load_pytree(str(tmp_path / "ref"), zeros_like(tree()))
    assert back["a"].dtype == torch.bfloat16
    for a, b in ((back["a"], tree()["a"]), (back["e"][0], tree()["e"][0])):
        assert torch.equal(a, b)
