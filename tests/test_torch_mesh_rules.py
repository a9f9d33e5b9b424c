"""``repro_torch.launch.sharding``'s rules against the reference's
``repro.launch.sharding`` (pure spec logic, no devices).

Every parameter of the ten archs at full size (the port's model built
under ``FakeTensorMode``, the reference's through ``jax.eval_shape``), in
both modes at model = data = 16: the port's spec equals the reference's
with its leading stack ``None``s dropped (the port's per-layer tensors
have no stack dims).  Every cache of ``init_cache(128, 32768)`` and the
batch specs on 16x16 and 2x16x16 equal the reference's.  Then each named
case of ``tests/test_sharding_rules.py`` once more, on the port's names.
The counterpart of its ``test_pjit_forward_on_host_mesh`` runs on a
process group (``test_torch_mesh_gloo.py``).
"""
import functools
import types

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch.sharding import P  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

SIZE = 16


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    model = build_model(jget_arch(arch))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return {jax.tree_util.keystr(path): (path, leaf) for path, leaf in
            jax.tree_util.tree_leaves_with_path(shapes)}


@functools.lru_cache(maxsize=None)
def port_model(arch):
    with FakeTensorMode():
        return Model(get_arch(arch), device="cpu", init=False)


def ref_key(arch, name):
    """The reference's path (keystr) of the port's parameter ``name``."""
    parts = [p for p in name.split(".") if not p.isdigit()]
    top = parts[0]
    if top == "unembed_weight":
        return "['unembed']"
    if top == "cross_blocks":
        parts = ["blocks", "cross"] + parts[1:]
    elif top == "blocks" and get_arch(arch).family == "vlm":
        parts = ["blocks", "selfs"] + parts[1:]
    return "".join(f"['{p}']" for p in parts)


def ref_spec(arch, name, mode):
    path, leaf = ref_params(arch)[ref_key(arch, name)]
    return jshd.param_pspec(path, leaf, jget_arch(arch), model_size=SIZE,
                            data_size=SIZE, mode=mode), leaf.shape


def port_spec(arch, name, mode):
    p = dict(port_model(arch).named_parameters())[name]
    return shd.param_pspec(name, p.shape, get_arch(arch), model_size=SIZE,
                           data_size=SIZE, mode=mode)


@pytest.mark.parametrize("mode", ["tp", "2d"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_param_spec_equals_the_reference(arch, mode):
    cfg = get_arch(arch)
    params = dict(port_model(arch).named_parameters())
    seen = set()
    for name, p in params.items():
        want, ref_shape = ref_spec(arch, name, mode)
        lead = len(ref_shape) - p.dim()
        assert tuple(ref_shape[lead:]) == tuple(p.shape), name
        assert all(e is None for e in tuple(want)[:lead]), (name, want)
        got = shd.param_pspec(name, p.shape, cfg, model_size=SIZE,
                              data_size=SIZE, mode=mode)
        assert tuple(got) == tuple(want)[lead:], (name, got, want)
        seen.add(ref_key(arch, name))
    # every reference leaf has a port parameter
    assert seen == set(ref_params(arch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_cache_spec_equals_the_reference(arch):
    jmodel = build_model(jget_arch(arch))
    want = jax.eval_shape(lambda: jmodel.init_cache(None, 128, 32768, None))
    with FakeTensorMode():
        cache = port_model(arch).init_cache(128, 32768)
    assert set(cache) == set(want)
    for key, t in cache.items():
        if key == "pos":
            continue
        assert tuple(t.shape) == tuple(want[key].shape), key
        ref = jshd.cache_pspec((jax.tree_util.DictKey(key),), want[key],
                               jget_arch(arch), model_size=SIZE,
                               data_size=SIZE, global_batch=128)
        got = shd.cache_pspec(key, t.shape, get_arch(arch), model_size=SIZE,
                              data_size=SIZE, global_batch=128)
        assert tuple(got) == tuple(ref), (key, got, ref)
    assert shd.cache_pspec("pos", (), get_arch(arch), model_size=SIZE,
                           data_size=SIZE, global_batch=128) == P()


class _Mesh:
    """A mesh's axis names and sizes, as the spec functions read them
    (both packages' meshes answer to the attribute each reads)."""

    def __init__(self, shape, names):
        self.axis_names = self.mesh_dim_names = names
        self.shape = tuple(shape)
        self.ref = types.SimpleNamespace(axis_names=names,
                                         shape=dict(zip(names, shape)))


MESHES = {"16x16": _Mesh((16, 16), ("data", "model")),
          "2x16x16": _Mesh((2, 16, 16), ("pod", "data", "model")),
          "1x1": _Mesh((1, 1), ("data", "model")),
          "4x2": _Mesh((4, 2), ("data", "model"))}


@pytest.mark.parametrize("batch", [1, 2, 8, 16, 32, 128, 256, 512, 1000])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_pspec_equals_the_reference(mesh, batch):
    m = MESHES[mesh]
    assert tuple(shd.batch_pspec(m, batch)) == tuple(
        jshd.batch_pspec(m.ref, batch))


def test_to_placements_and_specs_of_a_batch_dict():
    from torch.distributed.tensor import Replicate, Shard
    m = MESHES["2x16x16"]
    assert shd.to_placements(P(("pod", "data"), None), m) == [
        Shard(0), Shard(0), Replicate()]
    assert shd.to_placements(P(None, "model"), m) == [
        Replicate(), Replicate(), Shard(1)]
    with pytest.raises(ValueError, match="used twice"):
        shd.to_placements(P("data", "data"), m)
    batch = {"tokens": torch.zeros(64, 8), "image_embeds":
             torch.zeros(64, 3, 5)}
    assert shd.batch_shardings(MESHES["16x16"], batch, 64) == {
        "tokens": P(("data",), None),
        "image_embeds": P(("data",), None, None)}


# -- the named cases of tests/test_sharding_rules.py, on the port's names --

def test_dense_tp_rules():
    spec = functools.partial(port_spec, "qwen1.5-110b", mode="tp")
    assert spec("embed") == P("model", None)
    assert spec("blocks.0.attn.wq") == P(None, "model")
    # kv heads = 8 < 16 -> replicated kv projections
    assert spec("blocks.0.attn.wk") == P(None, None)
    assert spec("blocks.0.attn.wo") == P("model", None)
    assert spec("blocks.0.mlp.w_gate") == P(None, "model")
    assert spec("blocks.0.mlp.w_down") == P("model", None)


def test_dense_2d_adds_fsdp_axis():
    spec = functools.partial(port_spec, "qwen1.5-110b", mode="2d")
    assert spec("blocks.0.attn.wq") == P("data", "model")
    assert spec("blocks.0.mlp.w_down") == P("model", "data")


def test_moe_expert_parallel():
    spec = functools.partial(port_spec, "olmoe-1b-7b", mode="2d")
    # (E, d, dff): experts (64) over model axis
    assert spec("blocks.0.moe.w_gate") == P("model", "data", None)
    assert spec("blocks.0.moe.router") == P("data", None)


def test_deepseek_mla_rules():
    spec = functools.partial(port_spec, "deepseek-v2-236b", mode="2d")
    # wq_a deliberately replicated
    assert spec("blocks.0.attn.wq_a")[-1] is None
    assert spec("blocks.0.attn.wk_b")[-1] == "model"    # 128 heads
    assert spec("blocks.0.moe.w_gate") == P("model", "data", None)
    # the shared experts are no expert-parallel weights
    assert spec("blocks.0.moe.shared.w_gate") == P("data", "model")
    assert spec("dense_blocks.0.mlp.w_down") == P("model", "data")


def test_mamba_head_parallel():
    spec = functools.partial(port_spec, "mamba2-370m", mode="tp")
    assert spec("blocks.0.mamba.in_x") == P(None, "model")
    assert spec("blocks.0.mamba.in_z") == P(None, "model")
    assert spec("blocks.0.mamba.in_bc") == P(None, None)
    assert spec("blocks.0.mamba.out_proj") == P("model", None)
    assert spec("blocks.0.mamba.conv_x") == P("model", None)


def test_vlm_nested_stack_rules():
    spec = functools.partial(port_spec, "llama-3.2-vision-11b", mode="tp")
    # the reference's two stack dims (super, per-1) are the port's block
    # index; its cross layers are the port's cross_blocks
    assert spec("blocks.5.attn.wq") == P(None, "model")
    assert spec("cross_blocks.0.attn.wq") == P(None, "model")
    assert spec("cross_blocks.0.attn.gate") == P()
    assert spec("unembed_weight") == P(None, "model")


def test_cache_specs_decode():
    cfg = get_arch("command-r-plus-104b")
    with FakeTensorMode():
        cache = port_model("command-r-plus-104b").init_cache(128, 32768)
    spec_k = shd.cache_pspec("k", cache["k"].shape, cfg, model_size=16,
                             data_size=16, global_batch=128)
    # kv=8 not divisible by 16 -> sequence-sharded cache
    assert spec_k == P(None, "data", "model", None, None)
    cfg2 = get_arch("qwen1.5-0.5b")                  # kv=16 -> head-sharded
    with FakeTensorMode():
        cache2 = port_model("qwen1.5-0.5b").init_cache(128, 32768)
    spec_k2 = shd.cache_pspec("k", cache2["k"].shape, cfg2, model_size=16,
                              data_size=16, global_batch=128)
    assert spec_k2 == P(None, "data", None, "model", None)


def test_batch_pspec_fallbacks():
    mesh = MESHES["1x1"]
    assert shd.batch_pspec(mesh, 16) == P(("data",))
    # batch=1 not divisible -> replicated
    assert shd.batch_pspec(MESHES["4x2"], 1) == P(None)
    assert shd.batch_pspec(MESHES["2x16x16"], 16) == P("data")
