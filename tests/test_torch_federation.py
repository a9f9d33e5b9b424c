"""The port's serving slice against the reference, on the CPU.

Inputs come from numpy seeds and go through both packages.  Everything
on the numpy path (traces, tables, ensembles, AP50, lattices, costs) must
be bit-identical; the conv features and actor protos differ by float32
summation order only (atol 1e-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402

from repro.core import networks as jnets  # noqa: E402
from repro.core.loops import ensembleN_policy as j_ensN  # noqa: E402
from repro.core.loops import evaluate_policy as j_eval  # noqa: E402
from repro.core.sac import SAC as JSAC, SACConfig as JSACConfig  # noqa: E402
from repro.federation.env import ArmolEnv as JEnv  # noqa: E402
from repro.federation.evaluation import (  # noqa: E402
    SubsetEvaluationCore as JCore, popcount_masks)
from repro.federation.providers import (  # noqa: E402
    default_providers as j_default, scalability_providers as j_scal)
from repro.federation.traces import generate_traces as j_gen  # noqa: E402
from repro.serving.federation_service import (  # noqa: E402
    FederationService as JService)
from repro_torch.convert import (actor_from_jax,  # noqa: E402
                                 feature_extractor_from_jax)
from repro_torch.core.loops import ensembleN_policy as t_ensN  # noqa: E402
from repro_torch.core.loops import evaluate_policy as t_eval  # noqa: E402
from repro_torch.core.sac import SAC as TSAC, SACConfig as TSACConfig  # noqa: E402,E501
from repro_torch.federation import feature_params  # noqa: E402
from repro_torch.federation.env import ArmolEnv as TEnv  # noqa: E402
from repro_torch.federation.evaluation import (  # noqa: E402
    ShardedSubsetEvaluationCore as TShardedCore,
    SubsetEvaluationCore as TCore)
from repro_torch.federation.providers import (  # noqa: E402
    default_providers as t_default, scalability_providers as t_scal)
from repro_torch.federation.traces import generate_traces as t_gen  # noqa: E402,E501
from repro_torch.serving.federation_service import (  # noqa: E402
    FederationService as TService)

ROSTERS = {3: (j_default, t_default), 10: (j_scal, t_scal)}
N_IMAGES = 40


@pytest.fixture(scope="module", params=[3, 10], ids=["N3", "N10"])
def traces(request):
    j_roster, t_roster = ROSTERS[request.param]
    return (j_gen(j_roster(), N_IMAGES, seed=5),
            t_gen(t_roster(), N_IMAGES, seed=5))


@pytest.fixture(scope="module")
def envs():
    """Reference and port envs on the same N=3 traces (seed 5)."""
    jtr = j_gen(j_default(), N_IMAGES, seed=5)
    ttr = t_gen(t_default(), N_IMAGES, seed=5)
    return (JEnv(jtr, mode="gt", beta=0.0, seed=0),
            TEnv(ttr, mode="gt", beta=0.0, seed=0, device="cpu"))


def assert_dets_equal(a, b):
    for f in ("boxes", "scores", "labels", "providers"):
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None
            continue
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

def test_traces_bit_identical(traces):
    jtr, ttr = traces
    np.testing.assert_array_equal(jtr.images, ttr.images)
    assert jtr.images.dtype == ttr.images.dtype
    np.testing.assert_array_equal(jtr.costs(), ttr.costs())
    assert jtr.categories == ttr.categories
    for t in range(N_IMAGES):
        assert_dets_equal(jtr.gts[t], ttr.gts[t])
        np.testing.assert_array_equal(jtr.difficulties[t],
                                      ttr.difficulties[t])
        for jd, td in zip(jtr.dets[t], ttr.dets[t]):
            assert_dets_equal(jd, td)
        for jr, tr in zip(jtr.raw[t], ttr.raw[t]):
            np.testing.assert_array_equal(jr.boxes, tr.boxes)
            assert jr.words == tr.words


def test_category_features_chunked_bit_identical(traces, monkeypatch):
    from repro.federation.traces import category_features as j_cf
    from repro_torch.federation import traces as t_traces
    jtr, ttr = traces
    want = j_cf(jtr.images, len(jtr.categories))
    monkeypatch.setattr(t_traces, "CATEGORY_CHUNK", 7)
    got = t_traces.category_features(ttr.images, len(ttr.categories))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# subset-evaluation core
# ---------------------------------------------------------------------------

def test_evaluate_batch_and_rows_bit_identical(traces):
    jtr, ttr = traces
    jc = JCore(jtr, use_kernel=False)
    tc = TCore(ttr, device="cpu")
    assert tc.use_kernel is False
    n = jtr.n_providers
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, N_IMAGES, 120)
    actions = rng.integers(0, 2, (120, n)).astype(np.float32)
    for against in ("gt", "pseudo"):
        jo = jc.evaluate_batch(imgs, actions, beta=-0.1, against=against)
        to = tc.evaluate_batch(imgs, actions, beta=-0.1, against=against)
        for k in ("reward", "ap50", "cost", "mask"):
            assert jo[k].dtype == to[k].dtype
            np.testing.assert_array_equal(jo[k], to[k])
    masks = rng.integers(0, 1 << n, 120)
    for jr, tr in zip(jc.ensemble_rows(imgs, masks),
                      tc.ensemble_rows(imgs, masks)):
        for x, y in zip(jr, tr):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    for img in range(N_IMAGES):
        np.testing.assert_array_equal(jc.table(img).iou, tc.table(img).iou)
        for m in masks[:8]:
            assert jc.ap50(img, int(m)) == tc.ap50(img, int(m))


def test_lattice_rows_bit_identical(traces):
    jtr, ttr = traces
    jc = JCore(jtr, use_kernel=False)
    tc = TCore(ttr, device="cpu")
    for img in range(N_IMAGES):
        for against in ("gt", "pseudo"):
            jl = jc.evaluate_lattice(img, against=against)
            tl = tc.evaluate_lattice(img, against=against)
            for x, y in zip(jl.to_wire(), tl.to_wire()):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    assert tl.masks.tolist() == popcount_masks(jtr.n_providers)


def test_sharded_core_equals_unsharded(traces):
    _, ttr = traces
    flat = TCore(ttr, device="cpu")
    sharded = TShardedCore(ttr, n_shards=3, device="cpu")
    for img in range(0, N_IMAGES, 3):
        for m in range(1, 1 << ttr.n_providers, 5):
            assert_dets_equal(sharded.ensemble(img, m), flat.ensemble(img, m))
            assert sharded.ap50(img, m) == flat.ap50(img, m)
        assert sharded.shard_id(img) == img % 3
    assert all(i % 3 == s for s, imgs in enumerate(sharded.shard_images())
               for i in imgs)


# ---------------------------------------------------------------------------
# action space, features and actor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 10])
def test_threshold_map_matches_reference_and_codebook(n):
    from repro.core.action_space import threshold_map as j_tau
    from repro_torch.core.action_space import (nearest_in_codebook,
                                               threshold_map)
    rng = np.random.default_rng(n)
    proto = rng.random((500, n)).astype(np.float32)
    proto[:100] *= 0.5                      # all <= 0.5: argmax switched on
    proto[100:120] = 0.5                    # exactly 0.5 is not selected
    proto[120:140, :2] = 0.25               # ties: the first maximum wins
    proto[120:140, 2:] = 0.1
    want = np.asarray(j_tau(proto))
    got = threshold_map(torch.from_numpy(proto)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        nearest_in_codebook(torch.from_numpy(proto[140:]), n).numpy(),
        want[140:])

def test_committed_feature_params_equal_fresh_init():
    fresh = jnets.init_feature_extractor(jax.random.PRNGKey(7), feat_dim=64)
    got = feature_params.load_params()
    assert len(got["convs"]) == len(fresh["convs"])
    for g, f in zip(got["convs"], fresh["convs"]):
        for k in ("dw", "pw"):
            np.testing.assert_array_equal(g[k], np.asarray(f[k]))
    for k in ("w", "b"):
        np.testing.assert_array_equal(got["head"][k],
                                      np.asarray(fresh["head"][k]))


def test_conv_features_close_to_reference(envs):
    jenv, tenv = envs
    assert tenv.features.shape == jenv.features.shape
    assert tenv.features.dtype == np.float32
    # the conv sums run in another order than XLA's: float32 rounding
    np.testing.assert_allclose(tenv.features, jenv.features, atol=1e-5,
                               rtol=0)


def test_extractor_on_odd_sizes_matches_jax_same_padding():
    """SAME padding puts the odd pixel at the end: checked off the 48x48
    path too, on a 13x10 input."""
    fresh = jnets.init_feature_extractor(jax.random.PRNGKey(7), feat_dim=64)
    img = np.random.default_rng(1).random((13, 10, 3)).astype(np.float32)
    want = np.asarray(jnets.extract_features(fresh, img))
    fx = feature_extractor_from_jax(
        jax.tree.map(np.asarray, fresh))
    with torch.no_grad():
        got = fx(torch.from_numpy(img[None]))[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_actor_protos_close_after_conversion(envs):
    jenv, _ = envs
    jsac = JSAC(JSACConfig(state_dim=jenv.state_dim, n_providers=3, seed=2))
    tsac = TSAC(TSACConfig(state_dim=jenv.state_dim, n_providers=3, seed=2),
                device="cpu")
    actor_from_jax(jax.tree.map(np.asarray, jsac.state.actor), tsac.actor)
    s = jenv.features
    want = np.asarray(jnets.mean_action(jsac.state.actor, s))
    got = tsac.protos(s, deterministic=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the same normal draws give the same stochastic protos and log-probs
    noise = np.random.default_rng(4).standard_normal(
        (len(s), 3)).astype(np.float32)
    mu, log_std = jnets.actor_dist(jsac.state.actor, s)
    u = mu + np.exp(log_std) * noise
    from repro_torch.core import networks as tnets
    proto, logp = tnets.sample_action(tsac.actor, torch.from_numpy(s),
                                      noise=torch.from_numpy(noise))
    np.testing.assert_allclose(proto.detach().numpy(),
                               0.5 * (np.tanh(u) + 1.0), atol=1e-5, rtol=0)
    assert logp.shape == (len(s),)


# ---------------------------------------------------------------------------
# serving and policy evaluation
# ---------------------------------------------------------------------------

def test_handle_many_matches_reference(envs, monkeypatch):
    jenv, tenv = envs
    # the reference's features on the port's env: the comparison is of
    # the serving path, not of the conv summation order
    monkeypatch.setattr(tenv, "features", jenv.features.copy())
    jsac = JSAC(JSACConfig(state_dim=jenv.state_dim, n_providers=3, seed=1))
    tsac = TSAC(TSACConfig(state_dim=tenv.state_dim, n_providers=3, seed=1),
                device="cpu")
    actor_from_jax(jax.tree.map(np.asarray, jsac.state.actor), tsac.actor)
    imgs = np.random.default_rng(0).integers(0, N_IMAGES, 64)
    protos = np.asarray(jnets.mean_action(jsac.state.actor,
                                          jenv.features[imgs]))
    ambiguous = np.any(np.abs(protos - 0.5) < 1e-4, axis=1)
    assert ambiguous.sum() < len(imgs) // 4
    jres = JService(jenv, jsac).handle_many(imgs)
    tres = TService(tenv, tsac).handle_many(imgs)
    assert len(jres) == len(tres) == len(imgs)
    for skip, j, t in zip(ambiguous, jres, tres):
        if skip:
            continue
        np.testing.assert_array_equal(j.action, t.action)
        assert_dets_equal(j.detections, t.detections)
        assert j.cost_milli_usd == t.cost_milli_usd
        assert j.latency_ms == t.latency_ms
    assert len({tuple(r.action) for r in tres}) > 1
    one = TService(tenv, tsac).handle(int(imgs[0]))
    np.testing.assert_array_equal(one.action, tres[0].action)
    assert_dets_equal(one.detections, tres[0].detections)
    assert TService(tenv, tsac).handle_many([]) == []


def test_evaluate_policy_ensemble_n_matches_reference(envs):
    jenv, tenv = envs
    want = j_eval(j_ensN(jenv), jenv)
    got = t_eval(t_ensN(tenv), tenv)
    assert got == want
