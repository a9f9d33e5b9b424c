"""The sharded port on CPU process groups (gloo), held to the unsharded
port from the same seed (``torch_mesh_gloo_cases.py``, run once in a
subprocess, so that no process group outlives it).

Two ranks, mesh (1, 2) ``tp``: reduced qwen1.5-0.5b, olmoe-1b-7b and
stablelm-12b with ``num_kv_heads=1`` (K does not divide the model axis:
the flash call repeats the key/value head, the cache is sharded along
the sequence): prefill logits within 1e-5, then ten decode steps whose
logits and caches stay within 1e-5.  Two ranks, mesh (2, 1) ``2d``: one
train step of reduced qwen1.5-0.5b (flash) and mamba2-370m (SSD): loss,
grad norm, every parameter and AdamW moment within 1e-6 (the sharded
sums run in another order).  Four ranks, mesh (2, 2), both axes split
(batch over "data" beside heads, experts, vocab or ``d_inner`` over
"model"): the same three ``tp`` runs, and one ``2d`` train step of
reduced qwen1.5-0.5b, olmoe-1b-7b and mamba2-370m, held to the same
tolerances.  One rank, mesh (1, 1): the counterpart of
the reference's ``test_pjit_forward_on_host_mesh``, whose embedding
lookup fails under JAX 0.9's explicit mesh axes: here the lookup on the
vocab-sharded ``embed`` gives finite logits equal to the unsharded ones.
Two ranks, mesh (1, 2) ``tp``: reduced deepseek-v2-ep8 with MLA's card
route on a stand-in launch (the plain version written into the kernel's
output): each layer's MLA reaches the launch once a rank, on half the
heads, and the prefill logits equal the unsharded einsum's.  The
decode's card route on a stand-in launch (the plain partials of the
kernel's splits): two ranks, mesh (1, 2) ``tp``, reduced qwen1.5-0.5b
(each rank's half of the heads through the custom op) and stablelm-12b
with ``num_kv_heads=1`` (each rank's half of the cache sharded along W,
partials merged across the ranks), and four ranks, mesh (2, 2), the
latter beside a batch split: each layer's decode reaches the launch once
a rank and step, and ten decode steps' logits stay within 1e-5 of the
unsharded port's plain decode.  The Mamba step's card route on a stand-in
launch (the plain step written into the kernel's outputs): reduced
mamba2-370m (its Mamba leaves drawn), mesh (1, 2) ``tp`` (each rank's
half of the heads) and (2, 2) (and its half of the rows): each layer's
step launches once a rank and step on its shard, and ten decode steps'
logits and the caches after them stay within 1e-5 of the unsharded
port's plain step.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

HERE = Path(__file__).resolve().parent
SERVE_TOL = 1e-5
TRAIN_TOL = 1e-6


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("gloo") / "results.json"
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"))
    run = subprocess.run(
        [sys.executable, str(HERE / "torch_mesh_gloo_cases.py"), str(out)],
        env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    return json.loads(out.read_text())


def case(results, name):
    got = results[name]
    assert "error" not in got, got.get("error")
    return got


@pytest.mark.parametrize("name", ["tp_qwen", "tp_olmoe", "tp_stablelm_kv1",
                                  "tp_qwen_2x2", "tp_olmoe_2x2",
                                  "tp_stablelm_kv1_2x2"])
def test_tp_prefill_and_decode_equal_the_unsharded_port(results, name):
    got = case(results, name)
    assert got["sharded_params"] > 0
    assert got["prefill_logits"] <= SERVE_TOL
    assert got["decode_logits"] <= SERVE_TOL
    assert got["caches"] and max(got["caches"].values()) <= SERVE_TOL, got
    assert got["pos"] == [64 + 10, 64 + 10]


def test_kv_heads_below_the_model_axis_shard_the_cache_by_sequence(results):
    got = case(results, "tp_stablelm_kv1")
    # (L, B, W, K, hd), batch over "data" (one rank): K = 1 does not
    # divide 2 -> W over "model"; qwen's K = 4 does -> K over "model"
    assert got["cache_placements"]["k"] == \
        "(Shard(dim=1), Shard(dim=2))"
    assert case(results, "tp_qwen")["cache_placements"]["k"] == \
        "(Shard(dim=1), Shard(dim=3))"


def test_sequence_sharded_cache_beside_a_batch_split_on_2x2(results):
    # batch over two "data" ranks and W over two "model" ranks: each
    # decode slot is written by the two ranks whose range of W holds it
    got = case(results, "tp_stablelm_kv1_2x2")
    assert got["cache_placements"]["k"] == \
        "(Shard(dim=1), Shard(dim=2))"
    assert case(results, "tp_qwen_2x2")["cache_placements"]["k"] == \
        "(Shard(dim=1), Shard(dim=3))"


@pytest.mark.parametrize("name", ["2d_qwen", "2d_mamba2", "2d_qwen_2x2",
                                  "2d_olmoe_2x2", "2d_mamba2_2x2"])
def test_2d_train_step_equals_the_unsharded_port(results, name):
    got = case(results, name)
    assert got["sharded_moments"] > 0
    for key in ("loss", "grad_norm", "params", "moments"):
        assert got[key] <= TRAIN_TOL, (key, got)


def test_forward_on_host_mesh_with_a_vocab_sharded_embedding(results):
    got = case(results, "host_mesh")
    assert got["clamped_mesh"] == [1, 1]     # make_host_mesh on one rank
    assert got["embed_spec"] == ["model", None]
    assert got["embed_placements"] == "(Replicate(), Shard(dim=0))"
    assert got["shape"] == [2, 16, 512]
    assert got["finite"]
    assert got["logits"] <= SERVE_TOL


def test_mlas_card_route_on_sharded_heads_equals_the_unsharded_port(
        results):
    got = case(results, "tp_dsv2_mla_route")
    L, H = got["num_layers"], got["num_heads"]
    assert got["mla_launches"] == L
    # q and k (nope + rope) and v, each rank's half of the heads
    assert got["local_qkv"] == [[[2, 64, H // 2, 96], [2, 64, H // 2, 96],
                                 [2, 64, H // 2, 64]]] * L
    assert got["prefill_logits"] <= SERVE_TOL


@pytest.mark.parametrize("name", ["tp_qwen_decode_route",
                                  "tp_stablelm_kv1_decode_route",
                                  "tp_stablelm_kv1_decode_route_2x2"])
def test_decodes_card_route_on_shards_equals_the_unsharded_port(results,
                                                                name):
    got = case(results, name)
    seq = "kv1" in name
    assert got["launches"] == got["num_layers"] * got["steps"]
    # partials only where the cache is sharded along W (the stacked
    # cache's dim 2), whose ranks gather q's four heads over one
    # key/value head; else half of q's and of the cache's four heads
    assert got["partial_calls"] == (got["launches"] if seq else 0)
    assert ("Shard(dim=2)" in got["cache_placements"]) == seq
    (qb, _, qh, _), (cb, _, ck, _), partial = got["local"]
    assert (qh, ck, partial) == ((4, 1, True) if seq else (2, 2, False))
    assert qb == cb == (1 if name.endswith("2x2") else 2)
    assert got["decode_logits"] <= SERVE_TOL


@pytest.mark.parametrize("name", ["tp_mamba2_step_route",
                                  "tp_mamba2_step_route_2x2"])
def test_mamba_steps_card_route_on_shards_equals_the_unsharded_port(
        results, name):
    got = case(results, name)
    assert got["launches"] == got["num_layers"] * got["steps"]
    # the stacked (L, B, nh, hd, N) state over the rows on "data" (one
    # rank, or two at 2 x 2) and the heads on "model"; x's window alike;
    # B||C's over the rows alone
    rows = name.endswith("2x2")
    assert got["cache_placements"]["ssm"] == "(Shard(dim=1), Shard(dim=2))"
    assert got["cache_placements"]["conv_x"] == \
        "(Shard(dim=1), Shard(dim=2))"
    assert got["cache_placements"]["conv_bc"] == \
        "(Shard(dim=1), Replicate())"
    b, nh, d, bc = (1 if rows else 2), got["nh"] // 2, \
        got["d_inner"] // 2, got["d_bc"]
    hd = got["d_inner"] // got["nh"]
    assert got["local"] == [[b, nh, hd, got["local"][0][3]], [b, d, 3],
                            [b, bc, 3]]
    assert got["decode_logits"] <= SERVE_TOL
    assert max(got["caches"].values()) <= SERVE_TOL, got["caches"]
