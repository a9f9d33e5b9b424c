"""``repro_torch.launch.dryrun`` and ``launch.specs`` (counterparts of the
reference's ``launch/dryrun.py`` and ``specs.py``) on the CPU.

The CLI in a subprocess, as ``test_perf_variants.py::
test_dryrun_subprocess_smoke`` runs the reference's: qwen1.5-0.5b x
decode_32k on the fake 16x16 group prints ``1/1 combos OK`` and writes a
record with the reference's keys (``trace_s`` for ``lower_compile_s``,
no ``generated_code_size_in_bytes``) whose ``model_flops_total`` equals
the reference's ``model_flops`` for that combination.  ``serve_param_mode``
and ``batch_struct`` equal the reference's for every arch.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.dryrun import local_bytes  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
KEYS = {"arch", "shape", "mesh", "kind", "tag", "trace_s", "flops_per_dev",
        "bytes_per_dev", "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "collective_bytes_per_dev",
        "model_flops_total", "chips", "model_flops_per_dev",
        "useful_flops_ratio", "compute_s", "memory_s", "collective_s",
        "dominant", "status"}


def test_dryrun_cli_subprocess_smoke(tmp_path):
    pytest.importorskip("jax")
    from repro.configs.base import get_arch as jget_arch
    from repro.roofline.analysis import model_flops as jmodel_flops
    out = tmp_path / "records.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
         "cpu", "--arch", "qwen1.5-0.5b", "--shape", "decode_32k", "--out",
         str(out)], capture_output=True, text=True, env=env, timeout=300,
        cwd=ROOT)
    assert "1/1 combos OK" in run.stdout, run.stdout + run.stderr
    assert run.returncode == 0
    rec = json.loads(out.read_text().splitlines()[-1])
    assert set(rec) == KEYS
    assert (rec["status"], rec["mesh"], rec["chips"]) == ("ok", "16x16", 256)
    assert rec["model_flops_total"] == jmodel_flops(
        jget_arch("qwen1.5-0.5b"), 128, train=False)
    assert rec["flops_per_dev"] > 0 and rec["bytes_per_dev"] > 0
    # per device: the rank's shards of the weights and the 32k cache
    assert 0 < rec["argument_size_in_bytes"] < 4 * get_arch(
        "qwen1.5-0.5b").param_count() + 4 * 2 * 24 * 128 * 32768 * 1024
    assert rec["collective_bytes_per_dev"]["total"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")


def test_dryrun_cli_needs_a_gpu_unless_cpu_is_asked_for():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen1.5-0.5b", "--shape", "decode_32k"], capture_output=True,
        text=True, env=env, timeout=120, cwd=ROOT)
    assert run.returncode != 0
    assert "no CUDA device" in run.stderr
    assert "combos OK" not in run.stdout


def test_production_mesh_needs_the_fake_group_first():
    from repro_torch.launch.mesh import make_production_mesh
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="fake process group"):
        make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="512 ranks"):
        make_production_mesh(multi_pod=True, device_type="cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_param_mode_and_batch_struct_equal_the_reference(arch):
    pytest.importorskip("jax")
    from repro.configs.base import get_arch as jget_arch
    from repro.launch import specs as jspecs
    for msz in (1, 16):
        assert specs.serve_param_mode(get_arch(arch), msz) == \
            jspecs.serve_param_mode(jget_arch(arch), msz)
    want = jspecs.batch_struct(jget_arch(arch), 8, 64)
    got = specs.batch_struct(get_arch(arch), 8, 64, device="meta")
    assert set(got) == set(want)
    for key, t in got.items():
        assert tuple(t.shape) == tuple(want[key].shape), key
        assert str(t.dtype).split(".")[-1] == str(want[key].dtype), key


def test_local_bytes_walks_states_and_caches():
    from repro_torch.models.model import Model
    model = Model(get_arch("qwen1.5-0.5b").reduced(), device="cpu")
    n = sum(p.numel() for p in model.parameters())
    assert local_bytes(model) == 4 * n
    assert local_bytes({"a": torch.zeros(3), "pos": 7,
                        "b": [torch.zeros(2, dtype=torch.int64)]}) == 28
