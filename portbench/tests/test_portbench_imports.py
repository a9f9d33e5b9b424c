"""What a run may import, and when it must give no result."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

RUN_REDUCED = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}, {tests!r}]
import torch
from portbench import harness
from portbench_reduced import reduced_cell
cell, arch = reduced_cell({name!r})
r = harness.run(cell, 7, 0.2, {traced}, time.perf_counter(), device="cpu",
                arch=arch)
print(json.dumps({{"correct": r["correct"],
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


@pytest.mark.parametrize("name,traced", [("zamba2-decode", False),
                                         ("olmoe-longprompt", True)])
def test_a_run_imports_no_jax_and_not_the_jax_package(name, traced):
    code = RUN_REDUCED.format(root=str(ROOT), src=str(ROOT / "src"),
                              tests=str(Path(__file__).parent), name=name,
                              traced=traced)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    assert "repro_torch" in got["top"]
    assert not FORBIDDEN & set(got["top"])


READER_LOADS = """
import contextlib, io, json, sys, time
sys.path[:0] = [{stand_in!r}, {root!r}, {src!r}, {tests!r}]
sys.modules.pop("jax", None)
import importlib.util
from portbench import harness
from portbench_reduced import reduced_cell

def stand_in_reader(name):
    spec = importlib.util.spec_from_file_location("reader", {reader!r})
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

harness.metric_reader = stand_in_reader
cell, arch = reduced_cell("zamba2-decode")
r = harness.run(cell, 11, 0.1, True, time.perf_counter(), device="cpu",
                arch=arch)
err = io.StringIO()
with contextlib.redirect_stderr(err):
    rc = harness.report(r)
print(json.dumps({{"rc": rc, "err": err.getvalue()}}), file=sys.stderr)
"""


@pytest.mark.parametrize("loads", [True, False], ids=["jax", "nothing"])
def test_a_reader_that_loads_jax_leaves_the_run_without_a_result(tmp_path,
                                                                 loads):
    """The look at ``sys.modules`` comes after the last code that can
    import anything: a per-layer reader that brings in a module by the name
    ``jax`` (a stand-in) leaves the run with no result."""
    stand_in = tmp_path / "stand_in"
    stand_in.mkdir()
    (stand_in / "jax.py").write_text('"""A stand-in named jax."""\n')
    reader = tmp_path / "reader.py"
    reader.write_text(("import jax\n" if loads else "") +
                      "\n\ndef read(ctx):\n    return 1.0\n")
    code = READER_LOADS.format(stand_in=str(stand_in), root=str(ROOT),
                               src=str(ROOT / "src"), reader=str(reader),
                               tests=str(Path(__file__).parent))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stderr.strip().splitlines()[-1])
    if loads:
        assert got["rc"] != 0
        assert out.stdout.strip() == ""
        assert "forbidden modules: ['jax']" in got["err"]
    else:
        assert got["rc"] == 0
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] is True
        assert line["metrics"]["mfu.prefill"]["value"] == 1.0


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_references_import_nothing_of_the_program():
    files = sorted((PB / "reference").glob("*.py")) + [PB / "weights.py"]
    for f in files:
        names = set(_imports(f))
        assert not names & (FORBIDDEN | {"repro_torch"}), (f, names)
    # the harness reaches the program only through its checkout's src
    for f in PB.rglob("*.py"):
        if "tests" not in f.parts:
            assert not set(_imports(f)) & FORBIDDEN, f


def _run_cli(cwd: Path, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "olmoe-longprompt", "--seed", "3", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=str(cwd),
        env=env)


def test_without_a_card_the_cli_exits_nonzero_with_no_result(monkeypatch):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run_cli(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


@pytest.mark.cuda
def test_without_the_program_the_cli_exits_nonzero_with_no_result(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a card: without one every run stops earlier")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run_cli(tmp_path, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
