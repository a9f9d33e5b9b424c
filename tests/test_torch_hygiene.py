"""Hygiene of the port: it imports neither JAX nor the reference package,
and its entry points run on the GPU unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

SRC = Path(__file__).resolve().parent.parent / "src"
PORT = SRC / "repro_torch"


def port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_every_module_pulls_in_no_jax_and_no_repro():
    mods = port_modules()
    assert len(mods) > 30
    for m in ("repro_torch.models.model", "repro_torch.serving.engine",
              "repro_torch.core.td3", "repro_torch.core.blocks",
              "repro_torch.core.replay_buffer", "repro_torch.optim.adamw",
              "repro_torch.launch.train", "repro_torch.core.ppo",
              "repro_torch.core.device_replay", "repro_torch.obs",
              "repro_torch.launch.obs_report",
              "repro_torch.kernels.flash_attention.ops",
              "repro_torch.kernels.ssd_scan.ops",
              "repro_torch.configs.zamba2_2_7b"):
        assert m in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or m == 'repro' "
        "or m.startswith('repro.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout
    assert out.stdout.strip() == "[]"


def test_no_source_file_imports_jax_or_repro():
    offenders = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path.relative_to(SRC)}: {name}")
    assert not offenders, offenders


def test_entry_points_need_a_gpu_unless_cpu_is_asked_for(monkeypatch):
    """With no CUDA device the default device raises; ``device="cpu"``
    runs."""
    from repro_torch.core.device_replay import DeviceReplayBuffer
    from repro_torch.core.ppo import PPO, PPOConfig
    from repro_torch.core.sac import SAC, SACConfig
    from repro_torch.core.td3 import TD3, TD3Config
    from repro_torch.device import resolve_device
    from repro_torch.ensemble.pipeline import batch_iou_matrices
    from repro_torch.federation.env import ArmolEnv
    from repro_torch.federation.evaluation import SubsetEvaluationCore
    from repro_torch.federation.providers import default_providers
    from repro_torch.federation.traces import generate_traces
    from repro_torch.kernels.iou_matrix.ops import (batch_iou_matrices
                                                    as kernel_batch)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tr = generate_traces(default_providers(), 4, seed=0)
    boxes = [np.asarray([[0.1, 0.1, 0.5, 0.5]], np.float32)]
    for call in (lambda: resolve_device(),
                 lambda: SubsetEvaluationCore(tr),
                 lambda: ArmolEnv(tr),
                 lambda: SAC(SACConfig(state_dim=4, n_providers=3)),
                 lambda: TD3(TD3Config(state_dim=4, n_providers=3)),
                 lambda: PPO(PPOConfig(state_dim=4, n_providers=3)),
                 lambda: DeviceReplayBuffer(8, 4, 3),
                 lambda: batch_iou_matrices(boxes),
                 lambda: kernel_batch(boxes)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu").type == "cpu"
    env = ArmolEnv(tr, device="cpu")
    assert env.core.use_kernel is False
    sac = SAC(SACConfig(state_dim=env.state_dim, n_providers=3),
              device="cpu")
    assert sac.select_action(env.features[:2])[0].shape == (2, 3)
    assert kernel_batch(boxes, "cpu")[0].shape == (1, 1)
    ppo = PPO(PPOConfig(state_dim=env.state_dim, n_providers=3),
              device="cpu")
    assert ppo.select_action_batch(env.features[:2])[0].shape == (2, 3)
    buf = DeviceReplayBuffer(8, env.state_dim, 3, device="cpu",
                             feature_table=env.device_features())
    assert buf.device.type == "cpu" and buf.indexed


def test_serve_cli_raises_without_gpu_and_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--federation",
            "--images", "6", "--requests", "8", "--flush", "4"]
    gpu = subprocess.run(base, env=env, capture_output=True, text=True,
                         timeout=120)
    assert gpu.returncode != 0
    assert "no CUDA device" in gpu.stderr
    cpu = subprocess.run(base + ["--device", "cpu"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert cpu.returncode == 0, cpu.stderr
    assert "8 requests" in cpu.stdout


def test_train_cli_raises_without_gpu_and_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--federation",
            "--images", "12", "--epochs", "1", "--steps", "16", "--lanes",
            "4"]
    gpu = subprocess.run(base, env=env, capture_output=True, text=True,
                         timeout=120)
    assert gpu.returncode != 0
    assert "no CUDA device" in gpu.stderr
    for algo in ("sac", "td3", "ppo"):
        cpu = subprocess.run(base + ["--algo", algo, "--device", "cpu"],
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert cpu.returncode == 0, cpu.stderr
        assert "AP50=" in cpu.stdout and "over 16 steps" in cpu.stdout
    ppo = subprocess.run(base + ["--algo", "ppo"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert ppo.returncode != 0 and "no CUDA device" in ppo.stderr
    for extra in (["--scenario", "price_war"], ["--arch", "zamba2-2.7b"]):
        out = subprocess.run(base + extra + ["--device", "cpu"], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0 and "not ported yet" in out.stderr


def test_lm_entry_points_need_a_gpu_unless_cpu_is_asked_for(monkeypatch):
    from repro_torch.configs.base import get_arch
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Request, ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("zamba2-2.7b").reduced()
    for call in (lambda: ServeEngine(cfg), lambda: Model(cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    eng = ServeEngine(cfg, max_len=48, device="cpu")
    assert eng.model.device.type == "cpu"
    out = eng.serve([Request(np.arange(1, 33, dtype=np.int32),
                             max_new_tokens=3)])
    assert out[0].tokens.shape == (3,)


def test_lm_serve_cli_raises_without_gpu_and_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            "zamba2-2.7b", "--requests", "3", "--prompt-len", "32",
            "--new-tokens", "4", "--max-len", "64"]
    gpu = subprocess.run(base, env=env, capture_output=True, text=True,
                         timeout=120)
    assert gpu.returncode != 0
    assert "no CUDA device" in gpu.stderr
    cpu = subprocess.run(base + ["--device", "cpu"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert cpu.returncode == 0, cpu.stderr
    assert "3 requests" in cpu.stdout and "12 tokens" in cpu.stdout
    bad = subprocess.run(base[:-6] + ["--prompt-len", "40", "--device",
                                      "cpu"], env=env, capture_output=True,
                         text=True, timeout=120)
    assert bad.returncode != 0 and "multiple" in bad.stderr
