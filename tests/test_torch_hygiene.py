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
              "repro_torch.configs.zamba2_2_7b",
              "repro_torch.configs.llama_3_2_vision_11b",
              "repro_torch.configs.seamless_m4t_medium",
              "repro_torch.data.pipeline",
              "repro_torch.serving.async_service",
              "repro_torch.serving.transports",
              "repro_torch.serving.mp_shards",
              "repro_torch.serving.socket_shards",
              "repro_torch.serving.client",
              "repro_torch.serving.http_front",
              "repro_torch.launch.shard_host",
              "repro_torch.selection", "repro_torch.selection.cascade",
              "repro_torch.selection.mct", "repro_torch.selection.hybrid",
              "repro_torch.selection.frontier",
              "repro_torch.launch.mesh", "repro_torch.launch.sharding",
              "repro_torch.launch.specs", "repro_torch.launch.dryrun"):
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


def test_a_shard_worker_serving_imports_no_jax_and_no_repro():
    """What a spawned shard worker runs (``mp_shards._worker_main`` behind
    its pipe: the handshake, an eval, the install of a drifted scenario
    segment, which imports ``build_segment_traces``, an eval on it,
    introspection, stop) in a fresh interpreter that imported nothing
    else: neither JAX nor the reference is loaded."""
    code = (
        "import sys, threading\n"
        "from multiprocessing import Pipe\n"
        "from repro_torch.federation.providers import default_providers\n"
        "from repro_torch.federation.traces import generate_traces\n"
        "from repro_torch.serving.mp_shards import _worker_main, "
        "pickled_traces, shard_config\n"
        "from repro_torch.scenarios import DynamicProviderPool, "
        "build_scenario\n"
        "pv = default_providers()\n"
        "pool = DynamicProviderPool(pv, build_scenario('accuracy_drift', "
        "pv, horizon=40), n_images=6, seed=0, device='cpu')\n"
        "tr = pool.base_traces\n"
        "snap = pool.snapshot_at(20)\n"
        "cfg = shard_config(voting='affirmative', ablation='wbf', "
        "iou_thr=0.5, use_kernel='auto', device='cpu')\n"
        "parent, child = Pipe()\n"
        "t = threading.Thread(target=_worker_main, args=(child, cfg))\n"
        "t.start()\n"
        "parent.send_bytes(pickled_traces(tr))\n"
        "assert parent.recv() == (0, 'ok', 'ready')\n"
        "for rid, msg in enumerate([('eval', [0, 1, 2], [7, 1, 0], None, "
        "None), ('install', snap), ('eval', [0, 1], [7, 3], "
        "snap.dets_key, None), ('introspect', None), ('stop',)], 1):\n"
        "    parent.send((rid,) + msg)\n"
        "    r = parent.recv()\n"
        "    assert r[:2] == (rid, 'ok'), r\n"
        "t.join()\n"
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
    from repro_torch.scenarios import (DynamicProviderPool,
                                       NonStationaryArmolEnv,
                                       ScenarioSchedule)
    from repro_torch.serving.mp_shards import (
        ProcessShardedSubsetEvaluationCore, shard_config)
    from repro_torch.serving.socket_shards import \
        SocketShardedSubsetEvaluationCore
    from repro_torch.serving.transports import get_transport
    from repro_torch.configs.base import get_arch
    from repro_torch.launch import train as train_cli
    from repro_torch.training.train_step import init_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lm_cfg = get_arch("qwen1.5-0.5b").reduced()
    lm_argv = ["train", "--arch", "qwen1.5-0.5b", "--reduced", "--steps",
               "1", "--batch", "2", "--seq", "16"]
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
                 lambda: kernel_batch(boxes),
                 lambda: shard_config(voting="affirmative", ablation="wbf",
                                      iou_thr=0.5, use_kernel="auto",
                                      device=None),
                 lambda: DynamicProviderPool(
                     default_providers(), ScenarioSchedule("t", 4, []),
                     n_images=4),
                 lambda: ProcessShardedSubsetEvaluationCore(tr, n_shards=1),
                 lambda: SocketShardedSubsetEvaluationCore(tr, n_shards=1),
                 lambda: init_train_state(lm_cfg),
                 lambda: (monkeypatch.setattr("sys.argv", lm_argv),
                          train_cli.main())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu").type == "cpu"
    assert init_train_state(lm_cfg, device="cpu").model.device.type == "cpu"
    monkeypatch.setattr("sys.argv", lm_argv + ["--device", "cpu"])
    assert train_cli.main() == 0
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
    pool = DynamicProviderPool(default_providers(),
                               ScenarioSchedule("t", 4, []), n_images=4,
                               device="cpu")
    assert NonStationaryArmolEnv(pool).device.type == "cpu"
    assert pool.core_at(0).device.type == "cpu"
    # every plane's cores take the device of the env's core: the CPU only
    # because the env was asked for it
    for name in ("thread", "process", "socket"):
        tr_ = get_transport(name).build(env=env, workers=1)
        try:
            shard = tr_.core.shards[0] if tr_.inline else tr_.core
            assert str(shard.device) == "cpu"
        finally:
            tr_.close()


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


def test_async_serve_and_shard_host_clis_need_a_gpu_unless_cpu_is_asked():
    """``launch.shard_host`` and ``launch.serve --async`` raise without a
    GPU; with ``--device cpu`` two external hosts are joined by the
    serving front's socket plane (``--hosts``) and the run exits 0."""
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    host = [sys.executable, "-m", "repro_torch.launch.shard_host",
            "--images", "12", "--seed", "0"]
    serve = [sys.executable, "-m", "repro_torch.launch.serve",
             "--federation", "--async", "--images", "12", "--requests",
             "40", "--workers", "2"]
    for cmd in (host, serve):
        gpu = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=120)
        assert gpu.returncode != 0
        assert "no CUDA device" in gpu.stderr
    hosts = [subprocess.Popen(host + ["--device", "cpu"], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    try:
        addrs = []
        for h in hosts:
            line = h.stdout.readline()
            assert "[shard_host] serving" in line, h.stderr.read()
            addrs.append(line.split(" on ")[1].split()[0])
        out = subprocess.run(
            serve + ["--transport", "socket", "--hosts", ",".join(addrs),
                     "--device", "cpu"],
            env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert "async/socket" in out.stdout and "40 requests" in out.stdout
        assert "shards=2" in out.stdout
    finally:
        for h in hosts:
            h.terminate()
            h.wait(timeout=30)
            h.stdout.close()
            h.stderr.close()


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
    # LM training (--arch, no --federation): ported; the GPU unless asked
    # for the CPU, and the SSD chunk rule on --seq for the hybrid arch
    lm = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
          "zamba2-2.7b", "--reduced", "--steps", "2", "--batch", "2"]
    out = subprocess.run(lm + ["--seq", "64"], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    out = subprocess.run(lm + ["--seq", "64", "--device", "cpu"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "zamba2-2.7b (reduced)" in out.stdout and "step    1" in out.stdout
    out = subprocess.run(lm + ["--seq", "40", "--device", "cpu"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "multiple" in out.stderr
    # online scenarios are ported: they need the GPU like the rest, and
    # refuse PPO as the reference does
    scn = base + ["--scenario", "price_war", "--horizon", "64"]
    out = subprocess.run(scn, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    out = subprocess.run(scn + ["--algo", "ppo", "--device", "cpu"],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "use --algo sac or td3" in out.stderr


def test_mesh_entry_points_need_a_gpu_unless_cpu_is_asked_for(monkeypatch):
    """The meshes' device type follows ``resolve_device``; the dry-run CLI
    without ``--device cpu`` raises (``test_torch_mesh_dryrun.py`` runs
    it in a subprocess)."""
    from repro_torch.launch import dryrun, mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: mesh._mesh(None, (1, 1), ("data", "model")),
                 lambda: dryrun.main(["--arch", "qwen1.5-0.5b", "--shape",
                                      "decode_32k"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not torch.distributed.is_initialized()


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


def test_lm_serve_cli_serves_a_dense_arch_and_refuses_unported_ones():
    """``--arch qwen1.5-0.5b`` (dense, tied embeddings, no SSM: any prompt
    length) runs on the CPU when asked and raises without a GPU; no arch
    is left unported: ``seamless-m4t-medium`` (audio) and
    ``llama-3.2-vision-11b`` (vlm), with the engine's zero frames or image
    embeddings, serve their reduced configs on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            "qwen1.5-0.5b", "--requests", "3", "--prompt-len", "40",
            "--new-tokens", "4", "--max-len", "64"]
    gpu = subprocess.run(base, env=env, capture_output=True, text=True,
                         timeout=120)
    assert gpu.returncode != 0
    assert "no CUDA device" in gpu.stderr
    cpu = subprocess.run(base + ["--device", "cpu"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert cpu.returncode == 0, cpu.stderr
    assert "qwen1.5-0.5b (reduced" in cpu.stdout and "12 tokens" in cpu.stdout
    for arch in ("seamless-m4t-medium", "llama-3.2-vision-11b"):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             arch, "--device", "cpu"], env=env, capture_output=True,
            text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert f"{arch} (reduced" in out.stdout
        assert "not ported yet" not in out.stdout + out.stderr
