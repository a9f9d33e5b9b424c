"""The benchmark's cells at reduced widths, for runs on the CPU through the
port's plain paths: the cell's own files, with the port's ``reduced()``
widths in place of the configuration's, a smaller batch and shorter
lengths.  The cell's limits are kept."""
import copy
import dataclasses
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("olmoe-longprompt", "zamba2-longprompt", "olmoe-decode",
         "zamba2-decode")
PER_LAYER = ("mfu.prefill", "mbu.decode", "flash_roofline", "ssd_roofline",
             "idle.decode")


def reduced_cell(name: str, batch: int = 4):
    from repro_torch.configs.base import get_arch
    from portbench.harness import read_spec
    spec = read_spec(name)
    config = json.loads((ROOT / "portbench" / "configs" /
                         f"{spec['config']}.json").read_text())
    arch = dataclasses.replace(get_arch(config["arch"]).reduced(),
                               sliding_window=8192)
    have = dataclasses.asdict(arch)
    config["port_config"] = {k: have[k] for k in config["port_config"]}
    long = spec["prompt_len"][1] > 1024
    spec.update(batch=batch,
                prompt_len=[16, 64] if long else [8, 32],
                output_len=[4, 4] if long else [3, 9])
    spec.setdefault("limits", {"widest_gap": 1e-3})
    cell = {"name": name, "chips": 1, "spec": spec, "config": config,
            "end_to_end": [{"name": "tok_per_s", "unit": "tokens/s"},
                           {"name": "lat_p90_ms", "unit": "ms"},
                           {"name": "setup_s", "unit": "s"}],
            "per_layer": [{"name": n, "unit": "%"} for n in PER_LAYER]}
    return cell, arch


def with_spec(cell, **kw):
    cell = copy.deepcopy(cell)
    cell["spec"].update(kw)
    return cell
