"""Convert the reference package's parameters (as numpy arrays) into the
port's modules, so both packages can be run on the same weights.

The reference keeps a linear layer as ``{"w": (fan_in, fan_out), "b":
(fan_out,)}`` and convolution kernels as HWIO; ``nn.Linear`` stores
``(out, in)`` and ``F.conv2d`` takes OIHW.  An agent's AdamW moments are
shaped like its weights and are transposed with them.  The LM keeps the
reference's ``(fan_in, fan_out)`` layout, but one module per block where
the reference stacks the layers along leading axes.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.networks import MLP, FeatureExtractor
from repro_torch.models.layers import ParamTree
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWState
from repro_torch.training.train_step import TrainState


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _load_linear(lin: torch.nn.Linear, layer: Mapping) -> None:
    w = np.asarray(layer["w"], np.float32)
    if w.shape != (lin.in_features, lin.out_features):
        raise ValueError(f"linear weight {w.shape} does not fit "
                         f"({lin.in_features}, {lin.out_features})")
    with torch.no_grad():
        lin.weight.copy_(_t(w.T))
        lin.bias.copy_(_t(layer["b"]))


def actor_from_jax(params: Sequence[Mapping], actor: Optional[MLP] = None
                   ) -> MLP:
    """Reference MLP pytree (a list of ``{"w", "b"}``) -> ``MLP``.  Loads
    into ``actor`` in place when given (its device is kept), else builds
    a CPU module of the matching sizes."""
    if actor is None:
        sizes = [np.shape(params[0]["w"])[0]] + \
            [np.shape(p["w"])[1] for p in params]
        actor = MLP(sizes)
    if len(actor.layers) != len(params):
        raise ValueError(f"{len(params)} layers for an MLP of "
                         f"{len(actor.layers)}")
    for lin, layer in zip(actor.layers, params):
        _load_linear(lin, layer)
    return actor


def _field(tree: Any, name: str) -> Any:
    """A field of a reference state: a NamedTuple's attribute or a
    mapping's key."""
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def _load_adamw(opt: AdamWState, jopt: Any, mlp: MLP) -> None:
    """Reference ``AdamWState(step, mu, nu)`` (moments shaped like the MLP
    pytree) into ``opt``: each weight's moments transposed like the weight."""
    with torch.no_grad():
        for name, dst in (("mu", opt.mu), ("nu", opt.nu)):
            tree = _field(jopt, name)
            if len(tree) != len(mlp.layers):
                raise ValueError(f"{name}: {len(tree)} layers for an MLP of "
                                 f"{len(mlp.layers)}")
            src = []
            for layer in tree:
                src += [np.asarray(layer["w"], np.float32).T, layer["b"]]
            for d, x in zip(dst, src):
                x = _t(x)
                if tuple(x.shape) != tuple(d.shape):
                    raise ValueError(f"{name}: shape {tuple(x.shape)} does "
                                     f"not fit {tuple(d.shape)}")
                d.copy_(x)
        opt.step.fill_(int(np.asarray(_field(jopt, "step"))))


def _agent_from_jax(state: Any, agent: Any, nets: Sequence[str],
                    opts: Sequence[str] = ("actor", "q1", "q2")) -> Any:
    """Load the networks ``nets`` and the AdamW states ``opt_<name>`` of
    the networks ``opts`` from a reference state into ``agent``."""
    for name in nets:
        actor_from_jax(_field(state, name), getattr(agent, name))
    for name in opts:
        _load_adamw(getattr(agent, f"opt_{name}"),
                    _field(state, f"opt_{name}"), getattr(agent, name))
    return agent


def sac_state_from_jax(state: Any, agent: Any) -> Any:
    """The reference's ``SACState`` (numpy leaves, e.g. ``jax.tree.map(
    np.asarray, sac.state)``) into a port ``SAC`` in place: the actor, both
    critics and their targets, the three AdamW states (moments transposed
    like the weights) and their steps.  The PRNG key is not carried over:
    the port draws its noise from its own generator."""
    return _agent_from_jax(state, agent, ("actor", "q1", "q2", "q1_targ",
                                          "q2_targ"))


def td3_state_from_jax(state: Any, agent: Any) -> Any:
    """The reference's ``TD3State`` (numpy leaves) into a port ``TD3`` in
    place: as ``sac_state_from_jax``, plus the actor's target and the
    delay counter ``step``."""
    _agent_from_jax(state, agent, ("actor", "actor_targ", "q1", "q2",
                                   "q1_targ", "q2_targ"))
    agent.step.fill_(int(np.asarray(_field(state, "step"))))
    return agent


def ppo_state_from_jax(state: Any, agent: Any) -> Any:
    """The reference's ``PPOState`` (numpy leaves) into a port ``PPO`` in
    place: the actor, the V critic, ``opt_actor`` and ``opt_critic``
    (moments transposed like the weights) and their steps.  The PRNG key
    is not carried over: the port acts from its own generator."""
    return _agent_from_jax(state, agent, ("actor", "critic"),
                           ("actor", "critic"))


def feature_extractor_from_jax(params: Mapping) -> FeatureExtractor:
    """Reference ``{"convs": [{"dw": (3,3,1,c_in), "pw": (1,1,c_in,c_out)}],
    "head": {"w", "b"}}`` -> ``FeatureExtractor`` (on the CPU)."""
    convs = params["convs"]
    channels = tuple(int(np.shape(c["pw"])[3]) for c in convs)
    feat_dim = int(np.shape(params["head"]["w"])[1])
    fx = FeatureExtractor(channels, feat_dim)
    with torch.no_grad():
        for dw, pw, layer in zip(fx.dw, fx.pw, convs):
            dw.copy_(_t(np.transpose(layer["dw"], (3, 2, 0, 1))))  # HWIO
            pw.copy_(_t(np.transpose(layer["pw"], (3, 2, 0, 1))))  # -> OIHW
    _load_linear(fx.head, params["head"])
    return fx


def unflatten_feature_params(flat: Mapping[str, np.ndarray]) -> dict:
    """``{"convs.0.dw": ..., "head.w": ...}`` (the committed ``.npz``
    layout) -> the reference's nested parameter dict."""
    n = 1 + max(int(k.split(".")[1]) for k in flat if k.startswith("convs."))
    return {"convs": [{k: flat[f"convs.{i}.{k}"] for k in ("dw", "pw")}
                      for i in range(n)],
            "head": {"w": flat["head.w"], "b": flat["head.b"]}}


def _load_tree(tree: ParamTree, params: Mapping, index: tuple, path: str
               ) -> None:
    """Copy ``params`` (nested numpy, each leaf with the leading stack axes
    ``index`` selects) into the parameters of ``tree``; raise on a missing
    or extra key or a shape that does not fit."""
    if sorted(tree.keys()) != sorted(params.keys()):
        raise ValueError(f"{path or 'params'}: keys {sorted(params.keys())} "
                         f"do not fit {sorted(tree.keys())}")
    for key in tree.keys():
        sub, src = tree[key], params[key]
        if isinstance(sub, ParamTree):
            _load_tree(sub, src, index, f"{path}.{key}")
            continue
        arr = np.asarray(src)
        lead = arr.shape[:len(index)]
        if any(i >= n for i, n in zip(index, lead)) or \
                arr.shape[len(index):] != tuple(sub.shape):
            raise ValueError(f"{path}.{key}: shape {arr.shape} does not fit "
                             f"{tuple(sub.shape)} at stack index {index}")
        with torch.no_grad():
            sub.copy_(torch.from_numpy(np.array(arr[index])))


def _lead(tree: Mapping, n: int) -> tuple:
    """The first ``n`` (stack) axes of a stacked pytree's first leaf."""
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return tuple(np.shape(tree)[:n])


def lm_params_from_jax(params: Mapping, cfg: ArchConfig,
                       model: Optional[Model] = None) -> Model:
    """Reference LM pytree (numpy leaves) -> the port's ``Model``.

    Dense/moe: ``dense_blocks`` and ``blocks`` leaves carry a leading
    layer axis and become ``model.dense_blocks[i]`` / ``model.blocks[i]``
    (MoE weights keep their ``(E, fan_in, fan_out)`` layout); ssm:
    ``blocks`` likewise.  Hybrid: ``blocks`` leaves carry leading axes
    ``(n_super, per)`` and become ``model.blocks[s * per + i]``;
    ``shared_attn`` is one block.  Vlm: ``blocks.selfs`` leaves carry
    ``(n_super, per - 1)`` and become ``model.blocks[s * (per - 1) + i]``,
    ``blocks.cross`` leaves ``(n_super,)`` and become
    ``model.cross_blocks[s]``.  Audio: ``enc_blocks`` (``(E,)``) and
    ``blocks`` (``(L,)``, with ``norm_x`` and ``cross``) like dense
    blocks, ``enc_norm`` one tree.  ``unembed`` (absent with tied
    embeddings) becomes ``model.unembed_weight``.  Loads into ``model`` in place when given (its device is
    kept), else builds a CPU model.  Raises on any key or shape that does
    not fit.
    """
    if model is None:
        model = Model(cfg, device="cpu", init=False)
    if model.cfg != cfg:
        raise ValueError(f"model was built for {model.cfg.name}, not "
                         f"{cfg.name}")
    want = {"embed", "final_norm", "blocks"}
    if not cfg.tie_embeddings:
        want.add("unembed")
    if cfg.family == "hybrid":
        want.add("shared_attn")
    elif cfg.family == "audio":
        want |= {"enc_blocks", "enc_norm"}
    elif getattr(model, "dense_blocks", None):
        want.add("dense_blocks")
    if set(params.keys()) != want:
        raise ValueError(f"params keys {sorted(params.keys())} do not fit "
                         f"the {cfg.family} family's {sorted(want)}")
    for name in sorted({"embed", "unembed"} & want):
        arr = np.asarray(params[name])
        dst = model.embed if name == "embed" else model.unembed_weight
        if arr.shape != tuple(dst.shape):
            raise ValueError(f"{name}: shape {arr.shape} does not fit "
                             f"{tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(torch.from_numpy(np.array(arr)))
    _load_tree(model.final_norm, params["final_norm"], (), "final_norm")
    if cfg.family == "hybrid":
        _load_tree(model.shared_attn, params["shared_attn"], (),
                   "shared_attn")
        lead = _lead(params["blocks"], 2)
        if lead != (model.n_super, model.per):
            raise ValueError(f"blocks are stacked {lead}, the model has "
                             f"({model.n_super}, {model.per})")
        for s in range(model.n_super):
            for i in range(model.per):
                _load_tree(model.blocks[s * model.per + i], params["blocks"],
                           (s, i), f"blocks[{s},{i}]")
        return model
    if cfg.family == "vlm":
        blocks = params["blocks"]
        if sorted(blocks.keys()) != ["cross", "selfs"]:
            raise ValueError(f"blocks keys {sorted(blocks.keys())} do not "
                             f"fit the vlm's ['cross', 'selfs']")
        n = model.per - 1
        for key, lead in (("selfs", (model.n_super, n)),
                          ("cross", (model.n_super,))):
            got = _lead(blocks[key], len(lead))
            if got != lead:
                raise ValueError(f"blocks.{key} are stacked {got}, the "
                                 f"model has {lead}")
        for s in range(model.n_super):
            for i in range(n):
                _load_tree(model.blocks[s * n + i], blocks["selfs"], (s, i),
                           f"blocks.selfs[{s},{i}]")
            _load_tree(model.cross_blocks[s], blocks["cross"], (s,),
                       f"blocks.cross[{s}]")
        return model
    if cfg.family == "audio":
        _load_tree(model.enc_norm, params["enc_norm"], (), "enc_norm")
    for key in sorted(want & {"blocks", "dense_blocks", "enc_blocks"}):
        stack = getattr(model, key)
        lead = _lead(params[key], 1)
        if lead != (len(stack),):
            raise ValueError(f"{key} are stacked {lead}, the model has "
                             f"({len(stack)},)")
        for i, block in enumerate(stack):
            _load_tree(block, params[key], (i,), f"{key}[{i}]")
    return model


def train_state_from_jax(state: Any, cfg: ArchConfig,
                         model: Optional[Model] = None) -> TrainState:
    """The reference's LM ``TrainState(params, AdamWState(step, mu, nu))``
    (numpy leaves, e.g. ``jax.tree.map(np.asarray, state)``) -> the port's
    ``TrainState``: the params loaded into ``model`` (in place when given,
    else a CPU model) by ``lm_params_from_jax``, and each moment pytree,
    shaped like the params, laid out the same way in the order of
    ``model.parameters()``; the step both as the device counter and as
    its host mirror."""
    model = lm_params_from_jax(_field(state, "params"), cfg, model)
    jopt = _field(state, "opt")
    moments = []
    for name in ("mu", "nu"):
        like = Model(cfg, device=model.device, init=False)
        lm_params_from_jax(_field(jopt, name), cfg, like)
        moments.append([p.detach() for p in like.parameters()])
    step = int(np.asarray(_field(jopt, "step")))
    opt = AdamWState(step=torch.tensor(step, dtype=torch.int32,
                                       device=model.device),
                     mu=moments[0], nu=moments[1])
    return TrainState(model=model, opt=opt, step=step)
