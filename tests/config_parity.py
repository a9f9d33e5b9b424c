"""The port's config dataclasses against the reference's: the port adds
fields the reference lacks (an expert share, group-limited routing, YaRN;
``repro_torch.configs.base``), each with a default that keeps the
reference's behaviour.  ``as_reference`` keeps every field the
reference's dataclasses have, so an equality with its ``asdict`` compares
all of those; ``assert_port_fields_default`` checks that the fields the
port adds stand at their defaults (the reference's archs set none).
Imported by the config tests; not collected itself."""
import dataclasses


def as_reference(port_cfg, ref_cfg) -> dict:
    """``asdict(port_cfg)`` cut to the keys of ``asdict(ref_cfg)``, nested
    groups key by key (a group the port lacks stays missing)."""
    def cut(have, want):
        if isinstance(have, dict) and isinstance(want, dict):
            return {k: cut(have.get(k, "<missing>"), v)
                    for k, v in want.items()}
        return have
    return cut(dataclasses.asdict(port_cfg), dataclasses.asdict(ref_cfg))


def assert_port_fields_default(port_cfg, ref_cfg) -> None:
    """Every field of ``port_cfg`` (nested dataclasses too) that
    ``ref_cfg``'s class lacks holds its declared default."""
    theirs = {f.name for f in dataclasses.fields(ref_cfg)}
    for f in dataclasses.fields(port_cfg):
        mine = getattr(port_cfg, f.name)
        if f.name not in theirs:
            assert mine == f.default, (type(port_cfg).__name__, f.name, mine)
        elif dataclasses.is_dataclass(mine):
            assert_port_fields_default(mine, getattr(ref_cfg, f.name))


def assert_same_config(ref_cfg, port_cfg) -> None:
    """The port's config equals the reference's in every field the
    reference has, and adds only defaults."""
    assert as_reference(port_cfg, ref_cfg) == dataclasses.asdict(ref_cfg)
    assert_port_fields_default(port_cfg, ref_cfg)
