"""Public serving API of the port.

The serving plane in one import: the LM engine, the sync + async
federation services, the transport seam (``ShardTransport`` registry:
thread / process / socket planes), the client facade shared by
in-process and HTTP callers, and the HTTP front door.

The names load on first access, so that importing one submodule (a
spawned shard worker imports ``mp_shards``) does not import the rest.
"""
import importlib

_EXPORTS = {
    "async_service": ("AsyncFederationService",),
    "client": ("FederationClient", "result_to_dict", "result_from_dict"),
    "engine": ("ServeEngine", "Request"),
    "federation_service": ("FederationService", "FederationResult"),
    "http_front": ("HttpFrontDoor", "HttpServingClient", "create_app"),
    "mp_shards": ("ProcessShardedSubsetEvaluationCore", "ShardWorkerError"),
    "socket_shards": ("SocketShardedSubsetEvaluationCore",),
    "transports": ("ShardTransport", "ThreadTransport", "ProcessTransport",
                   "SocketTransport", "register_transport", "get_transport",
                   "available_transports"),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = list(_MODULE_OF)


def __getattr__(name: str):
    mod = _MODULE_OF.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
