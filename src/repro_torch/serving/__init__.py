"""Serving API of the port: the synchronous federation service."""
from repro_torch.serving.federation_service import (  # noqa: F401
    FederationResult, FederationService)
