"""The client-facing serving surface: one facade, two wire forms.

:class:`FederationClient` is the documented way to talk to a federation
service — in-process callers wrap the service object, HTTP callers sit
behind the same five calls via ``repro_torch.serving.http_front`` (the routes
are a thin adapter over this facade, so both paths stay in lockstep):

    ``submit(img)``            -> Future[FederationResult]
    ``handle(img)``            -> FederationResult (blocking)
    ``handle_many(imgs)``      -> List[FederationResult]
    ``invalidate_images(imgs)``-> int entries dropped
    ``stats``                  -> dict (flush counters / request totals)

The facade accepts either service flavor: the micro-batching
``AsyncFederationService`` (requests coalesce into flushes) or the
synchronous ``FederationService`` (each ``submit`` is served inline and
returned as an already-resolved future — same types, degenerate
batching), so callers and tests can swap services without touching call
sites.

:func:`result_to_dict` / :func:`result_from_dict` define the JSON body
of a served result — the HTTP door's response schema.
"""
from __future__ import annotations

from concurrent.futures import Future
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.ensemble.boxes import Detections
from repro_torch.serving.federation_service import (FederationResult,
                                                    FederationService)


def result_to_dict(res: FederationResult) -> Dict[str, object]:
    """JSON-safe view of one ``FederationResult`` (the HTTP response
    body).  Arrays become nested lists; the detections keep their
    box/score/label/provider columns."""
    det = res.detections
    return {"action": [int(a) for a in np.asarray(res.action).ravel()],
            "cost_milli_usd": float(res.cost_milli_usd),
            "latency_ms": float(res.latency_ms),
            "detections": {
                "boxes": np.asarray(det.boxes, np.float64).tolist(),
                "scores": np.asarray(det.scores, np.float64).tolist(),
                "labels": np.asarray(det.labels, np.int64).tolist(),
                "providers": np.asarray(det.providers,
                                        np.int64).tolist()}}


def result_from_dict(d: Dict[str, object]) -> FederationResult:
    """Rebuild a ``FederationResult`` from :func:`result_to_dict` output
    (the HTTP client's side of the contract)."""
    det = d["detections"]
    boxes = np.asarray(det["boxes"], np.float64).reshape(-1, 4)
    return FederationResult(
        detections=Detections.fast(
            boxes, np.asarray(det["scores"], np.float64),
            np.asarray(det["labels"], np.int64),
            np.asarray(det["providers"], np.int64)),
        action=np.asarray(d["action"], np.float32),
        cost_milli_usd=float(d["cost_milli_usd"]),
        latency_ms=float(d["latency_ms"]))


class FederationClient:
    """Uniform client handle over a federation service.

    Parameters
    ----------
    service: an ``AsyncFederationService`` (futures resolve when the
        request's flush assembles) or a ``FederationService`` (each
        submit is served inline; the returned future is already done).

    The facade never owns the service's lifecycle unless asked:
    ``close()`` closes the underlying service only when constructed with
    ``own_service=True`` (the HTTP door uses this to tie service
    shutdown to server shutdown).
    """

    def __init__(self, service, *, own_service: bool = False):
        self._svc = service
        self._own = bool(own_service)
        self._async = hasattr(service, "submit")

    @property
    def service(self):
        return self._svc

    # -- the five-call surface -------------------------------------------
    def submit(self, img_idx: int) -> "Future[FederationResult]":
        """Enqueue one request; returns a future of its result.  On the
        sync service the work happens here and the future arrives
        resolved (or failed) — same observable types either way."""
        if self._async:
            return self._svc.submit(int(img_idx))
        fut: Future = Future()
        try:
            fut.set_result(self._svc.handle(int(img_idx)))
        except BaseException as e:
            fut.set_exception(e)
        return fut

    def handle(self, img_idx: int) -> FederationResult:
        return self.submit(img_idx).result()

    def handle_many(self, img_indices: Sequence[int]
                    ) -> List[FederationResult]:
        futs = [self.submit(i) for i in img_indices]
        return [f.result() for f in futs]

    def invalidate_images(self, img_indices: Sequence[int]) -> int:
        return int(self._svc.invalidate_images(
            [int(i) for i in img_indices]))

    @property
    def stats(self) -> Dict[str, int]:
        svc = self._svc
        if isinstance(svc, FederationService):
            # the sync service keeps no flush counters; present the
            # same keys with the degenerate truth (1 request = 1 flush)
            return {}
        return dict(svc.stats)

    # -- passthroughs the HTTP door needs ---------------------------------
    def metrics_snapshot(self) -> dict:
        fn = getattr(self._svc, "metrics_snapshot", None)
        return {} if fn is None else fn()

    def condemned(self) -> List[int]:
        tr = getattr(self._svc, "transport", None)
        return [] if tr is None else list(tr.condemned)

    def close(self) -> None:
        if self._own:
            close = getattr(self._svc, "close", None)
            if close is not None:
                close()
