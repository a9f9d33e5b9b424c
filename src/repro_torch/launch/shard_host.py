"""Standalone shard host: one TCP server owning a private
``SubsetEvaluationCore`` on the GPU, speaking the serving plane's op
contract.

Start H of these, then point the serving front at them:

  PYTHONPATH=src python -m repro_torch.launch.shard_host --port 9701 &
  PYTHONPATH=src python -m repro_torch.launch.shard_host --port 9702 &
  PYTHONPATH=src python -m repro_torch.launch.serve --federation --async \\
      --transport socket --hosts 127.0.0.1:9701,127.0.0.1:9702

Every host must be started with the SAME roster arguments
(``--images``/``--seed``/ensemble config) and on the same device as the
front: the client's connect-time ``hello`` handshake refuses hosts whose
trace fingerprints or configuration (device included) differ, because
such hosts would answer valid-but-different rows and silently break
cross-shard bit-parity.  ``--device`` defaults to the GPU and raises
without one; ``--device cpu`` (with a front run with ``--device cpu``)
serves the plain versions.
"""
from __future__ import annotations

import argparse
import socket


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1",
                    help="interface to bind (default 127.0.0.1)")
    ap.add_argument("--port", type=int, default=0,
                    help="TCP port (0 = ephemeral, printed on start)")
    ap.add_argument("--images", type=int, default=64,
                    help="roster size; must match the serving front")
    ap.add_argument("--seed", type=int, default=0,
                    help="trace seed; must match the serving front")
    ap.add_argument("--voting", default="affirmative")
    ap.add_argument("--ablation", default="wbf")
    ap.add_argument("--iou-thr", type=float, default=0.5)
    ap.add_argument("--use-kernel", default="auto",
                    choices=["auto", "true", "false"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions); must match the serving front")
    args = ap.parse_args(argv)

    from repro_torch.federation.providers import default_providers
    from repro_torch.federation.traces import generate_traces
    from repro_torch.serving.mp_shards import ShardOpHandler, shard_config
    from repro_torch.serving.socket_shards import serve_host

    uk = {"auto": "auto", "true": True, "false": False}[args.use_kernel]
    cfg = shard_config(voting=args.voting, ablation=args.ablation,
                       iou_thr=args.iou_thr, use_kernel=uk,
                       device=args.device)
    traces = generate_traces(default_providers(), args.images,
                             seed=args.seed)
    handler = ShardOpHandler(traces, cfg)

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((args.host, args.port))
    srv.listen(16)
    print(f"[shard_host] serving {traces.n_providers} providers / "
          f"{args.images} images on {args.host}:{srv.getsockname()[1]} "
          f"(cfg={cfg})", flush=True)
    try:
        serve_host(srv, traces, cfg, handler=handler)
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
