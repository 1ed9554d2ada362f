"""``runctl serve-worker`` — run one socket-transport worker host.

The remote half of the runtime's ``socket`` backend
(:mod:`repro_torch.runtime.transport.socket_host`): a standalone process that
listens on a TCP port, accepts a master session, and executes the coded
tasks the master dispatches — rounds in, results out, over the
length-prefixed frame protocol.  One host per worker slot: a 5-worker
``RuntimeConfig`` needs 5 of these (possibly on 5 machines), named in
``cfg.hosts`` / ``runctl --hosts``.

Start one per machine::

    PYTHONPATH=src python -m repro_torch.launch.runctl serve-worker --port 7001
    # or equivalently
    PYTHONPATH=src python -m repro_torch.launch.worker_host --port 7001

then point the master at them::

    PYTHONPATH=src python -m repro_torch.launch.runctl --jobs 100 \
        --backend socket --hosts hostA:7001,hostB:7001,hostC:7001 \
        --mu 400,650,380

The host computes its coded tasks on host BLAS (it never touches CUDA),
whatever backend the master's other workers use.

``--port 0`` binds an ephemeral port and announces it on stdout as
``LISTENING <host> <port>`` — how the test harness
(:class:`repro_torch.runtime.transport.socket_host.LocalCluster`) discovers its
workers.  The host serves sessions in a loop (a new master can connect
after the previous one stopped); ``--once`` exits after the first orderly
session.

The wire protocol carries pickles and authenticates nothing: bind to a
trusted interface (the default is loopback; use ``--host 0.0.0.0`` only
on a private cluster network).
"""

from __future__ import annotations

import argparse

from repro_torch.runtime.transport.socket_host import serve_worker_host

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="runctl serve-worker", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--host", default="127.0.0.1",
                    help="interface to bind (default loopback; use a "
                         "private-network address for real multi-host runs)")
    ap.add_argument("--port", type=int, default=0,
                    help="TCP port to listen on (0 = ephemeral, announced "
                         "as 'LISTENING <host> <port>' on stdout)")
    ap.add_argument("--once", action="store_true",
                    help="exit after the first orderly master session")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="also serve live Prometheus worker metrics on this "
                         "TCP port at /metrics (0 = ephemeral, announced as "
                         "'METRICS <host> <port>' on stdout)")
    args = ap.parse_args(argv)
    serve_worker_host(args.port, args.host, once=args.once,
                      announce=lambda line: print(line, flush=True),
                      metrics_port=args.metrics_port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
