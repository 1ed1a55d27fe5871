"""Peer address table of the point-to-point backends (TRPC, GRPC): the
port's home of ``read_ip_config`` from
``fedml_tpu/core/distributed/communication/grpc/grpc_comm_manager.py:41-51``.

It lives apart from the gRPC module so that TRPC, which reads the same
table, imports no ``grpc`` (the JAX package's TRPC imports it from the gRPC
module and so cannot load without ``grpc``). ``free_port_block`` finds
ports for a federation or a benchmark that must not bind fixed ones.
"""

from __future__ import annotations

import csv
import errno
import random
import socket
from typing import Dict, Optional


def read_ip_config(path: Optional[str], size: int) -> Dict[int, str]:
    """CSV ``receiver_id,ip`` (reference: grpc_ipconfig.csv); default all
    localhost."""
    table = {i: "127.0.0.1" for i in range(size)}
    if path:
        with open(path) as f:
            for row in csv.reader(f):
                if len(row) >= 2 and row[0].strip().isdigit():
                    table[int(row[0])] = row[1].strip()
    return table


# where free_port_block draws: below Linux's ephemeral range (32768-60999),
# so outgoing connections do not take the ports, and above the backends'
# default bases (GRPC 8890, TRPC 9890, each plus a run-id offset below 1000)
_PORT_RANGE = (13000, 19000)


def free_port_block(n: int) -> int:
    """A base port whose ``n`` consecutive ports were all free to bind just
    now, drawn at random from ``_PORT_RANGE``. Free now is not free later: a
    caller that binds later retries on ``EADDRINUSE``."""
    lo, hi = _PORT_RANGE
    for _ in range(200):
        base = random.randrange(lo, hi - n)
        held = []
        try:
            for p in range(base, base + n):
                s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                held.append(s)
                s.bind(("0.0.0.0", p))
            return base
        except OSError:
            continue
        finally:
            for s in held:
                s.close()
    raise OSError(errno.EADDRINUSE, f"no block of {n} free ports in [{lo}, {hi})")
