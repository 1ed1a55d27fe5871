"""Launch one hierarchical silo's processes, as the reference's launcher does.

Reference: ``cross_silo/client/client_launcher.py:46`` runs the silo's
client under ``torchrun --nproc_per_node n_proc_in_silo``. Here the same
command is started ``nproc`` times, each process with the environment
``parallel/multihost.init_distributed`` reads: ``FEDML_COORDINATOR_ADDRESS``
(rank 0's rendezvous, ``127.0.0.1:<free port>``), ``FEDML_NUM_PROCESSES``
and ``FEDML_PROCESS_ID``. As under torchrun, a rank that exits with an
error ends the silo: the others are killed. Every process is waited for
under one deadline and killed when it passes::

    python -m fedml_tpu_torch.tools.launch_silo --nproc 2 --timeout 600 -- \\
        python my_silo_client.py --cf fedml_config.yaml
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

from ..core.distributed.communication.ip_config import free_port_block


class SiloProcesses:
    """The ``nproc`` processes of one silo (``procs[r]`` is rank r)."""

    def __init__(self, procs: List[subprocess.Popen], address: str):
        self.procs, self.address = procs, address

    def wait(self, timeout: float) -> List[int]:
        """Wait for every rank; returns their exit codes. A rank that exits
        non-zero kills the others; past ``timeout`` seconds every rank still
        running is killed and ``TimeoutError`` raised."""
        deadline = time.monotonic() + float(timeout)
        while any(p.poll() is None for p in self.procs):
            if any(p.poll() not in (None, 0) for p in self.procs):
                self.kill()
                break
            if time.monotonic() > deadline:
                self.kill()
                raise TimeoutError(f"silo ranks still running after {timeout}s: "
                                   f"{[r for r, p in enumerate(self.procs) if p.returncode is None]}")
            time.sleep(0.05)
        return [p.wait() for p in self.procs]

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()


def launch(cmd: Sequence[str], nproc: int, *, env: Optional[Dict[str, str]] = None,
           cwd: Optional[str] = None, log_dir: Optional[str] = None,
           port: Optional[int] = None) -> SiloProcesses:
    """Start ``cmd`` as ranks 0..nproc-1 of one silo; with ``log_dir``, rank
    r's output goes to ``rank{r}.out`` and ``rank{r}.err`` there."""
    address = f"127.0.0.1:{port or free_port_block(1)}"
    procs = []
    for rank in range(int(nproc)):
        rank_env = dict(os.environ if env is None else env)
        rank_env.update(FEDML_COORDINATOR_ADDRESS=address, FEDML_NUM_PROCESSES=str(nproc),
                        FEDML_PROCESS_ID=str(rank))
        out = err = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            out = open(os.path.join(log_dir, f"rank{rank}.out"), "w")
            err = open(os.path.join(log_dir, f"rank{rank}.err"), "w")
        try:
            procs.append(subprocess.Popen(list(cmd), env=rank_env, cwd=cwd, stdout=out,
                                          stderr=err))
        finally:
            for f in (out, err):
                if f is not None:
                    f.close()
    return SiloProcesses(procs, address)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, required=True, help="processes in the silo")
    ap.add_argument("--timeout", type=float, default=24 * 3600.0,
                    help="seconds before every rank still running is killed")
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("cmd", nargs=argparse.REMAINDER, help="-- the command of every rank")
    a = ap.parse_args(argv)
    cmd = a.cmd[1:] if a.cmd[:1] == ["--"] else a.cmd
    if not cmd:
        ap.error("no command after --")
    rcs = launch(cmd, a.nproc, log_dir=a.log_dir).wait(a.timeout)
    print(f"silo ranks exited {rcs}")
    return next((rc for rc in rcs if rc != 0), 0)


if __name__ == "__main__":
    sys.exit(main())
