"""Replica child process entrypoint.

Counterpart of ``fedml_tpu/serving/replica_main.py``. Reference:
``model_scheduler/device_model_deployment.py:68`` starts each replica as a
docker container running the inference image; here the isolation unit is
an OS process: ``python -m fedml_tpu_torch.serving.replica_main --predictor
pkg.mod:factory``. The child installs the flight recorder, builds the
predictor, serves /predict, /ready, /metrics and /statusz on a free port,
and writes the bound port to --port-file so the controller can probe it. A
predictor that fails to build (a replica asked for the card where there is
none) ends the child before the port file exists, so it never reports
ready.

``FEDML_REPLICA_MEM_FRACTION`` caps this process's share of the card
(``torch.cuda.set_per_process_memory_fraction``), so replicas sharing one
card coexist deterministically. The JAX child's ``FEDML_COMPILE_CACHE_DIR``
(JAX's persistent compile cache) has no counterpart: the port compiles no
programs, and its CUDA kernels are built once into the package
(ops/_build.py), where every replica finds them.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys


def resolve_factory(spec: str):
    """'package.module:attr' -> callable returning a FedMLPredictor."""
    mod_name, _, attr = spec.partition(":")
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, attr or "create_predictor")
    return fn


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--predictor", required=True, help="module:factory spec")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--port-file", default=None)
    p.add_argument("--model-path", default=None)
    args = p.parse_args(argv)

    # install BEFORE the predictor build: model-load crashes are exactly the
    # ones a restarting controller loses the traceback for
    from ..core.telemetry import flight_recorder

    flight_recorder.install(role="serving_replica")

    mem_frac = os.environ.get("FEDML_REPLICA_MEM_FRACTION")
    if mem_frac:
        import torch

        if torch.cuda.is_available():
            torch.cuda.set_per_process_memory_fraction(float(mem_frac))

    factory = resolve_factory(args.predictor)
    predictor = factory(args.model_path) if args.model_path else factory()

    from .fedml_inference_runner import FedMLInferenceRunner

    runner = FedMLInferenceRunner(predictor, port=args.port)
    port = runner.start()
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(port))
        os.replace(tmp, args.port_file)  # atomic: controller never reads half a write
    print(f"replica ready on {port}", flush=True)
    runner._thread.join()


if __name__ == "__main__":
    main()
