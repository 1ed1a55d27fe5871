"""Simulators (counterpart of ``fedml_tpu/simulation``): the sp, vmapped,
NCCL (``collective/``) and MPI (``mpi_sim.py``) fronts."""
