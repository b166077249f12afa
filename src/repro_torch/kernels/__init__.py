"""Hand-written Hopper kernels of the port, each beside its plain torch
version in ``kernels.ref``.

* ``kernels.tpd.batch_tpd_cuda`` — batched TPD (eqs. 6-7), the port of
  the TPU kernel ``repro/kernels/tpd.py:batch_tpd_pallas``.
"""
