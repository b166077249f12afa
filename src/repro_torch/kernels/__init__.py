"""Hand-written Hopper kernels of the port, each beside its plain torch
version in ``kernels.ref``.

* ``kernels.tpd.batch_tpd_cuda`` — batched TPD (eqs. 6-7), the port of
  the TPU kernel ``repro/kernels/tpd.py:batch_tpd_pallas``; one launch
  also builds the trainer leaf loads that kernel takes as an operand.
* ``kernels.fedavg`` — weighted FedAvg (``fedavg_rows``,
  ``fedavg_batched``, ``fedavg``), one CUDA reduction that ports both
  ``repro/kernels/fedavg.py:fedavg_batched_pallas`` and
  ``fedavg_pallas``; ``kernels.ops`` wraps it for trees.
* ``kernels.flash_attention.flash_attention`` — GQA attention forward
  with causal, window and ``kv_len`` masks, the port of
  ``repro/kernels/flash_attention.py:flash_attention_pallas``: one
  kernel per dtype, bf16 on the tensor cores (``wgmma`` + TMA) and
  float32 on scalar FMAs.
* ``kernels.rglru.rglru_scan`` — the RG-LRU linear recurrence, the
  port of ``repro/kernels/rglru.py:rglru_scan_pallas``.
* ``kernels.fused_adamw.fused_adamw`` — one AdamW step over flat
  buffers, in place, the port of
  ``repro/kernels/fused_adamw.py:fused_adamw_pallas``.
* ``kernels.flash_attention.flash_attention_bwd`` and
  ``kernels.rglru.rglru_scan_bwd`` — the backward passes of the two
  above (no TPU counterpart), behind autograd Functions.

``kernels.build`` compiles each ``csrc/*.cu`` at first use.
"""
