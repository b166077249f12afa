"""PyTorch/CUDA port of the Flag-Swap aggregation-placement system.

A second package beside ``repro`` (the JAX reference). It keeps the
reference's module layout and names, imports ``torch`` and numpy but
never ``jax`` or ``repro``, and runs its entry points on ``cuda`` unless
the caller passes ``device="cpu"``.

Ported so far (the simulated Flag-Swap track, paper Fig. 3; the
emulated track, Fig. 4; the hybrid LM serving and training paths):

* ``core`` — hierarchy, client pool, Flag-Swap PSO, the strategy
  registry with all ten strategies, and ``CostModel`` (eqs. 6-7);
* ``kernels`` — the TPD, FedAvg, fused AdamW, flash-attention and
  RG-LRU kernels, the last two with their backward kernels
  (``csrc/*.cu``), each beside its plain torch version;
* ``experiments`` — scenarios, cohort sampling and the simulated
  environments;
* ``fl.distributed`` — the hierarchy ladders of the elastic tracks;
* ``faults.schedule`` — the fault vocabulary ``ScenarioSpec`` carries;
* ``configs``, ``data``, ``models``, ``fl`` — the paper MLP, its data,
  the FedAvg aggregator and the round engines; ``recurrentgemma-2b``;
* ``serving`` and ``launch.serve`` — the wave scheduler and the serving
  driver;
* ``optim``, ``train``, ``checkpoint`` — AdamW (through the fused
  kernel) and SGD, the schedules, ``TrainLoop`` and npz checkpoints.
"""
