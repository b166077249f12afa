"""PyTorch/CUDA port of the Flag-Swap aggregation-placement system.

A second package beside ``repro`` (the JAX reference). It keeps the
reference's module layout and names, imports ``torch`` and numpy but
never ``jax`` or ``repro``, and runs its entry points on ``cuda`` unless
the caller passes ``device="cpu"``.

Ported so far (the simulated Flag-Swap track, paper Fig. 3):

* ``core`` — hierarchy, client pool, Flag-Swap PSO, the strategy
  registry with all ten strategies, and ``CostModel`` (eqs. 6-7);
* ``kernels`` — the batched TPD kernel (``csrc/tpd.cu``) beside its
  plain torch version;
* ``experiments`` — scenarios, cohort sampling and the simulated
  environments;
* ``fl.distributed`` — the hierarchy ladders of the elastic tracks;
* ``faults.schedule`` — the fault vocabulary ``ScenarioSpec`` carries.
"""
