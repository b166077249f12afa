#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root (it puts ``src`` on ``sys.path`` itself):

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc``. Without a card, or outside a
checkout of the repository, it exits non-zero and prints no result.
Phases, in order; any failed check raises and ends the run non-zero
(to make room for phase 28, every serving phase decodes 16 new tokens
a request, not 32, every federated LM run takes 2 rounds, not 3, phase
25 times the sLSTM loop at 1 x 128 only, and phase 27 runs one round
of each mode; so that the script ends well inside its 1200 s on a
slower host too, phase 27 (c) runs at most 4 layers, not 18, phase 28
serves at most 6 layers, not 36, and takes its gradient at most at 4,
not 15, phase 29 runs 2 and 1 layers, not 4 and 2, phase 25 trains 4
layers, not 8, phase 26 serves llava at 16 of 32 layers and cuts both
families to 1 layer against the CPU, not 2, and every
``launch/train.py`` run takes ``--batch-size 8``, not 32; to make room
for phase 30, phase 16's training depth cut takes 1 step on each
device, not 2, its bfloat16 step with plain SGD, not AdamW, phase 6
runs paper-fig4 for 20 rounds, not 50, phase 7 runs 3 rounds, not 5,
phase 11 and phase 26 (b) and (d) hold one request of each wave to its
serial decode, not all 8, phase 20 runs 8 rounds, not 12, every
federated LM run takes 1 round, not 2, phase 25 profiles its stages at
a 4 x 1024 prefill, not 4 x 2048, and serves a wave of 4 x 512, not
4 x 1024, phase 27 (c) runs its hierarchical round only, not also a
flat one, with 1 local step, not 2, phase 29 (b) runs its held round
only, not after a warm-up round, the federated clients of phases 27
(c), 29 (b) and 30 (c) train without remat (a rank's first remat call
imports ``torch._dynamo``, which stalled each world's first round);
and phase 30 serves seamless-m4t-large-v2 at 2 + 2 layers, not 12 +
12, whose 12-layer decoder's decode took 0.47-0.53 s a token over
gloo):

1. card and toolchain (and both TF32 flags);
2. build all eight kernel sources (``src/repro_torch/csrc/tpd.cu``,
   ``fedavg.cu``, ``flash_attention.cu``, ``flash_attention_bwd.cu``,
   ``flash_attention_sm90.cu``, ``flash_attention_bwd_sm90.cu``,
   ``rglru.cu`` and ``fused_adamw.cu``), one ``nvcc`` each, started
   together; each tensor-core kernel's registers, shared memory and
   spills from the ``-Xptxas -v`` log, and the ``HGMMA`` (wgmma) and
   ``UTMALDG`` (TMA load) instructions ``cuobjdump -sass`` finds in the
   bf16 libraries and the ``HMMA`` (mma.sync) instructions it finds in
   the float32 ones, which must not be 0; the RG-LRU kernels'
   registers, shared memory and spills, and the plan (blocks, stages, dynamic shared
   memory, held to the kernel's own count) at the training and serving
   shapes; the TPD kernel's registers and shared memory, its launch
   plan's shared memory and scratch held to the kernel's own counts;
3. the TPD kernel against its plain torch versions on the card, in
   both modes: given the leaf loads (the TPU kernel's operands), and
   building them in the same launch, its leaf loads held to np.bincount's
   and its TPDs to ``tpd_ref``'s, exactly, and against the float64 scalar
   model within rtol 2e-5, at the Fig. 3 extremes, large-1k, large-10k
   and a 60,000-client pool (the scratch route), with duplicate-id rows
   and payloads over 2^-30..2^30; reruns bit-equal;
4. the FedAvg kernel against its plain torch version on the card,
   exactly (atol 0): paper-fig4's two tree levels and a 256-client
   tree's leaf level at the paper MLP's N = 1,791,754, K = 1, ragged
   tails (N = 2049, 7), a bfloat16 pool, and the dense ``fedavg_batched``
   and ``fedavg`` forms; ``torch.einsum`` on the dense stack is printed
   beside it as a yardstick;
5. the simulated main path: the paper's Fig. 3 grid (depth {3,4,5} x
   width {4,5} x particles {5,10}, 100 iterations, seed 0) through
   ``FlagSwapPSO.run`` on ``cuda``, then large-10k (10 particles, 50
   iterations), each Fig. 3 cell held exactly to the same run on the CPU,
   every TPD launch on the route that builds the leaf loads in shared
   memory;
6. the emulated main path: ``run_experiment("paper-fig4", ["pso",
   "random", "uniform"], rounds=20, seeds=[0])`` on ``cuda`` with the
   full-width paper MLP (batched engine, deterministic timing), held to
   the same run on the CPU: placements and TPDs exactly, losses within
   rtol 1e-4, final params within rtol 1e-3 (atol 1e-5);
7. the loop engine: paper-fig4 with ``engine="loop"`` for 3 rounds on
   ``cuda``: its TPD trace equals the batched engine's exactly, its
   params agree within rtol 1e-3 (atol 1e-5);
8. where a round's time goes: 3 rounds of paper-fig4, then full scale:
   256 clients (``choose_fl_hierarchy(256)``), the full-width paper
   MLP, 4 local steps of batch 8, 3 rounds of the batched engine on
   ``cuda``; each round split into local training, aggregation and
   evaluation, its aggregate held to the flat weighted sum;
9. TPD and FedAvg timings (CUDA events, medians) beside the card's name
   and power limit. The JSON line's ``ms``, ``plain_ms`` and
   ``library_ms`` are device time per call, host enqueue hidden behind
   a device spin; wrapper-call times, host enqueue included, are
   printed beside them. For the TPD kernel: both modes at large-10k, P
   = 10 and 1000, beside both bounds and the floor of one launch; one
   ``batch_tpd(backend="kernel")`` call under ``torch.profiler`` (it
   must run one kernel and two copies on the device) and its host-clock
   breakdown; ``batch_tpd`` on the ``np``, ``torch`` and ``kernel``
   backends at five sizes;
10. the flash-attention and RG-LRU kernels against their plain torch
    versions at recurrentgemma-2b's serving shapes: flash at B = 4,
    Hq = 10, Hkv = 1, hd = 256, S = 1024 causal, S = 4096 and a ragged
    4097 with window 2048, bf16 (the sm90 route, rtol = atol = 2e-2)
    and f32 (the split-TF32 route, 1e-4), each held to have launched
    its own route's kernel only; flash at hd 80 (stablelm-3b's 32 x 80,
    B 2, S 1024 causal: bf16 zero-padded to the hd-128 kernel, f32
    native) and hd 320 (B 1, 10 heads on 1, S 1024 causal: both dtypes
    on the f32 kernel), at the same tolerances; flash bf16 at phases
    22 and 24's prefill shapes, B 4 causal: granite-8b's GQA 32/8 at hd
    128, S 1024 and 4096, stablelm-3b's 32 x 80 at S 1024,
    granite-moe-1b-a400m's GQA 16/8 at hd 64 and qwen3-moe-235b-a22b's
    GQA 64/4 at hd 128, S 1024 (2e-2); the
    scan at (4, 4096, 2560) f32, ragged T
    and D, and the training shape (1, 2048, 2560) f32 and bf16, exactly,
    with both copy routes (TMA, cp.async) launched;
11. the hybrid serving main path: full-width ``recurrentgemma-2b``
    (26 layers, 3.55B f32 params drawn on the card, bf16 compute)
    serving 8 requests through ``WaveScheduler(max_batch=4)``: 4 prompts
    of 1024 tokens and 4 of 4096 (tokens from numpy, seed 0), 32 new
    tokens each, the RG-LRU scan on the TMA route only; one request of
    each wave equal to its batch-1 serial decode; prefill
    time, decode time per token and ``summary()``; where a decode step
    goes; and prefill(4096) + decode equal to prefill(4097) (f32 rtol =
    atol = 2e-3, bf16 atol 0.5 on logits of scale ~5);
12. a depth cut against the CPU: the same params at full width cut to
    one triple and two tails, a 64-token prompt, prefill and a decode
    step on ``cuda`` (both kernels) vs ``cpu`` (plain versions), f32 and
    bf16 at the same tolerances; the f32 run is the f32 flash route's
    path (its launches counted from 0 over it);
13. flash and RG-LRU timings: kernel, wrapper call, plain version and
    (flash) ``torch.nn.functional.scaled_dot_product_attention`` as the
    yardstick, beside each bound: the bf16 route at both serving shapes
    and the training shape (B 1, S 2048 causal), with TFLOP/s and share
    of the bound, the f32 route at S = 1024 and at the training shape
    (its split-TF32 and scalar-FMA bounds both printed), and both
    routes at hd 80, and the bf16 route at the 1024-token prefill
    shapes of phases 22 and 24 (granite-8b, stablelm-3b, granite-moe,
    qwen3-moe); the scan at the serving shape and the training shape (1, 2048, 2560), and at the serving
    shape also on the cp.async route (operands one element past an
    aligned base) beside copying them to fresh aligned tensors first and
    taking the TMA route;
14. the training kernels against their plain torch versions: fused
    AdamW at N = 1, 3, 4097 and 2^24 + 5, float32 and bfloat16 params,
    steps 1 and 1000, bit for bit; the flash backward (through the
    autograd Function, against autograd of the dense plain version) at
    B 1, Hq 10, Hkv 1, hd 256, S 2048 causal and S 4096 window 2048, bf16
    (the sm90 route, 2e-2 of the gradients' scale) and f32 (the
    split-TF32 route, 1e-4), two runs bit-equal on each; the RG-LRU adjoint at
    (1, 2048, 2560) and ragged shapes, exactly, both copy routes launched;
15. the training main path: ``TrainLoop(model, adamw(
    warmup_cosine_schedule(3e-4, 2, 8)), batch_fn, TrainLoopConfig(
    total_steps=8, log_every=1))`` on full-width, full-depth
    recurrentgemma-2b (params from seed 0, as phase 11's), remat on, 1 x
    2048 tokens of ``SyntheticLMDataset(256000, 2048, seed=0)`` a step:
    losses (finite), step times, peak memory, launch counts held to the
    expected ones (both RG-LRU kernels on the TMA route only), and on
    the last step a window of p, g, m, v past
    element 2^31 held bit for bit to the plain AdamW;
16. a training depth cut: those params cut to one triple and two tails,
    1 x 128 tokens, 1 step on ``cuda`` vs ``cpu``, float32 compute
    with ``adamw`` (losses rtol 1e-4, update within 3% in norm, at most
    0.2% of the elements outside rtol 1e-3 / atol 1e-5) and bfloat16
    with ``sgd(1.0)``, whose update is the gradient (losses rtol 1e-2,
    update within 10% in norm); the f32 run is the f32 flash backward's
    path;
17. timings of the three training kernels beside their bounds, the plain
    versions and (AdamW, flash backward) ``torch._fused_adamw_`` and the
    SDPA backward as yardsticks, the flash backward on both routes (f32
    also at S 1024, B 4; both at hd 80);
18. the runner's other paths on ``cuda``: ``python -m
    repro_torch.experiments run paper-fig3 --set rounds=6 --rounds 6
    --strategies pso,random --seeds 0`` in a subprocess, its artifact
    equal to ``tests/golden/recording_off_fig3.json`` byte for byte and
    passed by ``validate``; large-1k (5 rounds) and flash-crowd (25) with
    ``EvalConfig(mode="batched")`` and ``"sequential"``, each equal to
    its ``tests/golden/sampling_off_*.json``; the ``two-tier`` preset
    (150 rounds, pso and random) equal to the same run on the CPU;
    ``TwoTierCostModel.batch_tpd`` at large-1k, 8 pods, P = 10 and 1000,
    within rtol 2e-5 of the float64 scalar model, with no TPD kernel
    launch over the preset and the swarms, and ``backend="kernel"``
    refused;
19. the emulated fault track at full width: ``chaos`` on the emulated
    track (the preset's paper MLP, its seeded fault profile and quorum
    0.2), pso and greedy, 12 rounds on ``cuda``, held to the same run on
    the CPU (placements, TPDs and every fault series exactly, losses
    within rtol 1e-4 as phase 6 holds Fig. 4, final params within rtol
    1e-3, atol 1e-5 but for at most 1e-5 of them: float32 training on
    two devices can put a ReLU pre-activation on the other side of 0,
    moving a few elements by ~1e-4; the largest difference a round is
    printed); its ``fedavg_batched`` launches held to (clean
    rounds + one warm-up a run) x tree levels; a pso run checkpointed at
    round 6 and resumed to 12 equal to the uninterrupted run's
    ``to_dict()`` byte for byte; wall seconds a round;
20. the online track at full width (the presets' paper MLP, N =
    1,791,754 f32) on ``cuda``, each run held to the same run on the
    CPU (placements, TPDs, the event log and every online and fault
    series exactly, losses within rtol 1e-4, final params within rtol
    1e-3 / atol 1e-5 but for at most 1e-5 of them, as phase 19):
    ``online-sync`` (8 rounds of pso) also equal to the emulated
    ``paper-fig4`` run on ``cuda`` bit for bit (``torch.equal`` on the
    final params); ``online-fig4`` (8 rounds of pso and greedy);
    ``online-straggler`` (6 rounds, at least one REOPT swap); ``chaos``
    online (8 rounds of pso and greedy) and a pso run checkpointed at
    round 6 and resumed to 8 equal to the uninterrupted run's
    ``to_dict()`` byte for byte; the ``fedavg_batched`` launches over
    the phase held to the CPU rehearsal's count (aggregations x tree
    levels: one warm-up a run and every lockstep round);
21. trace calibration on ``cuda``: ``record_trace("paper-fig4",
    rounds=6)`` (full-width MLP) equal to the CPU run's JSON byte for
    byte, its fit (last round held out) and replay reports equal to the
    CPU trace's; the Fig. 3 grid's swarms (as phase 5) priced by the
    fitted ``CalibratedCostModel`` on ``cuda`` (auto-selection: numpy
    below the fast-path threshold, as on the CPU) with 0 TPD kernel
    launches, held exactly to the same swarms on the CPU, and its
    analytic twin with one launch an iteration;
    ``CalibratedCostModel.batch_tpd`` at large-1k, P = 10 and 1000
    (auto, torch build and numpy, host clock; both builds within rtol
    2e-5 of the float64 scalar model, 0 launches) and
    ``backend="kernel"`` refused;
22. the dense serving main path: full-width ``granite-8b`` (36 layers,
    GQA 32/8 at hd 128, 8.25e9 f32 params drawn on the card, bf16
    compute) serving 8 requests through ``WaveScheduler(max_batch=4)``
    (4 prompts of 1024 tokens and 4 of 4096, 16 new tokens each): per
    wave the prefill time, the decode time per token (synchronised, and
    the host's issue time) and the peak memory; one flash launch a layer
    a wave, on the sm90 route only; one request of each wave equal to its
    batch-1 serial decode; a 2-layer depth cut at full width on
    ``cuda`` vs ``cpu`` (a 64-token prompt: prefill logits, both KV
    caches and 4 decode steps, bf16 and f32, at phase 12's tolerances);
    then one wave of full-width ``stablelm-3b`` (4 x 1024 tokens, 16 new
    tokens; hd 80 on the padded sm90 route, one launch a layer);
23. federated LM rounds: ``launch.train.main`` on stablelm-1.6b
    ``reduced()`` (pso, 7 clients, 1 round, batch 8) on ``cuda``, exit
    0 with finite losses; then the batched engine (deterministic timing, 7
    clients, 1 round of pso) on ``cuda`` and on ``cpu`` from the same
    initial params for stablelm-1.6b and recurrentgemma-2b ``reduced()``
    at float32 compute: placements and TPDs exactly, losses within rtol
    1e-4; the flash forward/backward, RG-LRU scan/adjoint and
    ``fedavg_batched`` launches held to the CPU rehearsal's count (the
    flash and scan calls at the models' entry, counted on both devices;
    (warm-up + rounds) x tree levels of FedAvg);
24. the moe family on ``cuda`` (params drawn on the card from seed 0):
    (c) ``moe_ffn`` on one full-width granite-moe-1b-a400m layer (E 32,
    top 8, F 512) at 4 x 1024 float32 tokens against the host: at least
    99.9% of the routing choices equal, 99% of the tokens' outputs
    within 1e-4, two card runs bit-equal; the layer's profile at that
    prefill and at decode B 4 (router, both top-k sorts, gather, the
    expert products against their float32 bound, combine); (d)
    full-width, full-depth granite-moe-1b-a400m (1.385e9 f32 params,
    bf16 compute) serving 8 requests through ``WaveScheduler(max_batch=
    4)`` (4 x 1024 and 4 x 4096 tokens, 32 new each): prefill and
    decode times, peak memory, one sm90 flash launch a layer a wave; the
    outputs equal to a direct ``prefill_fn`` + ``decode_fn`` loop over
    the same waves, whose rerun gives bit-equal logits, and a second
    scheduler run's; how many requests equal their batch-1 serial run
    is printed, not asserted (expert capacity spans the wave, as in the
    reference); (e) a 2-layer depth cut at full width on ``cuda`` vs
    ``cpu`` (a 64-token prompt and 4 decode steps): bf16 logits within
    0.5 with greedy tokens agreeing outside the drift band, as
    ``tests/test_serve_consistency.py`` holds the moe family, float32
    within phase 22's tolerance, the routing share printed; (g)
    ``TrainLoop`` on uncut granite-moe-1b-a400m, 4 steps of 1 x 2048
    tokens, remat on: finite losses and ``moe_aux``, step times, peak
    memory, launch counts; (f) qwen3-moe-235b-a22b at full width cut to
    2 layers (6.22e9 f32 params): one wave of 4 x 1024 tokens, 16 new
    each, then the same params on the host: a 1 x 256 prefill and 4
    decode steps in float32 at (e)'s tolerance; (h) ``launch/train.py
    --arch granite-moe-1b-a400m`` (reduced) on ``cuda``, then the
    batched engine on ``cuda`` and ``cpu`` (7 clients, 1 round of pso,
    float32): placements and TPDs exactly, losses within rtol 1e-4,
    flash and FedAvg launches held to the CPU rehearsal's count, 0 TPD
    launches;
25. the xLSTM (ssm) family on ``cuda`` (params drawn on the card from
    seed 0): (a) one full-width mLSTM block and one sLSTM block of
    xlstm-1.3b at 2 x 512 float32 tokens against the host (outputs and
    final states within rtol = atol = 1e-3, two card runs bit-equal),
    then their stages under ``torch.profiler`` at prefill 4 x 1024 and
    decode B 4 (bf16: up projection, q/k/v/gates, the chunkwise cell,
    out-norm and down; the sLSTM input projection, loop and out
    projection), with the sLSTM loop's launches a step and a token and
    its device time against its host time; (b) full-width, full-depth
    xlstm-1.3b (2.62e9 f32 params, bf16 compute) serving 4 requests
    through ``WaveScheduler(max_batch=4)`` (4 x 512 tokens, 32 new
    each; the 4 x 2048 wave gave phase 26 its time, the 4 x 1024 wave
    phase 30): prefill and decode
    times, peak memory, no kernel launch, one request equal to its
    batch-1 serial run, a decode step under ``torch.profiler``; (c) a
    2-layer full-width cut (one block of each kind), a 512-token prompt and 4
    decode steps, on ``cuda`` vs ``cpu``: float32 logits within 2e-4,
    bf16 greedy tokens by tests/test_serve_consistency.py's drift-band
    rule; (d) ``TrainLoop`` on xlstm-1.3b at full width cut to 4 layers
    (2 blocks of each kind), 2 steps of 1 x 2048
    tokens, remat on, ``adamw``: finite losses, step times, peak
    memory, one fused AdamW launch a step and no other; a step of 1 x
    128 under ``torch.profiler`` (device busy share); the sLSTM loop
    alone at 1 x 128, forward and forward + backward, its
    own backward against autograd's (gradients within 1e-4 of their
    scale), and its share of the step's device time; (e)
    ``launch/train.py --arch xlstm-1.3b`` (reduced) on ``cuda``, then
    the batched engine on ``cuda`` and ``cpu`` (7 clients, 1 round of
    pso, float32): placements and TPDs exactly, losses within rtol
    1e-4, the FedAvg launches held to the CPU rehearsal's count and no
    other kernel;
26. the vlm and audio families on ``cuda`` (params drawn on the card
    from seed 0): (a) the bf16 flash forward and backward at their
    serving prefill shapes, seamless-m4t-large-v2's encoder (B 4, 16
    heads of 64, S 1024, ``causal=False``) and decoder (causal, S 1024)
    and llava-next-mistral-7b's prefill (B 4, GQA 32/8 at hd 128, S
    4096, causal), against the plain version one batch row at a time
    (2e-2; the backward within 2e-2 of the gradients' scale), reruns
    bit-equal, then device times of the kernel, the plain version and
    SDPA beside the bound (a bidirectional pair count is S^2); (b)
    full-width llava-next-mistral-7b (7.24e9 f32 params drawn, bf16
    compute) at 16 of its 32 layers serving 8 requests through ``WaveScheduler(
    max_batch=4, frontend=...)`` behind one seeded 2880 x 4096 prefix
    (4 x 512 and 4 x 1024 text tokens, 3584 and 4096 after padding, 32
    new each): prefill and decode times, peak memory, one causal sm90
    flash launch a layer a wave, one request of each wave equal to its
    batch-1 serial decode, a decode step under ``torch.profiler``; (c) a
    1-layer
    full-width cut, 1 x (2880 + 64) and 4 decode steps, on ``cuda`` vs
    ``cpu``: float32 logits within 1e-4, bf16 greedy tokens by the drift
    band; (d) full-width seamless-m4t-large-v2 (1.28e9 params) served
    the same way behind a 1024 x 1024 frontend (one request of each
    wave equal to its serial decode; 12 bidirectional and 12 causal
    flash launches a
    wave), a 1 + 1-layer cut held to the CPU as (c), and 4 ``TrainLoop``
    steps of 1 x 2048 text tokens, remat on: losses, step times, peak
    memory, launches by mask; (e) llava trained 2 steps of 1 x (2880 +
    1024) at the deepest full-width depth cut that leaves 10 GiB of the
    card free (from 20 bytes a layer param and the largest leaf's
    stack), held to leave it; (f) ``launch/train.py`` for both families
    (reduced) on ``cuda``, then the batched engine on ``cuda`` and
    ``cpu`` (7 clients, 1 round of pso, float32): placements and TPDs
    exactly, losses within rtol 1e-4, the flash and FedAvg launches held
    to the CPU rehearsal's count;
27. the paper's aggregation tree across ranks (``fl.distributed``,
    ``fl.aggregation``, ``launch.mesh``): (a) ``PooledTPDEvaluator.
    tpds_sharded`` at ndev 1, 3 and 8, every shard on the one card (the
    float64 torch build; no kernel), on the reference test's case (24
    clients, 5 pools, 21 rows: the pad path, with ``pool_idx``) and on
    large-1k pools at P = 1000, held to ``shard="off"`` (numpy) within
    rtol 1e-12 (exactness printed), then ``run_experiment("paper-fig3",
    ...)`` batched with ``shard="on"`` on ``cuda``: every pooled call's
    placements equal to ``shard="off"``'s, TPDs within rtol 1e-12; (b)
    the full-width paper MLP (N = 1,791,754 f32) over a spawned gloo
    world of 8 ranks on the card (``launch.world.run_world``): meshes
    ``("data",)`` of 8 with 8 clients, of 8 with 4 clients of 2 ranks
    each, and ``("pod", "data")`` = (2, 4), ``FLTrainStep`` rounds
    (hierarchical and flat, ``choose_fl_hierarchy`` trees, the PSO's
    placement, 2 local steps of 32) from one seeded init, every rank's
    params bit-equal, held to the host path on ``cuda`` (one FedAvg
    launch a round) within rtol 1e-5 / atol 1e-7, and hierarchical to
    flat likewise; (c) full-width stablelm-1.6b (bf16 compute, f32
    params) at the deepest depth whose 4 ranks leave 10 GiB of the card
    free (12 bytes a layer param and 8 of the others a rank) over
    4 ranks, tree (2, 1, 2, 4), ``sgd(0.05)``,
    1 local step of 1 x 512 tokens a client, one hierarchical round
    (a second was cut for phase 28's time, a flat one for phase 30's; at
    most DIST_LM_LAYERS = 4 layers since phase 29);
    rank 0 then runs the host path on the card from the same init
    (held bit for bit) and, for each round, from the rank
    path's params before it: losses within rtol 1e-4, params within rtol
    1e-3 / atol 1e-5 but for a share of 1e-5; each round split into
    local steps and each aggregation step (ms, bytes, ranks), peak memory
    a rank, flash forward and backward launches held to 1 and 3 a layer
    a local step (2 and 3 with remat);
28. full-width granite-8b over a (1, 4) ``("data", "model")`` mesh of
    spawned gloo ranks on the card (``models/transformer_tp.py``), with
    ``seq_shard`` off and then on, each rank holding its shards of the
    seeded init: (a) serving at the deepest depth whose ranks and whose
    unsharded run each leave 10 GiB free, at most TP_SERVE_LAYERS = 6
    (all 36 fit; the cap is the script's time): the unsharded
    bf16 and float32 runs on the card first (one wave of 4 x 1024
    prompts, 8 greedy decode tokens; float32 fed bf16's tokens), then
    the ranks' prefill and the same 8 decode steps, their last-token
    logits within the band of bf16 against float32 and their greedy
    tokens in that band (``greedy_in_band``), the logits equal on every
    rank; prefill time a wave, decode time a token, each's share in
    collectives, bytes a collective, peak memory a rank; (b) one
    gradient of 1 x 2048 (remat) at the deepest depth whose unsharded
    step and whose ranks each leave 10 GiB free, at most TP_GRAD_LAYERS
    = 4 (15 fit): the unsharded gradient
    to shared host memory, then the ranks' loss within rtol 1e-3 of its,
    each leaf's gathered relative L2 error at most 2e-2, the norms'
    gradients bit-equal on every rank; step time and its collective
    share; (c) each rank holds 1/4 of every model-sharded leaf's bytes
    and all of the replicated ones, and launches the sm90 flash forward
    (and in (b) its backward) on its own 8 q and 2 kv heads (the
    wrappers' ``heads`` counts);
29. full-width granite-8b over data x model meshes of spawned gloo
    ranks on the card (``models/transformer_tp.py`` with batch axes and
    fsdp, ``fl/distributed.py`` over a model axis): (a) a (2, 2) mesh,
    ``make_policy(mesh, fsdp=True, seq_shard=True)`` (the reference's
    standard and prefill layout; granite-8b sets ``fsdp``): one prefill
    wave of 4 x 1024 prompts (2 rows a data rank) at FSDP_SERVE_LAYERS
    = 2 layers, then the same cut drawn again with fsdp off (the
    decode layout) and 8 decode steps fed the unsharded bf16 run's
    greedy tokens, the last-token logits within twice the unsharded
    run's bf16-to-float32 gap, greedy tokens in it, equal on every rank;
    two ``make_train_step`` steps of ``adamw()`` (clip 1.0) with remat
    on a global batch of 2 x 2048 at FSDP_TRAIN_LAYERS = 1 layer: the
    first loss within rtol 1e-4 of the unsharded bf16 step's, the
    pre-clip global norm within 1e-3, each leaf of the first gradient
    within twice the unsharded gradient's bf16 gap (read by CUDA IPC),
    the norms bit-equal on every rank after both steps, a window of
    2^22 elements at each end of every rank's flat buffer held bit for
    bit to the plain AdamW each step; (b) a (4, 2) mesh, 4 clients of
    2 model ranks, the reference's federated policy (model and seq
    axis, no batch or fsdp axes), ``sgd(0.05)``, tree (2, 1, 2, 4) at
    placement [1, 0], 1 x 512 tokens a client, at FL_TP_LAYERS = 1
    layer: one round (a warm-up before it was cut for phase 30), whose
    update (after minus
    before, leaf by leaf) is held to the host path's from the same
    params (written by the data-axis-0 ranks into the parent's buffers,
    CUDA IPC) within twice the host path's bf16-to-float32 gap, every
    rank's shards bit-equal along the data axis; prefill, decode, step
    and round times, each's share in collectives, bytes a collective,
    peak memory a rank, flash launches on each rank's 16 q and 4 kv
    heads. The depths are set by the phase's time (each layer's fsdp
    gather moves its float32 shard through gloo), not by memory;
30. full-width recurrentgemma-2b and seamless-m4t-large-v2 over 4
    spawned gloo ranks on the card (``models/rglru_tp.py``,
    ``models/encdec_tp.py``): first the RG-LRU scan and adjoint at a
    model-axis rank's shapes, (2, 4096, 640) and (1, 2048, 640) f32, on
    the TMA route, bit-equal to the plain versions, with device times
    beside the bound; then three worlds of 4 ranks (FAM_WORLDS: one each
    for recurrentgemma-2b's (b) and (c), whose ranks hold 15.4 and 8.9
    GiB each on the card, one for its (a) and all of seamless; the
    references on the card, read by CUDA IPC, but (b)'s in the host's
    shared memory; each world spawned only if the card has its ranks'
    measured peak reserves, plus 1 GiB a rank, free) run
    (a) a (1, 4) mesh,
    ``seq_shard`` off and on: recurrentgemma-2b at 5 layers (one triple,
    both tails; a wave of 2 x 4096, the 2048 window binding) and
    seamless at 2 + 2 (a wave of 4 x 512 behind 1024 stub frames), the
    prefill and
    8 decode steps fed the unsharded bf16 run's greedy tokens, the
    last-token logits within twice the unsharded run's bf16-to-float32
    gap and the greedy tokens in it, equal on every rank; a gradient of
    1 x 2048 (recurrentgemma at 5 layers, seamless at 2 + 2) held leaf
    by leaf to twice the unsharded gradient's bf16 gap (read by CUDA
    IPC), the loss within rtol 1e-3, the replicated leaves' gradients
    bit-equal on every rank; (b) a (2, 2) mesh, ``make_policy(mesh,
    fsdp=True, seq_shard=True)``: the wave's prefill within the same
    band, two ``adamw()`` steps (clip 1.0, remat) of 2 x 512 at the
    gradient's cut, the first loss within rtol 1e-4 of the unsharded
    step's, the pre-clip global norm within 1e-3, each leaf within
    twice its bf16 gap (the two vocab tables over a window of their
    vocab dim: the batch's ids and every 1021st), the fused AdamW
    windows bit for bit to the
    plain version every step, the replicated leaves bit-equal; (c) a
    (2, 2) mesh, 2 clients of 2 model ranks, the reference's federated
    policy, ``sgd(0.05)``, flat mode, 1 x 512 tokens a client
    (recurrentgemma cut to one triple, seamless to 1 + 1): a warm-up
    round and a round whose update is held to the host path's (one
    FedAvg launch, from the ranks' params before it) within twice the
    host path's bf16 gap, the shards bit-equal along the data axis.
    Every rank's flash launches run on its own heads (recurrentgemma:
    all 10 q and the 1 kv head on every rank; seamless: 4 and 4 at
    M = 4, 8 and 8 at M = 2) and its RG-LRU launches on the TMA route;
    prefill, decode, step and round times, each's seconds in
    collectives, bytes a collective and peak memory a rank are printed.
    Then the ``kernels`` JSON line (ten kernels) and the final status
    line.

Each kernel's launch count is set to 0 just before the path that runs
it and read just after: ``tpd`` over phase 5, ``fedavg_batched`` over
phase 6's cuda run, ``fedavg`` over phase 7's loop-engine run,
``flash_attention`` and ``rglru_scan`` over phase 11's scheduler run
(their training launches are printed in phase 15), and
``fused_adamw``, ``flash_attention_bwd`` and ``rglru_scan_bwd`` over
phase 15's ``TrainLoop.run``; the two flash kernels run bf16 there, so
the f32 route's (``flash_attention_f32``, ``flash_attention_bwd_f32``)
are counted over the float32 depth cuts on ``cuda`` (phases 12 and 16).
Comparison and timing launches never enter the JSON line's
``launches``. Phases 18 and 19 count their own launches (``tpd`` over
the two-tier model, which must be 0; ``fedavg_batched`` over the fault
run) and print them, and so do phases 20 (``fedavg_batched`` over the
online runs) and 21 (``tpd`` over the calibrated swarms, which must be
0, and over their analytic twin). Phases 22-26 are main paths too:
every count is set to 0 just before each (the scheduler's run of
granite-8b, the scheduler's stablelm-3b wave, the ``launch/train.py``
runs and the batched engine's cuda runs, the granite-moe scheduler
run, its ``TrainLoop.run``, the qwen3-moe cut's wave, phase 25's
scheduler run, ``TrainLoop.run``, ``launch/train.py`` run and engine
run, and phase 26's two scheduler runs, two ``TrainLoop.run`` calls,
``launch/train.py`` runs and engine runs) and read just after; each
path's count is the sum of its runs', the JSON line's ``launches`` is
the sum over the paths, and ``launches_by_path`` holds each path's
count. Phase 26 splits the flash kernels' count of a path that runs
the encoder by mask, ``causal=1`` and ``causal=0`` (the wrappers'
``modes``), so the bidirectional launches show on their own. Phase 27's
ranks count their own launches (set to 0 before their rounds, read
after) and return them; the parent adds them, with its own over the
Fig. 3 ``shard="on"`` run and the host paths, under ``"phase 27"``.
Phase 28's ranks count theirs over each path (the prefill and decode
of a ``seq_shard`` setting, its gradient), summed over the ranks under
``"phase 28 (a) ..."`` and ``"phase 28 (b) ..."``; the unsharded
reference runs are comparisons and are not counted. Phase 29's ranks
count theirs over the fsdp prefill, the decode, the training steps and
the two federated rounds, summed over the ranks under ``"phase 29 (a)
..."`` and ``"phase 29 (b) ..."``; the unsharded runs and the host
path are comparisons and are not counted. Phase 30's ranks count
theirs over each path of (a), (b) and (c) (a prefill with its decode
steps, a gradient, the fsdp prefill, the training steps, the rounds),
summed over the ranks under ``"phase 30 (a|b|c) <arch> ..."``, the
flash kernels split by mask (``causal=1``, ``causal=0``) as phase 26
splits them; its timings of the RG-LRU kernels at a rank's shapes are
comparisons.
"""
from __future__ import annotations

import ctypes
import dataclasses
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
RTOL_SCALAR = 2e-5             # f32 paths vs the float64 scalar model
SEED = 0
FIG3_DEPTH, FIG3_WIDTH, FIG3_PARTICLES = (3, 4, 5), (4, 5), (5, 10)
FIG3_ITERATIONS = 100
FULL_SCALE_ITERATIONS = 50
FIG4_STRATEGIES = ("pso", "random", "uniform")
FIG4_ROUNDS = 20               # 50 before phase 30 (the CPU run took 26.5 s)
LOOP_ROUNDS = 3                # 5 before phase 30 (25 s on an H100 host)
# cuda vs cpu on the emulated track: the same float32 math summed in
# other orders (the card's matmuls, the kernel's k-ordered sums)
LOSS_RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-3, atol=1e-5)
SCALE_CLIENTS, SCALE_ROUNDS = 256, 3
SCALE_LOCAL_STEPS, SCALE_BATCH = 4, 8
TIMING_RUNS = 25               # medians over this many runs
LAUNCHES_PER_RUN = 20          # back-to-back launches inside one run
SPIN_CYCLES = 10_000_000       # device spin hiding host enqueue, ~5 ms
MAX_SPIN_CYCLES = 2 ** 31
L2_BYTES = 50 * 2 ** 20        # H100 L2: timed operands rotate past it


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


_START = time.monotonic()


def phase(title: str) -> None:
    """Print a phase's heading with the seconds since the script began,
    so the log shows where the script's time goes."""
    print(f"\n== {title} == [{time.monotonic() - _START:.1f} s]", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_kernels(log: str):
    """(kernel, registers, static shared memory bytes, spill store bytes,
    spill load bytes) of each entry function in an ``-Xptxas -v`` log;
    the kernel as its name and head-dim template argument."""
    found, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"\d(flash_\w+?_kernel)(?:ILi(\d+)E)?",
                          m.group(1))
            r = re.search(r"(rglru_scan(?:_bwd)?_kernel)I(f|13__nv_bfloat16)"
                          r"Li(\d)E", m.group(1))
            t = re.search(r"\d(tpd_kernel)ILi(\d)E", m.group(1))
            if t:
                name = f"tpd_kernel<route {t.group(2)}>"
            elif r:
                dtype = "float" if r.group(2) == "f" else "bf16"
                route = ("tma", "cp_async")[int(r.group(3))]
                name = f"{r.group(1)}<{dtype}, {route}>"
            else:
                name = (k.group(1) + (f"<{k.group(2)}>" if k.group(2) else "")
                        if k else m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name is not None:
            found.append((name, int(m.group(1)), int(m.group(2) or 0),
                          *spills))
            name = None
    return found


def sass_counts(nvcc: str, lib) -> dict:
    """How many HGMMA (wgmma), UTMALDG (TMA load) and HMMA (mma.sync)
    instructions ``cuobjdump -sass`` finds in a built library."""
    cuobjdump = Path(nvcc).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("HGMMA", "UTMALDG", "HMMA")}


def tpd_bytes(ps, L, W, depth, penalty) -> int:
    """Bytes the TPD function must move for the placements ``ps``: each
    placement row, leaf-load row and internal slot's kid row read once,
    the level starts (launch arguments) once, the output written once,
    and mdatasize and pspeed (and memcap when ``penalty`` > 0) read at
    the distinct ids this swarm places, the only ids the function
    reads them at."""
    P, D = ps.shape
    ids = len(set(ps.ravel().tolist()))
    rows = 3 if penalty > 0 else 2
    return P * (4 * D + 4 * L + 4) + 4 * W * (D - L) + 4 * rows * ids \
        + 4 * (depth + 1)


def tpd_fused_bytes(ps, C, L, W, depth, penalty) -> int:
    """Bytes the TPD function must move when it builds the leaf loads
    itself: each placement row and internal slot's kid row read once,
    mdatasize whole (every client is placed or a trainer of a leaf),
    pspeed (and memcap when ``penalty`` > 0) at the distinct placed ids,
    the level starts once and the output written once."""
    P, D = ps.shape
    ids = len(set(ps.ravel().tolist()))
    rows = 2 if penalty > 0 else 1
    return P * (4 * D + 4) + 4 * W * (D - L) + 4 * C + 4 * rows * ids \
        + 4 * (depth + 1)


def fedavg_bytes(rows, N, in_bytes, out_bytes) -> int:
    """Bytes one FedAvg reduction must move: every distinct member row
    read once, every output row written once, and the (G, K) row and
    weight tables once."""
    G, K = rows.shape
    read = len({int(r) for r in rows.reshape(-1).tolist() if r >= 0})
    return in_bytes * N * read + out_bytes * G * N + 8 * G * K


def median_event_ms(torch, fn, runs=TIMING_RUNS, per_run=LAUNCHES_PER_RUN):
    """Median over ``runs`` of the CUDA-event time of ``per_run``
    back-to-back calls of ``fn``, divided by ``per_run`` (ms per call):
    the wrapper-call time, host enqueue included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_run):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_run)
    return statistics.median(times)


def median_device_ms(torch, fn, runs=TIMING_RUNS, per_run=LAUNCHES_PER_RUN):
    """Like :func:`median_event_ms`, but the device first spins in a
    ``torch.cuda._sleep`` while the host enqueues all ``per_run`` calls,
    so the events bracket device work only, without the host's per-call
    cost (ms per call on the device). A run counts only if the device
    had not yet reached the first event when the host finished
    enqueueing; otherwise the spin doubles and the run is repeated.
    ``fn`` must not synchronise."""
    spin = SPIN_CYCLES
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    while len(times) < runs:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        for _ in range(per_run):
            fn()
        b.record()
        hidden = not a.query()
        b.synchronize()
        if hidden:
            times.append(a.elapsed_time(b) / per_run)
        else:
            spin *= 2
            check(spin <= MAX_SPIN_CYCLES,
                  "host enqueue outlasts the longest device spin")
    return statistics.median(times)


def median_host_ms(fn, runs=TIMING_RUNS, sync=None):
    """Median host wall time of one call of ``fn`` (ms), ending in
    ``sync`` when given."""
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        if sync is not None:
            sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rotating(fns):
    """One callable cycling through ``fns`` (operand copies whose sum
    exceeds L2, so every timed call finds its operands in device
    memory, as the round engine does)."""
    state = {"i": 0}

    def call():
        fn = fns[state["i"] % len(fns)]
        state["i"] += 1
        return fn()
    return call


def np_leaf_loads(np, ps, mds32, C, L):
    """The reference's host prefix-sum of trainer loads (float64
    bincount, rounded to float32)."""
    P = ps.shape[0]
    p_off = np.arange(P)[:, None]
    unplaced = np.bincount((ps + C * p_off).ravel(),
                           minlength=P * C).reshape(P, C) == 0
    t_mds = np.where(unplaced, mds32[None], np.float32(0.0))
    leaf_of = (np.cumsum(unplaced, axis=1) - 1) % L
    return np.bincount((leaf_of + L * p_off).ravel(), weights=t_mds.ravel(),
                       minlength=P * L).reshape(P, L).astype(np.float32)


def recording(spec, envs):
    """``spec`` as a ScenarioSpec whose environments are kept in
    ``envs``, each recording every step's (placement, tpd, loss) in
    ``env.steps`` — how this script reads what ``run_experiment`` did."""
    base = type(spec)

    class Recorded(base):
        def make_environment(self, seed=0, eval_config=None, *,
                             device="cuda"):
            env = base.make_environment(self, seed, eval_config,
                                        device=device)
            env.steps = []
            step = env.step

            def recorded(r, placement):
                obs = step(r, placement)
                env.steps.append((obs.placement.tolist(), obs.tpd,
                                  obs.metrics["loss"]))
                return obs
            env.step = recorded
            envs.append(env)
            return env

    return Recorded(**{f.name: getattr(spec, f.name)
                       for f in dataclasses.fields(spec)})


# ---- the hybrid LM serving path: recurrentgemma-2b (phases 10-13) --------
RG_ARCH = "recurrentgemma-2b"
# 4 prompts of 1024 tokens (below the 2048 window: causal attention) and
# 4 of 4096 (windowed attention), 16 new tokens each, 4 to a wave
SERVE_PROMPTS = ((1024, 4), (4096, 4))
# 16 new tokens a request in every serving phase (32 were cut to 16 to
# make room for phase 28)
SERVE_NEW_TOKENS = 16
SERVE_MAX_BATCH = 4
# phase 11 serves one request of each wave alone (every request before
# phase 30)
SERVE_SERIAL = (0, 4)
DEPTH_CUT_LAYERS = 5            # one (r, r, a) triple and the two tails
DEPTH_CUT_PROMPT = 64
PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core rate
# the float32 rate the f32 flash kernels are held to: split TF32 runs
# three TF32 products per float32-accurate one, a third of the H100 SXM
# dense TF32 tensor-core rate (495 TFLOP/s)
PEAK_F32_FLOPS = 495e12 / 3
PEAK_F32_FMA_FLOPS = 67e12      # H100 SXM float32 outside the tensor cores
FLASH_SHAPE = (4, 10, 1, 256)   # serving B, Hq, Hkv, hd
# (S, window): the 1024-token wave (causal), the 4096-token wave
# (window 2048) and a ragged length
FLASH_CASES = ((1024, None), (4096, 2048), (4097, 2048))
# (B, S, window) timed on the bf16 route: both serving waves and the
# training shape; the kernels line reports the 4096-token wave, and the
# f32 route is timed at the 1024-token wave (reported) and the training
# shape
FLASH_TIMED = ((4, 1024, None), (4, 4096, 2048), (1, 2048, None))
FLASH_REPORTED = (4, 4096, 2048)
FLASH_F32_TIMED = (4, 1024, None)
FLASH_F32_TRAIN = (1, 2048, None)
# (B, T, D): a serving prefill's scan, then ragged T and D (the last on
# the cp.async route: 5,122-byte rows), then the training shape
RGLRU_CASES = (((4, 4096, 2560), "float32"), ((4, 1031, 2500), "float32"),
               ((3, 777, 2561), "bfloat16"), ((1, 2048, 2560), "float32"),
               ((1, 2048, 2560), "bfloat16"))
RGLRU_TRAIN_SHAPE = (1, 2048, 2560)
# flash at a head dim the sm90 kernels are not built for: stablelm-3b's
# (32 heads of 80; bf16 padded to 128, f32 native), B 2, S 1024 causal;
# and above what they take: hd 320 (both dtypes on the f32 kernels, two
# column blocks of 160) at recurrentgemma's MQA, B 1, S 1024 causal
FLASH_HD80 = (2, 32, 32, 1024, 80)
FLASH_HD320 = (1, 10, 1, 1024, 320)
# (B, Hq, Hkv, S, hd) bf16 causal: phases 22 and 24's prefill waves,
# checked against the plain version in phase 10: granite-8b's (GQA 32/8,
# hd 128) at 1024 and 4096 tokens, stablelm-3b's (hd 80, padded to 128),
# granite-moe-1b-a400m's (GQA 16/8, hd 64) and qwen3-moe-235b-a22b's
# (GQA 64/4, hd 128); the 1024-token waves are timed in phase 13; and
# granite-moe's training forward (phase 24 (g): B 1, S 2048)
FLASH_DENSE = ((4, 32, 8, 1024, 128), (4, 32, 8, 4096, 128),
               (4, 32, 32, 1024, 80), (4, 16, 8, 1024, 64),
               (4, 64, 4, 1024, 128), (1, 16, 8, 2048, 64))
FLASH_DENSE_TIMED = (FLASH_DENSE[0], FLASH_DENSE[2], FLASH_DENSE[3],
                     FLASH_DENSE[4])
# flash kernel vs the dense plain version: f32, online vs dense softmax
# over up to 2048 keys summed in other orders; bf16, one more rounding
# of the output (the reference's own kernel tests use 2e-5 and 2e-2)
FLASH_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# full-width logits (scale ~5): float32 differs only by the order of
# sums (card vs host, decode vs prefill products); bfloat16 rounds at
# other points along 26 layers (decode's 8-row products vs prefill's
# per-sequence ones, cuBLAS vs the host's bf16 GEMM)
LOGIT_TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
             "bfloat16": dict(rtol=0.05, atol=0.5)}


def flash_bound(b, hq, hkv, s, hd, window, elem_bytes, peak=None,
                causal=True):
    """(bound ms, flops, bytes) of one flash call, causal by default: 4
    hd flops per visible (query head, key) pair over ``peak``, by
    default the rate of the operands' type (bf16 tensor cores, or
    float32 in split TF32), and q, k, v read and the output written once
    over the memory rate. Without ``causal`` (and a window) every pair
    is visible: S^2, twice the causal count."""
    pairs = sum(min(i + 1, window or s) for i in range(s)) if causal \
        else s * s
    flops = 4 * b * hq * hd * pairs
    nbytes = elem_bytes * (2 * b * hq * s * hd + 2 * b * hkv * s * hd)
    peak = peak or (PEAK_BF16_FLOPS if elem_bytes == 2 else PEAK_F32_FLOPS)
    return max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3, flops, nbytes


def hybrid_phases(torch, np_, dev, card):
    """Phases 10-13; returns the flash and RG-LRU entries of the
    ``kernels`` line."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import SM90_SOURCE, SOURCE, flash_attention, head_route
    from repro_torch.kernels.ref import flash_attention_ref, rglru_scan_ref
    from repro_torch.kernels.rglru import plan_for, rglru_scan
    from repro_torch.models import get_model
    from repro_torch.models.common import DECODE_ROWS
    from repro_torch.serving import Request, WaveScheduler
    from repro_torch.utils.trees import tree_leaves, tree_map

    sync = torch.cuda.synchronize
    gen = torch.Generator(dev)
    B, HQ, HKV, HD = FLASH_SHAPE

    def qkv(s, dtype, seed, b=B, hq=HQ, hkv=HKV, hd=HD):
        gen.manual_seed(seed)
        return [torch.randn(shape, device=dev, generator=gen).to(dtype)
                for shape in ((b, hq, s, hd), (b, hkv, s, hd),
                              (b, hkv, s, hd))]

    # ---- 10. kernels vs plain versions at the serving shapes ----------
    phase(f"10. flash attention and RG-LRU kernels vs their plain torch "
          f"versions at {RG_ARCH}'s serving shapes")
    flash_err = {"bfloat16": 0.0, "float32": 0.0}
    routes = {"bfloat16": SM90_SOURCE.stem, "float32": SOURCE.stem}
    for s, window in FLASH_CASES:
        for name, dtype in (("bfloat16", torch.bfloat16),
                            ("float32", torch.float32)):
            q, k, v = qkv(s, dtype, s)
            before = dict(flash_attention.routes)
            got = flash_attention(q, k, v, causal=True, window=window)
            sync()
            went = {r: n - before.get(r, 0)
                    for r, n in flash_attention.routes.items()
                    if n != before.get(r, 0)}
            check(went == {routes[name]: 1}, f"flash {name} launched {went}")
            want = flash_attention_ref(q, k, v, causal=True, window=window)
            err = float((got.float() - want.float()).abs().max())
            flash_err[name] = max(flash_err[name], err)
            check(torch.allclose(got.float(), want.float(), **FLASH_TOL[name]),
                  f"flash S={s} window={window} {name}: kernel vs plain "
                  f"max abs err {err} beyond {FLASH_TOL[name]}")
            print(f"flash (B, Hq, Hkv, hd) = {FLASH_SHAPE} S={s:5d} "
                  f"window={window} {name:8s}: {routes[name]}.cu, max abs "
                  f"err {err:.3e} ({FLASH_TOL[name]})")
            del q, k, v, got, want
    def held(shape, name, dtype, seed):
        """One causal flash call at ``shape`` (B, Hq, Hkv, S, hd) on the
        route ``head_route`` gives, against the plain version (one batch
        row at a time: the dense scores of S 4096 at 32 heads are 8.6 GB
        a row) at FLASH_TOL."""
        b8, hq8, hkv8, s8, hd8 = shape
        gen.manual_seed(seed)
        q, k, v = [torch.randn(sh, device=dev, generator=gen).to(dtype)
                   for sh in ((b8, hq8, s8, hd8), (b8, hkv8, s8, hd8),
                              (b8, hkv8, s8, hd8))]
        before = dict(flash_attention.routes)
        got = flash_attention(q, k, v, causal=True)
        sync()
        went = {r: n - before.get(r, 0)
                for r, n in flash_attention.routes.items()
                if n != before.get(r, 0)}
        route, width = head_route(hd8, dtype)
        source = SOURCE.stem if route == "f32" else SM90_SOURCE.stem
        check(went == {source: 1}, f"flash {shape} {name} launched {went}")
        want = torch.cat([flash_attention_ref(q[i:i + 1], k[i:i + 1],
                                              v[i:i + 1], causal=True)
                          for i in range(b8)])
        err = float((got.float() - want.float()).abs().max())
        flash_err[name] = max(flash_err[name], err)
        check(got.shape == q.shape and got.dtype == dtype and torch.allclose(
            got.float(), want.float(), **FLASH_TOL[name]),
            f"flash {shape} {name}: kernel vs plain max abs err {err} "
            f"beyond {FLASH_TOL[name]}")
        print(f"flash (B, Hq, Hkv, hd) = {(b8, hq8, hkv8, hd8)} S={s8} causal "
              f"{name:8s}: {source}.cu at width {width}, max abs err "
              f"{err:.3e} ({FLASH_TOL[name]})")

    for shape, (name, dtype) in itertools.product(
            (FLASH_HD80, FLASH_HD320), (("bfloat16", torch.bfloat16),
                                        ("float32", torch.float32))):
        held(shape, name, dtype, shape[4])
    for shape in FLASH_DENSE:
        held(shape, "bfloat16", torch.bfloat16, shape[3] + shape[4])
    rglru_err = 0.0
    scan_routes = dict(rglru_scan.routes)
    for shape, name in RGLRU_CASES:
        dtype = getattr(torch, name)
        gen.manual_seed(shape[1])
        a = torch.rand(shape, device=dev, generator=gen).mul_(0.2).add_(0.8)
        u = torch.randn(shape, device=dev, generator=gen)
        a, u = a.to(dtype), u.to(dtype)
        got = rglru_scan(a, u)
        sync()
        want = rglru_scan_ref(a, u)
        err = float((got.float() - want.float()).abs().max())
        rglru_err = max(rglru_err, err)
        check(torch.equal(got, want), f"RG-LRU {shape} {name}: kernel != "
                                      f"plain version (max abs err {err})")
        print(f"RG-LRU scan {shape} {name:8s} ({plan_for((a, u))}): exact "
              f"(atol 0)")
        del a, u, got, want
    went = {r: n - scan_routes.get(r, 0) for r, n in rglru_scan.routes.items()}
    check(all(went.get(r, 0) > 0 for r in ("tma", "cp_async")),
          f"RG-LRU scan routes launched {went}: both must be")
    print(f"RG-LRU scan launches per copy route: {json.dumps(went)}")

    # ---- 11. full-width serving through the wave scheduler -------------
    phase(f"11. full-width {RG_ARCH} serving on cuda: WaveScheduler("
          f"max_batch={SERVE_MAX_BATCH}), {sum(n for _, n in SERVE_PROMPTS)}"
          f" requests, {SERVE_NEW_TOKENS} new tokens each")
    cfg = get_config(RG_ARCH)
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(SEED), dev)
    sync()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(3.5e9 < n_params < 3.6e9, f"{RG_ARCH} holds {n_params} params")
    n_triples = cfg.n_layers // 3
    n_rec = cfg.n_layers - n_triples
    print(f"{RG_ARCH}: {cfg.n_layers} layers ({n_triples} triples + "
          f"{cfg.n_layers - 3 * n_triples} tails), d {cfg.d_model}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, window "
          f"{cfg.local_attn_window}; {n_params} f32 params "
          f"({n_params * 4 / 1e9:.2f} GB) drawn on the card in "
          f"{init_s:.2f} s; compute dtype {cfg.dtype}")
    rng = np_.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, plen).astype(np_.int32)
               for plen, n in SERVE_PROMPTS for _ in range(n)]
    reqs = [Request(rid=i, tokens=t, max_new_tokens=SERVE_NEW_TOKENS)
            for i, t in enumerate(prompts)]
    sched = WaveScheduler(model, params, max_batch=SERVE_MAX_BATCH)
    for r in reqs:
        sched.submit(r)
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0     # the counts to 0 just before the path
    flash_attention.routes.clear()
    rglru_scan.launches = 0
    rglru_scan.routes.clear()
    t0 = time.perf_counter()
    served = sched.run()
    sync()
    serve_s = time.perf_counter() - t0
    launches_flash = flash_attention.launches    # read just after
    served_routes = dict(flash_attention.routes)
    launches_rglru = rglru_scan.launches
    scan_routes = dict(rglru_scan.routes)
    check(served_routes == {SM90_SOURCE.stem: launches_flash},
          f"bf16 serving launched the flash routes {served_routes}")
    check(scan_routes == {"tma": launches_rglru},
          f"serving launched the RG-LRU scan routes {scan_routes}")
    waves = len(sched.stats)
    check(waves == len(SERVE_PROMPTS), f"{waves} waves")
    check(launches_flash == n_triples * waves
          and launches_rglru == n_rec * waves,
          f"{launches_flash} flash / {launches_rglru} RG-LRU launches, "
          f"expected {n_triples} / {n_rec} per prefill x {waves} prefills")
    print(f"{launches_flash} flash_attention launches = {n_triples} per "
          f"prefill x {waves} waves; {launches_rglru} rglru_scan launches "
          f"= {n_rec} per prefill x {waves} (decode steps launch neither); "
          f"RG-LRU launches per copy route {json.dumps(scan_routes)}")
    for st in sched.stats:
        dec_ms = (st.wall_s - st.ttft_s) / max(st.steps - 1, 1) * 1e3
        print(f"wave {st.wave}: {st.batch} x {st.prompt_len} tokens: "
              f"prefill {st.ttft_s * 1e3:.1f} ms (until the first tokens are"
              f" on the host), decode {dec_ms:.2f} ms per token over "
              f"{st.steps - 1} steps, wave {st.wall_s:.3f} s (host clock) "
              f"[{card}]")
    print(f"summary() {json.dumps(sched.summary())}; whole run "
          f"{serve_s:.3f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for r in served:
        check(r.output is not None and len(r.output) == SERVE_NEW_TOKENS
              and bool(np_.all((r.output >= 0)
                               & (r.output < cfg.vocab_size))),
              f"request {r.rid}: malformed output {r.output}")
    mismatched = []
    for r in (r for r in reqs if r.rid in SERVE_SERIAL):
        one = WaveScheduler(model, params, max_batch=1)
        alone = Request(rid=r.rid, tokens=r.tokens,
                        max_new_tokens=SERVE_NEW_TOKENS)
        one.submit(alone)
        one.run()
        same = np_.array_equal(alone.output, r.output)
        where = "" if same else (f" from token "
                                 f"{int(np_.argmax(alone.output != r.output))}")
        if not same:
            mismatched.append(r.rid)
        print(f"request {r.rid} ({len(r.tokens)} tokens): batched output "
              f"{'equals' if same else 'differs from'} its batch-1 serial "
              f"decode{where}; first tokens {r.output[:6].tolist()}")
    check(not mismatched, f"requests {mismatched}: batched != serial")

    # where a decode step goes (the 1024-token wave's shape)
    wave0 = torch.as_tensor(np_.stack(prompts[:SERVE_MAX_BATCH])).to(dev)
    logits, state = model.prefill_fn(params, {"tokens": wave0})
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    sync()
    enq, step, host = [], [], []
    for _ in range(5):
        t0 = time.perf_counter()
        logits, state = model.decode_fn(params, state, {"token": tok[:, None]})
        t1 = time.perf_counter()
        sync()
        t2 = time.perf_counter()
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        tok.cpu().numpy()
        host.append((time.perf_counter() - t2) * 1e3)
        enq.append((t1 - t0) * 1e3)
        step.append((t2 - t0) * 1e3)
    print(f"decode step, batch {SERVE_MAX_BATCH} after {len(prompts[0])} "
          f"tokens: "
          f"{statistics.median(step):.2f} ms synchronised, of which the host"
          f" spends {statistics.median(enq):.2f} ms issuing it; argmax + "
          f"token to the host {statistics.median(host):.3f} ms (host clock, "
          f"medians of 5) [{card}]")
    del state, logits

    # why the model fixes its shapes: does a row's result depend on the
    # rows beside it? Each product and reduction of a decode step at
    # M = 1 vs M = 4, and of a prefill at one sequence vs four (printed,
    # not checked)
    gen.manual_seed(11)
    hd, win = cfg.resolved_head_dim, cfg.local_attn_window

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, device=dev, generator=gen).to(dtype)

    def gap(fn, x, n):
        return float((fn(x[:n]) - fn(x)[:n]).float().abs().max())

    probes = []
    for name, k_in, n_out, dtype in (
            ("bf16 d x d", cfg.d_model, cfg.d_model, torch.bfloat16),
            ("bf16 d x kv", cfg.d_model, cfg.n_kv_heads * hd, torch.bfloat16),
            ("f32 d x d", cfg.d_model, cfg.d_model, torch.float32),
            ("f32 d x d_ff", cfg.d_model, cfg.d_ff, torch.float32),
            ("f32 d_ff x d", cfg.d_ff, cfg.d_model, torch.float32),
            ("f32 d x vocab", cfg.d_model, cfg.padded_vocab, torch.float32)):
        w = rand(k_in, n_out, dtype=dtype)
        x = rand(4 * len(prompts[0]), k_in, dtype=dtype)
        dec = gap(lambda z, w=w: z @ w, x[:4], 1)
        pre = "-" if n_out == cfg.padded_vocab else \
            f"{gap(lambda z, w=w: z @ w, x, len(prompts[0])):.1e}"
        probes.append(f"{name} {dec:.1e}/{pre}")
        del w, x
    q, kc = rand(4, 1, cfg.n_heads, hd), rand(4, 1, hd, win)
    probes.append(f"decode scores bmm {gap(lambda z: z @ kc[:len(z)], q, 1):.1e}")
    sc = rand(4, 1, cfg.n_heads, win)
    probes.append(f"softmax {gap(lambda z: torch.softmax(z, -1), sc, 1):.1e}")
    x = rand(4 * len(prompts[0]), cfg.d_model)
    ms = lambda z: z.square().mean(-1)   # noqa: E731
    probes.append(f"mean square {gap(ms, x[:4], 1):.1e}/"
                  f"{gap(ms, x, len(prompts[0])):.1e}")
    print(f"a row alone vs beside others, max |diff| (decode M = 1 vs 4 / "
          f"prefill {len(prompts[0])} vs {4 * len(prompts[0])} rows): "
          f"{'; '.join(probes)} [{card}] (decode pads to {DECODE_ROWS} "
          f"rows, prefill multiplies per sequence)")
    del q, kc, sc, x

    # prefill(t[:n]) + decode(t[n]) == prefill(t[:n + 1]) for the longest
    # prompt (n = 4096: windowed attention, a ragged 4097-token prefill)
    longer_prompt = np_.concatenate(
        [prompts[-1], rng.integers(0, cfg.vocab_size, 1).astype(np_.int32)])
    t = torch.as_tensor(longer_prompt[None]).to(dev)
    for name in ("bfloat16", "float32"):
        m = get_model(cfg.replace(dtype=name))
        longer, _ = m.prefill_fn(params, {"tokens": t})
        _, st = m.prefill_fn(params, {"tokens": t[:, :-1]})
        stepped, _ = m.decode_fn(params, st, {"token": t[:, -1:]})
        a, b = stepped[:, -1].float(), longer[:, -1].float()
        err = float((a - b).abs().max())
        check(bool(torch.isfinite(a).all()) and
              torch.allclose(a, b, **LOGIT_TOL[name]),
              f"{name}: prefill + decode differs from the longer prefill by "
              f"{err} beyond {LOGIT_TOL[name]}")
        print(f"{name:8s}: prefill({t.shape[1] - 1}) + decode vs prefill("
              f"{t.shape[1]}) at full width: max |logit diff| {err:.3e} (logit scale "
              f"{float(b.abs().max()):.2f}; {LOGIT_TOL[name]}); argmax "
              f"{'agrees' if int(a.argmax()) == int(b.argmax()) else 'differs'}")
        del m, longer, st, stepped

    # ---- 12. depth cut: cuda against the CPU ----------------------------
    phase(f"12. depth cut: full width, {DEPTH_CUT_LAYERS} layers (one triple "
          f"+ two tails), cuda vs cpu (plain versions), a "
          f"{DEPTH_CUT_PROMPT}-token prompt")
    cut = cfg.replace(n_layers=DEPTH_CUT_LAYERS)
    p_cut = dict(params, triples=tree_map(lambda x: x[:1], params["triples"]))
    p_cpu = tree_map(lambda x: x.cpu(), p_cut)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (2, DEPTH_CUT_PROMPT + 1)),
                           dtype=torch.int32)
    cut_launches = {}
    for name in ("float32", "bfloat16"):
        m = get_model(cut.replace(dtype=name))
        out = {}
        for where, p in (("cuda", p_cut), ("cpu", p_cpu)):
            d = dev if where == "cuda" else torch.device("cpu")
            flash_attention.routes.clear()   # counts to 0 before the path
            logits, st = m.prefill_fn(p, {"tokens": toks[:, :-1].to(d)})
            step_l, _ = m.decode_fn(p, st, {"token": toks[:, -1:].to(d)})
            if where == "cuda":
                sync()
                cut_launches[name] = dict(flash_attention.routes)
                check(cut_launches[name] == {routes[name]: 1},
                      f"depth cut {name}: flash launches "
                      f"{cut_launches[name]}, expected {routes[name]}: 1")
            out[where] = (logits.float().cpu(), step_l.float().cpu(),
                          st["triples"]["rec2"]["h"].cpu())
        for what, a, b in zip(("prefill logits", "decode logits",
                               "rec2 state"), out["cuda"], out["cpu"],
                              strict=True):
            err = float((a - b).abs().max())
            check(torch.allclose(a, b, **LOGIT_TOL[name]),
                  f"depth cut {name} {what}: cuda vs cpu {err} beyond "
                  f"{LOGIT_TOL[name]}")
            print(f"{name:8s} {what:14s}: cuda vs cpu max abs diff "
                  f"{err:.3e} ({LOGIT_TOL[name]})")
    print(f"flash launches over each depth cut's prefill + decode on cuda: "
          f"{json.dumps(cut_launches)}")
    del p_cpu, p_cut, params

    # ---- 13. timings -----------------------------------------------------
    phase(f"13. flash attention and RG-LRU timings on {card}")

    def time_flash(b, s, window, dtype, seed, hq=HQ, hkv=HKV, hd=HD):
        """(kernel, plain, bound, SDPA) device ms of one flash call; the
        wrapper call's time, TFLOP/s and SDPA's difference printed (for
        f32, the scalar-FMA bound too)."""
        q, k, v = qkv(s, dtype, seed, b, hq, hkv, hd)
        kk = k.repeat_interleave(hq // hkv, dim=1)
        vv = v.repeat_interleave(hq // hkv, dim=1)
        i = torch.arange(s, device=dev)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window) \
            if window else None
        k_ms = median_device_ms(torch, lambda: flash_attention(
            q, k, v, causal=True, window=window), runs=9, per_run=5)
        call_ms = median_event_ms(torch, lambda: flash_attention(
            q, k, v, causal=True, window=window), runs=9, per_run=5)
        plain_ms = median_device_ms(torch, lambda: flash_attention_ref(
            q, k, v, causal=True, window=window), runs=5, per_run=1)
        if window:
            def sdpa():
                return F.scaled_dot_product_attention(q, kk, vv,
                                                      attn_mask=mask)
        else:
            def sdpa():
                return F.scaled_dot_product_attention(q, kk, vv,
                                                      is_causal=True)
        lib_ms = median_device_ms(torch, sdpa, runs=9, per_run=5)
        lib_err = float((sdpa().float() - flash_attention(
            q, k, v, causal=True, window=window).float()).abs().max())
        size = q.element_size()
        b_ms, flops, nbytes = flash_bound(b, hq, hkv, s, hd, window, size)
        route, width = head_route(hd, dtype)
        if size == 2:
            peak = "989 TFLOP/s bf16"
        else:
            fma_ms = flash_bound(b, hq, hkv, s, hd, window, size,
                                 PEAK_F32_FMA_FLOPS)[0]
            peak = (f"165 TFLOP/s f32 in split TF32; scalar-FMA bound "
                    f"{fma_ms:.4f} ms at 67 TFLOP/s")
        source = (SOURCE if route == "f32" else SM90_SOURCE).stem
        print(f"flash {dtype} (B, Hq, Hkv, hd) = {(b, hq, hkv, hd)} S={s} "
              f"window={window} ({source}.cu at width {width}): device time "
              f"per call: kernel {k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} "
              f"TFLOP/s, {b_ms / k_ms * 100:.1f}% of the bound), plain "
              f"torch {plain_ms:.3f} ms, SDPA {lib_ms:.4f} ms (differs from"
              f" the kernel by {lib_err:.2e}); wrapper call {call_ms:.4f} "
              f"ms; bound {b_ms:.4f} ms ({flops:.3e} flops / {peak}; "
              f"{nbytes} B / 3.35 TB/s: "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms) [{card}]")
        return k_ms, plain_ms, b_ms, lib_ms

    timed = {case: time_flash(*case, torch.bfloat16, 100 + case[1])
             for case in FLASH_TIMED}
    f32_timed = time_flash(*FLASH_F32_TIMED, torch.float32, 7)
    time_flash(*FLASH_F32_TRAIN, torch.float32, 8)
    b8, hq8, hkv8, s8, hd8 = FLASH_HD80
    for dtype in (torch.bfloat16, torch.float32):
        time_flash(b8, s8, None, dtype, 9, hq8, hkv8, hd8)
    for i, (b_, hq_, hkv_, s_, hd_) in enumerate(FLASH_DENSE_TIMED):
        time_flash(b_, s_, None, torch.bfloat16, 20 + i, hq_, hkv_, hd_)
    def time_scan(shape, seed):
        """(kernel, plain, bound) ms of one f32 scan at ``shape``, the
        wrapper call's time printed; at the serving shape also the
        cp.async route and the copy to aligned tensors that would avoid
        it, printed."""
        gen.manual_seed(seed)
        a = torch.rand(shape, device=dev, generator=gen).mul_(0.2).add_(0.8)
        u = torch.randn(shape, device=dev, generator=gen)
        ms = median_device_ms(torch, lambda: rglru_scan(a, u))
        call = median_event_ms(torch, lambda: rglru_scan(a, u))
        # one call per run: the plain version queues 3 launches per time
        # step (12,288 at T = 4096), past the device's queue of pending
        # launches, so its time includes the host's enqueue
        plain = median_event_ms(torch, lambda: rglru_scan_ref(a, u), runs=5,
                                per_run=1)
        nbytes = 3 * a.numel() * 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"RG-LRU f32 {shape} ({plan_for((a, u))}): kernel "
              f"{ms * 1e3:.1f} us on the device ({bound / ms * 100:.1f}% of "
              f"the bound), wrapper call {call * 1e3:.1f} us; plain torch "
              f"{plain:.2f} ms per call (host enqueue included); bound "
              f"{bound * 1e3:.1f} us ({nbytes} B / 3.35 TB/s) [{card}]")
        if shape == RGLRU_CASES[0][0]:
            # the same operands one element past an aligned base: the
            # cp.async route, against copying them to fresh (aligned)
            # tensors and taking the TMA route
            am, um = (torch.empty(x.numel() + 1, device=dev)[1:].view(shape)
                      .copy_(x) for x in (a, u))
            check(plan_for((am, um)).route == "cp_async"
                  and torch.equal(rglru_scan(am, um), rglru_scan(a, u)),
                  "RG-LRU misaligned operands: not the cp.async route, or "
                  "not equal to the TMA route's result")
            cp_ms = median_device_ms(torch, lambda: rglru_scan(am, um))
            copy_ms = median_device_ms(
                torch, lambda: rglru_scan(am.clone(), um.clone()))
            print(f"RG-LRU f32 {shape} one element past an aligned base: "
                  f"cp.async route {cp_ms * 1e3:.1f} us on the device "
                  f"({bound / cp_ms * 100:.1f}% of the bound); copied to "
                  f"aligned tensors, then the TMA route {copy_ms * 1e3:.1f} "
                  f"us [{card}]")
            del am, um
        return ms, plain, bound

    scan_timed = {shape: time_scan(shape, 5 + i)
                  for i, shape in enumerate((RGLRU_CASES[0][0],
                                             RGLRU_TRAIN_SHAPE))}
    r_ms, rp_ms, rb_ms = scan_timed[RGLRU_CASES[0][0]]
    t_ms, _, tb_ms = scan_timed[RGLRU_TRAIN_SHAPE]
    k_ms, plain_ms, b_ms, lib_ms = timed[FLASH_REPORTED]
    f_ms, fplain_ms, fb_ms, flib_ms = f32_timed
    return [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention.py:39",
         "note": "bf16 operands: wgmma + TMA",
         "launches": served_routes[SM90_SOURCE.stem],
         "max_abs_err": flash_err["bfloat16"],
         "ms": k_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
         "bound_by": "operations", "library_ms": lib_ms},
        {"name": "flash_attention_f32", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:39",
         "note": "float32 operands (and bf16 above hd 256): split TF32 on "
                 "mma.sync; launches over phase 12's float32 depth cut; "
                 "bound_ms at 165 TFLOP/s (a third of dense TF32)",
         "launches": cut_launches["float32"][SOURCE.stem],
         "max_abs_err": flash_err["float32"],
         "ms": f_ms, "plain_ms": fplain_ms, "bound_ms": fb_ms,
         "bound_by": "operations", "library_ms": flib_ms},
        {"name": "rglru_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/rglru.cu",
         "replaces": "src/repro/kernels/rglru.py:58",
         "note": f"times at the serving shape {RGLRU_CASES[0][0]}; at the "
                 f"training shape {RGLRU_TRAIN_SHAPE} {t_ms} ms against a "
                 f"{tb_ms} ms bound",
         "launches": launches_rglru, "max_abs_err": rglru_err,
         "ms": r_ms, "plain_ms": rp_ms, "bound_ms": rb_ms,
         "bound_by": "bytes", "library_ms": None},
    ]


# ---- the training path: recurrentgemma-2b (phases 14-17) -----------------
TRAIN_STEPS = 8
TRAIN_TOKENS = 2048             # = the window: the causal attention path
TRAIN_PEAK_LR, TRAIN_WARMUP = 3e-4, 2
ADAMW_NS = (1, 3, 4097, 2 ** 24 + 5)
ADAMW_WINDOW = 2 ** 20          # elements checked past 2^31 in phase 15
ADAMW_WINDOW_START = 2 ** 31 + 5
PLAIN_CHUNK = 2 ** 28           # the plain AdamW's chunk (its temporaries)
# flash backward cases (B, Hq, Hkv, S, hd, window): the training shape
# (causal: S = the window), the windowed path, and granite-moe's
# training shape (phase 24 (g): GQA 16/8, hd 64)
FLASH_BWD_CASES = ((1, 10, 1, 2048, 256, None), (1, 10, 1, 4096, 256, 2048),
                   (1, 16, 8, 2048, 64, None))
# kernel vs autograd of the dense plain version, max abs error over each
# gradient's largest value: f32 sums in other orders and P recomputed
# from the saved log-sum-exp; bf16 one more rounding of each gradient
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
RGLRU_BWD_CASES = (((1, 2048, 2560), "float32"), ((2, 1031, 2500), "float32"),
                   ((3, 777, 2561), "bfloat16"))
# one step since phase 30 (two took 34.8 and 35.8 s of host training on
# an H100 80GB HBM3 host at 700 W)
TRAIN_CUT_TOKENS, TRAIN_CUT_STEPS = 128, 1
# depth cut, cuda vs cpu: losses (f32: sums in other orders; bf16:
# roundings at other points over 5 blocks); params: Adam moves a weight
# whose gradient is within rounding of 0 by +-lr, so elementwise
# agreement holds for all but a few (tests/test_torch_train.py); the
# whole update is held in norm. The bf16 step is plain SGD since phase
# 30 (the host's AdamW over 1.74e9 params took most of its time): its
# update is the gradient, so the norm check reads the gradient itself
CUT_LOSS_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
CUT_OUTSIDE = {"float32": 2e-3}          # share outside rtol 1e-3/atol 1e-5
CUT_UPDATE_RTOL = {"float32": 3e-2, "bfloat16": 0.1}
CUT_SGD_LR = 1.0                         # lr x g: far above f32 rounding


def adamw_scalars(np_, step, b1=0.9, b2=0.95):
    """(bc1, bc2) as ``optim.adamw`` forms them on the host."""
    t = np_.float32(step)
    return (np_.float32(1) - np_.float32(b1) ** t,
            np_.float32(1) - np_.float32(b2) ** t)


def flash_bwd_bound(b, hq, hkv, s, hd, window, elem_bytes, peak=None,
                    causal=True):
    """(bound ms, flops, bytes) of one flash backward: 10 hd flops per
    visible (query head, key) pair over ``peak``, by default the rate of
    the operands' type, as :func:`flash_bound` (``causal`` too); q, k,
    v, o, do and lse read and dq, dk, dv written once over the memory
    rate."""
    pairs = sum(min(i + 1, window or s) for i in range(s)) if causal \
        else s * s
    flops = 10 * b * hq * hd * pairs
    nbytes = elem_bytes * (5 * b * hq * s * hd + 2 * b * hkv * s * hd) \
        + 4 * b * hq * s
    peak = peak or (PEAK_BF16_FLOPS if elem_bytes == 2 else PEAK_F32_FLOPS)
    return max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3, flops, nbytes


PROFILE_GROUPS = (("flash forward", ("flash_fwd",)),
                  ("flash backward", ("flash_bwd",)),
                  ("RG-LRU adjoint", ("rglru_scan_bwd",)),
                  ("RG-LRU forward", ("rglru_scan_kernel",)),
                  ("fused AdamW", ("adamw_",)),
                  ("matrix products", ("gemm", "xmma", "cutlass", "cublas")))


def step_profile(torch, loop, batch, card):
    """One more training step under ``torch.profiler``: device time by
    kernel group and the device's busy share of the step's wall time
    (one stream, so the kernels do not overlap). Printed, not checked."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = {k: torch.as_tensor(v).to(loop.device) for k, v in batch.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop.params, loop.opt_state, _ = loop.step_fn(
            loop.params, loop.opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0.0)

    total = sum(dev_us(e) for e in kernels) / 1e3
    if total <= 0:
        print(f"profiled step {wall_ms:.1f} ms: the trace holds no device "
              f"time [{card}]")
        return
    groups = {name: 0.0 for name, _ in PROFILE_GROUPS}
    launches = {name: 0 for name, _ in PROFILE_GROUPS}
    other = 0.0
    for e in kernels:
        key = e.key.lower()
        for name, subs in PROFILE_GROUPS:
            if any(sub in key for sub in subs):
                groups[name] += dev_us(e) / 1e3
                launches[name] += e.count
                break
        else:
            other += dev_us(e) / 1e3
    split = "; ".join(f"{k} {v:.1f} ms ({launches[k]} launches)"
                      for k, v in groups.items())
    print(f"profiled step (host clock {wall_ms:.1f} ms, under the profiler): "
          f"device busy {total:.1f} ms ({total / wall_ms * 100:.1f}%, idle "
          f"{100 - total / wall_ms * 100:.1f}%): {split}; everything else "
          f"(elementwise, reductions, copies) {other:.1f} ms [{card}]")
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    print("top kernels by device time: " + "; ".join(
        f"{e.key[:60]} {dev_us(e) / 1e3:.1f} ms x{e.count}" for e in top))


def training_phases(torch, np_, dev, card):
    """Phases 14-17; returns the fused AdamW, flash backward and RG-LRU
    adjoint entries of the ``kernels`` line."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import fused_adamw as kadamw
    from repro_torch.kernels import rglru as krglru
    from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref, fused_adamw_ref, rglru_scan_bwd_ref
    from repro_torch.models import get_model
    from repro_torch.models.api import flat_params, make_train_step
    from repro_torch.optim import Optimizer, adamw, sgd, warmup_cosine_schedule
    from repro_torch.train import TrainLoop, TrainLoopConfig
    from repro_torch.utils.trees import flat_buffer_of, tree_map

    sync = torch.cuda.synchronize
    gen = torch.Generator(dev)

    # ---- 14. the new kernels vs their plain versions ------------------------
    phase("14. fused AdamW, flash backward and RG-LRU adjoint vs their "
          "plain torch versions on the card")
    for n in ADAMW_NS:
        for name, dtype in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            for step in (1, 1000):
                gen.manual_seed(n + step)
                p = torch.randn(n, device=dev, generator=gen).to(dtype)
                g = (torch.randn(n, device=dev, generator=gen) * 1e-2).to(dtype)
                m = torch.randn(n, device=dev, generator=gen) * 1e-3
                v = (torch.randn(n, device=dev, generator=gen) * 3e-3) ** 2
                scal = (np_.float32(3e-4), *adamw_scalars(np_, step))
                want = fused_adamw_ref(p, g, m, v, *scal)
                kadamw.fused_adamw(p, g, m, v, *scal)
                sync()
                same = all(torch.equal(a, b) for a, b in zip((p, m, v), want))
                check(same, f"fused AdamW N={n} {name} step {step}: kernel "
                            f"!= plain version")
        print(f"fused AdamW N={n:>9}: float32 and bfloat16 params, steps 1 "
              f"and 1000: bit-equal to the plain version")
    flash_bwd_err = {"bfloat16": 0.0, "float32": 0.0}
    bwd_routes = {"bfloat16": (kflash.BWD_SM90_SOURCE.stem, 3),
                  "float32": (kflash.BWD_SOURCE.stem, 3)}
    for b, hq, hkv, s, hd, window in FLASH_BWD_CASES:
        for name, dtype in (("bfloat16", torch.bfloat16),
                            ("float32", torch.float32)):
            gen.manual_seed(s + hd)
            q, k, v, do = [torch.randn(sh, device=dev, generator=gen).to(dtype)
                           for sh in ((b, hq, s, hd), (b, hkv, s, hd),
                                      (b, hkv, s, hd), (b, hq, s, hd))]
            grads = []
            before = dict(kflash.flash_attention_bwd.routes)
            # the kernel twice (bit-equal runs), then the plain version
            for fn in (kflash.flash_attention, kflash.flash_attention,
                       flash_attention_ref):
                leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                fn(*leaves, causal=True, window=window).backward(do)
                grads.append([t.grad for t in leaves])
            sync()
            went = {r: n - before.get(r, 0)
                    for r, n in kflash.flash_attention_bwd.routes.items()
                    if n != before.get(r, 0)}
            route, passes = bwd_routes[name]
            check(went == {route: 2 * passes},
                  f"flash backward {name} launched {went}")
            check(all(torch.equal(a, c) for a, c in zip(grads[0], grads[1])),
                  f"flash backward S={s} {name}: two runs differ")
            worst = 0.0
            for got, want in zip(grads[0], grads[2]):
                err = float((got.float() - want.float()).abs().max())
                flash_bwd_err[name] = max(flash_bwd_err[name], err)
                worst = max(worst, err / float(want.float().abs().max()))
            check(worst <= FLASH_BWD_TOL[name],
                  f"flash backward S={s} window={window} {name}: kernel vs "
                  f"plain autograd {worst} of the gradients' scale, beyond "
                  f"{FLASH_BWD_TOL[name]}")
            print(f"flash backward (B, Hq, Hkv, hd) = {(b, hq, hkv, hd)} S={s}"
                  f" window={window} {name:8s} ({route}.cu, {passes} "
                  f"launches): dq, dk, dv within {worst:.2e} of the "
                  f"gradients' scale ({FLASH_BWD_TOL[name]}); two runs "
                  f"bit-equal")
            del q, k, v, do, grads
    rglru_bwd_err = 0.0
    adj_routes = dict(krglru.rglru_scan_bwd.routes)
    for shape, name in RGLRU_BWD_CASES:
        dtype = getattr(torch, name)
        gen.manual_seed(shape[1] + 3)
        a = torch.rand(shape, device=dev, generator=gen).mul_(0.2).add_(0.8)
        h = torch.randn(shape, device=dev, generator=gen)
        dh = torch.randn(shape, device=dev, generator=gen)
        a, h, dh = a.to(dtype), h.to(dtype), dh.to(dtype)
        got = krglru.rglru_scan_bwd(a, h, dh)
        sync()
        want = rglru_scan_bwd_ref(a, h, dh)
        for x, y in zip(got, want):
            rglru_bwd_err = max(rglru_bwd_err, float((x.float() - y.float())
                                                     .abs().max()))
            check(torch.equal(x, y), f"RG-LRU adjoint {shape} {name}: kernel "
                                     f"!= plain version")
        print(f"RG-LRU adjoint {shape} {name:8s} "
              f"({krglru.plan_for((a, h, dh))}): exact (atol 0)")
        del a, h, dh, got, want
    went = {r: n - adj_routes.get(r, 0)
            for r, n in krglru.rglru_scan_bwd.routes.items()}
    check(all(went.get(r, 0) > 0 for r in ("tma", "cp_async")),
          f"RG-LRU adjoint routes launched {went}: both must be")
    print(f"RG-LRU adjoint launches per copy route: {json.dumps(went)}")

    # ---- 15. full-width training ----------------------------------------
    cfg = get_config(RG_ARCH)
    check(cfg.remat, f"{RG_ARCH}'s config has remat off")
    phase(f"15. full-width {RG_ARCH} training on cuda: TrainLoop, "
          f"{TRAIN_STEPS} steps of 1 x {TRAIN_TOKENS} tokens, "
          f"adamw(warmup_cosine_schedule({TRAIN_PEAK_LR}, {TRAIN_WARMUP}, "
          f"{TRAIN_STEPS})), remat on")
    model = get_model(cfg)
    ds = SyntheticLMDataset(cfg.vocab_size, TRAIN_TOKENS, seed=SEED)
    stamps = []

    def batch_fn(step):
        sync()
        stamps.append(time.perf_counter())
        return ds.batch(1, step)

    sched = warmup_cosine_schedule(TRAIN_PEAK_LR, TRAIN_WARMUP, TRAIN_STEPS)
    inner = adamw(sched)
    window_check = {}

    def update(params, grads, state):
        """adamw's update; on the last step, a window of p, g, m and v past
        element 2^31 is held to the plain version."""
        step = int(state.step) + 1
        if step != TRAIN_STEPS:
            return inner.update(params, grads, state)
        flat_p = flat_buffer_of(params)
        win = slice(ADAMW_WINDOW_START, ADAMW_WINDOW_START + ADAMW_WINDOW)
        check(flat_p.numel() >= win.stop, f"{flat_p.numel()} params")
        before = [flat_buffer_of(t)[win].clone()
                  for t in (params, state.mu, state.nu)]
        params, state = inner.update(params, grads, state)
        g = flat_buffer_of(grads)[win].clone()      # as clipped in place
        want = fused_adamw_ref(before[0], g, before[1], before[2],
                               sched(step), *adamw_scalars(np_, step))
        got = [flat_buffer_of(t)[win] for t in (params, state.mu, state.nu)]
        window_check["same"] = all(torch.equal(a, b) for a, b in zip(got, want))
        # the schedule's last lr is 0: p stays, the moments move
        window_check["moved"] = not torch.equal(got[1], before[1])
        return params, state

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loop = TrainLoop(model, Optimizer(init=inner.init, update=update),
                     batch_fn, TrainLoopConfig(total_steps=TRAIN_STEPS,
                                               log_every=1,
                                               checkpoint_dir=None),
                     seed=SEED, device=dev)
    sync()
    init_s = time.perf_counter() - t0
    n_params = flat_buffer_of(loop.params).numel()
    print(f"{RG_ARCH}: {n_params} f32 params drawn on the card from seed "
          f"{SEED} (the serving phase's params) and packed into one flat "
          f"buffer, AdamW state allocated, in {init_s:.2f} s; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    counters = {"flash_attention": kflash.flash_attention,
                "flash_attention_bwd": kflash.flash_attention_bwd,
                "rglru_scan": krglru.rglru_scan,
                "rglru_scan_bwd": krglru.rglru_scan_bwd,
                "fused_adamw": kadamw.fused_adamw}
    for c in counters.values():
        c.launches = 0                   # the counts to 0 just before the path
    for c in (kflash.flash_attention, kflash.flash_attention_bwd,
              krglru.rglru_scan, krglru.rglru_scan_bwd):
        c.routes.clear()
    res = loop.run()
    sync()
    stamps.append(time.perf_counter())
    launched = {k: c.launches for k, c in counters.items()}   # read just after
    trained_routes = {**kflash.flash_attention.routes,
                      **kflash.flash_attention_bwd.routes}
    rglru_routes = {"rglru_scan": dict(krglru.rglru_scan.routes),
                    "rglru_scan_bwd": dict(krglru.rglru_scan_bwd.routes)}
    peak = torch.cuda.max_memory_allocated()
    n_tri = cfg.n_layers // 3
    n_rec = cfg.n_layers - n_tri
    expected = {"flash_attention": 2 * n_tri * TRAIN_STEPS,
                "flash_attention_bwd": 3 * n_tri * TRAIN_STEPS,
                "rglru_scan": 2 * n_rec * TRAIN_STEPS,
                "rglru_scan_bwd": n_rec * TRAIN_STEPS,
                "fused_adamw": TRAIN_STEPS}
    losses = [m["loss"] for m in res["metrics_log"]]
    steps_s = [b - a for a, b in zip(stamps, stamps[1:])]
    for i, (loss, dt) in enumerate(zip(losses, steps_s), start=1):
        print(f"step {i}: loss {loss:.6f}, lr {float(sched(i)):.3e}, "
              f"{dt:.3f} s (host clock, synchronised) [{card}]")
    print(f"median step {statistics.median(steps_s[1:]):.3f} s over steps "
          f"2-{TRAIN_STEPS} (step 1 {steps_s[0]:.3f} s); peak device memory "
          f"{peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB) [{card}]")
    print(f"launches over the {TRAIN_STEPS} steps: {json.dumps(launched)}; "
          f"expected {json.dumps(expected)} (flash: {n_tri} attention "
          f"blocks, forward + remat recompute, 3 bf16 backward launches: "
          f"dq, partial dk and dv, their sum; RG-LRU: {n_rec} recurrent "
          f"blocks); RG-LRU launches per copy route {json.dumps(rglru_routes)}")
    check(len(losses) == TRAIN_STEPS and all(np_.isfinite(losses)),
          f"losses {losses}")
    check(launched == expected, f"launches {launched} != {expected}")
    check(trained_routes == {
        kflash.SM90_SOURCE.stem: expected["flash_attention"],
        kflash.BWD_SM90_SOURCE.stem: expected["flash_attention_bwd"]},
        f"bf16 training launched the flash routes {trained_routes}")
    check(rglru_routes == {k: {"tma": expected[k]} for k in rglru_routes},
          f"training launched the RG-LRU routes {rglru_routes}")
    check(window_check.get("same") and window_check.get("moved"),
          f"AdamW window past element 2^31: {window_check}")
    print(f"AdamW on the last step, elements [{ADAMW_WINDOW_START}, "
          f"{ADAMW_WINDOW_START + ADAMW_WINDOW}): p, m, v bit-equal to the plain version run on "
          f"copies of p, g, m, v with the same scalars")
    step_profile(torch, loop, batch_fn(TRAIN_STEPS), card)

    # the depth cut's params: one triple and the two tails of these
    cut_params = {
        "embed": loop.params["embed"], "ln_f": loop.params["ln_f"],
        "lm_head": loop.params["lm_head"], "tail": loop.params["tail"],
        "triples": tree_map(lambda x: x[:1], loop.params["triples"])}
    cut_cpu = tree_map(lambda x: x.detach().cpu().clone(), cut_params)
    del loop, res, cut_params, inner
    torch.cuda.empty_cache()

    # ---- 16. depth cut: cuda vs cpu -------------------------------------
    cut = cfg.replace(n_layers=DEPTH_CUT_LAYERS)
    phase(f"16. training depth cut: full width, {DEPTH_CUT_LAYERS} layers, 1 x "
          f"{TRAIN_CUT_TOKENS} tokens, {TRAIN_CUT_STEPS} steps, cuda vs cpu")
    cut_ds = SyntheticLMDataset(cfg.vocab_size, TRAIN_CUT_TOKENS, seed=SEED)
    cut_bwd = {}
    for name in ("float32", "bfloat16"):
        m = get_model(cut.replace(dtype=name))
        out = {}
        for where in ("cuda", "cpu"):
            d = dev if where == "cuda" else torch.device("cpu")
            kflash.flash_attention_bwd.routes.clear()   # counts to 0
            params = flat_params(tree_map(lambda x: x.to(d), cut_cpu))
            opt = adamw(sched) if name == "float32" else sgd(CUT_SGD_LR)
            state = opt.init(params)
            step_fn = make_train_step(m, opt)
            t0 = time.perf_counter()
            losses = []
            for s in range(TRAIN_CUT_STEPS):
                batch = {k: torch.as_tensor(v).to(d)
                         for k, v in cut_ds.batch(1, s).items()}
                params, state, met = step_fn(params, state, batch)
                losses.append(float(met["loss"]))
            # compared on the card below: the host's float64 passes over
            # ~1.7e9 elements took ~30 s a dtype
            out[where] = (losses, flat_buffer_of(params).detach().to(dev))
            if where == "cuda":
                cut_bwd[name] = dict(kflash.flash_attention_bwd.routes)
                route, passes = bwd_routes[name]
                want = {route: passes * TRAIN_CUT_STEPS}
                check(cut_bwd[name] == want, f"depth cut {name}: flash "
                      f"backward launches {cut_bwd[name]}, expected {want}")
            print(f"{name:8s} {where}: losses {losses} in "
                  f"{time.perf_counter() - t0:.1f} s")
            del params, state, opt, step_fn
        (l_dev, p_dev), (l_cpu, p_cpu) = out["cuda"], out["cpu"]
        p0 = flat_buffer_of(flat_params(cut_cpu)).detach().to(dev)
        gap2 = moved2 = worst = 0.0
        far = 0
        for lo in range(0, p0.numel(), PLAIN_CHUNK):       # bounded temporaries
            a, b, z = (t[lo:lo + PLAIN_CHUNK] for t in (p_dev, p_cpu, p0))
            d = (a - b).abs()
            gap2 += float(d.double().square().sum())
            moved2 += float((b - z).double().square().sum())
            worst = max(worst, float(d.max()))
            far += int((d > 1e-5 + 1e-3 * b.abs()).sum())
        gap, moved = math.sqrt(gap2), math.sqrt(moved2)
        far /= p0.numel()
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_dev, l_cpu))
        print(f"{name:8s} ({'adamw' if name == 'float32' else 'sgd'}): loss "
              f"rel diff {loss_err:.2e} ("
              f"{CUT_LOSS_RTOL[name]}); params: update gap {gap / moved:.2e} "
              f"of the update's norm ({CUT_UPDATE_RTOL[name]}), "
              f"{far:.2e} of the elements outside rtol 1e-3 / atol 1e-5, "
              f"largest |diff| {worst:.2e}")
        check(loss_err <= CUT_LOSS_RTOL[name], f"depth cut {name} losses "
              f"{l_dev} vs {l_cpu}")
        check(gap / moved <= CUT_UPDATE_RTOL[name],
              f"depth cut {name}: update gap {gap / moved}")
        if name in CUT_OUTSIDE:
            check(far <= CUT_OUTSIDE[name], f"depth cut {name}: {far} of the "
                                            f"params outside tolerance")
        del out, p_dev, p_cpu, p0, m, a, b, z, d
        torch.cuda.empty_cache()
    del cut_cpu

    # ---- 17. timings ---------------------------------------------------------
    phase(f"17. fused AdamW, flash backward and RG-LRU adjoint timings on "
          f"{card}")
    n = n_params
    flat = [torch.empty(n, device=dev) for _ in range(4)]
    for i, t in enumerate(flat):
        t.normal_(generator=gen.manual_seed(40 + i))
    p, g, m, v = flat
    g.mul_(1e-2)
    m.mul_(1e-3)
    v.mul_(v).mul_(1e-5)
    scal = (np_.float32(3e-4), *adamw_scalars(np_, 5))
    adamw_bytes = 28 * n
    ab_ms = adamw_bytes / HBM_BYTES_PER_S * 1e3
    a_ms = median_device_ms(torch, lambda: kadamw.fused_adamw(p, g, m, v,
                                                              *scal),
                            runs=7, per_run=3)
    steps_t = torch.full((1,), 5.0, device=dev)

    def library():
        torch._fused_adamw_([p], [g], [m], [v], [], [steps_t], lr=3e-4,
                            beta1=0.9, beta2=0.95, weight_decay=0.1,
                            eps=1e-8, amsgrad=False, maximize=False)
    al_ms = median_device_ms(torch, library, runs=7, per_run=3)

    def plain_full():
        for lo in range(0, n, PLAIN_CHUNK):
            fused_adamw_ref(p[lo:lo + PLAIN_CHUNK], g[lo:lo + PLAIN_CHUNK],
                            m[lo:lo + PLAIN_CHUNK], v[lo:lo + PLAIN_CHUNK],
                            *scal)
    # the plain version's ~170 launches and 1 GB temporaries a call keep
    # the host busy past any device spin: its times include the host
    ap_ms = median_event_ms(torch, plain_full, runs=3, per_run=1)
    sub = [t[:PLAIN_CHUNK] for t in flat]
    a28_ms = median_device_ms(torch, lambda: kadamw.fused_adamw(*sub, *scal),
                              runs=9, per_run=5)
    ap28_ms = median_event_ms(torch, lambda: fused_adamw_ref(*sub, *scal),
                              runs=9, per_run=1)
    print(f"fused AdamW N={n} f32: kernel {a_ms:.3f} ms on the device "
          f"({ab_ms / a_ms * 100:.1f}% of the bound, "
          f"{adamw_bytes / a_ms / 1e6:.0f} GB/s), torch._fused_adamw_ "
          f"{al_ms:.3f} ms, plain torch {ap_ms:.3f} ms (in chunks of 2^28, "
          f"host enqueue included); "
          f"bound {ab_ms:.3f} ms ({adamw_bytes} B / 3.35 TB/s) [{card}]")
    print(f"fused AdamW N=2^28 f32: kernel {a28_ms:.3f} ms, plain torch "
          f"{ap28_ms:.3f} ms; bound "
          f"{28 * PLAIN_CHUNK / HBM_BYTES_PER_S * 1e3:.3f} ms [{card}]")
    del flat, p, g, m, v, sub
    torch.cuda.empty_cache()

    def time_flash_bwd(dtype, seed, shape=FLASH_BWD_CASES[0]):
        """(kernel, plain, bound, SDPA backward) device ms of one flash
        backward, by default at the training shape; wrapper call and
        TFLOP/s printed (for f32, the scalar-FMA bound too)."""
        b, hq, hkv, s, hd, window = shape
        gen.manual_seed(seed)
        q, k, v, do = [torch.randn(sh, device=dev, generator=gen).to(dtype)
                       for sh in ((b, hq, s, hd), (b, hkv, s, hd),
                                  (b, hkv, s, hd), (b, hq, s, hd))]
        scale = 1.0 / math.sqrt(hd)
        out, lse = flash_attention_ref(q, k, v, causal=True, scale=scale,
                                       return_lse=True)

        def kernel():
            return kflash.flash_attention_bwd(q, k, v, out, do, lse,
                                              causal=True, scale=scale)
        fb_ms = median_device_ms(torch, kernel, runs=7, per_run=3)
        call_ms = median_event_ms(torch, kernel, runs=7, per_run=3)
        fp_ms = median_device_ms(torch, lambda: flash_attention_bwd_ref(
            q, k, v, out, do, lse, causal=True, scale=scale), runs=5,
            per_run=1)
        kk = k.repeat_interleave(hq // hkv, dim=1).requires_grad_()
        vv = v.repeat_interleave(hq // hkv, dim=1).requires_grad_()
        qq = q.clone().requires_grad_()
        sdpa_out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)
        fl_ms = median_device_ms(torch, lambda: torch.autograd.grad(
            sdpa_out, (qq, kk, vv), do, retain_graph=True), runs=7, per_run=3)
        size = q.element_size()
        fbb_ms, f_flops, f_bytes = flash_bwd_bound(b, hq, hkv, s, hd, window,
                                                   size)
        on_f32, width = kflash.head_route(hd, dtype)
        route = (kflash.BWD_SOURCE if on_f32 == "f32"
                 else kflash.BWD_SM90_SOURCE).stem
        if size == 2:
            peak = "989 TFLOP/s bf16"
        else:
            fma_ms = flash_bwd_bound(b, hq, hkv, s, hd, window, size,
                                     PEAK_F32_FMA_FLOPS)[0]
            peak = (f"165 TFLOP/s f32 in split TF32; scalar-FMA bound "
                    f"{fma_ms:.4f} ms at 67 TFLOP/s")
        print(f"flash backward {dtype} (B, Hq, Hkv, hd) = {(b, hq, hkv, hd)} "
              f"S={s} causal ({route}.cu at width {width}): kernel "
              f"{fb_ms:.4f} ms on the device (3 launches, "
              f"{f_flops / fb_ms / 1e9:.1f} "
              f"TFLOP/s of the 10·hd a pair, {fbb_ms / fb_ms * 100:.1f}% of "
              f"the bound), wrapper call {call_ms:.4f} ms, plain torch "
              f"{fp_ms:.3f} ms, SDPA backward on k, v repeated to {hq} heads"
              f" {fl_ms:.4f} ms; bound {fbb_ms:.4f} ms ({f_flops:.3e} flops "
              f"/ {peak}; {f_bytes} B / 3.35 TB/s) [{card}]")
        return fb_ms, fp_ms, fbb_ms, fl_ms

    fb_ms, fp_ms, fbb_ms, fl_ms = time_flash_bwd(torch.bfloat16, 77)
    gb_ms, gp_ms, gbb_ms, gl_ms = time_flash_bwd(torch.float32, 79)
    fb4, hq4, hkv4, hd4 = FLASH_SHAPE
    time_flash_bwd(torch.float32, 80, (fb4, hq4, hkv4, FLASH_F32_TIMED[1],
                                       hd4, FLASH_F32_TIMED[2]))
    b8, hq8, hkv8, s8, hd8 = FLASH_HD80
    for dtype in (torch.bfloat16, torch.float32):
        time_flash_bwd(dtype, 81, (b8, hq8, hkv8, s8, hd8, None))

    shape = RGLRU_BWD_CASES[0][0]
    gen.manual_seed(78)
    a = torch.rand(shape, device=dev, generator=gen).mul_(0.2).add_(0.8)
    h = torch.randn(shape, device=dev, generator=gen)
    dh = torch.randn(shape, device=dev, generator=gen)
    r_ms = median_device_ms(torch, lambda: krglru.rglru_scan_bwd(a, h, dh))
    rp_ms = median_event_ms(torch, lambda: rglru_scan_bwd_ref(a, h, dh),
                            runs=3, per_run=1)
    r_bytes = 5 * a.numel() * 4
    rb_ms = r_bytes / HBM_BYTES_PER_S * 1e3
    print(f"RG-LRU adjoint f32 {shape} ({krglru.plan_for((a, h, dh))}): "
          f"kernel {r_ms * 1e3:.1f} us on the device ({rb_ms / r_ms * 100:.1f}"
          f"% of the bound); plain torch {rp_ms:.2f} ms per call (host "
          f"enqueue included); bound {rb_ms * 1e3:.1f} us ({r_bytes} B / "
          f"3.35 TB/s) [{card}]")
    return [
        {"name": "fused_adamw", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_adamw.cu",
         "replaces": "src/repro/kernels/fused_adamw.py:24",
         "launches": launched["fused_adamw"], "max_abs_err": 0.0,
         "ms": a_ms, "plain_ms": ap_ms, "bound_ms": ab_ms,
         "bound_by": "bytes", "library_ms": al_ms},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention.py:39",
         "note": "the backward of that kernel (the TPU has none), bf16 "
                 "operands: wgmma + TMA",
         "launches": trained_routes[kflash.BWD_SM90_SOURCE.stem],
         "max_abs_err": flash_bwd_err["bfloat16"],
         "ms": fb_ms, "plain_ms": fp_ms, "bound_ms": fbb_ms,
         "bound_by": "operations", "library_ms": fl_ms},
        {"name": "flash_attention_bwd_f32", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:39",
         "note": "the backward of that kernel (the TPU has none), float32 "
                 "operands (and bf16 above hd 256): split TF32 on mma.sync; "
                 "launches over phase 16's float32 depth cut; bound_ms at "
                 "165 TFLOP/s (a third of dense TF32)",
         "launches": cut_bwd["float32"][kflash.BWD_SOURCE.stem],
         "max_abs_err": flash_bwd_err["float32"],
         "ms": gb_ms, "plain_ms": gp_ms, "bound_ms": gbb_ms,
         "bound_by": "operations", "library_ms": gl_ms},
        {"name": "rglru_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/rglru.cu",
         "replaces": "src/repro/kernels/rglru.py:58",
         "note": "the backward of that kernel; the TPU has none",
         "launches": launched["rglru_scan_bwd"], "max_abs_err": rglru_bwd_err,
         "ms": r_ms, "plain_ms": rp_ms, "bound_ms": rb_ms,
         "bound_by": "bytes", "library_ms": None},
    ]


# ---- the runner and the emulated fault track (phases 18-19) --------------
FIG3_CLI = ("run", "paper-fig3", "--set", "rounds=6", "--rounds", "6",
            "--strategies", "pso,random", "--seeds", "0")
SAMPLING_GOLDENS = (("large-1k", 5), ("flash-crowd", 25))
TWO_TIER_ROUNDS = 150
TWO_TIER_SWARMS = (10, 1000)
TWO_TIER_PODS = 8
CHAOS_STRATEGIES = ("pso", "greedy")
CHAOS_ROUNDS = 12
CHAOS_CHECKPOINT = 6
CHAOS_PARAM_SHARE = 1e-5       # share of params allowed outside PARAM_TOL


def fault_recording(spec, envs):
    """``recording(spec, envs)`` whose environments also count the rounds
    that go through ``run_round`` (a fault-free round of the fault path
    delegates to it) in ``env.clean_rounds``, and keep a host copy of
    the global params after every step in ``env.params``."""
    base = recording(spec, envs)
    rec_type = type(base)

    class Counted(rec_type):
        def make_environment(self, seed=0, eval_config=None, *,
                             device="cuda"):
            from repro_torch.utils.trees import tree_leaves
            env = rec_type.make_environment(self, seed, eval_config,
                                            device=device)
            orch = env.orchestrator
            env.clean_rounds = 0
            env.params = []
            run_round, step = orch.run_round, env.step

            def counted(r, placement):
                env.clean_rounds += 1
                return run_round(r, placement)

            def snapped(r, placement):
                obs = step(r, placement)
                env.params.append([x.detach().cpu().numpy().copy()
                                   for x in tree_leaves(orch.params)])
                return obs
            orch.run_round = counted
            env.step = snapped
            return env

    return Counted(**{f.name: getattr(spec, f.name)
                      for f in dataclasses.fields(spec)})


def runner_phases(torch, np_, card):
    """Phases 18 (the Fig. 3 / Fig. 4 runner's other paths on cuda: the
    CLI, the lockstep batched sweep, the two-tier pod model) and 19 (the
    emulated fault track at full width, with checkpoint/resume)."""
    import os
    import shutil

    from repro_torch.core.cost_model import TwoTierCostModel
    from repro_torch.core.hierarchy import ClientPool
    from repro_torch.experiments import EvalConfig, get_scenario, run_experiment, run_single
    from repro_torch.experiments.cli import main as cli_main
    from repro_torch.kernels.fedavg import fedavg_batched
    from repro_torch.kernels.tpd import batch_tpd_cuda

    golden = ROOT / "tests" / "golden"
    out_dir = ROOT / "build" / "runner"
    out_dir.mkdir(parents=True, exist_ok=True)

    phase("18. runner on cuda: the CLI's Fig. 3 artifact, the batched "
          "sweep's goldens, the two-tier pod model")
    fig3 = out_dir / "fig3.json"
    fig3.unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.experiments", *FIG3_CLI,
         "--out", str(fig3)], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"python -m repro_torch.experiments run exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    check("device=cuda" in proc.stdout, "the CLI did not run on cuda")
    check(fig3.read_bytes() == (golden / "recording_off_fig3.json")
          .read_bytes(), "the CLI's Fig. 3 artifact differs from "
                         "tests/golden/recording_off_fig3.json")
    check(cli_main(["validate", str(fig3)]) == 0,
          "validate refused the CLI's Fig. 3 artifact")
    print(f"python -m repro_torch.experiments {' '.join(FIG3_CLI)}: "
          f"{fig3.stat().st_size} bytes equal to recording_off_fig3.json, "
          f"validate exits 0; {cli_s:.2f} s, process start included "
          f"[{card}]")
    for name, rounds in SAMPLING_GOLDENS:
        want = (golden / f"sampling_off_{name}.json").read_text()
        for mode in ("batched", "sequential"):
            t0 = time.perf_counter()
            res = run_experiment(name, ["pso", "random"], rounds=rounds,
                                 seeds=[SEED], progress=False,
                                 eval_config=EvalConfig(mode=mode),
                                 device="cuda")
            wall = time.perf_counter() - t0
            got = json.dumps(res.to_dict(), indent=1, sort_keys=True)
            check(got == want, f"{name} ({mode}) on cuda differs from "
                               f"sampling_off_{name}.json")
            print(f"{name:11s} {rounds:2d} rounds, mode={mode:10s}: equal "
                  f"to sampling_off_{name}.json; {wall:.3f} s [{card}]")

    batch_tpd_cuda.launches = 0   # the count to 0 just before the path
    t0 = time.perf_counter()
    tt_cuda = run_experiment("two-tier", ["pso", "random"],
                             rounds=TWO_TIER_ROUNDS, seeds=[SEED],
                             progress=False, device="cuda")
    tt_s = time.perf_counter() - t0
    tt_launches = batch_tpd_cuda.launches   # just after
    tt_cpu = run_experiment("two-tier", ["pso", "random"],
                            rounds=TWO_TIER_ROUNDS, seeds=[SEED],
                            progress=False, device="cpu")
    check(tt_cuda.to_dict() == tt_cpu.to_dict(),
          "two-tier on cuda differs from the CPU run")
    check(tt_launches == 0, f"the two-tier preset launched the TPD kernel "
                            f"{tt_launches} times")
    print(f"two-tier, {TWO_TIER_ROUNDS} rounds x (pso, random): artifact "
          f"equal to the CPU run; 0 tpd launches; {tt_s:.3f} s on cuda "
          f"[{card}]")

    spec = get_scenario("large-1k")
    h = spec.make_hierarchy()
    C = h.total_clients
    rng = np_.random.default_rng(SEED)
    pool = ClientPool.random(C, seed=SEED)
    pool.mdatasize = rng.uniform(1.0, 40.0, C)
    tt = TwoTierCostModel(h, pool, memory_penalty=2.0, device="cuda",
                          pod_of=np_.arange(C) * TWO_TIER_PODS // C)
    for P in TWO_TIER_SWARMS:
        ps = np_.stack([rng.permutation(C)[:h.dimensions]
                        for _ in range(P)])
        ps[0, 1] = ps[0, 0]                  # a duplicate-id row
        batch_tpd_cuda.launches = 0
        got = tt.batch_tpd(ps)
        torch.cuda.synchronize()
        check(batch_tpd_cuda.launches == 0,
              f"TwoTierCostModel.batch_tpd launched the TPD kernel at "
              f"P={P}")
        auto = "np" if P * C <= tt._NP_FASTPATH_ELEMS else "torch"
        check(getattr(tt, f"_batch_tpd_{auto}", None) is not None,
              f"TwoTierCostModel.batch_tpd did not take the {auto} build "
              f"at P={P}")
        scalar = np_.array([tt.tpd(p) for p in ps])
        rel = float(np_.max(np_.abs(got - scalar) / scalar))
        check(rel <= RTOL_SCALAR, f"two-tier batch_tpd at P={P}: rel "
                                  f"{rel} > {RTOL_SCALAR}")
        call_ms = median_host_ms(lambda ps=ps: tt.batch_tpd(ps), runs=9,
                                 sync=torch.cuda.synchronize)
        print(f"TwoTierCostModel.batch_tpd at large-1k, {TWO_TIER_PODS} "
              f"pods, P={P:4d} (auto: {auto}): 0 tpd launches, largest "
              f"rel diff to the float64 scalar model {rel:.2e} (rtol "
              f"{RTOL_SCALAR}); "
              f"{call_ms * 1e3:.1f} us a call (host clock) [{card}]")
    try:
        tt.batch_tpd(ps, backend="kernel")
    except ValueError as e:
        print(f"backend='kernel' on the two-tier model refused: {e}")
    else:
        raise SmokeFailure("backend='kernel' ran on a two-tier model")

    chaos = get_scenario("chaos").for_env("emulated")
    phase(f"19. emulated fault track on cuda: chaos (model {chaos.model}, "
          f"{CHAOS_ROUNDS} rounds x {CHAOS_STRATEGIES}), held to the CPU "
          f"run; resume from round {CHAOS_CHECKPOINT}")
    envs_cuda, envs_cpu = [], []
    fedavg_batched.launches = 0   # the count to 0 just before the path
    t0 = time.perf_counter()
    res_cuda = run_experiment(fault_recording(chaos, envs_cuda),
                              CHAOS_STRATEGIES, rounds=CHAOS_ROUNDS,
                              seeds=[SEED], progress=False, device="cuda")
    torch.cuda.synchronize()
    chaos_s = time.perf_counter() - t0
    chaos_launches = fedavg_batched.launches   # just after
    depth = chaos.make_hierarchy().depth
    clean = [env.clean_rounds for env in envs_cuda]
    want = sum(c + 1 for c in clean) * depth
    check(chaos_launches == want and chaos_launches > 0,
          f"chaos: {chaos_launches} fedavg_batched launches, expected "
          f"{want} ((clean rounds + 1 warm-up) x {depth} levels, clean "
          f"rounds {clean})")
    print(f"{chaos_launches} fedavg_batched launches = (clean rounds "
          f"{' + '.join(map(str, clean))} + {len(clean)} warm-ups) x "
          f"{depth} levels; the faulty rounds merge through "
          f"quorum_merge_batched")
    res_cpu = run_experiment(fault_recording(chaos, envs_cpu), CHAOS_STRATEGIES,
                             rounds=CHAOS_ROUNDS, seeds=[SEED],
                             progress=False, device="cpu")
    series = ("merged", "down", "partitioned", "faults", "failovers",
              "dropped_updates", "degraded_flushes", "train_time",
              "agg_time")
    for name, a, b, ec, eh in zip(CHAOS_STRATEGIES, res_cuda.runs,
                                  res_cpu.runs, envs_cuda, envs_cpu,
                                  strict=True):
        check([s[:2] for s in ec.steps] == [s[:2] for s in eh.steps],
              f"chaos {name}: cuda placements/TPDs differ from the CPU run")
        check(a.tpds == b.tpds and a.event_log == b.event_log,
              f"chaos {name}: TPDs or event log differ from the CPU run")
        for k in series:
            check(a.metrics[k] == b.metrics[k],
                  f"chaos {name}: {k} series differs from the CPU run")
        lc, lh = np_.array(a.metrics["loss"]), np_.array(b.metrics["loss"])
        check(bool(np_.all(np_.isfinite(lc))), f"chaos {name}: loss {lc}")
        loss_rel = float(np_.max(np_.abs(lc - lh) / np_.abs(lh)))
        check(loss_rel <= LOSS_RTOL, f"chaos {name}: losses differ by rel "
                                     f"{loss_rel} > {LOSS_RTOL}")
        # float32 training on two devices: a ReLU pre-activation within
        # the products' rounding of 0 can take the other side, moving one
        # client's update by ~1e-4 in a few elements; so the final params
        # are held elementwise up to a stated share, as phase 16 holds
        # training, and the per-round largest difference is printed
        per_round = [max(float(np_.max(np_.abs(x - y)))
                         for x, y in zip(pc, ph, strict=True))
                     for pc, ph in zip(ec.params, eh.params, strict=True)]
        total = outside = 0
        for x, y in zip(ec.params[-1], eh.params[-1], strict=True):
            check(x.shape == y.shape and bool(np_.all(np_.isfinite(x))),
                  f"chaos {name}: final params malformed")
            total += x.size
            outside += int(np_.count_nonzero(~np_.isclose(x, y,
                                                          **PARAM_TOL)))
        check(outside <= CHAOS_PARAM_SHARE * total,
              f"chaos {name}: {outside} of {total} final params outside "
              f"{PARAM_TOL} (at most {CHAOS_PARAM_SHARE:.0e} of them)")
        print(f"chaos {name:6s}: placements, TPDs and fault series equal to "
              f"the CPU run (merged {a.metrics['merged']}, failovers "
              f"{a.metrics['failovers'][-1]:.0f}, faults "
              f"{a.metrics['faults'][-1]:.0f}); loss {lh[0]:.4f} -> "
              f"{lh[-1]:.4f}, rel diff {loss_rel:.2e}; final params: "
              f"{outside} of {total} outside {PARAM_TOL}, largest abs diff "
              f"by round {' '.join(f'{d:.1e}' for d in per_round)}")
    ckpt = out_dir / "chaos_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    run_single(chaos, CHAOS_STRATEGIES[0], seed=SEED,
               rounds=CHAOS_CHECKPOINT, checkpoint_dir=str(ckpt),
               checkpoint_every=CHAOS_CHECKPOINT, device="cuda")
    resumed = run_single(chaos, CHAOS_STRATEGIES[0], seed=SEED,
                         rounds=CHAOS_ROUNDS, checkpoint_dir=str(ckpt),
                         resume=True, device="cuda")
    check(json.dumps(resumed.to_dict(), sort_keys=True)
          == json.dumps(res_cuda.runs[0].to_dict(), sort_keys=True),
          "chaos: the run resumed from round "
          f"{CHAOS_CHECKPOINT} differs from the uninterrupted cuda run")
    n_rounds = CHAOS_ROUNDS * len(CHAOS_STRATEGIES)
    shutil.rmtree(ckpt)
    print(f"resumed from round {CHAOS_CHECKPOINT} to {CHAOS_ROUNDS} on "
          f"cuda: to_dict() equal to the uninterrupted run, byte for byte")
    print(f"chaos on cuda: {chaos_s:.2f} s for {n_rounds} rounds "
          f"({chaos_s / n_rounds:.3f} s a round, warm-ups included, host "
          f"clock) [{card}]")


# ---- the online track and trace calibration (phases 20-21) ---------------
ONLINE_ROUNDS = 8              # 12 before phase 30 (the CPU runs took 24.5 s)
ONLINE_STRATEGIES = ("pso", "greedy")
STRAGGLER_ROUNDS = 6
ONLINE_CHECKPOINT = 6
TRACE_ROUNDS = 6
CAL_SWARMS = (10, 1000)


def keeping(spec, envs):
    """``spec`` as a ScenarioSpec whose environments are kept in ``envs``
    (its own class, so an online spec stays online), each recording
    every step's (placement, tpd) in ``env.steps`` and counting the
    orchestrator's FedAvg aggregations (``_agg_batched`` calls: the
    warm-up's and each lockstep round's, one kernel launch a tree level
    on the card) in ``env.agg_calls``."""
    base = type(spec)

    class Kept(base):
        def make_environment(self, seed=0, eval_config=None, *,
                             device="cuda"):
            env = base.make_environment(self, seed, eval_config,
                                        device=device)
            orch = env.orchestrator
            env.steps, env.agg_calls = [], 0
            aggregate, step = orch._agg_batched, env.step

            def counted(*args):
                env.agg_calls += 1
                return aggregate(*args)

            def recorded(r, placement):
                obs = step(r, placement)
                env.steps.append((obs.placement.tolist(), obs.tpd))
                return obs
            orch._agg_batched = counted
            env.step = recorded
            envs.append(env)
            return env

    return Kept(**{f.name: getattr(spec, f.name)
                   for f in dataclasses.fields(spec)})


def host_leaves(env):
    from repro_torch.utils.trees import tree_leaves
    return [x.detach().cpu().numpy()
            for x in tree_leaves(env.orchestrator.params)]


def params_outside(np_, a, b):
    """(elements outside PARAM_TOL, elements, largest abs difference)
    between two lists of host arrays."""
    outside = total = 0
    largest = 0.0
    for x, y in zip(a, b, strict=True):
        check(x.shape == y.shape and bool(np_.all(np_.isfinite(x))),
              "final params malformed")
        total += x.size
        outside += int(np_.count_nonzero(~np_.isclose(x, y, **PARAM_TOL)))
        largest = max(largest, float(np_.max(np_.abs(x - y))))
    return outside, total, largest


def online_phases(torch, np_, card):
    """Phases 20 (the online track on cuda at full width, held to the
    CPU run and, degenerate, to the emulated track) and 21 (trace
    calibration on cuda, and the calibrated cost model kept off the TPD
    kernel)."""
    import shutil

    from repro_torch.calibration import ANALYTIC, fit_calibration, record_trace, replay
    from repro_torch.core.cost_model import CalibratedCostModel
    from repro_torch.core.pso import FlagSwapPSO
    from repro_torch.experiments import EvalConfig, get_scenario, run_single
    from repro_torch.kernels.fedavg import fedavg_batched
    from repro_torch.kernels.tpd import batch_tpd_cuda
    from repro_torch.utils.trees import tree_leaves

    out_dir = ROOT / "build" / "online"
    out_dir.mkdir(parents=True, exist_ok=True)
    online4 = get_scenario("online-fig4")
    phase(f"20. online track on cuda: online-sync vs the emulated track, "
          f"online-fig4, online-straggler and chaos (model "
          f"{online4.model}, {ONLINE_ROUNDS} rounds), held to the CPU run")
    # (label, scenario, strategy, rounds): the cuda runs, then the same
    # runs on the CPU
    runs = [("online-sync", "online-sync", "pso", ONLINE_ROUNDS),
            ("paper-fig4 (emulated twin)", "paper-fig4", "pso",
             ONLINE_ROUNDS),
            *((f"online-fig4 {s}", "online-fig4", s, ONLINE_ROUNDS)
              for s in ONLINE_STRATEGIES),
            ("online-straggler pso", "online-straggler", "pso",
             STRAGGLER_ROUNDS),
            *((f"chaos {s}", "chaos", s, ONLINE_ROUNDS)
              for s in ONLINE_STRATEGIES)]
    done = {}
    for device in ("cuda", "cpu"):
        if device == "cuda":
            fedavg_batched.launches = 0   # the count to 0 just before
        t0 = time.perf_counter()
        for label, name, strategy, rounds in runs:
            envs = []
            t1 = time.perf_counter()
            run = run_single(keeping(get_scenario(name), envs), strategy,
                             seed=SEED, rounds=rounds, device=device)
            if device == "cuda":
                torch.cuda.synchronize()
            done[device, label] = (run, envs[0],
                                   time.perf_counter() - t1)
        wall = time.perf_counter() - t0
        if device == "cuda":
            launches = fedavg_batched.launches   # just after the path
            cuda_s = wall
        else:
            cpu_s = wall
    expect = {dev: sum(done[dev, label][1].agg_calls
                       * done[dev, label][1].hierarchy.depth
                       for label, *_ in runs) for dev in ("cuda", "cpu")}
    check(launches == expect["cuda"] == expect["cpu"] and launches > 0,
          f"online phase: {launches} fedavg_batched launches on cuda, "
          f"expected {expect['cuda']} (cuda aggregations x levels) and "
          f"the CPU rehearsal's {expect['cpu']}")
    print(f"{launches} fedavg_batched launches over the phase = the CPU "
          f"rehearsal's aggregations x tree levels ("
          + ", ".join(f"{label} {done['cpu', label][1].agg_calls}"
                      for label, *_ in runs)
          + "): one warm-up a run, plus every lockstep round of "
            "online-sync and its emulated twin; asynchronous merges are "
            "tensordots")

    sync, _, _ = done["cuda", "online-sync"]
    emu, _, _ = done["cuda", "paper-fig4 (emulated twin)"]
    env_s = done["cuda", "online-sync"][1]
    env_e = done["cuda", "paper-fig4 (emulated twin)"][1]
    check(sync.tpds == emu.tpds and env_s.steps == env_e.steps,
          "online-sync: TPDs/placements differ from the emulated track")
    for k in ("loss", "accuracy", "train_time", "agg_time"):
        check(sync.metrics[k] == emu.metrics[k],
              f"online-sync: {k} differs from the emulated track")
    same = all(torch.equal(x, y) for x, y in zip(
        tree_leaves(env_s.orchestrator.params),
        tree_leaves(env_e.orchestrator.params), strict=True))
    check(same, "online-sync: final params differ from the emulated "
                "track's (torch.equal)")
    check(env_s._store == {}, "online-sync stored updates: the lockstep "
                              "path must store none")
    print(f"online-sync pso, {ONLINE_ROUNDS} rounds on cuda: TPDs, "
          f"placements, losses and final params (torch.equal) equal to "
          f"the emulated paper-fig4 run on cuda; loss "
          f"{sync.metrics['loss'][0]:.4f} -> {sync.metrics['loss'][-1]:.4f}")

    series = ("overlap", "reopt_swaps", "merged", "staleness_mean",
              "staleness_max", "down", "partitioned", "faults",
              "dropped_updates", "retries", "degraded_flushes", "failovers")
    for label, name, strategy, rounds in runs:
        a, ec, a_s = done["cuda", label]
        b, eh, _ = done["cpu", label]
        check(ec.steps == eh.steps and a.tpds == b.tpds,
              f"{label}: cuda placements/TPDs differ from the CPU run")
        check(a.event_log == b.event_log,
              f"{label}: cuda event log differs from the CPU run")
        for k in series:
            check(a.metrics.get(k) == b.metrics.get(k),
                  f"{label}: {k} series differs from the CPU run")
        lc, lh = np_.array(a.metrics["loss"]), np_.array(b.metrics["loss"])
        check(bool(np_.all(np_.isfinite(lc))), f"{label}: loss {lc}")
        loss_rel = float(np_.max(np_.abs(lc - lh) / np_.abs(lh)))
        check(loss_rel <= LOSS_RTOL, f"{label}: losses differ by rel "
                                     f"{loss_rel} > {LOSS_RTOL}")
        outside, total, largest = params_outside(np_, host_leaves(ec),
                                                 host_leaves(eh))
        check(outside <= CHAOS_PARAM_SHARE * total,
              f"{label}: {outside} of {total} final params outside "
              f"{PARAM_TOL} (at most {CHAOS_PARAM_SHARE:.0e} of them)")
        extra = ""
        if "overlap" in a.metrics:
            extra = (f"; overlap max {max(a.metrics['overlap']):.2f}, "
                     f"staleness max {max(a.metrics['staleness_max']):.0f}"
                     f", reopt swaps {a.metrics['reopt_swaps'][-1]:.0f}")
        if "faults" in a.metrics:
            extra += (f", faults {a.metrics['faults'][-1]:.0f}, dropped "
                      f"{a.metrics['dropped_updates'][-1]:.0f}, failovers "
                      f"{a.metrics['failovers'][-1]:.0f}")
        print(f"{label:27s} {rounds:2d} rounds: placements, TPDs, event "
              f"log ({len(a.event_log)} lines) and series equal to the CPU "
              f"run{extra}; loss rel diff {loss_rel:.2e}; final params "
              f"{outside} of {total} outside {PARAM_TOL}, largest abs diff "
              f"{largest:.1e}; {a_s:.3f} s on cuda ({a_s / rounds:.4f} s "
              f"a round, warm-up included, host clock) [{card}]")
    strag, _, _ = done["cuda", "online-straggler pso"]
    swaps = [line for line in strag.event_log if "REOPT" in line]
    check(len(swaps) > 0, "online-straggler: no REOPT swap on cuda")
    print(f"online-straggler: {len(swaps)} REOPT swaps, the first: "
          f"{swaps[0]}")

    ckpt = out_dir / "chaos_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    chaos = get_scenario("chaos")
    run_single(chaos, "pso", seed=SEED, rounds=ONLINE_CHECKPOINT,
               checkpoint_dir=str(ckpt), checkpoint_every=ONLINE_CHECKPOINT,
               device="cuda")
    meta = json.loads((ckpt / f"step_{ONLINE_CHECKPOINT:08d}"
                       / "meta.json").read_text())
    in_flight = len(meta["extra"]["store_keys"])
    resumed = run_single(chaos, "pso", seed=SEED, rounds=ONLINE_ROUNDS,
                         checkpoint_dir=str(ckpt), resume=True,
                         device="cuda")
    check(json.dumps(resumed.to_dict(), sort_keys=True)
          == json.dumps(done["cuda", "chaos pso"][0].to_dict(),
                        sort_keys=True),
          f"chaos online: the run resumed from round {ONLINE_CHECKPOINT} "
          f"differs from the uninterrupted cuda run")
    shutil.rmtree(ckpt)
    print(f"chaos online pso resumed from round {ONLINE_CHECKPOINT} "
          f"({in_flight} updates in flight in the checkpoint) to "
          f"{ONLINE_ROUNDS} on cuda: to_dict() equal to the uninterrupted "
          f"run, byte for byte")
    n_rounds = sum(r for *_, r in runs)
    print(f"phase 20 runs: {cuda_s:.2f} s on cuda, {cpu_s:.2f} s on the "
          f"CPU for {n_rounds} rounds each (host clock) [{card}]")

    phase(f"21. trace calibration on cuda: record_trace('paper-fig4', "
          f"rounds={TRACE_ROUNDS}), fit, replay, and the calibrated cost "
          f"model on the Fig. 3 grid, held to the CPU run")
    traces = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        traces[device] = record_trace("paper-fig4", "pso", seed=SEED,
                                      rounds=TRACE_ROUNDS, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
            rec_s = time.perf_counter() - t0
    got = traces["cuda"].to_json()
    check(got == traces["cpu"].to_json(),
          "the cuda trace JSON differs from the CPU run's")
    cal = fit_calibration(traces["cuda"], holdout_rounds=1)
    check(cal.to_dict() == fit_calibration(traces["cpu"],
                                           holdout_rounds=1).to_dict(),
          "the fit of the cuda trace differs from the CPU trace's fit")
    for c in (cal, ANALYTIC):
        check(replay(traces["cuda"], c).to_dict()
              == replay(traces["cpu"], c).to_dict(),
              "replay of the cuda trace differs from the CPU trace's")
    held = [traces["cuda"].records[-1]["round"]]
    err_cal = replay(traces["cuda"], cal, rounds=held).mean_abs_error
    err_ana = replay(traces["cuda"], ANALYTIC, rounds=held).mean_abs_error
    cal_path = cal.save(out_dir / "cal.json")
    print(f"paper-fig4 trace, {TRACE_ROUNDS} rounds of pso on cuda: "
          f"{len(got)} bytes of JSON equal to the CPU run's; "
          f"{rec_s:.2f} s (host clock) [{card}]")
    print(f"fit (last round held out): payload_scale {cal.payload_scale!r}"
          f", level_link {list(cal.level_link)!r}, train_scale "
          f"{cal.train_scale!r}, {cal.n_rows} rows, rms residual "
          f"{cal.rms_residual:.3g}: equal to the CPU fit; held-out round "
          f"error {err_cal:.3g} calibrated vs {err_ana:.3g} analytic; "
          f"replay reports equal")

    ec = EvalConfig(cost_source="calibrated", calibration=str(cal_path))

    def swarm(depth, width, particles, device, eval_config):
        env = get_scenario("paper-fig3").with_overrides(
            depth=depth, width=width).make_environment(
            SEED, eval_config=eval_config, device=device)
        cm = env.cost_model
        pso = FlagSwapPSO(env.hierarchy.dimensions,
                          env.hierarchy.total_clients,
                          n_particles=particles, inertia=0.01, c1=0.01,
                          c2=1.0, velocity_factor=0.1, seed=SEED)
        best = pso.run(cm.fitness, FIG3_ITERATIONS,
                       batch_fitness_fn=cm.batch_fitness)
        return cm, pso, best

    cells = [(d, w, P) for d in FIG3_DEPTH for w in FIG3_WIDTH
             for P in FIG3_PARTICLES]
    batch_tpd_cuda.launches = 0   # the count to 0 just before the path
    t0 = time.perf_counter()
    calibrated = {c: swarm(*c, "cuda", ec) for c in cells}
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    cal_launches = batch_tpd_cuda.launches   # just after
    batch_tpd_cuda.launches = 0
    t0 = time.perf_counter()
    analytic = {c: swarm(*c, "cuda", None) for c in cells}
    torch.cuda.synchronize()
    ana_s = time.perf_counter() - t0
    ana_launches = batch_tpd_cuda.launches
    check(all(isinstance(calibrated[c][0], CalibratedCostModel)
              for c in cells), "the calibrated cost source did not build "
                               "a CalibratedCostModel")
    check(cal_launches == 0, f"the calibrated Fig. 3 grid launched the "
                             f"TPD kernel {cal_launches} times")
    check(ana_launches == len(cells) * FIG3_ITERATIONS,
          f"the analytic twin launched the TPD kernel {ana_launches} "
          f"times, expected {len(cells) * FIG3_ITERATIONS}")
    same_as_analytic = 0
    for c in cells:
        cm, pso, best = calibrated[c]
        _, cpu, cpu_best = swarm(*c, "cpu", ec)
        check(pso.history.best == cpu.history.best
              and pso.history.mean == cpu.history.mean
              and pso.history.worst == cpu.history.worst
              and np_.array_equal(best, cpu_best)
              and np_.array_equal(pso.gbest_x, cpu.gbest_x),
              f"calibrated Fig. 3 cell {c}: cuda history/gbest differ "
              f"from the CPU run")
        rel = abs(-pso.gbest_f - cm.tpd(best)) / cm.tpd(best)
        check(rel <= RTOL_SCALAR, f"calibrated cell {c}: gbest {-pso.gbest_f}"
                                  f" vs scalar {cm.tpd(best)}")
        same_as_analytic += bool(np_.array_equal(best, analytic[c][2]))
    print(f"calibrated Fig. 3 grid ({len(cells)} cells x "
          f"{FIG3_ITERATIONS} iterations) on cuda: histories and gbest "
          f"equal to the CPU run; 0 TPD kernel "
          f"launches ({cal_s:.2f} s); the analytic twin {ana_launches} "
          f"launches ({ana_s:.2f} s) [{card}]; {same_as_analytic}/"
          f"{len(cells)} cells end on the analytic twin's placement")

    spec = get_scenario("large-1k")
    env = spec.make_environment(SEED, eval_config=ec, device="cuda")
    cm = env.cost_model
    h = env.hierarchy
    rng = np_.random.default_rng(SEED)
    for P in CAL_SWARMS:
        ps = np_.stack([rng.permutation(h.total_clients)[:h.dimensions]
                        for _ in range(P)])
        batch_tpd_cuda.launches = 0
        got = cm.batch_tpd(ps)
        got_t = cm.batch_tpd(ps, "torch")
        torch.cuda.synchronize()
        check(batch_tpd_cuda.launches == 0,
              f"CalibratedCostModel.batch_tpd launched the TPD kernel at "
              f"P={P}")
        auto = "np" if P * h.total_clients <= cm._NP_FASTPATH_ELEMS \
            else "torch"
        check(getattr(cm, f"_batch_tpd_{auto}", None) is not None,
              f"CalibratedCostModel.batch_tpd did not take the {auto} "
              f"build at P={P}")
        scalar = np_.array([cm.tpd(p) for p in ps[:50]])
        rel = max(float(np_.max(np_.abs(g[:50] - scalar) / scalar))
                  for g in (got, got_t))
        check(rel <= RTOL_SCALAR, f"calibrated batch_tpd at P={P}: rel "
                                  f"{rel} > {RTOL_SCALAR}")
        t = {b: median_host_ms(lambda ps=ps, b=b: cm.batch_tpd(ps, b),
                               runs=9, sync=torch.cuda.synchronize)
             for b in (None, "torch", "np")}
        print(f"CalibratedCostModel.batch_tpd at large-1k "
              f"(C={h.total_clients}, D={h.dimensions}), P={P:4d}: auto "
              f"({auto}) {t[None] * 1e3:.1f} us a call (host clock), torch "
              f"build {t['torch'] * 1e3:.1f} us, numpy "
              f"{t['np'] * 1e3:.1f} us; 0 tpd launches; largest rel diff "
              f"to the float64 scalar model {rel:.2e} (rtol {RTOL_SCALAR}) "
              f"[{card}]")
    try:
        cm.batch_tpd(ps, backend="kernel")
    except ValueError as e:
        print(f"backend='kernel' on the calibrated model refused: {e}")
    else:
        raise SmokeFailure("backend='kernel' ran on a calibrated model")


# ---- the dense transformer family (phases 22-23) -------------------------
DENSE_ARCH = "granite-8b"
DENSE_PROMPTS = ((1024, 4), (4096, 4))   # as phase 11: 2 waves of 4
DENSE_NEW_TOKENS = SERVE_NEW_TOKENS
DENSE_SERIAL = (0, 4)          # one request of each wave, served alone
DENSE_CUT_LAYERS = 2           # the depth cut held to the CPU
DENSE_CUT_STEPS = 4            # decode steps of the depth cut
PADDED_ARCH = "stablelm-3b"    # hd 80: the padded route of the bf16 flash
PADDED_PROMPTS, PADDED_NEW_TOKENS = (1024, 4), 16
FL_ARCHS = ("stablelm-1.6b", "recurrentgemma-2b")   # reduced(), float32
# 1 federated round (a third was cut to make room for phase 28, a second
# for phase 30: the engine's cuda and cpu runs took 47 s over phases 23-26)
FL_CLIENTS, FL_ROUNDS, FL_LOCAL_STEPS, FL_BATCH, FL_SEQ = 7, 1, 2, 2, 16
# launch/train.py's --batch-size: its default 32 took 19-23 s a family on
# the reduced models, whose host issue (a product a sequence) binds
FL_TRAIN_BATCH = 8


def kernel_counts(kflash, krglru, kfedavg, ktpd, kadamw):
    """Every kernel counter of the port, by the kernels line's names."""
    return {"flash_attention": kflash.flash_attention.routes.get(
                kflash.SM90_SOURCE.stem, 0),
            "flash_attention_f32": kflash.flash_attention.routes.get(
                kflash.SOURCE.stem, 0),
            "flash_attention_bwd": kflash.flash_attention_bwd.routes.get(
                kflash.BWD_SM90_SOURCE.stem, 0),
            "flash_attention_bwd_f32": kflash.flash_attention_bwd.routes.get(
                kflash.BWD_SOURCE.stem, 0),
            "rglru_scan": krglru.rglru_scan.launches,
            "fused_adamw": kadamw.fused_adamw.launches,
            "rglru_scan_bwd": krglru.rglru_scan_bwd.launches,
            "fedavg_batched": kfedavg.fedavg_batched.launches,
            "fedavg": kfedavg.fedavg.launches,
            "tpd": ktpd.batch_tpd_cuda.launches}


def zero_counts(kflash, krglru, kfedavg, ktpd, kadamw):
    for fn in (kflash.flash_attention, kflash.flash_attention_bwd):
        fn.launches = 0
        fn.routes.clear()
        fn.modes.clear()
        fn.heads.clear()
    for fn in (krglru.rglru_scan, krglru.rglru_scan_bwd):
        fn.launches = 0
        fn.routes.clear()
    kfedavg.fedavg_batched.launches = kfedavg.fedavg.launches = 0
    ktpd.batch_tpd_cuda.launches = 0
    kadamw.fused_adamw.launches = 0


def decode_profile(torch, np_, model, params, prompts, dev, card,
                   frontend=None):
    """One decode step of a wave of ``prompts`` (behind ``frontend``, the
    vlm and audio families' stub embeddings) under ``torch.profiler``:
    the step's host time, the device's busy time and its split by kernel
    (one stream: kernels do not overlap). Printed, not checked."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    toks = torch.as_tensor(np_.stack(prompts)).to(dev)
    batch = {"tokens": toks}
    if frontend is not None:
        batch["frontend"] = torch.as_tensor(frontend).to(dev).expand(
            len(prompts), -1, -1).contiguous()
    logits, state = model.prefill_fn(params, batch)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    for _ in range(2):
        logits, state = model.decode_fn(params, state, {"token": tok})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, state = model.decode_fn(params, state, {"token": tok})
        issued = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]

    def dev_ms(e):
        return (getattr(e, "self_device_time_total", None) or
                getattr(e, "self_cuda_time_total", 0.0)) / 1e3

    busy = sum(dev_ms(e) for e in kernels)
    top = sorted(kernels, key=dev_ms, reverse=True)[:6]
    print(f"one decode step of {len(prompts)} x {len(prompts[0])} under "
          f"torch.profiler: host issue {issued * 1e3:.1f} ms, step "
          f"{wall * 1e3:.1f} ms synchronised, device busy {busy:.1f} ms "
          f"({sum(e.count for e in kernels)} launches); top: "
          + "; ".join(f"{e.key[:50]} {dev_ms(e):.2f} ms x{e.count}"
                      for e in top) + f" [{card}]")
    del state, logits


def dense_phases(torch, np_, dev, card):
    """Phases 22 (full-width granite-8b serving on cuda, a depth cut held
    to the CPU, a stablelm-3b wave on the padded hd-80 route) and 23
    (federated LM rounds through ``launch/train.py`` and the batched
    engine, cuda vs cpu). Returns each kernel's launches over the two
    main paths: {kernel name: {path: launches}}."""
    from repro_torch.configs import get_config
    from repro_torch.core.registry import create_strategy
    from repro_torch.core.hierarchy import ClientPool, Hierarchy
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.fl.orchestrator import FederatedOrchestrator
    from repro_torch.kernels import fedavg as kfedavg
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import fused_adamw as kadamw
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru as krglru
    from repro_torch.kernels import tpd as ktpd
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import get_model
    from repro_torch.serving import Request, WaveScheduler
    from repro_torch.utils.trees import tree_leaves, tree_map

    sync = torch.cuda.synchronize
    counters = (kflash, krglru, kfedavg, ktpd, kadamw)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"{held / 2**30:.2f} GiB held on the card before phase 22")
    check(held < 8 * 2 ** 30, f"{held} bytes still held on the card "
                              f"before phase 22")

    # ---- 22. full-width granite-8b serving ------------------------------
    cfg = get_config(DENSE_ARCH)
    n_req = sum(n for _, n in DENSE_PROMPTS)
    phase(f"22. full-width {DENSE_ARCH} serving on cuda: WaveScheduler("
          f"max_batch={SERVE_MAX_BATCH}), {n_req} requests, "
          f"{DENSE_NEW_TOKENS} new tokens each; a {DENSE_CUT_LAYERS}-layer "
          f"depth cut vs cpu; a {PADDED_ARCH} wave (hd 80, padded)")
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(SEED), dev)
    sync()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(8.2e9 < n_params < 8.3e9, f"{DENSE_ARCH} holds {n_params} params")
    hd = cfg.resolved_head_dim
    print(f"{DENSE_ARCH}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv heads of {hd}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, rope theta "
          f"{cfg.rope_theta:g}; {n_params} f32 params "
          f"({n_params * 4 / 1e9:.2f} GB) drawn on the card in {init_s:.2f} "
          f"s; compute dtype {cfg.dtype}; flash route "
          f"{kflash.head_route(hd, torch.bfloat16)}")
    rng = np_.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, plen).astype(np_.int32)
               for plen, n in DENSE_PROMPTS for _ in range(n)]
    reqs = [Request(rid=i, tokens=t, max_new_tokens=DENSE_NEW_TOKENS)
            for i, t in enumerate(prompts)]

    # each decode call's host time (it returns before the device is
    # done: the scheduler's argmax read synchronises) and each wave's
    # peak memory, read at the next wave's prefill and after the run
    issue_ms, peaks = [], []

    def timed_decode(p, state, batch):
        t1 = time.perf_counter()
        out = model.decode_fn(p, state, batch)
        issue_ms[-1].append((time.perf_counter() - t1) * 1e3)
        return out

    def wave_prefill(p, batch):
        if issue_ms:
            peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        issue_ms.append([])
        return model.prefill_fn(p, batch)

    served_model = dataclasses.replace(model, prefill_fn=wave_prefill,
                                       decode_fn=timed_decode)
    sched = WaveScheduler(served_model, params, max_batch=SERVE_MAX_BATCH)
    for r in reqs:
        sched.submit(r)
    zero_counts(*counters)            # the counts to 0 just before the path
    t0 = time.perf_counter()
    served = sched.run()
    sync()
    serve_s = time.perf_counter() - t0
    launched = kernel_counts(*counters)   # read just after
    peaks.append(torch.cuda.max_memory_allocated())
    waves = len(sched.stats)
    serve_flash = launched["flash_attention"]
    check(waves == len(DENSE_PROMPTS), f"{waves} waves")
    check(serve_flash == cfg.n_layers * waves
          and kflash.flash_attention.launches == serve_flash,
          f"serving launched the flash routes {kflash.flash_attention.routes}"
          f", expected {cfg.n_layers} per prefill x {waves} on "
          f"{kflash.SM90_SOURCE.stem} only")
    print(f"{serve_flash} flash_attention launches = {cfg.n_layers} per "
          f"prefill x {waves} waves, all on {kflash.SM90_SOURCE.stem}.cu "
          f"(decode steps launch none)")
    for st, issued, peak in zip(sched.stats, issue_ms, peaks, strict=True):
        dec_ms = (st.wall_s - st.ttft_s) / max(st.steps - 1, 1) * 1e3
        print(f"wave {st.wave}: {st.batch} x {st.prompt_len} tokens: "
              f"prefill {st.ttft_s * 1e3:.1f} ms (until the first tokens are "
              f"on the host), decode {dec_ms:.2f} ms per token synchronised, "
              f"of which the host spends {statistics.median(issued):.2f} ms "
              f"issuing it (median of {len(issued)} steps); peak device "
              f"memory {peak / 2**30:.2f} GiB; wave {st.wall_s:.3f} s (host "
              f"clock) [{card}]")
    print(f"summary() {json.dumps(sched.summary())}; whole run "
          f"{serve_s:.3f} s")
    decode_profile(torch, np_, model, params, prompts[:SERVE_MAX_BATCH],
                   dev, card)
    for r in served:
        check(r.output is not None and len(r.output) == DENSE_NEW_TOKENS
              and bool(np_.all((r.output >= 0)
                               & (r.output < cfg.vocab_size))),
              f"request {r.rid}: malformed output {r.output}")
    for rid in DENSE_SERIAL:
        r = reqs[rid]
        one = WaveScheduler(model, params, max_batch=1)
        alone = Request(rid=rid, tokens=r.tokens,
                        max_new_tokens=DENSE_NEW_TOKENS)
        one.submit(alone)
        one.run()
        same = np_.array_equal(alone.output, r.output)
        where = "" if same else (f" from token "
                                 f"{int(np_.argmax(alone.output != r.output))}")
        print(f"request {rid} ({len(r.tokens)} tokens): batched output "
              f"{'equals' if same else 'differs from'} its batch-1 serial "
              f"decode{where}; first tokens {r.output[:6].tolist()}")
        check(same, f"request {rid}: batched != serial")

    # the depth cut: full width, DENSE_CUT_LAYERS layers, cuda vs cpu
    cut = cfg.replace(n_layers=DENSE_CUT_LAYERS)
    p_cut = dict(params, layers=tree_map(lambda x: x[:DENSE_CUT_LAYERS],
                                         params["layers"]))
    p_cpu = tree_map(lambda x: x.cpu(), p_cut)
    toks = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (2, DEPTH_CUT_PROMPT + DENSE_CUT_STEPS)),
        dtype=torch.int32)
    for name in ("bfloat16", "float32"):
        m = get_model(cut.replace(dtype=name))
        out = {}
        for where, p in (("cuda", p_cut), ("cpu", p_cpu)):
            d = dev if where == "cuda" else torch.device("cpu")
            logits, st = m.prefill_fn(
                p, {"tokens": toks[:, :DEPTH_CUT_PROMPT].to(d)})
            # copies: decode writes the cache it is given in place
            got = [x.to("cpu", torch.float32, copy=True)
                   for x in (logits, st["cache"]["k"], st["cache"]["v"])]
            for i in range(DENSE_CUT_STEPS):
                j = DEPTH_CUT_PROMPT + i
                step, st = m.decode_fn(p, st, {"token": toks[:, j:j + 1]
                                               .to(d)})
                got.append(step.float().cpu())
            got.append(st["cache"]["k"].float().cpu())
            out[where] = got
        whats = (["prefill logits", "prefill k cache", "prefill v cache"]
                 + [f"decode step {i + 1}" for i in range(DENSE_CUT_STEPS)]
                 + ["k cache after decode"])
        for what, a, b in zip(whats, out["cuda"], out["cpu"], strict=True):
            err = float((a - b).abs().max())
            check(a.shape == b.shape and torch.allclose(
                a, b, **LOGIT_TOL[name]),
                f"{DENSE_ARCH} depth cut {name} {what}: cuda vs cpu {err} "
                f"beyond {LOGIT_TOL[name]}")
            print(f"{DENSE_ARCH} depth cut {name:8s} {what:20s}: cuda vs cpu "
                  f"max abs diff {err:.3e} (scale {float(b.abs().max()):.2f};"
                  f" {LOGIT_TOL[name]})")
        del m, out
    del p_cpu, p_cut, params, sched, served, served_model, model
    torch.cuda.empty_cache()

    # one wave of stablelm-3b at full width: hd 80, the padded bf16 route
    cfg3 = get_config(PADDED_ARCH)
    model3 = get_model(cfg3)
    t0 = time.perf_counter()
    params3 = model3.init(torch.Generator(dev).manual_seed(SEED), dev)
    sync()
    init_s = time.perf_counter() - t0
    n3 = sum(x.numel() for x in tree_leaves(params3))
    plen, nreq = PADDED_PROMPTS
    sched3 = WaveScheduler(model3, params3, max_batch=SERVE_MAX_BATCH)
    for i in range(nreq):
        sched3.submit(Request(rid=i, tokens=rng.integers(
            0, cfg3.vocab_size, plen).astype(np_.int32),
            max_new_tokens=PADDED_NEW_TOKENS))
    torch.cuda.reset_peak_memory_stats()
    zero_counts(*counters)            # the counts to 0 just before the path
    served3 = sched3.run()
    sync()
    padded = kernel_counts(*counters)     # read just after
    padded_flash = padded["flash_attention"]
    check(padded_flash == cfg3.n_layers and padded["flash_attention_f32"]
          == 0,
          f"{PADDED_ARCH}: {padded_flash} sm90 flash launches, expected "
          f"{cfg3.n_layers}")
    check(all(len(r.output) == PADDED_NEW_TOKENS for r in served3),
          f"{PADDED_ARCH}: malformed outputs")
    st = sched3.stats[0]
    dec_ms = (st.wall_s - st.ttft_s) / max(st.steps - 1, 1) * 1e3
    print(f"{PADDED_ARCH}: {cfg3.n_layers} layers, d {cfg3.d_model}, "
          f"{cfg3.n_heads} heads of {cfg3.resolved_head_dim} (route "
          f"{kflash.head_route(cfg3.resolved_head_dim, torch.bfloat16)}), "
          f"{n3} f32 params drawn in {init_s:.2f} s; one wave of {nreq} x "
          f"{plen} tokens: prefill {st.ttft_s * 1e3:.1f} ms, decode "
          f"{dec_ms:.2f} ms per token, {padded_flash} flash launches on "
          f"{kflash.SM90_SOURCE.stem}.cu at width 128; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    decode_profile(torch, np_, model3, params3,
                   [r.tokens for r in served3], dev, card)
    del params3, sched3, served3, model3
    torch.cuda.empty_cache()
    serving = {k: launched[k] + padded[k] for k in launched}

    # ---- 23. federated LM rounds ---------------------------------------
    phase(f"23. federated LM rounds on cuda: launch/train.py (stablelm-1.6b "
          f"reduced, pso, {FL_CLIENTS} clients, {FL_ROUNDS} rounds), then "
          f"the batched engine on cuda vs cpu for {', '.join(FL_ARCHS)} "
          f"reduced (float32)")
    # the CPU rehearsal's count: each flash or scan call, and each one
    # that will run a backward, counted on both devices at the entry the
    # models call (the kernels count only their own launches)
    calls = {}
    fwd_flash, fwd_scan = ops.flash_attention, ops.rglru_scan

    def counting(fn, name):
        def call(*args, **kw):
            grad = torch.is_grad_enabled() and any(
                x.requires_grad for x in args)
            calls[name] = calls.get(name, 0) + 1
            calls[name + "_bwd"] = calls.get(name + "_bwd", 0) + int(grad)
            return fn(*args, **kw)
        return call

    out_json = ROOT / "build" / "train_lm.json"
    out_json.parent.mkdir(parents=True, exist_ok=True)
    zero_counts(*counters)            # the counts to 0 just before the path
    t0 = time.perf_counter()
    code = train_main(["--arch", "stablelm-1.6b", "--strategy", "pso",
                       "--clients", str(FL_CLIENTS), "--rounds",
                       str(FL_ROUNDS), "--batch-size", str(FL_TRAIN_BATCH),
                       "--out", str(out_json)], device=dev)
    sync()
    train_s = time.perf_counter() - t0
    record = json.loads(out_json.read_text())
    losses = [r["loss"] for r in record["rounds"]]
    check(code == 0 and len(losses) == FL_ROUNDS
          and all(math.isfinite(x) for x in losses),
          f"launch/train.py: exit {code}, losses {losses}")
    by_train = kernel_counts(*counters)
    print(f"launch/train.py --arch stablelm-1.6b (reduced, bf16 compute): "
          f"exit {code}, {train_s:.2f} s, losses {losses}, placements "
          f"{[r['placement'] for r in record['rounds']]}; launches "
          f"{json.dumps({k: v for k, v in by_train.items() if v})}")

    runs = {}
    ops.flash_attention = counting(fwd_flash, "flash")
    ops.rglru_scan = counting(fwd_scan, "scan")
    try:
        for dev_name in ("cuda", "cpu"):
            if dev_name == "cuda":
                zero_counts(*counters)    # the counts to 0 just before
            for arch in FL_ARCHS:
                calls.clear()
                fl_cfg = get_config(arch).reduced().replace(dtype="float32")
                h = Hierarchy(depth=2, width=2, trainers_per_leaf=1,
                              n_clients=FL_CLIENTS)
                pool = ClientPool.random(h.total_clients, seed=SEED)
                orch = FederatedOrchestrator(
                    get_model(fl_cfg), h, pool, make_federated_dataset(
                        fl_cfg, h.total_clients, SEED, FL_SEQ),
                    local_steps=FL_LOCAL_STEPS, batch_size=FL_BATCH,
                    seed=SEED, timing="deterministic", device=dev_name)
                # both devices start from the cuda run's initial params
                init = tree_map(lambda x: x.cpu(), orch.params) \
                    if dev_name == "cuda" else runs["cuda", arch][2]
                orch.set_global(tree_map(
                    lambda x: x.to(dev_name).clone(), init))
                t1 = time.perf_counter()
                res = orch.run(create_strategy("pso", h, seed=SEED),
                               rounds=FL_ROUNDS)
                if dev_name == "cuda":
                    sync()
                runs[dev_name, arch] = (res, dict(calls), init,
                                        time.perf_counter() - t1,
                                        tree_map(lambda x: x.cpu(),
                                                 orch.params), h.depth)
            if dev_name == "cuda":
                fl_counts = kernel_counts(*counters)   # read just after
    finally:
        ops.flash_attention, ops.rglru_scan = fwd_flash, fwd_scan
    engine = fl_counts
    federated = {k: by_train[k] + engine[k] for k in engine}
    for arch in FL_ARCHS:
        got, got_calls, _, got_s, got_p, depth = runs["cuda", arch]
        want, want_calls, _, want_s, want_p, _ = runs["cpu", arch]
        check([r.placement for r in got.rounds]
              == [r.placement for r in want.rounds]
              and got.tpds.tolist() == want.tpds.tolist(),
              f"{arch}: placements or TPDs differ between cuda and cpu")
        gl = [r.loss for r in got.rounds]
        wl = [r.loss for r in want.rounds]
        rel = max(abs(a - b) / abs(b) for a, b in zip(gl, wl, strict=True))
        check(all(math.isfinite(x) for x in gl) and rel <= LOSS_RTOL,
              f"{arch}: losses {gl} on cuda vs {wl} on cpu (rtol "
              f"{LOSS_RTOL})")
        outside = sum(int((~torch.isclose(a, b, **PARAM_TOL)).sum())
                      for a, b in zip(tree_leaves(got_p), tree_leaves(want_p),
                                      strict=True))
        check(got_calls == want_calls,
              f"{arch}: flash/scan calls {got_calls} on cuda, "
              f"{want_calls} on cpu")
        print(f"{arch} reduced f32, {FL_ROUNDS} rounds of pso: placements "
              f"and TPDs equal to the cpu run's ({got.tpds.tolist()}); "
              f"losses {gl} (largest rel diff to cpu {rel:.2e}, rtol "
              f"{LOSS_RTOL}); {outside} final params outside rtol 1e-3 / "
              f"atol 1e-5; entry calls {json.dumps(got_calls)} (equal on "
              f"cpu); {got_s:.2f} s on cuda, {want_s:.2f} s on cpu (host "
              f"clock) [{card}]")
    want_calls = [runs["cpu", arch][1] for arch in FL_ARCHS]
    expect = {
        "flash_attention_f32": sum(c.get("flash", 0) for c in want_calls),
        "flash_attention_bwd_f32": 3 * sum(c.get("flash_bwd", 0)
                                           for c in want_calls),
        "rglru_scan": sum(c.get("scan", 0) for c in want_calls),
        "rglru_scan_bwd": sum(c.get("scan_bwd", 0) for c in want_calls),
        "fedavg_batched": sum((1 + FL_ROUNDS) * runs["cpu", arch][5]
                              for arch in FL_ARCHS)}
    got_engine = {k: engine[k] for k in expect}
    check(got_engine == expect and all(v > 0 for v in expect.values()),
          f"batched engine on cuda launched {got_engine}, the CPU "
          f"rehearsal's count is {expect}")
    print(f"batched engine launches on cuda {json.dumps(got_engine)} = the "
          f"CPU rehearsal's count (flash and scan calls at the model's "
          f"entry, 3 launches a flash backward, (warm-up + {FL_ROUNDS} "
          f"rounds) x tree levels of FedAvg); tpd {engine['tpd']} (the "
          f"emulated PSO is black-box: it scores no swarm)")
    return {k: {"granite-8b and stablelm-3b serving (phase 22)": serving[k],
                "federated LM rounds (phase 23)": federated[k]}
            for k in serving}


# ---- the moe family (phase 24) --------------------------------------------
MOE_ARCH = "granite-moe-1b-a400m"
MOE_BIG_ARCH = "qwen3-moe-235b-a22b"
MOE_PROMPTS = ((1024, 4), (4096, 4))     # as phase 22: 2 waves of 4
MOE_NEW_TOKENS = SERVE_NEW_TOKENS
MOE_FFN_SHAPE = (4, 1024)               # (c): one layer's moe_ffn, B x S
MOE_ROUTING_SHARE = 0.999               # (c): routing choices card = host
MOE_CUT_LAYERS = 2                      # (e), (f): the depth cuts
MOE_BIG_WAVE, MOE_BIG_NEW = (1024, 4), 16
MOE_BIG_CPU_PROMPT = 256                # (f): 1 x 256 held to the CPU
MOE_TRAIN_STEPS, MOE_TRAIN_TOKENS = 4, 2048
# (e): bf16 as tests/test_serve_consistency.py holds the moe family
# (logits within rtol 3e-2, atol 0.5; greedy tokens equal unless the
# CPU's top-2 gap is inside 2 x 0.5, where the card's token must sit
# within 1.0 of the top); float32 as phase 22's cut
MOE_BF16_TOL = dict(rtol=3e-2, atol=0.5)
# the depth cuts' own routing, card vs host: the share of routing choices
# that agree (float32 as (c); bf16 roundings move near-ties: 0.989430
# read on the H100) and the bf16 logits' max abs diff under the card's
# own routing (0.566 the largest read on the H100, in the prefill)
MOE_CUT_ROUTING_SHARE = {"float32": MOE_ROUTING_SHARE, "bfloat16": 0.98}
MOE_BF16_FREE_ATOL = 0.75


def moe_layer_profile(torch, moe, layer, cfg, x, card, what):
    """One full-width moe layer at ``x`` (B, S, D) on the card, split into
    its stages, each timed alone on that stage's real inputs (CUDA
    events, host enqueue hidden); the expert products against their
    float32 bound. Returns {stage: ms}."""
    b, s, d = x.shape
    t = b * s
    k, e, f = cfg.top_k, cfg.n_experts, cfg.d_ff_expert
    x2d = x.reshape(t, d)
    router = layer["router"]
    probs = torch.softmax(torch.matmul(x2d.float(), router), dim=-1)
    gates, _, choices = moe.route(x2d, router, k)
    cap = min(moe.capacity_of(t, cfg), t)
    gw, gi = moe.top_k(gates.t(), cap)
    xe = x2d[gi]
    w = (layer["w_gate"], layer["w_up"], layer["w_down"])
    ye = moe.expert_ffn(xe, gw, *w)
    stages = {
        "router (f32 product, softmax)": lambda: torch.softmax(
            torch.matmul(x2d.float(), router), dim=-1),
        "routing top-k (sort over E)": lambda: moe.top_k(probs, k),
        "whole route (+ renorm, scatter, aux)": lambda: moe.route(
            x2d, router, k),
        "capacity top-k (sort over T)": lambda: moe.top_k(gates.t(), cap),
        "gather x[gi]": lambda: x2d[gi],
        "expert products (3 bmm, silu, gates)": lambda: moe.expert_ffn(
            xe, gw, *w),
        "combine (inverse map, gather, sum)": lambda: moe.combine(
            ye, gi, choices, t),
        "moe_ffn whole": lambda: moe.moe_ffn(layer, x, cfg),
    }
    ms = {name: median_device_ms(torch, fn, runs=9, per_run=5)
          for name, fn in stages.items()}
    flops = 6 * e * cap * d * f
    nbytes = 4 * (3 * e * d * f + 2 * e * cap * d + e * cap)
    bound = max(flops / PEAK_F32_FMA_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    by = "operations" if flops / PEAK_F32_FMA_FLOPS > \
        nbytes / HBM_BYTES_PER_S else "bytes"
    prod = ms["expert products (3 bmm, silu, gates)"]
    print(f"moe layer profile, {what} (T {t}, E {e}, top {k}, capacity "
          f"{cap}), device time per call: " + "; ".join(
              f"{n} {v:.4f} ms" for n, v in ms.items())
          + f"; expert products {flops:.3e} flops, {nbytes} B: float32 "
          f"bound {bound:.4f} ms (by {by}: 67 TFLOP/s outside the tensor "
          f"cores, 3.35 TB/s), {bound / prod * 100:.1f}% of it [{card}]")
    return ms


def moe_phases(torch, np_, dev, card):
    """Phase 24: the moe family on cuda. Returns each kernel's launches
    over its main paths: {kernel name: {path: launches}}."""
    from repro_torch.configs import get_config
    from repro_torch.core.hierarchy import ClientPool, Hierarchy
    from repro_torch.core.registry import create_strategy
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.fl.orchestrator import FederatedOrchestrator
    from repro_torch.kernels import fedavg as kfedavg
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import fused_adamw as kadamw
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru as krglru
    from repro_torch.kernels import tpd as ktpd
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import get_model, moe
    from repro_torch.optim import adamw
    from repro_torch.serving import Request, WaveScheduler
    from repro_torch.train import TrainLoop, TrainLoopConfig
    from repro_torch.utils.trees import tree_leaves, tree_map

    sync = torch.cuda.synchronize
    counters = (kflash, krglru, kfedavg, ktpd, kadamw)
    phase_t0 = time.perf_counter()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    check(held < 8 * 2 ** 30, f"{held} bytes still held on the card "
                              f"before phase 24")
    cfg = get_config(MOE_ARCH)
    mc = cfg.moe
    phase(f"24. MoE on cuda: {MOE_ARCH} moe_ffn, serving, depth cuts and "
          f"training; {MOE_BIG_ARCH} cut to {MOE_CUT_LAYERS} layers; "
          f"federated MoE rounds")
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(SEED), dev)
    sync()
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(1.38e9 < n_params < 1.39e9, f"{MOE_ARCH} holds {n_params} params")
    print(f"{MOE_ARCH}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv heads of "
          f"{cfg.resolved_head_dim}, {mc.n_experts} experts of F "
          f"{mc.d_ff_expert}, top {mc.top_k}, capacity factor "
          f"{mc.capacity_factor}; {n_params} f32 params "
          f"({n_params * 4 / 1e9:.2f} GB) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")

    # ---- (c) one layer's moe_ffn, card vs host ---------------------------
    layer = tree_map(lambda x: x[0], params["layers"]["moe"])
    layer_cpu = tree_map(lambda x: x.cpu(), layer)
    gen = torch.Generator(dev).manual_seed(SEED + 24)
    x = torch.randn(*MOE_FFN_SHAPE, cfg.d_model, device=dev, generator=gen)
    out, aux = moe.moe_ffn(layer, x, mc)
    again, aux2 = moe.moe_ffn(layer, x, mc)
    sync()
    want, want_aux = moe.moe_ffn(layer_cpu, x.cpu(), mc)
    t_ = x.shape[0] * x.shape[1]
    _, _, got_i = moe.route(x.reshape(t_, -1), layer["router"], mc.top_k)
    _, _, want_i = moe.route(x.cpu().reshape(t_, -1), layer_cpu["router"],
                             mc.top_k)
    share = float((got_i.cpu().sort(-1).values
                   == want_i.sort(-1).values).float().mean())
    err = float((out.cpu() - want).abs().max())
    tok_err = (out.cpu() - want).abs().amax(-1)
    print(f"(c) moe_ffn, one full-width layer, {MOE_FFN_SHAPE[0]} x "
          f"{MOE_FFN_SHAPE[1]} f32 tokens (capacity "
          f"{moe.capacity_of(t_, mc)}): routing choices equal to the "
          f"host's {share:.6f} (at least {MOE_ROUTING_SHARE}); outputs max "
          f"abs err {err:.3e} (scale {float(want.abs().max()):.3f}), "
          f"{int((tok_err > 1e-4).sum())} of {t_} tokens beyond 1e-4; aux "
          f"{float(aux):.6f} vs {float(want_aux):.6f}; two card runs "
          f"bit-equal {torch.equal(out, again) and torch.equal(aux, aux2)}")
    check(share >= MOE_ROUTING_SHARE, f"(c) routing share {share}")
    check(torch.equal(out, again) and torch.equal(aux, aux2),
          "(c) two card runs of moe_ffn differ")
    check(abs(float(aux) - float(want_aux)) <= 1e-5,
          f"(c) aux {float(aux)} vs {float(want_aux)}")
    check(float((tok_err <= 1e-4 + 1e-4 * want.abs().amax(-1)).float()
                .mean()) >= 0.99, f"(c) outputs: max abs err {err}")
    # the layer's profile at prefill (4 x 1024) and decode (B 4)
    moe_layer_profile(torch, moe, layer, mc, x, card,
                      f"prefill {x.shape[0]} x {x.shape[1]}")
    moe_layer_profile(torch, moe, layer, mc, x[:, :1].contiguous(), card,
                      f"decode B {x.shape[0]}")
    del out, again, want, x, layer_cpu

    # ---- (d) full-width serving -------------------------------------------
    rng = np_.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, plen).astype(np_.int32)
               for plen, n in MOE_PROMPTS for _ in range(n)]

    def serve(max_batch):
        sched = WaveScheduler(model, params, max_batch=max_batch)
        reqs = [Request(rid=i, tokens=tk, max_new_tokens=MOE_NEW_TOKENS)
                for i, tk in enumerate(prompts)]
        for r in reqs:
            sched.submit(r)
        sched.run()
        return sched, [r.output for r in reqs]

    torch.cuda.reset_peak_memory_stats()
    zero_counts(*counters)            # the counts to 0 just before the path
    t0 = time.perf_counter()
    sched, outs = serve(SERVE_MAX_BATCH)
    sync()
    serve_s = time.perf_counter() - t0
    serving = kernel_counts(*counters)    # read just after
    peak = torch.cuda.max_memory_allocated()
    waves = len(sched.stats)
    check(waves == len(MOE_PROMPTS)
          and serving["flash_attention"] == cfg.n_layers * waves
          and kflash.flash_attention.launches == serving["flash_attention"],
          f"(d) {waves} waves, flash routes {kflash.flash_attention.routes}"
          f"; expected {cfg.n_layers} sm90 launches a wave")
    for st in sched.stats:
        dec_ms = (st.wall_s - st.ttft_s) / max(st.steps - 1, 1) * 1e3
        print(f"(d) wave {st.wave}: {st.batch} x {st.prompt_len} tokens: "
              f"prefill {st.ttft_s * 1e3:.1f} ms (until the first tokens are "
              f"on the host), decode {dec_ms:.2f} ms per token synchronised "
              f"[{card}]")
    print(f"(d) {serving['flash_attention']} flash_attention launches = "
          f"{cfg.n_layers} per prefill x {waves} waves on "
          f"{kflash.SM90_SOURCE.stem}.cu (hd {cfg.resolved_head_dim}); peak "
          f"device memory {peak / 2**30:.2f} GiB; whole run {serve_s:.3f} s "
          f"[{card}]")
    for r, o in enumerate(outs):
        check(o is not None and len(o) == MOE_NEW_TOKENS
              and bool(np_.all((o >= 0) & (o < cfg.vocab_size))),
              f"(d) request {r}: malformed output {o}")
    decode_profile(torch, np_, model, params, prompts[:SERVE_MAX_BATCH],
                   dev, card)

    def direct(p_model, p_params):
        """prefill_fn + decode_fn over the scheduler's waves: (tokens a
        request, every step's logits)."""
        toks, logits_all = [], []
        for plen, n in MOE_PROMPTS:
            wave = [tk for tk in prompts if len(tk) == plen][:n]
            logits, state = p_model.prefill_fn(p_params, {"tokens": torch.as_tensor(
                np_.stack(wave)).to(dev)})
            got = []
            for step in range(MOE_NEW_TOKENS):
                logits_all.append(logits)
                tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
                got.append(tok.cpu().numpy())
                if step + 1 < MOE_NEW_TOKENS:
                    logits, state = p_model.decode_fn(
                        p_params, state, {"token": tok[:, None]})
            toks.extend(np_.stack(got, axis=1))
            del state
        return toks, logits_all

    first, logits_a = direct(model, params)
    second, logits_b = direct(model, params)
    same_served = all(np_.array_equal(a, b) for a, b in zip(outs, first))
    bit_equal = all(torch.equal(a, b) for a, b in zip(logits_a, logits_b))
    sched2, outs2 = serve(SERVE_MAX_BATCH)
    rerun = all(np_.array_equal(a, b) for a, b in zip(outs, outs2))
    for st in sched2.stats:
        dec_ms = (st.wall_s - st.ttft_s) / max(st.steps - 1, 1) * 1e3
        print(f"(d) second run, wave {st.wave}: {st.batch} x "
              f"{st.prompt_len} tokens: prefill {st.ttft_s * 1e3:.1f} ms, "
              f"decode {dec_ms:.2f} ms per token synchronised [{card}]")
    check(same_served, "(d) served outputs differ from the direct "
                       "prefill_fn + decode_fn loop over the same waves")
    check(bit_equal and rerun, f"(d) reruns differ: logits bit-equal "
                               f"{bit_equal}, served tokens {rerun}")
    del logits_a, logits_b
    _, serial = serve(1)
    n_same = sum(np_.array_equal(a, b) for a, b in zip(outs, serial))
    parts = [int(np_.argmax(a != b)) for a, b in zip(outs, serial)
             if not np_.array_equal(a, b)]
    print(f"(d) served outputs equal the direct prefill_fn + decode_fn loop "
          f"over the same waves; a second direct run's logits bit-equal, a "
          f"second scheduler run's tokens equal; batch-1 serial runs: "
          f"{n_same} of {len(outs)} requests' tokens equal to their wave's "
          f"(capacity spans the wave, as in the reference; the others part "
          f"from tokens {parts})")

    # ---- (e) the depth cut vs the CPU --------------------------------------
    cut = cfg.replace(n_layers=MOE_CUT_LAYERS)
    p_cut = dict(params, layers=tree_map(lambda x: x[:MOE_CUT_LAYERS],
                                         params["layers"]))
    p_cpu = tree_map(lambda x: x.cpu(), p_cut)
    toks = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (2, DEPTH_CUT_PROMPT + DENSE_CUT_STEPS)),
        dtype=torch.int32)
    moe_cut_check(torch, np_, moe, get_model, cut, p_cut, p_cpu, toks,
                  DEPTH_CUT_PROMPT, DENSE_CUT_STEPS, dev, MOE_ARCH, "(e)")
    del p_cut, p_cpu, sched, sched2, outs, outs2, serial, first, second

    # ---- (g) training ------------------------------------------------------
    del params, layer
    torch.cuda.empty_cache()
    ds = SyntheticLMDataset(cfg.vocab_size, MOE_TRAIN_TOKENS, seed=SEED)
    stamps = []

    def batch_fn(step):
        sync()
        stamps.append(time.perf_counter())
        return ds.batch(1, step)

    torch.cuda.reset_peak_memory_stats()
    loop = TrainLoop(model, adamw(3e-4), batch_fn,
                     TrainLoopConfig(total_steps=MOE_TRAIN_STEPS, log_every=1,
                                     checkpoint_dir=None),
                     seed=SEED, device=dev)
    check(cfg.remat, f"{MOE_ARCH} trains without remat")
    zero_counts(*counters)            # the counts to 0 just before the path
    res = loop.run()
    sync()
    stamps.append(time.perf_counter())
    training = kernel_counts(*counters)   # read just after
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in res["metrics_log"]]
    auxes = [m["moe_aux"] for m in res["metrics_log"]]
    steps_s = [b - a for a, b in zip(stamps, stamps[1:])]
    print(f"(g) TrainLoop, {MOE_TRAIN_STEPS} steps of 1 x {MOE_TRAIN_TOKENS} "
          f"tokens, remat on: losses {losses}, moe_aux {auxes}; steps "
          f"{[round(s * 1e3, 1) for s in steps_s]} ms (median of steps 2-"
          f"{MOE_TRAIN_STEPS} {statistics.median(steps_s[1:]) * 1e3:.1f} ms)"
          f"; peak device memory {peak / 2**30:.2f} GiB; launches "
          f"{json.dumps({k: v for k, v in training.items() if v})} [{card}]")
    check(len(losses) == MOE_TRAIN_STEPS
          and all(math.isfinite(v) for v in losses + auxes),
          f"(g) losses {losses}, moe_aux {auxes}")
    check(training["fused_adamw"] == MOE_TRAIN_STEPS
          and training["flash_attention"] == 2 * cfg.n_layers
          * MOE_TRAIN_STEPS and training["flash_attention_bwd"]
          == 3 * cfg.n_layers * MOE_TRAIN_STEPS,
          f"(g) launches {training}: expected {MOE_TRAIN_STEPS} AdamW, "
          f"{cfg.n_layers} x 2 flash forwards (remat) and 3 backward "
          f"launches a layer a step")
    step_profile(torch, loop, batch_fn(MOE_TRAIN_STEPS), card)
    del loop, res
    torch.cuda.empty_cache()

    # ---- (f) qwen3-moe cut to 2 layers -------------------------------------
    big = get_config(MOE_BIG_ARCH).replace(n_layers=MOE_CUT_LAYERS)
    big_model = get_model(big)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    big_params = big_model.init(torch.Generator(dev).manual_seed(SEED), dev)
    sync()
    n_big = sum(x.numel() for x in tree_leaves(big_params))
    init_peak = torch.cuda.max_memory_allocated()
    check(6.2e9 < n_big < 6.25e9, f"{MOE_BIG_ARCH} cut holds {n_big}")
    plen, nreq = MOE_BIG_WAVE
    sched_b = WaveScheduler(big_model, big_params, max_batch=SERVE_MAX_BATCH)
    for i in range(nreq):
        sched_b.submit(Request(rid=i, tokens=rng.integers(
            0, big.vocab_size, plen).astype(np_.int32),
            max_new_tokens=MOE_BIG_NEW))
    torch.cuda.reset_peak_memory_stats()
    zero_counts(*counters)            # the counts to 0 just before the path
    served_b = sched_b.run()
    sync()
    big_serving = kernel_counts(*counters)    # read just after
    st = sched_b.stats[0]
    dec_ms = (st.wall_s - st.ttft_s) / max(st.steps - 1, 1) * 1e3
    print(f"(f) {MOE_BIG_ARCH} at full width cut to {MOE_CUT_LAYERS} layers "
          f"(d {big.d_model}, {big.n_heads} heads / {big.n_kv_heads} kv of "
          f"{big.resolved_head_dim}, rope theta {big.rope_theta:g}, "
          f"{big.moe.n_experts} experts of F {big.moe.d_ff_expert}): "
          f"{n_big} f32 params ({n_big * 4 / 1e9:.2f} GB) drawn in "
          f"{time.perf_counter() - t0:.2f} s (peak {init_peak / 2**30:.2f} "
          f"GiB while drawing); one wave of {nreq} x {plen} tokens: prefill "
          f"{st.ttft_s * 1e3:.1f} ms, decode {dec_ms:.2f} ms per token, "
          f"{big_serving['flash_attention']} flash launches; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"[{card}]")
    check(big_serving["flash_attention"] == MOE_CUT_LAYERS
          and all(len(r.output) == MOE_BIG_NEW for r in served_b),
          f"(f) flash launches {big_serving}, outputs "
          f"{[r.output for r in served_b]}")
    big_cpu = tree_map(lambda x: x.cpu(), big_params)
    toks = torch.as_tensor(rng.integers(
        0, big.vocab_size, (1, MOE_BIG_CPU_PROMPT + DENSE_CUT_STEPS)),
        dtype=torch.int32)
    moe_cut_check(torch, np_, moe, get_model, big, big_params, big_cpu, toks,
                  MOE_BIG_CPU_PROMPT, DENSE_CUT_STEPS, dev, MOE_BIG_ARCH,
                  "(f)", dtypes=("float32",))
    del big_params, big_cpu, sched_b, served_b, big_model
    torch.cuda.empty_cache()

    # ---- (h) federated MoE rounds ------------------------------------------
    out_json = ROOT / "build" / "train_moe.json"
    out_json.parent.mkdir(parents=True, exist_ok=True)
    zero_counts(*counters)            # the counts to 0 just before the path
    code = train_main(["--arch", MOE_ARCH, "--strategy", "pso", "--clients",
                       str(FL_CLIENTS), "--rounds", str(FL_ROUNDS),
                       "--batch-size", str(FL_TRAIN_BATCH), "--out",
                       str(out_json)], device=dev)
    sync()
    by_train = kernel_counts(*counters)   # read just after
    record = json.loads(out_json.read_text())
    losses = [r["loss"] for r in record["rounds"]]
    check(code == 0 and len(losses) == FL_ROUNDS
          and all(math.isfinite(v) for v in losses),
          f"(h) launch/train.py: exit {code}, losses {losses}")
    print(f"(h) launch/train.py --arch {MOE_ARCH} (reduced, bf16 compute): "
          f"exit {code}, losses {losses}; launches "
          f"{json.dumps({k: v for k, v in by_train.items() if v})}")
    calls = {}
    fwd_flash = ops.flash_attention

    def counting(*args, **kw):
        grad = torch.is_grad_enabled() and any(x.requires_grad for x in args)
        calls["flash"] = calls.get("flash", 0) + 1
        calls["flash_bwd"] = calls.get("flash_bwd", 0) + int(grad)
        return fwd_flash(*args, **kw)

    runs = {}
    fl_cfg = cfg.reduced().replace(dtype="float32")
    ops.flash_attention = counting
    try:
        for dev_name in ("cuda", "cpu"):
            calls.clear()
            h = Hierarchy(depth=2, width=2, trainers_per_leaf=1,
                          n_clients=FL_CLIENTS)
            pool = ClientPool.random(h.total_clients, seed=SEED)
            orch = FederatedOrchestrator(
                get_model(fl_cfg), h, pool, make_federated_dataset(
                    fl_cfg, h.total_clients, SEED, FL_SEQ),
                local_steps=FL_LOCAL_STEPS, batch_size=FL_BATCH, seed=SEED,
                timing="deterministic", device=dev_name)
            init = tree_map(lambda x: x.cpu(), orch.params) \
                if dev_name == "cuda" else runs["cuda"][2]
            orch.set_global(tree_map(lambda x: x.to(orch.device).clone(),
                                     init))
            if dev_name == "cuda":
                zero_counts(*counters)    # the counts to 0 just before
            t1 = time.perf_counter()
            res = orch.run(create_strategy("pso", h, seed=SEED),
                           rounds=FL_ROUNDS)
            if dev_name == "cuda":
                sync()
                engine = kernel_counts(*counters)   # read just after
            runs[dev_name] = (res, dict(calls), init,
                              time.perf_counter() - t1, h.depth)
    finally:
        ops.flash_attention = fwd_flash
    got, got_calls, _, got_s, depth = runs["cuda"]
    want, want_calls, _, want_s, _ = runs["cpu"]
    gl, wl = [r.loss for r in got.rounds], [r.loss for r in want.rounds]
    rel = max(abs(a - b) / abs(b) for a, b in zip(gl, wl, strict=True))
    same = ([r.placement for r in got.rounds]
            == [r.placement for r in want.rounds]
            and got.tpds.tolist() == want.tpds.tolist())
    expect = {"flash_attention_f32": want_calls.get("flash", 0),
              "flash_attention_bwd_f32": 3 * want_calls.get("flash_bwd", 0),
              "fedavg_batched": (1 + FL_ROUNDS) * depth, "tpd": 0}
    got_engine = {k: engine[k] for k in expect}
    print(f"(h) {MOE_ARCH} reduced f32, batched engine, {FL_ROUNDS} rounds "
          f"of pso: placements {[r.placement for r in got.rounds]}, TPDs "
          f"{got.tpds.tolist()} (cpu: equal {same}); "
          f"losses {gl} vs {wl} on cpu (largest rel diff {rel:.2e}); "
          f"launches {json.dumps(got_engine)}, the CPU rehearsal's count "
          f"{json.dumps(expect)}; {got_s:.2f} s on cuda, {want_s:.2f} s on "
          f"cpu [{card}]")
    check(same, "(h) placements or TPDs differ between cuda and cpu")
    check(all(math.isfinite(v) for v in gl) and rel <= LOSS_RTOL,
          f"(h) losses {gl} vs {wl} (rtol {LOSS_RTOL})")
    check(got_calls == want_calls and got_engine == expect
          and expect["flash_attention_f32"] > 0,
          f"(h) calls {got_calls} vs {want_calls}; launches {got_engine} vs "
          f"{expect}")
    federated = {k: by_train[k] + engine[k] for k in engine}
    took = time.perf_counter() - phase_t0
    print(f"phase 24 took {took:.1f} s [{card}]")
    return {k: {f"{MOE_ARCH} serving (phase 24)": serving[k],
                f"{MOE_BIG_ARCH} cut serving (phase 24)": big_serving[k],
                f"{MOE_ARCH} training (phase 24)": training[k],
                "federated MoE rounds (phase 24)": federated[k]}
            for k in serving}


def greedy_in_band(torch, a, b, band):
    """tests/test_serve_consistency.py's rule on the last position's
    logits: the greedy token of ``a`` equals ``b``'s where ``b``'s top-2
    gap is wider than ``band``, else lies within ``band`` of its top."""
    ok = True
    for row_a, row_b in zip(a[:, -1], b[:, -1], strict=True):
        top2 = torch.topk(row_b, 2).values
        pick = int(row_a.argmax())
        if float(top2[0] - top2[1]) > band:
            ok &= pick == int(row_b.argmax())
        else:
            ok &= float(top2[0] - row_b[pick]) <= band
    return ok


def moe_cut_check(torch, np_, moe, get_model, cut, p_dev, p_cpu, toks, plen,
                  steps, dev, arch, tag, dtypes=("bfloat16", "float32")):
    """A moe depth cut on the card against the CPU from the same params:
    prefill of ``toks[:, :plen]`` and ``steps`` decode steps fed the next
    tokens, run three ways: on the CPU, on the card, and on the card with
    the CPU's routing (each ``moe.route`` call answered by the CPU run's
    gates and choices, in call order). The share of routing choices that
    agree is held to ``MOE_CUT_ROUTING_SHARE``. float32: the card's
    logits within phase 22's tolerance. bfloat16: greedy tokens agreeing
    outside the drift band of tests/test_serve_consistency.py, the
    logits within ``MOE_BF16_FREE_ATOL``, and under the CPU's routing
    within that test's rtol 3e-2 / atol 0.5 (bf16 roundings on two
    devices move routing near-ties, and each moved choice moves its
    token's logits)."""
    routes, replay = [], []
    real_route = moe.route

    def recording(x2d, router, k):
        out = replay.pop(0) if replay else real_route(x2d, router, k)
        out = tuple(v.to(x2d.device) for v in out)
        routes.append(out)
        return out

    def run(m, p, d):
        routes.clear()
        logits, st = m.prefill_fn(p, {"tokens": toks[:, :plen].to(d)})
        got = [logits.float().cpu()]
        for i in range(steps):
            step, st = m.decode_fn(p, st, {"token": toks[
                :, plen + i:plen + i + 1].to(d)})
            got.append(step.float().cpu())
        return got, [tuple(v.cpu() for v in r) for r in routes]

    moe.route = recording
    try:
        for name in dtypes:
            m = get_model(cut.replace(dtype=name))
            host, host_routes = run(m, p_cpu, torch.device("cpu"))
            card, card_routes = run(m, p_dev, dev)
            replay.extend(host_routes)
            forced, _ = run(m, p_dev, dev)
            check(not replay, f"{tag} {len(replay)} routing calls not "
                              f"replayed")
            share = float(torch.cat([
                (a[2].sort(-1).values == b[2].sort(-1).values)
                .float().flatten() for a, b in zip(
                    card_routes, host_routes, strict=True)]).mean())
            print(f"{tag} {arch} depth cut {name}: routing choices equal on "
                  f"both devices {share:.6f} (at least "
                  f"{MOE_CUT_ROUTING_SHARE[name]}; {len(host_routes)} "
                  f"routing calls)")
            check(share >= MOE_CUT_ROUTING_SHARE[name],
                  f"{tag} {arch} depth cut {name}: routing share {share}")
            whats = ["prefill logits"] + [f"decode step {i + 1}"
                                          for i in range(steps)]
            failed = []
            for what, a, f, b in zip(whats, card, forced, host, strict=True):
                err = float((a - b).abs().max())
                ferr = float((f - b).abs().max())
                if name == "bfloat16":
                    ok = bool(torch.allclose(f, b, **MOE_BF16_TOL)) \
                        and err <= MOE_BF16_FREE_ATOL \
                        and greedy_in_band(torch, a, b,
                                           2 * MOE_BF16_TOL["atol"])
                    tol = (f"greedy tokens, atol {MOE_BF16_FREE_ATOL}; "
                           f"{MOE_BF16_TOL} under the CPU's routing")
                else:
                    ok = bool(torch.allclose(a, b, **LOGIT_TOL[name]))
                    tol = str(LOGIT_TOL[name])
                if not (a.shape == b.shape and ok):
                    failed.append(f"{what} {err} ({ferr} under the CPU's "
                                  f"routing)")
                print(f"{tag} {arch} depth cut {name:8s} {what:16s}: cuda vs "
                      f"cpu max abs diff {err:.3e}, {ferr:.3e} under the "
                      f"CPU's routing (scale {float(b.abs().max()):.2f}; "
                      f"{tol}); greedy tokens "
                      f"{a[:, -1].argmax(-1).tolist()} vs "
                      f"{b[:, -1].argmax(-1).tolist()}")
            check(not failed, f"{tag} {arch} depth cut {name}: cuda vs cpu "
                              f"beyond {tol}: {failed}")
    finally:
        moe.route = real_route
        replay.clear()


# ---- the xLSTM (ssm) family (phase 25) ------------------------------------
XLSTM_ARCH = "xlstm-1.3b"
# one wave of 4 x 1024 (a chunk multiple): the 4 x 2048 wave (9.9-20.7 s
# of host-bound prefill and its serial twin) gave phase 26 its time
XLSTM_PROMPTS = ((512, 4),)             # 1024 before phase 30
XLSTM_NEW_TOKENS = SERVE_NEW_TOKENS
XLSTM_SERIAL = (0,)                     # one request of the wave, alone
XLSTM_BLOCK_SHAPE = (2, 512)            # (a): card vs host, float32
XLSTM_PROFILE_SHAPE = (4, 1024)         # (a): the stages' prefill (2048
                                        # before phase 30)
XLSTM_DECODE_REPS = 10                  # (a): decode calls a profile
XLSTM_PROFILE_TRIES = 3                 # (a): profiles a stage at most
XLSTM_CUT_LAYERS = 2                    # (c): one mLSTM, one sLSTM block
XLSTM_CUT_PROMPT = 512                  # (c): two chunks of 256
XLSTM_TRAIN_STEPS, XLSTM_TRAIN_TOKENS = 2, 2048
# (d) trains a full-width depth cut, 2 mLSTM and 2 sLSTM blocks: the
# full 48 (41-48 s a step, the sLSTM loop's host issue) left phase 27
# no time in the script's limit, and 8 (8.5-8.9 s a step) left the
# script too little room under its limit on a slower host
XLSTM_TRAIN_LAYERS = 4
XLSTM_PROFILE_TOKENS = 128              # (d): the step under the profiler
# float32, card vs host: (a) one block's output and final state (the
# H100 read 4.9e-4 at most, on the sLSTM's n of scale 21), (c) the cut's
# logits (6.6e-5 at most, scale 4.7)
XLSTM_BLOCK_TOL = dict(rtol=1e-3, atol=1e-3)
XLSTM_CUT_TOL = dict(rtol=2e-4, atol=2e-4)
# (c) bf16: greedy tokens by tests/test_serve_consistency.py's rule (its
# atol 3e-2 for a family without experts; a top-2 gap inside twice that
# is its drift band)
XLSTM_BF16_BAND = 2 * 3e-2


def profiled(torch, fn):
    """``fn()`` once under ``torch.profiler`` (CUDA activity), after a
    synchronise: (its result, device busy ms, kernel launches, host ms
    until the device is done, the kernels' events). One stream: the
    kernels do not overlap, so their sum is the device's busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum((getattr(e, "self_device_time_total", None) or
                getattr(e, "self_cuda_time_total", 0.0))
               for e in kernels) / 1e3
    return out, busy, sum(e.count for e in kernels), wall * 1e3, kernels


def host_ms(torch, fn):
    """``fn()``'s host time until the device is done (no profiler)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def xlstm_stage_profile(torch, xlstm, common, cfg, mblock, sblock, x, card,
                        what, m_state=None):
    """The stages of one full-width mLSTM and one sLSTM block at ``x``
    (R, S, D) in ``x``'s dtype, each call run once to warm up, then once
    under the profiler: device busy ms, launches, host ms. Prefill when
    ``m_state`` is None, else one decode step from it (its B rows; the
    stream's R rows are the model's padded decode rows). Where a stage
    is not a function of the model, it is the difference of two that
    are. Returns the sLSTM loop's (device ms, launches, host ms)."""
    decode = m_state is not None
    rows = x.shape[0]
    dt = x.dtype
    h = cfg.n_heads
    xn = common.rmsnorm(mblock["ln"], x, cfg.norm_eps)
    q, k, v, li, lf, _ = xlstm._mlstm_qkvif(mblock, xn, cfg)
    n = m_state["C"].shape[0] if decode else rows
    xs = common.rmsnorm(sblock["ln"], x, cfg.norm_eps)

    def in_proj():
        return (common.matmul(xs, sblock["w_in"].to(dt)).float()
                + sblock["b"].float())

    wx = common.pad_rows(in_proj().reshape(rows, x.shape[1], h, 4, -1),
                         common.row_bucket(rows))
    r32 = sblock["r"].float()
    st = xlstm.slstm_init_state(wx.shape[0], h, wx.shape[-1], x.device)
    stages = {
        "mLSTM block": lambda: xlstm.mlstm_block(mblock, x, cfg, m_state,
                                                 decode),
        "up projection": lambda: common.matmul(xn, mblock["w_up"].to(dt)),
        "_mlstm_qkvif": lambda: xlstm._mlstm_qkvif(mblock, xn, cfg),
        "mLSTM cell": (lambda: xlstm.mlstm_step(
            q[:n], k[:n], v[:n], li[:n], lf[:n], m_state)) if decode else
        (lambda: xlstm.mlstm_chunkwise(q, k, v, li, lf, cfg.xlstm_chunk)),
        "sLSTM block": lambda: xlstm.slstm_block(
            sblock, x, cfg, {k_: t[:n] for k_, t in st.items()}
            if decode else None, decode),
        "sLSTM input projection": in_proj,
        "sLSTM loop": (lambda: xlstm.slstm_cell(wx[:, 0], r32, st))
        if decode else (lambda: xlstm.slstm_scan(wx, r32, st)),
    }
    # a decode stage is short: XLSTM_DECODE_REPS calls a profile
    reps = XLSTM_DECODE_REPS if decode else 1
    got = {}
    for name, fn in stages.items():
        fn()
        # a short profile now and then records no device event (read on
        # the H100): up to XLSTM_PROFILE_TRIES tries
        for _ in range(XLSTM_PROFILE_TRIES):
            _, busy, launches, wall, _ = profiled(
                torch, lambda fn=fn: [fn() for _ in range(reps)])
            if launches:
                break
        got[name] = (busy / reps, launches / reps, wall / reps)
    derived = {"q/k/v/gates": ("_mlstm_qkvif", "up projection"),
               "out-norm and down": ("mLSTM block", "_mlstm_qkvif",
                                     "mLSTM cell"),
               "sLSTM out projection": ("sLSTM block",
                                        "sLSTM input projection",
                                        "sLSTM loop")}
    for name, (whole, *parts) in derived.items():
        got[name] = tuple(got[whole][i] - sum(got[p][i] for p in parts)
                          for i in range(2))
    order = ("up projection", "q/k/v/gates", "mLSTM cell",
             "out-norm and down", "mLSTM block", "sLSTM input projection",
             "sLSTM loop", "sLSTM out projection", "sLSTM block")
    print(f"(a) stages, {what} ({x.shape[0]} x {x.shape[1]} {dt}; each "
          f"under torch.profiler, {reps} call(s) a profile: device busy ms "
          f"/ launches / host ms a call; a stage that is no function of the "
          f"model is a difference of two, without host ms): " + "; ".join(
              f"{s_} {got[s_][0]:.3f} / {got[s_][1]:g}"
              + (f" / {got[s_][2]:.1f}" if len(got[s_]) == 3 else "")
              for s_ in order) + f" [{card}]")
    loop_host = host_ms(torch, stages["sLSTM loop"])
    busy, launches, _ = got["sLSTM loop"]
    launches = round(launches)
    steps = 1 if decode else x.shape[1]
    print(f"(a) sLSTM loop, {what}: {launches} launches over {steps} steps "
          f"({launches / steps:.1f} a step, {launches / (steps * n):.2f} a "
          f"token of the {n} requests); device busy {busy:.3f} ms against "
          f"host {loop_host:.3f} ms without the profiler "
          f"({busy / loop_host * 100:.1f}% busy) [{card}]")
    return busy, launches, loop_host


def xlstm_phases(torch, np_, dev, card):
    """Phase 25: the xLSTM (ssm) family on cuda. Returns each kernel's
    launches over its main paths: {kernel name: {path: launches}}."""
    from repro_torch.configs import get_config
    from repro_torch.core.hierarchy import ClientPool, Hierarchy
    from repro_torch.core.registry import create_strategy
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.fl.orchestrator import FederatedOrchestrator
    from repro_torch.kernels import fedavg as kfedavg
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import fused_adamw as kadamw
    from repro_torch.kernels import rglru as krglru
    from repro_torch.kernels import tpd as ktpd
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import common, get_model, xlstm
    from repro_torch.optim import adamw
    from repro_torch.serving import Request, WaveScheduler
    from repro_torch.train import TrainLoop, TrainLoopConfig
    from repro_torch.utils.trees import tree_leaves, tree_map

    sync = torch.cuda.synchronize
    counters = (kflash, krglru, kfedavg, ktpd, kadamw)
    phase_t0 = time.perf_counter()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    check(held < 8 * 2 ** 30, f"{held} bytes still held on the card "
                              f"before phase 25")
    cfg = get_config(XLSTM_ARCH)
    n_m, n_s = xlstm._block_counts(cfg)
    phase(f"25. xLSTM on cuda: {XLSTM_ARCH} blocks card vs host and their "
          f"stages, serving, a {XLSTM_CUT_LAYERS}-layer depth cut, training; "
          f"federated xLSTM rounds")
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(SEED), dev)
    sync()
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(2.62e9 < n_params < 2.63e9, f"{XLSTM_ARCH} holds {n_params} params")
    d_in = int(cfg.xlstm_proj_factor * cfg.d_model)
    print(f"{XLSTM_ARCH}: {n_m} mLSTM blocks (d_in {d_in}, {cfg.n_heads} "
          f"heads of {d_in // cfg.n_heads}, chunk {cfg.xlstm_chunk}), then "
          f"{n_s} sLSTM blocks ({cfg.n_heads} heads of "
          f"{cfg.d_model // cfg.n_heads}), d {cfg.d_model}, vocab "
          f"{cfg.vocab_size} (padded {cfg.padded_vocab}); {n_params} f32 "
          f"params ({n_params * 4 / 1e9:.2f} GB) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s; compute dtype {cfg.dtype}")

    # ---- (a) one block of each kind, card vs host, and their stages ------
    mblock = tree_map(lambda x: x[0], params["mlstm"])
    sblock = tree_map(lambda x: x[0], params["slstm"])
    f32 = cfg.replace(dtype="float32")
    gen = torch.Generator(dev).manual_seed(SEED + 25)
    x = torch.randn(*XLSTM_BLOCK_SHAPE, cfg.d_model, device=dev,
                    generator=gen)
    for name, fn, block in (("mLSTM", xlstm.mlstm_block, mblock),
                            ("sLSTM", xlstm.slstm_block, sblock)):
        outs = [fn(block, x, f32) for _ in range(2)]
        sync()
        want = fn(tree_map(lambda t: t.cpu(), block), x.cpu(), f32)
        got = [tree_leaves(o) for o in outs]
        rerun = all(torch.equal(a, b) for a, b in zip(*got, strict=True))
        errs = []
        for a, b in zip(got[0], tree_leaves(want), strict=True):
            a = a.cpu()
            errs.append((float((a - b).abs().max()), float(b.abs().max()),
                         bool(torch.allclose(a, b, **XLSTM_BLOCK_TOL))))
        print(f"(a) {name} block at {XLSTM_BLOCK_SHAPE[0]} x "
              f"{XLSTM_BLOCK_SHAPE[1]} float32, cuda vs cpu (output, then "
              f"the final state's leaves): max abs err "
              + ", ".join(f"{e:.3e} (scale {s:.3g})" for e, s, _ in errs)
              + f"; two card runs bit-equal {rerun} ({XLSTM_BLOCK_TOL})")
        check(rerun, f"(a) two card runs of the {name} block differ")
        check(all(ok for _, _, ok in errs),
              f"(a) {name} block: cuda vs cpu beyond {XLSTM_BLOCK_TOL}: "
              f"{errs}")
        del outs, want, got
    dt = getattr(torch, cfg.dtype)
    xp = torch.randn(*XLSTM_PROFILE_SHAPE, cfg.d_model, device=dev,
                     generator=gen).to(dt)
    loop_prefill = xlstm_stage_profile(
        torch, xlstm, common, cfg, mblock, sblock, xp, card,
        f"prefill {XLSTM_PROFILE_SHAPE[0]} x {XLSTM_PROFILE_SHAPE[1]}")
    b_dec = XLSTM_PROFILE_SHAPE[0]
    dh_m = d_in // cfg.n_heads
    m_state = {"C": torch.zeros(b_dec, cfg.n_heads, dh_m, dh_m, device=dev),
               "n": torch.zeros(b_dec, cfg.n_heads, dh_m, device=dev)}
    loop_decode = xlstm_stage_profile(
        torch, xlstm, common, cfg, mblock, sblock,
        common.pad_rows(xp[:, :1], common.row_bucket(b_dec)).contiguous(),
        card, f"decode B {b_dec}", m_state=m_state)
    del xp, m_state, x

    print(f"(a) done {time.perf_counter() - phase_t0:.1f} s into "
          f"phase 25")
    # ---- (b) full-width serving -------------------------------------------
    rng = np_.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, plen).astype(np_.int32)
               for plen, n in XLSTM_PROMPTS for _ in range(n)]
    reqs = [Request(rid=i, tokens=t, max_new_tokens=XLSTM_NEW_TOKENS)
            for i, t in enumerate(prompts)]
    issue_ms, peaks = [], []

    def timed_decode(p, state, batch):
        t1 = time.perf_counter()
        out = model.decode_fn(p, state, batch)
        issue_ms[-1].append((time.perf_counter() - t1) * 1e3)
        return out

    def wave_prefill(p, batch):
        if issue_ms:
            peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        issue_ms.append([])
        return model.prefill_fn(p, batch)

    sched = WaveScheduler(dataclasses.replace(
        model, prefill_fn=wave_prefill, decode_fn=timed_decode), params,
        max_batch=SERVE_MAX_BATCH)
    for r in reqs:
        sched.submit(r)
    zero_counts(*counters)            # the counts to 0 just before the path
    t0 = time.perf_counter()
    sched.run()
    sync()
    serve_s = time.perf_counter() - t0
    serving = kernel_counts(*counters)    # read just after
    peaks.append(torch.cuda.max_memory_allocated())
    check(len(sched.stats) == len(XLSTM_PROMPTS)
          and not any(serving.values()),
          f"(b) {len(sched.stats)} waves, launches {serving}: the xLSTM "
          f"serving path launches none of the port's kernels")
    for st, issued, peak in zip(sched.stats, issue_ms, peaks, strict=True):
        dec_ms = (st.wall_s - st.ttft_s) / max(st.steps - 1, 1) * 1e3
        print(f"(b) wave {st.wave}: {st.batch} x {st.prompt_len} tokens: "
              f"prefill {st.ttft_s * 1e3:.1f} ms (until the first tokens are "
              f"on the host), decode {dec_ms:.2f} ms per token synchronised, "
              f"of which the host spends {statistics.median(issued):.2f} ms "
              f"issuing it (median of {len(issued)} steps); peak device "
              f"memory {peak / 2**30:.2f} GiB [{card}]")
    print(f"(b) summary() {json.dumps(sched.summary())}; whole run "
          f"{serve_s:.3f} s; no kernel of the port on this path")
    for r in reqs:
        check(r.output is not None and len(r.output) == XLSTM_NEW_TOKENS
              and bool(np_.all((r.output >= 0)
                               & (r.output < cfg.vocab_size))),
              f"(b) request {r.rid}: malformed output {r.output}")
    for rid in XLSTM_SERIAL:
        r = reqs[rid]
        one = WaveScheduler(model, params, max_batch=1)
        alone = Request(rid=rid, tokens=r.tokens,
                        max_new_tokens=XLSTM_NEW_TOKENS)
        one.submit(alone)
        one.run()
        same = np_.array_equal(alone.output, r.output)
        print(f"(b) request {rid} ({len(r.tokens)} tokens): batched output "
              f"{'equals' if same else 'differs from'} its batch-1 serial "
              f"decode; first tokens {r.output[:6].tolist()}")
        check(same, f"(b) request {rid}: batched != serial")
    decode_profile(torch, np_, model, params, prompts[:SERVE_MAX_BATCH],
                   dev, card)

    print(f"(b) done {time.perf_counter() - phase_t0:.1f} s into "
          f"phase 25")
    # ---- (c) the depth cut vs the CPU --------------------------------------
    cut = cfg.replace(n_layers=XLSTM_CUT_LAYERS)
    p_cut = dict(params, mlstm=tree_map(lambda x: x[:1], params["mlstm"]),
                 slstm=tree_map(lambda x: x[:1], params["slstm"]))
    p_cpu = tree_map(lambda x: x.cpu(), p_cut)
    toks = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (2, XLSTM_CUT_PROMPT + DENSE_CUT_STEPS)),
        dtype=torch.int32)
    for name in ("float32", "bfloat16"):
        m = get_model(cut.replace(dtype=name))
        out = {}
        for where, p in (("cuda", p_cut), ("cpu", p_cpu)):
            d = dev if where == "cuda" else torch.device("cpu")
            logits, st = m.prefill_fn(
                p, {"tokens": toks[:, :XLSTM_CUT_PROMPT].to(d)})
            got = [logits.float().cpu()]
            for i in range(DENSE_CUT_STEPS):
                j = XLSTM_CUT_PROMPT + i
                logits, st = m.decode_fn(p, st, {"token": toks[:, j:j + 1]
                                                 .to(d)})
                got.append(logits.float().cpu())
            out[where] = got
        whats = ["prefill logits"] + [f"decode step {i + 1}"
                                      for i in range(DENSE_CUT_STEPS)]
        failed = []
        for what, a, b in zip(whats, out["cuda"], out["cpu"], strict=True):
            err = float((a - b).abs().max())
            if name == "float32":
                ok = bool(torch.allclose(a, b, **XLSTM_CUT_TOL))
                tol = str(XLSTM_CUT_TOL)
            else:
                ok = greedy_in_band(torch, a, b, XLSTM_BF16_BAND)
                tol = f"greedy tokens, drift band {XLSTM_BF16_BAND}"
            if not (a.shape == b.shape and ok):
                failed.append(f"{what} {err}")
            print(f"(c) {XLSTM_ARCH} depth cut {name:8s} {what:16s}: cuda vs "
                  f"cpu max abs diff {err:.3e} (scale "
                  f"{float(b.abs().max()):.2f}; {tol}); greedy tokens "
                  f"{a[:, -1].argmax(-1).tolist()} vs "
                  f"{b[:, -1].argmax(-1).tolist()}")
        check(not failed, f"(c) depth cut {name}: cuda vs cpu beyond {tol}: "
                          f"{failed}")
        del m, out
    del p_cut, p_cpu, sched, reqs, params, mblock, sblock
    torch.cuda.empty_cache()

    print(f"(c) done {time.perf_counter() - phase_t0:.1f} s into "
          f"phase 25")
    # ---- (d) training ----------------------------------------------------
    ds = SyntheticLMDataset(cfg.vocab_size, XLSTM_TRAIN_TOKENS, seed=SEED)
    stamps = []

    def batch_fn(step):
        sync()
        stamps.append(time.perf_counter())
        return ds.batch(1, step)

    torch.cuda.reset_peak_memory_stats()
    train_cfg = cfg.replace(n_layers=XLSTM_TRAIN_LAYERS)
    n_s_train = xlstm._block_counts(train_cfg)[1]
    loop = TrainLoop(get_model(train_cfg), adamw(3e-4), batch_fn,
                     TrainLoopConfig(total_steps=XLSTM_TRAIN_STEPS,
                                     log_every=1, checkpoint_dir=None),
                     seed=SEED, device=dev)
    check(train_cfg.remat, f"{XLSTM_ARCH} trains without remat")
    zero_counts(*counters)            # the counts to 0 just before the path
    res = loop.run()
    sync()
    stamps.append(time.perf_counter())
    training = kernel_counts(*counters)   # read just after
    peak = torch.cuda.max_memory_allocated()
    losses = [m_["loss"] for m_ in res["metrics_log"]]
    steps_s = [b - a for a, b in zip(stamps, stamps[1:])]
    print(f"(d) TrainLoop at a {XLSTM_TRAIN_LAYERS}-layer full-width cut, "
          f"{XLSTM_TRAIN_STEPS} steps of 1 x "
          f"{XLSTM_TRAIN_TOKENS} tokens, remat on, adamw: losses {losses}; "
          f"steps {[round(s_ * 1e3, 1) for s_ in steps_s]} ms; peak device "
          f"memory {peak / 2**30:.2f} GiB; launches "
          f"{json.dumps({k: v for k, v in training.items() if v})} "
          f"({time.perf_counter() - phase_t0:.1f} s into phase 25) "
          f"[{card}]")
    check(len(losses) == XLSTM_TRAIN_STEPS
          and all(math.isfinite(v) for v in losses), f"(d) losses {losses}")
    check(training["fused_adamw"] == XLSTM_TRAIN_STEPS
          and sum(training.values()) == XLSTM_TRAIN_STEPS,
          f"(d) launches {training}: expected one fused AdamW a step and "
          f"no other kernel of the port")
    # under the profiler, a step of XLSTM_PROFILE_TOKENS: one of 2048
    # launches ~1.6M kernels, more than the profiler's buffers are sure
    # to hold, and its trace takes minutes to read back
    short = SyntheticLMDataset(cfg.vocab_size, XLSTM_PROFILE_TOKENS,
                               seed=SEED)
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in short.batch(1, 0).items()}

    def one_step():
        loop.params, loop.opt_state, _ = loop.step_fn(
            loop.params, loop.opt_state, batch)

    one_step()
    _, busy, launches, wall, kernels = profiled(torch, one_step)
    check(busy > 0, "(d) the profiled step holds no device time")
    top = sorted(kernels, key=lambda e: getattr(
        e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0.0), reverse=True)[:6]
    print(f"(d) one step of 1 x {XLSTM_PROFILE_TOKENS} tokens under "
          f"torch.profiler: host {wall:.1f} ms, device busy {busy:.1f} ms "
          f"({busy / wall * 100:.1f}% of the step), {launches} launches; "
          f"top: " + "; ".join(f"{e.key[:50]} x{e.count}" for e in top)
          + f" ({time.perf_counter() - phase_t0:.1f} s into phase 25) "
          f"[{card}]")
    # the sLSTM loop alone (rows padded to 8): the remat forward runs it
    # twice, the backward once; its own backward beside autograd's
    # backward of the plain loop of slstm_cell
    sblock = tree_map(lambda x: x[0].detach(), loop.params["slstm"])
    rows = common.row_bucket(1)
    dh = cfg.d_model // cfg.n_heads
    r32 = sblock["r"].float()
    st = xlstm.slstm_init_state(rows, cfg.n_heads, dh, dev)
    loop_train = {}
    # at XLSTM_PROFILE_TOKENS only: the loop at 1 x 2048 (33.9 s of the
    # phase on an H100 80GB HBM3 at 700 W) was cut to make room for
    # phase 28; PERF.md keeps its earlier numbers
    for tokens in (XLSTM_PROFILE_TOKENS,):
        wx = torch.randn(rows, tokens, cfg.n_heads, 4, dh, device=dev,
                         generator=gen)

        def forward():
            with torch.no_grad():
                return xlstm.slstm_scan(wx, r32, st)

        def forward_backward(own):
            wg, rg = wx.clone().requires_grad_(), r32.clone().requires_grad_()
            hs = xlstm.slstm_scan(wg, rg, st)[0] if own else \
                xlstm._scan(wg, rg, st, keep=False)[0]
            hs.sum().backward()
            return wg.grad, rg.grad

        forward()
        _, f_busy, f_launch, f_wall, _ = profiled(torch, forward)
        own = forward_backward(True)
        _, fb_busy, fb_launch, fb_wall, _ = profiled(
            torch, lambda: forward_backward(True))
        plain = forward_backward(False)
        _, p_busy, p_launch, p_wall, _ = profiled(
            torch, lambda: forward_backward(False))
        autograd = (f"{p_busy:.1f} ms device / {p_launch} launches / "
                    f"{p_wall:.1f} ms host")
        gerr = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(own, plain, strict=True)]
        check(max(gerr) <= 1e-4, f"(d) the sLSTM loop's own backward "
                                 f"against autograd's: {gerr}")
        loop_train[tokens] = n_s_train * (f_busy + fb_busy)
        against = (f"the profiled step's {busy:.1f} ms device busy "
                   f"({loop_train[tokens] / busy * 100:.1f}%)")
        print(f"(d) the sLSTM loop at 1 x {tokens} ({rows} rows), one block: "
              f"forward {f_busy:.1f} ms device / {f_launch} launches / "
              f"{f_wall:.1f} ms host; forward + backward {fb_busy:.1f} / "
              f"{fb_launch} / {fb_wall:.1f} with its own backward, "
              f"{autograd} with autograd's backward of the plain loop; "
              f"gradients of wx and r agree to {max(gerr):.2e} of their "
              f"scale; x {n_s_train} blocks with remat's second forward "
              f"{loop_train[tokens]:.1f} ms device a step, against "
              f"{against} ({time.perf_counter() - phase_t0:.1f} s into "
              f"phase 25) [{card}]")
    del loop, res, sblock, wx, batch, short
    torch.cuda.empty_cache()

    print(f"(d) done {time.perf_counter() - phase_t0:.1f} s into "
          f"phase 25")
    # ---- (e) federated xLSTM rounds ----------------------------------------
    out_json = ROOT / "build" / "train_xlstm.json"
    out_json.parent.mkdir(parents=True, exist_ok=True)
    zero_counts(*counters)            # the counts to 0 just before the path
    code = train_main(["--arch", XLSTM_ARCH, "--strategy", "pso",
                       "--clients", str(FL_CLIENTS), "--rounds",
                       str(FL_ROUNDS), "--batch-size", str(FL_TRAIN_BATCH),
                       "--out", str(out_json)], device=dev)
    sync()
    by_train = kernel_counts(*counters)   # read just after
    record = json.loads(out_json.read_text())
    losses = [r["loss"] for r in record["rounds"]]
    check(code == 0 and len(losses) == FL_ROUNDS
          and all(math.isfinite(v) for v in losses),
          f"(e) launch/train.py: exit {code}, losses {losses}")
    print(f"(e) launch/train.py --arch {XLSTM_ARCH} (reduced, bf16 compute): "
          f"exit {code}, losses {losses}; launches "
          f"{json.dumps({k: v for k, v in by_train.items() if v})}")
    runs = {}
    fl_cfg = cfg.reduced().replace(dtype="float32")
    for dev_name in ("cuda", "cpu"):
        h = Hierarchy(depth=2, width=2, trainers_per_leaf=1,
                      n_clients=FL_CLIENTS)
        pool = ClientPool.random(h.total_clients, seed=SEED)
        orch = FederatedOrchestrator(
            get_model(fl_cfg), h, pool, make_federated_dataset(
                fl_cfg, h.total_clients, SEED, FL_SEQ),
            local_steps=FL_LOCAL_STEPS, batch_size=FL_BATCH, seed=SEED,
            timing="deterministic", device=dev_name)
        init = tree_map(lambda x: x.cpu(), orch.params) \
            if dev_name == "cuda" else runs["cuda"][1]
        orch.set_global(tree_map(lambda x: x.to(orch.device).clone(), init))
        if dev_name == "cuda":
            zero_counts(*counters)    # the counts to 0 just before
        t1 = time.perf_counter()
        res = orch.run(create_strategy("pso", h, seed=SEED), rounds=FL_ROUNDS)
        if dev_name == "cuda":
            sync()
            engine = kernel_counts(*counters)   # read just after
        runs[dev_name] = (res, init, time.perf_counter() - t1, h.depth)
    got, _, got_s, depth = runs["cuda"]
    want, _, want_s, _ = runs["cpu"]
    gl, wl = [r.loss for r in got.rounds], [r.loss for r in want.rounds]
    rel = max(abs(a - b) / abs(b) for a, b in zip(gl, wl, strict=True))
    same = ([r.placement for r in got.rounds]
            == [r.placement for r in want.rounds]
            and got.tpds.tolist() == want.tpds.tolist())
    expect = {k: 0 for k in engine}
    expect["fedavg_batched"] = (1 + FL_ROUNDS) * depth
    print(f"(e) {XLSTM_ARCH} reduced f32, batched engine, {FL_ROUNDS} rounds "
          f"of pso: placements {[r.placement for r in got.rounds]}, TPDs "
          f"{got.tpds.tolist()} (cpu: equal {same}); losses {gl} vs {wl} on "
          f"cpu (largest rel diff {rel:.2e}); launches "
          f"{json.dumps({k: v for k, v in engine.items() if v})}, the CPU "
          f"rehearsal's count {json.dumps(expect['fedavg_batched'])} "
          f"fedavg_batched and none else; {got_s:.2f} s on cuda, "
          f"{want_s:.2f} s on cpu [{card}]")
    check(same, "(e) placements or TPDs differ between cuda and cpu")
    check(all(math.isfinite(v) for v in gl) and rel <= LOSS_RTOL,
          f"(e) losses {gl} vs {wl} (rtol {LOSS_RTOL})")
    check(engine == expect, f"(e) launches {engine}, expected {expect}")
    fedavg_train = by_train["fedavg_batched"] + by_train["fedavg"]
    check(fedavg_train > 0 and sum(by_train.values()) == fedavg_train,
          f"(e) launch/train.py launched {by_train}: FedAvg only, expected")
    federated = {k: by_train[k] + engine[k] for k in engine}
    print(f"(a, b, d) the sLSTM loop's device busy against host ms: prefill "
          f"{loop_prefill[0]:.1f} / {loop_prefill[2]:.1f} a block, decode "
          f"{loop_decode[0]:.3f} / {loop_decode[2]:.3f} a block, training "
          f"{loop_train[XLSTM_PROFILE_TOKENS]:.1f} ms device a step of 1 x "
          f"{XLSTM_PROFILE_TOKENS} over {n_s_train} blocks [{card}]")
    print(f"phase 25 took {time.perf_counter() - phase_t0:.1f} s [{card}]")
    return {k: {f"{XLSTM_ARCH} serving (phase 25)": serving[k],
                f"{XLSTM_ARCH} training (phase 25)": training[k],
                "federated xLSTM rounds (phase 25)": federated[k]}
            for k in serving}



# ---- the vlm and audio families (phase 26) --------------------------------
VLM_ARCH = "llava-next-mistral-7b"
AUDIO_ARCH = "seamless-m4t-large-v2"
# text tokens and requests a wave: llava's 2880-patch prefix plus 512 or
# 1024 tokens pads to 3584 or 4096; seamless's text follows 1024 frames
MM_PROMPTS = ((512, 4), (1024, 4))
# one request of each wave served alone (every request before phase 30:
# the 8 serial runs took 5.8-7.2 s a family)
MM_SERIAL = (0, 4)
MM_NEW_TOKENS = SERVE_NEW_TOKENS
# (c), (d): the depth cuts against the CPU (2 took the host 31.1 s for
# llava's two dtypes)
MM_CUT_LAYERS = 1
# (b) serves llava at a depth cut of the drawn params: all 32 layers
# (with the 8 serial runs, 27-31 s) left the script too little room
VLM_SERVE_LAYERS = 16
MM_CUT_PROMPT = 64                      # text tokens of a cut's prefill
MM_CUT_BATCH = {VLM_ARCH: 1, AUDIO_ARCH: 2}
AUDIO_TRAIN_STEPS, AUDIO_TRAIN_TOKENS = 4, 2048
VLM_TRAIN_STEPS, VLM_TRAIN_TOKENS = 2, 1024
VLM_TRAIN_FREE = 10 * 2 ** 30           # (e): the cut leaves this free
# (e): a training step holds 16 bytes a param (params, grads, both
# moments, flat), and the stacked layers' backward (one unbind a leaf)
# holds every layer's gradients until the first layer's are done, 4
# bytes a layer param, then stacks one leaf's at a time (4 bytes a param
# of the largest leaf); beyond those, this much working set (remat's
# layer in flight, the logits)
VLM_TRAIN_SLACK = 5 * 2 ** 30
# (a): (what, B, Hq, Hkv, S, hd, causal), the serving prefill shapes
# (forward and backward, bf16)
FLASH_MM = (("seamless encoder", 4, 16, 16, 1024, 64, False),
            ("seamless decoder", 4, 16, 16, 1024, 64, True),
            ("llava prefill", 4, 32, 8, 4096, 128, True))
# (c), (d): float32 logits card vs host, as the dense family's CPU tests
MM_F32_TOL = dict(rtol=1e-4, atol=1e-4)


def flash_modes(kflash):
    """The flash forward's and backward's launches by mask, as read now."""
    return (dict(kflash.flash_attention.modes),
            dict(kflash.flash_attention_bwd.modes))


def mm_paths(counts, path, modes=None):
    """{kernel: {path: launches}} of one main path's counts; given the
    path's ``modes`` (:func:`flash_modes`, read with the counts) the
    flash kernels' launches are split by mask (``causal=1`` and
    ``causal=0``, the encoder's bidirectional attention), which needs the
    path to have run one route of each."""
    out = {k: {path: n} for k, n in counts.items()}
    if modes is None:
        return out
    for names, by_mode in ((("flash_attention", "flash_attention_f32"),
                            modes[0]),
                           (("flash_attention_bwd", "flash_attention_bwd_f32"),
                            modes[1])):
        check(sum(1 for n in names if counts[n]) <= 1,
              f"{path}: {names} both launched; the mask split needs one")
        for n in names:
            causal = by_mode.get("causal", 0) if counts[n] else 0
            bidir = by_mode.get("bidirectional", 0) if counts[n] else 0
            check(causal + bidir == counts[n],
                  f"{path}: {n} {counts[n]} launches, modes {by_mode}")
            out[n] = {f"{path}, causal=1": causal, f"{path}, causal=0": bidir}
    return out


def merge_paths(*parts):
    return {k: {p: n for part in parts for p, n in part[k].items()}
            for k in parts[0]}


def mm_cut_check(torch, get_model, cut, p_dev, p_cpu, toks, front, steps,
                 dev, tag):
    """A depth cut on the card against the CPU from the same params: the
    prefill of ``toks[:, :MM_CUT_PROMPT]`` behind ``front`` and ``steps``
    decode steps; float32 logits within MM_F32_TOL, bf16 greedy tokens
    by the drift-band rule. Prints each run's host seconds."""
    for name in ("float32", "bfloat16"):
        m = get_model(cut.replace(dtype=name))
        out, secs = {}, {}
        for where, p in (("cuda", p_dev), ("cpu", p_cpu)):
            d = dev if where == "cuda" else torch.device("cpu")
            t0 = time.perf_counter()
            logits, st = m.prefill_fn(p, {
                "tokens": toks[:, :MM_CUT_PROMPT].to(d),
                "frontend": front.to(d)})
            got = [logits.float().cpu()]
            for i in range(steps):
                j = MM_CUT_PROMPT + i
                logits, st = m.decode_fn(p, st, {"token": toks[:, j:j + 1]
                                                 .to(d)})
                got.append(logits.float().cpu())
            secs[where] = time.perf_counter() - t0
            out[where] = got
        whats = ["prefill logits"] + [f"decode step {i + 1}"
                                      for i in range(steps)]
        failed = []
        for what, a, b in zip(whats, out["cuda"], out["cpu"], strict=True):
            err = float((a - b).abs().max())
            if name == "float32":
                ok = bool(torch.allclose(a, b, **MM_F32_TOL))
                tol = str(MM_F32_TOL)
            else:
                ok = greedy_in_band(torch, a, b, XLSTM_BF16_BAND)
                tol = f"greedy tokens, drift band {XLSTM_BF16_BAND}"
            if not (a.shape == b.shape and ok):
                failed.append(f"{what} {err}")
            print(f"{tag} depth cut {name:8s} {what:16s}: cuda vs cpu max "
                  f"abs diff {err:.3e} (scale {float(b.abs().max()):.2f}; "
                  f"{tol}); greedy tokens {a[:, -1].argmax(-1).tolist()} vs "
                  f"{b[:, -1].argmax(-1).tolist()}")
        print(f"{tag} depth cut {name}: {secs['cuda']:.2f} s on cuda, "
              f"{secs['cpu']:.2f} s on the host (prefill and {steps} decode "
              f"steps)")
        check(not failed, f"{tag} depth cut {name}: cuda vs cpu beyond "
                          f"{tol}: {failed}")
        del m, out


def mm_serve(torch, np_, model, params, frontend, prompts, dev, card, tag,
             counters):
    """Serve ``prompts`` through ``WaveScheduler(max_batch=4, frontend=)``
    on the card: per wave the prefill and decode times and the peak
    memory; every output held to its batch-1 serial decode. Returns the
    kernels' launches over the scheduler's run (counted from 0) and the
    flash kernels' by mask (:func:`flash_modes`)."""
    from repro_torch.serving import Request, WaveScheduler
    reqs = [Request(rid=i, tokens=t, max_new_tokens=MM_NEW_TOKENS)
            for i, t in enumerate(prompts)]
    issue_ms, peaks = [], []

    def timed_decode(p, state, batch):
        t1 = time.perf_counter()
        out = model.decode_fn(p, state, batch)
        issue_ms[-1].append((time.perf_counter() - t1) * 1e3)
        return out

    def wave_prefill(p, batch):
        if issue_ms:
            peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        issue_ms.append([])
        return model.prefill_fn(p, batch)

    sched = WaveScheduler(dataclasses.replace(
        model, prefill_fn=wave_prefill, decode_fn=timed_decode), params,
        max_batch=SERVE_MAX_BATCH, frontend=frontend)
    for r in reqs:
        sched.submit(r)
    zero_counts(*counters)            # the counts to 0 just before the path
    t0 = time.perf_counter()
    sched.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launched = kernel_counts(*counters)   # read just after
    modes = flash_modes(counters[0])
    peaks.append(torch.cuda.max_memory_allocated())
    check(len(sched.stats) == len(MM_PROMPTS), f"{tag}: {len(sched.stats)} "
                                               f"waves")
    for st, issued, peak in zip(sched.stats, issue_ms, peaks, strict=True):
        dec_ms = (st.wall_s - st.ttft_s) / max(st.steps - 1, 1) * 1e3
        print(f"{tag} wave {st.wave}: {st.batch} x {st.prompt_len} text "
              f"tokens: prefill {st.ttft_s * 1e3:.1f} ms (until the first "
              f"tokens are on the host), decode {dec_ms:.2f} ms per token "
              f"synchronised, of which the host spends "
              f"{statistics.median(issued):.2f} ms issuing it (median of "
              f"{len(issued)} steps); peak device memory "
              f"{peak / 2**30:.2f} GiB [{card}]")
    print(f"{tag} summary() {json.dumps(sched.summary())}; whole run "
          f"{serve_s:.3f} s; launches "
          f"{json.dumps({k: v for k, v in launched.items() if v})}")
    vocab = model.config.vocab_size
    for r in reqs:
        check(r.output is not None and len(r.output) == MM_NEW_TOKENS
              and bool(np_.all((r.output >= 0) & (r.output < vocab))),
              f"{tag} request {r.rid}: malformed output {r.output}")
    t0 = time.perf_counter()
    same = []
    serial = [r for r in reqs if r.rid in MM_SERIAL]
    for r in serial:
        one = WaveScheduler(model, params, max_batch=1, frontend=frontend)
        alone = Request(rid=r.rid, tokens=r.tokens,
                        max_new_tokens=MM_NEW_TOKENS)
        one.submit(alone)
        one.run()
        same.append(bool(np_.array_equal(alone.output, r.output)))
    print(f"{tag} requests {list(MM_SERIAL)} against their batch-1 serial "
          f"decode: equal {same} ({time.perf_counter() - t0:.1f} s for the "
          f"{len(serial)} serial runs); first tokens "
          f"{reqs[0].output[:6].tolist()}")
    check(all(same), f"{tag}: batched != serial for requests "
                     f"{[r.rid for r, s in zip(serial, same) if not s]}")
    return launched, modes


def flash_mm_case(torch, F, kflash, flash_attention_ref, dev, card, case,
                  seed):
    """Phase 26 (a): one flash shape, bf16 on the sm90 route, forward and
    backward against the plain version on the card (one batch row at a
    time: the dense plain version's scores at B 4 x S 4096 would take
    tens of GB) at 2e-2, then device times of the kernel, the plain
    version and SDPA beside the bound. Returns (forward max abs err,
    backward max abs err); both held, and the times printed."""
    from repro_torch.kernels.ref import flash_attention_bwd_ref
    what, b, hq, hkv, s, hd, causal = case
    gen = torch.Generator(dev).manual_seed(seed)
    q, k, v, do = [torch.randn(sh, device=dev, generator=gen).to(
        torch.bfloat16) for sh in ((b, hq, s, hd), (b, hkv, s, hd),
                                   (b, hkv, s, hd), (b, hq, s, hd))]
    tol = FLASH_TOL["bfloat16"]
    before = dict(kflash.flash_attention.modes)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = kflash.flash_attention(*leaves, causal=causal)
    out.backward(do)
    out = out.detach()
    got = [t.grad for t in leaves]
    again = [t.clone().requires_grad_() for t in (q, k, v)]
    kflash.flash_attention(*again, causal=causal).backward(do)
    torch.cuda.synchronize()
    mode = "causal" if causal else "bidirectional"
    went = {m: n - before.get(m, 0) for m, n in
            kflash.flash_attention.modes.items() if n != before.get(m, 0)}
    check(went == {mode: 2}, f"(a) {what}: flash modes launched {went}")
    check(all(torch.equal(x.grad, y) for x, y in zip(again, got)),
          f"(a) {what}: two backward runs differ")
    f_err, b_err, worst = 0.0, 0.0, 0.0
    for i in range(b):
        rows = [t[i:i + 1].clone().requires_grad_() for t in (q, k, v)]
        want = flash_attention_ref(*rows, causal=causal)
        w = want.detach().float()
        f_err = max(f_err, float((out[i:i + 1].float() - w).abs().max()))
        check(torch.allclose(out[i:i + 1].float(), w, **tol),
              f"(a) {what} forward row {i}: beyond {tol}")
        want.backward(do[i:i + 1])
        for g, r in zip(got, rows, strict=True):
            scale = float(r.grad.float().abs().max())
            err = float((g[i:i + 1].float() - r.grad.float()).abs().max())
            b_err = max(b_err, err)
            worst = max(worst, err / scale)
        del rows, want
    check(worst <= FLASH_BWD_TOL["bfloat16"],
          f"(a) {what} backward: {worst} of the gradients' scale")
    del leaves, again, out
    # device times: forward, then backward from the forward's out, lse
    scale = 1.0 / math.sqrt(hd)
    kk = k.repeat_interleave(hq // hkv, dim=1)
    vv = v.repeat_interleave(hq // hkv, dim=1)
    fwd = lambda: kflash.flash_attention(q, k, v, causal=causal)  # noqa: E731
    k_ms = median_device_ms(torch, fwd, runs=9, per_run=5)
    p_ms = median_device_ms(torch, lambda: flash_attention_ref(
        q, k, v, causal=causal), runs=3, per_run=1)
    l_ms = median_device_ms(torch, lambda: F.scaled_dot_product_attention(
        q, kk, vv, is_causal=causal), runs=9, per_run=5)
    fb_ms = flash_bound(b, hq, hkv, s, hd, None, 2, causal=causal)
    o, lse = kflash._forward(q, k, v, (causal, None, scale, None),
                             with_lse=True)
    kb_ms = median_device_ms(torch, lambda: kflash.flash_attention_bwd(
        q, k, v, o, do, lse, causal=causal, scale=scale), runs=7, per_run=3)
    pb_ms = median_device_ms(torch, lambda: flash_attention_bwd_ref(
        q, k, v, o, do, lse, causal=causal, scale=scale), runs=3, per_run=1)
    qq, kr, vr = (t.clone().requires_grad_() for t in (q, kk, vv))
    sdpa_out = F.scaled_dot_product_attention(qq, kr, vr, is_causal=causal)
    lb_ms = median_device_ms(torch, lambda: torch.autograd.grad(
        sdpa_out, (qq, kr, vr), do, retain_graph=True), runs=7, per_run=3)
    bb_ms = flash_bwd_bound(b, hq, hkv, s, hd, None, 2, causal=causal)
    print(f"(a) flash {what} bf16 (B, Hq, Hkv, hd) = {(b, hq, hkv, hd)} "
          f"S={s} causal={int(causal)}: forward max abs err {f_err:.3e} "
          f"({tol}), backward within {worst:.2e} of the gradients' scale "
          f"({FLASH_BWD_TOL['bfloat16']}), reruns bit-equal; forward "
          f"kernel {k_ms:.4f} ms ({fb_ms[1] / k_ms / 1e9:.1f} TFLOP/s, "
          f"{fb_ms[0] / k_ms * 100:.1f}% of the bound), plain torch "
          f"{p_ms:.3f} ms, SDPA {l_ms:.4f} ms, bound {fb_ms[0]:.4f} ms "
          f"({fb_ms[1]:.3e} flops); backward kernel {kb_ms:.4f} ms (3 "
          f"launches, {bb_ms[1] / kb_ms / 1e9:.1f} TFLOP/s, "
          f"{bb_ms[0] / kb_ms * 100:.1f}% of the bound), plain torch "
          f"{pb_ms:.3f} ms, SDPA backward on k, v repeated to {hq} heads "
          f"{lb_ms:.4f} ms, bound {bb_ms[0]:.4f} ms ({bb_ms[1]:.3e} flops) "
          f"[{card}]")
    del q, k, v, do, kk, vv, o, lse, qq, kr, vr, sdpa_out
    torch.cuda.empty_cache()
    return f_err, b_err


def vlm_audio_phases(torch, np_, dev, card):
    """Phase 26: the vlm and audio families on cuda. Returns ({kernel
    name: {path: launches}}, {kernel name: max abs err of (a)})."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core.hierarchy import ClientPool, Hierarchy
    from repro_torch.core.registry import create_strategy
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.fl.orchestrator import FederatedOrchestrator
    from repro_torch.kernels import fedavg as kfedavg
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import fused_adamw as kadamw
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru as krglru
    from repro_torch.kernels import tpd as ktpd
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import get_model
    from repro_torch.optim import adamw
    from repro_torch.train import TrainLoop, TrainLoopConfig
    from repro_torch.utils.trees import tree_leaves, tree_map

    sync = torch.cuda.synchronize
    counters = (kflash, krglru, kfedavg, ktpd, kadamw)
    phase_t0 = time.perf_counter()

    def mark(part):
        print(f"({part}) done {time.perf_counter() - phase_t0:.1f} s into "
              f"phase 26")

    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    check(held < 8 * 2 ** 30, f"{held} bytes still held on the card "
                              f"before phase 26")
    phase(f"26. vlm and audio on cuda: flash at their shapes (bidirectional "
          f"too), {VLM_ARCH} and {AUDIO_ARCH} served, cut and trained; "
          f"federated vlm and audio rounds")

    # ---- (a) flash at this slice's shapes ---------------------------------
    errs = {"flash_attention": 0.0, "flash_attention_bwd": 0.0}
    for i, case in enumerate(FLASH_MM):
        f_err, b_err = flash_mm_case(
            torch, F, kflash, flash_attention_ref, dev, card, case, 260 + i)
        errs["flash_attention"] = max(errs["flash_attention"], f_err)
        errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], b_err)
    mark("a")

    # ---- (b) llava-next-mistral-7b drawn uncut, served at a cut ----------
    cfg = get_config(VLM_ARCH)
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(SEED), dev)
    sync()
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(7.2e9 < n_params < 7.3e9, f"{VLM_ARCH} holds {n_params} params")
    rng = np_.random.default_rng(SEED)
    front = rng.normal(scale=0.02, size=(cfg.frontend_len, cfg.frontend_dim)
                       ).astype(np_.float32)
    prompts = [rng.integers(0, cfg.vocab_size, plen).astype(np_.int32)
               for plen, n in MM_PROMPTS for _ in range(n)]
    print(f"{VLM_ARCH}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"rope theta {cfg.rope_theta:g}, a {cfg.frontend_len} x "
          f"{cfg.frontend_dim} stub prefix; {n_params} f32 params "
          f"({n_params * 4 / 1e9:.2f} GB) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    srv_cfg = cfg.replace(n_layers=VLM_SERVE_LAYERS)
    srv_model = get_model(srv_cfg)
    srv_params = dict(params, layers=tree_map(
        lambda x: x[:VLM_SERVE_LAYERS], params["layers"]))
    print(f"(b) {VLM_ARCH} served at {VLM_SERVE_LAYERS} of {cfg.n_layers} "
          f"layers")
    vlm_serving, modes = mm_serve(torch, np_, srv_model, srv_params, front,
                                  prompts, dev, card, f"(b) {VLM_ARCH}",
                                  counters)
    waves = len(MM_PROMPTS)
    check(vlm_serving["flash_attention"] == srv_cfg.n_layers * waves
          and vlm_serving["flash_attention_f32"] == 0
          and modes[0] == {"causal": srv_cfg.n_layers * waves},
          f"(b) flash launches {vlm_serving} {modes}, expected "
          f"{srv_cfg.n_layers} causal per prefill x {waves} on "
          f"{kflash.SM90_SOURCE.stem} only")
    decode_profile(torch, np_, srv_model, srv_params,
                   prompts[:SERVE_MAX_BATCH], dev,
                   card, frontend=front)
    mark("b")

    # ---- (c) a full-width depth cut against the CPU ----------------------
    cut = cfg.replace(n_layers=MM_CUT_LAYERS)
    p_cut = dict(params, layers=tree_map(lambda x: x[:MM_CUT_LAYERS],
                                         params["layers"]))
    p_cpu = tree_map(lambda x: x.cpu(), p_cut)
    b_cut = MM_CUT_BATCH[VLM_ARCH]
    toks = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (b_cut, MM_CUT_PROMPT + DENSE_CUT_STEPS)),
        dtype=torch.int32)
    fe = torch.as_tensor(front).expand(b_cut, -1, -1).contiguous()
    mm_cut_check(torch, get_model, cut, p_cut, p_cpu, toks, fe,
                 DENSE_CUT_STEPS, dev, f"(c) {VLM_ARCH}")
    del p_cut, p_cpu, params, model, srv_params, srv_model
    torch.cuda.empty_cache()
    mark("c")

    # ---- (d) seamless-m4t-large-v2 uncut: served, cut, trained ------------
    acfg = get_config(AUDIO_ARCH)
    amodel = get_model(acfg)
    t0 = time.perf_counter()
    aparams = amodel.init(torch.Generator(dev).manual_seed(SEED), dev)
    sync()
    n_audio = sum(x.numel() for x in tree_leaves(aparams))
    check(1.27e9 < n_audio < 1.29e9, f"{AUDIO_ARCH} holds {n_audio} params")
    afront = rng.normal(scale=0.02, size=(acfg.frontend_len,
                                          acfg.frontend_dim)
                        ).astype(np_.float32)
    aprompts = [rng.integers(0, acfg.vocab_size, plen).astype(np_.int32)
                for plen, n in MM_PROMPTS for _ in range(n)]
    print(f"{AUDIO_ARCH}: {acfg.n_encoder_layers} encoder and "
          f"{acfg.n_layers} decoder layers, d {acfg.d_model}, "
          f"{acfg.n_heads} heads of {acfg.resolved_head_dim}, d_ff "
          f"{acfg.d_ff}, vocab {acfg.vocab_size} (padded "
          f"{acfg.padded_vocab}), a {acfg.frontend_len} x "
          f"{acfg.frontend_dim} stub frontend; {n_audio} f32 params "
          f"({n_audio * 4 / 1e9:.2f} GB) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    audio_serving, modes = mm_serve(torch, np_, amodel, aparams, afront,
                                    aprompts, dev, card, f"(d) {AUDIO_ARCH}",
                                    counters)
    per_wave = acfg.n_encoder_layers + acfg.n_layers
    check(audio_serving["flash_attention"] == per_wave * waves
          and modes[0] == {"bidirectional": acfg.n_encoder_layers * waves,
                           "causal": acfg.n_layers * waves},
          f"(d) flash launches {audio_serving} {modes}, expected "
          f"{acfg.n_encoder_layers} bidirectional (the encoder) and "
          f"{acfg.n_layers} causal (the decoder) per prefill x {waves}")
    audio_serving = mm_paths(audio_serving,
                             f"{AUDIO_ARCH} serving (phase 26)", modes)
    cut = acfg.replace(n_layers=MM_CUT_LAYERS,
                       n_encoder_layers=MM_CUT_LAYERS)
    p_cut = dict(aparams, **{part: tree_map(lambda x: x[:MM_CUT_LAYERS],
                                            aparams[part])
                             for part in ("encoder", "decoder")})
    p_cpu = tree_map(lambda x: x.cpu(), p_cut)
    b_cut = MM_CUT_BATCH[AUDIO_ARCH]
    toks = torch.as_tensor(rng.integers(
        0, acfg.vocab_size, (b_cut, MM_CUT_PROMPT + DENSE_CUT_STEPS)),
        dtype=torch.int32)
    fe = torch.as_tensor(afront).expand(b_cut, -1, -1).contiguous()
    mm_cut_check(torch, get_model, cut, p_cut, p_cpu, toks, fe,
                 DENSE_CUT_STEPS, dev, f"(d) {AUDIO_ARCH}")
    del p_cut, p_cpu, aparams
    torch.cuda.empty_cache()

    def train(model, steps, tokens, frontend, tag):
        ds = SyntheticLMDataset(model.config.vocab_size, tokens, seed=SEED)
        stamps = []

        def batch_fn(step):
            sync()
            stamps.append(time.perf_counter())
            return dict(ds.batch(1, step), frontend=frontend[None])

        torch.cuda.reset_peak_memory_stats()
        loop = TrainLoop(model, adamw(3e-4), batch_fn,
                         TrainLoopConfig(total_steps=steps, log_every=1,
                                         checkpoint_dir=None),
                         seed=SEED, device=dev)
        check(model.config.remat, f"{tag} trains without remat")
        zero_counts(*counters)        # the counts to 0 just before the path
        res = loop.run()
        sync()
        stamps.append(time.perf_counter())
        launched = kernel_counts(*counters)   # read just after
        modes = flash_modes(kflash)
        peak = torch.cuda.max_memory_allocated()
        reserved = torch.cuda.max_memory_reserved()
        n = sum(x.numel() for x in tree_leaves(loop.params))
        losses = [m_["loss"] for m_ in res["metrics_log"]]
        steps_s = [b_ - a_ for a_, b_ in zip(stamps, stamps[1:])]
        print(f"{tag} TrainLoop, {steps} steps of 1 x {tokens} text tokens "
              f"behind {frontend.shape[0]} frontend positions, remat on, "
              f"adamw, {n} params: losses {losses}; steps "
              f"{[round(s_ * 1e3, 1) for s_ in steps_s]} ms; peak device "
              f"memory {peak / 2**30:.2f} GiB allocated, "
              f"{reserved / 2**30:.2f} GiB reserved; launches "
              f"{json.dumps({k: v for k, v in launched.items() if v})}, "
              f"flash masks {json.dumps(modes[0])}, backward "
              f"{json.dumps(modes[1])} [{card}]")
        check(len(losses) == steps and all(math.isfinite(v) for v in losses),
              f"{tag} losses {losses}")
        with torch.no_grad():
            after = [float(model.loss_fn(loop.params, {
                k: torch.as_tensor(v).to(dev) for k, v in batch_fn(i).items()
            })[0]) for i in range(steps)]
        print(f"{tag} each step's batch under the final params: losses "
              f"{after}")
        del loop, res
        torch.cuda.empty_cache()
        return launched, modes, peak, n

    audio_training, modes, _, _ = train(
        amodel, AUDIO_TRAIN_STEPS, AUDIO_TRAIN_TOKENS,
        torch.as_tensor(afront), f"(d) {AUDIO_ARCH}")
    # each step: the encoder and decoder forward, remat's recompute, and
    # each layer's backward (3 launches)
    check(audio_training["flash_attention"] == 2 * per_wave
          * AUDIO_TRAIN_STEPS
          and audio_training["flash_attention_bwd"] == 3 * per_wave
          * AUDIO_TRAIN_STEPS
          and audio_training["fused_adamw"] == AUDIO_TRAIN_STEPS
          and modes[1].get("bidirectional") == 3 * acfg.n_encoder_layers
          * AUDIO_TRAIN_STEPS,
          f"(d) training launches {audio_training}, flash masks {modes}")
    audio_training = mm_paths(audio_training,
                              f"{AUDIO_ARCH} training (phase 26)", modes)
    del amodel
    mark("d")

    # ---- (e) llava training at the deepest full-width cut that fits ------
    total = torch.cuda.mem_get_info()[1]
    d, hd = cfg.d_model, cfg.resolved_head_dim
    per_layer = (2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
                 + 3 * d * cfg.d_ff + 2 * d)
    rest = 2 * cfg.padded_vocab * d + d      # embed, lm_head, ln_f
    layer_bytes = 20 * per_layer + 4 * d * cfg.d_ff   # largest: w_gate
    depth = int((total - VLM_TRAIN_FREE - VLM_TRAIN_SLACK - 16 * rest)
                // layer_bytes)
    depth = max(1, min(depth, cfg.n_layers))
    print(f"(e) {VLM_ARCH} training cut: {depth} of {cfg.n_layers} layers "
          f"({per_layer} params a layer, {rest} outside them; 16 bytes a "
          f"param for params, grads and both moments, 4 more a layer param "
          f"for the stacked layers' gradients in the backward and 4 a "
          f"param of the largest leaf's stack: {layer_bytes / 2**30:.2f} "
          f"GiB a layer; {VLM_TRAIN_SLACK / 2**30:.0f} GiB for the step's "
          f"working set, {VLM_TRAIN_FREE / 2**30:.0f} GiB left free of the "
          f"card's {total / 2**30:.2f} GiB)")
    vlm_model = get_model(cfg.replace(n_layers=depth))
    vlm_training, _, peak, n_cut = train(
        vlm_model, VLM_TRAIN_STEPS, VLM_TRAIN_TOKENS, torch.as_tensor(front),
        f"(e) {VLM_ARCH} cut to {depth} layers")
    check(n_cut == rest + depth * per_layer,
          f"(e) {n_cut} params, counted {rest + depth * per_layer}")
    free = total - peak
    print(f"(e) the cut left {free / 2**30:.2f} GiB of the card free at its "
          f"peak (at least {VLM_TRAIN_FREE / 2**30:.0f}); one layer more "
          f"would add {layer_bytes / 2**30:.2f} GiB")
    check(free >= VLM_TRAIN_FREE, f"(e) {free} bytes free at the peak")
    check(vlm_training["flash_attention"] == 2 * depth * VLM_TRAIN_STEPS
          and vlm_training["flash_attention_bwd"] == 3 * depth
          * VLM_TRAIN_STEPS
          and vlm_training["fused_adamw"] == VLM_TRAIN_STEPS,
          f"(e) training launches {vlm_training}")
    del vlm_model
    torch.cuda.empty_cache()
    mark("e")

    # ---- (f) federated vlm and audio rounds --------------------------------
    fl_archs = (VLM_ARCH, AUDIO_ARCH)
    zero_counts(*counters)            # the counts to 0 just before the path
    losses = {}
    for arch in fl_archs:
        out_json = ROOT / "build" / f"train_{arch}.json"
        out_json.parent.mkdir(parents=True, exist_ok=True)
        code = train_main(["--arch", arch, "--strategy", "pso", "--clients",
                           str(FL_CLIENTS), "--rounds", str(FL_ROUNDS),
                           "--batch-size", str(FL_TRAIN_BATCH),
                           "--out", str(out_json)], device=dev)
        record = json.loads(out_json.read_text())
        losses[arch] = [r["loss"] for r in record["rounds"]]
        check(code == 0 and len(losses[arch]) == FL_ROUNDS
              and all(math.isfinite(v) for v in losses[arch]),
              f"(f) launch/train.py --arch {arch}: exit {code}, losses "
              f"{losses[arch]}")
    sync()
    by_train = mm_paths(kernel_counts(*counters),   # read just after
                        "vlm and audio launch/train.py (phase 26)",
                        flash_modes(kflash))
    print(f"(f) launch/train.py (reduced, bf16 compute) on cuda: losses "
          f"{json.dumps(losses)}; launches "
          f"{json.dumps({k: sum(v.values()) for k, v in by_train.items()})}")
    calls = {}
    fwd_flash = ops.flash_attention

    def counting(*args, **kw):
        grad = torch.is_grad_enabled() and any(x.requires_grad for x in args)
        calls["flash"] = calls.get("flash", 0) + 1
        calls["flash_bwd"] = calls.get("flash_bwd", 0) + int(grad)
        return fwd_flash(*args, **kw)

    runs = {}
    ops.flash_attention = counting
    try:
        for where, d in (("card", dev), ("host", torch.device("cpu"))):
            if where == "card":
                zero_counts(*counters)    # the counts to 0 just before
            for arch in fl_archs:
                calls.clear()
                fl_cfg = get_config(arch).reduced().replace(dtype="float32")
                h = Hierarchy(depth=2, width=2, trainers_per_leaf=1,
                              n_clients=FL_CLIENTS)
                pool = ClientPool.random(h.total_clients, seed=SEED)
                orch = FederatedOrchestrator(
                    get_model(fl_cfg), h, pool, make_federated_dataset(
                        fl_cfg, h.total_clients, SEED, FL_SEQ),
                    local_steps=FL_LOCAL_STEPS, batch_size=FL_BATCH,
                    seed=SEED, timing="deterministic", device=d)
                # both devices start from the card run's initial params
                init = tree_map(lambda x: x.cpu(), orch.params) \
                    if where == "card" else runs["card", arch][2]
                orch.set_global(tree_map(lambda x: x.to(d).clone(), init))
                t1 = time.perf_counter()
                res = orch.run(create_strategy("pso", h, seed=SEED),
                               rounds=FL_ROUNDS)
                if where == "card":
                    sync()
                runs[where, arch] = (res, dict(calls), init,
                                     time.perf_counter() - t1, h.depth)
            if where == "card":
                engine = kernel_counts(*counters)   # read just after
                engine_paths = mm_paths(
                    engine, "vlm and audio engine rounds (phase 26)",
                    flash_modes(kflash))
    finally:
        ops.flash_attention = fwd_flash
    for arch in fl_archs:
        got, got_calls, _, got_s, _ = runs["card", arch]
        want, want_calls, _, want_s, _ = runs["host", arch]
        same = ([r.placement for r in got.rounds]
                == [r.placement for r in want.rounds]
                and got.tpds.tolist() == want.tpds.tolist())
        gl, wl = [r.loss for r in got.rounds], [r.loss for r in want.rounds]
        rel = max(abs(a - b) / abs(b) for a, b in zip(gl, wl, strict=True))
        print(f"(f) {arch} reduced f32, batched engine, {FL_ROUNDS} rounds of "
              f"pso: placements {[r.placement for r in got.rounds]}, TPDs "
              f"{got.tpds.tolist()} (cpu: equal {same}); losses {gl} vs {wl} "
              f"on cpu (largest rel diff {rel:.2e}); entry calls "
              f"{json.dumps(got_calls)} (cpu {json.dumps(want_calls)}); "
              f"{got_s:.2f} s on cuda, {want_s:.2f} s on cpu [{card}]")
        check(same, f"(f) {arch}: placements or TPDs differ")
        check(all(math.isfinite(v) for v in gl) and rel <= LOSS_RTOL,
              f"(f) {arch}: losses {gl} vs {wl} (rtol {LOSS_RTOL})")
        check(got_calls == want_calls, f"(f) {arch}: flash calls differ")
    want_calls = [runs["host", arch][1] for arch in fl_archs]
    expect = {k: 0 for k in engine}
    expect.update({
        "flash_attention_f32": sum(c.get("flash", 0) for c in want_calls),
        "flash_attention_bwd_f32": 3 * sum(c.get("flash_bwd", 0)
                                           for c in want_calls),
        "fedavg_batched": sum((1 + FL_ROUNDS) * runs["host", arch][4]
                              for arch in fl_archs)})
    launched, counted = ({k: v for k, v in d.items() if v}
                         for d in (engine, expect))
    print(f"(f) batched engine launches on cuda {json.dumps(launched)}, "
          f"the CPU rehearsal's count {json.dumps(counted)}; flash masks "
          f"{json.dumps(kflash.flash_attention.modes)}")
    check(engine == expect, f"(f) launches {engine}, expected {expect}")
    mark("f")
    print(f"phase 26 took {time.perf_counter() - phase_t0:.1f} s [{card}]")
    return merge_paths(
        mm_paths(vlm_serving, f"{VLM_ARCH} serving (phase 26)"),
        audio_serving, audio_training,
        mm_paths(vlm_training, f"{VLM_ARCH} training, {depth} layers "
                               f"(phase 26)"),
        by_train, engine_paths), errs


# ---------------------------------------------------------------------------
# phase 27: the paper's aggregation tree across ranks, and the sharded TPD
# ---------------------------------------------------------------------------
DIST_TPD_NDEV = (1, 3, 8)          # row shards, all on the one card
DIST_TPD_POOLS = 5
DIST_TPD_LARGE_P = 1000
DIST_TPD_RTOL = 1e-12
DIST_PSO_ITERATIONS = 20
DIST_MLP_RANKS = 8
# (mesh dims, axes, clients a pod): 8 clients, 4 clients of 2 ranks each,
# 2 pods of 4 clients
DIST_MLP_LAYOUTS = (((8,), ("data",), 8), ((8,), ("data",), 4),
                    ((2, 4), ("pod", "data"), 4))
DIST_MLP_BATCH, DIST_MLP_STEPS = 32, 2
DIST_MLP_TOL = dict(rtol=1e-5, atol=1e-7)
DIST_LM_ARCH = "stablelm-1.6b"
DIST_LM_RANKS = 4
DIST_LM_TREE = (2, 1, 2, 4)        # depth, width, trainers a leaf, clients
DIST_LM_TOKENS, DIST_LM_STEPS = 512, 1   # 2 local steps before phase 30
# the federated clients of phases 27 (c), 29 (b) and 30 (c) train without
# remat since phase 30: a rank's first remat call imports torch._dynamo
# (8-10.5 s on an H100 host, triton's import among it), which stalled
# each world's first round; remat runs in phases 28-30's gradients and
# training
FL_CLIENT_REMAT = False
DIST_FL_LR = 0.05                  # the reference's FL_LOCAL_LR
# one round of each mode: phase 28 took the time of the second
# hierarchical round (12-26 s on an H100 80GB HBM3 at 700 W)
# hierarchical only since phase 30 (flat added 5.5 s, and phases 29-30
# run flat rounds)
DIST_LM_MODES = ("hierarchical",)
DIST_LM_LOSS_RTOL = 1e-4
DIST_LM_PARAM_TOL = dict(rtol=1e-3, atol=1e-5)
DIST_LM_OUTSIDE = 1e-5             # share of params allowed outside it
DIST_FREE_BYTES = 10 * 2 ** 30     # what the ranks leave free on the card
DIST_MARGIN_BYTES = 2 ** 30        # the depth rule's slack: pools, fragments
DIST_WORLD_TIMEOUT_S = 400
# (c)'s depth cap for the script's time: 18 layers, the memory's
# deepest, took 11.6-16.6 s a tree level on an H100 80GB HBM3 at 700 W,
# and 9 left the script too little room under its limit
DIST_LM_LAYERS = 4


def _rank_setup(torch, device):
    """A rank's settings, as phase 1 sets the parent's: TF32 off, the
    one card (every rank on cuda:0), one intra-op thread; and, before
    the rank's first CUDA call, expandable segments for its allocator,
    so that ranks sharing the card do not each hold gigabytes of cached
    fragments (without them, one rank's pool on an H100 80GB HBM3
    reached 22.4 GiB for 16.7 GiB of tensors)."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    torch.backends.cuda.matmul.allow_tf32 = False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(1)
    _warm_checkpoint_import()


def _warm_checkpoint_import() -> None:
    """Import ``torch._dynamo`` on a thread of its own while the rank
    starts: ``torch.utils.checkpoint`` imports it at its first call (its
    ``torch._disable_dynamo`` wrappers), which took 10.5 s on the chip
    host (triton's import among it) and stalled every rank's first remat
    gradient. The modules a rank runs are imported first, on this
    thread, so the two threads never import one module together."""
    import threading

    import repro_torch.data.synthetic  # noqa: F401
    import repro_torch.fl.distributed  # noqa: F401
    import repro_torch.kernels.ref  # noqa: F401
    import repro_torch.launch.mesh  # noqa: F401
    import repro_torch.models  # noqa: F401
    import repro_torch.optim  # noqa: F401
    import repro_torch.train.loop  # noqa: F401
    import repro_torch.utils.trees  # noqa: F401
    import torch.utils.checkpoint  # noqa: F401
    _counters()
    threading.Thread(target=__import__, args=("torch._dynamo",),
                     daemon=True).start()


def _counters():
    from repro_torch.kernels import fedavg as kfedavg
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import fused_adamw as kadamw
    from repro_torch.kernels import rglru as krglru
    from repro_torch.kernels import tpd as ktpd
    return kflash, krglru, kfedavg, ktpd, kadamw


def dist_mlp_rank(rank, world, spec):
    """Phase 27 (b), one rank: FLTrainStep rounds of ``spec["cfg"]`` (the
    full-width paper MLP) on each layout and mode, on ``spec["device"]``.
    Rank 0 returns its params; every rank its params' checksum, the
    round's split, its peak memory and its kernel launches."""
    import torch

    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.fl.distributed import FLTrainStep, bits_checksum
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.models import ShardingPolicy, get_model
    from repro_torch.optim import sgd
    from repro_torch.utils.trees import flat_buffer_of

    dev, cfg = spec["device"], spec["cfg"]
    _rank_setup(torch, dev)
    counters = _counters()
    out = []
    zero_counts(*counters)
    peak = _peak_reset(torch, dev)
    for (dims, axes, per_pod), (h, placement) in zip(
            DIST_MLP_LAYOUTS, spec["trees"], strict=True):
        mesh = RankMesh(dims, axes, device=dev)
        model = get_model(cfg, ShardingPolicy(mesh=mesh))
        n_total = per_pod * mesh.shape.get("pod", 1)
        ds = make_federated_dataset(cfg, n_total, SEED)
        for mode in ("hierarchical", "flat"):
            fl = FLTrainStep(model, sgd(DIST_FL_LR), h, placement,
                             local_steps=DIST_MLP_STEPS, mode=mode)
            params, state = fl.init_stacked(
                torch.Generator(dev).manual_seed(SEED))
            batch = {k: torch.as_tensor(v, device=dev) for k, v in
                     ds.client_batch(fl.client_index, DIST_MLP_BATCH,
                                     0).items()}
            stats = []
            params, state, metrics = fl.make_round_fn()(
                params, state, batch, stats=stats)
            flat = flat_buffer_of(params)
            out.append({"layout": axes, "dims": dims, "mode": mode,
                        "client": fl.client_index,
                        "loss": float(metrics["loss"]),
                        "checksum": int(bits_checksum(flat)),
                        "params": flat.cpu().numpy() if rank == 0 else None,
                        "stats": stats})
    return {"rounds": out, "counts": kernel_counts(*counters),
            "peak": peak()[0]}


def _peak_reset(torch, device):
    """Reset the card's peak memory; returns a reader of it, (allocated,
    reserved) bytes ((0, 0) on the host)."""
    if torch.device(device).type != "cuda":
        return lambda: (0, 0)
    torch.cuda.reset_peak_memory_stats()
    return lambda: (torch.cuda.max_memory_allocated(),
                    torch.cuda.max_memory_reserved())


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def dist_lm_rank(rank, world, spec):
    """Phase 27 (c), one rank: ``spec["cfg"]`` (full-width stablelm-1.6b)
    for DIST_LM_MODES rounds on the rank path; rank 0 keeps its params
    after each round on the host, then (the other ranks' memory freed)
    runs the host path from the same init and batches and holds it to
    them."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.hierarchy import Hierarchy
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.fl.distributed import FLTrainStep
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.models import ShardingPolicy, get_model
    from repro_torch.optim import sgd
    from repro_torch.utils.trees import flat_buffer_of

    dev, cfg = spec["device"], spec["cfg"]
    _rank_setup(torch, dev)
    counters = _counters()
    mesh = RankMesh((world,), ("data",), device=dev)
    h = Hierarchy(*DIST_LM_TREE[:3], n_clients=DIST_LM_TREE[3])
    ds = make_federated_dataset(cfg, h.total_clients, SEED, DIST_LM_TOKENS)
    model = get_model(cfg, ShardingPolicy(mesh=mesh))
    fls = {m: FLTrainStep(model, sgd(DIST_FL_LR), h, spec["placement"],
                          local_steps=DIST_LM_STEPS, mode=m)
           for m in dict.fromkeys(DIST_LM_MODES)}
    fl = fls[DIST_LM_MODES[0]]
    t0 = time.perf_counter()
    params, state = fl.init_stacked(torch.Generator(dev).manual_seed(SEED))
    _sync(torch, dev)
    init_s = time.perf_counter() - t0
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in ds.client_batch(fl.client_index, 1, 0).items()}
    # rank 0 keeps the global params before and after every round, in
    # pinned host memory (a pageable copy of 6 GB took 3-4 s from an H100)
    kept = [_pinned_copy(torch, flat_buffer_of(params))] if rank == 0 \
        else []
    peak = _peak_reset(torch, dev)
    zero_counts(*counters)
    rounds = []
    for mode in DIST_LM_MODES:
        stats = []
        t0 = time.perf_counter()
        params, state, metrics = fls[mode].make_round_fn()(
            params, state, batch, stats=stats)
        wall = time.perf_counter() - t0
        rounds.append({"mode": mode, "loss": float(metrics["loss"]),
                       "stats": stats, "s": wall})
        if rank == 0:
            t0 = time.perf_counter()
            kept.append(_pinned_copy(torch, flat_buffer_of(params)))
            rounds[-1]["d2h_s"] = time.perf_counter() - t0
    counts = kernel_counts(*counters)
    allocated, reserved = peak()
    result = {"rounds": rounds, "counts": counts, "peak": allocated,
              "reserved": reserved, "init_s": init_s,
              "n_params": flat_buffer_of(params).numel()}
    del params, state, fls, fl, model
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        result["host"] = _lm_host_path(torch, dev, cfg, h, spec["placement"],
                                       ds, kept, counters)
    dist.barrier()
    return result


def _pinned_copy(torch, flat):
    """A host copy of ``flat`` (pinned when it lives on the card)."""
    out = torch.empty(flat.shape, dtype=flat.dtype,
                      pin_memory=flat.is_cuda)
    return out.copy_(flat)


def _lm_host_path(torch, dev, cfg, h, placement, ds, kept, counters):
    """FLTrainStep's host path on the card (one device, every client's
    replica in one stack, the FedAvg kernel): its init held to the
    ranks' bit for bit, then each round run from the rank path's params
    before it (``kept[r]``) on the same batches and held to the rank
    path's after it (``kept[r + 1]``). Starting each round from the same
    params keeps the comparison to one round's arithmetic: bf16 local
    steps would amplify the last-bit differences of two summation orders
    over rounds."""
    from repro_torch.fl.distributed import FLTrainStep
    from repro_torch.models import get_model
    from repro_torch.optim import sgd
    from repro_torch.utils.trees import flat_buffer_of

    fl = FLTrainStep(get_model(cfg), sgd(DIST_FL_LR), h, placement,
                     local_steps=DIST_LM_STEPS)
    params, states = fl.init_stacked(torch.Generator(dev).manual_seed(SEED),
                                     dev)
    stacked = {k: torch.stack([torch.as_tensor(ds.client_batch(c, 1, 0)[k])
                               for c in range(h.total_clients)]).to(dev)
               for k in ("tokens", "labels")}
    stack = flat_buffer_of(params, lead=1)
    n = stack.shape[1]
    init_equal = all(torch.equal(stack[0, i:i + 2 ** 26],
                                 kept[0][i:i + 2 ** 26].to(dev))
                     for i in range(0, n, 2 ** 26))
    peak = _peak_reset(torch, dev)
    zero_counts(*counters)
    rounds = []
    for start, want in zip(kept, kept[1:]):
        for c in range(stack.shape[0]):
            stack[c].copy_(start)
        stats = []
        t0 = time.perf_counter()
        params, states, metrics = fl.make_round_fn()(params, states, stacked,
                                                     stats=stats)
        wall = time.perf_counter() - t0
        rows_equal = all(torch.equal(stack[c], stack[0])
                         for c in range(1, stack.shape[0]))
        outside, err = 0, 0.0
        for i in range(0, n, 2 ** 26):
            a = stack[0, i:i + 2 ** 26]
            b = want[i:i + 2 ** 26].to(dev)
            d = (a - b).abs()
            outside += int((d > DIST_LM_PARAM_TOL["atol"]
                            + DIST_LM_PARAM_TOL["rtol"] * b.abs()).sum())
            err = max(err, float(d.max()))
        rounds.append({"loss": float(metrics["loss"]), "outside": outside,
                       "max_abs_err": err, "rows_equal": rows_equal,
                       "stats": stats, "s": wall})
    return {"rounds": rounds, "counts": kernel_counts(*counters),
            "peak": peak()[0], "init_equal": init_equal}


def bytes_by_step(stats_of_ranks) -> dict:
    """Bytes put into each aggregation step, summed over the ranks."""
    out = {}
    for stats in stats_of_ranks:
        for s in stats:
            if "bytes" in s:
                out[s["step"]] = out.get(s["step"], 0) + s["bytes"]
    return out


def lm_rank_bytes(cfg) -> int:
    """A rank's peak on the card in the rank path's local round of a
    dense decoder (sgd, 1 x DIST_LM_TOKENS): 12 bytes a layer param
    (params, grads, and the copy of the stacked layers' gradients their
    ``unbind`` backward builds), 8 bytes of every other param (the
    untied embedding and head, the final norm), six float32 copies of
    the logits, and 0.6 GiB of working set. It gives 13.99 and 16.87 GiB
    at 16 and 21 layers of stablelm-1.6b, where ranks on an H100 80GB
    HBM3 reserved 13.99 and 16.85 GiB."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    layer = d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) \
        + 3 * d * cfg.d_ff + 2 * d
    other = 2 * cfg.vocab_size * d + d
    logits = 6 * 4 * DIST_LM_TOKENS * cfg.vocab_size
    return 12 * layer * cfg.n_layers + 8 * other + logits + 6 * 2 ** 30 // 10


def lm_depth(torch, cfg, ranks, max_layers=None):
    """The deepest cut of ``cfg``, of at most ``max_layers`` layers, whose
    ``ranks`` leave DIST_FREE_BYTES
    of the card free, by :func:`lm_rank_bytes`, this process's use of
    the card standing for a rank's CUDA context, and DIST_MARGIN_BYTES
    of slack for the ranks' pools above their tensors. Returns (the cut,
    bytes estimated for the ranks and this process, the parts)."""
    free, total = torch.cuda.mem_get_info()
    held = total - free
    context = held - torch.cuda.memory_reserved()
    for layers in range(min(cfg.n_layers, max_layers or cfg.n_layers), 0,
                        -1):
        cut = cfg.replace(n_layers=layers)
        rank = lm_rank_bytes(cut)
        need = ranks * (rank + context) + held
        if need + DIST_MARGIN_BYTES <= total - DIST_FREE_BYTES:
            return cut, need, {"rank": rank, "context": context,
                               "held": held}
    raise SmokeFailure(f"no depth of {cfg.name} fits {ranks} ranks")


def distributed_phases(torch, np_, card):
    """Phase 27: the sharded pooled TPD on the card, then FLTrainStep
    over spawned gloo worlds of ranks on the one card: the paper MLP on
    8 ranks in three layouts, full-width stablelm-1.6b on 4. Returns
    {kernel name: {"phase 27": launches}}."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.core import cost_model as cm_mod
    from repro_torch.core.cost_model import CostModel, PooledTPDEvaluator
    from repro_torch.core.hierarchy import ClientPool, Hierarchy
    from repro_torch.core.pso import FlagSwapPSO
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.experiments import EvalConfig, get_scenario, run_experiment
    from repro_torch.fl.distributed import FLTrainStep, choose_fl_hierarchy
    from repro_torch.launch.world import run_world
    from repro_torch.models import get_model
    from repro_torch.optim import sgd
    from repro_torch.utils.trees import flat_buffer_of

    counters = _counters()
    phase_t0 = time.perf_counter()
    phase("27. the aggregation tree across ranks: the sharded pooled TPD, "
          "the paper MLP on 8 ranks, stablelm-1.6b on 4")
    paths = {}

    def pso_placement(h):
        cm = CostModel(h, ClientPool.random(h.total_clients, seed=SEED),
                       device="cpu")
        return FlagSwapPSO(h.dimensions, h.total_clients, n_particles=10,
                           seed=SEED).run(
            None, DIST_PSO_ITERATIONS, batch_fitness_fn=cm.batch_fitness)

    # ---- (a) the sharded pooled TPD ------------------------------------
    def tpd_case(name, h, n_rows):
        models = [CostModel(h, ClientPool.random(h.total_clients, seed=s),
                            memory_penalty=0.3, device="cuda")
                  for s in range(DIST_TPD_POOLS)]
        rng = np_.random.default_rng(SEED)
        ps = np_.stack([rng.permutation(h.total_clients)[:h.dimensions]
                        for _ in range(n_rows)]).astype(np_.int32)
        idx = rng.integers(0, DIST_TPD_POOLS, size=n_rows)
        t0 = time.perf_counter()
        want = PooledTPDEvaluator(models, shard="off").tpds(ps, pool_idx=idx)
        np_s = time.perf_counter() - t0
        for ndev in DIST_TPD_NDEV:
            ev = PooledTPDEvaluator(models, shard="on")
            ev.tpds_sharded(ps, pool_idx=idx, ndev=ndev)    # tables built
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = ev.tpds_sharded(ps, pool_idx=idx, ndev=ndev)
            s = time.perf_counter() - t0
            rel = float(np_.max(np_.abs(got - want) / np_.abs(want)))
            print(f"(a) {name}, {n_rows} rows over {DIST_TPD_POOLS} pools: "
                  f"tpds_sharded(ndev={ndev}) on cuda exact "
                  f"{bool(np_.array_equal(got, want))}, largest rel diff "
                  f"{rel:.3e} (rtol {DIST_TPD_RTOL}); {s * 1e3:.2f} ms, "
                  f"numpy shard='off' {np_s * 1e3:.2f} ms (host clock) "
                  f"[{card}]")
            check(got.dtype == np_.float64 and rel <= DIST_TPD_RTOL,
                  f"(a) {name} ndev={ndev}: {rel} beyond {DIST_TPD_RTOL}")

    zero_counts(*counters)
    tpd_case("the reference test's case (24 clients; the pad path)",
             Hierarchy(3, 2, 2, n_clients=24), 21)
    h1k = get_scenario("large-1k").make_environment(0, device="cpu").hierarchy
    tpd_case(f"large-1k ({h1k.total_clients} clients)", h1k,
             DIST_TPD_LARGE_P)
    sharded = kernel_counts(*counters)
    check(sum(sharded.values()) == 0,
          f"(a) the sharded pooled build launched {sharded}")

    # the Fig. 3 sweep, batched, shard='on' against 'off': the pooled
    # calls' placements recorded, the sharded calls counted
    seen, calls, runs, fig3 = {"on": [], "off": []}, [0], {}, {}
    base_tpds = cm_mod.PooledTPDEvaluator.tpds
    base_sharded = cm_mod.PooledTPDEvaluator.tpds_sharded

    def tpds_rec(self, placements, pool_idx=None):
        seen[self.shard].append(np_.array(placements, copy=True))
        return base_tpds(self, placements, pool_idx)

    def sharded_rec(self, *a, **k):
        calls[0] += 1
        return base_sharded(self, *a, **k)

    cm_mod.PooledTPDEvaluator.tpds = tpds_rec
    cm_mod.PooledTPDEvaluator.tpds_sharded = sharded_rec
    try:
        for shard in ("off", "on"):
            zero_counts(*counters)  # the counts to 0 just before the path
            t0 = time.perf_counter()
            runs[shard] = run_experiment(
                "paper-fig3", ["pso", "random"], seeds=(0, 1),
                progress=False, device="cuda",
                eval_config=EvalConfig(mode="batched", shard=shard))
            fig3[shard] = (kernel_counts(*counters),
                           time.perf_counter() - t0)
    finally:
        cm_mod.PooledTPDEvaluator.tpds = base_tpds
        cm_mod.PooledTPDEvaluator.tpds_sharded = base_sharded
    same = len(seen["on"]) == len(seen["off"]) > 0 and all(
        np_.array_equal(a, b) for a, b in zip(seen["on"], seen["off"]))
    on_t = [list(r.tpds) for r in runs["on"].runs]
    off_t = [list(r.tpds) for r in runs["off"].runs]
    rel = max(float(np_.max(np_.abs(np_.subtract(a, b)) / np_.abs(b)))
              for a, b in zip(on_t, off_t, strict=True))
    print(f"(a) run_experiment('paper-fig3', pso and random, "
          f"{len(on_t[0])} rounds, seeds 0 and 1, batched) on cuda, "
          f"shard='on' ({fig3['on'][1]:.2f} s, {calls[0]} sharded calls) "
          f"against shard='off' ({fig3['off'][1]:.2f} s): "
          f"{len(seen['on'])} pooled calls, placements equal {same}, TPDs "
          f"exact {on_t == off_t}, largest rel diff {rel:.3e}; TPD kernel "
          f"launches {fig3['on'][0]['tpd']} and {fig3['off'][0]['tpd']} "
          f"[{card}]")
    check(same and calls[0] == len(seen["on"]),
          "(a) Fig. 3 shard='on': placements differ from shard='off' or "
          "the sharded path did not run")
    check(rel <= DIST_TPD_RTOL and fig3["on"][0] == fig3["off"][0],
          f"(a) Fig. 3 shard='on': TPDs {rel}, launches {fig3}")
    paths["(a) Fig. 3 shard='on'"] = fig3["on"][0]
    print(f"(a) done {time.perf_counter() - phase_t0:.1f} s into phase 27")

    # ---- (b) the paper MLP on 8 ranks ----------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("paper-mlp-1m8")
    trees = [(h, pso_placement(h)) for h in
             (choose_fl_hierarchy(c) for _, _, c in DIST_MLP_LAYOUTS)]
    print(f"(b, c) every rank's tensors on cuda:0 over gloo, which stages "
          f"each collective's 64 MiB chunks through pinned host memory "
          f"inside the collective (its time is the step's); no other "
          f"host staging")
    t0 = time.perf_counter()
    res = run_world(dist_mlp_rank, DIST_MLP_RANKS,
                    ({"cfg": cfg, "device": "cuda", "trees": trees},),
                    timeout=DIST_WORLD_TIMEOUT_S)
    world_s = time.perf_counter() - t0
    rank_counts = {k: sum(r["counts"][k] for r in res)
                   for k in res[0]["counts"]}
    host = {}                 # the host path, once a client count
    zero_counts(*counters)
    for n_total in sorted({c * (d[0] if "pod" in a else 1)
                           for d, a, c in DIST_MLP_LAYOUTS}):
        h = choose_fl_hierarchy(n_total)
        fl = FLTrainStep(get_model(cfg), sgd(DIST_FL_LR), h,
                         np_.arange(h.dimensions), local_steps=DIST_MLP_STEPS)
        params, states = fl.init_stacked(
            torch.Generator("cuda").manual_seed(SEED))
        ds = make_federated_dataset(cfg, n_total, SEED)
        batch = {k: torch.stack([torch.as_tensor(
            ds.client_batch(c, DIST_MLP_BATCH, 0)[k])
            for c in range(n_total)]).to("cuda") for k in ("x", "y")}
        params, _, metrics = fl.make_round_fn()(params, states, batch)
        host[n_total] = (flat_buffer_of(params, lead=1).cpu().numpy(),
                         float(metrics["loss"]))
    host_counts = kernel_counts(*counters)
    check(host_counts["fedavg"] == len(host)
          and sum(host_counts.values()) == len(host),
          f"(b) host path launches {host_counts}: one FedAvg a round")
    rounds0 = res[0]["rounds"]
    for j, r0 in enumerate(rounds0):
        dims, axes, per_pod = DIST_MLP_LAYOUTS[j // 2]
        n_total = per_pod * (dims[0] if "pod" in axes else 1)
        want, want_loss = host[n_total]
        sums = {r["rounds"][j]["checksum"] for r in res}
        err = float(np_.max(np_.abs(r0["params"] - want[0])))
        ok = bool(np_.allclose(r0["params"], want[0], **DIST_MLP_TOL))
        split = "; ".join(f"{s['step']} {s['ms']:.2f} ms"
                          for s in r0["stats"])
        moved = bytes_by_step([r["rounds"][j]["stats"] for r in res])
        print(f"(b) paper-mlp-1m8 (N {want.shape[1]}), mesh {dims} over "
              f"{axes}, {n_total} clients, "
              f"{DIST_MLP_RANKS // n_total} rank(s) a client, "
              f"{r0['mode']}: every rank bit-equal {len(sums) == 1}; "
              f"against the host path on cuda max abs err {err:.3e} "
              f"(within {DIST_MLP_TOL}: {ok}), loss {r0['loss']:.7f} vs "
              f"{want_loss:.7f}; rank 0's split: {split}; bytes in, all "
              f"ranks: {json.dumps(moved)} [{card}]")
        check(len(sums) == 1 and ok, f"(b) {dims} {axes} {r0['mode']}: "
                                     f"ranks differ or beyond {DIST_MLP_TOL}")
        check(abs(r0["loss"] - want_loss) <= 1e-5 * abs(want_loss),
              f"(b) loss {r0['loss']} vs {want_loss}")
    for j in range(0, len(rounds0), 2):
        check(bool(np_.allclose(rounds0[j]["params"],
                                rounds0[j + 1]["params"], **DIST_MLP_TOL)),
              f"(b) hierarchical and flat differ on {rounds0[j]['dims']}")
    print(f"(b) 8-rank world {world_s:.1f} s (spawn to join); peak memory "
          f"a rank {[round(r['peak'] / 2**20, 1) for r in res]} MiB; "
          f"launches: ranks "
          f"{json.dumps({k: v for k, v in rank_counts.items() if v})}, "
          f"host path "
          f"{json.dumps({k: v for k, v in host_counts.items() if v})} "
          f"({time.perf_counter() - phase_t0:.1f} s into phase 27) [{card}]")
    paths["(b) ranks"] = rank_counts
    paths["(b) host path"] = host_counts

    # ---- (c) stablelm-1.6b at full width on 4 ranks ---------------------
    gc.collect()
    torch.cuda.empty_cache()
    lm = get_config(DIST_LM_ARCH)
    h = Hierarchy(*DIST_LM_TREE[:3], n_clients=DIST_LM_TREE[3])
    cut, need, parts = lm_depth(torch, lm, DIST_LM_RANKS,
                                max_layers=DIST_LM_LAYERS)
    cut = cut.replace(remat=FL_CLIENT_REMAT)
    placement = pso_placement(h)
    gib = {k: round(v / 2**30, 3) for k, v in parts.items()}
    print(f"(c) {DIST_LM_ARCH} at full width (d_model {lm.d_model}, "
          f"{lm.n_heads} heads of {lm.resolved_head_dim}, d_ff {lm.d_ff}, "
          f"vocab {lm.vocab_size}), {cut.n_layers} of {lm.n_layers} layers: "
          f"at most {DIST_LM_LAYERS}, the deepest whose {DIST_LM_RANKS} "
          f"ranks leave "
          f"{DIST_FREE_BYTES / 2**30:.0f} GiB of the card free (GiB: "
          f"{json.dumps(gib)}; "
          f"{need / 2**30:.1f} GiB estimated in all); tree {DIST_LM_TREE}, "
          f"PSO placement {placement.tolist()}, sgd({DIST_FL_LR}), "
          f"{DIST_LM_STEPS} local steps of 1 x {DIST_LM_TOKENS} tokens, "
          f"rounds {DIST_LM_MODES} [{card}]")
    t0 = time.perf_counter()
    res = run_world(dist_lm_rank, DIST_LM_RANKS,
                    ({"cfg": cut, "device": "cuda",
                      "placement": placement},),
                    timeout=DIST_WORLD_TIMEOUT_S)
    world_s = time.perf_counter() - t0
    n_params = res[0]["n_params"]
    hostr = res[0]["host"]
    check(hostr["init_equal"], "(c) the host path's init differs from the "
                               "ranks' (one seeded generator)")
    for i, mode in enumerate(DIST_LM_MODES):
        r0, hr = res[0]["rounds"][i], hostr["rounds"][i]
        losses = [r["rounds"][i]["loss"] for r in res]
        split = "; ".join(
            f"{s['step']} {s['ms']:.1f} ms" + (
                f" ({s['ranks']} ranks)" if "ranks" in s else "")
            for s in r0["stats"])
        moved = bytes_by_step([r["rounds"][i]["stats"] for r in res])
        share = hr["outside"] / n_params
        print(f"(c) round {i + 1} ({mode}): {r0['s']:.2f} s on rank 0 "
              f"({split}; D2H of its params {r0['d2h_s']:.2f} s; bytes "
              f"in, all ranks: {json.dumps(moved)}); loss "
              f"{r0['loss']:.6f}, host path {hr['loss']:.6f} ({hr['s']:.2f}"
              f" s: " + "; ".join(f"{s['step']} {s['ms']:.1f} ms"
                                   for s in hr["stats"])
              + f"); params against the host path: max abs err "
              f"{hr['max_abs_err']:.3e}, {hr['outside']} of {n_params} "
              f"({share:.2e}) outside {DIST_LM_PARAM_TOL} [{card}]")
        check(all(v == losses[0] for v in losses),
              f"(c) ranks report different losses {losses}")
        check(math.isfinite(r0["loss"]) and abs(r0["loss"] - hr["loss"])
              <= DIST_LM_LOSS_RTOL * abs(hr["loss"]),
              f"(c) round {i + 1} loss {r0['loss']} vs {hr['loss']}")
        check(share <= DIST_LM_OUTSIDE and hr["rows_equal"],
              f"(c) round {i + 1}: {hr['outside']} params outside "
              f"{DIST_LM_PARAM_TOL}, or the host rows differ")
    rank_counts = {k: sum(r["counts"][k] for r in res)
                   for k in res[0]["counts"]}
    steps = DIST_LM_STEPS * len(DIST_LM_MODES)
    layers = cut.n_layers
    fwd = 2 if cut.remat else 1                     # remat's recompute
    want_rank = {"flash_attention": DIST_LM_RANKS * steps * fwd * layers,
                 "flash_attention_bwd": DIST_LM_RANKS * steps * 3 * layers}
    want_host = {"flash_attention": h.total_clients * steps * fwd * layers,
                 "flash_attention_bwd": h.total_clients * steps * 3 * layers,
                 "fedavg": len(DIST_LM_MODES)}
    peaks = [r["peak"] for r in res]
    reserved = [r["reserved"] for r in res]
    total = torch.cuda.get_device_properties(0).total_memory
    use = sum(reserved) + DIST_LM_RANKS * parts["context"] + parts["held"]
    print(f"(c) 4-rank world {world_s:.1f} s (spawn to join; init "
          f"{res[0]['init_s']:.1f} s a rank); peak memory a rank "
          f"{[round(p / 2**30, 2) for p in peaks]} GiB allocated, "
          f"{[round(p / 2**30, 2) for p in reserved]} GiB reserved; with "
          f"the contexts and this process {use / 2**30:.2f} GiB of the "
          f"card's {total / 2**30:.2f} GiB; the host path "
          f"{hostr['peak'] / 2**30:.2f} GiB; launches: ranks "
          f"{json.dumps({k: v for k, v in rank_counts.items() if v})}, host "
          f"path {json.dumps({k: v for k, v in hostr['counts'].items() if v})}"
          f" [{card}]")
    check({k: v for k, v in rank_counts.items() if v} == want_rank,
          f"(c) rank launches {rank_counts}, expected {want_rank}")
    check({k: v for k, v in hostr["counts"].items() if v} == want_host,
          f"(c) host path launches {hostr['counts']}, expected {want_host}")
    check(use <= total - DIST_FREE_BYTES,
          f"(c) the ranks' peaks {reserved} leave less than "
          f"{DIST_FREE_BYTES} bytes of the card free ({parts})")
    paths["(c) ranks"] = rank_counts
    paths["(c) host path"] = hostr["counts"]
    print("phase 27 launches by path: " + json.dumps(
        {p: {k: v for k, v in c.items() if v} for p, c in paths.items()}))
    print(f"phase 27 took {time.perf_counter() - phase_t0:.1f} s [{card}]")
    return {k: {"phase 27": sum(c[k] for c in paths.values())}
            for k in res[0]["counts"]}


# ---------------------------------------------------------------------------
# phase 28: granite-8b tensor- and sequence-parallel over 4 ranks
# ---------------------------------------------------------------------------
TP_ARCH = "granite-8b"
TP_RANKS = 4
TP_WAVE = (4, 1024)                # (a): one wave of 4 x 1024 prompts
TP_NEW_TOKENS = 8                  # (a): greedy decode steps
TP_GRAD_TOKENS = 2048              # (b): a batch of 1 x 2048
TP_SEQ = (False, True)             # seq_shard off, then on
TP_LOSS_RTOL = 1e-3
TP_GRAD_REL_L2 = 2e-2              # (b): the gradient's rel L2 asked for
# (b): each leaf's rel L2 against the unsharded bf16 gradient, at most
# this many times that gradient's own gap to the float32 one (two bf16
# roundings of one float32 gradient lie within twice its gap)
TP_GRAD_BAND = 2.0
TP_FREE_BYTES = 10 * 2 ** 30       # what phase 28 leaves free on the card
# depth caps for the script's time: serving ran all 36 layers (46-64 s
# of phase 28's 108-116 s on an H100 80GB HBM3 at 700 W), the gradient
# 15; 12 and 8 (phase 28 54-62 s) left the script too little room
TP_SERVE_LAYERS = 6
TP_GRAD_LAYERS = 4
TP_WORLD_TIMEOUT_S = 600
TP_CHUNK = 2 ** 26                 # elements a comparison moves at once


def tp_param_bytes(model, ranks) -> dict:
    """A rank's bytes of the model's params, by ``param_pspecs`` over the
    meta shapes: {"sharded": bytes of the leaves split over the model
    axis (their 1/ranks), "replicated": the others' whole bytes}."""
    from repro_torch.utils.trees import tree_map_with_path
    out = {"sharded": 0, "replicated": 0}

    def one(path, x, spec):
        n = x.numel() * x.element_size()
        if "model" in spec:
            out["sharded"] += n // ranks
        else:
            out["replicated"] += n

    tree_map_with_path(one, model.param_shapes(), model.param_pspecs())
    return out


def tp_layer_params(cfg) -> int:
    """Params of one layer of the dense decoder ``cfg``."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) \
        + 3 * d * cfg.d_ff + 2 * d


def tp_serve_bytes(cfg, ranks) -> int:
    """One process's peak in a wave of TP_WAVE prompts of the decoder
    ``cfg`` split over ``ranks``: its f32 params (all but the norms
    split), its part of the bf16 cache, and the prefill's working set (a
    layer's f32 FFN activations and partial sums, the stream and its
    copies), with 1 GiB of slack."""
    b, s = TP_WAVE
    d, hd = cfg.d_model, cfg.resolved_head_dim
    params = 4 * (tp_layer_params(cfg) * cfg.n_layers
                  + 2 * cfg.padded_vocab * d) // ranks
    cache = 2 * 2 * cfg.n_layers * b * (s + 64) * cfg.n_kv_heads * hd \
        // ranks
    work = 4 * b * s * (3 * cfg.d_ff // ranks + 12 * d)
    return params + cache + work + 2 ** 30


def tp_grad_bytes(cfg, ranks) -> int:
    """One process's peak in a gradient of 1 x TP_GRAD_TOKENS of ``cfg``
    split over ``ranks`` (``torch.autograd.grad``, remat): 12 bytes a
    layer param (the f32 param, its gradient, and the stack the layers'
    ``unbind`` backward builds of the per-layer gradients) and 8 of the
    others, six f32 copies of its part of the logits, the remat
    checkpoints (a bf16 stream a layer) and one layer's recomputed
    activations, and 1 GiB of slack. (At 8 bytes a layer param, 21
    layers ran out of memory on an H100 80GB HBM3.)"""
    s, d = TP_GRAD_TOKENS, cfg.d_model
    params = (12 * tp_layer_params(cfg) * cfg.n_layers
              + 8 * 2 * cfg.padded_vocab * d) // ranks
    logits = 6 * 4 * s * cfg.padded_vocab // ranks
    work = 2 * s * d * cfg.n_layers + 4 * s * (6 * cfg.d_ff // ranks
                                               + 16 * d)
    return params + logits + work + 2 ** 30


def tp_depth(torch, cfg, per_process, ranks, context, kept=lambda cut: 0,
             max_layers=None):
    """The deepest cut of ``cfg``, of at most ``max_layers`` layers,
    whose unsharded run in this process and whose ``ranks`` (each
    ``per_process(cut, ranks)`` plus a CUDA context, beside
    ``kept(cut)`` bytes this process keeps for them) each leave
    TP_FREE_BYTES of the card free. Returns (cut, {"parent", "ranks"}:
    bytes estimated)."""
    free, total = torch.cuda.mem_get_info()
    held = total - free
    for layers in range(min(cfg.n_layers, max_layers or cfg.n_layers),
                        0, -1):
        cut = cfg.replace(n_layers=layers)
        need = {"parent": held + per_process(cut, 1),
                "ranks": held + kept(cut)
                + ranks * (per_process(cut, ranks) + context)}
        if max(need.values()) <= total - TP_FREE_BYTES:
            return cut, need
    raise SmokeFailure(f"no depth of {cfg.name} fits phase 28")



def tp_paths(skeleton, n: int) -> list:
    """The paths of a tree's ``n`` leaves, in leaf order, from its
    skeleton (a ``tree_flatten`` rebuild)."""
    from repro_torch.utils.trees import tree_map_with_path
    out = []
    tree = skeleton(list(range(n)))                # leaf i -> i
    tree_map_with_path(lambda path, i: out.append((i, path)), tree)
    return [path for _, path in sorted(out)]


def rel_l2(torch, a, b) -> float:
    """||a - b|| / ||b|| in float64, a slab at a time."""
    a, b = a.reshape(-1), b.reshape(-1)
    num = den = 0.0
    for i in range(0, a.numel(), TP_CHUNK):
        d = b[i:i + TP_CHUNK].double()
        num += float((a[i:i + TP_CHUNK].double() - d).square().sum())
        den += float(d.square().sum())
    return (num / max(den, 1e-300)) ** 0.5


def tp_view(x, spec, mesh):
    """This rank's part of the full ``x`` under ``spec``, a view (no
    copy: ``x`` may be another process's tensor, opened by CUDA IPC)."""
    for d, axis in enumerate(spec):
        if axis is not None:
            n = x.shape[d] // mesh.shape[axis]
            x = x.narrow(d, mesh.axis_index(axis) * n, n)
    return x


def _collective_ms(traffic) -> float:
    return sum(row[2] for row in traffic.values()) * 1e3


def _world_check_equal(torch, x, group=None) -> bool:
    """Whether every rank of ``group`` (None: the world) holds the same
    bits of the 1-D ``x``."""
    import torch.distributed as dist

    from repro_torch.fl.distributed import bits_checksum
    check_ = bits_checksum(x.reshape(-1))
    lo, hi = check_.clone(), check_.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    return int(lo) == int(hi)


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


NORM_PATHS = ("layers/ln1/scale", "layers/ln2/scale", "ln_f/scale")


def _rel_l2_sharded(torch, g, want, spec, mesh, dev) -> float:
    """The relative L2 error of the global leaf whose shard ``g`` this
    rank holds against ``want`` (this rank's part of the reference leaf,
    a view; ``spec`` the leaf's), float64, a slab of the leading dim at
    a time; the ranks' sums are added where ``spec`` splits the leaf
    (a shard held on several ranks adds to both sums alike)."""
    import torch.distributed as dist
    sums = torch.zeros(2, dtype=torch.float64, device=dev)
    pairs = zip(g.unbind(0), want.unbind(0)) if g.dim() == 3 \
        else [(g.reshape(1, -1) if g.dim() == 1 else g,
               want.reshape(1, -1) if want.dim() == 1 else want)]
    for gl, wl in pairs:
        step = max(1, TP_CHUNK // gl.shape[-1])
        for i in range(0, gl.shape[0], step):
            # to the card first: a host reference converts there, not on
            # the rank's one intra-op thread
            w = wl[i:i + step].to(dev).double()
            sums[0] += (gl[i:i + step].double() - w).square().sum()
            sums[1] += w.square().sum()
    if any(a is not None for a in spec):
        dist.all_reduce(sums)
    return float((sums[0] / sums[1].clamp_min(1e-300)).sqrt())


def tp_rank(rank, world, spec):
    """Phase 28, one rank of the (1, world) data x model mesh on the one
    card: (a) this rank's shards of the seeded serving cut, one wave's
    prefill and TP_NEW_TOKENS decode steps fed the reference's greedy
    tokens, with seq_shard off and then on; (b) its shards of the
    gradient cut, one gradient of the batch with seq_shard off and on,
    each leaf held to the reference's gradient (shared host memory, cut
    by the same specs), the norms' gradients checked equal on every
    rank. Returns logits, losses, errors, times, collective traffic,
    peak memory, bytes held and kernel launches."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import RankMesh
    from repro_torch.models import get_model, make_policy
    from repro_torch.utils.trees import tree_flatten, tree_map_with_path

    dev = torch.device(spec.get("device", "cuda"))
    _rank_setup(torch, dev)
    counters = _counters()
    kflash = counters[0]
    mesh = RankMesh((1, world), ("data", "model"), device=dev)
    mesh.timed = True
    out = {"serve": [], "grad": []}
    on_card = dev.type == "cuda"

    def sync():
        _sync(torch, dev)

    def reset_peak():
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() if on_card else 0

    # ---- (a) serving -----------------------------------------------------
    cfg = spec["serve_cfg"]
    models = {seq: get_model(cfg, make_policy(mesh, seq_shard=seq))
              for seq in TP_SEQ}
    t0 = time.perf_counter()
    params = models[False].init(torch.Generator(dev).manual_seed(SEED), dev)
    sync()
    out["serve_init_s"] = time.perf_counter() - t0
    held = {"sharded": 0, "replicated": 0}
    full = tp_param_bytes(models[False], 1)
    specs = models[False].param_pspecs()

    def count(path, x, spec_):
        held["sharded" if "model" in spec_ else "replicated"] += \
            x.numel() * x.element_size()

    tree_map_with_path(count, params, specs)
    out["held"], out["full"] = held, full
    prompts = torch.as_tensor(spec["prompts"], device=dev)
    for seq in TP_SEQ:
        model = models[seq]
        zero_counts(*counters)
        mesh.traffic.clear()
        reset_peak()
        sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, state = model.prefill_fn(params, {"tokens": prompts})
            sync()
            prefill_s = time.perf_counter() - t0
            prefill_coll = _collective_ms(mesh.traffic)
            prefill_bytes = {k: v[1] for k, v in mesh.traffic.items()}
            steps, step_ms = [logits.float().cpu()], []
            mesh.traffic.clear()
            for j in range(TP_NEW_TOKENS):
                t1 = time.perf_counter()
                logits, state = model.decode_fn(params, state, {
                    "token": torch.as_tensor(spec["tokens"][:, j:j + 1],
                                             device=dev)})
                sync()
                step_ms.append((time.perf_counter() - t1) * 1e3)
                steps.append(logits.float().cpu())
        decode_coll = _collective_ms(mesh.traffic)
        counts = kernel_counts(*counters)
        if rank == 0:
            print(f"(a) rank 0, seq_shard={seq}: prefill {prefill_s:.3f} s "
                  f"({prefill_coll / 1e3:.3f} s in collectives), decode "
                  f"{statistics.median(step_ms):.2f} ms a token", flush=True)
        out["serve"].append({
            "seq": seq, "logits": torch.stack(steps).numpy(),
            "prefill_s": prefill_s, "prefill_coll_ms": prefill_coll,
            "prefill_bytes": prefill_bytes, "step_ms": step_ms,
            "decode_coll_ms": decode_coll, "counts": counts,
            "heads": dict(kflash.flash_attention.heads),
            "cache": tuple(state["cache"]["k"].shape), "peak": peak()})
        del state, logits
    del params, models
    if on_card:
        torch.cuda.empty_cache()
    dist.barrier()

    # ---- (b) the gradient -------------------------------------------------
    cfg = spec["grad_cfg"]
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in spec["grad_batch"].items()}
    ref = spec["ref_grads"]
    model = get_model(cfg, make_policy(mesh))
    params = model.init(torch.Generator(dev).manual_seed(SEED), dev)
    specs = model.param_pspecs()
    leaves, rebuild = tree_flatten(params)
    live = [x.detach().requires_grad_() for x in leaves]
    del params, leaves
    for seq in TP_SEQ:
        model = get_model(cfg, make_policy(mesh, seq_shard=seq))
        zero_counts(*counters)
        mesh.traffic.clear()
        reset_peak()
        sync()
        t0 = time.perf_counter()
        loss, _ = model.loss_fn(rebuild(live), batch)
        grads = torch.autograd.grad(loss, live)
        sync()
        step_s = time.perf_counter() - t0
        coll = _collective_ms(mesh.traffic)
        if rank == 0:
            print(f"(b) rank 0, seq_shard={seq}: step {step_s:.3f} s "
                  f"({coll / 1e3:.3f} s in collectives)", flush=True)
        counts = kernel_counts(*counters)
        heads = {"fwd": dict(kflash.flash_attention.heads),
                 "bwd": dict(kflash.flash_attention_bwd.heads)}
        top = peak()
        errs = {}
        tree = rebuild(list(grads))

        tree_map_with_path(lambda path, g, spec_, ref_full: errs.__setitem__(
            path, _rel_l2_sharded(torch, g, tp_view(ref_full, spec_, mesh),
                                  spec_, mesh, dev)), tree, specs, ref)
        norms_equal = all(_world_check_equal(torch, _leaf(tree, path))
                          for path in NORM_PATHS)
        out["grad"].append({"seq": seq, "loss": float(loss.detach()),
                            "step_s": step_s, "coll_ms": coll,
                            "bytes": {k: v[1] for k, v in
                                      mesh.traffic.items()},
                            "errs": errs, "norms_equal": norms_equal,
                            "counts": counts, "heads": heads, "peak": top})
        del loss, grads, tree
        if on_card:
            torch.cuda.empty_cache()
    return out


def tensor_parallel_phases(torch, np_, card):
    """Phase 28: full-width granite-8b over a (1, 4) data x model mesh of
    spawned gloo ranks on the one card, tensor-parallel with
    ``seq_shard`` off and on: (a) one wave's prefill and greedy decode
    against the unsharded path on the card, (b) one gradient against
    the unsharded gradient, (c) the bytes each rank holds and the flash
    launches on its own heads. Returns {kernel name: {path: launches}}."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch.world import run_world
    from repro_torch.models import get_model
    from repro_torch.utils.trees import tree_flatten, tree_map

    counters = _counters()
    phase_t0 = time.perf_counter()
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    phase(f"28. full-width {TP_ARCH} over a (1, {TP_RANKS}) data x model "
          f"mesh of gloo ranks on the card, seq_shard off and on: serving, "
          f"a gradient, each rank's bytes and flash launches")
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config(TP_ARCH)
    context = 600 * 2 ** 20        # a rank's CUDA context and gloo buffers
    serve_cfg, serve_need = tp_depth(torch, full, tp_serve_bytes, TP_RANKS,
                                     context, max_layers=TP_SERVE_LAYERS)
    # the unsharded gradient stays on the card, read by the ranks
    grad_cfg, grad_need = tp_depth(torch, full, tp_grad_bytes, TP_RANKS,
                                   context, lambda c: 4 * (tp_layer_params(c) * c.n_layers
                                                + 2 * c.padded_vocab
                                                * c.d_model),
                                   max_layers=TP_GRAD_LAYERS)
    gib = lambda d: {k: round(v / 2 ** 30, 2) for k, v in d.items()}
    print(f"(a) serving at {serve_cfg.n_layers} of {full.n_layers} layers "
          f"(at most {TP_SERVE_LAYERS}; GiB estimated: "
          f"{json.dumps(gib(serve_need))}); (b) the gradient at "
          f"{grad_cfg.n_layers} layers, at most {TP_GRAD_LAYERS} and the "
          f"deepest whose unsharded step, and whose {TP_RANKS} ranks beside "
          f"that gradient, each leave {TP_FREE_BYTES / 2**30:.0f} GiB free (GiB "
          f"estimated: {json.dumps(gib(grad_need))}) [{card}]")

    # ---- the unsharded references on the card ---------------------------
    rng = np_.random.default_rng(SEED)
    b, s = TP_WAVE
    prompts = rng.integers(0, full.vocab_size, (b, s)).astype(np_.int32)
    model = get_model(serve_cfg)
    params = model.init(torch.Generator(dev).manual_seed(SEED), dev)
    ref = {}
    with torch.no_grad():
        for dtype in ("bfloat16", "float32"):
            # float32 is fed bf16's greedy tokens: the two runs' gap
            # is the band bf16 rounding spans
            fed = ref["bfloat16"]["tokens"] if dtype == "float32" else None
            m = get_model(serve_cfg.replace(dtype=dtype))
            zero_counts(*counters)
            sync()
            t0 = time.perf_counter()
            logits, state = m.prefill_fn(params, {
                "tokens": torch.as_tensor(prompts, device=dev)})
            sync()
            prefill_s = time.perf_counter() - t0
            steps, tokens, step_ms = [logits.float().cpu()], [], []
            for j in range(TP_NEW_TOKENS):
                tok = logits[:, -1].argmax(-1, keepdim=True).int() \
                    if fed is None else torch.as_tensor(fed[:, j:j + 1],
                                                        device=dev)
                tokens.append(tok.cpu().numpy())
                t1 = time.perf_counter()
                logits, state = m.decode_fn(params, state, {"token": tok})
                sync()
                step_ms.append((time.perf_counter() - t1) * 1e3)
                steps.append(logits.float().cpu())
            ref[dtype] = {"logits": torch.stack(steps),
                          "tokens": np_.concatenate(tokens, 1),
                          "prefill_s": prefill_s, "step_ms": step_ms}
            del state, logits
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    ref16, ref32 = ref["bfloat16"], ref["float32"]
    # the sharded and the unsharded bf16 runs are two roundings of one
    # float32 result, each about its bf16 gap away from it: they agree
    # within twice that gap
    gap = float((ref16["logits"] - ref32["logits"]).abs().max())
    band = 2 * gap
    print(f"(a) unsharded on the card: prefill {ref16['prefill_s']:.3f} s a "
          f"wave, decode {statistics.median(ref16['step_ms']):.2f} ms a "
          f"token (median of {TP_NEW_TOKENS}); bf16 against float32 "
          f"(the f32 run fed bf16's greedy tokens): max abs {gap:.4e} over "
          f"the last-token logits of prefill and decode; the sharded run "
          f"is held to twice that, {band:.4e} [{card}]")

    grad_batch = {"tokens": rng.integers(0, full.vocab_size,
                                         (1, TP_GRAD_TOKENS)).astype(np_.int32)}
    grad_batch["labels"] = np_.roll(grad_batch["tokens"], -1, axis=1)
    batch_dev = {k: torch.as_tensor(v, device=dev)
                 for k, v in grad_batch.items()}

    def unsharded_grad(dtype):
        """(loss, the gradient's leaves, the tree's skeleton, seconds,
        peak bytes) of the cut at ``dtype`` compute, from the seed."""
        model = get_model(grad_cfg.replace(dtype=dtype))
        params = model.init(torch.Generator(dev).manual_seed(SEED), dev)
        live, rebuild = tree_flatten(params)
        # the structure alone: a rebuild holds the leaves it was made from
        _, skeleton = tree_flatten(tree_map(lambda x: None, params))
        del params
        for x in live:
            x.requires_grad_()
        torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        loss, _ = model.loss_fn(rebuild(live), batch_dev)
        grads = list(torch.autograd.grad(loss, live))
        sync()
        return (float(loss.detach()), grads, skeleton,
                time.perf_counter() - t0, torch.cuda.max_memory_allocated())

    # float32 first: bf16's per-leaf gap to it is the band the ranks'
    # bf16 gradient is held to
    loss32, g32, _, step32_s, _ = unsharded_grad("float32")
    ref_loss, g16, skeleton, ref_step_s, ref_peak = unsharded_grad("bfloat16")
    gaps = {}
    for path, a, b in zip(tp_paths(skeleton, len(g16)), g16, g32,
                          strict=True):
        gaps[path] = rel_l2(torch, a, b)
    del g32
    # the gradient stays on the card; the ranks open it by CUDA IPC
    ref_grads = skeleton(g16)
    del g16
    gc.collect()
    torch.cuda.empty_cache()
    print(f"(b) unsharded gradient of 1 x {TP_GRAD_TOKENS} at "
          f"{grad_cfg.n_layers} layers: loss {ref_loss:.6f} (float32 "
          f"compute {loss32:.6f}), {ref_step_s:.3f} s ({step32_s:.3f} s in "
          f"float32), peak {ref_peak / 2**30:.2f} GiB; bf16 against float32, "
          f"relative L2 per leaf: " + ", ".join(
              f"{k} {v:.2e}" for k, v in sorted(gaps.items()))
          + f"; its {sum(x.numel() for x in tree_flatten(ref_grads)[0]) * 4 / 1e9:.2f}"
          f" GB kept on the card for the ranks "
          f"({time.perf_counter() - phase_t0:.1f} s into phase 28) [{card}]")

    # ---- the ranks ---------------------------------------------------------
    t0 = time.perf_counter()
    res = run_world(tp_rank, TP_RANKS, ({
        "serve_cfg": serve_cfg, "grad_cfg": grad_cfg, "prompts": prompts,
        "tokens": ref16["tokens"], "grad_batch": grad_batch,
        "ref_grads": ref_grads},), timeout=TP_WORLD_TIMEOUT_S)
    world_s = time.perf_counter() - t0
    del ref_grads
    gc.collect()

    # ---- (a) checks ----------------------------------------------------------
    paths = {}
    r0 = res[0]
    layers = serve_cfg.n_layers
    hq, hkv = full.n_heads // TP_RANKS, full.n_kv_heads // TP_RANKS
    for i, seq in enumerate(TP_SEQ):
        got = r0["serve"][i]
        logits = torch.as_tensor(got["logits"])
        err = float((logits - ref16["logits"]).abs().max())
        err32 = float((logits - ref32["logits"]).abs().max())
        greedy = all(greedy_in_band(torch, logits[j], ref16["logits"][j],
                                    band) for j in range(TP_NEW_TOKENS + 1))
        same = all(np_.array_equal(r["serve"][i]["logits"], got["logits"])
                   for r in res)
        med = statistics.median(got["step_ms"])
        dec_share = got["decode_coll_ms"] / sum(got["step_ms"])
        print(f"(a) seq_shard={seq}: prefill {got['prefill_s']:.3f} s a "
              f"wave ({got['prefill_coll_ms'] / 1e3:.3f} s, "
              f"{got['prefill_coll_ms'] / 1e3 / got['prefill_s']:.1%}, in "
              f"collectives; bytes in, rank 0: "
              f"{json.dumps(got['prefill_bytes'])}); decode {med:.2f} ms a "
              f"token (median of {TP_NEW_TOKENS}; {dec_share:.1%} in "
              f"collectives); peak a rank "
              f"{[round(r['serve'][i]['peak'] / 2**30, 2) for r in res]} "
              f"GiB; cache a rank {got['cache']}; last-token logits "
              f"against the unsharded bf16 run: max abs {err:.4e} (band "
              f"{band:.4e}; against the float32 run {err32:.4e}, the "
              f"unsharded bf16 run's {gap:.4e}), greedy in band {greedy}, "
              f"every rank's logits "
              f"equal {same}; flash launches by heads a rank "
              f"{[r['serve'][i]['heads'] for r in res]} [{card}]")
        check(err <= band and greedy and same,
              f"(a) seq_shard={seq}: logits {err} outside {band}, or the "
              f"greedy tokens part outside it, or the ranks differ")
        for r in res:
            check(r["serve"][i]["heads"] == {f"{hq}x{hkv}": layers},
                  f"(a) rank flash launches {r['serve'][i]['heads']}, "
                  f"expected {layers} on {hq} q and {hkv} kv heads")
            check(r["serve"][i]["cache"][3] == hkv,
                  f"(a) a rank's cache {r['serve'][i]['cache']}")
        paths[f"(a) serving, seq_shard={seq}"] = {
            k: sum(r["serve"][i]["counts"][k] for r in res)
            for k in r0["serve"][i]["counts"]}

    # ---- (b) checks ----------------------------------------------------------
    for i, seq in enumerate(TP_SEQ):
        got = r0["grad"][i]
        worst = max(got["errs"].items(), key=lambda kv: kv[1])
        ratio = max(got["errs"][k] / gaps[k] for k in gaps)
        losses = [r["grad"][i]["loss"] for r in res]
        rtol = abs(got["loss"] - ref_loss) / abs(ref_loss)
        print(f"(b) seq_shard={seq}: loss {got['loss']:.6f} against "
              f"{ref_loss:.6f} (rel {rtol:.2e}); step {got['step_s']:.3f} s "
              f"({got['coll_ms'] / 1e3:.3f} s, "
              f"{got['coll_ms'] / 1e3 / got['step_s']:.1%}, in collectives; "
              f"bytes in, rank 0: {json.dumps(got['bytes'])}); gradient "
              f"rel L2 per leaf: worst {worst[0]} {worst[1]:.3e} (at most "
              f"{ratio:.2f} times the leaf's bf16 gap to float32; "
              f"{TP_GRAD_REL_L2} asked), "
              + ", ".join(f"{k} {v:.2e}" for k, v in sorted(
                  got["errs"].items()))
              + f"; norms' gradients equal on every rank "
              f"{got['norms_equal']}; peak a rank "
              f"{[round(r['grad'][i]['peak'] / 2**30, 2) for r in res]} "
              f"GiB; flash heads {got['heads']} [{card}]")
        check(all(v == losses[0] for v in losses)
              and rtol <= TP_LOSS_RTOL and ratio <= TP_GRAD_BAND
              and got["norms_equal"],
              f"(b) seq_shard={seq}: losses {losses} vs {ref_loss}, worst "
              f"leaf {worst}, norms equal {got['norms_equal']}")
        n_layers = grad_cfg.n_layers
        remat = 2 if grad_cfg.remat else 1
        for r in res:
            check(r["grad"][i]["heads"] == {
                "fwd": {f"{hq}x{hkv}": remat * n_layers},
                "bwd": {f"{hq}x{hkv}": 3 * n_layers}},
                f"(b) rank flash launches {r['grad'][i]['heads']}")
        paths[f"(b) gradient, seq_shard={seq}"] = {
            k: sum(r["grad"][i]["counts"][k] for r in res)
            for k in r0["grad"][i]["counts"]}

    # ---- (c) bytes ------------------------------------------------------------
    for r in res:
        check(r["held"]["sharded"] * TP_RANKS == r["full"]["sharded"]
              and r["held"]["replicated"] == r["full"]["replicated"],
              f"(c) a rank holds {r['held']}, the model {r['full']}")
    print(f"(c) a rank holds {r0['held']['sharded'] / 2**30:.3f} GiB of the "
          f"model-sharded leaves ({r0['full']['sharded'] / 2**30:.3f} GiB "
          f"in all, 1/{TP_RANKS}) and {r0['held']['replicated'] / 2**20:.3f} "
          f"MiB of replicated ones (the norms), at {serve_cfg.n_layers} "
          f"layers; world {world_s:.1f} s from spawn to join, init "
          f"{r0['serve_init_s']:.1f} s a rank [{card}]")
    print("phase 28 launches by path: " + json.dumps(
        {p: {k: v for k, v in c.items() if v} for p, c in paths.items()}))
    print(f"phase 28 took {time.perf_counter() - phase_t0:.1f} s [{card}]")
    return {k: {f"phase 28 {p}": c[k] for p, c in paths.items()}
            for k in r0["serve"][0]["counts"]}


# ---------------------------------------------------------------------------
# phase 29: granite-8b over a data x model mesh: fsdp, and federated
# rounds of tensor-parallel clients
# ---------------------------------------------------------------------------
FSDP_DIMS = (2, 2)                 # (a): ("data", "model")
FSDP_WAVE = (4, 1024)              # (a): one prefill wave, 2 rows a data rank
FSDP_NEW_TOKENS = 8                # (a): greedy decode steps, fsdp off
FSDP_TRAIN = (2, 2048)             # (a): the global batch, 1 row a data rank
FSDP_STEPS = 2                     # (a): make_train_step steps, adamw()
# (a) the depth cuts: the time budget binds, not memory (each layer's
# fsdp gather moves its f32 shard through gloo, 1-2 s at its 0.2-0.5
# GB/s, three times a layer a training step with remat); at 4 and 2
# the phase took 105-129 s of its 120
FSDP_SERVE_LAYERS = 2
FSDP_TRAIN_LAYERS = 1
FSDP_LOSS_RTOL = 1e-4
FSDP_NORM_RTOL = 1e-3
FSDP_WINDOW = 2 ** 22              # (a): AdamW elements held at each end
FL_TP_DIMS = (4, 2)                # (b): 4 clients of 2 model ranks
FL_TP_TREE = (2, 1, 2, 4)          # (b): phase 27's tree
FL_TP_TOKENS = 512                 # (b): 1 x 512 a client a local step
FL_TP_LAYERS = 1                   # (b): the depth cut (time, as (a))
FL_TP_ROUNDS = 1                   # (b): the held round (a warm-up before
                                   # phase 30)
FL_TP_BAND = 2.0                   # (b): times the host path's bf16 gap


def fsdp_rank(rank, world, spec):
    """Phase 29 (a), one rank of the FSDP_DIMS data x model mesh on the
    one card: its shards of the seeded serving cut with fsdp on
    (``make_policy(mesh, fsdp=True, seq_shard=True)``, the reference's
    prefill layout) and one wave's prefill; the same cut drawn again
    with fsdp off (the decode layout) and FSDP_NEW_TOKENS decode steps
    fed the reference's greedy tokens; then FSDP_STEPS steps of
    ``make_train_step`` with ``adamw()`` on the training cut, fsdp on:
    the first step's gradient held leaf by leaf to the reference
    gradient (shared by CUDA IPC) and its pre-clip global norm, a window
    at each end of the rank's flat buffer held to the plain AdamW each
    step, the norms bit-equal on every rank after the steps."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.kernels.ref import fused_adamw_ref
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.models import get_model, make_policy
    from repro_torch.models.api import flat_params, make_train_step
    from repro_torch.optim import Optimizer, adamw
    from repro_torch.optim.optimizers import global_norm
    from repro_torch.utils.trees import flat_buffer_of, tree_map_with_path

    dev = torch.device(spec.get("device", "cuda"))
    _rank_setup(torch, dev)
    counters = _counters()
    kflash = counters[0]
    mesh = RankMesh(FSDP_DIMS, ("data", "model"), device=dev)
    mesh.timed = True
    on_card = dev.type == "cuda"
    out = {}

    def sync():
        _sync(torch, dev)

    def peak():
        return torch.cuda.max_memory_allocated() if on_card else 0

    def reset_peak():
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    def traffic():
        return {k: {"calls": v[0], "bytes": v[1], "ms": v[2] * 1e3}
                for k, v in mesh.traffic.items()}

    # ---- prefill, fsdp on --------------------------------------------------
    cfg = spec["serve_cfg"]
    model = get_model(cfg, make_policy(mesh, fsdp=cfg.fsdp, seq_shard=True))
    params = model.init(torch.Generator(dev).manual_seed(SEED), dev)
    prompts = torch.as_tensor(spec["prompts"], device=dev)
    zero_counts(*counters)
    mesh.traffic.clear()
    reset_peak()
    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, state = model.prefill_fn(params, {"tokens": prompts})
    sync()
    prefill = {"s": time.perf_counter() - t0, "traffic": traffic(),
               "counts": kernel_counts(*counters),
               "heads": dict(kflash.flash_attention.heads), "peak": peak(),
               "cache": tuple(state["cache"]["k"].shape)}
    steps = [logits.float().cpu()]
    del params, model
    # ---- decode, fsdp off --------------------------------------------------
    model = get_model(cfg, make_policy(mesh, seq_shard=True))
    params = model.init(torch.Generator(dev).manual_seed(SEED), dev)
    zero_counts(*counters)
    mesh.traffic.clear()
    reset_peak()
    step_ms = []
    with torch.no_grad():
        for j in range(FSDP_NEW_TOKENS):
            sync()
            t1 = time.perf_counter()
            logits, state = model.decode_fn(params, state, {
                "token": torch.as_tensor(spec["tokens"][:, j:j + 1],
                                         device=dev)})
            sync()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            steps.append(logits.float().cpu())
    decode = {"step_ms": step_ms, "traffic": traffic(),
              "counts": kernel_counts(*counters), "peak": peak()}
    if rank == 0:
        print(f"(a) rank 0: prefill {prefill['s']:.3f} s, decode "
              f"{statistics.median(step_ms):.1f} ms a token", flush=True)
    out["serve"] = {"logits": torch.stack(steps).numpy(),
                    "prefill": prefill, "decode": decode}
    del params, model, state, logits
    if on_card:
        torch.cuda.empty_cache()
    dist.barrier()

    # ---- training, fsdp on -------------------------------------------------
    cfg = spec["train_cfg"]
    model = get_model(cfg, make_policy(mesh, fsdp=cfg.fsdp, seq_shard=True))
    specs = model.param_pspecs()
    params = flat_params(model.init(torch.Generator(dev).manual_seed(SEED),
                                    dev))
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in spec["train_batch"].items()}
    inner = adamw()
    rec = {"check_s": 0.0, "adamw_same": [], "errs": {}}

    def update(p, g, state, **kw):
        """adamw's update; the first step's gradient is held to the
        reference first, and a window at each end of the flat buffer is
        held to the plain AdamW on every step (the checks' time kept
        apart from the step's)."""
        t_check = time.perf_counter()
        step = int(state.step) + 1
        if step == 1:
            rec["norm"] = float(global_norm(g, kw["shards"]))

            tree_map_with_path(
                lambda path, leaf, spec_, ref_full: rec["errs"].__setitem__(
                    path, _rel_l2_sharded(torch, leaf, tp_view(
                        ref_full, spec_, mesh), spec_, mesh, dev)),
                g, specs, spec["ref_grads"])
        flat = flat_buffer_of(p)
        n = flat.numel()
        wins = [slice(0, min(FSDP_WINDOW, n)), slice(max(n - FSDP_WINDOW, 0), n)]
        before = [[flat_buffer_of(t)[w].clone() for t in (p, state.mu,
                                                           state.nu)]
                  for w in wins]
        sync()
        rec["check_s"] += time.perf_counter() - t_check
        p, state = inner.update(p, g, state, **kw)
        t_check = time.perf_counter()
        same = True
        for w, (p0, m0, v0) in zip(wins, before, strict=True):
            want = fused_adamw_ref(p0, flat_buffer_of(g)[w].clone(), m0, v0,
                                   3e-4, *adamw_scalars(np, step))
            got = [flat_buffer_of(t)[w] for t in (p, state.mu, state.nu)]
            same &= all(torch.equal(a, b) for a, b in zip(got, want))
        rec["adamw_same"].append(same)
        sync()
        rec["check_s"] += time.perf_counter() - t_check
        return p, state

    step_fn = make_train_step(model, Optimizer(init=inner.init,
                                               update=update))
    state = inner.init(params)
    zero_counts(*counters)
    mesh.traffic.clear()
    reset_peak()
    train = {"steps": [], "losses": []}
    for _ in range(FSDP_STEPS):
        rec["check_s"] = 0.0
        before_traffic = {k: list(v) for k, v in mesh.traffic.items()}
        sync()
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, batch)
        sync()
        wall = time.perf_counter() - t0
        coll = sum(v[2] - before_traffic.get(k, [0, 0, 0.0])[2]
                   for k, v in mesh.traffic.items())
        train["steps"].append({"s": wall - rec["check_s"],
                               "check_s": rec["check_s"],
                               "coll_s": coll})
        train["losses"].append(float(metrics["loss"]))
    train.update(traffic=traffic(), counts=kernel_counts(*counters),
                 heads={"fwd": dict(kflash.flash_attention.heads),
                        "bwd": dict(kflash.flash_attention_bwd.heads)},
                 peak=peak(), norm=rec["norm"], errs=rec["errs"],
                 adamw_same=rec["adamw_same"])
    train["norms_equal"] = all(
        _world_check_equal(torch, _leaf(params, path).detach())
        for path in NORM_PATHS)
    out["train"] = train
    if rank == 0:
        print(f"(a) rank 0: steps {[round(s['s'], 3) for s in train['steps']]}"
              f" s", flush=True)
    return out


def fl_tp_rank(rank, world, spec):
    """Phase 29 (b), one rank of the FL_TP_DIMS data x model mesh on the
    one card: ``FLTrainStep`` with the reference's federated policy
    (model and seq axis, no batch or fsdp axes) and ``sgd``, a warm-up
    round, then the round held to the host path: the data-axis-0 ranks
    write their shards before and after it into the parent's buffers
    (CUDA IPC); every rank's shards after it are checked bit-equal
    along the data axis."""
    import torch

    from repro_torch.core.hierarchy import Hierarchy
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.fl.distributed import FLTrainStep
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.models import ShardingPolicy, get_model
    from repro_torch.optim import sgd
    from repro_torch.utils.trees import flat_buffer_of, tree_map_with_path

    dev = torch.device(spec.get("device", "cuda"))
    _rank_setup(torch, dev)
    counters = _counters()
    kflash = counters[0]
    mesh = RankMesh(FL_TP_DIMS, ("data", "model"), device=dev)
    cfg = spec["cfg"]
    model = get_model(cfg, ShardingPolicy(mesh=mesh, model_axis="model",
                                          seq_axis="model"))
    specs = model.param_pspecs()
    h = Hierarchy(*FL_TP_TREE[:3], n_clients=FL_TP_TREE[3])
    fl = FLTrainStep(model, sgd(DIST_FL_LR), h, spec["placement"],
                     local_steps=1, mode="hierarchical")
    t0 = time.perf_counter()
    params, state = fl.init_stacked(torch.Generator(dev).manual_seed(SEED))
    _sync(torch, dev)
    init_s = time.perf_counter() - t0
    ds = make_federated_dataset(cfg, h.total_clients, SEED, FL_TP_TOKENS)
    round_fn = fl.make_round_fn()
    peak = _peak_reset(torch, dev)
    zero_counts(*counters)
    first = mesh.axis_index("data") == 0

    def keep(into):
        if first:
            tree_map_with_path(
                lambda path, x, spec_, buf: tp_view(buf, spec_, mesh).copy_(x),
                params, specs, into)
            _sync(torch, dev)

    rounds = []
    for r in range(FL_TP_ROUNDS):           # the last one is held
        batch = {k: torch.as_tensor(v, device=dev) for k, v in
                 ds.client_batch(fl.client_index, 1, r).items()}
        if r == FL_TP_ROUNDS - 1:
            keep(spec["before"])
            mesh.timed = True
            mesh.traffic.clear()
        stats = []
        _sync(torch, dev)
        t0 = time.perf_counter()
        params, state, metrics = round_fn(params, state, batch, stats=stats)
        _sync(torch, dev)
        rounds.append({"s": time.perf_counter() - t0, "stats": stats,
                       "loss": float(metrics["loss"])})
    keep(spec["after"])
    equal = _world_check_equal(torch, flat_buffer_of(params),
                               mesh.axis_group("data"))
    if rank == 0:
        print(f"(b) rank 0: rounds {[round(x['s'], 3) for x in rounds]} s",
              flush=True)
    return {"rounds": rounds, "init_s": init_s, "equal": equal,
            "counts": kernel_counts(*counters),
            "heads": {"fwd": dict(kflash.flash_attention.heads),
                      "bwd": dict(kflash.flash_attention_bwd.heads)},
            "peak": peak()[0], "client": fl.client_index,
            "traffic": {k: v[:] for k, v in mesh.traffic.items()}}


def data_model_phases(torch, np_, card, device="cuda"):
    """Phase 29: full-width granite-8b over a data x model mesh of
    spawned gloo ranks on the one card: (a) fsdp over the data axis
    beside the model axis (prefill, decode with fsdp off, two AdamW
    steps) against the unsharded runs at the same cuts, (b) federated
    rounds of tensor-parallel clients against the host path. Returns
    {kernel name: {path: launches}}."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.core.hierarchy import Hierarchy
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.fl.distributed import FLTrainStep
    from repro_torch.launch.world import run_world
    from repro_torch.models import get_model
    from repro_torch.optim import sgd
    from repro_torch.utils.trees import (
        flat_buffer_of,
        tree_flatten,
        tree_global_norm,
        tree_map,
        tree_map_with_path,
    )

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    counters = _counters()
    phase_t0 = time.perf_counter()

    def sync():
        _sync(torch, dev)

    def free_card():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    phase(f"29. full-width {TP_ARCH} over data x model meshes of gloo ranks "
          f"on the card: (a) fsdp on {FSDP_DIMS}, (b) federated rounds of "
          f"tensor-parallel clients on {FL_TP_DIMS}")
    # the CPU rehearses the phase on the reduced config
    full = get_config(TP_ARCH) if on_card \
        else get_config(TP_ARCH).reduced().replace(fsdp=True)
    serve_cfg, train_cfg, fl_cfg = (
        full.replace(n_layers=min(n, full.n_layers))
        for n in (FSDP_SERVE_LAYERS, FSDP_TRAIN_LAYERS, FL_TP_LAYERS))
    fl_cfg = fl_cfg.replace(remat=FL_CLIENT_REMAT)
    print(f"(a) {TP_ARCH} (d_model {full.d_model}, {full.n_heads} q and "
          f"{full.n_kv_heads} kv heads of {full.resolved_head_dim}, d_ff "
          f"{full.d_ff}, vocab {full.vocab_size}, fsdp={full.fsdp}): "
          f"serving at {serve_cfg.n_layers} layers, training at "
          f"{train_cfg.n_layers}; (b) {fl_cfg.n_layers} layers [{card}]")
    free_card()

    # ---- (a) the unsharded references on the card -------------------------
    rng = np_.random.default_rng(SEED + 29)
    b, s = FSDP_WAVE
    prompts = rng.integers(0, full.vocab_size, (b, s)).astype(np_.int32)
    params = get_model(serve_cfg).init(torch.Generator(dev).manual_seed(SEED),
                                       dev)
    ref = {}
    with torch.no_grad():
        for dtype in ("bfloat16", "float32"):
            fed = ref["bfloat16"]["tokens"] if dtype == "float32" else None
            m = get_model(serve_cfg.replace(dtype=dtype))
            sync()
            t0 = time.perf_counter()
            logits, state = m.prefill_fn(params, {
                "tokens": torch.as_tensor(prompts, device=dev)})
            sync()
            prefill_s = time.perf_counter() - t0
            steps, tokens = [logits.float().cpu()], []
            for j in range(FSDP_NEW_TOKENS):
                tok = logits[:, -1].argmax(-1, keepdim=True).int() \
                    if fed is None else torch.as_tensor(fed[:, j:j + 1],
                                                        device=dev)
                tokens.append(tok.cpu().numpy())
                logits, state = m.decode_fn(params, state, {"token": tok})
                steps.append(logits.float().cpu())
            ref[dtype] = {"logits": torch.stack(steps),
                          "tokens": np_.concatenate(tokens, 1),
                          "prefill_s": prefill_s}
            del state, logits
    del params
    free_card()
    gap = float((ref["bfloat16"]["logits"]
                 - ref["float32"]["logits"]).abs().max())
    band = 2 * gap
    tb, ts = FSDP_TRAIN
    train_batch = {"tokens": rng.integers(0, full.vocab_size,
                                          (tb, ts)).astype(np_.int32)}
    train_batch["labels"] = np_.roll(train_batch["tokens"], -1, axis=1)
    batch_dev = {k: torch.as_tensor(v, device=dev)
                 for k, v in train_batch.items()}

    def unsharded_grad(dtype):
        model = get_model(train_cfg.replace(dtype=dtype))
        params = model.init(torch.Generator(dev).manual_seed(SEED), dev)
        live, rebuild = tree_flatten(params)
        _, skeleton = tree_flatten(tree_map(lambda x: None, params))
        del params
        for x in live:
            x.requires_grad_()
        sync()
        t0 = time.perf_counter()
        loss, _ = model.loss_fn(rebuild(live), batch_dev)
        grads = list(torch.autograd.grad(loss, live))
        sync()
        return float(loss.detach()), grads, skeleton, \
            time.perf_counter() - t0

    loss32, g32, _, _ = unsharded_grad("float32")
    ref_loss, g16, skeleton, ref_step_s = unsharded_grad("bfloat16")
    paths_ = tp_paths(skeleton, len(g16))
    gaps = {p: rel_l2(torch, a, b_) for p, a, b_ in zip(paths_, g16, g32,
                                                       strict=True)}
    ref_norm = float(tree_global_norm(g16))
    del g32
    ref_grads = skeleton(g16)
    del g16
    free_card()
    print(f"(a) unsharded on the card: prefill {ref['bfloat16']['prefill_s']:.3f}"
          f" s a wave; bf16 against float32 (fed bf16's greedy tokens): max "
          f"abs {gap:.4e} over the last-token logits, so the band {band:.4e};"
          f" gradient of {tb} x {ts}: loss {ref_loss:.6f} (float32 "
          f"{loss32:.6f}), global norm {ref_norm:.6f}, {ref_step_s:.3f} s; "
          f"bf16 against float32 a leaf (rel L2): " + ", ".join(
              f"{k} {v:.2e}" for k, v in sorted(gaps.items())) + f" [{card}]")

    # ---- (a) the ranks ---------------------------------------------------
    t0 = time.perf_counter()
    res = run_world(fsdp_rank, math.prod(FSDP_DIMS), ({
        "device": str(dev), "serve_cfg": serve_cfg, "train_cfg": train_cfg,
        "prompts": prompts, "tokens": ref["bfloat16"]["tokens"],
        "train_batch": train_batch, "ref_grads": ref_grads},),
        timeout=TP_WORLD_TIMEOUT_S)
    world_a = time.perf_counter() - t0
    del ref_grads
    free_card()
    paths = {}
    r0 = res[0]
    hq = full.n_heads // FSDP_DIMS[1]
    hkv = full.n_kv_heads // FSDP_DIMS[1]
    logits = torch.as_tensor(r0["serve"]["logits"])
    err = float((logits - ref["bfloat16"]["logits"]).abs().max())
    greedy = all(greedy_in_band(torch, logits[j], ref["bfloat16"]["logits"][j],
                                band) for j in range(FSDP_NEW_TOKENS + 1))
    same = all(np_.array_equal(r["serve"]["logits"], r0["serve"]["logits"])
               for r in res)
    pre, dec = r0["serve"]["prefill"], r0["serve"]["decode"]
    coll = lambda t: sum(v["ms"] for v in t.values()) / 1e3
    per_call = lambda t: {k: round(v["bytes"] / max(v["calls"], 1))
                          for k, v in t.items()}
    med = statistics.median(dec["step_ms"])
    print(f"(a) prefill of {b} x {s} (fsdp on, seq_shard on): "
          f"{pre['s']:.3f} s ({coll(pre['traffic']):.3f} s, "
          f"{coll(pre['traffic']) / pre['s']:.1%}, in collectives; bytes a "
          f"call, rank 0: {json.dumps(per_call(pre['traffic']))}); decode "
          f"(fsdp off) {med:.2f} ms a token (median of {FSDP_NEW_TOKENS}; "
          f"{coll(dec['traffic']) * 1e3 / sum(dec['step_ms']):.1%} in "
          f"collectives); cache a rank {pre['cache']}; peak a rank "
          f"{[round(max(r['serve']['prefill']['peak'], r['serve']['decode']['peak']) / 2**30, 2) for r in res]}"
          f" GiB; last-token logits against the unsharded bf16 run: max abs "
          f"{err:.4e} (band {band:.4e}), greedy in band {greedy}, every "
          f"rank's logits equal {same} [{card}]")
    check(err <= band and greedy and same,
          f"(a) logits {err} outside {band}, greedy out of band, or ranks "
          f"differ")
    check(pre["cache"][1] == b // FSDP_DIMS[0] and pre["cache"][3] == hkv,
          f"(a) a rank's cache {pre['cache']}")
    for r in res if on_card else ():        # the host runs no kernel
        check(r["serve"]["prefill"]["heads"] == {
            f"{hq}x{hkv}": serve_cfg.n_layers},
            f"(a) rank prefill flash launches "
            f"{r['serve']['prefill']['heads']}")
    paths["(a) prefill, fsdp"] = {
        k: sum(r["serve"]["prefill"]["counts"][k] for r in res)
        for k in r0["serve"]["prefill"]["counts"]}
    paths["(a) decode"] = {
        k: sum(r["serve"]["decode"]["counts"][k] for r in res)
        for k in r0["serve"]["decode"]["counts"]}

    tr = r0["train"]
    losses = [r["train"]["losses"] for r in res]
    rtol = abs(tr["losses"][0] - ref_loss) / abs(ref_loss)
    norm_rtol = abs(tr["norm"] - ref_norm) / ref_norm
    ratio = max(tr["errs"][k] / gaps[k] for k in gaps)
    worst = max(tr["errs"].items(), key=lambda kv: kv[1])
    print(f"(a) training {FSDP_STEPS} steps of {tb} x {ts} (fsdp on, "
          f"seq_shard on, remat {train_cfg.remat}, adamw()): losses "
          f"{tr['losses']} (first against {ref_loss:.6f}: rel {rtol:.2e}); "
          f"pre-clip global norm {tr['norm']:.6f} (rel {norm_rtol:.2e}); "
          f"gradient rel L2 a leaf: worst {worst[0]} {worst[1]:.3e}, at most "
          f"{ratio:.2f} times bf16's own gap; steps "
          + ", ".join(f"{x['s']:.3f} s ({x['coll_s']:.3f} s, "
                      f"{x['coll_s'] / x['s']:.1%}, in collectives)"
                      for x in tr["steps"])
          + f"; bytes a call, rank 0: {json.dumps(per_call(tr['traffic']))};"
          f" peak a rank {[round(r['train']['peak'] / 2**30, 2) for r in res]}"
          f" GiB; fused AdamW windows equal to the plain version "
          f"{[r['train']['adamw_same'] for r in res]}; norms bit-equal on "
          f"every rank {tr['norms_equal']} [{card}]")
    check(all(x == losses[0] for x in losses) and rtol <= FSDP_LOSS_RTOL
          and norm_rtol <= FSDP_NORM_RTOL and ratio <= TP_GRAD_BAND
          and tr["norms_equal"]
          and all(all(r["train"]["adamw_same"]) for r in res),
          f"(a) training: losses {losses} vs {ref_loss}, norm {tr['norm']} "
          f"vs {ref_norm}, worst leaf {worst}, norms equal "
          f"{tr['norms_equal']}")
    remat = 2 if train_cfg.remat else 1
    for r in res if on_card else ():
        check(r["train"]["heads"] == {
            "fwd": {f"{hq}x{hkv}": remat * train_cfg.n_layers * FSDP_STEPS},
            "bwd": {f"{hq}x{hkv}": 3 * train_cfg.n_layers * FSDP_STEPS}}
            and r["train"]["counts"]["fused_adamw"] == FSDP_STEPS,
            f"(a) rank training launches {r['train']['heads']}, "
            f"{r['train']['counts']}")
    paths["(a) training, fsdp"] = {
        k: sum(r["train"]["counts"][k] for r in res)
        for k in r0["train"]["counts"]}
    print(f"(a) world {world_a:.1f} s from spawn to join "
          f"({time.perf_counter() - phase_t0:.1f} s into phase 29) [{card}]")

    # ---- (b) federated rounds of tensor-parallel clients ------------------
    h = Hierarchy(*FL_TP_TREE[:3], n_clients=FL_TP_TREE[3])
    placement = np_.arange(h.dimensions)[::-1].copy()
    shapes = get_model(fl_cfg).param_shapes()
    before, after = (tree_map(lambda x: torch.empty(
        x.shape, dtype=x.dtype, device=dev), shapes) for _ in range(2))
    t0 = time.perf_counter()
    res = run_world(fl_tp_rank, math.prod(FL_TP_DIMS), ({
        "device": str(dev), "cfg": fl_cfg, "placement": placement,
        "before": before, "after": after},), timeout=TP_WORLD_TIMEOUT_S)
    world_b = time.perf_counter() - t0
    ds = make_federated_dataset(fl_cfg, h.total_clients, SEED, FL_TP_TOKENS)
    host_batch = {k: torch.stack([torch.as_tensor(
        ds.client_batch(c, 1, FL_TP_ROUNDS - 1)[k])
        for c in range(h.total_clients)]).to(dev)
        for k in ("tokens", "labels")}

    def host_update(dtype):
        """The host path's round update (after minus before, leaf by
        leaf) from the ranks' params before the round."""
        fl = FLTrainStep(get_model(fl_cfg.replace(dtype=dtype)),
                         sgd(DIST_FL_LR), h, placement, local_steps=1,
                         mode="hierarchical")
        stacked = tree_map(lambda x: x.expand(
            (h.total_clients,) + x.shape).clone(), before)
        states = [fl.optimizer.init(before) for _ in range(h.total_clients)]
        new, _, metrics = fl.make_round_fn()(stacked, states, host_batch)
        upd = tree_map(lambda n, b_: n[0].detach() - b_, new, before)
        return upd, float(metrics["loss"])

    zero_counts(*counters)
    upd16, loss16 = host_update("bfloat16")
    upd32, _ = host_update("float32")
    errs, gaps_b = {}, {}

    def compare(path, a, b_, u16, u32):
        errs[path] = rel_l2(torch, a - b_, u16)
        gaps_b[path] = rel_l2(torch, u16, u32)

    tree_map_with_path(compare, after, before, upd16, upd32)
    del upd16, upd32, before, after
    free_card()
    ratio = max(errs[k] / gaps_b[k] for k in errs)
    rb = res[0]
    rd = rb["rounds"][-1]
    moved = {}
    for st in rd["stats"]:
        if "bytes" in st:
            moved[st["step"]] = (st["bytes"], st["ranks"], round(st["ms"], 1))
    print(f"(b) {FL_TP_DIMS[0]} clients of {FL_TP_DIMS[1]} model ranks, tree "
          f"{FL_TP_TREE} at placement {placement.tolist()}, sgd("
          f"{DIST_FL_LR}), 1 x {FL_TP_TOKENS} tokens a client: rounds "
          f"{[round(x['s'], 3) for x in rb['rounds']]} s (the last held), "
          f"the held one's split on rank 0: "
          + ", ".join(f"{st['step']} {st['ms']:.1f} ms" for st in rd["stats"])
          + f"; collectives (step: bytes a rank, ranks, ms) "
          f"{json.dumps(moved)}; loss {rd['loss']:.6f} (host bf16 "
          f"{loss16:.6f}); round update against the host path's, rel L2 a "
          f"leaf: worst {max(errs.values()):.3e}, at most {ratio:.2f} times "
          f"its bf16 gap to float32; shards bit-equal along the data axis "
          f"{[r['equal'] for r in res]}; peak a rank "
          f"{[round(r['peak'] / 2**30, 2) for r in res]} GiB; world "
          f"{world_b:.1f} s [{card}]")
    check(ratio <= FL_TP_BAND and all(r["equal"] for r in res),
          f"(b) round update {ratio} times the band, or shards differ along "
          f"the data axis")
    fwd = (2 if fl_cfg.remat else 1) * fl_cfg.n_layers * FL_TP_ROUNDS
    hq = full.n_heads // FL_TP_DIMS[1]
    hkv = full.n_kv_heads // FL_TP_DIMS[1]
    for r in res if on_card else ():
        check(r["heads"] == {"fwd": {f"{hq}x{hkv}": fwd},
                             "bwd": {f"{hq}x{hkv}": 3 * fl_cfg.n_layers
                                     * FL_TP_ROUNDS}},
              f"(b) rank flash launches {r['heads']}")
    paths["(b) rounds"] = {k: sum(r["counts"][k] for r in res)
                           for k in rb["counts"]}
    print("phase 29 launches by path: " + json.dumps(
        {p: {k: v for k, v in c.items() if v} for p, c in paths.items()}))
    print(f"phase 29 took {time.perf_counter() - phase_t0:.1f} s [{card}]")
    return {k: {f"phase 29 {p}": c[k] for p, c in paths.items()}
            for k in rb["counts"]}


# ---------------------------------------------------------------------------
# phase 30: the hybrid and audio families over rank meshes
# ---------------------------------------------------------------------------
FAM_RANKS = 4
FAM_NEW_TOKENS = 8                 # (a): greedy decode steps
FAM_BAND = 2.0                     # times the unsharded run's bf16 gap
FAM_LOSS_RTOL = 1e-3               # (a): the gradient's loss
FAM_FL_TOKENS = 512                # (c): 1 x 512 tokens a client
FAM_FL_CLIENTS = 2                 # (c): choose_fl_hierarchy(2)'s tree
FAM_WORLD_TIMEOUT_S = 600
# per family: the cuts (of a full config's fields), (a)'s prefill wave
# and gradient tokens, (b)'s training batch
FAM_SPECS = {
    RG_ARCH: {
        "serve": {"n_layers": 5}, "grad": {"n_layers": 5},
        "fl": {"n_layers": 3, "remat": FL_CLIENT_REMAT}, "wave": (2, 4096),
        "grad_tokens": 2048, "train": (2, 512)},
    AUDIO_ARCH: {
        "serve": {"n_layers": 2, "n_encoder_layers": 2},
        "grad": {"n_layers": 2, "n_encoder_layers": 2},
        "fl": {"n_layers": 1, "n_encoder_layers": 1,
               "remat": FL_CLIENT_REMAT},
        "wave": (4, 512), "grad_tokens": 2048, "train": (2, 512)},
}
# the worlds of 4 ranks, each a list of (arch, parts): recurrentgemma-2b's
# (b) ranks hold 15.4 GiB each on the card (its vocab tables' AdamW
# state) and its (c) ranks 8.9 GiB beside the parent's 10.2 GiB of
# buffers, so each has a world of its own, (b) first while the card is
# emptiest. The references and buffers the ranks read stay on the card
# (CUDA IPC: through the host's shared memory they moved at 0.4-0.5 GB/s
# on an H100 host), but (b)'s, on the host: its ranks need nearly all
# of the card. (c)'s buffers are freed after its host path. (c) joined
# to the world of (a) ran out of memory (the ranks at 8.85 GiB
# allocated and 1.32 GiB cached each, the card full).
FAM_WORLDS = (((RG_ARCH, "b"),), ((RG_ARCH, "a"), (AUDIO_ARCH, "abc")),
              ((RG_ARCH, "c"),))
# each part's peak of the caching allocator's reserve a rank, GiB (H100
# 80GB HBM3, 700 W: (b) and (c) measured, 17.21 and 14.95 for
# recurrentgemma-2b beside 15.38 and 8.9 allocated; (a) its allocation
# peak plus 2.5), and each rank's CUDA context beside it: a world is
# spawned only if the card has FAM_RANKS times the largest of its parts'
# peaks, plus the context, free after its references
FAM_RANK_PEAK_GIB = {(RG_ARCH, "a"): 5.93, (RG_ARCH, "b"): 17.21,
                     (RG_ARCH, "c"): 14.95, (AUDIO_ARCH, "a"): 5.2,
                     (AUDIO_ARCH, "b"): 7.47, (AUDIO_ARCH, "c"): 6.38}
FAM_RANK_CONTEXT_GIB = 1.0
# (b) holds the two vocab tables' gradients over a window of their vocab
# dim (leaf path: that dim): the training batch's ids and every
# FAM_WINDOW_STRIDE-th id. The whole references (2.6 GB each in
# recurrentgemma-2b, float32) would cross the host's shared memory.
FAM_B_WINDOWS = {"embed/table": 0, "lm_head/proj": 1}
FAM_WINDOW_STRIDE = 1021
# the CPU rehearsal's sizes (reduced configs)
FAM_CPU = {"wave": (2, 128), "grad_tokens": 64, "train": (2, 32),
           "fl_tokens": 32}


def fam_path(counters) -> dict:
    """One path's kernel launches as read now: the counts, the flash
    launches by mask and by heads, the RG-LRU launches by copy route."""
    kflash, krglru = counters[0], counters[1]
    return {"counts": kernel_counts(*counters), "modes": flash_modes(kflash),
            "heads": {"fwd": dict(kflash.flash_attention.heads),
                      "bwd": dict(kflash.flash_attention_bwd.heads)},
            "routes": {"scan": dict(krglru.rglru_scan.routes),
                       "bwd": dict(krglru.rglru_scan_bwd.routes)}}


def fam_batch(torch, arrays, dev):
    return {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}


def _replicated_equal(torch, tree, specs) -> bool:
    """Whether every leaf that ``specs`` replicates over every axis holds
    the same bits on every rank."""
    from repro_torch.utils.trees import tree_map_with_path
    same = []
    tree_map_with_path(lambda path, x, s: same.append(_world_check_equal(
        torch, x.detach().reshape(-1))) if all(e is None for e in s)
        else None, tree, specs)
    return all(same)


def fam_rank(rank, world, spec):
    """Phase 30, one rank of the four on the one card: each family of
    ``spec["families"]`` in turn (:func:`fam_parts`); their results."""
    import torch

    from repro_torch.launch.mesh import RankMesh
    dev = torch.device(spec["device"])
    _rank_setup(torch, dev)
    counters = _counters()
    # one mesh a shape for every part and family: each new mesh creates
    # its gloo groups, a rendezvous of the world each
    meshes = {dims: RankMesh(dims, ("data", "model"), device=dev)
              for dims in ((1, world), (2, world // 2))}
    return [fam_parts(world, dev, counters, meshes, fs)
            for fs in spec["families"]]


def fam_parts(world, dev, counters, meshes, spec):
    """One family on this rank, its parts in turn: (a) a (1, 4) mesh,
    seq_shard off and on: the prefill of one wave and FAM_NEW_TOKENS
    decode steps fed the unsharded run's greedy tokens, then a gradient
    held leaf by leaf to the unsharded one (the parent's, by CUDA
    IPC, or for (b) in the host's shared memory); (b) a (2, 2) mesh with fsdp and seq: one prefill wave and
    two ``adamw()`` steps, the first step's gradient held to the
    unsharded one and the fused AdamW windows to the plain version; (c)
    FLTrainStep rounds of 2 clients of 2 model ranks, a warm-up and a
    held round whose params before and after the data-axis-0 ranks
    write into the parent's buffers (CUDA IPC)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.fl.distributed import FLTrainStep, choose_fl_hierarchy
    from repro_torch.kernels.ref import fused_adamw_ref
    from repro_torch.models import ShardingPolicy, get_model, make_policy
    from repro_torch.models.api import flat_params, make_train_step
    from repro_torch.optim import Optimizer, adamw, sgd
    from repro_torch.optim.optimizers import global_norm
    from repro_torch.utils.trees import flat_buffer_of, tree_flatten, tree_map_with_path

    on_card = dev.type == "cuda"
    out = {}

    def sync():
        _sync(torch, dev)

    def traffic(mesh):
        return {k: {"calls": v[0], "bytes": v[1], "ms": v[2] * 1e3}
                for k, v in mesh.traffic.items()}

    def start(mesh):
        zero_counts(*counters)
        mesh.traffic.clear()
        peak = _peak_reset(torch, dev)
        sync()
        return time.perf_counter(), peak

    def errs_of(grads, specs, refs, mesh):
        """Each leaf's relative L2 error against the reference (a leaf
        the reference leaves out, None, is skipped)."""
        errs = {}
        tree_map_with_path(lambda path, g, s, ref: None if ref is None
                           else errs.__setitem__(path, _rel_l2_sharded(
                               torch, g, tp_view(ref, s, mesh), s, mesh,
                               dev)), grads, specs, refs)
        return errs

    walls = {}
    for part in spec["parts"]:
        part_t0 = time.perf_counter()
        if part == "a":
            mesh = meshes[1, world]
            mesh.timed = True
            cfg = spec["serve_cfg"]
            params = get_model(cfg, make_policy(mesh)).init(
                torch.Generator(dev).manual_seed(SEED), dev)
            prompts = fam_batch(torch, spec["prompts"], dev)
            serve = []
            for seq in (False, True):
                model = get_model(cfg, make_policy(mesh, seq_shard=seq))
                t0, peak = start(mesh)
                with torch.no_grad():
                    logits, state = model.prefill_fn(params, prompts)
                    sync()
                    prefill = {"s": time.perf_counter() - t0,
                               "traffic": traffic(mesh)}
                    steps, step_ms = [logits.float().cpu()], []
                    mesh.traffic.clear()
                    for j in range(FAM_NEW_TOKENS):
                        t1 = time.perf_counter()
                        logits, state = model.decode_fn(params, state, {
                            "token": torch.as_tensor(
                                spec["tokens"][:, j:j + 1], device=dev)})
                        sync()
                        step_ms.append((time.perf_counter() - t1) * 1e3)
                        steps.append(logits.float().cpu())
                serve.append({"seq": seq, "logits": torch.stack(steps).numpy(),
                              "prefill": prefill, "step_ms": step_ms,
                              "decode_traffic": traffic(mesh),
                              "path": fam_path(counters), "peak": peak()})
                del state, logits
            del params
            cfg = spec["grad_cfg"]
            model = get_model(cfg, make_policy(mesh))
            params = model.init(torch.Generator(dev).manual_seed(SEED), dev)
            specs = model.param_pspecs()
            leaves, rebuild = tree_flatten(params)
            live = [x.detach().requires_grad_() for x in leaves]
            del params, leaves
            batch = fam_batch(torch, spec["grad_batch"], dev)
            grad = []
            for seq in (False, True):
                model = get_model(cfg, make_policy(mesh, seq_shard=seq))
                t0, peak = start(mesh)
                loss, _ = model.loss_fn(rebuild(live), batch)
                grads = rebuild(list(torch.autograd.grad(loss, live)))
                sync()
                step_s = time.perf_counter() - t0
                record = {"seq": seq, "loss": float(loss.detach()),
                          "s": step_s, "traffic": traffic(mesh),
                          "path": fam_path(counters), "peak": peak()}
                record["errs"] = errs_of(grads, specs, spec["ref_grads_a"],
                                         mesh)
                record["replicated_equal"] = _replicated_equal(
                    torch, grads, specs)
                grad.append(record)
                del loss, grads
            del live
            out["a"] = {"serve": serve, "grad": grad}
        elif part == "b":
            mesh = meshes[2, world // 2]
            mesh.timed = True
            policy = make_policy(mesh, fsdp=True, seq_shard=True)
            model = get_model(spec["serve_cfg"], policy)
            params = model.init(torch.Generator(dev).manual_seed(SEED), dev)
            t0, peak = start(mesh)
            with torch.no_grad():
                logits, state = model.prefill_fn(
                    params, fam_batch(torch, spec["prompts"], dev))
            sync()
            prefill = {"s": time.perf_counter() - t0, "traffic": traffic(mesh),
                       "path": fam_path(counters), "peak": peak()[0],
                       "logits": logits.float().cpu().numpy()}
            del params, state, logits
            model = get_model(spec["grad_cfg"], policy)
            specs = model.param_pspecs()
            params = flat_params(model.init(
                torch.Generator(dev).manual_seed(SEED), dev))
            batch = fam_batch(torch, spec["train_batch"], dev)
            inner = adamw()
            rec = {"check_s": 0.0, "adamw_same": []}

            def update(p, g, state, **kw):
                t_check = time.perf_counter()
                step = int(state.step) + 1
                if step == 1:
                    rec["norm"] = float(global_norm(g, kw["shards"]))
                    rec["errs"] = errs_of(g, specs, spec["ref_grads_b"], mesh)
                    for path, win in spec["ref_windows_b"].items():
                        rec["errs"][path] = _rel_l2_window(
                            torch, _leaf(g, path), win, _leaf(specs, path),
                            mesh, dev)
                flat = flat_buffer_of(p)
                n = flat.numel()
                wins = [slice(0, min(FSDP_WINDOW, n)),
                        slice(max(n - FSDP_WINDOW, 0), n)]
                before = [[flat_buffer_of(t)[w].clone()
                           for t in (p, state.mu, state.nu)] for w in wins]
                sync()
                rec["check_s"] += time.perf_counter() - t_check
                p, state = inner.update(p, g, state, **kw)
                t_check = time.perf_counter()
                same = True
                for w, (p0, m0, v0) in zip(wins, before, strict=True):
                    want = fused_adamw_ref(p0, flat_buffer_of(g)[w].clone(),
                                           m0, v0, 3e-4,
                                           *adamw_scalars(np, step))
                    got = [flat_buffer_of(t)[w] for t in (p, state.mu,
                                                           state.nu)]
                    same &= all(torch.equal(a, b) for a, b in zip(got, want))
                rec["adamw_same"].append(same)
                sync()
                rec["check_s"] += time.perf_counter() - t_check
                return p, state

            step_fn = make_train_step(model, Optimizer(init=inner.init,
                                                       update=update))
            state = inner.init(params)
            t0, peak = start(mesh)
            train = {"steps": [], "losses": []}
            for _ in range(2):
                rec["check_s"] = 0.0
                before = {k: v[2] for k, v in mesh.traffic.items()}
                sync()
                t0 = time.perf_counter()
                params, state, metrics = step_fn(params, state, batch)
                sync()
                coll = sum(v[2] - before.get(k, 0.0)
                           for k, v in mesh.traffic.items())
                train["steps"].append({
                    "s": time.perf_counter() - t0 - rec["check_s"],
                    "coll_s": coll})
                train["losses"].append(float(metrics["loss"]))
            peaks = peak()
            train.update(traffic=traffic(mesh), path=fam_path(counters),
                         peak=peaks[0], reserved=peaks[1], norm=rec["norm"],
                         errs=rec["errs"],
                         adamw_same=rec["adamw_same"],
                         replicated_equal=_replicated_equal(torch, params,
                                                            specs))
            out["b"] = {"prefill": prefill, "train": train}
            del params, state, step_fn
        elif part == "c":
            mesh = meshes[2, world // 2]
            mesh.timed = False            # timed from the held round
            cfg = spec["fl_cfg"]
            model = get_model(cfg, ShardingPolicy(mesh=mesh, model_axis="model",
                                                  seq_axis="model"))
            specs = model.param_pspecs()
            h = choose_fl_hierarchy(FAM_FL_CLIENTS)
            fl = FLTrainStep(model, sgd(DIST_FL_LR), h, spec["placement"],
                             local_steps=1, mode="flat")
            params, state = fl.init_stacked(
                torch.Generator(dev).manual_seed(SEED))
            ds = make_federated_dataset(cfg, h.total_clients, SEED,
                                        spec["fl_tokens"])
            round_fn = fl.make_round_fn()
            first = mesh.axis_index("data") == 0

            def keep(into):
                if first:
                    tree_map_with_path(
                        lambda path, x, s, buf: tp_view(buf, s, mesh).copy_(x),
                        params, specs, into)
                    sync()

            t0, peak = start(mesh)
            rounds = []
            for r in range(2):                  # a warm-up, then the round
                batch = fam_batch(torch, ds.client_batch(
                    fl.client_index, 1, r), dev)
                if r == 1:
                    keep(spec["before"])
                    mesh.timed = True
                    mesh.traffic.clear()
                stats = []
                sync()
                t0 = time.perf_counter()
                params, state, metrics = round_fn(params, state, batch,
                                                  stats=stats)
                sync()
                rounds.append({"s": time.perf_counter() - t0, "stats": stats,
                               "loss": float(metrics["loss"])})
            keep(spec["after"])
            peaks = peak()
            out["c"] = {"rounds": rounds, "path": fam_path(counters),
                        "peak": peaks[0], "reserved": peaks[1],
                        "client": fl.client_index,
                        "equal": _world_check_equal(
                            torch, flat_buffer_of(params),
                            mesh.axis_group("data"))}
            del params, state
        dist.barrier()
        if on_card:
            torch.cuda.empty_cache()
        walls[part] = time.perf_counter() - part_t0
    out["walls"] = walls
    return out


def fam_unsharded_serve(torch, np_, get_model, cfg, prompts, dev):
    """The unsharded bf16 and float32 runs of one wave (prefill and
    FAM_NEW_TOKENS greedy steps, float32 fed bf16's tokens): {dtype:
    {"logits", "tokens", "prefill_s"}}."""
    params = get_model(cfg).init(torch.Generator(dev).manual_seed(SEED), dev)
    batch = fam_batch(torch, prompts, dev)
    ref = {}
    with torch.no_grad():
        for dtype in ("bfloat16", "float32"):
            fed = ref["bfloat16"]["tokens"] if dtype == "float32" else None
            m = get_model(cfg.replace(dtype=dtype))
            _sync(torch, dev)
            t0 = time.perf_counter()
            logits, state = m.prefill_fn(params, batch)
            _sync(torch, dev)
            prefill_s = time.perf_counter() - t0
            steps, tokens = [logits.float().cpu()], []
            for j in range(FAM_NEW_TOKENS):
                tok = logits[:, -1].argmax(-1, keepdim=True).int() \
                    if fed is None else torch.as_tensor(fed[:, j:j + 1],
                                                        device=dev)
                tokens.append(tok.cpu().numpy())
                logits, state = m.decode_fn(params, state, {"token": tok})
                steps.append(logits.float().cpu())
            ref[dtype] = {"logits": torch.stack(steps),
                          "tokens": np_.concatenate(tokens, 1),
                          "prefill_s": prefill_s}
            del state, logits
    return ref


def fam_unsharded_grad(torch, get_model, cfg, batch, dev, windows=None,
                       host=False):
    """The unsharded gradient of ``batch`` at bf16 (kept on ``dev``, or
    with ``host`` in the host's shared memory) against float32: (loss,
    grads, {path: bf16 gap}, global norm, seconds, {path: (dim, indices,
    the bf16 gradient at them)}). A leaf of ``windows`` ({path: (dim,
    indices)}) is kept, and its gap taken, at those indices of ``dim``
    only (None in grads)."""
    from repro_torch.utils.trees import tree_flatten, tree_global_norm, tree_map
    windows = windows or {}
    out, t_start = {}, time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        model = get_model(cfg.replace(dtype=dtype))
        params = model.init(torch.Generator(dev).manual_seed(SEED), dev)
        live, rebuild = tree_flatten(params)
        _, skeleton = tree_flatten(tree_map(lambda x: None, params))
        del params
        for x in live:
            x.requires_grad_()
        _sync(torch, dev)
        t0 = time.perf_counter()
        loss, _ = model.loss_fn(rebuild(live), fam_batch(torch, batch, dev))
        grads = list(torch.autograd.grad(loss, live))
        _sync(torch, dev)
        out[dtype] = (float(loss.detach()), grads, time.perf_counter() - t0)
        del live, loss
    g16, g32 = out["bfloat16"][1], out["float32"][1]
    paths = tp_paths(skeleton, len(g16))
    norm = float(tree_global_norm(g16))

    def keep(x):
        return x.cpu().share_memory_() if host else x

    gaps, kept, wins = {}, [], {}
    for p, a, b in zip(paths, g16, g32, strict=True):
        if p in windows:
            dim, idx = windows[p]
            a, b = a.index_select(dim, idx), b.index_select(dim, idx)
            wins[p] = (dim, keep(idx), keep(a))
            kept.append(None)
        else:
            kept.append(keep(a))
        gaps[p] = rel_l2(torch, a, b)
    print(f"the unsharded gradients at float32 and bf16 "
          f"{time.perf_counter() - t_start:.1f} s (the bf16 step "
          f"{out['bfloat16'][2]:.3f} s)", flush=True)
    return (out["bfloat16"][0], skeleton(kept), gaps, norm,
            out["bfloat16"][2], wins)


def _rel_l2_window(torch, g, win, spec, mesh, dev) -> float:
    """The relative L2 error of the global leaf whose shard ``g`` this
    rank holds, over a window of one dim: ``win`` = (dim, the window's
    global indices, the reference leaf at them); ``spec`` the leaf's.
    The ranks' sums are added as :func:`_rel_l2_sharded` adds them."""
    import torch.distributed as dist
    dim, idx, want = win
    idx = idx.to(dev)
    n = g.shape[dim]
    lo = 0 if spec[dim] is None else mesh.axis_index(spec[dim]) * n
    mine = ((idx >= lo) & (idx < lo + n)).nonzero().squeeze(1)
    rest = tuple(None if d == dim else a for d, a in enumerate(spec))
    want = tp_view(want.to(dev), rest, mesh).index_select(dim, mine)
    got = g.index_select(dim, idx[mine] - lo).double()
    want = want.double()
    sums = torch.stack([(got - want).square().sum(), want.square().sum()])
    if any(a is not None for a in spec):
        dist.all_reduce(sums)
    return float((sums[0] / sums[1].clamp_min(1e-300)).sqrt())


def fam_scan_timing(torch, card) -> dict:
    """The RG-LRU scan and adjoint at a model-axis rank's shapes in phase
    30 (a), recurrentgemma-2b's dr / 4 = 640 channels, float32: the
    prefill's (2, 4096, 640) and the gradient's (1, 2048, 640), held
    bit for bit to the plain versions, then device times beside the
    bound (each operand read once, each output written once)."""
    from repro_torch.kernels import rglru as krglru
    from repro_torch.kernels.ref import rglru_scan_bwd_ref, rglru_scan_ref
    gen = torch.Generator("cuda").manual_seed(SEED + 30)
    out = {}
    for shape, adjoint in (((2, 4096, 640), False), ((1, 2048, 640), True)):
        a = torch.rand(shape, device="cuda", generator=gen).mul_(0.2).add_(0.8)
        u = torch.randn(shape, device="cuda", generator=gen)
        if adjoint:
            h = rglru_scan_ref(a, u)
            fn = lambda: krglru.rglru_scan_bwd(a, h, u)
            plain = lambda: rglru_scan_bwd_ref(a, h, u)
            nbytes = 5 * a.numel() * 4
        else:
            fn = lambda: krglru.rglru_scan(a, u)
            plain = lambda: rglru_scan_ref(a, u)
            nbytes = 3 * a.numel() * 4
        got, want = fn(), plain()
        same = all(torch.equal(x, y) for x, y in zip(
            got if adjoint else (got,), want if adjoint else (want,)))
        plan = krglru.plan_for((a, h, u) if adjoint else (a, u))
        check(same and plan.route == "tma", f"RG-LRU {shape}: route "
              f"{plan.route}, equal to the plain version {same}")
        ms = median_device_ms(torch, fn)
        plain_ms = median_event_ms(torch, plain, runs=5, per_run=1)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        name = "adjoint" if adjoint else "scan"
        print(f"RG-LRU {name} f32 {shape} (a rank's channels; {plan}): "
              f"kernel {ms * 1e3:.2f} us on the device ({bound / ms:.1%} of "
              f"the bound), equal to the plain version {same}; plain torch "
              f"{plain_ms:.2f} ms a call (host enqueue included); bound "
              f"{bound * 1e3:.2f} us ({nbytes} B / 3.35 TB/s) [{card}]")
        out[name] = (shape, ms, plain_ms, bound)
    return out


def fam_host_update(torch, get_model, ctx, dev, before, after):
    """(c)'s host path from the ranks' params ``before`` the held round,
    at bf16 and float32 (one FedAvg launch each): each leaf's relative L2
    error of the ranks' update (``after`` minus ``before``) against the
    host path's bf16 update, and of that against the float32 one, and
    the host path's bf16 loss."""
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.fl.distributed import FLTrainStep
    from repro_torch.optim import sgd
    from repro_torch.utils.trees import tree_map, tree_map_with_path
    cfg, h = ctx["fl_cfg"], ctx["h"]
    ds = make_federated_dataset(cfg, h.total_clients, SEED,
                                ctx["sizes"]["fl_tokens"])
    host_batch = {k: torch.stack([torch.as_tensor(ds.client_batch(
        c, 1, 1)[k]) for c in range(h.total_clients)]).to(dev)
        for k in ds.client_batch(0, 1, 1)}
    upd = {}
    for dtype in ("bfloat16", "float32"):
        fl = FLTrainStep(get_model(cfg.replace(dtype=dtype)), sgd(DIST_FL_LR),
                         h, ctx["placement"], local_steps=1, mode="flat")
        stacked = tree_map(lambda x: x.expand(
            (h.total_clients,) + x.shape).clone(), before)
        states = [fl.optimizer.init(before) for _ in range(h.total_clients)]
        new, _, metrics = fl.make_round_fn()(stacked, states, host_batch)
        upd[dtype] = (tree_map(lambda n, b_: n[0].detach() - b_, new, before),
                      float(metrics["loss"]))
        del stacked, states, new
    errs, gaps = {}, {}
    tree_map_with_path(lambda path, a, b_, u16, u32: (
        errs.__setitem__(path, rel_l2(torch, a - b_, u16)),
        gaps.__setitem__(path, rel_l2(torch, u16, u32))),
        after, before, upd["bfloat16"][0], upd["float32"][0])
    return errs, gaps, upd["bfloat16"][1]


def fam_check_path(arch, where, path, n_heads, on_card):
    """A path's launches on every rank: the flash kernels on
    ``n_heads`` ("HqxHkv") only, the RG-LRU scan and adjoint on the TMA
    route only; raises otherwise."""
    if not on_card:
        return
    for kind in ("fwd", "bwd"):
        heads = path["heads"][kind]
        check(set(heads) <= {n_heads}, f"{arch} {where}: flash {kind} "
                                       f"launches on heads {heads}")
    for kind, routes in path["routes"].items():
        check(set(routes) <= {"tma"}, f"{arch} {where}: RG-LRU {kind} "
                                      f"routes {routes}")


def hybrid_audio_phases(torch, np_, card, device="cuda"):
    """Phase 30: full-width recurrentgemma-2b and seamless-m4t-large-v2
    over meshes of 4 spawned gloo ranks on the one card: (a) a (1, 4)
    model axis, seq_shard off and on (serving and a gradient), (b) fsdp
    on (2, 2) (a prefill wave and two AdamW steps), (c) federated rounds
    of 2 tensor-parallel clients of 2 model ranks, each held to the
    unsharded run or the host path. Returns {kernel name: {path:
    launches}}."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.fl.distributed import FLTrainStep, choose_fl_hierarchy
    from repro_torch.launch.world import run_world
    from repro_torch.models import get_model
    from repro_torch.optim import sgd
    from repro_torch.utils.trees import tree_map, tree_map_with_path

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    phase_t0 = time.perf_counter()
    paths = {}            # {kernel: {path: launches}}

    def free():
        gc.collect()
        if on_card:
            # memory the ranks opened by CUDA IPC stays in use until
            # collected here, after they are gone
            torch.cuda.ipc_collect()
            torch.cuda.empty_cache()

    def collect(part, label, path):
        """The path's launches, summed over the ranks, the flash kernels
        split by mask."""
        counts = {k: sum(p["counts"][k] for p in path) for k in
                  path[0]["counts"]}
        modes = tuple({m: sum(p["modes"][i].get(m, 0) for p in path)
                       for m in ("causal", "bidirectional")}
                      for i in range(2))
        name = f"phase 30 ({part}) {label}"
        for k, sub in mm_paths(counts, name, modes).items():
            paths.setdefault(k, {}).update(sub)

    def coll_s(t):
        return sum(v["ms"] for v in t.values()) / 1e3

    def per_call(t):
        return {k: round(v["bytes"] / max(v["calls"], 1)) for k, v in t.items()}

    phase(f"30. full-width {RG_ARCH} and {AUDIO_ARCH} over meshes of "
          f"{FAM_RANKS} gloo ranks on the card: (a) a (1, {FAM_RANKS}) "
          f"model axis, seq_shard off and on; (b) fsdp on (2, 2); (c) "
          f"federated rounds of 2 tensor-parallel clients")
    if on_card:
        free()     # what earlier phases' ranks opened by CUDA IPC too
        print(f"{torch.cuda.mem_get_info()[0] / 2**30:.1f} GiB of the card "
              f"free [{card}]")
        fam_scan_timing(torch, card)
    ctxs = {}
    for arch, fs in FAM_SPECS.items():
        arch_t0 = time.perf_counter()
        full = get_config(arch)
        if not on_card:                  # the CPU rehearses reduced
            full = full.reduced().replace(**fs["serve"]) \
                if full.family == "hybrid" else full.reduced()
        sizes = FAM_CPU if not on_card else {
            "wave": fs["wave"], "grad_tokens": fs["grad_tokens"],
            "train": fs["train"], "fl_tokens": FAM_FL_TOKENS}
        serve_cfg = full.replace(**fs["serve"]) if on_card else full
        cut = lambda over: full.replace(**{k: min(v, getattr(full, k))
                                            for k, v in over.items()})
        grad_cfg, fl_cfg = cut(fs["grad"]), cut(fs["fl"])
        rng = np_.random.default_rng(SEED + 30)
        b, s = sizes["wave"]

        def arrays(rows, n):
            out = {"tokens": rng.integers(0, full.vocab_size,
                                          (rows, n)).astype(np_.int32)}
            if full.family == "audio":
                out["frontend"] = rng.normal(
                    scale=0.02, size=(rows, full.frontend_len,
                                      full.frontend_dim)).astype(np_.float32)
            return out

        prompts = arrays(b, s)
        grad_batch = arrays(1, sizes["grad_tokens"])
        grad_batch["labels"] = np_.roll(grad_batch["tokens"], -1, axis=1)
        train_batch = arrays(*sizes["train"])
        train_batch["labels"] = np_.roll(train_batch["tokens"], -1, axis=1)
        m = FAM_RANKS
        heads_a = f"{full.n_heads}x{full.n_kv_heads}" \
            if full.family == "hybrid" else \
            f"{full.n_heads // m}x{full.n_kv_heads // m}"
        heads_bc = f"{full.n_heads}x{full.n_kv_heads}" \
            if full.family == "hybrid" else \
            f"{full.n_heads // 2}x{full.n_kv_heads // 2}"
        print(f"{arch} (d_model {full.d_model}, {full.n_heads} q and "
              f"{full.n_kv_heads} kv heads of {full.resolved_head_dim}, d_ff "
              f"{full.d_ff}, vocab {full.vocab_size}): serving at "
              f"{serve_cfg.n_layers} layers ({serve_cfg.n_encoder_layers} "
              f"encoder), a wave of {b} x {s}; gradients at "
              f"{grad_cfg.n_layers} (+{grad_cfg.n_encoder_layers}); (c) at "
              f"{fl_cfg.n_layers} (+{fl_cfg.n_encoder_layers}) [{card}]")

        ref = fam_unsharded_serve(torch, np_, get_model, serve_cfg, prompts,
                                  dev)
        free()
        gap = float((ref["bfloat16"]["logits"]
                     - ref["float32"]["logits"]).abs().max())
        band = FAM_BAND * gap
        print(f"(a) unsharded on {dev.type}: prefill "
              f"{ref['bfloat16']['prefill_s']:.3f} s a wave; bf16 against "
              f"float32 (fed bf16's greedy tokens): max abs {gap:.4e} over the "
              f"last-token logits; the ranks are held to {band:.4e} "
              f"({time.perf_counter() - arch_t0:.1f} s into {arch}) [{card}]")
        h = choose_fl_hierarchy(FAM_FL_CLIENTS)
        placement = np_.arange(h.dimensions)
        base = {"serve_cfg": serve_cfg, "grad_cfg": grad_cfg,
                "fl_cfg": fl_cfg, "prompts": prompts,
                "tokens": ref["bfloat16"]["tokens"],
                "fl_tokens": sizes["fl_tokens"], "placement": placement,
                "grad_batch": grad_batch, "train_batch": train_batch}
        ctxs[arch] = dict(
            base=base, full=full, sizes=sizes, serve_cfg=serve_cfg,
            grad_cfg=grad_cfg, fl_cfg=fl_cfg, heads_a=heads_a,
            heads_bc=heads_bc, ref=ref, band=band, h=h, placement=placement,
            results={})
    for world in FAM_WORLDS:
        # each part's references, on the card only while its world runs
        # (but (c)'s buffers, which the host path reads after)
        t0 = time.perf_counter()
        specs = []
        for arch, parts in world:
            ctx = ctxs[arch]
            spec = dict(ctx["base"], parts=parts)
            if "a" in parts:
                (loss, spec["ref_grads_a"], gaps, _, ref_s,
                 _) = fam_unsharded_grad(torch, get_model, ctx["grad_cfg"],
                                         ctx["base"]["grad_batch"], dev)
                ctx["results"]["a_ref"] = (loss, gaps, ref_s)
            if "b" in parts:
                # on the host: (b)'s ranks need nearly all of the card
                train = ctx["base"]["train_batch"]
                idx = torch.as_tensor(np_.unique(np_.concatenate([
                    train["tokens"].ravel(), train["labels"].ravel(),
                    np_.arange(0, ctx["full"].vocab_size,
                               FAM_WINDOW_STRIDE)])), device=dev)
                (loss, spec["ref_grads_b"], gaps, norm, _,
                 spec["ref_windows_b"]) = fam_unsharded_grad(
                    torch, get_model, ctx["grad_cfg"], train, dev,
                    windows={p: (d, idx) for p, d in FAM_B_WINDOWS.items()},
                    host=on_card)
                ctx["results"]["b_ref"] = (loss, gaps, norm, len(idx))
            if "c" in parts:
                # the ranks write their shards before and after the held
                # round into these
                shapes = get_model(ctx["fl_cfg"]).param_shapes()
                ctx["bufs"] = tuple(tree_map(
                    lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device=dev), shapes)
                    for _ in range(2))
                spec["before"], spec["after"] = ctx["bufs"]
            specs.append(spec)
        free()
        label = " and ".join(f"{a} ({p})" for a, p in world)
        need = FAM_RANKS * (max(FAM_RANK_PEAK_GIB[a, p] for a, parts in world
                                for p in parts) + FAM_RANK_CONTEXT_GIB)
        free_gib = torch.cuda.mem_get_info()[0] / 2**30 if on_card else 0.0
        check(not on_card or free_gib >= need,
              f"world of {label}: {free_gib:.1f} GiB of the card free after "
              f"its references, its ranks need {need:.1f} GiB")
        t1 = time.perf_counter()
        res = run_world(fam_rank, FAM_RANKS, ({
            "device": str(dev), "families": specs},),
            timeout=FAM_WORLD_TIMEOUT_S)
        room = (f" ({free_gib:.1f} GiB of the card free after its "
                f"references, {need:.1f} GiB needed by its ranks: "
                f"{free_gib - need:.1f} GiB of headroom)") if on_card else ""
        print(f"world of {label}{room}: references {t1 - t0:.1f} s, "
              f"{time.perf_counter() - t1:.1f} s from spawn to join; on rank "
              f"0 each part's wall time (inits and checks included): "
              + "; ".join(f"({k}) {v:.1f} s" for r in res[0]
                          for k, v in r["walls"].items())
              + f" ({time.perf_counter() - phase_t0:.1f} s into phase 30) "
              f"[{card}]")
        for i, (arch, parts) in enumerate(world):
            for k in parts:
                ctxs[arch]["results"][k] = [r[i][k] for r in res]
        res = specs = spec = None
        free()
        for arch, parts in world:           # (c)'s host path, its buffers
            if "c" in parts:                # freed before the next world
                ctx = ctxs[arch]
                ctx["results"]["c_host"] = fam_host_update(
                    torch, get_model, ctx, dev, *ctx.pop("bufs"))
                free()
    for arch in FAM_SPECS:
        arch_t0 = time.perf_counter()
        ctx = ctxs.pop(arch)
        (full, sizes, serve_cfg, grad_cfg, fl_cfg, heads_a, heads_bc, ref,
         band, h, placement, results) = (ctx[k] for k in (
             "full", "sizes", "serve_cfg", "grad_cfg", "fl_cfg", "heads_a",
             "heads_bc", "ref", "band", "h", "placement", "results"))
        ctx = None
        # ---- (a) -------------------------------------------------------------
        ranks = results["a"]
        for i, seq in enumerate((False, True)):
            got = ranks[0]["serve"][i]
            logits = torch.as_tensor(got["logits"])
            err = float((logits - ref["bfloat16"]["logits"]).abs().max())
            greedy = all(greedy_in_band(torch, logits[j],
                                        ref["bfloat16"]["logits"][j], band)
                         for j in range(FAM_NEW_TOKENS + 1))
            same = all(np_.array_equal(r["serve"][i]["logits"], got["logits"])
                       for r in ranks)
            pre = got["prefill"]
            print(f"(a) {arch} seq_shard={seq}: prefill {pre['s']:.3f} s a "
                  f"wave ({coll_s(pre['traffic']):.3f} s in collectives; "
                  f"bytes a call, rank 0: {json.dumps(per_call(pre['traffic']))}"
                  f"); decode {statistics.median(got['step_ms']):.2f} ms a "
                  f"token ({coll_s(got['decode_traffic']) * 1e3 / sum(got['step_ms']):.1%}"
                  f" in collectives); last-token logits against the "
                  f"unsharded bf16 run: max abs {err:.4e} (band {band:.4e}), "
                  f"greedy in band {greedy}, equal on every rank {same}; peak "
                  f"a rank {[round(r['serve'][i]['peak'][0] / 2**30, 2) for r in ranks]}"
                  f" GiB allocated, {[round(r['serve'][i]['peak'][1] / 2**30, 2) for r in ranks]}"
                  f" reserved; flash heads a rank "
                  f"{[r['serve'][i]['path']['heads']['fwd'] for r in ranks]}; "
                  f"RG-LRU routes {ranks[0]['serve'][i]['path']['routes']} "
                  f"[{card}]")
            check(err <= band and greedy and same,
                  f"(a) {arch} seq_shard={seq}: logits {err} outside {band}, "
                  f"greedy out of band, or ranks differ")
            for r in ranks:
                fam_check_path(arch, "(a) serving", r["serve"][i]["path"],
                               heads_a, on_card)
            collect("a", f"{arch} serving, seq_shard={seq}",
                    [r["serve"][i]["path"] for r in ranks])
        ref_loss, gaps, ref_s = results["a_ref"]
        for i, seq in enumerate((False, True)):
            got = ranks[0]["grad"][i]
            ratio = max(got["errs"][k] / max(gaps[k], 1e-30) for k in gaps)
            worst = max(got["errs"].items(), key=lambda kv: kv[1])
            rtol = abs(got["loss"] - ref_loss) / abs(ref_loss)
            losses = [r["grad"][i]["loss"] for r in ranks]
            print(f"(a) {arch} gradient of 1 x {sizes['grad_tokens']}, "
                  f"seq_shard={seq}: loss {got['loss']:.6f} against "
                  f"{ref_loss:.6f} (rel {rtol:.2e}); step {got['s']:.3f} s "
                  f"({coll_s(got['traffic']):.3f} s in collectives; "
                  f"unsharded {ref_s:.3f} s); worst leaf {worst[0]} "
                  f"{worst[1]:.3e}, at most {ratio:.2f} times the leaf's bf16 "
                  f"gap; replicated leaves' gradients bit-equal on every rank "
                  f"{got['replicated_equal']}; peak a rank "
                  f"{[round(r['grad'][i]['peak'][0] / 2**30, 2) for r in ranks]} "
                  f"GiB allocated, {[round(r['grad'][i]['peak'][1] / 2**30, 2) for r in ranks]}"
                  f" reserved; RG-LRU routes {got['path']['routes']} [{card}]")
            check(all(x == losses[0] for x in losses)
                  and rtol <= FAM_LOSS_RTOL and ratio <= FAM_BAND
                  and got["replicated_equal"],
                  f"(a) {arch} gradient seq_shard={seq}: losses {losses} vs "
                  f"{ref_loss}, worst leaf {worst} ({ratio}x)")
            for r in ranks:
                fam_check_path(arch, "(a) gradient", r["grad"][i]["path"],
                               heads_a, on_card)
            collect("a", f"{arch} gradient, seq_shard={seq}",
                    [r["grad"][i]["path"] for r in ranks])
        # ---- (b) -------------------------------------------------------------
        ranks = results["b"]
        b_loss, b_gaps, b_norm, n_window = results["b_ref"]
        pre = ranks[0]["prefill"]
        err = float((torch.as_tensor(pre["logits"])
                     - ref["bfloat16"]["logits"][0]).abs().max())
        tr = ranks[0]["train"]
        rtol = abs(tr["losses"][0] - b_loss) / abs(b_loss)
        norm_rtol = abs(tr["norm"] - b_norm) / b_norm
        # the vocab tables over their window (FAM_B_WINDOWS)
        ratio = max(tr["errs"][k] / max(b_gaps[k], 1e-30) for k in b_gaps)
        worst = max(tr["errs"].items(), key=lambda kv: kv[1])
        losses = [r["train"]["losses"] for r in ranks]
        print(f"(b) {arch} fsdp on (2, 2), seq_shard on: prefill "
              f"{pre['s']:.3f} s ({coll_s(pre['traffic']):.3f} s in "
              f"collectives), logits against the unsharded bf16 run max abs "
              f"{err:.4e} (band {band:.4e}); two adamw() steps of "
              f"{sizes['train'][0]} x {sizes['train'][1]}: losses "
              f"{tr['losses']} (first rel {rtol:.2e}), pre-clip global norm "
              f"rel {norm_rtol:.2e}, worst leaf {worst[0]} {worst[1]:.3e} "
              f"({ratio:.2f}x its bf16 gap; the vocab tables over "
              f"{n_window} ids: " + ", ".join(
                  f"{k} {tr['errs'][k]:.3e} ({tr['errs'][k] / max(b_gaps[k], 1e-30):.2f}x)"
                  for k in FAM_B_WINDOWS) + "), steps "
              + ", ".join(f"{x['s']:.3f} s ({x['coll_s']:.3f} s in "
                          f"collectives)" for x in tr["steps"])
              + f"; bytes a call, rank 0: {json.dumps(per_call(tr['traffic']))}"
              f"; AdamW windows equal to the plain version "
              f"{[r['train']['adamw_same'] for r in ranks]}; replicated "
              f"leaves bit-equal {tr['replicated_equal']}; peak a rank "
              f"{[round(max(r['prefill']['peak'], r['train']['peak']) / 2**30, 2) for r in ranks]}"
              f" GiB allocated, {[round(r['train']['reserved'] / 2**30, 2) for r in ranks]}"
              f" GiB reserved in training [{card}]")
        check(err <= band and all(x == losses[0] for x in losses)
              and rtol <= FSDP_LOSS_RTOL and norm_rtol <= FSDP_NORM_RTOL
              and ratio <= FAM_BAND and tr["replicated_equal"]
              and all(all(r["train"]["adamw_same"]) for r in ranks),
              f"(b) {arch}: logits {err} ({band}), losses {losses} vs "
              f"{b_loss}, norm {tr['norm']} vs {b_norm}, worst {worst}")
        for r in ranks:
            fam_check_path(arch, "(b)", r["prefill"]["path"], heads_bc,
                           on_card)
            fam_check_path(arch, "(b)", r["train"]["path"], heads_bc, on_card)
            check(not on_card
                  or r["train"]["path"]["counts"]["fused_adamw"] == 2,
                  f"(b) {arch}: AdamW launches {r['train']['path']['counts']}")
        collect("b", f"{arch} prefill, fsdp",
                [r["prefill"]["path"] for r in ranks])
        collect("b", f"{arch} training, fsdp",
                [r["train"]["path"] for r in ranks])
        # ---- (c) -------------------------------------------------------------
        ranks = results["c"]
        errs, c_gaps, host_loss16 = results["c_host"]
        ratio = max(errs[k] / max(c_gaps[k], 1e-30) for k in errs)
        rd = ranks[0]["rounds"][1]
        moved = {st["step"]: (st["bytes"], st["ranks"], round(st["ms"], 1))
                 for st in rd["stats"] if "bytes" in st}
        print(f"(c) {arch}: 2 clients of 2 model ranks, flat, sgd("
              f"{DIST_FL_LR}), 1 x {sizes['fl_tokens']} tokens a client: "
              f"rounds {[round(x['s'], 3) for x in ranks[0]['rounds']]} s "
              f"(warm-up, held), the held one's split on rank 0: "
              + ", ".join(f"{st['step']} {st['ms']:.1f} ms"
                          for st in rd["stats"])
              + f"; collectives (step: bytes a rank, ranks, ms) "
              f"{json.dumps(moved)}; loss {rd['loss']:.6f} (host bf16 "
              f"{host_loss16:.6f}); round update against the host "
              f"path's, rel L2 a leaf: worst {max(errs.values()):.3e}, at most "
              f"{ratio:.2f} times its bf16 gap; shards bit-equal along the "
              f"data axis {[r['equal'] for r in ranks]}; peak a rank "
              f"{[round(r['peak'] / 2**30, 2) for r in ranks]} GiB allocated, "
              f"{[round(r['reserved'] / 2**30, 2) for r in ranks]} GiB "
              f"reserved [{card}]")
        check(ratio <= FAM_BAND and all(r["equal"] for r in ranks),
              f"(c) {arch}: round update {ratio} times the band, or shards "
              f"differ along the data axis")
        for r in ranks:
            fam_check_path(arch, "(c)", r["path"], heads_bc, on_card)
        collect("c", f"{arch} rounds", [r["path"] for r in ranks])
        del results
        free()
        print(f"{arch}'s checks and host path took "
              f"{time.perf_counter() - arch_t0:.1f} s "
              f"({time.perf_counter() - phase_t0:.1f} s into phase 30) "
              f"[{card}]")
    by_path = {}
    for k, sub in paths.items():
        for p, n in sub.items():
            if n:
                by_path.setdefault(p, {})[k] = n
    print("phase 30 launches by path: " + json.dumps(by_path))
    print(f"phase 30 took {time.perf_counter() - phase_t0:.1f} s [{card}]")
    return paths


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.cost_model import CostModel
    from repro_torch.core.hierarchy import ClientPool, Hierarchy
    from repro_torch.core.pso import FlagSwapPSO
    from repro_torch.data.synthetic import make_federated_dataset
    from repro_torch.experiments import get_scenario, run_experiment
    from repro_torch.fl.aggregation import SegmentAggregator
    from repro_torch.fl.distributed import choose_fl_hierarchy
    from repro_torch.fl.orchestrator import FederatedOrchestrator
    from repro_torch.kernels import build
    from repro_torch.kernels import fedavg as fedavg_mod
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import fused_adamw as adamw_mod
    from repro_torch.kernels import rglru as rglru_mod
    from repro_torch.kernels import tpd as tpd_mod
    from repro_torch.kernels.fedavg import fedavg, fedavg_batched, fedavg_rows
    from repro_torch.kernels.ref import fedavg_batched_ref, fedavg_ref, fedavg_rows_ref, tpd_ref
    from repro_torch.kernels.tpd import batch_tpd_cuda, leaf_loads, tpd_kernel_inputs
    from repro_torch.models import get_model
    from repro_torch.utils.trees import tree_leaves

    dev = torch.device("cuda")

    # ---- 1. card and toolchain -----------------------------------------
    phase("1. card and toolchain")
    card = card_line()
    print(card)
    nvcc = build.find_nvcc()
    nvcc_version = subprocess.run([nvcc, "--version"], capture_output=True,
                                  text=True, check=True, timeout=60)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    print(f"nvcc {nvcc}: {nvcc_version.stdout.strip().splitlines()[-1]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"TF32: torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} (no convolution runs)")

    # ---- 2. build --------------------------------------------------------
    phase("2. build")
    t0 = time.perf_counter()
    sources = [tpd_mod.SOURCE, fedavg_mod.SOURCE, flash_mod.SOURCE,
               flash_mod.BWD_SOURCE, flash_mod.SM90_SOURCE,
               flash_mod.BWD_SM90_SOURCE, rglru_mod.SOURCE, adamw_mod.SOURCE]
    libs = build.build_libraries(sources)
    build_s = time.perf_counter() - t0
    for lib in libs:
        print(f"built {lib.relative_to(ROOT)}")
        log = lib.with_suffix(".log")
        if log.is_file():
            print(log.read_text().strip())
    print(f"all {len(libs)} builds in {build_s:.2f} s (parallel)")
    fwd_lib, bwd_lib = flash_mod._sm90_library(), flash_mod._bwd_sm90_library()
    dyn = {"flash_fwd_sm90_kernel": fwd_lib.flash_attention_sm90_smem_bytes,
           "flash_bwd_dq_sm90_kernel":
               lambda hd: bwd_lib.flash_attention_bwd_sm90_smem_bytes(hd, 1),
           "flash_bwd_dkdv_sm90_kernel":
               lambda hd: bwd_lib.flash_attention_bwd_sm90_smem_bytes(hd, 2)}
    for src in (flash_mod.SM90_SOURCE, flash_mod.BWD_SM90_SOURCE):
        lib = libs[sources.index(src)]
        for name, regs, smem, st, ld in ptxas_kernels(
                lib.with_suffix(".log").read_text()):
            base, _, hd = name.partition("<")
            extra = f" + {dyn[base](int(hd[:-1]))} B dynamic" \
                if base in dyn else ""
            print(f"{name}: {regs} registers at entry, {smem} B static "
                  f"shared memory{extra}, spills {st} B stored / {ld} B "
                  f"loaded")
        counts = sass_counts(nvcc, lib)
        print(f"{lib.name}: cuobjdump -sass finds {counts['HGMMA']} HGMMA "
              f"and {counts['UTMALDG']} UTMALDG instructions")
        check(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0,
              f"{lib.name}: no wgmma or no TMA load in the SASS ({counts})")
    # the f32 route: split-TF32 mma.sync (HMMA), 8 instantiations each,
    # by output n-tiles (<32> holds 256 columns)
    for src in (flash_mod.SOURCE, flash_mod.BWD_SOURCE):
        lib = libs[sources.index(src)]
        for name, regs, smem, st, ld in ptxas_kernels(
                lib.with_suffix(".log").read_text()):
            print(f"{name}: {regs} registers, {smem} B static shared "
                  f"memory, spills {st} B stored / {ld} B loaded")
        counts = sass_counts(nvcc, lib)
        print(f"{lib.name}: cuobjdump -sass finds {counts['HMMA']} HMMA "
              f"instructions")
        check(counts["HMMA"] > 0,
              f"{lib.name}: no mma.sync in the SASS ({counts})")

    rg_lib = rglru_mod._library()
    for name, regs, smem, st, ld in ptxas_kernels(
            libs[sources.index(rglru_mod.SOURCE)].with_suffix(".log")
            .read_text()):
        print(f"{name}: {regs} registers, {smem} B static shared memory, "
              f"spills {st} B stored / {ld} B loaded")
    for shape, ops in ((RGLRU_TRAIN_SHAPE, 2), (RGLRU_TRAIN_SHAPE, 3),
                       (RGLRU_CASES[0][0], 2)):
        plan = rglru_mod.launch_plan(*shape, 4, ops, "tma",
                                     torch.cuda.get_device_properties(0)
                                     .multi_processor_count)
        dyn = rg_lib.rglru_smem_bytes(ops == 3, 0, 0, plan.stages)
        check(dyn == plan.smem_bytes, f"RG-LRU shared memory: kernel {dyn}, "
                                      f"plan {plan.smem_bytes}")
        print(f"RG-LRU {'adjoint' if ops == 3 else 'scan'} {shape} f32: "
              f"{plan.blocks} blocks of {rglru_mod.GROUP} channels, "
              f"{plan.stages} stages, {dyn} B dynamic shared memory a block")

    tpd_lib = tpd_mod._library()
    for name, regs, smem, st, ld in ptxas_kernels(
            libs[sources.index(tpd_mod.SOURCE)].with_suffix(".log")
            .read_text()):
        print(f"{name}: {regs} registers, {smem} B static shared memory, "
              f"spills {st} B stored / {ld} B loaded")
    static = tpd_lib.tpd_static_smem_bytes()
    check(0 < static <= tpd_mod.STATIC_SMEM,
          f"TPD kernel: {static} B static shared memory, the plan counts "
          f"{tpd_mod.STATIC_SMEM}")
    for label, P, D, C, L in (("large-10k", 10, 1365, 10000, 1024),
                              ("60,000 clients", 10, 21, 60000, 16)):
        plan = tpd_mod.launch_plan(P, D, C, L, build=True)
        dyn = tpd_lib.tpd_smem_bytes(D, C, L,
                                     tpd_mod.ROUTES.index(plan.route))
        check(dyn == plan.smem_bytes and tpd_lib.tpd_scratch_words(C, L)
              == tpd_mod.work_words(C, L),
              f"TPD {label}: kernel {dyn} B, plan {plan.smem_bytes} B")
        print(f"TPD {label} (leaf loads built): route {plan.route}, "
              f"{plan.threads} threads a particle, {dyn} B dynamic + "
              f"{static} B static shared memory, {plan.scratch_words} "
              f"scratch words a particle")

    # ---- 3. TPD kernel vs plain version on the card ---------------------
    phase("3. TPD kernel vs its plain torch versions on the card, leaf "
          "loads given and built")

    def operands(h, pool, P, penalty, seed, dup_rows):
        C = h.total_clients
        rng = np.random.default_rng(seed)
        ps = np.stack([rng.permutation(C)[:h.dimensions]
                       for _ in range(P)]).astype(np.int32)
        for i in range(1, min(dup_rows, P) + 1):
            ps[-i, 1] = ps[-i, 0]
            ps[-i, -1] = ps[-i, 0]
        cm = CostModel(h, pool, memory_penalty=penalty, device=dev)
        attrs_np = cm._attr_stack(np.float32)
        p = torch.as_tensor(ps, device=dev)
        attrs = torch.as_tensor(attrs_np, device=dev)
        leaf = leaf_loads(p, attrs[0], h.n_leaves)
        return cm, ps, attrs_np, (p, attrs, leaf,
                                  *tpd_kernel_inputs(h, device=dev))

    fig3_pool = {}

    def fig3(depth, width):
        h = Hierarchy(depth, width, 2)
        if (depth, width) not in fig3_pool:
            fig3_pool[depth, width] = ClientPool.random(h.total_clients,
                                                        seed=SEED)
        return h, fig3_pool[depth, width]

    def hetero(h, seed):
        pool = ClientPool.random(h.total_clients, seed=seed)
        pool.mdatasize = np.random.default_rng(seed + 1).uniform(
            1.0, 40.0, h.total_clients)
        return pool

    def wide(h, seed):
        """payloads over 2^-30..2^30: float64 leaf sums that are not
        exact, so only bincount's order of adds gives its bits"""
        pool = ClientPool.random(h.total_clients, seed=seed)
        pool.mdatasize = 2.0 ** np.random.default_rng(seed + 1).uniform(
            -30, 30, h.total_clients)
        return pool

    h1k = get_scenario("large-1k").make_hierarchy()
    h10k = get_scenario("large-10k").make_hierarchy()
    h60k = Hierarchy(3, 4, 2, 60000)
    pool10k = ClientPool.random(h10k.total_clients, seed=SEED)
    cases = [("fig3 d3w4", *fig3(3, 4), 10, 0.0, 0),
             ("fig3 d5w5", *fig3(5, 5), 10, 0.0, 0),
             ("large-1k hetero", h1k, hetero(h1k, 1), 10, 3.0, 2),
             ("large-1k hetero", h1k, hetero(h1k, 1), 100, 3.0, 5),
             ("large-1k wide", h1k, wide(h1k, 2), 10, 3.0, 2)]
    for P in (1, 10, 1000):
        for penalty in (0.0, 3.0):
            cases.append(("large-10k", h10k, pool10k, P, penalty,
                          0 if P == 1 else 3))
    cases += [("large-10k wide", h10k, wide(h10k, 3), 1000, 0.0, 3),
              ("60,000 clients wide", h60k, wide(h60k, 4), 10, 3.0, 2)]
    tpd_max_abs_err = 0.0
    for i, (name, h, pool, P, penalty, dups) in enumerate(cases):
        cm, ps, attrs_np, ops = operands(h, pool, P, penalty, 100 + i, dups)
        p, attrs, plain_leaf, kids, starts = ops
        leaf = torch.as_tensor(np_leaf_loads(
            np, ps, attrs_np[0], h.total_clients, h.n_leaves), device=dev)
        check(torch.equal(plain_leaf, leaf),
              f"{name} P={P}: leaf_loads differ from the numpy prefix-sum")
        built_leaf = torch.empty_like(leaf)
        given = batch_tpd_cuda(p, attrs, leaf, kids, starts, penalty=penalty)
        built = batch_tpd_cuda(p, attrs, None, kids, starts, penalty=penalty,
                               leaf_out=built_leaf)
        again = batch_tpd_cuda(p, attrs, None, kids, starts, penalty=penalty)
        torch.cuda.synchronize()
        want = tpd_ref(p, attrs, leaf, kids, starts, penalty=penalty)
        err = max(float((given - want).abs().max()),
                  float((built - want).abs().max()))
        tpd_max_abs_err = max(tpd_max_abs_err, err)
        check(torch.equal(built_leaf, leaf),
              f"{name} P={P}: the kernel's leaf loads differ from "
              f"np.bincount's (max abs err "
              f"{float((built_leaf - leaf).abs().max())})")
        check(torch.equal(given, want) and torch.equal(built, want),
              f"{name} P={P} penalty={penalty}: kernel != plain version "
              f"(max abs err {err})")
        check(torch.equal(again, built), f"{name} P={P}: rerun differs")
        rows = list(range(min(P, 3))) + ([P - 1] if P > 3 else [])
        scalar = np.array([cm.tpd(ps[r]) for r in rows])
        kern = built.cpu().numpy()[rows].astype(np.float64)
        rel = float(np.max(np.abs(kern - scalar) / np.abs(scalar)))
        check(rel <= RTOL_SCALAR, f"{name} P={P}: kernel vs f64 scalar "
                                  f"rel err {rel} > {RTOL_SCALAR}")
        route = tpd_mod.launch_plan(P, h.dimensions, h.total_clients,
                                    h.n_leaves, build=True).route
        print(f"{name:20s} D={h.dimensions:5d} C={h.total_clients:6d} "
              f"P={P:5d} penalty={penalty}: leaf loads built on the "
              f"{route} route equal np.bincount's; TPDs of both modes "
              f"exact (atol 0), rerun bit-equal; rel err vs f64 scalar "
              f"{rel:.2e}")

    # ---- 4. FedAvg kernel vs plain version on the card -------------------
    phase("4. FedAvg kernel vs its plain torch version on the card")
    N_MLP = 1_791_754
    check(sum(x.numel() for x in tree_leaves(get_model(get_config(
        "paper-mlp-1m8")).init(torch.Generator().manual_seed(SEED), "cpu")))
        == N_MLP, "paper-mlp-1m8 does not hold 1,791,754 params")
    fig4_h = get_scenario("paper-fig4").make_hierarchy()
    scale_h = choose_fl_hierarchy(SCALE_CLIENTS)
    print(f"256 clients -> {scale_h}")

    def level_operands(h, placement, N, dtype, seed):
        """A (C + D, N) pool and every level's (rows, w, first out row)
        as the aggregator builds them for ``placement``."""
        rng = np.random.default_rng(seed)
        C = h.total_clients
        agg = SegmentAggregator(h)
        plan = h.round_plan(placement)
        w = rng.dirichlet(np.ones(C)).astype(np.float32)
        tables = [agg._level_tables(i, plan, w)
                  for i in range(len(plan.levels))]
        pool = torch.empty((C + h.dimensions, N), dtype=dtype, device=dev)
        pool.normal_(generator=torch.Generator(dev).manual_seed(seed))
        return pool, tables

    fedavg_max_abs_err = 0.0
    einsum_max_abs_err = 0.0

    def hold(name, pool, rows, w, out=None):
        nonlocal fedavg_max_abs_err, einsum_max_abs_err
        got = fedavg_rows(pool, rows, w, out=out)
        torch.cuda.synchronize()
        want = fedavg_rows_ref(pool, rows, w)
        err = float((got.float() - want.float()).abs().max())
        fedavg_max_abs_err = max(fedavg_max_abs_err, err)
        check(torch.equal(got, want), f"{name}: kernel != plain version "
                                      f"(max abs err {err})")
        r = rows.to(dev).long()
        dense = pool[r.clamp_min(0)].float()
        wd = torch.where(r >= 0, w.to(dev), 0.0)
        lib_err = float((torch.einsum("gkn,gk->gn", dense, wd)
                         - got.float()).abs().max())
        einsum_max_abs_err = max(einsum_max_abs_err, lib_err)
        G, K = rows.shape
        print(f"{name:34s} G={G} K={K:2d} N={pool.shape[1]:8d} "
              f"{str(pool.dtype)[6:]:8s}: exact (atol 0); einsum differs "
              f"by {lib_err:.3e}")

    fig4_place = np.random.default_rng(SEED).permutation(
        fig4_h.total_clients)[:fig4_h.dimensions]
    pool4, tables4 = level_operands(fig4_h, fig4_place, N_MLP,
                                    torch.float32, 1)
    for i, (rows, w, first) in enumerate(tables4):
        hold(f"paper-fig4 level {i} (deepest first)", pool4, rows, w,
             out=pool4[first:first + rows.shape[0]])
    scale_place = np.random.default_rng(SEED).permutation(
        scale_h.total_clients)[:scale_h.dimensions]
    pool256, tables256 = level_operands(scale_h, scale_place, N_MLP,
                                        torch.float32, 2)
    rows, w, _ = tables256[0]
    check(tuple(rows.shape) == (4, 64), f"256-client leaf level is "
                                         f"{tuple(rows.shape)}")
    hold("256-client leaf level", pool256, rows, w)
    del pool256
    for name, R, N, G, K, dtype in (("K = 1", 3, N_MLP, 2, 1, torch.float32),
                                    ("ragged N = 2049", 11, 2049, 3, 4,
                                     torch.float32),
                                    ("ragged N = 7", 9, 7, 2, 5,
                                     torch.float32),
                                    ("bf16 pool, odd rows", 13, N_MLP, 2, 5,
                                     torch.bfloat16),
                                    ("bf16 pool, N = 1001", 7, 1001, 3, 3,
                                     torch.bfloat16)):
        rng = np.random.default_rng(R * 31 + N)
        pool = torch.empty((R, N), device=dev).normal_(
            generator=torch.Generator(dev).manual_seed(R)).to(dtype)
        rows = torch.from_numpy(rng.integers(-1, R, (G, K)).astype(np.int32))
        rows[:, 0] = torch.from_numpy(rng.integers(0, R, G).astype(np.int32))
        w = torch.from_numpy(rng.uniform(0, 1, (G, K)).astype(np.float32))
        hold(name, pool, rows, w)
    # the dense entry points: the (G, K, N) stack and the (K, N) one
    dense = torch.empty((2, 5, N_MLP), device=dev).normal_(
        generator=torch.Generator(dev).manual_seed(3))
    wd = torch.rand((2, 5), device=dev,
                    generator=torch.Generator(dev).manual_seed(4))
    got = fedavg_batched(dense, wd)
    torch.cuda.synchronize()
    check(torch.equal(got, fedavg_batched_ref(dense, wd)),
          "fedavg_batched != fedavg_batched_ref")
    got1 = fedavg(dense[0], wd[0])
    torch.cuda.synchronize()
    check(torch.equal(got1, fedavg_ref(dense[0], wd[0])),
          "fedavg != fedavg_ref")
    lib_err = max(
        float((torch.einsum("gkn,gk->gn", dense, wd) - got).abs().max()),
        float((torch.einsum("kn,k->n", dense[0], wd[0]) - got1).abs().max()))
    einsum_max_abs_err = max(einsum_max_abs_err, lib_err)
    print(f"dense fedavg_batched (2, 5, {N_MLP}) and fedavg (5, {N_MLP}): "
          f"exact (atol 0); einsum differs by {lib_err:.3e}")
    print(f"largest |kernel - plain| {fedavg_max_abs_err}; largest "
          f"|kernel - torch.einsum| {einsum_max_abs_err:.3e} (einsum sums "
          f"in another order; the yardstick only)")

    # ---- 5. simulated main path: the Fig. 3 grid on cuda -----------------
    phase("5. simulated main path: paper Fig. 3 grid on cuda, held to the "
          "CPU run")
    batch_tpd_cuda.launches = 0   # the count to 0 just before the path
    batch_tpd_cuda.routes = dict.fromkeys(tpd_mod.ROUTES, 0)
    t_main = time.perf_counter()

    def run_cell(depth, width, particles, device, backend=None):
        spec = get_scenario("paper-fig3").with_overrides(depth=depth,
                                                         width=width)
        env = spec.make_environment(SEED, device=device)
        h, cm = env.hierarchy, env.cost_model
        if backend is not None:
            cm.set_default_backend(backend)
        pso = FlagSwapPSO(h.dimensions, h.total_clients,
                          n_particles=particles, inertia=0.01, c1=0.01,
                          c2=1.0, velocity_factor=0.1, seed=SEED)
        best = pso.run(cm.fitness, FIG3_ITERATIONS,
                       batch_fitness_fn=cm.batch_fitness)
        return h, cm, pso, best

    cells = []
    for d in FIG3_DEPTH:
        for w in FIG3_WIDTH:
            for P in FIG3_PARTICLES:
                before = batch_tpd_cuda.launches
                t0 = time.perf_counter()
                h, _, pso, best = run_cell(d, w, P, "cuda")
                wall = time.perf_counter() - t0
                launched = batch_tpd_cuda.launches - before
                check(launched == FIG3_ITERATIONS,
                      f"D={d} W={w} P={P}: {launched} kernel launches, "
                      f"expected {FIG3_ITERATIONS}")
                cells.append((d, w, P, h, pso, best, wall))
    fig3_s = time.perf_counter() - t_main

    # large-10k
    env10k = get_scenario("large-10k").make_environment(SEED, device="cuda")
    h, cm10k = env10k.hierarchy, env10k.cost_model
    pso10k = FlagSwapPSO(h.dimensions, h.total_clients, n_particles=10,
                         seed=SEED, record_per_particle=False)
    before = batch_tpd_cuda.launches
    t0 = time.perf_counter()
    best10k = pso10k.run(cm10k.fitness, FULL_SCALE_ITERATIONS,
                         batch_fitness_fn=cm10k.batch_fitness)
    torch.cuda.synchronize()
    wall10k = time.perf_counter() - t0
    launches_tpd = batch_tpd_cuda.launches   # read just after the path
    routes_tpd = dict(batch_tpd_cuda.routes)
    check(launches_tpd - before == FULL_SCALE_ITERATIONS,
          f"large-10k: {launches_tpd - before} launches, expected "
          f"{FULL_SCALE_ITERATIONS}")
    scalar_best = cm10k.tpd(best10k)
    rel = abs(-pso10k.gbest_f - scalar_best) / scalar_best
    check(rel <= RTOL_SCALAR, f"large-10k gbest: kernel TPD "
                              f"{-pso10k.gbest_f} vs scalar {scalar_best}")
    print(f"large-10k D={h.dimensions} C={h.total_clients}: "
          f"{wall10k / 50 * 1e3:.3f} ms per iteration (host clock, "
          f"{FULL_SCALE_ITERATIONS} iterations, {card}); gbest TPD "
          f"{-pso10k.gbest_f:.6f} from the kernel vs {scalar_best:.6f} "
          f"scalar (rel {rel:.2e}); TPD {pso10k.history.mean[0]:.4f} -> "
          f"{pso10k.history.best[-1]:.4f}")
    check(routes_tpd == {**dict.fromkeys(tpd_mod.ROUTES, 0),
                         "shared": launches_tpd},
          f"simulated path: TPD launches by route {routes_tpd}, expected "
          f"all on the route that builds the leaf loads in shared memory")
    print(f"simulated path: {launches_tpd} TPD kernel launches (12 Fig. 3 "
          f"cells x {FIG3_ITERATIONS} + {FULL_SCALE_ITERATIONS}), by route "
          f"{routes_tpd}")

    # the Fig. 3 grid again on the CPU: every cell must match exactly
    for d, w, P, h, pso, best, wall in cells:
        _, _, cpu, cpu_best = run_cell(d, w, P, "cpu", backend="torch")
        same = (pso.history.best == cpu.history.best
                and pso.history.mean == cpu.history.mean
                and pso.history.worst == cpu.history.worst
                and np.array_equal(best, cpu_best)
                and np.array_equal(pso.gbest_x, cpu.gbest_x))
        check(same, f"D={d} W={w} P={P}: cuda history/gbest differ from "
                    f"the CPU run")
        print(f"D={d} W={w} P={P:2d} | clients={h.total_clients:5d} "
              f"slots={h.dimensions:4d} | TPD {pso.history.mean[0]:8.3f} "
              f"-> {-pso.gbest_f:8.3f} | {wall / FIG3_ITERATIONS * 1e3:.3f} "
              f"ms/iteration on cuda | equal to the CPU run")
    gbest = {(d, w, P): -pso.gbest_f for d, w, P, _, pso, _, _ in cells}
    improved = sum(-pso.gbest_f < pso.history.mean[0]
                   for _, _, _, _, pso, _, _ in cells)
    p10_wins = sum(gbest[d, w, 10] <= gbest[d, w, 5] * 1.02
                   for d in FIG3_DEPTH for w in FIG3_WIDTH)
    print(f"paper claims (printed, not checked): {improved}/{len(cells)} "
          f"cells improved TPD; P=10 <= P=5 (x1.02) in {p10_wins}/6 grids; "
          f"grid took {fig3_s:.2f} s on cuda")

    # ---- 6. emulated main path: paper-fig4 on cuda -----------------------
    phase("6. emulated main path: run_experiment('paper-fig4', ...) on "
          "cuda, held to the CPU run")
    fig4 = get_scenario("paper-fig4")
    print(f"paper-fig4: {fig4_h}, model {fig4.model}, engine "
          f"{fig4.engine}, timing {fig4.timing}, {FIG4_ROUNDS} rounds")
    envs_cuda, envs_cpu = [], []
    fedavg_batched.launches = 0   # the count to 0 just before the path
    t0 = time.perf_counter()
    res_cuda = run_experiment(recording(fig4, envs_cuda), FIG4_STRATEGIES,
                              rounds=FIG4_ROUNDS, seeds=[SEED],
                              device="cuda")
    torch.cuda.synchronize()
    fig4_cuda_s = time.perf_counter() - t0
    launches_fedavg_batched = fedavg_batched.launches   # just after
    want = len(FIG4_STRATEGIES) * (FIG4_ROUNDS + 1) * fig4_h.depth
    check(launches_fedavg_batched == want,
          f"paper-fig4: {launches_fedavg_batched} fedavg_batched launches, "
          f"expected {want} (2 levels x (50 rounds + 1 warmup) x 3 runs)")
    print(f"{launches_fedavg_batched} fedavg_batched launches = "
          f"{fig4_h.depth} levels x ({FIG4_ROUNDS} rounds + 1 warmup "
          f"round) x {len(FIG4_STRATEGIES)} strategies; {fig4_cuda_s:.2f} s "
          f"on cuda")
    t0 = time.perf_counter()
    res_cpu = run_experiment(recording(fig4, envs_cpu), FIG4_STRATEGIES,
                             rounds=FIG4_ROUNDS, seeds=[SEED], device="cpu",
                             progress=False)
    fig4_cpu_s = time.perf_counter() - t0
    max_loss_rel, max_param_abs = 0.0, 0.0
    for name, ec, eh in zip(FIG4_STRATEGIES, envs_cuda, envs_cpu,
                            strict=True):
        check(len(ec.steps) == len(eh.steps) == FIG4_ROUNDS,
              f"{name}: {len(ec.steps)} cuda / {len(eh.steps)} cpu rounds")
        check([s[:2] for s in ec.steps] == [s[:2] for s in eh.steps],
              f"{name}: cuda placements/TPDs differ from the CPU run")
        lc = np.array([s[2] for s in ec.steps])
        lh = np.array([s[2] for s in eh.steps])
        check(bool(np.all(np.isfinite(lc))), f"{name}: non-finite loss")
        loss_rel = float(np.max(np.abs(lc - lh) / np.abs(lh)))
        max_loss_rel = max(max_loss_rel, loss_rel)
        check(loss_rel <= LOSS_RTOL, f"{name}: losses differ by rel "
                                     f"{loss_rel} > {LOSS_RTOL}")
        for a, b in zip(tree_leaves(ec.orchestrator.params),
                        tree_leaves(eh.orchestrator.params), strict=True):
            a, b = a.cpu().numpy(), b.numpy()
            check(a.shape == b.shape and bool(np.all(np.isfinite(a))),
                  f"{name}: final params malformed")
            max_param_abs = max(max_param_abs, float(np.max(np.abs(a - b))))
            check(np.allclose(a, b, **PARAM_TOL),
                  f"{name}: final params differ beyond {PARAM_TOL}")
        print(f"{name:8s}: {FIG4_ROUNDS} placements and TPDs equal to the "
              f"CPU run; loss {lh[0]:.4f} -> {lh[-1]:.4f}, largest rel "
              f"loss diff {loss_rel:.2e}")
    print(f"largest loss rel diff {max_loss_rel:.3e} (rtol {LOSS_RTOL}); "
          f"largest final-param abs diff {max_param_abs:.3e} ({PARAM_TOL}); "
          f"CPU run took {fig4_cpu_s:.2f} s")
    agg = res_cuda.aggregates
    pso_t, uni_t, rnd_t = (agg[s]["total_tpd"] for s in ("pso", "uniform",
                                                          "random"))
    print(f"paper claims (printed, not checked): PSO total TPD {pso_t:.2f} "
          f"vs uniform {uni_t:.2f} ({(1 - pso_t / uni_t) * 100:.1f}% less) "
          f"and random {rnd_t:.2f} ({(1 - pso_t / rnd_t) * 100:.1f}% less); "
          f"the abstract reports 43% and 32%")
    check(all(agg[s]["total_tpd"] == res_cpu.aggregates[s]["total_tpd"]
              for s in FIG4_STRATEGIES),
          "aggregate TPDs differ from the CPU run")

    # ---- 7. the loop engine ----------------------------------------------
    phase(f"7. loop engine: paper-fig4, {LOOP_ROUNDS} rounds on cuda")
    envs_loop, envs_short = [], []
    fedavg.launches = 0   # the count to 0 just before the path
    run_experiment(recording(fig4.with_overrides(engine="loop"), envs_loop),
                   ["pso"], rounds=LOOP_ROUNDS, seeds=[SEED], device="cuda")
    torch.cuda.synchronize()
    launches_fedavg = fedavg.launches   # just after
    want = fig4_h.dimensions * LOOP_ROUNDS + 3
    check(launches_fedavg == want,
          f"loop engine: {launches_fedavg} fedavg launches, expected {want} "
          f"(3 clusters x {LOOP_ROUNDS} rounds + 3 warmup fan-ins)")
    run_experiment(recording(fig4, envs_short), ["pso"], rounds=LOOP_ROUNDS,
                   seeds=[SEED], device="cuda", progress=False)
    loop_tpds = [s[:2] for s in envs_loop[0].steps]
    check(loop_tpds == [s[:2] for s in envs_short[0].steps]
          and loop_tpds == [s[:2] for s in envs_cuda[0].steps[:LOOP_ROUNDS]],
          "loop engine TPD trace differs from the batched engine's")
    loop_diff = 0.0
    for a, b in zip(tree_leaves(envs_loop[0].orchestrator.params),
                    tree_leaves(envs_short[0].orchestrator.params),
                    strict=True):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        loop_diff = max(loop_diff, float(np.max(np.abs(a - b))))
        check(np.allclose(a, b, **PARAM_TOL),
              "loop engine params differ from the batched engine's")
    print(f"{launches_fedavg} fedavg launches = 3 clusters x {LOOP_ROUNDS} "
          f"rounds + 3 warmup fan-ins; TPD trace equal to the batched "
          f"engine's; largest param abs diff {loop_diff:.3e}")

    # ---- 8. where a round's time goes: paper-fig4, then 256 clients ------
    sync = torch.cuda.synchronize

    def round_split(label, orch, rounds):
        """Per-round time of local training (host batch collection
        timed alone beside it), aggregation and evaluation, host clock
        around synchronised parts; checks the aggregate against the flat
        weighted FedAvg of the same stack."""
        h = orch.hierarchy
        C = h.total_clients
        orch.warmup()
        w_dev = torch.as_tensor(orch.weights, device=dev)
        for r in range(rounds):
            placement = np.random.default_rng((SEED, r)).permutation(C)[
                :h.dimensions]
            t0 = time.perf_counter()
            orch._collect_batches(r)
            collect = time.perf_counter() - t0
            sync()
            t0 = time.perf_counter()
            stacked, _ = orch.train_cohort(np.arange(C), r)
            sync()
            t1 = time.perf_counter()
            new, _ = orch.aggregate_cohort(stacked, placement)
            sync()
            t2 = time.perf_counter()
            flat = (stacked["layers"][0]["w"] * w_dev[:, None, None]).sum(0)
            check(torch.allclose(new["layers"][0]["w"], flat, rtol=1e-4,
                                 atol=1e-6),
                  f"{label}: hierarchical FedAvg != flat weighted sum")
            orch.set_global(new)
            sync()
            t3 = time.perf_counter()
            loss, acc = orch.evaluate_global()
            t4 = time.perf_counter()
            check(np.isfinite(loss), f"{label}: round {r} loss {loss}")
            print(f"{label} round {r}: local training {(t1 - t0) * 1e3:.2f}"
                  f" ms (host batch collection alone {collect * 1e3:.2f} "
                  f"ms), aggregation {(t2 - t1) * 1e3:.2f} ms, evaluation "
                  f"{(t4 - t3) * 1e3:.2f} ms; loss {loss:.4f} acc {acc:.3f} "
                  f"(host clock, synchronised) [{card}]")

    phase(f"8. where a round's time goes: paper-fig4, then "
          f"{SCALE_CLIENTS} clients (paper-mlp-1m8, {SCALE_LOCAL_STEPS} "
          f"local steps of batch {SCALE_BATCH}), {SCALE_ROUNDS} rounds on "
          f"cuda")
    round_split("paper-fig4", fig4.make_environment(
        SEED, device="cuda").orchestrator, SCALE_ROUNDS)
    cfg = get_config("paper-mlp-1m8")
    C = scale_h.total_clients
    torch.cuda.reset_peak_memory_stats()
    round_split(f"{C} clients", FederatedOrchestrator(
        get_model(cfg), scale_h, ClientPool.random(C, seed=SEED),
        make_federated_dataset(cfg, C, seed=SEED),
        local_steps=SCALE_LOCAL_STEPS, batch_size=SCALE_BATCH, seed=SEED,
        timing="deterministic", engine="batched", device="cuda"),
        SCALE_ROUNDS)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; client stack {C} x {N_MLP} f32 = "
          f"{C * N_MLP * 4 / 1e9:.2f} GB")

    # ---- 9. timings --------------------------------------------------------
    phase(f"9. timings on {card}")
    floor_ms = median_device_ms(torch, lambda: torch.cuda._sleep(1))
    print(f"floor of one launch (torch.cuda._sleep(1), timed as the "
          f"kernels): {floor_ms * 1e3:.2f} us on the device [{card}]")
    rows = {}
    L10k, W10k, D10k = h10k.n_leaves, h10k.width, h10k.depth
    for P in (10, 1000):
        cm, ps, _, ops = operands(h10k, pool10k, P, 0.0, 7 + P, 0)
        p, attrs, leaf, kids, starts = ops

        def built(p=p, attrs=attrs, kids=kids, starts=starts):
            return batch_tpd_cuda(p, attrs, None, kids, starts)

        def fused_plain(p=p, attrs=attrs, kids=kids, starts=starts):
            return tpd_ref(p, attrs, leaf_loads(p, attrs[0], L10k), kids,
                           starts)

        g_ms = median_device_ms(torch, lambda ops=ops: batch_tpd_cuda(*ops))
        b_ms = median_device_ms(torch, built)
        # one plain call per run: leaf_loads is a few dozen small
        # launches, and a run must stay under the device's queue of
        # pending launches, or the host blocks on it behind the spin
        leaf_ms = median_device_ms(
            torch, lambda p=p, attrs=attrs: leaf_loads(p, attrs[0], L10k),
            runs=9, per_run=1)
        rg_ms = median_device_ms(torch, lambda ops=ops: tpd_ref(*ops))
        rb_ms = median_device_ms(torch, fused_plain, runs=9, per_run=1)
        g_call = median_event_ms(torch, lambda ops=ops: batch_tpd_cuda(*ops))
        b_call = median_event_ms(torch, built)
        g_bytes = tpd_bytes(ps, L10k, W10k, D10k, 0.0)
        b_bytes = tpd_fused_bytes(ps, h10k.total_clients, L10k, W10k, D10k,
                                  0.0)
        gb_ms = g_bytes / HBM_BYTES_PER_S * 1e3
        bb_ms = b_bytes / HBM_BYTES_PER_S * 1e3
        rows[P] = (b_ms, rb_ms, bb_ms)
        out = torch.empty(P, device=dev)
        starts_c = (ctypes.c_int * len(starts))(*starts)

        def raw(threads, route, leaf_ptr, P=P, p=p, attrs=attrs, kids=kids,
                out=out, starts_c=starts_c):
            """The kernel alone at a block size the plan may not pick."""
            def call():
                code = tpd_lib.tpd_launch(
                    p.data_ptr(), attrs.data_ptr(), leaf_ptr,
                    kids.data_ptr(), None, None, out.data_ptr(), starts_c,
                    P, h10k.dimensions, h10k.total_clients, W10k, D10k,
                    threads, tpd_mod.ROUTES.index(route), 0.0,
                    torch.cuda.current_stream().cuda_stream)
                check(code == 0, f"TPD launch failed ({code})")
            return call

        planned = {route: tpd_mod.launch_plan(
            P, h10k.dimensions, h10k.total_clients, L10k,
            build=route == "shared").threads for route in ("shared", "given")}
        sizes = "; ".join(
            f"{route} " + ", ".join(
                f"{t}: {median_device_ms(torch, raw(t, route, ptr)) * 1e3:.2f}"
                for t in (256, 512, 1024))
            + f" us (the plan: {planned[route]})"
            for route, ptr in (("shared", None), ("given", leaf.data_ptr())))
        print(f"TPD large-10k P={P:5d}, threads a block: {sizes} [{card}]")
        print(f"TPD large-10k P={P:5d}, device time per call: leaf loads "
              f"built {b_ms * 1e3:8.2f} us (bound {bb_ms * 1e3:.4f} us, "
              f"{b_bytes} B / 3.35 TB/s), given {g_ms * 1e3:8.2f} us "
              f"(bound {gb_ms * 1e3:.4f} us, {g_bytes} B), launch floor "
              f"{floor_ms * 1e3:.2f} us; plain versions: leaf_loads "
              f"{leaf_ms * 1e3:9.2f} us + tpd_ref {rg_ms * 1e3:9.2f} us = "
              f"{rb_ms * 1e3:9.2f} us together; back-to-back wrapper call: "
              f"built {b_call * 1e3:8.2f} us, given {g_call * 1e3:8.2f} us "
              f"[{card}]")

    hd = Hierarchy(5, 5, 2)
    cmd, psd, _, opsd = operands(hd, fig3(5, 5)[1], 10, 0.0, 11, 0)
    kd_ms = median_device_ms(torch, lambda: batch_tpd_cuda(
        opsd[0], opsd[1], None, *opsd[3:]))
    kd_call_ms = median_event_ms(torch, lambda: batch_tpd_cuda(
        opsd[0], opsd[1], None, *opsd[3:]))
    bd_ms = tpd_fused_bytes(psd, hd.total_clients, hd.n_leaves, hd.width,
                            hd.depth, 0.0) / HBM_BYTES_PER_S * 1e3
    np_ms = median_host_ms(lambda: cmd.batch_tpd(psd, backend="np"))
    print(f"TPD fig3 d5w5 P=10, leaf loads built: kernel {kd_ms * 1e3:.2f} "
          f"us on the device, {kd_call_ms * 1e3:.2f} us per wrapper call, "
          f"bound {bd_ms * 1e3:.4f} us; numpy batch_tpd(backend='np') "
          f"{np_ms * 1e3:.2f} us (host clock) [{card}]")

    # one batch_tpd(backend="kernel") call: what the device runs
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cm, ps, _, ops = operands(h10k, pool10k, 10, 0.0, 5, 0)
    cm.batch_tpd(ps, backend="kernel")   # tables uploaded before
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cm.batch_tpd(ps, backend="kernel")
        torch.cuda.synchronize()
    on_device = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
    copies = [n for n in on_device if n.lower().startswith("memcpy")]
    kernels = [n for n in on_device if n not in copies]
    print(f"batch_tpd(backend='kernel') under torch.profiler, large-10k "
          f"P=10: {len(kernels)} kernel(s) {kernels} and {len(copies)} "
          f"copies {copies} on the device")
    check(len(copies) == 2 and len(kernels) == 1
          and "tpd_kernel" in kernels[0],
          f"batch_tpd(backend='kernel') ran {on_device} on the device, "
          f"expected one TPD kernel and two copies")

    # where one large-10k iteration goes (P = 10)
    p_dev, attrs, kids, starts = ops[0], ops[1], ops[3], ops[4]
    h2d_ms = median_host_ms(lambda: torch.as_tensor(ps, device=dev),
                            sync=torch.cuda.synchronize)
    enqueue_ms = median_host_ms(lambda: batch_tpd_cuda(p_dev, attrs, None,
                                                       kids, starts))
    torch.cuda.synchronize()
    out_dev = batch_tpd_cuda(p_dev, attrs, None, kids, starts)
    d2h_ms = median_host_ms(lambda: out_dev.cpu().numpy())
    full_ms = median_host_ms(lambda: cm.batch_tpd(ps, backend="kernel"))
    swarm = FlagSwapPSO(h10k.dimensions, h10k.total_clients, n_particles=10,
                        seed=SEED, record_per_particle=False)
    fs = -cm.batch_tpd(swarm.placements(), backend="np").astype(np.float64)

    def host_update():
        swarm.history.record(-fs)
        swarm._update_bests_swarm(fs)
        swarm._step_swarm()
        swarm.placements()

    pso_ms = median_host_ms(host_update)
    print(f"large-10k iteration (P=10), host clock: H2D {h2d_ms * 1e3:.1f} "
          f"us, launch (the wrapper's host time) {enqueue_ms * 1e3:.1f} us, "
          f"kernel {rows[10][0] * 1e3:.1f} us on the device, D2H "
          f"{d2h_ms * 1e3:.1f} us, whole batch_tpd {full_ms * 1e3:.1f} us, "
          f"host PSO update {pso_ms * 1e3:.1f} us; measured iteration "
          f"{wall10k / FULL_SCALE_ITERATIONS * 1e3 * 1e3:.1f} us [{card}]")

    # numbers for a GPU auto-dispatch threshold: whole batch_tpd calls
    for name, hh, pool, P in (("fig3 d3w4", *fig3(3, 4), 10),
                              ("fig3 d5w5", *fig3(5, 5), 10),
                              ("large-1k", h1k, ClientPool.random(
                                  h1k.total_clients, seed=SEED), 10),
                              ("large-10k", h10k, pool10k, 10),
                              ("large-10k", h10k, pool10k, 1000)):
        cm, ps, _, _ = operands(hh, pool, P, 0.0, 3, 0)
        t = {b: median_host_ms(lambda cm=cm, ps=ps, b=b: cm.batch_tpd(ps, b))
             for b in ("np", "torch", "kernel")}
        print(f"batch_tpd {name:10s} P={P:5d} (P*C={P * hh.total_clients}):"
              f" np {t['np'] * 1e3:9.1f} us, torch {t['torch'] * 1e3:9.1f} "
              f"us, kernel {t['kernel'] * 1e3:9.1f} us (host clock) "
              f"[{card}]")

    # FedAvg at the main path's shapes: paper-fig4's levels (the batched
    # engine's row form) and the loop engine's largest cluster (K = 5)
    lib = fedavg_mod._library()

    def raw_launch(pool, rows_d, w_d, out):
        """The kernel alone, tables already on the card (no staging, no
        checks): its device time."""
        def call():
            code = lib.fedavg_rows_launch(
                pool.data_ptr(), rows_d.data_ptr(), w_d.data_ptr(),
                out.data_ptr(), rows_d.shape[0], rows_d.shape[1],
                pool.shape[1], 0, torch.cuda.current_stream().cuda_stream)
            check(code == 0, f"FedAvg launch failed ({code})")
        return call

    def fedavg_case(label, pool_rows, rows, w):
        """Time kernel / wrapper / plain / einsum for one (rows, w) over
        copies of a pool, rotated past the L2 cache."""
        G, K = rows.shape
        nbytes = fedavg_bytes(rows.numpy(), N_MLP, 4, 4)
        copies = max(2, -(-3 * L2_BYTES // nbytes))
        pools = [torch.empty((pool_rows, N_MLP), device=dev).normal_(
            generator=torch.Generator(dev).manual_seed(50 + i))
            for i in range(copies)]
        outs = [torch.empty((G, N_MLP), device=dev) for _ in range(copies)]
        rows_d, w_d = rows.to(dev), w.to(dev)
        r_long = rows_d.long()
        denses = [p[r_long.clamp_min(0)] for p in pools]
        wd = torch.where(r_long >= 0, w_d, 0.0)
        k_ms = median_device_ms(torch, rotating(
            [raw_launch(p, rows_d, w_d, o) for p, o in zip(pools, outs)]))
        call_ms = median_event_ms(torch, rotating(
            [lambda p=p, o=o: fedavg_rows(p, rows, w, out=o)
             for p, o in zip(pools, outs)]))
        # one call per run: at K = 64 a call is ~450 small launches,
        # and a run must stay under the device's queue of pending
        # launches, or the host blocks on it behind the spin
        plain_ms = median_device_ms(torch, rotating(
            [lambda p=p: fedavg_rows_ref(p, rows_d, w_d) for p in pools]),
            runs=9, per_run=1)
        lib_ms = median_device_ms(torch, rotating(
            [lambda d=d: torch.einsum("gkn,gk->gn", d, wd)
             for d in denses]))
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"FedAvg {label:30s} G={G} K={K}: device time per call: "
              f"kernel {k_ms * 1e3:8.2f} us, plain torch "
              f"{plain_ms * 1e3:9.2f} us, torch.einsum on the dense stack "
              f"{lib_ms * 1e3:8.2f} us; wrapper call {call_ms * 1e3:8.2f} "
              f"us; bound {b_ms * 1e3:.2f} us ({nbytes} B / 3.35 TB/s, "
              f"{k_ms and b_ms / k_ms * 100:.1f}% of it) [{card}]")
        del pools, outs, denses
        return k_ms, plain_ms, b_ms, lib_ms

    C4 = fig4_h.total_clients
    (leaf_rows, leaf_w, _), (root_rows, root_w, _) = tables4
    del pool4
    leaf = fedavg_case("paper-fig4 leaf level", C4 + fig4_h.dimensions,
                       leaf_rows, leaf_w)
    fedavg_case("paper-fig4 root level", C4 + fig4_h.dimensions, root_rows,
                root_w)
    rows256, w256, _ = tables256[0]
    fedavg_case("256-client leaf level", scale_h.total_clients
                + scale_h.dimensions, rows256, w256)
    flat_rows = torch.arange(5, dtype=torch.int32).view(1, 5)
    flat_w = torch.full((1, 5), 1.0)
    flat = fedavg_case("loop-engine cluster (fedavg)", 5, flat_rows, flat_w)
    flat_call_ms = median_event_ms(torch, lambda: fedavg(dense[0], wd[0]))
    print(f"fedavg (K, N) = (5, {N_MLP}) wrapper call {flat_call_ms * 1e3:.2f}"
          f" us [{card}]")

    hybrid = hybrid_phases(torch, np, dev, card)
    training = training_phases(torch, np, dev, card)
    runner_phases(torch, np, card)
    online_phases(torch, np, card)
    dense = dense_phases(torch, np, dev, card)
    moe_paths = moe_phases(torch, np, dev, card)
    xlstm_paths = xlstm_phases(torch, np, dev, card)
    mm_paths_, mm_errs = vlm_audio_phases(torch, np, dev, card)
    dist_paths = distributed_phases(torch, np, card)
    tp_paths = tensor_parallel_phases(torch, np, card)
    dm_paths = data_model_phases(torch, np, card)
    fam_paths = hybrid_audio_phases(torch, np, card)

    k_ms, r_ms, b_ms = rows[10]
    kernels = [
        {"name": "tpd", "route": "cuda",
         "source": "src/repro_torch/csrc/tpd.cu",
         "replaces": "src/repro/kernels/tpd.py:75",
         "launches": launches_tpd, "max_abs_err": tpd_max_abs_err,
         "ms": k_ms, "plain_ms": r_ms, "bound_ms": b_ms,
         "bound_by": "bytes", "library_ms": None},
        {"name": "fedavg_batched", "route": "cuda",
         "source": "src/repro_torch/csrc/fedavg.cu",
         "replaces": "src/repro/kernels/fedavg.py:31",
         "launches": launches_fedavg_batched,
         "max_abs_err": fedavg_max_abs_err,
         "ms": leaf[0], "plain_ms": leaf[1], "bound_ms": leaf[2],
         "bound_by": "bytes", "library_ms": leaf[3]},
        {"name": "fedavg", "route": "cuda",
         "source": "src/repro_torch/csrc/fedavg.cu",
         "replaces": "src/repro/kernels/fedavg.py:25",
         "launches": launches_fedavg, "max_abs_err": fedavg_max_abs_err,
         "ms": flat[0], "plain_ms": flat[1], "bound_ms": flat[2],
         "bound_by": "bytes", "library_ms": flat[3]},
        *hybrid,
        *training,
    ]
    # each path's launches, counted from 0 over it: the earlier main
    # paths' (as named in the module docstring), then phases 22-30
    for entry in kernels:
        paths = {"phases 5-16": entry["launches"], **dense[entry["name"]],
                 **moe_paths[entry["name"]], **xlstm_paths[entry["name"]],
                 **mm_paths_[entry["name"]], **dist_paths[entry["name"]],
                 **tp_paths[entry["name"]], **dm_paths[entry["name"]],
                 **fam_paths.get(entry["name"], {})}
        entry["launches"] = sum(paths.values())
        entry["launches_by_path"] = paths
        if entry["name"] in mm_errs:        # phase 26 (a)'s shapes too
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       mm_errs[entry["name"]])
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
