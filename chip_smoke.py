#!/usr/bin/env python3
"""Run the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each on stdout; any failure exits non-zero and prints
no result line:

1. ``device``: needs ``torch.cuda.is_available()``; prints the card's name
   and power limit as ``nvidia-smi`` reports them.
2. ``build``: starts compiling every CUDA source of ``scalerl_torch/csrc``
   with ``nvcc`` (one process per source, all started together) and waits
   for V-trace's; the others compile while the next phases run.
   ``kernels_built``, run before ``paged_attn``, waits for the rest and
   prints the ``build`` line: fails if ptxas reports a local-memory spill
   in any kernel; reports the registers of each flash, segment, paged, PER
   and V-trace kernel (instantiation).
3. ``vtrace``: the V-trace kernel against its plain PyTorch version on the
   card, for three clip settings (max abs error <= 1e-5, each call twice
   and bit-equal), at the fused loop's [20, 512], ImpalaArguments'
   defaults [80, 8], the transformer learner's [16, 8], ragged shapes
   ([1, 1], [37, 5], [20, 1000], [70, 1001]: B not a multiple of 4, T not
   a multiple of the kernel's chunks), a bandwidth probe [80, 4096], and
   planes with NaN log-rhos (NaN at the plain version's positions); its
   times by replay and eagerly at the four timed shapes beside their byte
   bounds and the replay floor of a one-element op, and the plain
   version's time at [20, 512].
4. ``model``: full-width ``AtariNet`` on the card against the same weights
   on the host, float32 with TF32 off (atol 1e-4).
5. ``impala_learn``: one full-width learn step with the kernel on the card
   against the plain V-trace on the card and the plain step on the host,
   float32 with TF32 off (tolerances and their reasons in ``LEARN_TOL``).
6. ``impala_fused``: the main path as ``bench.py`` sets it up (synthetic
   84x84x4 env, feed-forward AtariNet with hidden 512 and a bf16 torso,
   B=512, T=20, 5 iterations per chunk, V-trace through the kernel): one
   warm-up chunk, then ``MAIN_CHUNKS`` chunks under ``torch.cuda.set_sync_debug_mode
   ("error")`` with every kernel's launch count zeroed just before; then
   one more chunk under ``torch.profiler`` for the device's busy share,
   the heaviest kernels and the V-trace kernel's own µs a call and calls a
   chunk (``impala_profile``).
7. ``impala_lstm_learn``: ``ImpalaArguments``' own defaults (``AtariNet``
   with its 2-layer LSTM core, hidden 512, T=80, B=8, float32, TF32 off)
   on a trajectory the fused loop collects from the synthetic env with a
   carried core state: the model on the card against the host (outputs
   and carry within ``MODEL_TOL``), then the loss, the gradients leaf by
   leaf and one learn step with the V-trace kernel against the plain
   version (``LEARN_TOL``'s loss and grad-norm bounds, each leaf within
   1e-4 of its largest gradient; one kernel launch, none in the plain
   step).
8. ``impala_lstm_fused``: the fused loop at those defaults (the lr
   schedule over 30M frames included), 5 iterations a chunk: one warm-up
   chunk, ``LSTM_CHUNKS`` chunks under sync debug mode "error" (V-trace launches =
   chunks x iterations), then one iteration's unroll and learn step under
   ``torch.profiler`` (``impala_lstm_profile``), and its launches, busy
   share and V-trace µs a call at [80, 8] beside the feed-forward chunk's
   (``impala_lstm_vs_ff``).
9-11. ``learn_synthetic``, ``learn_catch``, ``learn_recall``: the
   reference's learning recipes (``tools/torch_learning_curves.py``) on
   the card at seed 0, V-trace through the kernel: ``run_until`` must
   cross 0.85 on ``TensorCatch(24)`` within 600,000 frames, and 0.8 on
   ``TensorRecall(16, delay 6)`` with the LSTM within 400,000, whose
   feed-forward control for the same frames must end below 0; on the
   synthetic 24x24x4 env the crossing of 54.4 is reported, not required
   (the reference's own recipe misses it at seed 0, with the same dead
   action), over ``SYNTHETIC_FRAMES`` = 40,000 frames (the recipe's
   500,000 stay in ``tools/torch_learning_curves.py``); one V-trace launch
   per learn step, every chunk finite.
12. ``per_kernels``: the prioritized-replay kernels against their plain
   PyTorch versions on the card.  The sample (both kernels: block sums,
   then the search) at N = 2^20 and a ragged N = 1,000,003, S in {32, 512},
   on the sequence-RL replay's 128-slot plane with pad slots and on R2D2's
   2,048-slot plane at its batch of 16, filled to 1,500 and full (empty
   slots never drawn): each call twice, bit-equal, and equal to
   ``ops/per.py::kernel_order_sample`` (their arithmetic in plain PyTorch);
   on integer priorities equal to the plain version; on ``uniform**0.6``
   priorities each index brackets its own residual to within
   ``PER_BRACKET_REL`` of its block's sum, and its block and residual
   differ from ``split_targets``' only within ``PER_PREFIX_REL`` of the
   plane's total of a block boundary.  The update with and without block
   sums at M = 512 (a few duplicates and revisits; each slot hit four
   times) and at M = 3 x ``MAX_UPDATES`` (duplicates within and across its
   chunks, one launch each): the plane exact and equal to an ordered host
   loop, the sums within ``PER_SUMS_RTOL`` of the plain version's and
   bit-equal to the kernels' own block-sum order, repeats bit-equal.  Times
   by CUDA-graph replay and eagerly beside the byte bounds and the replay
   floor of a one-element PyTorch op.
13. ``dqn_learn``: one full-size learn step (sample -> learn -> priority
   update) from the same buffer contents and uniforms, once through the
   kernels and once through the plain versions (the sample in the
   kernels' order of sums, ``kernel_order_sample``), float32 with TF32
   off: indices equal, priority plane and params within ``DQN_LEARN_TOL``.
14. ``dqn_per``: the slice's main path, ``OffPolicyTrainer(...).run()`` for
   DQN with prioritized replay through both kernels on ``TensorCartPole``
   (16 envs, a 65,536 x 16 replay, batch 512, 3-step returns, 40,000 env
   steps), with every kernel's launch count zeroed just before; then 20
   learn steps under ``torch.profiler`` (``dqn_profile``).
15. ``paged_attn``: the paged decode attention kernel against its plain
    PyTorch version on the card (max abs error <= ``PAGED_TOL``), each case
    twice and bit-equal: at the generation engine's shape (256 lanes, 8
    heads of 32, pages of 16, 24 per lane, 6,145 pages; fragmented seeded
    tables with shared pages, null or random junk past each length, lengths
    over [1, 384], and lengths on and beside the kernel's 16-token chunks
    and 64-token splits, a full lane among them), at the small layouts of
    the JAX tests with a length-1 lane, at pages of 4, 8 and 12, partial
    head groups, head dims 5, 16, 18, 20, 64 and 128, and in bfloat16
    (``PAGED_BF16_TOL``).  Its time by CUDA-graph replay and eagerly, the
    plain version's, the byte bound, the size of its per-call scratch, and
    gather + SDPA as context.
16. ``genrl_model``: the full-width generation model (V=32, d=256, 8
    heads, 4 layers) on the card against the same weights on the host,
    float32 with TF32 off (``GEN_MODEL_TOL``): masked forward, paged
    prefill, paged decode through the kernel, tail prefill, the pools.
17. ``genrl_decode``: one full-shape macro step (256 lanes, 16 substeps)
    from the same state and generator seed, through the kernel and
    through the plain version: tokens equal, the rest within
    ``GEN_DECODE_TOL``.
18. ``genrl_continuous``: the main path as ``bench.py --mode genrl
    --continuous`` sets it up on an accelerator: the cohort engine for
    ``GEN_TARGET_S``, a warm-up of two lane-fills, then the continuous
    engine for ``GEN_TARGET_S`` under Poisson arrivals at twice the cohort's
    completion rate with the kernel's launch count zeroed just before
    (launches must equal 64 per dispatched macro step); 4 more macro steps
    of the same traffic under ``torch.profiler`` (``genrl_profile``, with
    the paged kernel's time a call); the lanes' lengths as one decode call
    hands them to the kernel, snapshotted once, and the kernel's time at
    that mix beside its byte bound (``paged_attn_engine_mix``); a
    drain (every reservation returned); then at temperature 0 a handful of
    prompts through both engines, token-identical with logp within
    ``GEN_IDENTITY_LOGP_TOL`` (``genrl_identity``).
19. ``segment_attn``: the three segment flash attention kernels (forward,
    dq, dk/dv) against their plain PyTorch version on the card: at the
    packed learn batch of ``bench.py`` (64 sequences of 2-128 tokens in
    rows of 256, 8 heads of 32), as strided views of one fused projection,
    at rows of 512 with 2-3 segments, at ragged S (333 and 19, the latter
    at head dim 8), with an all-pad row and in bfloat16; then at head dims
    64 and 128 (rows of 512 as strided views, an all-pad row, bfloat16),
    every layout through all three kernels with gradients, and a
    differentiable call at 136, past the widest build, must be refused
    naming the dq kernel.  Values within ``SEG_VALUE_TOL``, gradients
    within ``SEG_GRAD_REL_TOL`` of the largest gradient
    (``SEG_BF16_REL_TOL`` in bfloat16), exact zeros on pad, two runs
    bit-equal.  Each kernel's time by CUDA-graph replay and eagerly, the
    plain version's, both bounds, and SDPA with the dense mask as context,
    at the bench's batch and at the learn step's 64 rows of 512.
20. ``token_ppo_learn``: one full-width learn step (64 rows of 512,
    ``kl_cost`` on) from the same state and batch, through the kernels and
    through the dense packed mask, float32 with TF32 off
    (``TOKEN_PPO_TOL``), at 8 heads of 32 and again at 4 heads of 64.
21. ``genrl_train``: the training slice's main path, ``SequenceRLTrainer``
    at ``bench.py --mode genrl``'s width (V=1024, d=256, 8 heads, 4 layers,
    64 lanes, prompts of 2-128 tokens, 128 new tokens) with the packed
    learner in rows of 512 through the kernels: two warm-up rounds, then
    ``TRAIN_COHORT_S`` on the cohort engine with every kernel's launch count
    zeroed just before (each segment kernel = 4 x learn steps, PER sample =
    learn steps; warm rounds run under sync debug mode "error"); two rounds
    and three learn steps under ``torch.profiler`` (``genrl_train_profile``);
    ``TRAIN_CONTINUOUS_ROUNDS`` rounds on the continuous engine (the paged
    kernel launches too); the packed against the padded learn rate on
    ``bench.py``'s mixed-length batch (``token_ppo_learn_rate``); and two
    three-round runs from one seed, compared bit for bit
    (``genrl_train_repeat``; reported, not required).
22. ``flash_attn``: the three flash attention kernels (forward, dq, dk/dv)
    against their plain PyTorch version on the card, in 27 layouts: the
    learner's ``[8, 17, 16, 64]`` bf16 causal as views of one fused
    projection, ``[4, 256, 2, 64]``, the JAX package's compiled-check shapes
    (D = 128, causal and not, a ragged T = 200, bf16), cross lengths 24/56
    and 256/1024 (causal top-left aligned and not), D in {8, 16, 32}, a
    ``[1, 4096, 8, 64]`` bf16 context, float32 views whose rows sit 8 and 4
    bytes off 16 (the float32 micro-tile forward, dq and dk/dv's narrower
    copies), and in bf16 (the tensor-core forward, dq and dk/dv) D in {8,
    16, 32, 128}, T = 200, both cross lengths causal and not, and views
    whose rows sit 8, 4 and 2 bytes off 16.  o, lse, dq, dk and dv each
    within ``FLASH_*_TOL``, two runs bit-equal, causal row 0 equal to v[0];
    the autograd function bit-equal to the direct calls.  Each kernel's time
    by CUDA-graph replay at six shapes (``FLASH_TIMED``: the learner's in
    bf16 and in float32, T = 256 in both, T = 1024 float32, T = 4096 bf16)
    beside the plain version, SDPA, the bound and its share of the bf16
    operations bound.
23. ``transformer_learn``: the transformer-policy IMPALA learner at
    ``bench.py --mode sharded``'s width (d=1024, 8 layers, 16 heads, T=16,
    B=8, obs 64, 16 actions; 100.8M parameters): the flash model on the
    card against the host, then two ``ImpalaAgent``s from one seed, with
    ``use_pallas`` (flash attention and V-trace kernels) and without:
    gradients leaf by leaf and two learn steps in float32
    (``SHARD_LEARN_TOL``), and under ``bf16_params`` the dtype layout,
    float32 optimizer state, finite losses and ``SHARD_BF16_TOL``, each
    bf16 path also held against the float32 model on the same params.
24. ``transformer_train``: the slice's main path, bench.py's sharded learn
    step at dp=1 (bf16 params, flash and V-trace kernels) for
    ``SHARD_TRAIN_S`` on one synthetic trajectory, metrics read two steps
    behind, warm steps under sync debug mode "error", every kernel's launch
    count zeroed just before (8 launches of each flash kernel and 1 of
    V-trace per step); train frames/s, achieved TFLOP/s, peak memory, and
    three steps under ``torch.profiler`` (``transformer_train_profile``).
25. ``flash_train_step``: the JAX package's compiled flash train-step check
    at T = 256 (d=128, 2 heads, 2 layers, one Adam step), flash against the
    plain attention, in float32 (the micro-tile forward, dq and dk/dv; 2
    launches of each).

26. ``impala_trainer_device``: ``examples/train_impala_torch.py``'s
    ``main()`` with ``--env-backend jax --env-id SyntheticPixel-v0`` at
    ``ImpalaArguments``' defaults (LSTM ``AtariNet``, hidden 512, T=80, 8
    envs, 10 iterations a call, ``--use-pallas``, ``--logger-backend
    none``, the telemetry export every 2 s): 2 calls and a save; the
    trainer's restore of that checkpoint bit-equal to what was saved
    (agent state and ``env_frames``); a second ``main()`` with
    ``--resume`` to a budget of 4 calls (V-trace launches = calls x 10, a
    manifest under ``model_dir/resume``, a ``.prev`` with
    ``checkpoint_keep_last`` 1); then a run stopped by SIGTERM from a
    thread a few chunks after the trainer's guard is installed, whose
    checkpoint holds ``chunks_done`` < the budget, resumed for 2 calls
    more.  Frames/s and the JSONL exporter's last snapshot.
27. ``impala_trainer_host``: ``HostActorLearnerTrainer`` in threads mode at
    ``ImpalaArguments``' defaults (8 actors of one ``PixelRingEnv``
    84x84x4 each through ``SyncVectorView``, batch 8, 32 slots, LSTM,
    hidden 512, T=80, the V-trace kernel) for ``HOST_TRAIN_S``, with a
    5 s wall-clock ``CheckpointCadence``: V-trace launches = learn steps,
    finite losses, 0 skipped steps, 0 actor errors, at least one cadence
    save; env frames/s, learn steps/s, the rollout queue's ``stats``, the
    actors' and learner's phase times; then ``HOST_PROFILE_STEPS`` learn
    steps of a fresh run under ``torch.profiler``
    (``impala_trainer_host_profile``: the device's busy share).
28. ``learn_cartpole_host``: the reference's ``impala_cartpole`` recipe on
    the host plane (``tools/torch_learning_curves.py``'s
    ``cartpole_host``: 2 actors x 8 ``TensorCartPole`` envs on the CPU,
    T=16, batch 16, hidden 64, lr 2e-3, the learner on the card): must
    cross 400 within 400,000 frames; V-trace launches = learn steps.
29. ``dqn_resume``: ``OffPolicyTrainer`` for DQN+PER at ``dqn_per``'s
    configuration: ``DQN_RESUME_STEPS`` env steps and a save; a trainer
    with ``--resume`` restores the agent and the replay (plane,
    priorities, cursors) and counters bit-equal to what was saved, then
    runs ``DQN_RESUME_MORE`` more with the divergence tripwire at K = 3
    while K batches in a row carry NaN rewards: one trip back to the last
    good checkpoint, K skipped steps, finite parameters, PER launches =
    learn steps.

30. ``dqn_rainbow_learn``: one full-width learn step (QNet 128,128, batch
    512 from a 65,536 x 16 replay) for C51 and for noisy dueling DQN, each
    with ``use_pallas`` on and off and on the host, one fixed noise draw
    in every leg: indices equal, loss within ``RAINBOW_TOL["loss_rel"]``,
    each leaf's gradient within ``grad_leaf_rel`` of its largest, card
    against host within ``host_rel``; one launch of each PER kernel in the
    kernel leg, none in the plain one.
31. ``apex_train``: ``examples/train_apex_torch.py``'s ``main()`` at
    ``ApexArguments``' defaults with 3-step returns and ``--use-pallas``
    (4 actor threads x 16 ``TensorCartPole`` envs on the CPU, slabs of 288,
    a 2^20-transition replay, batch 512), SIGTERM after ``APEX_TRAIN_S``:
    both PER kernels' launches = learn steps, weights pushed, finite
    losses, 0 actor errors; a trainer with ``--resume`` restores what the
    guard saved bit-equal; env and learn steps/s, the actors' and the
    learner's phase ms.
32. ``r2d2_device``: ``DeviceR2D2Trainer`` at ``R2D2Arguments``' defaults
    (conv + LSTM, hidden 256, T=20, burn-in 8, batch 16, 2,048 sequences of
    84x84x4 frames) on 16 synthetic lanes, ``R2D2_DEVICE_ITERS``
    iterations, warm ones under sync debug mode "error": sample launches =
    learn steps; frames/s, learn steps/s; ``R2D2_PROFILE_ITERS`` iterations
    under ``torch.profiler`` (``r2d2_device_profile``).
33. ``learn_r2d2_recall_device``: the reference's ``r2d2_recall_device``
    recipe at seed 0: the LSTM arm must reach 0.6, its feed-forward control
    stay below 0.3; sample launches = both arms' learn steps.
34. ``r2d2_host``: ``examples/train_r2d2_torch.py``'s ``main()`` on
    ``RecallGym-v0`` (the port's numpy env, 2 actors x 4 envs) with
    ``--use-pallas`` for ``R2D2_HOST_S``: sample launches = learn steps, 0
    actor errors, and a trainer with ``--resume`` restoring the agent, the
    sequence replay with its stored cores, the frames and the max priority
    bit-equal.

35. ``shm_ring``: the process plane's ring.  Builds the port's C++ ring
    (``scalerl_torch/csrc/shm_ring.cpp``, g++; its seconds), then, on the
    process-IMPALA slot at ``ImpalaArguments``' defaults (one actor's
    81 x 84x84x4 uint8 frames, logits, LSTM core; ``RING_SLOTS`` slots),
    ``RING_PRODUCERS`` spawned producers into one consumer on both legs
    (native and Python queues): every payload intact, slots/s and the
    bytes moved; a producer under a seeded ``slot_tear`` plan: torn reads
    = the plan's tears, every intact slot delivered in order; and
    ``gather_batch`` of a learn step's 8 slots, natively and by the Python
    copy (GB/s).  Host work: it joins no kernel row.
36. ``parallel_dqn``: ``ParallelDQNTrainer`` at ``DQNArguments``' defaults
    (QNet 128,128, T=20, batch 32) with PER through both kernels, 4 spawned
    actors on ``TensorCartPole`` on the CPU through ``make_host_envs``,
    stopped after ``PDQN_TRAIN_S``: sample launches = update launches =
    learn steps > 0, finite losses, 0 torn reads, every child exited 0 and
    reported no CUDA, the segment unlinked; env and learn steps/s, episodes,
    the newest weight version a drained slab acted on.
37. ``process_impala``: ``ProcessActorLearnerTrainer`` at
    ``ImpalaArguments``' defaults (LSTM ``AtariNet``, hidden 512, T=80,
    batch 8, 32 slots) with 8 spawned actors of one ``PixelRingEnv``
    84x84x4 each, one torch thread a child, for ``PROC_TRAIN_S``, then a
    save: V-trace launches = learn steps > 0, finite losses, children
    without CUDA, the segment unlinked, and a trainer with ``--resume``
    restoring what was saved bit-equal; env frames/s, learn steps/s, and
    one learn step under ``torch.profiler`` for the device's busy share.
38. ``impact_learn``: one IMPACT learn step at ``ImpactArguments``'
    defaults (LSTM ``AtariNet``, hidden 512, T=80, B=8, 84x84x4) from a
    state whose target network is a perturbed copy of the learner, float32
    with TF32 off: the V-trace kernel against the plain V-trace on the card
    and against the plain step on the host (``LEARN_TOL``); V-trace
    launches 1 a surrogate update (``replay_times`` for one ``learn()``).
39. ``impact_train``: ``examples/train_impact_torch.py``'s ``main()`` with
    ``--use-pallas`` on ``PixelRing-v0`` (8 actors of 1 env, the thread
    plane's fleet) for ``IMPACT_TRAIN_S``, stopped by SIGTERM: V-trace
    launches = ``replay_times`` x learn calls > 0, finite losses, no
    skipped step, the circular buffer's stats, and a ``--resume`` restore
    bit-equal to what was saved; env frames/s and learn calls/s.
40. ``onpolicy_train``: A3C (LSTM ``AtariNet`` 256) and PPO (its own
    defaults, the lane shuffle injected on both sides) learn steps at
    T=20, B=8, card against host (``MODEL_TOL``, ``LEARN_TOL``); then
    ``examples/train_{a3c,ppo}_torch.py`` on ``TensorCartPole``
    (``--env-backend jax``) for ``ONPOLICY_EXAMPLE_STEPS`` env steps; then
    PPO inside ``DeviceActorLearnerLoop`` on ``TensorRecall`` (the
    ``ppo_recall_lstm`` recipe) for ``ONPOLICY_RECALL_CHUNKS`` chunks under
    sync debug mode "error"; no kernel launch in any (neither runs V-trace
    or PER).
41. ``continuous_learn``: SAC (one step) and TD3 (two: the delayed actor
    update skipped, then applied) at their defaults with PER from a
    65,536 x 16 replay, through both PER kernels and through their plain
    versions with the same noise injected: indices equal, loss and each
    gradient leaf within ``RAINBOW_TOL``, the card against the host.
42. ``continuous_train``: ``OffPolicyTrainer`` with SAC, then TD3, PER
    through both kernels, on ``PendulumVectorView`` (gymnasium's
    ``Pendulum-v1`` dynamics in numpy) for ``CONTINUOUS_TRAIN_STEPS`` env
    steps: sample launches = update launches = learn steps > 0, finite
    losses; env and learn steps/s.
43. ``serving_flush``: an ``InferenceServer`` holding the LSTM ``AtariNet``
    at ``ImpalaArguments``' defaults (hidden 512, 84x84x4, 6 actions,
    ``serve_max_batch`` 64), with its sync guard armed (it has the card to
    itself): flushes of 1, 3, 8, 17, 33 and 64 lanes (buckets 1-64), each
    cold then warm under ``steady_state_guard()``; logits and cores against
    the agent's own act on the card within ``SERVE_TOL``, actions equal to
    the argmax of the agent's logits plus the same injected Gumbel draws,
    one put and one get a flush; then each flush's host µs.
44. ``impala_serving``: ``HostActorLearnerTrainer(actor_mode="serving")``
    at ``impala_trainer_host``'s defaults for ``SERVE_TRAIN_S``: env frames/s
    and learn steps/s beside the thread plane's from the same run, the
    server's SLO (latency p50/p95/p99, batch occupancy, requests/s),
    flushes, sheds, copies and the staleness gauge; then one learn step of
    the same run under ``torch.profiler`` (``impala_serving_profile``: busy
    share, V-trace µs a call).  V-trace launches = learn steps > 0, no
    client fallback, finite losses, no actor error or restart, every
    admitted request answered or shed.
45. ``serving_traffic``: the twin of ``bench.py --mode traffic``: 3 replicas
    of the obs-64, 16-action, hidden-256 MLP policy behind
    ``ServingRouter``, 16 clients of open-loop Poisson traffic (and bursts)
    at 200 requests/s of 4 lanes for 10 s, every request traced into a
    ``TierLedger``: goodput under the 100 ms SLO, p50/p95/p99, the tier with
    the most attributed time; ``admitted == answered + shed + orphaned``
    exactly.
46. ``fleet_impala``: ``examples/train_fleet_impala_torch.py`` at the JAX
    example's width (MLP hidden 64, T=16, 8 lanes a batch, 4 spawned
    workers of 2 ``TensorCartPole`` lanes with numpy inference): one learn
    step on a fleet batch, the V-trace kernel against the plain V-trace on
    the card and the plain step on the host (``LEARN_TOL``); then the twin
    with ``use_pallas`` for ``FLEET_TRAIN_S`` from its first answer, and its
    drain: V-trace launches = learn calls, every issued task answered
    exactly once; env frames/s, learn steps/s, policy lag, the ``fleet.*``
    telemetry tree.
47. ``fleet_elastic``: ``tools/elastic_soak.py``'s scenario with the
    learner on the card: the same twin (4 one-worker gathers) under a
    seeded ``mass_kill`` wave, drawn only once the learner has stepped,
    with the autoscaler's floor rule backfilling through
    ``ClusterExecutor``: in-flight tasks requeued, lost 0, the workers back
    at 4, the autoscaler's decisions.
48. ``a3c_fleet``: one worker gradient applied card vs host
    (``LEARN_TOL``'s relative L2), then ``examples/train_a3c_fleet_torch.py``
    with 2 workers for ``A3C_FLEET_S``: applied gradients/s, env frames/s.
49. ``marl_dqn``: each agent's DQN learn step card vs host, then
    ``examples/train_marl_dqn_torch.py`` over 8 env processes of
    ``AsyncMultiAgentVecEnv`` for ``MARL_STEPS`` steps a lane: env
    steps/s.
50. ``fleet_dqn``: the same fleet episodes saved in the uniform replay on
    the card and on the host hold the same transitions, one DQN learn step
    card vs host (``LEARN_TOL``), then ``examples/train_fleet_dqn_torch.py``
    with 4 workers for ``FLEET_DQN_EPISODES`` episodes into the replay on
    the card: each episode answered once, env steps/s, learn steps/s.
    Phases 46-50 give every spawned child a deadline: a hung fleet fails
    its phase.
51. ``genrl_spec``: the continuous engine at ``bench.py``'s speculative A/B
    width (V=64, d=256, 4 layers, 8 heads, prompts of 32, 64 lanes, pages
    of 16, responses of 512, ``spec_k`` 24, n-gram 3), greedy, speculation
    off and on over the same prompts, rounds interleaved: identical tokens,
    behaviour logp within ``GEN_IDENTITY_LOGP_TOL``, paged kernel launches
    0 with speculation on and 8 x 4 a macro step with it off; acceptance
    rate, accepted tokens/s on and off, rollback pages, draft and verify
    seconds.
52. ``quantize_push``: ``runtime/quantize.py`` on the card against the
    host at the sequence-RL learner's width: int8 payloads and scales bit
    for bit, bf16 bit for bit, every dequantized int8 leaf within half its
    scale of the source; snapshot bytes per format, the card's time, and a
    quantized push through the param plane read back dequantized.
53. ``disagg_train``: the slice's main path, ``DisaggSequenceRLTrainer`` at
    ``genrl_train``'s width with the packed learner, 2 thread hosts running
    the cohort engine on the card and int8 snapshots, for
    ``DISAGG_TRAIN_S`` after two warm-up rounds with every launch count
    zeroed just before: segment launches a learn step equal to
    ``genrl_train``'s, PER sample launches = learn steps, every lease
    answered once, finite losses, no skipped step; rounds/s, learn
    tokens/s, wire sequences/s beside ``genrl_train``'s cohort rate,
    staleness and snapshot MB.  Then ``DISAGG_CONT_ROUNDS`` rounds with
    continuous-engine hosts (paged kernel launches > 0), and one learn step
    with ``bf16_params``, segment kernels against the dense mask (loss
    within ``DISAGG_BF16_LOSS_REL``; the optimizer state stays float32).
54. ``disagg_soak``: ``tools/disagg_soak.py``'s scenario with the learner's
    plane on the card: the trainer with 2 spawned scripted hosts, a
    seeded ``mass_kill`` wave once the first sequence was accepted and
    every host holds leases mid-decode, the autoscaler's floor rule
    backfilling through
    ``GenerationTierExecutor``: the wave requeued leases, lost 0, no
    duplicate reaches the trainer, every payload its lease's.
55. ``disagg_preempt``: ``tools/preempt_soak.py``'s scenario through the
    trainer: a seeded ``preempt`` draw trips the guard at the round
    boundary, ``save_resume`` writes the ledger, and a new trainer against
    the same ledger dir resumes at the same learn step under epoch 2, with
    the weights and the replay bit-equal, the lease cursor continuing,
    every lease answered once, and the guard's flight dump written.
    Phases 53-55 join every thread and child with a deadline.
56. ``impala_anakin`` (run after ``impala_lstm_fused``): ``run_anakin``, N
    chunks as one CUDA-graph replay, at ``impala_fused``'s width and at
    ImpalaArguments' defaults, 2 chunks each: from one state, carry and
    generator state, 2 ``run()`` chunks and the captured superchunk under
    deterministic algorithms are bit-equal (params, carry, metric stream,
    generator); the next replay, timed, draws different actions with the
    generator moved on; V-trace launches captured into the graph = 2 x 5,
    and seen by the profiler in a replay (1 to 2 x 5: CUPTI can lose a
    record); warm replays under sync debug mode "error"; env frames/s of
    both, a profiled replay's busy share (its kernel time over the span of
    its kernels), kernels a replay, peak memory.
57. ``mesh_learn`` (run after ``flash_train_step``): a one-rank nccl
    process group; ``enable_mesh`` at dp = mp = 1 on the transformer
    learner at the sharded width (``SHARD_LEARN_TOL``, flash launches equal
    to the unmeshed step's), the IMPALA step and the DQN step on a PER
    batch (``LEARN_TOL``, V-trace and PER launches counted), each against
    the same agent unmeshed; the group is destroyed at the phase's end.
58. ``mesh_replay`` (run after ``r2d2_host``): a one-rank nccl group; the
    sharded replays of ``data/sharded_replay.py`` at dp = 1, each against
    its unsharded buffer fed the same: the transition buffer on
    ``apex_train``'s plane (3,640 rows x 288 lanes = 1,048,320
    transitions, batch 512, ``use_pallas``) and the sequence ring on
    ``r2d2_device``'s (2,048 sequences of 21 x 84x84x4 uint8, batch 16):
    the state bit-equal after a bulk fill and inserts through both, a
    sample from the same uniforms with exact indices and rows and weights
    within ``MESH_WEIGHT_TOL``, a write-back bit-equal to the plain
    version (the transitions' through the update kernel); one sample call
    (two kernel launches) a sample, one update launch a transition
    write-back (none for sequences, a plain scatter as in JAX); µs a
    sample and a write-back of both buffers.
59. ``mesh_loops``: a one-rank nccl group; ``DeviceActorLearnerLoop(mesh=)``
    at ``impala_fused``'s width and the mesh-fused
    ``DeviceR2D2Trainer(mesh=)`` at ``r2d2_device``'s settings
    (``MESH_R2D2_ITERS`` iterations), each against its unmeshed twin from
    the same state and generator under deterministic algorithms:
    bit-equal (or, where an op without a deterministic version or the
    keep-empty write-back makes a difference, named, within
    ``LEARN_TOL``), warm chunks and iterations under sync debug mode
    "error", V-trace 5 launches a chunk, sample launches = learn steps;
    then ``examples/train_apex_torch.py`` with ``--mesh-shape dp=1`` at
    ``apex_train``'s settings for ``MESH_APEX_S`` on its
    ``ShardedPrioritizedReplay``, the sample and update kernels launched
    once each a learn step; frames/s of each beside its twin's.
60. ``moe_impala`` (run after ``mesh_loops``): ``policy_arch="moe"``
    (``MoEPolicyNet`` at the JAX defaults: d_model 128, 8 experts, hidden
    256, capacity factor 2.0) on ``impala_fused``'s geometry: the
    index-form MoE layer on the card against its dense one-hot plain twin
    at the learner's 10,752 tokens (out, aux, dispatch_frac, gradients;
    ``MOE_LAYER_TOL``) and one learn step with each form (``LEARN_TOL``);
    the fused loop, ``MAIN_CHUNKS`` warm chunks (V-trace 5 launches a
    chunk), a profiled chunk's device ms, env frames/s beside
    ``impala_fused``'s AtariNet rate, the tokens dropped a learn step; one
    meshed learn step at dp = mp = 1 on a one-rank nccl group against the
    unmeshed step under deterministic algorithms, bit for bit.
61. ``parallel_families``: a one-rank nccl group made by the port's
    ``initialize_multihost``; ring attention (T4k bf16 and T1k float32,
    causal), the sequence-parallel transformer at the transformer
    learner's width, the heterogeneous pipeline (M = 4) and expert
    parallelism (10,752 tokens), each at extent 1 against its plain twin,
    outputs and gradients (``FAMILY_TOL``, the CPU tests'), with each
    path's ms beside its twin's; every collective and point-to-point call
    is counted and must stay 0 (at extent 1 none runs; the multi-rank
    paths are held on 4 gloo ranks on the CPU).

62-63. ``shard_compute`` (the learn step on shards, PR 24) and then
    ``genrl_on_shards`` on its 2 gloo ranks of cuda:0, which wait for it
    (no second start-up): the paged kernel at a rank's 4 of 8 heads
    (``[256, 1, 4, 32]`` against ``[6145, 16, 4, 32]``) against its plain
    version (``PAGED_TOL``) and timed beside its bound; the continuous
    engine at the generation width and ``SequenceRLTrainer`` at the
    training width (continuous engine) at mp = 2 against one rank here:
    ``GS_MACROS`` macro steps of 256 lanes at temperature 0 (tokens equal,
    logp within ``GEN_IDENTITY_LOGP_TOL``, the ranks' logits bit-equal,
    paged launches a rank = 64 a macro step as on one rank, pool and param
    bytes a rank beside one rank's) and ``GS_ROUNDS`` rounds (round 1's
    tokens equal and its loss within ``SC_TOL``'s ``loss_rel``, segment 4
    and PER sample 1 a learn step a rank, rounds/s and peak memory a
    rank).
64-65. ``serving_on_shards`` and ``disagg_on_shards`` on the same ranks,
    each after its go file.  The serving trainer with its learner at mp =
    2 (``RLArguments``' transformer: d 128, 2 layers, 2 of 4 heads a rank,
    the flash kernels, on the port's CartPole) for ``SS_LEARN_STEPS``
    learn steps: a rank serves half of each mp leaf and the live shards of
    the last push; a fixed batch's logits bit-equal across the ranks and
    within ``SS_TOL`` of a one-rank server at the gathered weights; the
    flash forward 2 a flush on the flush thread and 2 a learn step on the
    learner's, all on 2 heads.  ``DisaggSequenceRLTrainer`` at the
    training width at mp = 2, rank 0 owning the fleet (2 continuous hosts
    of 32 lanes, int8 snapshots), ``GS_ROUNDS`` rounds from cold: round
    1's loss within ``SC_TOL``'s ``loss_rel`` of one rank's learn step on
    the same rows, the ranks' metrics bit-equal, segment 4 and PER sample
    1 a learn step a rank, paged launches on rank 0's hosts alone, lost =
    0.  Rates and peak memory beside ``impala_serving``'s and
    ``disagg_train``'s.

Host-side phases use no gymnasium and no tensorboardX (the card's machine
may have neither): their envs are the port's numpy and tensor envs behind
``envs/gym_env.py``'s views, their logger ``none``.

Then the seconds of each phase (``phase_seconds``), a line with the card, a
``{"kernels": [...]}`` line (ten kernels; the
three flash kernels at the learner's bf16 shape, through the tensor cores),
and last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
VTRACE_OPS_PER_ELEMENT = 16  # exp, 3 clips, delta (4), recursion (3), vs (1), pg (4)
VTRACE_TOL = 1e-5
MODEL_TOL = 1e-4

MAIN_T, MAIN_B, MAIN_ITERS, MAIN_CHUNKS = 20, 512, 5, 4  # 10 chunks before phases 51-55 joined the script

# Prioritized replay (phases 7-9): the DQN slice's configuration
PER_BLOCK = 1024
PER_NUM_ENVS, PER_CAPACITY, PER_BATCH, PER_N_STEP = 16, 65536, 512, 3
# float32 scans in different orders round differently: an index may move
# to a neighbour only where its target lies this close (relative to the
# block's sum) to the boundary between them
PER_BRACKET_REL = 1e-6
# the sample kernels sum the plane's blocks and scan the block sums in their
# own order, PyTorch in its own: two float32 prefixes of one total, each a
# few dozen roundings of 2^-24 (relative to the total) from exact.  So a
# target may change block, or its residual move, only this close (relative
# to the plane's total) to a block boundary
PER_PREFIX_REL = 1e-5
PER_SUMS_RTOL = 1e-5
# kernels vs plain versions in one learn step on the card: with equal
# indices the batch, the learn step and the priorities are the same
# operations on the same inputs, so only cuBLAS's sum order could differ
DQN_LEARN_TOL = 1e-6


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gpu_time_ms(fn, launches: int, reps: int = 5, stream=None) -> float:
    """Median device time of one ``fn()``: ``launches`` calls captured in a
    CUDA graph, replayed between two events, so host overhead drops out.
    ``stream``: the stream to capture on.  A backward pass runs on the stream
    its forward ran on, so an ``autograd.grad`` of a retained graph is
    captured on the stream that made the forward."""
    import torch

    stream = stream or torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(launches):
            fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def eager_time_ms(fn, launches: int, reps: int = 5) -> float:
    """Median time of one eager ``fn()`` from the host, as the main path
    calls it: events around ``launches`` back-to-back calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def set_tf32(enabled: bool) -> None:
    import torch

    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled


# ---------------------------------------------------------------------------
def phase_device(report: dict) -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    report["card"] = smi.stdout.strip().splitlines()[0]
    print(report["card"], flush=True)
    emit("device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         card=report["card"], torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)))


def _kernel_name(mangled: str):
    """An attention kernel instantiation's readable name from its mangled
    one (``tc::flash_bwd_dq_kernel<64>``, ``mt::seg_bwd_dkv_kernel<float,
    128>``, ``paged_decode_kernel<bf16, 32>``), or None for another
    function."""
    import re

    m = re.search(r"(?:(\d)(tc|mt))?\d+((?:flash|seg|paged)_\w+?_kernel)I(\w*?)EEv", mangled)
    if m is None:
        return None
    targs = m.group(4)
    dtype = (["float"] if targs.startswith("f")
             else ["bf16"] if targs.startswith("13__nv_bfloat16") else [])
    args = dtype + re.findall(r"Li(\d+)E", targs)
    return f"{m.group(2) + '::' if m.group(2) else ''}{m.group(3)}<{', '.join(args)}>"


def _per_kernel_name(mangled: str):
    """A PER kernel's name from its mangled one, or None for another function."""
    import re

    m = re.search(r"\d(per_(?:block_sums|search|sample|update)_kernel)", mangled)
    return m and m.group(1)


def _vtrace_kernel_name(mangled: str):
    """The V-trace kernel's name from its mangled one (``vtrace_kernel<32,
    4>``; a kernel that is no template, plain ``vtrace_kernel``), or None."""
    import re

    m = re.search(r"\d(vtrace_kernel)(?:I((?:Li\d+E)+)E)?", mangled)
    if m is None:
        return None
    args = re.findall(r"Li(\d+)E", m.group(2) or "")
    return f"vtrace_kernel<{', '.join(args)}>" if args else "vtrace_kernel"


def _registers(log: str, namer=_kernel_name) -> dict:
    """ptxas's registers per kernel (instantiation), by ``namer``: by
    default the attention kernels' ``_kernel_name``."""
    import re

    out, name = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = namer(ln.split("Function properties for", 1)[1].strip())
        elif name and "Used" in ln and "registers" in ln:
            out[name] = int(re.search(r"Used (\d+) registers", ln).group(1))
            name = None
    return out


def _spills(log: str) -> list:
    """Each ptxas line that reports a spill, under the function it names
    just before it."""
    out, function = [], "?"
    for ln in log.splitlines():
        if "Function properties for" in ln:
            function = ln.split("Function properties for", 1)[1].strip()
        elif "spill" in ln and " 0 bytes spill stores, 0 bytes spill loads" not in ln:
            out.append(f"{function}: {ln.strip()}")
    return out


def phase_build(report: dict) -> None:
    """Start one ``nvcc`` for each kernel source, all together, and wait for
    V-trace's, which the next phases launch; the others compile while those
    phases run (the PER kernels' first launch waits for theirs), and
    ``phase_kernels_built``, before the first phase that launches an
    attention kernel, waits for the rest and reads every compile's report."""
    from scalerl_torch.utils import cuda_build

    # the kernels must come from the checkout this script sits in
    if cuda_build.PACKAGE_DIR.parent != Path(__file__).resolve().parent:
        raise RuntimeError(f"scalerl_torch found at {cuda_build.PACKAGE_DIR}, not beside this script")
    report["build_t0"] = time.perf_counter()
    cuda_build.start(cuda_build.KERNEL_SOURCES)
    cuda_build.build(["vtrace"])


def phase_kernels_built(report: dict) -> None:
    from scalerl_torch.utils import cuda_build

    t0 = time.perf_counter()
    cuda_build.build(cuda_build.KERNEL_SOURCES)
    waited = time.perf_counter() - t0
    seconds = time.perf_counter() - report["build_t0"]
    logs = cuda_build.compile_logs
    ptxas = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for name, log in logs.items()
    }
    spills = [f"{name}: {line}" for name, log in logs.items() for line in _spills(log)]
    emit("build", seconds=seconds, waited_s=waited, sources=list(cuda_build.KERNEL_SOURCES),
         ptxas=ptxas,
         spill_free=not spills, flash_registers=_registers(logs.get("flash_attention", "")),
         segment_registers=_registers(logs.get("segment_attention", "")),
         paged_registers=_registers(logs.get("paged_attention", "")),
         per_registers=_registers(logs.get("per", ""), _per_kernel_name),
         vtrace_registers=_registers(logs.get("vtrace", ""), _vtrace_kernel_name))
    if spills:
        raise AssertionError(f"ptxas reports local-memory spills: {spills}")


def _vtrace_inputs(T, B, seed, device, nan_share=0.0):
    import torch

    g = torch.Generator().manual_seed(seed)
    inp = dict(
        log_rhos=torch.randn(T, B, generator=g) * 0.4,
        discounts=0.99 * (torch.rand(T, B, generator=g) > 0.1).float(),
        rewards=torch.randn(T, B, generator=g),
        values=torch.randn(T, B, generator=g),
        bootstrap_value=torch.randn(B, generator=g),
    )
    if nan_share:
        inp["log_rhos"][torch.rand(T, B, generator=g) < nan_share] = float("nan")
    return {k: v.to(device) for k, v in inp.items()}


# [T, B] cases of the vtrace phase: the fused loop's main shape, ragged and
# odd shapes (B not a multiple of 4, T not a multiple of the kernel's 32-row
# chunks), ImpalaArguments' defaults [80, 8], the transformer learner's
# [16, 8] and a bandwidth probe [80, 4096]
VTRACE_CASES = [(MAIN_T, MAIN_B), (1, 1), (37, 5), (20, 1000), (80, 8), (16, 8), (70, 1001),
                (80, 4096)]
# planes with NaN log-rhos (about 2% of them): NaN must stay at the plain version's positions
VTRACE_NAN_CASES = [(MAIN_T, MAIN_B), (70, 1001)]
# shapes timed, by what calls the kernel there
VTRACE_TIMED = {"fused_loop": (MAIN_T, MAIN_B), "impala_defaults": (80, 8),
                "transformer_learner": (16, 8), "bandwidth_probe": (80, 4096)}


def _bits_equal(a, b) -> bool:
    import torch

    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _vtrace_bound(inp: dict) -> dict:
    T, B = inp["log_rhos"].shape
    moved = sum(x.numel() * x.element_size() for x in inp.values()) + 2 * T * B * 4
    bytes_ms = moved / H100_BYTES_PER_S * 1e3
    ops_ms = VTRACE_OPS_PER_ELEMENT * T * B / H100_F32_OPS_PER_S * 1e3
    return {"bytes_moved": moved, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_vtrace(report: dict) -> None:
    import torch

    from scalerl_torch.ops.cuda_vtrace import vtrace_from_importance_weights_kernel
    from scalerl_torch.ops.vtrace import vtrace_scan

    set_tf32(False)
    clips = {
        "default": {},
        "rho2_c1.5": {"clip_rho_threshold": 2.0, "clip_c_threshold": 1.5},
        "no_rho_clip": {"clip_rho_threshold": None, "clip_pg_rho_threshold": None},
    }
    cases = []
    worst = 0.0
    planes = [(T, B, 0.0) for T, B in VTRACE_CASES] + [(T, B, 0.02) for T, B in VTRACE_NAN_CASES]
    for T, B, nan_share in planes:
        inp = _vtrace_inputs(T, B, seed=T * 1000 + B, device="cuda", nan_share=nan_share)
        for clip_name, clip in clips.items():
            got = vtrace_from_importance_weights_kernel(**inp, **clip)
            again = vtrace_from_importance_weights_kernel(**inp, **clip)
            want = vtrace_scan(**inp, **clip)
            repeat_equal = all(_bits_equal(x, y) for x, y in zip(got, again))
            nan_equal = all(torch.equal(x.isnan(), y.isnan()) for x, y in zip(got, want))
            err = max(((x - y)[~y.isnan()].abs().max().item() for x, y in zip(got, want)),
                      default=0.0)
            cases.append({"shape": [T, B], "clips": clip_name, "nan_share": nan_share,
                          "max_abs_err": err, "repeat_bit_equal": repeat_equal,
                          "nan_positions_equal": nan_equal,
                          "nans": int(got.vs.isnan().sum().item())})
            worst = max(worst, err)
            if not (err <= VTRACE_TOL and repeat_equal and nan_equal):
                raise AssertionError(f"vtrace {T}x{B} {clip_name} nan {nan_share}: max abs err "
                                     f"{err}, repeat bit-equal {repeat_equal}, NaN positions "
                                     f"equal {nan_equal}")

    one = torch.zeros(1, device="cuda")
    floor_ms = gpu_time_ms(lambda: one.add_(1.0), 200)
    timed = {}
    for name, (T, B) in VTRACE_TIMED.items():
        inp = _vtrace_inputs(T, B, seed=0, device="cuda")
        kernel = lambda: vtrace_from_importance_weights_kernel(**inp)  # noqa: E731
        timed[name] = {"shape": [T, B], "ms": gpu_time_ms(kernel, 200),
                       "eager_ms": eager_time_ms(kernel, 200), **_vtrace_bound(inp)}
    inp = _vtrace_inputs(MAIN_T, MAIN_B, seed=0, device="cuda")
    plain = lambda: vtrace_scan(**inp)  # noqa: E731
    main = timed["fused_loop"]
    timing = dict(ms=main["ms"], plain_ms=gpu_time_ms(plain, 20), eager_ms=main["eager_ms"],
                  plain_eager_ms=eager_time_ms(plain, 20), bytes_moved=main["bytes_moved"],
                  bound_ms=main["bound_ms"], bound_by=main["bound_by"])
    report["vtrace"] = {"max_abs_err": worst, **timing}
    emit("vtrace", tol=VTRACE_TOL, max_abs_err=worst, cases=cases, shape=[MAIN_T, MAIN_B],
         timed=timed, replay_floor_ms=floor_ms, card=report["card"], **timing)


def phase_model(report: dict) -> None:
    import torch

    from scalerl_torch.models.atari import AtariNet

    set_tf32(False)
    A, T, B = 6, 2, 8
    gpu = AtariNet(num_actions=A, use_lstm=False, hidden_size=512, device="cuda",
                   generator=torch.Generator().manual_seed(1))
    cpu = AtariNet(num_actions=A, use_lstm=False, hidden_size=512, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    g = torch.Generator().manual_seed(2)
    inputs = (
        torch.randint(0, 256, (T, B, 84, 84, 4), generator=g, dtype=torch.uint8),
        torch.randint(0, A, (T, B), generator=g),
        torch.randn(T, B, generator=g) * 2,
        torch.rand(T, B, generator=g) < 0.3,
    )
    with torch.no_grad():
        want, _ = cpu(*inputs)
        got, _ = gpu(*(x.cuda() for x in inputs))
    err = max(
        (got.policy_logits.cpu() - want.policy_logits).abs().max().item(),
        (got.baseline.cpu() - want.baseline).abs().max().item(),
    )
    emit("model", tol=MODEL_TOL, max_abs_err=err, shape=[T, B, 84, 84, 4], hidden=512,
         tf32=False)
    if not err <= MODEL_TOL:
        raise AssertionError(f"AtariNet card vs host: max abs err {err}")


LEARN_TOL = {
    # card, kernel V-trace vs card, plain V-trace: the same kernels apart
    # from V-trace, which agrees bit for bit, so only the order of cuDNN's
    # weight-gradient sums may differ
    "kernel_vs_plain_update_abs": 1e-6,
    # card vs host: the forward agrees to ~1e-7, but a pre-activation within
    # that of 0 opens a ReLU on one side only and moves its gradient row by
    # one term of the sum over T*B (6.5e-4 relative L2 measured on an H100)
    "card_vs_host_update_rel_l2": 1e-2,
    "loss_rel": 1e-5,
    "grad_norm_rel": 1e-4,
}


def phase_impala_learn(report: dict) -> None:
    """One learn step from the same weights and trajectory, at full width
    and a small batch: kernel V-trace on the card against plain V-trace on
    the card, and against the plain step on the host."""
    import torch

    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.config import ImpalaArguments
    from scalerl_torch.data.trajectory import Trajectory

    set_tf32(False)
    T, B, A = 6, 4, 6
    g = torch.Generator().manual_seed(3)
    fields = dict(
        obs=torch.randint(0, 256, (T + 1, B, 84, 84, 4), generator=g, dtype=torch.uint8),
        action=torch.randint(0, A, (T + 1, B), generator=g),
        reward=torch.randn(T + 1, B, generator=g),
        done=torch.rand(T + 1, B, generator=g) < 0.2,
        logits=torch.randn(T + 1, B, A, generator=g),
    )
    fields["logits"][-1] = 0.0
    out = {}
    for name, device, use_pallas in (("host", "cpu", False), ("plain", "cuda", False),
                                     ("kernel", "cuda", True)):
        args = ImpalaArguments(use_lstm=False, hidden_size=512, rollout_length=T,
                               batch_size=B, max_timesteps=0, use_pallas=use_pallas)
        agent = ImpalaAgent(args, (84, 84, 4), A, device=device)
        before = {k: v.cpu() for k, v in agent.get_weights().items()}
        traj = Trajectory(**{k: v.to(device) for k, v in fields.items()})
        metrics = agent.learn(traj)
        update = {k: v.cpu() - before[k] for k, v in agent.get_weights().items()}
        out[name] = (metrics, torch.cat([u.reshape(-1) for u in update.values()]))

    def rel(a: float, b: float) -> float:
        return abs(a - b) / max(abs(b), 1.0)

    (m_host, u_host), (_, u_plain), (m_kern, u_kern) = out["host"], out["plain"], out["kernel"]
    errs = {
        "kernel_vs_plain_update_abs": (u_kern - u_plain).abs().max().item(),
        "card_vs_host_update_rel_l2": ((u_kern - u_host).norm() / u_host.norm()).item(),
        "loss_rel": rel(m_kern["total_loss"], m_host["total_loss"]),
        "grad_norm_rel": rel(m_kern["grad_norm"], m_host["grad_norm"]),
    }
    emit("impala_learn", **errs, card_vs_host_update_max_abs_err=(u_kern - u_host).abs().max().item(),
         update_max_abs=u_host.abs().max().item(), total_loss=m_kern["total_loss"],
         grad_norm=m_kern["grad_norm"], grad_norm_host=m_host["grad_norm"], tf32=False,
         tol=LEARN_TOL)
    bad = {k: v for k, v in errs.items() if not v <= LEARN_TOL[k]}
    if bad:
        raise AssertionError(f"learn step off tolerance: {bad}")


def phase_impala_fused(report: dict) -> None:
    import torch

    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.config import ImpalaArguments
    from scalerl_torch.envs.tensor_envs import SyntheticPixelEnv
    from scalerl_torch.ops import cuda_vtrace
    from scalerl_torch.runtime.device_loop import DeviceActorLearnerLoop

    set_tf32(True)  # PyTorch's defaults for cuDNN; the torso is bf16 anyway
    torch.backends.cuda.matmul.allow_tf32 = False
    args = ImpalaArguments(
        use_lstm=False, hidden_size=512, rollout_length=MAIN_T, batch_size=MAIN_B,
        max_timesteps=0, compute_dtype="bfloat16", use_pallas=True,
    )
    env = SyntheticPixelEnv(num_envs=MAIN_B)
    agent = ImpalaAgent(args, obs_shape=env.observation_shape, num_actions=env.num_actions)
    loop = DeviceActorLearnerLoop(agent.model, env, agent.make_learn_fn(),
                                  unroll_length=MAIN_T, iters_per_call=MAIN_ITERS)
    carry = loop.init_carry()
    t0 = time.perf_counter()
    state, carry, _ = loop.run(agent.state, carry, num_calls=1)  # warm-up chunk
    warmup_s = time.perf_counter() - t0

    chunk_metrics = []
    torch.cuda.reset_peak_memory_stats()
    cuda_vtrace.launches = 0
    t0 = time.perf_counter()
    state, carry, last = loop.run(state, carry, num_calls=MAIN_CHUNKS,
                                  on_metrics=lambda i, m: chunk_metrics.append(m))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = cuda_vtrace.launches
    report["launches"] = {"vtrace": launches}
    report["impala_fused_rate"] = MAIN_CHUNKS * MAIN_ITERS * MAIN_T * MAIN_B / seconds

    frames = MAIN_CHUNKS * MAIN_ITERS * MAIN_T * MAIN_B
    emit("impala_fused", B=MAIN_B, T=MAIN_T, iters_per_call=MAIN_ITERS,
         chunks=MAIN_CHUNKS, frames=frames, seconds=seconds,
         env_frames_per_s=frames / seconds, warmup_chunk_s=warmup_s,
         vtrace_launches=launches, learner_steps=int(state.step),
         env_frames_total=int(state.env_frames),
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
         sync_debug_mode="error", last_chunk=last, card=report["card"])
    if launches != MAIN_CHUNKS * MAIN_ITERS:
        raise AssertionError(f"vtrace launches {launches} != {MAIN_CHUNKS * MAIN_ITERS}")
    if len(chunk_metrics) != MAIN_CHUNKS:
        raise AssertionError(f"{len(chunk_metrics)} chunk metrics, want {MAIN_CHUNKS}")
    for i, m in enumerate(chunk_metrics):
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad or m["skipped_steps"] != 0.0:
            raise AssertionError(f"chunk {i}: non-finite {bad}, skipped {m['skipped_steps']}")
    report["ff_profile"] = profile_chunks(loop, state, carry, seconds / MAIN_CHUNKS,
                                          report["card"])


SYNTHETIC_FRAMES = 40_000  # 100,000 before phases 51-55 joined the script

# ImpalaArguments' own defaults (T=80, B=8, conv + 2-layer LSTM, hidden 512,
# float32, the lr schedule over 30M frames), as the fused loop runs them
# 3 chunks (4 before serving_on_shards, 10 before phases 51-55)
LSTM_ITERS, LSTM_CHUNKS = 5, 3


def _default_args(**kw):
    from scalerl_torch.config import ImpalaArguments

    args = ImpalaArguments(use_pallas=True, **kw)
    if not (args.use_lstm and args.hidden_size == 512 and args.compute_dtype == "float32"
            and (args.rollout_length, args.batch_size) == (80, 8)):
        raise AssertionError(f"ImpalaArguments' defaults moved: {args}")
    return args


def _impala_loss_grads(params, model, traj, args, vtrace_impl: str):
    """The IMPALA loss and its gradients leaf by leaf."""
    import torch

    from scalerl_torch.agents.impala import impala_loss

    params = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss, _ = impala_loss(params, model, traj, discounting=args.discounting,
                          baseline_cost=args.baseline_cost, entropy_cost=args.entropy_cost,
                          vtrace_impl=vtrace_impl)
    return loss, dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


def phase_impala_lstm_learn(report: dict) -> None:
    """One learn step at ImpalaArguments' defaults (AtariNet with its LSTM
    core, hidden 512, T=80, B=8) on a trajectory the fused loop collects
    from the synthetic 84x84x4 env with a carried core state, float32 with
    TF32 off: the model on the card against the host, then the V-trace
    kernel against the plain version (the loss, the gradients leaf by leaf,
    and one learn step each, which launches the kernel once)."""
    import torch
    from torch.func import functional_call

    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.envs.tensor_envs import SyntheticPixelEnv
    from scalerl_torch.models.atari import AtariNet
    from scalerl_torch.ops import cuda_vtrace
    from scalerl_torch.runtime.device_loop import DeviceActorLearnerLoop

    set_tf32(False)
    args = _default_args()
    T, B = args.rollout_length, args.batch_size
    env = SyntheticPixelEnv(num_envs=B)
    A = env.num_actions
    agent = ImpalaAgent(args, env.observation_shape, A)
    loop = DeviceActorLearnerLoop(agent.model, env, agent.make_learn_fn(), T, iters_per_call=1,
                                  seed=4)
    carry, _ = loop._unroll(agent.state.params, loop.init_carry())
    _, traj = loop._unroll(agent.state.params, carry)  # enters with a non-zero carry
    params = agent.state.params

    host = AtariNet(num_actions=A, use_lstm=True, hidden_size=args.hidden_size, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in params.items()})
    inputs = (traj.obs, traj.action, traj.reward, traj.done, traj.core_state)
    with torch.no_grad():
        got, got_core = functional_call(agent.model, params, inputs)
        want, want_core = host(*(x.cpu() for x in inputs[:4]),
                               tuple((c.cpu(), h.cpu()) for c, h in traj.core_state))
    pairs = [(got.policy_logits, want.policy_logits), (got.baseline, want.baseline)]
    pairs += [(g, w) for gl, wl in zip(got_core, want_core) for g, w in zip(gl, wl)]
    model_err = max((g.cpu() - w).abs().max().item() for g, w in pairs)

    loss_k, grads_k = _impala_loss_grads(params, agent.model, traj, args, "kernel")
    loss_p, grads_p = _impala_loss_grads(params, agent.model, traj, args, "scan")
    leaf_rel = _leaf_rel(grads_k, grads_p)
    steps = {}
    for name, use_pallas in (("kernel", True), ("plain", False)):
        learn = ImpalaAgent(dataclasses.replace(args, use_pallas=use_pallas),
                            env.observation_shape, A).make_learn_fn()
        cuda_vtrace.launches = 0
        state, metrics = learn(agent.state, traj)
        torch.cuda.synchronize()
        steps[name] = ({k: float(v) for k, v in metrics.items()}, cuda_vtrace.launches,
                       torch.cat([(state.params[k] - v).reshape(-1) for k, v in params.items()]))
    (m_k, launches_k, upd_k), (m_p, launches_p, upd_p) = steps["kernel"], steps["plain"]

    def rel(a: float, b: float) -> float:
        return abs(a - b) / max(abs(b), 1.0)

    errs = {"model_max_abs_err": model_err,
            "loss_rel": max(rel(loss_k.item(), loss_p.item()),
                            rel(m_k["total_loss"], m_p["total_loss"])),
            "grad_leaf_rel": max(leaf_rel.values()),
            "grad_norm_rel": rel(m_k["grad_norm"], m_p["grad_norm"])}
    tol = {"model_max_abs_err": MODEL_TOL, "loss_rel": LEARN_TOL["loss_rel"],
           "grad_leaf_rel": 1e-4, "grad_norm_rel": LEARN_TOL["grad_norm_rel"]}
    emit("impala_lstm_learn", T=T, B=B, hidden=args.hidden_size, lstm_layers=len(agent.model.core),
         core_size=agent.model.core_size, params=sum(v.numel() for v in params.values()),
         **errs, tol=tol, worst_grad_leaf=max(leaf_rel, key=leaf_rel.get),
         update_max_abs_diff=(upd_k - upd_p).abs().max().item(),
         update_max_abs=upd_p.abs().max().item(), total_loss=m_k["total_loss"],
         grad_norm=m_k["grad_norm"], skipped_steps=m_k["skipped_steps"],
         vtrace_launches_kernel=launches_k, vtrace_launches_plain=launches_p,
         dones_inside=int(traj.done[1:-1].sum()), tf32=False, card=report["card"])
    bad = {k: v for k, v in errs.items() if not v <= tol[k]}
    if bad or (launches_k, launches_p) != (1, 0) or m_k["skipped_steps"] != 0.0:
        raise AssertionError(f"LSTM learn step: {bad}, launches {launches_k}/{launches_p}, "
                             f"skipped {m_k['skipped_steps']}")


def phase_impala_lstm_fused(report: dict) -> None:
    """The fused loop at ImpalaArguments' defaults (conv + 2-layer LSTM,
    T=80, B=8, V-trace through the kernel) on the synthetic 84x84x4 env: one
    warm-up chunk, then ``LSTM_CHUNKS`` chunks of ``LSTM_ITERS`` iterations
    under sync debug mode "error", then a profile of one iteration's unroll
    and learn step (``impala_lstm_profile``) beside the feed-forward
    chunk's (``impala_lstm_vs_ff``)."""
    import torch

    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.envs.tensor_envs import SyntheticPixelEnv
    from scalerl_torch.ops import cuda_vtrace
    from scalerl_torch.runtime.device_loop import DeviceActorLearnerLoop

    set_tf32(True)  # PyTorch's defaults: TF32 convs, float32 matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _default_args()
    T, B = args.rollout_length, args.batch_size
    env = SyntheticPixelEnv(num_envs=B)
    agent = ImpalaAgent(args, env.observation_shape, env.num_actions)
    loop = DeviceActorLearnerLoop(agent.model, env, agent.make_learn_fn(), T,
                                  iters_per_call=LSTM_ITERS)
    t0 = time.perf_counter()
    state, carry, _ = loop.run(agent.state, loop.init_carry(), num_calls=1)  # warm-up chunk
    warmup_s = time.perf_counter() - t0
    chunk_metrics = []
    cuda_vtrace.launches = 0
    t0 = time.perf_counter()
    state, carry, last = loop.run(state, carry, num_calls=LSTM_CHUNKS,
                                  on_metrics=lambda i, m: chunk_metrics.append(m))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = cuda_vtrace.launches
    frames = LSTM_CHUNKS * LSTM_ITERS * T * B
    emit("impala_lstm_fused", B=B, T=T, iters_per_call=LSTM_ITERS, chunks=LSTM_CHUNKS,
         frames=frames, seconds=seconds, chunk_s=seconds / LSTM_CHUNKS,
         env_frames_per_s=frames / seconds, warmup_chunk_s=warmup_s, vtrace_launches=launches,
         learner_steps=int(state.step), sync_debug_mode="error", last_chunk=last,
         card=report["card"])
    if launches != LSTM_CHUNKS * LSTM_ITERS:
        raise AssertionError(f"vtrace launches {launches} != {LSTM_CHUNKS * LSTM_ITERS}")
    for i, m in enumerate(chunk_metrics):
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad or m["skipped_steps"] != 0.0:
            raise AssertionError(f"chunk {i}: non-finite {bad}, skipped {m['skipped_steps']}")
    if len(chunk_metrics) != LSTM_CHUNKS:
        raise AssertionError(f"{len(chunk_metrics)} chunk metrics, want {LSTM_CHUNKS}")
    profile_lstm_iteration(loop, state, carry, seconds / (LSTM_CHUNKS * LSTM_ITERS),
                           report["ff_profile"], report["card"])


def profile_lstm_iteration(loop, state, carry, iter_s: float, ff: dict, card: str) -> None:
    """Where an iteration of the LSTM chunk goes (a chunk repeats it
    ``LSTM_ITERS`` times): its unroll (T acting steps) and its learn step,
    each alone under ``torch.profiler``, beside the unprofiled iteration's
    time and the feed-forward chunk's profile."""
    import torch

    out = {}

    def unroll():
        out["traj"] = loop._unroll(state.params, carry)[1]

    def learn():
        loop.learn_fn(state, out["traj"])

    def host_s(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    parts = {"unroll": profile_device(unroll)[1], "learn": profile_device(learn)[1]}
    unprofiled = {"unroll": host_s(unroll), "learn": host_s(learn)}
    busy = {k: sum(us for _, us, _ in v) / 1e3 for k, v in parts.items()}
    launches = {k: sum(n for _, _, n in v) for k, v in parts.items()}
    vt = [(us, n) for k, us, n in parts["learn"] if "vtrace_kernel" in k]
    if not vt:
        raise AssertionError("the profile of the LSTM learn step shows no vtrace_kernel")
    emit("impala_lstm_profile", unprofiled_iteration_s=iter_s, unprofiled_s=unprofiled,
         device_ms=busy, launches=launches,
         device_busy_share=sum(busy.values()) / 1e3 / iter_s,
         top_kernels={k: [{"name": name[:90], "ms": us / 1e3, "calls": n}
                          for name, us, n in v[:8]] for k, v in parts.items()},
         vtrace_us_per_call=sum(us for us, _ in vt) / sum(n for _, n in vt), card=card)
    emit("impala_lstm_vs_ff",
         lstm_launches_per_chunk=sum(launches.values()) * LSTM_ITERS,
         ff_launches_per_chunk=ff["kernel_launches_per_chunk"],
         lstm_frames_per_chunk=LSTM_ITERS * loop.unroll_length * loop.venv.num_envs,
         ff_frames_per_chunk=MAIN_ITERS * MAIN_T * MAIN_B,
         lstm_busy_share=sum(busy.values()) / 1e3 / iter_s, ff_busy_share=ff["device_busy_share"],
         vtrace_us_per_call_80x8=sum(us for us, _ in vt) / sum(n for _, n in vt),
         vtrace_us_per_call_20x512=(ff["vtrace_kernel"] or {}).get("us_per_call"), card=card)


def _learning_phase(report: dict, task: str, required: bool = True, **kw) -> None:
    """``tools/torch_learning_curves.py``'s recipe for ``task`` at seed 0 on
    the card: ``run_until`` must cross the reference's threshold within its
    frame budget (reported only, where not ``required``), every learn step
    launching the V-trace kernel once, every chunk finite.  ``kw`` goes to
    the recipe."""
    import torch

    from scalerl_torch.ops import cuda_vtrace
    from tools.torch_learning_curves import REFERENCE_FRAMES, TASKS

    set_tf32(True)  # PyTorch's defaults: TF32 convs, float32 matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_vtrace.launches = 0
    row = TASKS[task](seed=0, **kw)
    launches = cuda_vtrace.launches
    steps = row["learner_steps"] + row.get("ff_control_learner_steps", 0)
    emit(f"learn_{task}", **row, required=required, reference_frames=REFERENCE_FRAMES[task],
         vtrace_launches=launches, card=report["card"])
    if launches != steps:
        raise AssertionError(f"{task}: vtrace launches {launches} != learner steps {steps}")
    if row["nonfinite_chunks"] or (required and not row["passed"]):
        raise AssertionError(f"{task}: did not reach {row['threshold']} within its budget: {row}")


def phase_learn_synthetic(report: dict) -> None:
    """Reported, not required: at seed 0 the reference's own recipe in the
    JAX package does not reach 54.4 within its budget either; both end with
    an action whose probability is ~0 in every cell (PERF.md §6).  Cut to
    ``SYNTHETIC_FRAMES`` (the recipe's budget is 500,000 frames, which
    ``tools/torch_learning_curves.py`` keeps)."""
    _learning_phase(report, "synthetic", required=False, max_frames=SYNTHETIC_FRAMES)


def phase_learn_catch(report: dict) -> None:
    _learning_phase(report, "catch")


def phase_learn_recall(report: dict) -> None:
    _learning_phase(report, "recall")


def profile_device(fn):
    """Run ``fn()`` under ``torch.profiler``; returns the wall seconds it
    took there and ``[(kernel, device us, calls)]``, heaviest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
    return profiled_s, _kernel_table(prof)


def _kernel_table(prof):
    """A finished profiler's ``[(kernel, device us, calls)]``, heaviest
    first, summed from its raw device events (``key_averages`` takes ~30 s
    over the ~354,000 kernels of an Anakin replay of the defaults' LSTM
    chunks).  The device-side ranges of ``record_function`` annotations
    (``step_marker``'s) span kernels already counted, so they are left out."""
    from torch.autograd import DeviceType

    rows: dict = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
                and e.duration_ns() > 0):
            us, n = rows.get(e.name(), (0.0, 0))
            rows[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    return sorted(((k, us, n) for k, (us, n) in rows.items()), key=lambda r: -r[1])


def _kernel_span_s(prof) -> float:
    """Seconds from the first kernel's start to the last kernel's end in a
    finished profiler's device events (``record_function`` ranges left out,
    as in :func:`_kernel_table`)."""
    from torch.autograd import DeviceType

    starts, ends = [], []
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
                and e.duration_ns() > 0):
            starts.append(e.start_ns())
            ends.append(e.start_ns() + e.duration_ns())
    return (max(ends) - min(starts)) / 1e9


def profile_host(fn, top: int = 12):
    """Run ``fn()`` under cProfile; returns the wall seconds and the
    port's functions with the largest cumulative time, as
    ``[(file:function, seconds, calls)]``.  cProfile slows Python calls,
    so read shares, not absolute times."""
    import cProfile
    import pstats

    import torch

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    rows = [(f"{Path(file).name}:{func}", ct, nc)
            for (file, _line, func), (_cc, nc, _tt, ct, _callers) in pstats.Stats(prof).stats.items()
            if "scalerl_torch" in file]
    return wall, sorted(rows, key=lambda r: -r[1])[:top]


def profile_chunks(loop, state, carry, chunk_s: float, card: str, chunks: int = 1) -> dict:
    """Where the time goes: ``chunks`` more chunks (after the counted run)
    under ``torch.profiler``; the device's busy time per chunk against the
    unprofiled chunk time, and the kernels that take the most of it.
    Returns the emitted fields."""
    profiled_s, kernels = profile_device(lambda: loop.run(state, carry, num_calls=chunks))
    busy_s = sum(us for _, us, _ in kernels) / 1e6 / chunks
    vt = [(us, n) for k, us, n in kernels if "vtrace_kernel" in k]
    if kernels and not vt:
        raise AssertionError("the profile of the fused chunks shows no vtrace_kernel")
    vtrace_row = {"us_per_call": sum(us for us, _ in vt) / sum(n for _, n in vt),
                  "calls_per_chunk": sum(n for _, n in vt) / chunks} if vt else None
    fields = dict(chunks=chunks, unprofiled_chunk_s=chunk_s,
                  profiled_chunk_s=profiled_s / chunks,
                  device_busy_s_per_chunk=busy_s if kernels else None,
                  device_busy_share=busy_s / chunk_s if kernels else None,
                  kernel_launches_per_chunk=sum(n for _, _, n in kernels) / chunks,
                  top_kernels=[{"name": k[:90], "ms_per_chunk": us / 1e3 / chunks,
                                "calls_per_chunk": n / chunks} for k, us, n in kernels[:12]],
                  vtrace_kernel=vtrace_row, card=card)
    emit("impala_profile", **fields)
    return fields


def _per_bracket(p, b_idx, within_t, got, n):
    """Samples whose index does not bracket its residual target ``within_t``
    in its block ``b_idx``, against a float64 scan of the block, to within
    ``PER_BRACKET_REL`` of the block's sum."""
    import torch

    from scalerl_torch.ops import per

    cum = per.gather_blocks(p, b_idx, PER_BLOCK).double().cumsum(dim=1)
    tol = PER_BRACKET_REL * cum[:, -1]
    t = within_t.double()

    def cum_at(w):
        return torch.gather(cum, 1, w.clamp(0, PER_BLOCK - 1)[:, None])[:, 0]

    w = got - b_idx * PER_BLOCK
    clipped = (w == PER_BLOCK - 1) | (got == n - 1)
    lower_ok = (w == 0) | (cum_at(w - 1) <= t + tol)
    upper_ok = clipped | (t <= cum_at(w) + tol)
    inside = (w >= 0) & (w < PER_BLOCK)
    return int((~(lower_ok & upper_ok & inside)).sum())


def _per_sample_case(p, targets, case: dict) -> dict:
    """The sample kernels on one plane, called twice (bit-equal), against
    ``ops/per.py::kernel_order_sample`` (their arithmetic in plain PyTorch:
    equal indices always) and the plain ``hierarchical_sample``: equal
    indices on integer priorities; on real ones the kernel order's index
    brackets its own residual (``_per_bracket``), and its block and residual
    differ from ``split_targets``' only within ``PER_PREFIX_REL`` of the
    plane's total of a block boundary.  Raises on a failure."""
    import torch

    from scalerl_torch.ops import cuda_per, per

    n = p.shape[0]
    got = cuda_per.sample_kernel(p, targets, PER_BLOCK)
    again = cuda_per.sample_kernel(p, targets, PER_BLOCK)
    order, b_k, within_k = per.kernel_order_sample(p, targets, PER_BLOCK)
    want = per.hierarchical_sample(p, targets, PER_BLOCK)
    torch.cuda.synchronize()
    case.update(n=n, S=targets.shape[0], mismatches=int((got != want).sum()),
                max_abs_err_vs_plain=int((got - want).abs().max()),
                kernel_order_mismatches=int((got != order).sum()),
                max_abs_err=int((got - order).abs().max()),
                repeat_bit_equal=bool(torch.equal(got, again)))
    bad = case["kernel_order_mismatches"] or not case["repeat_bit_equal"]
    if case["priorities"] == "integer":
        bad = bad or case["mismatches"]
    else:
        b_p, within_p = per.split_targets(p, targets, PER_BLOCK)
        cum = p.double().cumsum(dim=0)
        tol = PER_PREFIX_REL * cum[-1]
        moved = b_k != b_p
        boundary = cum[((torch.minimum(b_k, b_p) + 1) * PER_BLOCK).clamp(max=n) - 1]
        case.update(off_bracket=_per_bracket(p, b_k, within_k, got, n),
                    block_moves=int(moved.sum()),
                    block_moves_away_from_boundary=int(
                        (moved & ((targets.double() - boundary).abs() > tol)).sum()),
                    residual_moves_past_margin=int(
                        (~moved & ((within_k.double() - within_p.double()).abs() > tol)).sum()))
        bad = (bad or case["off_bracket"] or case["block_moves_away_from_boundary"]
               or case["residual_moves_past_margin"])
    if bad:
        raise AssertionError(f"sample kernels disagree: {case}")
    return case


R2D2_SLOTS, R2D2_BATCH = 2048, 16  # R2D2Arguments' replay_capacity and batch_size


def _per_replay_plane_cases(g) -> list:
    """The sample kernels at the sequence replays' sizes, through the
    dispatch the trainers call: the sequence-RL plane of 2 * TRAIN_B = 128
    priorities (one ragged block, an eighth of a 1024-wide one) with TRAIN_B
    = 64 stratified targets, and R2D2's plane of 2,048 slots (two whole
    blocks) with its batch of 16, filled to 1,500 (the ring not yet
    wrapped) and full.  Pad rows and empty slots carry priority 0 and may
    never be drawn; otherwise ``_per_sample_case``'s rules."""
    import torch

    from scalerl_torch.ops import per

    planes = []
    live = torch.zeros(2 * TRAIN_B, dtype=torch.bool, device="cuda")
    live[:41] = True  # two inserts of bucketed rows, each with a pad tail,
    live[64:93] = True  # and the rest of the ring still empty
    planes.append(("sequence replay", live, TRAIN_B))
    for filled in (1500, R2D2_SLOTS):
        live = torch.zeros(R2D2_SLOTS, dtype=torch.bool, device="cuda")
        live[:filled] = True
        planes.append((f"r2d2 replay, {filled} of {R2D2_SLOTS} slots", live, R2D2_BATCH))
    cases = []
    for plane, live, S in planes:
        n = live.shape[0]
        for kind in ("integer", "real"):
            if kind == "integer":
                raw = torch.randint(1, 17, (n,), generator=g, device="cuda").float()
            else:  # the trainers' own form: priority ** alpha
                raw = (torch.rand(n, generator=g, device="cuda") * 2 + 1e-3) ** 0.6
            p = torch.where(live, raw, 0.0)
            u = torch.rand(S, generator=g, device="cuda")
            targets = (torch.arange(S, device="cuda") + u) / S * p.sum()
            case = _per_sample_case(p, targets, {"plane": plane, "priorities": kind,
                                                 "live_slots": int(live.sum())})
            got = per.proportional_sample(p, targets, method="pallas", block_size=PER_BLOCK)
            case["pad_slots_drawn"] = int((~live[got]).sum())
            if case["pad_slots_drawn"]:
                raise AssertionError(f"sample kernels drew a pad slot: {case}")
            cases.append(case)
    return cases


def _update_case(n, g, kind="some", M=PER_BATCH):
    """M updates: ``some`` with a few duplicates, a same-block revisit, the
    plane's last lane and an index past it; ``heavy``: M / 4 slots hit 4
    times each in shuffled order, and an index below 0; ``chunks``: M
    indices over 3,000 slots, so duplicates fall within and across the
    kernel's chunks of ``MAX_UPDATES``."""
    import torch

    if kind == "heavy":
        slots = torch.randperm(n, generator=g, device="cuda")[:M // 4]
        idx = slots.repeat(4)[torch.randperm(M, generator=g, device="cuda")]
        idx[11] = -3  # clipped to 0
    elif kind == "chunks":
        idx = torch.randint(0, 3000, (M,), generator=g, device="cuda")
    else:
        idx = torch.randint(0, n, (M,), generator=g, device="cuda")
        idx[10] = idx[3]  # duplicate slots: the last write wins
        idx[20] = idx[3]
        idx[30] = (idx[5] // PER_BLOCK) * PER_BLOCK + (idx[5] + 1) % PER_BLOCK  # revisit
    idx[40] = n - 1  # the last lane of the plane
    idx[41] = n + 7  # clipped to n - 1
    p0 = torch.rand(n, generator=g, device="cuda") * 2 + 0.1
    new_p = torch.rand(M, generator=g, device="cuda") + 0.5
    return p0, idx, new_p


def _per_update_check(p0, idx, new_p, with_sums: bool, case: dict) -> dict:
    """The update kernel twice from one state (plane and sums bit-equal)
    against the plain version and the JAX package's ordered loop (the plane
    exact), the sums within ``PER_SUMS_RTOL`` of the plain version's and
    bit-equal to ``kernel_block_sums`` of the new plane on every touched
    block (the kernels sum a block in one order), and one launch a chunk of
    ``MAX_UPDATES``.  Raises on a failure."""
    import numpy as np
    import torch

    from scalerl_torch.ops import cuda_per, per

    n, M = p0.shape[0], idx.shape[0]
    want = p0.cpu().numpy()
    for i, v in zip(idx.clamp(0, n - 1).cpu().numpy(), new_p.cpu().numpy()):
        want[i] = v  # the JAX package's ordered loop
    runs = []
    for _ in range(2):
        pk = p0.clone()
        sk = per.block_sums(p0, PER_BLOCK) if with_sums else None
        before = cuda_per.update_launches
        cuda_per.update_kernel(pk, idx, new_p, sk, PER_BLOCK)
        runs.append((pk, sk, cuda_per.update_launches - before))
    pp = p0.clone()
    sp = per.block_sums(p0, PER_BLOCK) if with_sums else None
    per.update_priorities_plain(pp, idx, new_p, sp, PER_BLOCK)
    torch.cuda.synchronize()
    (pk, sk, launches), (pk2, sk2, _) = runs
    case.update(n=n, M=M, sums=with_sums, launches=launches,
                plane_max_abs_err=float((pk - pp).abs().max()),
                equals_ordered_loop=bool(np.array_equal(pk.cpu().numpy(), want)),
                repeat_bit_equal=bool(torch.equal(pk, pk2) and (sk is None or torch.equal(sk, sk2))))
    ok = (case["plane_max_abs_err"] == 0.0 and case["equals_ordered_loop"]
          and case["repeat_bit_equal"] and launches == -(-M // cuda_per.MAX_UPDATES))
    if with_sums:
        touched = torch.unique(idx.clamp(0, n - 1) // PER_BLOCK)
        case.update(touched_blocks=int(touched.numel()),
                    sums_max_rel_err=float(((sk - sp).abs() / sp.abs()).max()),
                    sums_equal_kernel_order=bool(torch.equal(
                        sk[touched], per.kernel_block_sums(pk, PER_BLOCK)[touched])))
        ok = ok and case["sums_max_rel_err"] <= PER_SUMS_RTOL and case["sums_equal_kernel_order"]
    if not ok:
        raise AssertionError(f"update kernel disagrees: {case}")
    return case


def phase_per_kernels(report: dict) -> None:
    import torch

    from scalerl_torch.ops import cuda_per, per

    set_tf32(False)
    g = torch.Generator(device="cuda").manual_seed(5)
    sample_cases = _per_replay_plane_cases(g)
    main = None
    for n in (1 << 20, 1_000_003):
        for kind in ("integer", "real"):
            if kind == "integer":
                p = torch.randint(1, 17, (n,), generator=g, device="cuda").float()
            else:
                p = torch.rand(n, generator=g, device="cuda") ** 0.6
            total = p.sum()
            for S in (32, PER_BATCH):
                u = torch.rand(S, generator=g, device="cuda")
                targets = (torch.arange(S, device="cuda") + u) / S * total
                sample_cases.append(_per_sample_case(p, targets, {"priorities": kind}))
                if n == 1 << 20 and S == PER_BATCH and kind == "real":
                    main = (p, targets)

    update_cases = []
    for n in (1 << 20, 1_000_003):
        for kind in ("some", "heavy"):
            p0, idx, new_p = _update_case(n, g, kind)
            for with_sums in (False, True):
                update_cases.append(_per_update_check(p0, idx, new_p, with_sums, {"kind": kind}))
    p0, idx, new_p = _update_case(1 << 20, g, "chunks", M=3 * cuda_per.MAX_UPDATES)
    for with_sums in (False, True):
        update_cases.append(_per_update_check(p0, idx, new_p, with_sums, {"kind": "chunks"}))

    # times at the DQN slice's shapes: N = 2^20, S = M = 512, blocks of 1024,
    # beside the replay floor: one one-element PyTorch op
    one = torch.zeros(1, device="cuda")
    floor = dict(replay_floor_ms=gpu_time_ms(lambda: one.add_(1.0), 200),
                 eager_floor_ms=eager_time_ms(lambda: one.add_(1.0), 200))
    p, targets = main
    n = p.shape[0]
    sample_bytes = 4 * n + PER_BATCH * (4 + 8)  # the plane once; targets in, indices out
    sample_ops = n + 2 * PER_BATCH * PER_BLOCK  # block sums' adds; a scan add, a compare a lane
    sample_timing = _bound(sample_bytes, sample_ops, dict(
        ms=gpu_time_ms(lambda: cuda_per.sample_kernel(p, targets, PER_BLOCK), 200),
        eager_ms=eager_time_ms(lambda: cuda_per.sample_kernel(p, targets, PER_BLOCK), 200),
        plain_ms=gpu_time_ms(lambda: per.hierarchical_sample(p, targets, PER_BLOCK), 50),
        plain_eager_ms=eager_time_ms(lambda: per.hierarchical_sample(p, targets, PER_BLOCK), 50),
        flat_cumsum_ms=gpu_time_ms(lambda: per.cumsum_sample(p, targets), 50),
        kernel_launches_per_call=2, **floor,
    ))
    p0, idx, new_p = _update_case(n, g)
    pk, pp = p0.clone(), p0.clone()
    clipped = idx.clamp(0, n - 1)
    slots = int(torch.unique(clipped).numel())
    touched = int(torch.unique(clipped // PER_BLOCK).numel())
    update_bytes = PER_BATCH * (8 + 4) + slots * 4  # indices, values in; slots out
    update_timing = _bound(update_bytes, 0, dict(
        ms=gpu_time_ms(lambda: cuda_per.update_kernel(pk, idx, new_p, None, PER_BLOCK), 200),
        eager_ms=eager_time_ms(lambda: cuda_per.update_kernel(pk, idx, new_p, None, PER_BLOCK), 200),
        plain_ms=gpu_time_ms(lambda: per.update_priorities_plain(pp, idx, new_p, None, PER_BLOCK), 50),
        plain_eager_ms=eager_time_ms(lambda: per.update_priorities_plain(pp, idx, new_p, None, PER_BLOCK), 50),
        distinct_slots=slots, touched_blocks=touched, **floor,
    ))
    sk = per.block_sums(p0, PER_BLOCK)
    sp = sk.clone()
    sums_bytes = update_bytes + touched * PER_BLOCK * 4 + touched * 4  # + blocks read, sums out
    sums_timing = _bound(sums_bytes, touched * PER_BLOCK, dict(
        ms=gpu_time_ms(lambda: cuda_per.update_kernel(pk, idx, new_p, sk, PER_BLOCK), 200),
        eager_ms=eager_time_ms(lambda: cuda_per.update_kernel(pk, idx, new_p, sk, PER_BLOCK), 200),
        plain_ms=gpu_time_ms(lambda: per.update_priorities_plain(pp, idx, new_p, sp, PER_BLOCK), 50),
        **floor,
    ))
    # max_abs_err: the sample's index against its plain version of the
    # kernels' arithmetic (kernel_order_sample), the update's plane against
    # update_priorities_plain; both must be 0
    worst_sample = max(c["max_abs_err"] for c in sample_cases)
    report["per_sample"] = {"max_abs_err": float(worst_sample), **sample_timing}
    report["per_update"] = {"max_abs_err": max(c["plane_max_abs_err"] for c in update_cases),
                            **update_timing}
    emit("per_kernels", block=PER_BLOCK, sample_cases=sample_cases, update_cases=update_cases,
         sample=sample_timing, update=update_timing, update_with_sums=sums_timing,
         bracket_rel=PER_BRACKET_REL, prefix_rel=PER_PREFIX_REL, sums_rtol=PER_SUMS_RTOL,
         max_updates_a_launch=cuda_per.MAX_UPDATES, card=report["card"],
         library_ms=None, library_note="no single PyTorch call computes either function: "
         "index_put_ does not promise last-wins; flat_cumsum_ms times cumsum + searchsorted")


def _bound(moved: int, ops: int, timing: dict, ops_per_s: float = H100_F32_OPS_PER_S) -> dict:
    """The larger of the bytes over the memory rate and the operations over
    ``ops_per_s``, the card's peak for the inputs' type."""
    bytes_ms = moved / H100_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return dict(timing, bytes_moved=moved, bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def _dqn_args(**kw):
    from scalerl_torch.config import DQNArguments

    return DQNArguments(num_envs=PER_NUM_ENVS, buffer_size=PER_CAPACITY, batch_size=PER_BATCH,
                        use_per=True, n_steps=PER_N_STEP, **kw)


def phase_dqn_learn(report: dict) -> None:
    """One full-size learn step from the same buffer contents and uniforms,
    through the kernels and through the plain versions, on the card."""
    import dataclasses

    import torch

    from unittest import mock

    from scalerl_torch.agents.dqn import DQNAgent
    from scalerl_torch.data.prioritized import per_sample_from_uniforms
    from scalerl_torch.data.sampler import Sampler
    from scalerl_torch.ops import per

    set_tf32(False)
    g = torch.Generator(device="cuda").manual_seed(7)
    shape = (PER_CAPACITY, PER_NUM_ENVS)
    done = torch.rand(shape, generator=g, device="cuda") < 0.05
    contents = dict(
        obs=torch.randn(shape + (4,), generator=g, device="cuda"),
        next_obs=torch.randn(shape + (4,), generator=g, device="cuda"),
        action=torch.randint(0, 2, shape, generator=g, device="cuda"),
        reward=torch.rand(shape, generator=g, device="cuda"),
        done=done,
        boundary=done | (torch.rand(shape, generator=g, device="cuda") < 0.01),
    )
    priorities = torch.rand(shape, generator=g, device="cuda") * 2 + 0.05
    u = torch.rand(PER_BATCH, generator=g, device="cuda")
    out = {}
    for name, use_pallas in (("plain", False), ("kernel", True)):
        args = _dqn_args(use_pallas=use_pallas)
        agent = DQNAgent(args, (4,), 2)
        sampler = Sampler((4,), PER_CAPACITY, PER_NUM_ENVS, use_per=True, per_alpha=args.per_alpha,
                          n_step=PER_N_STEP, gamma=args.gamma, use_pallas=use_pallas)
        state = sampler.buffer.state
        for k, v in contents.items():
            state.replay.storage[k].copy_(v)
        state.priorities.copy_(priorities)
        # a full ring whose head has wrapped: the sample rolls the plane
        sampler.buffer.state = dataclasses.replace(
            state, replay=dataclasses.replace(state.replay, pos=12345, size=PER_CAPACITY))
        # the plain leg samples in the kernels' order of sums (their plain
        # version): on this real-valued plane hierarchical_sample's order
        # picks other indices at a few boundaries (per_kernels bounds where)
        with mock.patch.object(per, "hierarchical_sample",
                               lambda p, t, bs: per.kernel_order_sample(p, t, bs)[0]):
            batch = per_sample_from_uniforms(sampler.buffer.state, u, args.per_alpha,
                                             args.per_beta, PER_N_STEP, args.gamma,
                                             sampler.buffer.sample_method)
        metrics, td_abs = agent.learn_device(batch)
        sampler.update_priorities(batch["indices"], td_abs + 1e-6)
        torch.cuda.synchronize()
        out[name] = dict(indices=batch["indices"], plane=sampler.buffer.state.priorities,
                         params=torch.cat([v.reshape(-1) for v in agent.state.params.values()]),
                         loss=float(metrics["loss"]))
    plain, kern = out["plain"], out["kernel"]
    mismatches = int((plain["indices"] != kern["indices"]).sum())
    errs = {
        "plane_max_abs_err": float((plain["plane"] - kern["plane"]).abs().max()),
        "params_max_abs_err": float((plain["params"] - kern["params"]).abs().max()),
    }
    emit("dqn_learn", index_mismatches=mismatches, **errs, loss_plain=plain["loss"],
         loss_kernel=kern["loss"], batch=PER_BATCH, replay=list(shape), tol=DQN_LEARN_TOL,
         tf32=False)
    if mismatches or any(not v <= DQN_LEARN_TOL for v in errs.values()):
        raise AssertionError(f"kernel learn step off the plain one: {mismatches} indices, {errs}")


class CartPoleVectorView:
    """gym's vector-env API over the port's ``TensorCartPole`` on the card
    (whose machine may have no gymnasium): ``reset(seed)``, ``step(actions)``
    -> ``(obs, reward, terminated, truncated, infos)``, ``num_envs`` and the
    spaces' ``shape`` and ``n``.

    ``done`` splits into ``truncated`` (the step that reaches ``max_steps``)
    and ``terminated`` (every other end).  No ``final_obs``: where an episode
    ends, ``obs`` is already the reset observation, so a truncated
    transition's ``next_obs`` is the reset observation."""

    def __init__(self, num_envs: int) -> None:
        from scalerl_torch.envs.tensor_envs import TensorCartPole

        self.env = TensorCartPole(num_envs)
        self.num_envs = num_envs
        self.single_observation_space = SimpleNamespace(shape=self.env.observation_shape)
        self.single_action_space = SimpleNamespace(n=self.env.num_actions)

    def reset(self, seed: int):
        import torch

        self.generator = torch.Generator(device=self.env.device).manual_seed(seed)
        self.state, obs = self.env.reset(self.generator)
        return obs, {}

    def step(self, actions):
        at_limit = self.state.t + 1 >= self.env.max_steps
        self.state, obs, reward, done = self.env.step(self.state, actions, self.generator)
        truncated = done & at_limit
        return obs, reward, done & ~truncated, truncated, {}


def phase_dqn_per(report: dict) -> None:
    import torch

    from scalerl_torch.agents.dqn import DQNAgent
    from scalerl_torch.ops import cuda_per, cuda_vtrace
    from scalerl_torch.trainer.off_policy import OffPolicyTrainer

    set_tf32(False)
    # 40,000 env steps: about 2,400 learn steps
    args = _dqn_args(use_pallas=True, warmup_learn_steps=2000, train_frequency=PER_NUM_ENVS,
                     max_timesteps=40_000, eval_frequency=10**9, save_model=False,
                     logger_backend="none", telemetry_interval_s=0.0,
                     work_dir=_work_dir("dqn_per"))
    envs = CartPoleVectorView(PER_NUM_ENVS)
    agent = DQNAgent(args, envs.single_observation_space.shape, envs.single_action_space.n)
    trainer = OffPolicyTrainer(args, agent, envs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_vtrace.launches = 0
    cuda_per.sample_launches = 0
    cuda_per.update_launches = 0
    t0 = time.perf_counter()
    summary = trainer.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"per_sample": cuda_per.sample_launches, "per_update": cuda_per.update_launches}
    report["launches"].update(launches)
    learn_steps = trainer.learn_steps
    skipped = float(trainer.skipped_steps)
    losses = [m["loss"] for _, kind, m in trainer.log_history if kind == "train" and "loss" in m]
    peak = torch.cuda.max_memory_allocated() / 2**30

    # the learn step alone (sample -> learn -> priority update), synchronised
    reps = 50
    t0 = time.perf_counter()
    for _ in range(reps):
        trainer.train_step()
    torch.cuda.synchronize()
    learn_step_s = (time.perf_counter() - t0) / reps

    emit("dqn_per", num_envs=PER_NUM_ENVS, replay=[PER_CAPACITY, PER_NUM_ENVS],
         batch=PER_BATCH, n_step=PER_N_STEP, env_steps=trainer.global_step, seconds=seconds,
         env_steps_per_s=trainer.global_step / seconds, learn_steps=learn_steps,
         learn_steps_per_s=learn_steps / seconds, learn_step_ms=learn_step_s * 1e3,
         launches=launches, vtrace_launches=cuda_vtrace.launches, skipped_steps=skipped,
         logged_losses=len(losses), losses_finite=all(math.isfinite(x) for x in losses),
         last_loss=losses[-1] if losses else None,
         episodes=summary.get("episodes"), return_mean=summary.get("return_mean"),
         peak_mem_gib=peak, card=report["card"])
    if launches != {"per_sample": learn_steps, "per_update": learn_steps} or learn_steps < 2000:
        raise AssertionError(f"PER kernel launches {launches} for {learn_steps} learn steps")
    if not losses or not all(math.isfinite(x) for x in losses) or skipped != 0.0:
        raise AssertionError(f"{len(losses)} logged losses (finite: "
                             f"{all(math.isfinite(x) for x in losses)}), {skipped} skipped steps")

    steps = 20
    profiled_s, kernels = profile_device(lambda: [trainer.train_step() for _ in range(steps)])
    busy_s = sum(us for _, us, _ in kernels) / 1e6 / steps
    emit("dqn_profile", learn_steps=steps, unprofiled_learn_step_s=learn_step_s,
         profiled_learn_step_s=profiled_s / steps,
         device_busy_s_per_learn_step=busy_s if kernels else None,
         device_busy_share=busy_s / learn_step_s if kernels else None,
         kernel_launches_per_learn_step=sum(n for _, _, n in kernels) / steps,
         top_kernels=[{"name": k[:90], "us_per_learn_step": us / steps,
                       "calls_per_learn_step": n / steps} for k, us, n in kernels[:12]],
         card=report["card"])


# Generation plane (phases 10-13): bench.py's genrl-continuous setup
GEN_V, GEN_D, GEN_HEADS, GEN_LAYERS = 32, 256, 8, 4
GEN_P, GEN_R, GEN_LANES = 128, 256, 256
GEN_PAGE, GEN_MACRO, GEN_MIN_FREE = 16, 16, 32
GEN_MAX_LEN = 2 * (GEN_P + GEN_R)
GEN_PAGES_PER_LANE = (GEN_P + GEN_R) // GEN_PAGE  # 24
GEN_NUM_PAGES = GEN_LANES * GEN_PAGES_PER_LANE + 1  # 6,145 with the null page
GEN_TARGET_S = 2.0  # 4 s before genrl_on_shards, 8 before phases 51-55, 10 before 43-45
# the kernel against its plain version: the same float32 arithmetic summed
# in another order (an online softmax over chunks of 16 tokens against one
# softmax and an einsum); JAX pins its kernel to its reference at 1e-5
PAGED_TOL = 1e-5
# bfloat16 inputs: both sides accumulate in float32 and round the output to
# bfloat16 once, so they may differ by one bfloat16 step of an output below
# 4 in magnitude (2^-6)
PAGED_BF16_TOL = 2.0 ** -6
# the model on the card against the same weights on the host, float32 with
# TF32 off: cuBLAS and the host's BLAS sum the d=256 and 1,024-wide products
# in different orders, which moves logits ~1e-6 per layer
GEN_MODEL_TOL = 1e-4
# one macro step, kernel against plain version on the card: attention
# differs by <= PAGED_TOL per call and that passes through 4 layers and 16
# dependent substeps
GEN_DECODE_TOL = 1e-4
# temperature 0, continuous (paged kernel) against cohort (dense masked
# attention) engine: JAX's acceptance pin, tests/test_continuous.py:74-94
GEN_IDENTITY_LOGP_TOL = 1e-5


def _gen_model(device, seed=0):
    import torch

    from scalerl_torch.models.transformer import TransformerPolicy

    return TransformerPolicy(num_actions=GEN_V, vocab_size=GEN_V, d_model=GEN_D,
                             num_heads=GEN_HEADS, num_layers=GEN_LAYERS, max_len=GEN_MAX_LEN,
                             device=device, generator=torch.Generator().manual_seed(seed))


def _gen_config(**kw):
    from scalerl_torch.genrl.continuous import ContinuousConfig

    base = dict(vocab_size=GEN_V, max_prompt_len=GEN_P, max_new_tokens=GEN_R, temperature=1.0,
                eos_token=1, seed=0, lanes=GEN_LANES, page_size=GEN_PAGE,
                steps_per_macro=GEN_MACRO, min_free_lanes=GEN_MIN_FREE, prompt_buckets=(GEN_P,))
    return ContinuousConfig(**{**base, **kw})


def _paged_case(B, H, D, ps, M, N, lengths, seed, dtype, junk=False, shared=0):
    """Pools, q and a fragmented table: lane pages drawn from one shuffled
    pool order; ``shared`` lanes map lane 0's first two pages; entries past
    a lane's pages are the null page (or random pages with ``junk``)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    order = torch.randperm(N - 1, generator=g) + 1
    table = torch.zeros(B, M, dtype=torch.int32)
    cursor = 0
    for b in range(B):
        n = -(-int(lengths[b]) // ps)
        table[b, :n] = order[cursor:cursor + n].to(torch.int32)
        cursor = (cursor + n) % (N - 1 - M)
        if junk and n < M:
            table[b, n:] = torch.randint(0, N, (M - n,), generator=g, dtype=torch.int32)
    for b in range(1, min(B, 1 + shared)):
        if -(-int(lengths[b]) // ps) > 2 and -(-int(lengths[0]) // ps) > 2:
            table[b, :2] = table[0, :2]
    dev = "cuda"
    return dict(
        q=torch.randn(B, 1, H, D, generator=g).to(dev, dtype),
        k_pages=torch.randn(N, ps, H, D, generator=g).to(dev, dtype),
        v_pages=torch.randn(N, ps, H, D, generator=g).to(dev, dtype),
        page_table=table.to(dev),
        lengths=torch.as_tensor(lengths, dtype=torch.int32).to(dev),
    )


# Lengths on and around the kernel's 64-token context splits (and its
# 16-token chunks), up to a full lane of 24 pages of 16
PAGED_SPLIT_LENGTHS = (1, 2, 15, 16, 17, 63, 64, 65, 127, 128, 129, 191, 192, 193, 255, 256,
                       257, 319, 320, 321, 383, 384)


def _paged_lengths(B: int, cap: int, seed: int):
    """B lengths cycling through ``PAGED_SPLIT_LENGTHS`` (those <= cap, and
    cap itself), in a seeded order."""
    import torch

    pool = sorted({n for n in PAGED_SPLIT_LENGTHS if n <= cap} | {cap})
    g = torch.Generator().manual_seed(seed)
    return torch.tensor([pool[i % len(pool)] for i in range(B)])[torch.randperm(B, generator=g)]


def _paged_layouts():
    """(name, B, H, D, ps, M, dtype, junk, shared) of the split kernel's
    edges, besides the engine's shape: pages of 4 and 12 (chunks that span
    pages, splits that start mid-page), heads that leave a head group
    partial (3; 12 at D = 128 in groups of 2), head dims padded up (5, 18,
    20: 4-, 8- and 16-byte copies in float32; 5 in bf16: 2-byte), and every
    padded width (16, 32, 64, 128) in both types."""
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    return [
        ("ps4_D16", 16, 8, 16, 4, 40, f32, True, 4),
        ("ps12_D64_H3", 12, 3, 64, 12, 16, f32, False, 4),
        ("ps16_D128_H12", 8, 12, 128, 16, 12, f32, True, 2),
        ("ps16_D20", 12, 8, 20, 16, 10, f32, False, 0),
        ("ps16_D18", 12, 8, 18, 16, 10, f32, True, 0),
        ("ps8_D5", 12, 4, 5, 8, 20, f32, False, 0),
        ("bf16_ps4_D16", 16, 8, 16, 4, 40, bf16, True, 4),
        ("bf16_ps12_D64_H12", 12, 12, 64, 12, 16, bf16, False, 4),
        ("bf16_ps16_D128_H3", 8, 3, 128, 16, 12, bf16, True, 2),
        ("bf16_ps8_D5", 12, 4, 5, 8, 20, bf16, False, 0),
    ]


def _paged_timing(inp: dict, lengths, with_plain: bool) -> dict:
    """The kernel's time by CUDA-graph replay and eagerly at these inputs,
    beside the bound: the bytes the call must move (each live token's K and
    V, q, the table, the lengths, the output; float32) and its operations."""
    from scalerl_torch.ops import cuda_paged_attention
    from scalerl_torch.ops.paged_attention import paged_attention_reference

    B, _, H, D = inp["q"].shape
    M = inp["page_table"].shape[1]
    kernel = cuda_paged_attention.paged_decode_attention
    live = int(lengths.sum())
    moved = (live * 2 * H * D * 4 + 2 * B * H * D * 4 + B * M * 4 + B * 4)
    ops = live * H * (4 * D + 6)  # q.k and p.v (2D each), the softmax's few
    timing = dict(ms=gpu_time_ms(lambda: kernel(**inp), 200),
                  eager_ms=eager_time_ms(lambda: kernel(**inp), 200), live_tokens=live)
    if with_plain:
        timing.update(plain_ms=gpu_time_ms(lambda: paged_attention_reference(**inp), 20),
                      plain_eager_ms=eager_time_ms(lambda: paged_attention_reference(**inp), 20))
    timing = _bound(moved, ops, timing)
    timing["bound_share"] = timing["bound_ms"] / timing["ms"]
    return timing


def _paged_gather_sdpa(inp: dict):
    """The library's computation of the paged kernel's function on ``inp``:
    every lane's pages gathered whole, then
    ``F.scaled_dot_product_attention`` under the length mask (context only;
    the port never calls it).  Returns the call, ``[B, 1, H, D]``."""
    import torch
    import torch.nn.functional as F

    B, _, H, D = inp["q"].shape
    N, ps = inp["k_pages"].shape[:2]
    M = inp["page_table"].shape[1]
    kflat = inp["k_pages"].view(N * ps, H, D)
    vflat = inp["v_pages"].view(N * ps, H, D)
    idx = (inp["page_table"].long()[:, :, None] * ps
           + torch.arange(ps, device="cuda")[None, None, :]).reshape(B, M * ps)
    valid = torch.arange(M * ps, device="cuda")[None, :] < inp["lengths"][:, None]
    valid = valid[:, None, None, :]

    def gather_sdpa():
        k = kflat[idx].transpose(1, 2)
        v = vflat[idx].transpose(1, 2)
        return F.scaled_dot_product_attention(inp["q"].transpose(1, 2), k, v,
                                              attn_mask=valid).transpose(1, 2)

    return gather_sdpa


def phase_paged_attn(report: dict) -> None:
    import torch

    from scalerl_torch.ops import cuda_paged_attention
    from scalerl_torch.ops.paged_attention import paged_attention_reference

    set_tf32(False)
    kernel = cuda_paged_attention.paged_decode_attention
    B, H, D = GEN_LANES, GEN_HEADS, GEN_D // GEN_HEADS
    ps, M, N = GEN_PAGE, GEN_PAGES_PER_LANE, GEN_NUM_PAGES
    main_lengths = _paged_main_lengths()
    cases = []

    def check(name, inp, tol, **extra):
        """The kernel against the plain version (and twice: bit-equal)."""
        got = kernel(**inp)
        again = kernel(**inp)
        err = (got.float() - paged_attention_reference(**inp).float()).abs().max().item()
        cases.append({"shape": name, "dtype": str(inp["q"].dtype)[6:], "max_abs_err": err,
                      "tol": tol, "repeat_bit_equal": bool(torch.equal(got, again)), **extra})

    layouts = [  # tests/test_paging.py:342-351, plus a length-1 lane
        ([[1, 2, 3], [4, 5, 6]], [12, 8]),
        ([[7, 1, 5], [3, 8, 2]], [12, 12]),
        ([[5, 3, 0], [6, 0, 0]], [7, 2]),
        ([[4, 0, 0], [2, 6, 1]], [1, 9]),
    ]
    for i, (table, lengths) in enumerate(layouts):
        inp = _paged_case(2, 2, 8, 4, 3, 9, lengths, seed=20 + i, dtype=torch.float32)
        inp["page_table"] = torch.tensor(table, dtype=torch.int32, device="cuda")
        check("small", inp, PAGED_TOL, table=table, lengths=lengths)
    split_lengths = _paged_lengths(B, M * ps, seed=14)
    for name, lengths, seed, dtype, kw in (
        ("main", main_lengths, 12, torch.float32, dict(shared=8)),
        ("main_junk_tail", main_lengths, 12, torch.float32, dict(junk=True, shared=8)),
        ("main_split_boundaries", split_lengths, 15, torch.float32, dict(junk=True, shared=8)),
        ("main_bf16", main_lengths, 13, torch.bfloat16, dict(shared=8)),
        ("main_split_boundaries_bf16", split_lengths, 16, torch.bfloat16,
         dict(junk=True, shared=8)),
    ):
        inp = _paged_case(B, H, D, ps, M, N, lengths, seed=seed, dtype=dtype, **kw)
        check(name, inp, PAGED_TOL if dtype == torch.float32 else PAGED_BF16_TOL)
    for name, b, h, d, pgs, m, dtype, junk, shared in _paged_layouts():
        lengths = _paged_lengths(b, m * pgs, seed=len(cases))
        inp = _paged_case(b, h, d, pgs, m, b * m + m + 2, lengths, seed=30 + len(cases),
                          dtype=dtype, junk=junk, shared=shared)
        check(name, inp, PAGED_TOL if dtype == torch.float32 else PAGED_BF16_TOL,
              lanes=b, heads=h, head_dim=d, page_size=pgs, pages_per_lane=m)
    torch.cuda.synchronize()
    bad = [c for c in cases if not (c["max_abs_err"] <= c["tol"] and c["repeat_bit_equal"])]
    if bad:
        raise AssertionError(f"paged kernel off its plain version or not repeatable: {bad}")
    worst = max(c["max_abs_err"] for c in cases if c["dtype"] == "float32")

    inp = _paged_case(B, H, D, ps, M, N, main_lengths, seed=12, dtype=torch.float32, shared=8)
    gather_sdpa = _paged_gather_sdpa(inp)
    lib_err = (gather_sdpa() - paged_attention_reference(**inp)).abs().max().item()
    timing = _paged_timing(inp, main_lengths, with_plain=True)
    timing["library_ms"] = gpu_time_ms(gather_sdpa, 20)
    report["paged_attention"] = {"max_abs_err": worst, **timing}
    emit("paged_attn", tol=PAGED_TOL, bf16_tol=PAGED_BF16_TOL, max_abs_err=worst, cases=cases,
         shape={"lanes": B, "heads": H, "head_dim": D, "page_size": ps, "pages_per_lane": M,
                "num_pages": N},
         split_tokens=cuda_paged_attention.SPLIT_TOKENS,
         scratch_bytes=4 * cuda_paged_attention.scratch_floats(B, H, D, M * ps),
         library="gather + F.scaled_dot_product_attention (context only; the port never "
                 "calls it)", library_max_abs_err=lib_err, card=report["card"], **timing)


def phase_genrl_model(report: dict) -> None:
    """The full-width model on the card against the same weights on the
    host, on the masked, paged prefill, paged decode (kernel on the card,
    plain version on the host) and tail prefill paths."""
    import torch

    from scalerl_torch.models.transformer import (
        init_paged_kv_cache,
        prompt_attention_mask,
        sequence_attention_mask,
        sequence_positions,
    )
    from scalerl_torch.ops import cuda_paged_attention

    set_tf32(False)
    gpu = _gen_model("cuda", seed=1)
    gpu.paged_attn_fn = cuda_paged_attention.paged_decode_attention
    cpu = _gen_model("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(3)
    A, P, ps, M = 4, GEN_P, GEN_PAGE, GEN_PAGES_PER_LANE
    N = A * M + 1
    lengths = np.array([P, P * 3 // 5, P // 8 + 1, 2], np.int32)
    tokens = rng.integers(2, GEN_V, size=(A, P)).astype(np.int32)
    order = rng.permutation(np.arange(1, N)).astype(np.int32)  # fragmented pages
    table = order.reshape(A, M)
    pos = np.arange(P)
    page_ids = np.where(pos[None] < lengths[:, None], table[:, pos // ps], 0).astype(np.int32)
    offsets = np.where(pos[None] < lengths[:, None], pos % ps, 0).astype(np.int32)
    head_dim = GEN_D // GEN_HEADS

    def run(model, dev):
        t = dict(tokens=tokens, lengths=lengths, table=table, page_ids=page_ids, offsets=offsets)
        t = {k: torch.as_tensor(v).to(dev) for k, v in t.items()}
        out = {}
        with torch.no_grad():
            S = P
            mask = sequence_attention_mask(t["lengths"], S, S)
            o = model(t["tokens"], positions=sequence_positions(t["lengths"], S, S), attn_mask=mask)
            out["masked"] = (o.policy_logits, o.baseline)
            pools = init_paged_kv_cache(N, ps, GEN_LAYERS, GEN_HEADS, head_dim, device=dev)
            o, _ = model(t["tokens"], positions=torch.arange(P, device=dev).expand(A, P),
                         attn_mask=prompt_attention_mask(t["lengths"], P), paged_cache=pools,
                         page_ids=t["page_ids"], page_offsets=t["offsets"])
            out["paged_prefill"] = (o.policy_logits, o.baseline)
            # one decode token at each lane's cursor, through the table
            cl = t["lengths"].clone()
            tok = t["tokens"][:, :1].clone()
            pid = t["table"].gather(1, (cl // ps).long()[:, None])
            o, _ = model(tok, positions=cl[:, None], paged_cache=pools, page_ids=pid,
                         page_offsets=(cl % ps)[:, None], page_table=t["table"],
                         attn_lengths=cl + 1)
            out["paged_decode"] = (o.policy_logits, o.baseline)
            # tail prefill: the last 5 prompt tokens again, on top of the
            # prefix before them in the pool
            T = 5
            starts = (t["lengths"] - T).clamp(min=0)
            gpos = starts[:, None] + torch.arange(T, device=dev)[None, :]
            toks = t["tokens"].gather(1, gpos.long())
            o, _ = model(toks, positions=gpos, paged_cache=pools,
                         page_ids=t["table"].gather(1, (gpos // ps).long()),
                         page_offsets=gpos % ps, page_table=t["table"], prefix_starts=starts)
            out["tail_prefill"] = (o.policy_logits, o.baseline)
            out["pools"] = torch.cat([torch.stack(pools.k)[:, 1:].reshape(-1),
                                      torch.stack(pools.v)[:, 1:].reshape(-1)])
        return out

    launches0 = cuda_paged_attention.launches
    want, got = run(cpu, "cpu"), run(gpu, "cuda")
    kernel_calls = cuda_paged_attention.launches - launches0
    errs = {}
    for path in ("masked", "paged_prefill", "paged_decode", "tail_prefill"):
        errs[path] = max((g.cpu() - w).abs().max().item() for g, w in zip(got[path], want[path]))
    errs["pools"] = (got["pools"].cpu() - want["pools"]).abs().max().item()
    emit("genrl_model", tol=GEN_MODEL_TOL, max_abs_err=errs, kernel_calls=kernel_calls,
         d_model=GEN_D, heads=GEN_HEADS, layers=GEN_LAYERS, vocab=GEN_V, tf32=False)
    if kernel_calls != GEN_LAYERS:
        raise AssertionError(f"paged decode ran the kernel {kernel_calls} times, want {GEN_LAYERS}")
    bad = {k: v for k, v in errs.items() if not v <= GEN_MODEL_TOL}
    if bad:
        raise AssertionError(f"model card vs host off tolerance: {bad}")


def _prompts(rng, n):
    lengths = rng.integers(2, GEN_P + 1, size=n).astype(np.int32)
    prompts = rng.integers(2, GEN_V, size=(n, GEN_P)).astype(np.int32)
    return prompts, lengths


def phase_genrl_decode(report: dict) -> None:
    """One full-shape macro step from the same state and generator seed:
    through the kernel and through the plain version, on the card."""
    import torch

    from scalerl_torch.genrl import continuous
    from scalerl_torch.genrl.continuous import ContinuousEngine
    from scalerl_torch.ops import cuda_paged_attention

    set_tf32(False)
    model = _gen_model("cuda")
    params = model.state_dict()
    prompts, lengths = _prompts(np.random.default_rng(5), GEN_LANES)
    out = {}
    for impl in ("pallas", "xla"):
        eng = ContinuousEngine(model, params, _gen_config(paged_attn=impl))
        for i in range(GEN_LANES):
            eng.submit(prompts[i], lengths[i])
        launches0 = cuda_paged_attention.launches
        eng._admit()
        eng._ensure_pages()
        p, gen = eng._snapshot_params()
        with torch.no_grad():
            (table,) = continuous._device_put((eng._table,), eng.device)
            packed = eng._decode_macro(p, gen, table)
        host = eng._unpack(continuous._device_get(packed))
        out[impl] = dict(host=host, logits=eng._logits_st.cpu(), live=eng.live_lanes,
                         pools=torch.cat([torch.stack(eng._pools.k)[:, 1:].reshape(-1),
                                          torch.stack(eng._pools.v)[:, 1:].reshape(-1)]).cpu(),
                         launches=cuda_paged_attention.launches - launches0)
        del eng
    k, p = out["pallas"], out["xla"]
    mismatches = {f: int((k["host"][f] != p["host"][f]).sum())
                  for f in ("tokens", "mask", "cl", "done", "resp")}
    errs = {
        "logp": float(np.abs(k["host"]["logp"] - p["host"]["logp"]).max()),
        "value": float(np.abs(k["host"]["value"] - p["host"]["value"]).max()),
        "logits": (k["logits"] - p["logits"]).abs().max().item(),
        "pools": (k["pools"] - p["pools"]).abs().max().item(),
    }
    emit("genrl_decode", lanes=GEN_LANES, live_lanes=k["live"], steps=GEN_MACRO,
         mismatches=mismatches, max_abs_err=errs, tol=GEN_DECODE_TOL, kernel_launches=k["launches"],
         plain_launches=p["launches"], tf32=False)
    if any(mismatches.values()) or any(not v <= GEN_DECODE_TOL for v in errs.values()):
        raise AssertionError(f"macro step kernel vs plain: {mismatches}, {errs}")
    if k["launches"] != GEN_MACRO * GEN_LAYERS or p["launches"] != 0:
        raise AssertionError(f"launches {k['launches']} / {p['launches']}")


def phase_genrl_continuous(report: dict) -> None:
    """The main path as bench.py's genrl-continuous mode sets it up: the
    cohort engine, then the continuous engine under Poisson arrivals at
    twice the cohort's completion rate, then the temperature-0 identity of
    the two engines at full width, then a profile."""
    import torch

    from scalerl_torch.genrl.continuous import ContinuousEngine
    from scalerl_torch.genrl.engine import GenerationConfig, GenerationEngine
    from scalerl_torch.ops import cuda_paged_attention

    set_tf32(False)
    model = _gen_model("cuda")
    params = model.state_dict()
    rng = np.random.default_rng(0)
    base = dict(vocab_size=GEN_V, max_prompt_len=GEN_P, max_new_tokens=GEN_R, temperature=1.0,
                eos_token=1, seed=0)
    cohort = GenerationEngine(model, params, GenerationConfig(**base))
    cohort.generate(*_prompts(rng, GEN_LANES))  # warm-up round
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cohort_tokens = cohort_rounds = 0
    while time.perf_counter() - t0 < GEN_TARGET_S or cohort_rounds < 2:
        cohort_tokens += cohort.generate(*_prompts(rng, GEN_LANES)).decode_tokens
        cohort_rounds += 1
    cohort_s = time.perf_counter() - t0
    cohort_seq_per_s = cohort_rounds * GEN_LANES / cohort_s

    engine = ContinuousEngine(model, params, _gen_config())
    rate = 2.0 * cohort_seq_per_s
    t_warm = time.perf_counter()
    prompts, lengths = _prompts(rng, 2 * GEN_LANES)  # two lane-fills (six before phases 51-55)
    for i in range(len(lengths)):
        engine.submit(prompts[i], lengths[i])
    while engine.live_lanes or engine.pending or engine._inflight:
        engine.step()
    warm_s = time.perf_counter() - t_warm

    clock = {"t0": time.perf_counter()}
    clock["next"] = rng.exponential(1.0 / rate)

    def cycle():
        """Submit the arrivals that are due, then one engine step."""
        now = time.perf_counter() - clock["t0"]
        n_new = 0
        while clock["next"] <= now:
            n_new += 1
            clock["next"] += rng.exponential(1.0 / rate)
        if n_new:
            prompts, lengths = _prompts(rng, n_new)
            for i in range(n_new):
                engine.submit(prompts[i], lengths[i])
        if engine.live_lanes == 0 and engine.pending == 0:
            return []  # idle until the next arrival lands
        return engine.step()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_paged_attention.launches = 0
    occ0, macro0 = engine._occupancy_sum, engine.macro_steps
    saved0 = engine.prefix_tokens_saved
    done = []
    t0 = clock["t0"] = time.perf_counter()
    while time.perf_counter() - t0 < GEN_TARGET_S or len(done) < 2:
        done.extend(cycle())
    torch.cuda.synchronize()
    cont_s = time.perf_counter() - t0
    launches = cuda_paged_attention.launches
    macros = engine.macro_steps - macro0
    occupancy = (engine._occupancy_sum - occ0) / max(macros, 1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    window = list(done)
    cont_tokens = sum(len(c.response_tokens) for c in window)
    report["launches"]["paged_attention"] = launches
    macro_s = cont_s / max(macros, 1)

    # where the time goes: more macro steps of the same traffic (arrivals
    # timed from each window's own start) under torch.profiler, against the
    # unprofiled macro step time above; then the host's side under cProfile
    def more_cycles(k=4):  # 8 cycles before phases 51-55 joined the script
        clock["t0"] = time.perf_counter()
        clock["next"] = rng.exponential(1.0 / rate)
        for _ in range(k):
            done.extend(cycle())

    macro1 = engine.macro_steps
    profiled_s, kernels = profile_device(more_cycles)
    pmacros = max(engine.macro_steps - macro1, 1)
    busy_s = sum(us for _, us, _ in kernels) / 1e6 / pmacros
    paged_us = sum(us for k, us, _ in kernels if "paged_decode" in k) / pmacros
    macro1 = engine.macro_steps
    host_s, host_top = profile_host(more_cycles)
    hmacros = max(engine.macro_steps - macro1, 1)

    # one length mix of the engine's lanes, as a decode call hands it to the
    # kernel, snapshotted once; the kernel is timed at it after the drain
    net, seen = engine._run.net, {}

    def snapshot(q, k_pages, v_pages, page_table, lengths, scale=None):
        seen.setdefault("lengths", lengths.clone())
        return cuda_paged_attention.paged_decode_attention(q, k_pages, v_pages, page_table,
                                                           lengths, scale)

    net.paged_attn_fn = snapshot
    for _ in range(64):
        if "lengths" in seen:
            break
        more_cycles(1)
    net.paged_attn_fn = cuda_paged_attention.paged_decode_attention

    while engine.live_lanes or engine.pending or engine._inflight:  # drain
        done.extend(engine.step())
    lat = np.array([c.admit_time - c.submit_time for c in window]) * 1e3
    lens = [len(c.response_tokens) for c in done]
    tokens_ok = all(((c.response_tokens >= 0) & (c.response_tokens < GEN_V)).all() for c in done)
    logp_ok = all(np.isfinite(c.behavior_logp).all() for c in done)
    emit("genrl_continuous", lanes=GEN_LANES, page_size=GEN_PAGE, steps_per_macro=GEN_MACRO,
         min_free_lanes=GEN_MIN_FREE, vocab=GEN_V, d_model=GEN_D, layers=GEN_LAYERS,
         prompt_max=GEN_P, response_budget=GEN_R, pages_capacity=engine.allocator.capacity,
         decode_tokens_per_s=cont_tokens / cont_s,
         cohort_decode_tokens_per_s=cohort_tokens / cohort_s,
         speedup_vs_cohort=(cont_tokens / cont_s) / max(cohort_tokens / cohort_s, 1e-9),
         cohort_rounds=cohort_rounds, cohort_s=cohort_s, arrival_rate_per_s=rate,
         warmup_s=warm_s, seconds=cont_s, macro_steps=macros, macro_step_ms=macro_s * 1e3,
         lane_occupancy_mean=occupancy,
         admission_latency_ms={f"p{q}": float(np.percentile(lat, q)) for q in (50, 95, 99)},
         completed_in_window=len(window), completed_total=len(done),
         prefix_tokens_saved=engine.prefix_tokens_saved - saved0,
         kernel_launches=launches, response_len_max=max(lens),
         response_len_mean=float(np.mean(lens)), reserved_after_drain=engine.allocator.reserved,
         shed_total=engine._batcher.shed_total, peak_mem_gib=peak, card=report["card"])
    emit("genrl_profile", macro_steps=pmacros, unprofiled_macro_step_s=macro_s,
         profiled_macro_step_s=profiled_s / pmacros,
         device_busy_s_per_macro_step=busy_s if kernels else None,
         device_busy_share=busy_s / macro_s if kernels else None,
         kernel_launches_per_macro_step=sum(n for _, _, n in kernels) / pmacros,
         paged_kernel_us_per_macro_step=paged_us,
         paged_kernel_share_of_device=paged_us / 1e6 / busy_s if kernels else None,
         top_kernels=[{"name": k[:90], "us_per_macro_step": us / pmacros,
                       "calls_per_macro_step": n / pmacros} for k, us, n in kernels[:12]],
         paged_kernel_us_per_call=paged_us / (GEN_MACRO * GEN_LAYERS),
         cprofile_macro_step_s=host_s / hmacros,
         host_top=[{"function": f, "cumulative_ms_per_macro_step": ct / hmacros * 1e3,
                    "calls_per_macro_step": n / hmacros} for f, ct, n in host_top],
         card=report["card"])
    if launches != GEN_MACRO * GEN_LAYERS * macros or macros == 0:
        raise AssertionError(f"paged kernel launches {launches} for {macros} macro steps")
    if "lengths" not in seen:
        raise AssertionError("no decode call in 64 cycles to snapshot the lanes' lengths from")
    mix = seen["lengths"].cpu()
    B, H, D = GEN_LANES, GEN_HEADS, GEN_D // GEN_HEADS
    inp = _paged_case(B, H, D, GEN_PAGE, GEN_PAGES_PER_LANE, GEN_NUM_PAGES, mix, seed=17,
                      dtype=torch.float32, shared=8)
    emit("paged_attn_engine_mix", lengths_mean=float(mix.float().mean()),
         lengths_max=int(mix.max()), lanes_at_length_1=int((mix == 1).sum()),
         in_path_us_per_call=paged_us / (GEN_MACRO * GEN_LAYERS),
         **_paged_timing(inp, mix, with_plain=False), card=report["card"])
    if max(lens) > GEN_R or not tokens_ok or not logp_ok or engine.allocator.reserved != 0:
        raise AssertionError(f"bad completions: max len {max(lens)}, tokens in vocab {tokens_ok}, "
                             f"finite logp {logp_ok}, reserved {engine.allocator.reserved}")
    del engine

    # temperature 0 at full width: the continuous engine (paged kernel)
    # token-identical to the cohort engine (dense masked attention)
    n = 8
    prompts, lengths = _prompts(np.random.default_rng(9), n)
    greedy = dict(base, temperature=0.0)
    ref = GenerationEngine(model, params, GenerationConfig(**greedy)).generate(prompts, lengths)
    eng0 = ContinuousEngine(model, params, _gen_config(temperature=0.0))
    for i in range(n):
        eng0.submit(prompts[i], lengths[i])
    by_prompt = {tuple(c.prompt.tolist()): c for c in eng0.run_until(n)}
    mismatched, logp_err, value_err = 0, 0.0, 0.0
    for i in range(n):
        c = by_prompt[tuple(prompts[i, :lengths[i]].tolist())]
        r = int(ref.response_len[i])
        same = len(c.response_tokens) == r and np.array_equal(c.response_tokens,
                                                               ref.response_tokens[i, :r])
        mismatched += int(not same)
        if same:
            logp_err = max(logp_err, float(np.abs(c.behavior_logp - ref.behavior_logp[i, :r]).max()))
            value_err = max(value_err, float(np.abs(c.values - ref.values[i, :r]).max()))
    emit("genrl_identity", prompts=n, response_lens=[int(x) for x in ref.response_len],
         mismatched_sequences=mismatched, logp_max_abs_err=logp_err, value_max_abs_err=value_err,
         tol=GEN_IDENTITY_LOGP_TOL)
    if mismatched or not logp_err <= GEN_IDENTITY_LOGP_TOL:
        raise AssertionError(f"temperature-0 identity: {mismatched} sequences differ, logp {logp_err}")


# Sequence-RL training plane (phases 14-16): bench.py's genrl width with the
# packed learner on
TRAIN_V, TRAIN_D, TRAIN_HEADS, TRAIN_LAYERS = 1024, 256, 8, 4
TRAIN_P, TRAIN_R, TRAIN_B = 128, 128, 64
TRAIN_PACK_LEN = 512
TRAIN_HEAD_DIM = TRAIN_D // TRAIN_HEADS
TRAIN_COHORT_S = 2.0  # 4 s before genrl_on_shards, 10 before phases 51-55, 15 before 43-45
TRAIN_CONTINUOUS_ROUNDS = 2  # 3 before phases 51-55 joined the script
TRAIN_LEARN_RATE_S = 1.0  # 1.5 s before genrl_on_shards, 3 before phases 51-55
# the segment kernels against the plain version in float32: the same
# arithmetic summed in another order (each warp's online softmax and sums
# over its 16 rows of a 64-row tile, the warps combined in order, against
# one softmax and two einsums); the JAX package pins its kernel to its
# reference at 2e-5 on values and 1e-5 on gradients of O(1) inputs.
# Gradients here are held relative to the largest reference gradient of the
# case
SEG_VALUE_TOL = 2e-5
SEG_GRAD_REL_TOL = 1e-4
# bfloat16 inputs: both sides accumulate in float32 and round each output to
# bfloat16 once (8 bits of mantissa: half a step is 2^-9 relative), so they
# may differ by one bfloat16 step of the largest output or gradient (2^-7
# relative), plus the plain version's own rounding of its float32 result
SEG_BF16_REL_TOL = 2.0 ** -6
# learn steps, kernel against dense masked attention, from the same state
# and batch on the card.  The gradients are held leaf by leaf, relative to
# each leaf's largest element: both paths sum the same float32 products in
# another order.  Adam's first step is lr * g / (|g| + eps), the sign of the
# gradient whatever its size, so the params are compared after a second step,
# whose moments carry the sizes; where a gradient element is within float
# noise of zero its step may still land up to lr either way, so the params
# are held by the relative L2 of the whole update
TOKEN_PPO_STEPS = 2
TOKEN_PPO_TOL = {"loss_rel": 1e-5, "grad_norm_rel": 1e-4, "metrics_abs": 1e-4,
                 "grad_leaf_rel": 1e-4, "update_rel_l2": 1e-3}


def _train_args(**kw):
    from scalerl_torch.config import GenRLArguments

    base = dict(vocab_size=TRAIN_V, prompt_len=TRAIN_P, max_new_tokens=TRAIN_R,
                d_model=TRAIN_D, n_layers=TRAIN_LAYERS, n_heads=TRAIN_HEADS,
                genrl_batch=TRAIN_B, genrl_sample_batch=TRAIN_B,
                genrl_buffer_sequences=2 * TRAIN_B, learner_packing=True,
                learner_packed_attn="pallas", learner_pack_len=TRAIN_PACK_LEN)
    return GenRLArguments(**{**base, **kw})


def _ragged_sequences(rng, B, p_range, r_range, V, behavior_p=(0.05, 0.5)):
    """True-length sequences as ``pack_learner_batch`` takes them; the
    behaviour probabilities are uniform over ``behavior_p``."""
    plens = rng.integers(p_range[0], p_range[1] + 1, B)
    rlens = rng.integers(r_range[0], r_range[1] + 1, B)
    return dict(
        prompts=[rng.integers(1, V, n).astype(np.int32) for n in plens],
        responses=[rng.integers(1, V, n).astype(np.int32) for n in rlens],
        behavior_logp=[np.log(rng.uniform(*behavior_p, n)).astype(np.float32) for n in rlens],
        values=[rng.normal(0, 0.1, n).astype(np.float32) for n in rlens],
        rewards=rng.uniform(0, 1, B).astype(np.float32),
        generations=np.zeros(B, np.int32), plens=plens, rlens=rlens,
    )


def _packed_rows(seqs, pack_len, row_cap):
    from scalerl_torch.genrl.rollout import pack_learner_batch
    from scalerl_torch.utils.buckets import bucket_for, default_buckets

    pk = pack_learner_batch(seqs["prompts"], seqs["responses"], seqs["behavior_logp"],
                            seqs["values"], seqs["rewards"], seqs["generations"], pack_len)
    return pk.bucketed(bucket_for(max(pk.rows, 1), default_buckets(row_cap)))


def _learn_step_fields(rng):
    """The token-PPO learn step's batch: 64 rows of 512 packed from
    sequences with prompts in [2, 128] and 128-token responses, 2-3
    segments a row; behaviour probabilities around a fresh model's
    near-uniform 1 / V, so the ratios sit inside and outside the clip
    range."""
    seqs = _ragged_sequences(rng, 3 * TRAIN_B, (2, TRAIN_P), (TRAIN_R, TRAIN_R), TRAIN_V,
                             behavior_p=(0.7 / TRAIN_V, 1.4 / TRAIN_V))
    fields, _ = _packed_rows(seqs, TRAIN_PACK_LEN, 2 * TRAIN_B).fields()
    return {k: v[:TRAIN_B] for k, v in fields.items()}


def _bench_learn_batches():
    """The packed and padded learn batches of bench.py's packed-learner
    phase on an accelerator: 64 sequences, prompt and response lengths
    uniform in [1, 64], rows of 256 bucketed up the pow2 ladder."""
    rng = np.random.default_rng(0)
    S = TRAIN_P + TRAIN_R
    seqs = _ragged_sequences(rng, TRAIN_B, (1, TRAIN_P // 2), (1, TRAIN_R // 2), TRAIN_V)
    pk = _packed_rows(seqs, S, TRAIN_B)
    tokens = np.zeros((TRAIN_B, S), np.int32)
    blogp = np.zeros((TRAIN_B, TRAIN_R), np.float32)
    bval = np.zeros((TRAIN_B, TRAIN_R), np.float32)
    mask = np.zeros((TRAIN_B, TRAIN_R), np.float32)
    for i in range(TRAIN_B):
        n, r = int(seqs["plens"][i]), int(seqs["rlens"][i])
        tokens[i, TRAIN_P - n:TRAIN_P] = seqs["prompts"][i]
        tokens[i, TRAIN_P:TRAIN_P + r] = seqs["responses"][i]
        blogp[i, :r] = seqs["behavior_logp"][i]
        bval[i, :r] = seqs["values"][i]
        mask[i, :r] = 1.0
    padded = dict(tokens=tokens, behavior_logp=blogp, value=bval, mask=mask,
                  reward=seqs["rewards"], prompt_len=seqs["plens"].astype(np.int32),
                  generation=seqs["generations"])
    return pk, padded, int(mask.sum())


def _live_pairs(seg: np.ndarray) -> int:
    """(query, key) pairs the segment rule keeps, per head: for a segment of
    length L, L * (L + 1) / 2."""
    total = 0
    for row in seg:
        ids, counts = np.unique(row[row > 0], return_counts=True)
        total += int(sum(int(c) * (int(c) + 1) // 2 for c in counts))
    return total


def _seg_case(seg: np.ndarray, H, D, dtype, seed, strided=False):
    import torch

    B, S = seg.shape
    g = torch.Generator().manual_seed(seed)
    if strided:  # q, k, v as the slices of one fused projection, as the model hands them over
        qkv = torch.randn(B, S, 3 * H * D, generator=g).to("cuda", dtype)
        q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(H * D, dim=-1))
    else:
        q, k, v = (torch.randn(B, S, H, D, generator=g).to("cuda", dtype) for _ in range(3))
    return dict(q=q, k=k, v=v, seg=torch.tensor(seg).cuda(),
                do=torch.randn(B, S, H, D, generator=g).to("cuda", dtype))


def _seg_check(name, case, report_cases):
    """Forward and backward through the kernels against the plain version in
    float32 on the same inputs; exact zeros on pad; two runs bit-equal."""
    import torch

    from scalerl_torch.ops import cuda_segment_attention as csa
    from scalerl_torch.ops.attention import segment_attention_reference

    def run(fn, cast):
        leaves = [cast(case[n]).detach().requires_grad_(True) for n in ("q", "k", "v")]
        out = fn(*leaves, case["seg"])
        return out, torch.autograd.grad(out, leaves, cast(case["do"]))

    o1, g1 = run(csa.segment_flash_attention, lambda t: t)
    o2, g2 = run(csa.segment_flash_attention, lambda t: t)
    ow, gw = run(segment_attention_reference, lambda t: t.float())
    torch.cuda.synchronize()
    bf16 = case["q"].dtype == torch.bfloat16
    pad = case["seg"] == 0
    o_err = (o1.float() - ow).abs().max().item()
    o_max = ow.abs().max().item()
    g_err = [(a.float() - b).abs().max().item() for a, b in zip(g1, gw)]
    g_max = max(b.abs().max().item() for b in gw)
    res = dict(case=name, shape=list(case["q"].shape), dtype=str(case["q"].dtype)[6:],
               contiguous=case["q"].is_contiguous(), o_max_abs_err=o_err,
               dq_max_abs_err=g_err[0], dk_max_abs_err=g_err[1], dv_max_abs_err=g_err[2],
               largest_gradient=g_max, pad_tokens=int(pad.sum()),
               pad_exact_zero=bool((o1[pad] == 0).all() and all((g[pad] == 0).all() for g in g1)),
               repeat_bit_equal=bool(torch.equal(o1, o2)
                                     and all(torch.equal(a, b) for a, b in zip(g1, g2))),
               finite=bool(torch.isfinite(o1).all() and all(torch.isfinite(g).all() for g in g1)))
    report_cases.append(res)
    if bf16:
        ok = (o_err <= SEG_BF16_REL_TOL * max(o_max, 1.0)
              and max(g_err) <= SEG_BF16_REL_TOL * max(g_max, 1.0))
    else:
        ok = o_err <= SEG_VALUE_TOL and max(g_err) <= SEG_GRAD_REL_TOL * max(g_max, 1.0)
    if not (ok and res["pad_exact_zero"] and res["repeat_bit_equal"] and res["finite"]):
        raise AssertionError(f"segment kernels off their plain version: {res}")
    return o_err, g_err[0], max(g_err[1:])  # by kernel: forward, dq, dk/dv


def _seg_times(seg_ids: np.ndarray, H: int, D: int, launches: int) -> dict:
    """The three segment kernels, each alone by CUDA-graph replay, at one
    packed batch (float32), beside the plain version, SDPA under the dense
    segment mask and both bounds (bytes; operations at the float32 peak)."""
    import torch
    import torch.nn.functional as F

    from scalerl_torch.models.transformer import packed_attention_mask
    from scalerl_torch.ops import cuda_segment_attention as csa
    from scalerl_torch.ops.attention import segment_attention_reference

    c = _seg_case(seg_ids, H, D, torch.float32, seed=100)
    q, k, v, seg, do = c["q"], c["k"], c["v"], c["seg"], c["do"]
    rows, S = seg_ids.shape
    scale = 1.0 / math.sqrt(D)
    o, lse = csa.segment_forward_kernel(q, k, v, seg, scale)
    dq, delta = csa.segment_dq_kernel(q, k, v, seg, o, lse, do, scale)
    pairs = _live_pairs(seg_ids) * H
    real_tokens = int((seg_ids > 0).sum())
    # The bytes this batch needs: a tensor that is read (q, k, v, o, do, lse,
    # delta) counts only at the real tokens, since pad rows of it never enter
    # the result; the ids and every tensor that is written count whole, pad
    # being stored as zeros (lse as -inf).  All float32.
    vec = real_tokens * H * D * 4  # one [., H, D] tensor at the real tokens
    vec_out = rows * S * H * D * 4  # one whole [rows, S, H, D] tensor
    stat = real_tokens * H * 4  # lse or delta at the real tokens
    stat_out = rows * H * S * 4  # lse or delta, whole
    ids = rows * S * 4
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    mask = packed_attention_mask(seg)[:, None]  # [rows, 1, S, S] bool

    def sdpa(qq, kk, vv):
        return F.scaled_dot_product_attention(qq.transpose(1, 2), kk.transpose(1, 2),
                                              vv.transpose(1, 2), attn_mask=mask).transpose(1, 2)

    def fwd_bwd(fn):
        out = fn(*leaves)
        torch.autograd.grad(out, leaves, do)

    # the plain version's and the library call's backward, each split as the
    # kernels split it (dq alone; dk and dv), by CUDA-graph replay like every
    # other time: the retained forward is made on the stream that captures
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        side_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        plain_out = segment_attention_reference(*side_leaves, seg)
        lib_out = sdpa(*side_leaves)
    torch.cuda.current_stream().wait_stream(side)
    real = (seg > 0)[:, :, None, None]
    lib_err = ((lib_out - plain_out) * real).abs().max().item()

    def bwd_ms(out, wrt):
        return gpu_time_ms(lambda: torch.autograd.grad(out, wrt, do, retain_graph=True), 10,
                           stream=side)

    fwd = _bound(3 * vec + vec_out + stat_out + ids, 4 * D * pairs, dict(
        ms=gpu_time_ms(lambda: csa.segment_forward_kernel(q, k, v, seg, scale), launches),
        eager_ms=eager_time_ms(lambda: csa.segment_forward_kernel(q, k, v, seg, scale), launches),
        plain_ms=gpu_time_ms(lambda: segment_attention_reference(q, k, v, seg), 10),
        plain_eager_ms=eager_time_ms(lambda: segment_attention_reference(q, k, v, seg), 10),
        library_ms=gpu_time_ms(lambda: sdpa(q, k, v), 10),
    ))
    # dq reads q, k, v, o, do, lse and writes dq, delta; s, dp and ds.k per pair
    dq_t = _bound(5 * vec + stat + vec_out + stat_out + ids, 6 * D * pairs, dict(
        ms=gpu_time_ms(lambda: csa.segment_dq_kernel(q, k, v, seg, o, lse, do, scale), launches),
        eager_ms=eager_time_ms(lambda: csa.segment_dq_kernel(q, k, v, seg, o, lse, do, scale), launches),
        plain_ms=bwd_ms(plain_out, side_leaves[:1]), library_ms=bwd_ms(lib_out, side_leaves[:1]),
    ))
    # dk/dv reads q, k, v, do, lse, delta and writes dk, dv; s, dp, p.do and ds.q per pair
    dkv_t = _bound(4 * vec + 2 * stat + 2 * vec_out + ids, 8 * D * pairs, dict(
        ms=gpu_time_ms(lambda: csa.segment_dkv_kernel(q, k, v, seg, lse, delta, do, scale), launches),
        eager_ms=eager_time_ms(lambda: csa.segment_dkv_kernel(q, k, v, seg, lse, delta, do, scale), launches),
        plain_ms=bwd_ms(plain_out, side_leaves[1:]), library_ms=bwd_ms(lib_out, side_leaves[1:]),
    ))
    whole = dict(
        plain_bwd_ms=bwd_ms(plain_out, side_leaves), library_bwd_ms=bwd_ms(lib_out, side_leaves),
        kernel_fwd_bwd_eager_ms=eager_time_ms(lambda: fwd_bwd(lambda a, b, cc: csa.segment_flash_attention(a, b, cc, seg)), 20),
        plain_fwd_bwd_eager_ms=eager_time_ms(lambda: fwd_bwd(lambda a, b, cc: segment_attention_reference(a, b, cc, seg)), 10),
        library_fwd_bwd_eager_ms=eager_time_ms(lambda: fwd_bwd(sdpa), 10),
        # forward + backward by the function's need: q, k, v, do read, o, dq,
        # dk, dv written, the ids; 4 D forward and 10 D backward per live pair
        fwd_bwd_bound_ms=max((4 * vec + 4 * vec_out + ids) / H100_BYTES_PER_S,
                             14 * D * pairs / H100_F32_OPS_PER_S) * 1e3,
    )
    return dict(shape={"rows": rows, "S": S, "heads": H, "head_dim": D,
                       "live_pairs_per_head": pairs // H, "real_tokens": real_tokens},
                forward=fwd, bwd_dq=dq_t, bwd_dkv=dkv_t,
                library_max_abs_err_on_real_tokens=lib_err, **whole)


def phase_segment_attn(report: dict) -> None:
    import torch

    from scalerl_torch.ops import cuda_segment_attention as csa

    set_tf32(False)
    H, D = TRAIN_HEADS, TRAIN_HEAD_DIM
    pk, _, _ = _bench_learn_batches()
    main_seg = pk.segment_ids  # [rows, 256], the bench's packed batch
    rng = np.random.default_rng(1)
    wide = _packed_rows(_ragged_sequences(rng, TRAIN_B, (2, TRAIN_P), (TRAIN_R, TRAIN_R), TRAIN_V),
                        TRAIN_PACK_LEN, TRAIN_B).segment_ids  # 2-3 segments per row of 512
    ragged = wide[:4, :333].copy()  # S not a multiple of either tile
    small = np.zeros((2, 19), np.int32)  # the JAX test's ragged tail
    small[0, :7] = 1
    small[1, :11], small[1, 11:19] = 1, 2
    all_pad = main_seg[:4].copy()
    all_pad[1] = 0
    cases = []
    worst = [0.0, 0.0, 0.0]  # float32 cases, by kernel: forward, dq, dk/dv
    for name, seg, heads, dim, dtype, strided in (
        ("main", main_seg, H, D, torch.float32, False),
        ("main_strided_views", main_seg, H, D, torch.float32, True),
        ("rows_of_512", wide, H, D, torch.float32, True),
        ("ragged_S_333", ragged, H, D, torch.float32, False),
        ("ragged_S_19_D_8", small, 2, 8, torch.float32, False),
        ("all_pad_row", all_pad, H, D, torch.float32, False),
        ("main_bf16", main_seg, H, D, torch.bfloat16, False),
        ("rows_of_512_bf16", wide[:8], H, D, torch.bfloat16, True),
    ):
        errs = _seg_check(name, _seg_case(seg, heads, dim, dtype, seed=len(cases), strided=strided),
                          cases)
        if dtype == torch.float32:
            worst = [max(w, e) for w, e in zip(worst, errs)]
    # wider heads, through all three kernels with gradients: 64 and 128 (DP
    # = 64 and 128; D = 8 above runs as DP = 32), float32 with strided views
    # and an all-pad row, and bfloat16
    for name, seg, heads, dim, dtype, strided in (
        ("rows_of_512_D64", wide[:16], 4, 64, torch.float32, True),
        ("all_pad_row_D64", all_pad, 4, 64, torch.float32, False),
        ("ragged_S_333_D64_bf16", ragged, 4, 64, torch.bfloat16, False),
        ("rows_of_512_D128", wide[:8], 2, 128, torch.float32, True),
        ("all_pad_row_D128", all_pad, 2, 128, torch.float32, False),
        ("ragged_S_333_D128_bf16", ragged, 2, 128, torch.bfloat16, False),
    ):
        errs = _seg_check(name, _seg_case(seg, heads, dim, dtype, seed=len(cases), strided=strided),
                          cases)
        if dtype == torch.float32:
            worst = [max(w, e) for w, e in zip(worst, errs)]
    # past the widest build a differentiable call is refused before any launch
    q136 = _seg_case(wide[:2], 1, 136, torch.float32, seed=99)["q"].requires_grad_(True)
    try:
        csa.segment_flash_attention(q136, q136, q136, torch.tensor(wide[:2]).cuda())
        raise AssertionError("a differentiable call at head dim 136 was not refused")
    except ValueError as exc:
        if f"{csa.MAX_HEAD_DIM}, the segment dq kernel" not in str(exc):
            raise

    # times at the bench's packed batch and at the learn step's rows of 512
    main = _seg_times(main_seg, H, D, 50)
    learn = _seg_times(_learn_step_fields(np.random.default_rng(2))["segment_ids"], H, D, 20)
    fwd, dq_t, dkv_t = main["forward"], main["bwd_dq"], main["bwd_dkv"]
    report["segment_attention_fwd"] = {"max_abs_err": worst[0], **fwd}
    report["segment_attention_bwd_dq"] = {"max_abs_err": worst[1], **dq_t}
    report["segment_attention_bwd_dkv"] = {"max_abs_err": worst[2], **dkv_t}
    emit("segment_attn", value_tol=SEG_VALUE_TOL, grad_rel_tol=SEG_GRAD_REL_TOL,
         bf16_rel_tol=SEG_BF16_REL_TOL, cases=cases, main_shape=main.pop("shape"), **main,
         learn_step=learn,
         backward_note="plain_ms and library_ms of bwd_dq are the plain version's and SDPA's "
         "backward for dq alone, those of bwd_dkv for dk and dv; plain_bwd_ms and "
         "library_bwd_ms for all three; all by CUDA-graph replay",
         library="F.scaled_dot_product_attention with the dense boolean mask "
         "(context only; the port never calls it)", card=report["card"])


def _token_ppo_compare(heads: int) -> None:
    """Full-width learn steps with ``heads`` heads of ``TRAIN_D // heads``
    from the same state and batch on the card, through the segment kernels
    and through the dense packed mask: the loss's gradients leaf by leaf,
    then the metrics and the parameters after two steps."""
    import torch

    from scalerl_torch.agents.token_ppo import TokenPPOAgent, token_ppo_packed_loss
    from scalerl_torch.ops import cuda_segment_attention as csa
    from scalerl_torch.trainer.sequence_rl import build_genrl_model

    fields = _learn_step_fields(np.random.default_rng(2))  # 64 rows of 512
    batch = {k: torch.tensor(v).cuda() for k, v in fields.items()}
    batch["is_weight"] = torch.rand(TRAIN_B, generator=torch.Generator().manual_seed(3)).cuda() * 0.7 + 0.3
    out = {}
    for impl in ("pallas", "xla"):
        args = _train_args(learner_packed_attn=impl, kl_cost=0.05, n_heads=heads)
        agent = TokenPPOAgent(args, build_genrl_model(args))
        params = {k: v.detach().requires_grad_(True) for k, v in agent.state.params.items()}
        loss, _ = token_ppo_packed_loss(
            params, agent.state.ref_params, agent.model, batch, clip_range=args.clip_range,
            value_cost=args.value_cost, entropy_cost=args.entropy_cost, kl_cost=args.kl_cost,
            adv_norm=args.adv_norm)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        before = torch.cat([v.reshape(-1) for v in agent.get_weights().values()])
        csa.fwd_launches = csa.dq_launches = csa.dkv_launches = 0
        for _ in range(TOKEN_PPO_STEPS):
            metrics = agent.learn(batch)
        after = torch.cat([v.reshape(-1) for v in agent.get_weights().values()])
        out[impl] = dict(metrics=metrics, grads=grads, update=(after - before).cpu(),
                         launches=(csa.fwd_launches, csa.dq_launches, csa.dkv_launches))
    k, p = out["pallas"], out["xla"]

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1.0)

    # each leaf's largest error over its largest element
    leaf_rel = {n: ((k["grads"][n] - g).abs().max() / g.abs().max().clamp(min=1e-30)).item()
                for n, g in p["grads"].items()}
    worst_leaf = max(leaf_rel, key=leaf_rel.get)
    errs = {
        "loss_rel": rel(k["metrics"]["total_loss"], p["metrics"]["total_loss"]),
        "grad_norm_rel": rel(k["metrics"]["grad_norm"], p["metrics"]["grad_norm"]),
        "metrics_abs": max(abs(k["metrics"][m] - p["metrics"][m]) for m in p["metrics"]
                           if m not in ("total_loss", "grad_norm")),
        "grad_leaf_rel": leaf_rel[worst_leaf],
        "update_rel_l2": ((k["update"] - p["update"]).norm() / p["update"].norm()).item(),
    }
    emit("token_ppo_learn", rows=TRAIN_B, pack_len=TRAIN_PACK_LEN, heads=heads,
         head_dim=TRAIN_D // heads, kl_cost=0.05, learn_steps=TOKEN_PPO_STEPS, **errs,
         grad_leaves=len(leaf_rel), grad_leaf_worst=worst_leaf,
         update_max_abs_err=(k["update"] - p["update"]).abs().max().item(),
         update_max_abs=p["update"].abs().max().item(), metrics_kernel=k["metrics"],
         metrics_dense=p["metrics"], kernel_launches=k["launches"], dense_launches=p["launches"],
         tol=TOKEN_PPO_TOL, tf32=False)
    # kl_cost > 0: the frozen reference's forward goes through the kernel too
    want = tuple(n * TRAIN_LAYERS * TOKEN_PPO_STEPS for n in (2, 1, 1))
    if k["launches"] != want or p["launches"] != (0, 0, 0):
        raise AssertionError(f"segment kernel launches {k['launches']} / {p['launches']}")
    bad = {m: e for m, e in errs.items() if not e <= TOKEN_PPO_TOL[m]}
    if bad or k["metrics"]["skipped_steps"] != 0.0:
        raise AssertionError(f"learn steps kernel vs dense off tolerance at head dim "
                             f"{TRAIN_D // heads}: {bad}")


def phase_token_ppo_learn(report: dict) -> None:
    """The learn-step comparison at the slice's 8 heads of 32, then at 4
    heads of 64 (the segment kernels' DP = 64 builds)."""
    set_tf32(False)
    for heads in (TRAIN_HEADS, TRAIN_HEADS // 2):
        _token_ppo_compare(heads)


def _zero_launch_counts():
    from scalerl_torch.ops import (
        cuda_flash_attention,
        cuda_paged_attention,
        cuda_per,
        cuda_segment_attention,
        cuda_vtrace,
    )

    cuda_flash_attention.fwd_launches = 0
    cuda_flash_attention.dq_launches = cuda_flash_attention.dkv_launches = 0
    cuda_vtrace.launches = 0
    cuda_per.sample_launches = cuda_per.update_launches = 0
    cuda_paged_attention.launches = 0
    cuda_segment_attention.fwd_launches = 0
    cuda_segment_attention.dq_launches = cuda_segment_attention.dkv_launches = 0


def _launch_counts() -> dict:
    from scalerl_torch.ops import (
        cuda_flash_attention,
        cuda_paged_attention,
        cuda_per,
        cuda_segment_attention,
        cuda_vtrace,
    )

    return {"vtrace": cuda_vtrace.launches, "per_sample": cuda_per.sample_launches,
            "per_update": cuda_per.update_launches,
            "paged_attention": cuda_paged_attention.launches,
            "segment_attention_fwd": cuda_segment_attention.fwd_launches,
            "segment_attention_bwd_dq": cuda_segment_attention.dq_launches,
            "segment_attention_bwd_dkv": cuda_segment_attention.dkv_launches,
            "flash_attention_fwd": cuda_flash_attention.fwd_launches,
            "flash_attention_bwd_dq": cuda_flash_attention.dq_launches,
            "flash_attention_bwd_dkv": cuda_flash_attention.dkv_launches}


def _gauge(name: str) -> float:
    from scalerl_torch.runtime import telemetry

    return telemetry.get_registry().gauge(name).value


def _train_window(trainer, seconds: float, min_rounds: int):
    """Rounds of ``trainer`` for ``seconds`` (at least ``min_rounds``), with
    every kernel's launch count zeroed just before and read just after."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seen0 = int(trainer.agent.state.tokens_seen)
    _zero_launch_counts()
    t0 = time.perf_counter()
    rounds = []
    while time.perf_counter() - t0 < seconds or len(rounds) < min_rounds:
        rounds.append(trainer.train_round())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    n = len(rounds)
    learn_tokens = int(trainer.agent.state.tokens_seen) - seen0
    decode_tokens = sum(m["decode_tokens"] for m in rounds)
    stats = dict(
        rounds=n, seconds=wall, rounds_per_s=n / wall, learn_steps=n, learn_steps_per_s=n / wall,
        learn_tokens=learn_tokens, learn_tokens_per_s=learn_tokens / wall,
        decode_tokens_per_s=decode_tokens / wall,
        real_token_frac_mean=float(np.mean([m["real_token_frac"] for m in rounds])),
        pad_ratio_last_insert=_gauge("genrl.pad_ratio"),
        round_reward_first=rounds[0]["round_reward"], round_reward_last=rounds[-1]["round_reward"],
        staleness_mean=float(np.mean([m["staleness"] for m in rounds])),
        skipped_steps=float(sum(m["skipped_steps"] for m in rounds)),
        losses_finite=all(math.isfinite(m["total_loss"]) for m in rounds),
        last_loss=rounds[-1]["total_loss"], launches=launches,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
    )
    return stats


def _check_train_window(name: str, stats: dict, continuous: bool) -> None:
    n, launches = stats["learn_steps"], stats["launches"]
    want = {k: TRAIN_LAYERS * n for k in ("segment_attention_fwd", "segment_attention_bwd_dq",
                                          "segment_attention_bwd_dkv")}
    want["per_sample"] = n
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{name}: kernel launches {got}, want {want} for {n} learn steps")
    if continuous and launches["paged_attention"] <= 0:
        raise AssertionError(f"{name}: the continuous rounds never launched the paged kernel")
    if not stats["losses_finite"] or stats["skipped_steps"] != 0.0:
        raise AssertionError(f"{name}: finite losses {stats['losses_finite']}, "
                             f"skipped {stats['skipped_steps']}")


def phase_genrl_train(report: dict) -> None:
    """The training slice's main path: ``SequenceRLTrainer`` at bench.py's
    genrl width with the packed learner through the segment kernels, on the
    cohort engine and for a few rounds on the continuous engine; then the
    packed against the padded learn rate, a profile, and two seeded runs."""
    import torch

    from scalerl_torch.agents.token_ppo import TokenPPOAgent
    from scalerl_torch.data.sequence_replay import seq_sample
    from scalerl_torch.genrl.task import TokenRecallTask
    from scalerl_torch.runtime.dispatch import MetricsPipeline
    from scalerl_torch.trainer.sequence_rl import SequenceRLTrainer, build_genrl_model

    set_tf32(False)

    def make_trainer(**kw):
        # ragged prompts: rows of 512 hold 2-3 sequences and a pad tail
        task = TokenRecallTask(vocab_size=TRAIN_V, prompt_len=(2, TRAIN_P), response_len=TRAIN_R)
        return SequenceRLTrainer(_train_args(**kw), task=task)

    trainer = make_trainer()
    t0 = time.perf_counter()
    for _ in range(2):  # warm-up: first allocations, the kernels' load
        trainer.train_round()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    cohort = _train_window(trainer, TRAIN_COHORT_S, 3)
    shape = dict(vocab=TRAIN_V, d_model=TRAIN_D, heads=TRAIN_HEADS, layers=TRAIN_LAYERS,
                 prompt_max=TRAIN_P, new_tokens=TRAIN_R, genrl_batch=TRAIN_B,
                 sample_batch_rows=TRAIN_B, pack_len=TRAIN_PACK_LEN, replay_rows=2 * TRAIN_B,
                 max_len=trainer.agent.model.max_len)
    emit("genrl_train", engine="cohort", **shape, warmup_s=warmup_s, **cohort,
         sync_debug_mode="error in warm rounds (insert, sample, learn) and in warm generation",
         card=report["card"])
    _check_train_window("cohort", cohort, continuous=False)
    for k in ("segment_attention_fwd", "segment_attention_bwd_dq", "segment_attention_bwd_dkv"):
        report["launches"][k] = cohort["launches"][k]
    report["genrl_train_cohort"] = cohort
    round_s = cohort["seconds"] / cohort["rounds"]

    # where a round's time goes: two more rounds under torch.profiler, and
    # three learn steps alone on a sampled batch
    def seg_us(kernels):
        return {n: sum(us for k, us, _ in kernels if n in k)
                for n in ("seg_fwd_kernel", "seg_bwd_dq_kernel", "seg_bwd_dkv_kernel")}

    prof_rounds = 2
    profiled_s, kernels = profile_device(lambda: [trainer.train_round() for _ in range(prof_rounds)])
    busy_s = sum(us for _, us, _ in kernels) / 1e6 / prof_rounds
    batch, _, _, weights = seq_sample(trainer.replay, trainer._sample_generator, TRAIN_B,
                                      method="pallas")
    batch = dict(batch, is_weight=weights)
    steps = 3
    trainer.agent.learn(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.agent.learn(batch)
    torch.cuda.synchronize()
    learn_step_s = (time.perf_counter() - t0) / steps
    _, lkernels = profile_device(lambda: [trainer.agent.learn(batch) for _ in range(steps)])
    learn_busy_s = sum(us for _, us, _ in lkernels) / 1e6 / steps
    seg_learn = seg_us(lkernels)
    emit("genrl_train_profile", rounds=prof_rounds, unprofiled_round_s=round_s,
         profiled_round_s=profiled_s / prof_rounds,
         device_busy_s_per_round=busy_s if kernels else None,
         device_busy_share=busy_s / round_s if kernels else None,
         kernel_launches_per_round=sum(n for _, _, n in kernels) / prof_rounds,
         top_kernels_round=[{"name": k[:90], "ms_per_round": us / 1e3 / prof_rounds,
                             "calls_per_round": n / prof_rounds} for k, us, n in kernels[:10]],
         learn_step_s=learn_step_s, learn_step_device_busy_s=learn_busy_s if lkernels else None,
         learn_step_device_busy_share=learn_busy_s / learn_step_s if lkernels else None,
         kernel_launches_per_learn_step=sum(n for _, _, n in lkernels) / steps,
         segment_kernels_us_per_learn_step={k: us / steps for k, us in seg_learn.items()},
         segment_kernels_share_of_learn_device_time=(
             sum(seg_learn.values()) / 1e6 / steps / learn_busy_s if lkernels else None),
         top_kernels_learn_step=[{"name": k[:90], "us_per_learn_step": us / steps,
                                  "calls_per_learn_step": n / steps} for k, us, n in lkernels[:10]],
         card=report["card"])
    del trainer, batch
    torch.cuda.empty_cache()

    # a few rounds on the continuous engine: the other bridge, and the paged kernel
    trainer = make_trainer(genrl_engine="continuous", genrl_page_size=GEN_PAGE,
                           genrl_macro_steps=GEN_MACRO)
    t0 = time.perf_counter()
    trainer.train_round()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    cont = _train_window(trainer, 0.0, TRAIN_CONTINUOUS_ROUNDS)
    emit("genrl_train", engine="continuous", **shape, lanes=TRAIN_B, page_size=GEN_PAGE,
         steps_per_macro=GEN_MACRO, warmup_s=warmup_s, **cont, card=report["card"])
    _check_train_window("continuous", cont, continuous=True)
    del trainer
    torch.cuda.empty_cache()

    # the packed against the padded learn rate on bench.py's mixed-length
    # batch: real response tokens per second of wall clock, metrics read
    # through a two-deep pipeline
    pk, padded, real_tokens = _bench_learn_batches()
    args = _train_args(learner_pack_len=0)
    agent = TokenPPOAgent(args, build_genrl_model(args))
    layouts = {"packed": {k: torch.tensor(v).cuda() for k, v in pk.fields()[0].items()},
               "padded": {k: torch.tensor(v).cuda() for k, v in padded.items()}}
    rates = {}
    for name, dev_batch in layouts.items():
        agent.learn(dev_batch)  # warm
        pipe = MetricsPipeline(depth=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < TRAIN_LEARN_RATE_S or n < 2:
            n += 1
            pipe.push(n, agent.learn_device(dev_batch))
        pipe.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rates[name] = dict(steps=n, seconds=wall, learn_steps_per_s=n / wall,
                           learn_tokens_per_s=n * real_tokens / wall,
                           rows=int(dev_batch["tokens"].shape[0]),
                           row_len=int(dev_batch["tokens"].shape[1]))
    emit("token_ppo_learn_rate", real_response_tokens=real_tokens, **rates,
         packed_over_padded=rates["packed"]["learn_tokens_per_s"] / rates["padded"]["learn_tokens_per_s"],
         card=report["card"])
    del agent, layouts
    torch.cuda.empty_cache()

    # two runs from one seed: the segment kernels repeat bit for bit, but the
    # embedding tables' gradients go through index_put_(accumulate=True),
    # whose float atomics may land in another order.  Measured, not required
    finals = []
    for _ in range(2):
        t = make_trainer(seed=11)
        for _ in range(2):
            m = t.train_round()
        finals.append((torch.cat([v.reshape(-1) for v in t.agent.get_weights().values()]).cpu(),
                       m["total_loss"]))
        del t
    diff = (finals[0][0] - finals[1][0]).abs().max().item()
    emit("genrl_train_repeat", rounds=2, seed=11, params_bit_equal=diff == 0.0,
         params_max_abs_diff=diff, last_loss=[finals[0][1], finals[1][1]])


# Transformer-policy IMPALA learner (phases 17-20): bench.py --mode sharded's
# accelerator width (bench.py:335-348) at dp=1
SHARD_D, SHARD_LAYERS, SHARD_HEADS = 1024, 8, 16
SHARD_T, SHARD_B, SHARD_OBS, SHARD_A = 16, 8, 64, 16
SHARD_HEAD_DIM = SHARD_D // SHARD_HEADS
SHARD_TRAIN_S = 2.0  # 4 s before genrl_on_shards, 10 before phases 51-55, 15 before 43-45
H100_BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
# the flash kernels against the plain version.  float32: the same products
# summed in another order (each warp of the micro-tile kernels sums over its
# 16 rows of a tile -- the forward's online softmax and dq over keys, dk/dv
# over queries -- and the warps combine in order; against one softmax and
# two einsums); the JAX package pins its kernel to its reference at 2e-5 on
# values.  lse is m + log(l) of the same sums.  Gradients are held relative
# to each gradient's largest element.  bfloat16 inputs: both sides
# accumulate in float32 (the plain version on the upcast inputs); the kernel
# rounds o, dq, dk, dv to bfloat16 once (half a step is 2^-9 relative) and
# reads o and do rounded, so they may differ by a step of the largest
# element (2^-7) and the plain version's own float32 noise: 2^-6 of the
# largest.  The tensor-core forward, dq and dk/dv
# also round P and dS to bfloat16 before their products (2^-9 relative each,
# independent errors that average over the keys); the CPU test of that
# arithmetic holds it inside the same 2^-6
FLASH_VALUE_TOL = 2e-5
FLASH_LSE_TOL = 2e-5
FLASH_GRAD_REL_TOL = 1e-4
FLASH_BF16_REL_TOL = 2.0 ** -6
# learn steps, flash kernels against the plain attention, from the same
# state and trajectory at the sharded width in float32 with TF32 off: the
# same arithmetic summed in another order; RMSProp's first step from nu = 0
# is ~lr * sign(g), so the update is compared after a second step
SHARD_LEARN_STEPS = 2
SHARD_LEARN_TOL = {"loss_rel": 1e-5, "grad_norm_rel": 1e-4, "grad_leaf_rel": 1e-4,
                   "update_rel_l2": 1e-3, "model_card_vs_host": MODEL_TOL}
# bf16_params: the plain attention rounds the scores q.k to bfloat16 before
# the float32 softmax (as the JAX full_attention does), the kernel keeps
# them in float32, and every block's output is rounded to bfloat16, so the
# two paths differ by bf16 rounding (2^-9 relative per rounding) compounded
# over 8 blocks and a backward pass.  The control holds each path against
# the float32 model on the same (upcast) params; on an H100 the plain path
# lay 2.1% of a leaf's largest gradient from it, the flash path 2.2%, and
# the two 2.2% (loss 1.4e-2) apart.  Held at 2^-5 on the loss and 2^-4 of
# each leaf's largest gradient (about 3x the readings), flash against plain
# and flash against float32; the bit-level check is the float32 one above
SHARD_BF16_TOL = {"loss_rel": 2.0 ** -5, "grad_leaf_rel": 2.0 ** -4,
                  "flash_vs_float32_grad_leaf_rel": 2.0 ** -4}
FLASH_STEP_TOL = {"loss_rel": 1e-5, "grad_leaf_rel": 1e-4}


def _flash_case(B, Tq, Tk, H, D, dtype, seed, strided=False):
    """q, k, v and a cotangent on the card; ``strided``: q, k, v as the
    slices of one fused projection, as the model hands them over."""
    import torch

    g = torch.Generator().manual_seed(seed)
    if strided:
        assert Tq == Tk
        qkv = torch.randn(B, Tq, 3 * H * D, generator=g).to("cuda", dtype)
        q, k, v = (t.reshape(B, Tq, H, D) for t in qkv.split(H * D, dim=-1))
    else:
        q = torch.randn(B, Tq, H, D, generator=g).to("cuda", dtype)
        k, v = (torch.randn(B, Tk, H, D, generator=g).to("cuda", dtype) for _ in range(2))
    return q, k, v, torch.randn(B, Tq, H, D, generator=g).to("cuda", dtype)


def _visible_pairs(Tq: int, Tk: int, causal: bool) -> int:
    """(query, key) pairs one (batch row, head) computes: key j is visible to
    query i iff j <= i under ``causal``."""
    if not causal:
        return Tq * Tk
    return sum(min(i + 1, Tk) for i in range(Tq))


def _flash_check(name, case, causal, report_cases):
    """Each kernel against the plain version in float32 on the same inputs:
    o, lse, dq, dk, dv; two runs bit-equal; causal row 0 finite and = v[0]."""
    import torch

    from scalerl_torch.ops import cuda_flash_attention as cfa
    from scalerl_torch.ops.attention import flash_attention_reference

    q, k, v, do = case
    scale = 1.0 / math.sqrt(q.shape[-1])

    def kernels():
        o, lse = cfa.flash_forward_kernel(q, k, v, scale, causal)
        return (o, lse) + cfa.flash_backward_kernels(q, k, v, o, lse, do, scale, causal)

    got, again = kernels(), kernels()
    leaves = [t.float().detach().requires_grad_(True) for t in (q, k, v)]
    ow, lw = flash_attention_reference(*leaves, causal, scale)
    gw = torch.autograd.grad(ow, leaves, do.float())
    torch.cuda.synchronize()
    o, lse, dq, dk, dv = got
    bf16 = q.dtype == torch.bfloat16
    o_err = (o.float() - ow).abs().max().item()
    o_max = ow.abs().max().item()
    lse_err = (lse - lw).abs().max().item()
    g_err = [(a.float() - b).abs().max().item() for a, b in zip((dq, dk, dv), gw)]
    g_max = [b.abs().max().item() for b in gw]
    res = dict(case=name, q=list(q.shape), k=list(k.shape), causal=causal,
               dtype=str(q.dtype)[6:], contiguous=q.is_contiguous(), o_max_abs_err=o_err,
               o_max=o_max, lse_max_abs_err=lse_err, dq_max_abs_err=g_err[0],
               dk_max_abs_err=g_err[1], dv_max_abs_err=g_err[2], largest_gradients=g_max,
               repeat_bit_equal=all(torch.equal(a, b) for a, b in zip(got, again)),
               finite=all(bool(torch.isfinite(t).all()) for t in got))
    if causal:
        res["row0_equals_v0"] = bool(torch.equal(o[:, 0], v[:, 0]))
    report_cases.append(res)
    if bf16:
        ok = (o_err <= FLASH_BF16_REL_TOL * max(o_max, 1.0)
              and all(e <= FLASH_BF16_REL_TOL * max(m, 1.0) for e, m in zip(g_err, g_max)))
    else:
        ok = (o_err <= FLASH_VALUE_TOL
              and all(e <= FLASH_GRAD_REL_TOL * max(m, 1.0) for e, m in zip(g_err, g_max)))
    ok = ok and lse_err <= FLASH_LSE_TOL and res["repeat_bit_equal"] and res["finite"]
    if not (ok and res.get("row0_equals_v0", True)):
        raise AssertionError(f"flash kernels off their plain version: {res}")
    # by kernel: forward (o and lse), dq, dk/dv
    return max(o_err, lse_err), g_err[0], max(g_err[1:])


def _flash_times(B, T, H, D, dtype, strided, launches):
    """Each kernel alone by CUDA-graph replay at one causal self-attention
    shape, beside the plain version, SDPA and the bounds.  The operations
    bound takes the card's peak for the inputs' type: the bf16 tensor-core
    rate for bfloat16, the float32 rate outside the tensor cores for
    float32 (the kernels compute exact float32; TF32 is another result)."""
    import torch
    import torch.nn.functional as F

    from scalerl_torch.ops import cuda_flash_attention as cfa
    from scalerl_torch.ops.attention import flash_attention_reference

    q, k, v, do = _flash_case(B, T, T, H, D, dtype, seed=100, strided=strided)
    scale = 1.0 / math.sqrt(D)
    o, lse = cfa.flash_forward_kernel(q, k, v, scale, True)
    dq, delta = cfa.flash_dq_kernel(q, k, v, o, lse, do, scale, True)
    pairs = _visible_pairs(T, T, True) * B * H
    vec = B * T * H * D * q.element_size()  # one [B, T, H, D] tensor
    stat = B * H * T * 4  # lse or delta
    peak = H100_BF16_OPS_PER_S if dtype == torch.bfloat16 else H100_F32_OPS_PER_S

    def sdpa(qq, kk, vv):
        return F.scaled_dot_product_attention(qq.transpose(1, 2), kk.transpose(1, 2),
                                              vv.transpose(1, 2), is_causal=True).transpose(1, 2)

    # the plain version's and SDPA's backward, split as the kernels split it,
    # from a forward retained on the stream that captures
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        side_leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        plain_out, _ = flash_attention_reference(*side_leaves, True, scale)
        lib_out = sdpa(*side_leaves)
    torch.cuda.current_stream().wait_stream(side)

    def bwd_ms(out, wrt, n):
        return gpu_time_ms(lambda: torch.autograd.grad(out, wrt, do, retain_graph=True), n,
                           stream=side)

    slow = max(launches // 10, 1)
    fwd = _bound(4 * vec + stat, 4 * D * pairs, dict(
        ms=gpu_time_ms(lambda: cfa.flash_forward_kernel(q, k, v, scale, True), launches),
        plain_ms=gpu_time_ms(lambda: flash_attention_reference(q, k, v, True, scale), slow),
        library_ms=gpu_time_ms(lambda: sdpa(q, k, v), launches)), peak)
    # dq reads q, k, v, o, do, lse and writes dq, delta
    dq_t = _bound(6 * vec + 2 * stat, 6 * D * pairs, dict(
        ms=gpu_time_ms(lambda: cfa.flash_dq_kernel(q, k, v, o, lse, do, scale, True), launches),
        plain_ms=bwd_ms(plain_out, side_leaves[:1], slow),
        library_ms=bwd_ms(lib_out, side_leaves[:1], launches)), peak)
    # dk/dv reads q, k, v, do, lse, delta and writes dk, dv
    dkv_t = _bound(6 * vec + 2 * stat, 8 * D * pairs, dict(
        ms=gpu_time_ms(lambda: cfa.flash_dkv_kernel(q, k, v, lse, delta, do, scale, True),
                       launches),
        plain_ms=bwd_ms(plain_out, side_leaves[1:], slow),
        library_ms=bwd_ms(lib_out, side_leaves[1:], launches)), peak)
    # each kernel's share of the bf16 tensor-core bound for its operations
    # (the fraction of the card's bf16 peak it reaches), whatever the type
    for t, ops in ((fwd, 4 * D * pairs), (dq_t, 6 * D * pairs), (dkv_t, 8 * D * pairs)):
        t["bf16_ops_bound_ms"] = ops / H100_BF16_OPS_PER_S * 1e3
        t["share_of_bf16_ops_bound"] = t["bf16_ops_bound_ms"] / t["ms"]
    return dict(shape=[B, T, H, D], dtype=str(dtype)[6:], strided_views=strided, ops_peak=peak,
                visible_pairs=pairs, forward=fwd, bwd_dq=dq_t, bwd_dkv=dkv_t,
                plain_bwd_ms=bwd_ms(plain_out, side_leaves, slow),
                library_bwd_ms=bwd_ms(lib_out, side_leaves, launches))


# the flash kernels' layouts: name, (B, Tq, Tk, H, D), dtype, causal, views
# of one fused projection; the first is the learner's
FLASH_LAYOUTS = [
    ("main_path", (SHARD_B, SHARD_T + 1, SHARD_T + 1, SHARD_HEADS, SHARD_HEAD_DIM), "bfloat16",
     True, True),
    ("T256_D64", (4, 256, 256, 2, 64), "float32", True, False),
    ("tpu_D128_causal", (2, 256, 256, 4, 128), "float32", True, False),
    ("tpu_D128_full", (2, 256, 256, 4, 128), "float32", False, False),
    ("tpu_ragged_T200", (1, 200, 200, 2, 128), "float32", True, False),
    ("tpu_bf16_D128", (2, 256, 256, 2, 128), "bfloat16", True, False),
    ("cross_24_56", (1, 24, 56, 2, 8), "float32", False, False),
    ("cross_256_1024_causal", (1, 256, 1024, 2, 64), "float32", True, False),
    ("cross_256_1024_full", (1, 256, 1024, 2, 64), "float32", False, False),
    ("D8", (2, 48, 48, 2, 8), "float32", True, False),
    ("D16_T100", (2, 100, 100, 2, 16), "float32", True, False),
    ("D32", (2, 48, 48, 2, 32), "float32", True, True),
    ("long_T4096_bf16", (1, 4096, 4096, 8, 64), "bfloat16", True, False),
    # the bfloat16 tensor-core kernels' edges: every padded head dim, ragged
    # and cross lengths, and views whose rows are not 16-byte aligned (the
    # odd heads of a D = 20 projection sit 8 bytes off, of D = 6 4 bytes, of
    # D = 7 2 bytes: each copy width the kernels take)
    ("bf16_D8", (2, 48, 48, 2, 8), "bfloat16", True, False),
    ("bf16_D16_T100", (2, 100, 100, 2, 16), "bfloat16", True, False),
    ("bf16_D32_views", (2, 48, 48, 2, 32), "bfloat16", True, True),
    ("bf16_D128_full", (2, 256, 256, 4, 128), "bfloat16", False, False),
    ("bf16_ragged_T200", (1, 200, 200, 2, 128), "bfloat16", True, False),
    ("bf16_cross_24_56_full", (1, 24, 56, 2, 8), "bfloat16", False, False),
    ("bf16_cross_24_56_causal", (1, 24, 56, 2, 8), "bfloat16", True, False),
    ("bf16_cross_256_1024_causal", (1, 256, 1024, 2, 64), "bfloat16", True, False),
    ("bf16_cross_256_1024_full", (1, 256, 1024, 2, 64), "bfloat16", False, False),
    ("bf16_D20_views_8B", (2, 40, 40, 4, 20), "bfloat16", True, True),
    ("bf16_D6_views_4B", (1, 20, 20, 2, 6), "bfloat16", True, True),
    ("bf16_D7_views_2B", (1, 20, 20, 3, 7), "bfloat16", True, True),
    # the float32 micro-tile kernels' narrower copies: the odd heads of a
    # D = 6 projection sit 8 bytes off 16, of D = 7 4 bytes
    ("f32_D6_views_8B", (1, 20, 20, 2, 6), "float32", True, True),
    ("f32_D7_views_4B", (1, 20, 20, 3, 7), "float32", True, True),
]
# timed causal self-attention shapes: name -> (B, T, H, D), dtype, views,
# launches per graph
FLASH_TIMED = {
    "main_path": ((SHARD_B, SHARD_T + 1, SHARD_HEADS, SHARD_HEAD_DIM), "bfloat16", True, 200),
    # the learner's float32 leg (bf16_params off, ImpalaArguments' default)
    "main_path_f32": ((SHARD_B, SHARD_T + 1, SHARD_HEADS, SHARD_HEAD_DIM), "float32", True, 200),
    "T256_f32": ((4, 256, 2, 64), "float32", False, 50),
    "T256_bf16": ((4, 256, 2, 64), "bfloat16", False, 50),
    "long_T4096_bf16": ((1, 4096, 8, 64), "bfloat16", False, 10),
    # the float32 kernels where operations, not latency, bound them
    "T1024_f32": ((2, 1024, 4, 64), "float32", False, 10),
}


def phase_flash_attn(report: dict) -> None:
    import torch

    from scalerl_torch.ops import cuda_flash_attention as cfa

    set_tf32(False)
    cases = []
    errs = {}
    for i, (name, shape, dtype, causal, strided) in enumerate(FLASH_LAYOUTS):
        case = _flash_case(*shape, getattr(torch, dtype), seed=i, strided=strided)
        errs[name] = _flash_check(name, case, causal, cases)
    # the autograd function routes the main path's views through the same
    # kernels: its output and gradients equal the direct calls bit for bit
    B, T1, _, H, D = FLASH_LAYOUTS[0][1]
    bf16 = torch.bfloat16
    q, k, v, do = _flash_case(B, T1, T1, H, D, bf16, seed=0, strided=True)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = cfa.flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(out, leaves, do)
    scale = 1.0 / math.sqrt(D)
    o, lse = cfa.flash_forward_kernel(q, k, v, scale, True)
    direct = (o,) + cfa.flash_backward_kernels(q, k, v, o, lse, do, scale, True)
    autograd_equal = all(torch.equal(a, b) for a, b in zip((out,) + grads, direct))
    if not autograd_equal:
        raise AssertionError("the autograd function differs from the direct kernel calls")

    times = {name: _flash_times(*shape, getattr(torch, dtype), strided, launches)
             for name, (shape, dtype, strided, launches) in FLASH_TIMED.items()}
    main = times["main_path"]
    # the kernels line reports the main path's shape and its case's errors
    for key, part, err in (("flash_attention_fwd", "forward", errs["main_path"][0]),
                           ("flash_attention_bwd_dq", "bwd_dq", errs["main_path"][1]),
                           ("flash_attention_bwd_dkv", "bwd_dkv", errs["main_path"][2])):
        report[key] = {"max_abs_err": err, **main[part]}
    emit("flash_attn", value_tol=FLASH_VALUE_TOL, lse_tol=FLASH_LSE_TOL,
         grad_rel_tol=FLASH_GRAD_REL_TOL, bf16_rel_tol=FLASH_BF16_REL_TOL, cases=cases,
         autograd_bit_equal_to_direct=autograd_equal, times=times,
         backward_note="plain_ms and library_ms of bwd_dq are the plain version's and SDPA's "
         "backward for dq alone, those of bwd_dkv for dk and dv; plain_bwd_ms and "
         "library_bwd_ms for all three; all by CUDA-graph replay",
         library="F.scaled_dot_product_attention(is_causal=True) (context only; the port "
         "never calls it)", card=report["card"])


def _shard_args(**kw):
    from scalerl_torch.config import ImpalaArguments

    base = dict(policy_arch="transformer", d_model=SHARD_D, n_layers=SHARD_LAYERS,
                n_heads=SHARD_HEADS, rollout_length=SHARD_T, batch_size=SHARD_B,
                use_lstm=False, use_pallas=True, max_timesteps=0)
    return ImpalaArguments(**{**base, **kw})


def _shard_traj(device, seed=0):
    """A synthetic [T+1, B] trajectory over flat observations, as bench.py's
    sharded mode makes it (done all False)."""
    import torch

    from scalerl_torch.data.trajectory import Trajectory

    g = torch.Generator().manual_seed(seed)
    T1 = SHARD_T + 1
    return Trajectory(
        obs=torch.randn(T1, SHARD_B, SHARD_OBS, generator=g).to(device),
        action=torch.randint(0, SHARD_A, (T1, SHARD_B), generator=g).to(device),
        reward=torch.randn(T1, SHARD_B, generator=g).to(device),
        done=torch.zeros(T1, SHARD_B, dtype=torch.bool, device=device),
        logits=torch.randn(T1, SHARD_B, SHARD_A, generator=g).to(device),
    )


def _shard_model(args, device="cuda"):
    """The learner's model as ``ImpalaAgent`` builds it: flash attention
    under ``args.use_pallas``."""
    import torch

    from scalerl_torch.models.transformer_policy import build_mp_policy

    return build_mp_policy(args, (SHARD_OBS,), SHARD_A, device=device,
                           generator=torch.Generator().manual_seed(args.seed))


def _flash_counts():
    from scalerl_torch.ops import cuda_flash_attention as cfa

    return (cfa.fwd_launches, cfa.dq_launches, cfa.dkv_launches)


def _learn_pair(args, traj, steps):
    """Two agents from one seed, with the kernels (``use_pallas``: flash
    attention and V-trace) and without: the loss's gradients leaf by leaf,
    then ``steps`` learn steps from the same state."""
    import torch

    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.ops import cuda_flash_attention as cfa

    out = {}
    for name, use_pallas in (("flash", True), ("plain", False)):
        agent = ImpalaAgent(dataclasses.replace(args, use_pallas=use_pallas), (SHARD_OBS,),
                            SHARD_A)
        model = agent.model
        # V-trace through its kernel on both sides: only the attention differs
        loss, grads = _impala_loss_grads(agent.state.params, model, traj, args, "kernel")
        learn = agent.make_learn_fn()
        before = torch.cat([v.float().reshape(-1) for v in agent.state.params.values()])
        cfa.fwd_launches = cfa.dq_launches = cfa.dkv_launches = 0
        state, losses = agent.state, []
        for _ in range(steps):
            state, metrics = learn(state, traj)
            losses.append(metrics)
        after = torch.cat([v.float().reshape(-1) for v in state.params.values()])
        out[name] = dict(loss=loss.item(), grads=grads, metrics=[
            {k: float(v) for k, v in m.items()} for m in losses], update=(after - before).cpu(),
            launches=_flash_counts(),
            dtypes={k: str(v.dtype)[6:] for k, v in state.params.items()},
            opt_dtypes=sorted({str(v.dtype)[6:] for v in state.opt_state["nu"].values()}))
        del agent, model, state
    return out["flash"], out["plain"]


def _float32_reference_grads(bargs, traj):
    """The bf16 learner's initial params, upcast, through the float32 model
    with the plain attention: the loss and gradients that both bf16 paths
    approximate."""
    f32 = _shard_model(dataclasses.replace(bargs, bf16_params=False, use_pallas=False))
    f32.load_state_dict(_shard_model(dataclasses.replace(bargs, use_pallas=False)).state_dict())
    loss, grads = _impala_loss_grads(dict(f32.named_parameters()), f32, traj, bargs, "kernel")
    return loss.item(), grads


def _leaf_rel(got: dict, want: dict) -> dict:
    """Each gradient leaf's largest error over its largest element."""
    return {n: ((got[n].float() - g.float()).abs().max()
                / g.float().abs().max().clamp(min=1e-30)).item() for n, g in want.items()}


def phase_transformer_learn(report: dict) -> None:
    """The learner at the sharded width, flash kernels against the plain
    attention: the model card vs host, the gradients leaf by leaf and two
    learn steps in float32; then the same under bf16_params."""
    import torch

    from scalerl_torch.models.transformer import TransformerPolicy

    set_tf32(False)
    args = _shard_args()
    traj = _shard_traj("cuda")

    # the model on the card (flash kernels) against the model on the host
    # (the flash op's plain version), one seed
    gpu = _shard_model(args)
    cpu = _shard_model(args, device="cpu")
    with torch.no_grad():
        want, _ = cpu(traj.obs.cpu(), None, None, None)
        got, _ = gpu(traj.obs, None, None, None)
    model_err = max((got.policy_logits.cpu() - want.policy_logits).abs().max().item(),
                    (got.baseline.cpu() - want.baseline).abs().max().item())
    params = sum(p.numel() for p in gpu.parameters())
    del gpu, cpu

    k, p = _learn_pair(args, traj, SHARD_LEARN_STEPS)
    leaf = _leaf_rel(k["grads"], p["grads"])
    worst = max(leaf, key=leaf.get)

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1.0)

    errs = {
        "loss_rel": rel(k["loss"], p["loss"]),
        "grad_norm_rel": rel(k["metrics"][0]["grad_norm"], p["metrics"][0]["grad_norm"]),
        "grad_leaf_rel": leaf[worst],
        "update_rel_l2": ((k["update"] - p["update"]).norm() / p["update"].norm()).item(),
        "model_card_vs_host": model_err,
    }
    want_launches = tuple(SHARD_LAYERS * SHARD_LEARN_STEPS for _ in range(3))
    f32 = dict(errs, grad_leaf_worst=worst, grad_leaves=len(leaf), loss=k["loss"],
               loss_plain=p["loss"], launches_flash=k["launches"], launches_plain=p["launches"])
    del k, p
    torch.cuda.empty_cache()

    # bf16_params: the dtypes of the layout and the optimizer state, finite
    # losses, and the flash path against the plain one at a bf16 tolerance
    bargs = _shard_args(bf16_params=True)
    kb, pb = _learn_pair(bargs, traj, SHARD_LEARN_STEPS)
    bleaf = _leaf_rel(kb["grads"], pb["grads"])
    bworst = max(bleaf, key=bleaf.get)
    float32_leaves = sorted(n for n, d in kb["dtypes"].items() if d == "float32")
    # float32 stay: the blocks' LayerNorm scales, final_norm and the heads
    layout_ok = (set(kb["dtypes"].values()) == {"bfloat16", "float32"}
                 and all(TransformerPolicy.keeps_float32(n[len("transformer."):])
                         for n in float32_leaves)
                 and kb["opt_dtypes"] == ["float32"] and kb["dtypes"] == pb["dtypes"])
    berrs = {"loss_rel": rel(kb["loss"], pb["loss"]), "grad_leaf_rel": bleaf[bworst]}
    # the control: how far each bf16 path lies from the float32 truth
    ref_loss, ref_grads = _float32_reference_grads(bargs, traj)
    control = {f"{n}_vs_float32": dict(loss_rel=rel(r["loss"], ref_loss),
                                       grad_leaf_rel=max(_leaf_rel(r["grads"], ref_grads).values()))
               for n, r in (("flash", kb), ("plain", pb))}
    berrs["flash_vs_float32_grad_leaf_rel"] = control["flash_vs_float32"]["grad_leaf_rel"]
    del ref_grads
    finite = all(math.isfinite(m["total_loss"]) and m["skipped_steps"] == 0.0
                 for m in kb["metrics"] + pb["metrics"])
    bf16 = dict(berrs, grad_leaf_worst=bworst, loss=kb["loss"], loss_plain=pb["loss"],
                float32_leaves=float32_leaves, optimizer_state_dtypes=kb["opt_dtypes"],
                layout_ok=layout_ok, losses_finite=finite, launches_flash=kb["launches"],
                metrics_flash=kb["metrics"], loss_float32=ref_loss, control=control)
    emit("transformer_learn", d_model=SHARD_D, layers=SHARD_LAYERS, heads=SHARD_HEADS,
         unroll=SHARD_T, batch=SHARD_B, obs_dim=SHARD_OBS, actions=SHARD_A, params=params,
         learn_steps=SHARD_LEARN_STEPS, float32=f32, bf16_params=bf16, tol=SHARD_LEARN_TOL,
         bf16_tol=SHARD_BF16_TOL, tf32=False)
    bad = {m: e for m, e in errs.items() if not e <= SHARD_LEARN_TOL[m]}
    bad.update({f"bf16_{m}": e for m, e in berrs.items() if not e <= SHARD_BF16_TOL[m]})
    if bad or not (layout_ok and finite):
        raise AssertionError(f"transformer learner flash vs plain: {bad}, layout {layout_ok}, "
                             f"finite {finite}")
    if f32["launches_flash"] != want_launches or f32["launches_plain"] != (0, 0, 0):
        raise AssertionError(f"flash launches {f32['launches_flash']} / {f32['launches_plain']}")


def _train_flops(params: int) -> int:
    """One learn step's FLOPs by an analytic count: 6 x params x tokens (a
    forward and a backward over every token, with the matmul of each weight
    twice in the backward) plus attention's scores and weighted sums, 4 x
    head_dim per visible (query, key) pair and head forward, twice that
    backward, in every layer."""
    T1 = SHARD_T + 1
    tokens = T1 * SHARD_B
    pairs = _visible_pairs(T1, T1, True) * SHARD_B * SHARD_HEADS
    return 6 * params * tokens + 3 * SHARD_LAYERS * 4 * SHARD_HEAD_DIM * pairs


def phase_transformer_train(report: dict) -> None:
    """The slice's main path: bench.py --mode sharded at dp=1 on one card,
    bf16 params with float32 heads and optimizer state, attention through
    the flash kernels, V-trace through its kernel; learn steps for
    ``SHARD_TRAIN_S`` on one synthetic trajectory with the metrics read two
    steps behind, warm steps under sync debug mode "error"."""
    import torch

    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.ops import cuda_vtrace
    from scalerl_torch.runtime.dispatch import MetricsPipeline, steady_state_guard

    set_tf32(False)
    args = _shard_args(bf16_params=True)
    agent = ImpalaAgent(args, (SHARD_OBS,), SHARD_A)
    params = sum(p.numel() for p in agent.state.params.values())
    traj = _shard_traj("cuda")
    t0 = time.perf_counter()
    for _ in range(2):  # warm-up: first allocations, the kernels' load
        agent.learn(traj)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    pipe = MetricsPipeline(depth=2)
    results = []
    steps = 0
    t0 = time.perf_counter()
    with steady_state_guard():
        while time.perf_counter() - t0 < SHARD_TRAIN_S or steps < 2:
            steps += 1
            results += pipe.push(steps, agent.learn_device(traj))
        results += pipe.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    per_step = {k: launches[k] / steps for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                                                 "flash_attention_bwd_dkv", "vtrace")}
    for k in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        report["launches"][k] = launches[k]
    peak = torch.cuda.max_memory_allocated() / 2**30
    finite = all(math.isfinite(m["total_loss"]) and m["skipped_steps"] == 0.0 for _, m in results)
    step_s = wall / steps
    flops = _train_flops(params)

    # where a step's time goes: three steps under torch.profiler
    prof_steps = 3
    profiled_s, kernels = profile_device(lambda: [agent.learn_device(traj)
                                                  for _ in range(prof_steps)])
    busy_s = sum(us for _, us, _ in kernels) / 1e6 / prof_steps
    flash_us = {n: sum(us for kk, us, _ in kernels if n in kk) / prof_steps
                for n in ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")}
    vtrace_us = sum(us for kk, us, _ in kernels if "vtrace_kernel" in kk) / prof_steps
    emit("transformer_train", d_model=SHARD_D, layers=SHARD_LAYERS, heads=SHARD_HEADS,
         unroll=SHARD_T, batch=SHARD_B, obs_dim=SHARD_OBS, actions=SHARD_A, params=params,
         bf16_params=True, use_flash=True, use_pallas=True, warmup_s=warmup_s, steps=steps,
         seconds=wall, steps_per_s=steps / wall,
         train_frames_per_s=steps * SHARD_T * SHARD_B / wall,
         learn_step_ms=step_s * 1e3, flops_per_step=flops,
         achieved_tflops=flops / step_s / 1e12,
         bf16_tensor_peak_share=flops / step_s / H100_BF16_OPS_PER_S,
         peak_mem_gib=peak, launches=launches, launches_per_step=per_step,
         losses_finite=finite, first_loss=results[0][1]["total_loss"],
         last_loss=results[-1][1]["total_loss"], sync_debug_mode="error in the warm steps",
         card=report["card"])
    emit("transformer_train_profile", steps=prof_steps, unprofiled_step_ms=step_s * 1e3,
         profiled_step_ms=profiled_s / prof_steps * 1e3,
         device_busy_ms_per_step=busy_s * 1e3 if kernels else None,
         device_busy_share=busy_s / step_s if kernels else None,
         kernel_launches_per_step=sum(n for _, _, n in kernels) / prof_steps,
         flash_us_per_step=flash_us, vtrace_us_per_step=vtrace_us,
         flash_share_of_device_time=(sum(flash_us.values()) / 1e6 / busy_s if kernels else None),
         top_kernels=[{"name": kk[:90], "us_per_step": us / prof_steps,
                       "calls_per_step": n / prof_steps} for kk, us, n in kernels[:12]],
         card=report["card"])
    want = {"flash_attention_fwd": SHARD_LAYERS, "flash_attention_bwd_dq": SHARD_LAYERS,
            "flash_attention_bwd_dkv": SHARD_LAYERS, "vtrace": 1}
    if per_step != want:
        raise AssertionError(f"launches per learn step {per_step}, want {want}")
    if not finite:
        raise AssertionError("non-finite loss or skipped step in the training window")


def phase_flash_train_step(report: dict) -> None:
    """The JAX package's own on-chip check (tests_tpu/test_compiled_kernels.py
    ::test_transformer_flash_train_step_on_tpu): one Adam step through a
    flash TransformerPolicy at T = 256 (the kernels' multi-tile path),
    against the same step with the plain attention, float32, TF32 off."""
    import torch
    import torch.nn.functional as F
    from torch.func import functional_call

    from scalerl_torch.agents.dqn import AdamOptimizer
    from scalerl_torch.models.transformer import TransformerPolicy

    set_tf32(False)
    obs = torch.randn(4, 256, 16, generator=torch.Generator().manual_seed(0)).cuda()
    actions = torch.zeros(4, 256, dtype=torch.long, device="cuda")
    out = {}
    for use_flash in (True, False):
        model = TransformerPolicy(num_actions=4, d_model=128, num_heads=2, num_layers=2,
                                  max_len=256, use_flash=use_flash, obs_dim=16,
                                  generator=torch.Generator().manual_seed(1))
        params = {k: v.detach().requires_grad_(True) for k, v in model.named_parameters()}
        before = _flash_counts()
        logits = functional_call(model, params, (obs,)).policy_logits
        logp = F.log_softmax(logits, dim=-1)
        loss = -logp.gather(-1, actions[..., None]).mean()
        # the value head takes no part in this loss: its gradients are zeros, as in JAX
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        opt = AdamOptimizer(1e-3)
        updates, _ = opt.update(grads, opt.init(params))
        new = {k: params[k].detach() + updates[k] for k in params}
        out[use_flash] = dict(loss=loss.item(), grads=grads, new=new,
                              launches=tuple(a - b for a, b in zip(_flash_counts(), before)))
    k, p = out[True], out[False]
    leaf = _leaf_rel(k["grads"], p["grads"])
    worst = max(leaf, key=leaf.get)
    errs = {"loss_rel": abs(k["loss"] - p["loss"]) / max(abs(p["loss"]), 1.0),
            "grad_leaf_rel": leaf[worst]}
    finite = math.isfinite(k["loss"]) and all(torch.isfinite(v).all() for v in k["new"].values())
    emit("flash_train_step", obs=[4, 256, 16], d_model=128, heads=2, layers=2, **errs,
         grad_leaf_worst=worst, loss=k["loss"], loss_plain=p["loss"], finite=bool(finite),
         launches_flash=k["launches"], launches_plain=p["launches"], tol=FLASH_STEP_TOL,
         tf32=False)
    bad = {m: e for m, e in errs.items() if not e <= FLASH_STEP_TOL[m]}
    if bad or not finite or k["launches"] != (2, 2, 2) or p["launches"] != (0, 0, 0):
        raise AssertionError(f"flash train step: {bad}, finite {finite}, "
                             f"launches {k['launches']} / {p['launches']}")


# ---------------------------------------------------------------------------
# The IMPALA entry point and the host plane (phases 26-29)
TRAINER_ITERS = 10  # DeviceActorLearnerTrainer's iterations a call
# the host-plane windows (HOST_TRAIN_S, APEX_TRAIN_S, R2D2_HOST_S, PDQN_TRAIN_S,
# PROC_TRAIN_S) were 20, 20, 15, 20, 20 s, then 12, 12, 10, 12, 12 s beside the
# remaining learners' phases; APEX_TRAIN_S, R2D2_HOST_S, PDQN_TRAIN_S and
# PROC_TRAIN_S are 8 s beside the serving phases, so the whole script stays
# inside its time limit; beside phases 51-55 HOST_TRAIN_S is 6 s (12 before)
# and PDQN_TRAIN_S and PROC_TRAIN_S 5 s; beside shard_compute APEX_TRAIN_S and
# R2D2_HOST_S are 6 s and PDQN_TRAIN_S and PROC_TRAIN_S 4 s
HOST_TRAIN_S = 6.0
HOST_PROFILE_STEPS = 1  # its trace holds ~70,000 kernels a learn step
DQN_RESUME_STEPS, DQN_RESUME_MORE, DQN_TRIP_K = 6_000, 4_000, 3


def _work_dir(name: str) -> str:
    """A fresh run root for ``name`` under the checkout's git-ignored
    ``work_dirs/``."""
    import shutil

    root = Path(__file__).resolve().parent / "work_dirs" / "chip_smoke" / name
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    return str(root)


def _example():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "train_impala_torch", Path(__file__).resolve().parent / "examples" / "train_impala_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _host_tree(tree) -> dict:
    """A tree's leaves as host copies, keyed by path (for bit comparisons)."""
    import torch

    from scalerl_torch.utils.checkpoint import flatten_tree

    return {p: (v.detach().cpu().clone() if isinstance(v, torch.Tensor) else np.asarray(v))
            for p, v in flatten_tree(tree)}


def _trees_bit_equal(a: dict, b: dict) -> list:
    """Paths where two ``_host_tree`` results differ (value, dtype or shape)."""
    import torch

    bad = sorted(set(a) ^ set(b))
    for p in set(a) & set(b):
        x, y = a[p], b[p]
        if isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.dtype == y.dtype and torch.equal(x, y)):
                bad.append(p)
        elif not np.array_equal(x, y) or np.asarray(x).dtype != np.asarray(y).dtype:
            bad.append(p)
    return bad


def _last_snapshot(run_dir: str) -> dict:
    with open(Path(run_dir) / "telemetry" / "telemetry.jsonl") as f:
        lines = f.read().splitlines()
    snap = json.loads(lines[-1])["snapshot"]
    return {"writes": len(lines), "rates": snap.get("rates"), "train": snap.get("train"),
            "checkpoint": snap.get("checkpoint"), "queue": snap.get("queue")}


def phase_impala_trainer_device(report: dict) -> None:
    """``examples/train_impala_torch.py``'s ``main()`` with ``--env-backend
    jax --env-id SyntheticPixel-v0`` at ImpalaArguments' defaults (the LSTM
    AtariNet, hidden 512, T=80, 8 envs, 10 iterations a call, the V-trace
    kernel): 2 calls and a save; the trainer's restore of that checkpoint
    bit-equal to what was saved; a second ``main()`` with ``--resume`` to a
    budget of 4 calls (20 V-trace launches, a ``.prev`` under
    ``checkpoint_keep_last`` 1); then a run stopped by SIGTERM from a timer
    thread, whose checkpoint holds the chunks done, resumed for 2 more."""
    import signal
    import threading

    import torch

    from scalerl_torch.config import ImpalaArguments, parse_args
    from scalerl_torch.envs.tensor_envs import make_tensor_vec_env
    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.ops import cuda_vtrace
    from scalerl_torch.trainer.actor_learner import DeviceActorLearnerTrainer

    set_tf32(True)  # PyTorch's defaults: TF32 convs, float32 matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    example = _example()
    root = _work_dir("impala_trainer_device")
    args0 = _default_args()
    per_call = args0.rollout_length * args0.num_envs * TRAINER_ITERS
    base = ["--env-backend", "jax", "--env-id", "SyntheticPixel-v0", "--use-pallas",
            "--logger-backend", "none", "--telemetry-interval-s", "2", "--work-dir", root,
            "--checkpoint-keep-last", "1", "--save-frequency", str(10**9)]

    def run(argv):
        cuda_vtrace.launches = 0
        t0 = time.perf_counter()
        out = example.main(base + argv)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, cuda_vtrace.launches

    out1, s1, launches1 = run(["--max-timesteps", str(2 * per_call)])
    run_dir, agent1 = out1["trainer"].work_dir, out1["agent"]
    saved = _host_tree({"agent": agent1.state, "env_frames": np.asarray(2 * per_call)})
    manifest = Path(out1["trainer"].resume_ckpt_path) / "integrity_manifest.json"

    # the trainer's own restore, as train() runs it, before the resumed run
    rargs = parse_args(ImpalaArguments, base + ["--resume", run_dir])
    venv = make_tensor_vec_env(rargs.env_id, rargs.num_envs)
    probe = DeviceActorLearnerTrainer(rargs, ImpalaAgent(rargs, venv.observation_shape,
                                                         venv.num_actions), venv)
    restored = _host_tree(probe.load_resume_checkpoint(probe._resume_pytree()))
    probe.close()
    restore_diff = _trees_bit_equal(restored, saved)

    out2, s2, launches2 = run(["--max-timesteps", str(4 * per_call), "--resume", run_dir])
    prev = Path(out2["trainer"].resume_ckpt_path + ".prev")
    snapshot = _last_snapshot(run_dir)

    # SIGTERM mid-run, a few chunks after the trainer's guard is in place:
    # the checkpoint records the chunks done
    done = threading.Event()

    def kill_when_guarded() -> None:
        while signal.getsignal(signal.SIGTERM) == signal.SIG_DFL:
            if done.wait(0.05):
                return
        if not done.wait(8.0):
            os.kill(os.getpid(), signal.SIGTERM)

    killer = threading.Thread(target=kill_when_guarded, daemon=True)
    killer.start()
    try:
        out3, s3, launches3 = run(["--max-timesteps", str(40 * per_call)])
    finally:
        done.set()
        killer.join()
    chunks3 = int(out3["result"]["chunks_done"])
    out4, s4, launches4 = run(["--max-timesteps", str((chunks3 + 2) * per_call), "--resume",
                               out3["trainer"].work_dir])
    frames = {"run": out1["result"]["env_frames"], "resumed": out2["result"]["env_frames"],
              "sigterm": out3["result"]["env_frames"], "sigterm_resumed":
              out4["result"]["env_frames"]}
    emit("impala_trainer_device", per_call=per_call, iters_per_call=TRAINER_ITERS,
         seconds={"run": s1, "resumed": s2, "sigterm": s3, "sigterm_resumed": s4},
         vtrace_launches={"run": launches1, "resumed": launches2, "sigterm": launches3,
                          "sigterm_resumed": launches4},
         env_frames=frames, resumed_env_frames_per_s=2 * per_call / s2,
         resumed_train_sps=out2["result"]["sps"], restore_mismatches=restore_diff,
         manifest=manifest.exists(), prev_after_resume=prev.exists(),
         sigterm_chunks_done=chunks3, learner_steps=int(out4["agent"].state.step),
         last_chunk=out2["result"], telemetry_last_snapshot=snapshot, card=report["card"])
    checks = {
        "restore bit-equal": not restore_diff,
        "manifest": manifest.exists(),
        "prev": prev.exists(),
        "launches = calls x iterations": (launches1, launches2, launches4)
        == (2 * TRAINER_ITERS, 2 * TRAINER_ITERS, 2 * TRAINER_ITERS),
        "frames": (frames["run"], frames["resumed"]) == (2 * per_call, 4 * per_call),
        "sigterm stopped early": 0 < chunks3 < 40 and launches3 == chunks3 * TRAINER_ITERS,
        "sigterm resumed": frames["sigterm_resumed"] == (chunks3 + 2) * per_call
        and int(out4["agent"].state.step) == (chunks3 + 2) * TRAINER_ITERS,
        "finite": all(math.isfinite(out2["result"][k]) for k in ("total_loss", "grad_norm"))
        and out2["result"]["skipped_steps"] == 0.0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"impala_trainer_device: {failed}")


def _pixel_ring_fns(n_actors: int):
    from scalerl_torch.envs.gym_env import SyncVectorView
    from scalerl_torch.envs.synthetic_gym import PixelRingEnv

    return [lambda: SyncVectorView([PixelRingEnv]) for _ in range(n_actors)]


def phase_impala_trainer_host(report: dict) -> None:
    """``HostActorLearnerTrainer`` in threads mode at ImpalaArguments'
    defaults (8 actors of 1 ``PixelRingEnv`` 84x84x4 each, batch 8, 32
    slots, the LSTM AtariNet, hidden 512, T=80, the V-trace kernel) for
    about ``HOST_TRAIN_S`` (stopped at the first log boundary past it), with
    the wall-clock ``CheckpointCadence`` at 5 s; then ``HOST_PROFILE_STEPS``
    learn steps of a fresh run under ``torch.profiler`` for the device's
    busy share."""
    import torch

    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.ops import cuda_vtrace
    from scalerl_torch.runtime import telemetry
    from scalerl_torch.trainer.actor_learner import HostActorLearnerTrainer

    set_tf32(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    root = _work_dir("impala_trainer_host")
    args = _default_args(env_id="PixelRing-v0", logger_backend="none", work_dir=root,
                         telemetry_interval_s=2.0, checkpoint_interval_s=5.0,
                         save_frequency=10**9, logger_frequency=640)
    if (args.num_actors, args.num_buffers) != (8, 32):
        raise AssertionError(f"ImpalaArguments' host-plane defaults moved: {args}")
    reg = telemetry.get_registry()
    errors0 = reg.counter("queue.actor_errors").value
    agent = ImpalaAgent(args, (84, 84, 4), 6)
    trainer = HostActorLearnerTrainer(args, agent, _pixel_ring_fns(args.num_actors))
    saves = []
    save_resume = trainer.save_resume
    trainer.save_resume = lambda: (saves.append(trainer.stop_event.is_set()), save_resume())
    log = trainer.log
    t0 = time.perf_counter()

    def log_and_stop(step, kind, m):
        log(step, kind, m)
        if time.perf_counter() - t0 >= HOST_TRAIN_S:
            trainer.stop_event.set()

    trainer.log = log_and_stop
    cuda_vtrace.launches = 0
    result = trainer.train(total_frames=10**9)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = cuda_vtrace.launches
    stats = trainer.queue.stats()
    trainer.close()
    losses = [m["total_loss"] for _, kind, m in trainer.log_history if kind == "train"]
    actor_timings = {k: v * 1e3 for k, v in trainer.actors[0].timings.means().items()}
    learn_timings = {k: v * 1e3 for k, v in trainer.learn_timings.means().items()}

    # the device's busy share over a few learn steps of the same plane
    args_p = _default_args(env_id="PixelRing-v0", logger_backend="none", work_dir=root,
                           telemetry_interval_s=0.0, save_model=False)
    agent_p = ImpalaAgent(args_p, (84, 84, 4), 6)
    agent_p.state = agent.state
    prof_trainer = HostActorLearnerTrainer(args_p, agent_p, _pixel_ring_fns(args_p.num_actors))
    frames = HOST_PROFILE_STEPS * args_p.rollout_length * args_p.batch_size
    profiled_s, kernels = profile_device(lambda: prof_trainer.train(total_frames=frames))
    prof_trainer.close()
    busy_s = sum(us for _, us, _ in kernels) / 1e6
    vt = [(us, n) for k, us, n in kernels if "vtrace_kernel" in k]
    # the serving trainer's phase prints its rates beside these
    report["impala_trainer_host"] = dict(
        env_frames_per_s=result["env_frames"] / seconds,
        learn_steps_per_s=trainer.learn_steps / seconds,
        device_busy_share=busy_s / profiled_s if kernels else None)
    emit("impala_trainer_host", actors=args.num_actors, envs_per_actor=1, T=args.rollout_length,
         batch=args.batch_size, num_buffers=args.num_buffers, seconds=seconds,
         env_frames=result["env_frames"], env_frames_per_s=result["env_frames"] / seconds,
         learn_steps=trainer.learn_steps, learn_steps_per_s=trainer.learn_steps / seconds,
         vtrace_launches=launches, skipped_steps=result.get("skipped_steps"),
         actor_errors=reg.counter("queue.actor_errors").value - errors0,
         actor_restarts=trainer.actor_restarts, cadence_saves=saves.count(False),
         final_saves=saves.count(True), queue_stats=stats, logged_losses=len(losses),
         actor_ms_per_slot=actor_timings, learner_ms_per_step=learn_timings,
         episodes=result.get("episodes"), return_mean=result.get("return_mean"),
         telemetry_last_snapshot=_last_snapshot(trainer.work_dir), card=report["card"])
    emit("impala_trainer_host_profile", learn_steps=HOST_PROFILE_STEPS, profiled_s=profiled_s,
         device_busy_s=busy_s, device_busy_share=busy_s / profiled_s if kernels else None,
         kernel_launches=sum(n for _, _, n in kernels),
         vtrace_us_per_call=sum(us for us, _ in vt) / sum(n for _, n in vt) if vt else None,
         top_kernels=[{"name": k[:90], "ms": us / 1e3, "calls": n} for k, us, n in kernels[:10]],
         card=report["card"])
    checks = {
        "launches = learn steps": launches == trainer.learn_steps > 0,
        "finite losses": bool(losses) and all(math.isfinite(x) for x in losses),
        "no skipped steps": result.get("skipped_steps") == 0.0,
        "no actor errors": reg.counter("queue.actor_errors").value == errors0
        and trainer.actor_restarts == 0,
        "a cadence save": saves.count(False) >= 1,
        "profile shows V-trace": bool(vt),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"impala_trainer_host: {failed}")


def phase_learn_cartpole_host(report: dict) -> None:
    """The reference's ``impala_cartpole`` recipe on the host plane
    (``tools/torch_learning_curves.py``'s ``cartpole_host``: 2 actors x 8
    ``TensorCartPole`` envs on the CPU, the learner and central inference on
    the card, the V-trace kernel): 400 within 400,000 frames at seed 0."""
    import torch

    from scalerl_torch.ops import cuda_vtrace
    from tools.torch_learning_curves import REFERENCE_FRAMES, TASKS

    set_tf32(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_vtrace.launches = 0
    row = TASKS["cartpole_host"](seed=0, work_dir=_work_dir("learn_cartpole_host"))
    launches = cuda_vtrace.launches
    emit("learn_cartpole_host", **row, required=True,
         reference_frames=REFERENCE_FRAMES["cartpole_host"], vtrace_launches=launches,
         card=report["card"])
    if launches != row["learner_steps"] or row["skipped_steps"] != 0.0 or not row["passed"]:
        raise AssertionError(f"cartpole_host: launches {launches}, {row}")


def phase_dqn_resume(report: dict) -> None:
    """``OffPolicyTrainer`` for DQN with PER at ``dqn_per``'s configuration:
    ``DQN_RESUME_STEPS`` env steps and a save; a second trainer with
    ``--resume`` restores the agent and the replay (plane, priorities,
    cursors) bit-equal to what was saved and runs ``DQN_RESUME_MORE`` more
    with the divergence tripwire on (K = ``DQN_TRIP_K``), where K batches in
    a row get NaN rewards: the guard skips them and the tripwire restores
    the last good checkpoint, with finite parameters after."""
    import torch

    from scalerl_torch.agents.dqn import DQNAgent
    from scalerl_torch.ops import cuda_per
    from scalerl_torch.trainer.off_policy import OffPolicyTrainer

    set_tf32(False)
    root = _work_dir("dqn_resume")
    kw = dict(use_pallas=True, warmup_learn_steps=2000, train_frequency=PER_NUM_ENVS,
              eval_frequency=10**9, logger_backend="none", telemetry_interval_s=0.0,
              save_frequency=10**9, work_dir=root)
    args_a = _dqn_args(max_timesteps=DQN_RESUME_STEPS, **kw)
    envs = CartPoleVectorView(PER_NUM_ENVS)
    agent_a = DQNAgent(args_a, envs.single_observation_space.shape, envs.single_action_space.n)
    trainer_a = OffPolicyTrainer(args_a, agent_a, envs)
    t0 = time.perf_counter()
    trainer_a.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    saved = _host_tree(trainer_a._resume_pytree())
    trainer_a.close()

    args_b = _dqn_args(max_timesteps=DQN_RESUME_STEPS + DQN_RESUME_MORE, resume=trainer_a.work_dir,
                       divergence_rollback_steps=DQN_TRIP_K, **kw)
    agent_b = DQNAgent(args_b, envs.single_observation_space.shape, envs.single_action_space.n)
    trainer_b = OffPolicyTrainer(args_b, agent_b, CartPoleVectorView(PER_NUM_ENVS))
    t0 = time.perf_counter()
    restored_ok = trainer_b.try_resume()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    steps_restored = trainer_b.global_step
    trainer_b.resuming = False  # restored above
    restore_diff = _trees_bit_equal(_host_tree(trainer_b._resume_pytree()), saved)
    learn0 = trainer_b.learn_steps

    sample = trainer_b.sampler.sample
    poison = {"left": 0, "calls": 0}

    def poisoned(*a, **k):
        batch = sample(*a, **k)
        poison["calls"] += 1
        if poison["calls"] == 50:
            poison["left"] = DQN_TRIP_K
        if poison["left"] > 0:
            poison["left"] -= 1
            batch = dict(batch, reward=batch["reward"] * float("nan"))
        return batch

    trainer_b.sampler.sample = poisoned
    cuda_per.sample_launches = cuda_per.update_launches = 0
    t0 = time.perf_counter()
    trainer_b.run()
    torch.cuda.synchronize()
    cont_s = time.perf_counter() - t0
    steps_b = poison["calls"]
    finite = all(bool(torch.isfinite(v).all()) for v in agent_b.state.params.values())
    trainer_b.close()
    emit("dqn_resume", env_steps_saved=int(saved["['global_step']"]),
         learn_steps_saved=int(saved["['learn_steps']"]), run_s=run_s, restore_s=restore_s,
         continue_s=cont_s, restored=restored_ok, restore_mismatches=restore_diff,
         replay_leaves=sum(1 for p in saved if p.startswith("['replay']")),
         learn_steps_continued=steps_b, trips=trainer_b.tripwire.trips,
         skipped_steps=float(trainer_b.skipped_steps), params_finite=finite,
         final_env_steps=trainer_b.global_step,
         per_launches={"sample": cuda_per.sample_launches, "update": cuda_per.update_launches},
         card=report["card"])
    checks = {
        "restored": restored_ok and steps_restored == int(saved["['global_step']"])
        and learn0 == int(saved["['learn_steps']"]),
        "bit-equal": not restore_diff,
        "tripwire": trainer_b.tripwire.trips == 1
        and float(trainer_b.skipped_steps) == float(DQN_TRIP_K),
        "finite": finite,
        "kernels": cuda_per.sample_launches == cuda_per.update_launches == steps_b > 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"dqn_resume: {failed}")


RAINBOW_TOL = {"loss_rel": 1e-5, "grad_leaf_rel": 1e-4, "host_rel": 1e-4}
APEX_TRAIN_S, R2D2_HOST_S = 4.5, 3.0  # 8, 8 s before shard_compute; R2D2 6 before genrl_on_shards; 6, 4 before serving_on_shards
R2D2_DEVICE_ITERS, R2D2_PROFILE_ITERS = 40, 5  # 60 before serving_on_shards, 80 before genrl_on_shards, 120 before shard_compute, 300 before 51-55


def _leaf_rel_err(got: dict, want: dict) -> float:
    """The largest over leaves of max |got - want| / max |want|."""
    return max(float((got[k].cpu() - w.cpu()).abs().max() / w.abs().max().clamp_min(1e-30))
               for k, w in want.items())


def phase_dqn_rainbow_learn(report: dict) -> None:
    """One full-width learn step (QNet 128,128, batch 512 from a 65,536 x 16
    replay) for C51 and for noisy dueling DQN, each with ``use_pallas`` on
    (the PER kernels sample and write back) and off (the plain versions, the
    sample in the kernels' order of sums), and on the host from the same
    batch; one fixed noise draw in every leg.  Indices equal; the loss within
    ``RAINBOW_TOL["loss_rel"]`` and each leaf's gradient (Adam's first moment
    after one step) within ``grad_leaf_rel`` of its largest between the
    card's legs, and within ``host_rel`` card against host."""
    import dataclasses

    import torch

    from unittest import mock

    from scalerl_torch.agents.dqn import DQNAgent
    from scalerl_torch.data.prioritized import per_sample_from_uniforms
    from scalerl_torch.data.sampler import Sampler
    from scalerl_torch.ops import cuda_per, per

    set_tf32(False)
    g = torch.Generator(device="cuda").manual_seed(11)
    shape = (PER_CAPACITY, PER_NUM_ENVS)
    done = torch.rand(shape, generator=g, device="cuda") < 0.05
    contents = dict(
        obs=torch.randn(shape + (4,), generator=g, device="cuda"),
        next_obs=torch.randn(shape + (4,), generator=g, device="cuda"),
        action=torch.randint(0, 2, shape, generator=g, device="cuda"),
        reward=torch.rand(shape, generator=g, device="cuda") * 2,
        done=done, boundary=done | (torch.rand(shape, generator=g, device="cuda") < 0.01))
    priorities = torch.rand(shape, generator=g, device="cuda") * 2 + 0.05
    u = torch.rand(PER_BATCH, generator=g, device="cuda")
    variants = {"c51": dict(categorical_dqn=True, num_atoms=51, v_min=0.0, v_max=200.0),
                "noisy_dueling": dict(noisy_dqn=True, dueling_dqn=True)}
    results = {}
    for variant, kw in variants.items():
        legs = {}
        for leg, use_pallas in (("plain", False), ("kernel", True)):
            args = _dqn_args(use_pallas=use_pallas, **kw)
            agent = DQNAgent(args, (4,), 2)
            noise = agent.network.sample_noise(torch.Generator(device="cuda").manual_seed(3))
            agent.network.sample_noise = lambda _g, noise=noise: noise
            sampler = Sampler((4,), PER_CAPACITY, PER_NUM_ENVS, use_per=True,
                              per_alpha=args.per_alpha, n_step=PER_N_STEP, gamma=args.gamma,
                              use_pallas=use_pallas)
            state = sampler.buffer.state
            for k, v in contents.items():
                state.replay.storage[k].copy_(v)
            state.priorities.copy_(priorities)
            sampler.buffer.state = dataclasses.replace(
                state, replay=dataclasses.replace(state.replay, pos=4321, size=PER_CAPACITY))
            cuda_per.sample_launches = cuda_per.update_launches = 0
            with mock.patch.object(per, "hierarchical_sample",
                                   lambda p, t, bs: per.kernel_order_sample(p, t, bs)[0]):
                batch = per_sample_from_uniforms(sampler.buffer.state, u, args.per_alpha,
                                                 args.per_beta, PER_N_STEP, args.gamma,
                                                 sampler.buffer.sample_method)
            metrics, td_abs = agent.learn_device(batch)
            sampler.update_priorities(batch["indices"], td_abs + 1e-6)
            torch.cuda.synchronize()
            legs[leg] = dict(batch=batch, loss=float(metrics["loss"]),
                             grads={k: v / 0.1 for k, v in agent.state.opt_state["mu"].items()},
                             plane=sampler.buffer.state.priorities.clone(),
                             launches=(cuda_per.sample_launches, cuda_per.update_launches),
                             noise=noise, args=args)
        plain, kern = legs["plain"], legs["kernel"]
        host = DQNAgent(plain["args"], (4,), 2, device="cpu")
        host_noise = [tuple(e.cpu() for e in pair) for pair in plain["noise"]]
        host.network.sample_noise = lambda _g: host_noise
        h_metrics, _ = host.learn_device({k: v.cpu() for k, v in plain["batch"].items()})
        h_grads = {k: v / 0.1 for k, v in host.state.opt_state["mu"].items()}
        res = {
            "index_mismatches": int((plain["batch"]["indices"] != kern["batch"]["indices"]).sum()),
            "loss": {"plain": plain["loss"], "kernel": kern["loss"],
                     "host": float(h_metrics["loss"])},
            "loss_rel_kernel_vs_plain": abs(kern["loss"] - plain["loss"]) / abs(plain["loss"]),
            "grad_leaf_rel_kernel_vs_plain": _leaf_rel_err(kern["grads"], plain["grads"]),
            "plane_max_abs_err": float((kern["plane"] - plain["plane"]).abs().max()),
            "loss_rel_card_vs_host": abs(plain["loss"] - float(h_metrics["loss"]))
            / abs(float(h_metrics["loss"])),
            "grad_leaf_rel_card_vs_host": _leaf_rel_err(plain["grads"], h_grads),
            "launches_kernel_leg": kern["launches"], "launches_plain_leg": plain["launches"],
            "leaves": len(plain["grads"]),
        }
        results[variant] = res
    emit("dqn_rainbow_learn", batch=PER_BATCH, replay=list(shape), tol=RAINBOW_TOL,
         variants=results, tf32=False, card=report["card"])
    bad = {v: r for v, r in results.items() if (
        r["index_mismatches"] or r["loss_rel_kernel_vs_plain"] > RAINBOW_TOL["loss_rel"]
        or r["grad_leaf_rel_kernel_vs_plain"] > RAINBOW_TOL["grad_leaf_rel"]
        or r["plane_max_abs_err"] > DQN_LEARN_TOL
        or r["loss_rel_card_vs_host"] > RAINBOW_TOL["host_rel"]
        or r["grad_leaf_rel_card_vs_host"] > RAINBOW_TOL["host_rel"]
        or r["launches_kernel_leg"] != (1, 1) or r["launches_plain_leg"] != (0, 0))}
    if bad:
        raise AssertionError(f"dqn_rainbow_learn: {bad}")


def _example_module(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parent / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sigterm_after(seconds: float, started):
    """A thread that sends SIGTERM ``seconds`` after ``started`` is set and
    the trainer's guard is installed; returns (thread, done event)."""
    import signal
    import threading

    done = threading.Event()

    def kill() -> None:
        while not started.is_set() or signal.getsignal(signal.SIGTERM) == signal.SIG_DFL:
            if done.wait(0.05):
                return
        if not done.wait(seconds):
            os.kill(os.getpid(), signal.SIGTERM)

    thread = threading.Thread(target=kill, daemon=True)
    thread.start()
    return thread, done


def phase_apex_train(report: dict) -> None:
    """``examples/train_apex_torch.py``'s ``main()`` at ``ApexArguments``'
    defaults (4 actors, QNet 128,128, T=20) with 3-step returns
    (``--n-steps 3``; the default is 1) and ``--use-pallas``,
    16 ``TensorCartPole`` envs an actor stepped on the CPU (slabs of 288),
    ``--buffer-size`` 2^20 (3,640 rows of 288 = 1,048,320 transitions, the
    plane the PER kernels are timed on) and batch 512, stopped by SIGTERM
    after ``APEX_TRAIN_S`` (the guard saves the resume checkpoint); every
    kernel's launch count zeroed just before.  Then a trainer with
    ``--resume`` restores the agent, the replay and the counters bit-equal
    to what was saved."""
    import threading
    from unittest import mock

    import torch

    from scalerl_torch.config import ApexArguments, parse_args
    from scalerl_torch.agents.dqn import DQNAgent
    from scalerl_torch.envs.gym_env import make_host_envs
    from scalerl_torch.trainer.apex import ApexTrainer

    set_tf32(False)
    root = _work_dir("apex_train")
    argv = ["--use-pallas", "--env-backend", "jax", "--num-envs", "16", "--n-steps", "3",
            "--buffer-size", str(1 << 20), "--batch-size", str(PER_BATCH),
            "--max-timesteps", str(10**9), "--eval-frequency", str(10**9),
            "--logger-frequency", "5000", "--save-frequency", str(10**9),
            "--logger-backend", "none", "--telemetry-interval-s", "0", "--work-dir", root]
    args0 = parse_args(ApexArguments, argv)
    if (args0.num_actors, args0.hidden_sizes, args0.rollout_length) != (4, "128,128", 20):
        raise AssertionError(f"ApexArguments' defaults moved: {args0}")
    saves, started = [], threading.Event()
    save_checkpoint, run = ApexTrainer.save_resume_checkpoint, ApexTrainer.run

    def recording_save(self, state, env_step, grad_step):
        # the tree as written: actor threads move global_step meanwhile
        saves.append(_host_tree(state))
        save_checkpoint(self, state, env_step, grad_step)

    def timed_run(self):
        self.t0 = time.perf_counter()
        started.set()
        try:
            return run(self)
        finally:
            self.t1 = time.perf_counter()

    killer, done = _sigterm_after(APEX_TRAIN_S, started)
    _zero_launch_counts()
    try:
        with mock.patch.object(ApexTrainer, "save_resume_checkpoint", recording_save), \
                mock.patch.object(ApexTrainer, "run", timed_run):
            out = _example_module("train_apex_torch").main(argv)
    finally:
        done.set()
        killer.join()
    torch.cuda.synchronize()
    trainer = out["trainer"]
    seconds = trainer.t1 - trainer.t0
    launches = _launch_counts()
    losses = [m["loss"] for _, kind, m in trainer.log_history if kind == "train" and "loss" in m]
    actor_ms = {k: v * 1e3 for k, v in trainer.actors[0].timings.means().items()}
    learner_ms = {k: v * 1e3 for k, v in trainer.timings.means().items()}

    # the resumed trainer's restore, against the tree saved at SIGTERM
    rargs = parse_args(ApexArguments, argv + ["--resume", trainer.work_dir])
    renvs = make_host_envs(rargs.env_id, rargs.num_envs, rargs.seed, "jax")
    ragent = DQNAgent(rargs, renvs.single_observation_space.shape,
                      renvs.single_action_space.n)
    resumed = ApexTrainer(rargs, ragent, lambda i: renvs)
    t0 = time.perf_counter()
    restored = resumed.try_resume()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restore_diff = _trees_bit_equal(_host_tree(resumed._resume_pytree()), saves[-1]) \
        if saves else ["no save"]
    resumed.close()
    report["apex_train"] = {"env_steps_per_s": trainer.global_step / seconds,
                            "learn_steps_per_s": trainer.learn_steps / seconds}
    emit("apex_train", actors=trainer.args.num_actors, envs_per_actor=trainer.envs_per_actor,
         slab=trainer.buffer.num_envs, replay=[trainer.buffer.capacity, trainer.buffer.num_envs],
         batch=PER_BATCH, seconds=seconds, env_steps=trainer.global_step,
         env_steps_per_s=trainer.global_step / seconds, learn_steps=trainer.learn_steps,
         learn_steps_per_s=trainer.learn_steps / seconds, launches=launches,
         weight_version=trainer.param_server.version, logged_losses=len(losses),
         last_loss=losses[-1] if losses else None, replay_size=len(trainer.buffer),
         actor_errors=sum(a.error is not None for a in trainer.actors),
         actor_ms_per_slab=actor_ms, learner_ms_per_step=learner_ms, saves=len(saves),
         restored=restored, restore_s=restore_s, restore_mismatches=restore_diff,
         result=out["result"], eval=out["eval"], card=report["card"])
    checks = {
        "learn steps": trainer.learn_steps > 0,
        "sample launches = learn steps": launches["per_sample"] == trainer.learn_steps,
        "update launches = learn steps": launches["per_update"] == trainer.learn_steps,
        "weights pushed": trainer.param_server.version >= 1,
        "finite losses": bool(losses) and all(math.isfinite(x) for x in losses),
        "no actor errors": all(a.error is None for a in trainer.actors),
        "resume bit-equal": restored and not restore_diff,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"apex_train: {failed}")


def phase_r2d2_device(report: dict) -> None:
    """``DeviceR2D2Trainer`` at ``R2D2Arguments``' defaults (conv torso,
    hidden 256, one LSTM layer, dueling, T=20, burn-in 8, 3-step, batch 16,
    2,048 sequences: ~1.2 GB of frames) on 16 lanes of the 84x84x4 uint8
    synthetic env with ``use_pallas``: ``R2D2_DEVICE_ITERS`` iterations,
    every warm one under sync debug mode "error", every kernel's launch
    count zeroed just before (sample launches = learn steps); frames/s and
    learn steps/s; then ``R2D2_PROFILE_ITERS`` iterations under
    ``torch.profiler`` (``r2d2_device_profile``)."""
    import torch

    from scalerl_torch.agents.r2d2 import R2D2Agent
    from scalerl_torch.config import R2D2Arguments
    from scalerl_torch.envs.tensor_envs import SyntheticPixelEnv
    from scalerl_torch.trainer.r2d2_device import DeviceR2D2Trainer

    set_tf32(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    args = R2D2Arguments(env_id="SyntheticPixel-v0", use_pallas=True, logger_backend="none",
                         telemetry_interval_s=0.0, save_model=False, logger_frequency=10**9,
                         work_dir=_work_dir("r2d2_device"))
    env = SyntheticPixelEnv(16)
    agent = R2D2Agent(args, env.observation_shape, env.num_actions)
    trainer = DeviceR2D2Trainer(args, agent, env)
    frames_per_iter = args.rollout_length * env.num_envs
    replay_gib = sum(v.numel() * v.element_size() for v in trainer.replay.storage.values()) / 2**30
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    t0 = time.perf_counter()
    result = trainer.train(total_frames=R2D2_DEVICE_ITERS * frames_per_iter)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    learn_steps = int(agent.state.step)
    peak = torch.cuda.max_memory_allocated() / 2**30
    frames0 = trainer.env_frames
    profiled_s, kernels = profile_device(lambda: trainer.train(
        total_frames=frames0 + R2D2_PROFILE_ITERS * frames_per_iter))
    trainer.close()
    busy_s = sum(us for _, us, _ in kernels) / 1e6
    sample = [(us, n) for k, us, n in kernels if "per_search" in k or "per_block_sums" in k]
    emit("r2d2_device", envs=env.num_envs, obs=list(env.observation_shape), T=args.rollout_length,
         burn_in=args.burn_in, batch=args.batch_size, replay_slots=args.replay_capacity,
         replay_gib=replay_gib, peak_mem_gib=peak, iterations=R2D2_DEVICE_ITERS,
         seconds=seconds, env_frames=result["env_frames"],
         env_frames_per_s=result["env_frames"] / seconds, learn_steps=learn_steps,
         learn_steps_per_s=learn_steps / seconds, launches=launches,
         total_loss=result.get("total_loss"), skipped_steps=result.get("skipped_steps"),
         card=report["card"])
    emit("r2d2_device_profile", iterations=R2D2_PROFILE_ITERS, profiled_s=profiled_s,
         device_busy_s=busy_s, device_busy_share=busy_s / profiled_s if kernels else None,
         kernel_launches=sum(n for _, _, n in kernels),
         per_sample_kernels_us=sum(us for us, _ in sample), per_sample_kernel_calls=sum(
             n for _, n in sample),
         top_kernels=[{"name": k[:90], "ms": us / 1e3, "calls": n} for k, us, n in kernels[:10]],
         card=report["card"])
    checks = {
        "learn steps": learn_steps > 0,
        "sample launches = learn steps": launches["per_sample"] == learn_steps,
        "plain write-back": launches["per_update"] == 0,
        "finite": math.isfinite(result.get("total_loss", float("nan")))
        and result.get("skipped_steps") == 0.0,
        "profile shows the sample kernels": bool(sample),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"r2d2_device: {failed}")


def phase_learn_r2d2_recall_device(report: dict) -> None:
    """The reference's ``r2d2_recall_device`` recipe
    (``tools/torch_learning_curves.py``: ``TensorRecall`` 12x12, delay 3, 2
    cues, 16 envs, hidden 64, 50,000 frames an arm) at seed 0 on the card:
    the LSTM arm's windowed return must reach 0.6 and the feed-forward
    control's stay below 0.3; sample launches = both arms' learn steps."""
    import torch

    from tools.torch_learning_curves import REFERENCE_FRAMES, TASKS

    set_tf32(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _zero_launch_counts()
    row = TASKS["r2d2_recall_device"](seed=0, work_dir=_work_dir("learn_r2d2_recall_device"))
    launches = _launch_counts()["per_sample"]
    steps = row["learner_steps"] + row["ff_control_learner_steps"]
    emit("learn_r2d2_recall_device", **row, required=True,
         reference_frames=REFERENCE_FRAMES["r2d2_recall_device"], per_sample_launches=launches,
         card=report["card"])
    if launches != steps or not row["passed"]:
        raise AssertionError(f"r2d2_recall_device: launches {launches} for {steps} steps, {row}")


def phase_r2d2_host(report: dict) -> None:
    """``examples/train_r2d2_torch.py``'s ``main()`` at ``R2D2Arguments``'
    defaults on ``RecallGym-v0`` (the port's numpy env: 2 actors x 4 envs
    16x16x1, conv torso, LSTM, T=20) with ``--use-pallas`` for about
    ``R2D2_HOST_S`` (stopped at the first log boundary past it), every
    kernel's launch count zeroed just before: sample launches = learn
    steps, 0 actor errors; then a trainer with ``--resume`` restores the
    agent, the sequence replay (stored cores included), the frame count and
    the max priority bit-equal to what the run saved."""
    from unittest import mock

    import torch

    from scalerl_torch.agents.r2d2 import R2D2Agent
    from scalerl_torch.config import R2D2Arguments, parse_args
    from scalerl_torch.envs.gym_env import make_host_envs
    from scalerl_torch.runtime import telemetry
    from scalerl_torch.trainer.r2d2 import R2D2Trainer

    set_tf32(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    root = _work_dir("r2d2_host")
    argv = ["--env-id", "RecallGym-v0", "--use-pallas", "--max-timesteps", str(10**9),
            "--logger-frequency", "2000", "--save-frequency", str(10**9),
            "--logger-backend", "none", "--telemetry-interval-s", "0", "--work-dir", root]
    reg = telemetry.get_registry()
    errors0 = reg.counter("queue.actor_errors").value
    log = R2D2Trainer.log
    t0 = time.perf_counter()

    def log_and_stop(self, step, kind, m):
        log(self, step, kind, m)
        if time.perf_counter() - t0 >= R2D2_HOST_S:
            self.stop_event.set()

    _zero_launch_counts()
    with mock.patch.object(R2D2Trainer, "log", log_and_stop):
        out = _example_module("train_r2d2_torch").main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    trainer = out["trainer"]
    launches = _launch_counts()
    saved = _host_tree(trainer._resume_pytree())
    returns = [m["return_mean"] for _, kind, m in trainer.log_history if kind == "train"]

    rargs = parse_args(R2D2Arguments, argv + ["--resume", trainer.work_dir])
    fns = [lambda: make_host_envs("RecallGym-v0", trainer.envs_per_actor, 0)] * 2
    resumed = R2D2Trainer(rargs, R2D2Agent(rargs, trainer.spec.obs_shape,
                                           trainer.spec.num_actions), fns)
    restored = resumed.try_resume()
    restore_diff = _trees_bit_equal(_host_tree(resumed._resume_pytree()), saved)
    resumed.close()
    actor_ms = {k: v * 1e3 for k, v in trainer.actors[0].timings.means().items()}
    emit("r2d2_host", actors=trainer.args.num_actors, envs_per_actor=trainer.envs_per_actor,
         obs=list(trainer.spec.obs_shape), T=trainer.args.rollout_length, seconds=seconds,
         env_frames=trainer.env_frames, env_frames_per_s=trainer.env_frames / seconds,
         learn_steps=trainer.learn_steps, learn_steps_per_s=trainer.learn_steps / seconds,
         launches=launches, actor_errors=reg.counter("queue.actor_errors").value - errors0,
         actor_restarts=trainer.actor_restarts, queue_stats=trainer.queue.stats(),
         actor_ms_per_slot=actor_ms, logged_returns=returns[-5:], result=out["result"],
         restored=restored, restore_mismatches=restore_diff,
         replay_leaves=sum(1 for p in saved if p.startswith("['replay']")), card=report["card"])
    checks = {
        "learn steps": trainer.learn_steps > 0,
        "sample launches = learn steps": launches["per_sample"] == trainer.learn_steps,
        "no actor errors": reg.counter("queue.actor_errors").value == errors0
        and trainer.actor_restarts == 0,
        "finite": out["result"]["skipped_steps"] == 0.0
        and math.isfinite(out["result"]["total_loss"]),
        "resume bit-equal": restored and not restore_diff,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"r2d2_host: {failed}")


# The process plane (phases 35-37)
RING_PRODUCERS, RING_SLOTS, RING_PER_PRODUCER = 4, 32, 40
RING_TEAR_SPEC, RING_TEAR_SLOTS = "16:slot_tear=0.25", 40
PDQN_TRAIN_S = 2.5  # 3 s before serving_on_shards, 4 before genrl_on_shards, 5 before shard_compute
PROC_TRAIN_S = 2.5  # 3 s before serving_on_shards, 4 before genrl_on_shards
# seconds a training phase may take to reach its first learn step
FIRST_LEARN_DEADLINE_S = 240.0


def _ring_producer(ring, actor_id: int, n: int, spec: str = "") -> None:
    """A spawned producer: ``n`` slots stamped ``(actor_id, seq)`` in
    ``meta`` and the first and last obs byte, under the chaos plan
    ``spec`` when one is given."""
    from scalerl_torch.runtime import chaos

    if spec:
        chaos.install(chaos.FaultInjector(chaos.ChaosPlan.parse(spec)))
    for i in range(n):
        idx = ring.acquire(timeout=30.0)
        if idx is None:
            raise RuntimeError("acquire timed out")
        views = ring.slot(idx)
        views["obs"].reshape(-1)[[0, -1]] = (actor_id * 50 + i) % 251
        views["meta"][:] = (actor_id, i)
        views = None
        ring.commit(idx)
    ring.detach()


def _process_impala_slot(device: str = "cpu"):
    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.trainer.process_actor_learner import slot_fields

    args = _default_args()
    agent = ImpalaAgent(args, (84, 84, 4), 6, device=device)
    return slot_fields(agent, args.rollout_length, args.num_envs // args.num_actors)


def _drain_ring(ring, expect: int, deadline_s: float = 120.0):
    """Pop, verify and release ``expect`` slots; returns their stamps and
    the seconds from the first slot to the last (children's start-up
    excluded)."""
    got = []
    first = None
    deadline = time.monotonic() + deadline_s
    while len(got) + ring.torn_reads < expect and time.monotonic() < deadline:
        idx = ring.pop_full_verified(timeout=0.5)
        if idx is None:
            continue
        first = first or time.perf_counter()
        views = ring.slot(idx)
        got.append((int(views["meta"][0]), int(views["meta"][1]),
                    int(views["obs"].reshape(-1)[0]), int(views["obs"].reshape(-1)[-1])))
        views = None
        ring.release(idx)
    return got, time.perf_counter() - first if first else 0.0


def phase_shm_ring(report: dict) -> None:
    import multiprocessing as mp

    from scalerl_torch.native import build as native_build
    from scalerl_torch.runtime import chaos
    from scalerl_torch.runtime.shm_ring import ShmRolloutRing, SlotSpec

    fresh = not native_build.library_path().exists()
    t0 = time.perf_counter()
    native_build.load_ring_lib()
    build_s = time.perf_counter() - t0
    spec = SlotSpec(_process_impala_slot())
    ctx = mp.get_context("spawn")
    legs = {}
    for native in (True, False):
        ring = ShmRolloutRing(spec, num_slots=RING_SLOTS, use_native=native)
        procs = [ctx.Process(target=_ring_producer, args=(ring, a, RING_PER_PRODUCER))
                 for a in range(RING_PRODUCERS)]
        try:
            for p in procs:
                p.start()
            got, seconds = _drain_ring(ring, RING_PRODUCERS * RING_PER_PRODUCER)
            for p in procs:
                p.join(timeout=30.0)
            exits = [p.exitcode for p in procs]
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            ring.unlink()
        want = sorted((a, i, (a * 50 + i) % 251, (a * 50 + i) % 251)
                      for a in range(RING_PRODUCERS) for i in range(RING_PER_PRODUCER))
        in_order = all([x for x in got if x[0] == a] == [x for x in want if x[0] == a]
                       for a in range(RING_PRODUCERS))
        legs["native" if native else "queues"] = dict(
            slots=len(got), seconds=seconds, slots_per_s=len(got) / seconds,
            payload_mb_per_s=len(got) * spec.slot_bytes / seconds / 1e6, exits=exits,
            intact=sorted(got) == want, in_order_per_producer=in_order,
            torn_reads=ring.torn_reads)

    # a seeded tear plan in the producer: every torn slot detected, skipped
    ring = ShmRolloutRing(spec, num_slots=RING_SLOTS)
    plan_inj = chaos.FaultInjector(chaos.ChaosPlan.parse(RING_TEAR_SPEC))
    torn = [plan_inj.tear_slot(bytearray(spec.slot_bytes)) for _ in range(RING_TEAR_SLOTS)]
    proc = ctx.Process(target=_ring_producer, args=(ring, 0, RING_TEAR_SLOTS, RING_TEAR_SPEC))
    try:
        proc.start()
        got, _ = _drain_ring(ring, RING_TEAR_SLOTS)
        proc.join(timeout=30.0)
        tear = dict(injected=sum(torn), torn_reads=ring.torn_reads, delivered=len(got),
                    exit=proc.exitcode,
                    intact_in_order=[g[1] for g in got] == [i for i in range(RING_TEAR_SLOTS)
                                                            if not torn[i]])
    finally:
        if proc.is_alive():
            proc.terminate()
        ring.unlink()

    # gather_batch of one learn step's slots (batch 8 = 8 slots of 1 env)
    timing = {}
    for native in (True, False):
        ring = ShmRolloutRing(spec, num_slots=RING_SLOTS, use_native=native)
        try:
            idxs = [ring.acquire(timeout=1.0) for _ in range(8)]
            out = {name: np.empty((8,) + shape, dtype)
                   for name, (shape, dtype) in spec.fields.items()}
            ring.gather_batch(idxs, out)
            reps = 20
            t0 = time.perf_counter()
            for _ in range(reps):
                ring.gather_batch(idxs, out)
            sec = (time.perf_counter() - t0) / reps
        finally:
            out = None
            ring.unlink()
        moved = 8 * sum(int(np.prod(shape)) * dtype.itemsize
                        for shape, dtype in spec.fields.values())
        timing["native" if native else "python_copy"] = dict(ms=sec * 1e3,
                                                             gb_per_s=moved / sec / 1e9)
    emit("shm_ring", build_s=build_s, built_fresh=fresh,
         library=native_build.library_path().name, slot_bytes=spec.slot_bytes,
         slot_fields={k: [list(s), str(d)] for k, (s, d) in spec.fields.items()},
         producers=RING_PRODUCERS, slots=RING_SLOTS, legs=legs, tear=tear,
         gather_batch_8_slots=dict(bytes=moved, **timing), card=report["card"])
    checks = {
        "both legs intact": all(leg["intact"] and leg["in_order_per_producer"]
                                and leg["exits"] == [0] * RING_PRODUCERS
                                and leg["torn_reads"] == 0 for leg in legs.values()),
        "torn reads = injected tears": 0 < tear["injected"] == tear["torn_reads"]
        and tear["delivered"] == RING_TEAR_SLOTS - tear["injected"]
        and tear["intact_in_order"] and tear["exit"] == 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"shm_ring: {failed}")


def _counter(name: str) -> float:
    from scalerl_torch.runtime import telemetry

    return telemetry.get_registry().counter(name).value


def _segment_gone(ring) -> bool:
    return not Path("/dev/shm", ring.shm.name.lstrip("/")).exists()


def _stop_after(trainer, seconds: float, started, counters) -> dict:
    """Set ``trainer.stop_event`` ``seconds`` after the first learn step;
    returns a dict that then holds the window's start (``t0`` and
    ``counters()``), for rates past the children's start-up and warm-up.
    With no learn step within ``FIRST_LEARN_DEADLINE_S`` it stops the
    trainer and leaves the window unopened, which fails the phase."""
    import threading

    window: dict = {}

    def stop() -> None:
        deadline = time.monotonic() + FIRST_LEARN_DEADLINE_S
        while not started() and not trainer.stop_event.is_set():
            if time.monotonic() > deadline:
                trainer.stop_event.set()
                return
            time.sleep(0.05)
        window.update(t0=time.perf_counter(), start=counters())
        trainer.stop_event.wait(seconds)
        trainer.stop_event.set()

    threading.Thread(target=stop, daemon=True).start()
    return window


def _window_rates(window: dict, end: dict) -> dict:
    """Rates over the steady window that ``_stop_after`` opened."""
    if "t0" not in window:
        raise AssertionError(f"no learn step within {FIRST_LEARN_DEADLINE_S:.0f} s")
    sec = time.perf_counter() - window["t0"]
    return {"window_s": sec, **{f"{k}_per_s": (end[k] - window["start"][k]) / sec
                                for k in end}}


def phase_parallel_dqn(report: dict) -> None:
    import torch

    from scalerl_torch.agents.dqn import DQNAgent
    from scalerl_torch.config import DQNArguments
    from scalerl_torch.ops import cuda_per, cuda_vtrace
    from scalerl_torch.trainer.parallel_dqn import ParallelDQNTrainer

    set_tf32(False)
    args = DQNArguments(use_per=True, use_pallas=True, env_backend="jax", logger_backend="none",
                        telemetry_interval_s=0.0, save_model=False, logger_frequency=2000,
                        max_timesteps=10**9, work_dir=_work_dir("parallel_dqn"))
    if (args.hidden_sizes, args.rollout_length, args.batch_size) != ("128,128", 20, 32):
        raise AssertionError(f"DQNArguments' defaults moved: {args}")
    agent = DQNAgent(args, (4,), 2)
    trainer = ParallelDQNTrainer(args, agent, env_id="CartPole-v1", obs_shape=(4,),
                                 num_actors=4)
    packed0 = _counter("codec.bytes_packed")

    def counters() -> dict:
        return {"env_steps": trainer.env_steps, "learn_steps": trainer.learn_steps}

    window = _stop_after(trainer, PDQN_TRAIN_S, lambda: trainer.learn_steps > 0, counters)
    cuda_vtrace.launches = 0
    cuda_per.sample_launches = cuda_per.update_launches = 0
    t0 = time.perf_counter()
    result = trainer.train(total_steps=10**9)
    torch.cuda.synchronize()
    steady = _window_rates(window, counters())
    seconds = time.perf_counter() - t0
    launches = {"per_sample": cuda_per.sample_launches, "per_update": cuda_per.update_launches}
    trainer.close()
    losses = [m["loss"] for _, kind, m in trainer.log_history if kind == "train" and "loss" in m]
    reports = trainer.child_reports
    emit("parallel_dqn", actors=trainer.num_actors, T=args.rollout_length,
         batch=args.batch_size, replay=args.buffer_size, seconds=seconds,
         env_steps=trainer.env_steps, env_steps_per_s=trainer.env_steps / seconds,
         learn_steps=trainer.learn_steps, learn_steps_per_s=trainer.learn_steps / seconds,
         steady=steady, learner_ms={k: v * 1e3 for k, v in trainer.learn_timings.means().items()},
         launches=launches, episodes=result["episodes"],
         return_mean=result["return_mean"],
         weight_version=trainer.param_server.version,
         actor_weight_version=trainer.max_actor_version, torn_reads=trainer.ring.torn_reads,
         logged_losses=len(losses), last_loss=losses[-1] if losses else None,
         skipped_steps=result.get("skipped_steps"),
         child_exits=[p.exitcode for p in trainer.procs],
         children_cuda=[reports[i]["cuda_initialized"] for i in sorted(reports)],
         segment_unlinked=_segment_gone(trainer.ring),
         weight_service_mb_sent=(_counter("codec.bytes_packed") - packed0) / 1e6,
         card=report["card"])
    checks = {
        "PER launches = learn steps": launches == {"per_sample": trainer.learn_steps,
                                                   "per_update": trainer.learn_steps}
        and trainer.learn_steps > 0,
        "finite losses": bool(losses) and all(math.isfinite(x) for x in losses),
        "no torn reads": trainer.ring.torn_reads == 0,
        "children exited": [p.exitcode for p in trainer.procs] == [0] * trainer.num_actors,
        "no CUDA in the children": len(reports) == trainer.num_actors
        and not any(r["cuda_initialized"] for r in reports.values()),
        "segment unlinked": _segment_gone(trainer.ring),
        "actors acted on pushed weights": trainer.max_actor_version >= 2,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"parallel_dqn: {failed}")


def phase_process_impala(report: dict) -> None:
    import torch

    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.ops import cuda_vtrace
    from scalerl_torch.trainer.process_actor_learner import ProcessActorLearnerTrainer

    set_tf32(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    root = _work_dir("process_impala")
    args = _default_args(env_id="PixelRing-v0", actor_mode="process", logger_backend="none",
                         telemetry_interval_s=0.0, save_frequency=10**9, logger_frequency=640,
                         work_dir=root)
    if (args.num_actors, args.num_buffers, args.num_envs) != (8, 32, 8):
        raise AssertionError(f"ImpalaArguments' host-plane defaults moved: {args}")
    agent = ImpalaAgent(args, (84, 84, 4), 6)
    trainer = ProcessActorLearnerTrainer(args, agent)
    last = {}
    learn_device = agent.learn_device

    def keep_last(traj):
        last["traj"] = traj
        return learn_device(traj)

    agent.learn_device = keep_last

    def counters() -> dict:
        return {"env_frames": trainer.env_frames, "learn_steps": trainer.learn_steps,
                "weight_mb_sent": _counter("codec.bytes_packed") / 1e6}

    window = _stop_after(trainer, PROC_TRAIN_S, lambda: trainer.learn_steps > 0, counters)
    packed0, frames0 = _counter("codec.bytes_packed"), _counter("codec.frames_packed")
    cuda_vtrace.launches = 0
    t0 = time.perf_counter()
    result = trainer.train(total_frames=10**9)  # saves its resume checkpoint at the end
    torch.cuda.synchronize()
    steady = _window_rates(window, counters())
    seconds = time.perf_counter() - t0
    launches = cuda_vtrace.launches
    weight_mb = (_counter("codec.bytes_packed") - packed0) / 1e6
    frames_sent = _counter("codec.frames_packed") - frames0
    agent.learn_device = learn_device
    saved = _host_tree({"agent": agent.state,
                        "env_frames": np.asarray(trainer.env_frames, np.int64)})
    trainer.close()
    losses = [m["total_loss"] for _, kind, m in trainer.log_history if kind == "train"]
    reports = trainer.child_reports
    actor_t = trainer.actor_timings

    args_b = _default_args(env_id="PixelRing-v0", actor_mode="process", logger_backend="none",
                           telemetry_interval_s=0.0, save_model=False, work_dir=root,
                           resume=trainer.work_dir)
    agent_b = ImpalaAgent(args_b, (84, 84, 4), 6)
    trainer_b = ProcessActorLearnerTrainer(args_b, agent_b)
    resumed = trainer_b.try_resume()
    bad = _trees_bit_equal(saved, _host_tree({
        "agent": agent_b.state, "env_frames": np.asarray(trainer_b.env_frames, np.int64)}))
    trainer_b.stop()  # no actor was started: this only unlinks its ring
    trainer_b.close()

    # one learn step's window on the card
    traj = last["traj"]
    profiled_s, kernels = profile_device(lambda: agent.learn_device(traj))
    busy_s = sum(us for _, us, _ in kernels) / 1e6
    emit("process_impala", actors=args.num_actors, envs_per_actor=trainer.envs_per_actor,
         T=args.rollout_length, batch=args.batch_size, num_buffers=args.num_buffers,
         seconds=seconds, env_frames=result["env_frames"],
         env_frames_per_s=result["env_frames"] / seconds, learn_steps=trainer.learn_steps,
         learn_steps_per_s=trainer.learn_steps / seconds, steady=steady,
         actor_ms_per_slot={k: 1e3 * statistics.mean(t[k] for t in actor_t.values())
                            for k in next(iter(actor_t.values()), {})},
         learner_ms_per_step={k: v * 1e3 for k, v in trainer.learn_timings.means().items()},
         vtrace_launches=launches, child_torch_threads=sorted({r["torch_threads"] for r in reports.values()}),
         children_cuda=[reports[i]["cuda_initialized"] for i in sorted(reports)],
         child_exits=[p.exitcode for p in trainer.procs], torn_reads=trainer.ring.torn_reads,
         skipped_steps=result.get("skipped_steps"), logged_losses=len(losses),
         episodes=result.get("episodes"), return_mean=result.get("return_mean"),
         resumed=resumed, resume_mismatches=bad, segment_unlinked=_segment_gone(trainer.ring),
         learn_step_profile=dict(
             profiled_s=profiled_s, device_busy_s=busy_s,
             device_busy_share=busy_s / profiled_s if kernels else None,
             kernel_launches=sum(n for _, _, n in kernels),
             vtrace_calls=sum(n for k, _, n in kernels if "vtrace_kernel" in k)),
         weight_service=dict(mb_sent=weight_mb, frames_sent=frames_sent,
                             mb_per_s=weight_mb / seconds),
         card=report["card"])
    checks = {
        "V-trace launches = learn steps": launches == trainer.learn_steps > 0,
        "finite losses": bool(losses) and all(math.isfinite(x) for x in losses),
        "no skipped steps": result.get("skipped_steps") == 0.0,
        "no CUDA in the children": len(reports) == args.num_actors
        and not any(r["cuda_initialized"] for r in reports.values()),
        "one torch thread a child": {r["torch_threads"] for r in reports.values()} == {1},
        "segment unlinked": _segment_gone(trainer.ring),
        "resume bit-equal": resumed and not bad,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"process_impala: {failed}")


# cut again when impala_anakin and mesh_learn joined the script: the script
# must end within 1,200 s, and a host 1.3-1.9x slower than usual has run it
# in 1,267 s (PERF.md's Findings)
IMPACT_TRAIN_S = 7.0  # 10 s before, 20 before phases 51-55 joined the script
ONPOLICY_EXAMPLE_STEPS = 4_000  # 6,000 before serving_on_shards, 8,000 before, 16,000 before phases 51-55
ONPOLICY_RECALL_CHUNKS = 6  # 8 before genrl_on_shards, 12 before, 30 before phases 51-55
CONTINUOUS_TRAIN_STEPS = 1_500  # 2,000 before genrl_on_shards, 3,000 before, 6,000 before 51-55
# card vs host for the on-policy learn steps: the loss, the gradient at the
# initial params and one optimizer step of it as LEARN_TOL holds IMPALA's.
# A whole PPO learn step is 16 Adam steps (4 epochs x 4 minibatches); Adam
# moves a weight whose gradient sits at rounding level by about lr * sign(g)
# on one side only (the R2D2 case, ROADMAP §C), and the steps compound: 2.0e-2
# relative L2 measured on an H100, against 1.7e-3 for one Adam step (A3C) and
# 2.6e-6 for IMPACT's RMSProp step, whose eps inside the root damps it
ONPOLICY_GRAD_LEAF_REL = 1e-4
PPO_SCHEDULE_UPDATE_REL_L2 = 5e-2


def _to_device(tree, device):
    """A train state, trajectory or batch (dataclasses, dicts, tuples of
    tensors) with every tensor moved to ``device``."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _to_device(getattr(tree, f.name), device)
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_device(v, device) for v in tree)
    return tree


def _flat_update(after: dict, before: dict):
    import torch

    return torch.cat([(after[k].cpu() - v.cpu()).reshape(-1) for k, v in before.items()])


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1.0)


def phase_impact_learn(report: dict) -> None:
    """One IMPACT learn step at ``ImpactArguments``' defaults (``AtariNet``
    with its 2-layer LSTM, hidden 512, T=80, B=8, 84x84x4 frames) on a
    trajectory the fused loop collects from the synthetic env with a carried
    core, from a state whose target network is a perturbed copy of the
    learner (so the ratio and V-trace's rhos move off 1), float32 with TF32
    off: the V-trace kernel on the card against the plain V-trace on the
    card (``LEARN_TOL``'s loss and grad-norm bounds, each gradient leaf
    within 1e-4 of its largest) and against the plain step on the host
    (``LEARN_TOL``'s, the update's relative L2 included); one kernel launch
    per surrogate update, none in the plain steps, and ``replay_times``
    launches for one ``learn()``."""
    import torch

    from scalerl_torch.agents.impact import ImpactAgent, impact_loss
    from scalerl_torch.config import ImpactArguments
    from scalerl_torch.envs.tensor_envs import SyntheticPixelEnv
    from scalerl_torch.ops import cuda_vtrace
    from scalerl_torch.runtime.device_loop import DeviceActorLearnerLoop

    set_tf32(False)
    args = ImpactArguments(use_pallas=True)
    if not (args.use_lstm and args.hidden_size == 512 and (args.rollout_length, args.batch_size)
            == (80, 8) and args.replay_times == 2):
        raise AssertionError(f"ImpactArguments' defaults moved: {args}")
    T, B = args.rollout_length, args.batch_size
    env = SyntheticPixelEnv(num_envs=B)
    A = env.num_actions
    agent = ImpactAgent(args, env.observation_shape, A)
    loop = DeviceActorLearnerLoop(agent.model, env, agent.make_learn_fn(), T, iters_per_call=1,
                                  seed=5)
    carry, _ = loop._unroll(agent.state.params, loop.init_carry())
    _, traj = loop._unroll(agent.state.params, carry)  # enters with a non-zero carry
    g = torch.Generator(device="cuda").manual_seed(6)
    target = {k: v + 0.2 * v.std(correction=0) * torch.randn(v.shape, generator=g,
                                                              device="cuda")
              for k, v in agent.state.params.items()}
    state = dataclasses.replace(agent.state, target_params=target)
    params = state.params

    def loss_grads(model, st, tr, impl):
        leaves = {k: v.detach().requires_grad_(True) for k, v in st.params.items()}
        loss, metrics = impact_loss(leaves, st.target_params, model, tr, args.discounting,
                                    args.baseline_cost, args.entropy_cost, args.impact_clip,
                                    vtrace_impl=impl)
        return loss, metrics, dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    loss_k, _, grads_k = loss_grads(agent.model, state, traj, "kernel")
    loss_p, _, grads_p = loss_grads(agent.model, state, traj, "scan")
    steps = {}
    for name, use_pallas, device in (("kernel", True, "cuda"), ("plain", False, "cuda"),
                                     ("host", False, "cpu")):
        a = ImpactAgent(dataclasses.replace(args, use_pallas=use_pallas),
                        env.observation_shape, A, device=device)
        cuda_vtrace.launches = 0
        st, metrics = a.make_learn_fn()(_to_device(state, device), _to_device(traj, device))
        torch.cuda.synchronize()
        steps[name] = ({k: float(v) for k, v in metrics.items()}, cuda_vtrace.launches,
                       _flat_update(st.params, params))
    (m_k, launches_k, upd_k), (m_p, launches_p, upd_p) = steps["kernel"], steps["plain"]
    m_h, _, upd_h = steps["host"]
    # one learn(): replay_times surrogate updates, one launch each
    agent.state = state
    cuda_vtrace.launches = 0
    agent.learn(traj)
    launches_learn = cuda_vtrace.launches
    leaf_rel = _leaf_rel(grads_k, grads_p)
    errs = {
        "loss_rel": max(_rel(loss_k.item(), loss_p.item()),
                        _rel(m_k["total_loss"], m_p["total_loss"])),
        "grad_leaf_rel": max(leaf_rel.values()),
        "grad_norm_rel": _rel(m_k["grad_norm"], m_p["grad_norm"]),
        "card_vs_host_loss_rel": _rel(m_p["total_loss"], m_h["total_loss"]),
        "card_vs_host_grad_norm_rel": _rel(m_p["grad_norm"], m_h["grad_norm"]),
        "card_vs_host_update_rel_l2": ((upd_k - upd_h).norm() / upd_h.norm()).item(),
    }
    tol = {"loss_rel": LEARN_TOL["loss_rel"], "grad_leaf_rel": 1e-4,
           "grad_norm_rel": LEARN_TOL["grad_norm_rel"],
           "card_vs_host_loss_rel": LEARN_TOL["loss_rel"],
           "card_vs_host_grad_norm_rel": LEARN_TOL["grad_norm_rel"],
           "card_vs_host_update_rel_l2": LEARN_TOL["card_vs_host_update_rel_l2"]}
    emit("impact_learn", T=T, B=B, hidden=args.hidden_size, lstm_layers=len(agent.model.core),
         replay_times=args.replay_times, params=sum(v.numel() for v in params.values()),
         **errs, tol=tol, worst_grad_leaf=max(leaf_rel, key=leaf_rel.get),
         kernel_vs_plain_update_max_abs=(upd_k - upd_p).abs().max().item(),
         update_max_abs=upd_p.abs().max().item(), total_loss=m_k["total_loss"],
         mean_ratio=m_k["mean_ratio"], mean_clip_frac=m_k["mean_clip_frac"],
         grad_norm=m_k["grad_norm"], skipped_steps=m_k["skipped_steps"],
         vtrace_launches_kernel=launches_k, vtrace_launches_plain=launches_p,
         vtrace_launches_learn=launches_learn,
         dones_inside=int(traj.done[1:-1].sum()), tf32=False, card=report["card"])
    bad = {k: v for k, v in errs.items() if not v <= tol[k]}
    if (bad or (launches_k, launches_p) != (1, 0) or launches_learn != args.replay_times
            or m_k["skipped_steps"] != 0.0 or m_k["mean_ratio"] == 1.0):
        raise AssertionError(f"impact_learn: {bad}, launches {launches_k}/{launches_p}/"
                             f"{launches_learn}, skipped {m_k['skipped_steps']}, "
                             f"ratio {m_k['mean_ratio']}")


def phase_impact_train(report: dict) -> None:
    """``examples/train_impact_torch.py``'s ``main()`` with ``--use-pallas``
    on ``PixelRing-v0`` (the port's numpy env, 84x84x4) at
    ``ImpactArguments``' defaults: 8 actor threads of 1 env each, the LSTM
    ``AtariNet``, hidden 512, T=80, batch 8, 2 replays a chunk, stopped by
    SIGTERM after ``IMPACT_TRAIN_S`` (the guard saves the resume checkpoint),
    every kernel's launch count zeroed just before.  V-trace launches =
    ``replay_times`` x ``learn()`` calls > 0, finite losses, no skipped
    step, the circular buffer's stats (one insert a ``learn()``, 2 samples
    each, no overdraw), and a trainer with ``--resume`` restoring the agent
    and the frames bit-equal to what was saved."""
    import threading
    from unittest import mock

    import torch

    from scalerl_torch.agents.impact import ImpactAgent
    from scalerl_torch.config import ImpactArguments, parse_args
    from scalerl_torch.envs.gym_env import make_host_envs
    from scalerl_torch.trainer.actor_learner import HostActorLearnerTrainer

    set_tf32(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    root = _work_dir("impact_train")
    argv = ["--env-id", "PixelRing-v0", "--use-pallas", "--max-timesteps", str(10**9),
            "--logger-frequency", "640", "--save-frequency", str(10**9),
            "--logger-backend", "none", "--telemetry-interval-s", "0", "--work-dir", root]
    args0 = parse_args(ImpactArguments, argv)
    if (args0.num_actors, args0.num_envs, args0.replay_times, args0.rollout_length,
            args0.batch_size) != (8, 8, 2, 80, 8):
        raise AssertionError(f"ImpactArguments' defaults moved: {args0}")
    saves, started = [], threading.Event()
    save_checkpoint, train = HostActorLearnerTrainer.save_resume_checkpoint, \
        HostActorLearnerTrainer.train

    def recording_save(self, state, env_step, grad_step):
        saves.append(_host_tree(state))
        save_checkpoint(self, state, env_step, grad_step)

    def timed_train(self, total_frames=None):
        self.t0 = time.perf_counter()
        started.set()
        try:
            return train(self, total_frames)
        finally:
            self.t1 = time.perf_counter()

    killer, done = _sigterm_after(IMPACT_TRAIN_S, started)
    _zero_launch_counts()
    try:
        with mock.patch.object(HostActorLearnerTrainer, "save_resume_checkpoint",
                               recording_save), \
                mock.patch.object(HostActorLearnerTrainer, "train", timed_train):
            out = _example_module("train_impact_torch").main(argv)
    finally:
        done.set()
        killer.join()
    torch.cuda.synchronize()
    trainer, agent, result = out["trainer"], out["agent"], out["result"]
    seconds = trainer.t1 - trainer.t0
    launches = _launch_counts()
    stats = agent.surrogate.stats()
    losses = [m["total_loss"] for _, kind, m in trainer.log_history if kind == "train"]

    rargs = parse_args(ImpactArguments, argv + ["--resume", trainer.work_dir])
    ragent = ImpactAgent(rargs, (84, 84, 4), 6)
    resumed = HostActorLearnerTrainer(
        rargs, ragent, [lambda: make_host_envs("PixelRing-v0", 1)] * rargs.num_actors)
    t0 = time.perf_counter()
    restored = resumed.try_resume()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restore_diff = _trees_bit_equal(_host_tree(resumed._resume_pytree()), saves[-1]) \
        if saves else ["no save"]
    resumed.close()
    emit("impact_train", actors=trainer.args.num_actors, envs_per_actor=trainer.envs_per_actor,
         T=trainer.args.rollout_length, batch=trainer.args.batch_size,
         replay_times=trainer.args.replay_times, seconds=seconds,
         env_frames=result["env_frames"], env_frames_per_s=result["env_frames"] / seconds,
         learn_calls=trainer.learn_steps, learn_calls_per_s=trainer.learn_steps / seconds,
         surrogate_updates=int(agent.state.step),
         surrogate_updates_per_s=int(agent.state.step) / seconds,
         agent_env_frames=int(agent.state.env_frames), launches=launches, buffer=stats,
         logged_losses=len(losses), last_loss=losses[-1] if losses else None,
         skipped_steps=result.get("skipped_steps"), return_mean=result.get("return_mean"),
         saves=len(saves), restored=restored, restore_s=restore_s,
         restore_mismatches=restore_diff, card=report["card"])
    calls = trainer.learn_steps
    checks = {
        "learn calls": calls > 0,
        "V-trace launches = replay_times x learn calls":
            launches["vtrace"] == trainer.args.replay_times * calls == int(agent.state.step),
        "no PER launches": launches["per_sample"] == launches["per_update"] == 0,
        "finite losses": bool(losses) and all(math.isfinite(x) for x in losses),
        "no skipped steps": result.get("skipped_steps") == 0.0,
        "buffer": stats["inserted"] == calls and stats["sampled"] == 2 * calls
        and stats["overdraws"] == 0 and stats["size"] == min(calls, 16),
        "frames once a chunk": int(agent.state.env_frames) == calls * 80 * 8,
        "resume bit-equal": restored and not restore_diff,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"impact_train: {failed}")


def _onpolicy_compare(name: str, args, T: int, B: int, A: int, perms=None) -> dict:
    """An on-policy learner's model, loss, gradients and one learn step on
    the card against the same weights, trajectory (and lane shuffle) on the
    host, float32 with TF32 off."""
    import torch
    from torch.func import functional_call

    from scalerl_torch.agents.a3c import A3CAgent, a3c_loss
    from scalerl_torch.agents.ppo import PPOAgent, ppo_loss
    from scalerl_torch.data.trajectory import Trajectory
    from scalerl_torch.ops import cuda_per, cuda_vtrace

    cls = A3CAgent if name == "a3c" else PPOAgent
    g = torch.Generator().manual_seed(13)
    traj = Trajectory(
        obs=torch.randint(0, 256, (T + 1, B, 84, 84, 4), generator=g, dtype=torch.uint8),
        action=torch.randint(0, A, (T + 1, B), generator=g),
        reward=torch.randn(T + 1, B, generator=g),
        done=torch.rand(T + 1, B, generator=g) < 0.1,
        logits=torch.randn(T + 1, B, A, generator=g))
    out = {}
    for device in ("cuda", "cpu"):
        agent = cls(args, (84, 84, 4), A, device=device)
        core = tuple((0.1 * torch.randn(c.shape, generator=torch.Generator().manual_seed(i)),
                      0.1 * torch.randn(h.shape, generator=torch.Generator().manual_seed(i + 9)))
                     for i, (c, h) in enumerate(agent.initial_state(B)))
        tr = _to_device(dataclasses.replace(traj, core_state=core), device)
        params = agent.state.params
        with torch.no_grad():
            model_out, _ = functional_call(agent.model, params,
                                           (tr.obs, tr.action, tr.reward, tr.done, tr.core_state))
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        if name == "a3c":
            loss, _ = a3c_loss(leaves, agent.model, tr, args.gamma, args.gae_lambda,
                               args.value_loss_coef, args.entropy_coef)
        else:  # the first minibatch's loss of the schedule, at the initial params
            mb = dict(obs=tr.obs, action=tr.action, reward=tr.reward, done=tr.done,
                      core_state=tr.core_state, advantages=tr.reward[1:],
                      value_targets=tr.reward[1:], behavior_logp=-tr.reward[1:].abs(),
                      old_values=tr.reward[:-1])
            loss, _ = ppo_loss(leaves, agent.model, mb, args.clip_range, args.clip_range_vf,
                               args.value_loss_coef, args.entropy_coef,
                               args.normalize_advantage, args.loss_reduction)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        one_step, _ = agent.optimizer.update(grads, agent.state.opt_state)
        learn = agent.make_learn_fn()
        cuda_vtrace.launches = cuda_per.sample_launches = 0
        state, metrics = (learn(agent.state, tr) if perms is None
                          else learn(agent.state, tr, perms.to(device)))
        if device == "cuda":
            torch.cuda.synchronize()
        out[device] = dict(logits=model_out.policy_logits.cpu(), values=model_out.baseline.cpu(),
                           loss=loss.item(), grads={k: v.cpu() for k, v in grads.items()},
                           metrics={k: float(v) for k, v in metrics.items()},
                           one_step=torch.cat([u.reshape(-1).cpu() for u in one_step.values()]),
                           update=_flat_update(state.params, params),
                           launches=cuda_vtrace.launches + cuda_per.sample_launches,
                           params=sum(v.numel() for v in params.values()))
    c, h = out["cuda"], out["cpu"]
    return {
        "params": c["params"],
        "model_max_abs_err": max((c["logits"] - h["logits"]).abs().max().item(),
                                 (c["values"] - h["values"]).abs().max().item()),
        "loss_rel": _rel(c["loss"], h["loss"]),
        "grad_leaf_rel": max(_leaf_rel(c["grads"], h["grads"]).values()),
        "update_rel_l2": ((c["one_step"] - h["one_step"]).norm() / h["one_step"].norm()).item(),
        "learn_step_update_rel_l2": ((c["update"] - h["update"]).norm()
                                     / h["update"].norm()).item(),
        "grad_norm": c["metrics"]["grad_norm"], "total_loss": c["metrics"]["total_loss"],
        "skipped_steps": c["metrics"]["skipped_steps"], "kernel_launches": c["launches"],
    }


def phase_onpolicy_train(report: dict) -> None:
    """A3C and PPO.  First their learn steps at the pixel width, T=20, B=8:
    A3C with ``AtariNet`` and its LSTM of 256 (``A3CArguments``' defaults),
    PPO at its own (feed-forward ``AtariNet``, hidden 256, 4 epochs of 4
    minibatches, the JAX step's lane shuffle injected on both sides): the
    model on the card against the host within ``MODEL_TOL``, the loss and
    each gradient leaf at the initial params within ``LEARN_TOL["loss_rel"]``
    and 1e-4 of its largest, one optimizer step of that gradient and A3C's
    whole learn step within ``LEARN_TOL``'s relative L2, PPO's whole learn
    step (16 Adam steps) within ``PPO_SCHEDULE_UPDATE_REL_L2`` (its reason
    beside it); no kernel launches (neither runs V-trace or PER).  Then
    ``examples/train_{a3c,ppo}_torch.py`` at their CartPole defaults on
    ``TensorCartPole`` (``--env-backend jax``, stepped on the CPU, the
    learner on the card) for ``ONPOLICY_EXAMPLE_STEPS`` env steps: finite
    losses and env steps/s.  Then PPO's learn step inside
    ``DeviceActorLearnerLoop`` on ``TensorRecall`` as the
    ``ppo_recall_lstm`` recipe runs it (LSTM hidden 64, 32 lanes, T=8, 2
    iterations a chunk) for ``ONPOLICY_RECALL_CHUNKS`` chunks, every chunk
    after the first under ``set_sync_debug_mode("error")``."""
    import torch

    from scalerl_torch.agents.ppo import PPOAgent
    from scalerl_torch.config import A3CArguments, PPOArguments
    from scalerl_torch.envs.tensor_envs import TensorRecall
    from scalerl_torch.runtime.device_loop import DeviceActorLearnerLoop

    set_tf32(False)
    a3c_args, ppo_args = A3CArguments(max_timesteps=0), PPOArguments(max_timesteps=0)
    if (a3c_args.use_lstm, a3c_args.hidden_size, a3c_args.rollout_length, a3c_args.num_workers,
            ppo_args.use_lstm, ppo_args.hidden_size, ppo_args.ppo_epochs,
            ppo_args.num_minibatches) != (True, 256, 20, 8, False, 256, 4, 4):
        raise AssertionError(f"A3C/PPO defaults moved: {a3c_args}, {ppo_args}")
    T, B, A = 20, 8, 6
    perms = torch.stack([torch.randperm(B, generator=torch.Generator().manual_seed(e))
                         for e in range(ppo_args.ppo_epochs)])
    learn = {"a3c": _onpolicy_compare("a3c", a3c_args, T, B, A),
             "ppo": _onpolicy_compare("ppo", ppo_args, T, B, A, perms)}
    tol = {"model_max_abs_err": MODEL_TOL, "loss_rel": LEARN_TOL["loss_rel"],
           "grad_leaf_rel": ONPOLICY_GRAD_LEAF_REL,
           "update_rel_l2": LEARN_TOL["card_vs_host_update_rel_l2"],
           "learn_step_update_rel_l2": LEARN_TOL["card_vs_host_update_rel_l2"]}
    ppo_tol = {**tol, "learn_step_update_rel_l2": PPO_SCHEDULE_UPDATE_REL_L2}
    emit("onpolicy_learn", T=T, B=B, **learn, tol={"a3c": tol, "ppo": ppo_tol}, tf32=False,
         card=report["card"])
    bad = {(n, k): r[k] for n, r in learn.items()
           for k, bound in (tol if n == "a3c" else ppo_tol).items() if not r[k] <= bound}
    bad.update({(n, "launches"): r["kernel_launches"] for n, r in learn.items()
                if r["kernel_launches"] or r["skipped_steps"]})

    examples = {}
    for name in ("a3c", "ppo"):
        argv = ["--env-backend", "jax", "--env-id", "CartPole-v1", "--max-timesteps",
                str(ONPOLICY_EXAMPLE_STEPS), "--logger-frequency", "2000", "--eval-frequency",
                str(10**9), "--eval-episodes", "4", "--logger-backend", "none",
                "--telemetry-interval-s", "0", "--save-model", "false",
                "--work-dir", _work_dir(f"{name}_train")]
        _zero_launch_counts()
        t0 = time.perf_counter()
        out = _example_module(f"train_{name}_torch").main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        trainer = out["trainer"]
        losses = [m["total_loss"] for _, kind, m in trainer.log_history if kind == "train"]
        examples[name] = dict(
            seconds=seconds, env_steps=trainer.global_step,
            env_steps_per_s=trainer.global_step / seconds, learn_steps=trainer.learn_steps,
            learn_steps_per_s=trainer.learn_steps / seconds, logged_losses=len(losses),
            last_loss=losses[-1] if losses else None, launches=_launch_counts(),
            return_mean=out["result"].get("return_mean"), eval=out["eval"],
            skipped_steps=trainer.last_train_info.get("skipped_steps"))
        if not (losses and all(math.isfinite(x) for x in losses)
                and trainer.last_train_info.get("skipped_steps") == 0.0
                and not any(_launch_counts().values())):
            bad[(name, "example")] = examples[name]
    emit("onpolicy_examples", **examples, card=report["card"])

    Bp, Tp, iters = 32, 8, 2
    env = TensorRecall(Bp, size=16, delay=6, num_cues=4)
    args = PPOArguments(use_lstm=True, hidden_size=64, rollout_length=Tp, num_workers=Bp,
                        num_minibatches=2, ppo_epochs=2, max_timesteps=0, learning_rate=1e-3,
                        entropy_coef=0.02, gae_lambda=0.95)
    agent = PPOAgent(args, env.observation_shape, env.num_actions)
    loop = DeviceActorLearnerLoop(agent.model, env, agent.make_learn_fn(), Tp,
                                  iters_per_call=iters, seed=0)
    state, carry, _ = loop.run(agent.state, loop.init_carry(), 1, instrument=False)  # warm-up
    torch.cuda.synchronize()
    _zero_launch_counts()
    t0 = time.perf_counter()
    state, carry, m = loop.run(state, carry, ONPOLICY_RECALL_CHUNKS, instrument=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    frames = ONPOLICY_RECALL_CHUNKS * Bp * Tp * iters
    emit("onpolicy_device_loop", task="TensorRecall(16, delay 6, 4 cues)", lanes=Bp, T=Tp,
         iters_per_call=iters, chunks=ONPOLICY_RECALL_CHUNKS, seconds=seconds,
         env_frames_per_s=frames / seconds, learn_steps=int(state.step),
         learn_steps_per_s=ONPOLICY_RECALL_CHUNKS * iters / seconds,
         sync_guarded_chunks=ONPOLICY_RECALL_CHUNKS, last_chunk=m, launches=_launch_counts(),
         card=report["card"])
    if (int(state.step) != (ONPOLICY_RECALL_CHUNKS + 1) * iters
            or not math.isfinite(m["total_loss"]) or m["nonfinite_chunks"]
            or any(_launch_counts().values())):
        bad["device_loop"] = m
    if bad:
        raise AssertionError(f"onpolicy_train: {bad}")


class PendulumVectorView:
    """gym's vector-env API over ``num_envs`` copies of gymnasium's
    ``Pendulum-v1`` dynamics in numpy (the card's machine has no
    gymnasium): obs ``[cos th, sin th, thdot]``, torque in [-2, 2], reward
    ``-(th^2 + 0.1 thdot^2 + 0.001 u^2)`` with th normalised to [-pi, pi),
    episodes truncated at 200 steps, SAME_STEP autoreset with the last
    observation in ``infos["final_obs"]``.  Harness code, not a port
    feature."""

    MAX_SPEED, MAX_TORQUE, DT, G, M, L, STEPS = 8.0, 2.0, 0.05, 10.0, 1.0, 1.0, 200

    def __init__(self, num_envs: int) -> None:
        self.num_envs = num_envs
        high = np.array([self.MAX_TORQUE], np.float32)
        self.single_observation_space = SimpleNamespace(shape=(3,))
        self.single_action_space = SimpleNamespace(shape=(1,), low=-high, high=high)

    def _obs(self) -> np.ndarray:
        th, thdot = self.state[:, 0], self.state[:, 1]
        return np.stack([np.cos(th), np.sin(th), thdot], axis=1).astype(np.float32)

    def _reset_rows(self, rows) -> None:
        self.state[rows] = self.rng.uniform([-np.pi, -1.0], [np.pi, 1.0], (len(rows), 2))
        self.t[rows] = 0

    def reset(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.state = np.zeros((self.num_envs, 2))
        self.t = np.zeros(self.num_envs, int)
        self._reset_rows(np.arange(self.num_envs))
        return self._obs(), {}

    def step(self, actions):
        u = np.clip(np.asarray(actions, np.float64).reshape(self.num_envs), -self.MAX_TORQUE,
                    self.MAX_TORQUE)
        th, thdot = self.state[:, 0], self.state[:, 1]
        angle = ((th + np.pi) % (2 * np.pi)) - np.pi
        costs = angle**2 + 0.1 * thdot**2 + 0.001 * u**2
        thdot = np.clip(thdot + (3 * self.G / (2 * self.L) * np.sin(th)
                                 + 3.0 / (self.M * self.L**2) * u) * self.DT,
                        -self.MAX_SPEED, self.MAX_SPEED)
        self.state = np.stack([th + thdot * self.DT, thdot], axis=1)
        self.t += 1
        truncated = self.t >= self.STEPS
        infos = {}
        if truncated.any():
            infos = {"final_obs": self._obs(), "_final_obs": truncated.copy()}
            self._reset_rows(np.nonzero(truncated)[0])
        return self._obs(), -costs, np.zeros(self.num_envs, bool), truncated, infos

    def close(self) -> None:
        pass


def _continuous_agent(name: str, use_pallas: bool, device: str = "cuda"):
    from scalerl_torch.agents.sac import SACAgent
    from scalerl_torch.agents.td3 import TD3Agent
    from scalerl_torch.config import SACArguments, TD3Arguments

    cls, acls = (SACArguments, SACAgent) if name == "sac" else (TD3Arguments, TD3Agent)
    args = cls(use_per=True, use_pallas=use_pallas, max_timesteps=0)
    high = np.array([2.0], np.float32)
    return acls(args, (3,), -high, high, device=device)


def phase_continuous_learn(report: dict) -> None:
    """SAC and TD3 learn steps at their defaults (hidden 256,256, batch 32
    as in ``RLArguments``) with PER on the card, from a 65,536 x 16 replay
    of Pendulum-shaped transitions (obs 3, one float32 action): with
    ``use_pallas`` (both PER kernels sample and write the new priorities
    back) and without (the plain versions, the sample in the kernels' order
    of sums), the same noise injected in both legs; TD3 for two steps, so
    one delayed actor update is skipped and one applied.  Indices equal; the
    loss within ``RAINBOW_TOL["loss_rel"]`` and each leaf's gradient (Adam's
    first moment) within ``grad_leaf_rel`` of its largest between the legs,
    the priority plane within ``DQN_LEARN_TOL``; the card against the host
    within ``host_rel``; one sample and one update launch a step."""
    from unittest import mock

    import torch

    from scalerl_torch.data.prioritized import per_sample_from_uniforms
    from scalerl_torch.data.sampler import Sampler
    from scalerl_torch.ops import cuda_per, per

    set_tf32(False)
    g = torch.Generator(device="cuda").manual_seed(17)
    shape = (PER_CAPACITY, PER_NUM_ENVS)
    done = torch.rand(shape, generator=g, device="cuda") < 0.02
    contents = dict(
        obs=torch.randn(shape + (3,), generator=g, device="cuda"),
        next_obs=torch.randn(shape + (3,), generator=g, device="cuda"),
        action=torch.rand(shape + (1,), generator=g, device="cuda") * 4 - 2,
        reward=-torch.rand(shape, generator=g, device="cuda") * 16, done=done)
    priorities = torch.rand(shape, generator=g, device="cuda") * 2 + 0.05
    results = {}
    for name, steps in (("sac", 1), ("td3", 2)):
        B = 32
        u = [torch.rand(B, generator=g, device="cuda") for _ in range(steps)]
        noise = [({"next": torch.randn(B, 1, generator=g, device="cuda"),
                   "pi": torch.randn(B, 1, generator=g, device="cuda")} if name == "sac"
                  else torch.randn(B, 1, generator=g, device="cuda")) for _ in range(steps)]
        legs = {}
        for leg, use_pallas in (("plain", False), ("kernel", True)):
            agent = _continuous_agent(name, use_pallas)
            args = agent.args
            sampler = Sampler((3,), PER_CAPACITY, PER_NUM_ENVS, use_per=True,
                              per_alpha=args.per_alpha, gamma=args.gamma, action_shape=(1,),
                              action_dtype=torch.float32, use_pallas=use_pallas)
            state = sampler.buffer.state
            for k, v in contents.items():
                state.replay.storage[k].copy_(v)
            state.priorities.copy_(priorities)
            sampler.buffer.state = dataclasses.replace(
                state, replay=dataclasses.replace(state.replay, pos=777, size=PER_CAPACITY))
            cuda_per.sample_launches = cuda_per.update_launches = 0
            batches, losses = [], []
            for i in range(steps):
                with mock.patch.object(per, "hierarchical_sample",
                                       lambda p, t, bs: per.kernel_order_sample(p, t, bs)[0]):
                    batch = per_sample_from_uniforms(sampler.buffer.state, u[i], args.per_alpha,
                                                     args.per_beta, 1, args.gamma,
                                                     sampler.buffer.sample_method)
                agent.state, metrics, td_abs = agent._learn(agent.state, batch, noise[i])
                sampler.update_priorities(batch["indices"], td_abs + 1e-6)
                batches.append(batch)
                losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            legs[leg] = dict(
                batches=batches, losses=losses, state=agent.state,
                grads={f"{grp}.{k}": v / 0.1 for grp in ("critic_opt", "actor_opt")
                       for k, v in getattr(agent.state, grp)["mu"].items()},
                plane=sampler.buffer.state.priorities.clone(),
                launches=(cuda_per.sample_launches, cuda_per.update_launches))
        plain, kern = legs["plain"], legs["kernel"]
        host = _continuous_agent(name, False, device="cpu")
        h_losses = []
        for i in range(steps):
            host.state, hm, _ = host._learn(host.state, _to_device(plain["batches"][i], "cpu"),
                                            _to_device(noise[i], "cpu"))
            h_losses.append(float(hm["loss"]))
        h_grads = {f"{grp}.{k}": v / 0.1 for grp in ("critic_opt", "actor_opt")
                   for k, v in getattr(host.state, grp)["mu"].items()}
        actor_counts = (int(plain["state"].actor_opt["count"]),
                        int(kern["state"].actor_opt["count"]))
        results[name] = {
            "steps": steps,
            "index_mismatches": sum(int((p["indices"] != k["indices"]).sum())
                                    for p, k in zip(plain["batches"], kern["batches"])),
            "losses": {"plain": plain["losses"], "kernel": kern["losses"], "host": h_losses},
            "loss_rel_kernel_vs_plain": max(abs(k - p) / abs(p) for k, p in
                                            zip(kern["losses"], plain["losses"])),
            "grad_leaf_rel_kernel_vs_plain": _leaf_rel_err(kern["grads"], plain["grads"]),
            "plane_max_abs_err": float((kern["plane"] - plain["plane"]).abs().max()),
            "loss_rel_card_vs_host": max(abs(p - h) / abs(h) for p, h in
                                         zip(plain["losses"], h_losses)),
            "grad_leaf_rel_card_vs_host": _leaf_rel_err(plain["grads"], h_grads),
            "launches_kernel_leg": kern["launches"], "launches_plain_leg": plain["launches"],
            "actor_adam_count": actor_counts, "leaves": len(plain["grads"]),
        }
    emit("continuous_learn", batch=32, replay=list(shape), tol=RAINBOW_TOL, variants=results,
         tf32=False, card=report["card"])
    bad = {v: r for v, r in results.items() if (
        r["index_mismatches"] or r["loss_rel_kernel_vs_plain"] > RAINBOW_TOL["loss_rel"]
        or r["grad_leaf_rel_kernel_vs_plain"] > RAINBOW_TOL["grad_leaf_rel"]
        or r["plane_max_abs_err"] > DQN_LEARN_TOL
        or r["loss_rel_card_vs_host"] > RAINBOW_TOL["host_rel"]
        or r["grad_leaf_rel_card_vs_host"] > RAINBOW_TOL["host_rel"]
        or r["launches_kernel_leg"] != (r["steps"], r["steps"])
        or r["launches_plain_leg"] != (0, 0)
        or r["actor_adam_count"] != (1, 1))}
    if bad:
        raise AssertionError(f"continuous_learn: {bad}")


def phase_continuous_train(report: dict) -> None:
    """``OffPolicyTrainer`` with SAC, then with TD3, at their defaults
    (hidden 256,256) with the Pendulum recipe's replay (``tools/
    torch_learning_curves.py``: 4 envs, buffer 100,000, batch 128, warm-up
    1,000, a learn step every 2 env steps) and PER through both kernels
    (``use_per``, ``use_pallas``), on ``PendulumVectorView`` for
    ``CONTINUOUS_TRAIN_STEPS`` env steps: sample launches = update launches
    = learn steps > 0, finite losses, no skipped step; env and learn
    steps/s."""
    import torch

    from scalerl_torch.agents.sac import SACAgent
    from scalerl_torch.agents.td3 import TD3Agent
    from scalerl_torch.config import SACArguments, TD3Arguments
    from scalerl_torch.trainer.off_policy import OffPolicyTrainer
    from tools.torch_learning_curves import PENDULUM

    set_tf32(False)
    out, bad = {}, {}
    for name, cls, acls in (("sac", SACArguments, SACAgent), ("td3", TD3Arguments, TD3Agent)):
        args = cls(**{**PENDULUM, "max_timesteps": CONTINUOUS_TRAIN_STEPS, "use_per": True,
                      "use_pallas": True, "logger_frequency": 1000,
                      "work_dir": _work_dir(f"{name}_train")})
        envs = PendulumVectorView(args.num_envs)
        space = envs.single_action_space
        agent = acls(args, (3,), space.low, space.high)
        trainer = OffPolicyTrainer(args, agent, envs)
        _zero_launch_counts()
        t0 = time.perf_counter()
        try:
            summary = trainer.run()
        finally:
            trainer.close()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _launch_counts()
        losses = [m["loss"] for _, kind, m in trainer.log_history if kind == "train" and "loss" in m]
        out[name] = dict(
            seconds=seconds, env_steps=trainer.global_step,
            env_steps_per_s=trainer.global_step / seconds, learn_steps=trainer.learn_steps,
            learn_steps_per_s=trainer.learn_steps / seconds,
            per_sample_launches=launches["per_sample"],
            per_update_launches=launches["per_update"], logged_losses=len(losses),
            last_loss=losses[-1] if losses else None,
            skipped_steps=float(trainer.skipped_steps), episodes=summary.get("episodes"),
            return_mean=summary.get("return_mean"))
        if not (launches["per_sample"] == launches["per_update"] == trainer.learn_steps > 0
                and launches["vtrace"] == 0 and losses
                and all(math.isfinite(x) for x in losses)
                and float(trainer.skipped_steps) == 0.0):
            bad[name] = out[name]
    emit("continuous_train", envs=4, batch=128, buffer=100_000, **out, card=report["card"])
    if bad:
        raise AssertionError(f"continuous_train: {bad}")


# ---------------------------------------------------------------------------
# The serving plane: the inference server, its clients, the router

# lane counts of the flush check: buckets 1, 4, 8, 32 and 64 of the ladder
# (1, 2, 4, ..., 64) that ServingConfig's max_batch of 64 builds
SERVE_LANES = (1, 3, 8, 17, 33, 64)
SERVE_TIMED_REPS = 20
# the server runs a bucket's padded batch, the agent the request's lanes:
# cuDNN and cuBLAS may pick other algorithms for other batch sizes, so the
# two agree to rounding, not bit for bit (float32, TF32 off)
SERVE_TOL = 1e-4
SERVE_TRAIN_S = HOST_TRAIN_S
SERVE_PROFILE_STEPS = 1
# bench.py --mode traffic on an accelerator (bench.py:589-590)
# TRAFFIC_S is 6 s (8 before serving_on_shards, 10 before genrl_on_shards)
TRAFFIC_REPLICAS, TRAFFIC_CLIENTS, TRAFFIC_RPS, TRAFFIC_S, TRAFFIC_SLO_MS = 3, 16, 200.0, 6.0, 100.0
TRAFFIC_OBS, TRAFFIC_ACTIONS, TRAFFIC_LANES = 64, 16, 4


def _serve_payload(rng, lanes: int, A: int, core_size: int) -> dict:
    return {
        "obs": rng.integers(0, 256, (lanes, 84, 84, 4)).astype(np.uint8),
        "last_action": rng.integers(0, A, lanes).astype(np.int32),
        "reward": rng.normal(size=lanes).astype(np.float32),
        "done": rng.uniform(size=lanes) < 0.2,
        "core": tuple((0.5 * rng.normal(size=(lanes, core_size))).astype(np.float32)
                      for _ in range(4)),
    }


def phase_serving_flush(report: dict) -> None:
    """An ``InferenceServer`` holding ``ImpalaArguments``' LSTM ``AtariNet``
    (hidden 512, 84x84x4, 6 actions) at ``serve_max_batch`` 64, with its
    sync guard armed (it has the card to itself here): each of
    ``SERVE_LANES`` flushed cold, then warm under ``steady_state_guard()``.
    Each reply's logits and cores against the agent's own act on the card
    on the same inputs (``SERVE_TOL``), its actions against the argmax of the
    agent's logits plus the same injected Gumbel draws; one put and one get
    a flush, counted at the module seams; then each bucket's flush timed
    ``SERVE_TIMED_REPS`` times (host µs, the reply's read included)."""
    import torch

    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.agents.policy_value import pack_host_inputs
    from scalerl_torch.serving import InferenceServer, ServingConfig, ServingRequest, local_pair
    from scalerl_torch.serving import server as serving_server

    set_tf32(False)
    args = _default_args(env_id="PixelRing-v0", logger_backend="none")
    A = 6
    agent = ImpalaAgent(args, (84, 84, 4), A)
    cfg = ServingConfig.from_args(args)
    if (cfg.max_batch, cfg.max_wait_s, cfg.max_pending) != (64, 0.005, 256):
        raise AssertionError(f"ImpalaArguments' serving defaults moved: {cfg}")
    server = InferenceServer(agent, cfg, guard_warm_flushes=True)
    c_end, s_end = local_pair()
    server.hub.add_connection(s_end)
    counts = {"put": 0, "get": 0}
    put, get = serving_server._device_put, serving_server._device_get

    def counting_put(*a, **k):
        counts["put"] += 1
        return put(*a, **k)

    def counting_get(*a, **k):
        counts["get"] += 1
        return get(*a, **k)

    serving_server._device_put, serving_server._device_get = counting_put, counting_get
    noise: dict = {}
    server._gumbel = lambda logits: noise["g"]
    draws = torch.Generator(device="cuda").manual_seed(1)
    rng = np.random.default_rng(0)
    core_size = agent.initial_state(1)[0][0].shape[-1]
    cases, req = [], 0
    try:
        for lanes in SERVE_LANES:
            bucket = serving_server.bucket_for(lanes, server.batcher.buckets)
            for warm in (False, True):
                p = _serve_payload(rng, lanes, A, core_size)
                u = torch.rand((bucket, A), generator=draws, device="cuda").clamp_min(1e-38)
                noise["g"] = -torch.log(-torch.log(u))
                core = ((p["core"][0], p["core"][1]), (p["core"][2], p["core"][3]))
                server._flush([ServingRequest(conn=s_end, req_id=req, lanes=lanes,
                                              payload={**p, "core": core})])
                reply = c_end.recv(timeout=120.0)
                if reply.get("req") != req or "error" in reply:
                    raise AssertionError(f"serving_flush: reply {reply.get('req')} to {req}: "
                                         f"{reply.get('error')}")
                req += 1
                with torch.no_grad():
                    inputs = pack_host_inputs(p["obs"], p["last_action"], p["reward"], p["done"],
                                              agent.device)
                    dev_core = tuple((torch.from_numpy(c).cuda(), torch.from_numpy(h).cuda())
                                     for c, h in core)
                    logits, new_core = agent._forward(*inputs, dev_core)
                    scored = logits + noise["g"][:lanes]
                    top2 = torch.topk(scored, 2, dim=-1).values
                    want = scored.argmax(-1).cpu().numpy()
                    margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
                logit_err = float(np.abs(reply["logits"] - logits.cpu().numpy()).max())
                core_err = max(float(np.abs(got - w.cpu().numpy()).max())
                               for pair_got, pair_want in zip(reply["core"], new_core)
                               for got, w in zip(pair_got, pair_want))
                clear = margin > 2 * SERVE_TOL
                cases.append(dict(lanes=lanes, bucket=bucket, warm=warm, logit_err=logit_err,
                                  core_err=core_err,
                                  actions_equal=bool((reply["action"] == want)[clear].all()),
                                  near_ties=int((~clear).sum()),
                                  action_dtype=str(reply["action"].dtype)))
        flushes_checked = server.flushes
        timed = {}
        for lanes in SERVE_LANES:
            bucket = serving_server.bucket_for(lanes, server.batcher.buckets)
            p = _serve_payload(rng, lanes, A, core_size)
            core = ((p["core"][0], p["core"][1]), (p["core"][2], p["core"][3]))
            noise["g"] = torch.zeros((bucket, A), device="cuda")
            us = []
            for _ in range(SERVE_TIMED_REPS):
                t = time.perf_counter()
                server._flush([ServingRequest(conn=s_end, req_id=req, lanes=lanes,
                                              payload={**p, "core": core})])
                us.append((time.perf_counter() - t) * 1e6)
                c_end.recv(timeout=120.0)
                req += 1
            timed[f"{lanes} lanes"] = dict(bucket=bucket, flush_us_median=statistics.median(us),
                                           flush_us_min=min(us))
    finally:
        serving_server._device_put, serving_server._device_get = put, get
        server.hub.close()
    emit("serving_flush", model="AtariNet LSTM hidden 512, 84x84x4, 6 actions",
         config=dict(max_batch=cfg.max_batch, max_wait_s=cfg.max_wait_s,
                     max_pending=cfg.max_pending, buckets=list(server.batcher.buckets)),
         tolerance=SERVE_TOL, tf32=False, cases=cases, flushes=server.flushes,
         flushes_checked=flushes_checked, device_puts=counts["put"], device_gets=counts["get"],
         warm_buckets=sorted(server._warm_buckets), guarded_flushes=server.flushes - len(
             {c["bucket"] for c in cases}), flush_us=timed, card=report["card"])
    checks = {
        "logits within SERVE_TOL": all(c["logit_err"] <= SERVE_TOL for c in cases),
        "cores within SERVE_TOL": all(c["core_err"] <= SERVE_TOL for c in cases),
        "actions equal under injected draws": all(c["actions_equal"] for c in cases),
        "int32 actions": {c["action_dtype"] for c in cases} == {"int32"},
        "one put and one get a flush": counts["put"] == counts["get"] == server.flushes
        == server.device_puts == server.device_gets,
        "two buckets or more": len({c["bucket"] for c in cases}) >= 2,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"serving_flush: {failed}")


def phase_impala_serving(report: dict) -> None:
    """``HostActorLearnerTrainer(actor_mode="serving")`` at
    ``impala_trainer_host``'s defaults (8 actors of 1 ``PixelRingEnv``
    84x84x4, batch 8, 32 slots, the LSTM AtariNet, hidden 512, T=80, the
    V-trace kernel, ``serve_max_batch`` 64, 5 ms, 256): rates over about
    ``SERVE_TRAIN_S`` (to the first log boundary past it), then
    ``SERVE_PROFILE_STEPS`` learn steps of the same run under
    ``torch.profiler`` (the device's busy share, V-trace µs a call) before
    the stop.  The server's SLO, flushes, sheds, copies and staleness gauge;
    V-trace launches = learn steps, no client fallback, finite losses, no
    actor error or restart, and every admitted request answered or shed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.ops import cuda_vtrace
    from scalerl_torch.runtime import telemetry
    from scalerl_torch.trainer.actor_learner import HostActorLearnerTrainer

    set_tf32(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    root = _work_dir("impala_serving")
    args = _default_args(env_id="PixelRing-v0", logger_backend="none", work_dir=root,
                         telemetry_interval_s=0.0, save_model=False, logger_frequency=640,
                         actor_mode="serving")
    if (args.num_actors, args.num_buffers, args.serve_max_batch, args.serve_max_wait_ms,
            args.serve_max_pending) != (8, 32, 64, 5.0, 256):
        raise AssertionError(f"ImpalaArguments' serving defaults moved: {args}")
    reg = telemetry.get_registry()
    errors0 = reg.counter("queue.actor_errors").value
    fallbacks0 = reg.counter("serving_client.fallbacks").value
    client_sheds0 = reg.counter("serving_client.sheds").value
    reg.gauge("serving.staleness").set(-1.0)
    agent = ImpalaAgent(args, (84, 84, 4), 6)
    trainer = HostActorLearnerTrainer(args, agent, _pixel_ring_fns(args.num_actors))
    server = trainer.inference_server
    log = trainer.log
    state: dict = {}
    t0 = time.perf_counter()

    def log_and_stop(step, kind, m):
        log(step, kind, m)
        now = time.perf_counter()
        if "prof" in state:
            if trainer.learn_steps >= state["prof_from"] + SERVE_PROFILE_STEPS:
                torch.cuda.synchronize()
                state["prof"].stop()
                state["profiled_s"] = time.perf_counter() - state["prof_t0"]
                trainer.stop_event.set()
        elif now - t0 >= SERVE_TRAIN_S:
            torch.cuda.synchronize()
            now = time.perf_counter()
            state["rates"] = dict(seconds=now - t0, env_frames=trainer.env_frames,
                                  learn_steps=trainer.learn_steps,
                                  answered=server.answered, flushes=server.flushes)
            state["prof_from"] = trainer.learn_steps
            state["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            state["prof"].start()
            state["prof_t0"] = time.perf_counter()

    trainer.log = log_and_stop
    cuda_vtrace.launches = 0
    result = trainer.train(total_frames=10**9)
    torch.cuda.synchronize()
    launches = cuda_vtrace.launches
    trainer.close()
    if "profiled_s" not in state:
        raise AssertionError("impala_serving: the run stopped before its profile window closed")
    kernels = _kernel_table(state["prof"])
    busy_s = sum(us for _, us, _ in kernels) / 1e6
    vt = [(us, n) for k, us, n in kernels if "vtrace_kernel" in k]
    rates = state["rates"]
    sec = rates["seconds"]
    losses = [m["total_loss"] for _, kind, m in trainer.log_history if kind == "train"]
    acc = server.accounting()
    slo = server.slo()
    host = report.get("impala_trainer_host", {})
    emit("impala_serving", actors=args.num_actors, envs_per_actor=1, T=args.rollout_length,
         batch=args.batch_size, num_buffers=args.num_buffers, seconds=sec,
         env_frames=rates["env_frames"], env_frames_per_s=rates["env_frames"] / sec,
         learn_steps=rates["learn_steps"], learn_steps_per_s=rates["learn_steps"] / sec,
         threads_plane=host, requests_per_s=rates["answered"] / sec,
         flushes_per_s=rates["flushes"] / sec, slo=slo, accounting=acc,
         flushes=server.flushes, device_puts=server.device_puts,
         device_gets=server.device_gets, generation=server.generation,
         server_sheds=acc["shed"] + server.hub.shed_total,
         client_sheds=reg.counter("serving_client.sheds").value - client_sheds0,
         staleness=reg.gauge("serving.staleness").value,
         fallbacks=reg.counter("serving_client.fallbacks").value - fallbacks0,
         total_learn_steps=trainer.learn_steps, vtrace_launches=launches,
         skipped_steps=result.get("skipped_steps"), logged_losses=len(losses),
         actor_errors=reg.counter("queue.actor_errors").value - errors0,
         actor_restarts=trainer.actor_restarts,
         actor_ms_per_slot={k: v * 1e3 for k, v in trainer.actors[0].timings.means().items()},
         learner_ms_per_step={k: v * 1e3 for k, v in trainer.learn_timings.means().items()},
         card=report["card"])
    # what serving_on_shards reports its meshed rates beside
    report["impala_serving"] = dict(requests_per_s=rates["answered"] / sec,
                                    flushes_per_s=rates["flushes"] / sec)
    emit("impala_serving_profile", learn_steps=SERVE_PROFILE_STEPS,
         profiled_s=state["profiled_s"], device_busy_s=busy_s,
         device_busy_share=busy_s / state["profiled_s"] if kernels else None,
         kernel_launches=sum(n for _, _, n in kernels),
         vtrace_us_per_call=sum(us for us, _ in vt) / sum(n for _, n in vt) if vt else None,
         top_kernels=[{"name": k[:90], "ms": us / 1e3, "calls": n} for k, us, n in kernels[:10]],
         card=report["card"])
    checks = {
        "V-trace launches = learn steps": launches == trainer.learn_steps > 0,
        "no client fallback": reg.counter("serving_client.fallbacks").value == fallbacks0
        and not any(c.fallen_back for c in trainer._serving_clients),
        "finite losses": bool(losses) and all(math.isfinite(x) for x in losses),
        "no skipped steps": result.get("skipped_steps") == 0.0,
        "no actor errors": reg.counter("queue.actor_errors").value == errors0
        and trainer.actor_restarts == 0,
        "every admitted request answered or shed": acc["balanced"] and acc["pending"] == 0
        and acc["errors"] == 0 and acc["answered"] > 0,
        "one put and one get a flush": server.device_puts == server.device_gets
        == server.flushes > 0,
        "a generation a learn step": server.generation == trainer.learn_steps,
        "staleness gauge set": reg.gauge("serving.staleness").value >= 0.0,
        "profile shows V-trace": bool(vt),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"impala_serving: {failed}")


def phase_serving_traffic(report: dict) -> None:
    """The twin of ``bench.py --mode traffic`` on an accelerator
    (bench.py:545-780): ``TRAFFIC_REPLICAS`` servers of the obs-64,
    16-action, hidden-256 MLP policy behind ``ServingRouter``;
    ``TRAFFIC_CLIENTS`` clients fire open-loop Poisson arrivals (plus a
    burst a second) at ``TRAFFIC_RPS`` in all for ``TRAFFIC_S``, each request
    of 4 lanes traced (a ``traffic.request`` root, the router's and the
    replica's spans under it) into a ``TierLedger`` on the tracer.  Goodput
    under the ``TRAFFIC_SLO_MS`` SLO, latency from the scheduled arrival,
    the tier with the most attributed time and the p95 bottleneck; the
    router's ``admitted == answered + shed + orphaned`` must hold exactly."""
    import queue as queue_mod
    import threading

    import torch

    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.config import ImpalaArguments
    from scalerl_torch.runtime import tracing
    from scalerl_torch.runtime.attribution import TierLedger
    from scalerl_torch.serving import (
        InferenceServer,
        RemotePolicyClient,
        RouterConfig,
        ServingConfig,
        ServingRouter,
        connect_replica,
        local_pair,
    )

    set_tf32(True)
    args = ImpalaArguments(use_lstm=False, hidden_size=256, rollout_length=8, batch_size=4,
                           num_actors=1, num_buffers=2, max_timesteps=0, logger_backend="none")
    agent = ImpalaAgent(args, (TRAFFIC_OBS,), TRAFFIC_ACTIONS)
    servers = [InferenceServer(agent, ServingConfig(max_batch=32, max_wait_s=0.002))
               for _ in range(TRAFFIC_REPLICAS)]
    for srv in servers:
        srv.start()
    router = ServingRouter([connect_replica(srv, f"replica{i}") for i, srv in enumerate(servers)],
                           RouterConfig(hedge_budget=2, probe_backoff_s=0.05, seed=0))
    router.start()
    tracing.reset(sample_rate=1.0)
    ledger = TierLedger().attach(tracing.get_tracer())
    clients = []
    for _ in range(TRAFFIC_CLIENTS):
        c_end, r_end = local_pair()
        router.add_client(r_end)
        clients.append(RemotePolicyClient(conn=c_end, request_timeout_s=60.0))
    lanes = TRAFFIC_LANES
    rng = np.random.default_rng(0)
    la, rew, done = np.zeros(lanes, np.int32), np.zeros(lanes, np.float32), np.zeros(lanes, bool)
    try:
        # warm-up: until every replica has flushed (affinity can pin early
        # traffic to one replica, whose first flush would land in the window)
        warm_deadline = time.monotonic() + 120.0
        while any(srv.flushes == 0 for srv in servers) and time.monotonic() < warm_deadline:
            for c in clients:
                c.act(rng.normal(size=(lanes, TRAFFIC_OBS)).astype(np.float32), la, rew, done, ())
        if any(srv.flushes == 0 for srv in servers):
            raise AssertionError("serving_traffic: a replica never flushed in the warm-up")
        admitted0 = router.stats()["admitted"]
        per_client_rps = TRAFFIC_RPS / TRAFFIC_CLIENTS
        burst_every_s, burst_n = 1.0, max(2, int(per_client_rps // 4))
        stop = threading.Event()
        lat_s = [[] for _ in range(TRAFFIC_CLIENTS)]
        sheds = [0] * TRAFFIC_CLIENTS
        lost = [0] * TRAFFIC_CLIENTS

        def open_loop(i: int) -> None:
            local = np.random.default_rng(1000 + i)
            c = clients[i]
            inflight: queue_mod.Queue = queue_mod.Queue()

            def drain() -> None:
                while True:
                    item = inflight.get()
                    if item is None:
                        return
                    pending, t_sched, span = item
                    try:
                        reply = pending.result(timeout=30.0)
                    except (TimeoutError, ConnectionError):
                        lost[i] += 1
                        span.end(outcome="lost")
                        continue
                    t_done = time.perf_counter()
                    if reply.get("shed"):
                        sheds[i] += 1
                        span.end(outcome="shed")
                    else:
                        lat_s[i].append(t_done - t_sched)
                        span.end(outcome="ok")

            drainer = threading.Thread(target=drain, daemon=True)
            drainer.start()

            def fire(t_sched: float) -> None:
                span = tracing.start_span("traffic.request", kind="serving")
                msg = c._act_msg(local.normal(size=(lanes, TRAFFIC_OBS)).astype(np.float32),
                                 la, rew, done, ())
                tracing.inject(msg, span)
                inflight.put((c._submit(msg), t_sched, span))

            t_start = time.perf_counter()
            next_poisson = t_start + local.exponential(1.0 / per_client_rps)
            next_burst = t_start + burst_every_s
            while not stop.is_set():
                now = time.perf_counter()
                while next_poisson <= now:
                    fire(next_poisson)
                    next_poisson += local.exponential(1.0 / per_client_rps)
                if next_burst <= now:
                    for _ in range(burst_n):
                        fire(next_burst)
                    next_burst += burst_every_s
                time.sleep(min(0.002, max(next_poisson - now, 0.0)))
            inflight.put(None)
            drainer.join(timeout=60.0)

        threads = [threading.Thread(target=open_loop, args=(i,), daemon=True)
                   for i in range(TRAFFIC_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        time.sleep(TRAFFIC_S)
        stop.set()
        for t in threads:
            t.join(timeout=90.0)
        elapsed = time.perf_counter() - t0
        deadline = time.monotonic() + 30.0
        while router.stats()["inflight"] > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        torch.cuda.synchronize()
        stats = router.stats()
        ledger.drain()
        bn = ledger.bottleneck()
    finally:
        ledger.detach(tracing.get_tracer())
        tracing.reset(sample_rate=0.0)
        for c in clients:
            c.close()
        router.stop()
        for srv in servers:
            srv.stop()
    balanced = stats["answered"] + stats["shed"] + stats["orphaned"] == stats["admitted"]
    lat = np.sort(np.concatenate([np.asarray(v) for v in lat_s]) if any(lat_s) else np.zeros(0))
    good = int(np.searchsorted(lat, TRAFFIC_SLO_MS / 1e3, side="right"))

    def q(x: float) -> float:
        return float(lat[min(int(x * lat.size), lat.size - 1)]) * 1e3 if lat.size else 0.0

    top_tier = max(bn["tiers"], key=lambda t: bn["tiers"][t]["total_s"], default="")
    emit("serving_traffic", replicas=TRAFFIC_REPLICAS, clients=TRAFFIC_CLIENTS,
         lanes=lanes, offered_rps_target=TRAFFIC_RPS, slo_ms=TRAFFIC_SLO_MS,
         measured_s=elapsed, goodput_rps=good / elapsed,
         offered_rps=(lat.size + sum(sheds)) / elapsed, answered=int(lat.size), good=good,
         shed=sum(sheds), lost=sum(lost), p50_ms=q(0.50), p95_ms=q(0.95), p99_ms=q(0.99),
         router=dict(admitted=stats["admitted"], admitted_in_window=stats["admitted"] - admitted0,
                     answered=stats["answered"], shed=stats["shed"], orphaned=stats["orphaned"],
                     retries=stats["retries"], ejections=stats["ejections"],
                     duplicate_replies=stats["duplicate_replies"]),
         accounting_balanced=balanced, flushes=[srv.flushes for srv in servers],
         top_tier_by_time=top_tier, bottleneck_tier_p95=bn["bottleneck_tier"], tiers=bn["tiers"],
         attribution=dict(decomposed=bn["decomposed"], orphans=bn["orphans"],
                          late_spans=bn["late_spans"], max_sum_err_s=bn["max_sum_err_s"]),
         card=report["card"])
    checks = {
        "admitted == answered + shed + orphaned": balanced,
        "answers in the window": lat.size > 0,
        "no request lost": sum(lost) == 0,
        "tiers attributed": bn["decomposed"] > 0 and bn["max_sum_err_s"] < 1e-6,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"serving_traffic: {failed}")


# ---------------------------------------------------------------------------
# the fleet: host CPU actors feeding the learner on the card

FLEET_TRAIN_S = 2.0  # 3 s before serving_on_shards, 5 before genrl_on_shards, 8 before phases 51-55
FLEET_ELASTIC_S = 20.0
A3C_FLEET_S = 3.0  # 4 s before serving_on_shards, 6 before 51-55 joined the script
MARL_STEPS = 700  # env steps a lane, 8 lanes: ~6 s on the card's host (1,000 before serving_on_shards)
FLEET_DQN_EPISODES = 45  # 60 before serving_on_shards, 100 before impala_anakin joined (why: at IMPACT_TRAIN_S), 200 before 51-55
# the elastic wave: the supervisor draws from this seed's mass_kill stream
# every 0.5 s once the learner has taken its first step, and the stream
# first fires at its 10th draw, ~5 s into the window; at most one wave,
# half the gathers
FLEET_CHAOS = "62:mass_kill=0.1@1,kills=0"


def _fleet_example(name: str):
    """An entry-point twin imported by name (``examples/`` on ``sys.path``),
    so that the gathers it spawns unpickle its runners."""
    import importlib

    examples = str(Path(__file__).resolve().parent / "examples")
    if examples not in sys.path:
        sys.path.insert(0, examples)
    return importlib.import_module(name)


def _fleet_accounting(name: str, out: dict) -> dict:
    """Every issued rollout task answered exactly once after the drain."""
    acct = {k: out[k] for k in ("issued", "answered", "answered_unique", "answered_twice",
                                "unanswered", "requeued_tasks", "duplicate_results",
                                "duplicate_tasks", "dropped_results", "worker_errors_total")}
    if not (acct["issued"] == acct["answered"] == acct["answered_unique"] > 0
            and acct["answered_twice"] == 0 and acct["unanswered"] == 0):
        raise AssertionError(f"{name}: task accounting {acct}")
    return acct


def phase_fleet_impala(report: dict) -> None:
    """``examples/train_fleet_impala_torch.py`` at the JAX example's width
    (MLP hidden 64, no LSTM, T=16, 8 lanes a batch from 4 chunks of 2 lanes,
    4 spawned workers on ``TensorCartPole`` on the CPU, numpy inference).
    First one learn step on a fleet batch (the workers' chunk runner at the
    initial weights) with the V-trace kernel on the card against the plain
    V-trace on the card and the plain step on the host, float32 with TF32
    off (``LEARN_TOL``); one launch in the kernel step, none in the plain.
    Then the twin with ``use_pallas`` for ``FLEET_TRAIN_S``, followed by its
    drain: V-trace launches = learn calls (the learn steps and the warm-up
    that builds the kernel before the workers start), every issued task
    answered exactly once (requeues and dropped duplicates reported), finite
    losses; env frames/s, learn steps/s, policy lag and the ``fleet.*``
    telemetry tree."""
    import torch

    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.data.trajectory import batch_to_trajectory
    from scalerl_torch.ops import cuda_vtrace

    ex = _fleet_example("train_fleet_impala_torch")
    set_tf32(False)
    args = ex.fleet_impala_args(use_pallas=True)
    runner = ex.ChunkRunner(num_lanes=2, rollout_length=16)
    base = ImpalaAgent(args, (ex.OBS_DIM,), ex.NUM_ACTIONS, device="cpu")
    weights = {k: v.numpy() for k, v in base.get_weights().items()}
    batch = ex.fleet_batch([runner({"role": "rollout", "seed": s}, weights, 0)
                            for s in range(4)])
    steps = {}
    for name, use_pallas, device in (("kernel", True, "cuda"), ("plain", False, "cuda"),
                                     ("host", False, "cpu")):
        agent = ImpalaAgent(dataclasses.replace(args, use_pallas=use_pallas), (ex.OBS_DIM,),
                            ex.NUM_ACTIONS, device=device)
        agent.state = _to_device(base.state, device)
        cuda_vtrace.launches = 0
        metrics = agent.learn(batch_to_trajectory(batch, agent.device))
        torch.cuda.synchronize()
        steps[name] = (metrics, cuda_vtrace.launches,
                       _flat_update(agent.state.params, base.state.params))
    (m_k, l_k, u_k), (m_p, l_p, u_p), (m_h, _, u_h) = (steps[k] for k in ("kernel", "plain",
                                                                          "host"))
    learn = {
        "loss_rel": _rel(m_k["total_loss"], m_p["total_loss"]),
        "grad_norm_rel": _rel(m_k["grad_norm"], m_p["grad_norm"]),
        "kernel_vs_plain_update_abs": (u_k - u_p).abs().max().item(),
        "card_vs_host_loss_rel": _rel(m_p["total_loss"], m_h["total_loss"]),
        "card_vs_host_update_rel_l2": ((u_k - u_h).norm() / u_h.norm()).item(),
    }
    tol = {"loss_rel": LEARN_TOL["loss_rel"], "grad_norm_rel": LEARN_TOL["grad_norm_rel"],
           "kernel_vs_plain_update_abs": LEARN_TOL["kernel_vs_plain_update_abs"],
           "card_vs_host_loss_rel": LEARN_TOL["loss_rel"],
           "card_vs_host_update_rel_l2": LEARN_TOL["card_vs_host_update_rel_l2"]}
    bad = {k: v for k, v in learn.items() if not v <= tol[k]}
    if bad or (l_k, l_p) != (1, 0):
        raise AssertionError(f"fleet_impala learn step: {bad}, launches {l_k}/{l_p}")

    set_tf32(True)
    _zero_launch_counts()
    out = ex.train_fleet_impala(total_frames=10**9, num_workers=4, use_pallas=True,
                                device="cuda", max_seconds=FLEET_TRAIN_S, log_every=0)
    launches = _launch_counts()
    acct = _fleet_accounting("fleet_impala", out)
    loss = out["metrics"].get("total_loss", float("nan"))
    emit("fleet_impala", T=16, B=8, hidden=64, workers=4, lanes_per_worker=2,
         learn_step=learn, tol=tol, vtrace_launches_kernel_step=l_k,
         vtrace_launches_plain_step=l_p, window_s=round(out["wall_s"], 2),
         env_frames=out["env_frames"], learn_steps=out["learn_steps"],
         learn_calls=out["learn_calls"], vtrace_launches=launches["vtrace"],
         env_frames_per_s=out["env_frames_per_s"],
         learn_steps_per_s=out["learn_steps_per_s"], policy_lag_mean=out["lag_mean"],
         policy_lag_max=out["lag_max"], episodes=out["episodes"],
         return_last50=out["return_last50"], total_loss=loss, tasks=acct,
         drained_frames=out["drained_frames"], weight_version=out["weight_version"],
         boot_s=round(out["boot_s"], 2),
         fleet_telemetry=out["fleet_telemetry"], card=report["card"])
    others = {k: v for k, v in launches.items() if k != "vtrace" and v}
    if (launches["vtrace"] != out["learn_calls"] or out["learn_steps"] <= 0 or others
            or not math.isfinite(loss) or out["worker_errors_total"]):
        raise AssertionError(f"fleet_impala: launches {launches} for {out['learn_calls']} "
                             f"learn calls, loss {loss}, errors {out['worker_errors_total']}")


def phase_fleet_elastic(report: dict) -> None:
    """``tools/elastic_soak.py``'s scenario with the learner on the card: the
    fleet IMPALA twin (4 workers, one a gather, ``use_pallas``) under the
    seeded ``mass_kill`` wave of ``FLEET_CHAOS`` (half the gathers killed
    once), with the autoscaler on (the floor rule backfills through
    ``ClusterExecutor``; the starved rule off, as the soak has it) for
    ``FLEET_ELASTIC_S``, then the drain.  The wave's stream is held shut
    until the learner's first step in this run, so the wave lands on a
    fleet that is answering.  Checks: the wave came after the first learn
    step, in-flight tasks were requeued, ``lost`` = 0 (every issued task
    answered exactly once), the autoscaler scaled up, the spawned workers
    are back at 4 when the window closes, and V-trace launches = learn
    calls.  Reports the autoscaler's decisions, the wave's time and the
    fleet's boot time."""
    from scalerl_torch.runtime import chaos, telemetry

    learns = telemetry.get_registry().meter("rates.learn_steps_per_s")

    class AfterFirstLearn(chaos.FaultInjector):
        """Draws no wave until the learner has stepped in this run."""

        def __init__(self, plan):
            super().__init__(plan)
            self.learns_before = learns.total
            self.opened_at = None

        def mass_kill_victims(self, n_peers, site="fleet"):
            if learns.total <= self.learns_before:
                return []
            if self.opened_at is None:
                self.opened_at = time.monotonic()
            return super().mass_kill_victims(n_peers, site)

    ex = _fleet_example("train_fleet_impala_torch")
    plan = FLEET_CHAOS
    injector = AfterFirstLearn(chaos.ChaosPlan.parse(plan))
    chaos.install(injector)
    recorder = telemetry.get_recorder()
    seq0 = recorder.total_recorded
    _zero_launch_counts()
    t_start = time.monotonic()
    try:
        out = ex.train_fleet_impala(
            total_frames=10**9, num_workers=4, workers_per_gather=1, use_pallas=True,
            device="cuda", max_seconds=FLEET_ELASTIC_S, log_every=0, autoscale=True,
            autoscale_config=dict(interval_s=0.25, cooldown_s=1.0, up_hysteresis=1,
                                  down_hysteresis=2, low_occupancy=-1.0))
    finally:
        chaos.clear()
    launches = _launch_counts()
    events = [e for e in recorder.events() if e["seq"] >= seq0]
    waves = [e for e in events if e["kind"] == "mass_kill"]
    decisions = [{k: e.get(k) for k in ("action", "delta", "reason", "workers")}
                 for e in events if e["kind"] == "autoscale_decision"]
    killed = sum(len(e.get("victims", [])) for e in waves)
    acct = _fleet_accounting("fleet_elastic", out)
    lost = acct["issued"] - acct["answered_unique"]
    scaler = out["autoscaler"]
    opened = injector.opened_at
    wave_after_learn = [round(e["t_mono"] - opened, 2) for e in waves] if opened else []
    emit("fleet_elastic", chaos=plan, workers_target=4, workers_at_end=out["workers_at_end"],
         waves=len(waves), gathers_killed=killed, lost=lost,
         wave_s_after_start=[round(e["t_mono"] - t_start, 2) for e in waves],
         wave_s_after_first_learn=wave_after_learn, boot_s=round(out["boot_s"], 2),
         duplicates_delivered=acct["answered_twice"], tasks=acct, autoscaler=scaler,
         decisions=decisions, learn_steps=out["learn_steps"],
         vtrace_launches=launches["vtrace"], learn_calls=out["learn_calls"],
         env_frames_per_s=out["env_frames_per_s"], learn_steps_per_s=out["learn_steps_per_s"],
         window_s=round(out["wall_s"], 2), card=report["card"])
    if (lost != 0 or not waves or killed == 0 or min(wave_after_learn, default=-1.0) < 0
            or acct["requeued_tasks"] <= 0
            or scaler["scale_ups"] < 1 or out["workers_at_end"] != 4
            or launches["vtrace"] != out["learn_calls"] or out["learn_steps"] <= 0):
        raise AssertionError(f"fleet_elastic: lost {lost}, waves {len(waves)} at "
                             f"{wave_after_learn} s after the first learn step, killed "
                             f"{killed}, requeued {acct['requeued_tasks']}, autoscaler "
                             f"{scaler}, workers {out['workers_at_end']}, "
                             f"launches {launches['vtrace']} / {out['learn_calls']}")


def phase_a3c_fleet(report: dict) -> None:
    """``examples/train_a3c_fleet_torch.py``.  First one applied gradient: a
    worker's A2C gradient (a 32-step rollout of 4 ``TensorCartPole`` lanes
    on the CPU at the initial weights, MLP 128,128) applied with the A3C
    optimizer (clip, then Adam) on the card and on the host, float32 with
    TF32 off: the update within ``LEARN_TOL``'s card-vs-host relative L2,
    as the on-policy phase holds A3C's.  Then the twin with 2 spawned
    workers for ``A3C_FLEET_S``: every gradient applied and republished
    (weight version = applied + 1), no kernel launch (A3C runs no V-trace);
    applied gradients/s and env frames/s."""
    import torch

    from scalerl_torch.agents.a3c import build_model, make_a3c_optimizer
    from scalerl_torch.config import A3CArguments
    from scalerl_torch.envs.tensor_envs import make_tensor_vec_env

    ex = _fleet_example("train_a3c_fleet_torch")
    set_tf32(False)
    args = A3CArguments(hidden_sizes="128,128", learning_rate=3e-3, entropy_coef=0.01, seed=0)
    model = build_model(args, (4,), 2, device="cpu", generator=torch.Generator().manual_seed(0))
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    venv = make_tensor_vec_env("CartPole-v1", 4, device="cpu")
    g = torch.Generator().manual_seed(1)
    state, obs = venv.reset(g)
    carry = (state, obs, torch.zeros(4, dtype=torch.int64), torch.zeros(4),
             torch.ones(4, dtype=torch.bool), torch.zeros(4))
    _, traj, _, _ = ex.rollout(params, model, venv, carry, 32, g)
    loss, grads = ex.a3c_fleet_grads({k: v.numpy() for k, v in params.items()}, model, traj,
                                     args)
    optimizer = make_a3c_optimizer(args)
    updates = {}
    for device in ("cuda", "cpu"):
        p = _to_device(params, device)
        new, _ = ex.apply_fleet_grads(optimizer, p, optimizer.init(p), grads)
        updates[device] = _flat_update(new, params)
    u_c, u_h = updates["cuda"], updates["cpu"]
    applied = {"update_rel_l2": ((u_c - u_h).norm() / u_h.norm()).item(),
               "update_max_abs_err": (u_c - u_h).abs().max().item(), "loss": loss}
    set_tf32(True)
    _zero_launch_counts()
    out = ex.train_a3c_fleet(num_workers=2, total_frames=10**9, seed=0, device="cuda",
                             max_seconds=A3C_FLEET_S)
    launches = _launch_counts()
    emit("a3c_fleet", workers=2, lanes_per_worker=4, T=32, hidden="128,128",
         applied_gradient=applied, tol=LEARN_TOL["card_vs_host_update_rel_l2"],
         applied_updates=out["applied_updates"], applied_per_s=out["applied_per_s"],
         env_frames=out["env_frames"], env_frames_per_s=out["env_frames_per_s"],
         env_frames_per_s_whole_run=out["fps"],
         windowed_return=out["windowed_return"], weight_version=out["weight_version"],
         window_s=out["wall_s"], kernel_launches=sum(launches.values()), card=report["card"])
    if (not applied["update_rel_l2"] <= LEARN_TOL["card_vs_host_update_rel_l2"]
            or out["applied_updates"] <= 0 or sum(launches.values())
            or out["weight_version"] != out["applied_updates"] + 1):
        raise AssertionError(f"a3c_fleet: {applied}, applied {out['applied_updates']}, "
                             f"version {out['weight_version']}, launches {launches}")


def phase_marl_dqn(report: dict) -> None:
    """``examples/train_marl_dqn_torch.py``: independent DQN for both agents
    of ``PursuitToyEnv`` over ``AsyncMultiAgentVecEnv`` (8 env processes on
    the host, the learners on the card).  First each agent's learn step on a
    batch from a replay of PursuitToy steps, card against host from the same
    state, float32 with TF32 off: the loss within ``LEARN_TOL["loss_rel"]``
    and the update within its card-vs-host relative L2.  Then the twin for
    ``MARL_STEPS`` steps a lane: finite losses, env steps/s, and the learned
    policies against random opponents (reported; the learning row is
    ``tools/torch_learning_curves.py``'s ``marl_pursuit_iql``)."""
    import torch

    from scalerl_torch.agents.dqn import DQNAgent
    from scalerl_torch.data.sampler import Sampler
    from scalerl_torch.envs.multi_agent import PursuitToyEnv

    ex = _fleet_example("train_marl_dqn_torch")
    set_tf32(False)
    env = PursuitToyEnv()
    rng = np.random.default_rng(0)
    samplers = {a: Sampler((4,), 4096, device="cpu") for a in env.possible_agents}
    obs, _ = env.reset(seed=0)
    for _ in range(600):
        acts = {a: int(rng.integers(3)) for a in env.possible_agents}
        nxt, rew, term, trunc, _ = env.step(acts)
        for a in env.possible_agents:
            samplers[a].add(obs[a][None], nxt[a][None], np.array([acts[a]]),
                            np.array([rew[a]], np.float32), np.array([term[a]]))
        obs = env.reset()[0] if (term["chaser"] or trunc["chaser"]) else nxt
    learn = {}
    for i, a in enumerate(env.possible_agents):
        args = ex.marl_agent_args(i, a, 32_000, 64, 0)
        batch = samplers[a].sample(64, generator=torch.Generator().manual_seed(i))
        base = DQNAgent(args, (4,), 3, device="cpu")
        out = {}
        for device in ("cuda", "cpu"):
            agent = DQNAgent(args, (4,), 3, device=device)
            agent.state = _to_device(base.state, device)
            metrics = agent.learn(_to_device(batch, device))
            out[device] = (float(metrics["loss"]),
                           _flat_update(agent.state.params, base.state.params))
        (l_c, u_c), (l_h, u_h) = out["cuda"], out["cpu"]
        learn[a] = {"loss_rel": _rel(l_c, l_h),
                    "update_rel_l2": ((u_c - u_h).norm() / u_h.norm()).item()}
    tol = {"loss_rel": LEARN_TOL["loss_rel"],
           "update_rel_l2": LEARN_TOL["card_vs_host_update_rel_l2"]}
    bad = {(a, k): v for a, r in learn.items() for k, v in r.items() if not v <= tol[k]}
    set_tf32(True)
    _zero_launch_counts()
    s = ex.run_marl(num_envs=8, max_steps=MARL_STEPS, seed=0, device="cuda", eval_episodes=100)
    launches = _launch_counts()
    emit("marl_dqn", agents=list(learn), learn_step=learn, tol=tol, num_envs=8,
         env_frames=s["env_frames"], env_steps_per_s=s["fps"], window_s=s["wall_s"],
         learn_steps=s["learn_steps"], final_returns=s["final_returns"],
         matchups={k: s[k] for k in ("trained_chaser_vs_random", "random_vs_random",
                                     "random_vs_trained_runner")},
         kernel_launches=sum(launches.values()), card=report["card"])
    if bad or s["learn_steps"] <= 0 or sum(launches.values()):
        raise AssertionError(f"marl_dqn: {bad}, learn steps {s['learn_steps']}, "
                             f"launches {launches}")


def phase_fleet_dqn(report: dict) -> None:
    """``examples/train_fleet_dqn_torch.py``: epsilon-greedy CartPole
    episodes from spawned fleet workers (numpy inference on the CPU) into
    the uniform ``ReplayBuffer`` on the card that ``DQNAgent`` samples with
    a generator on the card.  First the replay: the same fleet episodes
    saved on the card and on the host hold the same transitions, and one
    learn step on a batch drawn from the host's, card against host from the
    same state, float32 with TF32 off (``LEARN_TOL``'s loss and relative
    L2).  Then the twin with its 4 workers for ``FLEET_DQN_EPISODES``
    episodes: each episode answered once, learn steps on the card, finite
    loss, no kernel launch (the replay is uniform); env steps/s and learn
    steps/s."""
    import torch

    from scalerl_torch.agents.dqn import DQNAgent
    from scalerl_torch.config import DQNArguments
    from scalerl_torch.data.replay import ReplayBuffer

    ex = _fleet_example("train_fleet_dqn_torch")
    set_tf32(False)
    args = DQNArguments(hidden_sizes="128,128", learning_rate=1e-3)
    base = DQNAgent(args, (ex.OBS_DIM,), ex.NUM_ACTIONS, device="cpu")
    weights = {k: v.numpy() for k, v in base.get_weights().items()}
    episodes = [ex.episode_runner({"seed": s, "eps": 0.2}, weights, 0) for s in range(1, 9)]
    chunk = {k: np.concatenate([e[k] for e in episodes])[:, None] for k in ex.TRANSITION_KEYS}
    replays = {}
    for device in ("cuda", "cpu"):
        replays[device] = ReplayBuffer(obs_shape=(ex.OBS_DIM,), capacity=50_000, num_envs=1,
                                       device=device)
        replays[device].save_chunk(**chunk)
    rc, rh = replays["cuda"].state, replays["cpu"].state
    same_replay = ((rc.pos, rc.size) == (rh.pos, rh.size)
                   and all(torch.equal(rc.storage[k].cpu(), v) for k, v in rh.storage.items()))
    batch = replays["cpu"].sample(64, torch.Generator().manual_seed(0))
    steps = {}
    for device in ("cuda", "cpu"):
        agent = DQNAgent(args, (ex.OBS_DIM,), ex.NUM_ACTIONS, device=device)
        agent.state = _to_device(base.state, device)
        metrics = agent.learn(_to_device(batch, device))
        steps[device] = (float(metrics["loss"]),
                         _flat_update(agent.state.params, base.state.params))
    (l_c, u_c), (l_h, u_h) = steps["cuda"], steps["cpu"]
    learn = {"loss_rel": _rel(l_c, l_h), "update_rel_l2": ((u_c - u_h).norm() / u_h.norm()).item()}
    tol = {"loss_rel": LEARN_TOL["loss_rel"],
           "update_rel_l2": LEARN_TOL["card_vs_host_update_rel_l2"]}
    bad = {k: v for k, v in learn.items() if not v <= tol[k]}
    set_tf32(True)
    _zero_launch_counts()
    out = ex.train_fleet_dqn(episodes=FLEET_DQN_EPISODES, device="cuda", log_every=0)
    launches = _launch_counts()
    loss = out["metrics"].get("loss", float("nan"))
    emit("fleet_dqn", workers=4, hidden="128,128", batch=64, replay_transitions=len(chunk["action"]),
         same_replay=same_replay, learn_step=learn, tol=tol, episodes=out["episodes"],
         unique_episodes=out["unique_episodes"], transitions=out["transitions"],
         learn_steps=out["learn_steps"], env_steps_per_s=out["env_steps_per_s"],
         learn_steps_per_s=out["learn_steps_per_s"], window_s=round(out["wall_s"], 2),
         learner_device=str(out["agent"].device), weight_version=out["weight_version"],
         return_first20=out["return_first20"], return_last20=out["return_last20"], loss=loss,
         kernel_launches=sum(launches.values()), card=report["card"])
    if (bad or not same_replay or out["unique_episodes"] != FLEET_DQN_EPISODES
            or out["learn_steps"] <= 0 or not math.isfinite(loss)
            or out["agent"].device.type != "cuda" or sum(launches.values())):
        raise AssertionError(f"fleet_dqn: {bad}, same replay {same_replay}, episodes "
                             f"{out['unique_episodes']}, learn steps {out['learn_steps']}, "
                             f"loss {loss}, launches {launches}")


# The rest of sequence RL (phases 51-55): speculative decoding at
# bench.py's A/B width (bench.py:1351-1354), quantized snapshots, and the
# disaggregated trainer at genrl_train's width
SPEC_V, SPEC_D, SPEC_LAYERS, SPEC_HEADS = 64, 256, 4, 8
SPEC_P, SPEC_R, SPEC_LANES, SPEC_PAGE, SPEC_MACRO = 32, 512, 64, 16, 8
SPEC_K, SPEC_NGRAM = 24, 3
SPEC_ROUNDS = 1  # measured (off, on) round pairs after one warm-up pair
DISAGG_TRAIN_S = 3.0  # 5 s before genrl_on_shards, 7 before shard_compute, 10 before impala_anakin
DISAGG_CONT_ROUNDS = 2
# one bf16 learn step, segment kernels against the dense mask: both sides
# compute in bf16 and round in other places, held as the bf16 flash
# learner check holds it (transformer_learn)
DISAGG_BF16_LOSS_REL = 2.0 ** -5
# a dequantized int8 element lies within half a scale of its source in exact
# arithmetic; in float32 the division x / s may round |x/s - q| past 0.5 by
# up to 127 * 2^-24, and the product q * s rounds by up to 2^-24 of itself
# (|q| <= 127), so the bound is s * (0.5 + 2 * 127 * 2^-24)
INT8_DEQ_SLACK = 2 * 127 * 2.0 ** -24
SOAK_HOSTS, SOAK_LANES, SOAK_RESPONSE, SOAK_VOCAB = 2, 8, 8, 32
SOAK_ROUNDS = 6  # learn rounds the soak's lease budget covers (8 before serving_on_shards)
PREEMPT_WARM_ROUNDS, PREEMPT_ROUNDS = 2, 3
THREAD_JOIN_S = 10.0


def phase_genrl_spec(report: dict) -> None:
    """Speculative decoding A/B at bench.py's accelerator width: the same
    greedy rounds with speculation off and on, interleaved."""
    import torch

    from scalerl_torch.genrl.continuous import ContinuousConfig, ContinuousEngine
    from scalerl_torch.genrl.task import TokenRecallTask
    from scalerl_torch.models.transformer import TransformerPolicy
    from scalerl_torch.ops import cuda_paged_attention

    set_tf32(False)
    model = TransformerPolicy(num_actions=SPEC_V, vocab_size=SPEC_V, d_model=SPEC_D,
                              num_heads=SPEC_HEADS, num_layers=SPEC_LAYERS,
                              max_len=2 * (SPEC_P + SPEC_R), device="cuda",
                              generator=torch.Generator().manual_seed(2))
    params = model.state_dict()
    base = dict(vocab_size=SPEC_V, max_prompt_len=SPEC_P, max_new_tokens=SPEC_R,
                temperature=0.0, eos_token=-1, seed=0, lanes=SPEC_LANES, page_size=SPEC_PAGE,
                steps_per_macro=SPEC_MACRO, prompt_buckets=(SPEC_P,))
    engines = {"off": ContinuousEngine(model, params, ContinuousConfig(**base)),
               "on": ContinuousEngine(model, params,
                                      ContinuousConfig(spec_k=SPEC_K, spec_ngram=SPEC_NGRAM, **base))}
    task = TokenRecallTask(vocab_size=SPEC_V, prompt_len=SPEC_P, response_len=SPEC_R)
    rng = np.random.default_rng(0)

    def round_once(name, prompts, lengths):
        eng = engines[name]
        for i in range(SPEC_LANES):
            eng.submit(prompts[i], int(lengths[i]), tag=i)
        torch.cuda.synchronize()
        macro0 = eng.macro_steps
        cuda_paged_attention.launches = 0
        t0 = time.perf_counter()
        done = eng.run_until(SPEC_LANES, max_macro_steps=4 * SPEC_R)
        while eng._inflight:  # the plain engine's last read
            done.extend(eng.step())
        torch.cuda.synchronize()
        return (time.perf_counter() - t0, {c.tag: c for c in done},
                cuda_paged_attention.launches, eng.macro_steps - macro0)

    round_once("off", *task.sample_prompts(SPEC_LANES, rng))  # warm-up pair
    round_once("on", *task.sample_prompts(SPEC_LANES, rng))
    st0 = engines["on"].stats()
    secs, toks, launches, macros = {"off": 0.0, "on": 0.0}, {"off": 0, "on": 0}, {}, {}
    mismatched, logp_err = 0, 0.0
    for _ in range(SPEC_ROUNDS):
        prompts, lengths = task.sample_prompts(SPEC_LANES, rng)
        out = {}
        for name in ("off", "on"):
            s, out[name], n_launch, n_macro = round_once(name, prompts, lengths)
            secs[name] += s
            toks[name] += sum(len(c.response_tokens) for c in out[name].values())
            launches.setdefault(name, []).append(n_launch)
            macros.setdefault(name, []).append(n_macro)
        for tag, a in out["off"].items():
            b = out["on"][tag]
            if not np.array_equal(a.response_tokens, b.response_tokens):
                mismatched += 1
            else:
                logp_err = max(logp_err, float(np.abs(a.behavior_logp - b.behavior_logp).max()))
    st = engines["on"].stats()
    proposed = st["spec_proposed"] - st0["spec_proposed"]
    accepted = st["spec_accepted"] - st0["spec_accepted"]
    want_off = [SPEC_MACRO * SPEC_LAYERS * m for m in macros["off"]]
    emit("genrl_spec", vocab=SPEC_V, d_model=SPEC_D, layers=SPEC_LAYERS, heads=SPEC_HEADS,
         prompt_len=SPEC_P, response_len=SPEC_R, lanes=SPEC_LANES, page_size=SPEC_PAGE,
         spec_k=SPEC_K, spec_ngram=SPEC_NGRAM, rounds=SPEC_ROUNDS,
         accepted_tokens_per_s_on=toks["on"] / secs["on"],
         accepted_tokens_per_s_off=toks["off"] / secs["off"],
         speedup=(toks["on"] / secs["on"]) / (toks["off"] / secs["off"]),
         seconds_on=secs["on"], seconds_off=secs["off"], tokens_on=toks["on"],
         tokens_off=toks["off"], acceptance_rate=accepted / max(proposed, 1),
         proposed=proposed, accepted=accepted, verify_passes=macros["on"],
         plain_macro_steps=macros["off"],
         rollback_pages=st["spec_rollback_pages"] - st0["spec_rollback_pages"],
         draft_s=st["spec_draft_s"] - st0["spec_draft_s"],
         verify_s=st["spec_verify_s"] - st0["spec_verify_s"],
         paged_launches_on=launches["on"], paged_launches_off=launches["off"],
         paged_launches_off_want=want_off, mismatched_sequences=mismatched,
         logp_max_abs_err=logp_err, tol=GEN_IDENTITY_LOGP_TOL, card=report["card"])
    if mismatched or not logp_err <= GEN_IDENTITY_LOGP_TOL:
        raise AssertionError(f"genrl_spec: {mismatched} sequences differ, logp {logp_err}")
    if any(launches["on"]) or launches["off"] != want_off or not all(want_off):
        raise AssertionError(f"genrl_spec: paged launches on {launches['on']}, off "
                             f"{launches['off']} (want {want_off})")
    if accepted <= 0:
        raise AssertionError(f"genrl_spec: no draft accepted ({proposed} proposed)")


def phase_quantize_push(report: dict) -> None:
    """Quantized snapshots on the card against the host, at the sequence-RL
    learner's width."""
    import torch

    from scalerl_torch.runtime.param_server import ParamSnapshotPlane
    from scalerl_torch.runtime.quantize import (
        QuantizedLeaf,
        dequantize_tree,
        quantize_tree,
        tree_wire_bytes,
    )
    from scalerl_torch.trainer.sequence_rl import build_genrl_model

    params = {k: v.detach() for k, v in build_genrl_model(_train_args(), "cuda").state_dict().items()}
    host = {k: v.cpu() for k, v in params.items()}
    out = {"f32_bytes": tree_wire_bytes(params)}
    bad = []
    worst_int8 = 0.0
    for mode in ("int8", "bf16"):
        dev = quantize_tree(params, mode)
        ref = quantize_tree(host, mode)
        for k, leaf in ref.items():
            got = dev[k]
            if not isinstance(leaf, QuantizedLeaf):
                continue
            if not torch.equal(got.q.cpu(), leaf.q):
                bad.append((mode, k, "payload"))
            if mode == "int8":
                if got.scale.cpu().view(torch.int32).item() != leaf.scale.view(torch.int32).item():
                    bad.append((mode, k, "scale"))
                deq = dequantize_tree({k: got})[k]
                err = float((deq.double() - params[k].double()).abs().max())
                worst_int8 = max(worst_int8, err / float(got.scale.double()))
        out[f"{mode}_bytes"] = tree_wire_bytes(dev)
        out[f"{mode}_ms"] = eager_time_ms(lambda: quantize_tree(params, mode), launches=1)
    plane = type("Plane", (ParamSnapshotPlane,), {})()
    plane._init_param_plane(params, torch.device("cuda"))
    plane.push_params(params, learner_step=1, quantize="int8")
    read, gen = plane._snapshot_params()
    want = dequantize_tree(quantize_tree(params, "int8"))
    plane_equal = gen == 1 and all(torch.equal(read[k], want[k]) for k in want)
    emit("quantize_push", leaves=len(params),
         quantized_leaves=sum(v.ndim >= 2 for v in params.values()),
         snapshot_mb={k[:-6]: v / 2**20 for k, v in out.items() if k.endswith("_bytes")},
         quantize_ms={k[:-3]: v for k, v in out.items() if k.endswith("_ms")},
         mismatches=bad[:8], int8_err_over_scale_max=worst_int8,
         int8_err_bound_over_scale=0.5 + INT8_DEQ_SLACK,
         plane_read_equals_dequantized=plane_equal, card=report["card"])
    if bad or worst_int8 > 0.5 + INT8_DEQ_SLACK or not plane_equal:
        raise AssertionError(f"quantize_push: mismatches {bad[:8]}, int8 error "
                             f"{worst_int8} scales, plane read equal {plane_equal}")


def _disagg_task():
    from scalerl_torch.genrl.task import TokenRecallTask

    return TokenRecallTask(vocab_size=TRAIN_V, prompt_len=(2, TRAIN_P), response_len=TRAIN_R)


def _join_hosts(trainer, name: str) -> None:
    """After the trainer's ``close()``: give its hosts ``THREAD_JOIN_S``
    more to end, then fail the phase on any that did not."""
    trainer.fleet.join(timeout=THREAD_JOIN_S)
    alive = [p for p in trainer.fleet.procs if p.is_alive()]
    if alive:
        raise AssertionError(f"{name}: {len(alive)} generation hosts alive past their "
                             f"{THREAD_JOIN_S:.0f} s join deadline")


def phase_disagg_train(report: dict) -> None:
    """The slice's main path: the disaggregated trainer on the card, its
    learner through the segment and PER kernels, its hosts running the
    cohort engine (then the continuous one) on the card in threads."""
    import torch

    from scalerl_torch.agents.token_ppo import TokenPPOAgent
    from scalerl_torch.trainer.sequence_rl import DisaggSequenceRLTrainer, build_genrl_model

    set_tf32(False)
    trainer = DisaggSequenceRLTrainer(_train_args(disagg_hosts=2), task=_disagg_task())
    try:
        t0 = time.perf_counter()
        for _ in range(2):
            trainer.train_round()
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        seqs0, dup0 = trainer.learner.total_sequences, trainer.learner.duplicate_sequences
        stats = _train_window(trainer, DISAGG_TRAIN_S, 3)
        wire = trainer.learner.total_sequences - seqs0
        dups = trainer.learner.duplicate_sequences - dup0
        snapshot_mb = trainer.learner.snapshot_wire_bytes / 2**20
        epoch, gen = trainer.learner.learner_epoch, trainer.learner.generation
    finally:
        trainer.close()
    _join_hosts(trainer, "disagg_train")
    ref = report.get("genrl_train_cohort", {})
    emit("disagg_train", hosts=2, lanes_per_host=trainer.config.lanes_per_host,
         snapshot_quantize=trainer.config.snapshot_quantize, engine="cohort",
         warmup_s=warmup_s, **stats, wire_sequences=wire, wire_sequences_per_s=wire / stats["seconds"],
         duplicate_sequences=dups, snapshot_mb=snapshot_mb, learner_epoch=epoch, generation=gen,
         genrl_train_cohort_rounds_per_s=ref.get("rounds_per_s"),
         genrl_train_cohort_learn_tokens_per_s=ref.get("learn_tokens_per_s"),
         card=report["card"])
    _check_train_window("disagg_train", stats, continuous=False)
    if dups != 0 or wire < stats["rounds"] * TRAIN_B:
        raise AssertionError(f"disagg_train: {dups} duplicate sequences, {wire} wire sequences "
                             f"for {stats['rounds']} rounds of {TRAIN_B}")
    torch.cuda.empty_cache()

    trainer = DisaggSequenceRLTrainer(_train_args(disagg_hosts=2, genrl_engine="continuous",
                                                  genrl_page_size=GEN_PAGE,
                                                  genrl_macro_steps=GEN_MACRO),
                                      task=_disagg_task())
    try:
        trainer.train_round()
        cont = _train_window(trainer, 0.0, DISAGG_CONT_ROUNDS)
    finally:
        trainer.close()
    _join_hosts(trainer, "disagg_train continuous")
    emit("disagg_train", hosts=2, engine="continuous", page_size=GEN_PAGE,
         steps_per_macro=GEN_MACRO, **cont, card=report["card"])
    _check_train_window("disagg_train continuous", cont, continuous=True)
    report["disagg_train_continuous"] = cont  # beside disagg_on_shards' rates
    torch.cuda.empty_cache()

    # bf16_params: one learn step, segment kernels against the dense mask
    batch = {k: torch.tensor(v).cuda() for k, v in _learn_step_fields(np.random.default_rng(5)).items()}
    losses, dtypes, moments = {}, {}, set()
    for attn in ("pallas", "xla"):
        args = _train_args(bf16_params=True, learner_packed_attn=attn)
        agent = TokenPPOAgent(args, build_genrl_model(args))
        _zero_launch_counts()
        m = agent.learn(batch)
        launches = _launch_counts()
        losses[attn] = (m["total_loss"], m["skipped_steps"], launches["segment_attention_fwd"])
        dtypes[attn] = {str(v.dtype) for v in agent.state.params.values()}
        moments |= {str(v.dtype) for mom in ("mu", "nu") for v in agent.state.opt_state[mom].values()}
        del agent
    rel = abs(losses["pallas"][0] - losses["xla"][0]) / max(abs(losses["xla"][0]), 1e-12)
    emit("disagg_bf16_learn", loss_kernel=losses["pallas"][0], loss_plain=losses["xla"][0],
         loss_rel=rel, tol=DISAGG_BF16_LOSS_REL, seg_fwd_launches=losses["pallas"][2],
         param_dtypes=sorted(dtypes["pallas"]), moment_dtypes=sorted(moments),
         card=report["card"])
    if (rel > DISAGG_BF16_LOSS_REL or losses["pallas"][2] != TRAIN_LAYERS
            or losses["xla"][2] != 0 or moments != {"torch.float32"}
            or "torch.bfloat16" not in dtypes["pallas"]
            or losses["pallas"][1] != 0.0 or losses["xla"][1] != 0.0):
        raise AssertionError(f"disagg_bf16_learn: losses {losses}, rel {rel}, moments {moments}")


class _Budgeted:
    """Mixin: the trainer's lease cursor stops at ``budget`` leases, so the
    soaks can account for every lease issued."""

    budget = 0

    def _next_lease(self):
        with self._lease_lock:
            if self._lease_seq >= self.budget:
                return None
        return super()._next_lease()


def _recording(learner, seen: list) -> None:
    """Record every sequence the trainer takes from ``learner``."""
    get = learner.get_sequence

    def get_sequence(timeout=None):
        s = get(timeout=timeout)
        if s is not None:
            seen.append({k: s[k] for k in ("lease_id", "seed", "generation", "prompt",
                                           "response_tokens", "behavior_logp", "values")})
        return s

    learner.get_sequence = get_sequence


def _soak_accounting(seen: list, budget: int) -> dict:
    from scalerl_torch.genrl.disagg import scripted_sequence_payload

    ids = [s["lease_id"] for s in seen]
    mismatches = 0
    for s in seen:
        want = scripted_sequence_payload(s["seed"], SOAK_RESPONSE, SOAK_VOCAB, s["generation"])
        if not all(np.array_equal(s[k], want[k]) for k in ("prompt", "response_tokens",
                                                           "behavior_logp", "values")):
            mismatches += 1
    return dict(expected=budget, received=len(seen), unique=len(set(ids)),
                lost=budget - len(set(ids)), duplicates=len(ids) - len(set(ids)),
                payload_mismatches=mismatches)


def phase_disagg_soak(report: dict) -> None:
    """The disagg soak's wave with the learner's plane on the card: spawned
    scripted hosts, a seeded mass_kill after the first accepted sequence,
    the floor rule's backfill."""
    from scalerl_torch.genrl.disagg import (
        GenerationTierExecutor,
        ScriptedEngineFactory,
        disagg_signal_source,
    )
    from scalerl_torch.runtime import chaos, telemetry
    from scalerl_torch.runtime.autoscaler import Autoscaler, AutoscalerConfig
    from scalerl_torch.trainer.sequence_rl import DisaggSequenceRLTrainer

    class Trainer(_Budgeted, DisaggSequenceRLTrainer):
        budget = SOAK_ROUNDS * TRAIN_B

    plan = "1234:mass_kill=1.0@1,kills=0"
    recorder = telemetry.get_recorder()
    seq0 = recorder.total_recorded
    factory = ScriptedEngineFactory(lanes=SOAK_LANES, response_len=SOAK_RESPONSE,
                                    tokens_per_step=1, step_sleep_s=0.02, vocab=SOAK_VOCAB)
    seen: list = []
    scaler = trainer = None
    killed: list = []
    try:
        trainer = Trainer(_train_args(disagg_hosts=SOAK_HOSTS, disagg_lanes_per_host=SOAK_LANES,
                                      disagg_upload_batch=1, disagg_round_timeout_s=120.0),
                          engine_factory=factory, use_threads=False)
        _recording(trainer.learner, seen)
        scaler = Autoscaler(
            AutoscalerConfig(min_workers=SOAK_HOSTS, max_workers=2 * SOAK_HOSTS, interval_s=0.25,
                             cooldown_s=1.0, up_hysteresis=1, down_hysteresis=2,
                             low_occupancy=-1.0),
            executor=GenerationTierExecutor(trainer.learner, trainer.fleet),
            signal_source=disagg_signal_source(trainer.learner)).start()
        # the wave lands once the first sequence was accepted and every host
        # has joined and holds leases: a host killed while booting has
        # nothing in flight to requeue.  The plan is installed only now, so
        # the fleet started no chaos supervisor of its own
        learner = trainer.learner

        def every_host_decoding():
            with learner._roster_lock, learner._lease_lock:
                conns = list(learner.host_links)
                return len(conns) >= SOAK_HOSTS and all(learner._conn_leases.get(c)
                                                         for c in conns)

        t_start = time.monotonic()
        deadline = t_start + 120.0
        while ((learner.total_sequences < 1 or not every_host_decoding())
               and time.monotonic() < deadline):
            time.sleep(0.01)
        chaos.install(chaos.FaultInjector(chaos.ChaosPlan.parse(plan)))
        seqs_before_wave = learner.total_sequences
        requeued0 = trainer.learner.requeued_leases
        t_wave = time.monotonic()
        killed = trainer.fleet.chaos_poll()
        _zero_launch_counts()
        rounds = [trainer.train_round() for _ in range(SOAK_ROUNDS)]
        launches = _launch_counts()
        requeued = trainer.learner.requeued_leases - requeued0
    finally:
        if scaler is not None:
            scaler.stop()
        chaos.clear()
        if trainer is not None:
            trainer.close()
    _join_hosts(trainer, "disagg_soak")
    waves = [e for e in recorder.events() if e["seq"] >= seq0 and e["kind"] == "mass_kill"]
    acct = _soak_accounting(seen, Trainer.budget)
    acct["lost"] += trainer.learner.dropped_sequences  # evicted from a full queue
    emit("disagg_soak", chaos=plan, hosts=SOAK_HOSTS, lanes=SOAK_LANES, hosts_killed=len(killed),
         waves=len(waves), wave_s_after_start=round(t_wave - t_start, 2),
         sequences_before_wave=seqs_before_wave,
         requeued_leases=requeued, scale_ups=scaler.scale_ups, **acct,
         absorbed_duplicates=trainer.learner.duplicate_sequences + trainer.learner.duplicate_leases,
         learn_steps=len(rounds), launches={k: launches[k] for k in (
             "per_sample", "segment_attention_fwd", "segment_attention_bwd_dq",
             "segment_attention_bwd_dkv")},
         losses_finite=all(math.isfinite(m["total_loss"]) for m in rounds), card=report["card"])
    if (acct["lost"] or acct["duplicates"] or acct["payload_mismatches"] or not killed
            or requeued < 1 or scaler.scale_ups < 1 or launches["per_sample"] != SOAK_ROUNDS
            or launches["segment_attention_fwd"] != TRAIN_LAYERS * SOAK_ROUNDS
            or not all(math.isfinite(m["total_loss"]) for m in rounds)):
        raise AssertionError(f"disagg_soak: {acct}, killed {killed}, requeued {requeued}, "
                             f"scale-ups {scaler.scale_ups}, launches {launches}")


def phase_disagg_preempt(report: dict) -> None:
    """The preempt soak through the trainer: the guard trips on a seeded
    draw, the ledger saves, and a new trainer resumes it."""
    import shutil
    import tempfile

    from scalerl_torch.data.sequence_replay import seq_export
    from scalerl_torch.genrl.disagg import ScriptedEngineFactory
    from scalerl_torch.runtime import chaos, telemetry
    from scalerl_torch.runtime.supervisor import PreemptionGuard
    from scalerl_torch.trainer.sequence_rl import DisaggSequenceRLTrainer, host_weights

    class Trainer(_Budgeted, DisaggSequenceRLTrainer):
        budget = (PREEMPT_WARM_ROUNDS + PREEMPT_ROUNDS) * TRAIN_B

    ledger_dir = tempfile.mkdtemp(prefix="disagg_ledger_")
    args = _train_args(disagg_hosts=2, disagg_lanes_per_host=4, disagg_ledger_dir=ledger_dir,
                       disagg_upload_batch=2)
    # slow hosts (4 lanes, 20 ms a token): the guard trips while leases are
    # in flight and the budget is not yet issued, so the resume reissues
    # open leases and its cursor issues new ones
    factory = ScriptedEngineFactory(lanes=4, response_len=SOAK_RESPONSE, tokens_per_step=1,
                                    step_sleep_s=0.02, vocab=SOAK_VOCAB)
    seen: list = []
    plan = "5:preempt=1.0@1"
    guard = PreemptionGuard()  # not installed: the draw trips it as a signal would
    try:
        t1 = Trainer(args, engine_factory=factory)
        _recording(t1.learner, seen)
        for _ in range(PREEMPT_WARM_ROUNDS):
            t1.train_round()
        # the seeded draw fires at the next safe point: the round boundary
        chaos.install(chaos.FaultInjector(chaos.ChaosPlan.parse(plan)))
        t1.guard = guard
        try:
            summary1 = t1.train(PREEMPT_ROUNDS)  # saves the ledger and closes
        finally:
            chaos.clear()
        _join_hosts(t1, "disagg_preempt (preempted)")
        saved = dict(step=t1.learn_steps, epoch=t1.learner.learner_epoch,
                     lease_seq=t1._lease_seq, rng=json.dumps(t1._lease_rng.bit_generator.state),
                     weights=host_weights(t1.agent.get_weights()), replay=seq_export(t1.replay))
        t2 = Trainer(args, engine_factory=factory)
        _recording(t2.learner, seen)
        resumed = dict(step=t2.learn_steps, epoch=t2.learner.learner_epoch,
                       lease_seq=t2._lease_seq, rng=json.dumps(t2._lease_rng.bit_generator.state),
                       reissued=t2.learner.resumed_sequences_reissued)
        w2, r2 = host_weights(t2.agent.get_weights()), seq_export(t2.replay)
        weights_equal = all(np.array_equal(w2[k], v) for k, v in saved["weights"].items())
        replay_equal = (all(np.array_equal(r2["storage"][k], v)
                            for k, v in saved["replay"]["storage"].items())
                        and np.array_equal(r2["priorities"], saved["replay"]["priorities"])
                        and (r2["pos"], r2["size"]) == (saved["replay"]["pos"],
                                                        saved["replay"]["size"]))
        try:
            summary2 = t2.train(PREEMPT_ROUNDS)
        finally:
            t2.close()
        _join_hosts(t2, "disagg_preempt (resumed)")
    finally:
        shutil.rmtree(ledger_dir, ignore_errors=True)
    acct = _soak_accounting(seen, Trainer.budget)
    new_seeds = sorted(s["seed"] for s in seen if s["seed"] > saved["lease_seq"])
    exits = telemetry.get_recorder().events("preemption_exit")
    dump = guard.flight_dump_path
    emit("disagg_preempt", chaos=plan, saved_step=saved["step"], resumed_step=resumed["step"],
         saved_epoch=saved["epoch"], resumed_epoch=resumed["epoch"],
         lease_cursor_saved=saved["lease_seq"], lease_cursor_resumed=resumed["lease_seq"],
         first_new_lease_seed=new_seeds[0] if new_seeds else None,
         lease_rng_equal=saved["rng"] == resumed["rng"], reissued=resumed["reissued"],
         weights_bit_equal=weights_equal, replay_bit_equal=replay_equal,
         learn_steps_before=summary1["learn_steps"], learn_steps_after=summary2["learn_steps"],
         flight_dump=dump, flight_dump_written=bool(dump) and os.path.exists(dump),
         preemption_exits=len(exits), **acct, card=report["card"])
    if (not guard.triggered or saved["step"] != PREEMPT_WARM_ROUNDS
            or resumed["step"] != saved["step"] or resumed["epoch"] != saved["epoch"] + 1
            or resumed["lease_seq"] != saved["lease_seq"] or saved["rng"] != resumed["rng"]
            or not new_seeds or new_seeds[0] != saved["lease_seq"] + 1 or resumed["reissued"] < 1
            or not weights_equal or not replay_equal
            or summary2["learn_steps"] != saved["step"] + PREEMPT_ROUNDS
            or acct["lost"] or acct["duplicates"] or acct["payload_mismatches"]
            or not (dump and os.path.exists(dump)) or not exits):
        raise AssertionError(f"disagg_preempt: saved {dict(saved, weights=None, replay=None)}, "
                             f"resumed {resumed}, weights {weights_equal}, replay "
                             f"{replay_equal}, {acct}, dump {dump}")


# Anakin (phase impala_anakin): N chunks as one CUDA-graph replay, at the fused
# phase's width and at ImpalaArguments' defaults
ANAKIN_FF_CHUNKS = 2  # MAIN_CHUNKS (4) before the whole script neared its time limit
ANAKIN_LSTM_CHUNKS = 2  # 4 before shard_compute joined the script


def _clone_tree(tree):
    import torch

    from scalerl_torch.utils.tree import tree_map

    return tree_map(torch.clone, tree)


def _tree_diff(a, b) -> tuple:
    """(leaves that differ, their largest abs difference) of two trees."""
    from scalerl_torch.utils.tree import tree_leaves

    bad, worst = 0, 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if not (x.shape == y.shape and bool((x == y).all())):
            bad += 1
            worst = max(worst, float((x.double() - y.double()).abs().max()))
    return bad, worst


def _anakin_case(report: dict, name: str, args, chunks: int) -> dict:
    """One loop's Anakin checks: eager ``run()`` and one captured superchunk
    from the same state, carry and generator state under deterministic
    algorithms (bit-equal params, carry and metric stream; an op without a
    deterministic version is named and its leaves held at ``LEARN_TOL``),
    distinct draws across two replays, V-trace launches captured into the
    graph (the wrapper's count over the capture: a replay launches what was
    captured) and seen by the profiler in a replay (at least one, and no
    more than were captured: CUPTI can lose a record among the replay's
    ~10^5 kernels on a loaded host, and once saw 19 of 20), and the warm
    replay's rate beside ``run()``'s (both with the deterministic
    algorithms).  The timed warm replay is the second draw:
    it starts from the first replay's generator state, which must have
    moved on.  The device busy share is the profiled replay's kernel time
    over the span from its first kernel's start to its last kernel's end."""
    import warnings

    import torch

    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.envs.tensor_envs import SyntheticPixelEnv
    from scalerl_torch.ops import cuda_vtrace
    from scalerl_torch.runtime.device_loop import DeviceActorLearnerLoop

    T, B, iters = args.rollout_length, args.batch_size, MAIN_ITERS
    env = SyntheticPixelEnv(num_envs=B)
    agent = ImpalaAgent(args, obs_shape=env.observation_shape, num_actions=env.num_actions)
    loop = DeviceActorLearnerLoop(agent.model, env, agent.make_learn_fn(), unroll_length=T,
                                  iters_per_call=iters)
    t0 = time.perf_counter()
    state, carry, _ = loop.run(agent.state, loop.init_carry(), num_calls=1)  # warm-up chunk
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    state0, carry0, gen0 = _clone_tree(state), _clone_tree(carry), loop.generator.get_state()
    frames = chunks * iters * T * B
    prev_cfg = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eager_stream = []
            t0 = time.perf_counter()
            s_run, c_run, _ = loop.run(_clone_tree(state0), _clone_tree(carry0), num_calls=chunks,
                                       on_metrics=lambda i, m: eager_stream.append(m))
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            gen_after_run = loop.generator.get_state()
            loop.generator.set_state(gen0)
            ana_stream = []
            cuda_vtrace.launches = 0
            t0 = time.perf_counter()
            s_ana, c_ana, _ = loop.run_anakin(_clone_tree(state0), _clone_tree(carry0), chunks,
                                              on_metrics=lambda i, m: ana_stream.append(m))
            capture_s = time.perf_counter() - t0
            # the capture follows one warm eager chunk of ``iters`` launches
            captured_vtrace = cuda_vtrace.launches - iters
            s_ana, c_ana = _clone_tree(s_ana), _clone_tree(c_ana)
        nondeterministic = sorted({str(w.message).split(" does not have")[0][:120]
                                   for w in caught if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(False)
        if prev_cfg is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev_cfg
    bad_leaves, worst = _tree_diff((s_run, c_run), (s_ana, c_ana))
    stream_equal = eager_stream == ana_stream
    generator_equal = bool(torch.equal(gen_after_run, loop.generator.get_state()))
    # warm replays: run_anakin's guarded path, timed, which is also the
    # second draw (the generator has moved on, so the actions differ), then
    # one under the profiler
    gen1 = loop.generator.get_state()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s, c, last = loop.run_anakin(s_ana, c_ana, chunks)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    draws_differ = (not torch.equal(c_ana.last_action, c.last_action)
                    and not torch.equal(gen1, loop.generator.get_state()))
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loop.train_superchunk(s, c, chunks)
        torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    kernels = _kernel_table(prof)
    span_s = _kernel_span_s(prof)
    profile_s = time.perf_counter() - t0
    vtrace_calls = sum(n for k, _, n in kernels if "vtrace_kernel" in k)
    busy_s = sum(us for _, us, _ in kernels) / 1e6
    out = dict(B=B, T=T, iters_per_call=iters, chunks=chunks, frames=frames,
               run_env_frames_per_s=frames / run_s, anakin_env_frames_per_s=frames / replay_s,
               warmup_chunk_s=warmup_s, run_s=run_s, replay_s=replay_s,
               first_call_with_capture_s=capture_s, profile_s=profile_s,
               profile_traced_s=traced_s,
               replay_device_busy_s=busy_s, replay_kernel_span_s=span_s,
               replay_device_busy_share=busy_s / span_s,
               replay_kernel_launches=sum(n for _, _, n in kernels),
               captured_vtrace_launches=captured_vtrace,
               replay_vtrace_launches=vtrace_calls, peak_mem_gib=peak_gib,
               bit_equal=bad_leaves == 0 and stream_equal, differing_leaves=bad_leaves,
               max_abs_diff=worst, metric_stream_equal=stream_equal,
               generator_equal=generator_equal, replays_draw_differently=draws_differ,
               nondeterministic_ops=nondeterministic, warm_sync_debug_mode="error",
               last_chunk=last, card=report["card"])
    emit(f"impala_anakin_{name}", **out)
    if captured_vtrace != chunks * iters or not 1 <= vtrace_calls <= captured_vtrace:
        raise AssertionError(f"{name}: vtrace launches captured {captured_vtrace} != "
                             f"{chunks * iters}, or seen in a replay {vtrace_calls} outside "
                             f"[1, {captured_vtrace}]")
    if not (draws_differ and generator_equal):
        raise AssertionError(f"{name}: replays draw the same actions or the generator moved "
                             "otherwise than eager")
    if not out["bit_equal"]:
        if not nondeterministic:
            raise AssertionError(f"{name}: replay not bit-equal to eager ({bad_leaves} leaves, "
                                 f"{worst}; streams equal {stream_equal}) with every op "
                                 "deterministic")
        if not worst <= LEARN_TOL["kernel_vs_plain_update_abs"]:
            raise AssertionError(f"{name}: replay off eager by {worst} beside "
                                 f"{nondeterministic}")
    return out


def phase_impala_anakin(report: dict) -> None:
    """Anakin on the card: ``run_anakin`` replays one CUDA graph of N chunks
    (``runtime/device_loop.py``), at ``phase_impala_fused``'s width and at
    ImpalaArguments' defaults (the LSTM chunk)."""
    import torch

    from scalerl_torch.config import ImpalaArguments

    set_tf32(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    ff = ImpalaArguments(use_lstm=False, hidden_size=512, rollout_length=MAIN_T,
                         batch_size=MAIN_B, max_timesteps=0, compute_dtype="bfloat16",
                         use_pallas=True)
    report["anakin"] = {"ff": _anakin_case(report, "ff", ff, ANAKIN_FF_CHUNKS),
                        "lstm": _anakin_case(report, "lstm", _default_args(),
                                             ANAKIN_LSTM_CHUNKS)}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _flat_params(state) -> "object":
    import torch

    from scalerl_torch.parallel.sharding import gather_tree

    return torch.cat([v.float().reshape(-1) for v in gather_tree(state.params).values()]).cpu()


def _dqn_per_step(agent, sampler, args) -> dict:
    """One DQN learn step on a PER batch sampled by the kernels from a full
    ring of fixed contents, and the priority write-back; the PER launches
    counted."""
    import dataclasses

    import torch

    from scalerl_torch.data.prioritized import per_sample_from_uniforms
    from scalerl_torch.ops import cuda_per

    g = torch.Generator(device="cuda").manual_seed(7)
    shape = (PER_CAPACITY, PER_NUM_ENVS)
    state = sampler.buffer.state
    done = torch.rand(shape, generator=g, device="cuda") < 0.05
    for k, v in dict(obs=torch.randn(shape + (4,), generator=g, device="cuda"),
                     next_obs=torch.randn(shape + (4,), generator=g, device="cuda"),
                     action=torch.randint(0, 2, shape, generator=g, device="cuda"),
                     reward=torch.rand(shape, generator=g, device="cuda"), done=done,
                     boundary=done).items():
        state.replay.storage[k].copy_(v)
    state.priorities.copy_(torch.rand(shape, generator=g, device="cuda") * 2 + 0.05)
    sampler.buffer.state = dataclasses.replace(
        state, replay=dataclasses.replace(state.replay, pos=0, size=PER_CAPACITY))
    u = torch.rand(PER_BATCH, generator=g, device="cuda")
    cuda_per.sample_launches = cuda_per.update_launches = 0
    batch = per_sample_from_uniforms(sampler.buffer.state, u, args.per_alpha, args.per_beta,
                                     PER_N_STEP, args.gamma, sampler.buffer.sample_method)
    metrics, td_abs = agent.learn_device(batch)
    sampler.update_priorities(batch["indices"], td_abs + 1e-6)
    torch.cuda.synchronize()
    return dict(params=_flat_params(agent.state), loss=float(metrics["loss"]),
                sample=cuda_per.sample_launches, update=cuda_per.update_launches)


def phase_mesh_learn(report: dict) -> None:
    """The sharded learn step on one card: a one-rank nccl process group,
    ``enable_mesh`` at dp = mp = 1 (state leaves DTensors on a seven-dim
    ``DeviceMesh``), each step held against the same agent unmeshed: the
    transformer learner at the sharded width (``SHARD_LEARN_TOL``, flash
    launches equal), the IMPALA step (V-trace launches equal) and the DQN
    step on a PER batch (``LEARN_TOL``, PER launches counted).  The group is
    destroyed at the end."""
    import torch
    import torch.distributed as dist

    from scalerl_torch.agents.dqn import DQNAgent
    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.config import ImpalaArguments
    from scalerl_torch.data.sampler import Sampler
    from scalerl_torch.ops import cuda_per, cuda_vtrace
    from scalerl_torch.ops import cuda_flash_attention as cfa

    set_tf32(False)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        def rel(a: float, b: float) -> float:
            return abs(a - b) / max(abs(b), 1.0)

        # the transformer learner, bench.py --mode sharded's width
        traj = _shard_traj("cuda")
        tr = {}
        for name in ("plain", "mesh"):
            agent = ImpalaAgent(_shard_args(), (SHARD_OBS,), SHARD_A)
            if name == "mesh":
                agent.enable_mesh("dp=1,mp=1")
                if agent.mesh.device_mesh is None:
                    raise AssertionError("the meshed agent has no DeviceMesh")
            before = _flat_params(agent.state)
            cfa.fwd_launches = cfa.dq_launches = cfa.dkv_launches = 0
            metrics = [agent.learn(traj) for _ in range(SHARD_LEARN_STEPS)]
            torch.cuda.synchronize()
            tr[name] = dict(metrics=metrics, update=_flat_params(agent.state) - before,
                            launches=_flash_counts())
            del agent
        p, m = tr["plain"], tr["mesh"]
        shard_errs = {
            "loss_rel": max(rel(a["total_loss"], b["total_loss"])
                            for a, b in zip(m["metrics"], p["metrics"])),
            "grad_norm_rel": max(rel(a["grad_norm"], b["grad_norm"])
                                 for a, b in zip(m["metrics"], p["metrics"])),
            "update_rel_l2": float((m["update"] - p["update"]).norm() / p["update"].norm()),
        }
        # the IMPALA step at phase_impala_learn's configuration
        T, B, A = 6, 4, 6
        g = torch.Generator().manual_seed(3)
        from scalerl_torch.data.trajectory import Trajectory

        itraj = Trajectory(
            obs=torch.randint(0, 256, (T + 1, B, 84, 84, 4), generator=g,
                              dtype=torch.uint8).cuda(),
            action=torch.randint(0, A, (T + 1, B), generator=g).cuda(),
            reward=torch.randn(T + 1, B, generator=g).cuda(),
            done=(torch.rand(T + 1, B, generator=g) < 0.2).cuda(),
            logits=torch.randn(T + 1, B, A, generator=g).cuda())
        im = {}
        for name in ("plain", "mesh"):
            args = ImpalaArguments(use_lstm=False, hidden_size=512, rollout_length=T,
                                   batch_size=B, max_timesteps=0, use_pallas=True)
            agent = ImpalaAgent(args, (84, 84, 4), A)
            if name == "mesh":
                agent.enable_mesh("dp=1")
            before = _flat_params(agent.state)
            cuda_vtrace.launches = 0
            metrics = agent.learn(itraj)
            im[name] = dict(metrics=metrics, update=_flat_params(agent.state) - before,
                            vtrace=cuda_vtrace.launches)
        impala_errs = {
            "kernel_vs_plain_update_abs": float((im["mesh"]["update"]
                                                 - im["plain"]["update"]).abs().max()),
            "loss_rel": rel(im["mesh"]["metrics"]["total_loss"],
                            im["plain"]["metrics"]["total_loss"]),
            "grad_norm_rel": rel(im["mesh"]["metrics"]["grad_norm"],
                                 im["plain"]["metrics"]["grad_norm"]),
        }
        # the DQN step on a PER batch: sample (kernels), learn, write back
        dq = {}
        for name in ("plain", "mesh"):
            args = _dqn_args(use_pallas=True)
            agent = DQNAgent(args, (4,), 2)
            if name == "mesh":
                agent.enable_mesh("dp=1")
            sampler = Sampler((4,), PER_CAPACITY, PER_NUM_ENVS, use_per=True,
                              per_alpha=args.per_alpha, n_step=PER_N_STEP, gamma=args.gamma,
                              use_pallas=True)
            dq[name] = _dqn_per_step(agent, sampler, args)
        dqn_errs = {"kernel_vs_plain_update_abs": float((dq["mesh"]["params"]
                                                         - dq["plain"]["params"]).abs().max()),
                    "loss_rel": rel(dq["mesh"]["loss"], dq["plain"]["loss"])}
    finally:
        dist.destroy_process_group()
    out = dict(mesh="dp=1,mp=1 (transformer), dp=1 (IMPALA, DQN)", backend="nccl",
               transformer=dict(**shard_errs, tol={k: SHARD_LEARN_TOL[k] for k in shard_errs},
                                flash_launches_mesh=m["launches"],
                                flash_launches_plain=p["launches"], steps=SHARD_LEARN_STEPS),
               impala=dict(**impala_errs, vtrace_launches_mesh=im["mesh"]["vtrace"],
                           vtrace_launches_plain=im["plain"]["vtrace"]),
               dqn=dict(**dqn_errs, per_sample_launches=dq["mesh"]["sample"],
                        per_update_launches=dq["mesh"]["update"]),
               tol=LEARN_TOL, card=report["card"])
    emit("mesh_learn", **out)
    report["mesh_learn"] = out
    bad = {k: v for k, v in shard_errs.items() if not v <= SHARD_LEARN_TOL[k]}
    bad.update({f"impala_{k}": v for k, v in impala_errs.items() if not v <= LEARN_TOL[k]})
    bad.update({f"dqn_{k}": v for k, v in dqn_errs.items() if not v <= LEARN_TOL[k]})
    if bad:
        raise AssertionError(f"meshed steps off their unmeshed steps: {bad}")
    if m["launches"] != p["launches"] or not all(m["launches"]):
        raise AssertionError(f"flash launches {m['launches']} meshed, {p['launches']} not")
    if im["mesh"]["vtrace"] != im["plain"]["vtrace"] or im["mesh"]["vtrace"] != 1:
        raise AssertionError(f"vtrace launches {im['mesh']['vtrace']} meshed, "
                             f"{im['plain']['vtrace']} not")
    if not (dq["mesh"]["sample"] == dq["plain"]["sample"] > 0
            and dq["mesh"]["update"] == dq["plain"]["update"] > 0):
        raise AssertionError(f"PER launches meshed {dq['mesh']}, not {dq['plain']}")


MESH_APEX_ROWS, MESH_APEX_LANES = 3640, 288  # apex_train's plane: 2^20 // 288 rows of 288
MESH_REPLAY_ADDS = 64  # global adds through both buffers' inserts after the bulk fill
MESH_SEQ_INSERTS = 4  # inserts of 16 sequences after the bulk fill
MESH_TIMED_REPS = 20
MESH_WEIGHT_TOL = 1e-6  # importance weights, sharded vs unsharded sample
MESH_R2D2_ITERS = 20  # DeviceR2D2Trainer iterations a twin (30 before serving_on_shards, 40 before genrl_on_shards)
MESH_APEX_S = 3.5  # 5 s before serving_on_shards


def _one_rank_group() -> None:
    """A one-rank nccl process group; the caller destroys it."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))


def _one_rank_mesh():
    from scalerl_torch.parallel.mesh import make_mesh

    mesh = make_mesh("dp=1")
    if mesh.device_mesh is None:
        raise AssertionError("the one-rank mesh has no DeviceMesh")
    return mesh


def _planes_equal(a: dict, b: dict) -> list:
    """The names of the planes that differ between two dicts of tensors."""
    return [k for k in a if not (a[k].shape == b[k].shape and bool((a[k] == b[k]).all()))]


def _mesh_replay_transitions(mesh, card: str) -> dict:
    """``ShardedPrioritizedReplay`` at dp = 1 on ``apex_train``'s plane
    against ``PrioritizedReplayBuffer`` fed the same: state, sample (the
    same uniforms) and write-back, launches counted, times beside."""
    import dataclasses

    import torch

    from scalerl_torch.data.prioritized import PrioritizedReplayBuffer, per_sample_from_uniforms
    from scalerl_torch.data.sharded_replay import ShardedPrioritizedReplay
    from scalerl_torch.ops import cuda_per
    from scalerl_torch.ops.per import update_priorities_blocks

    R, L = MESH_APEX_ROWS, MESH_APEX_LANES
    kw = dict(alpha=0.6, n_step=1, gamma=0.99, sample_method="pallas", update_method="pallas",
              extra_fields={"n_steps": ((), torch.int32)})
    sharded = ShardedPrioritizedReplay((4,), R, mesh, num_envs=L, **kw)
    plain = PrioritizedReplayBuffer((4,), R, num_envs=L, **kw)
    g = torch.Generator(device="cuda").manual_seed(11)
    done = torch.rand(R, L, generator=g, device="cuda") < 0.05
    bulk = dict(obs=torch.randn(R, L, 4, generator=g, device="cuda"),
                next_obs=torch.randn(R, L, 4, generator=g, device="cuda"),
                action=torch.randint(0, 2, (R, L), generator=g, device="cuda"),
                reward=torch.rand(R, L, generator=g, device="cuda"), done=done,
                n_steps=torch.randint(1, 4, (R, L), generator=g, device="cuda",
                                      dtype=torch.int32))
    prio = torch.rand(R, L, generator=g, device="cuda") * 2 + 0.05
    for buf in (sharded, plain):
        st = buf.state
        for k, v in bulk.items():
            st.replay.storage[k].copy_(v)
        st.priorities.copy_(prio)
        buf.state = dataclasses.replace(st, replay=dataclasses.replace(st.replay, pos=0, size=R))
    for _ in range(MESH_REPLAY_ADDS):  # the insert path, wrapping the full ring
        step = dict(obs=torch.randn(L, 4, generator=g, device="cuda"),
                    next_obs=torch.randn(L, 4, generator=g, device="cuda"),
                    action=torch.randint(0, 2, (L,), generator=g, device="cuda"),
                    reward=torch.rand(L, generator=g, device="cuda"),
                    done=torch.rand(L, generator=g, device="cuda") < 0.05,
                    n_steps=torch.randint(1, 4, (L,), generator=g, device="cuda",
                                          dtype=torch.int32))
        p = torch.rand(L, generator=g, device="cuda") * 4
        sharded.add_with_priorities(step, p)
        plain.add_with_priorities(step, p)
    full = sharded.full_state()
    state_diff = _planes_equal(full.replay.storage, plain.state.replay.storage)
    state_diff += _planes_equal({"priorities": full.priorities,
                                 "max_priority": full.max_priority},
                                {"priorities": plain.state.priorities,
                                 "max_priority": plain.state.max_priority})
    if (full.replay.pos, full.replay.size) != (plain.state.replay.pos, plain.state.replay.size):
        state_diff.append("cursors")

    u = torch.rand(PER_BATCH, generator=g, device="cuda")
    _zero_launch_counts()
    got = sharded.sample(PER_BATCH, beta=0.4, u=u)
    torch.cuda.synchronize()
    sample_calls = cuda_per.sample_launches
    want = per_sample_from_uniforms(plain.state, u, 0.6, 0.4, 1, 0.99, "pallas")
    sample_diff = _planes_equal({k: v for k, v in got.items() if k != "weights"},
                                {k: v for k, v in want.items() if k != "weights"})
    weight_err = float((got["weights"] - want["weights"]).abs().max())

    idx = got["indices"]
    td = torch.rand(PER_BATCH, generator=g, device="cuda") * 3
    before = sharded.state.priorities.clone()
    _zero_launch_counts()
    sharded.update_priorities(idx, td)
    torch.cuda.synchronize()
    update_launches = cuda_per.update_launches
    update_priorities_blocks(before.view(-1), idx, td.clamp_min(1e-6), method="xla")
    plain.update_priorities(idx, td)
    write_back_equal = (bool(torch.equal(sharded.state.priorities, before))
                        and bool(torch.equal(sharded.state.priorities, plain.state.priorities))
                        and bool(torch.equal(sharded.state.max_priority,
                                             plain.state.max_priority)))
    times = {
        "sharded_sample_us": 1e3 * eager_time_ms(
            lambda: sharded.sample(PER_BATCH, beta=0.4, u=u), MESH_TIMED_REPS),
        "plain_sample_us": 1e3 * eager_time_ms(
            lambda: per_sample_from_uniforms(plain.state, u, 0.6, 0.4, 1, 0.99, "pallas"),
            MESH_TIMED_REPS),
        "sharded_write_back_us": 1e3 * eager_time_ms(
            lambda: sharded.update_priorities(idx, td), MESH_TIMED_REPS),
        "plain_write_back_us": 1e3 * eager_time_ms(
            lambda: plain.update_priorities(idx, td), MESH_TIMED_REPS),
    }
    return dict(plane=[R, L], transitions=R * L, batch=PER_BATCH, adds=MESH_REPLAY_ADDS,
                state_mismatches=state_diff, sample_mismatches=sample_diff,
                weight_max_abs_err=weight_err, weight_tol=MESH_WEIGHT_TOL,
                sample_calls=sample_calls, sample_kernel_launches=2 * sample_calls,
                update_launches=update_launches, write_back_bit_equal=write_back_equal,
                **times, card=card)


def _mesh_replay_sequences(mesh, card: str) -> dict:
    """``ShardedSequenceReplay`` at dp = 1 on ``r2d2_device``'s geometry
    (2,048 sequences of 21 x 84x84x4 uint8) against the sequence ring fed
    the same: state, sample and keep-empty write-back, times beside."""
    import dataclasses

    import torch

    from scalerl_torch.data import sequence_replay as sr
    from scalerl_torch.data.sharded_replay import ShardedSequenceReplay
    from scalerl_torch.ops import cuda_per
    from scalerl_torch.trainer.r2d2 import sequence_fields

    slots, T1, B, core_dim = R2D2_SLOTS, 21, R2D2_BATCH, 256
    fields = sequence_fields((84, 84, 4), T1)
    sharded = ShardedSequenceReplay(fields, ((core_dim,),), slots, mesh, alpha=0.6, beta=0.4,
                                    sample_method="pallas")
    plain = sr.seq_init(fields, ((core_dim,),), slots, "cuda")
    g = torch.Generator(device="cuda").manual_seed(12)

    def sequences(n):
        return ({"obs": torch.randint(0, 256, (n, T1, 84, 84, 4), generator=g, device="cuda",
                                      dtype=torch.uint8),
                 "action": torch.randint(0, 6, (n, T1), generator=g, device="cuda",
                                         dtype=torch.int32),
                 "reward": torch.randn(n, T1, generator=g, device="cuda"),
                 "done": torch.rand(n, T1, generator=g, device="cuda") < 0.05},
                ((torch.randn(n, core_dim, generator=g, device="cuda"),
                  torch.randn(n, core_dim, generator=g, device="cuda")),),
                torch.rand(n, generator=g, device="cuda") * 2 + 0.05)

    bulk, core, prio = sequences(slots)
    for st in (sharded.state, plain):
        for k, v in bulk.items():
            st.storage[k].copy_(v)
        st.core[0][0].copy_(core[0][0])
        st.core[0][1].copy_(core[0][1])
        st.priorities.copy_(prio)
    del bulk, core
    sharded.state = dataclasses.replace(sharded.state, pos=0, size=slots)
    plain = dataclasses.replace(plain, pos=0, size=slots)
    for _ in range(MESH_SEQ_INSERTS):
        batch, core, prio = sequences(B)
        sharded.add(batch, core, prio)
        plain = sr.seq_add(plain, batch, core, prio)
    full = sharded.full_state()
    state_diff = _planes_equal(full.storage, plain.storage)
    state_diff += _planes_equal({"c": full.core[0][0], "h": full.core[0][1],
                                 "priorities": full.priorities},
                                {"c": plain.core[0][0], "h": plain.core[0][1],
                                 "priorities": plain.priorities})
    if (full.pos, full.size) != (plain.pos, plain.size):
        state_diff.append("cursors")
    del full

    u = torch.rand(B, generator=g, device="cuda")
    _zero_launch_counts()
    f, c, idx, w = sharded.sample(B, u=u)
    torch.cuda.synchronize()
    sample_calls = cuda_per.sample_launches
    wf, wc, widx, ww = sr.seq_sample(plain, None, B, alpha=0.6, beta=0.4, method="pallas", u=u)
    sample_diff = _planes_equal({**f, "c": c[0][0], "h": c[0][1], "idx": idx},
                                {**wf, "c": wc[0][0], "h": wc[0][1], "idx": widx})
    weight_err = float((w - ww).abs().max())
    new_p = torch.rand(B, generator=g, device="cuda") + 0.1
    _zero_launch_counts()
    sharded.update_priorities(idx, new_p)
    plain = sr.seq_update_priorities_keep_empty(plain, widx, new_p)
    torch.cuda.synchronize()
    write_back_equal = bool(torch.equal(sharded.state.priorities, plain.priorities))
    update_launches = cuda_per.update_launches
    times = {
        "sharded_sample_us": 1e3 * eager_time_ms(lambda: sharded.sample(B, u=u),
                                                 MESH_TIMED_REPS),
        "plain_sample_us": 1e3 * eager_time_ms(
            lambda: sr.seq_sample(plain, None, B, alpha=0.6, beta=0.4, method="pallas", u=u),
            MESH_TIMED_REPS),
        "sharded_write_back_us": 1e3 * eager_time_ms(
            lambda: sharded.update_priorities(idx, new_p), MESH_TIMED_REPS),
        "plain_write_back_us": 1e3 * eager_time_ms(
            lambda: sr.seq_update_priorities_keep_empty(plain, widx, new_p), MESH_TIMED_REPS),
    }
    return dict(slots=slots, T1=T1, obs=[84, 84, 4], batch=B, inserts=MESH_SEQ_INSERTS,
                state_mismatches=state_diff, sample_mismatches=sample_diff,
                weight_max_abs_err=weight_err, weight_tol=MESH_WEIGHT_TOL,
                sample_calls=sample_calls, sample_kernel_launches=2 * sample_calls,
                update_launches=update_launches, write_back_bit_equal=write_back_equal,
                **times, card=card)


def phase_mesh_replay(report: dict) -> None:
    """The sharded replays (``data/sharded_replay.py``) at dp = 1 on a
    one-rank nccl group, each against its unsharded buffer fed the same:
    the transition buffer on ``apex_train``'s 2^20 plane with
    ``use_pallas`` (state bit-equal, a sample with the same uniforms gives
    exact indices and weights within ``MESH_WEIGHT_TOL``, a write-back
    through the update kernel bit-equal to the plain version; the sample
    kernels launch twice a sample, the update kernel once a write-back),
    and the sequence ring on ``r2d2_device``'s geometry (the same checks;
    its keep-empty write-back is a plain scatter, as in JAX).  µs a sample
    and a write-back of both, in this run.  The group is destroyed at the
    end."""
    import torch
    import torch.distributed as dist

    _one_rank_group()
    try:
        mesh = _one_rank_mesh()
        trans = _mesh_replay_transitions(mesh, report["card"])
        seqs = _mesh_replay_sequences(mesh, report["card"])
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    emit("mesh_replay", transitions=trans, sequences=seqs, mesh="dp=1", backend="nccl",
         card=report["card"])
    report["mesh_replay"] = {"transitions": trans, "sequences": seqs}
    failed = []
    for name, out, update in (("transitions", trans, 1), ("sequences", seqs, 0)):
        checks = {
            "state bit-equal": not out["state_mismatches"],
            "exact indices and rows": not out["sample_mismatches"],
            "weights": out["weight_max_abs_err"] <= MESH_WEIGHT_TOL,
            "one sample call (2 kernel launches)": out["sample_calls"] == 1,
            "update launches": out["update_launches"] == update,
            "write-back bit-equal": out["write_back_bit_equal"],
        }
        failed += [f"{name}: {k}" for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"mesh_replay: {failed}")


def _deterministic():
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` with
    cuBLAS's deterministic workspace, as a context that records the ops
    that have no deterministic version."""
    import contextlib
    import warnings

    import torch

    @contextlib.contextmanager
    def ctx():
        prev_cfg = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True, warn_only=True)
        found: list = []
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                yield found
            found += sorted({str(w.message).split(" does not have")[0][:120]
                             for w in caught if "deterministic" in str(w.message)})
        finally:
            torch.use_deterministic_algorithms(False)
            if prev_cfg is None:
                os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
            else:
                os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev_cfg

    return ctx()


def _mesh_device_loop(card: str) -> dict:
    """The fused loop at ``impala_fused``'s width, meshed (dp = 1) and not,
    ``MAIN_CHUNKS`` chunks a run from one state, carry and generator state
    under deterministic algorithms, in turns (plain, mesh, mesh, plain);
    warm chunks under sync debug mode "error"; V-trace launches of a meshed
    run counted."""
    import torch

    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.config import ImpalaArguments
    from scalerl_torch.envs.tensor_envs import SyntheticPixelEnv
    from scalerl_torch.ops import cuda_vtrace
    from scalerl_torch.runtime.device_loop import DeviceActorLearnerLoop

    set_tf32(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    args = ImpalaArguments(use_lstm=False, hidden_size=512, rollout_length=MAIN_T,
                           batch_size=MAIN_B, max_timesteps=0, compute_dtype="bfloat16",
                           use_pallas=True)
    env = SyntheticPixelEnv(num_envs=MAIN_B)
    agent = ImpalaAgent(args, obs_shape=env.observation_shape, num_actions=env.num_actions)
    loops = {"plain": DeviceActorLearnerLoop(agent.model, env, agent.make_learn_fn(), MAIN_T,
                                             iters_per_call=MAIN_ITERS),
             "mesh": DeviceActorLearnerLoop(agent.model, env, agent.make_learn_fn(), MAIN_T,
                                            iters_per_call=MAIN_ITERS, mesh=_one_rank_mesh())}
    state, carry, _ = loops["plain"].run(agent.state, loops["plain"].init_carry(), 1)
    loops["mesh"].run(_clone_tree(state), _clone_tree(carry), 1)  # its own warm-up chunk
    gen0 = loops["plain"].generator.get_state()
    runs: dict = {}
    seconds: dict = {"plain": [], "mesh": []}
    with _deterministic() as nondeterministic:
        # in turns, plain, mesh, mesh, plain: each twin pays the same warmth
        for name in ("plain", "mesh", "mesh", "plain"):
            loop = loops[name]
            loop.generator.set_state(gen0)
            stream: list = []
            cuda_vtrace.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s, c, _ = loop.run(_clone_tree(state), _clone_tree(carry), MAIN_CHUNKS,
                               on_metrics=lambda i, m: stream.append(m))
            torch.cuda.synchronize()
            seconds[name].append(time.perf_counter() - t0)
            runs.setdefault(name, dict(state=s, carry=c, stream=stream,
                                       vtrace=cuda_vtrace.launches,
                                       gen=loop.generator.get_state()))
    p, m = runs["plain"], runs["mesh"]
    bad, worst = _tree_diff((p["state"], p["carry"]), (m["state"], m["carry"]))
    frames = MAIN_CHUNKS * MAIN_ITERS * MAIN_T * MAIN_B
    return dict(B=MAIN_B, T=MAIN_T, iters_per_call=MAIN_ITERS, chunks=MAIN_CHUNKS,
                order="plain, mesh, mesh, plain",
                mesh_env_frames_per_s=[frames / x for x in seconds["mesh"]],
                plain_env_frames_per_s=[frames / x for x in seconds["plain"]],
                bit_equal=bad == 0 and p["stream"] == m["stream"],
                differing_leaves=bad, max_abs_diff=worst,
                metric_stream_equal=p["stream"] == m["stream"],
                generator_equal=bool(torch.equal(p["gen"], m["gen"])),
                vtrace_launches_mesh=m["vtrace"], vtrace_launches_plain=p["vtrace"],
                nondeterministic_ops=nondeterministic, warm_sync_debug_mode="error", card=card)


def _mesh_device_r2d2(card: str) -> dict:
    """``DeviceR2D2Trainer`` at ``r2d2_device``'s settings, meshed (dp = 1)
    and not, ``MESH_R2D2_ITERS`` iterations each from the same seed under
    deterministic algorithms; warm iterations under sync debug mode
    "error"; launches counted."""
    import torch

    from scalerl_torch.agents.r2d2 import R2D2Agent
    from scalerl_torch.config import R2D2Arguments
    from scalerl_torch.envs.tensor_envs import SyntheticPixelEnv
    from scalerl_torch.trainer.r2d2_device import DeviceR2D2Trainer

    set_tf32(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    args = R2D2Arguments(env_id="SyntheticPixel-v0", use_pallas=True, logger_backend="none",
                         telemetry_interval_s=0.0, save_model=False, logger_frequency=10**9,
                         replay_capacity=R2D2_SLOTS, work_dir=_work_dir("mesh_r2d2_device"))
    env = SyntheticPixelEnv(16)
    frames = MESH_R2D2_ITERS * args.rollout_length * env.num_envs
    runs = {}
    with _deterministic() as nondeterministic:
        for name, mesh in (("plain", None), ("mesh", _one_rank_mesh())):
            agent = R2D2Agent(args, env.observation_shape, env.num_actions)
            trainer = DeviceR2D2Trainer(args, agent, env, mesh=mesh)
            _zero_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = trainer.train(total_frames=frames)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            runs[name] = dict(state=_clone_tree(agent.state), launches=_launch_counts(),
                              prio=trainer.replay.priorities.clone(), seconds=seconds,
                              learn_steps=int(agent.state.step), result=result)
            trainer.close()
            del trainer, agent
            torch.cuda.empty_cache()
    p, m = runs["plain"], runs["mesh"]
    bad, worst = _tree_diff(p["state"], m["state"])
    prio_equal = bool(torch.equal(p["prio"], m["prio"]))
    # where the two differ, name the cause: a slot the plain write-back made
    # live that the keep-empty one left empty
    resurrected = int(((p["prio"] > 0) & (m["prio"] == 0)).sum())
    return dict(envs=env.num_envs, iterations=MESH_R2D2_ITERS, batch=args.batch_size,
                replay_slots=args.replay_capacity,
                mesh_env_frames_per_s=m["result"]["env_frames"] / m["seconds"],
                plain_env_frames_per_s=p["result"]["env_frames"] / p["seconds"],
                learn_steps_mesh=m["learn_steps"], learn_steps_plain=p["learn_steps"],
                launches_mesh=m["launches"], bit_equal=bad == 0 and prio_equal,
                differing_leaves=bad, max_abs_diff=worst, priorities_equal=prio_equal,
                slots_the_plain_write_back_made_live=resurrected,
                mesh_total_loss=m["result"].get("total_loss"),
                mesh_skipped_steps=m["result"].get("skipped_steps"),
                nondeterministic_ops=nondeterministic, warm_sync_debug_mode="error", card=card)


def _mesh_apex(report: dict) -> dict:
    """``examples/train_apex_torch.py``'s ``main()`` at ``apex_train``'s
    settings with ``--mesh-shape dp=1`` for ``MESH_APEX_S`` (SIGTERM;
    the guard saves), every kernel's launch count zeroed just before."""
    import threading
    from unittest import mock

    import torch

    from scalerl_torch.data.sharded_replay import ShardedPrioritizedReplay
    from scalerl_torch.trainer.apex import ApexTrainer

    set_tf32(False)
    argv = ["--use-pallas", "--env-backend", "jax", "--num-envs", "16", "--n-steps", "3",
            "--buffer-size", str(1 << 20), "--batch-size", str(PER_BATCH),
            "--max-timesteps", str(10**9), "--eval-frequency", str(10**9),
            "--logger-frequency", "5000", "--save-frequency", str(10**9),
            "--logger-backend", "none", "--telemetry-interval-s", "0",
            "--work-dir", _work_dir("mesh_apex"), "--mesh-shape", "dp=1"]
    started, run = threading.Event(), ApexTrainer.run

    def timed_run(self):
        self.t0 = time.perf_counter()
        started.set()
        try:
            return run(self)
        finally:
            self.t1 = time.perf_counter()

    killer, done = _sigterm_after(MESH_APEX_S, started)
    _zero_launch_counts()
    try:
        with mock.patch.object(ApexTrainer, "run", timed_run):
            out = _example_module("train_apex_torch").main(argv)
    finally:
        done.set()
        killer.join()
    torch.cuda.synchronize()
    trainer = out["trainer"]
    seconds = trainer.t1 - trainer.t0
    launches = _launch_counts()
    losses = [m["loss"] for _, kind, m in trainer.log_history if kind == "train" and "loss" in m]
    twin = report.get("apex_train", {})
    return dict(sharded=isinstance(trainer.buffer, ShardedPrioritizedReplay),
                meshed=out["agent"].mesh is not None,
                replay_shard=getattr(out["agent"]._learn, "batch_mode", None) == "replay_shard",
                replay=[trainer.buffer.capacity, trainer.buffer.num_envs], seconds=seconds,
                env_steps=trainer.global_step, mesh_env_steps_per_s=trainer.global_step / seconds,
                plain_env_steps_per_s=twin.get("env_steps_per_s"),
                learn_steps=trainer.learn_steps,
                mesh_learn_steps_per_s=trainer.learn_steps / seconds,
                plain_learn_steps_per_s=twin.get("learn_steps_per_s"), launches=launches,
                finite=bool(losses) and all(math.isfinite(x) for x in losses),
                actor_errors=sum(a.error is not None for a in trainer.actors),
                card=report["card"])


def phase_mesh_loops(report: dict) -> None:
    """The loops and trainers under a one-rank nccl mesh, each beside its
    unmeshed twin: the fused device loop (``DeviceActorLearnerLoop(mesh=)``)
    and the mesh-fused ``DeviceR2D2Trainer``, both
    bit-equal to the unmeshed runs under deterministic algorithms (or, where
    an op without a deterministic version or the keep-empty write-back makes
    a difference, named, within ``LEARN_TOL``), V-trace launches 5 a chunk,
    sample launches = learn steps; and the Ape-X example with
    ``--mesh-shape dp=1`` on its ``ShardedPrioritizedReplay``, the sample
    and update kernels launched once each a learn step.  frames/s of each
    beside its twin's.  The group is destroyed at the end."""
    import torch
    import torch.distributed as dist

    _one_rank_group()
    try:
        loop = _mesh_device_loop(report["card"])
        r2d2 = _mesh_device_r2d2(report["card"])
        apex = _mesh_apex(report)
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    emit("mesh_loops", device_loop=loop, r2d2_device=r2d2, apex=apex, mesh="dp=1",
         backend="nccl", tol=LEARN_TOL["kernel_vs_plain_update_abs"], card=report["card"])
    report["mesh_loops"] = {"device_loop": loop, "r2d2_device": r2d2, "apex": apex}
    tol = LEARN_TOL["kernel_vs_plain_update_abs"]

    def close(out) -> bool:
        cause = out["nondeterministic_ops"] or out.get("slots_the_plain_write_back_made_live")
        return out["bit_equal"] or (bool(cause) and out["max_abs_diff"] <= tol)

    checks = {
        "device loop = unmeshed loop": close(loop) and loop["generator_equal"],
        "vtrace launches 5 a chunk": loop["vtrace_launches_mesh"] == MAIN_CHUNKS * MAIN_ITERS
        == loop["vtrace_launches_plain"],
        "device r2d2 = unmeshed trainer": close(r2d2),
        "device r2d2 learn steps": r2d2["learn_steps_mesh"] == r2d2["learn_steps_plain"] > 0,
        "device r2d2 sample launches = learn steps":
            r2d2["launches_mesh"]["per_sample"] == r2d2["learn_steps_mesh"],
        "device r2d2 finite": math.isfinite(r2d2["mesh_total_loss"] or float("nan"))
        and r2d2["mesh_skipped_steps"] == 0.0,
        "apex sharded and meshed": apex["sharded"] and apex["meshed"] and apex["replay_shard"],
        "apex learn steps": apex["learn_steps"] > 0,
        "apex sample launches = learn steps": apex["launches"]["per_sample"]
        == apex["learn_steps"],
        "apex update launches = learn steps": apex["launches"]["per_update"]
        == apex["learn_steps"],
        "apex finite, no actor errors": apex["finite"] and apex["actor_errors"] == 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"mesh_loops: {failed}")


# Switch-MoE IMPALA (phase 60): policy_arch="moe" at the JAX defaults on
# impala_fused's geometry; the learner's [T+1, B] chunk is 10,752 tokens
MOE_D, MOE_E, MOE_H, MOE_CF = 128, 8, 256, 2.0
MOE_TOKENS = (MAIN_T + 1) * MAIN_B
# the index-form layer against its dense one-hot twin on the same inputs,
# float32 with TF32 off: a product with a one-hot entry is exact and the
# expert products are the same batched matmuls, so only sum orders may
# differ; held relative to each tensor's largest element (at least 1)
MOE_LAYER_TOL = 1e-5


def _rel_err(got, want, floor: float = 1.0) -> float:
    """Max abs difference over the larger of ``floor`` and the largest
    |want| (gradients pass a floor near 0: relative to their largest)."""
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max()) / max(float(want.abs().max()), floor)


def _moe_args(**kw):
    from scalerl_torch.config import ImpalaArguments

    base = dict(policy_arch="moe", d_model=MOE_D, moe_experts=MOE_E, moe_hidden=MOE_H,
                use_lstm=False, rollout_length=MAIN_T, batch_size=MAIN_B, max_timesteps=0,
                use_pallas=True)
    return ImpalaArguments(**{**base, **kw})


def _moe_traj(obs_shape, A, seed=5):
    import torch

    from scalerl_torch.data.trajectory import Trajectory

    g = torch.Generator(device="cuda").manual_seed(seed)
    T1 = MAIN_T + 1
    logits = torch.randn(T1, MAIN_B, A, generator=g, device="cuda")
    logits[-1] = 0.0
    return Trajectory(
        obs=torch.randint(0, 256, (T1, MAIN_B) + tuple(obs_shape), generator=g, device="cuda",
                          dtype=torch.uint8),
        action=torch.randint(0, A, (T1, MAIN_B), generator=g, device="cuda"),
        reward=torch.randn(T1, MAIN_B, generator=g, device="cuda"),
        done=torch.rand(T1, MAIN_B, generator=g, device="cuda") < 0.05, logits=logits)


def _moe_layer_check(layer, x) -> dict:
    """The index-form layer against its dense twin on ``x``: out, aux,
    dispatch_frac and the gradients of ``sum(out^2) + 0.01 aux`` (input and
    every param); each form's forward + backward time."""
    import torch

    res = {}
    for name, dense in (("index", False), ("dense", True)):
        layer.dense_dispatch = dense
        xin = x.detach().clone().requires_grad_(True)

        def step():
            out = layer(xin)
            loss = (out.out ** 2).sum() + 0.01 * out.aux_loss
            return out, torch.autograd.grad(loss, [xin] + list(layer.parameters()))

        out, grads = step()
        res[name] = dict(out=out, grads=grads, ms=eager_time_ms(step, 2, reps=3))
    layer.dense_dispatch = False
    i, d = res["index"], res["dense"]
    return dict(out_rel_err=_rel_err(i["out"].out, d["out"].out),
                aux_abs_err=abs(float(i["out"].aux_loss.detach())
                                - float(d["out"].aux_loss.detach())),
                dispatch_frac=float(i["out"].dispatch_frac),
                dispatch_frac_dense=float(d["out"].dispatch_frac),
                grad_rel_err=max(_rel_err(a, b, 1e-30) for a, b in zip(i["grads"], d["grads"])),
                index_ms=i["ms"], dense_ms=d["ms"])


def phase_moe_impala(report: dict) -> None:
    """``policy_arch="moe"`` (``MoEPolicyNet``, the JAX defaults) on
    ``impala_fused``'s geometry: the index-form MoE layer against its dense
    one-hot twin at the learner's 10,752 tokens (``MOE_LAYER_TOL``), one
    learn step with each (``LEARN_TOL``); the fused loop (V-trace launches
    5 a chunk, warm chunks under sync debug mode "error", a profiled
    chunk's device time); one meshed learn step at dp = mp = 1 on a
    one-rank nccl group against the unmeshed step under deterministic
    algorithms, bit for bit."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.envs.tensor_envs import SyntheticPixelEnv
    from scalerl_torch.models.moe import MoEPolicyNet
    from scalerl_torch.ops import cuda_vtrace
    from scalerl_torch.runtime.device_loop import DeviceActorLearnerLoop

    set_tf32(False)
    env = SyntheticPixelEnv(num_envs=MAIN_B)
    obs_shape, A = env.observation_shape, env.num_actions
    traj = _moe_traj(obs_shape, A)
    agent = ImpalaAgent(_moe_args(), obs_shape, A)
    if not isinstance(agent.model, MoEPolicyNet):
        raise AssertionError(f"policy_arch='moe' built {type(agent.model).__name__}")
    policy = agent.model.moe_policy
    with torch.no_grad():  # the layer's input in the learn step: the embedded chunk
        x = F.relu(policy.embed(traj.obs.reshape(MOE_TOKENS, -1).float()))
    layer = _moe_layer_check(policy.moe, x)
    del agent

    # one learn step with each form, from the same weights and chunk
    steps = {}
    for name, dense in (("index", False), ("dense", True)):
        a = ImpalaAgent(_moe_args(), obs_shape, A)
        a.model.moe_policy.moe.dense_dispatch = dense
        before = _flat_params(a.state)
        metrics = a.learn(traj)
        steps[name] = (metrics, _flat_params(a.state) - before)
        del a
    (mi, ui), (md, ud) = steps["index"], steps["dense"]
    learn_errs = {"kernel_vs_plain_update_abs": float((ui - ud).abs().max()),
                  "loss_rel": abs(mi["total_loss"] - md["total_loss"]) / max(
                      abs(md["total_loss"]), 1.0),
                  "grad_norm_rel": abs(mi["grad_norm"] - md["grad_norm"]) / max(
                      abs(md["grad_norm"]), 1.0)}

    # the fused loop, as impala_fused runs AtariNet
    set_tf32(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    agent = ImpalaAgent(_moe_args(), obs_shape, A)
    loop = DeviceActorLearnerLoop(agent.model, env, agent.make_learn_fn(),
                                  unroll_length=MAIN_T, iters_per_call=MAIN_ITERS)
    carry = loop.init_carry()
    state, carry, _ = loop.run(agent.state, carry, num_calls=1)  # warm-up chunk
    chunk_metrics = []
    cuda_vtrace.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, carry, _ = loop.run(state, carry, num_calls=MAIN_CHUNKS,
                                  on_metrics=lambda i, m: chunk_metrics.append(m))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = cuda_vtrace.launches
    _, kernels = profile_device(lambda: loop.run(state, carry, num_calls=1))
    device_ms = sum(us for _, us, _ in kernels) / 1e3
    del loop, agent, state, carry

    # the meshed step at dp = mp = 1 against the unmeshed one
    set_tf32(False)
    _one_rank_group()
    try:
        mesh_steps = {}
        with _deterministic() as nondeterministic:
            for name in ("plain", "mesh"):
                a = ImpalaAgent(_moe_args(), obs_shape, A)
                if name == "mesh":
                    a.enable_mesh("dp=1,mp=1")
                before = _flat_params(a.state)
                cuda_vtrace.launches = 0
                metrics = a.learn(traj)
                torch.cuda.synchronize()
                mesh_steps[name] = (metrics, _flat_params(a.state) - before, cuda_vtrace.launches)
                del a
    finally:
        dist.destroy_process_group()
    (mp_, up, vp), (mm, um, vm) = mesh_steps["plain"], mesh_steps["mesh"]
    mesh_bit_equal = bool(torch.equal(up, um)) and mp_ == mm
    mesh_max_abs = float((up - um).abs().max())

    frames = MAIN_CHUNKS * MAIN_ITERS * MAIN_T * MAIN_B
    out = dict(tokens=MOE_TOKENS, experts=MOE_E, d_model=MOE_D, d_hidden=MOE_H,
               capacity_factor=MOE_CF, capacity=max(int(MOE_CF * MOE_TOKENS / MOE_E), 1),
               layer=layer, layer_tol=MOE_LAYER_TOL,
               tokens_dropped_per_learn_step=round(MOE_TOKENS * (1 - layer["dispatch_frac"])),
               learn_index_vs_dense=learn_errs, learn_tol=LEARN_TOL,
               B=MAIN_B, T=MAIN_T, iters_per_call=MAIN_ITERS, chunks=MAIN_CHUNKS,
               env_frames_per_s=frames / seconds, chunk_s=seconds / MAIN_CHUNKS,
               device_ms_per_chunk=device_ms,
               impala_fused_atarinet_env_frames_per_s=report.get("impala_fused_rate"),
               vtrace_launches=launches,
               mesh=dict(spec="dp=1,mp=1", backend="nccl", bit_equal=mesh_bit_equal,
                         max_abs_diff=mesh_max_abs, vtrace_launches_mesh=vm,
                         vtrace_launches_plain=vp, nondeterministic_ops=nondeterministic),
               warm_sync_debug_mode="error", card=report["card"])
    emit("moe_impala", **out)
    report["moe_impala"] = out
    checks = {
        "layer out": layer["out_rel_err"] <= MOE_LAYER_TOL,
        "layer aux": layer["aux_abs_err"] <= MOE_LAYER_TOL,
        "layer dispatch_frac": layer["dispatch_frac"] == layer["dispatch_frac_dense"],
        "layer grads": layer["grad_rel_err"] <= MOE_LAYER_TOL,
        "learn step": all(v <= LEARN_TOL[k] for k, v in learn_errs.items()),
        "vtrace launches 5 a chunk": launches == MAIN_CHUNKS * MAIN_ITERS,
        "chunk metrics": len(chunk_metrics) == MAIN_CHUNKS and all(
            math.isfinite(v) for m in chunk_metrics for v in m.values())
        and all(m["skipped_steps"] == 0.0 for m in chunk_metrics),
        "meshed step": mesh_bit_equal or (
            bool(nondeterministic) and mesh_max_abs <= LEARN_TOL["kernel_vs_plain_update_abs"]),
        "meshed vtrace launches": vm == vp == 1,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"moe_impala: {failed}")


# the mesh families at extent 1 (phase 61): the CPU tests' tolerances
# (tests/test_torch_mesh_families.py), held relative to each compared
# tensor's largest element (at least 1); ring attention at PERF.md's T4k
# bf16 and T1k float32 shapes, the sequence-parallel transformer and the
# pipeline's block at the transformer learner's width, expert parallelism
# at the MoE learner's 10,752 tokens
FAMILY_RING_SHAPES = {"T4k_bf16": ((1, 4096, 8, 64), "bfloat16"),
                      "T1k_f32": ((2, 1024, 4, 64), "float32")}
FAMILY_TOL = {"ring_float32": 2e-5, "ring_bfloat16": 0.06, "sequence": 3e-5,
              "pipeline": 2e-5, "pipeline_grads": 5e-5, "expert": 2e-5,
              "expert_grads": 1e-5}
FAMILY_PIPE_M = 4
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_object", "broadcast",
               "broadcast_object_list", "send", "recv", "isend", "irecv", "batch_isend_irecv",
               "reduce_scatter_tensor", "all_to_all")


def _count_collectives():
    """Wrap ``torch.distributed``'s collectives and point-to-point calls with
    counters; returns the counts and a function that restores them."""
    import torch.distributed as dist

    counts = {name: 0 for name in COLLECTIVES}
    saved = {name: getattr(dist, name) for name in COLLECTIVES}

    def wrap(name):
        def counted(*args, **kwargs):
            counts[name] += 1
            return saved[name](*args, **kwargs)
        return counted

    for name in COLLECTIVES:
        setattr(dist, name, wrap(name))

    def restore():
        for name, fn in saved.items():
            setattr(dist, name, fn)

    return counts, restore


def _grad_pair(fn_a, fn_b, inputs):
    """Outputs and input gradients of two functions of ``inputs`` under one
    loss (the sum of squares of every output), and each one's forward +
    backward time."""
    import torch

    res = []
    for fn in (fn_a, fn_b):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]

        def step():
            outs = fn(*leaves)
            outs = outs if isinstance(outs, (tuple, list)) else (outs,)
            loss = sum((o.float() ** 2).sum() for o in outs)
            return outs, torch.autograd.grad(loss, leaves)

        outs, grads = step()
        res.append((outs, grads, eager_time_ms(step, 2, reps=3)))
    return res


def _families_at_extent_one(meshes: dict) -> dict:
    """The four paths at extent 1 against their plain twins: each one's
    errors (``{"err", "tol"}``) and forward + backward ms."""
    import torch
    import torch.nn.functional as F
    from torch.func import functional_call

    from scalerl_torch.models.moe import MoEMLP
    from scalerl_torch.models.transformer import TransformerPolicy
    from scalerl_torch.ops.ring_attention import full_attention, make_ring_attention_fn
    from scalerl_torch.parallel import (
        hetero_sequential_apply,
        make_expert_parallel_apply,
        make_hetero_pipeline_apply,
        make_sequence_parallel_apply,
    )

    errors: dict = {}
    times: dict = {}
    g = torch.Generator(device="cuda").manual_seed(11)

    def record(path, pair, out_tol, grad_tol):
        (got, got_grads, ms), (want, want_grads, plain_ms) = pair
        errors[f"{path}:out"] = {"err": max(_rel_err(a, b) for a, b in zip(got, want)),
                                 "tol": out_tol}
        errors[f"{path}:grads"] = {"err": max(_rel_err(a, b, 1e-30)
                                              for a, b in zip(got_grads, want_grads)),
                                   "tol": grad_tol}
        times[path] = {"ms": ms, "plain_ms": plain_ms}

    # ring attention at sp = 1 against full attention, causal
    ring = make_ring_attention_fn(meshes["sp"], causal=True)
    for name, (shape, dtype) in FAMILY_RING_SHAPES.items():
        qkv = [torch.randn(shape, generator=g, device="cuda").to(getattr(torch, dtype))
               for _ in range(3)]
        tol = FAMILY_TOL[f"ring_{dtype}"]
        record(f"ring_{name}", _grad_pair(
            ring, lambda q, k, v: full_attention(q, k, v, causal=True), qkv), tol, tol)

    # the sequence-parallel transformer at sp = 1 against the plain model,
    # at the transformer learner's width
    T1 = SHARD_T + 1
    model = TransformerPolicy(num_actions=SHARD_A, d_model=SHARD_D, num_heads=SHARD_HEADS,
                              num_layers=SHARD_LAYERS, max_len=T1, obs_dim=SHARD_OBS,
                              generator=torch.Generator().manual_seed(0))
    obs = torch.randn(SHARD_B, T1, SHARD_OBS, generator=g, device="cuda")
    sp_apply = make_sequence_parallel_apply(model, meshes["sp"])
    names = [n for n, _ in model.named_parameters()]

    def sequence(*ps):
        return tuple(sp_apply(dict(zip(names, ps)), obs))

    def plain(*ps):
        return tuple(functional_call(model, dict(zip(names, ps)), (obs,)))

    record("sequence", _grad_pair(sequence, plain, [p for _, p in model.named_parameters()]),
           FAMILY_TOL["sequence"], FAMILY_TOL["sequence"])

    # the heterogeneous pipeline at pp = 1, M = 4: embed -> one block of the
    # model above -> final norm and policy head
    block = model.blocks[0]
    embed_keys, head_keys = ("w", "b", "pos"), ("ln", "w", "b")
    block_names = [n for n, _ in block.named_parameters()]

    def embed_fn(p, x):
        return F.linear(x, p["w"], p["b"]) + p["pos"]

    def block_fn(p, x):
        return functional_call(block, p, (x,))

    def head_fn(p, x):
        return F.linear(F.layer_norm(x, (SHARD_D,), p["ln"], None, 1e-6), p["w"], p["b"])

    def tree(ps):
        e, b, h = ps[:3], ps[3:3 + len(block_names)], ps[3 + len(block_names):]
        return {"embed": dict(zip(embed_keys, e)), "block": dict(zip(block_names, b)),
                "head": dict(zip(head_keys, h))}

    pipe = make_hetero_pipeline_apply(embed_fn, block_fn, head_fn, meshes["pp"],
                                      FAMILY_PIPE_M)
    leaves = ([model.obs_embed.weight, model.obs_embed.bias, model.pos_embed[:T1]]
              + [p[None] for _, p in block.named_parameters()]
              + [model.final_norm.weight, model.policy_head.weight, model.policy_head.bias])
    record("pipeline", _grad_pair(
        lambda *ps: pipe(tree(ps), obs),
        lambda *ps: hetero_sequential_apply(embed_fn, block_fn, head_fn, tree(ps), obs),
        leaves), FAMILY_TOL["pipeline"], FAMILY_TOL["pipeline_grads"])

    # expert parallelism at ep = 1 against the single-device layer, at the
    # MoE learner's tokens
    layer = MoEMLP(MOE_E, MOE_D, MOE_H, MOE_CF, generator=torch.Generator().manual_seed(1))
    x = torch.randn(MOE_TOKENS, MOE_D, generator=g, device="cuda")
    apply_fn, sharded = make_expert_parallel_apply(layer, meshes["ep"])
    expert_names = list(sharded)

    def expert(xx, *ps):
        out = apply_fn(dict(zip(expert_names, ps)), xx)
        return out.out, out.aux_loss

    def single(xx, *ps):
        out = functional_call(layer, dict(zip(expert_names, ps)), (xx,))
        return out.out, out.aux_loss

    record("expert", _grad_pair(expert, single, [x] + [sharded[n] for n in expert_names]),
           FAMILY_TOL["expert"], FAMILY_TOL["expert_grads"])
    return dict(errors=errors, times=times, ring_shapes=FAMILY_RING_SHAPES,
                sequence_width=dict(d_model=SHARD_D, layers=SHARD_LAYERS, heads=SHARD_HEADS,
                                    B=SHARD_B, T=T1),
                pipeline_microbatches=FAMILY_PIPE_M, expert_tokens=MOE_TOKENS)


def phase_parallel_families(report: dict) -> None:
    """Ring attention, the sequence-parallel transformer, the heterogeneous
    pipeline and expert parallelism at extent 1 (sp = pp = ep = 1), each
    against its plain twin, forward and backward, on a one-rank nccl group
    that the port's own ``initialize_multihost`` makes.  At extent 1 no
    collective runs: every ``torch.distributed`` collective and
    point-to-point call is counted and must stay at 0.  The multi-rank
    paths are held on the CPU on 4 gloo ranks."""
    import torch.distributed as dist

    from scalerl_torch.parallel import initialize_multihost, make_mesh

    set_tf32(False)
    ran = initialize_multihost(coordinator_address=f"127.0.0.1:{_free_port()}",
                               num_processes=1, process_id=0)
    if not ran or dist.get_world_size() != 1 or dist.get_backend() != "nccl":
        raise AssertionError(f"initialize_multihost: ran={ran}")
    try:
        meshes = {axis: make_mesh(f"{axis}=1") for axis in ("sp", "pp", "ep")}
        if any(m.device_mesh is None for m in meshes.values()):
            raise AssertionError("a one-rank mesh has no DeviceMesh")
        counts, restore = _count_collectives()
        try:
            out = _families_at_extent_one(meshes)
        finally:
            restore()
    finally:
        dist.destroy_process_group()
    print("parallel_families: at extent 1 (sp = pp = ep = 1, one card) no collective runs; "
          "the multi-rank paths are held on the CPU on 4 gloo ranks", flush=True)
    emit("parallel_families", world_size=1, backend="nccl", **out, collectives=counts,
         card=report["card"])
    report["parallel_families"] = out
    bad = {k: v for k, v in out["errors"].items() if not v["err"] <= v["tol"]}
    if bad or any(counts.values()):
        raise AssertionError(f"parallel_families: off tolerance {bad}, collectives {counts}")


# the learn step on its shards across two ranks of the one card (phase 62).
# Two nccl ranks on one card fail at their first all-reduce ("Duplicate GPU
# detected"); a probe of two gloo ranks on cuda:0 found all_reduce (float32,
# bfloat16, an int32 MIN), all_gather, all_gather_into_tensor, broadcast
# and reduce_scatter_tensor right on CUDA tensors in the card's PyTorch.  So
# this phase runs the meshed step on 2 spawned gloo ranks, both on cuda:0,
# each configuration at full width against the one-rank step on the same
# global batch in this process; the probe runs first in the ranks, and a
# failed collective fails the phase.  Two ranks share one card's SMs and
# gloo stages each collective through host memory, so their ms per step is
# the cost of that setup, not of two cards.
SC_WORLD = 2
SC_JOIN_S = 300.0
SC_STEPS = 2  # compared learn steps from the same state; the second is timed
SC_ATARI_A = 6
SC_CONFIGS = {
    "transformer_bf16_mp2": "mp=2",  # bench.py's sharded learner: d 1024, 8 layers, bf16, flash
    "transformer_f32_mp2": "mp=2",  # the same in float32
    "token_ppo_mp2": "mp=2",  # V 1024, d 256, 4 layers, 64 rows of 512, segment kernels
    "impala_fsdp2": "fsdp=2",  # AtariNet 512, B 512, T 20, V-trace kernel
    "impala_tp2": "tp=2",
}
# per step and rank: a flash kernel per block, a segment kernel per block
# (kl_cost = 0: no reference forward), V-trace once
SC_LAUNCHES = {
    "transformer": {k: SHARD_LAYERS for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                                              "flash_attention_bwd_dkv")},
    "token_ppo": {k: TRAIN_LAYERS for k in ("segment_attention_fwd",
                                            "segment_attention_bwd_dq",
                                            "segment_attention_bwd_dkv")},
    "impala": {"vtrace": 1},
}
# the sharded step against the one-rank step.  The loss and the grad norm of
# the first step (one state, one batch) at the CPU tests' bounds
# (tests/test_torch_sharded_learner.py: loss 1e-5, metrics 1e-4), in bf16 at
# the bf16 learner's (SHARD_BF16_TOL: a row-parallel layer rounds each
# rank's partial product to bfloat16 before the sum, where one rank rounds
# the whole product once).  The update after SC_STEPS steps: the float32
# transformer's params at the CPU tests' rtol 2e-5, atol 2e-6; token-PPO's
# by relative L2 (TOKEN_PPO_TOL: Adam's first step is lr * sign(g) where a
# gradient element sits at float noise); IMPALA's as card against host
# (LEARN_TOL): its column- and row-parallel convs and GEMMs run at other
# shapes, for which cuDNN and cuBLAS pick other algorithms, and on the card
# the one-rank step's own trunk gradients move 2e-3 to 8e-3 of their
# largest between cuDNN and PyTorch's own convolutions at this batch (ReLU
# masks flip where a pre-activation sits at rounding; tools/shard_grads_study.py).
# The bf16 update is printed, not held: the float32 twin holds the path
SC_TOL = {"loss_rel": 1e-5, "grad_norm_rel": 1e-4, "param_rtol": 2e-5, "param_atol": 2e-6,
          "update_rel_l2": TOKEN_PPO_TOL["update_rel_l2"],
          "conv_update_rel_l2": LEARN_TOL["card_vs_host_update_rel_l2"],
          "bf16_loss_rel": SHARD_BF16_TOL["loss_rel"],
          "bf16_grad_norm_rel": SHARD_BF16_TOL["grad_leaf_rel"]}
SC_PROBE_OPS = ("all_reduce", "all_reduce_bf16", "all_reduce_min_int32", "all_gather",
                "broadcast", "reduce_scatter_tensor", "scatter")


def _sc_family(name: str) -> str:
    return name.split("_")[0] if not name.startswith("token") else "token_ppo"


def _sc_agent(name: str):
    """The agent of configuration ``name`` from its seed, and its global
    batch (made on the host from a seed, so every process holds the same)."""
    import torch

    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.config import ImpalaArguments
    from scalerl_torch.data.trajectory import Trajectory

    if name.startswith("transformer"):
        args = _shard_args(bf16_params=name == "transformer_bf16_mp2")
        return ImpalaAgent(args, (SHARD_OBS,), SHARD_A), (_shard_traj("cuda", seed=5),)
    if name == "token_ppo_mp2":
        from scalerl_torch.agents.token_ppo import TokenPPOAgent
        from scalerl_torch.trainer.sequence_rl import build_genrl_model

        args = _train_args()
        fields = _learn_step_fields(np.random.default_rng(2))
        batch = {k: torch.tensor(v).cuda() for k, v in fields.items()}
        batch["is_weight"] = (torch.rand(TRAIN_B, generator=torch.Generator().manual_seed(3))
                              * 0.7 + 0.3).cuda()
        return TokenPPOAgent(args, build_genrl_model(args)), (batch,)
    T, B, A = MAIN_T, MAIN_B, SC_ATARI_A
    g = torch.Generator().manual_seed(9)
    traj = Trajectory(
        obs=torch.randint(0, 256, (T + 1, B, 84, 84, 4), generator=g, dtype=torch.uint8).cuda(),
        action=torch.randint(0, A, (T + 1, B), generator=g).cuda(),
        reward=torch.randn(T + 1, B, generator=g).cuda(),
        done=(torch.rand(T + 1, B, generator=g) < 0.05).cuda(),
        logits=torch.randn(T + 1, B, A, generator=g).cuda())
    args = ImpalaArguments(use_lstm=False, hidden_size=512, rollout_length=T, batch_size=B,
                           max_timesteps=0, use_pallas=True)
    return ImpalaAgent(args, (84, 84, 4), A), (traj,)


def _sc_flat(state) -> "object":
    """The params of ``state`` as one flat float32 vector on the host."""
    import torch

    from scalerl_torch.parallel.sharding import gather_tree

    return torch.cat([v.float().reshape(-1) for v in gather_tree(state.params).values()]).cpu()


def _sc_measure(agent, before) -> dict:
    """``SC_STEPS`` learn steps of ``agent`` (meshed or not) on its batch,
    held in a local state (no acting copy is made), from the params
    ``before`` (flat, taken before the mesh placed them): the metrics, the
    update of the whole params, the launches per step, the peak memory the
    steps took above what was allocated before them, the state's bytes on
    this rank, and the last step's ms on the host clock."""
    import torch

    from scalerl_torch.parallel.sharding import to_local
    from scalerl_torch.utils.tree import tree_leaves

    batch = agent._sc_batch
    if agent._shard_batch is not None:
        batch = tuple(agent._shard_batch(b) for b in batch)
    state = agent.state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the state, the batch, what came before
    _zero_launch_counts()
    metrics = []
    for _ in range(SC_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = agent._learn(state, *batch)[:2]
        metrics.append({k: float(v) for k, v in m.items()})
        ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v / SC_STEPS for k, v in _launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() - held
    state_bytes = sum(to_local(x).numel() * to_local(x).element_size()
                      for x in tree_leaves(state))
    return dict(metrics=metrics, before=before, after=_sc_flat(state), launches=launches,
                peak_bytes=peak, state_bytes=state_bytes, ms_per_step=ms)


def _sc_probe_ops(rank: int, world: int) -> dict:
    """Each collective the meshed step issues (and the scatter that places a
    state), on CUDA tensors over the gloo group: True where the result is
    right, else the error."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    total = sum(range(1, world + 1))

    def all_reduce(dtype=torch.float32):
        x = torch.full((1000,), float(rank + 1), device=dev, dtype=dtype)
        dist.all_reduce(x)
        return bool((x == total).all())

    def all_reduce_min():
        x = torch.tensor([rank], dtype=torch.int32, device=dev)
        dist.all_reduce(x, op=dist.ReduceOp.MIN)
        return int(x) == 0

    def all_gather():
        parts = [torch.empty(4, 3, device=dev) for _ in range(world)]
        dist.all_gather(parts, torch.full((4, 3), float(rank), device=dev))
        return all(bool((p == i).all()) for i, p in enumerate(parts))

    def broadcast():
        x = torch.full((5,), float(rank + 7), device=dev)
        dist.broadcast(x, src=0)
        return bool((x == 7).all())

    def reduce_scatter_tensor():
        x = torch.arange(4 * world, dtype=torch.float32, device=dev)
        out = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(out, x)
        return bool((out == world * torch.arange(4 * rank, 4 * rank + 4, device=dev)).all())

    def scatter():
        out = torch.empty(3, device=dev)
        parts = [torch.full((3,), float(i), device=dev) for i in range(world)] if rank == 0 else None
        dist.scatter(out, parts, src=0)
        return bool((out == rank).all())

    ops = {"all_reduce": all_reduce, "all_reduce_bf16": lambda: all_reduce(torch.bfloat16),
           "all_reduce_min_int32": all_reduce_min, "all_gather": all_gather,
           "broadcast": broadcast, "reduce_scatter_tensor": reduce_scatter_tensor,
           "scatter": scatter}
    out = {}
    for name in SC_PROBE_OPS:
        try:
            out[name] = ops[name]()
        except Exception as exc:  # noqa: BLE001 - reported verbatim, and the phase fails
            out[name] = f"{type(exc).__name__}: {exc}"
    torch.cuda.synchronize()
    return out


def _sc_rank(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank of the phase: the probe, then every configuration meshed;
    writes ``rank<r>.pt``."""
    import datetime
    import faulthandler

    import torch
    import torch.distributed as dist

    from scalerl_torch.parallel.mesh import make_mesh

    faulthandler.enable()  # a crash in a collective names its Python frame
    torch.cuda.set_device(0)
    set_tf32(False)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    results: dict = {}
    try:
        results["probe"] = _sc_probe_ops(rank, world)
        if not all(v is True for v in results["probe"].values()):
            raise RuntimeError(f"gloo on CUDA tensors: {results['probe']}")
        # the ranks start up while the parent runs the one-rank steps; they
        # step only once those are done, so no two steps share the card
        deadline = time.monotonic() + SC_JOIN_S
        while not os.path.exists(os.path.join(workdir, "go")):
            if time.monotonic() > deadline:
                raise RuntimeError(f"no go from the parent in {SC_JOIN_S} s")
            time.sleep(0.05)
        for name, spec in SC_CONFIGS.items():
            print(f"shard_compute rank {rank}: {name} at {spec}", file=sys.stderr, flush=True)
            t0 = time.perf_counter()
            agent, agent._sc_batch = _sc_agent(name)
            before = _sc_flat(agent.state)
            agent.enable_mesh(make_mesh(spec, device_type="cuda"))
            results[name] = _sc_measure(agent, before)
            results[name]["shape"] = dict(agent.mesh.shape)
            results[name]["seconds"] = round(time.perf_counter() - t0, 1)
            del agent
            torch.cuda.empty_cache()
    except Exception:  # noqa: BLE001 - carried to the parent, which fails the phase
        results["error"] = traceback.format_exc()
    _sc_save(results, workdir, f"rank{rank}.pt")
    # the same world serves genrl_on_shards, serving_on_shards and
    # disagg_on_shards in turn, each after its go file; a hand-off that
    # failed ends the chain
    for run, name in ((_gs_rank, "genrl"), (_ss_rank, "serving"), (_ds_rank, "disagg")):
        if "error" in results:
            break
        try:
            results = run(workdir)
        except Exception:  # noqa: BLE001 - carried to the parent, which fails the phase
            results = {"error": traceback.format_exc()}
        _sc_save(results, workdir, f"{name}{rank}.pt")
    dist.destroy_process_group()


def _sc_save(results: dict, workdir: str, name: str) -> None:
    """``torch.save`` under a temporary name, then renamed: the parent
    waits for the name, so it never reads a half-written file."""
    import torch

    torch.save(results, os.path.join(workdir, name + ".tmp"))
    os.replace(os.path.join(workdir, name + ".tmp"), os.path.join(workdir, name))


def _sc_wait(ctx, workdir: str, names, deadline: float, what: str) -> None:
    """Wait for the ranks' result files ``names``; a rank that died or a
    deadline passed fails the phase."""
    while not all(os.path.exists(os.path.join(workdir, n)) for n in names):
        if any(p.exitcode not in (None, 0) for p in ctx.processes):
            raise AssertionError(f"{what}: a rank died: exit codes "
                                 f"{[p.exitcode for p in ctx.processes]}")
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: the ranks did not finish in time")
        time.sleep(0.1)


def _sc_kill(ctx) -> None:
    for p in ctx.processes:
        if p.is_alive():
            p.kill()


def _sc_go(workdir: str, name: str) -> None:
    """In a rank: wait for the parent's go file ``name``."""
    deadline = time.monotonic() + GS_GO_S
    while not os.path.exists(os.path.join(workdir, name)):
        if time.monotonic() > deadline:
            raise RuntimeError(f"no {name} from the parent in {GS_GO_S} s")
        time.sleep(0.05)


def phase_shard_compute(report: dict) -> None:
    """The learn step on its shards on 2 gloo ranks of the one card (see
    the constants above; multi-rank, chosen when the probe passed): the
    transformer learner at mp = 2 in bf16 and float32 (flash kernels on
    n_heads / 2 heads), token-PPO at mp = 2 (segment kernels), IMPALA's
    AtariNet at fsdp = 2 and at tp = 2 (V-trace kernel), each from one
    seed and on one global batch, against the one-rank step here: loss,
    grad norm and update (``SC_TOL``), each rank's launches per step
    (``SC_LAUNCHES``), peak memory and state bytes beside the one rank's,
    and the second step's ms.  The phase's own time: ~70 s on an H100's host
    (the IMPALA tp step ~4 s, its conv activations gathered through host
    memory); the ranks start up (spawn, CUDA, gloo, the probe) while the
    one-rank steps run here, and step after them.  The windows of earlier
    phases marked "before shard_compute" were cut to pay for part of it."""
    import tempfile

    import torch
    import torch.multiprocessing as tmp

    set_tf32(False)
    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="shard_compute_")
    ctx = tmp.start_processes(_sc_rank, args=(SC_WORLD, _free_port(), workdir),
                              nprocs=SC_WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + SC_JOIN_S
    ref, ref_s = {}, {}
    try:
        for name in SC_CONFIGS:
            t_cfg = time.perf_counter()
            agent, agent._sc_batch = _sc_agent(name)
            ref[name] = _sc_measure(agent, _sc_flat(agent.state))
            del agent
            torch.cuda.empty_cache()
            ref_s[name] = round(time.perf_counter() - t_cfg, 1)
        t1 = time.perf_counter()
        Path(workdir, "go").touch()
        _sc_wait(ctx, workdir, [f"rank{r}.pt" for r in range(SC_WORLD)], deadline,
                 "shard_compute")
        ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
                 for r in range(SC_WORLD)]
    except BaseException:
        _sc_kill(ctx)
        raise
    if any("error" in r for r in ranks):
        _sc_kill(ctx)
    else:  # the ranks wait for genrl_on_shards
        report["sc_world"] = (ctx, workdir)
    seconds = {"one_rank": round(t1 - t0, 1), "ranks_after_go": round(time.perf_counter() - t1, 1),
               "one_rank_by_config": ref_s,
               "rank0_by_config": {k: ranks[0].get(k, {}).get("seconds") for k in SC_CONFIGS}}
    print(f"shard_compute: gloo probe on cuda:0, {SC_WORLD} ranks: "
          f"{json.dumps([r.get('probe') for r in ranks])}", flush=True)
    errors = [r["error"] for r in ranks if "error" in r]
    if errors:
        raise AssertionError(f"shard_compute ranks failed: {errors[0]}")

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1.0)

    out, failed = {}, {}
    for name in SC_CONFIGS:
        one, got = ref[name], [r[name] for r in ranks]
        bf16 = "bf16" in name
        upd_one = one["after"] - one["before"]
        upd = got[0]["after"] - got[0]["before"]
        errs = {
            "loss_rel": max(rel(g["metrics"][0]["total_loss"], one["metrics"][0]["total_loss"])
                            for g in got),
            "grad_norm_rel": max(rel(g["metrics"][0]["grad_norm"],
                                     one["metrics"][0]["grad_norm"]) for g in got),
            "update_rel_l2": float((upd - upd_one).norm() / upd_one.norm()),
            "param_max_abs_err": float((got[0]["after"] - one["after"]).abs().max()),
        }
        param_ok = bool(torch.allclose(got[0]["after"], one["after"], rtol=SC_TOL["param_rtol"],
                                       atol=SC_TOL["param_atol"]))
        bounds = ({"loss_rel": SC_TOL["bf16_loss_rel"],
                   "grad_norm_rel": SC_TOL["bf16_grad_norm_rel"]} if bf16 else
                  {"loss_rel": SC_TOL["loss_rel"], "grad_norm_rel": SC_TOL["grad_norm_rel"]})
        if name == "token_ppo_mp2":
            bounds["update_rel_l2"] = SC_TOL["update_rel_l2"]
        elif name.startswith("impala"):
            bounds["update_rel_l2"] = SC_TOL["conv_update_rel_l2"]
        bad = {k: errs[k] for k, b in bounds.items() if not errs[k] <= b}
        if name == "transformer_f32_mp2" and not param_ok:
            bad["params"] = errs["param_max_abs_err"]
        ranks_agree = all(g["metrics"] == got[0]["metrics"] for g in got)
        if not ranks_agree:
            bad["ranks_disagree"] = [g["metrics"][0]["total_loss"] for g in got]
        want = SC_LAUNCHES[_sc_family(name)]
        launches = [{k: g["launches"].get(k, 0) for k in want} for g in got]
        if any(lc != want for lc in launches) or {k: one["launches"].get(k, 0)
                                                  for k in want} != want:
            bad["launches"] = launches
        if not all(g["state_bytes"] < one["state_bytes"] for g in got):
            bad["state_bytes"] = [g["state_bytes"] for g in got]
        if bad:
            failed[name] = bad
        out[name] = dict(
            mesh=SC_CONFIGS[name], **errs, params_allclose=param_ok, bounds=bounds,
            loss=[g["metrics"][0]["total_loss"] for g in got], ranks_agree=ranks_agree,
            loss_one_rank=one["metrics"][0]["total_loss"],
            launches_per_step=launches, launches_one_rank=one["launches"],
            step_peak_mb=[round(g["peak_bytes"] / 2**20, 1) for g in got],
            step_peak_mb_one_rank=round(one["peak_bytes"] / 2**20, 1),
            state_mb=[round(g["state_bytes"] / 2**20, 1) for g in got],
            state_mb_one_rank=round(one["state_bytes"] / 2**20, 1),
            ms_step2=[round(g["ms_per_step"], 2) for g in got],
            ms_step2_one_rank=round(one["ms_per_step"], 2))
    launches_on_shards = {}
    for name, o in out.items():
        for k, v in o["launches_per_step"][0].items():
            launches_on_shards[k] = launches_on_shards.get(k, 0) + v
    result = dict(world=SC_WORLD, backend="gloo", device="cuda:0 for both ranks",
                  probe=ranks[0]["probe"], configs=out, tol=SC_TOL, seconds=seconds,
                  card=report["card"])
    emit("shard_compute", **result)
    report["shard_compute"] = result
    report["launches_on_shards"] = launches_on_shards
    if failed:
        raise AssertionError(f"shard_compute: sharded steps off the one-rank step: {failed}")


# genrl_on_shards: sequence RL on shard_compute's two gloo ranks of the card
# (no second start-up), each rank on its own GEN_HEADS / 2 heads.  The
# continuous engine at the generation width for GS_MACROS macro steps at
# temperature 0 (every lane admitted at once, one macro in flight), and
# SequenceRLTrainer at the training width on the continuous engine for
# GS_ROUNDS rounds, each against the same on one rank here.  Tokens must
# be identical and logp within GEN_IDENTITY_LOGP_TOL; the trainer's first
# loss within SC_TOL's loss_rel of one rank's; the paged kernel at the
# rank's 4 heads within PAGED_TOL of its plain version
GS_MACROS = 4
GS_ROUNDS = 2
GS_GO_S = 300.0  # how long the ranks wait for the parent's one-rank runs
GS_JOIN_S = 300.0


def _gs_gen_agent():
    """A token-PPO agent on the generation width's model (seed 0), whose
    engines run its params."""
    from scalerl_torch.agents.token_ppo import TokenPPOAgent

    return TokenPPOAgent(_train_args(vocab_size=GEN_V), _gen_model("cuda"))


def _gs_decode(agent) -> dict:
    """``GS_MACROS`` macro steps of the continuous engine on ``agent``'s
    params (its rank's shards under a mesh), all lanes admitted at once, at
    temperature 0: each lane's tokens and logp, the paged launches, the
    pools' and params' bytes on this rank, ms a macro step after the first,
    the carried logits."""
    import torch

    from scalerl_torch.genrl.continuous import ContinuousEngine
    from scalerl_torch.ops import cuda_paged_attention

    meshed = agent.shard_ctx is not None
    eng = ContinuousEngine(agent.model, agent.engine_weights(),
                           _gen_config(temperature=0.0, steps_in_flight=1),
                           sync_guard=not meshed, shard_ctx=agent.shard_ctx)
    prompts, lengths = _prompts(np.random.default_rng(9), GEN_LANES)
    for i in range(GEN_LANES):
        eng.submit(prompts[i], lengths[i], tag=i)
    torch.cuda.synchronize()
    cuda_paged_attention.launches = 0
    done = eng.step()  # admission (prefill) and the first macro step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GS_MACROS - 1):
        done.extend(eng.step())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (GS_MACROS - 1)
    launches = cuda_paged_attention.launches
    tokens = {c.tag: (c.response_tokens, c.behavior_logp) for c in done}
    for lane in eng._lanes:
        if lane.busy:
            tokens[lane.tag] = (np.concatenate(lane.tokens), np.concatenate(lane.logps))
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    params, _ = eng._snapshot_params()
    return dict(tokens=tokens, launches=launches, macros=eng.macro_steps, ms_per_macro=ms,
                pool_bytes=nbytes([*eng._pools.k, *eng._pools.v]),
                param_bytes=nbytes(params.values()), pool_shape=list(eng._pools.k[0].shape),
                logits=eng._logits_st.cpu(), completed=len(done))


def _gs_train_args():
    return _train_args(genrl_engine="continuous", genrl_page_size=GEN_PAGE,
                       genrl_macro_steps=GEN_MACRO)


def _gs_train(agent) -> dict:
    """``GS_ROUNDS`` rounds of ``SequenceRLTrainer`` on ``agent`` from cold,
    every launch count zeroed just before: each round's metrics and
    inserted tokens, the launches, rounds/s, peak memory."""
    import torch

    from scalerl_torch.genrl.task import TokenRecallTask
    from scalerl_torch.trainer import sequence_rl

    tokens = []
    real_add = sequence_rl.seq_add

    def recording(state, fields, core, priorities):
        tokens.append(fields["tokens"].clone())  # read after the rounds: no sync here
        return real_add(state, fields, core, priorities)

    task = TokenRecallTask(vocab_size=TRAIN_V, prompt_len=(2, TRAIN_P), response_len=TRAIN_R)
    trainer = sequence_rl.SequenceRLTrainer(_gs_train_args(), task=task, agent=agent)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    sequence_rl.seq_add = recording
    _zero_launch_counts()
    try:
        t0 = time.perf_counter()
        metrics = [trainer.train_round() for _ in range(GS_ROUNDS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sequence_rl.seq_add = real_add
    return dict(metrics=metrics, tokens=[t.cpu() for t in tokens], launches=_launch_counts(),
                seconds=wall,
                rounds_per_s=GS_ROUNDS / wall,
                peak_bytes=torch.cuda.max_memory_allocated() - held, held_bytes=held,
                pool_heads=trainer.engine._run.heads)


def _gs_rank(workdir: str) -> dict:
    """One rank of ``genrl_on_shards``: waits for the parent's go, then the
    engine and the trainer on a mesh of ``mp = SC_WORLD``."""
    import torch

    from scalerl_torch.agents.token_ppo import TokenPPOAgent
    from scalerl_torch.parallel.mesh import make_mesh
    from scalerl_torch.trainer.sequence_rl import build_genrl_model

    _sc_go(workdir, "go_genrl")
    mesh = make_mesh(f"mp={SC_WORLD}", device_type="cuda")
    agent = _gs_gen_agent()
    agent.enable_mesh(mesh)
    out = {"decode": _gs_decode(agent)}
    del agent
    torch.cuda.empty_cache()
    agent = TokenPPOAgent(_gs_train_args(), build_genrl_model(_gs_train_args()))
    agent.enable_mesh(mesh)
    out["train"] = _gs_train(agent)
    return out


def _paged_main_lengths():
    """The lanes' lengths of row 6's timing (``paged_attn``'s main case)."""
    import torch

    M, ps = GEN_PAGES_PER_LANE, GEN_PAGE
    g = torch.Generator().manual_seed(11)
    lengths = torch.randint(1, M * ps + 1, (GEN_LANES,), generator=g)
    lengths[0], lengths[1], lengths[2] = M * ps, 1, 17
    return lengths


def phase_genrl_on_shards(report: dict) -> None:
    """Sequence RL on shard_compute's world (constants above): the paged
    kernel at a rank's ``[256, 1, 4, 32]`` against ``[6145, 16, 4, 32]``
    pools, checked and timed here; the continuous engine and the trainer on
    one rank here; then the go, and the same on 2 ranks at ``mp = 2``.
    Each rank's tokens, logp and loss against one rank's, the ranks'
    carried logits bit-equal, paged launches per rank equal to one rank's
    (64 a macro step), segment 4 and PER sample 1 a learn step, pool and
    param bytes per rank beside one rank's, rounds/s and peak memory."""
    import torch

    from scalerl_torch.agents.token_ppo import TokenPPOAgent
    from scalerl_torch.ops import cuda_paged_attention
    from scalerl_torch.ops.paged_attention import paged_attention_reference
    from scalerl_torch.trainer.sequence_rl import build_genrl_model

    if "sc_world" not in report:
        raise AssertionError("genrl_on_shards runs on shard_compute's ranks, which are gone")
    # the ranks stay for serving_on_shards; a phase that fails ends them
    # (main)
    ctx, workdir = report["sc_world"]
    set_tf32(False)
    t0 = time.perf_counter()
    # the kernel on a rank's heads, alone on the card
    H = GEN_HEADS // SC_WORLD
    lengths = _paged_main_lengths()
    inp = _paged_case(GEN_LANES, H, GEN_D // GEN_HEADS, GEN_PAGE, GEN_PAGES_PER_LANE,
                      GEN_NUM_PAGES, lengths, seed=12, dtype=torch.float32, shared=8)
    got = cuda_paged_attention.paged_decode_attention(**inp)
    want = paged_attention_reference(**inp)
    err = (got - want).abs().max().item()
    gather_sdpa = _paged_gather_sdpa(inp)
    kernel = dict(shape=list(inp["q"].shape), pools=list(inp["k_pages"].shape),
                  max_abs_err=err, tol=PAGED_TOL,
                  **_paged_timing(inp, lengths, with_plain=True),
                  library_ms=gpu_time_ms(gather_sdpa, 20),
                  library_max_abs_err=(gather_sdpa() - want).abs().max().item())
    one = {"decode": _gs_decode(_gs_gen_agent())}
    torch.cuda.empty_cache()
    one["train"] = _gs_train(TokenPPOAgent(_gs_train_args(),
                                           build_genrl_model(_gs_train_args())))
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    Path(workdir, "go_genrl").touch()
    _sc_wait(ctx, workdir, [f"genrl{r}.pt" for r in range(SC_WORLD)],
             time.monotonic() + GS_JOIN_S, "genrl_on_shards")
    ranks = [torch.load(os.path.join(workdir, f"genrl{r}.pt"), weights_only=False)
             for r in range(SC_WORLD)]
    errors = [r["error"] for r in ranks if "error" in r]
    if errors:
        raise AssertionError(f"genrl_on_shards ranks failed: {errors[0]}")
    failed = {}
    if not err <= PAGED_TOL:
        failed["paged_kernel"] = err

    # the engine
    d1, dr = one["decode"], [r["decode"] for r in ranks]
    mismatched = [sum(not np.array_equal(d["tokens"][i][0], d1["tokens"][i][0])
                      for i in d1["tokens"]) for d in dr]
    logp_err = max((float(np.abs(d["tokens"][i][1] - d1["tokens"][i][1]).max())
                    for d in dr for i in d1["tokens"]
                    if np.array_equal(d["tokens"][i][0], d1["tokens"][i][0])
                    and len(d1["tokens"][i][1])), default=0.0)
    logits_equal = all(torch.equal(d["logits"], dr[0]["logits"]) for d in dr)
    want_launches = GEN_MACRO * GEN_LAYERS * GS_MACROS
    decode = dict(
        macros=GS_MACROS, lanes=GEN_LANES, mismatched_lanes=mismatched, logp_max_abs_err=logp_err,
        logp_tol=GEN_IDENTITY_LOGP_TOL, ranks_logits_bit_equal=logits_equal,
        paged_launches=[d["launches"] for d in dr], paged_launches_one_rank=d1["launches"],
        pool_shape=[d["pool_shape"] for d in dr], pool_shape_one_rank=d1["pool_shape"],
        pool_mb=[round(d["pool_bytes"] / 2**20, 1) for d in dr],
        pool_mb_one_rank=round(d1["pool_bytes"] / 2**20, 1),
        pool_share=[d["pool_bytes"] / d1["pool_bytes"] for d in dr],
        param_mb=[round(d["param_bytes"] / 2**20, 2) for d in dr],
        param_mb_one_rank=round(d1["param_bytes"] / 2**20, 2),
        ms_per_macro=[round(d["ms_per_macro"], 2) for d in dr],
        ms_per_macro_one_rank=round(d1["ms_per_macro"], 2),
        completed=[d["completed"] for d in dr])
    if any(mismatched) or not logp_err <= GEN_IDENTITY_LOGP_TOL or not logits_equal:
        failed["decode"] = dict(mismatched=mismatched, logp=logp_err, logits_equal=logits_equal)
    if any(d["launches"] != want_launches for d in dr + [d1]):
        failed["paged_launches"] = decode["paged_launches"] + [d1["launches"]]
    if any(d["pool_shape"][2] != H for d in dr):
        failed["pool_heads"] = decode["pool_shape"]

    # the trainer
    t1r, tr = one["train"], [r["train"] for r in ranks]
    same_tokens = all(torch.equal(a, b) for t in tr for a, b in zip(t["tokens"][:1],
                                                                    t1r["tokens"][:1]))
    loss1 = t1r["metrics"][0]["total_loss"]
    loss_rel = max(abs(t["metrics"][0]["total_loss"] - loss1) / max(abs(loss1), 1.0) for t in tr)
    want = {k: TRAIN_LAYERS * GS_ROUNDS for k in ("segment_attention_fwd",
                                                   "segment_attention_bwd_dq",
                                                   "segment_attention_bwd_dkv")}
    want["per_sample"] = GS_ROUNDS
    launches = [{k: t["launches"][k] for k in (*want, "paged_attention")} for t in tr]
    train = dict(
        rounds=GS_ROUNDS, round1_tokens_equal=same_tokens, loss_rel=loss_rel,
        loss_tol=SC_TOL["loss_rel"], loss=[t["metrics"][0]["total_loss"] for t in tr],
        loss_one_rank=loss1, ranks_agree=all(t["metrics"] == tr[0]["metrics"] for t in tr),
        launches=launches, launches_one_rank={k: t1r["launches"][k]
                                              for k in (*want, "paged_attention")},
        rounds_per_s=[round(t["rounds_per_s"], 3) for t in tr],
        rounds_per_s_one_rank=round(t1r["rounds_per_s"], 3),
        peak_mb=[round(t["peak_bytes"] / 2**20, 1) for t in tr],
        peak_mb_one_rank=round(t1r["peak_bytes"] / 2**20, 1),
        held_mb=[round(t["held_bytes"] / 2**20, 1) for t in tr],
        held_mb_one_rank=round(t1r["held_bytes"] / 2**20, 1),
        pool_heads=[t["pool_heads"] for t in tr],
        skipped_steps=[sum(m["skipped_steps"] for m in t["metrics"]) for t in tr])
    if not same_tokens or not loss_rel <= SC_TOL["loss_rel"] or not train["ranks_agree"]:
        failed["train"] = dict(tokens_equal=same_tokens, loss_rel=loss_rel,
                               ranks_agree=train["ranks_agree"])
    if any({k: lc[k] for k in want} != want for lc in launches) or any(
            lc["paged_attention"] != t1r["launches"]["paged_attention"] for lc in launches):
        failed["train_launches"] = launches
    if any(train["skipped_steps"]) or any(h != H for h in train["pool_heads"]):
        failed["train_steps"] = dict(skipped=train["skipped_steps"], heads=train["pool_heads"])
    report["paged_attention_heads_on_rank"] = kernel
    report["launches_genrl_on_shards"] = {
        **launches[0], "paged_attention": dr[0]["launches"] + launches[0]["paged_attention"]}
    emit("genrl_on_shards", world=SC_WORLD, backend="gloo", device="cuda:0 for both ranks",
         heads_per_rank=H, kernel=kernel, decode=decode, train=train,
         seconds={"one_rank": round(t1 - t0, 1), "ranks_after_go": round(
             time.perf_counter() - t1, 1)}, card=report["card"])
    if failed:
        raise AssertionError(f"genrl_on_shards: {failed}")


# serving_on_shards: the serving trainer (actor_mode="serving") with its
# learner at mp = SC_WORLD, on shard_compute's ranks (a third hand-off on
# that world: the ranks wait for a go_serving file).  RLArguments' own
# transformer widths (d_model 128, 2 layers, 4 heads: 2 a rank) with the
# flash kernels, the port's CartPole (TensorCartPole on the host behind
# TensorVectorView), SS_ACTORS actors of SS_ENVS lanes a rank and
# SS_LEARN_STEPS learn steps.  T is ImpalaArguments' 80 cut to SS_T (the
# CartPole recipe's 16): each act is a lockstep flush of gloo collectives,
# so a learn step waits for T of them.  Then a new server on each rank's
# trained agent flushes one fixed batch (SS_REQUEST_LANES: each rank's own
# requests, pooled in rank order), held against a one-rank server at the
# gathered weights here: logits within SS_TOL (two matmul splits apart),
# bit-equal across the ranks
SS_ENVS, SS_ACTORS, SS_T, SS_LEARN_STEPS = 2, 4, 16, 3
SS_REQUEST_LANES = ((3, 1), (2,))  # 6 lanes pooled, bucket 8
SS_TOL = 1e-5
SS_JOIN_S = 300.0


def _ss_args(**kw):
    from scalerl_torch.config import ImpalaArguments

    base = dict(env_id="CartPole-v1", policy_arch="transformer", use_pallas=True,
                use_lstm=False, num_actors=SS_ACTORS, batch_size=SS_ACTORS * SS_ENVS,
                rollout_length=SS_T, actor_mode="serving", logger_backend="none",
                logger_frequency=10**9, telemetry_interval_s=0.0, save_model=False)
    return ImpalaArguments(**{**base, **kw})


def _ss_requests(rank: int) -> list:
    """Rank ``rank``'s fixed act requests: (id, payload) pairs."""
    rng = np.random.default_rng(30 + rank)
    return [(10 * rank + i, {"obs": rng.normal(size=(n, 4)).astype(np.float32),
                             "last_action": rng.integers(0, 2, n).astype(np.int32),
                             "reward": rng.normal(size=n).astype(np.float32),
                             "done": rng.uniform(size=n) < 0.3, "core": ()})
            for i, n in enumerate(SS_REQUEST_LANES[rank])]


def _ss_fixed_flush(agent, args, rank: int) -> dict:
    """A new server on ``agent`` flushes this rank's fixed requests in one
    lockstep tick: the pooled inputs, logits and actions of the bucket, and
    the replies."""
    import torch

    from scalerl_torch.serving import InferenceServer, ServingConfig, local_pair

    server = InferenceServer(agent, ServingConfig.from_args(args))
    pooled = {}
    serve = server._serve

    def recording(params, obs, last_action, reward, done, core):
        action, logits, new_core = serve(params, obs, last_action, reward, done, core)
        pooled.update(obs=obs.cpu(), last_action=last_action.cpu(), reward=reward.cpu(),
                      done=done.cpu(), logits=logits.cpu(), action=action.cpu())
        return action, logits, new_core

    server._serve = recording
    c_end, s_end = local_pair()
    server.hub.add_connection(s_end)
    mine = _ss_requests(rank)
    try:
        for req_id, payload in mine:
            server._admit(s_end, {"kind": "act", "req": req_id, **payload})
        time.sleep(2 * server.config.max_wait_s)  # every request of the rank due
        offered = server.batcher.ready()
        if len(offered) != len(mine) or server._tick(offered) != "flushed":
            raise AssertionError(f"rank {rank}: the fixed batch's tick did not flush "
                                 f"({len(offered)} of {len(mine)} requests offered)")
        torch.cuda.synchronize()
        replies = [c_end.recv(timeout=20.0) for _ in mine]
    finally:
        server.hub.close()
    return dict(pooled=pooled, replies=replies)


def _ss_rank(workdir: str) -> dict:
    """One rank of ``serving_on_shards``: the serving trainer on a mesh of
    ``mp = SC_WORLD`` for ``SS_LEARN_STEPS`` learn steps, every launch
    count zeroed just before and read once its server and actors stopped
    (each flash forward's heads and thread recorded), then the fixed
    batch."""
    import threading

    import torch
    import torch.distributed as dist

    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.envs.gym_env import TensorVectorView
    from scalerl_torch.envs.tensor_envs import TensorCartPole
    from scalerl_torch.ops import cuda_flash_attention
    from scalerl_torch.parallel.mesh import make_mesh
    from scalerl_torch.parallel.sharding import to_local
    from scalerl_torch.runtime import telemetry
    from scalerl_torch.trainer.actor_learner import HostActorLearnerTrainer

    _sc_go(workdir, "go_serving")
    rank = dist.get_rank()
    set_tf32(False)
    args = _ss_args(work_dir=_work_dir(f"serving_on_shards_{rank}"))
    agent = ImpalaAgent(args, (4,), 2)
    agent.enable_mesh(make_mesh(f"mp={SC_WORLD}", device_type="cuda"))
    fns = [lambda: TensorVectorView(TensorCartPole(SS_ENVS, device="cpu"))
           for _ in range(SS_ACTORS)]
    reg = telemetry.get_registry()
    fallbacks0 = reg.counter("serving_client.fallbacks").value
    trainer = HostActorLearnerTrainer(args, agent, fns, run_name="serving_on_shards")
    server = trainer.inference_server
    learner_thread = threading.current_thread().name
    flash = {}  # (thread kind, heads) -> forward launches
    real_fwd = cuda_flash_attention.flash_forward_kernel

    def fwd(q, *a, **kw):
        name = threading.current_thread().name
        kind = ("flush" if name == "serve-flush" else "learner" if name == learner_thread
                else "other")
        flash[(kind, int(q.shape[2]))] = flash.get((kind, int(q.shape[2])), 0) + 1
        return real_fwd(q, *a, **kw)

    learn = agent.learn_device

    def learn_device(traj):
        metrics = learn(traj)
        if trainer.learn_steps + 1 >= SS_LEARN_STEPS:  # every rank stops at the same step
            trainer.stop_event.set()
        return metrics

    agent.learn_device = learn_device
    cuda_flash_attention.flash_forward_kernel = fwd
    torch.cuda.synchronize()
    _zero_launch_counts()
    t0 = time.perf_counter()
    try:
        result = trainer.train(total_frames=10**9)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        trainer.close()
        cuda_flash_attention.flash_forward_kernel = real_fwd
    launches = _launch_counts()
    full = agent.get_weights()
    out = dict(
        learn_steps=trainer.learn_steps, seconds=wall, flushes=server.flushes,
        answered=server.answered, requests_per_s=server.answered / wall,
        flushes_per_s=server.flushes / wall, generation=server.generation,
        accounting=server.accounting(), puts=server.device_puts, gets=server.device_gets,
        launches=launches, flash_fwd_by_thread_heads=flash,
        fallbacks=reg.counter("serving_client.fallbacks").value - fallbacks0,
        loss=result.get("total_loss"), skipped_steps=result.get("skipped_steps"),
        served={k: (list(v.shape), list(full[k].shape)) for k, v in server._params.items()},
        served_bytes=sum(v.numel() * v.element_size() for v in server._params.values()),
        whole_bytes=sum(v.numel() * v.element_size() for v in full.values()),
        shards_are_live=all(torch.equal(server._params[k], to_local(v))
                            for k, v in agent.state.params.items()),
        threads_alive=[t.name for t in server._threads if t.is_alive()])
    out["fixed"] = _ss_fixed_flush(agent, args, rank)
    if rank == 0:
        out["weights"] = {k: v.cpu() for k, v in full.items()}
    del trainer, agent
    torch.cuda.empty_cache()
    return out


def phase_serving_on_shards(report: dict) -> None:
    """The inference server on the learner's mp shards, on shard_compute's
    ranks (constants above): the go, then the serving trainer at mp = 2 on
    each rank and the fixed batch; here a one-rank server at rank 0's
    gathered weights on the same pooled inputs.  Checks: a rank serves 1/2
    of each mp leaf and the live shards of the last push (a generation a
    learn step); the fixed batch's logits bit-equal across the ranks and
    within ``SS_TOL`` of the one-rank server's, actions equal across the
    ranks; the flash forward on each rank's 2 heads, 2 a flush on the flush
    thread and 2 a learn step on the learner's, backward 2 and V-trace 1 a
    learn step; no fallback, every request answered, finite losses.
    Flushes/s and requests/s beside the unmeshed ``impala_serving``'s."""
    import torch

    from scalerl_torch.agents.impala import ImpalaAgent
    from scalerl_torch.serving import InferenceServer, ServingConfig

    if "sc_world" not in report:
        raise AssertionError("serving_on_shards runs on shard_compute's ranks, which are gone")
    ctx, workdir = report["sc_world"]
    set_tf32(False)
    t0 = time.perf_counter()
    Path(workdir, "go_serving").touch()
    _sc_wait(ctx, workdir, [f"serving{r}.pt" for r in range(SC_WORLD)],
             time.monotonic() + SS_JOIN_S, "serving_on_shards")
    ranks = [torch.load(os.path.join(workdir, f"serving{r}.pt"), weights_only=False)
             for r in range(SC_WORLD)]
    t1 = time.perf_counter()
    errors = [r["error"] for r in ranks if "error" in r]
    if errors:
        raise AssertionError(f"serving_on_shards ranks failed: {errors[0]}")
    args = _ss_args(work_dir=_work_dir("serving_on_shards"))
    agent = ImpalaAgent(args, (4,), 2)
    agent.set_weights({k: v.cuda() for k, v in ranks[0]["weights"].items()})
    one = InferenceServer(agent, ServingConfig.from_args(args))
    pooled = ranks[0]["fixed"]["pooled"]
    params, _ = one._snapshot_params()
    with torch.no_grad():
        action1, logits1, _ = one._serve(params, *(pooled[k].cuda() for k in (
            "obs", "last_action", "reward", "done")), ())
    torch.cuda.synchronize()
    logits_err = (logits1.cpu() - pooled["logits"]).abs().max().item()
    one_bytes = sum(v.numel() * v.element_size() for v in params.values())

    L, H = args.n_layers, args.n_heads // SC_WORLD
    failed = {}
    for r, got in enumerate(ranks):
        n, flushes = got["learn_steps"], got["flushes"]
        sharded = {k: s for k, s in got["served"].items() if s[0] != s[1]}
        halves = all(SC_WORLD * math.prod(s[0]) == math.prod(s[1]) for s in sharded.values())
        fl = got["flash_fwd_by_thread_heads"]
        lc = got["launches"]
        acc = got["accounting"]
        checks = {
            "learn steps": n == SS_LEARN_STEPS,
            "half of each mp leaf": len(sharded) >= 4 and halves,
            "serves the live shards": got["shards_are_live"] and got["generation"] == n,
            "flash fwd on the flush thread, 2 heads": fl.get(("flush", H), 0) == L * flushes > 0
            and not any(k[0] == "flush" and k[1] != H for k in fl),
            "flash fwd on the learner, 2 heads": fl.get(("learner", H), 0) == L * n
            and not any(k[0] == "learner" and k[1] != H for k in fl),
            "flash bwd, V-trace a learn step": (lc["flash_attention_bwd_dq"],
                                                lc["flash_attention_bwd_dkv"],
                                                lc["vtrace"]) == (L * n, L * n, n),
            "one put and one get a flush": got["puts"] == got["gets"] == flushes,
            "no fallback": got["fallbacks"] == 0,
            "every request answered": acc["balanced"] and acc["errors"] == 0
            and acc["pending"] == 0 and acc["answered"] > 0,
            "finite loss, no skipped step": got["loss"] is not None
            and math.isfinite(got["loss"]) and got["skipped_steps"] == 0.0,
            "threads stopped": not got["threads_alive"],
        }
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            failed[f"rank{r}"] = bad
    fixed = [g["fixed"]["pooled"] for g in ranks]
    ranks_equal = all(torch.equal(f["logits"], fixed[0]["logits"])
                      and torch.equal(f["action"], fixed[0]["action"]) for f in fixed)
    if not ranks_equal:
        failed["fixed_batch_ranks_equal"] = False
    if not logits_err <= SS_TOL:
        failed["fixed_batch_logits_err"] = logits_err
    report["launches_serving_on_shards"] = ranks[0]["launches"]
    ref = report.get("impala_serving", {})
    emit("serving_on_shards", world=SC_WORLD, backend="gloo", device="cuda:0 for both ranks",
         d_model=args.d_model, layers=L, heads=args.n_heads, heads_per_rank=H, T=SS_T,
         actors=SS_ACTORS, lanes_per_actor=SS_ENVS, learn_steps=[g["learn_steps"] for g in ranks],
         flushes=[g["flushes"] for g in ranks],
         flushes_per_s=[round(g["flushes_per_s"], 2) for g in ranks],
         requests_per_s=[round(g["requests_per_s"], 2) for g in ranks],
         seconds=[round(g["seconds"], 2) for g in ranks],
         impala_serving_unmeshed=ref,
         served_mb=[round(g["served_bytes"] / 2**20, 4) for g in ranks],
         served_mb_one_rank=round(one_bytes / 2**20, 4),
         sharded_leaves=sum(s[0] != s[1] for s in ranks[0]["served"].values()),
         flash_fwd_by_thread_heads=[{f"{k[0]}/{k[1]}": v for k, v in g[
             "flash_fwd_by_thread_heads"].items()} for g in ranks],
         launches=[{k: v for k, v in g["launches"].items() if v} for g in ranks],
         fixed_lanes=SS_REQUEST_LANES, fixed_logits_max_abs_err=logits_err, tol=SS_TOL,
         fixed_ranks_bit_equal=ranks_equal,
         fixed_actions_equal_one_rank=bool(torch.equal(action1.cpu(), pooled["action"])),
         losses=[g["loss"] for g in ranks], accounting=[g["accounting"] for g in ranks],
         phase_seconds={"ranks": round(t1 - t0, 1), "here": round(time.perf_counter() - t1, 1)},
         card=report["card"])
    del one, agent
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"serving_on_shards: {failed}")


# disagg_on_shards: DisaggSequenceRLTrainer at the training width at mp =
# SC_WORLD on the same ranks (the fourth hand-off, go_disagg).  Rank 0 owns
# the fleet: disagg_train's continuous configuration (2 thread hosts of 32
# lanes, int8 snapshots); every rank learns its rows of each round's batch.
# GS_ROUNDS rounds from cold, the lease cursor stopped at their GS_ROUNDS *
# TRAIN_B sequences so every lease issued is accounted for (lost = issued -
# received once).  Round 1's loss against one rank's learn step on the same
# sequences here (SC_TOL's loss_rel)
DS_JOIN_S = 300.0


def _ds_args():
    return _train_args(disagg_hosts=2, genrl_engine="continuous", genrl_page_size=GEN_PAGE,
                       genrl_macro_steps=GEN_MACRO)


def _ds_rank(workdir: str) -> dict:
    """One rank of ``disagg_on_shards``: the trainer on a mesh of ``mp =
    SC_WORLD`` for ``GS_ROUNDS`` rounds from cold, every launch count zeroed
    before it is built (its hosts start decoding at once) and read after
    its hosts joined; each round's learn batch, the metrics, the accounting
    of the leases, rounds/s and the peak memory of the rank's process."""
    import torch
    import torch.distributed as dist

    from scalerl_torch.agents.token_ppo import TokenPPOAgent
    from scalerl_torch.parallel.mesh import make_mesh
    from scalerl_torch.trainer.sequence_rl import DisaggSequenceRLTrainer, build_genrl_model

    class Trainer(_Budgeted, DisaggSequenceRLTrainer):
        budget = GS_ROUNDS * TRAIN_B

    _sc_go(workdir, "go_disagg")
    set_tf32(False)
    args = _ds_args()
    agent = TokenPPOAgent(args, build_genrl_model(args))
    agent.enable_mesh(make_mesh(f"mp={SC_WORLD}", device_type="cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _zero_launch_counts()
    t0 = time.perf_counter()
    trainer = Trainer(args, task=_disagg_task(), agent=agent)
    seen: list = []  # the lease id of every sequence rank 0 takes
    if trainer.owns_fleet:
        get_sequence = trainer.learner.get_sequence

        def taking(timeout=None):
            s = get_sequence(timeout=timeout)
            if s is not None:
                seen.append(s["lease_id"])
            return s

        trainer.learner.get_sequence = taking
    batches = []
    learn_from = trainer._learn_from

    def recording(fields, priorities, guard=None):
        batches.append(({k: np.array(v) for k, v in fields.items()}, np.array(priorities)))
        return learn_from(fields, priorities, guard)

    trainer._learn_from = recording
    try:
        t1 = time.perf_counter()
        metrics = [trainer.train_round() for _ in range(GS_ROUNDS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    finally:
        trainer.close()
    if trainer.owns_fleet:
        _join_hosts(trainer, "disagg_on_shards")
    launches = _launch_counts()
    out = dict(metrics=metrics, batch=batches[0], launches=launches, rounds_per_s=GS_ROUNDS / wall,
               seconds=wall, build_s=t1 - t0, owns_fleet=trainer.owns_fleet,
               has_learner=trainer.learner is not None, has_fleet=trainer.fleet is not None,
               peak_bytes=torch.cuda.max_memory_allocated() - held, held_bytes=held,
               rank=dist.get_rank(), learn_steps=trainer.learn_steps)
    if trainer.owns_fleet:
        ids = seen
        out.update(issued=trainer._lease_seq, received=len(ids), unique=len(set(ids)),
                   lost=trainer._lease_seq - len(set(ids)) + trainer.learner.dropped_sequences,
                   duplicates=len(ids) - len(set(ids)),
                   quantize=trainer.config.snapshot_quantize,
                   snapshot_mb=trainer.learner.snapshot_wire_bytes / 2**20,
                   generation=trainer.learner.generation)
    del trainer, agent
    torch.cuda.empty_cache()
    return out


def phase_disagg_on_shards(report: dict) -> None:
    """``DisaggSequenceRLTrainer`` across shard_compute's ranks (constants
    above): the go, then ``GS_ROUNDS`` rounds at mp = 2 with rank 0's hosts;
    here one rank's learn step on round 1's sequences.  Checks: round 1's
    loss within ``SC_TOL``'s loss_rel of one rank's, the ranks' metrics
    bit-equal, segment 4/4/4 and PER sample 1 a learn step on each rank,
    paged launches on rank 0 (its hosts) and none on rank 1, rank 0 alone
    owning the fleet, int8 snapshots, lost = 0 and no duplicate, finite
    losses and no skipped step.  Rounds/s and a round's peak memory per
    rank beside one rank's ``disagg_train`` (continuous); the last
    hand-off, so the ranks are joined here."""
    import torch

    from scalerl_torch.trainer.sequence_rl import _LearnHalf
    from scalerl_torch.utils.buckets import bucket_for, default_buckets

    class OneRank(_LearnHalf):
        """The disaggregated trainer's learn half on this process's card."""

        def __init__(self, args):
            self._init_agent(args, _disagg_task(), None, "cuda")
            self._init_replay(bucket_for(args.prompt_len, default_buckets(args.prompt_len)),
                              bucket_for(args.max_new_tokens,
                                         default_buckets(args.max_new_tokens)))

    if "sc_world" not in report:
        raise AssertionError("disagg_on_shards runs on shard_compute's ranks, which are gone")
    ctx, workdir = report.pop("sc_world")
    set_tf32(False)
    t0 = time.perf_counter()
    try:
        Path(workdir, "go_disagg").touch()
        _sc_wait(ctx, workdir, [f"disagg{r}.pt" for r in range(SC_WORLD)],
                 time.monotonic() + DS_JOIN_S, "disagg_on_shards")
        ranks = [torch.load(os.path.join(workdir, f"disagg{r}.pt"), weights_only=False)
                 for r in range(SC_WORLD)]
        ctx.join(timeout=60)
    finally:
        _sc_kill(ctx)
    t1 = time.perf_counter()
    errors = [r["error"] for r in ranks if "error" in r]
    if errors:
        raise AssertionError(f"disagg_on_shards ranks failed: {errors[0]}")
    fields, priorities = ranks[0]["batch"]
    one = OneRank(_ds_args())
    metrics1, _ = one._learn_from(fields, priorities)
    del one
    torch.cuda.empty_cache()
    loss1 = metrics1["total_loss"]
    loss_rel = max(abs(g["metrics"][0]["total_loss"] - loss1) / max(abs(loss1), 1.0)
                   for g in ranks)
    want = {k: TRAIN_LAYERS * GS_ROUNDS for k in ("segment_attention_fwd",
                                                   "segment_attention_bwd_dq",
                                                   "segment_attention_bwd_dkv")}
    want["per_sample"] = GS_ROUNDS
    first = ranks[0]
    failed = {}
    if not loss_rel <= SC_TOL["loss_rel"]:
        failed["loss_rel"] = loss_rel
    if not all(g["metrics"] == first["metrics"] for g in ranks):
        failed["ranks_disagree"] = [[m["total_loss"] for m in g["metrics"]] for g in ranks]
    launches = [g["launches"] for g in ranks]
    if any({k: lc[k] for k in want} != want for lc in launches):
        failed["learn_launches"] = [{k: lc[k] for k in want} for lc in launches]
    if launches[0]["paged_attention"] <= 0 or any(lc["paged_attention"] for lc in launches[1:]):
        failed["paged_launches"] = [lc["paged_attention"] for lc in launches]
    if not (first["owns_fleet"] and first["has_learner"] and first["has_fleet"]) or any(
            g["owns_fleet"] or g["has_learner"] or g["has_fleet"] for g in ranks[1:]):
        failed["fleet_owner"] = [(g["owns_fleet"], g["has_learner"], g["has_fleet"])
                                 for g in ranks]
    if first["lost"] or first["duplicates"] or first["issued"] != GS_ROUNDS * TRAIN_B:
        failed["accounting"] = {k: first[k] for k in ("issued", "received", "unique", "lost",
                                                      "duplicates")}
    if first["quantize"] != "int8":
        failed["quantize"] = first["quantize"]
    steps = [m for g in ranks for m in g["metrics"]]
    if not all(math.isfinite(m["total_loss"]) for m in steps) or any(
            m["skipped_steps"] for m in steps):
        failed["steps"] = [(m["total_loss"], m["skipped_steps"]) for m in steps]
    report["launches_disagg_on_shards"] = launches[0]
    cont = report.get("disagg_train_continuous", {})
    emit("disagg_on_shards", world=SC_WORLD, backend="gloo", device="cuda:0 for both ranks",
         heads_per_rank=TRAIN_HEADS // SC_WORLD, hosts_on_rank0=2,
         lanes_per_host=TRAIN_B // 2, rounds=GS_ROUNDS, quantize=first["quantize"],
         snapshot_mb=first["snapshot_mb"], generation=first["generation"],
         loss=[g["metrics"][0]["total_loss"] for g in ranks], loss_one_rank=loss1,
         loss_rel=loss_rel, loss_tol=SC_TOL["loss_rel"],
         launches=[{k: v for k, v in lc.items() if v} for lc in launches],
         accounting={k: first[k] for k in ("issued", "received", "unique", "lost",
                                           "duplicates")},
         rounds_per_s=[round(g["rounds_per_s"], 3) for g in ranks],
         rounds_per_s_one_rank_disagg_train=cont.get("rounds_per_s"),
         peak_mb=[round(g["peak_bytes"] / 2**20, 1) for g in ranks],
         peak_mb_one_rank_disagg_train=(round(cont["peak_mem_gib"] * 1024, 1)
                                        if "peak_mem_gib" in cont else None),
         build_s=[round(g["build_s"], 2) for g in ranks],
         phase_seconds={"ranks": round(t1 - t0, 1), "here": round(time.perf_counter() - t1, 1)},
         card=report["card"])
    if failed:
        raise AssertionError(f"disagg_on_shards: {failed}")


PHASES = [phase_device, phase_build, phase_vtrace, phase_model, phase_impala_learn,
          phase_impala_fused, phase_impala_lstm_learn, phase_impala_lstm_fused,
          phase_impala_anakin, phase_learn_synthetic, phase_learn_catch, phase_learn_recall,
          phase_per_kernels, phase_dqn_learn, phase_dqn_per, phase_kernels_built,
          phase_paged_attn, phase_genrl_model, phase_genrl_decode, phase_genrl_continuous,
          phase_segment_attn, phase_token_ppo_learn, phase_genrl_train, phase_flash_attn,
          phase_transformer_learn, phase_transformer_train, phase_flash_train_step,
          phase_mesh_learn,
          phase_impala_trainer_device, phase_impala_trainer_host, phase_learn_cartpole_host,
          phase_dqn_resume, phase_dqn_rainbow_learn, phase_apex_train, phase_r2d2_device,
          phase_learn_r2d2_recall_device, phase_r2d2_host, phase_mesh_replay,
          phase_mesh_loops, phase_moe_impala, phase_parallel_families, phase_shm_ring,
          phase_parallel_dqn, phase_process_impala, phase_impact_learn, phase_impact_train,
          phase_onpolicy_train, phase_continuous_learn, phase_continuous_train,
          phase_serving_flush, phase_impala_serving, phase_serving_traffic,
          phase_fleet_impala, phase_fleet_elastic, phase_a3c_fleet, phase_marl_dqn,
          phase_fleet_dqn, phase_genrl_spec, phase_quantize_push, phase_disagg_train,
          phase_disagg_soak, phase_disagg_preempt, phase_shard_compute,
          phase_genrl_on_shards, phase_serving_on_shards, phase_disagg_on_shards]


def main() -> int:
    report: dict = {}
    seconds: dict = {}
    t_all = time.perf_counter()
    for phase in PHASES:
        name = phase.__name__[len("phase_"):]
        t_phase = time.perf_counter()
        try:
            phase(report)
        except Exception as exc:  # noqa: BLE001 — report the phase and fail
            traceback.print_exc()
            emit(name, ok=False, error=f"{type(exc).__name__}: {exc}")
            if "sc_world" in report:  # ranks left waiting for genrl_on_shards
                _sc_kill(report["sc_world"][0])
            return 1
        seconds[name] = round(time.perf_counter() - t_phase, 1)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "scalerl_tpu"))
    if leaked:
        emit("isolation", ok=False, error=f"imported {leaked}")
        return 1

    import torch

    # (name, source, the TPU kernel it replaces); library_ms is null where
    # no single PyTorch call computes the same function (the paged kernel's
    # is gather + scaled_dot_product_attention, timed in phase_paged_attn)
    kernels = [
        ("vtrace", "scalerl_torch/csrc/vtrace.cu", "scalerl_tpu/ops/pallas_vtrace.py:36"),
        ("per_sample", "scalerl_torch/csrc/per.cu", "scalerl_tpu/ops/pallas_per.py:79"),
        ("per_update", "scalerl_torch/csrc/per.cu", "scalerl_tpu/ops/pallas_per.py:225"),
        ("paged_attention", "scalerl_torch/csrc/paged_attention.cu",
         "scalerl_tpu/ops/pallas_paged_attention.py:108"),
        ("segment_attention_fwd", "scalerl_torch/csrc/segment_attention.cu",
         "scalerl_tpu/ops/pallas_attention.py:426"),
        ("segment_attention_bwd_dq", "scalerl_torch/csrc/segment_attention.cu",
         "scalerl_tpu/ops/pallas_attention.py:532"),
        ("segment_attention_bwd_dkv", "scalerl_torch/csrc/segment_attention.cu",
         "scalerl_tpu/ops/pallas_attention.py:578"),
        ("flash_attention_fwd", "scalerl_torch/csrc/flash_attention.cu",
         "scalerl_tpu/ops/pallas_attention.py:76"),
        ("flash_attention_bwd_dq", "scalerl_torch/csrc/flash_attention.cu",
         "scalerl_tpu/ops/pallas_attention.py:180"),
        ("flash_attention_bwd_dkv", "scalerl_torch/csrc/flash_attention.cu",
         "scalerl_tpu/ops/pallas_attention.py:220"),
    ]
    emit("phase_seconds", total=round(time.perf_counter() - t_all, 1), by_phase=seconds,
         card=report["card"])
    print(report["card"], flush=True)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": report["launches"][name],
        "max_abs_err": report[name]["max_abs_err"],
        "ms": report[name]["ms"],
        "plain_ms": report[name]["plain_ms"],
        "bound_ms": report[name]["bound_ms"],
        "bound_by": report[name]["bound_by"],
        "library_ms": report[name].get("library_ms"),
        # launches per learn step on each rank of shard_compute's two-rank
        # steps (summed over its configurations)
        "launches_on_shards": report["launches_on_shards"].get(name, 0),
        # launches on rank 0 of genrl_on_shards (its engine's macro steps
        # and its trainer's rounds)
        "launches_genrl_on_shards": report["launches_genrl_on_shards"].get(name, 0),
        # launches on rank 0 of serving_on_shards (its serving trainer's
        # learn steps and flushes) and of disagg_on_shards (its learn
        # steps, and its generation hosts' decoding)
        "launches_serving_on_shards": report["launches_serving_on_shards"].get(name, 0),
        "launches_disagg_on_shards": report["launches_disagg_on_shards"].get(name, 0),
    } for name, source, replaces in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
