#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one Hopper GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device of compute capability 9.0 and the CUDA toolkit (``nvcc``); it
imports nothing of JAX or of the JAX package.  Float32 matrix products run
in full float32 (TF32 off).  Phases, each reported on its own line:

1. device: the card's name, power limit and capability (must be 9.0);
2. build: the five kernels' CUDA sources compiled from
   ``src/repro_torch/**/csrc``, one ``nvcc`` each, in parallel (seconds and
   the ``ptxas`` register and spill report of each; the TF32
   flash_attention kernels, the tensor-core ones and the backward's four
   kernels (dq and dk / dv of each route) at every head dim (16, 32, 64, 80,
   112, 128, 256) must not spill, the bf16 backward's two kernels at d 64
   and 128 must issue wgmma (HGMMA in their SASS) and no warp-level HMMA,
   and the TF32 kernels' static SASS instruction mix is printed);
3. observe_scatter vs its plain version, exact, with and without a keep
   mask, each case on the table mode ``kernel.table_mode`` names (direct:
   slot = id; hashed): 5,000 blocks (SMALL) and 88 (the KV scenario);
   5,242,880 blocks on a Zipf draw, the online path's first batch (phase
   12's draw) at cursor 0 and at cursor = period - 1, a draw with a
   quarter of the ids on one page, all-distinct ids (they overflow every
   table) and ids that start 4 bytes past their allocation; n_blocks at
   the direct-map limit and one above it; the direct table's cases again
   on the hashed table, and the direct table above its limit refused;
4. hist_select vs its plain version, exact, one launch per call: 5 x
   5,242,880 mixed keys, S=1 and S=3, with caps of 0 and of the full
   segment and heavy ties; the online path's own rows (phase 12's, which
   stop after one or a few passes); uniform rows and rows that need every
   pass; n % 4 in {1, 2, 3} at 1 and at 5 rows (rows off a 16-byte
   boundary), S=3 with padding, k = 0 and k = |segment|; a row that starts
   4 bytes past its allocation;
5. gather_count vs its plain version, exact, float32 and bfloat16 storage
   at the paper's width (21,800,000 x 256), M in {1, 127, 2,400,001}, with
   a non-zero carry-in of the counters;
6. embedding_bag vs its plain version (float32 within 1e-5, bfloat16
   within 2e-2, counters exact): the paper draw at B=150,000, L=16, D=256
   in float32 and bfloat16, a Zipf mix, uniform ids (every row of a tile
   distinct: the tiled route's overflow), B=1 and B=3, L=5 on the tiled
   route, each equal to the per-bag route bit for bit, and D=250 on the
   per-bag route; each case takes the route ``kernel.route`` names;
7. SMALL parity, GPU vs CPU: ``run_scenario`` byte-identical for hints in
   {False, True} x sync_every in {1, 4, 7}; ``run_table1``/``run_fig3`` on
   the small specs and the tiering example at a small size, every field
   identical (the example's pooled rows within 1e-5);
8. the online main path at paper scale: 5,242,880 pages, 2.4 M lookups per
   batch, 486,587 fast slots, hints on, sync_every=4, under
   ``torch.cuda.set_sync_debug_mode("error")`` (only the record pull may
   sync); the kernels' launch counts and the record-pull count are checked;
   then the same loop five times warm, timed without the sync checks;
9. the offline path at the paper's width: ``examples.dlrm_tiering.run()``
   (20,000,000 x 256 table, 450,000 fast slots, 20 profile and 5 replay
   batches of 150,000 bags of 16): 20 embedding_bag (all on the tiled
   route), 5 gather_count and at least one hist_select launch, gathered
   rows equal to the table's; run under cProfile, whose top functions say
   where the host's time goes;
10. ``tracesim.run_table1()`` at paper scale (40 observe_scatter launches)
    inside the bands of ``tests/test_paper_claims.py``, under cProfile;
11. ``tracesim.run_fig3()`` at paper scale (256 launches), inside its bands,
    under cProfile;
12. kernel times at the paper-scale shapes (CUDA events), beside the bound,
    the plain version and one PyTorch library call (for hist_select the
    faster of ``kthvalue`` and ``topk``), the three redesigned kernels' times
    before their redesign beside theirs, observe_scatter on three draws
    (the online path's batch, uniform ids, one page) with the zeroing of
    its outputs timed alone, and embedding_bag's per-bag route
    timed in turns with the tiled one; then the online paper run once more
    under ``torch.profiler``: device busy time, idle share and the kernels
    that take the most device time;
13. flash_attention vs its plain version (2e-5 in float32; in bfloat16
    one bfloat16 step, 2**-7 of the value, plus 1e-3 of the largest
    output, and at most 1 % of the outputs differing at all), on inputs
    whose softmax is peaked, at the qwen2-0.5b and
    internlm2-1.8b prefill shapes (S=4096, bfloat16), MQA d=256, a sliding
    window, non-causal, and ragged S in {1, 19, 1000}; then the bfloat16
    tensor-core route at d=64 and 128 with ragged S in {130, 1000},
    non-causal Sq != Sk and a window, the same route at d=80 (zamba2-2.7b,
    32 heads) and d=112 (kimi-k2, 64 over 8) with S in {130, 512, 1000},
    non-causal Sq > Sk and Sq < Sk and a window edge inside a KV
    tile, and the float32 TF32 route at d=64 and 128: the qwen2-0.5b
    prefill, ragged S in {130, 1000}, a window edge inside a KV tile,
    non-causal Sq > Sk and Sq < Sk; the TF32 route at d=16, 32, 80, 112 and
    256 and the tensor-core route at d=16, 32 and 256, each with ragged S
    and GQA, a window edge inside a KV tile and non-causal Sq != Sk; each
    case must take the route that ``kernel.route`` names for its dtype and
    head dim (no (dtype, d) is the CUDA-core kernel's), and on each case of
    a (dtype, d) that the CUDA-core kernel takes (float32 at every d,
    bfloat16 at 16, 32, 80, 112 and 256) that kernel, named through
    ``kernel._launch``, must pass too;
14. the serving path at full width:
    ``repro_torch.launch.serve.main(["--arch", "qwen2-0.5b", "--batch",
    "4", "--prompt-len", "64", "--gen", "32", "--page-size", "16"])`` (the
    launcher's own example without ``--smoke``) and again with
    ``--prompt-len 4096``: 24 flash_attention launches per run (one per
    layer of the one prefill, none in decode), all on the tensor-core
    route, tokens/s, peak memory; then
    eight decode steps under ``torch.profiler`` (device busy and idle
    share, device ops per step, host-to-device copies, top ops);
15. one full-width prefill and decode step on the GPU (under
    ``set_sync_debug_mode("error")``: no host sync inside) and on the CPU
    with the same tokens: float32 activations within a stated tolerance,
    bfloat16 reported; each dtype's GPU run is a path of its own, counters
    zeroed before it: 24 flash_attention launches, on the TF32 route in
    float32 and on the tensor cores in bfloat16;
16. ``KVCacheScenario()`` on the GPU vs the CPU: 2 flash_attention launches
    (one prefill of the 2-layer smoke model, bfloat16 at d=16: the
    tensor-core route),
    decode masses within a
    tolerance, ``run_scenario`` fed the CPU's stream byte-identical for
    hints on x sync_every in {1, 4}, and how many access counts the GPU's
    own quantization moves;
17. flash_attention's time at the qwen2-0.5b and internlm2-1.8b S=4096
    prefill shapes (bfloat16: the tensor-core route) beside its bound, its
    plain version and ``F.scaled_dot_product_attention`` timed in the same
    call; TFLOP/s on the function's work and on the kernel's; then the
    qwen2-0.5b shape in float32 on the TF32 route, timed in turns with the
    plain version and with the CUDA-core kernel, beside both bounds (three
    TF32 products at the TF32 rate; one float32 product at the CUDA cores'
    rate) and the TF32 kernel's resident blocks an SM; then the shapes
    that took the CUDA-core kernel before every (dtype, d) had a tensor-core
    route (``ROW5B_TIME_SHAPES``: zamba2-2.7b and kimi-k2 in float32,
    qwen2-0.5b's heads at d=16 and 32 and phase 13's MQA heads at d=256 in
    both dtypes), each in turns with the CUDA-core kernel named through
    ``kernel._launch``, beside ``scaled_dot_product_attention`` and the
    bounds, with the softmax's exponentials a second;
18. the fleet: ``repro_torch.examples.fleet_mix``'s 4-tenant mix (dlrm, kv,
    moe, scanner; 340 fast slots; the KV and MoE streams made on the GPU
    once, their flash_attention launches checked) on the GPU vs the CPU
    for capacity in
    {shared, partition, weighted} x sync_every in {1, 4}, trajectory,
    summary and tenant rows identical, the launches checked; then the
    example's own run on the GPU inside the reference example's margins;
19. a paper-scale fleet at full width: phase 8's DLRM (stationary), the
    paper's mmap-bench region (2,621,440 pages, 262,144 hot, 2.4 M accesses
    a batch) and ``KVCacheScenario()``: 7,864,408 blocks, 600,000 fast
    slots against 748,753 of demand, 6 epochs of 4 interleaved rows, hints
    on, sync_every=4, shared and weighted-fair, each under
    ``set_sync_debug_mode("error")``: launches, 2 record pulls, the DLRM
    quota and weighted-fair DLRM coverage above the shared pool's checked;
    the warm epoch wall, the host interleave's share of it, the device's
    idle share (``torch.profiler``) and peak memory; hist_select's segment
    call (5 x 7,864,408 keys, S=3) timed beside its plain version, its
    bound and ``torch.topk`` on each segment's slice;
20. degraded telemetry (``repro_torch.faults``): (a) SMALL's
    ``run_scenario`` GPU vs CPU byte-identical under a neutral
    ``FaultModel`` and an "all faults" one (PEBS drops 0.3, resets 0.5 on
    every collector, NB stalls 0.5, 12-bit HMU counters, staleness 1,
    seed 7), each without and with hardening (three fallbacks, hysteresis
    2), K in {1, 4}, the neutral model equal to ``faults=None``; (b)
    ``repro_torch.examples.degraded_telemetry`` on the GPU inside the
    reference example's margins; (c) phase 8's paper-scale run under
    faults (drops 0.1, resets 0.1, stalls 0.2, 16-bit counters, staleness
    1) and ``hmu_oracle -> pebs`` hardening with H 2, under
    ``set_sync_debug_mode("error")``: 12 observe_scatter launches, all
    with the keep mask, 12 hist_select, 2 record pulls, the PEBS drop
    share within 5 sigma of 0.1; its warm epoch beside phase 8's, the
    fault model's draw for one batch, the device's idle share and peak
    memory; observe_scatter on the online batch with that draw's keep
    mask against its plain version (exact) and timed with and without it;
    (d) phase 18's mix GPU vs CPU, shared and weighted x K in {1, 4},
    under ``build_faults`` of a per-tenant profile (the scanner's PEBS
    drops 0.5 and 8-bit counters) with resets 0.2: trajectory, summary and
    tenant rows identical, launches checked;
21. the observability and export planes (``repro_torch.obs``,
    ``repro_torch.export``): (a) phase 8's paper run with tracing
    (``profiler_annotations``, span durations into ``REGISTRY``) and an
    ``ExportClient`` on a ``JsonlSink`` against the same run with both off,
    each under ``set_sync_debug_mode("error")``: trajectory JSON, dispatch
    deltas, launches (12 hashed observe_scatter, 6 hist_select) and peak
    memory to the MB equal; exactly 6 observe_all, 6 epoch_step and 2
    record_sync spans on the host thread, the pipelining visible, the
    Chrome trace written with its device track; every JSONL record valid,
    none dropped; under ``torch.profiler`` every observe_scatter kernel
    inside an ``observe_all`` range and every hist_select pass inside an
    ``epoch_step`` range; the warm epoch with both on and off, in turns,
    three runs each; (b) ``repro_torch.examples.runtime_timeline`` and
    ``telemetry_export`` on the GPU with the reference examples' asserts;
    (c) phase 18's mix, shared, sync_every in {1, 4}, with a
    ``MemorySink`` on the GPU and the CPU: wire records equal.  Its files
    go to fresh directories under the git-ignored ``build/``;
22. the per-lane reference path (``EpochRuntime(fused=False)``) and the
    MoE family: (a) ``run_scenario(fused=False)`` on SMALL for hints off,
    hints on and an NB rate limit, and ``run_fleet(fused=False)`` on phase
    18's mix for shared, partition and weighted, each GPU run byte-
    identical to the CPU's reference run and to the GPU's fused run, with
    one observe_scatter launch a batch and one hist_select a lane and
    epoch (none under quotas); (b) phase 8's paper run on the reference
    path, K 1: five lanes byte-identical to phase 8's fused trajectory,
    the hinted lane's differing epochs reported (eager against contracted
    float32 scores), 12 observe_scatter and 36 hist_select launches, its
    epoch wall beside phase 8's; (c) Mixtral-8x22B at its published widths
    with n_layers cut from 56 to 2 (5.41 B float32 parameters, their draw
    timed): prefill + 31 decode steps at B 4, prompt 64 and 4,096, page
    16, under ``set_sync_debug_mode("error")``, 2 flash_attention launches
    a prefill on the tensor cores and none in decode, the decode's expert
    counts per layer, tokens/s, peak memory; (d) ``MoEExpertScenario()``
    GPU vs CPU (its forwards on the route ``kernel.route`` names),
    ``run_scenario`` fed
    the CPU's stream byte-identical for hints x sync_every in {1, 4}, the
    accesses the GPU's own forwards move, then the port's
    ``expert_tiering_moe`` example on the GPU; (e) flash_attention at
    Mixtral's prefill shape (B 4, H 48, KVH 8, S 4,096, d 128, bfloat16,
    window 4,096) against its plain version, timed beside its bound and
    ``scaled_dot_product_attention(is_causal=True)`` (the kernel line's
    ``flash_attention_mixtral`` entry);
23. the recurrent families, RWKV-6 and Zamba2 (Mamba2 layers and a shared
    attention block): (a) both smoke models on perturbed weights (every
    leaf drawn, not the init's zeros), float32 and bfloat16: forward and
    prefill at S 150 (three chunks of 64, the last padded), then 3 decode
    steps, under ``set_sync_debug_mode("error")``, every output and cache
    leaf against the CPU's (RECURRENT_F32_TOL; bfloat16 by the rule of
    ``tests/_torch_recurrent.py``); zamba2's prefill launches
    flash_attention once per shared-block invocation (2), on the route
    ``kernel.route`` names (d 32: the tensor cores in bfloat16, the TF32
    route in float32), its decode none, rwkv6
    none; (b) one block at full width,
    float32, B 1 x 130 tokens, GPU against CPU within RECURRENT_F32_TOL:
    rwkv6-3b's layer 0 (output and wkv state), zamba2-2.7b's first group
    (6 Mamba2 layers, each output and SSM state, then the shared block at
    invocation 0, one flash_attention launch, float32 at d 80: the TF32
    route); (c) both at their published widths through
    ``launch.serve.main`` (float32 weights, bf16 activations, all layers;
    B 4, prompts 64 and 4,096, 32 tokens; every prefill and decode step
    under the sync check): the weights' draw, prefill and decode tokens/s,
    peak memory, 9 flash_attention launches per zamba2 prefill, all on the
    tensor cores (bf16 at d 80), none in decode, none for rwkv6, then each
    profiled at RECURRENT_PROFILE_LAYERS (every layer alike: rwkv6's first
    4, zamba2's first group of 6 and its shared block); (d)
    flash_attention at zamba2-2.7b's prefill shape (B 4, H 32, KVH 32, S
    4,096, d 80, bfloat16, causal, the tensor-core route) and at kimi-k2's
    (B 2, H 64, KVH 8, S 4,096, d 112) against its plain version, timed
    beside ``scaled_dot_product_attention(is_causal=True)`` and the bf16
    tensor-core bound, and in turns with the CUDA-core kernel named
    through ``kernel._launch`` (the kernel line's ``flash_attention_zamba2``
    and ``flash_attention_kimi_k2`` entries);
24. training: (a) ``FlashAttentionFn``'s dq, dk, dv (the kernel's forward,
    the backward kernels) against autograd of the plain version on the
    card and against the plain backward ``attention_bwd_ref`` (float32
    within 2e-5 of each tensor's largest magnitude, bfloat16 by FLASH_TOL's
    rule) at every TRAIN_GRAD_CASES case: qwen2-0.5b's training shape (B 4,
    H 14, KVH 2, S 2,048, d 64) in bfloat16 (the tensor cores) and float32
    (the TF32 route), zamba2's d 80, Mixtral's d 128 with a window of 1,000,
    ragged S 1,000, non-causal Sq > Sk, and d 16, 32, 112 and 256 in both
    dtypes and float32 at 80 and 128 (a window, ragged S, rows without any
    key, whose dq must be 0); one forward and one backward launch each on
    its route, a second backward (from the forward's saved lse and float32
    output) bit for bit equal to the first, and that lse against
    ``attention_lse_ref`` (LSE_TOL); at the qwen2 shape, in both dtypes,
    the backward kernels (from the saved lse and output), the plain
    backward, ``scaled_dot_product_attention``'s backward alone and its
    forward + backward (and in bfloat16 the forward kernel and the plain
    version's forward + backward) timed in turns, beside the backward's
    bound and the kernels' own floor, with the peak memory of the
    backwards (the kernel line's ``flash_attention_bwd`` and
    ``flash_attention_bwd_tf32x3`` entries), the forward's time beside its
    bound and sdpa's (``flash_attention_train``); (b) ``launch.train.main`` at
    qwen2-0.5b's full width (B 4, S 2,048, 12 steps, a checkpoint every 6
    to a fresh directory under ``build/``, tiering on): finite losses, the
    last below the first, 2 x 24 flash_attention launches and 24 backward
    calls a step, all on the tensor cores (remat "full"), none of the plain
    backward, one hist_select launch (step 10's
    rebalance), every step under ``set_sync_debug_mode("error")``; step
    wall, tokens/s, peak memory, one more step under ``torch.profiler``;
    (c) the step-6 checkpoint restored bit for bit, a second run resumed
    from it through step 12 on the same batches bit for bit, its losses
    within 1e-3 relative (reported: whether they are equal); (d) one
    float32 loss and gradient at full width (B 2, S 64) on the card and on
    the CPU, the loss and gradient norm within FULL_WIDTH_F32_TOL, every
    gradient leaf within TRAIN_LEAF_TOL_OF_MAX of its largest magnitude,
    2 x 24 launches and 24 backward calls on the TF32 route; (e)
    ``repro_torch.examples.train_100m`` for 5 steps on the card, its
    launches and backward calls on the tensor cores; then hist_select at the
    trainer's rebalance shape (the kernel line's ``hist_select_train``
    entry).

25. sharded state (``EpochRuntime(mesh=)``): a 1-rank NCCL group from a
    ``FileStore`` under a temporary directory and
    ``launch.mesh.make_telemetry_mesh(1)`` (one rank per GPU: this card is
    the mesh); (a) phase 8's paper-scale run (5,242,880 pages, 6 epochs x
    2 batches, hints, sync_every 4) with ``mesh=`` under
    ``set_sync_debug_mode("error")``: its JSON byte-identical to phase 8's
    meshless run, 12 observe_scatter and 6 hist_select launches, 2 record
    pulls, one observe_all and one epoch_step an epoch, the same
    collectives every epoch (their count and bytes an epoch printed);
    (b) the warm epoch with the mesh in turns with the meshless one;
    (c) the ranged observe_scatter (a rank's ``[lo, hi)`` of the id space)
    on phase 12's draw at lo > 0 (2- and 3-rank splits, with and without
    keep) against its plain version and the whole histogram cut to the
    range, exact; the W 1 call in turns with the unranged call, beside
    ``bincount`` and its bound (the kernel line's
    ``observe_scatter_sharded`` entry), a 2-rank half in turns with its
    plain version; (d) ``repro_torch.examples.quickstart`` and
    ``hinted_prefetch`` on the card, their stdout equal to their CPU
    run's; the group destroyed; within 60 s.

26. the sharded train step (``train.sharded.make_sharded_train_step``): a
    1-rank NCCL group as phase 25's and a (1, 1) ("data", "model") mesh;
    qwen2-0.5b at full width (phase 24b's B 4, S 2048, remat "full", AdamW
    at 3e-4), 3 steps with the mesh in turns with 3 meshless
    ``make_train_step`` steps from the same params and batches, each under
    ``set_sync_debug_mode("error")``: losses, grad norms and every param
    and optimizer leaf equal bit for bit, every leaf on ``named(mesh,
    model_pspecs / opt_pspecs)``, 48 flash_attention launches and 24
    backward calls a step on the tensor cores and no other kernel, none of
    the plain backward, the same collectives every step
    (their count and bytes printed); the step walls in turns, peak memory;
    the meshless state saved and restored with ``shardings=`` onto the
    mesh, bit for bit (the kernel line's ``flash_attention_sharded_train``
    entry); the group destroyed; within 60 s.

27. expert parallelism (``models.moe``'s expert-parallel path, the
    reference's ``_moe_shard_map``): two gloo ranks of CUDA tensors on the
    one card (NCCL takes one rank a device) and a (1, 2) ("data",
    "model") mesh.  (a) kimi-k2-1t-a32b at its published widths cut to 1
    of 61 layers, bf16 (38.8 GB of weights, each rank drawing its 192 of
    the 384 experts on the card from per-(leaf, expert) seeds):
    ``engine.prefill`` at B 2, S 4,096 with ``moe_groups`` (1, 2), a first
    call and EP_CALLS timed ones (wall, tokens/s, each rank's peak memory,
    the all-to-alls' count, bytes and seconds, 1 flash_attention launch a
    rank and call on the tensor cores); after the ranks exit, the same
    weights drawn whole and the prefill run on this process with each MoE
    layer per group: the counts and every group's dropped pairs exact, the
    MoE output and the last-token logits within EP_TOL of max(2,
    max|ref|); (b) the kimi-k2 smoke model's sharded train step (float32),
    2 steps with AdamW and 2 with Adafactor at the config's capacity
    factor, against the one-device steps with each MoE layer per group at
    the train-step bounds, placements and collectives exact; within 90 s.

28. the dry run (``launch.dryrun``), held to a real step: (a)
    qwen2-0.5b's single-device train step at phase 24b's shape (B 4,
    S 2048, bf16 activations, remat "full", AdamW) counted by
    ``dryrun.count_step`` on meta tensors, then run on the card (a
    warm-up, a timed step, a step under ``FlopCounterMode`` with each
    flash_attention launch's and backward call's shape recorded): the
    card's FLOPs plus the meta route's charge for each launch and backward
    call equal the dry run's FLOPs exactly, the launches (48, tensor-core)
    and the backward calls (24) equal its calls shape by shape, its
    argument bytes equal the storage of the card's params, optimizer state
    and batch; the predicted peak beside ``max_memory_allocated``, the warm
    step against its roofline time (max of the FLOPs at the bf16 peak and
    the bytes at the memory rate); (b) in a spawned process, rank 0 of a
    fake group of 512 ranks, ``dryrun.run_cell`` of kimi-k2-1t-a32b x
    train_4k x 16x16: status "ok" on the expert-parallel path (6 all-to-
    alls a layer), its FLOPs, collective bytes, argument and peak bytes
    and trace time printed; within 90 s.

29. tensor parallelism over "model" (``train.sharded``, tensor parallel):
    two gloo ranks of CUDA tensors on the one card and a (1, 2) ("data",
    "model") mesh; qwen2-0.5b at its published widths cut to TP_LAYERS of
    24 layers, B 4, S 2048, remat "full", the same weights on both ranks
    (``ep_params``, drawn on the card), each rank its 7 of the 14 query heads and 1
    of the 2 KV heads, its half of the MLP columns and of the vocabulary.
    (a) float32: the sharded step's gradient (local blocks gathered over
    "model") and one sharded AdamW step against the single-device
    ``loss_and_grads`` and ``make_train_step`` on rank 0: loss and grad
    norm within FULL_WIDTH_F32_TOL (abs + rel), every gradient leaf within
    TRAIN_LEAF_TOL_OF_MAX of its largest magnitude; the same for the two
    other attention layouts of TP_VARIANTS at TP_VARIANT_LAYERS layer
    (one KV head that each rank slices; 7 heads of d 128 that the rules
    cut through a head, q gathered over "model"); (b) the bf16 training
    config (bf16 activations), 2 steps: finite losses, on each rank and
    step 2 x TP_LAYERS flash_attention launches on the tensor cores and
    TP_LAYERS backward calls on the tensor-core route, every attention at
    (7, 1) heads, no call of the plain backward, the same collectives
    every step, each step under ``set_sync_debug_mode("error")`` but for
    the gloo calls themselves (gloo stages a CUDA tensor through the host
    and syncs there by design); then, on this process, flash_attention
    and its backward at a rank's shape (B 4, H 7, KVH 1, S 2048, d 64,
    bf16) beside their plain versions and ``sdpa``, the backward's
    gradient held as phase 24a holds it (the kernel line's
    ``flash_attention_tp_train`` and ``flash_attention_bwd_tp_train``
    entries).  FSDP over "data" on the same two ranks, a (2, 1) mesh
    (FSDP_MESH): (a-fsdp) 29a's float32 gradient and step at TP_LAYERS
    layers, each leaf the rules put "data" on held as the rank's half,
    gathered where its block reads it and its gradient reduce-scattered,
    held to the single-device step within the same bounds; (c) the bf16
    training config at qwen2-0.5b's full depth (24 layers, B 4: 2
    sequences a rank), FSDP_STEPS steps: finite losses equal on both
    ranks, 48 flash_attention launches on the tensor cores and 24
    backward calls a rank and step at (14, 2) heads, no plain backward,
    no sync but gloo's own, and the all-gathers, reduce-scatters and
    all-reduces over "data" a step, count and bytes, equal to those worked
    out from the config (``fsdp_expected``); the step walls and each
    rank's peak memory printed; within TP_PHASE_S.
30. sharded serving (``serve.engine.prefill(mesh=)`` /
    ``decode_step(mesh=)`` through ``repro_torch.serve.sharded``): two
    gloo ranks on the one card as phase 29's.  (a) qwen2-0.5b at its
    widths with SERVE_F32_LAYERS layers in float32 at the (1, 2) and
    (2, 1) meshes: the prefill of SERVE_F32_PROMPT tokens into a cache of
    SERVE_F32_MAX_LEN positions and SERVE_F32_STEPS decode steps with page
    masses; the logits, the page masses and pos gathered, and each rank's
    cache blocks after the prefill and after the last step, within
    SERVE_TOL (abs + rel) of the single-device run on the card (each rank
    against its block of that cache); (b) the same at one layer with one
    KV head at (1, 2): the cache's sequence over "model", so the decode
    combines the ranks' halves (its steps cross the halves' border); (c)
    qwen2-0.5b at its full width and depth in bf16 at (1, 2): the prefill
    of B SERVE_BATCH x S SERVE_PROMPT, then SERVE_STEPS decode steps, each
    call under ``set_sync_debug_mode("error")`` but for gloo's own calls;
    24 flash_attention launches a rank in the prefill, all on the tensor
    cores at (7, 1) heads, none in decode; tokens/s of prefill and decode
    and each rank's peak printed; then, on this process, flash_attention
    at a rank's prefill shape (B 4, H 7, KVH 1, S 4096, d 64, bf16) beside
    its plain version and ``sdpa`` (the kernel line's
    ``flash_attention_tp_serve`` entry); within SERVE_PHASE_S.
31. Mixtral's expert tensor parallelism (its override puts
    ``expert_mlp`` on "model": each rank runs every expert on its half of
    ``d_expert``, the partial outputs summed over "model"): two gloo
    ranks on the one card at (1, 2), Mixtral-8x22B at its published
    widths, its weights drawn on the card from a seed of each leaf and
    expert.  (a) One layer in float32: the prefill of SERVE_F32_PROMPT
    tokens into SERVE_F32_MAX_LEN positions and SERVE_F32_STEPS decode
    steps against the single-device run within SERVE_TOL, as 30a; (b) one
    layer in float32, B MOE_TP_TRAIN_BATCH x S MOE_TP_TRAIN_SEQ: the
    single-device gradient first (its blocks kept, the whole freed), then
    the sharded gradient, each leaf's block (the router's whole) within
    TRAIN_LEAF_TOL_OF_MAX of that leaf's largest magnitude, and one
    sharded step on MOE_TP_OPT, its loss and gradient norm within
    FULL_WIDTH_F32_TOL; (c) two layers in bf16: the prefill of B
    MOE_TP_BATCH x S MOE_TP_PROMPT and MOE_TP_STEPS decode steps, 2
    flash_attention launches a rank in the prefill, all on the tensor
    cores at (24, 4) heads, none in decode, tokens/s, each rank's peak
    and the collectives by axis and kind.  In every part: each step and
    serving call under ``set_sync_debug_mode("error")`` but for gloo's own
    calls, each expert leaf the rank's half of ``d_expert`` and none
    gathered over "model", the serving calls' collectives exactly
    ``moe_tp_expected``'s, the expert counts and dropped pairs of every
    call the single-device run's and equal on both ranks.  Then, on this
    process, flash_attention at a rank's prefill shape (B 4, H 24, KVH 4,
    S 4096, d 128, bf16) beside its plain version and ``sdpa`` (the
    kernel line's ``flash_attention_mixtral_tp`` entry); within
    MOE_TP_PHASE_S.
32. RWKV-6's and Mamba2's mixes on each "model" rank's heads: two gloo
    ranks on the one card at (1, 2), rwkv6-3b (20 of its 40 heads a
    rank; its channel mix on the rank's halves of ``d_ff`` and of the
    receptance's columns) and zamba2-2.7b (40 of 80 Mamba2 heads a rank;
    its shared block at 16 / 16 attention heads) at their published
    widths, the weights drawn on the card.  For each: (a) float32 at
    REC_TP_F32_LAYERS (rwkv6 2 layers, zamba2 one group of 6 Mamba2
    layers and its shared block): the prefill of SERVE_F32_PROMPT tokens
    into SERVE_F32_MAX_LEN positions and SERVE_F32_STEPS decode steps
    against the single-device run within SERVE_TOL, as 30a; (b) the same
    layers in float32, B REC_TP_TRAIN_BATCH x S REC_TP_TRAIN_SEQ: the
    single-device gradient, then the sharded gradient, each leaf's block
    within TRAIN_LEAF_TOL_OF_MAX of that leaf's largest magnitude, and one
    sharded step on REC_TP_OPT, its loss and gradient norm within
    FULL_WIDTH_F32_TOL.  rwkv6-3b's float32 runs at these widths differ
    from themselves on the CPU by more than those bounds, so its sharded
    runs (REC_TP_NOISE_ARCHS) are held to them or to twice that noise
    floor, measured in the phase (``rec_tp_noise``: the single-device
    runs on the CPU, in a thread while the ranks run, against the same
    runs on the card); (c) bf16 at REC_TP_BF16_LAYERS: the prefill of B
    REC_TP_BATCH x S REC_TP_PROMPT and REC_TP_STEPS decode steps, each
    rank's recurrent state its heads' block, zamba2's one
    flash_attention launch a rank in the prefill on the tensor cores at
    (16, 16) heads, none in decode, tokens/s a rank, each rank's peak and
    the collectives by axis and kind.  In every part each step and
    serving call runs under ``set_sync_debug_mode("error")`` but for
    gloo's own calls, and the collectives over "model" are exactly those
    worked out from the layout (``rec_tp_train_expected``,
    ``rec_tp_serve_expected``: no leaf gathered over "model" where the
    rank's block is its heads' slice).  Then, on this process,
    flash_attention at a rank's zamba2 prefill shape (B 4, H 16, KVH 16,
    S 4096, d 80, bf16) beside its plain version and ``sdpa`` (the kernel
    line's ``flash_attention_zamba2_tp`` entry); within REC_TP_PHASE_S.

Each path (8-11, 14-16, 18-32) sets the launch counters to 0 just before it
runs and reads them just after.  Any failure exits non-zero before the
result lines.  The last lines are the
kernel table (JSON), the ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12        # H100 SXM non-tensor-core rate (float32)
TENSOR_BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
TENSOR_TF32_OPS_PER_S = 495e12  # H100 SXM dense TF32 tensor-core rate
PAPER_PAGES = 5_242_880
PAPER_K_HOT = 486_587
# the offline path's paper width (datagen.PAPER): 20 M rows of 256 in 5 M
# blocks of 4, 9 % of them fast, 150,000 bags of 16 per batch
PAPER_ROWS, PAPER_DIM, PAPER_BLOCK_ROWS = 20_000_000, 256, 4
PAPER_SLOTS = 450_000
PAPER_STORAGE_ROWS = PAPER_ROWS + PAPER_SLOTS * PAPER_BLOCK_ROWS
PAPER_BAGS, PAPER_BAG = 150_000, 16


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, sort_keys=True), flush=True)


_SASS: dict = {}


def sass_text(library: Path, marker: str) -> dict:
    """{function: its SASS instructions, addresses and encodings taken
    out} of the functions in ``library`` whose (mangled) names hold
    ``marker`` (``cuobjdump -sass`` once a library and process)."""
    from repro_torch.kernels import _build
    key = str(library)
    if key not in _SASS:
        _SASS[key] = subprocess.run(
            [str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass",
             str(library)], capture_output=True, text=True, timeout=120,
            check=True).stdout
    sass = _SASS[key]
    out, fn = {}, None
    for ln in sass.splitlines():
        head = re.search(r"Function : (\S+)", ln)
        if head:
            fn = head.group(1) if marker in head.group(1) else None
            if fn:
                out[fn] = []
            continue
        op = re.match(r"\s*/\*[0-9a-f]+\*/\s+(.*?)\s*;", ln)
        if fn and op:
            out[fn].append(op.group(1))
    return out


def sass_mix(library: Path, marker: str) -> dict:
    """{function: [instructions, HMMA instructions, {opcode: count} of the
    ten most common]} of the functions in ``library``'s SASS (``cuobjdump
    -sass``, beside ``nvcc``) whose (mangled) names hold ``marker``; static
    counts."""
    import collections
    out = {}
    for fn, body in sass_text(library, marker).items():
        c = collections.Counter(
            m.group(1) for m in (re.match(r"(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                                          ins) for ins in body) if m)
        out[fn] = [sum(c.values()),
                   sum(n for op, n in c.items() if op.startswith("HMMA")),
                   dict(c.most_common(10))]
    return out


def spill_bytes(ptxas_log: str, marker: str) -> dict:
    """{function: spill store + load bytes} of the functions in a ``ptxas
    -v`` report whose (mangled) names hold ``marker``."""
    out, fn = {}, None
    for ln in ptxas_log.splitlines():
        if "Function properties for" in ln:
            fn = ln.split()[-1]
        elif fn is not None and "spill stores" in ln:
            if marker in fn:
                out[fn] = sum(int(n) for n in re.findall(
                    r"(\d+) bytes spill (?:stores|loads)", ln))
            fn = None
    return out


def ptxas_registers(ptxas_log: str, marker: str) -> dict:
    """{function: registers a thread} of the entry functions in a ``ptxas
    -v`` report whose (mangled) names hold ``marker``."""
    out, fn = {}, None
    for ln in ptxas_log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", ln)
        used = re.search(r"Used (\d+) registers", ln)
        if entry:
            fn = entry.group(1)
        elif fn is not None and used:
            if marker in fn:
                out[fn] = int(used.group(1))
            fn = None
    return out


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = SCALAR_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# cycles the card spins before a timed run, so that the host enqueues the
# run's calls while it waits (about 60 ms at the H100's clock)
SPIN_CYCLES = 100_000_000


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after a warm-up.
    The calls queue up behind a spin of the card, so a host slower than
    the card at enqueueing them (as at observe_scatter's paper shape) does
    not show in the time."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(plain, kernel, reps: int):
    """plain, kernel, kernel, plain on one card; mean of each pair."""
    p1 = time_ms(plain, reps)
    k1 = time_ms(kernel, reps)
    k2 = time_ms(kernel, reps)
    p2 = time_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def same_tree(a, b) -> bool:
    """Exact equality of nested dicts / lists / arrays / scalars."""
    import numpy as np
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(same_tree(a[k], b[k])
                                              for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tree(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return bool(np.array_equal(a, b))
    return a == b


def profiled(fn):
    """``fn()`` under cProfile -> (its result, {function: own seconds} of
    the ten functions with the most own time, total own seconds)."""
    import cProfile
    import pstats
    import torch
    host = cProfile.Profile()
    host.enable()
    out = fn()
    torch.cuda.synchronize()
    host.disable()
    stats = pstats.Stats(host).stats
    by_own = sorted(stats.items(), key=lambda kv: -kv[1][2])[:10]
    return out, {f"{Path(k[0]).name}:{k[1]}:{k[2]}": v[2]
                 for k, v in by_own}, sum(v[2] for v in stats.values())


def free_device_memory() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def paper_storage(dev, seed: int):
    """A (21.8 M, 256) float32 storage of the offline path's width, made on
    the card from a seeded generator (22.3 GB)."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    st = torch.empty((PAPER_STORAGE_ROWS, PAPER_DIM), dtype=torch.float32,
                     device=dev)
    return st.normal_(generator=gen)


def zipf_rows(rng, m: int, n_rows: int):
    """Row ids as the offline path draws them: Zipf(1.3) heads (repeats)
    mixed with uniform rows, all in [0, n_rows)."""
    import numpy as np
    heads = (rng.zipf(1.3, m) - 1) % n_rows
    return np.where(rng.random(m) < 0.5, heads,
                    rng.integers(0, n_rows, m)).astype(np.int32)


def observe_scatter_draws(dev, paper_ids) -> dict:
    """observe_scatter's id streams at the paper shape (2.4 M ids into
    5,242,880 pages), as phase 12 times them: the online path's first batch
    (Zipf 1.31; its hottest page takes about a quarter of the ids), uniform
    ids (few repeats: atomics seldom meet) and one page (all of them do)."""
    import torch
    m = paper_ids.numel()
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    return {"paper": paper_ids,
            "uniform": torch.randint(0, PAPER_PAGES, (m,), generator=gen,
                                     device=dev, dtype=torch.int32),
            "one_page": torch.full((m,), 4_321, dtype=torch.int32,
                                   device=dev)}


def observe_scatter_cases(dev, rng, paper_ids, direct_limit: int):
    """Phase 3's cases: (label, ids, n_blocks, cursor, period).  Ids reach
    past both ends of the range where the draw allows (negatives wrap once,
    the rest drop)."""
    import numpy as np
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def zipf(m, n):                     # -3 .. n + 2
        return (rng.zipf(1.3, m) - 1) % (n + 6) - 3

    n, m = PAPER_PAGES, 2_400_001
    quarter = np.where(rng.random(m) < 0.25, 77, rng.integers(-3, n + 3, m))
    # 4 bytes past the allocation: a 12-byte scalar head
    offset = t(zipf(m + 1, n))[1:]
    return [("small", t(zipf(40_003, 5_000)), 5_000, 123, 401),
            ("kv", t(zipf(16_384, 88)), 88, 5, 401),
            ("zipf", t(zipf(m, n)), n, 123, 401),
            ("phase-12 draw", paper_ids, n, 0, 401),
            ("phase-12 draw, cursor = period - 1", paper_ids, n, 400, 401),
            ("quarter on one page", t(quarter), n, 123, 401),
            ("all distinct", t(rng.permutation(n)[:m]), n, 123, 401),
            ("offset by 4 bytes", offset, n, 123, 401),
            ("direct-map limit", t(zipf(200_003, direct_limit)),
             direct_limit, 9, 13),
            ("direct-map limit + 1", t(zipf(200_003, direct_limit + 1)),
             direct_limit + 1, 9, 13)]


def observe_scatter_time(dev, plain, paper_ids) -> dict:
    """Phase 12: observe_scatter at the paper shape on observe_scatter_draws
    (the online path's batch gives the kernels line), in turns with the
    plain version, beside ``bincount``; each call zeroes its two outputs,
    and the zeroing is timed alone."""
    import torch
    from repro_torch.kernels.observe_scatter import kernel as os_kernel
    from repro_torch.kernels.observe_scatter import observe_scatter
    n, m = PAPER_PAGES, paper_ids.numel()
    cursor = torch.zeros((), dtype=torch.int32, device=dev)
    draws = {}
    for label, ids in observe_scatter_draws(dev, paper_ids).items():
        k_ms, p_ms = in_turns(
            lambda: observe_scatter(ids, cursor, n_blocks=n, period=401,
                                    backend=plain),
            lambda: observe_scatter(ids, cursor, n_blocks=n, period=401), 20)
        draws[label] = {
            "ms": k_ms, "plain_ms": p_ms,
            "bincount_ms": time_ms(lambda: torch.bincount(ids, minlength=n),
                                   20),
            "distinct": int(torch.unique(ids).numel())}
    zero_ms = time_ms(lambda: (torch.zeros(n, dtype=torch.int32, device=dev),
                               torch.zeros(n, dtype=torch.int32, device=dev)),
                      20)
    bound, by = bound_ms(4 * m + 2 * 4 * n, 2 * m)
    out = {"m": m, "n_blocks": n, "mode": os_kernel.table_mode(n),
           "draws": draws, "zeroing_ms": zero_ms, "bound_ms": bound,
           "bound_by": by, "before_ms": BEFORE_MS["observe_scatter"],
           "before_ms_without_spin": BEFORE_NO_SPIN_MS["observe_scatter"],
           "share_of_bound": bound / draws["paper"]["ms"]}
    say("observe_scatter_time", **out)
    return out


def selection_rows(dev, ids0, ids1, n_blocks: int = PAPER_PAGES):
    """The (5, n_blocks) int32 key rows the online path ranks in one
    hist_select call, from two batches of its page ids: the access counts,
    their non-zero mask and three float scores as sortable keys (phase 12's
    rows; about 98 % of each row is one tie value)."""
    import torch
    from repro_torch.core import selectk
    from repro_torch.kernels.observe_scatter import observe_scatter
    cursor = torch.zeros((), dtype=torch.int32, device=dev)
    h0, h1 = (observe_scatter(torch.from_numpy(ids).to(dev), cursor,
                              n_blocks=n_blocks, period=401)[0]
              for ids in (ids0, ids1))
    hf = h0.to(torch.float32)
    return torch.stack([
        h0, (h0 > 0).to(torch.int32), selectk.sortable_key(0.5 * hf),
        selectk.sortable_key(torch.where(h0 > 0, hf / hf.max(), -1.0)),
        selectk.sortable_key(h1.to(torch.float32) / h1.max())]).contiguous()


def hist_select_cases(dev, rng, datagen, DLRMScenario):
    """Phase 4's cases: [(label, (B, n) int32 keys, seg ids or None, ks)]."""
    import numpy as np
    import torch
    n = PAPER_PAGES
    keys = rng.integers(0, 40, (5, n)).astype(np.int32)          # heavy ties
    keys[1] = rng.integers(-2 ** 31, 2 ** 31 - 1, n, dtype=np.int64)
    keys[2, : n // 2] = -2 ** 31                                   # sentinel
    keys[3] = np.float32(rng.random(n) * (rng.random(n) < 0.1)).view(
        np.int32)
    keys_t = torch.from_numpy(keys).to(dev)
    lens = (1_000_003, 2_500_000, n - 3_500_003)
    seg = torch.from_numpy(np.repeat(np.arange(3, dtype=np.int32), lens)
                           ).to(dev)
    cases = [("mixed rows", keys_t, None, ks) for ks in (
        (PAPER_K_HOT,), (0,), (n,), (1,))]
    cases.append(("mixed rows, S=3", keys_t, seg, (0, lens[1], 7_777)))
    # the online path's rows: tie-heavy, one pass for the float rows
    spec = datagen.DLRMTraceSpec(n_params=5_368_709_120)
    head = list(DLRMScenario(spec=spec, n_epochs=2, batches_per_epoch=2,
                             shift_at=3, k_hot=PAPER_K_HOT).epochs())
    sel = selection_rows(dev, head[0][0], head[1][0])
    cases += [("phase-12 rows", sel, None, ks)
              for ks in ((PAPER_K_HOT,), (0,), (1,), (n,))]
    # uniform keys, and keys whose bytes come from {0, 1, 254, 255}: every
    # bin the search picks holds keys that differ in the next byte, so
    # those rows need every pass
    uni = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, (2, n),
                                        dtype=np.int64).astype(np.int32)
                           ).to(dev)
    cases += [("uniform rows", uni, None, ks)
              for ks in ((PAPER_K_HOT,), (1,), (n,))]
    byte = rng.choice(np.asarray([0, 1, 254, 255], np.uint32), (2, n, 4))
    hard = ((byte[..., 0] << 24) | (byte[..., 1] << 16) | (byte[..., 2] << 8)
            | byte[..., 3]).astype(np.uint32).view(np.int32)
    cases += [("every-pass rows", torch.from_numpy(hard).to(dev), None, ks)
              for ks in ((PAPER_K_HOT,), (1,), (n // 2,), (n,))]
    # n % 4 in {1, 2, 3}: rows that start off a 16-byte boundary, with a
    # scalar head and tail; S=3 with padding inside and at the end
    for m in (1_000_001, 1_000_002, 1_000_003, 5, 6, 7):
        for rows in (1, 5):
            x = rng.integers(-5, 6, (rows, m)).astype(np.int32)
            x[:, ::3] = rng.integers(-2 ** 31, 2 ** 31 - 1, x[:, ::3].shape,
                                     dtype=np.int64)
            x_t = torch.from_numpy(x).to(dev)
            sg = np.minimum(np.arange(m) * 3 // m, 2).astype(np.int32)
            sg[1::7] = -1
            sg[-1] = -1
            sg_t = torch.from_numpy(sg).to(dev)
            seg_lens = [int((sg == s).sum()) for s in range(3)]
            cases += [(f"n={m}, {rows} row(s)", x_t, None, ks)
                      for ks in ((1,), (m // 2 + 1,), (m,), (0,))]
            cases.append((f"n={m}, {rows} row(s), S=3 padded", x_t, sg_t,
                          (seg_lens[0], max(seg_lens[1] // 2, 1), 0)))
        # one row that starts 4 bytes past an allocation (a 12-byte head)
        flat = torch.from_numpy(rng.integers(-5, 6, m + 1).astype(np.int32)
                                ).to(dev)
        cases.append((f"n={m}, offset row", flat[1:].view(1, m), None,
                      (max(m // 3, 1),)))
    return cases


def check_observe_scatter(dev, rng, plain, paper_ids) -> int:
    """Phase 3: every case of observe_scatter_cases, with and without a
    keep mask, against the plain version, exactly, on the table mode
    ``kernel.table_mode`` names, and the direct table's cases on the hashed
    table too; the direct table above its limit must be refused -> the
    largest difference (0)."""
    import torch
    from repro_torch.kernels.observe_scatter import kernel as os_kernel
    from repro_torch.kernels.observe_scatter import observe_scatter
    t0 = time.perf_counter()
    direct_limit = os_kernel.shared_limit()
    if not 5_000 <= direct_limit < PAPER_PAGES:
        fail(f"unexpected direct-map limit {direct_limit}")
    os_modes, worst = {}, 0
    for label, ids, n_blocks, cur, period in observe_scatter_cases(
            dev, rng, paper_ids, direct_limit):
        keep = torch.from_numpy(rng.random(ids.numel()) < 0.7).to(dev)
        if label == "offset by 4 bytes":
            keep = torch.from_numpy(rng.random(ids.numel() + 1) < 0.7
                                    ).to(dev)[1:]
        cursor = torch.tensor(cur, dtype=torch.int32, device=dev)
        mode = os_kernel.table_mode(n_blocks)
        for run_mode in dict.fromkeys([mode, "hashed"]):
            before = dict(os_kernel.MODE_LAUNCHES)
            err = 0
            for km in (None, keep):
                got = (observe_scatter(ids, cursor, n_blocks=n_blocks,
                                       period=period, keep=km)
                       if run_mode == mode else
                       os_kernel._launch(run_mode, ids, cursor,
                                         n_blocks=n_blocks, period=period,
                                         keep=km))
                ref = observe_scatter(ids, cursor, n_blocks=n_blocks,
                                      period=period, keep=km, backend=plain)
                torch.cuda.synchronize()
                for g, r in zip(got, ref):
                    err = max(err, int((g - r).abs().max()))
            if os_kernel.MODE_LAUNCHES[run_mode] != before[run_mode] + 2:
                fail(f"observe_scatter ({label}) did not launch twice on "
                     f"the {run_mode} table")
            key = label if run_mode == mode else f"{label}, hashed"
            os_modes[key] = [n_blocks, ids.numel(), run_mode, err]
            worst = max(worst, err)
            if err != 0:
                fail(f"observe_scatter differs from its plain version "
                     f"({key}, max abs err {err})")
    launches = os_kernel.LAUNCHES
    try:
        os_kernel._launch("direct", paper_ids, cursor,
                          n_blocks=direct_limit + 1, period=401)
        fail("observe_scatter ran the direct table above its limit")
    except RuntimeError:
        pass
    if os_kernel.LAUNCHES != launches:
        fail("a refused observe_scatter launch was counted")
    say("observe_scatter", cases=os_modes, direct_map_limit=direct_limit,
        max_abs_err=worst, seconds=time.perf_counter() - t0)
    if {v[2] for v in os_modes.values()} != {"direct", "hashed"}:
        fail(f"observe_scatter's cases missed a table mode: {os_modes}")
    return worst


def check_gather_count(dev, rng, plain) -> int:
    """Phase 5: gather_count == plain, exactly; returns the max abs err."""
    import numpy as np
    import torch
    from repro_torch.kernels.gather_count import gather_count
    st32 = paper_storage(dev, 1)
    n_counts = PAPER_STORAGE_ROWS // PAPER_BLOCK_ROWS
    carry = torch.from_numpy(rng.integers(0, 10, n_counts).astype(np.int32)
                             ).to(dev)
    worst = 0
    for dtype in (torch.float32, torch.bfloat16):
        st = st32 if dtype == torch.float32 else st32.to(dtype)
        for m in (1, 127, 2_400_001):
            idx = torch.from_numpy(zipf_rows(rng, m, PAPER_STORAGE_ROWS)
                                   ).to(dev)
            rows, counts = gather_count(st, idx, carry,
                                        block_rows=PAPER_BLOCK_ROWS)
            p_rows, p_counts = gather_count(st, idx, carry,
                                            block_rows=PAPER_BLOCK_ROWS,
                                            backend=plain)
            torch.cuda.synchronize()
            err = max(float((rows.float() - p_rows.float()).abs().max()),
                      float((counts - p_counts).abs().max()))
            if not (torch.equal(rows, p_rows) and torch.equal(counts,
                                                              p_counts)):
                fail(f"gather_count differs from its plain version "
                     f"({dtype}, M={m}, max abs err {err})")
            worst = max(worst, int(err))
            del rows, p_rows
        del st
    del st32
    free_device_memory()
    return worst


def paper_lookups(dev, n_bags: int = PAPER_BAGS):
    """(n_bags, 16) row ids drawn as the offline example draws them
    (``ZipfPageSampler(PAPER, seed=1)`` pages x 4 + a row within the page,
    seeded): phase 12's draw, and phase 6's paper cases."""
    import numpy as np
    import torch
    from repro_torch.dlrm import datagen
    m = n_bags * PAPER_BAG
    pages = datagen.ZipfPageSampler(datagen.PAPER, seed=1).sample(m)
    rows = (pages.astype(np.int64) * PAPER_BLOCK_ROWS
            + np.random.default_rng(1).integers(0, PAPER_BLOCK_ROWS, m))
    return torch.from_numpy(rows.astype(np.int32).reshape(n_bags, PAPER_BAG)
                            ).to(dev)


# embedding_bag's checks (phase 6): (label, dtype, ids, B, L); ids "paper"
# is phase 12's draw, "zipf" zipf_rows, "uniform" uniform over the storage
# (every row of a tile distinct: the tiled route's overflow case)
EB_CASES = [
    ("paper f32", "float32", "paper", PAPER_BAGS, PAPER_BAG),
    ("paper bf16", "bfloat16", "paper", PAPER_BAGS, PAPER_BAG),
    ("zipf f32", "float32", "zipf", PAPER_BAGS, PAPER_BAG),
    ("zipf bf16", "bfloat16", "zipf", PAPER_BAGS, PAPER_BAG),
    ("uniform f32", "float32", "uniform", PAPER_BAGS, PAPER_BAG),
    ("B=1", "float32", "paper", 1, PAPER_BAG),
    ("B=3 L=5 f32", "float32", "zipf", 3, 5),
    ("B=3 L=5 bf16", "bfloat16", "zipf", 3, 5),
]
EB_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# an unaligned width (rows of 250 float32: not whole 128-byte slices) on a
# storage of its own, which takes the per-bag route
EB_UNALIGNED = (1_000_003, 250, 20_000, PAPER_BAG)


def check_embedding_bag(dev, rng, plain):
    """Phase 6: embedding_bag == plain within EB_TOL, counters exact, each
    case on the route ``kernel.route`` names; where that is the tiled
    route, its output and counters equal the per-bag route's bit for bit.
    Returns ({dtype: max abs err}, {label: route})."""
    import numpy as np
    import torch
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.embedding_bag import kernel as eb_kernel
    st32 = paper_storage(dev, 2)
    n_counts = PAPER_STORAGE_ROWS // PAPER_BLOCK_ROWS
    carry = torch.from_numpy(rng.integers(0, 10, n_counts).astype(np.int32)
                             ).to(dev)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    routes = {}
    stores = {"float32": st32}

    def one(label, st, idx, counts, dtype):
        b, l = idx.shape
        w = torch.from_numpy(rng.uniform(0.5, 1.5, (b, l))
                             .astype(np.float32)).to(dev)
        routes[label] = eb_kernel.route(st.dtype, st.shape[1], l,
                                        st.data_ptr() % 16 == 0)
        before = eb_kernel.ROUTE_LAUNCHES[routes[label]]
        out, got_counts = embedding_bag(st, idx, counts, w,
                                        block_rows=PAPER_BLOCK_ROWS)
        if eb_kernel.ROUTE_LAUNCHES[routes[label]] != before + 1:
            fail(f"embedding_bag ({label}) did not take its {routes[label]} "
                 f"route")
        p_out, p_counts = embedding_bag(st, idx, counts, w,
                                        block_rows=PAPER_BLOCK_ROWS,
                                        backend=plain)
        torch.cuda.synchronize()
        diff = (out.float() - p_out.float()).abs()
        err = float(diff.max())
        worst[dtype] = max(worst[dtype], err)
        tol = EB_TOL[dtype]
        within = bool(torch.all(diff <= tol + tol * p_out.float().abs()))
        if not (within and torch.equal(got_counts, p_counts)):
            fail(f"embedding_bag differs from its plain version ({label}, "
                 f"max abs err {err}, counts equal "
                 f"{torch.equal(got_counts, p_counts)})")
        if routes[label] == "tiled":
            o_out, o_counts = eb_kernel._launch(
                "per_bag", st, idx, w, counts, block_rows=PAPER_BLOCK_ROWS)
            if not (torch.equal(out, o_out) and torch.equal(got_counts,
                                                            o_counts)):
                fail(f"embedding_bag's tiled route differs from the per-bag "
                     f"route ({label}, max abs diff "
                     f"{float((out.float() - o_out.float()).abs().max())})")

    for label, dtype, ids, b, l in EB_CASES:
        if dtype not in stores:
            stores[dtype] = st32.to(getattr(torch, dtype))
        if ids == "paper":
            idx = paper_lookups(dev, b)
        elif ids == "zipf":
            idx = torch.from_numpy(zipf_rows(rng, b * l, PAPER_STORAGE_ROWS)
                                   .reshape(b, l)).to(dev)
        else:
            idx = torch.from_numpy(rng.integers(0, PAPER_STORAGE_ROWS, (b, l))
                                   .astype(np.int32)).to(dev)
        one(label, stores[dtype], idx, carry, dtype)
    del stores, st32
    free_device_memory()
    n, d, b, l = EB_UNALIGNED
    st = torch.empty((n, d), device=dev).normal_(
        generator=torch.Generator(device=dev).manual_seed(4))
    idx = torch.from_numpy(zipf_rows(rng, b * l, n).reshape(b, l)).to(dev)
    one(f"D={d} f32", st, idx, torch.zeros(-(-n // PAPER_BLOCK_ROWS),
                                           dtype=torch.int32, device=dev),
        "float32")
    want = {c[0]: "tiled" for c in EB_CASES}
    want[f"D={d} f32"] = "per_bag"
    if routes != want:
        fail(f"embedding_bag routes {routes}, expected {want}")
    del st
    free_device_memory()
    return worst, routes


def offline_small_parity(dlrm_tiering, tracesim, datagen, mmap_bench):
    """Phase 7, offline part: the small specs on the GPU and on the CPU."""
    import numpy as np
    import torch
    t1 = dict(k_hot=500, batches_per_iteration=5, eval_batches=8,
              dram_only_target_us=633.24)
    rows = {d: {k: dataclasses.asdict(v) for k, v in tracesim.run_table1(
        datagen.SMALL, device=d, **t1).items()} for d in ("cuda", "cpu")}
    if rows["cuda"] != rows["cpu"]:
        fail("run_table1 (small) differs GPU vs CPU")
    f3 = dict(total_accesses=2_000_000, pebs_period=401, n_batches=16)
    figs = {d: tracesim.run_fig3(mmap_bench.SMALL, device=d, **f3)
            for d in ("cuda", "cpu")}
    if not same_tree(figs["cuda"], figs["cpu"]):
        fail("run_fig3 (small) differs GPU vs CPU")
    spec = dlrm_tiering.SMALL
    table = (np.random.default_rng(3).normal(size=(spec.n_rows, spec.emb_dim))
             * 0.05).astype(np.float32)
    ex = {d: dlrm_tiering.run(spec, bag=4, table=table, device=d)
          for d in ("cuda", "cpu")}
    pooled_err = float((ex["cuda"].pop("pooled").cpu()
                        - ex["cpu"].pop("pooled")).abs().max())
    if not (same_tree(ex["cuda"], ex["cpu"]) and pooled_err <= 1e-5
            and ex["cuda"]["gathered_equal"]):
        fail(f"the small tiering example differs GPU vs CPU (pooled max "
             f"abs err {pooled_err})")
    return pooled_err


# flash_attention's checks (phase 13): (label, B, H, KVH, Sq, Sk, d, dtype,
# causal, window)
FLASH_CASES = [
    ("qwen2-0.5b prefill", 4, 14, 2, 4096, 4096, 64, "bfloat16", True, None),
    ("internlm2-1.8b prefill", 2, 16, 8, 4096, 4096, 128, "bfloat16", True,
     None),
    ("mqa d=256", 2, 8, 1, 512, 512, 256, "float32", True, None),
    ("window 128", 2, 4, 4, 512, 512, 128, "float32", True, 128),
    ("non-causal", 2, 4, 2, 512, 300, 64, "float32", False, None),
    ("ragged S=1", 1, 14, 2, 1, 1, 64, "bfloat16", True, None),
    ("ragged S=19", 4, 4, 2, 19, 19, 16, "bfloat16", True, None),
    ("ragged S=1000", 2, 14, 2, 1000, 1000, 64, "float32", True, None),
    # the tensor-core route (bfloat16, d in 64, 128): ragged tiles, Sq != Sk,
    # a window edge inside a KV tile
    ("ragged S=130 d=64", 2, 14, 2, 130, 130, 64, "bfloat16", True, None),
    ("ragged S=1000 d=64", 2, 14, 2, 1000, 1000, 64, "bfloat16", True, None),
    ("ragged S=130 d=128", 2, 16, 8, 130, 130, 128, "bfloat16", True, None),
    ("ragged S=1000 d=128", 2, 16, 8, 1000, 1000, 128, "bfloat16", True,
     None),
    ("non-causal Sq>Sk d=64", 2, 14, 2, 517, 300, 64, "bfloat16", False,
     None),
    ("non-causal Sq<Sk d=128", 2, 16, 8, 300, 517, 128, "bfloat16", False,
     None),
    ("window 200 d=128", 2, 16, 8, 1000, 1000, 128, "bfloat16", True, 200),
    # the tensor-core route at zamba2-2.7b's d=80 (32 heads) and kimi-k2's
    # d=112 (GQA 64 / 8), whose last 64-column panel runs past d: ragged
    # tiles, Sq != Sk, a window edge inside a KV tile
    ("zamba2-2.7b d=80", 1, 32, 32, 512, 512, 80, "bfloat16", True, None),
    ("kimi-k2 d=112", 1, 64, 8, 512, 512, 112, "bfloat16", True, None),
    ("ragged S=130 d=80", 2, 32, 32, 130, 130, 80, "bfloat16", True, None),
    ("ragged S=1000 d=80", 1, 32, 32, 1000, 1000, 80, "bfloat16", True,
     None),
    ("ragged S=130 d=112", 2, 64, 8, 130, 130, 112, "bfloat16", True, None),
    ("ragged S=1000 d=112", 1, 64, 8, 1000, 1000, 112, "bfloat16", True,
     None),
    ("non-causal Sq>Sk d=80", 1, 32, 32, 517, 300, 80, "bfloat16", False,
     None),
    ("non-causal Sq<Sk d=80", 1, 32, 32, 300, 517, 80, "bfloat16", False,
     None),
    ("non-causal Sq>Sk d=112", 1, 64, 8, 517, 300, 112, "bfloat16", False,
     None),
    ("non-causal Sq<Sk d=112", 1, 64, 8, 300, 517, 112, "bfloat16", False,
     None),
    ("window 200 d=80", 1, 32, 32, 1000, 1000, 80, "bfloat16", True, 200),
    ("window 200 d=112", 1, 64, 8, 1000, 1000, 112, "bfloat16", True, 200),
    # the TF32 route (float32, d in 64, 128; "window 128", "non-causal" and
    # "ragged S=1000" above take it too): the qwen2-0.5b prefill, ragged
    # tiles, a window edge inside a KV tile, non-causal Sq != Sk, GQA 14 / 2
    ("qwen2-0.5b prefill f32", 4, 14, 2, 4096, 4096, 64, "float32", True,
     None),
    ("f32 ragged S=130 d=64", 2, 14, 2, 130, 130, 64, "float32", True, None),
    ("f32 ragged S=130 d=128", 2, 16, 8, 130, 130, 128, "float32", True,
     None),
    ("f32 ragged S=1000 d=128", 2, 16, 8, 1000, 1000, 128, "float32", True,
     None),
    ("f32 window 200 d=64", 2, 14, 2, 1000, 1000, 64, "float32", True, 200),
    ("f32 window 200 d=128", 2, 16, 8, 1000, 1000, 128, "float32", True,
     200),
    ("f32 non-causal Sq>Sk d=64", 2, 14, 2, 517, 300, 64, "float32", False,
     None),
    ("f32 non-causal Sq<Sk d=128", 2, 16, 8, 300, 517, 128, "float32",
     False, None),
    # the head dims that took the CUDA-core kernel before every (dtype, d)
    # had a tensor-core route: the TF32 route at d 16 and 32 (the smoke
    # configs'), 80 (zamba2-2.7b, 32 heads), 112 (kimi-k2, 64 over 8) and
    # 256 ("mqa d=256" above takes it too), the tensor-core route at d 16
    # ("ragged S=19" above), 32 and 256: ragged tiles with GQA, a window
    # edge inside a KV tile, non-causal Sq != Sk
    ("f32 ragged S=1000 d=16", 2, 14, 2, 1000, 1000, 16, "float32", True,
     None),
    ("f32 window 200 d=16", 2, 14, 2, 1000, 1000, 16, "float32", True, 200),
    ("f32 non-causal Sq>Sk d=16", 2, 14, 2, 517, 300, 16, "float32", False,
     None),
    ("f32 ragged S=1000 d=32", 2, 14, 2, 1000, 1000, 32, "float32", True,
     None),
    ("f32 window 200 d=32", 2, 14, 2, 1000, 1000, 32, "float32", True, 200),
    ("f32 non-causal Sq<Sk d=32", 2, 14, 2, 300, 517, 32, "float32", False,
     None),
    ("f32 ragged S=1000 d=80", 1, 32, 32, 1000, 1000, 80, "float32", True,
     None),
    ("f32 window 200 d=80", 1, 32, 32, 1000, 1000, 80, "float32", True, 200),
    ("f32 non-causal Sq>Sk d=80", 1, 32, 32, 517, 300, 80, "float32", False,
     None),
    ("f32 ragged S=1000 d=112", 1, 64, 8, 1000, 1000, 112, "float32", True,
     None),
    ("f32 window 200 d=112", 1, 64, 8, 1000, 1000, 112, "float32", True,
     200),
    ("f32 non-causal Sq<Sk d=112", 1, 64, 8, 300, 517, 112, "float32",
     False, None),
    ("f32 ragged S=1000 d=256", 2, 8, 1, 1000, 1000, 256, "float32", True,
     None),
    ("f32 window 200 d=256", 2, 8, 2, 1000, 1000, 256, "float32", True,
     200),
    ("f32 non-causal Sq>Sk d=256", 2, 8, 1, 517, 300, 256, "float32", False,
     None),
    ("ragged S=1000 d=16", 2, 14, 2, 1000, 1000, 16, "bfloat16", True, None),
    ("window 200 d=16", 2, 14, 2, 1000, 1000, 16, "bfloat16", True, 200),
    ("non-causal Sq<Sk d=16", 2, 14, 2, 300, 517, 16, "bfloat16", False,
     None),
    ("ragged S=1000 d=32", 2, 14, 2, 1000, 1000, 32, "bfloat16", True, None),
    ("window 200 d=32", 2, 14, 2, 1000, 1000, 32, "bfloat16", True, 200),
    ("non-causal Sq>Sk d=32", 2, 14, 2, 517, 300, 32, "bfloat16", False,
     None),
    ("ragged S=1000 d=256", 2, 8, 1, 1000, 1000, 256, "bfloat16", True,
     None),
    ("window 200 d=256", 2, 8, 2, 1000, 1000, 256, "bfloat16", True, 200),
    ("non-causal Sq<Sk d=256", 2, 8, 1, 300, 517, 256, "bfloat16", False,
     None),
]
# |got - plain| <= atol + rtol * |plain|.  float32: 2e-5 both, the JAX
# kernel tests' own.  bfloat16: both compute in float32 and round once to
# bfloat16, so where the two float32 results straddle a rounding boundary
# they land one bfloat16 step apart, at most 2**-7 of the value; the atol,
# 1e-3 of the output's largest value, covers float32 summation noise at
# outputs near 0.  Such straddles are rare, so at most 1 % of the bfloat16
# outputs may differ at all: a rounding fault, which stays within one step,
# moves about half of them.  (3e-2, the JAX tests' bfloat16 tolerance, is
# several times a typical output here and would pass a wrong kernel.)
FLASH_TOL = {"float32": {"rtol": 2e-5, "atol": 2e-5},
             "bfloat16": {"rtol": 2 ** -7, "atol_of_max": 1e-3,
                          "differing_share": 0.01}}
# q, k, v scales: scores of std 3 (q 3, k 1) make the softmax peaked, a
# handful of keys carrying each row, so a fault in the running max, the
# scale, the mask or one KV tile moves the output by the size of v
FLASH_QKV_SCALE = (3.0, 1.0, 1.0)
# qwen2-0.5b: 24 layers, 14 heads; the full-width GPU-vs-CPU check's
# float32 tolerance (phase 15): the same float32 operations summed in
# another order by cuBLAS and the CPU's BLAS, through 24 layers
QWEN_LAYERS, QWEN_HEADS = 24, 14
FULL_WIDTH_F32_TOL = 1e-4
KV_MASS_TOL = 5e-4          # bf16 smoke model, GPU vs CPU (phase 16)
# phase 17's causal prefill shapes at S=4096: (label, B, H, KVH, d)
FLASH_TIME_SHAPES = (("qwen2-0.5b", 4, 14, 2, 64),
                     ("internlm2-1.8b", 2, 16, 8, 128))
# phase 17's shapes of the (dtype, d) that took the CUDA-core kernel before
# every one had a tensor-core route, causal at S=4096: (label, B, H, KVH, d,
# dtypes); zamba2-2.7b's and kimi-k2's prefill in float32, qwen2-0.5b's
# heads at the smoke configs' d 16 and 32, phase 13's MQA heads at d 256
ROW5B_TIME_SHAPES = (
    ("zamba2-2.7b", 4, 32, 32, 80, ("float32",)),
    ("kimi-k2", 2, 64, 8, 112, ("float32",)),
    ("qwen2-0.5b heads", 4, 14, 2, 16, ("bfloat16", "float32")),
    ("qwen2-0.5b heads", 4, 14, 2, 32, ("bfloat16", "float32")),
    ("mqa d=256", 2, 8, 1, 256, ("bfloat16", "float32")))
# the CUDA-core kernel's time at the qwen2-0.5b shape in bfloat16, before
# bfloat16 at d=64 moved to the tensor cores (PERF.md's kernel table; NVIDIA
# H100 80GB HBM3, 700 W)
CUDA_CORE_BF16_QWEN_MS = 4.216
# The three redesigned kernels' times at phase 12's shapes before their
# redesign for the card (PERF.md's kernel table; NVIDIA H100 80GB HBM3,
# 700 W).  hist_select's and embedding_bag's were taken before time_ms
# waited behind a spin of the card.  embedding_bag's was taken on an
# earlier lookup draw (the row within a page came from the generator the
# earlier phases share; now from a seed of its own), so the per-bag route
# timed in turns beside the tiled one is the comparison on the same draw.
# observe_scatter's is the kernel from before it summed a block's ids on
# chip, on phase 12's draw, timed in turns with the new one by this
# time_ms; BEFORE_NO_SPIN_MS is the figure taken earlier without the spin,
# printed beside it since the two methods give different times.
BEFORE_MS = {"hist_select": 0.524, "embedding_bag": 0.431,
             "observe_scatter": 0.1713}
BEFORE_NO_SPIN_MS = {"observe_scatter": 0.143}


def qkv(dev, seed: int, b, h, kvh, sq, sk, d, dtype):
    """Random (B*H, Sq, d) q and (B*KVH, Sk, d) k, v on the card, scaled
    by FLASH_QKV_SCALE."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = getattr(torch, dtype)
    return [(torch.randn(shape, generator=gen, device=dev) * scale).to(dt)
            for shape, scale in zip(((b * h, sq, d), (b * kvh, sk, d),
                                     (b * kvh, sk, d)), FLASH_QKV_SCALE)]


def flash_allowed(ref, dtype: str):
    """FLASH_TOL's bound on |got - ref|, elementwise."""
    tol = FLASH_TOL[dtype]
    ref = ref.float().abs()
    atol = tol.get("atol", tol.get("atol_of_max", 0.0) * float(ref.max()))
    return atol + tol["rtol"] * ref


def flash_verdict(got, ref, dtype: str):
    """(max |got - ref|, [the largest |err| / FLASH_TOL's bound, the share
    of outputs that differ at all], whether both are within FLASH_TOL)."""
    diff = (got.float() - ref.float()).abs()
    share = [float((diff / flash_allowed(ref, dtype)).max()),
             float((diff > 0).float().mean())]
    return float(diff.max()), share, (
        share[0] <= 1.0
        and share[1] <= FLASH_TOL[dtype].get("differing_share", 1.0))


def check_flash_attention(dev, plain):
    """Phase 13: flash_attention == plain within FLASH_TOL at every case,
    each on the route ``kernel.route`` names, and the CUDA-core kernel,
    named through ``kernel._launch``, on every case whose (dtype, d) it
    takes (float32 at every d, bfloat16 at 16, 32, 80, 112 and 256);
    returns ({label: max abs err}, {label: [the largest |err| / allowed,
    the share of outputs that differ at all]}, {label: route}, {label: the
    named CUDA-core kernel's max abs err})."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    errs, shares, routes, cuda_core = {}, {}, {}, {}
    for i, (label, b, h, kvh, sq, sk, d, dtype, causal, window) in enumerate(
            FLASH_CASES):
        q, k, v = qkv(dev, 10 + i, b, h, kvh, sq, sk, d, dtype)
        kw = dict(q_per_kv=h // kvh, causal=causal, window=window)
        routes[label] = fa_kernel.route(q.dtype, d)
        before = fa_kernel.ROUTE_LAUNCHES[routes[label]]
        got = flash_attention(q, k, v, **kw)
        if fa_kernel.ROUTE_LAUNCHES[routes[label]] != before + 1:
            fail(f"flash_attention ({label}) did not launch its "
                 f"{routes[label]} kernel")
        ref = flash_attention(q, k, v, backend=plain, **kw)
        torch.cuda.synchronize()
        errs[label], shares[label], ok = flash_verdict(got, ref, dtype)
        if not (got.dtype == q.dtype and got.shape == q.shape and ok):
            fail(f"flash_attention differs from its plain version ({label}, "
                 f"{dtype}, max abs err {errs[label]}, largest share of the "
                 f"tolerance and share of outputs that differ "
                 f"{shares[label]}, {FLASH_TOL[dtype]})")
        if d in fa_kernel._CUDA_CORE_HEAD_DIMS[q.dtype]:
            old = fa_kernel._launch("cuda_core", q, k, v, **kw)
            torch.cuda.synchronize()
            cuda_core[label], old_share, ok = flash_verdict(old, ref, dtype)
            if not ok:
                fail(f"the CUDA-core kernel named on {label} differs from "
                     f"the plain version (max abs err {cuda_core[label]}, "
                     f"{old_share})")
            del old
        del q, k, v, got, ref
    free_device_memory()
    return errs, shares, routes, cuda_core


def full_width_gpu_vs_cpu(rng, zero_counts, read_routes):
    """Phase 15: one prefill (B=2, 64 tokens) and one decode step of the
    full-width qwen2-0.5b on the GPU (with no host sync inside) and on the
    CPU, same weights (drawn on the CPU) and tokens.  On the GPU each
    dtype's prefill is a path: one flash_attention launch per layer, on
    the TF32 route in float32 and on the tensor cores in bfloat16, none in
    decode.  -> ({dtype: {logits/decode_logits/mass: max abs err}},
    {dtype: flash_attention's launches by route})."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serve import engine
    base = get_config("qwen2-0.5b")
    toks = rng.integers(0, base.vocab_size, (2, 64))
    nxt = rng.integers(0, base.vocab_size, (2,))
    errs, routes = {}, {}
    for act in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(base, activ_dtype=act)
        name = str(act).split(".")[-1]
        out = {}
        for d in ("cuda", "cpu"):
            params = init_params(cfg, 0, d)
            t_toks, t_nxt = (torch.from_numpy(x).to(d) for x in (toks, nxt))
            # on the card, prefill and decode must not stall the host:
            # set_sync_debug_mode raises on any synchronizing call inside
            if d == "cuda":
                zero_counts()
                torch.cuda.set_sync_debug_mode("error")
            try:
                logits, cache = engine.prefill(params, cfg, tokens=t_toks,
                                               max_len=80)
                dec, _, aux = engine.decode_step(params, cfg, cache, t_nxt,
                                                 page_size=16)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if d == "cuda":
                routes[name] = read_routes()
                want = "tf32x3" if act == torch.float32 else "tensor_core"
                if routes[name] != {r: QWEN_LAYERS if r == want else 0
                                    for r in routes[name]}:
                    fail(f"full-width {name} prefill + decode launches "
                         f"{routes[name]}: expected {QWEN_LAYERS} "
                         f"flash_attention on the {want} route")
            out[d] = [t.float().cpu() for t in
                      (logits, dec, aux["kv_page_mass"])]
            del params, cache
        free_device_memory()
        errs[name] = {}
        for key, g, c in zip(("logits", "decode_logits", "kv_page_mass"),
                             out["cuda"], out["cpu"]):
            if not bool(torch.isfinite(g).all()):
                fail(f"full-width {name} {key} on the GPU is not finite")
            diff = (g - c).abs()
            errs[name][key] = float(diff.max())
            if act == torch.float32 and not bool(torch.all(
                    diff <= FULL_WIDTH_F32_TOL * (1 + c.abs()))):
                fail(f"full-width float32 {key} GPU vs CPU: max abs err "
                     f"{errs[name][key]} over {FULL_WIDTH_F32_TOL}")
        np.testing.assert_allclose(
            out["cuda"][2].sum(-1).numpy(), QWEN_HEADS, rtol=1e-3)
    return errs, routes


def serve_full_width(serve_launcher, dev, zero_counts, read_counts,
                     read_routes) -> dict:
    """Phase 14: the launcher at qwen2-0.5b's full width, prompt 64, then
    4096, then 64 again warm; each run makes exactly one flash_attention
    launch per layer (its one prefill), all on the tensor-core route, and
    none in decode.  Returns the first run's launch counts (the main
    path's)."""
    import torch
    serve_args = ["--arch", "qwen2-0.5b", "--batch", "4", "--prompt-len",
                  "64", "--gen", "32", "--page-size", "16"]
    runs = {}
    for plen in ("64", "4096", "64"):
        args = list(serve_args)
        args[args.index("--prompt-len") + 1] = plen
        free_device_memory()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        t0 = time.perf_counter()
        rep = serve_launcher.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, routes = read_counts(), read_routes()
        if launches != {"observe_scatter": 0, "hist_select": 0,
                        "gather_count": 0, "embedding_bag": 0,
                        "flash_attention": QWEN_LAYERS} or routes != {
                            "tensor_core": QWEN_LAYERS, "tf32x3": 0,
                            "cuda_core": 0}:
            fail(f"serve --prompt-len {plen} launches {launches}, routes "
                 f"{routes}: expected {QWEN_LAYERS} flash_attention (one "
                 f"prefill, one per layer, on the tensor cores) and none in "
                 f"decode")
        pm = rep["page_mass"]
        want_mass = 31 * QWEN_LAYERS * 4 * QWEN_HEADS   # heads per step
        if not (rep["tokens"].shape == (4, 32)
                and pm.shape == (-(-(int(plen) + 32) // 16),)
                and abs(pm.sum() - want_mass) <= 1e-3 * want_mass):
            fail(f"serve --prompt-len {plen} report out of range")
        key = plen if plen not in runs else plen + "_warm"
        runs[key] = dict(
            launches=launches, flash_attention_routes=routes, wall_s=wall,
            prefill_s=rep["prefill_s"],
            prefill_tok_s=rep["prefill_tok_s"], decode_s=rep["decode_s"],
            decode_tok_s=rep["decode_tok_s"],
            pages_for_90pct=rep["pages_for_90pct"],
            covered_25pct=float(rep["covered_25pct"]),
            peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        say("serve", prompt_len=int(plen), run=key, **runs[key])
    return runs["64"]["launches"]


def profiled_steps(step, steps: int) -> dict:
    """``step()`` run ``steps`` times under ``torch.profiler``: the wall
    and device busy time (kernel and copy events) per step, the idle
    share, device events per step, host-to-device copies and the ops that
    take the most device and host time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us, host_us, n_dev, h2d = {}, {}, 0, 0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if ev.device_type == DeviceType.CUDA:
            n_dev += ev.count
            if "HtoD" in ev.key:
                h2d += ev.count
            if us > 0:
                dev_us[ev.key] = dev_us.get(ev.key, 0.0) + us
        elif ev.self_cpu_time_total > 0:
            host_us[ev.key] = host_us.get(ev.key, 0.0) + ev.self_cpu_time_total
    busy = sum(dev_us.values()) / 1e6
    return dict(steps=steps, step_wall_ms=1e3 * wall / steps,
                step_device_busy_ms=1e3 * busy / steps,
                device_idle_share=1.0 - busy / wall,
                device_events_per_step=n_dev / steps,
                host_to_device_copies=h2d,
                top_device_ms=top_ms(dev_us, 8, 60),
                top_host_self_ms=top_ms(host_us, 8, 60))


def top_ms(table: dict, n: int, width: int) -> dict:
    """The ``n`` largest entries of {name: microseconds} in milliseconds,
    names cut to ``width`` characters (entries whose cut names agree add
    up under it)."""
    ms = {}
    for key, us in table.items():
        ms[key[:width]] = ms.get(key[:width], 0.0) + us / 1e3
    return dict(sorted(ms.items(), key=lambda kv: -kv[1])[:n])


def profile_decode(dev, steps: int = 8) -> dict:
    """Phase 14, where a serving step's time goes: the full-width
    qwen2-0.5b (bf16, batch 4, prompt 64) decodes ``steps`` tokens under
    ``torch.profiler`` (``profiled_steps``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serve import engine
    cfg = get_config("qwen2-0.5b")
    params = init_params(cfg, 0, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen,
                         device=dev)
    logits, cache = engine.prefill(params, cfg, tokens=toks,
                                   max_len=64 + steps + 2)
    tok = torch.argmax(logits, -1)
    _, cache, _ = engine.decode_step(params, cfg, cache, tok, page_size=16)
    out = profiled_steps(decode_steps(params, cfg, cache, tok,
                                      page_size=16), steps)
    say("serve_decode_profile", **out)
    del params, cache
    free_device_memory()
    return out


def decode_steps(params, cfg, cache, tok, **kw):
    """A step function for ``profiled_steps``: each call decodes one token
    greedily from the last, carrying the cache."""
    import torch
    from repro_torch.serve import engine
    state = {"cache": cache, "tok": tok}

    def step():
        logits, state["cache"], _ = engine.decode_step(
            params, cfg, state["cache"], state["tok"], **kw)
        state["tok"] = torch.argmax(logits, -1)
    return step


def kv_gpu_vs_cpu(KVCacheScenario, run_scenario, zero_counts, read_counts,
                  read_routes) -> dict:
    """Phase 16: ``KVCacheScenario()`` (internlm2-1.8b smoke) on the GPU vs
    the CPU: one prefill = n_layers flash_attention launches (bfloat16 at
    d=16: the tensor-core route), decode masses within KV_MASS_TOL, and
    the GPU's
    ``run_scenario`` fed the CPU's stream byte-identical to the CPU's for
    hints on x sync_every in {1, 4}.  Returns the prefill's launches by
    route."""
    import numpy as np
    t0 = time.perf_counter()
    zero_counts()
    kv_gpu = KVCacheScenario()
    gpu_epochs = list(kv_gpu.epochs())
    prefill_launches, prefill_routes = read_counts(), read_routes()
    n_layers = kv_gpu.cfg.n_layers
    want_routes = fa_routes(kv_gpu.cfg.activ_dtype, kv_gpu.cfg.head_dim,
                            n_layers)
    if prefill_launches != {"observe_scatter": 0, "hist_select": 0,
                            "gather_count": 0, "embedding_bag": 0,
                            "flash_attention": n_layers} or prefill_routes \
            != want_routes:
        fail(f"KVCacheScenario launches {prefill_launches}, routes "
             f"{prefill_routes}: expected {n_layers} flash_attention (one "
             f"prefill), {want_routes}")
    kv_cpu = KVCacheScenario(device="cpu")
    cpu_epochs = list(kv_cpu.epochs())
    mass_err = float(np.abs(kv_gpu.masses - kv_cpu.masses).max())
    if mass_err > KV_MASS_TOL:
        fail(f"KV decode masses GPU vs CPU: max abs err {mass_err}")
    # informational: the GPU's own quantization of its (tolerance-close)
    # masses against the CPU's — a last-bit difference can flip a
    # largest-remainder rounding
    moved = changed = 0
    for ge, ce in zip(gpu_epochs, cpu_epochs):
        for gr, cr in zip(ge, ce):
            diff = np.abs(np.bincount(gr, minlength=kv_gpu.n_blocks)
                          - np.bincount(cr, minlength=kv_gpu.n_blocks))
            changed += int((diff > 0).sum())
            moved += int(diff.sum()) // 2
    zero_counts()
    for k in (1, 4):
        g = run_scenario(kv_gpu, hints=True, sync_every=k, epochs=cpu_epochs)
        c = run_scenario(kv_cpu, hints=True, sync_every=k, epochs=cpu_epochs,
                         device="cpu")
        if json.dumps(g, sort_keys=True) != json.dumps(c, sort_keys=True):
            fail(f"KV trajectory differs GPU vs CPU (hints, sync_every={k})")
    run_launches = read_counts()
    if not (run_launches["observe_scatter"] > 0
            and run_launches["hist_select"] > 0):
        fail(f"KV run_scenario launches {run_launches}")
    say("kv_cache", n_blocks=kv_gpu.n_blocks, k_hot=kv_gpu.k_hot,
        prefill_launches=prefill_launches,
        prefill_flash_attention_routes=prefill_routes,
        run_launches=run_launches,
        mass_max_abs_err=mass_err, mass_tolerance=KV_MASS_TOL,
        trajectories_identical=True, gpu_quantization_counts_changed=changed,
        gpu_quantization_accesses_moved=moved,
        accesses=kv_gpu.n_steps * kv_gpu.accesses_per_batch,
        seconds=time.perf_counter() - t0)
    return prefill_routes


def flash_attention_time(dev, plain, label: str, b: int, h: int, kvh: int,
                         d: int, dtype: str = "bfloat16",
                         s_len: int = 4096, window=None) -> dict:
    """Phase 17: flash_attention at a causal prefill shape beside its plain
    version, ``F.scaled_dot_product_attention`` (timed in this call) and the
    bound: the function's products, 2*B*H*S^2*d over the causal half, at
    the card's peak for the dtype, or q, k, v and the output moved once.
    In bfloat16 that is the dense bf16 tensor-core rate (the tensor-core
    route does 1.5x those products: P.V twice, as P_hi and P_lo; at d 80
    and 112 its products stay d wide); the kernel's own floor, its products
    at that rate, is reported beside it.  In float32 it is three TF32
    products for each (lo.hi + hi.lo + hi.hi, the least that keeps float32
    accuracy) at the dense TF32 rate, which the TF32 route does.  Every
    (dtype, d) that the CUDA-core kernel takes (float32 at every d, bfloat16
    at 16, 32, 80, 112 and 256) is also timed in turns with that kernel,
    named through ``kernel._launch``, on the same input, whose own bound is
    the products at the CUDA cores' float32 rate.  TFLOP/s are given on the
    function's work and on the kernel's, and the softmax's exponentials (one
    a kept (query, key) pair) a second.  ``window`` is the model's sliding window (one of at
    least ``s_len`` masks nothing beyond the causal mask, so
    ``scaled_dot_product_attention(is_causal=True)`` is the same function).
    The kernel's output is held against the plain version's within
    FLASH_TOL on this input."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    q, k, v = qkv(dev, 99, b, h, kvh, s_len, s_len, d, dtype)
    route = fa_kernel.route(q.dtype, d)
    if window is not None and window < s_len:
        fail(f"flash_attention_time: window {window} < S {s_len} is not "
             f"the causal function sdpa computes")
    kw = dict(q_per_kv=h // kvh, window=window)
    ms, plain_ms = in_turns(
        lambda: flash_attention(q, k, v, backend=plain, **kw),
        lambda: flash_attention(q, k, v, **kw), 5)
    got = flash_attention(q, k, v, **kw)
    ref = flash_attention(q, k, v, backend=plain, **kw)
    err, share, ok = flash_verdict(got, ref, dtype)
    checked = dict(max_abs_err=err, share_of_tolerance=share[0],
                   differing_share=share[1])
    if not ok:
        fail(f"flash_attention differs from its plain version at the "
             f"{label} prefill shape ({dtype}): {checked}")
    del got, ref
    free_device_memory()
    q4, k4, v4 = (x.view(b, -1, s_len, d) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_ms = time_ms(lambda: sdpa(q4, k4, v4, is_causal=True,
                                   enable_gqa=True), 5)
    sdpa_err = float((sdpa(q4, k4, v4, is_causal=True, enable_gqa=True)
                      .reshape(q.shape).float()
                      - flash_attention(q, k, v, **kw).float())
                     .abs().max())
    flops = 2 * b * h * s_len * s_len * d
    # (the kernel's products, the fewest products the function needs at
    # that rate: three TF32 ones for each float32 one, the rate)
    products, needed, rate = {
        "tensor_core": (1.5, 1, TENSOR_BF16_OPS_PER_S),
        "tf32x3": (3, 3, TENSOR_TF32_OPS_PER_S)}[route]
    kernel_flops = int(flops * products)
    n_bytes = q.element_size() * (2 * b * h * s_len * d
                                  + 2 * b * kvh * s_len * d)
    kernel_floor = kernel_flops / rate * 1e3
    exps = b * h * fa_kernel.kept_pairs(s_len, s_len, True, window)
    if dtype == "bfloat16":
        # the card's least time for bf16 products is on the tensor cores,
        # whichever route the kernel takes
        rate = TENSOR_BF16_OPS_PER_S
    bound, by = bound_ms(n_bytes, flops * needed, rate)
    out = dict(label=label, shape=[b, h, kvh, s_len, d], dtype=dtype,
               window=window, **checked,
               route=route, ms=ms, plain_ms=plain_ms, sdpa_ms=sdpa_ms,
               ms_over_sdpa_ms=ms / sdpa_ms, bound_ms=bound, bound_by=by,
               share_of_bound=bound / ms,
               causal_flops=flops, kernel_flops=kernel_flops, bytes=n_bytes,
               function_tflop_s=flops / ms / 1e9,
               kernel_tflop_s=kernel_flops / ms / 1e9,
               kernel_floor_ms=kernel_floor, exps=exps,
               exps_per_s=exps / ms * 1e3,
               vs_sdpa_max_abs_err=sdpa_err)
    if (label, dtype) == ("qwen2-0.5b", "bfloat16"):
        out.update(cuda_core_bf16_ms=CUDA_CORE_BF16_QWEN_MS,
                   speedup_over_cuda_core=CUDA_CORE_BF16_QWEN_MS / ms)
    if d in fa_kernel._CUDA_CORE_HEAD_DIMS[q.dtype]:
        ms_beside, cc_ms = in_turns(
            lambda: fa_kernel._launch("cuda_core", q, k, v, **kw),
            lambda: flash_attention(q, k, v, **kw), 5)
        cc_bound, cc_by = bound_ms(n_bytes, flops)
        out.update(cuda_core_ms=cc_ms, ms_in_turns_with_cuda_core=ms_beside,
                   speedup_over_cuda_core=cc_ms / ms_beside,
                   cuda_core_bound_ms=cc_bound, cuda_core_bound_by=cc_by)
    if route == "tf32x3":
        out.update(blocks_per_sm=fa_kernel.tf32x3_blocks_per_sm(d))
    say("flash_attention_time", **out)
    del q, k, v, q4, k4, v4
    free_device_memory()
    return out


_PARENT_LIBS: dict = {}


def parent_flash_library(parent_csrc: Path):
    """(library, new_abi): ``parent_csrc``, an earlier ``csrc/`` of
    flash_attention (e.g. ``git archive <commit>
    src/repro_torch/kernels/flash_attention/csrc``, unpacked under the
    git-ignored ``build/``), built here once with ``_build.NVCC_FLAGS`` and
    bound with ctypes.  ``new_abi``: its launchers take the saved lse (and
    bf16 float32 output) and its backward takes them (the ABI since the
    forward saves its lse); before that the forward launchers took neither
    and the backward recomputed them from q, k, v and dO."""
    import ctypes
    from repro_torch.kernels import _build
    key = str(parent_csrc)
    if key in _PARENT_LIBS:
        return _PARENT_LIBS[key]
    lib_path = ROOT / "build" / "parent_flash" / "flash_attention.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    # -fno-gnu-unique: the launchers' function-local statics (the shared
    # memory opt-in done once) would otherwise bind to this build's, loaded
    # first, and the other build's kernels would launch without opting in
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xcompiler",
                    "-fno-gnu-unique", "-o", str(lib_path),
                    str(parent_csrc / "flash_attention.cu")], check=True,
                   capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(lib_path))
    new_abi = "void* lse" in (parent_csrc / "flash_attention.cu").read_text()
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    common = [P, P, P, P, LL, LL, LL, I, I, I, I, ctypes.c_float]
    lib.flash_attention_wgmma_launch.argtypes = common + (
        [P, P, P] if new_abi else [P])
    lib.flash_attention_tf32x3_launch.argtypes = common + (
        [P, P] if new_abi else [P])
    for fn in (lib.flash_attention_bwd_launch,
               lib.flash_attention_bwd_tf32x3_launch):
        fn.argtypes = ([P] * 12 + [LL] * 3 + [I] * 4 + [ctypes.c_float, LL, P]
                       if new_abi else
                       [P] * 10 + [LL] * 3 + [I] * 4 + [ctypes.c_float, P])
    for fn in (lib.flash_attention_wgmma_launch,
               lib.flash_attention_tf32x3_launch,
               lib.flash_attention_bwd_launch,
               lib.flash_attention_bwd_tf32x3_launch):
        fn.restype = I
    _PARENT_LIBS[key] = (lib, new_abi, lib_path)
    return _PARENT_LIBS[key]


def flash_parent_in_turns(dev, plain, parent_csrc: Path) -> dict:
    """The forward in turns with a build of other sources of the same
    kernels (``parent_flash_library``), causal: the tensor-core route
    (bfloat16) and the TF32 route (float32) at FLASH_TIME_SHAPES (S 4,096;
    rows 5 and 5c), the tensor-core route at ZAMBA2_TIME_SHAPE and
    KIMI_TIME_SHAPE (rows 5z and 5k), the TF32 route at ROW5B_TIME_SHAPES'
    float32 ones (row 5b), no lse asked of either, as in serving; and at
    qwen2-0.5b's training shape (S 2,048, bfloat16, row 5t) this build's
    saving forward (``return_lse``: the lse and the float32
    output written too, FlashAttentionFn's) against the other's forward as
    FlashAttentionFn ran it there (with the lse, where its ABI takes one).
    Order: other, this, this, other; both outputs within FLASH_TOL of the
    plain version.  Also whether the two builds' SASS of the d 64 and 128
    instantiations is the same, instruction for instruction."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    lib, new_abi, lib_path = parent_flash_library(parent_csrc)

    def parent(q, k, v, q_per_kv, saving=False):
        bh, sq, d = q.shape
        out = torch.empty_like(q)
        bf16 = q.dtype == torch.bfloat16
        fn = (lib.flash_attention_wgmma_launch if bf16
              else lib.flash_attention_tf32x3_launch)
        extra = ()
        if new_abi:
            lse, out32 = fa_kernel._saved(out) if saving else (None, None)
            extra = (None if lse is None else lse.data_ptr(),) + (
                (None if out32 is None else out32.data_ptr(),) if bf16 else ())
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                bh, sq, k.shape[1], d, q_per_kv, 1, -1, d ** -0.5, *extra,
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            fail(f"the other build's flash_attention launch failed: {rc}")
        return out

    cases = [(label, b, h, kvh, d, dtype, 4096, False)
             for label, b, h, kvh, d in FLASH_TIME_SHAPES
             for dtype in ("bfloat16", "float32")]
    cases += [(label, b, h, kvh, d, "bfloat16", 4096, False)
              for label, b, h, kvh, d in (ZAMBA2_TIME_SHAPE, KIMI_TIME_SHAPE)]
    cases += [(label, b, h, kvh, d, "float32", 4096, False)
              for label, b, h, kvh, d, dtypes in ROW5B_TIME_SHAPES
              if "float32" in dtypes]
    cases.append(("qwen2-0.5b train, saving", *FLASH_TIME_SHAPES[0][1:],
                  "bfloat16", 2048, True))
    res = {}
    for label, b, h, kvh, d, dtype, s_len, saving in cases:
        q, k, v = qkv(dev, 99, b, h, kvh, s_len, s_len, d, dtype)
        kw = dict(q_per_kv=h // kvh)

        def ours():
            out = flash_attention(q, k, v, return_lse=saving, **kw)
            return out[0] if saving else out
        ms, other_ms = in_turns(lambda: parent(q, k, v, h // kvh, saving),
                                ours, 5)
        ref = flash_attention(q, k, v, backend=plain, **kw)
        errs = []
        for got in (ours(), parent(q, k, v, h // kvh, saving)):
            err, share, ok = flash_verdict(got, ref, dtype)
            if not ok:
                fail(f"flash_attention ({label}, {dtype}) differs from "
                     f"its plain version: {err}, {share}")
            errs.append(err)
        res[f"{label} d={d} {dtype}"] = dict(
            route=fa_kernel.route(q.dtype, d), shape=[b, h, kvh, s_len, d],
            saving=saving, ms=ms, other_ms=other_ms,
            ms_over_other_ms=ms / other_ms, max_abs_err=errs[0],
            other_max_abs_err=errs[1])
        del q, k, v, ref
        free_device_memory()
    ours = _build.library_path("flash_attention")
    same = {}
    for marker in ("fa_wgmma_kernelILi64E", "fa_wgmma_kernelILi128E",
                   "tf32x3_kernelILi64E", "tf32x3_kernelILi128E"):
        a, b_ = sass_text(ours, marker), sass_text(lib_path, marker)
        same[marker] = [len(x) for x in a.values()] + [
            len(x) for x in b_.values()] + [list(a.values())
                                            == list(b_.values())]
    say("flash_parent_in_turns", times=res, sass_lengths_and_same=same)
    return res


def flash_bwd_parent_in_turns(dev, parent_csrc: Path) -> dict:
    """The backward at TRAIN_TIME_SHAPE (qwen2-0.5b's training attention),
    bfloat16 and float32, in turns with the backward of another build
    (``parent_flash_library``): other, this, this, other.  This build's is
    timed from the forward's saved lse and float32 output, as phase 24a's
    time; the other's from what its ABI takes (q, k, v and dO alone before
    the forward saved its lse).  Both within ``grad_verdict`` of
    ``attention_bwd_ref`` on the same input."""
    import torch
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     flash_attention,
                                                     flash_attention_bwd)
    lib, new_abi, _ = parent_flash_library(parent_csrc)
    b, h, kvh, s, d = TRAIN_TIME_SHAPE
    g = h // kvh
    res = {}
    for dtype in dtypes:
        q, k, v = qkv(dev, 250, b, h, kvh, s, s, d, dtype)
        gen = torch.Generator(device=dev)
        gen.manual_seed(350)
        do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        _, lse, o32 = flash_attention(q, k, v, q_per_kv=g, return_lse=True)
        fn = (lib.flash_attention_bwd_launch if dtype == "bfloat16"
              else lib.flash_attention_bwd_tf32x3_launch)
        f32 = dict(dtype=torch.float32, device=dev)

        def parent():
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            tickets = torch.zeros((b * kvh, -(-s // 32)), dtype=torch.int32,
                                  device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            if new_abi:
                pad = -(-s // 128) * 128
                stats = torch.empty((2, b * h, pad), **f32)
                parts = torch.empty((b * h, 2, pad, -(-d // 64) * 64), **f32)
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o32.data_ptr(), do.data_ptr(), lse.data_ptr(),
                        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                        stats.data_ptr(), parts.data_ptr(),
                        tickets.data_ptr(), b * h, s, s, d, g, 1, -1,
                        d ** -0.5, pad, stream)
            else:
                pad = -(-s // 64) * 64
                stats = torch.empty((3, b * h, pad), **f32)
                parts = torch.empty((b * h, 2, pad, d), **f32)
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), stats.data_ptr(), parts.data_ptr(),
                        tickets.data_ptr(), b * h, s, s, d, g, 1, -1,
                        d ** -0.5, stream)
            if rc != 0:
                fail(f"the other build's backward launch failed: {rc}")
            return dq, dk, dv

        def ours():
            return flash_attention_bwd(q, k, v, o32, do, lse, q_per_kv=g)

        ms, other_ms = in_turns(parent, ours, 3)
        want = attention_bwd_ref(q, k, v, do, q_per_kv=g,
                                 block_q=TRAIN_BLOCK_Q)
        errs = {}
        for who, got in (("ms", ours()), ("other_ms", parent())):
            for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
                err, share, ok = grad_verdict(gt, wt, dtype)
                if not ok:
                    fail(f"the backward ({who}, {dtype}) {name} differs from "
                         f"attention_bwd_ref: {err}, {share}")
                errs[f"{who}_{name}"] = [err] + share
        res[dtype] = dict(ms=ms, other_ms=other_ms,
                          ms_over_other_ms=ms / other_ms, errors=errs,
                          other_abi="saved" if new_abi else "recompute")
        del q, k, v, do, lse, o32, want
        free_device_memory()
    say("flash_bwd_parent_in_turns", **res)
    return res


class Replay:
    """A scenario whose ``epochs()`` replays a list made once (set-up, so a
    timed fleet run holds the interleave and the runtime, not the tenants'
    data generation); every other attribute is the scenario's own."""

    def __init__(self, scenario, epochs):
        self._scenario, self._epochs = scenario, epochs

    def __getattr__(self, name):
        return getattr(self._scenario, name)

    def epochs(self):
        return iter(self._epochs)


def fleet_launches(fleet, runs: dict) -> dict:
    """The kernel launches ``runs`` ({capacity: number of runs}) of
    ``fleet``'s geometry make: observe_scatter once a batch row; hist_select
    per epoch the select and the tenants' hot sets, and under quotas also
    the segment mask and the hot set."""
    n_ep, rows = fleet.n_epochs, fleet.batches_per_epoch
    return {"observe_scatter": n_ep * rows * sum(runs.values()),
            "hist_select": sum(n_ep * (2 if cap == "shared" else 4) * n
                               for cap, n in runs.items()),
            "gather_count": 0, "embedding_bag": 0, "flash_attention": 0}


def fleet_mix_streams(sc) -> None:
    """Make the fleet example's model-backed tenant streams once, on the
    card: the KV decode (one prefill) and the MoE tenant's forwards (one a
    batch); every fleet built over ``sc`` replays them."""
    list(sc["kv"].epochs())
    list(sc["moe"].epochs())


# The MoE scenario's stream made on the card against the same scenario's
# on the CPU (phases 18 and 22d), held to tests/test_torch_moe.py's bounds
# for the bfloat16 kimi-k2 smoke model: a routing is a top-k over float32
# probabilities of bf16 activations, and where those differ by a rounding a
# near-tie may fall the other way.  So a batch row lies within an L1
# distance of 2 % of its length of the CPU's, a forward's (L, E) counts
# within 2 % of its routings with the same totals per layer, and its final
# hidden states (6e-2) and logits (1e-2, atol and rtol) within tolerance on
# at least 97 % of the elements.
MOE_STREAM_L1_SHARE = 0.02
MOE_BF16_TOL = {"hidden": 6e-2, "logits": 1e-2}
MOE_BF16_WITHIN = 0.97


def check_moe_stream(gpu, cpu, label: str) -> dict:
    """``gpu``'s expert stream (a MoEExpertScenario on the card) against
    ``cpu``'s (the same scenario on the CPU), row by row; then each token
    batch's forward again on both devices, its counts, hidden states and
    logits compared.  Fails outside the bounds above; returns the
    distances."""
    import numpy as np
    import torch
    from repro_torch.models.model import forward, logits_fn
    g_eps, c_eps = list(gpu.epochs()), list(cpu.epochs())
    if [e.shape for e in g_eps] != [e.shape for e in c_eps]:
        fail(f"{label}: MoE stream shapes differ GPU vs CPU")
    row_l1 = [int(np.abs(np.bincount(gr, minlength=gpu.n_blocks)
                         - np.bincount(cr, minlength=gpu.n_blocks)).sum())
              for ge, ce in zip(g_eps, c_eps) for gr, cr in zip(ge, ce)]
    row_bound = MOE_STREAM_L1_SHARE * gpu.batch_len
    if max(row_l1) > row_bound:
        fail(f"{label}: a MoE stream row lies {max(row_l1)} accesses (L1) "
             f"from the CPU's, above {row_bound}")
    g_par, c_par = gpu.model_params(), cpu.model_params()
    within = dict.fromkeys(MOE_BF16_TOL, 1.0)
    count_l1 = []
    with torch.no_grad():
        for toks in gpu.token_batches():
            tokens = torch.from_numpy(toks)
            gh, g_aux = forward(g_par, gpu.cfg, tokens=tokens.to(gpu.device))
            ch, c_aux = forward(c_par, cpu.cfg, tokens=tokens)
            got = {"hidden": gh, "logits": logits_fn(g_par, gpu.cfg, gh)}
            want = {"hidden": ch, "logits": logits_fn(c_par, cpu.cfg, ch)}
            for part, tol in MOE_BF16_TOL.items():
                g, w = got[part].float().cpu(), want[part].float()
                if g.shape != w.shape or not bool(torch.isfinite(g).all()):
                    fail(f"{label}: the card's forward {part} is not finite "
                         f"or of shape {tuple(w.shape)}")
                ok = (g - w).abs() <= tol + tol * w.abs()
                within[part] = min(within[part], float(ok.float().mean()))
            gc, cc = g_aux["expert_counts"].cpu(), c_aux["expert_counts"]
            if not torch.equal(gc.sum(-1), cc.sum(-1)):
                fail(f"{label}: the forward's per-layer routings differ "
                     f"GPU vs CPU")
            count_l1.append(int((gc - cc).abs().sum()) / int(cc.sum()))
    if max(count_l1) > MOE_STREAM_L1_SHARE or \
            min(within.values()) < MOE_BF16_WITHIN:
        fail(f"{label}: the card's MoE forwards differ from the CPU's: "
             f"counts L1 share {max(count_l1)} (bound "
             f"{MOE_STREAM_L1_SHARE}), elements within tolerance {within} "
             f"(bound {MOE_BF16_WITHIN})")
    return dict(row_l1_max=max(row_l1), row_l1_bound=row_bound,
                rows_changed=sum(d > 0 for d in row_l1),
                accesses_moved=sum(row_l1) // 2, forwards=len(count_l1),
                forward_counts_l1_share_max=max(count_l1),
                hidden_within_share=within["hidden"],
                logits_within_share=within["logits"])


def fleet_mix_gpu_vs_cpu(dev, zero_counts, read_counts,
                         read_routes) -> dict:
    """Phase 18: the example's 4-tenant mix (``repro_torch.examples.
    fleet_mix``: dlrm, kv, moe, scanner; 340 fast slots) on the GPU vs the
    CPU for capacity in {shared, partition, weighted} x sync_every in
    {1, 4}: trajectory, summary and tenant rows identical; then the
    example's own run (shared, weighted and every tenant solo) on the GPU
    inside the reference example's margins.  The KV and MoE tenants'
    streams are made on the GPU once (n_layers flash_attention launches
    for the KV prefill and n_layers for each MoE batch, each on the route
    ``kernel.route`` names) and replayed by every fleet on both devices.
    Returns
    the parity runs' launches."""
    from repro_torch.examples import fleet_mix
    from repro_torch.fleet import run_fleet
    t0 = time.perf_counter()
    zero_counts()
    sc = fleet_mix.make_scenarios(device=dev)
    fleet_mix_streams(sc)
    stream_launches, stream_routes = read_counts(), read_routes()
    moe = sc["moe"]
    n_moe = moe.cfg.n_layers * moe.n_epochs * moe.batches_per_epoch
    n_fa = sc["kv"].cfg.n_layers + n_moe
    want_routes = fa_routes(sc["kv"].cfg.activ_dtype, sc["kv"].cfg.head_dim,
                            sc["kv"].cfg.n_layers)
    for r, n in fa_routes(moe.cfg.activ_dtype, moe.cfg.head_dim,
                          n_moe).items():
        want_routes[r] += n
    if stream_launches["flash_attention"] != n_fa or \
            stream_routes != want_routes:
        fail(f"fleet_mix's KV decode and MoE forwards launch "
             f"{stream_launches}, routes {stream_routes}; expected {n_fa} "
             f"flash_attention, {want_routes}")
    moe_stream = check_moe_stream(
        moe, fleet_mix.make_scenarios(device="cpu")["moe"], "fleet_mix")
    zero_counts()
    for capacity in ("shared", "partition", "weighted"):
        for k in (1, 4):
            out = {d: run_fleet(fleet_mix.fleet(sc, capacity), hints=True,
                                sync_every=k, device=d)
                   for d in (dev, "cpu")}
            for part in ("trajectory", "summary", "tenants"):
                if json.dumps(out[dev][part], sort_keys=True) != json.dumps(
                        out["cpu"][part], sort_keys=True):
                    fail(f"fleet_mix {part} differs GPU vs CPU "
                         f"(capacity={capacity}, sync_every={k})")
    launches = read_counts()
    want = fleet_launches(fleet_mix.fleet(sc, "shared"),
                          {"shared": 2, "partition": 2, "weighted": 2})
    if launches != want:
        fail(f"fleet_mix parity launches {launches}, expected {want}")
    res = fleet_mix.run(device=dev, scenarios=sc)
    margins = fleet_mix.margins_met(res)
    if not all(margins.values()):
        fail(f"fleet_mix margins missed on the GPU: {margins}, coverages "
             f"solo {res['solo_cov']}, shared {res['shared_cov']}, "
             f"weighted {res['fair_cov']}")
    say("fleet_mix", runs=12, identical=True, launches=launches,
        tenants=list(fleet_mix.TENANTS),
        stream_launches=stream_launches, moe_stream_vs_cpu=moe_stream,
        margins=margins,
        solo_cov=res["solo_cov"], shared_cov=res["shared_cov"],
        fair_cov=res["fair_cov"], caps=res["caps"],
        seconds=time.perf_counter() - t0)
    return launches


# phase 19's fleet: 600,000 fast slots against a demand of 748,753 (the
# tenants' hot sets); weighted-fair weights: the DLRM tenant's hot set,
# the KV tenant's k_hot (as in the example) and 60,000 for the scanner
FLEET_K_HOT = 600_000
FLEET_BLOCKS, FLEET_DEMAND = 7_864_408, 748_753
FLEET_WEIGHTS = {"dlrm": float(PAPER_K_HOT), "kv": 22.0, "scanner": 60_000.0}


def check_fleet_records(res: dict, fleet) -> None:
    lanes = res["trajectory"]["lanes"]
    tenants = res["tenants"]
    if sorted(tenants) != sorted(t.name for t in fleet.tenants):
        fail(f"fleet tenants {sorted(tenants)}")
    for name, recs in lanes.items():
        if len(recs) != fleet.n_epochs:
            fail(f"fleet lane {name} has {len(recs)} records")
        for r in recs:
            nums = [v for v in r.values() if isinstance(v, (int, float))]
            if not (all(math.isfinite(v) for v in nums)
                    and 0.0 <= r["accuracy"] <= 1.0
                    and 0.0 <= r["coverage"] <= 1.0
                    and 0 <= r["resident"] <= fleet.k_hot
                    and r["time_s"] > 0):
                fail(f"fleet record out of range {r}")
    for t in tenants.values():
        for lane, recs in t["records"].items():
            if len(recs) != fleet.n_epochs or not all(
                    0.0 <= r["coverage"] <= 1.0 and r["resident"] >= 0
                    and math.isfinite(r["time_s"]) for r in recs):
                fail(f"tenant records out of range ({lane})")


def paper_fleet(dev, plain, spec, DLRMScenario, KVCacheScenario,
                mmap_bench, zero_counts, read_counts) -> dict:
    """Phase 19: a paper-scale fleet at full width — the online path's DLRM
    (5,242,880 pages, 2.4 M lookups a batch, 486,587 hot, stationary), the
    paper's §III.A mmap-bench region (2,621,440 pages, 262,144 hot, 2.4 M
    accesses a batch) and ``KVCacheScenario()`` (88 blocks): 7,864,408
    blocks, 600,000 fast slots, 6 epochs, hints on, sync_every=4, shared
    pool and weighted-fair quotas, each under ``set_sync_debug_mode(
    "error")``; launches, record pulls and the DLRM quota checked.  Then
    the weighted run warm, three times (the epoch wall and the host
    interleave's share of it), once under ``torch.profiler`` (the device's
    idle share), and hist_select's segment call on key rows from the
    fleet's stream (U=5 x 7,864,408 keys, S=3) timed beside its plain
    version, its bound and ``torch.topk`` on each segment's slice."""
    import numpy as np
    import torch
    from repro_torch.core import runtime
    from repro_torch.fleet import FleetScenario, TenantSpec, run_fleet
    from repro_torch.kernels.hist_select import kth_key
    from repro_torch.scenarios import MmapBenchScenario

    t0 = time.perf_counter()
    dlrm = DLRMScenario(spec=spec, n_epochs=6, batches_per_epoch=2,
                        shift_at=0, k_hot=PAPER_K_HOT)
    scanner = MmapBenchScenario(spec=mmap_bench.PAPER, n_epochs=6,
                                batches_per_epoch=2,
                                accesses_per_batch=2_400_000)
    kv = KVCacheScenario(device=dev)
    tenants = [TenantSpec(Replay(s, list(s.epochs())), weight=w, name=n)
               for s, n, w in ((dlrm, "dlrm", FLEET_WEIGHTS["dlrm"]),
                               (kv, "kv", FLEET_WEIGHTS["kv"]),
                               (scanner, "scanner",
                                FLEET_WEIGHTS["scanner"]))]
    fleets = {cap: FleetScenario(tenants, k_hot=FLEET_K_HOT, capacity=cap)
              for cap in ("shared", "weighted")}
    fleet = fleets["weighted"]
    if (fleet.n_blocks != FLEET_BLOCKS
            or sum(fleet.tenancy.hot_k) != FLEET_DEMAND
            or fleet.n_epochs != 6):
        fail(f"paper fleet geometry: {fleet.n_blocks} blocks, hot sets "
             f"{fleet.tenancy.hot_k}, {fleet.n_epochs} epochs")
    setup_s = time.perf_counter() - t0
    # the host interleave alone (the tenants replay from memory)
    interleave_s = {}
    for cap, fl in fleets.items():
        t0 = time.perf_counter()
        fl_epochs = list(fl.epochs())
        interleave_s[cap] = time.perf_counter() - t0
    runs, walls, peaks, launches = {}, {}, {}, {}
    for cap, fl in fleets.items():
        pipeline = fl.build_pipeline()
        free_device_memory()
        zero_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        with runtime.counting() as c:
            torch.cuda.set_sync_debug_mode("error")
            t0 = time.perf_counter()
            try:
                runs[cap] = run_fleet(fl, hints=pipeline, sync_every=4,
                                      device=dev)
                torch.cuda.synchronize()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            walls[cap] = time.perf_counter() - t0
        peaks[cap] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        launches[cap] = read_counts()
        want = fleet_launches(fl, {cap: 1})
        if launches[cap] != want:
            fail(f"paper fleet ({cap}) launches {launches[cap]}, expected "
                 f"{want}")
        dispatch = {k: c.dispatch[k] for k in ("observe_all", "epoch_step",
                                               "record_sync")}
        if dispatch != {"observe_all": 6, "epoch_step": 6, "record_sync": 2}:
            fail(f"paper fleet ({cap}) dispatches {dispatch}, expected 6, 6 "
                 f"and 2 record pulls")
        check_fleet_records(runs[cap], fl)
    caps = runs["weighted"]["tenants"]
    cov = {cap: r["tenants"]["dlrm"]["lanes"]["hmu_oracle"]["final_coverage"]
           for cap, r in runs.items()}
    if caps["dlrm"]["cap"] < PAPER_K_HOT:
        fail(f"DLRM quota {caps['dlrm']['cap']} < its hot set {PAPER_K_HOT}")
    if not cov["weighted"] > cov["shared"]:
        fail(f"weighted-fair DLRM coverage {cov['weighted']} is not above "
             f"the shared pool's {cov['shared']}")
    say("paper_fleet", n_blocks=fleet.n_blocks, k_hot=fleet.k_hot,
        tenants={t.name: [t.n_blocks, t.k_hot] for t in fleet.tenants},
        quotas={n: caps[n]["cap"] for n in caps},
        epochs=fleet.n_epochs, rows_per_epoch=fleet.batches_per_epoch,
        accesses_per_epoch=int(fl_epochs[0].size), setup_s=setup_s,
        cold_wall_s=walls, launches=launches, dispatch=dispatch,
        peak_mem_gib=peaks, dlrm_hmu_oracle_final_coverage=cov,
        tenant_final_coverage={
            cap: {n: t["lanes"]["hmu_oracle"]["final_coverage"]
                  for n, t in r["tenants"].items()}
            for cap, r in runs.items()},
        interleave_s=interleave_s)

    # warm: the weighted fleet three times, the interleave inside the wall
    warm_wall_s, warm_cpu_s = [], []
    for _ in range(3):
        pipeline = fleet.build_pipeline()
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        run_fleet(fleet, hints=pipeline, sync_every=4, device=dev)
        torch.cuda.synchronize()
        warm_wall_s.append(time.perf_counter() - t0)
        warm_cpu_s.append(time.process_time() - c0)
    warm_mean = sum(warm_wall_s) / len(warm_wall_s)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pipeline = fleet.build_pipeline()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_fleet(fleet, hints=pipeline, sync_every=4, device=dev)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    kernel_us = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if ev.device_type == DeviceType.CUDA and us > 0:
            kernel_us[ev.key] = kernel_us.get(ev.key, 0.0) + us
    busy_s = sum(kernel_us.values()) / 1e6
    say("paper_fleet_warm", runs=len(warm_wall_s), wall_s=warm_wall_s,
        process_cpu_s=warm_cpu_s,
        epoch_wall_s_mean=warm_mean / fleet.n_epochs,
        interleave_s_per_epoch=interleave_s["weighted"] / fleet.n_epochs,
        interleave_share_of_wall=interleave_s["weighted"] / warm_mean,
        profiled_wall_s=prof_wall, device_busy_s=busy_s,
        device_idle_share_profiled=1.0 - busy_s / prof_wall,
        device_idle_share_warm=1.0 - busy_s / warm_mean,
        top_kernel_ms={key[:80]: us / 1e3 for key, us in sorted(
            kernel_us.items(), key=lambda kv: -kv[1])[:10]})

    # hist_select's segment call at the fleet's shape, on key rows made
    # from the fleet's own first two batch rows
    ten = fleet.tenancy
    rows = selection_rows(dev, fl_epochs[0][0], fl_epochs[0][1],
                          n_blocks=fleet.n_blocks)
    seg = torch.from_numpy(ten.block_tenants()).to(dev)
    ks = ten.caps
    got = kth_key(rows, seg, ks)
    ref = kth_key(rows, seg, ks, backend=plain)
    err = int((got - ref).abs().max())
    if err != 0:
        fail(f"hist_select's segment call differs from its plain version "
             f"on the fleet's rows (max abs err {err})")
    bounds = list(zip(ten.offsets, ten.offsets[1:], ks))
    top_min = torch.stack([torch.topk(rows[:, a:b], c, dim=-1, sorted=False
                                      ).values.min(dim=-1).values
                           for a, b, c in bounds], dim=-1)
    if not torch.equal(top_min.to(torch.int64) + 2 ** 31, got):
        fail("hist_select's segment call disagrees with torch.topk")
    ms, plain_ms = in_turns(lambda: kth_key(rows, seg, ks, backend=plain),
                            lambda: kth_key(rows, seg, ks), 10)
    topk_ms = time_ms(lambda: [torch.topk(rows[:, a:b], c, dim=-1,
                                          sorted=False)
                               for a, b, c in bounds], 10)
    n_keys = rows.numel()
    b_ms, b_by = bound_ms(4 * n_keys + 4 * fleet.n_blocks
                          + 8 * got.numel(), n_keys)
    seg_time = {"rows": list(rows.shape), "segments": len(ks), "ks": list(ks),
                "ms": ms, "plain_ms": plain_ms, "topk_ms": topk_ms,
                "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                "launches": launches["weighted"]["hist_select"]}
    say("hist_select_segments_time", share_of_bound=b_ms / ms, **seg_time)
    del rows, seg, got, ref, top_min
    free_device_memory()
    return seg_time


# phase 20's fault models and hardenings: (a) SMALL's "all faults" model,
# (c) the paper-scale one, (d) the fleet's per-tenant profile and its
# collector-wide knobs
ALL_FAULTS = dict(pebs_drop_p=0.3, reset_p=(0.5, 0.5, 0.5), nb_stall_p=0.5,
                  hmu_counter_bits=12, stale_epochs=1, seed=7)
SMALL_HARDENING = dict(fallback={"hmu_oracle": "pebs", "hinted": "hmu",
                                 "nb_two_touch": "hmu"}, demote_hysteresis=2)
PAPER_FAULTS = dict(pebs_drop_p=0.1, reset_p=(0.1, 0.1, 0.1), nb_stall_p=0.2,
                    hmu_counter_bits=16, stale_epochs=1, seed=7)
PAPER_HARDENING = dict(fallback={"hmu_oracle": "pebs"}, demote_hysteresis=2)
FLEET_PROFILE = {"scanner": {"pebs_drop_p": 0.5, "hmu_counter_bits": 8}}
FLEET_FAULT_KW = dict(reset_p=0.2, seed=3)


def degraded_small_parity(dev, datagen, DLRMScenario, run_scenario,
                          zero_counts, read_counts) -> dict:
    """Phase 20a: SMALL's ``run_scenario`` trajectory JSON byte-identical
    GPU vs CPU under a neutral and the "all faults" model, each without
    and with hardening, for K in {1, 4}; the neutral unhardened run equal
    to ``faults=None``.  Returns the GPU runs' launches."""
    from repro_torch.faults import FaultModel, Hardening
    from repro_torch.kernels.observe_scatter import kernel as os_kernel
    t0 = time.perf_counter()
    proto = DLRMScenario(spec=datagen.SMALL)
    zero_counts()
    faulty_runs = 0
    for k in (1, 4):
        base = json.dumps(run_scenario(DLRMScenario(spec=datagen.SMALL),
                                       hints=True, sync_every=k, device=dev),
                          sort_keys=True)
        for label, kw in (("neutral", {}), ("all faults", ALL_FAULTS)):
            for har in (None, SMALL_HARDENING):
                out = {d: json.dumps(run_scenario(
                    DLRMScenario(spec=datagen.SMALL), hints=True,
                    sync_every=k, device=d,
                    faults=FaultModel.create(n_blocks=proto.n_blocks, **kw),
                    hardening=None if har is None else Hardening.make(**har)),
                    sort_keys=True) for d in (dev, "cpu")}
                faulty_runs += 1
                if out[dev] != out["cpu"]:
                    fail(f"SMALL degraded trajectory differs GPU vs CPU "
                         f"({label}, hardened={har is not None}, "
                         f"sync_every={k})")
                if label == "neutral" and har is None and out[dev] != base:
                    fail(f"the neutral FaultModel differs from faults=None "
                         f"on the GPU (sync_every={k})")
    launches, keep = read_counts(), os_kernel.KEEP_LAUNCHES
    per_run = proto.n_epochs * proto.batches_per_epoch
    want = {"observe_scatter": per_run * (faulty_runs + 2),
            "hist_select": proto.n_epochs * (2 * faulty_runs + 2),
            "gather_count": 0, "embedding_bag": 0, "flash_attention": 0}
    if launches != want or keep != per_run * faulty_runs:
        fail(f"SMALL degraded launches {launches}, {keep} with keep; "
             f"expected {want}, {per_run * faulty_runs}")
    say("degraded_small_parity", runs=2 * faulty_runs + 2, identical=True,
        neutral_equals_none=True, launches=launches, keep_launches=keep,
        faults=ALL_FAULTS, hardening=SMALL_HARDENING,
        seconds=time.perf_counter() - t0)
    return launches


def degraded_example(dev, zero_counts, read_counts) -> dict:
    """Phase 20b: ``repro_torch.examples.degraded_telemetry`` on the GPU
    inside the reference example's margins; launches: one observe_scatter a
    batch (with keep in the three runs with a model) and one hist_select an
    epoch, two under a model (its own hot set)."""
    from repro_torch.examples import degraded_telemetry as ex
    from repro_torch.kernels.observe_scatter import kernel as os_kernel
    t0 = time.perf_counter()
    zero_counts()
    res = ex.run(device=dev)
    launches, keep = read_counts(), os_kernel.KEEP_LAUNCHES
    margins = ex.margins_met(res)
    if not all(margins.values()):
        fail(f"degraded_telemetry margins missed on the GPU: {margins}, "
             f"coverage {res['cov']}, final quality {res['q_final']}")
    per_run = ex.N_EPOCHS * ex.scenario().batches_per_epoch
    if (launches["observe_scatter"] != 4 * per_run or keep != 3 * per_run
            or launches["hist_select"] != 7 * ex.N_EPOCHS):
        fail(f"degraded_telemetry launches {launches}, {keep} with keep")
    say("degraded_example", coverage=res["cov"], final_quality=res["q_final"],
        margins=margins, dispatch=res["dispatch"], launches=launches,
        keep_launches=keep, seconds=time.perf_counter() - t0)
    return res


def degraded_paper_run(dev, plain, scen, epochs, phase8_epoch_s: float,
                       build_hints, zero_counts, read_counts) -> dict:
    """Phase 20c: phase 8's paper-scale run (5,242,880 pages, 2.4 M lookups
    a batch, 486,587 fast slots, hints on, K 4, 6 epochs x 2 batches) under
    PAPER_FAULTS and PAPER_HARDENING, through ``EpochRuntime.for_scenario``
    under ``set_sync_debug_mode("error")``: 12 observe_scatter launches,
    all with keep, 12 hist_select (phase 8's 6 and the hot set's one an
    epoch), 2 record pulls, the PEBS drop share within 5 sigma of 0.1.
    Then the warm epoch wall beside phase 8's, the fault model's draw per
    batch and observe_scatter with and without the draw's keep mask (CUDA
    events), the device's idle share over a profiled run and peak memory.
    Returns the keep route's numbers for the kernels line."""
    import torch
    from repro_torch.core import runtime
    from repro_torch.faults import FaultModel, Hardening, prng
    from repro_torch.kernels.observe_scatter import kernel as os_kernel
    from repro_torch.kernels.observe_scatter import observe_scatter
    fm = FaultModel.create(n_blocks=scen.n_blocks, **PAPER_FAULTS)
    har = Hardening.make(**PAPER_HARDENING)

    def build(pipeline):
        return runtime.EpochRuntime.for_scenario(
            scen, hints=pipeline, sync_every=4, faults=fm, hardening=har,
            device=dev)

    free_device_memory()
    pipeline = build_hints(scen)
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with runtime.counting() as c:
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            rt = build(pipeline)
            traj = rt.run(epochs)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    launches, keep = read_counts(), os_kernel.KEEP_LAUNCHES
    modes = dict(os_kernel.MODE_LAUNCHES)
    dispatch = {k: c.dispatch[k] for k in ("observe_all", "epoch_step",
                                           "record_sync")}
    if launches != {"observe_scatter": 12, "hist_select": 12,
                    "gather_count": 0, "embedding_bag": 0,
                    "flash_attention": 0} or keep != 12 \
            or modes != {"direct": 0, "hashed": 12}:
        fail(f"degraded paper run launches {launches}, {keep} with keep, "
             f"modes {modes}: expected 12 observe_scatter (all hashed, all "
             f"with keep) and 12 hist_select")
    if dispatch != {"observe_all": 6, "epoch_step": 6, "record_sync": 2}:
        fail(f"degraded paper run dispatches {dispatch}")
    f, pebs = rt._state.bundle.faults, rt._state.bundle.pebs
    dropped, kept = int(f.pebs_dropped), int(pebs.host_events)
    share = dropped / (dropped + kept)
    sigma = math.sqrt(0.1 * 0.9 / (dropped + kept))
    if abs(share - 0.1) > 5 * sigma:
        fail(f"PEBS drop share {share} is more than 5 sigma ({sigma}) from "
             f"0.1 ({dropped} dropped, {kept} kept)")
    lanes = {n: [r.to_dict() for r in recs]
             for n, recs in traj.records.items()}
    for name, recs in lanes.items():
        if len(recs) != scen.n_epochs:
            fail(f"degraded lane {name} has {len(recs)} records")
        for r in recs:
            nums = [v for v in r.values() if isinstance(v, (int, float))]
            if not (all(math.isfinite(v) for v in nums)
                    and 0.0 <= r["accuracy"] <= 1.0
                    and 0.0 <= r["coverage"] <= 1.0
                    and 0.0 <= r["quality"] <= 1.0
                    and 0 <= r["resident"] <= scen.k_hot
                    and r["time_s"] > 0):
                fail(f"degraded record out of range {r}")
    say("degraded_paper_run", faults=PAPER_FAULTS, hardening=PAPER_HARDENING,
        wall_s=wall, epoch_wall_s_mean=wall / scen.n_epochs,
        launches=launches, keep_launches=keep, observe_scatter_modes=modes,
        dispatch=dispatch, pebs_dropped=dropped, pebs_kept=kept,
        drop_share=share, drop_share_sigma=sigma,
        resets=f.resets.tolist(), nb_stalls=int(f.nb_stalls),
        hmu_quality=[r["quality"] for r in lanes["hmu_oracle"]],
        pebs_quality=[r["quality"] for r in lanes["hinted"]],
        final_coverage={n: recs[-1]["coverage"] for n, recs in lanes.items()},
        peak_mem_gib=peak)
    del rt, traj

    # warm, twice, beside phase 8's warm epoch
    warm = []
    for _ in range(2):
        pipeline = build_hints(scen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        build(pipeline).run(epochs)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    epoch_s = sum(warm) / len(warm) / scen.n_epochs

    # the device's idle share over one profiled run
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pipeline = build_hints(scen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        build(pipeline).run(epochs)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    kernel_us = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if ev.device_type == DeviceType.CUDA and us > 0:
            kernel_us[ev.key] = kernel_us.get(ev.key, 0.0) + us
    busy_s = sum(kernel_us.values()) / 1e6

    # the fault model's draw for one batch (a three-way split, the keep
    # mask against pebs_drop_p, the stall bit) and observe_scatter on the
    # online batch with and without that mask
    ids = torch.from_numpy(epochs[0][0]).to(dev)
    m, n = ids.numel(), scen.n_blocks
    key = prng.prng_key(PAPER_FAULTS["seed"], device=dev)
    drop_p = fm.pebs_drop_p.to(dev)
    stall_p = fm.nb_stall_p.to(dev)

    def draw():
        k = prng.split(key, 3)
        return prng.uniform(k[1], (m,)) >= drop_p, prng.bernoulli(k[2],
                                                                  stall_p)

    draw_ms = time_ms(draw, 20)
    keep_mask = draw()[0]
    cursor = torch.zeros((), dtype=torch.int32, device=dev)
    got = observe_scatter(ids, cursor, n_blocks=n, period=401, keep=keep_mask)
    ref = observe_scatter(ids, cursor, n_blocks=n, period=401,
                          keep=keep_mask, backend=plain)
    err = max(int((g - r).abs().max()) for g, r in zip(got, ref))
    if err != 0:
        fail(f"observe_scatter with the fault model's keep mask differs "
             f"from its plain version (max abs err {err})")
    k_ms, p_ms = in_turns(
        lambda: observe_scatter(ids, cursor, n_blocks=n, period=401,
                                keep=keep_mask, backend=plain),
        lambda: observe_scatter(ids, cursor, n_blocks=n, period=401,
                                keep=keep_mask), 20)
    nokeep_ms = time_ms(lambda: observe_scatter(ids, cursor, n_blocks=n,
                                                period=401), 20)
    hit = (torch.arange(m, device=dev) % 401 == 0) & keep_mask
    hit_w = hit.to(torch.float32)
    lib_ms = time_ms(lambda: (torch.bincount(ids, minlength=n),
                              torch.bincount(ids, weights=hit_w,
                                             minlength=n)), 20)
    b_ms, b_by = bound_ms(4 * m + m + 2 * 4 * n, 2 * m)
    out = {"ms": k_ms, "plain_ms": p_ms, "no_keep_ms": nokeep_ms,
           "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
           "max_abs_err": err, "launches": keep, "draw_ms": draw_ms}
    say("degraded_paper_warm", warm_wall_s=warm, epoch_wall_s_mean=epoch_s,
        phase8_epoch_wall_s_mean=phase8_epoch_s,
        epoch_wall_ratio=epoch_s / phase8_epoch_s,
        draw_ms_per_batch=draw_ms,
        draw_share_of_epoch=2 * draw_ms / 1e3 / epoch_s,
        profiled_wall_s=prof_wall, device_busy_s=busy_s,
        device_idle_share_profiled=1.0 - busy_s / prof_wall,
        device_idle_share_warm=1.0 - busy_s / (epoch_s * scen.n_epochs),
        top_kernel_ms={key[:80]: us / 1e3 for key, us in sorted(
            kernel_us.items(), key=lambda kv: -kv[1])[:10]},
        observe_scatter_keep=out, share_of_bound=b_ms / k_ms)
    del ids, keep_mask, hit, hit_w, got, ref
    free_device_memory()
    return out


def degraded_fleet(dev, zero_counts, read_counts) -> dict:
    """Phase 20d: phase 18's mix GPU vs CPU for shared and weighted x
    sync_every in {1, 4} under ``build_faults(FLEET_PROFILE,
    **FLEET_FAULT_KW)``: trajectory, summary and tenant rows identical;
    launches: one observe_scatter a batch row, all with keep, and
    hist_select 3 an epoch shared (the hot set joins the select and the
    tenants' hot sets) and 4 weighted."""
    from repro_torch.examples import fleet_mix
    from repro_torch.fleet import run_fleet
    from repro_torch.kernels.observe_scatter import kernel as os_kernel
    t0 = time.perf_counter()
    sc = fleet_mix.make_scenarios(device=dev)
    fleet_mix_streams(sc)
    zero_counts()
    for capacity in ("shared", "weighted"):
        for k in (1, 4):
            out = {}
            for d in (dev, "cpu"):
                fl = fleet_mix.fleet(sc, capacity)
                out[d] = run_fleet(fl, hints=True, sync_every=k, device=d,
                                   faults=fl.build_faults(FLEET_PROFILE,
                                                          **FLEET_FAULT_KW))
            for part in ("trajectory", "summary", "tenants"):
                if json.dumps(out[dev][part], sort_keys=True) != json.dumps(
                        out["cpu"][part], sort_keys=True):
                    fail(f"degraded fleet {part} differs GPU vs CPU "
                         f"(capacity={capacity}, sync_every={k})")
    launches, keep = read_counts(), os_kernel.KEEP_LAUNCHES
    fl = fleet_mix.fleet(sc, "shared")
    rows = fl.n_epochs * fl.batches_per_epoch
    want = {"observe_scatter": 4 * rows,
            "hist_select": 2 * fl.n_epochs * (3 + 4),
            "gather_count": 0, "embedding_bag": 0, "flash_attention": 0}
    if launches != want or keep != 4 * rows:
        fail(f"degraded fleet launches {launches}, {keep} with keep; "
             f"expected {want}")
    say("degraded_fleet", runs=8, identical=True, launches=launches,
        keep_launches=keep, profile=FLEET_PROFILE, **FLEET_FAULT_KW,
        seconds=time.perf_counter() - t0)
    return launches


# phase 21: the observability and export planes (repro_torch.obs,
# repro_torch.export) on the online paper run, the port's two examples and
# the fleet mix's wire records; files go to fresh directories under build/
OBS_SPAN_KERNELS = {"observe_all": "observe_scatter", "epoch_step": "hs_pass"}
EXPORT_DROPS = ("dropped_queue_full", "dropped_invalid",
                "dropped_breaker_open", "dropped_sink_failure",
                "dropped_degraded")


def obs_dir(label: str) -> Path:
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    return Path(tempfile.mkdtemp(prefix=f"obs_{label}_", dir=ROOT / "build"))


def kernels_in_spans(trace: dict) -> dict:
    """From a ``torch.profiler`` Chrome trace: for each span of
    ``OBS_SPAN_KERNELS``, how many of its kernel's launches there are and
    how many lie inside a ``record_function`` range of that name — by the
    launching call's host time inside the host range, or by the kernel's
    device interval inside the range's device annotation."""
    evs = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    host, gpu, launch_ts = {}, {}, {}
    for e in evs:
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "user_annotation":
            host.setdefault(name, []).append((e["ts"], e["ts"] + e["dur"]))
        elif cat == "gpu_user_annotation":
            gpu.setdefault(name, []).append((e["ts"], e["ts"] + e["dur"]))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = e["ts"]
    out = {}
    for span, frag in OBS_SPAN_KERNELS.items():
        total = inside = 0
        for e in evs:
            if e.get("cat") != "kernel" or frag not in e.get("name", ""):
                continue
            total += 1
            t = launch_ts.get((e.get("args") or {}).get("correlation"))
            by_host = t is not None and any(
                a <= t <= b for a, b in host.get(span, ()))
            by_device = any(a <= e["ts"] and e["ts"] + e["dur"] <= b
                            for a, b in gpu.get(span, ()))
            inside += by_host or by_device
        out[span] = {"kernel": frag, "launches": total, "inside": inside,
                     "host_ranges": len(host.get(span, ())),
                     "device_ranges": len(gpu.get(span, ()))}
    return out


def observed_paper_run(dev, scen, epochs, build_hints, run_scenario,
                       zero_counts, read_counts) -> dict:
    """Phase 21a: phase 8's online paper run with tracing (metrics into
    ``REGISTRY``, ``profiler_annotations``) and an ``ExportClient`` on a
    ``JsonlSink`` against the same run with both off, each under
    ``set_sync_debug_mode("error")``: trajectory JSON, dispatch deltas,
    launches and peak memory (to the MB) equal; exactly 6 observe_all, 6
    epoch_step and 2 record_sync spans on the host thread, the pipelining
    visible and the Chrome trace written with its device track; every JSONL
    line valid, nothing dropped.  Then the traced run under
    ``torch.profiler`` (the kernels inside their spans) and the warm epoch
    with both on and off, in turns, three runs each."""
    import contextlib
    import threading
    import torch
    from repro_torch.core import runtime
    from repro_torch.export import ExportClient, JsonlSink, validate_record
    from repro_torch.kernels.observe_scatter import kernel as os_kernel
    from repro_torch.obs import REGISTRY, chrometrace
    from repro_torch.obs import trace as obs_trace
    t_phase = time.perf_counter()
    out_dir = obs_dir("paper")
    host_thread = threading.current_thread().name

    def run(on: bool, label: str, checked: bool):
        pipeline = build_hints(scen)
        client = (ExportClient(JsonlSink(out_dir / f"{label}.jsonl"))
                  if on else None)
        scope = (obs_trace.tracing(metrics=REGISTRY,
                                   profiler_annotations=True)
                 if on else contextlib.nullcontext())
        free_device_memory()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        with runtime.counting() as c, scope as tracer:
            if checked:
                torch.cuda.set_sync_debug_mode("error")
            t0 = time.perf_counter()
            try:
                res = run_scenario(scen, hints=pipeline, sync_every=4,
                                   epochs=epochs, export=client)
                torch.cuda.synchronize()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            wall = time.perf_counter() - t0
            dispatch = dict(c.dispatch.items())
        stats = None
        if client is not None:
            t0 = time.perf_counter()
            client.flush(timeout=120)
            stats = dict(client.stats(), flush_s=time.perf_counter() - t0)
            client.close()
        return {"json": json.dumps(res), "dispatch": dispatch,
                "launches": read_counts(),
                "modes": dict(os_kernel.MODE_LAUNCHES),
                "peak_mb": torch.cuda.max_memory_allocated(dev) // 2 ** 20,
                "wall_s": wall, "stats": stats,
                "spans": tracer.spans if on else None}

    off = run(False, "off", True)
    on = run(True, "on", True)
    want = {"observe_scatter": 12, "hist_select": 6, "gather_count": 0,
            "embedding_bag": 0, "flash_attention": 0}
    if off["json"] != on["json"]:
        fail("the paper run's trajectory differs with tracing and export on")
    if on["dispatch"] != off["dispatch"]:
        fail(f"dispatch counts differ: on {on['dispatch']}, "
             f"off {off['dispatch']}")
    for r in (off, on):
        if r["launches"] != want or r["modes"] != {"direct": 0, "hashed": 12}:
            fail(f"observed paper run launches {r['launches']}, modes "
                 f"{r['modes']}; expected {want}, 12 hashed")
    if on["dispatch"]["record_sync"] != 2:
        fail(f"record pulls {on['dispatch']['record_sync']}, expected 2")
    if on["peak_mb"] != off["peak_mb"]:
        fail(f"peak memory {on['peak_mb']} MB with tracing and export, "
             f"{off['peak_mb']} MB without")

    spans = on["spans"]
    names = [s.name for s in spans if s.tid == host_thread]
    counts = {n: names.count(n) for n in sorted(set(names))}
    if (counts.get("observe_all"), counts.get("epoch_step"),
            counts.get("record_sync")) != (6, 6, 2) or \
            counts.get("hint_refresh") != on["dispatch"]["hint_refresh"]:
        fail(f"host spans {counts}, expected 6 observe_all, 6 epoch_step, "
             f"2 record_sync and {on['dispatch']['hint_refresh']} "
             f"hint_refresh")
    visible = chrometrace.pipelining_visible(spans)
    doc = chrometrace.write_chrome_trace(
        out_dir / "trace.json", spans,
        metadata={"phase": 21, "sync_every": 4})
    device_track = [e["name"] for e in doc["traceEvents"]
                    if e["tid"] == "device"]
    if not visible or len(device_track) != 2:
        fail(f"pipelining visible {visible}, device track {device_track}")

    lines = (out_dir / "on.jsonl").read_text().splitlines()
    kinds = {}
    for ln in lines:
        rec = validate_record(json.loads(ln))
        kinds[rec["record_type"]] = kinds.get(rec["record_type"], 0) + 1
    st = on["stats"]
    n_lanes = len(runtime.ALL_POLICIES)
    if (kinds != {"epoch": 6 * n_lanes, "lane_summary": n_lanes}
            or st["exported"] != len(lines) or st["emitted"] != len(lines)
            or any(st[k] for k in EXPORT_DROPS)):
        fail(f"exported records {kinds}, stats {st}")

    # the traced run under torch.profiler: the kernels inside their spans
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pipeline = build_hints(scen)
    client = ExportClient(JsonlSink(out_dir / "profiled.jsonl"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with obs_trace.tracing(metrics=REGISTRY,
                               profiler_annotations=True) as tracer:
            t0 = time.perf_counter()
            run_scenario(scen, hints=pipeline, sync_every=4, epochs=epochs,
                         export=client)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
    client.close()
    # a span's range on the device timeline is a device event of the
    # span's name: it covers the span's kernels and the gaps between them,
    # so it is reported apart and kept out of the busy time
    span_names = {s.name for s in tracer.spans}
    busy_us, span_device_ms = 0.0, {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if ev.key in span_names:
            span_device_ms[ev.key] = us / 1e3
        else:
            busy_us += us
    prof.export_chrome_trace(str(out_dir / "profile.json"))
    inside = kernels_in_spans(json.loads(
        (out_dir / "profile.json").read_text()))
    if any(v["launches"] == 0 or v["inside"] != v["launches"]
           for v in inside.values()):
        fail(f"kernels outside their spans in torch.profiler: {inside}")

    # the warm epoch with both on and off, in turns (off, on, on, off, off,
    # on), each run timed from the call to the last epoch's completion
    warm = {False: [], True: []}
    flush_s = []
    for k, on_turn in enumerate((False, True, True, False, False, True)):
        r = run(on_turn, f"warm{k}", False)
        warm[on_turn].append(r["wall_s"] / scen.n_epochs)
        if on_turn:
            flush_s.append(r["stats"]["flush_s"])
    res = {"epoch_s_off": warm[False], "epoch_s_on": warm[True],
           "epoch_s_off_mean": sum(warm[False]) / 3,
           "epoch_s_on_mean": sum(warm[True]) / 3}
    res["on_over_off"] = res["epoch_s_on_mean"] / res["epoch_s_off_mean"]
    say("observed_paper_run", identical=True, launches=on["launches"],
        dispatch=on["dispatch"], peak_mb=on["peak_mb"], host_spans=counts,
        pipelining_visible=visible, device_track=device_track,
        exported=kinds, export_stats=st, kernels_in_spans=inside,
        profiled_wall_s=prof_wall, device_busy_s=busy_us / 1e6,
        span_device_ranges_ms=span_device_ms,
        device_idle_share_profiled=1.0 - busy_us / 1e6 / prof_wall,
        cold_wall_s={"off": off["wall_s"], "on": on["wall_s"]},
        export_flush_after_run_s=flush_s, **res,
        seconds=time.perf_counter() - t_phase)
    return res


def observability_examples(dev, zero_counts, read_counts) -> None:
    """Phase 21b: ``repro_torch.examples.runtime_timeline`` and
    ``telemetry_export`` on the GPU with the reference examples' asserts;
    their Chrome trace and JSONL under build/."""
    from repro_torch.examples import runtime_timeline, telemetry_export
    from repro_torch.export import validate_record
    t0 = time.perf_counter()
    zero_counts()
    tl = runtime_timeline.run(dev, trace_dir=obs_dir("timeline"))
    tl_launches = read_counts()
    ex = telemetry_export.run(dev, out_dir=obs_dir("export"))
    for name, res, checks in (("runtime_timeline", tl, runtime_timeline),
                              ("telemetry_export", ex, telemetry_export)):
        ok = checks.checks(res)
        if not all(ok.values()):
            fail(f"{name}'s checks failed on the GPU: {ok}")
    for ln in ex["lines"]:
        validate_record(json.loads(ln))
    # three runs (warm-up, off, on) of 6 epochs of 2 batches, one
    # hist_select an epoch
    if (tl_launches["observe_scatter"] != 3 * 2 * runtime_timeline.N_EPOCHS
            or tl_launches["hist_select"] != 3 * runtime_timeline.N_EPOCHS):
        fail(f"runtime_timeline launches {tl_launches}")
    say("observability_examples", timeline_spans=tl["spans"],
        timeline_pipelining_visible=tl["pipelining_visible"],
        timeline_launches=tl_launches, export_records=len(ex["lines"]),
        export_stats=ex["stats"], dead_sink=ex["dead_stats"],
        seconds=time.perf_counter() - t0)


def fleet_export_gpu_vs_cpu(dev, zero_counts, read_counts) -> None:
    """Phase 21c: phase 18's mix (shared, sync_every in {1, 4}) with a
    ``MemorySink`` on the GPU and the CPU: wire records equal record for
    record, launches checked."""
    from repro_torch.examples import fleet_mix
    from repro_torch.export import ExportClient, MemorySink
    from repro_torch.fleet import run_fleet
    t0 = time.perf_counter()
    sc = fleet_mix.make_scenarios(device=dev)
    fleet_mix_streams(sc)
    zero_counts()
    n_recs = {}
    for k in (1, 4):
        recs = {}
        for d in (dev, "cpu"):
            sink = MemorySink()
            client = ExportClient(sink)
            run_fleet(fleet_mix.fleet(sc, "shared"), hints=True,
                      sync_every=k, device=d, export=client)
            client.flush(timeout=60)
            client.close()
            recs[d] = sink.snapshot()
        if recs[dev] != recs["cpu"] or not recs["cpu"]:
            fail(f"fleet wire records differ GPU vs CPU (sync_every={k})")
        n_recs[k] = len(recs["cpu"])
    launches = read_counts()
    want = fleet_launches(fleet_mix.fleet(sc, "shared"), {"shared": 2})
    if launches != want:
        fail(f"fleet export launches {launches}, expected {want}")
    say("fleet_export", identical=True, records=n_recs, launches=launches,
        seconds=time.perf_counter() - t0)


# phase 22: the per-lane reference path (EpochRuntime(fused=False)) and the
# MoE family.  Its serving phase runs Mixtral-8x22B at its published widths
# with n_layers cut from 56 to MIXTRAL_LAYERS (5.41 B parameters in float32,
# 27 % of the card); (e) times flash_attention at that model's prefill shape
# (label, B, H, KVH, d) with its sliding window of 4,096.
MIXTRAL_LAYERS = 2
MIXTRAL_TIME_SHAPE = ("mixtral-8x22b", 4, 48, 8, 128)
MIXTRAL_WINDOW = 4096
# phase 22c's check of one MoE layer at those widths: tokens, and the
# float32 tolerance of the card test at smoke size (the same products
# summed in another order by cuBLAS and the CPU's BLAS)
MOE_CHECK_TOKENS = 48
MOE_F32_TOL = 2e-5
NO_KERNELS = {"observe_scatter": 0, "hist_select": 0, "gather_count": 0,
              "embedding_bag": 0, "flash_attention": 0}


def reference_launches(n_batches: int, n_epochs: int,
                       hist_select_per_epoch: int) -> dict:
    """The reference path's launches on the card: one observe_scatter a
    batch (observe_all) and one hist_select for each eager policy's top-k
    (none where quotas send the lanes through numpy sorts)."""
    return dict(NO_KERNELS, observe_scatter=n_batches,
                hist_select=hist_select_per_epoch * n_epochs)


def reference_small_parity(dev, datagen, DLRMScenario, run_scenario,
                           runtime, zero_counts, read_counts) -> dict:
    """Phase 22a: ``run_scenario(..., fused=False)`` on SMALL for hints
    off, hints on and an NB rate limit of 37, and ``run_fleet(...,
    fused=False)`` on the fleet example's 4-tenant mix for capacity in
    {shared, partition, weighted}: each GPU run byte-identical to the
    CPU's reference run (trajectory JSON, summary, tenant rows) and to the
    GPU's fused run, with the launches the code implies (6 hist_select a
    epoch without quotas, none under them)."""
    from repro_torch.examples import fleet_mix
    from repro_torch.fleet import run_fleet
    t0 = time.perf_counter()
    sc = DLRMScenario(spec=datagen.SMALL)
    eps = list(sc.epochs())
    out = {}
    for label, hints, kw in (("hints off", False, {}),
                             ("hints on", True, {}),
                             ("nb_rate_limit 37", False,
                              dict(nb_rate_limit=37))):
        zero_counts()
        with runtime.counting() as c:
            gpu = run_scenario(sc, hints=hints, fused=False, epochs=eps,
                               **kw)
            gpu_ref = c.dispatch["reference"]
        launches = read_counts()
        want = reference_launches(sum(len(e) for e in eps), len(eps), 6)
        if launches != want:
            fail(f"reference path ({label}) launches {launches}, expected "
                 f"{want}")
        with runtime.counting() as c:
            cpu = run_scenario(sc, hints=hints, fused=False, epochs=eps,
                               device="cpu", **kw)
            cpu_ref = c.dispatch["reference"]
        fused = run_scenario(sc, hints=hints, epochs=eps, **kw)
        if json.dumps(gpu, sort_keys=True) != json.dumps(cpu, sort_keys=True):
            fail(f"reference path ({label}) differs GPU vs CPU")
        if (gpu["trajectory"], gpu["summary"]) != (fused["trajectory"],
                                                   fused["summary"]):
            fail(f"reference path ({label}) differs from the fused run")
        if gpu_ref != cpu_ref:
            fail(f"reference path ({label}) dispatch counts differ GPU vs "
                 f"CPU: {gpu_ref} against {cpu_ref}")
        out[label] = dict(launches=launches, reference_dispatches=gpu_ref)
    fsc = fleet_mix.make_scenarios(device=dev)
    fleet_mix_streams(fsc)
    for capacity in ("shared", "partition", "weighted"):
        fl = fleet_mix.fleet(fsc, capacity)
        f_eps = list(fl.epochs())
        zero_counts()
        gpu = run_fleet(fleet_mix.fleet(fsc, capacity), hints=True,
                        fused=False, epochs=f_eps)
        launches = read_counts()
        want = reference_launches(sum(len(e) for e in f_eps), len(f_eps),
                                  6 if capacity == "shared" else 0)
        if launches != want:
            fail(f"fleet reference path ({capacity}) launches {launches}, "
                 f"expected {want}")
        cpu = run_fleet(fleet_mix.fleet(fsc, capacity), hints=True,
                        fused=False, epochs=f_eps, device="cpu")
        fused = run_fleet(fleet_mix.fleet(fsc, capacity), hints=True,
                          epochs=f_eps)
        for part in ("trajectory", "summary", "tenants"):
            g = json.dumps(gpu[part], sort_keys=True)
            if g != json.dumps(cpu[part], sort_keys=True):
                fail(f"fleet reference path {part} differs GPU vs CPU "
                     f"({capacity})")
            if g != json.dumps(fused[part], sort_keys=True):
                fail(f"fleet reference path {part} differs from the fused "
                     f"run ({capacity})")
        out["fleet " + capacity] = dict(launches=launches)
    say("reference_small", runs=out, identical_gpu_cpu=True,
        identical_to_fused=True, seconds=time.perf_counter() - t0)
    return out


def first_difference(a: list, b: list):
    """(epochs whose records differ, the first differing (epoch, field))."""
    differ, first = 0, None
    for ra, rb in zip(a, b):
        keys = [key for key in ra if ra[key] != rb.get(key)]
        if keys:
            differ += 1
            if first is None:
                first = [ra["epoch"], keys[0], ra[keys[0]], rb.get(keys[0])]
    return differ, first


def reference_paper_run(dev, scen, epochs, phase8_lanes, phase8_epoch_s,
                        build_hints, run_scenario, runtime, zero_counts,
                        read_counts) -> dict:
    """Phase 22b: phase 8's paper-scale run (5,242,880 pages, 2.4 M lookups
    a batch, hints on) on the reference path, K 1: 12 observe_scatter
    launches (hashed) and 36 hist_select (6 lanes x 6 epochs); five lanes
    byte-identical to phase 8's fused trajectory.  The hinted lane scores
    in the reference's eager float32 form, the fused step in its contracted
    one, so its epochs may differ: how many and where is reported.  Its
    epoch wall beside phase 8's warm epoch."""
    import torch
    from repro_torch.kernels.observe_scatter import kernel as os_kernel
    free_device_memory()
    pipeline = build_hints(scen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    with runtime.counting() as c:
        t0 = time.perf_counter()
        res = run_scenario(scen, hints=pipeline, fused=False, epochs=epochs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ref_dispatches = c.dispatch["reference"]
    launches, modes = read_counts(), dict(os_kernel.MODE_LAUNCHES)
    want = reference_launches(12, scen.n_epochs, 6)
    if launches != want or modes != {"direct": 0, "hashed": 12}:
        fail(f"reference paper run launches {launches}, modes {modes}; "
             f"expected {want}, all hashed")
    lanes = res["trajectory"]["lanes"]
    hinted_differ, hinted_first = first_difference(phase8_lanes["hinted"],
                                                   lanes["hinted"])
    for name in runtime.ALL_POLICIES:
        if name != "hinted" and lanes[name] != phase8_lanes[name]:
            n, first = first_difference(phase8_lanes[name], lanes[name])
            fail(f"reference paper run lane {name} differs from phase 8's "
                 f"fused run in {n} epochs, first {first}")
    say("reference_paper_run", n_pages=scen.n_blocks, epochs=scen.n_epochs,
        wall_s=wall, epoch_wall_s_mean=wall / scen.n_epochs,
        phase8_warm_epoch_wall_s_mean=phase8_epoch_s,
        launches=launches, observe_scatter_modes=modes,
        reference_dispatches=ref_dispatches,
        identical_lanes=[n for n in runtime.ALL_POLICIES if n != "hinted"],
        hinted_epochs_differing=hinted_differ,
        hinted_first_difference=hinted_first,
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    return launches


def moe_layer_full_width(dev, params, cfg) -> dict:
    """Phase 22c's MoE layer at Mixtral's widths: layer 0's ``moe_block``
    on MOE_CHECK_TOKENS tokens in float32, on the card against the CPU on
    the same weights, at capacity factors 1.25 and 0.3 (experts overflow
    and tokens drop): counts exact, output and balance loss within
    MOE_F32_TOL.  Returns the largest differences."""
    import numpy as np
    import torch
    from repro_torch.models.model import layer_params, moe_params
    from repro_torch.models.moe import moe_block
    par = moe_params(layer_params(params, 0))
    cpar = type(par)(*[None if v is None else v.cpu() for v in par])
    x = torch.from_numpy(np.random.default_rng(22).normal(
        size=(1, MOE_CHECK_TOKENS, cfg.d_model)).astype(np.float32))
    gx = x.to(dev)
    out = {}
    with torch.no_grad():
        for cf in (1.25, 0.3):
            g_out, g_aux = moe_block(gx, par, top_k=cfg.moe.top_k,
                                     capacity_factor=cf)
            c_out, c_aux = moe_block(x, cpar, top_k=cfg.moe.top_k,
                                     capacity_factor=cf)
            g_out = g_out.cpu()
            err = float((g_out - c_out).abs().max())
            ok = bool(((g_out - c_out).abs()
                       <= MOE_F32_TOL + MOE_F32_TOL * c_out.abs()).all())
            loss_err = abs(float(g_aux["aux_loss"]) - float(c_aux["aux_loss"]))
            counts = c_aux["counts"]
            if not (torch.equal(g_aux["counts"].cpu(), counts) and ok
                    and loss_err <= MOE_F32_TOL * abs(float(c_aux["aux_loss"]))):
                fail(f"mixtral moe_block (capacity factor {cf}) differs GPU "
                     f"vs CPU: counts {g_aux['counts'].tolist()} vs "
                     f"{counts.tolist()}, max |out diff| {err}, aux_loss "
                     f"diff {loss_err}")
            capacity = max(int(MOE_CHECK_TOKENS * cfg.moe.top_k * cf
                               / cfg.moe.n_experts), 4)
            out[str(cf)] = dict(
                capacity=capacity, counts=counts.tolist(),
                dropped=int((counts - capacity).clamp(min=0).sum()),
                max_abs_err=err, aux_loss_err=loss_err)
    del par, cpar, gx
    free_device_memory()
    return out


def moe_serve_full_width(dev, zero_counts, read_counts,
                         read_routes) -> dict:
    """Phase 22c: Mixtral-8x22B at its published widths (d_model 6,144, 48
    heads of 128 with 8 KV heads, 8 experts top-2 of d 16,384, vocab 32,768,
    window 4,096; float32 parameters drawn on the card by ``ep_params``,
    bfloat16 activations), n_layers cut from 56 to MIXTRAL_LAYERS.  The
    parameter draw is timed; then B 4, prompt
    64 and 4,096, 32 generated tokens, page 16, prefill and decode called
    directly under ``set_sync_debug_mode("error")``: 2 flash_attention
    launches a prefill, all on the tensor cores, none in decode; every
    decode step routes B x top_k tokens a layer.  Reports the decode's
    expert counts per layer, tokens/s and peak memory; then holds layer 0's
    ``moe_block`` against the CPU (``moe_layer_full_width``).  Returns the
    64-token run's launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serve import engine
    free_device_memory()
    cfg = dataclasses.replace(get_config("mixtral-8x22b"),
                              n_layers=MIXTRAL_LAYERS)
    t0 = time.perf_counter()
    params = ep_params(cfg, dev, range(cfg.moe.n_experts))
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in params["blocks"].values()) + sum(
        v.numel() for k, v in params.items() if k != "blocks")
    if n_params != cfg.param_count():
        fail(f"mixtral params {n_params} != the schema's {cfg.param_count()}")
    rng = np.random.default_rng(22)
    b, gen, page, e = 4, 32, 16, cfg.moe.n_experts
    runs = {}
    for plen in (64, 4096):
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (b, plen)).astype(np.int32)).to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            logits, cache = engine.prefill(params, cfg, tokens=prompts,
                                           max_len=plen + gen)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            prefill_launches, prefill_routes = read_counts(), read_routes()
            tokens = torch.argmax(logits, -1).to(torch.int32)
            out_tokens, counts = [tokens], []
            t0 = time.perf_counter()
            for _ in range(gen - 1):
                logits, cache, aux = engine.decode_step(
                    params, cfg, cache, tokens, page_size=page)
                tokens = torch.argmax(logits, -1).to(torch.int32)
                out_tokens.append(tokens)
                counts.append(aux["expert_counts"])
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
        launches, routes = read_counts(), read_routes()
        want = dict(NO_KERNELS, flash_attention=MIXTRAL_LAYERS)
        want_routes = {"tensor_core": MIXTRAL_LAYERS, "tf32x3": 0,
                       "cuda_core": 0}
        if prefill_launches != want or launches != want or \
                prefill_routes != want_routes or routes != want_routes:
            fail(f"mixtral prompt {plen}: prefill launches "
                 f"{prefill_launches} {prefill_routes}, in all {launches} "
                 f"{routes}; expected {MIXTRAL_LAYERS} flash_attention on "
                 f"the tensor cores, none in decode")
        steps = torch.stack(counts).cpu().numpy()          # (gen-1, L, E)
        toks = torch.stack(out_tokens, 1).cpu().numpy()
        if not ((steps.sum(-1) == b * cfg.moe.top_k).all()
                and steps.shape == (gen - 1, MIXTRAL_LAYERS, e)
                and toks.shape == (b, gen)
                and ((toks >= 0) & (toks < cfg.vocab_size)).all()
                and bool(torch.isfinite(logits.float()).all())):
            fail(f"mixtral prompt {plen}: decode outputs out of range")
        runs[plen] = dict(
            prefill_s=prefill_s, prefill_tok_s=b * plen / prefill_s,
            decode_s=decode_s, decode_tok_s=b * (gen - 1) / decode_s,
            decode_expert_counts_per_layer=steps.sum(0).tolist(),
            launches=launches, flash_attention_routes=routes,
            peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        say("moe_serve", arch=cfg.name, n_layers=MIXTRAL_LAYERS,
            reduced="n_layers 56 -> 2", batch=b, prompt_len=plen, gen=gen,
            page_size=page, **runs[plen])
        del prompts, logits, cache
    say("moe_layer_gpu_vs_cpu", arch=cfg.name, tokens=MOE_CHECK_TOKENS,
        dtype="float32", tolerance=MOE_F32_TOL,
        by_capacity_factor=moe_layer_full_width(dev, params, cfg))
    say("moe_serve_params", n_params=n_params,
        param_gib=n_params * 4 / 2 ** 30, draw_s=draw_s,
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, n_experts=e, top_k=cfg.moe.top_k,
        d_expert=cfg.moe.d_expert, vocab=cfg.vocab_size, window=cfg.window)
    del params
    free_device_memory()
    return runs[64]["launches"]


def moe_scenario_gpu_vs_cpu(dev, run_scenario, zero_counts, read_counts,
                            read_routes) -> dict:
    """Phase 22d: ``MoEExpertScenario()`` (the kimi-k2 smoke model, 6
    epochs of 4 batches) on the GPU: one flash_attention launch a layer a
    batch, on the route ``kernel.route`` names; the same on the CPU; the
    GPU's
    stream and forwards held to the CPU's (``check_moe_stream``);
    ``run_scenario`` fed the CPU's stream byte-identical GPU vs CPU for
    hints in {False, True} x sync_every in {1, 4}; then the port's
    ``expert_tiering_moe`` example on the GPU.  Returns the forwards'
    launches by route."""
    from repro_torch.examples import expert_tiering_moe
    from repro_torch.scenarios import MoEExpertScenario
    t0 = time.perf_counter()
    zero_counts()
    gpu = MoEExpertScenario()
    list(gpu.epochs())
    fwd_launches, fwd_routes = read_counts(), read_routes()
    n_fa = gpu.cfg.n_layers * gpu.n_epochs * gpu.batches_per_epoch
    want_routes = fa_routes(gpu.cfg.activ_dtype, gpu.cfg.head_dim, n_fa)
    if fwd_launches != dict(NO_KERNELS, flash_attention=n_fa) or \
            fwd_routes != want_routes:
        fail(f"MoEExpertScenario launches {fwd_launches}, routes "
             f"{fwd_routes}; expected {n_fa} flash_attention, "
             f"{want_routes}")
    cpu = MoEExpertScenario(device="cpu")
    c_eps = list(cpu.epochs())
    stream = check_moe_stream(gpu, cpu, "moe_scenario")
    zero_counts()
    for hints in (False, True):
        for k in (1, 4):
            g = run_scenario(gpu, hints=hints, sync_every=k, epochs=c_eps)
            c = run_scenario(cpu, hints=hints, sync_every=k, epochs=c_eps,
                             device="cpu")
            if json.dumps(g, sort_keys=True) != json.dumps(c, sort_keys=True):
                fail(f"MoE trajectory differs GPU vs CPU (hints={hints}, "
                     f"sync_every={k})")
    run_launches = read_counts()
    rows = 4 * gpu.n_epochs * gpu.batches_per_epoch
    if run_launches != dict(NO_KERNELS, observe_scatter=rows,
                            hist_select=4 * gpu.n_epochs):
        fail(f"MoE run_scenario launches {run_launches}")
    zero_counts()
    expert_tiering_moe.main(["--device", "cuda"])
    ex_launches = read_counts()
    say("moe_scenario", n_blocks=gpu.n_blocks, k_hot=gpu.k_hot,
        batch_len=gpu.batch_len, forward_launches=fwd_launches,
        forward_flash_attention_routes=fwd_routes, run_launches=run_launches,
        trajectories_identical=True, gpu_stream_vs_cpu=stream,
        accesses=gpu.n_epochs * gpu.batches_per_epoch * gpu.batch_len,
        example_launches=ex_launches, seconds=time.perf_counter() - t0)
    return fwd_routes



# phase 23: the recurrent families.  (a) GPU vs CPU on the smoke models at
# S = RECURRENT_SMOKE_LEN (three chunks of 64, the last padded) and three
# decode steps; float32 within RECURRENT_F32_TOL (relative and absolute:
# the same float32 products summed in another order by cuBLAS and the CPU's
# BLAS, through the layers and the carried state); bfloat16 within
# RECURRENT_BF16_TOL of the CPU on at least RECURRENT_BF16_WITHIN of the
# elements and within twice that everywhere, the rule of
# tests/_torch_recurrent.py (two bfloat16 runs that round at other places;
# logits and the float32 states at the tighter one).  (b) one block at
# full width on RECURRENT_CHECK_TOKENS tokens, float32.  (d) flash_attention
# at zamba2-2.7b's prefill shape (label, B, H, KVH, d).
RECURRENT_ARCHS = ("rwkv6-3b", "zamba2-2.7b")
# 23c's profiles: the first layers of the full-width draw (a profiled
# prefill of B 4 x 4,096 at all 32 / 54 layers took 45 / 73 s on a slow
# host, the script's limit nearing)
RECURRENT_PROFILE_LAYERS = {"rwkv6-3b": 4, "zamba2-2.7b": 6}
RECURRENT_SMOKE_LEN = 150
RECURRENT_F32_TOL = 1e-4
RECURRENT_BF16_TOL = {"hidden": 6e-2, "logits": 1e-2}
RECURRENT_BF16_WITHIN = 0.99
RECURRENT_CHECK_TOKENS = 130
ZAMBA2_TIME_SHAPE = ("zamba2-2.7b", 4, 32, 32, 80)
# kimi-k2's attention (64 heads over 8, d 112) at B 2: the plain version's
# float32 scores are then 8.6 GB a tensor
KIMI_TIME_SHAPE = ("kimi-k2", 2, 64, 8, 112)


def fa_routes(dtype, d: int, n: int) -> dict:
    """flash_attention's launches by route when ``n`` launches take the
    route ``kernel.route`` names for (dtype, d)."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    out = dict.fromkeys(fa_kernel.ROUTE_LAUNCHES, 0)
    out[fa_kernel.route(dtype, d)] += n
    return out


def bwd_routes(dtype, d: int, n: int) -> dict:
    """The backward's calls by route (``kernel.BWD_ROUTE_LAUNCHES``) when
    ``n`` take the route of (dtype, d)."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    out = dict.fromkeys(fa_kernel.BWD_ROUTE_LAUNCHES, 0)
    out[fa_kernel.route(dtype, d)] += n
    return out


def read_bwd_routes() -> dict:
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    return dict(fa_kernel.BWD_ROUTE_LAUNCHES)


@contextlib.contextmanager
def plain_backward_calls():
    """Counts the calls of the plain backward (``attention_bwd_ref``)
    through ``flash_attention_bwd``'s dispatch while the block runs:
    yields a dict whose ``"calls"`` the block reads at its end."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    real, seen = fa_ops.attention_bwd_ref, {"calls": 0}

    def counted(*a, **kw):
        seen["calls"] += 1
        return real(*a, **kw)

    fa_ops.attention_bwd_ref = counted
    try:
        yield seen
    finally:
        fa_ops.attention_bwd_ref = real


def perturbed_params(cfg, seed: int, leaves=None) -> dict:
    """``cfg``'s parameters (or the schema leaves whose path starts with one
    of ``leaves``) drawn by the tests' recipe (``tests/_perturbed_weights.py``:
    every leaf, not the init's zeros), on the host CPU."""
    sys.path.insert(0, str(ROOT / "tests"))
    from _perturbed_weights import perturbed_tree
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.model import iter_schema
    schema = [(p, spec) for p, spec in iter_schema(cfg)
              if leaves is None or p.startswith(leaves)]
    return params_from_numpy(perturbed_tree(schema, seed), device="cpu")


def to_device(tree, dev):
    return {k: to_device(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def held_to_cpu(label: str, got, want, kind: str) -> float:
    """Phase 23's comparison of one output (``kind``: "hidden" or "logits",
    the bfloat16 tolerance; float32 is RECURRENT_F32_TOL) -> max abs err."""
    import torch
    got, want = got.float().cpu(), want.float().cpu()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        fail(f"{label}: shape {tuple(got.shape)} vs {tuple(want.shape)} or "
             f"not finite on the GPU")
    diff = (got - want).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if kind == "float32":
        ok = bool((diff <= RECURRENT_F32_TOL * (1 + want.abs())).all())
    else:
        bound = RECURRENT_BF16_TOL[kind] * (1 + want.abs())
        ok = bool((diff <= 2 * bound).all()) and float(
            (diff <= bound).float().mean()) >= RECURRENT_BF16_WITHIN
    if not ok:
        fail(f"{label} GPU vs CPU ({kind}): max abs err {err}")
    return err


def recurrent_run(params, cfg, toks, dev, read_routes=None):
    """forward and prefill over toks[:, :-3], then 3 decode steps (under the
    sync check on the card) -> (outputs by name on the CPU, flash_attention
    launches by route: (prefill, decode))."""
    import torch
    from repro_torch.models.model import forward, logits_fn
    from repro_torch.serve import engine
    s = toks.shape[1] - 3
    toks = torch.from_numpy(toks).to(dev)
    out, routes = {}, None
    if dev.type == "cuda":
        torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            h, _ = forward(params, cfg, tokens=toks[:, :s])
            out["hidden"], out["logits"] = h, logits_fn(params, cfg, h[:, -1:])
            before = read_routes() if read_routes else None
            out["prefill_logits"], cache = engine.prefill(
                params, cfg, tokens=toks[:, :s], max_len=s + 3)
            mid = read_routes() if read_routes else None
            for k in range(3):
                out[f"decode_logits_{k}"], cache, aux = engine.decode_step(
                    params, cfg, cache, toks[:, s + k])
                if aux:
                    fail(f"{cfg.name} decode aux {sorted(aux)}: expected {{}}")
            if read_routes:
                end = read_routes()
                routes = ({r: mid[r] - before[r] for r in mid},
                          {r: end[r] - mid[r] for r in end})
    finally:
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode(0)
    out.update({"cache_" + k: v for k, v in cache.items()})
    return {k: v.cpu() for k, v in out.items()}, routes


def recurrent_smoke_gpu_vs_cpu(dev, read_routes) -> dict:
    """Phase 23a: both smoke models in float32 and bfloat16 on the GPU and
    on the CPU (``recurrent_run``), the same perturbed weights and tokens.
    Returns the largest errors by arch and dtype."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    t0 = time.perf_counter()
    errs = {}
    for arch in RECURRENT_ARCHS:
        for act in (torch.float32, torch.bfloat16):
            cfg = dataclasses.replace(get_smoke_config(arch), activ_dtype=act)
            name = str(act).split(".")[-1]
            params = perturbed_params(cfg, 0)
            toks = np.random.default_rng(23).integers(
                0, cfg.vocab_size, (2, RECURRENT_SMOKE_LEN + 3))
            got, routes = recurrent_run(to_device(params, dev), cfg, toks,
                                        dev, read_routes)
            want, _ = recurrent_run(params, cfg, toks, torch.device("cpu"))
            n_fa = cfg.n_shared_attn if cfg.family == "zamba2" else 0
            want_routes = (fa_routes(act, cfg.head_dim, n_fa),
                           fa_routes(act, cfg.head_dim, 0))
            if routes != want_routes:
                fail(f"{cfg.name} {name} flash_attention launches (prefill, "
                     f"decode) {routes}: expected {want_routes}")
            if got.keys() != want.keys() or not torch.equal(
                    got["cache_pos"], want["cache_pos"]):
                fail(f"{cfg.name} {name}: outputs {sorted(got)} vs "
                     f"{sorted(want)}")
            errs[f"{arch} {name}"] = {
                key: held_to_cpu(
                    f"{cfg.name} {name} {key}", got[key], want[key],
                    "float32" if act == torch.float32 else
                    "logits" if "logits" in key or key in (
                        "cache_wkv", "cache_ssm") else "hidden")
                for key in got if key != "cache_pos"}
    say("recurrent_smoke_gpu_vs_cpu", prompt_len=RECURRENT_SMOKE_LEN,
        decode_steps=3, max_abs_err=errs, float32_tolerance=RECURRENT_F32_TOL,
        bfloat16_tolerance=RECURRENT_BF16_TOL,
        bfloat16_within=RECURRENT_BF16_WITHIN,
        seconds=time.perf_counter() - t0)
    return errs


def recurrent_block_full_width(dev, read_routes) -> dict:
    """Phase 23b: one block at the published widths in float32 on B 1 x
    RECURRENT_CHECK_TOKENS tokens (three chunks, the last padded), GPU
    against CPU on the same perturbed weights and input: rwkv6-3b's layer 0
    (output, wkv state); zamba2-2.7b's first group, 6 Mamba2 layers (each
    output and SSM state) and the shared block at invocation 0 (one
    flash_attention launch, float32 at d 80: the TF32 route).  Returns
    zamba2-2.7b's flash_attention launches by route."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as tm
    t0 = time.perf_counter()
    errs = {}
    pos = torch.arange(RECURRENT_CHECK_TOKENS)[None]
    for arch in RECURRENT_ARCHS:
        full = get_config(arch)
        cfg = dataclasses.replace(
            full, activ_dtype=torch.float32,
            n_layers=1 if full.family == "rwkv6" else full.zamba_attn_every)
        x = torch.from_numpy(np.random.default_rng(24).normal(
            size=(1, RECURRENT_CHECK_TOKENS, cfg.d_model)).astype(np.float32))
        params = perturbed_params(cfg, 1, ("blocks.", "shared_attn."))
        outs = []
        for d in (dev, torch.device("cpu")):
            par = to_device(params, d)
            h, got = x.to(d), {}
            before = read_routes()
            with torch.no_grad():
                if cfg.family == "rwkv6":
                    got["out"], got["wkv"] = tm.rwkv6_block(
                        h, tm.layer_params(par, 0), cfg)
                else:
                    for i in range(cfg.n_layers):
                        h, got[f"ssm_{i}"] = tm.zamba2_mamba_block(
                            h, tm.layer_params(par, i), cfg)
                        got[f"out_{i}"] = h
                    got["shared_out"] = tm.zamba2_shared_attention(
                        h, par["shared_attn"], cfg, 0, pos.to(d))
            routes = {r: n - before[r] for r, n in read_routes().items()}
            outs.append({k: v.cpu() for k, v in got.items()})
            if d == dev and routes != fa_routes(
                    cfg.activ_dtype, cfg.head_dim,
                    int(cfg.family == "zamba2")):
                fail(f"{arch} full-width block flash_attention routes "
                     f"{routes}")
            if d == dev and cfg.family == "zamba2":
                zamba2_routes = routes
            del par, got, h
        gpu, cpu = outs
        errs[arch] = {k: held_to_cpu(f"{arch} full-width block {k}", gpu[k],
                                     cpu[k], "float32") for k in cpu}
        del params, outs, gpu, cpu
        free_device_memory()
    say("recurrent_block_gpu_vs_cpu", tokens=RECURRENT_CHECK_TOKENS,
        dtype="float32", tolerance=RECURRENT_F32_TOL, max_abs_err=errs,
        seconds=time.perf_counter() - t0)
    return zamba2_routes


def recurrent_serve_full_width(serve_launcher, dev, zero_counts, read_counts,
                               read_routes) -> dict:
    """Phase 23c: rwkv6-3b and zamba2-2.7b at their published widths
    through ``launch.serve.main`` (float32 weights drawn on the card, bf16
    activations, all layers): B 4, prompts 64 and 4,096, 32 tokens.  Every
    prefill and decode step runs under ``set_sync_debug_mode("error")``
    (``engine.prefill`` / ``decode_step`` wrapped for the call); the
    weights are drawn once per arch, on the card (the launcher's
    ``init_params`` replaced by ``ep_params``, which hands the 4,096-token
    run the first run's draw, whose time is the draw's).  Checks: flash_attention n_shared_attn times (9) a
    zamba2 prefill on the route ``kernel.route`` names (bf16 at d 80: the
    tensor cores), none in decode, none for rwkv6, no other kernel; tokens in range, logits finite, no page telemetry.
    Reports the draw, prefill and decode tokens/s and peak memory.
    Returns zamba2's 64-token run's launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serve import engine
    real = {"prefill": engine.prefill, "decode_step": engine.decode_step,
            "init_params": serve_launcher.init_params}
    drawn, seen = {}, {}

    def checked(name):
        def call(*args, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = real[name](*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            seen.setdefault(name, read_counts())
            seen[name + "_routes"] = read_routes()
            seen["logits"] = out[0]
            return out
        return call

    def draw_once(cfg, seed, device):
        if cfg.name not in drawn:
            drawn[cfg.name] = ep_params(cfg, torch.device(device), ())
        return drawn[cfg.name]

    runs = {}
    engine.prefill, engine.decode_step = checked("prefill"), checked(
        "decode_step")
    serve_launcher.init_params = draw_once
    try:
        for arch in RECURRENT_ARCHS:
            cfg = get_config(arch)
            n_fa = cfg.n_shared_attn if cfg.family == "zamba2" else 0
            # the last arch's weights go before this one's peak is taken
            drawn.clear()
            free_device_memory()
            for plen in (64, 4096):
                seen.clear()
                torch.cuda.reset_peak_memory_stats(dev)
                zero_counts()
                rep = serve_launcher.main(
                    ["--arch", arch, "--batch", "4", "--prompt-len",
                     str(plen), "--gen", "32"])
                torch.cuda.synchronize()
                launches, routes = read_counts(), read_routes()
                want = dict(NO_KERNELS, flash_attention=n_fa)
                want_routes = fa_routes(cfg.activ_dtype, cfg.head_dim, n_fa)
                if not (seen["prefill"] == launches == want
                        and routes == want_routes):
                    fail(f"{arch} prompt {plen}: prefill launches "
                         f"{seen['prefill']}, in all {launches} {routes}; "
                         f"expected {n_fa} flash_attention in the prefill "
                         f"({want_routes}), none in decode")
                toks = rep["tokens"]
                if not (toks.shape == (4, 32) and rep["page_mass"] is None
                        and ((toks >= 0) & (toks < cfg.vocab_size)).all()
                        and bool(torch.isfinite(seen["logits"].float()).all())):
                    fail(f"{arch} prompt {plen}: serving outputs out of range")
                key = f"{arch} {plen}"
                runs[key] = dict(
                    init_s=rep["init_s"], prefill_s=rep["prefill_s"],
                    prefill_tok_s=rep["prefill_tok_s"],
                    decode_s=rep["decode_s"], decode_tok_s=rep["decode_tok_s"],
                    launches=launches, flash_attention_routes=routes,
                    peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
                say("recurrent_serve", arch=arch, batch=4, prompt_len=plen,
                    gen=32, n_layers=cfg.n_layers,
                    params=cfg.param_count(),
                    weights_reused=plen != 64, **runs[key])
            recurrent_serve_profile(dev, cfg, drawn[cfg.name],
                                    real["prefill"])
    finally:
        engine.prefill, engine.decode_step = real["prefill"], real[
            "decode_step"]
        serve_launcher.init_params = real["init_params"]
        drawn.clear()
        seen.clear()
        free_device_memory()
    return runs["zamba2-2.7b 64"]["launches"]


def recurrent_serve_profile(dev, cfg, params, prefill) -> None:
    """Phase 23c, where the time goes (``profiled_steps``), at ``cfg``'s
    RECURRENT_PROFILE_LAYERS first layers of ``params``: one prefill of B
    4 x 4,096 tokens, then 8 decode steps after a 64-token prefill."""
    import torch
    n = RECURRENT_PROFILE_LAYERS[cfg.name]
    cfg = dataclasses.replace(cfg, n_layers=n)
    params = dict(params, blocks={k: v[:n]
                                  for k, v in params["blocks"].items()})
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    toks = torch.randint(0, cfg.vocab_size, (4, 4096), generator=gen,
                         device=dev)
    with torch.no_grad():
        prof = profiled_steps(
            lambda: prefill(params, cfg, tokens=toks, max_len=4096), 1)
        say("recurrent_prefill_profile", arch=cfg.name, n_layers=n,
            prompt_len=4096, **prof)
        logits, cache = prefill(params, cfg, tokens=toks[:, :64],
                                max_len=64 + 9)
        prof = profiled_steps(decode_steps(params, cfg, cache,
                                           torch.argmax(logits, -1)), 8)
    say("recurrent_decode_profile", arch=cfg.name, n_layers=n,
        prompt_len=64, **prof)
    del toks, logits, cache


# ---------------------------------------------------------------- phase 24
# 24a's gradient cases: (label, B, H, KVH, Sq, Sk, d, dtype, causal,
# window): the training shapes of qwen2-0.5b, zamba2's d 80 and Mixtral's
# d 128 with a window; then every other (dtype, d) of the backward kernels,
# with ragged S, GQA, windows whose edge falls inside a tile, non-causal
# Sq != Sk, and (Sq 700 over Sk 300, window 100) rows 400-699 without any key
TRAIN_GRAD_CASES = [
    ("qwen2-0.5b train", 4, 14, 2, 2048, 2048, 64, "bfloat16", True, None),
    ("qwen2-0.5b train f32", 4, 14, 2, 2048, 2048, 64, "float32", True,
     None),
    ("zamba2-2.7b d=80", 2, 32, 32, 2048, 2048, 80, "bfloat16", True, None),
    ("mixtral-8x22b d=128 window 1000", 1, 48, 8, 2048, 2048, 128,
     "bfloat16", True, 1000),
    ("ragged S=1000", 2, 14, 2, 1000, 1000, 64, "bfloat16", True, None),
    ("non-causal Sq=1000 Sk=600", 2, 14, 2, 1000, 600, 64, "bfloat16",
     False, None),
    ("zamba2-2.7b d=80 f32", 2, 32, 32, 1000, 1000, 80, "float32", True,
     None),
    ("mixtral-8x22b d=128 window 300 f32", 1, 48, 8, 1000, 1000, 128,
     "float32", True, 300),
] + [
    (f"{label} {dtype}", b, h, kvh, sq, sk, d, dtype, causal, window)
    for dtype in ("bfloat16", "float32")
    for label, b, h, kvh, sq, sk, d, causal, window in (
        ("d=16 ragged S=1000", 2, 14, 2, 1000, 1000, 16, True, None),
        ("d=32 window 200", 2, 8, 2, 1000, 1000, 32, True, 200),
        ("kimi-k2 d=112", 1, 64, 8, 1024, 1024, 112, True, None),
        ("d=256 rows without keys", 1, 8, 1, 700, 300, 256, True, 100))
]
# the backward's query rows a block: the configs' attn_block_k
TRAIN_BLOCK_Q = 512
# 24a's timed shape, qwen2-0.5b's training attention: (B, H, KVH, S, d)
TRAIN_TIME_SHAPE = (4, 14, 2, 2048, 64)
# the __global__ kernels one backward call launches (flash_attention_bwd.cuh's
# and flash_attention_bwd_wgmma.cuh's launch: the dq kernel, then the dk / dv
# kernel); BWD_ROUTE_LAUNCHES counts calls
BWD_KERNELS_A_CALL = 2
# float32 gradients: within 2e-5 of each tensor's largest magnitude (the
# same float32 products summed in another order); bfloat16 by FLASH_TOL's
# rule (both round one float32 result once)
GRAD_F32_TOL_OF_MAX = 2e-5
# the forward's saved lse (log2 units) against attention_lse_ref's: within
# 1e-5 of max(1, its largest magnitude) (float32 sums in another order, the
# kernels' exp2 approximate to 2 ulp)
LSE_TOL = 1e-5
# 24d: each gradient leaf of the full-width float32 step, GPU against CPU,
# within 1e-4 of that leaf's largest magnitude on the CPU (the rule of the
# train-step tests on the CPU), so a leaf that is zero or wrong fails even
# where its entries are small
TRAIN_LEAF_TOL_OF_MAX = 1e-4
# 24b: qwen2-0.5b at full width, B 4, S 2048, 12 steps, a checkpoint every 6
TRAIN_ARGS = ["--arch", "qwen2-0.5b", "--batch", "4", "--seq", "2048",
              "--steps", "12", "--ckpt-every", "6"]
TRAIN_STEPS, TRAIN_CKPT_STEP, TRAIN_TOKENS = 12, 6, 4 * 2048
# 24c: the resumed run's losses against the uninterrupted run's, relative:
# the embedding gradient's atomic accumulation on the card may sum in
# another order from run to run
TRAIN_RESUME_RTOL = 1e-3
# 24e: the 100M example's steps
EXAMPLE_STEPS = 5


def grad_verdict(got, want, dtype: str):
    """(max |got - want|, [its share of the bound, the share of elements
    that differ at all], within the bound): float32 within
    GRAD_F32_TOL_OF_MAX of want's largest magnitude, bfloat16 by
    FLASH_TOL's rule."""
    if dtype == "bfloat16":
        return flash_verdict(got, want, dtype)
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    allowed = GRAD_F32_TOL_OF_MAX * float(want.abs().max())
    return err, [err / allowed if allowed > 0 else float(err > 0),
                 float((diff > 0).float().mean())], err <= allowed


def train_attention_grads(dev, cases=TRAIN_GRAD_CASES) -> dict:
    """Phase 24a: FlashAttentionFn's dq, dk, dv (the kernel's forward, the
    backward kernels) at every TRAIN_GRAD_CASES case, against autograd of
    the plain version on the card (in float32, rounded once) and against
    the plain backward ``attention_bwd_ref`` on the same inputs, by
    ``grad_verdict``; one forward and one backward launch on the route
    ``kernel.route`` names, a second backward (from the forward's saved
    lse and float32 output, ``flash_attention(return_lse=True)``) bit for
    bit equal to the first, dq 0 on the rows that see no key, and that lse
    against ``attention_lse_ref`` (+inf on the same rows, elsewhere within
    LSE_TOL of max(1, |lse|)).  ``cases``: others of that form (phase
    29's rank).  -> {label: its errors, route and whether the repeat was
    equal}."""
    import torch
    from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                     attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref,
                                                     flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    out = {}
    for i, (label, b, h, kvh, sq, sk, d, dtype, causal, window) in enumerate(
            cases):
        q, k, v = qkv(dev, 240 + i, b, h, kvh, sq, sk, d, dtype)
        gen = torch.Generator(device=dev)
        gen.manual_seed(340 + i)
        do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        g = h // kvh
        kw = dict(q_per_kv=g, causal=causal, window=window)
        mine = [t.detach().requires_grad_() for t in (q, k, v)]
        before = dict(fa_kernel.ROUTE_LAUNCHES)
        o = FlashAttentionFn.apply(*mine, g, causal, window, None,
                                   TRAIN_BLOCK_Q)
        launched = {r: fa_kernel.ROUTE_LAUNCHES[r] - before[r]
                    for r in before}
        b_before = read_bwd_routes()
        got = torch.autograd.grad(o, mine, do)
        b_launched = {r: n - b_before[r] for r, n in read_bwd_routes().items()}
        if launched != fa_routes(q.dtype, d, 1) \
                or b_launched != bwd_routes(q.dtype, d, 1):
            fail(f"FlashAttentionFn ({label}) launched {launched} forward "
                 f"and {b_launched} backward: expected one each on the "
                 f"{fa_kernel.route(q.dtype, d)} route")
        _, lse, o32 = flash_attention(q, k, v, return_lse=True, **kw)
        again = flash_attention_bwd(q, k, v, o32, do, lse, **kw)
        repeat_equal = all(torch.equal(x, y) for x, y in zip(got, again))
        want_lse = attention_lse_ref(q, k, **kw)
        fin = want_lse.isfinite()
        lse_err = float((lse[fin] - want_lse[fin]).abs().max()) \
            if bool(fin.any()) else 0.0
        lse_ok = torch.equal(lse.isinf(), ~fin) and lse_err <= LSE_TOL * max(
            1.0, float(want_lse[fin].abs().max()) if bool(fin.any()) else 1.0)
        del again, o32
        # the plain version's autograd in float32, each gradient rounded
        # once to the inputs' dtype, as the reference's f32 autodiff does
        # (autograd of the plain version on bf16 leaves would round each
        # query head's dk, dv to bf16 before repeat_interleave's backward
        # sums them)
        theirs = [t.detach().float().requires_grad_() for t in (q, k, v)]
        ref = attention_ref(*theirs, **kw)
        want = [t.to(q.dtype) for t in torch.autograd.grad(
            ref, theirs, do.float())]
        ref = ref.to(q.dtype)
        plain = attention_bwd_ref(q, k, v, do, block_q=TRAIN_BLOCK_Q, **kw)
        torch.cuda.synchronize()
        # the rows that see no key: dq exactly 0 there
        keyless = [r for r in range(sq)
                   if (min(r, sk - 1) if causal else sk - 1)
                   < (0 if window is None else max(0, r - window))]
        res = {"route": fa_kernel.route(q.dtype, d),
               "repeat_bit_equal": repeat_equal, "keyless_rows": len(keyless),
               "lse_max_abs_err": lse_err}
        if not lse_ok:
            fail(f"{label}: the forward's lse differs from attention_lse_ref "
                 f"(max abs err {lse_err} on the finite rows, or +inf on "
                 f"other rows)")
        err, share, ok = flash_verdict(o.detach(), ref.detach(), dtype)
        res["forward"] = [err, share]
        if not ok:
            fail(f"FlashAttentionFn's forward differs from the plain version"
                 f" ({label}, {dtype}): max abs err {err}, share of the "
                 f"tolerance and share differing {share}")
        for name, gt, wt, pt in zip(("dq", "dk", "dv"), got, want, plain):
            if gt.dtype != wt.dtype or gt.shape != wt.shape:
                fail(f"{label} {name}: {gt.dtype} {tuple(gt.shape)} against "
                     f"{wt.dtype} {tuple(wt.shape)}")
            err, share, ok = grad_verdict(gt, wt, dtype)
            p_err, p_share, p_ok = grad_verdict(gt, pt, dtype)
            res[name] = [err] + share
            res[name + "_vs_plain_backward"] = [p_err] + p_share
            if not (ok and p_ok):
                fail(f"FlashAttentionFn's {name} differs from autograd of "
                     f"the plain version ({label}, {dtype}): max abs err "
                     f"{err}, share of the tolerance and share differing "
                     f"{share}; from attention_bwd_ref: {p_err}, {p_share}")
        if keyless and bool(got[0][:, keyless].any()):
            fail(f"{label}: dq is not 0 on the {len(keyless)} rows that see "
                 f"no key")
        if not repeat_equal:
            fail(f"{label}: two backward calls on the same input differ")
        out[label] = res
        del q, k, v, do, mine, theirs, o, ref, got, want, plain, lse
    free_device_memory()
    say("train_attention_grad", cases=[list(c) for c in cases],
        results=out, block_q=TRAIN_BLOCK_Q,
        float32_tolerance_of_max=GRAD_F32_TOL_OF_MAX,
        bfloat16_tolerance=FLASH_TOL["bfloat16"], lse_tolerance=LSE_TOL)
    return out


def peak_bytes(fn) -> int:
    """The device memory ``fn()`` takes above what was allocated before
    it, at its peak."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated() - base


def train_attention_time(dev, shape=TRAIN_TIME_SHAPE,
                         dtypes=("bfloat16", "float32")) -> dict:
    """Phase 24a's times at qwen2-0.5b's training shape (B 4, H 14, KVH 2,
    S 2048, d 64, causal), in bfloat16 (the tensor-core route) and float32
    (the TF32 route), each in turns: the backward kernels
    (``flash_attention_bwd``), the plain backward (``attention_bwd_ref``),
    ``F.scaled_dot_product_attention``'s backward alone (the library time)
    and its forward + backward, and in bfloat16 the kernel's forward and
    the plain version's forward + backward (autograd); the peak memory of
    the backwards, and in bfloat16 the saving forward (FlashAttentionFn's,
    which writes the lse and the float32 output too).  The kernels'
    backward is timed from what the forward saved (its lse and float32 output, ``flash_attention(return_lse=True)``
    once before), as ``sdpa``'s backward is timed from its saved forward.
    The backward's bound: its five products (2.5 times the forward's causal
    2·B·H·S²·d) at the dtype's tensor-core rate (in float32 three TF32
    products each, the fewest that keep float32 accuracy), or q, k, v, dO
    read and dq, dk, dv written once.  The kernels' own floor: their
    products at that rate, eleven of the forward's halves in bfloat16 (S
    and dP in both kernels, dq, dk and dv twice for the hi / lo split, and
    the dq kernel's P_hi.K for D's residual), seven in float32, three TF32
    products each.  ``shape`` (B, H, KVH, S, d) and ``dtypes`` another
    shape's times (phase 29's rank).  -> {dtype: its times}."""
    import torch
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_ref,
                                                     flash_attention,
                                                     flash_attention_bwd)
    b, h, kvh, s, d = shape
    g = h // kvh
    sdpa = torch.nn.functional.scaled_dot_product_attention
    shape4 = [(b, -1, s, d)] * 3
    flops = 2 * b * h * s * s * d
    res = {}
    for dtype in dtypes:
        q, k, v = qkv(dev, 250, b, h, kvh, s, s, d, dtype)
        gen = torch.Generator(device=dev)
        gen.manual_seed(350)
        do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        leaves4 = [t.detach().view(sh).requires_grad_()
                   for t, sh in zip((q, k, v), shape4)]
        o4 = sdpa(*leaves4, is_causal=True, enable_gqa=True)
        do4 = do.view(b, h, s, d)

        _, lse, o32 = flash_attention(q, k, v, q_per_kv=g, return_lse=True)

        def kernel_bwd():
            return flash_attention_bwd(q, k, v, o32, do, lse, q_per_kv=g)

        def plain_bwd():
            return attention_bwd_ref(q, k, v, do, q_per_kv=g,
                                     block_q=TRAIN_BLOCK_Q)

        def sdpa_bwd():
            return torch.autograd.grad(o4, leaves4, do4, retain_graph=True)

        def sdpa_fwd_bwd():
            leaves = [t.detach().view(sh).requires_grad_()
                      for t, sh in zip((q, k, v), shape4)]
            o = sdpa(*leaves, is_causal=True, enable_gqa=True)
            return torch.autograd.grad(o, leaves, do4)

        def forward():
            return flash_attention(q, k, v, q_per_kv=g)

        def forward_saving():
            return flash_attention(q, k, v, q_per_kv=g, return_lse=True)

        def plain_fwd_bwd():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            return torch.autograd.grad(
                attention_ref(*leaves, q_per_kv=g), leaves, do)

        fns = {"ms": kernel_bwd, "plain_ms": plain_bwd,
               "sdpa_bwd_ms": sdpa_bwd, "sdpa_fwd_bwd_ms": sdpa_fwd_bwd}
        if dtype == "bfloat16":
            fns.update(forward_ms=forward, forward_saving_ms=forward_saving,
                       plain_fwd_bwd_ms=plain_fwd_bwd)
        runs = {name: [] for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            runs[name].append(time_ms(fns[name], 3))
        out = {name: sum(t) / len(t) for name, t in runs.items()}
        elt = q.element_size()
        n_bytes = elt * (3 * b * h * s * d + 4 * b * kvh * s * d)
        if dtype == "bfloat16":
            rate, needed, kernel_flops = TENSOR_BF16_OPS_PER_S, 2.5, 5.5 * flops
        else:
            rate, needed, kernel_flops = (TENSOR_TF32_OPS_PER_S, 3 * 2.5,
                                          3 * 3.5 * flops)
        bound, by = bound_ms(n_bytes, needed * flops, rate)
        out.update(shape=[b, h, kvh, s, d], dtype=dtype,
                   route="tensor_core" if dtype == "bfloat16" else "tf32x3",
                   bound_ms=bound, bound_by=by, share_of_bound=bound / out["ms"],
                   kernel_flops=kernel_flops,
                   kernel_floor_ms=kernel_flops / rate * 1e3,
                   function_tflop_s=2.5 * flops / out["ms"] / 1e9,
                   ms_over_sdpa_bwd_ms=out["ms"] / out["sdpa_bwd_ms"],
                   speedup_over_plain=out["plain_ms"] / out["ms"],
                   peak_gib=peak_bytes(kernel_bwd) / 2 ** 30,
                   plain_peak_gib=peak_bytes(plain_bwd) / 2 ** 30,
                   sdpa_fwd_bwd_peak_gib=peak_bytes(sdpa_fwd_bwd) / 2 ** 30,
                   causal_flops=flops, bytes=n_bytes)
        if dtype == "bfloat16":
            out["plain_fwd_bwd_peak_gib"] = peak_bytes(plain_fwd_bwd) / 2 ** 30
        say("train_attention_time", **out)
        res[dtype] = out
        del q, k, v, do, leaves4, o4, do4, lse, o32
        free_device_memory()
    return res


def instrumented_train(train_launcher, args, read_counts, read_routes,
                       capture_step=None):
    """``train_launcher.main(args)`` with its step function wrapped: each
    step runs under ``set_sync_debug_mode("error")`` (no host sync inside
    ``step_fn``; the trainer's loss read comes after it), and its wall, its
    flash_attention launches and backward calls by route and its batch's
    tokens are recorded; the state after step ``capture_step`` is cloned on
    the card; ``rec["plain_backward"]`` counts the calls of the plain
    backward in the run.  -> (the trainer's report, the record)."""
    import torch
    from repro_torch.pytree import tree_map
    rec = {"steps": [], "tokens": [], "state": None, "last": None}
    real = train_launcher.make_train_step

    def factory(*a, **kw):
        step = rec["step_fn"] = real(*a, **kw)

        def wrapped(params, opt_state, batch):
            before, b_before = read_routes(), read_bwd_routes()
            hs_before = read_counts()["hist_select"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = step(params, opt_state, batch)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after, b_after = read_routes(), read_bwd_routes()
            n = int(out[1].step)
            rec["steps"].append(dict(
                step=n, wall_s=wall,
                routes={r: after[r] - before[r] for r in after},
                bwd_routes={r: b_after[r] - b_before[r] for r in b_after},
                hist_select=read_counts()["hist_select"] - hs_before))
            rec["tokens"].append(batch["tokens"].cpu())
            if n == capture_step:
                rec["state"] = tree_map(torch.clone, (out[0], out[1]))
            rec["last"] = (out[0], out[1], batch)
            return out
        return wrapped

    train_launcher.make_train_step = factory
    try:
        with plain_backward_calls() as seen:
            report = train_launcher.main(args)
    finally:
        train_launcher.make_train_step = real
    rec["plain_backward"] = seen["calls"]
    return report, rec


def train_full_width(train_launcher, dev, zero_counts, read_counts,
                     read_routes):
    """Phase 24b: ``launch.train.main`` at qwen2-0.5b's full width (B 4, S
    2048, 12 steps, a checkpoint every 6, tiering on): every loss finite
    and the last below the first, 2 x 24 flash_attention launches and 24
    backward calls a step (remat "full"), all on the tensor cores, none of
    the plain backward, one hist_select launch (step
    10's rebalance), no host sync inside a step; step wall, tokens/s, peak
    memory, then one more step under ``torch.profiler``.  -> (the trainer's
    report, the record with the step-6 state, the checkpoint directory,
    the run's launches)."""
    import torch
    ckdir = obs_dir("train")
    free_device_memory()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    report, rec = instrumented_train(
        train_launcher, TRAIN_ARGS + ["--ckpt-dir", str(ckdir)], read_counts,
        read_routes, capture_step=TRAIN_CKPT_STEP)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    launches, b_launches = read_counts(), read_bwd_routes()
    losses = report["losses"]
    per_step = 2 * QWEN_LAYERS
    if not (len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses))
            and losses[-1] < losses[0]):
        fail(f"qwen2-0.5b training losses {losses}: expected {TRAIN_STEPS} "
             f"finite, the last below the first")
    bad = [s for s in rec["steps"]
           if s["routes"] != fa_routes(torch.bfloat16, 64, per_step)
           or s["bwd_routes"] != bwd_routes(torch.bfloat16, 64, QWEN_LAYERS)]
    if bad or rec["plain_backward"] or launches != {
            **NO_KERNELS, "flash_attention": per_step * TRAIN_STEPS,
            "hist_select": 1} or b_launches != bwd_routes(
                torch.bfloat16, 64, QWEN_LAYERS * TRAIN_STEPS):
        fail(f"qwen2-0.5b training launches {launches}, plain backward "
             f"calls {rec['plain_backward']}, steps off the {per_step} "
             f"tensor-core launches and {QWEN_LAYERS} backward calls a "
             f"step: {bad}")
    walls = [s["wall_s"] for s in rec["steps"]]
    warm = sorted(walls[1:])[len(walls[1:]) // 2]
    params, opt_state, batch = rec.pop("last")
    step_fn = rec.pop("step_fn")
    prof = profiled_steps(lambda: step_fn(params, opt_state, batch), 1)
    del params, opt_state, batch
    free_device_memory()
    out = dict(losses=losses, grad_norms=report["grad_norms"],
               step_wall_s=walls, warm_step_s=warm,
               tokens_per_s=TRAIN_TOKENS / warm, trainer_step_s=report["step_s"],
               run_wall_s=wall, peak_mem_gib=peak, launches=launches,
               flash_attention_per_step=per_step,
               backward_calls=b_launches["tensor_core"],
               plain_backward_calls=rec["plain_backward"],
               no_sync_in_step=True, profiled_step=prof)
    say("train_full_width", **out)
    return out, rec, ckdir


def train_resume(train_launcher, dev, ckdir, first, first_losses,
                 read_counts, read_routes) -> dict:
    """Phase 24c: the step-6 checkpoint restores bit for bit (params,
    optimizer state, step) against ``first``'s state after step 6 (24b's
    record), and a second trainer run resumed from it continues through
    step 12 on the uninterrupted run's batches, bit for bit, its losses
    within TRAIN_RESUME_RTOL of the uninterrupted run's
    (``first_losses``)."""
    import os
    import shutil
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.pytree import leaves
    t0 = time.perf_counter()
    state, extra = CheckpointManager(ckdir).restore(step=TRAIN_CKPT_STEP,
                                                    device=dev)
    restore_s = time.perf_counter() - t0
    params6, opt6 = first.pop("state")
    same = (all(torch.equal(a, b) for a, b in zip(
        leaves(state["params"]), leaves(params6)))
        and all(torch.equal(a, b) for a, b in zip(
            leaves(state["opt"]["inner"]), leaves(opt6.inner)))
        and len(leaves(state["params"])) == len(leaves(params6))
        and state["opt"]["step"].dtype == torch.int32
        and int(state["opt"]["step"]) == int(opt6.step) == TRAIN_CKPT_STEP
        and extra["data"]["step"] == TRAIN_CKPT_STEP)
    if not same:
        fail("the step-6 checkpoint does not restore the step-6 state bit "
             "for bit")
    del state, params6, opt6
    free_device_memory()
    resume_dir = obs_dir("train_resume")
    name = f"step_{TRAIN_CKPT_STEP:08d}"
    os.rename(ckdir / name, resume_dir / name)
    report, rec = instrumented_train(
        train_launcher,
        TRAIN_ARGS + ["--ckpt-dir", str(resume_dir), "--resume"],
        read_counts, read_routes)
    rec.pop("last")
    first_losses = first_losses[TRAIN_CKPT_STEP:]
    tokens_equal = len(rec["tokens"]) == TRAIN_STEPS - TRAIN_CKPT_STEP and \
        all(torch.equal(a, b) for a, b in zip(
            first["tokens"][TRAIN_CKPT_STEP:], rec["tokens"]))
    rel = [abs(a - b) / abs(b) for a, b in zip(report["losses"],
                                               first_losses)]
    if not (report["start_step"] == TRAIN_CKPT_STEP and tokens_equal
            and len(rel) == len(first_losses)
            and max(rel) <= TRAIN_RESUME_RTOL):
        fail(f"resumed run: start {report['start_step']}, batches equal "
             f"{tokens_equal}, losses {report['losses']} against "
             f"{first_losses}")
    shutil.rmtree(ckdir, ignore_errors=True)
    shutil.rmtree(resume_dir, ignore_errors=True)
    out = dict(restored_bit_for_bit=True, restore_s=restore_s,
               start_step=report["start_step"], batches_bit_for_bit=True,
               losses=report["losses"], uninterrupted_losses=first_losses,
               losses_equal=report["losses"] == first_losses,
               loss_max_rel_diff=max(rel), tolerance=TRAIN_RESUME_RTOL,
               deterministic_algorithms=torch.are_deterministic_algorithms_enabled())
    say("train_resume", **out)
    return out


def train_gpu_vs_cpu(dev, zero_counts, read_routes) -> dict:
    """Phase 24d: one float32 loss and gradient of qwen2-0.5b at full width
    (B 2, S 64, the weights drawn once on the host), on the card and on the
    CPU: the loss and the gradient norm within FULL_WIDTH_F32_TOL (abs +
    rel, phase 15's), every gradient leaf within TRAIN_LEAF_TOL_OF_MAX of
    that leaf's largest magnitude; on the card 2 x 24 flash_attention
    launches and 24 backward calls on the TF32 route."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.optim.optimizers import global_norm
    from repro_torch.pytree import flatten
    from repro_torch.train.steps import loss_and_grads
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen2-0.5b"),
                              activ_dtype=torch.float32)
    rng = np.random.default_rng(24)
    batch = {key: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64))
                                   .astype(np.int32))
             for key in ("tokens", "labels")}
    params = init_params(cfg, 0, "cpu")
    res = {"cpu": loss_and_grads(params, cfg, batch)}
    params = to_device(params, dev)
    zero_counts()
    res["cuda"] = loss_and_grads(params, cfg, to_device(batch, dev))
    routes, b_routes = read_routes(), read_bwd_routes()
    del params
    if routes != fa_routes(torch.float32, 64, 2 * QWEN_LAYERS) \
            or b_routes != bwd_routes(torch.float32, 64, QWEN_LAYERS):
        fail(f"full-width float32 training step launches {routes}, backward"
             f" calls {b_routes}: expected {2 * QWEN_LAYERS} and "
             f"{QWEN_LAYERS} on the TF32 route")
    (gl, _, gg), (cl, _, cg) = res["cuda"], res["cpu"]
    errs, leaf_max, share = {}, {}, {}
    g_leaves, skeleton = flatten(gg)
    c_leaves = flatten(cg)[0]
    names = flatten(tree_paths(skeleton))[0]
    faults = []
    for key, g, c in [("loss", gl, cl),
                      ("grad_norm", global_norm(gg), global_norm(cg))]:
        g, c = g.float().cpu(), c.float()
        diff = (g - c).abs()
        errs[key] = float(diff.max())
        if not (bool(torch.isfinite(g).all()) and bool(torch.all(
                diff <= FULL_WIDTH_F32_TOL * (1 + c.abs())))):
            faults.append(f"{key}: max abs err {errs[key]} over "
                          f"{FULL_WIDTH_F32_TOL} abs + rel")
    for key, g, c in zip(names, g_leaves, c_leaves):
        g, c = g.float().cpu(), c.float()
        errs[key] = float((g - c).abs().max())
        leaf_max[key] = float(c.abs().max())
        allowed = TRAIN_LEAF_TOL_OF_MAX * leaf_max[key]
        share[key] = errs[key] / allowed if allowed > 0 else float("inf")
        if not (bool(torch.isfinite(g).all()) and share[key] <= 1.0):
            faults.append(f"{key}: max abs err {errs[key]} over "
                          f"{TRAIN_LEAF_TOL_OF_MAX} x its largest "
                          f"magnitude {leaf_max[key]}")
    out = dict(batch=2, seq=64, max_abs_err=errs, leaf_max=leaf_max,
               share_of_tolerance=share, tolerance=FULL_WIDTH_F32_TOL,
               leaf_tolerance_of_max=TRAIN_LEAF_TOL_OF_MAX,
               flash_attention_routes=routes, backward_routes=b_routes,
               seconds=time.perf_counter() - t0)
    say("train_gpu_vs_cpu", **out)
    if faults:
        fail("full-width float32 training GPU vs CPU: " + "; ".join(faults))
    del res, gg, cg, g_leaves, c_leaves
    free_device_memory()
    return out


def tree_paths(tree, prefix: str = ""):
    """``tree`` with each leaf replaced by its dotted path."""
    if isinstance(tree, dict):
        return {k: tree_paths(v, f"{prefix}{k}.") for k, v in tree.items()}
    return prefix[:-1]


def train_example(dev, zero_counts, read_routes) -> dict:
    """Phase 24e: ``repro_torch.examples.train_100m`` (llama-100m: 12
    layers, d 768, 12 / 4 heads at d 64) for EXAMPLE_STEPS steps on the
    card: finite losses, 2 x 12 flash_attention launches and 12 backward
    calls a step on the tensor cores."""
    import shutil
    import torch
    from repro_torch.examples import train_100m
    ckdir = obs_dir("train_100m")
    zero_counts()
    t0 = time.perf_counter()
    rep = train_100m.main(["--steps", str(EXAMPLE_STEPS), "--ckpt-dir",
                           str(ckdir)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    routes, b_routes = read_routes(), read_bwd_routes()
    shutil.rmtree(ckdir, ignore_errors=True)
    want = fa_routes(torch.bfloat16, 64, 2 * 12 * EXAMPLE_STEPS)
    b_want = bwd_routes(torch.bfloat16, 64, 12 * EXAMPLE_STEPS)
    if routes != want or b_routes != b_want \
            or len(rep["losses"]) != EXAMPLE_STEPS or not all(
            map(math.isfinite, rep["losses"])):
        fail(f"train_100m: routes {routes} (expected {want}), backward "
             f"{b_routes} (expected {b_want}), losses {rep['losses']}")
    out = dict(losses=rep["losses"], step_s=rep["step_s"], wall_s=wall,
               flash_attention_routes=routes, backward_routes=b_routes)
    say("train_example", **out)
    return out


def hist_select_train_time(dev, plain) -> dict:
    """hist_select at the trainer's rebalance (qwen2-0.5b: 18,992 blocks of
    8 embedding rows, k 1,899): the counts of the first 10 steps' tokens
    (the pipeline's own batches), the kernel against its plain version
    (exact) and ``torch.topk``, timed in turns."""
    import numpy as np
    import torch
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels.hist_select import kth_key
    vocab, n_blocks = 151_936, 151_936 // 8
    pipe = TokenPipeline(DataConfig(vocab_size=vocab, seq_len=2048,
                                    global_batch=4))
    counts = np.zeros(n_blocks, np.int64)
    for step in range(10):
        np.add.at(counts, pipe.batch(step)["tokens"].reshape(-1) // 8, 1)
    rows = torch.from_numpy(counts.astype(np.int32)[None]).to(dev)
    ks = (n_blocks // 10,)
    err = int((kth_key(rows, None, ks) - kth_key(rows, None, ks,
                                                 backend=plain)).abs().max())
    if err:
        fail(f"hist_select at the trainer's rebalance differs from its "
             f"plain version by {err}")
    ms, plain_ms = in_turns(lambda: kth_key(rows, None, ks, backend=plain),
                            lambda: kth_key(rows, None, ks), 20)
    topk_ms = time_ms(lambda: torch.topk(rows, ks[0], dim=-1,
                                         sorted=False), 20)
    bound, by = bound_ms(4 * rows.numel(), 4 * rows.numel())
    out = dict(rows=list(rows.shape), k=ks[0], max_abs_err=err, ms=ms,
               plain_ms=plain_ms, topk_ms=topk_ms, bound_ms=bound,
               bound_by=by)
    say("hist_select_train_time", **out)
    return out


# ---------------------------------------------------------------- phase 25
def example_stdout(module, device: str) -> str:
    """What ``python -m repro_torch.examples.<module> --device <device>``
    prints."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        module.main(["--device", device])
    return buf.getvalue()


def ranged_observe_scatter(dev, plain, paper_ids) -> dict:
    """Phase 25b: the ranged observe_scatter on phase 12's draw.  A rank of
    a 2-rank and of a 3-rank split (lo > 0, the last range shorter) against
    its plain version and against the whole histogram cut to the range,
    exact, with and without a keep mask; then the W 1 call of the sharded
    run (lo 0, n_global = n) in turns with the unranged call, and the
    2-rank split's second half in turns with its plain version."""
    import torch
    from repro_torch.core.shard import split
    from repro_torch.kernels.observe_scatter import observe_scatter
    n = PAPER_PAGES
    cursor = torch.zeros((), dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(25)
    keep = torch.rand(paper_ids.shape, generator=gen, device=dev) < 0.7
    worst = 0
    for world, rank in ((2, 1), (3, 2), (3, 1)):
        lo, hi = split(n, world, rank)
        for km in (None, keep):
            whole = observe_scatter(paper_ids, cursor, n_blocks=n,
                                    period=401, keep=km)
            got = observe_scatter(paper_ids, cursor, n_blocks=hi - lo,
                                  period=401, keep=km, lo=lo, n_global=n)
            ref = observe_scatter(paper_ids, cursor, n_blocks=hi - lo,
                                  period=401, keep=km, lo=lo, n_global=n,
                                  backend=plain)
            for g, r, w in zip(got, ref, whole):
                err = max(int((g - r).abs().max()),
                          int((g - w[lo:hi]).abs().max()))
                worst = max(worst, err)
                if err:
                    fail(f"ranged observe_scatter differs (W {world}, rank "
                         f"{rank}, keep {km is not None}): {err}")
    m = paper_ids.numel()
    ranged_ms, unranged_ms = in_turns(
        lambda: observe_scatter(paper_ids, cursor, n_blocks=n, period=401),
        lambda: observe_scatter(paper_ids, cursor, n_blocks=n, period=401,
                                lo=0, n_global=n), 20)
    ranged_plain_ms = time_ms(
        lambda: observe_scatter(paper_ids, cursor, n_blocks=n, period=401,
                                lo=0, n_global=n, backend=plain), 20)
    bincount_ms = time_ms(lambda: torch.bincount(paper_ids, minlength=n), 20)
    lo, hi = split(n, 2, 1)
    half_ms, half_plain_ms = in_turns(
        lambda: observe_scatter(paper_ids, cursor, n_blocks=hi - lo,
                                period=401, lo=lo, n_global=n,
                                backend=plain),
        lambda: observe_scatter(paper_ids, cursor, n_blocks=hi - lo,
                                period=401, lo=lo, n_global=n), 20)
    w1_bound, w1_by = bound_ms(4 * m + 2 * 4 * n, 2 * m)
    half_bound, half_by = bound_ms(4 * m + 2 * 4 * (hi - lo), 2 * m)
    return {"max_abs_err": worst, "w1_ms": ranged_ms,
            "unranged_ms": unranged_ms, "w1_plain_ms": ranged_plain_ms,
            "bincount_ms": bincount_ms, "w1_bound_ms": w1_bound,
            "w1_bound_by": w1_by, "half_lo": lo, "half_ms": half_ms,
            "half_plain_ms": half_plain_ms, "half_bound_ms": half_bound,
            "half_bound_by": half_by}


def sharded_paper_run(dev, plain, scen, epochs, paper_ids, phase8_json: str,
                      zero_counts, read_counts) -> dict:
    """Phase 25: phase 8's paper-scale online run with its state sharded
    over a 1-rank NCCL mesh (one rank per GPU: this card is the world).
    The group starts from a FileStore under a temporary directory (no TCP
    port) and is destroyed at the end."""
    import os
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.core import runtime, shard
    from repro_torch.examples import hinted_prefetch, quickstart
    from repro_torch.kernels.observe_scatter import kernel as os_kernel
    from repro_torch.launch.mesh import make_telemetry_mesh
    from repro_torch.scenarios import build_hints, run_scenario

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_store_")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_telemetry_mesh(1)
        # (a) under the sync check, against phase 8's meshless JSON
        pipeline = build_hints(scen)
        zero_counts()
        torch.cuda.synchronize()
        before = dict(shard.COLLECTIVES)
        with runtime.counting() as c:
            torch.cuda.set_sync_debug_mode("error")
            t0 = time.perf_counter()
            try:
                res = run_scenario(scen, hints=pipeline, sync_every=4,
                                   epochs=epochs, mesh=mesh)
                torch.cuda.synchronize()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            wall = time.perf_counter() - t0
        launches = read_counts()
        modes = dict(os_kernel.MODE_LAUNCHES)
        coll = {k: shard.COLLECTIVES[k] - before[k] for k in before}
        dispatch = dict(c.dispatch.items())
        n_ep = scen.n_epochs
        same = json.dumps(res, sort_keys=True) == phase8_json
        if not same:
            fail("the sharded paper run's JSON differs from phase 8's "
                 "meshless run")
        if (launches["observe_scatter"], launches["hist_select"]) != (12, 6):
            fail(f"sharded paper run launches {launches}, expected 12 "
                 f"observe_scatter and 6 hist_select")
        if dispatch["record_sync"] != 2:
            fail(f"sharded paper run made {dispatch['record_sync']} record "
                 f"pulls, expected 2")
        if (dispatch["observe_all"], dispatch["epoch_step"]) != (n_ep, n_ep):
            fail(f"sharded paper run dispatches {dispatch}")
        if any(v % n_ep for v in coll.values()):
            fail(f"collectives {coll} are not the same every epoch")
        # (b) the warm epoch with the mesh, in turns with the meshless run
        walls = {True: [], False: []}
        for on in (True, False, False, True):
            pipeline = build_hints(scen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_scenario(scen, hints=pipeline, sync_every=4, epochs=epochs,
                         mesh=mesh if on else None)
            torch.cuda.synchronize()
            walls[on].append((time.perf_counter() - t0) / n_ep)
        # (c) the ranged kernel, exact, and its times
        ranged = ranged_observe_scatter(dev, plain, paper_ids)
        # (d) both new examples on the card against their CPU run
        examples = {}
        for mod in (quickstart, hinted_prefetch):
            t0 = time.perf_counter()
            gpu = example_stdout(mod, "cuda")
            cpu = example_stdout(mod, "cpu")
            if gpu != cpu or not gpu.strip():
                fail(f"{mod.__name__} prints differently on the card and "
                     f"on the CPU")
            examples[mod.__name__.rsplit(".", 1)[-1]] = {
                "lines": len(gpu.splitlines()), "identical": True,
                "seconds": time.perf_counter() - t0}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"world": 1, "n_pages": PAPER_PAGES, "k_hot": scen.k_hot,
           "epochs": n_ep, "json_identical_to_phase8": same,
           "launches": launches, "observe_scatter_modes": modes,
           "dispatch": dispatch,
           "collectives_per_epoch": {k: v // n_ep for k, v in coll.items()},
           "cold_epoch_wall_s": wall / n_ep,
           "warm_epoch_wall_s_mesh": walls[True],
           "warm_epoch_wall_s_meshless": walls[False],
           "warm_ratio": sum(walls[True]) / sum(walls[False]),
           "ranged_observe_scatter": ranged, "examples": examples,
           "seconds": time.perf_counter() - t_phase}
    say("sharded_paper_run", **out)
    if out["seconds"] > 60:
        fail(f"phase 25 took {out['seconds']:.1f} s, over its 60 s")
    return out


# ---------------------------------------------------------------- phase 26
# 26: the sharded train step at qwen2-0.5b's full width, phase 24b's shape
# (B 4, S 2048, remat "full", AdamW), over a (1, 1) ("data", "model") mesh
SHARDED_STEPS = 3
SHARDED_LR = (3e-4, 1, 12)        # phase 24b's schedule (12 steps, warmup 1)


def sharded_train_step(dev, zero_counts, read_counts, read_routes) -> dict:
    """Phase 26: ``train.sharded.make_sharded_train_step`` on a 1-rank NCCL
    group (one rank per GPU: this card is the world) and a (1, 1) ("data",
    "model") mesh, SHARDED_STEPS steps in turns with the meshless
    ``make_train_step`` from the same params and batches: losses, grad
    norms and every param and optimizer leaf equal bit for bit; every leaf
    on ``named(mesh, model_pspecs / opt_pspecs)``; 2 x 24 flash_attention
    launches a step, all on the tensor cores; no host sync inside a step;
    the same collectives every step.  Then the meshless state saved and
    restored with ``shardings=`` onto the mesh, bit for bit."""
    import os
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import init_params
    from repro_torch.optim import OptState, cosine_schedule, get_optimizer
    from repro_torch.pytree import leaves, tree_map
    from repro_torch.train import sharded
    from repro_torch.train.steps import make_train_step

    t_phase = time.perf_counter()
    free_device_memory()
    torch.cuda.reset_peak_memory_stats(dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_store_")
    ckdir = obs_dir("train_sharded")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        cfg = get_config("qwen2-0.5b")
        opt = get_optimizer("adamw")
        sched = cosine_schedule(*SHARDED_LR)
        params = init_params(cfg, 0, dev)
        state = opt.init(params)
        shardings = sharded.state_shardings(mesh, cfg, state)
        d_params, d_state = sh.distribute((params, state), shardings)
        step_m = make_train_step(cfg, opt, sched)
        step_s = sharded.make_sharded_train_step(cfg, opt, sched, mesh)
        pipeline = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                            seq_len=2048, global_batch=4,
                                            seed=0))
        per_step = 2 * QWEN_LAYERS
        rec = {"mesh": [], "meshless": [], "collectives": [], "routes": [],
               "launches": [], "bwd_routes": [], "plain_backward": []}

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        for i in range(SHARDED_STEPS):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipeline.batch(i).items()}
            d_batch = sh.distribute(batch, sh.named(
                mesh, sh.batch_specs(mesh, cfg, batch)))
            # in turns: the mesh first on even steps, the meshless on odd
            for on in ((True, False) if i % 2 == 0 else (False, True)):
                if on:
                    zero_counts()
                    before = dict(sh.COLLECTIVES)
                    r0 = read_routes()
                    with plain_backward_calls() as seen:
                        (d_params, d_state, m_s), wall = timed(
                            lambda: step_s(d_params, d_state, d_batch))
                    r1 = read_routes()
                    rec["launches"].append(read_counts())
                    rec["routes"].append({r: r1[r] - r0[r] for r in r1})
                    rec["bwd_routes"].append(read_bwd_routes())
                    rec["plain_backward"].append(seen["calls"])
                    rec["collectives"].append(
                        {k: sh.COLLECTIVES[k] - before[k]
                         for k in before})
                else:
                    (params, state, m_m), wall = timed(
                        lambda: step_m(params, state, batch))
                rec["mesh" if on else "meshless"].append(wall)
            placed = all(tuple(x.placements) == s_.placements
                         for x, s_ in zip(leaves((d_params, d_state)),
                                          leaves(shardings)))
            full = sh.gather((d_params, d_state))
            same = (torch.equal(m_s["loss"], m_m["loss"])
                    and torch.equal(m_s["grad_norm"], m_m["grad_norm"])
                    and all(torch.equal(a, b) for a, b in zip(
                        leaves(full), leaves((params, state)))))
            del full
            if not (placed and same):
                fail(f"sharded step {i + 1} at W 1: placements as named "
                     f"{placed}, bit for bit with the meshless step {same} "
                     f"(losses {float(m_s['loss'])} / {float(m_m['loss'])})")
            rec.setdefault("losses", []).append(float(m_s["loss"]))
        bad = [r for r in rec["routes"]
               if r != fa_routes(torch.bfloat16, 64, per_step)] + [
            r for r in rec["bwd_routes"]
            if r != bwd_routes(torch.bfloat16, 64, QWEN_LAYERS)]
        if bad or any(rec["plain_backward"]) or any(
                c != {**NO_KERNELS, "flash_attention": per_step}
                for c in rec["launches"]):
            fail(f"sharded steps' launches {rec['launches']}, routes "
                 f"{rec['routes']}, backward {rec['bwd_routes']}, plain "
                 f"backward {rec['plain_backward']}: expected {per_step} "
                 f"tensor-core flash_attention and {QWEN_LAYERS} backward "
                 f"calls a step and no other kernel")
        if any(c != rec["collectives"][0] for c in rec["collectives"]):
            fail(f"sharded steps' collectives differ: {rec['collectives']}")
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        # the meshless state saved, restored onto the mesh
        ck = CheckpointManager(ckdir)
        t0 = time.perf_counter()
        ck.save(SHARDED_STEPS, {"params": params, "opt": state}, block=True)
        save_s = time.perf_counter() - t0
        del d_params, d_state
        free_device_memory()
        p_sh, o_sh = shardings
        t0 = time.perf_counter()
        got, _ = ck.restore(shardings={"params": p_sh, "opt": o_sh})
        restore_s = time.perf_counter() - t0
        want = {"params": params, "opt": {"step": state.step,
                                          "inner": state.inner}}
        restored = (all(torch.equal(a.to_local(), b) for a, b in zip(
            leaves(got), leaves(want)))
            and all(tuple(x.placements) == s_.placements for x, s_ in zip(
                leaves(got["params"]), leaves(p_sh))))
        if not restored:
            fail("the meshless state restored onto the mesh differs")
        sharded_p = sum(1 for s_ in leaves(shardings)
                        if any(getattr(p, "dim", None) is not None
                               for p in s_.placements))
        del got, want, params, state
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(ckdir, ignore_errors=True)
    free_device_memory()
    warm = {k: rec[k][1:] for k in ("mesh", "meshless")}
    out = {"world": 1, "mesh": [1, 1], "arch": "qwen2-0.5b", "batch": 4,
           "seq": 2048, "steps": SHARDED_STEPS, "losses": rec["losses"],
           "bit_for_bit_with_meshless": True, "placements_as_named": True,
           "leaves_on_a_shard_placement": sharded_p,
           "no_sync_in_step": True,
           "flash_attention_per_step": per_step,
           "routes_per_step": rec["routes"][0],
           "collectives_per_step": rec["collectives"][0],
           "step_wall_s_mesh": rec["mesh"],
           "step_wall_s_meshless": rec["meshless"],
           "warm_ratio": sum(warm["mesh"]) / sum(warm["meshless"]),
           "peak_mem_gib": peak, "save_s": save_s, "restore_s": restore_s,
           "restored_bit_for_bit": True,
           "launches": {k: sum(c[k] for c in rec["launches"])
                        for k in rec["launches"][0]},
           "seconds": time.perf_counter() - t_phase}
    say("sharded_train_step", **out)
    if out["seconds"] > 60:
        fail(f"phase 26 took {out['seconds']:.1f} s, over its 60 s")
    return out


# phase 27: expert parallelism over a (1, 2) ("data", "model") mesh of two
# gloo ranks on the one card.  (a) kimi-k2's prefill at row 5k's shape; (b)
# the smoke model's sharded train step.  The MoE output and logits bound:
# 2^-5 of max(2, max|ref|), half the reference test's 2^-4 at |h| ~ 2
# (tests/test_distribution.py:207-209): the two sides run the same bf16
# products but for the expert products' batch shapes.
EP_ARCH = "kimi-k2-1t-a32b"
EP_MESH = (1, 2)
EP_BATCH, EP_SEQ = 2, 4096
EP_CALLS = 3
EP_TOL = 2 ** -5
EP_EXPERT_LEAVES = ("e_gate", "e_up", "e_down")
# 27b: the kimi-k2 smoke model in float32, B 4, S 32 (two loss chunks and
# attention blocks of 16), tests/test_torch_moe_ep.py's schedule and bounds
EP_TRAIN_B, EP_TRAIN_S, EP_TRAIN_CHUNK = 4, 32, 16
EP_TRAIN_LR = (1e-3, 10, 100)
EP_TRAIN_SEEDS = (1, 2)
EP_LOSS_RTOL, EP_GNORM_RTOL, EP_PARAM_TOL, EP_PARAM_WITHIN = \
    1e-5, 1e-4, 1e-6, 0.999
EP_PHASE_S = 90


def ep_sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def ep_prefill_config(small: bool):
    """kimi-k2 cut to one layer (``small``: its smoke config, for a
    rehearsal on the CPU)."""
    from repro_torch.configs import get_config, get_smoke_config
    cfg = (get_smoke_config if small else get_config)(EP_ARCH)
    return dataclasses.replace(cfg, n_layers=1)


def ep_train_config(groups=None):
    """27b's kimi-k2 smoke config in float32, on the expert-parallel path
    with ``groups``."""
    import torch
    from repro_torch.configs import get_smoke_config
    cfg = dataclasses.replace(
        get_smoke_config(EP_ARCH), param_dtype=torch.float32,
        activ_dtype=torch.float32, loss_chunk=EP_TRAIN_CHUNK,
        attn_block_k=EP_TRAIN_CHUNK)
    if groups is not None:
        cfg = dataclasses.replace(cfg, moe_groups=groups,
                                  moe_expert_sharded=True)
    return cfg


def ep_seed(path: str, expert: int = -1) -> int:
    import zlib
    return zlib.crc32(f"{path}/{expert}".encode())


def ep_params(cfg, dev, experts) -> dict:
    """``cfg``'s weights drawn on ``dev`` at ``init_params``' scales: a
    leaf from a seed of its own, an expert leaf expert by expert from a
    seed of each (leaf, expert), only the experts in ``experts`` (a rank's
    block, or all of them), so a rank and a whole draw agree.  The
    full-width phases draw with it on the card (22c, 23c, 29-31):
    ``init_params`` draws on the host's one generator, about 120 M values
    a second (45.6 s for 22c's 5.41 B)."""
    import torch
    from repro_torch.models.model import iter_schema
    gen = torch.Generator(device=dev)
    tree: dict = {}
    for path, spec in iter_schema(cfg):
        dt = spec.dtype or cfg.param_dtype
        name = path.split(".")[-1]
        if spec.init in ("zeros", "ones"):
            val = (torch.zeros if spec.init == "zeros" else torch.ones)(
                spec.shape, dtype=dt, device=dev)
        else:
            scale = 0.02 if spec.init == "normal" else 0.006
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 \
                else spec.shape[-1]
            scale = min(scale, fan_in ** -0.5)
            if name in EP_EXPERT_LEAVES:
                one = (spec.shape[0],) + tuple(spec.shape[2:])
                val = torch.empty((spec.shape[0], len(experts)) + one[1:],
                                  dtype=dt, device=dev)
                for i, e in enumerate(experts):
                    gen.manual_seed(ep_seed(path, e))
                    val[:, i] = (torch.randn(one, generator=gen, device=dev)
                                 * scale).to(dt)
            else:
                gen.manual_seed(ep_seed(path))
                val = (torch.randn(spec.shape, generator=gen, device=dev)
                       * scale).to(dt)
        node = tree
        *parents, leaf = path.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = val
    return tree


def ep_tokens(cfg, dev, b: int, s: int, seed: int):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                            .astype(np.int32)).to(dev)


def ep_per_group(groups, record: list):
    """``moe_block``'s function on one device as the expert-parallel path
    computes it over a mesh of ``groups``: the router, counts and balance
    loss over the whole batch; each of the gd x gm groups (batch slice i,
    sequence slice j) dispatched on its own at the reference's local
    capacity through the port's ``_dispatch_local`` / ``_expert_ffn`` /
    ``_combine_local`` with all the experts; the shared expert on all of
    ``x``.  Appends (out, aux) of each call to ``record``."""
    import torch
    from repro_torch.models import moe as tmoe
    gd, gm = groups

    def block(x, p, *, top_k, capacity_factor=1.25, **_):
        b, s, d = x.shape
        e = p.router.shape[1]
        probs, topw, tope = tmoe._route(x, p.router, top_k)
        counts = torch.sum(tope.reshape(-1)[:, None]
                           == torch.arange(e, device=x.device), dim=0,
                           dtype=torch.int32)
        f_e = counts.to(torch.float32) / float(max(b * s * top_k, 1))
        aux_loss = e * torch.sum(f_e * probs.mean((0, 1)))
        bl, sl = b // gd, s // gm
        cap = max(int(bl * sl * top_k * capacity_factor / e), 2)
        cap = -(-cap // gm) * gm
        rows, drops = [], []
        for i in range(gd):
            cols, dcols = [], []
            for j in range(gm):
                at = (slice(i * bl, (i + 1) * bl), slice(j * sl, (j + 1) * sl))
                flat_e = tope[at].reshape(-1)
                x_buf, pos = tmoe._dispatch_local(
                    x[at].reshape(bl * sl, d), flat_e, top_k, e, cap)
                y = tmoe._expert_ffn(x_buf, p.w_gate, p.w_up, p.w_down)
                cols.append(tmoe._combine_local(
                    y, pos, flat_e, topw[at].reshape(bl * sl, top_k),
                    cap).reshape(bl, sl, d))
                dcols.append((pos >= cap).reshape(bl, sl, top_k))
                del x_buf, y
            rows.append(torch.cat(cols, 1))
            drops.append(torch.cat(dcols, 1))
        out = torch.cat(rows, 0)
        if p.shared_w_gate is not None:
            out = out + tmoe._shared_ffn(x, p)
        aux = {"counts": counts, "aux_loss": aux_loss,
               "dropped": torch.cat(drops, 0)}
        record.append((out, aux))
        return out, aux
    return block


def ep_named(tree, prefix: str = "") -> dict:
    """``{"a/b": CPU tensor}`` of a tree of dicts and namedtuples."""
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(ep_named(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree.detach().cpu()}


def ep_rank_prefill(mesh, dev, rank: int, out_dir: str, small: bool) -> dict:
    """27a on one rank: its block of experts drawn, the prefill called
    1 + EP_CALLS times with the MoE layer's output captured and each
    all-to-all timed; rank j writes its outputs to ``prefill.<j>.pt``."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch import sharding as sh
    from repro_torch.models import model as tm
    from repro_torch.serve import engine

    gm = EP_MESH[1]
    cfg = dataclasses.replace(ep_prefill_config(small), moe_groups=EP_MESH,
                              moe_expert_sharded=True,
                              act_batch_axes=("data",))
    j = mesh.get_local_rank("model")
    n = cfg.moe.n_experts // gm
    params = ep_params(cfg, dev, range(j * n, (j + 1) * n))
    b, s = (2, 64) if small else (EP_BATCH, EP_SEQ)
    toks = ep_tokens(cfg, dev, b, s, 27)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    record, a2a_s = [], [0.0]
    real_block, real_a2a = tm.moe_block, sh._tiled_all_to_all

    def captured(*a, **kw):
        out, aux = real_block(*a, **kw)
        record[:] = [(out, aux)]
        return out, aux

    def timed_a2a(*a, **kw):
        ep_sync(dev)
        t0 = time.perf_counter()
        out = real_a2a(*a, **kw)
        ep_sync(dev)
        a2a_s[0] += time.perf_counter() - t0
        return out
    tm.moe_block, sh._tiled_all_to_all = captured, timed_a2a
    calls = []
    try:
        with torch.no_grad():
            for _ in range(1 + EP_CALLS):
                fa_kernel.LAUNCHES = 0
                for r in fa_kernel.ROUTE_LAUNCHES:
                    fa_kernel.ROUTE_LAUNCHES[r] = 0
                before, a2a_s[0] = dict(sh.COLLECTIVES), 0.0
                ep_sync(dev)
                t0 = time.perf_counter()
                logits, cache = engine.prefill(params, cfg, tokens=toks,
                                               mesh=mesh)
                ep_sync(dev)
                calls.append({
                    "wall_s": time.perf_counter() - t0,
                    "a2a_s": a2a_s[0],
                    "flash_attention": fa_kernel.LAUNCHES,
                    "routes": dict(fa_kernel.ROUTE_LAUNCHES),
                    "collectives": {k: sh.COLLECTIVES[k] - before[k]
                                    for k in before}})
                del cache
    finally:
        tm.moe_block, sh._tiled_all_to_all = real_block, real_a2a
    out, aux = record[0]
    torch.save({"moe_out": out.cpu(), "logits": logits.cpu(),
                "counts": aux["counts"].cpu(),
                "dropped": aux["dropped"].cpu()},
               f"{out_dir}/prefill.{rank}.pt")
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    return {"calls": calls, "peak_gib": peak, "experts": [j * n, (j + 1) * n]}


def ep_rank_train(mesh, dev, rank: int, out_dir: str) -> dict:
    """27b on one rank: 2 sharded steps with AdamW and 2 with Adafactor;
    rank 0 writes the gathered state after each step."""
    import torch
    from repro_torch.launch import sharding as sh
    from repro_torch.optim import cosine_schedule, get_optimizer
    from repro_torch.pytree import leaves, tree_map
    from repro_torch.train import sharded

    cfg = ep_train_config(EP_MESH)
    out = {}
    for opt_name in ("adamw", "adafactor"):
        opt = get_optimizer(opt_name)
        params = ep_params(cfg, dev, range(cfg.moe.n_experts))
        state = opt.init(params)
        shardings = sharded.state_shardings(mesh, cfg, state)
        p, st = sh.distribute((params, state), shardings)
        step = sharded.make_sharded_train_step(
            cfg, opt, cosine_schedule(*EP_TRAIN_LR), mesh)
        rec = {"metrics": [], "collectives": [], "placements_ok": []}
        saved = {}
        for i, seed in enumerate(EP_TRAIN_SEEDS, 1):
            bt = {k: ep_tokens(cfg, dev, EP_TRAIN_B, EP_TRAIN_S, seed + 10 * c)
                  for c, k in enumerate(("tokens", "labels"))}
            db = sh.distribute(bt, sh.named(mesh, sh.batch_specs(mesh, cfg,
                                                                 bt)))
            before = dict(sh.COLLECTIVES)
            p, st, m = step(p, st, db)
            rec["collectives"].append({k: sh.COLLECTIVES[k] - before[k]
                                       for k in before})
            rec["placements_ok"].append(all(leaves(tree_map(
                lambda x, s_: tuple(x.placements) == s_.placements,
                (p, st), shardings))))
            rec["metrics"].append({k: v.tolist() for k, v in m.items()})
            full_p, full_s = sh.gather((p, st))
            saved.update({f"p{i}/{k}": v
                          for k, v in ep_named(full_p).items()})
            saved.update({f"s{i}/{k}": v
                          for k, v in ep_named(full_s).items()})
        if rank == 0:
            torch.save(saved, f"{out_dir}/train_{opt_name}.pt")
        out[opt_name] = rec
    return out


def ep_rank(rank: int, store: str, out_dir: str, small: bool = False
            ) -> None:
    """One of phase 27's two ranks (a spawned process; ``small``: the
    smoke config on the CPU, a rehearsal)."""
    import datetime
    import os
    import traceback
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    dev = torch.device("cpu") if small else torch.device("cuda", 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    try:
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh(EP_MESH, ("data", "model"), device=dev.type)
        t0 = time.perf_counter()
        res = {"prefill": ep_rank_prefill(mesh, dev, rank, out_dir, small)}
        res["prefill_s"] = time.perf_counter() - t0
        if dev.type == "cuda":
            free_device_memory()
        t0 = time.perf_counter()
        res["train"] = ep_rank_train(mesh, dev, rank, out_dir)
        res["train_s"] = time.perf_counter() - t0
        with open(f"{out_dir}/rank.{rank}.json", "w") as f:
            json.dump(res, f, sort_keys=True)
    except BaseException:
        with open(f"{out_dir}/rank.{rank}.error", "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)
    dist.destroy_process_group()


def ep_within(got, ref) -> tuple:
    """(max |got - ref|, its bound EP_TOL * max(2, max|ref|))."""
    got, ref = got.float(), ref.float()
    return (float((got - ref).abs().max()),
            EP_TOL * max(2.0, float(ref.abs().max())))


def ep_train_reference(dev, opt_name: str, got: dict, ranks: list) -> dict:
    """27b's one-device steps with each MoE layer per group against rank
    0's saved state and every rank's metrics, at the train-step bounds."""
    import torch
    from repro_torch.models import model as tm
    from repro_torch.optim import cosine_schedule, get_optimizer
    from repro_torch.train.steps import make_train_step

    cfg = ep_train_config()
    opt = get_optimizer(opt_name)
    step = make_train_step(cfg, opt, cosine_schedule(*EP_TRAIN_LR))
    params = ep_params(cfg, dev, range(cfg.moe.n_experts))
    state = opt.init(params)
    record, real = [], tm.moe_block
    tm.moe_block = ep_per_group(EP_MESH, record)
    worst, lr_sum = {"loss": 0.0, "grad_norm": 0.0, "state": 0.0}, 0.0
    try:
        for i, seed in enumerate(EP_TRAIN_SEEDS, 1):
            bt = {k: ep_tokens(cfg, dev, EP_TRAIN_B, EP_TRAIN_S, seed + 10 * c)
                  for c, k in enumerate(("tokens", "labels"))}
            params, state, m = step(params, state, bt)
            gm_ = ranks[0]["train"][opt_name]["metrics"][i - 1]
            for k in ("loss", "grad_norm"):
                worst[k] = max(worst[k], abs(gm_[k] - float(m[k]))
                               / abs(float(m[k])))
            lr_sum += float(m["lr"])
            if gm_["expert_counts"] != m["expert_counts"].tolist():
                fail(f"27b {opt_name} step {i}: expert counts "
                     f"{gm_['expert_counts']} vs {m['expert_counts'].tolist()}")
            want = {**{f"p{i}/{k}": v for k, v in ep_named(params).items()},
                    **{f"s{i}/{k}": v for k, v in ep_named(state).items()}}
            if sorted(want) != sorted(k for k in got if k[:2] in
                                      (f"p{i}", f"s{i}")):
                fail(f"27b {opt_name}: the saved state's leaves differ")
            diff = torch.cat([(got[k].float() - want[k].float()).abs()
                              .ravel() for k in want])
            within = float((diff <= EP_PARAM_TOL).float().mean())
            worst["state"] = max(worst["state"], float(diff.max()))
            if float(diff.max()) > 2 * lr_sum or within < EP_PARAM_WITHIN:
                fail(f"27b {opt_name} step {i}: state off by "
                     f"{float(diff.max())} (bound {2 * lr_sum}), "
                     f"{within} within {EP_PARAM_TOL}")
    finally:
        tm.moe_block = real
    if worst["loss"] > EP_LOSS_RTOL or worst["grad_norm"] > EP_GNORM_RTOL:
        fail(f"27b {opt_name}: loss / grad norm relative errors {worst}")
    dropped = sum(int(aux["dropped"].sum()) for _, aux in record)
    per = [r["train"][opt_name] for r in ranks]
    if not (all(r["metrics"] == per[0]["metrics"] for r in per)
            and all(all(r["placements_ok"]) for r in per)
            and all(c == per[0]["collectives"][0]
                    for r in per for c in r["collectives"])):
        fail(f"27b {opt_name}: ranks disagree, a leaf is off its placements "
             f"or the collectives differ across steps: {per}")
    return {"worst": worst, "dropped_pairs": dropped,
            "losses": [mm["loss"] for mm in per[0]["metrics"]],
            "collectives_per_step": per[0]["collectives"][0]}


def expert_parallel(dev, smi_line: str, small: bool = False) -> dict:
    """Phase 27 (see the module doc).  ``small``: a rehearsal on the CPU
    with the smoke config."""
    import multiprocessing
    import shutil
    import tempfile
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models import model as tm
    from repro_torch.serve import engine

    t_phase = time.perf_counter()
    if dev.type == "cuda":
        free_device_memory()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ep_")
    out_dir = obs_dir("expert_parallel")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=ep_rank,
                         args=(r, f"{tmp}/store", str(out_dir), small))
             for r in range(2)]
    try:
        for pr in procs:
            pr.start()
        for pr in procs:
            pr.join(timeout=EP_PHASE_S + 60)
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()
        errors = sorted(out_dir.glob("rank.*.error"))
        if errors or any(pr.exitcode != 0 for pr in procs):
            fail("phase 27's ranks failed (exit codes "
                 f"{[pr.exitcode for pr in procs]}): "
                 + " | ".join(e.read_text()[-3000:] for e in errors))
        ranks = [json.loads((out_dir / f"rank.{r}.json").read_text())
                 for r in range(2)]
        got = [torch.load(out_dir / f"prefill.{r}.pt") for r in range(2)]
        t_ranks = time.perf_counter() - t_phase

        # ---- 27a: the same draw whole, the prefill on one device per group
        cfg = ep_prefill_config(small)
        params = ep_params(cfg, dev, range(cfg.moe.n_experts))
        b, s = (2, 64) if small else (EP_BATCH, EP_SEQ)
        toks = ep_tokens(cfg, dev, b, s, 27)
        record, real = [], tm.moe_block
        tm.moe_block = ep_per_group(EP_MESH, record)
        try:
            with torch.no_grad():
                fa_kernel.LAUNCHES = 0
                ep_sync(dev)
                t0 = time.perf_counter()
                logits, cache = engine.prefill(params, cfg, tokens=toks)
                ep_sync(dev)
                one_wall = time.perf_counter() - t0
                one_launches = fa_kernel.LAUNCHES
        finally:
            tm.moe_block = real
        ref_out, ref_aux = record[-1]
        ref_out, logits = ref_out.cpu(), logits.cpu()
        counts, dropped = ref_aux["counts"].cpu(), ref_aux["dropped"].cpu()
        del params, cache, record, ref_aux
        if dev.type == "cuda":
            free_device_memory()
        sl = s // EP_MESH[1]
        errs = {}
        for r, g in enumerate(got):
            if not torch.equal(g["counts"], counts):
                fail(f"27a rank {r}: counts {g['counts'].tolist()} vs "
                     f"{counts.tolist()}")
            if not torch.equal(g["dropped"], dropped[:, r * sl:(r + 1) * sl]):
                fail(f"27a rank {r}: its group's dropped pairs differ "
                     f"({int(g['dropped'].sum())} vs "
                     f"{int(dropped[:, r * sl:(r + 1) * sl].sum())})")
            for name, ref in (("moe_out", ref_out), ("logits", logits)):
                err, bound = ep_within(g[name], ref)
                errs[f"{name}_{r}"] = [err, bound]
                if not err <= bound:
                    fail(f"27a rank {r}: {name} off by {err} > {bound}")
        n_e, k = cfg.moe.n_experts, cfg.moe.top_k
        cap = max(int(b * sl * k * cfg.moe.capacity_factor / n_e), 2)
        cap = -(-cap // EP_MESH[1]) * EP_MESH[1]
        a2a_bytes = n_e * cap * cfg.d_model * cfg.activ_dtype.itemsize
        for r, res in enumerate(ranks):
            for c in res["prefill"]["calls"]:
                co = c["collectives"]
                if (co["all_to_all"], co["all_to_all_bytes"]) \
                        != (2 * cfg.n_layers, 2 * cfg.n_layers * a2a_bytes):
                    fail(f"27a rank {r}: all-to-alls {co}, expected "
                         f"{2 * cfg.n_layers} of {a2a_bytes} bytes")
                if dev.type == "cuda" and (
                        c["flash_attention"] != cfg.n_layers
                        or c["routes"]["tensor_core"] != cfg.n_layers):
                    fail(f"27a rank {r}: flash_attention {c}, expected "
                         f"{cfg.n_layers} on the tensor cores a call")
        timed = [c["wall_s"] for c in ranks[0]["prefill"]["calls"][1:]]
        pre = {
            "arch": EP_ARCH, "n_layers": cfg.n_layers, "batch": b, "seq": s,
            "mesh": list(EP_MESH), "smi": smi_line,
            "capacity_factor": cfg.moe.capacity_factor, "local_capacity": cap,
            "wall_s": {r: [c["wall_s"] for c in res["prefill"]["calls"]]
                       for r, res in enumerate(ranks)},
            "tokens_per_s": [b * s / w for w in timed],
            "first_call_s": ranks[0]["prefill"]["calls"][0]["wall_s"],
            "peak_gib": [res["prefill"]["peak_gib"] for res in ranks],
            "all_to_all_per_call": ranks[0]["prefill"]["calls"][1][
                "collectives"],
            "all_to_all_s": {r: [c["a2a_s"] for c in res["prefill"]["calls"]]
                             for r, res in enumerate(ranks)},
            "flash_attention_per_rank_call": ranks[0]["prefill"]["calls"][1][
                "flash_attention"],
            "routes_per_rank_call": ranks[0]["prefill"]["calls"][1]["routes"],
            "one_device_per_group_wall_s": one_wall,
            "one_device_flash_attention": one_launches,
            "counts_exact": True, "dropped_exact": True,
            "dropped_pairs": int(dropped.sum()), "errors": errs,
            "rank_prefill_s": [res["prefill_s"] for res in ranks]}
        say("expert_parallel_prefill", **pre)

        # ---- 27b: the sharded train steps against one device per group
        train = {}
        for opt_name in ("adamw", "adafactor"):
            saved = torch.load(out_dir / f"train_{opt_name}.pt")
            train[opt_name] = ep_train_reference(dev, opt_name, saved, ranks)
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(out_dir, ignore_errors=True)
    if dev.type == "cuda":
        free_device_memory()
    out = {"prefill": pre, "train": train,
           "flash_attention_launches": sum(
               c["flash_attention"] for res in ranks
               for c in res["prefill"]["calls"]),
           "ranks_s": t_ranks, "rank_train_s": [res["train_s"]
                                                 for res in ranks],
           "seconds": time.perf_counter() - t_phase, "smi": smi_line}
    say("expert_parallel", **{k: v for k, v in out.items() if k != "prefill"})
    if out["seconds"] > EP_PHASE_S:
        fail(f"phase 27 took {out['seconds']:.1f} s, over its "
             f"{EP_PHASE_S} s")
    return out


# ---------------------------------------------------------------- phase 28
# 28: the dry run (launch.dryrun) held to the card.  (a) qwen2-0.5b's
# single-device train step at phase 24b's shape (B 4, S 2048, bf16
# activations, remat "full", AdamW), counted on meta tensors, then run on
# the card; (b) one production cell in a process of its own (the fake
# group of 512 ranks cannot share this process's groups).
DRY_BATCH, DRY_SEQ = 4, 2048
DRY_CELL = ("kimi-k2-1t-a32b", "train_4k")
DRY_PHASE_S = 90


def dry_run_card_step(dev, zero_counts, read_counts, read_routes) -> dict:
    """Phase 28a: ``dryrun.count_step`` of the step on meta tensors, then
    the same step on the card: a warm-up, a timed step, and a step under
    ``FlopCounterMode`` with each flash_attention launch's and backward
    call's shape recorded.  The ctypes kernels are invisible to that mode,
    so the card's count plus the meta routes' charge for each launch and
    backward call must equal the dry run's FLOPs exactly; the launches and
    backward calls must equal the dry run's calls, shape by shape, and no
    plain backward run; the dry run's argument bytes must equal the storage of the
    card's params, optimizer state and batch (and the allocator's growth
    those bytes rounded up to its 512-byte blocks)."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeSpec, input_specs
    from repro_torch.models.model import abstract_params, init_params
    from repro_torch.optim import cosine_schedule, get_optimizer
    from repro_torch.pytree import leaves
    from repro_torch.train.steps import make_train_step

    cfg = get_config("qwen2-0.5b")
    opt = get_optimizer("adamw")
    step = make_train_step(cfg, opt, cosine_schedule(*SHARDED_LR))
    t0 = time.perf_counter()
    meta = abstract_params(cfg)
    rec = dryrun.count_step(step, (meta, opt.init(meta), input_specs(
        cfg, ShapeSpec("train_card", DRY_SEQ, DRY_BATCH, "train"))))
    trace_s = time.perf_counter() - t0
    del meta

    free_device_memory()
    base = torch.cuda.memory_allocated(dev)
    params = init_params(cfg, 0, dev)
    state = opt.init(params)
    rng = np.random.default_rng(28)
    toks = rng.integers(0, cfg.vocab_size, (DRY_BATCH, DRY_SEQ + 1)) \
        .astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
             "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)}
    torch.cuda.synchronize(dev)
    held = leaves((params, state, batch))
    alloc = torch.cuda.memory_allocated(dev) - base
    storage = sum(t.untyped_storage().nbytes() for t in held)
    del held
    args_bytes = rec["memory"]["argument_bytes"]
    # the allocator's blocks round each tensor up (to 512 bytes, a large
    # one to the rest of its segment when less than 1 MiB would be left)
    if not (args_bytes == storage <= alloc):
        fail(f"28a: the dry run's argument bytes {args_bytes} against the "
             f"storage of the card's params + optimizer state + batch "
             f"{storage} (the allocator's growth {alloc})")

    params, state, _ = step(params, state, batch)        # warm-up
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params, state, m = step(params, state, batch)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base

    seen: dict = {}
    seen_bwd: dict = {}
    real, real_bwd = fa_ops.flash_attention_cuda, fa_ops.flash_attention_bwd_cuda

    def recorded(q, k, v, **kw):
        key = fa_kernel.meta_key(q, k, q_per_kv=kw["q_per_kv"],
                                 causal=kw["causal"], window=kw["window"],
                                 saves=kw.get("return_lse", False))
        seen[key] = seen.get(key, 0) + 1
        return real(q, k, v, **kw)

    def recorded_bwd(q, k, v, o, do, lse, **kw):
        key = fa_kernel.meta_key(q, k, q_per_kv=kw["q_per_kv"],
                                 causal=kw["causal"], window=kw["window"],
                                 saves=True)
        seen_bwd[key] = seen_bwd.get(key, 0) + 1
        return real_bwd(q, k, v, o, do, lse, **kw)

    def by_shape(calls: dict) -> dict:
        return {key[:7] + (str(key[7]).split(".")[-1], key[8]): n
                for key, n in calls.items()}

    def meta_by_shape(kern: dict) -> dict:
        return {(c["bh"], c["sq"], c["sk"], c["d"], c["q_per_kv"],
                 c["causal"], c["window"], c["dtype"], c["saves"]):
                c["calls"] for c in kern["calls"]}

    zero_counts()
    r0 = read_routes()
    fa_ops.flash_attention_cuda = recorded
    fa_ops.flash_attention_bwd_cuda = recorded_bwd
    try:
        with FlopCounterMode(display=False) as fc, \
                plain_backward_calls() as plain_seen:
            params, state, m = step(params, state, batch)
        torch.cuda.synchronize(dev)
    finally:
        fa_ops.flash_attention_cuda = real
        fa_ops.flash_attention_bwd_cuda = real_bwd
    launches = read_counts()
    routes = {k: v - r0[k] for k, v in read_routes().items()}
    b_routes = read_bwd_routes()
    card_flops = fc.get_total_flops()
    charged = sum(n * fa_kernel.charge(key)[0] for key, n in seen.items())
    charged_bwd = sum(n * fa_kernel.bwd_charge(key)[0]
                      for key, n in seen_bwd.items())
    kern = rec["kernels"]["flash_attention"]
    kern_bwd = rec["kernels"]["flash_attention_bwd"]
    per_step = 2 * QWEN_LAYERS
    if card_flops + charged + charged_bwd != rec["executed"]["flops"]:
        fail(f"28a: the card's FLOPs {card_flops} + the flash_attention "
             f"charges {charged} + the backward's {charged_bwd} != the dry "
             f"run's {rec['executed']['flops']}")
    if not (launches == {**NO_KERNELS, "flash_attention": per_step}
            and kern["launches"] == per_step
            and by_shape(seen) == meta_by_shape(kern)
            and routes == fa_routes(torch.bfloat16, 64, per_step)
            and kern_bwd["launches"] == QWEN_LAYERS
            and by_shape(seen_bwd) == meta_by_shape(kern_bwd)
            and b_routes == bwd_routes(torch.bfloat16, 64, QWEN_LAYERS)
            and plain_seen["calls"] == 0):
        fail(f"28a: the card's launches {launches} (routes {routes}, "
             f"shapes {by_shape(seen)}; backward {b_routes}, "
             f"{by_shape(seen_bwd)}; plain backward {plain_seen['calls']}) "
             f"against the dry run's {kern['launches']} "
             f"({meta_by_shape(kern)}) and {kern_bwd['launches']} "
             f"({meta_by_shape(kern_bwd)}); expected {per_step} and "
             f"{QWEN_LAYERS} on the tensor cores")
    if not math.isfinite(float(m["loss"])):
        fail(f"28a: the card step's loss is {float(m['loss'])}")
    ex = rec["executed"]
    roof = max(ex["flops"] / TENSOR_BF16_OPS_PER_S,
               ex["hbm_bytes"] / HBM_BYTES_PER_S)
    del params, state, batch, m
    free_device_memory()
    return {"arch": "qwen2-0.5b", "batch": DRY_BATCH, "seq": DRY_SEQ,
            "trace_s": trace_s, "flops": ex["flops"],
            "card_flops": card_flops, "flash_attention_charge": charged,
            "flash_attention_bwd_charge": charged_bwd,
            "flops_equal": True, "hbm_bytes": ex["hbm_bytes"],
            "launches": launches["flash_attention"],
            "dry_run_launches": kern["launches"],
            "backward_calls": sum(b_routes.values()),
            "dry_run_backward_calls": kern_bwd["launches"],
            "argument_bytes": args_bytes, "card_storage_bytes": storage,
            "card_allocated_bytes": alloc,
            "predicted_peak_bytes": rec["memory"]["peak_bytes"],
            "card_peak_bytes": peak, "warm_step_s": wall,
            "roofline_s": roof,
            "roofline_bound_by": ("operations" if ex["flops"]
                                  / TENSOR_BF16_OPS_PER_S
                                  >= ex["hbm_bytes"] / HBM_BYTES_PER_S
                                  else "bytes"),
            "roofline_share": roof / wall}


def dry_run_cell_rank(out: str) -> None:
    """28b's process: rank 0 of a fake group of 512 ranks (this module's
    path to ``src`` set up first), ``dryrun.run_cell`` on DRY_CELL at
    16 x 16, the record written to ``out``/record.json (a traceback to
    ``out``/error.txt)."""
    import traceback
    try:
        sys.path.insert(0, str(SRC))
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.launch import dryrun
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=dryrun.FAKE_WORLD)
        try:
            rec = dryrun.run_cell(*DRY_CELL, False, Path(out))
        finally:
            dist.destroy_process_group()
        (Path(out) / "record.json").write_text(json.dumps(rec))
    except BaseException:
        (Path(out) / "error.txt").write_text(traceback.format_exc())
        raise


def dry_run(dev, zero_counts, read_counts, read_routes, smi_line) -> dict:
    """Phase 28 (see the module doc): 28b's process starts first and runs
    beside 28a."""
    import multiprocessing
    import shutil
    import torch
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    out_dir = obs_dir("dry_run")
    proc = multiprocessing.get_context("spawn").Process(
        target=dry_run_cell_rank, args=(str(out_dir),))
    try:
        proc.start()
        card = dry_run_card_step(dev, zero_counts, read_counts, read_routes)
        say("dry_run_card_step", smi=smi_line, **card)
        proc.join(timeout=DRY_PHASE_S)
        if proc.is_alive():
            proc.kill()
            proc.join()
        err = out_dir / "error.txt"
        if proc.exitcode != 0 or err.exists():
            fail(f"28b: the cell's process failed (exit {proc.exitcode}): "
                 + (err.read_text()[-3000:] if err.exists() else ""))
        rec = json.loads((out_dir / "record.json").read_text())
    finally:
        if proc.is_alive():
            proc.kill()
        shutil.rmtree(out_dir, ignore_errors=True)
    n_layers = get_config(DRY_CELL[0]).n_layers
    ex, mem = rec.get("executed", {}), rec.get("memory", {})
    fa = rec.get("kernels", {}).get("flash_attention", {})
    # expert parallelism: two all-to-alls a MoE layer's forward, run three
    # times a step (forward, remat's recompute, backward)
    if not (rec["status"] == "ok"
            and ex["collective_count"]["all-to-all"] == 6 * n_layers
            and fa["launches"] == 2 * n_layers):
        fail(f"28b: {DRY_CELL} x 16x16 ended {rec['status']} "
             f"({rec.get('reason')}), all-to-alls "
             f"{ex.get('collective_count')}, flash_attention calls "
             f"{fa.get('launches')}: expected 'ok' on the expert-parallel "
             f"path, {6 * n_layers} all-to-alls and {2 * n_layers} calls")
    cell = {"arch": DRY_CELL[0], "shape": DRY_CELL[1], "mesh": rec["mesh"],
            "status": rec["status"], "devices": rec["devices"],
            "flops": ex["flops"], "hbm_bytes": ex["hbm_bytes"],
            "collective_count": ex["collective_count"],
            "collective_wire_bytes": ex["collective_wire_bytes"],
            "collective_total_bytes": ex["collective_total_bytes"],
            "argument_bytes": mem["argument_bytes"],
            "peak_bytes": mem["peak_bytes"],
            "flash_attention_calls": fa["launches"],
            "trace_s": rec["trace_s"]}
    say("dry_run_cell", **cell)
    out = {"card": card, "cell": cell,
           "seconds": time.perf_counter() - t_phase}
    say("dry_run", seconds=out["seconds"], smi=smi_line)
    if out["seconds"] > DRY_PHASE_S:
        fail(f"phase 28 took {out['seconds']:.1f} s, over its "
             f"{DRY_PHASE_S} s")
    return out


# ---------------------------------------------------------------- phase 29
# 29: tensor parallelism over "model": two gloo ranks on the one card, a
# (1, 2) ("data", "model") mesh, qwen2-0.5b at its widths cut to TP_LAYERS
TP_ARCH = "qwen2-0.5b"
TP_MESH = (1, 2)
TP_LAYERS = 4
TP_BATCH, TP_SEQ = 4, 2048
TP_STEPS = 2
TP_LR = (3e-4, 1, 12)
TP_LOCAL_HEADS = (7, 1)           # 14 / 2 query heads, 2 / 2 KV heads
TP_TIME_SHAPE = (4, 7, 1, 2048, 64)
TP_GRAD_CASE = ("qwen2-0.5b TP rank", 4, 7, 1, 2048, 2048, 64, "bfloat16",
                True, None)
TP_PHASE_S = 125
# 29a's other attention layouts at 2 "model" ranks, each a float32 step of
# TP_VARIANT_LAYERS layers at qwen2-0.5b's other widths: name -> (config
# changes, the smoke config's changes, the expected (heads, kv) layout).
# One KV head stays whole and each rank slices it; 7 heads of d 128 are
# cut through a head (q gathered over "model")
TP_VARIANTS = {
    "kv-sliced": ({"n_kv_heads": 1}, {"n_kv_heads": 1}, ["whole", "sliced"]),
    "heads-cut": ({"n_heads": 7, "head_dim": 128, "n_kv_heads": 1},
                  {"n_heads": 3, "head_dim": 16, "n_kv_heads": 1},
                  ["cut", None])}
TP_VARIANT_LAYERS = 1
# 29's FSDP layout: a (2, 1) ("data", "model") mesh, each rank its half of
# every leaf the rules put "data" on (an "embed" dim), gathered at use and
# its gradient reduce-scattered; 29a-fsdp at TP_LAYERS in float32, 29c at
# qwen2-0.5b's full depth in bf16 (B 4: 2 sequences a rank)
FSDP_MESH = (2, 1)
FSDP_STEPS = 2


def tp_phase_config(small: bool, dtype, changes=None,
                    layers: int | None = TP_LAYERS):
    """qwen2-0.5b cut to ``layers`` layers (None: all of them; ``small``:
    its smoke config, a rehearsal on the CPU) with ``dtype`` activations
    and ``changes``."""
    from repro_torch.configs import get_config, get_smoke_config
    cfg = (get_smoke_config if small else get_config)(TP_ARCH)
    return dataclasses.replace(cfg, n_layers=min(layers or cfg.n_layers,
                                                 cfg.n_layers),
                               activ_dtype=dtype, **(changes or {}))


@contextlib.contextmanager
def sync_checked_but_collectives(on: bool):
    """The block under ``set_sync_debug_mode("error")`` (``on``), but for
    the calls of ``torch.distributed.all_reduce`` / ``all_gather`` /
    ``reduce_scatter``, which run with the check off: gloo copies a CUDA
    tensor to the host and back and synchronises its stream there, which
    the mode, a setting of the whole process, would refuse in gloo's own
    thread."""
    import torch
    import torch.distributed as dist
    if not on:
        yield
        return
    real = {name: getattr(dist, name) for name in ("all_reduce",
                                                   "all_gather",
                                                   "reduce_scatter")}

    def unchecked(fn):
        def call(*a, **kw):
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("error")
        return call
    for name, fn in real.items():
        setattr(dist, name, unchecked(fn))
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)
        for name, fn in real.items():
            setattr(dist, name, fn)


def tp_rank_f32(mesh, dev, rank: int, params, batch, cfg) -> dict:
    """29a on one rank: the float32 sharded gradient and step of ``cfg``;
    rank 0 holds them against the single-device ones."""
    import torch
    from repro_torch.launch import sharding as sh
    from repro_torch.optim import cosine_schedule, get_optimizer
    from repro_torch.optim.optimizers import global_norm
    from repro_torch.pytree import flatten
    from repro_torch.train import sharded
    from repro_torch.train.steps import loss_and_grads, make_train_step

    opt, sched = get_optimizer("adamw"), cosine_schedule(*TP_LR)
    state = opt.init(params)
    shardings = sharded.state_shardings(mesh, cfg, state)
    p, st = sh.distribute((params, state), shardings)
    local, _ = sharded.leaf_roles(cfg, mesh)
    db = sh.distribute(batch, sh.named(mesh, sh.batch_specs(mesh, cfg,
                                                            batch)))
    t0 = time.perf_counter()
    loss, _, grads = sharded.sharded_grads(cfg, mesh, p, db)
    whole = sharded.gather_local(grads, p, shardings[0])
    _, _, m = sharded.make_sharded_train_step(cfg, opt, sched, mesh)(p, st,
                                                                      db)
    ep_sync(dev)
    out = {"seconds": time.perf_counter() - t0, "loss": float(loss),
           "step_loss": float(m["loss"]),
           "step_grad_norm": float(m["grad_norm"])}
    if rank != 0:
        return out
    one_loss, _, one_grads = loss_and_grads(params, cfg, batch)
    _, _, one_m = make_train_step(cfg, opt, sched)(params, opt.init(params),
                                                   batch)
    errs, faults = {}, []
    for key, g, c in (("loss", loss, one_loss),
                      ("step_loss", m["loss"], one_m["loss"]),
                      ("grad_norm", global_norm(whole), global_norm(one_grads)),
                      ("step_grad_norm", m["grad_norm"], one_m["grad_norm"])):
        g, c = float(g), float(c)
        errs[key] = abs(g - c)
        if not (math.isfinite(g) and errs[key]
                <= FULL_WIDTH_F32_TOL * (1 + abs(c))):
            faults.append(f"{key}: {g} vs {c}")
    g_leaves, skeleton = flatten(whole)
    names = flatten(tree_paths(skeleton))[0]
    share = {}
    for key, g, c in zip(names, g_leaves, flatten(one_grads)[0]):
        err = float((g.float() - c.float()).abs().max())
        allowed = TRAIN_LEAF_TOL_OF_MAX * float(c.abs().max())
        share[key] = err / allowed if allowed > 0 else float("inf")
        if not (bool(torch.isfinite(g).all()) and share[key] <= 1.0):
            faults.append(f"{key}: max abs err {err} over {allowed}")
    out.update(errors=errs, share_of_tolerance=share, faults=faults,
               local=sorted(k for k, v in zip(names, flatten(local)[0]) if v),
               data_cut=sorted(k for k, x in zip(names, flatten(p)[0])
                               if "data" in sh.cut_axes(x)))
    return out


def tp_rank_bf16(mesh, dev, rank: int, params, pipeline, cfg,
                 steps: int = TP_STEPS) -> dict:
    """29b / 29c on one rank: ``steps`` bf16 sharded steps of ``cfg``,
    each's launches, backward calls, attention head counts, collectives
    (and those over "data" by kind: count and bytes) and wall; the peak
    memory of the steps."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch import sharding as sh
    from repro_torch.models import attention as attn
    from repro_torch.optim import cosine_schedule, get_optimizer
    from repro_torch.train import sharded

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    opt = get_optimizer("adamw")
    state = opt.init(params)
    shardings = sharded.state_shardings(mesh, cfg, state)
    p, st = sh.distribute((params, state), shardings)
    step = sharded.make_sharded_train_step(cfg, opt, cosine_schedule(*TP_LR),
                                           mesh)
    heads, real = set(), attn.flash_train

    def seen(q, k, v, **kw):
        heads.add((q.shape[1], k.shape[1]))
        return real(q, k, v, **kw)
    rec = []
    attn.flash_train = seen
    try:
        for i in range(steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipeline.batch(100 + i).items()}
            db = sh.distribute(batch, sh.named(mesh, sh.batch_specs(
                mesh, cfg, batch)))
            fa_kernel.LAUNCHES = fa_kernel.BWD_LAUNCHES = 0
            for counts in (fa_kernel.ROUTE_LAUNCHES,
                           fa_kernel.BWD_ROUTE_LAUNCHES):
                for r in counts:
                    counts[r] = 0
            heads.clear()
            before = dict(sh.COLLECTIVES)
            ep_sync(dev)
            t0 = time.perf_counter()
            with plain_backward_calls() as plain, sh.recording() as log, \
                    sync_checked_but_collectives(dev.type == "cuda"):
                p, st, m = step(p, st, db)
            ep_sync(dev)
            over_data = {}
            for kind, nbytes, _, axis in log:
                if axis == "data":
                    got = over_data.setdefault(kind, [0, 0])
                    got[0] += 1
                    got[1] += nbytes
            rec.append({
                "over_data": over_data,
                "wall_s": time.perf_counter() - t0,
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "flash_attention": fa_kernel.LAUNCHES,
                "routes": dict(fa_kernel.ROUTE_LAUNCHES),
                "bwd_routes": dict(fa_kernel.BWD_ROUTE_LAUNCHES),
                "plain_backward": plain["calls"],
                "heads": sorted(heads),
                "collectives": {k: sh.COLLECTIVES[k] - before[k]
                                for k in before}})
    finally:
        attn.flash_train = real
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    return {"steps": rec, "peak_gib": peak}


def fsdp_expected(cfg, data: int) -> dict:
    """29c's all-gathers and reduce-scatters over "data" a rank and step,
    worked out from the dense config ``cfg`` at ``data`` "data" ranks:
    ``{kind: [count, bytes]}``.  Each leaf the rules put "data" on (its
    "embed" dim) is gathered whole at each use in each forward of its
    block (a layer's leaves once a layer, twice under remat: the forward
    and the recompute; the embedding once, and once more as the tied
    head), each gather returning the use padded to ``data`` equal chunks,
    and its gradient comes back in one reduce-scatter a use, returning a
    chunk.  The all-reduces over "data": one of each other leaf's whole
    gradient, the loss's packed terms (two float64) and the clip's sum of
    the cut leaves' squares (one float32)."""
    import math
    from repro_torch.models.model import iter_schema
    if cfg.family != "attn" or cfg.remat == "none":
        raise ValueError(f"{cfg.name}: 29c counts a dense, rematerialized "
                         f"step")
    gathers = scatters = gathered = scattered = 0
    reduces, reduced = 2, 2 * 8 + 4
    for path, spec in iter_schema(cfg):
        if "embed" not in spec.logical_axes:
            reduces += 1
            reduced += math.prod(spec.shape) * cfg.param_dtype.itemsize
            continue
        shape, axes = list(spec.shape), spec.logical_axes
        if path.startswith("blocks."):
            shape, axes = shape[1:], axes[1:]
            uses, runs = cfg.n_layers, 2
        else:
            uses = 2 if path == "embed" and cfg.tie_embeddings else 1
            runs = 1
        d = axes.index("embed")
        shape[d] = -(-shape[d] // data) * data
        nbytes = math.prod(shape) * cfg.param_dtype.itemsize
        gathers += uses * runs
        gathered += uses * runs * nbytes
        scatters += uses
        scattered += uses * nbytes // data
    return {"all_gather": [gathers, gathered],
            "reduce_scatter": [scatters, scattered],
            "all_reduce": [reduces, reduced]}


def tp_rank(rank: int, store: str, out_dir: str, small: bool = False) -> None:
    """One of phase 29's two ranks (a spawned process; ``small``: the smoke
    config on the CPU, a rehearsal)."""
    import datetime
    import os
    import traceback
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    dev = torch.device("cpu") if small else torch.device("cuda", 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    try:
        from repro_torch.data import DataConfig, TokenPipeline
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.model import tp_layout
        from repro_torch.train.sharded import tp_config
        mesh = make_mesh(TP_MESH, ("data", "model"), device=dev.type)
        fsdp_mesh = make_mesh(FSDP_MESH, ("data", "model"), device=dev.type)
        cfg = tp_phase_config(small, torch.float32)
        b, s = (4, 64) if small else (TP_BATCH, TP_SEQ)
        t0 = time.perf_counter()
        params = ep_params(cfg, dev, ())
        pipeline = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                            seq_len=s, global_batch=b,
                                            seed=29))
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipeline.batch(0).items()}
        res = {"draw_s": time.perf_counter() - t0}
        res["f32"] = tp_rank_f32(mesh, dev, rank, params, batch, cfg)
        res["variants"] = {}
        for name, (full_w, smoke_w, _) in TP_VARIANTS.items():
            vcfg = tp_phase_config(small, torch.float32,
                                   smoke_w if small else full_w,
                                   TP_VARIANT_LAYERS)
            got = tp_rank_f32(mesh, dev, rank, ep_params(vcfg, dev, ()),
                              batch, vcfg)
            got["layout"] = list(tp_layout(tp_config(vcfg, mesh),
                                           TP_MESH[1])[:2])
            res["variants"][name] = got
        res["fsdp_f32"] = tp_rank_f32(fsdp_mesh, dev, rank, params, batch,
                                      cfg)
        if dev.type == "cuda":
            free_device_memory()
        res["bf16"] = tp_rank_bf16(mesh, dev, rank, params, pipeline,
                                   tp_phase_config(small, torch.bfloat16))
        del params
        if dev.type == "cuda":
            free_device_memory()
        deep = tp_phase_config(small, torch.bfloat16, layers=None)
        t0 = time.perf_counter()
        params = ep_params(deep, dev, ())
        res["fsdp_draw_s"] = time.perf_counter() - t0
        res["fsdp_expected"] = fsdp_expected(deep, FSDP_MESH[0])
        res["fsdp_bf16"] = tp_rank_bf16(fsdp_mesh, dev, rank, params,
                                        pipeline, deep, FSDP_STEPS)
        res["fsdp_bf16"]["n_layers"] = deep.n_layers
        with open(f"{out_dir}/rank.{rank}.json", "w") as f:
            json.dump(res, f, sort_keys=True)
    except BaseException:
        with open(f"{out_dir}/rank.{rank}.error", "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)
    dist.destroy_process_group()


def tensor_parallel(dev, plain, smi_line: str, small: bool = False) -> dict:
    """Phase 29 (see the module doc).  ``small``: a rehearsal of the ranks
    on the CPU with the smoke config (no kernel times)."""
    import multiprocessing
    import shutil
    import tempfile
    import torch

    t_phase = time.perf_counter()
    if dev.type == "cuda":
        free_device_memory()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    out_dir = obs_dir("tensor_parallel")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=tp_rank,
                         args=(r, f"{tmp}/store", str(out_dir), small))
             for r in range(2)]
    try:
        for pr in procs:
            pr.start()
        for pr in procs:
            pr.join(timeout=TP_PHASE_S + 60)
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()
        errors = sorted(out_dir.glob("rank.*.error"))
        if errors or any(pr.exitcode != 0 for pr in procs):
            fail("phase 29's ranks failed (exit codes "
                 f"{[pr.exitcode for pr in procs]}): "
                 + " | ".join(e.read_text()[-3000:] for e in errors))
        ranks = [json.loads((out_dir / f"rank.{r}.json").read_text())
                 for r in range(2)]
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(out_dir, ignore_errors=True)
    t_ranks = time.perf_counter() - t_phase
    f32 = ranks[0]["f32"]
    if f32["faults"]:
        fail("29a: the float32 tensor-parallel step against the single-"
             "device step: " + "; ".join(f32["faults"]))
    if any(r["f32"]["step_loss"] != f32["step_loss"]
           or r["f32"]["step_grad_norm"] != f32["step_grad_norm"]
           for r in ranks):
        fail(f"29a: the ranks' metrics differ: {[r['f32'] for r in ranks]}")
    for name, (_, _, layout) in TP_VARIANTS.items():
        got = [r["variants"][name] for r in ranks]
        if got[0]["faults"]:
            fail(f"29a {name}: the float32 tensor-parallel step against the "
                 "single-device step: " + "; ".join(got[0]["faults"]))
        if any(g["layout"] != layout for g in got):
            fail(f"29a {name}: layout {[g['layout'] for g in got]}, "
                 f"expected {layout}")
        if any((g["step_loss"], g["step_grad_norm"])
               != (got[0]["step_loss"], got[0]["step_grad_norm"])
               for g in got):
            fail(f"29a {name}: the ranks' metrics differ: {got}")
    fsdp = ranks[0]["fsdp_f32"]
    if fsdp["faults"]:
        fail("29a-fsdp: the float32 FSDP step against the single-device "
             "step: " + "; ".join(fsdp["faults"]))
    if any((r["fsdp_f32"]["step_loss"], r["fsdp_f32"]["step_grad_norm"])
           != (fsdp["step_loss"], fsdp["step_grad_norm"]) for r in ranks):
        fail(f"29a-fsdp: the ranks' metrics differ: "
             f"{[r['fsdp_f32'] for r in ranks]}")
    if fsdp["local"] or not fsdp["data_cut"]:
        fail(f"29a-fsdp: leaves local to \"model\" {fsdp['local']}, cut "
             f"over \"data\" {fsdp['data_cut']}")
    deep_layers = ranks[0]["fsdp_bf16"]["n_layers"]
    want = ranks[0]["fsdp_expected"]
    for r, res in enumerate(ranks):
        steps = res["fsdp_bf16"]["steps"]
        for i, st in enumerate(steps):
            if not math.isfinite(st["loss"]) or st["loss"] != \
                    ranks[0]["fsdp_bf16"]["steps"][i]["loss"]:
                fail(f"29c rank {r} step {i + 1}: loss {st['loss']}")
            got = {k: st["over_data"].get(k) for k in want}
            if got != want or st["collectives"] != steps[0]["collectives"]:
                fail(f"29c rank {r} step {i + 1}: over \"data\" {got}, "
                     f"worked out from the config {want}; collectives "
                     f"{[x['collectives'] for x in steps]}")
            if dev.type != "cuda":
                continue
            if (st["flash_attention"] != 2 * deep_layers
                    or st["routes"] != fa_routes(torch.bfloat16, 64,
                                                 2 * deep_layers)
                    or st["bwd_routes"] != bwd_routes(torch.bfloat16, 64,
                                                      deep_layers)
                    or st["plain_backward"]
                    or st["heads"] != [[14, 2]]):
                fail(f"29c rank {r} step {i + 1}: launches "
                     f"{st['flash_attention']} {st['routes']}, backward "
                     f"{st['bwd_routes']}, plain backward "
                     f"{st['plain_backward']}, heads {st['heads']}: expected "
                     f"{2 * deep_layers} tensor-core launches and "
                     f"{deep_layers} backward calls at (14, 2) heads")
    layers = tp_phase_config(small, torch.float32).n_layers
    per_step = 2 * layers
    for r, res in enumerate(ranks):
        steps = res["bf16"]["steps"]
        for i, st in enumerate(steps):
            if not math.isfinite(st["loss"]) or st["loss"] != \
                    ranks[0]["bf16"]["steps"][i]["loss"]:
                fail(f"29b rank {r} step {i + 1}: loss {st['loss']} (rank 0 "
                     f"{ranks[0]['bf16']['steps'][i]['loss']})")
            if st["collectives"] != steps[0]["collectives"]:
                fail(f"29b rank {r}: collectives differ across steps: "
                     f"{[x['collectives'] for x in steps]}")
            if dev.type != "cuda":
                continue
            if (st["flash_attention"] != per_step
                    or st["routes"] != fa_routes(torch.bfloat16, 64, per_step)
                    or st["bwd_routes"] != bwd_routes(torch.bfloat16, 64,
                                                      layers)
                    or st["plain_backward"]
                    or st["heads"] != [list(TP_LOCAL_HEADS)]):
                fail(f"29b rank {r} step {i + 1}: launches "
                     f"{st['flash_attention']} {st['routes']}, backward "
                     f"{st['bwd_routes']}, plain backward "
                     f"{st['plain_backward']}, heads {st['heads']}: expected "
                     f"{per_step} tensor-core launches and {layers} backward "
                     f"calls at {TP_LOCAL_HEADS} heads")
    out = {"arch": TP_ARCH, "n_layers": layers, "mesh": list(TP_MESH),
           "batch": TP_BATCH, "seq": TP_SEQ, "smi": smi_line,
           "f32_errors": f32["errors"],
           "f32_worst_leaf_share": max(f32["share_of_tolerance"].values()),
           "local_leaves": f32["local"],
           "variants": {name: {
               "layout": r0["layout"], "layers": TP_VARIANT_LAYERS,
               "changes": TP_VARIANTS[name][1 if small else 0],
               "f32_errors": r0["errors"],
               "f32_worst_leaf_share": max(r0["share_of_tolerance"].values()),
               "local_leaves": r0["local"],
               "f32_seconds": [r["variants"][name]["seconds"]
                               for r in ranks]}
               for name, r0 in ranks[0]["variants"].items()},
           "f32_seconds": [r["f32"]["seconds"] for r in ranks],
           "bf16_losses": [st["loss"] for st in ranks[0]["bf16"]["steps"]],
           "bf16_step_wall_s": {r: [st["wall_s"] for st in
                                    res["bf16"]["steps"]]
                                for r, res in enumerate(ranks)},
           "flash_attention_per_rank_step":
               ranks[0]["bf16"]["steps"][0]["flash_attention"],
           "backward_calls_per_rank_step":
               ranks[0]["bf16"]["steps"][0]["bwd_routes"],
           "heads": ranks[0]["bf16"]["steps"][0]["heads"],
           "collectives_per_step": ranks[0]["bf16"]["steps"][0]["collectives"],
           "peak_gib": [r["bf16"]["peak_gib"] for r in ranks],
           "draw_s": [r["draw_s"] for r in ranks],
           "no_sync_in_step_but_gloo": dev.type == "cuda",
           "launches": sum(st["flash_attention"] for r in ranks
                           for st in r["bf16"]["steps"]),
           "backward_calls": sum(sum(st["bwd_routes"].values()) for r in ranks
                                 for st in r["bf16"]["steps"]),
           "ranks_s": t_ranks,
           "fsdp": {
               "mesh": list(FSDP_MESH), "layers_f32": layers,
               "f32_errors": fsdp["errors"],
               "f32_worst_leaf_share": max(
                   fsdp["share_of_tolerance"].values()),
               "f32_seconds": [r["fsdp_f32"]["seconds"] for r in ranks],
               "data_cut_leaves": fsdp["data_cut"],
               "n_layers": deep_layers, "batch": TP_BATCH, "seq": TP_SEQ,
               "draw_s": [r["fsdp_draw_s"] for r in ranks],
               "bf16_losses": [st["loss"] for st in
                               ranks[0]["fsdp_bf16"]["steps"]],
               "bf16_step_wall_s": {r: [st["wall_s"] for st in
                                        res["fsdp_bf16"]["steps"]]
                                    for r, res in enumerate(ranks)},
               "peak_gib": [r["fsdp_bf16"]["peak_gib"] for r in ranks],
               "over_data_per_step":
                   ranks[0]["fsdp_bf16"]["steps"][0]["over_data"],
               "over_data_worked_out": want,
               "collectives_per_step":
                   ranks[0]["fsdp_bf16"]["steps"][0]["collectives"],
               "flash_attention_per_rank_step":
                   ranks[0]["fsdp_bf16"]["steps"][0]["flash_attention"],
               "backward_calls_per_rank_step":
                   ranks[0]["fsdp_bf16"]["steps"][0]["bwd_routes"],
               "heads": ranks[0]["fsdp_bf16"]["steps"][0]["heads"],
               "launches": sum(st["flash_attention"] for r in ranks
                               for st in r["fsdp_bf16"]["steps"]),
               "backward_calls": sum(sum(st["bwd_routes"].values())
                                     for r in ranks
                                     for st in r["fsdp_bf16"]["steps"])}}
    if dev.type == "cuda":
        b, h, kvh, s_len, d = TP_TIME_SHAPE
        out["forward"] = flash_attention_time(dev, plain, "qwen2-0.5b TP rank",
                                              b, h, kvh, d, s_len=s_len)
        grads = train_attention_grads(dev, [TP_GRAD_CASE])[TP_GRAD_CASE[0]]
        out["backward"] = train_attention_time(dev, TP_TIME_SHAPE,
                                               ("bfloat16",))["bfloat16"]
        out["backward"]["max_abs_err"] = max(grads[n][0]
                                             for n in ("dq", "dk", "dv"))
    out["seconds"] = time.perf_counter() - t_phase
    say("tensor_parallel", **{k: v for k, v in out.items()
                              if k not in ("forward", "backward")})
    if out["seconds"] > TP_PHASE_S:
        fail(f"phase 29 took {out['seconds']:.1f} s, over its {TP_PHASE_S} s")
    return out


# phase 30: sharded serving at qwen2-0.5b's widths on two gloo ranks
SERVE_MESHES = {"tp": (1, 2), "fsdp": (2, 1)}
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 4096, 16
SERVE_F32_LAYERS = 4
# 30a / 30b: the prompt ends one before the middle of the cache, so with
# the cache's sequence over "model" the decode steps cross the ranks'
# halves (511 on rank 0, 512 and 513 on rank 1)
SERVE_F32_PROMPT, SERVE_F32_MAX_LEN, SERVE_F32_STEPS = 511, 1024, 3
SERVE_PAGE = 16
SERVE_TOL = 1e-4
SERVE_LOCAL_HEADS = (7, 1)        # 14 / 2 query heads, 2 / 2 KV heads
SERVE_TIME_SHAPE = (4, 7, 1, 4096, 64)
# 30b: one KV head, which 2 "model" ranks do not divide (smoke: the same)
SERVE_SEQ_VARIANT = {"n_kv_heads": 1, "n_layers": 1}
SERVE_PHASE_S = 55


def serve_phase_config(small: bool, dtype, changes=None):
    """qwen2-0.5b (``small``: its smoke config) with ``dtype`` activations
    and ``changes``."""
    from repro_torch.configs import get_config, get_smoke_config
    cfg = (get_smoke_config if small else get_config)(TP_ARCH)
    return dataclasses.replace(cfg, activ_dtype=dtype, **(changes or {}))


def serve_sharded_run(mesh, dev, cfg, p, toks, prompt: int,
                      max_len: int, steps: int, page: int,
                      keep_first: bool = False,
                      overrides: dict | None = None) -> dict:
    """Sharded prefill of ``toks[:, :prompt]`` and ``steps`` decode steps
    on ``mesh`` (``p`` the params laid out by
    ``serve.sharded.lay_out_params``, the rules with ``overrides``), each
    call under the sync check but for gloo's own calls: outputs (the
    logits and page masses gathered, the cache blocks), flash_attention's
    launches, routes and head counts in the prefill and in decode, each
    call's collectives ``(kind, bytes, group size, axis)``, walls, the
    peak memory from the prefill's start."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch import sharding as sh
    from repro_torch.models import attention as attn
    from repro_torch.serve import engine
    from repro_torch.serve import sharded as ss

    b = toks.shape[0]
    cfg_p = ss.serve_config(cfg, mesh, b, prompt, "prefill", overrides)
    cfg_d = ss.serve_config(cfg, mesh, b, max_len, "decode", overrides)
    tok_p = ss.batch_block(toks[:, :prompt], mesh, cfg_p)
    tok_d = [ss.batch_block(toks[:, prompt + t], mesh, cfg_d)
             for t in range(steps)]
    heads, real = set(), attn.flash_train

    def seen(q, k, v, **kw):
        heads.add((q.shape[1], k.shape[1]))
        return real(q, k, v, **kw)
    out = {"logits": [], "mass": []}
    attn.flash_train = seen
    try:
        fa_kernel.LAUNCHES = 0
        for r in fa_kernel.ROUTE_LAUNCHES:
            fa_kernel.ROUTE_LAUNCHES[r] = 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        ep_sync(dev)
        t0 = time.perf_counter()
        with torch.no_grad(), sh.recording() as log, \
                sync_checked_but_collectives(dev.type == "cuda"):
            logits, cache = engine.prefill(p, cfg_p, tokens=tok_p,
                                           max_len=max_len, mesh=mesh)
        ep_sync(dev)
        out["prefill_s"] = time.perf_counter() - t0
        out["prefill_launches"] = fa_kernel.LAUNCHES
        out["prefill_routes"] = dict(fa_kernel.ROUTE_LAUNCHES)
        out["prefill_collectives"] = len(log)
        out["logs"] = [[list(e) for e in log]]
        out["heads"] = sorted(heads)
        out["logits"].append(logits)
        if keep_first:
            out["first"] = {k: v.to_local().clone() for k, v in cache.items()}
        t0 = time.perf_counter()
        with torch.no_grad(), sync_checked_but_collectives(
                dev.type == "cuda"):
            for t in range(steps):
                with sh.recording() as log:
                    logits, cache, aux = engine.decode_step(
                        p, cfg_d, cache, tok_d[t], page_size=page,
                        mesh=mesh)
                out["logs"].append([list(e) for e in log])
                out["logits"].append(logits)
                if "kv_page_mass" in aux:
                    out["mass"].append(aux["kv_page_mass"])
        ep_sync(dev)
        out["decode_s"] = time.perf_counter() - t0
        out["decode_launches"] = fa_kernel.LAUNCHES - out["prefill_launches"]
        out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                           if dev.type == "cuda" else None)
    finally:
        attn.flash_train = real
    out["last"] = {k: v.to_local() for k, v in cache.items()}
    out["shardings"] = sh.cache_shardings(mesh, cfg, b, max_len)
    with torch.no_grad():
        out["logits"] = [ss.gather_outputs(x) for x in out["logits"]]
        out["mass"] = [ss.gather_outputs(x) for x in out["mass"]]
    return out


def serve_rank_f32(mesh, dev, cfg, params, toks,
                   overrides: dict | None = None) -> dict:
    """30a / 30b (and 31a) on one rank: the float32 sharded run (the rules
    with ``overrides``) against the single-device run on this device ->
    each output's worst share of SERVE_TOL (|a - b| / (tol + tol |b|)),
    faults, walls, each sharded call's collectives."""
    import torch
    from repro_torch.launch import sharding as sh
    from repro_torch.serve import engine
    from repro_torch.serve import sharded as ss

    prompt, max_len = SERVE_F32_PROMPT, SERVE_F32_MAX_LEN
    steps = SERVE_F32_STEPS
    if dev.type != "cuda":
        prompt, max_len = 31, 64
    got = serve_sharded_run(mesh, dev, cfg,
                            ss.lay_out_params(params, mesh, cfg, overrides),
                            toks, prompt, max_len, steps, SERVE_PAGE,
                            keep_first=True, overrides=overrides)
    with torch.no_grad():
        logits, cache = engine.prefill(params, cfg, tokens=toks[:, :prompt],
                                       max_len=max_len)
        want = {"logits": [logits], "mass": []}
        want["first"] = {k: v.clone() for k, v in cache.items()}
        for t in range(steps):
            logits, cache, aux = engine.decode_step(
                params, cfg, cache, toks[:, prompt + t], page_size=SERVE_PAGE)
            want["logits"].append(logits)
            if "kv_page_mass" in aux:
                want["mass"].append(aux["kv_page_mass"])
        want["last"] = cache

    def share(a, b) -> float:
        a, b = a.double(), b.double()
        return float(((a - b).abs() / (SERVE_TOL + SERVE_TOL * b.abs()))
                     .max())
    shares = {}
    for i, (a, b) in enumerate(zip(got["logits"], want["logits"])):
        shares[f"logits/{i}"] = share(a, b)
    for i, (a, b) in enumerate(zip(got["mass"], want["mass"])):
        shares[f"mass/{i}"] = share(a, b)
    for when in ("first", "last"):
        for k, mine in got[when].items():
            block = sh.local_block(want[when][k], got["shardings"][k])
            if tuple(block.shape) != tuple(mine.shape):
                shares[f"{when}/{k}"] = math.inf
            elif k == "pos":
                shares[f"{when}/{k}"] = 0.0 if torch.equal(
                    block, mine) else math.inf
            else:
                shares[f"{when}/{k}"] = share(mine, block)
    faults = [f"{k}: {v:.3g} of the tolerance" for k, v in shares.items()
              if not v <= 1.0]
    return {"worst_share": max(shares.values()), "faults": faults,
            "prefill_s": got["prefill_s"], "decode_s": got["decode_s"],
            "prompt": prompt, "max_len": max_len, "logs": got["logs"],
            "cache_blocks": {k: list(v.shape) for k, v in got["last"].items()}}


def serve_rank(rank: int, store: str, out_dir: str, small: bool = False
               ) -> None:
    """One of phase 30's two ranks (a spawned process; ``small``: the
    smoke config on the CPU, a rehearsal)."""
    import datetime
    import os
    import traceback
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    dev = torch.device("cpu") if small else torch.device("cuda", 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    try:
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.serve import sharded as ss
        meshes = {name: make_mesh(shape, ("data", "model"),
                                  device=dev.type)
                  for name, shape in SERVE_MESHES.items()}
        gen = torch.Generator().manual_seed(30)
        res = {}
        t0 = time.perf_counter()
        cfg = serve_phase_config(small, torch.float32,
                                 {"n_layers": SERVE_F32_LAYERS})
        params = ep_params(cfg, dev, ())
        toks = torch.randint(0, cfg.vocab_size,
                             (SERVE_BATCH, SERVE_F32_MAX_LEN), generator=gen,
                             dtype=torch.int32).to(dev)
        res["draw_s"] = time.perf_counter() - t0
        for name, mesh in meshes.items():
            res[f"f32_{name}"] = serve_rank_f32(mesh, dev, cfg, params, toks)
        vcfg = serve_phase_config(small, torch.float32, SERVE_SEQ_VARIANT)
        res["f32_seq"] = serve_rank_f32(meshes["tp"], dev, vcfg,
                                        ep_params(vcfg, dev, ()), toks)
        del params
        if dev.type == "cuda":
            free_device_memory()
        deep = serve_phase_config(small, torch.bfloat16)
        prompt, steps = (64, 4) if small else (SERVE_PROMPT, SERVE_STEPS)
        t0 = time.perf_counter()
        whole = ep_params(deep, dev, ())
        p = ss.lay_out_params(whole, meshes["tp"], deep)
        del whole
        if dev.type == "cuda":
            free_device_memory()
        toks = torch.randint(0, deep.vocab_size,
                             (SERVE_BATCH, prompt + steps), generator=gen,
                             dtype=torch.int32).to(dev)
        res["bf16_draw_s"] = time.perf_counter() - t0
        got = serve_sharded_run(meshes["tp"], dev, deep, p, toks, prompt,
                                prompt + steps, steps, SERVE_PAGE)
        res["bf16"] = {k: got[k] for k in (
            "prefill_s", "decode_s", "prefill_launches", "prefill_routes",
            "decode_launches", "heads", "peak_gib", "prefill_collectives")}
        res["bf16"]["n_layers"] = deep.n_layers
        res["bf16"]["finite"] = all(bool(torch.isfinite(x).all())
                                    for x in got["logits"])
        res["bf16"]["logits_sum"] = [float(x.double().sum())
                                     for x in got["logits"]]
        with open(f"{out_dir}/rank.{rank}.json", "w") as f:
            json.dump(res, f, sort_keys=True)
    except BaseException:
        with open(f"{out_dir}/rank.{rank}.error", "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)
    dist.destroy_process_group()


def sharded_serving(dev, plain, smi_line: str, small: bool = False) -> dict:
    """Phase 30 (see the module doc).  ``small``: a rehearsal of the ranks
    on the CPU with the smoke config (no kernel time)."""
    import multiprocessing
    import shutil
    import tempfile
    import torch

    t_phase = time.perf_counter()
    if dev.type == "cuda":
        free_device_memory()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    out_dir = obs_dir("sharded_serving")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=serve_rank,
                         args=(r, f"{tmp}/store", str(out_dir), small))
             for r in range(2)]
    try:
        for pr in procs:
            pr.start()
        for pr in procs:
            pr.join(timeout=SERVE_PHASE_S + 60)
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()
        errors = sorted(out_dir.glob("rank.*.error"))
        if errors or any(pr.exitcode != 0 for pr in procs):
            fail("phase 30's ranks failed (exit codes "
                 f"{[pr.exitcode for pr in procs]}): "
                 + " | ".join(e.read_text()[-3000:] for e in errors))
        ranks = [json.loads((out_dir / f"rank.{r}.json").read_text())
                 for r in range(2)]
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(out_dir, ignore_errors=True)
    t_ranks = time.perf_counter() - t_phase
    for name in ("f32_tp", "f32_fsdp", "f32_seq"):
        for r, res in enumerate(ranks):
            if res[name]["faults"]:
                fail(f"30 {name} rank {r}: the float32 sharded serving "
                     "against the single-device run: "
                     + "; ".join(res[name]["faults"]))
    layers = ranks[0]["bf16"]["n_layers"]
    for r, res in enumerate(ranks):
        got = res["bf16"]
        if not got["finite"] or got["logits_sum"] != \
                ranks[0]["bf16"]["logits_sum"]:
            fail(f"30c rank {r}: logits finite {got['finite']}, sums "
                 f"{got['logits_sum']} (rank 0 "
                 f"{ranks[0]['bf16']['logits_sum']})")
        if dev.type != "cuda":
            continue
        if (got["prefill_launches"] != layers
                or got["prefill_routes"] != fa_routes(torch.bfloat16, 64,
                                                      layers)
                or got["decode_launches"] != 0
                or got["heads"] != [list(SERVE_LOCAL_HEADS)]):
            fail(f"30c rank {r}: prefill launches {got['prefill_launches']} "
                 f"{got['prefill_routes']}, decode launches "
                 f"{got['decode_launches']}, heads {got['heads']}: expected "
                 f"{layers} tensor-core launches at {SERVE_LOCAL_HEADS} "
                 "heads and none in decode")
    bf = [r["bf16"] for r in ranks]
    b = SERVE_BATCH
    prompt, steps = (64, 4) if small else (SERVE_PROMPT, SERVE_STEPS)
    out = {"arch": TP_ARCH, "meshes": SERVE_MESHES, "smi": smi_line,
           "f32_layers": SERVE_F32_LAYERS,
           "f32_prompt": ranks[0]["f32_tp"]["prompt"],
           "f32_max_len": ranks[0]["f32_tp"]["max_len"],
           "f32_steps": SERVE_F32_STEPS,
           "f32_worst_share": {name: max(r[name]["worst_share"]
                                         for r in ranks)
                               for name in ("f32_tp", "f32_fsdp", "f32_seq")},
           "f32_cache_blocks": {name: ranks[0][name]["cache_blocks"]
                                for name in ("f32_tp", "f32_fsdp", "f32_seq")},
           "bf16_layers": layers, "batch": b, "prompt": prompt,
           "decode_steps": steps,
           "prefill_s": [x["prefill_s"] for x in bf],
           "decode_s": [x["decode_s"] for x in bf],
           "prefill_tokens_per_s": b * prompt / max(x["prefill_s"]
                                                    for x in bf),
           "decode_tokens_per_s": b * steps / max(x["decode_s"] for x in bf),
           "flash_attention_per_rank_prefill": bf[0]["prefill_launches"],
           "flash_attention_in_decode": [x["decode_launches"] for x in bf],
           "heads": bf[0]["heads"],
           "prefill_collectives": bf[0]["prefill_collectives"],
           "peak_gib": [x["peak_gib"] for x in bf],
           "draw_s": [r["draw_s"] + r["bf16_draw_s"] for r in ranks],
           "no_sync_in_serving_but_gloo": dev.type == "cuda",
           "launches": sum(x["prefill_launches"] + x["decode_launches"]
                           for x in bf),
           "ranks_s": t_ranks}
    if dev.type == "cuda":
        bq, h, kvh, s_len, d = SERVE_TIME_SHAPE
        out["forward"] = flash_attention_time(dev, plain,
                                              "qwen2-0.5b serving rank", bq, h,
                                              kvh, d, s_len=s_len)
    out["seconds"] = time.perf_counter() - t_phase
    out["limit_s"] = SERVE_PHASE_S
    say("sharded_serving", **{k: v for k, v in out.items()
                              if k != "forward"})
    if out["seconds"] > SERVE_PHASE_S:
        fail(f"phase 30 took {out['seconds']:.1f} s, over its "
             f"{SERVE_PHASE_S} s")
    return out


# ------------------------------------------------------------------
# phase 31: Mixtral's expert tensor parallelism on two gloo ranks
MOE_TP_ARCH = "mixtral-8x22b"
MOE_TP_MESH = (1, 2)
# 31a / 31b: float32 at one layer (each rank draws the whole layer, 11.6
# GB, then keeps its blocks); 31b's step on Adafactor (two ranks' AdamW
# state beside the blocks and the out-of-place update would not fit the
# one card at float32)
MOE_TP_F32_LAYERS = 1
MOE_TP_TRAIN_BATCH, MOE_TP_TRAIN_SEQ = 1, 512
MOE_TP_OPT = "adafactor"
# 31c: bf16 at two layers, B 4 x S 4096, then MOE_TP_STEPS decode steps
MOE_TP_BF16_LAYERS = 2
MOE_TP_BATCH, MOE_TP_PROMPT, MOE_TP_STEPS = 4, 4096, 4
MOE_TP_LOCAL_HEADS = (24, 4)     # 48 / 2 query heads, 8 / 2 KV heads
MOE_TP_TIME_SHAPE = (4, 24, 4, 4096, 128)
MOE_TP_PHASE_S = 90


def moe_tp_config(small: bool, dtype, layers: int):
    """Mixtral-8x22B at its published widths cut to ``layers`` layers
    (``small``: its smoke config, a rehearsal on the CPU) with ``dtype``
    params and activations."""
    from repro_torch.configs import get_config, get_smoke_config
    cfg = (get_smoke_config if small else get_config)(MOE_TP_ARCH)
    return dataclasses.replace(cfg, n_layers=layers, param_dtype=dtype,
                               activ_dtype=dtype)


@contextlib.contextmanager
def moe_routing_recorded(record: list):
    """Every ``moe_block`` call of the block (the model's layers and the
    serving decode's) appends its ``(counts, dropped)``, device tensors
    copied on the device (no host read inside the sync check)."""
    from repro_torch.models import model as tm
    from repro_torch.serve import engine
    real = tm.moe_block

    def recorded(*a, **kw):
        out, aux = real(*a, **kw)
        record.append((aux["counts"].detach().clone(),
                       aux["dropped"].detach().clone()))
        return out, aux
    tm.moe_block = engine.moe_block = recorded
    try:
        yield
    finally:
        tm.moe_block = engine.moe_block = real


def moe_tp_routing(record: list) -> list:
    """A record's ``(counts, dropped)`` as lists (read after the check)."""
    return [[c.tolist(), d.int().sum().item(), d.flatten().tolist()]
            for c, d in record]


def by_axis(log) -> dict:
    """``{"kind/axis": [count, bytes]}`` of a recorded call's
    collectives."""
    out: dict = {}
    for kind, nbytes, _, axis in log:
        got = out.setdefault(f"{kind}/{axis}", [0, 0])
        got[0] += 1
        got[1] += nbytes
    return out


def moe_tp_expected(kind: str, n_layers: int) -> dict:
    """A serving call's collectives by (kind, axis) count at Mixtral's
    (1, 2) layout on its override, worked out from it: nothing is cut
    over "data"; over "model" the embedding's all-reduce, each layer's
    attention output and expert output summed (one all-reduce each), the
    logits all-gathered once, and at decode each layer's page mass summed
    over the ranks' KV heads; no leaf is gathered over "model"."""
    reduces = 1 + 2 * n_layers + (n_layers if kind == "decode" else 0)
    return {"all_gather/model": 1, "all_reduce/model": reduces}


def moe_tp_serve(mesh, dev, rank: int, small: bool, over: dict) -> dict:
    """31a on one rank: the float32 serving run at one layer against the
    single-device run (serve_rank_f32), its routing recorded."""
    import torch
    cfg = moe_tp_config(small, torch.float32, MOE_TP_F32_LAYERS)
    params = ep_params(cfg, dev, range(cfg.moe.n_experts))
    gen = torch.Generator().manual_seed(31)
    toks = torch.randint(0, cfg.vocab_size,
                         (SERVE_BATCH, SERVE_F32_MAX_LEN), generator=gen,
                         dtype=torch.int32).to(dev)
    record: list = []
    with moe_routing_recorded(record):
        got = serve_rank_f32(mesh, dev, cfg, params, toks, over)
    routing = moe_tp_routing(record)
    n = len(routing) // 2
    if routing[:n] != routing[n:]:
        got["faults"].append("the sharded calls' expert counts or dropped "
                             "pairs differ from the single-device calls'")
    for i, log in enumerate(got["logs"]):
        kind = "prefill" if i == 0 else "decode"
        if by_axis(log).keys() != {"all_gather/model", "all_reduce/model"} \
                or {k: v[0] for k, v in by_axis(log).items()} \
                != moe_tp_expected(kind, cfg.n_layers):
            got["faults"].append(f"call {i} ({kind}): collectives "
                                 f"{by_axis(log)}, expected "
                                 f"{moe_tp_expected(kind, cfg.n_layers)}")
    got["logs"] = [by_axis(log) for log in got["logs"]]
    got["routing"] = routing[:n]
    return got


def moe_tp_train(mesh, dev, rank: int, small: bool, over: dict) -> dict:
    """31b on one rank: the single-device gradient of one layer first
    (its blocks kept, the whole freed), then the sharded gradient (each
    leaf's block against the single-device gradient's block, within
    TRAIN_LEAF_TOL_OF_MAX of that leaf's largest magnitude) and one
    sharded step under the sync check but for gloo's own calls, its loss
    and gradient norm against the single-device ones within
    FULL_WIDTH_F32_TOL; the routing of every call and the collectives."""
    import torch
    from repro_torch.launch import sharding as sh
    from repro_torch.optim import cosine_schedule, get_optimizer
    from repro_torch.optim.optimizers import global_norm
    from repro_torch.pytree import flatten
    from repro_torch.train import sharded
    from repro_torch.train.steps import loss_and_grads

    cfg = moe_tp_config(small, torch.float32, MOE_TP_F32_LAYERS)
    b, s = (1, 64) if small else (MOE_TP_TRAIN_BATCH, MOE_TP_TRAIN_SEQ)
    batch = {k: ep_tokens(cfg, dev, b, s, 31 + c)
             for c, k in enumerate(("tokens", "labels"))}
    opt = get_optimizer(MOE_TP_OPT)
    params = ep_params(cfg, dev, range(cfg.moe.n_experts))
    state = opt.init(params)
    shardings = sharded.state_shardings(mesh, cfg, state, over)
    single: list = []
    t0 = time.perf_counter()
    with moe_routing_recorded(single):
        one_loss, _, one_grads = loss_and_grads(params, cfg, batch)
    one_norm = float(global_norm(one_grads))
    one_leaves, skeleton = flatten(one_grads)
    names = flatten(tree_paths(skeleton))[0]
    blocks = [sh.local_block(g, x).clone() for g, x in
              zip(one_leaves, flatten(shardings[0])[0])]
    tops = [float(g.abs().max()) for g in one_leaves]
    del one_grads, one_leaves
    p, st = sh.distribute((params, state), shardings)
    del params, state
    if dev.type == "cuda":
        free_device_memory()
    out = {"single_s": time.perf_counter() - t0,
           "one_loss": float(one_loss), "one_grad_norm": one_norm}
    db = sh.distribute(batch, sh.named(mesh, sh.batch_specs(mesh, cfg,
                                                            batch)))
    grads_rec: list = []
    with moe_routing_recorded(grads_rec), sh.recording() as log:
        loss, _, grads = sharded.sharded_grads(cfg, mesh, p, db, over)
    faults, share = [], {}
    for name, g, want, top in zip(names, flatten(grads)[0], blocks, tops):
        err = float((g - want).abs().max())
        allowed = TRAIN_LEAF_TOL_OF_MAX * top
        share[name] = err / allowed if allowed > 0 else math.inf
        if not (bool(torch.isfinite(g).all()) and share[name] <= 1.0):
            faults.append(f"{name}: max abs err {err} over {allowed}")
    del grads, blocks
    step = sharded.make_sharded_train_step(cfg, opt,
                                           cosine_schedule(*TP_LR), mesh,
                                           over)
    step_rec: list = []
    ep_sync(dev)
    t0 = time.perf_counter()
    with moe_routing_recorded(step_rec), sh.recording() as step_log, \
            sync_checked_but_collectives(dev.type == "cuda"):
        p, st, m = step(p, st, db)
    ep_sync(dev)
    out["step_s"] = time.perf_counter() - t0
    for key, g, c in (("loss", float(loss), out["one_loss"]),
                      ("step_loss", float(m["loss"]), out["one_loss"]),
                      ("step_grad_norm", float(m["grad_norm"]), one_norm)):
        if not (math.isfinite(g)
                and abs(g - c) <= FULL_WIDTH_F32_TOL * (1 + abs(c))):
            faults.append(f"{key}: {g} vs {c}")
        out[key] = g
    routing = [moe_tp_routing(r) for r in (single, grads_rec, step_rec)]
    if not routing[0] == routing[1] == routing[2]:
        faults.append("the sharded calls' expert counts or dropped pairs "
                      "differ from the single-device calls'")
    for what, lg in (("gradient", log), ("step", step_log)):
        if any(k.startswith("all_gather/model") for k in by_axis(lg)):
            faults.append(f"the {what} gathers over \"model\": "
                          f"{by_axis(lg)}")
    out.update(faults=faults, worst_share=max(share.values()),
               share_of_tolerance=share, routing=routing[1],
               grads_collectives=by_axis(log),
               step_collectives=by_axis(step_log),
               expert_blocks={k: list(x.to_local().shape) for k, x in
                              p["blocks"].items() if k.startswith("e_")},
               peak_gib=(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if dev.type == "cuda" else None))
    return out


def moe_tp_prefill(mesh, dev, rank: int, small: bool, over: dict) -> dict:
    """31c on one rank: Mixtral in bf16 at two layers, its blocks drawn
    whole and laid out, the prefill of B MOE_TP_BATCH x S MOE_TP_PROMPT
    and MOE_TP_STEPS decode steps (serve_sharded_run), its routing and
    collectives."""
    import torch
    from repro_torch.serve import sharded as ss
    cfg = moe_tp_config(small, torch.bfloat16, MOE_TP_BF16_LAYERS)
    prompt, steps = (64, 2) if small else (MOE_TP_PROMPT, MOE_TP_STEPS)
    t0 = time.perf_counter()
    whole = ep_params(cfg, dev, range(cfg.moe.n_experts))
    p = ss.lay_out_params(whole, mesh, cfg, over)
    del whole
    if dev.type == "cuda":
        free_device_memory()
    toks = ep_tokens(cfg, dev, MOE_TP_BATCH, prompt + steps, 311)
    draw_s = time.perf_counter() - t0
    record: list = []
    with moe_routing_recorded(record):
        got = serve_sharded_run(mesh, dev, cfg, p, toks, prompt,
                                prompt + steps, steps, SERVE_PAGE,
                                overrides=over)
    faults = []
    for i, log in enumerate(got["logs"]):
        kind = "prefill" if i == 0 else "decode"
        counted = {k: v[0] for k, v in by_axis(log).items()}
        if counted != moe_tp_expected(kind, cfg.n_layers):
            faults.append(f"call {i} ({kind}): collectives {by_axis(log)}")
    out = {k: got[k] for k in ("prefill_s", "decode_s", "prefill_launches",
                               "prefill_routes", "decode_launches", "heads",
                               "peak_gib")}
    out.update(draw_s=draw_s, n_layers=cfg.n_layers, prompt=prompt,
               steps=steps, faults=faults,
               collectives=[by_axis(log) for log in got["logs"][:2]],
               routing=moe_tp_routing(record),
               finite=all(bool(torch.isfinite(x).all())
                          for x in got["logits"]),
               logits_sum=[float(x.double().sum()) for x in got["logits"]],
               expert_blocks={k: list(x.to_local().shape) for k, x in
                              p["blocks"].items() if k.startswith("e_")})
    return out


def moe_tp_rank(rank: int, store: str, out_dir: str, small: bool = False
                ) -> None:
    """One of phase 31's two ranks (a spawned process; ``small``: the
    smoke config on the CPU, a rehearsal)."""
    import datetime
    import os
    import traceback
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    dev = torch.device("cpu") if small else torch.device("cuda", 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    try:
        from repro_torch.configs import get_sharding_overrides
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh(MOE_TP_MESH, ("data", "model"), device=dev.type)
        over = get_sharding_overrides(MOE_TP_ARCH)
        res = {}
        for name, part in (("serve_f32", moe_tp_serve),
                           ("train_f32", moe_tp_train),
                           ("bf16", moe_tp_prefill)):
            t0 = time.perf_counter()
            res[name] = part(mesh, dev, rank, small, over)
            res[name]["seconds"] = time.perf_counter() - t0
            if dev.type == "cuda":
                free_device_memory()
                torch.cuda.reset_peak_memory_stats(dev)
        with open(f"{out_dir}/rank.{rank}.json", "w") as f:
            json.dump(res, f, sort_keys=True)
    except BaseException:
        with open(f"{out_dir}/rank.{rank}.error", "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)
    dist.destroy_process_group()


def mixtral_expert_tp(dev, plain, smi_line: str, small: bool = False
                      ) -> dict:
    """Phase 31 (see the module doc).  ``small``: a rehearsal of the ranks
    on the CPU with the smoke config (no kernel time)."""
    import multiprocessing
    import shutil
    import tempfile
    import torch

    t_phase = time.perf_counter()
    if dev.type == "cuda":
        free_device_memory()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_moe_tp_")
    out_dir = obs_dir("mixtral_expert_tp")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=moe_tp_rank,
                         args=(r, f"{tmp}/store", str(out_dir), small))
             for r in range(2)]
    try:
        for pr in procs:
            pr.start()
        for pr in procs:
            pr.join(timeout=MOE_TP_PHASE_S + 60)
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()
        errors = sorted(out_dir.glob("rank.*.error"))
        if errors or any(pr.exitcode != 0 for pr in procs):
            fail("phase 31's ranks failed (exit codes "
                 f"{[pr.exitcode for pr in procs]}): "
                 + " | ".join(e.read_text()[-3000:] for e in errors))
        ranks = [json.loads((out_dir / f"rank.{r}.json").read_text())
                 for r in range(2)]
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(out_dir, ignore_errors=True)
    t_ranks = time.perf_counter() - t_phase
    cfg = moe_tp_config(small, torch.float32, 1)
    e, d, fe = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert
    want_blocks = {"e_gate": [1, e, d, fe // 2], "e_up": [1, e, d, fe // 2],
                   "e_down": [1, e, fe // 2, d]}
    for name in ("serve_f32", "train_f32", "bf16"):
        for r, res in enumerate(ranks):
            if res[name]["faults"]:
                fail(f"31 {name} rank {r}: " + "; ".join(res[name]["faults"]))
            if res[name]["routing"] != ranks[0][name]["routing"]:
                fail(f"31 {name}: the ranks' expert counts or dropped pairs "
                     "differ")
    for name, layers in (("train_f32", 1), ("bf16", MOE_TP_BF16_LAYERS)):
        want = {k: [layers] + v[1:] for k, v in want_blocks.items()}
        for r, res in enumerate(ranks):
            if res[name]["expert_blocks"] != want:
                fail(f"31 {name} rank {r}: expert blocks "
                     f"{res[name]['expert_blocks']}, expected {want}")
    bf = [r["bf16"] for r in ranks]
    layers = bf[0]["n_layers"]
    for r, got in enumerate(bf):
        if not got["finite"] or got["logits_sum"] != bf[0]["logits_sum"]:
            fail(f"31c rank {r}: logits finite {got['finite']}, sums "
                 f"{got['logits_sum']} (rank 0 {bf[0]['logits_sum']})")
        if dev.type != "cuda":
            continue
        if (got["prefill_launches"] != layers
                or got["prefill_routes"] != fa_routes(torch.bfloat16,
                                                      cfg.head_dim, layers)
                or got["decode_launches"] != 0
                or got["heads"] != [list(MOE_TP_LOCAL_HEADS)]):
            fail(f"31c rank {r}: prefill launches {got['prefill_launches']} "
                 f"{got['prefill_routes']}, decode launches "
                 f"{got['decode_launches']}, heads {got['heads']}: expected "
                 f"{layers} tensor-core launches at {MOE_TP_LOCAL_HEADS} "
                 "heads and none in decode")
    prompt, steps = bf[0]["prompt"], bf[0]["steps"]
    b = MOE_TP_BATCH
    out = {"arch": MOE_TP_ARCH, "mesh": MOE_TP_MESH, "smi": smi_line,
           "f32_layers": MOE_TP_F32_LAYERS,
           "f32_serve_worst_share": max(r["serve_f32"]["worst_share"]
                                        for r in ranks),
           "f32_serve_collectives": ranks[0]["serve_f32"]["logs"][:2],
           "f32_train_optimizer": MOE_TP_OPT,
           "f32_train_worst_leaf_share": max(r["train_f32"]["worst_share"]
                                             for r in ranks),
           "f32_train_loss": [ranks[0]["train_f32"]["step_loss"],
                              ranks[0]["train_f32"]["one_loss"]],
           "f32_train_grad_norm": [ranks[0]["train_f32"]["step_grad_norm"],
                                   ranks[0]["train_f32"]["one_grad_norm"]],
           "f32_train_step_collectives":
               ranks[0]["train_f32"]["step_collectives"],
           "f32_train_step_s": [r["train_f32"]["step_s"] for r in ranks],
           "f32_train_peak_gib": [r["train_f32"]["peak_gib"] for r in ranks],
           "f32_dropped_pairs": sum(x[1] for x in
                                    ranks[0]["train_f32"]["routing"]),
           "expert_blocks": ranks[0]["bf16"]["expert_blocks"],
           "bf16_layers": layers, "batch": b, "prompt": prompt,
           "decode_steps": steps,
           "prefill_s": [x["prefill_s"] for x in bf],
           "decode_s": [x["decode_s"] for x in bf],
           "prefill_tokens_per_s": b * prompt / max(x["prefill_s"]
                                                    for x in bf),
           "decode_tokens_per_s": b * steps / max(x["decode_s"] for x in bf),
           "flash_attention_per_rank_prefill": bf[0]["prefill_launches"],
           "flash_attention_in_decode": [x["decode_launches"] for x in bf],
           "heads": bf[0]["heads"],
           "bf16_collectives": bf[0]["collectives"],
           "peak_gib": [x["peak_gib"] for x in bf],
           "parts_s": {name: [r[name]["seconds"] for r in ranks]
                       for name in ("serve_f32", "train_f32", "bf16")},
           "no_sync_but_gloo": dev.type == "cuda",
           "launches": sum(x["prefill_launches"] + x["decode_launches"]
                           for x in bf),
           "ranks_s": t_ranks}
    if dev.type == "cuda":
        bq, h, kvh, s_len, d_h = MOE_TP_TIME_SHAPE
        out["forward"] = flash_attention_time(
            dev, plain, "mixtral-8x22b expert-TP rank", bq, h, kvh, d_h,
            s_len=s_len, window=MIXTRAL_WINDOW)
    out["seconds"] = time.perf_counter() - t_phase
    out["limit_s"] = MOE_TP_PHASE_S
    say("mixtral_expert_tp", **{k: v for k, v in out.items()
                                if k != "forward"})
    if out["seconds"] > MOE_TP_PHASE_S:
        fail(f"phase 31 took {out['seconds']:.1f} s, over its "
             f"{MOE_TP_PHASE_S} s")
    return out


# phase 32: RWKV-6's and Mamba2's mixes on each "model" rank's heads
REC_TP_MESH = (1, 2)
# 32a / 32b: float32; rwkv6-3b at 2 layers, zamba2-2.7b at one group of 6
# Mamba2 layers and its shared block; 32b's step on Adafactor, B 1 x S 512
# (31b's)
REC_TP_F32_LAYERS = {"rwkv6-3b": 2, "zamba2-2.7b": 6}
REC_TP_TRAIN_BATCH, REC_TP_TRAIN_SEQ = 1, 512
REC_TP_OPT = "adafactor"
# 32c: bf16, B 4 x S 4096, then REC_TP_STEPS decode steps
REC_TP_BF16_LAYERS = {"rwkv6-3b": 4, "zamba2-2.7b": 6}
REC_TP_BATCH, REC_TP_PROMPT, REC_TP_STEPS = 4, 4096, 2
# a rank's heads at (1, 2): RWKV-6's 40 / 2, Mamba2's 80 / 2; zamba2's
# shared attention 32 / 2 query and KV heads
REC_TP_LOCAL_HEADS = {"rwkv6-3b": 20, "zamba2-2.7b": 40}
REC_TP_ATTN_HEADS = (16, 16)
REC_TP_TIME_SHAPE = (4, 16, 16, 4096, 80)
REC_TP_PHASE_S = 90
# rwkv6-3b's float32 runs at these widths differ from themselves on
# another backend by more than SERVE_TOL and TRAIN_LEAF_TOL_OF_MAX (the
# single-device run on an H100 against the same run on the CPU: 3.14x
# and 30.8x): its sharded runs are held to those bounds or to twice that
# noise floor, measured in the same phase on the same inputs
# (rec_tp_noise)
REC_TP_NOISE_ARCHS = ("rwkv6-3b",)


def rec_tp_config(arch: str, small: bool, dtype, layers: int):
    """``arch`` at its published widths cut to ``layers`` layers
    (``small``: its smoke config at its own depth, a rehearsal on the
    CPU) with ``dtype`` params and activations."""
    from repro_torch.configs import get_config, get_smoke_config
    cfg = (get_smoke_config if small else get_config)(arch)
    if small:
        layers = cfg.n_layers
    return dataclasses.replace(cfg, n_layers=layers, param_dtype=dtype,
                               activ_dtype=dtype)


def rec_tp_leaves(cfg, mesh) -> dict:
    """The step's leaves by what it does with them over "model" (the
    rules' layout of ``cfg`` on ``mesh``): "gathered" the paths of the
    leaves the rules cut over "model" that a rank gathers whole, "local"
    those it keeps as its block, "partial" those whose gradient is a
    partial sum on each rank."""
    from repro_torch.launch import sharding as sh
    local, partial = (dict(rec_tp_items(t))
                      for t in sh.leaf_roles(cfg, mesh))
    specs = dict(rec_tp_items(sh.model_pspecs(mesh, cfg)))
    return {"gathered": sorted(k for k, sp in specs.items() if not local[k]
                               and any("model" in sh.entry_axes(e)
                                       for e in sp)),
            "local": sorted(k for k, v in local.items() if v),
            "partial": sorted(k for k, v in partial.items() if v)}


def rec_tp_items(tree, prefix: str = ""):
    """``(path, leaf)`` of a tree of dicts, the path's parts joined by
    "/" (a spec is a leaf)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from rec_tp_items(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def rec_tp_train_expected(cfg, leaves: dict, seq: int) -> dict:
    """The collectives over "model" of 32b's sharded gradient at (1, 2),
    worked out from the layout (``tests/test_torch_sharded_train.py``'s
    rule): each gathered leaf all-gathered at each forward of its block
    (a layer's twice under remat, zamba2's Mamba2 layers three times,
    nested in their group), a partial one among them reduce-scattered
    once a use; RWKV-6's channel mix 2 all-gathers and 2 reduce-scatters
    a layer; all-reduces 4 an RWKV-6 layer, 7 a Mamba2 layer, 5 a shared
    block, 1 of the embedding, 1 of the loss's input, 4 a loss chunk and
    one a partial leaf "model" does not cut."""
    L = cfg.n_layers
    inv = cfg.n_shared_attn if cfg.family == "zamba2" else 0
    runs = 3 if cfg.family == "zamba2" else 2

    def uses(path):
        return L if path.startswith("blocks/") else inv
    gathered = leaves["gathered"]
    joins = 2 * L if cfg.family == "rwkv6" else 0
    chunk = min(cfg.loss_chunk or seq, seq)
    chunks = seq // chunk if seq % chunk == 0 else 1
    partial_whole = set(leaves["partial"]) - set(gathered)
    per_layer = 4 if cfg.family == "rwkv6" else 7
    return {"all_gather/model": sum(uses(k) * (runs if k.startswith(
                "blocks/") else 2) for k in gathered) + joins,
            "reduce_scatter/model": sum(uses(k) for k in gathered
                                        if k in leaves["partial"]) + joins,
            "all_reduce/model": per_layer * L + 5 * inv + 2 + 4 * chunks
            + len(partial_whole)}


def rec_tp_serve_expected(cfg, leaves: dict, kind: str) -> dict:
    """A serving call's collectives at (1, 2), worked out from the layout:
    each gathered leaf once a use, the logits' all-gather; all-reduces:
    the embedding, each RWKV-6 time mix (Mamba2 mix: its output and its
    sums of squares), each shared block's attention and MLP; RWKV-6's
    channel mix a reduce-scatter and an all-gather a layer; at decode
    each Mamba2 layer's conv state gathered (its channel blocks are not
    the rank's channels); the heads divide "model", so no state is
    joined or gathered but the conv state."""
    L = cfg.n_layers
    inv = cfg.n_shared_attn if cfg.family == "zamba2" else 0
    gathers = sum(L if k.startswith("blocks/") else inv
                  for k in leaves["gathered"]) + 1
    if cfg.family == "rwkv6":
        return {"all_gather/model": gathers + L,
                "all_reduce/model": 1 + L, "reduce_scatter/model": L}
    return {"all_gather/model": gathers + (L if kind == "decode" else 0),
            "all_reduce/model": 1 + 2 * L + 2 * inv}


def rec_tp_serve(mesh, dev, arch: str, small: bool) -> dict:
    """32a on one rank: ``arch``'s float32 serving run against the
    single-device run (serve_rank_f32), its collectives against
    ``rec_tp_serve_expected``."""
    import torch
    from repro_torch.launch.sharding import tp_config
    cfg = rec_tp_config(arch, small, torch.float32, REC_TP_F32_LAYERS[arch])
    params = ep_params(cfg, dev, ())
    gen = torch.Generator().manual_seed(32)
    toks = torch.randint(0, cfg.vocab_size,
                         (SERVE_BATCH, SERVE_F32_MAX_LEN), generator=gen,
                         dtype=torch.int32).to(dev)
    got = serve_rank_f32(mesh, dev, cfg, params, toks)
    if arch in REC_TP_NOISE_ARCHS:
        got["faults"] = []          # held by recurrent_tp (rec_tp_noise)
    leaves = rec_tp_leaves(tp_config(cfg, mesh), mesh)
    for i, log in enumerate(got["logs"]):
        kind = "prefill" if i == 0 else "decode"
        counted = {k: v[0] for k, v in by_axis(log).items()}
        want = rec_tp_serve_expected(cfg, leaves, kind)
        if counted != want:
            got["faults"].append(f"call {i} ({kind}): collectives "
                                 f"{by_axis(log)}, expected {want}")
    got["logs"] = [by_axis(log) for log in got["logs"][:2]]
    got["leaves"] = leaves
    return got


def rec_tp_train(mesh, dev, arch: str, small: bool) -> dict:
    """32b on one rank: the single-device gradient first (its blocks kept,
    the whole freed), then the sharded gradient (each leaf's block
    against the single-device gradient's block, within
    TRAIN_LEAF_TOL_OF_MAX of that leaf's largest magnitude; its
    collectives over "model" ``rec_tp_train_expected``'s) and one sharded
    step under the sync check but for gloo's own calls, its loss and
    gradient norm against the single-device ones within
    FULL_WIDTH_F32_TOL."""
    import torch
    from repro_torch.launch import sharding as sh
    from repro_torch.optim import cosine_schedule, get_optimizer
    from repro_torch.optim.optimizers import global_norm
    from repro_torch.pytree import flatten
    from repro_torch.train import sharded
    from repro_torch.train.steps import loss_and_grads

    cfg = rec_tp_config(arch, small, torch.float32, REC_TP_F32_LAYERS[arch])
    b, s = (1, 64) if small else (REC_TP_TRAIN_BATCH, REC_TP_TRAIN_SEQ)
    batch = {k: ep_tokens(cfg, dev, b, s, 32 + c)
             for c, k in enumerate(("tokens", "labels"))}
    opt = get_optimizer(REC_TP_OPT)
    params = ep_params(cfg, dev, ())
    state = opt.init(params)
    shardings = sharded.state_shardings(mesh, cfg, state)
    t0 = time.perf_counter()
    one_loss, _, one_grads = loss_and_grads(params, cfg, batch)
    one_norm = float(global_norm(one_grads))
    one_leaves, skeleton = flatten(one_grads)
    names = flatten(tree_paths(skeleton))[0]
    blocks = [sh.local_block(g, x).clone() for g, x in
              zip(one_leaves, flatten(shardings[0])[0])]
    tops = [float(g.abs().max()) for g in one_leaves]
    del one_grads, one_leaves
    p, st = sh.distribute((params, state), shardings)
    del params, state
    if dev.type == "cuda":
        free_device_memory()
    out = {"single_s": time.perf_counter() - t0,
           "one_loss": float(one_loss), "one_grad_norm": one_norm}
    db = sh.distribute(batch, sh.named(mesh, sh.batch_specs(mesh, cfg,
                                                            batch)))
    with sh.recording() as log:
        loss, _, grads = sharded.sharded_grads(cfg, mesh, p, db)
    faults, share = [], {}
    noise = arch in REC_TP_NOISE_ARCHS
    for name, g, want, top in zip(names, flatten(grads)[0], blocks, tops):
        err = float((g - want).abs().max())
        allowed = TRAIN_LEAF_TOL_OF_MAX * top
        # a leaf whose gradient is 0 (a LoRA factor before its zero-drawn
        # partner) must come out 0
        share[name] = (err / allowed if allowed > 0
                       else 0.0 if err == 0 else math.inf)
        if not bool(torch.isfinite(g).all()):
            share[name] = math.inf
        if not (noise or share[name] <= 1.0):
            faults.append(f"{name}: max abs err {err} over {allowed}")
    del grads, blocks
    leaves = rec_tp_leaves(sh.tp_config(cfg, mesh), mesh)
    want = rec_tp_train_expected(cfg, leaves, s)
    counted = {k: v[0] for k, v in by_axis(log).items()
               if k.endswith("/model")}
    if counted != want:
        faults.append(f"the gradient's collectives over \"model\" "
                      f"{counted}, expected {want}")
    step = sharded.make_sharded_train_step(cfg, opt,
                                           cosine_schedule(*TP_LR), mesh)
    ep_sync(dev)
    t0 = time.perf_counter()
    with sh.recording() as step_log, \
            sync_checked_but_collectives(dev.type == "cuda"):
        p, st, m = step(p, st, db)
    ep_sync(dev)
    out["step_s"] = time.perf_counter() - t0
    for key, g, c in (("loss", float(loss), out["one_loss"]),
                      ("step_loss", float(m["loss"]), out["one_loss"]),
                      ("step_grad_norm", float(m["grad_norm"]), one_norm)):
        if not math.isfinite(g) or (
                abs(g - c) > FULL_WIDTH_F32_TOL * (1 + abs(c))
                and not (noise and key == "step_grad_norm")):
            faults.append(f"{key}: {g} vs {c}")
        out[key] = g
    out.update(faults=faults, worst_share=max(share.values()),
               leaves=leaves, grads_collectives=by_axis(log),
               step_collectives=by_axis(step_log),
               peak_gib=(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if dev.type == "cuda" else None))
    return out


def rec_tp_prefill(mesh, dev, arch: str, small: bool) -> dict:
    """32c on one rank: ``arch`` in bf16, its blocks drawn whole and laid
    out, the prefill of B REC_TP_BATCH x S REC_TP_PROMPT and REC_TP_STEPS
    decode steps (serve_sharded_run), its launches and collectives."""
    import torch
    from repro_torch.launch.sharding import tp_config
    from repro_torch.serve import sharded as ss
    cfg = rec_tp_config(arch, small, torch.bfloat16,
                        REC_TP_BF16_LAYERS[arch])
    prompt, steps = (64, 2) if small else (REC_TP_PROMPT, REC_TP_STEPS)
    t0 = time.perf_counter()
    whole = ep_params(cfg, dev, ())
    p = ss.lay_out_params(whole, mesh, cfg)
    del whole
    if dev.type == "cuda":
        free_device_memory()
    toks = ep_tokens(cfg, dev, REC_TP_BATCH, prompt + steps, 321)
    draw_s = time.perf_counter() - t0
    got = serve_sharded_run(mesh, dev, cfg, p, toks, prompt, prompt + steps,
                            steps, SERVE_PAGE)
    leaves = rec_tp_leaves(tp_config(cfg, mesh), mesh)
    faults = []
    for i, log in enumerate(got["logs"]):
        kind = "prefill" if i == 0 else "decode"
        counted = {k: v[0] for k, v in by_axis(log).items()}
        if counted != rec_tp_serve_expected(cfg, leaves, kind):
            faults.append(f"call {i} ({kind}): collectives {by_axis(log)}")
    out = {k: got[k] for k in ("prefill_s", "decode_s", "prefill_launches",
                               "prefill_routes", "decode_launches", "heads",
                               "peak_gib")}
    out.update(draw_s=draw_s, n_layers=cfg.n_layers, prompt=prompt,
               steps=steps, faults=faults,
               collectives=[by_axis(log) for log in got["logs"][:2]],
               finite=all(bool(torch.isfinite(x).all())
                          for x in got["logits"]),
               logits_sum=[float(x.double().sum()) for x in got["logits"]],
               state_blocks={k: list(v.shape) for k, v in
                             got["last"].items() if k in ("wkv", "ssm")})
    return out


def rec_tp_single(cfg, dev, params, toks, batch, small: bool) -> tuple:
    """The single-device float32 runs 32a / 32b hold the sharded ones to,
    on ``dev``: the serving outputs (serve_rank_f32's prefill and decode
    steps, its shorter ones for a ``small`` rehearsal: each call's logits,
    the cache after the prefill and after the last step) and the gradient
    of ``batch`` (loss, leaves, norm)."""
    import torch
    from repro_torch.optim.optimizers import global_norm
    from repro_torch.pytree import flatten
    from repro_torch.serve import engine
    from repro_torch.train.steps import loss_and_grads
    prompt, max_len = ((31, 64) if small
                       else (SERVE_F32_PROMPT, SERVE_F32_MAX_LEN))
    out = {}
    with torch.no_grad():
        logits, cache = engine.prefill(params, cfg, tokens=toks[:, :prompt],
                                       max_len=max_len)
        out["logits/0"] = logits
        out.update({f"first/{k}": v.clone() for k, v in cache.items()})
        for t in range(SERVE_F32_STEPS):
            logits, cache, _ = engine.decode_step(params, cfg, cache,
                                                  toks[:, prompt + t])
            out[f"logits/{t + 1}"] = logits
        out.update({f"last/{k}": v for k, v in cache.items()})
    loss, _, grads = loss_and_grads(params, cfg, batch)
    leaves, skeleton = flatten(grads)
    names = flatten(tree_paths(skeleton))[0]
    return out, float(loss), dict(zip(names, leaves)), float(
        global_norm(grads))


def rec_tp_noise(arch: str, dev, small: bool):
    """The float32 noise floor of ``arch``'s single-device run at 32a /
    32b's inputs: the same function on the CPU against it on ``dev``.
    Starts the CPU run on a thread and returns ``finish()``, which (after
    the ranks, on the free device) runs it on ``dev`` and gives the worst
    serving share of SERVE_TOL, the worst gradient leaf's share of
    TRAIN_LEAF_TOL_OF_MAX of that leaf's largest magnitude, and the
    gradient norm's gap."""
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from repro_torch.pytree import tree_map
    cfg = rec_tp_config(arch, small, torch.float32, REC_TP_F32_LAYERS[arch])
    b, s = (1, 64) if small else (REC_TP_TRAIN_BATCH, REC_TP_TRAIN_SEQ)
    gen = torch.Generator().manual_seed(32)
    toks = torch.randint(0, cfg.vocab_size,
                         (SERVE_BATCH, SERVE_F32_MAX_LEN), generator=gen,
                         dtype=torch.int32)
    batch = {k: ep_tokens(cfg, torch.device("cpu"), b, s, 32 + c)
             for c, k in enumerate(("tokens", "labels"))}
    host = tree_map(lambda x: x.cpu(), ep_params(cfg, dev, ()))
    pool = ThreadPoolExecutor(max_workers=1)
    on_cpu = pool.submit(rec_tp_single, cfg, torch.device("cpu"), host,
                         toks, batch, small)
    pool.shutdown(wait=False)

    def finish() -> dict:
        cpu = on_cpu.result()
        params = tree_map(lambda x: x.to(dev), host)
        mine = rec_tp_single(cfg, dev, params, toks.to(dev),
                             {k: v.to(dev) for k, v in batch.items()}, small)

        def share(a, b):
            a, b = a.double().cpu(), b.double().cpu()
            return float(((a - b).abs() / (SERVE_TOL + SERVE_TOL * b.abs()))
                         .max())
        serve = {k: share(mine[0][k], v) for k, v in cpu[0].items()
                 if k.split("/")[-1] != "pos"}
        grads = {}
        for k, v in cpu[2].items():
            top = float(v.abs().max())
            err = float((mine[2][k].cpu() - v).abs().max())
            grads[k] = (err / (TRAIN_LEAF_TOL_OF_MAX * top) if top > 0
                        else 0.0 if err == 0 else math.inf)
        return {"serve_worst": max(serve.values()), "serve": serve,
                "grad_worst": max(grads.values()),
                "grad_top": sorted(grads.items(), key=lambda kv: -kv[1])[:6],
                "loss": [mine[1], cpu[1]], "grad_norm": [mine[3], cpu[3]]}
    return finish


def rec_tp_rank(rank: int, store: str, out_dir: str, small: bool = False
                ) -> None:
    """One of phase 32's two ranks (a spawned process; ``small``: the
    smoke configs on the CPU, a rehearsal)."""
    import datetime
    import os
    import traceback
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    dev = torch.device("cpu") if small else torch.device("cuda", 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    try:
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh(REC_TP_MESH, ("data", "model"), device=dev.type)
        res = {}
        for arch in REC_TP_F32_LAYERS:
            for name, part in (("serve_f32", rec_tp_serve),
                               ("train_f32", rec_tp_train),
                               ("bf16", rec_tp_prefill)):
                t0 = time.perf_counter()
                got = part(mesh, dev, arch, small)
                got["seconds"] = time.perf_counter() - t0
                res[f"{arch} {name}"] = got
                if dev.type == "cuda":
                    free_device_memory()
                    torch.cuda.reset_peak_memory_stats(dev)
        with open(f"{out_dir}/rank.{rank}.json", "w") as f:
            json.dump(res, f, sort_keys=True)
    except BaseException:
        with open(f"{out_dir}/rank.{rank}.error", "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)
    dist.destroy_process_group()


def recurrent_tp(dev, plain, smi_line: str, small: bool = False) -> dict:
    """Phase 32 (see the module doc).  ``small``: a rehearsal of the ranks
    on the CPU with the smoke configs (no kernel time)."""
    import multiprocessing
    import shutil
    import tempfile
    import torch

    t_phase = time.perf_counter()
    if dev.type == "cuda":
        free_device_memory()
    noise = {arch: rec_tp_noise(arch, dev, small)
             for arch in REC_TP_NOISE_ARCHS}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rec_tp_")
    out_dir = obs_dir("recurrent_tp")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rec_tp_rank,
                         args=(r, f"{tmp}/store", str(out_dir), small))
             for r in range(2)]
    try:
        for pr in procs:
            pr.start()
        for pr in procs:
            pr.join(timeout=REC_TP_PHASE_S + 60)
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()
        errors = sorted(out_dir.glob("rank.*.error"))
        if errors or any(pr.exitcode != 0 for pr in procs):
            fail("phase 32's ranks failed (exit codes "
                 f"{[pr.exitcode for pr in procs]}): "
                 + " | ".join(e.read_text()[-3000:] for e in errors))
        ranks = [json.loads((out_dir / f"rank.{r}.json").read_text())
                 for r in range(2)]
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(out_dir, ignore_errors=True)
    t_ranks = time.perf_counter() - t_phase
    noise = {arch: finish() for arch, finish in noise.items()}
    for arch, floor in noise.items():
        # within the bounds, or no farther from the single-device run than
        # twice the same run on the CPU is
        for r, res in enumerate(ranks):
            got = {"serve": res[f"{arch} serve_f32"]["worst_share"],
                   "grad": res[f"{arch} train_f32"]["worst_share"]}
            for what, worst in got.items():
                if not worst <= max(1.0, 2 * floor[f"{what}_worst"]):
                    fail(f"32 {arch} rank {r}: the {what} shares "
                         f"{worst:.3g} of the tolerance, the CPU run's "
                         f"{floor[f'{what}_worst']:.3g}")
            gap = abs(res[f"{arch} train_f32"]["step_grad_norm"]
                      - res[f"{arch} train_f32"]["one_grad_norm"])
            cpu_gap = abs(floor["grad_norm"][0] - floor["grad_norm"][1])
            if not gap <= max(FULL_WIDTH_F32_TOL
                              * (1 + floor["grad_norm"][0]), 2 * cpu_gap):
                fail(f"32 {arch} rank {r}: gradient norm off by {gap}, the "
                     f"CPU run's by {cpu_gap}")
    out = {"mesh": REC_TP_MESH, "smi": smi_line, "ranks_s": t_ranks,
           "no_sync_but_gloo": dev.type == "cuda", "launches": 0,
           "noise_floor": noise}
    for arch in REC_TP_F32_LAYERS:
        for name in ("serve_f32", "train_f32", "bf16"):
            for r, res in enumerate(ranks):
                if res[f"{arch} {name}"]["faults"]:
                    fail(f"32 {arch} {name} rank {r}: "
                         + "; ".join(res[f"{arch} {name}"]["faults"]))
        bf = [res[f"{arch} bf16"] for res in ranks]
        cfg = rec_tp_config(arch, small, torch.bfloat16,
                            REC_TP_BF16_LAYERS[arch])
        attn = cfg.n_shared_attn if cfg.family == "zamba2" else 0
        heads = (cfg.d_model // 64 if cfg.family == "rwkv6"
                 else cfg.mamba_heads) // REC_TP_MESH[1]
        state = "wkv" if cfg.family == "rwkv6" else "ssm"
        for r, got in enumerate(bf):
            if not got["finite"] or got["logits_sum"] != bf[0]["logits_sum"]:
                fail(f"32c {arch} rank {r}: logits finite {got['finite']}, "
                     f"sums {got['logits_sum']} (rank 0 "
                     f"{bf[0]['logits_sum']})")
            if got["state_blocks"][state][2] != heads:
                fail(f"32c {arch} rank {r}: its {state} block "
                     f"{got['state_blocks'][state]}, not its {heads} heads")
            if dev.type != "cuda":
                continue
            want_heads = [list(REC_TP_ATTN_HEADS)] if attn else []
            if (got["prefill_launches"] != attn
                    or (attn and got["prefill_routes"] != fa_routes(
                        torch.bfloat16, cfg.head_dim, attn))
                    or got["decode_launches"] != 0
                    or got["heads"] != want_heads):
                fail(f"32c {arch} rank {r}: prefill launches "
                     f"{got['prefill_launches']} {got['prefill_routes']}, "
                     f"decode launches {got['decode_launches']}, heads "
                     f"{got['heads']}: expected {attn} tensor-core launches "
                     f"at {want_heads} and none in decode")
        t32 = [res[f"{arch} train_f32"] for res in ranks]
        prompt, steps = bf[0]["prompt"], bf[0]["steps"]
        out[arch] = {
            "f32_layers": REC_TP_F32_LAYERS[arch],
            "f32_serve_worst_share": max(res[f"{arch} serve_f32"][
                "worst_share"] for res in ranks),
            "f32_serve_collectives": ranks[0][f"{arch} serve_f32"]["logs"],
            "leaves": ranks[0][f"{arch} serve_f32"]["leaves"],
            "f32_train_optimizer": REC_TP_OPT,
            "f32_train_worst_leaf_share": max(x["worst_share"] for x in t32),
            "f32_train_loss": [t32[0]["step_loss"], t32[0]["one_loss"]],
            "f32_train_grad_norm": [t32[0]["step_grad_norm"],
                                    t32[0]["one_grad_norm"]],
            "f32_train_grads_collectives": t32[0]["grads_collectives"],
            "f32_train_step_s": [x["step_s"] for x in t32],
            "f32_train_peak_gib": [x["peak_gib"] for x in t32],
            "bf16_layers": bf[0]["n_layers"], "batch": REC_TP_BATCH,
            "prompt": prompt, "decode_steps": steps,
            "local_heads": heads,
            "prefill_s": [x["prefill_s"] for x in bf],
            "decode_s": [x["decode_s"] for x in bf],
            "prefill_tokens_per_s_a_rank": REC_TP_BATCH * prompt
            / max(x["prefill_s"] for x in bf),
            "decode_tokens_per_s": REC_TP_BATCH * steps
            / max(x["decode_s"] for x in bf),
            "flash_attention_per_rank_prefill": bf[0]["prefill_launches"],
            "flash_attention_in_decode": [x["decode_launches"] for x in bf],
            "attention_heads": bf[0]["heads"],
            "bf16_collectives": bf[0]["collectives"],
            "state_blocks": bf[0]["state_blocks"],
            "peak_gib": [x["peak_gib"] for x in bf],
            "parts_s": {name: [res[f"{arch} {name}"]["seconds"]
                               for res in ranks]
                        for name in ("serve_f32", "train_f32", "bf16")}}
        out["launches"] += sum(x["prefill_launches"] + x["decode_launches"]
                               for x in bf)
    if dev.type == "cuda":
        bq, h, kvh, s_len, d_h = REC_TP_TIME_SHAPE
        out["forward"] = flash_attention_time(
            dev, plain, "zamba2-2.7b tensor-parallel rank", bq, h, kvh, d_h,
            s_len=s_len)
    out["seconds"] = time.perf_counter() - t_phase
    out["limit_s"] = REC_TP_PHASE_S
    say("recurrent_tp", **{k: v for k, v in out.items() if k != "forward"})
    if out["seconds"] > REC_TP_PHASE_S:
        fail(f"phase 32 took {out['seconds']:.1f} s, over its "
             f"{REC_TP_PHASE_S} s")
    return out


def in_band(name: str, checks: dict) -> None:
    bad = {k: v for k, v in checks.items() if not v}
    if bad:
        fail(f"{name} outside the bands of tests/test_paper_claims.py: "
             f"{sorted(bad)}")


def main(until: int = 32) -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))

    from repro_torch.core import runtime, selectk
    from repro_torch.dlrm import datagen, tracesim
    from repro_torch.examples import dlrm_tiering
    from repro_torch.kernels import _build
    from repro_torch.kernels.dispatch import KernelBackend
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.embedding_bag import kernel as eb_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.gather_count import gather_count
    from repro_torch.kernels.gather_count import kernel as gc_kernel
    from repro_torch.kernels.hist_select import kernel as hs_kernel
    from repro_torch.kernels.hist_select import kth_key
    from repro_torch.kernels.observe_scatter import kernel as os_kernel
    from repro_torch.kernels.observe_scatter import observe_scatter
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher
    from repro_torch.scenarios import (DLRMScenario, KVCacheScenario,
                                       build_hints, run_scenario)
    from repro_torch.workloads import mmap_bench

    plain = KernelBackend(plain=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernel_modules = {"observe_scatter": os_kernel, "hist_select": hs_kernel,
                      "gather_count": gc_kernel, "embedding_bag": eb_kernel,
                      "flash_attention": fa_kernel}

    def zero_counts() -> None:
        for mod in kernel_modules.values():
            mod.LAUNCHES = 0
        os_kernel.KEEP_LAUNCHES = 0
        for mod in (fa_kernel, eb_kernel):
            for route in mod.ROUTE_LAUNCHES:
                mod.ROUTE_LAUNCHES[route] = 0
        for mode in os_kernel.MODE_LAUNCHES:
            os_kernel.MODE_LAUNCHES[mode] = 0
        fa_kernel.BWD_LAUNCHES = 0
        for route in fa_kernel.BWD_ROUTE_LAUNCHES:
            fa_kernel.BWD_ROUTE_LAUNCHES[route] = 0

    def read_counts() -> dict:
        return {name: mod.LAUNCHES for name, mod in kernel_modules.items()}

    def read_routes() -> dict:
        """flash_attention's launches by route."""
        return dict(fa_kernel.ROUTE_LAUNCHES)

    # ---------------------------------------------------------- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi gave no output"
    cap = torch.cuda.get_device_capability(dev)
    say("device", name=torch.cuda.get_device_name(dev), smi=smi_line,
        capability=list(cap), torch=torch.__version__,
        cuda=torch.version.cuda)
    if cap != (9, 0):
        fail(f"compute capability {cap}, the kernels are built for sm_90a")

    if until < 2:
        fail(f"stopped after phase {until} (--until)")
    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    took = _build.build_all()
    ptxas = {}
    for name in took:
        log = _build.library_path(name).with_suffix(".log")
        ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                       if "registers" in ln or "spill" in ln
                       or "C75" in ln] if log.exists() else []
    say("build", seconds=time.perf_counter() - t0, per_kernel=took,
        ptxas=ptxas)
    fa_log = _build.library_path("flash_attention").with_suffix(
        ".log").read_text()
    n_dims = len(fa_kernel.HEAD_DIMS)
    tf32_spills = spill_bytes(fa_log, "flash_attention_tf32x3_kernel")
    if len(tf32_spills) != n_dims or any(tf32_spills.values()):
        fail(f"the TF32 flash_attention kernels (d in "
             f"{fa_kernel.HEAD_DIMS}) spill or are missing from the ptxas "
             f"report: {tf32_spills}")
    wgmma_spills = spill_bytes(fa_log, "fa_wgmma_kernel")
    if len(wgmma_spills) != n_dims or any(wgmma_spills.values()):
        fail(f"the tensor-core flash_attention kernels (d in "
             f"{fa_kernel.HEAD_DIMS}) spill or are missing from the ptxas "
             f"report: {wgmma_spills}")
    # the backward's dq and dk / dv kernels of both routes
    bwd_spills = spill_bytes(fa_log, "fa_bwd")
    if len(bwd_spills) != 4 * n_dims or any(bwd_spills.values()):
        fail(f"the backward flash_attention kernels (d in "
             f"{fa_kernel.HEAD_DIMS}) spill or are missing from the ptxas "
             f"report: {bwd_spills}")
    # on wgmma alone, HGMMA in each and no warp-level HMMA: the bf16
    # backward's kernels at the trained head dims (64: qwen2-0.5b, 128:
    # Mixtral) and the TF32 route's forward at every head dim its wgmma body
    # takes (all but 256, which keeps mma.sync)
    fa_lib = _build.library_path("flash_attention")
    markers = {"bf16_backward": [
        "fa_bwd_wg_dq_kernelILi64E", "fa_bwd_wg_dkv_kernelILi64E",
        "fa_bwd_wg_dq_kernelILi128E", "fa_bwd_wg_dkv_kernelILi128E"],
        "tf32x3": [f"flash_attention_tf32x3_kernelILi{d}E"
                   for d in fa_kernel.TF32X3_WGMMA_HEAD_DIMS]}
    wgmma_mix = {}
    for kind, names in markers.items():
        wgmma_mix[kind] = {}
        for marker in names:
            fns = sass_text(fa_lib, marker)
            ops = [re.match(r"(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ins)
                   for body in fns.values() for ins in body]
            ops = [m.group(1) for m in ops if m]
            mix = wgmma_mix[kind][marker] = [
                len(fns), len(ops), sum(o.startswith("HGMMA") for o in ops),
                sum(o.startswith("HMMA") for o in ops)]
            if mix[0] != 1 or not mix[2] or mix[3]:
                fail(f"the {kind} kernel {marker}: {mix[0]} functions, "
                     f"{mix[2]} HGMMA and {mix[3]} HMMA instructions "
                     f"(expected one, on wgmma alone)")
    # the TF32 kernels' instruction mix: how many instructions the operand
    # splits and the softmax add to each HGMMA (HMMA at d 256)
    # and the registers a thread each was built with (at launch: the wgmma
    # body's setmaxnreg moves them between its warpgroups)
    say("build_sass", tf32x3=sass_mix(fa_lib, "flash_attention_tf32x3_kernel"),
        functions_instructions_hgmma_hmma=wgmma_mix,
        tf32x3_registers=ptxas_registers(fa_log,
                                         "flash_attention_tf32x3_kernel"))

    rng = np.random.default_rng(0)
    errors = {}

    # ------------------------------------ 3. observe_scatter vs plain, exact
    t0 = time.perf_counter()
    spec = datagen.DLRMTraceSpec(n_params=5_368_709_120)
    if spec.n_pages != PAPER_PAGES:
        fail(f"paper spec has {spec.n_pages} pages")
    scen = DLRMScenario(spec=spec, n_epochs=6, batches_per_epoch=2,
                        shift_at=3, k_hot=PAPER_K_HOT)
    epochs = list(scen.epochs())
    setup_s = time.perf_counter() - t0
    paper_ids = torch.from_numpy(epochs[0][0]).to(dev)
    errors["observe_scatter"] = check_observe_scatter(dev, rng, plain,
                                                      paper_ids)

    # ---------------------------------------- 4. hist_select vs plain, exact
    t0 = time.perf_counter()
    hs_cases = hist_select_cases(dev, rng, datagen, DLRMScenario)
    worst = 0
    for label, rows_t, sg, ks in hs_cases:
        before = hs_kernel.LAUNCHES
        got = kth_key(rows_t, sg, ks)
        if hs_kernel.LAUNCHES != before + 1:
            fail(f"hist_select ({label}) did not launch once")
        ref = kth_key(rows_t, sg, ks, backend=plain)
        torch.cuda.synchronize()
        err = int((got - ref).abs().max())
        worst = max(worst, err)
        if err != 0:
            fail(f"hist_select differs from its plain version ({label}, "
                 f"ks {ks}, max abs err {err})")
    # and the whole selection built on it, against the plain threshold
    keys_t = hs_cases[0][1]
    v1, i1, s1 = selectk.select_top_k(keys_t, PAPER_K_HOT, return_mask=True)
    v2, i2, s2 = selectk.select_top_k(keys_t, PAPER_K_HOT, return_mask=True,
                                      backend=plain)
    sel_equal = bool(torch.equal(v1, v2) and torch.equal(i1, i2)
                     and torch.equal(s1, s2))
    say("hist_select", cases=[[c[0], list(c[1].shape), list(c[3])]
                              for c in hs_cases],
        max_abs_err=worst, select_top_k_equal=sel_equal,
        seconds=time.perf_counter() - t0)
    errors["hist_select"] = worst
    if not sel_equal:
        fail("select_top_k on the kernel's threshold differs from the plain "
             "version's")
    del hs_cases, keys_t
    free_device_memory()

    # --------------------------------------- 5. gather_count vs plain, exact
    t0 = time.perf_counter()
    errors["gather_count"] = check_gather_count(dev, rng, plain)
    say("gather_count", storage=[PAPER_STORAGE_ROWS, PAPER_DIM],
        dtypes=["float32", "bfloat16"], m=[1, 127, 2_400_001],
        max_abs_err=errors["gather_count"], seconds=time.perf_counter() - t0)

    # ------------------------------------------ 6. embedding_bag vs plain
    t0 = time.perf_counter()
    eb_err, eb_routes = check_embedding_bag(dev, rng, plain)
    errors["embedding_bag"] = eb_err["float32"]
    say("embedding_bag", storage=[PAPER_STORAGE_ROWS, PAPER_DIM],
        cases=[list(c) for c in EB_CASES], unaligned=list(EB_UNALIGNED),
        routes=eb_routes, max_abs_err=eb_err, tolerance=EB_TOL,
        counts_exact=True, tiled_equals_per_bag_bitwise=True,
        seconds=time.perf_counter() - t0)

    if until < 7:
        fail(f"stopped after phase {until} (--until)")
    # -------------------------------- 7. SMALL parity, GPU vs CPU, bytewise
    t0 = time.perf_counter()
    for hints in (False, True):
        for k in (1, 4, 7):
            out = {d: json.dumps(run_scenario(
                DLRMScenario(spec=datagen.SMALL), hints=hints, sync_every=k,
                device=d), sort_keys=True) for d in ("cuda", "cpu")}
            if out["cuda"] != out["cpu"]:
                fail(f"SMALL trajectory differs GPU vs CPU (hints={hints}, "
                     f"sync_every={k})")
    say("small_parity", runs=12, identical=True,
        seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    pooled_err = offline_small_parity(dlrm_tiering, tracesim, datagen,
                                      mmap_bench)
    say("offline_small_parity", table1=True, fig3=True, example=True,
        example_pooled_max_abs_err=pooled_err,
        seconds=time.perf_counter() - t0)

    if until < 8:
        fail(f"stopped after phase {until} (--until)")
    # ------------------------------ 8. the online main path, paper scale
    t0 = time.perf_counter()
    pipeline = build_hints(scen)
    setup_s += time.perf_counter() - t0
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with runtime.counting() as c:
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            res = run_scenario(scen, hints=pipeline, sync_every=4,
                               epochs=epochs)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        wall = time.perf_counter() - t0
    launches = read_counts()
    os_paper_modes = dict(os_kernel.MODE_LAUNCHES)
    record_sync = c.dispatch["record_sync"]
    lanes = res["trajectory"]["lanes"]
    say("paper_run", n_pages=spec.n_pages, k_hot=scen.k_hot,
        lookups_per_batch=spec.lookups_per_batch, epochs=scen.n_epochs,
        batches_per_epoch=scen.batches_per_epoch, setup_s=setup_s,
        wall_s=wall, epoch_wall_s_mean=wall / scen.n_epochs,
        launches=launches, observe_scatter_modes=os_paper_modes,
        record_sync=record_sync, hint_refresh=c.dispatch["hint_refresh"],
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    say("paper_summary", **res["summary"])
    phase8_json = json.dumps(res, sort_keys=True)     # phase 25's oracle
    if launches != {"observe_scatter": 12, "hist_select": 6,
                    "gather_count": 0, "embedding_bag": 0,
                    "flash_attention": 0}:
        fail(f"kernel launches {launches}, expected 12 and 6")
    if os_paper_modes != {"direct": 0, "hashed": 12}:
        fail(f"observe_scatter's table modes {os_paper_modes}, expected 12 "
             f"hashed")
    if record_sync != 2:
        fail(f"record_sync {record_sync}, expected 2")
    if set(lanes) != set(runtime.ALL_POLICIES):
        fail(f"lanes {sorted(lanes)}")
    for name, recs in lanes.items():
        if len(recs) != scen.n_epochs:
            fail(f"lane {name} has {len(recs)} records")
        for r in recs:
            nums = [v for v in r.values() if isinstance(v, (int, float))]
            if not all(math.isfinite(v) for v in nums):
                fail(f"non-finite record {r}")
            if not (0.0 <= r["accuracy"] <= 1.0
                    and 0.0 <= r["coverage"] <= 1.0
                    and 0 <= r["resident"] <= scen.k_hot and r["time_s"] > 0):
                fail(f"record out of range {r}")
    # the same stream on the CPU (plain versions) must give the same first
    # two epochs: their records depend on epochs 0..2 only (lookahead 1)
    t0 = time.perf_counter()
    head = DLRMScenario(spec=spec, n_epochs=3, batches_per_epoch=2,
                        shift_at=1, k_hot=PAPER_K_HOT)
    cpu = run_scenario(head, hints=build_hints(head), sync_every=1,
                       epochs=epochs[:3], device="cpu")
    cpu_lanes = cpu["trajectory"]["lanes"]
    same = all(cpu_lanes[name][:2] == lanes[name][:2] for name in lanes)
    say("paper_cpu_parity", epochs_compared=2, identical=same,
        seconds=time.perf_counter() - t0)
    if not same:
        fail("paper-scale GPU records differ from the CPU run's")
    # the run above is the first at this size (allocator growth, pinned
    # buffers, sync checks): time the same loop warm, five times, without
    # the sync debug mode.  The process's CPU time beside each wall time
    # tells a slower host (wall up, CPU time flat) from more work (both up).
    warm_wall_s, warm_cpu_s = [], []
    for _ in range(5):
        pipeline = build_hints(scen)
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        run_scenario(scen, hints=pipeline, sync_every=4, epochs=epochs)
        torch.cuda.synchronize()
        warm_wall_s.append(time.perf_counter() - t0)
        warm_cpu_s.append(time.process_time() - c0)
    warm_epoch_s = [w / scen.n_epochs for w in warm_wall_s]
    say("paper_warm", runs=len(warm_wall_s), wall_s=warm_wall_s,
        process_cpu_s=warm_cpu_s, epoch_wall_s=warm_epoch_s,
        epoch_wall_s_mean=sum(warm_epoch_s) / len(warm_epoch_s),
        cold_epoch_wall_s_mean=wall / scen.n_epochs)

    if until < 9:
        fail(f"stopped after phase {until} (--until)")
    # ----------------------- 9. the offline path at the paper's width
    free_device_memory()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    # under cProfile, whose cost is small beside the run's numpy and copies:
    # where the wall goes (host sampling, uploads, the exactness check)
    t0 = time.perf_counter()
    ex, ex_top_own, _ = profiled(lambda: dlrm_tiering.run(datagen.PAPER,
                                                          device=dev))
    ex_wall = time.perf_counter() - t0
    ex_launches = read_counts()
    ex_routes = dict(eb_kernel.ROUTE_LAUNCHES)
    say("offline_example", rows=ex["n_rows"], dim=ex["dim"],
        blocks=ex["n_blocks"], slots=ex["n_slots"], bags=ex["batch"],
        bag=ex["bag"], launches=ex_launches,
        embedding_bag_routes=ex_routes,
        promoted=ex["fast_occupancy"], hit_rate=ex["hit_rate"],
        tiered_vs_dram=ex["tiered_vs_dram"],
        tiered_us=ex["tiered_s"] * 1e6, dram_only_us=ex["dram_only_s"] * 1e6,
        cxl_only_us=ex["cxl_only_s"] * 1e6,
        gathered_equal=ex["gathered_equal"], wall_s=ex_wall,
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        host_top_own_s=ex_top_own)
    if not (ex_launches["embedding_bag"] == 20
            and ex_launches["gather_count"] == 5
            and ex_launches["hist_select"] >= 1
            and ex_launches["observe_scatter"] == 0
            and ex_routes == {"tiled": 20, "per_bag": 0}):
        fail(f"offline example launches {ex_launches}, embedding_bag routes "
             f"{ex_routes}")
    if not ex["gathered_equal"]:
        fail("gathered rows differ from the table's")
    if not (ex["n_slots"] == PAPER_SLOTS
            and ex["fast_occupancy"] == PAPER_SLOTS
            and 0.0 < ex["hit_rate"] < 1.0
            and ex["n_fast"] + ex["n_slow"] == 5 * PAPER_BAGS * PAPER_BAG
            and int(ex["eval_counts"].sum()) == 5 * PAPER_BAGS * PAPER_BAG
            and math.isfinite(ex["tiered_vs_dram"])):
        fail("offline example report out of range")
    del ex
    free_device_memory()

    # --------------------------------------- 10. run_table1 at paper scale
    zero_counts()
    t0 = time.perf_counter()
    t1, t1_top_own, _ = profiled(lambda: tracesim.run_table1(device=dev))
    t1_launches = read_counts()
    hmu, nb, dram = t1["hmu"], t1["nb"], t1["dram-only"]
    say("table1", launches=t1_launches, seconds=time.perf_counter() - t0,
        rows={k: dataclasses.asdict(v) for k, v in t1.items()},
        host_top_own_s=t1_top_own)
    if t1_launches["observe_scatter"] != 40:
        fail(f"run_table1 launches {t1_launches}, expected 40 observe_scatter")
    in_band("run_table1", {
        "1.5 <= hmu.speed_vs_nb <= 2.5": 1.5 <= hmu.speed_vs_nb <= 2.5,
        "hmu / dram-only <= 1.08":
            hmu.avg_inference_us / dram.avg_inference_us <= 1.08,
        "hmu promotes 486,587 pages": hmu.pages_promoted == PAPER_K_HOT,
        "hmu footprint <= 0.11": hmu.top_tier_gb / dram.top_tier_gb <= 0.11,
        "nb 100-160 ms": 100_000 <= nb.avg_inference_us <= 160_000})

    # ----------------------------------------- 11. run_fig3 at paper scale
    zero_counts()
    t0 = time.perf_counter()
    f3, f3_top_own, _ = profiled(lambda: tracesim.run_fig3(device=dev))
    f3_launches = read_counts()
    m3 = f3["methods"]
    say("fig3", launches=f3_launches, seconds=time.perf_counter() - t0,
        pages_for_90pct=f3["hotness"]["pages_for_90pct"],
        overlap_nb_hmu=f3["overlap_nb_hmu"], methods=m3,
        host_top_own_s=f3_top_own)
    if f3_launches["observe_scatter"] != 4 * 64:
        fail(f"run_fig3 launches {f3_launches}, expected 256 observe_scatter")
    in_band("run_fig3", {
        "pebs coverage <= 0.12": m3["pebs"]["coverage"] <= 0.12,
        "pebs accuracy >= 0.70": m3["pebs"]["accuracy"] >= 0.70,
        "2.2 <= hmu/pebs <= 4.0": 2.2 <= m3["hmu"]["speedup_vs_pebs"] <= 4.0,
        "1.4 <= hmu/nb <= 2.3": 1.4 <= m3["hmu"]["speedup_vs_nb"] <= 2.3,
        "0.6 <= overlap <= 1.0": 0.6 <= f3["overlap_nb_hmu"] <= 1.0,
        "pages for 90% = 0.10 +- 0.02":
            abs(f3["hotness"]["pages_for_90pct"] - 0.10) <= 0.02})

    if until < 12:
        fail(f"stopped after phase {until} (--until)")
    # --------------------------------------- 12. kernel times, paper shapes
    os_time = observe_scatter_time(dev, plain, paper_ids)
    os_paper = os_time["draws"]["paper"]
    n = PAPER_PAGES

    rows = selection_rows(dev, epochs[0][0], epochs[1][0])
    ks = (PAPER_K_HOT,)
    hs_ms, hs_plain = in_turns(lambda: kth_key(rows, None, ks, backend=plain),
                               lambda: kth_key(rows, None, ks), 10)
    kth_ms = time_ms(lambda: torch.kthvalue(rows, n - PAPER_K_HOT + 1,
                                            dim=-1), 10)
    topk_ms = time_ms(lambda: torch.topk(rows, PAPER_K_HOT, dim=-1,
                                         sorted=False), 10)
    hs_lib = min(kth_ms, topk_ms)
    lib_t = torch.kthvalue(rows, n - PAPER_K_HOT + 1, dim=-1).values
    top_min = torch.topk(rows, PAPER_K_HOT, dim=-1, sorted=False
                         ).values.min(dim=-1).values
    got_t = kth_key(rows, None, ks)[:, 0]
    if not (torch.equal(lib_t.to(torch.int64) + 2 ** 31, got_t)
            and torch.equal(top_min.to(torch.int64) + 2 ** 31, got_t)):
        fail("hist_select disagrees with torch.kthvalue / torch.topk")
    hs_bound, hs_by = bound_ms(4 * rows.numel(), 4 * rows.numel())

    # gather_count and embedding_bag at the offline path's paper shapes: a
    # float32 storage of 21.8 M x 256 and 2.4 M rows drawn as the example
    # draws them (Zipf pages x 4 + a row within the page).  The bound reads
    # each distinct row once, as the data needs, and counts the counters'
    # read and write.
    say("hist_select_time", rows=list(rows.shape), k=PAPER_K_HOT, ms=hs_ms,
        plain_ms=hs_plain, kthvalue_ms=kth_ms, topk_ms=topk_ms,
        before_ms=BEFORE_MS["hist_select"], bound_ms=hs_bound,
        share_of_bound=hs_bound / hs_ms)
    del rows, lib_t, top_min, got_t
    free_device_memory()
    storage = paper_storage(dev, 3)
    slow = storage[PAPER_SLOTS * PAPER_BLOCK_ROWS:]
    n_logical = PAPER_ROWS // PAPER_BLOCK_ROWS
    n_phys = PAPER_STORAGE_ROWS // PAPER_BLOCK_ROWS
    m_rows = PAPER_BAGS * PAPER_BAG
    row_bytes = PAPER_DIM * 4
    e_idx = paper_lookups(dev)
    g_idx = e_idx.reshape(-1) + PAPER_SLOTS * PAPER_BLOCK_ROWS  # slow region
    distinct = int(torch.unique(e_idx).numel())
    g_counts = torch.zeros(n_phys, dtype=torch.int32, device=dev)
    gc_ms, gc_plain = in_turns(
        lambda: gather_count(storage, g_idx, g_counts,
                             block_rows=PAPER_BLOCK_ROWS, backend=plain),
        lambda: gather_count(storage, g_idx, g_counts,
                             block_rows=PAPER_BLOCK_ROWS), 10)
    g_idx64 = g_idx.to(torch.int64)
    gc_lib = time_ms(lambda: (storage.index_select(0, g_idx64), torch.bincount(
        g_idx64 // PAPER_BLOCK_ROWS, minlength=n_phys)), 10)
    gc_bound, gc_by = bound_ms(
        distinct * row_bytes + 4 * m_rows + m_rows * row_bytes + 8 * n_phys,
        m_rows)

    w = torch.from_numpy(rng.uniform(0.5, 1.5, (PAPER_BAGS, PAPER_BAG))
                         .astype(np.float32)).to(dev)
    e_counts = torch.zeros(n_logical, dtype=torch.int32, device=dev)
    eb_ms, eb_plain = in_turns(
        lambda: embedding_bag(slow, e_idx, e_counts, w,
                              block_rows=PAPER_BLOCK_ROWS, backend=plain),
        lambda: embedding_bag(slow, e_idx, e_counts, w,
                              block_rows=PAPER_BLOCK_ROWS), 10)
    if eb_kernel.route(slow.dtype, PAPER_DIM, PAPER_BAG,
                       slow.data_ptr() % 16 == 0) != "tiled":
        fail("the paper shape does not take embedding_bag's tiled route")
    # the per-bag route (the kernel before the redesign) beside the tiled
    # one, in turns
    eb_tiled_ms, eb_per_bag_ms = in_turns(
        lambda: eb_kernel._launch("per_bag", slow, e_idx, w, e_counts,
                                  block_rows=PAPER_BLOCK_ROWS),
        lambda: embedding_bag(slow, e_idx, e_counts, w,
                              block_rows=PAPER_BLOCK_ROWS), 10)
    e_idx64 = e_idx.to(torch.int64)
    eb_lib = time_ms(lambda: (
        torch.nn.functional.embedding_bag(e_idx64, slow, mode="sum",
                                          per_sample_weights=w),
        torch.bincount(e_idx64.reshape(-1) // PAPER_BLOCK_ROWS,
                       minlength=n_logical)), 10)
    lib_out = torch.nn.functional.embedding_bag(e_idx64, slow, mode="sum",
                                                per_sample_weights=w)
    eb_lib_err = float((lib_out - embedding_bag(
        slow, e_idx, e_counts, w, block_rows=PAPER_BLOCK_ROWS)[0]).abs().max())
    eb_bound, eb_by = bound_ms(
        distinct * row_bytes + 8 * m_rows + PAPER_BAGS * row_bytes
        + 8 * n_logical, 2 * m_rows * PAPER_DIM)
    say("offline_kernel_times", rows=m_rows, distinct_rows=distinct,
        gather_count_ms=gc_ms, gather_count_plain_ms=gc_plain,
        gather_count_library_ms=gc_lib, gather_count_bound_ms=gc_bound,
        embedding_bag_ms=eb_ms, embedding_bag_plain_ms=eb_plain,
        embedding_bag_tiled_ms=eb_tiled_ms,
        embedding_bag_per_bag_ms=eb_per_bag_ms,
        embedding_bag_before_ms=BEFORE_MS["embedding_bag"],
        embedding_bag_library_ms=eb_lib, embedding_bag_bound_ms=eb_bound,
        embedding_bag_vs_library_max_abs_err=eb_lib_err,
        bound_if_every_row_read=bound_ms(
            2 * m_rows * row_bytes + 4 * m_rows, m_rows)[0])
    del storage, slow, lib_out
    free_device_memory()

    # -------------------- where the time goes: the paper run, profiled once
    from torch.profiler import ProfilerActivity, profile
    pipeline = build_hints(scen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_scenario(scen, hints=pipeline, sync_every=4, epochs=epochs)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    kernel_us, op_us = {}, {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        # kernel and copy events carry the device time; op events repeat it
        # as the time of what they launched, so they rank but never add up
        into = kernel_us if ev.device_type == DeviceType.CUDA else op_us
        if us > 0:
            into[ev.key] = into.get(ev.key, 0.0) + us
    busy_s = sum(kernel_us.values()) / 1e6
    # the profiler slows the host, so the idle share is given both over the
    # profiled wall and over the mean unprofiled warm wall of phase 8
    warm_mean = sum(warm_wall_s) / len(warm_wall_s)
    say("profile", wall_s=prof_wall, device_busy_s=busy_s,
        device_idle_share_profiled=1.0 - busy_s / prof_wall,
        device_idle_share_warm=1.0 - busy_s / warm_mean,
        top_op_device_ms=top_ms(op_us, 10, 80),
        top_kernel_ms=top_ms(kernel_us, 10, 80),
        port_kernel_ms={key[:80]: us / 1e3 for key, us in kernel_us.items()
                        if "observe_scatter" in key or "hs_" in key})

    # the host's side of the same run: where the Python process spends it
    pipeline = build_hints(scen)
    torch.cuda.synchronize()
    _, top_own, total_own = profiled(lambda: run_scenario(
        scen, hints=pipeline, sync_every=4, epochs=epochs))
    say("host_profile", total_s=total_own, top_own_s=top_own)

    if until < 13:
        fail(f"stopped after phase {until} (--until)")
    # ------------------------------------ 13. flash_attention vs plain
    t0 = time.perf_counter()
    fa_errs, fa_shares, fa_routes, fa_named = check_flash_attention(dev,
                                                                    plain)
    # each route's worst case; the CUDA-core kernel's from its named runs
    for route in ("tensor_core", "tf32x3"):
        errors["flash_attention_" + route] = max(
            err for label, err in fa_errs.items()
            if fa_routes[label] == route)
    errors["flash_attention_cuda_core"] = max(fa_named.values())
    say("flash_attention", cases=[list(c) for c in FLASH_CASES],
        routes=fa_routes, max_abs_err=fa_errs, share_of_tolerance=fa_shares,
        cuda_core_named_max_abs_err=fa_named, tolerance=FLASH_TOL,
        qkv_scale=FLASH_QKV_SCALE, seconds=time.perf_counter() - t0)

    # --------------------------- 14. the serving path at full width
    serve_launches = serve_full_width(serve_launcher, dev, zero_counts,
                                      read_counts, read_routes)
    profile_decode(dev)

    # ---------------------- 15. full-width prefill + decode, GPU vs CPU
    t0 = time.perf_counter()
    fw_errs, fw_routes = full_width_gpu_vs_cpu(rng, zero_counts, read_routes)
    say("full_width_gpu_vs_cpu", batch=2, prompt_len=64, max_abs_err=fw_errs,
        float32_tolerance=FULL_WIDTH_F32_TOL,
        flash_attention_routes=fw_routes, seconds=time.perf_counter() - t0)

    # ------------------------------- 16. KVCacheScenario, GPU vs CPU
    kv_routes = kv_gpu_vs_cpu(KVCacheScenario, run_scenario, zero_counts,
                              read_counts, read_routes)

    # --------- 17. flash_attention's time at the S=4096 prefill shapes
    fa_times = [flash_attention_time(dev, plain, *shape)
                for shape in FLASH_TIME_SHAPES]
    fa_tc = fa_times[0]
    fa_f32 = flash_attention_time(dev, plain, *FLASH_TIME_SHAPES[0],
                                  dtype="float32")
    fa_row5b = {(d, dt): flash_attention_time(dev, plain, label, b, h, kvh,
                                              d, dtype=dt)
                for label, b, h, kvh, d, dtypes in ROW5B_TIME_SHAPES
                for dt in dtypes}

    if until < 18:
        fail(f"stopped after phase {until} (--until)")
    # ------------------- 18. the fleet example's mix, GPU vs CPU, margins
    fleet_mix_gpu_vs_cpu(dev, zero_counts, read_counts, read_routes)

    # --------------------------- 19. a paper-scale fleet at full width
    seg_time = paper_fleet(dev, plain, spec, DLRMScenario, KVCacheScenario,
                           mmap_bench, zero_counts, read_counts)

    if until < 20:
        fail(f"stopped after phase {until} (--until)")
    # ------------------------------------------- 20. degraded telemetry
    degraded_small_parity(dev, datagen, DLRMScenario, run_scenario,
                          zero_counts, read_counts)
    degraded_example(dev, zero_counts, read_counts)
    keep_time = degraded_paper_run(
        dev, plain, scen, epochs, sum(warm_epoch_s) / len(warm_epoch_s),
        build_hints, zero_counts, read_counts)
    degraded_fleet(dev, zero_counts, read_counts)

    if until < 21:
        fail(f"stopped after phase {until} (--until)")
    # ---------------------- 21. the observability and export planes
    observed_paper_run(dev, scen, epochs, build_hints, run_scenario,
                       zero_counts, read_counts)
    observability_examples(dev, zero_counts, read_counts)
    fleet_export_gpu_vs_cpu(dev, zero_counts, read_counts)

    if until < 22:
        fail(f"stopped after phase {until} (--until)")
    # ------------- 22. the per-lane reference path and the MoE family
    reference_small_parity(dev, datagen, DLRMScenario, run_scenario, runtime,
                           zero_counts, read_counts)
    reference_paper_run(dev, scen, epochs, lanes,
                        sum(warm_epoch_s) / len(warm_epoch_s), build_hints,
                        run_scenario, runtime, zero_counts, read_counts)
    moe_launches = moe_serve_full_width(dev, zero_counts, read_counts,
                                        read_routes)
    moe_routes = moe_scenario_gpu_vs_cpu(dev, run_scenario, zero_counts,
                                         read_counts, read_routes)
    fa_mixtral = flash_attention_time(dev, plain, *MIXTRAL_TIME_SHAPE,
                                      window=MIXTRAL_WINDOW)
    say("moe_flash_attention_routes", mixtral_prefill=moe_launches,
        moe_scenario_forwards=moe_routes)

    if until < 23:
        fail(f"stopped after phase {until} (--until)")
    # ---------------- 23. the recurrent families, RWKV-6 and Zamba2
    recurrent_smoke_gpu_vs_cpu(dev, read_routes)
    zamba2_f32_routes = recurrent_block_full_width(dev, read_routes)
    zamba2_launches = recurrent_serve_full_width(
        serve_launcher, dev, zero_counts, read_counts, read_routes)
    fa_zamba2 = flash_attention_time(dev, plain, *ZAMBA2_TIME_SHAPE)
    fa_kimi = flash_attention_time(dev, plain, *KIMI_TIME_SHAPE)

    if until < 24:
        fail(f"stopped after phase {until} (--until)")
    # ------------------------------------------------------ 24. training
    t24 = time.perf_counter()
    grads24 = train_attention_grads(dev)
    bwd24 = train_attention_time(dev)
    fa_train = flash_attention_time(dev, plain, "qwen2-0.5b train",
                                    *FLASH_TIME_SHAPES[0][1:], s_len=2048)
    full24, rec24, ck24 = train_full_width(
        train_launcher, dev, zero_counts, read_counts, read_routes)
    train_resume(train_launcher, dev, ck24, rec24, full24["losses"],
                 read_counts, read_routes)
    del rec24
    f32_24 = train_gpu_vs_cpu(dev, zero_counts, read_routes)
    train_example(dev, zero_counts, read_routes)
    hs_train = hist_select_train_time(dev, plain)
    say("training", seconds=time.perf_counter() - t24)

    if until < 25:
        fail(f"stopped after phase {until} (--until)")
    # ------------------------------------ 25. sharded state, a 1-rank mesh
    sh25 = sharded_paper_run(dev, plain, scen, epochs, paper_ids,
                             phase8_json, zero_counts, read_counts)

    if until < 26:
        fail(f"stopped after phase {until} (--until)")
    # ------------------------------- 26. the sharded train step, W 1 mesh
    sh26 = sharded_train_step(dev, zero_counts, read_counts, read_routes)

    if until < 27:
        fail(f"stopped after phase {until} (--until)")
    # ----------------- 27. expert parallelism, two gloo ranks on the card
    ep27 = expert_parallel(dev, smi_line)

    if until < 28:
        fail(f"stopped after phase {until} (--until)")
    # ------------------- 28. the dry run, held to a real step on the card
    dry_run(dev, zero_counts, read_counts, read_routes, smi_line)

    if until < 29:
        fail(f"stopped after phase {until} (--until)")
    # ---------- 29. tensor parallelism over "model", two gloo ranks
    tp29 = tensor_parallel(dev, plain, smi_line)

    if until < 30:
        fail(f"stopped after phase {until} (--until)")
    # -------------------------- 30. sharded serving, two gloo ranks
    sv30 = sharded_serving(dev, plain, smi_line)

    if until < 31:
        fail(f"stopped after phase {until} (--until)")
    # ------------- 31. Mixtral's expert tensor parallelism, two gloo ranks
    mx31 = mixtral_expert_tp(dev, plain, smi_line)

    if until < 32:
        fail(f"stopped after phase {until} (--until)")
    # ----- 32. RWKV-6's and Mamba2's mixes on each rank's heads, two ranks
    rc32 = recurrent_tp(dev, plain, smi_line)

    kernels = [
        {"name": "observe_scatter", "route": "cuda",
         "source": "src/repro_torch/kernels/observe_scatter/csrc/"
                   "observe_scatter.cu",
         "replaces": "src/repro/kernels/observe_scatter/kernel.py:34",
         "launches": launches["observe_scatter"],
         "max_abs_err": errors["observe_scatter"], "ms": os_paper["ms"],
         "plain_ms": os_paper["plain_ms"], "bound_ms": os_time["bound_ms"],
         "bound_by": os_time["bound_by"],
         "library_ms": os_paper["bincount_ms"]},
        {"name": "hist_select", "route": "cuda",
         "source": "src/repro_torch/kernels/hist_select/csrc/hist_select.cu",
         "replaces": "src/repro/kernels/hist_select/kernel.py:45",
         "launches": launches["hist_select"],
         "max_abs_err": errors["hist_select"], "ms": hs_ms,
         "plain_ms": hs_plain, "bound_ms": hs_bound, "bound_by": hs_by,
         "library_ms": hs_lib},
        {"name": "gather_count", "route": "cuda",
         "source": "src/repro_torch/kernels/gather_count/csrc/"
                   "gather_count.cu",
         "replaces": "src/repro/kernels/gather_count/kernel.py:34",
         "launches": ex_launches["gather_count"],
         "max_abs_err": errors["gather_count"], "ms": gc_ms,
         "plain_ms": gc_plain, "bound_ms": gc_bound, "bound_by": gc_by,
         "library_ms": gc_lib},
        # the tiled route: all 20 of the offline example's launches (phase
        # 9 checks), its time at the paper shape
        {"name": "embedding_bag", "route": "cuda",
         "source": "src/repro_torch/kernels/embedding_bag/csrc/"
                   "embedding_bag_tiled.cuh",
         "replaces": "src/repro/kernels/embedding_bag/kernel.py:27",
         "launches": ex_launches["embedding_bag"],
         "max_abs_err": errors["embedding_bag"], "ms": eb_ms,
         "plain_ms": eb_plain, "bound_ms": eb_bound, "bound_by": eb_by,
         "library_ms": eb_lib},
        # the tensor-core route: its launches on the serving path (all of
        # them, phase 14 checks), its time at the qwen2-0.5b prefill shape
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_wgmma.cuh",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
         "launches": serve_launches["flash_attention"],
         "max_abs_err": errors["flash_attention_tensor_core"],
         "ms": fa_tc["ms"], "plain_ms": fa_tc["plain_ms"],
         "bound_ms": fa_tc["bound_ms"], "bound_by": fa_tc["bound_by"],
         "library_ms": fa_tc["sdpa_ms"]},
        # the CUDA-core kernel, which no route gives: its launches on the
        # paths that took it before (the KV scenario's prefill, the MoE
        # scenario's forwards, zamba2's float32 block), each checked to be
        # 0; its time at the qwen2-0.5b shape in float32, named through
        # _launch in turns with the TF32 route
        {"name": "flash_attention_cuda_core", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
         "launches": kv_routes["cuda_core"] + moe_routes["cuda_core"]
         + zamba2_f32_routes["cuda_core"],
         "max_abs_err": errors["flash_attention_cuda_core"],
         "ms": fa_f32["cuda_core_ms"], "plain_ms": fa_f32["plain_ms"],
         "bound_ms": fa_f32["cuda_core_bound_ms"],
         "bound_by": fa_f32["cuda_core_bound_by"],
         "library_ms": fa_f32["sdpa_ms"]},
        # the TF32 route (float32 at d 64, 128): its launches in the
        # full-width float32 prefill (phase 15), its time at the same shape
        {"name": "flash_attention_tf32x3", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_tf32x3.cuh",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
         "launches": fw_routes["float32"]["tf32x3"],
         "max_abs_err": errors["flash_attention_tf32x3"],
         "ms": fa_f32["ms"], "plain_ms": fa_f32["plain_ms"],
         "bound_ms": fa_f32["bound_ms"], "bound_by": fa_f32["bound_by"],
         "library_ms": fa_f32["sdpa_ms"]},
        # the tensor-core route at d 16: its launches in the KV scenario's
        # prefill (phase 16, bfloat16, one a layer), its time at qwen2-0.5b's
        # heads at d 16 (phase 17)
        {"name": "flash_attention_d16", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_wgmma.cuh",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
         "launches": kv_routes["tensor_core"],
         "max_abs_err": fa_row5b[(16, "bfloat16")]["max_abs_err"],
         "ms": fa_row5b[(16, "bfloat16")]["ms"],
         "plain_ms": fa_row5b[(16, "bfloat16")]["plain_ms"],
         "bound_ms": fa_row5b[(16, "bfloat16")]["bound_ms"],
         "bound_by": fa_row5b[(16, "bfloat16")]["bound_by"],
         "library_ms": fa_row5b[(16, "bfloat16")]["sdpa_ms"]},
        # the TF32 route at d 80: its launch in zamba2-2.7b's full-width
        # float32 block (phase 23b), its time at zamba2-2.7b's prefill shape
        # in float32 (phase 17)
        {"name": "flash_attention_tf32x3_zamba2", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_tf32x3.cuh",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
         "launches": zamba2_f32_routes["tf32x3"],
         "max_abs_err": fa_row5b[(80, "float32")]["max_abs_err"],
         "ms": fa_row5b[(80, "float32")]["ms"],
         "plain_ms": fa_row5b[(80, "float32")]["plain_ms"],
         "bound_ms": fa_row5b[(80, "float32")]["bound_ms"],
         "bound_by": fa_row5b[(80, "float32")]["bound_by"],
         "library_ms": fa_row5b[(80, "float32")]["sdpa_ms"]},
        # the fleet path: hist_select's launches in phase 19's weighted-fair
        # run (half of them on the segment route, S = 3), and the segment
        # call's time at that fleet's shape beside torch.topk on each
        # segment's slice
        {"name": "hist_select_segments", "route": "cuda",
         "source": "src/repro_torch/kernels/hist_select/csrc/hist_select.cu",
         "replaces": "src/repro/kernels/hist_select/kernel.py:45",
         "launches": seg_time["launches"],
         "max_abs_err": seg_time["max_abs_err"], "ms": seg_time["ms"],
         "plain_ms": seg_time["plain_ms"], "bound_ms": seg_time["bound_ms"],
         "bound_by": seg_time["bound_by"], "library_ms": seg_time["topk_ms"]},
        # the faulty path: observe_scatter with the fault model's keep mask,
        # its launches in phase 20's paper-scale degraded run (all 12 with
        # keep), its time on the online batch with that run's own draw; the
        # library call is two bincounts (accesses, kept samples)
        {"name": "observe_scatter_keep", "route": "cuda",
         "source": "src/repro_torch/kernels/observe_scatter/csrc/"
                   "observe_scatter.cu",
         "replaces": "src/repro/kernels/observe_scatter/kernel.py:34",
         "launches": keep_time["launches"],
         "max_abs_err": keep_time["max_abs_err"], "ms": keep_time["ms"],
         "plain_ms": keep_time["plain_ms"], "bound_ms": keep_time["bound_ms"],
         "bound_by": keep_time["bound_by"],
         "library_ms": keep_time["library_ms"]},
        # the tensor-core route on the MoE serving path: its launches in
        # phase 22c's Mixtral-8x22B prefill (prompt 64, one a layer), its
        # time and error at Mixtral's own prefill shape (S 4096, window
        # 4096) beside sdpa(is_causal=True)
        {"name": "flash_attention_mixtral", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_wgmma.cuh",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
         "launches": moe_launches["flash_attention"],
         "max_abs_err": fa_mixtral["max_abs_err"], "ms": fa_mixtral["ms"],
         "plain_ms": fa_mixtral["plain_ms"],
         "bound_ms": fa_mixtral["bound_ms"],
         "bound_by": fa_mixtral["bound_by"],
         "library_ms": fa_mixtral["sdpa_ms"]},
        # the tensor-core route on zamba2's serving path: its launches in
        # phase 23c's zamba2-2.7b prefill (prompt 64, one a shared-block
        # invocation, bf16 at d 80), its time and error at that model's
        # prefill shape (S 4096) beside sdpa(is_causal=True); the bound is
        # the bf16 products on the tensor cores (the CUDA-core kernel's
        # time in turns and its float32 bound are in the phase's line)
        {"name": "flash_attention_zamba2", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_wgmma.cuh",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
         "launches": zamba2_launches["flash_attention"],
         "max_abs_err": fa_zamba2["max_abs_err"], "ms": fa_zamba2["ms"],
         "plain_ms": fa_zamba2["plain_ms"],
         "bound_ms": fa_zamba2["bound_ms"],
         "bound_by": fa_zamba2["bound_by"],
         "library_ms": fa_zamba2["sdpa_ms"]},
        # the same route at kimi-k2's attention (bf16, d 112, GQA 64 / 8,
        # B 2, S 4096), beside sdpa(is_causal=True): its launches in phase
        # 27a's expert-parallel kimi-k2 prefill at that shape (both ranks,
        # every call, one a call)
        {"name": "flash_attention_kimi_k2", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_wgmma.cuh",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
         "launches": ep27["flash_attention_launches"],
         "max_abs_err": fa_kimi["max_abs_err"], "ms": fa_kimi["ms"],
         "plain_ms": fa_kimi["plain_ms"],
         "bound_ms": fa_kimi["bound_ms"],
         "bound_by": fa_kimi["bound_by"],
         "library_ms": fa_kimi["sdpa_ms"]},
        # the tensor-core route on the training path: its launches in
        # phase 24b's 12 full-width qwen2-0.5b steps (2 a layer and step
        # under remat), its forward's time and error at that training
        # shape (B 4, S 2048) beside sdpa(is_causal=True); the backward's
        # entries follow
        {"name": "flash_attention_train", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_wgmma.cuh",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
         "launches": full24["launches"]["flash_attention"],
         "max_abs_err": grads24["qwen2-0.5b train"]["forward"][0],
         "ms": fa_train["ms"], "plain_ms": fa_train["plain_ms"],
         "bound_ms": fa_train["bound_ms"], "bound_by": fa_train["bound_by"],
         "library_ms": fa_train["sdpa_ms"]},
        # the backward on the tensor cores (bf16 wgmma fed by TMA from the
        # forward's saved lse and float32 output, P and dS split hi / lo):
        # its wrapper calls in phase 24b's 12 steps (one a layer and step)
        # and its kernel launches (two a call), its largest error over dq,
        # dk, dv at qwen2-0.5b's training shape (phase 24a, against
        # autograd of the plain version in float32), its time there in
        # turns with the plain backward and sdpa's backward alone; the
        # reference's backward is XLA's autodiff of flash_train, not a
        # Pallas kernel
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_bwd_wgmma.cuh",
         "replaces": "src/repro/models/attention.py:33",
         "calls": full24["backward_calls"],
         "launches": BWD_KERNELS_A_CALL * full24["backward_calls"],
         "max_abs_err": max(grads24["qwen2-0.5b train"][n][0]
                            for n in ("dq", "dk", "dv")),
         "ms": bwd24["bfloat16"]["ms"],
         "plain_ms": bwd24["bfloat16"]["plain_ms"],
         "bound_ms": bwd24["bfloat16"]["bound_ms"],
         "bound_by": bwd24["bfloat16"]["bound_by"],
         "library_ms": bwd24["bfloat16"]["sdpa_bwd_ms"]},
        # the backward's TF32 route (float32, 3xTF32 mma.sync): its calls
        # and kernel launches in phase 24d's full-width float32 gradient,
        # its error and time at the training shape in float32
        {"name": "flash_attention_bwd_tf32x3", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_bwd.cuh",
         "replaces": "src/repro/models/attention.py:33",
         "calls": f32_24["backward_routes"]["tf32x3"],
         "launches": BWD_KERNELS_A_CALL * f32_24["backward_routes"]["tf32x3"],
         "max_abs_err": max(grads24["qwen2-0.5b train f32"][n][0]
                            for n in ("dq", "dk", "dv")),
         "ms": bwd24["float32"]["ms"],
         "plain_ms": bwd24["float32"]["plain_ms"],
         "bound_ms": bwd24["float32"]["bound_ms"],
         "bound_by": bwd24["float32"]["bound_by"],
         "library_ms": bwd24["float32"]["sdpa_bwd_ms"]},
        # the sharded path: observe_scatter's launches in phase 25's
        # paper run over a 1-rank mesh, the ranged call's error (lo > 0
        # cases against the plain version and the whole histogram) and the
        # W 1 call's time on the online batch (phase 25's line has it in
        # turns with the unranged call, and a 2-rank split's half)
        {"name": "observe_scatter_sharded", "route": "cuda",
         "source": "src/repro_torch/kernels/observe_scatter/csrc/"
                   "observe_scatter.cu",
         "replaces": "src/repro/kernels/observe_scatter/kernel.py:34",
         "launches": sh25["launches"]["observe_scatter"],
         "max_abs_err": sh25["ranged_observe_scatter"]["max_abs_err"],
         "ms": sh25["ranged_observe_scatter"]["w1_ms"],
         "plain_ms": sh25["ranged_observe_scatter"]["w1_plain_ms"],
         "bound_ms": sh25["ranged_observe_scatter"]["w1_bound_ms"],
         "bound_by": sh25["ranged_observe_scatter"]["w1_bound_by"],
         "library_ms": sh25["ranged_observe_scatter"]["bincount_ms"]},
        # the tensor-core route on the sharded training path: its launches
        # in phase 26's sharded steps (2 a layer and step under remat), its
        # forward's time and error at that shape (phase 24's, the same
        # B 4, S 2048 attention)
        {"name": "flash_attention_sharded_train", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_wgmma.cuh",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
         "launches": sh26["launches"]["flash_attention"],
         "max_abs_err": grads24["qwen2-0.5b train"]["forward"][0],
         "ms": fa_train["ms"], "plain_ms": fa_train["plain_ms"],
         "bound_ms": fa_train["bound_ms"], "bound_by": fa_train["bound_by"],
         "library_ms": fa_train["sdpa_ms"]},
        # hist_select on the training path: its launch at phase 24b's step
        # 10 rebalance, its time on that rebalance's shape (18,992 blocks,
        # k 1,899) beside torch.topk
        {"name": "hist_select_train", "route": "cuda",
         "source": "src/repro_torch/kernels/hist_select/csrc/hist_select.cu",
         "replaces": "src/repro/kernels/hist_select/kernel.py:45",
         "launches": full24["launches"]["hist_select"],
         "max_abs_err": hs_train["max_abs_err"], "ms": hs_train["ms"],
         "plain_ms": hs_train["plain_ms"], "bound_ms": hs_train["bound_ms"],
         "bound_by": hs_train["bound_by"], "library_ms": hs_train["topk_ms"]},
        # the tensor-core route on the tensor-parallel training path: its
        # launches on both ranks in phase 29b's bf16 steps (2 a layer and
        # step under remat, at a rank's 7 / 1 heads), its error and time at
        # that shape (B 4, H 7, KVH 1, S 2048, d 64)
        {"name": "flash_attention_tp_train", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_wgmma.cuh",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
         "launches": tp29["launches"],
         "max_abs_err": tp29["forward"]["max_abs_err"],
         "ms": tp29["forward"]["ms"], "plain_ms": tp29["forward"]["plain_ms"],
         "bound_ms": tp29["forward"]["bound_ms"],
         "bound_by": tp29["forward"]["bound_by"],
         "library_ms": tp29["forward"]["sdpa_ms"]},
        # its backward there: the calls and kernel launches of phase 29b
        # on both ranks, its time at a rank's shape beside the plain
        # backward's and sdpa's backward (the error: 29a's float32 step
        # holds the gradient; at this shape the kernels' bf16 dq against
        # the plain version's)
        {"name": "flash_attention_bwd_tp_train", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_bwd_wgmma.cuh",
         "replaces": "src/repro/models/attention.py:33",
         "calls": tp29["backward_calls"],
         "launches": BWD_KERNELS_A_CALL * tp29["backward_calls"],
         "max_abs_err": tp29["backward"]["max_abs_err"],
         "ms": tp29["backward"]["ms"],
         "plain_ms": tp29["backward"]["plain_ms"],
         "bound_ms": tp29["backward"]["bound_ms"],
         "bound_by": tp29["backward"]["bound_by"],
         "library_ms": tp29["backward"]["sdpa_bwd_ms"]},
        # the tensor-core route on the sharded serving path: its launches
        # on both ranks in phase 30c's bf16 prefill (one a layer at a
        # rank's 7 / 1 heads; none in decode), its error and time at that
        # shape (B 4, H 7, KVH 1, S 4096, d 64)
        {"name": "flash_attention_tp_serve", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_wgmma.cuh",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
         "launches": sv30["launches"],
         "max_abs_err": sv30["forward"]["max_abs_err"],
         "ms": sv30["forward"]["ms"], "plain_ms": sv30["forward"]["plain_ms"],
         "bound_ms": sv30["forward"]["bound_ms"],
         "bound_by": sv30["forward"]["bound_by"],
         "library_ms": sv30["forward"]["sdpa_ms"]},
        # the tensor-core route on Mixtral's expert-tensor-parallel serving
        # path: its launches on both ranks in phase 31c's bf16 prefill (one
        # a layer at a rank's 24 / 4 heads; none in decode), its error and
        # time at that shape (B 4, H 24, KVH 4, S 4096, d 128, window 4096)
        {"name": "flash_attention_mixtral_tp", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_wgmma.cuh",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
         "launches": mx31["launches"],
         "max_abs_err": mx31["forward"]["max_abs_err"],
         "ms": mx31["forward"]["ms"], "plain_ms": mx31["forward"]["plain_ms"],
         "bound_ms": mx31["forward"]["bound_ms"],
         "bound_by": mx31["forward"]["bound_by"],
         "library_ms": mx31["forward"]["sdpa_ms"]},
        # the tensor-core route on zamba2's tensor-parallel serving path:
        # its launches on both ranks in phase 32c's bf16 prefill (one a
        # shared-block invocation at a rank's 16 / 16 heads, beside the
        # Mamba2 layers on the rank's 40 of 80 heads; none in decode), its
        # error and time at that shape (B 4, H 16, KVH 16, S 4096, d 80)
        {"name": "flash_attention_zamba2_tp", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_wgmma.cuh",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:27",
         "launches": rc32["launches"],
         "max_abs_err": rc32["forward"]["max_abs_err"],
         "ms": rc32["forward"]["ms"], "plain_ms": rc32["forward"]["plain_ms"],
         "bound_ms": rc32["forward"]["bound_ms"],
         "bound_by": rc32["forward"]["bound_by"],
         "library_ms": rc32["forward"]["sdpa_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    # --until N stops after phase N (a short first check of a new kernel);
    # it fails by design, since the result lines are never reached
    args = sys.argv[1:]
    main(int(args[1]) if args[:1] == ["--until"] else 32)
