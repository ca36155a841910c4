"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py            # phases 1-18, one card (14, 15 run after 6; 10 to 13 before 9)
    python3 chip_smoke.py --chips 4  # phases 1, 2, 9, 11, 12d, 13's grid parts, 16-18; four cards

Phases (any failed check raises, so the script exits non-zero):

  1. Card: name and power limit (nvidia-smi), torch / CUDA versions.
  2. Build: the Hopper kernels in src/repro_torch/csrc/, compiled with nvcc
     for sm_90a, one nvcc per source, all started together.
  3. Main path, through the user's entry points (scatter_to_grid ->
     batched_summa3d), with every kernel launch count set to 0 just before
     each run and read just after it:
       a. full size, memory-constrained, hash path: C = A·A for a
          protein-similarity-like A with n = 2^20 (the repo's
          spgemm_eukarya_like size), a budget that forces b >= 1024 batches;
          the fused hash kernel must launch exactly once per batch and the
          one-chunk kernel never;
       b. the same product on the ESC path, same budget (the segment-reduce
          kernel sums every batch);
       c. the default path: n = 2^14, budget 48 B x nnz(A), local_path
          "auto", which plans the k-binned multiply with b = 16; run a
          second time, which must give the same bits.
     Each product is checked against scipy's A @ A on the host: identical
     structure, values within rtol 1e-4 (fp32 sums in another order).
  4. Each kernel against its plain PyTorch version on the card, on the
     operands of batch 0 of the run above that uses it: the one-chunk hash
     insert on batch 0's chunks and the fused hash kernel on the whole
     batch, each for sum/min/max in a table that fits (same key set, sums
     within rtol 1e-5 since atomics add in a run-dependent order, min/max
     exact, no drops) and in one that is far too small (both drop); the
     hash run's per-batch split of wall and device time; the binned
     multiply bit-identical to its plain version run on the CPU (both add
     in bin, A slot, B slot order) and to a second call; the segment
     reduction on the ESC run's batch 0 sum (rtol 1e-5, bit-identical
     between calls), beside torch.segment_reduce and the scatter_reduce_
     it replaced; and the ESC multiply of that batch run twice, which must
     give the same bits. A kernel's time is the
     device time of its wrapper per call (every kernel and memset the
     wrapper puts on the card, from torch.profiler); it raises if the
     profiler records none in 5 profiled runs of a rep. A library call's time (the yardstick) is its
     device time, measured the same way; plain times are CUDA-event times.
     A kernel's bound counts the bytes its wrapper must move on this run's
     data (inputs read once, outputs written once) against the card's
     memory rate, or its f32 operations against the f32 peak.
  5. The kernel API (kernels.ops), through its wrappers, on the binned
     kernel's operands of 4 (batch 0 of the n = 2^14 default product:
     A's tile against a 1024-column block of B), with every launch count
     set to 0 just before and read just after: spgemm_paired, the same
     product by spgemm_paired_binned (the run's bin plan) and by
     spmm(densify(B)), and sort_pairs on the packed keys and values of
     batch 0's first partial products at 2^14 pairs (the bitonic kernel),
     12345 (padded, the bitonic kernel) and 2^14 + 8 (routed to a stable
     torch.sort). The paired kernel must agree with its plain version and
     both counterparts within rtol 1e-5 / atol 1e-6; the sorted keys must
     equal torch.sort's, the values be bit-identical to the plain network
     on the same padding (to a stable torch.sort + gather when routed),
     and per-key value sums equal torch.sort + gather's. Both kernels timed
     as in 4, beside torch.sparse.mm and torch.sort + gather as
     yardsticks; the bitonic kernel also on one block of 2048 pairs (no
     cluster).
  6. The three dense-path kernels against their plain versions on batch 0
     of the dense MCL run's second multiply (the run of 8): col_prune
     bit-identical in one launch (the log says how many reads of x it
     makes), SpMM within rtol 1e-5 in f32 and with bf16 values and
     B (both sum in f32), bit-identical between calls, densify within rtol
     1e-6 (atomic sums of duplicates), each timed as in 4, beside one
     PyTorch call that computes the same function (torch.topk,
     torch.sparse.mm, index_put_), timed only as a yardstick. Then SpMM's
     accumulate mode (the Cannon ring's stages, phase 11a) against its
     plain version at the 2x2x1 ring's second stage on the n = 2^15 input
     (rtol 1e-5, bit-identical between calls), timed as in 4 beside
     addmm_ with A in CSR; timed here, as the other kernels are, because
     the profiler has recorded no device event at all late in the run.
  7. Markov clustering (sparse_apps.mcl.mcl_iterate), sparse path, n = 2^18:
     a column-stochastic protein-similarity-like input (64-node clusters),
     inflation 2, threshold 1e-4, top-64 per column, 4 iterations under a
     2 GiB per-process budget. First one batch of the second iteration
     (the multiply step and the prune): every segment-reduce input it
     makes held against the plain version (rtol 1e-5, bit-identical
     between calls; the log counts each input's runs by the kernel's
     path), then a profile (top ops by device time, and each
     segment-reduce launch: runs, entries, device time, bound). Then the
     loop, twice (both trajectories printed, and whether they are
     bit-identical), then its first iteration held against the host
     loop's (mcl_iterate_host: the same card multiply, pruning in numpy;
     1 of the 4 iterations, to keep the script within its limit): nnz
     trajectories equal within 1e-5
     per iteration (every difference printed: f32 sums in another order can
     move an entry across the threshold), chaos within rtol 1e-3, identical
     cluster partitions, at most 64 entries per column with column sums
     1 +- 1e-4, and under 1 KiB of host traffic per device-loop iteration.
  8. Markov clustering, dense path (densify + SpMM + col_prune), n = 2^14,
     4 forced batches of 16384 x 4096 f32 tiles, 6 iterations, held against
     the sparse device loop and the host loop: nnz trajectories as in 7,
     identical partitions; the col_prune, SpMM and densify kernels must
     launch. The dense loop, the sparse loop on its default (binned)
     multiply and the sparse loop on the ESC multiply each run twice and
     must repeat their results bit for bit.
  9. The multi-process grid: four ranks (repro_torch.launch.spawn), one per
     point of a 2x2x1 grid, which also build a 1x1x4 grid in the same
     process group. With no arguments all four share this card over gloo,
     with CUDA tensors, at n = 2^18; with --chips 4 each has its own card
     and they talk over NCCL, at n = 2^20. On each shape, under one
     per-process budget (64 MiB at n = 2^18, scaled with n): C = A·A on the
     ESC path twice and on the hash path once (at least as many batches as
     its i32 keys need), every rank's tile held against scipy's A @ A on
     its rows and columns, the second ESC run against the first bit for
     bit; every rank must plan the same batches, the fused hash kernel
     launch once a batch and the segment reduction at least once a batch
     on every rank. Logs per rank and shape the wall, how often a batch
     was consumed and b, and, on rank 0's profiled second ESC run, the
     device time and the NCCL kernels' share of it. On each shape every
     rank also runs triangle_count of the R-MAT graph of 10 (scale 16 over
     gloo, 18 over NCCL; at least 4 batches and as many as the i32 mask
     keys need): every rank must plan the same masked batches and count
     what rank 0 counted first on a 1x1x1 grid of its own card, the hash
     kernel launching once a batch. With --chips 4 the
     sparse n = 2^18 MCL device loop then runs on the 2x2x1 grid, held
     against the same loop on one card (rank 0, first) as in 7: nnz within
     NNZ_RTOL, chaos within CHAOS_RTOL, identical partitions. Then phase
     13's grid part: 13a's mix of 6 requests (3 repeats of A0·A0, one
     novel product of n/2, a min_plus product, one refusal) on the ESC
     engine, at n = 2^16 over gloo on 2x2x1 and 1x1x4 (with --chips 4 at
     n = 2^18 over NCCL on 2x2x1), every rank's stats, results and cache
     keys equal and every C (the whole product, on every rank) against
     scipy; and over gloo mcl_iterate_host (phase 8's sparse n = 2^14
     loop) on 2x2x1 against the same loop on one card (rank 0, first):
     nnz within NNZ_RTOL, identical partitions. A rank that fails fails
     the run.
 10. The masked multiply (paper §V-B) on one card, each run with every
     launch count set to 0 just before and read just after; runs before 9.
       a. triangle_count (sparse_apps.graph_algorithms) of the symmetrized
          R-MAT graph of scale 18 (16 edges a vertex, seed 5: 3805033
          entries in L, 5.78e9 wedges), under the budget at which its masked
          plan has at least 64 batches (its (tm, wb) mask keys must pack
          into i32), held to the exact count scipy gives as
          Σ_r ((L[r] @ U) ⊙ L[r]).sum() over row blocks of L (in a pool of
          worker processes); logs b, the local path "auto" chose, the wall,
          the per-batch peak against plan_footprint and the host traffic,
          which must stay at the mask's count vector plus one scalar a
          batch. At the reference's probe budget the masked ESC plan must
          have fewer batches and smaller D and C capacities than the
          unmasked one.
       b. the masked L·U at scale 16 through batched_summa3d(spec=
          PlanSpec(mask=M, local_path=p)), _batch_value_sum as postprocess,
          for p = esc (twice: bit for bit) and hash (one fused launch a
          batch), at least 16 batches, no retry: both give scipy's count;
          each plan beside the unmasked plan under the same budget; a
          profile of batch 0's masked step on each path.
       d. the masked fused hash kernel against its plain version on batch 0
          of b's hash run: strict for sum/min/max in the planned table and
          complement for sum (same key set, sums within rtol 1e-5, min/max
          exact, no drops), then timed beside the unmasked kernel on the
          same batch (CUDA events), with its bound (the mask keys read
          once).
       c. overlap_pairs of kmer_like(2^18, 2^23, 64, seed 17) with
          min_shared 2, without candidates (at least 128 batches) and with
          a candidate mask of the true pairs plus as many random ones (at
          least 64 batches: i32 mask keys), both equal to scipy's A·Aᵀ
          filtered to i < j and shared >= 2.

 11. The SUMMA3D steps outside the fused step, placement and the tuner;
     runs after 10, its grid parts inside 9's ranks. Every run with the
     launch counts of the kernels it reaches set to 0 just before and read
     just after.
       a. summa3d_dense_step at n = 2^15, "allgather" and "ring" (Cannon:
          skew, then per stage SpMM into one D tile, SpMM's accumulate
          mode after the first stage, and a unit Grid.ppermute of each
          operand), on this card (b = 1) and on 9's four gloo ranks
          (2x2x1 b = 1, 1x1x4 b = 4); with --chips 4 on 2x2x1 at n = 2^16
          over NCCL. Each tile against scipy's A @ A (same nonzeros, rtol
          1e-4) and the ring's against allgather's (rtol 1e-5: the
          stages add in another order); densify and SpMM launch once a
          stage (pc times on the ring). Logs each schedule's wall and the
          step's peak memory above what was allocated before it, per rank.
          summa3d_sparse_step on the n = 2^18 MCL input with the caps of
          each path's b = 1 plan: ESC on the whole of B, hash on batch 0
          of 64 (its packed keys must fit in i32), against scipy.
       b. placement.multiply_placed of the masked L·U of the R-MAT graph
          of scale 16 with "identity", "degree" and "rcm" on the hash
          path, all at one budget: the largest of the strategies' own
          budgets for b >= 16 (a strategy whose inputs exceed the identity
          plan's b >= 16 budget is logged as refused there), on this card
          and on 9's 2x2x1 ranks: every strategy's triplets
          equal the identity run's exactly and sum to 10b's scipy count;
          logs b, sel_cap, piece_cap, d_cap, padded_comm_volume and wall.
       c. autotune for 1 device on 3c's n = 2^14 input and budget; the
          tuned configuration run on the card against scipy, its predicted
          ms beside the measured; fit_overhead over the raw predicted and
          measured ms of 3's three runs and this one, beside the card's
          name. The n = 2^20 tunes (1 and 4 devices, 3's budget) run in a
          worker process from the end of phase 3 on and are logged with
          their host time; one that picks binned is not run (ROADMAP §3.1). With
          --chips 4 the 4-device pick runs on its own grid, one rank per
          card over NCCL, when its path is ESC or hash (hash: at least the
          i32 key floor of batches), against scipy.

 12. Durability, on one card; runs after 11. Checkpoints go to a temporary
     directory removed at the end; every run logs its checkpoint_bytes,
     checkpoint_stall_s, restarts and refused_restores, with the kernel
     counts set to 0 just before it and read just after.
       a. phase 7's sparse MCL loop (n = 2^18) through
          mcl_iterate_resilient, a checkpoint every iteration, step 2's
          arrays.npz truncated and a preemption at batch 5 of iteration 2:
          one restart, step 2 refused, the restore from step 1; then the
          trajectory, the final matrix and every iteration's b, caps and
          local path equal phase 7's device loop bit for bit, the segment
          reduction launching on every batch; wall and peak beside 7's.
       b. a child process runs phase 8's sparse n = 2^14 loop on its
          default (binned) multiply through mcl_iterate_resilient, held in
          iteration 3 by an injected 60 s straggle; once step 3 is stored it
          is SIGKILLed, and a second child resumes from step 3 and must end
          on phase 8's binned loop bit for bit, the binned kernel
          launching. The children load the kernels of phase 2 (they raise
          rather than build one).
       c. APSP (sparse_apps.graph_algorithms) on a weighted random digraph
          (8 out-edges a vertex, weights in [1, 10), seed 11), every run
          under a 2 GiB budget: n = 2^11 on the hash path against scipy's
          Dijkstra (the same reachable pairs, distances within rtol 1e-5;
          one fused hash launch a batch), the plans apsp_iterate's "auto"
          (the ESC budget) and the planner's own "auto" make on its
          fixpoint, and apsp_iterate_resilient preempted at iteration 3,
          bit-identical to the uninterrupted run; n = 2^10 on ESC (one
          batch's min segment reduction held exactly against its plain
          version first) and on hash, bit-identical to each other and
          equal to scipy.
       d. (--chips 4 only) after 9's 2x2x1 MCL loop at n = 2^18 over NCCL,
          the same loop through mcl_iterate_resilient, preempted at batch 3
          of iteration 2: every rank resumes from the same step and ends
          bit-identical to 9's loop; the checkpoint holds (2, 2, 1, cap)
          tiles (rank 0 writes).

 13. Serving (serve.SpgemmEngine) on one card; runs after 12. Each
     engine's launch counts are set to 0 just before its run and read just
     after; all requests of a stream are submitted at once, and the
     expected plan-cache hits come from matrix_signature on the host
     before the run. scipy's products are computed in a pool of worker
     processes while the card works.
       a. the ESC engine at n = 2^18 on A0, phase 7's MCL input before
          normalization: the budget is 2.5 times the engine's price of
          A0·A0 at the b the plan has at the least budget for b >= 4
          (budget_for_batches), with that b as the seed floor of every
          first plan, so two A0·A0 fit at once and three do not. 16
          requests: 8 repeats of A0·A0, 6 novel products (n = 2^16 and
          2^17, seeds 1-6), a min_plus A0 ⊗ A0, and one request priced on
          the host to exceed the budget with its inputs alone (a
          block-diagonal operand of dense blocks, the least block size that
          does), which must be refused with no dispatch. At least one
          deferral, exactly one refusal, the expected hits.
       b. the hash engine on the same budget, seed floor b = 64 (the least
          b whose packed keys fit i32): 4 repeats of A0·A0, 2 novel products
          and 2 masked triangle-count products L·U ⊙ L of phase 10b's R-MAT
          graph (mask_id "tri16"), whose C sums to phase 10's count. The
          fused hash kernel launches once a batch dispatch (retries
          included), the one-chunk kernel never.
       c. the reference's default ServeConfig ("auto") at n = 2^14 with
          phase 3c's budget: 4 repeats and 4 novel products (seeds 1-4);
          the binned kernel launches once a k-binned batch dispatch.
     Every plus_times C against scipy on the card (structure identical,
     values within 1e-4), the min_plus C bit for bit against
     batched_summa3d on the same operands and path, repeats on ESC and
     k-binned bit-identical, a cache hit dispatched at its miss's static
     signature (num_batches, caps, sel_cap, kbin caps, hash caps,
     mask_cap, A.cap, B.cap). Logs each request's b, price, retries and
     latency; latency p50/p99, requests/s and partial products/s; hit
     against miss latency; the peak device memory against the budget and
     the most admitted at once.

 14. The LM serving path (repro_torch.models, configs, serve.ServeEngine) on
     one card; runs after 6, before 7. Every run with the SpMM kernel's
     count set to 0 just before and read just after; matrix products in
     full f32 where the model is f32 (TF32 off).
       a. every SMOKE architecture of the registry, f32, the port's seeded
          init: forward's last position against prefill of the first 7
          positions and one decode within rtol = atol = 2e-3 (the JAX
          package's own check; B = 1 keeps the MoE under one capacity block,
          so nothing is dropped), and for the two MoE models forward with
          "spgemm" dispatch against "scatter" within 1e-4. SpMM launches
          exactly 2 a MoE layer a model call in "spgemm" mode; "scatter"
          none.
       b. OLMoE-1B-7B at its published width and depth (16 layers, d_model
          2048, 64 experts top-8, vocab 50304; 6.92e9 parameters) in bf16,
          seeded random weights on the card: EngineConfig(max_batch=8,
          s_max=1024), 16 requests of seeded prompts of 64-512 tokens and
          32 new tokens each, run twice: every request gets 32 in-range
          tokens, the two runs the same tokens, SpMM exactly 2 x 16 x (16
          prefills + ticks) launches. Logs each run's wall, prefill
          tokens/s and ms per decode-only tick (run 1 is the warm-up), the
          peak memory, and a profile of one decode tick of run 2 (top ops by
          device time, SpMM's share, the idle share against its own host
          time).
       c. the SpMM kernel on layer 0's MoE operands (dispatch and combine)
          of a prefill of T = 512 tokens (A 5632 x 512, 4096 entries) and of
          a decode tick of the 8 slots (A 512 x 8, 64 entries) against its
          plain version within rtol 1e-5, with bf16 values and B and in f32
          (both sum in f32), bit-identical between calls, timed as in 4
          beside torch.sparse.mm, with its bound.
       d. OLMoE at full width in f32, cut to 2 layers: as a.
 15. Training (repro_torch.optim, data, train, runtime.run_training,
     runtime.hierarchical, launch.train) on one card; runs after 14. The
     MoE's dispatch and combine go through the differentiable SpMM
     (kernels.spmm_kernel.SpmmFunction): the kernel forward, in the remat
     recompute, and for dB = Aᵀ·G in the backward; dvals is plain PyTorch.
       a. every MoE SMOKE architecture, f32, seeded: one step's gradients
          through the kernel (remat off, so the SpMM operands are this
          run's tensors: 4 launches a layer) against the same step with
          the plain SpMM forced on the card (dX, dY, dvals, the router's
          and the experts' weights) within rtol 1e-4 / atol 1e-6;
          run_training (remat on) with a failure injected at step 5
          (checkpoints every 3 steps) ends at step 8 with one restart and
          the uninterrupted run's losses; CrossClusterDP with 2 clusters
          for 4 steps: each step's summed gradient, for every parameter,
          the mean of what the clusters sent (gradient plus residual
          before minus residual after) bit for bit, wire_bytes the
          reference's formula, the replicas bit-identical; then
          ``python -m repro_torch.launch.train --arch olmoe-1b-7b --smoke``
          (in this process) takes 3 steps. Each run's SpMM count set to 0
          just before it and read just after: 6 a layer a step with remat
          (2 forward, 2 recompute, 2 dB).
       b. OLMoE-1B-7B at its published width, depth cut to 4 of 16 layers
          (f32 masters, grads and AdamW's two moments are 16 B a
          parameter: 103.1 GiB at 16 layers, 28.08 GiB at 4), bf16
          compute, remat on, AdamW lr 1e-3 warmup 2, batch 8 x 2048 tokens
          from the port's Prefetcher: 2 warm-up and 8 timed steps through
          build_train_step, then one profiled step. Every loss finite, the
          mean of the last 3 below the mean of the first 3, SpMM 24
          launches a step (4 layers x (2 + 2 + 2)). Logs tokens/s, ms a
          step, the peak memory, the profiled step's top ops and the SpMM's
          share. Then layer 0's dispatch and combine at T = 16384, forward
          and their dB (the swapped entries, G seeded), through the 14c
          check (kernel vs plain, bit-identical repeats, device time,
          bound, torch.sparse.mm), and dvals' plain time with its bound.

 16. LM serving on a process mesh (repro_torch.launch.mesh,
     ServeEngine(..., mesh=)); runs after 9. OLMoE-1B-7B at its published
     width in bf16, 8 of its 16 layers (--chips 4: all 16), seeded, on a
     2x2 ("data" x "model") mesh: four ranks sharing this card over gloo
     (--chips 4: one a card over NCCL), each drawing every leaf whole and
     keeping its slice (half the experts, heads, hidden and vocab).
     EngineConfig(max_batch=8, s_max=512), 8 requests of seeded prompts of
     64-256 tokens, 16 new tokens each, run twice: every rank and both runs
     the same tokens, SpMM exactly 2 x layers x (prefills + ticks)
     launches a rank a run (each
     count set to 0 just before the run). Then through the step builders
     a prefill of 4 x 64 tokens and one decode, held against one card in
     bf16 within atol 0.125: the prefill against the one-card model with
     each MoE layer applied to the mesh's shards (what "a2a" computes),
     the decode against a one-card decode from the mesh's own cache
     (assembled from the ranks' slices), each data shard's slots routed
     alone ("dense_ep"). Logs each rank's peak memory, decode-only tick
     times and run 2's share of time inside collectives.
 17. Training on a process mesh (train.build_train_step(..., mesh=),
     ZeRO-1 AdamW); runs after 16. OLMoE-1B-7B at its published width, 2
     of 16 layers (--chips 4: 4), f32 masters, bf16 compute, remat, on a
     2x2 ("data" x "model") mesh: four gloo ranks sharing this card
     (--chips 4: one a card over NCCL), each drawing every leaf whole and
     keeping its slice, its ZeRO-1 AdamW state the slices the specs give
     (checked). 3 steps on the port's data stream, global batch 4 x 512
     (--chips 4: 8 x 2048): every rank the same finite losses, SpMM
     exactly 6 launches a MoE layer a step on every rank (each count set
     to 0 just before the step). Before the run, a checked step in f32
     compute from the seeded init is held against one step on one card
     from the same init and batch, each MoE layer applied to the mesh's
     shards: loss within rtol 1e-4, the gradient norm within rtol 1e-3,
     the updated parameters within AdamW's first-step sign bound (see
     TRAIN_MESH_*). Logs each rank's init, peak memory, step times and the
     last step's share inside collectives.
 18. The ssm and hybrid families on a process mesh; runs after 17, on the
     same 2x2 mesh of four gloo ranks (--chips 4: one a card over NCCL),
     through phases 16's and 17's code with their own settings (SSM_*):
     18a serves Zamba2-2.7B at its published width in bf16, seeded (the
     Mamba2 blocks tensor parallel, the shared attention block on TP
     attention and MLP), 4 requests of 64-256 tokens (seed 18), 8 new
     tokens each, twice, with the one-card check of a 4 x 64 prefill and
     a decode; 18b trains Mamba2-370M at its published width (f32
     masters, bf16, remat, ZeRO-1 AdamW), 3 steps of batch 4 x 512 after
     the f32 step checked against one card. No kernel of the port
     launches there (the SSD scan is plain PyTorch, as the reference's is
     jnp): the SpMM counts stay 0. Logs each rank's peak memory, tick or
     step times, the share inside collectives and the collectives of a
     model call, and the phase's seconds beside the card's name and power
     limit.

The last two lines are a JSON object with one entry per kernel (the seven
that replace the TPU kernels, the hash row per batch, and the segment
reduction, whose row also holds its launches, device time and bound in
phase 7's profiled batch; those two rows also hold each rank's launches in
phase 9, and the hash row the masked kernel's numbers from 10; densify,
SpMM, hash and segment rows also hold their launches in 11, the hash,
segment and binned rows their launches in 12 and in 13, the segment row
its launches per rank in 9's serving, and the SpMM row its accumulate
mode's check, phase 14's MoE launches and timings, and phase 15's training
launches, forward and backward, and timings, and phases 16's and 17's
launches per rank; phase 18 launches none) and the JSON result line; with --chips 4 only
the result line.
Without a CUDA device (or the four cards --chips 4 asks for), or without
the repository's src/ beside this file, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import contextlib
import json
import logging
import multiprocessing
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, f32 outside the
# tensor cores. A card set below 700 W runs slower under load.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

N_FULL = 1 << 20
N_DEFAULT = 1 << 14
N_MCL = 1 << 18
VALUE_RTOL = 1e-4  # vs scipy: fp32 sums in another order
KERNEL_RTOL = 1e-5  # kernel vs plain: sums in another order (hash and paired atomics, SpMM)
DENSIFY_RTOL = 1e-6  # atomic sums of a few duplicates, in a run-dependent order
CHAOS_RTOL = 1e-3  # device loop (f32) vs host loop (f64 pruning), as the JAX tests allow
MCL_BUDGET = 2 << 30  # per-process bytes: iteration 2 of the n = 2^18 run plans b >= 4
# MCL loops that sum in another order (SpMM rows, binned vs ESC runs; f32
# device pruning vs f64 host pruning) can move an entry across the 1e-4
# threshold: their nnz may differ by this share per iteration, never more
NNZ_RTOL = 1e-5
PROFILE_MARGIN_S = 0.02  # idle time around a profiled window (see device_ms)
PROFILE_ATTEMPTS = 5  # profiled runs of one rep before a window without device events fails
SORT_CALLS = 20  # bitonic sorts per profiled window: one is ~tens of microseconds
N_GRID = 1 << 18  # the four-rank phase on one card
GRID_SHAPES = ((2, 2, 1), (1, 1, 4))  # the reference refuses 2x1x2 (pr == pc or l == 1)
# per-process bytes at n = N_GRID, scaled with n; the same on both shapes:
# b = 32 on 2x2x1 (its diagonal tiles hold twice 1x1x4's) and 8 on 1x1x4
GRID_BUDGET = 64 << 20
GRID_TIMEOUT_S = 600  # one spawn of the distributed phase, every collective included
TRI_SCALE = 18  # triangle_count in phase 10a and on four cards: R-MAT n = 2^18, 16 edges a vertex
# the pinned ESC and hash runs of 10b and the gloo grid's triangle count: the ESC
# path expands its whole unmasked flops capacity every batch (as the reference
# does), which at scale 18 and b >= 64 (i32 keys) is 64 x 4.9e8 slots, minutes a run
TRI_PINNED_SCALE = 16
PINNED_LEAST_B = 16  # 10b plans at least this many batches
GRID_TRI_LEAST_B = 4  # phase 9's triangle count plans at least this many batches
KMER = (1 << 18, 1 << 23, 64)  # 10c: sequences, k-mers, k-mers per sequence (~2 a column)
KMER_LEAST_B = 128  # 10c without candidates: a budget of at least this many batches
N_DENSE = 1 << 15  # 11a: the dense step on one card and on the four gloo ranks
N_DENSE_NCCL = 1 << 16  # 11a: the dense step on four cards, 2x2x1
DENSE_RTOL = 1e-5  # 11a: ring vs allgather, the stages add in another order
# 11a on the four gloo ranks: (shape, b) of the dense step's B block; b = 4 on
# 1x1x4 keeps its reduce-scatter of D over gloo at 1 GiB a rank
DENSE_GLOO = (((2, 2, 1), 1), ((1, 1, 4), 4))
PLACE_STRATEGIES = ("identity", "degree", "rcm")
PLACE_LEAST_B = 16  # 11b: the budget at which the identity plan has at least this b
TUNE_WAIT_S = 900  # 11c: how long the n = 2^20 tunes may take in their worker


def log(msg: str) -> None:
    print(msg, flush=True)


def card_lines(chips):
    """The first ``chips`` cards' name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[:chips]


def cuda_ms(fn, reps: int, setup=None) -> float:
    """Mean ms of ``fn()`` on the current stream, CUDA events around each
    rep (``setup()`` runs before each rep, outside the timed window)."""
    import torch

    total = 0.0
    for _ in range(reps):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def device_ms(fn, calls: int, kernel: str, reps: int, setup=None) -> float:
    """Device time (ms) per wrapper call: everything torch.profiler (CUPTI)
    records on the card during ``fn()``, which makes ``calls`` calls, mean
    over ``reps`` profiled runs (``setup()`` runs before each, outside the
    profiled window). The window keeps PROFILE_MARGIN_S of idle time before
    and after ``fn()``: device events of a window of a few microseconds
    went missing on the card, which the margin guards against (only device
    events are summed, so it adds nothing to the time). Even so, a window
    now and then comes back with no device event at all (seen once in
    ~200 windows of one run): such a rep is profiled again, and the call
    raises if PROFILE_ATTEMPTS runs in a row record no kernel named
    ``kernel``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    total_us, per_kernel = 0.0, {}
    for _ in range(reps):
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            if setup is not None:
                setup()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(PROFILE_MARGIN_S)
                fn()
                torch.cuda.synchronize()
                time.sleep(PROFILE_MARGIN_S)
            dev = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
            if any(kernel in ev.name for ev in dev):
                break
            log(f"  profiled run {attempt} of {PROFILE_ATTEMPTS} recorded no device time for "
                f"{kernel!r}: {sorted({ev.name for ev in dev})}")
        else:
            raise RuntimeError(f"profiler recorded no device time for {kernel!r} in "
                               f"{PROFILE_ATTEMPTS} runs")
        for ev in dev:
            us = ev.time_range.elapsed_us()
            total_us += us
            per_kernel[ev.name[:100]] = per_kernel.get(ev.name[:100], 0.0) + us
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    log("  profiled on the card, us per call: "
        + "; ".join(f"{name} {us / reps / calls:.3f}" for name, us in ranked))
    return total_us / reps / calls / 1e3


def library_device_ms(label: str, fn, calls: int = 1, reps: int = 5) -> float:
    """A yardstick's device time per call, measured as a kernel's
    (``device_ms``: every kernel and memset the call puts on the card).
    ``fn()`` makes ``calls`` calls; a warm-up call runs first. Its
    CUDA-event time, host gaps included, is only logged."""
    fn()
    dev = device_ms(fn, calls, "", reps)
    events = cuda_ms(fn, reps) / calls
    log(f"  {label}: {dev:.6f} ms device time, {events:.6f} ms with CUDA events")
    return dev


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scipy_square(a):
    """scipy's A @ A for a port SparseCOO: (row-major keys r*n+c, values)."""
    return scipy_product(a, a)


def check_product(parts, ref, n) -> float:
    """Hold the driver's batches against scipy; returns max relative error."""
    import torch

    rows = torch.cat([p[0] for p in parts])
    cols = torch.cat([p[1] for p in parts])
    vals = torch.cat([p[2] for p in parts])
    key, perm = torch.sort(rows * n + cols)
    ref_key = torch.as_tensor(ref[0], device=key.device)
    ref_val = torch.as_tensor(ref[1], device=key.device)
    if key.shape != ref_key.shape or not torch.equal(key, ref_key):
        raise AssertionError(
            f"structure differs from scipy: {key.numel()} vs {ref_key.numel()} entries"
        )
    err = float(((vals[perm] - ref_val).abs() / ref_val.abs()).max())
    if not err <= VALUE_RTOL:
        raise AssertionError(f"values differ from scipy: max rel err {err}")
    return err


def run_multiply(A, B, grid, budget, local_path):
    """One batched_summa3d run with a consumer that keeps every batch in
    global coordinates; returns (result, wall s, peak bytes, parts)."""
    import torch

    from repro_torch.core import batched, convert, specs

    parts = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = batched.batched_summa3d(
        A, B, grid, budget,
        consumer=lambda bi, cb, cm: parts.append(convert.batch_to_global(cb, cm)),
        spec=specs.PlanSpec(local_path=local_path),
    )
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, torch.cuda.max_memory_allocated(), parts


def batch0_operands(A, B, grid, plan):
    """The gathered A and B of batch 0, as the fused step builds them."""
    from repro_torch.core import summa3d

    sel, _ = B.local(*grid.coords).select_cols_blockcyclic(
        0, plan.num_batches, grid.l, plan.sel_cap
    )
    return (summa3d._gather_A(A.local(*grid.coords), grid),
            summa3d._gather_B(sel, grid))


def same_parts(parts, parts2) -> bool:
    """Two runs' batches (rows, cols, vals) are the same bits."""
    import torch

    return len(parts) == len(parts2) and all(
        torch.equal(p[0], q[0]) and torch.equal(p[1], q[1])
        and torch.equal(p[2].view(torch.int32), q[2].view(torch.int32))
        for p, q in zip(parts, parts2))


def hash_bytes_per_launch(chunks, chunk_cap) -> tuple:
    """Least bytes and adds per launch of inserting ``chunks`` in order into
    an empty table: every valid flag read, key and value of each valid entry
    read, and per distinct key of a chunk its slot's key and value read and
    the value written, plus the key written where the chunk claims a new
    slot. Returns (bytes per launch, f32 adds per launch)."""
    import torch

    seen = None
    nbytes = adds = 0
    for key, _, ok in chunks:
        live = torch.unique(key[ok])
        new = live if seen is None else live[~torch.isin(live, seen)]
        seen = live if seen is None else torch.cat([seen, new])
        n_ok = int(ok.sum())
        nbytes += chunk_cap + 8 * n_ok + 12 * live.numel() + 4 * new.numel()
        adds += n_ok
    return nbytes / len(chunks), adds / len(chunks)


def check_hash_kernel(a_cat, b_cat, hc):
    """Hash insert: kernel vs plain on batch 0's chunks, sum/min/max, in the
    planned table and in a table far too small. Returns (max abs err,
    kernel ms/launch, plain ms/launch, bytes/launch, adds/launch)."""
    import torch

    from repro_torch.core import local_spgemm, semiring as sr
    from repro_torch.kernels import spgemm_hash as H

    dev = a_cat.device
    max_err, timing = 0.0, None
    for semi in (sr.PLUS_TIMES, sr.MIN_PLUS, sr.MAX_TIMES):
        kind = semi.add_kind
        total, it = local_spgemm.hash_chunks(a_cat, b_cat, hc.chunk_cap, hc.num_chunks, semi)
        chunks = list(it)
        distinct = None
        for table_cap in (hc.table_cap, None):
            if table_cap is None:  # far too small: about an eighth of the keys
                table_cap = max(8, 1 << (distinct.bit_length() - 4))
            tables = []
            for fn in (H.hash_insert_cuda, H.hash_insert_ref):
                tk = torch.full((table_cap,), H.EMPTY, dtype=torch.int32, device=dev)
                tv = torch.full((table_cap,), H.table_init_val(kind), device=dev)
                dropped = torch.zeros((), dtype=torch.int32, device=dev)
                for key, vals, valid in chunks:
                    fn(tk, tv, key, vals, valid, dropped, add_kind=kind,
                       max_probes=hc.max_probes)
                torch.cuda.synchronize()
                skey, perm = torch.sort(tk)
                tables.append((skey, tv[perm], int(dropped)))
            (kk, kv, kd), (pk, pv, pd) = tables
            if distinct is None:
                distinct = int((kk != H.EMPTY).sum())
                if kd or pd:
                    raise AssertionError(f"hash {kind}: drops in the planned table {kd} {pd}")
                if not torch.equal(kk, pk):
                    raise AssertionError(f"hash {kind}: key sets differ")
                live = kk != H.EMPTY
                diff = (kv[live] - pv[live]).abs()
                max_err = max(max_err, float(diff.max()))
                if kind == "sum":
                    ok = bool((diff <= KERNEL_RTOL * pv[live].abs()).all())
                else:
                    ok = torch.equal(kv[live], pv[live])
                if not ok:
                    raise AssertionError(f"hash {kind}: values differ, max {float(diff.max())}")
                log(f"hash {kind}: table {table_cap}, {distinct} keys, flops "
                    f"{int(total)}, max abs err {float(diff.max()):.3g}")
            elif not (kd > 0 and pd > 0):
                raise AssertionError(f"hash {kind}: small table must drop in both ({kd}, {pd})")
            else:
                log(f"hash {kind}: table {table_cap} too small: dropped {kd} (kernel) {pd} (plain)")
        if kind == "sum":
            tk = torch.empty((hc.table_cap,), dtype=torch.int32, device=dev)
            tv = torch.empty((hc.table_cap,), device=dev)
            dropped = torch.zeros((), dtype=torch.int32, device=dev)

            def reset():
                tk.fill_(H.EMPTY)
                tv.fill_(0.0)

            def insert_all(fn):
                return lambda: [fn(tk, tv, k, v, ok, dropped, add_kind="sum",
                                   max_probes=hc.max_probes) for k, v, ok in chunks]

            n_ch = len(chunks)
            for fn in (H.hash_insert_cuda, H.hash_insert_ref):  # warm-up
                reset()
                insert_all(fn)()
            gaps = cuda_ms(insert_all(H.hash_insert_cuda), 10, reset) / n_ch
            ms = device_ms(insert_all(H.hash_insert_cuda), n_ch, "hash_insert_kernel", 5, reset)
            log(f"hash insert: {ms:.6f} ms/launch device time; {gaps:.6f} ms/launch "
                f"with the host gaps between launches (CUDA events)")
            plain = cuda_ms(insert_all(H.hash_insert_ref), 2, reset) / n_ch
            nbytes, adds = hash_bytes_per_launch(chunks, hc.chunk_cap)
            log(f"hash insert: {adds:.1f} valid entries, {nbytes:.0f} B per launch (bound)")
            timing = (ms, plain, nbytes, adds)
    return (max_err,) + timing


def check_fused_hash(a_cat, b_cat, hc):
    """The fused hash kernel (one launch per batch) against its plain
    version (the chunk loop) on batch 0's whole expansion: sum/min/max in
    the planned table and in one far too small. Returns (max abs err,
    kernel ms per batch, plain ms per batch, bytes per batch, ops per
    batch)."""
    import torch

    from repro_torch.core import local_spgemm, semiring as sr
    from repro_torch.kernels import spgemm_hash as H

    dev = a_cat.device
    x, total = local_spgemm.hash_expansion(a_cat, b_cat)
    nc, cc = hc.num_chunks, hc.chunk_cap
    max_err, distinct = 0.0, None

    def run(fn, table_cap, semi):
        tk = torch.full((table_cap,), H.EMPTY, dtype=torch.int32, device=dev)
        tv = torch.full((table_cap,), H.table_init_val(semi.add_kind), device=dev)
        dropped = torch.zeros((), dtype=torch.int32, device=dev)
        fn(tk, tv, dropped, x, cc, nc, semiring=semi, max_probes=hc.max_probes)
        skey, perm = torch.sort(tk)
        return skey, tv[perm], int(dropped)

    for semi in (sr.PLUS_TIMES, sr.MIN_PLUS, sr.MAX_TIMES):
        kind = semi.add_kind
        (kk, kv, kd), (pk, pv, pd) = (run(fn, hc.table_cap, semi) for fn in
                                      (H.hash_expand_insert_cuda, H.hash_expand_insert_ref))
        if kd or pd:
            raise AssertionError(f"fused hash {kind}: drops in the planned table {kd} {pd}")
        if not torch.equal(kk, pk):
            raise AssertionError(f"fused hash {kind}: key sets differ")
        live = kk != H.EMPTY
        distinct = int(live.sum())
        diff = (kv[live] - pv[live]).abs()
        max_err = max(max_err, float(diff.max()))
        ok = (bool((diff <= KERNEL_RTOL * pv[live].abs()).all()) if kind == "sum"
              else torch.equal(kv[live], pv[live]))
        if not ok:
            raise AssertionError(f"fused hash {kind}: values differ, max {float(diff.max())}")
        small = max(8, 1 << (distinct.bit_length() - 4))  # about an eighth of the keys
        (_, _, kd), (_, _, pd) = (run(fn, small, semi) for fn in
                                  (H.hash_expand_insert_cuda, H.hash_expand_insert_ref))
        if not (kd > 0 and pd > 0):
            raise AssertionError(f"fused hash {kind}: small table must drop in both ({kd}, {pd})")
        log(f"fused hash {kind}: table {hc.table_cap}, {distinct} keys, flops {int(total)}, "
            f"max abs err {float(diff.max()):.3g}; table {small}: dropped {kd} (kernel) "
            f"{pd} (plain)")

    tk = torch.empty((hc.table_cap,), dtype=torch.int32, device=dev)
    tv = torch.empty((hc.table_cap,), device=dev)
    dropped = torch.zeros((), dtype=torch.int32, device=dev)

    def reset():
        tk.fill_(H.EMPTY)
        tv.fill_(0.0)

    def insert(fn):
        return lambda: fn(tk, tv, dropped, x, cc, nc, semiring=sr.PLUS_TIMES,
                          max_probes=hc.max_probes)

    reset()
    insert(H.hash_expand_insert_cuda)()  # warm-up
    ms = device_ms(insert(H.hash_expand_insert_cuda), 1, "hash_expand_insert_kernel", 10, reset)
    plain = cuda_ms(insert(H.hash_expand_insert_ref), 2, reset)
    # B's entries and cum read once; of A, the (row, value) of every entry
    # in a column that B's block reaches, and that column's start and end;
    # per distinct key its slot's key and value read and written
    cnt = x.cum - torch.cat([x.cum.new_zeros(1), x.cum[:-1]])
    touched = torch.unique(x.b_cols[cnt > 0]).long()
    a_needed = int((x.colptr[touched + 1] - x.colptr[touched]).sum())
    nbytes = 8 * a_needed + 8 * touched.numel() + 16 * x.cum.numel() + 16 * distinct
    flops = min(int(total), nc * cc)
    log(f"fused hash: {ms:.6f} ms device time per batch (one launch, {flops} partial "
        f"products, {nc} chunks of {cc} before); plain {plain:.4f} ms; {nbytes} B per batch")
    return max_err, ms, plain, nbytes, 2 * flops


def hash_batch_split(A, B, grid, plan, hc, wall, batches):
    """Where one batch of the hash run spends its time: the wall and the
    device time of batch 0's fused step (selection, gathers, local multiply,
    split, merge), beside the run's wall per batch."""
    import torch

    from repro_torch.core import summa3d

    def step():
        return summa3d.summa3d_fused_step(A, B, 0, grid=grid, num_batches=plan.num_batches,
                                          sel_cap=plan.sel_cap, caps=plan.caps, hashc=hc)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 100
    log(f"hash n=2^20: {wall / batches * 1e3:.3f} ms wall per batch in the run; batch 0's "
        f"step alone {step_ms:.3f} ms wall (mean of 10)")
    profile_top("hash n=2^20 batch 0, fused step", step)


def capture_segment_inputs(fn, clone=False):
    """Run ``fn`` with the segment-reduce dispatcher patched to note each
    call's (values, offsets, kind), copied if ``clone`` (values in
    float32, as the kernel gets them). Returns (fn's result, the inputs).
    The callers reach the kernel through the dispatcher; the wrapper counts
    its own launches, so it is left as it is."""
    from repro_torch.kernels import segment_reduce as S

    captured, orig = [], S.segment_reduce

    def note(v, o, kind):
        captured.append((v.float().clone(), o.clone(), kind) if clone else (v, o, kind))
        return orig(v, o, kind)

    S.segment_reduce = note
    try:
        out = fn()
    finally:
        S.segment_reduce = orig
    return out, captured


def hold_segment_reduce(label, vals, offsets, kind):
    """The kernel on one input against its plain version (KERNEL_RTOL) and
    against a second call (bit-identical); logs the input's runs by the
    kernel's path. Returns the max abs error."""
    import torch

    from repro_torch.kernels import segment_reduce as S

    got = S.segment_reduce_cuda(vals, offsets, kind)
    again = S.segment_reduce_cuda(vals, offsets, kind)
    want = S.segment_reduce_ref(vals, offsets, kind)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=1e-6):
        raise AssertionError(f"{label}: segment_reduce differs from plain, max abs err {err}")
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"{label}: segment_reduce: two calls differ")
    thread_run, warp_run = S.path_limits()
    lengths = offsets[1:] - offsets[:-1]
    paths = [int((lengths <= thread_run).sum()),
             int(((lengths > thread_run) & (lengths <= warp_run)).sum()),
             int((lengths > warp_run).sum())]
    log(f"{label}: segment_reduce {kind} over {lengths.numel()} runs (by path: {paths[0]} "
        f"thread, {paths[1]} warp, {paths[2]} block; longest {int(lengths.max())}) within "
        f"rtol {KERNEL_RTOL} of plain, max abs err {err:.3g}; two calls bit-identical")
    return err


def check_segment_reduce(a_cat, b_cat, caps):
    """The segment reduction on the ESC run's batch 0 (the expansion's
    compress, captured from one spgemm_esc call) against its plain version,
    twice bit-identical; then the ESC multiply of that batch twice, which
    must give the same bits. Returns (max abs err, ms, plain ms, library ms,
    bytes, ops)."""
    import torch

    from repro_torch.core import local_spgemm
    from repro_torch.kernels import segment_reduce as S

    runs, captured = capture_segment_inputs(
        lambda: [local_spgemm.spgemm_esc(a_cat, b_cat, caps.d_cap, caps.flops_cap)
                 for _ in range(2)])
    (c1, o1), (c2, o2) = runs
    same = all(torch.equal(getattr(c1, f), getattr(c2, f)) for f in ("rows", "cols", "nnz"))
    if not (same and int(o1) == int(o2) == 0
            and torch.equal(c1.vals.view(torch.int32), c2.vals.view(torch.int32))):
        raise AssertionError("esc batch 0: two runs differ (or overflowed)")
    log(f"esc n=2^20 batch 0: two runs bit-identical, nnz {int(c1.nnz)}")
    vals, offsets, kind = max(captured, key=lambda c: c[0].numel())
    err = hold_segment_reduce("esc n=2^20 batch 0", vals, offsets, kind)
    lo, hi = int(offsets[0]), int(offsets[-1])
    num = offsets.numel() - 1
    ms = device_ms(lambda: S.segment_reduce_cuda(vals, offsets, kind), 1,
                   "segment_reduce_kernel", 10)
    plain = cuda_ms(lambda: S.segment_reduce_ref(vals, offsets, kind), 3)
    data, offs = vals[lo:hi], (offsets - lo).long()
    lib = library_device_ms("torch.segment_reduce",
                            lambda: torch.segment_reduce(data, "sum", offsets=offs, unsafe=True))
    # what it replaced: scatter_reduce_ of every slot, padding into one discard slot
    seg = (torch.searchsorted(offsets, torch.arange(vals.numel(), dtype=torch.int32,
                                                    device=vals.device), right=True) - 1).long()
    seg = torch.where((seg >= 0) & (seg < num), seg, torch.full_like(seg, num))
    old = library_device_ms(
        "scatter_reduce_ (discard slot)",
        lambda: torch.zeros(num + 1, device=vals.device).scatter_reduce_(0, seg, vals, "sum"))
    log(f"segment_reduce: {num} runs over {hi - lo} of {vals.numel()} slots, {ms:.6f} ms "
        f"device time; plain {plain:.4f} ms; torch.segment_reduce {lib:.6f} ms; "
        f"scatter_reduce_ {old:.6f} ms; max abs err {err:.3g}")
    return err, ms, plain, lib, 4 * (hi - lo) + 8 * num + 4, hi - lo


def library_operands(a_cat, b_cat):
    """Batch 0's gathered A and selected B as coalesced torch sparse COO
    tensors (for the torch.sparse.mm yardstick), and the count of matching
    (A entry, B entry) pairs, the product's multiply-adds."""
    import torch

    m, k = a_cat.shape
    _, n = b_cat.shape
    a_valid = a_cat.valid_mask() & (a_cat.cols < k)
    b_valid = b_cat.valid_mask() & (b_cat.rows < k)
    ka = a_cat.cols[a_valid].long()
    kbv = b_cat.rows[b_valid].long()
    matches = int((torch.bincount(ka, minlength=k) * torch.bincount(kbv, minlength=k)).sum())
    a_sp = torch.sparse_coo_tensor(
        torch.stack([a_cat.rows[a_valid].long(), ka]), a_cat.vals[a_valid], (m, k),
        check_invariants=False,
    ).coalesce()
    b_sp = torch.sparse_coo_tensor(
        torch.stack([kbv, b_cat.cols[b_valid].long()]), b_cat.vals[b_valid], (k, n),
        check_invariants=False,
    ).coalesce()
    return a_sp, b_sp, matches


def binned_operands(a_cat, b_cat, kb, bin_of_k):
    """Batch 0's gathered A and selected B, binned by the run's plan as
    local_spgemm.spgemm_kbinned bins them: the binned multiply's arguments
    (a_rows, a_k, a_vals, b_k, b_cols, b_vals, m, n)."""
    import torch

    from repro_torch.kernels import spgemm_binned as Bn

    m, k = a_cat.shape
    _, n = b_cat.shape
    a_valid = a_cat.valid_mask() & (a_cat.cols < k)
    b_valid = b_cat.valid_mask() & (b_cat.rows < k)
    av = torch.where(a_valid, a_cat.vals, torch.zeros_like(a_cat.vals))
    bv = torch.where(b_valid, b_cat.vals, torch.zeros_like(b_cat.vals))
    ak, ar, avb, _ = Bn.bin_entries_by_k(
        a_cat.cols, a_cat.rows, av, a_valid, k, kb.num_bins, kb.bin_cap_a,
        fill_k=-1, fill_other=m, bin_map=bin_of_k)
    bk, bc, bvb, _ = Bn.bin_entries_by_k(
        b_cat.rows, b_cat.cols, bv, b_valid, k, kb.num_bins, kb.bin_cap_b,
        fill_k=-2, fill_other=n, bin_map=bin_of_k)
    return ar, ak, avb, bk, bc, bvb, m, n


def check_binned_kernel(a_cat, b_cat, kb, bin_of_k):
    """Binned multiply on batch 0's binned operands: the kernel bit-identical
    to its plain version run on the CPU and to a second call; timed beside
    the plain version on the card and torch.sparse.mm (the library
    yardstick). Returns (max abs err, kernel ms, plain ms, library ms,
    bytes, flops)."""
    import torch

    from repro_torch.kernels import spgemm_binned as Bn

    args = binned_operands(a_cat, b_cat, kb, bin_of_k)
    ar, bk, m, n = args[0], args[3], args[6], args[7]
    got = Bn.spgemm_paired_binned_cuda(*args)
    again = Bn.spgemm_paired_binned_cuda(*args)
    t0 = time.perf_counter()
    want = Bn.spgemm_paired_binned_ref(*(t.cpu() for t in args[:6]), m, n)
    cpu_s = time.perf_counter() - t0
    got = got.cpu()
    err = float((got - want).abs().max())
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"binned: kernel differs from its plain version on the CPU in "
                             f"{int((got.view(torch.int32) != want.view(torch.int32)).sum())} "
                             f"entries, max abs err {err}")
    if not torch.equal(got.view(torch.int32), again.cpu().view(torch.int32)):
        raise AssertionError("binned: a second call gives other bits")
    log(f"binned: bit-identical to the plain version on the CPU ({cpu_s:.1f} s) and "
        f"between two calls")
    a_sp, b_sp, matches = library_operands(a_cat, b_cat)
    events = cuda_ms(lambda: Bn.spgemm_paired_binned_cuda(*args), 20)
    # the wrapper's time: its two stable sorts and the two kernels
    ms = device_ms(lambda: Bn.spgemm_paired_binned_cuda(*args), 1, "binned_pull_kernel", 10)
    log(f"binned: {ms:.6f} ms device time (sorts + kernels); {events:.6f} ms "
        f"with CUDA events")
    plain = cuda_ms(lambda: Bn.spgemm_paired_binned_ref(*args), 3)
    lib = library_device_ms("torch.sparse.mm", lambda: torch.sparse.mm(a_sp, b_sp))
    # the six binned arrays read once, C written once
    nbytes = (ar.numel() + bk.numel()) * 12 + m * n * 4
    shapes = f"{kb.num_bins} bins x ({kb.bin_cap_a} A, {kb.bin_cap_b} B) -> ({m}, {n})"
    log(f"binned: {shapes}, {matches} matching pairs, max abs err {err:.3g}")
    return err, ms, plain, lib, nbytes, 2 * matches


def ops_phase(a_cat, b_cat, kb, bin_of_k):
    """Phase 5: the kernel API (kernels.ops) on batch 0 of the default
    product. Runs the API once with every launch count set to 0 just before
    (the paired multiply, its binned and SpMM-of-densify counterparts, and
    sort_pairs at three lengths), then holds each result against its plain
    version and its counterparts, and times the two kernels the API alone
    reaches. Returns {name: (launches, max abs err, ms, plain ms, library
    ms, bytes, ops)} for bitonic_sort_pairs and spgemm_paired."""
    import torch

    from repro_torch.core import local_spgemm, semiring as sr
    from repro_torch.kernels import ops, sort_engine as So, spgemm_acc as Ac
    from repro_torch.kernels.densify_kernel import densify_cuda
    from repro_torch.kernels.spgemm_binned import spgemm_paired_binned_cuda
    from repro_torch.kernels.spmm_kernel import spmm_cuda

    m, k = a_cat.shape
    _, n = b_cat.shape
    big = So.MAX_BITONIC_ELEMS
    lengths = (big, 12345, big + 8)  # the network; padded; routed to torch.sort
    # the packed-key engine's input: the row-major keys of batch 0's first
    # partial products, in expansion order (duplicate-heavy), and their values
    total, chunks = local_spgemm.hash_chunks(a_cat, b_cat, big + 8, 1, sr.PLUS_TIMES)
    keys, vals, valid = next(chunks)
    if not bool(valid.all()):
        raise AssertionError(f"ops: batch 0 has only {int(total)} partial products")

    wrappers = {"bitonic_sort_pairs": So.bitonic_sort_pairs_cuda,
                "spgemm_paired": Ac.spgemm_paired_cuda,
                "spgemm_paired_binned": spgemm_paired_binned_cuda,
                "spmm": spmm_cuda, "densify": densify_cuda}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c_paired = ops.spgemm_paired(a_cat, b_cat)
    c_binned, overflow = ops.spgemm_paired_binned(
        a_cat, b_cat, kb.num_bins, kb.bin_cap_a, kb.bin_cap_b, bin_map=bin_of_k)
    c_spmm = ops.spmm(a_cat, ops.densify(b_cat))
    sorted_runs = {ln: ops.sort_pairs(keys[:ln], vals[:ln]) for ln in lengths}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    log(f"ops API on batch 0: {wall * 1e3:.1f} ms wall, launches {launches}")
    if launches["spgemm_paired"] != 1 or launches["bitonic_sort_pairs"] != 2:
        raise AssertionError(f"ops: the paired kernel must launch once and the bitonic "
                             f"kernel twice (2^14 and 12345 pairs): {launches}")

    # the paired multiply against its plain version and its counterparts
    av = torch.where(a_cat.valid_mask(), a_cat.vals, torch.zeros_like(a_cat.vals))
    bv = torch.where(b_cat.valid_mask(), b_cat.vals, torch.zeros_like(b_cat.vals))
    args = (a_cat.rows, a_cat.cols, av, b_cat.rows, b_cat.cols, bv, m, n)
    want = Ac.spgemm_paired_ref(*args)
    torch.cuda.synchronize()
    err = float((c_paired - want).abs().max())
    for label, other in (("plain", want), ("binned", c_binned), ("spmm(densify)", c_spmm)):
        if not torch.allclose(c_paired, other, rtol=KERNEL_RTOL, atol=1e-6):
            raise AssertionError(f"ops: spgemm_paired differs from {label}, max abs err "
                                 f"{float((c_paired - other).abs().max())}")
    if int(overflow) != 0:
        raise AssertionError(f"ops: the run's bin plan overflowed ({int(overflow)})")
    a_sp, b_sp, matches = library_operands(a_cat, b_cat)
    lib_c = torch.sparse.mm(a_sp, b_sp).to_dense()
    lib_err = float((c_paired - lib_c).abs().max())
    cap_a, cap_b = a_cat.cap, b_cat.cap
    log(f"spgemm_paired: A {cap_a} slots x B {cap_b} slots = {cap_a * cap_b} pairings, "
        f"{matches} matching pairs, C ({m}, {n}); max abs err {err:.3g} (plain), "
        f"{lib_err:.3g} (torch.sparse.mm)")
    ms = device_ms(lambda: Ac.spgemm_paired_cuda(*args), 1, "paired_match_kernel", 10)
    events = cuda_ms(lambda: Ac.spgemm_paired_cuda(*args), 10)
    plain = cuda_ms(lambda: Ac.spgemm_paired_ref(*args), 2)
    lib = library_device_ms("torch.sparse.mm", lambda: torch.sparse.mm(a_sp, b_sp))
    log(f"spgemm_paired: {ms:.6f} ms device time (zero fill + kernel); {events:.6f} ms "
        f"with CUDA events; plain {plain:.4f} ms, torch.sparse.mm {lib:.6f} ms device time")
    out = {"spgemm_paired": (launches["spgemm_paired"], err, ms, plain, lib,
                             12 * (cap_a + cap_b) + 4 * m * n, 2 * matches)}

    # sort_pairs: keys as torch.sort's, values bit-identical to the plain
    # network on the same padding, per-key value sums as torch.sort + gather's
    sort_err = 0.0
    for ln, (sk, sv) in sorted_runs.items():
        ref_k, perm = torch.sort(keys[:ln])
        if not torch.equal(sk, ref_k):
            raise AssertionError(f"ops: sort_pairs keys differ from torch.sort at {ln}")
        uniq, inv = torch.unique(sk, return_inverse=True)
        sums = torch.zeros(uniq.numel(), dtype=torch.float64, device=sk.device)
        ref_sums = torch.zeros_like(sums)
        sums.index_add_(0, inv, sv.double())
        ref_sums.index_add_(0, inv, vals[:ln][perm].double())
        if not torch.allclose(sums, ref_sums, rtol=1e-12, atol=0):
            raise AssertionError(f"ops: sort_pairs per-key sums differ at {ln}")
        if ln > big and not torch.equal(sv, vals[:ln][torch.sort(keys[:ln], stable=True)[1]]):
            raise AssertionError(f"ops: routed sort_pairs values differ from a stable sort at {ln}")
        if ln <= big:
            plain_k, plain_v = So.sort_pairs(keys[:ln].cpu(), vals[:ln].cpu())  # the plain network
            sort_err = max(sort_err, float((sv.cpu() - plain_v).abs().max()),
                           float((sk.cpu() - plain_k).abs().max()))
            if not torch.equal(sv.cpu().view(torch.int32), plain_v.view(torch.int32)):
                raise AssertionError(f"ops: sort_pairs values differ from the plain network "
                                     f"at {ln}")
        log(f"sort_pairs {ln}: keys equal to torch.sort's, {uniq.numel()} distinct, values "
            f"{'bit-identical to the plain network' if ln <= big else 'as a stable sort'}")
    k16, v16 = keys[:big].contiguous(), vals[:big].contiguous()

    def sorts():
        for _ in range(SORT_CALLS):
            So.bitonic_sort_pairs_cuda(k16, v16)

    sorts()  # warm-up
    ms = device_ms(sorts, SORT_CALLS, "bitonic_cluster_kernel", 10)
    # one block of 2048 pairs: the network inside a block, with no cluster
    k11, v11 = keys[:2048].contiguous(), vals[:2048].contiguous()
    ms11 = device_ms(lambda: [So.bitonic_sort_pairs_cuda(k11, v11) for _ in range(SORT_CALLS)],
                     SORT_CALLS, "bitonic_cluster_kernel", 10)
    log(f"bitonic_sort_pairs 2048 (one block, no cluster): {ms11:.6f} ms device time")
    events = cuda_ms(sorts, 10) / SORT_CALLS
    plain = cuda_ms(lambda: So.bitonic_sort_pairs_ref(k16, v16), 3)

    def torch_sort_gather():
        sk, perm = torch.sort(k16)
        return sk, v16[perm]

    lib = library_device_ms("torch.sort + gather",
                            lambda: [torch_sort_gather() for _ in range(SORT_CALLS)],
                            SORT_CALLS, 10)
    log(f"bitonic_sort_pairs {big}: {ms:.6f} ms device time; {events:.6f} ms per call with "
        f"CUDA events over {SORT_CALLS} back-to-back calls; plain {plain:.4f} ms; torch.sort "
        f"+ gather {lib:.6f} ms device time")
    out["bitonic_sort_pairs"] = (launches["bitonic_sort_pairs"], sort_err, ms, plain, lib,
                                 16 * big, big * (big.bit_length() - 1))
    for name, (_, e, t, pl, lb, nb, ops_n) in out.items():
        bound, by = bound_ms(nb, ops_n)
        log(f"{name}: {t:.6f} ms, bound {bound:.7f} ms ({by}, {nb} B, {ops_n} ops), "
            f"{100 * bound / t:.3f} % of bound, library {lb:.6f} ms, max abs err {e:.3g}")
    return out


def column_stochastic(a):
    """``a`` with every column scaled to sum 1 (MCL's input)."""
    from repro_torch.core import convert
    from repro_torch.core.sparse import from_numpy_coo

    n = a.shape[1]
    r, c, v = convert.triplets(a)
    sums = np.bincount(c, weights=v.astype(np.float64), minlength=n)
    v = (v / np.where(sums > 0, sums, 1.0)[c]).astype(np.float32)
    return from_numpy_coo(r, c, v, a.shape, cap=len(r), device=a.device)


def partition(final, n):
    """Cluster labels of a converged MCL matrix in a canonical form (each
    node labelled by the first node of its cluster): two results have the
    same partition exactly when these arrays are equal."""
    import scipy.sparse as sps
    from scipy.sparse.csgraph import connected_components

    from repro_torch.core import convert

    r, c, _ = convert.triplets(final)
    g = sps.coo_matrix((np.ones(len(r)), (r, c)), shape=(n, n))
    _, labels = connected_components(g, directed=False)
    _, first, inv = np.unique(labels, return_index=True, return_inverse=True)
    return first[inv]


def check_mcl_matrix(final, k):
    """At most k entries per column, nonempty columns summing to 1 +- 1e-4."""
    import torch

    n = final.shape[1]
    cols = final.cols[: int(final.nnz)].long()
    counts = torch.bincount(cols, minlength=n)
    sums = torch.zeros(n, dtype=torch.float64, device=cols.device)
    sums.index_add_(0, cols, final.vals[: int(final.nnz)].double())
    live = counts > 0
    dev = float((sums[live] - 1).abs().max())
    if int(counts.max()) > k or not dev <= 1e-4:
        raise AssertionError(f"MCL matrix: max {int(counts.max())} per column (k={k}), "
                             f"column sums off by {dev}")
    return int(counts.max()), dev


def compare_loops(label, hist, ref_hist, lab, ref_lab, chaos_rtol=None):
    """nnz trajectories equal within ``NNZ_RTOL`` per iteration (every
    difference is printed), identical partitions, and chaos within
    ``chaos_rtol`` if asked."""
    nnz, ref_nnz = [h["nnz"] for h in hist], [h["nnz"] for h in ref_hist]
    diff = [a - b for a, b in zip(nnz, ref_nnz)]
    if len(nnz) != len(ref_nnz) or any(abs(d) > NNZ_RTOL * b for d, b in zip(diff, ref_nnz)):
        raise AssertionError(f"{label}: nnz trajectories differ: {nnz} vs {ref_nnz}")
    if chaos_rtol is not None:
        ch = np.array([h["chaos"] for h in hist])
        ref = np.array([h["chaos"] for h in ref_hist])
        if not np.allclose(ch, ref, rtol=chaos_rtol, atol=1e-5):
            raise AssertionError(f"{label}: chaos differs: {ch} vs {ref}")
    if not np.array_equal(lab, ref_lab):
        raise AssertionError(f"{label}: cluster partitions differ")
    log(f"{label}: nnz trajectories {nnz} vs {ref_nnz} (differences {diff}), identical "
        f"partitions ({len(np.unique(lab))} clusters)")


def run_mcl(fn, a, grid, cfg, label):
    """One MCL loop with the kernel counts set to 0 just before it; returns
    (final, history, wall s, peak bytes, launches)."""
    import torch

    from repro_torch.kernels import col_prune, segment_reduce, spgemm_binned, spgemm_hash
    from repro_torch.kernels.densify_kernel import densify_cuda
    from repro_torch.kernels.spmm_kernel import spmm_cuda
    from repro_torch.sparse_apps import mcl

    wrappers = {
        "hash_insert": spgemm_hash.hash_expand_insert_cuda,
        "spgemm_paired_binned": spgemm_binned.spgemm_paired_binned_cuda,
        "col_topk_bounds": col_prune.col_topk_bounds_cuda,
        "spmm": spmm_cuda,
        "densify": densify_cuda,
        "segment_reduce": segment_reduce.segment_reduce_cuda,
    }
    for w in wrappers.values():
        w.launches = 0
    mcl.reset_transfer_bytes()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    final, hist = fn(a, grid, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {name: w.launches for name, w in wrappers.items()}
    log(f"{label}: {len(hist)} iterations, wall {wall:.2f} s, peak {peak / 2**30:.3f} GiB, "
        f"launches {launches}")
    for h in hist:
        log(f"  iter {h['iter']}: nnz {h['nnz']}, chaos {h['chaos']:.6g}, b={h['batches']}, "
            f"path {h['local_path']}, retries {h['retries']}, replans {h['replans']}, "
            f"host bytes {h['host_bytes']}, {h['wall_ms']:.1f} ms")
    return final, hist, wall, peak, launches


def same_bits(fin, hist, fin2, hist2) -> bool:
    """Two MCL results are the same bits: final matrices field by field and
    every iteration's nnz and chaos."""
    import torch

    fields = all(torch.equal(getattr(fin, f), getattr(fin2, f)) for f in ("rows", "cols", "nnz"))
    vals = torch.equal(fin.vals.view(torch.int32), fin2.vals.view(torch.int32))
    traj = [(h["nnz"], h["chaos"]) for h in hist] == [(h["nnz"], h["chaos"]) for h in hist2]
    return fields and vals and traj


def check_repeats(label, fn, a, grid, cfg, first):
    """Run an MCL loop once more and hold it to ``first`` = (final,
    history) bit for bit; raises if they differ."""
    fin2, hist2, wall2, _, _ = run_mcl(fn, a, grid, cfg, f"{label}, second run")
    if not same_bits(*first, fin2, hist2):
        raise AssertionError(f"{label}: a second run differs: "
                             f"{[h['nnz'] for h in first[1]]} vs {[h['nnz'] for h in hist2]}")
    log(f"{label}: second run bit-identical ({wall2:.2f} s)")


def profile_top(label, fn, rows=8, kernel=None):
    """One profiled call of ``fn``: its device time and the ops that take
    the most of it (logged). Returns (the window's device ms, the device
    time (us) of each launch of the kernel named ``kernel``, in launch
    order, or None without one)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches = None if kernel is None else sorted(
        (ev.time_range.start, ev.time_range.elapsed_us()) for ev in prof.events()
        if ev.device_type == DeviceType.CUDA and kernel in ev.name)
    # kernels carry the device time; each PyTorch op that launched them
    # carries the same time again, so sum the one and list the other
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in events
                if e.device_type == DeviceType.CUDA) / 1e3
    ops = [e for e in events if e.device_type != DeviceType.CUDA]
    log(f"{label}: {total:.1f} ms device time; top PyTorch ops (ms, calls):")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:rows]:
        log(f"  {e.self_device_time_total / 1e3:10.2f}  {e.count:4d}  {e.key[:90]}")
    times = None if launches is None else [us for _, us in launches]
    return total, times


def profile_segment_reduce(label, fn):
    """Profile ``fn`` (as profile_top) and log each segment-reduce launch
    it makes: runs, entries, device time and bound. A profiled run that
    misses some of the launches is run again, up to PROFILE_ATTEMPTS runs.
    Returns (launches, device ms or None if never all profiled, bound ms)
    summed over the launches of one run."""
    from repro_torch.kernels import segment_reduce as S

    kern = S.segment_reduce_cuda
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        kern.launches = 0
        (_, times), calls = capture_segment_inputs(
            lambda: profile_top(label, fn, kernel="segment_reduce_kernel"))
        if len(calls) != kern.launches:
            raise AssertionError(f"{label}: {kern.launches} segment-reduce launches, "
                                 f"{len(calls)} calls")
        if len(times) == kern.launches:
            break
        log(f"  profiled run {attempt} of {PROFILE_ATTEMPTS} recorded {len(times)} of "
            f"{kern.launches} segment-reduce launches")
    else:
        times = [None] * len(calls)
    total_bound = 0.0
    for (v, o, _), us in zip(calls, times):
        slots, runs, entries = v.numel(), o.numel() - 1, int(o[-1] - o[0])
        bound, _ = bound_ms(4 * entries + 8 * runs + 4, entries)
        total_bound += bound
        t = "not measured" if us is None else f"{us / 1e3:.6f} ms device time"
        log(f"  segment_reduce: {runs} runs over {entries} of {slots} slots, {t}, "
            f"bound {bound:.6f} ms")
    ms = None if None in times else sum(times) / 1e3
    log(f"{label}: {len(calls)} segment-reduce launches, "
        f"{'not measured' if ms is None else f'{ms:.6f} ms'} device time, "
        f"bound {total_bound:.6f} ms")
    return len(calls), ms, total_bound


# the n = 2^18 host loop's depth: of the device loop's 4 iterations, the
# first (the host loop pulls ~17 GB a later iteration through numpy: 4
# iterations took 182.48 s of the script's 1107.7 s on an H100 80GB HBM3 at
# 700 W, 2 took 102.08 s); the device loop run again to that depth is its
# reference
MCL_HOST_ITERS = 1


def mcl_sparse_input():
    """The sparse MCL run's column-stochastic input (n = 2^18) and config."""
    from repro_torch.core import gen
    from repro_torch.sparse_apps import mcl

    a = column_stochastic(gen.protein_similarity_like(
        N_MCL, blocks=N_MCL // 64, intra_p=0.12, seed=0))
    # "auto" plans the k-binned multiply here, whose dense (n, n/b) f32
    # output tile the planner does not charge (256 GiB at b = 1): ESC
    cfg = mcl.MCLConfig(inflation=2.0, prune_threshold=1e-4, max_per_col=64,
                        local_path="esc", max_iters=4, per_process_memory=MCL_BUDGET)
    return a, cfg


def mcl_batch(a, grid, cfg):
    """Batch 0 of the sparse MCL loop's second iteration as its two stages:
    ``step()`` runs the fused multiply step and returns the batch's product
    C, ``prune(c)`` the prune postprocess of C. Logs the plan."""
    import dataclasses

    from repro_torch.core import summa3d
    from repro_torch.core.batched import plan_batches
    from repro_torch.core.specs import PlanSpec
    from repro_torch.sparse_apps import mcl

    st = mcl._mcl_cold_state(a, grid, cfg)
    st, _, _ = mcl._mcl_sparse_step(st, grid, dataclasses.replace(cfg, max_iters=1))
    _, _, reserved = mcl._mcl_caps(a.shape[0], grid, cfg)
    plan = plan_batches(st.A, st.B, grid, cfg.per_process_memory,
                        spec=PlanSpec(local_path=st.lp_arg, reserved_bytes=reserved),
                        floors=st.floors.replace(caps_pow2=True))
    log(f"mcl sparse, iteration 2 plan: b={plan.num_batches}, caps {plan.caps}")

    def step():
        return summa3d.summa3d_fused_step(st.A, st.B, 0, grid=grid, num_batches=plan.num_batches,
                                          sel_cap=plan.sel_cap, caps=plan.caps)[0]

    def prune(c):
        k = cfg.max_per_col
        return mcl._mcl_prune_sparse(c, grid, cfg.inflation, cfg.prune_threshold, k,
                                     new_cap=min(k * c.tile_shape[1], c.cap))

    return step, prune


def profile_mcl_batch(a, grid, cfg):
    """One batch of the sparse MCL loop's second iteration (mcl_batch):
    each segment-reduce input of its multiply step and of its prune held
    against the plain version, then where its device time goes, with each
    segment-reduce launch. Returns {stage: (launches, device ms, bound ms,
    max abs err)} of the segment reduction."""
    def stage(name, fn, inputs):
        label = f"mcl sparse batch 0, {name}"
        err = max(hold_segment_reduce(f"{label}, input {i}", *inp)
                  for i, inp in enumerate(inputs))
        return (*profile_segment_reduce(label, fn), err)

    step, prune = mcl_batch(a, grid, cfg)
    c, inputs = capture_segment_inputs(step, clone=True)  # also the step's warm-up
    seg = {"multiply step": stage("multiply step", step, inputs)}
    _, inputs = capture_segment_inputs(lambda: prune(c), clone=True)
    seg["prune"] = stage("prune", lambda: prune(c), inputs)
    return seg


def mcl_sparse_phase(grid):
    """Phase 7: sparse MCL at n = 2^18, device loop vs host loop (the host
    loop's first MCL_HOST_ITERS iterations against the device loop's).
    Returns the segment reduction's numbers in the profiled batch (see
    profile_mcl_batch) and the first device loop (input, config, final
    matrix, history, wall, peak and each iteration's plan) for 12a."""
    import dataclasses

    from repro_torch.sparse_apps import mcl

    t0 = time.perf_counter()
    a, cfg = mcl_sparse_input()
    log(f"mcl sparse: n={N_MCL}, nnz(A)={int(a.nnz)}, set-up {time.perf_counter() - t0:.1f} s")
    seg = profile_mcl_batch(a, grid, cfg)
    with PlanLog(mcl) as plans:
        fin_d, hist_d, wall_d, peak_d, _ = run_mcl(
            mcl.mcl_iterate, a, grid, cfg, "mcl sparse n=2^18, device loop")
    fin_2, hist_2, wall_2, _, _ = run_mcl(
        mcl.mcl_iterate, a, grid, cfg, "mcl sparse n=2^18, device loop, second run")
    log(f"mcl sparse n=2^18: device loop trajectories {[h['nnz'] for h in hist_d]} and "
        f"{[h['nnz'] for h in hist_2]}; bit-identical: {same_bits(fin_d, hist_d, fin_2, hist_2)}")
    del fin_2
    short = dataclasses.replace(cfg, max_iters=MCL_HOST_ITERS)
    fin_h, hist_h, wall_h, peak_h, _ = run_mcl(
        mcl.mcl_iterate_host, a, grid, short, "mcl sparse n=2^18, host loop")
    fin_s, hist_s, _, _, _ = run_mcl(
        mcl.mcl_iterate, a, grid, short, f"mcl sparse n=2^18, device loop, {MCL_HOST_ITERS} "
        f"iterations")
    if [h["nnz"] for h in hist_s] != [h["nnz"] for h in hist_d[:MCL_HOST_ITERS]]:
        raise AssertionError("mcl sparse: the short device loop left the long one's trajectory")
    compare_loops("mcl sparse n=2^18 device vs host", hist_s, hist_h,
                  partition(fin_s, N_MCL), partition(fin_h, N_MCL), chaos_rtol=CHAOS_RTOL)
    del fin_s
    most, dev = check_mcl_matrix(fin_d, cfg.max_per_col)
    host_bytes = [h["host_bytes"] for h in hist_d]
    if max(host_bytes) >= 1024:
        raise AssertionError(f"mcl sparse: device loop moved {host_bytes} host bytes")
    if len(hist_d) < 2 or hist_d[1]["batches"] < 4:
        raise AssertionError("mcl sparse: iteration 2 must plan b >= 4")
    log(f"mcl sparse n=2^18: device loop {wall_d:.2f} s, peak {peak_d / 2**30:.3f} GiB, host "
        f"bytes/iter {host_bytes}; host loop {wall_h:.2f} s, peak {peak_h / 2**30:.3f} GiB, "
        f"host bytes/iter {[h['host_bytes'] for h in hist_h]}; final: <= {most} per column, "
        f"column sums within {dev:.3g} of 1")
    return seg, {"a": a, "cfg": cfg, "final": fin_d, "hist": hist_d, "wall": wall_d,
                 "peak": peak_d, "plans": plans.plans}


def mcl_dense_input():
    """The dense MCL run's column-stochastic input (n = 2^14) and config."""
    from repro_torch.core import gen
    from repro_torch.sparse_apps import mcl

    a = column_stochastic(gen.protein_similarity_like(
        N_DEFAULT, blocks=N_DEFAULT // 64, intra_p=0.12, seed=0))
    cfg = mcl.MCLConfig(inflation=2.0, prune_threshold=1e-4, max_per_col=64, path="dense",
                        force_num_batches=4, max_iters=6, per_process_memory=MCL_BUDGET)
    return a, cfg


def mcl_dense_phase(grid, a, cfg):
    """Phase 8: dense MCL at n = 2^14 vs the sparse device loop and the host
    loop; returns the launch counts of the dense run and the sparse loop on
    its default (binned) multiply as (final, history), 12b's reference."""
    import dataclasses

    from repro_torch.sparse_apps import mcl

    fin_d, hist_d, _, _, launches = run_mcl(
        mcl.mcl_iterate, a, grid, cfg, "mcl dense n=2^14, device loop")
    check_repeats("mcl dense n=2^14, device loop", mcl.mcl_iterate, a, grid, cfg,
                  (fin_d, hist_d))
    sparse = dataclasses.replace(cfg, path="sparse")
    fin_s, hist_s, _, _, sparse_launches = run_mcl(
        mcl.mcl_iterate, a, grid, sparse, "mcl dense n=2^14, sparse device loop")
    if sparse_launches["spgemm_paired_binned"] == 0:
        raise AssertionError(f"mcl sparse n=2^14: the binned kernel did not launch: "
                             f"{sparse_launches}")
    check_repeats("mcl dense n=2^14, sparse device loop", mcl.mcl_iterate, a, grid, sparse,
                  (fin_s, hist_s))
    esc = dataclasses.replace(cfg, path="sparse", local_path="esc")
    fin_e, hist_e, _, _, _ = run_mcl(mcl.mcl_iterate, a, grid, esc,
                                     "mcl n=2^14, sparse device loop (esc)")
    check_repeats("mcl n=2^14, sparse device loop (esc)", mcl.mcl_iterate, a, grid, esc,
                  (fin_e, hist_e))
    compare_loops("mcl n=2^14 sparse esc vs binned", hist_e, hist_s, partition(fin_e, N_DEFAULT),
                  partition(fin_s, N_DEFAULT))
    fin_h, hist_h, _, _, _ = run_mcl(
        mcl.mcl_iterate_host, a, grid, cfg, "mcl dense n=2^14, host loop")
    lab = partition(fin_d, N_DEFAULT)
    compare_loops("mcl n=2^14 dense vs sparse", hist_d, hist_s, lab, partition(fin_s, N_DEFAULT))
    compare_loops("mcl n=2^14 dense vs host", hist_d, hist_h, lab, partition(fin_h, N_DEFAULT))
    ported = ("col_topk_bounds", "spmm", "densify")
    if not all(launches[name] > 0 for name in ported):
        raise AssertionError(f"mcl dense: a dense-path kernel did not launch: {launches}")
    return launches, (fin_s, hist_s)


def dense_batch0(a, grid, cfg):
    """Batch 0 of the dense run's second multiply: the iterate after one
    dense iteration, re-scattered at the loop's operand capacities, and
    batch 0's gathered A, selected B and inflated, normalized D block (the
    col_prune kernel's input)."""
    import dataclasses

    import torch

    from repro_torch.core import local_spgemm
    from repro_torch.core.batched import plan_batches
    from repro_torch.core.distsparse import scatter_to_grid
    from repro_torch.core.specs import PlanSpec
    from repro_torch.sparse_apps import mcl

    it1, _ = mcl.mcl_iterate(a, grid, dataclasses.replace(cfg, max_iters=1))
    cap_a, cap_b, _ = mcl._mcl_caps(a.shape[0], grid, cfg)  # the loop's operand capacities
    A = scatter_to_grid(it1, grid, "A", cap=cap_a)
    B = scatter_to_grid(it1, grid, "B", cap=cap_b)
    plan = plan_batches(A, B, grid, cfg.per_process_memory,
                        spec=PlanSpec(local_path="esc", force_num_batches=cfg.force_num_batches))
    a_cat, b_cat = batch0_operands(A, B, grid, plan)
    d = local_spgemm.spmm(a_cat, b_cat.to_dense()) ** cfg.inflation
    x = d / torch.where(d.sum(0) > 0, d.sum(0), torch.ones_like(d[0]))[None, :]
    log(f"dense batch 0: nnz(A) {int(it1.nnz)}, A entries {a_cat.cap}, B entries "
        f"{int((b_cat.rows < b_cat.shape[0]).sum())} of {b_cat.cap}, D {tuple(x.shape)}")
    return a_cat, b_cat, x


def spmm_reuse(rows, cols, live, k, block_rows=(16, 32, 64, 128)):
    """How often the SpMM kernel can reuse a staged B stripe on these
    operands: per block of R rows, nnz / distinct columns, and (at each R)
    the share of entries whose column occurs twice or more in the block and
    the most such columns in one block (the stripes it would stage)."""
    import torch

    r, c = rows[live].long(), cols[live].long()
    for rb in block_rows:
        keys, counts = torch.unique((r // rb) * k + c, return_counts=True)
        multi = counts >= 2
        per_block = torch.bincount(keys[multi] // k)
        log(f"spmm reuse, {rb} rows a block: nnz / distinct columns "
            f"{r.numel() / keys.numel():.3f}; columns used twice or more carry "
            f"{float(counts[multi].sum()) / r.numel():.4f} of the entries, at most "
            f"{int(per_block.max())} such columns in a block")


def check_dense_kernels(a_cat, b_cat, x, k):
    """Phase 6: col_prune, SpMM and densify against their plain versions and
    a library yardstick. Returns {name: (max abs err, ms, plain ms,
    library ms, bytes, ops)}."""
    import torch

    from repro_torch.kernels import col_prune as P
    from repro_torch.kernels.densify_kernel import densify_cuda, densify_ref
    from repro_torch.kernels.spmm_kernel import spmm_cuda, spmm_ref

    out = {}
    m, kk = a_cat.shape
    _, n = b_cat.shape

    # col_prune: bit-identical
    before = P.col_topk_bounds_cuda.launches
    got, want = P.col_topk_bounds_cuda(x, k), P.col_topk_bounds_ref(x, k)
    if not all(torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want)):
        raise AssertionError("col_prune: kernel bracket differs from plain")
    if P.col_topk_bounds_cuda.launches != before + 1:
        raise AssertionError("col_prune: one call must be one launch")
    reads = P.reads_of_x()
    log(f"col_prune: bracket bit-identical, one launch; the built kernel reads x {reads} "
        f"times by design ({P.THRESH_ITERS} steps, {P.THRESH_ITERS // (reads - 1)} a read, "
        f"after one for the maxima)")
    ms = device_ms(lambda: P.col_topk_bounds_cuda(x, k), 1, "col_topk_bounds_kernel", 5)
    plain = cuda_ms(lambda: P.col_topk_bounds_ref(x, k), 3)
    lib = library_device_ms("torch.topk", lambda: torch.topk(x.abs(), k, dim=0))
    xm, xn = x.shape
    out["col_prune"] = (0.0, ms, plain, lib, xm * xn * 4 + 8 * xn,
                        2 * P.THRESH_ITERS * xm * xn)

    # SpMM: A's live entries (row, col, val) times the dense selected B, in
    # f32 and with bf16 values and B (both sum in f32); two calls bit-identical
    valid = a_cat.valid_mask()
    rows = torch.where(valid, a_cat.rows, torch.full_like(a_cat.rows, m))
    vals = torch.where(valid, a_cat.vals, torch.zeros_like(a_cat.vals))
    bd = b_cat.to_dense()
    live = (rows < m) & (a_cat.cols < kk)
    nnz_a = int(live.sum())
    spmm_reuse(rows, a_cat.cols, live, kk)
    for dtype in (torch.bfloat16, torch.float32):
        args = (rows, a_cat.cols, vals.to(dtype), bd.to(dtype), m)
        got, again, want = spmm_cuda(*args), spmm_cuda(*args), spmm_ref(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=1e-6):
            raise AssertionError(f"spmm {dtype}: kernel differs from plain, max abs err {err}")
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            raise AssertionError(f"spmm {dtype}: two calls differ")
        ms = device_ms(lambda: spmm_cuda(*args), 1, "spmm_tile_kernel", 5)
        nbytes = 12 * nnz_a + (kk * n) * bd.to(dtype).element_size() + 4 * m * n
        log(f"spmm {dtype}: {ms:.6f} ms device time, two calls bit-identical, max abs err "
            f"{err:.3g} (plain), bound {bound_ms(nbytes, 2 * nnz_a * n)[0]:.6f} ms")
    plain = cuda_ms(lambda: spmm_ref(*args), 3)
    a_csr = torch.sparse_coo_tensor(
        torch.stack([rows[live].long(), a_cat.cols[live].long()]), vals[live], (m, kk),
        check_invariants=False,
    ).coalesce().to_sparse_csr()
    lib = library_device_ms("torch.sparse.mm", lambda: torch.sparse.mm(a_csr, bd))
    lib_c = torch.sparse.mm(a_csr, bd)
    lib_again = torch.sparse.mm(a_csr, bd)
    log(f"spmm: torch.sparse.mm max abs diff from the kernel {float((lib_c - got).abs().max()):.3g}, "
        f"bit-identical between calls: {torch.equal(lib_c, lib_again)}")
    out["spmm"] = (err, ms, plain, lib, 12 * nnz_a + 4 * (kk * n + m * n), 2 * nnz_a * n)

    # densify: the selected B's entries into a (k, n) tile, duplicates summed
    args = (b_cat.rows, b_cat.cols, b_cat.vals, kk, n)
    got, want = densify_cuda(*args), densify_ref(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=DENSIFY_RTOL, atol=1e-7):
        raise AssertionError(f"densify: kernel differs from plain, max abs err {err}")
    ok = (b_cat.rows < kk) & (b_cat.cols < n)
    idx = (b_cat.rows[ok].long(), b_cat.cols[ok].long())
    bv = b_cat.vals[ok]
    ms = device_ms(lambda: densify_cuda(*args), 1, "densify_kernel", 5)
    plain = cuda_ms(lambda: densify_ref(*args), 3)
    lib = library_device_ms("index_put_", lambda: torch.zeros((kk, n), device=bv.device)
                            .index_put_(idx, bv, accumulate=True))
    out["densify"] = (err, ms, plain, lib, 12 * b_cat.cap + 4 * kk * n, b_cat.cap)
    for name, (e, t, pl, lb, nb, ops) in out.items():
        bound, by = bound_ms(nb, ops)
        log(f"{name}: {t:.6f} ms device time (plain {pl:.4f}, library {lb:.4f}), bound "
            f"{bound:.6f} ms ({by}, {nb} B, {ops} ops), {100 * bound / t:.2f} % of bound, "
            f"max abs err {e:.3g}")
    return out


# ---------------------------------------------------------------------------
# 9. the multi-process grid: one process per grid point
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# phase 10: the masked multiply and the §V-B applications
# ---------------------------------------------------------------------------
_TRI = {}


def _tri_init(parts):
    _TRI.update(parts)


def _tri_block(task):
    name, lo, hi = task
    lower, upper = _TRI[name]
    lb = lower[lo:hi]
    return int(round((lb @ upper).multiply(lb).sum()))


class TriangleReference:
    """scipy's exact triangle counts of several graphs, Σ over row blocks r
    of L of ((L[r] @ U) ⊙ L[r]).sum() (the unmasked L·U is never held
    whole), computed in a pool of worker processes while the card works.
    Use as a context manager: the pool ends with it."""

    def __init__(self, graphs, blocks=256):
        import multiprocessing
        import os

        import scipy.sparse as sps

        from repro_torch.core import convert

        parts, tasks, self.stats = {}, [], {}
        for name, g in graphs.items():
            n = g.shape[0]
            r, c, _ = convert.triplets(g)
            s = sps.csr_matrix((np.ones(len(r)), (r, c)), shape=g.shape)
            lower, upper = sps.tril(s, k=-1).tocsr(), sps.triu(s, k=1).tocsr()
            wedges = int((np.bincount(lower.indices, minlength=n).astype(np.int64)
                          * np.diff(upper.indptr)).sum())
            self.stats[name] = (lower.nnz, wedges, int(np.diff(s.indptr).max()))
            parts[name] = (lower, upper)
            edges = np.linspace(0, n, blocks + 1).astype(np.int64)
            tasks += [(name, int(lo), int(hi)) for lo, hi in zip(edges[:-1], edges[1:])]
        self.names = [t[0] for t in tasks]
        workers = max(1, min(8, (os.cpu_count() or 2) - 1))  # a core left to drive the card
        self.pool = multiprocessing.get_context("spawn").Pool(
            workers, initializer=_tri_init, initargs=(parts,))
        self.pending = self.pool.map_async(_tri_block, tasks)

    def count(self, name) -> int:
        return sum(x for nm, x in zip(self.names, self.pending.get()) if nm == name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.pool.terminate()
        self.pool.join()


def scipy_overlap_pairs(a, min_shared):
    """(rows, cols, shared) of A·Aᵀ with row < col and shared ≥ min_shared,
    row-major, by scipy."""
    import scipy.sparse as sps

    from repro_torch.core import convert

    r, c, v = convert.triplets(a)
    s = sps.csr_matrix((v.astype(np.float64), (r, c)), shape=a.shape)
    p = (s @ s.T).tocoo()
    keep = (p.row < p.col) & (p.data >= min_shared)
    rows, cols, vals = p.row[keep], p.col[keep], np.rint(p.data[keep]).astype(np.int64)
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], vals[order]


def budget_for_batches(A, B, grid, spec, least_b):
    """The per-process budget, inputs plus 1/d of the loose plan's
    intermediate bytes for the least d = least_b/2 · 2^i, at which ``spec``
    plans at least ``least_b`` batches (planning only; every rank of a grid
    calls it alike). Returns (budget, plan)."""
    from repro_torch.core.batched import plan_batches
    from repro_torch.core.distsparse import tile_nnz

    from repro_torch.core.symbolic import estimate_mem_c_bytes

    r = spec.r_bytes
    inputs = r * (int(tile_nnz(A, grid).max()) + int(tile_nnz(B, grid).max()))
    loose = plan_batches(A, B, grid, 1 << 62, spec=spec)
    extra = r * loose.max_unmerged_nnz  # the planner's intermediate bytes at b = 1
    if loose.local_path == "hash":
        extra = estimate_mem_c_bytes(loose.max_unmerged_nnz, loose.compression_est, r,
                                     local_path="hash")
    d = max(least_b // 2, 1)
    while True:
        budget = inputs + max(extra // d, 256)
        plan = plan_batches(A, B, grid, budget, spec=spec)
        if plan.num_batches >= least_b:
            return budget, plan
        if extra // d < 256:
            raise RuntimeError(f"no budget plans {least_b} batches for {spec.local_path}")
        d *= 2


def plan_bytes(res, A, B, grid) -> int:
    """The planner's ``plan_footprint`` of the capacities a run used."""
    from repro_torch.core.batched import plan_footprint
    from repro_torch.core.distsparse import tile_nnz

    p = res.plan
    return plan_footprint(p.caps, p.sel_cap, res.hash_caps, r_bytes=12,
                          max_nnz_a=int(tile_nnz(A, grid).max()),
                          max_nnz_b=int(tile_nnz(B, grid).max()))


class ObservedDriver:
    """Wraps graph_algorithms' ``batched_summa3d`` for one run of an entry
    point: keeps the run's ``BatchedResult`` and the peak device memory
    between consecutive consumer calls (the pipeline's lookahead batches
    included; the peak is reset after each), beside the planner's
    ``plan_footprint`` of the plan it ran."""

    def __init__(self, grid):
        self.grid, self.peaks, self.result = grid, [], None

    def __enter__(self):
        import torch

        from repro_torch.sparse_apps import graph_algorithms as ga

        self._real = real = ga.batched_summa3d

        def wrapped(*args, consumer, **kw):
            def consume(bi, x, col_map):
                out = consumer(bi, x, col_map)
                self.peaks.append(torch.cuda.max_memory_allocated(self.grid.device))
                torch.cuda.reset_peak_memory_stats(self.grid.device)
                return out

            torch.cuda.reset_peak_memory_stats(self.grid.device)
            self.result = real(*args, consumer=consume, **kw)
            self.args = args
            return self.result

        ga.batched_summa3d = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.sparse_apps import graph_algorithms as ga

        ga.batched_summa3d = self._real

    def footprint(self):
        return plan_bytes(self.result, *self.args[:2], self.grid)

    def summary(self):
        p = self.result.plan
        return (f"b={p.num_batches}, path {self.result.local_path}, retries "
                f"{self.result.num_retries}, caps {p.caps}, hash_caps {self.result.hash_caps}, "
                f"mask_sel_cap {p.mask_sel_cap}; per-batch peak {max(self.peaks) / 2**30:.3f} "
                f"GiB (min {min(self.peaks) / 2**30:.3f}) against plan_footprint "
                f"{self.footprint() / 2**30:.3f} GiB")


def counted_kernels():
    """Launch counters of the kernels the masked multiply can reach."""
    from repro_torch.kernels import segment_reduce as S, spgemm_binned as Bn
    from repro_torch.kernels import spgemm_hash as H

    return {"hash": H.hash_expand_insert_cuda, "hash_chunk": H.hash_insert_cuda,
            "binned": Bn.spgemm_paired_binned_cuda, "segment_reduce": S.segment_reduce_cuda}


def triangle_operands(g, grid):
    """(A = L, B = U, M = L) of ``graph_algorithms.triangle_count``,
    scattered as it scatters them."""
    from repro_torch.core.distsparse import scatter_to_grid
    from repro_torch.sparse_apps import graph_algorithms as ga

    L, U = ga._strict_parts(g)
    return scatter_to_grid(L, grid, "A"), scatter_to_grid(U, grid, "B"), \
        scatter_to_grid(L, grid, "C")


def triangle_run(g, grid, least_b, label):
    """``triangle_count`` under the budget at which its masked plan has at
    least ``least_b`` batches, with every launch count set to 0 just before
    and read just after. Returns (count, ObservedDriver, launches, wall)."""
    import torch

    from repro_torch.core.specs import PlanSpec
    from repro_torch.sparse_apps import graph_algorithms as ga, mcl

    A, B, M = triangle_operands(g, grid)
    budget, _ = budget_for_batches(A, B, grid, PlanSpec(mask=M), least_b)
    del A, B, M
    counters = counted_kernels()
    for w in counters.values():
        w.launches = 0
    mcl.reset_transfer_bytes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ObservedDriver(grid) as obs:
        count = ga.triangle_count(g, grid, per_process_memory=budget)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in counters.items()}
    moved = mcl.transfer_bytes()
    pr, pc, l = grid.pr, grid.pc, grid.l
    mask_pull = pr * pc * l * (g.shape[1] // pc // l) * 4
    nb = obs.result.plan.num_batches
    if moved > mask_pull + 8 * nb:
        raise AssertionError(f"{label}: {moved} B crossed to the host, more than the mask's "
                             f"count vector ({mask_pull} B) and one scalar a batch")
    log(f"{label}: {count} triangles, budget {budget} B, {obs.summary()}, wall {wall:.2f} s, "
        f"transfer {moved} B (mask counts {mask_pull} B + {nb} scalars), launches {launches}")
    return count, obs, launches, wall


def masked_product(A, B, M, grid, budget, local_path, floor, keep):
    """The masked L·U through ``batched_summa3d`` with ``_batch_value_sum``
    as postprocess (the batch is kept beside its sum when ``keep``), every
    launch count set to 0 just before and read just after. Returns (count,
    result, launches, wall, per-batch peaks, parts)."""
    import torch

    from repro_torch.core import batched, convert, specs
    from repro_torch.sparse_apps import graph_algorithms as ga

    sums, parts, peaks = [], [], []

    def consume(bi, payload, col_map):
        c, s = payload
        sums.append(float(s))
        if keep:
            parts.append(convert.batch_to_global(c, col_map))
        peaks.append(torch.cuda.max_memory_allocated(grid.device))
        torch.cuda.reset_peak_memory_stats(grid.device)

    counters = counted_kernels()
    for w in counters.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(grid.device)
    t0 = time.perf_counter()
    res = batched.batched_summa3d(
        A, B, grid, budget, consume, spec=specs.PlanSpec(mask=M, local_path=local_path),
        floors=specs.PlanFloors(num_batches=floor),
        postprocess=lambda bi, c: (c, ga._batch_value_sum(c, grid)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (int(round(sum(sums))), res, {n: w.launches for n, w in counters.items()}, wall,
            peaks, parts)


def batch0_mask_keys(M, grid, plan):
    """Batch 0's mask keys as the fused step builds them on a 1x1x1 grid:
    the mask's first wbl local columns, sentinel padding, sorted."""
    from repro_torch.core import sortkeys

    tm, wl = M.tile_shape
    wbl = wl // plan.num_batches
    msel, ovf = M.local(*grid.coords).select_col_block(0, wbl, plan.mask_sel_cap)
    assert int(ovf) == 0
    return sortkeys.sorted_mask_keys(msel.rows, msel.cols, msel.valid_mask(), (tm, wbl))


def check_masked_hash(a_cat, b_cat, keys, hc):
    """Phase 10d: the masked fused hash kernel (one launch) against its
    plain version (the chunk loop filtering each chunk by keys_in_sorted,
    in chunks of 2^22 slots: the same slots the kernel covers) on batch 0
    of the pinned hash run: strict for sum/min/max in the planned table
    (same key set, sums within KERNEL_RTOL, min/max exact, no drops), and
    complement for sum in a table sized for its survivors. Then its time
    beside the unmasked kernel's on the same batch (its table sized for
    every distinct key), with the bound. Both are timed with CUDA events
    around each launch, mean of 10 (each launch takes milliseconds, so the
    host's launch gap is under a thousandth of it): late in a full run
    torch.profiler recorded no device event in these windows, 4 times in a
    row. Returns a dict of numbers."""
    import torch

    from repro_torch.core import local_spgemm, semiring as sr, symbolic
    from repro_torch.kernels import spgemm_hash as H

    dev = a_cat.device
    x, total = local_spgemm.hash_expansion(a_cat, b_cat)
    limit = hc.num_chunks * hc.chunk_cap
    chunk = 1 << 22
    nchunks = -(-limit // chunk)

    def run(fn, xx, table_cap, semi, cc, nc):
        tk = torch.full((table_cap,), H.EMPTY, dtype=torch.int32, device=dev)
        tv = torch.full((table_cap,), H.table_init_val(semi.add_kind), device=dev)
        dropped = torch.zeros((), dtype=torch.int32, device=dev)
        fn(tk, tv, dropped, xx, cc, nc, semiring=semi, max_probes=hc.max_probes)
        skey, perm = torch.sort(tk)
        return skey, tv[perm], int(dropped)

    def table_for(distinct):
        return symbolic.rup_pow2(max(int(symbolic.HASH_LOAD_FACTOR * distinct), 64))

    unmasked_keys = run(H.hash_expand_insert_cuda, x, table_for(int(total)), sr.PLUS_TIMES,
                        chunk, nchunks)
    distinct_all = int((unmasked_keys[0] != H.EMPTY).sum())
    max_err, out = 0.0, {}
    cases = [(semi, "strict", hc.table_cap) for semi in (sr.PLUS_TIMES, sr.MIN_PLUS, sr.MAX_TIMES)]
    cases.append((sr.PLUS_TIMES, "complement", table_for(distinct_all)))
    for semi, mode, table_cap in cases:
        xm = x._replace(mask_keys=keys, mask_mode=mode)
        (kk, kv, kd) = run(H.hash_expand_insert_cuda, xm, table_cap, semi, chunk, nchunks)
        (pk, pv, pd) = run(H.hash_expand_insert_ref, xm, table_cap, semi, chunk, nchunks)
        kind = semi.add_kind
        if kd or pd:
            raise AssertionError(f"masked hash {mode} {kind}: drops {kd} {pd}")
        if not torch.equal(kk, pk):
            raise AssertionError(f"masked hash {mode} {kind}: key sets differ")
        live = kk != H.EMPTY
        diff = (kv[live] - pv[live]).abs()
        err = float(diff.max()) if bool(live.any()) else 0.0
        max_err = max(max_err, err)
        ok = (bool((diff <= KERNEL_RTOL * pv[live].abs()).all()) if kind == "sum"
              else torch.equal(kv[live], pv[live]))
        if not ok:
            raise AssertionError(f"masked hash {mode} {kind}: values differ, max {err}")
        log(f"masked fused hash {mode} {kind}: table {table_cap}, {int(live.sum())} of "
            f"{distinct_all} keys kept, {int(total)} partial products, max abs err {err:.3g}")
        out[f"{mode}_keys"] = int(live.sum())

    tk = torch.empty((hc.table_cap,), dtype=torch.int32, device=dev)
    tv = torch.empty((hc.table_cap,), device=dev)
    big = table_for(distinct_all)
    tk_all = torch.empty((big,), dtype=torch.int32, device=dev)
    tv_all = torch.empty((big,), device=dev)
    dropped = torch.zeros((), dtype=torch.int32, device=dev)
    xm = x._replace(mask_keys=keys, mask_mode="strict")

    def reset():
        for t, v in ((tk, H.EMPTY), (tv, 0.0), (tk_all, H.EMPTY), (tv_all, 0.0)):
            t.fill_(v)

    masked = lambda: H.hash_expand_insert_cuda(tk, tv, dropped, xm, hc.chunk_cap,
                                               hc.num_chunks, semiring=sr.PLUS_TIMES,
                                               max_probes=hc.max_probes)
    unmasked = lambda: H.hash_expand_insert_cuda(tk_all, tv_all, dropped, x, hc.chunk_cap,
                                                 hc.num_chunks, semiring=sr.PLUS_TIMES,
                                                 max_probes=hc.max_probes)
    reset()
    masked()
    unmasked()
    ms = cuda_ms(masked, 10, reset)
    ms_all = cuda_ms(unmasked, 10, reset)
    plain = cuda_ms(lambda: H.hash_expand_insert_ref(tk, tv, dropped, xm, chunk, nchunks,
                                                     semiring=sr.PLUS_TIMES,
                                                     max_probes=hc.max_probes), 1, reset)
    # as the unmasked bound (phase 4), plus the mask keys read once; only
    # the kept keys' slots are touched
    cnt = x.cum - torch.cat([x.cum.new_zeros(1), x.cum[:-1]])
    touched = torch.unique(x.b_cols[cnt > 0]).long()
    a_needed = int((x.colptr[touched + 1] - x.colptr[touched]).sum())
    base = 8 * a_needed + 8 * touched.numel() + 16 * x.cum.numel()
    nbytes = base + 16 * out["strict_keys"] + 4 * keys.numel()
    flops = min(int(total), limit)
    bound, by = bound_ms(nbytes, 2 * flops)
    bound_all, by_all = bound_ms(base + 16 * distinct_all, 2 * flops)
    log(f"masked fused hash: {ms:.6f} ms per batch, CUDA events ({flops} partial products, "
        f"{keys.numel()} mask keys), unmasked on the same batch {ms_all:.6f} ms (bound "
        f"{bound_all:.6f} ms, {by_all}); plain {plain:.3f} ms; bound {bound:.6f} ms ({by}), "
        f"{100 * bound / ms:.2f} % of bound")
    out.update(max_abs_err=max_err, ms=ms, unmasked_ms=ms_all, plain_ms=plain, bound_ms=bound,
               bound_by=by, unmasked_bound_ms=bound_all, flops=flops, mask_keys=keys.numel())
    return out


def masked_phase(grid):
    """Phase 10 (one card): the exact triangle count at R-MAT scale
    TRI_SCALE through ``triangle_count``; the masked L·U at scale
    TRI_PINNED_SCALE pinned to ESC (twice, bit for bit) and to hash (one
    fused launch a batch) against its count and the unmasked plans; the
    overlap pairs of a k-mer matrix with and without a candidate mask
    against scipy; and the masked fused kernel against its plain version on
    batch 0 of the hash run. Returns the hash row's "masked" entry."""
    from repro_torch.core import gen

    t_phase = time.perf_counter()
    graphs = {scale: gen.symmetrized(gen.rmat(scale, edge_factor=16, seed=5, device=grid.device))
              for scale in (TRI_SCALE, TRI_PINNED_SCALE)}
    with TriangleReference(graphs) as ref:
        log(f"10: graphs and the scipy pool started, {time.perf_counter() - t_phase:.1f} s")
        out = _masked_triangles(grid, graphs, ref)
    _masked_overlap(grid)
    log(f"phase 10: {time.perf_counter() - t_phase:.1f} s")
    return out


def _masked_triangles(grid, graphs, ref):
    """Phase 10a, b and d (see ``masked_phase``)."""
    import torch

    from repro_torch.core import specs, summa3d
    from repro_torch.core.batched import plan_batches, probe_memory_budget

    out = {}
    # 10a. triangle_count, default path, at scale TRI_SCALE
    t0 = time.perf_counter()
    g = graphs.pop(TRI_SCALE)
    n = g.shape[0]
    nnz_l, wedges, top = ref.stats[TRI_SCALE]
    log(f"10a: R-MAT scale {TRI_SCALE}: n={n}, {int(g.nnz)} nnz, {nnz_l} in L, {wedges} wedges "
        f"(partial products of L·U), top degree {top}")
    floor = hash_batch_floor(n, (1, 1, 1))
    count, obs, launches, wall = triangle_run(g, grid, floor, f"10a triangle_count scale "
                                              f"{TRI_SCALE}")
    rp = obs.result
    want = ref.count(TRI_SCALE)
    log(f"10a: scipy {want} triangles, waited for by {time.perf_counter() - t0:.1f} s")
    if count != want:
        raise AssertionError(f"10a: triangle_count {count} != scipy {want}")
    if rp.num_retries or (rp.local_path == "hash" and launches["hash"] != rp.plan.num_batches):
        raise AssertionError(f"10a: retries {rp.num_retries}, launches {launches}")
    out["launches"] = launches["hash"]
    # the reference's plan claim at its probe budget (planning only)
    A, B, M = triangle_operands(g, grid)
    ppm = probe_memory_budget(A, B, grid)
    pu = plan_batches(A, B, grid, ppm, spec=specs.PlanSpec(local_path="esc"))
    pm = plan_batches(A, B, grid, ppm, spec=specs.PlanSpec(mask=M, local_path="esc"))
    log(f"10a plans at the probe budget {ppm} B, esc: unmasked b={pu.num_batches} {pu.caps}; "
        f"masked b={pm.num_batches} {pm.caps}")
    if not (pm.num_batches < pu.num_batches and pm.caps.d_cap < pu.caps.d_cap
            and pm.caps.c_cap < pu.caps.c_cap):
        raise AssertionError("10a: the masked plan must have fewer batches and smaller caps")
    del g, A, B, M
    torch.cuda.empty_cache()
    log(f"10a: {time.perf_counter() - t0:.1f} s")

    # 10b. the masked product pinned to ESC and hash, at TRI_PINNED_SCALE
    t0 = time.perf_counter()
    g = graphs.pop(TRI_PINNED_SCALE)
    n = g.shape[0]
    want = out["tri16"] = ref.count(TRI_PINNED_SCALE)
    nnz_l, wedges, _ = ref.stats[TRI_PINNED_SCALE]
    A, B, M = triangle_operands(g, grid)
    floor = max(hash_batch_floor(n, (1, 1, 1)), PINNED_LEAST_B)
    budget, _ = budget_for_batches(A, B, grid, specs.PlanSpec(mask=M, local_path="esc"), floor)
    log(f"10b: scale {TRI_PINNED_SCALE}: {nnz_l} in L, {wedges} wedges, scipy {want} "
        f"triangles; budget {budget} B, at least {floor} batches")
    runs = {}
    for label, lp, keep in (("esc", "esc", True), ("esc again", "esc", True),
                            ("hash", "hash", False)):
        cnt, res, la, w, peaks, parts = masked_product(A, B, M, grid, budget, lp, floor, keep)
        unmasked = plan_batches(A, B, grid, budget, spec=specs.PlanSpec(local_path=lp),
                                floors=specs.PlanFloors(num_batches=floor))
        p = res.plan
        fp = plan_bytes(res, A, B, grid)
        log(f"10b {label}: {cnt} triangles, b={p.num_batches}, retries {res.num_retries}, "
            f"wall {w:.2f} s, launches {la}; masked plan {p.caps} {res.hash_caps} "
            f"mask_sel_cap {p.mask_sel_cap}; unmasked plan b={unmasked.num_batches} "
            f"{unmasked.caps} {unmasked.hash_caps}; per-batch peak {max(peaks) / 2**30:.3f} "
            f"GiB against plan_footprint {fp / 2**30:.3f} GiB")
        if cnt != want or res.num_retries:
            raise AssertionError(f"10b {label}: count {cnt} (scipy {want}), retries "
                                 f"{res.num_retries}")
        if not (p.caps.d_cap < unmasked.caps.d_cap and p.caps.c_cap < unmasked.caps.c_cap
                and p.num_batches <= unmasked.num_batches):
            raise AssertionError(f"10b {label}: the masked plan must not exceed the unmasked")
        if lp == "hash" and (la["hash"] != p.num_batches or la["hash_chunk"]):
            raise AssertionError(f"10b hash: one fused launch a batch: {la}")
        if lp == "esc" and la["segment_reduce"] < p.num_batches:
            raise AssertionError(f"10b esc: the segment reduction must sum every batch: {la}")
        runs[label] = (res, parts)
        out["launches"] += la["hash"]
    if not same_parts(runs["esc"][1], runs["esc again"][1]):
        raise AssertionError("10b: the second ESC run gave other bits")
    log("10b: the second ESC run repeated the first bit for bit")
    for label in ("esc", "hash"):  # where a masked batch's device time goes
        res = runs[label][0]
        p = res.plan
        step = (lambda p=p, res=res: summa3d.summa3d_fused_step(
            A, B, 0, None, M, grid=grid, num_batches=p.num_batches, sel_cap=p.sel_cap,
            caps=p.caps, hashc=res.hash_caps, mask_cap=p.mask_sel_cap))
        step()
        profile_top(f"10b {label} batch 0, masked fused step", step, rows=10)
    log(f"10b: {time.perf_counter() - t0:.1f} s")

    # 10d. the masked fused kernel against its plain version, batch 0 of the hash run
    t0 = time.perf_counter()
    rh = runs["hash"][0]
    a_cat, b_cat = batch0_operands(A, B, grid, rh.plan)
    keys = batch0_mask_keys(M, grid, rh.plan)
    out.update(check_masked_hash(a_cat, b_cat, keys, rh.hash_caps))
    log(f"10d: {time.perf_counter() - t0:.1f} s")
    del runs, a_cat, b_cat, keys, A, B, M, g
    torch.cuda.empty_cache()
    return out


def _masked_overlap(grid):
    """Phase 10c (see ``masked_phase``)."""
    import torch

    from repro_torch.core import gen, specs
    from repro_torch.core.distsparse import scatter_to_grid
    from repro_torch.core.sparse import from_numpy_coo
    from repro_torch.sparse_apps import graph_algorithms as ga

    # 10c. overlap detection on a k-mer matrix, without and with candidates
    t0 = time.perf_counter()
    a = gen.kmer_like(*KMER, seed=17, device=grid.device)
    nseqs = a.shape[0]
    wr, wc, wv = scipy_overlap_pairs(a, 2)
    log(f"10c: k-mers {KMER}: {int(a.nnz)} entries, scipy {len(wr)} pairs with >= 2 shared, "
        f"set-up {time.perf_counter() - t0:.1f} s")
    A = scatter_to_grid(a, grid, "A")
    B = scatter_to_grid(a.transpose().sort_rowmajor(), grid, "B")
    rng = np.random.default_rng(23)
    cr = np.concatenate([wr, rng.integers(0, nseqs, len(wr))])
    cc = np.concatenate([wc, rng.integers(0, nseqs, len(wr))])
    cands = from_numpy_coo(cr, cc, np.ones(len(cr), np.float32), (nseqs, nseqs),
                           device=grid.device)
    M = scatter_to_grid(cands, grid, "C")
    budget_u, _ = budget_for_batches(A, B, grid, specs.PlanSpec(), KMER_LEAST_B)
    budget_m, _ = budget_for_batches(A, B, grid, specs.PlanSpec(mask=M),
                                     hash_batch_floor(nseqs, (1, 1, 1)))
    del A, B, M
    want = list(zip(wr.tolist(), wc.tolist(), wv.tolist()))
    for label, budget, cand in (("without candidates", budget_u, None),
                                ("with candidates", budget_m, cands)):
        t1 = time.perf_counter()
        with ObservedDriver(grid) as obs:
            got = ga.overlap_pairs(a, grid, min_shared=2, per_process_memory=budget,
                                   candidates=cand)
        torch.cuda.synchronize()
        log(f"10c overlap_pairs {label}: {len(got)} pairs, budget {budget} B, "
            f"{obs.summary()}, wall {time.perf_counter() - t1:.2f} s")
        if got != want or obs.result.num_retries:
            raise AssertionError(f"10c {label}: {len(got)} pairs, scipy {len(want)}; retries "
                                 f"{obs.result.num_retries}")
    log(f"10c: {time.perf_counter() - t0:.1f} s")


def product_tile(key, n, grid):
    """Which of C's entries (row-major keys) lie in this rank's C tile: rows
    of row block i, columns of layer slice k of column block j."""
    i, j, k = grid.coords
    w = n // grid.pc
    r, c = key // n, key % n
    return (r // (n // grid.pr) == i) & (c // w == j) & (c % w // (w // grid.l) == k)


def nccl_share(prof, rows=5):
    """(NCCL kernels' device ms, all device ms, the ``rows`` device ops
    with the most time as (name, ms)) in a torch.profiler run."""
    from torch.autograd import DeviceType

    per = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            per[ev.name[:80]] = per.get(ev.name[:80], 0.0) + ev.time_range.elapsed_us() / 1e3
    nccl = sum(ms for name, ms in per.items() if "nccl" in name.lower())
    return nccl, sum(per.values()), sorted(per.items(), key=lambda kv: -kv[1])[:rows]


def hash_batch_floor(n, shape):
    """The least b at which the hash path's packed (row, column) keys of a
    (n/pr) x (n/pc/b) product tile fit in i32 (``sortkeys.fits_i32``)."""
    from repro_torch.core import sortkeys

    tm, tn = n // shape[0], n // shape[1]
    b = 1
    while not sortkeys.fits_i32(tm, tn // b):
        b *= 2
    return b


def run_grid_multiply(A, B, grid, budget, local_path, profile):
    """One batched_summa3d run on a rank, keeping its tile of every batch in
    global coordinates and the host time each batch was consumed; with
    ``profile``, under torch.profiler. The hash path plans at least
    ``hash_batch_floor`` batches. Returns (result, wall s, batch walls s,
    parts, ``nccl_share`` of the run or None)."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile as profiler

    from repro_torch.core import batched, convert, specs

    parts, stamps = [], []

    def consume(bi, cb, cm):
        parts.append(convert.batch_to_global(cb, cm))
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    ctx = (profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profile
           else contextlib.nullcontext())
    floor = hash_batch_floor(A.shape[0], (grid.pr, grid.pc, grid.l)) if local_path == "hash" else 1
    t0 = time.perf_counter()
    with ctx as prof:
        res = batched.batched_summa3d(A, B, grid, budget, consumer=consume,
                                      spec=specs.PlanSpec(local_path=local_path),
                                      floors=specs.PlanFloors(num_batches=floor))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, np.diff([t0] + stamps), parts, nccl_share(prof) if profile else None


def grid_rank(grid, n, budget, with_mcl, tri_scale, p11, p13, ckpt_dir=None):
    """One rank of the distributed phase (spawned, one process per grid
    point). On each of GRID_SHAPES (the launcher's grid, then the others
    built in the same process group): this rank's tile of C = A·A on the
    ESC path twice and on the hash path once, under ``budget`` bytes per
    process, each held against scipy's A @ A on the tile's rows and
    columns (structure identical, values within VALUE_RTOL) and the second
    ESC run against the first bit for bit, then ``triangle_count`` of the
    R-MAT graph of scale ``tri_scale`` (at least GRID_TRI_LEAST_B batches
    and as many as its i32 mask keys need), which rank 0 first counts on a
    1x1x1 grid of its own card. Rank 0 profiles the second ESC
    run. With ``with_mcl``, then the sparse n = 2^18 MCL device loop on
    the launcher's grid, which rank 0 first runs on a 1x1x1 grid of its
    own card and holds the grid's loop against, and then 12d: the same
    loop through ``mcl_iterate_resilient`` into ``ckpt_dir``, preempted
    mid-iteration (``resilient_grid_rank``). Then phase 11's parts on the
    grid (``phase11_rank``) and phase 13's (``phase13_rank``). Returns per shape and run the pickled plan, b,
    wall, per-batch walls, launches and checks."""
    import pickle

    import torch
    import torch.distributed as dist

    from repro_torch.core import gen
    from repro_torch.core.distsparse import scatter_to_grid
    from repro_torch.core.grid import make_grid
    from repro_torch.kernels import segment_reduce as S, spgemm_hash as H
    from repro_torch.sparse_apps import mcl

    a = gen.protein_similarity_like(n, blocks=n // 64, intra_p=0.12, seed=0, device=grid.device)
    t0 = time.perf_counter()
    ref_key, ref_val = scipy_square(a)
    if grid.rank == 0:
        log(f"  grid rank 0: n={n}, scipy A @ A {time.perf_counter() - t0:.1f} s")
    counted = {"hash_insert": H.hash_expand_insert_cuda, "segment_reduce": S.segment_reduce_cuda}
    out = {}
    tri = gen.symmetrized(gen.rmat(tri_scale, edge_factor=16, seed=5, device=grid.device))
    if grid.rank == 0:
        one = make_grid(1, 1, 1, device=grid.device)
        out["tri_one_card"] = triangle_run(
            tri, one, hash_batch_floor(tri.shape[0], (1, 1, 1)),
            f"  grid rank 0: triangle_count scale {tri_scale}, one card")[0]
    for shape in GRID_SHAPES:
        g = grid if shape == (grid.pr, grid.pc, grid.l) else make_grid(*shape, device=grid.device)
        A, B = scatter_to_grid(a, g, "A"), scatter_to_grid(a, g, "B")
        mine = product_tile(ref_key, n, g)
        ref = (ref_key[mine], ref_val[mine])
        runs, esc_parts = {}, None
        for label, lp in (("esc", "esc"), ("esc again", "esc"), ("hash", "hash")):
            for w in counted.values():
                w.launches = 0
            dist.barrier()
            res, wall, batch_s, parts, share = run_grid_multiply(
                A, B, g, budget, lp, profile=g.rank == 0 and label == "esc again")
            runs[label] = {
                "plan": pickle.dumps(res.plan), "b": res.plan.num_batches,
                "retries": res.num_retries, "wall": wall, "batch_s": batch_s,
                "launches": {name: w.launches for name, w in counted.items()},
                "max_rel_err": check_product(parts, ref, n), "entries": len(ref[0]),
                "share": share,
            }
            if g.rank == 0:
                log(f"  grid {shape} {label}, rank 0: b={res.plan.num_batches}, wall {wall:.2f} s")
            if label == "esc":
                esc_parts = parts
            elif label == "esc again":
                runs[label]["bit_identical"] = same_parts(esc_parts, parts)
            del parts
        dist.barrier()
        least = max(hash_batch_floor(tri.shape[0], shape), GRID_TRI_LEAST_B)
        count, obs, launches, wall = triangle_run(
            tri, g, least, f"  grid {shape} rank {g.rank}: triangle_count scale {tri_scale}")
        runs["triangles"] = {
            "plan": pickle.dumps(obs.result.plan), "b": obs.result.plan.num_batches,
            "retries": obs.result.num_retries, "wall": wall, "count": count,
            "path": obs.result.local_path, "launches": {"hash_insert": launches["hash"]},
            "peak": max(obs.peaks), "footprint": obs.footprint(),
        }
        out[shape] = runs
        del A, B, esc_parts
        torch.cuda.empty_cache()
    if with_mcl:
        a, cfg = mcl_sparse_input()
        one = None
        if grid.rank == 0:
            one = run_mcl(mcl.mcl_iterate, a, make_grid(1, 1, 1, device=grid.device), cfg,
                          "mcl sparse n=2^18, one card (rank 0)")
        dist.barrier()
        fin, hist, wall, peak, launches = run_mcl(
            mcl.mcl_iterate, a, grid, cfg, f"mcl sparse n=2^18, grid {grid.pr}x{grid.pc}x"
                                           f"{grid.l}, rank {grid.rank}")
        out["mcl"] = {"wall": wall, "peak": peak, "launches": launches,
                      "nnz": [h["nnz"] for h in hist], "batches": [h["batches"] for h in hist]}
        if one is not None:
            compare_loops("mcl sparse n=2^18, grid vs one card", hist, one[1],
                          partition(fin, N_MCL), partition(one[0], N_MCL), chaos_rtol=CHAOS_RTOL)
            check_mcl_matrix(fin, cfg.max_per_col)
            out["mcl"].update(one_card_wall=one[2], one_card_batches=[
                h["batches"] for h in one[1]])
        del one
        out["mcl_resilient"] = resilient_grid_rank(grid, a, cfg, (fin, hist, wall, peak),
                                                   ckpt_dir)
    out["p11"] = phase11_rank(grid, p11, tri)
    out["p13"] = phase13_rank(grid, p13)
    return out


def grid_phase(n, backend, with_mcl, tri_scale, p11, p13):
    """Phase 9: ``grid_rank`` on four ranks, one per grid point, over
    ``backend`` (gloo: all four on this card; nccl: one per card). Checks
    that every rank planned the same batches, that the second ESC run of
    every rank repeated the first bit for bit, that the hash kernel
    launched once a batch and the segment reduction at least once a batch
    on every rank, and that every rank counted the one-card triangle count
    under the same masked plan; logs per rank and shape the wall, the batch
    walls and b; then phase 11's and 13's records (``log_phase11_ranks``,
    ``log_phase13_ranks``). Returns the per-rank launches of the two
    kernels, by shape and run, the dense step's densify/SpMM launches per
    rank and the serving engine's segment reduction launches per rank."""
    from repro_torch.launch import spawn

    t0 = time.perf_counter()
    workdir = Path(__file__).resolve().parent / "build"
    workdir.mkdir(exist_ok=True)
    budget = GRID_BUDGET * n // N_GRID
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_12d_") if with_mcl else None
    try:
        ranks = spawn.run(grid_rank, GRID_SHAPES[0], backend=backend, device="cuda",
                          args=(n, budget, with_mcl, tri_scale, p11, p13, ckpt_dir),
                          timeout_s=GRID_TIMEOUT_S, workdir=workdir)
    finally:
        if ckpt_dir is not None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    launches = {}
    want = ranks[0]["tri_one_card"]
    for shape in GRID_SHAPES:
        tag = "x".join(map(str, shape))
        per = [r[shape]["triangles"] for r in ranks]
        if any(x["plan"] != per[0]["plan"] for x in per):
            raise AssertionError(f"grid {tag} triangles: the ranks planned different batches")
        b = per[0]["b"]
        counts = [x["launches"]["hash_insert"] for x in per]
        if ([x["count"] for x in per] != [want] * len(per) or any(x["retries"] for x in per)
                or (per[0]["path"] == "hash" and counts != [b] * len(per))):
            raise AssertionError(f"grid {tag} triangles: counts {[x['count'] for x in per]} "
                                 f"(one card {want}), retries {[x['retries'] for x in per]}, "
                                 f"hash launches {counts}, b = {b}")
        launches[(tag, "triangles")] = counts
        log(f"grid {tag} triangle_count scale {tri_scale} ({backend}): {want} triangles on "
            f"every rank, as on one card; b={b}, path {per[0]['path']}, hash launches per "
            f"rank {counts}; walls {[round(x['wall'], 3) for x in per]} s; per-batch peak "
            f"{max(x['peak'] for x in per) / 2**30:.3f} GiB against plan_footprint "
            f"{per[0]['footprint'] / 2**30:.3f} GiB")
        for label in ("esc", "esc again", "hash"):
            per = [r[shape][label] for r in ranks]
            if any(x["plan"] != per[0]["plan"] for x in per):
                raise AssertionError(f"grid {tag} {label}: the ranks planned different batches")
            b = per[0]["b"]
            kernel = "hash_insert" if label == "hash" else "segment_reduce"
            counts = [x["launches"][kernel] for x in per]
            if (label == "hash" and counts != [b] * len(per)) or min(counts) < b:
                raise AssertionError(f"grid {tag} {label}: {kernel} launches {counts}, b = {b}")
            if label == "esc again" and not all(x["bit_identical"] for x in per):
                raise AssertionError(f"grid {tag}: a rank's second ESC run gave other bits")
            launches[(tag, label)] = counts
            log(f"grid {tag} n={n} {label} ({backend}): b={b}, retries "
                f"{[x['retries'] for x in per]}, {kernel} launches per rank {counts}")
            for r, x in enumerate(per):
                bs = x["batch_s"]
                extra = ""
                if x["share"] is not None:
                    nccl, dev, top = x["share"]
                    extra = (f"; profiled: device {dev:.1f} ms ({100 * dev / 1e3 / x['wall']:.1f} "
                             f"% of wall), NCCL kernels {nccl:.1f} ms ({100 * nccl / dev:.1f} "
                             f"% of device time); top: "
                             + "; ".join(f"{name} {ms:.1f} ms" for name, ms in top))
                log(f"  rank {r}: wall {x['wall']:.3f} s, a batch consumed every "
                    f"{1e3 * bs.mean():.2f} ms (min {1e3 * bs.min():.2f}, max "
                    f"{1e3 * bs.max():.2f}; the first also waits for the plan), {x['entries']} "
                    f"entries of C, max rel err {x['max_rel_err']:.3g}{extra}")
    if with_mcl:
        for r, x in enumerate(ranks):
            m = x["mcl"]
            log(f"grid mcl rank {r}: wall {m['wall']:.2f} s, peak {m['peak'] / 2**30:.3f} GiB, "
                f"nnz {m['nnz']}, b {m['batches']}, launches {m['launches']}"
                + (f"; one card: wall {m['one_card_wall']:.2f} s, b {m['one_card_batches']}"
                   if "one_card_wall" in m else ""))
        check_resilient_grid([x["mcl_resilient"] for x in ranks], backend)
    dense_launches = log_phase11_ranks(ranks, backend)
    serve_launches = log_phase13_ranks(ranks, backend)
    log(f"phase 9 ({backend}, n={n}): {time.perf_counter() - t0:.1f} s")
    return launches, dense_launches, serve_launches


# ---------------------------------------------------------------------------
# phase 11: the SUMMA3D steps outside the fused step, placement, the tuner
# ---------------------------------------------------------------------------
def dense_counters():
    """Launch counters of the dense step's two kernels."""
    from repro_torch.kernels import densify_kernel as D, spmm_kernel as S

    return {"densify": D.densify_cuda, "spmm": S.spmm_cuda}


def batch_block(B, grid, nb, bi):
    """Batch ``bi`` of ``nb`` of B on this rank: the block-cyclic column
    block the driver's selection makes (kind "B", global (k, n/nb))."""
    from repro_torch.core.distsparse import from_tile

    sel, ovf = B.local(*grid.coords).select_cols_blockcyclic(bi, nb, grid.l, new_cap=B.cap)
    if int(ovf):
        raise AssertionError(f"batch {bi} of {nb}: the selection overflowed by {int(ovf)}")
    return from_tile(sel, (B.shape[0], B.shape[1] // nb), grid, "B")


def tile_reference(ref, n, grid, nb, bi):
    """scipy's entries of A @ A in this rank's C tile of batch ``bi`` of
    ``nb``: (local rows, local columns, values), row-major."""
    from repro_torch.core.batched import batch_column_map

    key, val = ref
    _, j, k = grid.coords
    cmap = batch_column_map(n, grid, nb, bi)[j, k]
    local = np.full(n, -1, np.int64)
    local[cmap] = np.arange(len(cmap))
    tm = n // grid.pr
    r, c = key // n, key % n
    keep = (r // tm == grid.coords[0]) & (local[c] >= 0)
    return r[keep] - grid.coords[0] * tm, local[c[keep]], val[keep]


def batch_reference(ref, n, grid, nb, bi):
    """scipy's (keys, values) of A @ A in the columns of batch ``bi`` of
    ``nb`` (on a single-row grid, which holds whole columns)."""
    from repro_torch.core.batched import batch_column_map

    cols = np.zeros(n, bool)
    cols[batch_column_map(n, grid, nb, bi).ravel()] = True
    keep = cols[ref[0] % n]
    return ref[0][keep], ref[1][keep]


def check_dense_tile(tile, entries) -> float:
    """A dense C tile against scipy's entries in it (``tile_reference``):
    the same nonzeros, values within VALUE_RTOL. Returns the max relative
    error."""
    import torch

    lr, lc, v = entries
    t = tile.reshape(tile.shape[-2], tile.shape[-1])
    nz = int(torch.count_nonzero(t))
    if nz != len(v):
        raise AssertionError(f"dense tile: {nz} nonzeros, scipy {len(v)}")
    if not len(v):
        return 0.0
    dev = t.device
    got = t[torch.as_tensor(lr, device=dev), torch.as_tensor(lc, device=dev)]
    want = torch.as_tensor(v, device=dev)
    err = float(((got - want).abs() / want.abs()).max())
    if not err <= VALUE_RTOL:
        raise AssertionError(f"dense tile: max rel err {err} against scipy")
    return err


def dense_step_run(A, Bb, grid, schedule):
    """One ``summa3d_dense_step`` with the densify and SpMM launch counts
    set to 0 just before and read just after. Returns (tile, wall s, the
    step's peak bytes above what was allocated before it, launches)."""
    import torch

    from repro_torch.core.summa3d import summa3d_dense_step

    counters = dense_counters()
    dev = grid.device
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    for w in counters.values():
        w.launches = 0
    t0 = time.perf_counter()
    c = summa3d_dense_step(A, Bb, grid, schedule=schedule)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    return c, wall, peak, {name: w.launches for name, w in counters.items()}


def dense_steps(a, grid, nb, ref):
    """11a's dense step on ``grid``: batch 0 of ``nb`` under "allgather"
    and "ring", each run twice (the first also pays for setting up its
    collectives: the ring's first shifts are the first point-to-point
    traffic of their subgroups), each tile held against scipy's, the
    ring's against allgather's (rtol DENSE_RTOL: the stages add in another
    order). Each launches densify and SpMM once per stage: once
    (allgather) or pc times (ring). Returns {schedule: record, the second
    run's wall and peak} and the ring's relative distance."""
    import torch

    from repro_torch.core.distsparse import scatter_to_grid

    n = a.shape[0]
    A, B = scatter_to_grid(a, grid, "A"), scatter_to_grid(a, grid, "B")
    Bb = batch_block(B, grid, nb, 0)
    del B
    entries = tile_reference(ref, n, grid, nb, 0)
    out, tiles = {}, {}
    for schedule in ("allgather", "ring"):
        first = dense_step_run(A, Bb, grid, schedule)[1]
        c, wall, peak, launches = dense_step_run(A, Bb, grid, schedule)
        stages = grid.pc if schedule == "ring" else 1
        if launches != {"densify": stages, "spmm": stages}:
            raise AssertionError(f"dense step {schedule}: launches {launches}, want {stages} each")
        out[schedule] = {"first_wall": first, "wall": wall, "peak": peak, "launches": launches,
                         "max_rel_err": check_dense_tile(c, entries)}
        tiles[schedule] = c
    g, r = tiles["allgather"], tiles["ring"]
    dist = float(((r - g).abs() / g.abs().clamp_min(torch.finfo(torch.float32).tiny)).max())
    if not dist <= DENSE_RTOL:
        raise AssertionError(f"dense step: ring vs allgather max rel {dist}")
    return out, dist


def log_dense(label, rec, dist):
    log(f"{label}: ring vs allgather max rel {dist:.3g}; " + "; ".join(
        f"{s} wall {x['wall']:.3f} s (first run {x['first_wall']:.3f} s), step peak "
        f"{x['peak'] / 2**30:.3f} GiB, launches "
        f"{x['launches']}, max rel err vs scipy {x['max_rel_err']:.3g}" for s, x in rec.items()))


def check_spmm_accumulate(a, n):
    """SpMM's accumulate mode against its plain version at the shape of the
    2x2x1 ring's second stage on grid point (0, 0): C (its first stage,
    A(0,0)·B(0,0)) += A(0,1)·B(1,0), each an (n/2 x n/2) block of ``a``;
    and ``addmm_`` with A(0,1) in CSR (cuSPARSE, C += A·B) as the library
    call. The bound counts this stage's own data: A's entries once, the
    rows of B that A's columns name once, and the rows of C that A's rows
    name read and written once. Returns (max rel err, ms, plain ms,
    library ms, bytes, flops)."""
    import torch

    from repro_torch.core import convert
    from repro_torch.kernels import densify_kernel as D, spmm_kernel as S

    h = n // 2
    r, c, v = (torch.as_tensor(x, device=a.device) for x in convert.triplets(a))

    def block(i, j):
        keep = (r // h == i) & (c // h == j)
        return (r[keep] - i * h).int(), (c[keep] - j * h).int(), v[keep].contiguous()

    a00, a01 = block(0, 0), block(0, 1)
    b00, b10 = (D.densify_ref(*block(i, 0), h, h) for i in (0, 1))
    acc = S.spmm_cuda(*a00, b00, h)
    got = S.spmm_cuda(*a01, b10, h, out=acc.clone())
    want = S.spmm_ref(*a01, b10, h, chunk=4096, out=acc.clone())
    err = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
    if not err <= KERNEL_RTOL:
        raise AssertionError(f"spmm accumulate: max rel err {err} against the plain version")
    if not torch.equal(S.spmm_cuda(*a01, b10, h, out=acc.clone()), got):
        raise AssertionError("spmm accumulate: a second call gave other bits")
    out = acc.clone()
    ms = device_ms(lambda: S.spmm_cuda(*a01, b10, h, out=out), 1, "spmm_tile_kernel", 5)
    events = cuda_ms(lambda: S.spmm_cuda(*a01, b10, h, out=out), reps=5)
    plain = cuda_ms(lambda: S.spmm_ref(*a01, b10, h, chunk=4096, out=out), reps=1)
    a_csr = torch.sparse_coo_tensor(torch.stack([a01[0].long(), a01[1].long()]), a01[2],
                                    (h, h), check_invariants=False).coalesce().to_sparse_csr()
    lib_c = acc.clone().addmm_(a_csr, b10)
    lib = library_device_ms("addmm_ (CSR)", lambda: out.addmm_(a_csr, b10))
    nnz = a01[0].numel()
    rows_a, cols_a = int(a01[0].unique().numel()), int(a01[1].unique().numel())
    nbytes = 12 * nnz + 4 * h * cols_a + 8 * h * rows_a
    log(f"spmm accumulate (C += A·B, {nnz} entries in {rows_a} rows and {cols_a} columns "
        f"x {h}x{h}): max rel err {err:.3g}, {ms:.6f} ms device time ({events:.4f} ms with "
        f"CUDA events; plain {plain:.3f} ms, addmm_ {lib:.6f} ms, max abs diff from the "
        f"kernel {float((lib_c - got).abs().max()):.3g}), {nbytes} bytes")
    return err, ms, plain, lib, nbytes, 2.0 * nnz * h


def sparse_steps(grid):
    """11a's sparse step on one card on the n = 2^18 MCL input, with the
    caps of each path's b = 1 plan: ESC on the whole of B (against scipy's
    A @ A), hash on batch 0 of the least b whose packed keys fit in i32
    (against scipy's columns of that batch). Returns launches by path."""
    import torch

    from repro_torch.core import convert
    from repro_torch.core.batched import batch_column_map, plan_batches
    from repro_torch.core.distsparse import scatter_to_grid
    from repro_torch.core.specs import PlanSpec
    from repro_torch.core.summa3d import summa3d_sparse_step

    a, _ = mcl_sparse_input()
    n = a.shape[0]
    A, B = scatter_to_grid(a, grid, "A"), scatter_to_grid(a, grid, "B")
    ref = scipy_square(a)
    counters = counted_kernels()
    out = {}
    for lp in ("esc", "hash"):
        plan = plan_batches(A, B, grid, 1 << 62, spec=PlanSpec(local_path=lp))
        nb = 1 if lp == "esc" else hash_batch_floor(n, (1, 1, 1))
        Bb = B if nb == 1 else batch_block(B, grid, nb, 0)
        for w in counters.values():
            w.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        c, ovf = summa3d_sparse_step(A, Bb, grid, plan.caps, hashc=plan.hash_caps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: w.launches for name, w in counters.items()}
        if int(ovf):
            raise AssertionError(f"11a sparse step {lp}: overflow {int(ovf)} at the b = 1 caps")
        want = ref if nb == 1 else batch_reference(ref, n, grid, nb, 0)
        err = check_product([convert.batch_to_global(c, batch_column_map(n, grid, nb, 0))],
                            want, n)
        if (lp == "hash" and launches["hash"] != 1) or (lp == "esc" and not launches["segment_reduce"]):
            raise AssertionError(f"11a sparse step {lp}: launches {launches}")
        log(f"11a sparse step {lp}, n={n}, b = 1 plan {plan.caps} {plan.hash_caps}, B block "
            f"1/{nb}: {len(want[0])} entries, max rel err {err:.3g}, wall {wall:.3f} s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, launches {launches}")
        out[lp] = launches
        del c, Bb
    return out


def placement_runs(g, grid, count, label):
    """11b on ``grid``: ``multiply_placed`` of the masked L·U (mask L) of
    graph ``g`` with every strategy of PLACE_STRATEGIES on the hash path,
    all at one budget, the hash launch count set to 0 just before each run
    and read just after. Each strategy's plan is first asked for at the
    budget at which the identity plan has b >= PLACE_LEAST_B; one whose
    permuted inputs alone exceed it on some process (its plan raises
    ``MemoryError``) is recorded as refused there. The common budget is the
    largest of the strategies' own b >= PLACE_LEAST_B budgets, so every
    strategy plans at it. Every strategy's triplets must equal the identity
    run's exactly (the values are small integer counts, exact in f32) and
    sum to ``count``. Returns the budgets ({"identity": identity's
    b >= PLACE_LEAST_B budget, "common": the run budget, "own": each
    strategy's own, "refused": the strategies refused at identity's}) and
    per strategy its b, caps, padded bytes, wall and launches."""
    import torch

    from repro_torch.core import placement
    from repro_torch.core.batched import plan_batches
    from repro_torch.core.distsparse import scatter_to_grid
    from repro_torch.core.specs import PlanSpec
    from repro_torch.kernels import spgemm_hash as H
    from repro_torch.sparse_apps import graph_algorithms as ga
    from repro_torch.tune import padded_comm_volume

    L, U = ga._strict_parts(g)
    spec = PlanSpec(local_path="hash")
    places = {s: placement.compute_placement(L, U, s, mask=L) for s in PLACE_STRATEGIES}
    own, refused = {}, []
    for strategy, pl in places.items():
        A, B, M = (scatter_to_grid(pl.apply_a(L), grid, "A"),
                   scatter_to_grid(pl.apply_b(U), grid, "B"),
                   scatter_to_grid(pl.apply_mask(L), grid, "C"))
        sm = spec.replace(mask=M)
        own[strategy], _ = budget_for_batches(A, B, grid, sm, PLACE_LEAST_B)
        if strategy != "identity":
            try:
                plan_batches(A, B, grid, own["identity"], spec=sm)
            except MemoryError:  # this placement's inputs alone exceed it on some process
                refused.append(strategy)
        del A, B, M
    budgets = {"identity": own["identity"], "common": max(own.values()), "own": own,
               "refused": refused}

    out, base = {}, None
    for strategy, pl in places.items():
        H.hash_expand_insert_cuda.launches = 0
        torch.cuda.synchronize(grid.device)
        t0 = time.perf_counter()
        res = placement.multiply_placed(L, U, grid, budgets["common"], mask=L, spec=spec,
                                        placement=pl)
        torch.cuda.synchronize(grid.device)
        wall = time.perf_counter() - t0
        p = res.result.plan
        vol = padded_comm_volume(p, (grid.pr, grid.pc, grid.l))
        total = int(round(float(res.vals.astype(np.float64).sum())))
        rec = {"b": p.num_batches, "sel_cap": p.sel_cap, "piece_cap": p.caps.piece_cap,
               "d_cap": p.caps.d_cap, "padded_bytes": vol.total_bytes,
               "all_to_all_bytes": vol.all_to_all_bytes, "gather_bytes": vol.gather_bytes,
               "wall": wall, "launches": H.hash_expand_insert_cuda.launches,
               "retries": res.result.num_retries, "entries": len(res.vals), "sum": total}
        if base is None:
            base = res
        elif not (np.array_equal(res.rows, base.rows) and np.array_equal(res.cols, base.cols)
                  and np.array_equal(res.vals, base.vals)):
            raise AssertionError(f"{label} {strategy}: the triplets differ from the identity run's")
        if total != count or rec["launches"] != p.num_batches or res.result.local_path != "hash":
            raise AssertionError(f"{label} {strategy}: sum {total} (want {count}), {rec}")
        out[strategy] = rec
    return budgets, out


def log_placement(label, budgets, rec):
    log(f"{label}: identity's b >= {PLACE_LEAST_B} budget {budgets['identity']} B, refused "
        f"there: {budgets['refused'] or 'none'}; own b >= {PLACE_LEAST_B} budgets "
        f"{budgets['own']}; all run at {budgets['common']} B; " + "; ".join(
            f"{s}: b={x['b']}, sel_cap {x['sel_cap']}, piece_cap {x['piece_cap']}, d_cap "
            f"{x['d_cap']}, padded {x['padded_bytes']} B (all_to_all {x['all_to_all_bytes']}, "
            f"gather {x['gather_bytes']}), wall {x['wall']:.3f} s, {x['launches']} hash "
            f"launches, {x['entries']} entries, sum {x['sum']}" for s, x in rec.items()))


def _tune_full(n, budget, devices):
    """Worker process: ``autotune`` of the n-node protein product (phase
    3's matrix, made again from its seed on the CPU) for each device count,
    under ``budget`` bytes a process (None: phase 3's hash budget, from the
    host oracle). Returns {count: (TunedConfig, host s)} and the budget."""
    from repro_torch.core import gen, symbolic
    from repro_torch.core.batched import PlanInputs, plan_from_symbolic
    from repro_torch.core.specs import PlanFloors, PlanSpec
    from repro_torch.tune import autotune

    a = gen.protein_similarity_like(n, blocks=n // 64, intra_p=0.12, seed=0, device="cpu")
    if budget is None:
        inputs = PlanInputs.from_host(a, a, (1, 1, 1))
        probe = plan_from_symbolic(symbolic.host_symbolic_counts(a, a, (1, 1, 1)), inputs,
                                   1 << 62, PlanSpec(local_path="hash"), PlanFloors())
        budget = full_budget(probe, inputs.max_nnz_a, inputs.max_nnz_b)
    out = {}
    for d in devices:
        t0 = time.perf_counter()
        out[d] = (autotune(a, a, budget, num_devices=d), time.perf_counter() - t0)
    return out, budget


def full_budget(probe, max_nnz_a, max_nnz_b):
    """Phase 3's per-process budget: inputs plus 1/1024 of the hash plan's
    table bytes, so its plan has b = 1024."""
    from repro_torch.core import symbolic

    r = 12
    hash_bytes = symbolic.estimate_mem_c_bytes(
        probe.max_unmerged_nnz, probe.compression_est, r, local_path="hash")
    return r * (max_nnz_a + max_nnz_b) + -(-r * -(-hash_bytes // r) // 1024)


class BackgroundTune:
    """The n = 2^20 autotunes in a worker process while the card works (the
    tuner is host math)."""

    def __init__(self, budget, devices):
        import multiprocessing

        self.pool = multiprocessing.get_context("spawn").Pool(1)
        self.pending = self.pool.apply_async(_tune_full, (N_FULL, budget, devices))

    def result(self):
        return self.pending.get(timeout=TUNE_WAIT_S)

    def close(self):
        self.pool.terminate()
        self.pool.join()


def log_tuned(label, t, host_s):
    log(f"{label}: tuner host time {host_s:.2f} s; {json.dumps(t.to_meta())}")


def tuned_run_floors(t, n):
    """``t``'s floors, with the batch count raised to ``hash_batch_floor``
    when it runs the hash path (the planner does not know the i32 key
    range, ROADMAP §3.1). Returns (floors, whether they were raised)."""
    floor = hash_batch_floor(n, t.grid_shape) if t.spec.local_path == "hash" else 1
    if t.floors.num_batches >= floor:
        return t.floors, False
    return t.floors.replace(num_batches=floor), True


def run_tuned(t, a, grid, ref, n):
    """The tuned configuration ``t`` on ``grid``: ``multiply_placed`` with
    its strategy when it picked one (every rank gets the whole product),
    else ``batched_summa3d`` on this rank's tile, both with its spec, floors
    and exec spec, every launch count set to 0 just before and read just
    after; held against scipy (the whole product, or the tile's part).
    Returns (wall ms, max rel err, launches, BatchedResult)."""
    import torch

    from repro_torch.core import batched, convert, placement
    from repro_torch.core.distsparse import scatter_to_grid

    counters = counted_kernels()
    for w in counters.values():
        w.launches = 0
    floors, _ = tuned_run_floors(t, n)
    kw = dict(spec=t.spec, floors=floors, exec_spec=t.exec_spec)
    if t.placement is not None:
        torch.cuda.synchronize(grid.device)
        t0 = time.perf_counter()
        res = placement.multiply_placed(a, a, grid, t.per_process_memory,
                                        strategy=t.placement, **kw)
        torch.cuda.synchronize(grid.device)
        wall = time.perf_counter() - t0
        dev = grid.device
        parts = [(torch.as_tensor(res.rows, device=dev), torch.as_tensor(res.cols, device=dev),
                  torch.as_tensor(res.vals, device=dev))]
        result = res.result
    else:
        A, B = scatter_to_grid(a, grid, "A"), scatter_to_grid(a, grid, "B")
        parts = []
        torch.cuda.synchronize(grid.device)
        t0 = time.perf_counter()
        result = batched.batched_summa3d(
            A, B, grid, t.per_process_memory,
            consumer=lambda bi, cb, cm: parts.append(convert.batch_to_global(cb, cm)), **kw)
        torch.cuda.synchronize(grid.device)
        wall = time.perf_counter() - t0
        if grid.p > 1:
            mine = product_tile(ref[0], n, grid)
            ref = (ref[0][mine], ref[1][mine])
    err = check_product(parts, ref, n)
    return 1e3 * wall, err, {k: w.launches for k, w in counters.items()}, result


def tune_phase(grid, a14, budget14, ref14, pairs, background):
    """11c: ``autotune`` for one device on the auto n = 2^14 input and
    budget (phase 3), the tuned configuration run on the card against
    scipy beside its predicted time; ``fit_overhead`` over the raw
    predicted and measured ms of this script's runs (``pairs``: phase 3's
    three and this one); the background n = 2^20 picks for 1 and 4
    devices, logged."""
    from repro_torch.tune import autotune, fit_overhead

    t0 = time.perf_counter()
    t = autotune(a14, a14, budget14, num_devices=1)
    host_s = time.perf_counter() - t0
    log_tuned("11c autotune n=2^14, 1 device", t, host_s)
    ms, err, launches, res = run_tuned(t, a14, grid, ref14, a14.shape[0])
    path = res.local_path
    log(f"11c tuned n=2^14 on the card: path {path}, b={res.plan.num_batches}, placement "
        f"{t.placement}, retries {res.num_retries}; predicted {t.predicted.total_ms:.3f} ms, "
        f"measured {ms:.3f} ms, max rel err {err:.3g}, launches {launches}")
    # the tuner prices with the default coefficients (overhead 1): raw ms
    pairs = pairs + [("tuned n=2^14", t.predicted.total_ms, ms)]
    coeffs = fit_overhead([(raw, meas) for _, raw, meas in pairs])
    log("11c fit_overhead over " + "; ".join(
        f"{label} raw {raw:.3f} ms, measured {meas:.3f} ms" for label, raw, meas in pairs)
        + f": overhead {coeffs.overhead:.6g} on {card_lines(1)[0]}")
    picks, full_b = background.result()
    log(f"11c n=2^20 budget {full_b} B")
    for d, (td, s) in sorted(picks.items()):
        log_tuned(f"11c autotune n=2^20, {d} device(s) (worker process)", td, s)
        if td.spec.local_path == "binned":
            log(f"11c n=2^20, {d} device(s): the tuner picked binned; not run (its dense output "
                f"tile is not charged by the planner, ROADMAP §3.1)")


def phase3_pairs(runs, walls, nnz):
    """(label, raw predicted ms, measured ms) of phase 3's runs on one card:
    ``predict_cost`` of each run's plan and path, against its wall."""
    from repro_torch.tune import predict_cost

    out = []
    for label, res in runs.items():
        n_a = nnz[label]
        c = predict_cost(res.plan, (1, 1, 1), n_a, n_a, path=res.local_path)
        out.append((label, c.total_ms, 1e3 * walls[label]))
    return out


def summa_phase(grid, a_dense, tri_count):
    """11a and 11b on one card: the dense step at n = N_DENSE (b = 1), the
    sparse step at n = 2^18; the placed masked multiply at R-MAT scale TRI_PINNED_SCALE.
    Returns the records the kernel line carries."""
    from repro_torch.core import gen

    ref = scipy_square(a_dense)
    rec, dist = dense_steps(a_dense, grid, 1, ref)
    log_dense(f"11a dense step, one card, n={a_dense.shape[0]}", rec, dist)
    sparse = sparse_steps(grid)
    g = gen.symmetrized(gen.rmat(TRI_PINNED_SCALE, edge_factor=16, seed=5, device=grid.device))
    budget, place = placement_runs(g, grid, tri_count, "11b placement, one card")
    log_placement(f"11b placement, one card, scale {TRI_PINNED_SCALE}", budget, place)
    return {"dense": rec, "sparse": sparse, "placement": place}


def phase11_rank(grid, p11, tri):
    """Phase 11 on one rank of the distributed phase (see ``grid_rank``):
    the dense step on each of ``p11["dense"]``'s (shape, b) at n =
    ``p11["dense_n"]``; with ``p11["place_count"]``, the placed masked
    multiply of ``tri`` on the launcher's grid."""
    import torch.distributed as dist

    from repro_torch.core import gen
    from repro_torch.core.grid import make_grid

    out = {"dense": {}}
    n = p11["dense_n"]
    ad = gen.protein_similarity_like(n, blocks=n // 64, intra_p=0.12, seed=0, device=grid.device)
    dref = scipy_square(ad)
    for shape, nb in p11["dense"]:
        g = grid if shape == (grid.pr, grid.pc, grid.l) else make_grid(*shape, device=grid.device)
        dist.barrier()
        out["dense"][shape] = dense_steps(ad, g, nb, dref)
    del ad, dref
    if p11["place_count"] is not None:
        dist.barrier()
        out["placement"] = placement_runs(tri, grid, p11["place_count"],
                                          f"11b rank {grid.rank}")
    return out


def tuned_rank(grid, t, n):
    """One rank of the tuned n = 2^20 configuration ``t`` on its own grid
    (``run_tuned``), against scipy's A @ A."""
    from repro_torch.core import gen

    a = gen.protein_similarity_like(n, blocks=n // 64, intra_p=0.12, seed=0, device=grid.device)
    ms, err, launches, res = run_tuned(t, a, grid, scipy_square(a), n)
    return {"ms": ms, "max_rel_err": err, "launches": launches, "b": res.plan.num_batches,
            "path": res.local_path, "retries": res.num_retries,
            "raised_floor": tuned_run_floors(t, n)[1]}


def tuned_phase_four_cards(t, n):
    """11c with --chips 4: the 4-device pick ``t`` at n on its grid, one
    rank per card over NCCL (on this process when the grid is one point),
    when its path is ESC or hash; logs each rank's wall beside the
    prediction."""
    from repro_torch.core.grid import make_grid
    from repro_torch.launch import spawn

    if t.spec.local_path not in ("esc", "hash"):
        log(f"11c n=2^20, 4 devices: the tuner picked {t.spec.local_path}; not run (its dense "
            f"output tile is not charged by the planner, ROADMAP §3.1)")
        return
    t0 = time.perf_counter()
    if t.grid_shape == (1, 1, 1):
        ranks = [tuned_rank(make_grid(1, 1, 1), t, n)]
    else:
        workdir = Path(__file__).resolve().parent / "build"
        ranks = spawn.run(tuned_rank, t.grid_shape, backend="nccl", device="cuda", args=(t, n),
                          timeout_s=GRID_TIMEOUT_S, workdir=workdir)
    for r, x in enumerate(ranks):
        log(f"11c tuned n=2^20 on grid {t.grid_shape} (nccl), rank {r}: predicted "
            f"{t.predicted.total_ms:.3f} ms, {x}")
    log(f"11c tuned n=2^20 (four cards): {time.perf_counter() - t0:.1f} s")


def log_phase11_ranks(ranks, backend):
    """Phase 11's records of every rank of the distributed phase, with the
    checks across ranks: the same placed plans, every dense step's launches
    as the schedule wants. Returns the densify/SpMM launches per rank."""
    launches = {}
    for shape in ranks[0]["p11"]["dense"]:
        tag = "x".join(map(str, shape))
        for r, x in enumerate(ranks):
            rec, dist = x["p11"]["dense"][shape]
            log_dense(f"11a dense step {tag} ({backend}), rank {r}", rec, dist)
        launches[tag] = {s: [x["p11"]["dense"][shape][0][s]["launches"] for x in ranks]
                         for s in ("allgather", "ring")}
    if "placement" in ranks[0]["p11"]:
        recs = [x["p11"]["placement"] for x in ranks]
        for strategy in PLACE_STRATEGIES:
            plans = {(x[1][strategy]["b"], x[1][strategy]["sel_cap"], x[1][strategy]["d_cap"])
                     for x in recs}
            if len(plans) != 1:
                raise AssertionError(f"11b {strategy}: the ranks planned differently: {plans}")
        for r, (budget, rec) in enumerate(recs):
            log_placement(f"11b placement 2x2x1 ({backend}), rank {r}", budget, rec)
    return launches


# ---------------------------------------------------------------------------
# phase 12: durability — the checkpoint store, the resilient loops, APSP
# ---------------------------------------------------------------------------
class PlanLog:
    """Notes (b, caps, local path) of every ``batched_summa3d`` call that
    ``module`` makes and that returns (a preempted call raises first)."""

    def __init__(self, module):
        self.module, self.plans = module, []

    def __enter__(self):
        import dataclasses

        real = self._real = self.module.batched_summa3d

        def wrapped(*args, **kw):
            res = real(*args, **kw)
            self.plans.append((res.plan.num_batches, dataclasses.astuple(res.plan.caps),
                               res.local_path))
            return res

        self.module.batched_summa3d = wrapped
        return self

    def __exit__(self, *exc):
        self.module.batched_summa3d = self._real


class RestoreLog(logging.Handler):
    """Notes the iteration of every restore the resilient loop logs."""

    def __init__(self):
        super().__init__()
        self.steps = []

    def emit(self, record):
        if record.getMessage().startswith("restored checkpoint at iteration"):
            self.steps.append(int(record.args[0]))

    def __enter__(self):
        logger = logging.getLogger("repro_torch.runtime.resilient")
        logger.addHandler(self)
        logger.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        logging.getLogger("repro_torch.runtime.resilient").removeHandler(self)


def durability(rep) -> str:
    return (f"restarts {rep.restarts}, refused_restores {rep.refused_restores}, "
            f"checkpoint_bytes {rep.checkpoint_bytes}, checkpoint_stall_s "
            f"{rep.checkpoint_stall_s:.4f} ({rep.checkpoint_stalls} stalls), straggler_events "
            f"{rep.straggler_events}")


def run_resilient_mcl(a, grid, cfg, ckpt_dir, injector, label):
    """``mcl_iterate_resilient`` through ``run_mcl`` (counts set to 0 just
    before, wall, peak); returns (final, history, wall, peak, launches,
    report, restored-from steps)."""
    from repro_torch.runtime.resilient import ResilientConfig
    from repro_torch.sparse_apps import mcl

    report = {}

    def resilient(a_, g, c):
        final, hist, report["rep"] = mcl.mcl_iterate_resilient(
            a_, g, c, ResilientConfig(ckpt_dir=ckpt_dir, ckpt_every=1), injector=injector)
        return final, hist

    with RestoreLog() as restores:
        final, hist, wall, peak, launches = run_mcl(resilient, a, grid, cfg, label)
    log(f"{label}: {durability(report['rep'])}, resumed from {restores.steps}")
    return final, hist, wall, peak, launches, report["rep"], restores.steps


def phase12a(grid, ref, root):
    """12a: phase 7's sparse MCL at n = 2^18 through mcl_iterate_resilient,
    step 2's arrays truncated and a preemption at batch 5 of iteration 2:
    one restart, the refused step 2, a restore from step 1, and then the
    device loop's trajectory, final matrix and plans bit for bit."""
    from repro_torch.runtime.resilient import SpgemmFailureInjector
    from repro_torch.sparse_apps import mcl

    inj = SpgemmFailureInjector(preempt_iters=(2,), preempt_batch=5, corrupt_steps=(2,))
    with PlanLog(mcl) as plans:
        final, hist, wall, peak, launches, rep, restored = run_resilient_mcl(
            ref["a"], grid, ref["cfg"], os.path.join(root, "12a"), inj,
            "12a mcl sparse n=2^18, resilient")
    want = ref["plans"][0:2] + ref["plans"][1:4]  # iteration 2 abandoned, 1 run again
    batches = sum(b for b, _, _ in plans.plans)
    if not (rep.restarts == 1 and rep.refused_restores >= 1 and restored == [1]):
        raise AssertionError(f"12a: {durability(rep)}, resumed from {restored}")
    if not same_bits(final, hist, ref["final"], ref["hist"]):
        raise AssertionError(f"12a: the resumed run differs from phase 7's device loop: "
                             f"{[h['nnz'] for h in hist]} vs {[h['nnz'] for h in ref['hist']]}")
    if plans.plans != want:
        raise AssertionError(f"12a: plans {plans.plans} against phase 7's {want}")
    if launches["segment_reduce"] < batches:
        raise AssertionError(f"12a: {launches['segment_reduce']} segment-reduce launches for "
                             f"{batches} batches")
    log(f"12a: bit-identical to phase 7's device loop (trajectory, final matrix, every "
        f"iteration's b, caps and path); wall {wall:.2f} s against {ref['wall']:.2f} s, peak "
        f"{peak / 2**30:.3f} GiB against {ref['peak'] / 2**30:.3f} GiB; {batches} batches run, "
        f"segment_reduce launches {launches['segment_reduce']}")
    return {"launches": launches["segment_reduce"], "wall": wall, "peak": peak,
            "report": rep.to_dict()}


STRAGGLE_S = 60.0  # 12b: the first child waits in iteration 3 until it is killed
CHILD_TIMEOUT_S = 300


def resume_child(ckpt_dir, out_path, straggle):
    """12b's child process: phase 8's sparse n = 2^14 MCL loop on its
    default (binned) multiply through mcl_iterate_resilient into
    ``ckpt_dir``, with the kernels phase 2 built (it raises rather than
    build one). ``straggle``: hold batch 0 of iteration 3 for STRAGGLE_S.
    Writes the final matrix, trajectory and report to ``out_path``."""
    import dataclasses

    import torch

    from repro_torch.checkpoint import store
    from repro_torch.core import convert
    from repro_torch.core.grid import make_grid
    from repro_torch.kernels import _build, spgemm_binned as Bn
    from repro_torch.runtime.resilient import ResilientConfig, SpgemmFailureInjector
    from repro_torch.sparse_apps import mcl

    missing = [n for n in _build.SOURCES if not _build.library_path(n).exists()]
    if missing:
        raise RuntimeError(f"12b child: kernels not built: {missing}")
    a, cfg = mcl_dense_input()
    cfg = dataclasses.replace(cfg, path="sparse")
    inj = SpgemmFailureInjector(straggle_batches=((3, 0),), batch_straggle_s=STRAGGLE_S
                                ) if straggle else None
    newest = store.latest_step(ckpt_dir)
    Bn.spgemm_paired_binned_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, hist, rep = mcl.mcl_iterate_resilient(
        a, make_grid(1, 1, 1), cfg, ResilientConfig(ckpt_dir=ckpt_dir, ckpt_every=1),
        injector=inj)
    torch.cuda.synchronize()
    r, c, v = convert.triplets(final)
    np.savez(out_path, rows=r, cols=c, vals=v, nnz=[h["nnz"] for h in hist],
             chaos=[h["chaos"] for h in hist])
    with open(out_path + ".json", "w") as f:
        json.dump({"report": rep.to_dict(), "newest_step": newest,
                   "binned_launches": Bn.spgemm_paired_binned_cuda.launches,
                   "wall": time.perf_counter() - t0, "loaded": sorted(_build._LIBS)}, f)


def phase12b(ref, root):
    """12b: a child runs the n = 2^14 loop (``resume_child``) and is
    SIGKILLed once step 3 is in the store; a second child resumes from
    step 3 and must end on phase 8's binned loop, bit for bit."""
    from repro_torch.checkpoint import store

    ckpt = os.path.join(root, "12b")
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    first = ctx.Process(target=resume_child, args=(ckpt, os.path.join(root, "first"), True),
                        name="12b-first")
    first.start()
    try:
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        while not os.path.isdir(os.path.join(ckpt, "step_00000003")):
            if first.exitcode is not None:
                raise AssertionError(f"12b: the first child exited ({first.exitcode}) "
                                     f"before step 3 was stored")
            if time.monotonic() > deadline:
                raise TimeoutError(f"12b: no step 3 in {CHILD_TIMEOUT_S} s")
            time.sleep(0.02)
        first.kill()
        first.join(30)
    finally:
        if first.is_alive():
            first.kill()
            first.join()
    if first.exitcode != -signal.SIGKILL:
        raise AssertionError(f"12b: the first child ended with {first.exitcode}, not SIGKILL")
    killed = time.perf_counter() - t0
    log(f"12b: first child SIGKILLed {killed:.1f} s after its start, store holds steps "
        f"{store.steps_available(ckpt)}")
    out = os.path.join(root, "second.npz")
    second = ctx.Process(target=resume_child, args=(ckpt, out, False), name="12b-second")
    second.start()
    second.join(CHILD_TIMEOUT_S)
    if second.is_alive():
        second.kill()
        second.join()
        raise TimeoutError(f"12b: the second child ran over {CHILD_TIMEOUT_S} s")
    if second.exitcode != 0:
        raise AssertionError(f"12b: the second child failed ({second.exitcode})")
    with open(out + ".json") as f:
        info = json.load(f)
    got = np.load(out)
    fin, hist = ref
    r = fin.rows[: int(fin.nnz)].cpu().numpy()
    c = fin.cols[: int(fin.nnz)].cpu().numpy()
    v = fin.vals[: int(fin.nnz)].cpu().numpy()
    same = (np.array_equal(got["rows"], r) and np.array_equal(got["cols"], c)
            and np.array_equal(got["vals"].view(np.int32), v.view(np.int32))
            and got["nnz"].tolist() == [h["nnz"] for h in hist]
            and got["chaos"].tolist() == [h["chaos"] for h in hist])
    rep = info["report"]
    if not (same and info["newest_step"] == 3 and rep["restarts"] == 0
            and rep["refused_restores"] == 0 and info["binned_launches"] > 0):
        raise AssertionError(f"12b: resumed run {got['nnz'].tolist()} against phase 8's "
                             f"{[h['nnz'] for h in hist]}, bit-identical {same}, {info}")
    log(f"12b: the second child resumed from step {info['newest_step']} and ended bit-identical "
        f"to phase 8's binned loop (nnz {got['nnz'].tolist()}); its loop {info['wall']:.2f} s, "
        f"binned launches {info['binned_launches']}, checkpoint_bytes "
        f"{rep['checkpoint_bytes']}, checkpoint_stall_s {rep['checkpoint_stall_s']:.4f}, "
        f"restarts {rep['restarts']}, refused_restores {rep['refused_restores']}; "
        f"12b {time.perf_counter() - t0:.1f} s; the children loaded {info['loaded']}")
    return {"launches": info["binned_launches"], "report": rep}


N_APSP = 1 << 11
N_APSP_PAIR = 1 << 10  # the ESC run (its expansion is the whole product) and its hash twin
APSP_BUDGET = 2 << 30  # the dense-tile operand caps alone charge 12 B x 2 x n^2 (100 MB)
APSP_OUT_DEGREE = 8
APSP_RTOL = 1e-5  # f32 path sums vs scipy's f64 Dijkstra


def weighted_digraph(n, seed=11):
    """APSP's input: about APSP_OUT_DEGREE out-edges a vertex, weights
    uniform in [1, 10), no self-loops (the JAX package's test generator),
    as numpy (rows, cols, vals)."""
    rng = np.random.default_rng(seed)
    w = rng.random((n, n)).astype(np.float32) * 9 + 1
    mask = rng.random((n, n)) < APSP_OUT_DEGREE / n
    np.fill_diagonal(mask, False)
    r, c = np.nonzero(mask)
    return r.astype(np.int32), c.astype(np.int32), w[r, c]


def scipy_apsp(coo, n):
    import scipy.sparse as sps
    from scipy.sparse.csgraph import shortest_path

    r, c, v = coo
    return shortest_path(sps.csr_matrix((v.astype(np.float64), (r, c)), shape=(n, n)),
                         method="D", directed=True)


def apsp_bits(final):
    from repro_torch.core import convert

    r, c, v = convert.triplets(final)
    return r, c, v.view(np.int32)


def check_apsp(label, final, want):
    """The reachable pairs identical to scipy's, distances within APSP_RTOL."""
    from repro_torch.core import convert

    r, c, v = convert.triplets(final)
    got = np.zeros(want.shape, bool)
    got[r, c] = True
    reach = np.isfinite(want)
    if not (np.isfinite(v).all() and np.array_equal(got, reach)):
        raise AssertionError(f"{label}: {len(r)} reachable pairs, scipy {int(reach.sum())}")
    w = want[r, c]
    err = float((np.abs(v - w) / np.maximum(w, 1e-30)).max())
    if not np.allclose(v, w, rtol=APSP_RTOL, atol=0):
        raise AssertionError(f"{label}: distances off scipy's by rel {err}")
    log(f"{label}: {len(r)} reachable pairs as scipy's, max rel err {err:.3g}")
    return err


def run_apsp(a, grid, cfg, label, ckpt_dir=None, injector=None):
    """apsp_iterate (or, with ``ckpt_dir``, apsp_iterate_resilient) with
    the hash, segment-reduce and binned counts set to 0 just before; logs
    every iteration. Returns (final, history, wall, peak, launches)."""
    import torch

    from repro_torch.runtime.resilient import ResilientConfig
    from repro_torch.sparse_apps import graph_algorithms as ga

    counted = counted_kernels()
    for w in counted.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with RestoreLog() as restores:
        if ckpt_dir is None:
            final, hist = ga.apsp_iterate(a, grid, cfg)
            rep = None
        else:
            final, hist, rep = ga.apsp_iterate_resilient(
                a, grid, cfg, ResilientConfig(ckpt_dir=ckpt_dir), injector=injector)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {name: w.launches for name, w in counted.items()}
    log(f"{label}: {len(hist)} iterations, wall {wall:.2f} s, peak {peak / 2**30:.3f} GiB, "
        f"launches {launches}" + (f"; {durability(rep)}, resumed from {restores.steps}"
                                  if rep is not None else ""))
    for h in hist:
        log(f"  iter {h['iter']}: nnz {h['nnz']}, b={h.get('batches')}, path "
            f"{h.get('local_path')}, retries {h['retries']}, {h['wall_ms']:.1f} ms")
    return final, hist, wall, peak, launches, rep, restores.steps


def hold_segment_min(label, vals, offsets):
    """The segment kernel's min on one input against its plain version and
    a second call: exactly (a min has no rounding). Returns 0.0."""
    import torch

    from repro_torch.kernels import segment_reduce as S

    got = S.segment_reduce_cuda(vals, offsets, "min")
    again = S.segment_reduce_cuda(vals, offsets, "min")
    want = S.segment_reduce_ref(vals, offsets, "min")
    if not (torch.equal(got, want) and torch.equal(got, again)):
        raise AssertionError(f"{label}: segment_reduce min differs from plain "
                             f"({int((got != want).sum())} runs) or between calls")
    lengths = offsets[1:] - offsets[:-1]
    log(f"{label}: segment_reduce min over {lengths.numel()} runs (longest "
        f"{int(lengths.max())}, {int(offsets[-1] - offsets[0])} entries) equal to plain and to "
        f"a second call")
    return 0.0


def phase12c(grid, root):
    """12c: APSP on the hash path at n = 2^11 against scipy's Dijkstra; the
    "auto" plan; ESC and hash at n = 2^10, bit-identical to each other and
    equal to scipy (a min segment reduction of the ESC run held exactly
    against its plain version first); the resilient run at n = 2^11,
    preempted at iteration 3, bit-identical to the uninterrupted one."""
    import dataclasses

    from repro_torch.core.batched import plan_batches
    from repro_torch.core.distsparse import scatter_to_grid
    from repro_torch.core.sparse import from_numpy_coo
    from repro_torch.core.specs import PlanSpec
    from repro_torch.runtime.resilient import SpgemmFailureInjector
    from repro_torch.sparse_apps import graph_algorithms as ga

    out = {}
    t0 = time.perf_counter()
    coo = weighted_digraph(N_APSP)
    a = from_numpy_coo(*coo, (N_APSP, N_APSP), device=grid.device)
    want = scipy_apsp(coo, N_APSP)
    log(f"12c: n={N_APSP}, {len(coo[0])} edges, scipy Dijkstra (f64) "
        f"{time.perf_counter() - t0:.1f} s, {int(np.isfinite(want).sum())} reachable pairs")
    cfg = ga.APSPConfig(per_process_memory=APSP_BUDGET, local_path="hash")
    fin, hist, wall, peak, launches, _, _ = run_apsp(a, grid, cfg, f"12c apsp n={N_APSP}, hash")
    check_apsp(f"12c apsp n={N_APSP} hash vs scipy", fin, want)
    run_b = sum(h["batches"] for h in hist)
    if launches["hash"] != run_b:
        raise AssertionError(f"12c: {launches['hash']} hash launches for {run_b} batches")
    out["hash_n2^11"] = launches["hash"]
    # plan only: APSPConfig(local_path="auto") under the driver's
    # ExecSpec(binned=False) plans the ESC budget (as in the reference); the
    # planner's own "auto" beside it
    _, _, reserved = ga._apsp_caps(N_APSP, grid, cfg)
    A, B = scatter_to_grid(fin, grid, "A"), scatter_to_grid(fin, grid, "B")
    for name, lp in (("apsp_iterate's \"auto\" (the ESC budget)", "esc"),
                     ("the planner's own \"auto\"", "auto")):
        p = plan_batches(A, B, grid, APSP_BUDGET,
                         spec=PlanSpec(local_path=lp, reserved_bytes=reserved))
        log(f"12c apsp n={N_APSP}, plan on the fixpoint iterate, {name}: path {p.local_path}, "
            f"b={p.num_batches}, caps {p.caps}, hash_caps {p.hash_caps}, flops "
            f"{p.total_flops}, compression est {p.compression_est:.1f}")
    del A, B
    inj = SpgemmFailureInjector(preempt_iters=(3,))
    fin_r, hist_r, wall_r, _, launches_r, rep, restored = run_apsp(
        a, grid, cfg, f"12c apsp n={N_APSP}, hash, resilient", os.path.join(root, "12c"), inj)
    if not (rep.restarts == 1 and all(np.array_equal(x, y) for x, y in
                                      zip(apsp_bits(fin_r), apsp_bits(fin)))
            and [h["nnz"] for h in hist_r] == [h["nnz"] for h in hist]):
        raise AssertionError(f"12c: the resumed APSP differs or did not restart: "
                             f"{durability(rep)}")
    log(f"12c apsp n={N_APSP}: resumed from {restored}, bit-identical to the uninterrupted "
        f"run; wall {wall_r:.2f} s against {wall:.2f} s")
    out["hash_n2^11_resilient"] = launches_r["hash"]
    out["resilient_report"] = rep.to_dict()
    del fin, fin_r
    # n = 2^10: ESC (a min segment reduction held first) and hash, bit for bit
    coo = weighted_digraph(N_APSP_PAIR)
    a = from_numpy_coo(*coo, (N_APSP_PAIR, N_APSP_PAIR), device=grid.device)
    want = scipy_apsp(coo, N_APSP_PAIR)
    esc = dataclasses.replace(cfg, local_path="esc")
    _, inputs = capture_segment_inputs(
        lambda: ga.apsp_iterate(a, grid, dataclasses.replace(esc, max_iters=3)), clone=True)
    mins = [(v, o) for v, o, kind in inputs if kind == "min"]
    if not mins:
        raise AssertionError("12c: the ESC run made no min segment reduction")
    v, o = max(mins, key=lambda x: x[1].numel())
    out["min_hold_err"] = hold_segment_min(f"12c apsp n={N_APSP_PAIR} esc, one batch", v, o)
    del inputs, mins, v, o
    bits = {}
    for lp, c in (("esc", esc), ("hash", cfg)):
        f, h, _, _, la, _, _ = run_apsp(a, grid, c, f"12c apsp n={N_APSP_PAIR}, {lp}")
        check_apsp(f"12c apsp n={N_APSP_PAIR} {lp} vs scipy", f, want)
        bits[lp] = apsp_bits(f)
        out[f"{lp}_n2^10"] = la["segment_reduce" if lp == "esc" else "hash"]
        if lp == "esc" and la["segment_reduce"] < sum(x["batches"] for x in h):
            raise AssertionError(f"12c esc: {la['segment_reduce']} segment-reduce launches")
    if not all(np.array_equal(x, y) for x, y in zip(bits["esc"], bits["hash"])):
        raise AssertionError("12c: ESC and hash APSP differ at n=2^10")
    log(f"12c apsp n={N_APSP_PAIR}: ESC and hash bit-identical; 12c {time.perf_counter() - t0:.1f} s")
    return out


def durability_phase(grid, ref7, ref8):
    """Phase 12 on this card, checkpoints in a temporary directory removed
    at the end. Returns each part's launches and reports."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_12_")
    try:
        out = {"12a": phase12a(grid, ref7, root)}
        log(f"12a: {time.perf_counter() - t0:.1f} s")
        out["12b"] = phase12b(ref8, root)
        out["12c"] = phase12c(grid, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")
    return out


def resilient_grid_rank(grid, a, cfg, ref, ckpt_dir):
    """12d on one rank: the grid's sparse MCL loop through
    mcl_iterate_resilient into ``ckpt_dir`` (rank 0 writes), preempted at
    batch 3 of iteration 2 (or its last batch, if it has fewer), held to
    ``ref`` = the grid's own loop (final, history, wall, peak) bit for
    bit. Rank 0 also returns the newest checkpoint's leaf shapes."""
    import torch.distributed as dist

    from repro_torch.checkpoint import store
    from repro_torch.runtime.resilient import SpgemmFailureInjector

    fin, hist, wall0, peak0 = ref
    batch = min(3, hist[2]["batches"] - 1)
    dist.barrier()
    final, hist_r, wall, peak, launches, rep, restored = run_resilient_mcl(
        a, grid, cfg, ckpt_dir, SpgemmFailureInjector(preempt_iters=(2,), preempt_batch=batch),
        f"12d mcl sparse n=2^18, grid {grid.pr}x{grid.pc}x{grid.l}, rank {grid.rank}, resilient")
    rec = {"batch": batch, "restored_from": restored, "report": rep.to_dict(),
           "bit_identical": same_bits(final, hist_r, fin, hist), "wall": wall, "peak": peak,
           "plain_wall": wall0, "plain_peak": peak0, "launches": launches}
    if grid.rank == 0:
        arrays = store.restore_arrays(ckpt_dir, store.latest_step(ckpt_dir))
        rec["leaf_shapes"] = {k: tuple(x.shape) for k, x in arrays.items()}
    return rec


def check_resilient_grid(recs, backend):
    """12d across ranks: one restart each, every rank resumed from the same
    step, bit-identical to the grid's own loop; the checkpoint holds
    (pr, pc, l, cap) tiles."""
    shapes = recs[0]["leaf_shapes"]
    steps = [x["restored_from"] for x in recs]
    ok = (all(x["report"]["restarts"] == 1 and x["bit_identical"] for x in recs)
          and all(s == steps[0] and len(s) == 1 for s in steps)
          and shapes["['A_nnz']"] == (2, 2, 1) and shapes["['A_rows']"][:3] == (2, 2, 1))
    for r, x in enumerate(recs):
        rep = x["report"]
        log(f"12d grid 2x2x1 ({backend}) rank {r}: preempted at batch {x['batch']} of iteration "
            f"2, resumed from {x['restored_from']}, bit-identical {x['bit_identical']}; wall "
            f"{x['wall']:.2f} s against {x['plain_wall']:.2f} s, peak {x['peak'] / 2**30:.3f} "
            f"GiB against {x['plain_peak'] / 2**30:.3f} GiB; restarts {rep['restarts']}, "
            f"refused_restores {rep['refused_restores']}, checkpoint_bytes "
            f"{rep['checkpoint_bytes']}, checkpoint_stall_s {rep['checkpoint_stall_s']:.4f}")
    log(f"12d: checkpoint leaves {shapes}")
    if not ok:
        raise AssertionError(f"12d: restores {steps}, shapes {shapes}, "
                             f"{[(x['report']['restarts'], x['bit_identical']) for x in recs]}")


# ---------------------------------------------------------------------------
# phase 13: serving — the plan-cached SpGEMM engine
# ---------------------------------------------------------------------------
SERVE_LEAST_B = 4  # 13a: one A0·A0 plans at least this many batches at the searched budget
SERVE_HASH_FLOOR = 64  # 13b: the least b whose packed (tm, wb) keys fit i32 at n = 2^18
N_SERVE_GLOO = 1 << 16  # phase 9: 13a's mix on the four gloo ranks
# 13a's novel products A·A: (n, seed)
SERVE_NOVEL = ((1 << 16, 1), (1 << 16, 2), (1 << 16, 3), (1 << 17, 4), (1 << 17, 5),
               (1 << 17, 6))


def protein(n, seed=0):
    """The protein-similarity-like matrix (64-node clusters) on the host,
    where a request's operands arrive."""
    from repro_torch.core import gen

    return gen.protein_similarity_like(n, blocks=n // 64, intra_p=0.12, seed=seed,
                                       device="cpu")


def block_dense(n, s):
    """The n x n block-diagonal matrix of dense s x s blocks (unit values),
    on the host, built in row-major order."""
    import torch

    from repro_torch.core.sparse import SparseCOO

    rows = np.repeat(np.arange(n, dtype=np.int32), s)
    cols = rows // s * s + np.tile(np.arange(s, dtype=np.int32), n)
    return SparseCOO(torch.from_numpy(rows), torch.from_numpy(cols),
                     torch.ones(n * s, dtype=torch.float32),
                     torch.tensor(n * s, dtype=torch.int32), (n, n))


def refused_operand(n, grid, budget, r=12):
    """An operand X whose product X·X no split fits under ``budget``,
    priced on the host: the least block size s of ``block_dense`` whose
    per-process inputs r·(max A tile + max B tile) reach the budget, the
    precondition of Alg. 3 that ``plan_batches`` raises MemoryError on
    before any split. Returns (X, its per-process input bytes)."""
    from repro_torch.core.distsparse import tile_nnz_counts
    from repro_torch.core.symbolic import rup_pow2

    s = rup_pow2(max(-(-budget * grid.pr * grid.l // (2 * r * n)), 1))
    while s <= n:
        x = block_dense(n, s)
        need = r * (int(tile_nnz_counts(x, grid, "A").max())
                    + int(tile_nnz_counts(x, grid, "B").max()))
        if need >= budget:
            return x, need
        s *= 2
    raise RuntimeError(f"no block-diagonal operand at n = {n} exceeds {budget} B")


def serve_budget(a0, grid, least_b, local_path="esc"):
    """13a's engine config: b, the batch count of the plan at the budget at
    which one a0·a0 plans at least ``least_b`` batches (``budget_for_batches``
    on the engine's signature capacities); p, the engine's price of a0·a0
    at b batches (its pow2 capacities); then a budget of 2.5 p, with b as
    the seed floor of every first plan, so that a0·a0 keeps that plan and
    price there: two such requests fit at once and three do not. Returns
    (ServeConfig, b, p, the searched budget)."""
    from repro_torch.core.distsparse import scatter_to_grid
    from repro_torch.core.specs import PlanFloors, PlanSpec
    from repro_torch.serve import MultiplyRequest, ServeConfig, SpgemmEngine, matrix_signature

    req = MultiplyRequest(rid=0, a=a0, b=a0)
    key = matrix_signature(req, grid, ServeConfig(local_path=local_path))
    A = scatter_to_grid(a0, grid, "A", cap=key[2][2])
    B = scatter_to_grid(a0, grid, "B", cap=key[3][2])
    low, plan = budget_for_batches(A, B, grid, PlanSpec(local_path=local_path), least_b)
    del A, B
    floors = PlanFloors(num_batches=plan.num_batches)
    act, reason = SpgemmEngine(grid, ServeConfig(per_process_memory=1 << 50, local_path=local_path,
                                                 seed_floors=floors))._price(req)
    cfg = ServeConfig(per_process_memory=act.price * 5 // 2, local_path=local_path,
                      seed_floors=floors)
    again, _ = SpgemmEngine(grid, cfg)._price(req)
    if again is None or (again.nb, again.price, again.splits) != (act.nb, act.price, 0):
        raise AssertionError(f"a0·a0 at the raised budget {cfg.per_process_memory}: "
                             f"{again and (again.nb, again.price, again.splits)}; unbounded: "
                             f"b={act.nb}, price {act.price}")
    return cfg, act.nb, act.price, low


def min_plus_reference(a, grid, budget, local_path):
    """``batched_summa3d`` of a ⊗ a over min_plus on ``grid`` (every batch
    gathered to every rank): (row-major keys, values) on the grid's
    device."""
    import torch

    from repro_torch.core import semiring as sr
    from repro_torch.core.batched import batched_summa3d
    from repro_torch.core.distsparse import scatter_to_grid
    from repro_torch.core.specs import PlanSpec
    from repro_torch.sparse_apps.mcl import _sparse_batch_to_global

    parts = []
    batched_summa3d(scatter_to_grid(a, grid, "A"), scatter_to_grid(a, grid, "B"), grid, budget,
                    consumer=lambda bi, cb, cm: parts.append(_sparse_batch_to_global(cb, cm, grid)),
                    semiring=sr.MIN_PLUS, spec=PlanSpec(local_path=local_path))
    n = a.shape[1]
    key = np.concatenate([p[0].astype(np.int64) * n + p[1] for p in parts])
    vals = np.concatenate([p[2] for p in parts])
    order = np.argsort(key, kind="stable")
    return (torch.as_tensor(key[order], device=grid.device),
            torch.as_tensor(vals[order], device=grid.device))


def serve_run(label, grid, cfg, stream, ops, refs, least_deferred=0, min_plus=None,
              verbose=True):
    """One engine on ``grid`` under ``cfg`` serves ``stream``, a list of
    (rid, operand pair, semiring, refused?) over ``ops`` (pair -> (a, b,
    mask, mask_id)), with every launch count set to 0 just before the run
    and read just after. The expected plan-cache hits and misses come from
    ``matrix_signature`` on the host before the run. Checks, on the card:
    the stats (hits, misses, refused, served exact; at least
    ``least_deferred`` deferrals); each refused request refused with no
    dispatch; every plus_times C against ``refs(pair)``, scipy's (keys,
    values) on the card (structure identical, values within VALUE_RTOL);
    every min_plus C bit for bit against ``min_plus(pair)``;
    repeats of one pair on the ESC and k-binned multiplies bit-identical;
    a cache hit dispatched at its miss's static signature when every
    request of its key so far was the same operand pair and the miss took
    no retry (another pair's needs fold into the key's floors). Returns the
    record the caller logs and compares, with each served C's value sum."""
    import torch

    from repro_torch.core import semiring as sr
    from repro_torch.serve import MultiplyRequest, SpgemmEngine, matrix_signature

    reqs = []
    for rid, pair, semiring, _ in stream:
        a, b, mask, mask_id = ops[pair]
        reqs.append(MultiplyRequest(rid=rid, a=a, b=b, semiring=sr.get(semiring), mask=mask,
                                    mask_id=mask_id))
    keys = {req.rid: matrix_signature(req, grid, cfg) for req in reqs}
    refused = {rid for rid, _, _, no in stream if no}
    first_of = {}
    for rid, *_ in stream:
        if rid not in refused:
            first_of.setdefault(keys[rid], rid)
    want = {"hits": len(stream) - len(refused) - len(first_of), "misses": len(first_of),
            "refused": len(refused), "served": len(stream) - len(refused)}

    eng = SpgemmEngine(grid, cfg)
    sigs, flops, peak_in_use = {}, {}, [0]
    real_dispatch, real_admit = eng._dispatch, eng._admit

    def dispatch(act, bi):
        if act.req.rid not in sigs:
            sigs[act.req.rid] = (act.nb, act.caps, act.sel_cap, act.kb, act.hc, act.mask_cap,
                                 act.A.cap, act.B.cap)
            flops[act.req.rid] = act.plan.total_flops
        return real_dispatch(act, bi)

    def admit():
        real_admit()
        peak_in_use[0] = max(peak_in_use[0], eng.in_use)

    eng._dispatch, eng._admit = dispatch, admit
    counters = counted_kernels()
    for w in counters.values():
        w.launches = 0
    torch.cuda.synchronize(grid.device)
    base = torch.cuda.memory_allocated(grid.device)
    torch.cuda.reset_peak_memory_stats(grid.device)
    t0 = time.perf_counter()
    for req in reqs:
        eng.submit(req)
    eng.run_to_completion()
    torch.cuda.synchronize(grid.device)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(grid.device)
    launches = {name: w.launches for name, w in counters.items()}

    stats = dict(eng.stats)
    if {k: stats[k] for k in want} != want or stats["deferred"] < least_deferred:
        raise AssertionError(f"{label}: stats {stats}, expected {want} and at least "
                             f"{least_deferred} deferred")
    spec = {rid: (pair, semiring) for rid, pair, semiring, _ in stream}
    first_bits, errs, dispatches, lines, sums = {}, [0.0], {}, [], {}
    pairs_of = {}
    for rid, pair, _, _ in stream:
        if rid not in refused:
            pairs_of.setdefault(keys[rid], []).append((rid, pair))
    for r in eng.done:
        pair, semiring = spec[r.rid]
        lines.append(f"  rid {r.rid} {pair} {semiring}: {r.status}, b={r.num_batches}, price "
                     f"{r.price_bytes} B, retries {r.report.retries} (selection "
                     f"{r.report.sel_retries}), splits {r.splits}, cached {r.plan_cached}, "
                     f"deferred {r.was_deferred}, latency {r.latency_ms:.1f} ms"
                     + (f", {r.reason}" if r.reason else ""))
        if r.rid in refused:
            if r.status != "refused" or r.rid in sigs:
                raise AssertionError(f"{label}: rid {r.rid} must be refused with no dispatch: "
                                     f"{r.status}, dispatched {r.rid in sigs}")
            continue
        if r.status != "ok":
            raise AssertionError(f"{label}: rid {r.rid} {r.status}: {r.reason}")
        path = eng.plan_cache[keys[r.rid]].local_path
        if path == "binned" and semiring != "plus_times":
            path = "esc"  # the k-binned multiply sums only
        dispatches[path] = dispatches.get(path, 0) + r.num_batches + r.report.retries
        nnz = int(r.c.nnz)
        key = r.c.rows[:nnz].long() * r.c.shape[1] + r.c.cols[:nnz].long()
        vals = r.c.vals[:nnz]
        sums[r.rid] = float(vals.double().sum())
        if semiring == "min_plus":
            ref_key, ref_val = min_plus(pair)
            if not (torch.equal(key, ref_key)
                    and torch.equal(vals.view(torch.int32), ref_val.view(torch.int32))):
                raise AssertionError(f"{label}: rid {r.rid}: min_plus C differs from "
                                     f"batched_summa3d's")
        else:
            ref_key, ref_val = refs(pair)
            if key.shape != ref_key.shape or not torch.equal(key, ref_key):
                raise AssertionError(f"{label}: rid {r.rid}: structure differs from scipy: "
                                     f"{key.numel()} vs {ref_key.numel()} entries")
            err = float(((vals - ref_val).abs() / ref_val.abs()).max()) if nnz else 0.0
            if not err <= VALUE_RTOL:
                raise AssertionError(f"{label}: rid {r.rid}: max rel err {err} against scipy")
            errs.append(err)
        if path in ("esc", "binned"):
            first = first_bits.setdefault((pair, semiring), (r.rid, key, vals))
            if not (torch.equal(first[1], key)
                    and torch.equal(first[2].view(torch.int32), vals.view(torch.int32))):
                raise AssertionError(f"{label}: rid {r.rid} repeats rid {first[0]} with other bits")
        miss = first_of[keys[r.rid]]
        before = [p for rid, p in pairs_of[keys[r.rid]] if rid <= r.rid]
        miss_retries = eng.done[[x.rid for x in eng.done].index(miss)].report.retries
        if r.plan_cached and set(before) == {pair} and not miss_retries:
            if sigs[r.rid] != sigs[miss]:
                raise AssertionError(f"{label}: hit rid {r.rid} dispatched at {sigs[r.rid]}, its "
                                     f"miss rid {miss} at {sigs[miss]}")
    ok = [r for r in eng.done if r.status == "ok"]
    lat = np.array([r.latency_ms for r in ok])
    hit = [r.latency_ms for r in ok if r.plan_cached]
    miss = [r.latency_ms for r in ok if not r.plan_cached]
    rec = {
        "stats": stats, "keys": repr([keys[r.rid] for r in eng.done]),
        "results": [(r.rid, r.status, r.plan_cached, r.was_deferred, r.splits, r.num_batches,
                     r.price_bytes, r.report.retries) for r in eng.done],
        "sums": sums, "wall": wall, "peak": peak, "base": base, "peak_in_use": peak_in_use[0],
        "budget": cfg.per_process_memory, "launches": launches, "dispatches": dispatches,
        "max_rel_err": max(errs), "p50": float(np.percentile(lat, 50)),
        "p99": float(np.percentile(lat, 99)), "requests_per_s": len(ok) / wall,
        "products_per_s": sum(flops.values()) / wall,
        "hit_ms": float(np.mean(hit)) if hit else None,
        "miss_ms": float(np.mean(miss)) if miss else None,
    }
    summary = (f"{label}: {stats}; wall {wall:.2f} s, {rec['requests_per_s']:.3f} requests/s, "
               f"{rec['products_per_s']:.4g} partial products/s; latency p50 {rec['p50']:.1f} "
               f"ms, p99 {rec['p99']:.1f} ms; mean hit {rec['hit_ms']} ms against miss "
               f"{rec['miss_ms']} ms; peak {peak / 2**30:.3f} GiB ({base / 2**30:.3f} before) "
               f"against budget {cfg.per_process_memory / 2**30:.3f} GiB and admitted prices "
               f"{peak_in_use[0] / 2**30:.3f} GiB at most; launches {launches}, batch "
               f"dispatches by path {dispatches}; max rel err {rec['max_rel_err']:.3g}")
    if verbose:
        log(summary)
        for line in lines:
            log(line)
    return rec


def _csr(x):
    import scipy.sparse as sps

    from repro_torch.core import convert

    r, c, v = convert.triplets(x)
    return sps.csr_matrix((v, (r, c)), shape=x.shape)


_PRODUCTS = {}


def _products_init(parts):
    _PRODUCTS.update(parts)


def _product_task(name):
    return _product(*_PRODUCTS[name])


def _product(a, b, mask):
    """scipy's a @ b (⊙ mask's structure) of CSR matrices: (row-major keys,
    values)."""
    p = a @ b
    if mask is not None:
        p = p.multiply(mask != 0)
    p = p.tocsr()
    p.sort_indices()
    rows = np.repeat(np.arange(p.shape[0], dtype=np.int64), np.diff(p.indptr))
    return rows * p.shape[1] + p.indices.astype(np.int64), np.asarray(p.data, np.float32)


class ScipyProducts:
    """scipy's products of ``ops`` (pair -> (a, b, mask, mask_id)), each
    as (row-major keys, values), computed in a pool of worker processes
    while the card works; ``get(pair, device)`` waits for one and moves it
    to ``device`` once. Use as a context manager: the pool ends with it."""

    def __init__(self, ops, workers=4):
        import multiprocessing

        parts = {pair: (_csr(a), _csr(b), None if m is None else _csr(m))
                 for pair, (a, b, m, _) in ops.items()}
        self.pool = multiprocessing.get_context("spawn").Pool(
            min(workers, len(parts)), initializer=_products_init, initargs=(parts,))
        self.pending = {pair: self.pool.apply_async(_product_task, (pair,)) for pair in parts}
        self.moved = {}

    def get(self, pair, device):
        import torch

        if pair not in self.moved:
            self.moved[pair] = tuple(torch.as_tensor(x, device=device)
                                     for x in self.pending[pair].get())
        return self.moved[pair]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.pool.terminate()
        self.pool.join()


def scipy_product(a, b, mask=None):
    """scipy's A @ B (⊙ the mask's structure): (row-major keys, values)."""
    ca = _csr(a)
    return _product(ca, ca if b is a else _csr(b), None if mask is None else _csr(mask))


def scipy_refs(ops, device):
    """``serve_run``'s ``refs`` computed here, once a pair: scipy's product
    of ``ops[pair]`` on ``device``."""
    import torch

    done = {}

    def refs(pair):
        if pair not in done:
            done[pair] = tuple(torch.as_tensor(x, device=device)
                               for x in scipy_product(*ops[pair][:3]))
        return done[pair]

    return refs


def esc_mix(grid, a0, novel, label, refs, verbose=True):
    """13a's mix on ``grid`` on the ESC engine of ``serve_budget``: with 6
    novel operand pairs (``novel``: pair -> ops entry), 16 requests (8
    repeats of A0·A0, the 6 novel products, a min_plus A0 ⊗ A0 and one
    request no split fits, ``refused_operand``); with one, 6 requests (3
    repeats). ``refs`` gives scipy's products (``serve_run``). Returns
    ``serve_run``'s record with the budget search's b, price and budget."""
    t0 = time.perf_counter()
    cfg, b0, price, low = serve_budget(a0, grid, SERVE_LEAST_B)
    t_budget = time.perf_counter() - t0
    big, need = refused_operand(a0.shape[0], grid, cfg.per_process_memory)
    t_refused = time.perf_counter() - t0 - t_budget
    ops = {"A0": (a0, a0, None, None), "refused": (big, big, None, None), **novel}
    names = list(novel)
    if len(names) == 6:
        order = ["A0", "A0", "A0", names[0], "A0", names[1], "min", "A0", names[2], names[3],
                 "A0", "refused", names[4], "A0", names[5], "A0"]
    else:
        order = ["A0", "A0", names[0], "min", "refused", "A0"]
    stream = [(rid, "A0" if p == "min" else p, "min_plus" if p == "min" else "plus_times",
               p == "refused") for rid, p in enumerate(order)]
    if verbose:
        log(f"{label}: budget {cfg.per_process_memory} B = 2.5 x the price {price} B of A0·A0 "
            f"at b={b0}, the plan's b at {low} B (the least budget for b >= {SERVE_LEAST_B}; "
            f"{t_budget:.1f} s); seed floor b={b0}; refused operand: {int(big.nnz)} entries, "
            f"{need} B of per-process inputs ({t_refused:.1f} s)")
    mp = {}

    def min_plus(pair):
        if pair not in mp:
            mp[pair] = min_plus_reference(ops[pair][0], grid, cfg.per_process_memory, "esc")
        return mp[pair]

    t0 = time.perf_counter()
    rec = serve_run(label, grid, cfg, stream, ops, refs, least_deferred=1, min_plus=min_plus,
                    verbose=verbose)
    del big, ops
    rec.update(b0=b0, price=price, low=low, refused_inputs=need, budget_s=t_budget,
               refused_s=t_refused, check_s=time.perf_counter() - t0 - rec["wall"])
    if verbose:
        log(f"{label}: set-up {t_budget + t_refused:.1f} s, checks {rec['check_s']:.1f} s")
    return rec


def serve_phase(grid, tri16):
    """Phase 13 (one card): 13a the ESC engine (``esc_mix`` of 16 at n =
    2^18), 13b the hash engine (seed floor b = 64: 4 repeats of A0·A0, 2
    novel products and 2 masked triangle-count products L·U ⊙ L of R-MAT
    scale 16 whose C sums to phase 10's count ``tri16``), 13c the
    reference's default ServeConfig ("auto") at n = 2^14 with phase 3c's
    budget (4 repeats, 4 novel). scipy's products are computed in a pool
    of worker processes while the card works. Every engine's launch
    counts are set to 0 just before its run and read just after; the hash
    engine must launch the fused kernel once a batch dispatch and the
    one-chunk kernel never, the auto engine the binned kernel once a
    k-binned batch dispatch, the ESC engine the segment reduction at least
    once a batch dispatch. Returns each engine's record."""
    import torch

    from repro_torch.core import gen
    from repro_torch.core.specs import PlanFloors
    from repro_torch.serve import ServeConfig
    from repro_torch.sparse_apps import graph_algorithms as ga

    t_phase = time.perf_counter()
    out = {}
    a0, a14 = protein(N_MCL), protein(N_DEFAULT)
    novel = {}
    for m, seed in SERVE_NOVEL:
        x = protein(m, seed)
        novel[f"n{m}s{seed}"] = (x, x, None, None)
    g = gen.symmetrized(gen.rmat(TRI_PINNED_SCALE, edge_factor=16, seed=5, device="cpu"))
    L, U = ga._strict_parts(g)
    small = {}
    for seed in range(1, 5):
        x = protein(N_DEFAULT, seed)
        small[f"n{N_DEFAULT}s{seed}"] = (x, x, None, None)
    ops = {"A0": (a0, a0, None, None), "tri16": (L, U, L, "tri16"),
           "A14": (a14, a14, None, None), **novel, **small}
    log(f"13: A0 n={N_MCL}, nnz {int(a0.nnz)} ({int(a0.nnz) / N_MCL:.2f}/row); operands "
        f"{time.perf_counter() - t_phase:.1f} s")
    with ScipyProducts(ops) as ref:
        refs = lambda pair: ref.get(pair, grid.device)  # noqa: E731
        rec = out["13a"] = esc_mix(grid, a0, novel, "13a ESC engine n=2^18", refs)
        if rec["launches"]["segment_reduce"] < rec["dispatches"].get("esc", 0):
            raise AssertionError(f"13a: segment reduction launched {rec['launches']} for "
                                 f"{rec['dispatches']} batch dispatches")
        torch.cuda.empty_cache()

        hashed = [SERVE_NOVEL[0], SERVE_NOVEL[3]]  # 13a's first novel of each size
        order = ["A0", "A0", "n{}s{}".format(*hashed[0]), "tri16", "A0",
                 "n{}s{}".format(*hashed[1]), "tri16", "A0"]
        cfg = ServeConfig(per_process_memory=rec["budget"], local_path="hash",
                          seed_floors=PlanFloors(num_batches=SERVE_HASH_FLOOR))
        rec = out["13b"] = serve_run(
            "13b hash engine n=2^18", grid, cfg,
            [(rid, p, "plus_times", False) for rid, p in enumerate(order)], ops, refs)
        counts = [int(round(rec["sums"][rid])) for rid, p in enumerate(order) if p == "tri16"]
        if counts != [tri16] * 2:
            raise AssertionError(f"13b: the masked products sum to {counts}, phase 10 counted "
                                 f"{tri16}")
        if (rec["launches"]["hash"] != rec["dispatches"].get("hash", -1)
                or rec["launches"]["hash_chunk"] != 0 or set(rec["dispatches"]) != {"hash"}):
            raise AssertionError(f"13b: the fused hash kernel must launch once a batch "
                                 f"dispatch ({rec['dispatches']}) and the one-chunk kernel "
                                 f"never: {rec['launches']}")
        log(f"13b: the masked products hold {counts[0]} triangles, as phase 10 counted")
        torch.cuda.empty_cache()

        order = [p for pair in small for p in ("A14", pair)]
        cfg = ServeConfig(per_process_memory=48 * int(a14.nnz))
        rec = out["13c"] = serve_run(
            "13c default ServeConfig n=2^14", grid, cfg,
            [(rid, p, "plus_times", False) for rid, p in enumerate(order)], ops, refs)
        if (rec["launches"]["binned"] != rec["dispatches"].get("binned", -1)
                or rec["launches"]["hash"] != 0):
            raise AssertionError(f"13c: the binned kernel must launch once a k-binned batch "
                                 f"dispatch ({rec['dispatches']}): {rec['launches']}")
        del ops, refs
    torch.cuda.empty_cache()
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s")
    return out


def phase13_rank(grid, p13):
    """Phase 13 on one rank of the distributed phase (see ``grid_rank``):
    13a's mix of 6 at n = ``p13["n"]`` on each of ``p13["shapes"]``; with
    ``p13["mcl_host"]``, ``mcl_iterate_host`` (phase 8's sparse n = 2^14
    loop) on the launcher's grid, which rank 0 first runs on a 1x1x1 grid
    of its own card and holds the grid's loop against (nnz within
    NNZ_RTOL, identical partitions)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.core.grid import make_grid
    from repro_torch.sparse_apps import mcl

    out = {"serve": {}}
    n = p13["n"]
    a0, x = protein(n), protein(n // 2, 1)
    novel = {f"n{n // 2}s1": (x, x, None, None)}
    refs = scipy_refs({"A0": (a0, a0, None, None), **novel}, grid.device)
    for shape in p13["shapes"]:
        g = grid if shape == (grid.pr, grid.pc, grid.l) else make_grid(*shape, device=grid.device)
        dist.barrier()
        tag = "x".join(map(str, shape))
        out["serve"][shape] = esc_mix(g, a0, novel, f"9 serve {tag} n={n} rank {g.rank}", refs,
                                      verbose=g.rank == 0)
        torch.cuda.empty_cache()
    if p13["mcl_host"]:
        a, cfg = mcl_dense_input()
        cfg = dataclasses.replace(cfg, path="sparse")
        one = None
        if grid.rank == 0:
            one = run_mcl(mcl.mcl_iterate_host, a, make_grid(1, 1, 1, device=grid.device), cfg,
                          "mcl host loop n=2^14, one card (rank 0)")
        dist.barrier()
        fin, hist, wall, peak, launches = run_mcl(
            mcl.mcl_iterate_host, a, grid, cfg,
            f"mcl host loop n=2^14, grid {grid.pr}x{grid.pc}x{grid.l}, rank {grid.rank}")
        out["mcl_host"] = {"wall": wall, "nnz": [h["nnz"] for h in hist],
                           "batches": [h["batches"] for h in hist]}
        if one is not None:
            compare_loops("mcl host loop n=2^14, grid vs one card", hist, one[1],
                          partition(fin, N_DEFAULT), partition(one[0], N_DEFAULT))
            out["mcl_host"]["one_card_wall"] = one[2]
    return out


def log_phase13_ranks(ranks, backend):
    """The serving records of every rank of the distributed phase: every
    rank's stats, results and cache keys must equal rank 0's. Returns the
    segment reduction's launches per rank by shape."""
    launches = {}
    for shape in ranks[0]["p13"]["serve"]:
        tag = "x".join(map(str, shape))
        per = [x["p13"]["serve"][shape] for x in ranks]
        for field in ("stats", "results", "keys"):
            if any(x[field] != per[0][field] for x in per):
                raise AssertionError(f"9 serve {tag}: the ranks' {field} differ: "
                                     f"{[x[field] for x in per]}")
        launches[tag] = [x["launches"]["segment_reduce"] for x in per]
        log(f"9 serve {tag} ({backend}): every rank the same stats {per[0]['stats']}, results "
            f"and cache keys; walls {[round(x['wall'], 3) for x in per]} s, p50 "
            f"{[round(x['p50'], 1) for x in per]} ms, p99 {[round(x['p99'], 1) for x in per]} "
            f"ms, peaks {[round(x['peak'] / 2**30, 3) for x in per]} GiB against budget "
            f"{per[0]['budget'] / 2**30:.3f} GiB (admitted at most "
            f"{per[0]['peak_in_use'] / 2**30:.3f}), segment launches per rank {launches[tag]}")
    if "mcl_host" in ranks[0]["p13"]:
        per = [x["p13"]["mcl_host"] for x in ranks]
        if any(x["nnz"] != per[0]["nnz"] for x in per):
            raise AssertionError(f"mcl host loop on the grid: the ranks' trajectories differ: "
                                 f"{[x['nnz'] for x in per]}")
        log(f"mcl host loop n=2^14 ({backend}): every rank nnz {per[0]['nnz']}, b "
            f"{per[0]['batches']}; walls {[round(x['wall'], 2) for x in per]} s, one card "
            f"{per[0]['one_card_wall']:.2f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 14: the LM serving path — models, configs, the continuous-batching engine
# ---------------------------------------------------------------------------
LM_RTOL = 2e-3  # forward's last position vs prefill + one decode (the JAX package's own check)
LM_DISPATCH_RTOL = 1e-4  # "spgemm" vs "scatter" MoE dispatch (the JAX package's own check)
LM_SEED = 0
OLMOE = "olmoe-1b-7b"
OLMOE_REQUESTS = 16
OLMOE_PROMPT = (64, 512)  # prompt lengths drawn from this range, both ends included
OLMOE_NEW = 32
OLMOE_BATCH, OLMOE_S_MAX = 8, 1024
OLMOE_F32_LAYERS = 2  # 14d: OLMoE at full width in f32, cut to this depth


def lm_model(cfg, seed):
    """The port's seeded init of ``cfg`` on the card."""
    import torch

    from repro_torch.models import transformer

    g = torch.Generator(device="cuda").manual_seed(seed)
    return transformer.init_params(cfg, g, "cuda")


def lm_inputs(cfg, shape, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    if cfg.input_mode == "tokens":
        return torch.randint(0, cfg.vocab, shape, generator=g, device="cuda")
    return torch.randn(shape + (cfg.d_model,), generator=g, device="cuda")


def check_lm(label, cfg, model, seed):
    """14a/14d: forward's last position against prefill of the first 7
    positions and one decode (B = 1: 8 tokens at most, one capacity block
    of 8, so no MoE assignment is dropped in any of the three calls) within
    LM_RTOL; for an MoE model, forward on a (2, 16) batch with "spgemm"
    dispatch against "scatter" within LM_DISPATCH_RTOL. The SpMM kernel's
    count, set to 0 just before, must read 2 a MoE layer a model call in
    "spgemm" mode after. Returns (consistency err, dispatch err or None,
    spgemm model calls, SpMM launches)."""
    import dataclasses

    import torch

    from repro_torch.kernels.spmm_kernel import spmm_cuda
    from repro_torch.models import transformer as tfm

    spmm_cuda.launches = 0
    seq = lm_inputs(cfg, (1, 8), seed)
    full, _ = tfm.forward(cfg, model, seq)
    _, cache = tfm.prefill(cfg, model, seq[:, :7], s_max=16)
    dec, _ = tfm.decode_step(cfg, model, cache, seq[:, 7:], 7)
    calls = 3
    want = full[:, -1, :cfg.vocab]
    err = float((dec - want).abs().max())
    if not torch.allclose(dec, want, rtol=LM_RTOL, atol=LM_RTOL):
        raise AssertionError(f"{label}: prefill + decode differs from forward, max abs err {err}")
    derr = None
    if cfg.moe:
        x = lm_inputs(cfg, (2, 16), seed + 1)
        spgemm, _ = tfm.forward(cfg, model, x)
        calls += 1
        torch.cuda.synchronize()
        before = spmm_cuda.launches
        scatter_cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch_mode="scatter"))
        scatter, _ = tfm.forward(scatter_cfg, model, x)
        torch.cuda.synchronize()
        if spmm_cuda.launches != before:
            raise AssertionError(f"{label}: the scatter dispatch launched the SpMM kernel")
        spgemm, scatter = spgemm[..., :cfg.vocab], scatter[..., :cfg.vocab]
        derr = float((spgemm - scatter).abs().max())
        if not torch.allclose(spgemm, scatter, rtol=LM_DISPATCH_RTOL, atol=LM_DISPATCH_RTOL):
            raise AssertionError(f"{label}: spgemm dispatch differs from scatter, max abs err "
                                 f"{derr}")
    torch.cuda.synchronize()
    launches = spmm_cuda.launches
    want_launches = 2 * cfg.n_layers * calls if cfg.moe else 0
    if launches != want_launches:
        raise AssertionError(f"{label}: {launches} SpMM launches, want {want_launches}")
    return err, derr, calls, launches


def lm_smoke_phase():
    """14a: every SMOKE architecture on the card, in f32, the port's seeded init."""
    from repro_torch.configs import ARCHS, get_config

    out = {}
    for i, arch in enumerate(ARCHS):
        cfg = get_config(arch, smoke=True)
        err, derr, calls, launches = check_lm(f"14a {arch}", cfg, lm_model(cfg, LM_SEED + i),
                                              LM_SEED + i)
        out[arch] = {"max_abs_err": err, "dispatch_max_abs_err": derr, "launches": launches}
        log(f"14a {arch} ({cfg.family}{', moe' if cfg.moe else ''}): prefill + decode vs "
            f"forward max abs err {err:.3g}"
            + ("" if derr is None else f"; spgemm vs scatter {derr:.3g}, {launches} SpMM "
               f"launches = 2 x {cfg.n_layers} layers x {calls} calls"))
    return out


def olmoe_prompts(cfg):
    rng = np.random.default_rng(LM_SEED)
    lengths = rng.integers(OLMOE_PROMPT[0], OLMOE_PROMPT[1] + 1, OLMOE_REQUESTS)
    return [rng.integers(0, cfg.vocab, int(s)).astype(np.int32) for s in lengths]


def olmoe_engine(cfg, model, prompts):
    from repro_torch.serve import EngineConfig, Request, ServeEngine

    eng = ServeEngine(cfg, model, EngineConfig(max_batch=OLMOE_BATCH, s_max=OLMOE_S_MAX))
    for rid, prompt in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=OLMOE_NEW))
    return eng


def serve_olmoe(cfg, model, prompts, profile):
    """One run of the stream through the engine, driven tick by tick: the
    SpMM count set to 0 just before and read just after; the host time of
    every prefill (each ends in a read of its token) and of every tick
    without an admission (each ends in the logits' copy to the host). With
    ``profile``, one such tick from the fifth on is profiled (another, up to
    PROFILE_ATTEMPTS, if the profiler records no SpMM launch), with its own
    host time inside the profiled window (the profiler's own host cost
    included); it is left out of ``tick_ms``."""
    import torch

    from repro_torch.kernels.spmm_kernel import spmm_cuda

    eng = olmoe_engine(cfg, model, prompts)
    prefill_s = []
    inner = eng._prefill_into_slot

    def timed(slot, req):
        t = time.perf_counter()
        inner(slot, req)
        prefill_s.append(time.perf_counter() - t)

    eng._prefill_into_slot = timed
    torch.cuda.synchronize()
    spmm_cuda.launches = 0
    ticks, tick_ms, prof, attempts = 0, [], None, 0
    t0 = time.perf_counter()
    while eng.queue or eng.active:
        admits = bool(eng.queue) and bool(eng._free_slots())
        if profile and prof is None and not admits and ticks >= 4:
            attempts += 1
            host_ms = []

            def timed_step():
                t = time.perf_counter()
                eng.step()
                host_ms.append((time.perf_counter() - t) * 1e3)

            total, times = profile_top("14b decode tick (8 slots)", timed_step, rows=12,
                                       kernel="spmm_tile_kernel")
            if times:
                prof = {"device_ms": total, "host_ms": host_ms[0],
                        "idle_share": 1 - total / host_ms[0], "spmm_ms": sum(times) / 1e3,
                        "spmm_launches": len(times), "spmm_share": sum(times) / 1e3 / total}
            elif attempts == PROFILE_ATTEMPTS:
                raise RuntimeError(f"14b: the profiler recorded no SpMM launch in {attempts} "
                                   f"decode ticks")
        else:
            t = time.perf_counter()
            eng.step()
            if not admits:
                tick_ms.append((time.perf_counter() - t) * 1e3)
        ticks += 1
    wall = time.perf_counter() - t0
    return {"done": eng.done, "ticks": ticks, "launches": spmm_cuda.launches, "wall": wall,
            "prefill_s": prefill_s, "tick_ms": tick_ms, "profile": prof}


def captured_spmm(fn, count=2):
    """The first ``count`` (A, B) operands ``core.local_spgemm.spmm`` gets
    while ``fn()`` runs (the MoE calls it through the module): layer 0's
    dispatch and combine."""
    from repro_torch.core import local_spgemm

    seen, inner = [], local_spgemm.spmm

    def spy(a, b, *args, **kw):
        if len(seen) < count:
            seen.append((a, b.clone()))
        return inner(a, b, *args, **kw)

    local_spgemm.spmm = spy
    try:
        fn()
    finally:
        local_spgemm.spmm = inner
    return seen


def olmoe_phase():
    """14b: OLMoE-1B-7B at its published width and depth, bf16, served
    twice; then the operands 14c holds the kernel on."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import param_count

    cfg = get_config(OLMOE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = lm_model(cfg, LM_SEED)
    torch.cuda.synchronize()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"14b {OLMOE}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads x "
        f"{cfg.hdim}, {cfg.moe.n_experts} experts top-{cfg.moe.top_k}, d_expert "
        f"{cfg.moe.d_expert}, vocab {cfg.vocab}; {param_count(model)} parameters, {weights} B "
        f"in {cfg.dtype}, seeded init on the card {time.perf_counter() - t0:.2f} s")
    prompts = olmoe_prompts(cfg)
    n_tok = sum(len(p) for p in prompts)
    runs = []
    for run in range(2):
        r = serve_olmoe(cfg, model, prompts, profile=run == 1)
        want = 2 * cfg.n_layers * (len(prompts) + r["ticks"])
        if r["launches"] != want:
            raise AssertionError(f"14b run {run + 1}: {r['launches']} SpMM launches, want "
                                 f"2 x {cfg.n_layers} x ({len(prompts)} prefills + "
                                 f"{r['ticks']} ticks) = {want}")
        tokens = {req.rid: list(req.out_tokens) for req in r["done"]}
        if sorted(tokens) != list(range(len(prompts))) or any(
                len(v) != OLMOE_NEW or not all(0 <= x < cfg.vocab for x in v)
                for v in tokens.values()):
            raise AssertionError(f"14b run {run + 1}: every request must get {OLMOE_NEW} "
                                 f"in-range tokens: {tokens}")
        r["tokens"] = tokens
        runs.append(r)
        log(f"14b run {run + 1}: {len(prompts)} requests served in {r['wall']:.3f} s, "
            f"{r['ticks']} ticks, {r['launches']} SpMM launches = 2 x {cfg.n_layers} x "
            f"({len(prompts)} + {r['ticks']}); prefill {n_tok} prompt tokens in "
            f"{sum(r['prefill_s']):.3f} s ({n_tok / sum(r['prefill_s']):.1f} tokens/s); "
            f"{len(r['tick_ms'])} decode-only ticks, {np.mean(r['tick_ms']):.3f} ms mean, "
            f"{np.median(r['tick_ms']):.3f} ms median")
    if runs[0]["tokens"] != runs[1]["tokens"]:
        raise AssertionError("14b: the two runs of the stream give other tokens")
    peak = torch.cuda.max_memory_allocated() - base
    prof = runs[1]["profile"]
    kv = 2 * cfg.n_layers * OLMOE_BATCH * OLMOE_S_MAX * cfg.kv_heads * cfg.hdim * 2
    log(f"14b: both runs the same {len(prompts) * OLMOE_NEW} tokens; peak {peak / 2**30:.3f} GiB "
        f"above the {base / 2**30:.3f} GiB held before (weights {weights / 2**30:.3f} GiB, KV "
        f"cache {kv / 2**30:.3f} GiB); profiled decode tick {prof['device_ms']:.3f} ms device "
        f"time, SpMM {prof['spmm_ms']:.4f} ms in {prof['spmm_launches']} launches "
        f"({100 * prof['spmm_share']:.2f} %) against its own {prof['host_ms']:.3f} ms on the "
        f"host under the profiler ({100 * prof['idle_share']:.2f} % idle; against run 2's "
        f"median unprofiled tick {np.median(runs[1]['tick_ms']):.3f} ms: "
        f"{100 * (1 - prof['device_ms'] / np.median(runs[1]['tick_ms'])):.2f} %)")

    # 14c's operands: layer 0's dispatch and combine in a prefill of T = 512
    # tokens and in a decode tick of all 8 slots after the stream's first 8
    # prefills
    long_prompt = np.random.default_rng(LM_SEED + 1).integers(
        0, cfg.vocab, OLMOE_PROMPT[1]).astype(np.int32)
    prefill_ops = captured_spmm(lambda: tfm.prefill(
        cfg, model, torch.as_tensor(long_prompt, device="cuda")[None], s_max=OLMOE_S_MAX))
    eng = olmoe_engine(cfg, model, prompts[:OLMOE_BATCH])
    eng.step()
    decode_ops = captured_spmm(eng.step)
    # run 1 is the warm-up; run 2's figures are the stream's (its wall
    # holds the profiled tick)
    stats = {"ticks": runs[1]["ticks"], "launches": [r["launches"] for r in runs],
             "peak_gib": peak / 2**30, "weights_gib": weights / 2**30, "profile": prof}
    for key, r in (("warmup", runs[0]), ("warm", runs[1])):
        stats[key] = {"wall_s": r["wall"], "prefill_tokens_per_s": n_tok / sum(r["prefill_s"]),
                      "decode_tick_ms_mean": float(np.mean(r["tick_ms"])),
                      "decode_tick_ms_median": float(np.median(r["tick_ms"]))}
    del model, eng
    return stats, {"prefill_T512": prefill_ops, "decode_T8": decode_ops}


def check_moe_spmm(label, a, b, phase="14c"):
    """14c (and 15b, ``phase``): the SpMM kernel on one MoE operand pair (A
    the dispatch or combine matrix or a transpose, B the tokens, the expert
    outputs or a gradient) against its plain
    version within rtol KERNEL_RTOL, with bf16 values and B and in f32
    (both sum in f32), bit-identical between calls; timed as in 4 beside
    torch.sparse.mm (CSR x dense, f32). The bound counts the live entries,
    the rows of B they name and C, each once."""
    import torch

    from repro_torch.kernels.spmm_kernel import spmm_cuda, spmm_ref

    m, k = a.shape
    n = b.shape[1]
    valid = a.valid_mask()
    rows = torch.where(valid, a.rows, torch.full_like(a.rows, m))
    vals = torch.where(valid, a.vals, torch.zeros_like(a.vals))
    live = (rows < m) & (a.cols < k)
    nnz = int(live.sum())
    b_rows = int(torch.unique(a.cols[live]).numel())
    out = {"m": m, "k": k, "n": n, "entries": a.cap, "live": nnz}
    for dtype in (torch.bfloat16, torch.float32):
        args = (rows, a.cols, vals.to(dtype), b.to(dtype).contiguous(), m)
        got, again, want = spmm_cuda(*args), spmm_cuda(*args), spmm_ref(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=1e-6):
            raise AssertionError(f"{phase} {label} {dtype}: kernel differs from plain, max abs err "
                                 f"{err}")
        if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
            raise AssertionError(f"{phase} {label} {dtype}: two calls differ")
        ms = device_ms(lambda: spmm_cuda(*args), 1, "spmm_tile_kernel", 5)
        elt = args[3].element_size()
        bound, by = bound_ms(nnz * (8 + elt) + b_rows * n * elt + 4 * m * n, 2 * nnz * n)
        plain = cuda_ms(lambda: spmm_ref(*args), 3)
        key = "bf16" if dtype == torch.bfloat16 else "f32"
        out[key] = {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                    "max_abs_err": err}
        log(f"{phase} {label} {key}: A {m} x {k} ({nnz} live of {a.cap} entries, {b_rows} rows of "
            f"B), n {n}: {ms:.6f} ms device time (plain {plain:.4f}), bound {bound:.6f} ms "
            f"({by}), {100 * bound / ms:.2f} % of bound, max abs err {err:.3g}, two calls "
            f"bit-identical")
    b32 = b.float().contiguous()
    a_csr = torch.sparse_coo_tensor(
        torch.stack([rows[live].long(), a.cols[live].long()]), vals[live].float(), (m, k),
        check_invariants=False,
    ).coalesce().to_sparse_csr()
    out["library_ms"] = library_device_ms(f"{phase} {label} torch.sparse.mm",
                                          lambda: torch.sparse.mm(a_csr, b32))
    return out


def lm_phase():
    """Phase 14: the LM serving path (14a-d). Returns its records."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config

    # full f32 products: the checks' tolerances leave no room for TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    smoke = lm_smoke_phase()
    log(f"14a: {time.perf_counter() - t_phase:.1f} s")
    olmoe, ops = olmoe_phase()
    torch.cuda.empty_cache()
    spmm = {}
    for where, (dispatch, combine) in ops.items():
        spmm[f"dispatch_{where}"] = check_moe_spmm(f"dispatch {where}", *dispatch)
        spmm[f"combine_{where}"] = check_moe_spmm(f"combine {where}", *combine)
    del ops
    cfg = dataclasses.replace(get_config(OLMOE), n_layers=OLMOE_F32_LAYERS, dtype="float32")
    err, derr, _, launches = check_lm("14d", cfg, lm_model(cfg, LM_SEED + 100), LM_SEED + 100)
    log(f"14d {OLMOE} at full width in f32, {OLMOE_F32_LAYERS} layers: prefill + decode vs "
        f"forward max abs err {err:.3g}, spgemm vs scatter {derr:.3g}, {launches} SpMM launches")
    torch.cuda.empty_cache()
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return {"smoke": smoke, "olmoe": olmoe, "spmm": spmm,
            "f32": {"max_abs_err": err, "dispatch_max_abs_err": derr, "launches": launches}}


# ---------------------------------------------------------------------------
# phase 15: training — the differentiable SpMM, the train step, the
# restartable loop, hierarchical data parallelism, the launcher
# ---------------------------------------------------------------------------
TRAIN_SEED = 0
TRAIN_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)  # kernel vs plain SpMM: f32 sums in other orders
TRAIN_LOOP_STEPS, TRAIN_FAIL_STEP, TRAIN_CKPT_EVERY = 8, 5, 3
TRAIN_DP_STEPS = 4
OLMOE_TRAIN_LAYERS = 4  # of 16: f32 masters + grads + 2 moments = 16 B a parameter
OLMOE_TRAIN_BATCH, OLMOE_TRAIN_SEQ = 8, 2048
OLMOE_TRAIN_WARMUP, OLMOE_TRAIN_TIMED = 2, 8
OLMOE_TRAIN_OPT = dict(lr=1e-3, warmup_steps=2)


def moe_archs():
    from repro_torch.configs import ARCHS, get_config

    return [a for a in ARCHS if get_config(a, smoke=True).moe]


def train_batch(cfg, step, batch=4, seq=16):
    from repro_torch.data import DataConfig, synthetic_batch

    return synthetic_batch(DataConfig(seq_len=seq, global_batch=batch, vocab=cfg.vocab,
                                      seed=TRAIN_SEED), step, "cuda")


def train_grads(cfg, model, batch, plain):
    """One step's loss gradients (``cfg`` with remat off), through the SpMM
    kernel or, with ``plain``, its plain version forced on the card; with
    the SpMM operands' gradients: (named grads, [(dB, dvals or None) a call,
    in call order: layer by layer, dispatch then combine])."""
    from repro_torch.core import local_spgemm
    from repro_torch.kernels import spmm_kernel
    from repro_torch.models import transformer as tfm

    seen, inner, kernel = [], local_spgemm.spmm, spmm_kernel.spmm_cuda

    def spy(a, b, *args, **kw):
        for x in (a.vals, b):
            if x.requires_grad:
                x.retain_grad()
        seen.append((a.vals, b))
        return inner(a, b, *args, **kw)

    leaves = dict(model.named_parameters())
    for p in leaves.values():
        p.requires_grad_(True)
        p.grad = None
    local_spgemm.spmm = spy
    if plain:
        spmm_kernel.spmm_cuda = lambda rows, cols, vals, b, m, out=None: spmm_kernel.spmm_ref(
            rows, cols, vals, b, m, out=out)
    try:
        tfm.lm_loss(cfg, model, batch["inputs"], batch["targets"]).backward()
    finally:
        local_spgemm.spmm, spmm_kernel.spmm_cuda = inner, kernel
    grads = {k: p.grad for k, p in leaves.items()}
    for p in leaves.values():
        p.grad = None
    return grads, [(b.grad, v.grad) for v, b in seen]


def train_grads_phase(arch, cfg, model):
    """15a: kernel against forced plain, on one step's gradients."""
    import dataclasses

    import torch

    from repro_torch.kernels.spmm_kernel import spmm_cuda

    cfg = dataclasses.replace(cfg, remat=False)
    batch = train_batch(cfg, 0)
    spmm_cuda.launches = 0
    got, ops = train_grads(cfg, model, batch, plain=False)
    torch.cuda.synchronize()
    launches = spmm_cuda.launches
    if launches != 4 * cfg.n_layers:
        raise AssertionError(f"15a {arch}: {launches} SpMM launches, want 4 x {cfg.n_layers} "
                             f"(dispatch and combine forward, their dB)")
    want, ops_plain = train_grads(cfg, model, batch, plain=True)
    if spmm_cuda.launches != launches:
        raise AssertionError(f"15a {arch}: the forced plain run launched the kernel")
    errs = {}

    def hold(label, g, w):
        if g is None or w is None:
            raise AssertionError(f"15a {arch} {label}: no gradient")
        err = float((g - w).abs().max())
        if not torch.allclose(g, w, **TRAIN_GRAD_TOL):
            raise AssertionError(f"15a {arch} {label}: kernel vs plain max abs err {err}")
        errs[label] = max(errs.get(label, 0.0), err)

    for i, ((db, dv), (db_p, dv_p)) in enumerate(zip(ops, ops_plain)):
        combine = i % 2 == 1
        hold("dY" if combine else "dX", db, db_p)
        if combine:
            hold("dvals", dv, dv_p)
    for name, g in got.items():
        if ".moe." in name:
            hold("router" if name.endswith("router") else "experts", g, want[name])
    return {"launches": launches, "max_abs_err": errs}


def train_loop_phase(arch, cfg, root):
    """15a: run_training with a failure injected against the uninterrupted
    loop; returns (the uninterrupted run's result, the injected run's, the
    uninterrupted run's SpMM launches)."""
    import torch

    from repro_torch.kernels.spmm_kernel import spmm_cuda
    from repro_torch.optim import adamw
    from repro_torch.runtime import FailureInjector, RuntimeConfig, run_training
    from repro_torch.train import TrainConfig, build_train_step

    step_fn = build_train_step(cfg, TrainConfig(optimizer=adamw.AdamWConfig(**OLMOE_TRAIN_OPT)),
                               "cuda")

    def make_state():
        model = lm_master(cfg, TRAIN_SEED)
        return {"params": model, "opt": adamw.init_opt_state(model)}

    def step(state, batch):
        p, o, m = step_fn(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, m

    runs, launches = {}, {}
    for label, injector in (("plain", None), ("injected", FailureInjector(
            fail_steps=(TRAIN_FAIL_STEP,)))):
        torch.cuda.synchronize()
        spmm_cuda.launches = 0
        runs[label] = run_training(
            steps=TRAIN_LOOP_STEPS, make_state=make_state, step_fn=step,
            batch_fn=lambda s: train_batch(cfg, s), injector=injector,
            rc=RuntimeConfig(ckpt_dir=os.path.join(root, f"{arch}_{label}"),
                             ckpt_every=TRAIN_CKPT_EVERY))
        torch.cuda.synchronize()
        launches[label] = spmm_cuda.launches
    plain, res = runs["plain"], runs["injected"]
    want = 6 * cfg.n_layers * TRAIN_LOOP_STEPS
    if launches["plain"] != want:
        raise AssertionError(f"15a {arch} loop: {launches['plain']} SpMM launches, want 6 x "
                             f"{cfg.n_layers} x {TRAIN_LOOP_STEPS}")
    if (res.final_step, res.restarts, res.rollbacks) != (TRAIN_LOOP_STEPS, 1, 0):
        raise AssertionError(f"15a {arch} loop: ended at {res.final_step} with {res.restarts} "
                             f"restarts, {res.rollbacks} rollbacks")
    if not np.all(np.isfinite(plain.losses)) or len(res.losses) != TRAIN_LOOP_STEPS or \
            not np.allclose(res.losses, plain.losses, rtol=1e-6, atol=0):
        raise AssertionError(f"15a {arch} loop: losses {res.losses} against the uninterrupted "
                             f"run's {plain.losses}")
    return plain, res, launches["plain"]


def lm_master(cfg, seed):
    """The port's seeded init of ``cfg`` on the card, f32 masters."""
    import torch

    from repro_torch.models import transformer

    g = torch.Generator(device="cuda").manual_seed(seed)
    return transformer.init_params(cfg, g, "cuda", master=True)


def dp_exchange_check(dp, states, batches):
    """One ``dp.step`` with its exchange held to what the clusters sent:
    the summed gradient that every cluster applies must be, for every
    parameter, the mean over clusters of the gradient plus the residual
    before minus the residual after (the (values, indices) a compressed
    leaf sent, all of a dense one), bit for bit (each sent entry is the
    same f32 sum as in ``compress_grad``, the others cancel exactly). And
    ``wire_bytes`` must be the reference's formula over the stacked leaves:
    8 B a kept entry of a leaf of at least ``min_size``, 4 B an entry of a
    smaller one, to each of the other clusters. Returns (states, metrics,
    the number of parameters held)."""
    import torch

    from repro_torch.optim import compress
    from repro_torch.runtime import hierarchical

    grads, g_sums = [], []
    vg, apply = hierarchical.value_and_grad, hierarchical.adamw.apply_updates

    def spy_vg(*args):
        loss, g = vg(*args)
        grads.append(g)
        return loss, g

    def spy_apply(params, g, *args):
        g_sums.append(g)
        return apply(params, g, *args)

    old = [st.err for st in states]
    hierarchical.value_and_grad, hierarchical.adamw.apply_updates = spy_vg, spy_apply
    try:
        states, m = dp.step(states, batches)
    finally:
        hierarchical.value_and_grad, hierarchical.adamw.apply_updates = vg, apply
    n = dp.num_clusters
    if len(grads) != n or len(g_sums) != n or any(g is not g_sums[0] for g in g_sums):
        raise AssertionError(f"DP: {len(grads)} gradients, {len(g_sums)} updates, not one "
                             f"summed gradient for {n} clusters")
    g_sum = g_sums[0]
    if sorted(g_sum) != sorted(grads[0]):
        raise AssertionError("DP: the summed gradient lacks parameters")
    for name, got in g_sum.items():
        sent = [grads[c][name].float() + old[c][name] - states[c].err[name] for c in range(n)]
        want = sum(sent) / n
        if not torch.equal(got, want):
            raise AssertionError(f"DP: the exchange of {name} is not the mean of what the "
                                 f"clusters sent: max abs err {float((got - want).abs().max())}")
    cfg = dp.comp_cfg
    sizes = [sum(grads[0][k].numel() for k in members)
             for _, members in compress.reference_leaves(grads[0])]
    wire = (n - 1) * sum(4 * s if s < cfg.min_size else 8 * max(int(s * cfg.density), 1)
                         for s in sizes)
    if m["wire_bytes"] != wire:
        raise AssertionError(f"DP: wire_bytes {m['wire_bytes']}, the formula gives {wire}")
    return states, m, len(g_sum)


def train_dp_phase(arch, cfg):
    """15a: CrossClusterDP, 2 clusters, TRAIN_DP_STEPS steps: every step's
    exchange held to what the clusters sent (``dp_exchange_check``), and
    the replicas bit-identical after every step."""
    import torch

    from repro_torch.kernels.spmm_kernel import spmm_cuda
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw, compress
    from repro_torch.runtime import CrossClusterDP

    dp = CrossClusterDP(
        lambda p, b: tfm.lm_loss(cfg, p, b["inputs"], b["targets"]),
        adamw.AdamWConfig(lr=2e-3, warmup_steps=5),
        compress.CompressConfig(density=0.05, min_size=256), num_clusters=2)
    states = dp.init(lm_master(cfg, TRAIN_SEED + 1))
    torch.cuda.synchronize()
    spmm_cuda.launches = 0
    metrics = []
    for s in range(TRAIN_DP_STEPS):
        states, m, held = dp_exchange_check(
            dp, states, [train_batch(cfg, 100 + 2 * s + c) for c in range(2)])
        metrics.append(m)
        for a, b in zip(states[0].params.parameters(), states[1].params.parameters()):
            if not torch.equal(a, b):
                raise AssertionError(f"15a {arch} DP: replicas differ after step {s}")
    torch.cuda.synchronize()
    return {"launches": spmm_cuda.launches, "losses": [m["loss"] for m in metrics],
            "wire_bytes": metrics[-1]["wire_bytes"], "params_held": held}


def train_smoke_phase(root):
    """15a for every MoE SMOKE arch, then the launcher's --smoke run."""
    import contextlib
    import io

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.spmm_kernel import spmm_cuda
    from repro_torch.launch import train as launch_train

    out = {}
    for arch in moe_archs():
        cfg = get_config(arch, smoke=True)
        g = train_grads_phase(arch, cfg, lm_master(cfg, TRAIN_SEED))
        plain, res, loop_launches = train_loop_phase(arch, cfg, root)
        dp = train_dp_phase(arch, cfg)
        same = res.losses == plain.losses
        log(f"15a {arch}: grads through the kernel vs the plain SpMM, max abs err "
            + ", ".join(f"{k} {v:.3g}" for k, v in g["max_abs_err"].items())
            + f" ({g['launches']} launches, remat off); loop of {TRAIN_LOOP_STEPS} steps "
            f"{loop_launches} launches, losses {plain.losses[0]:.4f} -> {plain.losses[-1]:.4f}; "
            f"failure at step {TRAIN_FAIL_STEP}: {res.restarts} restart, the uninterrupted "
            f"losses {'bit for bit' if same else 'within rtol 1e-6'}; DP 2 clusters "
            f"{TRAIN_DP_STEPS} steps: the exchange the mean of what was sent on all "
            f"{dp['params_held']} parameters, bit for bit, replicas bit-identical, "
            f"{dp['launches']} launches, {dp['wire_bytes']:.0f} wire bytes a step (the formula's)")
        out[arch] = {"grads": g, "loop_launches": loop_launches, "loop_losses": plain.losses,
                     "restart_bit_identical": same, "dp": dp}
    argv = ["--arch", OLMOE, "--smoke", "--steps", "3", "--ckpt", os.path.join(root, "launch")]
    torch.cuda.synchronize()
    spmm_cuda.launches = 0
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = launch_train.main(argv)
    torch.cuda.synchronize()
    last = printed.getvalue().strip().splitlines()[-1]
    cfg = get_config(OLMOE, smoke=True)
    want = 6 * cfg.n_layers * 3
    if rc != 0 or not last.startswith("done: step=3 ") or spmm_cuda.launches != want:
        raise AssertionError(f"15a launcher: rc {rc}, {last!r}, {spmm_cuda.launches} SpMM "
                             f"launches, want {want}")
    log(f"15a python -m repro_torch.launch.train {' '.join(argv[:4])}: {last}; "
        f"{spmm_cuda.launches} SpMM launches")
    out["launcher"] = {"launches": spmm_cuda.launches, "line": last}
    return out


def olmoe_train_step_ops(cfg, model, batch):
    """Layer 0's dispatch and combine operands of a forward over ``batch``
    (no grad: the operands alone)."""
    import torch

    from repro_torch.core import local_spgemm
    from repro_torch.core.sparse import SparseCOO
    from repro_torch.models import transformer as tfm

    seen, inner = [], local_spgemm.spmm

    def spy(a, b, *args, **kw):
        if len(seen) < 2:
            seen.append((SparseCOO(rows=a.rows, cols=a.cols, vals=a.vals.detach(), nnz=a.nnz,
                                   shape=a.shape), b.detach().clone()))
        return inner(a, b, *args, **kw)

    local_spgemm.spmm = spy
    try:
        with torch.no_grad():
            tfm.forward(cfg, model, batch["inputs"])
    finally:
        local_spgemm.spmm = inner
    return seen


def swapped(a):
    """Aᵀ's padded COO: the operand of the dB launch."""
    from repro_torch.core.sparse import SparseCOO

    return SparseCOO(rows=a.cols, cols=a.rows, vals=a.vals, nnz=a.nnz,
                     shape=(a.shape[1], a.shape[0]))


def dvals_timing(a, g, b):
    """dvals' plain time for the combine (G (T, D) f32, B = Y) and its
    bound: the live entries' indices read and values written, the rows of
    G and of B they name read once, 2 operations an entry a column."""
    import torch

    from repro_torch.kernels.spmm_kernel import spmm_dvals

    m, k = a.shape
    rows = torch.where(a.valid_mask(), a.rows, torch.full_like(a.rows, m))
    live = (rows < m) & (a.cols < k)
    nnz = int(live.sum())
    g_rows = int(torch.unique(rows[live]).numel())
    b_rows = int(torch.unique(a.cols[live]).numel())
    n = b.shape[1]
    ms = cuda_ms(lambda: spmm_dvals(rows, a.cols, g, b, m), 5)
    bound, by = bound_ms(nnz * 12 + g_rows * n * g.element_size() + b_rows * n * b.element_size(),
                         2 * nnz * n)
    return {"plain_ms": ms, "bound_ms": bound, "bound_by": by, "live": nnz}


def olmoe_train_phase():
    """15b: OLMoE-1B-7B at full width, 4 layers, bf16 compute, f32
    masters, remat, batch 8 x 2048; then 15b's SpMM timings at T = 16384."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, Prefetcher
    from repro_torch.kernels.spmm_kernel import spmm_cuda
    from repro_torch.models.common import param_count
    from repro_torch.optim import adamw
    from repro_torch.train import TrainConfig, build_train_step

    cfg = dataclasses.replace(get_config(OLMOE), n_layers=OLMOE_TRAIN_LAYERS)
    assert cfg.remat and cfg.dtype == "bfloat16"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = lm_master(cfg, TRAIN_SEED)
    opt = adamw.init_opt_state(model)
    torch.cuda.synchronize()
    n_params = param_count(model)
    state = torch.cuda.memory_allocated() - base
    log(f"15b {OLMOE}: {cfg.n_layers} of 16 layers at full width, {n_params} parameters, "
        f"f32 masters + AdamW moments {state / 2**30:.3f} GiB on the card (+ f32 grads "
        f"{4 * n_params / 2**30:.3f} GiB a step), made in {time.perf_counter() - t0:.2f} s")
    step = build_train_step(cfg, TrainConfig(optimizer=adamw.AdamWConfig(**OLMOE_TRAIN_OPT)),
                            "cuda")
    data = Prefetcher(DataConfig(seq_len=OLMOE_TRAIN_SEQ, global_batch=OLMOE_TRAIN_BATCH,
                                 vocab=cfg.vocab, seed=TRAIN_SEED), 0, "cuda")
    tokens = OLMOE_TRAIN_BATCH * OLMOE_TRAIN_SEQ
    want = 6 * cfg.n_layers
    losses, step_ms, launches = [], [], []
    for i in range(OLMOE_TRAIN_WARMUP + OLMOE_TRAIN_TIMED):
        batch = next(data)
        torch.cuda.synchronize()
        spmm_cuda.launches = 0
        t0 = time.perf_counter()
        model, opt, m = step(model, opt, batch)
        loss = float(m["loss"])  # waits for the step
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        launches.append(spmm_cuda.launches)
        log(f"15b step {i}: loss {loss:.6f}, grad norm {float(m['grad_norm']):.4f}, lr "
            f"{float(m['lr']):.2e}, {step_ms[-1]:.1f} ms, {spmm_cuda.launches} SpMM launches")
        if not np.isfinite(loss) or spmm_cuda.launches != want:
            raise AssertionError(f"15b step {i}: loss {loss}, {spmm_cuda.launches} SpMM "
                                 f"launches, want {want} = {cfg.n_layers} layers x (2 forward "
                                 f"+ 2 recompute + 2 dB)")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        raise AssertionError(f"15b: the loss does not fall: {losses}")
    timed = step_ms[OLMOE_TRAIN_WARMUP:]
    peak = torch.cuda.max_memory_allocated() - base
    log(f"15b: {OLMOE_TRAIN_TIMED} timed steps {np.mean(timed):.1f} ms mean, "
        f"{np.median(timed):.1f} ms median ({tokens / np.mean(timed) * 1e3:.1f} tokens/s, "
        f"T = {tokens}); warm-up steps {step_ms[0]:.1f}, {step_ms[1]:.1f} ms; loss "
        f"{np.mean(losses[:3]):.4f} (first 3) -> {np.mean(losses[-3:]):.4f} (last 3); peak "
        f"{peak / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held before")
    batch = next(data)
    spmm_cuda.launches = 0
    total, times = profile_top("15b one train step", lambda: step(model, opt, batch), rows=12,
                               kernel="spmm_tile_kernel")
    if not times or len(times) != want:
        raise AssertionError(f"15b: the profiler recorded {len(times or ())} SpMM launches of "
                             f"{want}")
    spmm_ms = sum(times) / 1e3
    log(f"15b profiled step: {total:.1f} ms device time, SpMM {spmm_ms:.3f} ms in "
        f"{len(times)} launches ({100 * spmm_ms / total:.2f} %)")
    ops = olmoe_train_step_ops(cfg, model, next(data))
    del model, opt, step, data
    torch.cuda.empty_cache()
    (dispatch, x), (combine, y) = ops
    at = f"T={tokens}"
    g = torch.Generator(device="cuda").manual_seed(TRAIN_SEED)
    g_disp = torch.randn((dispatch.shape[0], x.shape[1]), generator=g, device="cuda")
    g_comb = torch.randn((combine.shape[0], y.shape[1]), generator=g, device="cuda")
    spmm = {
        "dispatch_fwd": check_moe_spmm(f"dispatch forward {at}", dispatch, x, "15b"),
        "combine_fwd": check_moe_spmm(f"combine forward {at}", combine, y, "15b"),
        "dispatch_dB": check_moe_spmm(f"dispatch dB {at}", swapped(dispatch), g_disp, "15b"),
        "combine_dB": check_moe_spmm(f"combine dB {at}", swapped(combine), g_comb, "15b"),
    }
    dv = dvals_timing(combine, g_comb, y)
    log(f"15b combine dvals (plain PyTorch) {at}: {dv['plain_ms']:.4f} ms (CUDA events), "
        f"{dv['live']} live entries, bound {dv['bound_ms']:.6f} ms ({dv['bound_by']})")
    return {"params": n_params, "losses": losses, "step_ms": step_ms, "launches": launches,
            "tokens_per_s": tokens / np.mean(timed) * 1e3, "mean_step_ms": float(np.mean(timed)),
            "peak_gib": peak / 2**30,
            "profile": {"device_ms": total, "spmm_ms": spmm_ms, "spmm_launches": len(times),
                        "spmm_share": spmm_ms / total}, "spmm": spmm, "dvals": dv}


def train_phase():
    """Phase 15: training (15a, 15b). Returns its records."""
    import torch

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as root:
        smoke = train_smoke_phase(root)
    log(f"15a: {time.perf_counter() - t_phase:.1f} s")
    olmoe = olmoe_train_phase()
    torch.cuda.empty_cache()
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    return {"smoke": smoke, "olmoe": olmoe}


# ---------------------------------------------------------------------------
# phase 16: LM serving on a ("data", "model") process mesh
# ---------------------------------------------------------------------------
MESH_SHAPE = (2, 2)  # (data, model): 4 ranks
# OLMoE-1B-7B's depth on the mesh: 8 of its 16 layers over gloo (the four
# ranks share one card; 16 took 31-38 s of the script's time on an H100),
# all 16 over NCCL with a card a rank
MESH_LAYERS = {"gloo": 8, "nccl": 16}
MESH_REQUESTS = 8
MESH_PROMPT = (64, 256)  # prompt lengths drawn from this range, both ends included
MESH_NEW = 16
MESH_BATCH, MESH_S_MAX = 8, 512
MESH_CHECK = (4, 64, 128)  # the one-card check: batch, prompt length, s_max
# the mesh against one card in bf16 (see mesh_one_card_check): the same
# arithmetic apart from the order of f32 sums inside cuBLAS calls of other
# shapes (vocab-split logits, experts on tp·cap rows), each result rounded
# to bf16, over 16 layers. Logits have a std of ~0.88; the largest
# differences seen (H100, PR 28) were 0.03125 (prefill) and 0.02344
# (decode): 4x the larger
MESH_BF16_TOL = dict(rtol=0.0, atol=0.125)
MESH_TIMEOUT_S = 600  # one spawn of the mesh phase, every collective included
# the serving phase's settings (phase 18 serves another arch with its own)
P16 = {backend: dict(tag="16", arch=OLMOE, layers=layers, requests=MESH_REQUESTS,
                     prompt=MESH_PROMPT, new=MESH_NEW, batch=MESH_BATCH, s_max=MESH_S_MAX,
                     check=MESH_CHECK, seed=LM_SEED + 16, tol=MESH_BF16_TOL)
       for backend, layers in MESH_LAYERS.items()}


def mesh_prompts(cfg, p):
    rng = np.random.default_rng(p["seed"])
    lengths = rng.integers(p["prompt"][0], p["prompt"][1] + 1, p["requests"])
    return [rng.integers(0, cfg.vocab, int(s)).astype(np.int32) for s in lengths]


def mesh_check_inputs(cfg, device, p):
    import torch

    b, s, _ = p["check"]
    g = torch.Generator(device=device).manual_seed(p["seed"] + 1)
    return (torch.randint(0, cfg.vocab, (b, s), generator=g, device=device),
            torch.randint(0, cfg.vocab, (b, 1), generator=g, device=device))


class CollectiveClock:
    """Host time inside the mesh's collectives while installed: each call
    synchronises the card before and after it, so a call's time is the
    transfer plus the wait for the slowest peer, not this rank's own
    kernels queued ahead of it."""

    def __init__(self):
        from repro_torch.core.grid import AxisCollectives

        self.cls, self.seconds, self.calls, self.saved = AxisCollectives, 0.0, 0, {}

    def __enter__(self):
        import torch

        for name in ("_gather", "_reduce", "all_to_all"):
            inner = self.saved[name] = getattr(self.cls, name)

            def timed(obj, *a, _inner=inner, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = _inner(obj, *a, **k)
                torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t
                self.calls += 1
                return out

            setattr(self.cls, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.cls, name, fn)


def mesh_serve_rank(mesh, p16):
    """Phase 16 (and 18's serving) on one rank: ``p16["arch"]`` at
    ``p16["layers"]`` layers cut to this rank's slices at init, the stream
    served twice through the engine on the mesh (run 2 under
    ``CollectiveClock``), each run's SpMM count set to 0 just before and
    read just after; then the one-card check's prefill and one decode
    through the step builders, each call's collectives counted. Returns
    the tokens, counts, times and the check's logits and cache slices."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.spmm_kernel import spmm_cuda
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import EngineConfig, Request, ServeEngine
    from repro_torch.train import build_decode_step, build_prefill_step

    cfg = dataclasses.replace(get_config(p16["arch"]), n_layers=p16["layers"])
    dev = mesh.device
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(LM_SEED), dev,
                            mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    torch.cuda.reset_peak_memory_stats()
    prompts = mesh_prompts(cfg, p16)
    runs = []
    for run in range(2):
        eng = ServeEngine(cfg, model, EngineConfig(max_batch=p16["batch"], s_max=p16["s_max"]),
                          device=dev, mesh=mesh)
        for rid, prompt in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=p16["new"]))
        clock = CollectiveClock()
        torch.cuda.synchronize()
        spmm_cuda.launches = 0
        ticks, tick_ms, prefills = 0, [], 0
        t0 = time.perf_counter()
        with clock if run == 1 else contextlib.nullcontext():
            while eng.queue or eng.active:
                admits = min(len(eng.queue), len(eng._free_slots()))
                t = time.perf_counter()
                eng.step()
                if not admits:
                    tick_ms.append((time.perf_counter() - t) * 1e3)
                prefills += admits
                ticks += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append({"tokens": {r.rid: [int(x) for x in r.out_tokens] for r in eng.done},
                     "launches": spmm_cuda.launches, "ticks": ticks, "prefills": prefills,
                     "wall": wall, "tick_ms": tick_ms,
                     "collective_s": clock.seconds, "collectives": clock.calls})
        del eng
    peak = torch.cuda.max_memory_allocated()
    # the one-card check's mesh side
    b, s, s_max = p16["check"]
    prompt, nxt = mesh_check_inputs(cfg, dev, p16)
    pstep, info = build_prefill_step(cfg, mesh, s_max, b)
    dstep, _ = build_decode_step(cfg, mesh, b, s_max)
    spmm_cuda.launches = 0
    with CollectiveClock() as prefill_clock:
        logits, cache = pstep(model, prompt)
    torch.cuda.synchronize()
    check_launches = [spmm_cuda.launches]
    # numpy crosses the result queue by value (a CPU tensor would be shared by
    # a handle the exiting rank takes with it); bf16 values are exact in f32
    cache_host = {k: v.float().cpu().numpy().copy() for k, v in cache.items()}
    spmm_cuda.launches = 0
    with CollectiveClock() as decode_clock:
        dlogits, _ = dstep(model, cache, nxt, s)
    torch.cuda.synchronize()
    check_launches.append(spmm_cuda.launches)
    return {"coords": mesh.coords, "init_s": init_s, "weights": weights, "peak": peak,
            "runs": runs, "check": {"prefill": logits.float().cpu().numpy(),
                                    "decode": dlogits.float().cpu().numpy(),
                                    "cache": cache_host, "launches": check_launches,
                                    "collectives": [prefill_clock.calls, decode_clock.calls],
                                    "cache_specs": {k: tuple(v) for k, v in
                                                    info["specs"]["cache"].items()}}}


def sharded_moe(dp, tp):
    """A one-card ``moe_layer`` that routes as a (dp, tp) mesh does: each of
    the dp batch shards alone, and in "a2a" (S divisible by tp) each of its
    tp sequence shards alone, every shard with the capacity of its own
    tokens; the aux loss is the shards' mean, as the mesh averages it."""
    import torch

    from repro_torch.models import moe

    inner = moe.moe_layer

    def layer(params, x, cfg, mode="a2a", mesh=None):
        B, S, _ = x.shape
        rows, auxes = [], []
        for xb in x.split(B // dp):
            parts = xb.split(S // tp, dim=1) if mode == "a2a" and S % tp == 0 else (xb,)
            outs = [inner(params, xs, cfg, mode=mode) for xs in parts]
            rows.append(torch.cat([out for out, _ in outs], 1))
            auxes += [aux for _, aux in outs]
        return torch.cat(rows), torch.stack(auxes).mean()  # the mesh's aux: the shards' mean

    return layer


def mesh_one_card_check(cfg, ranks, p):
    """The mesh's check prefill and decode against one card, in bf16 within
    ``p["tol"]``: the prefill's logits against the one-card model run with
    ``sharded_moe`` (what "a2a" computes; a model without MoE runs as it
    is), and the decode's logits against a one-card decode ("dense_ep",
    each data shard's slots routed alone) from the same cache, assembled
    from the ranks' slices. Returns the errors."""
    import torch

    from repro_torch.models import moe, transformer as tfm

    dp, tp = MESH_SHAPE
    b, s, s_max = p["check"]
    model = lm_model(cfg, LM_SEED)
    prompt, nxt = mesh_check_inputs(cfg, "cuda", p)
    specs = ranks[0]["check"]["cache_specs"]
    whole = {}
    for name, spec in specs.items():  # the ranks' slices put back together
        blocks = {tuple(r["coords"].values()): torch.as_tensor(r["check"]["cache"][name])
                  for r in ranks}
        rows = []
        for d in range(dp):
            parts = [blocks[(d, m)] for m in range(tp)]
            rows.append(torch.cat(parts, spec.index("model")) if "model" in spec else parts[0])
        whole[name] = (torch.cat(rows, spec.index("data")) if "data" in spec else rows[0]).to(
            "cuda")
    # what the mesh does not compute: the prefill routing each data shard's
    # tokens together (logged, to show what the tolerance can see)
    inner = moe.moe_layer
    if cfg.moe:
        moe.moe_layer = sharded_moe(dp, 1)
        try:
            routed_together, _ = tfm.prefill(cfg, model, prompt, s_max)
        finally:
            moe.moe_layer = inner
    moe.moe_layer = sharded_moe(dp, tp)
    try:
        want_p, own = tfm.prefill(cfg, model, prompt, s_max)
        errs = {"cache": max(float((whole[k].float() - own[k].float()).abs().max())
                             for k in own)}
        whole = {k: v.to(own[k].dtype) for k, v in whole.items()}  # the SSM state stays f32
        want_d, _ = tfm.decode_step(cfg, model, whole, nxt, s)  # writes position s of whole
    finally:
        moe.moe_layer = inner
    if cfg.moe:
        got0 = torch.as_tensor(ranks[0]["check"]["prefill"]).cuda()
        errs["prefill_routed_together"] = float((got0 - routed_together.float()).abs().max())
    errs["logit_std"] = float(want_p.float().std())
    for key, want in (("prefill", want_p), ("decode", want_d)):
        diff = (torch.as_tensor(ranks[0]["check"][key]).cuda() - want.float()).abs()
        errs[f"{key}_p99.9"] = float(torch.quantile(diff.flatten()[:1 << 24], 0.999))
        for r in ranks:
            got = torch.as_tensor(r["check"][key]).cuda()
            err = float((got - want.float()).abs().max())
            errs[key] = max(errs.get(key, 0.0), err)
            if not torch.allclose(got, want.float(), **p["tol"]):
                raise AssertionError(f"{p['tag']} {key}: rank {r['coords']} differs from one "
                                     f"card, max abs err {err} (tolerance {p['tol']})")
    del model, own, whole
    torch.cuda.empty_cache()
    return errs


def mesh_phase(backend, p=None):
    """Phase 16 (``p`` P16[backend]; phase 18's serving with its own settings):
    ``mesh_serve_rank`` on a 2 x 2 mesh over ``backend`` (gloo: the four
    ranks share this card; nccl: one rank per card). Checks that both runs
    and all ranks give the same tokens (``p["new"]`` in-range tokens a
    request), that every rank counted 2 SpMM launches a MoE layer a model
    call in each run (prefills + ticks) and in the check (none without
    MoE), then the one-card check. Logs each rank's init, peak memory,
    decode-only tick times, the share of run 2 spent inside collectives
    and the collectives of one prefill and one decode call. Returns the
    phase's record."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import spawn

    t_phase = time.perf_counter()
    p = p or P16[backend]
    tag = p["tag"]
    cfg = dataclasses.replace(get_config(p["arch"]), n_layers=p["layers"])
    per_call = 2 * cfg.n_layers if cfg.moe else 0  # SpMM launches a model call
    workdir = Path(__file__).resolve().parent / "build"
    workdir.mkdir(exist_ok=True)
    ranks = spawn.run_mesh(mesh_serve_rank, MESH_SHAPE, backend=backend, device="cuda",
                           args=(p,), timeout_s=MESH_TIMEOUT_S, workdir=workdir)
    spawn_s = time.perf_counter() - t_phase
    tokens = ranks[0]["runs"][0]["tokens"]
    if sorted(tokens) != list(range(p["requests"])) or any(
            len(v) != p["new"] or not all(0 <= x < cfg.vocab for x in v) for v in tokens.values()):
        raise AssertionError(f"{tag}: every request must get {p['new']} in-range tokens: {tokens}")
    launches = {}
    for r in ranks:
        for i, run in enumerate(r["runs"]):
            if run["tokens"] != tokens:
                raise AssertionError(f"{tag}: rank {r['coords']} run {i + 1} gave other tokens")
            want = per_call * (run["prefills"] + run["ticks"])
            if run["launches"] != want:
                raise AssertionError(f"{tag}: rank {r['coords']} run {i + 1}: {run['launches']} "
                                     f"SpMM launches, want {per_call} a model call x "
                                     f"({run['prefills']} prefills + {run['ticks']} ticks) = "
                                     f"{want}")
        if r["check"]["launches"] != [per_call] * 2:
            raise AssertionError(f"{tag}: rank {r['coords']} check launches "
                                 f"{r['check']['launches']}, want {per_call} a call")
        launches[str(tuple(r["coords"].values()))] = [run["launches"] for run in r["runs"]] + \
            r["check"]["launches"]
    for r in ranks:
        run1, run2 = r["runs"]
        log(f"{tag} rank {r['coords']} ({backend}): init {r['init_s']:.2f} s, weights "
            f"{r['weights'] / 2**30:.3f} GiB, peak {r['peak'] / 2**30:.3f} GiB; run 1 "
            f"{run1['wall']:.3f} s, {run1['ticks']} ticks, decode-only tick median "
            f"{np.median(run1['tick_ms']):.3f} ms (mean {np.mean(run1['tick_ms']):.3f}); run 2 "
            f"{run2['wall']:.3f} s, tick median {np.median(run2['tick_ms']):.3f} ms, "
            f"{run2['collectives']} collectives {run2['collective_s']:.3f} s = "
            f"{100 * run2['collective_s'] / run2['wall']:.2f} % of the run; collectives in one "
            f"prefill call {r['check']['collectives'][0]}, in one decode call "
            f"{r['check']['collectives'][1]}; SpMM launches "
            f"{launches[str(tuple(r['coords'].values()))]}")
    t0 = time.perf_counter()
    errs = mesh_one_card_check(cfg, ranks, p)
    log(f"{tag} one-card check: prefill max abs err {errs['prefill']:.4g} (99.9th percentile "
        f"{errs['prefill_p99.9']:.4g}), decode from the same cache {errs['decode']:.4g} "
        f"({errs['decode_p99.9']:.4g}), the one-card prefill's cache against the mesh's "
        f"{errs['cache']:.4g}, logits' std {errs['logit_std']:.4g}; tolerance {p['tol']}"
        + (f"; against a one-card prefill routing each data shard's tokens together (not what "
           f"the mesh computes) {errs['prefill_routed_together']:.4g}" if cfg.moe else "")
        + f"; {time.perf_counter() - t0:.1f} s")
    log(f"{tag} {p['arch']} ({cfg.n_layers} layers, bf16) on a {MESH_SHAPE[0]}x{MESH_SHAPE[1]} "
        f"(data x model) mesh over {backend}: {p['requests']} requests x {p['new']} tokens, "
        f"both runs and all ranks the same tokens; spawn {spawn_s:.1f} s; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"backend": backend, "launches_per_rank": launches, "errs": errs,
            "peak_gib": {str(tuple(r["coords"].values())): r["peak"] / 2**30 for r in ranks},
            "tick_ms_median": {str(tuple(r["coords"].values())):
                               float(np.median(r["runs"][0]["tick_ms"])) for r in ranks},
            "seconds": time.perf_counter() - t_phase}


# ---------------------------------------------------------------------------
# phase 17: training on a ("data", "model") process mesh
# ---------------------------------------------------------------------------
TRAIN_MESH_SHAPE = (2, 2)  # (data, model): 4 ranks
# OLMoE-1B-7B at its published width: layers of 16, global batch x sequence
TRAIN_MESH = {"gloo": dict(tag="17", arch=OLMOE, layers=2, batch=4, seq=512),
              "nccl": dict(tag="17", arch=OLMOE, layers=4, batch=8, seq=2048)}
TRAIN_MESH_STEPS = 3
TRAIN_MESH_OPT = OLMOE_TRAIN_OPT
# The checked step against one card (PERF.md §6, stated before the run
# that tests it): one step from the seeded init on the first batch, in f32
# compute on both sides (f32 masters), the one card applying each MoE
# layer to the mesh's shards (``sharded_moe``). In bf16 (on an H100 80GB
# HBM3 at 700 W) routing near-ties flip between the two, and 18 % of an
# expert tensor's entries took another AdamW sign. Loss, the global
# gradient norm and every parameter's gradient norm (the data-reduced
# gradient, whose scale AdamW's first step does not show) within these
# rtols. AdamW's first step moves an entry by lr_1·g/(|g| + eps), the sign
# of g: at most TRAIN_MESH_FLIP_SHARE of a tensor's entries, or one entry,
# may differ by more than TRAIN_MESH_FLIP_ATOL (a gradient entry near 0
# whose sign the sums' order flips; one entry is 6.25 % of a Mamba2 rank's
# 16 dt_bias entries, where Mamba2-370M at 48 layers moved one by
# 2.195e-05, PERF.md §6).
TRAIN_MESH_LOSS_RTOL = 1e-4
TRAIN_MESH_NORM_RTOL = 1e-3
TRAIN_MESH_LEAF_RTOL = 1e-3
TRAIN_MESH_FLIP_ATOL = 1e-5
TRAIN_MESH_FLIP_SHARE = 0.01
TRAIN_MESH_TIMEOUT_S = 600  # one spawn of the phase, every collective included


def train_mesh_batch(cfg, p17, step, device):
    from repro_torch.data import DataConfig, synthetic_batch

    return synthetic_batch(DataConfig(seq_len=p17["seq"], global_batch=p17["batch"],
                                      vocab=cfg.vocab, seed=TRAIN_SEED), step, device)


def stacked_shapes(tree):
    """{name: shape} of a rank's ZeRO state in the reference's stacked
    layout: ``layers.<i>.<rest>`` stacked over the layers the rank holds."""
    layers, out = {}, {}
    for name, t in tree.items():
        parts = name.split(".")
        if parts[0] == "layers":
            layers.setdefault(".".join(["layers"] + parts[2:]), []).append(tuple(t.shape))
        else:
            out[name] = tuple(t.shape)
    for kind, shapes in layers.items():
        if len(set(shapes)) != 1:
            raise AssertionError(f"ZeRO state: {kind} holds layers of shapes {shapes}")
        out[kind] = (len(shapes),) + shapes[0]
    return out


def spec_slice_shapes(specs, shapes, mesh):
    """{name: shape} of this rank's slice of every leaf of a stacked spec
    tree ``specs`` over the stacked shape tree ``shapes``."""
    from repro_torch.models.common import Spec, shard_index

    out = {}

    def walk(spec, shape, path):
        if isinstance(spec, Spec):
            ent = tuple(spec) + (None,) * (len(shape) - len(spec))
            out[path] = tuple(n // shard_index(mesh, e)[1] for n, e in zip(shape, ent))
            return
        for k, v in spec.items():
            walk(v, shape[k], f"{path}.{k}" if path else k)

    walk(specs, shapes, "")
    return out


def mesh_train_setup(cfg, mesh, p17):
    """(model, AdamW state, train step) of ``cfg`` on ``mesh``: the seeded
    init cut to this rank's slices, its ZeRO-1 state."""
    import torch

    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.train import TrainConfig, build_train_step

    dev = mesh.device
    model = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(TRAIN_SEED), dev,
                            master=True, mesh=mesh)
    step = build_train_step(cfg, TrainConfig(optimizer=adamw.AdamWConfig(**TRAIN_MESH_OPT)),
                            dev, mesh=mesh, global_batch=p17["batch"])
    return model, adamw.init_opt_state(model, mesh=mesh, specs=step.specs), step


def mesh_train_rank(mesh, p17):
    """Phase 17 on one rank. First the checked step: the seeded init in f32
    compute, one step on the first batch, this rank's updated slices held
    against the one card's (``p17["ref"]``, shared by the parent). Then
    the run: the init in bf16 compute (f32 masters), TRAIN_MESH_STEPS
    steps on the port's data stream, each step's SpMM count set to 0 just
    before and read just after, the last under ``CollectiveClock``.
    Returns losses, counts, times, ZeRO shapes and the check's values."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.spmm_kernel import spmm_cuda
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import leaf_spec, shard_tensor

    entered = time.time()
    cfg = dataclasses.replace(get_config(p17["arch"]), n_layers=p17["layers"])
    dev = mesh.device
    # the checked step, f32
    t0 = time.perf_counter()
    model, opt, step = mesh_train_setup(dataclasses.replace(cfg, dtype="float32"), mesh, p17)
    spmm_cuda.launches = 0
    loss, grads = step.grads(model, train_mesh_batch(cfg, p17, 0, dev))
    leaf = dict(zip(step.layout.names, step.layout.norms_sq(grads).sqrt().tolist()))
    model, opt, m = step.update(model, opt, grads)
    del grads
    check = {"loss": float(loss), "grad_norm": float(m["grad_norm"]), "leaf_norms": leaf,
             "launches": spmm_cuda.launches, "params": {}, "s": time.perf_counter() - t0}
    for name, p in model.named_parameters():
        want = shard_tensor(p17["ref"][name], leaf_spec(step.specs["params"], name), mesh).to(dev)
        diff = (p.detach() - want).abs()
        over = diff > TRAIN_MESH_FLIP_ATOL
        check["params"][name] = (float(diff.max()), float(over.float().mean()), int(over.sum()))
        del want, diff
    check["s"] = time.perf_counter() - t0
    del model, opt, step, m
    torch.cuda.empty_cache()
    # the run, bf16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, opt, step = mesh_train_setup(cfg, mesh, p17)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nbytes = lambda tree: sum(t.numel() * t.element_size() for t in tree.values())  # noqa: E731
    held = {"params": nbytes(dict(model.named_parameters())),
            "opt": nbytes(opt["mu"]) + nbytes(opt["nu"])}
    zero = {"held": stacked_shapes(opt["mu"]),
            "want": spec_slice_shapes(step.specs["opt"]["mu"], tfm.param_shapes(cfg), mesh)}
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(TRAIN_MESH_STEPS):
        batch = train_mesh_batch(cfg, p17, i, dev)
        clock = CollectiveClock()
        torch.cuda.synchronize()
        spmm_cuda.launches = 0
        t = time.perf_counter()
        with clock if i == TRAIN_MESH_STEPS - 1 else contextlib.nullcontext():
            model, opt, m = step(model, opt, batch)
            loss = float(m["loss"])  # waits for the step
        steps.append({"loss": loss, "grad_norm": float(m["grad_norm"]),
                      "s": time.perf_counter() - t, "launches": spmm_cuda.launches,
                      "collective_s": clock.seconds, "collectives": clock.calls})
    return {"coords": mesh.coords, "init_s": init_s, "held": held, "zero": zero,
            "peak": torch.cuda.max_memory_allocated(), "steps": steps, "check": check,
            "entered": entered, "left": time.time()}


def mesh_train_reference(cfg, p17):
    """The checked step on this card, in f32 compute: the seeded init (the
    draws the mesh cuts its slices from), one train step on the mesh's
    first batch with ``sharded_moe`` routing each (data, model) shard
    alone. Returns its loss, gradient norm, every parameter's gradient
    norm, the updated parameters (kept on the card for the ranks) and the
    loss at init routing all tokens together."""
    import dataclasses

    import torch

    from repro_torch.models import moe, transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.train import TrainConfig, build_train_step

    cfg = dataclasses.replace(cfg, dtype="float32")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm_master(cfg, TRAIN_SEED)
    opt = adamw.init_opt_state(model)
    step = build_train_step(cfg, TrainConfig(optimizer=adamw.AdamWConfig(**TRAIN_MESH_OPT)),
                            "cuda")
    batch = train_mesh_batch(cfg, p17, 0, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    with torch.no_grad():  # not what the mesh computes: for the log
        together = float(tfm.lm_loss(cfg, model, batch["inputs"], batch["targets"]))
    inner = moe.moe_layer
    moe.moe_layer = sharded_moe(*TRAIN_MESH_SHAPE)
    try:
        t0 = time.perf_counter()
        loss, grads = step.grads(model, batch)
        leaf = {n: float(g.square().sum().sqrt()) for n, g in grads.items()}
        model, opt, m = step.update(model, opt, grads)
        loss, gnorm = float(loss), float(m["grad_norm"])
        step_s = time.perf_counter() - t0
        del grads
    finally:
        moe.moe_layer = inner
    peak = torch.cuda.max_memory_allocated()
    params = {n: p.detach() for n, p in model.named_parameters()}
    del opt, step, m
    torch.cuda.empty_cache()
    return {"loss": loss, "grad_norm": gnorm, "leaf_norms": leaf, "together": together,
            "params": params, "init_s": init_s, "step_s": step_s, "peak": peak}


def mesh_train_phase(backend, p17=None):
    """Phase 17 (``p17`` TRAIN_MESH[backend]; phase 18's training with its
    own settings): ``mesh_train_rank`` on a 2 x 2 mesh over ``backend``
    (gloo: the four ranks share this card; nccl: one rank per card).
    Checks that every rank got the same finite loss each step, counted 6
    SpMM launches a MoE layer a step (forward, remat recompute, dB: 2
    each; none without MoE), holds ZeRO state of the shapes
    ``shardings_for``'s specs give, and that the checked step agrees with
    one card's (see TRAIN_MESH_*). Logs each rank's init, peak memory,
    step times and the last step's collectives and share inside them.
    Returns the phase's record."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import spawn

    t_phase = time.perf_counter()
    p17 = p17 or TRAIN_MESH[backend]
    tag17 = p17["tag"]
    cfg = dataclasses.replace(get_config(p17["arch"]), n_layers=p17["layers"])
    ref = mesh_train_reference(cfg, p17)
    log(f"{tag17} one card, f32: {cfg.n_layers} layers, batch {p17['batch']} x {p17['seq']}, init "
        f"{ref['init_s']:.2f} s, one step {ref['step_s']:.2f} s, peak "
        f"{ref['peak'] / 2**30:.3f} GiB; loss {ref['loss']:.6f}, grad norm "
        f"{ref['grad_norm']:.6f}"
        + (f"; at init routing all tokens together (not what the mesh computes) "
           f"{ref['together']:.6f}" if cfg.moe else ""))
    workdir = Path(__file__).resolve().parent / "build"
    workdir.mkdir(exist_ok=True)
    t0, spawned = time.perf_counter(), time.time()
    ranks = spawn.run_mesh(mesh_train_rank, TRAIN_MESH_SHAPE, backend=backend, device="cuda",
                           args=({**p17, "ref": ref["params"]},),
                           timeout_s=TRAIN_MESH_TIMEOUT_S, workdir=workdir)
    spawn_s = time.perf_counter() - t0
    del ref["params"]
    torch.cuda.empty_cache()
    want = 6 * cfg.n_layers if cfg.moe else 0
    tag = lambda r: str(tuple(r["coords"].values()))  # noqa: E731
    launches = {tag(r): [s["launches"] for s in r["steps"]] for r in ranks}

    def leaf_rel(r):  # each parameter's gradient norm against the one card's, relative
        return {n: abs(g - ref["leaf_norms"][n]) / max(ref["leaf_norms"][n], 1e-30)
                for n, g in r["check"]["leaf_norms"].items()}

    worst = {"max": max(mx for r in ranks for mx, _, _ in r["check"]["params"].values()),
             "share": max(sh for r in ranks for _, sh, _ in r["check"]["params"].values()),
             "count": max(c for r in ranks for _, _, c in r["check"]["params"].values()),
             "leaf_norm_rel": max(v for r in ranks for v in leaf_rel(r).values())}
    worst_leaf = max(leaf_rel(ranks[0]).items(), key=lambda kv: kv[1])
    for r in ranks:
        s = r["steps"]
        last = s[-1]
        log(f"{tag17} rank {r['coords']} ({backend}): init {r['init_s']:.2f} s, params "
            f"{r['held']['params'] / 2**30:.3f} GiB, ZeRO moments {r['held']['opt'] / 2**30:.3f} "
            f"GiB, peak {r['peak'] / 2**30:.3f} GiB; step s {[round(x['s'], 3) for x in s]} "
            f"(host clock, ending in the loss's read); last step under the collective clock: "
            f"{last['collectives']} collectives {last['collective_s']:.3f} s = "
            f"{100 * last['collective_s'] / last['s']:.2f} % of {last['s']:.3f} s; SpMM "
            f"launches {launches[tag(r)]} (checked step {r['check']['launches']}); checked step "
            f"loss {r['check']['loss']:.6f}, grad norm {r['check']['grad_norm']:.6f}, parameters "
            f"max abs diff {max(mx for mx, _, _ in r['check']['params'].values()):.4g}, share over "
            f"{TRAIN_MESH_FLIP_ATOL} {max(sh for _, sh, _ in r['check']['params'].values()):.4g}; "
            f"entered {r['entered'] - spawned:.1f} s after the spawn, checked step (init, step, "
            f"compare) {r['check']['s']:.1f} s, left {r['left'] - spawned:.1f} s after it")
    check = ranks[0]["check"]
    log(f"{tag17} one-card check of the f32 step: loss {check['loss']:.6f} vs {ref['loss']:.6f} "
        f"(rel {abs(check['loss'] - ref['loss']) / abs(ref['loss']):.3g}, rtol "
        f"{TRAIN_MESH_LOSS_RTOL}), grad norm {check['grad_norm']:.6f} vs {ref['grad_norm']:.6f} "
        f"(rel {abs(check['grad_norm'] - ref['grad_norm']) / ref['grad_norm']:.3g}, rtol "
        f"{TRAIN_MESH_NORM_RTOL}); every parameter's gradient norm within rel "
        f"{worst['leaf_norm_rel']:.3g} (rtol {TRAIN_MESH_LEAF_RTOL}; rank 0's worst "
        f"{worst_leaf[0]}: {check['leaf_norms'][worst_leaf[0]]:.6g} vs "
        f"{ref['leaf_norms'][worst_leaf[0]]:.6g}, of {len(ref['leaf_norms'])} parameters); "
        f"parameters: max abs diff {worst['max']:.4g}, at most {100 * worst['share']:.4f} % of "
        f"a tensor's entries over {TRAIN_MESH_FLIP_ATOL}, at most {worst['count']} in one tensor "
        f"(bound {100 * TRAIN_MESH_FLIP_SHARE} % or one entry)" + (f"; at init the one card routing all tokens together gives loss "
                 f"{ref['together']:.6f}" if cfg.moe else ""))
    losses = [s["loss"] for s in ranks[0]["steps"]]
    for r in ranks:
        at = r["coords"]
        got = [s["loss"] for s in r["steps"]]
        if got != losses or not all(np.isfinite(got)):
            raise AssertionError(f"{tag17}: rank {at} losses {got}, rank 0's {losses}")
        if any(n != want for n in launches[tag(r)] + [r["check"]["launches"]]):
            raise AssertionError(f"{tag17}: rank {at} SpMM launches {launches[tag(r)]}, checked step "
                                 f"{r['check']['launches']}; want {want} a step = "
                                 f"{cfg.n_layers} MoE layers x (2 forward + 2 recompute + 2 "
                                 f"dB)")
        zero = r["zero"]
        if zero["held"] != zero["want"]:
            raise AssertionError(f"{tag17}: rank {at} ZeRO state {zero['held']}, specs give "
                                 f"{zero['want']}")
        if not (np.isclose(r["check"]["loss"], ref["loss"], rtol=TRAIN_MESH_LOSS_RTOL, atol=0)
                and np.isclose(r["check"]["grad_norm"], ref["grad_norm"],
                               rtol=TRAIN_MESH_NORM_RTOL, atol=0)):
            raise AssertionError(f"{tag17}: rank {at} checked step loss {r['check']['loss']}, grad "
                                 f"norm {r['check']['grad_norm']}; one card {ref['loss']}, "
                                 f"{ref['grad_norm']}")
        if sorted(r["check"]["leaf_norms"]) != sorted(ref["leaf_norms"]):
            raise AssertionError(f"{tag17}: rank {at} gradient norms of "
                                 f"{sorted(r['check']['leaf_norms'])}")
        for name, rel in leaf_rel(r).items():
            if not rel <= TRAIN_MESH_LEAF_RTOL:
                raise AssertionError(f"{tag17}: rank {at} {name}'s gradient norm "
                                     f"{r['check']['leaf_norms'][name]}, one card "
                                     f"{ref['leaf_norms'][name]} (rel {rel}, rtol "
                                     f"{TRAIN_MESH_LEAF_RTOL})")
        for name, (mx, share, count) in r["check"]["params"].items():
            if count > 1 and share > TRAIN_MESH_FLIP_SHARE:
                raise AssertionError(f"{tag17}: rank {at} {name} after the checked step: "
                                     f"{count} entries ({100 * share:.3f} %) over "
                                     f"{TRAIN_MESH_FLIP_ATOL} (bound "
                                     f"{100 * TRAIN_MESH_FLIP_SHARE} % or one entry; max abs "
                                     f"diff {mx})")
    log(f"{tag17} {p17['arch']} ({cfg.n_layers} layers, f32 masters, bf16, remat, ZeRO-1 AdamW) "
        f"on a "
        f"{TRAIN_MESH_SHAPE[0]}x{TRAIN_MESH_SHAPE[1]} (data x model) mesh over {backend}: "
        f"{TRAIN_MESH_STEPS} steps, losses {[round(x, 6) for x in losses]} on every rank; "
        f"spawn {spawn_s:.1f} s; phase {time.perf_counter() - t_phase:.1f} s")
    return {"backend": backend, "launches_per_rank": launches, "losses": losses,
            "check": {"loss": [check["loss"], ref["loss"]],
                      "grad_norm": [check["grad_norm"], ref["grad_norm"]], **worst},
            "peak_gib": {tag(r): r["peak"] / 2**30 for r in ranks},
            "step_s": {tag(r): [x["s"] for x in r["steps"]] for r in ranks},
            "seconds": time.perf_counter() - t_phase}

# ---------------------------------------------------------------------------
# phase 18: the Mamba2 and Zamba2 families on a ("data", "model") process mesh
# ---------------------------------------------------------------------------
ZAMBA2, MAMBA2 = "zamba2-2.7b", "mamba2-370m"
# 18a: Zamba2-2.7B at its published width (arXiv:2411.15242; 54 layers, the
# shared block after every 6th), bf16, seeded random weights, served twice
# through the engine on the mesh, then the one-card check: the mesh's
# prefill and decode against one card's from the same cache. In bf16 over
# 54 layers, with logits of std ~0.88, the largest differences seen (H100
# 80GB HBM3, 700 W) were 0.05811 (prefill) and 0.03125 (decode):
# ~4x the larger
SSM_BF16_TOL = dict(rtol=0.0, atol=0.25)
SSM_SERVE = {backend: dict(tag="18a", arch=ZAMBA2, layers=54, requests=4, prompt=(64, 256),
                           new=8, batch=4, s_max=512, check=(4, 64, 128), seed=LM_SEED + 18,
                           tol=SSM_BF16_TOL)
             for backend in ("gloo", "nccl")}
# 18b: Mamba2-370M at its published width (arXiv:2405.21060; 48 layers), f32
# masters, bf16 compute, remat, ZeRO-1 AdamW, global batch 4 x 512 from the
# port's stream, TRAIN_MESH_STEPS steps after the f32 step checked against
# one card (phase 17's checks)
# (over gloo 24 of the 48 layers: at 48 the part took ~60 s on an H100,
# ~0.9 s a layer, and a part is held to 45 s; all 48 over NCCL)
SSM_TRAIN = {"gloo": dict(tag="18b", arch=MAMBA2, layers=24, batch=4, seq=512),
             "nccl": dict(tag="18b", arch=MAMBA2, layers=48, batch=4, seq=512)}


def ssm_mesh_phase(backend):
    """Phase 18: the ssm and hybrid families tensor parallel on a 2 x 2
    mesh over ``backend`` (gloo: the four ranks share this card; nccl: one
    rank per card): 18a serves Zamba2-2.7B (``mesh_phase`` with
    SSM_SERVE's settings), 18b trains Mamba2-370M (``mesh_train_phase``
    with SSM_TRAIN's). No kernel of the port launches on this path: the
    SSD scan is plain PyTorch, as the JAX package's is jnp, and the counts
    of SpMM launches must stay 0. Returns both records."""
    import torch

    t0 = time.perf_counter()
    card = card_lines(1)[0]
    serve = mesh_phase(backend, SSM_SERVE[backend])
    torch.cuda.empty_cache()
    train = mesh_train_phase(backend, SSM_TRAIN[backend])
    torch.cuda.empty_cache()
    log(f"18 on {card} over {backend}: 18a {ZAMBA2} ({SSM_SERVE[backend]['layers']} layers) "
        f"served in {serve['seconds']:.1f} s, 18b {MAMBA2} ({SSM_TRAIN[backend]['layers']} "
        f"layers) trained in {train['seconds']:.1f} s; phase {time.perf_counter() - t0:.1f} s")
    return {"serve": serve, "train": train}


def main() -> int:
    import argparse

    import torch

    started = time.perf_counter()
    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch port on the card.")
    parser.add_argument("--chips", type=int, choices=(1, 4), default=1,
                        help="4: only the distributed phase, one rank per card over NCCL")
    chips = parser.parse_args().chips

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < chips:
        print(f"chip_smoke: --chips {chips} needs {chips} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    from repro_torch.core import gen, symbolic
    from repro_torch.core.batched import plan_batches
    from repro_torch.core.distsparse import scatter_to_grid
    from repro_torch.core.grid import make_grid
    from repro_torch.core.specs import PlanSpec
    from repro_torch.kernels import _build, segment_reduce as S, spgemm_binned as Bn
    from repro_torch.kernels import spgemm_hash as H

    # 1. card
    for line in card_lines(chips):
        log(line)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")

    if chips == 4:  # the 4-device n = 2^20 tune runs on the host while the cards work
        background = BackgroundTune(None, (4,))

    # 2. build
    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s wall for {sorted(built)}")
    for name, (secs, out) in built.items():
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}: {secs:.2f} s; " + " | ".join(regs))

    if chips == 4:  # 9 and 11's grid parts alone: one rank per card over NCCL
        try:
            grid_phase(N_FULL, "nccl", with_mcl=True, tri_scale=TRI_SCALE, p11={
                "dense_n": N_DENSE_NCCL, "dense": (((2, 2, 1), 1),), "place_count": None},
                p13={"n": N_MCL, "shapes": (GRID_SHAPES[0],), "mcl_host": False})
            picks, full_b = background.result()
        finally:
            background.close()
        t4, host_s = picks[4]
        log_tuned(f"11c autotune n=2^20, 4 devices, budget {full_b} B (worker process)", t4,
                  host_s)
        tuned_phase_four_cards(t4, N_FULL)
        mesh_phase("nccl")  # 16: one rank per card
        mesh_train_phase("nccl")  # 17: one rank per card
        ssm_mesh_phase("nccl")  # 18: one rank per card
        log(f"chip_smoke --chips 4: {time.perf_counter() - started:.1f} s")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # 3. main path
    grid = make_grid(1, 1, 1)
    t0 = time.perf_counter()
    a = gen.protein_similarity_like(N_FULL, blocks=N_FULL // 64, intra_p=0.12, seed=0)
    A = scatter_to_grid(a, grid, "A")
    B = scatter_to_grid(a, grid, "B")
    nnz = int(a.nnz)
    log(f"full size: n={N_FULL}, nnz(A)={nnz} ({nnz / N_FULL:.2f}/row), "
        f"tile cap {A.cap}, set-up {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ref_full = scipy_square(a)
    log(f"scipy A@A: nnz {len(ref_full[0])} ({len(ref_full[0]) / N_FULL:.1f}/row), "
        f"{time.perf_counter() - t0:.1f} s")
    # budget: inputs plus 1/1024 of the hash plan's table bytes, so the
    # plan's own batch count is 1024 (wb = 1024: the hash path's packed
    # (tm, wb) keys must fit in i32)
    r = PlanSpec().r_bytes
    probe = plan_batches(A, B, grid, 1 << 62, spec=PlanSpec(local_path="hash"))
    hash_bytes = symbolic.estimate_mem_c_bytes(
        probe.max_unmerged_nnz, probe.compression_est, r, local_path="hash")
    inputs = r * (int(A.nnz.max()) + int(B.nnz.max()))
    budget = inputs + -(-r * -(-hash_bytes // r) // 1024)
    log(f"budget: {budget} B per process (inputs {inputs} B, hash table "
        f"estimate {hash_bytes} B, flops {probe.total_flops}, "
        f"compression est {probe.compression_est:.3f})")

    a14 = gen.protein_similarity_like(N_DEFAULT, blocks=N_DEFAULT // 64, intra_p=0.12, seed=0)
    A14 = scatter_to_grid(a14, grid, "A")
    B14 = scatter_to_grid(a14, grid, "B")
    budget14 = 48 * int(a14.nnz)
    ref14 = scipy_square(a14)

    runs, launches, walls = {}, {}, {}
    counted = {"hash": H.hash_expand_insert_cuda, "hash_chunk": H.hash_insert_cuda,
               "binned": Bn.spgemm_paired_binned_cuda, "segment_reduce": S.segment_reduce_cuda}
    for label, (AA, BB, bud, lp, n) in {
        "hash n=2^20": (A, B, budget, "hash", N_FULL),
        "esc n=2^20": (A, B, budget, "esc", N_FULL),
        "auto n=2^14": (A14, B14, budget14, "auto", N_DEFAULT),
    }.items():
        for w in counted.values():
            w.launches = 0
        res, wall, peak, parts = run_multiply(AA, BB, grid, bud, lp)
        launches[label] = {name: w.launches for name, w in counted.items()}
        err = check_product(parts, ref_full if n == N_FULL else ref14, n)
        if lp == "auto":
            auto_parts = parts
        del parts
        runs[label], walls[label] = res, wall
        log(f"{label}: path {res.local_path}, b={res.plan.num_batches}, "
            f"retries {res.num_retries}, wall {wall:.2f} s, peak "
            f"{peak / 2**30:.3f} GiB, max rel err {err:.3g}, launches "
            f"{launches[label]}, caps {res.plan.caps}, "
            f"hash_caps {res.hash_caps}, binned_caps {res.binned_caps}")
    hash_launches = launches["hash n=2^20"]["hash"]
    binned_launches = launches["auto n=2^14"]["binned"]
    rh, resc, rb = runs["hash n=2^20"], runs["esc n=2^20"], runs["auto n=2^14"]
    if not (rh.plan.num_batches >= 1024 and rh.num_retries == 0
            and hash_launches == rh.plan.num_batches
            and launches["hash n=2^20"]["hash_chunk"] == 0):
        raise AssertionError(f"hash run: needs b >= 1024 and exactly one fused hash launch "
                             f"per batch, no one-chunk launches: {launches['hash n=2^20']}")
    if launches["esc n=2^20"]["segment_reduce"] < resc.plan.num_batches:
        raise AssertionError(f"esc run: the segment reduction must sum every batch: "
                             f"{launches['esc n=2^20']}")
    if not (rb.local_path == "binned" and rb.plan.num_batches == 16 and binned_launches > 0):
        raise AssertionError("default run: must plan binned with b = 16 and launch it")
    _, wall2, _, parts2 = run_multiply(A14, B14, grid, budget14, "auto")
    if not same_parts(auto_parts, parts2):
        raise AssertionError("auto n=2^14: a second run gives other bits")
    log(f"auto n=2^14: second run bit-identical, wall {wall2:.2f} s")
    del auto_parts, parts2
    tune_pairs = phase3_pairs(runs, walls, {"hash n=2^20": nnz, "esc n=2^20": nnz,
                                            "auto n=2^14": int(a14.nnz)})
    # 11c's n = 2^20 tunes run on the host while the card works (after 3,
    # whose host-driven batch loops they would share the cores with)
    background = BackgroundTune(budget, (1, 4))

    # 4. kernels against their plain versions, on batch 0's operands
    a_cat, b_cat = batch0_operands(A, B, grid, rh.plan)
    h_err, h_ms, h_plain, h_bytes, h_adds = check_hash_kernel(a_cat, b_cat, rh.hash_caps)
    h_bound, h_by = bound_ms(h_bytes, h_adds)
    log(f"hash insert, one chunk: {h_ms:.6f} ms/launch (plain {h_plain:.4f}), bound "
        f"{h_bound:.7f} ms ({h_by}), {100 * h_bound / h_ms:.2f} % of bound")
    f_err, f_ms, f_plain, f_bytes, f_ops = check_fused_hash(a_cat, b_cat, rh.hash_caps)
    f_bound, f_by = bound_ms(f_bytes, f_ops)
    log(f"hash insert, fused: {f_ms:.6f} ms per batch (plain {f_plain:.4f}), bound "
        f"{f_bound:.7f} ms ({f_by}), {100 * f_bound / f_ms:.2f} % of bound")
    hash_batch_split(A, B, grid, rh.plan, rh.hash_caps, walls["hash n=2^20"],
                     rh.plan.num_batches)
    a_cat, b_cat = batch0_operands(A, B, grid, resc.plan)
    seg = check_segment_reduce(a_cat, b_cat, resc.plan.caps)
    seg_launches = launches["esc n=2^20"]["segment_reduce"]
    a_cat, b_cat = batch0_operands(A14, B14, grid, rb.plan)
    bin_of_k = torch.as_tensor(rb.plan.kbin.bin_of_k, device=a_cat.device)
    b_err, b_ms, b_plain, b_lib, b_bytes, b_flops = check_binned_kernel(
        a_cat, b_cat, rb.binned_caps, bin_of_k)
    b_bound, b_by = bound_ms(b_bytes, b_flops)
    log(f"binned: {b_ms:.6f} ms (plain {b_plain:.4f}, torch.sparse.mm {b_lib:.4f}), "
        f"bound {b_bound:.6f} ms ({b_by}), {100 * b_bound / b_ms:.2f} % of bound")

    # 5. the kernel API on the same batch 0 operands
    t0 = time.perf_counter()
    api = ops_phase(a_cat, b_cat, rb.binned_caps, bin_of_k)
    log(f"phase 5: {time.perf_counter() - t0:.1f} s")

    del a, A, B, A14, B14, a_cat, b_cat, runs, rh, resc, rb, ref_full
    torch.cuda.empty_cache()

    # 6. the dense-path kernels against their plain versions
    t0 = time.perf_counter()
    a_mcl, cfg_dense = mcl_dense_input()
    dk = check_dense_kernels(*dense_batch0(a_mcl, grid, cfg_dense), cfg_dense.max_per_col)
    acc = check_spmm_accumulate(gen.protein_similarity_like(
        N_DENSE, blocks=N_DENSE // 64, intra_p=0.12, seed=0), N_DENSE)
    log(f"phase 6: {time.perf_counter() - t0:.1f} s")
    # 14. the LM serving path (after 6: it profiles a decode tick, and the
    # profiler has recorded no device event late in long runs)
    p14 = lm_phase()
    # 15. training: the differentiable SpMM, the train step, the loop
    p15 = train_phase()
    # 7-8. Markov clustering, sparse and dense
    t0 = time.perf_counter()
    seg_mcl, ref7 = mcl_sparse_phase(grid)
    log(f"phase 7: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dense_launches, ref8 = mcl_dense_phase(grid, a_mcl, cfg_dense)
    log(f"phase 8: {time.perf_counter() - t0:.1f} s")
    del a_mcl
    torch.cuda.empty_cache()
    # 10. the masked multiply and the §V-B applications
    masked = masked_phase(grid)
    torch.cuda.empty_cache()
    # 11. the SUMMA3D steps, placement and the tuner on this card
    t0 = time.perf_counter()
    try:
        p11 = summa_phase(grid, gen.protein_similarity_like(
            N_DENSE, blocks=N_DENSE // 64, intra_p=0.12, seed=0), masked["tri16"])
        tune_phase(grid, a14, budget14, ref14, tune_pairs, background)
    finally:
        background.close()
    del a14, ref14
    torch.cuda.empty_cache()
    log(f"phase 11 (one card): {time.perf_counter() - t0:.1f} s")
    # 12. durability: the resilient MCL loops and APSP
    p12 = durability_phase(grid, ref7, ref8)
    del ref7, ref8
    torch.cuda.empty_cache()
    # 13. serving: the plan-cached engine on this card
    p13 = serve_phase(grid, masked["tri16"])
    torch.cuda.empty_cache()
    # 9. four ranks on this card over gloo, with 11's and 13's grid parts
    grid_launches, dense_grid, serve_grid = grid_phase(
        N_GRID, "gloo", with_mcl=False, tri_scale=TRI_PINNED_SCALE,
        p11={"dense_n": N_DENSE, "dense": DENSE_GLOO, "place_count": masked["tri16"]},
        p13={"n": N_SERVE_GLOO, "shapes": GRID_SHAPES, "mcl_host": True})
    per_rank = lambda label: {tag: n for (tag, lab), n in grid_launches.items() if lab == label}
    torch.cuda.empty_cache()
    # 16. LM serving on a 2x2 (data, model) mesh: four ranks on this card over gloo
    p16 = mesh_phase("gloo")
    torch.cuda.empty_cache()
    # 17. training on a 2x2 (data, model) mesh: four ranks on this card over gloo
    p17 = mesh_train_phase("gloo")
    torch.cuda.empty_cache()
    # 18. the ssm and hybrid families on a 2x2 (data, model) mesh: four ranks
    # on this card over gloo
    ssm_mesh_phase("gloo")

    seg_err, seg_ms, seg_plain, seg_lib, seg_bytes, seg_ops = seg
    seg_bound, seg_by = bound_ms(seg_bytes, seg_ops)
    kernels = [
        {"name": "hash_insert", "route": "cuda",
         "source": "src/repro_torch/csrc/spgemm_hash.cu",
         "replaces": "src/repro/kernels/spgemm_hash.py:159",
         "launches": hash_launches, "max_abs_err": max(h_err, f_err, masked["max_abs_err"]),
         "ms": f_ms,
         "plain_ms": f_plain, "bound_ms": f_bound, "bound_by": f_by, "library_ms": None,
         "per": "batch: one fused expansion + insert launch",
         "grid_n2^18_launches_per_rank": per_rank("hash"),
         "grid_triangles_launches_per_rank": per_rank("triangles"),
         "masked": {"launches": masked["launches"], "ms": masked["ms"],
                    "plain_ms": masked["plain_ms"], "bound_ms": masked["bound_ms"],
                    "bound_by": masked["bound_by"], "max_abs_err": masked["max_abs_err"],
                    "unmasked_ms_same_batch": masked["unmasked_ms"],
                    "unmasked_bound_ms_same_batch": masked["unmasked_bound_ms"],
                    "partial_products": masked["flops"], "mask_keys": masked["mask_keys"]}},
        {"name": "segment_reduce", "route": "cuda",
         "source": "src/repro_torch/csrc/segment_reduce.cu",
         "replaces": "src/repro/core/sortkeys.py:94",
         "launches": seg_launches,
         "max_abs_err": max(seg_err, *(s[3] for s in seg_mcl.values())), "ms": seg_ms,
         "plain_ms": seg_plain, "bound_ms": seg_bound, "bound_by": seg_by,
         "library_ms": seg_lib,
         "grid_n2^18_launches_per_rank": per_rank("esc"),
         "mcl_n2^18_batch": {stage: {"launches": n, "ms": ms, "bound_ms": b,
                                     "max_abs_err": e}
                             for stage, (n, ms, b, e) in seg_mcl.items()}},
        {"name": "spgemm_paired_binned", "route": "cuda",
         "source": "src/repro_torch/csrc/spgemm_binned.cu",
         "replaces": "src/repro/kernels/spgemm_binned.py:119",
         "launches": binned_launches, "max_abs_err": b_err, "ms": b_ms,
         "plain_ms": b_plain, "bound_ms": b_bound, "bound_by": b_by, "library_ms": b_lib},
    ]
    for name, launch_key, source, replaces in (
        ("col_topk_bounds", "col_topk_bounds", "col_prune.cu", "col_prune.py:54"),
        ("spmm", "spmm", "spmm.cu", "spmm.py:64"),
        ("densify", "densify", "densify.cu", "densify.py:46"),
    ):
        err, ms, plain, lib, nbytes, ops = dk["col_prune" if name == "col_topk_bounds" else name]
        bound, by = bound_ms(nbytes, ops)
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}", "launches": dense_launches[launch_key],
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": by, "library_ms": lib,
        })
    for name, source, replaces in (
        ("bitonic_sort_pairs", "sort_engine.cu", "sort_engine.py:69"),
        ("spgemm_paired", "spgemm_acc.cu", "spgemm_acc.py:67"),
    ):
        launched, err, ms, plain, lib, nbytes, ops = api[name]
        bound, by = bound_ms(nbytes, ops)
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}", "launches": launched,
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": by, "library_ms": lib,
        })
    # phase 11's launches of each kernel it reaches, each run's counts set
    # to 0 just before it and read just after; SpMM's accumulate mode
    row = {k["name"]: k for k in kernels}
    for name in ("densify", "spmm"):
        row[name]["phase11_dense_step_launches"] = {
            "one_card_n2^15": {s: x["launches"][name] for s, x in p11["dense"].items()},
            **{f"gloo_{tag}_per_rank": {s: [x[name] for x in per] for s, per in recs.items()}
               for tag, recs in dense_grid.items()}}
    acc_err, acc_ms, acc_plain, acc_lib, acc_bytes, acc_ops = acc
    acc_bound, acc_by = bound_ms(acc_bytes, acc_ops)
    row["spmm"]["accumulate"] = {"max_rel_err": acc_err, "ms": acc_ms, "plain_ms": acc_plain,
                                 "bound_ms": acc_bound, "bound_by": acc_by,
                                 "library_ms": acc_lib}
    row["hash_insert"]["phase11_launches"] = {
        "sparse_step_n2^18": p11["sparse"]["hash"]["hash"],
        "placement": {s: x["launches"] for s, x in p11["placement"].items()}}
    row["segment_reduce"]["phase11_sparse_step_n2^18_launches"] = \
        p11["sparse"]["esc"]["segment_reduce"]
    # phase 12's launches, each run's counts set to 0 just before it
    p12c = p12["12c"]
    row["hash_insert"]["phase12_launches"] = {
        "apsp_n2^11_hash": p12c["hash_n2^11"], "apsp_n2^11_hash_resilient":
        p12c["hash_n2^11_resilient"], "apsp_n2^10_hash": p12c["hash_n2^10"]}
    row["segment_reduce"]["phase12_launches"] = {
        "mcl_n2^18_resilient": p12["12a"]["launches"], "apsp_n2^10_esc_min": p12c["esc_n2^10"]}
    row["segment_reduce"]["phase12_min_max_abs_err"] = p12c["min_hold_err"]
    row["spgemm_paired_binned"]["phase12_launches"] = {
        "mcl_n2^14_resumed_child": p12["12b"]["launches"]}
    # phase 13's launches, each engine's counts set to 0 just before its run
    for name, counter in (("hash_insert", "hash"), ("segment_reduce", "segment_reduce"),
                          ("spgemm_paired_binned", "binned")):
        row[name]["phase13_launches"] = {
            engine: p13[engine]["launches"][counter] for engine in ("13a", "13b", "13c")}
    row["segment_reduce"]["phase9_serve_n2^16_launches_per_rank"] = serve_grid
    # phase 14's MoE dispatch and combine, each run's count set to 0 just before it
    spmm14 = p14["spmm"]
    row["spmm"]["moe_launches"] = {
        "14a_smoke_f32": {a: r["launches"] for a, r in p14["smoke"].items() if r["launches"]},
        "14b_olmoe_stream_runs": p14["olmoe"]["launches"],
        "14d_olmoe_f32_2_layers": p14["f32"]["launches"]}
    for op in ("dispatch", "combine"):
        row["spmm"][f"moe_{op}_ms"] = {
            f"{where}_{dt}": spmm14[f"{op}_{where}"][dt]["ms"]
            for where in ("prefill_T512", "decode_T8") for dt in ("bf16", "f32")}
    for field in ("bound_ms", "bound_by", "plain_ms", "max_abs_err"):
        row["spmm"][f"moe_{field}"] = {f"{key}_{dt}": rec[dt][field]
                                      for key, rec in spmm14.items() for dt in ("bf16", "f32")}
    row["spmm"]["moe_library_ms"] = {key: rec["library_ms"] for key, rec in spmm14.items()}
    row["spmm"]["moe_decode_tick_profile"] = p14["olmoe"]["profile"]
    # phase 15's training launches (forward, remat recompute, dB), each
    # run's count set to 0 just before it; the T = 16384 timings
    p15s, p15b = p15["smoke"], p15["olmoe"]
    row["spmm"]["train_launches"] = {
        **{f"15a_{a}_grads_remat_off": r["grads"]["launches"]
           for a, r in p15s.items() if a != "launcher"},
        **{f"15a_{a}_loop_{TRAIN_LOOP_STEPS}_steps": r["loop_launches"]
           for a, r in p15s.items() if a != "launcher"},
        **{f"15a_{a}_dp_{TRAIN_DP_STEPS}_steps": r["dp"]["launches"]
           for a, r in p15s.items() if a != "launcher"},
        "15a_launcher_olmoe_smoke_3_steps": p15s["launcher"]["launches"],
        "15b_olmoe_4_layers_per_step": p15b["launches"]}
    row["spmm"]["train_grad_max_abs_err"] = {a: r["grads"]["max_abs_err"]
                                            for a, r in p15s.items() if a != "launcher"}
    for field in ("ms", "bound_ms", "bound_by", "plain_ms", "max_abs_err"):
        row["spmm"][f"train_{field}"] = {f"{key}_{dt}": rec[dt][field]
                                        for key, rec in p15b["spmm"].items()
                                        for dt in ("bf16", "f32")}
    row["spmm"]["train_library_ms"] = {key: rec["library_ms"] for key, rec in p15b["spmm"].items()}
    row["spmm"]["train_dvals_plain"] = p15b["dvals"]
    row["spmm"]["train_step_profile"] = p15b["profile"]
    # phase 16's launches per rank: run 1, run 2, the check's prefill and decode
    row["spmm"]["mesh_2x2_launches_per_rank"] = p16["launches_per_rank"]
    # phase 17's training launches per rank and step, each step's count set to 0 just before it
    row["spmm"]["mesh_train_2x2_launches_per_rank"] = p17["launches_per_rank"]
    log(f"chip_smoke: {time.perf_counter() - started:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
