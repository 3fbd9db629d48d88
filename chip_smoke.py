"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

1. Card and build: the card's name and power limit; the four CUDA
   libraries built from src/repro_torch/kernels/csrc/ (one nvcc per
   source, in parallel), with the build time.
2. Kernels against their plain PyTorch versions on the card, byte for
   byte: each of the nineteen entry points at the main path's shape — 100
   ranks x 2600 pages of 1024 words, with `stored` corrupted on a few
   pages, the syndrome sweeps at r = 3 — at the 16-page patch shape, and at
   edge shapes (1 page, 13 pages, 64-word pages; the syndrome sweeps at
   r = 2 and r = 4); the XOR kernel also on 1-D runs whose length is not a
   multiple of 4 and on slices that are not 16-byte aligned; the
   weight_words kernel (gf_scale, sdelta_stack) at r = 1..4 on leads 1, 3
   and 100, rows from 4 words to a block's share ± 4 words, and
   coefficients 0 and 1; the page-run sweeps (`syndrome_edges`: the five
   syndrome_pages entry points at r = 2..4; `fletcher_edges`: both
   fletcher_pages entry points) on leads 1, 3 and 100 of 1, K - 1, K,
   K + 1, 16 and 2600 pages (K the pages a CTA takes) of 4 and 1024
   words, the coefficient tables holding 0 and 1; commit_pages
   (`commit_edges`: its nine entry points, fused_accum_commit_tb the
   ninth) on the same shapes.  Then each timed at the
   main path's shape with CUDA events: one launch with its enqueue
   (`kernel_ms`, median of 12 runs after warm-up) and the device time of
   20 back-to-back launches enqueued behind a spin kernel (`device_ms`;
   operands under 100 MB cycle through a ring of input sets larger than
   twice the L2; a kernel and its library call in turns, k, lib, lib, k),
   beside its plain version, the one PyTorch call that computes the same
   function where there is one (`torch.bitwise_xor` for the XOR kernel),
   its least time on the card (by bytes, and by the integer operations of
   the byte-table GF multiply), the integer-op time of the 32-step
   multiply and, for the table multiply that every GF kernel runs, the
   time of its shared-memory lookups.  A device time under 95% of its
   bound fails the run.  `xor_delta` and `sdelta_stack` also at the patch
   flush's shape (100 ranks x 34 pages), with the host µs a call of
   `xor_delta` and `torch.bitwise_xor`; the three row-10 syndrome sweeps
   and the rows 3-4 sweeps (fused_commit, fused_verify_commit,
   fused_commit_old_terms) at the 16-page patch's shape (100 ranks x 16
   pages, r = 3 for the syndrome sweeps), L2-cold.
3. The r = 1 main path at the pool size of Pangolin's headline figure: a
   zone of G = 100 data ranks holding about 1.065 GB of rows (2600 pages a
   rank), so the parity is about 1% of the pool.  Through `Pool`, with
   random weights from a seed: open (mlpc, r = 1), a bulk transaction with
   verify, a bulk commit, 16-page patches with and without verify, the
   same patch on an mlp pool, rank loss + recover, scribble + scrub +
   repair, canary abort.
4. The r = 3 main path on the same zone: open (mlpc, redundancy 3), a bulk
   transaction with verify (streamed), a bulk commit, 16-page patches with
   and without verify, the patch on an mlp r = 3 pool, the pre-check, the
   loss of ranks 5, 37 and 99 at once recovered by `Fault.multi_loss`
   (the rebuilt rows must equal a copy taken before the loss), a scrub.
4a. The multi-process zone (zp): the same zone split over four worker
   processes on the one card (`repro_torch.dist.procs.spawn_zone`, a gloo
   group, each worker its own CUDA context holding 25 ranks, 266 MB of
   rows; the exchanges staged through host buffers), each worker building
   the whole state from SEED and keeping its block.  r = 1 (mlpc):
   a open, b a bulk transaction with verify, c a bulk commit, d two
   16-page patches (with and without verify) whose pages have parity
   owners on every process (pages 100-103, 780-783, 1560-1563,
   2340-2343: owners 3, 30, 60, 90), e a clean scrub, f the loss of rank
   57 (process 2) recovered, g a scribble on rank 88 (process 3) found by
   the scrub and repaired, h a canary smashed on process 1 only: every
   process aborts, nothing changes.  r = 3: i open, j a bulk commit, k
   the loss of ranks 7, 42 and 93 (processes 0, 1, 3) recovered, l a
   word flipped on rank 20 (process 0) found by the pre-check on every
   process and repaired, m a four-rank loss refused by the budget.  After
   every phase each worker's per-rank SHA-256 of row, syndromes,
   checksums, digest and every state leaf, and of the redo log and step,
   equals the one-process pool's at the same phase (run first, in this
   process, its launches not counted).  Each phase prints the slowest
   worker's wall, each worker's wall, staged bytes, sent bytes and the
   ms of its staging, the launches summed over the workers, and each
   worker's peak memory.  The workers time-slice the card: their kernel
   times are not the kernel table's.
4b. The deferred engines and the async ring on the split zone (zw), the
   same four workers, each phase held as zp's phases are (the open
   window's accumulator, live row, dirty mask, pending count, size and
   attempts hashed too):
   W — w3's engine (mlpc r = 3, window 4, streamed): a open, b three
        in-window commits, c the fourth and the flush, d a commit, e a
        staged abort mid-window whose guard page is smashed on process 1
        only (the canary agreed on the device: every process aborts), f a
        commit, g the loss of ranks 5, 37 and 99 recovered, its window
        bound from the mirrored meta (2 pending, digests verified), h a
        clean scrub that regrows the window;
   P — the patch engine (mlp r = 3, window 8) on w_fsdp and w_tp, four
        pages a commit past the leaves' own two: a open, b seven commits
        naming their words (512 words of each rank's w_fsdp shard, whose
        XOR deltas differ by rank, and 2048 of w_tp; the third also names
        two words past w_tp), c the eighth and the flush (xor_delta);
   Q — q3's ring (mlpc r = 3, depth 4): a open and the warm-up (a
        verified, a staged abort smashed on process 1, a patch), b eight
        bulk commit_async (the third verified, the fifth a staged abort),
        c poll and drain, e sixteen 16-page patches whose pages have an
        owner on every process, g the loss of ranks 5, 37 and 99 with
        three tickets in flight.
   A split dispatch blocks (its exchanges stage through the host), so
   the ring's lines print each worker's dispatch ms; no dispatch runs
   under the sync-debug mode here.  The one-process run drops the
   synchronous comparison pools of w3, wp and q3: it is the comparison.
4c. The hosts of a pool on the split zone, each phase held as zp's are
   (each prints its wall, one-process and spawn to join, and each
   worker's peak):
   zg — two workers, 50 + 50 ranks: a PoolGroup of tg's four tenants
        (mlpc r = 3): admission, a bulk wave, a verified wave, a wave
        with t2's canary failing, a word of t1 scribbled on rank 77
        (process 1) found by `scrub_tick` and recovered under
        quarantine, t3's loss of ranks 5, 37 and 99 recovered beside an
        async wave of the others, t0 evicted (its global state's hash
        equal everywhere); the four at window 2, a wave and the flushing
        one; then el's rescale walk, 100 x 1 -> 50 x 2 -> 100 x 1 over
        the same two processes, sync and window 4, each rescaled pool
        equal to a split pool freshly opened over its state;
   zs — four workers, one data rank and four batch rows each: sv's
        server (qwen3-0.6b, batch 16, max_len 2048, (4, 2)) through a
        8-token prompt, 4 tokens, rank 2 (process 2) lost and
        recovered, 4 tokens more, a scrub; then r = 3 / window 4 and
        pipeline_depth 2 runs of 4 + 4 tokens; the tokens gathered in
        rank order equal to one process's;
   zt — two workers: tr's trainer at microbatches 2 (qwen3-0.6b at 4
        of its 28 layers, seq 1024 x batch 8, (4, 2)) against one
        process at microbatches 2: the init, step 1, step 2 with
        verify_old, rank 3 (process 1) lost and recovered, step 3 with a
        failed canary, step 3, a scrub; each step's loss and verdict
        equal.
   The workers time-slice the card: their kernel times are not the
   kernel table's.
4d. The chaos campaign on the split zone (zc), four workers against one
   process on the same meshes, each run's final pools held as zp's are:
   ch's quick campaign and storm cell (1, 1) on 100 x 1 over four and
   50 x 2 over two (rescale_under_traffic goes 4 -> 2 -> 4 processes);
   g — a PoolGroup of four 266 MB tenants (mlpc r = 3) rescaled 100 x 1
        over four -> 50 x 2 over two (workers 2 and 3 join as spares) ->
        100 x 1 over four, a wave after each and a scrub tick finding
        nothing, sync and at window 4;
   r — a snapshot at 100 x 1 over four restored onto 50 x 2 over two by
        a loss of ranks 7 and 31 past r = 1 (the spares send their
        rows), then back to four and rank 57 (process 2) lost online;
   e — rescale_under_traffic's 4 -> 2 alone: it ends on two processes.
   Each run golden-exact on every process, each worker's recoveries one
   process's, every rescale's and the restore's moved bytes those the
   interval intersections reckon (printed with their ms).
5. The deferred-epoch engine (window > 1) on the same zone:
   w3 — the bulk engine, streamed, mlpc r = 3, window 4: open, three
        in-window commits, the fourth (the boundary flush), a commit, a
        canary abort mid-window, a commit, the loss of ranks 5, 37 and 99
        recovered by `Fault.multi_loss` (the recovery flushes first), a
        scrub;
   w1f — the bulk engine on the flat kernel (stream threshold 1<<22),
        mlpc r = 1, window 4: open, four commits;
   wp — the patch engine, mlp r = 3, window 8, the w_tp leaf dirty: open,
        eight commits of w_tp (one names its words), the eighth the
        boundary flush.
   Every boundary is compared byte for byte with a synchronous pool given
   the same states (its commits run outside the clock and its launches
   are not counted).
6. The async commit ring and tenancy on the same zone:
   q3 — the synchronous engine, mlpc r = 3, pipeline_depth 4: a warm-up
        (a verified, a staged-abort and a patch commit), eight bulk
        commit_async (the third with verify_old, the fifth with a staged
        canary from a smashed guard buffer, `tx.canary_device()`), poll
        and drain, sixteen 16-page patches, the loss of ranks 5, 37 and
        99 with three tickets in flight (the recovery drains first);
   qw — the w3 engine at depth 4: eight commit_async, the third a staged
        abort mid-window;
   tg — a PoolGroup of four tenants of the main path's state in one
        cohort (mlpc r = 3, sync engine): admission, a bulk wave, a
        verify_old wave, a wave where t2's canary fails, the same bulk
        wave looped (`batched=False`), two waves through commit_async at
        depth 2, a scrub_tick under a two-pool page budget, and t1's
        recovery from the loss of ranks 5, 37 and 99 beside a wave of the
        other three;
   tw — the same group at window 4: four waves, the fourth the flush.
   q3 and qw are compared at every drained boundary with a pool that
   resolves each commit before the next (its walls reported beside,
   its launches not counted), every tg / tw wave with four solo pools
   replayed on the same states outside the clock.  Every dispatch into a
   ring that is not full runs under torch.cuda.set_sync_debug_mode(
   "error"); each batched wave must launch each of its kernels once.
7. Elastic rescale, straggler mitigation and the chaos campaign:
   el — on the same zone, a synchronous mlpc r = 3 pool: commit, rescale
        to a 50 x 2 mesh, commit, rescale to 100 x 1, commit; the same on
        a w3-style pool (window 4, streamed) with a commit pending in the
        window at each rescale (the flush is on the clock).  After each
        rescale the invariants at the new G, the same bytes as a pool
        freshly opened on the new mesh, the step carried.  A window-8
        pool (straggler_threshold 2.0, window_growth_commits 4) fed commit
        times with rank 37 at 6x: rank 37 dropped, the window at 1, the
        health degraded; healed, the window regrows.  A PoolGroup of two
        tenants rescaled 100 x 1 -> 50 x 2, each tenant against a solo
        pool rescaled the same way;
   ch — the chaos workload's initial state and traffic step on the card
        against the host form and the CPU (a sample); then every scenario
        of the quick campaign and its first two storm cells, (1, 1) and
        (2, 16), at full width: 1,064,960,000 bytes a workload (a quarter
        of that for each of multi_tenant_interference's eight live
        tenants) on the reference's meshes scaled up, (4, 2) -> 50 x 2 and
        (8, 1) -> 100 x 1, traced in memory.  Each must end golden-exact
        with no trace violation; each prints its commit p50 / p99 clean
        and during a disturbance, its recovery and rescale ms, the window
        trace, its peak memory and its launches.
8. The serving plane (sv): qwen3-0.6b at its published width (28 layers,
   d_model 1024, GQA 16 / 8 heads of 128, vocab 151,936; 596,049,920
   parameters, random from SEED, bf16 compute) served by
   `repro_torch.runtime.Server` at batch 16 and max_len 2048 on the (4, 2)
   zone mesh, block_words 256, its KV cache (3,758,325,760 B) in a Pool:
   a — start: the pool opens over the empty cache;
   b — prefill a 32-token prompt and generate 32 tokens at mlpc r = 1,
        window 1, depth 1 (scrub every 16 commits), each decode step a
        252-page patch commit; the ms a step split into the decode, the
        zone copies (`pool.state`, `Pool.to_zone`), the commit and the
        scrub ticks, and tokens/s;
   c — the same unprotected (`protect_cache=False`): the same tokens;
   d — after prefill, a word of each cache leaf scribbled in rank 0's
        shard, scrubbed and repaired: the rows equal b's at that point;
   e — rank 1 lost 16 tokens later and recovered (rows equal b's), then
        on to the end: b's tokens;
   f — redundancy 3, window 4, pipeline_depth 4 (the deferred patch
        engine on dirty_words, the commit ring) through the loss of ranks
        0, 1 and 3: b's tokens;
   g — after b and after f (flushed), row, syndromes, checksums and
        digest equal a pool freshly opened over the final cache;
   h — (after c) the decode checked apart from the port: b's prompt and
        tokens teacher-forced through `Model.decode_step` over an empty
        2048-slot cache, its logits finite, its argmax b's tokens, within
        2^-4 of the largest |logit| of an f32 forward of the whole
        sequence on the same weights (no cache; causal attention by
        `scaled_dot_product_attention`, its own GQA grouping and rope).
   Each kernel the path launched is then held against its plain version
   on the card at the very inputs its first launch on the path had
   (recorded by `CallProbe` in d-f).
9. The training plane (tr): qwen3-0.6b at its published width, at
   TR_LAYERS = 14 of its 28 layers (full depth until PR 29), trained by
   `repro_torch.runtime.trainer.Trainer` (AdamW with f32 moments, lr
   1e-3, warmup 2; seq 1024 x batch 8 = 8,192 tokens a step of the
   synthetic stream) on the (4, 2) zone mesh at ProtectConfig's default
   block_words, its train state in a Pool (7.15 GB at full depth):
   a — start: the state made on the card from SEED, the pool opened;
   b — six steps (sixteen until PR 27) at mlpc r = 1, window 1, depth
        1, scrub every 6: 1-3 bulk commits, 4-6 with verify_old; the ms a
        step split into
        the train step, the zone copies (`pool.state`, `Pool.to_zone`),
        the commit and the scrub, tokens/s, each step's loss; the loss
        falls;
   c — the same six steps unprotected (mode none): the losses and the
        final state bit-equal to b's (the train step gives the same bits
        on every run);
   d — rank 1 lost after step 1 and recovered (the row equal to a copy
        taken before the loss, and the state to the row), a word of rank
        0's shard scribbled after step 2, scrubbed and repaired, on to
        step 6: b's losses, b's digest after every step, b's final state;
   e — step 3 with a failed canary: not committed, the cursor rolled back,
        the row unchanged; the next step is b's step 3;
   f — a checkpoint at step 4 (async save, then wait), on to step 6, the
        trainer dropped; a fresh one restores and replays 5-6 from the
        surviving redo log, each to its logged digest, to b's state at
        step 6; the ms of save, wait and restore;
   g — r = 3, window 4, pipeline_depth 4 through `run` on the ring, ranks
        0, 1 and 3 lost after step 5 and recovered: b's losses and final
        state; flushed, equal to a pool freshly opened over it;
   h — straggler_threshold 2.0, replica 1 at 10x: dropped, the loss-masked
        step commits with b's loss re-weighted (w / w: the reference's
        mask changes no gradient) and b's digest, its dispatch (batch,
        mask, train step, commit) under torch.cuda.set_sync_debug_mode(
        "error"); healed at 1x;
   i — (uncounted) the train step checked apart from the port: the
        chunked attention and its gradients on layer 0's q, k, v against
        `scaled_dot_product_attention` (math backend) in f32, within 1e-4
        of the largest |value|; step 1's loss and gradients (bf16) against
        a plain f32 forward and backward of the whole model (no chunks,
        no checkpointing, dense attention), within TR_LOSS_RTOL and at a
        cosine of at least TR_GRAD_COS a leaf.
   Every trainer is let go before the next phase starts; each phase line
   prints its peak memory.  Each kernel the path launched is held against
   its plain version on the card at the inputs of its first launch in
   d-h (copied to the host, checked after the phase, the plain version a
   data rank at a time).
10. The hybrid served (rg): recurrentgemma-2b at its published width and
   depth (26 layers: (rglru, rglru, attn) x 8 and a tail of two rglru
   blocks; d_model 2560, 10 heads on one KV head of 256, vocab 256,000,
   window 2048; 2,658,736,640 parameters from SEED, the attention's
   projections at a d_model fan-in (`soft_attention`), bf16 compute) served
   by `Server` at batch 128 and max_len 2048 (the window), block_words
   256, its 2,206,531,584 B cache of K/V rings and recurrent state in a
   Pool:
   a — start on the (4, 2) mesh, where the one KV head puts the rings'
        sequence on `model`: every leaf but the slot positions is dirty
        whole every step, so every commit is bulk (the footprint and the
        path recorded);
   b — 16 + 16 tokens (halved to make room for mv) at mlpc r = 1,
        window 1, depth 1, clocked: decode,
        zone copies, commit, scrub and the footprint's host time a step;
        equal to a fresh open;
   c — unprotected: b's tokens;
   h — (after c) b's tokens teacher-forced through the served bf16 decode
        at all 26 layers against an f32 forward apart from the port (the
        RG-LRU a loop over time, the conv a grouped conv1d, windowed
        attention by sdpa): its argmax gives b's tokens, every logit within
        2^-4 of the largest;
   d — a word of each leaf scribbled in rank 0 after prefill, scrubbed and
        repaired: the row equals b's there;
   e — rank 1 lost 8 tokens later and recovered (the row equals b's),
        on to the end: b's tokens and final row, checksums and digest;
   f — r = 3, window 4 (the deferred engine), depth 4 through the loss of
        ranks 0, 1 and 3 two commits into a window: b's tokens and final
        words, equal to a fresh open;
   g — the same decode on an (8, 1) mesh, where the rings keep their
        sequence: a time slot a ring plus the recurrent state, so every
        commit is a patch; b's tokens, equal to a fresh open.
   Each kernel the path launched is held against its plain version on the
   inputs of its first launch in d-g, a data rank at a time.
11. The hybrid trained (rt): the same model at full width, one group of
   depth (3 layers, 886,115,840 parameters, the attention as rg's),
   AdamW with bf16 moments (a 7.09 GB state), seq 4096 (twice the window)
   x batch 2 on (4, 2): a start; b 1 bulk and 1 verify_old step (2 and 2
   until PR 27); c the same unprotected, losses and state bit-equal; d
   rank 1 lost after step 1 and recovered, b's losses, digests and state;
   i the trained bf16
   step (its loss b's step 1) against a plain f32 one: loss within
   TR_LOSS_RTOL, every gradient at a cosine of TR_GRAD_COS.
12. The vlm (vl): chameleon-34b at full width (d_model 8192, GQA 64 / 8,
   qk-norm, 256 stub embedding positions), two layers (2,457,903,616
   parameters): one bf16 train step of 768 tokens behind the stub prefix
   against a plain f32 step, within TR_LOSS_RTOL and TR_GRAD_COS.
13. The ssm served (xs): xlstm-1.3b at its published width and depth
   (48 blocks: (7 mLSTM, sLSTM) x 6; d_model 2048, 4 heads, vocab
   50,304; 1,945,057,616 parameters from SEED conditioned by
   `soft_xlstm`, bf16 compute) served by `Server` at batch 4 and max_len
   2048 (off every state axis), block_words 256, on (4, 2): its
   2,826,242,688 B recurrent state (mLSTM C, n, m, conv history; sLSTM
   c, n, h, m) in a Pool, rewritten whole every token, so every commit
   is bulk and streamed.  a start; b 16 + 16 tokens (halved to make
   room for mv) at r = 1, clocked;
   c unprotected, b's tokens; h b's tokens teacher-forced through the
   served bf16 decode at all 48 blocks against an f32 forward that steps
   the recurrence a position at a time (`plain_mlstm`, `plain_slstm`),
   within 2^-4 of the largest logit, argmax agreement reported; d a
   scribble repaired; e a rank loss recovered; f r = 3, window 4, depth 4
   through a three-rank loss two commits into a window.  Each kernel
   held against its plain version at its first launch in d-f.
14. The ssm trained (xt): the same model at one group (7 mLSTM + 1
   sLSTM, 495,882,296 parameters), seq 4096 (16 chunks of 256) x batch
   2 on (4, 2), AdamW with bf16 moments: a start; b 1 bulk and 1
   verify_old step (2 and 2 until PR 27); c unprotected,
   losses and state bit-equal; d a rank loss; i the bf16 step against a plain f32 one whose mLSTM runs
   in chunks of 64 (so the chunk algebra is held too).
15. The moe served (mo): moonshot-v1-16b-a3b at its published width (d
   2048, 16 heads of 128, 64 experts of 1408, top-6 + shared, vocab
   163,840), depth cut to 8 layers (5,304,780,800 parameters, the
   attention as rg's), batch 16, max_len 2048, (4, 2), block_words 256:
   a 2,147,549,184 B KV cache, a time slot a step (the patch path).  The
   phases of xs; h against an f32 forward whose routed FFN loops over
   experts (`plain_moe`), every choice kept as a decode step keeps them,
   the share of expert choices the two routers make alike held to 0.9.
15a. The moe served at its largest (mv): llama4-maverick-400b-a17b at
   its published width (d_model 5120, 40 heads of 128 over 8 KV heads,
   128 experts of 8192, top-1 + shared, vocab 202,048), one ("dense",
   "moe") group of its 24 (18,553,267,200 parameters, 37.1 GB in bf16,
   the attention as rg's), batch 64 (the reference's decode_32k global
   batch of 128 halved: at 128 the path's peak on an H100 80GB HBM3 at
   700 W was 77.2 GB reserved),
   max_len 2048, (4, 2), block_words 256: a 1,073,741,824 B KV cache on
   the patch path.  The phases of mo; the expert stacks are
   widened to f32 a block of experts at a time (`moe.EXPERT_BLOCK_BYTES`)
   and h's f32 forward widens a layer, and an expert, as it runs.  h
   compares 32 sequences a pass; its f32 forward sends each token to the
   expert the decode chose (top-1: a choice that differs swaps the whole
   routed output), the share of choices its own router makes alike held
   to 0.9 and the ones that differ counted.  Each phase prints its peak
   reserved memory.
16. The moe trained (mt): moonshot's train step at full width and two
   layers (checkpointed groups), seq 1024 x batch 1, routed in the (4,
   2) mesh's four groups (capacity 30 an expert), aux losses weighed in,
   against a plain f32 step that routes in the same groups by its own
   router; the share of choices the two routers make alike held to 0.9.
17. The encoder-decoder served (es): seamless-m4t-large-v2 at its
   published width and depth (24 encoder + 24 decoder layers, d_model
   1024, 16 heads of 64, vocab 256,206; 2,034,784,256 parameters, the
   self and cross attention as rg's) served at batch 8, max_len 2048,
   (4, 2), block_words 256: a 3,221,422,080 B cache, half of it the
   cross K/V.  a0: the reference's serving, a few decode steps on the
   zero cross cache `start` opens, protected and unprotected alike, and
   the footprint a step declares (a slot of the cross leaves too).  Then
   every server's cross cache is filled after its start from 2,048
   frames of the synthetic stream's `src_embeds` (one bulk verify_old
   commit; at window 4 the pool opened again over the filled cache), and
   the phases of xs run on the patch path; h against an f32 forward of
   encoder and decoder (`plain_hidden` with `src`).
18. The encoder-decoder trained (et): the same model at 2 + 2 layers
   (650,551,296 parameters; both stacks checkpointed), seq 4096 source
   and target x batch 2, (4, 2), AdamW with f32 moments (a 7.81 GB
   state): the phases of xt.
19. The examples on the card (ex): examples/torch_quickstart.py in full,
   then the --smoke passes of torch_serve_protected (its faulted
   generation equal to its clean one), torch_train_fault_tolerant (at
   r = 1 and at --redundancy 3: a scribble, a rank loss or three, a canary
   abort, a crash and its replay) and torch_elastic_rescale, each on the
   card with its own asserts.
20. The dry run (dr): (a) `repro_torch.launch.dryrun` traces qwen3-0.6b's
   train_4k, prefill_32k and decode_32k cells at full size on the 16 x 16
   mesh on meta tensors, in a process of its own started with the run
   (the CPU's work beside the card's), each record printed; (b) one
   protected serving step at sv's shapes (batch 16, max_len 2048, (4, 2),
   block_words 256) run on the card under the cost mode and traced on
   meta: flops, bytes, launches and the kernels' records equal, and the
   card's allocation growth over the step at least the meta peak.
21. The cross-pod compressed mean (cm): qwen3-0.6b's gradients at full
   width (2.38 GB f32, random from SEED) on a (2, 4, 2) pod mesh with the
   parameters' specs, on the card; the embedding's and the stacked
   attention's leaves byte-equal to the same call on the CPU.
22. After each phase the invariants are recomputed apart from the engine:
   every syndrome plane k = XOR over ranks i of g^(k·i)·row_i, built rank by
   rank with the plain GF multiply; cksums = Fletcher terms of the rows;
   digest = combine(cksums); row = flatten(state).  Inside a window: the
   checksums and digest are the live rows'; the stack is the epoch start's;
   the bulk engine's accumulator is row_start ^ row_now, and the patch
   engine's row is pinned at the epoch start, its live row the live rows.
23. Each path's kernel launches (every count zeroed just before the path,
   read just after); every entry point of the path must have run.  Peak
   device memory of each path; the host ms of each async dispatch.

Every phase raises on failure.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import collections
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM: 3.35 TB/s of HBM; int32 ALU ops at 64 lanes per SM per clock
# (the 67 TFLOP/s fp32 peak is 128 lanes, an FMA counted as two) =
# 132 SMs * 64 * 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# shared-memory lookups: 32 lanes an SM a clock (128 B a clock, 4 B a lane)
LDS_LANES_PER_S = 132 * 32 * 1.98e9
L2_BYTES = 50e6
DEVICE_LAUNCHES = 20           # back-to-back launches a device_ms reading
SPIN_CYCLES = 4_000_000        # ~2 ms at 1.98 GHz: the host's head start
HOST_CALLS = 1000              # enqueues a host_us reading
G, PAGES, BW = 100, 2600, 1024
R = 3                          # the redundancy of the r >= 2 main path
LOST, SCRIBBLED = 37, 5        # the ranks the r = 1 path damages
MULTI_LOST = (5, 37, 99)       # the ranks the r = 3 path loses at once
WP_PAGES = 33                  # w_tp's pages a rank, the wp path's dirty set
FLUSH_SLOTS = WP_PAGES + 1     # pages its flush gathers (+ one fill slot)
SEED = 0

# The cost of the 32-step multiply, reported beside the bound and not a
# bound: 32 steps of acc ^= cur & bit mask; cur = (cur << 1) ^ (sign mask &
# POLY).  Compiled into a sweep it forms the doubling chain cur = x·g^i
# once a word for every plane (2 ALU instructions a step: SHF for the sign
# mask, LOP3 for the xor; the shift left issues on the FMA pipe) and adds
# one LOP3 a step for each weighted plane (scripts/torch_sass_counts.py).
# No kernel runs it on the words any more: weight_words (gf_scale,
# sdelta_stack) and syndrome_pages ran it until they took the table
# multiply, and it is the floor the table design has to beat.
def clmul_ops(planes):
    return 32 * (2 + planes) if planes else 0



CUDA = "src/repro_torch/kernels/csrc/"
KERNELS = {   # entry point: (CUDA source, TPU kernel replaced)
    "fletcher_blocks": (CUDA + "fletcher.cu",
                        "src/repro/kernels/fletcher.py:38"),
    "fletcher_stream": (CUDA + "fletcher.cu",
                        "src/repro/kernels/fletcher.py:82"),
    "fused_commit": (CUDA + "commit_fused.cu",
                     "src/repro/kernels/commit_fused.py:83"),
    "fused_verify_commit": (CUDA + "commit_fused.cu",
                            "src/repro/kernels/commit_fused.py:103"),
    "fused_commit_old_terms": (CUDA + "commit_fused.cu",
                               "src/repro/kernels/commit_fused.py:103"),
    "fused_verify_commit_stream": (CUDA + "commit_fused.cu",
                                   "src/repro/kernels/commit_fused.py:393"),
    "fused_commit_stream": (CUDA + "commit_fused.cu",
                            "src/repro/kernels/commit_fused.py:377"),
    "fused_commit_old_terms_stream": (CUDA + "commit_fused.cu",
                                      "src/repro/kernels/commit_fused.py:393"),
    "gf_scale": (CUDA + "gf_parity.cu", "src/repro/kernels/gf_parity.py:83"),
    "sdelta_stack": (CUDA + "gf_parity.cu",
                     "src/repro/kernels/gf_parity.py:224"),
    "fused_commit_s": (CUDA + "gf_parity.cu",
                       "src/repro/kernels/gf_parity.py:151"),
    "fused_verify_commit_s": (CUDA + "gf_parity.cu",
                              "src/repro/kernels/gf_parity.py:151"),
    "fused_commit_old_terms_s": (CUDA + "gf_parity.cu",
                                 "src/repro/kernels/gf_parity.py:151"),
    "fused_commit_s_stream": (CUDA + "gf_parity.cu",
                              "src/repro/kernels/gf_parity.py:311"),
    "fused_verify_commit_s_stream": (CUDA + "gf_parity.cu",
                                     "src/repro/kernels/gf_parity.py:311"),
    "fused_accum_commit": (CUDA + "commit_fused.cu",
                           "src/repro/kernels/commit_fused.py:185"),
    "fused_accum_commit_stream": (CUDA + "commit_fused.cu",
                                  "src/repro/kernels/commit_fused.py:436"),
    "xor_delta": (CUDA + "xor_parity.cu",
                  "src/repro/kernels/xor_parity.py:41"),
    "xor_accum": (CUDA + "xor_parity.cu",
                  "src/repro/kernels/xor_parity.py:41"),
}
# the one PyTorch call that computes the same function, where there is one
# (timed beside the kernel as its yardstick; the port never calls it)
LIBRARY = {"xor_delta": torch.bitwise_xor, "xor_accum": torch.bitwise_xor}
# the entry points each main path must launch
PATH_R1 = ("fletcher_blocks", "fletcher_stream", "fused_commit",
           "fused_verify_commit", "fused_commit_old_terms",
           "fused_verify_commit_stream")
PATH_R3 = ("gf_scale", "sdelta_stack", "fused_commit_s",
           "fused_verify_commit_s", "fused_commit_old_terms_s",
           "fused_verify_commit_s_stream")
PATH_W3 = ("fused_accum_commit_stream", "sdelta_stack", "fletcher_blocks",
           "gf_scale")
PATH_W1F = ("fused_accum_commit", "fletcher_blocks")
PATH_WP = ("xor_delta", "sdelta_stack", "fletcher_blocks")
PATH_Q3 = ("fletcher_stream", "sdelta_stack", "fused_verify_commit_s_stream",
           "fused_commit_s", "fletcher_blocks", "gf_scale")
PATH_QW = ("fused_accum_commit_stream", "sdelta_stack")
PATH_TG = ("fletcher_blocks", "sdelta_stack", "fused_verify_commit_s",
           "fletcher_stream", "gf_scale")
PATH_TW = ("fused_accum_commit", "sdelta_stack")
PATH_EL = ("fletcher_blocks", "fletcher_stream", "sdelta_stack",
           "fused_accum_commit_stream")
PATH_CH = ("fletcher_blocks", "fletcher_stream", "sdelta_stack",
           "fused_accum_commit_stream", "gf_scale")
TENANTS = 4                    # the tenancy paths' cohort
# the entry points of the page-run sweeps: syndrome_pages, fletcher_pages
SYNDROME = ("fused_commit_s", "fused_verify_commit_s",
            "fused_commit_old_terms_s", "fused_commit_s_stream",
            "fused_verify_commit_s_stream")
FLETCHER = ("fletcher_blocks", "fletcher_stream")
# the entry points of commit_pages (the commit_edges phase adds the
# tenant-batched fused_accum_commit_tb, a ninth way into the kernel)
COMMIT = ("fused_commit", "fused_verify_commit", "fused_commit_old_terms",
          "fused_verify_commit_stream", "fused_commit_stream",
          "fused_commit_old_terms_stream", "fused_accum_commit",
          "fused_accum_commit_stream")
# the entry points that take the syndrome coefficients (checked at each r)
WITH_R = ("gf_scale", "sdelta_stack") + SYNDROME
# The table multiply's shared-memory lookups a word a weighted plane (one
# per 4-bit chunk, gf.cuh): every GF entry point's kernel runs it.
TABLE_LOOKUPS = {name: 8 for name in WITH_R}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


# -- 2. kernels against their plain versions ---------------------------------

def entry_calls(old, new, stored, coeffs, scale_x):
    """{name: (kernel call, plain call)}; each returns a tuple of tensors.
    Pages `(*lead, n, bw)`; `coeffs` the `(*lead, r)` table of the
    syndrome entry points (r >= 2); `scale_x` the words gf_scale takes.
    The accumulate sweeps take ~old as the epoch accumulator."""
    from repro_torch.kernels import commit_fused as cf
    from repro_torch.kernels import fletcher as fl
    from repro_torch.kernels import gf_parity as gfk
    from repro_torch.kernels import ops
    from repro_torch.kernels import xor_parity as xp
    zeros = torch.zeros_like(stored)
    acc = torch.bitwise_not(old)
    rows = new.reshape(*new.shape[:-2], -1)
    c_last = int(coeffs.reshape(-1)[-1]) & 0xFFFFFFFF

    def bad(t):
        return (t != 0).any(-1)

    def s_plain(st=None, digest=False, keep=(0, 1, 2, 3)):
        out = gfk.syndrome_pages_plain(old, new, coeffs, st, digest)
        out = (out[0], out[1], bad(out[2]) if st is stored else out[2],
               out[3])
        return tuple(out[i] for i in keep)
    return {
        "fletcher_blocks": (lambda: (ops.fletcher_blocks(new),),
                            lambda: (fl.fletcher_pages_plain(new),)),
        "fletcher_stream": (lambda: ops.fletcher_stream(new),
                            lambda: fl.fletcher_stream_plain(new)),
        "fused_commit": (lambda: ops.fused_commit(old, new),
                         lambda: cf.commit_pages_plain(old, new)[:2]),
        "fused_verify_commit": (
            lambda: ops.fused_verify_commit(old, new, stored),
            lambda: cf.commit_pages_plain(old, new, stored)[:3]),
        "fused_commit_old_terms": (
            lambda: ops.fused_commit_old_terms(old, new),
            lambda: cf.commit_pages_plain(old, new, old_terms=True)[:3]),
        "fused_verify_commit_stream": (
            lambda: ops.fused_verify_commit_stream(old, new, stored),
            lambda: cf.commit_pages_plain(old, new, stored, digest=True)),
        "fused_commit_stream": (
            lambda: ops.fused_commit_stream(old, new),
            lambda: (lambda d, t, _, g: (d, t, g))(
                *cf.commit_pages_plain(old, new, digest=True))),
        "fused_commit_old_terms_stream": (
            lambda: ops.fused_commit_old_terms_stream(old, new),
            lambda: cf.commit_pages_plain(old, new, old_terms=True,
                                          digest=True)),
        "gf_scale": (lambda: (ops.gf_scale(scale_x, c_last),),
                     lambda: (gfk.gf_scale_plain(scale_x, c_last),)),
        "sdelta_stack": (lambda: (ops.syndrome_scale(rows, coeffs),),
                         lambda: (gfk.sdelta_stack_plain(rows, coeffs),)),
        "fused_commit_s": (lambda: ops.fused_commit_s(old, new, coeffs),
                           lambda: s_plain(keep=(0, 1))),
        "fused_verify_commit_s": (
            lambda: ops.fused_verify_commit_s(old, new, stored, coeffs),
            lambda: s_plain(stored, keep=(0, 1, 2))),
        "fused_commit_old_terms_s": (
            lambda: ops.fused_commit_old_terms_s(old, new, coeffs),
            lambda: s_plain(zeros, keep=(0, 1, 2))),
        "fused_commit_s_stream": (
            lambda: ops.fused_commit_s_stream(old, new, coeffs),
            lambda: s_plain(digest=True, keep=(0, 1, 3))),
        "fused_verify_commit_s_stream": (
            lambda: ops.fused_verify_commit_s_stream(old, new, stored,
                                                     coeffs),
            lambda: s_plain(stored, digest=True)),
        # the reference's order: (acc', old terms, new terms[, digest])
        "fused_accum_commit": (
            lambda: ops.fused_accum_commit(acc, old, new),
            lambda: (lambda a, t, m, _: (a, m, t))(
                *cf.commit_pages_plain(old, new, acc=acc))),
        "fused_accum_commit_stream": (
            lambda: ops.fused_accum_commit_stream(acc, old, new),
            lambda: (lambda a, t, m, g: (a, m, t, g))(
                *cf.commit_pages_plain(old, new, digest=True, acc=acc))),
        "xor_delta": (lambda: (ops.xor_delta(old, new),),
                      lambda: (xp.xor_words_plain(old, new),)),
        "xor_accum": (lambda: (ops.xor_accum(new, old),),
                      lambda: (xp.xor_words_plain(new, old),)),
    }


def max_abs_err(got, want):
    err = 0
    check(len(got) == len(want), f"{len(got)} outputs vs {len(want)}")
    for a, b in zip(got, want):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"output {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} "
              f"{b.dtype}")
        if a.dtype == torch.bool:
            err = max(err, int((a != b).sum()))
        else:
            err = max(err, int(((a.to(torch.int64) & 0xFFFFFFFF)
                                - (b.to(torch.int64) & 0xFFFFFFFF))
                               .abs().max()) if a.numel() else 0)
    return err


def cuda_ms(fn, runs=12, warm=2):
    for _ in range(warm):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ring_size(input_bytes, call_bytes):
    """Distinct input sets a timed run cycles through so that it reads from
    HBM and not from the 50 MB L2: one where a call's operands exceed twice
    the L2, else enough that the inputs alone do."""
    if call_bytes >= 2 * L2_BYTES:
        return 1
    return int(2 * L2_BYTES // input_bytes) + 2


def device_ms(fns, launches=DEVICE_LAUNCHES, warm=2):
    """Device ms of one call: CUDA events around `launches` back-to-back
    calls, cycling through `fns` (one per input set), over the count, after
    warm-up.  The calls are enqueued behind a spin kernel, so the events
    bracket the device's work and not the host's enqueue; the last
    len(fns) results are held, so the outputs cycle through distinct
    buffers as the inputs do."""
    held = collections.deque(maxlen=len(fns))
    for i in range(warm * len(fns)):
        held.append(fns[i % len(fns)]())
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for i in range(launches):
        held.append(fns[i % len(fns)]())
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def turns(fns, lib_fns):
    """device_ms of a kernel's calls and of the library's, timed in turns
    (kernel, library, library, kernel), each the mean of its two."""
    k0, l0, l1, k1 = (device_ms(fns), device_ms(lib_fns), device_ms(lib_fns),
                      device_ms(fns))
    return (k0 + k1) / 2, (l0 + l1) / 2


def host_us(fn, calls=HOST_CALLS):
    """Host µs a call: `calls` enqueues and one synchronize, after warm-up.
    Given a shape whose kernel takes less than its enqueue, the host's
    path is what this times."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def check_device_ms(what, ms, bound_ms):
    """A device time under 95% of the bound would be over 105% of the
    card's peak: the byte count or the cache set-up is wrong."""
    check(ms >= 0.95 * bound_ms, f"{what}: device {ms:.4f} ms under 95% of "
          f"its bound {bound_ms:.4f} ms")


def coeff_table(lead, r, dev):
    """Each leading index's syndrome coefficients: ranks of a G = 100 zone
    (the main path's own table for (G, 1) leads, else its last ranks)."""
    from repro_torch import ZoneMesh
    from repro_torch.core import gf
    if tuple(lead) == (G, 1):
        return gf.rank_syndrome_coeffs(G, r, ZoneMesh((G, 1), ("data", "m")),
                                       dev)
    n = 1
    for d in lead:
        n *= d
    table = torch.from_numpy(gf.syndrome_array(G, r)[G - n:].view("int32"))
    return table.reshape(*lead, r).to(dev)


def kernels_vs_plain(dev):
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import ops
    from repro_torch.kernels.fletcher import fletcher_pages_plain
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def pages(shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             device=dev, generator=gen)

    seg = PAGES * BW // G
    # (page shape, the syndrome sweeps' r values); the first is the main
    # path's full-row shape, the second its 16-page patch
    shapes = [((G, 1, PAGES, BW), (R,)), ((G, 1, 16, BW), (R,)),
              ((1, BW), (2, 4)), ((13, BW), (2, 4)), ((3, 13, 64), (2, 4))]
    timing = {}
    for shape, rs in shapes:
        old, new = pages(shape), pages(shape)
        stored = fletcher_pages_plain(old)
        stored[..., ::997, 1] ^= 1                 # a few corrupted pages
        main = shape == shapes[0][0]
        # gf_scale takes one (G, 1, seg) deficit plane on the main path
        scale_x = (new.reshape(G, 1, -1)[..., :seg].contiguous() if main
                   else new)
        for i, r in enumerate(rs):
            coeffs = coeff_table(shape[:-2], r, dev)
            calls = entry_calls(old, new, stored, coeffs, scale_x)
            for name, (kernel, plain) in calls.items():
                if i and name not in WITH_R:
                    continue                   # r-free: checked once
                got = kernel()
                torch.cuda.synchronize()
                err = max_abs_err(got, plain())
                check(err == 0, f"{name} at {shape}, r = {r}: kernel != "
                      f"plain (err {err})")
                if main:
                    n_pages = old.numel() // BW
                    words = (scale_x.numel() if name == "gf_scale"
                             else old.numel())
                    nbytes = kcost.io_bytes(name, words, n_pages, G, r)
                    planes = kcost.weighted_planes(name, r)
                    ops_n = kcost.int_ops(name, words, r)
                    algo_n = ((kcost.BASE_OPS[name] + clmul_ops(planes))
                              * words)
                    bound_b = nbytes / HBM_BYTES_PER_S * 1e3
                    bound_o = ops_n / INT32_OPS_PER_S * 1e3
                    bound = max(bound_b, bound_o)
                    fns = [kernel]
                    if name == "gf_scale":      # 21 MB a call: a ring
                        c = int(coeffs.reshape(-1)[-1]) & 0xFFFFFFFF
                        sets = ring_size(scale_x.numel() * 4, nbytes)
                        fns = [functools.partial(ops.gf_scale, x, c) for x in
                               [scale_x] + [pages(scale_x.shape)
                                            for _ in range(sets - 1)]]
                    library = LIBRARY.get(name)
                    lib_dev_ms = None
                    if library is None:
                        dev_ms = device_ms(fns)
                    else:                       # in turns: k, lib, lib, k
                        dev_ms, lib_dev_ms = turns(fns, [
                            functools.partial(library, old, new)])
                        check_device_ms(f"{name} library", lib_dev_ms, bound)
                    del fns
                    check_device_ms(name, dev_ms, bound)
                    lookups = TABLE_LOOKUPS.get(name, 0) * planes * words
                    timing[name] = dict(
                        shape=list(scale_x.shape if name == "gf_scale"
                                   else shape),
                        r=r if name in WITH_R else None, bytes=nbytes,
                        int_ops=ops_n, max_abs_err=err,
                        clmul_ops_ms=algo_n / INT32_OPS_PER_S * 1e3,
                        table_lds_ms=(lookups / LDS_LANES_PER_S * 1e3
                                      if lookups else None),
                        kernel_ms=cuda_ms(kernel), device_ms=dev_ms,
                        plain_ms=cuda_ms(plain, runs=5),
                        library_ms=(None if library is None else
                                    cuda_ms(lambda: library(old, new))),
                        library_device_ms=lib_dev_ms,
                        bound_bytes_ms=bound_b, bound_ops_ms=bound_o,
                        bound_ms=bound,
                        bound_by="bytes" if bound_b >= bound_o
                        else "operations")
            del calls, coeffs
        del old, new, stored, scale_x
        torch.cuda.empty_cache()
        emit(phase="kernels_vs_plain", shape=list(shape), r=list(rs),
             equal=True)
    xor_edges(pages)
    weight_edges(pages, dev)
    run_edges(pages, dev)
    commit_edges(pages, dev)
    at_flush_shape(pages, dev)
    at_patch_shape(pages, dev)
    return timing


def xor_edges(pages):
    """The XOR kernel on what pages never give it: 1-D runs whose length is
    not a multiple of 4 (its scalar tail), slices that start off a 16-byte
    boundary (its scalar path)."""
    from repro_torch.kernels import ops
    a, b = pages((8195,)), pages((8195,))
    for x, y in ((a[:1001], b[:1001]), (a[:7], b[:7]), (a[1:4097], b[2:4098]),
                 (a[3:8195], b[:8192]), (a[1:], b[:-1])):
        for fn in (ops.xor_delta, ops.xor_accum):
            got = fn(x, y)
            torch.cuda.synchronize()
            check(torch.equal(got, x ^ y), f"{fn.__name__} at {x.numel()} "
                  f"words, offsets {x.storage_offset()}/{y.storage_offset()}"
                  ": kernel != plain")
    emit(phase="xor_edges", equal=True)


def weight_edge_cases():
    """(r, lead, m) of the weight_words edge checks: r = 1 (gf_scale) to 4
    (sdelta_stack); leads 1, 3 and G; m from one uint4 to a block's least
    share of words ± 4; and one main-path row (2600 pages) at lead 1."""
    from repro_torch.kernels.gf_parity import SHARE_WORDS
    ms = (4, 1020, SHARE_WORDS - 4, SHARE_WORDS, SHARE_WORDS + 4)
    return ([(r, lead, m) for r in (1, 2, 3, 4) for lead in (1, 3, G)
             for m in ms] + [(r, 1, PAGES * BW) for r in (1, 2, 3, 4)])


def weight_case(pages, dev, r, lead, m):
    """One edge case's [(kernel call, plain call)]: at r >= 2 sdelta_stack
    with a coefficient table holding 0 (rank 0, plane 1) and 1 (the last
    rank's last plane); at r = 1 gf_scale by 0, 1 and a rank coefficient."""
    from repro_torch.kernels import gf_parity as gfk
    from repro_torch.kernels import ops
    x = pages((lead, m))
    if r == 1:
        c_big = int(coeff_table((1,), 4, "cpu")[0, -1]) & 0xFFFFFFFF
        return [(functools.partial(ops.gf_scale, x, c),
                 functools.partial(gfk.gf_scale_plain, x, c))
                for c in (0, 1, c_big)]
    coeffs = coeff_table((lead,), r, dev).clone()
    coeffs[0, 1] = 0
    coeffs[-1, -1] = 1
    return [(functools.partial(ops.syndrome_scale, x, coeffs),
             functools.partial(gfk.sdelta_stack_plain, x, coeffs))]


def weight_edges(pages, dev):
    """weight_words at every edge case, byte-equal to its plain version."""
    cases = weight_edge_cases()
    for r, lead, m in cases:
        for kernel, plain in weight_case(pages, dev, r, lead, m):
            got = kernel()
            torch.cuda.synchronize()
            check(torch.equal(got, plain()), f"weight_words at r = {r}, "
                  f"lead {lead}, m {m}: kernel != plain")
    emit(phase="weight_edges", cases=len(cases), equal=True)


def run_edge_cases():
    """(r, lead, n, bw) of the page-run edge checks: r = 2..4 (the
    syndrome sweeps; fletcher_pages takes none, so checked at r = 2 only);
    leads 1, 3 and G; n pages a rank around the K a CTA takes (1, K - 1,
    K, K + 1), the patch's 16 and a main-path rank's 2600; pages of one
    uint4 and of 1024 words."""
    from repro_torch.kernels.fletcher import RUN_PAGES as K
    ns = sorted({1, K - 1, K, K + 1, 16, PAGES})
    return [(r, lead, n, bw) for r in (2, 3, 4) for lead in (1, 3, G)
            for n in ns for bw in (4, BW)]


def run_case(pages, dev, r, lead, n, bw):
    """One edge case's [(entry point, kernel call, plain call)]: the five
    syndrome_pages entry points at r, with a coefficient table holding 0
    (rank 0, plane 1) and 1 (the last rank's last plane), and `stored`
    corrupted on every third page; at r = 2 also both fletcher_pages
    entry points."""
    from repro_torch.kernels.fletcher import fletcher_pages_plain
    old, new = pages((lead, n, bw)), pages((lead, n, bw))
    stored = fletcher_pages_plain(old)
    stored[:, ::3, 0] ^= 1
    coeffs = coeff_table((lead,), r, dev).clone()
    coeffs[0, 1] = 0
    coeffs[-1, -1] = 1
    calls = entry_calls(old, new, stored, coeffs, new)
    names = SYNDROME + (FLETCHER if r == 2 else ())
    return [(name, *calls[name]) for name in names]


def run_edges(pages, dev):
    """syndrome_pages (`syndrome_edges`) and fletcher_pages
    (`fletcher_edges`) at every page-run edge case, byte-equal to their
    plain versions."""
    cases = run_edge_cases()
    checked = collections.Counter()
    for r, lead, n, bw in cases:
        for name, kernel, plain in run_case(pages, dev, r, lead, n, bw):
            got = kernel()
            torch.cuda.synchronize()
            err = max_abs_err(got, plain())
            check(err == 0, f"{name} at r = {r}, lead {lead}, n {n}, bw "
                  f"{bw}: kernel != plain (err {err})")
            checked[name in FLETCHER] += 1
        torch.cuda.empty_cache()
    emit(phase="syndrome_edges", cases=checked[False], equal=True)
    emit(phase="fletcher_edges", cases=checked[True], equal=True)


def commit_edge_cases():
    """(lead, n, bw) of the commit_pages edge checks: the page-run edge
    cases' leads (1, 3, G), pages around the K a CTA takes (1, K - 1, K,
    K + 1), 16 and 2600, and widths (4, 1024)."""
    return sorted({(lead, n, bw) for _, lead, n, bw in run_edge_cases()})


def commit_case(pages, dev, lead, n, bw):
    """One edge case's [(entry point, kernel call, plain call)]: the eight
    commit_pages entry points, `stored` corrupted on every third page, and
    fused_accum_commit_tb with the ranks cut into TENANTS tenants where
    they divide (else one)."""
    from repro_torch.kernels import commit_fused as cf
    from repro_torch.kernels import ops
    from repro_torch.kernels.fletcher import fletcher_pages_plain
    old, new = pages((lead, n, bw)), pages((lead, n, bw))
    stored = fletcher_pages_plain(old)
    stored[:, ::3, 0] ^= 1
    # the commit entry points take no coefficients
    ones = torch.ones(lead, 2, dtype=torch.int32, device=dev)
    calls = entry_calls(old, new, stored, ones, new)
    t = TENANTS if lead % TENANTS == 0 else 1
    acc, o, nw = (x.reshape(t, lead // t, n, bw)
                  for x in (torch.bitwise_not(old), old, new))
    return [(name, *calls[name]) for name in COMMIT] + [(
        "fused_accum_commit_tb",
        functools.partial(ops.fused_accum_commit_tb, acc, o, nw),
        lambda: (lambda a, tm, om, _: (a, om, tm))(
            *cf.commit_pages_plain(o, nw, acc=acc)))]


def commit_edges(pages, dev):
    """commit_pages' nine entry points at every commit edge case,
    byte-equal to their plain versions."""
    cases = commit_edge_cases()
    for lead, n, bw in cases:
        for name, kernel, plain in commit_case(pages, dev, lead, n, bw):
            got = kernel()
            torch.cuda.synchronize()
            err = max_abs_err(got, plain())
            check(err == 0, f"{name} at lead {lead}, n {n}, bw {bw}: kernel "
                  f"!= plain (err {err})")
        torch.cuda.empty_cache()
    emit(phase="commit_edges", cases=len(cases), entry_points=len(COMMIT) + 1,
         equal=True)


def at_flush_shape(pages, dev):
    """xor_delta and sdelta_stack (r = 3) at the wp path's flush shape —
    G ranks x 34 pages, 41.8 MB for the XOR — where a call's work is tens of
    µs and the host's enqueue is of the same order: one launch timed with
    its enqueue (kernel_ms), the device time of back-to-back launches over
    a ring of input sets (device_ms), and the host µs a call of the entry
    point and of torch.bitwise_xor at one page."""
    from repro_torch.kernels import gf_parity as gfk
    from repro_torch.kernels import ops
    shape = (G, 1, FLUSH_SLOTS, BW)
    words = G * FLUSH_SLOTS * BW
    nbytes = 3 * words * 4
    sets = [(pages(shape), pages(shape))
            for _ in range(ring_size(2 * words * 4, nbytes))]
    old, new = sets[0]
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    one = pages((1, BW)), pages((1, BW))
    dev_ms, lib_dev_ms = turns(
        [functools.partial(ops.xor_delta, a, b) for a, b in sets],
        [functools.partial(torch.bitwise_xor, a, b) for a, b in sets])
    row = dict(
        phase="xor_delta_at_flush_shape", shape=list(shape), bytes=nbytes,
        ring=len(sets), kernel_ms=cuda_ms(lambda: ops.xor_delta(old, new)),
        device_ms=dev_ms, plain_ms=cuda_ms(lambda: old ^ new, runs=5),
        library_ms=cuda_ms(lambda: torch.bitwise_xor(old, new)),
        library_device_ms=lib_dev_ms,
        host_us=host_us(lambda: ops.xor_delta(*one)),
        library_host_us=host_us(lambda: torch.bitwise_xor(*one)),
        bound_ms=bound, bound_by="bytes")
    emit(**row)
    check_device_ms("xor_delta at the flush shape", row["device_ms"], bound)
    check_device_ms("torch.bitwise_xor at the flush shape",
                    row["library_device_ms"], bound)
    del sets, old, new

    xs = [pages((G, 1, FLUSH_SLOTS * BW))]
    coeffs = coeff_table((G, 1), R, dev)
    nbytes = words * 4 * (1 + R) + G * R * 4
    xs += [pages(xs[0].shape)
           for _ in range(ring_size(words * 4, nbytes) - 1)]
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    row = dict(
        phase="sdelta_stack_at_flush_shape", shape=list(xs[0].shape), r=R,
        bytes=nbytes, ring=len(xs),
        kernel_ms=cuda_ms(lambda: ops.syndrome_scale(xs[0], coeffs)),
        device_ms=device_ms([functools.partial(ops.syndrome_scale, x, coeffs)
                             for x in xs]),
        plain_ms=cuda_ms(lambda: gfk.sdelta_stack_plain(xs[0], coeffs),
                         runs=5),
        library_ms=None, bound_ms=bound, bound_by="bytes")
    emit(**row)
    check_device_ms("sdelta_stack at the flush shape", row["device_ms"], bound)


def at_patch_shape(pages, dev):
    """The row-10 syndrome sweeps (fused_commit_s, fused_verify_commit_s,
    fused_commit_old_terms_s) at the 16-page patch's shape, G ranks x 16
    pages at r = 3, as the r3 path's phases D and E run them, and the
    rows 3-4 sweeps (fused_commit, fused_verify_commit,
    fused_commit_old_terms) at the same shape, as the r1 path's phases d
    and e run them: one launch with its enqueue (kernel_ms) and the device
    time of back-to-back launches over an L2-cold ring of input sets
    (device_ms)."""
    from repro_torch.kernels import commit_fused as cf
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import gf_parity as gfk
    from repro_torch.kernels import ops
    from repro_torch.kernels.fletcher import fletcher_pages_plain
    shape = (G, 1, 16, BW)
    n_pages = G * 16
    coeffs = coeff_table((G, 1), R, dev)
    sets = []
    page_bytes = n_pages * BW * 4
    for _ in range(ring_size(2 * page_bytes, 5 * page_bytes)):
        old, new = pages(shape), pages(shape)
        sets.append((old, new, fletcher_pages_plain(old)))
    calls = {
        "fused_commit_s": (lambda o, n, s: ops.fused_commit_s(o, n, coeffs),
                           lambda o, n, s: gfk.syndrome_pages_plain(
                               o, n, coeffs)),
        "fused_verify_commit_s": (
            lambda o, n, s: ops.fused_verify_commit_s(o, n, s, coeffs),
            lambda o, n, s: gfk.syndrome_pages_plain(o, n, coeffs, s)),
        "fused_commit_old_terms_s": (
            lambda o, n, s: ops.fused_commit_old_terms_s(o, n, coeffs),
            lambda o, n, s: gfk.syndrome_pages_plain(
                o, n, coeffs, torch.zeros_like(s))),
        "fused_commit": (lambda o, n, s: ops.fused_commit(o, n),
                         lambda o, n, s: cf.commit_pages_plain(o, n)),
        "fused_verify_commit": (
            lambda o, n, s: ops.fused_verify_commit(o, n, s),
            lambda o, n, s: cf.commit_pages_plain(o, n, s)),
        "fused_commit_old_terms": (
            lambda o, n, s: ops.fused_commit_old_terms(o, n),
            lambda o, n, s: cf.commit_pages_plain(o, n, old_terms=True))}
    for name, (kernel, plain) in calls.items():
        nbytes = kcost.io_bytes(name, n_pages * BW, n_pages, G, R)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        syndrome = name.endswith("_s")
        row = dict(
            phase=("syndrome" if syndrome else "commit") + "_at_patch_shape",
            name=name, shape=list(shape), r=R if syndrome else 1,
            bytes=nbytes, ring=len(sets),
            kernel_ms=cuda_ms(functools.partial(kernel, *sets[0])),
            device_ms=device_ms([functools.partial(kernel, *st)
                                 for st in sets]),
            plain_ms=cuda_ms(functools.partial(plain, *sets[0]), runs=5),
            library_ms=None, bound_ms=bound, bound_by="bytes")
        emit(**row)
        check_device_ms(f"{name} at the patch shape", row["device_ms"], bound)
    del sets


# -- 3.-5. the main paths ----------------------------------------------------

def invariants(pool, tag):
    """Recompute the protection apart from the engine and compare: each
    syndrome plane k is the XOR over ranks i of g^(k·i)·row_i, folded rank
    by rank with the plain GF multiply (no code shared with the engine's
    folds or kernels); rank i holds segment i of every plane."""
    from repro_torch.core import checksum, gf, layout
    from repro_torch.kernels.fletcher import fletcher_pages_plain
    prot, lo, mode = pool.prot, pool.protector.layout, pool.mode
    rows = layout.flatten_row(lo, prot.state)
    check(torch.equal(rows, prot.row), f"{tag}: row cache != flatten(state)")
    if mode.has_parity:
        dd = pool.mesh.data_dim
        for k in range(pool.redundancy):
            fold = functools.reduce(torch.bitwise_xor, (
                gf.mul_const(row_i, gf.pow_g_int(k * i)) if k else row_i
                for i, row_i in enumerate(rows.unbind(dd))))
            segs = fold.reshape(*fold.shape[:-1], pool.protector.group_size,
                                -1).movedim(-2, dd)
            check(torch.equal(prot.synd[..., k, :], segs),
                  f"{tag}: syndrome plane {k} != weighted fold of rows")
    bw = lo.block_words
    # rank by rank: the plain sweep's int64 temporaries are 4x its input
    terms = torch.stack([fletcher_pages_plain(r) for r in rows.reshape(
        *rows.shape[:-1], -1, bw).unbind(0)])
    if mode.has_cksums:
        check(torch.equal(prot.cksums, terms), f"{tag}: cksums != terms")
    check(torch.equal(prot.digest, checksum.combine(terms, bw)),
          f"{tag}: digest != combine(terms)")


def zone_state(dev, group=None):
    """The main path's zone: the quickstart's three kinds of leaf at
    G = 100 ranks of 2600 pages, random from SEED (the state global; the
    mesh split over `group`'s processes if one is given)."""
    from repro_torch import P, ZoneMesh
    mesh = ZoneMesh((G, 1), ("data", "model"), group=group)
    specs = {"w_fsdp": P("data", "model"), "w_tp": P(None, "model"),
             "scale": P()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    state = {
        "w_fsdp": torch.randn(G * 2560, BW, device=dev, generator=gen),
        "w_tp": torch.randn(64, BW, device=dev, generator=gen).to(
            torch.bfloat16),
        "scale": torch.ones((), device=dev),
    }
    return mesh, specs, state


def bumped(st, words=None):
    """A new state: every leaf changed (bulk), or w_fsdp + 1 on the given
    slice (or tuple of slices) of each rank's local words only (patch)."""
    w = st["w_fsdp"].clone()
    if words is None:
        w += 1.0
        return {"w_fsdp": w, "w_tp": (st["w_tp"] * 2).to(torch.bfloat16),
                "scale": st["scale"] + 1}
    for run in words if isinstance(words, tuple) else (words,):
        w.view(G, -1)[:, run] += 1.0      # rank r's shard is row block r
    return {"w_fsdp": w, "w_tp": st["w_tp"], "scale": st["scale"]}


def patch_pages(lo, first=100, n=16):
    """n whole pages of w_fsdp, pages first..first+n-1 of every rank's row
    (the leaf starts at its slot's offset, after the sorted-first
    `scale`): (slice of each rank's local w_fsdp words, dirty page list)."""
    from repro_torch.core import layout
    slot = lo.slots[layout.leaves_for_pages(lo, [first])[0]]
    start = first * BW - slot.offset
    dirty = [int(p) for p in layout.range_pages(lo, slot.offset + start,
                                                 n * BW)]
    check(dirty == list(range(first, first + n)), f"dirty pages {dirty}")
    return slice(start, start + n * BW), dirty


class PathRun:
    """One main path's run: its launch counts from zero, its phase lines
    (host ms around the phase, synchronized, then the invariants, and the
    phase's peak device memory), and the path's peak."""

    def __init__(self, dev, tag):
        from repro_torch.kernels import _build
        self.build, self.dev, self.tag = _build, dev, tag
        self.peak = self.peak_reserved = 0
        # an earlier path's runtimes and their step clocks refer to each
        # other: only the cycle collector lets go of their tensors
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launches()

    def phase(self, tag, fn, pool=None, inv=None):
        """Time `fn`, then check the invariants (`inv`, by default the
        synchronous ones) of `pool` — or of the pool `fn` returns.  Returns
        (fn's result, the phase's launches)."""
        before = dict(self.build.LAUNCHES)
        torch.cuda.synchronize()
        self.peaks()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(self.dev)
        launched = {k: v - before.get(k, 0)
                    for k, v in self.build.LAUNCHES.items()
                    if v - before.get(k, 0)}
        (inv or invariants)(out if pool is None else pool, tag)
        emit(path=self.tag, phase=tag, ms=ms, launches=launched,
             max_memory_allocated=peak,
             max_memory_reserved=torch.cuda.max_memory_reserved(self.dev))
        return out, launched

    def peaks(self):
        """Fold the peaks since the last reset into the path's, and reset
        them."""
        self.peak = max(self.peak, torch.cuda.max_memory_allocated(self.dev))
        self.peak_reserved = max(self.peak_reserved,
                                 torch.cuda.max_memory_reserved(self.dev))
        torch.cuda.reset_peak_memory_stats(self.dev)

    def aside(self, fn):
        """Run `fn` (a comparison, not the path) with its launches
        uncounted."""
        saved = dict(self.build.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        self.build.LAUNCHES.clear()
        self.build.LAUNCHES.update(saved)
        return out

    def timed_aside(self, tag, fn):
        """`aside`, timed as a phase is (host ms ending in a synchronize):
        a comparison run whose wall is reported beside the path's."""
        torch.cuda.synchronize()
        self.peaks()
        t0 = time.perf_counter()
        out = self.aside(fn)
        emit(path=self.tag, phase=tag, ms=(time.perf_counter() - t0) * 1e3,
             launches="not counted (a comparison)",
             max_memory_allocated=torch.cuda.max_memory_allocated(self.dev),
             max_memory_reserved=torch.cuda.max_memory_reserved(self.dev))
        return out

    def end(self, must_launch):
        """Check the path's launches; print them and its peak memory."""
        counts = dict(self.build.LAUNCHES)
        missing = [k for k in must_launch if not counts.get(k)]
        check(not missing, f"{self.tag}: entry points never launched on "
              f"the path: {missing}")
        self.peaks()
        emit(path=self.tag, phase="memory", max_memory_allocated=self.peak,
             max_memory_reserved=self.peak_reserved, launches=counts)
        return counts


def open_pool(cur, specs, mesh, dev, pool_kw=None, **cfg):
    from repro_torch import Pool, ProtectConfig
    return Pool.open(cur, specs, mesh=mesh, device=dev,
                     config=ProtectConfig(**cfg), **(pool_kw or {}))


def main_path(dev):
    """The r = 1 main path (phases a-h)."""
    from repro_torch import Fault
    from repro_torch.runtime import failure

    mesh, specs, state = zone_state(dev)
    run = PathRun(dev, "r1")
    pool, _ = run.phase("a_open_mlpc", lambda: open_pool(
        state, specs, mesh, dev, mode="mlpc"))
    rep = pool.overhead_report()
    lo = pool.protector.layout
    check(lo.row_words == PAGES * BW and lo.n_blocks == PAGES,
          f"layout: {lo.row_words} words a rank")
    check(abs(rep["parity_fraction"] - 0.01) < 1e-3, f"overhead {rep}")
    emit(phase="a_layout", row_words=lo.row_words, pages_per_rank=PAGES,
         zone_row_bytes=lo.row_words * 4 * G, ranks=G,
         parity_fraction=rep["parity_fraction"])

    cur = state

    def bulk_verify():
        new = bumped(cur)
        with pool.transaction(data_cursor=1) as tx:
            tx.stage(new, verify_old=True)
        check(tx.ok, "bulk verified transaction did not commit")
        return new
    cur, l_b = run.phase("b_bulk_verify", bulk_verify, pool)
    check(l_b.get("fused_verify_commit_stream") == 1, f"b launches {l_b}")

    def bulk():
        new = bumped(cur)
        check(bool(pool.commit(new, data_cursor=2)), "bulk commit failed")
        return new
    cur, l_c = run.phase("c_bulk", bulk, pool)
    check(l_c.get("fletcher_stream") == 1, f"c launches {l_c}")

    patch, dirty = patch_pages(lo)

    def patches():
        new = bumped(cur, words=patch)
        with pool.transaction(data_cursor=3) as tx:
            tx.stage(new, dirty_pages=dirty, verify_old=True)
        check(tx.ok, "verified patch did not commit")
        newer = bumped(new, words=patch)
        with pool.transaction(data_cursor=4) as tx:
            tx.stage(newer, dirty_pages=dirty)
        check(tx.ok, "patch did not commit")
        return newer
    cur, l_d = run.phase("d_patch_16_pages", patches, pool)
    check(l_d.get("fused_verify_commit") == 1 and
          l_d.get("fused_commit") == 1, f"d launches {l_d}")
    check(pool.step == 4, f"step {pool.step}")

    def mlp_patch():
        mlp = open_pool(cur, specs, mesh, dev, mode="mlp")
        check(bool(mlp.commit(bumped(cur, words=patch), dirty_pages=dirty)),
              "mlp patch failed")
        return mlp
    mlp, l_e = run.phase("e_mlp_patch", mlp_patch)
    check(l_e.get("fused_commit_old_terms") == 1, f"e launches {l_e}")
    del mlp
    torch.cuda.empty_cache()

    before_loss = pool.prot.row.clone()

    def rank_loss():
        pool.prot, event = failure.inject_rank_loss(pool.protector,
                                                    pool.prot, LOST)
        check(not torch.equal(pool.prot.state["w_fsdp"][LOST],
                              cur["w_fsdp"].view(G, 1, 2560, BW)[LOST]),
              "rank loss did not garble the lost rank")
        rep = pool.recover(Fault.from_event(event))
        check(rep.verified and rep.reverified, f"recovery {rep}")
    run.phase("f_rank_loss_recover", rank_loss, pool)
    check(torch.equal(pool.prot.row, before_loss), "f: rows differ")

    def scribble():
        pool.prot, _ = failure.inject_scribble(
            pool.protector, pool.prot, rank=SCRIBBLED, word_offsets=[12345])
        report = pool.scrub()
        check(report.bad_locations == [(SCRIBBLED, 12)], f"scrub {report}")
        check(report.repaired and report.repair_ok, f"repair {report}")
    run.phase("g_scribble_scrub_repair", scribble, pool)
    check(torch.equal(pool.prot.row, before_loss), "g: rows differ")
    del before_loss

    def canary_abort():
        # the redo record of an aborted commit is still written, unmarked,
        # as in the reference; the commit marks must not move
        prot = pool.prot
        fields = (prot.row, prot.synd, prot.cksums, prot.digest,
                  prot.step, prot.log.mark, prot.state["w_fsdp"])
        zeros = {k: torch.zeros_like(v) for k, v in cur.items()}
        with pool.transaction() as tx:
            tx.watch(failure.smashed_canary_buffer(4096, device=dev))
            tx.stage(zeros)
        check(tx.aborted and not tx.ok, "canary did not abort")
        now = pool.prot
        for a, b in zip(fields, (now.row, now.synd, now.cksums, now.digest,
                                 now.step, now.log.mark,
                                 now.state["w_fsdp"])):
            check(torch.equal(a, b), "an abort changed protected state")
    run.phase("h_canary_abort", canary_abort, pool)
    return run.end(PATH_R1)


def main_path_r3(dev):
    """The r = 3 main path (phases A-H) on the same zone."""
    from repro_torch import Fault
    from repro_torch.runtime import failure

    mesh, specs, cur = zone_state(dev)
    run = PathRun(dev, "r3")
    pool, l_a = run.phase("A_open_mlpc_r3", lambda: open_pool(
        cur, specs, mesh, dev, mode="mlpc", redundancy=R))
    check(pool.redundancy == R and pool.prot.synd.shape[-2] == R,
          f"stack {tuple(pool.prot.synd.shape)}")
    check(l_a.get("sdelta_stack") == 1, f"A launches {l_a}")
    emit(phase="A_layout", syndrome_fraction=pool.overhead_report()[
        "syndrome_fraction"], stack_shape=list(pool.prot.synd.shape))

    def bulk_verify():
        new = bumped(cur)
        with pool.transaction(data_cursor=1) as tx:
            tx.stage(new, verify_old=True)
        check(tx.ok, "bulk verified transaction did not commit")
        return new
    cur, l_b = run.phase("B_bulk_verify", bulk_verify, pool)
    check(l_b.get("fused_verify_commit_s_stream") == 1, f"B launches {l_b}")

    def bulk():
        new = bumped(cur)
        check(bool(pool.commit(new, data_cursor=2)), "bulk commit failed")
        return new
    cur, l_c = run.phase("C_bulk", bulk, pool)
    check(l_c.get("fletcher_stream") == 1 and l_c.get("sdelta_stack") == 1,
          f"C launches {l_c}")

    patch, dirty = patch_pages(pool.protector.layout)

    def patches():
        new = bumped(cur, words=patch)
        with pool.transaction(data_cursor=3) as tx:
            tx.stage(new, dirty_pages=dirty, verify_old=True)
        check(tx.ok, "verified patch did not commit")
        newer = bumped(new, words=patch)
        with pool.transaction(data_cursor=4) as tx:
            tx.stage(newer, dirty_pages=dirty)
        check(tx.ok, "patch did not commit")
        return newer
    cur, l_d = run.phase("D_patch_16_pages", patches, pool)
    check(l_d.get("fused_verify_commit_s") == 1 and
          l_d.get("fused_commit_s") == 1, f"D launches {l_d}")

    def mlp_patch():
        mlp = open_pool(cur, specs, mesh, dev, mode="mlp", redundancy=R)
        check(bool(mlp.commit(bumped(cur, words=patch), dirty_pages=dirty)),
              "mlp patch failed")
        return mlp
    mlp, l_e = run.phase("E_mlp_r3_patch", mlp_patch)
    check(l_e.get("fused_commit_old_terms_s") == 1, f"E launches {l_e}")
    del mlp
    torch.cuda.empty_cache()

    def precheck():
        report = pool.precheck()
        check(report.local_only and not report.suspect and
              report.synd_ok == [True] * R, f"precheck {report}")
    _, l_f = run.phase("F_precheck", precheck, pool)
    check(l_f.get("sdelta_stack") == 1, f"F launches {l_f}")

    before_loss = pool.prot.row.clone()

    def multi_loss():
        pool.prot, event = failure.inject_multi_rank_loss(
            pool.protector, pool.prot, MULTI_LOST)
        for rank in MULTI_LOST:
            check(not torch.equal(pool.prot.state["w_fsdp"][rank],
                                  cur["w_fsdp"].view(G, 1, 2560, BW)[rank]),
                  f"multi loss did not garble rank {rank}")
        rep = pool.recover(Fault.from_event(event))
        check(rep.verified and rep.reverified and rep.synd_ok == [True] * R
              and rep.lost_ranks == list(MULTI_LOST), f"recovery {rep}")
    _, l_g = run.phase("G_multi_loss_recover", multi_loss, pool)
    check(l_g.get("gf_scale", 0) >= 1, f"G launches {l_g}")
    check(torch.equal(pool.prot.row, before_loss), "G: rows differ")
    del before_loss

    def scrub():
        report = pool.scrub()
        check(not report.suspect and report.synd_ok == [True] * R,
              f"scrub {report}")
    run.phase("H_scrub", scrub, pool)
    return run.end(PATH_R3)


# -- 4a. the multi-process zone ------------------------------------------------

ZP_WORLD = 4                          # worker processes on the one card
ZP_RUNS = (100, 780, 1560, 2340)      # 4-page runs, one owner on each process
ZP_LOST = 57                          # process 2
ZP_SCRIBBLED = 88                     # process 3
ZP_MULTI_LOST = (7, 42, 93)           # processes 0, 1, 3
ZP_FLIPPED = 20                       # process 0: the pre-check's word
ZP_SMASHED = 1                        # the process whose canary is smashed
ZP_TIMEOUT_S = 600                    # the workers' spawn, at most
PATH_ZP = ("fletcher_blocks", "fletcher_stream", "fused_commit",
           "fused_verify_commit", "fused_verify_commit_stream",
           "sdelta_stack", "gf_scale")


def zp_patch(lo):
    """The d phase's 16 pages of w_fsdp, four runs of four whose parity
    owners are one on each process (ranks 3, 30, 60 and 90): (the slices
    of each rank's local w_fsdp words, the dirty page list)."""
    from repro_torch.core import layout
    runs = [patch_pages(lo, first, 4) for first in ZP_RUNS]
    dirty = [p for _, pages in runs for p in pages]
    pps, block = lo.n_blocks // G, G // ZP_WORLD
    check(len(layout.leaves_for_pages(lo, dirty)) == 1 and
          sorted({p // pps // block for p in dirty}) ==
          list(range(ZP_WORLD)), f"zp dirty pages {dirty}")
    return tuple(run for run, _ in runs), dirty


def zp_phases(dev, group, smashed):
    """zp's phases on this process's block (the whole zone without a
    group): yields (phase, pool) after each; `smashed`: whether this
    process's canary is the smashed one."""
    from repro_torch import Fault
    from repro_torch.runtime import failure

    mesh, specs, cur = zone_state(dev, group)
    pool = open_pool(cur, specs, mesh, dev, mode="mlpc")
    yield "a_open", pool
    new = bumped(cur)
    with pool.transaction(data_cursor=1) as tx:
        tx.stage(new, verify_old=True)
    check(tx.ok, "zp b: the verified bulk transaction did not commit")
    cur = new
    yield "b_bulk_verify", pool
    new = bumped(cur)
    check(bool(pool.commit(new, data_cursor=2)), "zp c: bulk failed")
    cur = new
    yield "c_bulk", pool
    slices, dirty = zp_patch(pool.protector.layout)
    new = bumped(cur, words=slices)
    with pool.transaction(data_cursor=3) as tx:
        tx.stage(new, dirty_pages=dirty, verify_old=True)
    check(tx.ok, "zp d: the verified patch did not commit")
    cur = bumped(new, words=slices)
    check(bool(pool.commit(cur, dirty_pages=dirty, data_cursor=4)),
          "zp d: the patch failed")
    yield "d_patch_16_pages", pool
    report = pool.scrub()
    check(not report.suspect and report.synd_ok == [True], f"zp e {report}")
    yield "e_scrub", pool
    pool.inject(lambda p, prot: failure.inject_rank_loss(p, prot, ZP_LOST))
    rep = pool.recover(Fault.rank_loss(ZP_LOST))
    check(rep.verified and rep.reverified, f"zp f {rep}")
    yield "f_rank_loss_recover", pool
    pool.inject(lambda p, prot: failure.inject_scribble(
        p, prot, ZP_SCRIBBLED, [12345]))
    report = pool.scrub()
    check(report.bad_locations == [(ZP_SCRIBBLED, 12)] and report.repaired
          and report.repair_ok, f"zp g {report}")
    yield "g_scribble_repair", pool
    prot = pool.prot
    kept = (prot.row, prot.synd, prot.cksums, prot.digest, prot.step,
            prot.log.mark)
    with pool.transaction() as tx:
        if smashed:
            tx.watch(failure.smashed_canary_buffer(4096, device=dev))
        tx.stage({k: torch.zeros_like(v) for k, v in cur.items()})
    check(tx.aborted and not tx.ok, "zp h: the canary did not abort")
    now = pool.prot
    check(all(torch.equal(a, b) for a, b in zip(kept, (
        now.row, now.synd, now.cksums, now.digest, now.step, now.log.mark))),
          "zp h: an abort changed protected state")
    yield "h_canary_abort", pool
    del pool, prot, kept, now
    torch.cuda.empty_cache()

    pool = open_pool(cur, specs, mesh, dev, mode="mlpc", redundancy=R)
    yield "i_open_r3", pool
    new = bumped(cur)
    check(bool(pool.commit(new, data_cursor=5)), "zp j: bulk failed")
    cur = new
    yield "j_bulk", pool
    pool.inject(lambda p, prot: failure.inject_multi_rank_loss(
        p, prot, ZP_MULTI_LOST))
    rep = pool.recover(Fault.multi_loss(*ZP_MULTI_LOST))
    check(rep.verified and rep.reverified and rep.synd_ok == [True] * R,
          f"zp k {rep}")
    yield "k_multi_loss_recover", pool
    pool.inject(lambda p, prot: failure.inject_scribble(
        p, prot, ZP_FLIPPED, [777]))
    report = pool.precheck()
    check(report.suspect and report.bad_count == 1, f"zp l {report}")
    rep = pool.recover(Fault.scribble(ZP_FLIPPED, [0]))
    check(rep.verified and rep.reverified, f"zp l {rep}")
    yield "l_precheck_flip", pool
    lost = tuple(sorted(ZP_MULTI_LOST + (ZP_LOST,)))
    try:
        pool.recover(Fault.multi_loss(*lost))
        refused = False
    except RuntimeError as err:
        refused = "syndrome budget exhausted" in str(err)
    check(refused, "zp m: a four-rank loss was not refused")
    yield "m_over_budget", pool


HASH_CHUNK = 1 << 26                  # bytes of a rank hashed by one thread
_PINNED: list = [None]                # the host staging of `host_bytes`


def host_bytes(t):
    """A tensor's bytes on the host as a flat uint8 numpy array.  A card
    tensor is copied into one page-locked buffer kept for the process (a
    pageable copy runs at a fraction of the link's rate); the array is a
    view of that buffer, valid until the next call."""
    t = t.contiguous().reshape(-1).view(torch.uint8)
    if not t.is_cuda:
        return t.numpy()
    buf = _PINNED[0]
    if buf is None or buf.numel() < t.numel():
        _PINNED[0] = buf = None
        buf = _PINNED[0] = torch.empty(t.numel(), dtype=torch.uint8,
                                       pin_memory=True)
    out = buf[:t.numel()]
    out.copy_(t)
    return out.numpy()


def zp_hashes(pool, group, state=True):
    """{field: {global rank: SHA-256 of its bytes}} of row, synd, cksums,
    digest, every state leaf (unless not `state`) and an open window's
    acc, live row and dirty mask; {"log": ..., "step": ...} whole, and a
    window's pending count, its size and its attempts since the flush.
    A dict of pools (a group's tenants) gives each pool's under its name."""
    if isinstance(pool, dict):
        return {f"{name}.{k}": v for name, p in pool.items()
                for k, v in zp_hashes(p, group, state).items()}
    import hashlib
    from concurrent.futures import ThreadPoolExecutor
    prot, dd = pool.prot, pool.mesh.data_dim
    off = pool.mesh.data_offset
    fields = {"row": prot.row, "synd": prot.synd, "cksums": prot.cksums,
              "digest": prot.digest}
    if state:
        fields.update({f"state.{k}": v for k, v in
                       utils_flat(prot.state).items()})
    est = pool._est
    if est is not None:
        fields.update({f"window.{k}": getattr(est, k)
                       for k in ("acc", "live", "dirty")})
    out = collections.defaultdict(dict)
    with ThreadPoolExecutor(8) as ex:      # hashlib lets go of the GIL
        for name, t in fields.items():
            if t is None:
                continue
            host = host_bytes(t.detach().movedim(dd, 0))
            host = host.reshape(t.shape[dd], -1)
            # a rank's hash: SHA-256 of its HASH_CHUNK pieces' SHA-256s,
            # so that one large rank spreads over the threads
            jobs = [(i, c) for i in range(host.shape[0])
                    for c in range(0, max(host.shape[1], 1), HASH_CHUNK)]
            sums = list(ex.map(lambda j: hashlib.sha256(
                host[j[0], j[1]:j[1] + HASH_CHUNK]).digest(), jobs))
            for i in range(host.shape[0]):
                out[name][off + i] = hashlib.sha256(b"".join(
                    h for (r, _), h in zip(jobs, sums) if r == i)).hexdigest()
    log = b"".join(getattr(prot.log, f.name).cpu().numpy().tobytes()
                   for f in dataclasses.fields(prot.log))
    out["log"] = hashlib.sha256(log).hexdigest()
    out["step"] = int(prot.step) & 0xFFFFFFFF
    if est is not None:
        out["window.pending"] = int(est.pending) & 0xFFFFFFFF
        out["window.cadence"] = (pool.engine.window, pool.engine._since)
    return dict(out)


def on_card(dev):
    return torch.device(dev).type == "cuda"


def sync(dev):
    if on_card(dev):
        torch.cuda.synchronize(dev)


def utils_flat(tree):
    """{dotted path: leaf} of a nested dict of tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in utils_flat(v).items()})
        else:
            out[k] = v
    return out


def zp_run(dev, group, smashed, phases=None):
    """Drive a split path's phases (zp's by default); each phase's line:
    wall ms (synchronized, from a barrier of the workers; the hashing
    after the clock), launches, the exchanges' staged and sent bytes and
    ms, the peak memory, the hashes, and what the phase reported (a
    phase yields (tag, pool) or (tag, pool, {key: value}); a pool may be
    a dict of pools; an extra `hash_state=False` leaves the state leaves
    out of that phase's hashes, the row standing for them, `hash=False`
    hashes nothing: a phase that only checks)."""
    from repro_torch.kernels import _build
    stats = group.stats if group is not None else {}
    card = on_card(dev)
    lines = []
    phases = (phases or zp_phases)(dev, group, smashed)
    while True:
        launched, ex = dict(_build.LAUNCHES), dict(stats)
        sync(dev)
        if card:
            torch.cuda.reset_peak_memory_stats(dev)
        if group is not None:
            group.barrier()       # no worker's clock waits on another's hashing
        t0 = time.perf_counter()
        step = next(phases, None)
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        if step is None:
            return lines
        tag, pool, extra = (*step, {})[:3]
        del step
        extra = dict(extra)
        state = extra.pop("hash_state", True)
        hashed = extra.pop("hash", True)
        lines.append(dict(
            phase=tag, ms=ms, extra=extra, launches={
                k: v - launched.get(k, 0) for k, v in _build.LAUNCHES.items()
                if v - launched.get(k, 0)},
            exchange={k: v - ex[k] for k, v in stats.items()},
            max_memory_allocated=(torch.cuda.max_memory_allocated(dev)
                                  if card else 0),
            max_memory_reserved=(torch.cuda.max_memory_reserved(dev)
                                 if card else 0),
            hashes=zp_hashes(pool, group, state) if hashed else {}))
        del pool


# constant overrides a CPU rehearsal of a split path hands its workers
# (spawned processes import this file afresh)
REHEARSAL: dict = {}
SPLIT_RUNS: dict = {}                 # tag: the one-process run's lines
SPLIT_WORKERS: dict = {}              # tag: each worker's lines


def zp_worker(group, phases=None, dev="cuda", overrides=None):
    """One worker of a split path on the card (zp's phases by default):
    its launches counted from zero."""
    from repro_torch.kernels import _build
    globals().update(overrides or {})
    dev = torch.device(dev, 0) if dev == "cuda" else torch.device(dev)
    if on_card(dev):
        torch.cuda.set_device(dev)
    _build.reset_launches()
    lines = zp_run(dev, group, group.rank == ZP_SMASHED, phases)
    return {"lines": lines, "launches": dict(_build.LAUNCHES),
            "peak": (torch.cuda.max_memory_reserved(dev) if on_card(dev)
                     else 0)}


def split_path(dev, tag, phases, must_launch, launches=None,
               world=ZP_WORLD, timeout=ZP_TIMEOUT_S):
    """A split path: the one-process run, then `world` workers (spawned
    with `timeout` seconds to finish), phase by phase byte-equal by
    per-rank hashes, and an extra whose key starts with "same_" equal to
    the one process's; `launches` ({phase: {entry point: count}}) is what
    each worker and the one process must launch in a phase.  Returns the
    workers' summed launches; their lines stay in `SPLIT_WORKERS[tag]`."""
    from repro_torch.dist import procs
    from repro_torch.kernels import _build
    card = on_card(dev)
    gc.collect()
    sync(dev)
    if card:
        torch.cuda.empty_cache()
    saved = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    one = zp_run(dev, None, True, phases)  # a comparison: launches uncounted
    one_wall = (time.perf_counter() - t0) * 1e3
    _build.LAUNCHES.clear()
    _build.LAUNCHES.update(saved)
    gc.collect()
    free = total = 0
    if card:
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(dev)
    emit(path=tag, phase="spawn", world=world, mem_free=free,
         mem_total=total, one_process_wall_ms=one_wall)
    t0 = time.perf_counter()
    SPLIT_RUNS[tag] = one
    workers = procs.spawn_zone(zp_worker, world, phases, dev.type,
                               REHEARSAL, timeout=timeout)
    SPLIT_WORKERS[tag] = [w["lines"] for w in workers]
    wall = (time.perf_counter() - t0) * 1e3
    counts = collections.Counter()
    for w in workers:
        counts.update(w["launches"])
    for i, want in enumerate(one):
        got = [w["lines"][i] for w in workers]
        phase = want["phase"]
        check(all(g["phase"] == phase for g in got), f"{tag} phases {phase}")
        for k, v in want["extra"].items():
            if k.startswith("same_"):
                check(all(g["extra"][k] == v for g in got),
                      f"{tag} {phase}: {k} {[g['extra'][k] for g in got]}"
                      f", one process {v}")
        for name, by_rank in want["hashes"].items():
            # a spare (a worker outside the phase's mesh) hashed no pool
            if not isinstance(by_rank, dict):
                have = [g for g in got if name in g["hashes"]]
                check(have and all(g["hashes"][name] == by_rank
                                   for g in have),
                      f"{tag} {phase}: {name} differs from one process")
                continue
            merged = {}
            for g in got:
                merged.update(g["hashes"].get(name, {}))
            check(merged == by_rank, f"{tag} {phase}: {name} differs from "
                  "one process at ranks " + str(sorted(
                      r for r in by_rank if merged.get(r) != by_rank[r])))
        want_l = (launches or {}).get(phase)
        if want_l is not None:
            check(all(x["launches"] == want_l for x in got + [want]),
                  f"{tag} {phase}: launches {[x['launches'] for x in got]}"
                  f", one process {want['launches']}, want {want_l}")
        launched = collections.Counter()
        for g in got:
            launched.update(g["launches"])
        emit(path=tag, phase=phase, ms=max(g["ms"] for g in got),
             ms_by_worker=[g["ms"] for g in got],
             one_process_ms=want["ms"], launches=dict(launched),
             staged_bytes=[g["exchange"]["staged_bytes"] for g in got],
             sent_bytes=[g["exchange"]["sent_bytes"] for g in got],
             staged_ms=[g["exchange"]["ms"] for g in got],
             copy_ms=[g["exchange"]["copy_ms"] for g in got],
             exchanges=[g["exchange"]["exchanges"] for g in got],
             max_memory_allocated=[g["max_memory_allocated"] for g in got],
             max_memory_reserved=[g["max_memory_reserved"] for g in got],
             equal_ranks=len(next((v for v in want["hashes"].values()
                                   if isinstance(v, dict)), {})),
             **{k: [g["extra"][k] for g in got] for k in want["extra"]
                if not k.startswith("same_")},
             **{f"one_process_{k}": v for k, v in want["extra"].items()
                if not k.startswith("same_")},
             equal_host_values=[k for k in want["extra"]
                                if k.startswith("same_")])
    missing = [k for k in must_launch if not counts.get(k)]
    check(not missing or not card,
          f"{tag}: entry points never launched: {missing}")
    emit(path=tag, phase="memory", spawn_ms=wall,
         max_memory_reserved_by_worker=[w["peak"] for w in workers],
         launches=dict(counts))
    return dict(counts)


def procs_path(dev):
    """zp: the sync engine split over four workers."""
    return split_path(dev, "zp", zp_phases, PATH_ZP)


# -- 6b. the deferred engine and the ring on the split zone -----------------

ZW_CAPACITY = 4                       # zw's patch engine: pages a commit, + 2
PATH_ZW = ("fused_accum_commit_stream", "sdelta_stack", "fletcher_blocks",
           "gf_scale", "xor_delta", "fletcher_stream",
           "fused_verify_commit_s_stream", "fused_commit_s")
# what each process launches in a phase (and the one-process run)
ZW_LAUNCHES = {
    "W_a_open_window_4": {"fletcher_blocks": 1, "sdelta_stack": 1},
    **{f"W_b_commit_{i}": {"fused_accum_commit_stream": 1}
       for i in (1, 2, 3)},
    "W_c_commit_4_flush": {"fused_accum_commit_stream": 1,
                           "sdelta_stack": 1},
    "W_d_commit_5": {"fused_accum_commit_stream": 1},
    # the staged abort runs the all-clear step too, then selects
    "W_e_staged_abort_mid_window": {"fused_accum_commit_stream": 1},
    "W_f_commit_6": {"fused_accum_commit_stream": 1},
    "P_b_7_commits": {},
    "P_c_commit_8_flush": {"xor_delta": 1, "sdelta_stack": 1},
}


def zw_patched(st, i, n_words):
    """zw's i-th patch commit: on every rank 512 words of its w_fsdp shard
    (random values, so the XOR deltas differ by rank) and rows 4i..4i+3 of
    w_tp, + 1.0; (the state, its dirty_words for leaves 1 and 2 — commit 3
    names w_tp words past the leaf too)."""
    start = 4096 * i + 100
    w = st["w_fsdp"].clone()
    w.view(G, -1)[:, start:start + 512] += 1.0
    tp = st["w_tp"].clone()
    tp[4 * i:4 * i + 4] += 1.0
    tp_words = torch.arange(4 * i * BW // 2, (4 * i + 4) * BW // 2)
    if i == 3:
        tp_words = torch.cat([tp_words, torch.tensor([n_words,
                                                      n_words + 5000])])
    return ({"w_fsdp": w, "w_tp": tp, "scale": st["scale"]},
            (torch.arange(start, start + 512), tp_words))


def zw_phases(dev, group, smashed):
    """zw's phases on this process's block (the whole zone without a
    group): w3's bulk engine (W_a-W_h, its canary abort staged), wp's
    patch engine on w_fsdp and w_tp (P_a-P_c) and q3's ring (Q_a-Q_g).
    Yields (phase, pool[, extra]); `smashed`: whether this process's
    staged canaries are the smashed ones."""
    from repro_torch import Fault
    from repro_torch.core import microbuffer
    from repro_torch.kernels import ops
    from repro_torch.runtime import failure

    def canary():
        # a guard page checked on the device: smashed on one process only
        guards = ([microbuffer.check(failure.smashed_canary_buffer(
            4096, device=dev))] if smashed else [])
        return ops.stage_verdict(guards, device=dev)

    def dispatch(pool, state, **kw):
        t0 = time.perf_counter()
        ticket = pool.commit_async(state, **kw)
        return ticket, (time.perf_counter() - t0) * 1e3

    mesh, specs, cur = zone_state(dev, group)
    cfg = dict(mode="mlpc", redundancy=R)
    pool = open_pool(cur, specs, mesh, dev, window=4, **cfg)
    check(pool.engine.window == 4 and not pool.engine.patch and
          pool.protector.stream_chunk() is not None, "zw W_a: engine")
    yield "W_a_open_window_4", pool
    for i in (1, 2, 3, 4, 5):
        cur = bumped(cur)
        check(bool(pool.commit(cur, data_cursor=i)), f"zw commit {i}")
        yield {4: "W_c_commit_4_flush", 5: "W_d_commit_5"}.get(
            i, f"W_b_commit_{i}"), pool
    check(pool.engine._since == 1, "zw W_d: the flush")
    zeros = {k: torch.zeros_like(v) for k, v in cur.items()}
    verdict = canary()
    ticket, ms = dispatch(pool, zeros, data_cursor=6, canary_ok=verdict)
    check(ticket.result() is False and pool.engine._since == 2,
          "zw W_e: the staged canary did not abort")
    del zeros, ticket
    yield "W_e_staged_abort_mid_window", pool, {"dispatch_ms": ms}
    cur = bumped(cur)
    check(bool(pool.commit(cur, data_cursor=6)), "zw W_f")
    yield "W_f_commit_6", pool
    pool.inject(lambda p, prot: failure.inject_multi_rank_loss(
        p, prot, MULTI_LOST))
    rep = pool.recover(Fault.multi_loss(*MULTI_LOST))
    check(rep.verified and rep.reverified and rep.synd_ok == [True] * R
          and rep.window_bound == {"pending": 2, "dirty_pages": None,
                                   "digest_verified": True}
          and pool.engine.window == 1, f"zw W_g {rep}")
    yield "W_g_multi_loss_recover", pool
    report = pool.scrub()
    check(not report.suspect and report.synd_ok == [True] * R and
          pool.engine.window == 2, f"zw W_h {report}")
    yield "W_h_scrub", pool
    del pool, rep, report
    torch.cuda.empty_cache()

    pool = open_pool(cur, specs, mesh, dev, window=8, pool_kw={
        "dirty_leaf_idx": [1, 2], "dirty_capacity": ZW_CAPACITY},
        mode="mlp", redundancy=R)
    eng, n_words = pool.engine, pool.protector.layout.slots[2].n_words
    check(eng.flush_patch and eng.flush_capacity == 8 * (ZW_CAPACITY + 2),
          f"zw P_a: engine {eng.flush_patch} {eng.flush_capacity}")
    yield "P_a_open_window_8", pool
    ms = []
    for i in range(1, 8):
        cur, words = zw_patched(cur, i, n_words)
        t0 = time.perf_counter()
        check(bool(pool.commit(cur, dirty_words=words, data_cursor=i)),
              f"zw P_b {i}")
        ms.append((time.perf_counter() - t0) * 1e3)
    yield "P_b_7_commits", pool, {"commit_ms": ms}
    cur, words = zw_patched(cur, 8, n_words)
    check(bool(pool.commit(cur, dirty_words=words, data_cursor=8)) and
          eng._since == 0, "zw P_c")
    yield "P_c_commit_8_flush", pool
    del pool, eng
    torch.cuda.empty_cache()

    pool = open_pool(cur, specs, mesh, dev, pipeline_depth=4, **cfg)
    yield "Q_a_open_depth_4", pool
    slices, dirty = zp_patch(pool.protector.layout)
    states = [cur, bumped(cur)]
    states.append(bumped(states[-1], words=slices))
    got = [pool.commit_async(st, **kw).result() for st, kw in (
        (states[1], dict(data_cursor=1, verify_old=True)),
        (states[1], dict(data_cursor=2, canary_ok=canary())),
        (states[2], dict(data_cursor=3, dirty_pages=dirty)))]
    pool.drain()
    check(got == [True, False, True], f"zw Q_a verdicts {got}")
    yield "Q_a_warm_up", pool
    states = states[2:]
    for _ in range(8):
        states.append(bumped(states[-1]))
    tickets, ms = [], []
    for i in range(8):
        kw = (dict(verify_old=True) if i == 2 else
              dict(canary_ok=canary()) if i == 4 else {})
        ticket, t = dispatch(pool, states[i + 1], data_cursor=i + 1, **kw)
        tickets.append(ticket)
        ms.append(t)
    yield "Q_b_8_bulk_commit_async", pool, {"dispatch_ms": ms}
    polled, drained = len(pool.poll()), len(pool.drain())
    verdicts = [t.result() for t in tickets]
    check(verdicts == [i != 4 for i in range(8)], f"zw Q_c {verdicts}")
    yield "Q_c_poll_drain", pool, {"polled": polled, "drained": drained}
    cur = states[-1]
    del states, tickets
    tickets, ms = [], []
    for i in range(16):
        cur = bumped(cur, words=slices)
        ticket, t = dispatch(pool, cur, data_cursor=9 + i, dirty_pages=dirty)
        tickets.append(ticket)
        ms.append(t)
    pool.drain()
    check(all(t.result() for t in tickets), "zw Q_e: a patch failed")
    yield "Q_e_16_patch_depth_4", pool, {"dispatch_ms": ms}
    tickets = []
    for i in range(3):
        cur = bumped(cur)
        tickets.append(pool.commit_async(cur, data_cursor=25 + i))
    check(pool.in_flight == 3, f"zw Q_g in flight {pool.in_flight}")
    pool.inject(lambda p, prot: failure.inject_multi_rank_loss(
        p, prot, MULTI_LOST))
    rep = pool.recover(Fault.multi_loss(*MULTI_LOST))
    check(rep.verified and rep.reverified and rep.synd_ok == [True] * R
          and pool.in_flight == 0 and all(t.result() for t in tickets),
          f"zw Q_g {rep}")
    yield "Q_g_loss_with_3_in_flight", pool


def window_procs_path(dev):
    """zw: the deferred engines and the ring split over four workers."""
    return split_path(dev, "zw", zw_phases, PATH_ZW, ZW_LAUNCHES)


# -- 6c. the hosts of a pool on the split zone: PoolGroup, rescale, Server,
# -- Trainer -------------------------------------------------------------------

ZG_WORLD = 2                          # zg: 50 + 50 data ranks at 100 x 1
ZG_SCRIBBLED = 77                     # process 1's rank: t1's scribble
ZG_WORD = 4321
PATH_ZG = ("fletcher_blocks", "sdelta_stack", "fused_verify_commit_s",
           "gf_scale", "fused_accum_commit", "fused_accum_commit_stream",
           "fletcher_stream")
ZS_WORLD = 4                          # zs: one data rank and 4 rows each
ZS_PROMPT, ZS_NEW = 8, 8              # tokens of the r = 1 generation
ZS_EVENT = 4                          # generated tokens before the loss
ZS_LOST = 2                           # process 2's data rank
ZS_SHORT = 4                          # the window-4 / depth-2 runs' tokens
PATH_ZS = ("fletcher_blocks", "fused_commit", "fused_commit_s",
           "sdelta_stack")
ZT_WORLD = 2                          # zt: two data ranks each
ZT_MICROBATCHES = 2                   # the one process's too
ZT_LAYERS = 4                         # the depth (the config's 28 until
                                      # PR 29's cut, made for zc g, r, e)
ZT_LOST = 3                           # process 1's data rank
PATH_ZT = ("fletcher_blocks", "fletcher_stream",
           "fused_verify_commit_stream")


def sha(tree) -> str:
    """SHA-256 of a tensor tree's bytes, leaf by leaf in order."""
    import hashlib
    h = hashlib.sha256()
    for k, v in sorted(utils_flat(tree).items()):
        v = v.detach().contiguous().cpu().reshape(-1)
        h.update(k.encode())
        h.update(v.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def same_as_fresh_open(pool, state, tag):
    """The pool holds what a pool freshly opened over the global `state`
    on its mesh holds (row, syndromes, checksums, digest, state)."""
    from repro_torch import Pool
    fresh = Pool.open(state, pool.state_specs, mesh=pool.mesh,
                      config=pool.config, device=pool.device)
    for k in ("row", "synd", "cksums", "digest"):
        check(torch.equal(getattr(pool.prot, k), getattr(fresh.prot, k)),
              f"{tag}: {k} != a fresh pool's")
    for k, v in pool.prot.state.items():
        check(torch.equal(v, fresh.prot.state[k]),
              f"{tag}: state.{k} != a fresh pool's")


def zg_phases(dev, group, smashed):
    """zg: tg's four tenants (mlpc r = 3, G = 100) through a bulk wave, a
    verified wave, a wave with t2's canary failing, a scribble on
    process 1's rank of t1 found by `scrub_tick` and recovered under
    quarantine, t3's three-rank loss recovered beside an async wave of
    the others, t0's eviction; the four at window 2 through a wave and
    the flushing one; then el's rescale walk (100 x 1 -> 50 x 2 -> 100 x
    1, sync and window 4), each rescaled pool against a fresh one, each
    rescale's ms and moved bytes (none over one group) in its extras."""
    from repro_torch import Fault, ProtectConfig, ZoneMesh
    from repro_torch.runtime import failure
    from repro_torch.tenancy import PoolGroup

    mesh, specs, base = zone_state(dev, group)
    tids = [f"t{t}" for t in range(TENANTS)]
    cur = dict(zip(tids, tenant_states(base, TENANTS)))
    del base

    def pools(grp):
        return {tid: grp[tid].pool for tid in grp.tenants}

    def wave(grp, **kw):
        ups = {t: bumped(cur[t]) for t in grp.tenants}
        oks = {t: bool(v) for t, v in grp.commit(ups, **kw).items()}
        for t, ok in oks.items():
            if ok:
                cur[t] = ups[t]
        return {"same_oks": oks, "hash_state": False}

    grp = PoolGroup(mesh, device=dev, full_scrub_every=1)
    for tid in tids:
        grp.admit(tid, cur[tid], specs,
                  config=ProtectConfig(mode="mlpc", redundancy=R))
    yield "a_admit_4", pools(grp)
    yield "b_bulk_wave", pools(grp), wave(grp)
    yield "c_verify_wave", pools(grp), wave(grp, verify_old=True)
    out = wave(grp, canary_ok={t: t != "t2" for t in tids})
    check(not out["same_oks"]["t2"], "zg d: t2's canary did not abort")
    yield "d_canary_fails_t2", pools(grp), out
    grp["t1"].pool.inject(lambda p, prot: failure.inject_scribble(
        p, prot, ZG_SCRIBBLED, [ZG_WORD]))
    found, recovered = [], []
    for tid, kind, rep in grp.scrub_tick():
        locs = sorted(tuple(int(v) for v in loc) for loc in rep.bad_locations)
        found.append((tid, kind, locs))
        if locs:                          # an agreed finding: every process
            rec = grp.recover(tid, Fault.scribble(
                locs[0][0], sorted({pg for _, pg in locs})))
            check(rec.verified and rec.reverified, f"zg e {rec}")
            recovered.append(tid)
    check(recovered == ["t1"] and grp.quarantined == (),
          f"zg e: found {found}")
    yield "e_scrub_tick_scribble_recover", pools(grp), {
        "same_found": found, "same_recovered": recovered,
        "hash_state": False}
    victim = grp["t3"].pool
    victim.inject(lambda p, prot: failure.inject_multi_rank_loss(
        p, prot, MULTI_LOST))
    ups = {t: bumped(cur[t]) for t in tids if t != "t3"}
    ticket = grp.commit_async(ups)
    rep = grp.recover("t3", Fault.multi_loss(*MULTI_LOST))
    grp.drain()
    check(rep.verified and rep.reverified and bool(ticket.result()),
          f"zg f {rep}")
    cur.update(ups)
    del ups, ticket
    yield "f_recover_t3_beside_a_wave", pools(grp), {"hash_state": False}
    evicted = grp.evict("t0")
    check(all(torch.equal(evicted[k], cur["t0"][k]) for k in evicted),
          "zg g: the evicted state is not t0's")
    yield "g_evict_t0", pools(grp), {"same_evicted": sha(evicted)}
    del grp, evicted
    gc.collect()
    if on_card(dev):
        torch.cuda.empty_cache()

    grp = PoolGroup(mesh, device=dev)
    for tid in tids:
        grp.admit(tid, cur[tid], specs,
                  config=ProtectConfig(mode="mlpc", redundancy=R, window=2))
    yield "h_admit_4_window_2", pools(grp)
    yield "i_window_wave_1", pools(grp), wave(grp)
    yield "j_window_wave_2_flush", pools(grp), wave(grp)
    del grp
    gc.collect()
    if on_card(dev):
        torch.cuda.empty_cache()

    state = cur["t1"]
    for tag, cfg in (("sync", dict(mode="mlpc", redundancy=R)),
                     ("w3", dict(mode="mlpc", redundancy=R, window=4))):
        pool = open_pool(state, specs, mesh, dev, **cfg)
        yield f"k_{tag}_open", pool, {"hash_state": False}
        for i, shape in enumerate((*EL_SHAPES, None), start=1):
            new = bumped(state)
            check(bool(pool.commit(new, data_cursor=i)), "zg: commit failed")
            state = new
            yield f"l_{tag}_commit_{i}", pool, {"hash_state": shape is None}
            if shape is None:
                break
            sent = 0 if group is None else group.stats["moved_bytes"]
            sync(dev)
            t0 = time.perf_counter()
            moved = pool.rescale(ZoneMesh(shape, ("data", "model"),
                                          group=group))
            sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
            sent = (0 if group is None else group.stats["moved_bytes"]
                    - sent)
            check(moved.protector.group_size == shape[0] and moved.step == i,
                  f"zg {tag}: G {moved.protector.group_size}")
            check(sent == 0, f"zg {tag}: a same-group rescale moved {sent} "
                  "bytes")
            yield f"m_{tag}_rescale_{shape[0]}x{shape[1]}", moved, {
                "rescale_ms": ms, "moved_bytes": sent}
            same_as_fresh_open(moved, state, f"zg {tag} rescale {i}")
            yield f"n_{tag}_{i}_same_as_fresh", moved, {"hash": False}
            pool = moved
        del pool, moved
        gc.collect()


def batch_dims(specs) -> list:
    """Each cache leaf's batch dim: the one its spec puts on `data` (None
    for a leaf with none)."""
    from repro_torch import utils
    return [next((i for i, e in enumerate(spec)
                  if e == "data" or (isinstance(e, tuple) and "data" in e)),
                 None) for spec in utils.tree_leaves(specs)]


def by_blocks(decode, specs, world):
    """A decode step taken `world` blocks of rows at a time, each block's
    cache a contiguous tensor of its rows, as a server split over `world`
    processes takes it (the same products at the same M): the outputs put
    back together in rank order."""
    from repro_torch import utils
    dims = batch_dims(specs)

    def step(params, tokens, cache, pos):
        n = tokens.shape[0] // world
        leaves, treedef = utils.tree_flatten(cache)
        parts = [decode(params, tokens[i * n:(i + 1) * n],
                        utils.tree_unflatten(treedef, [
                            x if d is None else
                            x.narrow(d, i * n, n).contiguous()
                            for x, d in zip(leaves, dims)]), pos)
                 for i in range(world)]
        new = [torch.cat([utils.tree_leaves(q[2])[j] for q in parts], dim=d)
               if d is not None else utils.tree_leaves(parts[0][2])[j]
               for j, d in enumerate(dims)]
        return (torch.cat([q[0] for q in parts]),
                torch.cat([q[1] for q in parts]),
                utils.tree_unflatten(treedef, new))
    return step


def zs_server(dev, cfg, mesh, params, **pcfg):
    """sv's server on `mesh`.  On one process its decode goes by blocks of
    rows (`by_blocks`), as the split server's does: the card's bf16
    decode of B / W rows is not the same bits as of B (PERF.md §7), so
    the one-process pool is fed the caches the split pools are, and every
    field is held byte-equal given them."""
    srv = sv_server(dev, cfg, mesh, params, **pcfg)
    if mesh.group is None:
        srv._decode = by_blocks(srv._decode, srv._cache_specs, ZS_WORLD)
    return srv


def zs_phases(dev, group, smashed):
    """zs: sv's server (qwen3-0.6b at full width, batch 16, max_len 2048,
    (4, 2)) with each process decoding its block's rows: start, a
    ZS_PROMPT-token prompt, ZS_EVENT tokens, rank ZS_LOST (process 2)
    lost and recovered, the rest of ZS_NEW, a scrub; then a run at
    r = 3, window 4 and one at pipeline_depth 2, ZS_SHORT + ZS_SHORT
    tokens each.  The tokens are gathered in rank order."""
    from repro_torch import Fault, ZoneMesh
    from repro_torch.dist import sharding
    from repro_torch.runtime import failure

    cfg, _, params, prompt = sv_model(dev)
    mesh = ZoneMesh(SV_MESH, ("data", "model"), group=group)
    srv = zs_server(dev, cfg, mesh, params)
    yield "a_start", srv.pool, {"hash_state": False}
    rows = srv.block_rows(prompt)

    def tokens(out):
        toks = sharding.gather_global(torch.stack(out, dim=1),
                                      srv._row_spec, mesh)
        return toks.cpu().tolist()
    for t in range(ZS_PROMPT):
        tok = srv.step(rows[:, t])
    out = [tok]
    yield f"b_prefill_{ZS_PROMPT}", srv.pool, {"hash_state": False}
    for _ in range(ZS_EVENT):
        tok = srv.step(tok)
        out.append(tok)
    yield f"c_decode_{ZS_EVENT}", srv.pool, {"hash_state": False}
    srv.pool.inject(lambda p, prot: failure.inject_rank_loss(
        p, prot, ZS_LOST))
    rep = srv.pool.recover(Fault.rank_loss(ZS_LOST))
    check(rep.verified and rep.reverified, f"zs d {rep}")
    yield "d_rank_loss_recover", srv.pool, {"hash_state": False}
    while len(out) < ZS_NEW:
        tok = srv.step(tok)
        out.append(tok)
    yield f"e_decode_to_{ZS_NEW}", srv.pool, {"hash_state": False,
                                              "same_tokens": tokens(out)}
    report = srv.pool.scrub()
    check(report.checked and not report.suspect, f"zs f {report}")
    yield "f_scrub", srv.pool, {"same_tokens": tokens(out)}
    del srv
    gc.collect()
    if on_card(dev):
        torch.cuda.empty_cache()
    for tag, pcfg in (("g_r3_window_4", dict(redundancy=R, window=4)),
                      ("h_depth_2", dict(pipeline_depth=2))):
        srv = zs_server(dev, cfg, mesh, params, **pcfg)
        rows = srv.block_rows(prompt)
        for t in range(ZS_SHORT):
            tok = srv.step(rows[:, t])
        out = [tok]
        for _ in range(ZS_SHORT - 1):
            tok = srv.step(tok)
            out.append(tok)
        srv.pool.drain()
        yield tag, srv.pool, {"hash_state": False,
                              "same_tokens": tokens(out)}
        srv.flush()
        yield f"{tag}_flushed", srv.pool
        del srv
        gc.collect()
        if on_card(dev):
            torch.cuda.empty_cache()


def zt_trainer(dev, mesh):
    """tr's trainer at ZT_MICROBATCHES (and ZT_LAYERS) on `mesh`."""
    from repro_torch import ProtectConfig
    from repro_torch.configs.base import TrainConfig
    from repro_torch.runtime.trainer import Trainer
    cfg, _ = tr_model()
    if ZT_LAYERS is not None:
        cfg = dataclasses.replace(cfg, n_layers=ZT_LAYERS)
    t = Trainer(cfg, TrainConfig(learning_rate=TR_LR, warmup_steps=TR_WARMUP,
                                 total_steps=TR_TOTAL,
                                 microbatches=ZT_MICROBATCHES),
                ProtectConfig(mode="mlpc", scrub_period=TR_SCRUB), mesh,
                seq_len=TR_SEQ, global_batch=TR_BATCH, seed=SEED, device=dev)
    t.initialize()
    return t


def zt_phases(dev, group, smashed):
    """zt: tr's trainer (qwen3-0.6b at full width, seq 1024 x batch 8,
    (4, 2)) at microbatches ZT_MICROBATCHES, each process its
    microbatches: the init, step 1, step 2 with verify_old, rank ZT_LOST
    (process 1) lost and recovered, step 3 with a failed canary (aborted
    everywhere), step 3, a scrub."""
    from repro_torch import Fault, ZoneMesh
    from repro_torch.runtime import failure

    mesh = ZoneMesh(TR_MESH, ("data", "model"), group=group)
    t = zt_trainer(dev, mesh)
    yield "a_init", t.pool, {"hash_state": False}

    def step(**kw):
        out = t.step(**kw)
        return {"same_step": [out["step"], out["loss"], out["committed"]],
                "hash_state": False}
    yield "b_step_1", t.pool, step()
    t.verify_old = True
    yield "c_step_2_verify_old", t.pool, step()
    t.verify_old = False
    t.pool.inject(lambda p, prot: failure.inject_rank_loss(p, prot, ZT_LOST))
    rep = t.pool.recover(Fault.rank_loss(ZT_LOST))
    check(rep.verified and rep.reverified, f"zt d {rep}")
    yield "d_rank_loss_recover", t.pool, {"hash_state": False}
    out = step(canary_ok=False)
    check(out["same_step"][2] is False and t.cursor == 2,
          f"zt e: {out}, cursor {t.cursor}")
    yield "e_step_3_canary_fails", t.pool, out
    yield "f_step_3", t.pool, step()
    report = t.pool.scrub()
    check(report.checked and not report.suspect, f"zt g {report}")
    yield "g_scrub", t.pool


def group_procs_path(dev):
    """zg: PoolGroup and the rescale walk split over two workers."""
    return split_path(dev, "zg", zg_phases, PATH_ZG, world=ZG_WORLD)


def zs_op_bits(dev, cfg):
    """Which of the decode's ops give other bits on B / W rows than on B
    (the card picks a reduction's or a product's split by shape): each
    op at SV_BATCH rows against the same op a block of rows at a time."""
    from repro_torch.models import layers as L
    gen = torch.Generator(dev).manual_seed(SEED + 2)
    b, n = SV_BATCH, SV_BATCH // ZS_WORLD
    x = torch.randn(b, cfg.d_model, device=dev, generator=gen).to(
        torch.bfloat16)
    w = torch.randn(cfg.d_model, cfg.d_ff, device=dev, generator=gen).to(
        torch.bfloat16)
    scale = torch.randn(cfg.d_model, device=dev, generator=gen)
    g, hd, t = cfg.n_heads // cfg.n_kv, cfg.hd, SV_MAX_LEN
    q = torch.randn(b, cfg.n_kv, g, hd, device=dev, generator=gen)
    kt = torch.randn(b, cfg.n_kv, hd, t, device=dev, generator=gen)
    pr = torch.softmax(torch.randn(b, cfg.n_kv, g, t, device=dev,
                                   generator=gen), -1)
    vt = torch.randn(b, cfg.n_kv, t, hd, device=dev, generator=gen)
    heads = torch.randn(b, 1, cfg.n_heads, hd, device=dev, generator=gen)
    # (name, the op, its arguments), each batch-leading
    ops = (("matmul", lambda v: v[:, None] @ w, (x,)),
           ("rmsnorm", lambda v: L.apply_rmsnorm({"scale": scale}, v), (x,)),
           ("headnorm", lambda v: v.pow(2).mean(-1), (heads,)),
           ("softmax", lambda v: torch.softmax(v, -1), (pr,)),
           ("attn_scores", lambda a, c: torch.matmul(a, c), (q, kt)),
           ("attn_values", lambda a, c: torch.matmul(a, c), (pr, vt)))
    out = {}
    for name, fn, args in ops:
        whole = fn(*args)
        rows = torch.cat([fn(*(a[i:i + n] for a in args))
                          for i in range(0, b, n)])
        out[name] = bool(torch.equal(whole, rows))
    return out


def server_procs_path(dev):
    """zs: sv's server split over four workers, against one process
    decoding by blocks of rows (`zs_server`); then the decode itself:
    the whole-batch server's tokens against the split ones (the share
    of equal tokens), the split decode teacher-forced a block of rows at
    a time against the f32 forward (sv h's bound), and which op gives
    other bits by rows."""
    import numpy as np
    counts = split_path(dev, "zs", zs_phases, PATH_ZS, world=ZS_WORLD)
    one = {ln["phase"]: ln for ln in SPLIT_RUNS["zs"]}
    toks = np.asarray(one[f"e_decode_to_{ZS_NEW}"]["extra"]["same_tokens"])
    cfg, mesh, params, prompt = sv_model(dev)
    srv = sv_server(dev, cfg, mesh, params, protect=False)
    tok = None
    for t in range(ZS_PROMPT):
        tok = srv.step(prompt[:, t])
    whole = [tok]
    while len(whole) < ZS_NEW:
        tok = srv.step(tok)
        whole.append(tok)
    whole = torch.stack(whole, 1).cpu().numpy()
    del srv
    gc.collect()
    if on_card(dev):
        torch.cuda.empty_cache()
    n = SV_BATCH // ZS_WORLD
    refs = [sv_reference(cfg, params, prompt[i:i + n, :ZS_PROMPT],
                         toks[i:i + n], SV_MAX_LEN)
            for i in range(0, SV_BATCH, n)]
    emit(path="zs", phase="i_decode_by_rows",
         rows_a_process=n, equal_token_share=float((whole == toks).mean()),
         op_bits_equal_by_rows=zs_op_bits(dev, cfg),
         rel_err_by_block=[r["rel_err"] for r in refs],
         positions_over_bound=[r["positions_over_bound"] for r in refs],
         argmax_agree_by_block=[r["argmax_agree"] for r in refs],
         bound=SV_LOGIT_RTOL)
    return counts


def trainer_procs_path(dev):
    """zt: tr's trainer split over two workers."""
    return split_path(dev, "zt", zt_phases, PATH_ZT, world=ZT_WORLD)


# -- 6d. the chaos campaign on the split zone ---------------------------------

ZC_WORLD = 4                          # zc: 25 data ranks a worker at 100 x 1
ZC_STORMS = 1                         # the storm cells zc runs (ch's quick
                                      # two, cut to one to make room)
ZC_TIMEOUT_S = 900                    # the workers' spawn, at most
ZC_RESTORE_LOST = (7, 31)             # zc r's loss past r = 1 on 50 x 2:
                                      # processes 0 and 1
ZC_RESTORE_SINGLE = 57                # zc r's online loss: process 2
PATH_ZC = tuple(dict.fromkeys(PATH_CH + PATH_TG))


def zc_meshes():
    """zc's meshes in its order: 100 x 1 first, so every scenario opens
    over four workers; 50 x 2 fits two (a rescale there changes the
    process count)."""
    return (EL_SHAPES[1], EL_SHAPES[0])


def zc_extras(out):
    """A chaos run's extras as a zc phase gives them: the golden verdict
    (agreed, so alike on every process), the trace violations, the
    recoveries' (kind, step, verified), the steps a process sat out as a
    spare, the commit and recovery ms, each rescale's and restore's ms
    and moved bytes."""
    recs = out["recoveries"]
    return {
        "same_golden_exact": bool(out["golden_exact"]),
        "trace_violations": out["trace"]["violations"],
        "recoveries": [(r["kind"], r.get("step"), r.get("verified"))
                       for r in recs],
        "spare_steps": out.get("spare_steps", []),
        "commit_ms": out["commit_ms"], "recovery_ms": out["recovery_ms"],
        "rescale_ms": [r["ms"] for r in recs if r["kind"] == "rescale"],
        "moved_bytes": [r.get("moved_bytes") for r in recs
                        if r["kind"] == "rescale"],
        "restore_ms": [r["ms"] for r in recs
                       if r["kind"] == "restore_replay"],
        "restore_moved_bytes": [r.get("moved_bytes") for r in recs
                                if r["kind"] == "restore_replay"]}


def zc_group_phases(dev, group):
    """zc g: tg's four tenants at CH_TENANT_BYTES each (mlpc r = 3) in a
    PoolGroup opened on 100 x 1 over the four workers, a wave, a rescale
    to 50 x 2 over two (workers 2 and 3 spares, in `PoolGroup.join`), a
    wave (verified, on the sync engine), a rescale back to four, a wave
    and a scrub tick that finds nothing; sync, then at window 4.  Each
    rescale's extras: its ms and the bytes this process moved."""
    import numpy as np
    from repro_torch import ProtectConfig
    from repro_torch.chaos import workload
    from repro_torch.dist.sharding import P
    from repro_torch.tenancy import PoolGroup

    shapes = zc_meshes()
    words = workload.n_words(CH_TENANT_BYTES, shapes[0][0])
    specs = {"w": P("data")}
    cold = {"w": torch.empty(words, dtype=torch.float32, device="meta")}
    tids = [f"t{t}" for t in range(TENANTS)]

    def pools(grp):
        return {} if grp is None else {t: grp[t].pool for t in grp.tenants}

    def moved_bytes():
        return 0 if group is None else group.stats["moved_bytes"]

    for tag, cfg in (("sync", dict(mode="mlpc", redundancy=R)),
                     ("w4", dict(mode="mlpc", redundancy=R, window=4))):
        mesh = workload.mesh_over(shapes[0], group)
        grp = PoolGroup(mesh, device=dev)
        for t, tid in enumerate(tids):
            grp.admit(tid, cold, specs, config=ProtectConfig(**cfg))
            grp[tid].pool.init({"w": workload.initial_state(
                words // mesh.world, SEED + 13 * t, dev,
                workload.block_offset(mesh, words))}, block=True)
        yield f"g_{tag}_open", pools(grp), {"hash": False}
        for i, shape in enumerate((shapes[1], shapes[0], None), start=1):
            oks = None
            if grp is not None:
                c = np.float32((i % 7) * 1e-6)
                ups = {tid: {"w": workload.fma(
                    grp[tid].pool.block_state["w"], workload.GAIN, c)}
                    for tid in tids}
                vkw = {"verify_old": True} if tag == "sync" and i == 2 else {}
                oks = {t: bool(v) for t, v in grp.commit(
                    ups, data_cursor=i, block=True, **vkw).items()}
                check(all(oks.values()), f"zc g {tag} wave {i}: {oks}")
                del ups
            yield f"g_{tag}_wave_{i}", pools(grp), {"hash_state": False}
            if shape is None:
                break
            new = workload.mesh_over(shape, group)
            m0 = moved_bytes()
            sync(dev)
            t0 = time.perf_counter()
            if grp is not None:
                grp = grp.rescale(new)
            else:
                grp = PoolGroup.join(mesh, new, device=dev)
            sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
            mesh = new
            if grp is not None:
                check(grp.tenants == tuple(tids) and all(
                    grp[t].pool.protector.group_size == shape[0]
                    for t in tids), f"zc g {tag}: {grp.tenants}")
            yield f"g_{tag}_rescale_{i}", pools(grp), {
                "rescale_ms": ms, "moved_bytes": moved_bytes() - m0,
                "hash_state": False}
        found = [(tid, kind, sorted(tuple(int(v) for v in loc)
                                    for loc in rep.bad_locations))
                 for tid, kind, rep in grp.scrub_tick()]
        check(found and not any(locs for *_k, locs in found),
              f"zc g {tag}: the scrub tick found {found}")
        yield f"g_{tag}_scrub", pools(grp), {"same_found": found,
                                             "hash": False}
        del grp
        gc.collect()
        if on_card(dev):
            torch.cuda.empty_cache()


def zc_cross_runs(dev, group):
    """zc r and zc e: {name: a builder of (workload, schedule, steps)}.
    r: budget_exhaust_rearm's workload (r = 1, window 2) at CH_BYTES on a
    snapshot at 100 x 1 over four, a rescale to 50 x 2 over two, a loss
    of ZC_RESTORE_LOST past its budget (the restore from the four
    processes' snapshot onto two, and the replay), a rescale back and a
    loss of ZC_RESTORE_SINGLE recovered online.  e: ch's
    rescale_under_traffic with its first rescale only (4 -> 2), so that
    it ends on two processes."""
    from repro_torch.chaos import scenarios, workload
    from repro_torch.chaos.schedule import ChaosEvent, FaultSchedule
    meshes = zc_meshes()
    size = dict(meshes=meshes, n_bytes=CH_BYTES, device=dev, group=group)
    over = [{}, {}]
    if group is not None:
        over = [{"procs": workload.fit_procs(m[0], group.world)}
                for m in meshes]
    E = ChaosEvent.make

    def restore():
        wl, _, n = scenarios.budget_exhaust_rearm(True, SEED, **size)
        return wl, FaultSchedule([
            E(2, "snapshot"),
            E(4, "rescale", shape=tuple(meshes[1]), **over[1]),
            E(8, "multi_loss", ranks=ZC_RESTORE_LOST),
            E(12, "rescale", shape=tuple(meshes[0]), **over[0]),
            E(16, "rank_loss", rank=ZC_RESTORE_SINGLE)], seed=SEED), n

    def ends():
        wl, sched, n = scenarios.rescale_under_traffic(True, SEED, **size)
        return wl, FaultSchedule(list(sched)[:2], seed=SEED), n
    return {"r_restore_across_rescale": restore, "e_ends_elsewhere": ends}


def zc_phases(dev, group, smashed):
    """zc: ch's quick campaign, a phase a scenario (every one of SCENARIOS
    and GROUP_SCENARIOS, then the first ZC_STORMS storm cells), on
    `zc_meshes()` at CH_BYTES a workload (CH_TENANT_BYTES a tenant):
    split over the world of `group`, or on one process.  Each phase's
    pools are the scenario's final ones (none on a spare); its extras
    `zc_extras`.  Then zc g (`zc_group_phases`), and zc r and zc e
    (`zc_cross_runs`), each run a phase."""
    from repro_torch.chaos import scenarios
    from repro_torch.chaos.runner import ScenarioRunner
    from repro_torch.obs import Tracer, validate_events
    del smashed
    size = dict(quick=True, seed=SEED, meshes=zc_meshes(), device=dev,
                group=group, final=lambda pools: pools)
    jobs = [(name, functools.partial(
        scenarios.run_scenario, name, n_bytes=(
            CH_TENANT_BYTES if name == "multi_tenant_interference"
            else CH_BYTES), **size))
        for name in (*scenarios.SCENARIOS, *scenarios.GROUP_SCENARIOS)]
    jobs += [(f"storm_r{r}_w{w}", functools.partial(
        scenarios.run_storm_cell, r, w, n_bytes=CH_BYTES, **size))
        for r, w in scenarios.STORM_CELLS[:ZC_STORMS]]
    for name, job in jobs:
        gc.collect()
        if on_card(dev):
            torch.cuda.empty_cache()
        out = job()
        pools = out.pop("final")
        yield name, pools, zc_extras(out)
        del out, pools
    yield from zc_group_phases(dev, group)
    for name, build in zc_cross_runs(dev, group).items():
        gc.collect()
        if on_card(dev):
            torch.cuda.empty_cache()
        wl, sched, n = build()
        tracer = Tracer()
        wl.set_tracer(tracer)
        out = ScenarioRunner(wl, sched).run(n)
        out["trace"] = {"violations": validate_events(tracer.events)}
        pools = {} if wl.pool is None else {"w": wl.pool}
        del wl
        yield name, pools, zc_extras(out)
        del out, pools


def reckoned_moves(n_words, old_w, new_w, world):
    """The bytes each of `world` processes sends when a P("data") f32
    state of `n_words` moves from the first `old_w` processes to the first
    `new_w`: the words it holds and will not hold."""
    out = []
    for p in range(world):
        a, b = ((p * n_words // old_w, (p + 1) * n_words // old_w)
                if p < old_w else (0, 0))
        c, d = ((p * n_words // new_w, (p + 1) * n_words // new_w)
                if p < new_w else (0, 0))
        out.append(4 * ((b - a) - max(0, min(b, d) - max(a, c))))
    return out


def chaos_procs_path(dev):
    """zc: ch's quick campaign split over four workers against one process
    on the same meshes in the same order, then zc g (a PoolGroup across
    process counts), zc r (a snapshot restored onto another mesh) and zc
    e (a run that ends on two processes); every run golden-exact, every
    phase per-rank byte-equal, each worker's recoveries one process's
    (but for the steps it sat out: a rescale or a restore it took part
    in stays), and the W-change rescales' and the restore's moved bytes
    those the interval intersections reckon."""
    from repro_torch.chaos import workload
    counts = split_path(dev, "zc", zc_phases, PATH_ZC, world=ZC_WORLD,
                        timeout=ZC_TIMEOUT_S)
    one, workers = SPLIT_RUNS["zc"], SPLIT_WORKERS["zc"]
    n = workload.n_words(CH_BYTES, zc_meshes()[0][0])
    ws = [workload.fit_procs(m[0], ZC_WORLD) for m in zc_meshes()]
    by_tag = {want["phase"]: i for i, want in enumerate(one)}

    def extra(tag, k):
        return [lines[by_tag[tag]]["extra"][k] for lines in workers]
    for i, want in enumerate(one):
        tag, ext = want["phase"], want["extra"]
        if "same_golden_exact" not in ext:
            continue
        check(ext["same_golden_exact"] and not ext["trace_violations"],
              f"zc {tag}: one process not golden ({ext})")
        for rank, lines in enumerate(workers):
            got = lines[i]["extra"]
            check(not got["trace_violations"],
                  f"zc {tag} p{rank}: {got['trace_violations']}")
            sat = set(got["spare_steps"])
            check(got["recoveries"] == [
                r for r in ext["recoveries"]
                if r[1] not in sat or r[0] in ("rescale", "restore_replay")],
                f"zc {tag} p{rank}: recoveries {got['recoveries']}, one "
                f"process {ext['recoveries']}")
    for tag in ("rescale_under_traffic", "e_ends_elsewhere"):
        want_moves = [reckoned_moves(n, ws[0], ws[1], ZC_WORLD),
                      reckoned_moves(n, ws[1], ws[0], ZC_WORLD)]
        got = extra(tag, "moved_bytes")
        got_moves = [[g[k] for g in got] for k in range(len(got[0]))]
        emit(path="zc", phase=f"{tag}_moves", procs=ws,
             moved_bytes=got_moves, reckoned_bytes=want_moves,
             total_bytes=[sum(m) for m in got_moves],
             rescale_ms=extra(tag, "rescale_ms"))
        check(got_moves == want_moves[:len(got_moves)],
              f"zc {tag}: moved {got_moves}, reckoned {want_moves}")
    tag = "r_restore_across_rescale"
    kinds = [r[0] for r in one[by_tag[tag]]["extra"]["recoveries"]]
    check(kinds == ["rescale", "restore_replay", "rescale", "rank_loss"],
          f"zc r: recoveries {kinds}")
    restored = [g[0] for g in extra(tag, "restore_moved_bytes")]
    emit(path="zc", phase="r_restore_moves", moved_bytes=restored,
         reckoned_bytes=reckoned_moves(n, ws[0], ws[1], ZC_WORLD),
         restore_ms=extra(tag, "restore_ms"),
         rescale_ms=extra(tag, "rescale_ms"))
    check(restored == reckoned_moves(n, ws[0], ws[1], ZC_WORLD),
          f"zc r: the restore moved {restored}")
    words = workload.n_words(CH_TENANT_BYTES, zc_meshes()[0][0])
    for mode in ("sync", "w4"):
        for k, (old_w, new_w) in enumerate(((ws[0], ws[1]), (ws[1], ws[0])),
                                           start=1):
            tag = f"g_{mode}_rescale_{k}"
            got = extra(tag, "moved_bytes")
            want = [TENANTS * b for b in reckoned_moves(words, old_w, new_w,
                                                        ZC_WORLD)]
            emit(path="zc", phase=f"{tag}_moves", procs=(old_w, new_w),
                 moved_bytes=got, reckoned_bytes=want,
                 rescale_ms=extra(tag, "rescale_ms"),
                 one_process_rescale_ms=one[by_tag[tag]]["extra"][
                     "rescale_ms"])
            check(got == want, f"zc {tag}: moved {got}, reckoned {want}")
            check(one[by_tag[tag]]["extra"]["moved_bytes"] == 0,
                  f"zc {tag}: one process moved bytes")
    return counts


# -- 5. the deferred-epoch engine ---------------------------------------------

def window_invariants(start_row, start_synd):
    """The in-window invariants, apart from the engine: the checksums and
    the digest are the live rows' (the Fletcher terms, plain); the stack is
    the epoch start's; the bulk engine's row is the live rows and its
    accumulator row_start ^ row_now; the patch engine's row is pinned at
    the epoch start and its live row is the live rows."""
    def inv(pool, tag):
        from repro_torch.core import checksum, layout
        from repro_torch.kernels.fletcher import fletcher_pages_plain
        prot, lo = pool.prot, pool.protector.layout
        rows = layout.flatten_row(lo, prot.state)
        terms = fletcher_pages_plain(rows.reshape(*rows.shape[:-1], -1, BW))
        if pool.mode.has_cksums:
            check(torch.equal(prot.cksums, terms), f"{tag}: cksums != terms")
        check(torch.equal(prot.digest, checksum.combine(terms, BW)),
              f"{tag}: digest != combine(terms)")
        check(torch.equal(prot.synd, start_synd), f"{tag}: stack moved")
        if pool.engine.patch:
            check(torch.equal(prot.row, start_row), f"{tag}: row moved")
            check(torch.equal(pool._est.live, rows),
                  f"{tag}: live row != flatten")
        else:
            check(torch.equal(prot.row, rows), f"{tag}: row != flatten")
            check(torch.equal(pool._est.acc, start_row ^ rows),
                  f"{tag}: acc != row_start ^ row_now")
    return inv


def same_as_sync(pool, sync, path, tag):
    """A windowed pool at its epoch boundary holds exactly what the
    synchronous pool does after the same commits."""
    a, b = pool.prot, sync.prot
    for field in ("synd", "cksums", "digest", "row", "step"):
        x, y = getattr(a, field), getattr(b, field)
        check((x is None and y is None) or torch.equal(x, y),
              f"{tag}: {field} != the synchronous pool's")
    for field in ("digest", "mark", "step"):
        check(torch.equal(getattr(a.log, field), getattr(b.log, field)),
              f"{tag}: log.{field} != the synchronous pool's")
    emit(path=path, phase=tag, same_as_sync=True)


class Lockstep:
    """A windowed pool and a synchronous one fed the same states; the
    synchronous commits run outside the clock, their launches uncounted."""

    def __init__(self, run, pool, sync, cur, sync_kw=None):
        self.run, self.pool, self.sync, self.cur = run, pool, sync, cur
        self.sync_kw = sync_kw or {}
        self.since_start()

    def since_start(self):
        self.start_row = self.pool.prot.row.clone()
        self.start_synd = self.pool.prot.synd.clone()

    def commit(self, tag, new, boundary=False, **kw):
        def go():
            check(bool(self.pool.commit(new, data_cursor=self.step, **kw)),
                  f"{tag}: commit failed")
        self.step = self.pool.step + 1
        inv = None if boundary else window_invariants(self.start_row,
                                                      self.start_synd)
        _, launched = self.run.phase(tag, go, self.pool, inv)
        self.run.aside(lambda: self.sync.commit(
            new, data_cursor=self.step, **self.sync_kw))
        self.cur = new
        if boundary:
            same_as_sync(self.pool, self.sync, self.run.tag, tag)
            self.since_start()
        return launched


def window_path_w3(dev):
    """The bulk engine, streamed, at r = 3 (phases W_a-W_i)."""
    from repro_torch import Fault
    from repro_torch.runtime import failure

    mesh, specs, cur = zone_state(dev)
    cfg = dict(mode="mlpc", redundancy=R)
    run = PathRun(dev, "w3")
    pool, l_a = run.phase("W_a_open_window_4", lambda: open_pool(
        cur, specs, mesh, dev, window=4, **cfg))
    check(pool.engine.window == 4 and not pool.engine.patch and
          pool.protector.stream_chunk() is not None, "w3: engine")
    check(l_a == {"fletcher_blocks": 1, "sdelta_stack": 1},
          f"W_a launches {l_a}")
    sync = run.aside(lambda: open_pool(cur, specs, mesh, dev, **cfg))
    ls = Lockstep(run, pool, sync, cur)
    for i in (1, 2, 3):
        got = ls.commit(f"W_b_commit_{i}", bumped(ls.cur))
        check(got == {"fused_accum_commit_stream": 1},
              f"W_b commit {i} launches {got}")
    got = ls.commit("W_c_commit_4_flush", bumped(ls.cur), boundary=True)
    check(got == {"fused_accum_commit_stream": 1, "sdelta_stack": 1},
          f"W_c launches {got}")
    ls.commit("W_d_commit_5", bumped(ls.cur))

    def canary_abort():
        est = pool._est
        fields = (est.prot.row, est.prot.synd, est.prot.cksums,
                  est.prot.digest, est.prot.step, est.prot.log.mark,
                  est.acc, est.pending)
        zeros = {k: torch.zeros_like(v) for k, v in ls.cur.items()}
        with pool.transaction() as tx:
            tx.watch(failure.smashed_canary_buffer(4096, device=dev))
            tx.stage(zeros)
        check(tx.aborted and not tx.ok, "canary did not abort")
        now = pool._est
        for a, b in zip(fields, (now.prot.row, now.prot.synd,
                                 now.prot.cksums, now.prot.digest,
                                 now.prot.step, now.prot.log.mark, now.acc,
                                 now.pending)):
            check(torch.equal(a, b), "an abort changed the window")
        check(pool.engine._since == 2, "an abort is an attempt")
    _, l_e = run.phase("W_e_canary_abort_mid_window", canary_abort, pool,
                       window_invariants(ls.start_row, ls.start_synd))
    check(not l_e, f"W_e launches {l_e}")
    ls.commit("W_f_commit_6", bumped(ls.cur))
    del ls, sync
    before_loss = pool.prot.row.clone()

    def multi_loss():
        # the loss lands inside the open window: the window's bookkeeping
        # is kept, so the recovery's flush still sees the accumulator
        prot, event = failure.inject_multi_rank_loss(pool.protector,
                                                     pool.prot, MULTI_LOST)
        pool._est = dataclasses.replace(pool._est, prot=prot)
        rep = pool.recover(Fault.from_event(event))
        check(rep.verified and rep.reverified and rep.synd_ok == [True] * R
              and rep.window_bound == {"pending": 2, "dirty_pages": None,
                                       "digest_verified": True},
              f"recovery {rep}")
        check(pool.engine.window == 1, "failure suspicion: window 1")
    _, l_g = run.phase("W_g_multi_loss_recover", multi_loss, pool)
    check(l_g.get("sdelta_stack", 0) >= 2 and l_g.get("gf_scale", 0) >= 1,
          f"W_g launches {l_g}")
    check(torch.equal(pool.prot.row, before_loss), "W_g: rows differ")
    del before_loss

    def scrub():
        report = pool.scrub()
        check(not report.suspect and report.synd_ok == [True] * R,
              f"scrub {report}")
        check(pool.engine.window == 2, "a clean scrub regrows the window")
    run.phase("W_h_scrub", scrub, pool)
    return run.end(PATH_W3)


def window_path_w1f(dev):
    """The bulk engine on the flat kernel at r = 1 (phases V_a-V_c)."""
    mesh, specs, cur = zone_state(dev)
    cfg = dict(mode="mlpc", stream_threshold_words=1 << 22)
    run = PathRun(dev, "w1f")
    pool, l_a = run.phase("V_a_open_window_4", lambda: open_pool(
        cur, specs, mesh, dev, window=4, **cfg))
    check(pool.protector.stream_chunk() is None, "w1f: flat route")
    sync = run.aside(lambda: open_pool(cur, specs, mesh, dev, **cfg))
    ls = Lockstep(run, pool, sync, cur)
    for i in (1, 2, 3):
        got = ls.commit(f"V_b_commit_{i}", bumped(ls.cur))
        check(got == {"fused_accum_commit": 1}, f"V_b launches {got}")
    got = ls.commit("V_c_commit_4_flush", bumped(ls.cur), boundary=True)
    check(got == {"fused_accum_commit": 1}, f"V_c launches {got}")
    return run.end(PATH_W1F)


def window_path_wp(dev):
    """The patch engine at r = 3, mode mlp, on the w_tp leaf (phases
    P_a-P_c)."""
    from repro_torch.core import layout

    mesh, specs, cur = zone_state(dev)
    cfg = dict(mode="mlp", redundancy=R)
    run = PathRun(dev, "wp")
    pool, l_a = run.phase("P_a_open_window_8", lambda: open_pool(
        cur, specs, mesh, dev, window=8, pool_kw={"dirty_leaf_idx": [2]},
        **cfg))
    lo, eng = pool.protector.layout, pool.engine
    pages = layout.leaf_pages(lo, 2).tolist()
    check(lo.slots[2].shape == (64, BW) and len(pages) == WP_PAGES and
          eng.flush_patch and eng.flush_capacity == FLUSH_SLOTS,
          f"wp: engine {eng.flush_patch} {eng.flush_capacity}")
    sync = run.aside(lambda: open_pool(cur, specs, mesh, dev, **cfg))
    ls = Lockstep(run, pool, sync, cur, sync_kw={"dirty_pages": pages})
    n_words = lo.slots[2].n_words

    def w_tp(st, i):
        w = st["w_tp"].clone()
        w[4 * i:4 * i + 4] += 1.0          # 4 rows = 2048 words a rank
        return {"w_fsdp": st["w_fsdp"], "w_tp": w, "scale": st["scale"]}
    for i in range(1, 8):
        kw = {}
        if i == 3:                             # the changed words named,
            words = torch.arange(4 * i * BW // 2, (4 * i + 4) * BW // 2)
            kw["dirty_words"] = (torch.cat([words, torch.tensor(
                [n_words, n_words + 5000])]),)  # + indices past the leaf
        got = ls.commit(f"P_b_commit_{i}", w_tp(ls.cur, i), **kw)
        check(not got, f"P_b commit {i} launches {got}")
    got = ls.commit("P_c_commit_8_flush", w_tp(ls.cur, 8), boundary=True)
    check(got == {"xor_delta": 1, "sdelta_stack": 1}, f"P_c launches {got}")
    return run.end(PATH_WP)


# -- 6. the async commit ring and tenancy ------------------------------------

def same_prot(a, b, tag):
    """Two protected states byte for byte: every protection field, the redo
    log and the state leaves."""
    for field in ("synd", "cksums", "digest", "row", "step"):
        x, y = getattr(a, field), getattr(b, field)
        check((x is None and y is None) or torch.equal(x, y),
              f"{tag}: {field} differs")
    for field in ("step", "data_cursor", "rng", "digest", "mark"):
        check(torch.equal(getattr(a.log, field), getattr(b.log, field)),
              f"{tag}: log.{field} differs")
    for k in a.state:
        check(torch.equal(a.state[k], b.state[k]), f"{tag}: state.{k} differs")


def same_pool(pool, other, tag):
    """A pool against its comparison pool: the protected state and, with a
    window open, the accumulator and the pending count."""
    same_prot(pool.prot, other.prot, tag)
    if pool.engine is not None:
        check(torch.equal(pool._est.acc, other._est.acc) and
              torch.equal(pool._est.pending, other._est.pending) and
              pool.engine._since == other.engine._since,
              f"{tag}: open window differs")


# the caching allocator's counters that a dispatch must leave alone: a
# retry frees cached segments (a cudaFree, which syncs the device) and
# allocates again; a device alloc is a cudaMalloc of a new segment
ALLOC_COUNTS = ("num_alloc_retries", "num_device_free", "num_device_alloc")


def alloc_counts():
    stats = torch.cuda.memory_stats()
    return {k: stats.get(k, 0) for k in ALLOC_COUNTS}


class Dispatches:
    """Host ms of each commit_async (or wave) dispatch, and the allocator
    counters it moved (`alloc`, only the ones that moved).  Every dispatch
    into a ring that is not full runs under torch.cuda.set_sync_debug_mode(
    "error"): a host sync there raises and fails the run, and so does an
    allocator retry or cudaFree, which the debug mode does not see (a full
    ring resolves its oldest ticket, a sync by design)."""

    def __init__(self):
        self.ms, self.alloc, self.strict = [], [], 0

    def __call__(self, ring, fn):
        strict = len(ring) < ring.depth
        before = alloc_counts()
        if strict:
            torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            self.ms.append((time.perf_counter() - t0) * 1e3)
            if strict:
                torch.cuda.set_sync_debug_mode("default")
                self.strict += 1
            moved = {k: v - before[k] for k, v in alloc_counts().items()
                     if v != before[k]}
            self.alloc.append(moved)
            check(not strict or not (moved.get("num_alloc_retries")
                                     or moved.get("num_device_free")),
                  f"dispatch {len(self.ms)} into a ring not full: "
                  f"allocator {moved}")


def feed(pool, commits):
    """A comparison pool's commit_async of each (state, keywords), each
    verdict read before the next dispatch: synchronous resolution."""
    for state, kw in commits:
        pool.commit_async(state, **kw).result()
    pool.drain()


def nothing(pool, tag):
    """No invariants for a phase (its pool is compared byte for byte)."""


def async_path_q3(dev):
    """The async ring on the synchronous engine at r = 3, depth 4 (phases
    Q_a-Q_h), against a depth-1 pool fed the same states and verdicts."""
    from repro_torch import Fault
    from repro_torch.runtime import failure

    mesh, specs, cur = zone_state(dev)
    cfg = dict(mode="mlpc", redundancy=R)
    run = PathRun(dev, "q3")
    pool, _ = run.phase("Q_a_open_depth_4", lambda: open_pool(
        cur, specs, mesh, dev, pipeline_depth=4, **cfg))
    ring = pool._ring
    ref = run.aside(lambda: open_pool(cur, specs, mesh, dev,
                                      pipeline_depth=1, **cfg))
    tx = pool.transaction()
    tx.watch(failure.smashed_canary_buffer(4096, device=dev))
    canary = tx.canary_device()            # staged: read on the device
    patch, dirty = patch_pages(pool.protector.layout)
    states = [cur, bumped(cur)]
    states.append(bumped(states[-1], words=patch))
    warm = [(states[1], dict(data_cursor=1, verify_old=True)),
            (states[1], dict(data_cursor=2, canary_ok=canary)),
            (states[2], dict(data_cursor=3, dirty_pages=dirty))]

    def warm_up():
        feed(pool, warm)
    run.phase("Q_a_warm_up_first_use", warm_up, pool)
    run.timed_aside("Q_a_warm_up_depth_1", lambda: feed(ref, warm))
    same_pool(pool, ref, "Q_a")
    states = states[2:]
    for _ in range(8):
        states.append(bumped(states[-1]))
    kws = [dict(verify_old=True) if i == 2 else
           dict(canary_ok=canary) if i == 4 else {} for i in range(8)]
    disp = Dispatches()
    aborted = pool.stats()["aborted_commits"]

    def bulk():
        return [disp(ring, lambda i=i: pool.commit_async(
            states[i + 1], data_cursor=i + 1, **kws[i])) for i in range(8)]
    tickets, l_b = run.phase("Q_b_8_bulk_commit_async", bulk, inv=nothing)
    del warm
    emit(path="q3", phase="Q_b_dispatch_ms", ms=disp.ms[:8],
         alloc=disp.alloc[:8])
    check(l_b.get("fused_verify_commit_s_stream") == 1 and
          l_b.get("fletcher_stream") == 7, f"Q_b launches {l_b}")

    def poll_drain():
        polled = pool.poll()
        return len(polled), len(pool.drain())
    (polled, drained), _ = run.phase("Q_c_poll_drain", poll_drain,
                                     inv=nothing)
    verdicts = [t.result() for t in tickets]
    check(verdicts == [i != 4 for i in range(8)], f"Q_c verdicts {verdicts}")
    check(pool.stats()["aborted_commits"] == aborted + 1,
          "Q_c: the staged abort")
    emit(path="q3", phase="Q_c_polled_drained", polled=polled,
         drained=drained)
    run.timed_aside("Q_d_8_bulk_depth_1", lambda: feed(ref, [
        (states[i + 1], dict(data_cursor=i + 1, **kws[i]))
        for i in range(8)]))
    same_pool(pool, ref, "Q_d")
    invariants(pool, "Q_d")
    emit(path="q3", phase="Q_d_drained_same_as_depth_1", equal=True)
    cur = states[-1]
    del states, tickets
    patches = [cur]
    for _ in range(16):
        patches.append(bumped(patches[-1], words=patch))

    def patch_16():
        out = [disp(ring, lambda i=i: pool.commit_async(
            patches[i + 1], data_cursor=9 + i, dirty_pages=dirty))
            for i in range(16)]
        pool.drain()
        return out
    tickets, l_e = run.phase("Q_e_16_patch_depth_4", patch_16, inv=nothing)
    emit(path="q3", phase="Q_e_dispatch_ms", ms=disp.ms[8:],
         alloc=disp.alloc[8:])
    check(all(t.result() for t in tickets), "Q_e: a patch failed")
    check(l_e.get("fused_commit_s") == 16, f"Q_e launches {l_e}")
    run.timed_aside("Q_f_16_patch_depth_1", lambda: feed(ref, [
        (patches[i + 1], dict(data_cursor=9 + i, dirty_pages=dirty))
        for i in range(16)]))
    same_pool(pool, ref, "Q_f")
    emit(path="q3", phase="Q_f_drained_same_as_depth_1", equal=True)
    cur = patches[-1]
    del patches, tickets
    before = [cur]
    for _ in range(3):
        before.append(bumped(before[-1]))

    def loss_in_flight():
        burst = [disp(ring, lambda i=i: pool.commit_async(
            before[i + 1], data_cursor=25 + i)) for i in range(3)]
        check(pool.in_flight == 3, f"in flight {pool.in_flight}")
        pool.prot, event = failure.inject_multi_rank_loss(
            pool.protector, pool.prot, MULTI_LOST)
        rep = pool.recover(Fault.from_event(event))
        check(rep.verified and rep.reverified and rep.synd_ok == [True] * R
              and pool.in_flight == 0 and all(t.result() for t in burst),
              f"recovery {rep}")
    _, l_g = run.phase("Q_g_loss_with_3_in_flight", loss_in_flight,
                       inv=nothing)
    check(l_g.get("gf_scale", 0) >= 1, f"Q_g launches {l_g}")
    run.aside(lambda: feed(ref, [(before[i + 1], dict(data_cursor=25 + i))
                                 for i in range(3)]))
    same_pool(pool, ref, "Q_h")
    invariants(pool, "Q_h")
    emit(path="q3", phase="Q_h_recovered_same_as_depth_1", equal=True,
         strict_dispatches=disp.strict)
    check(disp.strict >= 4 + 4, f"strict dispatches {disp.strict}")
    return run.end(PATH_Q3)


def async_path_qw(dev):
    """The w3 configuration (bulk engine, streamed, r = 3, window 4) at
    depth 4 (phases X_a-X_e): eight commit_async, the third a staged abort
    mid-window, each boundary against the synchronous engine."""
    from repro_torch.kernels import ops

    mesh, specs, cur = zone_state(dev)
    cfg = dict(mode="mlpc", redundancy=R)
    run = PathRun(dev, "qw")
    pool, _ = run.phase("X_a_open_window_4_depth_4", lambda: open_pool(
        cur, specs, mesh, dev, window=4, pipeline_depth=4, **cfg))
    sync = run.aside(lambda: open_pool(cur, specs, mesh, dev, **cfg))
    abort = run.aside(lambda: ops.stage_verdict(
        [torch.zeros((), dtype=torch.bool, device=dev)]))
    disp, ring = Dispatches(), pool._ring
    for w, tag in ((0, "X_b"), (1, "X_d")):
        states = [cur]
        for _ in range(4):
            states.append(bumped(states[-1]))
        kws = [dict(canary_ok=abort) if (w, i) == (0, 2) else {}
               for i in range(4)]

        def window(states=states, kws=kws):
            out = [disp(ring, lambda i=i: pool.commit_async(
                states[i + 1], data_cursor=4 * w + i + 1, **kws[i]))
                for i in range(4)]
            pool.drain()
            return out
        tickets, launched = run.phase(f"{tag}_4_commit_async_drain", window,
                                      inv=nothing)
        # the staged abort runs the all-clear step too, then selects
        want = {"fused_accum_commit_stream": 4, "sdelta_stack": 1}
        check(launched == want, f"{tag} launches {launched}")
        check([t.result() for t in tickets] == [(w, i) != (0, 2)
                                                for i in range(4)],
              f"{tag} verdicts")
        check(pool.engine._since == 0, f"{tag}: not at a boundary")
        run.aside(lambda states=states, kws=kws: feed(sync, [
            (states[i + 1], dict(data_cursor=4 * w + i + 1, **kws[i]))
            for i in range(4)]))
        same_as_sync(pool, sync, "qw", f"{tag}_boundary")
        cur = states[-1]
        del states, tickets
    emit(path="qw", phase="X_dispatch_ms", ms=disp.ms, alloc=disp.alloc,
         strict_dispatches=disp.strict)
    check(disp.strict == 8, f"strict dispatches {disp.strict}")
    invariants(pool, "X_e")
    return run.end(PATH_QW)


def tenant_states(cur, n):
    """n tenants' distinct states of the main path's shapes."""
    return [{"w_fsdp": cur["w_fsdp"] + t,
             "w_tp": (cur["w_tp"] * (t + 1)).to(torch.bfloat16),
             "scale": cur["scale"] + t} for t in range(n)]


def tenancy_path(dev, tag, window):
    """A PoolGroup of T tenants of the main path's state in one cohort
    (mlpc, r = 3; `window` 1: the sync engine, 4: the bulk deferred
    engine), every wave against solo pools replayed on the same states
    outside the clock.  Returns the path's launch counts."""
    from repro_torch import Fault
    from repro_torch.runtime import failure
    from repro_torch.tenancy import PoolGroup

    mesh, specs, base = zone_state(dev)
    cfg = dict(mode="mlpc", redundancy=R, window=window)
    run = PathRun(dev, tag)
    tids = [f"t{t}" for t in range(TENANTS)]
    cur = dict(zip(tids, tenant_states(base, TENANTS)))
    del base

    def admit():
        from repro_torch import ProtectConfig
        group = PoolGroup(mesh, device=dev, pipeline_depth=2,
                          scrub_page_budget=2 * G * PAGES)
        for tid in tids:
            group.admit(tid, cur[tid], specs, config=ProtectConfig(**cfg))
        return group
    group, l_a = run.phase(f"{tag}_a_admit_{TENANTS}", admit, inv=nothing)
    check(len(group.cohorts) == 1, f"{tag}: cohorts {group.stats()}")
    solos = run.aside(lambda: {tid: open_pool(cur[tid], specs, mesh, dev,
                                              **cfg) for tid in tids})
    waves = []

    def wave(name, want=None, tenants=None, **kw):
        """One wave of bumped states: timed, its launches checked, then
        replayed on the solo pools and compared."""
        tenants = tenants or tids
        ups = {tid: bumped(cur[tid]) for tid in tenants}
        can = kw.get("canary_ok", True)
        oks, launched = run.phase(name, lambda: group.commit(ups, **kw),
                                  inv=nothing)
        check(want is None or launched == want,
              f"{name} launches {launched}, want {want}")
        waves.append((name, launched))

        def replay():
            for tid in tenants:
                c = can.get(tid, True) if isinstance(can, dict) else can
                solos[tid].commit(ups[tid], canary_ok=c,
                                  verify_old=kw.get("verify_old", False))
                check(bool(oks[tid]) == c, f"{name}: {tid} verdict")
        run.aside(replay)
        for tid in tenants:
            same_pool(group[tid].pool, solos[tid], f"{name} {tid}")
            if bool(oks[tid]):
                cur[tid] = ups[tid]
        return oks

    if window == 1:
        bulk = {"fletcher_blocks": 1, "sdelta_stack": 1}
        wave(f"{tag}_b_bulk_wave", bulk)
        wave(f"{tag}_c_verify_wave", {"fused_verify_commit_s": 1},
             verify_old=True)
        wave(f"{tag}_d_canary_fails_t2", bulk,
             canary_ok={tid: tid != "t2" for tid in tids})
        wave(f"{tag}_e_looped_wave", {"fletcher_stream": TENANTS,
                                      "sdelta_stack": TENANTS},
             batched=False)
        disp = Dispatches()
        ring = group._ring

        def async_waves():
            ups = [{tid: bumped(cur[tid]) for tid in tids}]
            ups.append({tid: bumped(ups[0][tid]) for tid in tids})
            tickets = [disp(ring, lambda u=u: group.commit_async(u))
                       for u in ups]
            group.drain()
            return ups, tickets
        (ups, tickets), l_f = run.phase(f"{tag}_f_2_waves_async_drain",
                                        async_waves, inv=nothing)
        check(l_f == {k: 2 for k in bulk} and
              all(t.result() for t in tickets), f"{tag}_f launches {l_f}")
        emit(path=tag, phase=f"{tag}_f_dispatch_ms", ms=disp.ms,
             alloc=disp.alloc, strict_dispatches=disp.strict)
        check(disp.strict == 2, f"strict dispatches {disp.strict}")
        run.aside(lambda: [solos[tid].commit(u[tid]) for u in ups
                           for tid in tids])
        for tid in tids:
            cur[tid] = ups[-1][tid]
            same_pool(group[tid].pool, solos[tid], f"{tag}_f {tid}")
        del ups, tickets

        def scrub_tick():
            served = group.scrub_tick()
            check(len(served) == 2 and not any(rep.suspect for *_, rep
                                               in served),
                  f"scrub_tick {served}")
            return [(tid, kind) for tid, kind, _ in served]
        served, _ = run.phase(f"{tag}_g_scrub_tick_2_pools", scrub_tick,
                              inv=nothing)
        emit(path=tag, phase=f"{tag}_g_served", served=served)

        def recover_beside_a_wave():
            victim = group["t1"].pool
            victim.prot, event = failure.inject_multi_rank_loss(
                victim.protector, victim.prot, MULTI_LOST)
            others = [tid for tid in tids if tid != "t1"]
            ups = {tid: bumped(cur[tid]) for tid in others}
            ticket = group.commit_async(ups)
            rep = group.recover("t1", Fault.from_event(event))
            check(rep.verified and rep.reverified and
                  group.quarantined == (), f"recovery {rep}")
            group.drain()
            check(ticket.result(), "the wave beside the recovery failed")
            return ups
        ups, l_h = run.phase(f"{tag}_h_recover_t1_beside_a_wave",
                             recover_beside_a_wave, inv=nothing)
        check(l_h.get("fletcher_blocks", 0) >= 1 and
              l_h.get("gf_scale", 0) >= 1, f"{tag}_h launches {l_h}")
        run.aside(lambda: [solos[tid].commit(ups[tid]) for tid in ups])
        for tid in tids:
            cur[tid] = ups.get(tid, cur[tid])
            same_pool(group[tid].pool, solos[tid], f"{tag}_h {tid}")
        # t1, left out of the wave, holds its own bytes, not the 4-stacks
        row = group["t1"].pool.prot.row
        check(row.untyped_storage().nbytes() == row.nbytes,
              f"{tag}_h: t1's row holds {row.untyped_storage().nbytes()} B")
    else:
        step = {"fused_accum_commit": 1}
        for i in range(1, 4):
            wave(f"{tag}_b_wave_{i}", step)
        wave(f"{tag}_c_wave_4_flush", dict(step, sdelta_stack=1))
    for tid in tids:
        invariants(group[tid].pool, f"{tag} {tid}")
    emit(path=tag, phase=f"{tag}_same_as_solo_pools", equal=True,
         tenants=TENANTS, waves=[w for w, _ in waves])
    return run.end(PATH_TG if window == 1 else PATH_TW)


# -- 7. elastic rescale, straggler mitigation and the chaos campaign ---------

EL_SHAPES = ((G // 2, 2), (G, 1))   # the rescales' meshes, 50 x 2 and 100 x 1
STRAGGLER = 37                      # the rank the straggler phase slows
CH_BYTES = G * PAGES * BW * 4       # the chaos workload: the main zone's rows
CH_TENANT_BYTES = CH_BYTES // 4     # each of multi_tenant_interference's
                                    # 8 live tenants (two groups of four)


def zone_mesh(shape):
    from repro_torch import ZoneMesh
    return ZoneMesh(shape, ("data", "model"))


def same_as_fresh(run, pool, cur, specs, cfg, tag):
    """A rescaled pool holds what a pool freshly opened on its mesh from the
    same global state holds, but for the step, which the rescale carries."""
    fresh = run.aside(lambda: open_pool(cur, specs, pool.mesh, run.dev,
                                        **cfg))
    for field in ("synd", "cksums", "digest", "row"):
        check(torch.equal(getattr(pool.prot, field),
                          getattr(fresh.prot, field)),
              f"{tag}: {field} != a fresh pool's")
    for k in pool.prot.state:
        check(torch.equal(pool.prot.state[k], fresh.prot.state[k]),
              f"{tag}: state.{k} != a fresh pool's")
    emit(path=run.tag, phase=tag, same_as_fresh_pool=True,
         ranks=pool.protector.group_size)


def rescale_walk(run, specs, cur, tag, cfg, want_rescale):
    """Open a pool of `cfg` on the main zone, then commit, rescale to 50 x 2,
    commit, rescale to 100 x 1, commit; a windowed pool holds each commit
    in its window, so each rescale flushes it first.  After each rescale:
    the invariants at the new G, the same bytes as a fresh pool, the step
    carried."""
    pool, _ = run.phase(f"L_{tag}_a_open", lambda: open_pool(
        cur, specs, zone_mesh(EL_SHAPES[1]), run.dev, **cfg))
    for i, shape in enumerate((*EL_SHAPES, None), start=1):
        new = bumped(cur)
        inv = None
        if pool.engine is not None:
            inv = window_invariants(pool.prot.row.clone(),
                                    pool.prot.synd.clone())

        def go():
            check(bool(pool.commit(new, data_cursor=i)), "commit failed")
        run.phase(f"L_{tag}_commit_{i}", go, pool, inv)
        cur = new
        if pool.engine is not None:
            check(pool.engine.needs_flush, f"{tag}: no commit pending")
        if shape is None:
            break
        target = zone_mesh(shape)
        moved, launched = run.phase(f"L_{tag}_rescale_{shape[0]}x{shape[1]}",
                                    lambda: pool.rescale(target))
        check(launched == want_rescale, f"{tag} rescale launches {launched}")
        check(moved.protector.group_size == shape[0] and moved.step == i,
              f"{tag}: G {moved.protector.group_size}, step {moved.step}")
        if moved.engine is not None:
            check(not moved.engine.needs_flush, f"{tag}: window not empty")
            window_invariants(moved.prot.row, moved.prot.synd)(
                moved, f"{tag} rescaled")
        same_as_fresh(run, moved, cur, specs, cfg, f"L_{tag}_{i}_fresh")
        pool = moved


def elastic_path(dev):
    """Rescale and straggler mitigation on the main zone (phases L_*)."""
    import numpy as np
    from repro_torch import ProtectConfig
    from repro_torch.tenancy import PoolGroup

    _, specs, cur = zone_state(dev)
    run = PathRun(dev, "el")
    init = {"fletcher_blocks": 1, "sdelta_stack": 1}
    rescale_walk(run, specs, cur, "sync", dict(mode="mlpc", redundancy=R),
                 init)
    rescale_walk(run, specs, cur, "w3",
                 dict(mode="mlpc", redundancy=R, window=4),
                 dict(init, sdelta_stack=2))       # + the flush's

    # a window-8 pool whose rank 37 runs 6x slow: dropped, the window held
    # at 1 and the pool degraded; then healed, and the window regrows
    cfg = dict(mode="mlpc", redundancy=R, window=8, straggler_threshold=2.0,
               window_growth_commits=4)
    mesh = zone_mesh(EL_SHAPES[1])
    pool, _ = run.phase("L_s_a_open_window_8", lambda: open_pool(
        cur, specs, mesh, dev, **cfg))
    check(pool.straggler.n_replicas == G and pool.engine.window == 8,
          "straggler pool")
    healthy = np.full(G, 0.01)
    slow = healthy.copy()
    slow[STRAGGLER] *= 6

    def commit():
        nonlocal cur
        cur = bumped(cur)
        check(bool(pool.commit(cur)), "commit failed")

    def drop():
        for _ in range(2):
            commit()
            pool.observe_commit_times(slow)
        check(pool.dropped_replicas == [STRAGGLER] and
              pool.engine.window == 1 and
              pool.health().status == "degraded",
              f"straggler: dropped {pool.dropped_replicas}, window "
              f"{pool.engine.window}, {pool.health().reasons}")
    run.phase("L_s_b_rank_37_slow", drop, pool)

    def heal():
        for n in range(1, 13):
            pool.observe_commit_times(healthy)
            if not pool.dropped_replicas:
                break
        check(not pool.dropped_replicas, "straggler never healed")
        for k in range(1, 9):
            commit()
            if pool.engine.window > 1:
                return {"observations": n, "commits_to_regrow": k}
        raise AssertionError("the window did not regrow")
    healed, _ = run.phase("L_s_c_heal_regrow", heal, pool)
    emit(path="el", phase="L_s_window", window=pool.engine.window,
         counters={k: pool.metrics.counter(k).value for k in (
             "pool_straggler_drop_total", "pool_straggler_heal_total")},
         **healed)
    del pool

    # PoolGroup.rescale of two full-width tenants, 100 x 1 -> 50 x 2, each
    # against a solo pool rescaled the same way
    tids = ("t0", "t1")
    states = dict(zip(tids, tenant_states(cur, 2)))
    gcfg = dict(mode="mlpc", redundancy=R)

    def admit():
        group = PoolGroup(mesh, device=dev)
        for tid in tids:
            group.admit(tid, states[tid], specs,
                        config=ProtectConfig(**gcfg))
        return group
    group, _ = run.phase("L_g_a_admit_2", admit, inv=nothing)
    target = zone_mesh(EL_SHAPES[0])
    moved, launched = run.phase("L_g_b_group_rescale",
                                lambda: group.rescale(target), inv=nothing)
    check(launched == {k: 2 for k in init}, f"L_g_b launches {launched}")
    del group
    for tid in tids:
        pool = moved[tid].pool
        check(pool.protector.group_size == EL_SHAPES[0][0], "group G")
        invariants(pool, f"L_g {tid}")
        solo = run.aside(lambda: open_pool(states[tid], specs, mesh, dev,
                                           **gcfg).rescale(target))
        same_prot(pool.prot, solo.prot, f"L_g {tid}")
        del solo
    emit(path="el", phase="L_g_same_as_solo_pools", equal=True,
         tenants=len(tids))
    return run.end(PATH_EL)


def traffic_sample(dev):
    """The chaos workload's initial state and three traffic steps made on
    the card, a sample held against the reference's host form (uint64
    numpy) and the steps on the CPU."""
    import numpy as np
    from repro_torch.chaos import workload
    n = CH_BYTES // 4
    w = workload.initial_state(n, SEED, dev)
    idx = torch.cat([torch.arange(0, n, 4099), torch.arange(n - 4096, n)])
    u = idx.numpy().astype(np.uint64)
    host = ((u * np.uint64(2654435761) + np.uint64(SEED * 97 + 1))
            % np.uint64(1000003)).astype(np.float32) / np.float32(1000.0)
    on_card = idx.to(dev)
    check(np.array_equal(w[on_card].cpu().numpy(), host),
          "initial state != the host form")
    sample = torch.from_numpy(host)
    fma_ms = []
    for t in range(3):
        c = np.float32(t % workload.PERIOD) * workload.STEP_BIAS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w = workload.fma(w, workload.GAIN, c)
        torch.cuda.synchronize()
        fma_ms.append((time.perf_counter() - t0) * 1e3)
        sample = workload.fma(sample, workload.GAIN, c)
        check(torch.equal(w[on_card].cpu(), sample),
              f"traffic step {t} on the card != the CPU's")
    return {"words": n, "sampled": int(idx.numel()), "fma_ms": fma_ms}


def chaos_path(dev):
    """Every scenario of the quick campaign and its first two storm cells
    at full width (phases C_*), each golden-exact with a valid trace."""
    from repro_torch.chaos import scenarios
    run = PathRun(dev, "ch")
    sampled, _ = run.phase("C_traffic_step_sample",
                           lambda: traffic_sample(dev), inv=nothing)
    emit(path="ch", phase="C_traffic_step_equal", **sampled)
    size = dict(quick=True, seed=SEED, meshes=EL_SHAPES, device=dev)
    jobs = [(name, functools.partial(
        scenarios.run_scenario, name, n_bytes=(
            CH_TENANT_BYTES if name == "multi_tenant_interference"
            else CH_BYTES), **size))
        for name in (*scenarios.SCENARIOS, *scenarios.GROUP_SCENARIOS)]
    jobs += [(f"storm_r{r}_w{w}", functools.partial(
        scenarios.run_storm_cell, r, w, n_bytes=CH_BYTES, **size))
        for r, w in scenarios.STORM_CELLS[:2]]
    results = []
    for name, job in jobs:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out, _ = run.phase(f"C_{name}", job, inv=nothing)
        results.append(out)
        emit(path="ch", phase=f"C_{name}_result",
             golden_exact=out["golden_exact"],
             trace_events=out["trace"]["events"],
             trace_violations=out["trace"]["violations"],
             commit_ms=out["commit_ms"], recovery_ms=out["recovery_ms"],
             rescale_ms=[r["ms"] for r in out["recoveries"]
                         if r["kind"] == "rescale"],
             recoveries=[{k: r[k] for k in ("kind", "ms", "verified")
                          if k in r} for r in out["recoveries"]],
             window_trace=out.get("window_trace"),
             health=out["health"]["status"])
        del out
    scenarios.check_results(results)
    return run.end(PATH_CH)



# -- 8. the serving plane -----------------------------------------------------

SV_ARCH = "qwen3-0.6b"           # served at its published width
SV_REDUCED = False               # True: the config's reduced() (a CPU rehearsal)
SV_MESH = (4, 2)                 # the reference launcher's default mesh
SV_BATCH, SV_MAX_LEN = 16, 2048  # max_len equals no other cache dim
SV_PROMPT, SV_NEW = 32, 32
SV_BW = 256                      # block_words, as launch/serve.py sets it
SV_SCRUB = 16                    # scrub_period, the launcher's default
SV_LOST = 1                      # the rank sv e loses
SV_MULTI_LOST = (0, 1, 3)        # the ranks sv f loses at once
SV_EVENT = 16                    # generated tokens before sv e / f's loss
# sv h: the bf16 decode's logits against an f32 forward of the same
# weights, as a share of the largest |logit|
SV_LOGIT_RTOL = 2 ** -4
PATH_SV = ("fletcher_blocks", "fused_commit", "fused_commit_s",
           "sdelta_stack", "gf_scale")
# the ops functions whose kernels a path may launch (sdelta_stack's is
# syndrome_scale)
PROBED = tuple(n for n in (
    "fletcher_blocks", "fletcher_stream", "fused_commit",
    "fused_verify_commit", "fused_commit_old_terms",
    "fused_verify_commit_stream", "fused_commit_stream",
    "fused_commit_old_terms_stream", "fused_accum_commit",
    "fused_accum_commit_stream", "xor_delta", "xor_accum", "gf_scale",
    "syndrome_scale", "fused_commit_s", "fused_verify_commit_s",
    "fused_commit_old_terms_s", "fused_commit_s_stream",
    "fused_verify_commit_s_stream"))


class CallProbe:
    """While entered, keeps a copy of the inputs of the first call that
    launched each kernel (the innermost ops function that launched it), so
    that afterwards each kernel can be held against its plain version on
    the card at the very inputs the path gave it.  `host=True` keeps the
    copies in host memory (the tr path's inputs run to 21 GB a call) and
    adds the time the copies take to `ms`, so that phases can report it
    apart; a kernel checked once is not recorded again."""

    def __init__(self, host=False):
        from repro_torch.kernels import _build, ops
        self.build, self.ops = _build, ops
        self.host = host
        self.calls: dict = {}
        self.done: set = set()
        self.ms = 0.0

    def __enter__(self):
        self.saved = {n: getattr(self.ops, n) for n in PROBED}
        for n, fn in self.saved.items():
            setattr(self.ops, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.ops, n, fn)
        return False

    def _keep(self, a):
        if not isinstance(a, torch.Tensor):
            return a
        return a.cpu() if self.host else a.clone()

    def _wrap(self, name, fn):
        def probed(*args, **kw):
            before = dict(self.build.LAUNCHES)
            out = fn(*args, **kw)
            new = [k for k, v in self.build.LAUNCHES.items()
                   if v > before.get(k, 0) and k not in self.calls
                   and k not in self.done]
            if new:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                keep = tuple(self._keep(a) for a in args)
                torch.cuda.synchronize()
                self.ms += (time.perf_counter() - t0) * 1e3
                for k in new:
                    self.calls[k] = (name, keep, kw)
            return out
        return probed

    def check(self, run, launched, by_rank=False):
        """Each kernel the path launched, on its recorded inputs, against
        the same ops function with the plain version forced; byte-equal.
        `by_rank`: the kernel runs on the whole recorded input and its
        plain version a data rank (the first lead index) at a time, each
        held against that rank's slice of the kernel's outputs: every
        kernel is per rank, and the plain versions' temporaries run to
        several times their input."""
        ops = self.ops
        missing = [k for k in launched
                   if k not in self.calls and k not in self.done]
        check(not missing, f"{run.tag}: no recorded call for {missing}")
        for kernel in sorted(self.calls):
            # each recorded input let go once checked; the peak of each
            # check (the plain version's temporaries) reported with it
            name, args, kw = self.calls.pop(kernel)
            self.done.add(kernel)
            run.peaks()
            args = tuple(a.to(run.dev) if isinstance(a, torch.Tensor) else a
                         for a in args)
            got = run.aside(lambda: getattr(ops, name)(*args, **kw))
            got = got if isinstance(got, tuple) else (got,)
            lead = args[0].shape[0]
            parts = ([tuple(a[i:i + 1] if isinstance(a, torch.Tensor)
                            and a.dim() and a.shape[0] == lead else a
                            for a in args) for i in range(lead)]
                     if by_rank else [args])
            on_card = ops._on_card
            ops._on_card = lambda x: False
            try:
                for i, part in enumerate(parts):
                    want = getattr(ops, name)(*part, **kw)
                    want = want if isinstance(want, tuple) else (want,)
                    mine = (tuple(g[i:i + 1] for g in got) if by_rank
                            else got)
                    check(len(mine) == len(want) and all(
                        torch.equal(a, b) for a, b in zip(mine, want)),
                        f"{run.tag}: {kernel} via {name} != its plain "
                        f"version" + (f" (rank {i})" if by_rank else ""))
                    del want
            finally:
                ops._on_card = on_card
            emit(path=run.tag, phase="k_kernel_vs_plain", kernel=kernel,
                 via=name, shapes=[list(a.shape) for a in args
                                   if isinstance(a, torch.Tensor)],
                 by_rank=by_rank, max_abs_err=0, equal=True,
                 max_memory_allocated=torch.cuda.max_memory_allocated(
                     run.dev))
            del args, got, parts


class StepClock:
    """Host ms of a runtime's steps by piece, each piece ending in a
    synchronize; a piece's ms leaves out the pieces nested in it.  For a
    server (`StepClock(srv)`): the decode step; the zone copies
    (`pool.state`, which unshards the cache for decode, and
    `Pool.to_zone`, which shards the new cache inside the commit); the
    commit less its to_zone; the scrub cadence (`maybe_scrub`); the
    footprint (`_dirty_pages` / `_dirty_words`: the pages or words a step
    dirties, from the layout on the host, kept by position).  Other
    runtimes pass their own `wraps`, (object, attribute, piece) each, and
    `off`, a clock of ms spent inside a piece that no piece should count
    (a CallProbe's copies)."""

    PIECES = ("decode", "zone_copies", "commit", "scrub", "footprint")

    def __init__(self, srv=None, wraps=None, pieces=None, off=None):
        self.ms = dict.fromkeys(pieces or self.PIECES, 0.0)
        self._open: list = []
        self._off = off or (lambda: 0.0)
        if wraps is None:
            wraps = [(srv, "_decode", "decode"),
                     (srv, "_current_cache", "zone_copies")]
            if srv.pool is not None:
                wraps += [(srv.pool, "to_zone", "zone_copies"),
                          (srv.pool, "commit", "commit"),
                          (srv.pool, "maybe_scrub", "scrub"),
                          (srv, "_dirty_pages", "footprint"),
                          (srv, "_dirty_words", "footprint")]
        for obj, attr, piece in wraps:
            self._wrap(obj, attr, piece)

    def _wrap(self, obj, attr, piece):
        fn = getattr(obj, attr)

        def timed(*args, **kw):
            torch.cuda.synchronize()
            self._open.append(0.0)
            off = self._off()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 - (self._off() - off)
            inner = self._open.pop()
            self.ms[piece] += ms - inner
            if self._open:
                self._open[-1] += ms
            return out
        setattr(obj, attr, timed)


def sv_model(dev):
    """The served model: config, mesh, random weights from SEED, the
    prompt from SEED + 1."""
    from repro_torch import ZoneMesh
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import build_model
    cfg = get_config(SV_ARCH, reduced=SV_REDUCED)
    mesh = ZoneMesh(SV_MESH, ("data", "model"))
    params = build_model(cfg, mesh).init(
        torch.Generator(dev).manual_seed(SEED), dev)
    prompt = torch.randint(0, cfg.vocab, (SV_BATCH, SV_PROMPT),
                           generator=torch.Generator(dev).manual_seed(
                               SEED + 1), device=dev)
    return cfg, mesh, params, prompt


def sv_server(dev, cfg, mesh, params, protect=True, **pcfg):
    from repro_torch import ProtectConfig
    from repro_torch.runtime.server import Server
    srv = Server(cfg, ProtectConfig(mode="mlpc", block_words=SV_BW,
                                    scrub_period=SV_SCRUB, **pcfg),
                 mesh, batch=SV_BATCH, max_len=SV_MAX_LEN,
                 protect_cache=protect, device=dev)
    srv.start(params)
    return srv


def sv_steps(srv, prompt, tok, upto, events=None):
    """`Server.generate` spelt out: decode from `srv.pos` up to position
    `upto` (prompt tokens while the position is in the prompt, then the
    last prediction), running `events[pos]()` after the step that reaches
    `pos`.  Returns (the last token, the tokens generated)."""
    out, n_prompt = [], prompt.shape[1]
    while srv.pos < upto:
        t = srv.pos
        tok = srv.step(prompt[:, t] if t < n_prompt else tok)
        if t >= n_prompt - 1:
            out.append(tok)
        if events and srv.pos in events:
            events[srv.pos]()
    return tok, out


def sv_tokens(srv, out):
    """Drain the ring (generate's boundary) and stack the tokens."""
    if srv.pool is not None:
        srv.pool.drain()
    return torch.stack(out, dim=1).cpu().numpy()


def sv_clocked(run, tag, srv, prompt, hook=None, n_new=SV_NEW):
    """Generate `n_new` tokens under a StepClock: the tokens, and the phase
    line's split of ms a decode step (each step decodes a token of every
    sequence of `prompt`)."""
    clock = StepClock(srv)
    if hook is not None:
        srv.add_step_hook(hook)
    batch = prompt.shape[0]
    steps = prompt.shape[1] + n_new - 1
    torch.cuda.synchronize()
    allocs = alloc_counts()
    t0 = time.perf_counter()
    toks = srv.generate(prompt, n_new)
    wall = (time.perf_counter() - t0) * 1e3
    allocs = {k: v - allocs[k] for k, v in alloc_counts().items()}
    split = {f"{k}_ms_per_step": v / steps for k, v in clock.ms.items()}
    split["other_ms_per_step"] = wall / steps - sum(split.values())
    emit(path=run.tag, phase=f"{tag}_split", steps=steps, batch=batch,
         wall_ms=wall, ms_per_step=wall / steps,
         tokens_per_s=batch * steps / wall * 1e3,
         generated_tokens_per_s=batch * n_new / wall * 1e3,
         alloc=allocs, **split)
    return toks


def host_same_as_fresh(run, host, tag):
    """A runtime's pool, flushed, holds the bytes of a pool freshly opened
    over its final state (uncounted: a comparison), which is then let
    go."""
    from repro_torch import Pool
    host.flush()
    pool = host.pool
    fresh = run.aside(lambda: Pool.open(
        pool.state, pool.state_specs, mesh=pool.mesh, config=pool.config,
        device=pool.device))
    for k in ("row", "synd", "cksums", "digest"):
        check(torch.equal(getattr(pool.prot, k), getattr(fresh.prot, k)),
              f"{tag}: {k} != a fresh pool's")
    del fresh
    gc.collect()
    emit(path=run.tag, phase=tag, equal_to_fresh_open=True,
         fields=["row", "synd", "cksums", "digest"], step=pool.step)


def sv_invariants(srv, tag):
    invariants(srv.pool, tag)


def plain_norm(x, scale):
    """RMS norm over the last axis, eps 1e-6."""
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * scale


def plain_conv(u, w, b):
    """A causal depthwise conv of width w.shape[0] over (B, S, C) as a
    grouped `conv1d`, in f32 proper (cuDNN would take TF32, a 10-bit
    mantissa, on the card)."""
    F = torch.nn.functional
    width, ch = w.shape
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return F.conv1d(F.pad(u.transpose(1, 2), (width - 1, 0)),
                        w.T[:, None, :], b, groups=ch).transpose(1, 2)


def plain_rglru(r, h):
    """The RG-LRU mixer in f32, apart from the port: the causal width-4
    conv as a grouped `conv1d`, the gates, and the recurrence h_t = a_t
    h_{t-1} + b_t run step by step (a loop over time, not a scan).
    (B, S, D) -> (B, S, D)."""
    F = torch.nn.functional
    gate = F.gelu(h @ r["wg"], approximate="tanh")
    u = plain_conv(h @ r["wr"], r["conv_w"], r["conv_b"])
    gr = torch.sigmoid(u * r["wa"] + r["ba"])
    gi = torch.sigmoid(u * r["wx"] + r["bx"])
    a = torch.exp(-8.0 * F.softplus(r["lam"] - 4.0) * gr)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * gi * u
    state, hs = torch.zeros_like(b[:, 0]), []
    for t in range(b.shape[1]):
        state = a[:, t] * state + b[:, t]
        hs.append(state)
    return (gate * torch.stack(hs, 1)) @ r["wo"]


def plain_mlstm(c, x, chunk=None):
    """An mLSTM block's residual branch in f32, apart from the port: the
    projections, the conv as `plain_conv`, and the matrix memory either
    stepped a position at a time (chunk None: C_t = f'_t C_{t-1} +
    i'_t k_t v_t^T with the stabilizer m_t = max(log f_t + m_{t-1}, i_t)),
    or in chunks of `chunk` positions written as masked log-weights: within
    a chunk position j reads source s <= j at F_j - F_s + i_s (F the
    chunk's cumulative log f) and the carried state at F_j + m, each
    stabilized by their max.  (B, S, D) -> (B, S, D)."""
    F = torch.nn.functional
    B, S, D = x.shape
    H, dh = c["wq"].shape[0], c["wq"].shape[1]
    di = H * dh
    up = plain_norm(x, c["norm"]["scale"]) @ c["w_up"]
    xin, z = up[..., :di], up[..., di:]
    u = F.silu(plain_conv(xin, c["conv_w"], c["conv_b"]))
    q = torch.einsum("bshe,hef->bshf", u.reshape(B, S, H, dh),
                     c["wq"]) / math.sqrt(dh)
    k = torch.einsum("bshe,hef->bshf", u.reshape(B, S, H, dh), c["wk"])
    v = torch.einsum("bshe,hef->bshf", xin.reshape(B, S, H, dh), c["wv"])
    g = u @ c["w_if"] + c["b_if"]
    ig, lf = g[..., :H], F.logsigmoid(g[..., H:])          # (B, S, H)
    C = x.new_zeros((B, H, dh, dh))
    n = x.new_zeros((B, H, dh))
    m = x.new_full((B, H), -1e30)
    hs = []
    if chunk is None:
        for t in range(S):
            m_new = torch.maximum(lf[:, t] + m, ig[:, t])
            ip = torch.exp(ig[:, t] - m_new)[..., None]
            fp = torch.exp(lf[:, t] + m - m_new)[..., None]
            C = fp[..., None] * C + ip[..., None] * (
                k[:, t, :, :, None] * v[:, t, :, None, :])
            n = fp * n + ip * k[:, t]
            m = m_new
            num = torch.einsum("bhd,bhde->bhe", q[:, t], C)
            den = torch.einsum("bhd,bhd->bh", q[:, t], n)
            hs.append(num / torch.maximum(den.abs(), torch.exp(-m))[..., None])
        h = torch.stack(hs, 1)
    else:
        for lo in range(0, S, chunk):
            sl = slice(lo, lo + chunk)
            L = min(chunk, S - lo)
            Fc = torch.cumsum(lf[:, sl], 1)                     # (B, L, H)
            lw = Fc[:, :, None] - Fc[:, None, :] + ig[:, None, sl]
            mask = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
            lw = torch.where(mask[None, :, :, None], lw, -math.inf)
            carry = Fc + m[:, None]                             # (B, L, H)
            mj = torch.maximum(carry, lw.amax(2))
            w = torch.exp(lw - mj[:, :, None])                  # (B, j, s, H)
            cw = torch.exp(carry - mj)
            qk = torch.einsum("bjhd,bshd->bjsh", q[:, sl], k[:, sl]) * w
            num = (torch.einsum("bjsh,bshe->bjhe", qk, v[:, sl])
                   + torch.einsum("bjhd,bhde->bjhe", q[:, sl], C)
                   * cw[..., None])
            den = qk.sum(2) + torch.einsum("bjhd,bhd->bjh", q[:, sl], n) * cw
            hs.append(num / torch.maximum(den.abs(), torch.exp(-mj))[..., None])
            # the state at the chunk's end
            end = lw[:, -1]                                     # (B, s, H)
            m_new = torch.maximum(carry[:, -1], end.amax(1))
            ws = torch.exp(end - m_new[:, None])
            cf = torch.exp(carry[:, -1] - m_new)
            C = cf[..., None, None] * C + torch.einsum(
                "bshd,bshe->bhde", ws[..., None] * k[:, sl], v[:, sl])
            n = cf[..., None] * n + torch.einsum("bsh,bshd->bhd", ws,
                                                 k[:, sl])
            m = m_new
        h = torch.cat(hs, 1)
    h = plain_norm(h.reshape(B, S, di), c["outnorm"])
    return (h * F.silu(z)) @ c["w_down"]


def plain_slstm(c, x):
    """An sLSTM block's residual branch in f32: the input's gate
    pre-activations, then the cell a position at a time (its gates read
    h_{t-1} through r_h), exponential input gate stabilized by m.
    (B, S, D) -> (B, S, D)."""
    F = torch.nn.functional
    B, S, D = x.shape
    gx = torch.einsum("bsd,dghe->bsghe", plain_norm(x, c["norm"]["scale"]),
                      c["w_in"])
    H, dh = gx.shape[3], gx.shape[4]
    cs, n, h = (x.new_zeros((B, H, dh)) for _ in range(3))
    n = n + 1e-6
    m = x.new_full((B, H, dh), -1e30)
    hs = []
    for t in range(S):
        g = gx[:, t] + torch.einsum("bhd,hdge->bghe", h, c["r_h"]) + c["bias"]
        lf = F.logsigmoid(g[:, 2])
        m_new = torch.maximum(lf + m, g[:, 1])
        ip, fp = torch.exp(g[:, 1] - m_new), torch.exp(lf + m - m_new)
        cs = fp * cs + ip * torch.tanh(g[:, 0])
        n = fp * n + ip
        h = torch.sigmoid(g[:, 3]) * cs / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return plain_norm(torch.stack(hs, 1).reshape(B, S, D),
                      c["outnorm"]) @ c["w_out"]


def plain_moe(f, h, cfg, groups=None, record=None, follow=None):
    """A routed-expert FFN in f32, apart from the port: softmax router,
    top k, gates renormalized; each expert's MLP on the tokens that chose
    it, gate-weighted and summed; the shared expert.  An expert's weights
    are widened to f32 (exact) when its MLP runs, so a stack is never
    widened whole.  `groups`: a train step's routing groups, each keeping
    an expert's first ceil(Tg k / E x capacity_factor) choices in (token,
    rank) order; None keeps every choice (a decode step's capacity is its
    whole group).  `record`: a list the (top k indices, kept mask) are
    appended to.  `follow`: (T, k) expert indices the tokens go to in
    place of the router's own top k (every choice kept), which `record`
    still gets.  Returns (out, aux: the load-balance and router-z
    terms)."""
    F = torch.nn.functional
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    B, S, D = h.shape
    T = B * S
    x = h.reshape(T, D)
    logits = x @ f["router"]
    probs = torch.softmax(logits, -1)
    idx = probs.topk(K, -1).indices
    keep = torch.ones_like(idx, dtype=torch.bool)
    if groups is not None:
        cap = max(math.ceil(T // groups * K / E * m.capacity_factor), 1)
        hot = F.one_hot(idx.reshape(groups, -1), E)       # (G, Tg K, E)
        rank = ((hot.cumsum(1) - 1) * hot).sum(-1)
        keep = (rank < cap).reshape(T, K)
    if record is not None:
        record.append((idx, keep))
    if follow is not None:
        check(groups is None, "plain_moe: follow keeps every choice")
        idx = follow.to(idx.device)
    gate = probs.gather(1, idx)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    out = torch.zeros_like(x)
    for e in range(E):
        tok, j = ((idx == e) & keep).nonzero(as_tuple=True)
        if tok.numel():
            xe = x[tok]
            wi, wg, wo = (f[n][e].float() for n in ("wi", "wg", "wo"))
            ye = (F.silu(xe @ wg) * (xe @ wi)) @ wo
            out = out.index_add(0, tok, ye * gate[tok, j, None])
            del wi, wg, wo
    out = out.reshape(B, S, D)
    if m.shared_expert:
        s = f["shared"]
        out = out + (F.silu(h @ s["wg"]) * (h @ s["wi"])) @ s["wo"]
    assign = torch.bincount(idx.reshape(-1), minlength=E).float() / (T * K)
    aux = (E * (probs.mean(0) * assign).sum()
           + (torch.logsumexp(logits, -1) ** 2).mean())
    return out, aux


def plain_blocks(cfg, params):
    """(block type, block parameters) of every layer in order: the stacked
    groups a layer at a time, then the unstacked tail (an encoder-decoder's
    decoder layers: its dec_x blocks)."""
    from repro_torch import utils
    out = []
    pattern = ("dec_x",) if cfg.enc_layers else cfg.pattern
    for i in range(cfg.n_layers // len(pattern)):
        for j, t in enumerate(pattern):
            out.append((t, utils.tree_map(lambda w: w[i],
                                          params["groups"][f"b{j}_{t}"])))
    for i, t in enumerate(cfg.tail_pattern):
        out.append((t, params[f"tail{i}_{t}"]))
    return out


EXPERT_STACKS = ("wi", "wg", "wo")     # a moe block's (E, ., .) weights


def plain_layer(t, p):
    """A layer's weights as the plain forward runs them: widened to f32
    (exact from bf16) as the layer runs, so a model's weights are never
    widened whole; a moe block's expert stacks are left to `plain_moe`,
    which widens them an expert at a time.  f32 leaves stay the same
    tensors."""
    from repro_torch import utils
    if t != "moe":
        return utils.tree_map(lambda w: w.float(), p)
    f = p["ffn"]
    out = utils.tree_map(lambda w: w.float(), dict(p, ffn={
        k: v for k, v in f.items() if k not in EXPERT_STACKS}))
    out["ffn"].update({k: f[k] for k in EXPERT_STACKS})
    return out


def plain_hidden(cfg, params, seq, *, mm=None, src=None, causal=True,
                 theta=None, kv_roll=0, mlstm_chunk=None, moe_groups=None,
                 aux=None, record=None, follow=None, enc_causal=False,
                 cross=True):
    """An f32 forward of the whole token sequence to the final norm, apart
    from the port's model code: no cache, no chunking, no checkpointing;
    attention by `scaled_dot_product_attention` with query head h on KV
    head h // (H / K), rope from the positions 0..S-1, an `attn` block's
    keys masked a window or more behind; the RG-LRU by `plain_rglru`.
    `mm`: the vlm's stub embeddings (B, P, D), put before the tokens'
    rows.  `src`: an encoder-decoder's source embeddings (B, S_src, D),
    run through the encoder (attention with no mask, rope from 0..S_src-1)
    and its norm; each decoder layer then attends to the tokens causally
    and to the encoder's output with no mask and no rope.  `params`: the
    weights at their own dtypes, each layer's widened to f32 as it runs
    (`plain_layer`).  The keywords plant a fault for the checks' own
    tests: no causal mask, another rope θ, every query head on the next KV
    head, a causal encoder, no cross attention.  The xLSTM blocks by
    `plain_mlstm` (stepped, or in chunks of `mlstm_chunk`) and
    `plain_slstm`; a moe block's FFN by `plain_moe` (routed in
    `moe_groups`; `record`: a list each moe layer's choices are appended
    to; `follow`: a list of each moe layer's expert indices to route by,
    taken in layer order), its aux terms appended to `aux`.  (B, S) ->
    (B, S + P, D)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch import utils
    F = torch.nn.functional
    check(cfg.act == "silu" and set(cfg.pattern) <= {
        "dense", "attn", "rglru", "mlstm", "slstm", "moe"},
        f"plain forward: not written for {cfg.name}")
    H, K, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    half = hd // 2
    theta = cfg.rope_theta if theta is None else theta

    x = params["embed"]["tok"][seq.long()].float()
    if mm is not None:
        x = torch.cat([mm.float(), x], 1)
    S = x.shape[1]
    at = torch.arange(S, device=seq.device)
    window = None
    if cfg.window is not None:
        window = (at[:, None] >= at[None, :]) & (
            at[:, None] - at[None, :] < cfg.window)

    def rot(x):                                    # (B, S, n, hd)
        ang = torch.arange(x.shape[1], device=x.device).float()[:, None] * (
            theta ** (-torch.arange(half, device=x.device,
                                    dtype=torch.float32) / half))
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        a, b = x[..., :half], x[..., half:]
        return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)

    def heads(x):                                  # (B, S, K, hd) -> (B, H, S, hd)
        return x.roll(kv_roll, 2).transpose(1, 2).repeat_interleave(
            H // K, 1)

    def attention(a, h, mask, causal=causal, kv=None):
        """Self attention with rope, or (`kv`: the encoder's output) cross
        attention with none."""
        src_ = h if kv is None else kv
        q = torch.einsum("bsd,dnh->bsnh", h, a["wq"])
        k = torch.einsum("bsd,dnh->bsnh", src_, a["wk"])
        v = torch.einsum("bsd,dnh->bsnh", src_, a["wv"])
        if "bq" in a:
            q, k, v = q + a["bq"], k + a["bk"], v + a["bv"]
        if "qnorm" in a:
            q, k = plain_norm(q, a["qnorm"]), plain_norm(k, a["knorm"])
        if kv is None:
            q, k = rot(q), rot(k)
        with sdpa_kernel(SDPBackend.MATH):         # f32 products, softmax
            o = F.scaled_dot_product_attention(
                q.transpose(1, 2), heads(k), heads(v),
                attn_mask=mask if causal else None,
                is_causal=causal and mask is None)
        return torch.einsum("bnsh,nhd->bsd", o, a["wo"])

    def mlp(f, h):
        return (F.silu(h @ f["wg"]) * (h @ f["wi"])) @ f["wo"]

    enc = None
    if cfg.enc_layers:
        enc = src.float()
        for i in range(cfg.enc_layers):
            p = utils.tree_map(lambda w: w[i].float(),
                               params["enc_groups"]["b0_enc"])
            h = plain_norm(enc, p["ln1"]["scale"])
            enc = enc + attention(p["attn"], h, None, causal=enc_causal)
            enc = enc + mlp(p["ffn"], plain_norm(enc, p["ln2"]["scale"]))
        enc = plain_norm(enc, params["enc_norm"]["scale"].float())

    for t, p in plain_blocks(cfg, params):
        p = plain_layer(t, p)
        if t == "mlstm":
            x = x + plain_mlstm(p["cell"], x, mlstm_chunk)
            continue
        if t == "slstm":
            x = x + plain_slstm(p["cell"], x)
            continue
        h = plain_norm(x, p["ln1"]["scale"])
        if t == "rglru":
            x = x + plain_rglru(p["rec"], h)
        else:
            x = x + attention(p["attn"], h, window if t == "attn" else None)
        if t == "dec_x" and cross:
            x = x + attention(p["xattn"], plain_norm(x, p["lnx"]["scale"]),
                              None, causal=False, kv=enc)
        h = plain_norm(x, p["ln2"]["scale"])
        f = p["ffn"]
        if t == "moe":
            y, a = plain_moe(f, h, cfg, moe_groups, record,
                             None if follow is None else follow.pop(0))
            x = x + y
            if aux is not None:
                aux.append(a)
            continue
        x = x + mlp(f, h)
    return plain_norm(x, params["final_norm"]["scale"].float())


def plain_logits(params, x):
    """f32 logits of hidden states: the untied unembedding, or the token
    table's transpose, widened to f32."""
    emb = params["embed"]
    return x @ (emb["unembed"].float() if "unembed" in emb
                else emb["tok"].float().T)


def sv_plain_logits(cfg, params, seq, **kw):
    """`plain_hidden` unembedded: (B, S) -> (B, S, V) f32 logits.
    `params`: the weights as the server holds them (each widened to f32
    where it is used); `kw`: `plain_hidden`'s keywords."""
    return plain_logits(params, plain_hidden(cfg, params, seq, **kw))


def sv_decode_logits(model, params, seq, max_len, cross=None):
    """The port's decode, teacher-forced on `seq` from an empty cache of
    `max_len` slots (an encoder-decoder's cross K/V from `cross`): the
    logits of every step, (B, S, V) f32, written into one tensor as they
    come (no second copy of them all)."""
    cache = model.init_cache(seq.shape[0], max_len, seq.device)
    if cross is not None:
        cache["cross"] = cross
    out = None
    for t in range(seq.shape[1]):
        logits, cache = model.decode_step(params, seq[:, t], cache, t)
        if out is None:
            out = logits.new_empty((seq.shape[0], seq.shape[1],
                                    logits.shape[-1]))
        out[:, t] = logits
    return out


def sv_reference(cfg, params, prompt, toks, max_len, chunk=None,
                 argmax=True, bound=SV_LOGIT_RTOL, plain_kw=None, src=None):
    """The served decode at full width against `sv_plain_logits` on the
    same weights: b's prompt and tokens teacher-forced, compared `chunk`
    sequences at a time (all at once by default).  The decode's argmax must give b's
    tokens (unless `argmax` is False: a decode at another compute dtype
    than b's), and its logits must be finite and within `bound` of the
    f32 forward, scaled by the largest |logit| (None: measured only).
    `plain_kw`: `plain_hidden`'s keywords, or a function of a chunk's
    first and last sequence (lo, hi) that returns them.  The f32 forward
    runs on the decode's weights, each layer widened as it runs
    (`plain_layer`), so no f32 copy of the model is made.  `src`: an
    encoder-decoder's
    source (B, S_src, D), encoded and projected into the decode's cross
    cache as the server's is filled, and run through the f32 encoder.
    Returns the phase line's fields, with each position's largest error
    summed up."""
    from repro_torch.models.transformer import build_model
    model = build_model(cfg)
    cparams = model.compute_params(params)
    n_new = toks.shape[1]
    gen = torch.as_tensor(toks, device=prompt.device)
    seq = torch.cat([prompt, gen[:, :n_new - 1].to(prompt.dtype)], 1)
    lead = seq.shape[1] - n_new + 1                # the prompt's last step
    chunk = chunk or seq.shape[0]
    err = scale = agree = 0.0
    pos_err = []                        # each position's largest error
    # the decode at the served batch: cuBLAS picks its products' order by
    # shape, so a smaller batch need not give the served tokens' bits
    cross = None if src is None else ed_cross(model, cparams, src)
    logits = sv_decode_logits(model, cparams, seq, max_len, cross)
    del cross
    for lo in range(0, seq.shape[0], chunk):
        part = seq[lo:lo + chunk]
        got = logits[lo:lo + chunk]
        kw = dict((plain_kw(lo, lo + part.shape[0]) if callable(plain_kw)
                   else plain_kw) or {})
        if src is not None:
            kw["src"] = src[lo:lo + chunk]
        want = sv_plain_logits(cfg, cparams, part, **kw)
        check(bool(torch.isfinite(got).all()
                   and torch.isfinite(want).all()), "h: non-finite logits")
        check(not argmax or torch.equal(
            got[:, lead - 1:].argmax(-1).cpu(),
            torch.as_tensor(toks[lo:lo + chunk]).long()),
            "h: the decode's argmax != b's tokens")
        pos_err.append((got - want).abs().amax(-1).flatten().cpu())
        err = max(err, pos_err[-1].max().item())
        scale = max(scale, want.abs().max().item())
        agree += (got.argmax(-1) == want.argmax(-1)).float().sum().item()
        del got, want
    del logits
    check(len(set(toks.ravel().tolist())) > 1, "h: every token the same")
    pos_rel = torch.cat(pos_err).double() / scale
    over = None if bound is None else int((pos_rel > bound).sum())
    out = dict(positions=seq.shape[1], sequences=seq.shape[0],
               compute_dtype=cfg.compute_dtype, max_abs_err=err,
               max_abs_logit=scale, rel_err=err / scale, bound=bound,
               positions_over_bound=over,
               median_position_rel_err=pos_rel.median().item(),
               p99_position_rel_err=pos_rel.quantile(0.99).item(),
               argmax_agree=agree / seq.numel(),
               distinct_tokens=len(set(toks.ravel().tolist())))
    check(bound is None or over == 0,
          f"h: logits off the f32 forward by {err} (bound {bound} x "
          f"{scale}) at {over} of {pos_rel.numel()} positions: {out}")
    return out


def serving_path(dev):
    """The serving plane at the model's published width (phases sv a-g)."""
    import numpy as np
    from repro_torch import Fault, utils
    from repro_torch.core import layout
    from repro_torch.runtime import failure
    run = PathRun(dev, "sv")
    probe = CallProbe()
    cfg, mesh, params, prompt = sv_model(dev)
    end = SV_PROMPT + SV_NEW - 1            # decode steps a generation takes
    event_pos = SV_PROMPT + SV_EVENT        # where sv e and f lose ranks

    # a: the server opens its pool over the empty cache
    srv, _ = run.phase("a_start", lambda: sv_server(dev, cfg, mesh, params),
                       inv=sv_invariants)
    lo = srv.protector.layout
    runs = [layout._slot_time_runs(sl, SV_MAX_LEN) for sl in lo.slots]
    check(all(len(r) == 1 for r in runs),
          f"max_len {SV_MAX_LEN} names {[len(r) for r in runs]} cache axes")
    emit(path="sv", phase="a_layout", arch=cfg.name, mesh=list(SV_MESH),
         batch=SV_BATCH, max_len=SV_MAX_LEN,
         params=sum(x.numel() for x in utils.tree_leaves(params)),
         cache_bytes=sum(x.numel() * x.element_size()
                         for x in utils.tree_leaves(srv.pool.state)),
         leaves=[list(sl.shape) for sl in lo.slots],
         row_words=lo.row_words, n_blocks=lo.n_blocks,
         dirty_pages_per_step=len(srv._dirty_pages(0)),
         dirty_words_per_step=sum(len(w) for w in srv._dirty_words(0)),
         page_capacity=layout.time_slice_page_capacity(lo, SV_MAX_LEN))

    # b: prefill + generate at r = 1, window 1, depth 1, clocked; the rows
    # at the positions sv d and e damage are kept for their checks
    rows = {}

    def keep(s, out):
        if out["pos"] + 1 in (SV_PROMPT, event_pos):
            rows[out["pos"] + 1] = s.prot.row.clone()
    toks, l_b = run.phase("b_generate_r1", lambda: sv_clocked(
        run, "b", srv, prompt, keep), srv, inv=sv_invariants)
    check(l_b.get("fused_commit") == end, f"b launches {l_b}")
    check(toks.shape == (SV_BATCH, SV_NEW) and toks.min() >= 0
          and toks.max() < cfg.vocab, f"tokens {toks.shape}")
    # g after b: every patch commit was exact
    host_same_as_fresh(run, srv, "g_fresh_after_b")
    del srv
    torch.cuda.empty_cache()

    # c: protection does not change the decode path
    toks_c, _ = run.phase("c_generate_unprotected", lambda: sv_clocked(
        run, "c", sv_server(dev, cfg, mesh, params, protect=False), prompt),
        inv=nothing)
    check(np.array_equal(toks_c, toks), "unprotected tokens != protected")
    torch.cuda.empty_cache()

    # h: the decode at full width against an f32 forward apart from it
    # (timed and uncounted: a comparison)
    emit(path="sv", phase="h_result", **run.timed_aside(
        "h_vs_f32_forward",
        lambda: sv_reference(cfg, params, prompt, toks, SV_MAX_LEN)))
    torch.cuda.empty_cache()

    with probe:
        # d: a scribble into rank 0's cache shard (a word of each leaf)
        # after prefill: scrub and repair
        srv = sv_server(dev, cfg, mesh, params)
        lo = srv.protector.layout
        offsets = [sl.offset + 11 for sl in lo.slots]
        out = []

        def scribble():
            out.extend(sv_steps(srv, prompt, None, SV_PROMPT)[1])
            srv.pool.inject(lambda pr, p: failure.inject_scribble(
                pr, p, rank=0, word_offsets=offsets))
            report = srv.pool.scrub()
            want = {(0, o // lo.block_words) for o in offsets}
            check(set(report.bad_locations) == want, f"scrub {report}")
            check(report.repaired and report.repair_ok, f"repair {report}")
            check(torch.equal(srv.prot.row, rows[SV_PROMPT]),
                  "d: repaired cache != b's at the same position")
        run.phase("d_prefill_scribble_repair", scribble, srv,
                  inv=sv_invariants)

        # e: a rank loss mid-generation, recovered; then to the end
        def rank_loss():
            event = srv.pool.inject(lambda pr, p: failure.inject_rank_loss(
                pr, p, SV_LOST))
            rep = srv.pool.recover(Fault.from_event(event))
            check(rep.verified and rep.reverified, f"recovery {rep}")
            check(torch.equal(srv.prot.row, rows[event_pos]),
                  "e: recovered cache != b's at the same position")

        def rest():
            out.extend(sv_steps(srv, prompt, out[-1], end,
                                {event_pos: rank_loss})[1])
            return sv_tokens(srv, out)
        toks_e, _ = run.phase("e_rank_loss_recover", rest, srv,
                              inv=sv_invariants)
        check(np.array_equal(toks_e, toks), "d / e tokens != b's")
        del srv, rows
        torch.cuda.empty_cache()

        # f: r = 3, window 4, depth 4: the deferred patch engine on
        # dirty_words and the commit ring, through a loss of three ranks
        srv, _ = run.phase("f_start_r3_w4_d4", lambda: sv_server(
            dev, cfg, mesh, params, redundancy=3, window=4,
            pipeline_depth=4), inv=nothing)
        check(srv.pool.engine is not None and srv.pool.engine.patch,
              "f: not the patch engine")

        def multi_loss():
            event = srv.pool.inject(
                lambda pr, p: failure.inject_multi_rank_loss(
                    pr, p, SV_MULTI_LOST))
            rep = srv.pool.recover(Fault.from_event(event))
            check(rep.verified and rep.reverified, f"recovery {rep}")
        toks_f, _ = run.phase("f_generate_loss_of_3", lambda: sv_tokens(
            srv, sv_steps(srv, prompt, None, end, {event_pos: multi_loss})[1]),
            inv=nothing)
        check(np.array_equal(toks_f, toks), "f tokens != b's")
        # g after f
        host_same_as_fresh(run, srv, "g_fresh_after_f")
        sv_invariants(srv, "g_flushed_f")
        del srv
        torch.cuda.empty_cache()
    probe.check(run, dict(run.build.LAUNCHES))
    return run.end(PATH_SV)


TR_ARCH = "qwen3-0.6b"           # trained at its published width
TR_REDUCED = False               # True: the config's reduced() (a CPU rehearsal)
TR_MESH = (4, 2)                 # the reference launcher's default mesh
TR_SEQ, TR_BATCH = 1024, 8       # 8,192 tokens a step
TR_LAYERS = 14                   # the depth (the config's 28, cut to
                                 # make room for zc's phases g, r, e)
TR_STEPS = 6                     # steps of each full phase (b, c, d, g)
TR_SCRUB = 6                     # scrub_period: b's last step scrubs
TR_LR, TR_WARMUP, TR_TOTAL = 1e-3, 2, 100
TR_LOST = 1                      # the rank tr d loses, after step TR_LOSS_AT
TR_LOSS_AT, TR_SCRIBBLE_AT = 1, 2
TR_ABORT_AT = 3                  # the step tr e runs with a failed canary
TR_CKPT_AT, TR_CRASH_AT = 4, 6   # tr f: checkpoint, then crash after
TR_MULTI_LOST = (0, 1, 3)        # the ranks tr g loses after TR_MULTI_AT
TR_MULTI_AT = 5
TR_SLOW = 1                      # the replica tr h slows 10x
# tr i, the train step checked apart from the port (a plain f32 forward
# and backward of the whole model, chip_smoke.plain_hidden): the bf16
# step's loss within TR_LOSS_RTOL of the f32 loss, and every parameter
# leaf's gradient at a cosine of at least TR_GRAD_COS with the f32 one;
# the chunked attention within TR_ATTN_RTOL of its largest |value|.
# Bounds, set before the first chip run: bf16 rounding moves the loss by
# ~5e-5 and each leaf's gradient by a cosine of ~1 - 7e-5 at reduced
# widths (scripts/torch_train_check_faults.py on the CPU), 20x and 150x
# inside the bounds; a wrong KV head, no causal mask or a rope θ of 1e4
# move some leaf's gradient to a cosine of 0.90 or less there
# (tests/test_torch_train_model.py::test_tr_check_catches_faults).
TR_LOSS_RTOL = 1e-3
TR_GRAD_COS = 0.99
# mo h and mt i also hold the share of (token, rank) expert choices the
# port's router and the plain f32 one make alike to ROUTER_AGREEMENT: a
# bf16 rounding can swap a token's k-th and k+1-th expert (measured 0.962
# and 0.979 on the card), a router that picks wrong experts shares few.
ROUTER_AGREEMENT = 0.9
TR_ATTN_RTOL = 1e-4
PATH_TR = ("fletcher_blocks", "fletcher_stream",
           "fused_verify_commit_stream", "fused_accum_commit_stream",
           "sdelta_stack", "gf_scale")


def tr_free():
    """Let go of a phase's trainer: a trainer and the clock wrapped around
    it refer to each other, so only the cycle collector frees them."""
    gc.collect()
    torch.cuda.empty_cache()


def tr_model():
    """The trained model's config and zone mesh."""
    from repro_torch import ZoneMesh
    from repro_torch.configs.registry import get_config
    return (get_config(TR_ARCH, reduced=TR_REDUCED),
            ZoneMesh(TR_MESH, ("data", "model")))


def tr_trainer(dev, cfg, mesh, checkpoint_dir=None, start=True,
               seq_len=TR_SEQ, global_batch=TR_BATCH, params=None, **pcfg):
    """A Trainer of the path's model (AdamW, lr 1e-3, warmup 2), mlpc at
    ProtectConfig's defaults unless `pcfg` says otherwise, initialized
    from `params` (a factory of them), else from SEED on the card (every
    trainer starts from the same state)."""
    from repro_torch import ProtectConfig
    from repro_torch.configs.base import TrainConfig
    from repro_torch.runtime.trainer import Trainer
    pcfg = {"mode": "mlpc", "scrub_period": TR_SCRUB, **pcfg}
    t = Trainer(cfg, TrainConfig(learning_rate=TR_LR,
                                 warmup_steps=TR_WARMUP,
                                 total_steps=TR_TOTAL),
                ProtectConfig(**pcfg), mesh, seq_len=seq_len,
                global_batch=global_batch, checkpoint_dir=checkpoint_dir,
                seed=SEED, device=dev)
    if start:
        t.initialize(params=None if params is None else params())
    return t


def tr_clock(t, probe=None):
    """A StepClock over a trainer: the train step (forward, backward,
    clip, AdamW); the zone copies (`pool.state` with the batch's creation,
    and `Pool.to_zone`); the commit less its to_zone; the scrub cadence.
    The probe's copies count in no piece."""
    return StepClock(pieces=("train_step", "zone_copies", "commit", "scrub"),
                     off=(lambda: probe.ms) if probe is not None else None,
                     wraps=[(t, "_dispatch_step", "zone_copies"),
                            (t, "_train_step", "train_step"),
                            (t.pool, "commit_async", "commit"),
                            (t.pool, "to_zone", "zone_copies"),
                            (t.pool, "maybe_scrub", "scrub")])


def tr_steps(run, tag, t, n, probe=None, events=None, **kw):
    """`n` steps of `t`, each resolved before the next; the phase line's
    split of ms a step (tokens/s counts the trainer's batch x sequence),
    the losses and the digests after each step.  `events[k]()` runs after
    the step that brings the trainer to step k, off the clock, as do the
    probe's copies."""
    if not hasattr(t, "_clock"):
        t._clock = tr_clock(t, probe)
    clock = t._clock
    clock.ms = dict.fromkeys(clock.ms, 0.0)
    losses, digests = [], []
    off = -(probe.ms if probe is not None else 0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        out = t.step(**kw)
        losses.append(out["loss"])
        digests.append(t.prot.digest.clone()
                       if t.prot.digest is not None else None)
        if events and out["step"] in events:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            events[out["step"]]()
            torch.cuda.synchronize()
            off += (time.perf_counter() - t1) * 1e3
    torch.cuda.synchronize()
    probe_ms = (probe.ms if probe is not None else 0.0)
    wall = (time.perf_counter() - t0) * 1e3 - off - probe_ms
    split = {f"{k}_ms_per_step": v / n for k, v in clock.ms.items()}
    split["other_ms_per_step"] = wall / n - sum(split.values())
    emit(path=run.tag, phase=f"{tag}_split", steps=n, wall_ms=wall,
         off_clock_ms=off + probe_ms, ms_per_step=wall / n,
         tokens_per_s=t.global_batch * t.seq_len * n / wall * 1e3,
         losses=losses, **split)
    return losses, digests


def tr_host_state(t):
    """The trainer's global state, copied to the host."""
    from repro_torch import utils
    return utils.tree_map(lambda x: x.cpu(), t.pool.state)


def tr_same_state(t, host, tag):
    """The trainer's global state byte-equal to a host copy."""
    from repro_torch import utils
    got = utils.tree_leaves(t.pool.state)
    for a, b in zip(got, utils.tree_leaves(host), strict=True):
        check(torch.equal(a, b.to(a.device)), f"{tag}: state != b's")


def tr_plain_loss(cfg, params, tokens, mm=None, **kw):
    """The loss of `plain_hidden` (f32 logits of the whole batch, no
    chunks) on the token positions (after the vlm's stub prefix `mm`):
    next-token CE with the last position masked, plus 1e-4 x the mean
    lse², plus 0.01 x the moe blocks' aux terms, as the reference's loss.
    `kw`: `plain_hidden`'s keywords."""
    aux = []
    x = plain_hidden(cfg, params, tokens, mm=mm, aux=aux, **kw)
    logits = plain_logits(params, x[:, cfg.mm_positions:])
    lse = torch.logsumexp(logits, -1)[:, :-1]
    ll = torch.gather(logits[:, :-1], -1,
                      tokens[:, 1:, None].long())[..., 0]
    loss = (lse - ll).mean() + 1e-4 * (lse ** 2).mean()
    return loss + 0.01 * sum(aux) if cfg.moe is not None else loss


class RouteRecorder:
    """While entered, records each moe layer's expert choices the port
    makes (`moe._route_group`): (top k indices, kept mask) a call, in
    (token, rank) order, the first `limit` calls (a train step's forward;
    the checkpointed groups route again in the backward)."""

    def __init__(self, limit=None):
        self.calls, self.limit = [], limit

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.route = moe, moe._route_group

        def route(xt, router, E, k, capacity, dt):
            out = self.route(xt, router, E, k, capacity, dt)
            if self.limit is None or len(self.calls) < self.limit:
                order, keep, flat = out[4], out[5], out[7]
                mask = torch.empty_like(keep).scatter_(1, order, keep)
                self.calls.append((flat.reshape(-1, k).clone(),
                                   mask.reshape(-1, k).clone()))
            return out
        moe._route_group = route
        return self

    def __exit__(self, *exc):
        self.moe._route_group = self.route
        return False


def choice_agreement(port, plain):
    """The share of (token, rank) expert choices and kept flags that two
    routings share: lists of (indices, kept) of equal shapes."""
    same = total = 0
    for (pi, pk), (qi, qk) in zip(port, plain, strict=True):
        a, b = pi.sort(-1).values, qi.sort(-1).values
        same += int(((a == b) & (pk.sum(-1, keepdim=True)
                                 == qk.sum(-1, keepdim=True))).sum())
        total += a.numel()
    return same / max(total, 1)


def tr_grad_check(cfg, params, batch, mesh=None, plain_kw=None, **fault):
    """The port's loss and gradients at `cfg`'s compute dtype
    (`api.make_loss_and_grads`: chunked attention and CE, checkpointed
    layer groups; a moe block routed in `mesh`'s groups) against
    `tr_plain_loss`'s on the same f32 weights and batch.  With experts,
    the plain step routes by its own f32 router in the same groups, and
    the share of choices the two routers make alike is held to
    ROUTER_AGREEMENT.  Returns the phase line's fields; `ok` holds the
    bounds."""
    from repro_torch import utils
    from repro_torch.dist import sharding as shd
    from repro_torch.models import api
    from repro_torch.models.transformer import build_model
    n_moe = (sum(t == "moe" for t in cfg.pattern) * cfg.n_groups
             + sum(t == "moe" for t in cfg.tail_pattern))
    with RouteRecorder(limit=n_moe) as rec:
        loss, _, grads = api.make_loss_and_grads(build_model(cfg, mesh))(
            params, batch)
    leaves, treedef = utils.tree_flatten(params)
    kw = dict(plain_kw or {}, **fault)
    if "src_embeds" in batch:
        kw["src"] = batch["src_embeds"]
    if cfg.moe is not None:
        sizes = shd.axis_sizes(mesh)
        g = sizes.get("data", 1) * sizes.get("pod", 1)
        kw["moe_groups"] = g if batch["tokens"].numel() % g == 0 else 1

    mine = [] if cfg.moe is not None else None
    xs = [p.detach().float().requires_grad_() for p in leaves]
    want = tr_plain_loss(cfg, utils.tree_unflatten(treedef, xs),
                         batch["tokens"], batch.get("mm_embeds"), **kw,
                         record=mine)
    # a leaf a planted fault leaves out of the plain step has no gradient
    gwant = [torch.zeros_like(x) if g is None else g for x, g in zip(
        xs, torch.autograd.grad(want, xs, allow_unused=True))]
    cos = [float(torch.nn.functional.cosine_similarity(
        a.double().reshape(-1), b.double().reshape(-1), dim=0))
        for a, b in zip(utils.tree_leaves(grads), gwant)]
    want = float(want.detach())
    rel = abs(float(loss) - want) / abs(want)
    out = dict(loss=float(loss), plain_loss=want, loss_rel_err=rel,
               loss_bound=TR_LOSS_RTOL, min_grad_cos=min(cos),
               grad_cos_bound=TR_GRAD_COS, grad_cos=cos,
               ok=rel <= TR_LOSS_RTOL and min(cos) >= TR_GRAD_COS)
    if cfg.moe is not None:
        agree = choice_agreement(rec.calls, mine)
        out.update(router_agreement=agree,
                   router_agreement_bound=ROUTER_AGREEMENT,
                   ok=out["ok"] and agree >= ROUTER_AGREEMENT)
    return out


def tr_attention_check(cfg, params, batch):
    """The chunked `attend` (f32) and its gradients on layer 0's q, k, v
    of the batch against `scaled_dot_product_attention` (causal, the math
    backend, GQA by repeating k and v); each within TR_ATTN_RTOL of its
    largest |value|."""
    import dataclasses
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch import utils
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    p = utils.tree_map(lambda w: w[0].float(),
                       params["groups"]["b0_dense"])
    x = L.apply_embed(params["embed"], batch["tokens"], cfg32)
    pos = torch.arange(x.shape[1], device=x.device)
    with torch.no_grad():
        h = L.apply_rmsnorm(p["ln1"], x)
        q = A.project_q(p["attn"], h, cfg32, pos)
        k, v = A.project_kv(p["attn"], h, cfg32, pos)
    dout = torch.randn(q.shape, device=q.device,
                       generator=torch.Generator(q.device).manual_seed(SEED))
    g = cfg.n_heads // cfg.n_kv
    outs = {}
    for name in ("attend", "sdpa"):
        qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
        if name == "attend":
            o = A.attend(qq, kk, vv, causal=True)
        else:
            with sdpa_kernel(SDPBackend.MATH):
                o = torch.nn.functional.scaled_dot_product_attention(
                    qq.transpose(1, 2),
                    kk.transpose(1, 2).repeat_interleave(g, 1),
                    vv.transpose(1, 2).repeat_interleave(g, 1),
                    is_causal=True).transpose(1, 2)
        o.backward(dout)
        outs[name] = (o.detach(), qq.grad, kk.grad, vv.grad)
    errs = {}
    for what, a, b in zip(("out", "dq", "dk", "dv"), outs["attend"],
                          outs["sdpa"]):
        errs[what] = float((a - b).abs().max()) / float(b.abs().max())
    check(all(e <= TR_ATTN_RTOL for e in errs.values()),
          f"i: chunked attention off sdpa: {errs}")
    return dict(shape=[list(q.shape), list(k.shape)], rel_err=errs,
                bound=TR_ATTN_RTOL)


def training_path(dev):
    """The training plane at the model's published width (phases tr a-i)."""
    import shutil
    import tempfile
    from repro_torch import utils
    from repro_torch.dist.straggler import StragglerPolicy
    from repro_torch.runtime import failure
    run = PathRun(dev, "tr")
    probe = CallProbe(host=True)
    cfg, mesh = tr_model()
    cfg = dataclasses.replace(cfg, n_layers=min(cfg.n_layers, TR_LAYERS))
    steps = TR_STEPS
    half = steps // 2

    # a: the state is made on the card and the pool opens over it
    t, _ = run.phase("a_start", lambda: tr_trainer(dev, cfg, mesh),
                     inv=nothing)
    lo = t.protector.layout
    state = t.pool.state
    emit(path="tr", phase="a_layout", arch=cfg.name, mesh=list(TR_MESH),
         seq_len=TR_SEQ, global_batch=TR_BATCH,
         params=sum(x.numel() for x in utils.tree_leaves(state["params"])),
         state_bytes=sum(x.numel() * x.element_size()
                         for x in utils.tree_leaves(state)),
         leaves=len(lo.slots), row_words=lo.row_words, n_blocks=lo.n_blocks,
         block_words=lo.block_words)
    del state
    invariants(t.pool, "a_start")

    # b: TR_STEPS steps at mlpc r = 1, window 1, depth 1: the first half
    # bulk commits, the second with verify-at-open
    ckpt = {}

    def b():
        l1, d1 = tr_steps(run, "b_bulk", t, half)
        t.verify_old = True
        l2, d2 = tr_steps(run, "b_verify_old", t, steps - half, events={
            TR_CRASH_AT: lambda: ckpt.update(state=tr_host_state(t))})
        return l1 + l2, d1 + d2
    (b_loss, b_dig), _ = run.phase("b_train_r1", b, t.pool)
    check(sum(b_loss[-4:]) < sum(b_loss[:4]),
          f"b: the loss did not fall: {b_loss}")
    check(all(math.isfinite(x) for x in b_loss), f"b: losses {b_loss}")
    b_final = tr_host_state(t)
    del t
    tr_free()

    # c: unprotected: the same losses and final state, bit for bit
    def c():
        u = tr_trainer(dev, cfg, mesh, mode="none")
        losses, _ = tr_steps(run, "c_unprotected", u, steps)
        check(losses == b_loss, f"c: losses {losses} != b's {b_loss}")
        tr_same_state(u, b_final, "c")
    run.phase("c_train_unprotected", c, inv=nothing)
    tr_free()

    with probe:
        # d: rank 1 lost after TR_LOSS_AT and recovered; a word scribbled
        # in rank 0's shard after TR_SCRIBBLE_AT, scrubbed and repaired; on
        # to TR_STEPS
        def d():
            u = tr_trainer(dev, cfg, mesh)
            losses, digs = tr_steps(run, "d_to_loss", u, TR_LOSS_AT, probe)
            row = u.prot.row.clone()
            ev = u.pool.inject(lambda pr, p: failure.inject_rank_loss(
                pr, p, TR_LOST))
            rep = u.on_failure(ev)
            check(rep["verified"] and rep["reverified"], f"d: {rep}")
            check(torch.equal(u.prot.row, row),
                  "d: recovered state != the copy taken before the loss")
            del row
            # row == flatten(state), so the state is the copy's too
            invariants(u.pool, "d_recovered")
            more, dg = tr_steps(run, "d_to_scribble", u,
                                TR_SCRIBBLE_AT - TR_LOSS_AT, probe)
            losses, digs = losses + more, digs + dg
            offset = lo.slots[0].offset + 11
            u.pool.inject(lambda pr, p: failure.inject_scribble(
                pr, p, rank=0, word_offsets=[offset]))
            report = u.pool.scrub()
            check(set(report.bad_locations) == {(0, offset // lo.block_words)}
                  and report.repaired and report.repair_ok,
                  f"d: scrub {report}")
            more, dg = tr_steps(run, "d_bulk", u, half - TR_SCRIBBLE_AT,
                                probe)
            losses, digs = losses + more, digs + dg
            u.verify_old = True
            more, dg = tr_steps(run, "d_verify_old", u, steps - half, probe)
            losses, digs = losses + more, digs + dg
            check(losses == b_loss, f"d: losses {losses} != b's")
            check(all(torch.equal(a, b) for a, b in zip(digs, b_dig)),
                  "d: a step's digest != b's")
            tr_same_state(u, b_final, "d")
            return u.pool
        run.phase("d_loss_scribble", d, inv=nothing)
        probe.check(run, {}, by_rank=True)
        tr_free()

        # e: step 5 with a failed canary: not committed, the cursor rolled
        # back, the bytes unchanged; the next step is b's step 5
        def e():
            u = tr_trainer(dev, cfg, mesh)
            tr_steps(run, "e_to_abort", u, TR_ABORT_AT - 1, probe)
            row, cursor = u.prot.row.clone(), u.cursor
            out = u.step(canary_ok=False)
            check(not out["committed"] and u.cursor == cursor
                  and u.pool.step == TR_ABORT_AT - 1
                  and torch.equal(u.prot.row, row), f"e: abort {out}")
            invariants(u.pool, "e_after_abort")
            del row
            losses, digs = tr_steps(run, "e_after_abort", u, 1, probe)
            check(losses[0] == b_loss[TR_ABORT_AT - 1]
                  and torch.equal(digs[0], b_dig[TR_ABORT_AT - 1]),
                  "e: the step after the abort != b's step 5")
        run.phase("e_canary_abort", e, inv=nothing)
        tr_free()

        # f: checkpoint at step 8, on to 12, the trainer dropped; a fresh
        # one restores and replays 9-12 from the redo log
        def f():
            where = tempfile.mkdtemp(prefix="tr_ckpt_")
            try:
                u = tr_trainer(dev, cfg, mesh, checkpoint_dir=where)
                tr_steps(run, "f_to_checkpoint", u, TR_CKPT_AT, probe)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                u.save_checkpoint()
                save_ms = (time.perf_counter() - t0) * 1e3
                tr_steps(run, "f_to_crash", u, TR_CRASH_AT - TR_CKPT_AT,
                         probe)
                t0 = time.perf_counter()
                u._ckpt_mgr.wait()
                wait_ms = (time.perf_counter() - t0) * 1e3
                # the surviving redo log (a peer's copy, in production)
                log = dataclasses.replace(u.prot.log, **{
                    k: v.clone() for k, v in vars(u.prot.log).items()})
                del u
                tr_free()
                w = tr_trainer(dev, cfg, mesh, checkpoint_dir=where,
                               start=False)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                info = w.restore_from_checkpoint(log=log)
                torch.cuda.synchronize()
                restore_ms = (time.perf_counter() - t0) * 1e3
                want = list(range(TR_CKPT_AT + 1, TR_CRASH_AT + 1))
                check(info == {"restored_step": TR_CKPT_AT,
                               "replayed": want}, f"f: {info}")
                replayed = [o["loss"] for o in w.history]
                check(replayed == b_loss[TR_CKPT_AT:TR_CRASH_AT],
                      f"f: replayed losses {replayed}")
                tr_same_state(w, ckpt.pop("state"), "f")
                emit(path="tr", phase="f_checkpoint", save_ms=save_ms,
                     wait_ms=wait_ms, restore_and_replay_ms=restore_ms,
                     replayed=info["replayed"], replayed_losses=replayed,
                     disk_free_bytes=shutil.disk_usage(where).free)
            finally:
                shutil.rmtree(where, ignore_errors=True)
        run.phase("f_checkpoint_replay", f, inv=nothing)
        probe.check(run, {}, by_rank=True)
        tr_free()

        # g: r = 3, window 4, pipeline_depth 4 through `run` on the ring,
        # ranks 0, 1 and 3 lost after TR_MULTI_AT and recovered
        def g():
            u = tr_trainer(dev, cfg, mesh, redundancy=3, window=4,
                           pipeline_depth=4)
            check(u.pool.engine is not None and not u.pool.engine.patch,
                  "g: not the bulk engine")

            def lose(tr, out):
                if out["step"] == TR_MULTI_AT:
                    ev = tr.pool.inject(
                        lambda pr, p: failure.inject_multi_rank_loss(
                            pr, p, TR_MULTI_LOST))
                    rep = tr.on_failure(ev)
                    check(rep["verified"] and rep["reverified"],
                          f"g: recovery {rep}")
            u.add_step_hook(lose)
            probe_ms = probe.ms
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = u.run(steps)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 - (probe.ms - probe_ms)
            losses = [o["loss"] for o in outs]
            emit(path="tr", phase="g_split", steps=steps, wall_ms=wall,
                 probe_copies_ms=probe.ms - probe_ms,
                 ms_per_step=wall / steps,
                 tokens_per_s=TR_BATCH * TR_SEQ * steps / wall * 1e3,
                 losses=losses)
            check(all(o["committed"] for o in outs) and losses == b_loss,
                  f"g: losses {losses} != b's")
            host_same_as_fresh(run, u, "g_fresh_after_run")
            tr_same_state(u, b_final, "g")
            invariants(u.pool, "g_flushed")
            return u.pool
        run.phase("g_train_r3_w4_d4", g, inv=nothing)
        probe.check(run, {}, by_rank=True)
        tr_free()

        # h: replica 1 runs 10x slow: dropped; the loss-masked step commits
        # with the unmasked loss (the reference's re-weighting); healed
        def h():
            u = tr_trainer(dev, cfg, mesh, straggler_threshold=2.0)
            u.pool.straggler = StragglerPolicy(TR_MESH[0], threshold=2.0,
                                               window=2)
            u.replica_slowdown[TR_SLOW] = 10.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = [u.step() for _ in range(4)]
            check(u.pool.dropped_replicas == [TR_SLOW],
                  f"h: dropped {u.pool.dropped_replicas}")
            # the masked step's dispatch (batch, mask, train step, commit)
            # makes no host sync: set_sync_debug_mode raises on one
            torch.cuda.set_sync_debug_mode("error")
            try:
                pending = u._dispatch_step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            out = u._resolve_step(pending)
            outs.append(out)
            w = torch.tensor(1.0 - 1.0 / TR_MESH[0])      # the mask's mean
            masked = [float(torch.tensor(x) * w / w) for x in b_loss[:5]]
            check(out["committed"] and out["loss"] == masked[4]
                  and torch.equal(u.prot.digest, b_dig[4]),
                  f"h: masked step {out} != b's step 5 re-weighted")
            u.replica_slowdown[TR_SLOW] = 1.0
            outs += [u.step() for _ in range(2)]
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            check(u.pool.dropped_replicas == [], "h: not healed")
            emit(path="tr", phase="h_result", dropped_after=[
                o.get("dropped_replicas", []) for o in outs],
                losses=[o["loss"] for o in outs], masked_b_losses=masked,
                ms_per_step=wall / len(outs),
                tokens_per_s=TR_BATCH * TR_SEQ * len(outs) / wall * 1e3)
        run.phase("h_straggler", h, inv=nothing)
        probe.check(run, {}, by_rank=True)
        tr_free()
    probe.check(run, dict(run.build.LAUNCHES), by_rank=True)

    # i: the train step checked apart from the port, at full width
    def i():
        from repro_torch.data.synthetic import batch_for
        from repro_torch.models.transformer import build_model
        # the parameters every trainer starts from
        params = build_model(cfg).init(
            torch.Generator(dev).manual_seed(SEED), dev)
        batch = batch_for(cfg, TR_SEQ, TR_BATCH, SEED).device_batch(0, dev)
        emit(path="tr", phase="i_attention",
             **tr_attention_check(cfg, params, batch))
        tr_free()
        got = tr_grad_check(cfg, params, batch)
        check(abs(got["loss"] - b_loss[0]) == 0,
              f"i: the checked loss {got['loss']} != b's step 1")
        emit(path="tr", phase="i_loss_and_grads", **got)
        check(got["ok"], f"i: the train step off the f32 plain step: {got}")
    run.timed_aside("i_vs_f32_plain", i)
    return run.end(PATH_TR)


RG_ARCH = "recurrentgemma-2b"    # served at its published width and depth
RG_REDUCED = False               # True: the config's reduced() (a CPU rehearsal)
RG_OVERRIDES: dict = {}          # config fields replaced (a rehearsal's window)
RG_MESH = (4, 2)                 # the reference launcher's default mesh
RG_WIDE_MESH = (8, 1)            # rg g: the cache's sequence axis unsplit
RG_BATCH = 128                   # the reference's decode_32k global batch
RG_PROMPT, RG_NEW = 16, 16       # max_len is the window (2048); halved
                                 # from 32, 32 to make room for mv
RG_BW = 256                      # block_words, as launch/serve.py sets it
RG_SCRUB = 16
RG_LOST = 1                      # the rank rg e loses
RG_MULTI_LOST = (0, 1, 3)        # the ranks rg f loses at once
RG_EVENT = 8                     # generated tokens before rg e's loss
RG_F_EVENT = 10                  # before rg f's: two commits into a window
RG_F_WINDOW = 4
RG_H_CHUNK = 32                  # sequences of rg h's comparison a pass
PATH_RG = ("fletcher_blocks", "fletcher_stream", "fused_commit",
           "sdelta_stack", "gf_scale")


def soft_attention(params):
    """Scale every attention block's (d_model, heads, head_dim)
    projections wq, wk, wv in place to a std of 1/sqrt(d_model), the
    self attention's (`attn`) and the cross attention's (`xattn`) alike.
    The reference's init takes `heads` as their fan-in (ROADMAP queue C);
    recurrentgemma has no qk-norm and one KV head, so its scores would
    have a std of ~800 and the softmax would be one-hot: a bf16 rounding
    of q or k would pick another key, and the decode and the train step
    would sit at no fixed distance from an f32 forward
    (scripts/torch_hybrid_chaos.py).  seamless's cross attention reads
    the encoder's normed output, so its scores are one-hot the same way.
    At this scale q and k have a std of ~1 and the scores ~1, as a
    trained model's.  Returns `params`."""
    def walk(tree):
        for key, sub in tree.items():
            if key in ("attn", "xattn") and "wq" in sub:
                for w in (sub["wq"], sub["wk"], sub["wv"]):
                    w.mul_(math.sqrt(w.shape[-2] / w.shape[-3]))
            elif isinstance(sub, dict):
                walk(sub)
    with torch.no_grad():
        walk(params)
    return params


def hybrid_params(cfg, dev):
    """The hybrid's weights: random from SEED, the attention soft."""
    from repro_torch.models.transformer import build_model
    return soft_attention(build_model(cfg).init(
        torch.Generator(dev).manual_seed(SEED), dev))


def rg_footprint(srv):
    """A decode step's footprint as the server hands it to its pool (the
    reference's rule: a leaf with no local axis of length max_len is dirty
    whole) and the commit path the synchronous engine takes for it."""
    lo, prot = srv.protector.layout, srv.protector
    pages = srv._dirty_pages(0)
    words = srv._dirty_words(0)
    share = len(pages) / lo.n_blocks
    return dict(dirty_pages_per_step=len(pages), n_blocks=lo.n_blocks,
                dirty_share=share,
                whole_leaves=[list(sl.shape) for sl, w in
                              zip(lo.slots, words) if w is None],
                sliced_leaves=[list(sl.shape) for sl, w in
                               zip(lo.slots, words) if w is not None],
                commit_path=("patch" if share < prot.hybrid_threshold
                             else "bulk"))


def rg_final(srv):
    """The words of a server's pool that do not depend on r: row,
    checksums, digest."""
    return {k: getattr(srv.prot, k).clone() for k in ("row", "cksums",
                                                      "digest")}


def rg_same_final(srv, want, tag):
    for k, v in want.items():
        check(torch.equal(getattr(srv.prot, k), v), f"{tag}: {k} != b's")


def rg_reference(cfg, params, prompt, toks):
    """rg h: b's tokens teacher-forced through the served bf16 decode at
    every layer against `sv_plain_logits` on the same weights, RG_H_CHUNK
    sequences a comparison: its argmax gives b's tokens, every logit
    within SV_LOGIT_RTOL of the largest."""
    return sv_reference(cfg, params, prompt, toks, cfg.window,
                        chunk=RG_H_CHUNK)


def rg_wide_mesh(run, server, prompt, toks, end):
    """rg g: the same decode on an (8, 1) mesh, where the rings keep the
    whole sequence: a time slot a ring plus the recurrent state, so each
    commit takes the patch path; b's tokens, equal to a fresh open."""
    import numpy as np
    srv = server(mesh=RG_WIDE_MESH)
    fp_g = rg_footprint(srv)
    emit(path="rg", phase="g_layout", mesh=list(RG_WIDE_MESH), **fp_g)
    # sliced: the attn block's k, v and slot positions
    check(fp_g["commit_path"] == "patch"
          and len(fp_g["sliced_leaves"]) == 3, f"g: footprint {fp_g}")
    toks_g, l_g = run.phase("g_generate_wide_mesh", lambda: sv_clocked(
        run, "g", srv, prompt, n_new=RG_NEW), srv, inv=sv_invariants)
    check(np.array_equal(toks_g, toks), "g tokens != b's")
    check(l_g.get("fused_commit") == end, f"g launches {l_g}")
    host_same_as_fresh(run, srv, "g_fresh_after_g")


def hybrid_serving_path(dev):
    """The hybrid served at its published width and depth (phases rg a-h:
    `served_path`'s on (4, 2), where every commit is bulk, and g on (8,
    1))."""
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config(RG_ARCH, reduced=RG_REDUCED),
                              **RG_OVERRIDES)
    return served_path(dev, ServeCell(
        "rg", cfg, lambda: hybrid_params(cfg, dev), RG_MESH, RG_BATCH,
        cfg.window, RG_PROMPT, RG_NEW, RG_BW, RG_SCRUB, RG_LOST,
        RG_MULTI_LOST, RG_EVENT, RG_F_EVENT, RG_F_WINDOW, "bulk", PATH_RG,
        rg_reference, rg_wide_mesh))


RT_LAYERS = 3                    # one group (rglru, rglru, attn)
RT_REDUCED = False
# AdamW's moments in bf16 (the config's `moment_dtype`, as llama4-maverick
# sets it): an 8 B a parameter state, 7.09 GB.  At f32 moments the 10.63 GB
# state ran out of the card's memory in b's first commit (four state-sized
# copies beside the pool's).
RT_OVERRIDES: dict = {"moment_dtype": "bfloat16"}
RT_MESH = (4, 2)
RT_SEQ, RT_BATCH = 4096, 2       # twice the window: it masks in the step
RT_STEPS = 2                     # steps of b, c, d (4 until PR 27)
RT_SCRUB = 2
RT_LOST, RT_LOSS_AT = 1, 1       # rt d: rank 1 lost after step 1
PATH_RT = ("fletcher_blocks", "fletcher_stream",
           "fused_verify_commit_stream")


@dataclasses.dataclass
class TrainCell:
    """A trained path's numbers: its tag, model config, zone mesh, seq x
    batch, the steps of b, c and d, the scrub period, the rank d loses and
    the step it loses it after, the weights (a factory), the entry points
    that must launch, and `plain_hidden`'s keywords for i."""
    tag: str
    cfg: object
    mesh: tuple
    seq: int
    batch: int
    steps: int
    scrub: int
    lost: int
    loss_at: int
    params: object
    must_launch: tuple
    plain_kw: dict = dataclasses.field(default_factory=dict)


def trained_path(dev, c):
    """A model trained at its published width, depth cut (phases a-d, i:
    start; b half the steps bulk, half with verify_old; c unprotected, the
    losses and state bit-equal to b's; d a rank lost and recovered, on to
    b's losses, digests and state; i the bf16 step against a plain f32
    one).  `c`: a TrainCell."""
    from repro_torch import ZoneMesh, utils
    from repro_torch.runtime import failure
    run = PathRun(dev, c.tag)
    probe = CallProbe(host=True)
    cfg = c.cfg
    mesh = ZoneMesh(c.mesh, ("data", "model"))
    kw = dict(seq_len=c.seq, global_batch=c.batch, scrub_period=c.scrub,
              params=c.params)
    half = c.steps // 2

    t, _ = run.phase("a_start", lambda: tr_trainer(dev, cfg, mesh, **kw),
                     inv=nothing)
    lo = t.protector.layout
    state = t.pool.state
    emit(path=c.tag, phase="a_layout", arch=cfg.name, layers=cfg.n_layers,
         pattern=list(cfg.pattern), mesh=list(c.mesh), seq_len=c.seq,
         global_batch=c.batch, window=cfg.window,
         moment_dtype=cfg.moment_dtype or cfg.param_dtype,
         params=sum(x.numel() for x in utils.tree_leaves(state["params"])),
         state_bytes=sum(x.numel() * x.element_size()
                         for x in utils.tree_leaves(state)),
         leaves=len(lo.slots), row_words=lo.row_words, n_blocks=lo.n_blocks,
         block_words=lo.block_words)
    del state
    invariants(t.pool, "a_start")

    # b: 1-2 bulk commits, 3-4 with verify-at-open, mlpc r = 1
    def b():
        l1, d1 = tr_steps(run, "b_bulk", t, half)
        t.verify_old = True
        l2, d2 = tr_steps(run, "b_verify_old", t, c.steps - half)
        return l1 + l2, d1 + d2
    (b_loss, b_dig), _ = run.phase("b_train_r1", b, t.pool)
    check(all(math.isfinite(x) for x in b_loss), f"b: losses {b_loss}")
    b_final = tr_host_state(t)
    del t
    tr_free()

    # c: unprotected: the same losses and final state, bit for bit
    def unprotected():
        u = tr_trainer(dev, cfg, mesh, mode="none", **kw)
        losses, _ = tr_steps(run, "c_unprotected", u, c.steps)
        check(losses == b_loss, f"c: losses {losses} != b's {b_loss}")
        tr_same_state(u, b_final, "c")
    run.phase("c_train_unprotected", unprotected, inv=nothing)
    tr_free()

    with probe:
        # d: a rank lost after step loss_at and recovered; on to the end
        def d():
            u = tr_trainer(dev, cfg, mesh, **kw)
            losses, digs = tr_steps(run, "d_to_loss", u, c.loss_at, probe)
            row = u.prot.row.clone()
            ev = u.pool.inject(lambda pr, p: failure.inject_rank_loss(
                pr, p, c.lost))
            rep = u.on_failure(ev)
            check(rep["verified"] and rep["reverified"], f"d: {rep}")
            check(torch.equal(u.prot.row, row),
                  "d: recovered state != the copy taken before the loss")
            del row
            invariants(u.pool, "d_recovered")
            u.verify_old = True
            more, dg = tr_steps(run, "d_verify_old", u,
                                c.steps - c.loss_at, probe)
            losses, digs = losses + more, digs + dg
            check(losses == b_loss, f"d: losses {losses} != b's")
            check(all(torch.equal(a, b) for a, b in zip(digs, b_dig)),
                  "d: a step's digest != b's")
            tr_same_state(u, b_final, "d")
            return u.pool
        run.phase("d_rank_loss", d, inv=nothing)
        tr_free()
    probe.check(run, dict(run.build.LAUNCHES), by_rank=True)

    # i: the trained step checked apart from the port, at full width
    def i():
        from repro_torch.data.synthetic import batch_for
        params = c.params()
        batch = batch_for(cfg, c.seq, c.batch, SEED).device_batch(0, dev)
        got = tr_grad_check(cfg, params, batch, mesh, plain_kw=c.plain_kw)
        del params
        check(abs(got["loss"] - b_loss[0]) == 0,
              f"i: the checked loss {got['loss']} != b's step 1")
        emit(path=c.tag, phase="i_loss_and_grads", **got)
        check(got["ok"], f"i: the train step off the f32 plain step: {got}")
    run.timed_aside("i_vs_f32_plain", i)
    tr_free()
    return run.end(c.must_launch)


def hybrid_training_path(dev):
    """The hybrid trained at its published width, depth cut to one group
    (phases rt a-d, i)."""
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config(RG_ARCH, reduced=RT_REDUCED),
                              n_layers=RT_LAYERS, **RT_OVERRIDES)
    return trained_path(dev, TrainCell(
        "rt", cfg, RT_MESH, RT_SEQ, RT_BATCH, RT_STEPS, RT_SCRUB, RT_LOST,
        RT_LOSS_AT, lambda: hybrid_params(cfg, dev), PATH_RT))


@dataclasses.dataclass
class ServeCell:
    """A served path's numbers: its tag, model config, weights (a
    factory), zone mesh, batch, max_len, prompt and generated tokens,
    block_words, scrub period, the rank e loses, the ranks f loses and
    after how many generated tokens each loss comes, f's window, the
    commit path every decode step must take ("bulk" or "patch"), the entry
    points that must launch, h's comparison (cfg, params, prompt, tokens)
    -> the phase line's fields, and phases of the path's own after f
    (run, server factory, prompt, b's tokens, decode steps), or None;
    and `fill`: what every server takes after `start` (srv -> None: an
    encoder-decoder's cross cache), or None."""
    tag: str
    cfg: object
    params: object
    mesh: tuple
    batch: int
    max_len: int
    prompt: int
    new: int
    bw: int
    scrub: int
    lost: int
    multi_lost: tuple
    event: int
    f_event: int
    f_window: int
    commit_path: str
    must_launch: tuple
    h: object
    extra: object = None
    fill: object = None


def served_path(dev, c):
    """A model served at its published width (phases a-f, h): a start; b
    a clocked generation at r = 1; c the same unprotected, equal tokens;
    h the served bf16 decode against an f32 forward apart from the port;
    d a scribble after prefill scrubbed and repaired; e a rank lost
    mid-generation and recovered; f r = 3, window `f_window`, depth 4
    through the loss of three ranks inside an open window; then `extra`.
    Each kernel the path launched is then held against its plain version
    on the inputs of its first launch from d on, a data rank at a time.
    `c`: a ServeCell."""
    import numpy as np
    from repro_torch import Fault, ProtectConfig, ZoneMesh, utils
    from repro_torch.runtime import failure
    from repro_torch.runtime.server import Server
    run = PathRun(dev, c.tag)
    probe = CallProbe()
    cfg = c.cfg
    params = c.params()
    prompt = torch.randint(0, cfg.vocab, (c.batch, c.prompt),
                           generator=torch.Generator(dev).manual_seed(
                               SEED + 1), device=dev)
    end = c.prompt + c.new - 1              # decode steps a generation takes
    event_pos = c.prompt + c.event          # where e loses a rank

    def server(protect=True, mesh=c.mesh, **pcfg):
        srv = Server(cfg, ProtectConfig(mode="mlpc", block_words=c.bw,
                                        scrub_period=c.scrub, **pcfg),
                     ZoneMesh(mesh, ("data", "model")), batch=c.batch,
                     max_len=c.max_len, protect_cache=protect, device=dev)
        srv.start(params)
        if c.fill is not None:
            c.fill(srv)
        return srv

    # a: the server opens its pool over the empty cache
    srv, _ = run.phase("a_start", server, inv=sv_invariants)
    fp = rg_footprint(srv)
    lo = srv.protector.layout
    emit(path=c.tag, phase="a_layout", arch=cfg.name, layers=cfg.n_layers,
         pattern=list(cfg.pattern), tail=list(cfg.tail_pattern),
         mesh=list(c.mesh), batch=c.batch, max_len=c.max_len,
         params=sum(x.numel() for x in utils.tree_leaves(params)),
         cache_bytes=sum(x.numel() * x.element_size()
                         for x in utils.tree_leaves(srv.pool.state)),
         leaves=len(lo.slots), row_words=lo.row_words, **fp)
    check(fp["commit_path"] == c.commit_path,
          f"a: a decode step's footprint takes the {fp['commit_path']} "
          f"path: {fp}")

    # b: prefill + generate at r = 1, window 1, depth 1, clocked; the rows
    # at the positions d and e damage are kept for their checks
    rows = {}

    def keep(s, out):
        if out["pos"] + 1 in (c.prompt, event_pos):
            rows[out["pos"] + 1] = s.prot.row.clone()
    toks, l_b = run.phase("b_generate_r1", lambda: sv_clocked(
        run, "b", srv, prompt, keep, n_new=c.new), srv, inv=sv_invariants)
    if c.commit_path == "bulk":
        bulk = l_b.get("fletcher_stream", 0) + l_b.get("fletcher_blocks", 0)
        check(bulk >= end and not l_b.get("fused_commit"),
              f"b: a bulk footprint took {l_b}")
    else:
        check(l_b.get("fused_commit") == end, f"b: patch launches {l_b}")
    check(toks.shape == (c.batch, c.new) and toks.min() >= 0
          and toks.max() < cfg.vocab, f"tokens {toks.shape}")
    host_same_as_fresh(run, srv, "b_fresh_after_b")
    b_final = rg_final(srv)
    del srv
    torch.cuda.empty_cache()

    # c: protection does not change the decode path
    toks_c, _ = run.phase("c_generate_unprotected", lambda: sv_clocked(
        run, "c", server(protect=False), prompt, n_new=c.new), inv=nothing)
    check(np.array_equal(toks_c, toks), "unprotected tokens != protected")
    torch.cuda.empty_cache()

    # h: the served decode against an f32 forward apart from the port
    emit(path=c.tag, phase="h_result", **run.timed_aside(
        "h_vs_f32_forward", lambda: c.h(cfg, params, prompt, toks)))
    torch.cuda.empty_cache()

    with probe:
        # d: a scribble into rank 0's shard (a word of each leaf) after
        # prefill: scrub and repair
        srv = server()
        lo = srv.protector.layout
        offsets = [sl.offset + 11 for sl in lo.slots]
        out = []

        def scribble():
            out.extend(sv_steps(srv, prompt, None, c.prompt)[1])
            srv.pool.inject(lambda pr, p: failure.inject_scribble(
                pr, p, rank=0, word_offsets=offsets))
            report = srv.pool.scrub()
            want = {(0, o // lo.block_words) for o in offsets}
            check(set(report.bad_locations) == want, f"scrub {report}")
            check(report.repaired and report.repair_ok, f"repair {report}")
            check(torch.equal(srv.prot.row, rows[c.prompt]),
                  "d: repaired cache != b's at the same position")
        run.phase("d_prefill_scribble_repair", scribble, srv,
                  inv=sv_invariants)

        # e: a rank loss mid-generation at r = 1, recovered; to the end
        def rank_loss():
            event = srv.pool.inject(lambda pr, p: failure.inject_rank_loss(
                pr, p, c.lost))
            rep = srv.pool.recover(Fault.from_event(event))
            check(rep.verified and rep.reverified, f"recovery {rep}")
            check(torch.equal(srv.prot.row, rows[event_pos]),
                  "e: recovered cache != b's at the same position")

        def rest():
            out.extend(sv_steps(srv, prompt, out[-1], end,
                                {event_pos: rank_loss})[1])
            return sv_tokens(srv, out)
        toks_e, _ = run.phase("e_rank_loss_recover", rest, srv,
                              inv=sv_invariants)
        check(np.array_equal(toks_e, toks), "d / e tokens != b's")
        rg_same_final(srv, b_final, "e")
        del srv, rows
        torch.cuda.empty_cache()

        # f: r = 3, window f_window (the deferred engine), depth 4 (the
        # commit ring) through a loss of three ranks inside an open window
        srv, _ = run.phase("f_start_r3_w4_d4", lambda: server(
            redundancy=3, window=c.f_window, pipeline_depth=4), inv=nothing)
        check(srv.pool.engine is not None and srv.pool.engine.patch,
              "f: not the patch engine")
        # the host's count of a step's declared pages, which the patch
        # engine makes before every commit (`_check_footprint`)
        eng, words = srv.pool.engine, srv._dirty_words(c.prompt)
        t0 = time.perf_counter()
        pages = [eng._declared_pages(words) for _ in range(20)]
        emit(path=c.tag, phase="f_footprint_count",
             ms=(time.perf_counter() - t0) * 1e3 / 20, pages=pages[0],
             dirty_capacity=eng.dirty_capacity, checked=eng._capped)

        def multi_loss():
            check(srv.pool.engine.needs_flush, "f: the loss is not mid-window")
            event = srv.pool.inject(
                lambda pr, p: failure.inject_multi_rank_loss(
                    pr, p, c.multi_lost))
            rep = srv.pool.recover(Fault.from_event(event))
            check(rep.verified and rep.reverified, f"recovery {rep}")
        toks_f, _ = run.phase("f_generate_loss_of_3", lambda: sv_tokens(
            srv, sv_steps(srv, prompt, None, end,
                          {c.prompt + c.f_event: multi_loss})[1]),
            inv=nothing)
        check(np.array_equal(toks_f, toks), "f tokens != b's")
        host_same_as_fresh(run, srv, "f_fresh_after_f")
        sv_invariants(srv, "f_flushed")
        rg_same_final(srv, b_final, "f")
        del srv
        torch.cuda.empty_cache()
        if c.extra is not None:
            c.extra(run, server, prompt, toks, end)
            torch.cuda.empty_cache()
    probe.check(run, dict(run.build.LAUNCHES), by_rank=True)
    del params
    return run.end(c.must_launch)


XS_ARCH = "xlstm-1.3b"           # served at its published width and depth
XS_REDUCED = False               # True: the config's reduced() (a CPU rehearsal)
XS_MESH = (4, 2)
# the batch the reckoning admits beside the weights: a 2,826,242,688 B
# state (706,560,672 B a sequence), each decode step rewriting it whole
XS_BATCH = 4
XS_MAX_LEN = 2048                # off every local state axis (6, 1, 2, 3,
                                 # 512, 1024, 4096): no leaf has a time axis
XS_PROMPT, XS_NEW = 16, 16       # halved from 32, 32 to make room for mv
XS_BW = 256
XS_SCRUB = 16
XS_EVENT, XS_F_EVENT = 8, 10     # generated tokens before e's / f's loss
PATH_XS = ("fletcher_blocks", "fletcher_stream", "sdelta_stack",
           "gf_scale")
XT_LAYERS = 8                    # one group: 7 mLSTM + 1 sLSTM
XT_REDUCED = False
# AdamW's moments in bf16, as rt's: the mLSTM's w_up, w_down and gates
# are split over `data` only, so on (4, 2) the zone rows hold them twice
# and the f32-moment state's 5.95 GB makes 11.4 GB of rows; b's first
# verify_old commit ran out of the card's memory there, and at batch 1
# (`scripts/torch_path_rerun.py xt-f32-batch1`) as well.  bf16 moments: a
# 3.97 GB state.
XT_OVERRIDES: dict = {"moment_dtype": "bfloat16"}
XT_MESH = (4, 2)
XT_SEQ, XT_BATCH = 4096, 2       # train_4k's length: 16 chunks of 256
XT_STEPS = 2                     # 4 until PR 27
XT_SCRUB = 2
XT_LOST, XT_LOSS_AT = 1, 1
XT_PLAIN_CHUNK = 64              # i's plain mLSTM: chunks of 64, not 256
PATH_XT = ("fletcher_blocks", "fletcher_stream",
           "fused_verify_commit_stream")


def soft_xlstm(params, n_layers):
    """Condition an xLSTM's random weights in place as a trained model's
    are: the token embeddings at a std of 1 (the init's 0.02), each
    block's output projection (mLSTM w_down, sLSTM w_out) at 1 /
    sqrt(2 n_layers) (GPT-2's residual scaling), and the sLSTM's w_in at a
    d_model fan-in (the reference's init takes `heads`: gate
    pre-activations of std ~22).  At the reference's init each block's
    output dwarfs the 0.02 embedding and feeds the next with a gain above
    1, so the stack is chaotic: a bf16 forward of 8 mLSTM blocks sits
    over 2^-4 of the largest logit from the f32 one, and within 2^-5
    here (ROADMAP queue C).  Returns `params`."""
    with torch.no_grad():
        params["embed"]["tok"].mul_(1 / EMBED_STD)
        out = 1 / math.sqrt(2 * n_layers)
        blocks = [g["cell"] for g in params["groups"].values()] + [
            v["cell"] for k, v in params.items() if k.startswith("tail")]
        for c in blocks:
            if "w_down" in c:
                c["w_down"].mul_(out)
            else:
                c["w_out"].mul_(out)
                w = c["w_in"]
                w.mul_(math.sqrt(w.shape[-2] / w.shape[-4]))
    return params


EMBED_STD = 0.02                 # the token embeddings' init scale


def xlstm_params(cfg, dev):
    """The xLSTM's weights: random from SEED, conditioned by
    `soft_xlstm`."""
    from repro_torch.models.transformer import build_model
    return soft_xlstm(build_model(cfg).init(
        torch.Generator(dev).manual_seed(SEED), dev), cfg.n_layers)


def xs_reference(cfg, params, prompt, toks):
    """xs h: b's tokens teacher-forced through the served bf16 decode at
    every layer against `sv_plain_logits` on the same weights, the mLSTM
    stepped a position at a time: its argmax gives b's tokens, every logit
    within SV_LOGIT_RTOL of the largest; the argmax agreement."""
    return sv_reference(cfg, params, prompt, toks, XS_MAX_LEN)


def xlstm_serving_path(dev):
    """xlstm-1.3b served at its published width and depth (phases xs)."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(XS_ARCH, reduced=XS_REDUCED)
    return served_path(dev, ServeCell(
        "xs", cfg, lambda: xlstm_params(cfg, dev), XS_MESH, XS_BATCH,
        XS_MAX_LEN, XS_PROMPT, XS_NEW, XS_BW, XS_SCRUB, RG_LOST,
        RG_MULTI_LOST, XS_EVENT, XS_F_EVENT, RG_F_WINDOW, "bulk", PATH_XS,
        xs_reference))


def xlstm_training_path(dev):
    """xlstm-1.3b trained at its published width, depth cut to one group
    (phases xt a-d, i; AdamW with bf16 moments)."""
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config(XS_ARCH, reduced=XT_REDUCED),
                              n_layers=XT_LAYERS, **XT_OVERRIDES)
    return trained_path(dev, TrainCell(
        "xt", cfg, XT_MESH, XT_SEQ, XT_BATCH, XT_STEPS, XT_SCRUB, XT_LOST,
        XT_LOSS_AT, lambda: xlstm_params(cfg, dev), PATH_XT,
        {"mlstm_chunk": XT_PLAIN_CHUNK}))


MO_ARCH = "moonshot-v1-16b-a3b"  # at its published width
MO_REDUCED = False
MO_LAYERS = 8                    # the depth the reckoning admits
MO_MESH = (4, 2)
MO_BATCH, MO_MAX_LEN = 16, 2048  # a 2,147,549,184 B KV cache
MO_PROMPT, MO_NEW = 32, 32
MO_BW = 256
MO_SCRUB = 16
MO_EVENT, MO_F_EVENT = 16, 18
PATH_MO = ("fletcher_blocks", "fused_commit", "fused_commit_s",
           "sdelta_stack", "gf_scale")
MT_LAYERS = 2                    # two groups: the layer checkpointing
MT_SEQ, MT_BATCH = 1024, 1
MT_MESH = (4, 2)                 # routing in its 4 data-shard groups
MV_ARCH = "llama4-maverick-400b-a17b"  # at its published width
MV_REDUCED = False
MV_LAYERS = 2                    # one ("dense", "moe") group: 37.1 GB
MV_MESH = (4, 2)
MV_BATCH = 64                    # the reference's decode_32k global batch
                                 # (128) halved: at 128 mv's peak on an
                                 # H100 80GB HBM3 was 77.2 GB reserved
MV_MAX_LEN = 2048                # a 1,073,741,824 B KV cache
MV_PROMPT, MV_NEW = 32, 32
MV_BW = 256
MV_SCRUB = 16
MV_EVENT, MV_F_EVENT = 16, 18
MV_H_CHUNK = 32                  # sequences of mv h's comparison a pass
PATH_MV = PATH_MO


def moe_reference(cfg, params, prompt, toks, max_len, chunk=None,
                  follow=False):
    """A moe model's h: b's tokens teacher-forced through the served bf16
    decode against `sv_plain_logits` (every expert choice kept: a decode
    step's capacity is its whole group), `chunk` sequences a comparison,
    within SV_LOGIT_RTOL of the largest logit, its argmax b's tokens; the
    share of (token, layer) expert choices the bf16 decode and the f32
    forward make alike, held to ROUTER_AGREEMENT, and the count of those
    that differ.  `follow`: the f32 forward sends each token to the
    experts the decode chose (`RouteRecorder`) for the logit bound, while
    the share is held on the choices its own router makes."""
    B, S = prompt.shape[0], prompt.shape[1] + toks.shape[1] - 1
    n_moe = (cfg.n_layers // len(cfg.pattern) * cfg.pattern.count("moe")
             + cfg.tail_pattern.count("moe"))
    plain = []

    def kw(lo, hi):
        """A chunk's keywords: its record and, following, the decode's
        choices for its sequences, each layer's in (sequence, position)
        order."""
        if not follow:
            return {"record": plain}
        return {"record": plain, "follow": [torch.stack(
            [rec.calls[t * n_moe + layer][0][lo:hi] for t in range(S)],
            1).reshape((hi - lo) * S, -1) for layer in range(n_moe)]}
    with RouteRecorder() as rec:
        out = sv_reference(cfg, params, prompt, toks, max_len, chunk=chunk,
                           plain_kw=kw)
    steps = [rec.calls[t * n_moe:(t + 1) * n_moe] for t in range(S)]
    port = [steps[t][layer] for layer in range(n_moe) for t in range(S)]
    mine = []
    for layer in range(n_moe):
        i, k = (torch.cat(x) for x in zip(*plain[layer::n_moe]))
        mine += [(i.reshape(B, S, -1)[:, t], k.reshape(B, S, -1)[:, t])
                 for t in range(S)]
    share = choice_agreement(port, mine)
    choices = sum(i.numel() for i, _ in port)
    out = dict(out, routing="the decode's" if follow else "its own",
               expert_choice_agreement=share,
               expert_choice_bound=ROUTER_AGREEMENT,
               expert_choices=choices,
               expert_choices_differing=round(choices * (1 - share)))
    check(share >= ROUTER_AGREEMENT,
          f"h: expert choices made alike {share} "
          f"(floor {ROUTER_AGREEMENT}): {out}")
    return out


def mo_reference(cfg, params, prompt, toks):
    """mo h: `moe_reference` over every sequence at once, the f32 forward
    routed by its own router."""
    return moe_reference(cfg, params, prompt, toks, MO_MAX_LEN)


def moe_serving_path(dev):
    """moonshot served at its published width, depth cut (phases mo)."""
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config(MO_ARCH, reduced=MO_REDUCED),
                              n_layers=MO_LAYERS)
    return served_path(dev, ServeCell(
        "mo", cfg, lambda: hybrid_params(cfg, dev), MO_MESH, MO_BATCH,
        MO_MAX_LEN, MO_PROMPT, MO_NEW, MO_BW, MO_SCRUB, RG_LOST,
        RG_MULTI_LOST, MO_EVENT, MO_F_EVENT, RG_F_WINDOW, "patch", PATH_MO,
        mo_reference))


def mv_reference(cfg, params, prompt, toks):
    """mv h: `moe_reference` MV_H_CHUNK sequences a pass (each pass
    widens the unembedding, 4.14 GB), the f32 forward on the decode's
    routes: with one expert a token, a choice the two routers make
    differently swaps the token's whole routed output, and on its own
    routes the f32 forward is past SV_LOGIT_RTOL at every such position
    (`scripts/torch_path_rerun.py mv-h`)."""
    return moe_reference(cfg, params, prompt, toks, MV_MAX_LEN, MV_H_CHUNK,
                         follow=True)


def maverick_serving_path(dev):
    """llama4-maverick served at its published width, one ("dense",
    "moe") group of its 24 (phases mv, as mo's)."""
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config(MV_ARCH, reduced=MV_REDUCED),
                              n_layers=MV_LAYERS)
    return served_path(dev, ServeCell(
        "mv", cfg, lambda: hybrid_params(cfg, dev), MV_MESH, MV_BATCH,
        MV_MAX_LEN, MV_PROMPT, MV_NEW, MV_BW, MV_SCRUB, RG_LOST,
        RG_MULTI_LOST, MV_EVENT, MV_F_EVENT, RG_F_WINDOW, "patch", PATH_MV,
        mv_reference))


def moe_step_path(dev):
    """moonshot's train step at its published width, two layers, routed
    in the (4, 2) mesh's groups, against the f32 plain step (phase mt i;
    unprotected: a train state and a pool do not fit beside it)."""
    from repro_torch import ZoneMesh, utils
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import batch_for
    run = PathRun(dev, "mt")
    cfg = dataclasses.replace(get_config(MO_ARCH, reduced=MO_REDUCED),
                              n_layers=MT_LAYERS)

    def i():
        params = hybrid_params(cfg, dev)
        batch = batch_for(cfg, MT_SEQ, MT_BATCH, SEED).device_batch(0, dev)
        got = tr_grad_check(cfg, params, batch,
                            ZoneMesh(MT_MESH, ("data", "model")))
        emit(path="mt", phase="i_loss_and_grads", arch=cfg.name,
             layers=cfg.n_layers, seq_len=MT_SEQ, global_batch=MT_BATCH,
             params=sum(p.numel() for p in utils.tree_leaves(params)),
             **got)
        check(got["ok"], f"i: the train step off the f32 plain step: {got}")
    run.phase("i_vs_f32_plain", i, inv=nothing)
    tr_free()
    return run.end(())


VL_ARCH = "chameleon-34b"        # at its published width
VL_REDUCED = False
VL_LAYERS = 2                    # two groups: the layer checkpointing
VL_SEQ, VL_BATCH = 1024, 1       # 256 stub positions + 768 tokens


def vlm_path(dev):
    """The vlm's train step at its published width, depth cut to two
    layers, against the f32 plain step (phase vl i; unprotected: a train
    state and a pool do not fit beside it)."""
    from repro_torch import utils
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import batch_for
    from repro_torch.models.transformer import build_model
    run = PathRun(dev, "vl")
    cfg = dataclasses.replace(get_config(VL_ARCH, reduced=VL_REDUCED),
                              n_layers=VL_LAYERS)

    def i():
        params = build_model(cfg).init(
            torch.Generator(dev).manual_seed(SEED), dev)
        batch = batch_for(cfg, VL_SEQ, VL_BATCH, SEED).device_batch(0, dev)
        got = tr_grad_check(cfg, params, batch)
        emit(path="vl", phase="i_loss_and_grads", arch=cfg.name,
             layers=cfg.n_layers, seq_len=VL_SEQ, global_batch=VL_BATCH,
             mm_positions=cfg.mm_positions,
             params=sum(p.numel() for p in utils.tree_leaves(params)),
             **got)
        check(got["ok"], f"i: the train step off the f32 plain step: {got}")
    run.phase("i_vs_f32_plain", i, inv=nothing)
    tr_free()
    return run.end(())


ES_ARCH = "seamless-m4t-large-v2"  # served at its published width and depth
ES_REDUCED = False
ES_MESH = (4, 2)                 # 16 KV heads split over `model`
# batch 8, cut from decode_32k's 128: a 3,221,422,080 B cache, half of it
# the cross K/V; batch 16's 6.44 GB cache would not fit beside the
# weights' f32 and bf16 copies and the pool's rows at ~15x the cache
ES_BATCH = 8
ES_MAX_LEN = 2048                # the served source's length too
ES_PROMPT, ES_NEW = 32, 32
ES_BW = 256
ES_SCRUB = 16
ES_EVENT, ES_F_EVENT = 16, 18
ES_ZERO_STEPS = 4                # es a's decode steps on the zero cross cache
PATH_ES = ("fletcher_blocks", "fused_commit",
           "fused_verify_commit_stream", "fused_commit_s", "sdelta_stack",
           "gf_scale")
ET_LAYERS = 2                    # 2 encoder + 2 decoder layers: two groups
ET_REDUCED = False               # each, so both stacks run checkpointed;
                                 # the config's f32 AdamW moments: a 7.81 GB
                                 # state, which fits (68.46 GB peak)
ET_MESH = (4, 2)
ET_SEQ, ET_BATCH = 4096, 2       # source and target lengths
ET_STEPS = 2                     # 4 until PR 27
ET_SCRUB = 2
PATH_ET = ("fletcher_blocks", "fletcher_stream",
           "fused_verify_commit_stream")


def ed_cross(model, params, src):
    """An encoder-decoder's cross K/V of `src` (B, S_src, D): the source
    encoded and projected a decoder layer at a time (the prefill)."""
    with torch.no_grad():
        return model.build_cross_cache(params, model.encode(params, src))


def ed_fill(srv, cross):
    """Write `cross` into a started server's cache in place of the zeros
    `start` opened it over: the cache with its two cross leaves replaced,
    one bulk commit with verify_old on the synchronous engine.  The
    deferred patch engine refuses a commit of more pages than a decode
    step's footprint (its flush holds that many), so there the pool is
    opened again over the filled cache (`Pool.init`); an unprotected
    server takes the cache as it is."""
    cache = dict(srv._current_cache(), cross=cross)
    if srv.pool is None:
        srv.cache = cache
    elif srv.pool.engine is None:
        check(bool(srv.pool.commit(cache, verify_old=True)),
              "the cross cache's commit aborted")
    else:
        srv.pool.init(cache)


class CrossFill:
    """es's `ServeCell.fill`: the source encoded by the first server's
    weights (cast to bf16 once, as every server casts them) into the cross
    K/V, kept and written into every server after its start (`ed_fill`);
    the first fill's ms and launches on a line of its own."""

    def __init__(self, run_tag, src):
        self.tag, self.src, self.cross = run_tag, src, None

    def __call__(self, srv):
        from repro_torch.kernels import _build
        if self.cross is None:
            self.cross = ed_cross(srv.model, srv.params, self.src)
            torch.cuda.synchronize()
            before = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            ed_fill(srv, self.cross)
            torch.cuda.synchronize()
            emit(path=self.tag, phase="fill_cross_commit",
                 ms=(time.perf_counter() - t0) * 1e3,
                 cross_bytes=sum(x.numel() * x.element_size()
                                 for x in self.cross.values()),
                 launches={k: v - before.get(k, 0)
                           for k, v in _build.LAUNCHES.items()
                           if v - before.get(k, 0)})
            return
        ed_fill(srv, self.cross)


def es_zero_cross(dev, cfg, params):
    """es a0: the reference's serving, whose `Server` never encodes a
    source: ES_ZERO_STEPS decode steps on the cross cache `start` leaves
    zero, protected and unprotected, equal tokens; the pool's cross
    leaves still zero.  The footprint a step declares: a time slot of
    each self and each cross K/V leaf (the cross slot is never written).
    Returns the phases' launches."""
    from repro_torch import ProtectConfig, ZoneMesh, utils
    from repro_torch.runtime.server import Server
    run = PathRun(dev, "es")
    prompt = torch.randint(0, cfg.vocab, (ES_BATCH, ES_ZERO_STEPS),
                           generator=torch.Generator(dev).manual_seed(
                               SEED + 1), device=dev)

    def steps(protect):
        srv = Server(cfg, ProtectConfig(mode="mlpc", block_words=ES_BW,
                                        scrub_period=ES_SCRUB),
                     ZoneMesh(ES_MESH, ("data", "model")), batch=ES_BATCH,
                     max_len=ES_MAX_LEN, protect_cache=protect, device=dev)
        srv.start(params)
        toks = [srv.step(prompt[:, t]) for t in range(ES_ZERO_STEPS)]
        return srv, torch.stack(toks, 1).cpu()

    (srv, toks), _ = run.phase("a0_zero_cross_protected",
                               lambda: steps(True), inv=nothing)
    cross = srv.pool.state["cross"]
    check(all(not bool(x.any()) for x in cross.values()),
          "a0: the served cross cache is not zero")
    lo = srv.protector.layout
    leaves = utils.tree_leaves(srv.model.init_cache(1, 1, "meta"))
    names = ["cross/k", "cross/v", "groups/k", "groups/pos", "groups/v"]
    check(len(leaves) == len(names), f"a0: cache leaves {len(leaves)}")
    words = srv._dirty_words(ES_ZERO_STEPS)
    declared = {n: (None if w is None else len(w))
                for n, w in zip(names, words)}
    emit(path=run.tag, phase="a0_footprint", declared_words=declared,
         dirty_pages_per_step=len(srv._dirty_pages(ES_ZERO_STEPS)),
         n_blocks=lo.n_blocks)
    check(all(isinstance(v, int) and v for v in declared.values()),
          f"a0: a leaf declared whole or not at all: {declared}")
    del srv, cross
    (_, toks_u), _ = run.phase("a0_zero_cross_unprotected",
                               lambda: steps(False), inv=nothing)
    check(torch.equal(toks, toks_u), "a0: unprotected tokens != protected")
    emit(path=run.tag, phase="a0_tokens_equal", steps=ES_ZERO_STEPS,
         tokens=toks.tolist())
    return dict(run.build.LAUNCHES)


def encdec_serving_path(dev):
    """seamless-m4t-large-v2 served at its published width and depth
    (phases es): a0 on the zero cross cache, then `served_path`'s a-f, h
    with the cross cache filled from a source of ES_MAX_LEN frames of the
    synthetic stream after every start.  Returns the launches of both."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import batch_for
    cfg = get_config(ES_ARCH, reduced=ES_REDUCED)
    params = hybrid_params(cfg, dev)
    zero = es_zero_cross(dev, cfg, params)
    src = torch.from_numpy(batch_for(cfg, ES_MAX_LEN, ES_BATCH, SEED)
                           .batch_at(0)["src_embeds"]).to(dev)
    counts = served_path(dev, ServeCell(
        "es", cfg, lambda: params, ES_MESH, ES_BATCH, ES_MAX_LEN,
        ES_PROMPT, ES_NEW, ES_BW, ES_SCRUB, RG_LOST, RG_MULTI_LOST,
        ES_EVENT, ES_F_EVENT, RG_F_WINDOW, "patch", PATH_ES,
        lambda cfg, params, prompt, toks: sv_reference(
            cfg, params, prompt, toks, ES_MAX_LEN, src=src),
        fill=CrossFill("es", src)))
    return {k: counts.get(k, 0) + zero.get(k, 0)
            for k in set(counts) | set(zero)}


def encdec_training_path(dev):
    """seamless-m4t-large-v2 trained at its published width, each stack
    cut to ET_LAYERS layers (phases et a-d, i)."""
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config(ES_ARCH, reduced=ET_REDUCED),
                              n_layers=ET_LAYERS, enc_layers=ET_LAYERS)
    return trained_path(dev, TrainCell(
        "et", cfg, ET_MESH, ET_SEQ, ET_BATCH, ET_STEPS, ET_SCRUB, RT_LOST,
        RT_LOSS_AT, lambda: hybrid_params(cfg, dev), PATH_ET))


# -- the tooling: the examples, the dry run, the compressed mean -------------

PATH_EX = ("fletcher_blocks", "fletcher_stream", "fused_commit",
           "sdelta_stack", "gf_scale")
EXAMPLES = (("quickstart", "torch_quickstart", []),
            ("serve", "torch_serve_protected", ["--smoke"]),
            ("train", "torch_train_fault_tolerant", ["--smoke"]),
            ("train_r3", "torch_train_fault_tolerant",
             ["--smoke", "--redundancy", "3"]),
            ("elastic", "torch_elastic_rescale", ["--smoke"]))
DR_ARCH = "qwen3-0.6b"           # the dry run's cells, at full size
DR_TIMEOUT_S = 900               # the meta trace's process, at most
DR_POS = 32                      # dr b's decode position (sv's after prefill)
CM_MESH = (2, 4, 2)              # pod x data x model


def example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_path(dev):
    """The four examples' main(), each on the card with its own asserts;
    the train example's checkpoints in a directory removed after."""
    import tempfile
    run = PathRun(dev, "ex")
    for tag, name, argv in EXAMPLES:
        with tempfile.TemporaryDirectory() as ckpt:
            extra = (["--ckpt-dir", ckpt] if name.startswith("torch_train")
                     else [])
            run.phase(tag, lambda: example(name).main(
                argv + extra + ["--device", dev.type]), inv=nothing)
    return run.end(PATH_EX)


def dryrun_start(out_dir):
    """The dry run's cells of DR_ARCH on meta, in a process of its own; a
    thread reads its output and notes when it exits."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    out = os.path.join(out_dir, "dryrun.json")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         DR_ARCH, "--mesh", "single", "--out", out], env=env, cwd=out_dir,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    done = {}

    def collect():
        done["log"], _ = proc.communicate()
        done["end"] = time.perf_counter()
    watch = threading.Thread(target=collect, daemon=True)
    watch.start()
    return proc, out, t0, (watch, done)


def sv_step_costs(dev):
    """dr b: one protected serving step at sv's shapes on the card under
    the cost mode, and the same step traced on meta."""
    from repro_torch import ProtectConfig, utils
    from repro_torch.launch import cost, dryrun
    from repro_torch.pool import Pool
    from repro_torch.models.transformer import build_model
    cfg, mesh, params, prompt = sv_model(dev)
    model = build_model(cfg, mesh)
    cache_abs = model.init_cache(SV_BATCH, SV_MAX_LEN, device="meta")
    specs = model.cache_specs(SV_BATCH, SV_MAX_LEN, mesh)
    # a cold pool a device: the layout, the programs, the zone views
    pool, meta_pool = (Pool(mesh, cache_abs, specs,
                            ProtectConfig(block_words=SV_BW), device=d)
                       for d in (dev, "meta"))
    params = model.compute_params(params)
    token = prompt[:, 0]
    prot = pool.protector.init(pool.to_zone(
        model.init_cache(SV_BATCH, SV_MAX_LEN, dev)))
    step = dryrun.protected_serve_step(model, pool, SV_MAX_LEN, DR_POS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    with cost.CostMode() as card:
        prot2, tok, ok = step(params, token, prot)
        torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    growth = torch.cuda.max_memory_allocated(dev) - base
    check(bool(ok) and 0 <= int(tok.min()) and int(tok.max()) < cfg.vocab,
          f"dr b: the step on the card: ok {bool(ok)}, tokens {tok}")
    del prot2, tok, ok
    # the same step warm, without and with the cost mode: what counting
    # costs the host when it is on
    warm = {}
    for tag, mode in (("off", None), ("on", cost.CostMode)):
        with (mode() if mode else contextlib.nullcontext()):
            t0 = time.perf_counter()
            step(params, token, prot)
            torch.cuda.synchronize()
        warm[tag] = (time.perf_counter() - t0) * 1e3
    del prot
    meta_args = (utils.tree_map(lambda p: torch.empty(
        p.shape, dtype=p.dtype, device="meta"), params),
        torch.empty_like(token, device="meta"),
        meta_pool.protector.abstract_protected(cache_abs))
    step = dryrun.protected_serve_step(model, meta_pool, SV_MAX_LEN, DR_POS)
    t0 = time.perf_counter()
    with cost.CostMode() as meta:
        step(*meta_args)
    meta_ms = (time.perf_counter() - t0) * 1e3
    a, b = card.record(), meta.record()
    emit(path="dr", phase="b_serve_step", arch=cfg.name, batch=SV_BATCH,
         max_len=SV_MAX_LEN, mesh=list(SV_MESH), pos=DR_POS, card=a, meta=b,
         card_ms=card_ms, warm_ms=warm["off"], warm_counted_ms=warm["on"],
         meta_trace_ms=meta_ms, card_growth_bytes=growth,
         growth_over_meta_peak=growth / b["peak_bytes"])
    for k in ("flops", "mm_flops", "hbm_bytes", "ops", "launches",
              "kernels", "wire_bytes", "wire_counts"):
        check(a[k] == b[k], f"dr b: {k} on the card {a[k]} != on meta {b[k]}")
    check(growth >= b["peak_bytes"] > 0, f"dr b: the card's growth {growth} "
          f"under the meta peak {b['peak_bytes']}")


def dryrun_path(dev, proc, out, t0, watched):
    """dr a: the meta cells' records (the process started with the run,
    given DR_TIMEOUT_S from its start); dr b: `sv_step_costs`."""
    run = PathRun(dev, "dr")
    watch, done = watched
    try:
        watch.join(timeout=max(1, DR_TIMEOUT_S - (time.perf_counter() - t0)))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    watch.join()
    print(done.get("log", ""), end="", flush=True)
    check(proc.returncode == 0, f"dr a: the dry run exited {proc.returncode}")
    with open(out) as f:
        recs = json.load(f)
    check([r["status"] for r in recs] == ["ok", "ok", "ok", "skip"],
          f"dr a: {[(r['workload'], r['status']) for r in recs]}")
    for r in recs:
        emit(path="dr", phase="a_cell", record=r)
    process_s = done["end"] - t0
    emit(path="dr", phase="a_wall", ms=(time.perf_counter() - t0) * 1e3,
         process_s=process_s, timeout_s=DR_TIMEOUT_S,
         margin_s=DR_TIMEOUT_S - process_s,
         note="ms: from the run's start to this path; process_s: the meta "
              "trace's process, beside the card's paths, to its exit")
    run.phase("b_serve_step_card_vs_meta", lambda: sv_step_costs(dev),
              inv=nothing)
    return run.end(("fused_commit",))


def crosspod_path(dev):
    """cm: the compressed mean of qwen3-0.6b's gradients at full width on
    the card, its embedding's and stacked attention's leaves byte-equal
    to the same call on the CPU."""
    from repro_torch import ZoneMesh, utils
    from repro_torch.configs.registry import get_config
    from repro_torch.models import params as prm
    from repro_torch.models.transformer import build_model
    from repro_torch.optim.compress import (init_error_feedback,
                                            make_crosspod_compressed_mean)
    run = PathRun(dev, "cm")
    cfg = get_config(SV_ARCH, reduced=SV_REDUCED)
    mesh = ZoneMesh(CM_MESH, ("pod", "data", "model"))
    model = build_model(cfg, mesh)
    specs = model.param_specs(mesh)
    gen = torch.Generator(dev).manual_seed(SEED)
    grads = prm._map(lambda d: torch.randn(
        d.shape, device=dev, generator=gen) * 1e-3, model.param_defs())
    ef = init_error_feedback(grads)
    nbytes = sum(g.numel() * 4 for g in utils.tree_leaves(grads))
    f = make_crosspod_compressed_mean(mesh, specs)
    out, new_ef = run.phase("a_card", lambda: f(grads, ef), inv=nothing)[0]
    check(all(bool(torch.isfinite(t).all()) for t in utils.tree_leaves(out)),
          "cm: a non-finite mean")
    subset = {"embed": grads["embed"], "attn": grads["groups"]["b0_dense"][
        "attn"]}
    sub_specs = {"embed": specs["embed"], "attn": specs["groups"][
        "b0_dense"]["attn"]}
    host = utils.tree_map(lambda t: t.cpu(), subset)
    t0 = time.perf_counter()
    want, want_ef = make_crosspod_compressed_mean(mesh, sub_specs)(
        host, init_error_feedback(host))
    cpu_ms = (time.perf_counter() - t0) * 1e3
    got = {"embed": out["embed"], "attn": out["groups"]["b0_dense"]["attn"]}
    got_ef = {"embed": new_ef["embed"],
              "attn": new_ef["groups"]["b0_dense"]["attn"]}
    pairs = list(zip(utils.tree_leaves(got) + utils.tree_leaves(got_ef),
                     utils.tree_leaves(want) + utils.tree_leaves(want_ef)))
    equal = all(torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
                for a, b in pairs)
    emit(path="cm", phase="b_card_vs_cpu", mesh=list(CM_MESH),
         grad_bytes=nbytes, leaves_checked=len(pairs) // 2,
         bytes_checked=sum(b.numel() * 4 for _, b in pairs) // 2,
         cpu_ms=cpu_ms, equal=equal)
    check(equal, "cm: the card's mean or error feedback != the CPU's")
    return run.end(())


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from repro_torch.kernels import _build
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    t_run = time.perf_counter()
    scratch = tempfile.TemporaryDirectory()
    dr = dryrun_start(scratch.name)
    try:
        t0 = time.perf_counter()
        _build.build()
        emit(phase="build", ms=(time.perf_counter() - t0) * 1e3,
             sources=list(_build.SOURCES))
        rows = run_paths(dev, dr)
        emit(phase="total", ms=(time.perf_counter() - t_run) * 1e3)
    finally:
        if dr[0].poll() is None:
            dr[0].kill()
            dr[0].wait()
        scratch.cleanup()
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def run_paths(dev, dr):
    """The kernels against their plain versions, every path, and the
    kernels line's rows."""
    from repro_torch.kernels import ops

    drivers = {"r1": main_path, "r3": main_path_r3, "zp": procs_path,
               "zw": window_procs_path, "zg": group_procs_path,
               "zs": server_procs_path, "zt": trainer_procs_path,
               "zc": chaos_procs_path,
               "w3": window_path_w3, "w1f": window_path_w1f,
               "wp": window_path_wp, "q3": async_path_q3,
               "qw": async_path_qw,
               "tg": functools.partial(tenancy_path, tag="tg", window=1),
               "tw": functools.partial(tenancy_path, tag="tw", window=4),
               "el": elastic_path, "ch": chaos_path, "sv": serving_path,
               "tr": training_path, "rg": hybrid_serving_path,
               "rt": hybrid_training_path, "vl": vlm_path,
               "xs": xlstm_serving_path, "xt": xlstm_training_path,
               "mo": moe_serving_path, "mv": maverick_serving_path,
               "mt": moe_step_path,
               "es": encdec_serving_path, "et": encdec_training_path,
               "ex": examples_path,
               "dr": lambda d: dryrun_path(d, *dr),
               "cm": crosspod_path}
    timing = kernels_vs_plain(dev)
    paths = {}
    for name, fn in drivers.items():
        t0 = time.perf_counter()
        paths[name] = fn(dev)
        emit(path=name, phase="wall", ms=(time.perf_counter() - t0) * 1e3)
    rows = []
    for name in ops.ENTRY_POINTS:
        t = timing[name]
        by_path = {p: c.get(name, 0) for p, c in paths.items()}
        emit(name=name, shape=t["shape"], r=t["r"], bytes=t["bytes"],
             int_ops=t["int_ops"], kernel_ms=t["kernel_ms"],
             device_ms=t["device_ms"], plain_ms=t["plain_ms"],
             bound_bytes_ms=t["bound_bytes_ms"],
             bound_ops_ms=t["bound_ops_ms"],
             clmul_ops_ms=t["clmul_ops_ms"], table_lds_ms=t["table_lds_ms"],
             library_ms=t["library_ms"],
             library_device_ms=t["library_device_ms"],
             launches_by_path=by_path)
        # no PyTorch call computes Fletcher terms or the GF(2^32) product:
        # library_ms is null but for the XOR kernel
        rows.append(dict(
            name=name, route="cuda", source=KERNELS[name][0],
            replaces=KERNELS[name][1], launches=sum(by_path.values()),
            max_abs_err=t["max_abs_err"], ms=t["kernel_ms"],
            device_ms=t["device_ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"],
            library_device_ms=t["library_device_ms"]))
    return rows


if __name__ == "__main__":
    main()
