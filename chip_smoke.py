#!/usr/bin/env python3
"""Drive the PyTorch port's secure serving, training, LM serving and LM
training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one H100 (sm_90a) and the
CUDA toolkit; it needs no arguments and no network.  It imports nothing of
JAX or of the JAX package.

1. Set-up: the card's name and power limit, torch and CUDA versions; the
   hand-written CUDA kernels are built from ``src/repro_torch/kernels/csrc``
   (one library per source, the four ``nvcc`` runs started together) into
   ``build/kernels/`` (git-ignored) and the build times printed, with the
   registers and spills of each library and of the redesigned programs'
   instances (``selective_scan``, ``vfl_forward_wide``).
2. Kernel phase: ``vfl_grad`` forward, backward and fused (split-batch)
   against their plain PyTorch versions on the card at the serving and
   training shapes (the minibatch steps, the multi-dominator
   block-diagonal backward, the pipelined steps, the full-dataset
   passes, phase 12's deep steps and ``deep_full_gradient`` passes
   with hidden 32 and d_rep 16 as M, and phase 13's per-dominator
   block-diagonal steps: the rows backward at Mθ = m·hidden per party and
   m·d_rep shared, the split step at Mw = hidden, Mθ = m·hidden), ragged
   shapes, fewer rows than a
   backward block has warps (B = 7), a one-row second chunk (B = 1,025),
   a wide side, a chunked backward side and bf16 (atol = rtol = 1e-4),
   and ``selective_scan`` (below);
   kernel, plain and library times from CUDA events over CUDA-graph
   replays, beside the byte/FLOP bound.  No single PyTorch call computes
   the split-batch function: its rows time the ``matmul`` + ``baddbmm``
   pair as a note instead.
3. Linear serving at q=8 parties, m=2, d=4096 (dp=512 per party),
   n=350,000 samples (webspam's sample count at the repo's widest split),
   ``secure="two_tree"``, ``max_batch=64``: a cold pass over the whole
   universe, a Zipf warm trace of 1e5 requests (all hits), one weight
   update and a delta pass over the hot ids, checked against a float64
   reference on the card; then threads submit through ``ServeQueue`` and
   every result must equal ``ServeEngine.serve`` on the same ids.
4. Short cold-then-hit passes with ``secure="off"`` and ``"ring"``.
5. Deep serving (hidden=32, d_rep=16) over a subset, cold then hits,
   against a float64 plain encoder.
6. A torch.profiler window: the device busy share of cold and hit
   dispatches.
7. Training on the same universe, relabelled by the repo's D4 recipe
   (columns standardised, labels from a planted w*):
   ``logistic_l2(1e-4)``, batch 32, lr = 1e-3 (the per-sample smoothness
   of the logistic loss at ‖x‖² ≈ d is about d/4 ≈ 1,024, so a step
   must stay below 2/L ≈ 2e-3; the quickstart's lr = 0.5 diverges here).
   Under ``two_tree``, 2 epochs each of SGD, SVRG and SAGA through the
   engine's epochs, each under ``torch.cuda.set_sync_debug_mode("error")``
   and each held against the port's float64 oracle run on the card from
   the same input with the same schedule (‖w − w₆₄‖/‖w₆₄‖ ≤ 1e-4, the
   objective within a relative 1e-5); then the same 2 epochs through
   ``algorithms.train(engine="fused")``, which must give the same
   iterate; then one SGD epoch under ``off`` and ``ring`` on the first
   schedule, which must agree with ``two_tree`` (the masks are
   lossless).  Samples/s per algorithm and epoch, the full-gradient pass
   time beside its bound, and the device busy share of one SGD and one
   pipelined SGD epoch from profiler windows.
8. Multi-dominator and pipelined training on phase 7's universe (m = 2
   dominators): one epoch of each of the 9 kinds (``multi_``,
   ``pipelined_`` and ``multi_pipelined_`` × SGD / SVRG / SAGA) from
   w = 0 under ``two_tree``, run twice (the first run captures the
   step's graph, the second is timed and must equal the first bit for
   bit), each under no host sync and held against the port's float64
   oracle on the same schedule at phase 7's bounds; pipelined SGD under
   ``off`` and ``ring`` against ``two_tree``; pipelined SGD against
   phase 7's sequential epoch on the same schedule (it must differ, and
   lie far nearer its own oracle than the sequential one); and
   ``train(multi_dominator=True, pipelined=True)`` for one SGD epoch,
   which must give the engine-driven iterate bit for bit.  Samples/s per
   kind.
11. Stale-gradient (bounded-delay) training on phase 7's universe, τ = 4,
   the delays ``party_delay_values(layout, 4, 0)`` per party and
   ``party_dominator_delays(layout, 4, 0)`` per (party, dominator): one
   epoch of each of the four delayed kinds (``delayed``,
   ``multi_delayed``, ``pipelined_delayed``, ``multi_pipelined_delayed``
   SGD) from w = 0 under ``two_tree``, run twice (the second timed and
   equal to the first bit for bit), each under no host sync and within
   ‖w − w₆₄‖/‖w₆₄‖ ≤ 1e-4 (its ring too) of the port's float64 staleness
   oracle on the same schedule and delays; each stale iterate must differ
   from its τ = 0 iterate (phases 7-8's fresh epoch) and lie at least
   10× nearer its own oracle than the τ = 0 oracle does.  Delayed SGD
   under ``off`` and ``ring`` against ``two_tree`` (1e-4); a second
   delayed SGD epoch chained on the first, so that the ring and the step
   counter cross the epoch boundary, against the chained oracle;
   ``run_delayed_fused`` for one epoch, which must give the engine-driven
   iterate bit for bit; at τ = 0 the delayed and pipelined delayed SGD
   epochs within 1e-6 of phase 7's first SGD iterate and phase 8's
   pipelined SGD iterate.  Samples/s and host µs a step per kind, and a
   profiler window over 1,000 delayed SGD steps.  It runs before phase
   9, on phase 7's resident data.
12. Deep training on phase 7's resident data and problem (hidden 32,
   d_rep 16: deep serving's widths; batch 32, lr = 1e-3), from the port's
   ``deep_vfl.initial_params(0)`` under ``two_tree``: one full epoch
   (10,937 steps) of each of the 8 deep kinds ({SGD, SVRG} × {fresh,
   multi-dominator, pipelined, multi-dominator pipelined}; SVRG with its
   ``deep_full_gradient`` μ), run twice (the second timed and equal to
   the first bit for bit), each under no host sync, finite and below its
   starting objective; each kind's first 250 steps (their own loop
   shape) against the port's float64 oracle ``train_deep_vfl`` on the
   same schedule (every leaf within ‖·−·₆₄‖/‖·₆₄‖ ≤ 1e-4, the objective
   within a relative 1e-5); deep SGD under ``off`` and ``ring`` against
   ``two_tree`` (1e-4); pipelined SGD against the sequential one (it must
   differ and lie 10× nearer its own oracle); ``train(deep=True,
   engine="fused")`` for one SGD epoch, which must give the engine-driven
   iterate bit for bit.  Samples/s and host µs a step per kind,
   ``deep_full_gradient``'s time beside its bytes bound (X read twice),
   and profiler windows over 250 deep SGD and 250 pipelined deep SGD
   steps.  It runs after phase 11 and before phase 13.
13. Bounded-delay deep training on phase 12's universe and start, τ = 4,
   phase 11's seed-0 delays: one full epoch of each of the 4 deep
   delayed kinds (``deep_delayed``, ``deep_multi_delayed``,
   ``deep_pipelined_delayed``, ``deep_multi_pipelined_delayed`` SGD)
   under ``two_tree``, run twice (the second timed and equal to the
   first bit for bit), each under no host sync, finite and below its
   start's objective; each kind's first 250 steps against the port's
   float64 staleness oracle (``train_deep_delayed`` /
   ``train_deep_multi_delayed``) on the same schedule and delays (every
   leaf and every ring slot within 1e-4 relative, the objective within
   1e-5) and at least 10× nearer it than phase 12's float64 τ = 0
   oracle; each full epoch differs from phase 12's fresh epoch of its
   form, and at τ = 0 lies within 1e-6 of it.  Deep delayed SGD under
   ``off`` and ``ring`` against ``two_tree`` (1e-4); a second full epoch
   chained on the first (the counter reaches 2 × steps) and a chained
   250-step prefix against the chained oracle; ``run_deep_delayed_fused``
   and ``run_deep_multi_delayed_fused(pipelined=True)`` bit-equal to
   their epochs.  Samples/s and host µs a step per kind, and profiler
   windows over 250 delayed and multi delayed deep SGD steps.  It runs
   after phase 12 and before phase 14.
14. Faults, guards, checkpoints and the supervisor on phase 7's resident
   data and problem, τ = 4, phase 11's seed-0 delays: one full epoch
   (10,937 steps) of each faulted kind (SGD, SVRG, SAGA) on a
   ``random_trace`` of crashes, rejoins, straggles and dropped broadcasts,
   and of each guarded kind on a trace with NaN and Inf corruptions added,
   under ``two_tree``, run twice (the second timed and equal to the first
   bit for bit), each under no host sync; each kind's first 250 steps
   against the port's float64 faulted or guarded oracle (iterate and ring
   within 1e-4 relative; guarded: ``finite``/``alive`` equal, the norms
   within 1e-4); guarded with ``guard=True`` finite with no poisoned step,
   with ``guard=False`` NaN in the oracle's coordinates; faulted SGD under
   ``off`` and ``ring`` against ``two_tree`` (1e-4);
   ``run_faulted_fused`` and ``train(engine="fused", algo="saga")``
   checkpointed after 1 epoch and resumed to 2, bit-equal to an
   uninterrupted 2-epoch run; ``train(supervise=True)`` on ridge at a
   divergent learning rate, finite after at least one heal; profiler
   windows over 250 faulted, guarded and delayed SGD steps.  It runs
   after phase 13 and before phase 15.
15. Deep faults and guards on phase 12's universe and start, τ = 4,
   phase 11's seed-0 delays and phase 14's traces: one full epoch of deep
   faulted SGD and SVRG and of deep guarded SGD and SVRG (NaN/Inf
   trace) under ``two_tree``, run twice (the second timed and equal to
   the first bit for bit, NaN for NaN in the telemetry), each under no
   host sync, each step's graph launching 4 ``vfl_grad`` programs (SVRG
   6); each kind's first 250 steps against the port's float64 deep
   oracle (every leaf and ring slot within 1e-4 relative; guarded:
   ``finite``/``alive`` equal, the norms within 1e-4); guarded finite
   with no poisoned step, with ``guard=False`` NaN in the oracle's
   places; deep faulted SGD under ``off`` and ``ring`` against
   ``two_tree`` (1e-4); ``run_deep_faulted_fused`` checkpointed after 1
   epoch and resumed to 2, bit-equal; ``supervised_guarded_run(deep=
   True)`` finite; profiler windows over 200 deep faulted, guarded and
   delayed SGD steps.
16. The party mesh on one card, on phase 7's data and problem:
   ``PartyMesh(q=8, slots=4)``, ``PartyMesh(q=8, slots=2,
   data_shards=2)`` and ``PartyMesh(q=64, slots=8)`` (64 parties of 64
   features, a (64, 350000, 64) pack of 5.73 GB, freed before phase 9):
   one SGD and one SVRG epoch each in every secure mode under no host
   sync, ``off`` bit-equal to the flat epoch where packed (1e-4 over the
   data axis), ``two_tree``/``ring`` within 1e-4 of the flat ``two_tree``
   iterate, a 250-step ``two_tree`` prefix within 1e-4 of the float64
   oracle; host µs a step beside the flat step;
   ``run_faulted_fused(mesh=PartyMesh(q=8, slots=2))`` within 1e-4 of the
   flat runner; profiler windows over 250 packed and flat SGD steps.
   It runs before phase 9.
17. Serving over the mesh and the thread simulation, on phase 7's data
   and problem.  (a) ``ServeEngine`` over ``PartyMesh(q=64, slots=8)``:
   phases 3-5's linear path (cold over every id, the Zipf trace all hits
   and bit-equal to the cold values, a weight update and the 8,192
   hottest ids through delta, the queue) under ``two_tree`` and, without
   the queue, ``ring``, every prediction within 1e-4 of float64 x·w,
   beside a flat q = 64 engine under ``two_tree``; phase 6's deep path
   (hidden 32, d_rep 16) under ``two_tree``; ``off`` packed bit-equal to
   flat.  (b) ``core.async_engine`` at ``examples/async_vfl.py``'s regime
   (q = 8, m = 3, 3 threads a party, the last party 1.45× slower, 2 ms
   base delay, batch 32) for 1,000 dominator iterations: ``run_sync``
   within 1e-4 of the float64 SGD oracle on its own draws; ``run_async``
   (secure) finite, not timed out, at its update target, its objective
   falling; a 500-iteration run with a crash and rejoin of the straggler
   whose realized trace compiles and replays one epoch through
   ``run_faulted_fused`` at τ = 2 to a finite iterate; each run's
   launches by the module's rule, exactly (``vfl_backward_rows`` once an
   update, ``run_sync``: once an iteration; ``vfl_forward_narrow`` once a
   dominator iteration and once a probe); async and sync wall time and a
   profiler window over 200 ``run_async`` iterations, printed.  The
   switch interval the thread runs set is put back.  It runs before
   phase 9.
18. The linter on the card, on phase 7's data and problem at full width
   ((8, 350000, 512) f32, batch 32, ``two_tree``): SGD, pipelined SGD,
   deep SGD (hidden 32, d_rep 16), delayed SGD and faulted SGD (τ = 2)
   each traced with ``make_fx`` over fake tensors
   (``FusedEngine.epoch_graph``), then run for one 3-step epoch under no
   host sync; each traced step's ``repro_torch.vfl_grad`` nodes must equal
   the launches of one replay of the captured step, and the trace hold no
   host transfer.  Then ``python -m repro_torch.analysis --quick --device
   cuda`` in this process must pass every gate against the committed
   ``analysis/INVARIANTS_torch.json`` with zero host transfers, and the
   operator's host dispatch cost is timed against the direct call of its
   CUDA implementation at the SGD step's shape (8, 32, 512) and printed.
   It runs before phase 9.
9. LM serving, falcon-mamba-7b at full width (d_model 4096, d_inner 8192,
   N = 16, 64 layers, vocabulary 65,024, random weights from a seed) across
   q = 8 parties under ``two_tree``: ``launch.serve.serve`` with batch 4,
   a 2,048-token prompt and 32 generated tokens.  ``selective_scan`` must
   launch exactly 64 times in that call (once per layer of the prefill,
   never in a decode step, which is checked on its own as well).  The
   prefill's stack is then walked layer by layer: at every layer the
   kernel-path block and the oracle-scan block (the sequential plain scan)
   run on the same input and must agree within atol = rtol = 5e-2 (the
   reference's bf16 scan tolerance: the two scans differ by f32 rounding,
   which tips an occasional bf16 rounding).  End to end, a 64-layer stack
   of random weights amplifies such rounding-level differences, so the
   kernel path's final hidden states must lie no farther from the
   oracle-scan path's (relative L2) than twice as far as a redraw of the
   embedding's masks moves the kernel path itself; the next tokens must
   be equal wherever the oracle's top-two logit margin exceeds 5e-2 of
   its largest logit, and a ``ring_masks`` prefill must give
   ``two_tree``'s next tokens by the same rule.  Every token must lie in
   [0, padded vocabulary) and every decode-state leaf be finite; a second
   ``serve`` with the same seed must give the same tokens, and its (warm)
   times are the ones reported: time to first token, decode step latency
   p50/p99, generated tokens/s and peak memory.  Profiler windows over
   one prefill and one decode step.
10. Dense LM serving, gemma3-4b at full width (34 layers, d_model 2560,
   8 query and 4 KV heads of 256, d_ff 10,240, vocabulary 262,144,
   window 1,024 with layers 5, 11, 17, 23 and 29 global; 15.5 GB of
   random f32 weights from a seed) across q = 8 parties under
   ``two_tree``: ``launch.serve.serve`` with batch 4, a 4,096-token
   prompt (4× the window) and 32 generated tokens.  In that call
   ``flash_attention`` must launch 34 times (once per layer of the
   prefill) and ``decode_attention`` 34 × 31 times (once per layer of
   each decode step, over all 8 cache shards), and no other kernel.  A
   second call must repeat the tokens, and its (warm) times are the ones
   reported, as in phase 9.  Then: one prefill and 8 teacher-forced
   decode steps must give the greedy tokens of the full forward pass over
   the prompt and those 8 tokens in at least 95% of the positions whose
   top-two logit margin exceeds 5e-2 of the largest logit (the criterion
   of ``tests/test_decode_consistency.py``); the prefill's stack is walked
   layer by layer, every layer's attention on the kernel path within
   atol = rtol = 5e-2 of ``attn_impl="reference"``'s (the plain chunked
   attention) on the same input, and the final hidden states no farther
   (relative L2) from the reference path's than twice a mask redraw's
   distance; the kernel and reference paths' next tokens, and
   ``ring_masks``' and ``two_tree``'s, must be equal where the margin
   decides them.  Profiler windows over one prefill and one decode step.
   Then ``Runtime(unroll_layers=6)`` on the full tree against the tree
   cut to 6 layers with ``n_layers=6``: a prefill, its normed hidden
   states and one decode step on a 34-layer cache must give the bits of
   the cut tree's (tokens, caches, hidden states), ``flash_attention``
   launching 6 times a prefill or forward and ``decode_attention`` 6
   times a step, counted on their own.
19. LM training at full width, the depth cut so that one card holds the
   parameters and the optimiser state: falcon-mamba-7b with 2 of its 64
   layers (batch 4 × 512 tokens), gemma3-4b with 6 of its 34 (layers
   0-4 local with the 1,024 window, layer 5 global; batch 2 × 2,048) and
   granite-moe-1b-a400m whole (24 layers, 32 experts top-8; batch 2 ×
   2,048; its router's lb_loss and z_loss finite and positive),
   each across q = 8 parties under ``two_tree``, random f32 weights from
   the seed, tokens from ``data.tokens.synthetic_token_batches(seed=0)``,
   ``launch.train``'s plain routes (the sequential scan, the plain
   chunked attention; the kernels are forward-only) with its default
   ``remat=True`` (each block recomputed in the backward).  For each: every
   parameter leaf's gradient on the first batch finite and nonzero
   somewhere (a cut gradient fails here); a step p − η·g/‖g‖ on the same
   batch and masks lowers the loss by at least half of its first-order
   prediction η‖g‖, which is the larger of 0.05 and 20× the loss's change
   under a redraw of the masks (all three printed, beside the drops at a
   quarter and four times that step); 8 AdamW steps (lr 1e-3), every loss
   finite and the mean of the last 3 at least 0.05 below the first
   (``examples/train_lm.py``'s threshold); 8 ``vfb2_sgd`` steps (τ = 4,
   lr 1e-2), every loss finite, the per-leaf delays the md5 rule over
   ``jax.tree_util.keystr`` paths built here on their own, and the last
   step moving each leaf by its ring's slot of step 7 − d; over both
   runs no program of the four sources launched.  Then, under no_grad,
   ``train_loss`` on the kernel routes against the plain routes on the
   same parameters, batch and masks: ``selective_scan`` 4 launches
   (falcon) or ``flash_attention`` 6 (gemma3) or 24 (granite-moe) and
   nothing else, the gap within layers · 2⁻⁸ · the table's RMS row norm
   (each layer's output rounding one bf16 step apart moves a token's
   cross-entropy by about that; for granite-moe at least twice the
   loss's change under a mask redraw, since a near-tie in the router can
   flip a token's experts between the routes), both forward times
   printed; falcon's final AdamW parameters saved
   with ``save_checkpoint`` and loaded back bit-equal.  Host ms a step
   (median of steps 2-8), tokens/s and peak memory per optimiser, and a
   profiler window over one AdamW step; the peak memory of the first
   gradient.  gemma3 takes that gradient once more and runs its 8 AdamW
   steps once more with ``remat=False`` on the same parameters and
   batches (every loss finite, the first within 1e-4 of the remat
   run's), with the same numbers, beside the remat run's.  It runs after
   phase 10, whose weights are freed.
20. MoE serving, qwen3-moe-30b-a3b at full width with 16 of its 48
   layers (d_model 2,048, 32 query and 4 KV heads of 128, 128 experts
   top-8 of width 768, vocabulary 151,936; 10.3 B random f32 parameters,
   41.1 GB) across q = 8 parties under ``two_tree``, each party owning
   16 experts (``moe_dispatch="replicated"``): ``launch.serve.serve``
   with batch 4, a 2,048-token prompt (8,192 tokens, 640 rows a bucket
   at cf 1.25) and 32 generated tokens.  In that call ``flash_attention``
   must launch 16 times and ``decode_attention`` 16 × 31, and no other
   kernel; a second call repeats the tokens and gives the (warm) times.
   Then 16 and 0 launches per prefill, 0 and 16 per decode step; the
   prefill's stack walked layer by layer, every layer's attention on the
   kernel path within atol = rtol = 5e-2 of ``attn_impl="reference"``'s
   and its MoE layer, run under ``set_sync_debug_mode("error")``, against
   a plain per-expert f32 oracle (route, each expert's SwiGLU on its
   first 640 assigned rows in token order, the gate-weighted sum): a
   token routed otherwise than by the oracle only where the oracle's
   8th and 9th probabilities are within 1e-6, and, on every token whose
   buckets agree with the oracle's (at least half of them), within 2e-2
   of the oracle's largest value and 1e-2 relative L2 (the share of
   assignments dropped recorded); at layer 0,
   on one prompt row, ``alltoall`` against ``replicated`` at cf = E/k,
   where nothing drops; the final hidden states no farther from the
   reference path's than twice a mask redraw's distance, tokens equal
   where the margin decides (also ``ring_masks`` against ``two_tree``;
   on random weights router flips cascade over the layers, so these two
   carry little, and the count of decided tokens is recorded).
   Profiler windows over one prefill and one decode step.
21. Hybrid serving, jamba-v0.1-52b at full width with one whole period,
   8 of its 32 layers (d_model 4,096; 7 mamba mixers, d_inner 8,192,
   N = 16, and 1 attention mixer, 32 query and 8 KV heads of 128; 4 MLP
   and 4 MoE feed-forwards, 16 experts top-2 of width 14,336;
   vocabulary 65,536; 13.0 B random f32 parameters, 52.1 GB) across
   q = 8 parties under ``two_tree`` (``replicated``, 2 experts a party):
   ``launch.serve.serve`` with batch 4, a 2,048-token prompt (8,192
   tokens, 1,280 rows a bucket at cf 1.25) and 32 generated tokens.  In
   that call ``selective_scan`` must launch 7 times, ``flash_attention``
   once and ``decode_attention`` 31 times, and no other kernel; its
   decode starts from zeros, as the reference's (ROADMAP C.R6).  A second
   call repeats the tokens and gives the (warm) times.  Then one more
   decode step on the cache the first call left, layer by layer: the
   attention layer's ``decode_attention`` route within atol = rtol =
   5e-2 of the plain route on the same input and cache, every mamba
   layer's new state finite; the first 16 prompt tokens decoded one at a
   time from zeros against the full forward's greedy tokens (≥ 95% of
   the positions the margin decides, their count recorded; the MoE
   layers at cf = E/k there); the prefill walked layer by layer in the
   period's order as in phase 20 (each mamba mixer against the oracle
   scan, the attention mixer against the plain chunked attention, each
   MoE layer against its f32 per-expert oracle, the dropped share
   recorded), end to end as phase 20.  Profiler windows over one prefill
   and one decode step.
22. Cross attention and the secure frontends, each model whole at full
   width across q = 8 parties under ``two_tree``, random f32 weights
   from the seed, the frames and patches the reference's random stubs:
   whisper-tiny (4 encoder layers over 1,500 frames of width 768, 96
   features a party; 4 decoder blocks of self and cross attention and,
   as the reference builds them, no feed-forward, ROADMAP C.R7; d_model
   384, 6 heads over 6 of 64; vocabulary 51,865) with batch 4, a
   224-token prompt and 32 generated tokens, its cross cache padded to
   1,504 positions (8 shards of 188); and pixtral-12b (40 layers,
   d_model 5,120, 32 heads over 8 of 128, d_ff 14,336, vocabulary
   131,072, rope θ 10⁶; 1,024 patches of width 1,024, 128 features a
   party, as a prefix) with batch 4, 1,024 patches + 1,024 text tokens
   and 32 generated tokens.  In each counted ``serve`` call
   ``flash_attention`` must launch once per attention of the prefill
   (whisper 4 encoder + 4 self + 4 cross, non-causal where not self;
   pixtral 40) and ``decode_attention`` once per decoder attention of
   each of the 31 steps (whisper 8, pixtral 40), and no other kernel;
   whisper's decoding never writes the cross cache's padding.  A second
   call repeats the tokens and gives the (warm) times.  Then: the
   parties' secure projection of the frames or patches within two bf16
   steps of the unmasked f32 product of the same bf16 operands; one
   prefill and 8 teacher-forced decode steps on the prefill's caches
   (the cross cache read at enc_seq − 1) against the forward over the
   prompt and those tokens (≥ 95% of the positions the margin decides,
   at least one decided); one more decode step layer by layer, every
   self and cross attention's ``decode_attention`` route within atol =
   rtol = 5e-2 of the plain route on the same input and cache; the
   prefill walked layer by layer (whisper's encoder first), every
   encoder, self and cross attention within 5e-2 of the plain chunked
   attention, end to end as phase 10.  Profiler windows over one
   prefill and one decode step.  whisper then holds
   ``Runtime(unroll_layers=2)`` on the full tree to the tree cut to 2
   encoder and 2 decoder layers, as phase 10 does.
23. The dry run against the card (``launch/dryrun.py``): phase 19's four
   AdamW steps (falcon-mamba-7b ×1 at 4 × 512, gemma3-4b ×6 at 2 × 2,048
   with and without remat, granite-moe-1b-a400m whole at 2 × 2,048) and
   a prefill and a decode step at phase 10's gemma3-4b shape (batch 4, a
   4,096-token prompt; decode on the 4,128-position cache) and phase
   21's jamba period (batch 4, 2,048; decode on 2,080), each predicted
   over fake tensors in a pool of three host processes (started with the
   phase, after every timed phase has ended) while the main process runs
   the same step once on the card from the same seed under
   ``FlopCounterMode``.  Each predicted peak must lie within 10% of the
   card's ``max_memory_allocated`` over the step (less what the process
   held before the step's arguments were made), the training steps'
   predicted aten FLOPs must equal the card's ``FlopCounterMode`` total,
   and the fake route's launches the kernels' counted launches (flash 34
   and decode 34 for gemma3, scan 7, flash 1 and decode 1 for jamba,
   none for training); each ratio is printed.
24. The party mesh on a ``torch.distributed`` device mesh
   (``PartyMesh(mesh=DeviceMesh)``), in spawned ranks after the kernels
   are built.  First the ring's survivor-rank counter stream on the card
   against the CPU's (Philox words equal, normals within 1e-6).  (a)
   ``PartyMesh(q=8, slots=cards)`` over NCCL, one rank a card (one on
   this machine), on phase 7's data: SGD, SVRG and SAGA epochs of 2,000
   steps of phase 7's schedule under ``off``, ``two_tree`` and ``ring``,
   each step a replay of a CUDA graph that holds its collectives, under
   no host sync, against the same epochs of the ``mesh=None`` engine: bit
   for bit under ``off`` at one rank, within 1e-5 under the masked modes;
   the deep SGD and SVRG epochs fresh and pipelined, a linear and a deep
   delayed SGD epoch (500 steps), ``deep_objective`` and deep serving;
   the six linear and four deep faulted and guarded epochs (250 steps on
   phases 14-15's traces, NaN and Inf codes included; the telemetry's
   flags equal); timed epochs of each engine; a ``ServeEngine`` over the
   mesh answering full, hit and delta requests against one over the
   ``mesh=None`` engine; the launches equal to the ``mesh=None``
   engine's.  (b) Four gloo ranks sharing the card, q = 4: SGD epochs of
   300 steps, deep SGD and delayed SGD epochs of 100, faulted, guarded
   and deep guarded SGD epochs of 100 under ``two_tree`` and ``ring``,
   eager (gloo is never captured), and one ``run_guarded_fused`` epoch
   over the mesh, within 1e-5 of the ``mesh=None`` engine and runner,
   each rank's ``vfl_grad`` launches as its steps imply; the tree replay
   (``schedule_faithful``) is held in the CPU tests, since gloo's sends
   take host tensors, and the phase says so.  It runs last.

The ``vfl_grad`` source holds five kernel programs:
``vfl_forward_narrow`` (M <= 4, the linear path), ``vfl_forward_wide``
(the deep encoder layers),
``vfl_backward_rows`` and ``vfl_backward_reduce`` (the reduce pass runs
only when a backward spans more than one chunk of rows: the full-dataset
passes), and ``vfl_fused_split`` (the fused mode and its split-batch
form: every interior step of a pipelined epoch).  The narrow forward
gives each lane fixed 16-byte groups of a row, one row a warp at the
minibatch steps and 4 rows a warp over the full dataset; a row's z does
not depend on the launch, and the kernel phase checks the full-dataset
pass's first and last 64 rows against one-row-a-warp launches of them,
aligned and off the 16-byte vector width.  The wide forward splits D over
a block's 8 warps and over 8 lanes of each, and adds the partials in a
fixed order (a shuffle tree, then the warps in order), so its z too is
the same bits in any launch; its rows include deep serving's cache hit
(64, 512)·32 and a ragged M (37).  The backward programs
spread each output's sum over the 8 warps of a block: a rows block owns
one chunk of up to 1,024 rows, one party and 64 columns, each warp a
fixed eighth of the rows; a reduce block owns 32 outputs, each warp a
fixed range of the chunks; the warps' partials are added in warp order,
so the sums do not depend on scheduling.  ``vfl_fused_split``'s backward
blocks are rows blocks.  Every program's launch count (all four sources)
is reset just before phase 3 and read after
phase 5, reset again just before phase 7's runs and read after them,
just before phase 8 and after it, just before phase 11 and after it,
just before phase 12 and after it, just before phase 13 and after it,
just before phase 14 and after it, just before phase 15 and after it,
just before phase 16 and after it, just before phase 17 and after it,
just before phase 18's census epochs and after its quick lint,
just before phase 9's serve call and after it, just before phase
10's serve call and after it, just before phase 19's no-grad
kernel-route forwards and after each (its training steps must launch
nothing), just before phase 20's serve call and after it, just before
phase 21's serve call and after it, just before each of phase 22's two
counted serve calls and after it, just before each of phase 23's steps on
the card and after it, and in each rank of phase 24 around its
device-mesh engines' calls (a new process starts at 0);
each count must equal what the dispatch or step structure implies, every
program of each path must have run, and no other program.  The
``kernels`` line has one entry per program, timed at its main-path shape
(serving: the linear full dispatch and deep layer 1; training: the SGD
step, the full-dataset reduce and the pipelined SGD step), with its
launches summed over every path (phases 3-8, 11-18 and 24).  The
``selective_scan`` source holds one program, held against its plain
version at the reference's sweep shapes, a ragged shape and phase 9's
prefill shape (4, 2048, 8192), N = 16, bf16 (1e-4 for f32 xa, 5e-2 for
bf16), the last two also with a_log drawn per (channel, state) (log of
uniform [0.5, 16], as trained weights have), two
calls of each equal bit for bit, and timed at the prefill shape with
mamba's a_log; its bound is the
larger of its bytes over the HBM rate and its exponentials over the
special-function units' rate (16 per clock per SM at the card's maximum
SM clock); its launches are phase 9's and 21's serve calls', phase
19's and phase 23's.  The
``flash_attention`` source holds one program (bf16 at dh 64-256 on the
tensor cores through wgmma on TMA-fed tiles, bf16 at dh 32 through
mma.sync, f32 on the CUDA cores), held against its plain version at
phase 10's prefill shape (4, 8, 4096, 256) bf16 as the model's transposed
views, global and with the window of 1,024, at granite-8b's and
internlm2-20b's prefill heads (32 and 48 over 8, dh 128, B 1), a ragged
(1, 4, 1000, 128) and a small f32 shape (2e-2 in bf16, 2e-6 in f32); its
bound is the larger of the bytes of q, k, v and o over the HBM rate and
the FLOPs of the (query, key) pairs the mask keeps over the dense bf16
tensor peak (f32 peak for f32).  The ``decode_attention`` source holds
one program (bf16 through mma.sync, f32 on the CUDA cores), held against
its plain version at phase 10's decode shape (q (4, 8, 256), caches (4,
4128, 4, 256) bf16 as 8 shards of 516) at pos 4100 global and with the
window, at pos 1000, and at granite-8b's and internlm2-20b's decode (q
(4, 32 or 48, 128) over (4, 4128, 8, 128), global) (the normalised output
within 3e-2 and, since P keeps its f32 accuracy, within 1e-4 absolute; l
within 2e-4, l = 0, o = 0, m = −1e30 on every shard with no
valid position, and two calls equal bit for bit); its bound is the bytes
of the K/V positions in the window against their f32 FLOPs.  Both
attention programs' library yardstick is ``scaled_dot_product_attention``.
Their rows give two times for the kernel and the library call: warm (the
same operands every call: a decode layer's window of K/V fits the 50 MB
L2) and cold (the calls rotate over enough
operand sets that each finds its bytes gone from L2, as every layer of
the model does); the bound is held against the cold time.  Their
``kernels`` line entries give the local-window shape's warm time (29 of
the 34 layers) and phase 10's, 20's, 21's and 22's serve calls'
launches and phase 23's (flash attention adds phase 19's); both also
run at phase 20's
qwen3-moe shapes (flash (4, 32, 2048, 128) over 4 KV heads, decode q (4,
32, 128) over (4, 2080, 4, 128) as 8 shards at pos 2050), at phase
21's jamba shapes (the same over 8 KV heads) and at phase 22's whisper
shapes (flash non-causal (4, 6, 1500, 64) and 224 queries over 1,500
keys; decode q (4, 6, 64) over (4, 1504, 6, 64) as 8 shards at pos
1499).  Every path's
checks also require that no program of another path ran.  The four
sources build in parallel.  Any failed check exits non-zero.  The last
three lines are the card's name and power limit, the ``kernels``
JSON line and ``{"ok": true, "device": {...}}``.  Details go to
``results/chip_smoke.json`` (git-ignored).
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import re
import shutil
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the card's data-sheet figures (an H100 SXM 80GB HBM3 at 700 W): the HBM
# rate, the f32 peak outside the tensor cores, the dense bf16 tensor peak
from repro_torch.launch.hlo_analysis import (BF16_FLOP_PER_S,  # noqa: E402
                                             F32_FLOP_PER_S,
                                             HBM_BYTES_PER_S)
L2_BYTES = 50e6                  # H100 SXM L2 cache (data sheet)
SEED = 0
BATCH = 64                       # max_batch: requests per dispatch
Q, M_ACT, D, N = 8, 2, 4096, 350_000
TRAIN_BATCH, TRAIN_LR, TRAIN_EPOCHS = 32, 1e-3, 2
DEEP_HIDDEN, DEEP_DREP = 32, 16  # deep serving's and training's widths
MESH_Q, MESH_SLOTS = 64, 8       # phase 16's "q past the mesh" layout
SFU_EXP_PER_CLOCK_PER_SM = 16    # Hopper's special-function units (ex2)
LM_ARCH, LM_Q, LM_BATCH, LM_PROMPT, LM_GEN = "falcon_mamba_7b", 8, 4, 2048, 32
LM_TOL = 5e-2                    # the reference's bf16 scan tolerance
SCAN_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
DENSE_ARCH, DENSE_Q, DENSE_BATCH = "gemma3_4b", 8, 4
DENSE_PROMPT, DENSE_GEN, DENSE_TEACHER = 4096, 32, 8
# tests/test_kernels.py's tolerances: flash 2e-6 (f32) / 2e-2 (bf16);
# decode's normalised output 1e-5 / 3e-2, its sum-exp 2e-4
FLASH_TOL = {"float32": 2e-6, "bfloat16": 2e-2}
DECODE_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# decode keeps P at f32 accuracy in P V, as the TPU kernel does: its bf16
# normalised output stays this close to the plain version's (P rounded to
# bf16 gives about 2e-3 at phase 10's shapes)
DECODE_P_TOL = 1e-4
# phase 19: LM training at full width, depth cut so that the parameters
# and the optimiser state fit the card: (arch, layers, q, batch, seq).
# granite-moe runs whole at 2 × 2,048 under remat (without it the τ = 4
# ring's run ran out of the 80 GB: some 1.75 GB of saved activations a
# layer); falcon at 2 layers, whose plain scan loop is host-bound (about
# 1.5 s a remat step a layer)
TRAIN_LM = (("falcon_mamba_7b", 2, 8, 4, 512),
            ("gemma3_4b", 6, 8, 2, 2048),
            ("granite_moe_1b_a400m", 24, 8, 2, 2048))
# the configuration whose AdamW steps also run with remat=False, and the
# one whose final parameters go through a checkpoint and back
TRAIN_LM_NO_REMAT, TRAIN_LM_CKPT = "gemma3_4b", "falcon_mamba_7b"
# the first AdamW loss of the remat=False run against the remat run's
# (the same forward; the tolerance allows the card's f32 reductions)
NO_REMAT_TOL = 1e-4
TRAIN_LM_STEPS, TRAIN_LM_LR, TRAIN_LM_SGD_LR, TRAIN_LM_TAU = 8, 1e-3, 1e-2, 4
TRAIN_LM_DROP = 0.05             # examples/train_lm.py:36's threshold
# the descent check's first-order prediction η‖g‖: at least this, and at
# least DESCENT_NOISE × the loss's change under a redraw of the masks
DESCENT_FLOOR, DESCENT_NOISE = 0.05, 20.0
BF16_ULP = 2.0 ** -8             # bf16's relative rounding step
# phase 20: MoE serving, qwen3-moe-30b-a3b at full width, 16 of 48 layers
MOE_ARCH, MOE_LAYERS, MOE_Q, MOE_BATCH = "qwen3_moe_30b_a3b", 16, 8, 4
MOE_PROMPT, MOE_GEN = 2048, 32
# the MoE layer against its f32 per-expert oracle, on the tokens whose
# buckets agree with the oracle's: the largest error within MOE_TOL of the
# oracle's largest value (the tests' bf16 hidden-state tolerance: the
# layer rounds its buckets, weights, g, u, silu(g)·u and output to bf16)
# and the relative L2 error within MOE_L2 (about two bf16 steps)
MOE_TOL, MOE_L2 = 2e-2, 1e-2
# the oracle and the port route the same bf16 input through the same f32
# router: only the order of the f32 sums and of equal probabilities can
# differ, so a token may be routed otherwise only where its k-th and
# (k+1)-th oracle probabilities are within this margin (the tests'
# ROUTE_MARGIN)
MOE_ROUTE_MARGIN = 1e-6
# at least this share of the tokens is compared: those routed otherwise,
# and those that one of them may have moved in a bucket, are left out
MOE_MIN_SHARE = 0.5
# phase 21: hybrid serving, jamba-v0.1-52b at full width, one whole period
# (8 of 32 layers); 16 teacher-forced decode positions from zeros
HYBRID_ARCH, HYBRID_LAYERS, HYBRID_Q, HYBRID_BATCH = "jamba_v0_1_52b", 8, 8, 4
HYBRID_PROMPT, HYBRID_GEN, HYBRID_TEACHER = 2048, 32, 16
# the unroll checks: unroll_layers=n on the full tree against the tree cut
# to n layers, phase 10's gemma3 and phase 22's whisper
DENSE_UNROLL, FRONTEND_UNROLL = 6, 2
# phase 22: cross attention and the continuous frontends, each model whole
# at full width across q = 8 parties: (arch, batch, prompt positions: a
# VLM's count its patches); 32 generated tokens, 8 teacher-forced steps
FRONTENDS = (("whisper_tiny", 4, 224), ("pixtral_12b", 4, 2048))
FRONTEND_Q, FRONTEND_GEN, FRONTEND_TEACHER = 8, 32, 8
# the secure projection against the unmasked f32 product of the same bf16
# operands: each party's bf16 partial rounds once and the f32 mask residue
# may tip one more rounding (tests/test_torch_frontends.py): two bf16
# steps of the largest value
PROJ_TOL = 2 * 2.0 ** -7


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*args):
    print(*args, flush=True)


def pct(xs, q):
    return float(np.percentile(np.asarray(xs), q))


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def _graph_ms(torch, fn, reps=50, replays=20):
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    replayed ``replays`` times between CUDA events (no host gaps).  ``fn``
    is one callable, called on the same operands every time (they stay in
    L2 where they fit: the warm time), or a list of callables over
    distinct operand sets, called in turn (the cold time, where the sets
    outgrow L2: ``_cold_sets``)."""
    fns = fn if isinstance(fn, list) else [fn]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            for f in fns:
                f()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def _nbytes(*tensors):
    """Bytes of the distinct storage the tensors cover: an ``expand``
    view (a shared ϑ) counts once."""
    return sum(t.untyped_storage().nbytes() if t.stride(0) == 0
               else t.numel() * t.element_size() for t in tensors)


def _bound(nbytes, flops):
    """The least time for the work: bytes over HBM rate vs f32 FLOPs over
    the f32 (non-tensor-core) peak, whichever is larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOP_PER_S * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def _kernel_row(torch, name, programs, x, kernel, plain, library, nbytes,
                flops, big=False, pair=None):
    """Check ``kernel()`` against ``plain()`` at 1e-4 (each output of a
    tuple) and time kernel, plain and (where there is one) the library
    call; ``pair``, where given, is a two-call yardstick timed beside it
    as a note (no single PyTorch call computes the function)."""
    outs, wants = kernel(), plain()
    torch.cuda.synchronize()
    if not isinstance(outs, tuple):
        outs, wants = (outs,), (wants,)
    err = max(float((o - w).abs().max()) for o, w in zip(outs, wants))
    for out, want in zip(outs, wants):
        check(tuple(out.shape) == tuple(want.shape)
              and out.dtype == torch.float32,
              f"kernel {name}: shape/dtype {tuple(out.shape)} {out.dtype}")
        check(torch.allclose(out, want, atol=1e-4, rtol=1e-4),
              f"kernel {name}: max abs err {err} beyond 1e-4")
    reps = dict(reps=10, replays=5) if big else {}
    kernel_ms = _graph_ms(torch, kernel, **reps)
    plain_ms = _graph_ms(torch, plain, **reps)
    library_ms = None if library is None \
        else _graph_ms(torch, library, **reps)
    bound_ms, bound_by = _bound(nbytes, flops)
    row = dict(name=name, programs=programs, x=list(x.shape),
               dtype=str(x.dtype).replace("torch.", ""), max_abs_err=err,
               ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes)
    if pair is not None:
        row["pair_ms"] = _graph_ms(torch, pair, **reps)
    lib = "-" if library_ms is None else f"{library_ms*1e3:.2f} us"
    note = "" if pair is None else f"  pair {row['pair_ms']*1e3:.2f} us"
    log(f"{'+'.join(programs)} {name:20s} x{list(x.shape)} {row['dtype']}: "
        f"err {err:.3e}  kernel {kernel_ms*1e3:.2f} us  plain "
        f"{plain_ms*1e3:.2f} us  library {lib}{note}  bound "
        f"{bound_ms*1e3:.3f} us ({bound_by})")
    return row


def kernel_phase(torch, dev):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import vfl_grad as vg
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    rows = []
    # forward: (name, party axis P or None, rows B, width D, columns M or
    # None, dtype); serving's shapes, then training's minibatch steps
    fwd = [
        ("linear_full", 8, 64, 512, None, torch.float32),
        ("linear_hit", None, 64, 512, None, torch.float32),
        ("deep_layer1", 8, 64, 512, 32, torch.float32),
        ("deep_layer2", 8, 64, 32, 16, torch.float32),
        ("deep_hit", None, 64, 512, 32, torch.float32),
        ("ragged_wide_m", 8, 64, 512, 37, torch.float32),
        ("ragged_narrow", 3, 37, 333, 3, torch.float32),
        ("ragged_wide", 3, 37, 333, 21, torch.float32),
        ("linear_full_bf16", 8, 64, 512, None, torch.bfloat16),
        ("deep_layer1_bf16", 8, 64, 512, 32, torch.bfloat16),
        ("train_step", 8, 32, 512, None, torch.float32),
        ("train_svrg_step", 8, 32, 512, 2, torch.float32),
        # phase 12's deep steps (the multi-dominator layer 1 and layer 2
        # are deep serving's (8, 64, 512)·32 and (8, 64, 32)·16 above)
        ("deep_train_layer1", 8, 32, 512, 32, torch.float32),
        ("deep_train_layer2", 8, 32, 32, 16, torch.float32),
        ("deep_svrg_layer1", 8, 32, 512, 64, torch.float32),
        ("deep_multi_svrg_layer1", 8, 64, 512, 64, torch.float32),
        # phase 16's packed q = 64 step: dp = 64 a party
        ("train_step_q64", MESH_Q, 32, D // MESH_Q, None, torch.float32),
    ]
    for name, p, b, d, m, dtype in fwd:
        x = randn(*((b, d) if p is None else (p, b, d)), dtype=dtype)
        wshape = ((d,) if m is None else (d, m))
        w = randn(*(wshape if p is None else (p,) + wshape), dtype=dtype)
        wcol = w if m is not None else w.unsqueeze(-1)
        zbytes = math.prod(x.shape[:-1]) * (m or 1) * 4
        program = vg.PROGRAMS[0] if (m or 1) <= vg.NARROW_MAX_M \
            else vg.PROGRAMS[1]
        rows.append(_kernel_row(
            torch, name, [program], x,
            lambda: ops.vfl_grad(x, w)[0], lambda: ref.vfl_forward_ref(x, w),
            lambda: torch.matmul(x, wcol), _nbytes(x, w) + zbytes,
            2.0 * x.numel() * (m or 1)))

    # backward: (name, P, B, D, M or None, ϑ shared by the parties, with
    # the λW epilogue, denom or None, dtype)
    bwd = [
        ("train_sgd_step", 8, 32, 512, None, True, False, None,
         torch.float32),
        ("train_svrg_step", 8, 32, 512, 2, True, False, None,
         torch.float32),
        ("train_saga_step", 8, 32, 512, None, False, False, 1,
         torch.float32),
        ("ragged", 5, 37, 333, 3, False, True, None, torch.float32),
        ("ragged_chunks", 3, 2500, 130, 5, True, True, None, torch.float32),
        ("few_rows", 3, 7, 333, None, True, False, None, torch.float32),
        ("chunk_edge", 2, 1025, 512, 2, False, True, None, torch.float32),
        ("train_sgd_step_bf16", 8, 32, 512, None, True, False, None,
         torch.bfloat16),
        # phase 12's deep steps: xᵀ∂u per party at Mθ = hidden (SVRG:
        # 2·hidden), hᵀϑ_z with ϑ_z shared at Mθ = d_rep
        ("deep_w1_step", 8, 32, 512, 32, False, False, 1, torch.float32),
        ("deep_svrg_w1_step", 8, 32, 512, 64, False, False, 1,
         torch.float32),
        ("deep_multi_w1_step", 8, 64, 512, 32, False, False, 1,
         torch.float32),
        ("deep_w2_step", 8, 32, 32, 16, True, False, 1, torch.float32),
        # phase 16's packed q = 64 step: dp = 64 a party
        ("train_sgd_step_q64", MESH_Q, 32, D // MESH_Q, None, True, False,
         None, torch.float32),
    ]
    for name, p, b, d, m, shared, with_w, denom, dtype in bwd:
        x = randn(p, b, d, dtype=dtype)
        tail = () if m is None else (m,)
        th = randn(*((b,) + tail if shared else (p, b) + tail))
        thq = th.expand(p, *th.shape) if shared else th
        w = randn(p, d, *tail, dtype=dtype) if with_w else None
        lam = 0.03 if with_w else 0.0
        progs = ["vfl_backward_rows"] + (["vfl_backward_reduce"]
                                         if b > vg.BWD_CHUNK_ROWS else [])
        thcol = thq if m is not None else thq.unsqueeze(-1)
        # one PyTorch call computing x^T θ / denom + λW into f32; none
        # takes bf16 x with f32 θ
        base = torch.zeros((p, d, m or 1), device=dev) if w is None \
            else w.reshape(p, d, m or 1)
        library = None if dtype == torch.bfloat16 else (
            lambda: torch.baddbmm(base, x.transpose(1, 2), thcol, beta=lam,
                                  alpha=1.0 / (denom or b)))
        rows.append(_kernel_row(
            torch, name, progs, x,
            lambda: ops.vfl_grad(x, w, thq, lam, mode="backward",
                                 denom=denom)[1],
            lambda: ref.vfl_backward_ref(x, thq, w, lam, denom), library,
            _nbytes(x, thq) + (0 if w is None else _nbytes(w))
            + p * d * (m or 1) * 4, 2.0 * x.numel() * (m or 1)))

    # the multi-dominator step's backward: the m = 2 dominators' ϑ as the
    # block-diagonal Θ (64, 2), shared by the parties, denom B = 32
    from repro_torch.core.engine import dominator_onehot
    x = randn(Q, 2 * TRAIN_BATCH, D // Q)
    thq = (randn(2 * TRAIN_BATCH)[:, None]
           * dominator_onehot(M_ACT, TRAIN_BATCH, dev)).expand(Q, -1, -1)
    zeros = torch.zeros((Q, D // Q, M_ACT), device=dev)
    rows.append(_kernel_row(
        torch, "train_multi_step", ["vfl_backward_rows"], x,
        lambda: ops.vfl_grad(x, None, thq, mode="backward",
                             denom=TRAIN_BATCH)[1],
        lambda: ref.vfl_backward_ref(x, thq, None, 0.0, TRAIN_BATCH),
        lambda: torch.baddbmm(zeros, x.transpose(1, 2), thq, beta=0.0,
                              alpha=1.0 / TRAIN_BATCH),
        _nbytes(x, thq) + zeros.numel() * 4, 2.0 * x.numel() * M_ACT))
    # phase 13's multi-dominator deep delayed steps: each dominator's slab
    # apart, through the block-diagonal columns of the m = 2 dominators
    # (dom_block_cols): xᵀ∂u per party at Mθ = m·hidden, hᵀϑ_z shared by
    # the parties at Mθ = m·d_rep
    from repro_torch.core.engine import dom_block_cols
    for name, d, k, shared in (
            ("deep_dom_w1_step", D // Q, DEEP_HIDDEN, False),
            ("deep_dom_w2_step", DEEP_HIDDEN, DEEP_DREP, True)):
        x = randn(Q, M_ACT * TRAIN_BATCH, d)
        th = dom_block_cols(randn(*((M_ACT * TRAIN_BATCH, k) if shared
                                    else (Q, M_ACT * TRAIN_BATCH, k))),
                            M_ACT)
        thq = th.expand(Q, *th.shape) if shared else th
        zeros = torch.zeros((Q, d, M_ACT * k), device=dev)
        rows.append(_kernel_row(
            torch, name, ["vfl_backward_rows"], x,
            lambda: ops.vfl_grad(x, None, thq, mode="backward", denom=1)[1],
            lambda: ref.vfl_backward_ref(x, thq, None, 0.0, 1),
            lambda: torch.baddbmm(zeros, x.transpose(1, 2), thq, beta=0.0),
            _nbytes(x, thq) + zeros.numel() * 4,
            2.0 * x.numel() * M_ACT * k))
    rows += fused_rows(torch, dev, randn)

    # the full-dataset passes: (8, 350000, 512) against one column
    x = randn(Q, N, D // Q)
    w = randn(Q, D // Q)
    rows.append(_kernel_row(
        torch, "full_dataset", ["vfl_forward_narrow"], x,
        lambda: ops.vfl_grad(x, w)[0], lambda: ref.vfl_forward_ref(x, w),
        lambda: torch.matmul(x, w.unsqueeze(-1)),
        _nbytes(x, w) + Q * N * 4, 2.0 * x.numel(), big=True))
    forward_rows_identical(torch, ops, x, w)
    thq = randn(N).expand(Q, N)
    zeros = torch.zeros((Q, D // Q, 1), device=dev)
    rows.append(_kernel_row(
        torch, "full_dataset", ["vfl_backward_rows", "vfl_backward_reduce"],
        x, lambda: ops.vfl_grad(x, None, thq, mode="backward", denom=N)[1],
        lambda: ref.vfl_backward_ref(x, thq, None, 0.0, N),
        lambda: torch.baddbmm(zeros, x.transpose(1, 2), thq.unsqueeze(-1),
                              beta=0.0, alpha=1.0 / N),
        _nbytes(x, thq) + Q * (D // Q) * 4, 2.0 * x.numel(), big=True))
    # the reduce program alone, over the workspace of that pass
    chunks = -(-N // vg.BWD_CHUNK_ROWS)
    ws = randn(chunks, Q, D // Q, 1)
    g = torch.empty((Q, D // Q, 1), device=dev)
    rows.append(_kernel_row(
        torch, "full_dataset_reduce", ["vfl_backward_reduce"], ws,
        lambda: vg.KERNEL.reduce(ws, None, g, float(N), 0.0),
        lambda: ws.sum(0) / N, lambda: torch.sum(ws, 0).div_(N),
        _nbytes(ws) + g.numel() * 4, float(ws.numel())))
    del ws
    rows += deep_full_rows(torch, dev, randn, x)
    del x
    torch.cuda.empty_cache()
    return rows


def deep_full_rows(torch, dev, randn, x):
    """``deep_full_gradient``'s passes over all n samples (phase 12's SVRG
    μ): layer 1's wide forward (8, 350000, 512)·32 and its backward at
    Mθ = 32 (rows and reduce), layer 2's forward (8, 350000, 32)·16 and
    its backward against the shared ϑ_z (n, 16)."""
    from repro_torch.kernels import ops, ref
    rows = []
    hid, drep = DEEP_HIDDEN, DEEP_DREP
    w1 = randn(Q, D // Q, hid)
    rows.append(_kernel_row(
        torch, "deep_full_layer1", ["vfl_forward_wide"], x,
        lambda: ops.vfl_grad(x, w1)[0], lambda: ref.vfl_forward_ref(x, w1),
        lambda: torch.matmul(x, w1), _nbytes(x, w1) + Q * N * hid * 4,
        2.0 * x.numel() * hid, big=True))
    # ∂u and ϑ_z carry the path's 1/n (ϑ_logit is the loss's derivative
    # over n), so the sums stay at the gradient's scale
    du = randn(Q, N, hid) / N
    zeros = torch.zeros((Q, D // Q, hid), device=dev)
    rows.append(_kernel_row(
        torch, "deep_full_w1", ["vfl_backward_rows", "vfl_backward_reduce"],
        x, lambda: ops.vfl_grad(x, None, du, mode="backward", denom=1)[1],
        lambda: ref.vfl_backward_ref(x, du, None, 0.0, 1),
        lambda: torch.baddbmm(zeros, x.transpose(1, 2), du, beta=0.0),
        _nbytes(x, du) + zeros.numel() * 4, 2.0 * x.numel() * hid,
        big=True))
    h, w2 = torch.tanh(randn(Q, N, hid)), randn(Q, hid, drep)
    rows.append(_kernel_row(
        torch, "deep_full_layer2", ["vfl_forward_wide"], h,
        lambda: ops.vfl_grad(h, w2)[0], lambda: ref.vfl_forward_ref(h, w2),
        lambda: torch.matmul(h, w2), _nbytes(h, w2) + Q * N * drep * 4,
        2.0 * h.numel() * drep, big=True))
    thz = (randn(N, drep) / N).expand(Q, N, drep)
    zeros = torch.zeros((Q, hid, drep), device=dev)
    rows.append(_kernel_row(
        torch, "deep_full_w2", ["vfl_backward_rows", "vfl_backward_reduce"],
        h, lambda: ops.vfl_grad(h, None, thz, mode="backward", denom=1)[1],
        lambda: ref.vfl_backward_ref(h, thz, None, 0.0, 1),
        lambda: torch.baddbmm(zeros, h.transpose(1, 2), thz, beta=0.0),
        _nbytes(h, thz) + zeros.numel() * 4, 2.0 * h.numel() * drep,
        big=True))
    return rows


def forward_rows_identical(torch, ops, x, w):
    """A row's z is the same bits in every launch of the narrow forward:
    the full-dataset pass (several rows a warp, streaming loads) against a
    one-row-a-warp launch of its first and last 64 rows, and against the
    same rows in a view whose pointer is off the 16-byte vector width
    (element loads)."""
    full = ops.vfl_grad(x, w)[0]
    for rows in (slice(0, BATCH), slice(N - BATCH, N)):
        part = x[:, rows].contiguous()
        buf = torch.empty(part.numel() + 1, device=x.device)
        off = buf[1:].view(part.shape)
        off.copy_(part)
        for what, xs in (("aligned", part), ("misaligned", off)):
            check(torch.equal(ops.vfl_grad(xs, w)[0], full[:, rows]),
                  f"forward rows {rows} ({what}) differ from the "
                  "full-dataset launch's")
    log("forward: full-dataset rows bit-identical to one-row-a-warp "
        "launches, aligned and misaligned")


def fused_rows(torch, dev, randn):
    """``vfl_fused_split`` (the fused mode and its split-batch form) at the
    pipelined steps' shapes, a ragged split, the non-split mode with λW, a
    wide side and a chunked backward side.  No single PyTorch call
    computes the split function, so there is no library time; the
    ``matmul`` + ``baddbmm`` pair is timed beside it as a note."""
    from repro_torch.kernels import ops, ref
    rows = []
    # (name, P, Bb, Bf or None (no split), D, Mw, Mθ, θ shared, λ, denom,
    # dominators: Θ block-diagonal over them (dom_block_cols), or 0)
    cases = [
        ("pipe_sgd_step", Q, 32, 32, 512, 1, 1, True, 0.0, None, 0),
        ("pipe_svrg_step", Q, 32, 32, 512, 2, 2, True, 0.0, None, 0),
        ("multi_pipe_sgd_step", Q, 64, 64, 512, 1, 2, True, 0.0, 32, 2),
        ("pipe_saga_step", Q, 32, 32, 512, 1, 1, False, 0.0, 1, 0),
        ("ragged_split", 3, 60, 40, 70, 1, 3, True, 0.0, None, 0),
        ("fused_lam", Q, 32, None, 512, 2, 2, False, 0.03, None, 0),
        ("wide_split", Q, 32, 32, 512, 32, 32, False, 0.0, None, 0),
        # phase 12's pipelined deep steps: xᵀ∂u beside the next round's
        # layer-1 forward, per-party ∂u, Mw = Mθ = hidden (SVRG 2·hidden)
        ("deep_pipe_sgd_step", Q, 32, 32, 512, 32, 32, False, 0.0, 1, 0),
        ("deep_pipe_svrg_step", Q, 32, 32, 512, 64, 64, False, 0.0, 1, 0),
        ("deep_multi_pipe_sgd_step", Q, 64, 64, 512, 32, 32, False, 0.0, 1,
         0),
        # phase 13's multi pipelined delayed step: the m dominators' ∂u
        # slabs (Mθ = m·hidden) beside layer 1's forward (Mw = hidden)
        ("deep_dom_pipe_step", Q, 64, 64, 512, 32, 64, False, 0.0, 1,
         M_ACT),
        ("chunked_split", 3, 2500, 100, 130, 2, 2, False, 0.03, None, 0),
    ]
    from repro_torch.core.engine import dom_block_cols
    for name, p, bb, bf, d, mw, mth, shared, lam, denom, doms in cases:
        b = bb + (bf or 0)
        split = None if bf is None else bb
        x = randn(p, b, d)
        w = randn(p, d, mw)
        if doms:
            th = dom_block_cols(randn(*((bb, mth // doms) if shared
                                        else (p, bb, mth // doms))), doms)
        else:
            th = randn(*((bb, mth) if shared else (p, bb, mth)))
        thq = th.expand(p, *th.shape) if shared else th
        xf = x if split is None else x[:, split:]
        xb = x if split is None else x[:, :split]
        base = w if lam else torch.zeros((p, d, mth), device=dev)
        dn = denom or bb
        progs = ["vfl_fused_split"] + (["vfl_backward_reduce"]
                                       if bb > 1024 else [])
        nout = p * (b - (split or 0)) * mw + p * d * mth
        rows.append(_kernel_row(
            torch, name, progs, x,
            lambda: ops.vfl_grad(x, w, thq, lam, mode="fused", split=split,
                                 denom=denom),
            lambda: ref.vfl_fused_ref(x, w, thq, lam, denom, split), None,
            _nbytes(x, w, thq) + 4 * nout,
            2.0 * p * d * ((b - (split or 0)) * mw + bb * mth),
            pair=lambda: (torch.matmul(xf, w),
                          torch.baddbmm(base, xb.transpose(1, 2), thq,
                                        beta=lam, alpha=1.0 / dn))))
    return rows


def _card_clock_and_sms(torch):
    """The card's maximum SM clock (Hz, from nvidia-smi) and SM count."""
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.split()[0]
    return float(mhz) * 1e6, torch.cuda.get_device_properties(
        0).multi_processor_count


def _kernel_name(symbol):
    """A kernel's name and integer template arguments from its mangled
    symbol, e.g. ``flash_ws_kernel<256,1>``."""
    i, name = symbol.find("_ZN") + 3, symbol
    while 2 < i < len(symbol) and symbol[i].isdigit():
        j = i
        while symbol[j].isdigit():
            j += 1
        name, i = symbol[j:j + int(symbol[i:j])], j + int(symbol[i:j])
    args = re.findall(r"L[ib](\d+)E", symbol[i:].split("EE")[0] + "E") \
        if symbol[i:i + 1] == "I" else []
    return f"{name}<{','.join(args)}>" if args else name


def _ptxas_summary(build_log):
    """The most registers and the spill bytes over a library's kernels,
    from nvcc's ``-Xptxas -v`` report, and the kernels that spill (empty
    when the library was reused, not built)."""
    regs = [int(w) for w in re.findall(r"Used (\d+) registers", build_log)]
    spilled = [(_kernel_name(sym), int(b)) for sym, b in re.findall(
        r"Function properties for (\S+)\n\s*\d+ bytes stack frame, (\d+) "
        r"bytes spill stores", build_log)]
    spills = [f"{name}: {b} B" for name, b in spilled if b]
    return (f"{len(regs)} kernels, at most {max(regs, default=0)} "
            f"registers, {sum(b for _, b in spilled)} bytes of spill "
            f"stores" + (f" (in {'; '.join(spills)})" if spills else ""))


def _instances(build_log, prefixes):
    """Registers and spill stores of each kernel instance whose name starts
    with one of ``prefixes``, from nvcc's ``-Xptxas -v`` report."""
    out = []
    for sym, stores, regs in re.findall(
            r"Function properties for (\S+)\n\s*\d+ bytes stack frame, "
            r"(\d+) bytes spill stores.*?\n.*?Used (\d+) registers",
            build_log):
        name = _kernel_name(sym)
        if name.startswith(tuple(prefixes)):
            dtype = "bf16" if "bfloat16" in sym else "f32"
            out.append(f"{name} {dtype}: {regs} registers, {stores} B "
                       "spilled")
    return out


def scan_rows(torch, dev):
    """``selective_scan`` against its plain version on the card at the
    reference's sweep shapes (``tests/test_kernels.py:62-77``), a ragged
    shape and phase 9's prefill shape; kernel and plain timed at the
    last.  Its bound: bytes over HBM, f32 FLOPs over the f32 peak and the
    exponentials over the special-function units' rate, the largest."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    clock, sms = _card_clock_and_sms(torch)
    exp_per_s = SFU_EXP_PER_CLOCK_PER_SM * sms * clock
    log(f"selective_scan bound: {sms} SMs at {clock / 1e9:.3f} GHz max "
        f"SM clock, {exp_per_s / 1e12:.3f}e12 exp/s")
    rows = []
    shapes = [("sweep_1", 1, 64, 128, 8), ("sweep_2", 2, 128, 256, 16),
              ("sweep_3", 1, 32, 512, 4), ("ragged", 3, 517, 1000, 16)]
    cases = [(n, sh, dt, False) for n, *sh in shapes
             for dt in (torch.float32, torch.bfloat16)]
    prefill = (LM_BATCH, LM_PROMPT, 8192, 16)
    # a_log drawn per (channel, state), as trained weights have, beside
    # mamba's log(1..N) in every channel
    cases += [("ragged_random_a", (3, 517, 1000, 16), torch.float32, True),
              ("prefill_random_a", prefill, torch.bfloat16, True),
              ("prefill", prefill, torch.bfloat16, False)]
    for name, (b, s, c, n), dtype, random_a in cases:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        xa = randn(b, s, c).to(dtype)
        dt = torch.nn.functional.softplus(randn(b, s, c))
        bm, cm = randn(b, s, n), randn(b, s, n)
        if random_a:
            a_log = torch.log(torch.rand((c, n), generator=gen, device=dev)
                              * 15.5 + 0.5)
        else:
            a_log = torch.log(torch.arange(1, n + 1, device=dev,
                                           dtype=torch.float32)).repeat(c, 1)
        d_skip = randn(c)
        args = (xa, dt, bm, cm, a_log, d_skip)
        y = ops.selective_scan(*args)
        again = ops.selective_scan(*args)
        want = ref.selective_scan(*args)
        torch.cuda.synchronize()
        err = float((y.float() - want.float()).abs().max())
        tol = SCAN_TOL[str(dtype).replace("torch.", "")]
        check(y.dtype == dtype and y.shape == xa.shape,
              f"selective_scan {name}: {y.dtype} {tuple(y.shape)}")
        check(torch.allclose(y.float(), want.float(), atol=tol, rtol=tol),
              f"selective_scan {name} {dtype}: max abs err {err} beyond "
              f"{tol}")
        check(torch.equal(y, again),
              f"selective_scan {name} {dtype}: two calls differ")
        row = dict(name=name, programs=["selective_scan"], x=[b, s, c, n],
                   dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                   random_a=random_a, repeat_equal=True)
        if name == "prefill":
            nbytes = _nbytes(*args) + y.numel() * y.element_size()
            elems = b * s * c * n
            flops = 5.0 * elems + 3.0 * b * s * c
            by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            by_ops = max(flops / F32_FLOP_PER_S, elems / exp_per_s) * 1e3
            row.update(
                ms=_graph_ms(torch, lambda: ops.selective_scan(*args),
                             reps=10, replays=5),
                plain_ms=_graph_ms(torch, lambda: ref.selective_scan(*args),
                                   reps=1, replays=3),
                library_ms=None, bytes=nbytes, exps=elems, flops=flops,
                bound_bytes_ms=by_bytes, bound_ops_ms=by_ops,
                bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")
            log(f"selective_scan {name} x{row['x']} {row['dtype']}: err "
                f"{err:.3e}  kernel {row['ms']*1e3:.2f} us  plain "
                f"{row['plain_ms']*1e3:.2f} us  library -  bound "
                f"{row['bound_ms']*1e3:.3f} us ({row['bound_by']}; bytes "
                f"{by_bytes*1e3:.3f}, operations {by_ops*1e3:.3f})")
        else:
            log(f"selective_scan {name} x{row['x']} {row['dtype']}: err "
                f"{err:.3e} (tol {tol}), two calls equal")
        rows.append(row)
        del args, xa, dt, bm, cm, y, again, want
    torch.cuda.empty_cache()
    return rows


def _valid_pairs(sq, skv, causal, window):
    """The (query, key) pairs the mask keeps, counted exactly."""
    total = 0
    for i in range(sq):
        hi = min(skv, i + 1) if causal else skv
        lo = 0 if window is None else max(0, i - window + 1)
        total += max(0, hi - lo)
    return total


def _cold_sets(touched):
    """How many operand sets a cold time rotates over: enough that between
    two calls on one set the others touch twice the L2 cache, so the
    set's bytes are gone from it, as they are for a 34-layer model whose
    every layer has its own weights and cache."""
    return 1 + math.ceil(2 * L2_BYTES / touched)


def _timed_row(torch, name, program, dtype, x, kernels, plain, libraries,
               nbytes, flops, peak, err, big):
    """Kernel, plain and library times (CUDA events over graph replays)
    beside the bound: bytes over HBM or FLOPs over ``peak``.
    ``kernels`` and ``libraries`` are one call per operand set; the first
    set's call repeated gives the warm time (``ms``, ``library_ms``), all
    of them in turn the cold time (``cold_ms``, ``library_cold_ms``),
    which is what the bound is held against."""
    reps = dict(reps=6, replays=3) if big else {}
    row = dict(name=name, programs=[program], x=list(x),
               dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
               ms=_graph_ms(torch, kernels[0], **reps),
               cold_ms=_graph_ms(torch, kernels, **reps),
               plain_ms=_graph_ms(torch, plain, **(
                   dict(reps=1, replays=3) if big else {})),
               bytes=nbytes, flops=flops, cold_sets=len(kernels))
    row["library_ms"] = None if libraries is None \
        else _graph_ms(torch, libraries[0], **reps)
    row["library_cold_ms"] = None if libraries is None \
        else _graph_ms(torch, libraries, **reps)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / peak * 1e3
    row.update(bound_ms=max(by_bytes, by_ops),
               bound_by="bytes" if by_bytes >= by_ops else "operations",
               bound_bytes_ms=by_bytes, bound_ops_ms=by_ops)
    lib = "-" if libraries is None else (
        f"{row['library_ms']*1e3:.2f} us warm, "
        f"{row['library_cold_ms']*1e3:.2f} cold")
    log(f"{program} {name:12s} x{row['x']} {row['dtype']}: err {err:.3e}  "
        f"kernel {row['ms']*1e3:.2f} us warm, {row['cold_ms']*1e3:.2f} cold "
        f"({row['bound_ms'] / row['cold_ms']:.0%} of the bound)  plain "
        f"{row['plain_ms']*1e3:.2f} us  library {lib}  bound "
        f"{row['bound_ms']*1e3:.3f} us ({row['bound_by']}; bytes "
        f"{by_bytes*1e3:.3f}, operations {by_ops*1e3:.3f})")
    return row


def flash_rows(torch, dev):
    """``flash_attention`` against its plain version on the card at
    phase 10's prefill shape (B 4, H 8, Hkv 4, S 4096, dh 256, bf16; q, k
    and v as the model's transposed (B, S, H, dh) views), once global and
    once with gemma3's window of 1024; at granite-8b's and internlm2-20b's
    (H 32 and 48 over Hkv 8, dh 128, a 4,096-token prompt at B 1: the
    plain version's f32 scores are 2-3 GB there); at phase 20's
    qwen3-moe prefill (B 4, H 32 over Hkv 4, S 2048, dh 128) and phase
    21's jamba prefill (over Hkv 8); at phase 22's whisper-tiny shapes,
    non-causal at dh 64 in groups of 1 (B 4, H 6 over 6): the encoder's
    self attention over 1,500 frames and the decoder's cross attention,
    224 queries over the 1,500 encoder keys; a ragged shape and a small
    f32 shape.  The bound counts the FLOPs of the pairs the mask keeps
    (bf16 at the dense tensor peak, f32 at the f32 peak) against the
    bytes of q, k, v and o.  The library yardstick is one
    ``scaled_dot_product_attention`` call (``enable_gqa``; ``is_causal``,
    a boolean window mask, or no mask where non-causal).  Warm and cold times as ``_timed_row``;
    the rows at S ≥ 2,048 with its fewer repeats (the plain version takes
    14-20 ms a call there)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    # (name, b, h, hkv, s (query positions), key positions, dh, causal,
    # window, dtype)
    wb, wenc, wdec = FRONTENDS[0][1], 1500, FRONTENDS[0][2]
    cases = [("global", DENSE_BATCH, 8, 4, DENSE_PROMPT, DENSE_PROMPT, 256,
              True, None, torch.bfloat16),
             ("local", DENSE_BATCH, 8, 4, DENSE_PROMPT, DENSE_PROMPT, 256,
              True, 1024, torch.bfloat16),
             ("granite", 1, 32, 8, DENSE_PROMPT, DENSE_PROMPT, 128, True,
              None, torch.bfloat16),
             ("internlm2", 1, 48, 8, DENSE_PROMPT, DENSE_PROMPT, 128, True,
              None, torch.bfloat16),
             ("qwen3_moe", MOE_BATCH, 32, 4, MOE_PROMPT, MOE_PROMPT, 128,
              True, None, torch.bfloat16),
             ("jamba", HYBRID_BATCH, 32, 8, HYBRID_PROMPT, HYBRID_PROMPT,
              128, True, None, torch.bfloat16),
             ("whisper_enc", wb, 6, 6, wenc, wenc, 64, False, None,
              torch.bfloat16),
             ("whisper_cross", wb, 6, 6, wdec, wenc, 64, False, None,
              torch.bfloat16),
             ("ragged", 1, 4, 2, 1000, 1000, 128, True, None,
              torch.bfloat16),
             ("small_f32", 2, 4, 2, 256, 256, 64, True, 96, torch.float32)]
    rows = []
    for name, b, h, hkv, s, skv, dh, causal, window, dtype in cases:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        def operands():
            return (randn(b, s, h, dh).transpose(1, 2),
                    randn(b, skv, hkv, dh).transpose(1, 2),
                    randn(b, skv, hkv, dh).transpose(1, 2))
        q, k, v = first = operands()
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = FLASH_TOL[str(dtype).replace("torch.", "")]
        check(got.dtype == dtype and got.shape == q.shape
              and got.stride() == q.stride(),
              f"flash_attention {name}: {got.dtype} {tuple(got.shape)} "
              f"{got.stride()}")
        check(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
              f"flash_attention {name}: max abs err {err} beyond {tol}")
        del want
        nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, got))
        sets = [first] + [operands()
                          for _ in range(_cold_sets(nbytes) - 1)]
        mask = None
        if window is not None:
            i = torch.arange(s, device=dev)
            mask = (i[:, None] >= i[None, :]) \
                & (i[None, :] > i[:, None] - window)

        def library(q, k, v):
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=True)
        pairs = _valid_pairs(s, skv, causal, window)
        rows.append(_timed_row(
            torch, name, "flash_attention", dtype, q.shape,
            [lambda q=q, k=k, v=v: ops.flash_attention(
                q, k, v, causal=causal, window=window) for q, k, v in sets],
            lambda: ref.attention_ref(q, k, v, causal=causal,
                                      window=window),
            [lambda q=q, k=k, v=v: library(q, k, v) for q, k, v in sets],
            nbytes, 4.0 * b * h * dh * pairs,
            BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S,
            err, big=s >= MOE_PROMPT))
        rows[-1].update(valid_pairs=pairs, key_positions=skv,
                        causal=causal)
        del q, k, v, first, sets, got, mask
        torch.cuda.empty_cache()
    return rows


def decode_rows(torch, dev):
    """``decode_attention`` against its plain version on the card at phase
    10's decode shape: q (4, 8, 256) over caches (4, 4128, 4, 256) bf16
    (a layer of the stacked cache) as 8 party shards of 516 positions, at
    pos 4100, once global and once with the window of 1024 (shards 0-4
    then hold no valid position), and at pos 1000 (shards 2-7 wholly in
    the future); then at granite-8b's and internlm2-20b's decode, q (4,
    32 or 48, 128) over caches (4, 4128, 8, 128), global at pos 4100; and
    at phase 20's qwen3-moe decode, q (4, 32, 128) over caches (4, 2080,
    4, 128) as 8 shards of 260, global at pos 2050 (and phase 21's jamba,
    over 8 KV heads); and at phase 22's whisper-tiny cross attention, q
    (4, 6, 64) over the padded cross cache (4, 1504, 6, 64) as 8 shards
    of 188 at pos 1499 (enc_seq − 1: the padding never attended).  A
    shard with no valid position must give l = 0, o = 0 and m = −1e30.
    The bound is the bytes of the K/V positions in the window (plus q and
    the partials) against their f32 FLOPs; the library yardstick is one
    ``scaled_dot_product_attention`` call of the one query over the valid
    positions (no PyTorch call returns the shards' (o, m, l)).  Warm and
    cold times as ``_timed_row``: each set is a whole layer's cache."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    dense_s = DENSE_PROMPT + DENSE_GEN
    rows = []
    # (name, h, hkv, dh, cache positions, pos, window)
    for name, h, hkv, dh, s, pos, window in (
            ("global", 8, 4, 256, dense_s, 4100, None),
            ("local", 8, 4, 256, dense_s, 4100, 1024),
            ("future", 8, 4, 256, dense_s, 1000, None),
            ("granite", 32, 8, 128, dense_s, 4100, None),
            ("internlm2", 48, 8, 128, dense_s, 4100, None),
            ("qwen3_moe", 32, 4, 128, MOE_PROMPT + MOE_GEN, 2050, None),
            ("jamba", 32, 8, 128, HYBRID_PROMPT + HYBRID_GEN, 2050, None),
            ("whisper_cross", 6, 6, 64, 1504, 1499, None)):
        b = DENSE_BATCH

        def operands():
            stack = torch.randn((2, b, s, hkv, dh), generator=gen,
                                device=dev).to(torch.bfloat16)
            return (torch.randn((b, h, dh), generator=gen,
                                device=dev).to(torch.bfloat16),
                    stack[0], stack[1])
        q, kc, vc = first = operands()
        pos_t = torch.full((), pos, dtype=torch.int32, device=dev)
        got = ops.decode_attention(q, kc, vc, pos_t, 0, window,
                                   shards=DENSE_Q)
        want = ref.decode_attention_ref(q, kc, vc, pos, 0, window, DENSE_Q)
        torch.cuda.synchronize()
        norm = [t[0] / t[2].clamp(min=1e-30)[..., None] for t in (got, want)]
        err = float((norm[0] - norm[1]).abs().max())
        tol = DECODE_TOL["bfloat16"]
        check(torch.allclose(norm[0], norm[1], atol=tol, rtol=tol)
              and err <= DECODE_P_TOL,
              f"decode_attention {name}: normalised max abs err {err}")
        check(torch.allclose(got[2], want[2], atol=2e-4, rtol=2e-4)
              and torch.allclose(got[1], want[1], atol=1e-4, rtol=1e-4),
              f"decode_attention {name}: m or l differ from the plain "
              "version's")
        masked = want[2] == 0
        check(torch.equal(got[2] == 0, masked)
              and not got[0][masked].any()
              and bool((got[1][masked] == -1e30).all()),
              f"decode_attention {name}: a shard with no valid position "
              "must give l = 0, o = 0, m = -1e30")
        again = ops.decode_attention(q, kc, vc, pos_t, 0, window,
                                     shards=DENSE_Q)
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"decode_attention {name}: two calls differ")
        lo = 0 if window is None else max(0, pos - window + 1)
        n_valid = pos + 1 - lo
        nbytes = (2 * b * n_valid * hkv * dh * 2 + q.numel() * 2
                  + sum(t.numel() * 4 for t in got))
        sets = [first] + [operands()
                          for _ in range(_cold_sets(nbytes) - 1)]

        def library(q, kc, vc):
            return F.scaled_dot_product_attention(
                q[:, :, None], kc[:, lo:pos + 1].transpose(1, 2),
                vc[:, lo:pos + 1].transpose(1, 2), enable_gqa=True)
        rows.append(_timed_row(
            torch, name, "decode_attention", torch.bfloat16, kc.shape,
            [lambda q=q, kc=kc, vc=vc: ops.decode_attention(
                q, kc, vc, pos_t, 0, window, shards=DENSE_Q)
             for q, kc, vc in sets],
            lambda: ref.decode_attention_ref(q, kc, vc, pos, 0, window,
                                             DENSE_Q),
            [lambda q=q, kc=kc, vc=vc: library(q, kc, vc)
             for q, kc, vc in sets],
            nbytes, 4.0 * b * h * dh * n_valid, F32_FLOP_PER_S,
            err, big=False))
        rows[-1].update(pos=pos, window=window, valid_positions=n_valid,
                        masked_shards=int(masked[:, 0, 0].sum()),
                        heads=h, kv_heads=hkv, d_head=dh)
        del q, kc, vc, first, sets, got, want, again
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# serving phases
# ---------------------------------------------------------------------------

def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _serve_chunks(sv, ids):
    """Serve ``ids`` in BATCH-request chunks; returns (predictions,
    per-chunk host latencies in ms).  ``serve`` returns host numpy, so each
    latency ends after the device finished."""
    out = np.empty(ids.shape[0], np.float32)
    lat = []
    for lo in range(0, ids.shape[0], BATCH):
        t0 = time.perf_counter()
        out[lo:lo + BATCH] = sv.serve(ids[lo:lo + BATCH])
        lat.append((time.perf_counter() - t0) * 1e3)
    return out, lat


def _close(got, want, tol, what):
    want = want.cpu().numpy() if hasattr(want, "cpu") else want
    err = np.abs(got.astype(np.float64) - want)
    bad = err > tol + tol * np.abs(want)
    check(not bad.any(), f"{what}: {int(bad.sum())} predictions beyond "
          f"{tol} of the float64 reference (max abs err {err.max():.3e})")
    return float(err.max())


def _linear_ref(torch, x, w, ids):
    """float64 x[ids] @ w on the card, in slices."""
    idt = torch.as_tensor(ids, device=x.device)
    out = []
    for lo in range(0, idt.shape[0], 32768):
        out.append(x[idt[lo:lo + 32768]].double() @ w.double())
    return torch.cat(out)


def _latency(lat, count):
    total_s = sum(lat) / 1e3
    return dict(chunks=len(lat), p50_ms=pct(lat, 50), p90_ms=pct(lat, 90),
                p99_ms=pct(lat, 99), requests_per_s=count / total_s,
                seconds=total_s)


def _zipf_ids(n, count, seed, s=1.0):
    """``count`` draws from a Zipf(s) over ranks 1..n, ranks mapped to a
    random permutation of the ids so the hot set is scattered."""
    rng = np.random.default_rng(seed)
    cdf = np.cumsum(1.0 / np.arange(1, n + 1) ** s)
    ranks = np.searchsorted(cdf / cdf[-1], rng.random(count))
    return rng.permutation(n)[np.minimum(ranks, n - 1)]


def _serve_engine(torch, dev, x, layout, secure, y=None, mesh=None):
    """A FusedEngine over the universe ``x`` (on ``mesh``, a PartyMesh or
    None) and a ServeEngine on it."""
    from repro_torch.core.engine import EngineConfig, FusedEngine
    from repro_torch.core.losses import logistic_l2
    from repro_torch.serve import ServeEngine
    y = torch.ones(x.shape[0], device=dev) if y is None else y
    eng = FusedEngine(logistic_l2(1e-4), x, y, layout,
                      EngineConfig(secure=secure), mesh=mesh, device=dev)
    return ServeEngine(eng, max_batch=BATCH, seed=SEED, device=dev)


def expected_launches(sv):
    """Launches per kernel program implied by ``sv``'s dispatches: the
    linear path (M=1) runs the narrow program, the deep encoder layers
    (M=32, 16) the wide one."""
    st = sv.stats
    if sv.deep:
        return Counter(vfl_forward_wide=4 * st.full_dispatches
                       + 2 * st.hit_dispatches)
    return Counter(vfl_forward_narrow=2 * (st.full_dispatches
                                           + st.delta_dispatches)
                   + st.hit_dispatches)


def linear_phase(torch, dev, x, layout, *, trace_len, hot_len, log_,
                 secure="two_tree", mesh=None):
    """Serving at full size (``two_tree`` unless told otherwise, over
    ``mesh`` if given): cold → Zipf hits → update → delta → queue.  The
    queue's results must equal a later ``serve`` of the same ids bit for
    bit, which holds where a row re-dispatched with a zero payload adds
    exactly zero: ``two_tree`` (ξ₁ − ξ₂ of the same masks) and ``off``,
    not ``ring`` (its masks cancel to rounding), so under ``ring`` the
    queue is skipped.  Returns (metrics, expected launches)."""
    n, d = x.shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    y = torch.where(torch.randn(n, generator=gen, device=dev) > 0, 1.0, -1.0)
    sv = _serve_engine(torch, dev, x, layout, secure, y, mesh)
    w0 = torch.randn(d, generator=gen, device=dev) / d ** 0.5
    sv.set_weights(w0)
    res = {}

    all_ids = np.arange(n)
    cold, lat = _serve_chunks(sv, all_ids)
    res["cold"] = _latency(lat, n)
    res["cold"]["max_abs_err"] = _close(
        cold, _linear_ref(torch, x, w0, all_ids), 1e-4, "linear cold")
    check(sv.stats.full_dispatches == -(-n // BATCH), "cold routing")
    log_(f"linear cold: {res['cold']}")

    trace = _zipf_ids(n, trace_len, SEED + 2)
    hits0 = sv.stats.hit_dispatches
    warm, lat = _serve_chunks(sv, trace)
    res["warm"] = _latency(lat, trace_len)
    check(sv.stats.hit_dispatches - hits0 == -(-trace_len // BATCH),
          "warm trace must be all hits")
    check(np.array_equal(warm, cold[trace]),
          "warm hits are not bit-exact against the cold values")
    res["warm"]["distinct_ids"] = int(np.unique(trace).shape[0])
    log_(f"linear warm (Zipf, all hits, bit-exact): {res['warm']}")

    _, first = np.unique(trace, return_index=True)
    hot = trace[np.sort(first)][:hot_len]
    w1 = w0 + 0.01 * torch.randn(d, generator=gen, device=dev) / d ** 0.5
    sv.set_weights(w1)
    delta0 = sv.stats.delta_dispatches
    refreshed, lat = _serve_chunks(sv, hot)
    res["delta"] = _latency(lat, hot.shape[0])
    check(sv.stats.delta_dispatches - delta0 == -(-hot.shape[0] // BATCH),
          "one-version-stale entries must route through delta")
    res["delta"]["max_abs_err"] = _close(
        refreshed, _linear_ref(torch, x, w1, hot), 1e-4,
        "linear delta")
    again, _ = _serve_chunks(sv, hot)
    check(np.array_equal(again, refreshed),
          "repaired entries must re-serve bit-exactly")
    log_(f"linear delta: {res['delta']}")

    if secure != "ring":
        res["queue"] = queue_phase(sv, trace)
        res["queue"]["max_abs_err"] = _close(
            sv.serve(trace[:4096]),
            _linear_ref(torch, x, w1, trace[:4096]), 1e-4, "queue")
        log_(f"queue: {res['queue']}")
    res["stats"] = dict(vars(sv.stats))
    return res, expected_launches(sv)


def queue_phase(sv, trace, threads=8, per_thread=48):
    """Concurrent clients through ServeQueue; each result must equal
    ``sv.serve`` on the same ids afterwards."""
    from repro_torch.serve import ServeQueue
    rng = np.random.default_rng(SEED + 3)
    jobs = [[trace[rng.integers(0, trace.shape[0], size=rng.integers(1, 5))]
             for _ in range(per_thread)] for _ in range(threads)]
    results = [[] for _ in range(threads)]
    errors = []

    def client(i):
        try:
            for ids in jobs[i]:
                results[i].append(q.serve(ids, timeout=60.0))
        except Exception as e:              # relayed to the main thread
            errors.append(e)

    t0 = time.perf_counter()
    with ServeQueue(sv, max_wait=0.002) as q:
        pool = [threading.Thread(target=client, args=(i,))
                for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(120.0)
            check(not t.is_alive(), "queue client did not finish")
    seconds = time.perf_counter() - t0
    check(not errors, f"queue clients failed: {errors[:1]}")
    nreq = 0
    for i in range(threads):
        for ids, got in zip(jobs[i], results[i]):
            check(np.array_equal(got, sv.serve(ids)),
                  "queue result differs from ServeEngine.serve")
            nreq += ids.shape[0]
    return dict(requests=nreq, submits=threads * per_thread,
                batches=q.coalesced_batches, seconds=seconds)


def secure_pass(torch, dev, x, layout, secure, count):
    """A short cold-then-hit pass under another secure mode."""
    n, d = x.shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    sv = _serve_engine(torch, dev, x, layout, secure)
    w = torch.randn(d, generator=gen, device=dev) / d ** 0.5
    sv.set_weights(w)
    ids = np.random.default_rng(SEED + 5).permutation(n)[:count]
    cold, lat = _serve_chunks(sv, ids)
    res = _latency(lat, count)
    res["max_abs_err"] = _close(cold, _linear_ref(torch, x, w, ids),
                                1e-4, f"linear {secure}")
    hit, _ = _serve_chunks(sv, ids)
    check(np.array_equal(hit, cold), f"{secure}: hits not bit-exact")
    return res, expected_launches(sv)


def deep_phase(torch, dev, x, layout, count, mesh=None):
    """Deep serving (hidden=32, d_rep=16) under ``two_tree`` (over
    ``mesh`` if given), cold then hits over a subset, against a float64
    plain encoder on the card."""
    from repro_torch.core.deep_vfl import init_deep_vfl
    n, d = x.shape
    sv = _serve_engine(torch, dev, x, layout, "two_tree", mesh=mesh)
    params = init_deep_vfl(torch.Generator(device=dev).manual_seed(SEED + 6),
                           layout, d, hidden=32, d_rep=16)
    sv.set_deep_params(params)
    ids = np.random.default_rng(SEED + 7).permutation(n)[:count]
    cold, lat = _serve_chunks(sv, ids)
    res = {"cold": _latency(lat, count)}
    idt = torch.as_tensor(ids, device=dev)
    z = 0
    for (lo, hi), w1, b1, w2 in zip(layout.bounds, params.enc_w1,
                                    params.enc_b1, params.enc_w2):
        xb = x[idt, lo:hi].double()
        z = z + torch.tanh(xb @ w1.double() + b1.double()) @ w2.double()
    res["cold"]["max_abs_err"] = _close(cold, z @ params.head.double(),
                                        1e-4, "deep cold")
    hit, lat = _serve_chunks(sv, ids)
    res["hit"] = _latency(lat, count)
    check(np.array_equal(hit, cold), "deep hits not bit-exact vs cold")
    check(sv.stats.hit_dispatches == -(-count // BATCH), "deep hit routing")
    res["stats"] = dict(vars(sv.stats))
    return res, expected_launches(sv)


def _device_kernels(prof):
    """Device time (µs) by name of a finished torch.profiler window's
    device activities (kernels and copies), read from its raw (kineto)
    events: ``key_averages`` first builds a function event for every
    event, which over a training step through the plain scan (some 10⁵
    launches) took about a minute on the card's host."""
    from torch.autograd import DeviceType
    kernels = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            kernels[ev.name()] = kernels.get(ev.name(), 0.0) \
                + ev.duration_ns() / 1e3
    return kernels


def profile_window(torch, dev, x, layout, chunks=200):
    """Device busy share over ``chunks`` cold two_tree dispatches and then
    the same ids again as hits, from torch.profiler (None where the
    profiler records no device time)."""
    from torch.profiler import ProfilerActivity, profile

    sv = _serve_engine(torch, dev, x, layout, "two_tree")
    sv.set_weights(torch.ones(x.shape[1], device=dev) / x.shape[1])
    _serve_chunks(sv, np.arange(BATCH))            # warm the path
    sel = np.arange(BATCH, (chunks + 1) * BATCH)
    out = {}
    for label in ("cold_full", "hit"):             # same ids: then all hits
        _sync(torch, dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _serve_chunks(sv, sel)
            _sync(torch, dev)
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = _device_kernels(prof)
        busy = sum(kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
        out[label] = dict(
            dispatches=sel.shape[0] // BATCH, wall_us=wall_us,
            device_busy_us=busy,
            device_busy_share=(busy / wall_us) if busy > 0 else None,
            top_device_us=[[k[:80], v] for k, v in top])
        log(f"profile {label}: {out[label]}")
    return out, expected_launches(sv)


# ---------------------------------------------------------------------------
# training phase
# ---------------------------------------------------------------------------

def implied(steps=0, full=0, objective=0, pipe_steps=0):
    """Launches per kernel program implied by ``steps`` minibatch steps
    (one forward, one single-chunk backward each), ``full`` full-dataset
    passes (``full_gradient``/``saga_init``: one forward, one backward
    over 342 chunks and its reduce), ``objective`` evaluations (one
    forward) and one pipelined epoch of ``pipe_steps`` steps (a forward
    prologue, one split-batch fused launch per interior step, a backward
    epilogue).  A delayed epoch launches as its fresh form does: the
    ring's write and read are PyTorch ops, not kernel programs."""
    pipe = int(pipe_steps > 0)
    return Counter(vfl_forward_narrow=steps + full + objective + pipe,
                   vfl_backward_rows=steps + full + pipe,
                   vfl_backward_reduce=full,
                   vfl_fused_split=max(pipe_steps - 1, 0))


@contextlib.contextmanager
def no_host_sync(torch):
    """Any synchronising CUDA call inside raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def d4_labels(torch, dev, x):
    """The repo's D4 recipe (``data/synthetic.py:38-65``) on the card, in
    place on ``x`` (n, d) of standard normals: columns standardised,
    w* with 90% non-zeros, labels ±1 drawn from σ(x·w*/√d / 0.8)."""
    n, d = x.shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    x.sub_(x.mean(0)).div_(x.std(0, correction=0) + 1e-6)
    w_star = torch.randn(d, generator=gen, device=dev) \
        * (torch.rand(d, generator=gen, device=dev) < 0.9)
    p = torch.sigmoid(x @ w_star / math.sqrt(d) / 0.8)
    return torch.where(torch.rand(n, generator=gen, device=dev) < p,
                       1.0, -1.0)


def _rel(a, b):
    return float((a.double() - b).norm() / b.norm())


def train_phase(torch, dev, x, y, layout, log_):
    """The training checks of phase 7; returns (record, expected
    launches, (schedule, iterate) of the first SGD epoch).  ``x`` (n, d)
    f32 and ``y`` live on the card."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core.engine import EngineConfig, FusedEngine
    from repro_torch.core.losses import logistic_l2
    n, d = x.shape
    prob, lr, batch = logistic_l2(1e-4), TRAIN_LR, TRAIN_BATCH
    steps = n // batch
    x64, y64 = x.double(), y.double()
    mask64 = torch.ones(d, dtype=torch.float64, device=dev)

    def unpack(vq):
        return torch.cat([vq[p, : hi - lo]
                          for p, (lo, hi) in enumerate(layout.bounds)])

    def objective64(w64):
        return float(prob.loss(x64 @ w64, y64).mean()
                     + prob.lam * prob.reg(w64).sum())

    expected = Counter()
    res = {"epochs": [], "train": {}, "secure_modes": {}}
    eng = FusedEngine(prob, x, y, layout, EngineConfig(secure="two_tree"),
                      device=dev)
    first_sgd = None
    for algo in ("sgd", "svrg", "saga"):
        wq = eng.pack_w(torch.zeros(d, device=dev))
        if algo == "saga":
            with no_host_sync(torch):
                tabq, avgq = eng.saga_init(wq, (SEED,))
            expected += implied(full=1)
            tab64, avg64 = alg.saga_init(prob, unpack(wq).double(), x64, y64)
            check(_rel(tabq[0], tab64) <= 1e-4
                  and _rel(unpack(avgq), avg64) <= 1e-4,
                  "saga_init beyond 1e-4 of the float64 oracle")
        hist = []
        for ep in range(TRAIN_EPOCHS):
            idx = alg.epoch_indices(SEED, ep, n, batch, steps, dev)
            key = (SEED, ep)
            w_in = wq
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with no_host_sync(torch):
                if algo == "sgd":
                    wq = eng.sgd_epoch(wq, lr, idx, key)
                elif algo == "svrg":
                    muq = eng.full_gradient(wq, key)
                    wq = eng.svrg_epoch(wq, wq, muq, lr, idx, key)
                else:
                    tab_in, avg_in = tabq, avgq
                    wq, tabq, avgq = eng.saga_epoch(wq, tabq, avgq, lr, idx,
                                                    key)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            expected += implied(steps=steps, full=algo == "svrg",
                                objective=1)
            obj = eng.objective(wq)
            w64 = unpack(w_in).double()
            if algo == "sgd":
                out64 = alg.sgd_epoch(prob, w64, x64, y64, lr, mask64, idx)
            elif algo == "svrg":
                mu64 = alg.full_gradient(prob, w64, x64, y64)
                check(_rel(unpack(muq), mu64) <= 1e-4,
                      f"svrg epoch {ep}: full gradient beyond 1e-4")
                out64 = alg.svrg_epoch(prob, w64, w64, mu64, x64, y64, lr,
                                       mask64, idx)
            else:
                out64, tab64, _ = alg.saga_epoch(
                    prob, w64, tab_in[0].double(), unpack(avg_in).double(),
                    x64, y64, lr, mask64, idx)
                check(_rel(tabq[0], tab64) <= 1e-4,
                      f"saga epoch {ep}: table beyond 1e-4")
            rel = _rel(unpack(wq), out64)
            obj64 = objective64(out64)
            ep_rec = dict(algo=algo, epoch=ep + 1, seconds=seconds,
                          samples_per_s=steps * batch / seconds,
                          rel_err_vs_f64=rel, objective=obj,
                          objective_f64=obj64,
                          objective_rel_err=abs(obj - obj64) / abs(obj64))
            res["epochs"].append(ep_rec)
            log_(f"train {algo} epoch {ep + 1}: {ep_rec}")
            check(rel <= 1e-4, f"{algo} epoch {ep + 1}: iterate {rel:.3e} "
                  "beyond 1e-4 of the float64 oracle")
            check(ep_rec["objective_rel_err"] <= 1e-5,
                  f"{algo} epoch {ep + 1}: objective {obj} vs float64 "
                  f"{obj64}")
            hist.append(obj)
            if first_sgd is None:
                first_sgd = (idx, wq)
        check(hist[-1] < math.log(2.0),
              f"{algo}: objective {hist[-1]} not below ln 2 (w = 0)")

        # the same epochs through the user's entry point
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = alg.train(prob, x, y, layout, algo=algo, epochs=TRAIN_EPOCHS,
                        lr=lr, batch=batch, seed=SEED, engine="fused",
                        engine_config=EngineConfig(secure="two_tree"),
                        device=dev)
        wall = time.perf_counter() - t0
        expected += implied(steps=TRAIN_EPOCHS * steps,
                            full=TRAIN_EPOCHS if algo == "svrg"
                            else int(algo == "saga"),
                            objective=TRAIN_EPOCHS)
        same = np.array_equal(out.w, unpack(wq).cpu().numpy())
        check(_rel(torch.as_tensor(out.w, device=dev), unpack(wq).double())
              <= 1e-6, f"train({algo}) differs from its epochs")
        check(all(abs(h["objective"] - o) <= 1e-6 * abs(o)
                  for h, o in zip(out.history, hist)),
              f"train({algo}) objectives {out.history} vs {hist}")
        res["train"][algo] = dict(
            seconds=wall, samples_per_s=TRAIN_EPOCHS * steps * batch / wall,
            objectives=[h["objective"] for h in out.history],
            bit_equal_to_epochs=same)
        log_(f"train({algo}, engine='fused', 2 epochs): {res['train'][algo]}")
    del eng

    # off and ring: one SGD epoch on the first schedule, from w = 0
    idx0, w_tt = first_sgd
    for secure in ("off", "ring"):
        e2 = FusedEngine(prob, x, y, layout, EngineConfig(secure=secure),
                         device=dev)
        with no_host_sync(torch):
            w2 = e2.sgd_epoch(e2.pack_w(torch.zeros(d, device=dev)), lr,
                              idx0, (SEED, 0))
        expected += implied(steps=steps)
        rel = _rel(unpack(w2), unpack(w_tt).double())
        res["secure_modes"][secure] = dict(rel_vs_two_tree=rel)
        check(rel <= 1e-4, f"sgd {secure} vs two_tree: {rel:.3e}")
        del e2
    log_(f"secure modes agree: {res['secure_modes']}")
    return res, expected, first_sgd


KINDS = ("multi", "pipelined", "multi_pipelined")


def pipe_phase(torch, dev, x, y, layout, first_sgd, log_):
    """Phase 8: one epoch of each of the 9 multi-dominator / pipelined
    kinds from w = 0 under ``two_tree``, each under no host sync and held
    against the port's float64 oracle on the same schedule (epoch 0's of
    ``train``: m·B rows per step for the multi-dominator kinds); pipelined
    SGD under ``off`` and ``ring`` against ``two_tree``; pipelined SGD
    against phase 7's sequential epoch on the same schedule (it must
    differ: the reads are one update old); and ``train(multi_dominator=True,
    pipelined=True)`` for one SGD epoch against the engine-driven epoch.
    Returns (record, expected launches, each SGD kind's (iterate, float64
    oracle) keyed by phase 11's delayed kind)."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core.engine import EngineConfig, FusedEngine
    from repro_torch.core.losses import logistic_l2
    n, d = x.shape
    m = layout.m
    prob, lr, batch = logistic_l2(1e-4), TRAIN_LR, TRAIN_BATCH
    steps = n // batch
    x64, y64 = x.double(), y.double()
    mask64 = torch.ones(d, dtype=torch.float64, device=dev)
    key = (SEED, 0)

    def unpack(vq):
        return torch.cat([vq[p, : hi - lo]
                          for p, (lo, hi) in enumerate(layout.bounds)])

    expected = Counter()
    res = {"epochs": [], "secure_modes": {}}
    eng = FusedEngine(prob, x, y, layout, EngineConfig(secure="two_tree"),
                      device=dev)
    zero = eng.pack_w(torch.zeros(d, device=dev))
    w64 = torch.zeros(d, dtype=torch.float64, device=dev)
    with no_host_sync(torch):
        tab0, avg0 = eng.saga_init(zero, (SEED,))
    expected += implied(full=1)
    idx = {kind: alg.epoch_indices(SEED, 0, n,
                                   (m if "multi" in kind else 1) * batch,
                                   steps, dev) for kind in KINDS}
    out, out64 = {}, {}
    for kind in KINDS:
        ix = idx[kind]
        extra = (m,) if "multi" in kind else ()
        for algo in ("sgd", "svrg", "saga"):
            fn = getattr(eng, f"{kind}_{algo}_epoch")

            def run():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with no_host_sync(torch):
                    if algo == "sgd":
                        got = (fn(zero, lr, ix, key),)
                    elif algo == "svrg":
                        muq = eng.full_gradient(zero, key)
                        got = (fn(zero, zero, muq, lr, ix, key),)
                    else:
                        got = fn(zero, tab0, avg0, lr, ix, key)
                torch.cuda.synchronize()
                return got, time.perf_counter() - t0

            # the first run captures the step's graph; the second is timed
            # and must replay the first bit for bit
            first, first_seconds = run()
            got, seconds = run()
            check(all(torch.equal(a, b) for a, b in zip(first, got)),
                  f"{kind} {algo}: a second run differs from the first")
            wq = got[0]
            out[kind, algo] = wq
            per_run = implied(full=algo == "svrg") + (
                implied(pipe_steps=steps) if "pipelined" in kind
                else implied(steps=steps))
            expected += per_run + per_run + implied(objective=1)
            obj = eng.objective(wq)
            oracle = getattr(alg, f"{kind}_{algo}_epoch")
            if algo == "sgd":
                o64 = oracle(prob, w64, x64, y64, lr, mask64, ix, *extra)
            elif algo == "svrg":
                mu64 = alg.full_gradient(prob, w64, x64, y64)
                o64 = oracle(prob, w64, w64, mu64, x64, y64, lr, mask64, ix,
                             *extra)
            else:
                o64, tab64, _ = oracle(prob, w64, tab0[0].double(),
                                       unpack(avg0).double(), x64, y64, lr,
                                       mask64, ix, *extra)
                check(_rel(got[1][0], tab64) <= 1e-4,
                      f"{kind} saga: table beyond 1e-4")
            out64[kind, algo] = o64
            rel = _rel(unpack(wq), o64)
            obj64 = float(prob.loss(x64 @ o64, y64).mean()
                          + prob.lam * prob.reg(o64).sum())
            rec = dict(kind=kind, algo=algo, seconds=seconds,
                       samples_per_s=steps * ix.shape[1] / seconds,
                       first_seconds=first_seconds,
                       rel_err_vs_f64=rel, objective=obj,
                       objective_f64=obj64,
                       objective_rel_err=abs(obj - obj64) / abs(obj64))
            res["epochs"].append(rec)
            log_(f"phase 8 {kind} {algo}: {rec}")
            check(rel <= 1e-4, f"{kind} {algo}: iterate {rel:.3e} beyond "
                  "1e-4 of the float64 oracle")
            check(rec["objective_rel_err"] <= 1e-5,
                  f"{kind} {algo}: objective {obj} vs float64 {obj64}")
            check(obj < math.log(2.0),
                  f"{kind} {algo}: objective {obj} not below ln 2 (w = 0)")

    # the pipelined iterate is genuinely stale: not phase 7's sequential
    # epoch on the same schedule (epoch 0, w = 0, two_tree), and nearer
    # the pipelined float64 oracle than the sequential one by far
    idx0, w_seq = first_sgd
    check(torch.equal(idx0, idx["pipelined"]),
          "phase 7's first SGD schedule is not epoch 0's")
    w_pipe = unpack(out["pipelined", "sgd"])
    seq64 = alg.sgd_epoch(prob, w64, x64, y64, lr, mask64, idx0)
    res["stale"] = dict(
        vs_sequential_epoch=_rel(w_pipe, unpack(w_seq).double()),
        vs_sequential_f64=_rel(w_pipe, seq64),
        vs_pipelined_f64=_rel(w_pipe, out64["pipelined", "sgd"]))
    log_(f"phase 8 pipelined vs sequential SGD: {res['stale']}")
    check(not torch.equal(w_pipe, unpack(w_seq)),
          "pipelined SGD equals the sequential epoch")
    check(res["stale"]["vs_sequential_f64"]
          > 10 * res["stale"]["vs_pipelined_f64"],
          "pipelined SGD is not nearer its own oracle than the sequential "
          "one")
    # phase 11's τ = 0 iterates and oracles: each SGD kind's fresh epoch
    fresh = {"delayed": (w_seq, seq64)}
    for kind in KINDS:
        fresh[f"{kind}_delayed"] = (out[kind, "sgd"], out64[kind, "sgd"])
    del eng

    for secure in ("off", "ring"):
        e2 = FusedEngine(prob, x, y, layout, EngineConfig(secure=secure),
                         device=dev)
        with no_host_sync(torch):
            w2 = e2.pipelined_sgd_epoch(zero, lr, idx["pipelined"], key)
        expected += implied(pipe_steps=steps)
        rel = _rel(unpack(w2), unpack(out["pipelined", "sgd"]).double())
        res["secure_modes"][secure] = dict(rel_vs_two_tree=rel)
        check(rel <= 1e-4, f"pipelined sgd {secure} vs two_tree: {rel:.3e}")
        del e2
    log_(f"phase 8 secure modes agree: {res['secure_modes']}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = alg.train(prob, x, y, layout, algo="sgd", epochs=1, lr=lr,
                   batch=batch, seed=SEED, engine="fused",
                   engine_config=EngineConfig(secure="two_tree"),
                   multi_dominator=True, pipelined=True, device=dev)
    wall = time.perf_counter() - t0
    expected += implied(pipe_steps=steps, objective=1)
    want = unpack(out["multi_pipelined", "sgd"]).cpu().numpy()
    res["train"] = dict(seconds=wall,
                        samples_per_s=steps * m * batch / wall,
                        bit_equal_to_epoch=bool(np.array_equal(tr.w, want)))
    check(res["train"]["bit_equal_to_epoch"],
          "train(multi_dominator, pipelined) differs from its epoch")
    log_(f"phase 8 train(sgd, multi_dominator, pipelined): {res['train']}")
    return res, expected, fresh


STALE_TAU = 4
STALE_PROFILE_STEPS = 1000
# delayed kind -> (multi-dominator, pipelined)
STALE_KINDS = {"delayed": (False, False), "multi_delayed": (True, False),
               "pipelined_delayed": (False, True),
               "multi_pipelined_delayed": (True, True)}
STALE_ORACLES = {"delayed": "delayed_sgd_epoch",
                 "multi_delayed": "delayed_multi_sgd_epoch",
                 "pipelined_delayed": "pipelined_delayed_sgd_epoch",
                 "multi_pipelined_delayed":
                 "pipelined_delayed_multi_sgd_epoch"}


def stale_phase(torch, dev, x, y, layout, first_sgd, fresh, log_):
    """Phase 11: the bounded-delay epochs at τ = 4 on phase 7's universe.
    One epoch of each of the four delayed kinds from w = 0 under
    ``two_tree`` on epoch 0's schedule, run twice (the first run captures
    the step's graph, the second is timed and must equal the first bit for
    bit), each under no host sync and held against the port's float64
    staleness oracle on the same schedule and delays; each stale iterate
    must differ from its τ = 0 iterate (``fresh``: phases 7-8's) and lie
    at least 10x nearer its own oracle than the τ = 0 oracle does.
    Delayed SGD under ``off`` and ``ring`` against ``two_tree``; a second
    delayed SGD epoch chained on the first (the ring and the step counter
    cross the epoch boundary) against the chained oracle;
    ``run_delayed_fused`` for one epoch against the engine-driven epoch;
    at τ = 0 the delayed SGD and pipelined delayed SGD epochs against
    phase 7's first SGD iterate and phase 8's pipelined SGD iterate.
    Returns (record, expected launches)."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core import staleness as st
    from repro_torch.core.engine import EngineConfig, FusedEngine
    from repro_torch.core.losses import logistic_l2
    n, d = x.shape
    m, tau = layout.m, STALE_TAU
    prob, lr, batch = logistic_l2(1e-4), TRAIN_LR, TRAIN_BATCH
    steps = n // batch
    x64, y64 = x.double(), y.double()
    mask64 = torch.ones(d, dtype=torch.float64, device=dev)
    key = (SEED, 0)

    def unpack(vq):
        return torch.cat([vq[p, : hi - lo]
                          for p, (lo, hi) in enumerate(layout.bounds)])

    def on_card(a):
        return torch.from_numpy(a).to(dev).long()

    delays = {False: on_card(st.party_delay_values(layout, tau, SEED)),
              True: on_card(st.party_dominator_delays(layout, tau, SEED))}
    coord = {False: on_card(st.party_delays(layout, d, tau, SEED)),
             True: on_card(st.dominator_delays_by_coord(layout, d, tau,
                                                        SEED))}
    idx = {multi: alg.epoch_indices(SEED, 0, n, (m if multi else 1) * batch,
                                    steps, dev) for multi in (False, True)}
    idx1 = alg.epoch_indices(SEED, 1, n, batch, steps, dev)
    check(torch.equal(first_sgd[0], idx[False]),
          "phase 7's first SGD schedule is not epoch 0's")

    expected = Counter()
    res = {"tau": tau, "delays": delays[False].tolist(),
           "dominator_delays": delays[True].tolist(), "epochs": [],
           "secure_modes": {}}
    eng = FusedEngine(prob, x, y, layout, EngineConfig(secure="two_tree"),
                      device=dev)
    zero = eng.pack_w(torch.zeros(d, device=dev))

    def ring(multi, t):
        return torch.zeros((layout.q, t + 1, eng.dp) + ((m,) if multi
                                                         else ()),
                           device=dev)

    def oracle(kind, ix, state=None):
        multi, _ = STALE_KINDS[kind]
        if state is None:
            state = st.init_multi_state(d, tau, m, dtype=torch.float64,
                                        device=dev) if multi \
                else st.init_state(d, tau, dtype=torch.float64, device=dev)
        return getattr(st, STALE_ORACLES[kind])(
            prob, state, x64, y64, lr, coord[multi], ix,
            *((m,) if multi else ()), mask=mask64)

    def rel(wq, w64):
        return _rel(unpack(wq), w64)

    out, states64 = {}, {}
    for kind, (multi, pipelined) in STALE_KINDS.items():
        fn = getattr(eng, f"{kind}_sgd_epoch")

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with no_host_sync(torch):
                got = fn(zero, ring(multi, tau), 0, delays[multi], lr,
                         idx[multi], tau, key)
            torch.cuda.synchronize()
            return got, time.perf_counter() - t0

        first, first_seconds = run()
        got, seconds = run()
        check(all(torch.equal(a, b) for a, b in zip(first, got)),
              f"{kind}: a second run differs from the first")
        check(int(got[2]) == steps, f"{kind}: counter {int(got[2])} after "
              f"{steps} steps")
        out[kind] = got
        per_run = implied(pipe_steps=steps) if pipelined \
            else implied(steps=steps)
        expected += per_run + per_run + implied(objective=1)
        obj = eng.objective(got[0])
        states64[kind] = o64 = oracle(kind, idx[multi])
        w_fresh, fresh64 = fresh[kind]
        rec = dict(kind=kind, seconds=seconds,
                   samples_per_s=steps * idx[multi].shape[1] / seconds,
                   host_us_per_step=seconds / steps * 1e6,
                   first_seconds=first_seconds,
                   rel_err_vs_f64=rel(got[0], o64.w),
                   ring_rel_err_vs_f64=max(
                       _rel(unpack(got[1][:, s]), o64.buf[s])
                       for s in range(tau + 1)),
                   vs_tau0_iterate=rel(got[0], unpack(w_fresh).double()),
                   vs_tau0_f64=rel(got[0], fresh64),
                   objective=obj)
        obj64 = float(prob.loss(x64 @ o64.w, y64).mean()
                      + prob.lam * prob.reg(o64.w).sum())
        rec["objective_rel_err"] = abs(obj - obj64) / abs(obj64)
        res["epochs"].append(rec)
        log_(f"phase 11 {kind} (tau={tau}): {rec}")
        check(rec["rel_err_vs_f64"] <= 1e-4, f"{kind}: iterate "
              f"{rec['rel_err_vs_f64']:.3e} beyond 1e-4 of the float64 "
              "staleness oracle")
        check(rec["ring_rel_err_vs_f64"] <= 1e-4, f"{kind}: ring beyond "
              "1e-4 of the float64 oracle's")
        check(rec["objective_rel_err"] <= 1e-5,
              f"{kind}: objective {obj} vs float64 {obj64}")
        check(not torch.equal(got[0], w_fresh),
              f"{kind}: the tau={tau} iterate equals the tau=0 one")
        check(rec["vs_tau0_f64"] > 10 * rec["rel_err_vs_f64"],
              f"{kind}: not 10x nearer its own oracle than the tau=0 one")

    # the masks are lossless: off and ring agree with two_tree
    w_tt = out["delayed"][0]
    for secure in ("off", "ring"):
        e2 = FusedEngine(prob, x, y, layout, EngineConfig(secure=secure),
                         device=dev)
        with no_host_sync(torch):
            w2, _, _ = e2.delayed_sgd_epoch(zero, ring(False, tau), 0,
                                            delays[False], lr, idx[False],
                                            tau, key)
        expected += implied(steps=steps)
        r = _rel(unpack(w2), unpack(w_tt).double())
        res["secure_modes"][secure] = dict(rel_vs_two_tree=r)
        check(r <= 1e-4, f"delayed sgd {secure} vs two_tree: {r:.3e}")
        del e2
    log_(f"phase 11 secure modes agree: {res['secure_modes']}")

    # a second epoch: the ring and the counter cross the epoch boundary
    with no_host_sync(torch):
        wq2, _, t2 = eng.delayed_sgd_epoch(*out["delayed"][:3],
                                           delays[False], lr, idx1, tau,
                                           (SEED, 1))
    expected += implied(steps=steps)
    chain64 = oracle("delayed", idx1, states64["delayed"])
    res["chained"] = dict(rel_err_vs_f64=rel(wq2, chain64.w),
                          counter=int(t2))
    log_(f"phase 11 chained second epoch: {res['chained']}")
    check(res["chained"]["rel_err_vs_f64"] <= 1e-4,
          "chained delayed epoch beyond 1e-4 of the float64 oracle")
    check(int(t2) == int(chain64.t) == 2 * steps,
          f"chained counter {int(t2)} != {2 * steps}")

    # the user's entry point gives the engine-driven epoch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w_run = st.run_delayed_fused(prob, x, y, layout, tau, 1, lr, batch,
                                 seed=SEED, engine_config=EngineConfig(
                                     secure="two_tree"), device=dev)
    wall = time.perf_counter() - t0
    expected += implied(steps=steps)
    res["runner"] = dict(seconds=wall,
                         bit_equal_to_epoch=bool(np.array_equal(
                             w_run, unpack(w_tt).cpu().numpy())))
    log_(f"phase 11 run_delayed_fused: {res['runner']}")
    check(res["runner"]["bit_equal_to_epoch"],
          "run_delayed_fused differs from its epoch")

    # τ = 0: the ring hands each step its own gradient back
    res["tau0"] = {}
    for kind, pipelined in (("delayed", False), ("pipelined_delayed", True)):
        with no_host_sync(torch):
            w0, _, _ = getattr(eng, f"{kind}_sgd_epoch")(
                zero, ring(False, 0), 0, torch.zeros_like(delays[False]),
                lr, idx[False], 0, key)
        expected += implied(pipe_steps=steps) if pipelined \
            else implied(steps=steps)
        w_fresh = fresh[kind][0]
        res["tau0"][kind] = dict(rel_vs_fresh=rel(w0, unpack(w_fresh)
                                                  .double()),
                                 bit_equal=bool(torch.equal(w0, w_fresh)))
        check(res["tau0"][kind]["rel_vs_fresh"] <= 1e-6,
              f"{kind} at tau=0 differs from the fresh epoch")
    log_(f"phase 11 tau=0 against the fresh epochs: {res['tau0']}")

    # where a delayed step's time goes: a profiler window over the first
    # STALE_PROFILE_STEPS rows of the schedule (the profiler takes about
    # 40 s to read a whole epoch's window)
    ix = idx[False][:STALE_PROFILE_STEPS]
    res["profile_delayed"] = epoch_profile(
        torch, lambda: eng.delayed_sgd_epoch(zero, ring(False, tau), 0,
                                             delays[False], lr, ix, tau,
                                             key), ix.shape[0])
    for _ in range(3):
        expected += implied(steps=ix.shape[0])
    log_(f"phase 11 profile of {ix.shape[0]} delayed SGD steps: "
         f"{res['profile_delayed']}")
    del eng
    return res, expected


DEEP_PREFIX = 250                # steps of the oracle and profiler runs
# deep kind -> (multi-dominator, pipelined)
DEEP_KINDS = {"fresh": (False, False), "multi": (True, False),
              "pipelined": (False, True), "multi_pipelined": (True, True)}


def deep_implied(steps=0, svrg_steps=0, full=0, objective=0, pipe_steps=0):
    """Launches per kernel program implied by ``steps`` fresh deep SGD
    steps (layer 1's and layer 2's wide forward, hᵀϑ_z and xᵀ∂u on the
    rows program), ``svrg_steps`` fresh deep SVRG steps (3 and 3: the
    iterate and the snapshot share layer 1's forward and backward),
    ``full`` ``deep_full_gradient`` passes (two wide forwards and two
    backwards over all n rows, each with its reduce), ``objective``
    ``deep_objective`` evaluations (two wide forwards) and one pipelined
    epoch of ``pipe_steps`` steps (a layer-1 forward prologue, one
    split-batch launch per interior step, a backward epilogue).  The
    delayed kinds of phase 13 launch as their fresh forms do: a fresh or
    multi delayed step 2 and 2 (the multi one's backwards over the
    per-dominator block-diagonal columns), a pipelined or multi pipelined
    delayed epoch one forward, one split launch per interior step (multi:
    Mw = hidden beside Mθ = m·hidden) and one backward."""
    pipe = int(pipe_steps > 0)
    return Counter(
        vfl_forward_wide=2 * steps + 3 * svrg_steps + 2 * full
        + 2 * objective + pipe,
        vfl_backward_rows=2 * steps + 3 * svrg_steps + 2 * full + pipe,
        vfl_backward_reduce=2 * full,
        vfl_fused_split=max(pipe_steps - 1, 0))


def _deep_method(kind, algo):
    multi, pipelined = DEEP_KINDS[kind]
    return "deep_" + ("multi_" if multi else "") \
        + ("pipelined_" if pipelined else "") + f"{algo}_epoch"


def deep_train_phase(torch, dev, x, y, layout, log_):
    """Phase 12: deep training on phase 7's resident data.  One full epoch
    of each of the 8 deep kinds ({SGD, SVRG} × {fresh, multi, pipelined,
    multi pipelined}) from the port's ``initial_params(SEED)`` under
    ``two_tree``, run twice (the first run captures, the second is timed
    and must equal the first bit for bit), each under no host sync; each
    kind's first ``DEEP_PREFIX`` steps (their own loop shape) against the
    port's float64 oracle on the same schedule (every leaf within 1e-4
    relative, the objective within 1e-5); ``off`` and ``ring`` deep SGD
    against ``two_tree``; pipelined SGD against the sequential one (it
    must differ and lie 10× nearer its own oracle); ``train(deep=True,
    engine="fused")`` for one SGD epoch against the engine-driven epoch,
    bit for bit; ``deep_full_gradient``'s time beside its bytes bound;
    profiler windows over ``DEEP_PREFIX`` deep SGD and pipelined SGD
    steps.  Returns (record, expected launches, each kind's SGD epoch and
    float64 prefix oracle, for phase 13)."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core import deep_vfl
    from repro_torch.core.engine import EngineConfig, FusedEngine
    from repro_torch.core.losses import logistic_l2
    n, d = x.shape
    m = layout.m
    prob, lr, batch = logistic_l2(1e-4), TRAIN_LR, TRAIN_BATCH
    steps = n // batch
    key = (SEED, 0)
    x64, y64 = x.double(), y.double()
    expected = Counter()
    res = {"hidden": DEEP_HIDDEN, "d_rep": DEEP_DREP, "lr": lr, "epochs": [],
           "secure_modes": {}}
    eng = FusedEngine(prob, x, y, layout, EngineConfig(secure="two_tree"),
                      device=dev)
    p0 = deep_vfl.initial_params(SEED, layout, d, DEEP_HIDDEN, DEEP_DREP)
    pq0 = eng.pack_deep(p0)
    res["objective_start"] = obj0 = eng.deep_objective(pq0)
    expected += deep_implied(objective=1)
    log_(f"phase 12 objective at the start: {obj0}")
    idx = {multi: alg.epoch_indices(SEED, 0, n, (m if multi else 1) * batch,
                                    steps, dev) for multi in (False, True)}

    def leaves(params):
        return [*params.enc_w1, *params.enc_b1, *params.enc_w2, params.head]

    def rel_leaves(pq, params64):
        return max(_rel(a, b) for a, b in zip(leaves(eng.unpack_deep(pq)),
                                              leaves(params64)))

    def run(fn, algo, ix):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with no_host_sync(torch):
            if algo == "sgd":
                got = fn(pq0, lr, ix, key)
            else:
                got = fn(pq0, pq0, eng.deep_full_gradient(pq0, key), lr, ix,
                         key)
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0

    def launches(algo, pipelined, s):
        per = deep_implied(full=algo == "svrg")
        if pipelined:
            return per + deep_implied(pipe_steps=s)
        return per + deep_implied(**{"steps" if algo == "sgd"
                                     else "svrg_steps": s})

    out, pre, out64 = {}, {}, {}
    for kind, (multi, pipelined) in DEEP_KINDS.items():
        ix = idx[multi]
        for algo in ("sgd", "svrg"):
            fn = getattr(eng, _deep_method(kind, algo))
            first, first_seconds = run(fn, algo, ix)
            got, seconds = run(fn, algo, ix)
            check(all(torch.equal(a, b) for a, b in zip(first, got)),
                  f"deep {kind} {algo}: a second run differs from the first")
            check(all(bool(torch.isfinite(a).all()) for a in got),
                  f"deep {kind} {algo}: non-finite parameters")
            out[kind, algo] = got
            obj = eng.deep_objective(got)
            # the oracle comparison over the schedule's first DEEP_PREFIX
            # rows (their own loop shape)
            pre[kind, algo], _ = run(fn, algo, ix[:DEEP_PREFIX])
            expected += launches(algo, pipelined, steps) \
                + launches(algo, pipelined, steps) \
                + launches(algo, pipelined, DEEP_PREFIX) \
                + deep_implied(objective=2)
            o64, hist64 = deep_vfl.train_deep_vfl(
                prob, x64, y64, layout, epochs=1, lr=lr, batch=batch,
                params=p0, algo=algo, multi_dominator=multi,
                pipelined=pipelined, indices=[ix[:DEEP_PREFIX]], device=dev)
            out64[kind, algo] = o64
            pre_obj = eng.deep_objective(pre[kind, algo])
            rec = dict(kind=kind, algo=algo, seconds=seconds,
                       samples_per_s=steps * ix.shape[1] / seconds,
                       host_us_per_step=seconds / steps * 1e6,
                       first_seconds=first_seconds, objective=obj,
                       prefix_rel_err_vs_f64=rel_leaves(pre[kind, algo],
                                                        o64),
                       prefix_objective=pre_obj,
                       prefix_objective_f64=hist64[0],
                       prefix_objective_rel_err=abs(pre_obj - hist64[0])
                       / abs(hist64[0]))
            res["epochs"].append(rec)
            log_(f"phase 12 {kind} {algo}: {rec}")
            check(rec["prefix_rel_err_vs_f64"] <= 1e-4,
                  f"deep {kind} {algo}: a leaf "
                  f"{rec['prefix_rel_err_vs_f64']:.3e} beyond 1e-4 of the "
                  "float64 oracle")
            check(rec["prefix_objective_rel_err"] <= 1e-5,
                  f"deep {kind} {algo}: objective {pre_obj} vs float64 "
                  f"{hist64[0]}")
            check(obj < obj0, f"deep {kind} {algo}: objective {obj} not "
                  f"below the start's {obj0}")

    # the pipelined iterate is genuinely stale: not the sequential one, and
    # far nearer its own float64 oracle than the sequential oracle
    w_pipe = pre["pipelined", "sgd"]
    res["stale"] = dict(
        vs_sequential_f64=rel_leaves(w_pipe, out64["fresh", "sgd"]),
        vs_pipelined_f64=rel_leaves(w_pipe, out64["pipelined", "sgd"]))
    log_(f"phase 12 pipelined vs sequential SGD: {res['stale']}")
    check(not all(torch.equal(a, b)
                  for a, b in zip(w_pipe, pre["fresh", "sgd"])),
          "deep pipelined SGD equals the sequential epoch")
    check(res["stale"]["vs_sequential_f64"]
          > 10 * res["stale"]["vs_pipelined_f64"],
          "deep pipelined SGD is not 10x nearer its own oracle than the "
          "sequential one")

    # the masks are lossless: off and ring agree with two_tree
    want = leaves(eng.unpack_deep(out["fresh", "sgd"]))
    for secure in ("off", "ring"):
        e2 = FusedEngine(prob, x, y, layout, EngineConfig(secure=secure),
                         device=dev)
        with no_host_sync(torch):
            got = e2.deep_sgd_epoch(pq0, lr, idx[False], key)
        expected += deep_implied(steps=steps)
        r = max(_rel(a, b.double())
                for a, b in zip(leaves(e2.unpack_deep(got)), want))
        res["secure_modes"][secure] = dict(rel_vs_two_tree=r)
        check(r <= 1e-4, f"deep sgd {secure} vs two_tree: {r:.3e}")
        del e2
    log_(f"phase 12 secure modes agree: {res['secure_modes']}")

    # the user's entry point gives the engine-driven epoch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = alg.train(prob, x, y, layout, algo="sgd", epochs=1, lr=lr,
                   batch=batch, seed=SEED, engine="fused",
                   engine_config=EngineConfig(secure="two_tree"), deep=True,
                   hidden=DEEP_HIDDEN, d_rep=DEEP_DREP, device=dev)
    wall = time.perf_counter() - t0
    expected += deep_implied(steps=steps, objective=1)
    res["train"] = dict(seconds=wall, samples_per_s=steps * batch / wall,
                        bit_equal_to_epoch=all(
                            torch.equal(a, b) for a, b in
                            zip(leaves(tr.params), want)))
    log_(f"phase 12 train(deep=True, sgd): {res['train']}")
    check(res["train"]["bit_equal_to_epoch"],
          "train(deep=True) differs from its epoch")

    # deep SVRG's μ: the full-dataset passes, beside the bytes bound of
    # reading X twice (the aggregation sits between the two reads)
    eng.deep_full_gradient(pq0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        eng.deep_full_gradient(pq0)
    end.record()
    end.synchronize()
    expected += deep_implied(full=11)
    xbytes = eng.xs.numel() * eng.xs.element_size()
    res["full_gradient"] = dict(
        ms=start.elapsed_time(end) / 10,
        bound_ms=2 * xbytes / HBM_BYTES_PER_S * 1e3)
    log_(f"phase 12 deep_full_gradient: {res['full_gradient']}")

    # where a deep step's time goes: profiler windows over DEEP_PREFIX
    # steps (never whole epochs: reading a window takes ~4 ms a step)
    for kind in ("fresh", "pipelined"):
        fn = getattr(eng, _deep_method(kind, "sgd"))
        ix = idx[False][:DEEP_PREFIX]
        res[f"profile_{kind}_sgd"] = epoch_profile(
            torch, lambda: fn(pq0, lr, ix, key), DEEP_PREFIX)
        for _ in range(3):
            expected += launches("sgd", kind == "pipelined", DEEP_PREFIX)
        log_(f"phase 12 profile of {DEEP_PREFIX} deep {kind} SGD steps: "
             f"{res[f'profile_{kind}_sgd']}")
    del eng
    return res, expected, {kind: (out[kind, "sgd"], out64[kind, "sgd"])
                           for kind in DEEP_KINDS}


# deep delayed kind -> the deep kind whose τ = 0 form it is
DEEP_STALE_FRESH = {"delayed": "fresh", "multi_delayed": "multi",
                    "pipelined_delayed": "pipelined",
                    "multi_pipelined_delayed": "multi_pipelined"}


def deep_stale_phase(torch, dev, x, y, layout, fresh, log_):
    """Phase 13: the bounded-delay deep epochs at τ = 4 on phase 12's
    universe.  One full epoch of each of the 4 deep delayed kinds from
    ``initial_params(SEED)`` under ``two_tree``, run twice (the second
    timed and equal to the first bit for bit), each under no host sync,
    finite and below its start's objective; each kind's first
    ``DEEP_PREFIX`` steps against the port's float64 staleness oracle on
    the same schedule and delays (every leaf and every ring slot within
    1e-4 relative, the objective within 1e-5), and ≥ 10× nearer it than
    phase 12's float64 τ = 0 oracle; each full τ = 4 epoch differs from
    phase 12's fresh one (``fresh``), and at τ = 0 lies within 1e-6 of
    it.  Deep delayed SGD under ``off`` and ``ring`` against
    ``two_tree``; a second full epoch chained on the first (the counter
    reaches 2 × steps) and a chained prefix against the chained oracle;
    ``run_deep_delayed_fused`` and ``run_deep_multi_delayed_fused
    (pipelined=True)`` bit-equal to their epochs; profiler windows over
    ``DEEP_PREFIX`` delayed and multi delayed steps.  Returns (record,
    expected launches)."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core import deep_vfl
    from repro_torch.core import staleness as st
    from repro_torch.core.engine import EngineConfig, FusedEngine
    from repro_torch.core.losses import logistic_l2
    n, d = x.shape
    m, tau = layout.m, STALE_TAU
    prob, lr, batch = logistic_l2(1e-4), TRAIN_LR, TRAIN_BATCH
    steps, pre = n // batch, DEEP_PREFIX
    key = (SEED, 0)
    x64, y64 = x.double(), y.double()
    expected = Counter()
    res = {"tau": tau, "epochs": [], "secure_modes": {}, "tau0": {}}
    eng = FusedEngine(prob, x, y, layout, EngineConfig(secure="two_tree"),
                      device=dev)
    p0 = deep_vfl.initial_params(SEED, layout, d, DEEP_HIDDEN, DEEP_DREP)
    pq0 = eng.pack_deep(p0)
    res["objective_start"] = obj0 = eng.deep_objective(pq0)
    expected += deep_implied(objective=1)
    delays = {False: torch.from_numpy(st.party_delay_values(
                  layout, tau, SEED)).to(dev).long(),
              True: torch.from_numpy(st.party_dominator_delays(
                  layout, tau, SEED)).to(dev).long()}
    idx = {multi: alg.epoch_indices(SEED, 0, n, (m if multi else 1) * batch,
                                    steps, dev) for multi in (False, True)}
    idx1 = alg.epoch_indices(SEED, 1, n, batch, steps, dev)

    def leaves(params):
        return [*params.enc_w1, *params.enc_b1, *params.enc_w2, params.head]

    def rel_leaves(pq, params64):
        return max(_rel(a, b) for a, b in zip(leaves(eng.unpack_deep(pq)),
                                              leaves(params64)))

    def rel_rings(bufq, rings64, multi):
        """The engine's rings (q, τ+1, ...) against the oracle's per-party
        rings (τ+1[, m], ...), slot by slot, w1's padding dropped."""
        worst = 0.0
        for i, (ring, per_party) in enumerate(zip(bufq, rings64)):
            for s in range(ring.shape[1]):
                got, want = [], []
                for p, r64 in enumerate(per_party):
                    g = ring[p, s]
                    if i == 0:                  # w1: d_p of the dp rows
                        g = g[: r64.shape[-2]]
                    got.append((g.movedim(-2, 0) if multi else g).flatten())
                    want.append(r64[s].flatten())
                worst = max(worst, _rel(torch.cat(got), torch.cat(want)))
        return worst

    def launches(pipelined, s):
        return deep_implied(pipe_steps=s) if pipelined \
            else deep_implied(steps=s)

    def buffers(multi, t):
        return (eng.deep_multi_delay_buffers if multi
                else eng.deep_delay_buffers)(pq0, t)

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with no_host_sync(torch):
            got = fn(*args)
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0

    out, pres, states64 = {}, {}, {}
    for kind, (multi, pipelined) in STALE_KINDS.items():
        fn = getattr(eng, f"deep_{kind}_sgd_epoch")
        ix = idx[multi]

        def run(ix, t=tau, dl=delays[multi]):
            return timed(lambda: fn(pq0, buffers(multi, t), 0, dl, lr, ix, t,
                                    key))

        first, first_seconds = run(ix)
        got, seconds = run(ix)
        check(all(torch.equal(a, b) for a, b in
                  zip(first[0] + first[1], got[0] + got[1])),
              f"deep {kind}: a second run differs from the first")
        check(all(bool(torch.isfinite(a).all()) for a in got[0]),
              f"deep {kind}: non-finite parameters")
        check(int(got[2]) == steps, f"deep {kind}: counter {int(got[2])} "
              f"after {steps} steps")
        out[kind] = got
        obj = eng.deep_objective(got[0])
        pres[kind], _ = run(ix[:pre])
        (w0, _, _), _ = run(ix, 0, torch.zeros_like(delays[multi]))
        for s in (steps, steps, steps, pre):   # 2 runs, τ = 0, the prefix
            expected += launches(pipelined, s)
        expected += deep_implied(objective=2)
        train64 = st.train_deep_multi_delayed if multi \
            else st.train_deep_delayed
        o64, hist64 = train64(prob, x64, y64, layout, tau, epochs=1, lr=lr,
                              batch=batch, seed=SEED, hidden=DEEP_HIDDEN,
                              d_rep=DEEP_DREP, pipelined=pipelined,
                              params=p0, indices=[ix[:pre]], device=dev)
        states64[kind] = o64
        pre_obj = eng.deep_objective(pres[kind][0])
        w_fresh, fresh64 = fresh[DEEP_STALE_FRESH[kind]]
        rec = dict(kind=kind, seconds=seconds,
                   samples_per_s=steps * ix.shape[1] / seconds,
                   host_us_per_step=seconds / steps * 1e6,
                   first_seconds=first_seconds, objective=obj,
                   prefix_rel_err_vs_f64=rel_leaves(pres[kind][0],
                                                    o64.params),
                   prefix_ring_rel_err_vs_f64=rel_rings(pres[kind][1],
                                                        o64.rings, multi),
                   prefix_vs_tau0_f64=rel_leaves(pres[kind][0], fresh64),
                   prefix_objective=pre_obj, prefix_objective_f64=hist64[0],
                   prefix_objective_rel_err=abs(pre_obj - hist64[0])
                   / abs(hist64[0]),
                   tau0_rel_vs_fresh=max(_rel(a, b.double()) for a, b in
                                         zip(w0, w_fresh)),
                   tau0_bit_equal=all(torch.equal(a, b)
                                      for a, b in zip(w0, w_fresh)))
        res["epochs"].append(rec)
        log_(f"phase 13 {kind} (tau={tau}): {rec}")
        check(rec["prefix_rel_err_vs_f64"] <= 1e-4,
              f"deep {kind}: a leaf {rec['prefix_rel_err_vs_f64']:.3e} "
              "beyond 1e-4 of the float64 staleness oracle")
        check(rec["prefix_ring_rel_err_vs_f64"] <= 1e-4,
              f"deep {kind}: a ring slot "
              f"{rec['prefix_ring_rel_err_vs_f64']:.3e} beyond 1e-4 of the "
              "float64 oracle's")
        check(rec["prefix_objective_rel_err"] <= 1e-5,
              f"deep {kind}: objective {pre_obj} vs float64 {hist64[0]}")
        check(obj < obj0, f"deep {kind}: objective {obj} not below the "
              f"start's {obj0}")
        check(not all(torch.equal(a, b) for a, b in zip(got[0], w_fresh)),
              f"deep {kind}: the tau={tau} epoch equals the tau=0 one")
        check(rec["prefix_vs_tau0_f64"] > 10 * rec["prefix_rel_err_vs_f64"],
              f"deep {kind}: not 10x nearer its own oracle than the tau=0 "
              "one")
        check(rec["tau0_rel_vs_fresh"] <= 1e-6,
              f"deep {kind} at tau=0: {rec['tau0_rel_vs_fresh']:.3e} from "
              "phase 12's fresh epoch")

    # the masks are lossless: off and ring agree with two_tree
    want = leaves(eng.unpack_deep(out["delayed"][0]))
    for secure in ("off", "ring"):
        e2 = FusedEngine(prob, x, y, layout, EngineConfig(secure=secure),
                         device=dev)
        with no_host_sync(torch):
            got, _, _ = e2.deep_delayed_sgd_epoch(
                pq0, buffers(False, tau), 0, delays[False], lr, idx[False],
                tau, key)
        expected += deep_implied(steps=steps)
        r = max(_rel(a, b.double())
                for a, b in zip(leaves(e2.unpack_deep(got)), want))
        res["secure_modes"][secure] = dict(rel_vs_two_tree=r)
        check(r <= 1e-4, f"deep delayed sgd {secure} vs two_tree: {r:.3e}")
        del e2
    log_(f"phase 13 secure modes agree: {res['secure_modes']}")

    # a second epoch: the rings and the counter cross the epoch boundary,
    # over the full epoch and over the prefix against the chained oracle
    chain = eng.deep_delayed_sgd_epoch
    (_, _, t2), chain_seconds = timed(chain, *out["delayed"], delays[False],
                                      lr, idx1, tau, (SEED, 1))
    (pq2, _, tp2), _ = timed(chain, *pres["delayed"], delays[False], lr,
                             idx1[:pre], tau, (SEED, 1))
    expected += deep_implied(steps=steps + pre)
    chain64, _ = st.train_deep_delayed(
        prob, x64, y64, layout, tau, epochs=2, lr=lr, batch=batch,
        seed=SEED, hidden=DEEP_HIDDEN, d_rep=DEEP_DREP, params=p0,
        indices=[idx[False][:pre], idx1[:pre]], device=dev)
    res["chained"] = dict(counter=int(t2), seconds=chain_seconds,
                          prefix_rel_err_vs_f64=rel_leaves(pq2,
                                                           chain64.params),
                          prefix_counter=int(tp2))
    log_(f"phase 13 chained second epoch: {res['chained']}")
    check(int(t2) == 2 * steps, f"chained counter {int(t2)} != {2 * steps}")
    check(int(tp2) == int(chain64.t) == 2 * pre,
          f"chained prefix counter {int(tp2)} != {2 * pre}")
    check(res["chained"]["prefix_rel_err_vs_f64"] <= 1e-4,
          "chained deep delayed prefix beyond 1e-4 of the float64 oracle")

    # the user's entry points give the engine-driven epochs
    res["runners"] = {}
    for kind, run in (("delayed", st.run_deep_delayed_fused),
                      ("multi_pipelined_delayed",
                       st.run_deep_multi_delayed_fused)):
        pipelined = STALE_KINDS[kind][1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run(prob, x, y, layout, tau, 1, lr, batch, seed=SEED,
                  hidden=DEEP_HIDDEN, d_rep=DEEP_DREP,
                  engine_config=EngineConfig(secure="two_tree"),
                  pipelined=pipelined, device=dev)
        wall = time.perf_counter() - t0
        expected += launches(pipelined, steps)
        res["runners"][kind] = dict(
            seconds=wall, bit_equal_to_epoch=all(
                torch.equal(a, b) for a, b in
                zip(leaves(got), leaves(eng.unpack_deep(out[kind][0])))))
        check(res["runners"][kind]["bit_equal_to_epoch"],
              f"run_deep_*_fused ({kind}) differs from its epoch")
    log_(f"phase 13 runners: {res['runners']}")

    # where a deep delayed step's time goes: profiler windows over
    # DEEP_PREFIX steps (never whole epochs)
    for kind in ("delayed", "multi_delayed"):
        multi = STALE_KINDS[kind][0]
        fn = getattr(eng, f"deep_{kind}_sgd_epoch")
        ix = idx[multi][:pre]
        res[f"profile_{kind}"] = epoch_profile(
            torch, lambda: fn(pq0, buffers(multi, tau), 0, delays[multi], lr,
                              ix, tau, key), pre)
        expected += deep_implied(steps=3 * pre)
        log_(f"phase 13 profile of {pre} deep {kind} SGD steps: "
             f"{res[f'profile_{kind}']}")
    del eng
    return res, expected


FAULT_PREFIX = 250               # steps of the oracle and profiler runs
FAULT_ALGOS = ("sgd", "svrg", "saga")
FAULT_P_CORRUPT = 0.002          # a NaN or Inf partial per party and step
# ridge SGD on phase 7's data diverges at lr = 0.1 and at 0.01 and holds at
# 0.001, so the supervisor's tenfold backoff heals it in two rollbacks
FAULT_DIVERGENT_LR = 0.1


def _same_bits(torch, a, b):
    """``a`` equals ``b`` bit for bit, NaN for NaN (the guarded telemetry
    holds the NaN partials' norms)."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) \
        and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))


def fault_phase(torch, dev, x, y, layout, log_):
    """Phase 14: the faulted and guarded linear epochs (``core.faults``
    semantics) at τ = 4 on phase 7's universe, under phase 11's seed-0
    delays, with checkpoints and the supervisor.  (a) One full faulted
    epoch each of SGD, SVRG and SAGA from w = 0 under ``two_tree`` on a
    ``random_trace`` of the epoch's steps (crash, rejoin, straggle,
    dropped broadcast), run twice (the second timed and equal to the first
    bit for bit); each kind's first ``FAULT_PREFIX`` steps against the
    port's float64 faulted oracle (iterate and ring slots within 1e-4
    relative); faulted SGD under ``off`` and ``ring`` against
    ``two_tree``.  (b) One full guarded epoch each on the same trace with
    NaN and Inf corruptions added: under ``guard=True`` finite iterates
    and no poisoned step, and over the prefix the float64 guarded
    oracle's ``finite``/``alive`` (equal) and norms, iterate and ring
    (1e-4); under ``guard=False`` the prefix's iterate NaN in the
    oracle's coordinates.  (c) Every epoch runs under no host sync.  (d)
    ``run_faulted_fused`` and ``train(engine="fused", algo="saga")``
    checkpoint 1 epoch, resume to 2, and equal an uninterrupted 2-epoch
    run bit for bit (the step graphs are captured anew after the resume).
    (e) ``train(supervise=True)`` on ridge at a divergent learning rate
    ends finite after at least one heal.  (f) Profiler windows over
    ``FAULT_PREFIX`` faulted, guarded and (phase 11's) delayed SGD steps.
    Returns (record, expected launches)."""
    import tempfile

    from repro_torch.core import algorithms as alg
    from repro_torch.core import faults
    from repro_torch.core import staleness as st
    from repro_torch.core.engine import EngineConfig, FusedEngine
    from repro_torch.core.losses import logistic_l2, ridge
    from repro_torch.core.supervisor import SupervisorConfig, poisoned_steps
    n, d = x.shape
    tau, pre = STALE_TAU, FAULT_PREFIX
    prob, lr, batch = logistic_l2(1e-4), TRAIN_LR, TRAIN_BATCH
    steps = n // batch
    x64, y64 = x.double(), y.double()
    mask64 = torch.ones(d, dtype=torch.float64, device=dev)
    own64 = faults._ownership(layout, d, dev, torch.float64)
    key = (SEED, 0)
    delays_q = st.party_delay_values(layout, tau, SEED)
    traces = {"faulted": faults.random_trace(layout, steps, seed=SEED),
              "guarded": faults.random_trace(layout, steps, seed=SEED,
                                             p_corrupt=FAULT_P_CORRUPT,
                                             corrupt_modes=("nan", "inf"))}
    scheds = {k: tr.compile(layout.m) for k, tr in traces.items()}
    for sched in scheds.values():
        faults._check_delay_budget(delays_q, sched, tau)
    dcoord = delays_q[layout.party_of_coord(d)]
    delays = torch.from_numpy(delays_q).to(dev).long()
    idx = alg.epoch_indices(SEED, 0, n, batch, steps, dev)

    def unpack(vq):
        return torch.cat([vq[p, : hi - lo]
                          for p, (lo, hi) in enumerate(layout.bounds)])

    def rows(kind, k=steps):
        win = scheds[kind].epoch(0, steps)
        out = [torch.from_numpy(a[:, :k].copy()).to(dev)
               for a in win.party_rows()]
        if kind == "guarded":
            out.append(torch.from_numpy(win.corrupt_rows()[:, :k].copy())
                       .to(dev))
        return out

    expected = Counter()
    res = {"tau": tau, "delays": delays_q.tolist(), "epochs": [],
           "prefix": [], "secure_modes": {},
           "events": {k: Counter(e.kind for e in tr.events)
                      for k, tr in traces.items()}}
    log_(f"phase 14 traces: {res['events']}")
    eng = FusedEngine(prob, x, y, layout, EngineConfig(secure="two_tree"),
                      device=dev)
    zero = eng.pack_w(torch.zeros(d, device=dev))
    muq = eng.full_gradient(zero, key)
    tabq, avgq = eng.saga_init(zero, key)
    expected += implied(full=2)
    w64 = torch.zeros(d, dtype=torch.float64, device=dev)
    mu64 = alg.full_gradient(prob, w64, x64, y64)
    tab64, avg64 = alg.saga_init(prob, w64, x64, y64)
    head = {"sgd": (zero,), "svrg": (zero, zero, muq),
            "saga": (zero, tabq, avgq)}
    head64 = {"sgd": (w64,), "svrg": (w64, w64, mu64),
              "saga": (w64, tab64, avg64)}

    def ring(t=tau):
        return torch.zeros((layout.q, t + 1, eng.dp), device=dev)

    def epoch(e, kind, algo, chans, ix, guard=True, sync_check=True):
        kw = {} if kind == "faulted" else {"guard": guard}
        with no_host_sync(torch) if sync_check else contextlib.nullcontext():
            return getattr(e, f"{kind}_{algo}_epoch")(
                *head[algo], ring(), 0, delays, *chans, lr, ix, tau, key,
                **kw)

    def oracle(kind, algo, k, guard=True):
        win = scheds[kind].epoch(0, steps)
        fc, bc, ec = (a[:k] for a in win.coord_rows(layout, d))
        common = (torch.zeros((tau + 1, d), dtype=torch.float64,
                              device=dev), 0, x64, y64, lr, mask64, dcoord)
        fn = getattr(faults, f"{kind}_{algo}_epoch")
        if kind == "faulted":
            return fn(prob, *head64[algo], *common, idx[:k], fc, bc, ec)
        return fn(prob, *head64[algo], *common, own64, idx[:k],
                  win.fwd[:k], bc, ec, win.codes()[:k], guard=guard)

    def ring_rel(bufq, buf64):
        return max(_rel(unpack(bufq[:, s]), buf64[s])
                   for s in range(tau + 1))

    full = {}
    for kind in ("faulted", "guarded"):
        chans, chans_pre = rows(kind), rows(kind, pre)
        for algo in FAULT_ALGOS:
            def run():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = epoch(eng, kind, algo, chans, idx)
                torch.cuda.synchronize()
                return got, time.perf_counter() - t0

            first, first_seconds = run()
            got, seconds = run()
            flat = [a for a in got if isinstance(a, torch.Tensor)]
            flat0 = [a for a in first if isinstance(a, torch.Tensor)]
            if kind == "guarded":
                flat += list(got[-1])
                flat0 += list(first[-1])
            check(all(_same_bits(torch, a, b) for a, b in zip(flat0, flat)),
                  f"{kind} {algo}: a second run differs from the first")
            n_state = 3 if algo == "saga" else 1
            check(int(got[n_state + 1]) == steps,
                  f"{kind} {algo}: counter {int(got[n_state + 1])}")
            expected += implied(steps=2 * steps, objective=1)
            full[kind, algo] = got
            rec = dict(kind=kind, algo=algo, seconds=seconds,
                       first_seconds=first_seconds,
                       samples_per_s=steps * batch / seconds,
                       host_us_per_step=seconds / steps * 1e6,
                       finite=bool(torch.isfinite(got[0]).all()),
                       objective=eng.objective(got[0]))
            if kind == "guarded":
                health = faults.HealthStats(*(a.cpu().numpy()
                                              for a in got[-1]))
                rec["quarantined"] = int((health.finite == 0).sum())
                rec["poisoned"] = int(poisoned_steps(health).sum())
                check(rec["finite"] and rec["poisoned"] == 0,
                      f"guarded {algo}: a non-finite partial got through")
                check(rec["quarantined"] > 0,
                      f"guarded {algo}: the trace corrupted nothing")
            check(np.isfinite(rec["objective"]),
                  f"{kind} {algo}: objective {rec['objective']}")
            res["epochs"].append(rec)
            log_(f"phase 14 {kind} {algo}: {rec}")

            # the prefix against the float64 oracle
            got = epoch(eng, kind, algo, chans_pre, idx[:pre])
            expected += implied(steps=pre)
            o64 = oracle(kind, algo, pre)
            prec = dict(kind=kind, algo=algo,
                        rel_err_vs_f64=_rel(unpack(got[0]), o64[0]),
                        ring_rel_err_vs_f64=ring_rel(got[n_state],
                                                     o64[n_state]))
            if kind == "guarded":
                h, h64 = got[-1], o64[-1]
                prec["finite_equal"] = bool(torch.equal(
                    h.finite, h64.finite.float()))
                prec["alive_equal"] = bool(torch.equal(
                    h.alive, h64.alive.float()))
                both = torch.isfinite(h.pnorm) & torch.isfinite(h64.pnorm)
                prec["pnorm_pattern_equal"] = bool(torch.equal(
                    torch.isfinite(h.pnorm), torch.isfinite(h64.pnorm)))
                prec["pnorm_rel_err"] = float(
                    ((h.pnorm.double() - h64.pnorm).abs()
                     / h64.pnorm.abs().clamp_min(1e-30))[both].max())
                prec["gnorm_rel_err"] = float(
                    ((h.gnorm.double() - h64.gnorm).abs()
                     / h64.gnorm.abs().clamp_min(1e-30)).max())
                check(prec["finite_equal"] and prec["alive_equal"]
                      and prec["pnorm_pattern_equal"],
                      f"guarded {algo}: telemetry differs from the oracle's")
                check(max(prec["pnorm_rel_err"], prec["gnorm_rel_err"])
                      <= 1e-4, f"guarded {algo}: norms beyond 1e-4")
            res["prefix"].append(prec)
            log_(f"phase 14 {kind} {algo} prefix: {prec}")
            check(prec["rel_err_vs_f64"] <= 1e-4, f"{kind} {algo}: iterate "
                  f"{prec['rel_err_vs_f64']:.3e} beyond 1e-4 of float64")
            check(prec["ring_rel_err_vs_f64"] <= 1e-4,
                  f"{kind} {algo}: ring beyond 1e-4 of float64")

    # unguarded, a NaN partial poisons the iterate in the oracle's places
    got = epoch(eng, "guarded", "sgd", rows("guarded", pre), idx[:pre],
                guard=False)
    expected += implied(steps=pre)
    o64 = oracle("guarded", "sgd", pre, guard=False)
    nan, nan64 = torch.isnan(unpack(got[0])), torch.isnan(o64[0])
    res["unguarded"] = dict(nan_coords=int(nan.sum()),
                            same_coords=bool(torch.equal(nan, nan64)))
    log_(f"phase 14 unguarded prefix: {res['unguarded']}")
    check(res["unguarded"]["nan_coords"] > 0
          and res["unguarded"]["same_coords"],
          "unguarded: NaN not in the float64 oracle's coordinates")

    # the masks are lossless over the survivors: off and ring agree
    w_tt = full["faulted", "sgd"][0]
    for secure in ("off", "ring"):
        e2 = FusedEngine(prob, x, y, layout, EngineConfig(secure=secure),
                         device=dev)
        w2 = epoch(e2, "faulted", "sgd", rows("faulted"), idx)[0]
        expected += implied(steps=steps)
        r = _rel(unpack(w2), unpack(w_tt).double())
        res["secure_modes"][secure] = dict(rel_vs_two_tree=r)
        check(r <= 1e-4, f"faulted sgd {secure} vs two_tree: {r:.3e}")
        del e2
    log_(f"phase 14 secure modes agree: {res['secure_modes']}")

    # kill and resume: one epoch checkpointed, resumed to two, against an
    # uninterrupted two-epoch run
    cfg = EngineConfig(secure="two_tree")
    trace2 = faults.random_trace(layout, 2 * steps, seed=SEED + 1)
    run_kw = dict(seed=SEED, delays_q=delays_q, engine_config=cfg,
                  device=dev)
    train_kw = dict(algo="saga", lr=lr, batch=batch, seed=SEED,
                    engine="fused", engine_config=cfg, device=dev)
    (ROOT / "results").mkdir(exist_ok=True)
    res["resume"] = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "results") as tmp:
        t0 = time.perf_counter()
        whole = faults.run_faulted_fused(prob, x, y, layout, trace2, tau, 2,
                                         lr, batch, **run_kw)
        faults.run_faulted_fused(prob, x, y, layout, trace2, tau, 1, lr,
                                 batch, checkpoint_dir=f"{tmp}/run",
                                 horizon_epochs=2, **run_kw)
        resumed = faults.run_faulted_fused(prob, x, y, layout, trace2, tau,
                                           2, lr, batch,
                                           resume_from=f"{tmp}/run",
                                           **run_kw)
        expected += implied(steps=4 * steps)
        res["resume"]["run_faulted_fused"] = dict(
            seconds=time.perf_counter() - t0,
            bit_equal=bool(np.array_equal(resumed, whole)))
        t0 = time.perf_counter()
        whole = alg.train(prob, x, y, layout, epochs=2, **train_kw)
        alg.train(prob, x, y, layout, epochs=1, horizon_epochs=2,
                  checkpoint_dir=f"{tmp}/train", **train_kw)
        resumed = alg.train(prob, x, y, layout, epochs=2,
                            resume_from=f"{tmp}/train", **train_kw)
        # saga_init runs in each of the three calls, resumed or not
        expected += implied(steps=4 * steps, full=3, objective=4)
        res["resume"]["train_saga"] = dict(
            seconds=time.perf_counter() - t0,
            bit_equal=bool(np.array_equal(resumed.w, whole.w)
                           and resumed.history == whole.history))
        log_(f"phase 14 kill and resume: {res['resume']}")
        for name, rec in res["resume"].items():
            check(rec["bit_equal"], f"{name}: the resumed run differs from "
                  "the uninterrupted one")

        # the supervisor heals a divergent ridge run
        t0 = time.perf_counter()
        before = Counter(_libs()[0].launches)
        sup = alg.train(ridge(1e-4), x, y, layout, algo="sgd", epochs=2,
                        lr=FAULT_DIVERGENT_LR, batch=batch, seed=SEED,
                        engine="fused",
                        engine_config=cfg, supervise=True,
                        supervisor_config=SupervisorConfig(
                            lr_backoff=0.1, max_retries=4, keep_last=2),
                        checkpoint_dir=f"{tmp}/sup", device=dev)
        ran = Counter(_libs()[0].launches) - before
        epochs_run = ran["vfl_backward_rows"] // steps
        expected += implied(steps=epochs_run * steps, objective=epochs_run)
        objs = [h["objective"] for h in sup.history]
        res["supervisor"] = dict(seconds=time.perf_counter() - t0,
                                 heals=sup.heals, objectives=objs,
                                 epochs_run=epochs_run)
        log_(f"phase 14 supervised ridge: {res['supervisor']}")
        check(len(sup.heals) >= 1 and np.isfinite(objs).all()
              and np.isfinite(sup.w).all(),
              "the supervisor did not heal the divergent ridge run")

    # where a faulted and a guarded step's time goes, beside phase 11's
    # delayed step in the same call
    chans = {k: rows(k, pre) for k in ("faulted", "guarded")}
    for kind, fn in (("faulted", lambda: epoch(
            eng, "faulted", "sgd", chans["faulted"], idx[:pre],
            sync_check=False)),
                     ("guarded", lambda: epoch(
            eng, "guarded", "sgd", chans["guarded"], idx[:pre],
            sync_check=False)),
                     ("delayed", lambda: eng.delayed_sgd_epoch(
            zero, ring(), 0, delays, lr, idx[:pre], tau, key))):
        res[f"profile_{kind}"] = epoch_profile(torch, fn, pre)
        expected += implied(steps=3 * pre)
        log_(f"phase 14 profile of {pre} {kind} SGD steps: "
             f"{res[f'profile_{kind}']}")
    del eng
    return res, expected


DEEP_FAULT_KINDS = [(k, a) for k in ("faulted", "guarded")
                    for a in ("sgd", "svrg")]
# steps of phase 15's float64 oracle runs: its party-loop oracles take
# 9-14 ms a step on one H100
DEEP_FAULT_PREFIX = 250
# steps of each of phase 15's three profiler windows
DEEP_FAULT_WINDOW = 200


def deep_fault_phase(torch, dev, x, y, layout, log_):
    """Phase 15: the deep faulted and guarded epochs at τ = 4 on phase 12's
    universe and start, under phase 11's seed-0 delays and phase 14's
    traces.  (a) One full epoch each of deep faulted SGD and SVRG on
    phase 14's crash/rejoin/straggle/drop trace and of deep guarded SGD
    and SVRG on its NaN/Inf trace, under ``two_tree``, run twice (the
    second timed and equal to the first bit for bit, NaN for NaN in the
    telemetry), each under no host sync, each step's graph launching as a
    fresh deep step does (4, SVRG 6); guarded: finite with no poisoned
    step.  (b) Each kind's first ``DEEP_FAULT_PREFIX`` steps against the
    port's float64 deep oracle on the same schedule (every leaf and ring
    slot within 1e-4 relative; guarded: ``finite``/``alive`` equal, the
    norms within 1e-4); ``guard=False`` NaN in the oracle's coordinates.
    (c) Deep faulted SGD under ``off`` and ``ring`` against ``two_tree``.
    (d) ``run_deep_faulted_fused`` checkpointed after 1 epoch and resumed
    to 2, bit-equal to an uninterrupted run.  (e)
    ``supervised_guarded_run(deep=True)`` finishes finite.  (f) Profiler
    windows over ``DEEP_FAULT_WINDOW`` deep faulted, deep guarded and
    (phase 13's) deep delayed SGD steps.  Returns (record, expected launches)."""
    import tempfile

    from repro_torch.core import algorithms as alg
    from repro_torch.core import deep_vfl
    from repro_torch.core import faults
    from repro_torch.core import staleness as st
    from repro_torch.core.engine import EngineConfig, FusedEngine
    from repro_torch.core.losses import logistic_l2
    from repro_torch.core.supervisor import (poisoned_steps,
                                             supervised_guarded_run)
    n, d = x.shape
    tau, pre, win = STALE_TAU, DEEP_FAULT_PREFIX, DEEP_FAULT_WINDOW
    prob, lr, batch = logistic_l2(1e-4), TRAIN_LR, TRAIN_BATCH
    steps = n // batch
    key = (SEED, 0)
    delays_q = st.party_delay_values(layout, tau, SEED)
    delays = torch.from_numpy(delays_q).to(dev).long()
    traces = {"faulted": faults.random_trace(layout, steps, seed=SEED),
              "guarded": faults.random_trace(layout, steps, seed=SEED,
                                             p_corrupt=FAULT_P_CORRUPT,
                                             corrupt_modes=("nan", "inf"))}
    scheds = {k: tr.compile(layout.m) for k, tr in traces.items()}
    idx = alg.epoch_indices(SEED, 0, n, batch, steps, dev)
    expected = Counter()
    res = {"tau": tau, "epochs": [], "prefix": [], "secure_modes": {}}
    eng = FusedEngine(prob, x, y, layout, EngineConfig(secure="two_tree"),
                      device=dev)
    p0 = deep_vfl.initial_params(SEED, layout, d, DEEP_HIDDEN, DEEP_DREP)
    pq0 = eng.pack_deep(p0)
    muq = eng.deep_full_gradient(pq0, key)
    expected += deep_implied(full=1)
    # the float64 oracles' inputs: the same start, blocks, labels and μ̃
    _, blocks64, y64, pt64 = deep_vfl._setup(x.double(), y, layout, p0, SEED,
                                             DEEP_HIDDEN, DEEP_DREP, dev)
    mu64 = deep_vfl._bum_grads(pt64, list(blocks64), y64, prob, layout.q)

    def rows(kind, k=steps):
        win = scheds[kind].epoch(0, steps)
        out = [torch.from_numpy(a[:, :k].copy()).to(dev)
               for a in win.party_rows()]
        if kind == "guarded":
            out.append(torch.from_numpy(win.corrupt_rows()[:, :k].copy())
                       .to(dev))
        return out

    def launches(algo, s):
        return deep_implied(steps=s) if algo == "sgd" \
            else deep_implied(svrg_steps=s)

    def epoch(e, kind, algo, chans, ix, guard=True, sync_check=True):
        head = (pq0,) if algo == "sgd" else (pq0, pq0, muq)
        kw = {} if kind == "faulted" else {"guard": guard}
        with no_host_sync(torch) if sync_check else contextlib.nullcontext():
            return getattr(e, f"deep_{kind}_{algo}_epoch")(
                *head, e.deep_delay_buffers(pq0, tau), 0, delays, *chans,
                lr, ix, tau, key, **kw)

    def oracle(kind, algo, k, guard=True):
        win = scheds[kind].epoch(0, steps)
        head = (pt64,) if algo == "sgd" else (pt64, pt64, mu64)
        extra = (win.codes()[:k],) if kind == "guarded" else ()
        kw = {"guard": guard} if kind == "guarded" else {}
        return getattr(faults, f"deep_{kind}_{algo}_epoch")(
            prob, *head, faults._deep_ring_init(pt64, tau), 0, blocks64,
            y64, lr, delays_q, idx[:k], win.fwd[:k], win.bwd[:k],
            win.extra[:k], *extra, **kw)

    def leaves(params):
        return [*params.enc_w1, *params.enc_b1, *params.enc_w2, params.head]

    def rel_rings(bufq, rings64):
        """The engine's (q, τ+1, ...) rings against the oracle's per-party
        (τ+1, ...) rings, slot by slot, w1's padding dropped."""
        worst = 0.0
        for i, (ring, per_party) in enumerate(zip(bufq, rings64)):
            for s in range(ring.shape[1]):
                got = torch.cat([(ring[p, s][: r.shape[-2]] if i == 0
                                  else ring[p, s]).flatten()
                                 for p, r in enumerate(per_party)])
                want = torch.cat([r[s].flatten() for r in per_party])
                worst = max(worst, _rel(got, want))
        return worst

    full = {}
    for kind, algo in DEEP_FAULT_KINDS:
        chans = rows(kind)

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = epoch(eng, kind, algo, chans, idx)
            torch.cuda.synchronize()
            return got, time.perf_counter() - t0

        first, first_seconds = run()
        got, seconds = run()
        flat = [*got[0], *got[1], got[2]]
        flat0 = [*first[0], *first[1], first[2]]
        if kind == "guarded":
            flat += list(got[3])
            flat0 += list(first[3])
        check(all(_same_bits(torch, a, b) for a, b in zip(flat0, flat)),
              f"deep {kind} {algo}: a second run differs from the first")
        check(int(got[2]) == steps,
              f"deep {kind} {algo}: counter {int(got[2])}")
        expected += launches(algo, 2 * steps) + deep_implied(objective=1)
        full[kind, algo] = got
        rec = dict(kind=kind, algo=algo, seconds=seconds,
                   first_seconds=first_seconds,
                   samples_per_s=steps * batch / seconds,
                   host_us_per_step=seconds / steps * 1e6,
                   finite=all(bool(torch.isfinite(a).all()) for a in got[0]),
                   objective=eng.deep_objective(got[0]))
        if kind == "guarded":
            health = faults.HealthStats(*(a.cpu().numpy() for a in got[3]))
            rec["quarantined"] = int((health.finite == 0).sum())
            rec["poisoned"] = int(poisoned_steps(health).sum())
            check(rec["quarantined"] > 0,
                  f"deep guarded {algo}: the trace corrupted nothing")
            check(rec["poisoned"] == 0,
                  f"deep guarded {algo}: a non-finite partial got through")
        check(rec["finite"] and np.isfinite(rec["objective"]),
              f"deep {kind} {algo}: non-finite parameters or objective")
        res["epochs"].append(rec)
        log_(f"phase 15 {kind} {algo}: {rec}")

        # the prefix against the float64 oracle
        got = epoch(eng, kind, algo, rows(kind, pre), idx[:pre])
        expected += launches(algo, pre)
        t0 = time.perf_counter()
        o64 = oracle(kind, algo, pre)
        params64 = deep_vfl._to_params(o64[0])
        prec = dict(kind=kind, algo=algo,
                    oracle_seconds=time.perf_counter() - t0,
                    rel_err_vs_f64=max(
            _rel(a, b) for a, b in zip(leaves(eng.unpack_deep(got[0])),
                                       leaves(params64))),
            ring_rel_err_vs_f64=rel_rings(got[1], o64[1]))
        if kind == "guarded":
            h, h64 = got[3], o64[3]
            prec["finite_equal"] = bool(torch.equal(h.finite,
                                                    h64.finite.float()))
            prec["alive_equal"] = bool(torch.equal(h.alive,
                                                   h64.alive.float()))
            both = torch.isfinite(h.pnorm) & torch.isfinite(h64.pnorm)
            prec["pnorm_pattern_equal"] = bool(torch.equal(
                torch.isfinite(h.pnorm), torch.isfinite(h64.pnorm)))
            prec["pnorm_rel_err"] = float(
                ((h.pnorm.double() - h64.pnorm).abs()
                 / h64.pnorm.abs().clamp_min(1e-30))[both].max())
            prec["gnorm_rel_err"] = float(
                ((h.gnorm.double() - h64.gnorm).abs()
                 / h64.gnorm.abs().clamp_min(1e-30)).max())
            check(prec["finite_equal"] and prec["alive_equal"]
                  and prec["pnorm_pattern_equal"],
                  f"deep guarded {algo}: telemetry differs from the oracle's")
            check(max(prec["pnorm_rel_err"], prec["gnorm_rel_err"]) <= 1e-4,
                  f"deep guarded {algo}: norms beyond 1e-4")
        res["prefix"].append(prec)
        log_(f"phase 15 {kind} {algo} prefix: {prec}")
        check(prec["rel_err_vs_f64"] <= 1e-4,
              f"deep {kind} {algo}: a leaf {prec['rel_err_vs_f64']:.3e} "
              "beyond 1e-4 of the float64 oracle")
        check(prec["ring_rel_err_vs_f64"] <= 1e-4,
              f"deep {kind} {algo}: a ring slot beyond 1e-4 of float64")

    # each deep faulted and guarded step's graph launches as a fresh deep
    # step's does: 4 (SVRG 6)
    per_step = {name: sum(loop.per_step.values())
                for (name, _), loop in eng._loops.items()
                if "faulted" in name or "guarded" in name}
    res["launches_per_step"] = per_step
    check(len(per_step) == 4 and all(
        v == (6 if "svrg" in k else 4) for k, v in per_step.items()),
        f"deep faulted/guarded launches per step {per_step} != 4 (SVRG 6)")

    # unguarded, a NaN partial poisons the params in the oracle's places
    got = epoch(eng, "guarded", "sgd", rows("guarded", pre), idx[:pre],
                guard=False)
    expected += deep_implied(steps=pre)
    o64 = oracle("guarded", "sgd", pre, guard=False)
    nan = [torch.isnan(a) for a in leaves(eng.unpack_deep(got[0]))]
    nan64 = [torch.isnan(a) for a in leaves(deep_vfl._to_params(o64[0]))]
    res["unguarded"] = dict(
        nan_values=int(sum(a.sum() for a in nan)),
        same_places=all(torch.equal(a, b) for a, b in zip(nan, nan64)))
    log_(f"phase 15 unguarded prefix: {res['unguarded']}")
    check(res["unguarded"]["nan_values"] > 0
          and res["unguarded"]["same_places"],
          "deep unguarded: NaN not in the float64 oracle's places")

    # the masks are lossless over the survivors: off and ring agree
    want = leaves(eng.unpack_deep(full["faulted", "sgd"][0]))
    for secure in ("off", "ring"):
        e2 = FusedEngine(prob, x, y, layout, EngineConfig(secure=secure),
                         device=dev)
        got = epoch(e2, "faulted", "sgd", rows("faulted"), idx)[0]
        expected += deep_implied(steps=steps)
        r = max(_rel(a, b.double())
                for a, b in zip(leaves(e2.unpack_deep(got)), want))
        res["secure_modes"][secure] = dict(rel_vs_two_tree=r)
        check(r <= 1e-4, f"deep faulted sgd {secure} vs two_tree: {r:.3e}")
        del e2
    log_(f"phase 15 secure modes agree: {res['secure_modes']}")

    # kill and resume; the supervisor
    cfg = EngineConfig(secure="two_tree")
    trace2 = faults.random_trace(layout, 2 * steps, seed=SEED + 1)
    run_kw = dict(seed=SEED, hidden=DEEP_HIDDEN, d_rep=DEEP_DREP,
                  delays_q=delays_q, engine_config=cfg, device=dev)
    (ROOT / "results").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "results") as tmp:
        t0 = time.perf_counter()
        whole = faults.run_deep_faulted_fused(prob, x, y, layout, trace2,
                                              tau, 2, lr, batch, **run_kw)
        faults.run_deep_faulted_fused(prob, x, y, layout, trace2, tau, 1, lr,
                                      batch, checkpoint_dir=f"{tmp}/run",
                                      horizon_epochs=2, **run_kw)
        resumed = faults.run_deep_faulted_fused(prob, x, y, layout, trace2,
                                                tau, 2, lr, batch,
                                                resume_from=f"{tmp}/run",
                                                **run_kw)
        expected += deep_implied(steps=4 * steps)
        res["resume"] = dict(seconds=time.perf_counter() - t0,
                             bit_equal=all(torch.equal(a, b) for a, b in
                                           zip(leaves(resumed),
                                               leaves(whole))))
        log_(f"phase 15 kill and resume: {res['resume']}")
        check(res["resume"]["bit_equal"], "run_deep_faulted_fused: the "
              "resumed run differs from the uninterrupted one")

        t0 = time.perf_counter()
        before = Counter(_libs()[0].launches)
        p_sup, h_sup, heals = supervised_guarded_run(
            prob, x, y, layout, traces["guarded"], tau, 1, lr, batch,
            algo="sgd", seed=SEED, deep=True, hidden=DEEP_HIDDEN,
            d_rep=DEEP_DREP, engine_config=cfg, delays_q=delays_q,
            checkpoint_dir=f"{tmp}/sup", device=dev)
        ran = Counter(_libs()[0].launches) - before
        epochs_run = ran["vfl_backward_rows"] // (2 * steps)
        expected += deep_implied(steps=epochs_run * steps)
        res["supervisor"] = dict(
            seconds=time.perf_counter() - t0, heals=heals,
            epochs_run=epochs_run,
            finite=all(bool(torch.isfinite(a).all()) for a in leaves(p_sup)),
            poisoned=int(poisoned_steps(h_sup).sum()))
        log_(f"phase 15 supervised deep guarded run: {res['supervisor']}")
        check(res["supervisor"]["finite"]
              and res["supervisor"]["poisoned"] == 0,
              "supervised_guarded_run(deep=True) did not finish finite")

    # where a deep faulted and a deep guarded step's time goes, beside
    # phase 13's deep delayed step in the same call
    chans = {k: rows(k, win) for k in ("faulted", "guarded")}
    t0 = time.perf_counter()
    for kind, fn in (("faulted", lambda: epoch(
            eng, "faulted", "sgd", chans["faulted"], idx[:win],
            sync_check=False)),
                     ("guarded", lambda: epoch(
            eng, "guarded", "sgd", chans["guarded"], idx[:win],
            sync_check=False)),
                     ("delayed", lambda: eng.deep_delayed_sgd_epoch(
            pq0, eng.deep_delay_buffers(pq0, tau), 0, delays, lr, idx[:win],
            tau, key))):
        res[f"profile_{kind}"] = epoch_profile(torch, fn, win)
        expected += deep_implied(steps=3 * win)
        log_(f"phase 15 profile of {win} deep {kind} SGD steps: "
             f"{res[f'profile_{kind}']}")
    res["profile_seconds"] = time.perf_counter() - t0
    del eng, blocks64, y64
    return res, expected


# phase 16's layouts: (name, PartyMesh keywords); the last packs q = 64
# parties 8 to a slot on phase 7's data (dp = 64)
MESH_LAYOUTS = (("packed_q8_slots4", dict(q=Q, slots=4)),
                ("data_q8_slots2_shards2", dict(q=Q, slots=2, data_shards=2)),
                ("packed_q64_slots8", dict(q=MESH_Q, slots=MESH_SLOTS)))


def mesh_phase(torch, dev, x, y, log_):
    """Phase 16: the hierarchical party mesh on one card, on phase 7's
    resident data and problem.  For each of ``PartyMesh(q=8, slots=4)``,
    ``PartyMesh(q=8, slots=2, data_shards=2)`` and ``PartyMesh(q=64,
    slots=8)`` (64 parties of 64 features on the same x): one SGD and one
    SVRG epoch from w = 0 in each secure mode, each under no host sync;
    under ``off`` bit-equal to the flat epoch where packed, within 1e-4
    over the data axis; under ``two_tree`` and ``ring`` within 1e-4
    relative of the flat ``two_tree`` iterate; a ``two_tree`` prefix of
    ``FAULT_PREFIX`` steps within 1e-4 of the float64 oracle; host µs a
    step beside the flat step's.  Faulted SGD through
    ``run_faulted_fused(mesh=PartyMesh(q=8, slots=2))`` within 1e-4 of the
    flat runner; profiler windows over ``FAULT_PREFIX`` packed and flat
    ``two_tree`` SGD steps.  Returns (record, expected launches)."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core import faults
    from repro_torch.core import staleness as st
    from repro_torch.core.algorithms import PartyLayout
    from repro_torch.core.engine import EngineConfig, FusedEngine
    from repro_torch.core.losses import logistic_l2
    from repro_torch.sharding.api import PartyMesh
    n, d = x.shape
    prob, lr, batch, pre = logistic_l2(1e-4), TRAIN_LR, TRAIN_BATCH, \
        FAULT_PREFIX
    steps = n // batch
    key = (SEED, 0)
    idx = alg.epoch_indices(SEED, 0, n, batch, steps, dev)
    x64, y64 = x.double(), y.double()
    w64 = torch.zeros(d, dtype=torch.float64, device=dev)
    mask64 = torch.ones(d, dtype=torch.float64, device=dev)
    mu64 = alg.full_gradient(prob, w64, x64, y64)
    o64 = {"sgd": alg.sgd_epoch(prob, w64, x64, y64, lr, mask64, idx[:pre]),
           "svrg": alg.svrg_epoch(prob, w64, w64, mu64, x64, y64, lr,
                                  mask64, idx[:pre])}
    del x64, y64
    expected = Counter()
    res = {"layouts": {}}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with no_host_sync(torch):
            got = fn()
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0

    def run(e, algo, ix, mu):
        zero = e.pack_w(torch.zeros(d, device=dev))
        if algo == "sgd":
            return e.sgd_epoch(zero, lr, ix, key)
        return e.svrg_epoch(zero, zero, mu, lr, ix, key)

    def epochs(e, timing):
        """SGD and SVRG (μ̃ at w = 0) epochs of ``e``; under ``timing`` the
        SGD epoch runs twice, the second timed, and each algorithm's
        prefix runs too."""
        mu = e.full_gradient(e.pack_w(torch.zeros(d, device=dev)), key)
        out = {"seconds": None}
        for algo in ("sgd", "svrg"):
            out[algo], seconds = timed(lambda: run(e, algo, idx, mu))
            if timing and algo == "sgd":
                again, out["seconds"] = timed(lambda: run(e, algo, idx, mu))
                check(torch.equal(again, out[algo]),
                      "a second mesh SGD run differs from the first")
            if timing:
                out[algo + "_prefix"], _ = timed(
                    lambda: run(e, algo, idx[:pre], mu))
        runs = 3 if timing else 2
        expected.update(implied(steps=runs * steps + (2 * pre if timing
                                                      else 0), full=1))
        return out

    flat = {}
    for name, kw in MESH_LAYOUTS:
        mesh = PartyMesh(**kw)
        lay = PartyLayout.even(d, mesh.q, M_ACT)
        if mesh.q not in flat:
            flat[mesh.q] = {}
            for mode in ("off", "two_tree"):
                e = FusedEngine(prob, x, y, lay, EngineConfig(secure=mode),
                                device=dev)
                flat[mesh.q][mode] = epochs(e, mode == "two_tree")
                del e
        ref = flat[mesh.q]
        rec = {"dp": D // mesh.q, "flat_host_us_per_step":
               ref["two_tree"]["seconds"] / steps * 1e6}
        for mode in ("off", "two_tree", "ring"):
            e = FusedEngine(prob, x, y, lay, EngineConfig(secure=mode),
                            mesh=mesh, device=dev)
            got = epochs(e, mode == "two_tree")
            for algo in ("sgd", "svrg"):
                if mode == "off" and mesh.data_shards == 1:
                    ok = torch.equal(got[algo], ref["off"][algo])
                    rec[f"{algo}_off_bit_equal"] = ok
                    check(ok, f"{name} {algo} off: not the flat epoch's bits")
                else:
                    want = ref["off" if mode == "off" else "two_tree"][algo]
                    r = _rel(got[algo], want.double())
                    rec[f"{algo}_{mode}_rel_vs_flat"] = r
                    check(r <= 1e-4, f"{name} {algo} {mode}: {r:.3e} from "
                          "the flat epoch")
                if mode == "two_tree":
                    r = _rel(torch.from_numpy(e.unpack_w(
                        got[algo + "_prefix"])).to(dev), o64[algo])
                    rec[f"{algo}_prefix_rel_err_vs_f64"] = r
                    check(r <= 1e-4, f"{name} {algo}: prefix {r:.3e} beyond "
                          "1e-4 of the float64 oracle")
            if mode == "two_tree":
                rec["host_us_per_step"] = got["seconds"] / steps * 1e6
                if name == MESH_LAYOUTS[0][0]:
                    res["profile_packed"] = epoch_profile(
                        torch, lambda: e.sgd_epoch(
                            e.pack_w(torch.zeros(d, device=dev)), lr,
                            idx[:pre], key), pre)
                    expected.update(implied(steps=3 * pre))
                    log_(f"phase 16 profile of {pre} packed two_tree SGD "
                         f"steps: {res['profile_packed']}")
            del e
        res["layouts"][name] = rec
        log_(f"phase 16 {name}: {rec}")
        if mesh.q != Q:
            del flat[mesh.q]                 # the q = 64 packs go here
            torch.cuda.empty_cache()

    # the flat step's window in the same call
    e = FusedEngine(prob, x, y, PartyLayout.even(d, Q, M_ACT),
                    EngineConfig(secure="two_tree"), device=dev)
    res["profile_flat"] = epoch_profile(
        torch, lambda: e.sgd_epoch(e.pack_w(torch.zeros(d, device=dev)), lr,
                                   idx[:pre], key), pre)
    expected.update(implied(steps=3 * pre))
    log_(f"phase 16 profile of {pre} flat two_tree SGD steps: "
         f"{res['profile_flat']}")
    del e

    # faulted SGD over a packed mesh against the flat runner
    lay = PartyLayout.even(d, Q, M_ACT)
    tr = faults.random_trace(lay, steps, seed=SEED)
    kw = dict(seed=SEED, delays_q=st.party_delay_values(lay, STALE_TAU, SEED),
              engine_config=EngineConfig(secure="two_tree"), device=dev)
    w_flat = faults.run_faulted_fused(prob, x, y, lay, tr, STALE_TAU, 1, lr,
                                      batch, **kw)
    w_mesh = faults.run_faulted_fused(prob, x, y, lay, tr, STALE_TAU, 1, lr,
                                      batch, mesh=PartyMesh(q=Q, slots=2),
                                      **kw)
    expected.update(implied(steps=2 * steps))
    res["faulted_runner_rel_vs_flat"] = r = float(
        np.linalg.norm(w_mesh - w_flat) / np.linalg.norm(w_flat))
    log_(f"phase 16 run_faulted_fused over PartyMesh(q=8, slots=2): "
         f"{r:.3e} from the flat runner")
    check(r <= 1e-4, f"packed faulted runner {r:.3e} from the flat one")
    return res, expected


# phase 17: serving over the mesh, and the thread simulation
SERVE_MESH_TRACE, SERVE_MESH_HOT = 100_000, 8192   # phases 3-5's trace
SERVE_MESH_OFF = BATCH * 100      # ids of the packed-against-flat off pass
ASYNC_M, ASYNC_THREADS = 3, 3     # examples/async_vfl.py's regime
ASYNC_STRAGGLER, ASYNC_DELAY = 1.45, 2e-3
ASYNC_ITERS = 1000                # dominator iterations a run
ASYNC_FAULT_ITERS = 500           # ... and in the run with a crash
ASYNC_PROFILE_ITERS = 200
ASYNC_MAX_WALL = 30.0


def _mesh_serve(torch, dev, x, log_):
    """Phase 17 (a): ``ServeEngine`` over ``PartyMesh(q=64, slots=8)`` on
    phase 7's resident data: phases 3-5's linear path (cold, Zipf hits,
    delta, queue) under ``two_tree`` and ``ring``, beside a flat q = 64
    engine under ``two_tree``; phase 6's deep path under ``two_tree``;
    ``off`` packed against flat on the same ids, bit for bit.  Returns
    (record, expected launches)."""
    from repro_torch.core.algorithms import PartyLayout
    from repro_torch.sharding.api import PartyMesh
    n, d = x.shape
    lay = PartyLayout.even(d, MESH_Q, M_ACT)
    mesh = PartyMesh(q=MESH_Q, slots=MESH_SLOTS)
    expected = Counter()
    res = {}
    for name, secure, m in (("packed_two_tree", "two_tree", mesh),
                            ("packed_ring", "ring", mesh),
                            ("flat_two_tree", "two_tree", None)):
        res[name], e = linear_phase(
            torch, dev, x, lay, trace_len=SERVE_MESH_TRACE,
            hot_len=SERVE_MESH_HOT, secure=secure, mesh=m,
            log_=lambda *a, name=name: log_(f"phase 17 {name}", *a))
        expected += e
        torch.cuda.empty_cache()
    res["packed_deep_two_tree"], e = deep_phase(torch, dev, x, lay,
                                                BATCH * 300, mesh)
    expected += e
    log_(f"phase 17 packed deep two_tree: {res['packed_deep_two_tree']}")

    # off: the packed engine serves the flat engine's bits
    ids = np.random.default_rng(SEED + 5).permutation(n)[:SERVE_MESH_OFF]
    w = torch.ones(d, device=dev) / d
    outs = []
    for m in (mesh, None):
        sv = _serve_engine(torch, dev, x, lay, "off", mesh=m)
        sv.set_weights(w)
        cold, _ = _serve_chunks(sv, ids)
        check(np.array_equal(_serve_chunks(sv, ids)[0], cold),
              "off hits not bit-exact")
        outs.append(cold)
        expected += expected_launches(sv)
        del sv
        torch.cuda.empty_cache()
    res["off_packed_bit_equal_flat"] = ok = bool(np.array_equal(*outs))
    check(ok, "packed off serving is not flat serving's bits")
    res["off_max_abs_err"] = _close(outs[0], _linear_ref(torch, x, w, ids),
                                    1e-4, "packed off")
    for what in ("cold", "warm"):
        p, f = res["packed_two_tree"][what], res["flat_two_tree"][what]
        log_(f"phase 17 {what}, packed q={MESH_Q} over {MESH_SLOTS} slots "
             f"against flat q={MESH_Q} (two_tree): p50 {p['p50_ms']:.3f} / "
             f"{f['p50_ms']:.3f} ms, p99 {p['p99_ms']:.3f} / "
             f"{f['p99_ms']:.3f} ms, {p['requests_per_s']:.0f} / "
             f"{f['requests_per_s']:.0f} req/s")
    return res, expected


def _async_launches(vg, before, res, q, sync):
    """Check one thread-simulation run's ``vfl_grad`` launches (the counts
    since ``before``) against ``core.async_engine``'s rule for q parties:
    a forward launch a dominator iteration and a probe, a backward launch
    an applied update (``run_sync``: an iteration), nothing else.  Returns
    the launches the rule gives, from the run's own counts."""
    got = {p: vg.KERNEL.launches[p] - before[p] for p in vg.PROGRAMS}
    want = dict.fromkeys(vg.PROGRAMS, 0)
    want["vfl_forward_narrow"] = res.iterations + len(res.loss_trace)
    want["vfl_backward_rows"] = res.iterations if sync else res.updates
    check(got == want,
          f"{'run_sync' if sync else 'run_async'} launches {got}, not "
          f"{want}: {res.iterations} iterations, {res.updates} updates, "
          f"{len(res.loss_trace)} probes")
    check(res.iterations * q == res.updates if sync
          else res.iterations * q >= res.updates,
          f"{res.iterations} iterations for {res.updates} updates of {q} "
          "parties")
    return Counter(want)


def _thread_sim(torch, dev, x, y, log_):
    """Phase 17 (b): the thread simulation at ``examples/async_vfl.py``'s
    regime (q = 8, m = 3, 3 threads a party, the last party 1.45×
    slower, ``base_delay`` 2 ms, batch 32) on phase 7's resident data and
    problem for ``ASYNC_ITERS`` dominator iterations.  ``run_sync``
    against the float64 SGD oracle on its own draws; ``run_async``
    (secure) finite, not timed out, at its update target, its objective
    falling; a crash and rejoin of the straggler in a run of
    ``ASYNC_FAULT_ITERS`` iterations, whose realized trace replays
    through ``run_faulted_fused``; every run's launches by the module's
    rule; a profiler window over ``ASYNC_PROFILE_ITERS`` iterations.
    Returns (record, expected launches)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import algorithms as alg
    from repro_torch.core import async_engine as ae
    from repro_torch.core import faults
    from repro_torch.core.algorithms import PartyLayout
    from repro_torch.core.losses import logistic_l2
    from repro_torch.kernels import vfl_grad as vg
    n, d = x.shape
    lay, batch, lr = PartyLayout.even(d, Q, ASYNC_M), TRAIN_BATCH, TRAIN_LR
    prob = logistic_l2(1e-4)
    speeds = [1.0] * lay.q
    speeds[-1] = ASYNC_STRAGGLER
    epochs = ASYNC_ITERS * batch / n
    kw = dict(lr=lr, batch=batch, total_epochs=epochs, speed_factors=speeds,
              base_delay=ASYNC_DELAY, seed=SEED, device=dev)
    akw = dict(kw, threads_per_party=ASYNC_THREADS, max_wall=ASYNC_MAX_WALL)
    expected = Counter()
    res = {}

    def counted(fn, sync):
        _sync(torch, dev)
        before = dict(vg.KERNEL.launches)
        out = fn()
        want = _async_launches(vg, before, out, lay.q, sync)
        expected.update(want)
        return out, dict(want)

    s, got = counted(lambda: ae.run_sync(prob, x, y, lay, **kw), True)
    iters = s.updates // lay.q
    rng = np.random.default_rng(SEED)
    idx = np.stack([rng.integers(0, n, size=batch) for _ in range(iters)])
    idt = torch.as_tensor(idx.ravel(), device=dev)
    w64 = alg.sgd_epoch(
        prob, torch.zeros(d, dtype=torch.float64, device=dev),
        x[idt].double(), y[idt].double(), lr,
        torch.ones(d, dtype=torch.float64, device=dev),
        torch.arange(idt.shape[0], device=dev).view(iters, batch))
    r = _rel(torch.from_numpy(s.w).to(dev), w64)
    res["sync"] = dict(iterations=iters, wall_s=s.wall_time,
                       host_s_per_iteration=s.wall_time / iters,
                       sleep_s_per_iteration=2 * ASYNC_DELAY
                       * ASYNC_STRAGGLER, rel_err_vs_f64_sgd=r,
                       objective_first=s.loss_trace[0][2],
                       objective_last=s.loss_trace[-1][2], launches=got)
    log_(f"phase 17 run_sync: {res['sync']}")
    check(r <= 1e-4, f"run_sync {r:.3e} from the float64 SGD oracle")
    del idt, w64

    a, got = counted(lambda: ae.run_async(prob, x, y, lay, secure=True,
                                          **akw), False)
    first, last = a.loss_trace[0][2], a.loss_trace[-1][2]
    res["async"] = dict(updates=a.updates, target=iters * lay.q,
                        iterations=a.iterations, wall_s=a.wall_time,
                        epochs=a.epochs,
                        host_s_per_iteration=a.wall_time / a.iterations,
                        objective_first=first,
                        objective_last=last, probes=len(a.loss_trace),
                        timed_out=a.timed_out, launches=got)
    res["sync_over_async_wall"] = s.wall_time / a.wall_time
    log_(f"phase 17 run_async (secure): {res['async']}")
    log_(f"phase 17 wall time: async {a.wall_time:.3f} s, sync "
         f"{s.wall_time:.3f} s, sync / async "
         f"{res['sync_over_async_wall']:.3f}")
    check(np.all(np.isfinite(a.w)), "run_async: a non-finite iterate")
    check(not a.timed_out, "run_async hit its wall-clock bound")
    check(a.updates >= iters * lay.q,
          f"run_async: {a.updates} updates, short of {iters * lay.q}")
    check(last < first, f"run_async: objective {first} -> {last}")

    target = ASYNC_FAULT_ITERS * lay.q
    plan = ae.ThreadFaultPlan(crash_at={lay.q - 1: target // 4},
                              rejoin_at={lay.q - 1: target // 2})
    fkw = dict(akw, total_epochs=ASYNC_FAULT_ITERS * batch / n)
    f, got = counted(lambda: ae.run_async(prob, x, y, lay, secure=True,
                                          fault_plan=plan, **fkw), False)
    tr = f.fault_trace
    kinds = [(e.kind, e.party) for e in tr.events]
    check(("crash", lay.q - 1) in kinds and ("rejoin", lay.q - 1) in kinds,
          f"the realized trace misses the crash or the rejoin: {kinds}")
    tr.compile(lay.m)
    steps = n // batch
    w = faults.run_faulted_fused(prob, x, y, lay, tr.with_steps(steps), 2, 1,
                                 lr, batch, seed=SEED, device=dev)
    expected.update(implied(steps=steps))
    res["faulted"] = dict(updates=f.updates, wall_s=f.wall_time,
                          events=[(e.kind, e.party, e.step)
                                  for e in tr.events],
                          replay_finite=bool(np.all(np.isfinite(w))),
                          launches=got)
    log_(f"phase 17 run_async with a crash and rejoin of party "
         f"{lay.q - 1}: {res['faulted']}")
    check(np.all(np.isfinite(w)) and np.abs(w).max() > 0,
          "the realized trace's replay is not finite")

    pkw = dict(akw, total_epochs=ASYNC_PROFILE_ITERS * batch / n)
    _sync(torch, dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        before = dict(vg.KERNEL.launches)
        t0 = time.perf_counter()
        p = ae.run_async(prob, x, y, lay, secure=True, **pkw)
        _sync(torch, dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    expected.update(_async_launches(vg, before, p, lay.q, False))
    kernels = _device_kernels(prof)
    busy = sum(kernels.values())
    res["profile"] = dict(
        iterations=p.iterations, wall_us=wall_us, device_busy_us=busy,
        device_busy_share=(busy / wall_us) if busy > 0 else None,
        top_device_us=[[k[:80], v] for k, v in
                       sorted(kernels.items(), key=lambda kv: -kv[1])[:8]])
    log_(f"phase 17 profile of {ASYNC_PROFILE_ITERS} run_async iterations: "
         f"{res['profile']}")
    return res, expected


def serve_async_phase(torch, dev, x, y, log_):
    """Phase 17: serving over ``PartyMesh(q=64, slots=8)`` (a) and the
    BAPA thread simulation (b) on phase 7's resident data; the
    interpreter's switch interval, which the thread runs set, is put back
    at the end.  Returns (record, expected launches)."""
    interval = sys.getswitchinterval()
    try:
        res, expected = _mesh_serve(torch, dev, x, log_)
        res["threads"], e = _thread_sim(torch, dev, x, y, log_)
    finally:
        sys.setswitchinterval(interval)
    expected.update(e)
    return res, expected


def train_measure(torch, dev, x, y, layout):
    """After the counted run: the full-gradient pass time beside its bound
    and a profiler window over one SGD epoch."""
    from repro_torch.core import algorithms as alg
    from repro_torch.core.engine import EngineConfig, FusedEngine
    from repro_torch.core.losses import logistic_l2
    n, d = x.shape
    eng = FusedEngine(logistic_l2(1e-4), x, y, layout,
                      EngineConfig(secure="two_tree"), device=dev)
    wq = eng.pack_w(torch.full((d,), 1e-3, device=dev))
    eng.full_gradient(wq)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        eng.full_gradient(wq)
    end.record()
    end.synchronize()
    full_ms = start.elapsed_time(end) / 20
    xbytes = eng.xs.numel() * eng.xs.element_size()
    out = dict(full_gradient_ms=full_ms,
               full_gradient_bound_ms=2 * xbytes / HBM_BYTES_PER_S * 1e3)
    log(f"full gradient pass: {out}")

    steps = n // TRAIN_BATCH
    idx = alg.epoch_indices(SEED, 99, n, TRAIN_BATCH, steps, dev)
    for name in ("sgd", "pipelined_sgd"):
        epoch = getattr(eng, f"{name}_epoch")
        out[f"profile_{name}"] = epoch_profile(
            torch, lambda: epoch(wq, TRAIN_LR, idx), steps)
        log(f"profile of one {name} epoch: {out[f'profile_{name}']}")
    return out


def epoch_profile(torch, epoch, steps):
    """Run ``epoch()`` three times: to capture its step's graph, timed
    without the profiler, and in a profiler window; returns the device
    busy time by kernel over the window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    epoch()                                          # capture its graph
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch()
    torch.cuda.synchronize()
    plain_wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = _device_kernels(prof)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:20]
    return dict(steps=steps, wall_us=wall_us,
                unprofiled_wall_us=plain_wall_us, device_busy_us=busy,
                device_busy_share=(busy / wall_us) if busy > 0 else None,
                top_device_us=[[k[:80], v] for k, v in top])


# ---------------------------------------------------------------------------
# phase 9: LM serving
# ---------------------------------------------------------------------------

def _libs():
    """The four kernel libraries, by source."""
    from repro_torch.kernels import decode_attention as dak
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import selective_scan as ssk
    from repro_torch.kernels import vfl_grad as vg
    return (vg.KERNEL, ssk.KERNEL, fak.KERNEL, dak.KERNEL)


def reset_counts():
    """Every kernel program's launch count to 0 (a path starts)."""
    for lib in _libs():
        lib.reset_launches()


def check_idle(libs, what):
    """None of ``libs``' programs was launched on the path ``what``."""
    for lib in libs:
        check(not any(lib.launches.values()),
              f"{what} launched {lib.source.name}: {lib.launches}")


def _serve_metrics(torch, out, wall, batch, gen):
    """A ``serve`` call's end-to-end numbers (times on the host clock,
    each ending at a device synchronisation)."""
    steps_ms = [1e3 * t for t in out.step_seconds]
    return dict(
        seconds=wall, ttft_ms=1e3 * out.prefill_seconds,
        decode_p50_ms=pct(steps_ms, 50), decode_p99_ms=pct(steps_ms, 99),
        decode_tokens_per_s=batch * len(steps_ms) / sum(out.step_seconds),
        tokens_per_s=batch * gen / (out.prefill_seconds
                                    + sum(out.step_seconds)),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


def _device_profile(torch, fn):
    """Run ``fn()`` under torch.profiler: wall time, device busy time and
    the device kernels by total time (None where no device time shows)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = _device_kernels(prof)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return dict(wall_us=wall_us, device_busy_us=busy,
                device_busy_share=(busy / wall_us) if busy > 0 else None,
                top_device_us=[[k[:80], v] for k, v in top])


def _decided_tokens_equal(torch, got, want, logits, what):
    """Greedy tokens equal wherever the reference logits' top-two margin
    exceeds LM_TOL of their largest logit; returns the share decided."""
    top = torch.topk(logits.float(), 2, dim=-1).values
    decided = (top[..., 0] - top[..., 1]) > LM_TOL * logits.abs().max()
    check(bool(torch.equal(got[decided], want[decided])),
          f"{what}: tokens differ where the margin decides them")
    return float(decided.float().mean())


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _mixer_step(torch, kern, plain, cfg, kind, p, hn, window, *,
                causal=True, kv_src=None):
    """One layer's mixer (``kind``: attention for a kind starting "attn",
    ``causal`` or not, the block's cross attention ``xattn`` over
    ``kv_src`` where that is given, else the SSM) on the kernel routes
    (``kern``: ``selective_scan``, ``flash_attention``) and on the plain
    ones (``plain``: the sequential scan, the chunked attention) on the
    same normed input hn.  Returns the kernel route's output and, against
    the plain one, the largest absolute error and the count of elements
    beyond atol = rtol = LM_TOL."""
    from repro_torch.models import model as lm
    from repro_torch.models import ssm as ssm_lib
    if kind.startswith("attn"):
        pa = p["attn"] if kv_src is None else p["xattn"]
        ok, _ = lm._apply_attention(kern, cfg, pa, hn, window,
                                    causal=causal, kv_src=kv_src)
        orr, _ = lm._apply_attention(plain, cfg, pa, hn, window,
                                     causal=causal, kv_src=kv_src)
    else:
        ok = ssm_lib.apply_ssm(p["ssm"], hn, scan_impl=kern.scan_impl)
        orr = ssm_lib.apply_ssm(p["ssm"], hn, scan_impl=plain.scan_impl)
    err = (ok.float() - orr.float()).abs()
    return ok, float(err.max()), int(
        (err > LM_TOL + LM_TOL * orr.float().abs()).sum())


def _moe_step(torch, kern, cfg, p, xa, first):
    """One MoE layer's feed-forward on the residual stream xa: the layer
    (``replicated``, under no host sync) against ``_moe_oracle`` on the
    same normed input, with its aux terms; at the ``first`` MoE layer of
    the stack, on the first prompt row, ``alltoall`` against
    ``replicated`` at a capacity where nothing drops (cf = E/k).  Returns
    (xa + the layer's output, its record)."""
    from repro_torch.models import moe
    from repro_torch.models.layers import rms_norm
    m = cfg.moe
    h2 = rms_norm(xa, p["norm2"])
    torch.cuda.synchronize()
    with no_host_sync(torch):
        mo, aux = moe.apply_moe_sharded(kern, p["moe"], h2, top_k=m.top_k,
                                        capacity_factor=m.capacity_factor)
    torch.cuda.synchronize()
    row = dict(_moe_oracle(torch, p["moe"], h2, m, mo),
               lb_loss=float(aux["lb_loss"]), z_loss=float(aux["z_loss"]))
    if first:
        wide = dict(top_k=m.top_k, capacity_factor=m.n_experts / m.top_k)
        one = h2[:1]
        a2a, a2a_aux = moe.apply_moe_sharded(kern, p["moe"], one,
                                             dispatch="alltoall", **wide)
        rep, _ = moe.apply_moe_sharded(kern, p["moe"], one,
                                       dispatch="replicated", **wide)
        single, _ = moe.apply_moe(p["moe"], one, **wide)
        row["alltoall_vs_replicated"] = dict(
            tokens=one.shape[1],
            max_abs_diff=float((a2a.float() - rep.float()).abs().max()),
            replicated_max=float(rep.float().abs().max()),
            alltoall_equals_one_party=bool(torch.equal(a2a, single)),
            alltoall_lb_loss=float(a2a_aux["lb_loss"]))
    return xa + mo, row


def _walk(torch, cfg, params, x, x2, q, frames=None):
    """The prefill's stack layer by layer (``models.model._blocks``: a
    period stack period by period) in three streams: the kernel routes
    from ``x``, the plain routes (``scan_impl`` and ``attn_impl``
    "reference") from ``x`` and the kernel routes from ``x2`` (the same
    prompt embedded under another mask draw), across q parties.  At
    every layer ``_mixer_step`` holds the kernel mixer against the plain
    one on the kernel stream's normed input, and an MoE layer's
    feed-forward goes through ``_moe_step``; the streams' relative L2
    distances are recorded after each layer.  An encoder-decoder's
    ``frames`` (the projected frames of the two mask draws) first go
    through the encoder layer by layer in the same three streams, each
    non-causal self attention held in the same way, and each decoder
    block's cross attention over its stream's encoder output is held
    too; ``mixers`` records each kind of mixer's worst error."""
    from repro_torch.models import model as lm
    from repro_torch.models.layers import rms_norm
    from repro_torch.sharding.api import Runtime
    kern = Runtime(model_size=q)
    plain = Runtime(model_size=q, scan_impl="reference",
                    attn_impl="reference")
    windows = lm.layer_windows(cfg, x.shape[1])
    worst, bad, plain_s = 0.0, 0, 0.0
    moe_layers, vs_ref, vs_masks, mixers = [], [], [], {}

    def mix(name, kind, p, hn, window, **kw):
        nonlocal worst, bad
        out, err, beyond = _mixer_step(torch, kern, plain, cfg, kind, p, hn,
                                       window, **kw)
        worst, bad = max(worst, err), bad + beyond
        row = mixers.setdefault(name, dict(layers=0, max_abs_err=0.0,
                                           beyond_tol=0))
        row.update(layers=row["layers"] + 1,
                   max_abs_err=max(row["max_abs_err"], err),
                   beyond_tol=row["beyond_tol"] + beyond)
        return out

    enc = (None,) * 3
    if frames is not None:
        ek, er, ek2 = frames[0], frames[0], frames[1]
        for i in range(cfg.enc_layers):
            p = lm._layer(params["enc_stack"], i)
            ok = mix("encoder_self", "attn_mlp", p, rms_norm(ek, p["norm1"]),
                     None, causal=False)
            ek, _ = lm._apply_ffn(kern, cfg, p, ek + ok)
            er, _ = lm._block_fwd(plain, cfg, "attn_mlp", p, er, None,
                                  causal=False)
            ek2, _ = lm._block_fwd(kern, cfg, "attn_mlp", p, ek2, None,
                                   causal=False)
        enc = tuple(rms_norm(v, params["enc_norm"]) for v in (ek, er, ek2))
    xk, xr, xk2 = x, x, x2
    for i, kind, p in lm._blocks(cfg, params):
        w = windows[i]
        ok = mix("self" if kind.startswith("attn") else "ssm", kind, p,
                 rms_norm(xk, p["norm1"]), w)
        if "xattn" in p:
            xk = xk + ok
            ok = mix("cross", kind, p, rms_norm(xk, p["norm_x"]), None,
                     causal=False, kv_src=enc[0])
        if "moe" in p:
            xk, row = _moe_step(torch, kern, cfg, p, xk + ok,
                                first=not moe_layers)
            moe_layers.append(dict(row, layer=i, kind=kind))
        else:
            xk, _ = lm._apply_ffn(kern, cfg, p, xk + ok)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xr, _ = lm._block_fwd(plain, cfg, kind, p, xr, w, enc_out=enc[1])
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        xk2, _ = lm._block_fwd(kern, cfg, kind, p, xk2, w, enc_out=enc[2])
        vs_ref.append(_rel_l2(xk, xr))
        vs_masks.append(_rel_l2(xk2, xk))
    fin = params["final_norm"]
    hidden = tuple(rms_norm(v, fin) for v in (xk, xr, xk2))
    res = dict(
        mixer_max_abs_err=worst, mixer_beyond_tol=bad, mixers=mixers,
        plain_path_s=plain_s,
        depth=cfg.n_layers,
        rel_l2_vs_reference=_rel_l2(hidden[0], hidden[1]),
        rel_l2_vs_mask_redraw=_rel_l2(hidden[2], hidden[0]),
        max_abs_err_vs_reference=float((hidden[0].float()
                                        - hidden[1].float()).abs().max()),
        stream_rel_l2_vs_reference=vs_ref,
        stream_rel_l2_vs_mask_redraw=vs_masks, hidden=hidden)
    if moe_layers:
        res.update(
            moe_layers=moe_layers,
            moe_worst_rel_err=max(r["max_abs_err"] / r["oracle_max"]
                                  for r in moe_layers),
            moe_worst_rel_l2=max(r["rel_l2"] for r in moe_layers),
            dropped_share=sum(r["dropped"] for r in moe_layers)
            / sum(r["assignments"] for r in moe_layers))
    return res


def _check_walk(walk, what):
    """``_walk``'s hard checks: every mixer within LM_TOL of the plain
    route's, every MoE layer within phase 20's rules of its f32 oracle
    (and ``alltoall`` within MOE_TOL of ``replicated`` where nothing
    drops), and the kernel path's final hidden states no farther from the
    plain path's than twice a mask redraw's distance."""
    check(walk["mixer_beyond_tol"] == 0,
          f"{what}: {walk['mixer_beyond_tol']} elements of the kernel-path "
          f"mixers beyond atol = rtol = {LM_TOL} of the plain route's on "
          f"the same input (max abs err {walk['mixer_max_abs_err']})")
    for r in walk.get("moe_layers", []):
        check(r["selection_differs_decided"] == 0
              and r["compared_share"] >= MOE_MIN_SHARE
              and r["max_abs_err"] <= MOE_TOL * r["oracle_max"]
              and r["rel_l2"] <= MOE_L2,
              f"{what}: MoE layer {r['layer']} against the f32 per-expert "
              f"oracle: {r} (want no token routed otherwise where the "
              f"oracle's k-th/(k+1)-th margin exceeds {MOE_ROUTE_MARGIN}, "
              f"and max abs err <= {MOE_TOL} x the oracle's largest value "
              f"and relative L2 <= {MOE_L2} on the tokens whose buckets "
              f"agree, at least {MOE_MIN_SHARE} of them)")
        a2a = r.get("alltoall_vs_replicated")
        check(a2a is None
              or a2a["max_abs_diff"] <= MOE_TOL * a2a["replicated_max"],
              f"{what}: alltoall against replicated where nothing drops: "
              f"{a2a}")
    check(walk["rel_l2_vs_reference"] <= 2 * walk["rel_l2_vs_mask_redraw"],
          f"{what}: kernel-path prefill {walk['rel_l2_vs_reference']} from "
          "the plain-route prefill, more than twice the "
          f"{walk['rel_l2_vs_mask_redraw']} a mask redraw moves it")


def _serve_twice(torch, arch, kw, phase, log_):
    """A phase's two ``serve`` calls.  The first is counted: every
    program's launch count is set to 0 just before it and read just
    after; its ids must lie in [0, padded vocabulary) and every leaf of
    its decode state be finite.  The second, warm, gives the reported
    numbers and must repeat the first call's tokens.  Returns (record,
    launches of the first call by program, its result)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.optim.tree import leaves
    b, g = kw["batch"], kw["gen_tokens"]
    vpad = get_arch(arch).padded_vocab
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                                  # main path starts
    t0 = time.perf_counter()
    out = serve(arch, **kw)
    wall = time.perf_counter() - t0
    launches = {prog: n for lib in _libs()          # main path ends
                for prog, n in lib.launches.items()}
    res = {"serve_first": dict(_serve_metrics(torch, out, wall, b, g),
                               launches=launches,
                               tokens_row0=out.tokens[0].tolist())}
    log_(f"phase {phase} serve (first call, counted): {res['serve_first']}")
    check(out.tokens.shape == (b, g)
          and ((out.tokens >= 0) & (out.tokens < vpad)).all(),
          f"phase {phase}: generated ids outside [0, {vpad}): {out.tokens}")
    check(all(bool(torch.isfinite(v.float()).all())
              for v in leaves(out.cache)),
          f"phase {phase}: a decode-state leaf is not finite")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    again = serve(arch, **kw)
    res["serve"] = _serve_metrics(torch, again, time.perf_counter() - t0,
                                  b, g)
    log_(f"phase {phase} serve (second call, warm): {res['serve']}")
    check(np.array_equal(again.tokens, out.tokens),
          f"phase {phase}: a second serve with the same seed gave other "
          "tokens")
    return res, launches, out


def _prefill_walk(torch, cfg, params, batch, gen, tok, q, phase, log_):
    """The prefill through ``_walk`` (its checks included), then end to
    end: the kernel path's next tokens against the plain path's, and a
    ``ring_masks`` prefill's against ``tok`` (``two_tree``'s), equal
    wherever the plain path's top-two margin decides them (on random
    weights router flips may leave none decided: logged).  The streams
    start from the secure frontends: the embedded tokens (after a VLM's
    projected patches), and an encoder-decoder's projected frames.
    Returns the walk's record."""
    from repro_torch.models import model as lm
    from repro_torch.sharding.api import Runtime
    from repro_torch.vfl.heads import vocab_parallel_greedy
    rt = Runtime(model_size=q)
    tok_ring, _ = lm.prefill(Runtime(model_size=q, secure_mode="ring_masks"),
                             cfg, params, batch, gen)
    streams = []
    for _ in range(2):                      # two mask draws
        if cfg.enc_dec:
            streams.append((lm._embed_tokens(rt, cfg, params,
                                             batch["tokens"], gen),
                            lm._project_features(rt, params["enc_proj"],
                                                 batch["frames"], gen)))
        else:
            streams.append((lm._prepare_inputs(rt, cfg, params, batch,
                                               gen)[0], None))
    (x, f), (x2, f2) = streams
    walk = _walk(torch, cfg, params, x, x2, q,
                 frames=(f, f2) if cfg.enc_dec else None)
    h, h_ref, _ = walk.pop("hidden")
    logits = _logits(torch, params, h_ref[:, -1])
    kt = vocab_parallel_greedy(rt, params["embed"], h[:, -1])
    rt_tok = vocab_parallel_greedy(rt, params["embed"], h_ref[:, -1])
    decided = _decided_tokens_equal(torch, kt, rt_tok, logits,
                                    "kernel vs reference prefill")
    walk.update(
        embed_elements_differing=int((x != x2).sum()),
        decided=decided, decided_tokens=round(decided * len(tok)),
        ring_decided=_decided_tokens_equal(
            torch, tok_ring, tok, logits, "ring_masks vs two_tree"),
        prefill_tokens=tok.tolist(), kernel_tokens=kt.tolist(),
        reference_tokens=rt_tok.tolist())
    log_(f"phase {phase} layer walk: {walk}")
    _check_walk(walk, f"phase {phase}")
    if walk["decided_tokens"] == 0:
        log_(f"phase {phase}: no prefill token's margin decides it; the "
             "token check compared none")
    return walk


def _profile_windows(torch, fns, phase, log_):
    """A profiler window (``_device_profile``) over one warm call of each
    of ``fns`` (name → callable)."""
    out = {}
    for name, fn in fns.items():
        fn()                                          # warm
        out[name] = _device_profile(torch, fn)
        log_(f"phase {phase} profile of one {name}: {out[name]}")
    return out


def _logits(torch, params, h):
    """The greedy head's bf16 logits of hidden states h (..., D), read
    as f32 (the party blocks, concatenated, are the whole table)."""
    table = params["embed"].to(torch.bfloat16)
    return torch.matmul(h.to(torch.bfloat16), table.T).float()


def lm_phase(torch, dev, log_):
    """Phase 9; returns (record, selective_scan launches of the serve
    call)."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.configs.inputs import make_batch
    from repro_torch.core.secure_agg import mask_generator
    from repro_torch.kernels import selective_scan as ssk
    from repro_torch.models import model as lm
    from repro_torch.sharding.api import Runtime
    cfg = get_arch(LM_ARCH)
    layers = cfg.n_layers
    kw = dict(batch=LM_BATCH, prompt_len=LM_PROMPT, gen_tokens=LM_GEN,
              reduced=False, model_parallel=LM_Q, seed=SEED)
    res = {"config": dict(arch=LM_ARCH, q=LM_Q, batch=LM_BATCH,
                          prompt=LM_PROMPT, generated=LM_GEN,
                          layers=layers, d_model=cfg.d_model,
                          vocab=cfg.vocab, padded_vocab=cfg.padded_vocab)}
    calls, launches, _ = _serve_twice(torch, LM_ARCH, kw, 9, log_)
    res.update(calls)
    launches = launches["selective_scan"]
    check_idle([lib for lib in _libs() if lib is not ssk.KERNEL],
               "SSM serving")
    check(launches == layers, f"serve launched selective_scan {launches} "
          f"times, not once per layer of the prefill ({layers})")

    rt = Runtime(model_size=LM_Q)
    with torch.no_grad():
        params = lm.init_params(cfg, SEED, device=dev)
        batch = make_batch(cfg, ShapeConfig("lm", LM_PROMPT, LM_BATCH,
                                            "prefill"), rt, seed=SEED,
                           device=dev)
        gen = mask_generator(SEED, 9, device=dev)
        ssk.KERNEL.reset_launches()
        tok, cache = lm.prefill(rt, cfg, params, batch, gen)
        torch.cuda.synchronize()
        per_prefill = ssk.KERNEL.launches["selective_scan"]
        dcache = lm.init_cache(rt, cfg, LM_BATCH, LM_PROMPT + 1, device=dev)
        step = {"token": tok, "pos": LM_PROMPT, "cache": dcache}
        lm.decode_step(rt, cfg, params, step, gen)
        torch.cuda.synchronize()
        per_step = ssk.KERNEL.launches["selective_scan"] - per_prefill
        check(cache is None, "the SSM prefill returned a cache (C.R3)")
        check(per_prefill == layers and per_step == 0,
              f"selective_scan launches: {per_prefill} per prefill (want "
              f"{layers}), {per_step} per decode step (want 0)")
        res["kernel_vs_reference"] = _prefill_walk(
            torch, cfg, params, batch, gen, tok, LM_Q, 9, log_)
        res["profile"] = _profile_windows(torch, {
            "prefill": lambda: lm.prefill(rt, cfg, params, batch, gen),
            "decode_step": lambda: lm.decode_step(rt, cfg, params, step,
                                                  gen)}, 9, log_)
        del params
    torch.cuda.empty_cache()
    return res, launches


# ---------------------------------------------------------------------------
# phase 10: dense LM serving
# ---------------------------------------------------------------------------

def _decode_vs_forward(torch, rt, cfg, params, dec, hf):
    """Greedy tokens ``dec`` (B, S) of teacher-forced decode steps
    against the full forward's at the same positions, from its normed
    hidden states hf (B, S, D): equal in the positions whose top-two
    logit margin exceeds LM_TOL of the top logit
    (``tests/test_decode_consistency.py``'s check; ``agreement`` None
    where none is decided)."""
    from repro_torch.vfl.heads import vocab_parallel_greedy
    b = dec.shape[0]
    fwd = vocab_parallel_greedy(rt, params["embed"],
                                hf.reshape(-1, cfg.d_model)).view(b, -1)
    top = torch.topk(_logits(torch, params, hf), 2, dim=-1).values
    decided = (top[..., 0] - top[..., 1]) > LM_TOL * top[..., 0].abs()
    agree = float((dec == fwd)[decided].float().mean()) \
        if decided.any() else None
    return dict(positions=int(decided.numel()), decided=int(decided.sum()),
                agreement=agree,
                all_positions_agreement=float((dec == fwd).float().mean()))


def _cut_layers(tree, n):
    """A stacked tree's first n layers (views)."""
    if isinstance(tree, dict):
        return {k: _cut_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def _unroll_check(torch, dev, cfg, params, batch, q, n, prompt, phase,
                  log_):
    """``Runtime(unroll_layers=n)`` on the full tree against the tree cut
    to its first n layers (an encoder's too) with ``n_layers=n``: a
    prefill, the normed hidden states of the same forward and one decode
    step on a full-depth cache must give the same bits (tokens, caches,
    hidden states).  The launches of these calls are counted on their
    own (the kernel routes: flash attention once per attention of a
    prefill or forward, decode attention once per decoder attention of a
    step).  Returns the record."""
    from repro_torch.core.secure_agg import mask_generator
    from repro_torch.models import model as lm
    from repro_torch.sharding.api import Runtime
    cut_cfg = dataclasses.replace(cfg, n_layers=n,
                                  enc_layers=min(n, cfg.enc_layers))
    cut = dict(params, stack=_cut_layers(params["stack"], n))
    if cfg.enc_dec:
        cut["enc_stack"] = _cut_layers(params["enc_stack"], n)
    b = batch["tokens"].shape[0]
    s_cache = prompt + q                # a multiple of q past the prompt
    outs = []
    reset_counts()
    for rt, c, p in ((Runtime(model_size=q, unroll_layers=n), cfg, params),
                     (Runtime(model_size=q), cut_cfg, cut)):
        tok, kv = lm.prefill(rt, c, p, batch, mask_generator(SEED, 1, 0,
                                                             device=dev))
        x, enc_out, _ = lm._prepare_inputs(
            rt, c, p, batch, mask_generator(SEED, 1, 0, device=dev))
        h = lm._backbone(rt, c, p, x, enc_out=enc_out)
        del x, enc_out
        # the full tree's decode reads the first n layers of a full cache
        cache = lm.init_cache(rt, c, b, s_cache, device=dev)
        for k, v in kv.items():
            cache[k][:n, :, :v.shape[2]].copy_(v)
        tok2, nxt = lm.decode_step(rt, c, p, {"token": tok, "pos": prompt,
                                              "cache": cache},
                                   mask_generator(SEED, 1, 1, device=dev))
        outs.append(dict(tok=tok, kv=kv, h=h, tok2=tok2, cache=nxt))
        del cache
    torch.cuda.synchronize()
    launches = {prog: k for lib in _libs()
                for prog, k in lib.launches.items() if k}
    per_pass = n * (3 if cfg.enc_dec else 1)    # encoder, self, cross
    per_step = n * (2 if cfg.enc_dec else 1)
    want = {"flash_attention": 2 * 2 * per_pass,
            "decode_attention": 2 * per_step}
    full, short = outs
    same = {name: bool(torch.equal(full[name], short[name]))
            for name in ("tok", "h", "tok2")}
    for name in ("kv", "cache"):
        same[name] = list(full[name]) == list(short[name]) and all(
            full[name][k].shape[0] == n
            and bool(torch.equal(full[name][k], short[name][k]))
            for k in full[name])
    res = dict(n=n, of_layers=cfg.n_layers, bit_equal=same,
               launches=launches, want_launches=want)
    log_(f"phase {phase} unroll_layers={n} vs the cut tree: {res}")
    check(launches == want,
          f"phase {phase} unroll check: launches {launches}, want {want}")
    check(all(same.values()),
          f"phase {phase}: unroll_layers={n} on the full tree is not the "
          f"cut tree's bits: {same}")
    return res


def dense_phase(torch, dev, log_):
    """Phase 10; returns (record, launches of the serve call by
    program)."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.configs.inputs import make_batch
    from repro_torch.core.secure_agg import mask_generator
    from repro_torch.kernels import decode_attention as dak
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.models import model as lm
    from repro_torch.sharding.api import Runtime
    cfg = get_arch(DENSE_ARCH)
    layers = cfg.n_layers
    kw = dict(batch=DENSE_BATCH, prompt_len=DENSE_PROMPT,
              gen_tokens=DENSE_GEN, reduced=False, model_parallel=DENSE_Q,
              seed=SEED)
    windows = lm.layer_windows(cfg, DENSE_PROMPT)
    res = {"config": dict(
        arch=DENSE_ARCH, q=DENSE_Q, batch=DENSE_BATCH, prompt=DENSE_PROMPT,
        generated=DENSE_GEN, layers=layers, d_model=cfg.d_model,
        heads=cfg.n_heads, kv_heads=cfg.n_kv, d_head=cfg.head_dim,
        d_ff=cfg.d_ff, vocab=cfg.vocab, padded_vocab=cfg.padded_vocab,
        window=cfg.window,
        global_layers=[i for i, w in enumerate(windows)
                       if w == DENSE_PROMPT])}
    steps = DENSE_GEN - 1
    calls, launches, _ = _serve_twice(torch, DENSE_ARCH, kw, 10, log_)
    res.update(calls)
    check(launches["flash_attention"] == layers
          and launches["decode_attention"] == layers * steps,
          f"serve launched flash_attention {launches['flash_attention']} "
          f"times (want {layers}, once per layer of the prefill) and "
          f"decode_attention {launches['decode_attention']} (want "
          f"{layers} x {steps} decode steps)")
    check_idle(_libs()[:2], "dense LM serving")
    torch.cuda.empty_cache()

    rt = Runtime(model_size=DENSE_Q)
    with torch.no_grad():
        params = lm.init_params(cfg, SEED, device=dev)
        batch = make_batch(cfg, ShapeConfig("lm", DENSE_PROMPT, DENSE_BATCH,
                                            "prefill"), rt, seed=SEED,
                           device=dev)
        gen = mask_generator(SEED, 10, device=dev)
        # launches per prefill and per decode step
        reset_counts()
        tok, kv = lm.prefill(rt, cfg, params, batch, gen)
        torch.cuda.synchronize()
        per_prefill = (fak.KERNEL.launches["flash_attention"],
                       dak.KERNEL.launches["decode_attention"])
        s_max = DENSE_PROMPT + DENSE_TEACHER
        cache = lm.init_cache(rt, cfg, DENSE_BATCH, s_max, device=dev)
        for name, val in kv.items():
            cache[name][:, :, :DENSE_PROMPT].copy_(val)
        del kv
        # decode against the forward pass: teacher-forced steps after the
        # prefill against the full forward over the prompt and the
        # teacher tokens
        teacher = torch.as_tensor(np.random.default_rng(SEED + 1).integers(
            0, cfg.vocab, (DENSE_BATCH, DENSE_TEACHER)), device=dev)
        dec = [tok]
        reset_counts()
        for i in range(DENSE_TEACHER):
            t, cache = lm.decode_step(
                rt, cfg, params, {"token": teacher[:, i],
                                  "pos": DENSE_PROMPT + i, "cache": cache},
                gen)
            dec.append(t)
        torch.cuda.synchronize()
        per_step = (fak.KERNEL.launches["flash_attention"],
                    dak.KERNEL.launches["decode_attention"])
        check(per_prefill == (layers, 0)
              and per_step == (0, layers * DENSE_TEACHER),
              f"launches (flash, decode): {per_prefill} per prefill (want "
              f"({layers}, 0)), {per_step} over {DENSE_TEACHER} decode "
              f"steps (want (0, {layers * DENSE_TEACHER}))")
        full_tokens = torch.cat([batch["tokens"], teacher], 1)
        xf = lm._embed_tokens(rt, cfg, params, full_tokens, gen)
        hf = lm._backbone(rt, cfg, params, xf)[:, DENSE_PROMPT - 1:]
        del xf
        tf = res["decode_vs_forward"] = _decode_vs_forward(
            torch, rt, cfg, params, torch.stack(dec, 1), hf)
        log_(f"phase 10 decode vs forward: {tf}")
        check(tf["decided"] and tf["agreement"] >= 0.95,
              f"decode against the forward pass: {tf['agreement']} of "
              f"{tf['decided']} decided positions agree (want >= 0.95)")
        del hf, cache
        torch.cuda.empty_cache()

        res["kernel_vs_reference"] = _prefill_walk(
            torch, cfg, params, batch, gen, tok, DENSE_Q, 10, log_)
        step = {"token": tok, "pos": DENSE_PROMPT,
                "cache": lm.init_cache(rt, cfg, DENSE_BATCH,
                                       DENSE_PROMPT + DENSE_GEN, device=dev)}
        res["profile"] = _profile_windows(torch, {
            "prefill": lambda: lm.prefill(rt, cfg, params, batch, gen),
            "decode_step": lambda: lm.decode_step(rt, cfg, params, step,
                                                  gen)}, 10, log_)
        del step
        torch.cuda.empty_cache()
        res["unroll"] = _unroll_check(torch, dev, cfg, params, batch,
                                      DENSE_Q, DENSE_UNROLL, DENSE_PROMPT,
                                      10, log_)
        del params
    torch.cuda.empty_cache()
    return res, launches


# ---------------------------------------------------------------------------
# phase 19: LM training
# ---------------------------------------------------------------------------

def _keystr_paths(tree, path=""):
    """The key path of every leaf of a dict tree, as
    ``jax.tree_util.keystr`` renders it (keys sorted), built here on its
    own to hold the optimiser's delays to the md5 rule."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _keystr_paths(tree[k], f"{path}[{k!r}]")]
    return [path]


def _md5_delay(path, tau):
    if tau == 0:
        return 0
    return int(hashlib.md5(path.encode()).hexdigest()[:8], 16) % (tau + 1)


def _step_stats(times, batch, seq):
    """Host ms a step (median over steps 2..n) and tokens/s."""
    ms = 1e3 * float(np.median(times[1:]))
    return dict(step_ms=ms, step_ms_all=[1e3 * t for t in times],
                tokens_per_s=batch * seq / (ms / 1e3))


def _train_lm_config(torch, dev, arch, layers, q, batch, seq, log_):
    """One configuration of phase 19; returns (record, launches by
    program of the no-grad kernel-route forward)."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs.base import get_arch
    from repro_torch.core.secure_agg import mask_generator
    from repro_torch.data.tokens import synthetic_token_batches
    from repro_torch.launch import train as lt
    from repro_torch.models import model as lm
    from repro_torch.optim.delayed import leaf_delays
    from repro_torch.optim.tree import leaves, leaves_with_path, tree_map
    from repro_torch.sharding.api import Runtime
    cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
    name = f"phase 19 {arch}"
    rt = lt.build_runtime(q, reduced=False)
    kernel_rt = Runtime(model_size=q)
    params = lm.init_params(cfg, SEED, device=dev)
    n_params = sum(p.numel() for p in leaves(params))
    batches = [lt.to_device_batch(b, dev, cfg)
               for b in synthetic_token_batches(cfg.vocab, batch, seq,
                                                TRAIN_LM_STEPS, seed=SEED)]

    def gen(*key):
        return mask_generator(SEED, 19, *key, device=dev)

    res = {"config": dict(arch=arch, layers=layers, of_layers=get_arch(
        arch).n_layers, q=q, batch=batch, seq=seq, d_model=cfg.d_model,
        vocab=cfg.vocab, padded_vocab=cfg.padded_vocab, params=n_params,
        param_gb=4 * n_params / 1e9)}
    log_(f"{name}: {res['config']}")

    # (1) every leaf's gradient at full width, and one normalised step
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss0, grads = lt.loss_and_grads(rt, cfg, params, batches[0], gen(0))
    torch.cuda.synchronize()
    grad_peak = {"remat": torch.cuda.max_memory_allocated() / 1e9}
    check_idle(_libs(), f"{name}'s gradient")
    flat = leaves_with_path(grads)
    bad = [p for p, g in flat if not (bool(torch.isfinite(g).all())
                                      and bool((g != 0).any()))]
    check(not bad, f"{name}: leaves whose gradient is not finite or zero "
          f"everywhere: {bad}")
    gnorm = float(torch.sqrt(sum((g.double() ** 2).sum() for _, g in flat)))
    with torch.no_grad():
        base = float(lm.train_loss(rt, cfg, params, batches[0], gen(0)))
        redraw = abs(float(lm.train_loss(rt, cfg, params, batches[0],
                                         gen(1))) - base)
        pred = max(DESCENT_FLOOR, DESCENT_NOISE * redraw)

        def loss_after(p_len):
            eta = p_len / gnorm
            moved = tree_map(lambda p, g: p - (eta / gnorm) * g, params,
                             grads)
            return base - float(lm.train_loss(rt, cfg, moved, batches[0],
                                              gen(0)))

        drop = loss_after(pred)
        res["descent"] = dict(
            loss=float(loss0), loss_no_grad=base, grad_norm=gnorm,
            mask_redraw_change=redraw, predicted_drop=pred, eta=pred / gnorm,
            drop=drop, drop_at_quarter=loss_after(pred / 4),
            drop_at_four_times=loss_after(4 * pred),
            leaves=len(flat))
    log_(f"{name} gradient and descent: {res['descent']}")
    check(abs(float(loss0) - base) <= 1e-3 * base,
          f"{name}: the loss under grad {float(loss0)} and under no_grad "
          f"{base} differ")
    check(drop >= pred / 2,
          f"{name}: a step of η = {pred / gnorm} along −g/‖g‖ lowered the "
          f"loss by {drop}, less than half the predicted {pred} (a mask "
          f"redraw moves it by {redraw})")
    del grads, flat
    if arch == TRAIN_LM_NO_REMAT:
        # the same gradient keeping every activation: what remat saves
        torch.cuda.reset_peak_memory_stats()
        loss1, grads = lt.loss_and_grads(dataclasses.replace(rt, remat=False),
                                         cfg, params, batches[0], gen(0))
        torch.cuda.synchronize()
        grad_peak["no_remat"] = torch.cuda.max_memory_allocated() / 1e9
        check(abs(float(loss1) - float(loss0)) <= NO_REMAT_TOL * base,
              f"{name}: the loss without remat {float(loss1)} is not the "
              f"remat gradient's {float(loss0)}")
        del grads
    res["gradient_peak_gb"] = grad_peak
    log_(f"{name} peak memory of one gradient: {grad_peak} GB")
    if cfg.moe is not None:
        # the router's terms, summed over the layers, in the same loss
        with torch.no_grad():
            aux = lm._no_aux()
            lm._backbone(rt, cfg, params, lm._embed_tokens(
                rt, cfg, params, batches[0]["tokens"], gen(0)), aux=aux)
        res["aux"] = {k: float(v) for k, v in aux.items()}
        log_(f"{name} aux terms over {layers} layers: {res['aux']}")
        check(all(math.isfinite(v) and v > 0 for v in res["aux"].values()),
              f"{name}: lb_loss and z_loss must be finite and positive: "
              f"{res['aux']}")

    # (2) training runs: AdamW, then VFB²'s delayed SGD, from the start
    # (for TRAIN_LM_NO_REMAT AdamW once more, without remat)
    runs = {}
    specs = [("adamw", "adamw", TRAIN_LM_LR, rt),
             ("vfb2_sgd", "vfb2_sgd", TRAIN_LM_SGD_LR, rt)]
    if arch == TRAIN_LM_NO_REMAT:
        specs.append(("adamw_no_remat", "adamw", TRAIN_LM_LR,
                      dataclasses.replace(rt, remat=False)))
    reset_counts()                              # training path starts
    for run_name, opt_name, lr, run_rt in specs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        opt, update = lt.make_optimizer(opt_name, params, lr, TRAIN_LM_TAU)
        p, losses, times = params, [], []
        for i, b in enumerate(batches):
            if opt_name == "vfb2_sgd" and i == len(batches) - 1:
                before = [x.clone() for x in leaves(p)]
            t0 = time.perf_counter()
            loss, p, opt = lt.train_step(run_rt, cfg, p, opt, b, gen(2, i),
                                         update)
            losses.append(float(loss))           # synchronises
            times.append(time.perf_counter() - t0)
        run = dict(remat=run_rt.remat, losses=losses,
                   **_step_stats(times, batch, seq),
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        check(all(math.isfinite(v) for v in losses),
              f"{name} {run_name}: a loss is not finite: {losses}")
        if opt_name == "adamw":
            last = float(np.mean(losses[-3:]))
            run["drop"] = losses[0] - last
            check(run["drop"] >= TRAIN_LM_DROP,
                  f"{name} {run_name}: the mean of the last 3 losses "
                  f"{last} is not {TRAIN_LM_DROP} below the first "
                  f"{losses[0]}")
            keep = {}

            def profiled():
                keep["out"] = lt.train_step(run_rt, cfg, p, opt, batches[0],
                                            gen(3), update)

            run["profile"] = _device_profile(torch, profiled)
            _, p, opt = keep.pop("out")
            if run_name == "adamw":
                # kept for the checkpoint round trip only
                final = p if arch == TRAIN_LM_CKPT else None
            else:
                first = runs["adamw"]["losses"][0]
                run["first_loss_gap"] = abs(losses[0] - first)
                check(run["first_loss_gap"] <= NO_REMAT_TOL * abs(first),
                      f"{name}: the first loss without remat {losses[0]} "
                      f"is not the remat run's {first}")
        else:
            # the delays act as the md5 rule says: the last step moved
            # each leaf by its ring's slot of step 7 − d
            paths = _keystr_paths(params)
            want = {path: _md5_delay(path, TRAIN_LM_TAU) for path in paths}
            got = leaf_delays(params, TRAIN_LM_TAU)
            check(list(got) == paths and got == want,
                  f"{name}: per-leaf delays {got} != the md5 rule {want}")
            t = len(batches) - 1
            moved_ok = all(
                torch.equal(new, (old - lr * ring[max(t - want[path], 0)
                                                  % (TRAIN_LM_TAU + 1)]
                                  .float()).to(old.dtype))
                for path, old, new, ring in zip(
                    paths, before, leaves(p), leaves(opt["buf"])))
            check(moved_ok, f"{name} vfb2_sgd: a leaf's last update is not "
                  "its ring slot of step 7 − d")
            run["delays"] = dict(Counter(want.values()))
            del before
        runs[run_name] = run
        log_(f"{name} {run_name}: {run}")
        del opt, p
    train_launches = {prog: n for lib in _libs()
                      for prog, n in lib.launches.items() if n}
    check(not train_launches, f"{name}'s training steps launched "
          f"{train_launches}: they take the plain routes")
    res.update(runs)

    # (3) the kernels in the no-grad forward of the same train_loss
    with torch.no_grad():
        torch.cuda.synchronize()
        reset_counts()                          # main path starts
        t0 = time.perf_counter()
        k_loss = float(lm.train_loss(kernel_rt, cfg, params, batches[0],
                                     gen(0)))
        k_s = time.perf_counter() - t0
        launches = {prog: n for lib in _libs()  # main path ends
                    for prog, n in lib.launches.items()}
        t0 = time.perf_counter()
        r_loss = float(lm.train_loss(rt, cfg, params, batches[0], gen(0)))
        r_s = time.perf_counter() - t0
        # tolerance: each layer's kernel output may round one bf16 step
        # (2⁻⁸ relative) away from the plain route's, so the final hidden
        # state h (‖h‖ = √D after the norm) moves by at most layers·2⁻⁸·√D;
        # a token's CE moves by (p − 1̂)ᵀW δh, about ‖w‖·‖δh‖/√D for a δh
        # unaligned with the label's row w: layers·2⁻⁸·(rms row norm of
        # the table)
        w_rms = float(params["embed"].float().pow(2).sum(1).mean().sqrt())
        tol = layers * BF16_ULP * w_rms
        if cfg.moe is not None:
            # a token's routing may flip between the two routes where its
            # k-th and (k+1)-th router probabilities nearly tie, as it may
            # under a redraw of the masks: twice the loss's change under a
            # redraw, as phase 10 holds the hidden states
            tol = max(tol, 2 * redraw)
    prog = "selective_scan" if cfg.arch_type == "ssm" else "flash_attention"
    res["kernel_forward"] = dict(
        kernel_loss=k_loss, reference_loss=r_loss,
        gap=abs(k_loss - r_loss), tolerance=tol, table_rms_row_norm=w_rms,
        kernel_ms=1e3 * k_s, reference_ms=1e3 * r_s, launches={
            k: v for k, v in launches.items() if v})
    log_(f"{name} no-grad train_loss, kernel route vs plain: "
         f"{res['kernel_forward']}")
    check(launches[prog] == layers and sum(launches.values()) == layers,
          f"{name}: the kernel-route train_loss launched {launches}, want "
          f"{prog} {layers} times (once a layer) and nothing else")
    check(abs(k_loss - r_loss) <= tol,
          f"{name}: kernel-route loss {k_loss} vs plain {r_loss}, beyond "
          f"{tol}")
    del params

    # (4) TRAIN_LM_CKPT's final AdamW parameters through a checkpoint and
    # back
    if final is None:
        del batches
        torch.cuda.empty_cache()
        return res, launches
    ck = ROOT / "results" / f"lm_train_{arch}"
    t0 = time.perf_counter()
    save_checkpoint(str(ck), {"params": final}, step=TRAIN_LM_STEPS + 1)
    back = load_checkpoint(str(ck), {"params": final})
    same = all(np.array_equal(np.asarray(b), a.cpu().numpy())
               for a, b in zip(leaves(final), leaves(back)))
    shutil.rmtree(ck, ignore_errors=True)
    res["checkpoint"] = dict(bit_equal=same,
                             seconds=time.perf_counter() - t0)
    log_(f"{name} checkpoint: {res['checkpoint']}")
    check(same, f"{name}: the checkpoint did not load back bit-equal")
    del final, back, batches
    torch.cuda.empty_cache()
    return res, launches


def lm_train_phase(torch, dev, log_):
    """Phase 19; returns (record, launches by program of the no-grad
    kernel-route forwards, summed)."""
    res, launches = {}, Counter()
    for arch, layers, q, batch, seq in TRAIN_LM:
        t0 = time.perf_counter()
        res[arch], got = _train_lm_config(torch, dev, arch, layers, q, batch,
                                          seq, log_)
        res[arch]["seconds"] = time.perf_counter() - t0
        launches.update(got)
    return res, dict(launches)


# ---------------------------------------------------------------------------
# phase 20: MoE serving
# ---------------------------------------------------------------------------

def _moe_oracle(torch, p, h, m, got):
    """An MoE layer (``apply_moe_sharded``'s output ``got`` on the normed
    input h (B, S, D) bf16) against the plain per-expert oracle in f32:
    route, each expert's SwiGLU on its assigned rows (the first
    ``capacity`` in token order; the rest dropped), the gate-weighted sum.
    A token whose selection differs from the port's ``_route`` must be
    undecided (its k-th and (k+1)-th oracle probabilities within
    MOE_ROUTE_MARGIN); it moves the bucket positions of its experts'
    later assignments, so those later tokens are left out with it.  All
    other tokens are compared, those with dropped assignments too."""
    from repro_torch.models import moe
    d = h.shape[-1]
    xt = h.reshape(-1, d).float()
    t, e, k = xt.shape[0], m.n_experts, m.top_k
    probs = torch.softmax(xt @ p["router"].float(), -1)
    gates, sel = torch.topk(probs, k, -1)
    gates = gates / gates.sum(-1, keepdim=True)
    cap = moe.capacity(m.capacity_factor, k, t, e)
    want = torch.zeros_like(xt)
    kept = torch.ones(t, dtype=torch.bool, device=h.device)
    dropped = 0
    silu = torch.nn.functional.silu
    for j in range(e):
        tok, slot = (sel == j).nonzero(as_tuple=True)   # in token order
        kept[tok[cap:]] = False
        dropped += max(0, tok.numel() - cap)
        tok, slot = tok[:cap], slot[:cap]
        x = xt[tok]
        y = (silu(x @ p["w_gate"][j]) * (x @ p["w_up"][j])) @ p["w_down"][j]
        want.index_add_(0, tok, gates[tok, slot, None] * y)
    mine, _, _ = moe._route(p["router"], h.reshape(-1, d), k)
    same = (mine.sort(-1).values == sel.sort(-1).values).all(-1)
    top = probs.topk(k + 1, -1).values
    undecided = (top[:, k - 1] - top[:, k]) <= MOE_ROUTE_MARGIN
    diff = (~same).nonzero().flatten()
    moved = torch.zeros_like(same)
    if diff.numel():
        # each expert's first token (in token order) routed otherwise
        first = torch.full((e,), t, dtype=torch.long, device=h.device)
        either = torch.cat([sel[diff], mine[diff]], 1)
        first.scatter_reduce_(0, either.flatten(),
                              diff.repeat_interleave(2 * k), "amin")
        moved = (torch.arange(t, device=h.device)[:, None]
                 > first[sel]).any(-1)
    use = same & ~moved
    g = got.reshape(-1, d).float()
    return dict(max_abs_err=float((g[use] - want[use]).abs().max()),
                oracle_max=float(want[use].abs().max()),
                rel_l2=_rel_l2(g[use], want[use]),
                compared_share=float(use.float().mean()),
                kept_share=float(kept.float().mean()),
                selection_differs=int((~same).sum()),
                selection_differs_decided=int((~same & ~undecided).sum()),
                undecided=int(undecided.sum()),
                dropped=dropped, assignments=t * k, capacity=cap)


def moe_phase(torch, dev, log_):
    """Phase 20; returns (record, launches of the serve call by
    program)."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.configs.inputs import make_batch
    from repro_torch.core.secure_agg import mask_generator
    from repro_torch.kernels import decode_attention as dak
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.models import model as lm
    from repro_torch.models import moe
    from repro_torch.optim.tree import leaves
    from repro_torch.sharding.api import Runtime
    full = get_arch(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    m, layers = cfg.moe, MOE_LAYERS
    kw = dict(batch=MOE_BATCH, prompt_len=MOE_PROMPT, gen_tokens=MOE_GEN,
              reduced=False, model_parallel=MOE_Q, seed=SEED,
              n_layers=MOE_LAYERS)
    res = {"config": dict(
        arch=MOE_ARCH, layers=layers, of_layers=full.n_layers, q=MOE_Q,
        batch=MOE_BATCH, prompt=MOE_PROMPT, generated=MOE_GEN,
        d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv,
        d_head=cfg.head_dim, experts=m.n_experts, top_k=m.top_k,
        d_expert=m.d_expert, capacity_factor=m.capacity_factor,
        capacity=moe.capacity(m.capacity_factor, m.top_k,
                              MOE_BATCH * MOE_PROMPT, m.n_experts),
        vocab=cfg.vocab, padded_vocab=cfg.padded_vocab,
        dispatch="replicated")}
    steps = MOE_GEN - 1
    calls, launches, _ = _serve_twice(torch, MOE_ARCH, kw, 20, log_)
    res.update(calls)
    check(launches["flash_attention"] == layers
          and launches["decode_attention"] == layers * steps,
          f"serve launched flash_attention {launches['flash_attention']} "
          f"times (want {layers}, once per layer of the prefill) and "
          f"decode_attention {launches['decode_attention']} (want "
          f"{layers} x {steps} decode steps)")
    check_idle(_libs()[:2], "MoE LM serving")
    torch.cuda.empty_cache()

    rt = Runtime(model_size=MOE_Q)
    with torch.no_grad():
        params = lm.init_params(cfg, SEED, device=dev)
        n_params = sum(p.numel() for p in leaves(params))
        res["config"].update(params=n_params, param_gb=4 * n_params / 1e9)
        batch = make_batch(cfg, ShapeConfig("moe", MOE_PROMPT, MOE_BATCH,
                                            "prefill"), rt, seed=SEED,
                           device=dev)
        gen = mask_generator(SEED, 20, device=dev)
        reset_counts()
        tok, kv = lm.prefill(rt, cfg, params, batch, gen)
        torch.cuda.synchronize()
        per_prefill = (fak.KERNEL.launches["flash_attention"],
                       dak.KERNEL.launches["decode_attention"])
        cache = lm.init_cache(rt, cfg, MOE_BATCH, MOE_PROMPT + MOE_GEN,
                              device=dev)
        for name, val in kv.items():
            cache[name][:, :, :MOE_PROMPT].copy_(val)
        del kv
        step = {"token": tok, "pos": MOE_PROMPT, "cache": cache}
        reset_counts()
        lm.decode_step(rt, cfg, params, step, gen)
        torch.cuda.synchronize()
        per_step = (fak.KERNEL.launches["flash_attention"],
                    dak.KERNEL.launches["decode_attention"])
        check(per_prefill == (layers, 0) and per_step == (0, layers),
              f"launches (flash, decode): {per_prefill} per prefill (want "
              f"({layers}, 0)), {per_step} per decode step (want (0, "
              f"{layers}))")
        res["kernel_vs_reference"] = _prefill_walk(
            torch, cfg, params, batch, gen, tok, MOE_Q, 20, log_)
        res["profile"] = _profile_windows(torch, {
            "prefill": lambda: lm.prefill(rt, cfg, params, batch, gen),
            "decode_step": lambda: lm.decode_step(rt, cfg, params, step,
                                                  gen)}, 20, log_)
        del params, cache, step
    torch.cuda.empty_cache()
    return res, launches


# ---------------------------------------------------------------------------
# phase 21: hybrid (period stack) serving
# ---------------------------------------------------------------------------

def _decode_walk(torch, cfg, params, cache, token, pos, q, gen):
    """One decode step at ``pos`` layer by layer on ``cache`` (as a serve
    call left it): at each attention layer the kernel route
    (``decode_attention`` over q shards) against the plain one on the
    same input and on copies of the same cache, and so for an
    encoder-decoder's cross attention over its read-only cross cache at
    enc_seq − 1; every SSM layer's new state finite.  The stream advances
    on the kernel routes, writing the cache in place as ``decode_step``
    does."""
    from repro_torch.models import model as lm
    from repro_torch.models.layers import rms_norm
    from repro_torch.sharding.api import Runtime
    kern = Runtime(model_size=q)
    plain = Runtime(model_size=q, attn_impl="reference")
    caches, kinds, _ = lm._stacks(cfg, cache)
    s_cache = next(c["k"].shape[2] for c in caches if "k" in c)
    pos_t = torch.full((), pos, dtype=torch.int32, device=token.device)
    xpos_t = torch.full((), cfg.enc_seq - 1, dtype=torch.int32,
                        device=token.device)
    x = lm._embed_tokens(kern, cfg, params, token[:, None], gen)[:, 0]
    rows = []

    def held(i, kind, mixer, outs):
        err = (outs[0].float() - outs[1].float()).abs()
        rows.append(dict(
            layer=i, kind=kind, mixer=mixer, max_abs_err=float(err.max()),
            beyond_tol=int((err > LM_TOL + LM_TOL
                            * outs[1].float().abs()).sum())))

    for i, kind, p in lm._blocks(cfg, params):
        c = lm._layer(caches[i % len(kinds)], i // len(kinds))
        if kind.startswith("attn"):
            h = rms_norm(x, p["norm1"])
            outs = []
            for rt in (kern, plain):
                kc, vc = c["k"].clone(), c["v"].clone()
                outs.append(lm._decode_attention(rt, cfg, p["attn"], h, kc,
                                                 vc, pos, pos_t, s_cache))
            held(i, kind, "self", outs)
            if "xattn" in p:
                hx = rms_norm(x + outs[0], p["norm_x"])
                held(i, kind, "cross", [lm._decode_attention(
                    rt, cfg, p["xattn"], hx, c["xk"], c["xv"],
                    cfg.enc_seq - 1, xpos_t, None, cross=True)
                    for rt in (kern, plain)])
        x, new = lm._block_decode(kern, cfg, kind, p, x, c, pos, pos_t,
                                  s_cache, xpos_t)
        if not kind.startswith("attn"):
            rows.append(dict(layer=i, kind=kind, state_finite=all(
                bool(torch.isfinite(v.float()).all()) for v in new.values())))
    torch.cuda.synchronize()
    return rows


def _teacher_forced(torch, cfg, params, tokens, q, gen):
    """The first ``tokens.shape[1]`` prompt tokens decoded one at a time
    from ``init_cache``'s zeros (a cache of the serve call's length) on
    the kernel routes, against the full forward over them
    (``_decode_vs_forward``), the MoE layers at cf = E/k (capacity = the
    tokens: the forward's buckets drop nothing that a decode step would
    keep)."""
    from repro_torch.models import model as lm
    from repro_torch.sharding.api import Runtime
    m = cfg.moe
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))
    rt = Runtime(model_size=q)
    cache = lm.init_cache(rt, cfg, tokens.shape[0],
                          HYBRID_PROMPT + HYBRID_GEN, device=tokens.device)
    dec = []
    for t in range(tokens.shape[1]):
        tok, cache = lm.decode_step(rt, cfg, params, {
            "token": tokens[:, t], "pos": t, "cache": cache}, gen)
        dec.append(tok)
    hf = lm._backbone(rt, cfg, params,
                      lm._embed_tokens(rt, cfg, params, tokens, gen))
    return _decode_vs_forward(torch, rt, cfg, params, torch.stack(dec, 1),
                              hf)


def hybrid_phase(torch, dev, log_):
    """Phase 21; returns (record, launches of the serve call by
    program)."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.configs.inputs import make_batch
    from repro_torch.core.secure_agg import mask_generator
    from repro_torch.models import model as lm
    from repro_torch.models import moe
    from repro_torch.optim.tree import leaves
    from repro_torch.sharding.api import Runtime
    full = get_arch(HYBRID_ARCH)
    cfg = dataclasses.replace(full, n_layers=HYBRID_LAYERS)
    m = cfg.moe
    kinds = lm.layer_kinds(cfg)
    n_attn = sum(k.startswith("attn") for k in kinds)
    steps = HYBRID_GEN - 1
    kw = dict(batch=HYBRID_BATCH, prompt_len=HYBRID_PROMPT,
              gen_tokens=HYBRID_GEN, reduced=False, model_parallel=HYBRID_Q,
              seed=SEED, n_layers=HYBRID_LAYERS)
    res = {"config": dict(
        arch=HYBRID_ARCH, layers=HYBRID_LAYERS, of_layers=full.n_layers,
        period=list(cfg.period), q=HYBRID_Q, batch=HYBRID_BATCH,
        prompt=HYBRID_PROMPT, generated=HYBRID_GEN, d_model=cfg.d_model,
        heads=cfg.n_heads, kv_heads=cfg.n_kv, d_head=cfg.head_dim,
        d_ff=cfg.d_ff, experts=m.n_experts, top_k=m.top_k,
        d_expert=m.d_expert, capacity_factor=m.capacity_factor,
        capacity=moe.capacity(m.capacity_factor, m.top_k,
                              HYBRID_BATCH * HYBRID_PROMPT, m.n_experts),
        d_state=cfg.ssm.d_state, d_inner=cfg.ssm.expand * cfg.d_model,
        vocab=cfg.vocab, padded_vocab=cfg.padded_vocab,
        dispatch="replicated")}
    want = {"selective_scan": len(kinds) - n_attn, "flash_attention": n_attn,
            "decode_attention": n_attn * steps}
    calls, launches, out = _serve_twice(torch, HYBRID_ARCH, kw, 21, log_)
    res.update(calls)
    check({p: n for p, n in launches.items() if n} == want,
          f"serve launched {launches}; want exactly {want} (the scan once "
          "per SSM layer of the prefill, flash attention once per "
          "attention layer of the prefill, decode attention once per "
          f"attention layer of each of the {steps} decode steps)")
    check_idle(_libs()[:1], "hybrid LM serving")
    check(isinstance(out.cache, list), "the period stack's decode state "
          "is not the reference's list")
    serve_cache = out.cache
    last = torch.as_tensor(out.tokens[:, -1], device=dev)
    del out
    torch.cuda.empty_cache()

    rt = Runtime(model_size=HYBRID_Q)
    with torch.no_grad():
        params = lm.init_params(cfg, SEED, device=dev)
        n_params = sum(p.numel() for p in leaves(params))
        res["config"].update(params=n_params, param_gb=4 * n_params / 1e9)
        batch = make_batch(cfg, ShapeConfig("hybrid", HYBRID_PROMPT,
                                            HYBRID_BATCH, "prefill"), rt,
                           seed=SEED, device=dev)
        gen = mask_generator(SEED, 21, device=dev)

        # one decode step after the serve call's 31, layer by layer
        res["decode_walk"] = _decode_walk(
            torch, cfg, params, serve_cache, last,
            HYBRID_PROMPT + HYBRID_GEN - 1, HYBRID_Q, gen)
        log_(f"phase 21 decode step layer by layer: {res['decode_walk']}")
        for r in res["decode_walk"]:
            check(r.get("beyond_tol", 0) == 0 and r.get("state_finite", True),
                  f"phase 21 decode layer {r}: want the kernel route's "
                  f"attention within atol = rtol = {LM_TOL} of the plain "
                  "route's on the same input and cache, and every SSM "
                  "state finite")
        del serve_cache

        tf = res["decode_vs_forward"] = _teacher_forced(
            torch, cfg, params, batch["tokens"][:, :HYBRID_TEACHER],
            HYBRID_Q, gen)
        log_(f"phase 21 teacher-forced decode vs forward: {tf}")
        if tf["decided"] == 0:
            log_("phase 21: no teacher-forced position's margin decides "
                 "it; the decode-vs-forward check compared none")
        check(tf["agreement"] is None or tf["agreement"] >= 0.95,
              f"decode against the forward pass: {tf['agreement']} of "
              f"{tf['decided']} decided positions agree (want >= 0.95)")

        tok, cache = lm.prefill(rt, cfg, params, batch, gen)
        check(cache is None, "the period stack's prefill returned a cache "
              "(C.R6)")
        res["kernel_vs_reference"] = _prefill_walk(
            torch, cfg, params, batch, gen, tok, HYBRID_Q, 21, log_)
        step = {"token": tok, "pos": HYBRID_PROMPT,
                "cache": lm.init_cache(rt, cfg, HYBRID_BATCH,
                                       HYBRID_PROMPT + HYBRID_GEN,
                                       device=dev)}
        res["profile"] = _profile_windows(torch, {
            "prefill": lambda: lm.prefill(rt, cfg, params, batch, gen),
            "decode_step": lambda: lm.decode_step(rt, cfg, params, step,
                                                  gen)}, 21, log_)
        del params, step
    torch.cuda.empty_cache()
    return res, launches


# ---------------------------------------------------------------------------
# phase 22: cross attention and the secure frontends
# ---------------------------------------------------------------------------

def _frontend_model(torch, dev, arch, batch, prompt, log_):
    """One model of phase 22; returns (record, launches of the counted
    serve call by program)."""
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.configs.inputs import make_batch
    from repro_torch.core.secure_agg import mask_generator
    from repro_torch.kernels import decode_attention as dak
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.models import model as lm
    from repro_torch.optim.tree import leaves
    from repro_torch.sharding.api import Runtime
    from repro_torch.vfl.embed import secure_feature_project
    cfg, q = get_arch(arch), FRONTEND_Q
    name = f"phase 22 {arch}"
    # flash attention: each encoder layer, and each decoder layer's self
    # (and cross) attention, once a prefill; decode attention each decoder
    # layer's self (and cross) attention once a step
    per_step = cfg.n_layers * (2 if cfg.enc_dec else 1)
    per_prefill = per_step + cfg.enc_layers
    steps = FRONTEND_GEN - 1
    kw = dict(batch=batch, prompt_len=prompt, gen_tokens=FRONTEND_GEN,
              reduced=False, model_parallel=q, seed=SEED)
    res = {"config": dict(
        arch=arch, q=q, batch=batch, prompt=prompt, generated=FRONTEND_GEN,
        layers=cfg.n_layers, encoder_layers=cfg.enc_layers,
        encoder_positions=cfg.enc_seq, patches=cfg.n_patches,
        text_tokens=prompt - cfg.n_patches, d_model=cfg.d_model,
        heads=cfg.n_heads, kv_heads=cfg.n_kv, d_head=cfg.head_dim,
        d_ff=cfg.d_ff, vocab=cfg.vocab, padded_vocab=cfg.padded_vocab)}
    want = {"flash_attention": per_prefill,
            "decode_attention": per_step * steps}
    calls, launches, out = _serve_twice(torch, arch, kw, f"22 {arch}", log_)
    res.update(calls)
    check({p: n for p, n in launches.items() if n} == want,
          f"{name}: serve launched {launches}; want exactly {want} (flash "
          "attention once per attention of the prefill, decode attention "
          f"once per decoder attention of each of the {steps} steps)")
    check_idle(_libs()[:2], f"{name} serving")
    if cfg.enc_dec:
        pad = [out.cache[n][:, :, cfg.enc_seq:] for n in ("xk", "xv")]
        check(all(not bool(t.any()) for t in pad),
              f"{name}: decoding wrote into the cross cache's padding")
    del out
    torch.cuda.empty_cache()

    rt = Runtime(model_size=q)
    with torch.no_grad():
        params = lm.init_params(cfg, SEED, device=dev)
        n_params = sum(p.numel() for p in leaves(params))
        res["config"].update(params=n_params, param_gb=4 * n_params / 1e9)
        inputs = make_batch(cfg, ShapeConfig("frontend", prompt, batch,
                                             "prefill"), rt, seed=SEED,
                            device=dev)
        gen = mask_generator(SEED, 22, device=dev)

        # (1) the parties' secure projection against the unmasked f32
        # product of the same bf16 operands
        proj, feat = ("enc_proj", "frames") if cfg.enc_dec \
            else ("patch_proj", "patches")
        got = secure_feature_project(rt, params[proj], inputs[feat], gen)
        want_p = inputs[feat].float() @ params[proj].to(torch.bfloat16).float()
        err = float((got.float() - want_p).abs().max())
        res["projection"] = dict(
            shape=list(got.shape), max_abs_err=err,
            ref_max=float(want_p.abs().max()),
            rel_l2=_rel_l2(got, want_p), tolerance=PROJ_TOL)
        log_(f"{name} secure projection: {res['projection']}")
        check(err <= PROJ_TOL * res["projection"]["ref_max"],
              f"{name}: the secure projection {res['projection']}")
        del got, want_p

        # (2) launches per prefill and per decode step; teacher-forced
        # decode after the prefill against the forward over the prompt and
        # the teacher tokens (the same frames or patches)
        reset_counts()
        tok, kv = lm.prefill(rt, cfg, params, inputs, gen)
        torch.cuda.synchronize()
        counted = [(fak.KERNEL.launches["flash_attention"],
                    dak.KERNEL.launches["decode_attention"])]
        cache = lm.init_cache(rt, cfg, batch, prompt + FRONTEND_GEN,
                              device=dev)
        for n, val in kv.items():
            cache[n][:, :, :val.shape[2]].copy_(val)
        del kv
        teacher = torch.as_tensor(np.random.default_rng(SEED + 1).integers(
            0, cfg.vocab, (batch, FRONTEND_TEACHER)), device=dev)
        dec = [tok]
        reset_counts()
        for i in range(FRONTEND_TEACHER):
            t, cache = lm.decode_step(
                rt, cfg, params, {"token": teacher[:, i], "pos": prompt + i,
                                  "cache": cache}, gen)
            dec.append(t)
        torch.cuda.synchronize()
        counted.append((fak.KERNEL.launches["flash_attention"],
                        dak.KERNEL.launches["decode_attention"]))
        check(counted == [(per_prefill, 0), (0, per_step * FRONTEND_TEACHER)],
              f"{name}: launches (flash, decode) {counted}, want "
              f"({per_prefill}, 0) a prefill and (0, {per_step}) a decode "
              f"step over {FRONTEND_TEACHER} steps")
        full = dict(inputs, tokens=torch.cat([inputs["tokens"], teacher], 1))
        x, enc_out, _ = lm._prepare_inputs(rt, cfg, params, full, gen)
        hf = lm._backbone(rt, cfg, params, x, enc_out=enc_out)[:, prompt - 1:]
        del x, enc_out
        tf = res["decode_vs_forward"] = _decode_vs_forward(
            torch, rt, cfg, params, torch.stack(dec, 1), hf)
        log_(f"{name} teacher-forced decode vs forward: {tf}")
        check(tf["decided"] and tf["agreement"] >= 0.95,
              f"{name}: decode against the forward pass: {tf['agreement']} "
              f"of {tf['decided']} decided positions agree (want >= 0.95)")
        del hf

        # (3) one more decode step layer by layer on that cache: each
        # self and cross attention's kernel route against the plain one
        res["decode_walk"] = _decode_walk(
            torch, cfg, params, cache, dec[-1], prompt + FRONTEND_TEACHER,
            q, gen)
        log_(f"{name} decode step layer by layer: {res['decode_walk']}")
        for r in res["decode_walk"]:
            check(r["beyond_tol"] == 0,
                  f"{name} decode layer {r}: want the kernel route within "
                  f"atol = rtol = {LM_TOL} of the plain route's on the same "
                  "input and cache")
        del cache
        torch.cuda.empty_cache()

        # (4) the prefill walked layer by layer, end to end
        res["kernel_vs_reference"] = _prefill_walk(
            torch, cfg, params, inputs, gen, tok, q, f"22 {arch}", log_)
        step = {"token": tok, "pos": prompt,
                "cache": lm.init_cache(rt, cfg, batch, prompt + FRONTEND_GEN,
                                       device=dev)}
        res["profile"] = _profile_windows(torch, {
            "prefill": lambda: lm.prefill(rt, cfg, params, inputs, gen),
            "decode_step": lambda: lm.decode_step(rt, cfg, params, step,
                                                  gen)}, f"22 {arch}", log_)
        del step
        if cfg.enc_dec:
            torch.cuda.empty_cache()
            res["unroll"] = _unroll_check(torch, dev, cfg, params, inputs,
                                          q, FRONTEND_UNROLL, prompt,
                                          f"22 {arch}", log_)
        del params
    torch.cuda.empty_cache()
    return res, launches


def frontend_phase(torch, dev, log_):
    """Phase 22; returns (record, launches of its serve calls by program,
    summed)."""
    res, launches = {}, Counter()
    for arch, batch, prompt in FRONTENDS:
        t0 = time.perf_counter()
        res[arch], got = _frontend_model(torch, dev, arch, batch, prompt,
                                         log_)
        res[arch]["seconds"] = time.perf_counter() - t0
        log_(f"phase 22 {arch}: {res[arch]['seconds']:.1f} s")
        launches.update(got)
    return res, dict(launches)


# ---------------------------------------------------------------------------
# phase 23: the dry run against the card
# ---------------------------------------------------------------------------

# each predicted peak within DRY_TOL of the card's max_memory_allocated
# over the same step (less what the process held before the step's
# arguments were made)
DRY_TOL = 0.10
# host processes for the fake passes: falcon's (its plain scan's fake
# operations, about half a minute of a host core at one layer) in one,
# the other cases in the others.  They start with phase 23, after the
# last timed phase, and run beside its steps on the card, which time
# nothing
DRY_POOL = 3
# phase 23 runs phase 19's training configurations with these depths cut
# further: falcon's four layers took its fake pass 106-140 s, one a
# quarter of that, and the checks are the same at any depth
DRY_LAYERS = {"falcon_mamba_7b": 1}


def _dry_cases():
    """Phase 23's steps: (name, arch, layers or None for the whole model,
    q, batch, seq, mode, remat).  Phase 19's AdamW steps (gemma3 also
    without remat; falcon at ``DRY_LAYERS``' depth), and a prefill and a
    decode step at phase 10's gemma3 and phase 21's jamba shapes (decode
    on the serve call's cache length, prompt + generated tokens)."""
    train = [(a, DRY_LAYERS.get(a, n), q, b, s)
             for a, n, q, b, s in TRAIN_LM]
    cases = [(f"train {a} x{n}", a, n, q, b, s, "train", True)
             for a, n, q, b, s in train]
    cases += [(f"train {a} x{n} no remat", a, n, q, b, s, "train", False)
              for a, n, q, b, s in train if a == TRAIN_LM_NO_REMAT]
    for arch, layers, q, b, prompt, gen in (
            (DENSE_ARCH, None, DENSE_Q, DENSE_BATCH, DENSE_PROMPT, DENSE_GEN),
            (HYBRID_ARCH, HYBRID_LAYERS, HYBRID_Q, HYBRID_BATCH,
             HYBRID_PROMPT, HYBRID_GEN)):
        cases.append((f"prefill {arch}", arch, layers, q, b, prompt,
                       "prefill", True))
        cases.append((f"decode {arch}", arch, layers, q, b, prompt + gen,
                       "decode", True))
    return cases


def _dry_step(case, device):
    """(step, args) of a phase 23 case on ``device``, through
    ``launch.dryrun.build_step``: ``launch.train``'s runtime for a train
    step (the plain routes), the kernel routes for serving."""
    import torch
    from repro_torch.configs.base import ShapeConfig, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as lt
    from repro_torch.sharding.api import Runtime
    name, arch, layers, q, b, s, mode, remat = case
    cfg = get_arch(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    rt = lt.build_runtime(q, reduced=False) if mode == "train" \
        else Runtime(model_size=q)
    rt = dataclasses.replace(rt, remat=remat)
    return dryrun.build_step(cfg, ShapeConfig(name, s, b, mode), rt,
                             device=torch.device(device))


def _dry_fake(case):
    """A phase 23 case's prediction over fake tensors (in a host process
    of its own, one torch thread)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    with FakeTensorMode():
        cost = dryrun.measure(*_dry_step(case, "cpu"))
    return dict(dataclasses.asdict(cost), seconds=time.perf_counter() - t0)


def _dry_card(torch, dev, case):
    """The same step on the card, once, under ``FlopCounterMode``: the
    caching allocator's peak, the launches counted and the aten FLOPs."""
    from torch.utils.flop_counter import FlopCounterMode
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    step, args = _dry_step(case, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                               # phase 23 path starts
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        step(*args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {prog: n for lib in _libs()      # phase 23 path ends
                for prog, n in lib.launches.items() if n}
    peak = torch.cuda.max_memory_allocated()
    del step, args
    torch.cuda.empty_cache()
    return dict(held_bytes=held, max_memory_allocated=peak,
                step_peak_bytes=peak - held, aten_flops=fc.get_total_flops(),
                launches=launches, seconds=seconds)


def dry_phase(torch, dev, log_):
    """Phase 23: the fake passes in ``DRY_POOL`` spawned host processes
    while the card runs the same steps; returns (record, launches by
    program of its serving steps on the card).  The pool is stopped on
    the way out."""
    import multiprocessing
    cases = _dry_cases()
    res, launches = {}, Counter()
    pool = multiprocessing.get_context("spawn").Pool(DRY_POOL)
    try:
        pending = pool.map_async(_dry_fake, cases, chunksize=1)
        cards = [_dry_card(torch, dev, case) for case in cases]
        t0 = time.perf_counter()
        fakes = pending.get(timeout=900)
        res["waited_for_fakes_s"] = time.perf_counter() - t0
    finally:
        pool.terminate()
        pool.join()
    log_(f"phase 23: the card's steps done, then {res['waited_for_fakes_s']:.1f}"
         " s waiting for the fake passes")
    for case, fake, card in zip(cases, fakes, cards):
        name, mode = case[0], case[6]
        ratio = fake["peak_bytes"] / card["step_peak_bytes"]
        row = dict(case=list(case[1:]), predicted=fake, card=card,
                   peak_ratio=ratio,
                   aten_flops_equal=fake["aten_flops"] == card["aten_flops"],
                   launches_equal=fake["kernel_launches"] == card["launches"])
        res[name] = row
        log_(f"phase 23 {name}: predicted peak {fake['peak_bytes'] / 1e9:.3f}"
             f" GB, card {card['step_peak_bytes'] / 1e9:.3f} GB (held before "
             f"{card['held_bytes'] / 1e9:.3f}), ratio {ratio:.4f}; aten FLOPs "
             f"predicted {fake['aten_flops']:.6e}, card "
             f"{card['aten_flops']:.6e}; kernel launches predicted "
             f"{fake['kernel_launches']}, card {card['launches']}; fake pass "
             f"{fake['seconds']:.1f} s, card step {card['seconds']:.1f} s")
        check(abs(ratio - 1) <= DRY_TOL,
              f"phase 23 {name}: predicted peak {fake['peak_bytes']} bytes "
              f"against the card's {card['step_peak_bytes']}: ratio {ratio}"
              f" beyond 1 ± {DRY_TOL}")
        check(row["launches_equal"],
              f"phase 23 {name}: the fake route's launches "
              f"{fake['kernel_launches']} != the card's {card['launches']}")
        if mode == "train":
            check(row["aten_flops_equal"],
                  f"phase 23 {name}: predicted aten FLOPs "
                  f"{fake['aten_flops']} != the card's "
                  f"{card['aten_flops']}")
        else:
            launches.update(card["launches"])
    return res, dict(launches)


# ---------------------------------------------------------------------------
# phase 24: the device party mesh
# ---------------------------------------------------------------------------

# 24(a): PartyMesh(q=8, slots=cards) over NCCL, one rank a card, on phase
# 7's data; each epoch runs this prefix of phase 7's schedule, and the
# masked modes are held to the mesh=None engine within DIST_TOL
DIST_STEPS, DIST_TOL = 2000, 1e-5
DIST_PROFILE_STEPS = 500         # 24(a)'s profiler windows, each engine
DIST_SERVE_IDS = 4 * BATCH       # requests of 24(a)'s serve calls
# 24(a)'s deep and bounded-delay epochs: this prefix of the schedule, at
# phase 11's τ and seed-0 delays, from the deep start of phases 12-13
DIST_DEEP_STEPS, DIST_TAU = 500, STALE_TAU
DIST_DEEP_KINDS = ("deep_sgd", "deep_svrg", "deep_pipelined_sgd",
                   "deep_pipelined_svrg", "delayed_sgd", "deep_delayed_sgd")
# 24(b): four gloo ranks sharing the card, one party each, eager steps
DIST_GLOO_RANKS, DIST_GLOO_STEPS = 4, 300
DIST_GLOO_DEEP_STEPS = 100       # 24(b)'s deep SGD and delayed epochs
DIST_TIMEOUT = 300               # seconds a world may take
# 24(a)'s faulted and guarded epochs: this prefix of phase 7's schedule on
# the prefix of phases 14-15's random_trace(seed=0) windows (the guarded
# one with its NaN and Inf codes: an Inf at step 104, a NaN at 222), at
# phase 11's τ and seed-0 delays, from w = 0 and the deep start
DIST_FAULT_STEPS = 250
DIST_FAULT_KINDS = tuple(f"{k}_{a}" for k in ("faulted", "guarded")
                         for a in ("sgd", "svrg", "saga")) \
    + tuple(f"deep_{k}_{a}" for k in ("faulted", "guarded")
            for a in ("sgd", "svrg"))
DIST_FAULT_TIMED = ("faulted_sgd", "guarded_sgd", "deep_guarded_sgd")
# 24(b)'s: 100 eager steps each of faulted, guarded and deep guarded SGD
# on a q = 4 trace with more corruptions (a NaN or Inf partial per party
# and step at 0.02), and one run_guarded_fused epoch of 100 steps
DIST_GLOO_FAULT_STEPS, DIST_GLOO_P_CORRUPT = 100, 0.02
DIST_GLOO_FAULT_KINDS = ("faulted_sgd", "guarded_sgd", "deep_guarded_sgd")
# the counter stream's words on the card against the CPU's: counters and
# normals of the ring's survivor-rank stream
DIST_STREAM_BLOCKS, DIST_STREAM_NUMEL, DIST_STREAM_TOL = 65_536, 4_096, 1e-6


def _dist_world(rank, world, backend, base, part):
    """One rank of a phase 24 world (spawned): its card, the process group
    over a file store in ``base``, the part's cases; its record goes to
    ``base/rank<rank>.json``."""
    import os

    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    torch.cuda.set_device(rank % torch.cuda.device_count())
    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=f"file://{base}/store",
                            rank=rank, world_size=world)
    try:
        res = (_dist_nccl if part == "a" else _dist_gloo)(torch, dev)
        Path(base, f"rank{rank}.json").write_text(json.dumps(res))
        dist.barrier()              # no rank leaves while another sends
    finally:
        dist.destroy_process_group()


def _dist_data(torch, dev):
    """Phase 7's resident data: x (N, D) from the seed, the D4 labels."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((N, D), generator=gen, device=dev)
    return x, d4_labels(torch, dev, x)


def _dist_epoch(torch, e, algo, idx, key):
    """``algo``'s epoch from w = 0 (SVRG from its full gradient, SAGA
    from its ``saga_init``); the whole (q, dp) iterate, gathered."""
    w0 = e.pack_w(torch.zeros(D, device=e.device))
    lr = TRAIN_LR
    if algo == "sgd":
        w = e.sgd_epoch(w0, lr, idx, key)
    elif algo == "svrg":
        w = e.svrg_epoch(w0, w0, e.full_gradient(w0, key), lr, idx, key)
    else:
        tab, avg = e.saga_init(w0, key)
        w = e.saga_epoch(w0, tab, avg, lr, idx, key)[0]
    return e.gather(w)


def _dist_deep_epoch(torch, e, kind, pq, delays, idx, key):
    """``kind``'s epoch on engine ``e``: a deep one from the packed start
    ``pq`` (SVRG from its ``deep_full_gradient``), a delayed one from
    zeroed rings at the engine's rows (w = 0 for the linear one) at step
    0 with ``delays``, the engine's rows of phase 11's.  Returns every
    result (leaves, μ, rings, the counter), gathered over the model
    group."""
    lr, tau = TRAIN_LR, DIST_TAU
    fn = getattr(e, f"{kind}_epoch")
    if kind == "delayed_sgd":
        ring = torch.zeros((e.qloc, tau + 1, e.dp), device=e.device)
        w, ring, t = fn(e.pack_w(torch.zeros(D, device=e.device)), ring, 0,
                        delays, lr, idx, tau, key)
        return [e.gather(w), e.gather(ring), t]
    if kind == "deep_delayed_sgd":
        pq, rings, t = fn(pq, e.deep_delay_buffers(pq, tau), 0, delays, lr,
                          idx, tau, key)
        return [e.gather(a) for a in (*pq, *rings)] + [t]
    if kind.endswith("svrg"):
        mu = e.deep_full_gradient(pq, key)
        return [e.gather(a) for a in (*fn(pq, pq, mu, lr, idx, key), *mu)]
    return [e.gather(a) for a in fn(pq, lr, idx, key)]


def _dist_hold(torch, rec, name, mode, world, got, want):
    """Hold the device-mesh engine's results ``got`` to the ``mesh=None``
    engine's ``want``: bit for bit under ``off`` at one rank, else each
    within ``DIST_TOL`` of the larger of 1 and its own scale."""
    err = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
              for a, b in zip(got, want, strict=True))
    rec[f"{name}_max_err"] = err
    if mode == "off" and world == 1:
        rec[f"{name}_bit_equal"] = same = all(
            torch.equal(a, b) for a, b in zip(got, want))
        check(same, f"phase 24(a) {name} off: not the mesh=None engine's "
              f"bits ({err:.3e})")
    else:
        check(err <= DIST_TOL, f"phase 24(a) {name} {mode}: {err:.3e} from "
              "the mesh=None engine")


def _dist_deep(torch, dev, e, flat, mode, world, lay, idx, key, rec,
               tallies):
    """24(a)'s deep and bounded-delay part of one mode: the epochs of
    ``DIST_DEEP_KINDS``, ``DIST_DEEP_STEPS`` steps each, under no host sync,
    ``deep_objective`` and a deep ``ServeEngine`` (full, hit, and full
    again for the deep SGD epoch's params) on the device-mesh engine
    ``e`` against the ``mesh=None`` engine ``flat``; then a timed deep SGD
    and delayed SGD epoch of each (graph replays).  ``tallies`` (mesh,
    flat) take each engine's launches."""
    from repro_torch.core import deep_vfl
    from repro_torch.core import staleness as st
    from repro_torch.kernels import vfl_grad as vg
    from repro_torch.serve.engine import ServeEngine
    p0 = deep_vfl.initial_params(SEED, lay, D, DEEP_HIDDEN, DEEP_DREP)
    dly = torch.from_numpy(st.party_delay_values(lay, DIST_TAU, SEED)) \
        .to(dev).long()
    didx = idx[:DIST_DEEP_STEPS]
    engines = ((e, e.pack_deep(p0), e.local(dly), tallies[0]),
               (flat, flat.pack_deep(p0), dly, tallies[1]))
    trained = None
    for kind in DIST_DEEP_KINDS:
        out = []
        for eng, pq, dl, tally in engines:
            with no_host_sync(torch):
                got, n = _counted(vg, lambda: _dist_deep_epoch(
                    torch, eng, kind, pq, dl, didx, key))
            tally.update(n)
            out.append(got)
        _dist_hold(torch, rec, kind, mode, world, *out)
        if kind == "deep_sgd":
            trained = flat.unpack_deep(out[1][:4])
    objs = []
    for eng, pq, _, tally in engines:
        obj, n = _counted(vg, lambda: eng.deep_objective(pq))
        tally.update(n)
        objs.append(torch.tensor([obj], dtype=torch.float64))
    _dist_hold(torch, rec, "deep_objective", mode, world, *([o] for o in objs))
    ids = (np.arange(DIST_SERVE_IDS) * 997) % N
    answers = []
    for eng, _, _, tally in engines:
        sv = ServeEngine(eng, max_batch=BATCH, device=dev)
        out = []
        for params in (p0, None, trained):
            if params is not None:
                sv.set_deep_params(params)
            got, n = _counted(vg, lambda: sv.serve(ids))
            tally.update(n)
            out.append(torch.from_numpy(got))
        answers.append((out, dataclasses.asdict(sv.stats)))
        del sv
    (mine, stats), (ref, ref_stats) = answers
    check(stats == ref_stats and stats["full_dispatches"]
          and stats["hit_dispatches"],
          f"phase 24(a) deep serving stats {stats} != {ref_stats}")
    rec["deep_serve_stats"] = stats
    _dist_hold(torch, rec, "deep_serve", mode, world, mine, ref)
    for name, (eng, pq, dl, tally) in zip(("mesh", "flat"), engines):
        ring = torch.zeros((eng.qloc, DIST_TAU + 1, eng.dp), device=dev)
        w0 = eng.pack_w(torch.zeros(D, device=dev))
        for what, epoch in (
                ("deep", lambda: eng.deep_sgd_epoch(pq, TRAIN_LR, didx,
                                                    key)),
                ("delayed", lambda: eng.delayed_sgd_epoch(
                    w0, ring, 0, dl, TRAIN_LR, didx, DIST_TAU, key))):
            rec[f"{name}_{what}_step_ms"], n = _counted(
                vg, lambda: _timed_step_ms(torch, epoch, DIST_DEEP_STEPS))
            tally.update(n)


def _dist_fault_windows(torch, dev, lay, steps, seed, p_corrupt, k):
    """The first ``k`` columns of the faulted and the guarded (NaN and
    Inf at ``p_corrupt``) ``random_trace`` windows of ``steps`` steps over
    ``lay``, whole (q, k) device tensors, and phase 11's seed delays
    (within the budget of both): ``{"faulted": [fwd, bwd, extra],
    "guarded": [..., codes]}``, delays (q,)."""
    from repro_torch.core import faults
    from repro_torch.core import staleness as st
    traces = {"faulted": faults.random_trace(lay, steps, seed=seed),
              "guarded": faults.random_trace(lay, steps, seed=seed,
                                             p_corrupt=p_corrupt,
                                             corrupt_modes=("nan", "inf"))}
    scheds = {name: tr.compile(lay.m) for name, tr in traces.items()}
    delays = st.party_delay_values(lay, DIST_TAU, seed)
    for sched in scheds.values():
        faults._check_delay_budget(delays, sched, DIST_TAU)
    out = {}
    for name, sched in scheds.items():
        win = sched.epoch(0, steps)
        rows = list(win.party_rows())
        if name == "guarded":
            rows.append(win.corrupt_rows())
        out[name] = [torch.from_numpy(a[:, :k].copy()).to(dev) for a in rows]
    return out, torch.from_numpy(delays).to(dev).long()


def _dist_fault_epoch(torch, e, kind, wins, delays, idx, key, pq):
    """``kind``'s faulted or guarded epoch on engine ``e`` from w = 0
    (SVRG from its full gradient, SAGA from its ``saga_init``) or the
    deep start ``pq``, the engine's packed rows (SVRG from its
    ``deep_full_gradient``), zeroed
    rings at the engine's rows and step 0, on the engine's rows of the
    whole channels ``wins`` and ``delays``.  Returns (every result
    gathered over the model group, the gathered ``HealthStats`` or
    None)."""
    tau, lr = DIST_TAU, TRAIN_LR
    guarded = "guarded" in kind
    chans = [e.local(a) for a in wins["guarded" if guarded else "faulted"]]
    kw = {"guard": True} if guarded else {}
    fn = getattr(e, f"{kind}_epoch")
    if kind.startswith("deep"):
        head = (pq, pq, e.deep_full_gradient(pq, key)) \
            if kind.endswith("svrg") else (pq,)
        out = fn(*head, e.deep_delay_buffers(pq, tau), 0, e.local(delays),
                 *chans, lr, idx, tau, key, **kw)
        got = [e.gather(a) for a in (*out[0], *out[1])] + [out[2]]
    else:
        w0 = e.pack_w(torch.zeros(D, device=e.device))
        head = (w0,)
        if kind.endswith("svrg"):
            head = (w0, w0, e.full_gradient(w0, key))
        elif kind.endswith("saga"):
            head = (w0, *e.saga_init(w0, key))
        ring = torch.zeros((e.qloc, tau + 1, e.dp), device=e.device)
        out = fn(*head, ring, 0, e.local(delays), *chans, lr, idx, tau, key,
                 **kw)
        n = 3 if kind.endswith("saga") else 1
        got = [e.gather(a) for a in out[:n + 1]] + [out[n + 1]]
    return got, ([e.gather(a) for a in out[-1]] if guarded else None)


def _dist_hold_health(torch, rec, name, mode, world, got, want):
    """Hold a guarded epoch's gathered telemetry to the ``mesh=None``
    engine's: ``finite`` and ``alive`` equal; the norms' NaN and infinite
    entries the same, and their finite entries bit for bit under ``off``
    at one rank, else within ``DIST_TOL`` of the finite entries' scale."""
    for field, a, b in zip(("finite", "alive"), got, want):
        check(torch.equal(a, b), f"phase 24 {name} {mode}: {field} differs "
              "from the mesh=None engine's")
    for field, a, b in zip(("pnorm", "gnorm"), got[2:], want[2:]):
        fin = b.isfinite()
        check(torch.equal(a.isnan(), b.isnan())
              and torch.equal(a.isinf(), b.isinf())
              and torch.equal(a[b.isinf()], b[b.isinf()]),
              f"phase 24 {name} {mode}: {field}'s non-finite entries differ")
        a, b = torch.where(fin, a, 0.0), torch.where(fin, b, 0.0)
        err = float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
        rec[f"{name}_{field}_max_err"] = err
        if mode == "off" and world == 1:
            check(torch.equal(a, b), f"phase 24 {name} off: {field} not the "
                  f"mesh=None engine's bits ({err:.3e})")
        else:
            check(err <= DIST_TOL, f"phase 24 {name} {mode}: {field} "
                  f"{err:.3e} from the mesh=None engine")


def _dist_faults(torch, dev, e, flat, mode, world, lay, idx, key, rec,
                 tallies):
    """24(a)'s faulted and guarded part of one mode: the six linear and
    four deep faulted and guarded epochs of ``DIST_FAULT_KINDS``,
    ``DIST_FAULT_STEPS`` steps each on phases 14-15's traces, under no
    host sync, on the device-mesh engine ``e`` against the ``mesh=None``
    engine ``flat`` (results, counter and telemetry); then a timed epoch
    of each of ``DIST_FAULT_TIMED`` on each engine (graph replays).
    ``tallies`` (mesh, flat) take each engine's launches."""
    from repro_torch.core import deep_vfl
    from repro_torch.kernels import vfl_grad as vg
    p0 = deep_vfl.initial_params(SEED, lay, D, DEEP_HIDDEN, DEEP_DREP)
    wins, delays = _dist_fault_windows(torch, dev, lay, N // TRAIN_BATCH,
                                       SEED, FAULT_P_CORRUPT,
                                       DIST_FAULT_STEPS)
    fidx = idx[:DIST_FAULT_STEPS]
    engines = ((e, e.pack_deep(p0), tallies[0]),
               (flat, flat.pack_deep(p0), tallies[1]))
    for kind in DIST_FAULT_KINDS:
        out = []
        for eng, pq, tally in engines:
            with no_host_sync(torch):
                got, n = _counted(vg, lambda: _dist_fault_epoch(
                    torch, eng, kind, wins, delays, fidx, key, pq))
            tally.update(n)
            out.append(got)
        (got, health), (want, ref_health) = out
        check(int(got[-1]) == int(want[-1]) == DIST_FAULT_STEPS,
              f"phase 24 {kind} {mode}: counter {int(got[-1])}")
        _dist_hold(torch, rec, kind, mode, world, got, want)
        if health is not None:
            check(not bool((health[0] == 0).all()) and bool(
                (health[0] == 0).any()), f"phase 24 {kind}: no quarantine")
            _dist_hold_health(torch, rec, kind, mode, world, health,
                              ref_health)
    for name, (eng, pq, tally) in zip(("mesh", "flat"), engines):
        for kind in DIST_FAULT_TIMED:
            rec[f"{name}_{kind}_step_ms"], n = _counted(
                vg, lambda: _timed_step_ms(torch, lambda: _dist_fault_epoch(
                    torch, eng, kind, wins, delays, fidx, key, pq),
                    DIST_FAULT_STEPS))
            tally.update(n)


def _dist_stream(torch, dev):
    """The ring's survivor-rank counter stream on the card against the
    CPU's: Philox's words on ``DIST_STREAM_BLOCKS`` random counters equal,
    ``_counter_normal``'s normals of 8 rows within ``DIST_STREAM_TOL``;
    returns the record."""
    from repro_torch.core import secure_agg as sa
    gen = torch.Generator().manual_seed(SEED)
    ctr = torch.randint(0, 1 << 32, (4, DIST_STREAM_BLOCKS), generator=gen)
    key = torch.tensor([*sa.key_words(SEED, 24), 7])
    words = [sa._philox(ctr.to(d), key[:2].to(d)).cpu() for d in ("cpu", dev)]
    fp, rows = torch.tensor(0x5A5A), torch.arange(8)
    normals = [sa._counter_normal(key.to(d), fp.to(d), rows.to(d),
                                  DIST_STREAM_NUMEL).cpu()
               for d in ("cpu", dev)]
    rec = {"words_equal": bool(torch.equal(*words)),
           "normals_max_abs_err": float((normals[0] - normals[1])
                                        .abs().max())}
    check(rec["words_equal"], "phase 24: the counter stream's words on the "
          "card differ from the CPU's")
    check(rec["normals_max_abs_err"] <= DIST_STREAM_TOL,
          f"phase 24: the counter stream's normals on the card "
          f"{rec['normals_max_abs_err']:.3e} from the CPU's")
    return rec


def _counted(vg, fn):
    """``fn()`` and the vfl_grad launches it made."""
    before = dict(vg.KERNEL.launches)
    out = fn()
    return out, {p: vg.KERNEL.launches[p] - before[p] for p in before}


def _timed_step_ms(torch, fn, steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def _dist_nccl(torch, dev):
    """24(a), in each rank: for ``off``, ``two_tree`` and ``ring`` the
    SGD, SVRG and SAGA epochs (``DIST_STEPS`` steps of phase 7's
    schedule) on ``PartyMesh(q=8, slots=world)`` over NCCL, under no host
    sync, each step a replay of a CUDA graph that holds its collectives,
    against the same epochs of the ``mesh=None`` engine on the card: bit
    for bit under ``off`` at one rank, within ``DIST_TOL`` otherwise; a
    timed SGD epoch of each; serving (full, hit, delta) against a
    ``ServeEngine`` over the ``mesh=None`` engine; profiler windows over
    ``DIST_PROFILE_STEPS`` masked SGD steps of each engine; the deep and
    bounded-delay part (``_dist_deep``); the faulted and guarded part
    (``_dist_faults``).  Returns the rank's record, its device-mesh
    launches apart."""
    import torch.distributed as dist
    from repro_torch.core import algorithms as alg
    from repro_torch.core.algorithms import PartyLayout
    from repro_torch.core.engine import EngineConfig, FusedEngine, unpack_vec
    from repro_torch.core.losses import logistic_l2
    from repro_torch.kernels import vfl_grad as vg
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.serve.engine import ServeEngine
    world = dist.get_world_size()
    x, y = _dist_data(torch, dev)
    pm = make_device_mesh(world, q=Q)
    lay, prob = PartyLayout.even(D, Q, M_ACT), logistic_l2(1e-4)
    idx = alg.epoch_indices(SEED, 0, N, TRAIN_BATCH, DIST_STEPS, dev)
    key = (SEED, 24)
    res = {"world": world, "backend": pm.backend, "slot": pm.slot,
           "parties": list(pm.parties), "modes": {}}
    mesh_launches, flat_launches = Counter(), Counter()
    torch.cuda.reset_peak_memory_stats()
    for mode in ("off", "two_tree", "ring"):
        cfg = EngineConfig(secure=mode)
        e = FusedEngine(prob, x, y, lay, cfg, mesh=pm, device=dev)
        flat = FusedEngine(prob, x, y, lay, cfg, device=dev)
        rec, iterates = {}, {}
        for algo in ("sgd", "svrg", "saga"):
            with no_host_sync(torch):
                got, n_mesh = _counted(vg, lambda: _dist_epoch(
                    torch, e, algo, idx, key))
                want, n_flat = _counted(vg, lambda: _dist_epoch(
                    torch, flat, algo, idx, key))
            mesh_launches.update(n_mesh)
            flat_launches.update(n_flat)
            iterates[algo] = got
            err = float((got - want).abs().max())
            rec[f"{algo}_max_abs_err"] = err
            if mode == "off" and world == 1:
                rec[f"{algo}_bit_equal"] = bool(torch.equal(got, want))
                check(rec[f"{algo}_bit_equal"], f"phase 24(a) {algo} off: "
                      f"not the mesh=None epoch's bits ({err:.3e})")
            else:
                check(err <= DIST_TOL, f"phase 24(a) {algo} {mode}: {err:.3e}"
                      f" from the mesh=None epoch")
        _dist_deep(torch, dev, e, flat, mode, world, lay, idx, key, rec,
                   (mesh_launches, flat_launches))
        _dist_faults(torch, dev, e, flat, mode, world, lay, idx, key, rec,
                     (mesh_launches, flat_launches))
        graphs = [lp.graph for lp in e._loops.values()]
        check(graphs and all(g is not None for g in graphs),
              f"phase 24(a) {mode}: an epoch ran uncaptured")
        # a step of each engine: its SGD epoch once more, graph replays
        for name, eng, tally in (("mesh", e, mesh_launches),
                                 ("flat", flat, flat_launches)):
            w0 = eng.pack_w(torch.zeros(D, device=dev))
            rec[f"{name}_step_ms"], n = _counted(vg, lambda: _timed_step_ms(
                torch, lambda: eng.sgd_epoch(w0, TRAIN_LR, idx, key),
                DIST_STEPS))
            tally.update(n)
            if mode != "off":       # where a masked step's time goes
                pre = idx[:DIST_PROFILE_STEPS]
                rec[f"{name}_profile"], n = _counted(vg, lambda: epoch_profile(
                    torch, lambda: eng.sgd_epoch(w0, TRAIN_LR, pre, key),
                    DIST_PROFILE_STEPS))
                tally.update(n)
        if mode == "two_tree":
            w = torch.from_numpy(unpack_vec(iterates["sgd"], lay)).to(dev)
            ids = (np.arange(DIST_SERVE_IDS) * 997) % N
            answers = []
            for eng, tally in ((e, mesh_launches), (flat, flat_launches)):
                sv = ServeEngine(eng, max_batch=BATCH, device=dev)
                out = []
                for scale in (1.0, None, 1.01):
                    if scale is not None:
                        sv.set_weights(w * scale)
                    got, n = _counted(vg, lambda: sv.serve(ids))
                    tally.update(n)
                    out.append(got)
                answers.append((out, dataclasses.asdict(sv.stats)))
                del sv
            (mine, stats), (ref, ref_stats) = answers
            check(stats == ref_stats and stats["full_dispatches"] and
                  stats["hit_dispatches"] and stats["delta_dispatches"],
                  f"phase 24(a) serving stats {stats} != {ref_stats}")
            rec["serve_max_abs_err"] = err = max(
                float(np.abs(a - b).max()) for a, b in zip(mine, ref))
            scale = max(1.0, max(float(np.abs(b).max()) for b in ref))
            check(err <= DIST_TOL * scale, f"phase 24(a) serving {err:.3e} "
                  "from the mesh=None ServeEngine")
            rec["serve_stats"] = stats
        res["modes"][mode] = rec
        del e, flat, eng
    res["launches"] = dict(mesh_launches)
    res["flat_launches"] = dict(flat_launches)
    res["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res


def _dist_gloo(torch, dev):
    """24(b), in each of four ranks sharing the card: SGD epochs of
    ``DIST_GLOO_STEPS`` steps, then a deep SGD epoch and a delayed SGD
    epoch (τ = 4, seed-0 delays) of ``DIST_GLOO_DEEP_STEPS`` steps, on
    ``PartyMesh(q=4, slots=4)`` over gloo under ``two_tree`` and
    ``ring``, eagerly (gloo is never captured); then ``DIST_GLOO_FAULT_KINDS``
    (faulted, guarded and deep guarded SGD, ``DIST_GLOO_FAULT_STEPS``
    steps each, on a q = 4 trace's NaN and Inf codes: under ``ring`` the
    survivor-rank stream across the processes) and, under ``ring``, one
    ``run_guarded_fused`` epoch over the mesh; rank 0 holds the gathered
    results (every rank gathers the same) to the ``mesh=None`` engine's
    and runner's on the card within ``DIST_TOL``, the telemetry's flags
    equal.  Every rank launches ``vfl_grad`` on the card for its own
    party."""
    import torch.distributed as dist
    from repro_torch.core import algorithms as alg
    from repro_torch.core import deep_vfl, faults
    from repro_torch.core import staleness as st
    from repro_torch.core.algorithms import PartyLayout
    from repro_torch.core.engine import EngineConfig, FusedEngine
    from repro_torch.core.losses import logistic_l2
    from repro_torch.kernels import vfl_grad as vg
    from repro_torch.launch.mesh import make_device_mesh
    world = dist.get_world_size()
    x, y = _dist_data(torch, dev)
    pm = make_device_mesh(world, backend="gloo")
    lay, prob = PartyLayout.even(D, world, M_ACT), logistic_l2(1e-4)
    idx = alg.epoch_indices(SEED, 0, N, TRAIN_BATCH, DIST_GLOO_STEPS, dev)
    didx = idx[:DIST_GLOO_DEEP_STEPS]
    key = (SEED, 24)
    p0 = deep_vfl.initial_params(SEED, lay, D, DEEP_HIDDEN, DEEP_DREP)
    dly = torch.from_numpy(st.party_delay_values(lay, DIST_TAU, SEED)) \
        .to(dev).long()
    fsteps = DIST_GLOO_FAULT_STEPS
    fwins, fdly = _dist_fault_windows(torch, dev, lay, fsteps, SEED,
                                      DIST_GLOO_P_CORRUPT, fsteps)
    fidx = idx[:fsteps]
    # the runner's epoch: fsteps minibatches of phase 7's first rows
    nrun = fsteps * TRAIN_BATCH
    run_kw = dict(tau=DIST_TAU, epochs=1, lr=TRAIN_LR, batch=TRAIN_BATCH,
                  seed=SEED, device=dev)
    run_trace = faults.random_trace(lay, fsteps, seed=SEED,
                                    p_corrupt=DIST_GLOO_P_CORRUPT,
                                    corrupt_modes=("nan", "inf"))
    res = {"world": world, "backend": pm.backend, "slot": pm.slot,
           "modes": {}}
    launches = Counter()
    torch.cuda.reset_peak_memory_stats()
    for mode in ("two_tree", "ring"):
        cfg = EngineConfig(secure=mode)
        e = FusedEngine(prob, x, y, lay, cfg, mesh=pm, device=dev)
        check(tuple(e.xs.shape) == (1, N, D // world),
              f"phase 24(b): rank {pm.slot} holds {tuple(e.xs.shape)}")
        w0 = e.pack_w(torch.zeros(D, device=dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, n = _counted(vg, lambda: e.sgd_epoch(w0, TRAIN_LR, idx, key))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / DIST_GLOO_STEPS * 1e3
        launches.update(n)
        check(not e._loops[("sgd", tuple(idx.shape))].graph,
              "phase 24(b): a gloo epoch was captured")
        got = {"sgd": [e.gather(got)]}
        res["modes"][mode] = rec = {"eager_step_ms": step_ms}
        pq = e.pack_deep(p0)
        for kind in ("deep_sgd", "delayed_sgd"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got[kind], n = _counted(vg, lambda: _dist_deep_epoch(
                torch, e, kind, pq, e.local(dly), didx, key))
            torch.cuda.synchronize()
            rec[f"{kind}_eager_step_ms"] = \
                (time.perf_counter() - t0) / DIST_GLOO_DEEP_STEPS * 1e3
            launches.update(n)
        health = {}
        for kind in DIST_GLOO_FAULT_KINDS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (got[kind], health[kind]), n = _counted(
                vg, lambda: _dist_fault_epoch(torch, e, kind, fwins, fdly,
                                              fidx, key, pq))
            torch.cuda.synchronize()
            rec[f"{kind}_eager_step_ms"] = \
                (time.perf_counter() - t0) / fsteps * 1e3
            launches.update(n)
        if mode == "ring":
            run, n = _counted(vg, lambda: faults.run_guarded_fused(
                prob, x[:nrun], y[:nrun], lay, run_trace, engine_config=cfg,
                mesh=pm, **run_kw))
            launches.update(n)
        if pm.slot == 0:
            flat = FusedEngine(prob, x, y, lay, cfg, device=dev)
            want = {"sgd": [flat.sgd_epoch(
                flat.pack_w(torch.zeros(D, device=dev)), TRAIN_LR, idx,
                key)]}
            for kind in ("deep_sgd", "delayed_sgd"):
                want[kind] = _dist_deep_epoch(torch, flat, kind,
                                              flat.pack_deep(p0), dly, didx,
                                              key)
            for kind in DIST_GLOO_FAULT_KINDS:
                want[kind], ref_health = _dist_fault_epoch(
                    torch, flat, kind, fwins, fdly, fidx, key,
                    flat.pack_deep(p0))
                if ref_health is not None:
                    check(bool((ref_health[0] == 0).any()),
                          f"phase 24(b) {kind}: no quarantine")
                    _dist_hold_health(torch, rec, kind, mode, world,
                                      health[kind], ref_health)
            if mode == "ring":
                ref_w, ref_h = faults.run_guarded_fused(
                    prob, x[:nrun], y[:nrun], lay, run_trace,
                    engine_config=cfg, **run_kw)
                for field, a, b in zip(("finite", "alive"), run[1], ref_h):
                    check(np.array_equal(a, b), f"phase 24(b) "
                          f"run_guarded_fused: {field} differs")
                err = float(np.abs(run[0] - ref_w).max()) \
                    / max(1.0, float(np.abs(ref_w).max()))
                check(err <= DIST_TOL, f"phase 24(b) run_guarded_fused: "
                      f"{err:.3e} from the mesh=None runner")
                rec["run_guarded_fused_max_err"] = err
            for kind, ws in want.items():
                err = max(float((a - b).abs().max())
                          for a, b in zip(got[kind], ws, strict=True))
                check(err <= DIST_TOL, f"phase 24(b) {kind} {mode}: "
                      f"{err:.3e} from the mesh=None epoch")
                rec[f"{kind}_max_err"] = err
            del flat
        del e
    res["launches"] = dict(launches)
    res["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res


def _dist_run(torch, world, backend, part):
    """Spawn ``world`` ranks of ``_dist_world`` and return their records;
    any rank's failure, or a world past ``DIST_TIMEOUT``, fails the
    phase, and every rank is stopped on the way out."""
    import tempfile
    import torch.multiprocessing as mp
    base = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        ctx = mp.start_processes(_dist_world,
                                 args=(world, backend, base, part),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + DIST_TIMEOUT
        try:
            while not ctx.join(timeout=2):
                check(time.monotonic() < deadline,
                      f"phase 24({part}) did not finish in {DIST_TIMEOUT} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [json.loads(Path(base, f"rank{r}.json").read_text())
                for r in range(world)]
    finally:
        shutil.rmtree(base, ignore_errors=True)


def dist_phase(torch, dev, log_):
    """Phase 24: the party mesh on a ``torch.distributed`` device mesh, in
    spawned ranks (the kernels are built before they start, so a rank
    only loads the libraries).  (a) ``PartyMesh(q=8, slots=cards)`` over
    NCCL, one rank a card (``_dist_nccl``); (b) four gloo ranks sharing
    the card, q = 4 (``_dist_gloo``).  First the ring's counter stream
    on the card against the CPU's (``_dist_stream``).  Returns (record,
    the vfl_grad launches of the device-mesh engines, summed over the
    ranks)."""
    from repro_torch.kernels import vfl_grad as vg
    vg.KERNEL.library()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    res, launches = {"stream": _dist_stream(torch, dev)}, Counter()
    log_(f"phase 24: the counter stream on the card: {res['stream']}")
    t0 = time.perf_counter()
    ranks = _dist_run(torch, cards, "nccl", "a")
    res["a"] = {"seconds": time.perf_counter() - t0, "ranks": ranks}
    for r in ranks:
        launches.update(r["launches"])
        check(all(r["launches"][p] for p in vg.PROGRAMS),
              f"a kernel of the phase 24(a) path was never launched: "
              f"{r['launches']}")
        check(cards > 1 or r["launches"] == r["flat_launches"],
              f"phase 24(a): launches {r['launches']} against the "
              f"mesh=None engine's {r['flat_launches']}")
        for mode, rec in r["modes"].items():
            log_(f"phase 24(a) rank {r['slot']} of {cards} ({r['backend']}, "
                 f"parties {r['parties'][0]}-{r['parties'][-1]}) {mode}: "
                 f"{ {k: v for k, v in rec.items() if 'profile' not in k} }")
            for name in ("mesh", "flat"):
                prof = rec.get(f"{name}_profile")
                if prof:
                    log_(f"phase 24(a) {mode} {name} profile of "
                         f"{prof['steps']} SGD steps: wall "
                         f"{prof['wall_us']:.0f} µs, device busy "
                         f"{prof['device_busy_share']}, top "
                         f"{prof['top_device_us'][:6]}")
        log_(f"phase 24(a) rank {r['slot']}: vfl_grad launches "
             f"{r['launches']}, the mesh=None engine's "
             f"{r['flat_launches']}; max_memory_allocated "
             f"{r['max_memory_allocated_gb']:.2f} GB")
    log_("phase 24(b): schedule_faithful (the tree rounds' point-to-point "
         "sends) is held in the CPU tests (tests/test_torch_dist_mesh.py), "
         "not here: gloo's send of a CUDA tensor fails (writev: Bad "
         "address), and tree_psum_dist refuses it")
    t0 = time.perf_counter()
    ranks = _dist_run(torch, DIST_GLOO_RANKS, "gloo", "b")
    res["b"] = {"seconds": time.perf_counter() - t0, "ranks": ranks}
    # per mode: the SGD, delayed SGD, faulted SGD and guarded SGD steps
    # (one forward, one backward each) and the deep SGD and deep guarded
    # SGD steps (2 and 2); under ring the runner's guarded SGD steps
    per_mode = implied(steps=DIST_GLOO_STEPS + DIST_GLOO_DEEP_STEPS
                       + 2 * DIST_GLOO_FAULT_STEPS) \
        + deep_implied(steps=DIST_GLOO_DEEP_STEPS + DIST_GLOO_FAULT_STEPS)
    want = per_mode + per_mode + implied(steps=DIST_GLOO_FAULT_STEPS)
    for r in ranks:
        launches.update(r["launches"])
        check(r["launches"] == {p: want[p] for p in vg.PROGRAMS},
              f"phase 24(b) rank {r['slot']}: launches {r['launches']} != "
              f"{dict(want)} implied by the steps")
        log_(f"phase 24(b) rank {r['slot']} of {DIST_GLOO_RANKS} "
             f"({r['backend']}): {r['modes']}; vfl_grad launches "
             f"{r['launches']}; max_memory_allocated "
             f"{r['max_memory_allocated_gb']:.2f} GB")
    return res, dict(launches)


# ---------------------------------------------------------------------------
# the linter on the card
# ---------------------------------------------------------------------------

LINT_KINDS = ("sgd", "pipelined_sgd", "deep_sgd", "delayed2", "faulted_sgd2")
LINT_STEPS, LINT_TAU = 3, 2      # the short epochs' steps; delayed2's τ
DISPATCH_CALLS, DISPATCH_ROUNDS = 200, 15


def _dispatch_cost(torch, dev, ops):
    """Host µs a call of ``repro_torch::vfl_grad`` (the operator, dispatched
    in C++ to its CUDA implementation, as a trace records it) and of the
    public wrapper ``ops.vfl_grad`` (its checks, then, outside a trace, the
    implementation itself) against a direct call of that implementation,
    at the SGD step's shape (8, 32, 512): forward with the rank-1 iterate,
    backward with the shared θ; and the one read of the dispatch mode
    that the wrapper adds to its eager call.  Blocks of ``DISPATCH_CALLS``
    calls of each form alternate over ``DISPATCH_ROUNDS`` rounds, the
    stream drained between blocks; each form's median block, per call."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xb = torch.randn((Q, TRAIN_BATCH, D // Q), generator=gen, device=dev)
    wq = torch.randn((Q, D // Q), generator=gen, device=dev)
    th = torch.randn((TRAIN_BATCH,), generator=gen, device=dev) \
        .expand(Q, TRAIN_BATCH)
    from torch.fx.experimental.proxy_tensor import get_proxy_mode

    op = torch.ops.repro_torch.vfl_grad
    forms = {
        "operator_forward": lambda: op.forward(xb, wq),
        "direct_forward": lambda: ops._cuda_forward(xb, wq),
        "wrapper_forward": lambda: ops.vfl_grad(xb, wq),
        "operator_backward": lambda: op.backward(xb, th, None, 0.0,
                                                 TRAIN_BATCH),
        "direct_backward": lambda: ops._cuda_backward(xb, th, None, 0.0,
                                                      TRAIN_BATCH),
        "wrapper_backward": lambda: ops.vfl_grad(
            xb, None, th, mode="backward", denom=TRAIN_BATCH),
        # what the wrapper adds to the parent's eager call: one read of
        # the dispatch mode (is a make_fx trace active?)
        "mode_read": get_proxy_mode}
    for fn in forms.values():                           # warm
        fn()
    torch.cuda.synchronize()
    blocks = {k: [] for k in forms}
    for _ in range(DISPATCH_ROUNDS):
        for name, fn in forms.items():
            t = time.perf_counter()
            for _ in range(DISPATCH_CALLS):
                fn()
            blocks[name].append((time.perf_counter() - t) / DISPATCH_CALLS)
            torch.cuda.synchronize()
    res = {k: float(np.median(v)) * 1e6 for k, v in blocks.items()}
    for mode in ("forward", "backward"):
        for form in ("operator", "wrapper"):
            res[f"{form}_minus_direct_{mode}"] = \
                res[f"{form}_{mode}"] - res[f"direct_{mode}"]
    return res


def lint_phase(torch, dev, x, y, layout, log_):
    """Phase 18: the linter on the card.  (a) On phase 7's resident data at
    full width ((8, 350000, 512) f32, batch 32) under ``two_tree``, each
    of ``LINT_KINDS`` (τ = 2 for the rings) is traced with ``make_fx`` over
    fake tensors (``FusedEngine.epoch_graph``: nothing runs), then one
    short epoch of ``LINT_STEPS`` steps runs (an eager step, the captured
    graph, its replays) under no host sync; the step's
    ``repro_torch.vfl_grad`` nodes must equal the launches one replay of
    the captured graph makes (``_StepLoop.per_step``), and the trace hold
    no host transfer.  (b) ``python -m repro_torch.analysis --quick
    --device cuda``, in this process: every gate must pass against the
    committed manifest, with zero host transfers; its storage audit runs
    two SGD epochs of the fixture on the card.  (c) The operator's host
    dispatch cost against the direct call (``_dispatch_cost``).  Returns
    (record, expected launches of (a) and (b)); the record's
    ``launches`` are the counts read after (b), before (c)'s calls."""
    from repro_torch.analysis import runner
    from repro_torch.analysis.walkers import (count_host_transfers,
                                              vfl_grad_census)
    from repro_torch.core import algorithms as alg
    from repro_torch.core import deep_vfl
    from repro_torch.core.engine import EngineConfig, FusedEngine
    from repro_torch.core.losses import logistic_l2
    from repro_torch.kernels import ops
    from repro_torch.kernels import vfl_grad as vg
    n, d = x.shape
    steps, tau, lr = LINT_STEPS, LINT_TAU, TRAIN_LR
    eng = FusedEngine(logistic_l2(1e-4), x, y, layout,
                      EngineConfig(secure="two_tree"), device=dev)
    idx = alg.epoch_indices(SEED, 0, n, TRAIN_BATCH, steps, dev)
    w0 = eng.pack_w(torch.zeros(d, device=dev))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pq = eng.pack_deep(deep_vfl.init_deep_vfl(gen, layout, d, DEEP_HIDDEN,
                                              DEEP_DREP))
    delays = torch.ones(Q, dtype=torch.int64, device=dev)
    buf = torch.zeros((Q, tau + 1, eng.dp), device=dev)
    live = torch.ones((Q, steps), device=dev)
    extra = torch.zeros((Q, steps), dtype=torch.int64, device=dev)
    calls = {"sgd": (eng.sgd_epoch, (w0, lr, idx)),
             "pipelined_sgd": (eng.pipelined_sgd_epoch, (w0, lr, idx)),
             "deep_sgd": (eng.deep_sgd_epoch, (pq, lr, idx)),
             "delayed2": (eng.delayed_sgd_epoch,
                          (w0, buf, 0, delays, lr, idx, tau)),
             "faulted_sgd2": (eng.faulted_sgd_epoch,
                              (w0, buf, 0, delays, live, live, extra, lr,
                               idx, tau))}
    res = {"census": {}}
    expected = Counter()
    for kind in LINT_KINDS:
        epoch, args = calls[kind]
        before = set(eng._loops)
        t = time.perf_counter()
        program = eng.epoch_graph(kind, epoch, *args)
        trace_s = time.perf_counter() - t
        (key,) = set(eng._loops) - before
        nodes = vfl_grad_census(program)
        check(count_host_transfers(program) == 0,
              f"phase 18 {kind}: host transfers in the trace")
        with no_host_sync(torch):
            epoch(*args)
        torch.cuda.synchronize()
        per_step = dict(eng._loops[key].per_step)
        check(nodes == sum(per_step.values()),
              f"phase 18 {kind}: {nodes} vfl_grad nodes a traced step, one "
              f"replay of the captured step launches {per_step}")
        if kind.startswith("pipelined"):
            expected += Counter(vfl_forward_narrow=1, vfl_backward_rows=1)
            expected += Counter({p: k * (steps - 1)
                                 for p, k in per_step.items()})
        else:
            expected += Counter({p: k * steps for p, k in per_step.items()})
        res["census"][kind] = {"vfl_grad_nodes": nodes,
                               "launches_per_replay": per_step,
                               "trace_seconds": trace_s}
        log_(f"phase 18 {kind}: {nodes} vfl_grad nodes a step, a replay "
             f"launches {per_step}; traced in {trace_s:.2f} s")
    del eng, pq, calls
    torch.cuda.empty_cache()

    t = time.perf_counter()
    out = ROOT / "results" / "lint_quick.json"
    rc = runner.main(["--quick", "--device", "cuda", "--ci", "--json",
                      str(out)])
    check(rc == 0, "phase 18: python -m repro_torch.analysis --quick "
          "--device cuda failed its gates")
    report = json.loads(out.read_text())
    res["lint"] = {"seconds": time.perf_counter() - t,
                   "entries": len(report["matrix"]),
                   "host_transfers": sum(v["host_transfers"]
                                         for v in report["matrix"].values()),
                   "kernels": report["kernels"],
                   "storage": report["storage"],
                   "collectives": report["collectives"]}
    check(res["lint"]["host_transfers"] == 0,
          "phase 18: host transfers in the quick matrix")
    # the storage audit's two SGD epochs of the fixture (3 steps each)
    expected += implied(steps=6)
    log_(f"phase 18 quick lint on the card: {res['lint']}")
    # the path's launches, read before the dispatch timing's
    res["launches"] = dict(vg.KERNEL.launches)

    res["dispatch_us"] = _dispatch_cost(torch, dev, ops)
    log_(f"phase 18 dispatch host µs a call: {res['dispatch_us']}")
    return res, expected


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a machine with an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.core.algorithms import PartyLayout
    from repro_torch.kernels import vfl_grad as vg

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 references
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    libs, failed = _libs(), []

    def build(lib):
        try:
            lib.library()
        except Exception as e:                  # relayed to the main thread
            failed.append(e)

    builders = [threading.Thread(target=build, args=(lib,)) for lib in libs]
    for t in builders:
        t.start()
    for t in builders:
        t.join()
    if failed:
        raise failed[0]
    log(f"kernel builds+loads: {time.perf_counter() - t0:.1f} s "
        f"(nvcc, in parallel: {[lib.build_seconds for lib in libs]} s)")
    record = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "build_logs": {lib.source.name: lib.build_log for lib in libs}}
    for lib in libs:
        log(f"{lib.source.name}: {_ptxas_summary(lib.build_log)}")
    # the redesigned programs' instances on the main paths
    record["instances"] = _instances(
        "".join(lib.build_log for lib in libs),
        ("selective_scan", "vfl_forward_wide", "vfl_fused_split<1,0>"))
    for line in record["instances"]:
        log(f"    {line}")
    record["kernel_shapes"] = kernel_phase(torch, dev)
    record["scan_shapes"] = scan_rows(torch, dev)
    record["flash_shapes"] = flash_rows(torch, dev)
    record["decode_shapes"] = decode_rows(torch, dev)

    layout = PartyLayout.even(D, Q, M_ACT)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((N, D), generator=gen, device=dev)      # ~5.7 GB
    torch.cuda.reset_peak_memory_stats()

    reset_counts()                                  # serving path starts
    expected = Counter()
    record["linear_two_tree"], e = linear_phase(
        torch, dev, x, layout, trace_len=100_000, hot_len=8192, log_=log)
    expected += e
    for secure in ("off", "ring"):
        record[f"linear_{secure}"], e = secure_pass(
            torch, dev, x, layout, secure, count=BATCH * 100)
        expected += e
        log(f"linear {secure}: {record[f'linear_{secure}']}")
    record["deep_two_tree"], e = deep_phase(torch, dev, x, layout,
                                            count=BATCH * 300)
    expected += e
    log(f"deep: {record['deep_two_tree']}")
    serve_launches = dict(vg.KERNEL.launches)       # serving path ends
    check_idle(_libs()[1:], "the serving path")
    check(serve_launches == {p: expected[p] for p in vg.PROGRAMS},
          f"serving launches {serve_launches} != {dict(expected)} implied "
          "by dispatches")
    serve_programs = ("vfl_forward_narrow", "vfl_forward_wide")
    check(all(serve_launches[p] for p in serve_programs),
          f"a kernel of the serving path was never launched: "
          f"{serve_launches}")
    log(f"serving path: kernel launches {serve_launches}, as the "
        "dispatches imply")
    record["serve_launches"] = serve_launches
    record["serve_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9

    record["profile"], _ = profile_window(torch, dev, x, layout)

    y = d4_labels(torch, dev, x)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                                  # training path starts
    record["train"], expected, first_sgd = train_phase(torch, dev, x, y,
                                                       layout, log)
    train_launches = dict(vg.KERNEL.launches)       # training path ends
    check_idle(_libs()[1:], "the training path")
    check(train_launches == {p: expected[p] for p in vg.PROGRAMS},
          f"training launches {train_launches} != {dict(expected)} implied "
          "by the steps")
    train_programs = ("vfl_forward_narrow", "vfl_backward_rows",
                      "vfl_backward_reduce")
    check(all(train_launches[p] for p in train_programs),
          f"a kernel of the training path was never launched: "
          f"{train_launches}")
    log(f"training path: kernel launches {train_launches}, as the steps "
        "imply")
    record["train_launches"] = train_launches
    record["train_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    record["train_measure"] = train_measure(torch, dev, x, y, layout)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()                                  # phase 8 path starts
    record["pipe"], expected, fresh = pipe_phase(torch, dev, x, y, layout,
                                                 first_sgd, log)
    pipe_launches = dict(vg.KERNEL.launches)        # phase 8 path ends
    check_idle(_libs()[1:], "the phase 8 path")
    check(pipe_launches == {p: expected[p] for p in vg.PROGRAMS},
          f"phase 8 launches {pipe_launches} != {dict(expected)} implied "
          "by the steps")
    check(all(pipe_launches[p] for p in train_programs + ("vfl_fused_split",)),
          f"a kernel of the phase 8 path was never launched: "
          f"{pipe_launches}")
    log(f"phase 8 path: kernel launches {pipe_launches}, as the steps "
        "imply")
    record["pipe_launches"] = pipe_launches
    record["pipe_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9

    t11 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                                  # phase 11 path starts
    record["stale"], expected = stale_phase(torch, dev, x, y, layout,
                                            first_sgd, fresh, log)
    stale_launches = dict(vg.KERNEL.launches)       # phase 11 path ends
    check_idle(_libs()[1:], "the phase 11 path")
    check(stale_launches == {p: expected[p] for p in vg.PROGRAMS},
          f"phase 11 launches {stale_launches} != {dict(expected)} implied "
          "by the steps")
    check(all(stale_launches[p] for p in ("vfl_forward_narrow",
                                          "vfl_backward_rows",
                                          "vfl_fused_split")),
          f"a kernel of the phase 11 path was never launched: "
          f"{stale_launches}")
    log(f"phase 11 path: kernel launches {stale_launches}, as the steps "
        "imply")
    record["stale_launches"] = stale_launches
    record["stale_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    record["stale"]["seconds"] = time.perf_counter() - t11
    log(f"phase 11: {record['stale']['seconds']:.1f} s")
    del first_sgd, fresh

    t12 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                                  # phase 12 path starts
    record["deep_train"], expected, deep_fresh = deep_train_phase(
        torch, dev, x, y, layout, log)
    deep_launches = dict(vg.KERNEL.launches)        # phase 12 path ends
    check_idle(_libs()[1:], "the phase 12 path")
    check(deep_launches == {p: expected[p] for p in vg.PROGRAMS},
          f"phase 12 launches {deep_launches} != {dict(expected)} implied "
          "by the steps")
    check(all(deep_launches[p] for p in ("vfl_forward_wide",
                                         "vfl_backward_rows",
                                         "vfl_backward_reduce",
                                         "vfl_fused_split")),
          f"a kernel of the phase 12 path was never launched: "
          f"{deep_launches}")
    log(f"phase 12 path: kernel launches {deep_launches}, as the steps "
        "imply")
    record["deep_train_launches"] = deep_launches
    record["deep_train_peak_memory_gb"] = \
        torch.cuda.max_memory_allocated() / 1e9
    record["deep_train"]["seconds"] = time.perf_counter() - t12
    log(f"phase 12: {record['deep_train']['seconds']:.1f} s")

    t13 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                                  # phase 13 path starts
    record["deep_stale"], expected = deep_stale_phase(torch, dev, x, y,
                                                      layout, deep_fresh, log)
    deep_stale_launches = dict(vg.KERNEL.launches)  # phase 13 path ends
    check_idle(_libs()[1:], "the phase 13 path")
    check(deep_stale_launches == {p: expected[p] for p in vg.PROGRAMS},
          f"phase 13 launches {deep_stale_launches} != {dict(expected)} "
          "implied by the steps")
    check(all(deep_stale_launches[p] for p in ("vfl_forward_wide",
                                               "vfl_backward_rows",
                                               "vfl_fused_split")),
          f"a kernel of the phase 13 path was never launched: "
          f"{deep_stale_launches}")
    log(f"phase 13 path: kernel launches {deep_stale_launches}, as the "
        "steps imply")
    record["deep_stale_launches"] = deep_stale_launches
    record["deep_stale_peak_memory_gb"] = \
        torch.cuda.max_memory_allocated() / 1e9
    record["deep_stale"]["seconds"] = time.perf_counter() - t13
    log(f"phase 13: {record['deep_stale']['seconds']:.1f} s")
    del deep_fresh

    t14 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                                  # phase 14 path starts
    record["faults"], expected = fault_phase(torch, dev, x, y, layout, log)
    fault_launches = dict(vg.KERNEL.launches)       # phase 14 path ends
    check_idle(_libs()[1:], "the phase 14 path")
    check(fault_launches == {p: expected[p] for p in vg.PROGRAMS},
          f"phase 14 launches {fault_launches} != {dict(expected)} "
          "implied by the steps")
    check(all(fault_launches[p] for p in train_programs),
          f"a kernel of the phase 14 path was never launched: "
          f"{fault_launches}")
    log(f"phase 14 path: kernel launches {fault_launches}, as the steps "
        "imply")
    record["fault_launches"] = fault_launches
    record["fault_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    record["faults"]["seconds"] = time.perf_counter() - t14
    log(f"phase 14: {record['faults']['seconds']:.1f} s")

    t15 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                                  # phase 15 path starts
    record["deep_faults"], expected = deep_fault_phase(torch, dev, x, y,
                                                       layout, log)
    deep_fault_launches = dict(vg.KERNEL.launches)  # phase 15 path ends
    check_idle(_libs()[1:], "the phase 15 path")
    check(deep_fault_launches == {p: expected[p] for p in vg.PROGRAMS},
          f"phase 15 launches {deep_fault_launches} != {dict(expected)} "
          "implied by the steps")
    check(all(deep_fault_launches[p] for p in ("vfl_forward_wide",
                                               "vfl_backward_rows",
                                               "vfl_backward_reduce")),
          f"a kernel of the phase 15 path was never launched: "
          f"{deep_fault_launches}")
    log(f"phase 15 path: kernel launches {deep_fault_launches}, as the "
        "steps imply")
    record["deep_fault_launches"] = deep_fault_launches
    record["deep_fault_peak_memory_gb"] = \
        torch.cuda.max_memory_allocated() / 1e9
    record["deep_faults"]["seconds"] = time.perf_counter() - t15
    log(f"phase 15: {record['deep_faults']['seconds']:.1f} s")

    t16 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                                  # phase 16 path starts
    record["mesh"], expected = mesh_phase(torch, dev, x, y, log)
    mesh_launches = dict(vg.KERNEL.launches)        # phase 16 path ends
    check_idle(_libs()[1:], "the phase 16 path")
    check(mesh_launches == {p: expected[p] for p in vg.PROGRAMS},
          f"phase 16 launches {mesh_launches} != {dict(expected)} "
          "implied by the steps")
    check(all(mesh_launches[p] for p in train_programs),
          f"a kernel of the phase 16 path was never launched: "
          f"{mesh_launches}")
    log(f"phase 16 path: kernel launches {mesh_launches}, as the steps "
        "imply")
    record["mesh_launches"] = mesh_launches
    record["mesh_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    record["mesh"]["seconds"] = time.perf_counter() - t16
    log(f"phase 16: {record['mesh']['seconds']:.1f} s")

    t17 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                                  # phase 17 path starts
    record["serve_async"], expected = serve_async_phase(torch, dev, x, y,
                                                        log)
    serve_async_launches = dict(vg.KERNEL.launches)  # phase 17 path ends
    check_idle(_libs()[1:], "the phase 17 path")
    check(serve_async_launches == {p: expected[p] for p in vg.PROGRAMS},
          f"phase 17 launches {serve_async_launches} != {dict(expected)} "
          "implied by the dispatches, iterations and steps")
    check(all(serve_async_launches[p] for p in ("vfl_forward_narrow",
                                                "vfl_forward_wide",
                                                "vfl_backward_rows")),
          f"a kernel of the phase 17 path was never launched: "
          f"{serve_async_launches}")
    log(f"phase 17 path: kernel launches {serve_async_launches}, as the "
        "dispatches, iterations and steps imply")
    record["serve_async_launches"] = serve_async_launches
    record["serve_async_peak_memory_gb"] = \
        torch.cuda.max_memory_allocated() / 1e9
    record["serve_async"]["seconds"] = time.perf_counter() - t17
    log(f"phase 17: {record['serve_async']['seconds']:.1f} s")

    t18 = time.perf_counter()
    reset_counts()                                  # phase 18 path starts
    record["lint"], expected = lint_phase(torch, dev, x, y, layout, log)
    lint_launches = record["lint"].pop("launches")  # phase 18 path ends
    check_idle(_libs()[1:], "the phase 18 path")
    check(lint_launches == {p: expected[p] for p in vg.PROGRAMS},
          f"phase 18 launches {lint_launches} != {dict(expected)} "
          "implied by the census epochs and the lint's storage audit")
    check(all(lint_launches[p] for p in ("vfl_forward_narrow",
                                         "vfl_forward_wide",
                                         "vfl_backward_rows",
                                         "vfl_fused_split")),
          f"a kernel of the phase 18 path was never launched: "
          f"{lint_launches}")
    log(f"phase 18 path: kernel launches {lint_launches}, as the epochs "
        "imply")
    record["lint_launches"] = lint_launches
    record["lint"]["seconds"] = time.perf_counter() - t18
    log(f"phase 18: {record['lint']['seconds']:.1f} s")
    del x, y                                       # free phases 7-18's data
    torch.cuda.empty_cache()

    t9 = time.perf_counter()
    record["lm"], scan_launches = lm_phase(torch, dev, log)
    record["lm"]["seconds"] = time.perf_counter() - t9
    log(f"phase 9: {record['lm']['seconds']:.1f} s")
    t10 = time.perf_counter()
    record["dense"], dense_launches = dense_phase(torch, dev, log)
    record["dense"]["seconds"] = time.perf_counter() - t10
    log(f"phase 10: {record['dense']['seconds']:.1f} s")
    t19 = time.perf_counter()
    record["lm_train"], lm_train_launches = lm_train_phase(torch, dev, log)
    record["lm_train"]["seconds"] = time.perf_counter() - t19
    log(f"phase 19: {record['lm_train']['seconds']:.1f} s")
    t20 = time.perf_counter()
    record["moe"], moe_launches = moe_phase(torch, dev, log)
    record["moe"]["seconds"] = time.perf_counter() - t20
    log(f"phase 20: {record['moe']['seconds']:.1f} s")
    t21 = time.perf_counter()
    record["hybrid"], hybrid_launches = hybrid_phase(torch, dev, log)
    record["hybrid"]["seconds"] = time.perf_counter() - t21
    log(f"phase 21: {record['hybrid']['seconds']:.1f} s")
    t22 = time.perf_counter()
    record["frontends"], frontend_launches = frontend_phase(torch, dev, log)
    record["frontends"]["seconds"] = time.perf_counter() - t22
    log(f"phase 22: {record['frontends']['seconds']:.1f} s")
    t23 = time.perf_counter()
    record["dry_run"], dry_launches = dry_phase(torch, dev, log)
    record["dry_run"]["seconds"] = time.perf_counter() - t23
    log(f"phase 23: {record['dry_run']['seconds']:.1f} s")
    t24 = time.perf_counter()
    record["dist"], dist_launches = dist_phase(torch, dev, log)
    record["dist"]["seconds"] = time.perf_counter() - t24
    log(f"phase 24: {record['dist']['seconds']:.1f} s")
    record["seconds"] = time.perf_counter() - t_start

    # each program's line reports its own main-path shape: serving's linear
    # full dispatch and deep layer 1, training's SGD step, the
    # full-dataset pass's reduce and the pipelined SGD step; launches are
    # summed over every path
    main_shape = {"vfl_forward_narrow": "linear_full",
                  "vfl_forward_wide": "deep_layer1",
                  "vfl_backward_rows": "train_sgd_step",
                  "vfl_backward_reduce": "full_dataset_reduce",
                  "vfl_fused_split": "pipe_sgd_step"}
    shapes = record["kernel_shapes"]
    entries = []
    for prog in vg.PROGRAMS:
        row = next(r for r in shapes if r["name"] == main_shape[prog]
                   and prog in r["programs"])
        entries.append({
            "name": prog, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/vfl_grad.cu",
            "replaces": "src/repro/kernels/vfl_grad.py:343",
            "launches": serve_launches[prog] + train_launches[prog]
            + pipe_launches[prog] + stale_launches[prog]
            + deep_launches[prog] + deep_stale_launches[prog]
            + fault_launches[prog] + deep_fault_launches[prog]
            + mesh_launches[prog] + serve_async_launches[prog]
            + lint_launches[prog] + dist_launches.get(prog, 0),
            "max_abs_err": max(r["max_abs_err"] for r in shapes
                               if prog in r["programs"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    scan = record["scan_shapes"]
    row = next(r for r in scan if r["name"] == "prefill")
    entries.append({
        "name": "selective_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
        "replaces": "src/repro/kernels/selective_scan.py:62",
        "launches": scan_launches + lm_train_launches["selective_scan"]
        + hybrid_launches["selective_scan"]
        + dry_launches.get("selective_scan", 0),
        "max_abs_err": max(r["max_abs_err"] for r in scan),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None})
    # the attention programs at phase 10's local-window shape (29 of the
    # 34 layers); launches are phase 10's, 20's, 21's and 22's serve
    # calls' and phase 19's no-grad forwards
    for prog, key, src, tpu in (
            ("flash_attention", "flash_shapes", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:93"),
            ("decode_attention", "decode_shapes", "decode_attention.cu",
             "src/repro/kernels/decode_attention.py:79")):
        rows = record[key]
        row = next(r for r in rows if r["name"] == "local")
        entries.append({
            "name": prog, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": tpu,
            "launches": dense_launches[prog] + lm_train_launches[prog]
            + moe_launches[prog] + hybrid_launches[prog]
            + frontend_launches[prog] + dry_launches.get(prog, 0),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    kernels = {"kernels": entries}
    out_dir = ROOT / "results"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(f"total {record['seconds']:.1f} s; details in "
        "results/chip_smoke.json")
    print(smi)
    print(json.dumps(kernels))
    # the run used one card, whatever else the host exposes
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
