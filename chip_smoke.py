#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``autodist_tpu_torch/kernel/csrc``
(at first use, into a git-ignored directory) and drives the port's
paths: serving the pipelined LM at the serve bench's width (vocab 32768,
hidden 1024, 16 heads of 64, mlp 4096, 8 layers, max_len 1024),
training BERT-base masked-LM through ``AutoDist`` + ``AllReduce``,
the data-parallel strategy zoo on BERT (every builder of the collective
lowering, the compressors and accumulation, the default
``AutoDist(rs)``), Megatron tensor-parallel training of the pipelined
LM through
``Pipeline(tensor_parallel=2, vocab_parallel=True)`` at one pipe device
and on ``bench.py quant``'s 4-device mesh (the cross-process pipe
schedule over a pipe axis of 2, interleaved, with the Megatron stages
inside and the vocabulary sharded over the model axis), expert-parallel
training of the MoE LM through ``ExpertParallel`` on an expert axis of
2, serving at tensor parallel 2, and sequence-parallel training of the
causal LM through ``SequenceParallel`` on a seq axis of 2 (ring
attention over K1/K2a/K2b), the training lifecycle around a runner
(``fit``, eval, checkpoints and resume, export, ``serve(artifact=)``),
the GSPMD builders, asynchronous PS and the stale-synchronous gate
over the coordination service, the model zoo (ResNet-50, VGG16,
DenseNet121, InceptionV3, NCF and the lm1b LSTM), and the runtime and
elasticity layer (``Cluster``, fault plans, ``restore_elastic``, the
``ElasticController``):

1. each kernel against its plain PyTorch version, fp32 (atol = rtol =
   1e-5) and bf16 (atol = rtol = 1e-2), timed with CUDA events beside
   the plain version, one PyTorch library call and the card's bound,
   each time with its achieved TFLOP/s:
   K5-K7 at the serving shapes, and again at the serve mix's occupancy
   (K5, K6: lengths 1-192; K7: 32 slots whose 64-row chunks start at 0),
   there also at a tensor-parallel rank's 8 heads (phase 10), and
   with one slot of 1024 keys (K7: a chunk at 960); K1, K2a
   and K2b at BERT-base's q/k/v ``[16, 512, 12, 64]`` and at ragged
   lengths 100 and 17, causal and not, and in bf16 at the ring chunk of
   phase 12, ``[8, 1024, 16, 64]``, full and causal (with the K2
   pair there); the registers, spills and static
   shared memory of K1, K2a, K2b (bf16), K5, K6 and K7 (both dtypes: K7's
   tensor-core and CUDA-core instances) from
   ``nvcc -Xptxas -v``; K1 causal at the serving prompt buckets of 8
   prompts, 16, 64 and 512 (timed in bf16 at 64 and 512), and K7 at the
   speculative verify window (8 slots, 5 rows at ragged starts, blocks
   of 16); the K2 pair (the whole autograd backward
   through K2a and K2b, and its delta and casts alone) against SDPA's
   backward; K3 bit for bit (levels and scale) at the ring's chunk of
   2^21 elements, at the vocab-parallel prologue's 2^22, at 1, 1000,
   2^20 + 3 and 2^23 + 5 (more than the grid
   holds in registers), on exact ties (halves at scale 1), on all-zero
   chunks, with a NaN in local, and with
   q_in and local off a 16-byte boundary, each call one device kernel
   (``torch.profiler``), timed beside a plain copy of the same bytes;
   K4 at the two row-parallel shapes of phase 7, at a ragged 100 x 72 x
   40 and (bf16) at 100 x 70 x 38, whose unaligned rows the wrapper
   stages for TMA (counted); K8 bit for bit (arrived, levels and scale)
   at the MoE window's chunks of 2^21 and 2^20 elements and at 1, 1000,
   2^20 + 3 and 2^23 + 5, in the warm-up (scale_in 0, also on exact
   ties), a hop, the last
   hop (all-zero nxt), with a NaN in nxt, off a 16-byte boundary and
   writing arrived into a row of a wider output, each call one device
   kernel; the registers of K3's and K8's kernels;
2. fp32 parity: 4 requests through ``ContinuousBatcher`` on the dense
   and on the paged + chunked engine, each stream equal token for token
   to a greedy full recompute by ``sequential_logits`` (a divergence
   counts as a tie only where the reference's top two logits are within
   1e-4);
3. bf16 serving of the bench mix on both engines, each twice: with
   every decode window one CUDA-graph replay (the main path: one
   capture in the warm-up, then a replay a window, asserted) and with
   the window body launched from the host (``decode_graph=False``),
   the two routes' streams equal token for token; the kernels' launch
   counters held to the attention calls the engines made (and K7's
   CUDA-core instance to none: the serve path is bf16 over blocks of
   16), a profiled window's device time on each route, the flash
   decode kernel's included, and on the paged engine a profiled
   prefill chunk of 16 prompts with K7's device time a chunk;
4. fp32 training parity: a 2-layer BERT at full width, 3 AdamW steps
   with the flash attention and with the einsum attention on the same
   weights and batches, every loss within 1e-4 relative;
5. the bench's BERT-base training window in bf16 (``bench.py`` ``_bench``
   on one card: batch 16, seq 512, 76 masked, adamw(1e-4, weight decay
   0.01, bf16 first moments), ``AllReduce(chunk_size=256)``), with the
   flash and with the einsum attention, each on two routes: a warm
   30-step ``run_steps`` window (its capture) and a timed one, each one
   CUDA-graph replay (the main path; one capture and two replays
   asserted), then a warm and a timed loop of 30 ``step`` calls; K1,
   K2a and K2b held to 12 x 30 launches each on either route;
   examples/s, step time, MFU, peak memory (the capture's included),
   the capture's seconds, the profiler's busy share and launches per
   step;
6. fp32 tensor- and pipeline-parallel parity: the pipelined LM at full
   width cut to 2 layers, seq 128, 3 Adam steps, against one process at
   T = 1 (1e-4 relative): composed fp32 on T = 2 ranks at pipe 1, on a
   pipe axis of 2 (GPipe, 2 ranks) and on pipe 2 x model 2 (4 ranks);
   at pipe 1 and at pipe 2 x model 2 the fused collective matmul against
   the composed one (1e-5), the quantized ring against the composed
   int8 program (2e-2), and ``vocab_parallel`` against the full-vocab
   head (1e-5);
7. the slice's window in bf16 (``bench.py quant`` on an accelerator: 4
   layers, max_len 512, batch 16, ``num_microbatches=2``,
   ``adam(1e-3)``, ``vocab_parallel=True`` as ``bench.py:342`` runs
   it) for the composed fp32, composed int8 (the bare ``"int8"`` string
   of ``bench.py:342``: ``tp_psum``, ``vocab_stats`` and the ``grad``
   slot's ``int8_ef``), ``quant_ring`` (the same string and the fused
   ring) and ``collective_matmul`` programs, at pipe 1
   (``virtual_stages=4``, 2 ranks) and on ``bench.py quant``'s 4-device
   mesh, pipe 2 x model 2 (``virtual_stages=2``, 4 ranks), there also
   fp32 with the full-vocab head: tokens/s, step ms, peak memory per
   rank (the last pipe coordinate's held below the full head's),
   the profiler's busy share and K3's device time per step, the K3 and
   K4 launches of every rank held to 66 and 32 per step at pipe 1 and
   34 (pipe rank 0: the prologue's lookup ring) or 32 and 16 at pipe 2
   (a bubble tick runs no stage), no K4 operand staged and no K3 hop
   off the vector path; over gloo the lowering stages through host
   memory, and ``run_steps`` is asserted to keep its host loop (no
   capture);
8. fp32 MoE parity: the MoE LM at full width (vocab 32768, hidden 1024,
   16 heads, expert hidden 4096, 8 experts) cut to 1 layer, seq 128,
   batch 8, capacity factor 4.0 (no token is dropped, so sharded and
   dense routing agree), 3 Adam steps: the composed fp32, composed int8
   and ``a2a_ring`` programs on an expert axis of 2 against the dense
   one-process model through ``AllReduce``, every nll within 5e-3
   (``adam(1e-4)``);
9. the MoE window in bf16 (``bench.py moe`` on an accelerator: 2
   layers, max_len 512, capacity factor 2.0, 2 rows per rank,
   ``adam(1e-3)``, nothing cut) for the composed int8 and ``a2a_ring``
   programs: a warm window of 10 steps, then a timed one; tokens/s,
   step ms, peak memory per rank, the profiler's busy share and K8's
   device time per step, and K8 held to 16 launches a step (2 layers x dispatch and
   combine x forward and backward x 2 hops), none off the vector path,
   and ``run_steps`` on the host loop as in phase 7;
10. serving at tensor parallel 2 with the vocabulary sharded, on the
   serve mix's model cut to 4 layers (8 of the 16 heads a rank): fp32 streams
   of 3 requests on the dense and the paged + chunked engine equal the
   one-process engine's (a divergence counts as a tie where the
   recompute's top two logits are within 1e-4), then the bf16 serve mix
   on both: tokens/s, TTFT, inter-token latency, peak memory per rank,
   K5-K7 held to the attention calls; over gloo the decode windows run
   the host loop (asserted);
11. fp32 sequence-parallel parity: ``TransformerLM`` at full width cut
   to 2 layers, global seq 256, batch 4, 3 Adam steps on a seq axis of
   2 with the flash ring, the einsum ring and the flash ring under
   ``remat``, every loss within 1e-4 relative of one process running
   ``flash_attention`` causal over the whole sequence (remat against no
   remat: 1e-6);
12. the sequence-parallel window in bf16 (``bench.py:442-446``'s model,
   nothing cut: 4 layers, max_len 2048; batch 8 of 2048 tokens,
   ``adamw(3e-4)`` as ``examples/long_context.py`` trains it, the flash
   ring on ``{"seq": 2}``): a warm window of 3 steps, then a timed
   one; tokens/s (the slowest rank), step ms, peak memory per rank, each
   rank's busy share and K1/K2a/K2b device time a step, K1, K2a and K2b
   held to 4 x (index + 1) launches a rank and step (a causal ring skips
   the chunks after the rank's own); then the long-context rows, batch 1
   of 8192 tokens (the positional table grown to 8192 rows), remat off
   and on (K1 doubled under remat), beside one process at the whole
   sequence; over gloo ``run_steps`` keeps its host loop (asserted);
13. fp32 parity of the data-parallel strategy zoo: BERT at full width
   cut to 2 layers (seq 128, batch 4 a rank, flash, dropout 0), 3
   ``adamw(1e-4, eps=1e-4, weight_decay=0.01)`` steps (an eps that keeps
   the k bias's zero gradient's noise from whole steps) of every
   builder of the JAX golden list,
   ``GradAccumulation(AllReduce(), 2)`` and ``AllReduce`` with each of
   the seven compressors, on 2 ranks over gloo (and over NCCL, one rank
   a card, where there are cards): ``get_params`` has the logical
   shapes; compressor-free builders' losses and parameters within 1e-5
   relative (per tensor, of its largest value floored at 1e-3) of
   ``AllReduce``'s; a compressed run's loss at step k within ``eps x k``
   of it relative (``eps`` the wire's unit: fp16 2^-11, bf16 2^-8, int8
   2/127; PowerSGD 1: a rank-2 wire bounds nothing, so its first loss and
   finite losses are what is held); the stored bytes a
   rank of PS (optimizer state) and PartitionedPS (both) at ``1/n`` of
   AllReduce's, printed;
14. the zoo on the bench's BERT-base window (bf16, batch 16, seq 512, 76
   masked, ``adamw(1e-4, 0.01, mu bf16)``, flash, nothing cut): on one
   card on the graph route, ``AutoDist(rs)`` with no builder
   (``PSLoadBalancing``), ``PartitionedPS``, ``AllReduce(256)`` with
   ``bf16_ef``, ``int8_ring``, ``int8_ef`` and ``powersgd:2``,
   ``GradAccumulation(AllReduce(256), 2)`` and ``AllReduce(256)``, each a
   warm and a timed 10-step window (one capture, two replays, K1/K2a/K2b
   held to 12 x 10 launches, twice that under accumulation): examples/s,
   step ms, MFU, peak memory, stored bytes, capture seconds; then
   ``PS``, ``PartitionedPS`` and ``AllReduce`` at data 2 on 2 ranks over
   gloo (2 steps, host loop): per-rank peak memory and stored bytes;
   with 2 or more cards every row again over NCCL at data = the cards,
   each row's parameters within 0.1 of one card's update (L2 over the
   tree) on the same batches;
15. fp32 parity of ZeRO, compressors, accumulation and remat in the
   pipeline, sequence and expert lowerings, four jobs at once on card
   0: the pipelined LM at full width cut to 2 layers (1 at pipe 1; seq
   128, batch 8, 2 ``adam(1e-3, eps=0.1)``
   steps: an eps that keeps the k bias's zero gradient's noise from
   whole steps) on data 2 x pipe 2 and on data 2 x model 2 with
   ``vocab_parallel`` (4 ranks each): ZeRO-1, 2 and 3, the
   ``zero_min_bytes`` mix of ZeRO-3 and ``bf16_ef``, ZeRO-3 with the
   ``zero3_gather`` slot at bf16, ``bf16_ef``, the ``"int8"`` string
   (on the vocab mesh every slot of it but ``vocab_stats``, whose int8
   sum rounds a confident token's sum-exp to 0 at this fp32 width, in
   both packages), ``GradAccumulation(..., 2)`` and ``remat``, and on
   the vocab mesh the
   ``quant_ring`` program under remat (K3 held to the recomputed
   forward rings: 26 a step on 1 layer), each against the plain
   program of its mesh by phase 13's rule (1e-5 per tensor and loss for
   exact wires; a narrowed wire's loss at step k within its unit x k);
   the causal LM's ZeRO-3 with the flash ring on seq 2 (phase 11's
   model; K1/K2a/K2b held to the ring's calls) and the MoE LM's ZeRO-1
   with ``a2a_ring`` on expert 2 (phase 8's; K8 held to 8 a step), each
   against its plain program; every row's stored bytes a rank checked
   variable by variable against what ZeRO promises (optimizer state at
   ``1/n``, at stage 3 the parameter too, a degraded variable whole, as
   its record says) and printed;
16. the bf16 windows under ZeRO: the pipelined LM at ``bench.py
   quant``'s width, 4 layers, batch 16 of 512, on data 2 x pipe 2,
   plain, ZeRO-1, ZeRO-3, ``GradAccumulation 2`` and ``remat``, and
   phase 12's sequence window on seq 2 (cut to 2 layers) plain and
   under ZeRO-3 (K1/K2a/K2b held to the ring's calls), each a warm and
   a timed window of 1 step: step
   ms, peak memory and stored bytes a rank beside the plain row's, the
   ZeRO-3 rows' parameters at most 0.51 and ZeRO-1's optimizer state at
   most 0.51 of the plain row's (asserted); 4 and 2 ranks over gloo on
   card 0, and over NCCL on the graph route, one rank a card, where the
   machine has the cards (captures asserted);
17. fp32 parity of the serving ladder: the serve width cut to 2 layers,
   4 requests on a shared 2-block prefix (the first admitted alone, the
   last repeating its prompt so that its partial tail is shared and
   copied on write) through ``ContinuousBatcher`` on 14 engines, each
   with the prefill graph and eagerly: dense, paged and paged + chunked,
   greedy and sampled (``temperature=0.9, top_k=40``), prefix-cached,
   speculative (k 4, a same-weights and a 1-layer other-weights draft)
   and K1 in the prefill; every stream equal to a full recompute
   (``sequential_logits``, and sampled the port's epilogue at the same
   seed and position, phase 2's tie rule), the graph route's to the
   eager one's, the speculative and cached engines' to their vanilla
   engine's; launches equal to the calls, one prefill and one window
   graph replayed at every call after the first; the pools idle; the
   allocator's trace replayed with no write on a shared block;
18. bf16 at the serve widths: the serve mix on dense and paged + chunked
   with the prefill graph, eagerly, and sampled (tokens/s, TTFT,
   inter-token, a profiled prefill's wall, device busy and launches);
   ``bench.py serve --prompt-mix shared-prefix``'s configuration paged
   alone, prefix-cached and with K1 in the 512-token prefill (peak
   admitted, hit blocks, TTFT; in the bench's order the JAX engine's
   18, 18 and 48 hits, and with the prefix resident first the cached
   run admitting strictly more); ``bench.py serve --speculative 4``'s
   configuration vanilla and speculative (tokens/s, acceptance); every
   run's launches equal to its calls (K1 8 a single-shot prefill, K7 8
   a chunk or verify window, K5/K6 8 a token step, the draft's 1) and
   its graphs' captures and replays to the shapes and calls;
19. the training lifecycle on BERT-base bf16 (phase 5's configuration,
   the graph route): ``fit`` over 16 steps in windows of 4 with eval
   every 8 (2 batches) and a ``Saver`` checkpoint every 8; a fresh
   runner resumed from the step-8 checkpoint and run to 16, twice: the
   two resumed runs and three uninterrupted ones all bit-equal (the
   step is deterministic on the card); fit's eval against
   ``eval_step`` by hand; an async save followed at once by a window,
   restored into a fresh runner equal to the state at save time; K1,
   K2a and K2b held to the steps and eval batches, captures to one per
   window size and replays to the windows; printed: fit's examples/s
   beside a bare ``run_steps`` window's, a blocking save's seconds and
   bytes, the async save's stall, restore seconds, eval ms a batch, and
   the ``DataLoader``'s per-step loop beside ``step`` on placed batches;
20. export and serve: the pipelined LM at the serve widths (bf16) fitted
   4 steps through ``Pipeline`` at data 1 x pipe 1 x model 1 (graph
   route), exported from the runner (``export_model``) and reloaded
   (``load_exported`` on the card: logits within 1e-2 of the largest
   live logit); ``serve(cfg, artifact=dir)``'s greedy streams equal,
   token for token, to ``serve(cfg, runner=runner)``'s on the dense and
   paged + chunked engines (16 requests of 64 tokens; K5, K6 and K7 held
   to the calls); printed: export seconds, artifact bytes, tokens/s
   from the artifact beside the runner's;
21. tensor and pipeline leftovers, ranks sharing card 0 over gloo: (a)
   the fp32 parity at 2 layers, model 2, of ``comm_overlap="rsag"``,
   ``"rsag"`` with ``tp_psum`` int8, ``"matmul"`` with ``tp_psum`` int8
   and the fused ``collective_matmul`` kernel, and ``"rsag"`` with
   ``vocab_stats`` bf16 against the blocking program (exact wires 1e-5
   per tensor and loss, a narrowed wire's loss at step k within its unit
   x (k + 1) relative), then ``bench.py quant``'s bf16 window under them
   (a timed step after a warm one) at model 2 and pipe 2 x model 2 (the slowest rank's step ms and
   tokens/s beside phase 7's blocking fp32, peak memory per rank, K4
   held to the calls); (b) the pipelined LM with dropout 0.1 (full width,
   2 layers, fp32) at pipe 2, M = 2 and 4, against its sequential
   program (1e-5), eval deterministic and apart from the train loss, and
   at pipe 1 a captured window of 2 steps against a loop of ``step``
   calls at the same seeds (the keyed masks read the seed from a static
   buffer); (c) ``stage_aux`` on dict activations against the
   sequential loss; (d) the tp-2 dense and paged + chunked engines under
   ``"rsag"``: fp32 streams equal to the blocking engine's, the bf16
   serve mix with K5-K7 held to the calls;
22. the GSPMD builders on DTensor: BERT (phase 5's configuration, flash)
   through ``TensorParallel()`` and ``FSDPSharded()`` in one process at
   data 1 x model 1 (a gloo group of ranks sharing a card does not carry
   DTensor's all-gathers): fp32 params after 3 SGD steps at 2 layers
   against ``AllReduce`` (2e-5 / 2e-6), then the bf16 BERT-base window on
   the graph route (captures and replays asserted), K1/K2a/K2b held to
   12 x 10 launches, step ms and examples/s beside phase 5's, and the
   collectives a step issued;
23. asynchronous PS and the SSP gate: (a) fp32, phase 22's 2-layer BERT
   (flash, dropout 0, SGD), one ``AsyncPSRunner`` worker through
   ``AutoDist({}, PS(sync=False))`` with ``wait_applied`` after each of
   3 steps, its params within 1e-5 of each tensor's largest value
   (floor 1e-3) of the synchronous ``PS()`` runner's on the same
   batches; (b) phase 5's BERT-base bf16 configuration on the async
   path: the chief (this process: the PS thread on its own CUDA stream
   and one worker) and a spawned worker (``AUTODIST_TPU_WORKER``, the
   chief's ``AUTODIST_TPU_COORD_SERVICE``) share card 0, 3 pushes each;
   all 6 updates applied, losses finite, K1/K2a/K2b held to 12 x the
   steps of both processes (the worker's counts come back through the
   coordination KV); printed: seconds a step, the device's gradient ms,
   the host's pull, pack and push seconds, a push's bytes, the PS's
   apply ms and the push, pull, pull_skip, apply and publish counts;
   (c) the SSP gate at staleness 1: two 2-layer bf16
   ``DistributedRunner``s in two processes on card 0, this one and
   (b)'s spawned worker (the gate asserted on), the slow one sleeping
   0.3 s before each step, the fast one's
   completions held to the reference's c9 rule (step 2 before 0.29 s,
   3 after 0.29 s, 4 after 0.59 s) and the ``ssp/gate_wait_s`` waits
   printed; then a gated ``run_steps`` window (dropout 0.1) equal to a
   loop of ``step`` calls at the same seeds with no capture, and the
   same strategy at staleness 0 capturing one graph;
24. the model zoo (``autodist_tpu_torch.models``), no kernel of the port
   on its path (cuDNN's convolutions and LSTM, cuBLAS's GEMMs; the
   launch counters held to 0): fp32 first, ResNet18 with BatchNorm (16
   filters, 64 px) and lm1b (vocab 2000, widths 64) through ``AllReduce``
   and ``Parallax``, a captured window of 3 steps against a loop of
   ``step`` calls at the same seeds (params and ``batch_stats`` within
   1e-5 of each tensor's largest value, floor 1e-3); then every model at
   full width on the graph route, a warm and a timed window of 5 steps
   each (one capture and two replays asserted, losses finite):
   ResNet-50 (224 px, batch 128), VGG16 (224, 64), DenseNet121 (224, 64)
   and InceptionV3 (299, 64) in bf16 through ``AllReduce`` with
   ``examples/benchmark/imagenet.py``'s chunk sizes and ``sgd(0.1,
   momentum=0.9)``; NCF at ``ncf.py``'s full preset (6040 users, 3706
   items, batch 1024, ``adam(1e-3)``, ``AllReduce``) and lm1b at
   ``LSTMWordLM``'s widths (vocab 800000, embed 512, hidden 1024, 2
   layers; batch 32 x 20, 64 samples, ``Parallax``, ``adagrad(0.2)``),
   both fp32 as the JAX models compute; printed: step ms, examples/s,
   peak memory, capture seconds and, for the ImageNet models, the MFU at
   989 TFLOP/s from imagenet.py's forward GFLOPs (x 3); then one more
   replay under the profiler: device busy share and the top kernels a
   step;
25. runtime and elasticity (``chip_smoke.py`` starts a chief process,
   which launches each of two jobs through ``LocalCluster(1)``: one
   worker process, this script again; both ranks ``bootstrap()`` from
   the ``multihost`` env, over gloo sharing card 0, or NCCL one rank a
   card where the machine has 2 or more, printed so): (a) fp32, phase
   22's 2-layer BERT (flash, dropout 0, ``adam(1e-2, eps=1e-3)``: phase
   13's rule, lr / eps bounds how far Adam scales a gradient's
   rounding), the chief publishes ``PS()`` and the worker loads it (JSON
   equal); a fault plan shipped in ``AUTODIST_TPU_FAULT_PLAN`` fires
   ``preempt_signal`` on both ranks at step 2, both save (the sidecar
   written), the worker departs and the chief's
   ``ElasticController.resume(strategy=AllReduce(), spec={})`` restores
   alone by the staged route (asserted, the whole state bit-equal to
   the 2-rank job's at the save: every leaf at its logical shape,
   Adam's ``mu``, ``nu`` and count included, the seed stream and the
   host step; the gap to the one-rank run at step 2 printed) and
   steps twice: params within 1e-5 of each tensor's largest value
   (floor 1e-3) of an uninterrupted one-rank ``AllReduce`` run of the 4
   steps; every injected fault record paired with its terminal one; (b)
   before that, on the same 2 ranks at dropout 0.1, ``hot_swap`` from
   ``AllReduce`` to ``PS`` after 2 steps by the fast route (asserted),
   then 2 steps, within the same bound of the unswapped run at the same
   seed streams; (c) phase 5's BERT-base bf16 configuration through
   (a)'s flow at 2 ranks, then on the chief alone: the whole state back
   bit-equal to the saved one as in (a), its ``mu`` bf16, a warm and a
   timed graph-route
   window of 2 steps (finite loss), and a hot swap onto ``PS`` (fast
   route); K1/K2a/K2b held to 12 x the steps of both ranks.  Printed:
   (a)'s job's seconds from ``launch_clients`` to the chief's first step
   (job (c)'s worker starts meanwhile and waits at its rendezvous); step
   ms before (gloo or NCCL) and after the shrink (one rank, graph
   route); save seconds and bytes and the sidecar's bytes;
   ``restore_elastic`` seconds, route and ``peak_host_bytes``;
   ``hot_swap`` seconds and the device bytes it allocates above the two
   states;
26. multi-slice (the ``dcn`` axis): 4 ranks, one a card over NCCL where
   the machine has 4 cards, else over gloo on card 0 (chosen by the
   device count).  (a) BERT-base (fp32 at 2 layers, seq 128, 3 AdamW
   steps) through ``AllReduce`` on ``{"dcn": 2, "data": 2}``, its
   params within 1e-4 of one rank's update on the same global batches
   (phase 14's measure, over the tree), then the bf16 window at full
   depth (a warm
   step, a timed window, K1/K2a/K2b held to 12 x its steps a rank);
   (b) the pipelined LM at the serve width cut to 4 layers, fp32,
   ``Pipeline(virtual_stages=2)`` on ``{"data": 2, "pipe": 2}``: two
   steps, a save (its sidecar), one step more; the checkpoint restored
   by ``restore_elastic`` on one rank (``{"pipe": 1}``, V = 4): the
   logical state bit-equal to the source's at the save, the next loss
   within 1e-5 of the uninterrupted run's; the save's and the
   restore's seconds and bytes; (c) the MoE LM of phase 8 at fp32 under
   ``ExpertParallel(expert_over_dcn=True)`` on a 2-slice spec against
   plain ``ExpertParallel`` on the same mesh, 3 steps: on one host the
   flag moves no collective, so the two are held bit-equal, the flag
   recorded and ADT061 on the first plan alone.  Two levels of
   the network cannot be told apart on one host: ``dcn`` on these cards
   is a program-correctness run, not a cross-node measurement, and
   every line says so;
27. one ``{"kernels": [...]}`` line, the card's name and power limit, and
   last the ``{"ok": true, "device": ...}`` line.

Phases 2, 4, 6 (at T = 1), 8 (the dense model) and 11 (one process)
run one process on the card, so their windows replay CUDA graphs too.
Phases 6 to 16 run 2 or 4 processes (``torch.multiprocessing`` spawn;
phase 15 four such jobs at once) on card 0, joined in a gloo group: NCCL refuses two ranks on one device, so each transfer is
staged through host memory while the kernels, the model and the
optimizer stay on the card.  Their numbers are labelled so, and say
nothing about multi-GPU speed.  Where the machine has at least 2 cards,
phases 7 (pipe 1, and a pipe axis of 2 in fp32), 9 and 10 run again
over NCCL, one rank per card (phase 10 on the graph route: one capture,
then a replay a window, asserted) and 12 (seq 2, on the graph route,
asserted), and with 4 cards phase 7's pipe 2 x model 2 and phase 12 at
seq 4 too; each prints apart.  Every rank joins and leaves the job through
``autodist_tpu_torch.testing`` (a barrier before the groups go).

Any failed check raises, in any rank, and the script exits non-zero;
without a CUDA device it exits 2 and prints no result.  ``--phases 7,9``
(a comma-separated list) runs only those phases and prints no kernels
line.  Each phase prints its seconds.  Imports torch, numpy and
``autodist_tpu_torch`` only.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.multiprocessing as mp

import autodist_tpu_torch as port
from autodist_tpu_torch import telemetry, testing
from autodist_tpu_torch.analysis import lint_plan
from autodist_tpu_torch.kernel import a2a_ring as ar
from autodist_tpu_torch.kernel import build
from autodist_tpu_torch.kernel import collective_matmul as cm
from autodist_tpu_torch.kernel import flash_decode as fd
from autodist_tpu_torch.kernel import flash_prefill as fp
from autodist_tpu_torch.kernel import quant_ring as qr
from autodist_tpu_torch.kernel.common import flatten_with_names, unflatten
from autodist_tpu_torch.models import bert, moe_transformer
from autodist_tpu_torch.models.pipeline_lm import (make_pipeline_lm_trainable,
                                                   sequential_logits)
from autodist_tpu_torch.parallel import ring_attention as ra
from autodist_tpu_torch.parallel.sequence import global_positions
from autodist_tpu_torch.parallel.tensor import sampled_scores
from autodist_tpu_torch.runner import _pack_tree
from autodist_tpu_torch.strategy.parallel_builders import Pipeline
from autodist_tpu_torch.resource import H100
from autodist_tpu_torch.serving import FINISH_REASONS, kv_cache

fa = importlib.import_module("autodist_tpu_torch.ops.flash_attention")

# Published H100 SXM rates (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = H100.hbm_gbps * 1e9
PEAK_FLOPS = {torch.bfloat16: H100.peak_bf16_tflops * 1e12,
              torch.float32: H100.peak_fp32_tflops * 1e12}

VOCAB, HIDDEN, LAYERS, HEADS, MLP, MAX_LEN = 32768, 1024, 8, 16, 4096, 1024
HEAD_DIM = HIDDEN // HEADS
BLOCK_LEN, NUM_BLOCKS, CHUNK = 16, 512, 64
SPEC_K = 4                # bench.py serve --speculative's default k
PREFILL_BUCKETS = (16, 64, 512)
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # atol = rtol

KERNELS = {
    "flash_decode": dict(
        wrapper=fd.flash_decode_attention,
        source="autodist_tpu_torch/kernel/csrc/flash_decode.cu",
        replaces="autodist_tpu/kernel/pallas/flash_decode.py:45"),
    "flash_decode_paged": dict(
        wrapper=fd.flash_decode_attention_paged,
        source="autodist_tpu_torch/kernel/csrc/flash_decode.cu",
        replaces="autodist_tpu/kernel/pallas/flash_decode.py:148"),
    "flash_prefill_paged": dict(
        wrapper=fp.flash_prefill_attention_paged,
        source="autodist_tpu_torch/kernel/csrc/flash_prefill.cu",
        replaces="autodist_tpu/kernel/pallas/flash_prefill.py:48"),
    "flash_attention_fwd": dict(
        wrapper=fa.flash_attention_fwd,
        source="autodist_tpu_torch/kernel/csrc/flash_attention.cu",
        replaces="autodist_tpu/ops/flash_attention.py:145"),
    "flash_attention_bwd_dq": dict(
        wrapper=fa.flash_attention_bwd_dq,
        source="autodist_tpu_torch/kernel/csrc/flash_attention.cu",
        replaces="autodist_tpu/ops/flash_attention.py:246"),
    "flash_attention_bwd_dkv": dict(
        wrapper=fa.flash_attention_bwd_dkv,
        source="autodist_tpu_torch/kernel/csrc/flash_attention.cu",
        replaces="autodist_tpu/ops/flash_attention.py:288"),
}
KERNELS.update({
    "quant_ring_hop": dict(
        wrapper=qr.fused_hop,
        source="autodist_tpu_torch/kernel/csrc/quant_ring.cu",
        replaces="autodist_tpu/kernel/pallas/quant_ring.py:48"),
    "collective_matmul_hop": dict(
        wrapper=cm.fused_matmul_add,
        source="autodist_tpu_torch/kernel/csrc/collective_matmul.cu",
        replaces="autodist_tpu/kernel/pallas/collective_matmul.py:35"),
    "a2a_ring_hop": dict(
        wrapper=ar.fused_hop,
        source="autodist_tpu_torch/kernel/csrc/a2a_ring.cu",
        replaces="autodist_tpu/kernel/pallas/a2a_ring.py:52"),
})
SERVING_KERNELS = ("flash_decode", "flash_decode_paged", "flash_prefill_paged")
TRAINING_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                    "flash_attention_bwd_dkv")
# K2a and K2b share one library call, SDPA's backward (the K2 pair).
PAIR = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
TP_KERNELS = ("quant_ring_hop", "collective_matmul_hop")
MOE_KERNELS = ("a2a_ring_hop",)

# Step ms and rate of phases 5 and 7's rows, for phases 21 and 22 to
# print beside theirs: (kind or backend, label, route or program).
WINDOW_TIMES: dict = {}

# BERT-base (bench.py _bench on an accelerator).
BERT_BATCH, BERT_SEQ, BERT_MASKED, BERT_STEPS = 16, 512, 76, 30
# Phase 14's windows, shorter than phase 5's to keep the script's time:
# on one card, and of the gloo rows (seconds a step each).
ZOO_STEPS, ZOO_GLOO_STEPS = 10, 2

# The tensor-parallel window (bench.py quant on an accelerator): at one
# pipe device, and on bench.py quant's 4-device mesh, pipe 2 x model 2
# (V = 2 chunks a pipe rank).
TP, TP_LAYERS, TP_SEQ, TP_BATCH, TP_MICRO, TP_STEPS = 2, 4, 512, 16, 2, 2
PIPE = 2
TP_MESH = {"data": 1, "pipe": 1, "model": TP}
QUANT_MESH = {"data": 1, "pipe": PIPE, "model": TP}
# K3's chunk on that path: one [8, 512, 1024] boundary over 2 ranks.
RING_CHUNK = TP_BATCH // TP_MICRO * TP_SEQ * HIDDEN // TP
# K4's shapes there: [M, K] @ [K, C] per hop, M = 8 x 512 rows, C = the
# 1024 features over 2 ranks; K = 512 (out projection), 2048 (mlp wo).
MATMUL_SHAPES = ((4096, 512, 512), (4096, 2048, 512))
# K3's chunk at the vocab-parallel prologue's lookup sum (pipe rank 0):
# the [16, 512, 1024] fp32 lookup of the whole batch over 2 ranks.
PROLOGUE_CHUNK = TP_BATCH * TP_SEQ * HIDDEN // TP
# Phase 6's programs.
TP_PROGRAMS = {
    "fp32": {},
    "int8": dict(collective_precision={"tp_psum": "int8"}),
    "quant_ring": dict(collective_precision={"tp_psum": "int8"},
                       kernel=("quant_ring",)),
    "matmul": dict(comm_overlap="matmul"),
    "collective_matmul": dict(comm_overlap="matmul",
                              kernel=("collective_matmul",)),
    "fp32 vocab": dict(vocab_parallel=True),
}
# Phase 7's: bench.py quant's programs, each with vocab_parallel and
# the bare "int8" string as bench.py:342 passes them (every slot
# narrowed: tp_psum, vocab_stats and the grad slot's int8_ef over the
# data axis of 1), and at pipe 2 x model 2 the fp32 program with the
# full-vocab head beside them.
VOCAB_PARALLEL = dict(vocab_parallel=True)
WINDOW_PROGRAMS = {
    "fp32": VOCAB_PARALLEL,
    "int8": dict(VOCAB_PARALLEL, collective_precision="int8"),
    "quant_ring": dict(VOCAB_PARALLEL, collective_precision="int8",
                       kernel=("quant_ring",)),
    "collective_matmul": dict(VOCAB_PARALLEL,
                              **TP_PROGRAMS["collective_matmul"]),
    "fp32 full head": {},
}
# The MoE window (bench.py moe on an accelerator) on an expert axis of 2.
EXPERT, MOE_LAYERS, MOE_SEQ, MOE_ROWS, MOE_STEPS = 2, 2, 512, 2, 10
MOE_EXPERTS, MOE_HIDDEN = 8, 4096
# K8's chunk there: each rank's [8, 512, 1024] dispatch and [4, 1024,
# 1024] combine payloads split in two, [4, 512, 1024]; 512 is the
# capacity ceil(2 x 1024 tokens x 2.0 / 8 experts).
MOE_CAPACITY = 2 * MOE_ROWS * MOE_SEQ * 2 // MOE_EXPERTS
A2A_CHUNK = MOE_EXPERTS // EXPERT * MOE_CAPACITY * HIDDEN
MOE_PROGRAMS = {
    "fp32": {},
    "int8": dict(collective_precision={"moe_a2a": "int8"}),
    "a2a_ring": dict(collective_precision={"moe_a2a": "int8"},
                     kernel=("a2a_ring",)),
}
# Per step of phase 9: a warm-up hop and one hop per peer for every
# dispatch and combine, forward and backward, in every layer.
MOE_WANT = {"a2a_ring": {"a2a_ring_hop": EXPERT * 2 * 2 * MOE_LAYERS}}
# The sequence-parallel window: bench.py:442-446's model (4 layers,
# max_len 2048) trained as examples/long_context.py trains it
# (adamw(3e-4), batch 8), the flash ring causal on a seq axis of 2: a
# ring chunk is [8, 1024, 16, 64].  The long-context rows: batch 1 of
# 8192 tokens, the positional table grown to 8192 rows.
SEQ, SEQ_LAYERS, SEQ_LEN, SEQ_BATCH, SEQ_STEPS = 2, 4, 2048, 8, 3
LONG_LEN, LONG_STEPS = 8192, 2
RING_CHUNK_SHAPE = (SEQ_BATCH, SEQ_LEN // SEQ, HEADS)
RINGS = {"flash": ra.make_ring_flash_attention_fn,
         "einsum": ra.make_ring_attention_fn}


def seq_want(index, layers, remat=False):
    """K1, K2a and K2b per step on seq rank ``index`` under the causal
    flash ring: one chunk call a ring step that is not skipped (the
    diagonal and the ``index`` chunks before it) a layer; remat runs
    each forward again in the backward."""
    calls = layers * (index + 1)
    return {"flash_attention_fwd": calls * (2 if remat else 1),
            "flash_attention_bwd_dq": calls,
            "flash_attention_bwd_dkv": calls}


def tp_want(program, layers, first):
    """Per step of phase 7 in a rank that holds ``layers`` layers: K3
    opens and hops once per ring at T = 2, four rings per layer and
    microbatch (two forward sums, two backward), and on pipe rank 0
    (``first``) one more ring for the vocab-parallel prologue's lookup
    sum (its backward is the identity); K4 runs T times per row-parallel
    boundary, two per layer and microbatch, forward only.  A bubble tick
    runs no stage, so the pipe schedule adds none."""
    return {"quant_ring": {"quant_ring_hop": 2 * 4 * layers * TP_MICRO
                           + (TP if first else 0)},
            "collective_matmul": {
                "collective_matmul_hop": TP * 2 * layers * TP_MICRO},
            }.get(program, {})


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def reset_launches():
    for k in KERNELS.values():
        k["wrapper"].launches = 0
    fp.flash_prefill_attention_paged.cuda_core_launches = 0


def launches():
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}


def cfg_of(dtype, layers=LAYERS):
    return port.TransformerConfig(
        vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=layers,
        num_heads=HEADS, mlp_dim=MLP, max_len=MAX_LEN, dtype=dtype,
        dropout_rate=0.0, attention_dropout_rate=0.0)


# --------------------------------------------------------------------- #
# phase 1: kernels against their plain versions
# --------------------------------------------------------------------- #
def edge_values(n, hi, rng):
    """0, 15, 16, 17, 1023 (block and tile edges), then random."""
    vals = [0, 15, 16, 17, MAX_LEN - 1]
    return np.array(vals + list(rng.randint(0, hi, n - len(vals))), np.int32)


def tail_filled_table(spans, rng):
    """Block table rows as ``reserve_slot`` lays them out: each slot's
    blocks drawn from one shuffled pool, the row tail-filled with its
    last block."""
    mb = MAX_LEN // BLOCK_LEN
    free = list(rng.permutation(NUM_BLOCKS))
    table = np.zeros((len(spans), mb), np.int32)
    for i, span in enumerate(spans):
        n = kv_cache.blocks_for(max(int(span), 1), BLOCK_LEN)
        blocks = [free.pop() for _ in range(n)]
        table[i, :] = blocks[-1]
        table[i, :n] = blocks
    return table


def decode_cases(dtype, randn, dense_lengths, paged_lengths, pools, rng,
                 heads=HEADS):
    """(name, args, kwargs, bytes, flops) of K5 over dense lanes and K6
    over ``pools`` (a table drawn from ``rng``) at the given lengths, of
    ``heads`` heads (a tensor-parallel rank's: 16 / T);
    the bytes count each visible key's K and V row, q, out, the lengths
    and the used table entries once."""
    dev = "cuda"
    esize = torch.empty((), dtype=dtype).element_size()
    cases = []
    for name, lengths in (("flash_decode", dense_lengths),
                          ("flash_decode_paged", paged_lengths)):
        B = len(lengths)
        n_vis = np.minimum(lengths.astype(np.int64) + 1, MAX_LEN)
        q = randn(B, 1, heads, HEAD_DIM)
        nbytes = (2 * n_vis.sum() * heads * HEAD_DIM * esize
                  + 2 * B * heads * HEAD_DIM * esize + B * 4)
        if name == "flash_decode":
            args = (q, randn(B, heads, MAX_LEN, HEAD_DIM),
                    randn(B, heads, MAX_LEN, HEAD_DIM),
                    torch.as_tensor(lengths, device=dev))
            kw = {}
        else:
            table = tail_filled_table(n_vis, rng)
            args = (q, *pools, torch.as_tensor(lengths, device=dev),
                    torch.as_tensor(table, device=dev))
            kw = {"block_len": BLOCK_LEN}
            nbytes += 4 * sum(kv_cache.blocks_for(n, BLOCK_LEN)
                              for n in n_vis)
        cases.append((name, args, kw, nbytes,
                      4 * HEAD_DIM * heads * n_vis.sum()))
    return cases


def serve_mix_lengths(rng):
    """K5's and K6's lengths at the serve mix's occupancy: phase 3's
    requests (1-64 prompt tokens, 128 new) reach lengths 1-192; the
    dense engine's 8 slots are all busy, the paged engine's 32 hold the
    16 requests and 16 idle slots at length 0."""
    return (rng.randint(1, 193, 8).astype(np.int32),
            np.concatenate([rng.randint(1, 193, 16),
                            np.zeros(16, np.int64)]).astype(np.int32))


def kernel_cases(dtype, gen, rng):
    """(name, args, kwargs, bytes, flops) at the serving shapes."""
    dev = "cuda"
    esize = torch.empty((), dtype=dtype).element_size()

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    mb = MAX_LEN // BLOCK_LEN
    # K5: 8 slots over dense lanes; K6: 32 slots over the 512-block pool.
    k_pool = randn(NUM_BLOCKS, HEADS, BLOCK_LEN, HEAD_DIM)
    v_pool = randn(NUM_BLOCKS, HEADS, BLOCK_LEN, HEAD_DIM)
    cases = decode_cases(dtype, randn, edge_values(8, MAX_LEN, rng),
                         edge_values(32, 200, rng), (k_pool, v_pool), rng)
    # K7: a 64-row chunk for each of 32 slots over the same pool.
    cases.append(prefill_case(dtype, randn, edge_values(32, 150, rng),
                              (k_pool, v_pool), rng))
    return cases


def prefill_case(dtype, randn, starts, pools, rng, heads=HEADS, C=CHUNK):
    """(name, args, kwargs, bytes, flops) of K7: a ``C``-row window a
    slot (a prefill chunk, or the speculative verify window) starting at
    ``starts`` over ``pools`` (a table drawn from ``rng``); the bytes
    count each visible key's K and V row, q, out, the starts and the
    used table entries once, the flops each row's visible keys."""
    dev = "cuda"
    esize = torch.empty((), dtype=dtype).element_size()
    B, extent = len(starts), MAX_LEN // BLOCK_LEN * BLOCK_LEN
    n_keys = np.minimum(starts.astype(np.int64) + C, extent)
    table = tail_filled_table(n_keys, rng)
    args = (randn(B, C, heads, HEAD_DIM), *pools,
            torch.as_tensor(starts, device=dev),
            torch.as_tensor(table, device=dev))
    rows = np.minimum(starts[:, None].astype(np.int64) + np.arange(C) + 1,
                      extent)
    kv_bytes = 2 * n_keys.sum() * heads * HEAD_DIM * esize
    tab_bytes = 4 * sum(kv_cache.blocks_for(n, BLOCK_LEN) for n in n_keys)
    return ("flash_prefill_paged", args, {"block_len": BLOCK_LEN},
            kv_bytes + 2 * B * C * heads * HEAD_DIM * esize + B * 4
            + tab_bytes, 4 * HEAD_DIM * heads * rows.sum())


def library_call(name, args, block_len=None):
    """One PyTorch call computing the same function (timed as a
    yardstick only; the port never calls it)."""
    import torch.nn.functional as F

    if name == "flash_decode":
        q, k, v, lengths = args
        rows = lengths[:, None]                        # one query row
    else:
        q, k_pool, v_pool, idx, table = args
        k = kv_cache.gather_blocks(k_pool, table)
        v = kv_cache.gather_blocks(v_pool, table)
        C = q.shape[1]
        rows = idx[:, None] + torch.arange(C, device=q.device)
    pos = torch.arange(k.shape[2], device=q.device)
    mask = (pos[None, None, :] <= rows[:, :, None])[:, None]  # [B,1,C,T]
    out = F.scaled_dot_product_attention(q.transpose(1, 2), k, v,
                                         attn_mask=mask)
    return out.transpose(1, 2)


def time_ms(fn, reps=30):
    """Mean device time of ``fn`` over ``reps`` calls, CUDA events
    around the call only.  The 50 MB L2 is flushed before each call by
    reading 64 MB (the serving loop reaches each layer's cache cold; a
    read leaves no dirty lines to write back inside the timed call).  A
    spin kernel holds the card while the host enqueues every call, so
    the events time the device and not the host's launch overhead."""
    flush = torch.ones(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(300_000_000)            # ~0.2 s at H100 clocks
    for e0, e1 in events:
        flush.sum()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in events) / reps


def tflop_rate(flops, ms):
    """Achieved TFLOP/s of ``flops`` in ``ms``."""
    return flops / ms / 1e9


def timings(rec, flops):
    """The kernel's, the plain version's and the library call's times,
    each with its achieved TFLOP/s, and the bound."""
    def at(ms):
        return f"{ms:.4f} ms ({tflop_rate(flops, ms):.1f} TFLOP/s)"

    lib = "none" if rec["library_ms"] is None else at(rec["library_ms"])
    return (f"kernel {at(rec['ms'])}, plain {at(rec['plain_ms'])}, library "
            f"{lib}, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")


def check_and_time(name, args, kw, nbytes, flops, dtype):
    """One K5-K7 case: the kernel against its plain version within the
    dtype's tolerance, then the kernel, the plain version and the
    library call timed; returns the record."""
    tol = TOLERANCE[dtype]
    wrapper = KERNELS[name]["wrapper"]
    plain = {"flash_decode": fd.flash_decode_attention_plain,
             "flash_decode_paged": fd.flash_decode_attention_paged_plain,
             "flash_prefill_paged":
                 fp.flash_prefill_attention_paged_plain}[name]
    got = wrapper(*args, dtype=dtype, **kw)
    ref = plain(*args, dtype=dtype, **kw)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    max_err = float(err.max())
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
    check(bool((err <= tol + tol * ref.float().abs()).all()),
          f"{name} {dtype}: max |kernel - plain| = {max_err} "
          f"exceeds atol = rtol = {tol}")
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return {
        "max_abs_err": max_err,
        "ms": time_ms(lambda: wrapper(*args, dtype=dtype, **kw)),
        "plain_ms": time_ms(lambda: plain(*args, dtype=dtype, **kw)),
        "library_ms": time_ms(lambda: library_call(name, args)),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def phase_kernels(record):
    """Kernel vs plain at both dtypes, into the per-kernel record; K5-K7
    also at the serve mix's occupancy (K7: 32 chunks at 0) and with one
    slot of ``MAX_LEN`` keys (K7: its last chunk) (``record[(name,
    dtype, "serve_mix" or "one_slot")]``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.RandomState(0)
    mix_gen = torch.Generator(device="cuda").manual_seed(2)
    mix_rng = np.random.RandomState(2)
    pre_gen = torch.Generator(device="cuda").manual_seed(3)
    pre_rng = np.random.RandomState(3)
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOLERANCE[dtype]
        for name, args, kw, nbytes, flops in kernel_cases(dtype, gen, rng):
            rec = check_and_time(name, args, kw, nbytes, flops, dtype)
            print(f"phase 1 {name} {str(dtype)[6:]}: max_abs_err "
                  f"{rec['max_abs_err']:.3e} (tol {tol}), "
                  f"{timings(rec, flops)}", flush=True)
            record[(name, dtype)] = rec

        def randn(*shape):
            return torch.randn(shape, generator=mix_gen,
                               device="cuda").to(dtype)

        def pre_randn(*shape):
            return torch.randn(shape, generator=pre_gen,
                               device="cuda").to(dtype)

        one_slot = np.array([MAX_LEN - 1], np.int32)
        # The serve mix's occupancy at 16 heads and, for phase 10's
        # tensor-parallel ranks, at 16 / T.
        for label, lengths, starts, heads in (
                ("serve_mix", serve_mix_lengths(mix_rng),
                 np.zeros(32, np.int32), HEADS),
                ("one_slot", (one_slot, one_slot),
                 np.array([MAX_LEN - CHUNK], np.int32), HEADS),
                ("tp2", serve_mix_lengths(mix_rng), np.zeros(32, np.int32),
                 HEADS // TP)):
            pools = (randn(NUM_BLOCKS, heads, BLOCK_LEN, HEAD_DIM),
                     randn(NUM_BLOCKS, heads, BLOCK_LEN, HEAD_DIM))
            cases = decode_cases(dtype, randn, *lengths, pools, mix_rng,
                                 heads)
            cases.append(prefill_case(dtype, pre_randn, starts, pools,
                                      pre_rng, heads))
            for name, args, kw, nbytes, flops in cases:
                rec = check_and_time(name, args, kw, nbytes, flops, dtype)
                what = "starts" if name == "flash_prefill_paged" \
                    else "lengths"
                print(f"phase 1 {name} {str(dtype)[6:]} {label} [B="
                      f"{args[0].shape[0]}, heads {heads}, {what} "
                      f"{args[3].min().item()}-"
                      f"{args[3].max().item()}]: max_abs_err "
                      f"{rec['max_abs_err']:.3e} (tol {tol}), "
                      f"{timings(rec, flops)}", flush=True)
                record[(name, dtype, label)] = rec
        # The speculative verify window (phase 18 (d): 8 slots, k = 4):
        # 5 rows a slot at ragged starts, neither chunk- nor
        # block-aligned, over blocks of 16 (bf16: the tensor-core
        # instance).
        starts = np.array([1, 15, 17, 63, 100, 150, 191, MAX_LEN - 3],
                          np.int32)
        pools = (pre_randn(NUM_BLOCKS, HEADS, BLOCK_LEN, HEAD_DIM),
                 pre_randn(NUM_BLOCKS, HEADS, BLOCK_LEN, HEAD_DIM))
        name, args, kw, nbytes, flops = prefill_case(
            dtype, pre_randn, starts, pools, pre_rng, C=SPEC_K + 1)
        rec = check_and_time(name, args, kw, nbytes, flops, dtype)
        print(f"phase 1 {name} {str(dtype)[6:]} verify [B=8, C="
              f"{SPEC_K + 1}, heads {HEADS}, blocks of {BLOCK_LEN}, starts "
              f"{starts.tolist()}]: max_abs_err {rec['max_abs_err']:.3e} "
              f"(tol {tol}), {timings(rec, flops)}", flush=True)
        record[(name, dtype, "verify")] = rec
        del pools, args


def attention_bytes_flops(name, B, L, H, D, esize, causal):
    """Bytes each input is read and each output written once, and the
    flops of the products (halved when causal), for K1, K2a and K2b."""
    qkv = 3 * B * L * H * D * esize
    rows = B * L * H * 4                       # one fp32 statistic per row
    tri = 0.5 if causal else 1.0
    if name == "flash_attention_fwd":           # q, k, v -> out, lse
        return qkv + B * L * H * D * esize + rows, 4 * B * H * L * L * D * tri
    grads = B * L * H * D * 4 * (1 if name == "flash_attention_bwd_dq" else 2)
    return (qkv + B * L * H * D * esize + 2 * rows + grads,
            (6 if name == "flash_attention_bwd_dq" else 8)
            * B * H * L * L * D * tri)


def attention_library(name, q, k, v, g, causal):
    """``scaled_dot_product_attention`` computing the same function:
    its forward for K1; for K2a and K2b, which no PyTorch call computes
    apart, its autograd backward (dq, dk and dv together, with its own
    delta pass; the forward is run once outside the timed call), the
    yardstick of the pair."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    if name == "flash_attention_fwd":
        return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=causal)
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    gt = g.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), gt,
                                       retain_graph=True)


def backward_pair(q, k, v, g, causal, dtype, library_ms):
    """The K2 pair: the port's whole backward as training runs it,
    ``torch.autograd.grad`` through ``flash_attention`` (delta, K2a, K2b
    and the casts of dq, dk, dv to the input dtype; the forward runs
    once outside the timed call), against SDPA's autograd backward, with
    the bound of K2a's and K2b's bytes and flops together; and the part
    outside the two kernels (delta and the casts), timed and counted
    alone."""
    B, L, H, D = q.shape
    x = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*x, causal=causal)
    whole = lambda: torch.autograd.grad(out, x, g,      # noqa: E731
                                        retain_graph=True)
    o = out.detach()
    grads = [torch.empty(q.shape, dtype=torch.float32, device=q.device)
             for _ in range(3)]

    def outside():
        return ((g.float() * o.float()).sum(-1),
                *(t.to(dtype) for t in grads))

    esize = torch.empty((), dtype=dtype).element_size()
    nbytes, flops = map(sum, zip(*(
        attention_bytes_flops(name, B, L, H, D, esize, causal)
        for name in PAIR)))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    rec = {"ms": time_ms(whole), "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "outside_ms": time_ms(outside)}
    for key, fn in (("launches", whole), ("outside_launches", outside)):
        prof = device_profile(fn)
        rec[key] = "not measured" if prof is None else round(prof[2])
    return rec, flops


def in_launches(n):
    """``in N launches``, or that the profiler saw none."""
    return (f"in {n} launches" if isinstance(n, int)
            else "(launches not measured: the profiler saw no device time)")


# The kernels whose registers, spills and static shared memory phase 1
# prints, by source: record name -> a fragment of the mangled entry name
# (bf16 instances, and K5's, K6's and K7's fp32 ones; K3's and K8's
# vector one-tile paths, the main path's).
PTXAS_KERNELS = {
    "flash_attention.cu": {
        "flash_attention_fwd": "16fwd_wgmma_kernelE",
        "flash_attention_bwd_dq": "15dq_wgmma_kernelE",
        "flash_attention_bwd_dkv": "16dkv_wgmma_kernelE"},
    "flash_decode.cu": {
        "flash_decode": "13decode_kernelI13__nv_bfloat16Li64ELb0E",
        "flash_decode_paged": "13decode_kernelI13__nv_bfloat16Li64ELb1E",
        "flash_decode fp32": "13decode_kernelIfLi64ELb0E",
        "flash_decode_paged fp32": "13decode_kernelIfLi64ELb1E"},
    "flash_prefill.cu": {
        "flash_prefill_paged": "20prefill_wgmma_kernelE",
        "flash_prefill_paged fp32": "14prefill_kernelIfLi64EE"},
    "quant_ring.cu": {"quant_ring_hop": "quant_ring_hop_kernelILb1ELb0E"},
    "a2a_ring.cu": {"a2a_ring_hop": "a2a_ring_hop_kernelILb1ELb0E"},
}


def ptxas_registers():
    """Registers, spill-store bytes and static shared-memory bytes a
    thread block of each kernel of ``PTXAS_KERNELS`` takes, from ``nvcc
    -Xptxas -v`` on its source with the build's flags (the sources
    compiled in parallel)."""
    found = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {src: subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             str(build.CSRC_DIR / src), "-o", os.path.join(tmp, src + ".o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in PTXAS_KERNELS}
        outs = {src: p.communicate()[0] for src, p in procs.items()}
    for src, kernels in PTXAS_KERNELS.items():
        check(procs[src].returncode == 0, f"nvcc -Xptxas -v {src}: "
              f"{outs[src][-2000:]}")
        name = None
        for line in outs[src].splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            spill = re.search(r"(\d+) bytes spill stores", line)
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            if entry:
                name = next((n for n, frag in kernels.items()
                             if frag in entry.group(1)), None)
            elif name and spill:
                found.setdefault(name, {})["spill_bytes"] = int(spill.group(1))
            elif name and regs:
                found[name]["registers"] = int(regs.group(1))
                found[name]["static_smem_bytes"] = (
                    int(smem.group(1)) if smem else 0)
        print(f"phase 1 ptxas {src}: " + "; ".join(
            f"{n} {found[n]['registers']} registers, "
            f"{found[n]['spill_bytes']} bytes spill stores, "
            f"{found[n]['static_smem_bytes']} bytes static shared memory"
            for n in kernels if n in found), flush=True)
    want = {n for kernels in PTXAS_KERNELS.values() for n in kernels}
    check(set(found) == want,
          f"ptxas reported {sorted(found)}, expected {sorted(want)}")
    return found


def attention_shape(gen, dtype, B, L, H, causal, timed, forward_only=False):
    """K1, K2a and K2b against their plain versions at ``[B, L, H, 64]``
    (q, k and v slices of one [B, L, 3, H, D] projection, as the model
    hands them over) within the dtype's tolerance; with ``timed`` each
    kernel, its plain version and the library call timed, and the K2
    pair.  ``forward_only``: K1 alone (the serving prefill's).  Prints
    a line a kernel; returns ``({name: rec}, pair rec)`` (empty and
    ``None`` untimed or forward only)."""
    D, tol = HEAD_DIM, TOLERANCE[dtype]
    esize = torch.empty((), dtype=dtype).element_size()
    qkv = torch.randn((B, L, 3, H, D), generator=gen,
                      device="cuda").to(dtype)
    q, k, v = qkv.unbind(2)
    g = torch.randn((B, L, H, D), generator=gen, device="cuda").to(dtype)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    delta = (g.float() * out.float()).sum(-1)
    kw = dict(causal=causal, scale=1.0 / math.sqrt(D))
    calls = {
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v, **kw),
            lambda: fa.flash_attention_fwd_plain(q, k, v, **kw)),
        "flash_attention_bwd_dq": (
            lambda: fa.flash_attention_bwd_dq(q, k, v, g, lse, delta, **kw),
            lambda: fa.flash_attention_bwd_dq_plain(
                q, k, v, g, lse, delta, **kw)),
        "flash_attention_bwd_dkv": (
            lambda: fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta, **kw),
            lambda: fa.flash_attention_bwd_dkv_plain(
                q, k, v, g, lse, delta, **kw)),
    }
    if forward_only:
        calls = {"flash_attention_fwd": calls["flash_attention_fwd"]}
    elif timed:
        pair_library = time_ms(attention_library(
            "flash_attention_bwd_dq", q, k, v, g, causal))
    recs, pair = {}, None
    for name, (kernel, plain) in calls.items():
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        max_err = 0.0
        for a, b in zip(got, ref):
            err = (a.float() - b.float()).abs()
            max_err = max(max_err, float(err.max()))
            check(bool(torch.isfinite(a).all()), f"{name}: non-finite")
            check(bool((err <= tol + tol * b.float().abs()).all()),
                  f"{name} {dtype} [{B},{L},{H},{D}] causal={causal}: max "
                  f"|kernel - plain| = {max_err} exceeds atol = rtol = "
                  f"{tol}")
        del got, ref
        line = (f"phase 1 {name} {str(dtype)[6:]} [{B},{L},{H},{D}] "
                f"causal={causal}: max_abs_err {max_err:.3e} (tol {tol})")
        if timed:
            nbytes, flops = attention_bytes_flops(name, B, L, H, D, esize,
                                                  causal)
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = flops / PEAK_FLOPS[dtype]
            recs[name] = {
                "max_abs_err": max_err,
                "ms": time_ms(kernel),
                "plain_ms": time_ms(plain),
                "library_ms": (pair_library if name in PAIR else time_ms(
                    attention_library(name, q, k, v, g, causal))),
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            }
            line += ", " + timings(recs[name], flops)
        print(line, flush=True)
    if timed and not forward_only:
        pair, flops = backward_pair(q, k, v, g, causal, dtype, pair_library)
        print(f"phase 1 K2 pair {str(dtype)[6:]} [{B},{L},{H},{D}] "
              f"causal={causal}: the port's backward {pair['ms']:.4f} ms "
              f"{in_launches(pair['launches'])} "
              f"({tflop_rate(flops, pair['ms']):.1f} TFLOP/s), of which "
              f"delta and casts {pair['outside_ms']:.4f} ms "
              f"{in_launches(pair['outside_launches'])}; SDPA backward "
              f"{pair['library_ms']:.4f} ms; bound {pair['bound_ms']:.4f} "
              f"ms ({pair['bound_by']})", flush=True)
    del qkv, q, k, v, g, out, lse, delta, calls
    torch.cuda.empty_cache()
    return recs, pair


def phase_attention_kernels(record):
    """K1, K2a and K2b against their plain versions at BERT-base shapes
    and at ragged lengths, causal and not, both dtypes, timed at
    BERT-base (the non-causal record is the training path's); and in
    bf16 at the ring chunk of phase 12, ``[8, 1024, 16, 64]``, full and
    causal (the ring's two kinds of step), timed (``record[(name, bf16,
    "ring_chunk" or "ring_chunk_causal")]``)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        for B, L in ((BERT_BATCH, BERT_SEQ), (4, 100), (4, 17)):
            for causal in (False, True):
                recs, pair = attention_shape(gen, dtype, B, L, 12, causal,
                                             timed=L == BERT_SEQ)
                if recs and not causal:
                    for name, rec in recs.items():
                        record[(name, dtype)] = rec
                    record[("K2 pair", dtype)] = pair
    for causal in (False, True):
        recs, pair = attention_shape(gen, torch.bfloat16, *RING_CHUNK_SHAPE,
                                     causal, timed=True)
        label = "ring_chunk_causal" if causal else "ring_chunk"
        for name, rec in recs.items():
            record[(name, torch.bfloat16, label)] = rec
        record[("K2 pair", torch.bfloat16, label)] = pair
    # K1 in the serving prefill: causal at the prompt buckets of 8
    # prompts (16: the engine's default; 64: bench.py serve and
    # --speculative; 512: --prompt-mix shared-prefix), held at both
    # dtypes, timed in bf16 at 64 and 512.
    for dtype in (torch.float32, torch.bfloat16):
        for L in PREFILL_BUCKETS:
            recs, _ = attention_shape(
                gen, dtype, 8, L, HEADS, True, forward_only=True,
                timed=dtype == torch.bfloat16 and L > 16)
            for name, rec in recs.items():
                record[(name, dtype, f"prefill_{L}")] = rec


def misaligned(q_in, x):
    """``q_in`` 4 bytes into a wire (a view ``wire[4:]``) and ``x`` at
    an odd element offset: neither on a 16-byte boundary."""
    wire = torch.empty(q_in.numel() + 4, dtype=torch.int8, device="cuda")
    wire[4:] = q_in
    odd = torch.empty(x.numel() + 1, device="cuda")
    odd[1:] = x
    return wire[4:], odd[1:]


def hop_cases(n, gen):
    """K3's and K8's cases at ``n`` elements, ``{name: (q_in, scale_in,
    x, vector)}``: ``x`` is K3's ``local`` or K8's ``nxt``, ``vector``
    whether every array is 16-byte aligned (the kernel's vector path)."""
    x = torch.randn(n, generator=gen, device="cuda") * 3
    q_in = torch.randint(-127, 128, (n,), generator=gen, device="cuda",
                         dtype=torch.int8)
    s_in = torch.full((1,), 0.0173, device="cuda")
    zero_q, zero_s = torch.zeros_like(q_in), torch.zeros(1, device="cuda")
    nan = x.clone()
    nan[n // 2] = float("nan")
    odd_q, odd_x = misaligned(q_in, x)
    # Halves up to max |x| = 127: scale 1, every quotient a tie.
    ties = torch.randint(-254, 255, (n,), generator=gen, device="cuda") / 2
    ties[0] = 127.0
    return {"open": (zero_q, zero_s, x, True),
            "ties": (zero_q, zero_s, ties, True),
            "hop": (q_in, s_in, x, True),
            "zero": (zero_q, zero_s, torch.zeros_like(x), True),
            "last": (q_in, s_in, torch.zeros_like(x), True),
            "nan": (q_in, s_in, nan, True),
            "misaligned": (odd_q, s_in, odd_x, False)}


def device_ops(fn, tries=8):
    """The names of the device operations (kernels, copies, memsets)
    one ``fn()`` ran, from ``torch.profiler``.  The profiler now and then
    records no device event at all in a session (runs of the whole
    script on an H100 saw it once among dozens of sessions, and once
    three sessions in a row, for a one-element hop whose launch was
    counted and whose bytes were checked): such an empty record is taken
    again, up to ``tries`` sessions a few milliseconds apart; the first
    record with any device event is returned as it is."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        if attempt:
            time.sleep(0.05)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
        if ops:
            break
    return ops


def check_hop(name, n, case, wrapper, plain, args, vector, out=None):
    """One K3 or K8 case: the kernel's outputs equal the plain
    version's byte for byte, the launch is counted (and in
    ``unaligned`` unless ``vector``), and the call is one device kernel,
    no memset or copy.  Returns the printed line."""
    before = (wrapper.launches, wrapper.unaligned)
    kw = {} if out is None else {"out": out}
    got, want = wrapper(*args, **kw), plain(*args)
    torch.cuda.synchronize()
    check((wrapper.launches, wrapper.unaligned)
          == (before[0] + 1, before[1] + (not vector)),
          f"{name} n={n} {case}: launches and unaligned went from {before} "
          f"to {(wrapper.launches, wrapper.unaligned)}")
    diff = [int((a.reshape(-1).view(torch.uint8)
                 != b.reshape(-1).view(torch.uint8)).sum())
            for a, b in zip(got, want)]
    check(diff == [0] * len(want), f"{name} n={n} {case}: bytes differ in "
          f"the outputs: {diff}; scale {float(got[-1])} vs "
          f"{float(want[-1])}")
    ops = device_ops(lambda: wrapper(*args, **kw))
    check(len(ops) == 1 and "ring_hop_kernel" in ops[0],
          f"{name} n={n} {case}: device operations {ops}, expected one "
          f"hop kernel")
    kernel = re.search(r"\w+_hop_kernel<[^>]*>", ops[0]).group(0)
    return (f"phase 1 {name} n={n} {case}: bit-exact, "
            f"{'vector' if vector else 'element-wise'} path, "
            f"{len(ops)} device operation a call ({kernel})")


def time_hop(n, wrapper, plain, args, nbytes):
    """K3's or K8's record at the main path's chunk: the kernel, the
    plain version and a plain copy of the same bytes (``nbytes`` / 2
    read and written: the event-timing floor beside the bound) timed by
    ``time_ms``.  A multiply, a divide, a round and a compare an
    element."""
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4 * n / PEAK_FLOPS[torch.float32]
    rec = {"max_abs_err": 0.0,
           "ms": time_ms(lambda: wrapper(*args)),
           "plain_ms": time_ms(lambda: plain(*args)),
           "library_ms": None,
           "copy_ms": time_ms(lambda: dst.copy_(src)),
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    return rec, (timings(rec, 4 * n) + f", copy of the same bytes "
                 f"{rec['copy_ms']:.4f} ms")


# Beyond what a grid holds in registers (2^21 elements on an H100): tiles.
HOP_LARGE = 2 ** 23 + 5


def phase_tp_kernels(record):
    """K3 bit for bit against its plain version (levels and scale), one
    device kernel a call, at the main path's chunk, at edge sizes and
    past what the grid holds in registers, aligned and not; K4 within
    tolerance; both timed at the shapes of phase 7."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    for C in (RING_CHUNK, PROLOGUE_CHUNK, 1, 1000, 2 ** 20 + 3, HOP_LARGE):
        for case, (*args, vector) in hop_cases(C, gen).items():
            line = check_hop("quant_ring_hop", C, case, qr.fused_hop,
                             qr.fused_hop_plain, args, vector)
            if C == RING_CHUNK and case == "hop":
                # Read q_in and local, write q_out: 6 bytes an element.
                rec, times = time_hop(C, qr.fused_hop, qr.fused_hop_plain,
                                      args, 6 * C + 8)
                record[("quant_ring_hop", torch.float32)] = rec
                line += ", " + times
            print(line, flush=True)
    # bf16 at the main path's shapes, at a ragged one, at one whose rows
    # are not 16-byte aligned (the wrapper stages it for TMA) and at an
    # odd C (the one-element epilogue; k's slice is staged).
    cases = [(torch.bfloat16, M, K, C) for M, K, C in MATMUL_SHAPES] + [
        (torch.bfloat16, 100, 72, 40), (torch.bfloat16, 100, 70, 38),
        (torch.bfloat16, 100, 72, 37), (torch.float32, 100, 72, 40)] + [
        (torch.float32, M, K, C) for M, K, C in MATMUL_SHAPES]
    for dtype, M, K, C in cases:
        tol = TOLERANCE[dtype]
        esize = torch.empty((), dtype=dtype).element_size()
        carry = torch.randn(M, C, generator=gen, device="cuda").to(dtype)
        x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
        # k: this rank's chunk of the row-parallel kernel, a column slice
        # of the [K, 2C] shard as the ring reads it.
        wide = (torch.randn(K, TP * C, generator=gen, device="cuda")
                / math.sqrt(K)).to(dtype)
        k = wide[:, C:]
        staged = cm.fused_matmul_add.staged
        got = cm.fused_matmul_add(carry, x, k)
        ref = cm.fused_matmul_add_plain(carry, x, k)
        torch.cuda.synchronize()
        staged = cm.fused_matmul_add.staged - staged
        check(staged == (dtype == torch.bfloat16
                         and (K % 8 != 0 or C % 8 != 0)),
              f"collective_matmul_hop {dtype} {M}x{K}x{C}: staged {staged}")
        err = (got.float() - ref.float()).abs()
        max_err = float(err.max())
        check(bool(torch.isfinite(got).all()), "collective_matmul: non-finite")
        check(bool((err <= tol + tol * ref.float().abs()).all()),
              f"collective_matmul_hop {dtype} {M}x{K}x{C}: max |kernel - "
              f"plain| = {max_err} exceeds atol = rtol = {tol}")
        line = (f"phase 1 collective_matmul_hop {str(dtype)[6:]} "
                f"[{M},{K}]@[{K},{C}]: max_abs_err {max_err:.3e} (tol {tol})")
        if M == 4096:
            t_bytes = (M * K + K * C + 2 * M * C) * esize / HBM_BYTES_PER_S
            t_ops = 2 * M * K * C / PEAK_FLOPS[dtype]
            rec = {"max_abs_err": max_err,
                   "ms": time_ms(lambda: cm.fused_matmul_add(carry, x, k)),
                   "plain_ms": time_ms(
                       lambda: cm.fused_matmul_add_plain(carry, x, k)),
                   "library_ms": time_ms(lambda: torch.addmm(carry, x, k)),
                   "bound_ms": max(t_bytes, t_ops) * 1e3,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            # mlp wo (K = 2048) is the kernel's record, the out
            # projection (K = 512) rides beside it.
            record[("collective_matmul_hop", dtype) if K == 2048 else
                   ("collective_matmul_hop", dtype, K)] = rec
            line += ", " + timings(rec, 2 * M * K * C) + " (library: addmm)"
        else:
            line += f", staged {staged}"
        print(line, flush=True)
    del carry, x, wide, k, got, ref
    torch.cuda.empty_cache()


def phase_a2a_kernels(record):
    """K8 bit for bit against its plain version (arrived, levels and
    scale), one device kernel a call, at the MoE window's chunks, at
    edge sizes and past what the grid holds in registers, aligned and
    not, and writing arrived into a row of the ring's output; timed at
    the MoE window's chunk."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    for L in (A2A_CHUNK, A2A_CHUNK // 2, 1, 1000, 2 ** 20 + 3, HOP_LARGE):
        cases = hop_cases(L, gen)
        rows = torch.empty(2, L, device="cuda")
        for case, (*args, vector) in list(cases.items()) + [
                ("out", (*cases["hop"][:3], L % 4 == 0))]:
            line = check_hop("a2a_ring_hop", L, case, ar.fused_hop,
                             ar.fused_hop_plain, args, vector,
                             out=rows[1] if case == "out" else None)
            if L == A2A_CHUNK and case == "hop":
                # Read q_in and nxt, write arrived and q_out: 10 bytes an
                # element.
                rec, times = time_hop(L, ar.fused_hop, ar.fused_hop_plain,
                                      args, 10 * L + 8)
                record[("a2a_ring_hop", torch.float32)] = rec
                line += ", " + times
            print(line, flush=True)
    del cases, rows
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# phase 2: fp32 parity against the greedy full recompute
# --------------------------------------------------------------------- #
def ladder_calls(engine):
    """Wrap the engine (and its draft) so the phase counts what it ran:
    target prefill calls and chunks, windows (decode, or verify on a
    speculative engine), the draft's prefill chunks, proposal windows
    and catch-ups."""
    calls = dict.fromkeys(("prefills", "chunks", "windows", "draft_prefills",
                           "draft_chunks", "proposals", "catchups"), 0)

    def wrap(owner, attr, key, chunk_key=None):
        fn = getattr(owner, attr)

        def counted(*a, **kw):
            out = fn(*a, **kw)
            calls[key] += 1
            if chunk_key:
                calls[chunk_key] += owner.last_prefill_chunks
            return out
        setattr(owner, attr, counted)

    wrap(engine, "prefill", "prefills", "chunks")
    wrap(engine, "decode_window", "windows")
    if engine.draft is not None:
        wrap(engine.draft, "prefill", "draft_prefills", "draft_chunks")
        wrap(engine.draft, "decode", "proposals")
        wrap(engine.draft, "decode_one", "catchups")
    return calls


ENGINES = {
    "dense": dict(num_slots=8, decode_steps=16, prefill_len=64),
    "paged": dict(num_slots=32, decode_steps=16, prefill_len=64,
                  kv_layout="paged", kv_block_len=BLOCK_LEN,
                  kv_num_blocks=NUM_BLOCKS, prefill_chunk=CHUNK),
}


def recompute_check(cfg, params, prompt, gen, seed, sampling, label):
    """The stream against a full recompute: ``sequential_logits`` and,
    sampled, the port's epilogue at the same ``(seed, position)``
    (:func:`~autodist_tpu_torch.parallel.tensor.sampled_scores`).  A
    divergence counts only at a near tie (the top two scores within
    1e-4) and ends the comparison.  Returns the index the comparison
    stopped at (the stream's length where it equals the recompute)."""
    seq = torch.as_tensor([prompt + gen[:-1]], device="cuda")
    scores = sequential_logits(cfg, params, seq)[0, len(prompt) - 1:]
    if sampling:
        n = len(gen)
        pos = torch.arange(len(prompt), len(prompt) + n, device="cuda",
                           dtype=torch.int32)
        scores = sampled_scores(
            scores, 0, seeds=torch.full((n,), seed, dtype=torch.int32,
                                        device="cuda"),
            positions=pos, vocab_size=cfg.vocab_size, **sampling)
    want = scores.argmax(-1).tolist()
    for i, tok in enumerate(gen):
        if tok != want[i]:
            top2 = scores[i].topk(2).values
            gap = float(top2[0] - top2[1])
            check(gap < 1e-4, f"{label}: token {i} is {tok}, the recompute "
                  f"gives {want[i]} (top-2 gap {gap})")
            return i
    return len(gen)


def phase_parity():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg_of(torch.float32)
    params = port.init_pipeline_lm_params(
        cfg, torch.Generator(device="cuda").manual_seed(1), device="cuda")
    rng = np.random.RandomState(1)
    ties = 0
    for layout, max_prompt in (("dense", 64), ("paged", 200)):
        engine = port.serve(cfg, params=params, device="cuda",
                            **ENGINES[layout])
        batcher = port.ContinuousBatcher(engine)
        prompts = [rng.randint(0, VOCAB, int(n)).tolist()
                   for n in [1, max_prompt] + list(
                       rng.randint(1, max_prompt + 1, 2))]
        rids = [batcher.submit(p, max_new_tokens=40) for p in prompts]
        done = batcher.run()
        compared = 0
        for p, rid in zip(prompts, rids):
            gen = done[rid].tokens
            stop = recompute_check(cfg, params, p, gen, 0, {},
                                   f"{layout} {rid}")
            compared += stop
            ties += stop < len(gen)
        check(engine.block_accounting()[1] == 0, "blocks leaked")
        print(f"phase 2 {layout}: {compared} tokens equal to the greedy "
              f"recompute over {len(prompts)} requests", flush=True)
    print(f"phase 2 ties: {ties}", flush=True)
    del params
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# phase 3: bf16 serving of the bench mix
# --------------------------------------------------------------------- #
PROFILED = "chip_smoke.profiled_window"


def profile_summary(intervals, span, k=1, watch=None):
    """Per-step summary of a profiled window of ``k`` steps.

    ``intervals``: ``(name, start_us, end_us)`` of every device launch
    (kernels, copies, memsets); ``span``: the window's ``(start_us,
    end_us)``.  Each interval is clipped to the window, and one that lies
    wholly outside it is left out.  Returns, every field divided by
    ``k``: the window's wall ms, its device-busy ms (the union of the
    intervals, so launches that overlap on several streams count once),
    the launches, the device-to-host copies, and the six names with the
    most device time as ``"name xN t ms"``, followed by every other name
    that contains ``watch``; ``None`` when no device time lies in the
    window."""
    start, end = span
    clipped = [(name, max(lo, start), min(hi, end))
               for name, lo, hi in intervals if lo <= end and hi >= start]
    busy_us, covered = 0.0, start
    for _, lo, hi in sorted(clipped, key=lambda c: c[1:]):
        lo = max(lo, covered)
        if hi > lo:
            busy_us += hi - lo
            covered = hi
    if not busy_us:
        return None
    by_name = {}
    for name, lo, hi in clipped:
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + hi - lo)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    top = ranked[:6] + [kv for kv in ranked[6:] if watch and watch in kv[0]]
    d2h = sum(n for name, (n, _) in by_name.items()
              if name.startswith("Memcpy DtoH"))
    return ((end - start) / 1e3 / k, busy_us / 1e3 / k, len(clipped) / k,
            d2h / k, "; ".join(f"{name[:60]} x{n / k:g} {us / 1e3 / k:.3f} ms"
                               for name, (n, us) in top))


def device_profile(run, k=1, watch=None):
    """Run ``run()`` (``k`` steps) once under ``torch.profiler`` and
    return ``profile_summary`` of its device launches, per step.
    Annotation ranges (``nccl:*``, which repeat their kernels' time) are
    left out, so busy time never exceeds the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(PROFILED):
            run()
            torch.cuda.synchronize()
    events = prof.events()
    span = next(e.time_range for e in events
                if e.name == PROFILED and e.device_type == DeviceType.CPU)
    return profile_summary(
        [(e.name, e.time_range.start, e.time_range.end) for e in events
         if e.device_type == DeviceType.CUDA and not e.is_user_annotation],
        (span.start, span.end), k, watch)


def profile_window(engine, n_active, label):
    """Where one decode window's time goes: its host wall time (timed
    without the profiler), then ``device_profile`` of a second window.
    Prints "not measured" where the profiler records no device time.
    Returns the flash decode kernel's entries of the window's top."""
    active = np.zeros(engine.num_slots, bool)
    active[:n_active] = True
    engine.decode_window(active)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.decode_window(active)
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = device_profile(lambda: engine.decode_window(active),
                          watch="decode_kernel")
    if prof is None:
        print(f"phase 3 {label} window profile: device time not measured")
        return "not measured"
    prof_ms, busy_ms, n_launch, d2h, top = prof
    print(f"phase 3 {label} window profile: wall {wall_ms:.2f} ms; profiled "
          f"window {prof_ms:.2f} ms, device busy {busy_ms:.2f} ms "
          f"({busy_ms / prof_ms:.1%}), {n_launch:.0f} kernel launches, "
          f"{d2h:.0f} device-to-host copies; top: {top}", flush=True)
    decode = "; ".join(t for t in top.split("; ") if "decode_kernel" in t)
    print(f"phase 3 {label} window profile: flash decode kernel "
          f"{decode or 'not launched'} a window", flush=True)
    return decode or "not launched"


def profile_prefill(engine, rng, n, watch=None):
    """Where one prefill's time goes: ``n`` prompts of 1-64 tokens (one
    bucket, or one chunk) admitted at once, prefilled once (on the graph
    route, the capture) and then under ``device_profile``.  Returns its
    summary, ``None`` where the profiler saw no device time."""
    B = engine.num_slots
    prompts = np.zeros((B, engine.max_prompt_tokens), np.int64)
    p_lens = np.ones(B, np.int32)
    admit = np.zeros(B, bool)
    for i in range(n):
        p_lens[i] = rng.randint(1, CHUNK + 1)
        prompts[i, :p_lens[i]] = rng.randint(0, VOCAB, p_lens[i])
        engine.reserve_slot(i, int(p_lens[i]), 128)
        admit[i] = True
    engine.prefill(prompts, p_lens, admit)
    prof = device_profile(lambda: engine.prefill(prompts, p_lens, admit),
                          watch=watch)
    check(engine.last_prefill_chunks == 1, "the profiled prefill took "
          f"{engine.last_prefill_chunks} chunks")
    engine.release_all_slots()
    return prof


def profile_chunk(engine, rng, decode):
    """A paged prefill chunk of 16 prompts (:func:`profile_prefill`); K7's
    device time a chunk printed beside the flash decode kernel's a
    window (``decode``)."""
    prof = profile_prefill(engine, rng, 16, watch="prefill")
    if prof is None:
        print("phase 3 chunk profile: device time not measured")
        return
    prof_ms, busy_ms, n_launch, _, top = prof
    k7 = "; ".join(t for t in top.split("; ") if "prefill" in t)
    print(f"phase 3 chunk profile: profiled chunk {prof_ms:.2f} ms, device "
          f"busy {busy_ms:.2f} ms ({busy_ms / prof_ms:.1%}), "
          f"{n_launch:.0f} kernel launches; K7 {k7 or 'not launched'} a "
          f"chunk, beside the flash decode kernel {decode} a window",
          flush=True)


def serve_mix(engine, rng):
    """Two warm-up requests in turn, then the serve mix (16 requests of
    1-64 prompt tokens and 128 new ones) timed through
    ``ContinuousBatcher``, with the launch counters set to 0 just before
    it.  The first warm-up's window captures the decode graph, and the
    capture empties the allocator's cache; the second warms the prefill
    after it.  Returns (seconds, completions, the engine's calls, the
    launches, the graph replays)."""
    batcher = port.ContinuousBatcher(engine)
    for warm in (rng, np.random.RandomState(1)):        # warm-up
        batcher.submit(warm.randint(0, VOCAB, 4).tolist(), max_new_tokens=16)
        batcher.run()
    calls = ladder_calls(engine)
    replays = engine.replays
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [batcher.submit(
        rng.randint(0, VOCAB, int(rng.randint(1, 65))).tolist(),
        max_new_tokens=128) for _ in range(16)]
    done = batcher.run()
    wall = time.perf_counter() - t0
    return (wall, [done[r] for r in rids], calls, launches(),
            engine.replays - replays)


def phase_serve():
    """The bench mix on the dense and the paged engine, each with its
    decode windows replaying one CUDA graph (the main path) and again
    with the window body launched from the host; the two routes' streams
    must be equal token for token."""
    cfg = cfg_of(torch.bfloat16)
    params = port.init_pipeline_lm_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    counts = {}
    for layout in ("dense", "paged"):
        streams = {}
        for route in ("graph", "body"):
            label = f"{layout} {route}"
            engine = port.serve(cfg, params=params, device="cuda",
                                decode_graph=route == "graph",
                                **ENGINES[layout])
            wall, comps, calls, got, replays = serve_mix(
                engine, np.random.RandomState(0))
            check(all(c.finish_reason in FINISH_REASONS for c in comps),
                  "invalid finish reason")
            check(all(0 <= t < VOCAB for c in comps for t in c.tokens),
                  "token outside the vocabulary")
            free, used, total = engine.block_accounting()
            check(used == 0 and free == total, f"blocks leaked: {free, used}")
            if route == "graph":
                check(engine.captures == 1 and replays == calls["windows"]
                      and replays > 0,
                      f"{label}: {engine.captures} captures and {replays} "
                      f"replays for {calls['windows']} windows (one capture "
                      f"in the warm-up, then a replay a window)")
            else:
                check(engine.captures == engine.replays == 0,
                      f"{label}: the uncaptured route captured")
            per_window = LAYERS * engine.decode_steps
            want = dict.fromkeys(KERNELS, 0)
            if layout == "dense":
                want["flash_decode"] = per_window * calls["windows"]
            else:
                want["flash_decode_paged"] = per_window * calls["windows"]
                want["flash_prefill_paged"] = LAYERS * calls["chunks"]
            check(got == want, f"{label}: launches {got}, attention calls "
                  f"{want}")
            cuda_core = fp.flash_prefill_attention_paged.cuda_core_launches
            check(cuda_core == 0, f"{label}: K7's CUDA-core instance ran "
                  f"{cuda_core} times on the bf16 serve path")
            check(all(n > 0 for n in want.values() if n != 0)
                  and sum(n > 0 for n in got.values()) == (
                      1 if layout == "dense" else 2),
                  f"{label}: a kernel of the path was never launched: {got}")
            tokens = sum(len(c.tokens) for c in comps)
            itl = [ms for c in comps for ms in c.inter_token_ms]
            ttft = sorted(c.ttft_s * 1e3 for c in comps)
            print(f"phase 3 {label} bf16: {tokens} tokens in {wall:.3f} s = "
                  f"{tokens / wall:.1f} tokens/s, TTFT p50 "
                  f"{ttft[len(ttft) // 2]:.2f} ms, inter-token p50 "
                  f"{np.percentile(itl, 50):.3f} ms p99 "
                  f"{np.percentile(itl, 99):.3f} ms, windows "
                  f"{calls['windows']}, chunks {calls['chunks']}, graph "
                  f"replays {replays}, captures {engine.captures} "
                  f"({engine.capture_seconds:.2f} s), launches {got}",
                  flush=True)
            streams[route] = [c.tokens for c in comps]
            if route == "graph":
                counts.update({k: v for k, v in got.items() if v})
            decode = profile_window(engine, min(16, engine.num_slots), label)
            if layout == "paged" and route == "graph":
                counts["flash_prefill_paged cuda_core"] = cuda_core
                profile_chunk(engine, np.random.RandomState(1), decode)
            engine.close()
            del engine
            torch.cuda.empty_cache()
        check(streams["graph"] == streams["body"],
              f"{layout}: the replayed windows' streams differ from the "
              f"uncaptured body's")
        print(f"phase 3 {layout}: the graph route's {len(streams['graph'])} "
              f"streams equal the uncaptured body's token for token",
              flush=True)
    return counts


# --------------------------------------------------------------------- #
# phases 4 and 5: BERT masked-LM training through AutoDist + AllReduce
# --------------------------------------------------------------------- #
def bert_window(cfg, steps, seed0=0):
    """``steps`` distinct synthetic MLM batches without ``input_mask``
    (unpadded, as the bench feeds them), stacked ``[steps, ...]``."""
    batches = []
    for i in range(steps):
        b = bert.synthetic_mlm_batch(seed0 + i, BERT_BATCH, BERT_SEQ,
                                     BERT_MASKED, cfg.vocab_size)
        b.pop("input_mask")
        batches.append(b)
    return port.stack_steps(batches)


def bert_runner(cfg, optimizer):
    trainable = bert.make_mlm_trainable(
        cfg, optimizer, torch.Generator(device="cuda").manual_seed(0),
        with_input_mask=False)
    return port.AutoDist({}, port.AllReduce(chunk_size=256)).build(trainable)


def phase_training_parity():
    """fp32: flash and einsum attention train a 2-layer full-width BERT
    alike over 3 AdamW steps (same generator seed, so the same weights;
    same batches)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    losses = {}
    for name, fn in (("flash", fa.make_attention_fn(False)),
                     ("einsum", None)):
        cfg = port.TransformerConfig(
            num_layers=2, dtype=torch.float32, dropout_rate=0.0,
            attention_dropout_rate=0.0, attention_fn=fn)
        runner = bert_runner(cfg, port.optim.adamw(1e-4, weight_decay=0.01))
        losses[name] = runner.run_steps(bert_window(cfg, 3, seed0=100))[
            "loss"].tolist()
        runner.close()
        torch.cuda.empty_cache()
    for i, (a, b) in enumerate(zip(losses["flash"], losses["einsum"])):
        check(math.isfinite(a) and abs(a - b) <= 1e-4 * abs(b),
              f"step {i}: flash loss {a} vs einsum loss {b} differ by more "
              f"than 1e-4 relative")
    print(f"phase 4 fp32 2-layer BERT, 3 AdamW steps: flash losses "
          f"{losses['flash']}, einsum losses {losses['einsum']}", flush=True)


def window_steps(window, k=None):
    """The first ``k`` steps (all by default) of a placed window, one
    batch each; each keeps the placed type, so the runner does not split
    it again."""
    k = len(next(iter(window.values()))) if k is None else k
    return [type(window)({key: t[i] for key, t in window.items()})
            for i in range(k)]


def profile_steps(runner, window, k=3, watch=None, loop=False):
    """``device_profile`` of ``k`` warm steps, per step, every kernel
    whose name holds ``watch`` listed: one ``run_steps`` window, or with
    ``loop`` ``k`` ``step`` calls.  ``window`` is placed
    (``runner.place_steps``)."""
    if loop:
        steps = window_steps(window, k)
        run = lambda: [runner.step(b) for b in steps]      # noqa: E731
    else:
        part = type(window)({key: t[:k] for key, t in window.items()})
        run = lambda: runner.run_steps(part)               # noqa: E731
    run()
    torch.cuda.synchronize()
    return device_profile(run, k, watch)


def timed_window(runner, window, loop=False):
    """A warm window, then a timed one (host clock around a window that
    ends in a host read of the last loss): one ``run_steps`` call, or
    with ``loop`` a ``step`` call a step.  The warm window is the whole
    window where ``run_steps`` captures a graph, one step on a host
    loop (a loop has nothing to capture; its one-time costs fall in its
    first step).  The launch counters are set to 0 just before the timed
    window, the peak memory before the warm one (so a graph's capture
    counts).  Returns (seconds, metrics)."""
    fence = lambda m: float(m["loss"].reshape(-1)[-1])  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    if loop:
        steps = window_steps(window)
        fence(runner.step(steps[0]))

        def run():
            out = [runner.step(b) for b in steps]
            return {key: torch.stack([m[key] for m in out])
                    for key in out[0]}
    else:
        run = lambda: runner.run_steps(window)          # noqa: E731
        fence(run() if runner.lowered.capturable else runner.run_steps(
            type(window)({k: v[:1] for k, v in window.items()})))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    metrics = run()
    fence(metrics)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, metrics


def train_route(cfg, opt, label, route):
    """One BERT-base training window on one route: ``"graph"`` (each
    ``run_steps`` call one CUDA-graph replay: the main path) or
    ``"loop"`` (a ``step`` call a step).  Checks the losses, the route's
    captures and replays and the attention kernels' launches; prints
    examples/s, step ms, MFU, peak memory, capture seconds and the
    profiler's busy share.  Returns the launches."""
    flops = bert.mlm_model_flops_per_example(cfg, BERT_SEQ, BERT_MASKED)
    chip = port.ResourceSpec({}).chip
    runner = bert_runner(cfg, opt)
    check(runner.lowered.capturable, f"{label}: one card's lowering is "
          f"not capturable")
    window = runner.place_steps(bert_window(cfg, BERT_STEPS))
    dt, metrics = timed_window(runner, window, loop=route == "loop")
    got = launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = metrics["loss"].float()
    check(bool(torch.isfinite(losses).all()),
          f"{label} {route}: non-finite loss: {losses}")
    want = dict.fromkeys(KERNELS, 0)
    if cfg.attention_fn is not None:
        want.update(dict.fromkeys(TRAINING_KERNELS,
                                  cfg.num_layers * BERT_STEPS))
    check(got == want, f"{label} {route}: training launches {got}, "
          f"expected {want}")
    graphs = (1, 2) if route == "graph" else (0, 0)
    check((runner.captures, runner.replays) == graphs,
          f"{label} {route}: {runner.captures} captures and "
          f"{runner.replays} replays, expected {graphs}")
    rate = BERT_STEPS * BERT_BATCH / dt
    WINDOW_TIMES[("bert", label, route)] = (dt / BERT_STEPS * 1e3, rate)
    print(f"phase 5 {label} bf16 {route}: {BERT_STEPS} steps in {dt:.3f} s "
          f"= {rate:.2f} examples/s, step {dt / BERT_STEPS * 1e3:.2f} ms, "
          f"MFU {rate * flops / (chip.peak_bf16_tflops * 1e12):.4f}, peak "
          f"memory {peak_gb:.2f} GB of {chip.hbm_gb:g}, graph captures "
          f"{runner.captures} ({runner.capture_seconds:.2f} s), replays "
          f"{runner.replays}, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"launches {got}", flush=True)
    prof = profile_steps(runner, window, loop=route == "loop")
    if prof is None:
        print(f"phase 5 {label} {route} step profile: device time not "
              f"measured", flush=True)
    else:
        prof_ms, busy, n_launch, _, top = prof
        print(f"phase 5 {label} {route} step profile: device busy "
              f"{busy:.2f} ms of the profiled step's {prof_ms:.2f} ms "
              f"({busy / prof_ms:.1%}), {n_launch:.0f} kernel launches per "
              f"step; top per step: {top}", flush=True)
    runner.close()
    del runner, window
    torch.cuda.empty_cache()
    return got


def phase_train():
    """bf16 BERT-base: the bench's training window through the flash
    kernels, then through the einsum attention, each replayed as one
    CUDA graph a window and as a loop of ``step`` calls."""
    opt = port.optim.adamw(1e-4, weight_decay=0.01, mu_dtype=torch.bfloat16)
    counts = {}
    for label, fn in (("flash", fa.make_attention_fn(False)),
                      ("einsum", None)):
        cfg = bert.bert_base(dropout_rate=0.0, attention_dropout_rate=0.0,
                             attention_fn=fn)
        for route in ("graph", "loop"):
            got = train_route(cfg, opt, label, route)
            if label == "flash" and route == "graph":
                counts = {name: got[name] for name in TRAINING_KERNELS}
    return counts


# --------------------------------------------------------------------- #
# phases 6 and 7: tensor- and pipeline-parallel training of the pipelined LM
# --------------------------------------------------------------------- #
def tp_runner(job, program, mesh):
    """AutoDist + Pipeline on the pipelined LM at full width, depth
    ``job["layers"]``, over ``mesh`` (``virtual_stages`` the layers a
    pipe rank holds, ``tensor_parallel`` the model axis) with a program
    of phase 6 (``TP_PROGRAMS``), of phase 7's window
    (``WINDOW_PROGRAMS``) or of phase 21's window
    (``OVERLAP_PROGRAMS``); weights from seed 0 on the card (every rank
    draws the same tree and keeps its chunks' shard)."""
    programs = {"window": WINDOW_PROGRAMS,
                "overlap_window": OVERLAP_PROGRAMS}.get(job["kind"],
                                                        TP_PROGRAMS)
    cfg = port.TransformerConfig(
        vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=job["layers"],
        num_heads=HEADS, mlp_dim=MLP, max_len=job["seq"], dtype=job["dtype"],
        dropout_rate=0.0, attention_dropout_rate=0.0)
    trainable = make_pipeline_lm_trainable(
        cfg, port.optim.adam(1e-3), torch.Generator(device="cuda").manual_seed(0))
    builder = Pipeline(num_microbatches=TP_MICRO,
                       virtual_stages=job["layers"] // mesh.get("pipe", 1),
                       tensor_parallel=mesh.get("model", 1),
                       **programs[program])
    return port.AutoDist({"mesh": mesh}, builder).build(trainable)


def mesh_label(mesh):
    return " x ".join(f"{ax} {n}" for ax, n in mesh.items() if n > 1)


def tp_window(job, steps, seed0=0):
    """``steps`` next-token batches ``{"x", "y"}`` from a numpy seed,
    stacked ``[steps, B, L]``."""
    batches = []
    for i in range(steps):
        r = np.random.RandomState(seed0 + i)
        batches.append({k: r.randint(0, VOCAB, (job["batch"], job["seq"]))
                        .astype(np.int32) for k in ("x", "y")})
    return port.stack_steps(batches)


def tp_parity(job):
    """Phase 6 in one rank: 3 steps of each program; the losses."""
    out = {}
    for program in job["programs"]:
        runner = tp_runner(job, program, job["mesh"])
        out[program] = runner.run_steps(tp_window(job, 3, seed0=100))[
            "loss"].tolist()
        runner.close()
        torch.cuda.empty_cache()
    return out


def check_route(runner, job, program):
    """Over gloo the step stages every exchange through host memory, so
    ``run_steps`` keeps the host loop (no capture); over NCCL it replays
    one CUDA graph."""
    staged = job["backend"] == "gloo"
    check(runner.lowered.host_staged == staged
          and runner.lowered.capturable == (not staged),
          f"{program} over {job['backend']}: host_staged "
          f"{runner.lowered.host_staged}, capturable "
          f"{runner.lowered.capturable}")
    if staged:
        check(runner.captures == runner.replays == 0,
              f"{program}: the gloo loop captured {runner.captures} graphs")
    return "loop" if staged else f"graph ({runner.captures} captures)"


def tp_window_programs(job):
    """Phase 7 in one rank: per program a warm window, a timed one with
    the launch counters, then a profiled one."""
    out = {}
    layers = job["layers"] // job["mesh"].get("pipe", 1)
    for program in job["programs"]:
        torch.cuda.reset_peak_memory_stats()
        runner = tp_runner(job, program, job["mesh"])
        pipe = runner.lowered.mesh.axis("pipe").index
        window = runner.place_steps(tp_window(job, TP_STEPS))
        cm.fused_matmul_add.staged = qr.fused_hop.unaligned = 0
        dt, metrics = timed_window(runner, window)
        route = check_route(runner, job, program)
        got = {name: launches()[name] for name in TP_KERNELS}
        check(cm.fused_matmul_add.staged == 0,
              f"{program}: K4 staged {cm.fused_matmul_add.staged} operands "
              f"(the main path's are TMA-ready)")
        check(qr.fused_hop.unaligned == 0,
              f"{program}: {qr.fused_hop.unaligned} K3 hops took the "
              f"element-wise path (the main path's arrays are aligned)")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = metrics["loss"].float()
        check(bool(torch.isfinite(losses).all()),
              f"{program}: non-finite loss {losses}")
        want = dict.fromkeys(TP_KERNELS, 0)
        want.update({k: n * TP_STEPS
                     for k, n in tp_want(program, layers, pipe == 0).items()})
        check(got == want, f"{program} on {job['mesh']}: launches {got}, "
                           f"expected {want}")
        prof = profile_steps(runner, window, k=1, watch="ring_hop_kernel")
        out[program] = {"seconds": dt, "launches": got, "peak_gb": peak_gb,
                        "pipe": pipe,
                        "loss": [float(losses[0]), float(losses[-1])],
                        "profile": prof, "route": route}
        runner.close()
        del runner, window
        torch.cuda.empty_cache()
    return out


def rank_worker(rank, world, backend, store, job, out_dir):
    """One rank of a spawned phase; writes its result as JSON.  It joins
    and leaves the job through ``autodist_tpu_torch.testing``; a failure
    raises here and ``mp.spawn`` stops the other ranks."""
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    testing.init_rank(rank, world, store, backend)
    job = dict(job, backend=backend)
    run = {"parity": tp_parity, "window": tp_window_programs,
           "moe_parity": moe_parity, "moe_window": moe_window_programs,
           "serve": tp_serve, "seq_parity": seq_parity,
           "seq_window": seq_window_rows, "zoo_parity": zoo_parity,
           "zoo_window": zoo_window_rows,
           "zero_pipe_parity": zero_pipe_parity,
           "zero_seq_parity": zero_seq_parity,
           "zero_moe_parity": zero_moe_parity,
           "zero_window": zero_window_rows,
           "overlap_window": overlap_window_programs,
           "dropout": pipeline_dropout, "serve_rsag": tp_serve_rsag,
           "gspmd": gspmd_ranks, "async_worker": async_worker,
           "multislice": multislice_rank}
    result = run[job["kind"]](job)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    testing.end_rank()


def spawn_ranks(job, world, backend="gloo"):
    """Run ``job`` in ``world`` spawned ranks; every rank's result.  A
    failure in any rank stops the others and raises here."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(rank_worker, args=(world, backend,
                                    os.path.join(tmp, "store"), job, tmp),
                 nprocs=world, join=True)
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                results.append(json.load(f))
    return results


def spawn_together(jobs, meanwhile=None):
    """Run several ``(job, world)`` jobs at once over gloo, each in its
    own spawned ranks and process group; every job's ranks' results, in
    order.  ``meanwhile()`` runs in this process once every rank is
    started.  A failure in any rank stops every rank of every job and
    raises here."""
    with tempfile.TemporaryDirectory() as tmp:
        started = []
        try:
            for i, (job, world) in enumerate(jobs):
                out = os.path.join(tmp, str(i))
                os.mkdir(out)
                started.append((mp.spawn(
                    rank_worker, args=(world, "gloo",
                                       os.path.join(out, "store"), job, out),
                    nprocs=world, join=False), out, world))
            if meanwhile is not None:
                meanwhile()
            for ctx, _, _ in started:
                while not ctx.join():
                    pass
        except BaseException:
            for ctx, _, _ in started:
                for proc in ctx.processes:
                    if proc.is_alive():
                        proc.terminate()
            raise
        results = []
        for _, out, world in started:
            ranks = []
            for rank in range(world):
                with open(os.path.join(out, f"rank{rank}.json")) as f:
                    ranks.append(json.load(f))
            results.append(ranks)
    return results


def phase_tp_parity():
    """fp32 on the card against one process at T = 1: T = 2 ranks at
    pipe 1, a pipe axis of 2 at V = 1 (2 ranks), and pipe 2 x model 2 at
    V = 1 (4 ranks); each kernel program against its composed sibling,
    at pipe 1 and at pipe 2 x model 2."""
    job = {"kind": "parity", "layers": 2, "seq": 128, "batch": 8,
           "dtype": torch.float32}
    torch.backends.cuda.matmul.allow_tf32 = False
    runner = tp_runner(job, "fp32", {"data": 1, "pipe": 1})
    one = runner.run_steps(tp_window(job, 3, seed0=100))["loss"].tolist()
    runner.close()
    torch.cuda.empty_cache()
    runs = ((TP_MESH, list(TP_PROGRAMS)), ({"data": 1, "pipe": PIPE},
                                           ["fp32"]),
            (QUANT_MESH, list(TP_PROGRAMS)))
    # The three jobs at once: parity, not time, is read here.
    results = spawn_together([
        (dict(job, mesh=mesh, programs=programs),
         math.prod(mesh.values())) for mesh, programs in runs])
    for (mesh, programs), ranks in zip(runs, results):
        world = math.prod(mesh.values())
        got = ranks[0]
        for rank in ranks[1:]:
            for program, losses in rank.items():
                check(all(abs(a - b) <= 1e-5 * abs(b)
                          for a, b in zip(losses, got[program])),
                      f"{program} on {mesh}: the ranks' losses differ: "
                      f"{ranks}")
        pairs = [("fp32", one, 1e-4, "T = 1")]
        if "fp32 vocab" in got:
            pairs.append(("fp32 vocab", got["fp32"], 1e-5,
                          "the full-vocab head"))
        if "matmul" in got:
            pairs += [("collective_matmul", got["matmul"], 1e-5,
                       "composed matmul"),
                      ("quant_ring", got["int8"], 2e-2, "composed int8")]
        for program, ref, tol, what in pairs:
            for i, (a, b) in enumerate(zip(got[program], ref)):
                check(math.isfinite(a) and abs(a - b) <= tol * abs(b),
                      f"{mesh_label(mesh)}, step {i}: {program} loss {a} vs "
                      f"{what} {b} differ by more than {tol} relative")
        print(f"phase 6 fp32 2-layer pipelined LM, seq 128, batch 8, 3 Adam "
              f"steps, {mesh_label(mesh)} ({world} ranks on one card over "
              f"gloo, V = {job['layers'] // mesh['pipe']}): T = 1 losses "
              f"{one}; " + "; ".join(f"{p} {got[p]}" for p in programs),
              flush=True)


def phase_tp_window():
    """bf16 window of the four programs at pipe 1 (T ranks) and on
    bench.py quant's mesh, pipe 2 x model 2 (4 ranks), on card 0 over
    gloo; over NCCL, one rank per card, where the machine has the
    cards (2: pipe 1 and a pipe axis of 2, fp32; 4: pipe 2 x model 2)."""
    job = {"kind": "window", "layers": TP_LAYERS, "seq": TP_SEQ,
           "batch": TP_BATCH, "dtype": torch.bfloat16}
    programs = ["fp32", "int8", "quant_ring", "collective_matmul"]
    quant = programs + ["fp32 full head"]
    pipe_only = {"data": 1, "pipe": PIPE}
    runs = [("gloo", TP_MESH, programs), ("gloo", QUANT_MESH, quant)]
    cards = torch.cuda.device_count()
    if cards >= TP:
        runs += [("nccl", TP_MESH, programs), ("nccl", pipe_only, ["fp32"])]
    if cards >= math.prod(QUANT_MESH.values()):
        runs.append(("nccl", QUANT_MESH, quant))
    counts = {}
    tokens = TP_STEPS * TP_BATCH * TP_SEQ
    for backend, mesh, progs in runs:
        world = math.prod(mesh.values())
        label = (f"{mesh_label(mesh)}, {world} ranks on one card, gloo, "
                 f"transfers through host" if backend == "gloo" else
                 f"{mesh_label(mesh)}, {world} ranks on {world} cards, NCCL")
        ranks = spawn_ranks(dict(job, mesh=mesh, programs=progs), world,
                            backend)
        for program in progs:
            r0 = ranks[0][program]
            dt = max(r[program]["seconds"] for r in ranks)
            peaks = ", ".join(f"{r[program]['peak_gb']:.2f}" for r in ranks)
            per_step = {k: n / TP_STEPS for k, n in r0["launches"].items()}
            line = (f"phase 7 {program} bf16 [{label}, run_steps route "
                    f"{r0['route']}]: {TP_STEPS} steps in "
                    f"{dt:.3f} s = {tokens / dt:.1f} tokens/s, step "
                    f"{dt / TP_STEPS * 1e3:.2f} ms, peak memory per rank "
                    f"{peaks} GB, loss {r0['loss'][0]:.4f} -> "
                    f"{r0['loss'][1]:.4f}, launches per step and rank "
                    f"{per_step}")
            if r0["profile"] is None:
                line += "; rank 0 profile: device time not measured"
            else:
                prof_ms, busy, n_launch, _, top = r0["profile"]
                line += (f"; rank 0 profile: device busy {busy:.2f} ms of "
                         f"the profiled step's {prof_ms:.2f} ms "
                         f"({busy / prof_ms:.1%}), {n_launch:.0f} kernel "
                         f"launches per step; top per step: {top}")
            print(line, flush=True)
            WINDOW_TIMES[(backend, mesh_label(mesh), program)] = (
                dt / TP_STEPS * 1e3, tokens / dt)
            if backend == "gloo":
                for name, n in r0["launches"].items():
                    counts[name] = counts.get(name, 0) + n
        if "fp32 full head" in progs:
            # The last pipe coordinate holds the loss head: the
            # vocab-parallel head's peak must sit below the full one's.
            last = [(r["fp32"]["peak_gb"], r["fp32 full head"]["peak_gb"])
                    for r in ranks if r["fp32"]["pipe"] == PIPE - 1]
            check(all(vp < full for vp, full in last),
                  f"{label}: the last pipe coordinate's peak memory with "
                  f"vocab_parallel {last} is not below the full head's")
            print(f"phase 7 [{label}] last pipe coordinate's peak memory "
                  f"per rank: vocab_parallel " + ", ".join(
                      f"{vp:.2f}" for vp, _ in last) + " GB, full-vocab "
                  "head " + ", ".join(f"{full:.2f}" for _, full in last)
                  + " GB", flush=True)
    return counts


# --------------------------------------------------------------------- #
# phase 10: tensor-parallel serving
# --------------------------------------------------------------------- #
# The serve mix's model at tensor parallel 2, the vocabulary sharded:
# each rank holds 8 of the 16 heads and half of the table; cut to 4 of
# its 8 layers to keep the whole script near its earlier run time.
SERVE_TP_LAYERS = 4
SERVE_TP_NEW = 24          # new tokens a request of the fp32 parity


def tp_serve_prompts(rng):
    """Phase 10's fp32 requests by layout: one of the longest prompt the
    engine takes, one random, one of a single token."""
    return {layout: [rng.randint(0, VOCAB, int(n)).tolist()
                     for n in (longest, rng.randint(1, longest + 1), 1)]
            for layout, longest in (("dense", 64), ("paged", 200))}


def tp_serve_mix(engine, layers, backend, label):
    """The bf16 serve mix on one tensor-parallel engine (``serve_mix``:
    the launch counters set to 0 just before it), held to the attention
    calls it made and to its route: gloo ranks keep the host loop, NCCL
    ranks capture one decode graph and replay it a window."""
    wall, comps, calls, got, replays = serve_mix(engine,
                                                 np.random.RandomState(0))
    check(all(c.finish_reason in FINISH_REASONS for c in comps),
          "invalid finish reason")
    check(all(0 <= t < VOCAB for c in comps for t in c.tokens),
          "token outside the vocabulary")
    free, used, total = engine.block_accounting()
    check(used == 0 and free == total, f"blocks leaked: {free, used}")
    if backend == "nccl":
        check(engine.captures == 1 and replays == calls["windows"] > 0,
              f"{label}: {engine.captures} captures and {replays} replays "
              f"for {calls['windows']} windows")
    else:
        check(engine.captures == engine.replays == 0,
              f"{label}: the gloo group captured a decode graph")
    want = dict.fromkeys(KERNELS, 0)
    if engine.kv_layout == "dense":
        want["flash_decode"] = layers * engine.decode_steps * calls["windows"]
    else:
        want["flash_decode_paged"] = (layers * engine.decode_steps
                                      * calls["windows"])
        want["flash_prefill_paged"] = layers * calls["chunks"]
    check(got == want, f"{label}: launches {got}, attention calls {want}")
    cuda_core = fp.flash_prefill_attention_paged.cuda_core_launches
    check(cuda_core == 0, f"{label}: K7's CUDA-core instance ran")
    itl = [ms for c in comps for ms in c.inter_token_ms]
    return {"wall": wall, "tokens": sum(len(c.tokens) for c in comps),
            "ttft_p50": sorted(c.ttft_s * 1e3 for c in comps)[len(comps) // 2],
            "itl": [float(np.percentile(itl, 50)),
                    float(np.percentile(itl, 99))],
            "windows": calls["windows"], "chunks": calls["chunks"],
            "replays": replays, "captures": engine.captures,
            "launches": got, "streams": [c.tokens for c in comps],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def tp_serve(job):
    """Phase 10 in one rank of the tensor-parallel group: the fp32
    streams of ``job["prompts"]`` on the dense and the paged + chunked
    engine, then the bf16 serve mix on each (``tp_serve_mix``)."""
    out = {"streams": {}, "mix": {}}
    for dtype, seed in ((torch.float32, 1), (torch.bfloat16, 0)):
        cfg = cfg_of(dtype, job["layers"])
        params = port.init_pipeline_lm_params(
            cfg, torch.Generator(device="cuda").manual_seed(seed),
            device="cuda")
        for layout in ENGINES:
            torch.cuda.reset_peak_memory_stats()
            engine = port.serve(cfg, params=params, device="cuda",
                                tensor_parallel=TP, vocab_parallel=True,
                                **ENGINES[layout])
            if dtype == torch.float32:
                batcher = port.ContinuousBatcher(engine)
                rids = [batcher.submit(p, max_new_tokens=SERVE_TP_NEW)
                        for p in job["prompts"][layout]]
                done = batcher.run()
                out["streams"][layout] = [done[r].tokens for r in rids]
            else:
                out["mix"][layout] = tp_serve_mix(
                    engine, job["layers"], job["backend"],
                    f"{layout} on {job['backend']}")
            engine.close()
            del engine
        del params
        torch.cuda.empty_cache()
    return out


def phase_tp_serve():
    """Serving at tensor parallel 2 with the vocabulary sharded: 2 ranks
    on card 0 over gloo, and again over NCCL one rank a card where the
    machine has 2 cards.  The fp32 streams equal the one-process
    engine's (a divergence counts as a tie where the recompute's top two
    logits are within 1e-4); the bf16 serve mix's numbers and counts."""
    torch.backends.cuda.matmul.allow_tf32 = False
    layers = SERVE_TP_LAYERS
    cfg = cfg_of(torch.float32, layers)
    params = port.init_pipeline_lm_params(
        cfg, torch.Generator(device="cuda").manual_seed(1), device="cuda")
    prompts = tp_serve_prompts(np.random.RandomState(1))
    want = {}
    for layout in ENGINES:
        engine = port.serve(cfg, params=params, device="cuda",
                            **ENGINES[layout])
        batcher = port.ContinuousBatcher(engine)
        rids = [batcher.submit(p, max_new_tokens=SERVE_TP_NEW)
                for p in prompts[layout]]
        done = batcher.run()
        want[layout] = [done[r].tokens for r in rids]
        engine.close()
    runs = [("gloo", f"{TP} ranks on one card, gloo, transfers through "
                     "host")]
    if torch.cuda.device_count() >= TP:
        runs.append(("nccl", f"{TP} ranks on {TP} cards, NCCL"))
    counts = {}
    for backend, label in runs:
        ranks = spawn_ranks({"kind": "serve", "layers": layers,
                             "prompts": prompts}, TP, backend)
        for r in ranks[1:]:
            check(r["streams"] == ranks[0]["streams"] and all(
                r["mix"][lay]["streams"] == ranks[0]["mix"][lay]["streams"]
                for lay in ENGINES), f"{label}: the ranks' streams differ")
        ties = 0
        for layout in ENGINES:
            for p, got, ref in zip(prompts[layout],
                                   ranks[0]["streams"][layout],
                                   want[layout]):
                if got == ref:
                    continue
                i = next(i for i, (a, b) in enumerate(zip(got, ref))
                         if a != b)
                seq = torch.as_tensor([p + ref[:i]], device="cuda")
                top2 = sequential_logits(cfg, params, seq)[0, -1].topk(2)
                gap = float(top2.values[0] - top2.values[1])
                check(gap < 1e-4, f"{label} {layout}: token {i} is "
                      f"{got[i]}, tensor parallel 1 gives {ref[i]} (top-2 "
                      f"gap {gap})")
                ties += 1
        print(f"phase 10 fp32 {layers}-layer pipelined LM [{label}]: "
              f"{sum(len(w) for w in want.values())} requests of "
              f"{SERVE_TP_NEW} tokens, dense and paged + chunked, equal "
              f"to tensor parallel 1 token for token (ties: {ties})",
              flush=True)
        for layout in ENGINES:
            m = ranks[0]["mix"][layout]
            peaks = ", ".join(f"{r['mix'][layout]['peak_gb']:.2f}"
                              for r in ranks)
            print(f"phase 10 {layout} bf16 [{label}, decode "
                  f"{'graph' if m['captures'] else 'host loop'}]: "
                  f"{m['tokens']} tokens in {m['wall']:.3f} s = "
                  f"{m['tokens'] / m['wall']:.1f} tokens/s, TTFT p50 "
                  f"{m['ttft_p50']:.2f} ms, inter-token p50 "
                  f"{m['itl'][0]:.3f} ms p99 {m['itl'][1]:.3f} ms, windows "
                  f"{m['windows']}, chunks {m['chunks']}, graph replays "
                  f"{m['replays']}, captures {m['captures']}, peak memory "
                  f"per rank {peaks} GB, rank 0 launches "
                  f"{ {k: v for k, v in m['launches'].items() if v} }",
                  flush=True)
            if backend == "gloo":
                for name, n in m["launches"].items():
                    counts[name] = counts.get(name, 0) + n
    del params
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------------- #
# phases 8 and 9: expert-parallel training of the MoE LM
# --------------------------------------------------------------------- #
def moe_cfg(job):
    return moe_transformer.MoeConfig(
        vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=job["layers"],
        num_heads=HEADS, expert_hidden=MOE_HIDDEN, num_experts=MOE_EXPERTS,
        capacity_factor=job["capacity"], max_len=job["seq"],
        dtype=job["dtype"])


def moe_runner(job, program, expert_sharded=True, extra=None):
    """AutoDist + ExpertParallel on the MoE LM (weights from seed 0 on
    the card, the same in every rank), with ``extra`` builder keywords
    beside the program's, or with ``expert_sharded=False`` the dense
    model through ``AllReduce`` on one process."""
    cfg = moe_cfg(job)
    trainable = port.make_moe_lm_trainable(
        cfg, port.optim.adam(job["lr"]),
        torch.Generator(device="cuda").manual_seed(0),
        batch_size=job["batch"], seq_len=job["seq"],
        expert_sharded=expert_sharded)
    if not expert_sharded:
        return port.AutoDist({}, port.AllReduce()).build(trainable)
    return port.AutoDist({"mesh": {"expert": EXPERT}}, port.ExpertParallel(
        num_experts=MOE_EXPERTS, capacity_factor=job["capacity"],
        **MOE_PROGRAMS[program], **(extra or {}))).build(trainable)


def moe_window(job, steps, seed0=0):
    """``steps`` next-token batches ``{"x", "y" = x shifted}`` from a
    numpy seed, stacked ``[steps, B, L]``."""
    batches = []
    for i in range(steps):
        x = np.random.RandomState(seed0 + i).randint(
            0, VOCAB, (job["batch"], job["seq"])).astype(np.int32)
        batches.append({"x": x, "y": np.roll(x, -1, axis=1)})
    return port.stack_steps(batches)


def moe_parity(job):
    """Phase 8 in one rank: 3 steps of each program; the nlls and
    losses."""
    out = {}
    for program in job["programs"]:
        runner = moe_runner(job, program)
        m = runner.run_steps(moe_window(job, 3, seed0=200))
        out[program] = {k: m[k].tolist() for k in ("nll", "loss")}
        runner.close()
        torch.cuda.empty_cache()
    return out


def moe_window_programs(job):
    """Phase 9 in one rank: per program a warm window, a timed one with
    the launch counters, then a profiled one."""
    out = {}
    for program in job["programs"]:
        runner = moe_runner(job, program)
        window = runner.place_steps(moe_window(job, MOE_STEPS))
        ar.fused_hop.unaligned = 0
        dt, metrics = timed_window(runner, window)
        got = launches()
        route = check_route(runner, job, program)
        check(ar.fused_hop.unaligned == 0,
              f"{program}: {ar.fused_hop.unaligned} K8 hops took the "
              f"element-wise path (the main path's arrays are aligned)")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = metrics["loss"].float()
        check(bool(torch.isfinite(losses).all()),
              f"{program}: non-finite loss {losses}")
        want = dict.fromkeys(KERNELS, 0)
        want.update({k: n * MOE_STEPS
                     for k, n in MOE_WANT.get(program, {}).items()})
        check(got == want, f"{program}: launches {got}, expected {want}")
        prof = profile_steps(runner, window, k=1, watch="ring_hop_kernel")
        out[program] = {"seconds": dt, "launches": got, "peak_gb": peak_gb,
                        "loss": [float(losses[0]), float(losses[-1])],
                        "profile": prof, "route": route}
        runner.close()
        del runner, window
        torch.cuda.empty_cache()
    return out


def phase_moe_parity():
    """fp32 on the card: each program on an expert axis of 2 against the
    dense one-process model, nll within the JAX golden's 5e-3."""
    # adam(1e-4): the sharded model averages the aux loss per shard, a
    # slightly different objective, and at 1e-3 the two trajectories of
    # this full-width model part by 4.2e-3 in nll by step 3 (H100).
    job = {"kind": "moe_parity", "layers": 1, "seq": 128, "batch": 8,
           "capacity": 4.0, "dtype": torch.float32, "lr": 1e-4,
           "programs": list(MOE_PROGRAMS)}
    torch.backends.cuda.matmul.allow_tf32 = False
    runner = moe_runner(job, None, expert_sharded=False)
    dense = runner.run_steps(moe_window(job, 3, seed0=200))["nll"].tolist()
    runner.close()
    torch.cuda.empty_cache()
    ranks = spawn_ranks(job, EXPERT)
    got = ranks[0]
    for program in job["programs"]:
        check(all(abs(a - b) <= 1e-6 * abs(b) for k in ("nll", "loss")
                  for a, b in zip(ranks[1][program][k], got[program][k])),
              f"{program}: the ranks' metrics differ: {ranks}")
        r = got[program]
        check(all(math.isfinite(x) for x in r["loss"] + r["nll"]),
              f"{program}: non-finite loss {r}")
        for i, (a, b) in enumerate(zip(r["nll"], dense)):
            check(abs(a - b) <= 5e-3, f"step {i}: {program} nll {a} vs "
                  f"dense {b} differ by more than 5e-3")
    print(f"phase 8 fp32 1-layer MoE LM, seq 128, batch 8, capacity 4.0, "
          f"3 Adam steps, expert axis 2 on one card over gloo: dense nll "
          f"{dense}; " + "; ".join(f"{p} {got[p]['nll']}"
                                   for p in job["programs"]), flush=True)


def phase_moe_window():
    """bf16 window of the composed int8 and a2a_ring programs: 2 ranks on
    card 0 over gloo, and over NCCL one rank per card where the machine
    has 2 cards."""
    job = {"kind": "moe_window", "layers": MOE_LAYERS, "seq": MOE_SEQ,
           "batch": MOE_ROWS * EXPERT, "capacity": 2.0, "lr": 1e-3,
           "dtype": torch.bfloat16, "programs": ["int8", "a2a_ring"]}
    counts = {}
    runs = [("gloo", f"{EXPERT} ranks on one card, gloo, transfers through "
                     f"host")]
    if torch.cuda.device_count() >= EXPERT:
        runs.append(("nccl", f"{EXPERT} ranks on {EXPERT} cards, NCCL"))
    tokens = MOE_STEPS * job["batch"] * MOE_SEQ
    for backend, label in runs:
        ranks = spawn_ranks(job, EXPERT, backend)
        for program in job["programs"]:
            r0 = ranks[0][program]
            dt = max(r[program]["seconds"] for r in ranks)
            peaks = ", ".join(f"{r[program]['peak_gb']:.2f}" for r in ranks)
            per_step = {k: n / MOE_STEPS for k, n in r0["launches"].items()
                        if n}
            line = (f"phase 9 {program} bf16 [{label}, run_steps route "
                    f"{r0['route']}]: {MOE_STEPS} steps "
                    f"in {dt:.3f} s = {tokens / dt:.1f} tokens/s, step "
                    f"{dt / MOE_STEPS * 1e3:.2f} ms, peak memory per rank "
                    f"{peaks} GB, loss {r0['loss'][0]:.4f} -> "
                    f"{r0['loss'][1]:.4f}, launches per step {per_step}")
            if r0["profile"] is None:
                line += "; rank 0 profile: device time not measured"
            else:
                prof_ms, busy, n_launch, _, top = r0["profile"]
                line += (f"; rank 0 profile: device busy {busy:.2f} ms of "
                         f"the profiled step's {prof_ms:.2f} ms "
                         f"({busy / prof_ms:.1%}), {n_launch:.0f} kernel "
                         f"launches per step; top per step: {top}")
            print(line, flush=True)
            if backend == "gloo":
                for name in MOE_KERNELS:
                    counts[name] = counts.get(name, 0) + r0["launches"][name]
    return counts


# --------------------------------------------------------------------- #
# phases 11 and 12: sequence-parallel training of the causal LM
# --------------------------------------------------------------------- #
def lm_runner(job, ring=None, remat=False, builder_kw=None):
    """``TransformerLM`` at full width, depth ``job["layers"]``, weights
    from seed 0 on the card (the same in every rank): with ``ring`` (a
    key of ``RINGS``) the causal ring and ``global_positions`` through
    ``AutoDist`` + ``SequenceParallel(**builder_kw)`` on
    ``job["mesh"]``; without, the whole sequence through
    ``flash_attention`` causal on one process (``AllReduce``)."""
    fn, pos = ((RINGS[ring](causal=True), global_positions) if ring
               else (fa.make_attention_fn(True), None))
    cfg = port.TransformerConfig(
        vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=job["layers"],
        num_heads=HEADS, mlp_dim=MLP, max_len=job["max_len"],
        dtype=job["dtype"], dropout_rate=0.0, attention_dropout_rate=0.0,
        remat=remat, attention_fn=fn, position_fn=pos)
    name, lr = job["opt"]
    trainable = port.make_lm_trainable(
        cfg, getattr(port.optim, name)(lr),
        torch.Generator(device="cuda").manual_seed(0))
    if ring is None:
        return port.AutoDist({}, port.AllReduce()).build(trainable)
    return port.AutoDist({"mesh": job["mesh"]}, port.SequenceParallel(
        **(builder_kw or {}))).build(trainable)


def lm_window(job, steps, seed0=0):
    """``steps`` next-token batches ``{"x", "y" = x shifted}`` of
    ``job["batch"]`` sequences of ``job["seq"]`` tokens from a numpy
    seed, stacked ``[steps, B, L]``."""
    batches = []
    for i in range(steps):
        x = np.random.RandomState(seed0 + i).randint(
            0, VOCAB, (job["batch"], job["seq"])).astype(np.int32)
        batches.append({"x": x, "y": np.roll(x, -1, axis=1)})
    return port.stack_steps(batches)


def seq_parity(job):
    """Phase 11 in one rank: 3 steps of each program; the losses."""
    out = {}
    for program in job["programs"]:
        runner = lm_runner(job, program.split()[0], "remat" in program)
        out[program] = runner.run_steps(lm_window(job, 3, seed0=300))[
            "loss"].tolist()
        runner.close()
        torch.cuda.empty_cache()
    return out


def phase_seq_parity():
    """fp32 on the card: the flash ring, the einsum ring and the flash
    ring under remat on a seq axis of 2 against one process with
    ``flash_attention`` causal over the whole sequence."""
    job = {"kind": "seq_parity", "layers": 2, "seq": 256, "max_len": 256,
           "batch": 4, "dtype": torch.float32, "opt": ("adam", 1e-4),
           "mesh": {"seq": SEQ},
           "programs": ["flash", "einsum", "flash remat"]}
    torch.backends.cuda.matmul.allow_tf32 = False
    runner = lm_runner(job)
    one = runner.run_steps(lm_window(job, 3, seed0=300))["loss"].tolist()
    runner.close()
    torch.cuda.empty_cache()
    ranks = spawn_ranks(job, SEQ)
    got = ranks[0]
    for program in job["programs"]:
        check(all(abs(a - b) <= 1e-6 * abs(b) for a, b in
                  zip(ranks[1][program], got[program])),
              f"{program}: the ranks' losses differ: {ranks}")
    pairs = [("flash", one, 1e-4, "one process"),
             ("einsum", one, 1e-4, "one process"),
             ("flash remat", got["flash"], 1e-6, "no remat")]
    for program, ref, tol, what in pairs:
        for i, (a, b) in enumerate(zip(got[program], ref)):
            check(math.isfinite(a) and abs(a - b) <= tol * abs(b),
                  f"step {i}: {program} loss {a} vs {what} {b} differ by "
                  f"more than {tol} relative")
    print(f"phase 11 fp32 2-layer TransformerLM, global seq 256, batch 4, "
          f"3 Adam steps, seq 2 on one card over gloo: one process "
          f"(flash_attention causal) {one}; " + "; ".join(
              f"{p} {got[p]}" for p in job["programs"]), flush=True)


def kernel_ms(top):
    """K1, K2a and K2b device ms a step from a profile's top list."""
    frags = {"flash_attention_fwd": "fwd_wgmma_kernel",
             "flash_attention_bwd_dq": "dq_wgmma_kernel",
             "flash_attention_bwd_dkv": "dkv_wgmma_kernel"}
    found = dict.fromkeys(frags, 0.0)
    for entry in top.split("; "):
        m = re.match(r"(.*) x[\d.]+ ([\d.]+) ms$", entry)
        for name, frag in frags.items():
            if m and frag in m.group(1) and "matmul" not in m.group(1):
                found[name] += float(m.group(2))
    return found


def seq_window_rows(job):
    """Phase 12 in one rank: per row a warm window, a timed one with the
    launch counters, then a profiled one of 2 steps."""
    out = {}
    for row in job["rows"]:
        rj = dict(job, **row)
        runner = lm_runner(rj, "flash", row["remat"])
        index = runner.lowered.mesh.axis("seq").index
        window = runner.place_steps(lm_window(rj, row["steps"]))
        dt, metrics = timed_window(runner, window)
        graphs = (runner.captures, runner.replays)
        route = check_route(runner, job, row["label"])
        if job["backend"] == "nccl":
            check(graphs == (1, 2), f"{row['label']}: {graphs[0]} captures "
                  f"and {graphs[1]} replays, expected 1 and 2")
        got = launches()
        want = dict.fromkeys(KERNELS, 0)
        want.update({k: n * row["steps"] for k, n in seq_want(
            index, job["layers"], row["remat"]).items()})
        check(got == want, f"{row['label']} on seq rank {index}: launches "
                           f"{got}, expected {want}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = metrics["loss"].float()
        check(bool(torch.isfinite(losses).all()),
              f"{row['label']}: non-finite loss {losses}")
        prof = profile_steps(runner, window, k=2, watch="wgmma_kernel")
        out[row["label"]] = {
            "seconds": dt, "launches": got, "peak_gb": peak_gb,
            "index": index, "loss": [float(losses[0]), float(losses[-1])],
            "profile": prof, "route": route,
            "attention_ms": None if prof is None else kernel_ms(prof[4])}
        runner.close()
        del runner, window
        torch.cuda.empty_cache()
    return out


def long_context_one_process(job):
    """One process over the whole 8192-token sequence (``flash_attention``
    causal, a loop of ``step`` calls as the gloo ranks run): step ms and
    peak memory."""
    rj = dict(job, batch=1, seq=LONG_LEN, max_len=LONG_LEN)
    runner = lm_runner(rj)
    window = runner.place_steps(lm_window(rj, LONG_STEPS))
    dt, _ = timed_window(runner, window, loop=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    runner.close()
    del runner, window
    torch.cuda.empty_cache()
    return dt, peak_gb


def phase_seq_window():
    """bf16: the window on a seq axis of 2 over gloo (2 ranks on card
    0), then the long-context rows, remat off and on, beside one process
    at the whole sequence; over NCCL, one rank per card, where the
    machine has the cards (2: seq 2; 4: also seq 4, global 2048)."""
    main = {"label": "window", "batch": SEQ_BATCH, "seq": SEQ_LEN,
            "max_len": SEQ_LEN, "steps": SEQ_STEPS, "remat": False}
    long_rows = [{"label": f"long context{' remat' if remat else ''}",
                  "batch": 1, "seq": LONG_LEN, "max_len": LONG_LEN,
                  "steps": LONG_STEPS, "remat": remat}
                 for remat in (False, True)]
    job = {"kind": "seq_window", "layers": SEQ_LAYERS,
           "dtype": torch.bfloat16, "opt": ("adamw", 3e-4)}
    runs = [("gloo", {"seq": SEQ}, [main] + long_rows)]
    cards = torch.cuda.device_count()
    if cards >= SEQ:
        runs.append(("nccl", {"seq": SEQ}, [main]))
    if cards >= 4:
        runs.append(("nccl", {"seq": 4}, [main]))
    counts = {}
    for backend, mesh, rows in runs:
        world = math.prod(mesh.values())
        label = (f"{mesh_label(mesh)}, {world} ranks on one card, gloo, "
                 f"transfers through host" if backend == "gloo" else
                 f"{mesh_label(mesh)}, {world} ranks on {world} cards, NCCL")
        ranks = spawn_ranks(dict(job, mesh=mesh, rows=rows), world, backend)
        for row in rows:
            rs = [r[row["label"]] for r in ranks]
            dt = max(r["seconds"] for r in rs)
            tokens = row["steps"] * row["batch"] * row["seq"]
            line = (f"phase 12 {row['label']} bf16 [{label}, batch "
                    f"{row['batch']} of {row['seq']} tokens, positional "
                    f"table {row['max_len']} rows, run_steps route "
                    f"{rs[0]['route']}]: {row['steps']} steps in {dt:.3f} s "
                    f"= {tokens / dt:.1f} tokens/s, step "
                    f"{dt / row['steps'] * 1e3:.2f} ms, peak memory per "
                    f"rank " + ", ".join(f"{r['peak_gb']:.2f}" for r in rs)
                    + f" GB, loss {rs[0]['loss'][0]:.4f} -> "
                    f"{rs[0]['loss'][1]:.4f}")
            for r in rs:
                per_step = {k: n / row["steps"]
                            for k, n in r["launches"].items() if n}
                line += f"; seq rank {r['index']}: launches a step {per_step}"
                if r["profile"] is None:
                    line += ", profile: device time not measured"
                    continue
                prof_ms, busy, n_launch, _, top = r["profile"]
                line += (f", device busy {busy:.2f} ms of the profiled "
                         f"step's {prof_ms:.2f} ms ({busy / prof_ms:.1%}), "
                         f"{n_launch:.0f} kernel launches a step, K1/K2a/"
                         f"K2b device ms a step "
                         + "/".join(f"{ms:.3f}" for ms in
                                    r["attention_ms"].values())
                         + f"; top a step: {top}")
            print(line, flush=True)
            if backend == "gloo" and row is main:
                for r in rs:
                    for name, n in r["launches"].items():
                        counts[name] = counts.get(name, 0) + n
        if backend == "gloo":
            dt, peak_gb = long_context_one_process(job)
            print(f"phase 12 long context bf16 [one process on one card, "
                  f"batch 1 of {LONG_LEN} tokens, flash_attention causal, "
                  f"a loop of step calls]: step {dt / LONG_STEPS * 1e3:.2f} "
                  f"ms, peak memory {peak_gb:.2f} GB", flush=True)
    return counts


# --------------------------------------------------------------------- #
# phases 13 and 14: the data-parallel strategy zoo on BERT
# --------------------------------------------------------------------- #
def zoo_builder(spec):
    """A builder from ``(name, kwargs)``; ``None`` is AutoDist's default
    (``PSLoadBalancing``)."""
    if spec is None:
        return None
    name, kw = spec
    if name == "GradAccumulation":
        kw = dict(kw, builder=zoo_builder(kw["builder"]))
    return getattr(port, name)(**kw)


def zoo_runner(job, spec, batch):
    """BERT at full width, ``job["layers"]`` deep, the flash attention,
    weights from seed 0 on the card (every rank and row alike), through
    ``AutoDist({}, builder)``: the data axis is the job's ranks."""
    cfg = port.TransformerConfig(               # BERT-base's widths
        num_layers=job["layers"], dtype=job["dtype"], dropout_rate=0.0,
        attention_dropout_rate=0.0, attention_fn=fa.make_attention_fn(False))
    lr, wd, mu, eps = job["opt"]
    trainable = bert.make_mlm_trainable(
        cfg, port.optim.adamw(lr, eps=eps, weight_decay=wd, mu_dtype=mu),
        torch.Generator(device="cuda").manual_seed(0),
        with_input_mask=False)
    return port.AutoDist({}, zoo_builder(spec)).build(trainable), trainable


def zoo_window(job, steps, batch, seed0=0):
    batches = []
    for i in range(steps):
        b = bert.synthetic_mlm_batch(seed0 + i, batch, job["seq"],
                                     job["masked"], 30522)
        b.pop("input_mask")
        batches.append(b)
    return port.stack_steps(batches)


def state_bytes(tree):
    return sum(t.numel() * t.element_size()
               for _, t in flatten_with_names(tree)
               if isinstance(t, torch.Tensor))


def tensor_errs(got, want):
    """Per tensor max |a - b| over max |b|, floored at 1e-3 (a tensor
    that stays near 0, as the k projection's bias whose gradient is
    zero, is held at 1e-3 absolute times the tolerance)."""
    w = dict(flatten_with_names(want))
    return {n: float((a.float() - w[n].float()).abs().max()
                     / w[n].float().abs().max().clamp(min=1e-3))
            for n, a in flatten_with_names(got)}


def rel_err(got, want):
    """The largest of :func:`tensor_errs` over the tree."""
    return max(tensor_errs(got, want).values())


# Phase 13's wire units: a loss may part from AllReduce's by this much of
# itself for every update behind it (fp16, bf16: the wire's unit; int8:
# two levels of 1/127 of the largest value, its own rounding and the
# group scale's; PowerSGD: 1, a rank-r wire keeps no precision of the
# gradient outside its top r directions, so only the first loss, before
# any update, and finite losses are held).
ZOO_WIRE = {"fp16": 2.0 ** -11, "fp16_ef": 2.0 ** -11, "bf16": 2.0 ** -8,
            "bf16_ef": 2.0 ** -8, "int8_ef": 2.0 / 127,
            "int8_ring": 2.0 / 127, "powersgd:2": 1.0}
ZOO_GOLDEN = [("AllReduce", ("AllReduce", {"chunk_size": 2})),
              ("AllReduce-chunk1", ("AllReduce", {"chunk_size": 1})),
              ("PS", ("PS", {})), ("PSLoadBalancing", ("PSLoadBalancing", {})),
              ("PartitionedPS", ("PartitionedPS", {})),
              ("UnevenPartitionedPS", ("UnevenPartitionedPS", {})),
              ("PartitionedAR", ("PartitionedAR", {})),
              ("RandomAxisPartitionAR", ("RandomAxisPartitionAR",
                                         {"seed": 3})),
              ("Parallax", ("Parallax", {})),
              ("ZeRO1", ("ZeRO", {"stage": 1})),
              ("ZeRO2", ("ZeRO", {"stage": 2})),
              ("ZeRO3", ("ZeRO", {"stage": 3})),
              ("GradAccumulation", ("GradAccumulation", {
                  "builder": ("AllReduce", {}), "steps": 2}))]
ZOO_COMPRESSED = [(c, ("AllReduce", {"compressor": c})) for c in ZOO_WIRE]


def zoo_parity(job):
    """Phase 13 in one rank: 3 steps of every builder; losses, the
    parameters' largest relative distance from AllReduce's, the logical
    shapes of ``get_params``, stored bytes."""
    out, ref = {}, None
    world = torch.distributed.get_world_size()
    window = zoo_window(job, 3, job["batch"] * world, seed0=400)
    for label, spec in ZOO_GOLDEN + ZOO_COMPRESSED:
        runner, trainable = zoo_runner(job, spec, job["batch"])
        losses = runner.run_steps(window)["loss"].tolist()
        params = runner.get_params()
        shapes_ok = ([(n, tuple(t.shape)) for n, t in
                      flatten_with_names(params)]
                     == [(n, tuple(t.shape)) for n, t in
                         flatten_with_names(trainable.params)])
        if ref is None:
            ref = params
        out[label] = {"loss": losses, "shapes_ok": shapes_ok,
                      "err": rel_err(params, ref),
                      "params_bytes": state_bytes(runner.state["params"]),
                      "opt_bytes": state_bytes(runner.state["opt_state"]),
                      "route": check_route(runner, job, label)}
        runner.close()
        del runner, trainable, params
        torch.cuda.empty_cache()
    return out


def phase_zoo_parity():
    """fp32 on the card: BERT at full width cut to 2 layers, 3 AdamW
    steps of every golden builder, every compressor and accumulation on
    2 ranks over gloo (and over NCCL with 2 or more cards), each held to
    AllReduce's run on the same weights and batches."""
    # Adam's eps at 1e-4: the k projection's bias has an exactly zero
    # gradient (a softmax does not see a shift of every score), and at
    # 1e-8 Adam turns its summation-order noise into steps of the
    # learning rate that differ between any two reduction orders (a
    # microbatch sum, a reduce-scatter, NCCL's ring).
    job = {"kind": "zoo_parity", "layers": 2, "dtype": torch.float32,
           "seq": 128, "masked": 20, "batch": 4,
           "opt": (1e-4, 0.01, None, 1e-4)}
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = [("gloo", 2)]
    if torch.cuda.device_count() >= 2:
        runs.append(("nccl", torch.cuda.device_count()))
    for backend, world in runs:
        ranks = spawn_ranks(job, world, backend)
        got, ar = ranks[0], ranks[0]["AllReduce"]["loss"]
        faults = []
        for label, res in got.items():
            if not res["shapes_ok"]:
                faults.append(f"{label}: get_params shapes differ from "
                              f"the logical tree")
            if not all(math.isfinite(x) for x in res["loss"]):
                faults.append(f"{label}: non-finite loss {res['loss']}")
            if label not in ZOO_WIRE:
                if not (res["err"] <= 1e-5 and all(
                        abs(a - b) <= 1e-5 * abs(b)
                        for a, b in zip(res["loss"], ar))):
                    faults.append(
                        f"{label}: losses {res['loss']} vs AllReduce "
                        f"{ar}, params {res['err']:.3g} relative")
                continue
            eps = ZOO_WIRE[label]
            for k, (a, b) in enumerate(zip(res["loss"], ar)):
                bound = 1e-6 * abs(b) if k == 0 else eps * k * abs(b)
                if abs(a - b) > bound:
                    faults.append(f"{label} step {k}: loss {a} vs "
                                  f"AllReduce {b}, bound {bound:.3g}")
        sizes = {n: (got[n]["params_bytes"], got[n]["opt_bytes"])
                 for n in ("AllReduce", "PS", "PartitionedPS")}
        ar_p, ar_o = sizes["AllReduce"]
        if not (sizes["PS"][0] == ar_p and sizes["PS"][1] <= ar_o / world
                * 1.01 and sizes["PartitionedPS"][0] <= ar_p / world * 1.01
                and sizes["PartitionedPS"][1] <= ar_o / world * 1.01):
            faults.append(f"stored bytes a rank at data {world}: {sizes}")
        print(f"phase 13 fp32 2-layer BERT-base width, seq 128, batch "
              f"{job['batch']} a rank, 3 AdamW steps, data {world} "
              f"[{world} ranks, {backend}, run_steps route "
              f"{got['AllReduce']['route']}]: AllReduce losses {ar}; "
              + "; ".join(f"{n} params {r['err']:.2e} rel., last loss "
                          f"{r['loss'][-1]:.6f}" for n, r in got.items()
                          if n != "AllReduce")
              + "; stored bytes a rank (params, optimizer state) "
              + ", ".join(f"{n} {p}, {o}" for n, (p, o) in sizes.items()),
              flush=True)
        check(not faults, f"phase 13 over {backend}: " + "; ".join(faults))


# Phase 14's rows on the graph route: (label, builder spec).
ZOO_ROWS = [
    ("AutoDist default (PSLoadBalancing)", None),
    ("PartitionedPS", ("PartitionedPS", {})),
    *[(f"AllReduce {c}", ("AllReduce", {"chunk_size": 256,
                                        "compressor": c}))
      for c in ("bf16_ef", "int8_ring", "int8_ef", "powersgd:2")],
    ("GradAccumulation 2", ("GradAccumulation", {
        "builder": ("AllReduce", {"chunk_size": 256}), "steps": 2})),
    ("AllReduce", ("AllReduce", {"chunk_size": 256}))]
ZOO_GLOO = [("PS", ("PS", {})), ("PartitionedPS", ("PartitionedPS", {})),
            ("AllReduce", ("AllReduce", {"chunk_size": 256}))]


def zoo_bf16_job(world=1):
    return {"kind": "zoo_window", "layers": 12, "dtype": torch.bfloat16,
            "seq": BERT_SEQ, "masked": BERT_MASKED, "batch": BERT_BATCH,
            "opt": (1e-4, 0.01, torch.bfloat16, 1e-8), "world": world}


def zoo_row(job, label, spec, steps, check_graph):
    """One row: a warm window and a timed one (launch counters from 0
    before it), on the runner's route; the row's numbers and its final
    parameters."""
    world = job["world"]
    runner, _ = zoo_runner(job, spec, job["batch"])
    window = runner.place_steps(zoo_window(job, steps, job["batch"] * world))
    dt, metrics = timed_window(runner, window)
    got = launches()
    accum = 2 if label.startswith("GradAccumulation") else 1
    want = dict.fromkeys(KERNELS, 0)
    want.update(dict.fromkeys(TRAINING_KERNELS,
                              job["layers"] * steps * accum))
    check(got == want, f"{label}: launches {got}, expected {want}")
    if check_graph:
        check((runner.captures, runner.replays) == (1, 2),
              f"{label}: {runner.captures} captures and {runner.replays} "
              f"replays, expected 1 and 2")
    losses = metrics["loss"].float()
    check(bool(torch.isfinite(losses).all()), f"{label}: non-finite loss")
    row = {"seconds": dt, "launches": got,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "capture_s": runner.capture_seconds,
           "graphs": (runner.captures, runner.replays),
           "loss": [float(losses[0]), float(losses[-1])],
           "params_bytes": state_bytes(runner.state["params"]),
           "opt_bytes": state_bytes(runner.state["opt_state"]),
           "sync_bytes": state_bytes(runner.state["sync_state"])}
    params = runner.get_params()
    runner.close()
    del runner, window
    torch.cuda.empty_cache()
    return row, params


def zoo_window_rows(job):
    """Phase 14 in one rank of a spawned job: each row of ``job["rows"]``
    (labels into ``ZOO_ROWS`` or ``ZOO_GLOO``); with ``job["digest"]``
    rank 0 keeps each row's final parameters for the caller."""
    out, rows = {}, dict(ZOO_ROWS + ZOO_GLOO)
    for label in job["rows"]:
        row, params = zoo_row(job, label, rows[label], job["steps"],
                              job["backend"] == "nccl")
        row["route"] = "graph" if job["backend"] == "nccl" else "loop"
        if job.get("digest") and torch.distributed.get_rank() == 0:
            torch.save({n: t.cpu() for n, t in flatten_with_names(params)},
                       os.path.join(job["digest"], f"{label}.pt"))
        out[label] = row
        del params
    return out


def zoo_line(label, row, steps, batch, flops, chip, where):
    rate = steps * batch / row["seconds"]
    return (f"phase 14 {label} bf16 [{where}]: {steps} steps in "
            f"{row['seconds']:.3f} s = {rate:.2f} examples/s, step "
            f"{row['seconds'] / steps * 1e3:.2f} ms, MFU "
            f"{rate * flops / (chip.peak_bf16_tflops * 1e12):.4f}, peak "
            f"memory {row['peak_gb']:.2f} GB, stored bytes (params, "
            f"optimizer state, compressor rows) {row['params_bytes']}, "
            f"{row['opt_bytes']}, {row['sync_bytes']}, graph captures "
            f"{row['graphs'][0]} ({row['capture_s']:.2f} s), replays "
            f"{row['graphs'][1]}, loss {row['loss'][0]:.4f} -> "
            f"{row['loss'][1]:.4f}")


def update_distance(got, want, init):
    """``|got - want|_2 / |want - init|_2`` over the whole tree: how far
    two runs part, against how far the reference moved.  Over the tree,
    not a tensor: the k projection's bias has a zero gradient, so at
    Adam's eps 1e-8 its steps are summation noise, as large in one run
    as the other."""
    apart = sum(float((got[n].float() - w.float()).norm()) ** 2
                for n, w in want.items())
    moved = sum(float((w.float() - init[n].float()).norm()) ** 2
                for n, w in want.items())
    return (apart / max(moved, 1e-30)) ** 0.5


def phase_zoo_window():
    """bf16 BERT-base, the bench's window: every row on one card on the
    graph route; PS, PartitionedPS and AllReduce at data 2 over gloo on
    the card; over NCCL at data = the cards where there are 2 or more,
    each row's parameters held to one card's on the same batches.
    Returns the default row's launches."""
    cfg = bert.bert_base()
    flops = bert.mlm_model_flops_per_example(cfg, BERT_SEQ, BERT_MASKED)
    chip = port.ResourceSpec({}).chip
    job = dict(zoo_bf16_job(), backend="nccl")       # one card: graph
    counts = {}
    for label, spec in ZOO_ROWS:
        row, _ = zoo_row(job, label, spec, ZOO_STEPS, True)
        if spec is None:
            counts = {k: row["launches"][k] for k in TRAINING_KERNELS}
        print(zoo_line(label, row, ZOO_STEPS, BERT_BATCH, flops, chip,
                       "one card, data 1, run_steps route graph"),
              flush=True)
    ranks = spawn_ranks(dict(zoo_bf16_job(2), steps=ZOO_GLOO_STEPS,
                             rows=[label for label, _ in ZOO_GLOO]), 2)
    for label, _ in ZOO_GLOO:
        rs = [r[label] for r in ranks]
        dt = max(r["seconds"] for r in rs)
        print(f"phase 14 {label} bf16 [data 2, 2 ranks on one card, gloo, "
              f"transfers through host, run_steps route loop, batch "
              f"{BERT_BATCH} a rank]: {ZOO_GLOO_STEPS} steps in "
              f"{dt:.3f} s, step {dt / ZOO_GLOO_STEPS * 1e3:.2f} ms; per "
              f"rank: peak memory "
              + ", ".join(f"{r['peak_gb']:.2f}" for r in rs)
              + " GB, stored bytes (params, optimizer state) "
              + ", ".join(f"{r['params_bytes']}, {r['opt_bytes']}"
                          for r in rs), flush=True)
    cards = torch.cuda.device_count()
    if cards >= 2:
        with tempfile.TemporaryDirectory() as digest:
            ranks = spawn_ranks(dict(zoo_bf16_job(cards), steps=ZOO_STEPS,
                                     rows=[label for label, _ in ZOO_ROWS],
                                     digest=digest), cards, "nccl")
            init_runner, _ = zoo_runner(zoo_bf16_job(cards), None,
                                        BERT_BATCH)
            init = {n: t.cpu() for n, t in flatten_with_names(
                init_runner.get_params())}
            init_runner.close()
            job_n = dict(zoo_bf16_job(cards), backend="nccl",
                         batch=BERT_BATCH * cards, world=1)
            for label, spec in ZOO_ROWS:
                rs = [r[label] for r in ranks]
                _, params = zoo_row(job_n, label, spec, ZOO_STEPS, True)
                ref = {n: t.cpu() for n, t in flatten_with_names(params)}
                del params
                dist = update_distance(
                    torch.load(os.path.join(digest, f"{label}.pt")), ref,
                    init)
                check(dist <= 0.1, f"{label} over NCCL at data {cards}: "
                      f"parameters {dist:.3g} of one card's update away")
                print(zoo_line(label, rs[0], ZOO_STEPS,
                               BERT_BATCH * cards, flops, chip,
                               f"data {cards}, {cards} cards, NCCL, "
                               f"run_steps route graph, batch {BERT_BATCH} "
                               f"a card")
                      + f"; parameters against one card's on the same "
                      f"{BERT_BATCH * cards}-row batches: {dist:.3e} of "
                      f"its update; peak memory per rank "
                      + ", ".join(f"{r['peak_gb']:.2f}" for r in rs)
                      + " GB", flush=True)
    return counts


# --------------------------------------------------------------------- #
# phases 15 and 16: ZeRO, compressors, accumulation and remat in the
# pipeline, sequence and expert lowerings
# --------------------------------------------------------------------- #
# A narrowed wire's unit, and whether it narrows the forward on its mesh
# too (a weight gather or a model-axis boundary: the first loss moves)
# or only the gradients.
BF16_GRAD, BF16_FWD = (2.0 ** -8, False), (2.0 ** -8, True)
INT8_GRAD, INT8_FWD = (2.0 / 127, False), (2.0 / 127, True)
# The fault row: the plain program at a learning rate of 0, which every
# bound must reject.
NO_UPDATE = "no update"
# The narrowed rows' optimizer and their reference: SGD, whose update is
# the synced gradient times the rate, so that a wire's rounding of each
# gradient shows in the parameters in proportion.  Adam at eps 1e-8
# steps every element by about the rate whatever its gradient, so an
# int8 wire that rounds the small gradients to 0 takes those steps away
# (0.88 of the table's update, the no-update run's 1.0: PERF.md, phase
# 15).
LINEAR, LINEAR_LR = "plain, SGD", 0.1
# An exact row held on SGD: accumulation sums each gradient as two
# half-batch sums, and where the halves cancel their rounding is a large
# share of a small gradient, which Adam divides by that gradient's own
# size (3.0e-4 of the q and v biases' largest value at eps 1e-4, 2.71e-3
# at 1e-8: PERF.md, phase 15).  SGD's step is linear in the gradient.
EXACT_SGD = "exact, SGD"
# Every slot of the "int8" string but vocab_stats: at this fp32 width a
# token whose tied logit stands ~11 above the rest has a sum-exp near 1
# beside others' ~400, and the group's shared int8 scale rounds it to 0
# (log 0: a loss of -inf).  The JAX package's rule gives the same -inf
# on such inputs (tests/test_torch_vocab_parallel.py,
# test_int8_stats_underflow_is_the_jax_rule).
INT8_BUT_STATS = {"tp_psum": "int8", "grad": "int8", "zero3_gather": "int8",
                  "moe_a2a": "int8"}


def zero_pipe_programs(int8, model_axis):
    """Phase 15's pipeline programs: (label, Pipeline keywords,
    accumulation steps, the wire, None for an exact one), the int8
    program at ``int8``, which narrows the forward only on a mesh with a
    ``model_axis``.  The mix: variables of 1 MiB and more (the kernels,
    the table) ZeRO-3, the rest bf16_ef."""
    return [
        ("plain", {}, 1, None),
        (LINEAR, {}, 1, LINEAR),
        (NO_UPDATE, {}, 1, NO_UPDATE),
        ("ZeRO-1", dict(zero_stage=1), 1, None),
        ("ZeRO-2", dict(zero_stage=2), 1, None),
        ("ZeRO-3", dict(zero_stage=3), 1, None),
        ("zero_min_bytes", dict(zero_stage=3, zero_min_bytes=1 << 20,
                                compressor="bf16_ef"), 1, BF16_GRAD),
        ("ZeRO-3 zero3_gather bf16", dict(zero_stage=3, collective_precision={
            "zero3_gather": "bf16"}), 1, BF16_FWD),
        ("bf16_ef", dict(compressor="bf16_ef"), 1, BF16_GRAD),
        ("int8", dict(collective_precision=int8), 1,
         INT8_FWD if model_axis else INT8_GRAD),
        ("GradAccumulation 2", {}, 2, EXACT_SGD),
        ("remat", dict(remat=True), 1, None)]


# On the vocab-parallel mesh also the fused int8 ring under remat: its
# recompute re-runs the stages' forward rings in the backward.
RING_REMAT = ("int8 quant_ring remat", dict(
    collective_precision=INT8_BUT_STATS, kernel=("quant_ring",),
    remat=True), 1, INT8_FWD)
# (mesh, layout, the int8 program's precision)
ZERO_PIPE_MESHES = [({"data": 2, "pipe": 2}, {}, "int8"),
                    ({"data": 2, "pipe": 1, "model": TP}, VOCAB_PARALLEL,
                     INT8_BUT_STATS)]
# Phase 16's pipeline rows at data 2 x pipe 2: (label, keywords, accum).
ZERO_WINDOW_ROWS = [("plain", {}, 1), ("ZeRO-1", dict(zero_stage=1), 1),
                    ("ZeRO-3", dict(zero_stage=3), 1),
                    ("GradAccumulation 2", {}, 2),
                    ("remat", dict(remat=True), 1)]
ZERO_WINDOW_STEPS = 1
ZERO_PARITY_STEPS = 2


def ring_remat_want(layers, first):
    """K3 a rank and step under remat at T = 2: ``tp_want``'s four rings
    a layer and microbatch plus the two forward rings recomputed in the
    backward (the prologue's lookup ring is outside the stages)."""
    return {"quant_ring_hop": 2 * 6 * layers * TP_MICRO
            + (TP if first else 0)}


def zero_pipe_runner(job, kw, accum, opt=None):
    """AutoDist + Pipeline (wrapped in GradAccumulation when ``accum`` >
    1) on the pipelined LM at full width, depth ``job["layers"]``, over
    ``job["mesh"]``; weights from seed 0 on the card; ``opt``, or Adam
    at ``job["opt"]``."""
    mesh = job["mesh"]
    cfg = port.TransformerConfig(
        vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=job["layers"],
        num_heads=HEADS, mlp_dim=MLP, max_len=job["seq"], dtype=job["dtype"],
        dropout_rate=0.0, attention_dropout_rate=0.0)
    rate, eps = job["opt"]
    trainable = make_pipeline_lm_trainable(
        cfg, opt or port.optim.adam(rate, eps=eps),
        torch.Generator(device="cuda").manual_seed(0))
    builder = Pipeline(num_microbatches=TP_MICRO,
                       virtual_stages=job["layers"] // mesh["pipe"],
                       tensor_parallel=mesh.get("model", 1),
                       **job["layout"], **kw)
    if accum > 1:
        builder = port.GradAccumulation(builder, accum)
    return port.AutoDist({"mesh": mesh}, builder).build(trainable)


def var_bytes(state):
    """Bytes a rank stores a variable: ``(params, optimizer state)``, the
    latter its Adam moments."""
    params = {nm: t.numel() * t.element_size()
              for nm, t in state["params"].items()}
    opt = dict.fromkeys(params, 0)
    for nm, t in flatten_with_names(state["opt_state"]):
        if nm.startswith(("mu/", "nu/")):
            opt[nm[3:]] += t.numel() * t.element_size()
    return params, opt


def zero_record(runner):
    """Stored bytes a variable and the lowering's records: the ZeRO
    (PS) variables, those stored as ZeRO-3 shards, the degraded ones,
    the unapplied slots."""
    params, opt = var_bytes(runner.state)
    low = runner.lowered
    return {"params_bytes": params, "opt_bytes": opt,
            "zero": sorted(nc.var_name for nc in runner.strategy.node_configs
                           if nc.synchronizer.kind == "ps"),
            "zero3": sorted(low.zero3_shapes),
            "degraded": sorted(low.zero_degraded),
            "unapplied": sorted(low.unapplied)}


def gradient_kept(runner):
    """From a run under Adam: each tensor's elements (logical shapes)
    whose gradient is more than summation noise, the root of Adam's
    second moment above 1e-5 of its tensor's largest; and each tensor's
    peak, the largest of those roots over their mean square's root.  A
    gradient that is zero in exact arithmetic (the k projection's bias:
    a softmax does not see a shift of every score) is fp32 noise, which
    Adam scales by up to lr / eps: two summation orders draw it
    apart."""
    nu = {nm[3:]: t for nm, t in flatten_with_names(
        runner.state["opt_state"]) if nm.startswith("nu/")}
    kept, peak = {}, {}
    for nm, t in runner.lowered.full_params(nu).items():
        g = t.sqrt()
        kept[nm] = g > 1e-5 * g.max()
        k = g[kept[nm]]
        peak[nm] = float(k.max() / k.pow(2).mean().sqrt()) if k.numel() \
            else 1.0
    return kept, peak


def kept_distances(got, want, init, kept):
    """Per tensor over its ``kept`` elements: ``(max |a - b| / max |b|,
    floored at 1e-3; |a - b|_2 / |b - init|_2)``, the exact rows' and the
    narrowed rows' distances from the reference ``want``."""
    out = {}
    for n, a in got.items():
        k = kept[n]
        d = (a.float() - want[n].float())[k]
        moved = (want[n].float() - init[n].float())[k].norm()
        out[n] = (float(d.abs().max() / want[n].float().abs().max().clamp(
                      min=1e-3)) if d.numel() else 0.0,
                  float(d.norm() / moved.clamp(min=1e-30)))
    return out


def wire_allowance(wire, peak):
    """A narrowed row's distance from the SGD reference a tensor may
    take, in units of the tensor's update: the wire's unit a step (bf16
    rounds each element by half a unit at most); int8 rounds to a level
    of 1/127 of the tensor's largest gradient, so a quarter of its
    ``peak`` (largest over mean square) times that, at least one
    unit."""
    unit, _ = wire
    if unit == BF16_GRAD[0]:
        return unit * ZERO_PARITY_STEPS
    return unit * ZERO_PARITY_STEPS * max(1.0, peak / 4)


def zero_pipe_parity(job):
    """Phase 15's pipeline in one rank: 2 steps of each program; losses,
    the parameters' distances from the reference's over the elements
    with a real gradient (:func:`gradient_kept`: the plain program's
    for the exact rows, the SGD program's for the narrowed ones),
    stored bytes a variable, and K3's launches."""
    out, refs, init, kept, peak = {}, {}, None, None, None
    window = tp_window(job, ZERO_PARITY_STEPS, seed0=500)
    eps = job["opt"][1]
    for label, kw, accum, wire in job["programs"]:
        # Adam for the exact rows (ZeRO's optimizer state is what they
        # shard), SGD for the rest.
        opt = (port.optim.adam(0.0, eps=eps) if wire == NO_UPDATE
               else None if wire is None
               else port.optim.sgd(LINEAR_LR))
        runner = zero_pipe_runner(job, kw, accum, opt)
        pipe = runner.lowered.mesh.axis("pipe").index
        if init is None:
            init = dict(flatten_with_names(runner.get_params()))
        reset_launches()
        losses = runner.run_steps(window)["loss"].tolist()
        got = launches()
        params = dict(flatten_with_names(runner.get_params()))
        if label == "plain":
            kept, peak = gradient_kept(runner)
        if label in ("plain", LINEAR):
            refs[label] = params
        ref = refs["plain" if wire in (None, NO_UPDATE) else LINEAR]
        dists = kept_distances(params, ref, init, kept)
        errs = {n: e for n, (e, _) in dists.items()}
        moved = {n: m for n, (_, m) in dists.items()}
        over = ({n: m / wire_allowance(wire, peak[n])
                 for n, m in moved.items()}
                if isinstance(wire, tuple) else {"-": 0.0})
        out[label] = dict(zero_record(runner), loss=losses,
                          err=max(errs.values()),
                          worst=max(errs, key=errs.get),
                          moved=max(moved.values()),
                          moved_worst=max(moved, key=moved.get),
                          over=max(over.values()),
                          over_worst=max(over, key=over.get),
                          left_out=sum(int((~k).sum()) for k in
                                       kept.values()),
                          left_out_by=({n: int((~k).sum())
                                        for n, k in kept.items()
                                        if int((~k).sum())}),
                          launches=got, pipe=pipe,
                          route=check_route(runner, job, label))
        runner.close()
        del runner, params
        torch.cuda.empty_cache()
    return out


def zero_seq_parity(job):
    """Phase 15's sequence rows in one rank: 3 steps plain and under
    ZeRO-3 with the flash ring; losses, parameter distance, bytes and
    K1/K2 launches."""
    out, ref = {}, None
    window = lm_window(job, ZERO_PARITY_STEPS, seed0=600)
    for label, kw in job["programs"]:
        runner = lm_runner(job, "flash", builder_kw=kw)
        reset_launches()
        losses = runner.run_steps(window)["loss"].tolist()
        got = launches()
        params = runner.get_params()
        ref = params if ref is None else ref
        out[label] = dict(zero_record(runner), loss=losses,
                          err=rel_err(params, ref), launches=got,
                          index=runner.lowered.mesh.axis("seq").index)
        runner.close()
        del runner, params
        torch.cuda.empty_cache()
    return out


def zero_moe_parity(job):
    """Phase 15's expert rows in one rank: 3 steps of ``a2a_ring`` plain
    and under ZeRO-1; losses, parameter distance, bytes and K8's
    launches."""
    out, ref = {}, None
    window = moe_window(job, ZERO_PARITY_STEPS, seed0=700)
    for label, kw in job["programs"]:
        runner = moe_runner(job, "a2a_ring", extra=kw)
        reset_launches()
        losses = runner.run_steps(window)["loss"].tolist()
        got = launches()
        params = runner.get_params()
        ref = params if ref is None else ref
        out[label] = dict(zero_record(runner), loss=losses,
                          err=rel_err(params, ref), launches=got)
        runner.close()
        del runner, params
        torch.cuda.empty_cache()
    return out


# A narrowed forward wire's loss at step 0, before any update, relative
# to the reference's: the readings reach 1.28e-4 (the int8 ring under
# remat; the bf16 gather 2.2e-5: PERF.md, phase 15), a broken wire's scale
# would part it by its own error.
FWD_LOSS0 = 1e-3


def held(label, res, plain, wire, fault=None):
    """Phase 13's rule against the plain program: exact wires within 1e-5
    per tensor (of its largest value, floored at 1e-3) and 1e-5 on every
    loss.  A narrowed wire (``plain`` the SGD reference) per tensor
    within :func:`wire_allowance` of the tensor's update (``|a - b|_2 /
    |b - init|_2``), its loss at step k >= 1 within ``unit x k`` of the
    gap the updates opened between the reference's loss and the
    no-update run's (``fault``), and at step 0, before any update, within
    1e-6 of the reference's loss for a gradient wire and FWD_LOSS0 for a
    forward one.  Returns the faults."""
    faults = []
    if not all(math.isfinite(x) for x in res["loss"]):
        return [f"{label}: non-finite loss {res['loss']}"]
    if wire is None:
        if not (res["err"] <= 1e-5 and all(
                abs(a - b) <= 1e-5 * abs(b)
                for a, b in zip(res["loss"], plain["loss"]))):
            faults.append(f"{label}: losses {res['loss']} vs plain "
                          f"{plain['loss']}, params {res['err']:.3g} "
                          f"relative")
        return faults
    unit, forward = wire
    if res["over"] > 1:
        faults.append(f"{label}: {res['over_worst']} {res['over']:.3g} of "
                      f"its allowance from the SGD reference")
    for k, (a, b, c) in enumerate(zip(res["loss"], plain["loss"],
                                      fault["loss"])):
        bound = (unit * k * abs(b - c) if k
                 else (FWD_LOSS0 if forward else 1e-6) * abs(b))
        if abs(a - b) > bound:
            faults.append(f"{label} step {k}: loss {a} vs plain {b}, bound "
                          f"{bound:.3g}")
    return faults


def held_rows(where, r, programs):
    """Phase 13's rule over one rank's rows of ``programs`` (phase 15's
    table: the "plain", LINEAR and NO_UPDATE rows among them): each
    exact row held to the plain program, each narrowed one to the SGD
    reference (:func:`held`), and the no-update row rejected.  Returns
    the faults."""
    faults = []
    for label, _, _, wire in programs:
        res = r[label]
        if wire == NO_UPDATE:
            # Every bound must reject a run that never moves: its
            # parameters a whole update away, beyond the exact rule, and
            # its later losses apart from both references' (so that the
            # narrowed rows' loss bound, a part of that gap, stands
            # above fp32 noise).
            if not (res["err"] > 1e-5 and all(
                    abs(a - b) > 1e-4 * abs(b)
                    for ref in ("plain", LINEAR) for a, b in zip(
                        res["loss"][1:], r[ref]["loss"][1:]))):
                faults.append(f"{where}: the no-update run is not "
                              f"rejected ({res['err']:.3g}, losses "
                              f"{res['loss']})")
        elif wire != LINEAR:
            faults += held(f"{where} {label}", res,
                           r["plain"] if wire is None else r[LINEAR],
                           None if wire == EXACT_SGD else wire,
                           r[NO_UPDATE])
    return faults


def sharded_as_promised(label, res, plain, n):
    """The fraction ZeRO promises a rank, variable by variable: a ZeRO
    variable keeps about ``1/n`` of its optimizer state, at stage 3 of
    its parameter too; a degraded one and any other keep their plain
    bytes (the vocab table's state still shards: its record names stage
    3 only)."""
    faults = []
    for nm, p in plain["params_bytes"].items():
        o = plain["opt_bytes"][nm]
        got_p, got_o = res["params_bytes"][nm], res["opt_bytes"][nm]
        slack = 4 * n * 4                   # a few padded elements
        if nm not in res["zero"] or (nm in res["degraded"]
                                     and nm != "shared/embedding"):
            ok = got_p == p and got_o == o
        else:
            ok = got_o <= o / n + slack and (
                got_p <= p / n + slack if nm in res["zero3"]
                else got_p == p)
        if not ok:
            faults.append(f"{label} {nm}: params {got_p} of {p}, optimizer "
                          f"state {got_o} of {o} bytes a rank")
    return faults


def zero_sums(res):
    return (sum(res["params_bytes"].values()),
            sum(res["opt_bytes"].values()))


def phase_zero_parity():
    """fp32 on the card: the pipelined LM at full width cut to 2 layers
    (1 at pipe 1) with every ZeRO stage, the zero_min_bytes mix, the
    narrowed gather, a compressor, the "int8" string, accumulation and
    remat, each held to the plain program of its mesh (data 2 x pipe 2;
    data 2 x model 2 with vocab_parallel); the sequence lowering's
    ZeRO-3 on seq 2 and the expert lowering's ZeRO-1 on expert 2, each
    to its plain program; the stored bytes a rank of every row.  The
    four jobs (4, 4, 2 and 2 ranks) run at once on card 0 over gloo;
    2 steps each."""
    torch.backends.cuda.matmul.allow_tf32 = False
    counts, faults, jobs = {}, [], []
    for mesh, layout, int8 in ZERO_PIPE_MESHES:
        # Adam at lr 1e-3 as bench.py quant builds it, at eps 1e-4 as
        # phase 13 runs it: at the bench's 1e-8 Adam steps each element
        # by the whole rate wherever its gradient's sign is summation
        # noise, and accumulation's two half-batch sums drew elements
        # 2 x lr apart (2.71e-3 and 2.17e-3 of a tensor's largest value,
        # with every gradient at or below 100 x eps left out: PERF.md,
        # phase 15); at 1e-4 the step is continuous in the gradient.  The
        # elements whose gradient is summation noise are left out of
        # the parameter checks (gradient_kept).
        jobs.append(({"kind": "zero_pipe_parity", "layers": mesh["pipe"],
                      "seq": 128, "batch": 8, "dtype": torch.float32,
                      "opt": (1e-3, 1e-4), "mesh": mesh, "layout": layout,
                      "programs": zero_pipe_programs(int8, "model" in mesh)
                      + ([RING_REMAT] if layout else [])},
                     math.prod(mesh.values())))
    seq_job = {"kind": "zero_seq_parity", "layers": 2, "seq": 256,
               "max_len": 256, "batch": 4, "dtype": torch.float32,
               "opt": ("adam", 1e-4), "mesh": {"seq": SEQ},
               "programs": [("plain", {}), ("ZeRO-3", dict(zero_stage=3))]}
    moe_job = {"kind": "zero_moe_parity", "layers": 1, "seq": 128,
               "batch": 8, "capacity": 4.0, "dtype": torch.float32,
               "lr": 1e-4,
               "programs": [("plain", {}), ("ZeRO-1", dict(zero_stage=1))]}
    *pipe_ranks, seq_ranks, moe_ranks = spawn_together(
        jobs + [(seq_job, SEQ), (moe_job, EXPERT)])
    for (job, world), ranks in zip(jobs, pipe_ranks):
        mesh, programs = job["mesh"], job["programs"]
        got, plain = ranks[0], ranks[0]["plain"]
        where = f"{mesh_label(mesh)}" + (", vocab_parallel"
                                         if job["layout"] else "")
        for r in ranks:
            faults += held_rows(where, r, programs)
        for label, _, _, wire in programs:
            for r in ranks:
                if wire != NO_UPDATE:
                    faults += sharded_as_promised(
                        f"{where} {label}", r[label],
                        r["plain"] if wire is None else r[LINEAR],
                        mesh["data"])
            if label == RING_REMAT[0]:
                for r in ranks:
                    res = r[label]
                    want = dict.fromkeys(KERNELS, 0)
                    want.update({k: n * ZERO_PARITY_STEPS
                                 for k, n in ring_remat_want(
                                     job["layers"] // mesh["pipe"],
                                     res["pipe"] == 0).items()})
                    if res["launches"] != want:
                        faults.append(f"{where} {label}: launches "
                                      f"{res['launches']}, expected {want}")
                for name, n in got[label]["launches"].items():
                    counts[name] = counts.get(name, 0) + n
        print(f"phase 15 fp32 {job['layers']}-layer pipelined LM, seq 128, "
              f"batch 8, {ZERO_PARITY_STEPS} Adam steps (lr 1e-3, eps 1e-4; "
              f"accumulation and the narrowed rows SGD at {LINEAR_LR}), "
              f"{where} [{world} ranks on one card, gloo, run_steps route "
              f"{plain['route']}]: plain losses {plain['loss']}; "
              f"{plain['left_out']} elements with a noise gradient left "
              f"out (by tensor: {plain['left_out_by']}); "
              + "; ".join(
                  f"{label} losses {got[label]['loss']}, params "
                  f"{got[label]['err']:.2e} rel. ({got[label]['worst']}), "
                  f"{got[label]['moved']:.3e} of the update "
                  f"({got[label]['moved_worst']}), "
                  f"{got[label]['over']:.3g} of the allowance "
                  f"({got[label]['over_worst']})"
                  for label, *_ in programs if label != "plain")
              + "; stored bytes rank 0 (params, optimizer state): "
              + ", ".join(f"{label} {'%d, %d' % zero_sums(got[label])}"
                          for label, *_ in programs)
              + "; degraded: " + ", ".join(
                  f"{label} {len(got[label]['degraded'])}"
                  for label, *_ in programs if got[label]["degraded"])
              + "; unapplied: " + (", ".join(
                  f"{label} {got[label]['unapplied']}"
                  for label, *_ in programs if got[label]["unapplied"])
                  or "none"), flush=True)
    for r in seq_ranks:
        res = r["ZeRO-3"]
        faults += held("seq 2 ZeRO-3", res, r["plain"], None)
        faults += sharded_as_promised("ZeRO-3", res, r["plain"], SEQ)
        for label in ("plain", "ZeRO-3"):
            want = dict.fromkeys(KERNELS, 0)
            want.update({k: n * ZERO_PARITY_STEPS for k, n in seq_want(
                r[label]["index"], seq_job["layers"]).items()})
            if r[label]["launches"] != want:
                faults.append(f"seq 2 {label} on seq rank "
                              f"{r[label]['index']}: launches "
                              f"{r[label]['launches']}, expected {want}")
        for name, n in r["ZeRO-3"]["launches"].items():
            counts[name] = counts.get(name, 0) + n
    got = seq_ranks[0]
    print(f"phase 15 fp32 2-layer TransformerLM, global seq 256, batch 4, "
          f"{ZERO_PARITY_STEPS} Adam steps, the flash ring on seq 2 [2 ranks "
          f"on one card, gloo]: plain losses {got['plain']['loss']}, ZeRO-3 "
          f"{got['ZeRO-3']['loss']}, params {got['ZeRO-3']['err']:.2e} "
          f"rel.; stored bytes a rank (params, optimizer state) plain "
          f"{'%d, %d' % zero_sums(got['plain'])}, ZeRO-3 "
          f"{'%d, %d' % zero_sums(got['ZeRO-3'])}", flush=True)
    for r in moe_ranks:
        res = r["ZeRO-1"]
        faults += held("expert 2 ZeRO-1", res, r["plain"], None)
        faults += sharded_as_promised("ZeRO-1", res, r["plain"], EXPERT)
        if not res["degraded"]:
            faults.append("expert 2 ZeRO-1: no expert table degraded")
        want = dict.fromkeys(KERNELS, 0)
        want["a2a_ring_hop"] = (EXPERT * 2 * 2 * moe_job["layers"]
                                * ZERO_PARITY_STEPS)
        for label in ("plain", "ZeRO-1"):
            if r[label]["launches"] != want:
                faults.append(f"expert 2 {label}: launches "
                              f"{r[label]['launches']}, expected {want}")
    got = moe_ranks[0]
    for name, n in got["ZeRO-1"]["launches"].items():
        counts[name] = counts.get(name, 0) + n
    print(f"phase 15 fp32 1-layer MoE LM, seq 128, batch 8, capacity 4.0, "
          f"{ZERO_PARITY_STEPS} Adam steps, a2a_ring on expert 2 [2 ranks "
          f"on one card, gloo]: plain losses {got['plain']['loss']}, ZeRO-1 "
          f"{got['ZeRO-1']['loss']}, params {got['ZeRO-1']['err']:.2e} "
          f"rel.; stored bytes a rank (params, optimizer state) plain "
          f"{'%d, %d' % zero_sums(got['plain'])}, ZeRO-1 "
          f"{'%d, %d' % zero_sums(got['ZeRO-1'])}; degraded "
          f"{got['ZeRO-1']['degraded']}", flush=True)
    check(not faults, "phase 15: " + "; ".join(faults))
    return counts


def zero_window_rows(job):
    """Phase 16 in one rank: per row a warm window and a timed one (the
    launch counters from 0 before it); step seconds, peak memory, stored
    bytes."""
    out = {}
    for label, kw, accum in job["rows"]:
        if job["lowering"] == "pipeline":
            runner = zero_pipe_runner(job, kw, accum)
            window = runner.place_steps(tp_window(job, ZERO_WINDOW_STEPS))
        else:
            runner = lm_runner(job, "flash", builder_kw=kw)
            window = runner.place_steps(lm_window(job, ZERO_WINDOW_STEPS))
        dt, metrics = timed_window(runner, window)
        route = check_route(runner, job, label)
        if job["backend"] == "nccl":
            check((runner.captures, runner.replays) == (1, 2),
                  f"{label}: {runner.captures} captures and "
                  f"{runner.replays} replays, expected 1 and 2")
        losses = metrics["loss"].float()
        check(bool(torch.isfinite(losses).all()),
              f"{label}: non-finite loss {losses}")
        rec = zero_record(runner)
        out[label] = {"seconds": dt, "launches": launches(),
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "bytes": zero_sums(rec), "route": route,
                      "loss": [float(losses[0]), float(losses[-1])]}
        if job["lowering"] == "sequence":
            index = runner.lowered.mesh.axis("seq").index
            want = dict.fromkeys(KERNELS, 0)
            want.update({k: n * ZERO_WINDOW_STEPS for k, n in seq_want(
                index, job["layers"]).items()})
            check(out[label]["launches"] == want,
                  f"{label} on seq rank {index}: launches "
                  f"{out[label]['launches']}, expected {want}")
        runner.close()
        del runner, window
        torch.cuda.empty_cache()
    return out


def phase_zero_window():
    """bf16: the pipelined LM of bench.py quant's width, 4 layers, at data
    2 x pipe 2 plain, under ZeRO-1, ZeRO-3, GradAccumulation 2 and
    remat, and the sequence window (phase 12's model, seq 2) plain and
    under ZeRO-3: step ms, peak memory a rank and stored bytes a rank,
    ZeRO-3's parameters about half the plain row's; 2-step windows, the
    sequence model cut to 2 layers.  Over gloo on card 0; over
    NCCL on the graph route, one rank a card, where there are the cards
    (4: the pipeline; 2: the sequence window)."""
    pipe_job = {"kind": "zero_window", "lowering": "pipeline",
                "layers": TP_LAYERS, "seq": TP_SEQ, "batch": TP_BATCH,
                "dtype": torch.bfloat16, "opt": (1e-3, 1e-8),
                "mesh": {"data": 2, "pipe": PIPE}, "layout": {},
                "rows": ZERO_WINDOW_ROWS}
    # The sequence rows cut phase 12's model to 2 of its 4 layers (the
    # rows run over gloo, so their depth is the lever on run time).
    seq_job = {"kind": "zero_window", "lowering": "sequence",
               "layers": 2, "seq": SEQ_LEN, "max_len": SEQ_LEN,
               "batch": SEQ_BATCH, "dtype": torch.bfloat16,
               "opt": ("adamw", 3e-4), "mesh": {"seq": SEQ},
               "rows": [("plain", {}, 1),
                        ("ZeRO-3", dict(zero_stage=3), 1)]}
    runs = [("gloo", pipe_job), ("gloo", seq_job)]
    cards = torch.cuda.device_count()
    if cards >= 4:
        runs.append(("nccl", pipe_job))
    if cards >= SEQ:
        runs.append(("nccl", seq_job))
    counts = {}
    for backend, job in runs:
        mesh = job["mesh"]
        world = math.prod(mesh.values())
        where = (f"{mesh_label(mesh)}, {world} ranks on one card, gloo, "
                 f"transfers through host" if backend == "gloo" else
                 f"{mesh_label(mesh)}, {world} ranks on {world} cards, NCCL")
        ranks = spawn_ranks(job, world, backend)
        plain = ranks[0]["plain"]["bytes"]
        for label, _, accum in job["rows"]:
            rs = [r[label] for r in ranks]
            dt = max(r["seconds"] for r in rs)
            tokens = ZERO_WINDOW_STEPS * job["batch"] * job["seq"]
            print(f"phase 16 {job['lowering']} {label} bf16 [{where}, "
                  f"{job['layers']} layers, batch {job['batch']} of "
                  f"{job['seq']} tokens, run_steps route {rs[0]['route']}]: "
                  f"{ZERO_WINDOW_STEPS} steps in {dt:.3f} s = "
                  f"{tokens / dt:.1f} tokens/s, step "
                  f"{dt / ZERO_WINDOW_STEPS * 1e3:.2f} ms, peak memory per "
                  f"rank " + ", ".join(f"{r['peak_gb']:.2f}" for r in rs)
                  + " GB, stored bytes a rank (params, optimizer state) "
                  + ", ".join(f"{r['bytes'][0]}, {r['bytes'][1]}"
                              for r in rs)
                  + f" (plain rank 0: {plain[0]}, {plain[1]}), loss "
                  f"{rs[0]['loss'][0]:.4f} -> {rs[0]['loss'][1]:.4f}",
                  flush=True)
            if label == "ZeRO-3":
                for r in ranks:
                    p3, p = r[label]["bytes"][0], r["plain"]["bytes"][0]
                    check(p3 <= 0.51 * p, f"{job['lowering']} ZeRO-3 over "
                          f"{backend}: {p3} parameter bytes a rank against "
                          f"the plain row's {p}")
            if label == "ZeRO-1":
                for r in ranks:
                    o1, o = r[label]["bytes"][1], r["plain"]["bytes"][1]
                    check(o1 <= 0.51 * o, f"pipeline ZeRO-1 over {backend}: "
                          f"{o1} optimizer bytes a rank against {o}")
            if backend == "gloo" and job["lowering"] == "sequence" \
                    and label == "ZeRO-3":
                for r in rs:
                    for name, n in r["launches"].items():
                        counts[name] = counts.get(name, 0) + n
    return counts


# --------------------------------------------------------------------- #
# phases 17 and 18: the rest of serving (sampling, prefix caching,
# speculative decoding, K1 in the prefill, the prefill graphs)
# --------------------------------------------------------------------- #
SAMPLING = dict(temperature=0.9, top_k=40)
LADDER_LAYERS = 2          # phase 17: the serve width cut to 2 layers
LADDER_NEW = 24            # new tokens a request of phase 17
SHARED_PREFIX = 2 * BLOCK_LEN


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def ladder_want(engine, calls):
    """The launches each kernel wrapper must count for ``calls``: K5/K6
    ``layers`` a token step (the draft's 1 a step), K7 ``layers`` a
    chunk or verify window, K1 ``layers`` a single-shot prefill under
    the flash ``attention_fn``."""
    want = dict.fromkeys(KERNELS, 0)
    decode = ("flash_decode" if engine.kv_layout == "dense"
              else "flash_decode_paged")
    parts = [(engine, calls["prefills"], calls["chunks"])]
    if engine.draft is None:
        want[decode] += (engine.cfg.num_layers * engine.decode_steps
                         * calls["windows"])
    else:
        d = engine.draft
        want[decode] += d.cfg.num_layers * (
            d.decode_steps * calls["proposals"] + calls["catchups"])
        want["flash_prefill_paged"] += engine.cfg.num_layers * calls[
            "windows"]
        parts.append((d, calls["draft_prefills"], calls["draft_chunks"]))
    for e, prefills, chunks in parts:
        if e.prefill_chunk is not None:
            want["flash_prefill_paged"] += e.cfg.num_layers * chunks
        elif e.cfg.attention_fn is not None:
            want["flash_attention_fwd"] += e.cfg.num_layers * prefills
    return want


def check_graphs(engine, calls, label):
    """One prefill graph (the bucket or the chunk shape) and one window
    graph (decode or verify; the draft's decode and catch-up), each
    replayed at every call after the first; none on the eager routes."""
    def dispatches(e, prefills, chunks):
        return chunks if e.prefill_chunk is not None else prefills

    d = engine.draft
    rows = [(engine, dispatches(engine, calls["prefills"], calls["chunks"]),
             calls["windows"], 0)]
    if d is not None:
        rows.append((d, dispatches(d, calls["draft_prefills"],
                                   calls["draft_chunks"]),
                     calls["proposals"], calls["catchups"]))
    for e, n_pre, n_win, n_one in rows:
        pre = (int(n_pre > 0), max(n_pre - 1, 0)) if e.prefill_graph \
            else (0, 0)
        win = ((int(n_win > 0) + int(n_one > 0),
                max(n_win - 1, 0) + max(n_one - 1, 0)) if e.decode_graph
               else (0, 0))
        got = ((e.prefill_captures, e.prefill_replays),
               (e.captures, e.replays))
        check(got == (pre, win), f"{label}: prefill (captures, replays) "
              f"{got[0]} and window {got[1]}, the calls give {pre} and "
              f"{win}")


def run_staggered(engine, requests):
    """The first request admitted alone (one scheduler round), then the
    rest, so that later admissions find its prefix resident (same-batch
    requests never share).  Returns the completions in request order."""
    batcher = port.ContinuousBatcher(engine)
    p, n, s = requests[0]
    rids = [batcher.submit(p, max_new_tokens=n, seed=s)]
    batcher.step()
    rids += [batcher.submit(p, max_new_tokens=n, seed=s)
             for p, n, s in requests[1:]]
    batcher.run()
    return [batcher.completions[r] for r in rids]


def block_trace_clean(events):
    """Replay an allocator trace: no ``write`` lands on a block whose
    reference count is not exactly 1.  Returns (writes, cows)."""
    rc, writes, cows = {}, 0, 0
    for ev in events:
        kind, b = ev[0], ev[1]
        if kind == "alloc":
            rc[b] = 1
        elif kind == "share":
            rc[b] += 1
        elif kind == "free":
            rc[b] -= 1
        elif kind == "write":
            check(rc.get(b, 0) == 1, f"write on block {b} at refcount "
                  f"{rc.get(b, 0)}")
            writes += 1
        elif kind == "cow":
            cows += 1
    return writes, cows


def same_streams(a, b, stops, label):
    """Two engines' streams token for token, each up to where its
    recompute comparison stopped at a near tie."""
    for i, (x, y) in enumerate(zip(a, b)):
        m = min(stops[0][i], stops[1][i])
        check(x[:m] == y[:m], f"{label}: request {i} differs: {x} vs {y}")
        if m == len(x):
            check(x == y, f"{label}: request {i} differs: {x} vs {y}")


def phase_ladder_parity():
    """fp32 parity of the serving ladder at the serve width cut to 2
    layers (4 requests sharing a 2-block prefix through
    ``ContinuousBatcher``, each engine on the prefill-graph route and
    eagerly)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    where = card()
    cfg = cfg_of(torch.float32, LADDER_LAYERS)
    k1 = dataclasses.replace(cfg, attention_fn=port.ops.make_attention_fn(
        True))
    params = port.init_pipeline_lm_params(
        cfg, torch.Generator(device="cuda").manual_seed(1), device="cuda")
    draft_cfg = cfg_of(torch.float32, 1)
    drafts = {"same": dict(draft_cfg=cfg, draft_params=params),
              "other": dict(draft_cfg=draft_cfg,
                            draft_params=port.init_pipeline_lm_params(
                                draft_cfg, torch.Generator(
                                    device="cuda").manual_seed(2),
                                device="cuda"))}
    layouts = {
        "dense": dict(num_slots=8, decode_steps=8, prefill_len=64),
        "paged": dict(num_slots=8, decode_steps=8, prefill_len=64,
                      kv_layout="paged", kv_block_len=BLOCK_LEN),
        "chunked": dict(num_slots=8, decode_steps=8, prefill_len=64,
                        kv_layout="paged", kv_block_len=BLOCK_LEN,
                        prefill_chunk=BLOCK_LEN)}
    # (label, layout, the vanilla engine it must equal, kwargs); the
    # first of each layout and sampling is its vanilla engine.
    variants = [
        ("dense", "dense", None, {}),
        ("dense sampled", "dense", None, SAMPLING),
        ("dense spec same", "dense", "dense", dict(speculative=SPEC_K,
                                                   draft="same")),
        ("dense spec other sampled", "dense", "dense sampled",
         dict(speculative=SPEC_K, draft="other", **SAMPLING)),
        ("dense K1 sampled", "dense", "dense sampled",
         dict(k1=True, **SAMPLING)),
        ("paged", "paged", None, {}),
        ("paged sampled", "paged", None, SAMPLING),
        ("paged K1 sampled", "paged", "paged sampled",
         dict(k1=True, **SAMPLING)),
        ("paged cached sampled", "paged", "paged sampled",
         dict(prefix_caching=True, **SAMPLING)),
        ("paged spec other", "paged", "paged", dict(speculative=SPEC_K,
                                                    draft="other")),
        ("chunked", "chunked", None, {}),
        ("chunked sampled", "chunked", None, SAMPLING),
        ("chunked cached", "chunked", "chunked",
         dict(prefix_caching=True)),
        ("chunked cached spec same sampled", "chunked", "chunked sampled",
         dict(prefix_caching=True, speculative=SPEC_K, draft="same",
              **SAMPLING)),
    ]
    # A 2-block shared prefix and suffixes of 10, 25 and 3 tokens; the
    # last request repeats the first, so its partial tail block is shared
    # too and its first decode step copies it on write.
    rng = np.random.RandomState(17)
    shared = rng.randint(0, VOCAB, SHARED_PREFIX).tolist()
    requests = [(shared + rng.randint(0, VOCAB, n).tolist(), LADDER_NEW, s)
                for s, n in enumerate((10, 25, 3))]
    requests.append((requests[0][0], LADDER_NEW, 3))
    streams, stops, ties = {}, {}, 0
    for label, layout, vanilla, kw in variants:
        kw = dict(kw)
        draft = drafts[kw.pop("draft")] if "draft" in kw else {}
        ecfg = k1 if kw.pop("k1", False) else cfg
        sampling = {k: kw[k] for k in SAMPLING if k in kw}
        for route in ("graph", "eager"):
            name = f"{label} {route}"
            engine = port.serve(ecfg, params=params, device="cuda",
                                prefill_graph=route == "graph",
                                **layouts[layout], **draft, **kw)
            calls = ladder_calls(engine)
            reset_launches()
            comps = run_staggered(engine, requests)
            torch.cuda.synchronize()
            got = [c.tokens for c in comps]
            check(launches() == ladder_want(engine, calls),
                  f"{name}: launches {launches()}, the calls "
                  f"{ladder_want(engine, calls)}")
            check_graphs(engine, calls, name)
            stop = []
            for (p, _, s), toks in zip(requests, got):
                at = recompute_check(cfg, params, p, toks, s, sampling,
                                     name)
                stop.append(at)
                ties += at < len(toks)
            for e in (engine, engine.draft):
                if e is not None:
                    free, used, total = e.block_accounting()
                    check(used == 0 and free == total,
                          f"{name}: blocks leaked ({free}, {used})")
            writes = cows = 0
            if engine.kv_layout == "paged":
                writes, cows = block_trace_clean(engine._allocator.events)
            hits = sum(c.prefix_hit_blocks for c in comps)
            proposed = sum(c.spec_proposed for c in comps)
            accepted = sum(c.spec_accepted for c in comps)
            if engine.prefix_caching:
                check(hits > 0 and cows > 0, f"{name}: {hits} hit blocks, "
                      f"{cows} copies on write")
            if engine.draft is not None:
                check(proposed > 0, f"{name}: nothing proposed")
            streams[name], stops[name] = got, stop
            if route == "eager":
                same_streams(streams[f"{label} graph"], got,
                             (stops[f"{label} graph"], stop),
                             f"{label}: graph against eager")
            if vanilla is not None:
                same_streams(streams[f"{vanilla} {route}"], got,
                             (stops[f"{vanilla} {route}"], stop),
                             f"{name} against {vanilla}")
            print(f"phase 17 {name} fp32 [{where}]: "
                  f"{sum(map(len, got))} tokens over {len(got)} requests "
                  f"equal to the recompute, graph == eager"
                  + (f", == {vanilla}" if vanilla else "")
                  + f"; prefix-hit blocks {hits}, writes {writes}, copies "
                  f"on write {cows}; proposed {proposed}, accepted "
                  f"{accepted}; launches "
                  f"{ {k: v for k, v in launches().items() if v} }; "
                  f"prefill graphs {engine.prefill_captures}/"
                  f"{engine.prefill_replays}, window graphs "
                  f"{engine.captures}/{engine.replays}", flush=True)
            engine.close()
            del engine
    print(f"phase 17 ties: {ties}", flush=True)
    del params, drafts
    torch.cuda.empty_cache()


def timed_mix(engine, requests, warm, resident=None):
    """``warm`` (prompt, new) requests run to completion first (the
    graphs' captures), then ``requests`` through ``ContinuousBatcher``
    timed, with the launch counters set to 0 just before, the batcher
    stepped by hand to track the admitted count; ``resident``, where
    given, is admitted alone first (one scheduler round) and held for
    64 tokens.  The
    launches are held to the timed run's calls, the graphs' captures and
    replays to all of the engine's.  Returns (seconds, completions, the
    timed run's calls, launches, peak admitted)."""
    batcher = port.ContinuousBatcher(engine)
    totals = ladder_calls(engine)
    for p, n in warm:
        batcher.submit(p, max_new_tokens=n)
        batcher.run()
    before = dict(totals)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if resident is not None:
        batcher.submit(resident, max_new_tokens=64)
        batcher.step()
    rids = [batcher.submit(p, max_new_tokens=n, seed=s)
            for p, n, s in requests]
    admitted = 0
    while batcher.queue_depth or batcher.active_slots:
        batcher.step()
        admitted = max(admitted, batcher.active_slots)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    comps = [batcher.completions[r] for r in rids]
    got = launches()
    calls = {k: v - before[k] for k, v in totals.items()}
    check(got == ladder_want(engine, calls),
          f"launches {got}, the calls {ladder_want(engine, calls)}")
    check_graphs(engine, totals, "the timed mix")
    check(all(c.finish_reason in FINISH_REASONS and
              all(0 <= t < VOCAB for t in c.tokens) for c in comps),
          "a completion out of the vocabulary or with no reason")
    for e in (engine, engine.draft):
        if e is not None:
            free, used, total = e.block_accounting()
            check(used == 0 and free == total, f"blocks leaked: {free, used}")
    return wall, comps, calls, got, admitted


def mix_line(wall, comps):
    tokens = sum(len(c.tokens) for c in comps)
    itl = [ms for c in comps for ms in c.inter_token_ms] or [0.0]
    ttft = sorted(c.ttft_s * 1e3 for c in comps)
    return (tokens / wall, ttft[len(ttft) // 2], np.percentile(itl, 50),
            np.percentile(itl, 99),
            f"{tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} tokens/s,"
            f" TTFT p50 {ttft[len(ttft) // 2]:.2f} ms, inter-token p50 "
            f"{np.percentile(itl, 50):.3f} ms p99 "
            f"{np.percentile(itl, 99):.3f} ms")


def phase_ladder_serve():
    """bf16 at the serve widths: the serve mix with the prefill graph and
    eagerly, sampled; bench.py serve --prompt-mix shared-prefix's
    configuration paged-alone and prefix-cached, and with K1 in the
    prefill; bench.py serve --speculative 4's configuration vanilla and
    speculative.  Returns the main path's launches."""
    where = card()
    cfg = cfg_of(torch.bfloat16)
    params = port.init_pipeline_lm_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    counts = {}

    def add(got):
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v

    def mix(rng):
        return [(rng.randint(0, VOCAB, int(rng.randint(1, 65))).tolist(), 128,
                 s) for s in range(16)]

    warm = [([1, 2, 3, 4], 16), ([5, 6, 7, 8], 16)]
    # (a) and (b): the serve mix (phase 3's engines and requests).
    for layout in ("dense", "paged"):
        greedy = None
        for label, kw in (("prefill graph", {}),
                          ("eager prefill", dict(prefill_graph=False)),
                          ("sampled", SAMPLING)):
            engine = port.serve(cfg, params=params, device="cuda",
                                **ENGINES[layout], **kw)
            wall, comps, calls, got, _ = timed_mix(
                engine, mix(np.random.RandomState(0)), warm)
            rate, ttft, p50, p99, line = mix_line(wall, comps)
            print(f"phase 18 (a/b) {layout} {label} bf16 [{where}]: {line};"
                  f" windows {calls['windows']}, prefill calls "
                  f"{calls['prefills']}, chunks {calls['chunks']}, prefill "
                  f"graphs {engine.prefill_captures}/"
                  f"{engine.prefill_replays} "
                  f"({engine.prefill_capture_seconds:.2f} s), launches "
                  f"{ {k: v for k, v in got.items() if v} }", flush=True)
            if label == "prefill graph":
                greedy = (rate, p50, p99)
                add(got)
            if label == "sampled":
                print(f"phase 18 (b) {layout} [{where}]: sampled "
                      f"{rate:.1f} tokens/s, inter-token p50 {p50:.3f} / "
                      f"p99 {p99:.3f} ms beside greedy {greedy[0]:.1f} "
                      f"tokens/s, {greedy[1]:.3f} / {greedy[2]:.3f} ms",
                      flush=True)
            else:
                prof = profile_prefill(engine, np.random.RandomState(1), 8)
                print(f"phase 18 {layout} {label} prefill profile [{where}]: "
                      + ("device time not measured" if prof is None else
                         f"one prefill of 8 prompts {prof[0]:.2f} ms wall, "
                         f"device busy {prof[1]:.2f} ms, {prof[2]:.0f} "
                         f"kernel launches; top: {prof[4]}"), flush=True)
            engine.close()
            del engine
            torch.cuda.empty_cache()
    # (c) and (e): bench.py serve --prompt-mix shared-prefix.
    shared_kw = dict(num_slots=32, max_len=MAX_LEN, prefill_len=512,
                     decode_steps=16, kv_layout="paged", kv_block_len=16,
                     kv_num_blocks=8 * (MAX_LEN // 16))
    rng = np.random.RandomState(0)
    shared = rng.randint(0, VOCAB, 256).tolist()
    requests = [(shared + rng.randint(0, VOCAB, int(rng.randint(
        1, 512 - 256 + 1))).tolist(), int(rng.randint(2, 65)), 0)
        for _ in range(24)]
    rows = {}
    k1 = dataclasses.replace(cfg, attention_fn=port.ops.make_attention_fn(
        True))
    # The bench submits the mix at once: its first admission round fills
    # the pool before any prefix is registered, and the JAX engine peaks
    # at 18 both ways with 48 hit blocks (tests/test_torch_prefix_
    # capacity.py holds the port to it on the CPU).  With the prefix
    # resident first, as a cached system prompt is, caching admits more.
    resident = shared + [1, 2, 3]
    for label, ecfg, caching, first in (
            ("paged alone", cfg, False, None),
            ("prefix cached", cfg, True, None),
            ("prefix cached K1", k1, True, None),
            ("paged alone, prefix resident", cfg, False, resident),
            ("prefix cached, prefix resident", cfg, True, resident)):
        engine = port.serve(ecfg, params=params, device="cuda",
                            prefix_caching=caching, **shared_kw)
        wall, comps, calls, got, peak = timed_mix(
            engine, requests, [([1, 2, 3, 4], 16)], resident=first)
        hits = sum(c.prefix_hit_blocks for c in comps)
        rate, ttft, p50, p99, line = mix_line(wall, comps)
        rows[label] = (peak, ttft, hits)
        print(f"phase 18 (c/e) shared-prefix {label} bf16 [{where}, 32 "
              f"slots, pool {shared_kw['kv_num_blocks']} x 16]: peak admitted"
              f" {peak}, prefix-hit blocks {hits}; {line}; launches "
              f"{ {k: v for k, v in got.items() if v} }", flush=True)
        if caching:
            block_trace_clean(engine._allocator.events)
        if label == "prefix cached K1":
            add(got)
        engine.close()
        del engine
        torch.cuda.empty_cache()
    bench = (rows["paged alone"][0], rows["prefix cached"][0],
             rows["prefix cached"][2])
    check(bench == (18, 18, 48), f"bench order: peaks and hit blocks "
          f"{bench}, the JAX engine's (18, 18, 48)")
    alone, cached = (rows[f"{k}, prefix resident"][0]
                     for k in ("paged alone", "prefix cached"))
    check(cached > alone, f"prefix resident: the prefix-cached run admitted "
          f"{cached}, no more than paged alone's {alone}")
    print(f"phase 18 (e) [{where}]: TTFT p50 with K1 in the prefill "
          f"{rows['prefix cached K1'][1]:.2f} ms against the composed "
          f"prefill's {rows['prefix cached'][1]:.2f} ms", flush=True)
    # (d): bench.py serve --speculative 4.
    draft_cfg = cfg_of(torch.bfloat16, 1)
    draft = port.init_pipeline_lm_params(
        draft_cfg, torch.Generator(device="cuda").manual_seed(1),
        device="cuda")
    rng = np.random.RandomState(0)
    requests = [(rng.randint(0, VOCAB, int(rng.randint(1, 65))).tolist(), 128,
                 0) for _ in range(16)]
    spec_kw = dict(num_slots=8, max_len=MAX_LEN, prefill_len=64,
                   decode_steps=16, kv_layout="paged", kv_block_len=16)
    rates, streams = {}, {}
    for label, kw in (("vanilla", {}),
                      ("speculative", dict(speculative=SPEC_K,
                                           draft_cfg=draft_cfg,
                                           draft_params=draft))):
        engine = port.serve(cfg, params=params, device="cuda", **spec_kw,
                            **kw)
        wall, comps, calls, got, _ = timed_mix(engine, requests,
                                               [([1, 2, 3, 4], 16)])
        rate, ttft, p50, p99, line = mix_line(wall, comps)
        rates[label] = rate
        streams[label] = [c.tokens for c in comps]
        proposed = sum(c.spec_proposed for c in comps)
        accepted = sum(c.spec_accepted for c in comps)
        acc = f", acceptance {accepted / proposed:.4f} ({accepted} of " \
            f"{proposed})" if proposed else ""
        print(f"phase 18 (d) {label} bf16 [{where}, 8 slots, k {SPEC_K}, "
              f"1-layer draft]: {line}{acc}; windows {calls['windows']}, "
              f"proposals {calls['proposals']}, catch-ups "
              f"{calls['catchups']}; launches "
              f"{ {k: v for k, v in got.items() if v} }", flush=True)
        if label == "speculative":
            add(got)
        engine.close()
        del engine
        torch.cuda.empty_cache()
    # In bf16 the verify window (K7 over k + 1 rows) and a decode step
    # (K6) round apart: a stream may part from vanilla only where the
    # recompute's top two logits lie within bf16's tolerance (1e-2 of
    # the top logit), and the comparison ends there.
    parted = []
    for (p, _, _), a, b in zip(requests, streams["vanilla"],
                               streams["speculative"]):
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            check(a == b, "a speculative stream's length differs")
            continue
        logits = sequential_logits(cfg, params, torch.as_tensor(
            [p + a[:i]], device="cuda"))[0, -1]
        top2 = logits.topk(2).values
        gap, bound = float(top2[0] - top2[1]), 1e-2 * max(
            1.0, abs(float(top2[0])))
        check(gap <= bound, f"a speculative stream parts from vanilla at "
              f"token {i} ({b[i]} against {a[i]}), top-2 gap {gap} > {bound}")
        parted.append((i, round(gap, 5)))
    print(f"phase 18 (d) [{where}]: speculative {rates['speculative']:.1f} "
          f"against vanilla {rates['vanilla']:.1f} tokens/s; "
          f"{len(requests) - len(parted)} of {len(requests)} streams equal "
          f"to vanilla's, the rest parting at near ties (token, top-2 gap) "
          f"{parted}", flush=True)
    del params, draft
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------------- #
# phases 19 and 20: the training lifecycle (fit, eval, checkpoints,
# resume, export) and serving the exported artifact
# --------------------------------------------------------------------- #
LIFE_STEPS, LIFE_LOOP, LIFE_EVAL, LIFE_SAVE = 16, 4, 8, 8
LIFE_EVAL_BATCHES = 2


def life_batch(step, seed0=0):
    """Step ``step``'s BERT-base batch (phase 5's shapes, unpadded)."""
    b = bert.synthetic_mlm_batch(seed0 + step, BERT_BATCH, BERT_SEQ,
                                 BERT_MASKED, 30522)
    b.pop("input_mask")
    return b


def life_eval(step):
    return life_batch(step, seed0=10_000)


def life_fit_kw(**kw):
    return dict(dict(steps=LIFE_STEPS, steps_per_loop=LIFE_LOOP,
                     log_every=LIFE_LOOP, eval_every=LIFE_EVAL,
                     eval_source=life_eval, eval_batches=LIFE_EVAL_BATCHES),
                **kw)


def state_leaves(runner):
    """The parameters and optimizer moments, on the host."""
    return {n: t.detach().cpu() for n, t in flatten_with_names(
        {"params": runner.state["params"], "opt": runner.state["opt_state"]})}


def max_diff(a, b):
    return max(float((a[n].float() - b[n].float()).abs().max()) for n in a)


def differing(a, b):
    """``{leaf: elements that differ}`` of two state snapshots."""
    out = {n: int((a[n] != b[n]).sum()) for n in a}
    return {n: k for n, k in out.items() if k}


def held_to(resumed, runs, label):
    """The ``resumed`` runs against the uninterrupted ``runs``: all bit-
    equal.  BERT's step is deterministic on the card (its lookups of
    repeated rows are one-hot products: the backwards of a gather and of
    a two-row embedding add them in no fixed order), so runs of the same
    inputs (two uninterrupted, or the two resumed) must agree too.
    Returns the largest resumed-uninterrupted difference."""
    spread = max(max_diff(a, b) for group in (runs, resumed)
                 for i, a in enumerate(group) for b in group[i + 1:])
    d = max(max_diff(r, u) for r in resumed for u in runs)
    check(spread == 0.0, f"{label}: runs of the same inputs differ by "
          f"{spread}: the step is not deterministic")
    check(d == 0.0, f"{label}: the resumed and uninterrupted runs differ "
          f"by {d} (leaves and elements "
          f"{differing(resumed[0], runs[0])})")
    return d


def life_want(steps, evals):
    """K1 a layer a step and a layer an eval batch (the eval forward);
    K2a and K2b a layer a step."""
    want = dict.fromkeys(KERNELS, 0)
    want.update(dict.fromkeys(TRAINING_KERNELS, 12 * steps))
    want["flash_attention_fwd"] += 12 * evals * LIFE_EVAL_BATCHES
    return want


def phase_lifecycle():
    """BERT-base bf16 (phase 5's configuration) through the lifecycle on
    the graph route: ``fit`` with eval and checkpoints, a resume at step
    8 from the saver against the uninterrupted run, eval against
    ``eval_step`` by hand, blocking and async saves, restore, and the
    loader's per-step loop.  Returns the uninterrupted fit's launches."""
    import shutil

    where = card()
    cfg = bert.bert_base(dropout_rate=0.0, attention_dropout_rate=0.0,
                         attention_fn=fa.make_attention_fn(False))
    opt = port.optim.adamw(1e-4, weight_decay=0.01, mu_dtype=torch.bfloat16)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # (a) the uninterrupted run, checkpoints at 8 and 16.
        runner = bert_runner(cfg, opt)
        saver = port.Saver(os.path.join(root, "a"))
        reset_launches()
        spans = telemetry.reset().spans
        t0 = time.perf_counter()
        hist = port.fit(runner, life_batch, saver=saver,
                        save_every=LIFE_SAVE, **life_fit_kw())
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        span_s = {name: sum(sp["dur_s"] for sp in spans if sp["name"] == name)
                  for name in ("train/eval", "train/checkpoint")}
        got = launches()
        want = life_want(LIFE_STEPS, LIFE_STEPS // LIFE_EVAL)
        check(got == want, f"fit launches {got}, the calls {want}")
        check((runner.captures, runner.replays)
              == (1, LIFE_STEPS // LIFE_LOOP),
              f"fit: {runner.captures} captures, {runner.replays} replays")
        check(saver.all_steps() == [8, 16], f"saves {saver.all_steps()}")
        capture_s = runner.capture_seconds
        check([s for s, _ in hist["eval"]] == [8, 16]
              and [s for s, _ in hist["loss"]] == [4, 8, 12, 16],
              f"cadences: eval {hist['eval']}, loss {hist['loss']}")
        check(all(math.isfinite(v) for _, v in hist["loss"]),
              f"non-finite loss {hist['loss']}")
        uninterrupted = state_leaves(runner)
        # eval against eval_step by hand, at the same state (step 16)
        t0 = time.perf_counter()
        by_hand = [runner.eval_step(life_eval(i))
                   for i in range(LIFE_EVAL_BATCHES)]
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t0) / LIFE_EVAL_BATCHES * 1e3
        ev = hist["eval"][-1][1]
        for k, v in ev.items():
            mean = sum(float(m[k]) for m in by_hand) / LIFE_EVAL_BATCHES
            check(abs(float(v) - mean) <= 1e-6 * max(1.0, abs(mean)),
                  f"eval {k}: fit's {float(v)}, eval_step by hand {mean}")
        # (b) two more uninterrupted runs (no eval, no saves: they change
        # no state), which must agree bit for bit; the second warm after
        # its first window, for the steady fit rate.
        third = bert_runner(cfg, opt)
        port.fit(third, life_batch, steps=LIFE_STEPS,
                 steps_per_loop=LIFE_LOOP, log_every=LIFE_LOOP)
        runs = [uninterrupted, state_leaves(third)]
        third.close()
        del third
        second = bert_runner(cfg, opt)
        port.fit(second, life_batch, steps=LIFE_LOOP,
                 steps_per_loop=LIFE_LOOP, log_every=LIFE_LOOP)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        port.fit(second, life_batch, steps=LIFE_STEPS,
                 steps_per_loop=LIFE_LOOP, log_every=LIFE_LOOP)
        torch.cuda.synchronize()
        warm_fit_s = time.perf_counter() - t0
        runs.append(state_leaves(second))
        window = second.place_steps(port.stack_steps(
            [life_batch(i) for i in range(LIFE_LOOP)]))
        second.run_steps(window)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range((LIFE_STEPS - LIFE_LOOP) // LIFE_LOOP):
            float(second.run_steps(window)["loss"][-1])
        torch.cuda.synchronize()
        bare_s = time.perf_counter() - t0
        second.close()
        del second
        n_ex = (LIFE_STEPS - LIFE_LOOP) * BERT_BATCH
        # (c) the resumed run, twice: a fresh runner and a saver holding
        # step 8.
        resumed_runs = []
        for i, b in enumerate(("b", "b2")):
            shutil.copytree(os.path.join(root, "a", "8"),
                            os.path.join(root, b, "8"))
            resumed = bert_runner(cfg, opt)
            rsaver = port.Saver(os.path.join(root, b))
            reset_launches()
            hist_r = port.fit(resumed, life_batch, saver=rsaver,
                              save_every=LIFE_SAVE, **life_fit_kw())
            torch.cuda.synchronize()
            got_r = launches()
            want_r = life_want(LIFE_STEPS - 8, 1)
            check(got_r == want_r,
                  f"resumed launches {got_r}, the calls {want_r}")
            check((resumed.captures, resumed.replays) == (1, 2),
                  f"resumed: {resumed.captures} captures, "
                  f"{resumed.replays} replays")
            check(rsaver.all_steps() == [8, 16]
                  and resumed.step_count == 16,
                  f"resumed saves {rsaver.all_steps()}")
            check([s for s, _ in hist_r["loss"]] == [12, 16],
                  f"resumed logs {hist_r['loss']}")
            resumed_runs.append(state_leaves(resumed))
            resumed.close()
            del resumed
            shutil.rmtree(os.path.join(root, b))
        resume_diff = held_to(resumed_runs, runs, "the resumed run")
        run_spread = max(max_diff(a, b) for i, a in enumerate(runs)
                         for b in runs[i + 1:])
        resumed_spread = max_diff(*resumed_runs)
        # (d) a blocking save, then an async one followed at once by a
        # window, then a restore into a fresh runner.
        bsaver = port.Saver(os.path.join(root, "c"))
        t0 = time.perf_counter()
        bsaver.save(runner, force=True)
        block_s = time.perf_counter() - t0
        save_bytes = bsaver.last_save_bytes
        shutil.rmtree(os.path.join(root, "c"))
        snapshot = state_leaves(runner)
        asaver = port.Saver(os.path.join(root, "d"), async_save=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        asaver.save(runner)
        stall_s = time.perf_counter() - t0
        runner.run_steps(runner.place_steps(port.stack_steps(
            [life_batch(100 + i) for i in range(LIFE_LOOP)])))
        asaver.wait()
        torch.cuda.synchronize()
        fresh = bert_runner(cfg, opt)
        t0 = time.perf_counter()
        asaver.restore(fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        d = max_diff(state_leaves(fresh), snapshot)
        check(d == 0.0 and fresh.step_count == LIFE_STEPS,
              f"the async snapshot differs by {d} from the state at save "
              f"time (step {fresh.step_count})")
        check(max_diff(state_leaves(runner), snapshot) > 0,
              "the window after the async save changed nothing")
        fresh.close()
        del fresh
        shutil.rmtree(os.path.join(root, "d"))
        # (e) the loader's per-step loop beside step on placed batches.
        host = [life_batch(200 + i) for i in range(8)]
        placed = [runner._place_batch(b) for b in host]
        runner.step(placed[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in placed:
            runner.step(b)
        float(runner.step(placed[0])["loss"])
        step_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for b in port.DataLoader(host, runner.mesh, lowered=runner.lowered,
                                 global_batches=True):
            runner.step(b)
        float(runner.step(placed[0])["loss"])
        loader_s = time.perf_counter() - t0
        runner.close()
        del runner
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 19 BERT-base bf16 fit [{where}]: {LIFE_STEPS} steps in "
          f"windows of {LIFE_LOOP}, eval every {LIFE_EVAL} "
          f"({LIFE_EVAL_BATCHES} batches), saves every {LIFE_SAVE}: "
          f"{fit_s:.3f} s ({hist['examples_per_sec']:.2f} examples/s): the "
          f"capture {capture_s:.3f} s, evals {span_s['train/eval']:.3f} s, "
          f"saves {span_s['train/checkpoint']:.3f} s; warm, no eval or "
          f"save: {n_ex / warm_fit_s:.2f} examples/s "
          f"({warm_fit_s / (LIFE_STEPS - LIFE_LOOP) * 1e3:.2f} ms a step) "
          f"against a bare run_steps window's {n_ex / bare_s:.2f} "
          f"({bare_s / (LIFE_STEPS - LIFE_LOOP) * 1e3:.2f} ms); losses "
          f"{[round(v, 4) for _, v in hist['loss']]}; launches "
          f"{ {k: v for k, v in got.items() if v} }", flush=True)
    print(f"phase 19 resume [{where}]: resumed at step 8, run to "
          f"{LIFE_STEPS}, twice: resumed and uninterrupted runs differ "
          f"by {resume_diff}, held to 0 (three "
          f"uninterrupted runs differ by at most {run_spread}, two "
          f"resumed runs by {resumed_spread}); launches "
          f"{({k: v for k, v in got_r.items() if v})}", flush=True)
    print(f"phase 19 checkpoints [{where}]: blocking save {block_s:.3f} s, "
          f"{save_bytes} bytes ({save_bytes / block_s / 1e9:.3f} GB/s); "
          f"async save stall {stall_s:.3f} s; restore {restore_s:.3f} s; "
          f"eval {eval_ms:.2f} ms a batch; per-step loop over the "
          f"DataLoader {loader_s / 9 * 1e3:.2f} ms a step against step() on "
          f"placed batches {step_s / 9 * 1e3:.2f} ms", flush=True)
    return {name: got[name] for name in TRAINING_KERNELS}


EXPORT_STEPS, EXPORT_BATCH, EXPORT_SEQ = 4, 8, 128


def phase_export_serve():
    """The pipelined LM at the serve widths (bf16) fitted through
    ``Pipeline`` at data 1 x pipe 1 x model 1, exported from the runner
    and reloaded: ``serve(artifact=)``'s greedy streams against
    ``serve(runner=)``'s on the dense and paged + chunked engines (K5,
    K6, K7 held to the calls), the reloaded program's logits against the
    live forward.  Returns the artifact engines' launches."""
    import shutil

    where = card()
    cfg = cfg_of(torch.bfloat16)
    trainable = make_pipeline_lm_trainable(
        cfg, port.optim.sgd(1e-2),
        torch.Generator(device="cuda").manual_seed(0), device="cuda")
    runner = port.AutoDist({"mesh": {"data": 1, "pipe": 1, "model": 1}},
                           Pipeline(num_microbatches=2,
                                    virtual_stages=LAYERS)).build(trainable)

    def source(step):
        x = np.random.RandomState(step).randint(
            0, VOCAB, (EXPORT_BATCH, EXPORT_SEQ + 1))
        return {"x": x[:, :-1].astype(np.int32),
                "y": x[:, 1:].astype(np.int32)}

    hist = port.fit(runner, source, steps=EXPORT_STEPS, steps_per_loop=2,
                    log_every=2)
    check(runner.captures == 1 and runner.replays == EXPORT_STEPS // 2
          and all(math.isfinite(v) for _, v in hist["loss"]),
          f"fit: {runner.captures} captures, {runner.replays} replays, "
          f"losses {hist['loss']}")
    root = tempfile.mkdtemp(prefix="chip_smoke_export_")
    counts = {}
    try:
        path = os.path.join(root, "lm")
        t0 = time.perf_counter()
        port.export_model(path, lambda p, t: sequential_logits(cfg, p, t),
                          None, [np.zeros((1, 64), np.int64)], runner=runner)
        export_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, fs in os.walk(path) for f in fs)
        served = port.load_exported(path, device="cuda")
        toks = torch.as_tensor(np.random.RandomState(7).randint(
            0, VOCAB, (1, 64)), device="cuda")
        got = served(toks).float()
        want = sequential_logits(cfg, runner.get_params(), toks).float()
        err = float((got - want).abs().max())
        bound = 1e-2 * max(1.0, float(want.abs().max()))
        check(got.shape == want.shape and bool(torch.isfinite(got).all())
              and err <= bound, f"the reloaded program's logits differ by "
              f"{err} > {bound} from the live forward")
        rng = np.random.RandomState(3)
        requests = [(rng.randint(0, VOCAB, int(rng.randint(1, 65))).tolist(),
                     64, 0) for _ in range(16)]
        warm = [([1, 2, 3, 4], 16)]
        lines = []
        for layout in ("dense", "paged"):
            rates, streams = {}, {}
            for label, src in (("artifact", dict(artifact=path)),
                               ("runner", dict(runner=runner))):
                engine = port.serve(cfg, device="cuda", **src,
                                    **ENGINES[layout])
                wall, comps, calls, got_l, _ = timed_mix(engine, requests,
                                                         warm)
                rates[label] = mix_line(wall, comps)[0]
                streams[label] = [c.tokens for c in comps]
                if label == "artifact":
                    for k, v in got_l.items():
                        counts[k] = counts.get(k, 0) + v
                engine.close()
                del engine
                torch.cuda.empty_cache()
            check(streams["artifact"] == streams["runner"],
                  f"{layout}: serve(artifact=) and serve(runner=) streams "
                  "differ")
            lines.append(f"{layout} {rates['artifact']:.1f} tokens/s from "
                         f"the artifact, {rates['runner']:.1f} from the "
                         f"runner")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    runner.close()
    del runner
    torch.cuda.empty_cache()
    print(f"phase 20 export and serve bf16 [{where}]: fit {EXPORT_STEPS} "
          f"steps of {EXPORT_BATCH} x {EXPORT_SEQ} (losses "
          f"{[round(v, 4) for _, v in hist['loss']]}); export {export_s:.3f} "
          f"s, {nbytes} bytes; reloaded logits within {err:.5f} of the live "
          f"forward (bound {bound:.4f}); greedy streams equal token for "
          f"token, 16 requests of 64 tokens: {'; '.join(lines)}; launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    return {k: counts.get(k, 0) for k in SERVING_KERNELS}


# --------------------------------------------------------------------- #
# phase 21: comm_overlap="rsag" and narrowed precisions under overlap,
# keyed dropout and stage_aux in the pipeline, tp-2 serving under rsag
# --------------------------------------------------------------------- #
# (a) bench.py quant's window under overlap (phase 7's widths and mesh),
# each program with vocab_parallel; "int8" the bare string of
# bench.py:342, as in phase 7.
OVERLAP_PROGRAMS = {
    "rsag": dict(VOCAB_PARALLEL, comm_overlap="rsag"),
    "rsag int8": dict(VOCAB_PARALLEL, comm_overlap="rsag",
                      collective_precision="int8"),
    "matmul int8": dict(VOCAB_PARALLEL, comm_overlap="matmul",
                        collective_precision="int8",
                        kernel=("collective_matmul",)),
    "rsag vocab_stats bf16": dict(VOCAB_PARALLEL, comm_overlap="rsag",
                                  collective_precision={
                                      "vocab_stats": "bf16"}),
}
OVERLAP_QUANT = ("rsag", "matmul int8")
OVERLAP_STEPS = 1
# Their fp32 parity at 2 layers, model 2, by phase 15's rule
# (:func:`held_rows`): the plain (blocking) program under Adam, and the
# same under SGD and at a learning rate of 0; "rsag" held to the first
# at 1e-5 per tensor and loss, the narrowed programs (SGD) to the
# second within their wire's allowance a tensor, the no-update row
# rejected by both rules.  A narrowed tp_psum or vocab_stats wire
# rounds the forward on a model axis.
OVERLAP_PARITY = [
    ("plain", {}, 1, None),
    (LINEAR, {}, 1, LINEAR),
    (NO_UPDATE, {}, 1, NO_UPDATE),
    ("rsag", dict(comm_overlap="rsag"), 1, None),
    ("rsag int8", dict(comm_overlap="rsag",
                       collective_precision={"tp_psum": "int8"}), 1,
     INT8_FWD),
    ("matmul int8", dict(comm_overlap="matmul",
                         collective_precision={"tp_psum": "int8"},
                         kernel=("collective_matmul",)), 1, INT8_FWD),
    ("rsag vocab_stats bf16", dict(comm_overlap="rsag",
                                   collective_precision={
                                       "vocab_stats": "bf16"}), 1, BF16_FWD),
]
# (b) the pipelined LM with dropout 0.1 at full width cut to 2 layers,
# fp32, seq 128, batch 8, 2 SGD steps at the seeds below.
DROP_SEEDS, DROP_LR = (11, 12), 0.05


def overlap_window_programs(job):
    """Phase 21 (a)'s window in one rank: per program a warm step and a
    timed window of OVERLAP_STEPS, K3 and K4 held to the calls."""
    out = {}
    layers = job["layers"] // job["mesh"].get("pipe", 1)
    for program in job["programs"]:
        torch.cuda.reset_peak_memory_stats()
        runner = tp_runner(job, program, job["mesh"])
        pipe = runner.lowered.mesh.axis("pipe").index
        window = runner.place_steps(tp_window(job, OVERLAP_STEPS))
        dt, metrics = timed_window(runner, window)
        check_route(runner, job, program)
        got = {name: launches()[name] for name in TP_KERNELS}
        losses = metrics["loss"].float()
        check(bool(torch.isfinite(losses).all()),
              f"{program}: non-finite loss {losses}")
        want = dict.fromkeys(TP_KERNELS, 0)
        if program.startswith("matmul"):
            want.update({k: n * OVERLAP_STEPS for k, n in tp_want(
                "collective_matmul", layers, pipe == 0).items()})
        check(got == want, f"{program} on {job['mesh']}: launches {got}, "
                           f"expected {want}")
        out[program] = {"seconds": dt, "launches": got, "pipe": pipe,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "loss": [float(losses[0]), float(losses[-1])]}
        runner.close()
        del runner, window
        torch.cuda.empty_cache()
    return out


def dropout_lm(seq):
    """Phase 21 (b)'s model: the pipelined LM at full width, 2 layers,
    dropout and attention dropout 0.1, fp32, SGD; weights from seed 0."""
    cfg = port.TransformerConfig(
        vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=2, num_heads=HEADS,
        mlp_dim=MLP, max_len=seq, dtype=torch.float32, dropout_rate=0.1,
        attention_dropout_rate=0.1)
    return make_pipeline_lm_trainable(
        cfg, port.optim.sgd(DROP_LR),
        torch.Generator(device="cuda").manual_seed(0))


def dropout_sequential(job):
    """The sequential program (``PipelineTrainable.loss``, both stages in
    order in one process) over phase 21 (b)'s batches: SGD steps; the
    final params."""
    tr = dropout_lm(job["seq"])
    params = dict(flatten_with_names(tr.params))
    window = tp_window(job, len(DROP_SEEDS), seed0=200)
    for i, seed in enumerate(DROP_SEEDS):
        batch = {k: torch.as_tensor(v[i], device="cuda")
                 for k, v in window.items()}
        leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
        loss, _, _ = tr.loss(unflatten(leaves), None,
                             batch, seed)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        params = {n: (p - DROP_LR * g).detach()
                  for (n, p), g in zip(leaves.items(), grads)}
    return params


def pipeline_dropout(job):
    """Phase 21 (b) in one rank of a pipe axis of 2: M = 2 and M = 4,
    2 steps each at the same seeds; the params' distance from the
    sequential program's (computed on rank 0) and between the two M;
    the train loss and two evals under different seeds."""
    window = tp_window(job, len(DROP_SEEDS), seed0=200)
    out, got = {}, {}
    for m in (2, 4):
        runner = port.AutoDist({"mesh": job["mesh"]}, Pipeline(
            num_microbatches=m, virtual_stages=1)).build(
                dropout_lm(job["seq"]))
        metrics = runner.run_steps(window, rngs=list(DROP_SEEDS))
        got[m] = runner.get_params()
        if m == 2:
            first = {k: v[0] for k, v in window.items()}
            out["train_loss"] = float(metrics["loss"][-1])
            out["evals"] = [float(runner.eval_step(first, rng=s)["loss"])
                            for s in (1, 2)]
        runner.close()
        del runner
    if torch.distributed.get_rank() == 0:
        ref = dropout_sequential(job)
        out["err"] = {m: rel_err(got[m], ref) for m in got}
        out["m2_m4"] = rel_err(got[4], got[2])
    return out


def tp_serve_rsag(job):
    """Phase 21 (d) in one rank of the tensor-parallel group: the fp32
    streams of phase 10's prompts on the dense and paged + chunked
    engines, blocking and under ``comm_overlap="rsag"``, then the bf16
    serve mix on the rsag engines (``tp_serve_mix``: K5-K7 held to the
    calls)."""
    out = {"streams": {}, "mix": {}}
    for dtype, seed in ((torch.float32, 1), (torch.bfloat16, 0)):
        cfg = cfg_of(dtype, job["layers"])
        params = port.init_pipeline_lm_params(
            cfg, torch.Generator(device="cuda").manual_seed(seed),
            device="cuda")
        for layout in ENGINES:
            modes = (None, "rsag") if dtype == torch.float32 else ("rsag",)
            for mode in modes:
                torch.cuda.reset_peak_memory_stats()
                engine = port.serve(cfg, params=params, device="cuda",
                                    tensor_parallel=TP, vocab_parallel=True,
                                    comm_overlap=mode, **ENGINES[layout])
                if dtype == torch.float32:
                    batcher = port.ContinuousBatcher(engine)
                    rids = [batcher.submit(p, max_new_tokens=SERVE_TP_NEW)
                            for p in job["prompts"][layout]]
                    done = batcher.run()
                    out["streams"][f"{layout} {mode}"] = [
                        done[r].tokens for r in rids]
                else:
                    out["mix"][layout] = tp_serve_mix(
                        engine, job["layers"], job["backend"],
                        f"{layout} rsag on {job['backend']}")
                engine.close()
                del engine
        del params
        torch.cuda.empty_cache()
    return out


def stage_aux_check(label):
    """Phase 21 (c): a stage with an aux loss on dict activations (4
    stages of ``relu(h @ w)``, the aux the mean of h^2) through
    ``Pipeline(num_microbatches=2)`` at pipe 1 (V = 4) on the card, one
    SGD step against the sequential loss's gradient step (1e-5)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    hid = 256
    w = torch.randn(4, hid, hid, generator=gen, device="cuda") / hid ** 0.5

    def stage(p, act):
        h = torch.relu(act["h"] @ p["w"])
        return {"h": h, "scale": act["scale"]}, (h ** 2).mean()

    def head(outputs, batch):
        return ((outputs["h"] * outputs["scale"] - batch["y"]) ** 2).mean(), {}

    batch = {"x": {"h": torch.randn(16, hid, generator=gen, device="cuda"),
                   "scale": torch.ones(16, 1, device="cuda")},
             "y": torch.randn(16, hid, generator=gen, device="cuda")}
    tr = port.PipelineTrainable(stage, {"w": w}, head, port.optim.sgd(0.05),
                                num_stages=4, stage_aux=True)
    leaf = w.clone().requires_grad_()
    loss, _, m = tr.loss({"w": leaf}, None, batch, None)
    want = (w - 0.05 * torch.autograd.grad(loss, leaf)[0]).detach()
    lowered = port.AutoDist({"mesh": {"pipe": 1}}, Pipeline(
        num_microbatches=2, virtual_stages=4)).lower(tr)
    state, metrics = lowered.step_fn(lowered.init_state(tr), batch, 0)
    got = lowered.full_params(state["params"])["w"]
    err = float((got - want).abs().max() / want.abs().max())
    loss = loss.detach()
    check(err <= 1e-5 and abs(float(metrics["loss"]) - float(loss))
          <= 1e-5 * abs(float(loss)) and abs(float(metrics["aux_loss"])
                                             - float(m["aux_loss"]))
          <= 1e-5 * abs(float(m["aux_loss"])),
          f"stage_aux: loss {float(metrics['loss'])} vs sequential "
          f"{float(loss)}, aux {float(metrics['aux_loss'])} vs "
          f"{float(m['aux_loss'])}, params {err:.3g} relative")
    print(f"phase 21 (c) stage_aux on dict activations [{label}]: 4 stages "
          f"of relu(h @ w) at hidden {hid}, M = 2, V = 4: loss "
          f"{float(metrics['loss']):.6f} (sequential {float(loss):.6f}), "
          f"aux {float(metrics['aux_loss']):.6f} (sequential "
          f"{float(m['aux_loss']):.6f}), params after one SGD step "
          f"{err:.3g} relative from the sequential step's", flush=True)


def dropout_graph_route(label):
    """Phase 21 (b) on the graph route: the dropout LM at pipe 1 (V = 2)
    in one process, a ``run_steps`` window of 2 steps (one CUDA graph
    whose keyed masks read each step's seed from its ``GraphSeed``'s
    static buffer, no generator) against a loop of ``step`` calls at the
    same seeds: the params within 1e-5."""
    job = {"seq": 128, "batch": 8}
    window = tp_window(job, 2, seed0=300)
    got = []
    for route in ("graph", "loop"):
        runner = port.AutoDist({"mesh": {"pipe": 1}}, Pipeline(
            num_microbatches=2, virtual_stages=2)).build(
                dropout_lm(job["seq"]))
        if route == "graph":
            check(runner.lowered.capturable, "pipe 1 is not capturable")
            runner.run_steps(window, rngs=[21, 22])
            check(runner.captures == runner.replays == 1,
                  f"dropout window: {runner.captures} captures, "
                  f"{runner.replays} replays")
        else:
            for i, seed in enumerate((21, 22)):
                runner.step({k: v[i] for k, v in window.items()}, rng=seed)
        got.append(runner.get_params())
        runner.close()
        del runner
    err = rel_err(got[0], got[1])
    check(err <= 1e-5, f"dropout graph route: params {err:.3g} from the "
                       f"step loop's")
    print(f"phase 21 (b) keyed dropout on the graph route [{label}]: one "
          f"capture, one replay of 2 steps at seeds 21, 22; params "
          f"{err:.3g} relative from a loop of step calls", flush=True)
    torch.cuda.empty_cache()


def phase_overlap():
    """Phase 21: (a) the overlap programs' fp32 parity at model 2 and
    bench.py quant's bf16 window under them at model 2 and pipe 2 x
    model 2; (b) the pipelined LM with keyed dropout at pipe 2 against
    its sequential program, and on the graph route; (c) stage_aux;
    (d) the tp-2 engines under rsag.  Ranks share card 0 over gloo."""
    label = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parity = {"kind": "zero_pipe_parity", "layers": 2, "seq": 128,
              "batch": 8, "dtype": torch.float32, "opt": (1e-3, 1e-4),
              "mesh": TP_MESH, "layout": VOCAB_PARALLEL,
              "programs": OVERLAP_PARITY}
    drop = {"kind": "dropout", "seq": 128, "batch": 8,
            "mesh": {"data": 1, "pipe": PIPE}}
    serve = {"kind": "serve_rsag", "layers": SERVE_TP_LAYERS,
             "prompts": tp_serve_prompts(np.random.RandomState(1))}
    t0 = time.perf_counter()

    def meanwhile():
        # The graph route and stage_aux in this process, beside the
        # spawned parity jobs (nothing here is timed).
        dropout_graph_route(label)
        stage_aux_check(label)

    (par, dro, srv) = spawn_together([(parity, TP), (drop, PIPE),
                                      (serve, TP)], meanwhile)
    print(f"phase 21 parity, dropout, stage_aux and serve jobs took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    where = f"phase 21 (a) {mesh_label(TP_MESH)}, vocab_parallel"
    faults = [f for r in par for f in held_rows(where, r, OVERLAP_PARITY)]
    check(not faults, "; ".join(faults))
    got = par[0]
    plain, fault = got["plain"], got[NO_UPDATE]
    for wire in (INT8_FWD, BF16_FWD):
        # The narrowed rule itself, in this run, on a program that never
        # moves.
        check(held("no update", fault, got[LINEAR], wire, fault),
              f"phase 21 (a): a run with no update passes the {wire} rule")

    def reading(label, wire):
        res = got[label]
        if wire is None:
            gap = max(abs(a - b) / abs(b)
                      for a, b in zip(res["loss"], plain["loss"]))
            return (f"{label} (Adam) losses {res['loss']}, {gap:.3g} of "
                    f"blocking's, params {res['err']:.3g} ({res['worst']}); "
                    f"bound 1e-5 each")
        unit, forward = wire
        bounds = [unit * k * abs(b - c) if k
                  else (FWD_LOSS0 if forward else 1e-6) * abs(b)
                  for k, (b, c) in enumerate(zip(got[LINEAR]["loss"],
                                                 fault["loss"]))]
        gaps = [abs(a - b) for a, b in zip(res["loss"],
                                           got[LINEAR]["loss"])]
        return (f"{label} (SGD) losses {res['loss']}, apart from the SGD "
                f"reference's by " + ", ".join(
                    f"{g:.3g} (bound {d:.3g})" for g, d in zip(gaps, bounds))
                + f"; params {res['moved']:.3e} of the update "
                f"({res['moved_worst']}), {res['over']:.3g} of the allowance "
                f"({res['over_worst']}; bound 1)")

    print(f"phase 21 (a) fp32 2-layer pipelined LM, seq 128, batch 8, "
          f"vocab_parallel, model 2 (2 ranks on one card over gloo), "
          f"{ZERO_PARITY_STEPS} steps (Adam lr 1e-3, eps 1e-4; the narrowed "
          f"programs SGD at {LINEAR_LR}) [{label}]: blocking losses "
          f"{plain['loss']}, SGD {got[LINEAR]['loss']}; " + "; ".join(
              reading(lb, wire) for lb, _, _, wire in OVERLAP_PARITY
              if lb not in ("plain", LINEAR, NO_UPDATE))
          + f"; no update: losses {fault['loss']}, params "
          f"{fault['err']:.3g} from blocking's, rejected by the exact and "
          f"both narrowed rules", flush=True)
    r0 = dro[0]
    check(max(r0["err"].values()) <= 1e-5 and r0["m2_m4"] <= 1e-5,
          f"pipelined dropout vs sequential {r0['err']}, M = 2 vs 4 "
          f"{r0['m2_m4']}")
    e1, e2 = r0["evals"]
    check(e1 == e2 and abs(e1 - r0["train_loss"]) > 1e-4,
          f"evals {e1}, {e2} under two seeds; train loss {r0['train_loss']}")
    print(f"phase 21 (b) fp32 2-layer pipelined LM, dropout 0.1, pipe 2 "
          f"(2 ranks over gloo), 2 SGD steps [{label}]: params against the "
          f"sequential program {r0['err']} relative by M, M = 2 vs 4 "
          f"{r0['m2_m4']:.3g}; train loss {r0['train_loss']:.6f}, eval "
          f"{e1:.6f} under seeds 1 and 2 alike", flush=True)
    counts = {}
    s0 = srv[0]
    for r in srv[1:]:
        check(r["streams"] == s0["streams"], "rsag serve: ranks differ")
    for layout in ENGINES:
        check(s0["streams"][f"{layout} rsag"] == s0["streams"][
            f"{layout} None"], f"{layout}: rsag streams differ from the "
                               f"blocking engine's")
        m = s0["mix"][layout]
        for name, n in m["launches"].items():
            counts[name] = counts.get(name, 0) + n
        print(f"phase 21 (d) {layout} tp 2 rsag [{label}, 2 ranks on one "
              f"card over gloo]: fp32 streams equal to the blocking "
              f"engine's token for token; bf16 serve mix {m['tokens']} "
              f"tokens in {m['wall']:.3f} s = {m['tokens'] / m['wall']:.1f} "
              f"tokens/s, TTFT p50 {m['ttft_p50']:.2f} ms, launches "
              f"{ {k: v for k, v in m['launches'].items() if v} }",
              flush=True)
    job = {"kind": "overlap_window", "layers": TP_LAYERS, "seq": TP_SEQ,
           "batch": TP_BATCH, "dtype": torch.bfloat16}
    tokens = OVERLAP_STEPS * TP_BATCH * TP_SEQ
    for mesh, progs in ((TP_MESH, list(OVERLAP_PROGRAMS)),
                        (QUANT_MESH, list(OVERLAP_QUANT))):
        world = math.prod(mesh.values())
        ranks = spawn_ranks(dict(job, mesh=mesh, programs=progs), world)
        where = f"{mesh_label(mesh)}, {world} ranks on one card, gloo"
        for program in progs:
            dt = max(r[program]["seconds"] for r in ranks)
            r0 = ranks[0][program]
            blocking = WINDOW_TIMES.get(("gloo", mesh_label(mesh), "fp32"))
            beside = ("phase 7's blocking fp32 not run" if blocking is None
                      else f"phase 7's blocking fp32 {blocking[0]:.2f} ms, "
                           f"{blocking[1]:.1f} tokens/s")
            print(f"phase 21 (a) {program} bf16 [{where}, {label}]: "
                  f"{OVERLAP_STEPS} steps in {dt:.3f} s (slowest rank) = "
                  f"{tokens / dt:.1f} tokens/s, step "
                  f"{dt / OVERLAP_STEPS * 1e3:.2f} ms ({beside}), peak "
                  f"memory per rank " + ", ".join(
                      f"{r[program]['peak_gb']:.2f}" for r in ranks)
                  + f" GB, loss {r0['loss'][0]:.4f} -> {r0['loss'][1]:.4f}, "
                  f"K4 launches per step and rank "
                  f"{r0['launches']['collective_matmul_hop'] / OVERLAP_STEPS}",
                  flush=True)
            for name, n in r0["launches"].items():
                counts[name] = counts.get(name, 0) + n
    return counts


# --------------------------------------------------------------------- #
# phase 22: the GSPMD builders on DTensor
# --------------------------------------------------------------------- #
GSPMD_STEPS = 10
GSPMD_BUILDERS = ("TensorParallel", "FSDPSharded")


def gspmd_runner(cfg, opt, name, mesh):
    """BERT MLM through ``AutoDist({"mesh": mesh}, <name>())`` on the
    ``gspmd`` lowering; weights from seed 0 on the card (every rank
    alike)."""
    trainable = bert.make_mlm_trainable(
        cfg, opt, torch.Generator(device="cuda").manual_seed(0),
        with_input_mask=False)
    return port.AutoDist({"mesh": mesh},
                         getattr(port, name)()).build(trainable)


def gspmd_parity_cfg():
    return port.TransformerConfig(
        num_layers=2, dtype=torch.float32, dropout_rate=0.0,
        attention_dropout_rate=0.0, attention_fn=fa.make_attention_fn(False))


def gspmd_parity(mesh):
    """Phase 22's fp32 runs at ``mesh``: each builder's full params (on
    the CPU) after 3 SGD steps at 2 layers."""
    cfg = gspmd_parity_cfg()
    window = bert_window(cfg, 3, seed0=500)
    got = {}
    for name in GSPMD_BUILDERS:
        runner = gspmd_runner(cfg, port.optim.sgd(0.5), name, mesh)
        runner.run_steps(window)
        got[name] = {n: t.cpu() for n, t in
                     flatten_with_names(runner.get_params())}
        runner.close()
        del runner
    torch.cuda.empty_cache()
    return got


def gspmd_window(mesh, name):
    """Phase 22's bf16 window in this rank: BERT-base through ``name``
    at ``mesh``, GSPMD_STEPS timed steps; K1/K2a/K2b held to the layers'
    calls, the graph route's captures and replays where the lowering is
    capturable; then one ``step`` under ``CommDebugMode``.  Returns the
    seconds, losses, launches, graphs, collectives and peak GB."""
    from torch.distributed.tensor.debug import CommDebugMode

    opt = port.optim.adamw(1e-4, weight_decay=0.01, mu_dtype=torch.bfloat16)
    cfg = bert.bert_base(dropout_rate=0.0, attention_dropout_rate=0.0,
                         attention_fn=fa.make_attention_fn(False))
    runner = gspmd_runner(cfg, opt, name, mesh)
    window = runner.place_steps(bert_window(cfg, GSPMD_STEPS))
    capturable = runner.lowered.capturable
    dt, metrics = timed_window(runner, window)
    got = launches()
    losses = metrics["loss"].float()
    where = f"gspmd {name} at {mesh}"
    check(bool(torch.isfinite(losses).all()),
          f"{where}: non-finite loss {losses}")
    want = dict.fromkeys(KERNELS, 0)
    want.update(dict.fromkeys(TRAINING_KERNELS, cfg.num_layers * GSPMD_STEPS))
    check(got == want, f"{where}: launches {got}, expected {want}")
    graphs = (1, 2) if capturable else (0, 0)
    check((runner.captures, runner.replays) == graphs,
          f"{where}: {runner.captures} captures, {runner.replays} replays, "
          f"expected {graphs}")
    first = {k: v[0] for k, v in window.items()}
    with CommDebugMode() as comm:
        runner.step(type(window)(first))
    torch.cuda.synchronize()
    out = {"seconds": dt, "loss": [float(losses[0]), float(losses[-1])],
           "launches": got, "graphs": [runner.captures, runner.replays],
           "route": "graph" if capturable else "loop",
           "collectives": {str(op).split(".")[-1]: n
                           for op, n in comm.get_comm_counts().items()},
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    runner.close()
    del runner, window
    torch.cuda.empty_cache()
    return out


def gspmd_ranks(job):
    """Phase 22 in one rank of an NCCL job, one card a rank: the fp32
    runs (rank 0 saves the params to ``job["digest"]``), then each
    builder's bf16 window."""
    got = gspmd_parity(job["mesh"])
    if torch.distributed.get_rank() == 0:
        torch.save(got, os.path.join(job["digest"], "params.pt"))
    del got
    return {name: gspmd_window(job["mesh"], name) for name in GSPMD_BUILDERS}


def gspmd_held(got, ref, where, label):
    """Each builder's params against ``AllReduce``'s (2e-5 relative,
    2e-6 absolute); prints the largest distance."""
    for name in GSPMD_BUILDERS:
        bad = [n for n, p in got[name].items()
               if not torch.allclose(p, ref[n], rtol=2e-5, atol=2e-6)]
        check(not bad, f"gspmd {name} at {where}: params {bad[:3]} off "
                       f"AllReduce's")
    worst = max(float(((p - ref[n]).abs() / (2e-6 + 2e-5 * ref[n].abs()))
                      .max()) for g in got.values() for n, p in g.items())
    print(f"phase 22 fp32 2-layer BERT, flash, 3 SGD steps, {where} "
          f"[{label}]: TensorParallel and FSDPSharded params within 2e-5 / "
          f"2e-6 of AllReduce's on one card (largest |a - b| "
          f"{worst:.3g} of its allowance)", flush=True)


def gspmd_line(name, mesh, recs, where):
    """One bf16 window's line: the slowest rank's seconds."""
    cfg = bert.bert_base()
    flops = bert.mlm_model_flops_per_example(cfg, BERT_SEQ, BERT_MASKED)
    dt = max(r["seconds"] for r in recs)
    r0 = recs[0]
    rate = GSPMD_STEPS * BERT_BATCH / dt
    ref = WINDOW_TIMES.get(("bert", "flash", "graph"))
    beside = ("phase 5's AllReduce(256) not run" if ref is None else
              f"phase 5's AllReduce(256) {ref[0]:.2f} ms, "
              f"{ref[1]:.2f} examples/s")
    return (f"phase 22 {name} BERT-base bf16, gspmd on DTensor, "
            f"{mesh_label(mesh) or 'data 1 x model 1'} [{where}, route "
            f"{r0['route']}]: {GSPMD_STEPS} steps of {BERT_BATCH} in "
            f"{dt:.3f} s (slowest rank) = {rate:.2f} examples/s, step "
            f"{dt / GSPMD_STEPS * 1e3:.2f} ms ({beside}), MFU "
            f"{rate * flops / (H100.peak_bf16_tflops * 1e12 * len(recs)):.4f}"
            f", peak memory per rank "
            + ", ".join(f"{r['peak_gb']:.2f}" for r in recs)
            + f" GB, captures {r0['graphs'][0]} replays {r0['graphs'][1]}, "
            f"loss {r0['loss'][0]:.4f} -> {r0['loss'][1]:.4f}, launches a "
            f"rank { {k: v for k, v in r0['launches'].items() if v} }, "
            f"collectives a step and rank {r0['collectives'] or 'none'}")


def phase_gspmd():
    """Phase 22: BERT-base MLM (phase 5's configuration, flash) through
    ``TensorParallel()`` and ``FSDPSharded()`` on the ``gspmd`` lowering.
    The route is chosen by the device count: on one card a gloo group of
    several ranks does not carry DTensor's all-gathers (PERF.md), so the
    card runs the lowering, DTensor's dispatch, ``local_map`` and K1/K2
    in one process at data 1 x model 1; where there are 2 or more cards
    the same runs again over NCCL, one rank a card, at data 2 x model 2
    (4 cards or more) or model 2 (2 or 3).  Each mesh: fp32 parity at 2
    layers against ``AllReduce`` on one card (params after 3 SGD steps,
    2e-5 relative / 2e-6 absolute), then the bf16 window: step ms and
    examples/s beside phase 5's, K1/K2a/K2b held to the calls, the graph
    route's captures and replays, and the collectives a step issued
    (DTensor's ``CommDebugMode``)."""
    label = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gspmd_parity_cfg()
    runner = bert_runner(cfg, port.optim.sgd(0.5))
    runner.run_steps(bert_window(cfg, 3, seed0=500))
    ref = {n: t.cpu() for n, t in flatten_with_names(runner.get_params())}
    runner.close()
    del runner
    one = {"data": 1, "model": 1}
    gspmd_held(gspmd_parity(one), ref, "data 1 x model 1, one process",
               label)
    counts = {}
    for name in GSPMD_BUILDERS:
        rec = gspmd_window(one, name)
        for k, n in rec["launches"].items():
            counts[k] = counts.get(k, 0) + n
        print(gspmd_line(name, one, [rec], label), flush=True)
    cards = torch.cuda.device_count()
    if cards >= 2:
        mesh = {"data": 2, "model": 2} if cards >= 4 else {"data": 1,
                                                           "model": 2}
        world = math.prod(mesh.values())
        with tempfile.TemporaryDirectory() as digest:
            ranks = spawn_ranks({"kind": "gspmd", "mesh": mesh,
                                 "digest": digest}, world, "nccl")
            got = torch.load(os.path.join(digest, "params.pt"))
        where = f"{mesh_label(mesh)}, {world} cards, NCCL"
        gspmd_held(got, ref, where, label)
        for name in GSPMD_BUILDERS:
            print(gspmd_line(name, mesh, [r[name] for r in ranks],
                             f"{label}, {where}"), flush=True)
    return counts


# --------------------------------------------------------------------- #
# phase 23: asynchronous PS and the SSP gate
# --------------------------------------------------------------------- #
ASYNC_STEPS = 3          # pushes a process in (a) and (b)
SSP_STEPS = 5            # steps 0 (warm) to 4 of (c)
SSP_SLEEP_S = 0.3        # the slow worker's sleep before each step
ASYNC_SPANS = ("pull", "pack", "push", "apply", "publish")
ASYNC_COUNTERS = ("push", "pull", "pull_skip", "apply", "publish")


def async_bert(cfg, opt):
    """Phase 23's BERT MLM trainable, weights from seed 0 on the card."""
    return bert.make_mlm_trainable(
        cfg, opt, torch.Generator(device="cuda").manual_seed(0),
        with_input_mask=False)


def async_bf16():
    """(b)'s configuration: phase 5's, flash."""
    return (bert.bert_base(dropout_rate=0.0, attention_dropout_rate=0.0,
                           attention_fn=fa.make_attention_fn(False)),
            port.optim.adamw(1e-4, weight_decay=0.01,
                             mu_dtype=torch.bfloat16))


def async_counters():
    return {k: telemetry.counter(f"asyncps/{k}").value
            for k in ASYNC_COUNTERS}


def async_parity(label):
    """(a): one ``AsyncPSRunner`` worker through ``AutoDist({},
    PS(sync=False))``, ``wait_applied`` after each of 3 SGD steps,
    against the synchronous ``PS()`` ``DistributedRunner`` on the same
    weights and batches (fp32, 2 layers, flash, dropout 0)."""
    cfg = gspmd_parity_cfg()
    steps = window_steps(bert_window(cfg, ASYNC_STEPS, seed0=600))
    sync = port.AutoDist({}, port.PS()).build(
        async_bert(cfg, port.optim.sgd(0.5)))
    for b in steps:
        sync.step(b)
    ref = {n: t.cpu() for n, t in flatten_with_names(sync.get_params())}
    sync.close()
    runner = port.AutoDist({}, port.PS(sync=False)).build(
        async_bert(cfg, port.optim.sgd(0.5)))
    check(isinstance(runner, port.AsyncPSRunner),
          f"PS(sync=False) built a {type(runner).__name__}")
    try:
        for i, b in enumerate(steps):
            runner.step(b)
            runner.wait_applied(i + 1, timeout_s=120)
        got = {n: t.cpu() for n, t in flatten_with_names(runner.get_params())}
    finally:
        runner.close()
    worst = rel_err(got, ref)
    check(worst <= 1e-5, f"phase 23 (a): async params {worst:.3g} of a "
                         f"tensor's largest value off the synchronous PS's")
    print(f"phase 23 (a) fp32 2-layer BERT, flash, {ASYNC_STEPS} SGD steps "
          f"[{label}]: AsyncPSRunner (one worker, wait_applied after each "
          f"step) params within 1e-5 of the synchronous PS() runner's "
          f"(largest gap {worst:.3g} of each tensor's largest value, floor "
          f"1e-3)", flush=True)
    torch.cuda.empty_cache()


def async_worker(job):
    """Phase 23's second process: (b)'s worker (``AUTODIST_TPU_WORKER``
    and the chief's service in its environment, ASYNC_STEPS pushes; its
    launch counts, losses, step seconds and counters go back through
    the coordination KV), then (c)'s slow SSP worker."""
    from autodist_tpu_torch.runtime import coordination

    os.environ.update(job["env"])
    coordination.reset_service_client()
    cfg, opt = async_bf16()
    runner = port.AutoDist({}, port.PS(sync=False)).build(
        async_bert(cfg, opt))
    check(not runner.is_chief, "the spawned async worker thinks it is "
                               "the chief")
    steps = window_steps(bert_window(cfg, ASYNC_STEPS, seed0=800))
    before = async_counters()
    reset_launches()
    losses, seconds = [], []
    for b in steps:
        t0 = time.perf_counter()
        losses.append(float(runner.step(b)["loss"]))
        seconds.append(time.perf_counter() - t0)
    out = {"launches": launches(), "losses": losses, "step_s": seconds,
           "counters": {k: v - before[k]
                        for k, v in async_counters().items()}}
    runner._client.put("phase23/worker", json.dumps(out).encode())
    runner.close()
    del runner, steps
    torch.cuda.empty_cache()
    return ssp_role(job["ssp_env"], "slow")


def span_seconds(name, since):
    """The durations of the spans ``name`` recorded after ``since``."""
    return [s["dur_s"] for s in telemetry.get().spans
            if s["name"] == name and s["start_s"] >= since]


def ssp_cfg(dropout=0.0):
    return port.TransformerConfig(
        num_layers=2, dropout_rate=dropout, attention_dropout_rate=0.0,
        attention_fn=fa.make_attention_fn(False))


def ssp_role(env, name):
    """(c) in one process: a 2-layer bf16 ``DistributedRunner`` under
    ``PS(staleness=1)`` on the service in ``env``, gated (asserted),
    step 0, then the processes' barrier, then steps 1-4 (the slow one
    sleeping SSP_SLEEP_S before each); each step's completion after the
    barrier, and the gate's waits."""
    from autodist_tpu_torch.runtime import coordination

    os.environ.update(env)
    coordination.reset_service_client()
    cfg = ssp_cfg()
    runner = port.AutoDist({}, port.PS(staleness=1)).build(
        async_bert(cfg, port.optim.sgd(0.1)), ssp_worker=name,
        ssp_num_workers=2)
    check(runner._ssp is not None, f"{name}: the SSP gate is off")
    steps = window_steps(runner.place_steps(bert_window(cfg, SSP_STEPS)))
    waits = len(telemetry.histogram("ssp/gate_wait_s").values)
    runner.step(steps[0])       # the gate cannot block step 0
    check(coordination.service_client().barrier("phase23/ready", 2, 120000),
          "the SSP workers never met")
    t0 = time.monotonic()
    done = {}
    for i in range(1, SSP_STEPS):
        if name == "slow":
            time.sleep(SSP_SLEEP_S)
        runner.step(steps[i])
        done[i] = time.monotonic() - t0
    out = {"done": done, "captures": runner.captures,
           "waits": list(telemetry.histogram("ssp/gate_wait_s")
                         .values)[waits:]}
    runner.close()
    os.environ.pop("AUTODIST_TPU_COORD_SERVICE", None)
    coordination.reset_service_client()
    return out


def async_window(label):
    """(b) and (c)'s timing, with one spawned process.  (b): BERT-base
    bf16 (phase 5's configuration) on the async path; the chief (this
    process: the PS thread and one worker) and the spawned worker share
    card 0, ASYNC_STEPS pushes each; all updates applied, losses
    finite, K1/K2a/K2b held to 12 x the steps of both processes.  (c):
    then this process is the fast SSP worker and the spawned one the
    slow.  Returns (b)'s launches."""
    from autodist_tpu_torch.runtime import coordination

    ssp_server = coordination.CoordServer()
    ssp_env = {"AUTODIST_TPU_COORD_SERVICE": f"127.0.0.1:{ssp_server.port}",
               "AUTODIST_TPU_COORD_TOKEN": ssp_server.token}
    cfg, opt = async_bf16()
    runner = port.AutoDist({}, port.PS(sync=False)).build(
        async_bert(cfg, opt))
    try:
        check(runner.is_chief and runner._own_server is not None,
              "the async chief does not serve the coordination service")
        steps = window_steps(bert_window(cfg, ASYNC_STEPS, seed0=700))
        # The device's gradient time and a push's bytes, on the chief's
        # first batch (warm, then timed; outside the counted window).
        runner.local_grads(steps[0], 0)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        grads, _ = runner.local_grads(steps[0], 0)
        end.record()
        torch.cuda.synchronize()
        grad_ms = start.elapsed_time(end)
        t0 = time.perf_counter()
        push_bytes = len(_pack_tree(0, grads))
        pack_s = time.perf_counter() - t0
        del grads
        env = {k: os.environ[k] for k in ("AUTODIST_TPU_COORD_SERVICE",
                                          "AUTODIST_TPU_COORD_TOKEN")}
        env["AUTODIST_TPU_WORKER"] = "worker1"
        chief = {"losses": [], "step_s": []}
        before = async_counters()
        since = time.perf_counter()

        def chief_side():
            reset_launches()
            for b in steps:
                t1 = time.perf_counter()
                chief["losses"].append(float(runner.step(b)["loss"]))
                chief["step_s"].append(time.perf_counter() - t1)
            chief["launches"] = launches()
            runner.wait_applied(2 * ASYNC_STEPS, timeout_s=600)
            chief["wall"] = time.perf_counter() - t0
            chief["worker"] = json.loads(runner._client.get(
                "phase23/worker", timeout_ms=60000))
            chief["moved"] = {k: v - before[k]
                              for k, v in async_counters().items()}
            chief["spans"] = {k: span_seconds(f"asyncps/{k}", since)
                              for k in ASYNC_SPANS}
            final = runner.get_params()
            check(all(bool(torch.isfinite(t).all()) for _, t in
                      flatten_with_names(final)), "non-finite async params")
            del final
            runner.close()
            torch.cuda.empty_cache()
            chief["fast"] = ssp_role(ssp_env, "fast")

        t0 = time.perf_counter()
        (slow,), = spawn_together([({"kind": "async_worker", "env": env,
                                     "ssp_env": ssp_env}, 1)],
                                  meanwhile=chief_side)
    finally:
        runner.close()
        ssp_server.stop()
    worker, moved, spans = chief["worker"], chief["moved"], chief["spans"]
    losses = chief["losses"] + worker["losses"]
    check(all(math.isfinite(x) for x in losses),
          f"phase 23 (b): non-finite loss {losses}")
    check(moved["apply"] == 2 * ASYNC_STEPS and moved["push"] == ASYNC_STEPS
          and worker["counters"]["push"] == ASYNC_STEPS,
          f"phase 23 (b): pushes {moved['push']} + "
          f"{worker['counters']['push']}, applies {moved['apply']}")
    got = {k: chief["launches"][k] + worker["launches"][k] for k in KERNELS}
    want = dict.fromkeys(KERNELS, 0)
    want.update(dict.fromkeys(TRAINING_KERNELS,
                              cfg.num_layers * 2 * ASYNC_STEPS))
    check(got == want, f"phase 23 (b): launches {got}, expected {want} "
                       f"(chief {chief['launches']}, worker "
                       f"{worker['launches']})")

    def mean(xs):
        return sum(xs) / len(xs) if xs else float("nan")

    step_s = chief["step_s"] + worker["step_s"]
    print(f"phase 23 (b) BERT-base bf16 async PS [{label}], chief (PS "
          f"thread + worker) and one spawned worker on card 0, "
          f"{ASYNC_STEPS} pushes each: {2 * ASYNC_STEPS} updates applied "
          f"in {chief['wall']:.2f} s from the worker's spawn; step "
          f"{mean(step_s):.3f} s mean (chief "
          f"{[round(s, 3) for s in chief['step_s']]}, worker "
          f"{[round(s, 3) for s in worker['step_s']]}); the device's "
          f"gradient {grad_ms:.2f} ms a step; host seconds mean pull "
          f"{mean(spans['pull']):.3f} ({len(spans['pull'])}), pack "
          f"{mean(spans['pack']):.3f}, push {mean(spans['push']):.3f}; a "
          f"push {push_bytes} bytes (tree {runner.blob_bytes}; one pack "
          f"{pack_s:.3f} s); PS apply {mean(spans['apply']) * 1e3:.1f} ms "
          f"mean ({len(spans['apply'])}), publish "
          f"{mean(spans['publish']):.3f} s ({len(spans['publish'])}); "
          f"counts chief {moved}, worker {worker['counters']}; losses "
          f"{[round(x, 4) for x in losses]}; launches {got}", flush=True)
    fast = chief["fast"]
    done = {int(k): v for k, v in fast["done"].items()}
    # c9's rule at staleness 1: steps 1 and 2 at once; step 2 + k waits
    # for the slow worker's step k.
    check(done[2] < 0.29 and done[3] > 0.29 and done[4] > 0.59,
          f"phase 23 (c): the fast worker's steps completed at {done}")
    check(fast["captures"] == slow["captures"] == 0,
          "phase 23 (c): a gated runner captured a graph")
    waits = fast["waits"] + slow["waits"]
    print(f"phase 23 (c) SSP gate at staleness 1 [{label}], two 2-layer "
          f"bf16 DistributedRunners on card 0 (the fast one in this "
          f"process, the slow one in the spawned one), the slow one "
          f"sleeping {SSP_SLEEP_S} s before each step: the fast one's "
          f"steps 1-4 completed at "
          f"{[round(done[i], 3) for i in range(1, SSP_STEPS)]} s (rule: "
          f"2 < 0.29, 3 > 0.29, 4 > 0.59); ssp/gate_wait_s over "
          f"{len(waits)} waits: fast "
          f"{[round(w, 3) for w in fast['waits']]}, slow "
          f"{[round(w, 3) for w in slow['waits']]}", flush=True)
    return got


def ssp_window(label):
    """(c)'s host loop: a gated ``run_steps`` window against a loop of
    ``step`` calls, and the same strategy at staleness 0 captured."""
    from autodist_tpu_torch.runtime import coordination

    # A gated run_steps window is a loop of step calls at its seeds, and
    # captures nothing; at staleness 0 the same window is one graph.
    server = coordination.CoordServer()
    os.environ.update({"AUTODIST_TPU_COORD_SERVICE":
                       f"127.0.0.1:{server.port}",
                       "AUTODIST_TPU_COORD_TOKEN": server.token})
    coordination.reset_service_client()
    try:
        cfg = ssp_cfg(dropout=0.1)
        window = bert_window(cfg, 3, seed0=900)
        rngs = [5, 6, 7]
        ad = port.AutoDist({}, port.PS(staleness=1))
        seq = ad.build(async_bert(cfg, port.optim.sgd(0.1)), ssp_worker="a",
                       ssp_num_workers=1)
        check(seq._ssp is not None, "phase 23 (c): the gate is off")
        for b, r in zip(window_steps(window), rngs):
            seq.step(b, rng=r)
        fused = ad.build(async_bert(cfg, port.optim.sgd(0.1)),
                         ssp_worker="b", ssp_num_workers=1)
        fused.run_steps(window, rngs=rngs)
        gap = rel_err(fused.get_params(), seq.get_params())
        check(gap == 0.0 and fused.captures == 0,
              f"phase 23 (c): gated run_steps {gap:.3g} off the step loop, "
              f"{fused.captures} captures")
        plain = port.AutoDist({}, port.PS()).build(
            async_bert(cfg, port.optim.sgd(0.1)))
        plain.run_steps(window, rngs=rngs)
        check(plain.captures == 1, f"phase 23 (c): staleness 0 captured "
                                   f"{plain.captures} graphs")
        print(f"phase 23 (c) gated run_steps (3 steps, dropout 0.1, seeds "
              f"{rngs}) [{label}]: params equal to a loop of step calls "
              f"(largest gap {gap:.3g}), captures {fused.captures}; the same "
              f"strategy at staleness 0: captures {plain.captures}, replays "
              f"{plain.replays}", flush=True)
        for r in (seq, fused, plain):
            r.close()
    finally:
        os.environ.pop("AUTODIST_TPU_COORD_SERVICE", None)
        coordination.reset_service_client()
        server.stop()
    torch.cuda.empty_cache()


def phase_async():
    """Phase 23: asynchronous PS and the SSP gate on the card: (a) fp32
    parity of one async worker with the synchronous PS, (b) BERT-base
    bf16 through the chief's PS and a second worker process, (c) the
    SSP gate's timing and its host loop.  Returns (b)'s launches."""
    label = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    async_parity(label)
    counts = async_window(label)
    ssp_window(label)
    return counts


# --------------------------------------------------------------------- #
# phase 24: the model zoo
# --------------------------------------------------------------------- #
# Copies of examples/benchmark/imagenet.py's tables: forward GFLOPs an
# image at the canonical size (training ~ 3x) and the AllReduce chunk.
MODEL_FWD_GFLOPS = {"resnet50": 4.1, "vgg16": 15.5, "densenet121": 2.9,
                  "inceptionv3": 5.7}
MODEL_CHUNK_SIZES = {"vgg16": 25, "resnet101": 200, "inceptionv3": 30}
MODEL_DEFAULT_CHUNK = 512
# (name, model, input px, per-card batch)
MODEL_IMAGE = (("resnet50", "ResNet50", 224, 128), ("vgg16", "VGG16", 224, 64),
             ("densenet121", "DenseNet121", 224, 64),
             ("inceptionv3", "InceptionV3", 299, 64))
MODEL_STEPS = 5
NCF_FULL = dict(num_users=6040, num_items=3706, mf_dim=64,
                mlp_dims=(256, 128, 64))          # ncf.py --preset full
NCF_BATCH = 1024
LM1B_FULL = dict(vocab_size=800_000, embed_dim=512, hidden_dim=1024,
                 num_layers=2, num_samples=64)   # LSTMWordLM's own widths
LM1B_BATCH, LM1B_SEQ = 32, 20                    # lm1b_train.py
MODEL_CHECK_STEPS = 3


def model_gen(seed=0):
    return torch.Generator(device="cuda").manual_seed(seed)


def model_images(k, batch, size, classes, gen):
    """A ``[k, ...]`` window of random images and labels, made on the
    card."""
    return {"x": torch.rand(k, batch, size, size, 3, device="cuda",
                            generator=gen),
            "y": torch.randint(0, classes, (k, batch), device="cuda",
                               generator=gen, dtype=torch.int32)}


def model_ids(k, shape, high, gen):
    return torch.randint(0, high, (k,) + shape, device="cuda",
                         generator=gen, dtype=torch.int32)


def model_window(label, runner, window, examples, flops=None):
    """A warm window (its capture) and a timed one on the graph route,
    each one replay: losses finite, one capture and two replays, no
    kernel of the port launched; prints step ms, examples/s, peak memory
    (the capture's included), capture seconds and, with ``flops`` (a
    step's training FLOPs an example), the MFU; then profiles one more
    replay (device busy share, launches and the six kernels with the
    most device time, a step)."""
    chip = port.ResourceSpec({}).chip
    check(runner.lowered.capturable,
          f"phase 24 {label}: one card's lowering is not capturable")
    window = runner.place_steps(window)
    dt, metrics = timed_window(runner, window)
    got, peak_gb = launches(), torch.cuda.max_memory_allocated() / 1e9
    losses = metrics["loss"].float()
    check(bool(torch.isfinite(losses).all()),
          f"phase 24 {label}: non-finite loss: {losses}")
    check(got == dict.fromkeys(KERNELS, 0),
          f"phase 24 {label}: the zoo runs no kernel of the port, "
          f"launched {got}")
    check((runner.captures, runner.replays) == (1, 2),
          f"phase 24 {label}: {runner.captures} captures and "
          f"{runner.replays} replays, expected 1 and 2")
    rate = MODEL_STEPS * examples / dt
    mfu = (f", MFU {rate * flops / (chip.peak_bf16_tflops * 1e12):.4f}"
           if flops else "")
    print(f"phase 24 {label} graph: {MODEL_STEPS} steps in {dt:.3f} s, step "
          f"{dt / MODEL_STEPS * 1e3:.2f} ms, {rate:.1f} examples/s{mfu}, peak "
          f"memory {peak_gb:.2f} GB of {chip.hbm_gb:g}, capture "
          f"{runner.capture_seconds:.2f} s, replays {runner.replays}, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    prof = device_profile(lambda: runner.run_steps(window), MODEL_STEPS)
    if prof is None:
        print(f"phase 24 {label} step profile: device time not measured",
              flush=True)
    else:
        prof_ms, busy, n_launch, _, top = prof
        print(f"phase 24 {label} step profile (one more replay): device "
              f"busy {busy:.2f} ms of {prof_ms:.2f} ({busy / prof_ms:.1%}), "
              f"{n_launch:.0f} kernel launches a step; top per step: {top}",
              flush=True)
    runner.close()
    torch.cuda.empty_cache()


def model_graph_equals_loop(label, build, window, rngs):
    """fp32: a captured ``run_steps`` window and a loop of ``step`` calls
    at the same seeds, from the same initial state, end at the same
    params and ``batch_stats``, each tensor within 1e-5 of its largest
    value (floor 1e-3)."""
    graph, loop = build(), build()
    graph.run_steps(window, rngs=rngs)
    for i, rng in enumerate(rngs):
        loop.step({key: t[i] for key, t in window.items()}, rng=rng)
    check((graph.captures, graph.replays) == (1, 1),
          f"phase 24 {label}: {graph.captures} captures, {graph.replays} "
          f"replays, expected 1 and 1")
    worst = 0.0
    for part, got, want in (("params", graph.get_params(),
                             loop.get_params()),
                            ("extra", graph.get_extra(), loop.get_extra())):
        want = dict(flatten_with_names(want or {}))
        for name, t in flatten_with_names(got or {}):
            w = want[name]
            err = float((t - w).abs().max())
            scale = max(float(w.abs().max()), 1e-3)
            worst = max(worst, err / scale)
            check(err <= 1e-5 * scale,
                  f"phase 24 {label} {part} {name}: the graph route parts "
                  f"from the step loop by {err} (scale {scale})")
    print(f"phase 24 {label} fp32 graph = loop over {len(rngs)} steps: "
          f"worst {worst:.3e} of a tensor's largest value", flush=True)
    graph.close()
    loop.close()
    torch.cuda.empty_cache()


def phase_models():
    """Phase 24: the model zoo on the card.  fp32 first: ResNet18 (with
    BatchNorm) and lm1b at small widths, a captured window against a
    loop of ``step`` calls; then each model at full width on the graph
    route: the four ImageNet models in bf16 (``sgd(0.1, momentum=0.9)``,
    imagenet.py's ``AllReduce`` chunk), NCF at ``ncf.py``'s full preset
    and lm1b at ``LSTMWordLM``'s own widths through ``Parallax`` (both
    fp32, as the models compute in the JAX package)."""
    from autodist_tpu_torch import models as zoo

    label = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rngs = [11, 12, 13]

    def small_resnet():
        return port.AutoDist({}, port.AllReduce()).build(
            zoo.make_image_trainable(
                zoo.ResNet18(num_classes=10, num_filters=16,
                             dtype=torch.float32),
                port.optim.sgd(0.1, momentum=0.9), model_gen(), image_size=64))

    model_graph_equals_loop("ResNet18 (16 filters, 64 px, batch 16)",
                          small_resnet,
                          model_images(MODEL_CHECK_STEPS, 16, 64, 10, model_gen(1)),
                          rngs)
    small_lm = dict(vocab_size=2000, embed_dim=64, hidden_dim=64,
                    num_layers=2)

    def small_lm1b():
        return port.AutoDist({}, port.Parallax()).build(
            zoo.make_lm1b_trainable(port.optim.adagrad(0.2), model_gen(),
                                    **small_lm))

    gen = model_gen(2)
    model_graph_equals_loop("lm1b (vocab 2000, widths 64, batch 8 x 10)",
                          small_lm1b,
                          {"x": model_ids(MODEL_CHECK_STEPS, (8, 10), 2000, gen),
                           "y": model_ids(MODEL_CHECK_STEPS, (8, 10), 2000, gen)},
                          rngs)
    for name, model, size, batch in MODEL_IMAGE:
        trainable = zoo.make_image_trainable(
            getattr(zoo, model)(num_classes=1000),
            port.optim.sgd(0.1, momentum=0.9), model_gen(), image_size=size,
            batch_size=batch)
        runner = port.AutoDist({}, port.AllReduce(
            chunk_size=MODEL_CHUNK_SIZES.get(name, MODEL_DEFAULT_CHUNK))).build(
            trainable)
        model_window(f"{model} bf16 {size} px, batch {batch} ({label})", runner,
                   model_images(MODEL_STEPS, batch, size, 1000, model_gen(3)),
                   batch, 3.0 * MODEL_FWD_GFLOPS[name] * 1e9)
        del trainable, runner
    gen = model_gen(4)
    runner = port.AutoDist({}, port.AllReduce()).build(zoo.make_ncf_trainable(
        port.optim.adam(1e-3), model_gen(), **NCF_FULL))
    model_window(f"NCF fp32 full preset, batch {NCF_BATCH} ({label})", runner,
               {"users": model_ids(MODEL_STEPS, (NCF_BATCH,), 6040, gen),
                "items": model_ids(MODEL_STEPS, (NCF_BATCH,), 3706, gen),
                "labels": model_ids(MODEL_STEPS, (NCF_BATCH,), 2, gen)},
               NCF_BATCH)
    del runner
    runner = port.AutoDist({}, port.Parallax()).build(
        zoo.make_lm1b_trainable(port.optim.adagrad(0.2), model_gen(),
                                seq_len=LM1B_SEQ, batch_size=LM1B_BATCH,
                                **LM1B_FULL))
    model_window(f"lm1b fp32 vocab 800000, batch {LM1B_BATCH} x {LM1B_SEQ} "
               f"({label})", runner,
               {"x": model_ids(MODEL_STEPS, (LM1B_BATCH, LM1B_SEQ), 800_000, gen),
                "y": model_ids(MODEL_STEPS, (LM1B_BATCH, LM1B_SEQ), 800_000,
                             gen)},
               LM1B_BATCH)


# --------------------------------------------------------------------- #
# phase 25: runtime and elasticity
# --------------------------------------------------------------------- #
ELASTIC_STEPS = 4          # (a)'s and (b)'s steps: 2 before, 2 after
ELASTIC_AT = 2             # the step both ranks take preempt_signal at
ELASTIC_WINDOW = 2         # (c)'s graph-route windows after the shrink


def elastic_plan():
    """Both ranks preempted at one step: the chief, and the worker by its
    host marker (``AUTODIST_TPU_WORKER``, the cluster's host name)."""
    from autodist_tpu_torch.runtime.faults import FaultPlan, FaultSpec

    return FaultPlan([FaultSpec("preempt_signal", target=t,
                                at_step=ELASTIC_AT)
                      for t in ("chief", "localhost")], seed=25)


def elastic_parity_cfg(dropout=0.0):
    """(a) and (b): phase 22's 2-layer BERT (fp32, flash)."""
    return port.TransformerConfig(
        num_layers=2, dtype=torch.float32, dropout_rate=dropout,
        attention_dropout_rate=0.0, attention_fn=fa.make_attention_fn(False))


def elastic_parity_opt():
    # Adam at lr 1e-2 multiplies a gradient's rounding by up to lr / eps
    # (phase 13's rule): at eps 1e-8 the k bias's exactly-zero gradient
    # takes whole steps of either sign, and at eps 1e-4 the fp32
    # rounding of 2 ranks' gradients against one's parts the runs by
    # more than 1e-5 of a tensor's largest value before any restore.
    # (a) prints that gap at the restore; the restore itself is held
    # bit-exact, the whole state (``elastic_state``).
    return port.optim.adam(1e-2, eps=1e-3)


def elastic_state(runner):
    """Every leaf of ``runner``'s training state at its logical shape,
    on the host (gathered over the ranks: every rank calls it), with
    its seed stream and host step: what a restore onto any layout gives
    back bit for bit."""
    from autodist_tpu_torch.elastic.reshard import LiveSource, apply_ops

    m = runner.lowered.state_manifest(runner.state)
    read = LiveSource(runner.lowered, runner.state, m)
    leaves = {n: apply_ops(read(n), rec["ops"]).cpu()
              for n, rec in m["leaves"].items() if n not in m.get("sync", {})}
    return leaves, runner._seeds.get_state(), runner._host_step


def elastic_same(a, b) -> bool:
    """Whether two :func:`elastic_state` results are bit-equal: leaf
    names, dtypes and values, the seed stream and the host step."""
    (la, sa, ha), (lb, sb, hb) = a, b
    return (la.keys() == lb.keys() and ha == hb
            and all(la[n].dtype == lb[n].dtype and torch.equal(la[n], lb[n])
                    for n in la)
            and sa[0] == sb[0] and np.array_equal(sa[1], sb[1])
            and tuple(sa[2:]) == tuple(sb[2:]))


def elastic_faults():
    """This process's fault records, and whether every injection has a
    terminal record of the same fault and target."""
    from autodist_tpu_torch.runtime.faults import TERMINAL_PHASES

    recs = [{k: r.get(k) for k in ("fault", "target", "phase", "action")}
            for r in telemetry.get().events if r["kind"] == "fault"]
    done = {(r["fault"], r["target"]) for r in recs
            if r["phase"] in TERMINAL_PHASES}
    paired = all((r["fault"], r["target"]) in done for r in recs
                 if r["phase"] == "injected")
    return {"records": recs, "paired": paired and bool(recs)}


def elastic_routes(since):
    return [r["route"] for r in telemetry.get().events[since:]
            if r["kind"] == "reshard"]


def elastic_swap(spec):
    """(b) in one rank: two ``AllReduce`` runners at dropout 0.1 step
    twice from their seed streams; one is hot-swapped onto ``PS`` (the
    fast route), then both step twice more.  Returns the largest gap,
    the routes, the swap's seconds and the swapped update space."""
    cfg = elastic_parity_cfg(dropout=0.1)
    steps = window_steps(bert_window(cfg, ELASTIC_STEPS, seed0=2500))

    def build():
        return port.AutoDist(spec, port.AllReduce()).build(
            async_bert(cfg, elastic_parity_opt()))

    swapped, plain = build(), build()
    first_done = None
    for b in steps[:ELASTIC_AT]:
        swapped.step(b)
        plain.step(b)
        torch.cuda.synchronize()
        first_done = first_done or time.perf_counter()
    seen = len(telemetry.get().events)
    t0 = time.perf_counter()
    swapped = port.ElasticController(swapped.trainable, None).hot_swap(
        swapped, strategy=port.PS(), spec=spec)
    torch.cuda.synchronize()
    out = {"swap_s": time.perf_counter() - t0, "routes": elastic_routes(seen),
           "first_done": first_done,
           "updates": sorted({vp.update for vp in
                              swapped.lowered.plan.var_plans.values()})}
    for b in steps[ELASTIC_AT:]:
        swapped.step(b)
        plain.step(b)
    out["gap"] = rel_err(swapped.get_params(), plain.get_params())
    swapped.close()
    plain.close()
    torch.cuda.empty_cache()
    return out


def elastic_train(runner, ctl, steps):
    """Step ``runner`` under the shipped fault plan until the preemption
    (the injector fires at ``ELASTIC_AT``; the hook saves).  Returns the
    steps taken, the save's seconds and each step's milliseconds
    (synchronized)."""
    from autodist_tpu_torch.runtime.faults import (FaultInjector,
                                                   fault_target,
                                                   load_fault_plan)

    injector = FaultInjector(load_fault_plan(), fault_target())
    step_ms = []
    for i, b in enumerate(steps):
        t0 = time.perf_counter()
        injector.maybe_fire(i)
        if ctl.preempted:
            return i, time.perf_counter() - t0, step_ms
        runner.step(b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    raise AssertionError("the fault plan never preempted the run")


def elastic_part_a(ad, strategy, trainable, out_dir, chief):
    """(a) in one rank: ``PS`` on 2 ranks, the plan's preemption at step
    2 (both ranks save), then the worker departs and the chief resumes
    alone under ``AllReduce`` (staged), steps twice and runs the
    uninterrupted one-rank reference."""
    cfg = elastic_parity_cfg()
    steps = window_steps(bert_window(cfg, ELASTIC_STEPS, seed0=2600))
    runner = ad.build(trainable, strategy)
    saver = port.Saver(os.path.join(out_dir, "ckpt_a"))
    ctl = port.ElasticController(trainable, saver)
    previous = ctl.install(runner)
    try:
        at, _, _ = elastic_train(runner, ctl, steps)
        saved = elastic_state(runner)
        out = {"preempted_at": at, "strategy": strategy.to_json(),
               "backend": torch.distributed.get_backend()}
        if not chief:
            ctl.depart()
            out["faults"] = elastic_faults()
            return out
        out["sidecar"] = saver.read_sidecar(at) is not None
        seen = len(telemetry.get().events)
        resumed = ctl.resume(strategy=port.AllReduce(), spec={})
        out["routes"] = elastic_routes(seen)
        out["resumed_step"] = resumed.step_count
        out["leaves"] = len(saved[0])
        out["restore_exact"] = elastic_same(elastic_state(resumed), saved)
        ref = port.AutoDist({}, port.AllReduce()).build(
            async_bert(cfg, elastic_parity_opt()))
        for b in steps[:at]:
            ref.step(b)
        out["gap_at_restore"] = rel_err(resumed.get_params(),
                                        ref.get_params())
        for b in steps[at:]:
            resumed.step(b)
            ref.step(b)
        out["gap"] = rel_err(resumed.get_params(), ref.get_params())
        resumed.close()
        ref.close()
        out["faults"] = elastic_faults()
        return out
    finally:
        for sig, prev in previous.items():
            signal.signal(sig, prev)
        torch.cuda.empty_cache()


def elastic_part_c(ad, strategy, trainable, out_dir, chief):
    """(c) in one rank: phase 5's BERT-base bf16 configuration through
    (a)'s flow at 2 ranks; then on the chief alone the resumed runner's
    graph-route windows, its bf16 ``mu`` held bit-equal to the saved
    one, and a hot swap onto ``PS`` (the fast route) with its seconds
    and the device bytes it allocates above the two states."""
    cfg, _ = async_bf16()
    steps = window_steps(bert_window(cfg, ELASTIC_AT + 1, seed0=2700))
    runner = ad.build(trainable, strategy)
    saver = port.Saver(os.path.join(out_dir, "ckpt_c"))
    ctl = port.ElasticController(trainable, saver)
    previous = ctl.install(runner)
    reset_launches()
    try:
        at, save_s, step_ms = elastic_train(runner, ctl, steps)
        saved = elastic_state(runner)
        out = {"preempted_at": at, "save_s": save_s, "step_ms": step_ms,
               "save_bytes": saver.last_save_bytes,
               "backend": torch.distributed.get_backend()}
        if not chief:
            ctl.depart()
            out["launches"] = launches()
            out["steps"] = at
            out["faults"] = elastic_faults()
            return out
        out["sidecar_bytes"] = saver.last_sidecar_bytes
        seen = len(telemetry.get().events)
        t0 = time.perf_counter()
        resumed = ctl.resume(strategy=port.AllReduce(chunk_size=256), spec={})
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        (rec,) = [r for r in telemetry.get().events[seen:]
                  if r["kind"] == "reshard"]
        out["restore"] = {k: rec[k] for k in ("route", "peak_host_bytes",
                                              "bytes_moved", "duration_ms")}
        restored = elastic_state(resumed)
        mu = [t for n, t in restored[0].items() if "/mu/" in f"/{n}/"]
        out["mu_bf16"] = bool(mu) and all(t.dtype == torch.bfloat16
                                          for t in mu)
        out["leaves"] = len(saved[0])
        out["restore_exact"] = elastic_same(restored, saved)
        del saved, restored, mu
        window = resumed.place_steps(bert_window(cfg, ELASTIC_WINDOW,
                                                 seed0=2750))
        resumed.run_steps(window)                      # the capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = resumed.run_steps(window)
        torch.cuda.synchronize()
        out["graph_step_ms"] = ((time.perf_counter() - t0) * 1e3
                                / ELASTIC_WINDOW)
        out["graph"] = [resumed.captures, resumed.replays]
        out["loss_after"] = float(metrics["loss"][-1])
        # the hot swap, on this rank alone
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        seen = len(telemetry.get().events)
        t0 = time.perf_counter()
        swapped = ctl.hot_swap(resumed, strategy=port.PS(), spec={})
        torch.cuda.synchronize()
        out["swap_s"] = time.perf_counter() - t0
        out["swap_routes"] = elastic_routes(seen)
        out["state_bytes"] = state_bytes(swapped.state)
        out["swap_extra_bytes"] = (torch.cuda.max_memory_allocated()
                                   - before - out["state_bytes"])
        out["loss_swapped"] = float(swapped.step(steps[-1])["loss"])
        swapped.close()
        out["launches"] = launches()
        out["steps"] = at + 2 * ELASTIC_WINDOW + 1
        out["faults"] = elastic_faults()
        return out
    finally:
        for sig, prev in previous.items():
            signal.signal(sig, prev)
        torch.cuda.empty_cache()


def elastic_role(role, out_dir):
    """One process of phase 25's two jobs.  The chief launches each job
    through its own ``LocalCluster(1)`` (one worker, this script with
    ``--elastic-role worker-a`` or ``worker-c``), publishing the
    strategy and shipping the fault plan; both ranks ``bootstrap()``
    from the ``multihost`` env (gloo where they share a card, NCCL one
    rank a card).  Job (c)'s worker starts first and waits at its
    rendezvous while job (a) runs, so that its start-up overlaps (a);
    each cluster puts back the environment it exported.  Each process
    writes its results as JSON into ``out_dir``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    script = os.path.abspath(__file__)
    out = {}
    if role == "chief":
        os.environ.update(elastic_plan().ship())
        jobs = {}
        for part in ("c", "a"):
            cluster = port.LocalCluster(1)
            if part == "a":
                trainable = async_bert(elastic_parity_cfg(),
                                       elastic_parity_opt())
                builder = port.PS()
            else:
                trainable = async_bert(*async_bf16())
                builder = port.AllReduce(chunk_size=256)
            ad = port.AutoDist(cluster.resource_spec, builder)
            strategy = ad.build_or_load_strategy(trainable)
            t_launch = time.perf_counter()
            cluster.launch_clients(strategy, argv=[
                sys.executable, script, "--elastic-role", f"worker-{part}",
                "--elastic-dir", out_dir])
            jobs[part] = (cluster, ad, strategy, trainable, t_launch)
        try:
            for part in ("a", "c"):
                cluster, ad, strategy, trainable, t_launch = jobs.pop(part)
                try:
                    cluster.resource_spec.bootstrap()
                    if part == "a":
                        out["b"] = elastic_swap(cluster.resource_spec)
                        out["b"]["first_step_s"] = (out["b"].pop("first_done")
                                                    - t_launch)
                        out["a"] = elastic_part_a(ad, strategy, trainable,
                                                  out_dir, True)
                    else:
                        out["c"] = elastic_part_c(ad, strategy, trainable,
                                                  out_dir, True)
                    cluster.join(timeout=300)
                finally:
                    cluster.terminate()
                del trainable
                torch.cuda.empty_cache()
        finally:
            for cluster, *_ in jobs.values():
                cluster.terminate()
    else:
        part = role[-1]
        spec = port.ResourceSpec({})
        spec.bootstrap()
        trainable = (async_bert(elastic_parity_cfg(), elastic_parity_opt())
                     if part == "a" else async_bert(*async_bf16()))
        ad = port.AutoDist(spec)
        # the chief's, taken once: (b)'s builds then build their own
        strategy = ad.build_or_load_strategy(trainable)
        if part == "a":
            out["b"] = elastic_swap(spec)
        run = elastic_part_a if part == "a" else elastic_part_c
        out[part] = run(ad, strategy, trainable, out_dir, False)
    with open(os.path.join(out_dir, f"{role}.json"), "w") as f:
        json.dump(out, f)


def phase_elastic():
    """Phase 25: runtime and elasticity on card 0 (or one rank a card).
    (a) fp32 parity of a preempted ``PS`` job resumed alone under
    ``AllReduce`` against an uninterrupted one-rank run; (b) a hot swap
    against no swap; (c) BERT-base bf16 through the same flow, with its
    seconds and bytes.  Returns (c)'s launches (both ranks')."""
    label = card()
    build.build()          # one build for the job's three processes
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--elastic-role",
             "chief", "--elastic-dir", tmp], timeout=600)
        check(proc.returncode == 0,
              f"phase 25: the chief exited with {proc.returncode}")
        res = {}
        for role in ("chief", "worker-a", "worker-c"):
            with open(os.path.join(tmp, f"{role}.json")) as f:
                res[role] = json.load(f)
    chief, wa, wc = res["chief"], res["worker-a"], res["worker-c"]
    a, b, c = chief["a"], chief["b"], chief["c"]
    backend = a["backend"]
    where = ("2 ranks over gloo sharing card 0" if backend == "gloo"
             else "2 ranks over NCCL, one a card")
    # (a)
    check(wa["a"]["strategy"] == a["strategy"],
          "phase 25 (a): the worker's strategy is not the chief's")
    check(a["preempted_at"] == wa["a"]["preempted_at"] == ELASTIC_AT
          and a["sidecar"], f"phase 25 (a): preempted at "
          f"{a['preempted_at']} / {wa['a']['preempted_at']}, sidecar "
          f"{a['sidecar']}")
    check(a["routes"] == ["staged"] and a["resumed_step"] == ELASTIC_AT
          and a["restore_exact"], f"phase 25 (a): restore routes "
          f"{a['routes']} at step {a['resumed_step']}, the whole state "
          f"bit-equal to the saved one {a['restore_exact']}")
    check(a["gap"] <= 1e-5, f"phase 25 (a): the resumed run's params are "
                            f"{a['gap']:.3g} of a tensor's largest value "
                            f"off the uninterrupted run's")
    for who, f in (("chief", a["faults"]), ("worker", wa["a"]["faults"]),
                   ("chief", c["faults"]), ("worker", wc["c"]["faults"])):
        check(f["paired"], f"phase 25: {who}'s fault records are not "
                           f"paired: {f['records']}")
    print(f"phase 25 (a) fp32 2-layer BERT [{label}], {where}: a chief "
          f"published PS() through LocalCluster(1), the worker loaded it "
          f"(JSON equal); preempt_signal on both ranks at step {ELASTIC_AT}"
          f" (both saved, sidecar written), the worker departed, the chief "
          f"resumed alone under AllReduce by the {a['routes'][0]} route "
          f"(the whole state, {a['leaves']} leaves with Adam's mu, nu "
          f"and count, the seed stream and the host step, bit-equal to "
          f"the 2-rank job's at the save; "
          f"{a['gap_at_restore']:.3g} of each tensor's largest value off the one-rank run at step "
          f"{ELASTIC_AT}) and stepped twice: params within {a['gap']:.3g} "
          f"(floor 1e-3; bound 1e-5) of an uninterrupted one-rank "
          f"AllReduce run; fault records "
          f"{[r['phase'] for r in a['faults']['records']]} (chief), "
          f"{[r['phase'] for r in wa['a']['faults']['records']]} (worker)",
          flush=True)
    # (b)
    for who, r in (("chief", b), ("worker", wa["b"])):
        check(r["routes"] == ["fast"] and r["updates"] == ["flat"],
              f"phase 25 (b) {who}: routes {r['routes']}, update spaces "
              f"{r['updates']}")
        check(r["gap"] <= 1e-5, f"phase 25 (b) {who}: the swapped run is "
                                f"{r['gap']:.3g} off the unswapped one")
    print(f"phase 25 (b) fp32 2-layer BERT, dropout 0.1 [{label}], {where}:"
          f" from launch_clients to the chief's first step "
          f"{b['first_step_s']:.2f} s; hot_swap AllReduce -> PS after "
          f"{ELASTIC_AT} steps by the fast "
          f"route in {b['swap_s']:.3f} s, then {ELASTIC_STEPS - ELASTIC_AT} "
          f"steps: params within {max(b['gap'], wa['b']['gap']):.3g} of the "
          f"unswapped run at the same seed streams (bound 1e-5)", flush=True)
    # (c)
    wcc = wc["c"]
    check(c["preempted_at"] == wcc["preempted_at"] == ELASTIC_AT,
          f"phase 25 (c): preempted at {c['preempted_at']} / "
          f"{wcc['preempted_at']}")
    check(c["restore"]["route"] == "staged" and c["mu_bf16"]
          and c["restore_exact"], f"phase 25 (c): restore {c['restore']}, "
          f"mu bf16 {c['mu_bf16']}, the whole state bit-equal "
          f"{c['restore_exact']}")
    check(math.isfinite(c["loss_after"]) and math.isfinite(
        c["loss_swapped"]), f"phase 25 (c): losses {c['loss_after']}, "
        f"{c['loss_swapped']}")
    check(c["graph"] == [1, 2] and c["swap_routes"] == ["fast"],
          f"phase 25 (c): captures/replays {c['graph']}, swap routes "
          f"{c['swap_routes']}")
    steps = c["steps"] + wcc["steps"]
    got = {k: c["launches"][k] + wcc["launches"][k] for k in KERNELS}
    want = dict.fromkeys(KERNELS, 0)
    want.update(dict.fromkeys(TRAINING_KERNELS, 12 * steps))
    check(got == want, f"phase 25 (c): launches {got}, expected {want}")
    gb = 1e9
    print(f"phase 25 (c) BERT-base bf16 AllReduce(256) [{label}], {where} "
          f"then one rank (its worker started during (a)): step ms before "
          f"the shrink "
          f"({backend}, host-staged where gloo) chief "
          f"{[round(x, 1) for x in c['step_ms']]}, worker "
          f"{[round(x, 1) for x in wcc['step_ms']]}; preemption save "
          f"{c['save_s']:.2f} s (chief) / {wcc['save_s']:.2f} s (worker), "
          f"{c['save_bytes'] / gb:.3f} + {wcc['save_bytes'] / gb:.3f} GB, "
          f"sidecar {c['sidecar_bytes']} bytes; restore_elastic (the "
          f"whole state, {c['leaves']} leaves, bf16 mu, bit-equal) "
          f"{c['restore_s']:.2f} s ({c['restore']['duration_ms']:.0f} ms in "
          f"the engine), route {c['restore']['route']}, peak_host_bytes "
          f"{c['restore']['peak_host_bytes']}, logical bytes "
          f"{c['restore']['bytes_moved']}; step ms after the shrink (one "
          f"rank, graph route) {c['graph_step_ms']:.1f}, loss "
          f"{c['loss_after']:.4f}; hot_swap AllReduce -> PS "
          f"{c['swap_s']:.2f} s, {c['swap_extra_bytes'] / gb:.3f} GB above "
          f"the two states ({c['state_bytes'] / gb:.3f} GB each); launches "
          f"{got} over {steps} steps", flush=True)
    return got


# --------------------------------------------------------------------- #
# phase 26: multi-slice, the dcn axis
# --------------------------------------------------------------------- #
SLICE_MESH = {"dcn": 2, "data": 2}
SLICE_STEPS = 2            # the bf16 window's timed steps
SLICE_PIPE_LAYERS = 4      # the pipelined LM's depth, cut from 8
SLICE_NOTE = ("dcn on one host's cards: a program-correctness run, not a "
              "cross-node measurement")


def slice_parity_job():
    """(a)'s fp32 parity: phase 13's 2-layer BERT-base width."""
    return {"layers": 2, "dtype": torch.float32, "seq": 128, "masked": 20,
            "batch": 4, "opt": (1e-4, 0.01, None, 1e-4)}


def slice_bert(job, spec):
    cfg = port.TransformerConfig(
        num_layers=job["layers"], dtype=job["dtype"], dropout_rate=0.0,
        attention_dropout_rate=0.0, attention_fn=fa.make_attention_fn(False))
    lr, wd, mu, eps = job["opt"]
    trainable = bert.make_mlm_trainable(
        cfg, port.optim.adamw(lr, eps=eps, weight_decay=wd, mu_dtype=mu),
        torch.Generator(device="cuda").manual_seed(0),
        with_input_mask=False)
    return port.AutoDist(spec, port.AllReduce(chunk_size=256)).build(
        trainable)


def slice_pipe_runner(mesh, virtual_stages):
    """(b)'s pipelined LM: the serve width, 4 layers, fp32, SGD with
    momentum, 2 microbatches."""
    torch.manual_seed(0)
    trainable = make_pipeline_lm_trainable(
        cfg_of(torch.float32, SLICE_PIPE_LAYERS),
        port.optim.sgd(1e-2, momentum=0.9),
        torch.Generator(device="cuda").manual_seed(0))
    return port.AutoDist({"mesh": mesh}, port.Pipeline(
        num_microbatches=2, virtual_stages=virtual_stages)).build(trainable)


def slice_pipe_batch(step):
    x = np.random.RandomState(600 + step).randint(
        0, VOCAB, (8, TP_SEQ)).astype(np.int32)
    return {"x": x, "y": np.roll(x, -1, axis=1)}


def logical_digest(runner):
    """Each state leaf at its logical form (the manifest's recipe over
    the gathered stored leaf; collective on every rank), as a SHA-256 of
    its bytes, with its dtype and shape."""
    import hashlib

    from autodist_tpu_torch.elastic.reshard import LiveSource, apply_ops

    manifest = runner.lowered.state_manifest(runner.state)
    read = LiveSource(runner.lowered, runner.state, manifest)
    out = {}
    for name, rec in manifest["leaves"].items():
        t = apply_ops(read(name), rec["ops"]).contiguous().cpu()
        out[name] = [str(t.dtype), list(t.shape), hashlib.sha256(
            t.reshape(-1).view(torch.uint8).numpy().tobytes()).hexdigest()]
    return manifest["family"], out


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def multislice_rank(job):
    """Phase 26 in one rank of the 4-rank job: (a) fp32 parity and the
    bf16 window on dcn x data, (b) the pipeline save, (c) the two MoE
    programs."""
    rank = torch.distributed.get_rank()
    out = {}
    # (a) fp32: 3 steps of the global batch of 4 ranks
    pj = slice_parity_job()
    runner = slice_bert(pj, {"mesh": SLICE_MESH})
    check(runner.lowered.plan.repl_axes == ("dcn", "data")
          and runner.lowered.batch_axis.size == 4,
          f"(a): replica axes {runner.lowered.plan.repl_axes}")
    runner.run_steps(zoo_window(pj, 3, pj["batch"] * 4, seed0=700))
    if rank == 0:
        torch.save({n: t.cpu() for n, t in
                    flatten_with_names(runner.get_params())},
                   os.path.join(job["dir"], "a_params.pt"))
    else:
        runner.get_params()
    runner.close()
    del runner
    torch.cuda.empty_cache()
    # (a) bf16 at full depth: a warm step, then the timed window
    bj = dict(zoo_bf16_job(4), backend=job["backend"])
    runner = slice_bert(bj, {"mesh": SLICE_MESH})
    window = runner.place_steps(zoo_window(bj, SLICE_STEPS, BERT_BATCH * 4,
                                           seed0=800))
    dt, metrics = timed_window(runner, window)
    got = launches()
    want = dict.fromkeys(KERNELS, 0)
    want.update(dict.fromkeys(TRAINING_KERNELS, 12 * SLICE_STEPS))
    check(got == want, f"(a) rank {rank}: launches {got}, expected {want}")
    losses = metrics["loss"].float()
    check(bool(torch.isfinite(losses).all()), f"(a): losses {losses}")
    out["a"] = {"seconds": dt, "launches": got,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "route": "graph" if runner.lowered.capturable else "loop",
                "loss": [float(losses[0]), float(losses[-1])]}
    runner.close()
    del runner, window
    torch.cuda.empty_cache()
    # (b) the pipeline job: two steps, a save, one more step
    runner = slice_pipe_runner({"data": 2, "pipe": 2}, 2)
    for i in range(2):
        runner.step(slice_pipe_batch(i), rng=i)
    saver = port.Saver(os.path.join(job["dir"], "pipe_ckpt"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    saver.save(runner)
    saver.wait()
    torch.distributed.barrier()
    save_s = time.perf_counter() - t0
    family, digest = logical_digest(runner)
    loss3 = float(runner.step(slice_pipe_batch(2), rng=2)["loss"])
    sidecar = saver.read_sidecar(2)
    out["b"] = {"save_s": save_s, "family": family, "digest": digest,
                "loss3": loss3,
                "sidecar": None if sidecar is None
                else sidecar["manifest"]["family"]}
    runner.close()
    del runner
    torch.cuda.empty_cache()
    # (c) MoE: expert_over_dcn on 2 slices, and without it
    mj = {"layers": 1, "seq": 128, "batch": 16, "capacity": 4.0,
          "dtype": torch.float32, "lr": 1e-4}
    out["c"] = {}
    for label, spec, kw in (
            ("expert_over_dcn", {"topology": {"num_devices": 4,
                                              "num_slices": 2},
                                 "mesh": {"data": 2, "expert": 2}},
             {"expert_over_dcn": True}),
            ("plain", {"mesh": {"data": 2, "expert": 2}}, {})):
        trainable = port.make_moe_lm_trainable(
            moe_cfg(mj), port.optim.adam(mj["lr"]),
            torch.Generator(device="cuda").manual_seed(0),
            batch_size=mj["batch"], seq_len=mj["seq"])
        runner = port.AutoDist(spec, port.ExpertParallel(
            num_experts=MOE_EXPERTS, capacity_factor=mj["capacity"],
            **kw)).build(trainable)
        # a step loop: the expert lowering has not run under capture
        # over NCCL (ROADMAP's standing list)
        ms = [runner.step(b) for b in window_steps(
            moe_window(mj, 3, seed0=900))]
        out["c"][label] = {k: [float(m[k]) for m in ms]
                           for k in ("nll", "loss")}
        out["c"][label]["over_dcn"] = runner.strategy.graph_config.parallel[
            "expert_over_dcn"]
        out["c"][label]["lint"] = sorted(lint_plan(runner.strategy).codes())
        runner.close()
        del runner, trainable
        torch.cuda.empty_cache()
    return out


def phase_multislice():
    """Phase 26: the dcn axis (see the module docstring).  Returns (a)'s
    bf16 window's launches, the four ranks'."""
    label = card()
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 4 else "gloo"
    where = ("4 ranks over NCCL, one a card" if backend == "nccl"
             else "4 ranks over gloo sharing card 0, transfers through "
                  "host")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_ranks({"kind": "multislice", "dir": tmp}, 4, backend)
        # (a) one rank on the same global batches
        pj = slice_parity_job()
        runner = slice_bert(pj, {})
        init = {n: t.cpu() for n, t in
                flatten_with_names(runner.get_params())}
        runner.run_steps(zoo_window(pj, 3, pj["batch"] * 4, seed0=700))
        ref = {n: t.cpu() for n, t in flatten_with_names(
            runner.get_params())}
        runner.close()
        del runner
        torch.cuda.empty_cache()
        # Held over the tree (update_distance says why not a tensor);
        # the largest tensor gap is printed beside it.
        got_a = torch.load(os.path.join(tmp, "a_params.pt"))
        dist_a, err_a = update_distance(got_a, ref, init), rel_err(got_a, ref)
        check(dist_a <= 1e-4, f"phase 26 (a): dcn x data params "
              f"{dist_a:.3g} of one rank's update away (bound 1e-4)")
        # (b) the restore on one rank
        src = ranks[0]["b"]
        check(src["family"] == "pipeline" and src["sidecar"] == "pipeline",
              f"phase 26 (b): manifest {src['family']}, sidecar "
              f"{src['sidecar']}")
        ckpt = os.path.join(tmp, "pipe_ckpt")
        save_bytes = dir_bytes(ckpt)
        runner = slice_pipe_runner({"pipe": 1}, 2 * 2)
        telemetry.get().events.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        port.Saver(ckpt).restore_elastic(runner)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        event = [e for e in telemetry.get().events
                 if e["kind"] == "reshard"][-1]
        family, digest = logical_digest(runner)
        check(digest == src["digest"], "phase 26 (b): the restored logical "
              "state differs from the source's: " + ", ".join(
                  n for n, d in src["digest"].items() if digest.get(n) != d))
        loss3 = float(runner.step(slice_pipe_batch(2), rng=2)["loss"])
        check(abs(loss3 - src["loss3"]) <= 1e-5 * abs(src["loss3"]),
              f"phase 26 (b): next loss {loss3} vs uninterrupted "
              f"{src['loss3']}")
        runner.close()
        del runner
        torch.cuda.empty_cache()
    # (c) the two MoE programs of each rank: on one host the flag moves
    # no collective (the slices are the expert axis's ranks either way),
    # so the run shows that it is recorded and linted, and that the
    # program is the same, bit for bit
    for r in ranks:
        over, plain = r["c"]["expert_over_dcn"], r["c"]["plain"]
        check(over["over_dcn"] and not plain["over_dcn"]
              and over["lint"] == ["ADT061"] and plain["lint"] == [],
              f"phase 26 (c): flag {over['over_dcn']}/{plain['over_dcn']}, "
              f"lint {over['lint']}/{plain['lint']}")
        check(all(math.isfinite(x) for x in over["loss"] + over["nll"])
              and all(over[k] == plain[k] for k in ("nll", "loss")),
              f"phase 26 (c): expert_over_dcn {over} vs plain {plain}")
    a = [r["a"] for r in ranks]
    dt = max(x["seconds"] for x in a)
    got = {k: sum(x["launches"][k] for x in a) for k in KERNELS}
    print(f"phase 26 (a) [{label}; {where}; {SLICE_NOTE}]: fp32 2-layer "
          f"BERT-base width, seq 128, 3 AdamW steps, AllReduce on "
          f"dcn 2 x data 2 (replica axes dcn, data): params {dist_a:.3e} "
          f"of one rank's update on the same 16-row batches (bound 1e-4; "
          f"largest tensor gap {err_a:.3e}, not held); "
          f"bf16 BERT-base, batch {BERT_BATCH} a rank, run_steps route "
          f"{a[0]['route']}: {SLICE_STEPS} steps in {dt:.3f} s, step "
          f"{dt / SLICE_STEPS * 1e3:.1f} ms, "
          f"{SLICE_STEPS * BERT_BATCH * 4 / dt:.2f} examples/s, peak memory "
          f"per rank " + ", ".join(f"{x['peak_gb']:.2f}" for x in a)
          + f" GB, loss {a[0]['loss'][0]:.4f} -> {a[0]['loss'][1]:.4f}, "
          f"launches {got}", flush=True)
    print(f"phase 26 (b) [{label}; {where}; {SLICE_NOTE}]: fp32 pipelined LM "
          f"at the serve width, {SLICE_PIPE_LAYERS} layers, "
          f"Pipeline(virtual_stages=2) on data 2 x pipe 2, saved at step 2 "
          f"in {src['save_s']:.2f} s ({save_bytes} bytes, the sidecar's "
          f"manifest family {src['sidecar']}); restore_elastic on one rank "
          f"(pipe 1, V = 4) in {restore_s:.2f} s ({event['duration_ms']:.0f} "
          f"ms in the engine, route {event['route']}, logical bytes "
          f"{event['bytes_moved']}, peak host bytes "
          f"{event['peak_host_bytes']}): the logical state "
          f"({len(digest)} leaves) bit-equal to the source's; next loss "
          f"{loss3:.6f} vs uninterrupted {src['loss3']:.6f}", flush=True)
    c = ranks[0]["c"]
    print(f"phase 26 (c) [{label}; {where}; {SLICE_NOTE}]: fp32 1-layer MoE "
          f"LM, seq 128, batch 16, 3 Adam steps, ExpertParallel("
          f"expert_over_dcn=True) on 2 slices (data 2 x expert 2) nll "
          f"{c['expert_over_dcn']['nll']} vs plain ExpertParallel "
          f"{c['plain']['nll']} (bit-equal: the flag moves no collective "
          f"on one host), lint {c['expert_over_dcn']['lint']} vs "
          f"{c['plain']['lint']}", flush=True)
    return got


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--phases",
        default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,19,20,21,"
                "22,23,24,25,26",
        help="comma-separated phases to run (default: all); the kernels "
             "line needs them all")
    parser.add_argument("--elastic-role", help=argparse.SUPPRESS)
    parser.add_argument("--elastic-dir", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.elastic_role:              # a process of phase 25's jobs
        elastic_role(args.elastic_role, args.elastic_dir)
        return 0
    t0 = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          f"card(s)", flush=True)
    record, counts = {}, {}

    def add(found):
        for name, n in found.items():
            counts[name] = counts.get(name, 0) + n

    steps = [(1, lambda: (record.update(ptxas=ptxas_registers()),
                          phase_kernels(record),
                          phase_attention_kernels(record),
                          phase_tp_kernels(record),
                          phase_a2a_kernels(record))),
             (2, phase_parity),
             (3, lambda: add(phase_serve())),
             (4, phase_training_parity),
             (5, lambda: add(phase_train())),
             (6, phase_tp_parity),
             (7, lambda: add(phase_tp_window())),
             (8, phase_moe_parity),
             (9, lambda: add(phase_moe_window())),
             (10, lambda: add(phase_tp_serve())),
             (11, phase_seq_parity),
             (12, lambda: add(phase_seq_window())),
             (13, phase_zoo_parity),
             (14, lambda: add(phase_zoo_window())),
             (15, lambda: add(phase_zero_parity())),
             (16, lambda: add(phase_zero_window())),
             (17, phase_ladder_parity),
             (18, lambda: add(phase_ladder_serve())),
             (19, lambda: add(phase_lifecycle())),
             (20, lambda: add(phase_export_serve())),
             (21, lambda: add(phase_overlap())),
             (22, lambda: add(phase_gspmd())),
             (23, lambda: add(phase_async())),
             (24, phase_models),
             (25, lambda: add(phase_elastic())),
             (26, lambda: add(phase_multislice()))]
    for phase, run in steps:
        if phase in phases:
            t1 = time.perf_counter()
            run()
            print(f"phase {phase} took {time.perf_counter() - t1:.1f} s, "
                  f"done at {time.perf_counter() - t0:.1f} s", flush=True)
    if phases >= {phase for phase, _ in steps}:
        kernels = []
        for name, k in KERNELS.items():
            # K3 and K8 work on int8 levels and fp32 values: their one
            # record is fp32.
            dtype = (torch.bfloat16 if (name, torch.bfloat16) in record
                     else torch.float32)
            rec = record[(name, dtype)]
            kernels.append({
                "name": name, "route": "cuda", "source": k["source"],
                "replaces": k["replaces"], "launches": counts[name],
                "max_abs_err": rec["max_abs_err"],
                "max_abs_err_fp32": record[(name, torch.float32)][
                    "max_abs_err"],
                "ms": rec["ms"], "kernel_ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                "dtype": str(dtype)[6:]})
            if "copy_ms" in rec:                 # K3, K8
                kernels[-1]["copy_ms"] = rec["copy_ms"]
            if (name, dtype, 512) in record:     # K4's out projection
                kernels[-1]["k512"] = record[(name, dtype, 512)]
            kernels[-1].update(record["ptxas"].get(name, {}))
            if (name, dtype, "serve_mix") in record:     # K5-K7
                for label in ("serve_mix", "one_slot", "tp2"):
                    kernels[-1][label] = record[(name, dtype, label)]
                kernels[-1]["ptxas_fp32"] = record["ptxas"][f"{name} fp32"]
            if f"{name} cuda_core" in counts:            # K7
                kernels[-1]["cuda_core_launches"] = counts[f"{name} cuda_core"]
            if name in PAIR:
                kernels[-1]["library"] = (
                    "SDPA's autograd backward (dq, dk, dv), shared by "
                    "K2a and K2b: compare the pair")
                kernels[-1]["pair"] = record[("K2 pair", dtype)]
            if name in TRAINING_KERNELS:                  # K1, K2a, K2b
                for label in ("ring_chunk", "ring_chunk_causal"):
                    kernels[-1][label] = dict(
                        record[(name, dtype, label)],
                        pair=record[("K2 pair", dtype, label)])
            for label in ("verify", "prefill_64", "prefill_512"):
                if (name, dtype, label) in record:        # K7, K1
                    kernels[-1][label] = record[(name, dtype, label)]
        print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
