#!/usr/bin/env python3
"""Drive the PyTorch port (paddle_tpu_torch) end to end on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--init-range 0.055] [--dtype bfloat16]

Phases, each fatal on failure (a traceback and a non-zero exit, never the
ok line):

1. build   — compile every CUDA kernel of the port from
             paddle_tpu_torch/csrc with nvcc, all sources at once (and
             graph_edges.cu, the host helper that counts a captured
             graph's edges), into
             build/paddle_tpu_torch/, and print the build time and the
             registers, spills, static shared memory and "Potential
             Performance Loss" notes ptxas reports for the flash
             forward's and backward's, the prefill chunk's, the paged
             decode's, the decode attention's and the int8 head's
             kernels, for the add + LayerNorm instances (an add_ln
             instance that spills fails the smoke) and for the
             moe_gather instances (one that spills fails too), from
             the report kept beside each library, so a build that an
             earlier run left is checked as well;
2. kernels — hold each kernel against its plain PyTorch version on the
             card, in f32 (TF32 off) and bf16. The serving kernels at the
             serving shapes of GPT-3 125M (12 heads of 64, block 16, 32
             blocks per sequence, 16 slots, chunk 128) with random block
             tables, context lengths 0..511 including 0, block edges and
             the decode kernel's 32-key chunk edges, an inactive slot,
             and chunk starts p0 in {0, 7, 128, 384, 400} (at 400 the
             chunk runs past key 511 and its last rows clamp; each also
             with p0 read from device memory, bit for bit the host
             argument's result); the
             training kernels at [2, 1024, 12, 64] (flash forward and
             backward, causal, non-causal, and causal with sq 512 < sk
             1024, plus ragged lengths (sq 200; sq 300 < sk 700; sq 130
             < sk 190, a partial last key tile) and head_dim 128; every
             backward run twice and held bitwise
             equal: no atomics) and at 24576 x 768 and
             16 x 768 (add + LayerNorm); the inference pair (K7's out
             and the residual carry from one launch, the carry bit for
             bit x + residual) at 8, 16, 128, 300 and 24576 rows of 768
             (its 16-byte path), of 770 and with x one element off its
             allocation (its one-element path), 3 rows of 4096, in f32,
             bf16 and bf16 x over an f32 residual; the decode kernels
             at generate's shapes: decode_fused at batch 8, cache 256,
             12 heads of 64, off in {0, 7, 63, 64, 127, 128, 135, 136,
             191, 200, 255}
             (one chunk up to 128 keys, then 8 chunks, full at 136 keys;
             and head_dim 128, 6 heads of 64 (no group of 4 heads), and
             bf16 q over the f32 cache), and with its position read from
             device memory at keys {1, 32, 33, 64, 65, 128, 129, 136,
             200, 256} and every chunk count 1/2/4/8 that leaves each
             chunk a key: inside a CUDA graph bit for bit the same launch
             outside it, at decode_split's chunk count the host
             position's bits, int8_matvec at D 768, V 51200,
             rows {1, 8, 16, 24, 40, 64, 65}, V 50257 (no multiple of
             the kernel's 64-row tile) at rows {3, 16, 64}, and a bf16
             scale at 8 rows (generate's bf16 decode); the MoE kernels
             on maps from the port's own router at 8192 tokens, E 8,
             k 2, C 2560 (dropped choices and empty slots both real) at
             d in {64, 768, 1024, 2048}, plus all sentinels, 1001 rows,
             k 1 and an f32 weight over bf16 rows, and for moe_gather
             1009 rows (no multiple of a CTA's rows), m 1, n_src 1,
             indices below 0 and above n_src, the combine backward's
             map and (f32) rows of 64 KB (moe_gather bit for bit,
             moe_combine within the registry's tolerance). Then time
             kernel, plain version and one PyTorch library call (a
             yardstick the port never calls: scaled_dot_product_attention,
             F.layer_norm, a dequantized bf16 matmul, F.embedding,
             F.embedding_bag) with CUDA events, the L2 flushed before
             each launch by reading 256 MB, which leaves it clean (the
             MoE kernels' launches also after a reset of the lines
             moe_gather reads under evict_last, which outlive a flush;
             flash_bwd, flash_prefill_chunk and
             paged_decode also with the L2 warm, and flash_bwd by kernel
             from a trace), at the serving shapes (paged_decode at 16
             slots with ctx uniform in 0..511), at the training shape
             (batch 24, seq 1024; flash_fwd also at the K2 shapes,
             non-causal and sq 512 < sk 1024; the layernorm_fused pair
             at the rows the main paths give it, 16, 8 and 128, and at
             24576, L2 flushed and warm, beside its y-only form and one
             trivial launch), at the decode shape
             (batch 8, mean position 191) and at the MoE training
             shape (rows of 768: moe_combine in f32, moe_gather at the
             dispatch in f32 and bf16 and at the combine's backward in
             f32, beside the bytes of reading every valid slot's row
             once, as a gather in slot order with no L2 reuse does);
             int8_matvec at 1, 8, 16, 64 and 128 rows, each beside
             the composed head, the dequantized bf16 matmul and a
             product over an unquantized bf16 table; then at GPT-3
             1.3B's shapes: flash forward and backward at batch 2, seq
             2048 and at the seq-4096 full run's batch 8, seq 4096, 16
             heads of 128 (bf16, causal; the backward twice, bitwise
             equal; at 8 x 4096 the plain versions run a batch row a
             call) and add + LayerNorm with saved statistics
             and the residual carry (layernorm_fwd_saved) at the four
             shapes its main paths give it ([16384, 2048] and [32768,
             2048] in bf16, [16384, 2048] and [24576, 768] with an f32
             stream, a bf16 branch and f32 weights; the carry bit for
             bit, the sum and rstd at the f32 tolerance), each against
             its plain version and timed beside SDPA forward / backward
             or F.layer_norm(x + r) and its bound (the bf16 shapes
             also without the carry), flash_bwd and SDPA's backward
             also in turns (flash_bwd, SDPA, SDPA, flash_bwd);
2a. kernels 13B — the inference add + LayerNorm pair at GPT-3 13B's
             width (1, 8, 16 and 300 rows of 5120 in f32 and bf16, an
             x one element off its allocation, bf16 over f32, 8 rows
             of 5118, 3 of 4104: the kernel's staged form for rows
             wider than 4096) against its plain version, the carry bit
             for bit, timed at 1, 8 and 16 rows of 5120 in bf16 beside
             F.layer_norm(x + r); decode_fused at 40 heads of 128 over
             a bf16 cache at batch 1 and every key count 64..128 of the
             13B recipe's steps (host and device position, the same
             bits), timed at 96 keys beside SDPA over the prefix; the
             build fails if an instance of the staged form spills;
2b. long context — the JAX bench's attn_16k (S 16384, B 1, 16 heads of
             128 and 12 of 64, x = N(0, 1) from RandomState(0)) and the
             single-card leg of its ringattn_128k (S 131072, 16 heads of
             128, x = 0.3 N(0, 1)): the port's
             scaled_dot_product_attention(x, x, x, is_causal=True) in
             bf16 and the gradient of sum(o.float()^2) by x, once
             counted (one flash_fwd and one flash_bwd launch a point),
             its out and gradient held against the f32 math computed in
             query chunks (at 131072 the whole output and the gradient
             at 13 rows: the first, the last and both sides of 64-row
             tile edges), at the registry's bf16 tolerance (2e-2)
             elementwise and per row (the 2-norm of each head's row,
             relative), then forward and forward + backward ms (CUDA
             events, medians), TFLOP/s by the bench's 6 B H S^2 D,
             flash_bwd alone, SDPA's forward, forward + backward and
             backward as yardsticks, bounds, peak memory; an
             out-of-memory fails the smoke;
3. serve   — GPT-3 125M at full width, random weights from --seed (std
             --init-range), in bf16 (--dtype float32 serves in f32, which
             isolates what bf16 rounding changes), through
             ServingEngine(max_slots=16, block_size=16,
             prefill_chunk=128, max_model_len=512): 32 greedy requests of
             16..384 prompt tokens, half sharing a 96-token template, 32
             new tokens each, the decode steps and prefill chunks
             replayed as CUDA graphs captured at the warm-up (the prefix
             index flushed before each run). Every stream must complete;
             the launch counters, zeroed just before, must equal layers
             x decode steps (paged_decode), layers x prefill chunks
             (flash_prefill_chunk) and layers x both (layernorm_fused);
             every stream is teacher-forced through the port's dense f32
             forward on the card (flash_fwd and layernorm_fused in f32).
             Then the same requests through the eager step bodies and the
             captured steps in turns (eager, captured, captured, eager):
             the same tokens every run; tokens/s, decode-step p50/p99
             and prefill-chunk p50 of each; every family captured once
             per key (the capture records), capture ms, the graph pool's
             bytes, and the edges of each captured graph, how many of
             them programmatic (cudaGraphGetEdges_v2): 2 x layers in a
             decode graph (K7 and K10's merge), layers in a prefill
             graph (K7), or the phase fails;
4. profile — device time by kernel over 10 full-batch decode steps
             (torch.profiler), device launches and the host's launch API
             calls (cudaLaunchKernel, cudaLaunchKernelExC,
             cuLaunchKernelEx, cudaGraphLaunch) a step, captured and
             eager; then 16 requests
             served with weights="wo8" over a model quantized with its
             embeddings: every stream completes, int8_matvec launches
             once per decode step and once per prefill chunk, and the
             eager bodies give the same tokens;
4b. serve loop — the engine as a server at the serve phase's shape
             (bf16, init --init-range): `start()` and a
             `ServingHTTPServer` on 127.0.0.1; 8 client threads POST the
             32 serve prompts as JSONL streams, 16 greedy and 16
             sampled with seeds (top_k 50, top_p 0.9, temperature 0.8
             and all three), 32 new tokens each: every stream ends with
             done, the greedy ones pass the teacher-forced bar. Replay
             identity: after a drain (which flushes the prefix index), 4
             sampled requests resubmitted one at a time give their batch
             tokens, and after another flush so do the same 4 through
             the eager step bodies. Step times of full greedy-only and
             sampling
             batches; GET /metrics carries the serving.* histogram and
             gauge series under the exporter's names, /healthz answers
             200. A warm restart: one decode step raises a RuntimeError
             under load (16 streams); serving.restarts is 1, every
             stream completes, the greedy ones pass the bar. drain():
             /healthz 503, /livez 200, the quiesce record balances, the
             pool is quiesced. The launch counters, zeroed before the
             first POST, equal layers x decode steps (paged_decode),
             layers x prefill chunks (flash_prefill_chunk) and layers x
             both (layernorm_fused), the restart's replay included.
             Then prng on the card against the CPU (keys, bits, and 64
             counts of [16, vocab] categorical draws: 0 mismatches), a
             chi-square of 20000 draws from a fixed 8-way distribution
             (p > 1e-3), top_k 1 and a tiny top_p give the argmax, and
             the sampler's device ms and launches a call (torch.profiler)
             against the greedy selection's;
4c. memory — the memory observatory over the CUDA caching allocator, one
             engine at the serve phase's shape (bf16): 16 of the serve
             prompts served with the ledger sampled every step (launch
             counts exact); then a snapshot whose params bucket equals
             the serving copy's parameter and buffer bytes, whose kv
             bucket equals the arenas' bytes, whose total equals
             torch.cuda.memory_reserved() and is the sum of its buckets.
             An engine with hbm_budget_mb below that total sheds:
             submit raises MemoryPressureError and POST /generate
             answers 429 with Retry-After (serving.mem_shed counts
             both). An engine with the card's memory as its budget sheds
             nothing; one of its decode steps asks the allocator for
             twice the card: a real torch.OutOfMemoryError, a postmortem
             record (the old arenas' bytes, num_ooms, the largest
             segments) written before the restart record, one warm
             restart, every stream complete and past the teacher-forced
             bar; each step family recaptured exactly once after it,
             the record's cause naming the arenas. The ledger records
             pass telemetry/ledger_check.py;
4d. fleet  — paddle_tpu_torch.fleet.drill on the card: three replica
             processes (`python -m paddle_tpu_torch.fleet.drill --serve`,
             each an engine at the serve shape, bf16, with its own
             engine_id and ledger) and a fourth behind a router of its
             own (the single-replica baseline), spawned in parallel;
             every replica's weight checksum equals this process's
             reference model's. A FleetRouter over HTTPReplicas in this
             process: the 32 serve prompts as greedy streams (32 new
             tokens), two waves over the three replicas and two over
             the one (best of 2: fleet.rated_throughput_tokens_per_sec
             and fleet.scaling_efficiency); the chaos wave, where the
             replica of the first stream to reach 16 tokens is
             SIGKILLed: every stream completes, every splice balances,
             the tokens streamed before the kill equal the second
             wave's, the router's time to declare the death is printed;
             the victim respawned under a new engine_id; a rolling
             restart of the three under feeder traffic (half greedy,
             half sampled with seeds), zero failures; a last wave
             through a FleetHTTPServer (its /metrics, /healthz and
             /replicas read). Every greedy stream passes the
             teacher-forced bar; the fleet-wide prefix hit rate is above
             0; the concatenated ledger (every incarnation and both
             routers) passes telemetry/ledger_check.py; every replica
             that exited cleanly ran on this card and launched
             layernorm_fused, paged_decode and flash_prefill_chunk;
5. decode  — `generate` on GPT-3 125M (the JAX bench's decode_wo8 shape:
             batch 8, prompt 128 from RandomState(--seed), 128 new tokens,
             greedy, bf16), for three recipes of one model: native,
             quantize_for_decode (int8 linears), and int8 linears +
             embeddings on a copy. Per recipe a warm call and 3 timed
             calls (tokens/s); the launch counters, zeroed before the
             timed calls, must equal layers x 128 x calls (decode_fused),
             128 x calls (int8_matvec, third recipe; 0 otherwise) and
             layers x 129 x calls (layernorm_fused); every stream is
             teacher-forced through the same model's dense f32 forward;
             the token steps are CUDA graphs captured at the warm call.
             Then eager and captured calls in turns (eager, captured,
             captured, eager): the same 8 streams, tokens/s of each; a
             profile of the 32 token steps of a call, captured and
             eager (native and int8-head recipes; device launches and
             host launch calls a step). On the native model one beam
             search (4 beams, 32 tokens) and one top-k/top-p sampling
             call must give valid ids, the same as their eager
             bodies'; every family captured once per key; the bytes
             generate keeps for the native model after its first call
             (weights, loop buffers, graph pool) and what
             `generation.release` frees;
5b. serve 13B — tools/serve_13b_w8a16.py's recipe through the port's
             `paddle_tpu_torch.tools.serve_13b_w8a16`: GPT-3 13B (40
             layers, hidden 5120, 40 heads of 128, vocab 50304) drawn
             in f32 on the card a piece at a time from a CUDA generator
             seeded with --seed (init 0.02), every linear quantized to
             int8 there, floats cast to bf16 (a serving set of ~12.2
             GiB); greedy
             `generate` at batch 1, 64 prompt tokens from
             RandomState(--seed), 64 new, a warm and a timed call. The
             card holds no f32 linear; the serving set's bytes, the
             call's peak, tokens/s beside the bound of reading the set
             once a token; exactly 40 decode_fused and 40
             layernorm_fused launches a token step; the teacher-forced
             bar against the same wo8 model's f32 forward on the card
             (each linear dequantized in f32); generate's kept bytes
             and what `generation.release` frees; then the weights
             scaled to init 0.04 (a stream that varies) and the first
             1..40 blocks decoded in bf16, all 40 in f32 with an f32
             cache, each teacher-forced: a distinct-token floor and
             the trail held at depths 1 and 2 (bf16) and 40 (f32, with
             the agreement too);
5c. moe serve — GPTMoE at the moe train phase's configuration (init
             --init-range) through the engine (the serve phase's
             configuration and 32 requests, captured steps, eager and
             captured in turns) and `generate` (batch 8, prompt 128,
             128 new), in bf16 at capacity factor 1.25 (tokens/s,
             decode-step p50; the teacher-forced agreement printed,
             not held: a token's capacity depends on the rows routed
             with it) and in f32 at a capacity that drops nothing (the
             teacher-forced bar, and every engine run's streams equal);
             `generate` at cf 1.25 in f32 (held) and bf16 (printed),
             its first 32 tokens teacher-forced through a CPU copy of
             the model (plain versions) stepped over the same rows as
             the card's token steps, so every routing call meets the
             card's rows and capacity;
             exactly one moe_gather and one moe_combine a MoE layer in
             every step, chunk and token step; K12 and K13 at 16 and
             128 rows of 768 in bf16 against their plain versions
             (the gather bit for bit), timed;
6. train   — GPT-3 125M at full width (seed 0, init 0.02) through
             TrainStep with AdamW(1e-4, weight decay 0.01): first 2 steps
             in f32 at batch 2, seq 256 on the card and on the CPU (plain
             versions) from the same weights, losses within 1e-4
             relative; then the training shape of the JAX package's
             bench, batch 24 x seq 1024 under bf16 amp, 3 warm-up and 10
             timed steps (tokens/s, step ms, MFU, finite loss; the launch
             counters must equal layers x steps for flash_fwd, flash_bwd
             and layernorm_fwd_saved), and a 10-step profile;
7. moe train — the JAX bench's moe_train: GPT-3 125M with every MLP an
             8-expert top-2 MoEFFN at capacity factor 1.25 (GPTMoE, seed
             0, init 0.02), TrainStep with AdamW(1e-4, weight decay 0.01)
             over GPTMoE.loss (LM + aux + z). First 2 f32 steps at full
             width but 2 layers, batch 2, seq 256, on the card and on the
             CPU from the same weights: losses within 1e-4 relative, the
             tokens whose routing map differs printed (expected 0). Then
             batch 8 x seq 1024 under bf16 amp, 3 warm-up and 10 timed
             steps (tokens/s, step ms, MFU over the active FLOPs, peak
             memory, finite loss, the routing stats; the launch counters
             must equal 2 x layers x steps for moe_gather (the dispatch
             and the combine's backward) and layers x steps for
             moe_combine, flash_fwd, flash_bwd and layernorm_fwd_saved,
             in the f32 steps too), a 3-step profile and the MoE
             regions timed alone;
8. train options — one GPT-3 1.3B-width block (b 1, s 256; loss the
             mean square of its output) for 2 steps on the card and on
             the CPU from the same weights, losses within 1e-4
             relative: Momentum with a global-norm clip (1.0) and a
             warm-up into a cosine schedule, in f32; AdamW over bf16
             parameters with f32 masters; Adamax, Adagrad, Adadelta,
             RMSProp (centered, momentum), Lamb (biases and LayerNorms
             excluded by name), LarsMomentum and DGCMomentum (Nesterov,
             sparse from the second step) in f32, Lamb and Adamax over bf16
             parameters; 4 eager steps of Lookahead(Momentum, k 2) with
             an EMA and of GradientMerge(AdamW, k 2) with a ModelAverage,
             whose apply() losses agree too and whose restore() gives
             every parameter back bit for bit. Then 3 bf16 amp AdamW steps of
             GPT-3 125M at the train shape from one seed: plain, with
             use_fused_ce (losses within 2e-2 relative of plain: one
             bf16 rounding of the logits) and with remat (losses,
             gradients and parameters bit for bit the plain run's: the
             recompute runs the same kernels on the same inputs under
             the caller's amp, and K3-K5 use no atomics); launches exact,
             the remat run's forward kernels twice. Last, optimizer.update
             alone over GPT-3 125M's f32 parameters for SGD, Momentum,
             Adam, AdamW and the seven rules (median of 10, CUDA events)
             beside its bytes bound, and DGC's top-k on the token table;
9. train 1.3B layer — the JAX bench's gpt1_3b_layer: one GPTBlock at
             GPT-3 1.3B's width, x of 8 x 2048 x 2048 (0.02 N(0, 1) from
             RandomState(0)), SGD(1e-6), bf16 amp, 3 warm and 15 timed
             steps: tokens/s, MFU (the bench's 6 layer_params + 12 h seq
             FLOPs a token over 989 TFLOP/s), step ms, peak memory; one
             launch of each training kernel a step;
10. train 1.3B full — the JAX bench's gpt1_3b_full at its width:
             GPT-3 1.3B (8 of its 24 layers, seq 2048, remat,
             use_fused_ce, bf16 amp), OffloadTrainStep with bf16
             parameters and AdamW(1e-4, wd 0.01) whose f32 masters and
             moments sit in pinned host memory, micro-batch 16 x 2048
             and the bench's K 16; cut: 8 layers and 1 warm + 1 timed
             round (the bench's 24 and 2 + 2). First /proc/meminfo's
             MemTotal and MemAvailable (under 16 GB available fails).
             Reports tokens/s and MFU, micro-step and update-round ms
             (and the update's share of a round), the update's copy
             bytes and rate, peak device memory, pinned
             bytes and every round's losses (finite); each micro-step
             launches exactly 16 flash_fwd (8 + 8 recomputed), 8
             flash_bwd and 16 layernorm_fwd_saved (each writing the
             bf16 carry: one device launch a residual site). Then the
             bench's seq-4096 point the same way at 6 layers:
             max_seq_len 4096, micro-batch 8 x 4096 and the bench's K
             8, 1 warm + 1 timed round, the same report, launches of 6
             layers.

11. serving bench — `paddle_tpu_torch.tools.bench_serving` (the JAX
             bench_serving.py's legs) at its card configuration: GPT-3
             125M with wo8 linears (init 0.02, quantized before the
             baseline), 16 slots, block 16, chunk 128, length 512,
             prompts of 126-130 tokens, 128 new; the single-stream
             `generate` baseline (median of 3 sweeps over 3 prompts,
             every length served once first), offered levels 1, 2, 4,
             8 and 16 (two waves each: tokens/s, TTFT and TPOT p50/p99
             from the handles), the level rated at the tool's declared
             SLO (2000 ms p99 TTFT, 20 ms p99 TPOT), the shared-prefix
             leg (32 requests over 2 templates of 96 tokens, warm vs
             cold engine) and the tracing cost at the rated level. Holds:
             every request ends with 128 tokens, the warm prefix streams
             equal the cold ones and the hit rate is > 0, no capture
             inside a timed level, a baseline sweep or a tracing wave,
             each level's launches K7 = 12 x (decode steps + chunks),
             K10 = 12 x decode steps, K11 = 12 x chunks and no other
             kernel, and every record of its JSONL (under
             build/chip_smoke/) passes the port's validator;
12. health — `TrainStep(health=)` and the telemetry runtime: the taps
             (grad norm over the raw grads, update ratio, NaN/Inf
             counts, loss) of 2 f32 AdamW steps at b 2, s 256, full
             width, card against CPU within 1e-4 relative; at the train
             shape (24 x 1024, bf16 amp) ms a step and peak memory with
             taps off, at every_k 4 and at every_k 1, then 12 steps at
             every_k 4 under a TelemetryRecorder (records valid, taps
             on steps 3, 7 and 11); a 3 s host stall past a 1 s
             hang_deadline_s: exactly one black-box dump, a
             MetricsServer's /healthz 503 during it and 200 after; an
             injected NaN with action="raise": HealthError, `nan`, one
             dump; `tools.memwatch --smoke` on the card, no rule firing.
             The memory phase holds the engine's memory rules:
             `hbm_pressure` fires once under the tight budget and nothing
             fires at the card's budget or without one;
13. kernel obs — `telemetry.kernel_obs.measure_registry` over every
             registered kernel at its registry example (the main path's
             shape): median of 60 of the kernel and of its plain
             version (each launch after a read flush, CUDA events),
             `predicted_ms` from the entry's cost() over the H100 SXM
             peaks, the bound and the fraction of it reached, and the
             `kernel_time_drift` verdicts (printed, not held: the
             launch-bound serving shapes sit far from their bounds);
             the records validate and the DB is written to
             build/paddle_tpu_torch/kernel_db.json.
14. distributed — the hybrid-parallel training step
             (`distributed.ShardedTrainStep`) as rank processes through
             `distributed.launch` (`tools/dist_drill.py` jobs, each under
             a hard timeout that kills its ranks): one NCCL rank (the
             collectives of CUDA tensors against their inputs, and the
             step at dp = mp = sp = 1 under ZeRO-0 and -1 bit for bit
             against jit.TrainStep in f32); GPT-3 1.3B's width (2 layers
             of 24 cut, seq 2048, batch 2) on mp 2 x sp 2 as 4 gloo ranks
             sharing the card (after 2 ranks probe which gloo collectives
             take a CUDA tensor themselves: f32 AdamW steps with ring
             (3) and with Ulysses attention (2), within 1e-4 relative
             of the same model's 2 one-process jit.TrainStep steps
             here, 2 bf16-amp ring steps within 2e-2 of f32, 3 f32 ring
             steps with the loss under use_fused_ce (the fused CE over
             each rank's half of the vocab-parallel table) within 1e-5
             of the unfused ring steps' losses with a lower forward
             peak on every rank
             (the step's peak lies in the AdamW update), each
             rank's launches a step exact: K6 one a
             layer, K1/K2 and K3-K5 (i + 1) a layer on ring rank i and one
             a layer under Ulysses); the bench's ringattn_128k over sp 4
             (its out and dx held per head row against one K1/K3 run of
             the whole x here, to 2e-2); GPT-3 125M's width (2 layers,
             seq 1024, batch 4) on dp 2 x mp 2 x sp 2 as 8 gloo ranks
             under ZeRO-0, -1 and -2 (equal parameters, each rank's
             optimizer states half of ZeRO-0's); expert parallelism
             (`ep4`, 4 ranks): GPT-MoE at the bench's width (d 768, E
             8, top-2, 2 layers, 8 x 1024) on ep 4, dp 2 x ep 2 and ep
             2 x mp 2, 2 dropless f32 SGD steps within 1e-5 relative
             of the one-process jit.TrainStep (losses and every
             parameter), capacity-bound moe_ffn_values (cf 1.25) per
             rank within 1e-5 of its blocks run alone, bf16 amp
             within 5e-3 of f32, K12/K13 launches exact (2 and 1 a
             layer a step); the pipeline (`pp4`, 4 ranks): GPT-3 1.3B's
             width as a PipelineLayer (tied embedding, 8 blocks),
             8 micro-batches of 1 x 2048: 1F1B at pp 4, interleaved at
             pp 4 x vpp 2, pp 2 x mp 2, 2 f32 SGD steps within 1e-5
             of the one-process sequential train_batch (losses and
             each stage's parameters), bf16 1F1B within 5e-3, stage
             0's peak at 16 micro-batches within 5 % of its peak at 8
             (4 printed), 1F1B at pp 4 and pp 2 x mp 2 under
             ClipGradByNorm with the health taps at every_k 1, 2 SGD
             steps within 1e-5 (losses) and 1e-4 (parameters) of the
             sequential run with the same clip, which must differ from
             the unclipped run, the taps within 1e-5 of its taps, K1/K3/K6
             launches exact (the rank's blocks x micro-batches); then
             GPipe (`pipeline_apply`) forward and backward through the
             8 blocks stacked at pp 4: rank 2's gradients of the stack
             and of x within 1e-5 of its one-process gradient, every
             rank's the same, K1 twice and K3, K6 and K7 once a block
             a micro-batch (K7 in the forward, which keeps no graph).
             Times
             are of ranks sharing one card over gloo, not scaling
             figures.
15. resilience — ZeRO-3, offload and checkpoints, as rank processes
             (`tools/dist_drill.py` jobs) beside the chaos drill, in
             turn after the 13B phase:
             `zero3_4` (4 ranks): GPT-3 1.3B's width x 2 blocks, 4 x
             2048 on dp 4, f32 AdamW, ZeRO-3 3 steps and ZeRO-2 2
             (every rank's pieces compared with ZeRO-3's after 2
             steps, the sums all-reduced, within 1e-6 relative),
             ZeRO-3 offloaded, 2 steps (bit for bit), bf16 amp, 2
             steps (losses within 2e-2), ZeRO-3 with remat, 3 steps
             (within 1e-6 of ZeRO-3, the same all_gather bytes a step,
             K1 and K6 twice a block; torch._dynamo's import, which
             torch.utils.checkpoint's first call makes, timed before
             it), ZeRO-3 with the health taps at every_k 1, 3 steps
             (each step's stats within 1e-5 of `jit.TrainStep
             (health=)` run first on rank 0, counts equal), dp 2 x mp
             2 with the taps, 2 steps (losses within 1e-5, taps within
             1e-5); each leg's model collected before the next is
             built, and the three f32 ZeRO-3 legs' steps start from
             the same memory (within 16 MiB: nothing of an earlier leg
             left), remat's step peak below ZeRO-3's and the taps' at
             most ZeRO-3's plus their copy, on every rank (each rank's
             step peak, start, what the forward keeps and its peak,
             and the taps' bytes printed);
             between steps each rank's parameter storage is
             exactly its pieces and its states twice that (0 on the
             device and all pinned under offload); rank 0's peak under
             ZeRO-3 below ZeRO-2's; K1/K3/K6 2 a rank a step. The ckpt
             jobs at 2 blocks, dp 4 ZeRO-3, dropout 0.1, a save every 2
             steps: `ckpt4` runs 3 uninterrupted steps, then a run with
             preemption requested on rank 2 alone before its first
             step, after which all four ranks exit 102 at the first
             boundary with step_1 committed; `ckpt4_resume` resumes it
             (direct; the stitched losses and the parameters' digest
             equal the uninterrupted run's) and restores the
             uninterrupted run's step_2 at dp 4 for 2 steps at dropout
             0; `ckpt2_reshard` (dp 2, ZeRO-2) and `ckpt4_reshard` (dp 2
             x mp 2, ZeRO-3), side by side, restore that step_2 through
             the reshard path: every logical leaf bit for bit
             (assembled on rank 0 from the pieces the ranks hold,
             against the saved one), the elastic record, the 2 steps
             within 1e-5 of the direct restore's. The chaos drill
             (`tools/chaos_drill.py`, started with zero3_4, beside which
             it fits at these depths; GPT-3 125M's width x 4 layers, 8 x
             1024, bf16, dropout 0.1, a save every step from step 4, 5 %
             injected I/O faults; the baseline and the crashed run side
             by side): SIGKILL after step 5's save starts, the resume
             from step_4 bit for bit (losses, weights, RNG), a corrupt
             piece named and walked past. The elastic drill
             (`tools/elastic_drill.py`, started beside ckpt4; GPT-3
             125M's width x 2 layers, 4 x 1024, bf16, AdamW, dropout
             0.1): a dp 2 pod of two host processes on the card, host 1
             SIGKILL'd once host 0 has passed step 2 and seen it; host
             0 logs heartbeat_miss, declared_dead (detect_s within the
             heartbeat timeout + 3 polls + 5 s), replan to dp 1 and
             relaunch, drains and exits 101; a relaunch at dp 1 resumes
             via reshard from the drained step with the parameters,
             AdamW slots and RNG equal (digests), 2 finite losses; the
             combined ledger valid with all five elastic events; K1/K3/
             K6 once a layer in every child's every step, no child
             running nvcc. Meanwhile this process builds kvstore.cc
             (g++) and holds `ElasticManager(store=KVClient)` over the
             port's KVServer: HOLD, RESTART at level 1 once a host stops
             heartbeating, EXIT at level 0. Prints step ms, gather,
             reduce-scatter and offload bytes, the offload's GB/s,
             snapshot, commit and restore ms and bytes, and the elastic
             drill's seconds, detect_s, kill-to-exit seconds, drained
             step, resume route, losses and launches.

`--phases kernels_moe,moe_train,kernels_1_3b,kernels_13b,long_context,
serve_13b,moe_serve,options,layer,full,full_4k,memory,serving_bench,
health,kernel_obs,distributed,resilience,elastic` (any of them) runs the
build and the named phases alone and prints no result line; `elastic`
is the store check and the elastic drill alone.

Prints the card's name and power limit (nvidia-smi), the seconds each
phase took, one JSON line of the compiled step against the eager bodies
(serve tokens/s, step p50/p99 and chunk p50, generate tokens/s per
recipe, capture ms, pool bytes, launches a step), a JSON line with
every kernel's launches, error (the largest of all its checks, the
1.3B, 13B and MoE serving shapes' included) and times, a JSON line of
the 1.3B phases, one of the 13B and MoE serving phases, and as its last
line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without a result when CUDA is unavailable or when run
outside a checkout of the repository.
"""
import argparse
import contextlib
import json
import math
import os
import statistics
import sys
import threading
import time

DEVICE = "cuda"
ROOT = os.path.dirname(os.path.abspath(__file__))
# what the smoke writes (bench JSONL, black-box dumps): under build/,
# which git ignores
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")
HBM_BYTES_PER_S = 3.35e12           # H100 SXM, data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12,   # dense tensor-core bf16
                  "float32": 67e12}     # f32 outside the tensor cores

# training shape of GPT-3 125M (the JAX package's gpt_train_bench)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARMUP, TRAIN_STEPS = 24, 1024, 3, 10
# f32 parity of the training step, card against CPU
PARITY_BATCH, PARITY_SEQ, PARITY_STEPS, PARITY_RTOL = 2, 256, 2, 1e-4
# flash checks: (batch, sq, sk, heads, head_dim, causal)
# (1, 130, 190): the forward's last key tile is partial (190 = 2 x 64 +
# 62) and so is its last query tile
FLASH_CHECKS = ((2, 1024, 1024, 12, 64, True), (2, 1024, 1024, 12, 64, False),
                (2, 512, 1024, 12, 64, True), (1, 200, 200, 12, 64, True),
                (1, 300, 700, 12, 64, True), (1, 256, 384, 4, 128, True),
                (1, 130, 190, 12, 64, True))
# the K2 shapes timed beside the training shape: (batch, sq, sk, causal)
FLASH_K2_TIMED = ((TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, False),
                  (TRAIN_BATCH, TRAIN_SEQ // 2, TRAIN_SEQ, True))
# add + LayerNorm checks: (rows, d, x dtype, residual dtype)
LN_CHECKS = ((24576, 768, "float32", "bfloat16"), (24576, 768, "bfloat16",
                                                    "bfloat16"),
             (16, 768, "bfloat16", "bfloat16"), (16, 768, "float32",
                                                 "float32"),
             (24576, 768, "float32", "float32"))
# the inference pair (K7's out and the residual carry from one launch):
# (rows, d, x dtype, residual dtype, unaligned). d 768 takes the kernel's
# 16-byte path, d 770 (no multiple of 4 or 8) and an x one element off
# its allocation the one-element path; 4096 is the widest row it takes
# (16-byte chunks in bf16, one-element in f32)
LN_PAIR_CHECKS = ((16, 768, "bfloat16", "bfloat16", False),
                  (8, 768, "bfloat16", "bfloat16", False),
                  (128, 768, "bfloat16", "bfloat16", False),
                  (300, 768, "float32", "float32", False),
                  (16, 768, "bfloat16", "float32", False),
                  (16, 770, "bfloat16", "bfloat16", False),
                  (16, 770, "float32", "float32", False),
                  (16, 768, "bfloat16", "bfloat16", True),
                  (16, 768, "float32", "float32", True),
                  (3, 4096, "bfloat16", "bfloat16", False),
                  (3, 4096, "float32", "float32", False),
                  (24576, 768, "bfloat16", "bfloat16", False))

# serving shapes of GPT-3 125M in the engine configuration below
N_HEADS, HEAD_DIM, BLOCK, MAX_BLOCKS, SLOTS, CHUNK = 12, 64, 16, 32, 16, 128
# block edges (16 keys) and paged_decode's chunk edges (32 keys)
CTX_EDGES = (0, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 255, 256, 511)
P0S = (0, 7, 128, 384, 400)      # 400: the chunk runs past key 511
TIMED_P0 = 128
ENGINE = dict(max_slots=SLOTS, block_size=BLOCK, prefill_chunk=CHUNK,
              max_model_len=BLOCK * MAX_BLOCKS)
# generate's shapes on GPT-3 125M (the JAX bench's decode_wo8): a step
# at position p attends keys 0..p; the timed kernel sits at the mean
# position of the 128 steps
DEC_BATCH, DEC_PROMPT, DEC_NEW, DEC_CALLS = 8, 128, 128, 3
DEC_PROFILED = 32           # token steps a decode profile covers
DEC_LEN = DEC_PROMPT + DEC_NEW
DEC_OFFS = (0, 7, 63, 64, 127, 128, 135, 136, 191, 200, 255)
DEC_TIMED_OFF = DEC_PROMPT + (DEC_NEW - 1) // 2
# key counts of decode_fused's device-position checks: the one-chunk
# edge (128/129) and the cluster path's 32- and 64-key edges
DEVICE_KEYS = (1, 32, 33, 64, 65, 128, 129, 136, 200, DEC_LEN)
# the int8 head: GPT-3 125M's vocab 50304 padded to a multiple of 1024
I8_V, I8_D = 51200, 768
I8_ROWS = (1, 8, 16, 24, 40, 64, 65)
I8_RAGGED_V, I8_RAGGED_ROWS = 50257, (3, 16, 64)
I8_TIMED_ROWS = (1, 8, 16, 64, 128)
# the MoE training shape (the JAX bench's moe_train, bench.py:712-771):
# GPT-3 125M with every MLP an 8-expert top-2 MoEFFN at capacity factor
# 1.25, batch 8 x seq 1024 under bf16 amp
MOE_E, MOE_K, MOE_CF = 8, 2, 1.25
MOE_BATCH, MOE_SEQ, MOE_WARMUP, MOE_STEPS = 8, 1024, 3, 10
MOE_PROFILE_STEPS = 3
# f32 parity of the MoE step, card against CPU: full width, 2 layers
MOE_PARITY_LAYERS = 2
# row widths the kernels are held at (768 is GPT-3 125M's)
MOE_WIDTHS = (64, 768, 1024, 2048)
# Random weights: GPT's initializer at this std. At width 768 the
# attention logits' spread grows with the square of the std: at the
# default 0.02 attention is near uniform and greedy streams repeat one
# token; from ~0.07 it is so sharp that bf16 rounding flips which keys
# win and the bf16 and f32 streams part ways. 0.055 lies between:
# streams vary and bf16 tracks f32.
INIT_RANGE = 0.055
# bf16 engine vs f32 dense forward over the same tokens, every stream:
# the engine's token must be the f32 argmax at >= 95% of positions, and
# never trail the f32 best logit by more than this many standard
# deviations of that position's logits. bf16 keeps 8 significant bits;
# where it flips a greedy choice the two logits were near-tied, while a
# wrong attention or cache moves logits by whole standard deviations.
TF_AGREE = 0.95
TF_MARGIN_STD = 0.25
# the streams must not be one token repeated, or token agreement says
# little: at most a quarter constant, >= 4 distinct tokens on average
MAX_CONSTANT_FRAC = 0.25
MIN_MEAN_DISTINCT = 4.0


# device kernels by what they do, matched on a substring of their name
PROFILE_CATEGORIES = (
    ("port: flash attention", ("fwd_wgmma", "dkdv_wgmma", "dq_wgmma",
                               "bwd_delta", "fwd_f32", "dkdv_f32",
                               "dq_f32")),
    ("port: add + LayerNorm", ("add_ln",)),
    ("port: paged attention", ("paged_decode", "flash_prefill")),
    ("port: decode attention", ("decode_attention",)),
    ("port: int8 matvec", ("int8_matvec",)),
    ("port: moe gather (K12)", ("moe_gather",)),
    ("port: moe combine (K13)", ("moe_combine",)),
    ("index_add (moe backward scatters)", ("indexFunc",)),
    ("sorts and scans (router)", ("sort", "Sort", "scan", "Scan")),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("reductions", ("reduce_kernel",)),
    ("copies and casts", ("copy",)),
    ("indexing", ("index", "gather", "scatter")),
    ("other elementwise", ("elementwise",)),
)


# the kernels whose registers, spills and static shared memory the build
# prints (their dynamic shared memory is in their source notes)
PTXAS_SHOWN = ("fwd_wgmma", "dkdv_wgmma", "dq_wgmma", "bwd_delta",
               "flash_prefill_mma", "paged_decode_split",
               "paged_decode_merge", "decode_attention_split",
               "int8_matvec_wgmma")


def print_pair_ptxas(_build):
    """The add + LayerNorm kernels have one instance per dtype triple and
    width class: print, for the saving form (add_ln, K6), the inference
    pair (add_ln_pair, K7) and K7's form for rows wider than 4096
    (add_ln_pair_wide), their register range and which spill (by their
    mangled template arguments), from the report kept beside the built
    library. An add_ln or add_ln_pair_wide instance that spills, or no
    report, fails: K6 runs on every training path at widths up to 4096,
    the wide K7 on GPT-3 13B's decode path (add_ln_pair's spills at d >
    1024 are reported only)."""
    info = _build.ptxas_info("add_layer_norm")
    for kernel in ("add_ln", "add_ln_pair", "add_ln_pair_wide"):
        mark = kernel + "I"
        inst = {fn: i for fn, i in info.items() if mark in fn}
        if not inst:
            raise AssertionError(f"{kernel}: no ptxas report for its "
                                 "instances")
        regs = [i.get("registers", 0) for i in inst.values()]
        spill = sorted(fn.split(mark, 1)[1].split("EEEv")[0]
                       for fn, i in inst.items()
                       if i.get("spills", (0, 0)) != (0, 0))
        print(f"build: ptxas add_layer_norm: {len(inst)} {kernel} "
              f"instances, {min(regs)}-{max(regs)} registers, "
              f"{len(spill)} spill: {spill}")
        if kernel != "add_ln_pair" and spill:
            raise AssertionError(f"{kernel}: {len(spill)} of {len(inst)} "
                                 f"instances spill: {spill}")


def card_line():
    from paddle_tpu_torch.device import card_line
    return card_line()


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def decode_inputs(torch, gen, dtype, dev, edges=True):
    """16 slots over a 513-block arena: with `edges` the context edges,
    an inactive slot (ctx 0, all-null table) and the rest uniform in
    0..511; else all 16 uniform in 0..511 (a serving step, timed)."""
    L = BLOCK * MAX_BLOCKS
    ctx = list(CTX_EDGES) + [-1] if edges else []
    ctx += torch.randint(0, L, (SLOTS - len(ctx),), generator=gen,
                         device="cpu").tolist()
    nb = SLOTS * MAX_BLOCKS + 1
    perm = torch.randperm(nb - 1, generator=gen, device="cpu") + 1
    tables = torch.zeros((SLOTS, MAX_BLOCKS), dtype=torch.int32)
    for s, c in enumerate(ctx):
        if c < 0:
            continue                            # the inactive slot
        n = c // BLOCK + 1
        tables[s, :n] = perm[s * MAX_BLOCKS:s * MAX_BLOCKS + n]
    ctx = [max(c, 0) for c in ctx]
    nh = N_HEADS * HEAD_DIM
    q = torch.randn((SLOTS, 1, nh), generator=gen, device="cpu")
    kp = torch.randn((nb, BLOCK, nh), generator=gen, device="cpu")
    vp = torch.randn((nb, BLOCK, nh), generator=gen, device="cpu")
    to = dict(device=dev, dtype=dtype)
    return (q.to(**to), kp.to(**to), vp.to(**to), tables.to(dev),
            torch.tensor(ctx, dtype=torch.int32, device=dev))


def prefill_inputs(torch, gen, dtype, dev, p0):
    nb = MAX_BLOCKS + 8
    nh = N_HEADS * HEAD_DIM
    n = min((p0 + CHUNK - 1) // BLOCK + 1, MAX_BLOCKS)
    row = torch.zeros((MAX_BLOCKS,), dtype=torch.int32)
    row[:n] = (torch.randperm(nb - 1, generator=gen) + 1)[:n]
    q = torch.randn((1, CHUNK, nh), generator=gen)
    kp = torch.randn((nb, BLOCK, nh), generator=gen)
    vp = torch.randn((nb, BLOCK, nh), generator=gen)
    to = dict(device=dev, dtype=dtype)
    return q.to(**to), kp.to(**to), vp.to(**to), row.to(dev), p0


def hold(name, got, ref, tol):
    """Elementwise |got - ref| <= atol + rtol |ref|; returns max error."""
    rtol, atol = tol
    err = (got.float() - ref.float()).abs()
    bad = err > atol + rtol * ref.float().abs()
    if not bool(got.isfinite().all()) or bool(bad.any()):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version "
            f"(max abs err {err.max().item():.3e}, {int(bad.sum())} "
            f"elements outside rtol={rtol} atol={atol})")
    return err.max().item()


def l2_flush(torch, dev):
    """256 MB of f32 zeros whose reading overwrites the card's 50 MB L2
    (`median_ms`'s `flush`)."""
    return torch.zeros(64 * 2 ** 20, device=dev)


def median_ms(torch, fn, flush, reps=60, warmup=5, spin=None,
              dirty=False, before=None):
    """Median of per-launch CUDA-event times; the L2 is overwritten
    before every launch by reading `flush` (`l2_flush`: a sum into a
    scalar), so each launch reads its inputs from device memory and the
    L2 holds no dirty lines. `dirty` flushes by zeroing `flush` instead:
    ~50 MB of dirty lines stay, and the timed launch's reads pay for
    their write-backs (cuBLAS over a bf16 table reads ~2.2 TB/s there,
    ~2.7 after a read). With `flush` None the L2 stays warm, as in a
    step: the card spins ~0.1 ms instead, so that the host has queued
    the launch before the first event is reached and the time is the
    kernel's, not the host's. `spin` sets the spin in clock cycles (by
    default 200000 when warm, none after a flush): a call that enqueues
    several launches needs more, or the card waits for the host.
    `before`, when given, runs on the host before each flush."""
    if spin is None:
        spin = 200_000 if flush is None else 0
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        if before is not None:
            before()
        if flush is not None:
            if dirty:
                flush.zero_()
            else:
                flush.sum()
        if spin:
            torch.cuda._sleep(spin)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def decode_work(ctx, itemsize):
    """Bytes and operations paged_decode needs for these inputs: q, the
    ctx+1 K and V rows of every head, the table and ctx, the output."""
    L = BLOCK * MAX_BLOCKS
    nh = N_HEADS * HEAD_DIM
    keys = sum(min(int(c), L - 1) + 1 for c in ctx)
    nbytes = (2 * keys * nh + 2 * SLOTS * nh) * itemsize \
        + (SLOTS * MAX_BLOCKS + SLOTS) * 4
    return nbytes, 4 * keys * nh


def prefill_work(p0, itemsize):
    L = BLOCK * MAX_BLOCKS
    nh = N_HEADS * HEAD_DIM
    span = min(p0 + CHUNK - 1, L - 1) + 1
    pairs = sum(min(p0 + i, L - 1) + 1 for i in range(CHUNK))
    nbytes = (2 * span * nh + 2 * CHUNK * nh) * itemsize + MAX_BLOCKS * 4
    return nbytes, 4 * pairs * nh


def sdpa_decode(torch, q, kp, vp, tables, ctx):
    """Yardstick inputs: the pages gathered dense, a boolean mask."""
    L = BLOCK * MAX_BLOCKS
    S = q.shape[0]
    k = kp[tables.long()].reshape(S, L, N_HEADS, HEAD_DIM).transpose(1, 2)
    v = vp[tables.long()].reshape(S, L, N_HEADS, HEAD_DIM).transpose(1, 2)
    qq = q.reshape(S, 1, N_HEADS, HEAD_DIM).transpose(1, 2).contiguous()
    mask = (torch.arange(L, device=q.device)[None, :]
            <= ctx.long()[:, None])[:, None, None, :]
    return qq, k.contiguous(), v.contiguous(), mask


def sdpa_prefill(torch, q, kp, vp, row, p0):
    L = BLOCK * MAX_BLOCKS
    k = kp[row.long()].reshape(1, L, N_HEADS, HEAD_DIM).transpose(1, 2)
    v = vp[row.long()].reshape(1, L, N_HEADS, HEAD_DIM).transpose(1, 2)
    qq = q.reshape(1, CHUNK, N_HEADS, HEAD_DIM).transpose(1, 2).contiguous()
    pos = p0 + torch.arange(CHUNK, device=q.device)
    mask = (torch.arange(L, device=q.device)[None, :]
            <= pos[:, None])[None, None]
    return qq, k.contiguous(), v.contiguous(), mask


def kernels_phase(torch, seed):
    from paddle_tpu_torch.ops.kernel_registry import get_kernel
    from paddle_tpu_torch.ops.paged_attention import (
        flash_prefill_chunk, flash_prefill_plain, paged_decode_attention,
        paged_decode_plain)
    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    dec, pre = get_kernel("paged_decode"), get_kernel("flash_prefill_chunk")
    errs = {}
    for dtype, dname in ((torch.float32, "float32"),
                         (torch.bfloat16, "bfloat16")):
        args = decode_inputs(torch, gen, dtype, dev)
        got = paged_decode_attention(*args, N_HEADS)
        ref = paged_decode_plain(*args, N_HEADS)
        torch.cuda.synchronize()
        errs[("paged_decode", dname)] = hold(
            f"paged_decode[{dname}]", got, ref, dec.tol[dname])
        for p0 in P0S:
            pargs = prefill_inputs(torch, gen, dtype, dev, p0)
            got = flash_prefill_chunk(*pargs, N_HEADS)
            ref = flash_prefill_plain(*pargs, N_HEADS)
            # p0 read from device memory (the engine's captured chunk):
            # the same bits as the host argument
            p0_dev = torch.full((), p0, dtype=torch.int32, device=dev)
            got_dev = flash_prefill_chunk(*pargs[:4], p0_dev, N_HEADS)
            torch.cuda.synchronize()
            e = hold(f"flash_prefill_chunk[{dname}, p0={p0}]", got, ref,
                     pre.tol[dname])
            if not same_bits(torch, got, got_dev):
                raise AssertionError(f"flash_prefill_chunk[{dname}, "
                                     f"p0={p0}]: a device p0 differs")
            key = ("flash_prefill_chunk", dname)
            errs[key] = max(errs.get(key, 0.0), e)
    for (name, dname), e in sorted(errs.items()):
        print(f"kernels: {name} {dname} max_abs_err {e:.3e} "
              f"(tol rtol, atol = {get_kernel(name).tol[dname]})")
    print(f"kernels: flash_prefill_chunk with p0 read from device memory: "
          f"the host launch's bits at p0 {list(P0S)}, f32 and bf16")

    # timing at the serving shapes, in the engine's bf16: paged_decode
    # at a decode step of 16 slots with ctx uniform in 0..511, L2 flushed
    # and warm (as in a step, where the arenas' rows were just written)
    flush = l2_flush(torch, dev)
    rows = {}
    args = decode_inputs(torch, torch.Generator().manual_seed(seed + 3),
                         torch.bfloat16, dev, edges=False)
    sd = sdpa_decode(torch, *args)
    nbytes, ops = decode_work(args[4].tolist(), 2)

    def sdpa():
        return F.scaled_dot_product_attention(sd[0], sd[1], sd[2],
                                              attn_mask=sd[3])
    rows["paged_decode"] = dict(
        ms=median_ms(torch, lambda: paged_decode_attention(*args, N_HEADS),
                     flush),
        warm_ms=median_ms(
            torch, lambda: paged_decode_attention(*args, N_HEADS), None),
        plain_ms=median_ms(torch, lambda: paged_decode_plain(*args, N_HEADS),
                           flush),
        library_ms=median_ms(torch, sdpa, flush),
        library_warm_ms=median_ms(torch, sdpa, None),
        bound=bound(nbytes, ops, "bfloat16"),
        max_abs_err=errs[("paged_decode", "bfloat16")])
    print(f"kernels: paged_decode timed at S={SLOTS}, ctx "
          f"{args[4].tolist()} (mean {sum(args[4].tolist()) / SLOTS:.1f}): "
          f"{nbytes} bytes, {ops} ops")
    for p0 in P0S:
        pargs = prefill_inputs(torch, gen, torch.bfloat16, dev, p0)
        sp = sdpa_prefill(torch, *pargs)
        nbytes, ops = prefill_work(p0, 2)
        row = dict(
            ms=median_ms(torch, lambda: flash_prefill_chunk(*pargs, N_HEADS),
                         flush),
            warm_ms=median_ms(
                torch, lambda: flash_prefill_chunk(*pargs, N_HEADS), None),
            plain_ms=median_ms(
                torch, lambda: flash_prefill_plain(*pargs, N_HEADS), flush),
            library_ms=median_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    sp[0], sp[1], sp[2], attn_mask=sp[3]), flush),
            bound=bound(nbytes, ops, "bfloat16"),
            max_abs_err=errs[("flash_prefill_chunk", "bfloat16")])
        print(f"kernels: flash_prefill_chunk p0={p0} C={CHUNK}: "
              f"{row['ms']:.4f} ms (L2 warm {row['warm_ms']:.4f}; plain "
              f"{row['plain_ms']:.4f}, sdpa "
              f"{row['library_ms']:.4f}, bound {row['bound'][0]:.5f} by "
              f"{row['bound'][1]}; {nbytes} bytes, {ops} ops)")
        if p0 == TIMED_P0:
            rows["flash_prefill_chunk"] = row
    r = rows["paged_decode"]
    print(f"kernels: paged_decode: {r['ms']:.4f} ms (L2 warm "
          f"{r['warm_ms']:.4f}; plain {r['plain_ms']:.4f}, sdpa "
          f"{r['library_ms']:.4f}, warm {r['library_warm_ms']:.4f}; bound "
          f"{r['bound'][0]:.5f} by {r['bound'][1]})")
    del flush
    return rows


def flash_inputs(torch, gen, dtype, dev, b, sq, sk, n, h):
    """q, k, v and a random dout; for self-attention q, k, v are the
    `unbind` views of one [b, s, 3, n, h] tensor, as the GPT's fused qkv
    projection hands them to the kernels."""
    to = dict(device=dev, dtype=dtype)
    dout = torch.randn((b, sq, n, h), generator=gen).to(**to)
    if sq == sk:
        q, k, v = torch.randn((b, sq, 3, n, h), generator=gen).to(
            **to).unbind(dim=2)
    else:
        q = torch.randn((b, sq, n, h), generator=gen).to(**to)
        k, v = (torch.randn((b, sk, n, h), generator=gen).to(**to)
                for _ in range(2))
    return q, k, v, dout


def flash_work(b, sq, sk, n, h, causal, itemsize, backward):
    """Bytes and operations of attention over these shapes: each input
    read once, each output written once; 4h flops per visible (query,
    key) pair forward, 10h backward (S and dP recomputed, dV, dK, dQ)."""
    pairs = sq * sk if not causal else sum(
        min(i + sk - sq + 1, sk) for i in range(sq))
    pairs *= b * n
    qo = b * sq * n * h * itemsize
    kv = b * sk * n * h * itemsize
    lse = b * n * sq * 4
    if backward:    # q, k, v, out, dout, lse in; dq, dk, dv out
        return 4 * qo + 4 * kv + lse, 10 * h * pairs
    return 2 * qo + 2 * kv + lse, 4 * h * pairs


def bwd_parts(torch, fn, flush, calls=10):
    """Device ms a call of each of flash_bwd's three kernels (delta,
    dK/dV, dQ), from torch.profiler over `calls` calls, the L2 flushed
    before each (`median_ms`'s read)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.sum()
            fn()
        torch.cuda.synchronize()
    parts = {}
    for e in device_events(prof):
        for name in ("bwd_delta", "dkdv_wgmma", "dq_wgmma"):
            if name in e.key:
                parts[name] = parts.get(name, 0.0) \
                    + e.self_device_time_total / 1e3 / calls
    return parts


def ln_work(rows, d, x_size, r_size, w_size, save, carry=False):
    """Bytes and operations of add + LayerNorm: x, r, w, b in, out (and
    the f32 sum and rstd, or the carry in x's dtype) out; ~8 flops per
    element."""
    nbytes = rows * d * (2 * x_size + r_size) + 2 * d * w_size
    if save:
        nbytes += rows * d * 4 + rows * 4
    if carry:
        nbytes += rows * d * x_size
    return nbytes, 8 * rows * d


def same_bits(torch, a, b):
    """a and b hold the same bits (dtype, shape and every element)."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(ints[a.dtype]), b.view(ints[b.dtype]))


def ln_pair_checks(torch, gen, dev, checks=LN_PAIR_CHECKS):
    """The inference pair of add + LayerNorm against its plain version at
    `checks` (LN_PAIR_CHECKS' layout): out within the registry's
    tolerance, the carry bit for bit the plain one's and torch's x +
    residual; -> {x dtype: max abs error of out}."""
    from paddle_tpu_torch.ops.kernel_registry import get_kernel
    from paddle_tpu_torch.ops.layernorm import (layernorm_fused_pair,
                                                layernorm_fused_pair_plain)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    errs = {}
    for rows, d, xd, rd, unaligned in checks:
        tag = (f"[pair {rows}x{d}, x {xd}, residual {rd}"
               f"{', x unaligned' if unaligned else ''}]")
        x = torch.randn((rows * d + 1,), generator=gen).to(dev, dts[xd])
        x = (x[1:] if unaligned else x[:-1]).view(rows, d)
        r = torch.randn((rows, d), generator=gen).to(dev, dts[rd])
        w = (1 + 0.1 * torch.randn((d,), generator=gen)).to(dev, dts[xd])
        bb = (0.1 * torch.randn((d,), generator=gen)).to(dev, dts[xd])
        y, h = layernorm_fused_pair(x, r, w, bb)
        ry, rh = layernorm_fused_pair_plain(x, r, w, bb)
        torch.cuda.synchronize()
        errs[xd] = max(errs.get(xd, 0.0), hold(
            "layernorm_fused pair out" + tag, y, ry,
            get_kernel("layernorm_fused").tol[xd]))
        # the carry is one rounding of the same f32 sum: bit for bit
        if not (same_bits(torch, h, rh)
                and same_bits(torch, h, (x + r).to(x.dtype))):
            raise AssertionError(f"layernorm_fused pair carry{tag}: not bit "
                                 "for bit x + residual")
    return errs


def train_kernels_phase(torch, seed):
    """The training path's kernels against their plain versions, then
    timed at the training shape (batch 24, seq 1024, 12 heads of 64)."""
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_plain, flash_attention_fwd_plain, flash_bwd,
        flash_fwd)
    from paddle_tpu_torch.ops.kernel_registry import get_kernel
    from paddle_tpu_torch.ops.layernorm import (
        layernorm_fused, layernorm_fused_pair, layernorm_fused_pair_plain,
        layernorm_fused_plain, layernorm_fwd_saved, layernorm_plain)
    F = torch.nn.functional
    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(seed + 7)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    errs = {}

    def note(name, dname, e):
        errs[(name, dname)] = max(errs.get((name, dname), 0.0), e)

    for b, sq, sk, n, h, causal in FLASH_CHECKS:
        scale = 1.0 / math.sqrt(h)
        for dname, dtype in dts.items():
            tol = get_kernel("flash_fwd").tol[dname]
            tag = (f"[{dname}, b={b} sq={sq} sk={sk} n={n} h={h} "
                   f"causal={causal}]")
            q, k, v, dout = flash_inputs(torch, gen, dtype, dev, b, sq, sk,
                                         n, h)
            out, lse = flash_fwd(q, k, v, causal, scale)
            rout, rlse = flash_attention_fwd_plain(q, k, v, causal, scale)
            torch.cuda.synchronize()
            note("flash_fwd", dname, max(
                hold("flash_fwd out" + tag, out, rout, tol),
                hold("flash_fwd lse" + tag, lse, rlse, tol)))
            # both backwards from the same (plain) forward outputs
            got = flash_bwd(q, k, v, rout, rlse, dout, causal, scale)
            ref = flash_attention_bwd_plain(q, k, v, rout, rlse, dout,
                                            causal, scale)
            again = flash_bwd(q, k, v, rout, rlse, dout, causal, scale)
            torch.cuda.synchronize()
            note("flash_bwd", dname, max(
                hold(f"flash_bwd d{nm}" + tag, g, r, tol)
                for nm, g, r in zip("qkv", got, ref)))
            # no atomics: a second call on the same inputs is bitwise equal
            for nm, g, a in zip("qkv", got, again):
                if not torch.equal(g, a):
                    raise AssertionError(f"flash_bwd d{nm}{tag}: two calls "
                                         "on the same inputs differ")
    for rows, d, xd, rd in LN_CHECKS:
        tag = f"[{rows}x{d}, x {xd}, residual {rd}]"
        x = torch.randn((rows, d), generator=gen).to(dev, dts[xd])
        r = torch.randn((rows, d), generator=gen).to(dev, dts[rd])
        w = (1 + 0.1 * torch.randn((d,), generator=gen)).to(dev, dts[xd])
        bb = (0.1 * torch.randn((d,), generator=gen)).to(dev, dts[xd])
        tol = get_kernel("layernorm_fwd_saved").tol[xd]
        f32tol = get_kernel("layernorm_fwd_saved").tol["float32"]
        got = layernorm_fwd_saved(x, r, w, bb)
        ref = layernorm_plain(x, r, w, bb)
        got_o = layernorm_fused(x, r, w, bb)
        ref_o = layernorm_fused_plain(x, r, w, bb)
        torch.cuda.synchronize()
        note("layernorm_fwd_saved", xd, max(
            hold("layernorm_fwd_saved out" + tag, got[0], ref[0], tol),
            hold("layernorm_fwd_saved sum" + tag, got[1], ref[1], f32tol),
            hold("layernorm_fwd_saved rstd" + tag, got[2], ref[2], f32tol)))
        note("layernorm_fused", xd,
             hold("layernorm_fused" + tag, got_o, ref_o, tol))
    for xd, e in ln_pair_checks(torch, gen, dev).items():
        note("layernorm_fused", xd, e)
    for (name, dname), e in sorted(errs.items()):
        print(f"kernels: {name} {dname} max_abs_err {e:.3e} "
              f"(tol rtol, atol = {get_kernel(name).tol[dname]})")

    # timing at the training shape, in bf16 as the amp step runs it
    flush = l2_flush(torch, dev)
    rows = {}
    b, s, n, h = TRAIN_BATCH, TRAIN_SEQ, N_HEADS, HEAD_DIM
    scale = 1.0 / math.sqrt(h)
    q, k, v, dout = flash_inputs(torch, gen, torch.bfloat16, dev, b, s, s,
                                 n, h)
    out, lse = flash_fwd(q, k, v, True, scale)
    lq, lk, lv = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    with torch.no_grad():
        lib_fwd = median_ms(torch, lambda: F.scaled_dot_product_attention(
            lq, lk, lv, is_causal=True), flush)
    lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
    go = dout.transpose(1, 2).contiguous()
    rows["flash_fwd"] = dict(
        ms=median_ms(torch, lambda: flash_fwd(q, k, v, True, scale), flush),
        plain_ms=median_ms(torch, lambda: flash_attention_fwd_plain(
            q, k, v, True, scale), flush, reps=20),
        library_ms=lib_fwd,
        bound=bound(*flash_work(b, s, s, n, h, True, 2, False), "bfloat16"),
        max_abs_err=errs[("flash_fwd", "bfloat16")])
    rows["flash_bwd"] = dict(
        ms=median_ms(torch, lambda: flash_bwd(q, k, v, out, lse, dout, True,
                                              scale), flush),
        warm_ms=median_ms(torch, lambda: flash_bwd(q, k, v, out, lse, dout,
                                                   True, scale), None),
        plain_ms=median_ms(torch, lambda: flash_attention_bwd_plain(
            q, k, v, out, lse, dout, True, scale), flush, reps=10),
        library_ms=median_ms(torch, lambda: torch.autograd.grad(
            lo, (lq, lk, lv), go, retain_graph=True), flush),
        bound=bound(*flash_work(b, s, s, n, h, True, 2, True), "bfloat16"),
        max_abs_err=errs[("flash_bwd", "bfloat16")])
    print("kernels: flash_bwd at the training shape by kernel (L2 flushed, "
          "ms a call): " + json.dumps(bwd_parts(
              torch, lambda: flash_bwd(q, k, v, out, lse, dout, True, scale),
              flush)))
    del lo, lq, lk, lv, go, q, k, v, dout, out, lse
    # the forward at the K2 shapes (non-causal; causal with sk > sq,
    # whose bottom-right mask SDPA takes as an explicit mask)
    for kb, ksq, ksk, kcausal in FLASH_K2_TIMED:
        q, k, v, _ = flash_inputs(torch, gen, torch.bfloat16, dev, kb, ksq,
                                  ksk, n, h)
        lq, lk, lv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = None
        if kcausal:
            mask = torch.ones((ksq, ksk), dtype=torch.bool,
                              device=dev).tril(ksk - ksq)
        ms = median_ms(torch, lambda: flash_fwd(q, k, v, kcausal, scale),
                       flush)
        lib = median_ms(torch, lambda: F.scaled_dot_product_attention(
            lq, lk, lv, attn_mask=mask), flush)
        kbound = bound(*flash_work(kb, ksq, ksk, n, h, kcausal, 2, False),
                       "bfloat16")
        print(f"kernels: flash_fwd (K2) b={kb} sq={ksq} sk={ksk} "
              f"causal={kcausal}: {ms:.4f} ms (sdpa {lib:.4f}, bound "
              f"{kbound[0]:.5f} by {kbound[1]})")
        del q, k, v, lq, lk, lv

    # add + LayerNorm: the saving form at the training step's dtypes (f32
    # residual stream, bf16 branch output, f32 weights); the inference
    # pair in bf16 at the rows the main paths launch it with — a serve
    # decode step's 16 (its `kernels` row), a generate step's 8, a
    # prefill chunk's 128 — and at the training rows, L2 flushed and
    # warm, beside its y-only form, F.layer_norm(x + r) (which gives the
    # same pair in two launches) and one trivial launch (a one-element
    # fill), the floor under the short ones
    rows_t, d = TRAIN_BATCH * TRAIN_SEQ, N_HEADS * HEAD_DIM

    def ln_args(nrows, xdt, rdt):
        return (torch.randn((nrows, d), generator=gen).to(dev, xdt),
                torch.randn((nrows, d), generator=gen).to(dev, rdt),
                (1 + 0.1 * torch.randn((d,), generator=gen)).to(dev, xdt),
                (0.1 * torch.randn((d,), generator=gen)).to(dev, xdt))

    def ln_library(a):
        return lambda: F.layer_norm(a[0] + a[1], (d,), a[2], a[3])

    a = ln_args(rows_t, torch.float32, torch.bfloat16)
    rows["layernorm_fwd_saved"] = dict(
        ms=median_ms(torch, lambda: layernorm_fwd_saved(*a), flush),
        plain_ms=median_ms(torch, lambda: layernorm_plain(*a), flush),
        library_ms=median_ms(torch, ln_library(a), flush),
        bound=bound(*ln_work(rows_t, d, 4, 2, 4, True), "bfloat16"),
        max_abs_err=errs[("layernorm_fwd_saved", "float32")])
    one = torch.zeros(1, device=dev)
    floor_ms = median_ms(torch, lambda: one.fill_(1.0), flush)
    warm_floor_ms = median_ms(torch, lambda: one.fill_(1.0), None)
    print(f"kernels: one trivial launch (a one-element fill): "
          f"{floor_ms:.5f} ms, L2 warm {warm_floor_ms:.5f}")
    for nrows in (SLOTS, DEC_BATCH, CHUNK, rows_t):
        a = ln_args(nrows, torch.bfloat16, torch.bfloat16)
        row = dict(
            ms=median_ms(torch, lambda: layernorm_fused_pair(*a), flush),
            warm_ms=median_ms(torch, lambda: layernorm_fused_pair(*a),
                              None),
            y_only_ms=median_ms(torch, lambda: layernorm_fused(*a), flush),
            plain_ms=median_ms(torch, lambda: layernorm_fused_pair_plain(
                *a), flush),
            library_ms=median_ms(torch, ln_library(a), flush),
            warm_library_ms=median_ms(torch, ln_library(a), None),
            bound=bound(*ln_work(nrows, d, 2, 2, 2, False, carry=True),
                        "bfloat16"),
            max_abs_err=errs[("layernorm_fused", "bfloat16")],
            launch_floor_ms=floor_ms)
        print(f"kernels: layernorm_fused pair {nrows}x{d} bf16: "
              f"{row['ms']:.5f} ms, L2 warm {row['warm_ms']:.5f} (y only "
              f"{row['y_only_ms']:.5f}, plain {row['plain_ms']:.4f}, "
              f"F.layer_norm(x + r) {row['library_ms']:.5f}, L2 warm "
              f"{row['warm_library_ms']:.5f}, bound {row['bound'][0]:.5f} "
              f"by {row['bound'][1]})")
        rows.setdefault("layernorm_fused", row)
    for name in ("flash_fwd", "flash_bwd", "layernorm_fwd_saved"):
        r = rows[name]
        warm = f", L2 warm {r['warm_ms']:.4f}" if "warm_ms" in r else ""
        print(f"kernels: {name} at the training shape: {r['ms']:.4f} ms"
              f"{warm} (plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}, bound {r['bound'][0]:.5f} by "
              f"{r['bound'][1]})")
    del flush
    return rows


def device_position_checks(torch, gen, dev, k8, note):
    """decode_fused with q's position read from device memory, as
    generate's captured token step launches it: at every key count of
    DEVICE_KEYS and every chunk count that leaves each chunk a key, the
    launch inside a CUDA graph (replayed after the position buffer moved
    away and back) gives the bits of the same launch outside it, and,
    at decode_split's own chunk count, of the host-position launch;
    every result within the registry's tolerance of the plain version."""
    from paddle_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_plain, decode_split)
    f32, bf16 = torch.float32, torch.bfloat16
    B, n, h = DEC_BATCH, N_HEADS, HEAD_DIM
    off = torch.zeros((), dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    cases = 0
    for qd, cd in ((f32, f32), (bf16, bf16), (bf16, f32)):
        dname = str(qd).split(".")[1]
        q = torch.randn((B, 1, n * h), generator=gen).to(dev, qd)
        k, v = (torch.randn((B, DEC_LEN, n * h), generator=gen).to(dev, cd)
                for _ in range(2))
        for keys in DEVICE_KEYS:
            last = keys - 1
            for chunks in (1, 2, 4, 8):
                if (chunks - 1) * -(-keys // chunks) > last:
                    continue            # a chunk would hold no key
                off.fill_(last)
                eager = decode_attention(q, k, v, off, n, chunks)
                g = torch.cuda.CUDAGraph()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    g.capture_begin()
                    in_graph = decode_attention(q, k, v, off, n, chunks)
                    g.capture_end()
                torch.cuda.current_stream().wait_stream(side)
                off.fill_(0)
                g.replay()
                off.fill_(last)
                g.replay()
                ref = decode_attention_plain(q, k, v, last, n)
                torch.cuda.synchronize()
                what = (f"decode_fused[device position, q {qd}, cache {cd}, "
                        f"keys {keys}, {chunks} chunks]")
                if not same_bits(torch, eager, in_graph):
                    raise AssertionError(f"{what}: the graph's bits differ")
                if chunks == decode_split(last)[0] and not same_bits(
                        torch, eager,
                        decode_attention(q, k, v, last, n)):
                    raise AssertionError(f"{what}: differs from the host "
                                         "position's launch")
                note(("decode_fused", dname, str(cd)),
                     hold(what, eager, ref, k8.tol[dname]))
                cases += 1
                del g
    print(f"kernels: decode_fused with its position in device memory: "
          f"{cases} cases (keys {list(DEVICE_KEYS)} x 1/2/4/8 chunks x 3 "
          f"dtype pairs), in a graph = outside it, = the host position's "
          f"launch at decode_split's chunk count")


def decode_kernels_phase(torch, seed):
    """The decode path's kernels against their plain versions, then
    timed at generate's shapes (batch 8 on GPT-3 125M)."""
    from paddle_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_plain)
    from paddle_tpu_torch.ops.int8_matvec import (int8_matvec,
                                                  int8_matvec_plain)
    from paddle_tpu_torch.ops.kernel_registry import get_kernel
    F = torch.nn.functional
    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(seed + 11)
    f32, bf16 = torch.float32, torch.bfloat16
    errs = {}

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen).to(dev, dtype)

    def table(V):
        return (torch.randint(-127, 128, (V, I8_D), generator=gen,
                              dtype=torch.int8).to(dev),
                ((0.01 + torch.rand((V,), generator=gen)) * 0.01).to(dev))

    def note(key, e):
        errs[key] = max(errs.get(key, 0.0), e)

    # decode_fused: (q dtype, cache dtype) -> (b, heads, head_dim, offs)
    k8 = get_kernel("decode_fused")
    for qd, cd in ((f32, f32), (bf16, bf16), (bf16, f32)):
        dname = str(qd).split(".")[1]
        tol = k8.tol[dname]
        for b, n, h, offs in ((DEC_BATCH, N_HEADS, HEAD_DIM, DEC_OFFS),
                              (2, 4, 128, (100, 200)), (2, 6, 64, (200,))):
            q = randn((b, 1, n * h), qd)
            k, v = (randn((b, DEC_LEN, n * h), cd) for _ in range(2))
            for off in offs:
                got = decode_attention(q, k, v, off, n)
                ref = decode_attention_plain(q, k, v, off, n)
                torch.cuda.synchronize()
                note(("decode_fused", dname, str(cd)), hold(
                    f"decode_fused[q {qd}, cache {cd}, b={b} n={n} h={h} "
                    f"off={off}]", got, ref, tol))
    device_position_checks(torch, gen, dev, k8, note)
    # int8_matvec: h in f32 and bf16, the 125M head and a ragged table
    k9 = get_kernel("int8_matvec")
    big, ragged = table(I8_V), table(I8_RAGGED_V)
    for hd in (f32, bf16):
        dname = str(hd).split(".")[1]
        for B, (wq, sc) in [(r, big) for r in I8_ROWS] \
                + [(r, ragged) for r in I8_RAGGED_ROWS]:
            hh = randn((B, I8_D), hd)
            got = int8_matvec(hh, wq, sc)
            ref = int8_matvec_plain(hh, wq, sc)
            torch.cuda.synchronize()
            note(("int8_matvec", dname), hold(
                f"int8_matvec[h {dname}, B={B} D={I8_D} V={wq.shape[0]}]",
                got, ref, k9.tol[dname]))
    # generate's int8 head: a bf16 decode casts the scale buffer to bf16
    wq, sc = big
    sc_bf16 = sc.to(bf16)
    hh = randn((DEC_BATCH, I8_D), bf16)
    got = int8_matvec(hh, wq, sc_bf16)
    ref = int8_matvec_plain(hh, wq, sc_bf16)
    torch.cuda.synchronize()
    note(("int8_matvec", "bfloat16"), hold(
        f"int8_matvec[h bfloat16, scale bfloat16, B={DEC_BATCH} D={I8_D} "
        f"V={I8_V}]", got, ref, k9.tol["bfloat16"]))
    for key, e in sorted(errs.items()):
        print(f"kernels: {' '.join(key)} max_abs_err {e:.3e} (tol rtol, "
              f"atol = {get_kernel(key[0]).tol[key[1]]})")

    flush = l2_flush(torch, dev)
    rows = {}
    # decode_fused as generate runs it: bf16 q over the f32 cache (the
    # cache keeps the config's dtype), at the mean step position
    B, n, h, off = DEC_BATCH, N_HEADS, HEAD_DIM, DEC_TIMED_OFF
    nh = n * h
    q = randn((B, 1, nh), bf16)
    k, v = (randn((B, DEC_LEN, nh), f32) for _ in range(2))
    sq = q.float().reshape(B, 1, n, h).transpose(1, 2)
    sk, sv = (t[:, :off + 1].reshape(B, off + 1, n, h).transpose(1, 2)
              for t in (k, v))
    nbytes = 2 * B * (off + 1) * nh * 4 + B * nh * (2 + 4)
    rows["decode_fused"] = dict(
        ms=median_ms(torch, lambda: decode_attention(q, k, v, off, n),
                     flush),
        plain_ms=median_ms(
            torch, lambda: decode_attention_plain(q, k, v, off, n), flush),
        library_ms=median_ms(
            torch, lambda: F.scaled_dot_product_attention(sq, sk, sv),
            flush),
        bound=bound(nbytes, 4 * B * n * (off + 1) * h, "float32"),
        max_abs_err=errs[("decode_fused", "bfloat16", str(f32))])
    kb, vb = k.to(bf16), v.to(bf16)
    ms_bf16 = median_ms(torch, lambda: decode_attention(q, kb, vb, off, n),
                        flush)
    r = rows["decode_fused"]
    print(f"kernels: decode_fused B={B} off={off} bf16 q, f32 cache: "
          f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, sdpa over the "
          f"prefix {r['library_ms']:.4f}, bound {r['bound'][0]:.5f} by "
          f"{r['bound'][1]}; {nbytes} bytes); bf16 cache {ms_bf16:.4f} ms")

    # int8_matvec at generate's decode batch, bf16 h
    wq, sc = big
    wb = randn((I8_V, I8_D), bf16)      # an unquantized bf16 table

    def head_rows(B):
        hh = randn((B, I8_D), bf16)
        nbytes = I8_V * I8_D + B * I8_D * 2 + I8_V * 4 + B * I8_V * 4
        return dict(
            ms=median_ms(torch, lambda: int8_matvec(hh, wq, sc), flush),
            plain_ms=median_ms(torch, lambda: int8_matvec_plain(hh, wq, sc),
                               flush),
            library_ms=median_ms(torch, lambda: torch.matmul(
                hh, wq.to(bf16).t()) * sc, flush),
            bf16_table_ms=median_ms(torch, lambda: torch.matmul(hh, wb.t()),
                                    flush),
            bound=bound(nbytes, 2 * B * I8_V * I8_D, "bfloat16"),
            max_abs_err=errs[("int8_matvec", "bfloat16")])

    for B in I8_TIMED_ROWS:
        r = head_rows(B)
        print(f"kernels: int8_matvec B={B} D={I8_D} V={I8_V}: "
              f"{r['ms']:.4f} ms; composed head (f32 product, the plain "
              f"version) {r['plain_ms']:.4f}; dequantized bf16 matmul "
              f"{r['library_ms']:.4f}; bf16 table {r['bf16_table_ms']:.4f};"
              f" bound {r['bound'][0]:.5f} by {r['bound'][1]}")
        if B == DEC_BATCH:
            rows["int8_matvec"] = r
    del flush
    return rows


def moe_maps(torch, gen, dev):
    """The router's maps at the MoE training shape (8192 tokens, E 8,
    k 2, C 2560) from random gate logits that favour the low experts
    (a 1 to -1 ramp), so that both sentinels are real: choices dropped
    at capacity and slots left empty."""
    from paddle_tpu_torch.moe.router import capacity_for, route_top_k
    n = MOE_BATCH * MOE_SEQ
    C = capacity_for(n, MOE_E, MOE_K, MOE_CF)
    logits = (torch.randn((n, MOE_E), generator=gen)
              + torch.linspace(1.0, -1.0, MOE_E)).to(dev)
    comb_w, comb_slot, slot_token = route_top_k(logits, MOE_K, C)[:3]
    return n, C, comb_w, comb_slot, slot_token


def gather_work(torch, idx, n_src, d, itemsize):
    """Bytes the gather must move for the map `idx` over n_src rows of d,
    each distinct byte once: every distinct valid source row read once,
    all m rows written, the map read; and the distinct valid rows."""
    valid = idx[(idx >= 0) & (idx < n_src)]
    distinct = int(torch.unique(valid).numel())
    m = idx.numel()
    return (distinct + m) * d * itemsize + m * 4, distinct


def moe_work(torch, n, d, slot_token, comb_slot, itemsize):
    """Bytes each kernel must move for these maps, each distinct byte
    once: the dispatch gather reads every distinct kept token row and
    writes all E*C rows (and reads the map); the combine reads every
    kept slot row and writes n rows (and reads the maps and weights,
    f32)."""
    n_slots = slot_token.numel()
    gather, kept_tokens = gather_work(torch, slot_token, n, d, itemsize)
    kept_slots = int((comb_slot < n_slots).sum())
    combine = (kept_slots + n) * d * itemsize + comb_slot.numel() * 8
    return gather, combine, kept_tokens, kept_slots


def gather_cases(torch, gen, dev, n, slot_token, comb_slot, dtype):
    """K12's own cases beside the router's maps: (tag, src, idx)."""
    d = N_HEADS * HEAD_DIM
    n_slots = slot_token.numel()
    tokens = torch.randn((n, d), generator=gen).to(dev, dtype)
    eo = torch.randn((n_slots, d), generator=gen).to(dev, dtype)
    odd = slot_token.clone()
    odd[::97] = -1
    odd[1::101] = n + 1
    odd[2::103] = -2 ** 31
    odd[3::107] = 2 ** 31 - 1
    cases = [
        ("1009 rows, no multiple of a CTA's rows", tokens,
         slot_token[:1009]),
        ("m=1", tokens, slot_token[:1]),
        ("m=1 valid", tokens, torch.full((1,), n - 1, dtype=torch.int32,
                                         device=dev)),
        ("n_src=1", tokens[:1], torch.randint(
            -2, 3, (777,), generator=gen, dtype=torch.int32).to(dev)),
        ("indices below 0 and above n_src", tokens, odd),
        ("the combine backward's map", eo, comb_slot.reshape(-1))]
    if dtype == torch.float32:
        # 64 KB rows: 16 passes of a warp's loads (4 KB a pass)
        wide = torch.randn((257, 16384), generator=gen).to(dev)
        cases.append(("d=16384, rows of 64 KB", wide,
                      torch.randint(-1, 259, (300,), generator=gen,
                                    dtype=torch.int32).to(dev)))
    return cases


def print_gather_ptxas(_build):
    """ptxas's report for K12's instances, kept beside the built
    library; no report or an instance that spills fails."""
    inst = {fn: i for fn, i in _build.ptxas_info("moe_kernels").items()
            if "moe_gather" in fn}
    if not inst:
        raise AssertionError("moe_gather: no ptxas report for its "
                             "instances")
    for fn, info in sorted(inst.items()):
        print(f"build: ptxas moe_kernels: {fn}: {json.dumps(info)}")
    spill = [fn for fn, i in inst.items() if i.get("spills", (0, 0)) != (0, 0)]
    if spill:
        raise AssertionError(f"moe_gather: {len(spill)} of {len(inst)} "
                             f"instances spill: {spill}")


def moe_kernels_phase(torch, seed):
    """moe_gather and moe_combine against their plain versions on maps
    from the port's own router (and edge cases), in f32 and bf16 (the
    gather bit for bit), then timed at the MoE training shape: the
    combine in f32 (the layer's dtype there), the gather at both of its
    sites in f32 and at the dispatch in bf16."""
    from paddle_tpu_torch.moe.kernels import (combine_plain, gather_plain,
                                              moe_combine_fwd, moe_gather_fwd,
                                              reset_persisting_l2)
    from paddle_tpu_torch.ops.kernel_registry import get_kernel
    F = torch.nn.functional
    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(seed + 13)
    n, C, comb_w, comb_slot, slot_token = moe_maps(torch, gen, dev)
    n_slots = MOE_E * C
    kg, kc = get_kernel("moe_gather"), get_kernel("moe_combine")
    errs = {}

    def note(key, e):
        errs[key] = max(errs.get(key, 0.0), e)

    def check(kern, dname, tag, args):
        got = kern.wrapper(*args)
        ref = kern.plain(*args)
        torch.cuda.synchronize()
        name = f"{kern.name}[{dname}, {tag}]"
        note((kern.name, dname), hold(name, got, ref, kern.tol[dname]))
        if kern is kg and not same_bits(torch, got, ref):
            raise AssertionError(f"{name}: not bit for bit its plain "
                                 "version")

    dropped = int((comb_slot == n_slots).sum())
    empty = int((slot_token == n).sum())
    print(f"kernels: moe maps n={n} E={MOE_E} k={MOE_K} C={C}: {dropped} "
          f"dropped choices, {empty} empty slots")
    if not dropped or not empty:
        raise AssertionError("moe kernels: the maps hold no sentinels")
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for d in MOE_WIDTHS:
            tokens = torch.randn((n, d), generator=gen).to(dev, dtype)
            eo = torch.randn((n_slots, d), generator=gen).to(dev, dtype)
            w = comb_w.to(dtype)
            cases = [("gather", f"d={d}", (tokens, slot_token)),
                     ("combine", f"d={d}", (eo, comb_slot, w))]
            if d == 768:
                cases += [
                    ("gather", "all sentinels",
                     (tokens, torch.full_like(slot_token, n))),
                    ("gather", "1001 rows", (tokens, slot_token[:1001])),
                    ("combine", "all sentinels",
                     (eo, torch.full_like(comb_slot, n_slots), w)),
                    ("combine", "1001 rows",
                     (eo, comb_slot[:1001].contiguous(),
                      w[:1001].contiguous())),
                    ("combine", "k=1", (eo, comb_slot[:, :1].contiguous(),
                                        w[:, :1].contiguous())),
                    ("combine", "f32 w", (eo, comb_slot, comb_w))]
            for which, tag, args in cases:
                check(kg if which == "gather" else kc, dname, tag, args)
            del tokens, eo
        for tag, src, idx in gather_cases(torch, gen, dev, n, slot_token,
                                          comb_slot, dtype):
            check(kg, dname, tag, (src, idx))
    for key, e in sorted(errs.items()):
        print(f"kernels: {' '.join(key)} max_abs_err {e:.3e} (tol rtol, "
              f"atol = {get_kernel(key[0]).tol[key[1]]})")

    # timing at the main path's shapes: rows of 768, the combine and both
    # gather sites in f32 (the layer's dtype), the dispatch also in bf16;
    # every launch after a reset of the lines the gather left marked
    flush = l2_flush(torch, dev)

    def timed(fn):
        return median_ms(torch, fn, flush, before=reset_persisting_l2)
    d = N_HEADS * HEAD_DIM
    tokens = torch.randn((n, d), generator=gen).to(dev)
    eo = torch.randn((n_slots, d), generator=gen).to(dev)
    eo_pad = torch.cat([eo, eo.new_zeros((1, d))])
    _, c_bytes, kept_tokens, kept_slots = moe_work(
        torch, n, d, slot_token, comb_slot, 4)
    print(f"kernels: moe maps: {kept_tokens} distinct kept tokens, "
          f"{kept_slots} kept slots of {n_slots}")
    sites = {"dispatch f32": (tokens, slot_token),
             "combine backward f32": (eo, comb_slot.reshape(-1)),
             "dispatch bf16": (tokens.to(torch.bfloat16), slot_token)}
    gather = {}
    for site, (src, idx) in sites.items():
        pad = torch.cat([src, src.new_zeros((1, d))])
        size = src.element_size()
        nbytes, distinct = gather_work(torch, idx, src.shape[0], d, size)
        valid = int(((idx >= 0) & (idx < src.shape[0])).sum())
        gather[site] = r = dict(
            ms=timed(lambda: moe_gather_fwd(src, idx)),
            plain_ms=timed(lambda: gather_plain(src, idx)),
            library_ms=timed(lambda: F.embedding(idx, pad)),
            bound=bound(nbytes, 0, "float32"),
            max_abs_err=errs[("moe_gather", str(src.dtype)[6:])])
        # a gather in slot order with no L2 reuse reads each valid
        # slot's row once
        slot_order = (valid + idx.numel()) * d * size + idx.numel() * 4
        print(f"kernels: moe_gather {site} d={d}: {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f}, F.embedding {r['library_ms']:.4f}, "
              f"bound {r['bound'][0]:.5f} by {r['bound'][1]}; {nbytes} "
              f"bytes, {distinct} distinct rows of {idx.numel()}; read in "
              f"slot order, each valid row once: {slot_order} bytes, "
              f"{bound(slot_order, 0, 'float32')[0]:.5f} ms)")
        del pad
    rows = {
        "moe_gather": gather["dispatch f32"],
        "moe_combine": dict(
            ms=timed(lambda: moe_combine_fwd(eo, comb_slot, comb_w)),
            plain_ms=timed(lambda: combine_plain(eo, comb_slot, comb_w)),
            library_ms=timed(lambda: F.embedding_bag(
                comb_slot, eo_pad, per_sample_weights=comb_w, mode="sum")),
            bound=bound(c_bytes, 2 * kept_slots * d, "float32"),
            max_abs_err=errs[("moe_combine", "float32")])}
    r = rows["moe_combine"]
    print(f"kernels: moe_combine f32 d={d}: {r['ms']:.4f} ms (plain "
          f"{r['plain_ms']:.4f}, F.embedding_bag {r['library_ms']:.4f}, "
          f"bound {r['bound'][0]:.5f} by {r['bound'][1]}; {c_bytes} bytes)")
    del flush
    reset_persisting_l2()
    return rows


# ---------------------------------------------------------------------------
# phase 3: serve GPT-3 125M
# ---------------------------------------------------------------------------

def make_requests(seed, vocab, n=32, template_len=96):
    """`n` prompts of 16..384 tokens, the even ones sharing a template
    (the fleet drill's serve prompts)."""
    from paddle_tpu_torch.fleet.drill import serve_prompts
    return serve_prompts(seed, vocab, n, template_len)


def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))]


def teacher_forced(torch, model, prompt, out):
    """The dense f32 forward over prompt + output; per generated token,
    whether it is the f32 argmax and how far its logit trails the best,
    in units of that position's logit standard deviation."""
    ids = torch.tensor([prompt + out], device=model.gpt.ln_f.weight.device)
    with torch.inference_mode():
        logits = model(ids)[0, len(prompt) - 1:len(prompt) + len(out) - 1]
    tok = torch.tensor(out, device=logits.device)
    best = logits.max(dim=-1).values
    mine = logits.gather(1, tok[:, None])[:, 0]
    trail = (best - mine) / logits.std(dim=-1)
    agree = (logits.argmax(dim=-1) == tok).float()
    return agree.tolist(), trail.tolist()


def eager_steps(on=True):
    """The captured steps' bodies run eagerly while active (`on`), the
    same bodies over the same static buffers: what the compiled step is
    compared with."""
    from paddle_tpu_torch import jit
    return jit._eager_steps() if on else contextlib.nullcontext()


def serve_run(torch, eng, prompts, new=32, eager=False, sp=None):
    """The prompts served to idle (`new` tokens each, greedy) after a
    drain has flushed the prefix index, so every run prefills the same
    chunks: (outputs, tokens/s, decode-step ms, prefill-chunk ms), the
    step times on the host's clock around `_decode_once` and
    `_prefill_chunk` (each ends in its host copy). `sp` is the engine's
    own SamplingParams class (another checkout's engine takes its
    own)."""
    from paddle_tpu_torch.serving import SamplingParams
    sp = sp or SamplingParams
    eng.drain()
    eng.resume_admission()
    step_ms, chunk_ms = [], []
    decode_once, prefill_chunk = eng._decode_once, eng._prefill_chunk

    def timed_decode():
        t = time.perf_counter()
        did = decode_once()
        if did:
            step_ms.append((time.perf_counter() - t) * 1e3)
        return did

    def timed_chunk(*args):
        t = time.perf_counter()
        out = prefill_chunk(*args)
        chunk_ms.append((time.perf_counter() - t) * 1e3)
        return out

    eng._decode_once, eng._prefill_chunk = timed_decode, timed_chunk
    try:
        with eager_steps(eager):
            t0 = time.perf_counter()
            handles = [eng.submit(p, sp(max_new_tokens=new))
                       for p in prompts]
            eng.run_until_idle()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        del eng._decode_once, eng._prefill_chunk
    outs = [h.output_tokens for h in handles]
    if not all(h.finished and len(o) == new for h, o in zip(handles, outs)):
        raise AssertionError("serve: a stream did not complete")
    return outs, new * len(prompts) / wall, step_ms, chunk_ms


def run_stats(rate, step_ms, chunk_ms):
    return dict(tokens_per_s=rate, step_p50_ms=statistics.median(step_ms),
                step_p99_ms=pct(step_ms, 0.99),
                chunk_p50_ms=statistics.median(chunk_ms))


def eager_captured_turns(torch, eng, prompts, outs, what, turns=2, new=32):
    """Eager and captured runs of the same prompts in turns (eager,
    captured, captured, eager, ...): each must give `outs`, token for
    token. -> {"eager": [stats], "captured": [stats]}."""
    order = [True, False, False, True] * (turns // 2)
    got = {"eager": [], "captured": []}
    for eager in order:
        o, rate, step_ms, chunk_ms = serve_run(torch, eng, prompts, new=new,
                                               eager=eager)
        if o != outs:
            i = next(i for i, (a, b) in enumerate(zip(o, outs)) if a != b)
            mode = "eager" if eager else "captured"
            raise AssertionError(f"{what}: the {mode} steps' stream {i} "
                                 "differs from the captured run's")
        got["eager" if eager else "captured"].append(
            run_stats(rate, step_ms, chunk_ms))
    return got


def check_captures(records, what):
    """Every family was captured once per key -> {family: captures}."""
    keys, fams = {}, {}
    for r in records:
        if r.get("kind") != "compile":
            continue
        k = (r["fn"], r["extra"]["key"])
        keys[k] = keys.get(k, 0) + 1
        fams[r["fn"]] = fams.get(r["fn"], 0) + 1
    twice = {k: n for k, n in keys.items() if n > 1}
    if twice:
        raise AssertionError(f"{what}: captured more than once per key: "
                             f"{twice}")
    return fams


def graph_edges(graphs, layers, what):
    """{key: [edges, programmatic edges]} of an engine's captured graphs,
    from cudaGraphGetEdges_v2 (csrc/graph_edges.cu). Fails unless each
    decode graph has 2 x `layers` programmatic edges (K7 and K10's merge
    a layer) and each prefill graph `layers` (K7): a graph that lost
    their early start has none."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    fn, err = _build.launcher(
        "graph_edges", "graph_edge_counts",
        [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_longlong)] * 2)
    out = {}
    for key, g in graphs.items():
        total, prog = ctypes.c_longlong(), ctypes.c_longlong()
        _build.check_launch("graph_edges", fn(
            g.graph.raw_cuda_graph(), ctypes.byref(total),
            ctypes.byref(prog)), err)
        out[repr(key)] = [total.value, prog.value]
        want = layers * (2 if key[0].startswith("decode") else 1)
        if prog.value != want:
            raise AssertionError(f"{what}: graph {key!r} has {prog.value} "
                                 f"programmatic edges, not {want}")
    return out


def serve_phase(torch, seed, init_range, dtype):
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.ops.kernel_registry import kernels, reset_launches
    from paddle_tpu_torch.serving import SamplingParams, ServingEngine
    cfg = GPTConfig.gpt3_125m(max_seq_len=1024,
                              initializer_range=init_range)
    model = GPTForPretraining(cfg, seed=seed)          # on the card
    eng = ServingEngine(model, **{**ENGINE, "dtype": dtype})
    # warm-up: cuBLAS handles, allocator pools, first launches, and the
    # captures of the greedy decode step and prefill chunk
    for p in make_requests(seed + 1, cfg.vocab_size, n=2):
        eng.submit(p[:40], SamplingParams(max_new_tokens=4))
    eng.run_until_idle()
    torch.cuda.synchronize()

    prompts = make_requests(seed, cfg.vocab_size)
    d0, c0 = eng.decode_steps, eng.prefill_chunks
    reset_launches()
    outs, rate, step_ms, chunk_ms = serve_run(torch, eng, prompts)
    launches = {k.name: k.launches for k in kernels()}
    steps, chunks = eng.decode_steps - d0, eng.prefill_chunks - c0
    eng.pool.assert_quiesced()
    L = cfg.num_layers
    want = {**{name: 0 for name in launches},
            "paged_decode": L * steps, "flash_prefill_chunk": L * chunks,
            "layernorm_fused": L * (steps + chunks)}
    if launches != want:
        raise AssertionError(f"serve: launches {launches} != layers x "
                             f"steps/chunks {want}")
    ps = eng.prefix_stats()
    if ps["hits"] == 0:
        raise AssertionError("serve: the shared template never hit the "
                             "prefix cache")
    distinct = [len(set(o)) for o in outs]
    agree, trail = [], []
    for prompt, out in zip(prompts, outs):
        a, t = teacher_forced(torch, model, prompt, out)
        agree += a
        trail += t
    tf_rate = sum(agree) / len(agree)
    # the same requests through the eager bodies, in turns with the
    # captured steps: the same tokens
    turns = eager_captured_turns(torch, eng, prompts, outs, "serve")
    captures = check_captures(eng._graphs.records, "serve")
    edges = graph_edges(eng._graphs.graphs, L, "serve")
    stats = dict(**run_stats(rate, step_ms, chunk_ms), wall_s=32 * len(
                     prompts) / rate,
                 decode_steps=steps, prefill_chunks=chunks,
                 prefix_hits=ps["hits"], tokens_saved=ps["tokens_saved"],
                 distinct_mean=sum(distinct) / len(distinct),
                 constant_streams=sum(1 for d in distinct if d == 1),
                 tf_agree=tf_rate, tf_max_trail_std=max(trail),
                 launches=launches)
    print(f"serve[{dtype}, init {init_range}]: " + json.dumps(stats))
    compiled = dict(turns=turns, captures=captures,
                    capture_ms=eng._graphs.capture_ms,
                    pool_bytes=eng._graphs.pool_bytes, graph_edges=edges,
                    records=[{k: r[k] for k in ("fn", "n_compiles",
                                                "compile_ms", "extra")}
                             for r in eng._graphs.records])
    print(f"serve[{dtype}] eager vs captured steps, same tokens, on "
          f"{card_line()}: " + json.dumps(compiled))
    stats["compiled"] = compiled
    if stats["constant_streams"] > MAX_CONSTANT_FRAC * len(outs) or \
            sum(distinct) / len(distinct) < MIN_MEAN_DISTINCT:
        raise AssertionError(f"serve: the streams barely vary (distinct "
                             f"tokens per stream {distinct})")
    if tf_rate < TF_AGREE or max(trail) > TF_MARGIN_STD:
        raise AssertionError(
            f"serve: teacher-forced check failed: agreement {tf_rate:.3f} "
            f"(need {TF_AGREE}), worst trail {max(trail):.3f} std "
            f"(limit {TF_MARGIN_STD})")
    return stats, eng, cfg.vocab_size


def profile_phase(torch, eng, vocab, seed, steps=10, sampling_params=None,
                  what="", eager=False):
    """Device time by kernel over `steps` decode steps of a full batch,
    from torch.profiler with CUDA and CPU activity (the profiler's own
    host cost lengthens the steps, so the busy share it gives is a
    floor), and the host's launch API calls a step; `eager` runs the
    steps' bodies eagerly. `sampling_params` is the engine's own
    SamplingParams class (another checkout's engine takes its own).
    -> (device launches, host launch calls) a step."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.serving import SamplingParams
    SamplingParams = sampling_params or SamplingParams
    for p in make_requests(seed + 2, vocab, n=SLOTS):
        eng.submit(p[:200], SamplingParams(max_new_tokens=64))
    while eng.sched.prefilling or eng.sched.waiting:
        eng.step()
    eng.step()
    torch.cuda.synchronize()
    with eager_steps(eager), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    eng.run_until_idle()
    what = f"decode steps of {SLOTS} slots{what}"
    print_profile(prof, steps, wall_ms, what, top=12)
    return launch_counts(prof, steps, what)


# the host's launch API calls in a profile: kernel launches (cuda* and
# cu* entry points, PDL and clusters included) and graph launches
LAUNCH_API = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
              "cuLaunchKernelEx", "cudaGraphLaunch")


def launch_counts(prof, steps, what):
    """(device launches, host launch API calls by name) a step."""
    dev = sum(e.count for e in device_events(prof)) / steps
    host = {e.key: e.count / steps for e in prof.key_averages()
            if e.key in LAUNCH_API}
    print(f"profile: {what}: {dev:.1f} device launches a step, host launch "
          f"calls a step {json.dumps(host)} (total "
          f"{sum(host.values()):.1f})")
    return dev, host


def device_events(prof):
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]


def print_profile(prof, steps, wall_ms, what, top):
    """Device busy share and the `top` kernels by device time, per step;
    returns the busy ms per step (None when nothing was recorded)."""
    dev = device_events(prof)
    if not dev:
        print("profile: the profiler recorded no device time (not "
              "measured)")
        return None
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3 / steps
    launches = sum(e.count for e in dev) / steps
    print(f"profile: {steps} {what}: wall {wall_ms:.3f} ms/step, device "
          f"busy {busy_ms:.3f} ms/step (share {busy_ms / wall_ms:.3f}) "
          f"over {launches:.1f} device launches/step")
    split = {}
    for e in dev:
        cat = next((c for c, keys in PROFILE_CATEGORIES
                    if any(k in e.key for k in keys)), "other")
        ms, n = split.get(cat, (0.0, 0))
        split[cat] = (ms + e.self_device_time_total / 1e3 / steps,
                      n + e.count / steps)
    for cat, (ms, n) in sorted(split.items(), key=lambda kv: -kv[1][0]):
        print(f"profile:   {ms:8.4f} ms/step {n:6.1f} launches/step  "
              f"[{cat}]")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"profile:   {e.self_device_time_total / 1e3 / steps:8.4f} "
              f"ms/step {e.count / steps:6.1f} launches/step  {e.key[:80]}")
    return busy_ms


def serve_wo8_phase(torch, seed, init_range, n=16):
    """16 requests with weights="wo8" over a model quantized with its
    embeddings: the head runs int8_matvec once per decode step (16
    rows) and once per prefill chunk (the chunk's last row)."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.ops.kernel_registry import kernels, reset_launches
    from paddle_tpu_torch.quant import quantize_weights_int8
    from paddle_tpu_torch.serving import SamplingParams, ServingEngine
    cfg = GPTConfig.gpt3_125m(max_seq_len=1024,
                              initializer_range=init_range)
    model = GPTForPretraining(cfg, seed=seed)
    quantize_weights_int8(model, embeddings=True)
    eng = ServingEngine(model, **{**ENGINE, "dtype": "bfloat16",
                                  "weights": "wo8"})
    for p in make_requests(seed + 1, cfg.vocab_size, n=2):
        eng.submit(p[:40], SamplingParams(max_new_tokens=4))
    eng.run_until_idle()
    torch.cuda.synchronize()
    prompts = make_requests(seed + 3, cfg.vocab_size, n=n)
    d0, c0 = eng.decode_steps, eng.prefill_chunks
    reset_launches()
    outs, rate, _, _ = serve_run(torch, eng, prompts, new=16)
    launches = {k.name: k.launches for k in kernels()}
    steps, chunks = eng.decode_steps - d0, eng.prefill_chunks - c0
    eng.pool.assert_quiesced()
    # the eager bodies give the captured steps' tokens
    eager, eager_rate, _, _ = serve_run(torch, eng, prompts, new=16,
                                        eager=True)
    if eager != outs:
        raise AssertionError("serve wo8: the eager steps' tokens differ "
                             "from the captured steps'")
    check_captures(eng._graphs.records, "serve wo8")
    L = cfg.num_layers
    want = {**{name: 0 for name in launches},
            "paged_decode": L * steps, "flash_prefill_chunk": L * chunks,
            "layernorm_fused": L * (steps + chunks),
            "int8_matvec": steps + chunks}
    stats = dict(tokens_per_s=rate, eager_tokens_per_s=eager_rate,
                 same_tokens_eager=True, decode_steps=steps,
                 prefill_chunks=chunks, launches=launches)
    print("serve[wo8 + int8 embeddings, bf16]: " + json.dumps(stats))
    if launches != want:
        raise AssertionError(f"serve wo8: launches {launches} != {want}")
    return stats


# ---------------------------------------------------------------------------
# phase 4b: the engine as a server (serve loop + HTTP front)
# ---------------------------------------------------------------------------

# 8 client threads POST the 32 serve prompts: even ones greedy (half of
# them share the template), odd ones sampled with a seed each and one of
# these knob sets; 32 new tokens each
LOOP_CLIENTS, LOOP_NEW = 8, 32
LOOP_REPLAYS = 4            # sampled requests resubmitted one at a time
LOOP_FAULT_AT = 10          # the decode step that raises in the restart run
# card-vs-CPU draws over [slots, vocab] f32 logits, and a chi-square test
# of 20000 draws from a fixed 8-way distribution
DRAW_COUNTS = 64
CHI_P = (0.3, 0.2, 0.15, 0.1, 0.1, 0.08, 0.05, 0.02)
CHI_DRAWS, CHI_MIN_PVALUE = 20000, 1e-3
SAMPLER_CALLS = 10


class ListSink:
    """The engine's record sink, in memory (kind=serving and
    kind=reqtrace records)."""

    def __init__(self):
        self.records = []

    def write(self, rec):
        self.records.append(rec)
        return rec


def loop_knobs(i):
    """Even requests greedy, odd ones sampled with a seed of their own
    and one of the fleet drill's knob sets (top_k 50, top_p 0.9,
    temperature 0.8, all three)."""
    from paddle_tpu_torch.fleet.drill import feeder_knobs
    return feeder_knobs(i)


def http_streams(url, prompts, knobs, timeout=300):
    """POST every prompt with stream=true from LOOP_CLIENTS threads; each
    stream must end with its done event. Returns the tokens per stream."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    def one(i):
        body = json.dumps({"prompt": prompts[i], "max_new_tokens": LOOP_NEW,
                           "stream": True, **knobs[i]}).encode()
        req = urllib.request.Request(
            url + "/generate", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as r:
            lines = [json.loads(ln)
                     for ln in r.read().decode().strip().splitlines()]
        toks = [ln["token"] for ln in lines[:-1]]
        if not lines[-1].get("done") or lines[-1]["tokens"] != toks or \
                len(toks) != LOOP_NEW:
            raise AssertionError(f"serve loop: stream {i} ended with "
                                 f"{lines[-1]} after {len(toks)} tokens")
        return toks

    with ThreadPoolExecutor(LOOP_CLIENTS) as ex:
        return list(ex.map(one, range(len(prompts))))


def http_get(url, path, timeout=60):
    """(status, body) of a GET; an HTTP error status is returned, not
    raised."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url + path, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def tf_check(torch, model, prompts, outs, what):
    agree, trail = [], []
    for prompt, out in zip(prompts, outs):
        a, t = teacher_forced(torch, model, prompt, out)
        agree += a
        trail += t
    rate = sum(agree) / len(agree)
    if rate < TF_AGREE or max(trail) > TF_MARGIN_STD:
        raise AssertionError(
            f"{what}: teacher-forced check failed: agreement "
            f"{rate:.3f} (need {TF_AGREE}), worst trail {max(trail):.3f} "
            f"std (limit {TF_MARGIN_STD})")
    return rate, max(trail)


def draws_check(torch, seed, vocab):
    """prng on the card against the CPU: keys and bits equal, and the
    categorical draws of 64 counts over [slots, vocab] f32 logits (a
    mismatch can come only from torch.log rounding differently); the
    chi-square of 20000 draws from CHI_P on the card; top_k=1 and a
    tiny top_p select the argmax."""
    from scipy.stats import chi2
    from paddle_tpu_torch import prng
    from paddle_tpu_torch.serving.engine import _select
    gen = torch.Generator().manual_seed(seed)
    lg = torch.randn(SLOTS, vocab, generator=gen) * 3
    lg_d = lg.to(DEVICE)
    base = torch.stack([prng.prng_key(seed + i) for i in range(SLOTS)])
    mismatches = 0
    for c in range(DRAW_COUNTS):
        counts = torch.full((SLOTS,), c * 997)
        keys = prng.fold_in(base, counts)
        keys_d = prng.fold_in(base.to(DEVICE), counts.to(DEVICE))
        if not torch.equal(keys_d.cpu(), keys):
            raise AssertionError(f"draws: fold_in keys differ on the card "
                                 f"(count {c * 997})")
        if c == 0 and not torch.equal(
                prng.random_bits32(keys_d, (vocab,)).cpu(),
                prng.random_bits32(keys, (vocab,))):
            raise AssertionError("draws: random bits differ on the card")
        got = prng.categorical(keys_d, lg_d).cpu()
        mismatches += int((got != prng.categorical(keys, lg)).sum())
    if mismatches:
        raise AssertionError(f"draws: {mismatches} of {DRAW_COUNTS * SLOTS}"
                             " categorical draws differ card vs CPU")
    p = torch.tensor(CHI_P, dtype=torch.float64)
    keys = prng.fold_in(prng.prng_key(seed, device=DEVICE).expand(
        CHI_DRAWS, 2), torch.arange(CHI_DRAWS, device=DEVICE))
    toks = prng.categorical(keys, p.float().log().to(DEVICE).expand(
        CHI_DRAWS, len(CHI_P)))
    obs = torch.bincount(toks, minlength=len(CHI_P)).cpu().double()
    exp = p * CHI_DRAWS
    stat = float(((obs - exp) ** 2 / exp).sum())
    pvalue = float(chi2.sf(stat, len(CHI_P) - 1))
    if pvalue <= CHI_MIN_PVALUE:
        raise AssertionError(f"draws: chi-square {stat:.2f} (p {pvalue:.2e})"
                             f" for counts {obs.tolist()}")
    half = SLOTS // 2
    top_k = torch.tensor([1] * half + [0] * half, device=DEVICE)
    top_p = torch.tensor([1.0] * half + [1e-6] * half, device=DEVICE)
    tok, _ = _select(lg_d, base.to(DEVICE),
                     torch.arange(SLOTS, device=DEVICE),
                     torch.ones(SLOTS, device=DEVICE), top_k, top_p,
                     torch.zeros(SLOTS, dtype=torch.bool, device=DEVICE))
    if not torch.equal(tok, lg_d.argmax(dim=-1)):
        raise AssertionError("draws: top_k=1 / a tiny top_p did not give "
                             "the argmax")
    return dict(draw_mismatches=mismatches,
                draws_compared=DRAW_COUNTS * SLOTS, chi_square=stat,
                chi_square_pvalue=pvalue, chi_square_counts=obs.tolist())


def sampler_cost(torch, vocab):
    """Device ms and kernel launches of one `_select` (sampling) and one
    `_greedy` over [slots, vocab] bf16 logits (torch.profiler, CUDA
    activity), and their host ms a call (synchronized)."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import prng
    from paddle_tpu_torch.serving.engine import _greedy, _select
    gen = torch.Generator().manual_seed(1)
    last = (torch.randn(SLOTS, vocab, generator=gen) * 3).to(
        DEVICE, torch.bfloat16)
    base = torch.stack([prng.prng_key(i) for i in range(SLOTS)]).to(DEVICE)
    args = (base, torch.arange(SLOTS, device=DEVICE),
            torch.full((SLOTS,), 0.8, device=DEVICE),
            torch.full((SLOTS,), 50, device=DEVICE),
            torch.full((SLOTS,), 0.9, device=DEVICE),
            torch.zeros(SLOTS, dtype=torch.bool, device=DEVICE))
    out = {}
    for name, fn in (("sampling", lambda: _select(last, *args)),
                     ("greedy", lambda: _greedy(last))):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SAMPLER_CALLS):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / SAMPLER_CALLS
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(SAMPLER_CALLS):
                fn()
            torch.cuda.synchronize()
        dev = device_events(prof)
        out[name] = dict(
            host_ms=host_ms,
            device_ms=(sum(e.self_device_time_total for e in dev) / 1e3
                       / SAMPLER_CALLS) if dev else "not measured",
            launches=(sum(e.count for e in dev) / SAMPLER_CALLS)
            if dev else "not measured")
    return out


def serve_loop_phase(torch, seed, init_range):
    """The engine as a server: `start()` + `ServingHTTPServer` on
    127.0.0.1, GPT-3 125M in bf16 at the serve phase's engine shape."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.ops.kernel_registry import kernels, reset_launches
    from paddle_tpu_torch.serving import (SamplingParams, ServingEngine,
                                          ServingHTTPServer)
    t_phase = time.perf_counter()
    cfg = GPTConfig.gpt3_125m(max_seq_len=1024,
                              initializer_range=init_range)
    model = GPTForPretraining(cfg, seed=seed)          # on the card
    sink = ListSink()
    eng = ServingEngine(model, sink=sink, **{**ENGINE, "dtype": "bfloat16",
                                             "restart_backoff_s": 0.01})
    for i, p in enumerate(make_requests(seed + 1, cfg.vocab_size, n=2)):
        eng.submit(p[:40], SamplingParams(max_new_tokens=4,
                                          **loop_knobs(i)))
    eng.run_until_idle()
    torch.cuda.synchronize()
    step_ms = {False: [], True: []}
    decode_step = eng._decode_step

    def timed_step(inputs, sampling):
        t = time.perf_counter()
        out = decode_step(inputs, sampling)         # ends in a host copy
        step_ms[sampling].append((time.perf_counter() - t) * 1e3)
        return out

    eng._decode_step = timed_step
    prompts = make_requests(seed, cfg.vocab_size)
    knobs = [loop_knobs(i) for i in range(len(prompts))]
    restarts0 = monitor.get("serving.restarts", 0)
    timing = {}

    def timed_batch(sampling, drive, what):
        """A full batch of the first 16 prompts cut to 64 tokens; its
        decode-step times under timing[what, sampling]."""
        step_ms[False].clear()
        step_ms[True].clear()
        hs = [eng.submit(p[:64], SamplingParams(
            max_new_tokens=LOOP_NEW, **loop_knobs(2 * j + sampling)))
            for j, p in enumerate(prompts[:SLOTS])]
        drive()
        for h in hs:
            h.result(timeout=300)
        timing[what, sampling] = list(step_ms[sampling])

    d0, c0 = eng.decode_steps, eng.prefill_chunks
    reset_launches()
    # the greedy batch stepped by run_until_idle on this thread, as the
    # serve phase steps, before the loop starts: what the loop's thread
    # costs a step
    timed_batch(False, eng.run_until_idle, "main")
    eng.start()
    srv = ServingHTTPServer(eng, port=0).start()
    try:
        t0 = time.perf_counter()
        outs = http_streams(srv.url, prompts, knobs)
        http_s = time.perf_counter() - t0
        if monitor.get("serving.restarts", 0) != restarts0 or \
                eng.sched.preemptions:
            raise AssertionError("serve loop: the engine restarted or "
                                 "preempted during the clean run")
        # replay identity: sampled requests, one at a time to the idle
        # engine, must draw the same tokens as in the batch: each row of
        # the fixed-shape step computes alone. Their prompts share no
        # template, and a drain flushes the prefix index, so no prefix
        # hit (of their own cached prompts) moves where prefill chunks
        # start
        if not eng.drain(timeout=300):
            raise AssertionError("serve loop: drain did not complete")
        eng.resume_admission()
        for i in [i for i in range(len(prompts)) if knobs[i]][:LOOP_REPLAYS]:
            again = eng.submit(prompts[i], SamplingParams(
                max_new_tokens=LOOP_NEW, **knobs[i])).result(timeout=300)
            if again != outs[i]:
                at = next(j for j, (a, b) in enumerate(zip(again, outs[i]))
                          if a != b)
                raise AssertionError(
                    f"serve loop: sampled request {i} alone differs from "
                    f"its batch stream at token {at}")
        # the same sampled requests through the eager bodies, after
        # another flush: the captured steps' tokens
        if not eng.drain(timeout=300):
            raise AssertionError("serve loop: drain did not complete")
        eng.resume_admission()
        with eager_steps():
            for i in [i for i in range(len(prompts))
                      if knobs[i]][:LOOP_REPLAYS]:
                again = eng.submit(prompts[i], SamplingParams(
                    max_new_tokens=LOOP_NEW, **knobs[i])).result(
                        timeout=300)
                if again != outs[i]:
                    raise AssertionError(
                        f"serve loop: sampled request {i} through the "
                        "eager steps differs from the captured stream")
        # decode-step times of full batches on the loop's thread: greedy
        # only, then sampling
        for sampling in (False, True):
            timed_batch(sampling, lambda: None, "loop")
        status, text = http_get(srv.url, "/metrics")
        for series in ("# TYPE paddle_tpu_serving_ttft_ms histogram",
                       'paddle_tpu_serving_ttft_ms_bucket{le="+Inf"}',
                       "paddle_tpu_serving_ttft_ms_count",
                       "paddle_tpu_serving_tpot_ms_sum",
                       "# TYPE paddle_tpu_serving_kv_block_utilization gauge",
                       "paddle_tpu_serving_queue_depth",
                       "paddle_tpu_serving_ttft_p99_ms",
                       "# TYPE paddle_tpu_serving_tokens_generated counter"):
            if status != 200 or series not in text:
                raise AssertionError(f"serve loop: /metrics ({status}) "
                                     f"lacks {series!r}")
        status, body = http_get(srv.url, "/healthz")
        if status != 200 or json.loads(body)["status"] != "ok":
            raise AssertionError(f"serve loop: /healthz {status} {body}")
        # warm restart under load: one decode step raises mid-run
        calls = {"n": 0}
        inner = eng._decode_step

        def faulty(inputs, sampling):
            calls["n"] += 1
            if calls["n"] == LOOP_FAULT_AT:
                raise RuntimeError("serve loop: injected step fault")
            return inner(inputs, sampling)

        eng._decode_step = faulty
        n_fault = len(prompts) // 2
        r_outs = http_streams(srv.url, prompts[:n_fault], knobs[:n_fault])
        eng._decode_step = inner
        restarts = monitor.get("serving.restarts", 0) - restarts0
        if restarts != 1 or calls["n"] < LOOP_FAULT_AT:
            raise AssertionError(f"serve loop: {restarts} restarts after "
                                 f"one injected fault")
        if not eng.drain(timeout=300):
            raise AssertionError("serve loop: drain did not complete")
        status, body = http_get(srv.url, "/healthz")
        live, _ = http_get(srv.url, "/livez")
        if status != 503 or json.loads(body)["status"] != "draining" or \
                live != 200:
            raise AssertionError(f"serve loop: while draining /healthz "
                                 f"answered {status}, /livez {live}")
    finally:
        srv.stop()
        eng.stop()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels()}
    steps, chunks = eng.decode_steps - d0, eng.prefill_chunks - c0
    eng.pool.assert_quiesced()
    quiesce = [r for r in sink.records if r.get("event") == "quiesce"][-1]
    c = quiesce["counts"]
    if c["admitted"] != c["finished"] + c["failed"] + c["cancelled"] + \
            c["expired"] or quiesce["kv_blocks_used"] != 0:
        raise AssertionError(f"serve loop: the quiesce record does not "
                             f"balance: {quiesce}")
    L = cfg.num_layers
    want = {**{name: 0 for name in launches},
            "paged_decode": L * steps, "flash_prefill_chunk": L * chunks,
            "layernorm_fused": L * (steps + chunks)}
    if launches != want:
        raise AssertionError(f"serve loop: launches {launches} != layers x "
                             f"steps/chunks {want}")
    greedy = [i for i in range(len(prompts)) if not knobs[i]]
    tf_rate, tf_trail = tf_check(torch, model, [prompts[i] for i in greedy],
                                 [outs[i] for i in greedy],
                                 "serve loop (clean run)")
    rg = [i for i in greedy if i < n_fault]
    rtf_rate, rtf_trail = tf_check(torch, model, [prompts[i] for i in rg],
                                   [r_outs[i] for i in rg],
                                   "serve loop (restart run)")
    captures = check_captures(sink.records, "serve loop")
    draws = draws_check(torch, seed, cfg.vocab_size)
    sampler = sampler_cost(torch, cfg.vocab_size)
    stats = dict(
        http_tokens_per_s=LOOP_NEW * len(prompts) / http_s, http_s=http_s,
        greedy_step_p50_ms=statistics.median(timing["loop", False]),
        greedy_step_p99_ms=pct(timing["loop", False], 0.99),
        sampling_step_p50_ms=statistics.median(timing["loop", True]),
        sampling_step_p99_ms=pct(timing["loop", True], 0.99),
        main_thread_greedy_step_p50_ms=statistics.median(
            timing["main", False]),
        main_thread_greedy_step_p99_ms=pct(timing["main", False], 0.99),
        timed_steps=[len(t) for t in timing.values()],
        sampler=sampler, decode_steps=steps, prefill_chunks=chunks,
        restarts=restarts, quiesce_counts=c, tf_agree=tf_rate,
        tf_max_trail_std=tf_trail, restart_tf_agree=rtf_rate,
        restart_tf_max_trail_std=rtf_trail, replays=LOOP_REPLAYS,
        eager_replays_same=True, captures=captures,
        capture_ms=eng._graphs.capture_ms, pool_bytes=eng._graphs.pool_bytes,
        **draws, launches=launches,
        phase_s=time.perf_counter() - t_phase)
    print(f"serve loop[bf16, init {init_range}] on {card_line()}: "
          + json.dumps(stats))
    return stats


# ---------------------------------------------------------------------------
# phase 4c: the memory observatory (one engine at the serve shape)
# ---------------------------------------------------------------------------

MEM_REQUESTS = 16           # served per engine in the memory phase
MEM_FAULT_AT = 6            # the decode step that asks for too much memory
MEM_SNAP_TIMED = 50         # snapshots timed alone
GIB = 2 ** 30


def recapture_check(records, what):
    """After one warm restart: every family captured once per key, and
    each family that ran after it recaptured exactly once, the cause
    naming the arenas -> {family: cause}."""
    check_captures(records, what)
    comp = [r for r in records if r.get("kind") == "compile"]
    again = {}
    for r in comp:
        if r["n_compiles"] > 1:
            if r["fn"] in again or not any("arenas" in c
                                           for c in r.get("cause", [])):
                raise AssertionError(f"{what}: recapture {r}")
            again[r["fn"]] = r["cause"]
    if not again or any(r["n_compiles"] > 2 for r in comp):
        raise AssertionError(f"{what}: recaptures {comp}")
    return again


def memory_phase(torch, seed, init_range):
    """The ledger against the CUDA caching allocator, the headroom shed
    (direct and over HTTP), a budget that never sheds, and a real
    allocation failure inside a step -> postmortem before the arena
    rebuild, one warm restart, every stream complete."""
    import gc
    import urllib.error
    import urllib.request
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.ops.kernel_registry import kernels, reset_launches
    from paddle_tpu_torch.serving import (MemoryPressureError,
                                          SamplingParams, ServingEngine,
                                          ServingHTTPServer)
    from paddle_tpu_torch.telemetry.ledger_check import check_records
    from paddle_tpu_torch.telemetry.mem_obs import registered_providers
    t_phase = time.perf_counter()
    gc.collect()        # the earlier phases' engines must be gone
    cfg = GPTConfig.gpt3_125m(max_seq_len=1024,
                              initializer_range=init_range)
    model = GPTForPretraining(cfg, seed=seed)          # on the card
    prompts = make_requests(seed, cfg.vocab_size)[:MEM_REQUESTS]
    sink = ListSink()
    eng = ServingEngine(model, sink=sink, **{**ENGINE, "dtype": "bfloat16"})
    if len(registered_providers()) != 2:
        raise AssertionError(f"memory: providers of other engines are "
                             f"alive: {registered_providers()}")
    # the phase's main path: the engine serving, the ledger sampled at
    # every step
    d0, c0 = eng.decode_steps, eng.prefill_chunks
    reset_launches()
    hs = [eng.submit(p, SamplingParams(max_new_tokens=LOOP_NEW))
          for p in prompts]
    eng.run_until_idle()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels()}
    steps, chunks = eng.decode_steps - d0, eng.prefill_chunks - c0
    L = cfg.num_layers
    want = {**{name: 0 for name in launches},
            "paged_decode": L * steps, "flash_prefill_chunk": L * chunks,
            "layernorm_fused": L * (steps + chunks)}
    if launches != want or not all(h.finished for h in hs):
        raise AssertionError(f"memory: launches {launches} != {want}, or "
                             "a stream did not complete")
    snaps = [r for r in sink.records if r.get("kind") == "memsnap"]
    if len(snaps) != eng._steps:
        raise AssertionError(f"memory: {len(snaps)} snapshots in "
                             f"{eng._steps} steps")
    # the ledger against the allocator, read back to back
    rec = eng.mem_obs.snapshot(eng._steps + 1)
    reserved = torch.cuda.memory_reserved()
    net = eng._net
    params = sum(t.numel() * t.element_size()
                 for t in {*net.parameters(), *net.buffers()})
    kv = sum(a.numel() * a.element_size() for a in eng.cache.k + eng.cache.v)
    buckets = {b: rec[b] for b in ("params_bytes", "opt_state_bytes",
                                   "kv_bytes", "workspace_bytes",
                                   "other_bytes")}
    if rec["params_bytes"] != params or rec["kv_bytes"] != kv or \
            rec["total_bytes"] != reserved or \
            sum(buckets.values()) != rec["total_bytes"]:
        raise AssertionError(
            f"memory: ledger {rec} against params {params}, kv {kv}, "
            f"reserved {reserved}")
    total = rec["total_bytes"]
    ledger_pool = eng._graphs.pool_bytes     # reserved inside the total
    if eng.health.anomalies:            # no budget declared: no rule fires
        raise AssertionError(f"memory: {eng.health.kinds()} fired without "
                             "a budget")
    # what a snapshot costs the step that takes it (host time)
    snap_ms = []
    for i in range(MEM_SNAP_TIMED):
        t = time.perf_counter()
        eng.mem_obs.snapshot(eng._steps + 2 + i)
        snap_ms.append((time.perf_counter() - t) * 1e3)
    del eng, hs
    gc.collect()        # the ledger is per process: one engine at a time
    # a budget below the measured total: admission sheds, directly and
    # over HTTP (429 + Retry-After)
    shed0 = monitor.get("serving.mem_shed", 0)
    low = ServingEngine(model, **{**ENGINE, "dtype": "bfloat16",
                                  "hbm_budget_mb": total // 2 ** 20 - 1})
    low.mem_obs.snapshot(0)
    if low.mem_obs.headroom_bytes() != 0:
        raise AssertionError(f"memory: headroom {low.mem_obs.last}")
    # the engine's detector judged that record: hbm_pressure, once
    low_kinds = [a.kind for a in low.health.anomalies]
    if low_kinds != ["hbm_pressure"]:
        raise AssertionError(f"memory: the tight budget's engine fired "
                             f"{low_kinds}, not one hbm_pressure")
    try:
        low.submit(prompts[0], SamplingParams(max_new_tokens=4))
        raise AssertionError("memory: an exhausted budget admitted")
    except MemoryPressureError as e:
        if e.reason != "mem_pressure" or e.retry_after_s <= 0:
            raise
    low.start()
    srv = ServingHTTPServer(low, port=0).start()
    try:
        body = json.dumps({"prompt": prompts[0], "max_new_tokens": 4,
                           "stream": True}).encode()
        req = urllib.request.Request(
            srv.url + "/generate", data=body,
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=60)
            raise AssertionError("memory: HTTP admitted past the budget")
        except urllib.error.HTTPError as e:
            reply = json.loads(e.read().decode())
            if e.code != 429 or e.headers.get("Retry-After") is None or \
                    reply.get("reason") != "mem_pressure":
                raise AssertionError(f"memory: HTTP answered {e.code} "
                                     f"{dict(e.headers)} {reply}")
    finally:
        srv.stop()
        low.stop()
    low_kinds = [a.kind for a in low.health.anomalies]
    if monitor.get("serving.mem_shed", 0) != shed0 + 2 or \
            low._counts["admitted"] != 0 or low_kinds != ["hbm_pressure"]:
        raise AssertionError("memory: serving.mem_shed did not count the "
                             "two sheds")
    del low, srv
    gc.collect()
    # the card's memory as the budget: nothing sheds. Then a step that
    # asks the allocator for more than the card has: a real
    # torch.OutOfMemoryError -> postmortem, warm restart, every stream
    # complete
    card_mb = torch.cuda.get_device_properties(0).total_memory // 2 ** 20
    psink = ListSink()
    high = ServingEngine(model, sink=psink,
                         **{**ENGINE, "dtype": "bfloat16",
                            "hbm_budget_mb": card_mb,
                            "restart_backoff_s": 0.01})
    kv_high = high.cache.nbytes
    calls = {"n": 0}
    inner = high._decode_step

    def greedy_for_memory(inputs, sampling):
        calls["n"] += 1
        if calls["n"] == MEM_FAULT_AT:
            torch.empty(2 * card_mb * 2 ** 20, dtype=torch.uint8,
                        device=DEVICE)
        return inner(inputs, sampling)

    high._decode_step = greedy_for_memory
    ooms0 = torch.cuda.memory_stats().get("num_ooms", 0)
    restarts0 = monitor.get("serving.restarts", 0)
    high.start()
    try:
        hs = [high.submit(p, SamplingParams(max_new_tokens=LOOP_NEW))
              for p in prompts]
        outs = [h.result(timeout=300) for h in hs]
        if not high.drain(timeout=300):
            raise AssertionError("memory: drain did not complete")
    finally:
        high.stop()
    recs = psink.records
    high_kinds = [a.kind for a in high.health.anomalies]
    if high_kinds:
        raise AssertionError(f"memory: the card's budget fired {high_kinds}")
    posts = [i for i, r in enumerate(recs) if r.get("event") == "postmortem"]
    restarts = [i for i, r in enumerate(recs)
                if r.get("kind") == "serving" and r.get("event") == "restart"]
    if calls["n"] < MEM_FAULT_AT or len(posts) != 1 or len(restarts) != 1 \
            or posts[0] > restarts[0] or \
            monitor.get("serving.restarts", 0) != restarts0 + 1:
        raise AssertionError(f"memory: {len(posts)} postmortems, "
                             f"{len(restarts)} restarts after one OOM")
    recaptures = recapture_check(recs, "memory")
    post = recs[posts[0]]
    if "OutOfMemoryError" not in post["error"] or \
            post["kv_bytes"] != kv_high or post["num_ooms"] <= ooms0 or \
            not post["top_arrays"] or not post["top_segments"]:
        raise AssertionError(f"memory: postmortem {post}")
    if any(len(o) != LOOP_NEW for o in outs) or \
            high._counts["shed"] or high._counts["admitted"] != len(prompts):
        raise AssertionError("memory: a stream did not complete or was "
                             "shed under a budget above the total")
    tf_rate, tf_trail = tf_check(torch, model, prompts, outs,
                                 "memory (OOM restart run)")
    problems = check_records(sink.records + psink.records, "memory")
    if problems:
        raise AssertionError(f"memory: ledger problems {problems[:5]}")
    stats = dict(
        ledger_gib={k[:-6]: v / GIB for k, v in buckets.items()},
        total_gib=total / GIB, reserved_gib=reserved / GIB,
        total_graph_pool_gib=ledger_pool / GIB,
        allocated_gib=torch.cuda.memory_allocated() / GIB,
        snapshots=len(snaps), decode_steps=steps, prefill_chunks=chunks,
        snapshot_host_ms_p50=statistics.median(snap_ms),
        snapshot_host_ms_max=max(snap_ms),
        low_budget_mb=total // 2 ** 20 - 1, high_budget_mb=card_mb,
        postmortem=dict(step=post["step"],
                        num_alloc_retries=post["num_alloc_retries"],
                        num_ooms=post["num_ooms"],
                        top_segment_gib=post["top_segments"][0]["bytes"]
                        / GIB,
                        top_array=post["top_arrays"][0]),
        oom_tf_agree=tf_rate, oom_tf_max_trail_std=tf_trail,
        recaptures=recaptures, pool_bytes=high._graphs.pool_bytes,
        health=dict(tight=low_kinds, card=high_kinds),
        launches=launches, phase_s=time.perf_counter() - t_phase)
    print(f"memory[bf16, init {init_range}] on {card_line()}: "
          + json.dumps(stats))
    return stats


# ---------------------------------------------------------------------------
# phase 4d: the fleet tier (replica processes on the one card)
# ---------------------------------------------------------------------------

def fleet_phase(torch, seed, init_range):
    """paddle_tpu_torch.fleet.drill on the card at the serve shape: three
    replica processes (`python -m paddle_tpu_torch.fleet.drill --serve`)
    and a single-replica baseline, a FleetRouter over HTTPReplicas and a
    FleetHTTPServer in this process; the chaos wave, respawn, rolling
    restart and ledger of the drill, then the teacher-forced bar over
    every greedy stream (chaos wave, greedy feeders, the final wave,
    which goes through a FleetHTTPServer)."""
    import tempfile
    import urllib.request
    from paddle_tpu_torch.fleet.drill import (N_REPLICAS, SERVED_KERNELS,
                                              drill, weights_checksum)
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    t_phase = time.perf_counter()
    cfg = GPTConfig.gpt3_125m(max_seq_len=1024,
                              initializer_range=init_range)
    model = GPTForPretraining(cfg, seed=seed)          # the reference
    checksum = weights_checksum(model)
    prompts = make_requests(seed, cfg.vocab_size)
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="fleet_", dir=os.path.join(root,
                                                                "build"))
    res = drill(workdir, seed=seed, init_range=init_range, device=DEVICE,
                prompts=prompts, max_new=LOOP_NEW)
    if res["findings"]:
        raise AssertionError("fleet: " + "; ".join(res["findings"][:10]))
    if res["weights_sha256"] != [checksum]:
        raise AssertionError(f"fleet: replica weights {res['weights_sha256']}"
                             f" != the reference's {checksum}")
    kind = torch.cuda.get_device_name(0)
    if {r["device"] for r in res["ready"].values()} != {kind} or \
            any(r["device"] != kind for r in res["exits"]):
        raise AssertionError(f"fleet: a replica ran off {kind}")
    if res["prefix_hit_rate"] <= 0:
        raise AssertionError("fleet: no prefix hit across the fleet")
    if not res["spliced"]:
        raise AssertionError("fleet: the kill spliced no stream")
    greedy_feed = [(i, t) for i, k, t in res["feed"]
                   if k.get("decode_strategy") != "sampling"]
    tf = {}
    for what, ps, outs in (
            ("fleet chaos wave", prompts, res["chaos_streams"]),
            ("fleet rolling restart", [prompts[i] for i, _ in greedy_feed],
             [t for _, t in greedy_feed]),
            ("fleet final wave", prompts, res["final_streams"])):
        tf[what] = tf_check(torch, model, ps, outs, what)
    launches = {}
    for rep in res["exits"]:
        for k, n in rep["launches"].items():
            launches[k] = launches.get(k, 0) + n
    stats = {
        "fleet.rated_throughput_tokens_per_sec": res["fleet_tokens_per_s"],
        "fleet.rated_throughput_tokens_per_sec[1 replica]":
            res["solo_tokens_per_s"],
        "fleet.scaling_efficiency": res["scaling_efficiency"],
        "replicas": N_REPLICAS, "kill_to_exit_ms": res["exit_ms"],
        "kill_to_declared_dead_ms": res["detect_ms"],
        "declared_dead_detect_s": res["detect_s_record"],
        "victim": res["victim"], "spliced": res["spliced"],
        "spawn_s": res["spawn_s"], "respawn_s": res["respawn_s"],
        "rolling_restart_s": res["rolling_restart_s"],
        "restarted": res["restarted"], "feed_requests": len(res["feed"]),
        "feed_failed": res["feed_failed"],
        "prefix_hit_rate": res["prefix_hit_rate"],
        "tf": {k: {"agree": a, "max_trail_std": t}
               for k, (a, t) in tf.items()},
        "ledger_records": res["ledger_records"],
        "engines_exited": [r["engine_id"] for r in res["exits"]],
        "launches": {k: launches.get(k, 0) for k in SERVED_KERNELS},
        "phase_s": time.perf_counter() - t_phase}
    print(f"fleet[bf16, init {init_range}] on {card_line()}: "
          + json.dumps(stats))
    stats["launches"] = launches
    return stats


# ---------------------------------------------------------------------------
# phase 5: decode (generate) GPT-3 125M, native and weight-only int8
# ---------------------------------------------------------------------------

def decode_profile(torch, model, ids, what, eager=False):
    """Device time by kernel over the DEC_PROFILED token steps of one bf16
    `generate` call (torch.profiler, CUDA and CPU activity, started after
    the prefill), and the host's launch API calls a step; `eager` runs
    the token steps' bodies eagerly. A warm call first captures the
    call's shape. -> (device launches, host launch calls) a step."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import generation
    model.generate(ids, max_new_tokens=DEC_PROFILED)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    run, wall = generation._run_steps, []

    def profiled(*args, **kw):
        torch.cuda.synchronize()
        prof.start()
        t0 = time.perf_counter()
        try:
            run(*args, **kw)
            torch.cuda.synchronize()
        finally:
            wall.append((time.perf_counter() - t0) * 1e3 / DEC_PROFILED)
            prof.stop()

    generation._run_steps = profiled
    try:
        with eager_steps(eager):
            model.generate(ids, max_new_tokens=DEC_PROFILED)
    finally:
        generation._run_steps = run
    what = (f"generate token steps of {ids.shape[0]} rows, {what}, "
            f"{'eager' if eager else 'captured'}")
    print_profile(prof, DEC_PROFILED, wall[0], what, top=8)
    return launch_counts(prof, DEC_PROFILED, what)


def kept_bytes(torch, ms):
    """Bytes of one model's kept `generate` state: the decode-dtype
    weights, the loop buffers (KV cache, ids, selection state), and the
    device memory its graphs' captures reserved."""
    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    loop = [t for kv in ms.loop.caches for t in kv] + [
        t for t in vars(ms.loop).values() if torch.is_tensor(t)]
    return dict(weights=nbytes(ms.store.values()), loop=nbytes(loop),
                graph_pool=ms.steps.pool_bytes)


def decode_phase(torch, seed, init_range):
    import copy
    import numpy as np
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.ops.kernel_registry import kernels, reset_launches
    from paddle_tpu_torch import generation
    from paddle_tpu_torch.quant import (quantize_for_decode,
                                        quantize_weights_int8)
    cfg = GPTConfig.gpt3_125m(max_seq_len=1024,
                              initializer_range=init_range)
    L, vocab = cfg.num_layers, cfg.vocab_size
    model = GPTForPretraining(cfg, seed=seed)          # on the card
    copy_for_embeddings = copy.deepcopy(model)
    prompt = np.random.RandomState(seed).randint(
        0, vocab, (DEC_BATCH, DEC_PROMPT))
    ids = torch.from_numpy(prompt).to(DEVICE)
    recipes = (
        ("bf16", model, lambda m: None),
        ("wo8", model, quantize_for_decode),
        ("wo8 + int8 embeddings", copy_for_embeddings,
         lambda m: quantize_weights_int8(m, embeddings=True)))
    total = {k.name: 0 for k in kernels()}
    stats = {}
    kept = {}
    for name, m, quantize in recipes:
        quantize(m)
        torch.cuda.synchronize()
        a0 = torch.cuda.memory_allocated()
        m.generate(ids, max_new_tokens=DEC_NEW)         # warm-up, capture
        torch.cuda.synchronize()
        if name == "bf16":      # what generate keeps after a call
            kept = dict(
                allocated_after_first_call=torch.cuda.memory_allocated() - a0,
                **kept_bytes(torch, generation._MODEL_STEPS[m]))
        reset_launches()
        t0 = time.perf_counter()
        for _ in range(DEC_CALLS):
            out, _ = m.generate(ids, max_new_tokens=DEC_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels()}
        head = DEC_NEW * DEC_CALLS if "embeddings" in name else 0
        want = {**{k: 0 for k in launches},
                "decode_fused": L * DEC_NEW * DEC_CALLS,
                "int8_matvec": head,
                "layernorm_fused": L * (DEC_NEW + 1) * DEC_CALLS}
        if launches != want:
            raise AssertionError(f"decode {name}: launches {launches} != "
                                 f"{want}")
        for k, c in launches.items():
            total[k] += c
        streams = out[:, DEC_PROMPT:].tolist()
        if out.shape != (DEC_BATCH, DEC_LEN) or not all(
                0 <= t < vocab for s in streams for t in s):
            raise AssertionError(f"decode {name}: bad ids {out.shape}")
        agree, trail = [], []
        for p, s in zip(prompt.tolist(), streams):
            a, t = teacher_forced(torch, m, p, s)
            agree += a
            trail += t
        distinct = [len(set(s)) for s in streams]
        rate = sum(agree) / len(agree)
        # the eager token steps in turns with the captured ones: the
        # same 8 streams, and each mode's tokens/s
        turns = {"eager": [], "captured": []}
        for eager in (True, False, False, True):
            with eager_steps(eager):
                t0 = time.perf_counter()
                o, _ = m.generate(ids, max_new_tokens=DEC_NEW)
                torch.cuda.synchronize()
                turns["eager" if eager else "captured"].append(
                    DEC_BATCH * DEC_NEW / (time.perf_counter() - t0))
            if not torch.equal(o, out):
                raise AssertionError(f"decode {name}: the "
                                     f"{'eager' if eager else 'captured'} "
                                     "steps' streams differ")
        st = dict(tokens_per_s=DEC_BATCH * DEC_NEW * DEC_CALLS / wall,
                  call_s=wall / DEC_CALLS,
                  step_ms=wall * 1e3 / (DEC_CALLS * DEC_NEW),
                  tokens_per_s_turns=turns, same_tokens_eager=True,
                  tf_agree=rate, tf_max_trail_std=max(trail),
                  distinct=distinct, launches=launches)
        print(f"decode[{name}, b={DEC_BATCH} prompt={DEC_PROMPT} "
              f"new={DEC_NEW}]: " + json.dumps(st))
        if sum(1 for d in distinct if d == 1) > \
                MAX_CONSTANT_FRAC * len(distinct) or \
                sum(distinct) / len(distinct) < MIN_MEAN_DISTINCT:
            raise AssertionError(f"decode {name}: the streams barely vary "
                                 f"(distinct tokens per stream {distinct})")
        if rate < TF_AGREE or max(trail) > TF_MARGIN_STD:
            raise AssertionError(
                f"decode {name}: teacher-forced check failed: agreement "
                f"{rate:.3f} (need {TF_AGREE}), worst trail "
                f"{max(trail):.3f} std (limit {TF_MARGIN_STD})")
        if name == "bf16":
            for kw in (dict(decode_strategy="beam_search", num_beams=4,
                            length_penalty=0.6),
                       dict(decode_strategy="sampling", top_k=40, top_p=0.9,
                            temperature=0.8, seed=seed)):
                t0 = time.perf_counter()
                o, sc = m.generate(ids, max_new_tokens=32, **kw)
                torch.cuda.synchronize()
                ok = (o.shape == (DEC_BATCH, DEC_PROMPT + 32)
                      and bool(((o >= 0) & (o < vocab)).all())
                      and bool(sc.isfinite().all())
                      and torch.equal(o[:, :DEC_PROMPT], ids))
                dt = time.perf_counter() - t0
                with eager_steps():
                    eo, esc = m.generate(ids, max_new_tokens=32, **kw)
                same = torch.equal(eo, o) and torch.equal(esc, sc)
                print(f"decode[{kw['decode_strategy']}]: 32 tokens in "
                      f"{dt:.2f} s (first call: capture included), valid "
                      f"{ok}, the eager steps' tokens and scores {same}")
                if not ok or not same:
                    raise AssertionError(f"decode {kw}: invalid output, or "
                                         "eager and captured differ")
        if name != "wo8":   # the int8-head recipe's trace holds its copies
            st["profile"] = {
                mode: decode_profile(torch, m, ids, name,
                                     eager=mode == "eager")
                for mode in ("captured", "eager")}
        steps = generation._MODEL_STEPS[m].steps
        st["capture_ms"], st["pool_bytes"] = steps.capture_ms, steps.pool_bytes
        stats[name] = st
    stats["captures"] = {
        what: check_captures(generation.capture_records(m), f"decode {what}")
        for what, m in (("native and wo8", model),
                        ("wo8 + int8 embeddings", copy_for_embeddings))}
    print(f"decode captures on {card_line()}: "
          + json.dumps(stats["captures"]))
    # release() gives the kept state back to the allocator
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_allocated()
    for m in (model, copy_for_embeddings):
        generation.release(m)
    torch.cuda.synchronize()
    kept["freed_by_release_of_both_models"] = \
        a0 - torch.cuda.memory_allocated()
    stats["kept"] = kept
    print(f"decode kept state (bytes; native bf16 after its first call, "
          f"then freed) on {card_line()}: " + json.dumps(kept))
    stats["launches"] = total
    return stats


# ---------------------------------------------------------------------------
# phase 6: train GPT-3 125M
# ---------------------------------------------------------------------------

def make_train_step(torch, model, amp_on):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters())

    def loss_fn(ids, labels):
        with amp.auto_cast(enable=amp_on, dtype="bfloat16"):
            return model.loss(ids, labels)

    return TrainStep(model, loss_fn, opt)


def train_batch(torch, vocab, batch, seq, seed, dev):
    import numpy as np
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (batch, seq)).astype(np.int32)
    labels = rs.randint(0, vocab, (batch, seq)).astype(np.int32)
    return torch.from_numpy(ids).to(dev), torch.from_numpy(labels).to(dev)


# launches a layer and step of each training kernel: the MoE step runs
# the gather in the dispatch and in the combine's backward
TRAIN_KERNELS = {"flash_fwd": 1, "flash_bwd": 1, "layernorm_fwd_saved": 1}
MOE_TRAIN_KERNELS = {**TRAIN_KERNELS, "moe_gather": 2, "moe_combine": 1}


def check_train_launches(launches, L, steps, what, train=TRAIN_KERNELS,
                         extra=None):
    """Each kernel of `train` launched its count (`train[name]`) per
    layer and step, and `extra[name]` more (launches outside the steps),
    no other kernel at all."""
    extra = extra or {}
    want = {name: L * steps * train.get(name, 0) + extra.get(name, 0)
            for name in launches}
    if launches != want:
        raise AssertionError(f"train {what}: launches {launches} != layers "
                             f"x steps x each kernel's count + {extra} "
                             f"{want}")


def train_phase(torch, seed):
    import copy
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.ops.kernel_registry import kernels, reset_launches
    from paddle_tpu_torch.telemetry import gpt_train_flops_per_token
    cfg = GPTConfig.gpt3_125m(max_seq_len=1024, dropout=0.0)
    L = cfg.num_layers

    # f32 parity: the card with its kernels against the CPU with the
    # plain versions, from the same weights and batch
    cpu_model = GPTForPretraining(cfg, device="cpu", seed=seed)
    card_model = copy.deepcopy(cpu_model).to(DEVICE)
    runs = {}
    reset_launches()
    for name, model in (("cuda", card_model), ("cpu", cpu_model)):
        step = make_train_step(torch, model, amp_on=False)
        batch = train_batch(torch, cfg.vocab_size, PARITY_BATCH, PARITY_SEQ,
                            seed, model.gpt.wte.weight.device)
        t0 = time.perf_counter()
        runs[name] = [float(step(*batch)) for _ in range(PARITY_STEPS)]
        print(f"train: f32 b={PARITY_BATCH} s={PARITY_SEQ} on {name}: "
              f"losses {runs[name]} in {time.perf_counter() - t0:.1f} s")
    check_train_launches({k.name: k.launches for k in kernels()}, L,
                         PARITY_STEPS, "f32 parity")
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"], runs["cpu"]))
    if not rel <= PARITY_RTOL:
        raise AssertionError(f"train: card losses {runs['cuda']} vs CPU "
                             f"{runs['cpu']}: relative {rel:.2e} > "
                             f"{PARITY_RTOL}")
    del cpu_model, card_model, step

    # the bench shape under bf16 amp
    model = GPTForPretraining(cfg, device=DEVICE, seed=seed)
    step = make_train_step(torch, model, amp_on=True)
    ids, labels = train_batch(torch, cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                              0, DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    stats = timed_train(torch, step, (ids, labels), TRAIN_WARMUP,
                        TRAIN_STEPS,
                        gpt_train_flops_per_token(cfg, TRAIN_SEQ, n_params))
    stats["n_params"] = n_params
    print(f"train[bf16 amp, b={TRAIN_BATCH} s={TRAIN_SEQ}]: "
          + json.dumps(stats))
    check_train_launches(stats["launches"], L, TRAIN_STEPS, "bench shape")
    check_falling("train", stats, TRAIN_WARMUP + TRAIN_STEPS)
    profile_steps(torch, step, (ids, labels), TRAIN_STEPS,
                  f"train steps of {TRAIN_BATCH}x{TRAIN_SEQ} tokens", top=20)
    train_regions(torch, cfg, step, labels)
    return stats


def timed_train(torch, step, batch, warmup, steps, fpt):
    """`warmup` steps (the first one's loss kept), then the launch
    counters and the peak memory reset and `steps` timed steps on one
    batch (its first tensor [batch, seq, ...] gives the tokens): tokens/s
    and mean step ms on the host clock (ending in `.item()`), p50 and max
    step ms from CUDA events, MFU at `fpt` FLOPs per token, peak memory,
    the first and last losses and the launches of the timed steps."""
    from paddle_tpu_torch.ops.kernel_registry import kernels, reset_launches
    from paddle_tpu_torch.telemetry import device_peak_flops, mfu
    first = float(step(*batch))
    for _ in range(warmup - 1):
        step(*batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    t0 = time.perf_counter()
    ev[0].record()
    for i in range(steps):
        loss = step(*batch)
        ev[i + 1].record()
    final = loss.item()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels()}
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
    tps = batch[0].shape[0] * batch[0].shape[1] * steps / wall
    return dict(tokens_per_s=tps, step_ms=wall * 1e3 / steps,
                step_p50_ms=statistics.median(step_ms),
                step_max_ms=max(step_ms),
                mfu=mfu(tps, fpt, device_peak_flops(
                    torch.cuda.get_device_name(0))),
                loss_first=first, loss=final, flops_per_token=fpt,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                launches=launches)


def check_falling(what, stats, steps):
    first, final = stats["loss_first"], stats["loss"]
    if not math.isfinite(final) or not final < first:
        raise AssertionError(f"{what}: loss {final} after {steps} steps on "
                             f"one batch (first step {first}): not finite "
                             "or not falling")


def profile_steps(torch, step, batch, steps, what, top):
    """Device time by kernel over `steps` steps (CUDA activity only)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = step(*batch)
        loss.item()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    return print_profile(prof, steps, wall_ms, what, top)


def region_ms(torch, fn, reps=3):
    """Device time of `fn` (CUDA events around `reps` calls, after one
    warm-up call)."""
    fn()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def train_regions(torch, cfg, step, labels):
    """Time the step's plain-PyTorch regions alone, at its shapes: the
    AdamW update, the cross entropy over the bf16 logits and the
    composed tanh-gelu of the 12 MLPs, forward and backward each."""
    from paddle_tpu_torch import amp, nn
    rows = TRAIN_BATCH * TRAIN_SEQ
    grads = [p.grad for p in step.params]
    logits = torch.randn((rows, cfg.vocab_size), device=DEVICE,
                         dtype=torch.bfloat16, requires_grad=True)
    flat = labels.reshape(-1)
    x = torch.randn((rows, cfg.ffn_hidden_size), device=DEVICE,
                    dtype=torch.bfloat16, requires_grad=True)
    gx = torch.randn_like(x)

    def ce():
        with amp.auto_cast(dtype="bfloat16"):
            nn.functional.cross_entropy(logits, flat).backward()

    regions = {
        "adamw update": region_ms(
            torch, lambda: step.optimizer.update(step.params, grads)),
        "cross entropy fwd+bwd": region_ms(torch, ce),
        "gelu fwd+bwd x layers": cfg.num_layers * region_ms(
            torch, lambda: nn.gelu(x).backward(gx)),
    }
    print("train regions (ms per step): " + json.dumps(regions))


# ---------------------------------------------------------------------------
# phase 7: train the GPT-3 125M mixture-of-experts
# ---------------------------------------------------------------------------

def moe_config(num_layers=12):
    from paddle_tpu_torch.moe import GPTMoEConfig
    return GPTMoEConfig(vocab_size=50304, hidden_size=768,
                        num_layers=num_layers, num_heads=12,
                        max_seq_len=1024, dropout=0.0, num_experts=MOE_E,
                        expert_top_k=MOE_K, capacity_factor=MOE_CF)


def record_routes(torch, model, maps):
    """Hook every MoEFFN to append its routing map (comb_slot) of each
    forward to `maps`, recomputed from the layer's input and gate."""
    from paddle_tpu_torch.moe import MoEFFN
    from paddle_tpu_torch.moe.router import capacity_for, route_top_k

    def hook(mod, args):
        with torch.no_grad():
            t = args[0].reshape(-1, args[0].shape[-1])
            C = capacity_for(t.shape[0], mod.num_experts, mod.k,
                             mod.capacity_factor)
            maps.append(route_top_k(t @ mod.w_gate.to(t.dtype), mod.k,
                                    C)[1].cpu())

    return [m.register_forward_pre_hook(hook) for m in model.modules()
            if isinstance(m, MoEFFN)]


def moe_train_phase(torch, seed):
    import copy
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.moe import GPTMoE, note_step_stats
    from paddle_tpu_torch.moe.kernels import reset_persisting_l2
    from paddle_tpu_torch.ops.kernel_registry import kernels, reset_launches
    from paddle_tpu_torch.telemetry import gpt_train_flops_per_token

    # f32 parity: the card with its kernels against the CPU with the
    # plain versions, from the same weights and batch; full width, 2 layers
    cfg = moe_config(MOE_PARITY_LAYERS)
    cpu_model = GPTMoE(cfg, device="cpu", seed=seed)
    card_model = copy.deepcopy(cpu_model).to(DEVICE)
    runs, maps = {}, {}
    reset_launches()
    for name, model in (("cuda", card_model), ("cpu", cpu_model)):
        maps[name] = []
        hooks = record_routes(torch, model, maps[name])
        step = make_train_step(torch, model, amp_on=False)
        batch = train_batch(torch, cfg.vocab_size, PARITY_BATCH, PARITY_SEQ,
                            seed, model.gpt.wte.weight.device)
        t0 = time.perf_counter()
        runs[name] = [float(step(*batch)) for _ in range(PARITY_STEPS)]
        for h in hooks:
            h.remove()
        dropped = float(step._last_moe[1])
        print(f"moe train: f32 {MOE_PARITY_LAYERS} layers b={PARITY_BATCH} "
              f"s={PARITY_SEQ} on {name}: losses {runs[name]}, dropped_frac "
              f"{dropped:.4f} in {time.perf_counter() - t0:.1f} s")
    check_train_launches({k.name: k.launches for k in kernels()},
                         MOE_PARITY_LAYERS, PARITY_STEPS, "moe f32 parity",
                         MOE_TRAIN_KERNELS)
    moved = sum(int((a != b).any(dim=1).sum())
                for a, b in zip(maps["cuda"], maps["cpu"]))
    print(f"moe train: routing maps card vs CPU over {len(maps['cpu'])} "
          f"layer forwards: {moved} tokens with a different comb_slot")
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"], runs["cpu"]))
    if not rel <= PARITY_RTOL:
        raise AssertionError(f"moe train: card losses {runs['cuda']} vs CPU "
                             f"{runs['cpu']}: relative {rel:.2e} > "
                             f"{PARITY_RTOL}")
    del cpu_model, card_model, step

    # the bench shape under bf16 amp; MFU over the active FLOPs (the top-k
    # of E experts), as the JAX bench counts them (bench.py:757-763)
    cfg = moe_config()
    L = cfg.num_layers
    model = GPTMoE(cfg, device=DEVICE, seed=seed)
    step = make_train_step(torch, model, amp_on=True)
    ids, labels = train_batch(torch, cfg.vocab_size, MOE_BATCH, MOE_SEQ, 0,
                              DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    active = n_params - L * (MOE_E - MOE_K) * 2 * cfg.hidden_size \
        * cfg.ffn_hidden_size
    stats = timed_train(torch, step, (ids, labels), MOE_WARMUP, MOE_STEPS,
                        gpt_train_flops_per_token(cfg, MOE_SEQ, active))
    stats.update(n_params=n_params, active_params=active,
                 moe=note_step_stats(None, step._last_moe, MOE_E))
    print(f"moe train[bf16 amp, b={MOE_BATCH} s={MOE_SEQ} E={MOE_E} "
          f"k={MOE_K} cf={MOE_CF}]: " + json.dumps(stats))
    check_train_launches(stats["launches"], L, MOE_STEPS, "moe bench shape",
                         MOE_TRAIN_KERNELS)
    check_falling("moe train", stats, MOE_WARMUP + MOE_STEPS)
    if stats["moe"] is None:
        raise AssertionError(f"moe train: routing stats {step._last_moe} "
                             "not finite")
    busy = profile_steps(torch, step, (ids, labels), MOE_PROFILE_STEPS,
                         f"moe train steps of {MOE_BATCH}x{MOE_SEQ} tokens",
                         top=24)
    # again with CPU activity (slower on the host, the same kernels) to
    # tell the MoE layer's parts apart
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with moe_scopes(torch), profile(activities=activities) as prof:
        for _ in range(MOE_PROFILE_STEPS):
            loss = step(ids, labels)
        loss.item()
    print("moe train device ms per step by part: " + json.dumps(
        moe_step_parts(prof, MOE_PROFILE_STEPS, busy or 0.0)))
    reset_persisting_l2()
    return stats


@contextlib.contextmanager
def moe_scopes(torch):
    """Profiler ranges around the parts of the MoE layer, patched into
    `paddle_tpu_torch.moe.layer` for the duration: its forward ops carry
    the range, and its backward ops are found through the autograd
    sequence numbers (`moe_step_parts`)."""
    from torch.profiler import record_function
    from paddle_tpu_torch.moe import layer

    def scoped(part, fn):
        def call(*args, **kw):
            with record_function("moe: " + part):
                return fn(*args, **kw)
        return call

    class ScopedTorch:
        bmm = staticmethod(scoped("expert products", torch.bmm))

        def __getattr__(self, name):
            return getattr(torch, name)

    parts = {"moe_ffn_values": "gate product and casts",
             "route_top_k": "router", "gelu": "gelu chain",
             "moe_gather": "moe_gather", "moe_combine": "moe_combine"}
    saved = {name: getattr(layer, name) for name in [*parts, "torch"]}
    for name, part in parts.items():
        setattr(layer, name, scoped(part, saved[name]))
    layer.torch = ScopedTorch()
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(layer, name, fn)


def moe_step_parts(prof, steps, busy_ms):
    """Device ms per step by part of the MoE layer, from a profile with
    CPU and CUDA activity under `moe_scopes`: a kernel counts for the
    CPU op it is attached to; an op inside a range belongs to that
    range's part; an op inside an autograd node belongs to the part of
    the forward op whose sequence number the node carries ("... bwd").
    The port's own kernels go by name. The rest of the step (the dense
    part, the loss, the optimizer) is `busy_ms`, the busy time of a
    profile with CUDA activity only, less the parts: with CPU activity
    the device also records the ranges' own spans, and the kernels of
    the ops outside the MoE layer summed to more than the busy time."""
    from torch.autograd import DeviceType

    def scope(e):
        while e is not None:
            if e.name.startswith("moe: "):
                return e.name[5:]
            e = e.cpu_parent
        return None

    def part_of(op):
        part = scope(op)
        if part is not None:
            return part
        while op is not None and not op.name.startswith(
                "autograd::engine::evaluate_function"):
            op = op.cpu_parent
        if op is not None and op.sequence_nr in fwd:
            return fwd[op.sequence_nr] + " bwd"
        return None

    def own(name):
        return next((n for n in ("moe_gather", "moe_combine")
                     if n + "_kernel" in name), None)

    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    fwd = {e.sequence_nr: scope(e) for e in cpu
           if e.sequence_nr >= 0 and scope(e) is not None}
    parts = {}
    for e in cpu:
        part = part_of(e) if e.kernels else None
        for k in e.kernels:
            if part is not None and not own(k.name) \
                    and not k.name.startswith("moe: "):
                parts[part] = parts.get(part, 0.0) + k.duration / 1e3 / steps
    for e in device_events(prof):
        if own(e.key):
            key = own(e.key) + " kernel"
            parts[key] = parts.get(key, 0.0) + (
                e.self_device_time_total / 1e3 / steps)
    parts["rest of the step"] = busy_ms - sum(parts.values())
    return dict(sorted(parts.items(), key=lambda kv: -kv[1]))


# ---------------------------------------------------------------------------
# the 1.3B shapes: kernels, the training options, gpt1_3b_layer and
# gpt1_3b_full
# ---------------------------------------------------------------------------

# flash at GPT-3 1.3B's attention shapes: (batch, seq, heads, head_dim)
# — the shape timed since the 1.3B phases began and the seq-4096 full
# run's micro-batch of 8 x 4096
FLASH_1_3B = ((2, 2048, 16, 128), (8, 4096, 16, 128))
# the batch rows of each plain call: at 8 x 4096 the plain version's
# [b, n, s, s] f32 logits are 8.6 GB a tensor, so it runs a row at a time
FLASH_1_3B_PLAIN_ROWS = {(2, 2048, 16, 128): 2, (8, 4096, 16, 128): 1}
# K6 at the shapes its main paths give it: (rows, d, x, residual and
# weight dtypes) — the 1.3B layer step's 8 x 2048 rows in bf16 and as
# the amp step runs them (an f32 stream, a bf16 branch, f32 weights),
# the 1.3B full step's micro-batch of 16 x 2048 in bf16, and the 125M
# train step's 24 x 1024
LN_SAVED_PATHS = ((16384, 2048, "bfloat16", "bfloat16", "bfloat16"),
                  (32768, 2048, "bfloat16", "bfloat16", "bfloat16"),
                  (16384, 2048, "float32", "bfloat16", "float32"),
                  (24576, 768, "float32", "bfloat16", "float32"))
# the training options: one 1.3B-width block, card vs CPU
OPT_SEQ, OPT_STEPS = 256, 3
# the bench's gpt1_3b_layer (bench.py:496-535)
LAYER_BATCH, LAYER_SEQ, LAYER_WARMUP, LAYER_STEPS = 8, 2048, 3, 15
# the bench's gpt1_3b_full (bench.py:538-630) by sequence length:
# (micro-batch, K), the bench's own (16 at 2048, 8 at 4096); both cut the
# bench's 2 warm + 2 timed rounds to 1 + 1, and its 24 layers to
# FULL_LAYERS of each sequence length (the smoke's time limit)
FULL_RUNS = {2048: (16, 16), 4096: (8, 8)}
FULL_WARM_ROUNDS = 1
FULL_LAYERS = {2048: 8, 4096: 6}
FULL_MIN_HOST_GB = 16       # the pinned f32 master + moments: <= ~8.5 GB


def full_micro_launches(layers):
    """A micro-step's launches of the remat step: the forward and its
    recomputation each run flash_fwd and the add + LayerNorm site a
    layer."""
    return {"flash_fwd": 2 * layers, "flash_bwd": layers,
            "layernorm_fwd_saved": 2 * layers}


def kernel_line(row):
    """A timed row as text: ms, plain, library, bound, error, and any
    other timings it has."""
    extra = "".join(f", {k} {v:.4f}" for k, v in row.items()
                    if k.endswith("_ms") and k not in ("plain_ms",
                                                       "library_ms"))
    return (f"{row['ms']:.4f} ms (plain {row['plain_ms']:.3f}, library "
            f"{row['library_ms']:.4f}, bound {row['bound'][0]:.5f} by "
            f"{row['bound'][1]}, max_abs_err {row['max_abs_err']:.3e}"
            f"{extra})")


def ln_saved_row(torch, gen, dev, flush, nrows, d, xd, rd, wd):
    """layernorm_fwd_saved with the carry at one of LN_SAVED_PATHS
    against its plain version (out at the registry's tolerance of x's
    dtype, the sum and rstd at f32's, the carry bit for bit), then timed
    beside the plain version, F.layer_norm(x + r) and its bytes bound
    (the carry counted where x is bf16: an f32 x's carry is the sum);
    a bf16 x also without the carry."""
    from paddle_tpu_torch.ops.kernel_registry import get_kernel
    from paddle_tpu_torch.ops.layernorm import (layernorm_fwd_saved,
                                                layernorm_plain)
    F = torch.nn.functional
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    x = torch.randn((nrows, d), generator=gen).to(dev, dts[xd])
    r = torch.randn((nrows, d), generator=gen).to(dev, dts[rd])
    w = (1 + 0.1 * torch.randn((d,), generator=gen)).to(dev, dts[wd])
    bb = (0.1 * torch.randn((d,), generator=gen)).to(dev, dts[wd])
    kt = get_kernel("layernorm_fwd_saved").tol
    tag = f"[{nrows}x{d}, x {xd}, residual {rd}, weight {wd}]"
    got = layernorm_fwd_saved(x, r, w, bb, carry=True)
    ref = layernorm_plain(x, r, w, bb, carry=True)
    torch.cuda.synchronize()
    err = max(hold("layernorm_fwd_saved out" + tag, got[0], ref[0], kt[xd]),
              hold("layernorm_fwd_saved sum" + tag, got[1], ref[1],
                   kt["float32"]),
              hold("layernorm_fwd_saved rstd" + tag, got[2], ref[2],
                   kt["float32"]))
    if not same_bits(torch, got[3], ref[3]):
        raise AssertionError(f"layernorm_fwd_saved carry{tag}: not bit for "
                             "bit the sum in x's dtype")
    del got, ref
    size = {"float32": 4, "bfloat16": 2}
    row = dict(
        ms=median_ms(torch, lambda: layernorm_fwd_saved(x, r, w, bb,
                                                        carry=True), flush),
        plain_ms=median_ms(torch, lambda: layernorm_plain(
            x, r, w, bb, carry=True), flush, reps=20),
        library_ms=median_ms(torch, lambda: F.layer_norm(
            x + r, (d,), w, bb), flush),
        bound=bound(*ln_work(nrows, d, size[xd], size[rd], size[wd], True,
                             carry=xd != "float32"), "bfloat16"),
        max_abs_err=err)
    if xd != "float32":
        row["no_carry_ms"] = median_ms(
            torch, lambda: layernorm_fwd_saved(x, r, w, bb), flush)
    return row


def plain_by_batch(torch, fn, b, step):
    """`fn` (flash_attention_fwd_plain or _bwd_plain, whose arguments are
    [b, ...] tensors, an lse of [b n, sq] and flags) over `step` batch
    rows a call, its outputs joined: the same math without holding
    every row's [n, sq, sk] logits at once; `fn` itself when step >= b."""
    if step >= b:
        return fn

    def part(t, i):
        # lse is [b n, sq], batch-major: n of its rows a batch row
        per = t.shape[0] // b
        return t[i * per:(i + step) * per]

    def sliced(*args):
        ts = [a for a in args if isinstance(a, torch.Tensor)]
        flags = args[len(ts):]
        parts = [fn(*[part(t, i) for t in ts], *flags)
                 for i in range(0, b, step)]
        return tuple(torch.cat(o) for o in zip(*parts))

    return sliced


def flash_1_3b_rows(torch, gen, dev, flush, shape, tag_name):
    """flash_fwd and flash_bwd at `shape` (b, s, n, h; bf16, causal)
    against their plain versions at the registry's tolerance (the
    plain versions over FLASH_1_3B_PLAIN_ROWS batch rows a call; the
    backward twice, bitwise equal), then timed beside the plain
    versions, SDPA forward and backward and their bounds, L2 flushed."""
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_plain, flash_attention_fwd_plain, flash_bwd,
        flash_fwd)
    from paddle_tpu_torch.ops.kernel_registry import get_kernel
    F = torch.nn.functional
    b, s, n, h = shape
    scale = 1.0 / math.sqrt(h)
    tag = f"[bfloat16, b={b} s={s} n={n} h={h} causal]"
    tol = get_kernel("flash_fwd").tol["bfloat16"]
    step = FLASH_1_3B_PLAIN_ROWS[shape]
    fwd_plain = plain_by_batch(torch, flash_attention_fwd_plain, b, step)
    bwd_plain = plain_by_batch(torch, flash_attention_bwd_plain, b, step)
    q, k, v, dout = flash_inputs(torch, gen, torch.bfloat16, dev, b, s, s,
                                 n, h)
    out, lse = flash_fwd(q, k, v, True, scale)
    rout, rlse = fwd_plain(q, k, v, True, scale)
    torch.cuda.synchronize()
    fwd_err = max(hold("flash_fwd out" + tag, out, rout, tol),
                  hold("flash_fwd lse" + tag, lse, rlse, tol))
    got = flash_bwd(q, k, v, rout, rlse, dout, True, scale)
    ref = bwd_plain(q, k, v, rout, rlse, dout, True, scale)
    again = flash_bwd(q, k, v, rout, rlse, dout, True, scale)
    torch.cuda.synchronize()
    bwd_err = max(hold(f"flash_bwd d{nm}" + tag, g, r, tol)
                  for nm, g, r in zip("qkv", got, ref))
    for nm, g, a in zip("qkv", got, again):
        if not torch.equal(g, a):
            raise AssertionError(f"flash_bwd d{nm}{tag}: two calls on the "
                                 "same inputs differ")
    del got, ref, again, rout, rlse
    torch.cuda.empty_cache()
    lq, lk, lv = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    with torch.no_grad():
        sdpa_fwd = median_ms(torch, lambda: F.scaled_dot_product_attention(
            lq, lk, lv, is_causal=True), flush)
    lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
    go = dout.transpose(1, 2).contiguous()
    rows = {"flash_fwd": dict(
        ms=median_ms(torch, lambda: flash_fwd(q, k, v, True, scale), flush),
        plain_ms=median_ms(torch, lambda: fwd_plain(
            q, k, v, True, scale), flush, reps=5, warmup=1),
        library_ms=sdpa_fwd,
        bound=bound(*flash_work(b, s, s, n, h, True, 2, False), "bfloat16"),
        max_abs_err=fwd_err)}
    rows["flash_bwd"] = dict(
        ms=median_ms(torch, lambda: flash_bwd(q, k, v, out, lse, dout, True,
                                              scale), flush),
        plain_ms=median_ms(torch, lambda: bwd_plain(
            q, k, v, out, lse, dout, True, scale), flush, reps=3, warmup=1),
        library_ms=median_ms(torch, lambda: torch.autograd.grad(
            lo, (lq, lk, lv), go, retain_graph=True), flush),
        bound=bound(*flash_work(b, s, s, n, h, True, 2, True), "bfloat16"),
        max_abs_err=bwd_err)
    print(f"kernels: flash_bwd at the {tag_name} shape by kernel (L2 "
          "flushed, ms a call): " + json.dumps(bwd_parts(
              torch, lambda: flash_bwd(q, k, v, out, lse, dout, True, scale),
              flush)))
    # K3 and SDPA's backward in turns (K3, SDPA, SDPA, K3), each after a
    # read flush, in this one process: which of the two leads
    fns = {"flash_bwd": lambda: flash_bwd(q, k, v, out, lse, dout, True,
                                          scale),
           "sdpa_bwd": lambda: torch.autograd.grad(
               lo, (lq, lk, lv), go, retain_graph=True)}
    turns = {"flash_bwd": [], "sdpa_bwd": []}
    for name in ("flash_bwd", "sdpa_bwd", "sdpa_bwd", "flash_bwd"):
        turns[name].append(median_ms(torch, fns[name], flush))
    rows["flash_bwd"]["turns"] = turns
    ratio = statistics.mean(turns["flash_bwd"]) / statistics.mean(
        turns["sdpa_bwd"])
    print(f"kernels: flash_bwd and SDPA's backward in turns at the "
          f"{tag_name} shape (read flush, ms): {json.dumps(turns)}; "
          f"flash_bwd / SDPA {ratio:.3f}")
    del lo, lq, lk, lv, go, q, k, v, dout, out, lse, fns
    torch.cuda.empty_cache()
    for name, row in rows.items():
        print(f"kernels: {name} at the {tag_name} shape: " + kernel_line(row))
    return rows


def kernels_1_3b_phase(torch, seed):
    """flash_fwd and flash_bwd at FLASH_1_3B's two training shapes
    (`flash_1_3b_rows`) and layernorm_fwd_saved at LN_SAVED_PATHS
    against their plain versions at the registry's tolerance, then
    timed beside the plain versions, SDPA forward and backward /
    F.layer_norm(x + r) and their bounds, L2 flushed. The seq-2048
    rows keep the names flash_fwd and flash_bwd; the seq-4096 rows are
    named "flash_fwd s4096" and "flash_bwd s4096"."""
    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(seed + 13)
    flush = l2_flush(torch, dev)
    rows = {}
    for shape in FLASH_1_3B:
        tag_name = "1.3B" if shape[1] == 2048 else f"1.3B s{shape[1]}"
        for name, row in flash_1_3b_rows(torch, gen, dev, flush, shape,
                                         tag_name).items():
            rows[name if shape[1] == 2048 else f"{name} s{shape[1]}"] = row
    for shape in LN_SAVED_PATHS:
        name = "layernorm_fwd_saved {}x{} {}/{}/{}".format(*shape)
        rows[name] = ln_saved_row(torch, gen, dev, flush, *shape)
        print(f"kernels: {name} with the carry: " + kernel_line(rows[name]))
    del flush
    return rows


def init_block(torch, block, num_layers, seed):
    """A standalone block's weights as GPTForPretraining.init_weights
    draws them: N(0, 0.02), fc2 N(0, 0.02 / sqrt(2 num_layers)), zero
    biases, unit LayerNorm scales."""
    gen = torch.Generator(device=block.ln1.weight.device).manual_seed(seed)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if name.startswith("ln"):
                continue
            if name.endswith(".bias"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02 / math.sqrt(2 * num_layers)
                          if name.endswith("fc2.weight") else 0.02,
                          generator=gen)


# the optimizer rules by recipe name, and the options phase's arguments
# for those it runs with its own settings
RULES = {"sgd": "SGD", "momentum": "Momentum", "adam": "Adam",
         "adamw": "AdamW", "adamax": "Adamax", "adagrad": "Adagrad",
         "adadelta": "Adadelta", "rmsprop": "RMSProp", "lamb": "Lamb",
         "lars": "LarsMomentum", "dgc": "DGCMomentum"}


def rule(name):
    """The optimizer class of recipe `name` (RULES)."""
    from paddle_tpu_torch import optimizer as O
    return getattr(O, RULES[name])


def options_optimizer(name, block):
    """The option recipes over a block's parameters: Momentum with f32
    masters (for low-precision parameters), a global-norm clip and a
    warm-up into a cosine schedule; AdamW (masters on by default); each
    of the seven rules without masters (Lamb excluding biases and
    LayerNorms from its decay by name); Lookahead over Momentum and
    GradientMerge over AdamW, stepped eagerly."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    ps = block.parameters()
    if name == "momentum":
        return O.Momentum(learning_rate=O.lr.LinearWarmup(
            O.lr.CosineAnnealingDecay(0.05, T_max=4), warmup_steps=2,
            start_lr=0.01, end_lr=0.05), momentum=0.9, parameters=ps,
            multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0))
    if name == "lookahead":
        return O.Lookahead(O.Momentum(learning_rate=0.01, momentum=0.9,
                                      parameters=ps), alpha=0.5, k=2)
    if name == "gradient_merge":
        return O.GradientMerge(O.AdamW(learning_rate=1e-3, weight_decay=0.01,
                                       parameters=ps), k_steps=2)
    args = {"adamw": dict(learning_rate=1e-3, weight_decay=0.01),
            "adamax": dict(learning_rate=1e-3),
            "adagrad": dict(learning_rate=1e-2,
                            initial_accumulator_value=0.1),
            "adadelta": dict(learning_rate=1.0, weight_decay=O.L2Decay(1e-4)),
            "rmsprop": dict(learning_rate=1e-3, momentum=0.9, centered=True),
            "lamb": dict(learning_rate=1e-3,
                         exclude_from_weight_decay_fn=lambda n: n.endswith(
                             ".bias") or n.startswith("ln")),
            "lars": dict(learning_rate=0.5, lars_coeff=0.01),
            "dgc": dict(learning_rate=0.05, rampup_begin_step=1,
                        use_nesterov=True)}[name]
    return rule(name)(parameters=ps, **args)


# (recipe, parameter dtype, steps) of the block runs: the wrappers step
# eagerly 4 times, so that each updates (or syncs) twice; EMA rides on
# the Lookahead run and ModelAverage on the GradientMerge run
OPTION_RUNS = (("momentum", "float32", 2), ("adamw", "bfloat16", 2),
               ("adamax", "float32", 2), ("adagrad", "float32", 2),
               ("adadelta", "float32", 2), ("rmsprop", "float32", 2),
               ("lamb", "float32", 2), ("lars", "float32", 2),
               ("dgc", "float32", 2), ("lamb", "bfloat16", 2),
               ("adamax", "bfloat16", 2), ("lookahead", "float32", 4),
               ("gradient_merge", "float32", 4))


def block_run(torch, block, name, x, steps, loss_fn):
    """`steps` steps of recipe `name` on `block` -> (losses, the
    optimizer, the averaged weights' loss or None). Rules step through
    TrainStep; a wrapper steps eagerly (backward, `step()`,
    `clear_grad()`) with an average beside it (EMA by Lookahead,
    ModelAverage by GradientMerge), whose `apply()` gives the last loss
    and whose `restore()` must put every parameter back bit for bit."""
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.jit import TrainStep
    opt = options_optimizer(name, block)
    if name not in ("lookahead", "gradient_merge"):
        step = TrainStep(block, loss_fn, opt)
        losses = []
        for _ in range(steps):
            losses.append(float(step(x)))
            if hasattr(opt._learning_rate, "step"):
                opt._learning_rate.step()
        return losses, opt, None
    ps = list(block.parameters())
    avg = O.ExponentialMovingAverage(0.9, parameters=ps) \
        if name == "lookahead" else O.ModelAverage(
            0.5, parameters=ps, min_average_window=2, max_average_window=3)
    losses = []
    for _ in range(steps):
        loss = loss_fn(x)
        loss.backward()
        losses.append(float(loss.detach()))
        opt.step()
        opt.clear_grad()
        if name == "lookahead":
            avg.update()
        else:
            avg.accumulate()
    before = [p.detach().clone() for p in ps]
    with torch.no_grad(), avg.apply():
        averaged = float(loss_fn(x))
    if not all(torch.equal(a, b) for a, b in zip(before, ps)):
        raise AssertionError(f"train options {name}: restore() did not "
                             "give the parameters back bit for bit")
    return losses, opt, averaged


def options_block_runs(torch, seed):
    """One 1.3B-width block (b 1, s 256) for each of OPTION_RUNS, on the
    card and on the CPU (plain versions) from the same weights. The loss
    is the mean square of the block's output (f32), which stays away
    from 0. Losses (and the averaged weights' loss) within PARITY_RTOL;
    the card's training steps launch one of each training kernel a
    step."""
    import copy

    import numpy as np
    from paddle_tpu_torch.models.gpt import GPTBlock, GPTConfig
    from paddle_tpu_torch.ops.kernel_registry import kernels, reset_launches
    cfg = GPTConfig.gpt3_1_3b(max_seq_len=2048, dropout=0.0)
    x0 = np.random.RandomState(seed).randn(1, OPT_SEQ, cfg.hidden_size)
    out, launches = {}, {}
    for name, dt, steps in OPTION_RUNS:
        dtype = getattr(torch, dt)
        cpu_block = GPTBlock(cfg, device="cpu", dtype=dtype)
        init_block(torch, cpu_block, cfg.num_layers, seed)
        card_block = copy.deepcopy(cpu_block).to(DEVICE)
        runs, masters, averaged = {}, {}, {}
        for where, block in (("cuda", card_block), ("cpu", cpu_block)):
            x = torch.from_numpy(x0).to(block.ln1.weight.device, dtype)

            def loss_fn(xx, block=block):
                return block(xx).float().square().mean()

            reset_launches()
            runs[where], opt, averaged[where] = block_run(
                torch, block, name, x, steps, loss_fn)
            if where == "cuda":
                got = {k.name: k.launches for k in kernels()}
                # one of each training kernel a step; the averaged
                # weights' forward is an inference call (K1 and K7)
                check_train_launches(
                    got, 1, steps, f"options {name}",
                    extra=None if averaged[where] is None else
                    {"flash_fwd": 1, "layernorm_fused": 1})
                for k, v in got.items():
                    launches[k] = launches.get(k, 0) + v
            inner = getattr(opt, "inner", opt)
            masters[where] = [inner._states[id(p)].get("master")
                              for p in block.parameters()
                              if id(p) in inner._states]
        pairs = list(zip(runs["cuda"], runs["cpu"]))
        if averaged["cpu"] is not None:
            pairs.append((averaged["cuda"], averaged["cpu"]))
        rel = max(abs(a - b) / abs(b) for a, b in pairs)
        gap = max((float((a.cpu() - b).abs().max())
                   for a, b in zip(masters["cuda"], masters["cpu"])
                   if a is not None), default=None)
        tag = f"{name} {dt}"
        print(f"train options: {tag} 1.3B-width block b=1 s={OPT_SEQ}: card "
              f"{runs['cuda']} vs CPU {runs['cpu']}"
              + ("" if averaged["cpu"] is None else
                 f", averaged weights card {averaged['cuda']} vs CPU "
                 f"{averaged['cpu']}")
              + f", relative {rel:.2e}; masters' max gap card vs CPU {gap}")
        if not rel <= PARITY_RTOL:
            raise AssertionError(f"train options {tag}: relative {rel:.2e} "
                                 f"> {PARITY_RTOL}")
        out[tag] = dict(card=runs["cuda"], cpu=runs["cpu"], rel=rel,
                        master_gap=gap, averaged=averaged)
        del card_block, cpu_block
    return out, launches


# the optimizer.update timings: median of UPDATE_REPS
UPDATE_REPS = 10


def optimizer_update_times(torch, seed):
    """`optimizer.update` alone over GPT-3 125M's f32 parameters and
    random gradients, for each of RULES at its defaults (lr 1e-4): CUDA
    events, the median
    of UPDATE_REPS after 2 warm-up updates, L2 flushed; the bound is the
    bytes of the parameters (read and written), the gradients (read) and
    every state tensor (read and written) over the card's memory rate.
    Also the top-k that DGC's threshold takes on the token table (k =
    round(0.001 n))."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    dev = torch.device(DEVICE)
    cfg = GPTConfig.gpt3_125m(max_seq_len=1024, dropout=0.0)
    model = GPTForPretraining(cfg, device=DEVICE, seed=seed)
    named = list(model.named_parameters())
    params = [p for _, p in named]
    gen = torch.Generator(device=dev).manual_seed(seed)
    grads = [torch.randn(p.shape, generator=gen, device=dev) * 1e-3
             for p in params]
    n = sum(p.numel() for p in params)
    flush = l2_flush(torch, dev)
    times = {}
    for name in RULES:
        opt = rule(name)(1e-4, parameters=named)
        # the first warm-up update makes the states; count them after it
        opt.update(params, grads)
        n_state = sum(v.numel() for v in opt.state_dict().values()
                      if isinstance(v, torch.Tensor))
        ms = median_ms(torch, lambda: opt.update(params, grads), flush,
                       reps=UPDATE_REPS, warmup=1)
        nbytes = 4 * (2 * n + n + 2 * n_state)
        times[name] = dict(ms=ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                           bytes=nbytes)
        del opt
    wte = grads[[nm for nm, _ in named].index("gpt.wte.weight")]
    k = max(1, int(round(wte.numel() * (1.0 - 0.999))))
    times["dgc_topk_wte"] = dict(
        ms=median_ms(torch, lambda: torch.topk(wte.abs().reshape(-1), k),
                     flush, reps=UPDATE_REPS, warmup=2),
        numel=wte.numel(), k=k)
    print(f"train options: optimizer.update at GPT-3 125M ({n} f32 "
          f"parameters) on {card_line()}: " + json.dumps(times))
    del model, params, grads, flush
    return times


def fused_remat_runs(torch, seed):
    """GPT-3 125M at the train shape, bf16 amp, 3 AdamW steps from one
    seed: plain, with use_fused_ce, with remat. Fused vs plain losses
    within 2e-2 relative (one bf16 rounding of the logits); remat vs
    plain identical losses, gradients and parameters (the recompute
    runs the same kernels on the same inputs under the caller's amp, and
    K3-K5 use no atomics). Launches exact: remat runs each forward
    kernel twice. -> (results, launches)."""
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.ops.kernel_registry import kernels, reset_launches
    vocab = GPTConfig.gpt3_125m().vocab_size
    ids, labels = train_batch(torch, vocab, TRAIN_BATCH, TRAIN_SEQ, 0,
                              DEVICE)
    runs, launches = {}, {}
    for tag, fused, remat in (("plain", False, False),
                              ("fused_ce", True, False),
                              ("remat", False, True)):
        cfg = GPTConfig.gpt3_125m(max_seq_len=1024, dropout=0.0,
                                  remat=remat)
        model = GPTForPretraining(cfg, device=DEVICE, seed=seed)
        step = make_train_step(torch, model, amp_on=True)
        set_flags({"use_fused_ce": fused})
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            losses, ev = [], [torch.cuda.Event(enable_timing=True)
                              for _ in range(OPT_STEPS + 1)]
            ev[0].record()
            for i in range(OPT_STEPS):
                losses.append(step(ids, labels))
                ev[i + 1].record()
            losses = [float(x) for x in losses]
        finally:
            set_flags({"use_fused_ce": False})
        got = {k.name: k.launches for k in kernels()}
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        twice = 2 if remat else 1
        want = {k: 0 for k in got}
        want.update(flash_fwd=twice * cfg.num_layers * OPT_STEPS,
                    flash_bwd=cfg.num_layers * OPT_STEPS,
                    layernorm_fwd_saved=twice * cfg.num_layers * OPT_STEPS)
        if got != want:
            raise AssertionError(f"train options {tag}: launches {got} != "
                                 f"{want}")
        runs[tag] = dict(
            losses=losses,
            step_ms=[ev[i].elapsed_time(ev[i + 1]) for i in range(OPT_STEPS)],
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
            grads=[p.grad.detach().clone() for p in step.params],
            params=[p.detach().clone() for p in step.params])
        del model, step
    fused_rel = max(abs(a - b) / abs(b) for a, b in zip(
        runs["fused_ce"]["losses"], runs["plain"]["losses"]))
    same = {what: all(torch.equal(a, b) for a, b in zip(
        runs["remat"][what], runs["plain"][what])) for what in ("grads",
                                                               "params")}
    same["losses"] = runs["remat"]["losses"] == runs["plain"]["losses"]
    grad_gap = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(runs["remat"]["grads"],
                                   runs["plain"]["grads"]))
    summary = {tag: {k: r[k] for k in ("losses", "step_ms", "peak_mem_gb")}
               for tag, r in runs.items()}
    print(f"train options: GPT-3 125M b={TRAIN_BATCH} s={TRAIN_SEQ} bf16 "
          f"amp, {OPT_STEPS} steps: " + json.dumps(summary))
    print(f"train options: fused CE vs plain losses relative "
          f"{fused_rel:.2e}; remat vs plain identical {json.dumps(same)}, "
          f"largest gradient gap {grad_gap:.3e}")
    if not fused_rel <= 2e-2:
        raise AssertionError(f"train options: fused CE losses "
                             f"{runs['fused_ce']['losses']} vs "
                             f"{runs['plain']['losses']}")
    if not all(same.values()):
        raise AssertionError(f"train options: remat changed the step "
                             f"({same}, gradients up to {grad_gap:.3e} "
                             "apart)")
    return dict(fused_rel=fused_rel, remat_identical=same, **summary), \
        launches


def train_options_phase(torch, seed):
    block, launches = options_block_runs(torch, seed)
    torch.cuda.empty_cache()
    gpt, more = fused_remat_runs(torch, seed)
    torch.cuda.empty_cache()
    update = optimizer_update_times(torch, seed)
    torch.cuda.empty_cache()
    return dict(block=block, gpt125m=gpt, update=update, launches={
        k: launches.get(k, 0) + more.get(k, 0) for k in more})


def train_1_3b_layer_phase(torch, seed):
    """The bench's gpt1_3b_layer: one GPTBlock at GPT-3 1.3B's width,
    x = 0.02 N(0, 1) of 8 x 2048 x 2048 from RandomState(0), SGD(1e-6),
    bf16 amp, loss = mean of the block's output; 3 warm and 15 timed
    steps; MFU with the bench's 6 layer_params + 12 h seq FLOPs a token
    over the card's dense bf16 peak."""
    import numpy as np
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTBlock, GPTConfig
    from paddle_tpu_torch.optimizer import SGD
    cfg = GPTConfig.gpt3_1_3b(max_seq_len=LAYER_SEQ, dropout=0.0,
                              attn_dropout=0.0)
    block = GPTBlock(cfg, device=DEVICE)
    init_block(torch, block, cfg.num_layers, seed)
    opt = SGD(learning_rate=1e-6, parameters=block.parameters())

    def loss_fn(x):
        with amp.auto_cast(dtype="bfloat16"):
            return block(x).mean()

    step = TrainStep(block, loss_fn, opt)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        LAYER_BATCH, LAYER_SEQ, cfg.hidden_size).astype(np.float32)
        * 0.02).to(DEVICE)
    layer_params = sum(p.numel() for p in block.parameters())
    fpt = 6 * layer_params + 12 * cfg.hidden_size * LAYER_SEQ
    stats = timed_train(torch, step, (x,), LAYER_WARMUP, LAYER_STEPS, fpt)
    stats["layer_params"] = layer_params
    print(f"train 1.3B layer[bf16 amp, b={LAYER_BATCH} s={LAYER_SEQ}, SGD] "
          f"on {card_line()}: " + json.dumps(stats))
    check_train_launches(stats["launches"], 1, LAYER_STEPS, "1.3B layer")
    if not (math.isfinite(stats["loss"])
            and math.isfinite(stats["loss_first"])):
        raise AssertionError(f"train 1.3B layer: loss {stats['loss']}")
    profile_steps(torch, step, (x,), 5,
                  f"1.3B layer steps of {LAYER_BATCH}x{LAYER_SEQ} tokens",
                  top=12)
    return stats


def host_memory_gb():
    """(MemTotal, MemAvailable) of /proc/meminfo in GB."""
    got = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                got[key] = int(val.split()[0]) * 1024 / 1e9
    return got["MemTotal"], got["MemAvailable"]


def train_1_3b_full_phase(torch, seed, seq=2048):
    """The bench's gpt1_3b_full at its width, FULL_LAYERS[seq] of its 24
    layers: gpt3_1_3b(max_seq_len=seq, num_layers=FULL_LAYERS[seq],
    remat=True), use_fused_ce, bf16 amp,
    OffloadTrainStep(param_dtype="bfloat16") with AdamW(1e-4, wd 0.01,
    f32 masters and moments in pinned host memory), micro-batch and K
    from FULL_RUNS (the bench's: 16 x 2048 with K 16, 8 x 4096 with K
    8), 1 warm + 1 timed round (the bench: 2 + 2). Reports tokens/s and
    MFU (the bench's 6 N + 12 L d s FLOPs a token), micro-step and
    update-round ms and the update's share of a round, the update's copy
    bytes and rate, peak device memory, pinned host bytes and every
    round's losses; the micro-steps' launches must be exactly
    full_micro_launches(FULL_LAYERS[seq]) each."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed import OffloadTrainStep
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.ops.kernel_registry import kernels, reset_launches
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.telemetry import (device_peak_flops,
                                            gpt_train_flops_per_token, mfu)
    batch, K = FULL_RUNS[seq]
    what = f"train 1.3B full s={seq}"
    total, avail = host_memory_gb()
    print(f"{what}: host memory MemTotal {total:.1f} GB, "
          f"MemAvailable {avail:.1f} GB")
    if avail < FULL_MIN_HOST_GB:
        raise AssertionError(f"{what}: {avail:.1f} GB of host "
                             f"memory available, the pinned states need "
                             f"~8.5 GB (at least {FULL_MIN_HOST_GB} GB "
                             "asked)")
    layers = FULL_LAYERS[seq]
    cfg = GPTConfig.gpt3_1_3b(max_seq_len=seq, num_layers=layers,
                              dropout=0.0, attn_dropout=0.0, remat=True)
    model = GPTForPretraining(cfg, device=DEVICE, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters())

    def loss_fn(ids, labels):
        with amp.auto_cast(dtype="bfloat16"):
            return model.loss(ids, labels)

    set_flags({"use_fused_ce": True})
    try:
        t0 = time.perf_counter()
        step = OffloadTrainStep(model, loss_fn, opt,
                                accumulate_steps=K,
                                param_dtype="bfloat16")
        setup_s = time.perf_counter() - t0
        state_bytes = sum(v.numel() * v.element_size() for st in step._states
                          for v in st.values() if isinstance(v, torch.Tensor))
        ids, labels = train_batch(torch, cfg.vocab_size, batch,
                                  seq, 0, DEVICE)
        t0 = time.perf_counter()
        warm = [float(step(ids, labels))
                for _ in range(K * FULL_WARM_ROUNDS)]
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(K)]
        t0 = time.perf_counter()
        ev[0].record()
        losses = [step(ids, labels) for _ in range(K - 1)]
        ev[-1].record()
        torch.cuda.synchronize()
        micro_ms = ev[0].elapsed_time(ev[-1]) / (K - 1)
        t1 = time.perf_counter()
        losses.append(step(ids, labels))    # the K-th: micro-step + update
        torch.cuda.synchronize()
        last_ms = (time.perf_counter() - t1) * 1e3
        round_s = time.perf_counter() - t0
        losses = [float(x) for x in losses]
        launches = {k.name: k.launches for k in kernels()}
    finally:
        set_flags({"use_fused_ce": False})
    tokens = K * batch * seq
    fpt = gpt_train_flops_per_token(cfg, seq, n_params)
    tps = tokens / round_s
    update_ms = last_ms - micro_ms
    stats = dict(
        tokens_per_s=tps, mfu=mfu(tps, fpt, device_peak_flops(
            torch.cuda.get_device_name(0))),
        round_s=round_s, micro_step_ms=micro_ms, update_round_ms=update_ms,
        update_share=update_ms / (round_s * 1e3),
        update_copy_bytes=2 * state_bytes,
        update_copy_gb_per_s=2 * state_bytes / (update_ms / 1e3) / 1e9,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
        pinned_bytes=step.pinned_bytes, chunks=len(step._chunks),
        n_params=n_params, flops_per_token=fpt, setup_s=setup_s,
        warm_round_s=warm_s, losses_warm=warm, losses=losses,
        host_mem_total_gb=total, host_mem_available_gb=avail,
        launches=launches)
    print(f"{what}[{layers} of 24 layers, remat, fused CE, bf16 "
          f"params, offloaded AdamW, K={K} x {batch}x{seq}] on "
          f"{card_line()}: "
          + json.dumps(stats))
    micro = full_micro_launches(layers)
    want = {k: K * micro.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches} != "
                             f"{want} (K x a micro-step's)")
    if not all(math.isfinite(x) for x in warm + losses):
        raise AssertionError(f"{what}: losses {warm} {losses}")
    # where a micro-step's time goes (the next call: no update)
    set_flags({"use_fused_ce": True})
    try:
        profile_steps(torch, step, (ids, labels), 1,
                      f"1.3B full micro-step of {batch}x{seq} "
                      "tokens", top=15)
    finally:
        set_flags({"use_fused_ce": False})
    del step, opt, model
    return stats


# ---------------------------------------------------------------------------
# long context: the JAX bench's attn_16k and the single-card leg of its
# ringattn_128k
# ---------------------------------------------------------------------------

# (name, S, heads, head_dim, x's scale, timed calls): bench.py:837-927
# (x = N(0, 1) from RandomState(0), B 1) and bench.py:774-834 (0.3 N(0, 1),
# B 1, sp 1)
LONG_POINTS = (("attn_16k d128", 16384, 16, 128, 1.0, 10),
               ("attn_16k d64", 16384, 12, 64, 1.0, 10),
               ("ringattn_128k sp1", 131072, 16, 128, 0.3, 3))
# the f32 reference's chunks: [heads, rows, S] logits of 2^29 elements
LONG_CHUNK_ELEMS = 2 ** 29
# the 128k gradient's rows: the first, the last, and both sides of the
# kernels' 64-row tile edges at the start, the middle and the end
LONG_ROWS = (0, 1, 63, 64, 127, 128, 4095, 4096, 65535, 65536, 131007,
             131008, 131071)


def attention_ref_fwd(torch, x, scale, chunk):
    """Causal attention of q = k = v = x ([1, S, n, h]) in f32, in query
    chunks of `chunk` rows -> (out [n, S, h], lse [n, S]): the plain
    version's math without its [n, S, S] logits."""
    xf = x[0].float().transpose(0, 1).contiguous()
    n, S, _ = xf.shape
    out = torch.empty_like(xf)
    lse = torch.empty((n, S), dtype=torch.float32, device=x.device)
    for i0 in range(0, S, chunk):
        i1 = min(i0 + chunk, S)
        s = causal_logits(torch, xf, torch.arange(i0, i1, device=x.device),
                          i1, scale)
        m = s.amax(dim=-1, keepdim=True)
        p = s.sub_(m).exp_()
        den = p.sum(dim=-1, keepdim=True)
        out[:, i0:i1] = torch.matmul(p, xf[:, :i1]).div_(den)
        lse[:, i0:i1] = (m + den.log())[..., 0]
    return out, lse


def causal_logits(torch, xf, rows, keys, scale):
    """f32 logits [n, len(rows), keys] of query rows `rows` over keys
    0..keys-1, keys after a row at -inf."""
    s = torch.matmul(xf[:, rows], xf[:, :keys].transpose(1, 2)).mul_(scale)
    late = torch.arange(keys, device=xf.device)[None, :] > rows[:, None]
    return s.masked_fill_(late, -math.inf)


def attention_ref_grad_rows(torch, x, scale, out, lse, rows):
    """d sum(o^2) / dx at `rows` ([n, len(rows), h] f32) for o the causal
    attention of q = k = v = x: the plain backward's f32 math given the
    forward's output `out` ([n, S, h]; the port's own, as the backward
    kernel receives it) and the log-sum-exps `lse` ([n, S]): dO = 2 o,
    delta = rowsum(dO o), P_ij = exp(s_ij - lse_i); dQ_i = scale sum_j
    P_ij (dO_i v_j - delta_i) k_j over keys j <= i; dV_j = sum_i P_ij dO_i
    and dK_j = scale sum_i P_ij (dO_i v_j - delta_i) q_i over queries
    i >= j; autograd sums the three, as here."""
    xf = x[0].float().transpose(0, 1).contiguous()
    S = xf.shape[1]
    rows = torch.as_tensor(rows, device=x.device)
    dout = 2 * out
    delta = (dout * out).sum(dim=-1)
    # dQ at the rows: their queries over every key up to them
    p = causal_logits(torch, xf, rows, S, scale).sub_(
        lse[:, rows, None]).exp_()
    ds = torch.matmul(dout[:, rows], xf.transpose(1, 2)).sub_(
        delta[:, rows, None]).mul_(p)
    grad = torch.matmul(ds, xf).mul_(scale)
    # dK and dV at the rows: every query from them on over their keys
    st = torch.matmul(xf, xf[:, rows].transpose(1, 2)).mul_(scale)
    early = torch.arange(S, device=x.device)[:, None] < rows[None, :]
    pt = st.masked_fill_(early, -math.inf).sub_(lse[..., None]).exp_()
    grad += torch.matmul(pt.transpose(1, 2), dout)
    dst = torch.matmul(dout, xf[:, rows].transpose(1, 2)).sub_(
        delta[..., None]).mul_(pt)
    grad += torch.matmul(dst.transpose(1, 2), xf).mul_(scale)
    return grad


def hold_rows(name, got, ref, rtol):
    """|got - ref| / |ref| <= rtol over each head's row (the 2-norm over
    the head dim): the check that stays strict where the values are
    small, as the 128k point's late rows are; returns the worst."""
    rel = ((got.float() - ref).norm(dim=-1)
           / ref.norm(dim=-1).clamp_min(1e-30)).max().item()
    if not rel <= rtol:
        raise AssertionError(f"{name}: a row {rel:.3e} from the f32 "
                             f"reference, relative, above {rtol}")
    return rel


def long_context_phase(torch, seed):
    """The port's scaled_dot_product_attention(x, x, x, is_causal=True)
    (K1 forward, K3 backward) in bf16 at LONG_POINTS, with the gradient
    of sum(o.float()^2) with respect to x. One counted forward and
    backward a point (one flash_fwd and one flash_bwd launch), its out
    and gradient held against the f32 math (`attention_ref_fwd`,
    `attention_ref_grad_rows`; at 16384 every row, at 131072 the whole
    output and the gradient at LONG_ROWS) at the registry's bf16
    tolerance, elementwise and per row; then forward and forward +
    backward ms (CUDA events, medians), TFLOP/s by the bench's 6 B H S^2
    D, flash_bwd alone, and SDPA's forward, forward + backward and
    backward on the same x as yardsticks, beside the bounds."""
    import numpy as np
    from paddle_tpu_torch.ops.attention import scaled_dot_product_attention
    from paddle_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    from paddle_tpu_torch.ops.kernel_registry import (get_kernel, kernels,
                                                      reset_launches)
    F = torch.nn.functional
    dev = torch.device(DEVICE)
    tol = get_kernel("flash_fwd").tol["bfloat16"]
    flush = l2_flush(torch, dev)
    points, launches = {}, {}
    for name, S, n, h, amp, reps in LONG_POINTS:
        scale = 1.0 / math.sqrt(h)
        x = torch.from_numpy(np.random.RandomState(0).randn(
            1, S, n, h).astype(np.float32)).to(dev, torch.bfloat16)
        if amp != 1.0:
            x = x * amp                 # in bf16, as the bench scales it

        def fwd_bwd(x=x):
            xg = x.detach().requires_grad_()
            o = scaled_dot_product_attention(xg, xg, xg, is_causal=True)
            return o, torch.autograd.grad((o.float() ** 2).sum(), xg)[0]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        o, dx = fwd_bwd()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        got = {k.name: k.launches for k in kernels()}
        want = {k: int(k in ("flash_fwd", "flash_bwd")) for k in got}
        if got != want:
            raise AssertionError(f"long_context {name}: launches {got} != "
                                 f"{want}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        t0 = time.perf_counter()
        chunk = max(64, LONG_CHUNK_ELEMS // (n * S))
        ref, lse = attention_ref_fwd(torch, x, scale, chunk)
        o_t = o.detach()[0].transpose(0, 1)
        tag = f" [{name}: bf16, S {S}, {n} x {h}, causal]"
        err = dict(out=hold("long_context out" + tag, o_t, ref, tol),
                   out_row=hold_rows("long_context out" + tag, o_t, ref,
                                     tol[0]))
        # the backward's reference takes the port's out, as its kernel
        # does: with o near one-hot (unit x at 16k), dO v_j and delta
        # cancel, and o's bf16 rounding moves delta by more than the
        # tolerance
        rows = range(S) if S <= 16384 else LONG_ROWS
        gdx = dx[0].transpose(0, 1)[:, list(rows)]
        rdx = torch.cat([attention_ref_grad_rows(
            torch, x, scale, o_t.float(), lse, list(rows)[i:i + chunk])
            for i in range(0, len(rows), chunk)], dim=1)
        err.update(dx=hold("long_context dx" + tag, gdx, rdx, tol),
                   dx_row=hold_rows("long_context dx" + tag, gdx, rdx,
                                    tol[0]))
        ref_s = time.perf_counter() - t0
        dout = 2 * o.detach()
        del ref, lse, o_t, gdx, rdx, o, dx
        torch.cuda.empty_cache()
        with torch.no_grad():
            fwd_ms = median_ms(torch, lambda: scaled_dot_product_attention(
                x, x, x, is_causal=True), flush, reps=reps, warmup=1)
        fb_ms = median_ms(torch, fwd_bwd, flush, reps=reps, warmup=1)
        out, lse = flash_fwd(x, x, x, True, scale)
        bwd_ms = median_ms(torch, lambda: flash_bwd(
            x, x, x, out, lse, dout, True, scale), flush, reps=reps, warmup=1)
        del out, lse
        xs = x.transpose(1, 2).contiguous()
        with torch.no_grad():
            sdpa_fwd = median_ms(torch, lambda: F.scaled_dot_product_attention(
                xs, xs, xs, is_causal=True), flush, reps=reps, warmup=1)

        def sdpa_fwd_bwd():
            xg = xs.detach().requires_grad_()
            so = F.scaled_dot_product_attention(xg, xg, xg, is_causal=True)
            return torch.autograd.grad((so.float() ** 2).sum(), xg)

        sdpa_fb = median_ms(torch, sdpa_fwd_bwd, flush, reps=reps, warmup=1)
        xg = xs.detach().requires_grad_()
        so = F.scaled_dot_product_attention(xg, xg, xg, is_causal=True)
        go = dout.transpose(1, 2).contiguous()
        sdpa_bwd = median_ms(torch, lambda: torch.autograd.grad(
            so, xg, go, retain_graph=True), flush, reps=reps, warmup=1)
        del so, xg, go, xs, dout
        points[name] = dict(
            S=S, heads=n, head_dim=h, fwd_ms=fwd_ms, fwd_bwd_ms=fb_ms,
            tflops=6 * n * S * S * h / (fb_ms / 1e3) / 1e12,
            flash_bwd_ms=bwd_ms, sdpa_fwd_ms=sdpa_fwd,
            sdpa_fwd_bwd_ms=sdpa_fb, sdpa_bwd_ms=sdpa_bwd,
            fwd_bound=bound(*flash_work(1, S, S, n, h, True, 2, False),
                            "bfloat16"),
            bwd_bound=bound(*flash_work(1, S, S, n, h, True, 2, True),
                            "bfloat16"),
            max_abs_err=err, checked_rows=len(rows), reference_s=ref_s,
            peak_mem_gb=peak)
        print(f"long_context: {name} on {card_line()}: "
              + json.dumps(points[name]))
        del x
        torch.cuda.empty_cache()
    del flush
    return dict(points=points, launches=launches)


# ---------------------------------------------------------------------------
# GPT-3 13B weight-only-int8 decode (tools/serve_13b_w8a16.py's recipe)
# and GPT-MoE served through the engine and generate
# ---------------------------------------------------------------------------

# K7 at GPT-3 13B's width: (rows, d, x dtype, residual dtype, unaligned).
# Rows of 5120 take the staged form with 16-byte chunks; 5118 and an x
# one element off its allocation take its one-element chunks; 4104 is
# the narrowest width past the register-resident instances; 300 rows
# are more CTAs than SMs
LN_PAIR_13B_CHECKS = tuple(
    (rows, 5120, dt, dt, False) for rows in (1, 8, 16)
    for dt in ("float32", "bfloat16")) + (
    (16, 5120, "bfloat16", "bfloat16", True),
    (16, 5120, "float32", "float32", True),
    (16, 5120, "bfloat16", "float32", False),
    (8, 5118, "float32", "float32", False),
    (8, 5118, "bfloat16", "bfloat16", False),
    (3, 4104, "bfloat16", "bfloat16", False),
    (300, 5120, "bfloat16", "bfloat16", False))
LN_13B_TIMED_ROWS = (1, 8, 16)
D_13B = 5120
# decode_fused at 13B's 40 heads of 128 over the recipe's bf16 cache of
# 64 + 64 positions at batch 1: every decode step's key count, 65..128
K8_13B_HEADS, K8_13B_DIM, K8_13B_LEN = 40, 128, 128
K8_13B_OFFS = tuple(range(63, 128))
K8_13B_TIMED_OFF = 95               # the mean step position
SERVE_13B_PROMPT, SERVE_13B_NEW = 64, 64
# At the recipe's init std (GPTConfig's 0.02) the random 40-layer model's
# greedy stream collapses to a few tokens. The witness scales the same
# weights as if drawn at SERVE_13B_WITNESS_STD, where the stream varies,
# and decodes the model's first D blocks at each depth D: in bf16
# through the kernels, and at full depth in f32 with an f32 cache
# through the same kernels' f32 instances, each stream teacher-forced
# through the same blocks' f32 forward. A fault of what only 13B runs
# (K7's wide form, K8 at 40 x 128, the 5120 / 20480 linears) shows at
# every depth and in f32; bf16 rounding grown through depth shows only
# in bf16 and grows with D. Held: the teacher-forced bar and the
# distinct floor in f32 at full depth; in bf16 at SERVE_13B_HELD_DEPTHS
# the trail and the floor (there many of the 50304 logits lie within
# bf16's rounding of the best, so near-tie flips cost more than 5 % of
# the tokens, each by a few hundredths of a std)
SERVE_13B_WITNESS_STD = 0.04
SERVE_13B_WITNESS_DEPTHS = (1, 2, 4, 8, 16, 40)
SERVE_13B_HELD_DEPTHS = (1, 2)
# the MoE serve phase: the moe train phase's model (moe_config) in bf16
# at its capacity factor, and in f32 at a capacity where no choice is
# ever dropped (C = n at E / k), where routing is a function of the
# token alone, so the dense forward over a whole stream routes every
# token as the serving steps did and the teacher-forced bar applies
MOE_DROPLESS_CF = MOE_E / MOE_K
MOE_SERVE_ROWS = (SLOTS, CHUNK)     # a decode step's rows, a chunk's
MOE_SERVE_KERNELS = ("moe_gather", "moe_combine")
MOE_REF_NEW = 32                    # tokens the CPU step-wise reference takes


def kernels_13b_phase(torch, seed):
    """K7 (layernorm_fused's pair) at LN_PAIR_13B_CHECKS against its
    plain version (out at the registry's tolerance, the carry bit for
    bit), then timed at 1, 8 and 16 rows of 5120 in bf16 beside the
    plain version, F.layer_norm(x + r) and the bytes bound; K8
    (decode_fused) at 40 heads of 128 over a bf16 cache of 128 keys at
    every step position of the recipe (keys 64..128), the host position
    and the position read from device memory bit for bit the same,
    within the registry's bf16 tolerance of the plain version, then
    timed at the mean position beside SDPA over the valid prefix.
    -> rows named "layernorm_fused 8x5120 bf16", "decode_fused 40x128
    bf16"."""
    from paddle_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_plain, decode_split)
    from paddle_tpu_torch.ops.kernel_registry import get_kernel
    from paddle_tpu_torch.ops.layernorm import (layernorm_fused_pair,
                                                layernorm_fused_pair_plain)
    F = torch.nn.functional
    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(seed + 17)
    bf16 = torch.bfloat16
    errs = ln_pair_checks(torch, gen, dev, LN_PAIR_13B_CHECKS)
    for xd, e in sorted(errs.items()):
        print(f"kernels: layernorm_fused pair at d {D_13B} (and 5118, 4104) "
              f"{xd} max_abs_err {e:.3e} (tol rtol, atol = "
              f"{get_kernel('layernorm_fused').tol[xd]}), the carry bit "
              "for bit")
    k8 = get_kernel("decode_fused")
    B, n, h, L = 1, K8_13B_HEADS, K8_13B_DIM, K8_13B_LEN
    nh = n * h
    q = torch.randn((B, 1, nh), generator=gen).to(dev, bf16)
    k, v = (torch.randn((B, L, nh), generator=gen).to(dev, bf16)
            for _ in range(2))
    off_dev = torch.zeros((), dtype=torch.int32, device=dev)
    k8_err = 0.0
    for off in K8_13B_OFFS:
        got = decode_attention(q, k, v, off, n)
        off_dev.fill_(off)
        got_dev = decode_attention(q, k, v, off_dev, n, decode_split(off)[0])
        ref = decode_attention_plain(q, k, v, off, n)
        torch.cuda.synchronize()
        what = f"decode_fused[q bf16, cache bf16, b=1 n={n} h={h} off={off}]"
        k8_err = max(k8_err, hold(what, got, ref, k8.tol["bfloat16"]))
        if not same_bits(torch, got, got_dev):
            raise AssertionError(f"{what}: the device position differs")
    print(f"kernels: decode_fused at 40 x 128, bf16 cache, keys "
          f"{K8_13B_OFFS[0] + 1}..{K8_13B_OFFS[-1] + 1}: max_abs_err "
          f"{k8_err:.3e} (tol {k8.tol['bfloat16']}), the device position's "
          "bits")

    flush = l2_flush(torch, dev)
    rows = {}
    for nrows in LN_13B_TIMED_ROWS:
        a = tuple(t.to(dev, bf16) for t in (
            torch.randn((nrows, D_13B), generator=gen),
            torch.randn((nrows, D_13B), generator=gen),
            1 + 0.1 * torch.randn((D_13B,), generator=gen),
            0.1 * torch.randn((D_13B,), generator=gen)))
        row = dict(
            ms=median_ms(torch, lambda: layernorm_fused_pair(*a), flush),
            warm_ms=median_ms(torch, lambda: layernorm_fused_pair(*a),
                              None),
            plain_ms=median_ms(torch, lambda: layernorm_fused_pair_plain(
                *a), flush),
            library_ms=median_ms(torch, lambda: F.layer_norm(
                a[0] + a[1], (D_13B,), a[2], a[3]), flush),
            bound=bound(*ln_work(nrows, D_13B, 2, 2, 2, False, carry=True),
                        "bfloat16"),
            max_abs_err=errs["bfloat16"])
        name = f"layernorm_fused {nrows}x{D_13B} bf16"
        rows[name] = row
        print(f"kernels: {name} (the pair, with the carry): "
              + kernel_line(row))
    rows[f"layernorm_fused 1x{D_13B} bf16"]["f32_max_abs_err"] = \
        errs["float32"]
    off = K8_13B_TIMED_OFF
    sq = q.reshape(B, 1, n, h).transpose(1, 2)
    sk, sv = (t[:, :off + 1].reshape(B, off + 1, n, h).transpose(1, 2)
              for t in (k, v))
    nbytes = 2 * B * (off + 1) * nh * 2 + B * nh * (2 + 4)
    row = dict(
        ms=median_ms(torch, lambda: decode_attention(q, k, v, off, n), flush),
        plain_ms=median_ms(torch, lambda: decode_attention_plain(
            q, k, v, off, n), flush),
        library_ms=median_ms(torch, lambda: F.scaled_dot_product_attention(
            sq, sk, sv), flush),
        bound=bound(nbytes, 4 * B * n * (off + 1) * h, "bfloat16"),
        max_abs_err=k8_err)
    rows["decode_fused 40x128 bf16"] = row
    print(f"kernels: decode_fused B=1 40x128 off={off} bf16 q and cache: "
          + kernel_line(row))
    del flush
    return rows


def serve_13b_phase(torch, seed):
    """tools/serve_13b_w8a16.py's recipe through the port's entry point
    (`paddle_tpu_torch.tools.serve_13b_w8a16`): GPT-3 13B drawn on the
    card a piece at a time in f32, its linears quantized there, floats
    cast to bf16; then greedy `generate` at batch 1,
    a 64-token prompt from RandomState(seed), 64 new tokens, a warm call
    (the capture) and a timed call. Checks: the card holds no f32 linear
    (every linear int8, every parameter bf16, the f32 buffers only the
    scales); the serving set's bytes against the card's allocation; the
    call's peak; tokens/s beside its bound (the serving set read once a
    token); exactly 40 decode_fused and 40 layernorm_fused launches a
    token step (and 40 layernorm_fused in the prefill), nothing else;
    the timed call's tokens = the warm call's; every token teacher-forced
    through the same wo8 model's f32 forward on the card (each linear
    dequantized in f32): the f32 argmax at >= TF_AGREE of positions,
    never trailing by more than TF_MARGIN_STD; what generate keeps after
    a call and what `generation.release` frees; then the depth witness
    (witness_13b)."""
    import gc
    from paddle_tpu_torch import generation
    from paddle_tpu_torch.ops.kernel_registry import kernels, reset_launches
    from paddle_tpu_torch.quant import WeightOnlyInt8Linear
    from paddle_tpu_torch.tools.serve_13b_w8a16 import (
        build_w8a16, config_13b, decode, prompt_ids, serving_bytes)
    gc.collect()
    torch.cuda.empty_cache()
    total, avail = host_memory_gb()
    base = torch.cuda.memory_allocated()
    cfg = config_13b()
    L = cfg.num_layers
    t0 = time.perf_counter()
    model, secs = build_w8a16(cfg, seed=seed, device=DEVICE)
    secs["total"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    device_bytes = torch.cuda.memory_allocated() - base
    set_bytes = serving_bytes(model)
    linears = [m for m in model.modules()
               if isinstance(m, WeightOnlyInt8Linear)]
    f32_buffers = [n for n, b in model.named_buffers()
                   if b.dtype == torch.float32]
    if (len(linears) != 4 * L
            or any(m.wq.dtype != torch.int8 for m in linears)
            or any(p.dtype != torch.bfloat16 for p in model.parameters())
            or any(not n.endswith(".w_scale") or b.dim() != 1
                   for n, b in model.named_buffers()
                   if b.dtype == torch.float32)):
        raise AssertionError("serve 13b: the card holds a float linear or "
                             "an f32 parameter")
    codes = sum(m.wq.numel() for m in linears)
    ids = prompt_ids(cfg.vocab_size, 1, SERVE_13B_PROMPT, seed)
    torch.cuda.reset_peak_memory_stats()
    first, first_s = decode(model, ids, SERVE_13B_NEW)
    kept = kept_bytes(torch, generation._MODEL_STEPS[model])
    reset_launches()
    out, dt = decode(model, ids, SERVE_13B_NEW)
    launches = {k.name: k.launches for k in kernels()}
    peak = torch.cuda.max_memory_allocated() - base
    want = {**{k: 0 for k in launches},
            "decode_fused": L * SERVE_13B_NEW,
            "layernorm_fused": L * (SERVE_13B_NEW + 1)}
    if launches != want:
        raise AssertionError(f"serve 13b: launches {launches} != {want}")
    if not torch.equal(out, first):
        raise AssertionError("serve 13b: the timed call's tokens differ "
                             "from the warm call's")
    prompt, stream = ids[0].tolist(), out[0, SERVE_13B_PROMPT:].tolist()
    if len(stream) != SERVE_13B_NEW or not all(
            0 <= t < cfg.vocab_size for t in stream):
        raise AssertionError(f"serve 13b: bad ids {out.shape}")
    with generation._decode_weights(model, torch.float32):
        agree, trail = teacher_forced(torch, model, prompt, stream)
    rate = sum(agree) / len(agree)
    tps = SERVE_13B_NEW / dt
    profile = decode_profile(torch, model, ids.to(DEVICE), "13B w8a16")
    bound_ms = set_bytes / HBM_BYTES_PER_S * 1e3
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_allocated()
    generation.release(model)
    torch.cuda.synchronize()
    kept["freed_by_release"] = a0 - torch.cuda.memory_allocated()
    stats = dict(
        seconds={**secs, "first_call": first_s, "timed_call": dt},
        host_mem_total_gb=total, host_mem_available_gb=avail,
        serving_set_gib=set_bytes / GIB, device_alloc_gib=device_bytes / GIB,
        int8_codes=codes, f32_scale_buffers=len(f32_buffers),
        call_peak_gib=peak / GIB, tokens_per_s=tps,
        ms_per_token=dt * 1e3 / SERVE_13B_NEW, bound_ms_per_token=bound_ms,
        bound_tokens_per_s=1e3 / bound_ms, kept=kept,
        launches_per_step={"decode_fused": launches["decode_fused"]
                           // SERVE_13B_NEW,
                           "layernorm_fused": (launches["layernorm_fused"]
                                               - L) // SERVE_13B_NEW},
        tf_agree=rate, tf_max_trail_std=max(trail),
        distinct=len(set(stream)), profile=profile, launches=launches)
    print(f"serve 13b[w8a16, b=1 prompt={SERVE_13B_PROMPT} "
          f"new={SERVE_13B_NEW}] on {card_line()}: " + json.dumps(stats))
    if rate < TF_AGREE or max(trail) > TF_MARGIN_STD:
        raise AssertionError(
            f"serve 13b: teacher-forced check failed: agreement {rate:.3f} "
            f"(need {TF_AGREE}), worst trail {max(trail):.3f} std (limit "
            f"{TF_MARGIN_STD})")
    stats["witness"] = witness_13b(torch, model, linears, ids, prompt,
                                   cfg.initializer_range)
    del model, linears, first, out
    gc.collect()
    torch.cuda.empty_cache()
    return stats


def depth_view(torch, model, depth, dtype):
    """A GPTForPretraining over `model`'s embeddings, its first `depth`
    blocks and its final LayerNorm (the same modules, nothing copied),
    whose config gives that depth and the KV cache's `dtype`."""
    import copy
    from paddle_tpu_torch.models.gpt import GPTForPretraining
    cfg = copy.copy(model.config)
    cfg.num_layers, cfg.dtype = depth, dtype
    view = GPTForPretraining(cfg, device="meta")
    core = model.gpt
    view.gpt.wte, view.gpt.wpe, view.gpt.ln_f = core.wte, core.wpe, core.ln_f
    view.gpt.blocks = torch.nn.ModuleList(list(core.blocks)[:depth])
    return view


def witness_13b(torch, model, linears, ids, prompt, std):
    """The 13B weights scaled in place as if drawn at
    SERVE_13B_WITNESS_STD (every int8 linear's scales and the embedding
    tables: a per-channel int8 code is the same at any scale), then one
    greedy call of the first D blocks for each D of
    SERVE_13B_WITNESS_DEPTHS in bf16, and one of all 40 in f32 with an f32
    cache, each teacher-forced through the same blocks' f32 forward:
    agreement, worst trail and distinct tokens. Printed, then held: a
    stream of >= MIN_MEAN_DISTINCT distinct tokens and the worst trail
    within TF_MARGIN_STD in bf16 at SERVE_13B_HELD_DEPTHS and in f32 at
    full depth, where the agreement must also reach TF_AGREE."""
    from paddle_tpu_torch import generation
    from paddle_tpu_torch.tools.serve_13b_w8a16 import decode
    scale = SERVE_13B_WITNESS_STD / std
    with torch.no_grad():
        for m in linears:
            m.w_scale.mul_(scale)
        for t in (model.gpt.wte.weight, model.gpt.wpe.weight):
            t.mul_(scale)
    runs = [(f"bf16 depth {d}", d, "bfloat16")
            for d in SERVE_13B_WITNESS_DEPTHS]
    runs.append((f"f32 depth {model.config.num_layers}",
                 model.config.num_layers, "float32"))
    out = {}
    for what, depth, dtype in runs:
        view = depth_view(torch, model, depth, dtype)
        got, _ = decode(view, ids, SERVE_13B_NEW, dtype=dtype)
        generation.release(view)
        stream = got[0, SERVE_13B_PROMPT:].tolist()
        with generation._decode_weights(view, torch.float32):
            agree, trail = teacher_forced(torch, view, prompt, stream)
        out[what] = dict(distinct=len(set(stream)),
                         tf_agree=sum(agree) / len(agree),
                         tf_max_trail_std=max(trail))
        del view, got
    print(f"serve 13b: witness at init {SERVE_13B_WITNESS_STD}, the first D "
          f"blocks decoded and teacher-forced through their f32 forward: "
          + json.dumps(out))
    held = [(f"bf16 depth {d}", 0.0) for d in SERVE_13B_HELD_DEPTHS]
    held.append((runs[-1][0], TF_AGREE))
    for what, need in held:
        r = out[what]
        if (r["tf_agree"] < need or r["tf_max_trail_std"] > TF_MARGIN_STD
                or r["distinct"] < MIN_MEAN_DISTINCT):
            raise AssertionError(
                f"serve 13b witness {what}: agreement {r['tf_agree']:.3f} "
                f"(need {need}), worst trail {r['tf_max_trail_std']:.3f}"
                f" std (limit {TF_MARGIN_STD}), {r['distinct']} distinct "
                f"tokens (need {MIN_MEAN_DISTINCT})")
    return out


def moe_serve_kernels(torch, seed):
    """K12 and K13 at the serving shapes (a decode step's 16 rows and a
    prefill chunk's 128, d 768, bf16, maps from the port's router at
    moe_config's capacity factor over skewed gate logits): against their
    plain versions (the gather bit for bit, the combine within the
    registry's bf16 tolerance), timed beside the plain versions and
    F.embedding / F.embedding_bag, each launch after a read flush and a
    reset of the lines the gather marks. -> rows named "moe_gather
    serve 16" ..."""
    from paddle_tpu_torch.moe.kernels import (combine_plain, gather_plain,
                                              moe_combine_fwd, moe_gather_fwd,
                                              reset_persisting_l2)
    from paddle_tpu_torch.moe.router import capacity_for, route_top_k
    from paddle_tpu_torch.ops.kernel_registry import get_kernel
    F = torch.nn.functional
    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(seed + 19)
    bf16, d = torch.bfloat16, N_HEADS * HEAD_DIM
    flush = l2_flush(torch, dev)
    rows = {}
    for n in MOE_SERVE_ROWS:
        C = capacity_for(n, MOE_E, MOE_K, MOE_CF)
        logits = (torch.randn((n, MOE_E), generator=gen)
                  + torch.linspace(1.0, -1.0, MOE_E)).to(dev)
        comb_w, comb_slot, slot_token = route_top_k(logits, MOE_K, C)[:3]
        tokens = torch.randn((n, d), generator=gen).to(dev, bf16)
        eo = torch.randn((MOE_E * C, d), generator=gen).to(dev, bf16)
        w = comb_w.to(bf16)
        got = moe_gather_fwd(tokens, slot_token)
        ref = gather_plain(tokens, slot_token)
        cgot = moe_combine_fwd(eo, comb_slot, w)
        cref = combine_plain(eo, comb_slot, w)
        torch.cuda.synchronize()
        tag = f"[bf16, serve {n} rows, E={MOE_E} C={C}]"
        if not same_bits(torch, got, ref):
            raise AssertionError(f"moe_gather{tag}: not bit for bit its "
                                 "plain version")
        c_err = hold(f"moe_combine{tag}", cgot, cref,
                     get_kernel("moe_combine").tol["bfloat16"])
        pad = torch.cat([tokens, tokens.new_zeros((1, d))])
        eo_pad = torch.cat([eo, eo.new_zeros((1, d))])
        g_bytes, c_bytes, _, kept_slots = moe_work(
            torch, n, d, slot_token, comb_slot, 2)

        def timed(fn):
            return median_ms(torch, fn, flush, before=reset_persisting_l2)
        rows[f"moe_gather serve {n}"] = dict(
            ms=timed(lambda: moe_gather_fwd(tokens, slot_token)),
            plain_ms=timed(lambda: gather_plain(tokens, slot_token)),
            library_ms=timed(lambda: F.embedding(slot_token, pad)),
            bound=bound(g_bytes, 0, "bfloat16"), max_abs_err=0.0)
        rows[f"moe_combine serve {n}"] = dict(
            ms=timed(lambda: moe_combine_fwd(eo, comb_slot, w)),
            plain_ms=timed(lambda: combine_plain(eo, comb_slot, w)),
            library_ms=timed(lambda: F.embedding_bag(
                comb_slot, eo_pad, per_sample_weights=w, mode="sum")),
            bound=bound(c_bytes, 2 * kept_slots * d, "bfloat16"),
            max_abs_err=c_err)
        for name in (f"moe_gather serve {n}", f"moe_combine serve {n}"):
            print(f"kernels: {name} rows, d {d} bf16, C {C}: "
                  + kernel_line(rows[name]))
    del flush
    reset_persisting_l2()
    return rows


def moe_serve_run(torch, model, prompts, ids, dtype, what, exact):
    """One serving configuration of the MoE model: the serve phase's
    engine (captured steps) over `prompts` (32 new tokens each) and
    `generate` over `ids` (DEC_NEW new tokens), launches exact (one
    moe_gather and one moe_combine a MoE layer a step or chunk), every
    stream teacher-forced through `model`'s dense f32 forward. The
    engine's runs in turns (eager bodies, captured, captured, eager)
    count the streams equal to the first run's; with `exact` every one
    must be. Without it they may differ: idle slots and a chunk's
    padding rows attend over whatever the arenas hold and compete for
    the experts' capacity, so a stream depends on what earlier runs left
    there. `generate` routes no such row: its captured streams must equal
    its eager steps' in both cases. -> stats."""
    from paddle_tpu_torch import generation
    from paddle_tpu_torch.ops.kernel_registry import kernels, reset_launches
    from paddle_tpu_torch.serving import SamplingParams, ServingEngine
    L, vocab = model.config.num_layers, model.config.vocab_size
    eng = ServingEngine(model, **{**ENGINE, "dtype": dtype})
    for p in make_requests(1, vocab, n=2):
        eng.submit(p[:40], SamplingParams(max_new_tokens=4))
    eng.run_until_idle()
    torch.cuda.synchronize()
    d0, c0 = eng.decode_steps, eng.prefill_chunks
    reset_launches()
    outs, rate, step_ms, chunk_ms = serve_run(torch, eng, prompts)
    launches = {k.name: k.launches for k in kernels()}
    steps, chunks = eng.decode_steps - d0, eng.prefill_chunks - c0
    eng.pool.assert_quiesced()
    want = {**{k: 0 for k in launches}, "paged_decode": L * steps,
            "flash_prefill_chunk": L * chunks,
            **{k: L * (steps + chunks) for k in ("layernorm_fused",
                                                 *MOE_SERVE_KERNELS)}}
    if launches != want:
        raise AssertionError(f"{what} engine: launches {launches} != "
                             f"{want}")
    turns, same = {"eager": [], "captured": []}, []
    for eager in (True, False, False, True):
        o, r, sm, cm = serve_run(torch, eng, prompts, eager=eager)
        turns["eager" if eager else "captured"].append(run_stats(r, sm, cm))
        same.append(sum(a == b for a, b in zip(o, outs)))
    if exact and min(same) < len(outs):
        raise AssertionError(f"{what} engine: a run's streams differ from "
                             f"the first run's ({same} of {len(outs)} "
                             "equal)")
    captures = check_captures(eng._graphs.records, f"{what} engine")
    eng_tf = [teacher_forced(torch, model, p, o)
              for p, o in zip(prompts, outs)]
    del eng
    gdt = "bfloat16" if dtype == "bfloat16" else None
    model.generate(ids, max_new_tokens=DEC_NEW, dtype=gdt)     # capture
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out, _ = model.generate(ids, max_new_tokens=DEC_NEW, dtype=gdt)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    glaunch = {k.name: k.launches for k in kernels()}
    gwant = {**{k: 0 for k in glaunch}, "decode_fused": L * DEC_NEW,
             **{k: L * (DEC_NEW + 1) for k in ("layernorm_fused",
                                               *MOE_SERVE_KERNELS)}}
    if glaunch != gwant:
        raise AssertionError(f"{what} generate: launches {glaunch} != "
                             f"{gwant}")
    with eager_steps():
        eout, _ = model.generate(ids, max_new_tokens=DEC_NEW, dtype=gdt)
    if not torch.equal(eout, out):
        raise AssertionError(f"{what} generate: the eager steps' streams "
                             "differ from the captured ones'")
    streams = out[:, DEC_PROMPT:].tolist()
    gen_tf = [teacher_forced(torch, model, p, s)
              for p, s in zip(ids.tolist(), streams)]
    generation.release(model)

    def tf(runs):
        agree = [a for r in runs for a in r[0]]
        return sum(agree) / len(agree), max(t for r in runs for t in r[1])
    distinct = [len(set(o)) for o in outs + streams]
    stats = dict(engine=run_stats(rate, step_ms, chunk_ms),
                 engine_turns=turns, engine_captures=captures,
                 engine_turns_same_streams=same,
                 decode_steps=steps, prefill_chunks=chunks,
                 engine_tf=tf(eng_tf),
                 generate_tokens_per_s=DEC_BATCH * DEC_NEW / gen_s,
                 generate_step_ms=gen_s * 1e3 / DEC_NEW,
                 generate_tf=tf(gen_tf),
                 per_step={k: launches[k] / (steps + chunks)
                           for k in MOE_SERVE_KERNELS},
                 distinct_mean=sum(distinct) / len(distinct),
                 launches={k: launches[k] + glaunch[k] for k in launches})
    print(f"moe serve[{what}] on {card_line()}: " + json.dumps(stats))
    return stats


def stepwise_tf(torch, model, ids, streams):
    """Teacher-forced agreement of greedy `streams` [b, n] after the
    prompts `ids` [b, s0] through `model`'s f32 forward stepped as
    `generate` steps it: the prompts in one call, then each step's b
    previous tokens in one call over a KV cache, so a MoE layer routes
    the rows, and meets the capacity, that the decode's call did.
    -> (agree, trail) per token, as teacher_forced gives them."""
    b, s0 = ids.shape
    n = streams.shape[1]
    with torch.inference_mode():
        caches = model.gpt.init_cache(b, s0 + n, dtype=torch.float32)
        lg, caches = model(ids, caches=caches, offset=0)
        rows = [lg[:, -1]]
        for i in range(1, n):
            lg, caches = model(streams[:, i - 1:i], caches=caches,
                               offset=s0 + i - 1)
            rows.append(lg[:, -1])
    logits = torch.stack(rows, 1).float()
    best = logits.max(dim=-1).values
    mine = logits.gather(2, streams[..., None])[..., 0]
    trail = (best - mine) / logits.std(dim=-1)
    agree = (logits.argmax(dim=-1) == streams).float()
    return agree.flatten().tolist(), trail.flatten().tolist()


def moe_served_cf_check(torch, model, ids):
    """`generate` (captured token steps) at moe_config's capacity factor,
    where tokens are dropped, in f32 and in bf16, MOE_REF_NEW new tokens:
    every token teacher-forced through a CPU copy of the model (the plain
    versions) by stepwise_tf. Printed; held in f32: the teacher-forced
    bar and streams of >= MIN_MEAN_DISTINCT distinct tokens. bf16 is
    printed only: its gate logits' rounding flips near-tied choices."""
    import copy
    from paddle_tpu_torch import generation
    cpu = copy.deepcopy(model).to("cpu")
    out = {}
    for dtype in ("float32", "bfloat16"):
        got, _ = model.generate(ids, max_new_tokens=MOE_REF_NEW, dtype=dtype)
        generation.release(model)
        streams = got[:, ids.shape[1]:].cpu()
        agree, trail = stepwise_tf(torch, cpu, ids.cpu(), streams)
        out[dtype] = dict(tf_agree=sum(agree) / len(agree),
                          tf_max_trail_std=max(trail),
                          distinct_mean=sum(len(set(r)) for r in
                                            streams.tolist()) / len(streams))
    print(f"moe serve: generate at cf {MOE_CF}, {MOE_REF_NEW} tokens "
          "teacher-forced through the CPU's plain versions over the same "
          "rows: " + json.dumps(out))
    r = out["float32"]
    if (r["tf_agree"] < TF_AGREE or r["tf_max_trail_std"] > TF_MARGIN_STD
            or r["distinct_mean"] < MIN_MEAN_DISTINCT):
        raise AssertionError(
            f"moe serve f32 cf {MOE_CF} generate vs the CPU: agreement "
            f"{r['tf_agree']:.3f} (need {TF_AGREE}), worst trail "
            f"{r['tf_max_trail_std']:.3f} std (limit {TF_MARGIN_STD}), "
            f"{r['distinct_mean']:.1f} distinct tokens a stream (need "
            f"{MIN_MEAN_DISTINCT})")
    return out


def moe_serve_phase(torch, seed, init_range):
    """GPT-MoE (moe_config: GPT-3 125M width, every MLP an 8-expert top-2
    MoEFFN; init --init-range) served through the engine (the serve
    phase's configuration and its 32 greedy requests, 32 new tokens;
    decode steps and prefill chunks captured, which route every row they
    carry, idle slots and padding included) and `generate` (batch 8,
    prompt 128, 128 new, captured token steps), twice: in bf16 at
    moe_config's capacity factor 1.25 (the served configuration: speed,
    decode-step p50, launches; its teacher-forced agreement is printed,
    not held: the capacity a token meets depends on the rows routed
    with it, so the dense forward over a whole stream drops other
    choices than the steps did), and in f32 at a capacity where no
    choice is dropped, held to the teacher-forced bar (exact routing,
    so the f32 steps and the f32 dense forward compute the same
    function) and to stream identity between runs (moe_serve_run). Then
    `generate` at cf 1.25 against the CPU stepped over the same rows
    (moe_served_cf_check), and K12 and K13 at the serving shapes
    (moe_serve_kernels). -> (stats, that check's readings, kernel
    rows)."""
    import numpy as np
    from paddle_tpu_torch.moe import GPTMoE, MoEFFN
    cfg = moe_config()
    cfg.initializer_range = init_range
    model = GPTMoE(cfg, seed=seed)                    # f32, on the card
    prompts = make_requests(seed, cfg.vocab_size)
    ids = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (DEC_BATCH, DEC_PROMPT))).to(DEVICE)
    layers = [m for m in model.modules() if isinstance(m, MoEFFN)]
    stats = {}
    for what, dtype, cf in (("bf16 cf 1.25", "bfloat16", MOE_CF),
                            ("f32 dropless", "float32", MOE_DROPLESS_CF)):
        for m in layers:
            m.capacity_factor = cf
        stats[what] = moe_serve_run(torch, model, prompts, ids, dtype, what,
                                    exact=cf == MOE_DROPLESS_CF)
    for m in layers:
        m.capacity_factor = MOE_CF
    served = moe_served_cf_check(torch, model, ids)
    for part in ("engine_tf", "generate_tf"):
        rate, trail = stats["f32 dropless"][part]
        if rate < TF_AGREE or trail > TF_MARGIN_STD:
            raise AssertionError(
                f"moe serve f32 dropless {part}: teacher-forced check "
                f"failed: agreement {rate:.3f} (need {TF_AGREE}), worst "
                f"trail {trail:.3f} std (limit {TF_MARGIN_STD})")
    if stats["bf16 cf 1.25"]["distinct_mean"] < MIN_MEAN_DISTINCT:
        raise AssertionError("moe serve: the bf16 streams barely vary")
    del model, layers
    torch.cuda.empty_cache()
    return stats, served, moe_serve_kernels(torch, seed)


def print_compiled_summary(serve, wo8, loop, memory, decode):
    """The compiled step against the eager bodies, one JSON line: what
    each phase measured, eager and captured in turns in this process."""
    c = serve["compiled"]

    def mid(runs, key):
        return statistics.median(r[key] for r in runs)

    out = {"serve": {mode: {k: mid(c["turns"][mode], k) for k in (
        "tokens_per_s", "step_p50_ms", "step_p99_ms", "chunk_p50_ms")}
        for mode in ("eager", "captured")},
        "serve_turns": c["turns"],
        "serve_profile": c["profile"], "serve_graph_edges": c["graph_edges"],
        "serve_capture_ms": c["capture_ms"],
        "serve_pool_bytes": c["pool_bytes"],
        "serve_wo8_tokens_per_s": {"captured": wo8["tokens_per_s"],
                                   "eager": wo8["eager_tokens_per_s"]},
        "serve_loop_capture_ms": loop["capture_ms"],
        "serve_loop_pool_bytes": loop["pool_bytes"],
        "memory_recaptures": memory["recaptures"],
        "memory_total_graph_pool_gib": memory["total_graph_pool_gib"],
        "generate_kept_bytes": decode["kept"],
        "generate": {name: {**{mode: statistics.median(ts) for mode, ts in
                              decode[name]["tokens_per_s_turns"].items()},
                            "capture_ms": decode[name]["capture_ms"],
                            "pool_bytes": decode[name]["pool_bytes"],
                            "profile": decode[name].get("profile")}
                     for name in ("bf16", "wo8", "wo8 + int8 embeddings")}}
    print(f"compiled step on {card_line()}: " + json.dumps(out))


# ---------------------------------------------------------------------------
# phase 11: the serving bench (tools/bench_serving.py) at the card config
# ---------------------------------------------------------------------------

def serving_bench_phase(torch, seed):
    """`paddle_tpu_torch.tools.bench_serving`'s single-engine bench at
    its card configuration (the JAX tool's accelerator one): the
    single-stream baseline, the offered-load levels 1-16, the shared
    prefix leg and the tracing cost. Holds: exit 0 (the warm prefix
    streams equal the cold ones), every request of every level ends
    with max_new tokens, a prefix hit rate > 0, no capture inside a
    timed level, a baseline sweep or a tracing wave, launches of K7 = L
    x (decode steps + chunks), K10 = L x decode steps, K11 = L x chunks
    in every level and no other kernel, and every record of the JSONL
    passes the port's validator."""
    from paddle_tpu_torch.ops.kernel_registry import kernels, reset_launches
    from paddle_tpu_torch.telemetry import read_jsonl, validate_record
    from paddle_tpu_torch.telemetry.sink import SERVING_BENCH_METRICS
    from paddle_tpu_torch.tools import bench_serving
    t_phase = time.perf_counter()
    path = os.path.join(OUT_DIR, "serving_bench.jsonl")
    os.makedirs(OUT_DIR, exist_ok=True)
    if os.path.exists(path):
        os.unlink(path)
    reset_launches()
    rc, s = bench_serving.run(bench_serving.parse_args(
        ["--telemetry", path, "--seed", str(seed)]))
    launches = {k.name: k.launches for k in kernels()}
    L, new = s["num_layers"], s["max_new_tokens"]
    for lv in s["levels"]:
        d, c = lv["decode_steps"], lv["prefill_chunks"]
        want = {"layernorm_fused": L * (d + c), "paged_decode": L * d,
                "flash_prefill_chunk": L * c}
        if lv["launches"] != want or lv["min_tokens"] != new or \
                lv["captures"]:
            raise AssertionError(
                f"serving_bench: level {lv['level']}: launches "
                f"{lv['launches']} != {want}, fewest tokens "
                f"{lv['min_tokens']} (want {new}) or {lv['captures']} "
                "captures inside the timed level")
    if rc != 0 or not s["prefix_streams_identical"] or \
            not s["serving.prefix_hit_rate"] > 0 or \
            s["trace_captures_timed"] or \
            s["single_stream"]["captures_timed"]:
        raise AssertionError(
            f"serving_bench: rc {rc}, prefix identical "
            f"{s['prefix_streams_identical']}, hit rate "
            f"{s['serving.prefix_hit_rate']}, captures in the tracing "
            f"waves {s['trace_captures_timed']} and in the baseline "
            f"sweeps {s['single_stream']['captures_timed']}")
    records = read_jsonl(path)
    problems = [p for r in records for p in validate_record(r)]
    bench = [r["metric"] for r in records if r.get("kind") == "bench"]
    owned = [m for m in SERVING_BENCH_METRICS
             if not m.startswith(("serving.rated_", "fleet."))]
    if problems or bench != owned:
        raise AssertionError(f"serving_bench: record problems "
                             f"{problems[:5]}, bench rows {bench}")
    card = card_line()
    for lv in s["levels"]:
        print(f"serving_bench: level {lv['level']} on {card}: "
              f"{lv['tokens_per_sec']} tokens/s, TTFT p50/p99 "
              f"{lv['ttft_p50_ms']:.2f}/{lv['ttft_p99_ms']:.2f} ms, TPOT "
              f"p50/p99 {lv['tpot_p50_ms']:.3f}/{lv['tpot_p99_ms']:.3f} ms "
              f"({lv['requests']} requests, {lv['decode_steps']} decode "
              f"steps, {lv['prefill_chunks']} chunks)")
    keys = ("best_level", "slo_met", "slo_ttft_ms", "slo_tpot_ms",
            "serving.single_stream_tokens_per_sec",
            "serving.throughput_vs_single", "serving.ttft_p50_ms",
            "serving.ttft_p99_ms", "serving.tpot_p50_ms",
            "serving.tpot_p99_ms", "serving.preemptions",
            "serving.kv_block_utilization_peak",
            "serving.prefix_hit_rate", "serving.prefill_tokens_saved",
            "serving.prefill_tokens_offered", "serving.prefix_ttft_p50_ms",
            "prefix_cold_ttft_p50_ms", "serving.prefix_ttft_speedup",
            "serving.trace_overhead_frac", "trace_on_tokens_per_sec",
            "trace_off_tokens_per_sec", "single_stream", "warm_captures")
    out = {"serving.throughput_tokens_per_sec": s["value"],
           **{k: s[k] for k in keys},
           "phase_s": time.perf_counter() - t_phase}
    print(f"serving_bench on {card}: " + json.dumps(out))
    return dict(summary=s, launches=launches)


# ---------------------------------------------------------------------------
# phase 12: the health monitor, the watchdog and the memory rules
# ---------------------------------------------------------------------------

HEALTH_WARMUP, HEALTH_STEPS = 2, 12
HEALTH_DEADLINE_S, HEALTH_STALL_S = 1.0, 3.0


def health_phase(torch, seed):
    """TrainStep(health=) and the telemetry runtime on the card: the taps
    of 2 f32 AdamW steps (the train phase's card-vs-CPU check: b 2, s
    256, full width) against the CPU's, to 1e-4 relative; at the train
    shape under bf16 amp, ms a step with taps off, at every_k 4 and at
    every_k 1 (and the peak memory each: the pre-update copy), then 12
    steps at every_k 4 under a TelemetryRecorder whose step records
    validate; a host stall past hang_deadline_s: one dump, /healthz 503
    during it and 200 after; an injected NaN with action="raise":
    HealthError, `nan` fired, one dump; `memwatch --smoke` on the card
    with no rule firing."""
    import copy
    import shutil
    import threading
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.ops.kernel_registry import kernels, reset_launches
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.telemetry import (HealthConfig, HealthError,
                                            MetricsServer,
                                            TelemetryRecorder,
                                            gpt_train_flops_per_token,
                                            validate_record)
    from paddle_tpu_torch.tools import memwatch
    t_phase = time.perf_counter()
    cfg = GPTConfig.gpt3_125m(max_seq_len=1024, dropout=0.0)
    L = cfg.num_layers
    card = card_line()

    def adamw(model):
        return AdamW(learning_rate=1e-4, weight_decay=0.01,
                     parameters=model.parameters())

    def dumps(d):
        return sorted(f for f in os.listdir(d)
                      if f.startswith("health_blackbox_"))

    def fresh_dir(name):
        d = os.path.join(OUT_DIR, name)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        return d

    # the taps, card against CPU, f32, from the same weights and batch
    cpu_model = GPTForPretraining(cfg, device="cpu", seed=seed)
    card_model = copy.deepcopy(cpu_model).to(DEVICE)
    taps = {}
    reset_launches()
    for name, model in (("cuda", card_model), ("cpu", cpu_model)):
        step = TrainStep(model, model.loss, adamw(model),
                         health=HealthConfig(every_k=1, action="record",
                                             dump_on_exception=False))
        batch = train_batch(torch, cfg.vocab_size, PARITY_BATCH, PARITY_SEQ,
                            seed, model.gpt.wte.weight.device)
        for _ in range(PARITY_STEPS):
            step(*batch)
        taps[name] = [{k: r[k] for k in ("loss", "grad_norm",
                                         "update_ratio", "nan_count",
                                         "inf_count")}
                      for r in step.health.ring]
        print(f"health: f32 b={PARITY_BATCH} s={PARITY_SEQ} taps on "
              f"{name}: {json.dumps(taps[name])}")
    check_train_launches({k.name: k.launches for k in kernels()}, L,
                         PARITY_STEPS, "health f32 taps")
    rel = 0.0
    for c, p in zip(taps["cuda"], taps["cpu"]):
        if (c["nan_count"], c["inf_count"], p["nan_count"],
                p["inf_count"]) != (0, 0, 0, 0):
            raise AssertionError(f"health: non-zero NaN/Inf counts {c} {p}")
        for k in ("loss", "grad_norm", "update_ratio"):
            rel = max(rel, abs(c[k] - p[k]) / abs(p[k]))
    if len(taps["cuda"]) != PARITY_STEPS or not rel <= PARITY_RTOL:
        raise AssertionError(f"health: card taps {taps['cuda']} vs CPU "
                             f"{taps['cpu']}: relative {rel:.2e} > "
                             f"{PARITY_RTOL}")
    del cpu_model

    # the train shape under bf16 amp: the taps' cost, then the recorder
    model = GPTForPretraining(cfg, device=DEVICE, seed=seed)
    ids, labels = train_batch(torch, cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                              0, DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    fpt = gpt_train_flops_per_token(cfg, TRAIN_SEQ, n_params)

    def loss_fn(i, lbl):
        with amp.auto_cast(dtype="bfloat16"):
            return model.loss(i, lbl)

    cost = {}
    for label, every_k in (("off", None), ("every_k 4", 4),
                           ("every_k 1", 1)):
        health = None if every_k is None else HealthConfig(
            every_k=every_k, action="record", dump_on_exception=False)
        step = TrainStep(model, loss_fn, adamw(model), health=health)
        st = timed_train(torch, step, (ids, labels), HEALTH_WARMUP,
                         HEALTH_STEPS, fpt)
        check_train_launches(st["launches"], L, HEALTH_STEPS,
                             f"health {label}")
        fetches = 0 if health is None else len(step.health.ring)
        cost[label] = dict(step_ms=st["step_ms"],
                           step_p50_ms=st["step_p50_ms"],
                           peak_mem_gb=st["peak_mem_gb"],
                           tokens_per_s=st["tokens_per_s"],
                           fetches=fetches, tap_bytes=step.tap_bytes)
        if health is not None and any(
                a.kind == "nan" for a in step.health.anomalies):
            raise AssertionError(f"health {label}: nan fired on a "
                                 "healthy run")
        del step
    if (cost["every_k 4"]["fetches"], cost["every_k 1"]["fetches"]) != (
            (HEALTH_WARMUP + HEALTH_STEPS) // 4,
            HEALTH_WARMUP + HEALTH_STEPS):
        raise AssertionError(f"health: fetch counts {cost}")
    print(f"health: ms a step at b={TRAIN_BATCH} s={TRAIN_SEQ} bf16 amp "
          f"on {card} (taps off / every_k 4 / every_k 1): "
          + json.dumps(cost))
    rec = TelemetryRecorder(tokens_per_step=TRAIN_BATCH * TRAIN_SEQ,
                            flops_per_token=fpt)
    step = TrainStep(model, loss_fn, adamw(model),
                     health=HealthConfig(every_k=4, action="record",
                                         dump_on_exception=False))
    with rec:
        for _ in range(HEALTH_STEPS):
            step(ids, labels)
    problems = [p for r in rec.records for p in validate_record(r)]
    tapped = [r["step"] for r in rec.records if "grad_norm" in r]
    if len(rec.records) != HEALTH_STEPS or problems or \
            tapped != [3, 7, 11] or \
            not all(math.isfinite(r["loss"]) for r in rec.records):
        raise AssertionError(f"health: recorder records {rec.records[:2]}"
                             f", problems {problems[:5]}, tapped {tapped}")
    print(f"health: recorder, 12 steps at every_k 4 on {card}: "
          + json.dumps({"step_ms": [r["step_ms"] for r in rec.records],
                        "mfu": [r["mfu"] for r in rec.records],
                        "mem_bytes": rec.records[-1].get("mem_bytes"),
                        "tapped": tapped,
                        "last_taps": {k: rec.records[-1][k] for k in (
                            "grad_norm", "update_ratio", "nan_count",
                            "inf_count")}}))
    del step, model, rec

    # a host stall inside a step: one dump, /healthz 503 during it, 200
    # after
    stall_dir = fresh_dir("health_stall")
    calls = {"n": 0}

    def stalling_loss(i, lbl):
        calls["n"] += 1
        if calls["n"] == 2:
            time.sleep(HEALTH_STALL_S)
        return card_model.loss(i, lbl)

    step = TrainStep(card_model, stalling_loss, adamw(card_model),
                     health=HealthConfig(every_k=1, action="record",
                                         hang_deadline_s=HEALTH_DEADLINE_S,
                                         dump_dir=stall_dir))
    srv = MetricsServer(health=step.health).start()
    codes, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            codes.append(http_get(srv.url, "/healthz", timeout=10)[0])
            time.sleep(0.1)

    poller = threading.Thread(target=poll, name="healthz-poller")
    batch = train_batch(torch, cfg.vocab_size, PARITY_BATCH, PARITY_SEQ,
                        seed, DEVICE)
    poller.start()
    try:
        for _ in range(3):
            step(*batch)
    finally:
        stop.set()
        poller.join(30)
    after = http_get(srv.url, "/healthz", timeout=10)[0]
    srv.stop()
    step.health.close()
    stall_dumps = dumps(stall_dir)
    if poller.is_alive() or 503 not in codes or after != 200 or \
            len(stall_dumps) != 1:
        raise AssertionError(f"health: stall: /healthz codes {codes}, "
                             f"after {after}, dumps {stall_dumps}")
    box = json.load(open(os.path.join(stall_dir, stall_dumps[0])))
    if "stalled" not in box["reason"]:
        raise AssertionError(f"health: stall dump reason {box['reason']}")

    # an injected NaN with action="raise": HealthError, nan, one dump
    nan_dir = fresh_dir("health_nan")
    step = TrainStep(card_model,
                     lambda i, lbl: card_model.loss(i, lbl) * float("nan"),
                     adamw(card_model),
                     health=HealthConfig(every_k=1, action="raise",
                                         dump_dir=nan_dir))
    try:
        step(*batch)
        raise AssertionError("health: a NaN step did not raise")
    except HealthError as e:
        kinds = [a.kind for a in e.anomalies]
    if kinds != ["nan"] or len(dumps(nan_dir)) != 1:
        raise AssertionError(f"health: NaN fired {kinds}, dumps "
                             f"{dumps(nan_dir)}")
    del step, card_model

    # memwatch --smoke on the card: the ledger clean, no rule firing
    mem_path = os.path.join(OUT_DIR, "memwatch_smoke.jsonl")
    if os.path.exists(mem_path):
        os.unlink(mem_path)
    rc = memwatch.main(["--smoke", "--telemetry", mem_path])
    if rc != 0:
        raise AssertionError(f"health: memwatch --smoke exited {rc}")
    stats = dict(taps_rel=rel, cost=cost, stall_healthz_codes=sorted(
        set(codes)), stall_dump=stall_dumps[0], nan_kinds=kinds,
        phase_s=time.perf_counter() - t_phase)
    print(f"health on {card}: " + json.dumps(stats))
    return stats


# ---------------------------------------------------------------------------
# phase 13: the kernel observatory over the registry
# ---------------------------------------------------------------------------

def kernel_obs_phase(torch, seed):
    """`telemetry.kernel_obs.measure_registry` over every registered
    kernel at its example (the main path's shape): the wrapper's and the
    plain version's median of 60 (each launch after a read flush, CUDA
    events), `predicted_ms` from the entry's cost() over the data-sheet
    peaks, the bound kind and the achieved fraction; the
    `kernel_time_drift` verdicts are printed, not held (the
    launch-bound serving shapes sit far from their bounds by design).
    Holds: every record validates, and the DB is written under build/."""
    from paddle_tpu_torch.moe.kernels import reset_persisting_l2
    from paddle_tpu_torch.telemetry.health import AnomalyDetector
    from paddle_tpu_torch.telemetry.kernel_obs import (DEFAULT_DB_PATH,
                                                       KernelDB,
                                                       measure_registry)
    from paddle_tpu_torch.telemetry.ledger_check import validate_record
    t_phase = time.perf_counter()
    results = measure_registry(seeds=(seed,), warmup=5, k=60)
    reset_persisting_l2()       # the gather's evict_last lines
    records = [r.to_record() for r in results]
    problems = [p for r in records for p in validate_record(r)]
    det = AnomalyDetector()
    card = card_line()
    rows = {}
    for res, rec in zip(results, records):
        verdict = det.observe(rec)
        roof = res.roof
        frac = roof["bw_frac"] if roof["bound"] == "memory" \
            else roof["flops_frac"]
        rows[res.kernel] = dict(
            ms=res.kernel_ms, plain_ms=res.fallback_ms,
            predicted_ms=roof["predicted_ms"], bound=roof["bound"],
            frac=frac, bw_frac=roof["bw_frac"],
            flops_frac=roof["flops_frac"], compile_ms=res.compile_ms,
            sig=res.sig, drift=[a.message for a in verdict])
        print(f"kernel_obs: {res.kernel} {res.sig} on {card}: "
              f"{res.kernel_ms:.4f} ms (plain {res.fallback_ms:.4f}), "
              f"predicted {roof['predicted_ms']:.5f} ms by "
              f"{roof['bound']}, {frac:.3f} of that peak; drift: "
              + ("; ".join(a.message for a in verdict) or "in band"))
    db = KernelDB(DEFAULT_DB_PATH)
    updated, refused = db.update(results)
    db.save()
    if problems or refused or len(results) != len(rows) or \
            not os.path.exists(DEFAULT_DB_PATH):
        raise AssertionError(f"kernel_obs: record problems {problems[:5]}, "
                             f"refused {refused}")
    print(f"kernel_obs on {card}: " + json.dumps(
        dict(rows=rows, db=os.path.relpath(DEFAULT_DB_PATH, ROOT),
             db_updated=len(updated),
             phase_s=time.perf_counter() - t_phase)))
    return rows


# ---------------------------------------------------------------------------
# phase 14: the hybrid-parallel step as ranks sharing the card
# ---------------------------------------------------------------------------

DIST_LAYERS = 2                     # GPT-3 1.3B's 24 layers cut to 2
DIST_RTOL = 1e-4                    # the train phase's card-vs-CPU bar
DIST_BF16_ATOL = 2e-2
DIST_128K_TOL = 2e-2
DIST_TIMEOUT_S = {"nccl1": 240, "gloo_probe": 90, "card4": 420,
                  "card8": 300, "ep4": 420, "pp4": 600}
# the ep and pp legs: f32 SGD parameters and losses against the
# one-process run (Adam's update is blind to a gradient's scale), bf16
# losses against f32, capacity-bound MoE values against the block-by-
# block run, stage 0's peak memory between 8 and 16 micro-batches
DIST_EP_PP_RTOL = 1e-5
DIST_EP_PP_BF16_ATOL = 5e-3
DIST_EP_BOUND_RTOL = 1e-5
DIST_PP_MEM_GROWTH = 0.05
DIST_PP_CLIP_PARAM_RTOL = 1e-4      # the clipped runs' parameters


def dist_train_launches(launches, layers, sp_index, mode):
    """A step's exact launches on a rank: K6 once a layer, K1/K2 and
    K3-K5 (sp_index + 1) times a layer under ring, once under Ulysses,
    no other kernel."""
    hops = sp_index + 1 if mode == "ring" else 1
    want = {k: 0 for k in launches}
    want.update(flash_fwd=layers * hops, flash_bwd=layers * hops,
                layernorm_fwd_saved=layers)
    return want


def one_process_losses(torch, cfg, ids, lbl, seed, steps):
    """The same model's jit.TrainStep on the card in this process."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.tools.dist_drill import LR, WD
    model = GPTForPretraining(cfg, device=DEVICE, seed=seed)
    opt = AdamW(learning_rate=LR, weight_decay=WD,
                parameters=model.parameters())
    step = TrainStep(model, model.loss, opt)
    tids, tlbl = (torch.from_numpy(a).to(DEVICE) for a in (ids, lbl))
    out = [float(step(tids, tlbl)) for _ in range(steps)]
    del model, opt, step
    torch.cuda.empty_cache()
    return out


def ring_128k_reference(torch):
    """One K1/K3 run of the whole 128k x (the drill's), out and dx."""
    import numpy as np
    from paddle_tpu_torch.ops.attention import scaled_dot_product_attention
    from paddle_tpu_torch.tools.dist_drill import RING_128K
    c = RING_128K
    x = torch.from_numpy(np.random.RandomState(0).randn(
        1, c["S"], c["heads"], c["head_dim"]).astype(np.float32)).to(
        DEVICE, torch.bfloat16) * c["amp"]
    xg = x.requires_grad_()
    o = scaled_dot_product_attention(xg, xg, xg, is_causal=True)
    dx = torch.autograd.grad((o.float() ** 2).sum(), xg)[0]
    return o.detach(), dx


def distributed_phase(torch, seed):
    """Phase 14 (see the docstring): -> its readings and the launches
    of every rank's counted runs, summed."""
    import numpy as np
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.ops.kernel_registry import kernels
    from paddle_tpu_torch.tools import chaos_drill as cd
    from paddle_tpu_torch.tools import dist_drill as dd
    t_phase = time.perf_counter()
    card = card_line()
    out_dir = os.path.join(ROOT, "build", "chip_smoke", "dist_drill")
    torch.cuda.empty_cache()
    total = {k.name: 0 for k in kernels()}

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    # 1-2. the untimed jobs (one NCCL rank; the gloo probe) run beside
    # this process's references
    jobs = {name: dd.start_job(name, os.path.join(out_dir, name), seed,
                               DIST_TIMEOUT_S[name])
            for name in ("nccl1", "gloo_probe")}
    ids, lbl = dd.tiny_batch(seed, 2, dd.CARD_SEQ, 50304)
    cfg = GPTConfig.gpt3_1_3b(num_layers=DIST_LAYERS,
                              max_seq_len=dd.CARD_SEQ, dropout=0.0)
    t0 = time.perf_counter()
    ref = one_process_losses(torch, cfg, ids, lbl, seed, dd.CARD_STEPS)
    o_ref, dx_ref = ring_128k_reference(torch)
    ref_s = time.perf_counter() - t0
    job_s = {}

    res = jobs["nccl1"].wait()
    job_s["nccl1"] = jobs["nccl1"].seconds
    rec = res[0][0]
    if not all(rec["nccl_collectives"].values()):
        raise AssertionError(f"distributed: NCCL collectives "
                             f"{rec['nccl_collectives']}")
    for name in ("zero0", "zero1"):
        r1 = rec["size1"][name]
        if not (r1["losses_equal"] and r1["params_equal"]):
            raise AssertionError(
                f"distributed: ShardedTrainStep {name} at a mesh of ones "
                f"vs jit.TrainStep: {r1} vs "
                f"{rec['size1']['train_step_losses']} (not bit for bit)")
    readings = {"nccl1": {"collectives": rec["nccl_collectives"],
                          "size1": rec["size1"]}}
    print(f"distributed: NCCL one rank on {card}: "
          + json.dumps(readings["nccl1"]))

    # which gloo collectives take a CUDA tensor (an op missing from the
    # ranks' files aborted the process)
    res = jobs["gloo_probe"].wait(allow_fail=True)
    job_s["gloo_probe"] = jobs["gloo_probe"].seconds
    probe = {}
    for name in dd.GLOO_PROBES:
        got = [res[k][0]["gloo_cuda_probe"].get(name) if k in res else None
               for k in range(dd.JOBS["gloo_probe"][0])]
        probe[name] = (f"aborted the process (rank {got.index(None)})"
                       if None in got else got[0])
    readings["gloo_cuda_probe"] = probe
    print(f"distributed: gloo collectives on CUDA tensors, unstaged (torch "
          f"{torch.__version__}) on {card}: " + json.dumps(probe))
    from paddle_tpu_torch.distributed.collective import GLOO_CUDA_NATIVE
    native = {name for name, got in probe.items() if got == "ok"}
    if native != GLOO_CUDA_NATIVE:
        raise AssertionError(f"distributed: gloo carries {sorted(native)} "
                             "over CUDA tensors here, the collective layer "
                             f"assumes {sorted(GLOO_CUDA_NATIVE)}")

    # 3. the 4 ranks, alone on the card (timed)
    t0 = time.perf_counter()
    res = dd.run_job("card4", os.path.join(out_dir, "card4"), seed,
                     DIST_TIMEOUT_S["card4"])
    job_s["card4"] = time.perf_counter() - t0
    runs = {}
    for tag in ("ring_f32", "ulysses_f32", "ring_bf16", "ring_fce_f32"):
        mode = tag.split("_")[0]
        losses = [res[k][0][tag]["losses"] for k in res]
        if any(l != losses[0] for l in losses):
            raise AssertionError(f"distributed {tag}: ranks report "
                                 f"different losses {losses}")
        for k, (rk, _) in res.items():
            for i, st in enumerate(rk[tag]["steps"]):
                want = dist_train_launches(st["launches"], DIST_LAYERS,
                                           rk[tag]["coords"]["sp"], mode)
                if st["launches"] != want:
                    raise AssertionError(
                        f"distributed {tag}: rank {k} step {i} launches "
                        f"{st['launches']} != {want}")
                add(st["launches"])
        got = losses[0]
        if tag.endswith("f32"):
            rel = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
            if not rel <= DIST_RTOL:
                raise AssertionError(f"distributed {tag}: losses {got} vs "
                                     f"one process {ref}: {rel:.2e}")
        else:
            f32 = runs["ring_f32"]["losses"]
            dev = max(abs(a - b) for a, b in zip(got, f32))
            if not (all(math.isfinite(a) for a in got)
                    and dev <= DIST_BF16_ATOL):
                raise AssertionError(f"distributed {tag}: losses {got} vs "
                                     f"f32 {f32}: {dev:.3e}")
            rel = dev
        recs = [rk[f"{tag}/record"] for rk, _ in res.values()]
        runs[tag] = {
            "losses": got, "vs_reference": rel,
            "comm_ms_last_step": [round(x["comm_ms"], 1) for x in recs],
            "comm_frac_last_step": [x["comm_frac"] for x in recs],
            "collective_ms_rank0": {k: v["ms"] for k, v in
                                    recs[0]["collectives"].items()},
            "step_ms": [[round(st["ms"], 1) for st in rk[tag]["steps"]]
                        for rk, _ in res.values()],
            "comm_bytes": res[0][0][tag]["steps"][-1]["comm"]["bytes"],
            "staged_bytes":
                res[0][0][tag]["steps"][-1]["comm"]["staged_bytes"],
            "peak_mem_gb": [max(st["peak_mem_gb"]
                                for st in rk[tag]["steps"])
                            for rk, _ in res.values()]}
        print(f"distributed: {tag}, GPT-3 1.3B width x {DIST_LAYERS} "
              f"layers, mp 2 x sp 2, 4 ranks sharing one card, gloo, on "
              f"{card}: " + json.dumps(runs[tag]))
    # the fused CE over mp: the unfused ring step's losses, and a lower
    # peak in the forward, where no rank holds [tokens, vocab / mp]
    # logits (the step's peak lies in the AdamW update, the same in both)
    fce, base = runs["ring_fce_f32"], runs["ring_f32"]
    fce["vs_unfused"] = _rel_max(fce["losses"], base["losses"])
    fwd = {t: [max(st["forward_peak_gb"] for st in rk[t]["steps"])
               for rk, _ in res.values()] for t in ("ring_f32",
                                                    "ring_fce_f32")}
    fce["forward_peak_gb"] = fwd["ring_fce_f32"]
    fce["forward_peak_saved_gb"] = [b - a for a, b in zip(
        fwd["ring_fce_f32"], fwd["ring_f32"])]
    fce["step_peak_saved_gb"] = [b - a for a, b in zip(
        fce["peak_mem_gb"], base["peak_mem_gb"])]
    print(f"distributed: use_fused_ce over mp 2 against the unfused ring "
          f"step on {card}: " + json.dumps(
              {k: fce[k] for k in ("vs_unfused", "forward_peak_gb",
                                   "forward_peak_saved_gb",
                                   "step_peak_saved_gb")}))
    if not (fce["vs_unfused"] <= DIST_EP_PP_RTOL
            and min(fce["forward_peak_saved_gb"]) > 0):
        raise AssertionError(f"distributed ring_fce_f32: losses "
                             f"{fce['losses']} vs unfused {base['losses']}, "
                             f"forward peak saved "
                             f"{fce['forward_peak_saved_gb']} GB")
    runs["one_process_losses"] = ref
    runs["reference_s"] = ref_s
    # the 128k ring leg against the one-process run
    n = len(res)
    S = dd.RING_128K["S"]
    errs, row_errs = [], []
    for k, (rk, _) in res.items():
        r128 = rk["ring128k"]
        i = r128["sp_index"]
        want = {name: 0 for name in r128["launches"]}
        want.update(flash_fwd=i + 1, flash_bwd=i + 1)
        if r128["launches"] != want:
            raise AssertionError(f"distributed ring128k: rank {k} launches "
                                 f"{r128['launches']} != {want}")
        add(r128["launches"])
        piece = torch.load(os.path.join(out_dir, "card4",
                                        f"ring128k_rank{k}.pt"))
        rows = slice(i * S // n, (i + 1) * S // n)
        tag = f" [ringattn_128k sp 4, rank {k}]"
        for what, got, want_t in (("out", piece["out"], o_ref),
                                  ("dx", piece["dx"], dx_ref)):
            g = got.to(DEVICE)[0].transpose(0, 1).float()
            w = want_t[0, rows].transpose(0, 1).float()
            errs.append(hold(f"distributed {what}" + tag, g, w,
                             (DIST_128K_TOL, DIST_128K_TOL)))
            row_errs.append(hold_rows(f"distributed {what}" + tag, g, w,
                                      DIST_128K_TOL))
    del o_ref, dx_ref
    torch.cuda.empty_cache()
    ms = max(rk["ring128k"]["ms"] for rk, _ in res.values())
    runs["ring128k"] = {"fwd_bwd_ms": ms, "max_abs_err": max(errs),
                        "max_row_rel_err": max(row_errs),
                        "label": "4 ranks sharing one card, gloo"}
    print(f"distributed: ringattn_128k fwd+bwd over sp 4 (4 ranks sharing "
          f"one card, gloo) on {card}: " + json.dumps(runs["ring128k"]))
    readings["card4"] = runs

    # 4. ZeRO on 8 ranks
    t0 = time.perf_counter()
    res = dd.run_job("card8", os.path.join(out_dir, "card8"), seed,
                     DIST_TIMEOUT_S["card8"])
    job_s["card8"] = time.perf_counter() - t0
    zero = {"max_diff": res[0][0]["zero_max_diff"],
            "state_bytes": {f"zero{z}": [rk[f"zero{z}"]["state_bytes"]
                                         for rk, _ in res.values()]
                            for z in (0, 1, 2)}}
    if not zero["max_diff"]["2_vs_1"] <= 1e-6:
        raise AssertionError(f"distributed ZeRO: {zero['max_diff']}")
    for k, (rk, _) in res.items():
        for z in (1, 2):
            if 2 * rk[f"zero{z}"]["state_bytes"] \
                    != rk["zero0"]["state_bytes"]:
                raise AssertionError(f"distributed ZeRO-{z}: rank {k} holds "
                                     f"{zero['state_bytes']}")
        for z in (0, 1, 2):
            for i, st in enumerate(rk[f"zero{z}"]["steps"]):
                want = dist_train_launches(st["launches"], DIST_LAYERS,
                                           rk[f"zero{z}"]["coords"]["sp"],
                                           "ring")
                if st["launches"] != want:
                    raise AssertionError(
                        f"distributed zero{z}: rank {k} step {i} launches "
                        f"{st['launches']} != {want}")
                add(st["launches"])
    zero["losses"] = {f"zero{z}": res[0][0][f"zero{z}"]["losses"]
                      for z in (0, 1, 2)}
    zero["step_ms"] = {f"zero{z}": [round(st["ms"], 1) for st in
                                    res[0][0][f"zero{z}"]["steps"]]
                       for z in (0, 1, 2)}
    readings["card8"] = zero
    print(f"distributed: ZeRO-0/1/2, GPT-3 125M width x {DIST_LAYERS} "
          f"layers, dp 2 x mp 2 x sp 2, 8 ranks sharing one card, gloo, "
          f"on {card}: " + json.dumps(zero))

    # 5-6. expert parallelism and the pipeline, 4 ranks each
    for job, check in (("ep4", check_ep4), ("pp4", check_pp4)):
        t0 = time.perf_counter()
        res = dd.run_job(job, os.path.join(out_dir, job), seed,
                         DIST_TIMEOUT_S[job])
        job_s[job] = time.perf_counter() - t0
        readings[job] = check(res, add, card)
    readings["phase_s"] = time.perf_counter() - t_phase
    print("distributed: job seconds " + json.dumps(
        {k: round(v, 1) for k, v in job_s.items()}))
    return dict(readings=readings, launches=total)


def _same_losses(what, res, tag):
    """The losses every rank reports for run `tag` (they must agree)."""
    losses = [rk[tag]["losses"] for rk, _ in res.values()]
    if any(l != losses[0] for l in losses):
        raise AssertionError(f"{what} {tag}: ranks report different losses "
                             f"{losses}")
    return losses[0]


def _rel_max(got, ref):
    return max(abs(a - b) / abs(b) for a, b in zip(got, ref))


def _step_rows(res, tag, comm):
    """Per rank per step: launches of the kernels that ran, `comm`
    bytes, ms, peak GB."""
    return {f"rank{k}": [{"launches": {n: v for n, v in st["launches"]
                                       .items() if v},
                          f"{comm}_bytes": st["comm"]["bytes"].get(comm, 0),
                          "ms": round(st["ms"], 1),
                          "peak_gb": round(st.get("peak_mem_gb", 0.0), 3)}
                         for st in rk[tag]["steps"]]
            for k, (rk, _) in res.items()}


def check_ep4(res, add, card):
    """The ep4 job (tools/dist_drill.py): GPT-MoE at the bench's width x
    2 layers, global batch 8 x 1024, on ep 4, dp 2 x ep 2, ep 2 x mp 2."""
    from paddle_tpu_torch.tools import dist_drill as dd
    L = dd.EP_CARD["num_layers"]
    ref = res[0][0]["ep4/reference"]["losses"]
    out = {"one_process_losses": ref}
    for sizes in dd.EP_CARD_MESHES:
        tag = "ep4/" + "x".join(f"{a}{n}" for a, n in sizes.items())
        got = _same_losses("distributed", res, tag)
        rel = _rel_max(got, ref)
        prm = res[0][0][tag]["param_rel"]
        bound = {f"rank{k}": rk[tag]["bound"] for k, (rk, _) in res.items()}
        out[tag] = {"losses": got, "vs_one_process": rel,
                    "param_rel_max": prm, "capacity_bound": bound,
                    "steps": _step_rows(res, tag, "all_to_all")}
        print(f"distributed: {tag}, GPT-MoE at 768 x {L} layers, E 8 "
              f"top-2, 8 x 1024, 4 ranks sharing one card (gloo; not a "
              f"scaling figure), on {card}: " + json.dumps(out[tag]))
        if not (rel <= DIST_EP_PP_RTOL and prm["max"] <= DIST_EP_PP_RTOL):
            raise AssertionError(f"distributed {tag}: losses {got} vs one "
                                 f"process {ref} ({rel:.2e}), parameters "
                                 f"{prm}")
        for k, (rk, _) in res.items():
            for i, st in enumerate(rk[tag]["steps"]):
                check_train_launches(st["launches"], L, 1,
                                     f"distributed {tag} rank {k} step {i}",
                                     MOE_TRAIN_KERNELS)
                add(st["launches"])
            b = rk[tag]["bound"]
            if not (b["out_rel"] <= DIST_EP_BOUND_RTOL
                    and b["dx_rel"] <= DIST_EP_BOUND_RTOL
                    and b["dropped_frac"] > 0):
                raise AssertionError(f"distributed {tag} cf "
                                     f"{dd.EP_BOUND_CF}: rank {k} {b} "
                                     "against its blocks run alone")
    f32 = out["ep4/ep4"]["losses"]
    for tag in ("ep4/ep4_bf16", "ep4/ep4_cf1.25"):
        got = _same_losses("distributed", res, tag)
        for k, (rk, _) in res.items():
            for i, st in enumerate(rk[tag]["steps"]):
                check_train_launches(st["launches"], L, 1,
                                     f"distributed {tag} rank {k} step {i}",
                                     MOE_TRAIN_KERNELS)
                add(st["launches"])
        if not all(math.isfinite(a) for a in got):
            raise AssertionError(f"distributed {tag}: losses {got}")
        if tag.endswith("bf16"):
            dev = max(abs(a - b) for a, b in zip(got, f32))
            if not dev <= DIST_EP_PP_BF16_ATOL:
                raise AssertionError(f"distributed {tag}: losses {got} vs "
                                     f"f32 {f32}: {dev:.3e}")
            out[tag] = {"losses": got, "vs_f32": dev}
        else:
            out[tag] = {"losses": got}
        out[tag]["steps"] = _step_rows(res, tag, "all_to_all")
        print(f"distributed: {tag} on {card}: " + json.dumps(out[tag]))
    return out


def check_pp4(res, add, card):
    """The pp4 job (tools/dist_drill.py): GPT-3 1.3B's width as a
    PipelineLayer (tied embedding, 8 blocks, final LN, tied head),
    micro-batch 1 x 2048."""
    from paddle_tpu_torch.tools import dist_drill as dd
    refs = {False: res[0][0]["pp4/reference"],
            True: res[1][0]["pp4/reference_clip"]}
    out = {"one_process_losses": refs[False]["losses"],
           "one_process_clip": refs[True]}
    if not refs[True]["tensors_changed"] > 0:
        raise AssertionError(f"distributed pp4: ClipGradByNorm("
                             f"{dd.PP_CARD_CLIP}) scaled no gradient")
    for tag, sizes, vpp, amp_on, acc, steps, clip in dd.PP_CARD_RUNS:
        key = f"pp4/{tag}"
        ref = refs[clip]["losses"]
        got = _same_losses("distributed", res, key)
        for k, (rk, _) in res.items():
            r = rk[key]
            n = r["local_blocks"] * r["acc"]
            for i, st in enumerate(r["steps"]):
                want = {name: 0 for name in st["launches"]}
                want.update(flash_fwd=n, flash_bwd=n, layernorm_fwd_saved=n)
                if st["launches"] != want:
                    raise AssertionError(f"distributed {key}: rank {k} step "
                                         f"{i} launches {st['launches']} != "
                                         f"{want}")
                add(st["launches"])
        row = {"losses": got, "steps": _step_rows(res, key, "ppermute")}
        bad = None
        if amp_on:
            dev = max(abs(a - b) for a, b in zip(
                got, out["pp4/1f1b"]["losses"]))
            row["vs_f32"] = dev
            if not dev <= DIST_EP_PP_BF16_ATOL:
                bad = f"losses {got} vs f32 1F1B: {dev:.3e}"
        elif steps == dd.PP_CARD_STEPS:
            rel = _rel_max(got, ref)
            prm = {f"rank{k}": rk[key]["param_rel"]
                   for k, (rk, _) in res.items()}
            worst = max(p["max"] for p in prm.values())
            row.update(vs_one_process=rel, param_rel=prm)
            bar = DIST_PP_CLIP_PARAM_RTOL if clip else DIST_EP_PP_RTOL
            if not (rel <= DIST_EP_PP_RTOL and worst <= bar):
                bad = (f"losses {got} vs one process {ref} ({rel:.2e}), "
                       f"parameters {prm}")
            if clip:
                taps = [[st["health"] for st in rk[key]["steps"]]
                        for rk, _ in res.values()]
                row["health"] = taps[0]
                found = [f for t in taps for f in health_mismatch(
                    f"{key} taps", t, refs[True]["health"],
                    RES_HEALTH_RTOL)]
                if found:
                    bad = "; ".join(found)
        out[key] = row
        print(f"distributed: {key}, GPT-3 1.3B width x "
              f"{dd.PP_CARD_BLOCKS} blocks, {acc} micro-batches of 1 x "
              f"{dd.CARD_SEQ}, vpp {vpp}, 4 ranks sharing one card (gloo; "
              f"not a scaling figure), on {card}: " + json.dumps(row))
        if bad:
            raise AssertionError(f"distributed {key}: {bad}")
    # stage 0's peak memory under 1F1B: pp = 4 micro-batches in flight
    # once the steady phase exists (from pp + 1 on); at 4 the in-flight
    # peak comes before the first backward allocates the gradients
    peaks = {}
    for acc, key in ((4, "pp4/1f1b_acc4"), (8, "pp4/1f1b"),
                     (16, "pp4/1f1b_acc16")):
        for rk, _ in res.values():
            if rk[key]["coords"]["pp"] == 0 and rk[key]["coords"]["mp"] == 0:
                peaks[acc] = max(st["peak_mem_gb"] for st in rk[key]["steps"])
    growth = peaks[16] / peaks[8] - 1.0
    out["stage0_peak_gb"] = {"acc4": peaks[4], "acc8": peaks[8],
                             "acc16": peaks[16], "growth_8_to_16": growth,
                             "growth_4_to_8": peaks[8] / peaks[4] - 1.0}
    print(f"distributed: pp4 stage 0 peak memory, 1F1B at 4, 8 and 16 "
          f"micro-batches, on {card}: " + json.dumps(out["stage0_peak_gb"]))
    if not growth <= DIST_PP_MEM_GROWTH:
        raise AssertionError(f"distributed pp4: stage 0's peak grew "
                             f"{growth:.3f} from 8 to 16 micro-batches")
    # GPipe's backward: every rank's whole gradient, rank 2's against the
    # one-process gradient; K1 twice a block a micro-batch (the forward,
    # without a graph, and the backward's rerun), K7 in the forward's
    # add + LN and K6 in the rerun's, K3 once
    g = {k: rk["pp4/gpipe"] for k, (rk, _) in res.items()}
    n = dd.PP_CARD_BLOCKS // 4 * dd.PP_CARD_ACC
    for k, gk in g.items():
        want = {name: 0 for name in gk["launches"]}
        want.update(flash_fwd=2 * n, flash_bwd=n, layernorm_fwd_saved=n,
                    layernorm_fused=n)
        if gk["launches"] != want:
            raise AssertionError(f"distributed pp4 gpipe: rank {k} launches "
                                 f"{gk['launches']} != {want}")
        add(gk["launches"])
    rel = g[2]["grad_rel"]      # rank 2 holds the one-process gradient
    out["gpipe"] = {"grad_rel": rel,
                    "ms": [round(gk["ms"], 1) for gk in g.values()],
                    "peak_gb": [gk["peak_mem_gb"] for gk in g.values()],
                    "fingerprints": [gk["fingerprint"] for gk in g.values()]}
    print(f"distributed: pp4 GPipe forward + backward, GPT-3 1.3B width x "
          f"{dd.PP_CARD_BLOCKS} blocks stacked, {dd.PP_CARD_ACC} "
          f"micro-batches of 1 x {dd.CARD_SEQ}, pp 4 (4 ranks sharing one "
          f"card, gloo), on {card}: " + json.dumps(out["gpipe"]))
    if not (rel["max"] <= DIST_EP_PP_RTOL and len(
            set(out["gpipe"]["fingerprints"])) == 1):
        raise AssertionError(f"distributed pp4 gpipe: {out['gpipe']}")
    return out


# the resilience phase's jobs (tools/dist_drill.py) and their limits
RES_TIMEOUT_S = {"zero3_4": 420, "ckpt4": 240, "ckpt4_resume": 240,
                 "ckpt2_reshard": 180, "ckpt4_reshard": 180}
RES_ZERO_RTOL = 1e-6        # ZeRO-3 against ZeRO-2 (PR 18's ZeRO bar)
RES_BF16_RTOL = 2e-2        # bf16 amp losses against f32
RES_MESH_RTOL = 1e-5        # dp 2 x mp 2 against dp 4; the continuation
RES_HEALTH_RTOL = 1e-5      # the sharded taps against jit.TrainStep's
RES_MEM_TOL_GB = 1 / 64     # 16 MiB: the allocator's rounding
RES_TRAIN_KERNELS = ("flash_fwd", "flash_bwd", "layernorm_fwd_saved")
CHAOS_TIMEOUT_S = 420
ELASTIC_TIMEOUT_S = 300     # each leg of the elastic drill


def zero3_pieces(cfg, dp, rank):
    """Bytes of rank `rank`'s ZeRO pieces of GPT(cfg)'s f32 parameters:
    ceil(n / dp) elements of each parameter's n, the last rank's
    shorter."""
    from paddle_tpu_torch.models.gpt import GPTForPretraining
    out = 0
    for _, p in GPTForPretraining(cfg, device="meta").named_parameters():
        n = p.numel()
        c = -(-n // dp)
        out += 4 * (min((rank + 1) * c, n) - min(rank * c, n))
    return out


def health_mismatch(what, got, want, rtol):
    """The findings of holding health stats, step by step, against a
    reference's: the gradient norm, the update ratio and the loss within
    `rtol` relative, the NaN and Inf counts equal."""
    bad = []
    if len(got) != len(want):
        return [f"{what}: {len(got)} steps against {len(want)}"]
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("grad_norm", "update_ratio", "loss"):
            if not abs(g[k] - w[k]) <= rtol * abs(w[k]):
                bad.append(f"{what} step {i}: {k} {g[k]!r} against "
                           f"{w[k]!r}")
        if (g["nan_count"], g["inf_count"]) != (w["nan_count"],
                                                w["inf_count"]):
            bad.append(f"{what} step {i}: counts {g} against {w}")
    return bad


def check_step_launches(what, launches, blocks, remat=False):
    """K1, K3 and K6 once a block a rank a step (with `remat` K1 and K6
    twice: the forward and the backward's rerun); no other kernel."""
    want = {k: (blocks * (2 if remat and k != "flash_bwd" else 1)
                if k in RES_TRAIN_KERNELS else 0) for k in launches}
    if launches != want:
        raise AssertionError(f"resilience {what}: launches {launches} != "
                             f"{want}")


def start_elastic_drill(out_dir, seed):
    """Start the elastic drill (GPT-3 125M's width on the card) in a
    session of its own, its output to files under `out_dir`; -> (the
    process, its report's path, its stdout and stderr paths)."""
    import subprocess
    os.makedirs(out_dir, exist_ok=True)
    report = os.path.join(out_dir, "elastic_report.json")
    logs = [os.path.join(out_dir, f"elastic_{k}.log")
            for k in ("stdout", "stderr")]
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    with open(logs[0], "w") as out, open(logs[1], "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.tools.elastic_drill",
             "--dir", os.path.join(out_dir, "elastic"), "--report", report,
             "--seed", str(seed), "--leg-timeout", str(ELASTIC_TIMEOUT_S)],
            cwd=ROOT, env=env, stdout=out, stderr=err,
            start_new_session=True)
    return proc, report, logs


def stop_elastic_drill(proc):
    """End a drill still running (the phase failed first): SIGTERM lets
    it kill its hosts, each in a session of its own; then SIGKILL."""
    import signal
    import subprocess
    if proc is None or proc.poll() is not None:
        return
    os.killpg(proc.pid, signal.SIGTERM)
    try:
        proc.wait(timeout=20)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def elastic_store_check():
    """`ElasticManager(store=KVClient)` over the port's `KVServer` in
    this process: kvstore.cc builds (g++), two hosts heartbeating hold
    (HOLD); once host 1 stops, level 1 restarts (RESTART) and level 0
    exits (EXIT). -> its readings."""
    from paddle_tpu_torch.distributed.elastic import (ElasticManager,
                                                      ElasticStatus)
    from paddle_tpu_torch.distributed.kvstore import KVClient, KVServer
    t0 = time.perf_counter()
    srv = KVServer()
    build_s = time.perf_counter() - t0
    timeout = 0.5
    try:
        with KVClient(port=srv.port) as c0, KVClient(port=srv.port) as c1:
            m0, _ = (ElasticManager(store=c, np=2, host_id=str(h),
                                     timeout=timeout,
                                     fault_tolerance_level=1).register()
                      for h, c in ((0, c0), (1, c1)))
            seen = [m0.check()]
            time.sleep(timeout + 0.2)       # host 1 heartbeats no more
            m0.heartbeat()
            seen.append(m0.check())
            alive = m0.alive_hosts()
            m0.level = 0
            seen.append(m0.check())
    finally:
        srv.stop()
    out = {"build_s": round(build_s, 3), "statuses": seen, "alive": alive}
    want = [ElasticStatus.HOLD, ElasticStatus.RESTART, ElasticStatus.EXIT]
    print("elastic: ElasticManager(store=KVClient) over the port's KVServer "
          "(kvstore.cc built with g++): " + json.dumps(out))
    if seen != want or alive != ["0"]:
        raise AssertionError(f"elastic store check: statuses {seen} (want "
                             f"{want}), alive {alive}")
    return out


def elastic_drill_verdict(proc, report, logs, card, add):
    """Wait for the elastic drill, hold its report, add its children's
    launches (`add`) and print its numbers; -> its readings."""
    from paddle_tpu_torch.tools import elastic_drill as ed
    t0 = time.perf_counter()
    proc.wait(timeout=3 * ELASTIC_TIMEOUT_S)
    waited = time.perf_counter() - t0
    with open(logs[0]) as f:
        print(f.read().strip())
    with open(logs[1]) as f:
        stderr = f.read()
    rep = {}
    if os.path.exists(report):
        with open(report) as f:
            rep = json.load(f)
    if proc.returncode != 0:
        raise AssertionError(f"elastic drill exited {proc.returncode}: "
                             f"{rep.get('failures')} {stderr[-2000:]}")
    steps = {"host0": len(rep["host0_losses"]),
             "host1": len(rep["host1_ms"]),
             "relaunch": len(rep["relaunch_losses"])}
    for who, n in steps.items():
        got = rep["launches"][who]
        want = {k: (ed.CARD_LAYERS * n if k in RES_TRAIN_KERNELS else 0)
                for k in got}
        if got != want:
            raise AssertionError(f"elastic drill {who}: launches {got} != "
                                 f"{want} ({n} steps)")
        add(got)
    out = {k: rep[k] for k in (
        "drill_s", "pod_s", "relaunch_s", "detect_s", "kill_to_exit_s",
        "kill_step", "drained_step", "events", "resumed_via",
        "resumed_from", "host0_losses", "relaunch_losses", "host0_ms",
        "host0_commit_wait_s", "host1_ms", "host1_gaps_s", "relaunch_ms", "restore_ms",
        "heartbeat_timeout_s", "ledger")}
    out["steps"] = steps
    out["launches"] = {who: {k: v for k, v in l.items()
                             if k in RES_TRAIN_KERNELS}
                       for who, l in rep["launches"].items()}
    out["waited_s"] = round(waited, 1)
    print(f"elastic: host-loss drill, GPT-3 125M's width x {ed.CARD_LAYERS} "
          f"layers, {ed.CARD_BATCH[0]} x {ed.CARD_BATCH[1]}, bf16 amp, AdamW, "
          f"dropout 0.1, two host processes on {card}: " + json.dumps(out))
    return out


def elastic_phase(torch, seed):
    """`--phases elastic`: the store check and the elastic drill alone."""
    import shutil
    from paddle_tpu_torch.ops.kernel_registry import kernels
    out_dir = os.path.join(ROOT, "build", "chip_smoke", "elastic")
    shutil.rmtree(out_dir, ignore_errors=True)
    total = {k.name: 0 for k in kernels()}

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    proc, report, logs = start_elastic_drill(out_dir, seed)
    try:
        store = elastic_store_check()
        drill = elastic_drill_verdict(proc, report, logs, card_line(), add)
    finally:
        stop_elastic_drill(proc)
    return dict(readings={"store": store, "drill": drill}, launches=total)


def resilience_phase(torch, seed):
    """Phase 15 (see the docstring): -> its readings and the launches
    of every rank's steps, summed."""
    import shutil
    import signal
    import subprocess
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.ops.kernel_registry import kernels
    from paddle_tpu_torch.tools import chaos_drill as cd
    from paddle_tpu_torch.tools import dist_drill as dd
    t_phase = time.perf_counter()
    card = card_line()
    out_dir = os.path.join(ROOT, "build", "chip_smoke", "resilience")
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    total = {k.name: 0 for k in kernels()}
    job_s = {}
    readings = {}

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    def run(job, allow_fail=False, meanwhile=None):
        t0 = time.perf_counter()
        j = dd.start_job(job, os.path.join(out_dir, job), seed,
                         RES_TIMEOUT_S[job])
        if meanwhile is not None:
            meanwhile()
        res = j.wait(allow_fail=allow_fail)
        job_s[job] = time.perf_counter() - t0
        return res, j.rc

    drill_proc = el_proc = None
    drill_log = {k: os.path.join(out_dir, f"chaos_{k}.log")
                 for k in ("stdout", "stderr")}
    try:
        # 4 (beside 1-3). the chaos drill: GPT-3 125M's width, a SIGKILL
        # mid-save, a resume; started first, read last; its output goes
        # to files, read once it has exited
        t_drill = time.perf_counter()
        report = os.path.join(out_dir, "chaos_report.json")
        os.makedirs(out_dir, exist_ok=True)
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        with open(drill_log["stdout"], "w") as out, \
                open(drill_log["stderr"], "w") as err:
            drill_proc = subprocess.Popen(
                [sys.executable, "-m", "paddle_tpu_torch.tools.chaos_drill",
                 "--dir", os.path.join(out_dir, "chaos"), "--report",
                 report, "--io-error-rate", "0.05",
                 "--leg-timeout", str(CHAOS_TIMEOUT_S)],
                cwd=ROOT, env=env, stdout=out, stderr=err,
                start_new_session=True)

        # 1. zero3_4: ZeRO-2, ZeRO-3, offload, bf16, remat, the health
        # taps and dp 2 x mp 2
        res, _ = run("zero3_4")
        cfg = GPTConfig.gpt3_1_3b(num_layers=dd.ZERO3_CARD_BLOCKS,
                                  max_seq_len=dd.CARD_SEQ, dropout=0.0)
        cmp = res[0][0]["zero3_cmp"]
        tags = dd.ZERO3_CARD_TAGS + ("z3_mp",)
        z = {"cmp": cmp, "losses": {t: _same_losses("resilience", res, t)
                                    for t in tags}}
        bad = []
        for t in ("z3", "z3_remat"):
            c3 = cmp[t]
            if not (c3["rel"] <= RES_ZERO_RTOL and max(c3["loss_rel"])
                    <= RES_ZERO_RTOL):
                bad.append(f"{t} vs {c3['vs']} {c3}")
        off = cmp["z3_off"]
        if not (off["equal"] and max(off["loss_rel"]) == 0):
            bad.append(f"offload vs none {off}")
        if not max(cmp["z3_bf16"]["loss_rel"]) <= RES_BF16_RTOL:
            bad.append(f"bf16 vs f32 {cmp['z3_bf16']}")
        if not max(cmp["z3_mp"]["loss_rel"]) <= RES_MESH_RTOL:
            bad.append(f"dp 2 x mp 2 vs dp 4 {cmp['z3_mp']}")
        ref = res[0][0]["z3_health/reference"]
        z["health"] = {"reference": ref}
        for t, n in (("z3_health", dd.ZERO3_STEPS),
                     ("z3_mp", dd.ZERO3_CARD_STEPS)):
            got = [st["health"] for st in res[0][0][t]["steps"]]
            z["health"][t] = got
            bad += health_mismatch(f"{t} taps", got, ref[:n],
                                   RES_HEALTH_RTOL)
        mem, peaks = {}, {}
        for k, (rk, _) in res.items():
            want = zero3_pieces(cfg, 4, k)
            for t in ("z3", "z3_off", "z3_bf16", "z3_remat", "z3_health"):
                for st in rk[t]["steps"]:
                    m = st["memory"]
                    if not (m["param_storage"] == 0 and m["owned"] == want
                            and m["state"] == 2 * want):
                        bad.append(f"rank {k} {t} between steps {m}, pieces "
                                   f"{want}")
                    if t == "z3_off" and not (m["state_device"] == 0 and
                                              m["state_pinned"] == m["state"]):
                        bad.append(f"rank {k} offload holds {m}")
            mem[f"rank{k}"] = rk["z3_off"]["steps"][-1]["memory"]
            for t in tags:
                for i, st in enumerate(rk[t]["steps"]):
                    check_step_launches(f"zero3_4 {t} rank {k} step {i}",
                                        st["launches"], dd.ZERO3_CARD_BLOCKS,
                                        remat=t == "z3_remat")
                    add(st["launches"])
            if k == 0:
                peaks = {t: max(st["peak_mem_gb"] for st in rk[t]["steps"])
                         for t in tags}
        # each rank's memory a step: the peak, what the step started
        # with, what the forward kept for the backward, the forward's
        # peak (GB), and the taps' pre-update copy (bytes); rank 0 alone
        # ran the one-process health reference first
        mem_rows = {t: {f"rank{k}": [
            {key: round(st[key], 3) for key in (
                "peak_mem_gb", "start_gb", "after_forward_gb",
                "forward_peak_gb")} | ({"tap_bytes": st["tap_bytes"]}
                                       if "tap_bytes" in st else {})
            for st in rk[t]["steps"]] for k, (rk, _) in res.items()}
            for t in ("z3", "z3_remat", "z3_health", "z3_mp")}
        # nothing of an earlier leg is left on the card (the f32 ZeRO-3
        # legs start their steps from the same bytes: their pieces and
        # states); remat's peak lies below ZeRO-3's; the taps add at
        # most their pre-update copy to ZeRO-3's
        fam = ("z3", "z3_remat", "z3_health")
        for k, (rk, _) in res.items():
            start = {t: rk[t]["steps"][0]["start_gb"] for t in fam}
            pk = {t: max(st["peak_mem_gb"] for st in rk[t]["steps"])
                  for t in fam}
            tap = rk["z3_health"]["steps"][-1]["tap_bytes"] / 2 ** 30
            if max(start.values()) - min(start.values()) > RES_MEM_TOL_GB:
                bad.append(f"rank {k} steps start from {start} GB")
            if not pk["z3_remat"] < pk["z3"]:
                bad.append(f"rank {k} remat's peak {pk['z3_remat']:.3f} GB "
                           f"is not below ZeRO-3's {pk['z3']:.3f}")
            if not pk["z3_health"] <= pk["z3"] + tap + RES_MEM_TOL_GB:
                bad.append(f"rank {k} the taps' peak {pk['z3_health']:.3f} "
                           f"GB above ZeRO-3's {pk['z3']:.3f} + their "
                           f"copy {tap:.3f}")
        if not peaks["z3"] < peaks["z2"]:
            bad.append(f"rank 0's peak under ZeRO-3 {peaks['z3']:.3f} GB "
                       f"is not below ZeRO-2's {peaks['z2']:.3f}")
        rows = {}
        for t in tags:
            st = res[0][0][t]["steps"]
            row = {"ms": [round(s["ms"], 1) for s in st],
                   "all_gather_bytes": st[-1]["comm"]["bytes"].get(
                       "all_gather", 0),
                   "reduce_scatter_bytes": st[-1]["comm"]["bytes"].get(
                       "reduce_scatter", 0),
                   "peak_gb": round(peaks[t], 3)}
            if t == "z3_off":
                h2d, d2h = st[-1]["offload_ms"]
                nbytes = mem["rank0"]["state_pinned"]
                row.update(offload_bytes=2 * nbytes, h2d_ms=round(h2d, 3),
                           d2h_ms=round(d2h, 3),
                           h2d_gbps=round(nbytes / h2d / 1e6, 2),
                           d2h_gbps=round(nbytes / d2h / 1e6, 2))
            rows[t] = row
        # remat: the rerun reuses the gather its output's gradient made
        if rows["z3_remat"]["all_gather_bytes"] != \
                rows["z3"]["all_gather_bytes"]:
            bad.append(f"remat all_gather bytes {rows['z3_remat']} against "
                       f"{rows['z3']}")
        z.update(steps=rows, memory=mem, step_memory=mem_rows,
                 dynamo_import_s=[rk["z3_remat/dynamo_import_s"]
                                  for rk, _ in res.values()],
                 pieces_bytes=[zero3_pieces(cfg, 4, k) for k in range(4)])
        readings["zero3_4"] = z
        print(f"resilience: zero3_4, GPT-3 1.3B width x "
              f"{dd.ZERO3_CARD_BLOCKS} blocks, 4 x {dd.CARD_SEQ} (a row a "
              f"rank), dp 4 (and dp 2 x mp 2), f32 AdamW (and bf16 amp), 4 "
              f"ranks sharing one card (gloo; not a scaling figure), on "
              f"{card}: " + json.dumps(z))
        if bad:
            raise AssertionError("resilience zero3_4: " + "; ".join(bad))
        del res
        torch.cuda.empty_cache()

        # 2. the checkpoint jobs: a baseline and a run preempted on one rank
        plan = dd.CKPT_CARD
        stop = plan["preempt_at"] + 1
        kept = sorted({*range(plan["save_every"], stop, plan["save_every"]),
                       stop})[-dd.CKPT_KEEP:]
        # 5 (beside 2-4). the elastic drill starts beside ckpt4, read
        # last; this process checks the store-backed membership meanwhile
        t_el = time.perf_counter()
        el_proc, el_report, el_logs = start_elastic_drill(out_dir, seed)

        def store_check():
            readings["elastic_store"] = elastic_store_check()
        res, rc = run("ckpt4", allow_fail=True, meanwhile=store_check)
        if rc != 102 or sorted(res) != [0, 1, 2, 3]:
            raise AssertionError(f"resilience ckpt4: the job exited {rc} with "
                                 f"the records of ranks {sorted(res)}")
        ck = {}
        base = _same_losses("resilience", res, "ckpt_base")
        for k, (rk, _) in res.items():
            pre = rk["ckpt_preempt"]
            if rk.get("exit_code") != 102 or pre["exit"] != {
                    "code": 102, "step": stop} or pre["steps_on_disk"] != kept:
                raise AssertionError(
                    f"resilience ckpt4: rank {k} stopped with "
                    f"{rk.get('exit_code')} {pre['exit']}, committed "
                    f"{pre['steps_on_disk']}")
            for leg in ("ckpt_base", "ckpt_preempt"):
                for i, l in enumerate(rk[leg]["launches"]):
                    check_step_launches(f"ckpt4 {leg} rank {k} step {i}", l,
                                        dd.CKPT_CARD_BLOCKS)
                    add(l)
        b0 = res[0][0]["ckpt_base"]
        commits = [x for x in b0["records"] if x["event"] == "commit"]
        saves = [x for x in b0["records"] if x["event"] == "save"]
        ck["base"] = {
            "losses": base, "step_ms": [round(x, 1) for x in b0["ms"]],
            "save_in_flight": b0["in_flight"],
            "snapshot_ms": [x.get("snapshot_ms") for x in saves],
            "commit_ms": [x["save_ms"] for x in commits],
            "bytes": [x["bytes"] for x in commits]}
        ck["preempt"] = {"exit": res[0][0]["ckpt_preempt"]["exit"],
                         "committed": kept}
        # 3. side by side: the resume at dp 4, and step_2 of the
        # uninterrupted run restored at dp 2 (ZeRO-2) and dp 2 x mp 2
        t0 = time.perf_counter()
        jobs = {job: dd.start_job(job, os.path.join(out_dir, job), seed,
                                  RES_TIMEOUT_S[job])
                for job in ("ckpt4_resume", "ckpt2_reshard",
                            "ckpt4_reshard")}
        done = {}
        for job, j in jobs.items():
            done[job] = j.wait()
            job_s[job] = time.perf_counter() - t0
        res = done["ckpt4_resume"]
        for k, (rk, _) in res.items():
            rr = rk["ckpt_resume"]
            if rr["resumed_via"] != "direct" or rr["start"] != stop:
                raise AssertionError(f"resilience ckpt4_resume: rank {k} "
                                     f"{rr['resumed_via']} from {rr['start']}")
            for leg in ("ckpt_resume", "ckpt_direct"):
                for i, l in enumerate(rk[leg]["launches"]):
                    check_step_launches(
                        f"ckpt4_resume {leg} rank {k} step {i}", l,
                        dd.CKPT_CARD_BLOCKS)
                    add(l)
        r0 = res[0][0]
        got = {int(i): v for i, v in r0["ckpt_resume"]["losses"].items()}
        want = {int(i): v for i, v in base.items() if int(i) >= stop}
        ck["resume"] = {"losses": r0["ckpt_resume"]["losses"],
                        "restore_ms": round(
                            r0["ckpt_resume"]["restore_ms"], 1),
                        "digest_equal": r0["ckpt_resume"]["digest"]
                        == b0["digest"]}
        if got != want or not ck["resume"]["digest_equal"]:
            raise AssertionError(f"resilience ckpt4_resume: losses {got} vs "
                                 f"the uninterrupted {want}, digests equal "
                                 f"{ck['resume']['digest_equal']}")
        direct = r0["ckpt_direct"]
        ck["direct"] = {"losses": direct["losses"],
                        "restore_ms": round(direct["restore_ms"], 1)}
        for job in ("ckpt2_reshard", "ckpt4_reshard"):
            res = done[job]
            r0 = res[0][0]
            rs = r0["ckpt_reshard"]
            leaves = r0["ckpt_reshard/leaves"]
            rel = max(abs(rs["losses"][i] - direct["losses"][i])
                      / abs(direct["losses"][i]) for i in direct["losses"])
            ck[job] = {"losses": rs["losses"], "vs_direct": rel,
                       "leaves": leaves,
                       "restore_ms": round(rs["restore_ms"], 1),
                       "elastic": rs["elastic"]}
            for k, (rk, _) in res.items():
                if rk["ckpt_reshard"]["resumed_via"] != "reshard":
                    raise AssertionError(
                        f"resilience {job}: rank {k} resumed "
                        f"{rk['ckpt_reshard']['resumed_via']}")
                for i, l in enumerate(rk["ckpt_reshard"]["launches"]):
                    check_step_launches(f"{job} rank {k} step {i}", l,
                                        dd.CKPT_CARD_BLOCKS)
                    add(l)
            if leaves["n_differ"] or not rel <= RES_MESH_RTOL:
                raise AssertionError(f"resilience {job}: {ck[job]}")
        readings["ckpt"] = ck
        print(f"resilience: ckpt4, GPT-3 1.3B width x {dd.CKPT_CARD_BLOCKS} "
              f"blocks, dp 4 ZeRO-3, f32 AdamW, dropout {dd.CKPT_DROPOUT}, a "
              f"save every {plan['save_every']} steps, preemption on rank "
              f"{dd.CKPT_PREEMPT_RANK} alone, 4 ranks sharing one card "
              f"(gloo), on {card}: " + json.dumps(ck))
        shutil.rmtree(os.path.join(out_dir, "ckpt"), ignore_errors=True)

        # 4. the chaos drill's verdict
        drill_proc.wait(timeout=3 * CHAOS_TIMEOUT_S)
        job_s["chaos_drill"] = time.perf_counter() - t_drill
        with open(drill_log["stdout"]) as f:
            print(f.read().strip())
        with open(drill_log["stderr"]) as f:
            stderr = f.read()
        with open(report) as f:
            rep = json.load(f)
        if drill_proc.returncode != 0:
            raise AssertionError(f"resilience chaos drill exited "
                                 f"{drill_proc.returncode}: {rep['failures']} "
                                 f"{stderr[-2000:]}")
        for leg, steps in (("baseline", 6), ("resume", 2)):
            got = rep[leg]["launches"]
            want = {k: (cd.CARD_LAYERS * steps if k in RES_TRAIN_KERNELS
                        else 0) for k in got}
            if got != want:
                raise AssertionError(f"resilience chaos drill {leg}: launches "
                                     f"{got} != {want}")
            add(got)
        drill = {"losses": rep["losses"], "corrupt": rep["corrupt"],
                 "husks": rep["husks"],
                 "baseline_step_ms": [round(x, 1)
                                      for x in rep["baseline"]["step_ms"]],
                 "snapshot_ms": rep["baseline"]["snapshot_ms"],
                 "commit_ms": rep["baseline"]["save_ms"],
                 "bytes": rep["baseline"]["bytes"],
                 "restore_ms": rep["resume"]["restore_ms"],
                 "faults": [rep["baseline"]["chaos_faults"],
                            rep["resume"]["chaos_faults"]],
                 "legs_s": [round(rep[k], 1) for k in (
                     "baseline_s", "crash_s", "resume_s", "corrupt_s")]}
        readings["chaos_drill"] = drill
        print(f"resilience: chaos drill, GPT-3 125M's width x "
              f"{cd.CARD_LAYERS} layers, 8 x 1024, bf16 amp, "
              f"dropout 0.1, 5% injected I/O faults, SIGKILL after step 5's "
              f"save starts, on {card}: " + json.dumps(drill))
        shutil.rmtree(os.path.join(out_dir, "chaos"), ignore_errors=True)

        # 5. the elastic drill's verdict
        readings["elastic_drill"] = elastic_drill_verdict(
            el_proc, el_report, el_logs, card, add)
        job_s["elastic_drill"] = time.perf_counter() - t_el
        shutil.rmtree(os.path.join(out_dir, "elastic"), ignore_errors=True)
    finally:
        if drill_proc is not None and drill_proc.poll() is None:
            # the phase failed first
            os.killpg(drill_proc.pid, signal.SIGKILL)
            drill_proc.wait()
        stop_elastic_drill(el_proc)
    readings["phase_s"] = time.perf_counter() - t_phase
    print("resilience: job seconds " + json.dumps(
        {k: round(v, 1) for k, v in job_s.items()}))
    return dict(readings=readings, launches=total)


PARTIAL_PHASES = ("kernels_moe", "moe_train", "kernels_1_3b",
                  "kernels_13b", "long_context", "serve_13b", "moe_serve",
                  "options", "layer", "full", "full_4k", "memory",
                  "serving_bench", "health", "kernel_obs", "distributed",
                  "resilience", "elastic")


def partial_run(torch, args, lap, phase_s):
    """The build and the named phases alone (--phases); no result."""
    fns = {"kernels_moe": moe_kernels_phase, "moe_train": moe_train_phase,
           "kernels_1_3b": kernels_1_3b_phase,
           "kernels_13b": kernels_13b_phase,
           "serve_13b": serve_13b_phase,
           "moe_serve": lambda torch, seed: moe_serve_phase(
               torch, seed, INIT_RANGE),
           "long_context": long_context_phase, "options": train_options_phase,
           "layer": train_1_3b_layer_phase, "full": train_1_3b_full_phase,
           "full_4k": lambda torch, seed: train_1_3b_full_phase(
               torch, seed, 4096),
           "memory": lambda torch, seed: memory_phase(torch, seed,
                                                      INIT_RANGE),
           "serving_bench": serving_bench_phase, "health": health_phase,
           "kernel_obs": kernel_obs_phase,
           "distributed": distributed_phase,
           "resilience": resilience_phase, "elastic": elastic_phase}
    for name in args.phases.split(","):
        fns[name](torch, args.seed)
        torch.cuda.empty_cache()
        lap(name)
    print("phase seconds: " + json.dumps(
        {k: round(v, 1) for k, v in phase_s.items()}))
    print(f"chip_smoke: partial run ({args.phases}) on {card_line()}: no "
          "result line")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init-range", type=float, default=INIT_RANGE,
                    help="std of the random weights (GPT initializer)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"),
                    help="the engine's compute dtype in the serve phase")
    ap.add_argument("--phases", default="all",
                    help="a comma list of " + ",".join(PARTIAL_PHASES)
                    + " to run after the build alone, for iterating on "
                    "them; such a run prints no result line")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "paddle_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(paddle_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 3
    sys.path.insert(0, root)
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops.kernel_registry import kernels

    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    # f32 references in full f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    regs = kernels()
    sources = sorted({os.path.basename(k.source)[:-3] for k in regs})
    t0 = time.perf_counter()
    # the kernels' sources and the captured graphs' edge counter
    _build.build(sources + ["graph_edges"])
    print(f"build: {len(regs)} kernels from {len(sources)} sources (and "
          f"graph_edges.cu) in {time.perf_counter() - t0:.1f} s")
    for src in ("flash_attention_fwd", "flash_attention_bwd",
                "flash_prefill_chunk", "paged_decode", "decode_attention",
                "int8_matvec"):
        for fn, info in sorted(_build.ptxas_info(src).items()):
            if any(k in fn for k in PTXAS_SHOWN):
                print(f"build: ptxas {src}: {fn}: {json.dumps(info)}")
    print_pair_ptxas(_build)
    print_gather_ptxas(_build)

    phase_s = {"build": time.perf_counter() - t0}

    def lap(name):
        phase_s[name] = time.perf_counter() - t0 - sum(phase_s.values())

    if args.phases != "all":
        return partial_run(torch, args, lap, phase_s)
    rows = kernels_phase(torch, args.seed)
    lap("kernels: serving")
    rows.update(train_kernels_phase(torch, args.seed))
    lap("kernels: training")
    rows.update(decode_kernels_phase(torch, args.seed))
    lap("kernels: decode")
    rows.update(moe_kernels_phase(torch, args.seed))
    lap("kernels: moe")
    rows_1_3b = kernels_1_3b_phase(torch, args.seed)
    lap("kernels: 1.3B")
    rows_13b = kernels_13b_phase(torch, args.seed)
    lap("kernels: 13B")
    kernel_obs_phase(torch, args.seed)
    torch.cuda.empty_cache()
    lap("kernel obs")
    long_ctx = long_context_phase(torch, args.seed)
    torch.cuda.empty_cache()
    lap("long context")
    stats, eng, vocab = serve_phase(torch, args.seed, args.init_range,
                                    args.dtype)
    lap("serve")
    stats["compiled"]["profile"] = {
        mode: profile_phase(torch, eng, vocab, args.seed, what=f" ({mode})",
                            eager=mode == "eager")
        for mode in ("captured", "eager")}
    del eng
    lap("serve profile")
    wo8 = serve_wo8_phase(torch, args.seed, args.init_range)
    torch.cuda.empty_cache()
    lap("serve wo8")
    loop = serve_loop_phase(torch, args.seed, args.init_range)
    torch.cuda.empty_cache()
    lap("serve loop")
    memory = memory_phase(torch, args.seed, args.init_range)
    torch.cuda.empty_cache()
    lap("memory")
    fleet = fleet_phase(torch, args.seed, args.init_range)
    torch.cuda.empty_cache()
    lap("fleet")
    sbench = serving_bench_phase(torch, args.seed)
    torch.cuda.empty_cache()
    lap("serving bench")
    decode = decode_phase(torch, args.seed, args.init_range)
    torch.cuda.empty_cache()
    lap("decode")
    serve_13b = serve_13b_phase(torch, args.seed)
    lap("serve 13B")
    resil = resilience_phase(torch, args.seed)
    torch.cuda.empty_cache()
    lap("resilience")
    moe_serve, moe_served_cf, rows_moe_serve = moe_serve_phase(
        torch, args.seed, args.init_range)
    torch.cuda.empty_cache()
    lap("moe serve")
    train = train_phase(torch, args.seed)
    torch.cuda.empty_cache()
    lap("train")
    moe = moe_train_phase(torch, args.seed)
    torch.cuda.empty_cache()
    lap("moe train")
    health_phase(torch, args.seed)
    torch.cuda.empty_cache()
    lap("health")
    options = train_options_phase(torch, args.seed)
    torch.cuda.empty_cache()
    lap("train options")
    layer = train_1_3b_layer_phase(torch, args.seed)
    torch.cuda.empty_cache()
    lap("train 1.3B layer")
    full = train_1_3b_full_phase(torch, args.seed)
    torch.cuda.empty_cache()
    lap("train 1.3B full")
    full_4k = train_1_3b_full_phase(torch, args.seed, 4096)
    torch.cuda.empty_cache()
    lap("train 1.3B full s=4096")
    dist = distributed_phase(torch, args.seed)
    torch.cuda.empty_cache()
    lap("distributed")
    print("phase seconds: " + json.dumps(
        {k: round(v, 1) for k, v in phase_s.items()}))
    print_compiled_summary(stats, wo8, loop, memory, decode)
    print(f"1.3B on {card_line()}: " + json.dumps({
        "kernels": {k: {**r, "bound": list(r["bound"])}
                    for k, r in rows_1_3b.items()},
        "options": {k: v for k, v in options.items() if k != "launches"},
        "layer": {k: v for k, v in layer.items() if k != "launches"},
        "full": {k: v for k, v in full.items() if k != "launches"},
        "full_4k": {k: v for k, v in full_4k.items() if k != "launches"},
        "long_context": long_ctx["points"]}))
    print(f"13B decode and MoE serving on {card_line()}: " + json.dumps({
        "kernels": {k: {**r, "bound": list(r["bound"])}
                    for k, r in {**rows_13b, **rows_moe_serve}.items()},
        "serve_13b": {k: v for k, v in serve_13b.items() if k != "launches"},
        "moe_serve": {what: {k: v for k, v in st.items() if k != "launches"}
                      for what, st in moe_serve.items()},
        "moe_served_cf_vs_cpu": moe_served_cf}))

    out = []
    for k in regs:
        r = rows[k.name]
        # the launches of every main path's counted run
        launches = sum(run["launches"][k.name]
                       for run in (stats, wo8, loop, memory, fleet, sbench,
                                   decode, serve_13b, *moe_serve.values(),
                                   train, moe, options, layer, full,
                                   full_4k, long_ctx, dist, resil))
        # the largest error of the kernel's checks, the 1.3B, 13B and MoE
        # serving shapes' too
        err = max([r["max_abs_err"]] + [
            r13["max_abs_err"] for name, r13 in {
                **rows_1_3b, **rows_13b, **rows_moe_serve}.items()
            if name.split(" ")[0] == k.name])
        out.append({"name": k.name, "route": "cuda", "source": k.source,
                    "replaces": k.replaces, "launches": launches,
                    "max_abs_err": err, "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                    "bound_by": r["bound"][1],
                    "library_ms": r["library_ms"]})
    print(card_line())
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
